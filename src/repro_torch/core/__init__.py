"""Distributed-matrix, solver and linear-algebra layers of the port."""
