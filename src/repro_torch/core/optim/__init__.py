from .first_order import METHODS, minimize_first_order

__all__ = ["METHODS", "minimize_first_order"]
