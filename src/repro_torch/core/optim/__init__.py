from .first_order import METHODS, minimize_first_order
from .lbfgs import lbfgs, lbfgs_composite
from .problems import (Problem, composite_value, lbfgs_value_and_grad,
                       make_problem)
from .api import minimize

__all__ = ["METHODS", "minimize_first_order", "lbfgs", "lbfgs_composite",
           "make_problem", "Problem", "composite_value",
           "lbfgs_value_and_grad", "minimize"]
