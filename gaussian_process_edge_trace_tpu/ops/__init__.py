from .diff import finite_diff
from .integrate import simpson_nonuniform, simpson_weights
from .interp import bilinear_interp, column_interp

__all__ = ["finite_diff", "simpson_nonuniform", "simpson_weights",
           "bilinear_interp", "column_interp"]
