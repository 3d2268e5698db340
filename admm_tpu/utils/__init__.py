"""Utilities: input validation and result reporting.

JAX analog of the reference's root-level utilities
(errorcheck.m, showresults.m; SURVEY.md section 2.4).  The reference's
setuppaths.m / removepaths.m session-path management has no analog — a
Python package imports without path mutation.
"""

from .validate import errorcheck, slicemaker
from .report import showresults
from .checkpoint import load_state, load_state_orbax, save_state, save_state_orbax

__all__ = [
    "errorcheck", "slicemaker", "showresults",
    "save_state", "load_state", "save_state_orbax", "load_state_orbax",
]
