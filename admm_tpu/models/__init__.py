"""Problem library: solver wrappers + proximal-operator registry.

JAX analog of the reference's solvers/ directory and the
getProxOps.m string switch (getProxOps.m:52-917).  Each module exposes
``make_prox_ops(...)`` (the registry entry) and a solver entry point with
the reference solver's signature.
"""

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name.lower()] = fn
        return fn

    return deco


def get_prox_ops(problem: str, args=None, **kwargs):
    """String-keyed prox-op factory mirroring getproxops(problem, args)
    (reference getProxOps.m:13-31).  ``args`` may be a struct (dict) of
    problem arguments, exactly like the reference's second positional
    argument — validated by errorcheck('isstruct'), errorcheck.m:117 —
    or the arguments may be passed as keywords.  Prefer the typed
    per-module ``make_prox_ops`` in new code.  (The solver imports at
    the bottom of this module register every entry at
    package-import time.)"""
    key = problem.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown problem {problem!r}; known: {sorted(_REGISTRY)}")
    if args is not None:
        from ..utils.validate import errorcheck

        kwargs = {**errorcheck(args, "isstruct", "args"), **kwargs}
    return _REGISTRY[key](**kwargs)


from .basispursuit import basispursuit  # noqa: E402
from .covarianceselection import covarianceselection  # noqa: E402
from .elasticnet import elasticnet  # noqa: E402
from .grouplasso import grouplasso  # noqa: E402
from .huberfit import huberfit  # noqa: E402
from .lad import lad  # noqa: E402
from .quantile import quantile  # noqa: E402
from .fusedlasso import fusedlasso  # noqa: E402
from .rpca import rpca  # noqa: E402
from .sdp import sdp  # noqa: E402
from .matrixcompletion import matrixcompletion  # noqa: E402
from .logreg import logreg  # noqa: E402
from .lasso import lasso  # noqa: E402
from .nnls import nnls  # noqa: E402
from .linearprogram import linearprogram  # noqa: E402
from .linearsvm import linearsvm  # noqa: E402
from .model import model  # noqa: E402
from .quadraticprogram import quadraticprogram  # noqa: E402
from .totalvariation import totalvariation  # noqa: E402
from .totalvariation2d import totalvariation2d  # noqa: E402
from .unwrapped import unwrappedadmm  # noqa: E402

__all__ = [
    "get_prox_ops",
    "register",
    "model",
    "lasso",
    "elasticnet",
    "grouplasso",
    "nnls",
    "basispursuit",
    "totalvariation",
    "totalvariation2d",
    "lad",
    "fusedlasso",
    "quantile",
    "rpca",
    "sdp",
    "matrixcompletion",
    "logreg",
    "huberfit",
    "linearprogram",
    "quadraticprogram",
    "covarianceselection",
    "linearsvm",
    "unwrappedadmm",
]
