"""Shared proximal-operator primitives and linear-solve caches.

JAX analog of the reference's getProxOps.m helper layer: the
soft-threshold family (getProxOps.m:933-938), hinge / 0-1 / Huber proxes
(getProxOps.m:1084-1180, 1529-1539), projections (getProxOps.m:1378-1382,
1470-1474), and rho-parameterized SPD solves that replace the reference's
rho-keyed Cholesky caches (getProxOps.m:968-971, 1400-1405, 1444-1453) with
one-time symmetric eigendecompositions whose per-iteration application is
pure matmul work.
"""

from .prox import (
    soft_threshold,
    hinge_prox,
    zero_one_prox,
    huber_prox,
    project_nonneg,
    project_box,
    covsel_eig_prox,
)
from .solve import SymShiftSolver, WoodburySolver, kkt_eq_solver
from .matfun import ns_sqrtm, covsel_ns_prox
from .scaling import ruiz_equilibrate, kkt_scale_quality

__all__ = [
    "soft_threshold",
    "hinge_prox",
    "zero_one_prox",
    "huber_prox",
    "project_nonneg",
    "project_box",
    "ruiz_equilibrate",
    "kkt_scale_quality",
    "covsel_eig_prox",
    "SymShiftSolver",
    "WoodburySolver",
    "kkt_eq_solver",
    "ns_sqrtm",
    "covsel_ns_prox",
]
