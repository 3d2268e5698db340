"""2-D (image) total variation denoising — EXTENSION.

No reference analog (the reference's TV is 1-D, solvers/totalvariation.m);
this extends the same splitting to images with anisotropic TV:

    min 1/2 ||X - S||_F^2 + lambda ||Z||_1   s.t.   A X - Z = 0,
    A X = stack(D_r X, X D_c^T)

where D_r / D_c are PURE difference stencils ((Dv)_i = v_i - v_{i+1},
zero in the last slot) — unlike the 1-D model, which keeps the
reference's last-element-identity stencil for parity, this extension
penalizes only differences, so a constant image has TV exactly 0.

x-update:  (I + rho (D_r^T D_r (+) D_c^T D_c)) X = S + rho A^T (Z - U)
           — a Sylvester-structured system diagonalized by the two SMALL
           1-D eigenbases:  X = U_r [ (U_r^T B U_c) / (1 + rho (wr_i +
           wc_j)) ] U_cT.  Per-iteration work is four dense matmuls
           of shapes (m,m)x(m,n) and (m,n)x(n,n) — no mn-by-mn
           system is ever formed, and the solve is valid for ANY runtime
           rho (rbadaptive-safe; there are no config-dependent paths).
z-update:  soft_threshold(A X + U, lambda / rho)   (elementwise)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import ADMMConfig
from ..engine import Hooks, admm
from ..ops.prox import soft_threshold
from ..results import ADMMResults
from . import register
from ._common import merge_config, timed_solver


def _d(v, axis):
    """Pure difference along ``axis``: (Dv)_i = v_i - v_{i+1}, last = 0."""
    lead = jax.lax.slice_in_dim(v, 0, v.shape[axis] - 1, axis=axis)
    trail = jax.lax.slice_in_dim(v, 1, v.shape[axis], axis=axis)
    zero = jnp.zeros_like(jax.lax.slice_in_dim(v, 0, 1, axis=axis))
    return jnp.concatenate([lead - trail, zero], axis=axis)


def _dt(v, axis):
    """Adjoint of ``_d`` (the last slot of v is ignored by construction)."""
    body = jax.lax.slice_in_dim(v, 0, v.shape[axis] - 1, axis=axis)
    zero = jnp.zeros_like(jax.lax.slice_in_dim(v, 0, 1, axis=axis))
    up = jnp.concatenate([body, zero], axis=axis)      # v with last slot 0
    down = jnp.concatenate([zero, body], axis=axis)    # shifted down by 1
    return up - down


def _dense_1d(n, dtype):
    """Dense pure-difference matrix D, built by applying the SAME stencil
    to the identity (single source of truth for the eigenbasis):
    _d(I, 0) applies the stencil to each column, i.e. D @ I = D."""
    return _d(jnp.eye(n, dtype=dtype), 0)


@jax.tree_util.register_pytree_node_class
class TV2DOp:
    """A X = stack(D_r X, X D_c^T) with the pure-difference stencil."""

    def __init__(self, m: int, n: int):
        self.m = m
        self.n = n

    def mv(self, X):
        return jnp.stack([_d(X, 0), _d(X, 1)])

    def rmv(self, V):
        return _dt(V[0], 0) + _dt(V[1], 1)

    def out_shape(self, in_shape):
        return (2,) + tuple(in_shape)

    def tree_flatten(self):
        return (), (self.m, self.n)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*aux)


def _prox_f(X, Z, U, rho, d):
    B = d["S"] + rho * d["A"].rmv(Z - U)
    Y = d["Ur"].T @ B @ d["Uc"]
    Y = Y / (1.0 + rho * (d["wr"][:, None] + d["wc"][None, :]))
    return d["Ur"] @ Y @ d["Uc"].T


def _prox_g(X, Z, U, rho, d):
    return soft_threshold(U + d["A"].mv(X), d["lam"] / rho)


def _prox_g_relaxed(AXhat, Z, U, rho, d):
    # Under relaxation the engine hands Axhat, already in A-space.
    return soft_threshold(U + AXhat, d["lam"] / rho)


def _obj(X, Z, d):
    return 0.5 * jnp.sum((X - d["S"]) ** 2) + d["lam"] * jnp.sum(jnp.abs(Z))


def make_prox_ops(S, lam, config: ADMMConfig = ADMMConfig()):
    """Build (prox_f, prox_g, obj, data, A).  The eigenbasis x-prox is
    valid for any runtime rho, so no config-dependent solve paths exist
    (config selects only the relaxation-aware z-prox)."""
    S = jnp.asarray(S)
    m, n = S.shape
    A = TV2DOp(m, n)
    Lr = _dense_1d(m, S.dtype)
    Lc = _dense_1d(n, S.dtype)
    wr, Ur = jnp.linalg.eigh(Lr.T @ Lr)
    wc, Uc = jnp.linalg.eigh(Lc.T @ Lc)
    data = {"S": S, "lam": jnp.asarray(lam, S.dtype), "A": A,
            "Ur": Ur, "wr": wr, "Uc": Uc, "wc": wc}
    prox_g = _prox_g if config.relax == 1.0 else _prox_g_relaxed
    return _prox_f, prox_g, _obj, data, A


@register("totalvariation2d")
def _registry_entry(S, lam, config=ADMMConfig(), **_):
    from ._common import bind_data

    pf, pg, obj, data, _A = make_prox_ops(S, lam, config)
    return bind_data(pf, pg, obj, data)


@timed_solver
def totalvariation2d(S, lam, config: ADMMConfig = ADMMConfig(), *,
                     x0=None, z0=None, u0=None, **overrides) -> ADMMResults:
    """Denoise an image by anisotropic 2-D TV."""
    config = merge_config(config, overrides, body="gemv")
    S = jnp.asarray(S)
    m, n = S.shape
    prox_f, prox_g, obj, data, A = make_prox_ops(S, lam, config)
    zeros_x = jnp.zeros((m, n), S.dtype)
    zeros_z = jnp.zeros((2, m, n), S.dtype)
    return admm(
        prox_f, prox_g, config,
        A=A, B=-1.0, c=0.0,
        shape_x=(m, n), shape_z=(2, m, n),
        x0=zeros_x if x0 is None else jnp.asarray(x0, S.dtype),
        z0=zeros_z if z0 is None else jnp.asarray(z0, S.dtype),
        u0=zeros_z if u0 is None else jnp.asarray(u0, S.dtype),
        hooks=Hooks(obj=obj), dtype=S.dtype, data=data,
    )
