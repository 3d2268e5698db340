"""Linear-operator protocol for the ADMM constraint A x + B z = c.

The reference engine accepts A/At/B as dense matrices, scalars (for +/- I
efficiency) or function handles (admm.m:112-245).  Here the same flexibility
is a small pytree-registered operator hierarchy so operators can flow through
``jit`` / ``vmap`` / ``shard_map`` as arguments, and scaled identities stay
O(n) instead of materializing a matrix.

Every operator provides:
  - ``mv(v)``   : A @ v
  - ``rmv(v)``  : A.T @ v
  - ``out_shape(in_shape)`` for size inference.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
class ScaledIdentityOp:
    """alpha * I.  The reference's scalar-A/B fast path (admm.m:145-153)."""

    def __init__(self, alpha=1.0):
        self.alpha = alpha

    def mv(self, v):
        if isinstance(self.alpha, (int, float)) and self.alpha == 1.0:
            return v
        if isinstance(self.alpha, (int, float)) and self.alpha == -1.0:
            return -v
        return self.alpha * v

    rmv = mv

    def out_shape(self, in_shape):
        return in_shape

    def tree_flatten(self):
        return (self.alpha,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])

    def __repr__(self):
        return f"ScaledIdentityOp({self.alpha})"


@jax.tree_util.register_pytree_node_class
class DenseOp:
    """A dense matrix operator; mv/rmv are matmuls."""

    def __init__(self, M):
        self.M = M

    def mv(self, v):
        return self.M @ v

    def rmv(self, v):
        return self.M.T @ v

    def out_shape(self, in_shape):
        return (self.M.shape[0],) + tuple(in_shape[1:])

    def tree_flatten(self):
        return (self.M,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])

    def __repr__(self):
        return f"DenseOp{tuple(self.M.shape)}"


@jax.tree_util.register_pytree_node_class
class DiffOp:
    """The total-variation difference operator.

    Matches the reference's D = spdiags([1, -1], 0:1, n, n)
    (solvers/totalvariation.m:127): upper-bidiagonal with D[i,i] = 1,
    D[i,i+1] = -1, and last row [0 ... 0 1], i.e.
    (Dx)_i = x_i - x_{i+1} for i < n, (Dx)_n = x_n.
    Applied matrix-free: O(n) instead of an O(n^2) matmul.
    """

    def __init__(self, n: int):
        self.n = n

    def mv(self, v):
        shifted = jnp.concatenate([v[1:], jnp.zeros_like(v[:1])], axis=0)
        return v - shifted

    def rmv(self, v):
        # D^T v: (D^T v)_i = v_i - v_{i-1}; (D^T v)_1 = v_1.
        shifted = jnp.concatenate([jnp.zeros_like(v[:1]), v[:-1]], axis=0)
        return v - shifted

    def out_shape(self, in_shape):
        return in_shape

    def dense(self, dtype=jnp.float64):
        eye = jnp.eye(self.n, dtype=dtype)
        return eye - jnp.eye(self.n, k=1, dtype=dtype)

    def tree_flatten(self):
        return (), self.n

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux)

    def __repr__(self):
        return f"DiffOp({self.n})"


@jax.tree_util.register_pytree_node_class
class StackIDiffOp:
    """The fused-lasso stacked operator A = [I; D] applied matrix-free:
    ``mv(x) = concat([x, Dx])`` (2n,), ``rmv(v) = v[:n] + D^T v[n:]`` —
    O(n) elementwise work instead of a dense (2n, n) GEMV per residual/dual
    evaluation (models/fusedlasso.py)."""

    def __init__(self, n: int):
        self.n = n
        self._D = DiffOp(n)

    def mv(self, v):
        return jnp.concatenate([v, self._D.mv(v)], axis=0)

    def rmv(self, v):
        return v[: self.n] + self._D.rmv(v[self.n:])

    def out_shape(self, in_shape):
        return (2 * self.n,) + tuple(in_shape[1:])

    def tree_flatten(self):
        return (), self.n

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux)

    def __repr__(self):
        return f"StackIDiffOp({self.n})"


@jax.tree_util.register_pytree_node_class
class FnOp:
    """A matrix-free operator from explicit mv/rmv callables (the
    reference's function-handle A with explicit nA, admm.m:121-130)."""

    def __init__(self, mv: Callable, rmv: Callable, data=()):
        self._mv = mv
        self._rmv = rmv
        self.data = tuple(data)

    def mv(self, v):
        return self._mv(v, *self.data)

    def rmv(self, v):
        return self._rmv(v, *self.data)

    def out_shape(self, in_shape):
        return None  # unknown; caller must supply m explicitly

    def tree_flatten(self):
        return (self.data,), (self._mv, self._rmv)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux[0], aux[1], children[0])


def as_linop(A) -> object:
    """Coerce matrices / scalars / operators into a LinOp (admm.m:112-158).

    Anything exposing the mv/rmv/out_shape protocol passes through — user
    operator classes included (the reference's function-handle A/B) — but
    must be a registered jax pytree so it can cross the jit boundary."""
    if hasattr(A, "mv") and hasattr(A, "rmv"):
        if not hasattr(A, "out_shape"):
            raise TypeError(
                f"operator {type(A).__name__} defines mv/rmv but not "
                "out_shape(in_shape); implement it (return None if unknown)"
            )
        # An unregistered object is a pytree LEAF; it would fail deep
        # inside jit with an obscure error. Fail here with guidance.
        if jax.tree_util.all_leaves([A]):
            raise TypeError(
                f"operator {type(A).__name__} must be registered as a jax "
                "pytree (e.g. @jax.tree_util.register_pytree_node_class) "
                "to be passed through jit; see linop.FnOp for a "
                "ready-made wrapper around plain callables"
            )
        return A
    if isinstance(A, (int, float)):
        return ScaledIdentityOp(float(A))
    A = jnp.asarray(A)
    if A.ndim == 0:
        return ScaledIdentityOp(A)
    if A.ndim == 2:
        return DenseOp(A)
    raise TypeError(f"Cannot interpret {type(A)} with ndim {A.ndim} as a linear operator")
