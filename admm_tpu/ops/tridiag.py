"""Cyclic-reduction tridiagonal solver with precomputed elimination.

The TV x-update solves the FIXED tridiagonal system (I + rho D^T D) x = b
every iteration (getProxOps.m:1044-1048).  A dense inverse costs O(n^2)
per iteration; sequential Thomas elimination is O(n) but serializes.
Cyclic reduction trades that for log2(n) levels of fully vectorized
elementwise work, O(n log n) total.  (On the GPU,
``lax.linalg.tridiagonal_solve`` lowers to cuSPARSE; which wins on the
TV cells is not yet measured, ROADMAP §3.4.)

Because the matrix is fixed, the elimination coefficients (alpha, beta,
pivots) for every level are computed ONCE at setup on the host; each
per-iteration ``solve(b)`` runs only the b-phase:

  forward, level l (stride s = 2^l):   active i (i mod 2s == 2s-1):
      b_i -= alpha^l_i b_{i-s} + beta^l_i b_{i+s}
  back substitution, level l = L-1..0: active i (i mod 2s == s-1):
      x_i = (b_i - a^l_i x_{i-s} - c^l_i x_{i+s}) / d^l_i

The system is padded to n = 2^L - 1 with identity rows (exact no-ops).
All shifts are jnp.roll + masking — static shapes, no gathers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _shift_up(v, s):
    """v_{i-s} with zeros shifted in (values from lower indices)."""
    return jnp.roll(v, s).at[..., :s].set(0.0) if s else v


def _shift_down(v, s):
    """v_{i+s} with zeros shifted in."""
    return jnp.roll(v, -s).at[..., -s:].set(0.0) if s else v


@jax.tree_util.register_pytree_node_class
class CyclicReductionSolver:
    """Solve T x = b for fixed tridiagonal T = tridiag(dl, d, du).

    ``dense_cutoff`` (from_tridiag) enables the HYBRID scheme: run only
    the first k masked levels (the large strata, where the full-length
    vectorized form is efficient) and solve the level-k reduced
    system — size 2^(L-k) - 1 <= dense_cutoff — with one precomputed
    dense inverse apply (a single small GEMV).  The deep masked levels
    each stream full-length arrays to update a vanishing stratum, so at
    n = 65536 they are pure waste; cutting to a 1023-size dense tail
    removes 20 of 34 level sweeps.  A fully PACKED per-level layout
    (PackedCyclicReductionSolver below) is the asymptotically-optimal-
    bytes answer, built of small strided operations instead of big
    aligned sweeps.
    """

    def __init__(self, alphas, betas, a_lv, c_lv, d_lv, masks_f, masks_b, n,
                 Tinv=None, cut_stride=1):
        self.alphas = alphas    # (k, N) forward elimination coefficients
        self.betas = betas      # (k, N)
        self.a_lv = a_lv        # (k, N) sub-diagonal entering each level
        self.c_lv = c_lv        # (k, N) super-diagonal entering each level
        self.d_lv = d_lv        # (k, N) pivots entering each level
        self.masks_f = masks_f  # (k, N) forward-active masks
        self.masks_b = masks_b  # (k, N) backsub-active masks
        self.n = n              # true (unpadded) size
        self.Tinv = Tinv        # dense inverse of the level-k system (or None)
        self.cut_stride = cut_stride  # 2^k; 1 = pure masked CR

    @classmethod
    def from_tridiag(cls, dl, d, du,
                     dense_cutoff=None) -> "CyclicReductionSolver":
        """Precompute elimination state on the host (NumPy, one-time).

        ``dl[i] = T[i, i-1]`` (dl[0] unused), ``du[i] = T[i, i+1]``
        (du[-1] unused).  ``dense_cutoff``: stop the masked elimination
        once the reduced system is at most this size and finish it with
        a precomputed dense inverse (see class docstring).
        """
        dl = np.asarray(dl, np.float64)
        d0 = np.asarray(d, np.float64)
        du = np.asarray(du, np.float64)
        n = d0.shape[0]
        L = max(1, int(np.ceil(np.log2(n + 1))))
        N = 2**L - 1

        a = np.zeros(N)
        c = np.zeros(N)
        dd = np.ones(N)          # identity padding rows
        a[:n] = dl
        a[0] = 0.0
        c[:n] = du
        c[n - 1] = 0.0
        c[n:] = 0.0
        dd[:n] = d0

        # Hybrid cut: number of masked levels before the dense tail.
        n_levels = L
        if dense_cutoff is not None and dense_cutoff >= 1:
            k = 0
            while k < L - 1 and 2 ** (L - k) - 1 > dense_cutoff:
                k += 1
            n_levels = k

        alphas, betas = [], []
        a_lv, c_lv, d_lv = [], [], []
        masks_f, masks_b = [], []
        idx = np.arange(N)
        for l in range(n_levels):
            s = 2**l
            mf = (idx % (2 * s)) == (2 * s - 1)      # forward-active
            mb = (idx % (2 * s)) == (s - 1)          # backsub-active
            a_lv.append(a.copy())
            c_lv.append(c.copy())
            d_lv.append(dd.copy())
            masks_b.append(mb)

            am = np.roll(dd, s); am[:s] = 1.0        # d_{i-s}
            ap = np.roll(dd, -s); ap[-s:] = 1.0      # d_{i+s}
            alpha = np.where(mf, a / am, 0.0)
            beta = np.where(mf, c / ap, 0.0)
            alphas.append(alpha)
            betas.append(beta)
            masks_f.append(mf)

            a_up = np.roll(a, s); a_up[:s] = 0.0
            c_up = np.roll(c, s); c_up[:s] = 0.0
            a_dn = np.roll(a, -s); a_dn[-s:] = 0.0
            c_dn = np.roll(c, -s); c_dn[-s:] = 0.0
            dd = np.where(mf, dd - alpha * c_up - beta * a_dn, dd)
            a_new = np.where(mf, -alpha * a_up, a)
            c_new = np.where(mf, -beta * c_dn, c)
            a, c = a_new, c_new

        Tinv, stride = None, 1
        if n_levels < L:
            # Dense inverse of the level-k reduced tridiagonal, which
            # lives on the stratum i = 2^k - 1 :: 2^k.
            stride = 2 ** n_levels
            sl = slice(stride - 1, None, stride)
            av, cv, dv = a[sl], c[sl], dd[sl]
            M = dv.shape[0]
            Tk = np.diag(dv)
            if M > 1:
                Tk += np.diag(av[1:], -1) + np.diag(cv[:-1], 1)
            Tinv = jnp.asarray(np.linalg.inv(Tk))

        # Precompute in f64 on the host; store at the platform's widest
        # available float (f64 under x64, f32 otherwise).
        pack = lambda arrs: (jnp.asarray(np.stack(arrs)) if arrs
                             else jnp.zeros((0, N)))
        packb = lambda arrs: (jnp.asarray(np.stack(arrs)) if arrs
                              else jnp.zeros((0, N), bool))
        return cls(
            pack(alphas), pack(betas), pack(a_lv), pack(c_lv), pack(d_lv),
            packb(masks_f), packb(masks_b), n, Tinv=Tinv, cut_stride=stride,
        )

    def solve(self, b):
        dt = b.dtype
        N = self.alphas.shape[1]
        L = self.alphas.shape[0]  # masked levels (k under the hybrid cut)
        bb = jnp.zeros((N,), dt).at[: self.n].set(b)

        # forward b-reduction
        for l in range(L):
            s = 2**l
            upd = (
                bb
                - self.alphas[l].astype(dt) * _shift_up(bb, s)
                - self.betas[l].astype(dt) * _shift_down(bb, s)
            )
            bb = jnp.where(self.masks_f[l], upd, bb)

        if self.Tinv is None:
            x = jnp.zeros((N,), dt)
        else:
            # Dense tail: solve the level-k reduced system in one GEMV
            # and scatter onto its stratum.
            st = self.cut_stride
            y = bb[st - 1 :: st]
            xs = self.Tinv.astype(dt) @ y
            x = jnp.zeros((N,), dt).at[st - 1 :: st].set(xs)

        # back substitution
        for l in range(L - 1, -1, -1):
            s = 2**l
            num = (
                bb
                - self.a_lv[l].astype(dt) * _shift_up(x, s)
                - self.c_lv[l].astype(dt) * _shift_down(x, s)
            )
            x = jnp.where(self.masks_b[l], num / self.d_lv[l].astype(dt), x)

        return x[: self.n]

    def tree_flatten(self):
        return (
            (self.alphas, self.betas, self.a_lv, self.c_lv, self.d_lv,
             self.masks_f, self.masks_b, self.Tinv),
            (self.n, self.cut_stride),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        *arrs, Tinv = children
        n, stride = aux
        return cls(*arrs, n, Tinv=Tinv, cut_stride=stride)


@jax.tree_util.register_pytree_node_class
class PackedCyclicReductionSolver:
    """Cyclic reduction with PACKED per-level state: O(n) streamed bytes
    per solve instead of the masked variant's O(n log n).

    The masked solver above streams full-length (N,) coefficient arrays
    at every one of the 2 log2(n) levels — ~93 MB per solve at n = 65536,
    and it measures at ~85% of that self-inflicted stream bound (round-4
    probe).  But each level only touches a geometrically shrinking
    stratum.  This variant stores each level's coefficients packed to its
    stratum, so level l moves 2^(L-l) floats and the whole solve streams
    ~4 N floats total: the classic even/odd CR recursion, laid out for
    elementwise work with static shapes and no gathers (stride-2 slices and an
    interleaving reshape per level).

    Derivation (sizes exact for N = 2^L - 1, identity-padded): in packed
    coordinates p over the level-l system (global index s-1 + p*s,
    s = 2^l, size M_l = 2^(L-l) - 1), the forward pass eliminates odd p
    (neighbors p +- 1 are even), the reduced system is the odd stratum,
    and back substitution solves even p from the already-known odd
    solutions.  M_l odd means no edge cases: odd p's neighbors always
    exist, even p's missing boundary neighbors multiply exact zeros.
    """

    def __init__(self, alphas, betas, a_lv, c_lv, d_lv, n):
        # Tuples of per-level PACKED arrays:
        #   alphas[l], betas[l]: (2^(L-l-1) - 1,) forward coefficients
        #   a_lv[l], c_lv[l], d_lv[l]: (2^(L-l-1),) back-sub row entries
        self.alphas = alphas
        self.betas = betas
        self.a_lv = a_lv
        self.c_lv = c_lv
        self.d_lv = d_lv
        self.n = n

    @classmethod
    def from_tridiag(cls, dl, d, du) -> "PackedCyclicReductionSolver":
        """Precompute packed elimination state on the host (f64)."""
        dl = np.asarray(dl, np.float64)
        d0 = np.asarray(d, np.float64)
        du = np.asarray(du, np.float64)
        n = d0.shape[0]
        L = max(1, int(np.ceil(np.log2(n + 1))))
        N = 2**L - 1

        a = np.zeros(N)
        c = np.zeros(N)
        dd = np.ones(N)  # identity padding rows
        a[:n] = dl
        a[0] = 0.0
        c[:n] = du
        c[n - 1] = 0.0
        c[n:] = 0.0
        dd[:n] = d0

        alphas, betas, a_lv, c_lv, d_lv = [], [], [], [], []
        for _ in range(L):
            odd_a, odd_c, odd_d = a[1::2], c[1::2], dd[1::2]
            ev_a, ev_c, ev_d = a[0::2], c[0::2], dd[0::2]
            m = odd_d.shape[0]           # 2^(L-l-1) - 1
            alpha = odd_a / ev_d[:m]     # / d_{p-1}
            beta = odd_c / ev_d[1:m + 1]  # / d_{p+1}
            alphas.append(alpha)
            betas.append(beta)
            a_lv.append(ev_a)
            c_lv.append(ev_c)
            d_lv.append(ev_d)
            # Reduced tridiagonal on the odd stratum.
            dd = odd_d - alpha * ev_c[:m] - beta * ev_a[1:m + 1]
            a = -alpha * ev_a[:m]
            c = -beta * ev_c[1:m + 1]

        J = jnp.asarray
        return cls(tuple(J(v) for v in alphas), tuple(J(v) for v in betas),
                   tuple(J(v) for v in a_lv), tuple(J(v) for v in c_lv),
                   tuple(J(v) for v in d_lv), n)

    def solve(self, b):
        """Solve T x = b; supports leading batch dimensions on ``b``."""
        dt = b.dtype
        L = len(self.alphas)
        N = 2**L - 1
        lead = b.shape[:-1]
        bb = jnp.zeros(lead + (N,), dt).at[..., : self.n].set(b)

        # Forward: eliminate odd packed positions, recurse on them.
        evens = []
        cur = bb
        for l in range(L):
            odd = cur[..., 1::2]
            ev = cur[..., 0::2]
            m = odd.shape[-1]
            evens.append(ev)
            cur = (odd
                   - self.alphas[l].astype(dt) * ev[..., :m]
                   - self.betas[l].astype(dt) * ev[..., 1:m + 1])

        # Back substitution: solve even positions, interleave.
        x = cur  # length-0 remnant below the last level
        for l in range(L - 1, -1, -1):
            ev_b = evens[l]
            m = x.shape[-1]              # odd-stratum solutions
            pad = [(0, 0)] * (x.ndim - 1)
            x_m1 = jnp.pad(x, pad + [(1, 0)])   # x_{p-1} for even p
            x_p1 = jnp.pad(x, pad + [(0, 1)])   # x_{p+1}
            x_even = (ev_b
                      - self.a_lv[l].astype(dt) * x_m1
                      - self.c_lv[l].astype(dt) * x_p1) / self.d_lv[l].astype(dt)
            # Interleave even/odd strata back to level-l ordering.
            merged = jnp.stack(
                [x_even[..., :m], x], axis=-1).reshape(lead + (2 * m,))
            x = jnp.concatenate([merged, x_even[..., m:]], axis=-1)

        return x[..., : self.n]

    def tree_flatten(self):
        return ((self.alphas, self.betas, self.a_lv, self.c_lv, self.d_lv),
                self.n)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux)
