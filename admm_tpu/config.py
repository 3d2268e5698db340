"""ADMM engine configuration.

A frozen dataclass mirroring the reference's ``options`` struct / ``setopt``
resolution (reference: admm.m:51-76 for the reads, admm.m:780-971 for the
per-option documentation and defaults).  Every option name and default below
matches the reference unless noted.

Unlike the reference (which resolves options dynamically each call), the
config is *static*: it selects which branches get traced into the compiled
XLA program, so e.g. ``fast=True`` compiles a different (momentum-carrying)
loop body rather than branching at runtime.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    """Static configuration for the ADMM engine.

    Mirrors reference admm.m options (defaults at admm.m:51-76):

    - ``rho``: dual step size (admm.m:57; under ``adaptive`` this is the
      initial rho).
    - ``maxiters``: iteration cap N (admm.m:58).
    - ``domaxiters``: run all N iterations even if converged (admm.m:59).
    - ``relax``: over/under-relaxation parameter; != 1 enables relaxation in
      the z- and u-updates (admm.m:60, 515-532).
    - ``fast`` / ``fasttype``: Goldstein fast ('strong') / accelerated with
      restart ('weak', default) ADMM (admm.m:63-64, 264-298, 563-600).
    - ``restart``: accelerated-ADMM restart fraction (admm.m:282-287).
    - ``dvaltol``: accelerated-ADMM d-value stop tolerance (admm.m:290).
    - ``abstol`` / ``reltol``: Boyd stopping tolerances (admm.m:71-72).
    - ``hnormtol``: H-norm stopping tolerance (admm.m:73).
    - ``convtest`` / ``convtol``: divergence monitor on monotone H-norm
      decrease (admm.m:67-68, 686-703).
    - ``stopcond``: 'standard' | 'hnorm' | 'both' (admm.m:69, 705-722).
    - ``nodualerror``: skip the dual half of the standard stop (admm.m:70).
    - ``adaptive``: experimental adaptive rho (admm.m:51, 724-741).
    - ``objevals``: record the objective each iteration (admm.m:66, 602-605).

    Additions beyond the reference:

    - ``nanguard``: abort (results.diverged) as soon as the primal norm
      goes non-finite, instead of burning the rest of the iteration
      budget on NaNs.  No reference analog (its loop runs on).
    - ``rbadaptive`` / ``rbmu`` / ``rbtau``: residual-balancing adaptive
      rho (Boyd et al. 2011, section 3.4.1): grow rho by tau when
      pnorm > mu * dnorm, shrink when dnorm > mu * pnorm, and rescale the
      scaled dual u by rho_old/rho_new (the rescaling the reference's
      experimental mode omits).  Requires prox operators valid for any
      runtime rho — the library's eigh-folded solvers all are.  Note:
      the balancing compares the pnorm/dnorm the loop computes; a
      hooks.specialnorms override returning SQUARED norms (the
      reference's lassonorms convention) shifts the trigger to
      sqrt(rbmu) imbalance — unsquare in the hook, or use
      parallel.consensus_admm, which handles this itself.

    Further additions (no reference equivalent):

    - ``record_iterates``: also record full per-iteration x/z/u/w traces
      (the reference records these unconditionally, admm.m:607-610,
      680-682; here they are opt-in because a (maxiters, n) buffer is
      HBM-expensive).
    - ``stallwindow`` / ``stalltol``: plateau detector for reduced
      precision (no reference analog; its f64 loop either converges or
      hits maxiters, admm.m:705-722).  At f32 the primal residual can
      floor ABOVE the Boyd gate — the stopping rule then never fires and
      the solve burns the whole iteration budget at constant quality.
      With ``stallwindow = k > 0``, the loop stops (results.stalled)
      once the best-seen pnorm has not improved by a relative
      ``stalltol`` for k consecutive iterations.  Disabled by default
      and under ``domaxiters`` (which demands all N iterations).
    - ``anderson`` / ``aa_reg`` / ``aa_restart`` / ``aa_gmax``:
      safeguarded type-II Anderson acceleration on the ADMM fixed-point
      map (the SCS / A2DR convergence lever; no reference analog).
      ``anderson = m > 0`` keeps a window of the last m iterate/residual
      differences of the full state s = (x, z, u) and replaces the next
      iterate with the regularized least-squares extrapolation
      ``T(s_k) - dT @ gamma``, ``gamma = (dF dFᵀ + reg)⁻¹ dF f_k`` —
      an (m, m) solve plus a few extra vector streams per iteration,
      negligible next to a GEMV body.  Safeguards: the candidate is
      dropped when non-finite or when ``sum|gamma| > aa_gmax`` (ill-
      conditioned window), and the history restarts when the residual
      norm grows past ``aa_restart`` times the best seen since the last
      restart.  Applies to the standard iteration only (the map must be
      fixed): incompatible with ``fast``, adaptive rho modes,
      ``convtest`` (AA breaks H-norm monotonicity), and non-standard
      ``stopcond``.  Stopping/residual records are those of the plain
      sweep, so a converged run reports the un-extrapolated iterate.
    """

    rho: float = 1.0
    maxiters: int = 1000
    domaxiters: bool = False
    relax: float = 1.0
    fast: bool = False
    fasttype: str = "weak"  # 'weak' -> accelerated+restart, 'strong' -> fast
    restart: float = 0.999
    dvaltol: float = 1e-8
    abstol: float = 1e-5
    reltol: float = 1e-3
    hnormtol: float = 1e-6
    convtest: bool = False
    convtol: float = 1e-10
    stopcond: str = "standard"  # 'standard' | 'hnorm' | 'both'
    nodualerror: bool = False
    adaptive: bool = False
    rbadaptive: bool = False
    rbmu: float = 10.0
    rbtau: float = 2.0
    nanguard: bool = True
    stallwindow: int = 0
    stalltol: float = 1e-3
    anderson: int = 0
    aa_reg: float = 1e-8
    aa_restart: float = 5.0
    aa_gmax: float = 1e3
    objevals: bool = False
    quiet: bool = True
    record_iterates: bool = False
    jit: bool = True
    # Iterations per while_loop step (no reference analog).  Each device
    # loop turn has a fixed cost that can rival a small iteration body,
    # so unrolling K reference iterations into one loop step amortizes it.
    # Semantics are EXACT: sub-steps after convergence are computed but
    # discarded via done-masking, so results and step counts match
    # unroll=1 bit-for-bit; the only cost is up to K-1 wasted sub-steps
    # in the final loop turn (and K-times-larger compiled body).
    #
    # "auto" lets each solver wrapper resolve K for its iteration-body
    # class (resolve_unroll below): GEMV-dominated bodies get a deep
    # unroll, heavy bodies (in-loop eigh / triangular sweeps) stay at 1,
    # and batched lanes resolve to 1.
    # Calling the engine directly with "auto" resolves to the balanced
    # default (4) since the engine cannot classify a user prox.
    unroll: int | str = 1

    def __post_init__(self):
        if self.stopcond not in ("standard", "hnorm", "both"):
            raise ValueError(f"stopcond must be standard|hnorm|both, got {self.stopcond!r}")
        if self.fasttype not in ("weak", "strong"):
            raise ValueError(f"fasttype must be weak|strong, got {self.fasttype!r}")
        if self.maxiters <= 0:
            raise ValueError("maxiters must be positive")
        # Reference clamps a bad restart fraction back to the default
        # (admm.m:285-287).
        if self.fast and self.fasttype == "weak" and not (0.0 < self.restart < 1.0):
            object.__setattr__(self, "restart", 0.999)
        if self.rbadaptive and self.nodualerror:
            raise ValueError("rbadaptive needs dual residuals (nodualerror=False)")
        if self.rbadaptive and self.adaptive:
            raise ValueError("choose one adaptive-rho mode: adaptive or rbadaptive")
        if self.rbadaptive and self.fast:
            raise ValueError("rbadaptive applies to the standard iteration only")
        if self.stallwindow < 0:
            raise ValueError(f"stallwindow must be >= 0, got {self.stallwindow}")
        if self.anderson < 0:
            raise ValueError(f"anderson must be >= 0, got {self.anderson}")
        if self.anderson:
            # AA extrapolates the fixed-point map of the STANDARD
            # iteration; momentum or a runtime-varying rho changes the
            # map mid-flight, and the H-norm machinery (convtest /
            # hnorm stops) assumes the monotone plain sweep.
            if self.fast:
                raise ValueError("anderson applies to the standard "
                                 "iteration only (fast=False)")
            if self.adaptive or self.rbadaptive:
                raise ValueError("anderson requires a fixed rho (no "
                                 "adaptive/rbadaptive)")
            if self.convtest or self.stopcond != "standard":
                raise ValueError("anderson breaks H-norm monotonicity: "
                                 "use stopcond='standard', convtest=False")
        if self.aa_reg < 0 or self.aa_restart <= 1.0 or self.aa_gmax <= 0:
            raise ValueError("need aa_reg >= 0, aa_restart > 1, aa_gmax > 0")
        if not 0.0 <= self.stalltol < 1.0:
            raise ValueError(f"stalltol must be in [0, 1), got {self.stalltol}")
        if isinstance(self.unroll, str):
            if self.unroll != "auto":
                raise ValueError(
                    f"unroll must be an int >= 1 or 'auto', got {self.unroll!r}")
        elif self.unroll < 1:
            raise ValueError(f"unroll must be >= 1, got {self.unroll}")

    @property
    def resolved(self) -> bool:
        """Whether unroll has been resolved to a concrete int."""
        return not isinstance(self.unroll, str)

    @property
    def alg(self) -> int:
        """Algorithm id, matching the reference's ``alg`` variable
        (admm.m:262-298): 0 = standard, 1 = fast (strong convexity),
        2 = accelerated with restart (weak convexity)."""
        if not self.fast:
            return 0
        return 1 if self.fasttype == "strong" else 2

    @property
    def needs_hnorm(self) -> bool:
        """Whether the H-norm machinery must be traced (admm.m:302-313)."""
        return self.convtest or self.stopcond in ("hnorm", "both")

    @property
    def use_stall(self) -> bool:
        """Whether the plateau detector is traced into the loop (see
        ``stallwindow``); domaxiters wins, as it does for the standard
        and hnorm stops (admm.m:705-722)."""
        return self.stallwindow > 0 and not self.domaxiters

    @property
    def dynamic_rho(self) -> bool:
        """Whether rho can change at runtime — prox builders must then use
        the rho-parameterized (eigh-folded) solve paths."""
        return self.adaptive or self.rbadaptive


# unroll='auto' resolution table, by iteration-body class.  The values
# were chosen on an earlier accelerator and are not yet re-derived on
# the H100 (ROADMAP §1.3; chip_smoke.py prints the headline lasso at
# unroll 1, 16 and 64):
#
# - 'gemv': bodies that are a handful of GEMVs + vector ops (lasso, lad,
#   huberfit, model, basis pursuit, serial SVM, LP/QP in affine mode),
#   where the loop turn is a large share of an iteration.  K=64 compiles
#   a much larger program — opt in explicitly.
# - 'heavy': bodies dominated by an in-loop eigh / Newton-Schulz /
#   triangular sweep (covariance selection, LP/QP kkt_mode='chol'):
#   masked redundant sub-steps can cost more than the turn they save.
# - 'batched': vmapped instance-batched lanes already amortize the loop
#   turn over B lanes.
# - 'default': unknown body (engine called directly with a user prox).
_AUTO_UNROLL = {"gemv": 16, "heavy": 1, "batched": 1, "default": 4}


def resolve_unroll(config: ADMMConfig, body: str = "default") -> ADMMConfig:
    """Resolve ``unroll='auto'`` to the table's K for the given
    iteration-body class (no-op for concrete ints).  Wrappers call this
    with their body class before handing the config to the engine, so
    the compiled-runner caches only ever see concrete unroll values."""
    if isinstance(config.unroll, str):
        return dataclasses.replace(config, unroll=_AUTO_UNROLL[body])
    return config
