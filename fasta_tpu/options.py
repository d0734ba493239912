"""Solver options — the reference-compatible configuration surface.

Mirrors the option set of the reference solver (see SURVEY.md §2.1 C1/C4 and
the FASTA user manual arXiv:1501.04979 §5): every enhancement (adaptive BB
stepsize, FISTA acceleration, backtracking, restart) is independently
toggleable, the stopping rule is selectable, and the defaults follow the
reference conventions (adaptive on, acceleration off, backtracking on,
window 10, stepsize_shrink 0.2 when adaptive else 0.5).

``FastaOptions`` is a frozen (hashable) dataclass so it can be closed over
by ``jax.jit`` as static configuration: every boolean/rule choice selects a
trace-time branch, never a runtime one — the compiled solver contains only
the code for the chosen mode (SURVEY.md §7 step 1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

__all__ = ["FastaOptions", "STOP_RULES"]

# Stopping rules, matching reference_oracle.fasta_numpy.STOP_RULES
# (reference manual arXiv:1501.04979 §5: residual / normalizedResidual /
# ratioResidual / hybridResidual / iterations).
STOP_RULES = (
    "residual",
    "normalized_residual",
    "ratio_residual",
    "hybrid_residual",
    "iterations",
)


@dataclasses.dataclass(frozen=True)
class FastaOptions:
    """Static solver configuration (hashable; safe as a jit closure).

    Field semantics are identical to the keyword arguments of the in-repo
    float64 oracle ``reference_oracle.fasta_numpy.fasta`` — that module is
    the authoritative algorithm spec (the upstream mount was empty, see
    SURVEY.md §0).
    """

    max_iters: int = 1000
    tol: float = 1e-3
    adaptive: bool = True
    accelerate: bool = False
    backtrack: bool = True
    restart: bool = True
    window: int = 10
    max_backtracks: int = 20
    stepsize_shrink: Optional[float] = None   # default 0.2 adaptive else 0.5
    eps_r: float = 1e-8
    eps_n: float = 1e-8
    stop_rule: str = "hybrid_residual"
    record_objective: bool = False
    record_iterates: bool = False
    # LEAN serving mode: skip ALL per-iteration diagnostic recording
    # (residuals/taus/fvals/backtracks arrays come back None).  The
    # iteration math, stopping decisions and solution are unchanged —
    # only the ~6 dynamic-update-slice kernels per iteration disappear,
    # which matters on the latency-bound hot loop.  Incompatible with
    # record_objective/record_iterates and with solve_path (which
    # warm-starts from the recorded taus).
    record_diagnostics: bool = True
    verbose: bool = False
    # Let the smooth term provide a fused (d, f, grad) evaluation (one
    # shard_map region with a single psum when sharded; enables the
    # zero-matvec FISTA gradient extrapolation for quadratic f).  Purely
    # an execution strategy — iteration math is unchanged.
    fuse: bool = True
    # Device-side sanitizer (SURVEY.md §5): halt the loop the moment the
    # objective or residual goes NaN/Inf and flag it in the result —
    # instead of burning the remaining iterations on garbage.
    guard_nonfinite: bool = False
    # Custom stopping rule (the reference's stopNow hook): a traceable
    # callable (k, residual, norm_residual, max_residual, f1) -> bool
    # scalar, OR-combined with the selected stop_rule.  Hashed by
    # identity (use a module-level function for cache stability).
    stop_fn: Optional[Callable] = None
    # Decision-scalar precision (SURVEY.md §7 hard part 3).  "high"
    # carries every stepsize/backtracking/stopping scalar (⟨Δx,Δg⟩,
    # ‖·‖², f-values and the nonmonotone window) in double-word float32
    # arithmetic (fasta_tpu/precision.py) — oracle-grade decisions on
    # a float32 data path without float64 storage.  "auto" (the
    # default) enables this exactly when the iterate dtype is below
    # float64; "standard" uses plain working-precision reductions.
    precision: str = "auto"

    # Mode precedence matches the oracle (fasta_numpy.py: ``if adaptive and
    # not accelerate ... elif accelerate``): acceleration wins when both are
    # set, since ``adaptive=True`` is the default and the mode-comparison
    # harness toggles ``accelerate`` alone.
    @property
    def effective_mode(self) -> str:
        if self.accelerate:
            return "accelerated"
        if self.adaptive:
            return "adaptive"
        return "plain"

    def __post_init__(self):
        if self.stop_rule not in STOP_RULES:
            raise ValueError(
                f"stop_rule must be one of {STOP_RULES}, got {self.stop_rule!r}")
        if self.precision not in ("auto", "standard", "high"):
            raise ValueError(
                "precision must be 'auto', 'standard' or 'high', "
                f"got {self.precision!r}")
        if self.window < 1:
            raise ValueError("window must be >= 1")
        if self.max_iters < 1:
            raise ValueError("max_iters must be >= 1")
        if not self.record_diagnostics and (self.record_objective
                                            or self.record_iterates):
            raise ValueError(
                "record_objective/record_iterates need "
                "record_diagnostics=True")

    @property
    def shrink_factor(self) -> float:
        """Backtracking shrink factor with the reference's mode-dependent
        default: 0.2 when adaptive (aggressive — BB recovers quickly),
        0.5 otherwise."""
        if self.stepsize_shrink is not None:
            return self.stepsize_shrink
        return 0.2 if self.adaptive else 0.5

    def replace(self, **kw) -> "FastaOptions":
        return dataclasses.replace(self, **kw)
