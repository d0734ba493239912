"""fasta-tpu — a forward-backward splitting (FASTA) engine in JAX.

Built from scratch on JAX/XLA with the capabilities of
``phasepack/fasta-python`` (see SURVEY.md): solves  min_x f(Ax) + g(x)
with f smooth and g prox-friendly, featuring adaptive Barzilai–Borwein
stepsizes, nonmonotone backtracking, FISTA acceleration with adaptive
restart, pluggable linear/proximal operators, full diagnostics, and
multi-device row-sharded scaling over a ``jax.sharding.Mesh``.

Public surface:
  fasta(...)        — reference-compatible one-call solver (host result)
  solve(...)        — device-side solve on pytree terms (stays on device)
  make_solver(...)  — jitted solver factory, cached per option set
  FastaOptions      — the static option set (the compatibility surface)
  operators         — pytree LinearOps (dense, stencil, FFT, composed)
  terms             — pytree objective terms (LeastSquares, L1Norm, …)
  prox              — closed-form proximal operators / projections
  smooth            — raw-callable smooth-term builders (closure style)
  sharding          — mesh construction + row-sharded problem placement
"""

from . import checkpoint, operators, plotting, profiling, prox, smooth, terms
from .operators import (
    LinearOp, DenseOp, IdentityOp, FunctionOp, TVGrad2D, TVDiv2D,
    MaskedFourierOp, DiagonalOp, ScaledOp, ComposeOp, StackedOp,
    PlanarDenseOp, LowPrecDenseOp, SparseOp, as_linear_op,
    check_adjoint,
)
from .options import FastaOptions, STOP_RULES
from .solver import (
    fasta, solve, make_solver, make_stateful_solver, resume_state,
    make_batch_solver, solve_path, estimate_stepsize,
    FastaResult, DeviceResult, SolverState, Diagnostics,
)
from . import precision
from .problem import Problem
from .terms import (
    SmoothTerm, LeastSquares, Logistic, MaskedLogistic, PhaseHinge, NMFLoss,
    PlanarPhaseHinge, SquaredHinge, FunctionSmooth, ProxTerm, L1Norm,
    LinfNorm, L21Norm, NuclearNorm, NonnegIndicator, BoxIndicator,
    LinfBallIndicator, MaxRowNormBall, LinearAnchor, PlanarLinearAnchor,
    L2Norm2, ZeroTerm, FunctionProx, as_smooth_term, as_prox_term,
)

__version__ = "0.3.0"

__all__ = [
    "fasta", "solve", "make_solver", "make_stateful_solver",
    "resume_state", "make_batch_solver", "solve_path",
    "estimate_stepsize", "FastaResult", "DeviceResult", "SolverState",
    "Diagnostics", "FastaOptions", "STOP_RULES", "LinearOp", "DenseOp",
    "IdentityOp", "FunctionOp", "TVGrad2D", "TVDiv2D", "MaskedFourierOp",
    "DiagonalOp", "ScaledOp", "ComposeOp", "StackedOp", "PlanarDenseOp", "LowPrecDenseOp", "SparseOp", "as_linear_op",
    "check_adjoint", "SmoothTerm", "LeastSquares", "Logistic",
    "MaskedLogistic", "PhaseHinge", "PlanarPhaseHinge", "SquaredHinge", "FunctionSmooth",
    "ProxTerm", "L1Norm", "LinfNorm", "L21Norm", "NuclearNorm",
    "NonnegIndicator", "BoxIndicator", "LinfBallIndicator",
    "MaxRowNormBall", "LinearAnchor", "PlanarLinearAnchor", "L2Norm2", "ZeroTerm",
    "Problem",
    "FunctionProx", "as_smooth_term", "as_prox_term", "checkpoint",
    "operators", "plotting", "profiling", "prox", "smooth", "terms",
]
