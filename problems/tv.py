"""E4 — Total-variation denoising:  min ½‖x−b‖² + μ·TV(x), 512×512.

Solved on the dual (SURVEY.md §3.3 / oracle make_tv): the FASTA variable
is the dual field p ∈ ℝ^{2×H×W}, A = μ·div (the (2,H,W)→(H,W) adjoint of
the forward-difference gradient), f(Ap) = ½‖Ap−b‖², g = indicator of the
∞-ball, and the denoised image is recovered as x* = b − μ·div(p*).

No matrix is ever materialized: the operator is a pure-XLA stencil
(pad/slice composition) that fuses into the elementwise graph — the
structured-operator call stack of the reference (BASELINE.json config 4).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from fasta_tpu import BoxIndicator, LeastSquares, ScaledOp, TVDiv2D
from fasta_tpu.problem import Problem
from reference_oracle.generators import make_tv, tv_div_2d

from . import register

__all__ = ["build"]


@register("tv")
def build(h: int = 512, w: int = 512, mu: float = 0.1, sigma: float = 0.1,
          seed: int = 4, dtype=jnp.float32) -> Problem:
    inst = make_tv(h=h, w=w, mu=mu, sigma=sigma, seed=seed)
    b_np = inst["b"]
    return Problem(
        name=f"tv[{h}x{w}]",
        op=ScaledOp(mu, TVDiv2D()),
        fterm=LeastSquares(jnp.asarray(b_np, dtype)),
        gterm=BoxIndicator(-1.0, 1.0),
        x0=jnp.asarray(inst["x0"], dtype),
        x_true=inst["x_true"],
        instance=inst,
        recover=lambda p: b_np - mu * tv_div_2d(np.asarray(p, np.float64)),
    )


if __name__ == "__main__":
    from fasta_tpu.harness import compare_modes, format_comparison
    problem = build()
    print(format_comparison(problem, compare_modes(problem, tol=1e-5,
                                                   max_iters=500)))
