"""E1 — LASSO / BPDN:  min ½‖Ax−b‖² + μ‖x‖₁.

The reference's flagship example (dense Gaussian A 1000×2000, sparse
planted signal; BASELINE.json config 1).  Instance data comes from the
shared float64 generator; the JAX solver consumes the same arrays cast to
the working dtype, so the oracle and this module solve bit-identical
problems (SURVEY.md §7 hard part 5).
"""

from __future__ import annotations

import jax.numpy as jnp

from fasta_tpu import DenseOp, L1Norm, LeastSquares
from fasta_tpu.problem import Problem
from reference_oracle.generators import make_lasso

from . import register

__all__ = ["build"]


@register("lasso")
def build(m: int = 1000, n: int = 2000, k: int = 100, mu: float = 0.1,
          seed: int = 1, dtype=jnp.float32) -> Problem:
    inst = make_lasso(m=m, n=n, k=k, mu=mu, seed=seed)
    return Problem(
        name=f"lasso[{m}x{n}]",
        op=DenseOp(jnp.asarray(inst["A"], dtype)),
        fterm=LeastSquares(jnp.asarray(inst["b"], dtype)),
        gterm=L1Norm(mu),
        x0=jnp.asarray(inst["x0"], dtype),
        x_true=inst["x_true"],
        instance=inst,
    )


if __name__ == "__main__":
    from fasta_tpu.harness import compare_modes, format_comparison
    problem = build()
    print(format_comparison(problem, compare_modes(problem, tol=1e-6,
                                                   max_iters=2000)))
