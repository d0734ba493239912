"""E10 — Sparse-operator LASSO:  min ½‖Ax−b‖² + μ‖x‖₁ with a SPARSE A.

The reference accepts scipy.sparse matrices through its operator wrapper
(capability C2, SURVEY.md §2.1); the JAX mapping is a BCOO
``SparseOp`` (fasta_tpu/operators.py) whose matvecs XLA lowers to
gather/segment-sum kernels.  Oracle counterpart:
reference_oracle/generators.py make_sparse_lasso (the identical scipy
CSR matrix drives the oracle through closure matvecs).
"""

from __future__ import annotations

import jax.numpy as jnp

from fasta_tpu import L1Norm, LeastSquares, SparseOp
from fasta_tpu.problem import Problem
from reference_oracle.generators import make_sparse_lasso

from . import register

__all__ = ["build"]


@register("sparse_lasso")
def build(m: int = 1500, n: int = 3000, density: float = 0.02,
          k: int = 80, mu: float = 0.1, seed: int = 12,
          dtype=jnp.float32) -> Problem:
    inst = make_sparse_lasso(m=m, n=n, density=density, k=k, mu=mu,
                             seed=seed)
    return Problem(
        name=f"sparse_lasso[{m}x{n}@{density}]",
        op=SparseOp.from_scipy(inst["A_sparse"], dtype=dtype),
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
