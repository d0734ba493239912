"""Canonical FASTA problem suite — the workload library (SURVEY.md §2.2).

Each module mirrors one of the reference's example problems: it
synthesizes an instance with a planted solution (via the shared NumPy
generators in ``reference_oracle/generators.py`` — identical data feeds
the oracle and the JAX solver, RNG parity by construction), defines the
JAX ``(op, f, gradf, g, proxg)`` pieces, and is runnable as
``python -m problems.<name>`` to print the three-mode comparison table.

Required (BASELINE.json configs):
  lasso            E1  sparse least squares, dense Gaussian 1000×2000
  nnls             E2  non-negative least squares (projection prox)
  logistic         E3  sparse logistic regression (non-quadratic f)
  tv               E4  total-variation denoising 512×512 (stencil op)
  phase_retrieval  E5  PhaseMax-style, complex A, 16k measurements

Additional capability parity (upstream example set, SURVEY.md §2.2):
  democratic       E6  L∞-penalized least squares
  mmv              E7  multiple-measurement-vector row sparsity (L2,1)
  matrix_completion E8 logistic 1-bit matrix completion (SVT prox)
  max_norm         E9  max-norm regularized factorization surrogate
  sparse_lasso     E10 LASSO over a scipy-sparse operator (BCOO SparseOp)
  nmf              E11 joint nonnegative matrix factorization ([P1] app.)
"""

from typing import Callable, Dict

REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        REGISTRY[name] = fn
        return fn
    return deco


def build(name: str, **kwargs):
    """Construct a named problem instance: ``build('lasso', m=..., ...)``."""
    from . import (lasso, nnls, logistic, tv, phase_retrieval,  # noqa: F401
                   phase_retrieval_cdp, democratic, mmv,
                   matrix_completion, max_norm, svm, nmf, sparse_lasso)
    return REGISTRY[name](**kwargs)
