"""Sparse operator (BCOO) — the scipy.sparse capability of the
reference, in JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import fasta_tpu as ft

RNG = np.random.default_rng(4)


def test_sparse_matvec_and_adjoint():
    M = sp.random(40, 24, density=0.2, format="csr", random_state=1)
    op = ft.SparseOp.from_scipy(M, dtype=jnp.float64)
    x = jnp.asarray(RNG.standard_normal(24))
    y = jnp.asarray(RNG.standard_normal(40))
    np.testing.assert_allclose(op(x), M @ np.asarray(x), atol=1e-12)
    np.testing.assert_allclose(op.rmatvec(y), M.T @ np.asarray(y),
                               atol=1e-12)
    ft.check_adjoint(op, jnp.zeros(24), jax.random.PRNGKey(0), rtol=1e-10)


def test_as_linear_op_dispatches_scipy():
    M = sp.random(10, 8, density=0.3, format="csc", random_state=2)
    op = ft.as_linear_op(M)
    assert isinstance(op, ft.SparseOp)


def test_sparse_lasso_solve_matches_dense():
    """Full solve through a sparse operator equals the dense solve.
    Overdetermined instance (unique minimizer) — underdetermined L1
    problems have degenerate optima where fp noise picks the vertex."""
    M = sp.random(90, 60, density=0.15, format="csr", random_state=3)
    A_dense = jnp.asarray(M.toarray())
    b = jnp.asarray(RNG.standard_normal(90))
    mu = 0.05
    opts = ft.FastaOptions(tol=1e-8, max_iters=200,
                           record_objective=True)
    r_sp = ft.solve(ft.SparseOp.from_scipy(M, dtype=jnp.float64),
                    ft.LeastSquares(b), ft.L1Norm(mu),
                    jnp.zeros(60), 0.1, opts)
    r_dn = ft.solve(ft.DenseOp(A_dense), ft.LeastSquares(b), ft.L1Norm(mu),
                    jnp.zeros(60), 0.1, opts.replace(fuse=False))
    # early trajectory identical; late iterations bifurcate at 1e-15
    # matvec noise on this degenerate underdetermined instance, so the
    # invariant is the objective
    np.testing.assert_allclose(np.asarray(r_sp.taus)[:20],
                               np.asarray(r_dn.taus)[:20], rtol=1e-9)
    k_sp = int(r_sp.iteration_count)
    k_dn = int(r_dn.iteration_count)
    obj_sp = float(np.asarray(r_sp.objectives)[k_sp - 1])
    obj_dn = float(np.asarray(r_dn.objectives)[k_dn - 1])
    assert abs(obj_sp - obj_dn) < 1e-6 * max(abs(obj_dn), 1e-10)
