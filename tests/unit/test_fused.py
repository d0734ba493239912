"""Tests for the fused gradmap path (the plain XLA graph on one device,
one shard_map region when sharded) and the affine FISTA gradient
extrapolation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fasta_tpu as ft
import problems


def _lasso(tau0=0.05):
    prob = problems.build("lasso", m=96, n=192, k=10, dtype=jnp.float64)
    prob.tau0 = tau0
    return prob


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_lstsq_gradmap_matches_unfused(dtype):
    """The fused (d, f, g) map the solver uses for a dense LeastSquares
    term equals the unfused op/term composition."""
    rng = np.random.default_rng(0)
    m, n = 64, 256
    A = jnp.asarray(rng.standard_normal((m, n)), dtype)
    x = jnp.asarray(rng.standard_normal(n), dtype)
    b = jnp.asarray(rng.standard_normal(m), dtype)
    op, term = ft.DenseOp(A), ft.LeastSquares(b)
    d, f, g = term.fused_gradmap(op)(x)
    rtol = 1e-12 if dtype == jnp.float64 else 1e-5
    np.testing.assert_allclose(d, op(x), rtol=rtol)
    np.testing.assert_allclose(float(f), float(term.value(op(x))),
                               rtol=rtol)
    np.testing.assert_allclose(g, op.rmatvec(term.grad(op(x))), rtol=rtol,
                               atol=rtol)


def test_tv_gradmap_matches_unfused():
    """The TV dual's fused map equals μ·div / μ·grad composed."""
    prob = problems.build("tv", h=12, w=10, dtype=jnp.float64)
    p = jnp.asarray(np.random.default_rng(1).standard_normal((2, 12, 10)))
    d, f, g = prob.fterm.fused_gradmap(prob.op)(p)
    np.testing.assert_allclose(d, prob.op(p), rtol=1e-13)
    np.testing.assert_allclose(float(f), float(prob.fterm.value(prob.op(p))),
                               rtol=1e-13)
    np.testing.assert_allclose(
        g, prob.op.rmatvec(prob.fterm.grad(prob.op(p))), rtol=1e-12,
        atol=1e-13)


@pytest.mark.parametrize("mode_kw", [
    dict(adaptive=True, accelerate=False),
    dict(adaptive=False, accelerate=False),
])
def test_fuse_flag_is_trajectory_invariant(mode_kw):
    """fuse=True evaluates the same matvecs as fuse=False, so the
    trajectory must match to machine precision."""
    prob = _lasso()
    r_on = prob.solve(tol=1e-10, max_iters=80, fuse=True, **mode_kw)
    r_off = prob.solve(tol=1e-10, max_iters=80, fuse=False, **mode_kw)
    assert r_on.iteration_count == r_off.iteration_count
    k = r_on.iteration_count
    np.testing.assert_allclose(r_on.taus[:k], r_off.taus[:k], rtol=1e-12)
    np.testing.assert_allclose(r_on.solution, r_off.solution, atol=1e-12)


def test_affine_accel_matches_direct_gradient():
    """Accelerated mode with the affine gradient extrapolation (zero
    extra matvecs) must agree with the direct Aᵀ(d_next−b) evaluation to
    fp-accumulation tolerance."""
    prob = _lasso()
    r_on = prob.solve(tol=1e-10, max_iters=100, fuse=True,
                      adaptive=False, accelerate=True)
    r_off = prob.solve(tol=1e-10, max_iters=100, fuse=False,
                       adaptive=False, accelerate=True)
    assert abs(r_on.iteration_count - r_off.iteration_count) <= 2
    k = min(r_on.iteration_count, r_off.iteration_count)
    np.testing.assert_allclose(r_on.residuals[:k], r_off.residuals[:k],
                               rtol=1e-6)
    np.testing.assert_allclose(r_on.solution, r_off.solution, atol=1e-8)


def test_fused_gradmap_only_for_dense_real():
    b = jnp.zeros(8)
    term = ft.LeastSquares(b)
    assert term.fused_gradmap(ft.IdentityOp()) is None
    A_c = jnp.zeros((8, 4), jnp.complex128)
    assert term.fused_gradmap(ft.DenseOp(A_c)) is None
    A_r = jnp.zeros((8, 4))
    assert term.fused_gradmap(ft.DenseOp(A_r)) is not None


def test_nonquadratic_terms_do_not_fuse():
    assert ft.Logistic(jnp.zeros(8)).fused_gradmap(
        ft.DenseOp(jnp.zeros((8, 4)))) is None
    assert not ft.Logistic(jnp.zeros(8)).grad_affine
    assert ft.LeastSquares(jnp.zeros(8)).grad_affine


def test_lowprec_op_does_not_fuse():
    """bf16-storage operators take the solver's two-call path."""
    op = ft.LowPrecDenseOp(jnp.zeros((64, 128), jnp.bfloat16))
    assert ft.LeastSquares(jnp.zeros(64)).fused_gradmap(op) is None


def test_pointwise_streaming_dispatch_gates():
    """Logistic/SquaredHinge fuse only on a row-sharded operator (one
    shard_map region); a single-device dense operator takes the
    two-call path."""
    b = jnp.zeros(64)
    assert ft.Logistic(b).fused_gradmap(
        ft.DenseOp(jnp.zeros((64, 128)))) is None
    assert ft.SquaredHinge(b).fused_gradmap(
        ft.DenseOp(jnp.zeros((64, 128)))) is None
