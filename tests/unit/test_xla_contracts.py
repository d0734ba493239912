"""Contracts of the XLA solver's entry points: the non-finite guard, the
per-iteration recorders against the float64 oracle, batched lanes
against single solves, and the warm-started path against cold solves —
in every solver mode."""

import jax.numpy as jnp
import numpy as np
import pytest

import fasta_tpu as ft
import problems
from reference_oracle.fasta_numpy import fasta as fasta_np

MODES = {
    "plain": dict(adaptive=False, accelerate=False),
    "adaptive": dict(adaptive=True, accelerate=False),
    "accelerated": dict(adaptive=False, accelerate=True),
}


# Per-mode tolerance at which each mode converges well inside its
# budget (plain FBS at a fixed stepsize is slowest).
TOL = {"plain": 1e-3, "adaptive": 1e-6, "accelerated": 1e-4}


def _lasso(dtype=jnp.float64, **kw):
    return problems.build("lasso", m=40, n=80, k=6, dtype=dtype, **kw)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("tau0", [float("nan"), float("inf")])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_guard_nonfinite_tau0(dtype, tau0, mode):
    """A NaN or infinite τ₀ makes the first iterate non-finite: the
    guarded loop halts on iteration 1 and flags it; unguarded, it runs
    its full budget and flags nothing."""
    prob = _lasso(dtype)
    kw = dict(tau0=tau0, tol=1e-6, max_iters=30, **MODES[mode])
    r = prob.solve(guard_nonfinite=True, **kw)
    assert r.iteration_count == 1
    assert r.nonfinite and not r.converged
    r_off = prob.solve(guard_nonfinite=False, **kw)
    assert r_off.iteration_count == 30
    assert not r_off.nonfinite and not r_off.converged


def _recorded_pair(mode):
    """Oracle and JAX runs with every recorder on; τ₀ = 5 is far above
    1/L, so the first iterations backtrack."""
    prob = _lasso()
    kw = dict(tau0=5.0, tol=1e-8, max_iters=60, record_objective=True,
              record_iterates=True, **MODES[mode])
    inst = prob.instance
    r_np = fasta_np(inst["op"], None, inst["f"], inst["gradf"], inst["g"],
                    inst["proxg"], inst["x0"], **kw)
    return r_np, prob.solve(**kw)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("recorder", ["fvals", "objectives", "iterates",
                                      "backtracks"])
def test_recorder_matches_oracle(recorder, mode):
    r_np, r_j = _recorded_pair(mode)
    assert r_j.iteration_count == r_np.iteration_count
    got, want = getattr(r_j, recorder), getattr(r_np, recorder)
    assert got is not None and len(got) == r_j.iteration_count
    if recorder == "backtracks":
        assert r_np.total_backtracks > 0
        np.testing.assert_array_equal(got, want)
        assert r_j.total_backtracks == r_np.total_backtracks
    else:
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("per_lane_tau0", [False, True])
def test_batch_lanes_match_single_solves(mode, per_lane_tau0):
    """``make_batch_solver`` over right-hand sides (and τ₀ per lane):
    every lane reproduces the single solve of its instance."""
    prob = _lasso()
    opts = ft.FastaOptions(tol=TOL[mode], max_iters=400, **MODES[mode])
    rng = np.random.default_rng(3)
    B = jnp.asarray(np.asarray(prob.fterm.b)[None, :]
                    + 0.1 * rng.standard_normal((3, 40)))
    taus = jnp.asarray([0.1, 0.2, 0.3]) if per_lane_tau0 else 0.2
    batch = ft.make_batch_solver(
        opts, in_axes=(None, ft.LeastSquares(0), None, None,
                       0 if per_lane_tau0 else None))
    out = batch(prob.op, ft.LeastSquares(B), prob.gterm,
                jnp.asarray(prob.x0), taus)
    for i in range(3):
        tau_i = float(taus[i]) if per_lane_tau0 else taus
        single = ft.solve(prob.op, ft.LeastSquares(B[i]), prob.gterm,
                          jnp.asarray(prob.x0), tau_i, opts)
        k = int(single.iteration_count)
        assert bool(single.converged)
        assert int(out.iteration_count[i]) == k
        # vmapped fusion reorders float64 sums, which BB feedback grows
        # over a long solve: the early stepsizes agree to ~1e-12
        np.testing.assert_allclose(out.taus[i][:10], single.taus[:10],
                                   rtol=1e-9)
        np.testing.assert_allclose(out.solution[i], single.solution,
                                   atol=1e-7)


@pytest.mark.parametrize("mode", list(MODES))
def test_path_first_point_is_the_cold_solve(mode):
    """The first point of a warm-started path has no predecessor: it is
    exactly the cold solve at that penalty."""
    prob = _lasso()
    opts = ft.FastaOptions(tol=1e-6, max_iters=400, stop_rule="residual",
                           **MODES[mode])
    mus = jnp.asarray([0.3, 0.1, 0.03])
    path = ft.solve_path(prob.op, prob.fterm, ft.L1Norm(mus),
                         jnp.asarray(prob.x0), 0.05, opts)
    cold = ft.solve(prob.op, prob.fterm, ft.L1Norm(mus[0]),
                    jnp.asarray(prob.x0), 0.05, opts)
    assert int(path.iteration_count[0]) == int(cold.iteration_count)
    np.testing.assert_array_equal(path.solution[0], cold.solution)
    np.testing.assert_array_equal(path.taus[0], cold.taus)


@pytest.mark.parametrize("mode", list(MODES))
def test_path_reaches_cold_objectives(mode):
    """Every warm-started path point converges to the objective of the
    cold solve at its penalty."""
    prob = _lasso()
    opts = ft.FastaOptions(tol=1e-7, max_iters=2000, stop_rule="residual",
                           **MODES[mode])
    mus = jnp.asarray([0.3, 0.1, 0.03])
    path = ft.solve_path(prob.op, prob.fterm, ft.L1Norm(mus),
                         jnp.asarray(prob.x0), 0.05, opts)
    assert bool(np.all(np.asarray(path.converged)))

    def objective(x, mu):
        x = jnp.asarray(x)
        return float(prob.fterm.value(prob.op(x)) + mu * jnp.sum(jnp.abs(x)))

    for i, mu in enumerate(np.asarray(mus)):
        cold = ft.solve(prob.op, prob.fterm, ft.L1Norm(mu),
                        jnp.asarray(prob.x0), 0.05, opts)
        fw, fc = objective(path.solution[i], mu), objective(cold.solution,
                                                            mu)
        assert abs(fw - fc) <= 1e-6 * (1.0 + abs(fc)), (i, fw, fc)
