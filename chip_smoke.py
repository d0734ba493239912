"""Run the solver's main path on an NVIDIA GPU at real sizes and check it.

    python chip_smoke.py               # one card: phases 1-6 below
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

One process drives the card from start to end; the float64 NumPy oracle
(``reference_oracle.fasta_numpy``) runs in the same process on the host.

  1. Device: platform, kind and count as JAX reports them, and the
     ``nvidia-smi`` name and power limit.  No GPU is an error.
  2. The five BASELINE.json configs at their published sizes through
     ``Problem.solve``: converged float32 solve vs the oracle's objective,
     and the warm wall time to tolerance.
  3. Every other problem of the registry at its default size, likewise.
  4. Float32 with double-word decision scalars (``precision="auto"``):
     the oracle's iteration counts (tests/parity/test_f32_hp.py's bar).
  5. Streaming size: LASSO 8192×16384 float32 (512 MB) for a fixed 200
     iterations through ``make_solver``: f-values vs the oracle,
     iterations/s and the share of the card's HBM peak.
  6. The last line of standard output:
     ``{"ok": true, "device": {"platform", "kind", "count"}}`` — printed
     only when every phase passed.

``--four-cards`` runs the paths of ``__graft_entry__.dryrun_multichip(4)``
(float64, each against the single-device solve) and row-sharded LASSO
8192×16384 float32 on four cards against one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import numpy as np

# Objective gap |f_f32 − f_oracle| / |f_oracle| allowed after a converged
# solve.  float32 iterate storage rounds each iterate at ~6e-8 relative,
# and the converged objectives of these convex problems sit within ~1e-6
# of the float64 optimum (the gaps measured on earlier hardware were
# 1e-9 to 1.3e-6); 1e-5 leaves room for another reduction order.
GAP_TOL = 1e-5

# name, build kwargs, tau0, stopping tol — the BASELINE.json configs at
# their published sizes.  Phase retrieval stops at 1e-5 (its runner:
# 1e-6): the normalized
# residual's floor under float32 iterate storage is ~5e-6 for this
# instance (Δx is quantized at eps32·‖x‖), so 1e-6 is out of reach.
BASELINE = [
    ("lasso", {}, 0.05, 1e-6),
    ("nnls", {}, 0.08, 1e-6),
    ("logistic", {}, 1.0, 1e-6),
    ("tv", {}, 2.0, 1e-5),
    ("phase_retrieval", {}, 1.0, 1e-5),
    ("phase_retrieval", {"planar": True}, 1.0, 1e-5),
]

# name -> (tau0, stopping tol, objective gap tol) for the rest of the
# registry at default sizes.  Each stops at the tol of its own runner
# (``python -m problems.<name>``) except, with reasons:
#   democratic stops at 1e-5, not 1e-6: float32 does not meet 1e-6
#     within 5000 iterations (the oracle needs 3876 in float64).  Its gap
#     limit is 1e-4: the L∞ penalty has near-degenerate optimal
#     vertices, and rounding-level flips in its sort-based prox move the
#     objective by up to ~1e-5 (tests/parity/test_parity.py allows 1e-3
#     even in float64);
#   phase_retrieval_cdp stops at 1e-4, not 1e-6: float32 iterate
#     storage floors its normalized residual near 1e-4.
REGISTRY_REST = {
    "democratic": (0.05, 1e-5, 1e-4),
    "mmv": (0.08, 1e-6, GAP_TOL),
    "matrix_completion": (1.0, 1e-5, GAP_TOL),
    "max_norm": (0.5, 1e-6, GAP_TOL),
    "svm": (0.3, 1e-6, GAP_TOL),
    "sparse_lasso": (0.05, 1e-6, GAP_TOL),
    "nmf": (0.05, 1e-7, GAP_TOL),
    "phase_retrieval_cdp": (1.0, 1e-4, GAP_TOL),
}

# The instances of tests/parity/test_f32_hp.py: name -> (build kwargs,
# tau0, solve kwargs, allowed factor on the oracle's iteration count).
F32_HP = {
    "tv": (dict(h=48, w=48), 0.25, dict(tol=1e-5, max_iters=8000), 1.25),
    "lasso": (dict(m=150, n=300, k=15, mu=0.05), 0.05,
              dict(tol=1e-7, max_iters=4000), 1.25),
    "logistic": (dict(m=150, n=80), 1.0, dict(tol=1e-6, max_iters=4000),
                 1.5),
}

# Phase 3's SVD check: the SVT prox (prox.svt, float32 on the device)
# against the float64 NumPy SVT on an N×N Gaussian matrix, thresholded at
# its median singular value.  Matrix completion stops at a normalized
# residual of 1e-5, so an SVT less accurate than that stalls its solve.
SVD = dict(n=200, rtol=1e-5)

# Phase 5: LASSO at the streaming size (A is 512 MB in float32, ten times
# the 50 MB L2).  The first F_CHECK f-values must match the oracle to
# F_RTOL: float32 matvecs over 16384 columns round at ~1e-7 relative and
# the BB stepsize feeds that back, so by iteration 20 the f-values part
# by up to ~1e-5; 1e-4 keeps a margin.
STREAM = dict(m=8192, n=16384, k=400, iters=200, f_check=20, f_rtol=1e-4)

# µs/iteration of the XLA loop at a fixed iteration count (LASSO
# 1000×2000, adaptive, the bench.py setting).
FIXED_ITERS = 5000

# --four-cards: row-sharded LASSO against the single-card solve.  The
# psum adds the four row blocks' partial adjoints in another order than
# one device does, so stepsizes part at float32 rounding and BB feedback
# grows that over the solve; 1e-3 on τ and 1e-5 on the objective.
FOUR = dict(m=8192, n=16384, k=400, tol=1e-4, max_iters=2000,
            tau_rtol=1e-3, obj_rtol=1e-5)


class CheckFailed(AssertionError):
    """A phase's result does not meet its stated bar."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def _oracle(prob, tau0, **kw):
    from reference_oracle.fasta_numpy import fasta as fasta_np
    inst = prob.instance
    return fasta_np(inst["op"], inst.get("op_t"), inst["f"], inst["gradf"],
                    inst["g"], inst["proxg"], inst["x0"], tau0=tau0, **kw)


def rel_gap(a: float, ref: float) -> float:
    return abs(a - ref) / max(abs(ref), 1e-12)


def device_phase(min_count: int = 1):
    """Phase 1: the devices JAX reports, and the card's name and limit."""
    from fasta_tpu import profiling
    devices = profiling.require_gpu()
    d = devices[0]
    print(f"[device] platform={d.platform} kind={d.device_kind} "
          f"count={len(devices)}")
    print("[device] nvidia-smi --query-gpu=name,power.limit:")
    print(profiling.nvidia_smi())
    check(len(devices) >= min_count,
          f"need {min_count} GPUs, JAX found {len(devices)}")
    return devices


def solve_against_oracle(prob, tau0: float, tol: float, gap_tol: float,
                         label: str, max_iters: int = 5000) -> dict:
    """Converged solve through ``Problem.solve`` vs the float64 oracle at
    the same tolerance; then, if both converged, the warm wall time to
    tolerance."""
    import jax.numpy as jnp

    from fasta_tpu import FastaOptions, make_solver, profiling

    opts = FastaOptions(tol=tol, max_iters=max_iters, record_objective=True)
    r = prob.solve(options=opts, tau0=tau0)
    t0 = time.perf_counter()
    r_np = _oracle(prob, tau0, tol=tol, max_iters=max_iters,
                   record_objective=True)
    oracle_s = time.perf_counter() - t0
    gap = rel_gap(float(r.objectives[-1]), float(r_np.objectives[-1]))
    print(f"[{label}] {prob.name}: f32 {r.iteration_count} iters "
          f"(converged={r.converged}, last normalized residual "
          f"{float(r.norm_residuals[-1]):.3e}), oracle "
          f"{r_np.iteration_count} iters (converged={r_np.converged}, "
          f"{oracle_s:.3f} s on the host); objective "
          f"{float(r.objectives[-1]):.9e} vs "
          f"{float(r_np.objectives[-1]):.9e}, rel gap {gap:.3e} "
          f"(limit {gap_tol:g})")
    check(bool(r_np.converged), f"{prob.name}: oracle did not converge")
    check(bool(r.converged), f"{prob.name}: f32 solve did not converge")
    check(gap <= gap_tol,
          f"{prob.name}: objective gap {gap:.3e} > {gap_tol:g}")
    args = (prob.op, prob.fterm, prob.gterm, jnp.asarray(prob.x0), tau0)
    wall = profiling.time_blocking(make_solver(opts), *args, repeats=3)
    print(f"[{label}] {prob.name}: wall to tol {wall * 1e3:.3f} ms "
          f"({wall / r.iteration_count * 1e6:.1f} us/iteration)")
    return dict(iters=r.iteration_count, oracle_iters=r_np.iteration_count,
                gap=gap, wall_s=wall)


def baseline_phase(configs=BASELINE, fixed_iters: int = FIXED_ITERS,
                   lasso_kwargs=None) -> dict:
    """Phase 2: the five BASELINE.json configs (phase retrieval twice:
    native complex64 and planar)."""
    import problems
    from bench import bench_solver

    out = {}
    for name, kwargs, tau0, tol in configs:
        prob = problems.build(name, **kwargs)
        out[prob.name] = solve_against_oracle(prob, tau0, tol, GAP_TOL,
                                              "baseline")
    lasso = problems.build("lasso", **(lasso_kwargs or {}))
    s = bench_solver(lasso, fixed_iters)["seconds"] / fixed_iters
    print(f"[baseline] {lasso.name} XLA loop, {fixed_iters} fixed "
          f"adaptive iterations: {s * 1e6:.3f} us/iteration "
          f"({1.0 / s:.1f} it/s)")
    out["lasso_us_per_iter"] = s * 1e6
    return out


def svd_check(n: int = SVD["n"], rtol: float = SVD["rtol"],
              seed: int = 0) -> dict:
    """The SVD behind the SVT prox, float32 on the device, against
    float64 on the host.  Prints the time and reconstruction error of one
    thin SVD for every algorithm the backend lowers; checks ``prox.svt``
    against the float64 NumPy SVT to ``rtol``."""
    import jax
    import jax.numpy as jnp

    from fasta_tpu import profiling, prox
    from reference_oracle.generators import svt as svt_np

    Zd = jnp.asarray(np.random.default_rng(seed).standard_normal((n, n)),
                     jnp.float32)
    Z = np.asarray(Zd, np.float64)          # the input both sides see
    out = {}
    algs = jax.lax.linalg.SvdAlgorithm
    for alg in (None, algs.QR, algs.JACOBI, algs.POLAR):
        name = "default" if alg is None else alg.name
        fn = jax.jit(lambda z, a=alg: jax.lax.linalg.svd(
            z, full_matrices=False, algorithm=a))
        try:
            secs = profiling.time_blocking(fn, Zd, repeats=3)
        except NotImplementedError:
            print(f"[svd] {name}: not lowered on this backend")
            continue
        U, s, Vh = (np.asarray(a, np.float64) for a in fn(Zd))
        out[name] = np.linalg.norm((U * s) @ Vh - Z) / np.linalg.norm(Z)
        print(f"[svd] {name} {n}x{n} float32: {secs * 1e3:.3f} ms, "
              f"reconstruction rel error {out[name]:.3e}")
    t = float(np.median(np.linalg.svd(Z, compute_uv=False)))
    want = svt_np(Z, t)
    got = np.asarray(jax.jit(prox.svt)(Zd, t), np.float64)
    out["svt"] = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"[svd] prox.svt vs float64 SVT at the median singular value: "
          f"rel error {out['svt']:.3e} (limit {rtol:g})")
    check(out["svt"] <= rtol,
          f"prox.svt parts from the float64 SVT by {out['svt']:.3e}")
    return out


def registry_phase(configs=None, sizes=None) -> dict:
    """Phase 3: every other problem of the registry at its default size
    (``sizes`` overrides the build kwargs, for rehearsals), after the SVD
    check of the SVT prox."""
    import problems

    configs = REGISTRY_REST if configs is None else configs
    out = {"svd": svd_check()}
    for name, (tau0, tol, gap_tol) in configs.items():
        prob = problems.build(name, **((sizes or {}).get(name, {})))
        out[name] = solve_against_oracle(prob, tau0, tol, gap_tol,
                                         "registry")
    return out


def f32_hp_phase(cases=F32_HP) -> dict:
    """Phase 4: double-word decision scalars keep float32 on the
    oracle's iteration count (``precision="auto"``)."""
    import jax.numpy as jnp

    import problems

    out = {}
    for name, (kwargs, tau0, skw, factor) in cases.items():
        prob = problems.build(name, dtype=jnp.float32, **kwargs)
        r_np = _oracle(prob, tau0, **skw)       # the float64 instance
        r = prob.solve(tau0=tau0, precision="auto", **skw)
        lo = r_np.iteration_count / factor
        hi = factor * r_np.iteration_count + 10
        print(f"[f32-dd] {prob.name}: f32 {r.iteration_count} iters "
              f"(converged={r.converged}), oracle {r_np.iteration_count}; "
              f"allowed [{lo:.1f}, {hi:.1f}]")
        check(bool(r_np.converged), f"{name}: oracle did not converge")
        check(bool(r.converged), f"{name}: f32 dd solve did not converge")
        check(lo <= r.iteration_count <= hi,
              f"{name}: f32 dd {r.iteration_count} iters outside "
              f"[{lo:.1f}, {hi:.1f}] of the oracle's "
              f"{r_np.iteration_count}")
        out[name] = (r.iteration_count, r_np.iteration_count)
    return out


def gradmap_chain(A, b, x, evals: int):
    """``evals`` dependent least-squares gradient evaluations in one jit
    (two passes over A each)."""
    import jax

    from fasta_tpu.terms import lstsq_gradmap_reference

    def body(_, v):
        return v - 1e-9 * lstsq_gradmap_reference(A, v, b)[2]

    return jax.lax.fori_loop(0, evals, body, x)


def streaming_phase(m: int = STREAM["m"], n: int = STREAM["n"],
                    k: int = STREAM["k"], iters: int = STREAM["iters"],
                    f_check: int = STREAM["f_check"],
                    f_rtol: float = STREAM["f_rtol"],
                    device_kind=None) -> dict:
    """Phase 5: LASSO at the streaming size for a fixed iteration count.
    ``device_kind=None`` skips the HBM share (CPU rehearsals)."""
    import jax
    import jax.numpy as jnp

    import problems
    from bench import bench_solver, fixed_iteration_solve
    from fasta_tpu import profiling

    t0 = time.perf_counter()
    prob = problems.build("lasso", m=m, n=n, k=k)
    print(f"[stream] built {prob.name} in {time.perf_counter() - t0:.1f} s "
          f"(A: {m * n * 4 / 2**20:.0f} MiB float32 on the device)")
    solve, args = fixed_iteration_solve(prob, iters, 0.05)
    compiled = solve.lower(*args).compile()
    print(f"[stream] memory_analysis: {compiled.memory_analysis()}")
    out = jax.block_until_ready(solve(*args))
    r_np = _oracle(prob, 0.05, max_iters=f_check, stop_rule="iterations",
                   tol=0.0)
    fv = np.asarray(out.fvals)[:f_check]
    worst = float(np.max(np.abs(fv - r_np.fvals) / np.abs(r_np.fvals)))
    print(f"[stream] first {f_check} f-values vs oracle: max rel diff "
          f"{worst:.3e} (limit {f_rtol:g})")
    check(worst <= f_rtol,
          f"streaming f-values part from the oracle by {worst:.3e}")
    check(bool(np.isfinite(np.asarray(out.solution)).all()),
          "streaming solution is not finite")

    rep = bench_solver(prob, iters, 0.05, device_kind=device_kind)
    bt = int(out.total_backtracks)
    evals = 50
    g_rep = profiling.roofline_report(
        evals * 2 * m * n * 4, jax.jit(gradmap_chain, static_argnums=3),
        prob.op.A, prob.fterm.b, jnp.asarray(prob.x0), evals, repeats=3,
        device_kind=device_kind)
    res = dict(ips=rep["ips"], solve_GBps=rep["achieved_GBps"],
               gradmap_GBps=g_rep["achieved_GBps"], backtracks=bt)

    def share(r):
        if device_kind is None:
            return ""
        return (f"; {r['fraction_of_peak']:.3f} of the "
                f"{r['peak_GBps'] / 1e3:.2f} TB/s HBM peak of {device_kind}")

    if device_kind is not None:
        res.update(solve_share=rep["fraction_of_peak"],
                   gradmap_share=g_rep["fraction_of_peak"])
    print(f"[stream] {iters} fixed iterations in "
          f"{rep['seconds'] * 1e3:.3f} ms: {rep['ips']:.1f} it/s; 2 passes "
          f"x {m * n * 4 / 1e6:.0f} MB per iteration = "
          f"{rep['achieved_GBps']:.1f} GB/s{share(rep)} ({bt} backtracking "
          f"trials in {iters} iterations, one more forward pass each)")
    print(f"[stream] gradient evaluation (two passes over A): "
          f"{g_rep['seconds'] / evals * 1e3:.4f} ms each, "
          f"{g_rep['achieved_GBps']:.1f} GB/s{share(g_rep)}")
    return res


def sharded_lasso_phase(mesh_devices: int, m: int = FOUR["m"],
                        n: int = FOUR["n"], k: int = FOUR["k"],
                        tol: float = FOUR["tol"],
                        max_iters: int = FOUR["max_iters"],
                        tau_rtol: float = FOUR["tau_rtol"],
                        obj_rtol: float = FOUR["obj_rtol"]) -> dict:
    """Row-sharded LASSO float32 on ``mesh_devices`` devices against the
    same solve on one device."""
    import jax
    import jax.numpy as jnp

    import problems
    from fasta_tpu import FastaOptions, make_solver, profiling
    from fasta_tpu import sharding as sh

    prob = problems.build("lasso", m=m, n=n, k=k)
    opts = FastaOptions(tol=tol, max_iters=max_iters,
                        record_objective=True)
    solve = make_solver(opts)
    tau0 = jnp.asarray(0.05, jnp.float32)

    def args(p):
        return (p.op, p.fterm, p.gterm, jnp.asarray(p.x0), tau0)

    ref = jax.block_until_ready(solve(*args(prob)))
    t1 = profiling.time_blocking(solve, *args(prob), repeats=3)
    mesh = sh.make_mesh(n_devices=mesh_devices)
    sprob = sh.shard_problem(prob, mesh)
    shards = sprob.op.A.addressable_shards
    placed = sorted(str(s.device) for s in shards)
    print(f"[sharded] A row blocks: "
          f"{[tuple(s.data.shape) for s in shards]} on {placed}")
    check(len({s.device for s in shards}) == mesh_devices,
          f"row blocks sit on {placed}, not on {mesh_devices} devices")
    check(all(s.data.shape == (m // mesh_devices, n) for s in shards),
          "row blocks are not m/D rows each")
    out = jax.block_until_ready(solve(*args(sprob)))
    tD = profiling.time_blocking(solve, *args(sprob), repeats=3)
    k1, kD = int(ref.iteration_count), int(out.iteration_count)
    taus1, tausD = np.asarray(ref.taus)[:k1], np.asarray(out.taus)[:kD]
    n_cmp = min(k1, kD)
    tau_diff = float(np.max(np.abs(tausD[:n_cmp] - taus1[:n_cmp])
                            / np.abs(taus1[:n_cmp])))
    obj1 = float(np.asarray(ref.objectives)[k1 - 1])
    objD = float(np.asarray(out.objectives)[kD - 1])
    print(f"[sharded] {prob.name} on 1 device: {k1} iters "
          f"(converged={bool(ref.converged)}) in {t1 * 1e3:.3f} ms; on "
          f"{mesh_devices}: {kD} iters (converged={bool(out.converged)}) "
          f"in {tD * 1e3:.3f} ms; max tau rel diff {tau_diff:.3e} "
          f"(limit {tau_rtol:g}); objective rel gap "
          f"{rel_gap(objD, obj1):.3e} (limit {obj_rtol:g})")
    check(bool(ref.converged) and bool(out.converged),
          "sharded LASSO: a solve did not converge")
    check(k1 == kD, f"sharded LASSO: {kD} iters vs single-device {k1}")
    check(tau_diff <= tau_rtol, f"sharded LASSO: tau differs {tau_diff:.3e}")
    check(rel_gap(objD, obj1) <= obj_rtol,
          "sharded LASSO: objective differs from single-device")
    return dict(iters=k1, single_s=t1, sharded_s=tD, tau_diff=tau_diff)


def last_line(devices) -> str:
    """The one-line JSON verdict: the device as JAX reports it."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def run_phases(phases) -> list:
    """Run every ``(name, fn)``; return the names of those that failed
    (each failure's traceback goes to stderr)."""
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:                 # report it, run the next phase
            traceback.print_exc()
            failed.append(name)
        print(f"[phase] {name}: {'FAILED' if name in failed else 'ok'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the sharded paths on four cards, and "
                         "nothing else")
    args = ap.parse_args(argv)

    from fasta_tpu import profiling
    profiling.enable_compile_cache()
    try:
        devices = device_phase(4 if args.four_cards else 1)
    except (RuntimeError, CheckFailed) as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2

    if args.four_cards:
        import __graft_entry__
        phases = [
            ("sharded LASSO 8192x16384 f32, 4 cards vs 1",
             lambda: sharded_lasso_phase(4)),
            ("dryrun_multichip(4), f64", lambda: __graft_entry__
             .dryrun_multichip(4)),
        ]
        devices = devices[:4]
    else:
        kind = devices[0].device_kind
        phases = [
            ("baseline configs", baseline_phase),
            ("rest of the registry", registry_phase),
            ("f32 double-word decision scalars", f32_hp_phase),
            ("streaming LASSO 8192x16384",
             lambda: streaming_phase(device_kind=kind)),
        ]
    failed = run_phases(phases)
    if failed:
        print(f"chip_smoke: FAILED phases: {failed}", file=sys.stderr)
        return 1
    print(last_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
