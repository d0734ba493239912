"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline: solver iterations/second on the BASELINE LASSO config (dense
Gaussian A 1000×2000, adaptive BB mode, float32, fixed iteration count
so every run does identical work), timed on the GPU with
``jax.block_until_ready``.  ``vs_baseline`` is the speedup over the
float64 NumPy oracle running the same instance on this host's CPU — the
reference implementation's measured rate (BASELINE.md: the oracle run
*is* the baseline; the upstream publishes no numbers).

Above the JSON line it prints the device as JAX reports it and the
card's ``nvidia-smi`` name and power limit.  Without a GPU it exits
non-zero and prints no metric.

Usage:  python bench.py            # full benchmark
        python bench.py --quick    # reduced iteration counts (smoke)
        python bench.py --large    # LASSO 8192×16384 (512 MB operand):
                                   # HBM streaming instead of L2-resident
"""

from __future__ import annotations

import json
import sys
import time

METRIC = "lasso_1000x2000_adaptive_iters_per_sec"


def fixed_iteration_solve(prob, iters: int, tau0: float = 0.05):
    """``(solve, args)``: the jitted solver for ``iters`` fixed adaptive
    iterations (with backtracking) of a dense problem, and its
    arguments."""
    import jax.numpy as jnp

    from fasta_tpu import FastaOptions, make_solver

    opts = FastaOptions(max_iters=iters, stop_rule="iterations",
                        adaptive=True, backtrack=True)
    args = (prob.op, prob.fterm, prob.gterm, jnp.asarray(prob.x0),
            jnp.asarray(tau0, prob.op.A.dtype))
    return make_solver(opts), args


def bench_solver(prob, iters: int, tau0: float = 0.05,
                 device_kind: str | None = None, repeats: int = 3) -> dict:
    """``profiling.roofline_report`` of ``iters`` fixed iterations, best
    of ``repeats`` warm runs, with ``ips`` (iterations/s) added.  An
    adaptive iteration counts as two passes over A (forward and
    adjoint); backtracking trials are not counted."""
    from fasta_tpu import profiling

    solve, args = fixed_iteration_solve(prob, iters, tau0)
    m, n = prob.op.A.shape
    rep = profiling.roofline_report(
        iters * 2 * m * n * prob.op.A.dtype.itemsize, solve, *args,
        repeats=repeats, device_kind=device_kind)
    rep["ips"] = iters / rep["seconds"]
    return rep


def bench_oracle(inst, tau0: float, iters: int) -> float:
    from reference_oracle.fasta_numpy import fasta as fasta_np

    t0 = time.perf_counter()
    r = fasta_np(inst["op"], None, inst["f"], inst["gradf"], inst["g"],
                 inst["proxg"], inst["x0"], tau0=tau0, max_iters=iters,
                 stop_rule="iterations", tol=0.0)
    return r.iteration_count / (time.perf_counter() - t0)


def main() -> int:
    quick = "--quick" in sys.argv
    large = "--large" in sys.argv

    from fasta_tpu import profiling
    profiling.enable_compile_cache()
    try:
        devices = profiling.require_gpu()
        smi = profiling.nvidia_smi()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    kind = devices[0].device_kind
    print(f"# device: platform={devices[0].platform} kind={kind} "
          f"count={len(devices)}")
    print("# nvidia-smi --query-gpu=name,power.limit:")
    print(smi)

    import problems

    if large:
        iters, oracle_iters = 2000, 5
        prob = problems.build("lasso", m=8192, n=16384, k=400)
        metric = "lasso_8192x16384_adaptive_iters_per_sec"
    else:
        iters = 100 if quick else 20000
        oracle_iters = 50 if quick else 300
        prob = problems.build("lasso")        # BASELINE: 1000x2000
        metric = METRIC
    tau0 = 0.05

    # the 8 MB operand of the default size stays in the 50 MB L2, so
    # only the streaming size has an HBM share
    rep = bench_solver(prob, iters, tau0,
                       device_kind=kind if large else None)
    ips = rep["ips"]
    oracle_ips = bench_oracle(prob.instance, tau0, oracle_iters)

    print(json.dumps({
        "metric": metric,
        "value": round(ips, 1),
        "unit": "iterations/s",
        "vs_baseline": round(ips / oracle_ips, 2),
    }))
    share = (f" = {rep['fraction_of_peak']:.3f} of the "
             f"{rep['peak_GBps'] / 1e3:.2f} TB/s HBM peak of {kind}"
             if large else " (nominal: A stays in L2)")
    print(f"# detail: XLA loop {ips:.1f} it/s ({iters} iters); matvec "
          f"traffic {rep['achieved_GBps']:.1f} GB/s{share}; oracle "
          f"{oracle_ips:.1f} it/s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
