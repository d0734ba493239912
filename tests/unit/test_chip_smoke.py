"""chip_smoke.py and bench.py off the card: both refuse the CPU, the
verdict line has its exact shape, the compile cache follows
JAX_COMPILATION_CACHE_DIR, the HBM peak table knows only the cards it
lists, and every phase runs end to end at a tiny size on the CPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import chip_smoke as cs
from fasta_tpu import profiling

REPO = Path(__file__).resolve().parents[2]


def _run(args, cwd, env_extra=None, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(env_extra or {})
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("args", [["chip_smoke.py"],
                                  ["chip_smoke.py", "--four-cards"],
                                  ["bench.py"], ["bench.py", "--quick"]])
def test_cpu_backend_is_refused(args):
    r = _run(args, REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert '"metric"' not in r.stdout
    assert "no GPU" in r.stderr


def test_script_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], tmp_path,
             env_extra={"PYTHONPATH": str(tmp_path)})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("count", [1, 4])
def test_last_line_shape(count):
    line = cs.last_line(jax.devices()[:count])
    assert "\n" not in line
    d = jax.devices()[0]
    assert json.loads(line) == {"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": count}}


@pytest.mark.parametrize("args", [[], ["--four-cards"]])
def test_main_exits_nonzero_without_verdict_on_cpu(args, capsys):
    assert cs.main(args) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_failed_phase_is_reported_and_later_phases_run(capsys):
    ran = []

    def bad():
        cs.check(False, "deliberately unmet")

    failed = cs.run_phases([("bad", bad), ("good", lambda: ran.append(1))])
    assert failed == ["bad"] and ran == [1]
    out = capsys.readouterr()
    assert "[phase] bad: FAILED" in out.out
    assert "deliberately unmet" in out.err


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert profiling.compile_cache_dir() == str(REPO / ".jax_cache")
    assert profiling.enable_compile_cache() == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")


def test_cache_dir_follows_env_var(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs land there
    and the helper sets no other directory."""
    cache = tmp_path / "cc"
    code = ("import jax, jax.numpy as jnp\n"
            "from fasta_tpu import profiling\n"
            "d = profiling.enable_compile_cache()\n"
            "jax.config.update("
            "'jax_persistent_cache_min_compile_time_secs', 0)\n"
            "jax.jit(lambda x: x * 2 + 1)(jnp.ones(3)).block_until_ready()\n"
            "print(d)\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    r = _run(["-c", code], REPO,
             env_extra={"JAX_COMPILATION_CACHE_DIR": str(cache)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [str(cache), str(cache)]
    assert any(cache.iterdir())


@pytest.mark.parametrize("kind,peak", [("NVIDIA H100 80GB HBM3", 3.35e12),
                                       ("NVIDIA H100 PCIe", 2.0e12),
                                       ("NVIDIA H100 NVL", 3.9e12)])
def test_hbm_peak_of_known_cards(kind, peak):
    assert profiling.hbm_peak_bytes_per_s(kind) == peak


def test_pcie_card_is_not_the_sxm_card():
    assert (profiling.hbm_peak_bytes_per_s("NVIDIA H100 PCIe")
            < profiling.hbm_peak_bytes_per_s("NVIDIA H100 80GB HBM3"))


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100",
                                  "NVIDIA A100-SXM4-80GB"])
def test_unknown_card_has_no_peak(kind):
    with pytest.raises(ValueError, match="no published HBM peak"):
        profiling.hbm_peak_bytes_per_s(kind)


def test_baseline_phase_tiny():
    configs = [("lasso", dict(m=60, n=120, k=6), 0.05, 1e-6),
               ("tv", dict(h=16, w=16), 2.0, 1e-5),
               ("phase_retrieval", dict(m=256, n=16), 1.0, 1e-5),
               ("phase_retrieval", dict(m=256, n=16, planar=True), 1.0,
                1e-5)]
    out = cs.baseline_phase(configs, fixed_iters=20,
                            lasso_kwargs=dict(m=60, n=120, k=6))
    assert len(out) == len(configs) + 1
    assert all(v["gap"] <= cs.GAP_TOL for k, v in out.items()
               if isinstance(v, dict))
    assert out["lasso_us_per_iter"] > 0


def test_registry_phase_tiny():
    sizes = {"mmv": dict(m=40, n=80, l=3, k=5),
             "sparse_lasso": dict(m=100, n=200, density=0.05, k=8),
             "matrix_completion": dict(d1=20, d2=20, rank=2)}
    configs = {k: cs.REGISTRY_REST[k] for k in sizes}
    out = cs.registry_phase(configs, sizes)
    assert set(out) == set(sizes) | {"svd"}
    assert out["svd"]["svt"] <= cs.SVD["rtol"]


def test_svd_check_cpu():
    """The algorithms the CPU lowers are reported; JACOBI and POLAR are
    GPU-only and are skipped, not failed."""
    out = cs.svd_check(n=48)
    assert set(out) == {"default", "QR", "svt"}
    assert max(out.values()) <= cs.SVD["rtol"]


def test_svd_check_enforces_its_bar():
    with pytest.raises(cs.CheckFailed, match="float64 SVT"):
        cs.svd_check(n=16, rtol=-1.0)


def test_solve_against_oracle_enforces_its_gap():
    import problems
    prob = problems.build("lasso", m=60, n=120, k=6)
    with pytest.raises(cs.CheckFailed, match="objective gap"):
        cs.solve_against_oracle(prob, 0.05, 1e-6, -1.0, "test")


def test_streaming_phase_tiny():
    out = cs.streaming_phase(m=128, n=256, k=10, iters=40, f_check=10)
    assert out["ips"] > 0 and out["gradmap_GBps"] > 0
    assert "solve_share" not in out        # no peak for the CPU


def test_sharded_phase_tiny():
    out = cs.sharded_lasso_phase(4, m=256, n=512, k=12)
    assert out["iters"] > 0 and out["tau_diff"] <= cs.FOUR["tau_rtol"]


def test_four_card_dryrun_on_cpu_devices():
    """The --four-cards f64 paths, on four of the suite's CPU devices."""
    import __graft_entry__
    __graft_entry__.dryrun_multichip(4)


def test_planar_2d_divergence_starts_at_rounding():
    """At m=32 the 2-D mesh run stops at another iteration than the
    single-device one, but only after BB has grown a rounding-level
    difference: the first 30 iterations agree to far below float32
    rounding, which a wrong shard or a missing psum would not."""
    import __graft_entry__
    out = __graft_entry__.planar_2d_divergence(4, 32)
    assert abs(out["iters"][0] - out["iters"][1]) <= 10
    assert out["taus"][:30].max() <= 1e-9
    assert out["objectives"][:30].max() <= 1e-12
