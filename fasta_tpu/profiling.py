"""Device, timing and tracing utilities (SURVEY.md §5).

The reference records wall-clock plus per-iteration arrays; the
equivalents here are:

  * ``trace(...)`` — context manager around ``jax.profiler`` writing an
    XProf/TensorBoard trace of the jitted solve;
  * ``time_blocking(...)`` — best wall time of a call, ended by
    ``jax.block_until_ready``;
  * ``roofline_report(...)`` — measured bandwidth of a call, and its
    share of the card's published HBM peak (``HBM_PEAK_BYTES_PER_S``);
  * ``require_gpu()`` / ``nvidia_smi()`` — the card a measurement ran on;
  * ``enable_compile_cache()`` — JAX's persistent compilation cache;
  * per-iteration diagnostics are already device-side arrays in the
    result pytree (capability C5), so no separate tracer is needed.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from pathlib import Path

import jax

__all__ = ["trace", "time_blocking", "roofline_report",
           "device_memory_stats", "HBM_PEAK_BYTES_PER_S",
           "hbm_peak_bytes_per_s", "require_gpu", "nvidia_smi",
           "compile_cache_dir", "enable_compile_cache"]

# Published HBM bandwidth of each card, keyed by the exact
# ``jax.Device.device_kind`` the CUDA driver reports (NVIDIA H100 data
# sheet: SXM5 80 GB HBM3 3.35 TB/s, PCIe 80 GB HBM2e 2.0 TB/s, NVL 94 GB
# HBM3 3.9 TB/s).  A kind not listed here has no peak: asking for one
# raises rather than guessing.
HBM_PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
}

_CHECKOUT = Path(__file__).resolve().parents[1]


def hbm_peak_bytes_per_s(device_kind: str) -> float:
    """Published HBM peak of ``device_kind``; ``ValueError`` if unknown."""
    try:
        return HBM_PEAK_BYTES_PER_S[device_kind]
    except KeyError:
        raise ValueError(
            f"no published HBM peak for device kind {device_kind!r}; "
            f"known: {sorted(HBM_PEAK_BYTES_PER_S)}") from None


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``
    (a fixed path: the directory is part of the cache key)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(_CHECKOUT / ".jax_cache"))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory.  When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already
    reads it, and no other directory is set here."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def require_gpu() -> list:
    """The devices a GPU measurement runs on.  Raises ``RuntimeError``
    when JAX's first device is not a GPU: a measurement never falls
    back to the CPU."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"JAX found no GPU (first device: platform "
            f"{devices[0].platform!r}, kind {devices[0].device_kind!r}); "
            f"this measurement runs only on the card")
    return devices


def nvidia_smi() -> str:
    """``name, power.limit`` of every card, as ``nvidia-smi`` reports
    them.  Raises ``RuntimeError`` when ``nvidia-smi`` fails."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"nvidia-smi failed: {e}") from e
    return out.stdout.strip()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block into an XProf/TensorBoard trace directory."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def time_blocking(fn, *args, repeats: int = 3, warmup: int = 1) -> float:
    """Best wall time of ``fn(*args)`` over ``repeats`` calls, each ended
    by ``jax.block_until_ready`` (a true completion barrier on a local
    device), after ``warmup`` untimed calls that absorb compilation."""
    for _ in range(max(warmup, 1)):
        jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def roofline_report(bytes_per_call: int, fn, *args, repeats: int = 5,
                    warmup: int = 1, device_kind: str | None = None) -> dict:
    """Time ``fn(*args)`` and report the bytes/s it moved.  Given a
    ``device_kind``, also the share of that card's published HBM peak
    (``ValueError`` for a kind with no published peak, e.g. the CPU).
    Without one there is no share: an operand that stays in L2 has no
    HBM roofline."""
    best = time_blocking(fn, *args, repeats=repeats, warmup=warmup)
    rate = bytes_per_call / best
    report = {"seconds": best, "achieved_GBps": rate / 1e9}
    if device_kind is not None:
        peak = hbm_peak_bytes_per_s(device_kind)
        report.update(peak_GBps=peak / 1e9, fraction_of_peak=rate / peak,
                      device_kind=device_kind)
    return report


def device_memory_stats() -> dict:
    """Per-device memory statistics where the backend exposes them."""
    return {str(d): d.memory_stats() for d in jax.devices()}
