"""Tests for the device, timing and tracing utilities (SURVEY.md §5) —
CPU-backend coverage of the API surface; rates themselves are measured
on the card (chip_smoke.py)."""

import jax
import jax.numpy as jnp
import pytest

from fasta_tpu import profiling


def test_time_blocking_positive_and_barrier_subtracted():
    """Timing ends each call at ``block_until_ready``: the measured wall
    covers the work, so a call that does more work is not faster."""
    fn = jax.jit(lambda x: x @ x)
    x = jnp.ones((64, 64))
    t = profiling.time_blocking(fn, x, repeats=2)
    assert t > 0
    big = jnp.ones((512, 512))
    t_big = profiling.time_blocking(fn, big, repeats=2)
    assert t_big > t


def test_roofline_report_fields():
    """The CPU has no published HBM peak: the report refuses to guess;
    without a device kind it gives the rate and no share."""
    fn = jax.jit(lambda x: x @ x)
    x = jnp.ones((64, 64))
    with pytest.raises(ValueError, match="no published HBM peak"):
        profiling.roofline_report(64 * 64 * 8 * 2, fn, x, repeats=2,
                                  device_kind=jax.devices()[0].device_kind)
    rep = profiling.roofline_report(64 * 64 * 8 * 2, fn, x, repeats=2)
    assert set(rep) == {"seconds", "achieved_GBps"}
    assert rep["achieved_GBps"] == pytest.approx(
        64 * 64 * 8 * 2 / rep["seconds"] / 1e9)


def test_roofline_report_share_of_known_card():
    fn = jax.jit(lambda x: x + 1)
    x = jnp.ones(1024)
    rep = profiling.roofline_report(4096, fn, x, repeats=2,
                                    device_kind="NVIDIA H100 80GB HBM3")
    assert rep["peak_GBps"] == 3350.0
    assert rep["fraction_of_peak"] == pytest.approx(
        rep["achieved_GBps"] / 3350.0)


def test_trace_context_manager(tmp_path):
    logdir = str(tmp_path / "trace")
    fn = jax.jit(lambda x: jnp.sum(x * x))
    with profiling.trace(logdir) as d:
        float(fn(jnp.ones(128)))
    assert d == logdir


def test_device_memory_stats_shape():
    stats = profiling.device_memory_stats()
    assert len(stats) == len(jax.devices())
