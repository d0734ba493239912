"""Test configuration: CPU backend with 8 virtual devices + float64.

Set BEFORE jax import (SURVEY.md §4): sharding correctness is validated on
8 virtual CPU devices, and float64 enables exact-trajectory parity against
the NumPy oracle.  The suite always runs on the CPU, even on a machine
with a GPU; measurements on the card are ``chip_smoke.py``'s job.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from fasta_tpu import profiling  # noqa: E402

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the suite compiles dozens of solver
# variants, so reruns hit the cache.
profiling.enable_compile_cache()
