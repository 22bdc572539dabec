"""Timing, peak rates and run-time set-up for measurement scripts.

Plays the role of the reference's measurement machinery: the CUDA-event
stopwatch (``internal_test.cu:31-66``) and the TF benchmark harness
(``tests/test_base.py:229-305``).

* ``median_time`` — warm up (which also compiles), then the median of
  host wall times around calls that end in ``block_until_ready``.
* ``Roofline`` / ``roofline_for`` — published peak rates keyed by the
  device kind JAX reports.  A device that is not in the table is an
  error, never a default.
* ``setup_compile_cache`` — JAX's persistent compile cache: where
  ``JAX_COMPILATION_CACHE_DIR`` is set JAX uses it as it is; otherwise a
  fixed ``.jax_cache/`` directory in the checkout.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import subprocess
import time

import jax

__all__ = ["median_time", "Roofline", "roofline_for", "PEAKS",
           "setup_compile_cache", "gpu_name_and_power"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def median_time(fn, *args, warmup: int = 2, iters: int = 10) -> float:
    """Median wall seconds of ``fn(*args)``, each call ended by
    ``block_until_ready`` so the device work is inside the interval."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Published dense peak rates of one device."""

    name: str
    bf16_flops: float   # FLOP/s, bf16 and fp16 tensor cores
    tf32_flops: float   # FLOP/s
    hbm_bytes: float    # bytes/s

    def bound(self, flops: float, bytes_moved: float, half: bool = True):
        """Least time for the work, and which of the two limits bounds it."""
        t_flop = flops / (self.bf16_flops if half else self.tf32_flops)
        t_mem = bytes_moved / self.hbm_bytes
        return (t_flop, "compute") if t_flop >= t_mem else (t_mem, "memory")


#: NVIDIA H100 SXM data sheet, dense rates without sparsity, at the
#: 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": Roofline(
        name="H100 SXM", bf16_flops=989e12, tf32_flops=495e12,
        hbm_bytes=3.35e12),
}


def roofline_for(device) -> Roofline:
    """Peak rates for ``device``; raises for a kind the table lacks."""
    kind = device.device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}")
    return PEAKS[kind]


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at one fixed directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is and nothing
    else is set.  Otherwise the cache lives in ``.jax_cache/`` at the root
    of the checkout (git-ignored), a path that never moves, so a second
    run finds what the first compiled.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(_REPO_ROOT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_name_and_power() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
