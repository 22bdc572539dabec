"""The one place that decides how the Pallas kernels run.

Every kernel in this package is written for Pallas on its Triton route
(``backend="triton"``).  On the GPU it compiles for the card; on the CPU,
where the test suite runs, the same kernel body runs in the Pallas
interpreter.  Any other backend is refused, so a public path can never
fall back to the interpreter on an accelerator by accident.
"""

from __future__ import annotations

import jax
from jax.experimental.pallas import triton as plt

__all__ = ["ROUTE", "default_interpret", "compiler_params"]

#: The Pallas lowering every kernel names.  Named explicitly because an
#: unnamed ``pallas_call`` on the GPU goes to Mosaic GPU in this JAX.
ROUTE = "triton"


def default_interpret() -> bool:
    """``False`` on the GPU (compiled Triton), ``True`` on the CPU.

    Raises on any other backend: the kernels have no other lowering.
    """
    backend = jax.default_backend()
    if backend == "gpu":
        return False
    if backend == "cpu":
        return True
    raise RuntimeError(
        f"no kernel route for JAX backend {backend!r}: the Pallas kernels "
        "compile for the GPU (Triton) and run interpreted on the CPU")


def compiler_params(num_warps: int = 4, num_stages: int = 2):
    """Triton launch parameters for one ``pallas_call``."""
    return plt.CompilerParams(num_warps=num_warps, num_stages=num_stages)
