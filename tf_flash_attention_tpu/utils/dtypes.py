"""Dtype policy for the TPU-native flash-attention framework.

Replaces the reference's type utilities (``kernel/type_util.h``,
``kernel/type_mapping.h``, ``cuda_launch::L_TypeMapping`` in
``kernel/flash_attention.h:181-185``) with a single table-driven module:

* ``neg_inf_approx(dtype)`` — the finite "negative infinity" masking value.
  The reference fills masked logits (and the initial ``m`` buffer) with the
  byte pattern ``0xFA`` repeated (``type_util.h:11-45``); semantics are
  "any logit ``<= masking_value`` contributes a zero numerator"
  (``flash_attention.cu:740-745``).  We reproduce the exact bit-pattern
  values per dtype so the public ``m`` output matches the reference.
* ``l_dtype(dtype)`` — the dtype of the softmax normaliser ``l``: float32
  for half-precision inputs, else the input dtype
  (``flash_attention.h:181-185``).
* ``supported``/validation helpers.  float64 exists on TPU only via software
  emulation; it is accepted (runs through the XLA path) but documented as a
  deviation from the CUDA reference, which compiles real fp64 kernels.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = [
    "neg_inf_approx",
    "l_dtype",
    "canonical_dtype",
    "MASK_VALUE_F32",
]


def _pattern_value(dtype) -> float:
    """Value of the 0xFA-repeated byte pattern interpreted as ``dtype``.

    Mirrors ``TypeUtil<T>::GetNegInfApprox`` (``type_util.h:11-45``): the
    reference memsets the ``m`` output with byte 0xFA and treats the
    resulting value as its finite -inf approximation.
    """
    dtype = np.dtype(dtype)
    if dtype == np.dtype("bfloat16") if hasattr(np, "bfloat16") else False:  # pragma: no cover
        raise AssertionError
    nbytes = dtype.itemsize
    raw = bytes([0xFA]) * nbytes
    if dtype.kind == "V" or str(dtype) == "bfloat16":
        # numpy may not know bfloat16; handled by caller.
        raise TypeError("bfloat16 handled separately")
    return float(np.frombuffer(raw, dtype=dtype)[0])


# bfloat16 0xFAFA: sign=1, exponent=0xF5 (245), mantissa=0b1111010
# == -(1 + 122/128) * 2**(245-127) = -1.953125 * 2**118
_BF16_NEG_INF_APPROX = -(1.0 + 0x7A / 128.0) * 2.0 ** 118

_NEG_INF_TABLE = {
    jnp.float16.dtype: _pattern_value(np.float16),   # ~ -5.7344e4
    jnp.float32.dtype: _pattern_value(np.float32),   # ~ -6.5251e35
    jnp.float64.dtype: _pattern_value(np.float64),   # ~ -4.8357e281
    jnp.bfloat16.dtype: _BF16_NEG_INF_APPROX,
    # fp8 (beyond reference scope; BASELINE "fp8 compute"): the same
    # 0xFA-pattern convention extended to the 8-bit float formats.
    # e4m3fn 0xFA: -(1 + 2/8)*2^(15-7) = -320; e5m2 0xFA: -1.5*2^15 = -49152
    jnp.float8_e4m3fn.dtype: -320.0,
    jnp.float8_e5m2.dtype: -49152.0,
}

# Masking value used inside kernels, where logits are always computed in
# float32 regardless of the input dtype.  Matches the reference's float32
# pattern so that "masked logit == masking value" round-trips exactly.
MASK_VALUE_F32 = _NEG_INF_TABLE[jnp.float32.dtype]


def canonical_dtype(dtype) -> jnp.dtype:
    dtype = jnp.dtype(dtype)
    if dtype not in _NEG_INF_TABLE:
        raise TypeError(
            f"unsupported dtype {dtype}; expected one of "
            f"{sorted(str(k) for k in _NEG_INF_TABLE)}"
        )
    return dtype


def neg_inf_approx(dtype) -> float:
    """Finite large-negative masking value for ``dtype`` (reference parity)."""
    return _NEG_INF_TABLE[canonical_dtype(dtype)]


def l_dtype(dtype) -> jnp.dtype:
    """Dtype of the softmax normaliser ``l`` for input dtype ``dtype``.

    float32 for half-precision inputs (fp16/bf16), mirroring
    ``L_TypeMapping<half> -> float`` (``flash_attention.h:184-185``);
    otherwise the input dtype.
    """
    dtype = canonical_dtype(dtype)
    if jnp.dtype(dtype).itemsize <= 2:
        return jnp.float32.dtype
    return dtype
