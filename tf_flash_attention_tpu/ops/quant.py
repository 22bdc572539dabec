"""Quantization primitives (INT8 KV-cache, weight-only INT8 projections).

Beyond-reference capability from the BASELINE north star: the serving
path stores the KV cache in INT8 with per-token scales (halving decode
HBM traffic — decode is bandwidth-bound) and dequantizes inside the
attention kernel tile loop; linear-layer weights can be stored INT8 with
per-output-channel scales and dequantized into the matmul.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

__all__ = ["QuantizedTensor", "quantize_int8", "dequantize_int8",
           "quantize_weight_int8", "int8_matmul"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class QuantizedTensor:
    """INT8 payload + float scales broadcastable against it."""

    values: jax.Array   # int8
    scales: jax.Array   # f32, shape = values.shape with quantized axis -> 1

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return jnp.int8


def quantize_int8(x: jax.Array, axis: int = -1) -> QuantizedTensor:
    """Symmetric per-slice INT8 quantization along ``axis``."""
    amax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=axis, keepdims=True)
    scale = jnp.where(amax == 0.0, 1.0, amax / 127.0)
    q = jnp.clip(jnp.round(x.astype(jnp.float32) / scale), -127, 127).astype(jnp.int8)
    return QuantizedTensor(values=q, scales=scale)


def dequantize_int8(qt: QuantizedTensor, dtype=jnp.float32) -> jax.Array:
    return (qt.values.astype(jnp.float32) * qt.scales).astype(dtype)


def quantize_weight_int8(w: jax.Array) -> QuantizedTensor:
    """Weight-only INT8: per-output-channel scales for ``(in, out)`` weights."""
    return quantize_int8(w, axis=0)


def int8_matmul(x: jax.Array, qw: QuantizedTensor) -> jax.Array:
    """``x @ dequant(qw)`` with the dequant folded after the int matmul.

    ``x`` is quantized per-row on the fly; XLA runs an int8 x int8 matmul
    with int32 accumulation (the tensor cores' int8 path on the GPU), and
    both scales are applied to the int32 result.
    """
    qx = quantize_int8(x, axis=-1)
    acc = jax.lax.dot_general(
        qx.values, qw.values, (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return (acc.astype(jnp.float32) * qx.scales * qw.scales.reshape(1, -1)).astype(x.dtype)
