"""Public API — parity surface with the reference's 6 entry points.

``full_1d``, ``causal_1d``, ``local_1d``, ``full_2d``, ``causal_2d``,
``local_2d`` reproduce the contract of ``flash_attention/flash_attention.py``
(`:80,122,163,219,266,312`): channel-first tensors
(``Q: batch_shape + (d, *q_seq)``, ``K: batch_shape + (d, *k_seq)``,
``V: batch_shape + (v_d, *k_seq)``), a ``sync_mode`` string, optional
``returning_l_m``, and outputs ``O`` (+ ``l``, ``m``).  Autodiff is wired
through ``jax.custom_vjp`` (the replacement for the reference's
TF gradient registrations, ``flash_attention.py:392-471``) saving
``(Q, K, V, O, l, m)`` as residuals — the exact saved-tensor contract of
the reference backward ops.

Three implementations sit behind the same surface:

* ``"pallas"`` — the fused kernels (compiled through Triton on the GPU; on
  the CPU they run in interpreter mode, the role the reference's no-TF
  ``internal_test.cu`` CPU oracle plays);
* ``"xla_flash"`` — the same flash recurrence as plain XLA
  (``ops/chunked.py``), the float64 path;
* ``"xla"`` — the dense oracle path (useful for debugging and for tiny
  shapes where kernel launch overhead dominates).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .block_sizes import BlockConfig, choose_block_config
from .mask_rules import CausalRule, FullRule, LocalRule, MaskRule
from .ops.attend import AttendParams, attend
from .ops.backend import default_interpret
from .ops.reference import build_mask, reference_attention_flat
from .sync_modes import make_sync_pack

__all__ = [
    "full_1d", "causal_1d", "local_1d",
    "full_2d", "causal_2d", "local_2d",
    "flash_attention",
]


def _default_implementation(dtype) -> str:
    # The Triton route has no float64 tensor-core path (the CUDA reference
    # compiles real fp64 kernels, flash_attention.cu:2450-2487); route it
    # through the chunked flash-structured XLA path, which keeps flash's
    # O(block) memory at the reference's fp64 precision class.
    if jnp.dtype(dtype) == jnp.float64:
        return "xla_flash"
    return "pallas"


def _public_lm(in_dtype, l32, m32):
    """Cast the fp32 kernel stats to the reference's output dtypes.

    ``l`` is float32 for half inputs, else the input dtype
    (``flash_attention.h:181-185``); ``m`` is the input dtype, with the
    finite -inf clamped so it survives the narrowing cast
    (``type_util.h:11-45``).
    """
    from .utils.dtypes import l_dtype, neg_inf_approx

    l_pub = l32.astype(l_dtype(in_dtype))
    m_pub = jnp.maximum(m32, neg_inf_approx(in_dtype)).astype(in_dtype)
    return l_pub, m_pub


def flash_attention(
    Q: jax.Array,
    K: jax.Array,
    V: jax.Array,
    *,
    rule: MaskRule,
    sync_mode: str = "none_front",
    seq_dims: int = 1,
    returning_l_m: bool = False,
    implementation: Optional[str] = None,
    block_config: Optional[BlockConfig] = None,
    interpret: Optional[bool] = None,
    scale: Optional[float] = None,
):
    """Rule-masked flash attention on channel-first tensors.

    The general entry point behind the 6 reference-parity wrappers; also
    accepts any custom :class:`MaskRule`.
    """
    if seq_dims not in (1, 2):
        raise ValueError(f"seq_dims must be 1 or 2, got {seq_dims}")
    q_seq = tuple(int(s) for s in Q.shape[-seq_dims:])
    k_seq = tuple(int(s) for s in K.shape[-seq_dims:])
    v_seq = tuple(int(s) for s in V.shape[-seq_dims:])
    if k_seq != v_seq:
        raise ValueError(f"K and V sequence shapes differ: {k_seq} vs {v_seq}")
    d = int(Q.shape[-seq_dims - 1])
    if int(K.shape[-seq_dims - 1]) != d:
        raise ValueError(
            f"Q and K channel dims differ: {d} vs {K.shape[-seq_dims - 1]}"
        )
    v_d = int(V.shape[-seq_dims - 1])
    batch_shape = tuple(Q.shape[: -seq_dims - 1])
    if tuple(K.shape[: -seq_dims - 1]) != batch_shape or tuple(
        V.shape[: -seq_dims - 1]
    ) != batch_shape:
        raise ValueError("Q, K, V batch shapes must match")
    if Q.dtype != K.dtype or Q.dtype != V.dtype:
        raise ValueError("Q, K, V dtypes must match")

    pack = make_sync_pack(sync_mode, q_seq, k_seq)
    q_len = int(np.prod(q_seq))
    k_len = int(np.prod(k_seq))
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    if implementation is None:
        implementation = _default_implementation(Q.dtype)
    if interpret is None:
        interpret = default_interpret()
    if block_config is None:
        block_config = choose_block_config(q_len, k_len, d, v_d, Q.dtype)

    B = int(np.prod(batch_shape)) if batch_shape else 1
    # channel-first -> (B, seq, channel)
    qf = jnp.swapaxes(Q.reshape((B, d, q_len)), -1, -2)
    kf = jnp.swapaxes(K.reshape((B, d, k_len)), -1, -2)
    vf = jnp.swapaxes(V.reshape((B, v_d, k_len)), -1, -2)

    if implementation == "xla":
        mask = jnp.asarray(build_mask(pack, rule).reshape(q_len, k_len))
        o, l, m = reference_attention_flat(qf, kf, vf, mask, scale=scale)
    elif implementation == "xla_flash":
        from .ops.chunked import flash_attention_xla

        o, lv, mv = flash_attention_xla(
            qf, kf, vf, pack=pack, rule=rule, scale=scale,
            block_q=block_config.block_q, block_kv=block_config.block_kv,
        )
        l, m = _public_lm(Q.dtype, lv, mv)
    elif implementation == "pallas":
        params = AttendParams(
            pack=pack, rule=rule, config=block_config,
            scale=float(scale), interpret=bool(interpret),
        )
        o, l32, m32 = attend(qf, kf, vf, params)
        l, m = _public_lm(Q.dtype, l32, m32)
    else:
        raise ValueError(f"unknown implementation {implementation!r}")

    O = jnp.swapaxes(o, -1, -2).reshape(batch_shape + (v_d,) + q_seq)
    if not returning_l_m:
        return O
    l = l.reshape(batch_shape + q_seq)
    m = m.reshape(batch_shape + q_seq)
    return O, l, m


def full_1d(Q, K, V, sync_mode="none_front", returning_l_m=False, **kwargs):
    """Full (unmasked) attention on 1d sequences (ref ``flash_attention.py:80``)."""
    return flash_attention(Q, K, V, rule=FullRule(), sync_mode=sync_mode,
                           seq_dims=1, returning_l_m=returning_l_m, **kwargs)


def causal_1d(Q, K, V, sync_mode, returning_l_m=False, **kwargs):
    """Causal attention on 1d sequences (ref ``flash_attention.py:122``)."""
    return flash_attention(Q, K, V, rule=CausalRule(), sync_mode=sync_mode,
                           seq_dims=1, returning_l_m=returning_l_m, **kwargs)


def local_1d(Q, K, V, window_size, log2_stride_size, is_causal, sync_mode,
             returning_l_m=False, **kwargs):
    """Local (windowed/strided) attention on 1d sequences (ref ``flash_attention.py:163``)."""
    rule = LocalRule(window_size=window_size, log2_stride_size=log2_stride_size,
                     is_causal=is_causal)
    return flash_attention(Q, K, V, rule=rule, sync_mode=sync_mode,
                           seq_dims=1, returning_l_m=returning_l_m, **kwargs)


def full_2d(Q, K, V, sync_mode="none_front", returning_l_m=False, **kwargs):
    """Full (unmasked) attention on 2d sequences (ref ``flash_attention.py:219``)."""
    return flash_attention(Q, K, V, rule=FullRule(), sync_mode=sync_mode,
                           seq_dims=2, returning_l_m=returning_l_m, **kwargs)


def causal_2d(Q, K, V, sync_mode, returning_l_m=False, **kwargs):
    """Causal attention on 2d sequences (ref ``flash_attention.py:266``)."""
    return flash_attention(Q, K, V, rule=CausalRule(), sync_mode=sync_mode,
                           seq_dims=2, returning_l_m=returning_l_m, **kwargs)


def local_2d(Q, K, V, window_size, log2_stride_size, is_causal, sync_mode,
             returning_l_m=False, **kwargs):
    """Local (windowed/strided) attention on 2d sequences (ref ``flash_attention.py:312``)."""
    rule = LocalRule(window_size=window_size, log2_stride_size=log2_stride_size,
                     is_causal=is_causal)
    return flash_attention(Q, K, V, rule=rule, sync_mode=sync_mode,
                           seq_dims=2, returning_l_m=returning_l_m, **kwargs)
