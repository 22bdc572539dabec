"""Shared in-kernel helpers for the Pallas attention kernels.

The mask expression built here is the in-kernel twin of the NumPy rule
evaluation in ``reference.build_mask``: per-dimension order coordinates are
derived from global row/column positions with shift/mask arithmetic on the
power-of-two reference shape (the reference's coordinate codec,
``flash_attention.h:11-41``) and fed to ``MaskRule.check``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..mask_rules import MaskRule
from ..sync_modes import SeqDescriptor, SyncPack, ref_log2

__all__ = ["kernel_orders", "build_tile_mask", "dot_precision", "dot_nt",
           "dot_nn", "dot_tn", "NEG_INF_F32", "LOG2E", "INV_LOG2E"]

from ..utils.dtypes import MASK_VALUE_F32 as NEG_INF_F32

#: The kernels run the online softmax in the log2 domain:
#: ``p = exp2(s·(scale·log2e) − m₂)``.  ``exp`` is ``exp2`` plus a hidden
#: multiply by log2(e); folding that constant into the (already required)
#: scale multiply removes one full pass over the scores tile.
#: Public ``m`` outputs are converted back to the natural-log domain.
LOG2E = float(math.log2(math.e))
INV_LOG2E = 1.0 / LOG2E


def dot_precision(dtype):
    """Matmul precision for ``dtype`` operands.

    fp32 operands need ``HIGHEST``, which Triton lowers to IEEE fp32 (no
    TF32), to meet the reference's fp32 tolerance model of 1e-6·k_len
    (``test_base.py:205-226``); half dtypes run natively on the tensor
    cores with fp32 accumulation.
    """
    if jnp.dtype(dtype) == jnp.float32:
        return jax.lax.Precision.HIGHEST
    return None


def _dot(a, b, contract):
    return jax.lax.dot_general(
        a, b, (contract, ((), ())), preferred_element_type=jnp.float32,
        precision=dot_precision(a.dtype))


def dot_nt(a, b):
    """``a @ b.T`` with fp32 accumulation."""
    return _dot(a, b, ((1,), (1,)))


def dot_nn(a, b):
    """``a @ b`` with fp32 accumulation."""
    return _dot(a, b, ((1,), (0,)))


def dot_tn(a, b):
    """``a.T @ b`` with fp32 accumulation."""
    return _dot(a, b, ((0,), (0,)))


def kernel_orders(desc: SeqDescriptor, logs: Tuple[int, ...], pos):
    """Order coordinates + flattened order for traced position indices.

    ``pos`` is a (broadcastable) int32 array of row-major flattened sequence
    positions; returns ``(coords, flat)`` where ``coords`` is a list of
    per-dimension order-coordinate arrays.  All arithmetic is static-shape
    int32.  Positions are non-negative, so truncating ``lax.div``/``lax.rem``
    by trace-time constants equal floor division and need no sign fix-up.
    """
    ndim = len(desc.shape)
    shifts = [sum(logs[d + 1:]) for d in range(ndim)]
    coords = []
    rem = pos
    for d in range(ndim):
        inner = math.prod(desc.shape[d + 1:])
        idx_d = jax.lax.div(rem, jnp.int32(inner)) if inner > 1 else rem
        if d + 1 < ndim:
            rem = rem - idx_d * inner
        c = idx_d * desc.stride[d] + desc.offset[d]
        coords.append(c)
    flat = coords[0] << shifts[0] if shifts[0] else coords[0]
    for d in range(1, ndim):
        flat = flat + (coords[d] << shifts[d] if shifts[d] else coords[d])
    return coords, flat


def build_tile_mask(
    pack: SyncPack,
    rule: MaskRule,
    q_pos,
    k_pos,
    q_len: int,
    k_len: int,
    q_len_padded: int,
    k_len_padded: int,
) -> Optional[jax.Array]:
    """Boolean visibility mask for a (block_q, block_kv) tile, or ``None``.

    ``q_pos``/``k_pos`` are global flattened positions as column/row int32
    arrays.  Returns ``None`` when nothing can be masked (full rule and no
    sequence padding), so callers can skip the select entirely.
    """
    mask = None
    if not rule.is_full:
        logs = ref_log2(pack.reference_shape)
        q_coords, q_flat = kernel_orders(pack.q, logs, q_pos)
        k_coords, k_flat = kernel_orders(pack.k, logs, k_pos)
        mask = rule.check(pack, q_coords, k_coords, q_flat, k_flat)
    if q_len_padded > q_len:
        bounds_q = q_pos < q_len
        mask = bounds_q if mask is None else (mask & bounds_q)
    if k_len_padded > k_len:
        bounds_k = k_pos < k_len
        mask = bounds_k if mask is None else (mask & bounds_k)
    if mask is None:
        return None
    return jnp.broadcast_to(mask, (q_pos.shape[0], k_pos.shape[1]))
