"""Data- and head-sharded flash attention (``shard_map`` wrappers).

First-class parallelism the reference does not have (SURVEY.md §2): the
attention kernel is wrapped in ``shard_map`` over a ``(data, model)`` mesh
— batch sharded on ``data``, heads on ``model`` — so each chip runs the
Pallas kernel on its local (batch-shard, head-shard) block with **zero
communication during attention** (communication happens in the projections
around it).  GQA co-locates each KV head with its query-head group.

Tensors here use the TPU-native layout ``(batch, heads, seq, head_dim)``
(sequence-major per head); the channel-first reference-parity API in
``api.py`` remains the compatibility surface.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..block_sizes import BlockConfig, choose_block_config
from ..mask_rules import MaskRule
from ..ops.attend import AttendParams, attend
from ..sync_modes import make_sync_pack
from ..ops.backend import default_interpret
from .mesh import AXIS_DATA, AXIS_MODEL

__all__ = ["mha", "sharded_flash_attention"]


def mha(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    rule: MaskRule,
    sync_mode: str = "none_front",
    scale: Optional[float] = None,
    block_config: Optional[BlockConfig] = None,
    interpret: Optional[bool] = None,
    return_stats: bool = False,
):
    """Multi-head attention on ``(batch, heads, seq, head_dim)`` tensors.

    The sequence-major performance path (no layout transposes).  Supports
    GQA/MQA: ``k``/``v`` may have fewer heads than ``q`` as long as
    ``num_q_heads % num_kv_heads == 0``; KV heads are repeated logically.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, dk = k.shape
    if dk != d:
        raise ValueError(f"head_dim mismatch: {d} vs {dk}")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if interpret is None:
        interpret = default_interpret()
    if block_config is None:
        block_config = choose_block_config(sq, skv, d, d, q.dtype)
    # GQA runs natively in the kernels: with heads minor in the flattened
    # batch, query row b·hq + h maps to KV row (b·hq + h) // (hq/hkv)
    # = b·hkv + h//(hq/hkv) via the kernel's BlockSpec index map — no
    # jnp.repeat materialisation, no duplicated KV footprint.
    pack = make_sync_pack(sync_mode, (sq,), (skv,))
    qf = q.reshape(b * hq, sq, d)
    kf = k.reshape(b * hkv, skv, d)
    vf = v.reshape(b * hkv, skv, v.shape[-1])
    if scale is None:
        import numpy as _np
        scale = 1.0 / _np.sqrt(d)
    params = AttendParams(
        pack=pack, rule=rule, config=block_config,
        scale=float(scale), interpret=bool(interpret),
    )
    o, l, m = attend(qf, kf, vf, params)
    o = o.reshape(b, hq, sq, -1)
    if return_stats:
        return o, l.reshape(b, hq, sq), m.reshape(b, hq, sq)
    return o


def sharded_flash_attention(
    mesh: Mesh,
    rule: MaskRule,
    *,
    sync_mode: str = "none_front",
    scale: Optional[float] = None,
    block_config: Optional[BlockConfig] = None,
    data_axis: str = AXIS_DATA,
    model_axis: str = AXIS_MODEL,
    interpret: Optional[bool] = None,
):
    """Build a jitted head+data-sharded attention callable.

    Input layout ``(batch, heads, seq, head_dim)``; batch sharded over
    ``data_axis``, heads over ``model_axis``; sequence and head_dim
    replicated.  Each shard runs the local Pallas kernel — no collectives
    inside attention.
    """
    spec = P(data_axis, model_axis, None, None)

    def local_attention(q, k, v):
        return mha(
            q, k, v, rule=rule, sync_mode=sync_mode, scale=scale,
            block_config=block_config, interpret=interpret,
        )

    return jax.jit(
        shard_map(
            local_attention,
            mesh=mesh,
            in_specs=(spec, spec, spec),
            out_specs=spec,
            check_vma=False,
        )
    )
