"""Ulysses sequence parallelism: all-to-all head<->sequence resharding.

The second context-parallel strategy next to ring attention
(``parallel/ring.py``) — a component with no reference
counterpart (the reference is single-GPU, SURVEY.md §2).  Inputs arrive
sequence-sharded over the ``context`` mesh axis; one tiled
``jax.lax.all_to_all`` converts them to *head*-sharded tensors
holding the **full** sequence, every chip runs the local Pallas flash
kernel on its head group, and a second all-to-all converts the output
back to sequence sharding:

    (b, H, S/cp, d) --a2a(heads->seq)--> (b, H/cp, S, d)
        --local flash attention--> (b, H/cp, S, v_d)
        --a2a(seq->heads)--> (b, H, S/cp, v_d)

Trade-offs vs the ring (why both exist):

* Ulysses moves activations twice between devices but runs attention on the full
  sequence locally, so **every mask rule × sync mode combination works
  unchanged** — including the strided-local and cross-resolution
  ``scale_front``/``scale_end`` modes whose non-contiguous order maps do
  not decompose neatly across ring hops.  The in-kernel block-skip
  schedule also stays globally optimal.
* The ring keeps memory O(S/cp) per chip at all times; Ulysses
  materialises the full-sequence KV for its local head group, so its
  per-chip memory is O(S·H/cp) — the right choice while heads ≥ cp and
  the sequence still fits, the ring beyond that.
* Parallelism degree is bounded by the KV head count (`cp ≤ n_kv_heads`);
  the ring is bounded only by sequence length.

Differentiable end to end: ``all_to_all`` is linear (its transpose is the
reverse all-to-all) and the local kernel carries its own ``custom_vjp``,
so ``jax.grad`` composes without a hand-written ring-style backward.

2d sequences shard along sequence dim 0 (row slabs), like the ring; after
the gathering all-to-all each chip holds the full row-major-flattened
sequence, so the 2d order arithmetic needs no shard offsets at all.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..block_sizes import BlockConfig, choose_block_config
from ..mask_rules import MaskRule
from ..ops.attend import AttendParams, attend
from ..sync_modes import make_sync_pack
from ..ops.backend import default_interpret
from .mesh import AXIS_CONTEXT, AXIS_DATA, AXIS_MODEL

__all__ = ["ulysses_attention_local", "ulysses_flash_attention"]


def ulysses_attention_local(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    rule: MaskRule,
    axis_name: str,
    axis_size: int,
    sync_mode: str = "none_front",
    q_seq_shape=None,
    k_seq_shape=None,
    scale: Optional[float] = None,
    block_config: Optional[BlockConfig] = None,
    interpret: bool = False,
):
    """Ulysses body (call inside ``shard_map``); differentiable.

    ``q``: ``(b, Hq, sq_local, d)``; ``k``/``v``: ``(b, Hkv, skv_local, *)``
    — sequence axes sharded equally over ``axis_name`` (row-slab sharding
    of dim 0 for 2d sequences, whose *global* shapes are
    ``q_seq_shape``/``k_seq_shape``).  Both head counts must divide by
    ``axis_size``.  Returns the local output shard ``(b, Hq, sq_local, v_d)``.
    """
    b, hq, sq_loc, d = q.shape
    _, hkv, skv_loc, _ = k.shape
    cp = int(axis_size)
    if hq % cp or hkv % cp:
        raise ValueError(
            f"Ulysses needs head counts divisible by the context axis size: "
            f"q heads {hq}, kv heads {hkv}, axis {cp} (use ring attention "
            f"when cp exceeds the KV head count)")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")

    sq, skv = sq_loc * cp, skv_loc * cp
    q_seq_shape = tuple(int(x) for x in (q_seq_shape or (sq,)))
    k_seq_shape = tuple(int(x) for x in (k_seq_shape or (skv,)))
    if int(np.prod(q_seq_shape)) != sq or int(np.prod(k_seq_shape)) != skv:
        raise ValueError(
            f"global seq shapes {q_seq_shape}/{k_seq_shape} do not flatten "
            f"to {sq}/{skv}")

    if cp > 1:
        # heads -> sequence reshard: split the head axis over the mesh
        # axis, gather the full sequence (tiled all-to-all concatenates
        # shards in mesh-axis order = global sequence order).
        a2a = lambda x: jax.lax.all_to_all(
            x, axis_name, split_axis=1, concat_axis=2, tiled=True)
        q, k, v = a2a(q), a2a(k), a2a(v)
    hq_loc, hkv_loc = hq // cp, hkv // cp

    # GQA runs natively in the kernels via the flattened-batch group index
    # map (see parallel/sharded.mha) — no jnp.repeat materialisation.
    if block_config is None:
        block_config = choose_block_config(sq, skv, d, d, q.dtype)
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    params = AttendParams(
        pack=make_sync_pack(sync_mode, q_seq_shape, k_seq_shape),
        rule=rule, config=block_config, scale=float(scale),
        interpret=bool(interpret),
    )
    o, _, _ = attend(
        q.reshape(b * hq_loc, sq, d),
        k.reshape(b * hkv_loc, skv, d),
        v.reshape(b * hkv_loc, skv, v.shape[-1]),
        params,
    )
    o = o.reshape(b, hq_loc, sq, -1)
    if cp > 1:
        # sequence -> heads reshard back to the caller's layout.
        o = jax.lax.all_to_all(o, axis_name, split_axis=2, concat_axis=1,
                               tiled=True)
    return o


def ulysses_flash_attention(
    mesh: Mesh,
    rule: MaskRule,
    *,
    sync_mode: str = "none_front",
    q_seq_shape=None,
    k_seq_shape=None,
    scale: Optional[float] = None,
    block_config: Optional[BlockConfig] = None,
    data_axis: str = AXIS_DATA,
    model_axis: str = AXIS_MODEL,
    context_axis: str = AXIS_CONTEXT,
    interpret: Optional[bool] = None,
):
    """Build a jitted Ulysses context-parallel attention callable.

    Input layout ``(batch, heads, seq, head_dim)``: batch on ``data``,
    heads on ``model``, sequence on ``context`` (the ``seq`` axis carries
    the row-major flattening of 2d sequences, sharded along dim 0, whose
    *global* shapes are ``q_seq_shape``/``k_seq_shape``).  The *local*
    per-chip head count (after any ``model`` sharding) must divide by the
    context axis size.  Differentiable end to end.
    """
    if interpret is None:
        interpret = default_interpret()
    cp = int(mesh.shape[context_axis])
    spec = P(data_axis, model_axis, context_axis, None)

    def local_fn(q, k, v):
        return ulysses_attention_local(
            q, k, v, rule=rule, axis_name=context_axis, axis_size=cp,
            sync_mode=sync_mode, q_seq_shape=q_seq_shape,
            k_seq_shape=k_seq_shape, scale=scale,
            block_config=block_config, interpret=interpret,
        )

    return jax.jit(
        shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(spec, spec, spec),
            out_specs=spec,
            check_vma=False,
        )
    )
