"""Ring attention: context parallelism, forward and backward.

Sequence/context parallelism for sequences beyond one chip's HBM — a
component with no reference counterpart (the reference
scales sequence length only by tiling + block skipping on one GPU,
SURVEY.md §5).  KV shards rotate around the ``context`` mesh axis via
``jax.lax.ppermute`` (point-to-point, which XLA hands to NCCL) while every chip
runs the local Pallas flash kernel on the shard currently in front of it;
XLA's latency-hiding scheduler overlaps the permute with the compute.

The cross-shard combine is the *same online (m, l, O) merge* the kernels
use across KV tiles (and that the reference implements across blocks at
``flash_attention.cu:974-1035``) — the ring is the inter-chip level of the
identical recurrence:

    m' = max(m, m_s);  l' = e^(m-m')·l + e^(m_s-m')·l_s
    O' = (e^(m-m')·l·O + e^(m_s-m')·l_s·O_s) / l'

Causal masking decomposes exactly over aligned equal shards: a KV shard
from an earlier ring position is fully visible (full-rule kernel, no mask
work), the diagonal shard is locally causal, and later shards are skipped
outright (l = 0 contribution) — the shard-level analog of the block-skip
schedule.

**2d sequences** shard along sequence dimension 0: each device holds a
slab of rows, which is a *contiguous* range of the row-major-flattened
sequence the kernels consume, so the same ring applies unchanged.  The
flattened reference order of an earlier row-slab is everywhere smaller
(row-major flattening is monotone in the dim-0 coordinate,
``flash_attention.h:27-41``), so the causal full/diagonal/skip shard
decomposition holds verbatim; local rules get global dim-0 coordinates
through per-pair offset packs, and the banded shard schedule is driven by
the dim-0 window reach.

**Backward** is a ring-level ``custom_vjp``: the forward saves the global
softmax stats ``(l, m)`` (exact after the full ring pass), and the
backward runs its own ring loop, calling the recompute-based
``flash_backward`` kernels per visiting shard with those *global* stats —
dK/dV partials rotate alongside their K/V shards and arrive home after a
full cycle.  This is the standard ring-attention gradient; masked-out
shard pairs contribute exact zeros.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..block_sizes import BlockConfig, choose_block_config
from ..mask_rules import CausalRule, FullRule
from ..ops.backward import flash_backward
from ..ops.forward import flash_forward
from ..sync_modes import make_sync_pack
from ..utils.dtypes import MASK_VALUE_F32
from ..ops.backend import default_interpret
from .mesh import AXIS_CONTEXT, AXIS_DATA, AXIS_MODEL

__all__ = ["ring_attention_local", "ring_flash_attention"]


@dataclasses.dataclass(frozen=True)
class _RingParams:
    axis_name: str
    axis_size: int
    causal: bool
    scale: Optional[float]
    block_config: BlockConfig
    interpret: bool
    local_rule: Optional["LocalRule"] = None  # local rule over the ring
    #: local (per-shard) sequence shape; ndim > 1 means a 2d sequence
    #: sharded along dim 0 (row slabs of the flattened layout)
    seq_shape: tuple = ()


def _shift(x, axis_name, axis_size, delta=1):
    return jax.lax.ppermute(
        x, axis_name,
        [(i, (i + delta) % axis_size) for i in range(axis_size)])


def _branch_index(src, my):
    return jnp.where(src == my, 1, jnp.where(src > my, 2, 0))


def _offset_pack(seq_shape, q_off0: int, k_off0: int):
    """Sync pack placing the two shards at their *global* positions.

    ``seq_shape`` is the local per-shard sequence shape; shards are offset
    along dimension 0 only (the sharded dimension).  Order coordinates
    become global sequence positions (offset + index), so the rule
    predicates and the block-skip schedule see exactly the global geometry
    of the shard pair.
    """
    from ..sync_modes import SeqDescriptor, SyncPack

    pow2 = lambda n: 1 << (int(n) - 1).bit_length()
    top0 = max(q_off0, k_off0) + seq_shape[0]
    ref = (pow2(top0),) + tuple(pow2(s) for s in seq_shape[1:])
    ndim = len(seq_shape)
    q_off = (int(q_off0),) + (0,) * (ndim - 1)
    k_off = (int(k_off0),) + (0,) * (ndim - 1)
    return SyncPack(
        reference_shape=ref,
        q=SeqDescriptor(tuple(seq_shape), (1,) * ndim, q_off),
        k=SeqDescriptor(tuple(seq_shape), (1,) * ndim, k_off),
    )


def _local_live_steps(rule, n: int, r0: int):
    """Static per-step liveness of the banded shard schedule.

    ``r0`` is the per-shard extent of the sharded sequence dimension
    (dim 0; the whole sequence for 1d).  At ring step ``t`` a device sees
    the shard ``t`` positions behind it (or ``n - t`` ahead, for devices
    that wrapped).  A shard pair can contain a visible element iff the
    per-dim window reaches across the dim-0 gap:
    ``gap*r0 - (r0-1) <= strided_window - 1`` (the remaining dimensions
    always overlap — shards span them fully).  Steps where neither the
    behind nor (non-causal) ahead case is live are dropped entirely —
    ppermute jumps straight to the next live rotation.
    """
    sw = rule.strided_window_size
    steps = []
    for t in range(n):
        behind = (t * r0) <= sw + r0 - 2
        ahead = (not rule.is_causal) and t > 0 and ((n - t) * r0) <= sw + r0 - 2
        if t == 0 or behind or ahead:
            steps.append((t, behind or t == 0, ahead))
    return steps


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def _ring_attend(q, k, v, params: _RingParams):
    o, _, _ = _ring_forward(q, k, v, params)
    return o


def _ring_forward_local(q, k, v, params: _RingParams):
    """Forward ring pass for a local rule (banded shard schedule)."""
    rule = params.local_rule
    B, s, d = q.shape
    v_d = v.shape[-1]
    n = params.axis_size
    seq_shape = params.seq_shape or (s,)
    r0 = seq_shape[0]
    my = jax.lax.axis_index(params.axis_name)

    def part(pack):
        def fn(args):
            k_cur, v_cur = args
            o_s, l_s, m_s = flash_forward(
                q, k_cur, v_cur, pack=pack, rule=rule,
                config=params.block_config, scale=params.scale,
                interpret=params.interpret)
            return o_s.astype(jnp.float32), l_s, m_s
        return fn

    def skip_part(args):
        return (
            jnp.zeros((B, s, v_d), jnp.float32),
            jnp.zeros((B, s), jnp.float32),
            jnp.full((B, s), MASK_VALUE_F32, jnp.float32),
        )

    o = jnp.zeros((B, s, v_d), jnp.float32)
    l = jnp.zeros((B, s), jnp.float32)
    m = jnp.full((B, s), MASK_VALUE_F32, jnp.float32)
    k_cur, v_cur = k, v
    rot = 0

    for t, behind_live, ahead_live in _local_live_steps(rule, n, r0):
        if t != rot:
            k_cur = _shift(k_cur, params.axis_name, n, t - rot)
            v_cur = _shift(v_cur, params.axis_name, n, t - rot)
            rot = t
        branches = [
            part(_offset_pack(seq_shape, t * r0, 0)) if behind_live else skip_part,
            part(_offset_pack(seq_shape, 0, (n - t) * r0)) if ahead_live else skip_part,
        ]
        is_behind = my >= t  # device my sees shard my - t (no wrap)
        o_s, l_s, m_s = jax.lax.switch(
            jnp.where(is_behind, 0, 1), branches, (k_cur, v_cur))

        m_new = jnp.maximum(m, m_s)
        a = jnp.exp(m - m_new)
        b_w = jnp.exp(m_s - m_new)
        l_new = a * l + b_w * l_s
        l_safe = jnp.where(l_new == 0.0, 1.0, l_new)
        o = ((a * l)[..., None] * o + (b_w * l_s)[..., None] * o_s) / l_safe[..., None]
        l, m = l_new, m_new

    return o.astype(q.dtype), l, m


def _ring_bwd_local(params: _RingParams, residuals, do):
    """Backward ring pass for a local rule."""
    rule = params.local_rule
    q, k, v, o, l, m = residuals
    s = q.shape[1]
    n = params.axis_size
    seq_shape = params.seq_shape or (s,)
    r0 = seq_shape[0]
    my = jax.lax.axis_index(params.axis_name)

    def part(pack):
        def fn(args):
            k_cur, v_cur = args
            return flash_backward(
                q, k_cur, v_cur, o, l, m, do,
                pack=pack, rule=rule, config=params.block_config,
                scale=params.scale, interpret=params.interpret)
        return fn

    def skip_part(args):
        k_cur, v_cur = args
        return (jnp.zeros_like(q), jnp.zeros_like(k_cur), jnp.zeros_like(v_cur))

    dq = jnp.zeros(q.shape, jnp.float32)
    k_cur, v_cur = k, v
    dk_cur = jnp.zeros(k.shape, jnp.float32)
    dv_cur = jnp.zeros(v.shape, jnp.float32)
    rot = 0

    for t, behind_live, ahead_live in _local_live_steps(rule, n, r0):
        if t != rot:
            shift = lambda x: _shift(x, params.axis_name, n, t - rot)
            k_cur, v_cur = shift(k_cur), shift(v_cur)
            dk_cur, dv_cur = shift(dk_cur), shift(dv_cur)
            rot = t
        branches = [
            part(_offset_pack(seq_shape, t * r0, 0)) if behind_live else skip_part,
            part(_offset_pack(seq_shape, 0, (n - t) * r0)) if ahead_live else skip_part,
        ]
        dq_s, dk_s, dv_s = jax.lax.switch(
            jnp.where(my >= t, 0, 1), branches, (k_cur, v_cur))
        dq = dq + dq_s.astype(jnp.float32)
        dk_cur = dk_cur + dk_s.astype(jnp.float32)
        dv_cur = dv_cur + dv_s.astype(jnp.float32)

    if rot % n:
        home = (n - rot) % n
        dk_cur = _shift(dk_cur, params.axis_name, n, home)
        dv_cur = _shift(dv_cur, params.axis_name, n, home)

    return dq.astype(q.dtype), dk_cur.astype(k.dtype), dv_cur.astype(v.dtype)


def _ring_forward(q, k, v, params: _RingParams):
    if params.local_rule is not None:
        return _ring_forward_local(q, k, v, params)
    B, s, d = q.shape
    v_d = v.shape[-1]
    n = params.axis_size
    # Diagonal-shard pack in *local* coordinates: row-major flattening is
    # monotone in the dim-0 coordinate, so slab-local order comparisons
    # equal global ones (both operands share the same dim-0 offset).
    seq_shape = params.seq_shape or (s,)
    pack = make_sync_pack("none_front", seq_shape, seq_shape)
    my = jax.lax.axis_index(params.axis_name)

    def part(rule):
        def fn(args):
            k_cur, v_cur = args
            o_s, l_s, m_s = flash_forward(
                q, k_cur, v_cur, pack=pack, rule=rule,
                config=params.block_config, scale=params.scale,
                interpret=params.interpret)
            return o_s.astype(jnp.float32), l_s, m_s
        return fn

    def skip_part(args):
        return (
            jnp.zeros((B, s, v_d), jnp.float32),
            jnp.zeros((B, s), jnp.float32),
            jnp.full((B, s), MASK_VALUE_F32, jnp.float32),
        )

    branches = [part(FullRule()), part(CausalRule()), skip_part]

    o = jnp.zeros((B, s, v_d), jnp.float32)
    l = jnp.zeros((B, s), jnp.float32)
    m = jnp.full((B, s), MASK_VALUE_F32, jnp.float32)
    k_cur, v_cur = k, v

    for step in range(n):
        src = (my - step) % n
        if params.causal:
            o_s, l_s, m_s = jax.lax.switch(
                _branch_index(src, my), branches, (k_cur, v_cur))
        else:
            o_s, l_s, m_s = branches[0]((k_cur, v_cur))

        # online merge (identical recurrence to the in-kernel KV-tile merge)
        m_new = jnp.maximum(m, m_s)
        a = jnp.exp(m - m_new)
        b_w = jnp.exp(m_s - m_new)
        l_new = a * l + b_w * l_s
        l_safe = jnp.where(l_new == 0.0, 1.0, l_new)
        o = ((a * l)[..., None] * o + (b_w * l_s)[..., None] * o_s) / l_safe[..., None]
        l, m = l_new, m_new

        if step + 1 < n:
            k_cur = _shift(k_cur, params.axis_name, n)
            v_cur = _shift(v_cur, params.axis_name, n)

    return o.astype(q.dtype), l, m


def _ring_fwd(q, k, v, params: _RingParams):
    o, l, m = _ring_forward(q, k, v, params)
    return o, (q, k, v, o, l, m)


def _ring_bwd(params: _RingParams, residuals, do):
    if params.local_rule is not None:
        return _ring_bwd_local(params, residuals, do)
    q, k, v, o, l, m = residuals
    n = params.axis_size
    seq_shape = params.seq_shape or (q.shape[1],)
    pack = make_sync_pack("none_front", seq_shape, seq_shape)
    my = jax.lax.axis_index(params.axis_name)

    def part(rule):
        def fn(args):
            k_cur, v_cur = args
            return flash_backward(
                q, k_cur, v_cur, o, l, m, do,
                pack=pack, rule=rule, config=params.block_config,
                scale=params.scale, interpret=params.interpret)
        return fn

    def skip_part(args):
        k_cur, v_cur = args
        return (jnp.zeros_like(q), jnp.zeros_like(k_cur), jnp.zeros_like(v_cur))

    branches = [part(FullRule()), part(CausalRule()), skip_part]

    dq = jnp.zeros(q.shape, jnp.float32)
    k_cur, v_cur = k, v
    dk_cur = jnp.zeros(k.shape, jnp.float32)
    dv_cur = jnp.zeros(v.shape, jnp.float32)

    for step in range(n):
        src = (my - step) % n
        if params.causal:
            dq_s, dk_s, dv_s = jax.lax.switch(
                _branch_index(src, my), branches, (k_cur, v_cur))
        else:
            dq_s, dk_s, dv_s = branches[0]((k_cur, v_cur))
        dq = dq + dq_s.astype(jnp.float32)
        dk_cur = dk_cur + dk_s.astype(jnp.float32)
        dv_cur = dv_cur + dv_s.astype(jnp.float32)
        # rotate the kv shard together with its gradient partials; after a
        # full cycle the accumulated dK/dV land back on their home chip
        k_cur = _shift(k_cur, params.axis_name, n)
        v_cur = _shift(v_cur, params.axis_name, n)
        dk_cur = _shift(dk_cur, params.axis_name, n)
        dv_cur = _shift(dv_cur, params.axis_name, n)

    return dq.astype(q.dtype), dk_cur.astype(k.dtype), dv_cur.astype(v.dtype)


_ring_attend.defvjp(_ring_fwd, _ring_bwd)


def ring_attention_local(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    axis_name: str,
    axis_size: int,
    causal: bool = True,
    rule=None,
    seq_shape=None,
    scale: Optional[float] = None,
    block_config: Optional[BlockConfig] = None,
    interpret: bool = False,
):
    """Ring attention body (call inside ``shard_map``); differentiable.

    ``q, k, v``: local shards ``(B, s, d)`` where the global sequence is
    sharded equally (and identically for q and kv) over ``axis_name``.
    ``rule`` may be Full/Causal (overrides ``causal``) or a
    :class:`LocalRule`, which runs the banded shard schedule (only steps
    the window can reach are visited, with global-position masking inside
    each shard pair).  ``seq_shape`` is the *local* (per-shard) sequence
    shape for 2d sequences sharded along dim 0 (``s`` must equal its
    product); omit for 1d.  Returns the local output shard ``(B, s, v_d)``.
    """
    from ..mask_rules import LocalRule as _Local

    B, s, d = q.shape
    if seq_shape is None:
        seq_shape = (s,)
    seq_shape = tuple(int(x) for x in seq_shape)
    import numpy as _np
    if int(_np.prod(seq_shape)) != s:
        raise ValueError(f"seq_shape {seq_shape} does not flatten to {s}")
    if block_config is None:
        block_config = choose_block_config(s, s, d, d, q.dtype)
    local_rule = None
    if rule is not None:
        if isinstance(rule, _Local):
            local_rule = rule
        elif isinstance(rule, CausalRule):
            causal = True
        elif isinstance(rule, FullRule):
            causal = False
        else:
            raise ValueError(f"unsupported ring rule {rule!r}")
    params = _RingParams(
        axis_name=axis_name, axis_size=int(axis_size), causal=bool(causal),
        scale=None if scale is None else float(scale),
        block_config=block_config, interpret=bool(interpret),
        local_rule=local_rule, seq_shape=seq_shape,
    )
    return _ring_attend(q, k, v, params)


def ring_flash_attention(
    mesh: Mesh,
    *,
    causal: bool = True,
    rule=None,
    seq_shape=None,
    scale: Optional[float] = None,
    block_config: Optional[BlockConfig] = None,
    data_axis: str = AXIS_DATA,
    model_axis: str = AXIS_MODEL,
    context_axis: str = AXIS_CONTEXT,
    interpret: Optional[bool] = None,
):
    """Build a jitted context-parallel ring-attention callable.

    Input layout ``(batch, heads, seq, head_dim)``: batch on ``data``,
    heads on ``model``, sequence on ``context`` (2D/3D meshes supported;
    missing axes may have size 1).  For 2d sequences pass the *global*
    ``seq_shape``; the ``seq`` axis carries the row-major flattening and
    is sharded along sequence dim 0 (dim 0 must divide by the context
    axis size).  Differentiable end to end.
    """
    if interpret is None:
        interpret = default_interpret()
    axis_size = int(mesh.shape[context_axis])
    local_seq_shape = None
    if seq_shape is not None:
        seq_shape = tuple(int(x) for x in seq_shape)
        if seq_shape[0] % axis_size:
            raise ValueError(
                f"sequence dim 0 ({seq_shape[0]}) must divide by the "
                f"context axis size ({axis_size})")
        local_seq_shape = (seq_shape[0] // axis_size,) + seq_shape[1:]
    spec = P(data_axis, model_axis, context_axis, None)

    def local_fn(q, k, v):
        b, h, s, d = q.shape
        o = ring_attention_local(
            q.reshape(b * h, s, d),
            k.reshape(b * h, s, d),
            v.reshape(b * h, s, v.shape[-1]),
            axis_name=context_axis,
            axis_size=axis_size,
            causal=causal,
            rule=rule,
            seq_shape=local_seq_shape,
            scale=scale,
            block_config=block_config,
            interpret=interpret,
        )
        return o.reshape(b, h, s, -1)

    return jax.jit(
        shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(spec, spec, spec),
            out_specs=spec,
            check_vma=False,
        )
    )
