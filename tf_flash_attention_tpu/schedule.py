"""Trace-time block-skip schedule builder.

The reference prunes masked-out (q-tile, kv-tile) pairs *inside* the CUDA
kernel (``IsSkipped`` call sites, ``flash_attention.cu:865-871`` forward,
``:1731-1737`` backward).  Here the pruning moves to trace time: for every q
block we precompute the list of *live* kv blocks, and each kernel program
reads its own row of that int32 table as an ordinary input and loops over
it.  Dead tiles are then **never loaded from device memory** and cost no
loop iteration at all.

Beyond liveness, tiles are classified as *interior* (provably every element
visible and in-bounds — the kernel skips mask construction entirely, pure
matmul + softmax) vs *partial* (the kernel builds the element mask).  The CUDA
reference has no such fast path: it evaluates ``Check`` per element on every
live tile (``flash_attention.cu:915-947``).

Shapes are static under ``jit``; everything here is NumPy executed once per
compiled specialisation (and cached).  ``live`` is shared with the analytic
FLOPs estimator so the cost model honours the same skip schedule as the
kernels, mirroring the contract of the reference estimator
(``flash_attention.cu:2069-2144``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np

from .mask_rules import MaskRule
from .sync_modes import SyncPack, SeqDescriptor, flatten_orders, order_coords

__all__ = ["Schedule", "build_schedule", "sequence_orders",
           "tile_order_bounds"]


def sequence_orders(pack_desc: SeqDescriptor, reference_shape) -> Tuple[np.ndarray, np.ndarray]:
    """Per-position order info for a row-major-flattened sequence.

    Returns ``(coords, flat)`` where ``coords`` has shape ``(ndim, length)``
    with the per-dimension order coordinates of every flattened position,
    and ``flat`` has shape ``(length,)`` with the flattened reference-grid
    orders.  ``length = prod(desc.shape)``.
    """
    per_dim = order_coords(pack_desc)
    length = int(np.prod(pack_desc.shape))
    idx = np.unravel_index(np.arange(length, dtype=np.int64), pack_desc.shape)
    coords = np.stack([per_dim[d][idx[d]] for d in range(pack_desc.ndim)], axis=0)
    flat = flatten_orders(reference_shape, per_dim)[idx]
    return coords.astype(np.int32), np.asarray(flat, dtype=np.int32).reshape(-1)


def tile_order_bounds(coords: np.ndarray, flat: np.ndarray, block: int):
    """Exact per-tile min/max of per-dim coords and flattened orders.

    The trailing partial tile is reduced over its valid entries only.
    Returns ``(coord_lo, coord_hi, flat_lo, flat_hi)`` with shapes
    ``(ndim, n_tiles)`` / ``(n_tiles,)``.
    """
    ndim, length = coords.shape
    n_tiles = -(-length // block)
    pad = n_tiles * block - length
    if pad:
        coords = np.concatenate([coords, np.repeat(coords[:, -1:], pad, axis=1)], axis=1)
        flat = np.concatenate([flat, np.repeat(flat[-1:], pad)])
    coords = coords.reshape(ndim, n_tiles, block)
    flat = flat.reshape(n_tiles, block)
    return (
        coords.min(axis=2),
        coords.max(axis=2),
        flat.min(axis=1),
        flat.max(axis=1),
    )


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Per-q-block live-kv-block schedule with interior/partial classing.

    ``kv_table[qi, step]`` is the kv-block index to visit at ``step`` while
    processing q block ``qi``; only the first ``kv_counts[qi]`` steps are
    real (the rest repeat the last live block and are never visited).
    ``needs_mask[qi, step]`` is 1 when the visited tile requires the
    in-kernel element mask (partial visibility or sequence-padding edge),
    0 when it is provably fully visible and in-bounds.
    ``num_steps = kv_table.shape[1]`` is the table's row width.
    """

    kv_table: np.ndarray    # (num_rows, num_steps) int32
    kv_counts: np.ndarray   # (num_rows,) int32
    needs_mask: np.ndarray  # (num_rows, num_steps) int32 (0/1)
    live: np.ndarray        # (num_rows, num_cols) bool
    partial: np.ndarray     # (num_rows, num_cols) bool

    @property
    def num_q_blocks(self) -> int:
        return self.kv_table.shape[0]

    @property
    def num_steps(self) -> int:
        return self.kv_table.shape[1]

    @property
    def num_kv_blocks(self) -> int:
        return self.live.shape[1]

    def transpose(self) -> "Schedule":
        """Schedule for the kv-outer backward kernel: live q blocks per kv block."""
        return _pack_live(self.live.T, self.partial.T)


def _pack_live(live: np.ndarray, partial: np.ndarray) -> Schedule:
    n_rows, _ = live.shape
    counts = live.sum(axis=1).astype(np.int32)
    num_steps = max(1, int(counts.max()) if n_rows else 1)
    table = np.zeros((n_rows, num_steps), dtype=np.int32)
    needs = np.ones((n_rows, num_steps), dtype=np.int32)
    for r in range(n_rows):
        idx = np.flatnonzero(live[r])
        if idx.size:
            table[r, : idx.size] = idx
            table[r, idx.size :] = idx[-1]
            needs[r, : idx.size] = partial[r, idx]
    return Schedule(kv_table=table, kv_counts=counts, needs_mask=needs,
                    live=live, partial=partial)


def _tile_classes_python(pack: SyncPack, rule: MaskRule, block_q: int, block_kv: int):
    q_coords, q_flat = sequence_orders(pack.q, pack.reference_shape)
    k_coords, k_flat = sequence_orders(pack.k, pack.reference_shape)
    q_len, k_len = q_flat.size, k_flat.size

    q_lo, q_hi, qf_lo, qf_hi = tile_order_bounds(q_coords, q_flat, block_q)
    k_lo, k_hi, kf_lo, kf_hi = tile_order_bounds(k_coords, k_flat, block_kv)

    n_q = q_lo.shape[1]
    n_k = k_lo.shape[1]
    live = np.empty((n_q, n_k), dtype=bool)
    full = np.empty((n_q, n_k), dtype=bool)
    for qi in range(n_q):
        args = (
            pack,
            q_lo[:, qi], q_hi[:, qi],
            k_lo, k_hi,
            qf_lo[qi], qf_hi[qi],
            kf_lo, kf_hi,
        )
        live[qi] = np.asarray(rule.tile_live(*args))
        full[qi] = np.asarray(rule.tile_fully_visible(*args))

    # Sequence-padding edges always need the bounds mask.
    if q_len % block_q:
        full[-1, :] = False
    if k_len % block_kv:
        full[:, -1] = False
    return live, live & ~full


def _classes(pack, rule, block_q, block_kv, use_native):
    if use_native:
        from .native import native_tile_classes
        classes = native_tile_classes(pack, rule, block_q, block_kv)
        if classes is not None:
            return classes
    return _tile_classes_python(pack, rule, block_q, block_kv)


@functools.lru_cache(maxsize=512)
def _build_schedule_cached(pack: SyncPack, rule: MaskRule, block_q: int,
                           block_kv: int, use_native: bool) -> Schedule:
    return _pack_live(*_classes(pack, rule, block_q, block_kv, use_native))


def build_schedule(pack: SyncPack, rule: MaskRule, block_q: int, block_kv: int,
                   use_native: bool = True) -> Schedule:
    """Build (and cache) the live-block schedule for a (pack, rule, tiling).

    Uses the native C++ classifier (``csrc/fa_native.cc``) when available;
    the NumPy implementation is the fallback and behavioural spec.
    """
    return _build_schedule_cached(pack, rule, int(block_q), int(block_kv),
                                  bool(use_native))
