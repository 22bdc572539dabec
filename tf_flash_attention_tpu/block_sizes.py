"""Tile sizes and Triton launch parameters for the attention kernels.

The reference sized its tiles from the card's queried shared-memory size
(``DecideConfigurationForForward``, ``flash_attention.cu:1977-2067``).
Here Triton places the tiles in shared memory and registers itself, so
the choice is a small table keyed by the kernel's operand class (16-bit
or float32) and the padded head dim.  Tiles are powers of two of at
least 16 rows, the smallest operand Triton's ``dot`` takes.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

__all__ = ["BlockConfig", "choose_block_config", "pad_to", "pad_dim",
           "MIN_BLOCK"]

MIN_BLOCK = 16


def pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def pad_dim(d: int) -> int:
    """Feature width a kernel tile uses: the next power of two >= 16."""
    return max(MIN_BLOCK, next_pow2(d))


def fit_block(block: int, length: int) -> int:
    """``block`` shrunk to the sequence, keeping a power of two >= 16."""
    return max(MIN_BLOCK, min(block, next_pow2(length)))


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """Static tile sizes and launch parameters of the kernels.

    ``block_q``/``block_kv`` tile the forward kernel; ``block_q_dkv``/
    ``block_kv_dkv`` tile the kv-outer backward kernel (dK, dV and dQ);
    ``block_q_dq``/``block_kv_dq`` tile the q-outer dQ pass of the split
    backward.  ``num_warps``/``num_stages`` launch the forward kernel,
    ``bwd_num_warps``/``bwd_num_stages`` the backward kernels.
    """

    block_q: int
    block_kv: int
    block_q_dq: int
    block_kv_dq: int
    block_q_dkv: int
    block_kv_dkv: int
    num_warps: int = 4
    num_stages: int = 2
    bwd_num_warps: int = 4
    bwd_num_stages: int = 2

    def __post_init__(self):
        for name in ("block_q", "block_kv", "block_q_dq", "block_kv_dq",
                     "block_q_dkv", "block_kv_dkv"):
            v = getattr(self, name)
            if v < MIN_BLOCK or v & (v - 1):
                raise ValueError(
                    f"{name}={v} must be a power of two >= {MIN_BLOCK}")


# (16-bit operands?, padded head dim) -> (fwd block_q, block_kv, warps,
# stages, bwd block_q, block_kv, warps, stages).  The d=64 and d=128 rows
# are the fastest of a sweep on an H100 at causal S=4096 (S=2048 for
# float32; ``PERF.md``); narrower heads reuse the d=64 row and d=256
# halves the tiles.  Float32 runs in IEEE mode
# (``kernel_common.dot_precision``), whose larger tiles spill registers:
# at d=128 a (64, 64) forward measured 8x slower than (32, 32).
_TABLE = {
    (True, 16): (64, 64, 4, 3, 64, 64, 4, 2),
    (True, 32): (64, 64, 4, 3, 64, 64, 4, 2),
    (True, 64): (64, 64, 4, 3, 64, 64, 4, 2),
    (True, 128): (64, 128, 4, 3, 64, 64, 4, 3),
    (True, 256): (64, 32, 8, 2, 32, 32, 8, 1),
    (False, 16): (32, 32, 4, 2, 32, 32, 4, 2),
    (False, 32): (32, 32, 4, 2, 32, 32, 4, 2),
    (False, 64): (32, 32, 4, 2, 32, 32, 4, 2),
    (False, 128): (32, 32, 4, 2, 16, 16, 4, 1),
    (False, 256): (16, 16, 4, 1, 16, 16, 4, 1),
}


def choose_block_config(q_len: int, k_len: int, d: int, v_d: int,
                        dtype) -> BlockConfig:
    """Tiles for one call, from the table, shrunk to short sequences."""
    half = jnp.dtype(dtype).itemsize <= 2
    width = min(256, pad_dim(max(d, v_d)))
    fq, fk, fw, fs, bq, bk, bw, bs = _TABLE[half, width]
    return BlockConfig(
        block_q=fit_block(fq, q_len), block_kv=fit_block(fk, k_len),
        block_q_dq=fit_block(bq, q_len), block_kv_dq=fit_block(bk, k_len),
        block_q_dkv=fit_block(bq, q_len), block_kv_dkv=fit_block(bk, k_len),
        num_warps=fw, num_stages=fs, bwd_num_warps=bw, bwd_num_stages=bs,
    )
