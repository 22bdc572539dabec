"""Differentiable sequence-major attention core.

``attend`` wraps the forward/backward Pallas kernels in ``jax.custom_vjp``
— the replacement for the reference's TF gradient registrations
(``flash_attention.py:392-471``).  Residuals are the reference's
saved-tensor set ``(Q, K, V, O, l, m)`` (``flash_attention.py:374-390``)
with the softmax stats kept at fp32.  Both the channel-first parity API
(``api.py``) and the native multi-head layer (``parallel/sharded.mha``)
route through this function, so autodiff works at every level.
"""

from __future__ import annotations

import dataclasses
import functools

import jax

from ..block_sizes import BlockConfig
from ..mask_rules import MaskRule
from ..sync_modes import SyncPack
from .backward import flash_backward
from .forward import flash_forward

__all__ = ["AttendParams", "attend"]


@dataclasses.dataclass(frozen=True)
class AttendParams:
    """Hashable static configuration for one attention call."""

    pack: SyncPack
    rule: MaskRule
    config: BlockConfig
    scale: float
    interpret: bool


@functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
def attend(q, k, v, params: AttendParams):
    """Rule-masked flash attention on ``(B, seq, channel)`` tensors.

    Returns ``(o, l, m)`` with ``l, m`` in float32 (kernel stats); callers
    cast to public dtypes as needed.  Gradients propagate to ``q, k, v``
    from the ``o`` cotangent only — ``l``/``m`` are caches for the backward
    computation (reference: ``flash_attention.py:382-384``).
    """
    return flash_forward(
        q, k, v,
        pack=params.pack, rule=params.rule, config=params.config,
        scale=params.scale, interpret=params.interpret,
    )


def _attend_fwd(q, k, v, params: AttendParams):
    o, l32, m32 = attend(q, k, v, params)
    return (o, l32, m32), (q, k, v, o, l32, m32)


def _attend_bwd(params: AttendParams, residuals, cotangents):
    q, k, v, o, l32, m32 = residuals
    do = cotangents[0]
    dq, dk, dv = flash_backward(
        q, k, v, o, l32, m32, do,
        pack=params.pack, rule=params.rule, config=params.config,
        scale=params.scale, interpret=params.interpret,
    )
    return dq, dk, dv


attend.defvjp(_attend_fwd, _attend_bwd)
