"""Mixture-of-Experts FFN with expert parallelism (GShard-style top-1).

Expert weights carry a leading expert axis sharded over the mesh (``ep``);
token dispatch/combine are einsums against a capacity-limited one-hot
dispatch tensor, so under ``jit`` + sharding GSPMD lowers the
dispatch/combine pair to the canonical all-to-alls.

Top-1 routing with capacity factor: each token goes to its argmax expert;
tokens beyond an expert's capacity are dropped (standard GShard
behaviour); the router is trained with the auxiliary load-balancing loss.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["MoEConfig", "init_moe_params", "moe_ffn"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 4
    d_model: int = 512
    d_ff: int = 1024
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2


def init_moe_params(cfg: MoEConfig, key):
    k1, k2, k3 = jax.random.split(key, 3)
    scale_in = 1.0 / np.sqrt(cfg.d_model)
    scale_out = 1.0 / np.sqrt(cfg.d_ff)
    return {
        "router": jax.random.normal(k1, (cfg.d_model, cfg.n_experts), jnp.float32) * scale_in,
        "w_in": jax.random.normal(k2, (cfg.n_experts, cfg.d_model, cfg.d_ff), jnp.float32) * scale_in,
        "w_out": jax.random.normal(k3, (cfg.n_experts, cfg.d_ff, cfg.d_model), jnp.float32) * scale_out,
    }


def moe_ffn(cfg: MoEConfig, params, x) -> Tuple[jax.Array, jax.Array]:
    """Apply the expert FFN to ``x (b, s, d)``.

    Returns ``(y, aux_loss)`` where ``aux_loss`` is the GShard
    load-balancing term (mean fraction-routed x mean router prob per
    expert, scaled by ``n_experts^2``).
    """
    b, s, d = x.shape
    E = cfg.n_experts
    capacity = max(1, int(cfg.capacity_factor * s / E))

    logits = x.astype(jnp.float32) @ params["router"]          # (b, s, E)
    probs = jax.nn.softmax(logits, axis=-1)
    expert = jnp.argmax(probs, axis=-1)                         # (b, s)
    gate = jnp.take_along_axis(probs, expert[..., None], axis=-1)[..., 0]

    onehot = jax.nn.one_hot(expert, E, dtype=jnp.float32)       # (b, s, E)
    # position of each token within its expert's queue
    position = jnp.cumsum(onehot, axis=1) * onehot - 1.0        # (b, s, E)
    keep = (position >= 0) & (position < capacity)
    pos_onehot = jax.nn.one_hot(position.astype(jnp.int32), capacity,
                                dtype=jnp.float32) * keep[..., None]
    dispatch = onehot[..., None] * pos_onehot                   # (b, s, E, C)

    # dispatch -> per-expert token blocks (GSPMD: all-to-all over the
    # expert-sharded axis)
    expert_in = jnp.einsum("bsec,bsd->ebcd", dispatch, x.astype(jnp.float32))
    h = jax.nn.gelu(jnp.einsum("ebcd,edf->ebcf", expert_in, params["w_in"]))
    expert_out = jnp.einsum("ebcf,efd->ebcd", h, params["w_out"])

    combine = dispatch * gate[..., None, None]                  # (b, s, E, C)
    y = jnp.einsum("bsec,ebcd->bsd", combine, expert_out).astype(x.dtype)

    # load-balancing aux loss (GShard eq. for top-1)
    frac_routed = jnp.mean(onehot * keep.astype(jnp.float32), axis=(0, 1))
    mean_prob = jnp.mean(probs, axis=(0, 1))
    aux = cfg.aux_loss_weight * E * E * jnp.mean(frac_routed * mean_prob)
    return y, aux
