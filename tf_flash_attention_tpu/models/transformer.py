"""Flagship transformer LM built on the flash-attention kernels.

The reference ships no models (it is an op library); this is the TPU
build's demonstration vehicle: a decoder-only LM whose attention runs the
rule-masked Pallas kernels (causal or local/strided via ``MaskRule``),
trained with a fully sharded step:

* **dp** — batch sharded over the ``data`` mesh axis;
* **tp** — attention heads and MLP hidden sharded over ``model``
  (Megatron-style column/row parallel pairs: the wo / w2 matmuls produce
  partials that XLA reduces);
* **sp** — between-block activations (norm inputs) sharded along the
  sequence dimension over the same ``model`` axis (Megatron sequence
  parallelism), expressed as sharding constraints that GSPMD lowers to
  reduce-scatter/all-gather;
* attention itself runs inside ``shard_map`` with heads on ``model`` and
  no collectives (``parallel/sharded.py``).

Pure functional style: params are pytrees, the train step is
``jax.jit``-compiled with explicit ``NamedSharding``s.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..block_sizes import BlockConfig
from ..mask_rules import CausalRule, MaskRule
from ..parallel.mesh import AXIS_CONTEXT, AXIS_DATA, AXIS_MODEL
from ..parallel.sharded import mha
from ..ops.backend import default_interpret

__all__ = ["ModelConfig", "init_params", "forward", "loss_fn", "train_step",
           "param_shardings", "make_sharded_train_step",
           "quantize_model_weights"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_head: int = 64
    d_ff: int = 1536
    max_seq: int = 1024
    dtype: Any = jnp.bfloat16
    rule: MaskRule = dataclasses.field(default_factory=CausalRule)
    block_config: Optional[BlockConfig] = None
    # Mixture-of-Experts FFN (expert parallelism) when n_experts > 0
    n_experts: int = 0
    capacity_factor: float = 1.25
    # ring attention over a 'context' mesh axis (sequence sharded)
    context_parallel: bool = False

    @property
    def rope_theta(self) -> float:
        return 10000.0


def _dense_init(key, shape, scale=None):
    scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
    return jax.random.normal(key, shape, jnp.float32) * scale


def init_params(cfg: ModelConfig, key) -> Dict[str, Any]:
    keys = jax.random.split(key, cfg.n_layers + 2)
    params = {
        "embed": jax.random.normal(keys[0], (cfg.vocab, cfg.d_model), jnp.float32) * 0.02,
        "final_norm": jnp.ones((cfg.d_model,), jnp.float32),
        "layers": [],
    }
    for i in range(cfg.n_layers):
        k = jax.random.split(keys[i + 1], 7)
        layer = {
            "ln1": jnp.ones((cfg.d_model,), jnp.float32),
            "ln2": jnp.ones((cfg.d_model,), jnp.float32),
            "wq": _dense_init(k[0], (cfg.d_model, cfg.n_heads * cfg.d_head)),
            "wk": _dense_init(k[1], (cfg.d_model, cfg.n_kv_heads * cfg.d_head)),
            "wv": _dense_init(k[2], (cfg.d_model, cfg.n_kv_heads * cfg.d_head)),
            "wo": _dense_init(k[3], (cfg.n_heads * cfg.d_head, cfg.d_model)),
        }
        if cfg.n_experts:
            from .moe import init_moe_params
            layer["moe"] = init_moe_params(_moe_cfg(cfg), k[6])
        else:
            layer.update({
                "w1": _dense_init(k[4], (cfg.d_model, cfg.d_ff)),
                "w3": _dense_init(k[5], (cfg.d_model, cfg.d_ff)),
                "w2": _dense_init(k[4], (cfg.d_ff, cfg.d_model)),
            })
        params["layers"].append(layer)
    return params


def _moe_cfg(cfg: ModelConfig):
    from .moe import MoEConfig
    return MoEConfig(n_experts=cfg.n_experts, d_model=cfg.d_model,
                     d_ff=cfg.d_ff, capacity_factor=cfg.capacity_factor)


def param_shardings(cfg: ModelConfig, mesh: Mesh):
    """NamedShardings for the parameter pytree (tp over ``model``)."""
    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    layer = {
        "ln1": ns(None), "ln2": ns(None),
        "wq": ns(None, AXIS_MODEL),
        "wk": ns(None, AXIS_MODEL),
        "wv": ns(None, AXIS_MODEL),
        "wo": ns(AXIS_MODEL, None),
    }
    if cfg.n_experts:
        # expert parallelism: expert axis sharded over the model axis
        layer["moe"] = {
            "router": ns(None, None),
            "w_in": ns(AXIS_MODEL, None, None),
            "w_out": ns(AXIS_MODEL, None, None),
        }
    else:
        layer.update({
            "w1": ns(None, AXIS_MODEL),
            "w3": ns(None, AXIS_MODEL),
            "w2": ns(AXIS_MODEL, None),
        })
    return {
        "embed": ns(None, None),
        "final_norm": ns(None),
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
    }


def quantize_model_weights(params):
    """Weight-only INT8 for the linear projections (inference path).

    Stores wq/wk/wv/wo/w1/w2/w3 as :class:`QuantizedTensor` (int8 payload +
    per-output-channel scales); matmuls run int8 x int8 with int32 accumulation, the
    scales applied to the int32 result (``ops/quant.int8_matmul``).
    """
    from ..ops.quant import quantize_weight_int8

    out = {"embed": params["embed"], "final_norm": params["final_norm"],
           "layers": []}
    for layer in params["layers"]:
        q = dict(layer)
        for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
            if name in q:
                q[name] = quantize_weight_int8(q[name])
        out["layers"].append(q)
    return out


def _proj(x, w):
    """x @ w for dense or weight-only-quantized w."""
    from ..ops.quant import QuantizedTensor, int8_matmul

    if isinstance(w, QuantizedTensor):
        return int8_matmul(x, w)
    return x @ w.astype(x.dtype)


def _rms_norm(x, scale, eps=1e-6):
    x32 = x.astype(jnp.float32)
    rms = jax.lax.rsqrt(jnp.mean(x32 * x32, axis=-1, keepdims=True) + eps)
    return (x32 * rms * scale).astype(x.dtype)


def _rope(x, theta, pos0=0):
    """Rotary embedding on (b, h, s, d_head); positions start at ``pos0``
    (nonzero for context-parallel shards, where positions are global)."""
    b, h, s, d = x.shape
    half = d // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    pos = pos0 + jnp.arange(s, dtype=jnp.float32)
    angles = pos[:, None] * freqs[None, :]
    cos = jnp.cos(angles)[None, None].astype(x.dtype)
    sin = jnp.sin(angles)[None, None].astype(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return jnp.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], axis=-1)


def _use_cp(cfg, mesh) -> bool:
    return (cfg.context_parallel and mesh is not None
            and int(mesh.shape.get(AXIS_CONTEXT, 1)) > 1)


def _attention_block(cfg: ModelConfig, layer, x, mesh: Optional[Mesh], interpret):
    b, s, _ = x.shape
    h = _rms_norm(x, layer["ln1"])
    q = _proj(h, layer["wq"]).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = _proj(h, layer["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = _proj(h, layer["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    q = jnp.swapaxes(q, 1, 2)
    k = jnp.swapaxes(k, 1, 2)
    v = jnp.swapaxes(v, 1, 2)

    if _use_cp(cfg, mesh):
        # context parallelism: sequence sharded over 'context', heads over
        # 'model'; RoPE applied per shard at global positions; attention is
        # the differentiable ring
        from ..parallel.ring import ring_attention_local

        n_ctx = int(mesh.shape[AXIS_CONTEXT])
        spec = P(AXIS_DATA, AXIS_MODEL, AXIS_CONTEXT, None)

        def cp_attend(q, k, v):
            bb, hh, ss, dd = q.shape
            pos0 = jax.lax.axis_index(AXIS_CONTEXT) * ss
            q_r = _rope(q, cfg.rope_theta, pos0)
            k_r = _rope(k, cfg.rope_theta, pos0)
            # GQA runs natively in the kernels (flattened-batch group index
            # map, parallel/sharded.mha) — no jnp.repeat materialisation.
            hh_kv = k_r.shape[1]
            o = ring_attention_local(
                q_r.reshape(bb * hh, ss, dd),
                k_r.reshape(bb * hh_kv, ss, dd),
                v.reshape(bb * hh_kv, ss, -1),
                axis_name=AXIS_CONTEXT, axis_size=n_ctx,
                rule=cfg.rule, block_config=cfg.block_config,
                interpret=interpret,
            )
            return o.reshape(bb, hh, ss, -1)

        o = shard_map(
            cp_attend, mesh=mesh, in_specs=(spec, spec, spec),
            out_specs=spec, check_vma=False,
        )(q, k, v)
    else:
        q = _rope(q, cfg.rope_theta)
        k = _rope(k, cfg.rope_theta)
        attend = functools.partial(
            mha, rule=cfg.rule, block_config=cfg.block_config, interpret=interpret
        )
        if mesh is not None:
            spec = P(AXIS_DATA, AXIS_MODEL, None, None)
            o = shard_map(
                attend, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
                check_vma=False,
            )(q, k, v)
        else:
            o = attend(q, k, v)
    o = jnp.swapaxes(o, 1, 2).reshape(b, s, cfg.n_heads * cfg.d_head)
    return x + _proj(o, layer["wo"])


def _mlp_block(cfg: ModelConfig, layer, x):
    h = _rms_norm(x, layer["ln2"])
    if cfg.n_experts:
        from .moe import moe_ffn
        y, aux = moe_ffn(_moe_cfg(cfg), layer["moe"], h)
        return x + y, aux
    gated = jax.nn.silu(_proj(h, layer["w1"])) * _proj(h, layer["w3"])
    return x + _proj(gated, layer["w2"]), jnp.float32(0.0)


def forward(cfg: ModelConfig, params, tokens, *, mesh: Optional[Mesh] = None,
            interpret: Optional[bool] = None, return_aux: bool = False):
    """Token ids ``(batch, seq)`` -> logits ``(batch, seq, vocab)``
    (optionally ``(logits, moe_aux_loss)``)."""
    if interpret is None:
        interpret = default_interpret()

    def sp(x):
        # Megatron-style sequence parallelism: between-block activations
        # sharded along seq — over 'context' when context parallelism is
        # on (sequence residency), else over the tp axis (GSPMD inserts
        # the reduce-scatter/all-gather pairs).
        if _use_cp(cfg, mesh):
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, P(AXIS_DATA, AXIS_CONTEXT, None))
            )
        if mesh is not None and mesh.shape.get(AXIS_MODEL, 1) > 1:
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, P(AXIS_DATA, AXIS_MODEL, None))
            )
        return x

    x = params["embed"].astype(cfg.dtype)[tokens]
    aux_total = jnp.float32(0.0)
    for layer in params["layers"]:
        x = sp(x)
        x = _attention_block(cfg, layer, x, mesh, interpret)
        x = sp(x)
        x, aux = _mlp_block(cfg, layer, x)
        aux_total = aux_total + aux
    x = _rms_norm(x, params["final_norm"])
    logits = (x @ params["embed"].astype(x.dtype).T).astype(jnp.float32)
    if return_aux:
        return logits, aux_total
    return logits


def loss_fn(cfg: ModelConfig, params, tokens, *, mesh=None, interpret=None):
    """Next-token cross entropy (+ MoE load-balancing aux loss)."""
    logits, aux = forward(cfg, params, tokens[:, :-1], mesh=mesh,
                          interpret=interpret, return_aux=True)
    targets = tokens[:, 1:]
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    return jnp.mean(nll) + aux


def train_step(cfg: ModelConfig, params, opt_state, tokens, *, optimizer,
               mesh=None, interpret=None):
    """One SGD/optax step; returns (loss, params, opt_state)."""
    loss, grads = jax.value_and_grad(
        lambda p: loss_fn(cfg, p, tokens, mesh=mesh, interpret=interpret)
    )(params)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    import optax
    params = optax.apply_updates(params, updates)
    return loss, params, opt_state


def make_sharded_train_step(cfg: ModelConfig, mesh: Mesh, optimizer,
                            interpret: Optional[bool] = None):
    """jit-compiled train step with dp/tp/sp shardings over ``mesh``."""
    p_shard = param_shardings(cfg, mesh)
    tok_shard = NamedSharding(mesh, P(AXIS_DATA, None))
    opt_shard = None  # optax state mirrors params; let GSPMD propagate

    @functools.partial(
        jax.jit,
        in_shardings=(p_shard, opt_shard, tok_shard),
        donate_argnums=(0, 1),
    )
    def step(params, opt_state, tokens):
        return train_step(cfg, params, opt_state, tokens, optimizer=optimizer,
                          mesh=mesh, interpret=interpret)

    return step
