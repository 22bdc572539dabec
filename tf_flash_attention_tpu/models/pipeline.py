"""Pipeline parallelism (GPipe) over a ``pipe`` mesh axis.

The transformer's layers are split into equal stages, one stage per
position on the ``pipe`` axis; microbatches stream through the stages with
activations handed to the next stage via ``jax.lax.ppermute``
(point-to-point between devices).  The schedule is classic GPipe: with ``M``
microbatches and ``S`` stages the loop runs ``M + S - 1`` ticks; ticks a
stage has no work for are masked (the pipeline bubble).  Data parallelism
composes on an outer ``data`` axis (batch sharded; stage weights
replicated across it).  The backward pass is plain autodiff through the
loop — the transposed ``ppermute``s realise the reverse schedule.

Single-purpose by design: the flagship dp/tp/sp training step lives in
``transformer.py``; this module demonstrates the pipe axis for the
multi-axis dryrun and as the scaling path for deep models.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.backend import default_interpret
from .transformer import ModelConfig, _attention_block, _mlp_block, _rms_norm

__all__ = ["stack_stage_params", "pipeline_loss_fn", "make_pipeline_train_step"]

AXIS_PIPE = "pipe"


def stack_stage_params(cfg: ModelConfig, params, n_stages: int):
    """Re-organise flat params into per-stage stacked pytrees.

    ``layers`` (length ``n_layers``) becomes ``layers_per_stage`` lists of
    layer dicts whose leaves carry a leading ``n_stages`` axis (sharded
    over ``pipe``); ``embed``/``final_norm`` stay replicated.
    """
    L = cfg.n_layers
    if L % n_stages:
        raise ValueError(f"n_layers {L} not divisible by n_stages {n_stages}")
    per = L // n_stages
    stacked_layers = []
    for j in range(per):
        stage_layers = [params["layers"][s * per + j] for s in range(n_stages)]
        stacked_layers.append(
            jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *stage_layers)
        )
    return {
        "embed": params["embed"],
        "final_norm": params["final_norm"],
        "layers": stacked_layers,
    }


def _stage_apply(cfg: ModelConfig, local_layers, x, interpret):
    for layer in local_layers:
        x = _attention_block(cfg, layer, x, None, interpret)
        x, _ = _mlp_block(cfg, layer, x)
    return x


def pipeline_loss_fn(cfg: ModelConfig, mesh: Mesh, n_microbatches: int,
                     interpret: Optional[bool] = None,
                     data_axis: str = "data", pipe_axis: str = AXIS_PIPE):
    """Build ``loss(stacked_params, tokens) -> scalar`` with pp (+ dp)."""
    if interpret is None:
        interpret = default_interpret()
    n_stages = int(mesh.shape[pipe_axis])
    M = n_microbatches

    def local_fn(embed, final_norm, layers, tokens):
        # layers leaves arrive with local leading axis 1 (the pipe shard)
        local_layers = [jax.tree.map(lambda x: x[0], layer) for layer in layers]
        stage = jax.lax.axis_index(pipe_axis)
        B = tokens.shape[0]
        if B % M:
            raise ValueError(f"local batch {B} not divisible by microbatches {M}")
        mb = B // M
        T = tokens.shape[1] - 1
        inputs = tokens[:, :-1].reshape(M, mb, T)
        targets = tokens[:, 1:].reshape(M, mb, T)

        d_model = embed.shape[1]
        buf = jnp.zeros((mb, T, d_model), cfg.dtype)
        loss_acc = jnp.float32(0.0)
        perm = [(i, i + 1) for i in range(n_stages - 1)]

        for tick in range(M + n_stages - 1):
            in_mb = min(tick, M - 1)
            x0 = embed.astype(cfg.dtype)[inputs[in_mb]]
            x_in = jnp.where(stage == 0, x0, buf)
            x_out = _stage_apply(cfg, local_layers, x_in, interpret)

            out_tick = tick - (n_stages - 1)
            out_mb = min(max(out_tick, 0), M - 1)
            h = _rms_norm(x_out, final_norm)
            logits = (h @ embed.astype(h.dtype).T).astype(jnp.float32)
            logp = jax.nn.log_softmax(logits, axis=-1)
            nll = -jnp.take_along_axis(
                logp, targets[out_mb][..., None], axis=-1)[..., 0]
            valid = (stage == n_stages - 1) & (0 <= out_tick) & (out_tick < M)
            loss_acc = loss_acc + jnp.where(valid, jnp.mean(nll), 0.0)

            if tick + 1 < M + n_stages - 1:
                buf = jax.lax.ppermute(x_out, pipe_axis, perm)

        # only the last stage accumulated loss; share it with every stage
        loss = jax.lax.psum(loss_acc, pipe_axis) / M
        # mean over data-parallel shards
        loss = jax.lax.pmean(loss, data_axis)
        return loss

    # in_specs for `layers` must mirror the pytree: a list of per-layer
    # dicts each entirely P(pipe).
    def make(params_example):
        layer_specs = [
            jax.tree.map(lambda _: P(pipe_axis), layer)
            for layer in params_example["layers"]
        ]
        return shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P(), P(), layer_specs, P(data_axis, None)),
            out_specs=P(),
            check_vma=False,
        )

    def loss(stacked_params, tokens):
        inner = make(stacked_params)
        return inner(stacked_params["embed"], stacked_params["final_norm"],
                     stacked_params["layers"], tokens)

    return loss


def make_pipeline_train_step(cfg: ModelConfig, mesh: Mesh, optimizer,
                             n_microbatches: int,
                             interpret: Optional[bool] = None,
                             data_axis: str = "data", pipe_axis: str = AXIS_PIPE):
    """jit-compiled pp(+dp) train step over stacked stage params."""
    loss_fn_ = pipeline_loss_fn(cfg, mesh, n_microbatches, interpret,
                                data_axis, pipe_axis)

    def shardings(stacked_params):
        def ns(spec):
            return NamedSharding(mesh, spec)
        return {
            "embed": ns(P()),
            "final_norm": ns(P()),
            "layers": [jax.tree.map(lambda _: ns(P(pipe_axis)), layer)
                       for layer in stacked_params["layers"]],
        }

    @jax.jit
    def step(params, opt_state, tokens):
        import optax
        loss, grads = jax.value_and_grad(lambda p: loss_fn_(p, tokens))(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return loss, params, opt_state

    return step, shardings
