"""Bipartite variable-subproblem GNN predicting per-layer MMA parameters.

flax counterpart of DOGE's PyG model (DOGE/model/model.py:204-401):
several rounds of message passing between variable and BDD nodes through the
layer (edge) set, followed by heads predicting per-layer distribution-weight
logits (softmax-normalized per variable downstream) and damping omega
(sigmoid). Message passing uses segment-sum aggregation over the static layer
graph — the jraph pattern, no dynamic structure.
"""
from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax
import jax.numpy as jnp

from bdd_tpu.learn.features import GraphSpec


class MLP(nn.Module):
    """Feature MLP with the reference's normalization/activation options
    (DOGE/model/model.py:204-260: layer norm + CELU in the extractor MLPs)."""

    widths: Sequence[int]
    layer_norm: bool = False
    activation: str = "relu"

    @nn.compact
    def __call__(self, x):
        act = nn.celu if self.activation == "celu" else nn.relu
        for i, w in enumerate(self.widths):
            x = nn.Dense(w)(x)
            if i + 1 < len(self.widths):
                if self.layer_norm:
                    x = nn.LayerNorm()(x)
                x = act(x)
        return x


class MessagePassingLayer(nn.Module):
    """One var <-> bdd round through edges
    (ref: FeatureExtractorLayer, model.py:57-130)."""

    dim: int
    layer_norm: bool = False
    activation: str = "relu"

    @nn.compact
    def __call__(self, spec: GraphSpec, var_e, bdd_e, edge_e):
        E = spec.E
        mlp = lambda: MLP(
            [self.dim, self.dim],
            layer_norm=self.layer_norm,
            activation=self.activation,
        )
        act = nn.celu if self.activation == "celu" else nn.relu
        ve = var_e[spec.layer_var]
        be = bdd_e[spec.layer_bdd]
        msg_in = jnp.concatenate([ve, be, edge_e], axis=-1)
        edge_new = mlp()(msg_in)
        edge_new = jnp.where(spec.layer_valid[:, None], edge_new, 0.0)

        def seg(x, ids, n):
            s = jax.ops.segment_sum(x, ids, num_segments=n)
            cnt = jax.ops.segment_sum(
                spec.layer_valid.astype(x.dtype), ids, num_segments=n
            )
            return s / jnp.maximum(cnt, 1.0)[:, None]

        var_msg = seg(edge_new, spec.layer_var, spec.nr_vars + 1)
        bdd_msg = seg(edge_new, spec.layer_bdd, spec.nr_bdds + 1)
        var_new = mlp()(jnp.concatenate([var_e, var_msg], -1))
        bdd_new = mlp()(jnp.concatenate([bdd_e, bdd_msg], -1))
        return act(var_new), act(bdd_new), act(edge_new)


class DogePredictor(nn.Module):
    """Predicts (alpha logits, omega logits) per layer
    (ref: DOGEPredictor.forward, model.py:262-401).

    ``use_lstm_var`` mirrors the reference's per-variable LSTM over dual
    rounds (model.py:244-247, 278-282): an LSTMCell consumes the round's
    learned variable features with hidden state carried ACROSS rounds by the
    caller, and the new hidden state is concatenated into the prediction-head
    variable features. Pass ``lstm_state=(c, h)`` (arrays [nr_vars+1, dim]);
    the call then returns ``(alpha_logits, omega_logits, new_lstm_state)``.
    """

    dim: int = 32
    nr_rounds: int = 2
    use_lstm_var: bool = False
    free_update: bool = False  # direct dual step head (ref model.py:318-334)
    layer_norm: bool = False  # LayerNorm in all MLPs (ref model.py option)
    activation: str = "relu"  # or "celu" (ref model.py option)

    def zero_lstm_state(self, nr_vars: int, dtype=jnp.float32):
        z = jnp.zeros((nr_vars + 1, self.dim), dtype)
        return (z, z)

    @nn.compact
    def __call__(self, spec: GraphSpec, var_f, bdd_f, edge_f, lstm_state=None):
        act = nn.celu if self.activation == "celu" else nn.relu
        var_e = act(nn.Dense(self.dim)(var_f))
        bdd_e = act(nn.Dense(self.dim)(bdd_f))
        edge_e = act(nn.Dense(self.dim)(edge_f))
        for _ in range(self.nr_rounds):
            var_e, bdd_e, edge_e = MessagePassingLayer(
                self.dim,
                layer_norm=self.layer_norm,
                activation=self.activation,
            )(spec, var_e, bdd_e, edge_e)
        var_head = var_e
        new_lstm_state = None
        if self.use_lstm_var:
            assert lstm_state is not None, "use_lstm_var needs a carried state"
            new_lstm_state, h = nn.OptimizedLSTMCell(features=self.dim)(
                lstm_state, var_e
            )
            var_head = jnp.concatenate([var_e, h], axis=-1)
        head_in = jnp.concatenate(
            [edge_e, var_head[spec.layer_var], bdd_e[spec.layer_bdd]], axis=-1
        )
        out = MLP(
            [self.dim, 2 + int(self.free_update)],
            layer_norm=self.layer_norm,
            activation=self.activation,
        )(head_in)
        alpha_logits = out[:, 0]
        omega_logits = out[:, 1]
        rets = [alpha_logits, omega_logits]
        if self.free_update:
            # per-layer direct dual step on the hi costs, scaled by a learned
            # step size and projected to zero mean per primal variable so the
            # decomposition stays dual-feasible (ref model.py:318-322: update
            # -= scatter_mean(update, var)[var])
            # explicit dtype: the constant initializer defaults to float64
            # under jax_enable_x64, which would promote the whole update
            step = self.param(
                "free_update_step", nn.initializers.constant(1e-3), (1,),
                out.dtype,
            )
            u = out[:, 2] * jnp.abs(step[0])
            valid = spec.layer_valid
            u = jnp.where(valid, u, 0.0)
            tot = jax.ops.segment_sum(
                u, spec.layer_var, num_segments=spec.nr_vars + 1
            )
            cnt = jax.ops.segment_sum(
                valid.astype(u.dtype),
                spec.layer_var,
                num_segments=spec.nr_vars + 1,
            )
            mean = tot / jnp.maximum(cnt, 1.0)
            u = jnp.where(valid, u - mean[spec.layer_var], 0.0)
            rets.append(u)
        if self.use_lstm_var:
            rets.append(new_lstm_state)
        return tuple(rets)
