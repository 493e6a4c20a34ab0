"""DOGE training over a device mesh — the reference has no multi-GPU
training story at all (DOGE/doge.py is single-GPU Lightning).

The GNN is tiny and runs replicated on the GLOBAL VIEW of the sharded
geometry (``ShardedUniformSolver.global_view``: every shard's bucket columns
side by side — valid because features and predictions are per-column /
per-(variable, bdd) quantities). The expensive part — the differentiable
learned-MMA rollout — runs sharded under ``shard_map`` with the psum
consensus (``ShardedUniformSolver._learned_run``), so gradients flow through
the mesh collectives.

Per round:
    view_state  <- concat(state_stacked)          (cheap reshapes)
    features    <- compute_features(view)          (replicated)
    alpha/omega <- DogePredictor(features)         (replicated)
    normalize   <- per-variable over ALL shards    (global view)
    stacked     <- split back into [D, H, B]
    rollout     <- sharded learned iterations      (psum consensus)
loss = -global lower bound after the last round (grad on the last
``grad_rounds`` rounds, as in DOGE's last-round-gradient protocol,
doge.py:412-459).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax

from bdd_tpu.learn import features as ft
from bdd_tpu.learn.model import DogePredictor
from bdd_tpu.learn.train import TrainConfig
from bdd_tpu.solver import learned as ln


class ShardedDogeTrainer:
    """Trains a DOGE policy with sharded solver rollouts.

    ``solver``: a ShardedUniformSolver for the training instance.
    """

    def __init__(self, solver, objective, config: TrainConfig) -> None:
        self.solver = solver
        self.cfg = config
        self.objective = jnp.asarray(np.asarray(objective), solver.dtype)
        self.view_host = solver.global_view()
        self.spec = ft.graph_spec(self.view_host)
        self.model = DogePredictor(
            dim=config.dim, free_update=config.free_update,
            use_lstm_var=config.use_lstm_var,
            layer_norm=config.layer_norm, activation=config.activation,
        )
        self.opt = optax.adam(config.lr)
        self.params = None
        self.opt_state = None
        self.state0 = solver.state_stacked

    # ----------------------------------------------------------------- setup
    def _zero_lstm(self):
        if not self.cfg.use_lstm_var:
            return None
        return self.model.zero_lstm_state(
            self.spec.nr_vars, dtype=self.solver.dtype
        )

    def init(self) -> None:
        rng = jax.random.PRNGKey(self.cfg.seed)
        var_f, bdd_f, edge_f = self._features(self.state0)
        self.params = self.model.init(
            rng, self.spec, var_f, bdd_f, edge_f,
            lstm_state=self._zero_lstm(),
        )
        self.opt_state = self.opt.init(self.params)

    # ------------------------------------------------------------- internals
    def _features(self, state_stacked):
        view_state = self._view_state(state_stacked)
        # prev_lb is not threaded through the sharded rollout (yet); a zero
        # column keeps the feature layout identical to the single-device
        # trainer so configs and models transfer
        prev_lb = (
            jnp.zeros((self.view_host.nr_bdds + 1,), self.solver.dtype)
            if self.cfg.prev_lb_features
            else None
        )
        return ft.compute_features(
            self.view_host, self.spec, view_state, self.objective,
            self.cfg.smoothing,
            smooth_temps=self.cfg.smooth_temps,
            prev_lb_per_bdd=prev_lb,
        )

    def _view_state(self, state_stacked):
        return self.solver.view_state(state_stacked)

    def _predict(self, params, state_stacked, lstm=None):
        var_f, bdd_f, edge_f = self._features(state_stacked)
        out = self.model.apply(
            params, self.spec, var_f, bdd_f, edge_f, lstm_state=lstm
        )
        out = list(out)
        a_logits, o_logits = out[0], out[1]
        if self.cfg.use_lstm_var:
            lstm = out[-1]
        update = None
        if self.cfg.free_update:
            update = self.solver.stack_layers(
                ft.split_like(self.view_host, out[2])
            )
        raw = ft.split_like(
            self.view_host, jnp.exp(jnp.clip(a_logits, -10, 10))
        )
        vg = self.view_host.geom
        alphas_view = ln.normalize_alpha(
            vg,
            tuple(jnp.where(g.layer_valid, r, 0.0)
                  for g, r in zip(vg.buckets, raw)),
        )
        alphas = self.solver.stack_layers(alphas_view)
        omegas = self.solver.stack_layers(tuple(
            jax.nn.sigmoid(o)
            for o in ft.split_like(self.view_host, o_logits)
        ))
        return alphas, omegas, update, lstm

    def _apply_free_update(self, state_stacked, update):
        """hi += zero-sum step, refreshing the backward run per shard so
        the cft invariant holds (the next sweep reads marginals from it)."""
        if update is None:
            return state_stacked
        import bdd_tpu.solver.uniform as uf

        hi = tuple(h + u for h, u in zip(state_stacked.hi, update))
        cft = tuple(
            jax.vmap(uf.bucket_backward_run)(g, lo, nh)
            for g, lo, nh in zip(
                self.solver.geom_stacked.buckets, state_stacked.lo, hi
            )
        )
        return state_stacked._replace(hi=hi, cft=cft)

    def _round(self, params, state_stacked, lstm=None):
        alphas, omegas, update, lstm = self._predict(
            params, state_stacked, lstm
        )
        state_stacked = self._apply_free_update(state_stacked, update)
        state_stacked = self.solver._learned_run(
            self.solver.geom_stacked, state_stacked, alphas, omegas,
            self.cfg.iters_per_round,
        )
        return state_stacked, lstm

    def _loss(self, params, state_stacked, lstm=None):
        """-bound after the round's rollout, with the deferred deltas
        distributed by the LEARNED alphas (single-host dual_loss semantics,
        learned.distribute_delta_learned) so the alpha head gets gradient
        from the final distribution step too."""
        alphas, omegas, update, lstm = self._predict(
            params, state_stacked, lstm
        )
        state_stacked = self._apply_free_update(state_stacked, update)
        out = self.solver._learned_run(
            self.solver.geom_stacked, state_stacked, alphas, omegas,
            self.cfg.iters_per_round,
        )
        loss = -self.solver._learned_lb(
            self.solver.geom_stacked, out, alphas
        )
        return loss, out, lstm

    def _get_jitted(self):
        """Jit the whole epoch body once (eager flax dispatches one program
        per op, and re-tracing value_and_grad per epoch is wasteful)."""
        if getattr(self, "_jitted", None) is not None:
            return self._jitted
        cfg = self.cfg

        @jax.jit
        def step(params, opt_state, state0, lstm0):
            state, lstm = state0, lstm0
            for _ in range(cfg.nr_rounds - cfg.grad_rounds):
                state, lstm = self._round(params, state, lstm)
            state = jax.lax.stop_gradient(state)
            if lstm is not None:
                lstm = jax.lax.stop_gradient(lstm)

            def loss_fn(p):
                s, l, total = state, lstm, 0.0
                for _ in range(cfg.grad_rounds):
                    loss, s, l = self._loss(p, s, l)
                    total = total + loss
                return total

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = self.opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return loss, params, opt_state

        @jax.jit
        def rollout(params, state, lstm):
            state, lstm = self._round(params, state, lstm)
            lb = self.solver._lb(self.solver.geom_stacked, state)
            return state, lstm, lb

        self._jitted = (step, rollout)
        return self._jitted

    # ---------------------------------------------------------------- public
    def train_step(self):
        """One epoch over the instance: no-grad rounds, then
        ``grad_rounds`` rounds with gradients (last-round protocol)."""
        step, _ = self._get_jitted()
        loss, self.params, self.opt_state = step(
            self.params, self.opt_state, self.state0, self._zero_lstm()
        )
        return {"loss": float(loss)}

    def run_learned_rounds(self, nr_rounds=None):
        """Rollout with the trained policy; returns the global lower bound
        after each round."""
        nr_rounds = nr_rounds if nr_rounds is not None else self.cfg.nr_rounds
        _, rollout = self._get_jitted()
        state = self.state0
        lstm = self._zero_lstm()
        lbs = []
        for _ in range(nr_rounds):
            state, lstm, lb = rollout(self.params, state, lstm)
            lbs.append(float(lb))
        return lbs
