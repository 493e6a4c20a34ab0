"""DOGE-style training loop: learn per-layer MMA parameters with a GNN.

JAX counterpart of DOGE/doge.py + train_doge.py: for each instance and each of
``nr_rounds`` dual rounds, the GNN reads solver-state features and predicts
per-layer (alpha, omega); the solver runs ``iters_per_round`` differentiable
iterations; the loss is the negated sum of per-BDD lower bounds after delta
distribution (doge.py:356-369), with gradients flowing only through the last
round(s) (doge.py:412-459). Optimizer: optax adam. Checkpointing via
flax serialization (orbax-free fallback).
"""
from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from bdd_tpu.learn import features as ft
from bdd_tpu.learn.model import DogePredictor
from bdd_tpu.solver import learned as ln
from bdd_tpu.solver import uniform as uf


@dataclasses.dataclass
class TrainConfig:
    """Hyperparameters (ref: DOGE/configs/defaults.py:26-108)."""

    dim: int = 32
    nr_rounds: int = 3  # dual rounds per instance per epoch
    iters_per_round: int = 5  # differentiable MMA iterations per round
    grad_rounds: int = 1  # rounds (from the end) contributing gradients
    lr: float = 1e-3
    epochs: int = 5
    smoothing: float = 1.0
    seed: int = 0
    use_lstm_var: bool = False  # per-variable LSTM over rounds (ref model.py:244-247)
    free_update: bool = False  # direct zero-sum dual step head (ref model.py:318-334)
    use_replay: bool = False  # resume epochs from replayed states (ref replay_buffer.py)
    history_features: bool = False  # EMA history features (ref cu:185-270)
    history_beta: float = 0.9  # TRAIN.HISTORY_AVG_BETA
    layer_norm: bool = False  # LayerNorm in the GNN MLPs (ref model.py option)
    activation: str = "relu"  # "celu" per the reference's extractor option
    smooth_temps: Tuple[float, ...] = ()  # smooth_sol@T edge features
    prev_lb_features: bool = True  # 'prev_lb'/'lb_change' con features


class Instance:
    """A preprocessed training instance (pickled-solver analogue,
    ref: DOGE/data/ilp_converters.py create_bdd_repr)."""

    def __init__(self, host: uf.UniformHost, objective, dtype=jnp.float32,
                 pre=None):
        self.host = host
        self.objective = jnp.asarray(np.asarray(objective), dtype)
        self.spec = ft.graph_spec(host, pre)
        self.state0 = uf.init_uniform_state(host, objective, dtype=dtype)

    @classmethod
    def from_ilp(cls, ilp, dtype=jnp.float32):
        from bdd_tpu.bdd.preprocessor import BddPreprocessor

        ilp.normalize()
        pre = BddPreprocessor(ilp)
        host = uf.flatten_uniform(
            pre.collection,
            pre.total_nr_variables(),
            pre.nr_primal_variables,
            dtype=dtype,
        )
        obj = pre.objective_vector()
        return cls(host, obj, dtype=dtype, pre=pre)

    @classmethod
    def from_cached(cls, host, objective, spec, dtype=jnp.float32,
                    layer_costs=None):
        """Rebuild from a disk-cached representation (learn.data) without
        re-running the ILP->BDD conversion; ``layer_costs`` (the converged
        {(bdd, var): (lo, hi[, mm])} duals) replaces the objective-split
        initial state — the reference's read_dual_converged path
        (DOGE/data/disk_dataloader.py:119-126)."""
        self = cls.__new__(cls)
        self.host = host
        self.objective = jnp.asarray(np.asarray(objective), dtype)
        self.spec = spec
        if layer_costs is not None:
            self.state0 = uf.init_uniform_state_from_layer_costs(
                host, layer_costs, dtype=dtype
            )
        else:
            self.state0 = uf.init_uniform_state(host, objective, dtype=dtype)
        return self

    @classmethod
    def from_ilps(cls, ilps, dtype=jnp.float32):
        """Batch several ILPs into ONE training instance (the reference
        concatenates layer ranges of several pickled solvers per batch,
        bdd_cuda_torch.py:102-133; here the batching is structural: disjoint
        variable spaces in one collection, so the GNN message passing and the
        delta exchange never mix instances and the loss is the sum of the
        per-instance dual losses)."""
        from bdd_tpu.utils.batching import BatchedInstances

        for ilp in ilps:
            ilp.normalize()
        bi = BatchedInstances(ilps)
        host = uf.flatten_uniform(
            bi.collection, bi.nr_vars, bi.nr_vars, dtype=dtype
        )
        return cls(host, bi.objective, dtype=dtype, pre=bi)


class ReplayBuffer:
    """Stores per-instance solver states keyed by round so later epochs can
    resume mid-trajectory (ref: DOGE/data/replay_buffer.py:3-26)."""

    def __init__(self, capacity_per_key: int = 4) -> None:
        self.capacity = capacity_per_key
        self._store: Dict[Tuple[int, int], List[Any]] = {}

    def add(self, instance_id: int, round_nr: int, state) -> None:
        lst = self._store.setdefault((instance_id, round_nr), [])
        lst.append(jax.tree.map(jax.lax.stop_gradient, state))
        if len(lst) > self.capacity:
            lst.pop(0)

    def sample(self, instance_id: int, round_nr: int, rng: np.random.RandomState):
        lst = self._store.get((instance_id, round_nr))
        if not lst:
            return None
        return lst[rng.randint(len(lst))]


class DogeTrainer:
    def __init__(self, config: Optional[TrainConfig] = None):
        config = config if config is not None else TrainConfig()
        self.cfg = config
        self.model = DogePredictor(
            dim=config.dim,
            use_lstm_var=config.use_lstm_var,
            free_update=config.free_update,
            layer_norm=config.layer_norm,
            activation=config.activation,
        )
        self.params = None
        self.opt = optax.adam(config.lr)
        self.opt_state = None
        self.replay = ReplayBuffer()
        self._replay_rng = np.random.RandomState(config.seed)

    # ----------------------------------------------------------------- setup
    def _zero_lstm(self, instance: Instance):
        if not self.cfg.use_lstm_var:
            return None
        return self.model.zero_lstm_state(
            instance.spec.nr_vars, dtype=instance.objective.dtype
        )

    def init(self, instance: Instance) -> None:
        rng = jax.random.PRNGKey(self.cfg.seed)
        # jit the feature sweeps (eager per-bucket scans dispatch one
        # program per op; host/spec are closure constants, only the state
        # is traced)
        var_f, bdd_f, edge_f = jax.jit(
            lambda st: ft.compute_features(
                instance.host, instance.spec, st, instance.objective,
                self.cfg.smoothing, history=self._zero_history(instance),
                smooth_temps=self.cfg.smooth_temps,
                prev_lb_per_bdd=self._zero_prev_lb(instance),
            )
        )(instance.state0)
        self.params = self.model.init(
            rng, instance.spec, var_f, bdd_f, edge_f,
            lstm_state=self._zero_lstm(instance),
        )
        self.opt_state = self.opt.init(self.params)

    # ------------------------------------------------------------- internals
    def _zero_prev_lb(self, instance: Instance):
        if not self.cfg.prev_lb_features:
            return None
        return jnp.zeros(
            (instance.host.nr_bdds + 1,), instance.objective.dtype
        )

    def _zero_history(self, instance: Instance):
        if not self.cfg.history_features:
            return None
        z = tuple(jnp.zeros_like(l) for l in instance.state0.lo)
        return (z, z, z)

    def _predict(self, params, instance: Instance, state, lstm=None,
                 history=None, prev_lb=None):
        if prev_lb is None:
            prev_lb = self._zero_prev_lb(instance)
        var_f, bdd_f, edge_f = ft.compute_features(
            instance.host, instance.spec, state, instance.objective,
            self.cfg.smoothing, history=history,
            smooth_temps=self.cfg.smooth_temps,
            prev_lb_per_bdd=prev_lb,
        )
        out = self.model.apply(
            params, instance.spec, var_f, bdd_f, edge_f, lstm_state=lstm
        )
        out = list(out)
        a_logits, o_logits = out[0], out[1]
        update = None
        if self.cfg.free_update:
            update = ft.split_like(instance.host, out[2])
        if self.cfg.use_lstm_var:
            lstm = out[-1]
        raw = ft.split_like(instance.host, jnp.exp(jnp.clip(a_logits, -10, 10)))
        alphas = ln.normalize_alpha(
            instance.host.geom,
            tuple(
                jnp.where(g.layer_valid, r, 0.0)
                for g, r in zip(instance.host.geom.buckets, raw)
            ),
        )
        omegas = tuple(
            jax.nn.sigmoid(o)
            for o in ft.split_like(instance.host, o_logits)
        )
        return alphas, omegas, update, lstm

    @staticmethod
    def _apply_free_update(geom, state, update):
        """hi_costs += zero-sum-per-variable direct step (ref model.py:329).
        The per-variable net cost is unchanged, so the state stays a valid
        reparametrization of the same Lagrange dual. The backward run is
        refreshed so the state keeps the documented cft invariant (the next
        forward half-sweep reads min-marginals from cft)."""
        if update is None:
            return state
        hi = tuple(h + u for h, u in zip(state.hi, update))
        cft = tuple(
            uf.bucket_backward_run(g, lo, nh)
            for g, lo, nh in zip(geom.buckets, state.lo, hi)
        )
        return state._replace(hi=hi, cft=cft)

    def _round_loss(self, params, instance: Instance, state, lstm=None,
                    history=None, prev_lb=None):
        """One round: predict (with the previous round's EMA history
        features when enabled, ref solver_utils.py:78-148), free update, n
        learned iterations (ONCE), loss = -sum per-BDD lb after distributing
        the deferred deltas with the LEARNED alphas."""
        geom = instance.host.geom
        alphas, omegas, update, lstm = self._predict(
            params, instance, state, lstm, history, prev_lb
        )
        if self.cfg.prev_lb_features:
            prev_lb = ft.per_bdd_lb_vector(instance.host, state)
        state = self._apply_free_update(geom, state, update)
        if self.cfg.history_features:
            new_state, sol_avg, fo, so = ln.learned_iterations_with_stats(
                geom, state, alphas, omegas, self.cfg.iters_per_round,
                history_itr=self.cfg.iters_per_round,
                beta=self.cfg.history_beta,
            )
            history = (sol_avg, fo, so)
        else:
            new_state = ln.learned_iterations(
                geom, state, alphas, omegas, self.cfg.iters_per_round
            )
        dist = ln.distribute_delta_learned(geom, new_state, alphas)
        loss = -sum(jnp.sum(l) for l in ln.per_bdd_lower_bound(geom, dist))
        return loss, new_state, lstm, history, prev_lb

    # ---------------------------------------------------------------- training
    def _get_jitted(self, instance: Instance):
        """Per-instance jitted (train_step, rollout_round) — the whole epoch
        body runs as one compiled program (eager flax dispatches one
        program per op)."""
        key = id(instance)
        cached = getattr(self, "_jit_cache", None)
        if cached is None:
            cached = self._jit_cache = {}
        if key in cached:
            return cached[key]
        if len(cached) >= 16:  # bounded: the closures pin instance arrays
            cached.pop(next(iter(cached)))
        cfg = self.cfg

        def step(params, opt_state, state0, lstm0):
            state, lstm = state0, lstm0
            hist = self._zero_history(instance)
            plb = self._zero_prev_lb(instance)
            n_pre = cfg.nr_rounds - cfg.grad_rounds
            if n_pre > 0:
                # identical-shape rounds: scan instead of unrolling (a
                # 20-round protocol would otherwise compile 20 copies of
                # features+GNN+iterations)
                def pre_round(carry, _):
                    s, l, h, pl = carry
                    _, s, l, h, pl = self._round_loss(
                        params, instance, s, l, h, pl
                    )
                    return (s, l, h, pl), ()

                (state, lstm, hist, plb), _ = jax.lax.scan(
                    pre_round, (state, lstm, hist, plb), None, length=n_pre
                )
            state = jax.lax.stop_gradient(state)
            if lstm is not None:
                lstm = jax.lax.stop_gradient(lstm)
            if hist is not None:
                hist = jax.lax.stop_gradient(hist)
            if plb is not None:
                plb = jax.lax.stop_gradient(plb)

            def loss_fn(p):
                s, l, h, pl = state, lstm, hist, plb
                total = 0.0
                for _ in range(cfg.grad_rounds):
                    loss, s, l, h, pl = self._round_loss(
                        p, instance, s, l, h, pl
                    )
                    total = total + loss
                return total, s

            (loss, end_state), grads = jax.value_and_grad(
                loss_fn, has_aux=True
            )(params)
            updates, opt_state = self.opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return loss, params, opt_state, jax.lax.stop_gradient(end_state)

        def rollout_round(params, state, lstm, hist, plb):
            geom = instance.host.geom
            alphas, omegas, update, lstm = self._predict(
                params, instance, state, lstm, hist, plb
            )
            if cfg.prev_lb_features:
                plb = ft.per_bdd_lb_vector(instance.host, state)
            state = self._apply_free_update(geom, state, update)
            if cfg.history_features:
                state, sol_avg, fo, so = ln.learned_iterations_with_stats(
                    geom, state, alphas, omegas, cfg.iters_per_round,
                    history_itr=cfg.iters_per_round, beta=cfg.history_beta,
                )
                hist = (sol_avg, fo, so)
            else:
                state = ln.learned_iterations(
                    geom, state, alphas, omegas, cfg.iters_per_round
                )
            # report the bound the loss optimizes: deferred deltas
            # distributed with the LEARNED alphas
            dist = ln.distribute_delta_learned(geom, state, alphas)
            lb = uf.lower_bound_from_cft(geom, dist.cft)
            return state, lb, lstm, hist, plb

        def rollout_scan(params, state, lstm, hist, plb, n: int):
            """Fused inference rollout: n identical rounds under one
            lax.scan — one compile, one dispatch, one host fetch for all
            per-round bounds. The per-round Python loop costs ~25 ms/round
            of GNN-dispatch + lb-sync overhead at small instance sizes
            (~80% of rollout wall on qap16, LEARNED.md round-3 notes);
            fusing removes all but the final sync."""

            def body(carry, _):
                s, l, h, pl = carry
                s, lb, l, h, pl = rollout_round(params, s, l, h, pl)
                return (s, l, h, pl), lb

            (state, lstm, hist, plb), lbs = jax.lax.scan(
                body, (state, lstm, hist, plb), None, length=n
            )
            return lbs

        fns = (
            jax.jit(step),
            jax.jit(rollout_round),
            jax.jit(rollout_scan, static_argnums=5),
        )
        cached[key] = fns
        return fns

    def train_step(self, instance: Instance) -> Dict[str, float]:
        """One epoch on one instance: advance rounds, backprop last rounds.
        With ``use_replay``, epochs may resume from a replayed end-state of a
        previous epoch instead of state0 (ref: doge.py:469-493)."""
        step, _, _ = self._get_jitted(instance)
        state0 = instance.state0
        if self.cfg.use_replay and self._replay_rng.rand() < 0.5:
            replayed = self.replay.sample(id(instance), 0, self._replay_rng)
            if replayed is not None:
                state0 = replayed
        loss, self.params, self.opt_state, end_state = step(
            self.params, self.opt_state, state0,
            self._zero_lstm(instance),
        )
        if self.cfg.use_replay:
            self.replay.add(id(instance), 0, end_state)
        return {"loss": float(loss)}

    def run_learned_rounds(
        self,
        instance: Instance,
        nr_rounds: Optional[int] = None,
        fused: bool = True,
    ) -> List[float]:
        """Inference: run rounds with the trained policy; returns the lb after
        each round (DualMetrics per-round lb, ref: DOGE/metrics/dual_metrics.py).

        Every round's bound is a valid dual bound, and a trained-on-last-round
        policy can drift slightly after converging — use ``best_bound`` (or
        ``max(lbs)``) for the solver-quality readout.

        ``fused`` (default) runs all rounds as ONE scanned program with a
        single host fetch at the end — same per-round computation, minus the
        per-round dispatch/sync overhead; set False to stream bounds round
        by round (e.g. for early-stopping loops)."""
        _, rollout, rollout_scan = self._get_jitted(instance)
        state = instance.state0
        lstm = self._zero_lstm(instance)
        hist = self._zero_history(instance)
        plb = self._zero_prev_lb(instance)
        n = nr_rounds if nr_rounds is not None else self.cfg.nr_rounds
        if fused:
            lbs = rollout_scan(self.params, state, lstm, hist, plb, n)
            return [float(x) for x in np.asarray(lbs)]
        lbs = []
        for _ in range(n):
            state, lb, lstm, hist, plb = rollout(
                self.params, state, lstm, hist, plb
            )
            lbs.append(float(lb))
        return lbs

    def best_bound(
        self, instance: Instance, nr_rounds: Optional[int] = None
    ) -> float:
        """Max dual bound over a learned rollout (each round is valid)."""
        return max(self.run_learned_rounds(instance, nr_rounds))

    # ------------------------------------------------------------ checkpoints
    def save(self, path: str) -> None:
        from flax import serialization

        with open(path, "wb") as fh:
            pickle.dump(
                {
                    "config": dataclasses.asdict(self.cfg),
                    "params": serialization.to_bytes(self.params),
                },
                fh,
            )

    def load(self, path: str, example_instance: Instance) -> None:
        from flax import serialization

        with open(path, "rb") as fh:
            blob = pickle.load(fh)
        cfg_d = dict(blob["config"])
        if "smooth_temps" in cfg_d:
            cfg_d["smooth_temps"] = tuple(cfg_d["smooth_temps"])
        self.cfg = TrainConfig(**cfg_d)
        self.model = DogePredictor(
            dim=self.cfg.dim,
            use_lstm_var=self.cfg.use_lstm_var,
            free_update=self.cfg.free_update,
            layer_norm=self.cfg.layer_norm,
            activation=self.cfg.activation,
        )
        # the optimizer and any jitted closures captured the OLD config
        self.opt = optax.adam(self.cfg.lr)
        self._jit_cache = {}
        self.init(example_instance)
        self.params = serialization.from_bytes(self.params, blob["params"])


def dual_metrics(lbs: List[float], reference_lb: float) -> Dict[str, Any]:
    """Per-round relative dual gap vs a reference bound
    (ref: DOGE/metrics/dual_metrics.py:7-119)."""
    gaps = [
        abs(reference_lb - lb) / max(abs(reference_lb), 1e-9) for lb in lbs
    ]
    return {
        "lb_per_round": lbs,
        "rel_gap_per_round": gaps,
        "final_gap": gaps[-1],
        "best_gap": min(gaps),
    }
