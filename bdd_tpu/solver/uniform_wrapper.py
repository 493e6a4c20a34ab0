"""UniformSolver — object wrapper for the bucketed uniform backend.

Duck-compatible with RefSolver / JaxSolver (run loop, rounding, outer loops).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bdd_tpu.bdd.collection import BddCollection
from bdd_tpu.solver import uniform as uf

INF = np.inf


class UniformLayerView:
    """The layer-indexed view the rounding decoder needs (a stand-in for
    FlatBdds over the concatenated per-bucket [H*B] layer arrays)."""

    def __init__(self, host: uf.UniformHost) -> None:
        self.host = host
        self.nr_vars = host.nr_vars
        self.nr_primal_vars = host.nr_primal_vars
        self.layer_var = np.concatenate(
            [np.asarray(g.layer_var).ravel() for g in host.geom.buckets]
        )
        self._valid = np.concatenate(
            [np.asarray(g.layer_valid).ravel() for g in host.geom.buckets]
        )
        self.num_bdds_per_var = np.asarray(host.geom.num_bdds_per_var)

    def valid_layer_mask(self) -> np.ndarray:
        return self._valid


class UniformSolver:
    default_block_size = 25

    def __init__(
        self,
        collection: BddCollection,
        nr_vars: int,
        objective,
        nr_primal_vars: Optional[int] = None,
        dtype=jnp.float32,
        omega: float = 0.5,
        layer_costs=None,
    ) -> None:
        """``layer_costs``: optional {(bdd, var): (lo, hi)} warm start — the
        tightening cost-transfer path; ``objective`` is ignored for state
        init then (the transferred duals carry the full decomposition)."""
        self.host = uf.flatten_uniform(collection, nr_vars, nr_primal_vars, dtype=dtype)
        self.geom = self.host.geom
        if layer_costs is not None:
            self.state = uf.init_uniform_state_from_layer_costs(
                self.host, layer_costs, dtype=dtype
            )
        else:
            self.state = uf.init_uniform_state(self.host, objective, dtype=dtype)
        self.omega = omega
        self.dtype = dtype
        self.f = UniformLayerView(self.host)

    @classmethod
    def from_host(
        cls, host, objective, dtype=jnp.float32, omega: float = 0.5
    ) -> "UniformSolver":
        """Wrap an ALREADY-FLATTENED uniform host (e.g. from
        native.NativeHost.make_uniform_host) without re-running the Python
        flattener — the cheap path for bench/serving code that built the
        geometry natively."""
        self = cls.__new__(cls)
        self.host = host
        self.geom = host.geom
        self.state = uf.init_uniform_state(host, objective, dtype=dtype)
        self.omega = omega
        self.dtype = dtype
        self.f = UniformLayerView(host)
        return self

    def export_layer_costs(self) -> dict:
        """Converged duals as {(bdd, var): (lo, hi)} — distribute the
        deferred ledger first so the dict carries the full decomposition
        (input format of tighten_collection's cost transfer)."""
        self.distribute_delta()
        out = {}
        for k, g in enumerate(self.geom.buckets):
            lvalid = np.asarray(g.layer_valid)
            lbdd = np.asarray(self.host.layer_bdd[k])
            lvar = np.asarray(g.layer_var)
            lo = np.asarray(self.state.lo[k], dtype=np.float64)
            hi = np.asarray(self.state.hi[k], dtype=np.float64)
            for (h, b) in zip(*np.nonzero(lvalid & (lbdd >= 0))):
                out[(int(lbdd[h, b]), int(lvar[h, b]))] = (
                    lo[h, b], hi[h, b],
                )
        return out

    # ------------------------------------------------------------------- dual
    def iteration(self) -> None:
        self.state = uf.iterations(self.geom, self.state, 1, self.omega)

    def iteration_block(self, n: int) -> None:
        self.state = uf.iterations(self.geom, self.state, n, self.omega)

    def lower_bound(self) -> float:
        return float(uf.lower_bound(self.geom, self.state))

    def lower_bound_with_deferred(self) -> float:
        return float(uf.lower_bound_with_deferred(self.geom, self.state))

    def lower_bound_per_bdd(self) -> np.ndarray:
        out = np.zeros(self.host.nr_bdds)
        for g, cft, lbdd in zip(
            self.geom.buckets, self.state.cft, self.host.layer_bdd
        ):
            roots = np.asarray(uf.root_rows(g))
            vals = np.asarray(cft[:, 0, :])
            bdds = np.asarray(lbdd)
            m = roots & (bdds >= 0)
            out[bdds[m]] = vals[m]
        return out

    # -------------------------------------------------------------- marginals
    def min_marginals(self) -> Tuple[np.ndarray, np.ndarray]:
        """Concatenated per-bucket [H*B] min marginals (UniformLayerView
        indexing); +inf at invalid layers."""
        mm = uf.min_marginals_all(self.geom, self.state)
        m0 = np.concatenate([np.asarray(a).ravel() for (a, b) in mm])
        m1 = np.concatenate([np.asarray(b).ravel() for (a, b) in mm])
        return m0, m1

    # ------------------------------------------------------------------ costs
    def distribute_delta(self) -> None:
        self.state = uf.distribute_delta(self.geom, self.state)

    def update_layer_costs(self, lo_delta, hi_delta) -> None:
        """Per-layer cost deltas in UniformLayerView (concatenated [H*B])
        indexing (one jitted program — eager per-bucket device work
        dispatches one program per op)."""
        dl_l, dh_l = [], []
        off = 0
        for g in self.geom.buckets:
            n = g.H * g.B
            dl_l.append(jnp.asarray(
                np.asarray(lo_delta[off : off + n]).reshape(g.H, g.B),
                self.dtype,
            ))
            dh_l.append(jnp.asarray(
                np.asarray(hi_delta[off : off + n]).reshape(g.H, g.B),
                self.dtype,
            ))
            off += n
        self.state = _update_layer_costs_jit(
            self.geom, self.state, tuple(dl_l), tuple(dh_l)
        )

    def update_costs(self, lo_per_var, hi_per_var) -> None:
        lo_u = jnp.asarray(
            np.append(np.asarray(lo_per_var, np.float64), 0.0), dtype=self.dtype
        )
        hi_u = jnp.asarray(
            np.append(np.asarray(hi_per_var, np.float64), 0.0), dtype=self.dtype
        )
        self.state = _update_costs_jit(self.geom, self.state, lo_u, hi_u)


_update_costs_jit = jax.jit(uf.update_costs_per_var)


@jax.jit
def _update_layer_costs_jit(geom, state, dls, dhs):
    lo_l, hi_l, cft_l = [], [], []
    for g, lo, hi, dl, dh in zip(geom.buckets, state.lo, state.hi, dls, dhs):
        nl = jnp.where(g.layer_valid, lo + dl, 0.0)
        nh = jnp.where(g.layer_valid, hi + dh, 0.0)
        lo_l.append(nl)
        hi_l.append(nh)
        cft_l.append(uf.bucket_backward_run(g, nl, nh))
    return uf.UniformState(
        tuple(lo_l), tuple(hi_l), state.def_mm, tuple(cft_l)
    )
