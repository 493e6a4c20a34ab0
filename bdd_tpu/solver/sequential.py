"""True sequential min-marginal averaging (Lange & Swoboda, ICML 2021).

The reference's original CPU algorithm (include/bdd_solver/bdd_mma_base.h,
src/bdd_solver/bdd_mma_base.cpp:104-276): a Gauss-Seidel sweep over *variables*
in order; at each variable the min marginals of all its BDDs are computed
against the already-updated forward state, equalized in place (each BDD's mm
difference is replaced by the average), and the per-BDD frontiers advance with
the new costs. Converges in fewer iterations than the deferred parallel scheme
but is inherently serial — kept as a host-side solver and convergence
reference; the device backends implement the parallel deferred variant.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from bdd_tpu.solver.flatten import FlatBdds

INF = np.inf


class SequentialSolver:
    """Duck-compatible with RefSolver (iteration / lower_bound / ...)."""

    def __init__(self, flat: FlatBdds, objective=None, dtype=np.float64) -> None:
        self.f = flat
        self.dtype = dtype
        if objective is not None:
            self.lo_cost, self.hi_cost = flat.init_costs(objective, dtype)
        else:
            self.lo_cost = np.zeros(flat.nr_layers, dtype=dtype)
            self.hi_cost = np.zeros(flat.nr_layers, dtype=dtype)
        self.def_mm = np.zeros(flat.nr_layers, dtype=dtype)  # unused; interface
        # per-variable layer lists and per-layer node slices
        self._layers_of_var = flat.layers_of_var()
        f = flat
        self._layer_nodes = []
        node_of_layer = [[] for _ in range(f.nr_layers)]
        for i in range(f.nr_nodes):
            node_of_layer[f.node_to_layer[i]].append(i)
        self._layer_nodes = [np.asarray(x, dtype=np.int64) for x in node_of_layer]
        # per-bdd layers ordered by hop (ascending variable order within bdd)
        self._bdd_layers = [[] for _ in range(f.nr_bdds)]
        for h in range(f.nr_hops):
            ls, le = f.hop_layer_range(h)
            for li in range(ls, le):
                self._bdd_layers[int(f.layer_bdd[li])].append(li)
        self._layer_pos = np.zeros(f.nr_layers, dtype=np.int64)
        for b, lst in enumerate(self._bdd_layers):
            for pos, li in enumerate(lst):
                self._layer_pos[li] = pos
        self._cft = self._backward_run()
        self._cfr: Optional[np.ndarray] = None

    # ------------------------------------------------------------------ sweeps
    def _init_cfr(self) -> np.ndarray:
        cfr = np.full(self.f.nr_nodes, INF, dtype=self.dtype)
        cfr[self.f.root_node] = 0.0
        return cfr

    def _backward_run(self) -> np.ndarray:
        from bdd_tpu.solver.ref_solver import numpy_backward_run

        return numpy_backward_run(self.f, self.lo_cost, self.hi_cost, self.dtype)

    def _forward_run(self) -> np.ndarray:
        from bdd_tpu.solver.ref_solver import numpy_forward_run

        return numpy_forward_run(self.f, self.lo_cost, self.hi_cost, self.dtype)

    # --------------------------------------------------------------- iteration
    def _mm_of_layer(self, li: int, cfr: np.ndarray, cft: np.ndarray):
        f = self.f
        ns = self._layer_nodes[li]
        m0 = np.min(cfr[ns] + self.lo_cost[li] + cft[f.lo_node[ns]])
        m1 = np.min(cfr[ns] + self.hi_cost[li] + cft[f.hi_node[ns]])
        return m0, m1

    def _average_at_variable(self, v: int, cfr: np.ndarray, cft: np.ndarray) -> None:
        """Equalize mm differences across the variable's BDD copies in place
        (bdd_mma_base.cpp:104-146)."""
        layers = self._layers_of_var[v]
        if len(layers) == 0:
            return
        diffs = np.empty(len(layers), dtype=self.dtype)
        for j, li in enumerate(layers):
            m0, m1 = self._mm_of_layer(li, cfr, cft)
            if np.isfinite(m0) and np.isfinite(m1):
                diffs[j] = m1 - m0
            elif np.isfinite(m1):
                diffs[j] = -INF
            else:
                diffs[j] = INF
        finite = np.isfinite(diffs)
        if not np.all(finite):
            # forced variable: fix by +inf on the impossible side everywhere
            if np.any(diffs == INF):
                self.hi_cost[layers] = INF
            if np.any(diffs == -INF):
                self.lo_cost[layers] = INF
            return
        avg = diffs.mean()
        self.hi_cost[layers] += avg - diffs

    def _relax_layer_forward(self, li: int, cfr: np.ndarray) -> None:
        f = self.f
        ns = self._layer_nodes[li]
        np.minimum.at(cfr, f.lo_node[ns], cfr[ns] + self.lo_cost[li])
        np.minimum.at(cfr, f.hi_node[ns], cfr[ns] + self.hi_cost[li])

    def _relax_layer_backward(self, li: int, cft: np.ndarray) -> None:
        f = self.f
        ns = self._layer_nodes[li]
        cft[ns] = np.minimum(
            cft[f.lo_node[ns]] + self.lo_cost[li],
            cft[f.hi_node[ns]] + self.hi_cost[li],
        )

    def forward_pass(self) -> None:
        """Gauss-Seidel over variables in ascending order; per-BDD frontiers
        advance lazily so every min marginal sees the already-updated costs of
        all earlier variables of its BDD (bdd_mma_base.cpp:104-146)."""
        f = self.f
        cfr = self._init_cfr()
        cft = self._cft
        cur = np.zeros(f.nr_bdds, dtype=np.int64)  # next unadvanced hop per bdd
        for v in range(f.nr_vars):
            layers = self._layers_of_var[v]
            for li in layers:
                b = int(f.layer_bdd[li])
                pos = int(self._layer_pos[li])
                while cur[b] < pos:
                    self._relax_layer_forward(self._bdd_layers[b][cur[b]], cfr)
                    cur[b] += 1
            self._average_at_variable(v, cfr, cft)
        # complete the frontiers for the backward pass's cfr
        for b in range(f.nr_bdds):
            while cur[b] < len(self._bdd_layers[b]):
                self._relax_layer_forward(self._bdd_layers[b][cur[b]], cfr)
                cur[b] += 1
        self._cfr = cfr

    def backward_pass(self) -> None:
        f = self.f
        cfr = self._cfr if self._cfr is not None else self._forward_run()
        cft = np.zeros(f.nr_nodes, dtype=self.dtype)
        cft[f.bot_node] = INF
        cur = np.asarray(
            [len(lst) for lst in self._bdd_layers], dtype=np.int64
        )  # first not-yet-relaxed hop from the back
        for v in range(f.nr_vars - 1, -1, -1):
            layers = self._layers_of_var[v]
            for li in layers:
                b = int(f.layer_bdd[li])
                pos = int(self._layer_pos[li])
                while cur[b] > pos + 1:
                    cur[b] -= 1
                    self._relax_layer_backward(self._bdd_layers[b][cur[b]], cft)
            self._average_at_variable(v, cfr, cft)
        for b in range(f.nr_bdds):
            while cur[b] > 0:
                cur[b] -= 1
                self._relax_layer_backward(self._bdd_layers[b][cur[b]], cft)
        self._cft = cft

    def iteration(self) -> None:
        self.forward_pass()
        self.backward_pass()

    # -------------------------------------------------------------- interface
    def lower_bound(self) -> float:
        return float(np.sum(self._cft[self.f.root_node]))

    def lower_bound_with_deferred(self) -> float:
        return self.lower_bound()

    def min_marginals(self) -> Tuple[np.ndarray, np.ndarray]:
        f = self.f
        cfr = self._forward_run()
        cft = self._backward_run()
        m0 = np.full(f.nr_layers, INF, dtype=self.dtype)
        m1 = np.full(f.nr_layers, INF, dtype=self.dtype)
        for h in range(f.nr_hops):
            s, e = f.hop_node_range(h)
            lmap = f.node_to_layer[s:e]
            np.minimum.at(m0, lmap, cfr[s:e] + self.lo_cost[lmap] + cft[f.lo_node[s:e]])
            np.minimum.at(m1, lmap, cfr[s:e] + self.hi_cost[lmap] + cft[f.hi_node[s:e]])
        return m0, m1

    def distribute_delta(self) -> None:
        pass  # no deferred state in the sequential scheme

    def update_costs(self, lo_per_var, hi_per_var) -> None:
        f = self.f
        dlo = np.asarray(lo_per_var, dtype=self.dtype)
        dhi = np.asarray(hi_per_var, dtype=self.dtype)
        valid = f.valid_layer_mask()
        lv = f.layer_var[valid]
        scale = 1.0 / f.num_bdds_per_var[lv]
        if dlo.size:
            self.lo_cost[valid] += dlo[lv] * scale
        if dhi.size:
            self.hi_cost[valid] += dhi[lv] * scale
        self._cft = self._backward_run()
        self._cfr = None
