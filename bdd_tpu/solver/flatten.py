"""QBDD collection → hop-major solver arrays.

This is the layout decision at the heart of the framework (SURVEY.md §7):
the reference's GPU SoA (include/bdd_solver/bdd_cuda_base.h:183-207) already
bucketizes BDD nodes by *hop distance* from the root so one kernel sweeps all
BDDs' hop-h nodes at once. We keep that and produce two views:

1. ``FlatBdds`` — flat arrays with per-hop prefix offsets, the exact analogue
   of the CUDA/torch layout (populate_bdd_nodes/compress_bdd_nodes_to_layer,
   bdd_cuda_base.cu:87-307). Used by the numpy oracle solver and as the
   serialization format.

2. ``DenseBdds`` — every hop padded to fixed widths (W nodes, L layers) giving
   static [H, W]/[H, L] arrays scanned by ``lax.scan``/Pallas. Child pointers
   become *hop-local* indices into the next row; terminal arcs carry flags
   instead of pointers (TOP: cost-from-terminal 0, BOT: +inf), replacing the
   reference's two sentinel nodes per BDD.

Vocabulary (ref SURVEY.md §1 L3): a **layer** is a (bdd, variable-level) pair —
one dual variable with lo/hi Lagrange costs; hop h of BDD b is its h-th level;
all nodes of (b, h) belong to layer (b, h).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from bdd_tpu.bdd.collection import BOT, TOP, BddCollection

# arc kinds in DenseBdds
ARC_INTERNAL = 0
ARC_TOP = 1
ARC_BOT = 2


@dataclass
class FlatBdds:
    """Flat hop-major arrays (CUDA-layout analogue).

    Node arrays have size ``nr_nodes = sum of BDD nodes + 2*nr_bdds`` — each
    BDD contributes one TOP and one BOT terminal node at the end (final hop
    block), mirroring bdd_cuda_base. Terminal nodes have lo_node = hi_node = -1.
    """

    nr_vars: int  # total (primal + auxiliary split) variables
    nr_primal_vars: int
    nr_bdds: int
    nr_hops: int  # variable hops (terminal block excluded)

    # per node
    lo_node: np.ndarray  # int32 [nr_nodes], absolute node index or -1
    hi_node: np.ndarray
    node_to_layer: np.ndarray  # int32 [nr_nodes]
    cum_nodes_per_hop: np.ndarray  # int64 [nr_hops + 1], last entry incl. terminals

    # per layer
    layer_var: np.ndarray  # int32 [nr_layers], nr_vars for terminal layers
    layer_bdd: np.ndarray  # int32 [nr_layers]
    cum_layers_per_hop: np.ndarray  # int64 [nr_hops + 1]

    # per bdd
    root_node: np.ndarray  # int32 [nr_bdds]
    top_node: np.ndarray
    bot_node: np.ndarray

    # per variable
    num_bdds_per_var: np.ndarray  # int32 [nr_vars]

    @property
    def nr_nodes(self) -> int:
        return len(self.lo_node)

    @property
    def nr_layers(self) -> int:
        return len(self.layer_var)

    def hop_node_range(self, h: int) -> Tuple[int, int]:
        return (
            int(self.cum_nodes_per_hop[h - 1]) if h > 0 else 0,
            int(self.cum_nodes_per_hop[h]),
        )

    def hop_layer_range(self, h: int) -> Tuple[int, int]:
        return (
            int(self.cum_layers_per_hop[h - 1]) if h > 0 else 0,
            int(self.cum_layers_per_hop[h]),
        )

    def valid_layer_mask(self) -> np.ndarray:
        return self.layer_var < self.nr_vars

    def init_costs(
        self, objective: Sequence[float], dtype=np.float64
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Distribute objective over layers: hi_cost = c_v / nr_bdds(v)
        (ref: bdd_cuda_base update_costs semantics)."""
        obj = np.asarray(objective, dtype=dtype)
        assert len(obj) == self.nr_vars
        lo = np.zeros(self.nr_layers, dtype=dtype)
        hi = np.zeros(self.nr_layers, dtype=dtype)
        valid = self.valid_layer_mask()
        v = self.layer_var[valid]
        hi[valid] = obj[v] / self.num_bdds_per_var[v]
        return lo, hi

    def layers_of_var(self) -> List[np.ndarray]:
        """CSR: layer indices per variable."""
        valid = self.valid_layer_mask()
        order = np.argsort(self.layer_var[valid], kind="stable")
        idx = np.nonzero(valid)[0][order]
        splits = np.searchsorted(
            self.layer_var[idx], np.arange(1, self.nr_vars + 1)
        )
        return np.split(idx, splits[:-1])


@dataclass
class DenseBdds:
    """Hop-padded static-shape arrays for the JAX scan / Pallas backends."""

    nr_vars: int
    nr_primal_vars: int
    nr_bdds: int
    H: int  # hops
    W: int  # max nodes per hop
    L: int  # max layers per hop

    # nodes [H, W]
    node_valid: np.ndarray  # bool
    layer_local: np.ndarray  # int32, L for padding
    lo_kind: np.ndarray  # int8: ARC_*
    lo_next: np.ndarray  # int32 local index in hop h+1, W for terminal/pad
    hi_kind: np.ndarray
    hi_next: np.ndarray

    # layers [H, L]
    layer_valid: np.ndarray  # bool
    layer_var: np.ndarray  # int32, nr_vars for padding
    layer_bdd: np.ndarray  # int32, -1 for padding

    # hop 0: root w-slot of bdd b
    root_slot_bdd: np.ndarray  # int32 [nr_bdds] -> w index in row 0

    num_bdds_per_var: np.ndarray  # int32 [nr_vars]

    # mapping into FlatBdds layer indexing (for cost import/export):
    flat_layer_index: np.ndarray  # int32 [H, L], -1 for padding

    def pack_costs(self, flat_costs: np.ndarray, fill: float = 0.0) -> np.ndarray:
        out = np.full((self.H, self.L), fill, dtype=flat_costs.dtype)
        m = self.flat_layer_index >= 0
        out[m] = flat_costs[self.flat_layer_index[m]]
        return out

    def unpack_costs(self, dense: np.ndarray, nr_layers: int) -> np.ndarray:
        out = np.zeros(nr_layers, dtype=dense.dtype)
        m = self.flat_layer_index >= 0
        out[self.flat_layer_index[m]] = np.asarray(dense)[m]
        return out


def flatten_collection(
    collection: BddCollection,
    nr_vars: int,
    nr_primal_vars: Optional[int] = None,
) -> FlatBdds:
    """Build the flat hop-major arrays from a QBDD collection.

    Node order: (hop, layer_var, bdd, within-bdd) — the CUDA sort key
    (bdd_cuda_base.cu:147-188). Terminal nodes (one TOP + one BOT per BDD) form
    a final block; each BDD has one terminal layer with var = nr_vars.
    """
    nb = collection.nr_bdds()
    if nr_primal_vars is None:
        nr_primal_vars = nr_vars

    # per-bdd structure
    per_bdd_levels: List[List[int]] = []
    per_bdd_vars: List[List[int]] = []
    H = 0
    for b in range(nb):
        assert collection.is_qbdd(b), f"bdd {b} is not quasi-reduced"
        lv = collection.node_levels(b)
        per_bdd_levels.append(lv)
        per_bdd_vars.append(collection.level_variables(b))
        H = max(H, max(lv) + 1)

    # enumerate (hop, var, bdd, node) tuples
    # layers: (hop, var, bdd); sort per hop by (var, bdd)
    hop_nodes: List[List[Tuple[int, int, int]]] = [[] for _ in range(H)]
    # entries: (var, bdd, absolute old node index)
    for b in range(nb):
        s, _ = collection.node_range(b)
        vars_b = per_bdd_vars[b]
        for i_local, lvl in enumerate(per_bdd_levels[b]):
            hop_nodes[lvl].append((vars_b[lvl], b, s + i_local))
    for h in range(H):
        hop_nodes[h].sort()

    # new node indices
    total_internal = sum(len(hn) for hn in hop_nodes)
    nr_nodes = total_internal + 2 * nb
    new_index = {}
    pos = 0
    for h in range(H):
        for (_, _, old) in hop_nodes[h]:
            new_index[old] = pos
            pos += 1
    top_node = np.empty(nb, dtype=np.int32)
    bot_node = np.empty(nb, dtype=np.int32)
    for b in range(nb):
        top_node[b] = pos
        bot_node[b] = pos + 1
        pos += 2
    assert pos == nr_nodes

    # layers
    layer_var_l: List[int] = []
    layer_bdd_l: List[int] = []
    cum_layers = np.zeros(H + 1, dtype=np.int64)
    layer_of: dict = {}
    for h in range(H):
        seen_key = None
        for (v, b, _) in hop_nodes[h]:
            if (v, b) != seen_key:
                layer_of[(b, h)] = len(layer_var_l)
                layer_var_l.append(v)
                layer_bdd_l.append(b)
                seen_key = (v, b)
        cum_layers[h] = len(layer_var_l)
    # terminal layers
    terminal_layer = {}
    for b in range(nb):
        terminal_layer[b] = len(layer_var_l)
        layer_var_l.append(nr_vars)
        layer_bdd_l.append(b)
    cum_layers[H] = len(layer_var_l)

    lo_node = np.full(nr_nodes, -1, dtype=np.int32)
    hi_node = np.full(nr_nodes, -1, dtype=np.int32)
    node_to_layer = np.empty(nr_nodes, dtype=np.int32)
    cum_nodes = np.zeros(H + 1, dtype=np.int64)
    pos = 0
    for h in range(H):
        for (v, b, old) in hop_nodes[h]:
            lo_old, hi_old = collection.lo[old], collection.hi[old]
            lo_node[pos] = (
                top_node[b]
                if lo_old == TOP
                else bot_node[b]
                if lo_old == BOT
                else new_index[lo_old]
            )
            hi_node[pos] = (
                top_node[b]
                if hi_old == TOP
                else bot_node[b]
                if hi_old == BOT
                else new_index[hi_old]
            )
            node_to_layer[pos] = layer_of[(b, h)]
            pos += 1
        cum_nodes[h] = pos
    for b in range(nb):
        node_to_layer[top_node[b]] = terminal_layer[b]
        node_to_layer[bot_node[b]] = terminal_layer[b]
    cum_nodes[H] = nr_nodes

    root_node = np.array(
        [new_index[collection.root(b)] for b in range(nb)], dtype=np.int32
    )

    layer_var = np.asarray(layer_var_l, dtype=np.int32)
    layer_bdd = np.asarray(layer_bdd_l, dtype=np.int32)
    num_bdds_per_var = np.zeros(nr_vars, dtype=np.int32)
    np.add.at(num_bdds_per_var, layer_var[layer_var < nr_vars], 1)

    return FlatBdds(
        nr_vars=nr_vars,
        nr_primal_vars=nr_primal_vars,
        nr_bdds=nb,
        nr_hops=H,
        lo_node=lo_node,
        hi_node=hi_node,
        node_to_layer=node_to_layer,
        cum_nodes_per_hop=cum_nodes,
        layer_var=layer_var,
        layer_bdd=layer_bdd,
        cum_layers_per_hop=cum_layers,
        root_node=root_node,
        top_node=top_node,
        bot_node=bot_node,
        num_bdds_per_var=num_bdds_per_var,
    )


def densify(flat: FlatBdds) -> DenseBdds:
    """FlatBdds → hop-padded DenseBdds with hop-local child indices."""
    H = flat.nr_hops
    # hop_node_range(h) for h < H covers internal nodes only; the terminal
    # block lives between cum_nodes_per_hop[H-1] and cum_nodes_per_hop[H].
    node_counts = [
        flat.hop_node_range(h)[1] - flat.hop_node_range(h)[0] for h in range(H)
    ]
    layer_counts = [
        flat.hop_layer_range(h)[1] - flat.hop_layer_range(h)[0] for h in range(H)
    ]
    W = max(node_counts)
    L = max(layer_counts)

    node_valid = np.zeros((H, W), dtype=bool)
    layer_local = np.full((H, W), L, dtype=np.int32)
    lo_kind = np.full((H, W), ARC_BOT, dtype=np.int8)
    lo_next = np.full((H, W), W, dtype=np.int32)
    hi_kind = np.full((H, W), ARC_BOT, dtype=np.int8)
    hi_next = np.full((H, W), W, dtype=np.int32)
    layer_valid = np.zeros((H, L), dtype=bool)
    layer_var = np.full((H, L), flat.nr_vars, dtype=np.int32)
    layer_bdd = np.full((H, L), -1, dtype=np.int32)
    flat_layer_index = np.full((H, L), -1, dtype=np.int32)

    top_set = set(int(t) for t in flat.top_node)
    bot_set = set(int(t) for t in flat.bot_node)

    # local position of absolute node index within its hop row
    local_of = np.zeros(flat.nr_nodes, dtype=np.int32)
    for h in range(H):
        s, e = flat.hop_node_range(h)
        local_of[s:e] = np.arange(e - s)

    for h in range(H):
        s, e = flat.hop_node_range(h)
        ls, le = flat.hop_layer_range(h)
        for li in range(ls, le):
            j = li - ls
            layer_valid[h, j] = True
            layer_var[h, j] = flat.layer_var[li]
            layer_bdd[h, j] = flat.layer_bdd[li]
            flat_layer_index[h, j] = li
        for i in range(s, e):
            w = i - s
            node_valid[h, w] = True
            layer_local[h, w] = flat.node_to_layer[i] - ls
            for (child_arr, kind_arr, next_arr) in (
                (flat.lo_node, lo_kind, lo_next),
                (flat.hi_node, hi_kind, hi_next),
            ):
                c = int(child_arr[i])
                if c in top_set:
                    kind_arr[h, w] = ARC_TOP
                elif c in bot_set:
                    kind_arr[h, w] = ARC_BOT
                else:
                    kind_arr[h, w] = ARC_INTERNAL
                    next_arr[h, w] = local_of[c]

    # roots: hop-0 slots per bdd
    root_slot_bdd = np.empty(flat.nr_bdds, dtype=np.int32)
    for b in range(flat.nr_bdds):
        root_slot_bdd[b] = local_of[flat.root_node[b]]

    return DenseBdds(
        nr_vars=flat.nr_vars,
        nr_primal_vars=flat.nr_primal_vars,
        nr_bdds=flat.nr_bdds,
        H=H,
        W=W,
        L=L,
        node_valid=node_valid,
        layer_local=layer_local,
        lo_kind=lo_kind,
        lo_next=lo_next,
        hi_kind=hi_kind,
        hi_next=hi_next,
        layer_valid=layer_valid,
        layer_var=layer_var,
        layer_bdd=layer_bdd,
        root_slot_bdd=root_slot_bdd,
        num_bdds_per_var=flat.num_bdds_per_var,
        flat_layer_index=flat_layer_index,
    )
