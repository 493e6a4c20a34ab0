"""Multi-chip / multi-host sharded MMA.

Design (SURVEY.md §5/§7): BDDs are partitioned into contiguous blocks balanced
by node count — each BDD lives wholly on one shard, preserving the variable
locality of the BFS/Cuthill ordering so most primal variables touch few shards.
Per-variable deferred deltas are the ONLY cross-shard state: after each
half-sweep every device computes its local segment-sum delta and a single
``lax.psum`` over the mesh axis reconciles them, followed by the isotropic
division by the *global* per-variable BDD count. This generalizes the
reference's 2-participant hybrid CPU/GPU delta exchange
(bdd_multi_parallel_mma_base.cu:268-455, normalization :423-433) to an N-way
all-reduce riding ICI/DCN. Min-marginal averaging is associative-sum-based, so
the collective is a plain sum — no ordering hazards; results are bitwise
deterministic.

Implementation: every shard's DenseBdds is padded to the common (H, W, L);
geometry and state are stacked on a leading device axis and the whole
iteration runs under ``shard_map`` over a 1-D mesh.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bdd_tpu.bdd.collection import BddCollection
from bdd_tpu.solver import jax_solver as js
from bdd_tpu.solver.flatten import DenseBdds, FlatBdds, densify, flatten_collection


def partition_bdds(collection: BddCollection, nr_shards: int) -> List[List[int]]:
    """Partition of BDD numbers balanced by node count, contiguous in the
    MEDIAN-VARIABLE order. Collection order follows constraint order, which
    need not track the variable ordering (e.g. grid MRFs list all unary
    simplexes first) — splitting in variable order gives every shard a tight
    variable window (~V/D with a BFS/Cuthill ordering), which the windowed
    exchange plans exploit to keep per-shard sort volume ~E/D. The MEDIAN
    (not minimum) is the robust centroid: on GM/QAP-like instances a
    marginalization/product constraint touches one early assignment variable
    plus a dense block of late product variables — min-var order interleaves
    those BDDs by the assignment id and destroys locality, while median-var
    order clusters them by their product block (the assignment variables
    become the two-region plans' shared stretcher set). For chain/grid BDDs
    with contiguous levels both keys give the same order."""
    nb = collection.nr_bdds()
    sizes = [collection.nr_bdd_nodes(b) for b in range(nb)]

    def median_var(b: int) -> int:
        vs = sorted(collection.level_variables(b))
        return vs[len(vs) // 2]

    order = sorted(range(nb), key=lambda b: (median_var(b), b))
    total = sum(sizes)
    target = total / nr_shards
    parts: List[List[int]] = []
    cur: List[int] = []
    acc = 0.0
    for b in order:
        cur.append(b)
        acc += sizes[b]
        # leave enough bdds so every remaining shard gets at least one
        if (
            acc >= target
            and len(parts) < nr_shards - 1
            and (nb - len(cur) - sum(len(p) for p in parts))
            >= (nr_shards - len(parts) - 1)
        ):
            parts.append(sorted(cur))
            cur = []
            acc = 0.0
    parts.append(sorted(cur))
    while len(parts) < nr_shards:  # degenerate: fewer bdds than shards
        parts.append([])
    assert sum(len(p) for p in parts) == nb
    return parts


def shared_width(
    collection: BddCollection, parts: List[List[int]]
) -> int:
    """Cost of a partition under the split exchange plans: the shared-region
    width sum_{v shared} max_s cnt[v, s] — each shard's sort must carry one
    column per shared variable's max-over-shards BDD count. Private
    variables cost nothing extra."""
    D = len(parts)
    V = 0
    vars_of = []
    for b in range(collection.nr_bdds()):
        vs = np.asarray(sorted(collection.level_variables(b)), dtype=np.int64)
        vars_of.append(vs)
        if len(vs):
            V = max(V, int(vs[-1]) + 1)
    cnt = np.zeros((V, D), dtype=np.int32)
    for s, p in enumerate(parts):
        for b in p:
            cnt[vars_of[b], s] += 1
    nnz = (cnt > 0).sum(axis=1)
    return int(cnt.max(axis=1)[nnz >= 2].sum())


def partition_cost(
    collection: BddCollection, parts: List[List[int]]
) -> tuple:
    """(N_est, E_est, J) host-side cost proxy of a partition under the split
    exchange plans. N_est = max-shard private column count + shared width
    (the per-shard sort volume); E_est = max-shard layer count (the bucket
    slots every shard pads to). J = N_est + E_est weights both alike (not
    yet re-derived on the H100) and ranks partitions without building
    geometries."""
    D = len(parts)
    V = 0
    vars_of = []
    layers = np.zeros(collection.nr_bdds(), dtype=np.int64)
    for b in range(collection.nr_bdds()):
        vs = np.asarray(sorted(collection.level_variables(b)), dtype=np.int64)
        vars_of.append(vs)
        layers[b] = len(vs)
        if len(vs):
            V = max(V, int(vs[-1]) + 1)
    cnt = np.zeros((V, D), dtype=np.int32)
    for s, p in enumerate(parts):
        for b in p:
            cnt[vars_of[b], s] += 1
    shared = (cnt > 0).sum(axis=1) >= 2
    w_shared = int(cnt.max(axis=1)[shared].sum())
    priv = np.where(shared[:, None], 0, cnt).sum(axis=0)  # per-shard
    priv_max = int(priv.max()) if D else 0
    e_max = max(
        (int(layers[list(p)].sum()) if len(p) else 0) for p in parts
    )
    n_est = priv_max + w_shared
    return n_est, e_max, n_est + e_max


def refine_partition_mincut(
    collection: BddCollection,
    parts: List[List[int]],
    balance: float = 0.05,
    max_passes: int = 8,
) -> List[List[int]]:
    """KL-style greedy refinement of a BDD partition minimizing the
    shared-variable width (see ``shared_width``) under a node-count balance
    constraint (no shard above (1+balance) x average).

    The block partition (``partition_bdds``) is locality-aware only through
    the variable ORDER; on quadratically-coupled families (QAP, GM) many
    BDDs straddle any contiguous split. This pass moves boundary BDDs to
    the shard where most of their variables already live, deterministically
    (fixed scan order, strict-improvement moves), until a pass makes no
    move. Cost per pass is O(sum_b |vars(b)| * touched shards) in vectorized
    numpy. (SURVEY §7 'multi-host BDD partitioning'; the reference's
    two-way CPU/GPU split, bdd_multi_parallel_mma_base.cu:268-455, has no
    partitioner to port — it splits by a fixed hop threshold.)"""
    nb = collection.nr_bdds()
    D = len(parts)
    if D <= 1 or nb == 0:
        return parts
    vars_of = [
        np.asarray(sorted(collection.level_variables(b)), dtype=np.int64)
        for b in range(nb)
    ]
    sizes = np.asarray(
        [collection.nr_bdd_nodes(b) for b in range(nb)], dtype=np.float64
    )
    V = max((int(v[-1]) for v in vars_of if len(v)), default=-1) + 1
    cnt = np.zeros((V, D), dtype=np.int32)
    shard_of = np.empty(nb, dtype=np.int32)
    for s, p in enumerate(parts):
        for b in p:
            shard_of[b] = s
            cnt[vars_of[b], s] += 1
    shard_nodes = np.zeros(D)
    shard_len = np.zeros(D, dtype=np.int64)
    for s, p in enumerate(parts):
        shard_nodes[s] = sizes[list(p)].sum() if len(p) else 0.0
        shard_len[s] = len(p)
    hi = (1.0 + balance) * sizes.sum() / D

    def contribs(rows: np.ndarray) -> np.ndarray:
        # per-variable shared-width contribution of a [k, D] count block
        return np.where((rows > 0).sum(axis=1) >= 2, rows.max(axis=1), 0)

    # scan order: BDDs with many variables first (largest potential gain)
    order = sorted(range(nb), key=lambda b: (-len(vars_of[b]), b))
    for _ in range(max_passes):
        moved = 0
        for b in order:
            vb = vars_of[b]
            if len(vb) == 0:
                continue
            s = int(shard_of[b])
            if shard_len[s] <= 1:
                continue  # never empty a shard
            rows = cnt[vb]
            base = contribs(rows)
            if int(base.sum()) == 0:
                continue  # fully private: no move can help
            cand = np.nonzero(rows.sum(axis=0) > 0)[0]
            best_gain, best_t = 0, -1
            for t in cand:
                t = int(t)
                if t == s or shard_nodes[t] + sizes[b] > hi:
                    continue
                rows2 = rows.copy()
                rows2[:, s] -= 1
                rows2[:, t] += 1
                gain = int(base.sum() - contribs(rows2).sum())
                if gain > best_gain or (
                    gain == best_gain and best_t >= 0 and t < best_t
                ):
                    best_gain, best_t = gain, t
            if best_t >= 0 and best_gain > 0:
                cnt[vb, s] -= 1
                cnt[vb, best_t] += 1
                shard_nodes[s] -= sizes[b]
                shard_nodes[best_t] += sizes[b]
                shard_len[s] -= 1
                shard_len[best_t] += 1
                shard_of[b] = best_t
                moved += 1
        if moved == 0:
            break
    return [
        sorted(int(b) for b in np.nonzero(shard_of == s)[0])
        for s in range(D)
    ]


def _subcollection(collection: BddCollection, bdd_nrs: List[int]) -> BddCollection:
    out = BddCollection()
    for b in bdd_nrs:
        out.add_bdd(collection.local_nodes(b))
    return out


class ShardedBdds(NamedTuple):
    """Stacked per-shard geometry + bookkeeping (host side)."""

    geom: js.DenseGeom  # every leaf has leading shard axis [D, ...]
    flats: tuple  # per-shard FlatBdds (host)
    denses: tuple  # per-shard DenseBdds (host)
    parts: tuple  # per-shard bdd number lists (into the original collection)
    num_bdds_per_var_global: np.ndarray


def shard_collection(
    collection: BddCollection,
    nr_vars: int,
    nr_shards: int,
    nr_primal_vars: Optional[int] = None,
    dtype=jnp.float32,
) -> ShardedBdds:
    parts = partition_bdds(collection, nr_shards)
    flats: List[FlatBdds] = []
    denses: List[DenseBdds] = []
    dummy: List[bool] = []
    for p in parts:
        sub = _subcollection(collection, p)
        dummy.append(sub.nr_bdds() == 0)
        if sub.nr_bdds() == 0:
            # empty shard: one placeholder BDD whose layers are marked invalid
            # below — it neither receives nor emits delta mass and its lower
            # bound contribution is 0
            sub.add_bdd([(0, -1, -1)])
        flats.append(flatten_collection(sub, nr_vars, nr_primal_vars))
        denses.append(densify(flats[-1]))

    # global per-variable BDD counts (dummy BDDs excluded)
    counts = np.zeros(nr_vars, dtype=np.int32)
    for p, f in zip(parts, flats):
        if len(p) > 0:
            counts += f.num_bdds_per_var
    counts_safe = np.maximum(counts, 1)

    H = max(d.H for d in denses)
    W = max(d.W for d in denses)
    L = max(d.L for d in denses)

    geoms = []
    for f, d, is_dummy in zip(flats, denses, dummy):
        alpha = np.zeros((H, L))
        lvar = np.full((H, L), nr_vars, dtype=np.int32)
        lvalid = np.zeros((H, L), dtype=bool)
        if not is_dummy:
            lvar[: d.H, : d.L] = d.layer_var
            lvalid[: d.H, : d.L] = d.layer_valid
        m = lvalid
        alpha[m] = 1.0 / counts_safe[lvar[m]]
        nvalid = np.zeros((H, W), dtype=bool)
        nvalid[: d.H, : d.W] = d.node_valid
        llocal = np.full((H, W), L, dtype=np.int32)
        llocal[: d.H, : d.W] = np.where(d.layer_local == d.L, L, d.layer_local)
        lo_kind = np.full((H, W), 2, dtype=np.int32)  # ARC_BOT
        lo_next = np.full((H, W), W, dtype=np.int32)
        hi_kind = np.full((H, W), 2, dtype=np.int32)
        hi_next = np.full((H, W), W, dtype=np.int32)
        lo_kind[: d.H, : d.W] = d.lo_kind
        hi_kind[: d.H, : d.W] = d.hi_kind
        lo_next[: d.H, : d.W] = np.where(d.lo_next == d.W, W, d.lo_next)
        hi_next[: d.H, : d.W] = np.where(d.hi_next == d.W, W, d.hi_next)
        geoms.append(
            js.DenseGeom(
                node_valid=jnp.asarray(nvalid),
                layer_local=jnp.asarray(llocal),
                lo_kind=jnp.asarray(lo_kind),
                lo_next=jnp.asarray(lo_next),
                hi_kind=jnp.asarray(hi_kind),
                hi_next=jnp.asarray(hi_next),
                layer_valid=jnp.asarray(lvalid),
                layer_var=jnp.asarray(lvar, dtype=jnp.int32),
                alpha=jnp.asarray(alpha, dtype=dtype),
                num_bdds_per_var=jnp.asarray(counts, dtype=jnp.int32),
            )
        )
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *geoms)
    return ShardedBdds(
        geom=stacked,
        flats=tuple(flats),
        denses=tuple(denses),
        parts=tuple(tuple(p) for p in parts),
        num_bdds_per_var_global=counts,
    )


def init_sharded_state(
    sharded: ShardedBdds, objective, dtype=jnp.float32
) -> js.SolverState:
    """Stacked initial state [D, H, L]/[D, H, W]; objective split by global
    per-variable BDD counts."""
    obj = np.asarray(objective, dtype=np.float64)
    counts = np.maximum(sharded.num_bdds_per_var_global, 1)
    D = sharded.geom.node_valid.shape[0]
    H = sharded.geom.node_valid.shape[1]
    W = sharded.geom.node_valid.shape[2]
    L = sharded.geom.layer_valid.shape[2]
    lo = np.zeros((D, H, L))
    hi = np.zeros((D, H, L))
    lvar = np.asarray(sharded.geom.layer_var)
    lvalid = np.asarray(sharded.geom.layer_valid)
    hi[lvalid] = obj[lvar[lvalid]] / counts[lvar[lvalid]]
    state = js.SolverState(
        lo=jnp.asarray(lo, dtype=dtype),
        hi=jnp.asarray(hi, dtype=dtype),
        def_mm=jnp.zeros((D, H, L), dtype=dtype),
        cft=jnp.zeros((D, H, W), dtype=dtype),
    )
    cft = jax.jit(jax.vmap(js.backward_run))(sharded.geom, state.lo, state.hi)
    return state._replace(cft=cft)


# ------------------------------------------------------------------- kernels
def _unstack(tree):
    return jax.tree.map(lambda x: x[0], tree)


def _restack(tree):
    return jax.tree.map(lambda x: x[None], tree)


def make_sharded_iteration(mesh: Mesh, axis: str = "b"):
    """Build a jitted sharded iteration function over the given 1-D mesh.

    Cross-shard communication: one psum of the per-variable delta pair per
    half-sweep (2 collectives / iteration), everything else is local.
    """

    def one_iteration(geom, state, omega):
        dlo, dhi = js.compute_delta(geom, state.def_mm)
        dlo = jax.lax.psum(dlo, axis)
        dhi = jax.lax.psum(dhi, axis)
        state, cfr = js.forward_iteration(geom, state, omega, delta=(dlo, dhi))
        dlo, dhi = js.compute_delta(geom, state.def_mm)
        dlo = jax.lax.psum(dlo, axis)
        dhi = jax.lax.psum(dhi, axis)
        state = js.backward_iteration(geom, state, omega, cfr, delta=(dlo, dhi))
        return state

    @functools.partial(jax.jit, static_argnames=("n",))
    def run(geom_stacked, state_stacked, omega, n: int):
        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P()),
            out_specs=P(axis),
            check_vma=False,
        )
        def shard_fn(geom_blk, state_blk, om):
            geom = _unstack(geom_blk)
            state = _unstack(state_blk)

            def body(s, _):
                return one_iteration(geom, s, om), ()

            state, _ = jax.lax.scan(body, state, None, length=n)
            return _restack(state)

        return shard_fn(geom_stacked, state_stacked, omega)

    return run


def make_sharded_lower_bound(mesh: Mesh, axis: str = "b"):
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,
    )
    def shard_fn(geom_blk, state_blk):
        geom = _unstack(geom_blk)
        state = _unstack(state_blk)
        # distribute the (globally reduced) deferred delta, then local bound
        dlo, dhi = js.compute_delta(geom, state.def_mm)
        dlo = jax.lax.psum(dlo, axis)
        dhi = jax.lax.psum(dhi, axis)
        lo = state.lo + geom.alpha * dlo[geom.layer_var]
        hi = state.hi + geom.alpha * dhi[geom.layer_var]
        cft = js.backward_run(geom, lo, hi)
        lb = js.lower_bound_from_cft(geom, cft)
        return jax.lax.psum(lb, axis)

    return jax.jit(shard_fn)


class ShardedSolver:
    """Duck-interface solver over a device mesh (dp over BDD blocks)."""

    default_block_size = 10

    def __init__(
        self,
        collection: BddCollection,
        nr_vars: int,
        objective,
        mesh: Optional[Mesh] = None,
        nr_primal_vars: Optional[int] = None,
        dtype=jnp.float32,
        omega: float = 0.5,
    ) -> None:
        if mesh is None:
            mesh = Mesh(np.array(jax.devices()), ("b",))
        assert len(mesh.axis_names) == 1, "BDD-block sharding needs a 1-D mesh"
        self.mesh = mesh
        self._axis = mesh.axis_names[0]
        D = int(mesh.shape[self._axis])
        self.sharded = shard_collection(
            collection, nr_vars, D, nr_primal_vars, dtype=dtype
        )
        self.state = init_sharded_state(self.sharded, objective, dtype=dtype)
        sharding = NamedSharding(mesh, P(self._axis))
        self.geom = jax.tree.map(
            lambda x: jax.device_put(x, sharding), self.sharded.geom
        )
        self.state = jax.tree.map(
            lambda x: jax.device_put(x, sharding), self.state
        )
        self.omega = omega
        self._iter = make_sharded_iteration(mesh, self._axis)
        self._lb = make_sharded_lower_bound(mesh, self._axis)

    def iteration(self) -> None:
        self.state = self._iter(self.geom, self.state, self.omega, 1)

    def iteration_block(self, n: int) -> None:
        self.state = self._iter(self.geom, self.state, self.omega, n)

    def lower_bound(self) -> float:
        return float(self._lb(self.geom, self.state))

    def lower_bound_with_deferred(self) -> float:
        return self.lower_bound()
