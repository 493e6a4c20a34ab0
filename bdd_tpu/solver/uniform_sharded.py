"""Multi-device sharding of the uniform bucketed backend.

BDDs are partitioned into contiguous blocks (balanced by node count, variable
locality preserved); every shard builds the SAME bucket structure (global
bucket keys) with its own BDD columns, padded to a common column count, so all
per-shard pytrees stack on a leading device axis and the whole iteration runs
under ``shard_map``. Cross-shard state is exactly one psum of the per-variable
delta pair per half-sweep (the N-way generalization of the reference's hybrid
CPU/GPU exchange, bdd_multi_parallel_mma_base.cu:268-455), wired through the
``delta_reduce`` hook of ``uniform.iteration``.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bdd_tpu.bdd.collection import BddCollection
from bdd_tpu.solver import uniform as uf
from bdd_tpu.solver.sharding import partition_bdds


def _pad_bucket(
    g: uf.BucketGeom, B: int, nr_vars: int, dtype, H: Optional[int] = None
) -> uf.BucketGeom:
    """Pad a bucket's column axis to B and (optionally) its row axis to H.
    Padded rows/columns are fully invalid, so sweeps pass through them; with
    a packed layout the padded root_mask stays False (no segment starts)."""
    H = int(H) if H is not None else int(g.node_valid.shape[0])
    dH = H - int(g.node_valid.shape[0])
    dB = B - g.B
    if dH == 0 and dB == 0:
        return g

    def pad3(x, fill):
        return jnp.pad(x, ((0, dH), (0, 0), (0, dB)), constant_values=fill)

    def pad2(x, fill):
        return jnp.pad(x, ((0, dH), (0, dB)), constant_values=fill)

    return uf.BucketGeom(
        node_valid=pad3(g.node_valid, False),
        lo_kind=pad3(g.lo_kind, uf.ARC_BOT),
        lo_slot=pad3(g.lo_slot, 0),
        hi_kind=pad3(g.hi_kind, uf.ARC_BOT),
        hi_slot=pad3(g.hi_slot, 0),
        layer_valid=pad2(g.layer_valid, False),
        layer_var=pad2(g.layer_var, nr_vars),
        alpha=pad2(g.alpha, 0.0),
        root_mask=None if g.root_mask is None else pad2(g.root_mask, False),
    )


def _empty_bucket(
    key: Tuple[int, int], B: int, nr_vars: int, dtype, packed: bool = False
) -> uf.BucketGeom:
    P_, H = key
    return uf.BucketGeom(
        node_valid=jnp.zeros((H, P_, B), dtype=bool),
        lo_kind=jnp.full((H, P_, B), uf.ARC_BOT, dtype=jnp.int32),
        lo_slot=jnp.zeros((H, P_, B), dtype=jnp.int32),
        hi_kind=jnp.full((H, P_, B), uf.ARC_BOT, dtype=jnp.int32),
        hi_slot=jnp.zeros((H, P_, B), dtype=jnp.int32),
        layer_valid=jnp.zeros((H, B), dtype=bool),
        layer_var=jnp.full((H, B), nr_vars, dtype=jnp.int32),
        alpha=jnp.zeros((H, B), dtype=dtype),
        root_mask=jnp.zeros((H, B), dtype=bool) if packed else None,
    )


def build_shard_geoms(
    collection: BddCollection,
    nr_vars: int,
    D: int,
    dtype=jnp.float32,
    pack: Optional[bool] = None,
    nr_primal_vars: Optional[int] = None,
    plan_family: str = "auto",
    partition: str = "auto",
):
    """Build the D per-shard uniform geometries (equal shapes across shards:
    global bucket keys, padded column counts, globally-shaped exchange plans).
    Returns (geoms, hosts, layer_bdd_padded, counts). Standalone so the
    multi-chip projection benchmark can measure per-shard compute on one real
    chip without constructing a mesh.

    ``partition``: 'block' = contiguous median-variable blocks; 'mincut' =
    block + KL-style refinement minimizing the shared-variable width;
    'auto' = refine only when the block partition's shared width is a
    significant fraction of the incidences AND refinement actually shrinks
    it >= 5% (quadratically-coupled families; grids keep their ideal
    contiguous windows)."""
    from bdd_tpu.solver.sharding import (
        partition_cost,
        refine_partition_mincut,
        shared_width,
    )

    parts = partition_bdds(collection, D)
    if partition not in ("block",) and D > 1:
        w_block = shared_width(collection, parts)
        total_inc = sum(
            len(collection.level_variables(b))
            for b in range(collection.nr_bdds())
        )
        want = partition == "mincut" or (
            partition == "auto" and w_block > 0.15 * max(total_inc, 1)
        )
        if want:
            refined = refine_partition_mincut(collection, parts)
            if partition == "mincut":
                parts = refined
            else:
                # auto: rank by the J model = sort volume +
                # padded layer slots (partition_cost) — shared width alone
                # mispicks when refinement's balance slack grows the max
                # shard (gm50k D=2)
                if partition_cost(collection, refined)[2] < partition_cost(
                    collection, parts
                )[2]:
                    parts = refined
    # global counts over all shards
    counts = np.zeros(nr_vars, dtype=np.int32)
    for b in range(collection.nr_bdds()):
        for v in collection.level_variables(b):
            counts[v] += 1

    hosts = [
        uf.flatten_uniform(
            collection,
            nr_vars,
            nr_primal_vars,
            dtype=dtype,
            counts_override=counts,
            keep_bdds=p,
            build_plan=False,
        )
        if len(p) > 0
        else None
        for p in parts
    ]
    # vertical column packing (f32 default, matching the single-device
    # policy): pool all shards' segment depths, choose ONE cap per
    # (width, tier) class, pack every shard with it, then pad rows to the
    # class-global H so the per-shard buckets stack on the device axis
    if pack is None:
        pack = dtype == jnp.float32
    packed = False
    if pack:
        pooled: dict = {}
        for h in hosts:
            if h is None:
                continue
            for k, g in enumerate(h.geom.buckets):
                deps = np.asarray(h.depths[k])
                pooled.setdefault(int(g.P), []).extend(
                    int(x) for x in deps[deps > 0]
                )
        if pooled:
            caps = uf.choose_pack_caps(
                {p: np.asarray(v) for p, v in pooled.items()}
            )
            hosts = [
                uf.pack_uniform_host(h, dtype=dtype, caps=caps)
                if h is not None
                else None
                for h in hosts
            ]
            packed = True

    # global bucket key set: (P, H) unpacked (H is a per-BDD-class
    # property, equal across shards); (P, depth tier) packed (each
    # shard's FFD may stop below the cap -> rows padded to the class max)
    def key_of(g):
        H = int(g.node_valid.shape[0])
        if packed:
            return (int(g.P), -1 - int(H > uf.PACK_H_CAP))
        return (int(g.P), H)

    def keys_of(h):
        return [key_of(g) for g in h.geom.buckets] if h else []

    all_keys = sorted({k for h in hosts for k in keys_of(h)})
    H_per_key: dict = {}
    B_per_key: dict = {}
    for h in hosts:
        for g in h.geom.buckets if h else ():
            k = key_of(g)
            H_per_key[k] = max(
                H_per_key.get(k, 0), int(g.node_valid.shape[0])
            )
            B_per_key[k] = max(B_per_key.get(k, 0), g.B)
    geoms = []
    layer_bdd_padded: list = []  # per shard: per bucket [H_key, B_key]
    for h in hosts:
        bl = []
        lbd = []
        hk = keys_of(h)
        for k in all_keys:
            if h and k in hk:
                idx = hk.index(k)
                bl.append(
                    _pad_bucket(
                        h.geom.buckets[idx],
                        B_per_key[k],
                        nr_vars,
                        dtype,
                        H=H_per_key[k],
                    )
                )
                src = np.asarray(h.layer_bdd[idx])
                pad = np.full(
                    (H_per_key[k], B_per_key[k]), -1, dtype=np.int64
                )
                pad[: src.shape[0], : src.shape[1]] = src
                lbd.append(pad)
            else:
                bl.append(
                    _empty_bucket(
                        (k[0], H_per_key[k]),
                        B_per_key[k],
                        nr_vars,
                        dtype,
                        packed=packed,
                    )
                )
                lbd.append(np.full(
                    (H_per_key[k], B_per_key[k]), -1, dtype=np.int64
                ))
        layer_bdd_padded.append(lbd)
        geoms.append(
            uf.UniformGeom(
                buckets=tuple(bl),
                num_bdds_per_var=jnp.asarray(counts, dtype=jnp.int32),
            )
        )
    # per-shard static-permutation exchange plans with GLOBAL shapes
    # (same bucket keys + padded column counts on every shard -> equal E;
    # C cap + class layout from the global counts so key arrays stack on
    # the device axis)
    if dtype == jnp.float32:
        shard_ids, shard_valid = [], []
        for geom in geoms:
            ids = np.concatenate(
                [np.asarray(g.layer_var).ravel() for g in geom.buckets]
            )
            val = np.concatenate(
                [np.asarray(g.layer_valid).ravel() for g in geom.buckets]
            )
            shard_ids.append(ids)
            shard_valid.append(val)
        # SHARED class layout from the per-shard MAXIMUM local counts: the
        # psum only needs every shard to emit per-variable totals in the
        # same [2, Vp + sum(nv)] order, so the class layout (C cap, heavy
        # membership, W widths) must be identical across shards but does
        # NOT need to accommodate the summed global counts — only the
        # largest local count of each variable. With balanced partitions
        # max-local ~ global/D, so the [C, Vx] matrix (and with it the
        # per-shard sort volume N = max(E_shard, C*Vx)) shrinks ~D-fold
        # instead of staying global-sized — the sorts are the dominant
        # per-iteration cost, so this is what makes iterations/s actually
        # scale with the mesh. (An earlier revision summed the counts,
        # which kept N at the single-chip size on every shard; and the
        # original force_C=global-cmax plan's skew guard silently dropped
        # GM/QAP-like instances back to the segment exchange.) All shards
        # feed the same (E, layout_counts) into the plan builder, so they
        # deterministically pick the same C/classes and the key arrays
        # stack on the device axis.
        m_counts = np.zeros(nr_vars, dtype=np.int64)
        for i, v in zip(shard_ids, shard_valid):
            rv = i[v]
            if rv.size:
                m_counts = np.maximum(
                    m_counts, np.bincount(rv, minlength=nr_vars)
                )
        # candidate per-shard plan families, picked by the dominant
        # cost (sort volume N; ties to the smaller collective payload):
        #   split    — private + shared regions, psum only over variables
        #              touched by >= 2 shards (GM/QAP random couplings,
        #              and it beats windowed on grids too: N ~ E/D and the
        #              payload drops to the partition boundaries)
        #   windowed — contiguous variable windows + stretcher region
        #   global   — globally-sized columns (always available)
        # then the segment exchange as the last resort.
        cands = []
        if plan_family in ("auto", "windowed"):
            w = uf.build_windowed_plans(shard_ids, shard_valid, nr_vars)
            if w is not None:
                cands.append((w[0].key_fwd.shape[0], 1, w))
        if plan_family in ("auto", "split"):
            sp = uf.build_split_plans(shard_ids, shard_valid, nr_vars)
            if sp is not None:
                cands.append((sp[0].key_fwd.shape[0], 0, sp))
        if cands:
            plans = min(cands)[2]
        else:
            plans = [
                uf.build_exchange_plan(i, v, nr_vars, global_counts=m_counts)
                for i, v in zip(shard_ids, shard_valid)
            ]
        if all(p is not None for p in plans):
            assert len({(p.C, p.Vp, p.Vx, p.classes) for p in plans}) == 1
            geoms = [
                g._replace(exchange=p) for g, p in zip(geoms, plans)
            ]
    return geoms, hosts, layer_bdd_padded, counts


class ShardedUniformSolver:
    """Duck-interface sharded solver over a 1-D device mesh."""

    default_block_size = 25

    def __init__(
        self,
        collection: BddCollection,
        nr_vars: int,
        objective,
        mesh: Optional[Mesh] = None,
        nr_primal_vars: Optional[int] = None,
        dtype=jnp.float32,
        omega: float = 0.5,
        pack: Optional[bool] = None,
        plan_family: str = "auto",
        partition: str = "auto",
    ) -> None:
        if mesh is None:
            mesh = Mesh(np.array(jax.devices()), ("b",))
        assert len(mesh.axis_names) == 1, "BDD-block sharding needs a 1-D mesh"
        self.mesh = mesh
        self._axis = mesh.axis_names[0]
        D = int(mesh.shape[self._axis])
        self.omega = omega
        self.dtype = dtype

        geoms, hosts, layer_bdd_padded, counts = build_shard_geoms(
            collection, nr_vars, D, dtype=dtype, pack=pack,
            nr_primal_vars=nr_primal_vars, plan_family=plan_family,
            partition=partition,
        )
        self._shard_hosts = hosts
        all_keys = list(range(len(geoms[0].buckets)))
        self.geom_stacked = jax.tree.map(lambda *xs: jnp.stack(xs, 0), *geoms)
        # per-bucket GLOBAL-view layer_bdd: shard columns concatenated
        self._view_layer_bdd = tuple(
            np.concatenate([lbd[k] for lbd in layer_bdd_padded], axis=-1)
        for k in range(len(all_keys)))
        self._nr_bdds_global = collection.nr_bdds()
        self.nr_vars = nr_vars
        self.host = uf.UniformHost(
            geom=geoms[0],  # representative (for shapes only)
            bdd_of_col=tuple(),
            depths=tuple(),
            nr_vars=nr_vars,
            nr_primal_vars=nr_primal_vars or nr_vars,
            nr_bdds=collection.nr_bdds(),
        )

        # initial state per shard
        obj = np.asarray(objective, dtype=np.float64)
        states = []
        for geom in geoms:
            host = uf.UniformHost(
                geom=geom,
                bdd_of_col=tuple(),
                depths=tuple(),
                nr_vars=nr_vars,
                nr_primal_vars=nr_primal_vars or nr_vars,
                nr_bdds=0,
            )
            states.append(uf.init_uniform_state(host, obj, dtype=dtype))
        self.state_stacked = jax.tree.map(lambda *xs: jnp.stack(xs, 0), *states)

        sharding = NamedSharding(mesh, P(self._axis))
        put = lambda x: jax.device_put(x, sharding)
        self.geom_stacked = jax.tree.map(put, self.geom_stacked)
        self.state_stacked = jax.tree.map(put, self.state_stacked)
        self._make_fns()

        # layer view for rounding (concatenated over shards and buckets)
        class _View:
            pass

        lv, lval = [], []
        for geom in geoms:
            for g in geom.buckets:
                lv.append(np.asarray(g.layer_var).ravel())
                lval.append(np.asarray(g.layer_valid).ravel())
        view = _View()
        view.nr_vars = nr_vars
        view.nr_primal_vars = nr_primal_vars or nr_vars
        view.layer_var = np.concatenate(lv)
        view._valid = np.concatenate(lval)
        view.valid_layer_mask = lambda: view._valid
        view.num_bdds_per_var = counts
        self.f = view

    # ------------------------------------------------------------------- fns
    def _make_fns(self) -> None:
        mesh = self.mesh
        axis = self._axis

        def psum2(dsum):
            return jax.lax.psum(dsum, axis)

        @functools.partial(jax.jit, static_argnames=("n",))
        def run(geom_s, state_s, omega, n: int):
            @functools.partial(
                jax.shard_map,
                mesh=mesh,
                in_specs=(P(axis), P(axis), P()),
                out_specs=P(axis),
                check_vma=False,
            )
            def fn(geom_blk, state_blk, om):
                geom = jax.tree.map(lambda x: x[0], geom_blk)
                state = jax.tree.map(lambda x: x[0], state_blk)

                def body(s, _):
                    return uf.iteration(geom, s, om, delta_reduce=psum2), ()

                state, _ = jax.lax.scan(body, state, None, length=n)
                return jax.tree.map(lambda x: x[None], state)

            return fn(geom_s, state_s, omega)

        @jax.jit
        def lb(geom_s, state_s):
            @functools.partial(
                jax.shard_map,
                mesh=mesh,
                in_specs=(P(axis), P(axis)),
                out_specs=P(),
                check_vma=False,
            )
            def fn(geom_blk, state_blk):
                geom = jax.tree.map(lambda x: x[0], geom_blk)
                state = jax.tree.map(lambda x: x[0], state_blk)
                s = uf.distribute_delta(geom, state, delta_reduce=psum2)
                return jax.lax.psum(uf.lower_bound_from_cft(geom, s.cft), axis)

            return fn(geom_s, state_s)

        @jax.jit
        def dist(geom_s, state_s):
            @functools.partial(
                jax.shard_map,
                mesh=mesh,
                in_specs=(P(axis), P(axis)),
                out_specs=P(axis),
                check_vma=False,
            )
            def fn(geom_blk, state_blk):
                geom = jax.tree.map(lambda x: x[0], geom_blk)
                state = jax.tree.map(lambda x: x[0], state_blk)
                s = uf.distribute_delta(geom, state, delta_reduce=psum2)
                return jax.tree.map(lambda x: x[None], s)

            return fn(geom_s, state_s)

        @jax.jit
        def upd(geom_s, state_s, lo_u, hi_u):
            def per_shard(geom, state):
                lo_l, hi_l, cft_l = [], [], []
                for g, lo, hi in zip(geom.buckets, state.lo, state.hi):
                    nl = jnp.where(g.layer_valid, lo + g.alpha * lo_u[g.layer_var], 0.0)
                    nh = jnp.where(g.layer_valid, hi + g.alpha * hi_u[g.layer_var], 0.0)
                    lo_l.append(nl)
                    hi_l.append(nh)
                    cft_l.append(uf.bucket_backward_run(g, nl, nh))
                return uf.UniformState(
                    tuple(lo_l), tuple(hi_l), state.def_mm, tuple(cft_l)
                )

            return jax.vmap(per_shard)(geom_s, state_s)

        @functools.partial(jax.jit, static_argnames=("n",))
        def learned_run(geom_s, state_s, alphas_s, omegas_s, n: int):
            """n learned-MMA iterations over the mesh: per-layer (alpha,
            omega) sharded like the state, consensus via the same psum —
            multi-chip DOGE, beyond the reference's single-GPU training."""
            from bdd_tpu.solver import learned as ln

            @functools.partial(
                jax.shard_map,
                mesh=mesh,
                in_specs=(P(axis), P(axis), P(axis), P(axis)),
                out_specs=P(axis),
                check_vma=False,
            )
            def fn(geom_blk, state_blk, al_blk, om_blk):
                geom = jax.tree.map(lambda x: x[0], geom_blk)
                state = jax.tree.map(lambda x: x[0], state_blk)
                al = jax.tree.map(lambda x: x[0], al_blk)
                om = jax.tree.map(lambda x: x[0], om_blk)
                state = ln.learned_iterations(
                    geom, state, al, om, n, delta_reduce=psum2
                )
                return jax.tree.map(lambda x: x[None], state)

            return fn(geom_s, state_s, alphas_s, omegas_s)

        @jax.jit
        def learned_lb(geom_s, state_s, alphas_s):
            """Global bound after distributing the deferred deltas with the
            LEARNED alphas (the single-host dual_loss semantics,
            learned.distribute_delta_learned) — not the isotropic weights."""
            from bdd_tpu.solver import learned as ln

            @functools.partial(
                jax.shard_map,
                mesh=mesh,
                in_specs=(P(axis), P(axis), P(axis)),
                out_specs=P(),
                check_vma=False,
            )
            def fn(geom_blk, state_blk, al_blk):
                geom = jax.tree.map(lambda x: x[0], geom_blk)
                state = jax.tree.map(lambda x: x[0], state_blk)
                al = jax.tree.map(lambda x: x[0], al_blk)
                s = ln.distribute_delta_learned(
                    geom, state, al, delta_reduce=psum2
                )
                return jax.lax.psum(
                    uf.lower_bound_from_cft(geom, s.cft), axis
                )

            return fn(geom_s, state_s, alphas_s)

        # jitted per-(shard, bucket) min marginals in the layer-view order
        @jax.jit
        def mms(geom_s, state_s):
            def per_shard(geom, state):
                return uf.min_marginals_all(geom, state)

            return jax.vmap(per_shard)(geom_s, state_s)

        # ---- L-BFGS primitives over the mesh (ref lbfgs.h:22-27 contract)
        @jax.jit
        def netc(geom_s, state_s):
            @functools.partial(
                jax.shard_map,
                mesh=mesh,
                in_specs=(P(axis), P(axis)),
                out_specs=P(axis),
                check_vma=False,
            )
            def fn(geom_blk, state_blk):
                geom = jax.tree.map(lambda x: x[0], geom_blk)
                state = jax.tree.map(lambda x: x[0], state_blk)
                xs = uf.net_solver_costs(geom, state, delta_reduce=psum2)
                return jax.tree.map(lambda x: x[None], xs)

            return fn(geom_s, state_s)

        @jax.jit
        def feas(geom_s, gs_s):
            @functools.partial(
                jax.shard_map,
                mesh=mesh,
                in_specs=(P(axis), P(axis)),
                out_specs=P(axis),
                check_vma=False,
            )
            def fn(geom_blk, gs_blk):
                geom = jax.tree.map(lambda x: x[0], geom_blk)
                gs = jax.tree.map(lambda x: x[0], gs_blk)
                out = uf.make_dual_feasible(
                    geom, gs, sum_reduce=lambda s: jax.lax.psum(s, axis)
                )
                return jax.tree.map(lambda x: x[None], out)

            return fn(geom_s, gs_s)

        @jax.jit
        def sols(geom_s, state_s):
            return jax.vmap(uf.bdds_solution)(geom_s, state_s)

        @jax.jit
        def gstep(geom_s, state_s, gs_s, step):
            return jax.vmap(
                uf.gradient_step, in_axes=(0, 0, 0, None)
            )(geom_s, state_s, gs_s, step)

        self._run = run
        self._lb = lb
        self._dist = dist
        self._upd = upd
        self._learned_run = learned_run
        self._netc = netc
        self._feas = feas
        self._sols = sols
        self._gstep = gstep
        self._learned_lb = learned_lb
        self._mms = mms

    # ------------------------------------------------------------- interface
    def iteration(self) -> None:
        self.state_stacked = self._run(
            self.geom_stacked, self.state_stacked, self.omega, 1
        )

    def iteration_block(self, n: int) -> None:
        self.state_stacked = self._run(
            self.geom_stacked, self.state_stacked, self.omega, n
        )

    # ------------------------------------------------------- learned (DOGE)
    @staticmethod
    def _concat_cols(x):
        """[D, ..., B] -> [..., D*B] (shard columns side by side)."""
        return jnp.concatenate([x[d] for d in range(x.shape[0])], axis=-1)

    def global_view(self):
        """A single-host ``UniformHost`` view of the sharded geometry: per
        bucket, every shard's columns concatenated along the column axis.
        Valid for all PER-COLUMN computations (min marginals, smooth
        solution, per-BDD lower bounds, features) — columns are independent;
        the exchange plan is deliberately absent. Cached."""
        if getattr(self, "_view_host", None) is not None:
            return self._view_host
        cc = self._concat_cols
        buckets = []
        for g in self.geom_stacked.buckets:
            buckets.append(uf.BucketGeom(
                node_valid=cc(g.node_valid),
                lo_kind=cc(g.lo_kind),
                lo_slot=cc(g.lo_slot),
                hi_kind=cc(g.hi_kind),
                hi_slot=cc(g.hi_slot),
                layer_valid=cc(g.layer_valid),
                layer_var=cc(g.layer_var),
                alpha=cc(g.alpha),
                root_mask=None if g.root_mask is None else cc(g.root_mask),
            ))
        geom = uf.UniformGeom(
            buckets=tuple(buckets),
            num_bdds_per_var=self.geom_stacked.num_bdds_per_var[0],
        )
        self._view_host = uf.UniformHost(
            geom=geom,
            bdd_of_col=tuple(),
            depths=tuple(),
            nr_vars=self.nr_vars,
            nr_primal_vars=self.host.nr_primal_vars,
            nr_bdds=self._nr_bdds_global,
            layer_bdd=self._view_layer_bdd,
        )
        return self._view_host

    def view_state(self, state=None) -> uf.UniformState:
        """A sharded state (default: the current one) in the global-view
        layout (see ``global_view``)."""
        cc = self._concat_cols
        s = state if state is not None else self.state_stacked
        return uf.UniformState(
            lo=tuple(cc(x) for x in s.lo),
            hi=tuple(cc(x) for x in s.hi),
            def_mm=tuple(cc(x) for x in s.def_mm),
            cft=tuple(cc(x) for x in s.cft),
        )

    def stack_layers(self, per_bucket):
        """Inverse of the view layout for per-layer [H, D*B] arrays: split
        each bucket's columns back into shard blocks -> stacked [D, H, B]."""
        D = self.mesh.devices.size
        out = []
        for x in per_bucket:
            out.append(jnp.stack(jnp.split(x, D, axis=-1), axis=0))
        return tuple(out)

    def isotropic_alphas(self):
        """Stacked per-bucket [D, H, B] isotropic distribution weights (the
        non-learned default) — the template shape for learned parameters."""
        return tuple(g.alpha for g in self.geom_stacked.buckets)

    def omega_from_per_var(self, omega_vec):
        """Broadcast a per-variable [V+1] vector to stacked per-layer omegas
        (differentiable: gradients sum over a variable's layers)."""
        return tuple(
            jnp.where(g.layer_valid, omega_vec[g.layer_var], 0.0)
            for g in self.geom_stacked.buckets
        )

    def learned_iteration_block(self, alphas, omegas, n: int) -> None:
        """n learned-MMA iterations with per-layer (alpha, omega) in the
        stacked [D, H, B] layout (see isotropic_alphas / omega_from_per_var);
        differentiable through the mesh (jax.grad over the psum consensus)."""
        self.state_stacked = self._learned_run(
            self.geom_stacked, self.state_stacked, alphas, omegas, n
        )

    def lower_bound(self) -> float:
        return float(self._lb(self.geom_stacked, self.state_stacked))

    def lower_bound_with_deferred(self) -> float:
        return self.lower_bound()

    # ------------------------------------------- rounding support (host-side)
    def distribute_delta(self) -> None:
        self.state_stacked = self._dist(self.geom_stacked, self.state_stacked)

    def min_marginals(self):
        """Concatenated per-(shard, bucket) [H*B] min marginals matching the
        layer view built in __init__ (one jitted vmapped program; the eager
        per-(shard, bucket) loop was a rounding-loop hotspot)."""
        res = self._mms(self.geom_stacked, self.state_stacked)
        D = self.mesh.devices.size
        m0_l, m1_l = [], []
        for d in range(D):
            for m0, m1 in res:
                m0_l.append(np.asarray(m0[d]).ravel())
                m1_l.append(np.asarray(m1[d]).ravel())
        return np.concatenate(m0_l), np.concatenate(m1_l)

    def update_costs(self, lo_per_var, hi_per_var) -> None:
        import numpy as np

        lo_u = jnp.asarray(
            np.append(np.asarray(lo_per_var, np.float64), 0.0), dtype=self.dtype
        )
        hi_u = jnp.asarray(
            np.append(np.asarray(hi_per_var, np.float64), 0.0), dtype=self.dtype
        )
        self.state_stacked = self._upd(
            self.geom_stacked, self.state_stacked, lo_u, hi_u
        )
