"""Heterogeneous host+device concurrent MMA — the 2-way CPU+device consensus.

Analogue of the reference's hybrid CPU+GPU solver
(``/root/reference/src/bdd_solver/bdd_multi_parallel_mma_base.cu``:
``split_bdd_collection`` :15-128, ``forward_mm``/``backward_mm`` :321-356):
BDDs deeper than a hop threshold are solved by the native C++ OpenMP solver
on the host, the (many) short ones by the bucketed uniform device backend, and
the per-variable delta consensus is summed across the two solvers every
half-sweep. Because both sides use the GLOBAL per-variable BDD counts for
their averaging weights (alpha = 1/nbpv) and consume the combined delta,
the joint dual trajectory is exactly the monolithic solver's — the same
invariant the N-way sharded psum path (uniform_sharded) already verifies,
here with one heterogeneous "shard".

Mechanics: inside the jitted device program, an *ordered* ``io_callback`` per
half-sweep
  1. joins the previous CPU half-sweep worker (if still running),
  2. reads the CPU solver's partial delta (from its deferred-mm ledger),
  3. returns that contribution to the device program (which adds it to its
     own partial sums -> the combined global delta), and
  4. hands the combined delta to the CPU solver and launches its half-sweep
     on a worker thread — overlapped with the device sweep, mirroring the
     reference's ``std::async`` (bdd_multi_parallel_mma_base.cu:328-335).

Precision: the parity mode (tests) runs both sides in f64 through the
segment exchange and is bit-identical to the numpy oracle on the full
collection (on the CPU). With ``dtype=float32`` the device side runs f32
while the host side stays f64 — the consensus deltas are exchanged at f32,
exactly like the reference's REAL=float build.
"""
from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import io_callback

from bdd_tpu.bdd.collection import BddCollection
from bdd_tpu.solver import uniform as uf
from bdd_tpu.solver.uniform_wrapper import UniformLayerView


def split_bdds(
    collection: BddCollection,
    hop_threshold: Optional[int] = None,
    min_nodes_per_hop: int = 3072,
    device_threshold: int = 64,
) -> Tuple[List[int], List[int], int]:
    """Partition BDD numbers into (host_bdds, device_bdds, threshold).

    Reference rule (bdd_multi_parallel_mma_base.cu:15-128): build the
    nodes-per-hop histogram over all BDDs; the threshold is one past the
    deepest hop that still holds >= ``min_nodes_per_hop`` nodes (searched
    downward from the deepest hop, never below ``device_threshold``). BDDs
    deeper than the threshold go to the host solver — on the device those
    are the BDDs whose buckets degenerate to tall, narrow [H, P, B] tensors
    (huge H, tiny B) where the sweep is a long serial chain over few
    columns.
    """
    depths = []
    for b in range(collection.nr_bdds()):
        depths.append(len(collection.level_variables(b)))
    if not depths:
        return [], [], 0
    max_d = max(depths)
    if hop_threshold is None:
        per_hop = np.zeros(max_d, dtype=np.int64)
        for b in range(collection.nr_bdds()):
            levels = collection.node_levels(b)
            np.add.at(per_hop, np.asarray(levels, dtype=np.int64), 1)
        th = max_d - 1
        while th > device_threshold:
            if per_hop[th] >= min_nodes_per_hop:
                th += 1
                break
            th -= 1
        hop_threshold = max(th, device_threshold)
    host_bdds = [b for b, d in enumerate(depths) if d > hop_threshold]
    device_bdds = [b for b, d in enumerate(depths) if d <= hop_threshold]
    return host_bdds, device_bdds, hop_threshold


def _subset_flat(collection: BddCollection, keep: Sequence[int]):
    """Flat (var, lo, hi, delim) arrays of a BDD subset, arcs rebased to the
    packed node numbering (input format of native bh_load_collection)."""
    var = np.asarray(collection.var, dtype=np.int64)
    lo = np.asarray(collection.lo, dtype=np.int64)
    hi = np.asarray(collection.hi, dtype=np.int64)
    delim = np.asarray(collection.delim, dtype=np.int64)
    vs, ls, hs, dl = [], [], [], [0]
    base = 0
    for b in keep:
        s, e = int(delim[b]), int(delim[b + 1])
        shift = base - s
        vs.append(var[s:e])
        ls.append(np.where(lo[s:e] < 0, lo[s:e], lo[s:e] + shift))
        hs.append(np.where(hi[s:e] < 0, hi[s:e], hi[s:e] + shift))
        base += e - s
        dl.append(base)
    if not vs:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, np.zeros(1, dtype=np.int64)
    return (
        np.concatenate(vs),
        np.concatenate(ls),
        np.concatenate(hs),
        np.asarray(dl, dtype=np.int64),
    )


class _JointLayerView:
    """Layer view across both solvers: device-side layers (UniformLayerView
    order) followed by the host solver's bdd-major layers — the `.f` duck
    interface of the rounding/decoder machinery (rounding.MmDecoder)."""

    def __init__(self, dev_view, cpu_var, counts, nr_vars, nr_primal_vars):
        self.nr_vars = nr_vars
        self.nr_primal_vars = nr_primal_vars
        self.num_bdds_per_var = counts
        self.nr_device_layers = (
            dev_view.layer_var.size if dev_view is not None else 0
        )
        if dev_view is not None:
            self.layer_var = np.concatenate(
                [dev_view.layer_var, cpu_var.astype(dev_view.layer_var.dtype)]
            )
            self._valid = np.concatenate(
                [
                    dev_view.valid_layer_mask(),
                    np.ones(cpu_var.size, dtype=bool),
                ]
            )
        else:
            self.layer_var = cpu_var.astype(np.int64)
            self._valid = np.ones(cpu_var.size, dtype=bool)

    def valid_layer_mask(self) -> np.ndarray:
        return self._valid


class HybridSolver:
    """Duck-compatible with UniformSolver (run loop, outer loops, export)."""

    default_block_size = 25

    def __init__(
        self,
        collection: BddCollection,
        nr_vars: int,
        objective,
        nr_primal_vars: Optional[int] = None,
        dtype=jnp.float32,
        omega: float = 0.5,
        hop_threshold: Optional[int] = None,
        min_nodes_per_hop: int = 3072,
        force_host_bdds: Optional[Sequence[int]] = None,
        mode: str = "auto",
    ) -> None:
        """``mode``: 'callback' exchanges the delta through an ordered
        io_callback inside ONE jitted program per block (host sweep fully
        overlapped — the reference's std::async form); 'sync' splits each
        half-sweep into a partial-delta readout program + a sweep program
        taking the host contribution as an input (2 dispatches/half-sweep,
        still overlapped with the host sweep). 'auto' means 'callback'."""
        from bdd_tpu import native

        self.nr_vars = nr_vars
        self.omega = omega
        self.dtype = dtype
        self.collection = collection
        self.nr_primal_vars = (
            nr_primal_vars if nr_primal_vars is not None else nr_vars
        )
        if force_host_bdds is not None:
            hb = set(int(b) for b in force_host_bdds)
            host_bdds = sorted(hb)
            device_bdds = [
                b for b in range(collection.nr_bdds()) if b not in hb
            ]
            self.hop_threshold = -1
        else:
            host_bdds, device_bdds, self.hop_threshold = split_bdds(
                collection, hop_threshold, min_nodes_per_hop
            )
        self.host_bdds, self.device_bdds = host_bdds, device_bdds

        # global per-variable BDD counts — BOTH sides weight by these
        counts = np.zeros(nr_vars, dtype=np.int32)
        for b in range(collection.nr_bdds()):
            for v in collection.level_variables(b):
                counts[v] += 1
        self._counts_global = counts
        obj = np.asarray(objective, dtype=np.float64)

        # device side: uniform host over the short BDDs, global alpha
        self.host = None
        self.state = None
        if device_bdds:
            self.host = uf.flatten_uniform(
                collection,
                nr_vars,
                self.nr_primal_vars,
                dtype=dtype,
                counts_override=counts,
                keep_bdds=device_bdds,
            )
            self.geom = self.host.geom
            self.state = uf.init_uniform_state(self.host, obj, dtype=dtype)
            self.f = UniformLayerView(self.host)
            self._build_layout_maps()

        # host side: native OpenMP solver over the long BDDs, global nbpv
        self._cs = None
        if host_bdds:
            var, lo, hi, delim = _subset_flat(collection, host_bdds)
            self._cs = native.cpu_solver_from_flat(
                var, lo, hi, delim, nr_vars, obj, nbpv=counts
            )
        if mode == "auto":
            mode = "callback"
        self.mode = mode
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending = None
        if mode == "sync":
            self._make_fns_sync()
        else:
            self._make_fns()

        # joint layer view (device layers first, then host layers): the
        # indexing contract of min_marginals() — feeds MmDecoder / the
        # incremental rounding loop unchanged
        cpu_var = (
            self._cs.layer_info()[1]
            if self._cs is not None
            else np.zeros(0, dtype=np.int32)
        )
        tview = self.f if self.host is not None else None
        self.f = _JointLayerView(
            tview, cpu_var, counts, nr_vars, self.nr_primal_vars
        )

    # ------------------------------------------------------------- layouts
    def _build_layout_maps(self) -> None:
        """Row <-> global-variable maps of the delta vector handed to
        ``delta_reduce`` by uniform.exchange_delta. Segment path (f64 /
        no plan): [V+1, 2] in global id order. Permutation path: the concat
        of the primary region (row = variable id; heavy variables' unused
        primary rows and the padding rows masked out) and the class totals
        (row order = plan.class_members)."""
        V = self.nr_vars
        plan = self.geom.exchange
        perm = (
            uf.USE_PERM_EXCHANGE
            and plan is not None
            and uf._perm_exchange_ok(self.dtype)
        )
        if not perm:
            rows = np.full(V + 1, -1, dtype=np.int64)
            rows[:V] = np.arange(V)
        else:
            members = np.asarray(plan.class_members, dtype=np.int64)
            rows = np.full(plan.Vp + members.size, -1, dtype=np.int64)
            rows[:V] = np.arange(V)
            rows[members] = -1  # heavy: authoritative total is the class row
            rows[plan.Vp :] = members
        self._rows = rows
        self._rows_valid = rows >= 0

    def _layout_to_global(self, dsum: np.ndarray) -> np.ndarray:
        g = np.zeros((self.nr_vars, 2), dtype=np.float64)
        m = self._rows_valid
        g[self._rows[m]] = dsum[m]
        return g

    def _global_to_layout(self, g: np.ndarray, like: np.ndarray) -> np.ndarray:
        out = np.zeros_like(like)
        m = self._rows_valid
        out[m] = g[self._rows[m]].astype(like.dtype)
        return out

    # ------------------------------------------------------------ callbacks
    def _join(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _cpu_partial(self) -> np.ndarray:
        if self._cs is None:
            return np.zeros((self.nr_vars, 2), dtype=np.float64)
        return self._cs.partial_delta()

    def _host_exchange(self, dsum, omega, direction: int, sweep: bool):
        """The per-half-sweep consensus (ordered io_callback target).
        Returns the HOST side's contribution in the device layout; launches
        the host half-sweep on the combined delta when ``sweep``."""
        dsum = np.asarray(dsum)
        self._join()
        cpu_d = self._cpu_partial()
        comb = self._layout_to_global(dsum.astype(np.float64)) + cpu_d
        self._last_combined = comb
        if sweep and self._cs is not None:
            om = float(omega)
            self._pending = self._pool.submit(
                self._cs.half_iteration_ext, om, direction, comb
            )
        return self._global_to_layout(cpu_d, dsum)

    def _make_fns(self) -> None:
        if self.host is None:
            return
        shape = lambda d: jax.ShapeDtypeStruct(d.shape, d.dtype)  # noqa: E731

        def reduce_for(direction: int, sweep: bool):
            def reduce(dsum, *, _dir=direction, _sw=sweep):
                contrib = io_callback(
                    functools.partial(
                        self._host_exchange, direction=_dir, sweep=_sw
                    ),
                    shape(dsum),
                    dsum,
                    self._omega_trace,
                    ordered=True,
                )
                return dsum + contrib

            return reduce

        geom = self.geom

        def one_iteration(state, omega):
            # uf.iteration with distinct fwd/bwd consensus hooks (the hook
            # tells the host side which direction to sweep)
            self._omega_trace = omega
            din_lo, din_hi = uf.exchange_delta(
                geom, state.def_mm, reduce_for(+1, True)
            )
            new_lo, new_hi, new_mm, cfrs = [], [], [], []
            for g, lo, hi, cft, dl, dh in zip(
                geom.buckets, state.lo, state.hi, state.cft, din_lo, din_hi
            ):
                fwd, _ = uf._sweep_fns(g, lo.dtype)
                nl, nh, mm, cfr = fwd(g, lo, hi, cft, omega, dl, dh)
                new_lo.append(nl)
                new_hi.append(nh)
                new_mm.append(mm)
                cfrs.append(cfr)
            state = uf.UniformState(
                tuple(new_lo), tuple(new_hi), tuple(new_mm), state.cft
            )
            din_lo, din_hi = uf.exchange_delta(
                geom, state.def_mm, reduce_for(-1, True)
            )
            new_lo, new_hi, new_mm, cfts = [], [], [], []
            for g, lo, hi, cfr, dl, dh in zip(
                geom.buckets, state.lo, state.hi, cfrs, din_lo, din_hi
            ):
                _, bwd = uf._sweep_fns(g, lo.dtype)
                nl, nh, mm, cft = bwd(g, lo, hi, cfr, omega, dl, dh)
                new_lo.append(nl)
                new_hi.append(nh)
                new_mm.append(mm)
                cfts.append(cft)
            return uf.UniformState(
                tuple(new_lo), tuple(new_hi), tuple(new_mm), tuple(cfts)
            )

        @functools.partial(jax.jit, static_argnames=("n",))
        def run(state, omega, n: int):
            def body(s, _):
                return one_iteration(s, omega), ()

            s, _ = jax.lax.scan(body, state, None, length=n)
            return s

        @jax.jit
        def lb_deferred(state, omega):
            self._omega_trace = omega
            s = uf.distribute_delta(
                self.geom, state, delta_reduce=reduce_for(0, False)
            )
            return uf.lower_bound_from_cft(self.geom, s.cft)

        @jax.jit
        def dist(state, omega):
            self._omega_trace = omega
            return uf._distribute_delta_impl(
                self.geom, state, delta_reduce=reduce_for(0, False)
            )

        self._run = run
        self._lb_deferred = lb_deferred
        self._dist = dist
        self._upd_jit = jax.jit(uf.update_costs_per_var)

    def _make_fns_sync(self) -> None:
        """Host-synchronous consensus, for runtimes that do not service host
        callbacks: each half-sweep is two programs — a partial-delta readout (XLA dead-code-eliminates
        everything past the captured reduce point, so it costs one sort)
        and the sweep consuming the host contribution as a program INPUT.
        The host half-sweep still overlaps the device one: it is submitted
        before the device program's result is forced."""
        if self.host is None:
            return
        geom = self.geom

        @jax.jit
        def partials(state):
            cap = []

            def red(d):
                cap.append(d)
                return d

            uf.exchange_delta(geom, state.def_mm, red)
            return cap[0]

        @functools.partial(jax.jit, static_argnames=())
        def half_fwd(state, contrib, omega):
            din_lo, din_hi = uf.exchange_delta(
                geom, state.def_mm, lambda d: d + contrib
            )
            new_lo, new_hi, new_mm, cfrs = [], [], [], []
            for g, lo, hi, cft, dl, dh in zip(
                geom.buckets, state.lo, state.hi, state.cft, din_lo, din_hi
            ):
                fwd, _ = uf._sweep_fns(g, lo.dtype)
                nl, nh, mm, cfr = fwd(g, lo, hi, cft, omega, dl, dh)
                new_lo.append(nl)
                new_hi.append(nh)
                new_mm.append(mm)
                cfrs.append(cfr)
            return (
                uf.UniformState(
                    tuple(new_lo), tuple(new_hi), tuple(new_mm), state.cft
                ),
                tuple(cfrs),
            )

        @functools.partial(jax.jit, static_argnames=())
        def half_bwd(state, cfrs, contrib, omega):
            din_lo, din_hi = uf.exchange_delta(
                geom, state.def_mm, lambda d: d + contrib
            )
            new_lo, new_hi, new_mm, cfts = [], [], [], []
            for g, lo, hi, cfr, dl, dh in zip(
                geom.buckets, state.lo, state.hi, cfrs, din_lo, din_hi
            ):
                _, bwd = uf._sweep_fns(g, lo.dtype)
                nl, nh, mm, cft = bwd(g, lo, hi, cfr, omega, dl, dh)
                new_lo.append(nl)
                new_hi.append(nh)
                new_mm.append(mm)
                cfts.append(cft)
            return uf.UniformState(
                tuple(new_lo), tuple(new_hi), tuple(new_mm), tuple(cfts)
            )

        @jax.jit
        def lb_with_contrib(state, contrib):
            s = uf._distribute_delta_impl(
                geom, state, delta_reduce=lambda d: d + contrib
            )
            return uf.lower_bound_from_cft(geom, s.cft)

        @jax.jit
        def dist_with_contrib(state, contrib):
            return uf._distribute_delta_impl(
                geom, state, delta_reduce=lambda d: d + contrib
            )

        self._partials = partials
        self._half_fwd = half_fwd
        self._half_bwd = half_bwd
        self._lb_with_contrib = lb_with_contrib
        self._dist_with_contrib = dist_with_contrib
        self._upd_jit = jax.jit(uf.update_costs_per_var)

    def _sync_consensus(self, direction: int, sweep: bool = True):
        """Fetch the device partials, combine with the host partial delta,
        launch the host half-sweep, return the host contribution (device
        layout, state dtype)."""
        p = np.asarray(self._partials(self.state))
        self._join()
        cpu_d = self._cpu_partial()
        comb = self._layout_to_global(p.astype(np.float64)) + cpu_d
        self._last_combined = comb
        if sweep and self._cs is not None:
            self._pending = self._pool.submit(
                self._cs.half_iteration_ext, self.omega, direction, comb
            )
        return jnp.asarray(self._global_to_layout(cpu_d, p))

    # ------------------------------------------------------------------ dual
    def iteration(self) -> None:
        self.iteration_block(1)

    def iteration_block(self, n: int) -> None:
        if self.host is None:  # degenerate: everything on the host solver
            if self._cs is not None:
                self._cs.iterations(n, self.omega)
            return
        if self.mode == "sync":
            om = jnp.asarray(self.omega, self.dtype)
            for _ in range(n):
                c = self._sync_consensus(+1)
                self.state, cfrs = self._half_fwd(self.state, c, om)
                c = self._sync_consensus(-1)
                self.state = self._half_bwd(self.state, cfrs, c, om)
            np.asarray(self.state.lo[0]).ravel()[:1]
            self._join()
            return
        self.state = self._run(
            self.state, jnp.asarray(self.omega, self.dtype), n
        )
        # sync: the device program's callbacks (and the host worker) must
        # finish before python-side reads of the CPU solver state. A scalar
        # fetch (not block_until_ready) forces execution on lazy backends
        # (CLAUDE.md gotcha 2).
        np.asarray(self.state.lo[0]).ravel()[:1]
        self._join()

    def lower_bound(self) -> float:
        lb = 0.0
        if self._cs is not None:
            self._join()
            lb += self._cs.lower_bound()
        if self.host is not None:
            lb += float(uf.lower_bound(self.geom, self.state))
        return lb

    def lower_bound_with_deferred(self) -> float:
        """Bound after (virtually) distributing the COMBINED deferred delta
        on both sides — the reference's lower_bound_after_distribution."""
        if self.host is None:
            if self._cs is None:  # empty collection on both sides
                return 0.0
            return self._cs.lower_bound_with_deferred()
        self._join()
        if self.mode == "sync":
            c = self._sync_consensus(0, sweep=False)
            dev_lb = float(self._lb_with_contrib(self.state, c))
        else:
            dev_lb = float(
                self._lb_deferred(
                    self.state, jnp.asarray(self.omega, self.dtype)
                )
            )
        # the consensus stored the combined delta without sweeping
        if self._cs is not None:
            dev_lb += self._cs.lower_bound_deferred_ext(self._last_combined)
        return dev_lb

    # ------------------------------------------- rounding duck interface
    def distribute_delta(self) -> None:
        """Fold the COMBINED deferred delta into both sides' layer costs
        (monolithic distribute_delta semantics across the split)."""
        if self.host is None:
            self._cs.distribute_delta_ext(self._cs.partial_delta())
            return
        self._join()
        if self.mode == "sync":
            c = self._sync_consensus(0, sweep=False)
            self.state = self._dist_with_contrib(self.state, c)
        else:
            self.state = self._dist(
                self.state, jnp.asarray(self.omega, self.dtype)
            )
        np.asarray(self.state.lo[0]).ravel()[:1]  # force (lazy backends)
        if self._cs is not None:
            self._cs.distribute_delta_ext(self._last_combined)

    def min_marginals(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-layer (m0, m1) in _JointLayerView order (device layers,
        then host layers); +inf at invalid device slots."""
        parts0, parts1 = [], []
        if self.host is not None:
            mm = uf.min_marginals_all(self.geom, self.state)
            parts0 += [np.asarray(a).ravel() for (a, _) in mm]
            parts1 += [np.asarray(b).ravel() for (_, b) in mm]
        if self._cs is not None:
            self._join()
            c0, c1 = self._cs.min_marginals()
            parts0.append(c0)
            parts1.append(c1)
        return np.concatenate(parts0), np.concatenate(parts1)

    def update_costs(self, lo_per_var, hi_per_var) -> None:
        lo = np.asarray(lo_per_var, np.float64)
        hi = np.asarray(hi_per_var, np.float64)
        if self.host is not None:
            lo_u = jnp.asarray(np.append(lo, 0.0), dtype=self.dtype)
            hi_u = jnp.asarray(np.append(hi, 0.0), dtype=self.dtype)
            self.state = self._upd_jit(self.geom, self.state, lo_u, hi_u)
        if self._cs is not None:
            self._join()
            self._cs.update_costs(lo, hi)

    # -------------------------------------------------------------- escalate
    def to_native_full(self):
        """Full-collection native f64 solver warm-started with the hybrid's
        current duals (both sides' per-layer lo/hi costs and deferred mms,
        matched by their unique (bdd, variable) key). The deferred ledger
        transfers verbatim: the full solver's own compute_delta then yields
        exactly the combined delta the hybrid exchanged — so the trajectory
        continues as if the solve had been monolithic all along. Feeds the
        rounding / f32->f64 certification paths (extras.transfer_costs_to_
        native semantics, generalized to the two-solver split)."""
        from bdd_tpu import native

        self._join()
        cs = native.cpu_solver_from_collection(
            self.collection,
            self.nr_vars,
            np.zeros(self.nr_vars, dtype=np.float64),
        )
        V = self.nr_vars
        keys, los, his, mms = [], [], [], []
        if self.host is not None:
            for k, g in enumerate(self.geom.buckets):
                valid = np.asarray(g.layer_valid)
                lbd = np.asarray(self.host.layer_bdd[k])
                m = valid & (lbd >= 0)
                lv = np.asarray(g.layer_var)[m].astype(np.int64)
                keys.append(lbd[m].astype(np.int64) * (V + 1) + lv)
                los.append(np.asarray(self.state.lo[k], np.float64)[m])
                his.append(np.asarray(self.state.hi[k], np.float64)[m])
                mms.append(np.asarray(self.state.def_mm[k], np.float64)[m])
        if self._cs is not None:
            clo, chi, cmm = self._cs.costs()
            cb, cv = self._cs.layer_info()
            gb = np.asarray(self.host_bdds, dtype=np.int64)[cb]
            keys.append(gb * (V + 1) + cv.astype(np.int64))
            los.append(clo)
            his.append(chi)
            mms.append(cmm)
        key_u = np.concatenate(keys)
        lo = np.concatenate(los)
        hi = np.concatenate(his)
        mm = np.concatenate(mms)
        fb, fv = cs.layer_info()
        key_f = fb.astype(np.int64) * (V + 1) + fv.astype(np.int64)
        order = np.argsort(key_u, kind="stable")
        pos = np.searchsorted(key_u[order], key_f)
        assert (key_u[order][pos] == key_f).all(), "layer sets differ"
        sel = order[pos]
        cs.set_costs(lo[sel], hi[sel], mm[sel])
        return cs

    def close(self) -> None:
        """Release the worker pool (idempotent; also invoked by __del__ and
        the BddSolver pipeline after rounding so each 'hybrid mma' solve
        does not leak a ThreadPoolExecutor thread until GC)."""
        pool = getattr(self, "_pool", None)
        if pool is None:
            return
        self._join()
        pool.shutdown(wait=True)
        self._pool = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass
