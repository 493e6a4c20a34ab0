"""Uniform-bucketed backend — the performance compute path.

Key observation (a redesign of the CUDA hop-sweep): in all benchmark
families the per-(bdd, hop) layer width is tiny (simplex: 2, marginalization /
cardinality: a handful), while the number of BDDs is huge. So instead of the
reference's flat hop-major node array with atomic scatter
(bdd_cuda_base.h:183-207), we give every BDD a FIXED power-of-two slot width P
and batch BDDs of similar (width, depth) into buckets of dense tensors

    costs [H, B]      (one layer per (hop, bdd))
    nodes [H, P, B]   (slot-padded; root at slot 0)

The hop relaxation then needs NO gather and NO scatter: child links are
slot-local indices < P, and both the frontier update and the min-marginal
reduction become one-hot-masked [P, P, B] elementwise min-reductions — dense
elementwise work along B. BDDs are independent within a half-sweep (coupling
happens only through the per-variable delta between sweeps), so each bucket
runs as its own ``lax.scan``, or as one fused GPU kernel
(``solver/pallas_uniform.py``).

The delta consensus (segment-sum per primal variable + isotropic division) is
the only irregular op left, executed once per half-sweep.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bdd_tpu.bdd.collection import BOT, TOP, BddCollection

INF = jnp.inf

ARC_INTERNAL = 0
ARC_TOP = 1
ARC_BOT = 2


def _pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


MERGE_WORK = 8192  # buckets below this H*B work merge into the next depth


def _merge_small_buckets(groups: Dict[Tuple[int, int], List]) -> Dict[Tuple[int, int], List]:
    """Coalesce small same-width depth groups upward. Fine depth buckets cut
    hop padding on big homogeneous families, but tiny groups cost more in
    per-kernel overhead than they save — merge any group with H * members <
    MERGE_WORK into the next deeper bucket of the same slot width (mirrors
    native/bdd_host.cpp merge_small_buckets)."""
    out: Dict[Tuple[int, int], List] = {}
    for P in sorted({k[0] for k in groups}):
        hs = sorted(h for (p, h) in groups if p == P)
        carry: List = []
        for i, h in enumerate(hs):
            mem = carry + groups[(P, h)]
            if i + 1 < len(hs) and len(mem) * h < MERGE_WORK:
                carry = mem
            else:
                out[(P, h)] = mem
                carry = []
    return out


class BucketGeom(NamedTuple):
    """Static geometry of one (width, depth) bucket. Shapes noted per leaf.

    ``root_mask`` (column packing): several BDDs may share one column
    vertically, each occupying a contiguous row range; True marks rows where
    a new BDD's root (always slot 0) starts. ``None`` means the classic
    one-BDD-per-column layout (root at hop 0 only). Restarting is exact
    because a QBDD's last layer has only terminal arcs — nothing propagates
    across a segment boundary in either sweep direction."""

    node_valid: jnp.ndarray  # bool [H, P, B]
    lo_kind: jnp.ndarray  # int32 [H, P, B]
    lo_slot: jnp.ndarray  # int32 [H, P, B]
    hi_kind: jnp.ndarray
    hi_slot: jnp.ndarray
    layer_valid: jnp.ndarray  # bool [H, B]
    layer_var: jnp.ndarray  # int32 [H, B]  (pad -> V sentinel)
    alpha: jnp.ndarray  # [H, B]
    root_mask: Optional[jnp.ndarray] = None  # bool [H, B]

    @property
    def H(self) -> int:
        return self.node_valid.shape[0]

    @property
    def P(self) -> int:
        return self.node_valid.shape[1]

    @property
    def B(self) -> int:
        return self.node_valid.shape[2]


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Static-permutation delta exchange (replaces segment_sum + gather).

    The per-variable consensus sum is re-expressed over a dense [C, Vx]
    matrix: slot e of variable v with occurrence rank r lands at row r mod C
    of v's column. Both the scatter into that layout and the gather back to
    slot order are STATIC permutations, executed as ``lax.sort`` with
    precomputed constant keys. The reduction itself becomes a dense sum
    over the C axis (INF-safe, unlike a cumsum formulation). On an H100 the
    segment-sum exchange measured faster on gm50k (PERF.md).

    Heavy-tailed count distributions (e.g. graph matching: mean 2.5 layers
    per variable, max ~100) are handled by CLASS BLOCKS: C is capped small,
    and a variable with count > C gets NO primary column — all its
    occurrences route to a block of W contiguous columns after the primary
    Vp region, where W = ceil(count/C) rounded up to a power of two (its
    size class). Within a class every variable owns exactly W columns, so
    folding the per-column partials into per-variable totals is a dense
    ``reshape(nv, W).sum(1)`` and the re-broadcast a dense repeat — NO
    scatter/gather anywhere. (The class blocks replace an earlier fold of
    extra columns into the primary column by a scatter-add; they cost
    ~5-25% more sort volume and delete the fold entirely.)

    ``key_fwd[i]``: target position of flat source i (invalid/padding slots
    fill the unused positions). ``key_inv[t]``: flat destination of target t.
    Both are permutations of [0, N), N = max(E, C*Vx).
    ``Vp`` = nr_vars+1 lane-padded (primary columns, light variables only);
    ``Vx`` = Vp + class blocks, lane-padded. ``classes``: static
    (base_col, W, nv) per size class.
    """

    key_fwd: jnp.ndarray  # int32 [N]
    key_inv: jnp.ndarray  # int32 [N]
    C: int
    Vp: int
    Vx: int
    classes: Tuple[Tuple[int, int, int], ...] = ()  # (base_col, W, nv)
    # class members' (window-relative) variable ids, class-ordered,
    # concatenated [sum nv] — the static scatter/gather indices that merge
    # class totals into the primary vector for WINDOWED (sharded) plans
    class_members: Optional[jnp.ndarray] = None
    # windowed (sharded) plans: this shard's occurrences are routed within
    # its variable window [window_lo, window_lo + Vp); before the psum the
    # [2, Vp] window totals are placed at window_lo into a [2, Vg] global
    # vector (dynamic_update_slice — dense), summed across shards, and
    # sliced back. Vg == 0 means not windowed.
    window_lo: Optional[jnp.ndarray] = None  # int32 scalar
    Vg: int = 0
    # TWO-REGION windowed plans (sharded GM/QAP: quadratic couplings stretch
    # a handful of variables across the whole range, which would blow the
    # window up to ~V and kill the E/D scaling): virtual variable ids
    # [0, stretch_base) are window-relative as above; ids [stretch_base,
    # stretch_base + len(stretch_globals)) are the compacted union of every
    # shard's out-of-window variables, merged into the [2, Vg] global vector
    # by a static scatter-add at ``stretch_globals`` (and gathered back after
    # the psum). None means single-region (stretch_base ignored).
    stretch_globals: Optional[jnp.ndarray] = None  # int32 [G] global var ids
    stretch_base: int = 0
    # SPLIT plans (sharded, build_split_plans): virtual variable ids are
    # [0, split_base) per-shard PRIVATE variables (touched by exactly one
    # shard — no cross-shard consensus needed, the psum would be an
    # identity) followed by [split_base, split_base + split_len) the
    # globally-shared compacted region (variables touched by >= 2 shards,
    # SAME mapping on every shard). The cross-shard reduce is a dense psum
    # of the shared slice alone — no merge permutation, no scatter, and the
    # collective payload shrinks from ~V to the shared count. split_len == 0
    # means not split.
    split_base: int = 0
    split_len: int = 0
    # per class: how many of its (ascending-id) members fall in the shared
    # tail range — the class totals' shared slice lengths for the psum
    class_shared_counts: Tuple[int, ...] = ()
    # Optional Benes-network routing (solver/benes.py): 2*log2(Np)-1 swap
    # masks per direction, Np = N padded to a power of two. Routes the same
    # permutations with ~10x fewer passes than the bitonic `lax.sort`.
    benes_fwd: Optional[Tuple[jnp.ndarray, ...]] = None  # bool [Np] each
    benes_inv: Optional[Tuple[jnp.ndarray, ...]] = None
    benes_dists: Tuple[int, ...] = ()


jax.tree_util.register_dataclass(
    ExchangePlan,
    data_fields=[
        "key_fwd", "key_inv", "class_members", "window_lo",
        "stretch_globals", "benes_fwd", "benes_inv",
    ],
    meta_fields=["C", "Vp", "Vx", "classes", "Vg", "benes_dists",
                 "stretch_base", "split_base", "split_len",
                 "class_shared_counts"],
)


def build_exchange_plan(
    ids: np.ndarray,
    valid: np.ndarray,
    V: int,
    lane: int = 128,
    max_blowup: float = 4.0,
    force_C: Optional[int] = None,
    global_counts: Optional[np.ndarray] = None,
    class_merge_penalty: float = 0.0,
    compact_primary: bool = False,
) -> Optional[ExchangePlan]:
    """Precompute the exchange permutation keys (host side, numpy).

    ``ids``: concatenated per-bucket layer_var.ravel() (flat slot order, the
    same order as ``_exchange_ids``). ``valid``: matching layer_valid mask.
    ``force_C``: use this C instead of the local max count (the sharded path
    passes the global maximum so per-shard plans have identical shapes and
    stack on the device axis). ``global_counts``: per-variable GLOBAL layer
    counts (sum over shards) — the C cap and the class layout are derived
    from them so every shard builds the same [C, Vx] geometry while routing
    only its local occurrences (per-shard column sums then meet in the psum).
    Returns None when the count distribution is too skewed (C*Vp would blow
    past ``max_blowup``x the slot count) — callers fall back to segment ops.
    """
    ids = np.asarray(ids)
    valid = np.asarray(valid)
    E = ids.size
    real = np.nonzero(valid)[0]
    if real.size == 0 and force_C is None and global_counts is None:
        return None
    rv = ids[real]
    counts = np.bincount(rv, minlength=V) if rv.size else np.zeros(V, np.int64)
    layout_counts = (
        np.asarray(global_counts, dtype=np.int64)
        if global_counts is not None
        else counts
    )
    assert (counts <= layout_counts).all()
    cmax = max(int(layout_counts.max()) if layout_counts.size else 0, 1)
    # compact_primary (split plans): heavy variables get NO primary column
    # and zero-count ids none either — the primary region holds only the
    # light variables, compacted in ascending id order (which keeps the
    # private-then-shared region split contiguous). Saves C columns per
    # heavy variable (gm50k D=4: 19% of the sort volume).
    Vp = _pad_to(V + 1, lane)

    def vp_of(wvar):
        if not compact_primary:
            return Vp
        nl = int(((layout_counts > 0) & (wvar == 0)).sum())
        return _pad_to(max(nl, 1), lane)

    def class_layout(c):
        """Class blocks for count > c: W(v) = ceil(count/c) rounded up to the
        {pow2, 1.5*pow2} ladder (1,2,3,4,6,8,12,...) — <=33% padding at <=2x
        the class count of pure pow2. Returns (W per var [V] with 0 for
        light, ordered class list, total cols)."""
        heavy = layout_counts > c
        W = np.zeros(V, dtype=np.int64)
        if heavy.any():
            need = (layout_counts[heavy] + c - 1) // c
            p2 = (1 << np.maximum(
                np.ceil(np.log2(np.maximum(need, 1))).astype(np.int64) - 1, 0
            ))
            # smallest ladder value >= need: p2, 1.5*p2, or 2*p2
            w = np.where(
                need <= p2, p2,
                np.where(need <= p2 + p2 // 2, p2 + p2 // 2, 2 * p2),
            )
            W[heavy] = np.maximum(w, need)  # ladder floor (p2//2=0 at need=1)
        ws = sorted(int(w) for w in np.unique(W[W > 0]))
        return W, ws, int(W.sum())

    if force_C is not None:
        # legacy sharded path: fixed shapes across shards, no class blocks
        assert force_C >= cmax, (force_C, cmax)
        C = force_C
        Wvar = np.zeros(V, dtype=np.int64)
        ws: List[int] = []
        ncols = 0
    else:
        # pick the C cap minimizing sort volume N = max(E, C*Vx'):
        # small C shrinks the primary region but pads heavy variables into
        # wider class blocks; large C pads every light column. All the
        # resulting ops are dense (sort + reshape-sums), so sort volume IS
        # the cost — except in windowed/split plans, whose class totals go
        # through a [2, nv_heavy] scatter-add + gather pair:
        # ``class_merge_penalty`` (in sort-volume units per heavy variable)
        # charges that, preventing the degenerate C=1 everyone-is-heavy
        # layouts (gm50k D=4 split plan with C=1: 43.7k heavy vars). With
        # global_counts the inputs (E, layout) are identical on every
        # shard, so all shards pick the same C deterministically.
        best = None
        cand = sorted(
            {cmax}
            | {1 << k for k in range(0, cmax.bit_length() + 1)}
            | {3 * (1 << k) for k in range(0, cmax.bit_length())}
        )
        for c in cand:
            Wc, _, nc = class_layout(c)
            vx = _pad_to(vp_of(Wc) + nc, lane)
            n = max(E, c * vx) + class_merge_penalty * int((Wc > 0).sum())
            if best is None or n < best[0] or (n == best[0] and c < best[1]):
                best = (n, c)
        _, C = best
        Wvar, ws, ncols = class_layout(C)
    Vp = vp_of(Wvar)
    Vx = _pad_to(Vp + ncols, lane)
    CV = C * Vx
    N = max(E, CV)
    if force_C is None and N > max_blowup * E + 4 * lane * lane:
        return None

    order = np.argsort(rv, kind="stable")
    sv = rv[order]
    src = real[order]
    starts = np.zeros(V + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    occ = np.arange(sv.size, dtype=np.int64) - starts[sv]
    # light variable (count <= C): occurrence o -> (row o, primary column v).
    # heavy variable: rank j within its size class W -> columns
    # [base + j*W, base + (j+1)*W), occurrence o -> (row o // W,
    # column base + j*W + o % W). Dense per-class fold: the W columns of a
    # variable are contiguous and every class member has exactly W of them.
    classes: List[Tuple[int, int, int]] = []
    if compact_primary:
        col_of_var = np.zeros(V, dtype=np.int64)
        light_ids = np.nonzero((layout_counts > 0) & (Wvar == 0))[0]
        col_of_var[light_ids] = np.arange(light_ids.size, dtype=np.int64)
    else:
        col_of_var = np.arange(V, dtype=np.int64)  # light: primary col = id
    base = Vp
    all_members: List[np.ndarray] = []
    for w in ws:
        members = np.nonzero(Wvar == w)[0]
        nv = members.size
        col_of_var[members] = base + np.arange(nv, dtype=np.int64) * w
        classes.append((base, w, nv))
        all_members.append(members)
        base += nv * w
    members_cat = (
        np.concatenate(all_members) if all_members else np.zeros(0, np.int64)
    )
    heavy_mask = Wvar > 0
    Wocc = np.where(heavy_mask[sv], Wvar[sv], np.int64(1))
    is_h = heavy_mask[sv]
    row = np.where(is_h, occ // Wocc, occ)
    col = col_of_var[sv] + np.where(is_h, occ % Wocc, 0)
    tpos = row * Vx + col  # distinct targets < CV

    key_fwd = np.full(N, -1, dtype=np.int64)
    key_fwd[src] = tpos
    used_tgt = np.zeros(N, dtype=bool)
    used_tgt[tpos] = True
    unused_src = np.nonzero(key_fwd < 0)[0]
    unused_tgt = np.nonzero(~used_tgt)[0]
    key_fwd[unused_src] = unused_tgt
    key_inv = np.empty(N, dtype=np.int64)
    key_inv[tpos] = src
    key_inv[unused_tgt] = unused_src

    benes_fwd = benes_inv = None
    benes_dists: Tuple[int, ...] = ()
    if force_C is None and _use_benes():
        from bdd_tpu.solver import benes as bn

        Np = _pow2(N)
        ext = np.arange(N, Np, dtype=np.int64)
        # out[t] = in[argsort(key)[t]] is what the sort computes
        p1 = np.concatenate([np.argsort(key_fwd, kind="stable"), ext])
        p2 = np.concatenate([np.argsort(key_inv, kind="stable"), ext])
        st1 = bn.route_benes(p1)
        st2 = bn.route_benes(p2)
        benes_dists = tuple(m for m, _ in st1)
        benes_fwd = tuple(jnp.asarray(mk) for _, mk in st1)
        benes_inv = tuple(jnp.asarray(mk) for _, mk in st2)

    return ExchangePlan(
        key_fwd=jnp.asarray(key_fwd, dtype=jnp.int32),
        key_inv=jnp.asarray(key_inv, dtype=jnp.int32),
        C=C,
        Vp=Vp,
        Vx=Vx,
        classes=tuple(classes),
        class_members=jnp.asarray(members_cat, dtype=jnp.int32),
        benes_fwd=benes_fwd,
        benes_inv=benes_inv,
        benes_dists=benes_dists,
    )


def _dense_window(rv: np.ndarray, eps: float) -> Tuple[int, int]:
    """Smallest contiguous id range [lo, hi) covering >= (1-eps) of the
    occurrences (two-pointer over the distinct-id count profile)."""
    u, c = np.unique(rv, return_counts=True)
    need = int(np.ceil((1.0 - eps) * rv.size))
    best = (int(u[-1]) + 1 - int(u[0]), int(u[0]), int(u[-1]) + 1)
    acc = 0
    i = 0
    for j in range(u.size):
        acc += int(c[j])
        while acc - int(c[i]) >= need:
            acc -= int(c[i])
            i += 1
        if acc >= need:
            w = int(u[j]) + 1 - int(u[i])
            if w < best[0]:
                best = (w, int(u[i]), int(u[j]) + 1)
    return best[1], best[2]


def build_windowed_plans(
    shard_ids: Sequence[np.ndarray],
    shard_valid: Sequence[np.ndarray],
    V: int,
    lane: int = 128,
    max_blowup: float = 4.0,
    min_shrink: float = 0.75,
    stretch_eps: Sequence[float] = (0.0, 0.01, 0.03, 0.08),
) -> Optional[List[ExchangePlan]]:
    """Per-shard WINDOWED exchange plans for the multi-device path.

    The plain sharded plan keeps the [C, Vx] column matrix globally sized on
    every shard, so the per-shard sort volume N = max(E_shard, C*Vx) never
    shrinks with the shard count — the sorts (the dominant per-iteration
    cost) stop scaling. With a variable-ordered BDD partition each shard's
    occurrences live in a tight variable WINDOW [lo_s, lo_s + Wv) of width
    ~V/D, so the columns can be window-relative: N scales with E/D.

    Alignment for the psum: all shards share one static layout (same C, Wv,
    classes — derived from the elementwise MAX of the window-relative count
    profiles); each shard's class totals are merged into its [2, Vp] window
    vector by a tiny static scatter-add over ``class_members``, the window
    vectors are placed at ``window_lo`` into a [2, Vg] global vector
    (``lax.dynamic_update_slice`` — dense), psum'd, and sliced back. Window
    overlap is handled by the sum; out-of-window columns only ever carry
    zeros (invalid slots have zero deferred min-marginals).

    Returns None when the windows don't shrink the problem (max window >
    ``min_shrink`` * V) or any shard's count profile is too skewed — callers
    fall back to the global-column plans.

    TWO-REGION refinement: GM/QAP-like instances carry a few coupling
    variables whose occurrences span the whole range — with a single window
    those stretch Wv to ~V and disable the path. ``stretch_eps`` tries a
    ladder of tolerances: the window only has to cover >= (1-eps) of each
    shard's occurrences (minimal contiguous range, ``_dense_window``); the
    out-of-window variables of ALL shards form one compacted globally-shared
    stretcher region appended after the window (see ExchangePlan docstring).
    The candidate with the smallest sort volume N wins; eps=0.0 reproduces
    the single-region plan.
    """
    D = len(shard_ids)
    if D < 2:
        return None
    shard_ids = [np.asarray(i, dtype=np.int64) for i in shard_ids]
    shard_valid = [np.asarray(v) for v in shard_valid]

    def try_eps(eps: float) -> Optional[List[ExchangePlan]]:
        los: List[int] = []
        Wv = 0
        for ids, val in zip(shard_ids, shard_valid):
            rv = ids[val]
            if rv.size:
                lo, hi = _dense_window(rv, eps)
                lo = (lo // lane) * lane
            else:
                lo, hi = 0, 1
            los.append(lo)
            Wv = max(Wv, hi - lo)
        # union of out-of-window variables across shards (compacted region)
        stretch: List[np.ndarray] = []
        for ids, val, lo in zip(shard_ids, shard_valid, los):
            rv = ids[val]
            out = rv[(rv < lo) | (rv >= lo + Wv)]
            if out.size:
                stretch.append(np.unique(out))
        S = (
            np.unique(np.concatenate(stretch))
            if stretch
            else np.zeros(0, np.int64)
        )
        G = int(S.size)
        Vvirt = Wv + G
        if Vvirt > min_shrink * V or (G and G > Wv):
            return None  # no shrink / stretcher region dominates
        counts_rel = np.zeros(Vvirt, np.int64)
        rels: List[np.ndarray] = []
        for ids, val, lo in zip(shard_ids, shard_valid, los):
            inw = val & (ids >= lo) & (ids < lo + Wv)
            rel = np.full(ids.shape, np.int64(Vvirt))
            rel[inw] = ids[inw] - lo
            outm = val & ~inw
            if outm.any():
                rel[outm] = Wv + np.searchsorted(S, ids[outm])
            rels.append(rel)
            rv = rel[val]
            if rv.size:
                counts_rel = np.maximum(
                    counts_rel, np.bincount(rv, minlength=Vvirt)
                )
        plans: List[ExchangePlan] = []
        for rel, val in zip(rels, shard_valid):
            p = build_exchange_plan(
                rel, val, Vvirt, lane=lane, max_blowup=max_blowup,
                global_counts=counts_rel,
            )
            if p is None:
                return None
            plans.append(p)
        assert len({(p.C, p.Vp, p.Vx, p.classes) for p in plans}) == 1
        Vg = _pad_to(max(V + 1, max(los) + plans[0].Vp), lane)
        sg = jnp.asarray(S, dtype=jnp.int32) if G else None
        return [
            dataclasses.replace(
                p,
                window_lo=jnp.asarray(lo, dtype=jnp.int32),
                Vg=Vg,
                stretch_globals=sg,
                stretch_base=Wv if G else 0,
            )
            for p, lo in zip(plans, los)
        ]

    best: Optional[List[ExchangePlan]] = None
    for eps in stretch_eps:
        cand = try_eps(eps)
        if cand is not None and (
            best is None
            or cand[0].key_fwd.shape[0] < best[0].key_fwd.shape[0]
        ):
            best = cand
    return best


def build_split_plans(
    shard_ids: Sequence[np.ndarray],
    shard_valid: Sequence[np.ndarray],
    V: int,
    lane: int = 128,
    max_blowup: float = 6.0,
    class_merge_penalty: float = 0.0,
) -> Optional[List[ExchangePlan]]:
    """Per-shard SPLIT exchange plans: private + globally-shared regions.

    Windowed plans need each shard's variables in a tight CONTIGUOUS range —
    GM/QAP-like instances (quadratic couplings between far-apart ids) never
    qualify and fell back to globally-sized columns, pinning the per-shard
    sort volume at ~C*V regardless of the shard count (the measured 25-55%
    multi-chip efficiency plateau). The split layout drops contiguity:

      * virtual ids [0, split_base): this shard's PRIVATE variables
        (touched by no other shard), densest-first. No other shard holds
        mass for them, so they need no cross-shard consensus at all.
      * virtual ids [split_base, split_base + Sg): the variables touched by
        >= 2 shards, compacted, in one GLOBAL order shared by every shard.
        The psum acts on this dense slice of the per-variable totals —
        no merge permutation, no scatter (a rejected full-compaction
        variant needed two extra [V]-sized routing sorts per exchange,
        which cost more than it saved; see benchmarks/compaction_analysis).

    Shape alignment across shards (the [D, ...] stacking and the psum both
    need identical layouts): private regions are padded to the widest
    shard, and the class layout is derived from the elementwise MAXIMUM of
    the shards' count profiles — private profiles compare after the
    densest-first sort (slot i of every shard holds its i-th-heaviest
    private variable), the shared profile per global variable. Every
    shard's local counts are then pointwise <= the layout counts, which is
    exactly ``build_exchange_plan``'s contract for ``global_counts``.

    The collective payload shrinks from ~V+1 to Sg entries (measured: 100x
    on grid MRFs where only the D-1 partition boundaries are shared, 3x on
    GM-50k). Returns None when any shard's plan degenerates — callers fall
    back to windowed / global-column plans.
    """
    D = len(shard_ids)
    if D < 2:
        return None
    ids_l = [np.asarray(i, dtype=np.int64) for i in shard_ids]
    val_l = [np.asarray(v) for v in shard_valid]
    touch = np.zeros(V, dtype=np.int32)
    counts_l: List[np.ndarray] = []
    touched_l: List[np.ndarray] = []
    for ids, val in zip(ids_l, val_l):
        rv = ids[val]
        counts_l.append(np.bincount(rv, minlength=V)[:V] if rv.size
                        else np.zeros(V, np.int64))
        t = np.unique(rv) if rv.size else np.zeros(0, np.int64)
        touch[t] += 1
        touched_l.append(t)
    shared = np.nonzero(touch >= 2)[0]
    Sg = int(shared.size)
    is_sh = np.zeros(V, dtype=bool)
    is_sh[shared] = True
    # private regions, densest-first; profile = elementwise max over shards
    privs: List[np.ndarray] = []
    prof_priv = np.zeros(0, dtype=np.int64)
    for c, t in zip(counts_l, touched_l):
        priv = t[~is_sh[t]]
        o = np.argsort(c[priv], kind="stable")[::-1]
        priv = priv[o]
        privs.append(priv)
        pp = np.asarray(c[priv], dtype=np.int64)
        if pp.size > prof_priv.size:
            prof_priv = np.pad(prof_priv, (0, pp.size - prof_priv.size))
        prof_priv[: pp.size] = np.maximum(prof_priv[: pp.size], pp)
    Ps = int(prof_priv.size)
    Vvirt = Ps + Sg
    if Vvirt == 0:
        return None
    prof_shared = np.zeros(Sg, dtype=np.int64)
    for c in counts_l:
        prof_shared = np.maximum(prof_shared, c[shared])
    layout = np.concatenate([prof_priv, prof_shared])
    plans: List[ExchangePlan] = []
    for ids, val, priv in zip(ids_l, val_l, privs):
        vmap = np.full(V + 1, np.int64(Vvirt))
        vmap[priv] = np.arange(priv.size, dtype=np.int64)
        vmap[shared] = Ps + np.arange(Sg, dtype=np.int64)
        rel = np.where(val, vmap[np.minimum(ids, V)], np.int64(Vvirt))
        p = build_exchange_plan(
            rel, val, Vvirt, lane=lane, max_blowup=max_blowup,
            global_counts=layout, class_merge_penalty=class_merge_penalty,
            compact_primary=True,
        )
        if p is None:
            return None
        plans.append(p)
    assert len({(p.C, p.Vp, p.Vx, p.classes) for p in plans}) == 1
    # per class, the count of members with shared (tail-range) virtual ids;
    # members are ascending, private ids < Ps <= shared ids, so the shared
    # members are exactly the tail — the scatterless psum packing relies on
    # this (see _exchange_perm's split branch)
    p0 = plans[0]
    mem = np.asarray(p0.class_members)
    shared_counts = []
    off = 0
    for _base, _w, nv in p0.classes:
        shared_counts.append(int((mem[off : off + nv] >= Ps).sum()))
        off += nv
    # the primary region is LIGHT-COMPACTED (ascending id), so the region
    # boundary translates from id units to column units: private lights
    # (< Ps) first, shared lights after
    is_heavy = np.zeros(Vvirt, dtype=bool)
    if mem.size:
        is_heavy[mem] = True
    light_ids = np.nonzero((layout > 0) & ~is_heavy)[0]
    n_priv_light = int((light_ids < Ps).sum())
    n_shared_light = int(light_ids.size) - n_priv_light
    return [
        dataclasses.replace(
            p, split_base=n_priv_light, split_len=n_shared_light,
            class_shared_counts=tuple(shared_counts),
        )
        for p in plans
    ]


class UniformGeom(NamedTuple):
    buckets: Tuple[BucketGeom, ...]
    num_bdds_per_var: jnp.ndarray  # int32 [V]
    exchange: Optional[ExchangePlan] = None

    @property
    def V(self) -> int:
        return self.num_bdds_per_var.shape[0]


class UniformState(NamedTuple):
    lo: Tuple[jnp.ndarray, ...]  # per bucket [H, B]
    hi: Tuple[jnp.ndarray, ...]
    def_mm: Tuple[jnp.ndarray, ...]
    cft: Tuple[jnp.ndarray, ...]  # per bucket [H, P, B]


class UniformHost(NamedTuple):
    """Host-side bookkeeping for import/export.

    With column packing, one column holds several BDDs stacked vertically;
    ``bdd_of_col``/``depths`` then describe only the FIRST segment of each
    column — per-slot exports must use ``layer_bdd`` (always filled by the
    flatteners; empty only in the sharded representative host)."""

    geom: UniformGeom
    bdd_of_col: Tuple[np.ndarray, ...]  # per bucket [B] first-segment bdd (-1 pad)
    depths: Tuple[np.ndarray, ...]  # per bucket [B] first-segment depth
    nr_vars: int
    nr_primal_vars: int
    nr_bdds: int
    layer_bdd: Tuple[np.ndarray, ...] = ()  # per bucket [H, B] bdd nr (-1 pad)


def flatten_uniform(
    collection: BddCollection,
    nr_vars: int,
    nr_primal_vars: Optional[int] = None,
    dtype=jnp.float32,
    lane_pad: int = 128,
    counts_override: Optional[np.ndarray] = None,
    keep_bdds: Optional[Sequence[int]] = None,
    build_plan: bool = True,
    pack: Optional[bool] = None,
) -> UniformHost:
    """Build bucketed uniform arrays from a QBDD collection.

    ``counts_override``: global per-variable BDD counts (multi-shard case).
    ``keep_bdds``: subset of BDD numbers to include (sharding); default all.
    """
    if nr_primal_vars is None:
        nr_primal_vars = nr_vars
    bdd_nrs = list(keep_bdds) if keep_bdds is not None else list(range(collection.nr_bdds()))

    # per-bdd structure
    info = []  # (bucket_key, bdd_nr, levels, vars, slots)
    for b in bdd_nrs:
        levels = collection.node_levels(b)
        depth = max(levels) + 1
        lvars = collection.level_variables(b)
        # slot assignment: nodes of (b, h) numbered in node order, root slot 0
        counts: Dict[int, int] = {}
        slots = []
        for lvl in levels:
            s = counts.get(lvl, 0)
            slots.append(s)
            counts[lvl] = s + 1
        width = max(counts.values())
        # depth rounded to eighth-of-pow2 steps: <=12.5% hop padding with a
        # bounded number of distinct bucket shapes (pow2 rounding wasted up
        # to 2x of the sweep + exchange volume)
        step = max(1, _pow2(depth) // 8)
        key = (_pow2(width), _pad_to(depth, step))
        info.append((key, b, levels, lvars, slots, depth))

    buckets_members: Dict[Tuple[int, int], List] = {}
    for item in info:
        buckets_members.setdefault(item[0], []).append(item)
    buckets_members = _merge_small_buckets(buckets_members)

    # global per-variable counts
    if counts_override is not None:
        counts_global = np.asarray(counts_override, dtype=np.int32)
    else:
        counts_global = np.zeros(nr_vars, dtype=np.int32)
        for (_, b, levels, lvars, slots, depth) in info:
            for v in lvars:
                counts_global[v] += 1
    counts_safe = np.maximum(counts_global, 1)

    bucket_geoms: List[BucketGeom] = []
    bdd_of_cols: List[np.ndarray] = []
    depths_l: List[np.ndarray] = []
    layer_bdds: List[np.ndarray] = []
    for key in sorted(buckets_members.keys()):
        members = buckets_members[key]
        P, H = key
        nB = len(members)
        pad = lane_pad if nB >= lane_pad else 8
        B = _pad_to(nB, pad)
        node_valid = np.zeros((H, P, B), dtype=bool)
        lo_kind = np.full((H, P, B), ARC_BOT, dtype=np.int32)
        lo_slot = np.zeros((H, P, B), dtype=np.int32)
        hi_kind = np.full((H, P, B), ARC_BOT, dtype=np.int32)
        hi_slot = np.zeros((H, P, B), dtype=np.int32)
        layer_valid = np.zeros((H, B), dtype=bool)
        layer_var = np.full((H, B), nr_vars, dtype=np.int32)
        bdd_of_col = np.full(B, -1, dtype=np.int64)
        depths = np.zeros(B, dtype=np.int32)
        layer_bdd = np.full((H, B), -1, dtype=np.int64)
        for col, (_, b, levels, lvars, slots, depth) in enumerate(members):
            bdd_of_col[col] = b
            depths[col] = depth
            s0, _ = collection.node_range(b)
            for h in range(depth):
                layer_valid[h, col] = True
                layer_var[h, col] = lvars[h]
                layer_bdd[h, col] = b
            for i_local, (lvl, slot) in enumerate(zip(levels, slots)):
                node_valid[lvl, slot, col] = True
                n_abs = s0 + i_local
                for child, kind_arr, slot_arr in (
                    (collection.lo[n_abs], lo_kind, lo_slot),
                    (collection.hi[n_abs], hi_kind, hi_slot),
                ):
                    if child == TOP:
                        kind_arr[lvl, slot, col] = ARC_TOP
                    elif child == BOT:
                        kind_arr[lvl, slot, col] = ARC_BOT
                    else:
                        kind_arr[lvl, slot, col] = ARC_INTERNAL
                        slot_arr[lvl, slot, col] = slots[child - s0]
        alpha = np.zeros((H, B))
        m = layer_valid
        alpha[m] = 1.0 / counts_safe[layer_var[m]]
        bucket_geoms.append(
            BucketGeom(
                node_valid=jnp.asarray(node_valid),
                lo_kind=jnp.asarray(lo_kind),
                lo_slot=jnp.asarray(lo_slot),
                hi_kind=jnp.asarray(hi_kind),
                hi_slot=jnp.asarray(hi_slot),
                layer_valid=jnp.asarray(layer_valid),
                layer_var=jnp.asarray(layer_var),
                alpha=jnp.asarray(alpha, dtype=dtype),
            )
        )
        bdd_of_cols.append(bdd_of_col)
        depths_l.append(depths)
        layer_bdds.append(layer_bdd)

    geom = UniformGeom(
        buckets=tuple(bucket_geoms),
        num_bdds_per_var=jnp.asarray(counts_global, dtype=jnp.int32),
        exchange=None,
    )
    host = UniformHost(
        geom=geom,
        bdd_of_col=tuple(bdd_of_cols),
        depths=tuple(depths_l),
        nr_vars=nr_vars,
        nr_primal_vars=nr_primal_vars,
        nr_bdds=len(bdd_nrs),
        layer_bdd=tuple(layer_bdds),
    )
    if pack is None:
        # packing reorders float reductions — keep the f64 path bit-identical
        # to the oracle, and the sharded path (counts_override) on uniform
        # global bucket keys
        pack = dtype == jnp.float32 and counts_override is None
    if pack:
        host = pack_uniform_host(host, dtype=dtype)
    if build_plan:
        host = attach_exchange_plan(host)
    return host


def attach_exchange_plan(host: UniformHost) -> UniformHost:
    """(Re)build the static-permutation exchange plan for a host's layout."""
    geom = host.geom
    if not geom.buckets:
        return host
    plan = build_exchange_plan(
        np.concatenate([np.asarray(g.layer_var).ravel() for g in geom.buckets]),
        np.concatenate([np.asarray(g.layer_valid).ravel() for g in geom.buckets]),
        host.nr_vars,
    )
    return host._replace(geom=geom._replace(exchange=plan))


# Packing cost model: one serial hop is weighted like PACK_LAMBDA padded
# layer slots (E, which the exchange volume is linear in). PACK_H_CAP splits
# each width class into a shallow and a deep tier. Neither is re-derived on
# the H100 yet.
PACK_LAMBDA = 128
PACK_H_CAP = 256


def _ffd_pack(depths: np.ndarray, cap: int):
    """Worst-fit-decreasing column packing. Returns (column, row0) per
    segment (input order) and the number of columns."""
    import heapq

    order = np.argsort(-depths, kind="stable")
    col = np.zeros(depths.size, dtype=np.int64)
    row0 = np.zeros(depths.size, dtype=np.int64)
    heap: List[Tuple[int, int]] = []  # (fill, column)
    ncols = 0
    for i in order:
        d = int(depths[i])
        if heap and heap[0][0] + d <= cap:
            fill, c = heapq.heappop(heap)
        else:
            fill, c = 0, ncols
            ncols += 1
        col[i] = c
        row0[i] = fill
        heapq.heappush(heap, (fill + d, c))
    return col, row0, ncols



def _pack_candidates(max_d: int) -> List[int]:
    """Candidate packed-column heights: multiples of the deepest member
    (deeper columns pack tighter but add serial scan latency)."""
    if max_d > PACK_H_CAP:
        return [max_d]
    return sorted(
        {min(m * max_d, max(PACK_H_CAP, max_d)) for m in (1, 2, 3, 4)}
    )


def _pack_eval(deps: np.ndarray, cap: int):
    """FFD-pack ``deps`` under ``cap``; returns (cost, col, row0, H, B)
    under the shared cost model (bucket area + PACK_LAMBDA per serial
    row). The SINGLE source of the model — choose_pack_caps (globally pooled
    caps for sharding) and pack_uniform_host must agree on it."""
    col, row0, nc = _ffd_pack(deps, cap)
    H = int((row0 + deps).max())
    B = _pad_to(nc, 128 if nc >= 128 else 8)
    return H * B + PACK_LAMBDA * H, col, row0, H, B


def choose_pack_caps(
    depths_by_class: Dict[int, np.ndarray]
) -> Dict[Tuple[int, int], int]:
    """Pick the packed-column height per (width class P, depth tier) with the
    same cost model as :func:`pack_uniform_host`, but from a POOLED multiset
    of segment depths. The sharded backend pools the depths of ALL shards and
    passes the result back via ``caps`` so every shard packs with identical
    column heights (required for the per-shard buckets to stack on the device
    axis of the mesh)."""
    caps: Dict[Tuple[int, int], int] = {}
    for P, deps_all in depths_by_class.items():
        deps_all = np.asarray(deps_all, dtype=np.int64)
        for ti, sel in enumerate(
            (deps_all <= PACK_H_CAP, deps_all > PACK_H_CAP)
        ):
            deps = deps_all[sel]
            if deps.size == 0:
                continue
            max_d = int(deps.max())
            if max_d > PACK_H_CAP:
                caps[(int(P), ti)] = max_d
                continue
            best = None
            for cap in _pack_candidates(max_d):
                cost = _pack_eval(deps, cap)[0]
                if best is None or cost < best[0]:
                    best = (cost, cap)
            caps[(int(P), ti)] = best[1]
    return caps


def pack_uniform_host(
    host: UniformHost,
    dtype=jnp.float32,
    caps: Optional[Dict[Tuple[int, int], int]] = None,
) -> UniformHost:
    """Vertical column packing: stack several BDDs into one column of one
    bucket per (width, depth-tier) class, with ``root_mask`` marking segment
    starts. Cuts the number of buckets (fewer kernel launches / XLA ops), the
    total serial scan steps, and the padded slot count E (exchange volume).
    Per width class the column height is chosen by a cost model
    E_padded + PACK_LAMBDA * height over FFD trials; BDDs deeper than
    PACK_H_CAP go to a separate bucket so the deep few do not set the
    height of the shallow majority. ``caps overrides the per-class height choice
    (one value per (P, tier) key from :func:`choose_pack_caps`) — used by the
    sharded backend to pack every shard identically."""
    geom = host.geom
    assert host.layer_bdd, "pack_uniform_host needs layer_bdd bookkeeping"
    assert all(g.root_mask is None for g in geom.buckets), "already packed"

    # collect segments per width class
    classes: Dict[int, List[Tuple[int, int, int, int]]] = {}
    bufs = []
    for k, g in enumerate(geom.buckets):
        bufs.append(
            dict(
                node_valid=np.asarray(g.node_valid),
                lo_kind=np.asarray(g.lo_kind),
                lo_slot=np.asarray(g.lo_slot),
                hi_kind=np.asarray(g.hi_kind),
                hi_slot=np.asarray(g.hi_slot),
                layer_valid=np.asarray(g.layer_valid),
                layer_var=np.asarray(g.layer_var),
                alpha=np.asarray(g.alpha),
                layer_bdd=np.asarray(host.layer_bdd[k]),
            )
        )
        deps = np.asarray(host.depths[k])
        cols = np.asarray(host.bdd_of_col[k])
        for c in np.nonzero(deps > 0)[0]:
            classes.setdefault(int(g.P), []).append(
                (int(deps[c]), k, int(c), int(cols[c]))
            )

    new_buckets: List[BucketGeom] = []
    new_bdd_of_col: List[np.ndarray] = []
    new_depths: List[np.ndarray] = []
    new_layer_bdd: List[np.ndarray] = []
    for P in sorted(classes):
        segs = classes[P]
        tiers = [
            [s for s in segs if s[0] <= PACK_H_CAP],
            [s for s in segs if s[0] > PACK_H_CAP],
        ]
        for ti, tier in enumerate(tiers):
            if not tier:
                continue
            deps = np.array([s[0] for s in tier], dtype=np.int64)
            max_d = int(deps.max())
            if caps is not None:
                cands = [max(caps.get((int(P), ti), max_d), max_d)]
            else:
                cands = _pack_candidates(max_d)
            best = None
            for cap in cands:
                cost, col, row0, H, B = _pack_eval(deps, cap)
                if best is None or cost < best[0]:
                    best = (cost, col, row0, H, B)
            _, col, row0, H, B = best
            node_valid = np.zeros((H, P, B), dtype=bool)
            lo_kind = np.full((H, P, B), ARC_BOT, dtype=np.int32)
            lo_slot = np.zeros((H, P, B), dtype=np.int32)
            hi_kind = np.full((H, P, B), ARC_BOT, dtype=np.int32)
            hi_slot = np.zeros((H, P, B), dtype=np.int32)
            layer_valid = np.zeros((H, B), dtype=bool)
            layer_var = np.full((H, B), host.nr_vars, dtype=np.int32)
            alpha = np.zeros((H, B))
            root_mask = np.zeros((H, B), dtype=bool)
            layer_bdd = np.full((H, B), -1, dtype=np.int64)
            bdd_of_col = np.full(B, -1, dtype=np.int64)
            depths_col = np.zeros(B, dtype=np.int32)
            # vectorized copy, grouped by source bucket
            by_src: Dict[int, List[int]] = {}
            for i, (_, k, _, _) in enumerate(tier):
                by_src.setdefault(k, []).append(i)
            for k, idxs in by_src.items():
                d = deps[idxs]
                sc = np.array([tier[i][2] for i in idxs], dtype=np.int64)
                bdd = np.array([tier[i][3] for i in idxs], dtype=np.int64)
                dc = col[idxs]
                r0 = row0[idxs]
                h_idx = np.concatenate([np.arange(x) for x in d])
                src_c = np.repeat(sc, d)
                dst_r = np.concatenate([r + np.arange(x) for r, x in zip(r0, d)])
                dst_c = np.repeat(dc, d)
                src = bufs[k]
                for dst3, name in (
                    (node_valid, "node_valid"),
                    (lo_kind, "lo_kind"),
                    (lo_slot, "lo_slot"),
                    (hi_kind, "hi_kind"),
                    (hi_slot, "hi_slot"),
                ):
                    dst3[dst_r, :, dst_c] = src[name][h_idx, :, src_c]
                for dst2, name in (
                    (layer_valid, "layer_valid"),
                    (layer_var, "layer_var"),
                    (alpha, "alpha"),
                    (layer_bdd, "layer_bdd"),
                ):
                    dst2[dst_r, dst_c] = src[name][h_idx, src_c]
                root_mask[r0, dc] = True
                first = r0 == 0
                bdd_of_col[dc[first]] = bdd[first]
                depths_col[dc[first]] = d[first]
            new_buckets.append(
                BucketGeom(
                    node_valid=jnp.asarray(node_valid),
                    lo_kind=jnp.asarray(lo_kind),
                    lo_slot=jnp.asarray(lo_slot),
                    hi_kind=jnp.asarray(hi_kind),
                    hi_slot=jnp.asarray(hi_slot),
                    layer_valid=jnp.asarray(layer_valid),
                    layer_var=jnp.asarray(layer_var),
                    alpha=jnp.asarray(alpha, dtype=dtype),
                    root_mask=jnp.asarray(root_mask),
                )
            )
            new_bdd_of_col.append(bdd_of_col)
            new_depths.append(depths_col)
            new_layer_bdd.append(layer_bdd)

    return host._replace(
        geom=geom._replace(buckets=tuple(new_buckets), exchange=None),
        bdd_of_col=tuple(new_bdd_of_col),
        depths=tuple(new_depths),
        layer_bdd=tuple(new_layer_bdd),
    )


def init_uniform_state(
    host: UniformHost, objective, dtype=jnp.float32
) -> UniformState:
    obj = np.asarray(objective, dtype=np.float64)
    counts = np.maximum(np.asarray(host.geom.num_bdds_per_var), 1)
    lo_l, hi_l, mm_l, cft_l = [], [], [], []
    for g in host.geom.buckets:
        lvar = np.asarray(g.layer_var)
        lvalid = np.asarray(g.layer_valid)
        hi = np.zeros(lvar.shape)
        hi[lvalid] = obj[lvar[lvalid]] / counts[lvar[lvalid]]
        lo_l.append(jnp.zeros(lvar.shape, dtype=dtype))
        hi_l.append(jnp.asarray(hi, dtype=dtype))
        mm_l.append(jnp.zeros(lvar.shape, dtype=dtype))
        cft_l.append(jnp.zeros(g.node_valid.shape, dtype=dtype))
    state = UniformState(tuple(lo_l), tuple(hi_l), tuple(mm_l), tuple(cft_l))
    cft = _backward_all(host.geom, state.lo, state.hi)
    return state._replace(cft=cft)


def init_uniform_state_from_layer_costs(
    host: UniformHost, layer_costs, dtype=jnp.float32
) -> UniformState:
    """Initialize from explicit per-layer duals {(bdd, var): (lo, hi)} —
    the warm-start path for cut tightening (the reference transfers the
    converged Lagrange costs onto the melded BDDs, bdd_tightening.h:168-274,
    so the tightened solve continues from the pre-meld dual bound instead of
    re-deriving it from scratch). Missing layers get (0, 0); deferred mms
    start at zero unless a value is a (lo, hi, mm) triple — the exact
    native->uniform state transfer (reverse of
    extras.transfer_costs_to_native, same per-layer semantics)."""
    assert host.layer_bdd, "warm start needs layer_bdd bookkeeping"
    lo_l, hi_l, mm_l, cft_l = [], [], [], []
    for k, g in enumerate(host.geom.buckets):
        lvar = np.asarray(g.layer_var)
        lbdd = np.asarray(host.layer_bdd[k])
        lvalid = np.asarray(g.layer_valid)
        lo = np.zeros(lvar.shape)
        hi = np.zeros(lvar.shape)
        mm = np.zeros(lvar.shape)
        for (h, b) in zip(*np.nonzero(lvalid & (lbdd >= 0))):
            c = layer_costs.get((int(lbdd[h, b]), int(lvar[h, b])))
            if c is not None:
                lo[h, b], hi[h, b] = c[0], c[1]
                if len(c) > 2:
                    mm[h, b] = c[2]
        lo_l.append(jnp.asarray(lo, dtype=dtype))
        hi_l.append(jnp.asarray(hi, dtype=dtype))
        mm_l.append(jnp.asarray(mm, dtype=dtype))
        cft_l.append(jnp.zeros(g.node_valid.shape, dtype=dtype))
    state = UniformState(tuple(lo_l), tuple(hi_l), tuple(mm_l), tuple(cft_l))
    cft = _backward_all(host.geom, state.lo, state.hi)
    return state._replace(cft=cft)


@jax.jit
def _backward_all(geom: UniformGeom, lo, hi):
    return tuple(
        bucket_backward_run(g, l, h) for g, l, h in zip(geom.buckets, lo, hi)
    )


def root_rows(g: BucketGeom) -> jnp.ndarray:
    """[H, B] bool: rows where a BDD root (slot 0) sits."""
    if g.root_mask is not None:
        return g.root_mask
    return jnp.concatenate(
        [g.layer_valid[:1], jnp.zeros_like(g.layer_valid[1:])], axis=0
    )


def _restart_cfr(cfr, root_row, P):
    """Reset restarted columns' frontier to the root initial condition
    (0 at slot 0, INF elsewhere). Exact: the carry entering a restart row is
    all-INF (the previous BDD's last layer has no internal arcs)."""
    iota0 = jax.lax.broadcasted_iota(jnp.int32, (P, 1), 0) == 0
    root_init = jnp.where(iota0, 0.0, INF).astype(cfr.dtype)
    return jnp.where(root_row[None, :], root_init, cfr)


# ------------------------------------------------------------ bucket kernels
def _child_cft(kind, slot, cft_next, P):
    """cft of the child along one arc type, [P, B]. Gather over the slot axis
    via a one-hot mask (slot values < P, unrolled by XLA)."""
    # onehot[k, p, b] = (slot[p, b] == k)
    iota = jax.lax.broadcasted_iota(jnp.int32, (P, 1, 1), 0)
    onehot = slot[None, :, :] == iota  # [P(k), P(p), B]
    gathered = jnp.sum(
        jnp.where(onehot, cft_next[:, None, :], 0.0), axis=0
    )  # [P(p), B]
    return jnp.where(
        kind == ARC_TOP, 0.0, jnp.where(kind == ARC_BOT, INF, gathered)
    )


def _relax_next(vals, kind, slot, valid, P):
    """Frontier relaxation: next_cfr[k, b] = min over source slots p with an
    internal arc into k (scatter-min as masked min-reduction)."""
    iota = jax.lax.broadcasted_iota(jnp.int32, (P, 1, 1), 0)
    mask = (slot[None] == iota) & (kind[None] == ARC_INTERNAL) & valid[None]
    return jnp.min(jnp.where(mask, vals[None], INF), axis=1)  # [P(k), B]


def _hop_cost_update(lo_row, hi_row, m0, m1, omega_row, alpha_row, din_lo, din_hi, lvalid):
    """Same contract as jax_solver._hop_cost_update, on [B] rows."""
    fin0 = jnp.isfinite(m0)
    fin1 = jnp.isfinite(m1)
    both = fin0 & fin1
    diff = jnp.where(both, m1 - m0, 0.0)
    diff = jnp.where(jnp.isnan(diff), 0.0, diff)
    mm_rm = omega_row * diff
    # double-where around alpha*din: the multiply must never see an infinite
    # primal (forcing deltas, the ±inf def_mm contract) — its VJP computes
    # cotangent 0 x inf = NaN under jax.grad (the learned path). The infinity
    # is re-added additively (adds pass cotangents through untouched);
    # alpha·(±inf) == ±inf for alpha>0, so the forward value is unchanged.
    dfin0 = jnp.isfinite(din_lo)
    dfin1 = jnp.isfinite(din_hi)
    dlo = alpha_row * jnp.where(dfin0, din_lo, 0.0) + jnp.where(dfin0, 0.0, din_lo)
    dhi = alpha_row * jnp.where(dfin1, din_hi, 0.0) + jnp.where(dfin1, 0.0, din_hi)
    new_lo = jnp.where(fin0, lo_row - jnp.maximum(-mm_rm, 0.0), INF) + dlo
    new_hi = jnp.where(fin1, hi_row - jnp.maximum(mm_rm, 0.0), INF) + dhi
    def_mm = jnp.where(both, mm_rm, jnp.where(fin1, -INF, INF))
    return (
        jnp.where(lvalid, new_lo, 0.0),
        jnp.where(lvalid, new_hi, 0.0),
        jnp.where(lvalid, def_mm, 0.0),
    )


def bucket_backward_run(g: BucketGeom, lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    P = g.P

    def step(cft_next, xs):
        (nvalid, lo_k, lo_s, hi_k, hi_s, lo_row, hi_row) = xs
        t_lo = _child_cft(lo_k, lo_s, cft_next, P)
        t_hi = _child_cft(hi_k, hi_s, cft_next, P)
        cft_row = jnp.where(
            nvalid, jnp.minimum(lo_row[None] + t_lo, hi_row[None] + t_hi), INF
        )
        return cft_row, cft_row

    xs = (g.node_valid, g.lo_kind, g.lo_slot, g.hi_kind, g.hi_slot, lo, hi)
    init = jnp.full((P, g.B), INF, dtype=lo.dtype)
    _, cft = jax.lax.scan(step, init, xs, reverse=True)
    return cft


def bucket_forward_run(g: BucketGeom, lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    P = g.P
    cfr0 = jnp.where(g.node_valid[0], 0.0, INF).astype(lo.dtype)
    packed = g.root_mask is not None

    def step(cfr_row, xs):
        (nvalid, lo_k, lo_s, hi_k, hi_s, lo_row, hi_row, root_row) = xs
        if packed:
            cfr_row = _restart_cfr(cfr_row, root_row, P)
        nxt = jnp.minimum(
            _relax_next(cfr_row + lo_row[None], lo_k, lo_s, nvalid, P),
            _relax_next(cfr_row + hi_row[None], hi_k, hi_s, nvalid, P),
        )
        return nxt, cfr_row

    xs = (g.node_valid, g.lo_kind, g.lo_slot, g.hi_kind, g.hi_slot, lo, hi,
          root_rows(g))
    _, cfr = jax.lax.scan(step, cfr0, xs)
    return cfr


def bucket_min_marginals(
    g: BucketGeom, lo: jnp.ndarray, hi: jnp.ndarray, cft=None
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """``cft``: optional precomputed clean backward run of (lo, hi) — every
    state-mutating op in this module ends with a backward refresh, so
    ``state.cft`` always qualifies and saves one backward sweep."""
    P = g.P
    cfr = bucket_forward_run(g, lo, hi)
    if cft is None:
        cft = bucket_backward_run(g, lo, hi)
    cft_next = jnp.concatenate(
        [cft[1:], jnp.full((1, P, g.B), INF, dtype=lo.dtype)], axis=0
    )

    def per_hop(cfr_row, cft_next_row, nvalid, lo_k, lo_s, hi_k, hi_s, lo_row, hi_row):
        t_lo = _child_cft(lo_k, lo_s, cft_next_row, P)
        t_hi = _child_cft(hi_k, hi_s, cft_next_row, P)
        lo_path = jnp.where(nvalid, cfr_row + lo_row[None] + t_lo, INF)
        hi_path = jnp.where(nvalid, cfr_row + hi_row[None] + t_hi, INF)
        return jnp.min(lo_path, axis=0), jnp.min(hi_path, axis=0)

    return jax.vmap(per_hop)(
        cfr,
        cft_next,
        g.node_valid,
        g.lo_kind,
        g.lo_slot,
        g.hi_kind,
        g.hi_slot,
        lo,
        hi,
    )


def bucket_forward_iteration(
    g: BucketGeom,
    lo: jnp.ndarray,
    hi: jnp.ndarray,
    cft: jnp.ndarray,
    omega,
    din_lo: jnp.ndarray,
    din_hi: jnp.ndarray,
    alpha=None,
):
    """One forward half-sweep of a bucket. din_*: [H, B] pre-gathered deltas.
    ``alpha``/``omega`` may be [H, B] arrays (learned per-layer parameters,
    ref: bdd_cuda_learned_mma.cu:10-171) or scalars; alpha defaults to the
    isotropic 1/#bdds-per-var weights."""
    if alpha is None:
        alpha = g.alpha
    alpha = jnp.broadcast_to(alpha, lo.shape).astype(lo.dtype)
    din_lo = din_lo.astype(lo.dtype)
    din_hi = din_hi.astype(lo.dtype)
    P = g.P
    cft_next = jnp.concatenate(
        [cft[1:], jnp.full((1, P, g.B), INF, dtype=lo.dtype)], axis=0
    )
    cfr0 = jnp.where(g.node_valid[0], 0.0, INF).astype(lo.dtype)
    omega_arr = jnp.broadcast_to(jnp.asarray(omega, dtype=lo.dtype), lo.shape)
    packed = g.root_mask is not None

    def step(cfr_row, xs):
        (nvalid, lo_k, lo_s, hi_k, hi_s, lo_row, hi_row, om, al, dlo, dhi, lval,
         cftn, root_row) = xs
        if packed:
            cfr_row = _restart_cfr(cfr_row, root_row, P)
        t_lo = _child_cft(lo_k, lo_s, cftn, P)
        t_hi = _child_cft(hi_k, hi_s, cftn, P)
        lo_path = jnp.where(nvalid, cfr_row + lo_row[None] + t_lo, INF)
        hi_path = jnp.where(nvalid, cfr_row + hi_row[None] + t_hi, INF)
        m0 = jnp.min(lo_path, axis=0)
        m1 = jnp.min(hi_path, axis=0)
        new_lo, new_hi, mm = _hop_cost_update(lo_row, hi_row, m0, m1, om, al, dlo, dhi, lval)
        nxt = jnp.minimum(
            _relax_next(cfr_row + new_lo[None], lo_k, lo_s, nvalid, P),
            _relax_next(cfr_row + new_hi[None], hi_k, hi_s, nvalid, P),
        )
        return nxt, (new_lo, new_hi, mm, cfr_row)

    xs = (
        g.node_valid, g.lo_kind, g.lo_slot, g.hi_kind, g.hi_slot,
        lo, hi, omega_arr, alpha, din_lo, din_hi, g.layer_valid, cft_next,
        root_rows(g),
    )
    _, (new_lo, new_hi, new_mm, cfr) = jax.lax.scan(step, cfr0, xs)
    return new_lo, new_hi, new_mm, cfr


def bucket_backward_iteration(
    g: BucketGeom,
    lo: jnp.ndarray,
    hi: jnp.ndarray,
    cfr: jnp.ndarray,
    omega,
    din_lo: jnp.ndarray,
    din_hi: jnp.ndarray,
    alpha=None,
):
    if alpha is None:
        alpha = g.alpha
    alpha = jnp.broadcast_to(alpha, lo.shape).astype(lo.dtype)
    din_lo = din_lo.astype(lo.dtype)
    din_hi = din_hi.astype(lo.dtype)
    P = g.P
    omega_arr = jnp.broadcast_to(jnp.asarray(omega, dtype=lo.dtype), lo.shape)

    def step(cft_next, xs):
        (nvalid, lo_k, lo_s, hi_k, hi_s, lo_row, hi_row, om, al, dlo, dhi, lval, cfr_row) = xs
        t_lo = _child_cft(lo_k, lo_s, cft_next, P)
        t_hi = _child_cft(hi_k, hi_s, cft_next, P)
        lo_path = jnp.where(nvalid, cfr_row + lo_row[None] + t_lo, INF)
        hi_path = jnp.where(nvalid, cfr_row + hi_row[None] + t_hi, INF)
        m0 = jnp.min(lo_path, axis=0)
        m1 = jnp.min(hi_path, axis=0)
        new_lo, new_hi, mm = _hop_cost_update(lo_row, hi_row, m0, m1, om, al, dlo, dhi, lval)
        cft_row = jnp.where(
            nvalid, jnp.minimum(new_lo[None] + t_lo, new_hi[None] + t_hi), INF
        )
        return cft_row, (new_lo, new_hi, mm, cft_row)

    xs = (
        g.node_valid, g.lo_kind, g.lo_slot, g.hi_kind, g.hi_slot,
        lo, hi, omega_arr, alpha, din_lo, din_hi, g.layer_valid, cfr,
    )
    init = jnp.full((P, g.B), INF, dtype=lo.dtype)
    _, (new_lo, new_hi, new_mm, cft) = jax.lax.scan(step, init, xs, reverse=True)
    return new_lo, new_hi, new_mm, cft


# --------------------------------------------------------------- global ops
def _exchange_ids(geom: UniformGeom) -> jnp.ndarray:
    return jnp.concatenate([g.layer_var.ravel() for g in geom.buckets])


USE_PERM_EXCHANGE = os.environ.get("BDD_TPU_PERM_EXCHANGE", "1") != "0"

# POLICY: float64 configs keep the segment-sum exchange by default so every
# f64 run on the CPU stays bit-identical to the numpy oracle (the f64 path is
# the correctness anchor of the whole test suite; the permutation exchange
# reassociates the per-variable sums). On a GPU, segment_sum is an atomic
# scatter whose summation order varies, so there f64 matches the oracle to
# rounding (relative 1e-9 is checked), not bit for bit. Opt in to the
# permutation exchange for f64 runs where bit-parity with the oracle is not
# required:
_PERM_EXCHANGE_F64 = os.environ.get("BDD_TPU_PERM_EXCHANGE_F64", "0") == "1"


def _perm_exchange_ok(dtype) -> bool:
    return dtype == jnp.float32 or (_PERM_EXCHANGE_F64 and dtype == jnp.float64)

# Benes routing (solver/benes.py): correct, 10x fewer passes than the
# bitonic sort in theory, but slower than `lax.sort` end to end where it was
# measured (not measured on the H100). Behind BDD_TPU_BENES=1, default off.
_BENES_MODE = os.environ.get("BDD_TPU_BENES", "0")


def _use_benes() -> bool:
    return _BENES_MODE == "1"


def _exchange_perm(
    plan: ExchangePlan, mm_flat: jnp.ndarray, delta_reduce=None
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Static-permutation exchange: sort into the [C, Vx] layout, dense sum
    over C (+ dense per-class reshape-folds for heavy variables), broadcast
    back, inverse sort. Returns flat (din_lo, din_hi) [E]; entries at invalid
    slots are unspecified (consumers mask by layer_valid / alpha=0)."""
    E = mm_flat.shape[0]
    N = plan.key_fwd.shape[0]
    CV = plan.C * plan.Vx
    use_benes = plan.benes_fwd is not None
    Nfull = plan.benes_fwd[0].shape[0] if use_benes else N
    mm_p = mm_flat
    if Nfull > E:
        mm_p = jnp.concatenate(
            [mm_flat, jnp.zeros((Nfull - E,), dtype=mm_flat.dtype)]
        )
    # single-payload routing: the (lo, hi) contributions are both derived
    # from mm, so permute mm once and split afterwards
    if use_benes:
        from bdd_tpu.solver import benes as bn

        (mm_s,) = bn.apply_network_jax(plan.benes_dists, plan.benes_fwd, (mm_p,))
    else:
        _, mm_s = jax.lax.sort((plan.key_fwd, mm_p), num_keys=1)
    mm_cv = mm_s[:CV].reshape(plan.C, plan.Vx)
    # stacked (lo, hi) glue: every fold/concat/broadcast below runs ONCE on a
    # [2, ...] array instead of twice — on small instances the dense glue
    # chain is bound by its op count, so halving the op count matters more
    # than the negligible extra arithmetic
    d_col = jnp.stack(
        [
            jnp.sum(jnp.maximum(-mm_cv, 0.0), axis=0),
            jnp.sum(jnp.maximum(mm_cv, 0.0), axis=0),
        ]
    )  # [2, Vx] per-column (lo, hi)
    # per-variable totals: light variables ARE their primary column; each
    # heavy class folds its [2, nv, W] block densely (no scatter)
    d_parts = [d_col[:, : plan.Vp]]
    for base, w, nv in plan.classes:
        d_parts.append(d_col[:, base : base + nv * w].reshape(2, nv, w).sum(2))
    if plan.split_len or plan.class_shared_counts:
        # SPLIT plan: only the globally-shared region participates in the
        # consensus — private variables' sums are already complete locally.
        # Shared virtual ids are a contiguous TAIL range, so (a) the shared
        # light variables are a dense slice of the primary region and (b)
        # every class's members sort ascending = [private..., shared...],
        # making each class's shared totals a dense tail slice too. The
        # psum rides one concat of those slices — NO scatter/gather
        # anywhere (an earlier scatter-merged variant spent more time in
        # the [2, nv_heavy] scatter pair than it saved in sort volume).
        if delta_reduce is not None:
            b, nsh = plan.split_base, plan.split_len
            merged = d_parts[0]
            send = [merged[:, b : b + nsh]]
            for t, sc in zip(d_parts[1:], plan.class_shared_counts):
                if sc:
                    send.append(t[:, t.shape[1] - sc :])
            packed = delta_reduce(jnp.concatenate(send, axis=1).T).T
            merged = jnp.concatenate(
                [merged[:, :b], packed[:, :nsh], merged[:, b + nsh :]],
                axis=1,
            )
            new_parts = [merged]
            off = nsh
            for t, sc in zip(d_parts[1:], plan.class_shared_counts):
                if sc:
                    t = jnp.concatenate(
                        [t[:, : t.shape[1] - sc], packed[:, off : off + sc]],
                        axis=1,
                    )
                    off += sc
                new_parts.append(t)
            d_parts = new_parts
        # delta_reduce None (single-device timing/inspection): totals are
        # already per-variable-complete locally; nothing to merge.
    elif plan.Vg:
        # windowed (sharded) plan: merge class totals into the window
        # vector (tiny static scatter-add), place it into the [2, Vg]
        # global vector for the cross-shard reduce, slice it back, and
        # read the class totals back out with one gather
        merged = d_parts[0]
        if plan.classes:
            cls = jnp.concatenate(d_parts[1:], axis=1)  # [2, sum nv]
            merged = merged.at[:, plan.class_members].add(cls)
        if delta_reduce is not None and plan.stretch_globals is not None:
            # two-region merge: window slice placed densely, the compacted
            # stretcher region scatter-added at its global variable ids
            # (G is small — the whole point of the split), psum, then both
            # regions read back. A variable can legally appear in BOTH
            # regions (inside this shard's window but another shard's
            # stretcher set): each shard routes its occurrences to exactly
            # one copy, the gvec sums them, and both read-backs see the
            # full cross-shard total.
            G = plan.stretch_globals.shape[0]
            win = merged[:, : plan.stretch_base]
            st = merged[:, plan.stretch_base : plan.stretch_base + G]
            gvec = jnp.zeros((2, plan.Vg), dtype=merged.dtype)
            gvec = jax.lax.dynamic_update_slice(
                gvec, win, (jnp.int32(0), plan.window_lo)
            )
            gvec = gvec.at[:, plan.stretch_globals].add(st)
            gvec = delta_reduce(gvec.T).T
            win = jax.lax.dynamic_slice(
                gvec, (jnp.int32(0), plan.window_lo), win.shape
            )
            merged = jnp.concatenate(
                [win, gvec[:, plan.stretch_globals],
                 merged[:, plan.stretch_base + G :]],
                axis=1,
            )
        elif delta_reduce is not None:
            gvec = jnp.zeros((2, plan.Vg), dtype=merged.dtype)
            gvec = jax.lax.dynamic_update_slice(
                gvec, merged, (jnp.int32(0), plan.window_lo)
            )
            gvec = delta_reduce(gvec.T).T
            merged = jax.lax.dynamic_slice(
                gvec, (jnp.int32(0), plan.window_lo), merged.shape
            )
        d_parts = [merged]
        if plan.classes:
            cls_tot = merged[:, plan.class_members]  # [2, sum nv]
            off = 0
            for base, w, nv in plan.classes:
                d_parts.append(cls_tot[:, off : off + nv])
                off += nv
    elif delta_reduce is not None:
        sizes = [p.shape[1] for p in d_parts]
        d = delta_reduce(jnp.concatenate(d_parts, axis=1).T)  # [sum, 2]
        d = d.T
        d_parts, off = [], 0
        for s in sizes:
            d_parts.append(d[:, off : off + s])
            off += s
    # broadcast back: primary region verbatim, class blocks as dense repeats
    w_parts = [d_parts[0]]
    for (base, w, nv), p in zip(plan.classes, d_parts[1:]):
        w_parts.append(
            jnp.broadcast_to(p[:, :, None], (2, nv, w)).reshape(2, nv * w)
        )
    tail = plan.Vx - plan.Vp - sum(w * nv for _, w, nv in plan.classes)
    if tail:
        w_parts.append(jnp.zeros((2, tail), dtype=mm_flat.dtype))
    d_all = jnp.concatenate(w_parts, axis=1) if len(w_parts) > 1 else w_parts[0]
    t = jnp.broadcast_to(d_all[:, None, :], (2, plan.C, plan.Vx)).reshape(2, CV)
    t_lo, t_hi = t[0], t[1]
    if Nfull > CV:
        pad = jnp.zeros((Nfull - CV,), dtype=mm_flat.dtype)
        t_lo = jnp.concatenate([t_lo, pad])
        t_hi = jnp.concatenate([t_hi, pad])
    if use_benes:
        din_lo, din_hi = bn.apply_network_jax(
            plan.benes_dists, plan.benes_inv, (t_lo, t_hi)
        )
    else:
        _, din_lo, din_hi = jax.lax.sort((plan.key_inv, t_lo, t_hi), num_keys=1)
    return din_lo[:E], din_hi[:E]


def exchange_delta(
    geom: UniformGeom, def_mm: Tuple[jnp.ndarray, ...], delta_reduce=None
) -> Tuple[Tuple[jnp.ndarray, ...], Tuple[jnp.ndarray, ...]]:
    """Full delta consensus: fused scatter + fused gather. Returns per-bucket
    pre-gathered (din_lo, din_hi) [H, B] arrays. ``delta_reduce`` (sharded
    path) is applied once to the stacked [V+1, 2] (segment path) or [Vp, 2]
    (permutation path) sums — a psum is shape-agnostic over both."""
    mm_flat = jnp.concatenate([m.ravel() for m in def_mm])
    if (
        USE_PERM_EXCHANGE
        and geom.exchange is not None
        and _perm_exchange_ok(mm_flat.dtype)
    ):
        din_lo_f, din_hi_f = _exchange_perm(geom.exchange, mm_flat, delta_reduce)
        out_lo, out_hi = [], []
        off = 0
        for g in geom.buckets:
            n = g.H * g.B
            out_lo.append(din_lo_f[off : off + n].reshape(g.H, g.B))
            out_hi.append(din_hi_f[off : off + n].reshape(g.H, g.B))
            off += n
        return tuple(out_lo), tuple(out_hi)
    ids = _exchange_ids(geom)
    contrib = jnp.stack(
        [jnp.maximum(-mm_flat, 0.0), jnp.maximum(mm_flat, 0.0)], axis=-1
    )
    dsum = jax.ops.segment_sum(contrib, ids, num_segments=geom.V + 1)
    dsum = dsum.at[geom.V].set(0.0)
    if delta_reduce is not None:
        dsum = delta_reduce(dsum)
    din = dsum[ids]  # [E, 2] — the single fused gather
    out_lo, out_hi = [], []
    off = 0
    for g in geom.buckets:
        n = g.H * g.B
        out_lo.append(din[off : off + n, 0].reshape(g.H, g.B))
        out_hi.append(din[off : off + n, 1].reshape(g.H, g.B))
        off += n
    return tuple(out_lo), tuple(out_hi)


def _sweep_fns(g, dtype):
    """The bucket's half-sweep pair: the fused GPU kernels where
    ``pallas_uniform.enabled`` admits the bucket, the XLA scan otherwise."""
    from bdd_tpu.solver import pallas_uniform as pu

    if pu.enabled(g, dtype):
        return (
            pu.bucket_forward_iteration_pallas,
            pu.bucket_backward_iteration_pallas,
        )
    return xla_sweep_fns(g, dtype)


def xla_sweep_fns(g, dtype):
    """The XLA scan half-sweeps, whatever the backend."""
    return bucket_forward_iteration, bucket_backward_iteration


def iteration(
    geom: UniformGeom, state: UniformState, omega=0.5, delta_reduce=None,
    sweeps=_sweep_fns,
) -> UniformState:
    """One full dual MMA iteration over all buckets.

    ``delta_reduce``: optional callable applied to the stacked [V+1, 2] delta
    sums before redistribution — the sharded path passes a psum here.
    ``sweeps``: (bucket, dtype) -> (forward, backward) half-sweep pair; the
    default picks per bucket, a caller comparing the two paths fixes one."""
    din_lo, din_hi = exchange_delta(geom, state.def_mm, delta_reduce)
    new_lo, new_hi, new_mm, cfrs = [], [], [], []
    for g, lo, hi, cft, dl, dh in zip(
        geom.buckets, state.lo, state.hi, state.cft, din_lo, din_hi
    ):
        fwd, _ = sweeps(g, lo.dtype)
        nl, nh, mm, cfr = fwd(g, lo, hi, cft, omega, dl, dh)
        new_lo.append(nl)
        new_hi.append(nh)
        new_mm.append(mm)
        cfrs.append(cfr)
    state = UniformState(tuple(new_lo), tuple(new_hi), tuple(new_mm), state.cft)

    din_lo, din_hi = exchange_delta(geom, state.def_mm, delta_reduce)
    new_lo, new_hi, new_mm, cfts = [], [], [], []
    for g, lo, hi, cfr, dl, dh in zip(
        geom.buckets, state.lo, state.hi, cfrs, din_lo, din_hi
    ):
        _, bwd = sweeps(g, lo.dtype)
        nl, nh, mm, cft = bwd(g, lo, hi, cfr, omega, dl, dh)
        new_lo.append(nl)
        new_hi.append(nh)
        new_mm.append(mm)
        cfts.append(cft)
    return UniformState(tuple(new_lo), tuple(new_hi), tuple(new_mm), tuple(cfts))


@functools.partial(jax.jit, static_argnames=("n", "sweeps"))
def iterations(
    geom: UniformGeom, state: UniformState, n: int, omega=0.5,
    sweeps=_sweep_fns,
) -> UniformState:
    # NOTE a "lazy exchange" variant (one consensus per iteration, backward
    # half accumulating into the deferred ledger) was tried to halve the
    # dominant exchange cost: the bound stays valid but the dynamics stall
    # far short of the converged dual (grid 8x8x4: -85.97 vs -72.66) — each
    # half-sweep needs FRESH consensus. Do not revisit without a damping fix.
    def body(s, _):
        return iteration(geom, s, omega, sweeps=sweeps), ()

    state, _ = jax.lax.scan(body, state, None, length=n)
    return state


def lower_bound_from_cft(geom: UniformGeom, cft: Tuple[jnp.ndarray, ...]) -> jnp.ndarray:
    """Sum of per-BDD root costs. Selective precision: when x64 is enabled
    the accumulation runs in float64 even for f32 solvers (one tiny reduction
    per termination check while the sweeps stay f32); without x64 XLA's tree
    reduction already keeps the f32 error at ~eps*log2(B). Cast back to the
    state dtype either way."""
    acc_t = jnp.float64 if jax.config.jax_enable_x64 else cft[0].dtype
    lb = jnp.asarray(0.0, dtype=acc_t)
    for g, c in zip(geom.buckets, cft):
        if g.root_mask is None:
            root = c[0, 0, :]  # root slot 0, hop 0
            lb = lb + jnp.sum(
                jnp.where(g.layer_valid[0], root, 0.0), dtype=acc_t
            )
        else:  # packed columns: one root (slot 0) per segment start row
            lb = lb + jnp.sum(
                jnp.where(g.root_mask, c[:, 0, :], 0.0), dtype=acc_t
            )
    return lb.astype(cft[0].dtype)


def distribute_delta(geom: UniformGeom, state: UniformState, delta_reduce=None) -> UniformState:
    if delta_reduce is None:
        return _distribute_delta_jit(geom, state)
    return _distribute_delta_impl(geom, state, delta_reduce)


@jax.jit
def _distribute_delta_jit(geom: UniformGeom, state: UniformState) -> UniformState:
    return _distribute_delta_impl(geom, state, None)


def _distribute_delta_impl(geom: UniformGeom, state: UniformState, delta_reduce=None) -> UniformState:
    din_lo, din_hi = exchange_delta(geom, state.def_mm, delta_reduce)
    lo_l, hi_l, mm_l, cft_l = [], [], [], []
    for g, lo, hi, dl, dh in zip(geom.buckets, state.lo, state.hi, din_lo, din_hi):
        nl = lo + g.alpha * dl
        nh = hi + g.alpha * dh
        nl = jnp.where(g.layer_valid, nl, 0.0)
        nh = jnp.where(g.layer_valid, nh, 0.0)
        lo_l.append(nl)
        hi_l.append(nh)
        mm_l.append(jnp.zeros_like(lo))
        cft_l.append(bucket_backward_run(g, nl, nh))
    return UniformState(tuple(lo_l), tuple(hi_l), tuple(mm_l), tuple(cft_l))


@jax.jit
def lower_bound_with_deferred(geom: UniformGeom, state: UniformState) -> jnp.ndarray:
    s = distribute_delta(geom, state)
    return lower_bound_from_cft(geom, s.cft)


@jax.jit
def lower_bound(geom: UniformGeom, state: UniformState) -> jnp.ndarray:
    return lower_bound_from_cft(geom, state.cft)


@jax.jit
def min_marginals_all(geom: UniformGeom, state: UniformState):
    return tuple(
        bucket_min_marginals(g, lo, hi, cft)
        for g, lo, hi, cft in zip(
            geom.buckets, state.lo, state.hi, state.cft
        )
    )


# --------------------------------------------------- solutions & dual algebra
@jax.jit
def bdds_solution(geom: UniformGeom, state: UniformState):
    """Per-layer 0/1 argmin-path choices, per bucket [H, B] int8 (bucketed
    formulation of bdds_solution_cuda, bdd_cuda_base.cu:1104-1233): every
    bucket advances all its BDDs' path pointers one hop per scan step."""
    out = []
    for g, lo, hi, cft in zip(geom.buckets, state.lo, state.hi, state.cft):
        P = g.P
        cft_next = jnp.concatenate(
            [cft[1:], jnp.full((1, P, g.B), INF, dtype=lo.dtype)], axis=0
        )
        active0 = jnp.zeros((g.B,), dtype=jnp.int32)  # root slot 0

        def step(active, xs):
            (nvalid, lo_k, lo_s, hi_k, hi_s, lo_row, hi_row, cftn) = xs
            onehot = (
                jax.lax.broadcasted_iota(jnp.int32, (P, 1), 0) == active[None, :]
            )  # [P, B]

            def pick(x):
                return jnp.sum(jnp.where(onehot, x, 0), axis=0)

            t_lo = _child_cft(lo_k, lo_s, cftn, P)
            t_hi = _child_cft(hi_k, hi_s, cftn, P)
            v_lo = lo_row + pick(jnp.where(nvalid, t_lo, INF))
            v_hi = hi_row + pick(jnp.where(nvalid, t_hi, INF))
            take_hi = v_hi <= v_lo
            nxt_slot = jnp.where(
                take_hi, pick(hi_s), pick(lo_s)
            ).astype(jnp.int32)
            kind = jnp.where(take_hi, pick(hi_k), pick(lo_k))
            nxt = jnp.where(kind == ARC_INTERNAL, nxt_slot, 0)
            return nxt, take_hi.astype(jnp.int8)

        xs = (g.node_valid, g.lo_kind, g.lo_slot, g.hi_kind, g.hi_slot, lo, hi, cft_next)
        _, sol = jax.lax.scan(step, active0, xs)
        out.append(jnp.where(g.layer_valid, sol, 0))
    return tuple(out)


def update_costs_per_var(
    geom: UniformGeom, state: UniformState, lo_u: jnp.ndarray, hi_u: jnp.ndarray
) -> UniformState:
    """Add per-variable cost deltas [V+1] (sentinel last) split by the
    isotropic weights, refreshing the backward run (ref: update_costs,
    bdd_cuda_base.cu:1397-1437). The single source for the cost-update
    semantics — the wrapper's update_costs and the device rounding's
    perturbation both route here."""
    lo_l, hi_l, cft_l = [], [], []
    for g, lo, hi in zip(geom.buckets, state.lo, state.hi):
        nl = jnp.where(g.layer_valid, lo + g.alpha * lo_u[g.layer_var], 0.0)
        nh = jnp.where(g.layer_valid, hi + g.alpha * hi_u[g.layer_var], 0.0)
        lo_l.append(nl)
        hi_l.append(nh)
        cft_l.append(bucket_backward_run(g, nl, nh))
    return UniformState(tuple(lo_l), tuple(hi_l), state.def_mm, tuple(cft_l))


@functools.partial(jax.jit, static_argnames=("delta_reduce",))
def net_solver_costs(geom: UniformGeom, state: UniformState, delta_reduce=None):
    """Per-layer net costs x = hi - lo + deferred share, per bucket [H, B]
    (ref: bdd_parallel_mma_base.cpp:1285-1327). ``delta_reduce``: cross-shard
    reduction of the stacked delta (sharded L-BFGS)."""
    din_lo, din_hi = exchange_delta(geom, state.def_mm, delta_reduce)

    def diff(dl, dh):
        # a variable forced BOTH ways (infeasible) has dl = dh = +inf;
        # inf - inf would inject NaN into the L-BFGS history — treat the
        # deferred share as 0 (the run loop stops on the inf lower bound)
        return jnp.where(
            jnp.isfinite(dh) & jnp.isfinite(dl), dh - dl,
            jnp.where(jnp.isfinite(dl), INF,
                      jnp.where(jnp.isfinite(dh), -INF, 0.0)),
        )

    return tuple(
        jnp.where(g.layer_valid, hi - lo + g.alpha * diff(dl, dh), 0.0)
        for g, lo, hi, dl, dh in zip(
            geom.buckets, state.lo, state.hi, din_lo, din_hi
        )
    )


@functools.partial(jax.jit, static_argnames=("sum_reduce",))
def make_dual_feasible(geom: UniformGeom, gs, sum_reduce=None):
    """Zero-sum projection per primal variable
    (ref: bdd_parallel_mma_base.cpp:1349-1369). ``sum_reduce``: cross-shard
    reduction of the per-variable sums (psum under shard_map)."""
    V = geom.V
    ids = _exchange_ids(geom)
    flat = jnp.concatenate(
        [jnp.where(g.layer_valid, x, 0.0).ravel() for g, x in zip(geom.buckets, gs)]
    )
    sums = jax.ops.segment_sum(flat, ids, num_segments=V + 1).at[V].set(0.0)
    if sum_reduce is not None:
        sums = sum_reduce(sums)
    gathered = sums[ids]
    out = []
    off = 0
    for g, x in zip(geom.buckets, gs):
        n = g.H * g.B
        proj = jnp.where(
            g.layer_valid,
            x - g.alpha * gathered[off : off + n].reshape(g.H, g.B),
            0.0,
        )
        out.append(proj)
        off += n
    return tuple(out)


@jax.jit
def gradient_step(geom: UniformGeom, state: UniformState, gs, step_size):
    """hi += step * g (ref: bdd_parallel_mma_base.cpp:1371-1396)."""
    hi_l, cft_l = [], []
    for g, lo, hi, x in zip(geom.buckets, state.lo, state.hi, gs):
        nh = hi + jnp.where(g.layer_valid, step_size * x, 0.0)
        hi_l.append(nh)
        cft_l.append(bucket_backward_run(g, lo, nh))
    return state._replace(hi=tuple(hi_l), cft=tuple(cft_l))
