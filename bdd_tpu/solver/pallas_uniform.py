"""Fused bucket half-sweep kernels for NVIDIA GPUs (Pallas, Triton route).

The XLA path (``uniform.bucket_forward_iteration`` /
``bucket_backward_iteration``) runs a half-sweep as a ``lax.scan`` over the H
hops of a bucket, which on a GPU is a loop of small kernel launches per hop,
each re-reading and re-writing [P, B] rows through device memory. These
kernels run a bucket's whole half-sweep in one launch:

- one BDD column per thread; a program owns a power-of-two tile of columns
  (BDDs are independent within a half-sweep);
- the hop loop runs inside the program (``lax.fori_loop``); each hop loads
  the geometry and cost rows of its columns (coalesced along B) and writes
  the hop's outputs, while the P-slot frontier stays in registers;
- refs are the full [H, P, B] / [H, B] arrays, indexed per hop, so every
  tensor Triton sees is a [tile] vector (a power of two) whatever H is.

There is no matrix product here, so no tensor-core (TF32) rounding arises;
results differ from the XLA path only where the two compilers contract or
reorder f32 adds differently. BIG stands in for ±inf inside the kernels
(inf arithmetic is avoided); costs are mapped inf -> BIG on load and
BIG -> inf on store.

Interpret mode is never chosen here: only a caller that asks for it (the CPU
tests) gets it, through ``interpret=True``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from bdd_tpu.solver.uniform import (
    ARC_BOT,
    ARC_INTERNAL,
    ARC_TOP,
    BucketGeom,
    root_rows,
)

BIG = 1e30  # stand-in for +inf inside kernels (inf arithmetic is avoided)
MAX_P = 8  # the frontier's P x P selects stay in registers up to here


def enabled(g: BucketGeom, dtype) -> bool:
    """The kernels serve f32 buckets of slot width <= MAX_P on a GPU; every
    other bucket takes the XLA scan path."""
    return (
        jax.default_backend() == "gpu"
        and dtype == jnp.float32
        and g.P <= MAX_P
    )


def _tile(B: int) -> int:
    """Columns per program: a power of two. Prefer at least two programs
    per SM of an H100 (132 SMs) so that small buckets still spread over the
    card; no tile is smaller than one warp or larger than 256 columns."""
    bt = 256
    while bt > 32 and B < 2 * 132 * bt:
        bt //= 2
    return bt


def _compiler_params(bt: int):
    return plgpu.CompilerParams(num_warps=max(1, bt // 32), num_stages=1)


def _prep(x):
    """inf -> BIG on load (NaN stays NaN: masking a NaN to 0 would silently
    diverge from the XLA path, which propagates it to the bound)."""
    return jnp.where(x >= BIG, BIG, jnp.where(x <= -BIG, -BIG, x))


def _clean(x):
    """BIG -> inf on store."""
    return jnp.where(
        x >= BIG / 2, jnp.inf, jnp.where(x <= -BIG / 2, -jnp.inf, x)
    )


def _hop_update(lo_row, hi_row, m0, m1, omega_row, alpha_row, dlo, dhi, lval):
    """Cost update on [BT] rows; mirrors uniform._hop_cost_update with BIG
    standing in for inf."""
    fin0 = m0 < BIG / 2
    fin1 = m1 < BIG / 2
    both = fin0 & fin1
    mm_rm = jnp.where(both, omega_row * (m1 - m0), 0.0)
    # forcing deltas (|din| >= BIG/2, the inf stand-in) must NOT be scaled by
    # alpha: alpha*BIG for a variable in >=3 BDDs drops below the BIG/2
    # finiteness threshold and the forcing silently stops propagating —
    # re-add them additively, exactly like uniform._hop_cost_update's
    # double-where does for real infinities
    dfin0 = jnp.abs(dlo) < BIG / 2
    dfin1 = jnp.abs(dhi) < BIG / 2
    c_lo = alpha_row * jnp.where(dfin0, dlo, 0.0) + jnp.where(dfin0, 0.0, dlo)
    c_hi = alpha_row * jnp.where(dfin1, dhi, 0.0) + jnp.where(dfin1, 0.0, dhi)
    new_lo = jnp.where(fin0, lo_row - jnp.maximum(-mm_rm, 0.0), BIG) + c_lo
    new_hi = jnp.where(fin1, hi_row - jnp.maximum(mm_rm, 0.0), BIG) + c_hi
    def_mm = jnp.where(both, mm_rm, jnp.where(fin1, -BIG, BIG))
    new_lo = jnp.where(lval, jnp.minimum(new_lo, BIG), 0.0)
    new_hi = jnp.where(lval, jnp.minimum(new_hi, BIG), 0.0)
    def_mm = jnp.where(lval, def_mm, 0.0)
    return new_lo, new_hi, def_mm


def _child_cft(kind, slot, cft_next):
    """cft of the child of one slot's arc; operands are [BT] rows, the slot
    axis is a Python list (one-hot select over P)."""
    gathered = jnp.zeros_like(cft_next[0])
    for k, c in enumerate(cft_next):
        gathered = jnp.where(slot == k, c, gathered)
    return jnp.where(
        kind == ARC_TOP, 0.0, jnp.where(kind == ARC_BOT, BIG, gathered)
    )


def _relax(vals, kind, slot, valid):
    """next_cfr[k] = min over source slots p with an internal arc into k."""
    P = len(vals)
    out = []
    for k in range(P):
        acc = jnp.full_like(vals[0], BIG)
        for p in range(P):
            mask = (slot[p] == k) & (kind[p] == ARC_INTERNAL) & valid[p]
            acc = jnp.minimum(acc, jnp.where(mask, vals[p], BIG))
        out.append(acc)
    return out


def _node(ref, h, cols, P):
    """Hop h's [P] slot rows of an [H, P, B] ref, for the program's columns."""
    return [ref[h, p, cols] for p in range(P)]


def _geometry(geo_refs, h, cols, P):
    """(node valid, lo kind, lo slot, hi kind, hi slot) slot rows of hop h."""
    nv, *arcs = (_node(r, h, cols, P) for r in geo_refs)
    return ([v != 0 for v in nv], *arcs)


def _row(ref, h, cols, per_layer):
    return ref[h, cols] if per_layer else ref[0]


def _min_marginals(cfr, lo_row, hi_row, t_lo, t_hi, nvalid):
    m0 = jnp.full_like(lo_row, BIG)
    m1 = jnp.full_like(lo_row, BIG)
    for p in range(len(cfr)):
        m0 = jnp.minimum(m0, jnp.where(nvalid[p], cfr[p] + lo_row + t_lo[p], BIG))
        m1 = jnp.minimum(m1, jnp.where(nvalid[p], cfr[p] + hi_row + t_hi[p], BIG))
    return jnp.minimum(m0, BIG), jnp.minimum(m1, BIG)


def _forward_kernel(
    P, H, BT, omega_per_layer,
    nv_ref, lok_ref, los_ref, hik_ref, his_ref,
    lo_ref, hi_ref, cft_ref, dlo_ref, dhi_ref, alpha_ref, lval_ref, root_ref,
    omega_ref,
    out_lo_ref, out_hi_ref, out_mm_ref, out_cfr_ref,
):
    cols = pl.ds(pl.program_id(0) * BT, BT)
    geo_refs = (nv_ref, lok_ref, los_ref, hik_ref, his_ref)

    def body(h, cfr):
        # root restart (column packing): exact, since the carry entering a
        # restart row is all-BIG (the previous BDD's last layer has only
        # terminal arcs); also provides the hop-0 init (roots sit at slot 0)
        root = root_ref[h, cols] != 0
        cfr = [jnp.where(root, 0.0 if p == 0 else BIG, c) for p, c in enumerate(cfr)]
        nvalid, lo_k, lo_s, hi_k, hi_s = _geometry(geo_refs, h, cols, P)
        lo_row = _prep(lo_ref[h, cols])
        hi_row = _prep(hi_ref[h, cols])
        last = h == H - 1
        hn = jnp.minimum(h + 1, H - 1)
        cft_next = [jnp.where(last, BIG, _prep(c)) for c in _node(cft_ref, hn, cols, P)]
        t_lo = [_child_cft(lo_k[p], lo_s[p], cft_next) for p in range(P)]
        t_hi = [_child_cft(hi_k[p], hi_s[p], cft_next) for p in range(P)]
        m0, m1 = _min_marginals(cfr, lo_row, hi_row, t_lo, t_hi, nvalid)
        new_lo, new_hi, mm = _hop_update(
            lo_row, hi_row, m0, m1, _row(omega_ref, h, cols, omega_per_layer),
            alpha_ref[h, cols], _prep(dlo_ref[h, cols]), _prep(dhi_ref[h, cols]),
            lval_ref[h, cols] != 0,
        )
        out_lo_ref[h, cols] = _clean(new_lo)
        out_hi_ref[h, cols] = _clean(new_hi)
        out_mm_ref[h, cols] = _clean(mm)
        for p in range(P):
            out_cfr_ref[h, p, cols] = _clean(cfr[p])
        nxt_lo = _relax([jnp.minimum(c + new_lo, BIG) for c in cfr], lo_k, lo_s, nvalid)
        nxt_hi = _relax([jnp.minimum(c + new_hi, BIG) for c in cfr], hi_k, hi_s, nvalid)
        return [jnp.minimum(a, b) for a, b in zip(nxt_lo, nxt_hi)]

    init = [jnp.full((BT,), BIG, jnp.float32) for _ in range(P)]
    jax.lax.fori_loop(0, H, body, init)


def _backward_kernel(
    P, H, BT, omega_per_layer,
    nv_ref, lok_ref, los_ref, hik_ref, his_ref,
    lo_ref, hi_ref, cfr_ref, dlo_ref, dhi_ref, alpha_ref, lval_ref,
    omega_ref,
    out_lo_ref, out_hi_ref, out_mm_ref, out_cft_ref,
):
    cols = pl.ds(pl.program_id(0) * BT, BT)
    geo_refs = (nv_ref, lok_ref, los_ref, hik_ref, his_ref)

    def body(i, cft_next):
        h = H - 1 - i
        nvalid, lo_k, lo_s, hi_k, hi_s = _geometry(geo_refs, h, cols, P)
        lo_row = _prep(lo_ref[h, cols])
        hi_row = _prep(hi_ref[h, cols])
        cfr = [_prep(c) for c in _node(cfr_ref, h, cols, P)]
        t_lo = [_child_cft(lo_k[p], lo_s[p], cft_next) for p in range(P)]
        t_hi = [_child_cft(hi_k[p], hi_s[p], cft_next) for p in range(P)]
        m0, m1 = _min_marginals(cfr, lo_row, hi_row, t_lo, t_hi, nvalid)
        new_lo, new_hi, mm = _hop_update(
            lo_row, hi_row, m0, m1, _row(omega_ref, h, cols, omega_per_layer),
            alpha_ref[h, cols], _prep(dlo_ref[h, cols]), _prep(dhi_ref[h, cols]),
            lval_ref[h, cols] != 0,
        )
        out_lo_ref[h, cols] = _clean(new_lo)
        out_hi_ref[h, cols] = _clean(new_hi)
        out_mm_ref[h, cols] = _clean(mm)
        cft = [
            jnp.where(
                nvalid[p],
                jnp.minimum(jnp.minimum(new_lo + t_lo[p], new_hi + t_hi[p]), BIG),
                BIG,
            )
            for p in range(P)
        ]
        for p in range(P):
            out_cft_ref[h, p, cols] = _clean(cft[p])
        return cft

    init = [jnp.full((BT,), BIG, jnp.float32) for _ in range(P)]
    jax.lax.fori_loop(0, H, body, init)


def _pad_cols(x, Bp):
    """Pad the trailing (column) axis to Bp; padded columns are invalid
    (zero valid flags) and sliced off the results."""
    B = x.shape[-1]
    if B == Bp:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, Bp - B)])


def _sweep_call(kernel, g, lo, hi, carry, omega, din_lo, din_hi, alpha,
                extra, interpret):
    H, P, B = g.H, g.P, g.B
    if alpha is None:
        alpha = g.alpha
    bt = _tile(B)
    Bp = -(-B // bt) * bt
    dt = lo.dtype
    omega = jnp.asarray(omega, dt)
    per_layer = omega.ndim > 0
    omega = jnp.broadcast_to(omega, lo.shape) if per_layer else omega.reshape(1)
    pad = functools.partial(_pad_cols, Bp=Bp)
    args = [
        g.node_valid, g.lo_kind, g.lo_slot, g.hi_kind, g.hi_slot,
        lo, hi, carry, din_lo.astype(dt), din_hi.astype(dt),
        jnp.broadcast_to(alpha, lo.shape).astype(dt), g.layer_valid,
    ] + extra
    args = [pad(a) for a in args] + [pad(omega) if per_layer else omega]
    out_shape = (
        jax.ShapeDtypeStruct((H, Bp), dt),
        jax.ShapeDtypeStruct((H, Bp), dt),
        jax.ShapeDtypeStruct((H, Bp), dt),
        jax.ShapeDtypeStruct((H, P, Bp), dt),
    )
    outs = pl.pallas_call(
        functools.partial(kernel, P, H, bt, per_layer),
        grid=(Bp // bt,),
        out_shape=out_shape,
        backend="triton",
        compiler_params=_compiler_params(bt),
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(*args)
    if Bp != B:
        outs = tuple(o[..., :B] for o in outs)
    return outs


def bucket_forward_iteration_pallas(
    g: BucketGeom, lo, hi, cft, omega, din_lo, din_hi, alpha=None, *,
    interpret=False,
):
    """Same contract as ``uniform.bucket_forward_iteration`` (f32)."""
    return _sweep_call(
        _forward_kernel, g, lo, hi, cft, omega, din_lo, din_hi, alpha,
        [root_rows(g)], interpret,
    )


def bucket_backward_iteration_pallas(
    g: BucketGeom, lo, hi, cfr, omega, din_lo, din_hi, alpha=None, *,
    interpret=False,
):
    """Same contract as ``uniform.bucket_backward_iteration`` (f32)."""
    return _sweep_call(
        _backward_kernel, g, lo, hi, cfr, omega, din_lo, din_hi, alpha,
        [], interpret,
    )
