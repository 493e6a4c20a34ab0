"""Parallel-prefix (log-depth) sweeps on the uniform layout.

The plain forward/backward *runs* (no cost updates) are chains of (min,+)
linear maps between consecutive hop frontiers, so they compose associatively:
with the terminal arcs folded into an augmented (P+1)-dimensional transfer
matrix (row = source slot p at hop h, column = destination slot k at hop h+1,
extra column = cheapest TOP-terminal arc, extra absorbing row = the constant)

    M_h[p, k] = cheapest internal arc p -> k
    M_h[p, P] = cheapest terminal arc from p
    M_h[P, :] = [inf, ..., inf, 0]

the suffix (min,+) products give every hop's cost-from-terminal and the prefix
products every hop's cost-from-root in O(log H) sequential depth via
``jax.lax.associative_scan`` — a formulation the sequential CUDA wavefront
cannot exploit, but a vector machine executes natively (each combine is a tiny min-plus
matrix product, vectorized over all BDD columns).

Used for lower bounds and min marginals; the MMA *iteration* itself is
inherently sequential along hops (costs update mid-sweep, Gauss-Seidel) and
keeps the scan/Pallas kernels.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from bdd_tpu.solver.uniform import (
    ARC_INTERNAL,
    ARC_TOP,
    BucketGeom,
    UniformGeom,
    UniformState,
)

INF = jnp.inf
_BIG = 1e30


def _transfer_matrices(g: BucketGeom, lo: jnp.ndarray, hi: jnp.ndarray):
    """Augmented per-hop transfer matrices [H, P+1(p), P+1(k), B]."""
    # packed columns (uniform.pack_uniform_host) would need a restart at each
    # segment-start row, but the affine lane P accumulates finished-path
    # costs across segments — use an unpacked host (flatten_uniform(pack=False))
    assert g.root_mask is None, "prefix sweeps require an unpacked bucket layout"
    P, B, H = g.P, g.B, g.H
    # k runs over axis 2
    iota_k = jax.lax.broadcasted_iota(jnp.int32, (1, 1, P, 1), 2)

    def arc_block(kind, slot, cost_row):
        # [H, P(p), P(k), B]
        m = (
            (slot[:, :, None, :] == iota_k)
            & (kind[:, :, None, :] == ARC_INTERNAL)
            & g.node_valid[:, :, None, :]
        )
        return jnp.where(m, cost_row[:, None, None, :], _BIG)

    A = jnp.minimum(
        arc_block(g.lo_kind, g.lo_slot, lo), arc_block(g.hi_kind, g.hi_slot, hi)
    )
    t_lo = jnp.where((g.lo_kind == ARC_TOP) & g.node_valid, lo[:, None, :], _BIG)
    t_hi = jnp.where((g.hi_kind == ARC_TOP) & g.node_valid, hi[:, None, :], _BIG)
    t = jnp.minimum(t_lo, t_hi)  # [H, P(p), B]
    right_col = t[:, :, None, :]  # [H, P, 1, B]
    bottom = jnp.full((H, 1, P + 1, B), _BIG, dtype=lo.dtype)
    bottom = bottom.at[:, :, P, :].set(0.0)
    M = jnp.concatenate(
        [jnp.concatenate([A, right_col], axis=2), bottom], axis=1
    )  # [H, P+1, P+1, B]
    return M


def _minplus(a, b):
    """(min,+) product contracting a's column index with b's row index:
    (a (x) b)[p, j] = min_k a[p, k] + b[k, j]; shapes [..., p, k, B]."""
    return jnp.min(
        jnp.minimum(a[..., :, :, None, :] + b[..., None, :, :, :], _BIG), axis=-3
    )


def bucket_backward_run_prefix(
    g: BucketGeom, lo: jnp.ndarray, hi: jnp.ndarray, M=None
) -> jnp.ndarray:
    """cost-from-terminal for every hop, [H, P, B], via suffix products
    S_h = M_h (x) M_{h+1} (x) ... (x) M_{H-1}; cft_h = S_h[:, P] (last col)."""
    if M is None:
        M = _transfer_matrices(g, lo, hi)
    # reverse scan combines as fn(later, earlier); we need M_h (x) M_{h+1}
    S = jax.lax.associative_scan(lambda a, b: _minplus(b, a), M, reverse=True, axis=0)
    cft = S[:, : g.P, g.P, :]
    return jnp.where(cft >= _BIG / 2, INF, cft)


def bucket_forward_run_prefix(
    g: BucketGeom, lo: jnp.ndarray, hi: jnp.ndarray, M=None
) -> jnp.ndarray:
    """cost-from-root for every hop, [H, P, B]: cfr as a row vector,
    cfr_{h+1} = cfr_0 (x) (M_0 (x) ... (x) M_h)."""
    if M is None:
        M = _transfer_matrices(g, lo, hi)
    P = g.P
    prefix = jax.lax.associative_scan(_minplus, M, axis=0)  # [H, P+1, P+1, B]
    cfr0 = jnp.where(g.node_valid[0], 0.0, _BIG).astype(lo.dtype)
    cfr0_aug = jnp.concatenate(
        [cfr0, jnp.full((1, g.B), _BIG, dtype=lo.dtype)], axis=0
    )  # [P+1, B]
    # row-vector application: out[h, k] = min_p cfr0_aug[p] + prefix[h, p, k]
    applied = jnp.min(
        jnp.minimum(prefix + cfr0_aug[None, :, None, :], _BIG), axis=1
    )  # [H, P+1, B]
    cfr = jnp.concatenate([cfr0[None], applied[:-1, :P, :]], axis=0)
    return jnp.where(cfr >= _BIG / 2, INF, cfr)


@jax.jit
def lower_bound_prefix(geom: UniformGeom, state: UniformState) -> jnp.ndarray:
    lb = jnp.asarray(0.0, dtype=state.lo[0].dtype)
    for g, lo, hi in zip(geom.buckets, state.lo, state.hi):
        cft = bucket_backward_run_prefix(g, lo, hi)
        root = cft[0, 0, :]
        lb = lb + jnp.sum(jnp.where(g.layer_valid[0], root, 0.0))
    return lb


def bucket_min_marginals_prefix(
    g: BucketGeom, lo: jnp.ndarray, hi: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-layer min marginals via the two log-depth sweeps (one shared
    transfer-matrix build — it is the dominant O(H*P^2*B) term)."""
    from bdd_tpu.solver.uniform import _child_cft

    P = g.P
    M = _transfer_matrices(g, lo, hi)
    cfr = bucket_forward_run_prefix(g, lo, hi, M=M)
    cft = bucket_backward_run_prefix(g, lo, hi, M=M)
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
