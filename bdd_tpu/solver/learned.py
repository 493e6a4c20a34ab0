"""Differentiable learned-MMA iterations (DOGE solver core).

JAX counterpart of the reference's learned CUDA solver (include/bdd_solver/
bdd_cuda_learned_mma.h, src/.../bdd_cuda_learned_mma.cu): MMA iterations
parameterized by per-layer distribution weights alpha (how each variable's
deferred delta is split among its BDD copies; softmax-normalized per variable)
and per-layer damping omega. Instead of the reference's ~1400 lines of
hand-written adjoint kernels with solver_state_cache checkpoint replay
(bdd_cuda_learned_mma.cu:309-1049), the sweeps here are pure JAX scans, so
``jax.grad`` differentiates them directly; ``jax.checkpoint`` on the
per-iteration body reproduces the reference's recompute-from-checkpoint memory
strategy.

Parameters are per-bucket [H, B] arrays matching the uniform layout.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from bdd_tpu.solver import uniform as uf


def isotropic_alpha(geom: uf.UniformGeom) -> Tuple[jnp.ndarray, ...]:
    """1/#bdds-per-var weights (= uniform distribution; the non-learned
    default, ref: bdd_torch_learned_mma.get_isotropic_alpha)."""
    return tuple(g.alpha for g in geom.buckets)


def normalize_alpha(
    geom: uf.UniformGeom, raw: Tuple[jnp.ndarray, ...]
) -> Tuple[jnp.ndarray, ...]:
    """Normalize nonnegative per-layer weights to sum to 1 over each primal
    variable's layers (ref: solver_utils.normalize_distribution_weights)."""
    V = geom.V
    total = jnp.zeros((V + 1,), dtype=raw[0].dtype)
    for g, r in zip(geom.buckets, raw):
        w = jnp.where(g.layer_valid, r, 0.0)
        total = total + jax.ops.segment_sum(
            w.ravel(), g.layer_var.ravel(), num_segments=V + 1
        )
    total = jnp.maximum(total, 1e-30)
    return tuple(
        jnp.where(g.layer_valid, r / total[g.layer_var], 0.0)
        for g, r in zip(geom.buckets, raw)
    )


def learned_iteration(
    geom: uf.UniformGeom,
    state: uf.UniformState,
    alphas: Tuple[jnp.ndarray, ...],
    omegas: Tuple[jnp.ndarray, ...],
    delta_reduce=None,
) -> uf.UniformState:
    """One dual iteration with per-layer (alpha, omega)
    (ref: forward/backward_iteration_learned_mm_dist, bdd_cuda_learned_mma.cu:10-171).
    ``delta_reduce``: optional cross-shard reduction of the stacked [V+1, 2]
    delta (psum under shard_map) — multi-chip learned MMA, beyond the
    reference's single-GPU training."""
    din_lo, din_hi = uf.exchange_delta(geom, state.def_mm, delta_reduce)
    new_lo, new_hi, new_mm, cfrs = [], [], [], []
    for g, lo, hi, cft, al, om, dl, dh in zip(
        geom.buckets, state.lo, state.hi, state.cft, alphas, omegas, din_lo, din_hi
    ):
        nl, nh, mm, cfr = uf.bucket_forward_iteration(
            g, lo, hi, cft, om, dl, dh, alpha=al
        )
        new_lo.append(nl)
        new_hi.append(nh)
        new_mm.append(mm)
        cfrs.append(cfr)
    state = uf.UniformState(
        tuple(new_lo), tuple(new_hi), tuple(new_mm), state.cft
    )
    din_lo, din_hi = uf.exchange_delta(geom, state.def_mm, delta_reduce)
    new_lo, new_hi, new_mm, cfts = [], [], [], []
    for g, lo, hi, cfr, al, om, dl, dh in zip(
        geom.buckets, state.lo, state.hi, cfrs, alphas, omegas, din_lo, din_hi
    ):
        nl, nh, mm, cft = uf.bucket_backward_iteration(
            g, lo, hi, cfr, om, dl, dh, alpha=al
        )
        new_lo.append(nl)
        new_hi.append(nh)
        new_mm.append(mm)
        cfts.append(cft)
    return uf.UniformState(tuple(new_lo), tuple(new_hi), tuple(new_mm), tuple(cfts))


@functools.partial(jax.jit, static_argnames=("n", "delta_reduce"))
def learned_iterations(
    geom: uf.UniformGeom,
    state: uf.UniformState,
    alphas: Tuple[jnp.ndarray, ...],
    omegas: Tuple[jnp.ndarray, ...],
    n: int,
    delta_reduce=None,
) -> uf.UniformState:
    """n differentiable iterations; per-iteration gradient checkpointing
    bounds memory at one iteration's activations (the reference's
    solver_state_cache replay strategy, bdd_cuda_learned_mma.h:8-43)."""

    @jax.checkpoint
    def body(s, _):
        return learned_iteration(geom, s, alphas, omegas, delta_reduce), ()

    state, _ = jax.lax.scan(body, state, None, length=n)
    return state


@functools.partial(
    jax.jit, static_argnames=("n", "history_itr", "delta_reduce")
)
def learned_iterations_with_stats(
    geom: uf.UniformGeom,
    state: uf.UniformState,
    alphas: Tuple[jnp.ndarray, ...],
    omegas: Tuple[jnp.ndarray, ...],
    n: int,
    history_itr: int = 0,
    beta: float = 0.9,
    delta_reduce=None,
):
    """n differentiable iterations ALSO tracking the reference's
    exp-moving-average history features over the last ``history_itr``
    iterations (bdd_cuda_learned_mma.cu:185-270): per-layer solution average
    ``sol_avg`` (edge feature prev_sol_avg) and per-BDD lower-bound first/
    second-order difference averages (con features lb_first_order_avg /
    lb_sec_order_avg). Returns (state, sol_avg, lb_fo_avg, lb_so_avg), the
    stats as per-bucket [H, B] tuples (lb stats live on root rows)."""
    k0 = n - min(history_itr, n)

    def zeros_like_layers(dtype):
        return tuple(jnp.zeros_like(l) for l in state.lo)

    def ema(avg, new, first):
        return jnp.where(first, new, beta * avg + (1.0 - beta) * new)

    def body(carry, i):
        s, sol_avg, lb_prev, fo_prev, fo_avg, so_avg, cnt = carry
        s = learned_iteration(geom, s, alphas, omegas, delta_reduce)
        track = i >= k0
        first = cnt == 0
        sols = uf.bdds_solution(geom, s)
        lbs = per_bdd_lower_bound(geom, s)
        new_sol, new_fo_avg, new_so_avg, new_lb, new_fo = [], [], [], [], []
        for sa, so_l, lb_p, fo_p, fa, sa2, lb_t in zip(
            sol_avg, sols, lb_prev, fo_prev, fo_avg, so_avg, lbs
        ):
            sol_f = so_l.astype(sa.dtype)
            sa_new = ema(sa, sol_f, first)
            fo_t = lb_t - lb_p
            so_t = fo_t - fo_p
            fa_new = ema(fa, fo_t, first)
            sa2_new = ema(sa2, so_t, first)
            new_sol.append(jnp.where(track, sa_new, sa))
            new_fo_avg.append(jnp.where(track, fa_new, fa))
            new_so_avg.append(jnp.where(track, sa2_new, sa2))
            new_lb.append(lb_t)
            new_fo.append(jnp.where(track, fo_t, fo_p))
        cnt = cnt + jnp.where(track, 1, 0)
        return (
            s, tuple(new_sol), tuple(new_lb), tuple(new_fo),
            tuple(new_fo_avg), tuple(new_so_avg), cnt,
        ), ()

    z = zeros_like_layers(state.lo[0].dtype)
    init = (
        state, z, per_bdd_lower_bound(geom, state), z, z, z,
        jnp.asarray(0, jnp.int32),
    )
    (s, sol_avg, _, _, fo_avg, so_avg, _), _ = jax.lax.scan(
        body, init, jnp.arange(n)
    )
    return s, sol_avg, fo_avg, so_avg


def distribute_delta_learned(
    geom: uf.UniformGeom,
    state: uf.UniformState,
    alphas: Tuple[jnp.ndarray, ...],
    delta_reduce=None,
) -> uf.UniformState:
    """Fold deferred deltas with learned weights
    (ref: DistributeDeferredDelta, bdd_cuda_torch.py:184-232)."""
    din_lo, din_hi = uf.exchange_delta(geom, state.def_mm, delta_reduce)
    lo_l, hi_l, mm_l, cft_l = [], [], [], []
    for g, lo, hi, al, dl, dh in zip(
        geom.buckets, state.lo, state.hi, alphas, din_lo, din_hi
    ):
        # double-where: the multiply must never see an infinite primal
        # (forcing deltas, the ±inf def_mm contract) — its VJP would compute
        # cotangent 0 x inf = NaN; the infinity is re-added additively instead
        # (adds pass cotangents through untouched). alpha·inf == inf, so the
        # forward value is unchanged.
        fl, fh = jnp.isfinite(dl), jnp.isfinite(dh)
        dl_c = al * jnp.where(fl, dl, 0.0) + jnp.where(fl, 0.0, dl)
        dh_c = al * jnp.where(fh, dh, 0.0) + jnp.where(fh, 0.0, dh)
        nl = jnp.where(g.layer_valid, lo + dl_c, 0.0)
        nh = jnp.where(g.layer_valid, hi + dh_c, 0.0)
        lo_l.append(nl)
        hi_l.append(nh)
        mm_l.append(jnp.zeros_like(lo))
        cft_l.append(uf.bucket_backward_run(g, nl, nh))
    return uf.UniformState(tuple(lo_l), tuple(hi_l), tuple(mm_l), tuple(cft_l))


def per_bdd_lower_bound(
    geom: uf.UniformGeom, state: uf.UniformState
) -> Tuple[jnp.ndarray, ...]:
    """Per-BDD-root costs of the current cft, per bucket [H, B] (0 away from
    roots; with column packing a column hosts several roots)
    (ref: ComputeLowerBoundperBDD, bdd_cuda_torch.py:339-401)."""
    return tuple(
        jnp.where(uf.root_rows(g), cft[:, 0, :], 0.0)
        for g, cft in zip(geom.buckets, state.cft)
    )


def dual_loss(
    geom: uf.UniformGeom,
    state: uf.UniformState,
    alphas: Tuple[jnp.ndarray, ...],
    omegas: Tuple[jnp.ndarray, ...],
    n: int,
    delta_reduce=None,
) -> jnp.ndarray:
    """-lower_bound after n learned iterations + delta distribution — the
    DOGE training loss (doge.py:356-369)."""
    out = learned_iterations(geom, state, alphas, omegas, n,
                             delta_reduce=delta_reduce)
    out = distribute_delta_learned(geom, out, alphas, delta_reduce)
    lbs = per_bdd_lower_bound(geom, out)
    return -sum(jnp.sum(l) for l in lbs)


def all_min_marginal_differences(
    geom: uf.UniformGeom, state: uf.UniformState
) -> Tuple[jnp.ndarray, ...]:
    """Per-layer mm differences (m1 - m0) per bucket [H, B] (a GNN feature;
    ref: ComputeAllMinMarginalsDiff, bdd_cuda_torch.py:234-277). Infinite
    sides are clamped to +-1e9 for feature stability."""
    out = []
    for g, lo, hi in zip(geom.buckets, state.lo, state.hi):
        m0, m1 = uf.bucket_min_marginals(g, lo, hi)
        d = jnp.where(
            jnp.isfinite(m1) & jnp.isfinite(m0),
            m1 - m0,
            jnp.where(jnp.isfinite(m0), 1e9, -1e9),
        )
        out.append(jnp.where(g.layer_valid, d, 0.0))
    return out and tuple(out)
