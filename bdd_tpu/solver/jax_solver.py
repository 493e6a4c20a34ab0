"""JAX dense hop-scan solver (segment-op backend).

Design (SURVEY.md §7): all BDD nodes at hop distance h across all BDDs form row
h of static [H, W] arrays; the per-hop wavefront relaxation of the reference's
CUDA kernels (bdd_cuda_parallel_mma.cu:59-346, atomicMin scatter) becomes a
``lax.scan`` over rows with deterministic ``segment_min``/``segment_sum`` —
an upgrade over nondeterministic float atomics. Terminal arcs carry flags
(TOP → cost-from-terminal 0, BOT → +inf) instead of pointer sentinels, so no
terminal nodes are materialized on device.

Everything here is functional and jit-compatible: geometry arrays are closure
constants, solver state is a small pytree, iterations run inside ``lax.scan``.

Numerics: float32 by default; float64 available for parity tests
via jax_enable_x64.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bdd_tpu.solver.flatten import ARC_BOT, ARC_INTERNAL, ARC_TOP, DenseBdds

INF = jnp.inf


class DenseGeom(NamedTuple):
    """Static BDD geometry on device. Shapes: nodes [H, W], layers [H, L]."""

    node_valid: jnp.ndarray  # bool [H, W]
    layer_local: jnp.ndarray  # int32 [H, W], pad -> L
    lo_kind: jnp.ndarray  # int8 [H, W]
    lo_next: jnp.ndarray  # int32 [H, W], pad/terminal -> W
    hi_kind: jnp.ndarray
    hi_next: jnp.ndarray
    layer_valid: jnp.ndarray  # bool [H, L]
    layer_var: jnp.ndarray  # int32 [H, L], pad -> V (sentinel delta slot)
    alpha: jnp.ndarray  # [H, L] isotropic distribution weights (1/#bdds(var))
    num_bdds_per_var: jnp.ndarray  # int32 [V]

    @property
    def H(self) -> int:
        return self.node_valid.shape[0]

    @property
    def W(self) -> int:
        return self.node_valid.shape[1]

    @property
    def L(self) -> int:
        return self.layer_valid.shape[1]

    @property
    def V(self) -> int:
        return self.num_bdds_per_var.shape[0]


class SolverState(NamedTuple):
    lo: jnp.ndarray  # [H, L]
    hi: jnp.ndarray  # [H, L]
    def_mm: jnp.ndarray  # [H, L]
    cft: jnp.ndarray  # [H, W] cost-from-terminal of the last backward sweep


def geom_from_dense(dense: DenseBdds, dtype=jnp.float32) -> DenseGeom:
    alpha = np.zeros((dense.H, dense.L), dtype=np.float64)
    lv = dense.layer_var
    valid = dense.layer_valid
    alpha[valid] = 1.0 / dense.num_bdds_per_var[lv[valid]]
    return DenseGeom(
        node_valid=jnp.asarray(dense.node_valid),
        layer_local=jnp.asarray(dense.layer_local, dtype=jnp.int32),
        lo_kind=jnp.asarray(dense.lo_kind, dtype=jnp.int32),
        lo_next=jnp.asarray(dense.lo_next, dtype=jnp.int32),
        hi_kind=jnp.asarray(dense.hi_kind, dtype=jnp.int32),
        hi_next=jnp.asarray(dense.hi_next, dtype=jnp.int32),
        layer_valid=jnp.asarray(dense.layer_valid),
        layer_var=jnp.asarray(dense.layer_var, dtype=jnp.int32),
        alpha=jnp.asarray(alpha, dtype=dtype),
        num_bdds_per_var=jnp.asarray(dense.num_bdds_per_var, dtype=jnp.int32),
    )


def init_state(
    geom: DenseGeom, dense: DenseBdds, objective, dtype=jnp.float32
) -> SolverState:
    obj = np.asarray(objective, dtype=np.float64)
    lo = np.zeros((dense.H, dense.L), dtype=np.float64)
    hi = np.zeros((dense.H, dense.L), dtype=np.float64)
    valid = dense.layer_valid
    lv = dense.layer_var[valid]
    hi[valid] = obj[lv] / dense.num_bdds_per_var[lv]
    state = SolverState(
        lo=jnp.asarray(lo, dtype=dtype),
        hi=jnp.asarray(hi, dtype=dtype),
        def_mm=jnp.zeros((dense.H, dense.L), dtype=dtype),
        cft=jnp.zeros((dense.H, dense.W), dtype=dtype),
    )
    cft = _backward_run_jit(geom, state.lo, state.hi)
    return state._replace(cft=cft)


# ---------------------------------------------------------------- primitives
def _cft_child(geom_row_kind, geom_row_next, cft_next_row):
    """Cost-from-terminal of each node's child along one arc type."""
    padded = jnp.concatenate([cft_next_row, jnp.array([0.0], cft_next_row.dtype)])
    gathered = padded[geom_row_next]
    return jnp.where(
        geom_row_kind == ARC_TOP,
        0.0,
        jnp.where(geom_row_kind == ARC_BOT, INF, gathered),
    )


def _node_cost(cost_row_L, layer_local_row, W_pad_value=0.0):
    padded = jnp.concatenate(
        [cost_row_L, jnp.array([W_pad_value], cost_row_L.dtype)]
    )
    return padded[layer_local_row]


def _scatter_min_next(vals_lo, vals_hi, kinds_lo, kinds_hi, next_lo, next_hi, W):
    """Relax the next hop's frontier: segment-min of arc values over internal
    arc destinations (deterministic replacement of CUDA atomicMin)."""
    dest_lo = jnp.where(kinds_lo == ARC_INTERNAL, next_lo, W)
    dest_hi = jnp.where(kinds_hi == ARC_INTERNAL, next_hi, W)
    vals = jnp.concatenate([vals_lo, vals_hi])
    dests = jnp.concatenate([dest_lo, dest_hi])
    out = jax.ops.segment_min(vals, dests, num_segments=W + 1)
    return out[:W]


# -------------------------------------------------------------------- sweeps
def forward_run(geom: DenseGeom, lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    """Shortest-path costs from root, rows stacked [H, W]."""
    W = geom.W
    cfr0 = jnp.where(geom.node_valid[0], 0.0, INF).astype(lo.dtype)

    def step(cfr_row, xs):
        (valid, llocal, lo_k, lo_n, hi_k, hi_n, lo_row, hi_row) = xs
        c_lo = _node_cost(lo_row, llocal)
        c_hi = _node_cost(hi_row, llocal)
        v_lo = jnp.where(valid, cfr_row + c_lo, INF)
        v_hi = jnp.where(valid, cfr_row + c_hi, INF)
        nxt = _scatter_min_next(v_lo, v_hi, lo_k, hi_k, lo_n, hi_n, W)
        return nxt, cfr_row

    xs = (
        geom.node_valid,
        geom.layer_local,
        geom.lo_kind,
        geom.lo_next,
        geom.hi_kind,
        geom.hi_next,
        lo,
        hi,
    )
    _, cfr = jax.lax.scan(step, cfr0, xs)
    return cfr


def backward_run(geom: DenseGeom, lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    """Shortest-path costs to TOP, rows stacked [H, W]."""

    def step(cft_next, xs):
        (valid, llocal, lo_k, lo_n, hi_k, hi_n, lo_row, hi_row) = xs
        c_lo = _node_cost(lo_row, llocal)
        c_hi = _node_cost(hi_row, llocal)
        t_lo = _cft_child(lo_k, lo_n, cft_next)
        t_hi = _cft_child(hi_k, hi_n, cft_next)
        cft_row = jnp.where(
            valid, jnp.minimum(c_lo + t_lo, c_hi + t_hi), INF
        )
        return cft_row, cft_row

    xs = (
        geom.node_valid,
        geom.layer_local,
        geom.lo_kind,
        geom.lo_next,
        geom.hi_kind,
        geom.hi_next,
        lo,
        hi,
    )
    init = jnp.full((geom.W,), INF, dtype=lo.dtype)
    _, cft = jax.lax.scan(step, init, xs, reverse=True)
    return cft


# shared jit cache across solver constructions (a fresh jax.jit wrapper per
# construction would re-trace identical geometry shapes every time)
_backward_run_jit = jax.jit(backward_run)


@jax.jit
def lower_bound_from_cft(geom: DenseGeom, cft: jnp.ndarray) -> jnp.ndarray:
    """Sum of per-BDD root costs (roots are exactly the valid hop-0 slots)."""
    return jnp.sum(jnp.where(geom.node_valid[0], cft[0], 0.0))


def lower_bound_per_root_slot(geom: DenseGeom, cft: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(geom.node_valid[0], cft[0], 0.0)


@jax.jit
def min_marginals(
    geom: DenseGeom, lo: jnp.ndarray, hi: jnp.ndarray, cft=None
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-layer min marginals (m0, m1), [H, L]; padding -> +inf.
    ``cft``: optional clean backward run of (lo, hi) — state.cft always
    qualifies (every mutating op ends with a backward refresh)."""
    cfr = forward_run(geom, lo, hi)
    if cft is None:
        cft = backward_run(geom, lo, hi)
    cft_next = jnp.concatenate(
        [cft[1:], jnp.full((1, geom.W), INF, dtype=lo.dtype)], axis=0
    )
    L = geom.L

    def per_hop(cfr_row, cft_next_row, valid, llocal, lo_k, lo_n, hi_k, hi_n, lo_row, hi_row):
        c_lo = _node_cost(lo_row, llocal)
        c_hi = _node_cost(hi_row, llocal)
        t_lo = _cft_child(lo_k, lo_n, cft_next_row)
        t_hi = _cft_child(hi_k, hi_n, cft_next_row)
        lo_path = jnp.where(valid, cfr_row + c_lo + t_lo, INF)
        hi_path = jnp.where(valid, cfr_row + c_hi + t_hi, INF)
        m0 = jax.ops.segment_min(lo_path, llocal, num_segments=L + 1)[:L]
        m1 = jax.ops.segment_min(hi_path, llocal, num_segments=L + 1)[:L]
        return m0, m1

    m0, m1 = jax.vmap(per_hop)(
        cfr,
        cft_next,
        geom.node_valid,
        geom.layer_local,
        geom.lo_kind,
        geom.lo_next,
        geom.hi_kind,
        geom.hi_next,
        lo,
        hi,
    )
    return m0, m1


# ----------------------------------------------------------------- iteration
def compute_delta(
    geom: DenseGeom, def_mm: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-variable deferred deltas [V+1] (last entry = padding slot, 0).
    delta_lo = sum relu(-def_mm), delta_hi = sum relu(def_mm) per variable;
    infinite def_mm encodes variable forcing and propagates as +inf."""
    ids = geom.layer_var.ravel()
    dlo = jax.ops.segment_sum(
        jnp.maximum(-def_mm.ravel(), 0.0), ids, num_segments=geom.V + 1
    )
    dhi = jax.ops.segment_sum(
        jnp.maximum(def_mm.ravel(), 0.0), ids, num_segments=geom.V + 1
    )
    return dlo.at[geom.V].set(0.0), dhi.at[geom.V].set(0.0)


def _hop_cost_update(
    lo_row, hi_row, m0, m1, omega_row, alpha_row, din_lo, din_hi, lvalid
):
    """MMA cost update for one hop — the SINGLE implementation lives in
    uniform._hop_cost_update (elementwise, shape-polymorphic; see
    ref_solver._hop_cost_update for the semantics contract,
    bdd_parallel_mma_base.cpp:844-887)."""
    from bdd_tpu.solver.uniform import _hop_cost_update as impl

    return impl(lo_row, hi_row, m0, m1, omega_row, alpha_row, din_lo, din_hi, lvalid)


def forward_iteration(
    geom: DenseGeom, state: SolverState, omega, delta=None
) -> Tuple[SolverState, jnp.ndarray]:
    """Forward half-sweep: returns (new state [cft unchanged], cfr [H, W]).

    ``delta``: optional precomputed per-variable (delta_lo, delta_hi) [V+1]
    pair — the multi-chip path passes the psum-reduced global deltas here
    (generalizing the hybrid CPU/GPU consensus exchange,
    bdd_multi_parallel_mma_base.cu:268-455)."""
    W, L = geom.W, geom.L
    dlo, dhi = compute_delta(geom, state.def_mm) if delta is None else delta
    cft_next = jnp.concatenate(
        [state.cft[1:], jnp.full((1, W), INF, dtype=state.lo.dtype)], axis=0
    )
    omega_arr = jnp.broadcast_to(
        jnp.asarray(omega, dtype=state.lo.dtype), state.lo.shape
    )
    cfr0 = jnp.where(geom.node_valid[0], 0.0, INF).astype(state.lo.dtype)

    def step(cfr_row, xs):
        (
            valid,
            llocal,
            lo_k,
            lo_n,
            hi_k,
            hi_n,
            lo_row,
            hi_row,
            om_row,
            al_row,
            lvar,
            lvalid,
            cft_next_row,
        ) = xs
        c_lo = _node_cost(lo_row, llocal)
        c_hi = _node_cost(hi_row, llocal)
        t_lo = _cft_child(lo_k, lo_n, cft_next_row)
        t_hi = _cft_child(hi_k, hi_n, cft_next_row)
        lo_path = jnp.where(valid, cfr_row + c_lo + t_lo, INF)
        hi_path = jnp.where(valid, cfr_row + c_hi + t_hi, INF)
        m0 = jax.ops.segment_min(lo_path, llocal, num_segments=L + 1)[:L]
        m1 = jax.ops.segment_min(hi_path, llocal, num_segments=L + 1)[:L]
        new_lo, new_hi, mm = _hop_cost_update(
            lo_row, hi_row, m0, m1, om_row, al_row, dlo[lvar], dhi[lvar], lvalid
        )
        nc_lo = _node_cost(new_lo, llocal)
        nc_hi = _node_cost(new_hi, llocal)
        v_lo = jnp.where(valid, cfr_row + nc_lo, INF)
        v_hi = jnp.where(valid, cfr_row + nc_hi, INF)
        nxt = _scatter_min_next(v_lo, v_hi, lo_k, hi_k, lo_n, hi_n, W)
        return nxt, (new_lo, new_hi, mm, cfr_row)

    xs = (
        geom.node_valid,
        geom.layer_local,
        geom.lo_kind,
        geom.lo_next,
        geom.hi_kind,
        geom.hi_next,
        state.lo,
        state.hi,
        omega_arr,
        geom.alpha,
        geom.layer_var,
        geom.layer_valid,
        cft_next,
    )
    _, (new_lo, new_hi, new_mm, cfr) = jax.lax.scan(step, cfr0, xs)
    return state._replace(lo=new_lo, hi=new_hi, def_mm=new_mm), cfr


def backward_iteration(
    geom: DenseGeom, state: SolverState, omega, cfr: jnp.ndarray, delta=None
) -> SolverState:
    """Backward half-sweep: returns new state with refreshed cft."""
    W, L = geom.W, geom.L
    dlo, dhi = compute_delta(geom, state.def_mm) if delta is None else delta
    omega_arr = jnp.broadcast_to(
        jnp.asarray(omega, dtype=state.lo.dtype), state.lo.shape
    )

    def step(cft_next_row, xs):
        (
            valid,
            llocal,
            lo_k,
            lo_n,
            hi_k,
            hi_n,
            lo_row,
            hi_row,
            om_row,
            al_row,
            lvar,
            lvalid,
            cfr_row,
        ) = xs
        c_lo = _node_cost(lo_row, llocal)
        c_hi = _node_cost(hi_row, llocal)
        t_lo = _cft_child(lo_k, lo_n, cft_next_row)
        t_hi = _cft_child(hi_k, hi_n, cft_next_row)
        lo_path = jnp.where(valid, cfr_row + c_lo + t_lo, INF)
        hi_path = jnp.where(valid, cfr_row + c_hi + t_hi, INF)
        m0 = jax.ops.segment_min(lo_path, llocal, num_segments=L + 1)[:L]
        m1 = jax.ops.segment_min(hi_path, llocal, num_segments=L + 1)[:L]
        new_lo, new_hi, mm = _hop_cost_update(
            lo_row, hi_row, m0, m1, om_row, al_row, dlo[lvar], dhi[lvar], lvalid
        )
        nc_lo = _node_cost(new_lo, llocal)
        nc_hi = _node_cost(new_hi, llocal)
        cft_row = jnp.where(
            valid, jnp.minimum(nc_lo + t_lo, nc_hi + t_hi), INF
        )
        return cft_row, (new_lo, new_hi, mm, cft_row)

    xs = (
        geom.node_valid,
        geom.layer_local,
        geom.lo_kind,
        geom.lo_next,
        geom.hi_kind,
        geom.hi_next,
        state.lo,
        state.hi,
        omega_arr,
        geom.alpha,
        geom.layer_var,
        geom.layer_valid,
        cfr,
    )
    init = jnp.full((W,), INF, dtype=state.lo.dtype)
    _, (new_lo, new_hi, new_mm, cft) = jax.lax.scan(step, init, xs, reverse=True)
    return SolverState(lo=new_lo, hi=new_hi, def_mm=new_mm, cft=cft)


@jax.jit
def iteration(geom: DenseGeom, state: SolverState, omega=0.5) -> SolverState:
    """One full dual MMA iteration (ref: bdd_cuda_parallel_mma.cu:142-153)."""
    state, cfr = forward_iteration(geom, state, omega)
    return backward_iteration(geom, state, omega, cfr)


@functools.partial(jax.jit, static_argnames=("n",))
def iterations(geom: DenseGeom, state: SolverState, n: int, omega=0.5) -> SolverState:
    def body(s, _):
        return iteration(geom, s, omega), ()

    state, _ = jax.lax.scan(body, state, None, length=n)
    return state


@jax.jit
def distribute_delta(geom: DenseGeom, state: SolverState) -> SolverState:
    """Fold deferred deltas into the costs -> valid dual point
    (ref: bdd_cuda_base.cu:1397-1437)."""
    dlo, dhi = compute_delta(geom, state.def_mm)
    lo = state.lo + geom.alpha * dlo[geom.layer_var]
    hi = state.hi + geom.alpha * dhi[geom.layer_var]
    cft = backward_run(geom, lo, hi)
    return SolverState(lo=lo, hi=hi, def_mm=jnp.zeros_like(state.def_mm), cft=cft)


@jax.jit
def lower_bound_with_deferred(geom: DenseGeom, state: SolverState) -> jnp.ndarray:
    s = distribute_delta(geom, state)
    return lower_bound_from_cft(geom, s.cft)


@jax.jit
def lower_bound(geom: DenseGeom, state: SolverState) -> jnp.ndarray:
    cft = backward_run(geom, state.lo, state.hi)
    return lower_bound_from_cft(geom, cft)


# --------------------------------------------------- solutions & dual algebra
@jax.jit
def bdds_solution(geom: DenseGeom, lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    """Per-layer 0/1 argmin-path choice of every BDD, [H, L] int8 (garbage at
    invalid layers). Hop-major formulation of bdds_solution_cuda
    (bdd_cuda_base.cu:1104-1233): every hop advances all BDDs' path pointers
    in parallel; dead/pad slots park at index W."""
    W, L = geom.W, geom.L
    cft = backward_run(geom, lo, hi)
    cft_next = jnp.concatenate([cft[1:], jnp.full((1, W), INF, dtype=lo.dtype)], 0)

    active0 = jnp.where(
        geom.node_valid[0],
        jax.lax.broadcasted_iota(jnp.int32, (W, 1), 0).squeeze(-1),
        W,
    )

    def pad1(row, fill):
        return jnp.concatenate([row, jnp.array([fill], row.dtype)])

    def step(active, xs):
        (llocal, lo_k, lo_n, hi_k, hi_n, lo_row, hi_row, cft_next_row) = xs
        llocal_a = pad1(llocal, L)[active]
        lo_k_a = pad1(lo_k, ARC_BOT)[active]
        hi_k_a = pad1(hi_k, ARC_BOT)[active]
        lo_n_a = pad1(lo_n, W)[active]
        hi_n_a = pad1(hi_n, W)[active]
        c_lo = jnp.concatenate([lo_row, jnp.zeros(1, lo_row.dtype)])[llocal_a]
        c_hi = jnp.concatenate([hi_row, jnp.zeros(1, hi_row.dtype)])[llocal_a]
        cftp = jnp.concatenate([cft_next_row, jnp.zeros(1, cft_next_row.dtype)])
        t_lo = jnp.where(
            lo_k_a == ARC_TOP, 0.0, jnp.where(lo_k_a == ARC_BOT, INF, cftp[lo_n_a])
        )
        t_hi = jnp.where(
            hi_k_a == ARC_TOP, 0.0, jnp.where(hi_k_a == ARC_BOT, INF, cftp[hi_n_a])
        )
        take_hi = (c_hi + t_hi) <= (c_lo + t_lo)
        sol_row = (
            jnp.zeros((L + 1,), dtype=jnp.int8)
            .at[llocal_a]
            .set(take_hi.astype(jnp.int8))[:L]
        )
        nxt = jnp.where(take_hi, hi_n_a, lo_n_a)
        nxt = jnp.where(
            jnp.where(take_hi, hi_k_a, lo_k_a) == ARC_INTERNAL, nxt, W
        )
        return nxt, sol_row

    xs = (
        geom.layer_local,
        geom.lo_kind,
        geom.lo_next,
        geom.hi_kind,
        geom.hi_next,
        lo,
        hi,
        cft_next,
    )
    _, sol = jax.lax.scan(step, active0, xs)
    return sol


@jax.jit
def net_solver_costs(geom: DenseGeom, state: SolverState) -> jnp.ndarray:
    """Per-layer net cost x = (hi - lo) including the deferred delta share
    (ref: bdd_parallel_mma_base.cpp:1285-1327). [H, L], 0 at invalid layers."""
    dlo, dhi = compute_delta(geom, state.def_mm)
    dl = dlo[geom.layer_var]
    dh = dhi[geom.layer_var]
    # both-ways forcing (infeasible variable) has dl = dh = +inf; inf - inf
    # would inject NaN into the L-BFGS history — treat the share as 0 (the
    # run loop stops on the inf lower bound)
    diff = jnp.where(
        jnp.isfinite(dh) & jnp.isfinite(dl), dh - dl,
        jnp.where(jnp.isfinite(dl), INF,
                  jnp.where(jnp.isfinite(dh), -INF, 0.0)),
    )
    net = state.hi - state.lo + geom.alpha * diff
    return jnp.where(geom.layer_valid, net, 0.0)


@jax.jit
def make_dual_feasible(geom: DenseGeom, g: jnp.ndarray) -> jnp.ndarray:
    """Zero-sum projection per primal variable: g -= mean over the variable's
    layers (ref: bdd_parallel_mma_base.cpp:1349-1369)."""
    g = jnp.where(geom.layer_valid, g, 0.0)
    sums = jax.ops.segment_sum(
        g.ravel(), geom.layer_var.ravel(), num_segments=geom.V + 1
    )
    proj = g - geom.alpha * sums[geom.layer_var]
    return jnp.where(geom.layer_valid, proj, 0.0)


@jax.jit
def gradient_step(
    geom: DenseGeom, state: SolverState, g: jnp.ndarray, step_size
) -> SolverState:
    """hi_cost += step * g (ref: bdd_parallel_mma_base.cpp:1371-1396)."""
    hi = state.hi + jnp.where(geom.layer_valid, step_size * g, 0.0)
    cft = backward_run(geom, state.lo, hi)
    return state._replace(hi=hi, cft=cft)
