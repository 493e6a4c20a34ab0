"""Solver-state features for the learned solver.

JAX counterpart of DOGE/model/solver_utils.py:13-157: per-variable,
per-subproblem (BDD) and per-layer (edge) feature tensors computed from the
current solver state, in the uniform bucket layout (layers flattened across
buckets as [sum H*B]).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from bdd_tpu.solver import learned as ln
from bdd_tpu.solver import smooth as sm
from bdd_tpu.solver import uniform as uf

_CLIP = 1e4


class GraphSpec(NamedTuple):
    """Static bipartite graph of the ILP: layer e connects variable
    layer_var[e] with bdd layer_bdd[e]. Flattened over buckets.

    Optional static ILP-side features (ref solver_utils.py edge 'coeff' /
    con 'rhs' / 'con_type' lists): constraint coefficient per layer, rhs and
    inequality type per BDD — None when the builder had no preprocessor."""

    layer_var: jnp.ndarray  # int32 [E] (V sentinel at padding)
    layer_bdd: jnp.ndarray  # int32 [E] (nr_bdds sentinel at padding)
    layer_valid: jnp.ndarray  # bool [E]
    nr_vars: int
    nr_bdds: int
    coeff: jnp.ndarray = None  # f32 [E]
    rhs: jnp.ndarray = None  # f32 [nr_bdds+1]
    con_type: jnp.ndarray = None  # f32 [nr_bdds+1] (LEQ 0 / GEQ 1 / EQ 2)

    @property
    def E(self) -> int:
        return self.layer_var.shape[0]


def _static_ilp_features(host: uf.UniformHost, pre):
    """(coeff[E], rhs[nb+1], con_type[nb+1]) from preprocessor constraint
    info; accepts a BddPreprocessor or a utils.batching.BatchedInstances.
    Layers without a recoverable constraint (free-variable BDDs, melded
    coalesce groups, split chunks) get zeros."""
    nb = host.nr_bdds
    rhs = np.zeros(nb + 1, np.float64)
    ctype = np.zeros(nb + 1, np.float64)
    coeff_of: dict = {}  # bdd -> {var: coeff}
    ineq_code = {"<=": 0.0, ">=": 1.0, "=": 2.0}

    def add_pre(pre1, var_off, bdd_off):
        cons = list(pre1.ilp.constraints())
        for ci, bdds in enumerate(pre1.ineq_to_bdd_nrs):
            if ci >= len(cons) or len(bdds) != 1:
                continue  # melded group emission rows / dropped constraints
            b = bdds[0] + bdd_off
            c = cons[ci]
            rhs[b] = float(c.rhs)
            ctype[b] = ineq_code.get(
                getattr(c.ineq, "value", str(c.ineq)), 0.0
            )
            coeff_of[b] = {
                m[0] + var_off: float(co)
                for co, m in zip(c.coefficients, c.monomials)
                if len(m) == 1
            }

    if hasattr(pre, "pres"):  # BatchedInstances
        for p, vo, bo in zip(pre.pres, pre.var_offsets, pre.bdd_offsets):
            add_pre(p, vo, bo)
    else:
        add_pre(pre, 0, 0)

    coeffs = []
    for g, lbdd in zip(host.geom.buckets, host.layer_bdd):
        lv = np.asarray(g.layer_var)
        lb = np.asarray(lbdd)
        out = np.zeros(lv.shape, np.float64)
        it = np.nditer(lb, flags=["multi_index"])
        for b in it:
            d = coeff_of.get(int(b))
            if d is not None:
                out[it.multi_index] = d.get(int(lv[it.multi_index]), 0.0)
        coeffs.append(out.ravel())
    return np.concatenate(coeffs), rhs, ctype


def graph_spec(host: uf.UniformHost, pre=None) -> GraphSpec:
    """``pre``: optional BddPreprocessor / BatchedInstances providing the
    static constraint-side features (coeff, rhs, con_type)."""
    lv, lb, lval = [], [], []
    for g, lbdd in zip(host.geom.buckets, host.layer_bdd):
        lv.append(np.asarray(g.layer_var).ravel())
        valid = np.asarray(g.layer_valid)
        bdd = np.asarray(lbdd).copy()
        bdd[~valid] = host.nr_bdds
        bdd[bdd < 0] = host.nr_bdds
        lb.append(bdd.ravel())
        lval.append(valid.ravel())
    coeff = rhs = ctype = None
    if pre is not None:
        c_np, r_np, t_np = _static_ilp_features(host, pre)
        coeff = jnp.asarray(c_np, jnp.float32)
        rhs = jnp.asarray(r_np, jnp.float32)
        ctype = jnp.asarray(t_np, jnp.float32)
    return GraphSpec(
        layer_var=jnp.asarray(np.concatenate(lv), jnp.int32),
        layer_bdd=jnp.asarray(np.concatenate(lb), jnp.int32),
        layer_valid=jnp.asarray(np.concatenate(lval)),
        nr_vars=host.nr_vars,
        nr_bdds=host.nr_bdds,
        coeff=coeff,
        rhs=rhs,
        con_type=ctype,
    )


def _flatten(per_bucket: Tuple[jnp.ndarray, ...]) -> jnp.ndarray:
    return jnp.concatenate([x.ravel() for x in per_bucket])


def per_bdd_lb_vector(host: uf.UniformHost, state: uf.UniformState) -> jnp.ndarray:
    """Per-BDD root costs scattered into an [nr_bdds+1] vector (sentinel 0)."""
    geom = host.geom
    nb = host.nr_bdds
    dtype = state.lo[0].dtype
    lbs = ln.per_bdd_lower_bound(geom, state)  # per bucket [H, B] root costs
    lb_per_bdd = jnp.zeros((nb + 1,), dtype)
    for g, cft_lb, lbdd in zip(geom.buckets, lbs, host.layer_bdd):
        roots = np.asarray(uf.root_rows(g))
        ids_np = np.where(roots & (np.asarray(lbdd) >= 0), np.asarray(lbdd), nb)
        ids = jnp.asarray(ids_np.ravel(), jnp.int32)
        lb_per_bdd = lb_per_bdd.at[ids].add(cft_lb.ravel())
    return lb_per_bdd.at[nb].set(0.0)


def compute_features(
    host: uf.UniformHost,
    spec: GraphSpec,
    state: uf.UniformState,
    objective: jnp.ndarray,
    smoothing: float = 1.0,
    history=None,
    smooth_temps=(),
    prev_lb_per_bdd=None,
):
    """Returns (var_f [V+1, Fv], bdd_f [nb+1, Fb], layer_f [E, Fe]).
    Sentinel rows (index V / nb) are zero. Features follow DOGE's lists
    (solver_utils.py var/con/edge lp_f): objective, degree, costs, min-marginal
    differences, per-BDD lower bounds, smoothed solutions, plus (when the
    spec carries them) the static coeff/rhs/con_type features and the
    l2-normalized net solver costs of DOGE/model/model.py:41
    (compute_normalized_solver_costs_for_dual; norm taken over the whole
    batch here rather than per instance).

    ``history``: optional (sol_avg, lb_fo_avg, lb_so_avg) per-bucket tuples
    from ``learned.learned_iterations_with_stats`` — appended as the
    reference's prev_sol_avg edge feature and lb_first/sec_order_avg con
    features (solver_utils.py:132-148).
    ``smooth_temps``: extra temperatures for smooth_sol@T edge features
    (ref config EDGE_LP_FEATURES 'smooth_sol@0.1'..'@1000').
    ``prev_lb_per_bdd``: previous round's per-BDD bound [nb+1] — adds the
    'prev_lb' and 'lb_change' con features."""
    geom = host.geom
    lo = _flatten(state.lo)
    hi = _flatten(state.hi)
    mm_flat = _flatten(state.def_mm)
    mmdiff = _flatten(ln.all_min_marginal_differences(geom, state))
    probs = _flatten(sm.smooth_solution(geom, state, smoothing))
    valid = spec.layer_valid
    E = spec.E
    V, nb = spec.nr_vars, spec.nr_bdds

    def seg_v(x):
        return jax.ops.segment_sum(
            jnp.where(valid, x, 0.0), spec.layer_var, num_segments=V + 1
        )

    def seg_b(x):
        return jax.ops.segment_sum(
            jnp.where(valid, x, 0.0), spec.layer_bdd, num_segments=nb + 1
        )

    deg_v = seg_v(jnp.ones((E,), lo.dtype))
    deg_b = seg_b(jnp.ones((E,), lo.dtype))
    obj = jnp.concatenate([objective.astype(lo.dtype), jnp.zeros((1,), lo.dtype)])

    lb_per_bdd = per_bdd_lb_vector(host, state)

    c = lambda x: jnp.clip(x, -_CLIP, _CLIP)
    var_f = jnp.stack(
        [c(obj), deg_v, c(seg_v(mmdiff)), c(seg_v(probs)), c(seg_v(hi - lo))],
        axis=-1,
    )
    bdd_cols = [deg_b, c(lb_per_bdd), c(seg_b(mmdiff))]
    layer_cols = [c(lo), c(hi), c(mmdiff), c(probs), valid.astype(lo.dtype)]
    # static constraint-side features (edge 'coeff', con 'rhs'/'con_type')
    if spec.coeff is not None:
        layer_cols.append(c(spec.coeff.astype(lo.dtype)))
        bdd_cols.append(c(spec.rhs.astype(lo.dtype)))
        bdd_cols.append(spec.con_type.astype(lo.dtype))
    # normalized net solver costs (model.py:41): net = hi - lo + def_mm,
    # l2-normalized; the normalized deferred mm joins it. Variable forcing
    # puts ±inf in costs/def_mm (inf - inf = NaN) — forced entries carry 0
    # here (the reference zeroes invalid/non-finite entries too,
    # solver_utils.py:100-109)
    raw_net = hi - lo + mm_flat
    net = jnp.where(valid & jnp.isfinite(raw_net), raw_net, 0.0)
    norm = jnp.sqrt(jnp.sum(jnp.square(jnp.clip(net, -_CLIP, _CLIP)))) + 1e-6
    layer_cols.append(c(net) / norm)
    mm_fin = jnp.where(valid & jnp.isfinite(mm_flat), mm_flat, 0.0)
    layer_cols.append(c(mm_fin) / norm)
    # hard per-BDD argmin solution (edge 'sol'); input feature only — the
    # argmin path has no useful gradient
    sol = jax.lax.stop_gradient(
        _flatten(
            tuple(s.astype(lo.dtype) for s in uf.bdds_solution(geom, state))
        )
    )
    layer_cols.append(jnp.where(valid, sol, 0.0))
    # multi-temperature smoothed solutions (edge 'smooth_sol@T')
    for T in smooth_temps:
        layer_cols.append(c(_flatten(sm.smooth_solution(geom, state, T))))
    if prev_lb_per_bdd is not None:
        bdd_cols.append(c(prev_lb_per_bdd))  # 'prev_lb'
        bdd_cols.append(c(lb_per_bdd - prev_lb_per_bdd))  # 'lb_change'
    if history is not None:
        sol_avg, fo_avg, so_avg = history
        layer_cols.append(c(_flatten(sol_avg)))

        def per_bdd_from_roots(vals):
            out = jnp.zeros((nb + 1,), lo.dtype)
            for g, v_b, lbdd in zip(geom.buckets, vals, host.layer_bdd):
                roots = np.asarray(uf.root_rows(g))
                ids_np = np.where(
                    roots & (np.asarray(lbdd) >= 0), np.asarray(lbdd), nb
                )
                out = out.at[jnp.asarray(ids_np.ravel(), jnp.int32)].add(
                    v_b.ravel()
                )
            return out.at[nb].set(0.0)

        bdd_cols.append(c(per_bdd_from_roots(fo_avg)))
        bdd_cols.append(c(per_bdd_from_roots(so_avg)))
    bdd_f = jnp.stack(bdd_cols, axis=-1)
    layer_f = jnp.stack(layer_cols, axis=-1)
    return var_f, bdd_f, layer_f


def split_like(host: uf.UniformHost, flat: jnp.ndarray) -> Tuple[jnp.ndarray, ...]:
    """Inverse of _flatten: split an [E] vector into per-bucket [H, B]."""
    out = []
    off = 0
    for g in host.geom.buckets:
        n = g.H * g.B
        out.append(flat[off : off + n].reshape(g.H, g.B))
        off += n
    return tuple(out)
