"""On-device incremental rounding for the uniform backend.

Same semantics as solver/rounding.py (the reference's incremental mm-agreement
scheme), but one entire rounding round — distribute deltas, min marginals,
per-variable classification, perturbation sampling, cost update — runs as a
single jitted program on device. Only four scalars (the class counts) cross to
the host per round, instead of the megabytes of marginals that host-side
rounding transfers every round.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from bdd_tpu.solver import uniform as uf
from bdd_tpu.solver.run import run_solver
from bdd_tpu.utils.logging import bdd_log

_EPS = 1e-6
_BIGF = 1e9


@functools.partial(jax.jit, static_argnames=())
def _classify(geom: uf.UniformGeom, state: uf.UniformState):
    """Returns (types [V], sum0 [V], sum1 [V], stats [4]) of the
    delta-distributed state. types: 0 zero, 1 one, 2 equal, 3 inconsistent."""
    s = uf.distribute_delta(geom, state)
    mm = uf.min_marginals_all(geom, s)
    ids = uf._exchange_ids(geom)
    V = geom.V
    m0 = jnp.concatenate([a.ravel() for a, _ in mm])
    m1 = jnp.concatenate([b.ravel() for _, b in mm])
    lval = jnp.concatenate([g.layer_valid.ravel() for g in geom.buckets])
    d = m1 - m0
    d = jnp.where(jnp.isfinite(d), d, jnp.where(jnp.isfinite(m0), _BIGF, -_BIGF))
    d = jnp.where(lval, d, 0.0)
    ids_m = jnp.where(lval, ids, V)
    dmax = jax.ops.segment_max(d, ids_m, num_segments=V + 1)[:V]
    dmin = jax.ops.segment_min(d, ids_m, num_segments=V + 1)[:V]
    amax = jnp.maximum(jnp.abs(dmax), jnp.abs(dmin))
    sum0 = jax.ops.segment_sum(
        jnp.where(lval, jnp.clip(m0, -_BIGF, _BIGF), 0.0), ids_m, num_segments=V + 1
    )[:V]
    sum1 = jax.ops.segment_sum(
        jnp.where(lval, jnp.clip(m1, -_BIGF, _BIGF), 0.0), ids_m, num_segments=V + 1
    )[:V]
    types = jnp.full((V,), 3, dtype=jnp.int8)
    types = jnp.where(amax <= _EPS, 2, types)
    types = jnp.where(dmax < -_EPS, 1, types)
    types = jnp.where(dmin > _EPS, 0, types)
    stats = jnp.stack(
        [
            jnp.sum(types == 1),
            jnp.sum(types == 0),
            jnp.sum(types == 2),
            jnp.sum(types == 3),
        ]
    )
    solution = jnp.where(
        types == 1, 1, jnp.where(types == 0, 0, (sum0 > sum1).astype(jnp.int8))
    ).astype(jnp.int8)
    return types, sum0, sum1, stats, solution


@jax.jit
def _perturb(geom: uf.UniformGeom, state: uf.UniformState, types, sum0, sum1, key, cur_delta, tilt):
    """Apply the reference's perturbation (rounding.py semantics) on device.
    ``tilt`` [V]: objective tilt (pre-scaled by the bias; zeros reproduce the
    reference's symmetric tie-breaking) — see rounding.objective_tilt."""
    V = geom.V
    r = jax.random.uniform(key, (V,), minval=-cur_delta, maxval=cur_delta)
    r_dir = r + cur_delta * tilt
    mag = jnp.abs(r) * cur_delta
    lo_upd = jnp.where(
        types == 1,
        cur_delta,
        jnp.where((types == 2) & (r_dir < 0), mag,
                  jnp.where((types == 3) & (sum0 >= sum1), mag, 0.0)),
    )
    hi_upd = jnp.where(
        types == 0,
        cur_delta,
        jnp.where((types == 2) & (r_dir >= 0), mag,
                  jnp.where((types == 3) & (sum0 < sum1), mag, 0.0)),
    )
    lo_u = jnp.concatenate([lo_upd, jnp.zeros(1, lo_upd.dtype)]).astype(state.lo[0].dtype)
    hi_u = jnp.concatenate([hi_upd, jnp.zeros(1, hi_upd.dtype)]).astype(state.lo[0].dtype)
    return uf.update_costs_per_var(geom, state, lo_u, hi_u)


def incremental_mm_rounding_device(
    s,
    init_delta: float = math.inf,
    delta_growth_rate: float = 1.1,
    num_itr_lb: int = 100,
    num_rounding_itr: int = 500,
    seed: int = 0,
    verbose: bool = True,
    objective_bias: float = 0.0,
    objective=None,
) -> Optional[np.ndarray]:
    """Drop-in device-resident replacement for incremental_mm_rounding,
    specialized to UniformSolver-like objects (attributes geom, state).
    ``objective_bias``/``objective``: tilt tie-breaking toward the primal
    objective (see incremental_mm_rounding)."""
    geom = s.geom
    key = jax.random.PRNGKey(seed)
    if objective_bias > 0.0 and objective is not None:
        from bdd_tpu.solver.rounding import objective_tilt

        tilt = jnp.asarray(
            objective_bias * objective_tilt(objective, geom.V),
            dtype=jnp.float32,
        )
    else:
        tilt = jnp.zeros((geom.V,), dtype=jnp.float32)

    if math.isinf(init_delta):
        from bdd_tpu.solver.rounding import compute_initial_delta

        s.distribute_delta()
        m0, m1 = s.min_marginals()
        init_delta = compute_initial_delta(s.f, m0, m1)
    cur_delta = init_delta / delta_growth_rate

    for rnd in range(num_rounding_itr):
        cur_delta = min(cur_delta * delta_growth_rate, 1e6)
        types, sum0, sum1, stats, solution = _classify(geom, s.state)
        n1, n0, neq, ninc = (int(x) for x in np.asarray(stats))
        if verbose:
            V = geom.V
            bdd_log(
                f"[device rounding] round {rnd}, delta {cur_delta:.4g}: "
                f"one {100 * n1 / V:.1f}%, zero {100 * n0 / V:.1f}%, "
                f"equal {100 * neq / V:.1f}%, inconsistent {100 * ninc / V:.1f}%"
            )
        if neq == 0 and ninc == 0:
            if verbose:
                bdd_log("[device rounding] found feasible solution")
            return np.asarray(solution)
        key, sub = jax.random.split(key)
        s.state = _perturb(geom, s.state, types, sum0, sum1, sub, cur_delta, tilt)
        run_solver(
            s,
            max_iter=num_itr_lb,
            tolerance=1e-7,
            improvement_slope=1e-4,
            time_limit=math.inf,
            verbose=False,
            block_size=getattr(s, "default_block_size", 25),
        )
    if verbose:
        bdd_log("[device rounding] no solution found")
    return None
