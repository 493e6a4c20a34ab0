"""Stub-bisect one uniform-MMA iteration on the real chip.

Measures, for a given instance (default: the 12x12x4 grid MRF driver metric),
the composed per-iteration cost of:
  full        — the real iteration
  sweeps      — exchange stubbed (din = 0*mm broadcast; keeps the data chain)
  exch        — sweeps stubbed (def_mm' = din_lo - din_hi)
  exch-nosort — exchange with both sorts replaced by identity (dense glue
                chain only: C-reduce, class folds, broadcasts)
  sort1       — one fwd sort (key + 1 payload) alone
  sort2       — one inv sort (key + 2 payloads) alone

All variants run as one jitted scan of N iterations, synced by a host scalar
fetch, median of 3 measurements. Usage:
  python benchmarks/bisect_iteration.py [grid12|gm50k|qap18|grid24] [N]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bdd_tpu.utils.platform import device_platform

device_platform()

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bdd_tpu.solver import uniform as uf


def build(which: str):
    if which == "gm50k":
        from bdd_tpu import native
        from bdd_tpu.frontends.graph_matching import construct_graph_matching_ilp
        from bdd_tpu.utils.problems import graph_matching

        inst = graph_matching(120, 120, seed=0, candidates=6, nr_quadratic=2000)
        gm_ilp = construct_graph_matching_ilp(inst)[0]
        nh = native.NativeHost(gm_ilp.write_lp(), "bfs")
        return nh.make_uniform_host(), nh.objective()
    from bdd_tpu.bdd.preprocessor import BddPreprocessor
    from bdd_tpu.utils.problems import grid_mrf, quadratic_assignment

    if which == "grid12":
        ilp = grid_mrf(12, 12, 4, seed=0)
    elif which == "grid24":
        ilp = grid_mrf(24, 24, 8, seed=0)
    elif which == "qap18":
        ilp = quadratic_assignment(18, seed=0, density=0.06)
    else:
        raise SystemExit(f"unknown instance {which}")
    ilp.reorder_bfs()
    ilp.normalize()
    pre = BddPreprocessor(ilp)
    host = uf.flatten_uniform(
        pre.collection, pre.total_nr_variables(), pre.nr_primal_variables
    )
    return host, pre.objective_vector()


def stub_exchange(geom, def_mm):
    """Zero din with a live dependency on def_mm (prevents DCE)."""
    leak = sum(jnp.sum(m) * 0.0 for m in def_mm)
    out_lo = tuple(jnp.zeros((g.H, g.B), def_mm[0].dtype) + leak for g in geom.buckets)
    return out_lo, out_lo


def exchange_nosort(plan, mm_flat):
    """The dense glue chain of _exchange_perm with both sorts skipped."""
    E = mm_flat.shape[0]
    N = plan.key_fwd.shape[0]
    CV = plan.C * plan.Vx
    mm_p = mm_flat
    if N > E:
        mm_p = jnp.concatenate([mm_flat, jnp.zeros((N - E,), mm_flat.dtype)])
    mm_s = mm_p  # sort skipped
    mm_cv = mm_s[:CV].reshape(plan.C, plan.Vx)
    dlo_col = jnp.sum(jnp.maximum(-mm_cv, 0.0), axis=0)
    dhi_col = jnp.sum(jnp.maximum(mm_cv, 0.0), axis=0)
    dlo_parts = [dlo_col[: plan.Vp]]
    dhi_parts = [dhi_col[: plan.Vp]]
    for base, w, nv in plan.classes:
        dlo_parts.append(dlo_col[base : base + nv * w].reshape(nv, w).sum(1))
        dhi_parts.append(dhi_col[base : base + nv * w].reshape(nv, w).sum(1))
    w_lo = [dlo_parts[0]]
    w_hi = [dhi_parts[0]]
    for (base, w, nv), plo, phi in zip(plan.classes, dlo_parts[1:], dhi_parts[1:]):
        w_lo.append(jnp.broadcast_to(plo[:, None], (nv, w)).reshape(nv * w))
        w_hi.append(jnp.broadcast_to(phi[:, None], (nv, w)).reshape(nv * w))
    tail = plan.Vx - plan.Vp - sum(w * nv for _, w, nv in plan.classes)
    if tail:
        w_lo.append(jnp.zeros((tail,), mm_flat.dtype))
        w_hi.append(jnp.zeros((tail,), mm_flat.dtype))
    dlo = jnp.concatenate(w_lo) if len(w_lo) > 1 else w_lo[0]
    dhi = jnp.concatenate(w_hi) if len(w_hi) > 1 else w_hi[0]
    t_lo = jnp.broadcast_to(dlo, (plan.C, plan.Vx)).reshape(CV)
    t_hi = jnp.broadcast_to(dhi, (plan.C, plan.Vx)).reshape(CV)
    if N > CV:
        pad = jnp.zeros((N - CV,), mm_flat.dtype)
        t_lo = jnp.concatenate([t_lo, pad])
        t_hi = jnp.concatenate([t_hi, pad])
    return t_lo[:E], t_hi[:E]  # inverse sort skipped


def split_din(geom, din_lo_f, din_hi_f):
    out_lo, out_hi, off = [], [], 0
    for g in geom.buckets:
        n = g.H * g.B
        out_lo.append(din_lo_f[off : off + n].reshape(g.H, g.B))
        out_hi.append(din_hi_f[off : off + n].reshape(g.H, g.B))
        off += n
    return tuple(out_lo), tuple(out_hi)


def make_variants(geom):
    def sweep_half(state, din_lo, din_hi, omega, direction):
        new_lo, new_hi, new_mm, carry = [], [], [], []
        for i, (g, lo, hi) in enumerate(zip(geom.buckets, state.lo, state.hi)):
            fwd, bwd = uf._sweep_fns(g, lo.dtype)
            fn = fwd if direction == 0 else bwd
            c = state.cft[i]
            nl, nh, mm, nc = fn(g, lo, hi, c, omega, din_lo[i], din_hi[i])
            new_lo.append(nl)
            new_hi.append(nh)
            new_mm.append(mm)
            carry.append(nc)
        return uf.UniformState(
            tuple(new_lo), tuple(new_hi), tuple(new_mm), tuple(carry)
        )

    def it_full(state, omega=0.5):
        return uf.iteration(geom, state, omega)

    def it_sweeps(state, omega=0.5):
        dl, dh = stub_exchange(geom, state.def_mm)
        s = sweep_half(state, dl, dh, omega, 0)
        dl, dh = stub_exchange(geom, s.def_mm)
        return sweep_half(s, dl, dh, omega, 1)

    def it_exch(state, omega=0.5):
        # two consensus rounds per iteration as in the real loop; feed the
        # result back through def_mm to keep the chain alive
        s = state
        for _ in range(2):
            dl, dh = uf.exchange_delta(geom, s.def_mm)
            new_mm = tuple(l - h for l, h in zip(dl, dh))
            s = uf.UniformState(s.lo, s.hi, new_mm, s.cft)
        return s

    def it_exch_nosort(state, omega=0.5):
        plan = geom.exchange
        s = state
        for _ in range(2):
            mm_flat = jnp.concatenate([m.ravel() for m in s.def_mm])
            dlo_f, dhi_f = exchange_nosort(plan, mm_flat)
            dl, dh = split_din(geom, dlo_f, dhi_f)
            new_mm = tuple(l - h for l, h in zip(dl, dh))
            s = uf.UniformState(s.lo, s.hi, new_mm, s.cft)
        return s

    return {
        "full": it_full,
        "sweeps": it_sweeps,
        "exch": it_exch,
        "exch-nosort": it_exch_nosort,
    }


def time_variant(fn, state, n, reps=3):
    @functools.partial(jax.jit, static_argnames=("n",))
    def run(s, n):
        def body(s, _):
            return fn(s), ()

        s, _ = jax.lax.scan(body, s, None, length=n)
        return s

    out = run(state, n)
    float(out.lo[0][0, 0])  # sync
    rates = []
    for _ in range(reps):
        t0 = time.time()
        out = run(out, n)
        float(out.lo[0][0, 0])
        rates.append((time.time() - t0) / n)
    return float(np.median(rates))


def time_sorts(plan, n=200, reps=3):
    N = plan.key_fwd.shape[0]

    @functools.partial(jax.jit, static_argnames=("n",))
    def run1(x, n):
        def body(x, _):
            _, y = jax.lax.sort((plan.key_fwd, x), num_keys=1)
            return y, ()

        x, _ = jax.lax.scan(body, x, None, length=n)
        return x

    @functools.partial(jax.jit, static_argnames=("n",))
    def run2(x, n):
        def body(c, _):
            a, b = c
            _, y, z = jax.lax.sort((plan.key_inv, a, b), num_keys=1)
            return (y, z), ()

        c, _ = jax.lax.scan(body, (x, x + 1.0), None, length=n)
        return c[0]

    x = jnp.arange(N, dtype=jnp.float32)
    res = {}
    for name, run in (("sort1", run1), ("sort2", run2)):
        out = run(x, n)
        float(out[0])
        ts = []
        for _ in range(reps):
            t0 = time.time()
            out = run(out, n)
            float(out[0])
            ts.append((time.time() - t0) / n)
        res[name] = float(np.median(ts))
    return res


def main() -> int:
    which = sys.argv[1] if len(sys.argv) > 1 else "grid12"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 200
    host, obj = build(which)
    geom = host.geom
    E = sum(g.H * g.B for g in geom.buckets)
    plan = geom.exchange
    print(
        f"# {which}: V={geom.V} E={E} buckets="
        f"{[(g.H, g.P, g.B) for g in geom.buckets]}"
        + (f" plan N={plan.key_fwd.shape[0]} C={plan.C} Vx={plan.Vx}" if plan else ""),
        flush=True,
    )
    state = uf.init_uniform_state(host, obj)
    rows = {}
    for name, fn in make_variants(geom).items():
        t = time_variant(fn, state, n)
        rows[name] = t
        print(f"# {name:12s} {t * 1e3:8.3f} ms/iter", flush=True)
    if plan is not None:
        for name, t in time_sorts(plan, n).items():
            rows[name] = t
            print(f"# {name:12s} {t * 1e3:8.3f} ms/sort", flush=True)
    print("RESULT " + " ".join(f"{k}={v * 1e3:.3f}ms" for k, v in rows.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
