"""Certified time-to-1e-6 via f32 -> f64 escalation.

The f32 device MMA rows of the time-to-gap table resolve 1e-6 at the edge of
f32 bound accumulation (the QAP row's nominal hit shows a 2.8e-6
f64-evaluated gap). This benchmark runs the documented escalation: f32 MMA
on the chip until its relative progress stalls near the f32 floor, then
`extras.transfer_costs_to_native` warm-starts the native f64 OpenMP solver
(the reference's default double precision) which certifies the remaining
digits. Reported: wall time to a CERTIFIED <=1e-6 f64-evaluated gap vs the
converged bound, against pure-f64-C++ and pure-f32 rows.

Usage: python benchmarks/certify_gap.py [qap18|grid12|grid24|ct ...]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bdd_tpu.utils.platform import device_platform

device_platform()

import jax.numpy as jnp
import numpy as np

from bdd_tpu import native
from bdd_tpu.bdd.preprocessor import BddPreprocessor
from bdd_tpu.solver import uniform as uf
from bdd_tpu.solver.extras import transfer_costs_to_native
from bdd_tpu.utils.problems import cell_tracking, grid_mrf, quadratic_assignment


def build(which):
    if which == "qap18":
        ilp = quadratic_assignment(18, seed=0, density=0.06)
    elif which == "grid12":
        ilp = grid_mrf(12, 12, 4, seed=0)
    elif which == "grid24":
        ilp = grid_mrf(24, 24, 8, seed=0)
    elif which == "ct":
        ilp = cell_tracking(30, 40, seed=0)
    else:
        raise SystemExit(which)
    ilp.reorder_bfs()
    ilp.normalize()
    return BddPreprocessor(ilp)


def converged_bound(pre, V, obj, iters=30000):
    cs = native.cpu_solver_from_collection(pre.collection, V, obj)
    cs.iterations(iters, 0.5)
    return cs.lower_bound_with_deferred()


def main() -> int:
    families = sys.argv[1:] or ["qap18"]
    for which in families:
        pre = build(which)
        V = pre.total_nr_variables()
        obj = pre.objective_vector()
        print(f"## {which}: computing converged f64 bound...", flush=True)
        lb_star = converged_bound(pre, V, obj)
        tgt = abs(lb_star) * 1e-6
        print(f"## {which}: lb* = {lb_star:.9f} (target gap {tgt:.2e})",
              flush=True)

        # --- escalated row: f32 chip until stall, then f64 C++ finish
        host = uf.flatten_uniform(pre.collection, V, pre.nr_primal_variables)
        state = uf.init_uniform_state(host, obj)
        blk = 200
        # warm the compile outside the clock (production serves warm)
        state = uf.iterations(host.geom, state, blk, 0.5)
        float(state.lo[0][0, 0])
        state = uf.init_uniform_state(host, obj)
        t0 = time.time()
        prev = -np.inf
        it32 = 0
        while True:
            state = uf.iterations(host.geom, state, blk, 0.5)
            it32 += blk
            lb = float(uf.lower_bound_with_deferred(host.geom, state))
            if lb_star - lb <= tgt:
                break  # f32 alone certified (f64-evaluated below anyway)
            # f32 floor: relative progress under 2 f32 eps per block
            if abs(lb - prev) <= abs(lb) * 2.4e-7 or it32 >= 40000:
                break
            prev = lb
        t_f32 = time.time() - t0
        cs = native.cpu_solver_from_collection(pre.collection, V, obj)
        transfer_costs_to_native(host, state, cs)
        lb_warm = cs.lower_bound_with_deferred()
        it64 = 0
        while lb_star - cs.lower_bound_with_deferred() > tgt and it64 < 20000:
            cs.iterations(100, 0.5)
            it64 += 100
        t_total = time.time() - t0
        gap = (lb_star - cs.lower_bound_with_deferred()) / abs(lb_star)
        print(
            f"# escalated: f32 {it32} it in {t_f32:.2f}s "
            f"(f64-eval warm gap {(lb_star - lb_warm) / abs(lb_star):.2e}), "
            f"+ f64 C++ {it64} it -> certified gap {gap:.2e} "
            f"in {t_total:.2f}s TOTAL",
            flush=True,
        )

        # --- pure f64 C++ row
        cs2 = native.cpu_solver_from_collection(pre.collection, V, obj)
        t0 = time.time()
        it = 0
        while lb_star - cs2.lower_bound_with_deferred() > tgt and it < 60000:
            cs2.iterations(100, 0.5)
            it += 100
        print(
            f"# pure f64 C++: {it} it -> gap "
            f"{(lb_star - cs2.lower_bound_with_deferred()) / abs(lb_star):.2e}"
            f" in {time.time() - t0:.2f}s",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
