"""Dual-MMA iteration rates and time-to-1e-3-gap per benchmark family, on
one GPU.

Usage: python benchmarks/run_all.py [quick]

Measures warm steady-state dual-MMA iteration rates of the uniform backend
on the benchmark families, plus time-to-1e-3-gap. Every timed section ends
in ``block_until_ready`` and is preceded by a warm-up call of the same
compiled program. Run nothing else on the card meanwhile.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from bdd_tpu.utils.platform import device_platform

device_platform(require="gpu")
import jax.numpy as jnp
import numpy as np

from bdd_tpu.native import NativeHost
from bdd_tpu.solver import uniform as uf
from bdd_tpu.solver.flatten import flatten_collection
from bdd_tpu.solver.ref_solver import RefSolver
from bdd_tpu.utils.problems import (
    grid_mrf,
    quadratic_assignment,
    set_cover,
    graph_matching,
)


def sync(s):
    return jax.block_until_ready(s)


def bench_instance(name, lp, n_iters=2000, numpy_iters=10):
    """Warm steady-state it/s. Protocol (matching bench.py): 500-iteration
    compiled blocks, >= 2000 iterations per measurement, ONE host sync at
    the end, so that the per-call dispatch and sync are amortized."""
    t0 = time.time()
    nh = NativeHost(lp, "bfs")
    host = nh.make_uniform_host()
    state = uf.init_uniform_state(host, nh.objective())
    print(f"[{name}] build+first-compile {time.time() - t0:.1f}s "
          f"({nh.nr_bdds()} bdds)")
    block = 500
    s = uf.iterations(host.geom, state, block, 0.5)
    sync(s)  # compile + warm
    rates = []
    out = s
    for _ in range(3):
        t0 = time.time()
        for _ in range(max(1, n_iters // block)):
            out = uf.iterations(host.geom, out, block, 0.5)
        sync(out)
        rates.append(
            block * max(1, n_iters // block) / (time.time() - t0)
        )
    rate = float(np.median(rates))
    dt = 1.0 / rate
    lb = float(uf.lower_bound_with_deferred(host.geom, out))
    print(f"[{name}] device: {rate:.0f} it/s "
          f"({dt * 1e3:.3f} ms/iter, median of 3), lb={lb:.4f}")

    col = nh.collection()
    flat = flatten_collection(col, nh.nr_vars())
    ref = RefSolver(flat, nh.objective())
    t0 = time.time()
    for _ in range(numpy_iters):
        ref.iteration(0.5)
    dt_np = (time.time() - t0) / numpy_iters
    print(f"[{name}] numpy: {1 / dt_np:.1f} it/s; device speedup {dt_np / dt:.1f}x")
    return host, nh


def time_to_gap(name, lp, rel=1e-3, max_iters=4000):
    nh = NativeHost(lp, "bfs")
    host = nh.make_uniform_host()
    state = uf.init_uniform_state(host, nh.objective())
    s = uf.iterations(host.geom, state, 2000, 0.5)
    ref_lb = float(uf.lower_bound_with_deferred(host.geom, s))
    target = ref_lb - abs(ref_lb) * rel
    s = uf.iterations(host.geom, state, 50, 0.5)
    sync(s)  # warm
    s = state
    t0 = time.time()
    iters = 0
    reached = False
    period = 1  # doubling check period (run_solver's treatment): the lb
    while iters < max_iters:  # fetch is a host sync
        for _ in range(period):
            if iters >= max_iters:
                break
            s = uf.iterations(host.geom, s, 50, 0.5)
            iters += 50
        period = min(period * 2, 16)
        if float(uf.lower_bound_with_deferred(host.geom, s)) >= target:
            reached = True
            break
    status = "" if reached else " [NOT CONVERGED]"
    print(f"[{name}] time-to-{rel:g}-gap: {time.time() - t0:.2f}s ({iters} iters, "
          f"converged lb {ref_lb:.4f}){status}")


def main():
    quick = len(sys.argv) > 1 and sys.argv[1] == "quick"
    bench_instance("grid-mrf-12x12x4", grid_mrf(12, 12, 4, seed=0).write_lp())
    time_to_gap("grid-mrf-12x12x4", grid_mrf(12, 12, 4, seed=0).write_lp())
    if quick:
        return
    bench_instance("grid-mrf-24x24x8", grid_mrf(24, 24, 8, seed=0).write_lp(),
                   numpy_iters=5)
    time_to_gap("grid-mrf-24x24x8", grid_mrf(24, 24, 8, seed=0).write_lp())
    bench_instance("set-cover-3000x6000",
                   set_cover(3000, 6000, density=0.004, seed=0).write_lp(),
                   numpy_iters=5)
    from bdd_tpu.frontends.graph_matching import construct_graph_matching_ilp

    gm = construct_graph_matching_ilp(
        graph_matching(120, 120, seed=0, candidates=6, nr_quadratic=2000)
    )[0]
    bench_instance("graph-matching-120", gm.write_lp(), numpy_iters=5)
    time_to_gap("graph-matching-120", gm.write_lp())
    qap_lp = quadratic_assignment(18, seed=0, density=0.06).write_lp()
    bench_instance("qap-18 (Fortet-linearized, dense quadratic)", qap_lp,
                   numpy_iters=5)
    time_to_gap("qap-18", qap_lp)
    from bdd_tpu.utils.problems import cell_tracking

    ct_lp = cell_tracking(30, 40, nr_transitions=4, seed=0).write_lp()
    bench_instance("cell-tracking-30x40 (drosophila-style flow ILP)", ct_lp,
                   numpy_iters=5)
    time_to_gap("cell-tracking-30x40", ct_lp)


if __name__ == "__main__":
    main()
