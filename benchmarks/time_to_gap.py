"""Time-to-gap: the BASELINE.json north-star metric, measured as written.

Wall time to reach a RELATIVE 1e-6 (and 1e-3) dual gap to the converged
bound, per family, for:
  - device uniform MMA (f32, the production config)
  - device uniform MMA (f64, the reference's default precision — README.md:53)
  - native C++ OpenMP parallel MMA (the CPU baseline)
  - device L-BFGS outer loop (defaults of lbfgs.h:29-33)

The converged reference bound per family = max over a long f64 MMA run and a
long L-BFGS run. Methods that exhaust their iteration budget report the gap
they reached (MMA's tail is sublinear on LP-loose families; L-BFGS is the
configuration meant for tight gaps).

Usage: python benchmarks/time_to_gap.py [fast]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bdd_tpu.utils.platform import device_platform

device_platform(require="gpu")

import jax.numpy as jnp

from bdd_tpu import native
from bdd_tpu.native import NativeHost
from bdd_tpu.solver import uniform as uf
from bdd_tpu.solver.lbfgs import LbfgsSolver
from bdd_tpu.solver.uniform_wrapper import UniformSolver
from bdd_tpu.utils.problems import (
    cell_tracking,
    graph_matching,
    grid_mrf,
    quadratic_assignment,
)


def make_solver(nh, dtype=jnp.float32) -> UniformSolver:
    if dtype == jnp.float64:
        import jax

        jax.config.update("jax_enable_x64", True)
    return UniformSolver(nh.collection(), nh.nr_vars(), nh.objective(),
                         dtype=dtype)


def converged_bound(nh, mma_iters, lbfgs_iters) -> float:
    """Reference bound from the native C++ double solver + device L-BFGS
    (the C++ CpuSolver runs the same deferred-MMA iteration in doubles,
    independently of the device code)."""
    cs = nh.cpu_solver()
    cs.iterations(mma_iters, 0.5)
    best = cs.lower_bound_with_deferred()
    ls = LbfgsSolver(make_solver(nh))
    for _ in range(max(1, lbfgs_iters // 25)):
        ls.iteration_block(25)
    return max(best, ls.lower_bound_with_deferred())


def time_to(lb_fn, iterate, targets, max_iters, block):
    """Generic: returns {rel: (secs, iters)} plus the final (lb, iters).

    The lb fetch is a host sync, so the check period DOUBLES (cap 8
    blocks) like run_solver's (granularity: a target can overshoot by <= 8
    blocks)."""
    remaining = dict(targets)
    hit = {}
    t0 = time.time()
    iters = 0
    period = 1
    while iters < max_iters and remaining:
        for _ in range(period):
            if iters >= max_iters:
                break
            iterate(block)
            iters += block
        period = min(period * 2, 8)
        lb = lb_fn()
        for rel, tgt in list(remaining.items()):
            if lb >= tgt:
                hit[rel] = (time.time() - t0, iters)
                del remaining[rel]
    return hit, (lb_fn(), iters, time.time() - t0)


def fmt(hit, rel):
    if rel in hit:
        t, it = hit[rel]
        return f"{t:7.2f}s ({it:5d} it)"
    return "      —  (budget)  "


def run(name, ilp_or_lp, mma_ref=20000, lbfgs_ref=1500, max_iters=40000,
        block=100, cpu_max=25000):
    lp = ilp_or_lp if isinstance(ilp_or_lp, str) else ilp_or_lp.write_lp()
    nh = NativeHost(lp, "bfs")
    t0 = time.time()
    best = converged_bound(nh, mma_ref, lbfgs_ref)
    targets = {r: best - abs(best) * r for r in (1e-3, 1e-6)}
    print(f"[{name}] converged lb {best:.6f} (ref {time.time()-t0:.0f}s)",
          flush=True)

    rows = []

    # device f32 MMA
    s = make_solver(nh)
    s.iteration_block(block)
    s.lower_bound_with_deferred()  # warm/compile
    s = make_solver(nh)
    hit, fin = time_to(
        s.lower_bound_with_deferred, s.iteration_block, targets, max_iters,
        block,
    )
    rows.append(("dev mma f32", hit, fin))

    # device f64 MMA at the reference's default precision
    s = make_solver(nh, jnp.float64)
    s.iteration_block(block)
    s.lower_bound_with_deferred()
    s = make_solver(nh, jnp.float64)
    hit, fin = time_to(
        s.lower_bound_with_deferred, s.iteration_block, targets,
        max_iters, block,
    )
    rows.append(("dev mma f64", hit, fin))

    # native C++ CPU baseline
    cs = nh.cpu_solver()
    hit, fin = time_to(
        cs.lower_bound_with_deferred,
        lambda n: cs.iterations(n, 0.5),
        targets,
        cpu_max,
        block,
    )
    rows.append(("cpu C++", hit, fin))

    # device L-BFGS (outer loop; 10-iteration device blocks)
    warm = LbfgsSolver(make_solver(nh))
    warm.iteration_block(10)
    warm.lower_bound_with_deferred()
    ls = LbfgsSolver(make_solver(nh))
    hit, fin = time_to(
        ls.lower_bound_with_deferred, ls.iteration_block, targets, 4000, 10
    )
    rows.append(("dev lbfgs", hit, fin))

    for label, hit, (lb, iters, secs) in rows:
        gap = abs(best - lb) / max(abs(best), 1e-12)
        print(f"[{name}] {label:13s} 1e-3: {fmt(hit, 1e-3)}  "
              f"1e-6: {fmt(hit, 1e-6)}  final gap {gap:.1e} "
              f"after {iters} it / {secs:.1f}s", flush=True)


def main():
    fast = len(sys.argv) > 1 and sys.argv[1] == "fast"
    run("grid-mrf-12x12x4", grid_mrf(12, 12, 4, seed=0))
    if fast:
        return
    run("qap-18", quadratic_assignment(18, seed=0, density=0.06))
    run("cell-tracking-30x40", cell_tracking(30, 40, nr_transitions=4, seed=0))
    run("grid-mrf-24x24x8", grid_mrf(24, 24, 8, seed=0), mma_ref=12000,
        max_iters=20000, cpu_max=8000)
    from bdd_tpu.frontends.graph_matching import construct_graph_matching_ilp

    gm = construct_graph_matching_ilp(
        graph_matching(120, 120, seed=0, candidates=6, nr_quadratic=2000)
    )[0]
    # lbfgs_ref 800 -> 2400: with the round-5 direction-fixed + block-scanned
    # L-BFGS the eval run at 870 iters EXCEEDED the 800-iteration reference
    # bound (its row read "1e-6 reached" against an under-converged target)
    run("graph-matching-120", gm, mma_ref=8000, lbfgs_ref=2400,
        max_iters=12000, cpu_max=5000)


if __name__ == "__main__":
    main()
