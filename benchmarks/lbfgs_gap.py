"""L-BFGS vs plain MMA: wall time to a 1e-3 relative dual gap (one GPU).

The reference's L-BFGS variant (Roetzer et al. 2023; include/bdd_solver/
lbfgs_impl.h) accelerates convergence on hard families at the price of
host-side outer control flow. This runs the "time-to-gap" protocol for the `lbfgs mma` configuration after the two-loop-recursion
Hessian-scaling fix (the old direction had cosine ~0.5 to the textbook one).

Usage: python benchmarks/lbfgs_gap.py [quick]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bdd_tpu.utils.platform import device_platform

device_platform(require="gpu")

from bdd_tpu.native import NativeHost
from bdd_tpu.solver.lbfgs import LbfgsSolver
from bdd_tpu.solver.uniform_wrapper import UniformSolver
from bdd_tpu.utils.problems import (
    cell_tracking,
    graph_matching,
    grid_mrf,
    quadratic_assignment,
)


def make_solver(lp: str) -> UniformSolver:
    nh = NativeHost(lp, "bfs")
    return UniformSolver(nh.collection(), nh.nr_vars(), nh.objective())


def converged_bound(lp: str, mma_iters: int = 3000, lbfgs_iters: int = 400) -> float:
    s = make_solver(lp)
    s.iteration_block(mma_iters)
    best = s.lower_bound_with_deferred()
    ls = LbfgsSolver(make_solver(lp))
    for _ in range(lbfgs_iters):
        ls.iteration()
    return max(best, ls.lower_bound_with_deferred())


def time_mma(lp: str, target: float, max_iters: int = 4000):
    s = make_solver(lp)
    s.iteration_block(50)
    s.lower_bound_with_deferred()  # compile + warm both programs
    s = make_solver(lp)
    t0 = time.time()
    iters = 0
    while iters < max_iters:
        s.iteration_block(50)
        iters += 50
        if s.lower_bound_with_deferred() >= target:
            return time.time() - t0, iters, s.lower_bound_with_deferred()
    return time.time() - t0, iters, s.lower_bound_with_deferred()


def time_lbfgs(lp: str, target: float, max_iters: int = 1500, check: int = 5):
    warm = LbfgsSolver(make_solver(lp))
    for _ in range(12):  # compile iteration + lb + the lbfgs device primitives
        warm.iteration()
    warm.lower_bound_with_deferred()
    s = LbfgsSolver(make_solver(lp))
    t0 = time.time()
    iters = 0
    while iters < max_iters:
        for _ in range(check):
            s.iteration()
        iters += check
        if s.lower_bound_with_deferred() >= target:
            return time.time() - t0, iters, s.lower_bound_with_deferred()
    return time.time() - t0, iters, s.lower_bound_with_deferred()


def run(name: str, lp: str, rel: float = 1e-3) -> None:
    t0 = time.time()
    best = converged_bound(lp)
    target = best - abs(best) * rel
    print(f"[{name}] converged lb {best:.4f} (ref computed in "
          f"{time.time() - t0:.0f}s)")
    t_m, it_m, lb_m = time_mma(lp, target)
    ok_m = "" if lb_m >= target else " [NOT CONVERGED]"
    print(f"[{name}] mma:   {t_m:.2f}s ({it_m} iters, lb {lb_m:.4f}){ok_m}")
    t_l, it_l, lb_l = time_lbfgs(lp, target)
    ok_l = "" if lb_l >= target else " [NOT CONVERGED]"
    print(f"[{name}] lbfgs: {t_l:.2f}s ({it_l} outer iters, lb {lb_l:.4f})"
          f"{ok_l}  ({t_m / t_l:.1f}x vs mma)" , flush=True)


def main() -> None:
    quick = len(sys.argv) > 1 and sys.argv[1] == "quick"
    run("grid-mrf-12x12x4", grid_mrf(12, 12, 4, seed=0).write_lp())
    if quick:
        return
    from bdd_tpu.frontends.graph_matching import construct_graph_matching_ilp

    run("qap-18", quadratic_assignment(18, seed=0, density=0.06).write_lp())
    gm = construct_graph_matching_ilp(
        graph_matching(120, 120, seed=0, candidates=6, nr_quadratic=2000)
    )[0]
    run("graph-matching-120", gm.write_lp())
    run("cell-tracking-30x40",
        cell_tracking(30, 40, nr_transitions=4, seed=0).write_lp())


if __name__ == "__main__":
    main()
