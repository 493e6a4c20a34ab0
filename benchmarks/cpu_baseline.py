"""Honest CPU baseline: native OpenMP parallel-MMA iterations/s per instance.

Measures the C++ multi-core deferred-MMA solver (native/bdd_host.cpp
CpuSolver; semantics of the reference's OpenMP parallel solver,
src/bdd_solver/bdd_parallel_mma_base.cpp:815-1044) on the benchmark
instance families, alongside the numpy oracle for context. These numbers are
the `vs_baseline` denominators for the device rows.

Usage: python benchmarks/cpu_baseline.py [family ...]
"""
from __future__ import annotations

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build(name):
    from bdd_tpu.utils.problems import (
        cell_tracking,
        graph_matching,
        grid_mrf,
        quadratic_assignment,
        set_cover,
    )

    if name == "grid12":
        return grid_mrf(12, 12, 4, seed=0)
    if name == "grid24":
        return grid_mrf(24, 24, 8, seed=0)
    if name == "grid32":
        return grid_mrf(32, 32, 12, seed=0)
    if name == "cover":
        # match benchmarks/run_all.py conditions
        return set_cover(3000, 6000, density=0.004, seed=0)
    if name == "gm120":
        from bdd_tpu.frontends.graph_matching import (
            construct_graph_matching_ilp,
        )

        return construct_graph_matching_ilp(
            graph_matching(120, 120, seed=0, candidates=6, nr_quadratic=2000)
        )[0]
    if name == "qap18":
        return quadratic_assignment(18, seed=0, density=0.06)
    if name == "ct":
        return cell_tracking(30, 40, nr_transitions=4, seed=0)
    raise KeyError(name)


def main(argv):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from bdd_tpu import native
    from bdd_tpu.bdd.preprocessor import BddPreprocessor
    from bdd_tpu.solver import RefSolver, flatten_collection

    families = argv or ["grid12", "grid24", "cover", "gm120", "qap18", "ct"]
    for name in families:
        t0 = time.time()
        ilp = build(name)
        ilp.reorder_bfs()
        ilp.normalize()
        pre = BddPreprocessor(ilp)
        cs = native.cpu_solver_from_collection(
            pre.collection, pre.total_nr_variables(), pre.objective_vector()
        )
        build_s = time.time() - t0

        # calibrate iteration blocks to ~2s of native work
        cs.iterations(2, 0.5)
        t0 = time.time()
        cs.iterations(3, 0.5)
        per = (time.time() - t0) / 3
        n = max(5, min(1000, int(2.0 / max(per, 1e-9))))
        t0 = time.time()
        cs.iterations(n, 0.5)
        native_s = time.time() - t0
        native_ips = n / native_s
        lb = cs.lower_bound_with_deferred()

        # numpy oracle for context (small fixed count)
        flat = flatten_collection(
            pre.collection, pre.total_nr_variables(), pre.nr_primal_variables
        )
        ref = RefSolver(flat, pre.objective_vector(), dtype=np.float64)
        n_ref = 3 if name in ("grid24", "grid32", "gm120") else 10
        t0 = time.time()
        for _ in range(n_ref):
            ref.iteration(0.5)
        ref_ips = n_ref / (time.time() - t0)

        print(
            f"{name}: bdds={pre.collection.nr_bdds()} "
            f"native C++ ({cs.nr_threads()} thr) {native_ips:.1f} it/s | "
            f"numpy {ref_ips:.1f} it/s | ratio {native_ips / ref_ips:.1f}x | "
            f"lb@{n + 5}={lb:.4f} | build {build_s:.1f}s",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
