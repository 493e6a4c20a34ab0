"""Hybrid host+device solve on a deep-BDD instance (real chip).

The instance class the hybrid mode targets (ref
bdd_multi_parallel_mma_base.cu:15-128 — long BDDs starve the accelerator's
hop wavefront): set cover 500x2000 plus one global <=300-of-2000 cardinality
row whose BDD is 2000 levels deep with frontier width 301 (~600k nodes).
Compared, all warm, same normalized instance:

  cpu     native C++ OpenMP parallel MMA over the whole problem (f64)
  device  uniform backend unsplit (the depth-2000 BDD serializes the sweep)
  split   uniform + split_qbdd "auto" chunks (sequence parallelism; the
          round-2 answer to deep BDDs — adds one-hot coupling variables)
  hybrid  solver/hybrid.py: cardinality BDD on the host solver, the 500
          short rows on the chip, delta consensus per half-sweep

Run: python benchmarks/hybrid_solver.py
"""
import sys
import time

sys.path.insert(0, ".")

from bdd_tpu.utils.platform import device_platform  # noqa: E402

device_platform()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from bdd_tpu import native  # noqa: E402
from bdd_tpu.bdd.preprocessor import BddPreprocessor  # noqa: E402
from bdd_tpu.ilp.model import Ineq  # noqa: E402
from bdd_tpu.solver import uniform as uf  # noqa: E402
from bdd_tpu.solver.hybrid import HybridSolver  # noqa: E402
from bdd_tpu.utils.problems import set_cover  # noqa: E402


def make_instance():
    ilp = set_cover(500, 2000, density=0.004, seed=0)
    vs = list(range(2000))
    ilp.add_linear_constraint([1] * 2000, vs, Ineq.LEQ, 300)
    ilp.reorder_bfs()
    ilp.normalize()
    return ilp


def time_uniform(pre, label, iters=60, block=20):
    host = uf.flatten_uniform(
        pre.collection, pre.total_nr_variables(), pre.nr_primal_variables
    )
    state = uf.init_uniform_state(host, pre.objective_vector())
    t0 = time.time()
    warm = uf.iterations(host.geom, state, block, 0.5)
    float(warm.lo[0][0, 0])
    print(f"# {label}: compile+warm {time.time() - t0:.1f}s", file=sys.stderr)
    t0 = time.time()
    out = warm
    for _ in range(iters // block):
        out = uf.iterations(host.geom, out, block, 0.5)
    float(out.lo[0][0, 0])
    dt = time.time() - t0
    lb = float(uf.lower_bound_with_deferred(host.geom, out))
    return iters / dt, lb, block + iters


def main():
    ilp = make_instance()

    rows = []

    # --- cpu (whole problem, f64)
    pre = BddPreprocessor(ilp)
    cs = native.cpu_solver_from_collection(
        pre.collection, pre.total_nr_variables(), pre.objective_vector()
    )
    cs.iterations(5, 0.5)
    t0 = time.time()
    n = 60
    cs.iterations(n, 0.5)
    cpu_ips = n / (time.time() - t0)
    cs.iterations(100, 0.5)
    rows.append(("cpu (4-thread f64)", cpu_ips, cs.lower_bound_with_deferred()))

    # --- hybrid (auto threshold puts the cardinality BDD on the host)
    hs = HybridSolver(
        pre.collection,
        pre.total_nr_variables(),
        pre.objective_vector(),
        nr_primal_vars=pre.nr_primal_variables,
        dtype=jnp.float32,
    )
    print(
        f"# hybrid: {len(hs.host_bdds)} host / {len(hs.device_bdds)} device "
        f"BDDs, threshold {hs.hop_threshold}, mode {hs.mode}",
        file=sys.stderr,
    )
    t0 = time.time()
    hs.iteration_block(5)
    print(f"# hybrid: compile+warm {time.time() - t0:.1f}s", file=sys.stderr)
    t0 = time.time()
    hs.iteration_block(60)
    hy_ips = 60 / (time.time() - t0)
    hs.iteration_block(100)  # 165 total
    rows.append(("hybrid (host+chip)", hy_ips, hs.lower_bound_with_deferred()))
    hs.close()

    # --- device unsplit (deep BDD serializes the sweep; big compile)
    try:
        ips, lb, it = time_uniform(pre, "device unsplit", iters=40, block=20)
        rows.append(("device unsplit", ips, lb))
    except Exception as e:
        print(f"# device unsplit failed: {e}", file=sys.stderr)

    # --- device + auto split_qbdd
    pre_s = BddPreprocessor(ilp, split_chunk_size="auto")
    ips, lb, it = time_uniform(pre_s, "device auto-split", iters=60, block=20)
    rows.append(("device auto-split", ips, lb))

    print(f"{'variant':24s} {'it/s':>8s}  lb(warm+measured iters)")
    for name, ips, lb in rows:
        print(f"{name:24s} {ips:8.1f}  {lb:.4f}")


if __name__ == "__main__":
    raise SystemExit(main())
