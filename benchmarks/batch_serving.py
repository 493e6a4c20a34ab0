"""Batched-serving benchmark: K independent instances solved as ONE batch
(utils/batching.BatchedInstances) vs sequentially, on one chip.

The uniform bucketed layout batches all instances into the same tensors for
free; the delta exchange never mixes instances (disjoint variables).
Default: 64 x 100-node MIS, 100 iterations each, batched vs sequential.

Usage: python benchmarks/batch_serving.py [K] [nodes]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from bdd_tpu.utils.platform import device_platform

device_platform()
import numpy as np

from bdd_tpu.bdd.preprocessor import BddPreprocessor
from bdd_tpu.solver import uniform as uf
from bdd_tpu.utils.batching import BatchedInstances
from bdd_tpu.utils.problems import independent_set


def sync(s):
    return float(jax.tree.leaves(s)[0].ravel()[0])


def main() -> int:
    K = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    nodes = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    blk = 100
    ilps = [independent_set(nodes, edge_prob=0.08, seed=s) for s in range(K)]
    t0 = time.time()
    bat = BatchedInstances(ilps)
    host = uf.flatten_uniform(bat.collection, len(bat.objective))
    state = uf.init_uniform_state(host, bat.objective)
    print(f"# batch build {time.time()-t0:.1f}s ({host.nr_bdds} bdds)",
          flush=True)
    s = uf.iterations(host.geom, state, blk, 0.5)
    sync(s)
    t0 = time.time()
    out = s
    for _ in range(4):
        out = uf.iterations(host.geom, out, blk, 0.5)
    sync(out)
    dt_batch = (time.time() - t0) / 4
    print(f"# batched: {K} x {blk} iters in {dt_batch*1e3:.1f} ms "
          f"({K*blk/dt_batch:.0f} instance-iters/s)", flush=True)

    pre = BddPreprocessor(ilps[0])
    h1 = uf.flatten_uniform(
        pre.collection, pre.total_nr_variables(), pre.nr_primal_variables
    )
    s1 = uf.init_uniform_state(h1, pre.objective_vector())
    w = uf.iterations(h1.geom, s1, blk, 0.5)
    sync(w)
    t0 = time.time()
    o = w
    for _ in range(4):
        o = uf.iterations(h1.geom, o, blk, 0.5)
    sync(o)
    dt_one = (time.time() - t0) / 4
    print(f"# single: {blk} iters in {dt_one*1e3:.1f} ms")
    # the sequential baseline is K x the measured single-instance time
    # (instances share the size class; solving all K sequentially would
    # mostly measure per-instance compile time) — marked as estimated
    print(f"RESULT batch_speedup={K*dt_one/dt_batch:.1f}x "
          f"({K} x {nodes}-node MIS; sequential baseline estimated as "
          f"K x single-instance time)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
