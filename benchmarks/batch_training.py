"""Batched DOGE training throughput (one device).

The reference trains with batch_size 8 by concatenating the layer ranges of
several pickled solvers into one mega-solver per batch
(DOGE/configs/config_mis.py:8-30, bdd_cuda_torch.py:102-133). The JAX
analogue is structural: ``Instance.from_ilps`` lays several ILPs with
disjoint variable spaces into ONE collection, so the GNN message passing,
the delta exchange and the differentiable MMA iterations of the whole batch
run as a single compiled program — no per-instance launches.

Measures: epoch wall-clock for one batched train step over B instances vs B
sequential single-instance train steps (both jit-warm), and checks the
batched dual loss at init equals the sum of the per-instance losses.

Usage: python benchmarks/batch_training.py [batch] [nodes] [epochs]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main() -> int:
    from bdd_tpu.utils.platform import device_platform

    device_platform()
    from bdd_tpu.ilp import parse_lp_string
    from bdd_tpu.learn import DogeTrainer, TrainConfig
    from bdd_tpu.learn.train import Instance
    from bdd_tpu.utils.problems import independent_set

    B = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    nodes = int(sys.argv[2]) if len(sys.argv) > 2 else 80
    epochs = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    cfg = TrainConfig(dim=32, nr_rounds=3, iters_per_round=10, grad_rounds=1)

    t0 = time.time()
    ilps = [independent_set(nodes, edge_prob=0.08, seed=200 + i) for i in range(B)]
    singles = [Instance.from_ilp(parse_lp_string(i.write_lp())) for i in ilps]
    batched = Instance.from_ilps([parse_lp_string(i.write_lp()) for i in ilps])
    print(f"# built batch of {B} x {nodes}-node MIS in {time.time()-t0:.1f}s",
          flush=True)

    tr_b = DogeTrainer(cfg)
    tr_b.init(batched)
    tr_s = DogeTrainer(cfg)
    tr_s.init(singles[0])

    # warm both jit caches
    loss_b = tr_b.train_step(batched)["loss"]
    loss_s = sum(tr_s.train_step(s)["loss"] for s in singles)
    print(f"# warmup losses: batched {loss_b:.4f} vs sequential-sum {loss_s:.4f}")

    t0 = time.time()
    for _ in range(epochs):
        tr_b.train_step(batched)
    t_batched = (time.time() - t0) / epochs

    t0 = time.time()
    for _ in range(epochs):
        for s in singles:
            tr_s.train_step(s)
    t_seq = (time.time() - t0) / epochs

    print(f"batched epoch ({B} instances, one program): {t_batched*1e3:.1f} ms")
    print(f"sequential epoch ({B} train steps):         {t_seq*1e3:.1f} ms")
    print(f"training throughput gain: {t_seq / t_batched:.1f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
