"""DOGE-Train demo at benchmark scale (one device).

Protocol modeled on the reference MIS setup (DOGE/configs/config_mis.py:8-30,
scaled to this environment): Erdos-Renyi independent-set instances, train the
GNN policy with last-round gradients, evaluate on held-out instances against
plain isotropic MMA at the SAME dual-iteration budget, and against the
converged bound (plain MMA, 2000 iterations) as reference.

Usage: python benchmarks/train_doge_demo.py [size] [epochs] [family]
family (mirrors the reference's four DOGE dataset configs,
DOGE/configs/config_{mis,qaplib,ct,gm}.py):
  mis (default) — Erdos-Renyi independent set, size = #nodes
  qap           — QAPLib-style Fortet-linearized, size = n
  ct            — cell-tracking flow ILP (drosophila-style), size =
                  cells/frame (6 frames); free-update head on (ref config_ct)
  gm            — geometric graph matching with quadratic terms, size =
                  #points per side; free-update head on (ref config_gm)
Writes the checkpoint to benchmarks/doge_<family>.ckpt and prints a table.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from bdd_tpu.learn import DogeTrainer, TrainConfig
from bdd_tpu.learn.train import Instance, dual_metrics
from bdd_tpu.solver import uniform as uf
from bdd_tpu.utils.problems import (
    cell_tracking,
    graph_matching,
    independent_set,
    quadratic_assignment,
)


def main() -> int:
    from bdd_tpu.utils.platform import device_platform

    device_platform()
    nodes = int(sys.argv[1]) if len(sys.argv) > 1 else 120
    epochs = int(sys.argv[2]) if len(sys.argv) > 2 else 25
    family = sys.argv[3] if len(sys.argv) > 3 else "mis"
    n_train, n_test = 4, 2
    # demo-scale overrides over the per-family reference presets
    # (learn/configs.py maps the reference's config_{mis,gm,qaplib,ct});
    # the dual-iteration budget stays 60 across families so the equal-budget
    # comparison is uniform. The free-update head follows each preset.
    from bdd_tpu.learn import config_ct, config_gm, config_mis, config_qaplib

    preset = {"mis": config_mis, "qap": config_qaplib, "ct": config_ct,
              "gm": config_gm}[family]
    free = family in ("ct", "gm")
    cfg = preset(
        dim=32, nr_rounds=10 if free else 4,
        iters_per_round=6 if free else 15, grad_rounds=1, lr=1e-3,
        epochs=epochs, seed=0,
    )
    budget = cfg.nr_rounds * cfg.iters_per_round

    t0 = time.time()
    train_inst, test_inst = [], []
    for i in range(n_train + n_test):
        if family == "qap":
            ilp = quadratic_assignment(nodes, seed=100 + i, density=0.08)
        elif family == "ct":
            ilp = cell_tracking(6, nodes, seed=100 + i)
        elif family == "gm":
            from bdd_tpu.frontends.graph_matching import (
                construct_graph_matching_ilp,
            )

            ilp, _, _ = construct_graph_matching_ilp(graph_matching(
                nodes, nodes, seed=100 + i, candidates=5,
                nr_quadratic=3 * nodes,
            ))
        else:
            ilp = independent_set(nodes, edge_prob=0.08, seed=100 + i)
        inst = Instance.from_ilp(ilp)
        (train_inst if i < n_train else test_inst).append(inst)
    print(f"# built {n_train}+{n_test} instances ({nodes} nodes) "
          f"in {time.time()-t0:.1f}s", flush=True)

    tr = DogeTrainer(cfg)
    tr.init(train_inst[0])

    t0 = time.time()
    for ep in range(cfg.epochs):
        losses = [tr.train_step(inst)["loss"] for inst in train_inst]
        if ep % 5 == 0 or ep == cfg.epochs - 1:
            print(f"# epoch {ep}: mean loss {np.mean(losses):.4f} "
                  f"({time.time()-t0:.0f}s)", flush=True)
    train_s = time.time() - t0
    print(f"# training: {train_s:.1f}s wall", flush=True)

    rows = []
    for k, inst in enumerate(test_inst):
        # converged reference bound
        s_ref = uf.iterations(inst.host.geom, inst.state0, 2000, 0.5)
        ref_lb = float(uf.lower_bound_with_deferred(inst.host.geom, s_ref))
        # plain MMA, equal budget
        s_plain = uf.iterations(inst.host.geom, inst.state0, budget, 0.5)
        plain_lb = float(uf.lower_bound_with_deferred(inst.host.geom, s_plain))
        # learned policy, equal budget
        lbs = tr.run_learned_rounds(inst)
        m = dual_metrics(lbs, ref_lb)
        plain_gap = abs(ref_lb - plain_lb) / max(abs(ref_lb), 1e-9)
        rows.append((k, ref_lb, plain_lb, plain_gap, lbs[-1], m["final_gap"]))
        print(f"# test {k}: converged {ref_lb:.4f} | plain({budget} it) "
              f"{plain_lb:.4f} gap {100*plain_gap:.2f}% | learned {lbs[-1]:.4f} "
              f"gap {100*m['final_gap']:.2f}%", flush=True)

    ckpt = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), f"doge_{family}.ckpt"
    )
    tr.save(ckpt)
    print(f"# checkpoint -> {ckpt}")
    gaps = np.array([[r[3], r[5]] for r in rows])
    print(f"RESULT family={family} size={nodes} budget={budget} train_s={train_s:.0f} "
          f"plain_gap={100*gaps[:,0].mean():.2f}% "
          f"learned_gap={100*gaps[:,1].mean():.2f}% "
          f"ratio={gaps[:,0].mean()/max(gaps[:,1].mean(),1e-12):.1f}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
