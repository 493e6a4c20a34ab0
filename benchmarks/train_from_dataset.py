"""Dataset-driven DOGE training, end to end.

One command reproduces the reference's train path shape
(DOGE/train_doge.py:20-37 -> disk_dataloader.py): a directory of .lp
instances is scanned by IlpDiskDataset, per-instance caches are built on
first touch (bdd_repr pickles, framework-native ground truth, converged
f64 duals via --converged semantics) and demonstrably HIT on the second
scan; DogeTrainer then trains across the dataset instances and evaluates
on a held-out directory against the cached converged bounds.

  python benchmarks/train_from_dataset.py [root] [epochs]

Default root /tmp/bdd_tpu_dataset_qap16 is (re)generated if empty:
6 train + 3 held-out qap16 instances. Appends results to LEARNED.md.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bdd_tpu.utils.platform import device_platform

device_platform()

import numpy as np

from bdd_tpu.learn.configs import config_qaplib
from bdd_tpu.learn.data import IlpDiskDataset
from bdd_tpu.learn.train import DogeTrainer
from bdd_tpu.solver import uniform as uf
from bdd_tpu.utils.problems import quadratic_assignment


def generate_instances(root: str) -> None:
    for sub, seeds in (("train", range(6)), ("eval", (100, 101, 102))):
        d = os.path.join(root, sub, "instances")
        os.makedirs(d, exist_ok=True)
        for s in seeds:
            p = os.path.join(d, f"qap16_s{s}.lp")
            if not os.path.exists(p):
                ilp = quadratic_assignment(16, seed=s, density=0.06)
                with open(p, "w") as fh:
                    fh.write(ilp.write_lp())


def bound_of(inst) -> float:
    return float(
        uf.lower_bound_with_deferred(inst.host.geom, inst.state0)
    )


def main():
    root = sys.argv[1] if len(sys.argv) > 1 else "/tmp/bdd_tpu_dataset_qap16"
    epochs = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    generate_instances(root)
    train_dir = os.path.join(root, "train")
    eval_dir = os.path.join(root, "eval")

    # ---- phase A: cache build (first scan converges duals + generates GT)
    t0 = time.time()
    ds_conv = IlpDiskDataset(
        train_dir, read_dual_converged=True, need_gt=True,
        load_in_memory=True,
    )
    ds_eval_conv = IlpDiskDataset(
        eval_dir, read_dual_converged=True, need_gt=True,
        load_in_memory=True,
    )
    t_build = time.time() - t0
    # ---- phase B: cache hit (re-scan must reuse every artifact)
    t0 = time.time()
    ds_cold = IlpDiskDataset(train_dir, load_in_memory=True, verbose=False)
    ds_eval = IlpDiskDataset(eval_dir, load_in_memory=True, verbose=False)
    t_hit = time.time() - t0
    n_pkl = sum(
        name.endswith(".pkl")
        for _, _, names in os.walk(root)
        for name in names
    )
    print(
        f"# dataset: {len(ds_cold)} train + {len(ds_eval)} eval; cache "
        f"build {t_build:.0f}s, warm re-scan {t_hit:.2f}s ({n_pkl} cached "
        f"artifacts)",
        flush=True,
    )
    assert t_hit < max(5.0, 0.2 * t_build), "cache not hit on re-scan"

    # converged reference bounds from the --converged caches (no re-solve)
    conv_bounds = {}
    for i in range(len(ds_eval_conv)):
        inst, gt, path = ds_eval_conv[i]
        conv_bounds[path] = bound_of(inst)
        lp_obj = gt["lp_stats"]["obj"]
        print(
            f"# eval {os.path.basename(path)}: converged-cache bound "
            f"{conv_bounds[path]:.4f}, gt lp obj {lp_obj:.4f}",
            flush=True,
        )

    # ---- training across the dataset (cold starts; per-instance programs)
    rounds, iters = 20, 20
    cfg = config_qaplib(
        nr_rounds=rounds, iters_per_round=iters, grad_rounds=1,
        use_replay=True, epochs=epochs, dim=32,
    )
    tr = DogeTrainer(cfg)
    inst0, _, _ = ds_cold[0]
    tr.init(inst0)
    epoch_walls = []
    for ep in range(epochs):
        t0 = time.time()
        losses = []
        for i in range(len(ds_cold)):
            inst, _gt, _p = ds_cold[i]
            losses.append(tr.train_step(inst)["loss"])
        epoch_walls.append(time.time() - t0)
        print(
            f"# epoch {ep + 1}/{epochs}: mean loss {np.mean(losses):.4f} "
            f"({epoch_walls[-1]:.1f}s)",
            flush=True,
        )

    # ---- held-out eval: learned rollout vs the cached converged bound
    lines = [
        "",
        f"## dataset-driven training (IlpDiskDataset end to end, "
        f"{len(ds_cold)} train qap16, {epochs} epochs, {rounds}x{iters})",
        "",
        f"Cache build {t_build:.0f}s (converged duals + framework GT), "
        f"warm re-scan {t_hit:.2f}s — caches hit. First epoch "
        f"{epoch_walls[0]:.1f}s (compiles {len(ds_cold)} geometries), "
        f"steady epochs {np.median(epoch_walls[1:]):.1f}s.",
        "",
        "| held-out | converged bound (cache) | learned best | gap | "
        "rollout wall |",
        "|---|---|---|---|---|",
    ]
    for i in range(len(ds_eval)):
        inst, _gt, path = ds_eval[i]
        ref = conv_bounds[path]
        tr.run_learned_rounds(inst, nr_rounds=rounds)  # warm (same n)
        t0 = time.time()
        lbs = tr.run_learned_rounds(inst, nr_rounds=rounds)
        wall = time.time() - t0
        best = max(lbs)
        gap = abs(ref - best) / max(abs(ref), 1e-9)
        name = os.path.basename(path)
        print(
            f"# {name}: conv {ref:.4f} learned {best:.4f} gap {gap:.2e} "
            f"({wall:.2f}s)",
            flush=True,
        )
        lines.append(
            f"| {name} | {ref:.4f} | {best:.4f} | {gap:.2e} | {wall:.2f} s |"
        )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "LEARNED.md"), "a") as fh:
        fh.write("\n".join(lines) + "\n")
    print("# appended results to LEARNED.md", flush=True)


if __name__ == "__main__":
    main()
