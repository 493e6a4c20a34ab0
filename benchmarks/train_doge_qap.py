"""DOGE training on the QAP family at reference protocol scale.

Protocol (DOGE/configs/config_mis.py:8-30 applied to QAP, the reference's
flagship family): 20 dual rounds x 20 dual iterations per round, batch 8,
trajectory replay across epochs, gradients through the last round. Model:
layer-norm GNN with the reference feature lists (learn/configs.config_qaplib
feature depth) + free-update head.

Evaluation on held-out instances at EQUAL solver budget (400 dual
iterations): learned rounds vs plain MMA vs L-BFGS; per-round gap curve vs a
converged f64 reference bound. Appends the table to LEARNED.md and writes
benchmarks/doge_qap.ckpt.

Usage: python benchmarks/train_doge_qap.py [epochs] [qap_n]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bdd_tpu.utils.platform import device_platform

device_platform()


from bdd_tpu.learn.configs import config_qaplib
from bdd_tpu.learn.train import DogeTrainer, Instance, dual_metrics
from bdd_tpu.solver.lbfgs import LbfgsSolver
from bdd_tpu.solver.uniform_wrapper import UniformSolver
from bdd_tpu.utils.problems import quadratic_assignment


def make_ilps(seeds, n):
    return [quadratic_assignment(n, seed=s, density=0.3) for s in seeds]


def main():
    epochs = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    qap_n = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    rounds, iters = 20, 20

    cfg = config_qaplib(
        nr_rounds=rounds,
        iters_per_round=iters,
        grad_rounds=1,
        use_replay=True,
        epochs=epochs,
        dim=32,
    )
    print(f"# config: {cfg}", flush=True)

    t0 = time.time()
    train_inst = Instance.from_ilps(make_ilps(range(8), qap_n))
    print(
        f"# train batch: 8 x qap-{qap_n} -> {train_inst.host.nr_bdds} bdds, "
        f"{train_inst.host.nr_vars} vars, E={train_inst.spec.E} "
        f"(build {time.time()-t0:.0f}s)",
        flush=True,
    )

    tr = DogeTrainer(cfg)
    t0 = time.time()
    tr.init(train_inst)
    print(f"# init: {time.time()-t0:.0f}s", flush=True)
    t0 = time.time()
    for ep in range(epochs):
        m = tr.train_step(train_inst)
        if ep < 3 or (ep + 1) % 5 == 0:
            print(
                f"# epoch {ep+1}/{epochs}: loss {m['loss']:.4f} "
                f"({time.time()-t0:.0f}s)",
                flush=True,
            )
    ck = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "doge_qap.ckpt"
    )
    tr.save(ck)
    print(f"# saved {ck}", flush=True)

    # ------------------------------------------------------------- evaluation
    lines = [
        "",
        f"## QAP protocol run (batch 8 x qap-{qap_n}, {rounds} rounds x "
        f"{iters} iters, replay, {epochs} epochs, layer-norm GNN + reference "
        "feature lists)",
        "",
        "| instance | budget | plain MMA gap | L-BFGS gap | learned gap |",
        "|---|---|---|---|---|",
    ]
    for seed in (100, 101, 102):
        ilp = make_ilps([seed], qap_n)[0]
        inst = Instance.from_ilp(ilp)

        # converged reference bound: native C++ double MMA long run (f64,
        # independent of the device code) + a device L-BFGS polish run
        from bdd_tpu import native
        from bdd_tpu.bdd.preprocessor import BddPreprocessor

        ilp2 = make_ilps([seed], qap_n)[0]
        ilp2.normalize()
        pre = BddPreprocessor(ilp2)
        cs = native.cpu_solver_from_collection(
            pre.collection, pre.total_nr_variables(), pre.objective_vector()
        )
        cs.iterations(20000, 0.5)
        ls_ref = LbfgsSolver(
            UniformSolver(
                pre.collection, pre.total_nr_variables(),
                pre.objective_vector(),
                nr_primal_vars=pre.nr_primal_variables,
            )
        )
        for _ in range(1000):
            ls_ref.iteration()
        best = max(
            cs.lower_bound_with_deferred(), ls_ref.lower_bound_with_deferred()
        )

        budget = rounds * iters
        mma = UniformSolver(
            pre.collection, pre.total_nr_variables(), pre.objective_vector(),
            nr_primal_vars=pre.nr_primal_variables,
        )
        mma.iteration_block(budget)
        gap_mma = abs(best - mma.lower_bound_with_deferred()) / max(
            abs(best), 1e-9
        )

        lb_l = LbfgsSolver(
            UniformSolver(
                pre.collection, pre.total_nr_variables(),
                pre.objective_vector(),
                nr_primal_vars=pre.nr_primal_variables,
            )
        )
        for _ in range(budget):
            lb_l.iteration()
        gap_lbfgs = abs(best - lb_l.lower_bound_with_deferred()) / max(
            abs(best), 1e-9
        )

        lbs = tr.run_learned_rounds(inst, nr_rounds=rounds)
        met = dual_metrics(lbs, best)
        print(
            f"# qap-{qap_n} seed {seed}: best {best:.4f} | mma {gap_mma:.2e} "
            f"| lbfgs {gap_lbfgs:.2e} | learned {met['final_gap']:.2e}",
            flush=True,
        )
        print(f"#   learned per-round gaps: "
              + " ".join(f"{g:.3f}" for g in met["rel_gap_per_round"]),
              flush=True)
        lines.append(
            f"| qap-{qap_n} seed {seed} | {budget} iters | {gap_mma:.2e} | "
            f"{gap_lbfgs:.2e} | {met['final_gap']:.2e} |"
        )

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "LEARNED.md"), "a") as fh:
        fh.write("\n".join(lines) + "\n")
    print("# appended results to LEARNED.md", flush=True)


if __name__ == "__main__":
    main()
