"""DOGE at reference scale with wall-clock evaluation.

Round 2 ran the 20x20 batch-8 replay protocol on qap-8 and compared at equal
ITERATIONS, although an L-BFGS iteration does strictly more work. This run:

  * trains on batch 8 x QAP n>=16 (the it/s-table family/scale) or GM >= 80,
  * evaluates on 3 held-out instances at EQUAL WALL-CLOCK: the learned
    rollout's own warm wall time (GNN inference + feature extraction
    included) is measured first, then plain MMA and L-BFGS each get that
    many seconds of warm solver time,
  * reports gap-vs-wall-clock curves against a converged f64 bound.

Appends the table to LEARNED.md. Usage:
  python benchmarks/train_doge_scale.py [qap16|qap18|gm80] [epochs]
  python benchmarks/train_doge_scale.py qap16 --eval-only   # reuse ckpt

--eval-only loads benchmarks/doge_<family>.ckpt (same training protocol)
and re-runs only the wall-clock-equal evaluation — used to refresh the
LEARNED.md table after inference-path changes (e.g. the fused rollout)
without retraining.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bdd_tpu.utils.platform import device_platform

device_platform()

import jax
import numpy as np

from bdd_tpu import native
from bdd_tpu.bdd.preprocessor import BddPreprocessor
from bdd_tpu.learn.configs import config_qaplib
from bdd_tpu.learn.train import DogeTrainer, Instance, dual_metrics
from bdd_tpu.solver.lbfgs import LbfgsSolver
from bdd_tpu.solver.uniform_wrapper import UniformSolver
from bdd_tpu.utils.problems import quadratic_assignment


def make_ilp(family, seed):
    if family == "qap16":
        return quadratic_assignment(16, seed=seed, density=0.06)
    if family == "qap18":
        return quadratic_assignment(18, seed=seed, density=0.06)
    if family == "gm80":
        from bdd_tpu.frontends.graph_matching import (
            construct_graph_matching_ilp,
        )
        from bdd_tpu.utils.problems import graph_matching

        return construct_graph_matching_ilp(
            graph_matching(80, 80, seed=seed, candidates=5, nr_quadratic=900)
        )[0]
    if family == "gm120":
        # the it/s-table scale row (50k BDDs, 168k vars per instance): the
        # MMA-plateau regime DOGE exists for (ref
        # DOGE/configs/config_gm.py trains GM at dataset scale)
        from bdd_tpu.frontends.graph_matching import (
            construct_graph_matching_ilp,
        )
        from bdd_tpu.utils.problems import graph_matching

        return construct_graph_matching_ilp(
            graph_matching(120, 120, seed=seed, candidates=6,
                           nr_quadratic=2000)
        )[0]
    raise SystemExit(family)


# training batch size per family: gm120 instances are ~25x a qap16 — batch 4
# keeps the stacked rollout within HBM
TRAIN_BATCH = {"gm120": 4}


def fresh_uniform(pre):
    return UniformSolver(
        pre.collection,
        pre.total_nr_variables(),
        pre.objective_vector(),
        nr_primal_vars=pre.nr_primal_variables,
    )


def main():
    args = [a for a in sys.argv[1:] if a != "--eval-only"]
    eval_only = "--eval-only" in sys.argv[1:]
    family = args[0] if args else "qap16"
    epochs = int(args[1]) if len(args) > 1 else 30
    rounds, iters = 20, 20

    cfg = config_qaplib(
        nr_rounds=rounds, iters_per_round=iters, grad_rounds=1,
        use_replay=True, epochs=epochs, dim=32,
    )
    ck = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), f"doge_{family}.ckpt"
    )
    tr = DogeTrainer(cfg)
    if eval_only:
        # re-evaluate an existing checkpoint (trained with this same
        # protocol) after inference-path changes; load() needs an example
        # instance to build the param structure
        ex = Instance.from_ilp(make_ilp(family, 100))
        tr.load(ck, ex)
        print(f"# loaded {ck} (eval only)", flush=True)
    else:
        t0 = time.time()
        nb = TRAIN_BATCH.get(family, 8)
        train_inst = Instance.from_ilps(
            [make_ilp(family, s) for s in range(nb)]
        )
        print(
            f"# train batch: {nb} x {family} -> {train_inst.host.nr_bdds} bdds, "
            f"{train_inst.host.nr_vars} vars, E={train_inst.spec.E} "
            f"(build {time.time() - t0:.0f}s)",
            flush=True,
        )
        t0 = time.time()
        tr.init(train_inst)
        print(f"# init: {time.time() - t0:.0f}s", flush=True)
        t0 = time.time()
        for ep in range(epochs):
            m = tr.train_step(train_inst)
            if ep < 3 or (ep + 1) % 5 == 0:
                print(
                    f"# epoch {ep + 1}/{epochs}: loss {m['loss']:.4f} "
                    f"({time.time() - t0:.0f}s)",
                    flush=True,
                )
        tr.save(ck)
        print(f"# saved {ck} (train {time.time() - t0:.0f}s)", flush=True)

    # --------------------------------------------- wall-clock-equal evaluation
    lines = [
        "",
        f"## {family} protocol run, WALL-CLOCK-equal eval "
        f"(batch {TRAIN_BATCH.get(family, 8)}, "
        f"{rounds}x{iters}, replay, {epochs} epochs"
        f"{', FUSED rollout, ckpt re-eval' if eval_only else ''})",
        "",
        "| instance | learned wall | learned gap | MMA gap @ equal s "
        "(iters) | L-BFGS gap @ equal s (iters) | MMA @ 5x / 25x s "
        "| L-BFGS @ 5x / 25x s |",
        "|---|---|---|---|---|---|---|",
    ]
    wins = 0
    best_bounds = {}
    eval_ilps = {}
    for seed in (100, 101, 102):
        ilp = make_ilp(family, seed)
        ilp.normalize()
        pre = BddPreprocessor(ilp)
        inst = Instance.from_ilp(make_ilp(family, seed))

        # converged f64 reference bound (native C++ long run + L-BFGS polish)
        cs = native.cpu_solver_from_collection(
            pre.collection, pre.total_nr_variables(), pre.objective_vector()
        )
        cs.iterations(20000, 0.5)
        ls_ref = LbfgsSolver(fresh_uniform(pre))
        for _ in range(32):  # 800 outer iterations, block-scanned (no
            ls_ref.iteration_block(25)  # per-iteration host sync)
        best = max(
            cs.lower_bound_with_deferred(), ls_ref.lower_bound_with_deferred()
        )
        best_bounds[seed] = best
        eval_ilps[seed] = make_ilp(family, seed)

        # learned rollout: warm once with the SAME round count (the fused
        # rollout_scan is jitted with n static — a different nr_rounds would
        # compile a different program inside the clock); the final
        # np.asarray(lbs) conversion blocks on the whole fused program, so
        # the measured wall includes all device work
        tr.run_learned_rounds(inst, nr_rounds=rounds)
        t0 = time.time()
        lbs = tr.run_learned_rounds(inst, nr_rounds=rounds)
        t_learned = time.time() - t0
        met = dual_metrics(lbs, best)
        gap_learned = min(met["best_gap"], met["final_gap"])

        def gap_of(solver):
            return abs(best - solver.lower_bound_with_deferred()) / max(
                abs(best), 1e-9
            )

        def sync_state(st):
            jax.block_until_ready(st)

        def mma_at(budget_s):
            """Gap of plain MMA after `budget_s` seconds of warm solver time
            (each block synced — device calls are async, an unsynced loop
            measures dispatch only)."""
            m = fresh_uniform(pre)
            m.iteration_block(100)  # compile the SAME block size outside
            sync_state(m.state)
            m = fresh_uniform(pre)
            t = time.time()
            it = 0
            while time.time() - t < budget_s:
                m.iteration_block(100)
                sync_state(m.state)
                it += 100
            return gap_of(m), it

        def lbfgs_at(budget_s):
            w = LbfgsSolver(fresh_uniform(pre))
            w.iteration_block(10)  # compiles the block program off-clock
            sync_state(w.base.state)
            l = LbfgsSolver(fresh_uniform(pre))
            t = time.time()
            it = 0
            while time.time() - t < budget_s:
                l.iteration_block(10)
                sync_state(l.base.state)
                it += 10
            return gap_of(l), it

        # gap-vs-wall-clock: equal seconds, and 5x/25x for the curve
        gap_mma, it_mma = mma_at(t_learned)
        gap_lbfgs, it_l = lbfgs_at(t_learned)
        gap_mma5, _ = mma_at(5 * t_learned)
        gap_lbfgs5, _ = lbfgs_at(5 * t_learned)
        gap_mma25, _ = mma_at(25 * t_learned)
        gap_lbfgs25, _ = lbfgs_at(25 * t_learned)

        if gap_learned <= gap_lbfgs:
            wins += 1
        print(
            f"# {family} seed {seed}: best {best:.4f} | learned "
            f"{gap_learned:.2e} in {t_learned:.2f}s | mma {gap_mma:.2e} "
            f"({it_mma} it) / 5x {gap_mma5:.2e} / 25x {gap_mma25:.2e} | "
            f"lbfgs {gap_lbfgs:.2e} ({it_l} it) / 5x {gap_lbfgs5:.2e} / "
            f"25x {gap_lbfgs25:.2e}",
            flush=True,
        )
        lines.append(
            f"| {family} seed {seed} | {t_learned:.2f} s | {gap_learned:.2e} "
            f"| {gap_mma:.2e} ({it_mma}) | {gap_lbfgs:.2e} ({it_l}) "
            f"| {gap_mma5:.2e} / {gap_mma25:.2e} "
            f"| {gap_lbfgs5:.2e} / {gap_lbfgs25:.2e} |"
        )
    lines.append("")
    lines.append(
        f"Learned >= L-BFGS at equal wall-clock on {wins}/3 held-out."
    )

    # ------------------------------------------- batched serving eval
    # The production deployment of a learned policy is BATCHED serving (the
    # GNN/feature overhead amortizes over instances; DOGE itself trains and
    # evaluates batched, bdd_cuda_torch.py:102-133). All three held-out
    # instances as ONE device program per method, equal wall-clock.
    import jax

    from bdd_tpu.utils.batching import BatchedInstances

    binst = Instance.from_ilps([eval_ilps[s] for s in (100, 101, 102)])
    best_total = sum(best_bounds.values())
    tr.run_learned_rounds(binst, nr_rounds=rounds)  # warm same round count
    t0 = time.time()
    lbs = tr.run_learned_rounds(binst, nr_rounds=rounds)
    t_lb = time.time() - t0
    gap_learned_b = abs(best_total - max(lbs)) / max(abs(best_total), 1e-9)

    # normalize to match Instance.from_ilps preprocessing (BatchedInstances
    # does not normalize) so all methods solve the same relaxation
    _batch_ilps = [make_ilp(family, s) for s in (100, 101, 102)]
    for _b in _batch_ilps:
        _b.normalize()
    bi = BatchedInstances(_batch_ilps)

    def fresh_batched():
        return UniformSolver(bi.collection, bi.nr_vars, bi.objective)

    def mma_b(budget_s):
        m = fresh_batched()
        m.iteration_block(100)
        jax.block_until_ready(m.state.lo)
        m = fresh_batched()
        t = time.time()
        it = 0
        while time.time() - t < budget_s:
            m.iteration_block(100)
            jax.block_until_ready(m.state.lo)
            it += 100
        return abs(best_total - m.lower_bound_with_deferred()) / max(
            abs(best_total), 1e-9
        ), it

    def lbfgs_b(budget_s):
        w = LbfgsSolver(fresh_batched())
        for _ in range(3):
            w.iteration()
        jax.block_until_ready(w.base.state.lo)
        l = LbfgsSolver(fresh_batched())
        t = time.time()
        it = 0
        while time.time() - t < budget_s:
            l.iteration()
            jax.block_until_ready(l.base.state.lo)
            it += 1
        return abs(best_total - l.lower_bound_with_deferred()) / max(
            abs(best_total), 1e-9
        ), it

    g_mma, it_m = mma_b(t_lb)
    g_lb, it_lb2 = lbfgs_b(t_lb)
    g_mma5, _ = mma_b(5 * t_lb)
    g_lb5, _ = lbfgs_b(5 * t_lb)
    print(
        f"# {family} batch-3 held-out: learned {gap_learned_b:.2e} in "
        f"{t_lb:.2f}s | mma {g_mma:.2e} ({it_m} it) / 5x {g_mma5:.2e} | "
        f"lbfgs {g_lb:.2e} ({it_lb2} it) / 5x {g_lb5:.2e}",
        flush=True,
    )
    lines.append("")
    lines.append(
        f"Batched serving (all 3 held-out as one program, total-bound gap): "
        f"learned {gap_learned_b:.2e} in {t_lb:.2f} s; MMA {g_mma:.2e} "
        f"({it_m} it) / {g_mma5:.2e} @ 5x; L-BFGS {g_lb:.2e} ({it_lb2} it) "
        f"/ {g_lb5:.2e} @ 5x."
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "LEARNED.md"), "a") as fh:
        fh.write("\n".join(lines) + "\n")
    print(f"# appended results to LEARNED.md ({wins}/3 wins)", flush=True)


if __name__ == "__main__":
    main()
