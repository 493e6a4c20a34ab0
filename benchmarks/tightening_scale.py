"""Cut tightening at benchmark scale: gap closed vs meld budget.

The reference intends tightening for instances whose converged LP relaxation
has an integrality gap (include/bdd_tightening.h:168-274, experimental
there). Protocol: converge the dual (MMA + L-BFGS polish), round a primal
solution (upper bound), meld BDD groups around tight variables under a node
budget, re-solve, report the integrality gap closed:
(lb_after - lb_before) / (ub - lb_before).

Families: MIS (odd-cycle gaps — the canonical tightening target), QAP
(Fortet relaxation gaps), graph matching.

Usage: python benchmarks/tightening_scale.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bdd_tpu.utils.platform import device_platform

device_platform()

import numpy as np

from bdd_tpu.bdd.preprocessor import BddPreprocessor
from bdd_tpu.solver.lbfgs import LbfgsSolver
from bdd_tpu.solver.rounding_device import incremental_mm_rounding_device
from bdd_tpu.solver.run import run_solver
from bdd_tpu.solver.tighten import (
    conflict_cliques,
    conflict_cuts,
    tight_variables,
    tighten_collection,
)
from bdd_tpu.solver.uniform_wrapper import UniformSolver
from bdd_tpu.utils.problems import (
    graph_matching,
    independent_set,
    quadratic_assignment,
)


def solve(col, nr_vars, obj, nr_primal, mma_iters=1000, lbfgs_iters=200,
          layer_costs=None):
    """Converge the dual: MMA block then L-BFGS polish (plain MMA plateaus
    on GM/MIS far from the dual optimum — tight variables need converged
    multipliers). ``layer_costs``: warm start from transferred duals."""
    s = UniformSolver(col, nr_vars, obj, nr_primal_vars=nr_primal,
                      layer_costs=layer_costs)
    run_solver(s, max_iter=mma_iters, verbose=False,
               block_size=s.default_block_size)
    ls = LbfgsSolver(s)
    for _ in range(lbfgs_iters):
        ls.iteration()
    s.distribute_delta()
    return s


def upper_bound(s, ilp):
    """Rounded primal objective (+inf when rounding fails)."""
    try:
        sol = incremental_mm_rounding_device(s, verbose=False)
        if sol is None:
            return float("inf")
        x = np.asarray(sol)[: ilp.nr_variables()]
        return float(ilp.evaluate([int(v) for v in x]))
    except Exception as e:
        print(f"#   rounding failed: {e}", flush=True)
        return float("inf")


def run(name, ilp, budgets=(20000, 200000), cliques=False, cuts=None,
        **solve_kw):
    t0 = time.time()
    ilp_eval = ilp  # evaluate() needs the pre-normalize objective constant
    ilp.reorder_bfs()
    ilp.normalize()
    pre = BddPreprocessor(ilp)
    col = pre.collection
    nv, npv = pre.total_nr_variables(), pre.nr_primal_variables
    obj = pre.objective_vector()
    s = solve(col, nv, obj, npv, **solve_kw)
    lb0 = s.lower_bound_with_deferred()
    # min-marginals BEFORE rounding: incremental rounding perturbs the
    # solver's costs in place (forced state => huge |mm|, zero tight vars)
    m0, m1 = s.min_marginals()
    tv = tight_variables(s.f, m0, m1, eps=1e-4)
    # export the converged duals BEFORE rounding: the incremental rounding
    # perturbs the solver costs in place, and a post-rounding export would
    # transfer the PERTURBED objective onto the melded collection (measured:
    # mis-100 warm "lower bound" +28.5 with optimum ~ -11 — not a bound of
    # the real objective at all)
    costs = s.export_layer_costs()
    ub = upper_bound(s, ilp_eval)
    print(
        f"[{name}] bdds={col.nr_bdds()} lb={lb0:.4f} ub={ub:.4f} "
        f"(base solve {time.time()-t0:.0f}s)",
        flush=True,
    )
    if not np.isfinite(ub) or ub <= lb0 + 1e-9 * max(1.0, abs(lb0)):
        print(f"[{name}] LP-tight (no integrality gap) — nothing to close",
              flush=True)
        return
    print(f"[{name}] tight vars: {len(tv)} / {nv}", flush=True)
    explicit = None
    if cuts is not None:
        # conflict-graph separation (A/B): 'cliques' = clique
        # facets only; 'cliques+odd' = cliques, then odd-cycle inequalities
        # over the edges no clique consumed (tighten.conflict_cuts — the
        # stacked pipeline default)
        explicit = conflict_cuts(
            col, tv, cliques=True, odd_cycles=(cuts == "cliques+odd")
        ) or None
        print(f"[{name}] {cuts} groups: "
              f"{0 if explicit is None else len(explicit)}", flush=True)
    elif cliques:
        # clique-cut mode: meld each conflict-graph clique's edge BDDs into
        # the facet sum <= 1 (tighten.conflict_cliques) instead of the
        # generic tight-variable clusters
        explicit = conflict_cliques(col, tv)[0] or None
        print(f"[{name}] clique groups: "
              f"{0 if explicit is None else len(explicit)}", flush=True)
    for budget in budgets:
        t0 = time.time()
        new_col, new_costs, groups = tighten_collection(
            col, tv, layer_costs=costs, node_limit=budget,
            explicit_groups=explicit,
        )
        melded = sum(1 for g in groups.values() if len(g) > 1)
        t_meld = time.time() - t0
        if melded == 0:
            print(f"[{name}] budget {budget}: no groups melded", flush=True)
            continue
        # WARM re-solve (cost transfer — starts from the converged bound)
        t0 = time.time()
        s2 = solve(new_col, nv, obj, npv, layer_costs=new_costs, **solve_kw)
        lb1 = s2.lower_bound_with_deferred()
        closed = (lb1 - lb0) / (ub - lb0)
        t_warm = time.time() - t0
        # COLD re-solve (the r2 protocol, for comparison)
        t0 = time.time()
        s3 = solve(new_col, nv, obj, npv, **solve_kw)
        lb1c = s3.lower_bound_with_deferred()
        closed_c = (lb1c - lb0) / (ub - lb0)
        print(
            f"[{name}] budget {budget}: {melded} groups melded, "
            f"bdds {col.nr_bdds()} -> {new_col.nr_bdds()}, "
            f"lb {lb0:.4f} -> warm {lb1:.4f} ({100*closed:+.1f}%) "
            f"/ cold {lb1c:.4f} ({100*closed_c:+.1f}%), meld {t_meld:.1f}s "
            f"warm {t_warm:.0f}s cold {time.time()-t0:.0f}s",
            flush=True,
        )


def main():
    from bdd_tpu.frontends.graph_matching import construct_graph_matching_ilp

    only = set(sys.argv[1:])

    def want(name):
        return not only or any(o in name for o in only)

    rows = [
        ("mis-100", lambda: independent_set(100, edge_prob=0.25, seed=0),
         dict()),
        ("mis-100 cliques", lambda: independent_set(100, edge_prob=0.25,
         seed=0), dict(budgets=(200000,), cuts="cliques")),
        ("mis-100 cliques+odd", lambda: independent_set(100, edge_prob=0.25,
         seed=0), dict(budgets=(200000,), cuts="cliques+odd")),
        ("mis-200", lambda: independent_set(200, edge_prob=0.15, seed=0),
         dict()),
        ("mis-200 cliques", lambda: independent_set(200, edge_prob=0.15,
         seed=0), dict(budgets=(200000,), cuts="cliques")),
        ("mis-200 cliques+odd", lambda: independent_set(200, edge_prob=0.15,
         seed=0), dict(budgets=(200000,), cuts="cliques+odd")),
        # sparse conflict graph: few triangles, many odd holes — the regime
        # odd-cycle separation exists for (unit-test class, at scale)
        ("mis-150-sparse cliques", lambda: independent_set(150,
         edge_prob=0.04, seed=0), dict(budgets=(200000,), cuts="cliques")),
        ("mis-150-sparse cliques+odd", lambda: independent_set(150,
         edge_prob=0.04, seed=0),
         dict(budgets=(200000,), cuts="cliques+odd")),
        ("qap-12", lambda: quadratic_assignment(12, seed=0, density=0.3),
         dict()),
        ("graph-matching-40", lambda: construct_graph_matching_ilp(
            graph_matching(40, 40, seed=0, candidates=5, nr_quadratic=400)
        )[0], dict()),
    ]
    for name, mk, kw in rows:
        if want(name):
            run(name, mk(), **kw)


if __name__ == "__main__":
    main()
