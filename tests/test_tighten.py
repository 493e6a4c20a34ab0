"""Cut tightening + batching + coefficient decomposition tests."""
import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from bdd_tpu.bdd import BddPreprocessor, TOP, BOT
from bdd_tpu.ilp import parse_lp_string
from bdd_tpu.ilp.model import ILPInput, Ineq
from bdd_tpu.solver.run import run_solver
from bdd_tpu.solver.tighten import tighten_and_resolve, tighten_collection, tight_variables
from bdd_tpu.solver.uniform_wrapper import UniformSolver
from bdd_tpu.utils.batching import BatchedInstances
from tests import fixtures

# odd antiferromagnetic triangle: LP bound -1.5, ILP optimum -1
TRIANGLE = """Minimize
-1 x - 1 y - 1 z
Subject To
x + y <= 1
y + z <= 1
x + z <= 1
End"""


def test_tighten_closes_triangle_gap():
    ilp = parse_lp_string(TRIANGLE)
    pre = BddPreprocessor(ilp)
    tightened, groups = tighten_and_resolve(pre, {"dtype": jnp.float64})
    # all three BDDs share tight variables -> melded into one exact subproblem
    assert any(len(g) == 3 for g in groups.values())
    run_solver(tightened, max_iter=300, verbose=False, block_size=25)
    opt, _ = fixtures.brute_force_ilp_optimum(ilp)
    assert tightened.lower_bound_with_deferred() == pytest.approx(opt, abs=1e-6)
    # untightened bound is stuck at the LP value -1.5
    base = UniformSolver(
        pre.collection, pre.total_nr_variables(), pre.objective_vector(),
        nr_primal_vars=pre.nr_primal_variables, dtype=jnp.float64,
    )
    run_solver(base, max_iter=300, verbose=False, block_size=25)
    assert base.lower_bound_with_deferred() == pytest.approx(-1.5, abs=1e-4)


def test_tighten_collection_preserves_costs_bound():
    ilp = parse_lp_string(TRIANGLE)
    pre = BddPreprocessor(ilp)
    col = pre.collection
    costs = {}
    for b in range(col.nr_bdds()):
        for v in col.level_variables(b):
            costs[(b, v)] = (0.0, pre.objective_vector()[v] / 2.0)
    new_col, new_costs, groups = tighten_collection(
        col, tight_vars=[0, 1, 2], layer_costs=costs
    )
    # melded bdd exists and carries summed costs
    melded = [nr for nr, g in groups.items() if len(g) == 3]
    assert melded
    nr = melded[0]
    for v in new_col.level_variables(nr):
        # each variable appeared in exactly 2 of the 3 pairwise constraints
        assert new_costs[(nr, v)][1] == pytest.approx(
            2 * pre.objective_vector()[v] / 2.0
        )


def test_batched_instances_solve_independently():
    from bdd_tpu.solver.run import run_solver

    ilps = [parse_lp_string(fixtures.MATCHING_3x3), parse_lp_string(fixtures.COVERING)]
    batch = BatchedInstances(ilps)
    s = UniformSolver(
        batch.collection, batch.nr_vars, batch.objective, dtype=jnp.float64
    )
    run_solver(s, max_iter=300, verbose=False, block_size=25)
    lb = s.lower_bound_with_deferred()
    expected = sum(fixtures.brute_force_ilp_optimum(i)[0] for i in ilps)
    assert lb == pytest.approx(expected, abs=1e-4)


def test_coefficient_decomposition_preserves_semantics():
    ilp = ILPInput()
    vs = [ilp.add_new_variable(f"x{i}") for i in range(4)]
    for v in vs:
        ilp.add_to_objective(-1.0, v)
    # 7 x0 + 5 x1 + 3 x2 + 2 x3 <= 9
    ilp.add_linear_constraint([7, 5, 3, 2], vs, Ineq.LEQ, 9)
    opt, _ = fixtures.brute_force_ilp_optimum(ilp)
    pre = BddPreprocessor(ilp, coefficient_decomposition_threshold=2)
    s = UniformSolver(
        pre.collection,
        pre.total_nr_variables(),
        pre.objective_vector(),
        nr_primal_vars=pre.nr_primal_variables,
        dtype=jnp.float64,
    )
    run_solver(s, max_iter=500, verbose=False, block_size=25)
    # decomposition is a relaxation-preserving reformulation: dual bound <= opt
    assert s.lower_bound_with_deferred() <= opt + 1e-6
    # exact feasibility of the reformulated ILP
    pre_ilp = pre.ilp
    opt2, _ = fixtures.brute_force_ilp_optimum(pre_ilp)
    assert opt2 == pytest.approx(opt)


def test_meld_preserves_total_costs_on_eliminated_variables():
    """Melding can eliminate a variable from the product's support (don't-care
    in the conjunction); its Lagrange costs must stay in the decomposition on
    a free carrier BDD (regression: 12.0 of cost silently vanished)."""
    from bdd_tpu.bdd.collection import BddCollection
    from bdd_tpu.solver.tighten import tighten_collection

    col = BddCollection()
    # B0 = (x0 or x1), B1 = (x0 = 1); conjunction = (x0 = 1), x1 eliminated
    b0 = col.add_bdd([(0, 1, TOP), (1, BOT, TOP)])
    b1 = col.add_bdd([(0, BOT, TOP)])
    costs = {(b0, 0): (0.0, 5.0), (b0, 1): (0.0, 7.0), (b1, 0): (0.0, 3.0)}
    out, out_costs, groups = tighten_collection(
        col, tight_vars=[0], layer_costs=costs
    )
    total_in = sum(lo + hi for lo, hi in costs.values())
    total_out = sum(lo + hi for lo, hi in out_costs.values())
    assert total_out == pytest.approx(total_in)
    # x1's cost rides a free don't-care BDD
    carriers = [k for k in out_costs if k[1] == 1]
    assert carriers and out_costs[carriers[0]][1] == pytest.approx(7.0)


def test_tight_variables_excludes_forced():
    """Forced variables (one-sided infinite marginals) are NOT tight."""
    import numpy as np

    from bdd_tpu.solver.tighten import tight_variables

    class _V:
        nr_vars = 2
        layer_var = np.array([0, 1])

        def valid_layer_mask(self):
            return np.array([True, True])

    m0 = np.array([np.inf, 1.0])   # var 0 forced to 1; var 1 tight
    m1 = np.array([0.0, 1.0])
    tv = tight_variables(_V(), m0, m1)
    assert list(tv) == [1]


def test_tighten_warm_start_preserves_converged_bound():
    """The warm-start path (reference cost transfer, bdd_tightening.h): the
    tightened solver's INITIAL bound already equals the pre-meld converged
    bound (melding with summed member costs never lowers it), and further
    iterations only ascend — the fix for the r2 'tightening net-negative on
    QAP at equal budget' finding (the cold restart re-derived the bound)."""
    from bdd_tpu.bdd import BddPreprocessor
    from bdd_tpu.solver.run import run_solver
    from bdd_tpu.solver.tighten import tighten_and_resolve
    from bdd_tpu.solver.uniform_wrapper import UniformSolver
    from bdd_tpu.utils.problems import independent_set

    ilp = independent_set(40, edge_prob=0.25, seed=1)
    ilp.reorder_bfs()
    ilp.normalize()
    pre = BddPreprocessor(ilp)

    base = UniformSolver(
        pre.collection, pre.total_nr_variables(), pre.objective_vector(),
        nr_primal_vars=pre.nr_primal_variables,
    )
    run_solver(base, max_iter=500, verbose=False,
               block_size=base.default_block_size)
    lb0 = base.lower_bound_with_deferred()

    warm, groups = tighten_and_resolve(pre, warm_start=True)
    assert any(len(g) > 1 for g in groups.values())  # something melded
    lb_init = warm.lower_bound_with_deferred()
    assert lb_init >= lb0 - 5e-3  # transfer preserves the converged bound
    warm.iteration_block(200)
    lb_warm = warm.lower_bound_with_deferred()
    assert lb_warm >= lb_init - 5e-3

    # the cold restart at the same post-meld budget sits at or below warm
    cold, _ = tighten_and_resolve(pre, warm_start=False)
    assert cold.lower_bound_with_deferred() <= lb_init + 5e-3
    cold.iteration_block(200)
    assert lb_warm >= cold.lower_bound_with_deferred() - 5e-3


def _mis_ilp(n, p, seed):
    from bdd_tpu.utils.problems import independent_set

    ilp = independent_set(n, edge_prob=p, seed=seed)
    ilp.reorder_bfs()
    ilp.normalize()
    return ilp


def test_conflict_cliques_structure():
    """Clique groups are edge-disjoint C(k,2)-sized bags of at-most-1 BDDs."""
    from bdd_tpu.solver.tighten import conflict_cliques

    ilp = _mis_ilp(30, 0.3, seed=2)
    pre = BddPreprocessor(ilp)
    groups, _ = conflict_cliques(pre.collection)
    assert groups, "a 0.3-density conflict graph has triangles"
    seen = set()
    for g in groups:
        # C(k,2) edges for some k >= 3
        m = len(g)
        k = int((1 + (1 + 8 * m) ** 0.5) / 2)
        assert k * (k - 1) // 2 == m and k >= 3
        for b in g:
            assert b not in seen, "edge BDD melded twice"
            seen.add(b)
            assert len(pre.collection.variables(b)) == 2


def test_clique_tighten_cuts_triangle_instantly():
    """Triangle MIS: LP bound -1.5; the melded clique facet gives -1 at the
    transferred duals BEFORE any re-solve iteration."""
    ilp = ILPInput()
    for v in range(3):
        ilp.add_to_objective(-1.0, f"x_{v}")
    for a in range(3):
        for b in range(a + 1, 3):
            ilp.add_linear_constraint([1, 1], [a, b], Ineq.LEQ, 1)
    ilp.normalize()
    pre = BddPreprocessor(ilp)
    ts, groups = tighten_and_resolve(
        pre, dict(dtype=jnp.float64), cliques=True
    )
    assert ts.lower_bound_with_deferred() == pytest.approx(-1.0, abs=1e-6)


def test_clique_tighten_beats_generic_on_mis():
    """Random MIS: the clique melds close far more of the integrality gap
    than the generic tight-variable clusters at the same budget (the
    measured motivation for conflict_cliques)."""
    ilp = _mis_ilp(40, 0.25, seed=1)
    finals = {}
    for mode in (False, True):
        pre = BddPreprocessor(ilp)
        ts, _ = tighten_and_resolve(pre, dict(dtype=jnp.float64), cliques=mode)
        run_solver(ts, max_iter=200, verbose=False, block_size=25)
        finals[mode] = ts.lower_bound_with_deferred()
    assert finals[True] >= finals[False] + 0.3
    # validity: any feasible point (greedy independent set by weight)
    # upper-bounds the optimum, which upper-bounds every dual bound
    order = np.argsort(ilp.objective())
    taken, x = set(), [0] * ilp.nr_variables()
    conflicts = {
        frozenset(m[0] for m in c.monomials) for c in ilp.constraints()
    }
    for v in order:
        v = int(v)
        if all(
            frozenset((v, u)) not in conflicts for u in taken
        ):
            taken.add(v)
            x[v] = 1
    assert ilp.feasible(x)
    assert finals[True] <= ilp.evaluate(x) + 1e-6


def test_api_tighten_phase_mis():
    """config 'tighten' runs the clique-cut phase inside the pipeline and
    improves the MIS bound (the reference never dispatches its tightening)."""
    from bdd_tpu.api import BddSolver
    from bdd_tpu.utils.problems import independent_set

    lp = independent_set(30, edge_prob=0.3, seed=2).write_lp()
    lbs = {}
    for tighten in (False, True):
        s = BddSolver(
            {
                "relaxation solver": "uniform mma",
                "precision": "double",
                "variable order": "bfs",
                "termination criteria": {"maximum iterations": 500},
                "tighten": {"cliques": True} if tighten else False,
                "perturbation rounding": False,
            }
        )
        s.read_ilp(lp_string=lp)
        r = s.solve(verbose=False)
        assert r["status"] == "solved"
        lbs[tighten] = r["lower_bound"]
    assert lbs[True] >= lbs[False] + 0.2


def test_odd_cycle_cut_pentagon_exact():
    """C5 MIS: LP bound -2.5; the 5-cycle meld carries the odd-cycle facet
    sum <= 2 and the tightened relaxation is exact (-2)."""
    from bdd_tpu.solver.tighten import conflict_cuts, conflict_odd_cycles

    ilp = ILPInput()
    for v in range(5):
        ilp.add_to_objective(-1.0, f"x_{v}")
    for a in range(5):
        ilp.add_linear_constraint(
            [1, 1], sorted([a, (a + 1) % 5]), Ineq.LEQ, 1
        )
    ilp.normalize()
    pre = BddPreprocessor(ilp)
    cyc, _ = conflict_odd_cycles(pre.collection)
    assert len(cyc) == 1 and len(cyc[0]) == 5
    assert conflict_cuts(pre.collection)  # combined separation finds it too
    ts, _ = tighten_and_resolve(pre, dict(dtype=jnp.float64), cliques=True)
    run_solver(ts, max_iter=200, verbose=False, block_size=20)
    assert ts.lower_bound_with_deferred() == pytest.approx(-2.0, abs=1e-6)


def test_odd_cycles_stack_on_cliques_sparse_mis():
    """Sparse conflict graphs (few triangles): odd cycles add edge-disjoint
    groups beyond the cliques and improve the tightened bound (measured
    -38.57 -> -38.39 on mis-150 p=.04)."""
    from bdd_tpu.solver.tighten import conflict_cuts

    ilp = _mis_ilp(150, 0.04, seed=0)
    pre = BddPreprocessor(ilp)
    only_cl = conflict_cuts(pre.collection, odd_cycles=False)
    both = conflict_cuts(pre.collection)
    assert len(both) > len(only_cl)
    for g in both[len(only_cl):]:
        assert len(g) % 2 == 1 and len(g) >= 5  # odd cycles, length >= 5
