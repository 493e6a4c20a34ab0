"""Sequence-parallel BDD splitting and coalesce groups, end-to-end."""
import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from bdd_tpu.bdd import BddPreprocessor
from bdd_tpu.ilp import parse_lp_string
from bdd_tpu.solver import RefSolver, flatten_collection
from bdd_tpu.solver.uniform_wrapper import UniformSolver
from bdd_tpu.utils.problems import set_cover
from tests import fixtures


def solve_uniform(pre, iters=300):
    s = UniformSolver(
        pre.collection,
        pre.total_nr_variables(),
        pre.objective_vector(),
        nr_primal_vars=pre.nr_primal_variables,
        dtype=jnp.float64,
    )
    s.iteration_block(iters)
    return s.lower_bound_with_deferred()


def test_split_preserves_relaxation_bound():
    """Splitting long BDDs (sequence parallelism) changes the decomposition
    but the converged bound must stay within the unsplit bound's range
    (each chunk group is an exact reformulation of its BDD)."""
    ilp = set_cover(12, 14, density=0.3, seed=7)
    opt, _ = fixtures.brute_force_ilp_optimum(ilp)

    pre_full = BddPreprocessor(parse_lp_string(ilp.write_lp()))
    lb_full = solve_uniform(pre_full, 500)

    pre_split = BddPreprocessor(parse_lp_string(ilp.write_lp()), split_chunk_size=4)
    assert pre_split.nr_aux_variables > 0  # splitting actually happened
    lb_split = solve_uniform(pre_split, 800)

    assert lb_full <= opt + 1e-6
    assert lb_split <= opt + 1e-6
    # split relaxation is a valid reformulation: bound within 2% of unsplit
    assert lb_split >= lb_full - abs(lb_full) * 0.02 - 1e-6


def test_split_depth_capped():
    ilp = set_cover(12, 14, density=0.3, seed=7)
    pre = BddPreprocessor(ilp, split_chunk_size=4)
    for b in range(pre.collection.nr_bdds()):
        levels = pre.collection.node_levels(b)
        assert max(levels) + 1 <= 4 + 2  # chunk + entry/exit dispatch slack


def test_coalesce_end_to_end():
    """Coalesced constraints are melded into one BDD -> tighter relaxation."""
    lp_plain = """Minimize
-1 x - 1 y - 1 z
Subject To
c1: x + y <= 1
c2: y + z <= 1
c3: x + z <= 1
End"""
    lp_coalesced = lp_plain.replace("End", "Coalesce\nc1 c2 c3\nEnd")
    pre1 = BddPreprocessor(parse_lp_string(lp_plain))
    pre2 = BddPreprocessor(parse_lp_string(lp_coalesced))
    assert pre2.collection.nr_bdds() == 1  # melded
    lb1 = solve_uniform(pre1, 300)
    lb2 = solve_uniform(pre2, 300)
    # plain relaxation stuck at the fractional LP value -1.5; the meld is exact
    assert lb1 == pytest.approx(-1.5, abs=1e-4)
    assert lb2 == pytest.approx(-1.0, abs=1e-6)


def test_auto_split_chunk_size():
    """"auto" split length: no split when every BDD is shallower than the
    shallow packing tier (PACK_H_CAP); deep cardinality chains get split to a power-of-two
    chunk chosen by the cost model (serial scan steps vs coupling slots)."""
    from bdd_tpu.ilp.model import ILPInput, Ineq
    from bdd_tpu.solver.uniform import PACK_H_CAP

    # shallow instance -> auto is a no-op
    pre = BddPreprocessor(set_cover(12, 14, density=0.3, seed=7),
                          split_chunk_size="auto")
    assert pre.nr_aux_variables == 0

    # one cardinality constraint over 600 vars -> depth 600 > PACK_H_CAP
    ilp = ILPInput()
    n = 600
    for i in range(n):
        ilp.add_new_variable(f"x{i}")
    ilp.objective_ = [((i * 7919) % 13) - 6.0 for i in range(n)]
    ilp.add_linear_constraint([1] * n, list(range(n)), Ineq.GEQ, 2)
    pre = BddPreprocessor(parse_lp_string(ilp.write_lp()),
                          split_chunk_size="auto")
    assert pre.nr_aux_variables > 0  # split happened
    # every chunk fits the shallow tier (depth <= PACK_H_CAP incl. the
    # 2*w coupling-layer overhead the auto model accounts for)
    for b in range(pre.collection.nr_bdds()):
        levels = pre.collection.node_levels(b)
        assert max(levels) + 1 <= PACK_H_CAP

    # the split relaxation still reaches the LP bound of the plain problem
    # (a single >=2-of-n constraint: LP = ILP = two cheapest costs)
    lb = solve_uniform(pre, 400)
    opt = sum(sorted(x for x in ilp.objective_)[:2])
    opt = min(opt, sum(x for x in ilp.objective_ if x < 0))
    assert lb <= opt + 1e-6
    assert lb >= opt - abs(opt) * 0.05 - 1e-6
