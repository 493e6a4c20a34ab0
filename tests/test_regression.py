"""Regression suite: the BASELINE.json config matrix on generated instances.

The reference's regression tests download real benchmark instances (zero
egress here), so each config runs on a generated instance of the matching
family and asserts the solver reaches the known LP bound / ILP optimum within
the reference's tolerances (test/bdd_solver_regression_test.cpp:36-58).
"""
import math

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
from jax.sharding import Mesh

from bdd_tpu.api import BddSolver
from bdd_tpu.bdd import BddPreprocessor
from bdd_tpu.solver.run import run_solver
from bdd_tpu.solver.uniform_sharded import ShardedUniformSolver
from bdd_tpu.utils.problems import (
    assignment,
    grid_mrf,
    independent_set,
    quadratic_assignment,
    set_cover,
)
from tests import fixtures


def brute(ilp):
    return fixtures.brute_force_ilp_optimum(ilp)[0]


def test_sequential_mma_double_set_cover():
    """config: sequential mma, double, set-cover instance."""
    ilp = set_cover(8, 10, density=0.3, seed=3)
    opt = brute(ilp)
    s = BddSolver(
        {
            "relaxation solver": "sequential mma",
            "precision": "double",
            "variable order": "bfs",
            "termination criteria": {"maximum iterations": 500},
        }
    )
    s.read_ilp(ilp=ilp)
    r = s.solve(verbose=False)
    assert r["lower_bound"] <= opt + 1e-6
    assert "objective" in r and r["objective"] <= opt * 0.99 + 1e-6 + abs(opt) * 0.02


def test_parallel_mma_float_binary_mrf():
    """config: parallel mma, float, small binary MRF."""
    ilp = grid_mrf(3, 3, 2, seed=11)
    s = BddSolver(
        {
            "relaxation solver": "uniform mma",
            "precision": "float",
            "variable order": "bfs",
            "termination criteria": {"maximum iterations": 400},
        }
    )
    s.read_ilp(ilp=ilp)
    r = s.solve(verbose=False)
    opt = fixtures.grid_mrf_optimum(s.ilp, 3, 3, 2)
    assert r["lower_bound"] <= opt + 1e-3
    if "objective" in r:
        assert r["objective"] >= opt - 1e-4


def test_tpu_mma_qap():
    """config: batched device mma on a (tiny) QAPLIB-style instance with
    quadratic terms."""
    ilp = quadratic_assignment(3, seed=2, density=0.6)
    opt = fixtures.qap_optimum(ilp, 3)
    s = BddSolver(
        {
            "relaxation solver": "uniform mma",
            "variable order": "bfs",
            "termination criteria": {"maximum iterations": 600},
        }
    )
    s.read_ilp(ilp=ilp)
    r = s.solve(verbose=False)
    assert r["lower_bound"] <= opt + 1e-4
    if "objective" in r:
        assert r["objective"] >= opt - 1e-6
        assert r["objective"] <= opt + abs(opt) * 0.25 + 1e-6


def test_lbfgs_with_rounding_tracking_style():
    """config: lbfgs + perturbation rounding (cell-tracking stand-in:
    assignment chain)."""
    ilp = assignment(4, seed=5)
    opt = brute(ilp)
    s = BddSolver(
        {
            "relaxation solver": "lbfgs parallel mma",
            "precision": "double",
            "termination criteria": {"maximum iterations": 150},
        }
    )
    s.read_ilp(ilp=ilp)
    r = s.solve(verbose=False)
    assert r["lower_bound"] == pytest.approx(opt, abs=1e-3)
    assert r.get("objective", math.inf) == pytest.approx(opt, abs=1e-6)


def test_sharded_mis_suite():
    """config: multi-device sharded mma on MIS (DOGE protocol family)."""
    ilp = independent_set(14, edge_prob=0.3, seed=9)
    opt = brute(ilp)
    pre = BddPreprocessor(ilp)
    mesh = Mesh(np.array(jax.devices()[:4]), ("b",))
    s = ShardedUniformSolver(
        pre.collection,
        pre.total_nr_variables(),
        pre.objective_vector(),
        mesh=mesh,
        nr_primal_vars=pre.nr_primal_variables,
        dtype=jnp.float64,
    )
    run_solver(s, max_iter=400, verbose=False, block_size=25)
    lb = s.lower_bound()
    assert lb <= opt + 1e-6
    # MIS LP (edge relaxation) can be loose; within 50% of optimum magnitude
    assert lb >= opt - abs(opt) * 0.5 - 1e-6
