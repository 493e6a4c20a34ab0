"""Fused GPU sweep kernels (Pallas, Triton route) against the XLA scan path.

On the CPU the kernels run in interpret mode, asked for explicitly; the
``gpu`` tests compile them for the card and skip elsewhere.

(analogue of the reference's torch-vs-CUDA parity tests)
"""
import functools

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from bdd_tpu.bdd import BddPreprocessor
from bdd_tpu.ilp import parse_lp_string
from bdd_tpu.solver import pallas_uniform as pu
from bdd_tpu.solver import uniform as uf
from bdd_tpu.utils.problems import grid_mrf
from tests import fixtures

FORCING_LP = """Minimize
-1 x + y + z + w
Subject To
x + y >= 1
x + z >= 1
x + w >= 1
2 x + y + z >= 4
End"""  # the last constraint forces x = 1 (y+z <= 2); x sits in 4 BDDs


def interpret_sweeps():
    def sweeps(g, dtype):
        return (
            functools.partial(pu.bucket_forward_iteration_pallas, interpret=True),
            functools.partial(pu.bucket_backward_iteration_pallas, interpret=True),
        )

    return sweeps


def build(lp=None, ilp=None):
    if ilp is None:
        ilp = parse_lp_string(lp)
    pre = BddPreprocessor(ilp)
    host = uf.flatten_uniform(
        pre.collection,
        pre.total_nr_variables(),
        pre.nr_primal_variables,
        dtype=jnp.float32,
    )
    state = uf.init_uniform_state(host, pre.objective_vector(), dtype=jnp.float32)
    return host, state, pre, ilp


def assert_same(a, b, tol=1e-6):
    """Identical ±inf/NaN pattern, finite entries within tol*(1+|x|)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    for f in (np.isposinf, np.isneginf, np.isnan):
        np.testing.assert_array_equal(f(a), f(b))
    fin = np.isfinite(a)
    np.testing.assert_array_less(
        np.abs(a[fin] - b[fin]), tol * (1.0 + np.abs(a[fin])) + 1e-30
    )


@pytest.mark.parametrize(
    "lp", [fixtures.MATCHING_3x3, fixtures.TWO_SIMPLEX, fixtures.INFEASIBLE]
)
def test_pallas_iteration_parity(lp):
    host, state, _, _ = build(lp)
    sA = uf.iterations(host.geom, state, 6, 0.5, sweeps=uf.xla_sweep_fns)
    sB = uf.iterations(host.geom, state, 6, 0.5, sweeps=interpret_sweeps())
    for a, b in zip(jax.tree.leaves(sA), jax.tree.leaves(sB)):
        assert_same(a, b)


def test_pallas_grid_mrf_parity():
    ilp = grid_mrf(3, 3, 2, seed=7)
    ilp.normalize()
    host, state, _, _ = build(ilp=ilp)
    sA = uf.iterations(host.geom, state, 5, 0.5, sweeps=uf.xla_sweep_fns)
    sB = uf.iterations(host.geom, state, 5, 0.5, sweeps=interpret_sweeps())
    lbA = float(uf.lower_bound_with_deferred(host.geom, sA))
    lbB = float(uf.lower_bound_with_deferred(host.geom, sB))
    assert lbA == pytest.approx(lbB, rel=1e-6)


def test_pallas_forcing_with_three_bdds():
    """Variable forcing (±inf min-marginals) must survive the kernels' BIG
    arithmetic even when alpha <= 1/3 (regression: alpha*BIG fell below the
    BIG/2 finiteness threshold and forcing silently stopped propagating for
    variables in >= 3 BDDs)."""
    host, state, _, ilp = build(FORCING_LP)
    results = {}
    for name, sweeps in (("xla", uf.xla_sweep_fns), ("kernel", interpret_sweeps())):
        out = uf.iterations(host.geom, state, 30, 0.5, sweeps=sweeps)
        results[name] = float(uf.lower_bound_with_deferred(host.geom, out))
    assert results["kernel"] == pytest.approx(results["xla"], abs=1e-3)
    # and the bound reflects x forced to 1 (cost -1 realized)
    opt, _ = fixtures.brute_force_ilp_optimum(ilp)
    assert results["kernel"] <= opt + 1e-4


def half_sweep_inputs(host, state, n=3):
    state = uf.iterations(host.geom, state, n, 0.5, sweeps=uf.xla_sweep_fns)
    din_lo, din_hi = uf.exchange_delta(host.geom, state.def_mm)
    return state, din_lo, din_hi


@pytest.mark.parametrize(
    "make", [lambda: grid_mrf(4, 4, 3, seed=7), lambda: grid_mrf(5, 3, 2, seed=1),
             lambda: parse_lp_string(fixtures.SHORT_MRF_CHAIN)],
)
def test_half_sweep_parity_per_bucket(make):
    """Each bucket's forward and backward half-sweep, including the padding
    of the column count up to a multiple of the tile."""
    ilp = make()
    ilp.normalize()
    host, state, _, _ = build(ilp=ilp)
    assert any(g.B % pu._tile(g.B) for g in host.geom.buckets)
    state, din_lo, din_hi = half_sweep_inputs(host, state)
    kw = dict(interpret=True)
    for k, g in enumerate(host.geom.buckets):
        args = (state.lo[k], state.hi[k], state.cft[k], 0.5, din_lo[k], din_hi[k])
        ref = uf.bucket_forward_iteration(g, *args)
        out = pu.bucket_forward_iteration_pallas(g, *args, **kw)
        for a, b in zip(ref, out):
            assert_same(a, b)
        bargs = (ref[0], ref[1], ref[3], 0.5, din_lo[k], din_hi[k])
        ref_b = uf.bucket_backward_iteration(g, *bargs)
        out_b = pu.bucket_backward_iteration_pallas(g, *bargs, **kw)
        for a, b in zip(ref_b, out_b):
            assert_same(a, b)


def test_per_layer_omega_and_alpha():
    """[H, B] omega / alpha (the learned path's per-layer parameters) take
    the kernel's per-layer branch and match the scan."""
    host, state, _, _ = build(fixtures.MATCHING_3x3)
    state, din_lo, din_hi = half_sweep_inputs(host, state)
    g = host.geom.buckets[0]
    rng = np.random.default_rng(0)
    omega = jnp.asarray(rng.uniform(0.2, 0.9, (g.H, g.B)), jnp.float32)
    alpha = jnp.asarray(np.asarray(g.alpha) * 0.9, jnp.float32)
    args = (state.lo[0], state.hi[0], state.cft[0], omega, din_lo[0], din_hi[0], alpha)
    ref = uf.bucket_forward_iteration(g, *args)
    out = pu.bucket_forward_iteration_pallas(g, *args, interpret=True)
    for a, b in zip(ref, out):
        assert_same(a, b)


def test_inf_costs_roundtrip():
    """±inf input costs are mapped to BIG on load and back to ±inf on
    store: same pattern as the scan path."""
    host, state, _, _ = build(fixtures.TWO_SIMPLEX)
    state, din_lo, din_hi = half_sweep_inputs(host, state)
    g = host.geom.buckets[0]
    lo = state.lo[0].at[0, 0].set(jnp.inf)
    args = (lo, state.hi[0], state.cft[0], 0.5, din_lo[0], din_hi[0])
    ref = uf.bucket_forward_iteration(g, *args)
    out = pu.bucket_forward_iteration_pallas(g, *args, interpret=True)
    assert np.isinf(np.asarray(ref[3])).any()
    for a, b in zip(ref, out):
        assert_same(a, b)


@pytest.mark.parametrize("B", [8, 104, 1024, 13696, 1 << 20])
def test_tile_choice(B):
    bt = pu._tile(B)
    assert bt & (bt - 1) == 0 and 32 <= bt <= 256
    # at least two programs per SM unless the tile is already the smallest
    assert bt == 32 or B >= 2 * 132 * bt
    params = pu._compiler_params(bt)
    assert params.num_warps * 32 == bt  # one column per thread


def test_enabled_rule(monkeypatch):
    host, _, _, _ = build(fixtures.MATCHING_3x3)
    g = host.geom.buckets[0]
    assert not pu.enabled(g, jnp.float32)  # never on the CPU backend
    assert uf._sweep_fns(g, jnp.float32) == uf.xla_sweep_fns(g, jnp.float32)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert pu.enabled(g, jnp.float32)
    assert not pu.enabled(g, jnp.float64)  # f64 takes the scan
    wide = g._replace(node_valid=jnp.zeros((g.H, pu.MAX_P * 2, g.B), bool))
    assert not pu.enabled(wide, jnp.float32)
    assert uf._sweep_fns(g, jnp.float32)[0] is pu.bucket_forward_iteration_pallas


@pytest.mark.gpu
def test_kernels_compiled_on_gpu(gpu):
    """The kernels as compiled for the card match the scan path."""
    ilp = grid_mrf(8, 8, 3, seed=3)
    ilp.normalize()
    host, state, _, _ = build(ilp=ilp)
    sA = uf.iterations(host.geom, state, 50, 0.5, sweeps=uf.xla_sweep_fns)
    sB = uf.iterations(host.geom, state, 50, 0.5)
    lbA = float(uf.lower_bound_with_deferred(host.geom, sA))
    lbB = float(uf.lower_bound_with_deferred(host.geom, sB))
    assert lbB == pytest.approx(lbA, rel=1e-5)
