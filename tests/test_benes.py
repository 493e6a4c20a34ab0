"""Benes-network routing: construction correctness + exchange parity.

The Benes exchange mode is off by default (measured slower than lax.sort
where it was measured) but must stay exactly correct.
"""
import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from bdd_tpu.bdd import BddPreprocessor
from bdd_tpu.solver import uniform as uf
from bdd_tpu.solver.benes import apply_network_jax, apply_network_np, route_benes
from bdd_tpu.utils.problems import grid_mrf


def test_route_benes_random():
    rng = np.random.default_rng(0)
    for N in [1, 2, 4, 32, 256, 1 << 12]:
        for _ in range(3):
            perm = rng.permutation(N)
            st = route_benes(perm)
            if N > 1:
                assert len(st) == 2 * int(np.log2(N)) - 1
            x = rng.standard_normal(N)
            np.testing.assert_array_equal(apply_network_np(st, x), x[perm])


def test_apply_network_jax_matches_np():
    rng = np.random.default_rng(1)
    N = 1 << 10
    perm = rng.permutation(N)
    st = route_benes(perm)
    dists = tuple(m for m, _ in st)
    masks = tuple(jnp.asarray(mk) for _, mk in st)
    x = rng.standard_normal(N).astype(np.float32)
    y = rng.standard_normal(N).astype(np.float32)
    ox, oy = apply_network_jax(dists, masks, (jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_array_equal(np.asarray(ox), x[perm])
    np.testing.assert_array_equal(np.asarray(oy), y[perm])


def test_benes_exchange_parity(monkeypatch):
    monkeypatch.setattr(uf, "_BENES_MODE", "1")
    ilp = grid_mrf(4, 4, 3, seed=0)
    pre = BddPreprocessor(ilp)
    host = uf.flatten_uniform(
        pre.collection,
        pre.total_nr_variables(),
        pre.nr_primal_variables,
        dtype=jnp.float32,
    )
    assert host.geom.exchange.benes_fwd is not None
    state = uf.init_uniform_state(host, pre.objective_vector())
    s3 = uf.iterations(host.geom, state, 3, 0.5)
    b = uf.exchange_delta(host.geom, s3.def_mm)

    monkeypatch.setattr(uf, "USE_PERM_EXCHANGE", False)
    a = uf.exchange_delta(host.geom, s3.def_mm)
    for ga, gb in zip(a, b):
        for g, x, y in zip(host.geom.buckets, ga, gb):
            m = np.asarray(g.layer_valid)
            np.testing.assert_allclose(
                np.asarray(x)[m], np.asarray(y)[m], rtol=1e-6, atol=1e-6
            )
