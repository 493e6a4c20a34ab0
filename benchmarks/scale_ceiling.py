"""Single-GPU scale ceiling: how big an instance fits one card, and where
sharding becomes mandatory.

Builds instances >= 5M BDD nodes (grid48-class MRF; GM-300), accounts the
uniform layout's device-memory footprint from the geometry (state = 3x [H,B]
layer arrays + 1x [H,P,B] node array per bucket, f32, x2 for the
double-buffered scan carry + sort scratch) against the card's
``memory_stats()["bytes_limit"]``, runs a measured iteration block, and
reports it/s and the peak bytes in use. Past the ceiling the card runs out
of memory and the BDD-block sharding (uniform_sharded) is the way forward.

(ref analogue: the CUDA solver sizes its SoA to gpu memory,
src/bdd_conversion/bdd_preprocessor.cpp:32-121 does occupancy-driven
chunking on the host side.)

Usage: python benchmarks/scale_ceiling.py [families...]
  families from: grid32 grid40 grid48 gm300
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bdd_tpu.utils.platform import device_platform

device_platform()

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bdd_tpu.solver import uniform as uf


def build(which):
    t0 = time.time()
    if which.startswith("grid"):
        from bdd_tpu import native
        from bdd_tpu.utils.problems import grid_mrf

        n, labels = {"grid32": (32, 12), "grid40": (40, 16),
                     "grid48": (48, 20)}[which]
        ilp = grid_mrf(n, n, labels, seed=0)
        nh = native.NativeHost(ilp.write_lp(), "bfs")
        host = nh.make_uniform_host()
        obj = nh.objective()
        nodes = sum(
            int(np.asarray(g.node_valid).sum()) for g in host.geom.buckets
        )
        nbdds = nh.nr_bdds()
    elif which == "gm300":
        from bdd_tpu import native
        from bdd_tpu.frontends.graph_matching import (
            construct_graph_matching_ilp,
        )
        from bdd_tpu.utils.problems import graph_matching

        inst = graph_matching(300, 300, seed=0, candidates=6,
                              nr_quadratic=12000)
        gm_ilp = construct_graph_matching_ilp(inst)[0]
        nh = native.NativeHost(gm_ilp.write_lp(), "bfs")
        host = nh.make_uniform_host()
        obj = nh.objective()
        nodes = sum(
            int(np.asarray(g.node_valid).sum()) for g in host.geom.buckets
        )
        nbdds = nh.nr_bdds()
    else:
        raise SystemExit(which)
    return host, obj, nodes, nbdds, time.time() - t0


def nbytes(x) -> int:
    return int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize


def memory_estimate(geom):
    """Bytes of the resident f32 state + geometry arrays (each at its own
    dtype's width); x2 for the scan's double-buffered carry (XLA keeps
    input+output alive across the while loop) plus the exchange plan's keys
    and the sort scratch (key + payload per element, twice)."""
    layer = sum(int(np.prod(g.layer_var.shape)) for g in geom.buckets)
    node = sum(int(np.prod(g.node_valid.shape)) for g in geom.buckets)
    state = (3 * layer + node) * 4
    idx = sum(nbytes(f) for g in geom.buckets for f in g if hasattr(f, "shape"))
    plan = geom.exchange
    sortn = plan.key_fwd.shape[0] if plan is not None else 0
    keys = nbytes(plan.key_fwd) + nbytes(plan.key_inv) if plan is not None else 0
    return 2 * state + idx + keys + 2 * sortn * (4 + 4)


def time_block(geom, state, n, reps=3):
    @functools.partial(jax.jit, static_argnames=("n",))
    def run(s, n):
        def body(s, _):
            return uf.iteration(geom, s), ()

        s, _ = jax.lax.scan(body, s, None, length=n)
        return s

    out = jax.block_until_ready(run(state, n))
    ts = []
    for _ in range(reps):
        t0 = time.time()
        out = jax.block_until_ready(run(out, n))
        ts.append((time.time() - t0) / n)
    return float(np.median(ts)), out


def main():
    fams = sys.argv[1:] or ["grid32", "grid40", "grid48", "gm300"]
    dev = jax.devices()[0]
    limit = int(dev.memory_stats()["bytes_limit"])
    for which in fams:
        try:
            host, obj, nodes, nbdds, t_build = build(which)
        except Exception as e:
            print(f"## {which}: build failed: {e}", flush=True)
            continue
        geom = host.geom
        est = memory_estimate(geom)
        E = sum(g.H * g.B for g in geom.buckets)
        print(
            f"## {which}: {nbdds} bdds, {nodes} nodes, E={E}, "
            f"V={host.nr_vars}, build {t_build:.0f}s, "
            f"device memory est {est/2**30:.2f} GiB ({est/limit*100:.1f}% of "
            f"{limit/2**30:.1f} GiB, {dev.device_kind})",
            flush=True,
        )
        try:
            state = uf.init_uniform_state(host, obj)
            n = max(20, min(400, int(4e6 / max(nodes // 1000, 1))))
            T, out = time_block(geom, state, n)
            lb = float(uf.lower_bound_with_deferred(geom, out))
            print(
                f"#  {which}: {1/T:.1f} it/s ({T*1e3:.3f} ms/iter, "
                f"block {n}), lb after {4*n} iters = {lb:.4f}, peak "
                f"{dev.memory_stats()['peak_bytes_in_use']/2**30:.2f} GiB",
                flush=True,
            )
        except Exception as e:
            msg = str(e)
            oom = "RESOURCE_EXHAUSTED" in msg
            print(
                f"#  {which}: "
                f"{'out of memory - sharding required' if oom else 'run failed'}: "
                f"{msg[:300]}",
                flush=True,
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
