"""Fused GPU sweep kernels against the XLA scan, on one GPU.

Usage: python benchmarks/sweep_kernel_ab.py [grid12 gm50k grid32x12]

For each instance (built as in chip_smoke.py, native host, bfs order, f32):
  - whole iterations: ``uniform.iterations`` over 500-iteration blocks, the
    kernel path and the XLA path in turns A, B, B, A;
  - sweeps alone: 100 forward+backward half-sweep pairs of every bucket in
    one compiled loop, no exchange, for each path.
Times are host clock around work that ends in ``block_until_ready``, after a
warm-up call of the same program. Prints the card's name and power limit.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import chip_smoke
from bdd_tpu.solver import uniform as uf
from bdd_tpu.utils.platform import device_platform

BLOCK = 500
PAIRS = 100


VARIANTS = {"kernel": uf._sweep_fns, "xla": uf.xla_sweep_fns}
ORDER = ("kernel", "xla", "xla", "kernel")


def sweep_pairs(geom, state, sweeps, n):
    """n forward+backward half-sweep pairs per bucket, zero deltas."""

    @jax.jit
    def run(state):
        outs = []
        for g, lo, hi, cft in zip(geom.buckets, state.lo, state.hi, state.cft):
            fwd, bwd = sweeps(g, lo.dtype)
            z = jnp.zeros_like(lo)

            def body(_, c, g=g, fwd=fwd, bwd=bwd, z=z):
                lo, hi, cft = c
                nl, nh, _, cfr = fwd(g, lo, hi, cft, 0.5, z, z)
                nl, nh, _, cft = bwd(g, nl, nh, cfr, 0.5, z, z)
                return nl, nh, cft

            outs.append(jax.lax.fori_loop(0, n, body, (lo, hi, cft)))
        return outs

    return run


def main(names):
    device_platform(require="gpu")
    print(f"# {chip_smoke.nvidia_smi()}", flush=True)
    for name in names:
        t0 = time.time()
        nh = chip_smoke.native_host(chip_smoke.INSTANCES[name]())
        host = nh.make_uniform_host()
        geom = host.geom
        state0 = uf.init_uniform_state(host, nh.objective())
        shapes = [(g.H, g.P, g.B) for g in geom.buckets]
        print(f"## {name}: buckets {shapes}, build {time.time() - t0:.1f} s",
              flush=True)
        states, times, lbs = {}, {k: [] for k in VARIANTS}, {}
        for k, sw in VARIANTS.items():
            t0 = time.time()
            states[k] = jax.block_until_ready(
                uf.iterations(geom, state0, BLOCK, 0.5, sweeps=sw))
            print(f"#  {k}: compile+first block {time.time() - t0:.1f} s",
                  flush=True)
        for k in ORDER:
            t0 = time.time()
            states[k] = jax.block_until_ready(
                uf.iterations(geom, states[k], BLOCK, 0.5, sweeps=VARIANTS[k]))
            times[k].append((time.time() - t0) / BLOCK * 1e3)
        for k in VARIANTS:
            lbs[k] = float(uf.lower_bound_with_deferred(geom, states[k]))
        for k in VARIANTS:
            print(f"{name} iteration {k}: ms/it {[round(t, 5) for t in times[k]]}"
                  f", lb after {3 * BLOCK} its {lbs[k]!r}", flush=True)
        pair = {}
        for k in VARIANTS:
            run = sweep_pairs(geom, state0, VARIANTS[k], PAIRS)
            jax.block_until_ready(run(state0))
            ts = []
            for _ in range(3):
                t0 = time.time()
                jax.block_until_ready(run(state0))
                ts.append((time.time() - t0) / PAIRS * 1e6)
            pair[k] = [round(t, 2) for t in ts]
        print(f"{name} sweeps only (fwd+bwd pair, all buckets): us/pair "
              f"kernel {pair['kernel']} xla {pair['xla']}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:] or list(chip_smoke.INSTANCES)))
