"""Exchange byte-reduction probes.

Sorts are 81-90% of the iteration and run near HBM peak — the remaining
single-chip lever is bytes moved per sort pass. Variants measured here on
the real chip, in-context (full iteration) and in isolation:

  int16-keys  — sort keys are positions < N; for N < 32768 they fit int16
                (grid12 N=18048, qap18 N=23808 qualify). Exact.
  bf16-mm     — forward-sort payload (deferred mm) in bfloat16. NOT exact:
                admissibility gated by the f64-oracle parity suite; probed
                for the speed ceiling it would buy.
  bf16-packed — inverse-sort payloads (t_lo, t_hi) packed as two bf16
                halves of one int32 word: 2 payload arrays -> 1. Same gate.

Usage: python benchmarks/exchange_width_probe.py [grid12 qap18 gm50k]
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

from benchmarks.bisect_iteration import build
from bdd_tpu.solver import uniform as uf


def time_scan(fn, x0, n=400, reps=3):
    @functools.partial(jax.jit, static_argnames=("n",))
    def run(x, n):
        def body(x, _):
            return fn(x), ()

        x, _ = jax.lax.scan(body, x, None, length=n)
        return x

    out = run(x0, n)
    jax.tree.map(lambda a: np.asarray(a[:1]), out)
    ts = []
    for _ in range(reps):
        t0 = time.time()
        out = run(out, n)
        jax.tree.map(lambda a: np.asarray(a[:1]), out)
        ts.append((time.time() - t0) / n)
    return float(np.median(ts))


def main():
    for which in sys.argv[1:] or ["grid12", "qap18", "gm50k"]:
        host, obj = build(which)
        plan = host.geom.exchange
        if plan is None:
            print(f"## {which}: no plan", flush=True)
            continue
        N = int(plan.key_fwd.shape[0])
        k32f = plan.key_fwd
        k32i = plan.key_inv
        print(f"## {which}: N={N} int16-eligible={N < 32768}", flush=True)
        x = jnp.arange(N, dtype=jnp.float32) * 1e-3

        # --- baseline sorts
        t1 = time_scan(lambda v: jax.lax.sort((k32f, v), num_keys=1)[1], x)
        t2 = time_scan(
            lambda v: jax.lax.sort((k32i, v, v + 1.0), num_keys=1)[1], x
        )
        print(f"#  i32 keys: sort1 {t1*1e6:.1f} us  sort2 {t2*1e6:.1f} us",
              flush=True)

        # --- int16 keys
        if N < 32768:
            k16f = k32f.astype(jnp.int16)
            k16i = k32i.astype(jnp.int16)
            t1s = time_scan(
                lambda v: jax.lax.sort((k16f, v), num_keys=1)[1], x
            )
            t2s = time_scan(
                lambda v: jax.lax.sort((k16i, v, v + 1.0), num_keys=1)[1], x
            )
            # exactness: identical permutation
            a = np.asarray(jax.lax.sort((k32f, x), num_keys=1)[1])
            b = np.asarray(jax.lax.sort((k16f, x), num_keys=1)[1])
            ok = np.array_equal(a, b)
            print(
                f"#  i16 keys: sort1 {t1s*1e6:.1f} us ({t1/t1s:.2f}x)  "
                f"sort2 {t2s*1e6:.1f} us ({t2/t2s:.2f}x)  exact={ok}",
                flush=True,
            )

        # --- bf16 forward payload
        xb = x.astype(jnp.bfloat16)
        t1b = time_scan(lambda v: jax.lax.sort((k32f, v), num_keys=1)[1], xb)
        print(f"#  bf16 mm payload: sort1 {t1b*1e6:.1f} us ({t1/t1b:.2f}x)",
              flush=True)

        # --- packed inverse payload: two bf16 in one i32
        def pack(lo, hi):
            lo16 = jax.lax.bitcast_convert_type(
                lo.astype(jnp.bfloat16), jnp.uint16
            ).astype(jnp.uint32)
            hi16 = jax.lax.bitcast_convert_type(
                hi.astype(jnp.bfloat16), jnp.uint16
            ).astype(jnp.uint32)
            return (lo16 | (hi16 << 16)).astype(jnp.int32)

        def sort2_packed(v):
            p = pack(v, v + 1.0)
            _, out = jax.lax.sort((k32i, p), num_keys=1)
            u = out.astype(jnp.uint32)
            lo = jax.lax.bitcast_convert_type(
                (u & 0xFFFF).astype(jnp.uint16), jnp.bfloat16
            )
            hi = jax.lax.bitcast_convert_type(
                (u >> 16).astype(jnp.uint16), jnp.bfloat16
            )
            return lo.astype(jnp.float32) + 0.0 * hi.astype(jnp.float32)

        t2p = time_scan(sort2_packed, x)
        print(
            f"#  bf16-packed inv payload: sort2 {t2p*1e6:.1f} us "
            f"({t2/t2p:.2f}x, incl pack/unpack)",
            flush=True,
        )


if __name__ == "__main__":
    main()


def end_to_end(which="grid12"):
    """Composed check: full iteration with int16 vs int32 plan keys
    (CLAUDE.md: stub-bisect/measure the COMPOSED program — sorts behave
    differently in context than alone)."""
    import dataclasses

    host, obj = build(which)
    plan = host.geom.exchange
    N = int(plan.key_fwd.shape[0])
    if N >= 32768:
        print(f"## {which}: N={N} not int16-eligible", flush=True)
        return
    from benchmarks.scale_ceiling import time_block

    state = uf.init_uniform_state(host, obj)
    t32 = time_block(host.geom, state, 2000)[0]
    plan16 = dataclasses.replace(
        plan,
        key_fwd=plan.key_fwd.astype(jnp.int16),
        key_inv=plan.key_inv.astype(jnp.int16),
    )
    g16 = host.geom._replace(exchange=plan16)
    t16 = time_block(g16, state, 2000)[0]
    print(
        f"## {which} end-to-end: i32 {t32*1e3:.4f} ms/iter, "
        f"i16 {t16*1e3:.4f} ms/iter ({t32/t16:.3f}x)",
        flush=True,
    )
