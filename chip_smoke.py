"""Smoke test of the solver's main path on one NVIDIA GPU.

Usage:
    python chip_smoke.py          # phases 0-5 on one GPU
    python chip_smoke.py --four   # only the sharded phase, on four GPUs

Phases (one line each, then the card's name and power limit, then one JSON
line):
  0  device, compile cache, native host library build
  1  sweep kernels: per-bucket parity with the XLA scan on grid12, gm50k and
     grid32x12, the bound after 500 iterations, memory of one 500-iteration
     block
  2  a served request (``serve.handle_request``, f32, default rounding) on
     grid12 through the native path, checked against the native C++ solver
  3  gm50k and grid32x12, 1000 dual iterations through ``BddSolver``,
     checked against the native C++ solver
  4  ``"precision": "double"`` on grid12 against the numpy oracle
  5  the two delta exchanges on gm50k, timed in turns

Instances are generated from fixed seeds; weights do not exist here (the
ILPs' costs are the data). Any failed check exits non-zero and prints no
result line. Needs a GPU: on any other platform it stops before phase 0.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REL_F32_VS_F64 = 1e-4  # device f32 bound vs native f64 bound, same iterations
REL_F64 = 1e-9  # device f64 bound vs the numpy oracle
REL_KERNEL_LB = 1e-5  # kernel vs XLA scan bound after 500 iterations
REL_SHARDED = 1e-5  # four-GPU sharded bound vs one-GPU bound


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


# ------------------------------------------------------------------ instances
def grid12():
    from bdd_tpu.utils.problems import grid_mrf

    return grid_mrf(12, 12, 4, seed=0)


def gm50k():
    from bdd_tpu.frontends.graph_matching import construct_graph_matching_ilp
    from bdd_tpu.utils.problems import graph_matching

    inst = graph_matching(120, 120, seed=0, candidates=6, nr_quadratic=2000)
    return construct_graph_matching_ilp(inst)[0]


def grid32x12():
    from bdd_tpu.utils.problems import grid_mrf

    return grid_mrf(32, 32, 12, seed=0)


INSTANCES = {"grid12": grid12, "gm50k": gm50k, "grid32x12": grid32x12}


def native_host(ilp, order="bfs"):
    from bdd_tpu.native import NativeHost

    return NativeHost(ilp.write_lp(), order)


def peak_bytes() -> int:
    import jax

    return int(jax.devices()[0].memory_stats()["peak_bytes_in_use"])


def block(x):
    import jax

    return jax.block_until_ready(x)


# -------------------------------------------------------------- comparisons
def compare_rows(tag: str, ref, out, tol: float = 1e-5) -> float:
    """Identical ±inf (and NaN) pattern; finite entries within
    tol * (1 + |x|). Returns the largest scaled difference."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(ref, out)):
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        check(a.shape == b.shape, f"{tag}[{i}]: shape {b.shape} != {a.shape}")
        for name, f in (("+inf", np.isposinf), ("-inf", np.isneginf),
                        ("nan", np.isnan)):
            bad = int(np.count_nonzero(f(a) != f(b)))
            check(bad == 0, f"{tag}[{i}]: {name} pattern differs at {bad} entries")
        fin = np.isfinite(a)
        if fin.any():
            d = float(np.max(np.abs(a[fin] - b[fin]) / (1.0 + np.abs(a[fin]))))
            check(d <= tol, f"{tag}[{i}]: finite entries differ by {d:.3e} > {tol}")
            worst = max(worst, d)
    return worst


# ------------------------------------------------------------------ phases
def phase_kernel(name: str, nh, n: int = 500) -> None:
    """Each bucket's fused forward and backward half-sweep against the XLA
    scan, from the same inputs, then both paths over n iterations."""
    import jax
    import jax.numpy as jnp

    from bdd_tpu.solver import uniform as uf

    t0 = time.time()
    host = nh.make_uniform_host()
    geom = host.geom
    state0 = uf.init_uniform_state(host, nh.objective())

    state = uf.iterations(geom, state0, 20, 0.5, sweeps=uf.xla_sweep_fns)
    din_lo, din_hi = jax.jit(uf.exchange_delta)(geom, state.def_mm)
    worst, used = 0.0, 0
    for k, g in enumerate(geom.buckets):
        kfwd, kbwd = uf._sweep_fns(g, jnp.float32)
        if kfwd is uf.bucket_forward_iteration:
            log(f"#   {name} bucket {k} (H={g.H}, P={g.P}, B={g.B}): XLA scan")
            continue
        used += 1
        args = (state.lo[k], state.hi[k], state.cft[k], 0.5, din_lo[k], din_hi[k])
        ref_f = jax.jit(uf.bucket_forward_iteration)(g, *args)
        ker_f = jax.jit(kfwd)(g, *args)
        worst = max(worst, compare_rows(f"{name} b{k} forward", ref_f, ker_f))
        bargs = (ref_f[0], ref_f[1], ref_f[3], 0.5, din_lo[k], din_hi[k])
        ref_b = jax.jit(uf.bucket_backward_iteration)(g, *bargs)
        ker_b = jax.jit(kbwd)(g, *bargs)
        worst = max(worst, compare_rows(f"{name} b{k} backward", ref_b, ker_b))
    check(used > 0, f"{name}: no bucket takes the kernel")
    s_k = block(uf.iterations(geom, state0, n, 0.5))
    s_x = block(uf.iterations(geom, state0, n, 0.5, sweeps=uf.xla_sweep_fns))
    lb_k = float(uf.lower_bound_with_deferred(geom, s_k))
    lb_x = float(uf.lower_bound_with_deferred(geom, s_x))
    check(rel(lb_k, lb_x) <= REL_KERNEL_LB,
          f"{name}: bound after {n} its, kernel {lb_k!r} vs scan {lb_x!r}")
    ma = uf.iterations.lower(geom, state0, n, 0.5).compile().memory_analysis()
    mem = (f", {n}-it block memory: args {ma.argument_size_in_bytes} B, "
           f"out {ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} B")
    shapes = [(g.H, g.P, g.B) for g in geom.buckets]
    log(f"phase 1 kernel {name}: buckets {shapes}, {used} on the kernel, "
        f"max scaled diff {worst:.3e}, lb after {n} its kernel {lb_k!r} "
        f"scan {lb_x!r} (rel {rel(lb_k, lb_x):.2e}){mem}, {time.time() - t0:.1f} s")


class NativeSpy:
    """Records whether ``BddSolver._try_native`` handled each solve (it
    returns None, and the Python pipeline runs, when it declines)."""

    def __init__(self):
        from bdd_tpu import api

        self.api = api
        self.orig = api.BddSolver._try_native
        self.taken = []

    def __enter__(self):
        orig, taken = self.orig, self.taken

        def spy(solver, verbose):
            out = orig(solver, verbose)
            taken.append(out is not None)
            return out

        self.api.BddSolver._try_native = spy
        return self

    def __exit__(self, *exc):
        self.api.BddSolver._try_native = self.orig


def native_bound(nh, n: int) -> float:
    cs = nh.cpu_solver()
    cs.iterations(n, 0.5)
    return float(cs.lower_bound_with_deferred())


def phase_served(tmp: str) -> None:
    from bdd_tpu.serve import handle_request

    ilp = grid12()
    lp = ilp.write_lp()
    path = os.path.join(tmp, "grid12.lp")
    with open(path, "w") as fh:
        fh.write(lp)
    t0 = time.time()
    with NativeSpy() as spy:
        res = handle_request({"input": path, "relaxation solver": "uniform mma"})
    wall = time.time() - t0
    check(spy.taken == [True], f"served request left the native path: {res}")
    check(res.get("status") == "solved", f"served request: {res}")
    sol = res["solution"]
    x = [int(sol[ilp.get_var_name(i)]) for i in range(ilp.nr_variables())]
    check(ilp.feasible(x), "served solution is infeasible")
    lb, obj = float(res["lower_bound"]), float(res["objective"])
    check(abs(obj - float(ilp.evaluate(x))) <= 1e-6 * max(1.0, abs(obj)),
          "served objective does not match the solution")
    check(obj >= lb - 1e-6 * abs(lb), f"objective {obj} below lower bound {lb}")
    n = int(res["iterations"])
    from bdd_tpu.native import NativeHost

    lb_cpu = native_bound(NativeHost(lp, "input"), n)
    check(rel(lb, lb_cpu) <= REL_F32_VS_F64,
          f"grid12 served bound {lb!r} vs native C++ {lb_cpu!r} after {n} its")
    log(f"phase 2 served grid12: solved in {wall:.2f} s, {n} its, lb {lb!r} "
        f"(native C++ {lb_cpu!r}, rel {rel(lb, lb_cpu):.2e}), objective {obj!r}")


DUAL_ONLY = {
    "relaxation solver": "uniform mma",
    "variable order": "bfs",
    "perturbation rounding": False,
}


def termination(n: int) -> dict:
    return {"termination criteria": {"maximum iterations": n,
                                     "minimum improvement": 0.0,
                                     "improvement slope": 0.0}}


def phase_dual(name: str, n: int = 1000) -> None:
    from bdd_tpu.api import BddSolver

    ilp = INSTANCES[name]()
    t0 = time.time()
    s = BddSolver({**DUAL_ONLY, **termination(n)})
    s.read_ilp(ilp=ilp)
    with NativeSpy() as spy:
        res = s.solve(verbose=False)
    wall = time.time() - t0
    check(spy.taken == [True], f"{name} left the native path: {res}")
    check(res.get("status") == "solved", f"{name}: {res}")
    check(int(res["iterations"]) == n, f"{name}: ran {res['iterations']} its")
    lb = float(res["lower_bound"])
    peak = peak_bytes()
    t1 = time.time()
    lb_cpu = native_bound(s._native, n)
    t_cpu = time.time() - t1
    check(rel(lb, lb_cpu) <= REL_F32_VS_F64,
          f"{name} bound {lb!r} vs native C++ {lb_cpu!r} after {n} its")
    log(f"#   {name}: BddSolver wall {wall:.2f} s (dual {res['solve_time']} s), "
        f"native C++ {n} its {t_cpu:.2f} s, process device peak so far {peak} B")
    log(f"phase 3 dual {name}: {n} its, lb {lb!r} (native C++ {lb_cpu!r}, "
        f"rel {rel(lb, lb_cpu):.2e})")


def phase_double(tmp: str, n: int = 100) -> None:
    from bdd_tpu.native import NativeHost
    from bdd_tpu.serve import handle_request
    from bdd_tpu.solver.flatten import flatten_collection
    from bdd_tpu.solver.ref_solver import RefSolver

    lp = grid12().write_lp()
    path = os.path.join(tmp, "grid12.lp")
    with open(path, "w") as fh:
        fh.write(lp)
    with NativeSpy() as spy:
        res = handle_request({"input": path, "precision": "double",
                              "perturbation rounding": False, **termination(n)})
    check(spy.taken == [True], f"f64 request left the native path: {res}")
    check(res.get("status") == "solved" and int(res["iterations"]) == n,
          f"f64 request: {res}")
    nh = NativeHost(lp, "input")
    ref = RefSolver(flatten_collection(nh.collection(), nh.nr_vars()),
                    nh.objective(), dtype=np.float64)
    ref.iterations(n, 0.5)
    lb_ref = float(ref.lower_bound_with_deferred())
    lb = float(res["lower_bound"])
    check(rel(lb, lb_ref) <= REL_F64,
          f"f64 bound {lb!r} vs numpy oracle {lb_ref!r} after {n} its")
    log(f"phase 4 f64 grid12: {n} its, lb {lb!r} (numpy oracle {lb_ref!r}, "
        f"rel {rel(lb, lb_ref):.2e})")


def time_blocks(run, state, n_blocks: int = 2):
    t0 = time.time()
    out = state
    for _ in range(n_blocks):
        out = run(out)
    block(out)
    return (time.time() - t0) / n_blocks, out


def phase_exchange(n: int = 500) -> None:
    """Permutation (sort) exchange against the segment-sum exchange on
    gm50k, 500-iteration blocks in turns A, B, B, A."""
    from bdd_tpu.solver import uniform as uf

    nh = native_host(gm50k())
    host = nh.make_uniform_host()
    state0 = uf.init_uniform_state(host, nh.objective())
    geoms = {"perm": host.geom, "segment": host.geom._replace(exchange=None)}
    runs = {k: (lambda s, g=g: uf.iterations(g, s, n, 0.5)) for k, g in geoms.items()}
    states = {k: block(r(state0)) for k, r in runs.items()}  # compile + warm
    times = {k: [] for k in runs}
    for k in ("perm", "segment", "segment", "perm"):
        dt, states[k] = time_blocks(runs[k], states[k])
        times[k].append(dt / n)
    ms = {k: [round(t * 1e3, 4) for t in v] for k, v in times.items()}
    log(f"phase 5 exchange gm50k: ms/iteration perm {ms['perm']} "
        f"segment {ms['segment']} (A,B,B,A over {n}-it blocks)")


def phase_four(n: int = 500) -> None:
    """``"sharded mma"`` on gm50k over a 1-D mesh of four GPUs against
    ``uniform mma`` on one GPU, same BDDs, same iterations."""
    import jax
    import jax.numpy as jnp

    from bdd_tpu.api import BddSolver
    from bdd_tpu.solver.uniform_wrapper import UniformSolver

    check(len(jax.devices()) == 4, f"--four needs 4 GPUs, have {len(jax.devices())}")
    t0 = time.time()
    s = BddSolver({"relaxation solver": "sharded mma", "variable order": "bfs",
                   "perturbation rounding": False, **termination(n)})
    s.read_ilp(ilp=gm50k())
    res = s.solve(verbose=False)
    wall = time.time() - t0
    check(res.get("status") == "solved" and int(res["iterations"]) == n,
          f"sharded: {res}")
    devs = {sh.device for sh in s.solver.state_stacked.lo[0].addressable_shards}
    check(len(devs) == 4, f"sharded state sits on {len(devs)} devices")
    lb = float(res["lower_bound"])
    one = UniformSolver(s.pre.collection, s.pre.total_nr_variables(),
                        s.pre.objective_vector(),
                        nr_primal_vars=s.pre.nr_primal_variables,
                        dtype=jnp.float32)
    t1 = time.time()
    for _ in range(n // 25):
        one.iteration_block(25)
    lb_one = float(one.lower_bound_with_deferred())
    t_one = time.time() - t1
    check(rel(lb, lb_one) <= REL_SHARDED,
          f"sharded bound {lb!r} vs one GPU {lb_one!r} after {n} its")

    def ms_per_it(solver, state):
        t = time.time()
        for _ in range(n // 25):
            solver.iteration_block(25)
        block(state(solver))
        return (time.time() - t) / n * 1e3

    warm = {"sharded": ms_per_it(s.solver, lambda x: x.state_stacked),
            "one": ms_per_it(one, lambda x: x.state)}
    log(f"phase four gm50k: sharded over {sorted(d.id for d in devs)} in "
        f"{wall:.2f} s (dual {res['solve_time']} s), lb {lb!r}; one GPU "
        f"{t_one:.2f} s, lb {lb_one!r} (rel {rel(lb, lb_one):.2e}); warm "
        f"ms/iteration (blocks of 25 with a sync at the end) sharded "
        f"{warm['sharded']:.4f}, one GPU {warm['one']:.4f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded phase on four GPUs")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX runs on {dev.platform}",
              file=sys.stderr)
        return 2
    from bdd_tpu import native
    from bdd_tpu.utils.platform import enable_compile_cache

    cache = enable_compile_cache()
    t0 = time.time()
    prebuilt = os.path.exists(native._SO)
    native.load_library()  # builds native/build/libbddhost.so on first use
    lib = (f"native library {'found' if prebuilt else 'built from source'} "
           f"in {time.time() - t0:.1f} s")
    smi = nvidia_smi()
    log(f"phase 0 device: platform {dev.platform}, kind {dev.device_kind}, "
        f"count {len(jax.devices())}, nvidia-smi '{'; '.join(smi.splitlines())}', "
        f"compile cache "
        f"{cache}, {lib}")
    if args.four:
        phase_four()
    else:
        for name in INSTANCES:
            phase_kernel(name, native_host(INSTANCES[name]()))
        with tempfile.TemporaryDirectory() as tmp:
            phase_served(tmp)
            for name in ("gm50k", "grid32x12"):
                phase_dual(name)
            phase_double(tmp)
        phase_exchange()
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
