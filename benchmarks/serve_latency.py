"""Warm-serving latency on one GPU: one process, repeated solves.

Measures (a) cold first solve, (b) warm same-geometry re-solve, (c) new
instance with the same geometry (jit-cache hit), for the 12x12x4 grid MRF
with rounding. Run nothing else on the card meanwhile.

Usage: python benchmarks/serve_latency.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bdd_tpu.utils.platform import device_platform

device_platform()

from bdd_tpu.serve import handle_request
from bdd_tpu.utils.problems import grid_mrf


def main() -> int:
    base = {
        "relaxation solver": "uniform mma",
        "variable order": "bfs",
        "termination criteria": {"maximum iterations": 1000},
    }
    os.makedirs("/tmp/bdd_serve_bench", exist_ok=True)
    p1 = "/tmp/bdd_serve_bench/a.lp"
    p2 = "/tmp/bdd_serve_bench/b.lp"
    open(p1, "w").write(grid_mrf(12, 12, 4, seed=0).write_lp())
    open(p2, "w").write(grid_mrf(12, 12, 4, seed=7).write_lp())
    rows = []
    for label, path in (("cold", p1), ("warm same instance", p1),
                        ("warm same geometry", p2)):
        t0 = time.time()
        r = handle_request({**base, "input": path})
        rows.append((label, time.time() - t0, r.get("lower_bound"),
                     r.get("objective")))
        print(f"# {label}: {rows[-1][1]:.2f}s lb={rows[-1][2]:.4f} "
              f"obj={rows[-1][3]}", flush=True)
    print(f"RESULT cold={rows[0][1]:.2f}s warm={rows[1][1]:.2f}s "
          f"same_geom={rows[2][1]:.2f}s speedup={rows[0][1]/rows[1][1]:.1f}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
