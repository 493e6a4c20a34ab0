"""Persistent serving mode: one warm process, many solves.

Each run of the JSON-api CLI pays process and device start-up and loads its
programs from the compile cache before the solve itself. This server keeps
the process (and the in-process jit cache) warm: requests are JSON solver configs — the same schema as
``python -m bdd_tpu.api`` (reference README.md:24-76) — read one per line
from stdin; one JSON result is written per line to stdout. Repeated solves of
same-shaped geometries skip compilation entirely.

Protocol (JSONL):
    {"input": "a.lp", ...}            -> one result object
    {"inputs": ["a.lp", "b.lp"], ...} -> list of results (batched serving)
    {"shutdown": true}                -> {"status": "bye"} and exit

No reference analogue (the reference is a one-shot CLI); this is the
framework's serving deployment. The platform JAX runs on is printed to
stderr at start.

Usage: python -m bdd_tpu.serve [< requests.jsonl]
"""
from __future__ import annotations

import json
import sys
import time


def handle_request(config) -> "dict | list":
    """Solve one request (a JSON solver config) in-process. Any failure —
    including a non-object request — returns an error result; the warm
    server must never die on a bad request."""
    t0 = time.time()
    try:
        if not isinstance(config, dict):
            raise TypeError(
                f"request must be a JSON object, got {type(config).__name__}")
        if config.get("shutdown"):
            return {"status": "bye"}
        import jax

        from bdd_tpu.api import BddSolver

        # 'precision: double' flips the global x64 flag; restore it after
        # the request so one double request doesn't invalidate the warm
        # float32 jit cache for every later request
        x64_before = bool(jax.config.jax_enable_x64)
        solver = BddSolver(config)
        try:
            if "inputs" in config:
                result = solver.solve_batch(
                    paths=config["inputs"],
                    verbose=bool(config.get("verbose", False)),
                )
            else:
                result = solver.solve(
                    verbose=bool(config.get("verbose", False)))
        finally:
            if bool(jax.config.jax_enable_x64) != x64_before:
                jax.config.update("jax_enable_x64", x64_before)
    except Exception as exc:  # a bad request must not kill the server
        return {"status": "error", "message": f"{type(exc).__name__}: {exc}"}
    wall = time.time() - t0
    if isinstance(result, dict):
        result["wall_s"] = round(wall, 3)
    return result


def _json_safe(x):
    """RFC-8259-safe payload: json.dumps would emit the non-standard
    ``Infinity``/``NaN`` tokens for non-finite floats (infeasible solves have
    lower_bound = inf), which strict parsers reject — encode them as
    strings."""
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    if isinstance(x, float) and (x != x or x in (float("inf"), float("-inf"))):
        return repr(x)
    return x


def serve(lines, out) -> int:
    """Run the request loop over an iterable of JSONL lines; returns the
    number of requests served."""
    n = 0
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            config = json.loads(line)
        except json.JSONDecodeError as exc:
            out.write(json.dumps(
                {"status": "error", "message": f"bad json: {exc}"}) + "\n")
            out.flush()
            continue
        result = handle_request(config)
        out.write(json.dumps(_json_safe(result), default=str) + "\n")
        out.flush()
        n += 1
        if isinstance(result, dict) and result.get("status") == "bye":
            break
    return n


def main() -> int:
    from bdd_tpu.utils.platform import device_platform

    device_platform()
    print("# bdd_tpu serve: one JSON config per line on stdin; "
          "results on stdout", file=sys.stderr, flush=True)
    serve(sys.stdin, sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
