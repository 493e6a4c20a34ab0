"""Multi-host (2-process) sharded solving with kill + restart-from-checkpoint.

SURVEY §5: the reference has no distributed backend; the framework must
supply its own multi-host checkpoint/restart story. This dryrun launches a
REAL 2-process x 4-virtual-CPU-device jax.distributed run (Gloo collectives):

  phase 1: both processes solve 8 iterations on the global 8-device mesh,
           checkpoint, and exit (the "kill");
  phase 2: FRESH processes rebuild the solver, restore the checkpoint, and
           continue 8 more iterations.

The resumed bound must equal an uninterrupted single-process 8-device run of
the same 16 iterations (f64: the sharded segment exchange is deterministic).
"""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bdd_tpu.bdd import BddPreprocessor
from bdd_tpu.solver.uniform_sharded import ShardedUniformSolver
from bdd_tpu.utils.problems import grid_mrf

WORKER = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    pid = int(sys.argv[1]); port = sys.argv[2]; phase = sys.argv[3]
    ckpt = sys.argv[4]
    import jax
    from bdd_tpu.utils import multihost as mh
    mh.initialize(f"localhost:{port}", num_processes=2, process_id=pid,
                  platform="cpu")
    assert len(jax.devices()) == 8, jax.devices()
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from bdd_tpu.bdd import BddPreprocessor
    from bdd_tpu.solver.uniform_sharded import ShardedUniformSolver
    from bdd_tpu.utils.problems import grid_mrf

    ilp = grid_mrf(4, 4, 3, seed=0)
    ilp.reorder_bfs()
    ilp.normalize()
    pre = BddPreprocessor(ilp)
    s = ShardedUniformSolver(
        pre.collection, pre.total_nr_variables(), pre.objective_vector(),
        mesh=mh.global_mesh(), nr_primal_vars=pre.nr_primal_variables,
        dtype=jnp.float64,
    )
    if phase == "resume":
        mh.load_sharded(s, ckpt)
    s.iteration_block(8)
    lb = s.lower_bound_with_deferred()
    if phase == "start":
        mh.save_sharded(s, ckpt)
    print(f"RESULT {pid} {phase} {lb!r}", flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_phase(tmp_path, port, phase, ckpt):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), str(port), phase, ckpt],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out)
    lbs = []
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT"):
                lbs.append(float(line.split()[-1]))
    assert len(lbs) == 2, outs
    assert lbs[0] == lbs[1], f"processes disagree: {lbs}"
    return lbs[0]


@pytest.mark.skipif(
    os.environ.get("BDD_TPU_SKIP_MULTIPROC") == "1",
    reason="multi-process dryrun disabled",
)
def test_two_process_restart_from_checkpoint(tmp_path):
    ckpt = str(tmp_path / "sharded.ckpt")
    port = _free_port()
    lb_start = _run_phase(tmp_path, port, "start", ckpt)
    assert os.path.exists(ckpt)
    port = _free_port()
    lb_resumed = _run_phase(tmp_path, port, "resume", ckpt)

    # uninterrupted single-process 8-device reference run (conftest gives
    # this process 8 virtual CPU devices)
    jax.config.update("jax_enable_x64", True)
    ilp = grid_mrf(4, 4, 3, seed=0)
    ilp.reorder_bfs()
    ilp.normalize()
    pre = BddPreprocessor(ilp)
    s = ShardedUniformSolver(
        pre.collection,
        pre.total_nr_variables(),
        pre.objective_vector(),
        nr_primal_vars=pre.nr_primal_variables,
        dtype=jnp.float64,
    )
    s.iteration_block(8)
    assert s.lower_bound_with_deferred() == pytest.approx(lb_start, abs=1e-9)
    s.iteration_block(8)
    lb_ref = s.lower_bound_with_deferred()
    assert lb_resumed == pytest.approx(lb_ref, abs=1e-9)


def test_save_load_single_process_roundtrip(tmp_path):
    """multihost.save_sharded/load_sharded also work single-process (and the
    blob is extras.load_state compatible)."""
    from bdd_tpu.solver import extras
    from bdd_tpu.utils import multihost as mh

    jax.config.update("jax_enable_x64", True)
    ilp = grid_mrf(3, 3, 2, seed=1)
    ilp.normalize()
    pre = BddPreprocessor(ilp)

    def make():
        return ShardedUniformSolver(
            pre.collection,
            pre.total_nr_variables(),
            pre.objective_vector(),
            nr_primal_vars=pre.nr_primal_variables,
            dtype=jnp.float64,
        )

    s = make()
    s.iteration_block(5)
    path = str(tmp_path / "ck.pkl")
    mh.save_sharded(s, path)
    lb5 = s.lower_bound_with_deferred()
    s.iteration_block(5)
    lb10 = s.lower_bound_with_deferred()

    r = make()
    mh.load_sharded(r, path)
    assert r.lower_bound_with_deferred() == pytest.approx(lb5, abs=0)
    r.iteration_block(5)
    assert r.lower_bound_with_deferred() == pytest.approx(lb10, abs=0)

    r2 = make()
    extras.load_state(r2, path)  # blob-format compatibility
    assert r2.lower_bound_with_deferred() == pytest.approx(lb5, abs=1e-12)
