"""Disk dataset + ground-truth pipeline (learn/data.py; reference
DOGE/data/disk_dataloader.py, gt_generator.py, write_dual_solved.py)."""
import os
import pickle

import numpy as np
import pytest

import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

from bdd_tpu import native
from bdd_tpu.bdd.preprocessor import BddPreprocessor
from bdd_tpu.learn.data import (
    IlpDiskDataset,
    converged_layer_costs,
    generate_gt,
)
from bdd_tpu.solver import uniform as uf
from bdd_tpu.solver.uniform_wrapper import UniformSolver
from bdd_tpu.utils.problems import grid_mrf, set_cover

needs_native = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)


def _write_instances(root):
    os.makedirs(root, exist_ok=True)
    paths = []
    for i, ilp in enumerate(
        [grid_mrf(3, 3, 2, seed=s) for s in (0, 1)]
        + [set_cover(12, 30, density=0.2, seed=3)]
    ):
        p = os.path.join(root, f"inst_{i}.lp")
        with open(p, "w") as fh:
            fh.write(ilp.write_lp())
        paths.append(p)
    return paths


@needs_native
def test_dataset_scan_cache_and_reload(tmp_path):
    root = str(tmp_path / "instances")
    _write_instances(root)
    # skip markers and non-matching extensions are ignored
    with open(os.path.join(root, "bad_too_easy.lp"), "w") as fh:
        fh.write("Minimize\nx\nSubject To\nc: x >= 1\nEnd\n")
    with open(os.path.join(root, "notes.txt"), "w") as fh:
        fh.write("not an instance")

    ds = IlpDiskDataset(root, verbose=False)
    assert len(ds) == 3
    # artifacts exist
    for e in ds.file_list:
        assert os.path.exists(e["bdd_repr_path"])
        assert os.path.exists(e["sol_path"])
    # sorted by file size ascending (largest last, reference policy)
    sizes = [e["lp_size"] for e in ds.file_list]
    assert sizes == sorted(sizes)

    inst, gt_info, path = ds.get(0)
    assert gt_info["lp_stats"]["obj"] is None  # need_gt=False -> empty schema
    # served instance is usable: initial bound matches a fresh build
    ilp = __import__("bdd_tpu.ilp.lp_parser", fromlist=["parse_lp_file"]).parse_lp_file(path)
    ilp.normalize()
    pre = BddPreprocessor(ilp)
    s = UniformSolver(pre.collection, pre.total_nr_variables(),
                      pre.objective_vector())
    got = float(uf.lower_bound_with_deferred(inst.host.geom, inst.state0))
    assert got == pytest.approx(s.lower_bound_with_deferred(), abs=1e-5)

    # second scan must reuse the caches (repr mtimes unchanged)
    mtimes = {e["bdd_repr_path"]: os.path.getmtime(e["bdd_repr_path"])
              for e in ds.file_list}
    ds2 = IlpDiskDataset(root, verbose=False, load_in_memory=True)
    assert len(ds2) == 3
    for p, t in mtimes.items():
        assert os.path.getmtime(p) == t
    inst2, _, _ = ds2.get(1)
    assert inst2.spec.nr_vars == ds.get(1)[0].spec.nr_vars


@needs_native
def test_dual_converged_state_transfers_exactly(tmp_path):
    """native f64 converged duals -> uniform state is an EXACT transfer:
    the uniform bound (f64) reproduces the native bound (the reverse of
    extras.transfer_costs_to_native, verified both ways now)."""
    ilp = grid_mrf(4, 4, 2, seed=5)
    ilp.normalize()
    pre = BddPreprocessor(ilp)
    costs = converged_layer_costs(pre, improvement=1e-12, max_iterations=3000)
    cs = native.cpu_solver_from_collection(
        pre.collection, pre.total_nr_variables(), pre.objective_vector()
    )
    cs.iterations(3000, 0.5)
    want = cs.lower_bound_with_deferred()

    host = uf.flatten_uniform(
        pre.collection, pre.total_nr_variables(), pre.nr_primal_variables,
        dtype=jnp.float64,
    )
    st = uf.init_uniform_state_from_layer_costs(host, costs, dtype=jnp.float64)
    got = float(uf.lower_bound_with_deferred(host.geom, st))
    assert got == pytest.approx(want, abs=1e-9)


@needs_native
def test_dataset_read_dual_converged(tmp_path):
    root = str(tmp_path / "instances")
    _write_instances(root)
    ds = IlpDiskDataset(root, read_dual_converged=True, verbose=False)
    inst, _, path = ds.get(0)
    # converged state bound must beat the cold initial bound
    from bdd_tpu.learn.data import read_any_ilp

    ilp = read_any_ilp(path)
    ilp.normalize()
    pre = BddPreprocessor(ilp)
    cold = UniformSolver(pre.collection, pre.total_nr_variables(),
                         pre.objective_vector())
    warm_lb = float(uf.lower_bound_with_deferred(inst.host.geom, inst.state0))
    assert warm_lb > cold.lower_bound_with_deferred() - 1e-6
    cold.iteration_block(500)
    # and be at (or above, f32 cast) the 500-iteration level
    assert warm_lb >= cold.lower_bound_with_deferred() - 1e-3


@needs_native
def test_generate_gt_schema_and_bounds(tmp_path):
    root = str(tmp_path / "instances")
    paths = _write_instances(root)
    lp_stats, ilp_stats = generate_gt(paths[0], need_ilp_gt=True,
                                      max_dual_iterations=2000)
    assert set(lp_stats) >= {"time", "obj", "sol_dict"}
    assert lp_stats["obj"] is not None and np.isfinite(lp_stats["obj"])
    if ilp_stats is not None:  # rounding may fail on tiny instances
        assert ilp_stats["obj"] >= lp_stats["obj"] - 1e-6
        assert isinstance(ilp_stats["sol_dict"], dict)


@needs_native
def test_dataset_files_to_load_and_error_rename(tmp_path):
    root = str(tmp_path / "instances")
    paths = _write_instances(root)
    names = [os.path.basename(p) for p in paths]
    ds = IlpDiskDataset(root, files_to_load=names[:1], verbose=False)
    assert len(ds) == 1
    # a file that fails conversion is renamed *_error_bdd.lp and skipped
    bad = os.path.join(root, "broken.lp")
    with open(bad, "w") as fh:
        fh.write("this is not an lp file at all {{{")
    ds2 = IlpDiskDataset(root, verbose=False)
    assert len(ds2) == 3
    assert os.path.exists(os.path.join(root, "broken_error_bdd.lp"))
    # and is retried (renamed back) on the next scan
    ds3 = IlpDiskDataset(root, verbose=False)
    assert os.path.exists(os.path.join(root, "broken_error_bdd.lp"))


@needs_native
def test_trainer_runs_from_disk_dataset(tmp_path):
    """End-to-end: dataset -> DogeTrainer rollout on a served instance."""
    root = str(tmp_path / "instances")
    _write_instances(root)
    ds = IlpDiskDataset(root, read_dual_converged=True, verbose=False)
    inst, _, _ = ds.get(0)
    from bdd_tpu.learn.train import DogeTrainer, TrainConfig

    tr = DogeTrainer(TrainConfig(nr_rounds=2, iters_per_round=3, dim=8,
                                 epochs=1))
    tr.init(inst)
    lbs = tr.run_learned_rounds(inst, nr_rounds=2)
    assert len(lbs) == 2 and all(np.isfinite(v) for v in lbs)


@needs_native
def test_sharded_trainer_from_disk_dataset(tmp_path):
    """Dataset -> sharded DOGE training over the virtual mesh: the dataset supplies discovery + converged-dual reference bound;
    the sharded trainer runs the rollout with psum consensus and training
    reduces the loss. The learned sharded rollout's bound must be sane
    against the cached converged bound."""
    from jax.sharding import Mesh

    from bdd_tpu.learn.sharded import ShardedDogeTrainer
    from bdd_tpu.learn.train import TrainConfig
    from bdd_tpu.solver.uniform_sharded import ShardedUniformSolver

    root = str(tmp_path / "instances")
    _write_instances(root)
    ds = IlpDiskDataset(root, read_dual_converged=True, verbose=False)
    inst, _gt, path = ds.get(0)
    conv_bound = float(
        uf.lower_bound_with_deferred(inst.host.geom, inst.state0)
    )
    # the sharded solver needs the collection: rebuild from the dataset's
    # instance path (the cached host pickles carry only the flat arrays)
    from bdd_tpu.learn.data import read_any_ilp

    ilp = read_any_ilp(path)
    ilp.normalize()
    pre = BddPreprocessor(ilp)
    mesh = Mesh(np.array(jax.devices()[:4]), ("b",))
    s = ShardedUniformSolver(
        pre.collection, pre.total_nr_variables(), pre.objective_vector(),
        mesh=mesh, nr_primal_vars=pre.nr_primal_variables,
        dtype=jnp.float32,
    )
    cfg = TrainConfig(dim=8, nr_rounds=2, iters_per_round=3, grad_rounds=1)
    tr = ShardedDogeTrainer(s, pre.objective_vector(), cfg)
    tr.init()
    losses = [tr.train_step()["loss"] for _ in range(3)]
    assert all(np.isfinite(losses))
    lbs = tr.run_learned_rounds(2)
    assert all(np.isfinite(lbs))
    # a valid dual bound never exceeds the converged optimum (f32 slack)
    assert max(lbs) <= conv_bound + 1e-3 * max(1.0, abs(conv_bound))
