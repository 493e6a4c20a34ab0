"""Measure the split-plan C/penalty tradeoff on the real chip (gm50k):
time one shard's iteration for plans built with different
class_merge_penalty values. Decides the default penalty with data.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bdd_tpu.utils.platform import device_platform

device_platform()

import functools

import jax
import numpy as np

from bdd_tpu.solver import uniform as uf
from bdd_tpu.solver import uniform_sharded as us
from benchmarks.compaction_analysis import build
from benchmarks.scale_ceiling import time_block


def main():
    fam = sys.argv[1] if len(sys.argv) > 1 else "gm50k"
    Ds = [int(x) for x in sys.argv[2:]] or [2, 4, 8]
    pre = build(fam)
    V = pre.total_nr_variables()
    obj = pre.objective_vector()
    for D in Ds:
        geoms, hosts, _, counts = us.build_shard_geoms(
            pre.collection, V, D, plan_family="windowed"  # base, no split
        )
        base_geom = geoms[0]._replace(exchange=None)
        ids = np.concatenate(
            [np.asarray(g.layer_var).ravel() for g in base_geom.buckets]
        )
        val = np.concatenate(
            [np.asarray(g.layer_valid).ravel() for g in base_geom.buckets]
        )
        # shard ids for all shards (plan builder needs them all)
        all_ids, all_val = [], []
        for geom in geoms:
            all_ids.append(np.concatenate(
                [np.asarray(g.layer_var).ravel() for g in geom.buckets]
            ))
            all_val.append(np.concatenate(
                [np.asarray(g.layer_valid).ravel() for g in geom.buckets]
            ))
        h0 = uf.UniformHost(
            geom=base_geom, bdd_of_col=(), depths=(), nr_vars=V,
            nr_primal_vars=pre.nr_primal_variables, nr_bdds=0,
        )
        s0 = uf.init_uniform_state(h0, obj)
        n = 250 if fam == "gm50k" else 1000
        for pen in (0.0, 3.0, 8.0, 20.0):
            plans = uf.build_split_plans(
                all_ids, all_val, V, class_merge_penalty=pen
            )
            if plans is None:
                print(f"# {fam} D={D} pen={pen}: no split plan", flush=True)
                continue
            p = plans[0]
            g = base_geom._replace(exchange=p)
            t = time_block(g, s0, n)[0]
            nv = sum(nvv for _, _, nvv in p.classes)
            print(
                f"# {fam} D={D} pen={pen}: C={p.C} N={p.key_fwd.shape[0]} "
                f"heavy_nv={nv} -> T_shard={t*1e3:.3f} ms",
                flush=True,
            )


if __name__ == "__main__":
    main()
