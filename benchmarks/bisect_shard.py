"""Stub-bisect ONE SHARD's iteration of the sharded uniform backend
(gm50k, D shards): where does the non-scaling T_shard go — sweeps,
exchange sorts, or glue? Reuses bisect_iteration's composed variants.

Usage: python benchmarks/bisect_shard.py [gm50k] [D] [pen]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bdd_tpu.utils.platform import device_platform

device_platform()

import numpy as np

from benchmarks.bisect_iteration import make_variants, time_variant, time_sorts
from benchmarks.compaction_analysis import build
from bdd_tpu.solver import uniform as uf
from bdd_tpu.solver import uniform_sharded as us


def main():
    fam = sys.argv[1] if len(sys.argv) > 1 else "gm50k"
    D = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    pen = float(sys.argv[3]) if len(sys.argv) > 3 else 8.0
    pre = build(fam)
    V = pre.total_nr_variables()
    obj = pre.objective_vector()
    geoms, hosts, _, _ = us.build_shard_geoms(
        pre.collection, V, D, plan_family="windowed"
    )
    base_geom = geoms[0]._replace(exchange=None)
    all_ids, all_val = [], []
    for geom in geoms:
        all_ids.append(np.concatenate(
            [np.asarray(g.layer_var).ravel() for g in geom.buckets]
        ))
        all_val.append(np.concatenate(
            [np.asarray(g.layer_valid).ravel() for g in geom.buckets]
        ))
    plans = uf.build_split_plans(all_ids, all_val, V, class_merge_penalty=pen)
    g = base_geom._replace(exchange=plans[0])
    p = plans[0]
    nb = len(g.buckets)
    hops = sum(int(b.node_valid.shape[0]) for b in g.buckets)
    cols = sum(int(b.B) for b in g.buckets)
    print(
        f"# {fam} D={D} pen={pen}: buckets={nb} serial_hops={hops} "
        f"cols={cols} C={p.C} N={p.key_fwd.shape[0]} "
        f"heavy_nv={sum(nv for _, _, nv in p.classes)}",
        flush=True,
    )
    h0 = uf.UniformHost(
        geom=g, bdd_of_col=(), depths=(), nr_vars=V,
        nr_primal_vars=pre.nr_primal_variables, nr_bdds=0,
    )
    s0 = uf.init_uniform_state(h0, obj)
    n = 250
    variants = make_variants(g)
    for name, fn in variants.items():
        t = time_variant(fn, s0, n)
        print(f"#   {name:12s} {t*1e3:.3f} ms/iter", flush=True)
    res = time_sorts(p)
    print(f"#   sorts: {res}", flush=True)


if __name__ == "__main__":
    main()
