"""Host-side analysis for per-shard COMPACTED-column exchange plans
For each family and shard count D, report:

  * E_s       — shard-0 slot count (exchange volume in),
  * Vs        — distinct variables the shard touches,
  * N_cur     — current plan sort volume (windowed or global-column),
  * N_cmp     — compacted-plan sort volume max(E_s, C*Vx) with the layout
                over only touched variables (max-local counts),
  * merge     — extra static-permutation volume to place/fetch the compacted
                totals into the [2, Vg] psum vector (2 sorts x (key + 2
                payloads) x Vg elements, charged in units of N-elements),

so we can decide whether compaction beats the global-column fallback before
implementing the device path. CPU-only (plan building is host numpy).
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from bdd_tpu.solver import uniform as uf
from bdd_tpu.solver import uniform_sharded as us


def build(which: str):
    from bdd_tpu.bdd.preprocessor import BddPreprocessor
    from bdd_tpu.utils.problems import grid_mrf, quadratic_assignment

    if which == "gm50k":
        from bdd_tpu.frontends.graph_matching import (
            construct_graph_matching_ilp,
        )
        from bdd_tpu.utils.problems import graph_matching

        inst = graph_matching(
            120, 120, seed=0, candidates=6, nr_quadratic=2000
        )
        ilp = construct_graph_matching_ilp(inst)[0]
    elif which == "qap18":
        ilp = quadratic_assignment(18, seed=0, density=0.06)
    elif which == "grid24":
        ilp = grid_mrf(24, 24, 8, seed=0)
    else:
        raise SystemExit(which)
    ilp.reorder_bfs()
    ilp.normalize()
    return BddPreprocessor(ilp)


def main():
    for which in sys.argv[1:] or ["qap18", "gm50k"]:
        t0 = time.time()
        pre = build(which)
        V = pre.total_nr_variables()
        print(f"## {which}: V={V} (build {time.time() - t0:.0f}s)", flush=True)
        host = uf.flatten_uniform(
            pre.collection, V, pre.nr_primal_variables
        )
        plan1 = host.geom.exchange
        E1 = sum(g.H * g.B for g in host.geom.buckets)
        print(
            f"#  single chip: E={E1} N1="
            f"{plan1.key_fwd.shape[0] if plan1 else 'segment'}",
            flush=True,
        )
        for D in (2, 4, 8):
            geoms, hosts, _, counts = us.build_shard_geoms(
                pre.collection, V, D
            )
            g0 = geoms[0]
            E_s = sum(g.H * g.B for g in g0.buckets)
            N_cur = (
                g0.exchange.key_fwd.shape[0] if g0.exchange else 0
            )
            windowed = bool(g0.exchange and g0.exchange.Vg)
            # per-shard stats over ALL shards (worst case governs: all
            # shards run the same shapes)
            rows = []
            for geom in geoms:
                ids = np.concatenate(
                    [np.asarray(g.layer_var).ravel() for g in geom.buckets]
                )
                val = np.concatenate(
                    [np.asarray(g.layer_valid).ravel() for g in geom.buckets]
                )
                rv = ids[val]
                rows.append((ids, val, np.unique(rv)))
            Vs_max = max(r[2].size for r in rows)
            # compacted layout: per-shard ids remapped to its own touched
            # set; the shared class layout uses elementwise-max of the
            # remapped count profiles ONLY within each shard's own space,
            # so shapes differ — for the stacked mesh we need the max
            # shapes; approximate with the max over shards of each shard's
            # own compacted plan volume
            n_cmp_max = 0
            for ids, val, touched in rows:
                rel = np.searchsorted(touched, ids)
                rel[~val] = touched.size
                p = uf.build_exchange_plan(
                    rel, val, int(touched.size), max_blowup=64.0
                )
                if p is not None:
                    n_cmp_max = max(n_cmp_max, int(p.key_fwd.shape[0]))
            Vg = ((V + 1 + 127) // 128) * 128
            merge_elems = 2 * 3 * Vg  # 2 sorts x (1 key + 2 payloads) x Vg
            print(
                f"#  D={D}: E_s={E_s} Vs_max={Vs_max} ({Vs_max/V:.2f}V) "
                f"N_cur={N_cur}{' (windowed)' if windowed else ''} "
                f"N_cmp={n_cmp_max} merge~{merge_elems} "
                f"(cur_total~{3*N_cur}, cmp_total~{3*n_cmp_max+merge_elems})",
                flush=True,
            )


if __name__ == "__main__":
    main()
