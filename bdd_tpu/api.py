"""Top-level solver pipeline + CLI.

JSON-config compatible with the reference schema (README.md:24-76; pipeline
bdd_solver.h:37-43 / src/bdd_solver/bdd_solver.cpp):

    read ILP -> variable reorder -> normalize -> ILP->BDD -> dual solver ->
    perturbation rounding.

Relaxation solver names (reference names map to device backends):
    "sequential mma" / "parallel mma"      -> numpy oracle backend (host)
    "cuda parallel mma" / "jax mma" / "mma" -> JAX bucketed backend (device)
"""
from __future__ import annotations

import json
import math
import sys
from typing import Dict, Optional

import numpy as np

from bdd_tpu.bdd.preprocessor import BddPreprocessor, InfeasibleError
from bdd_tpu.ilp.lp_parser import parse_lp_string
from bdd_tpu.solver.flatten import flatten_collection
from bdd_tpu.solver.ref_solver import RefSolver
from bdd_tpu.solver.rounding import incremental_mm_rounding
from bdd_tpu.solver.run import run_solver
from bdd_tpu.solver.wrapper import JaxSolver
from bdd_tpu.utils.logging import bdd_log

DEFAULT_CONFIG = {
    "variable order": "input",  # input|bfs|minimum degree|cuthill
    "use native preprocessing": True,  # C++ host pipeline when applicable
    "normalize constraints": True,
    "precision": "float",  # float|double (double matches the reference CPU default)
    "relaxation solver": "uniform mma",
    "split chunk size": None,  # cap BDD depth (sequence parallelism); int or "auto"
    "split implication": False,  # redundant cross-chunk implication BDD (ref bdd_solver.cpp:108-120)
    "termination criteria": {
        "maximum iterations": 1000,
        # reference code defaults (bdd_solver.cpp:279-282): minimum
        # improvement (relative tolerance) 1e-6, improvement slope 1e-9
        # (the reference README documents 1e-6 for the slope; its code uses
        # 1e-9 — we follow the code, which is what the binaries run with)
        "improvement slope": 1e-9,
        "minimum improvement": 1e-6,
        "time limit": 3600,
    },
    "perturbation rounding": {
        "initial perturbation": math.inf,
        "perturbation growth rate": 1.1,
        "inner iterations": 100,
        # the reference README documents 100 outer iterations but its CODE
        # runs up to 500 rounds (incremental_mm_agreement_rounding.hxx:47);
        # at 100 the 3000x6000 set cover measurably stops 20 rounds short of
        # full mm agreement (benchmarks/primal_quality.py)
        "outer iterations": 500,
    },
}


def _merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            out[k] = _merge(base[k], v)
        else:
            out[k] = v
    return out



def _lbfgs_kwargs(config: dict) -> dict:
    """Accept the reference's spaced JSON keys (README.md:71-76)."""
    rename = {
        "history size": "history_size",
        "initial step size": "init_step_size",
        "required relative lb increase": "required_relative_lb_increase",
        "step size decrease factor": "step_size_decrease_factor",
        "step size increase factor": "step_size_increase_factor",
    }
    return {rename.get(k, k): v for k, v in config.get("lbfgs", {}).items()}


class BddSolver:
    """The orchestration class (ref: include/bdd_solver/bdd_solver.h:45-103)."""

    def __init__(self, config: Optional[dict] = None, **kwargs) -> None:
        config = _merge(DEFAULT_CONFIG, config or {})
        config = _merge(config, kwargs)
        # Reference-spelled BDD-splitting block (bdd_solver.cpp:108-120):
        #   "split bdds": {"split length": N, "implication bdd": true}
        # maps onto our "split chunk size"/"split implication" keys. As in the
        # reference, "split bdds" without a length means auto-computed length.
        sb = config.get("split bdds")
        if sb is not None and sb is not False:
            sb = sb if isinstance(sb, dict) else {}
            if not config.get("split chunk size"):
                config["split chunk size"] = sb.get("split length", "auto")
            if "implication bdd" in sb or "implication" in sb:
                config["split implication"] = bool(
                    sb.get("implication bdd", sb.get("implication"))
                )
        if config.get("smoothing") and "smooth" not in str(
            config.get("relaxation solver", "")
        ):
            # a "smoothing" key with a non-smooth solver selects the smoothed
            # dual-ascent solver (the reference's dispatch marks this "not
            # currently implemented", bdd_solver.cpp:127-138 — here it runs:
            # solver/smooth_mma.py)
            bdd_log("[bdd solver] smoothing requested: switching relaxation "
                    "solver to 'smooth mma'")
            config["relaxation solver"] = "smooth mma"
        self.config = config
        self._ilp = None
        self.solver = None
        self.infeasible = False
        self._lp_text = None
        self.var_perm = None  # old index per new position (None = identity)

    @property
    def ilp(self):
        if self._ilp is None and self._lp_text is not None:
            self._ilp = parse_lp_string(self._lp_text)
        return self._ilp

    @ilp.setter
    def ilp(self, value):
        self._ilp = value

    # ------------------------------------------------------------------ input
    def read_ilp(self, ilp=None, path: Optional[str] = None, lp_string: Optional[str] = None):
        if ilp is not None:
            self._ilp = ilp
        elif lp_string is not None:
            self._lp_text = lp_string  # python parse deferred (native path)
        elif path is not None:
            # Specialized problem frontends (ref: the dedicated solver CLIs
            # src/specialized_solvers/{mrf,graph_matching,multi_graph_matching}
            # _solver_cl.cpp, each a bdd_solver subclass overriding read_ILP,
            # mrf_solver.h:5-11). Here one CLI: the "input type" config key or
            # the file extension selects the frontend.
            input_type = str(self.config.get("input type", "")).lower()
            if input_type in ("uai", "mrf", "uai mrf") or (
                not input_type and path.endswith(".uai")
            ):
                from bdd_tpu.frontends.mrf_uai import parse_uai_file

                self._ilp = parse_uai_file(path).convert_to_ilp()
            elif input_type in ("graph matching", "gm") or (
                not input_type and path.endswith(".dd")
            ):
                from bdd_tpu.frontends.graph_matching import (
                    parse_graph_matching_file,
                )

                self._ilp = parse_graph_matching_file(path)
            elif input_type in ("multi graph matching", "mgm") or (
                not input_type and path.endswith(".mgm")
            ):
                from bdd_tpu.frontends.multi_graph_matching import (
                    construct_multi_graph_matching_ilp,
                    parse_mgm_file,
                )

                self._ilp = construct_multi_graph_matching_ilp(
                    parse_mgm_file(path)
                )
            elif path.endswith(".opb"):
                from bdd_tpu.ilp.opb_parser import parse_opb_file

                self._ilp = parse_opb_file(path)
            elif path.endswith(".mps"):
                from bdd_tpu.ilp.mps_parser import parse_mps_file

                self._ilp = parse_mps_file(path)
            else:
                with open(path) as fh:
                    self._lp_text = fh.read()
        else:
            path = self.config.get("input")
            if path is None:
                raise ValueError("no input given")
            return self.read_ilp(path=path)
        return self

    def process_ilp(self):
        order = self.config["variable order"]
        if order == "bfs":
            self.var_perm = self.ilp.reorder_bfs()
        elif order == "cuthill":
            self.var_perm = self.ilp.reorder_cuthill_mckee()
        elif order in ("minimum degree", "mindegree"):
            self.var_perm = self.ilp.reorder_minimum_degree()
        elif order != "input":
            raise ValueError(f"unknown variable order {order!r}")
        if self.config["normalize constraints"]:
            self.ilp.normalize()
        return self

    def transform_to_bdds(self):
        self.pre = BddPreprocessor(
            self.ilp,
            split_chunk_size=self.config["split chunk size"],
            split_implication_bdd=self.config["split implication"],
        )
        self.flat = flatten_collection(
            self.pre.collection,
            self.pre.total_nr_variables(),
            self.pre.nr_primal_variables,
        )
        bdd_log(
            f"[bdd solver] {self.flat.nr_bdds} BDDs, {self.flat.nr_nodes} nodes, "
            f"{self.flat.nr_layers} layers, {self.flat.nr_hops} hops, "
            f"{self.flat.nr_vars} variables"
        )
        return self

    # ------------------------------------------------------- export phases
    # (ref: bdd_solver.cpp solve() pipeline, 477-495: export_lp after
    # process_ILP; print_statistics / export_bdd_graph / export_bdd_lp after
    # transform_to_BDDs)
    def export_lp_file(self) -> None:
        path = self.config.get("export lp")
        if not path:
            return
        if path.endswith(".opb"):
            text = self.ilp.write_opb()
        elif path.endswith(".mps"):
            text = self.ilp.write_mps()
        elif path.endswith(".lp"):
            text = self.ilp.write_lp()
        else:
            raise ValueError(
                f"Cannot recognize file extension of {path!r} for exporting "
                "problem file (.lp/.opb/.mps)")
        with open(path, "w") as fh:
            fh.write(text)

    def print_statistics(self) -> None:
        """ILP/BDD size statistics (ref: bdd_solver.cpp:382-398)."""
        if not self.config.get("print statistics"):
            return
        ilp = self.ilp
        counts = np.zeros(ilp.nr_variables(), dtype=np.int64)
        for c in ilp.constraints():
            for v in c.variables():
                counts[v] += 1
        bdd_log(f"[print_statistics] #variables = {ilp.nr_variables()}")
        bdd_log(f"[print_statistics] #constraints = {ilp.nr_constraints()}")
        bdd_log(f"[print_statistics] #BDDs = {self.pre.collection.nr_bdds()}")
        if len(counts):
            bdd_log("[print_statistics] minimum num. constraints per var = "
                    f"{int(counts.min())}")
            bdd_log("[print_statistics] maximum num. constraints per var = "
                    f"{int(counts.max())}")
            bdd_log("[print_statistics] mean num. constraints per var = "
                    f"{float(counts.mean())}")

    def export_bdd_graph(self) -> None:
        """One graphviz .dot file per BDD, ``<base>_<nr>.dot``
        (ref: bdd_solver.cpp:433-466; the reference also shells out to
        ``dot -Tpng`` — skipped here)."""
        path = self.config.get("export bdd graph")
        if not path:
            return
        base = path[:-4] if path.endswith(".dot") else path
        col = self.pre.collection
        for bdd_nr in range(col.nr_bdds()):
            with open(f"{base}_{bdd_nr}.dot", "w") as fh:
                fh.write(col.export_graphviz(bdd_nr))

    def export_bdd_lp_file(self) -> None:
        path = self.config.get("export bdd lp")
        if not path:
            return
        with open(path, "w") as fh:
            fh.write(self.pre.collection.write_bdd_lp(
                self.pre.objective_vector()))

    def construct_solver(self):
        name = self.config["relaxation solver"]
        double = self.config["precision"] == "double"
        obj = self.pre.objective_vector()
        if name == "sequential mma":
            from bdd_tpu.solver.sequential import SequentialSolver

            self.solver = SequentialSolver(
                self.flat, obj, dtype=np.float64 if double else np.float32
            )
        elif name in ("parallel mma", "ref mma"):
            self.solver = RefSolver(
                self.flat, obj, dtype=np.float64 if double else np.float32
            )
        elif name in ("hybrid mma", "multi parallel mma",
                      "hybrid parallel mma"):
            # heterogeneous host+device concurrent solve: long BDDs on the
            # native C++ OpenMP solver, short ones on the uniform device
            # backend, delta consensus per half-sweep (the literal analogue
            # of the reference's CPU+GPU bdd_multi_parallel_mma_base.cu —
            # which its own JSON dispatch never exposes; ours does)
            import jax.numpy as jnp

            from bdd_tpu.solver.hybrid import HybridSolver

            if double:
                import jax

                jax.config.update("jax_enable_x64", True)
            self.solver = HybridSolver(
                self.pre.collection,
                self.pre.total_nr_variables(),
                obj,
                nr_primal_vars=self.pre.nr_primal_variables,
                dtype=jnp.float64 if double else jnp.float32,
                hop_threshold=self.config.get("hybrid hop threshold"),
            )
        elif name in ("sharded mma",
                      "lbfgs sharded mma", "subgradient sharded mma"):
            # BDD-block partition over all visible devices, psum consensus
            # (the N-way generalization of the reference's 2-way hybrid
            # CPU/GPU split, bdd_multi_parallel_mma_base.cu:268-455)
            import jax.numpy as jnp

            from bdd_tpu.solver.uniform_sharded import ShardedUniformSolver

            if double:
                import jax

                jax.config.update("jax_enable_x64", True)
            base = ShardedUniformSolver(
                self.pre.collection,
                self.pre.total_nr_variables(),
                obj,
                nr_primal_vars=self.pre.nr_primal_variables,
                dtype=jnp.float64 if double else jnp.float32,
                # "auto" (default): J-model choice between the contiguous
                # block partition and the min-cut refinement
                partition=self.config.get("partition", "auto"),
            )
            if name.startswith("lbfgs"):
                from bdd_tpu.solver.lbfgs import LbfgsSolver

                base = LbfgsSolver(base, **_lbfgs_kwargs(self.config))
            elif name.startswith("subgradient"):
                from bdd_tpu.solver.subgradient import SubgradientSolver

                base = SubgradientSolver(base)
            self.solver = base
        elif name in ("smooth mma", "mma smooth", "parallel mma smooth"):
            # smoothed sum-marginal-averaging dual ascent with temperature
            # annealing (ref classes: bdd_parallel_mma_base_smooth.h:1-631;
            # their JSON dispatch never ran them — ours does)
            import jax.numpy as jnp

            from bdd_tpu.solver.smooth_mma import SmoothSolver

            if double:
                import jax

                jax.config.update("jax_enable_x64", True)
            self.solver = SmoothSolver(
                self.pre.collection,
                self.pre.total_nr_variables(),
                obj,
                nr_primal_vars=self.pre.nr_primal_variables,
                dtype=jnp.float64 if double else jnp.float32,
                smoothing=(
                    float(self.config["smoothing"])
                    if isinstance(self.config.get("smoothing"), (int, float))
                    and not isinstance(self.config.get("smoothing"), bool)
                    else 0.1
                ),
                smoothing_decay=float(
                    self.config.get("smoothing decay factor", 0.5)
                ),
                min_smoothing=float(self.config.get("min smoothing", 1e-3)),
            )
        elif name in ("cuda parallel mma", "jax mma", "mma", "uniform mma",
                      "lbfgs parallel mma", "lbfgs cuda parallel mma",
                      "lbfgs jax mma", "subgradient", "dense mma"):
            import jax.numpy as jnp

            if double:
                import jax

                jax.config.update("jax_enable_x64", True)
            dt = jnp.float64 if double else jnp.float32
            if name == "dense mma":
                base = JaxSolver(self.flat, obj, dtype=dt)
            else:
                from bdd_tpu.solver.uniform_wrapper import UniformSolver

                base = UniformSolver(
                    self.pre.collection,
                    self.pre.total_nr_variables(),
                    obj,
                    nr_primal_vars=self.pre.nr_primal_variables,
                    dtype=dt,
                )
            if name.startswith("lbfgs"):
                from bdd_tpu.solver.lbfgs import LbfgsSolver

                base = LbfgsSolver(base, **_lbfgs_kwargs(self.config))
            elif name == "subgradient":
                from bdd_tpu.solver.subgradient import SubgradientSolver

                base = SubgradientSolver(base)
            self.solver = base
        else:
            raise ValueError(f"unknown relaxation solver {name!r}")
        return self

    # ------------------------------------------------------------------ solve
    def solve_dual(self, verbose: bool = True) -> float:
        from bdd_tpu.utils.logging import device_trace

        t = self.config["termination criteria"]
        self.dual_stats = {}
        with device_trace(label="solve_dual"):  # BDD_TPU_TRACE=dir to capture
            lb = run_solver(
                self.solver,
                max_iter=t["maximum iterations"],
                tolerance=t["minimum improvement"],
                improvement_slope=t["improvement slope"],
                time_limit=t["time limit"],
                verbose=verbose,
                block_size=getattr(self.solver, "default_block_size", 1),
                stats=self.dual_stats,
            )
        if math.isinf(lb):
            self.infeasible = True
        return lb

    def round(self, verbose: bool = True) -> Optional[np.ndarray]:
        p = self.config["perturbation rounding"]
        if p is False:  # dual-only run (rounding disabled)
            return None
        # "rounding method": "incremental" (reference pipeline default),
        # "wedelin" (the reference implements but never dispatches it,
        # incremental_mm_agreement_rounding.hxx:160 — measurably stronger on
        # loose flow families: CT -263 -> -305 objective), or
        # "best" (run both, keep the better objective).
        method = p.get("method", self.config.get("rounding method",
                                                 "incremental"))

        def _incremental(bias: float = 0.0):
            sol = incremental_mm_rounding(
                self.solver,
                init_delta=p["initial perturbation"],
                delta_growth_rate=p["perturbation growth rate"],
                num_itr_lb=p["inner iterations"],
                num_rounding_itr=p["outer iterations"],
                verbose=verbose,
                objective_bias=bias,
                objective=self.pre.objective_vector() if bias else None,
            )
            return None if sol is None else sol[: self.ilp.nr_variables()]

        def _incremental_biased():
            # objective-tilted tie-breaking (rounding.py docstring): repairs
            # the slack-collapse of symmetric coin flips on LP-loose families
            return _incremental(float(p.get("objective bias", 0.5)))

        def _wedelin():
            from bdd_tpu.solver.extras import wedelin_rounding

            sol = wedelin_rounding(self.solver, verbose=verbose)
            return None if sol is None else np.asarray(sol)[
                : self.ilp.nr_variables()
            ]

        if method == "wedelin":
            return _wedelin()
        if method in ("incremental biased", "biased"):
            return _incremental_biased()
        if method == "best":
            # the heuristics perturb the solver costs in place — snapshot
            # the dual state so each starts from the same converged point
            # (outer-loop wrappers like LbfgsSolver hold the state on .base)
            target = self.solver
            if not hasattr(target, "state") and hasattr(target, "base"):
                target = target.base
            snap = getattr(target, "state", None)
            best_sol, best_obj = None, math.inf
            for i, fn in enumerate(
                (_incremental, _wedelin, _incremental_biased)
            ):
                if i and snap is not None:
                    target.state = snap
                sol = fn()
                if sol is None:
                    continue
                obj = self.ilp.evaluate([int(v) for v in sol])
                if obj < best_obj:
                    best_sol, best_obj = sol, obj
            return best_sol
        return _incremental()

    # --------------------------------------------------- solver-level queries
    # (ref: bdd_solver.h:92-97 lower_bound / min_marginals /
    #  min_marginals_with_variable_names / fix_variable / export_difficult_core)
    def lower_bound(self) -> float:
        if self.infeasible:
            return math.inf
        if hasattr(self.solver, "lower_bound_with_deferred"):
            return float(self.solver.lower_bound_with_deferred())
        return float(self.solver.lower_bound())

    def _var_names(self):
        if self._ilp is not None:
            return [self.ilp.get_var_name(i)
                    for i in range(self.ilp.nr_variables())]
        return self._native.var_names()

    def min_marginals(self, original_order: bool = True):
        """Per-variable stacked min marginals: list over variables of [n_i, 2]
        arrays (columns m0, m1), one row per BDD containing the variable (ref:
        bdd_solver::min_marginals, bdd_solver.cpp:497-514, incl. the
        permute-back-to-input-order step via permute_min_marginals)."""
        from bdd_tpu.solver.rounding import min_marginals_per_var

        m0, m1 = self.solver.min_marginals()
        off, m0s, m1s = min_marginals_per_var(self.solver.f, m0, m1)
        per_var = [
            np.stack([m0s[off[v]:off[v + 1]], m1s[off[v]:off[v + 1]]], axis=1)
            for v in range(len(off) - 1)
        ]
        if original_order and self.var_perm is not None:
            n = len(self.var_perm)
            out = list(per_var)
            for new, old in enumerate(self.var_perm):
                out[old] = per_var[new]
            per_var = out[:n] + per_var[n:]
        return per_var

    def min_marginals_with_variable_names(self):
        """(names, mm_lo, mm_hi) flat vectors, one entry per (variable, BDD)
        layer (ref: export_min_marginals_with_names,
        min_marginal_utils.h:91-110)."""
        per_var = self.min_marginals(original_order=False)
        names = self._var_names()
        out_names, lo, hi = [], [], []
        for v, name in enumerate(names):
            for row in per_var[v]:
                out_names.append(name)
                lo.append(float(row[0]))
                hi.append(float(row[1]))
        return out_names, lo, hi

    def fix_variable(self, var, value) -> None:
        """Fix a primal variable (by index or name) to 0/1 in the constructed
        solver (ref: bdd_solver.cpp:521-541)."""
        from bdd_tpu.solver.extras import fix_variable

        if isinstance(var, str):
            if self._ilp is not None:
                var = self.ilp.get_var_index(var)
            else:
                var = self._native.var_names().index(var)
        fix_variable(self.solver, int(var), int(value))

    def export_difficult_core(self, path: Optional[str] = None,
                              threshold: Optional[float] = None):
        """Fix variables whose min-marginal sums agree by more than
        ``threshold`` and export the reduced 'difficult core' ILP
        (.lp/.opb/.mps by extension; declared at bdd_solver.h:97 — the
        reference's implementation is commented out at bdd_solver.cpp:550-578;
        this follows that commented intent). Returns the reduced ILPInput."""
        from bdd_tpu.solver.rounding import MM_ONE, MM_ZERO, MmDecoder

        path = path if path is not None else self.config.get(
            "export difficult core")
        threshold = threshold if threshold is not None else float(
            self.config.get("export difficult core th", 1e-6))
        # fold pending deferred deltas first: classification from
        # pre-consensus costs fixes the wrong variables (both rounding paths
        # distribute before classifying)
        if hasattr(self.solver, "distribute_delta"):
            self.solver.distribute_delta()
        m0, m1 = self.solver.min_marginals()
        dec = MmDecoder(self.solver.f, np.asarray(m0), np.asarray(m1))
        n = self.ilp.nr_variables()
        one_fix = [v for v in range(n)
                   if dec.types[v] == MM_ONE
                   and dec.sum1[v] + threshold <= dec.sum0[v]]
        zero_fix = [v for v in range(n)
                    if dec.types[v] == MM_ZERO
                    and dec.sum0[v] + threshold <= dec.sum1[v]]
        reduced = self.ilp.reduce(zero_fix, one_fix)
        bdd_log(f"[bdd solver] Difficult core has {reduced.nr_variables()} "
                f"variables and {reduced.nr_constraints()} constraints left")
        if path:
            if path.endswith(".opb"):
                text = reduced.write_opb()
            elif path.endswith(".mps"):
                text = reduced.write_mps()
            elif path.endswith(".lp"):
                text = reduced.write_lp()
            else:
                raise ValueError(
                    f"Cannot recognize file extension of {path!r} for "
                    "difficult core export file (.lp/.opb/.mps)")
            with open(path, "w") as fh:
                fh.write(text)
        return reduced

    def _try_native(self, verbose: bool) -> Optional[Dict]:
        """Native C++ preprocessing fast path (parse + order + BDDs + uniform
        buckets). Returns a result dict when fully handled natively, None to
        fall back to the Python pipeline."""
        cfg = self.config
        if not cfg.get("use native preprocessing", True):
            return None
        if any(cfg.get(k) for k in ("export lp", "export bdd lp",
                                    "export bdd graph", "print statistics",
                                    "export difficult core")):
            return None  # phases needing the python ILP/collection objects
        if cfg["relaxation solver"] not in ("uniform mma", "cuda parallel mma",
                                            "jax mma", "mma"):
            return None
        if cfg.get("split chunk size"):
            return None  # BDD splitting runs in the python pipeline
        if cfg.get("tighten"):
            return None  # the tightening phase runs in the python pipeline
        p = cfg.get("perturbation rounding")
        if isinstance(p, dict) and p.get("method", cfg.get(
                "rounding method", "incremental")) != "incremental":
            return None  # wedelin / best rounding run in the python pipeline
        if self._lp_text is None:
            # frontend-built ILPs (UAI MRF, graph matching, generators):
            # serialize through write_lp so they too get the C++ host
            # pipeline (parse + order + BDD DP + buckets, ~6x faster than
            # the python pipeline at scale); the native pipeline handles
            # monomials (Fortet linearization) and coalesce sets directly
            if self._ilp is not None:
                try:
                    self._lp_text = self._ilp.write_lp()
                except Exception:
                    return None
            else:
                return None
        try:
            from bdd_tpu.native import NativeHost, NativeUnsupported, available

            if not available():
                return None
            order = cfg["variable order"]
            nh = NativeHost(
                self._lp_text,
                order
                if order in ("input", "bfs", "cuthill", "minimum degree",
                             "mindegree")
                else "input",
            )
            self.var_perm = nh.var_perm()  # for min_marginals(original_order)
        except Exception:
            return None
        if nh.infeasible:
            return {"status": "infeasible", "lower_bound": math.inf}
        import jax.numpy as jnp

        double = cfg["precision"] == "double"
        if double:
            import jax

            jax.config.update("jax_enable_x64", True)
        dt = jnp.float64 if double else jnp.float32
        from bdd_tpu.solver.uniform_wrapper import UniformSolver

        solver = UniformSolver.__new__(UniformSolver)
        solver.host = nh.make_uniform_host(dtype=dt)
        solver.geom = solver.host.geom
        from bdd_tpu.solver import uniform as uf
        from bdd_tpu.solver.uniform_wrapper import UniformLayerView

        solver.state = uf.init_uniform_state(solver.host, nh.objective(), dtype=dt)
        solver.omega = 0.5
        solver.dtype = dt
        solver.f = UniformLayerView(solver.host)
        self.solver = solver
        self._native = nh
        lb = self.solve_dual(verbose=verbose)
        if self.infeasible:
            return {"status": "infeasible", "lower_bound": math.inf}
        lb = solver.lower_bound_with_deferred()
        p = cfg["perturbation rounding"]
        if p is False:  # dual-only run (rounding disabled)
            sol = None
        else:
            from bdd_tpu.solver.rounding_device import (
                incremental_mm_rounding_device,
            )

            sol = incremental_mm_rounding_device(
                solver,
                init_delta=p["initial perturbation"],
                delta_growth_rate=p["perturbation growth rate"],
                num_itr_lb=p["inner iterations"],
                num_rounding_itr=p["outer iterations"],
                verbose=verbose,
            )
        result = {"status": "solved", "lower_bound": float(lb),
                  **self.dual_stats}
        if sol is not None:
            names = nh.var_names()
            x = [int(v) for v in sol[: len(names)]]
            result["solution"] = dict(zip(names, x))
            result["objective"] = float(
                np.dot(nh.objective(), np.asarray(x)) + nh.constant()
            )
        return result

    def solve_batch(self, ilps=None, paths=None, verbose: bool = True):
        """Solve several INDEPENDENT ILPs as one batched device program
        (batched serving mode; no reference analogue — DOGE's layer-range
        concatenation, bdd_cuda_torch.py:102-133, is the closest pattern).
        Instances share the bucketed tensors; the delta exchange never mixes
        them (disjoint variable spaces). Returns one result dict per ILP,
        with per-instance lower bounds from the per-BDD decomposition.
        Config keys (solver must be a uniform-mma variant; rounding/termination
        apply to the joint program)."""
        import jax.numpy as jnp

        from bdd_tpu.solver.rounding_device import (
            incremental_mm_rounding_device,
        )
        from bdd_tpu.solver.uniform_wrapper import UniformSolver
        from bdd_tpu.utils.batching import BatchedInstances

        name = self.config["relaxation solver"]
        if name not in ("uniform mma", "cuda parallel mma", "jax mma", "mma"):
            raise ValueError(
                f"solve_batch requires a uniform-mma relaxation solver, "
                f"got {name!r}")
        if ilps is None:
            ilps = []
            for p in paths:
                sub = BddSolver(dict(self.config))
                sub.read_ilp(path=p)
                ilps.append(sub.ilp)
        n = len(ilps)
        results: list = [None] * n
        pres, live = [], []
        order = self.config["variable order"]
        for k, ilp in enumerate(ilps):
            if order == "bfs":
                ilp.reorder_bfs()
            elif order == "cuthill":
                ilp.reorder_cuthill_mckee()
            elif order in ("minimum degree", "mindegree"):
                ilp.reorder_minimum_degree()
            elif order != "input":
                raise ValueError(f"unknown variable order {order!r}")
            if self.config["normalize constraints"]:
                ilp.normalize()
            try:
                pres.append(BddPreprocessor(
                    ilp,
                    split_chunk_size=self.config["split chunk size"],
                    split_implication_bdd=self.config["split implication"],
                ))
                live.append(k)
            except InfeasibleError:
                results[k] = {"status": "infeasible",
                              "lower_bound": math.inf}
        if not live:
            return results
        bat = BatchedInstances([ilps[k] for k in live], pres=pres)
        dt = jnp.float64 if self.config["precision"] == "double" else jnp.float32
        if self.config["precision"] == "double":
            import jax

            jax.config.update("jax_enable_x64", True)
        solver = UniformSolver(bat.collection, bat.nr_vars, bat.objective,
                               dtype=dt)
        self.solver = solver
        self.solve_dual(verbose=verbose)
        # per-instance lower bounds from the per-BDD decomposition
        # (a joint-infeasible dual shows up as inf in the affected
        # instances' per-BDD sums below)
        solver.distribute_delta()
        per_bdd = solver.lower_bound_per_bdd()
        bounds = []
        for i, k in enumerate(live):
            b0 = bat.bdd_offsets[i]
            b1 = (bat.bdd_offsets[i + 1] if i + 1 < len(live)
                  else bat.collection.nr_bdds())
            bounds.append(float(np.sum(per_bdd[b0:b1])))
        p = self.config["perturbation rounding"]
        sol = None
        if p is not False:
            # honor the configured rounding method where the device rounder
            # supports it: 'incremental biased' maps to objective-tilted
            # tie-breaks; 'wedelin'/'best' have no batched device variant —
            # say so instead of silently dropping the setting
            method = p.get("method", self.config.get("rounding method",
                                                     "incremental"))
            bias = 0.0
            if method in ("incremental biased", "biased"):
                bias = float(p.get("objective bias", 0.5))
            elif method not in ("incremental",):
                bdd_log(f"[solve_batch] rounding method {method!r} has no "
                        f"batched device variant; using incremental")
            sol = incremental_mm_rounding_device(
                solver,
                init_delta=p["initial perturbation"],
                delta_growth_rate=p["perturbation growth rate"],
                num_itr_lb=p["inner iterations"],
                num_rounding_itr=p["outer iterations"],
                verbose=verbose,
                objective_bias=bias,
                objective=np.asarray(bat.objective) if bias else None,
            )
        for i, k in enumerate(live):
            ilp = ilps[k]
            res = {"status": "solved", "lower_bound": bounds[i]}
            if math.isinf(bounds[i]):
                res = {"status": "infeasible", "lower_bound": math.inf}
            elif sol is not None:
                xs = bat.slice_solution(np.asarray(sol), i)
                x = [int(v) for v in xs[: ilp.nr_variables()]]
                if ilp.feasible(x):
                    res["solution"] = {
                        ilp.get_var_name(j): x[j]
                        for j in range(ilp.nr_variables())
                    }
                    res["objective"] = float(ilp.evaluate(x))
            results[k] = res
        return results

    def _tighten_phase(self, verbose: bool) -> float:
        """Optional cut-tightening phase (config key ``"tighten"``: true or
        {"cliques": bool, "eps": float, "node limit": int}) — meld BDD groups
        around tight variables (clique facets in conflict graphs with
        "cliques") and re-solve WARM from the transferred converged duals.
        The reference implements tightening but never dispatches it
        (include/bdd_tightening.h); here it is a pipeline phase. Returns the
        (possibly improved) lower bound; the bound never decreases (warm
        cost transfer)."""
        from bdd_tpu.solver.tighten import (
            conflict_cuts,
            tight_variables,
            tighten_collection,
        )
        from bdd_tpu.solver.uniform_wrapper import UniformSolver

        t_cfg = self.config["tighten"]
        if not isinstance(t_cfg, dict):
            t_cfg = {}
        s = self.solver
        if not hasattr(s, "export_layer_costs") and hasattr(s, "base"):
            s = s.base
        lb0 = float(s.lower_bound_with_deferred())
        if not all(
            hasattr(s, a)
            for a in ("export_layer_costs", "min_marginals", "f")
        ):
            bdd_log("[tighten] solver exposes no layer costs — skipped")
            return lb0
        s.distribute_delta()
        m0, m1 = s.min_marginals()
        tv = tight_variables(s.f, m0, m1, eps=float(t_cfg.get("eps", 1e-4)))
        costs = s.export_layer_costs()
        explicit = None
        if t_cfg.get("cliques", True) or t_cfg.get("odd cycles", True):
            explicit = (
                conflict_cuts(
                    self.pre.collection,
                    tv,
                    cliques=t_cfg.get("cliques", True),
                    odd_cycles=t_cfg.get("odd cycles", True),
                )
                or None
            )
        new_col, new_costs, groups = tighten_collection(
            self.pre.collection,
            tv,
            layer_costs=costs,
            node_limit=int(t_cfg.get("node limit", 200000)),
            explicit_groups=explicit,
        )
        melded = sum(1 for g in groups.values() if len(g) > 1)
        if melded == 0:
            bdd_log("[tighten] no groups melded")
            return lb0
        bdd_log(
            f"[tighten] {melded} groups melded "
            f"({'clique facets' if explicit else 'tight-variable clusters'}),"
            f" bdds {self.pre.collection.nr_bdds()} -> {new_col.nr_bdds()}"
        )
        import jax.numpy as jnp

        dt = (
            jnp.float64
            if self.config["precision"] == "double"
            else jnp.float32
        )
        pre_solver = self.solver
        self.solver = UniformSolver(
            new_col,
            self.pre.total_nr_variables(),
            self.pre.objective_vector(),
            nr_primal_vars=self.pre.nr_primal_variables,
            layer_costs=new_costs,
            dtype=dt,
        )
        lb = self.solve_dual(verbose=verbose)
        lb = float(self.solver.lower_bound_with_deferred())
        bdd_log(f"[tighten] lower bound {lb0:.6f} -> {lb:.6f}")
        self._tighten_bounds = (lb0, lb)
        if lb < lb0:
            # the warm re-solve did not recover the pre-tighten bound in
            # budget: keep the original solver so the bound we report is the
            # bound actually held by the state rounding runs on
            self.solver = pre_solver
            return lb0
        return lb

    def solve(self, verbose: bool = True) -> Dict:
        """Full pipeline; returns result dict."""
        if self._ilp is None and self._lp_text is None:
            self.read_ilp()
        native_result = self._try_native(verbose)
        if native_result is not None:
            return native_result
        if self.ilp is None:
            self.read_ilp()
        self.process_ilp()
        self.export_lp_file()
        try:
            self.transform_to_bdds()
        except InfeasibleError:
            return {"status": "infeasible", "lower_bound": math.inf}
        self.print_statistics()
        self.export_bdd_graph()
        self.export_bdd_lp_file()
        self.construct_solver()
        lb = self.solve_dual(verbose=verbose)
        if self.infeasible:
            return {"status": "infeasible", "lower_bound": math.inf}
        lb = self.solver.lower_bound_with_deferred() if hasattr(
            self.solver, "lower_bound_with_deferred"
        ) else lb
        if self.config.get("tighten") and not self.infeasible:
            lb = self._tighten_phase(verbose)
        if self.config.get("export difficult core"):
            self.export_difficult_core()
        sol = self.round(verbose=verbose)
        if hasattr(self.solver, "close"):
            self.solver.close()  # hybrid mma: release the worker thread
        result = {"status": "solved", "lower_bound": float(lb),
                  **self.dual_stats}
        tb = getattr(self, "_tighten_bounds", None)
        if tb is not None:
            result["tighten"] = {
                "pre_lower_bound": float(tb[0]),
                "post_lower_bound": float(tb[1]),
            }
        if sol is not None:
            x = [int(v) for v in sol]
            result["solution"] = {
                self.ilp.get_var_name(i): x[i] for i in range(self.ilp.nr_variables())
            }
            result["objective"] = float(self.ilp.evaluate(x))
        return result


def main(argv=None) -> int:
    """CLI: ``python -m bdd_tpu.api config.json`` (ref: bdd_solver_cl.cpp)."""
    from bdd_tpu.utils.platform import device_platform

    device_platform()
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("usage: python -m bdd_tpu.api <config.json | problem.lp>")
        return 1
    arg = argv[0]
    if arg.endswith(".json"):
        with open(arg) as fh:
            config = json.load(fh)
        solver = BddSolver(config)
    else:
        solver = BddSolver({"input": arg})
    if "inputs" in solver.config:  # batched serving mode
        result = solver.solve_batch(paths=solver.config["inputs"])
    else:
        result = solver.solve()
    bdd_log(json.dumps(result, indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
