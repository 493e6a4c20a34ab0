"""Primal quality at benchmark scale.

For the benchmark families at their benchmark sizes: dual solve + incremental
perturbation rounding, reporting the dual lower bound, the rounded objective,
the certified integrality gap, and wall times. The generated instances have
no known optimum, so the certificate is the dual bound itself:

    rounded objective >= optimum >= dual lb
    =>  (obj - lb) / max(|obj|, 1)  bounds the suboptimality of the rounding.

PASS = gap <= 5% — the outer edge of the reference's regression contract
(rounded solution within 1-5% of the optimum on its instance set,
/root/reference/test/bdd_solver_regression_test.cpp:36-58; the contract there
is vs known optima, which are unavailable offline — the dual-bound gap is the
strictly stronger certificate when it passes).

The reference's regression instances are REAL structured data with
near-tight LP relaxations; several generated analogues here (random set
cover, generated cell tracking / graph matching) carry an inherent
integrality gap, so (obj - lb) measures the INSTANCE's gap, not the
rounding's suboptimality. For those the suite adds two independent quality
certificates: a family greedy upper bound (rounding must beat it) and a
1-opt local-optimality check (no single feasible flip improves the rounded
solution). Verdict: PASS if gap <= 5%; PASS* if the rounding beats the
greedy baseline and is 1-opt-improvable by < 1%.

Usage: python benchmarks/primal_quality.py [fast] [family ...]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bdd_tpu.utils.platform import device_platform

device_platform()

from bdd_tpu.api import BddSolver
from bdd_tpu.frontends.graph_matching import construct_graph_matching_ilp
from bdd_tpu.utils.problems import (
    cell_tracking,
    graph_matching,
    grid_mrf,
    quadratic_assignment,
    set_cover,
)


def families(fast: bool):
    scale = 0.5 if fast else 1.0

    def gm():
        inst = graph_matching(
            120, 120, seed=0, candidates=6, nr_quadratic=2000
        )
        return construct_graph_matching_ilp(inst)[0]

    # (name, ilp builder, solver, dual iters, rounding method); the loose
    # flow families use "best" (incremental + wedelin, better objective kept)
    return [
        ("grid12", lambda: grid_mrf(12, 12, 4, seed=0), "uniform mma", 3000,
         "incremental"),
        ("grid24", lambda: grid_mrf(24, 24, 8, seed=0), "uniform mma", 4000,
         "incremental"),
        ("setcover3000", lambda: set_cover(3000, 6000, density=0.004, seed=0),
         "uniform mma", 3000, "best"),
        ("qap18", lambda: quadratic_assignment(18, seed=0, density=0.06),
         "uniform mma", 10000, "incremental"),
        ("ct30x40", lambda: cell_tracking(30, 40, seed=0), "uniform mma",
         2000, "best"),
        # MMA plateaus at ~4e-2 on GM; the reference also
        # ships L-BFGS solvers — use the variant that converges
        ("gm120", gm, "lbfgs jax mma", 1500, "best"),
    ]


def _linear_constraints(ilp):
    """(rows per var, coeff per (c, v), rhs, ineq) for singleton-monomial
    constraints; None if any constraint is truly nonlinear."""
    per_var = [[] for _ in range(ilp.nr_variables())]
    cons = []
    from bdd_tpu.ilp.model import Ineq

    for ci, c in enumerate(ilp.constraints_):
        terms = []
        for coef, m in zip(c.coefficients, c.monomials):
            if len(m) != 1:
                return None
            terms.append((m[0], coef))
            per_var[m[0]].append((ci, coef))
        cons.append((terms, c.rhs, c.ineq))
    return per_var, cons


def one_opt_improve(ilp, x):
    """Greedy 1-opt: flip single variables while feasibility holds and the
    objective improves. Returns (improved x, objective). Linear-constraint
    instances only (returns input unchanged otherwise)."""
    lin = _linear_constraints(ilp)
    if lin is None:
        return x, ilp.evaluate(x)
    from bdd_tpu.ilp.model import Ineq

    per_var, cons = lin
    V = ilp.nr_variables()
    x = list(x)
    lhs = [sum(coef * x[v] for v, coef in terms) for terms, _, _ in cons]

    def flip_ok(v, new):
        d = new - x[v]
        for ci, coef in per_var[v]:
            nl = lhs[ci] + coef * d
            _, rhs, ineq = cons[ci]
            if ineq == Ineq.LEQ and nl > rhs:
                return False
            if ineq == Ineq.GEQ and nl < rhs:
                return False
            if ineq == Ineq.EQ and nl != rhs:
                return False
        return True

    obj = ilp.objective_
    changed = True
    rounds = 0
    while changed and rounds < 20:
        changed = False
        rounds += 1
        for v in range(V):
            new = 1 - x[v]
            gain = obj[v] * (new - x[v])
            if gain >= 0 or not flip_ok(v, new):
                continue
            for ci, coef in per_var[v]:
                lhs[ci] += coef * (new - x[v])
            x[v] = new
            changed = True
    return x, ilp.evaluate(x)


def _ct_greedy(ilp, F, N):
    """Cell-tracking family greedy: per frame pick detections by reward
    respecting conflicts, cover flow with appearance/disappearance slack,
    then replace (e, a) pairs with cheaper transitions by best savings."""
    from bdd_tpu.ilp.model import Ineq

    V = ilp.nr_variables()
    name = [ilp.get_var_name(i) for i in range(V)]
    obj = ilp.objective_
    idx = {n: i for i, n in enumerate(name)}
    conf = {t: [] for t in range(F)}
    for c in ilp.constraints_:
        vs = [m[0] for m in c.monomials]
        if (c.ineq == Ineq.LEQ and c.rhs == 1
                and all(name[v].startswith("d_") for v in vs)):
            conf[int(name[vs[0]].split("_")[1])].append(vs)
    x = [0] * V
    active = {t: [] for t in range(F)}
    for t in range(F):
        order = sorted(range(N), key=lambda i: obj[idx[f"d_{t}_{i}"]])
        for i in order:
            di = idx[f"d_{t}_{i}"]
            if obj[di] >= -0.41:  # cheaper than the a+e slack only
                continue
            if any(di in grp and any(x[g] for g in grp if g != di)
                   for grp in conf[t]):
                continue
            x[di] = 1
            active[t].append(i)
    for t in range(F):
        for i in active[t]:
            x[idx[f"a_{t}_{i}"]] = 1
            x[idx[f"e_{t}_{i}"]] = 1
    for t in range(F - 1):
        cands = []
        for i in active[t]:
            for j in active[t + 1]:
                vn = f"m_{t}_{i}_{j}"
                if vn in idx:
                    save = (obj[idx[f"e_{t}_{i}"]]
                            + obj[idx[f"a_{t + 1}_{j}"]] - obj[idx[vn]])
                    if save > 0:
                        cands.append((save, i, j, idx[vn]))
        cands.sort(reverse=True)
        used_i, used_j = set(), set()
        for save, i, j, vi in cands:
            if i in used_i or j in used_j:
                continue
            used_i.add(i)
            used_j.add(j)
            x[vi] = 1
            x[idx[f"e_{t}_{i}"]] = 0
            x[idx[f"a_{t + 1}_{j}"]] = 0
    return ilp.evaluate(x)


def _gm_greedy(ilp):
    """Graph-matching greedy: assign left nodes in order of best available
    (linear + realized quadratic) cost respecting right uniqueness (slack
    allowed), then set the product variables consistently."""
    V = ilp.nr_variables()
    name = [ilp.get_var_name(i) for i in range(V)]
    obj = ilp.objective_
    xvars = {}   # (i, j) -> var, j == "s" for slack
    qvars = []   # (i0, i1, j0, j1, var)
    for v, n in enumerate(name):
        p = n.split("_")
        if p[0] == "x":
            xvars[(p[1], p[2])] = v
        elif p[0] == "q":
            qvars.append((p[1], p[2], p[3], p[4], v))
    lefts = sorted({i for (i, j) in xvars if i != "s"}, key=int)
    labels = {i: [j for (ii, j) in xvars if ii == i] for i in lefts}
    qcost = {}
    for i0, i1, j0, j1, v in qvars:
        qcost.setdefault((i0, j0), []).append((i1, j1, obj[v]))
        qcost.setdefault((i1, j1), []).append((i0, j0, obj[v]))
    assign = {}
    used = set()
    x = [0] * V
    for i in lefts:
        best, bc = "s", obj[xvars[(i, "s")]] if (i, "s") in xvars else 0.0
        for j in labels[i]:
            if j != "s" and j in used:
                continue
            c = obj[xvars[(i, j)]]
            for (i2, j2, qc) in qcost.get((i, j), ()):
                if assign.get(i2) == j2:
                    c += qc
            if c < bc:
                best, bc = j, c
        assign[i] = best
        if best != "s":
            used.add(best)
        x[xvars[(i, best)]] = 1
    # slack vars for unassigned right nodes
    for (i, j), v in xvars.items():
        if i == "s" and j not in used:
            x[v] = 1

    def val(i, j):
        # truth of x_{i,j}: i == "s" means "right node j unassigned"
        # (right-side marginalization rows create q_s_* vars,
        # frontends/graph_matching.py:180-201); j == "s" means "left node i
        # unassigned" — both compare against the greedy assignment.
        if i == "s":
            return j not in used
        return assign.get(i) == j

    for i0, i1, j0, j1, v in qvars:
        x[v] = int(val(i0, j0) and val(i1, j1))
    return ilp.evaluate(x)


def greedy_baseline(name, ilp):
    """Independent family heuristic upper bound (None if not implemented).
    Call with a FRESH instance (pre-normalization variable names)."""
    if name == "ct30x40":
        return _ct_greedy(ilp, 30, 40)
    if name.startswith("gm"):
        return _gm_greedy(ilp)
    if not name.startswith("setcover"):
        return None
    import numpy as np

    V = ilp.nr_variables()
    obj = np.array(ilp.objective_[:V])
    members = [[] for _ in range(V)]
    for ci, c in enumerate(ilp.constraints_):
        for coef, m in zip(c.coefficients, c.monomials):
            members[m[0]].append(ci)
    nc = len(ilp.constraints_)
    covered = [False] * nc
    ncov = 0
    x = [0] * V
    while ncov < nc:
        best, bs = None, -1.0
        for v in range(V):
            if x[v]:
                continue
            gain = sum(1 for ci in members[v] if not covered[ci])
            if gain == 0:
                continue
            score = gain / max(obj[v], 1e-9)
            if score > bs:
                bs, best = score, v
        if best is None:
            break
        x[best] = 1
        for ci in members[best]:
            if not covered[ci]:
                covered[ci] = True
                ncov += 1
    # polish the greedy too (drop redundant sets)
    x, val = one_opt_improve(ilp, x)
    return val


def certified_bound(name, build):
    """f64-evaluated CONVERGED dual bound (the certificate):
    native f64 long run; the families where plain MMA plateaus far from the
    optimum (GM / CT / set cover) get a device L-BFGS
    polish first, transferred exactly into the native f64 state
    (extras.transfer_costs_to_native — the f32->f64 escalation path)."""
    import numpy as np

    from bdd_tpu import native
    from bdd_tpu.bdd.preprocessor import BddPreprocessor

    ilp = build()
    ilp.reorder_bfs()
    ilp.normalize()
    pre = BddPreprocessor(ilp)
    V = pre.total_nr_variables()
    obj = pre.objective_vector()
    cs = native.cpu_solver_from_collection(pre.collection, V, obj)
    if name.startswith(("gm", "ct", "setcover")):
        from bdd_tpu.solver.extras import transfer_costs_to_native
        from bdd_tpu.solver.lbfgs import LbfgsSolver
        from bdd_tpu.solver.uniform_wrapper import UniformSolver

        us = UniformSolver(pre.collection, V, obj,
                           nr_primal_vars=pre.nr_primal_variables)
        ls = LbfgsSolver(us)
        prev = -np.inf
        for it in range(800):
            ls.iteration()
            if (it + 1) % 50 == 0:
                lb = us.lower_bound_with_deferred()
                if abs(lb - prev) <= 1e-9 * max(1.0, abs(lb)):
                    break
                prev = lb
        transfer_costs_to_native(us.host, us.state, cs)
    cs.iterations(5000, 0.5)
    return cs.lower_bound_with_deferred()


def exact_rows(fast: bool, only):
    """Companion rows with an EXACT certificate at sizes where it closes
    the same solve+round pipeline, gap measured against a
    true optimum — brute force (set cover), full BDD meld (MIS), or the
    solve_easy_variables-reduced core solved exhaustively (cell tracking,
    the reference's FastDOG+Gurobi hybrid with the framework-native exact
    hook instead)."""
    import numpy as np

    from bdd_tpu.bdd.preprocessor import BddPreprocessor
    from bdd_tpu.solver.extras import (
        exact_min_bruteforce,
        exact_min_via_meld,
        solve_easy_variables,
    )
    from bdd_tpu.utils.problems import independent_set

    def exact_setcover(build):
        return exact_min_bruteforce(build())

    def exact_meld(build):
        ilp = build()
        ilp.reorder_bfs()
        ilp.normalize()
        pre = BddPreprocessor(ilp)
        res = exact_min_via_meld(pre.collection, pre.objective_vector())
        if res is None:
            return None
        opt, x = res
        # evaluate on the SAME (reordered) model the meld was built from —
        # x is in bfs-permuted variable order; objective values are
        # order-invariant so the pipeline comparison is apples-to-apples
        return (
            float(ilp.evaluate([int(v) for v in x[: ilp.nr_variables()]])),
            x,
        )

    def exact_ct_core(build):
        """Converge the dual, fix strongly-agreeing variables, brute-force
        the residual core: optimum CONDITIONAL on the fixations (certified
        exact when it meets the converged dual bound below)."""
        from bdd_tpu.solver.lbfgs import LbfgsSolver
        from bdd_tpu.solver.run import run_solver
        from bdd_tpu.solver.uniform_wrapper import UniformSolver

        ilp = build()
        ilp.normalize()
        pre = BddPreprocessor(ilp)
        us = UniformSolver(
            pre.collection, pre.total_nr_variables(),
            pre.objective_vector(), nr_primal_vars=pre.nr_primal_variables,
        )
        run_solver(us, max_iter=2000, verbose=False, block_size=25)
        ls = LbfgsSolver(us)
        for _ in range(300):
            ls.iteration()
        lb_conv = us.lower_bound_with_deferred()
        for margin in (1e-3, 1e-2, 0.05, 0.12, 0.25):
            _fix, core = solve_easy_variables(us, ilp, margin=margin)
            if core.nr_variables() <= 24:
                break
        if core.nr_variables() > 24:
            return None
        res = exact_min_bruteforce(core)
        if res is None:
            return None
        # the core optimum is conditional on the fixations (>= true opt);
        # it is CERTIFIED exact only when it sandwiches against the
        # converged dual bound: core_opt >= opt >= lb_conv
        core_opt = res[0]
        if core_opt - lb_conv > 1e-4 * max(1.0, abs(lb_conv)):
            print(f"#   ct core opt {core_opt:.4f} does not meet the dual "
                  f"bound {lb_conv:.4f}; certificate void", flush=True)
            return None
        return core_opt, None

    rows = []
    companions = [
        ("setcover22-exact",
         lambda: set_cover(40, 22, density=0.3, seed=0),  # 22 sets = 22 vars
         "best", exact_setcover),
        ("mis40-exact",
         lambda: independent_set(40, edge_prob=0.2, seed=0),
         "incremental", exact_meld),
        # largest CT whose full conjunction melds within the node cap
        # (169 vars; ct6x8 at 277 vars exceeds it) — the certified-exact
        # size for this family
        ("ct5x6-exact", lambda: cell_tracking(5, 6, seed=0),
         "best", exact_meld),
        # the reference's FastDOG+exact hybrid pattern: converge, fix
        # agreeing variables, solve the residual core exhaustively;
        # certified only when the conditional optimum meets the dual bound
        ("ct6x8-core-exact", lambda: cell_tracking(6, 8, seed=0),
         "best", exact_ct_core),
    ]
    for name, build, rmethod, exact_fn in companions:
        if only and name not in only:
            continue
        t0 = time.time()
        s = BddSolver({
            "relaxation solver": "uniform mma",
            "variable order": "bfs",
            "rounding method": rmethod,
            "termination criteria": {"maximum iterations": 2000,
                                     "time limit": 600},
        })
        s._ilp = build()
        res = s.solve(verbose=False)
        obj = res.get("objective")
        lb = res.get("lower_bound")
        ex = exact_fn(build)
        if ex is None or obj is None:
            rows.append({"family": name, "verdict": "NO-CERTIFICATE",
                         "objective": obj, "lb": lb})
            print(f"# {name}: exact certificate unavailable "
                  f"(obj={obj}, lb={lb})", flush=True)
            continue
        opt = ex[0]
        gap_exact = (obj - opt) / max(abs(opt), 1.0)
        ok = "PASS" if gap_exact <= 0.05 else "FAIL"
        rows.append({
            "family": name, "lb": lb, "objective": obj, "exact_opt": opt,
            "gap_vs_exact_pct": round(gap_exact * 100, 3),
            "wall_s": round(time.time() - t0, 1), "verdict": ok,
        })
        print(
            f"# {name}: lb={lb:.4f} obj={obj:.4f} EXACT opt={opt:.4f} "
            f"gap-vs-exact={gap_exact*100:.2f}% ({time.time()-t0:.1f}s) "
            f"-> {ok}",
            flush=True,
        )
    return rows


def main() -> int:
    args = sys.argv[1:]
    fast = "fast" in args
    only = [a for a in args if a != "fast"]
    rows = []
    for name, build, solver, iters, rmethod in families(fast):
        if only and name not in only:
            continue
        t0 = time.time()
        ilp = build()
        cfg = {
            "relaxation solver": solver,
            "variable order": "bfs",
            "rounding method": rmethod,
            "termination criteria": {
                "maximum iterations": iters // (2 if fast else 1),
                "time limit": 1200,
            },
        }
        s = BddSolver(cfg)
        s._ilp = ilp
        t_build = time.time() - t0
        t0 = time.time()
        res = s.solve(verbose=False)
        t_solve = time.time() - t0
        lb = res.get("lower_bound")
        obj = res.get("objective")
        if obj is None:
            rows.append(
                {"family": name, "lb": lb, "objective": None,
                 "gap_pct": None, "wall_s": round(t_solve, 1),
                 "verdict": "NO-SOLUTION"}
            )
            print(f"# {name}: lb={lb:.4f} NO integral solution found "
                  f"({t_solve:.1f}s)", flush=True)
            continue
        gap = (obj - lb) / max(abs(obj), 1.0)
        # CERTIFIED gap: vs the converged f64 dual bound (always >= lb of
        # the truncated run, so this gap is <= the raw one and certified)
        t0 = time.time()
        # the pipeline's own final bound is also a valid certificate — use
        # whichever converged further (the separate certify run can stop
        # short on families where L-BFGS needs per-iteration syncs)
        lb_star = max(certified_bound(name, build), lb)
        t_cert = time.time() - t0
        cgap = (obj - lb_star) / max(abs(obj), 1.0)
        # independent quality certificates for loose generated families
        sol = [int(res["solution"][ilp.get_var_name(i)])
               for i in range(ilp.nr_variables())]
        _, obj_1opt = one_opt_improve(ilp, sol)
        greedy = greedy_baseline(name, build())  # fresh pre-normalize copy
        one_opt_slack = (obj - obj_1opt) / max(abs(obj), 1.0)
        if cgap <= 0.05:
            ok = "PASS"
        elif one_opt_slack < 0.01 and (greedy is None or obj <= greedy):
            ok = "PASS*"  # beats the greedy baseline and is ~1-opt-optimal:
            # the residual certified gap bounds the instance's own
            # integrality gap plus any rounding slack
        else:
            ok = "FAIL"
        rows.append(
            {"family": name, "lb": lb, "objective": obj,
             "gap_pct": round(gap * 100, 3),
             "lb_star": lb_star,
             "certified_gap_pct": round(cgap * 100, 3),
             "one_opt_obj": obj_1opt,
             "greedy_obj": greedy,
             "wall_s": round(t_solve, 1), "verdict": ok}
        )
        print(
            f"# {name}: lb={lb:.4f} lb*={lb_star:.4f} obj={obj:.4f} "
            f"gap={gap*100:.2f}% CERTIFIED gap={cgap*100:.2f}% "
            f"1opt={obj_1opt:.4f} greedy={greedy} "
            f"build={t_build:.1f}s solve+round={t_solve:.1f}s "
            f"certify={t_cert:.1f}s "
            f"dual_iters={res.get('iterations')} -> {ok}",
            flush=True,
        )
    rows += exact_rows(fast, only)
    print("RESULT " + json.dumps(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
