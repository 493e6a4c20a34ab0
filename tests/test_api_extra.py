"""Additional API coverage: OPB end-to-end, native fallback, config handling."""
import json

import pytest

from bdd_tpu.api import BddSolver
from tests import fixtures


def test_opb_end_to_end(tmp_path):
    opb = "min: 2 x1 + 1 x2 + 3 x3;\n1 x1 + 1 x2 + 1 x3 >= 2;\n"
    p = tmp_path / "prob.opb"
    p.write_text(opb)
    s = BddSolver({"relaxation solver": "ref mma"})
    s.read_ilp(path=str(p))
    r = s.solve(verbose=False)
    assert r["status"] == "solved"
    assert r["objective"] == pytest.approx(3.0)  # x1 + x2


def test_native_path_used_for_lp(tmp_path):
    lp = fixtures.MATCHING_3x3
    s = BddSolver(
        {
            "relaxation solver": "uniform mma",
            "variable order": "bfs",
            "termination criteria": {"maximum iterations": 200},
        }
    )
    s.read_ilp(lp_string=lp)
    r = s.solve(verbose=False)
    assert r["status"] == "solved"
    # native path attaches the NativeHost
    assert getattr(s, "_native", None) is not None
    assert r["objective"] == pytest.approx(-6.0)


def test_native_path_handles_nonlinear():
    # nonlinear instances take the native pipeline too (C++ Fortet
    # linearization, native/bdd_host.cpp linearize_nonlinear)
    lp = """Minimize
-2 x - 2 y + 3 z
Subject To
x + y <= 2
x*y - z <= 0
End"""
    s = BddSolver(
        {
            "relaxation solver": "uniform mma",
            "termination criteria": {"maximum iterations": 300},
        }
    )
    s.read_ilp(lp_string=lp)
    r = s.solve(verbose=False)
    assert r["status"] == "solved"
    opt, _ = fixtures.brute_force_ilp_optimum(s.ilp)
    assert r["lower_bound"] <= opt + 1e-5
    assert r["objective"] == pytest.approx(opt, abs=1e-6)


def test_cli_config_file(tmp_path, capsys):
    from bdd_tpu.api import main

    lp = tmp_path / "m.lp"
    lp.write_text(fixtures.COVERING)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(
        json.dumps(
            {
                "input": str(lp),
                "relaxation solver": "ref mma",
                "termination criteria": {"maximum iterations": 200},
            }
        )
    )
    assert main([str(cfg)]) == 0
    out = capsys.readouterr().out
    assert "lower_bound" in out


def test_converter_cli(tmp_path, capsys):
    from bdd_tpu.ilp.__main__ import main

    lp = tmp_path / "m.lp"
    lp.write_text("Minimize\nx + y\nSubject To\nx + y >= 1\nEnd")
    assert main(["lp2opb", str(lp)]) == 0
    assert "min:" in capsys.readouterr().out
    assert main(["lp2mps", str(lp)]) == 0
    assert "ENDATA" in capsys.readouterr().out

def test_export_phases_and_statistics(tmp_path, capsys):
    """Reference export/statistics pipeline phases (bdd_solver.cpp:382-466):
    'export lp', 'export bdd lp', 'export bdd graph', 'print statistics'."""
    s = BddSolver(
        {
            "relaxation solver": "ref mma",
            "print statistics": True,
            "export lp": str(tmp_path / "out.opb"),
            "export bdd lp": str(tmp_path / "bdd.lp"),
            "export bdd graph": str(tmp_path / "g.dot"),
            "termination criteria": {"maximum iterations": 20},
            "perturbation rounding": False,
        }
    )
    s.read_ilp(lp_string=fixtures.COVERING)
    r = s.solve(verbose=False)
    assert r["status"] == "solved"
    assert (tmp_path / "out.opb").read_text().startswith("min:")
    assert "Minimize" in (tmp_path / "bdd.lp").read_text()
    dots = list(tmp_path.glob("g_*.dot"))
    assert len(dots) == s.pre.collection.nr_bdds()
    assert "digraph" in dots[0].read_text()
    out = capsys.readouterr().out
    assert "[print_statistics] #BDDs" in out


def test_solver_level_queries_and_difficult_core(tmp_path):
    """bdd_solver.h:92-97 surface: lower_bound, min_marginals (+names),
    fix_variable, export_difficult_core."""
    import math

    s = BddSolver(
        {
            "relaxation solver": "ref mma",
            "variable order": "bfs",
            "termination criteria": {"maximum iterations": 200},
            "perturbation rounding": False,
        }
    )
    s.read_ilp(lp_string=fixtures.MATCHING_3x3)
    r = s.solve(verbose=False)
    lb = s.lower_bound()
    assert lb == pytest.approx(r["lower_bound"])
    s.solver.distribute_delta()
    mms = s.min_marginals()
    n = s.ilp.nr_variables()
    assert len(mms) >= n
    # each variable has one (m0, m1) row per BDD containing it
    import numpy as np
    for v in range(n):
        assert mms[v].shape[1] == 2
        assert np.all(np.isfinite(mms[v]))
    names, lo, hi = s.min_marginals_with_variable_names()
    assert len(names) == len(lo) == len(hi) == sum(
        mms_v.shape[0] for mms_v in s.min_marginals(original_order=False)[:n]
    )
    # at the converged matching optimum every name appears per its BDD count
    assert set(names) <= {s.ilp.get_var_name(i) for i in range(n)}
    # difficult core: at a converged LP-tight optimum most variables are
    # decided, so the core shrinks
    core = s.export_difficult_core(str(tmp_path / "core.lp"), threshold=1e-4)
    assert core.nr_variables() <= n
    assert (tmp_path / "core.lp").read_text().startswith("Minimize")
    # fix a variable and re-solve: bound stays finite and >= previous
    s.fix_variable(s.ilp.get_var_name(0), 0)
    for _ in range(50):
        s.solver.iteration()
    lb2 = s.solver.lower_bound()
    assert math.isfinite(lb2) and lb2 >= lb - 1e-4


def test_split_bdds_reference_spelling():
    """'split bdds': {'split length': N, 'implication bdd': b} maps onto the
    chunking keys (ref bdd_solver.cpp:108-120)."""
    s = BddSolver({"split bdds": {"split length": 64,
                                  "implication bdd": True}})
    assert s.config["split chunk size"] == 64
    assert s.config["split implication"] is True
    s2 = BddSolver({"split bdds": {}})
    assert s2.config["split chunk size"] == "auto"


def test_solve_batch_serving():
    """Batched serving: K independent ILPs as one device program with
    per-instance bounds/solutions; infeasible members flagged."""
    from bdd_tpu.ilp import parse_lp_string

    lp_feasible = fixtures.COVERING
    lp_matching = fixtures.MATCHING_3x3
    lp_infeasible = """Minimize
x + y
Subject To
x + y >= 1
x + y <= 0
End"""
    ilps = [parse_lp_string(t) for t in
            (lp_feasible, lp_matching, lp_infeasible)]
    opts = [fixtures.brute_force_ilp_optimum(ilps[0])[0],
            fixtures.brute_force_ilp_optimum(ilps[1])[0]]
    s = BddSolver({"termination criteria": {"maximum iterations": 300}})
    res = s.solve_batch(ilps=ilps, verbose=False)
    assert len(res) == 3
    assert res[2]["status"] == "infeasible"
    for k in (0, 1):
        assert res[k]["status"] == "solved"
        # per-instance dual bound is a valid lower bound (weak duality)
        assert res[k]["lower_bound"] <= opts[k] + 1e-4


def test_solve_batch_rounds_feasible():
    """Without an infeasible member, batched rounding recovers per-instance
    optimal solutions on LP-tight instances."""
    from bdd_tpu.ilp import parse_lp_string

    ilps = [parse_lp_string(fixtures.COVERING),
            parse_lp_string(fixtures.MATCHING_3x3)]
    opts = [fixtures.brute_force_ilp_optimum(i)[0] for i in ilps]
    s = BddSolver({"termination criteria": {"maximum iterations": 300}})
    res = s.solve_batch(ilps=ilps, verbose=False)
    for k in (0, 1):
        assert res[k]["status"] == "solved"
        assert "objective" in res[k]
        assert res[k]["objective"] == pytest.approx(opts[k], abs=1e-6)


def test_serve_jsonl_loop(tmp_path):
    """Persistent serving mode: JSONL request loop with per-request error
    isolation, batch requests, and shutdown."""
    import io

    from bdd_tpu.serve import serve

    lp = tmp_path / "p.lp"
    lp.write_text(fixtures.COVERING)
    reqs = [
        json.dumps({"input": str(lp), "relaxation solver": "ref mma",
                    "termination criteria": {"maximum iterations": 100}}),
        "this is not json",
        json.dumps({"input": str(tmp_path / "missing.lp")}),
        json.dumps({"inputs": [str(lp), str(lp)],
                    "termination criteria": {"maximum iterations": 100}}),
        json.dumps({"shutdown": True}),
        json.dumps({"input": str(lp)}),  # after shutdown: not served
    ]
    out = io.StringIO()
    n = serve(reqs, out)
    lines = [json.loads(l) for l in out.getvalue().splitlines()]
    # bad-json line answered but not counted as a served request; the
    # post-shutdown request is never served (no 6th line)
    assert n == 4 and len(lines) == 5
    assert lines[0]["status"] == "solved" and "wall_s" in lines[0]
    assert lines[1]["status"] == "error" and "bad json" in lines[1]["message"]
    assert lines[2]["status"] == "error"
    assert isinstance(lines[3], list) and len(lines[3]) == 2
    assert all(r["status"] == "solved" for r in lines[3])
    assert lines[4]["status"] == "bye"


def test_solve_batch_matches_individual_bounds():
    """Batching is exact: per-instance dual bounds from the batched program
    equal each instance solved alone (disjoint variable spaces — the exchange
    never mixes instances)."""
    import numpy as np

    from bdd_tpu.utils.problems import independent_set, set_cover

    ilps = [independent_set(25, edge_prob=0.15, seed=3),
            set_cover(15, 30, density=0.2, seed=4),
            independent_set(20, edge_prob=0.2, seed=5)]
    individual = []
    for ilp in ilps:
        s = BddSolver({"termination criteria": {"maximum iterations": 120},
                       "perturbation rounding": False,
                       "use native preprocessing": False})
        s.read_ilp(lp_string=ilp.write_lp())
        r = s.solve(verbose=False)
        individual.append(r["lower_bound"])
    sb = BddSolver({"termination criteria": {"maximum iterations": 120},
                    "perturbation rounding": False})
    res = sb.solve_batch(ilps=list(ilps), verbose=False)
    for k in range(3):
        assert res[k]["lower_bound"] == pytest.approx(
            individual[k], rel=2e-5, abs=2e-4)


def test_serve_non_object_request_isolated():
    """A valid-JSON but non-object request must not kill the server loop."""
    import io

    from bdd_tpu.serve import serve

    reqs = ["42", "[1, 2]", json.dumps({"shutdown": True})]
    out = io.StringIO()
    serve(reqs, out)
    lines = [json.loads(l) for l in out.getvalue().splitlines()]
    assert lines[0]["status"] == "error" and "object" in lines[0]["message"]
    assert lines[1]["status"] == "error"
    assert lines[2]["status"] == "bye"


def test_native_min_marginals_original_order():
    """With the native fast path + a reorder, min_marginals(original_order=
    True) permutes back using the native-recorded permutation and matches the
    python pipeline's result variable-for-variable."""
    import numpy as np

    lp = fixtures.MATCHING_3x3
    mms = {}
    for native in (True, False):
        s = BddSolver({
            "relaxation solver": "uniform mma",
            "variable order": "bfs",
            "use native preprocessing": native,
            "termination criteria": {"maximum iterations": 100},
            "perturbation rounding": False,
        })
        s.read_ilp(lp_string=lp)
        r = s.solve(verbose=False)
        assert r["status"] == "solved"
        if native:
            assert getattr(s, "_native", None) is not None
            assert s.var_perm is not None  # bh_var_order recorded the reorder
        s.solver.distribute_delta()
        mms[native] = s.min_marginals(original_order=True)
    for v in range(min(len(mms[True]), len(mms[False]))):
        a, b = mms[True][v], mms[False][v]
        assert a.shape == b.shape
        fa, fb = np.isfinite(a), np.isfinite(b)
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_allclose(a[fa], b[fb], atol=5e-4)


def test_native_path_for_frontend_ilps():
    """ILPs built by frontends/generators (no LP text) are serialized through
    write_lp so the C++ host pipeline handles them too; result matches the
    python pipeline."""
    from bdd_tpu.native import available
    from bdd_tpu.utils.problems import grid_mrf

    if not available():
        pytest.skip("native lib unavailable")
    results = {}
    for native in (True, False):
        s = BddSolver({
            "relaxation solver": "uniform mma",
            "use native preprocessing": native,
            "termination criteria": {"maximum iterations": 150},
            "perturbation rounding": False,
        })
        s.read_ilp(ilp=grid_mrf(4, 4, 2, seed=3))
        r = s.solve(verbose=False)
        if native:
            assert getattr(s, "_native", None) is not None
        results[native] = r["lower_bound"]
    assert results[True] == pytest.approx(results[False], rel=1e-5, abs=1e-4)


def test_serve_json_strict_and_empty_batch(tmp_path):
    """Serve output is RFC-8259-strict (no Infinity token for infeasible
    bounds) and an empty batch returns []."""
    import io

    from bdd_tpu.serve import serve

    lp = tmp_path / "inf.lp"
    lp.write_text("""Minimize
x + y
Subject To
x + y >= 1
x + y <= 0
End""")
    reqs = [
        json.dumps({"input": str(lp),
                    "termination criteria": {"maximum iterations": 10}}),
        json.dumps({"inputs": []}),
        json.dumps({"shutdown": True}),
    ]
    out = io.StringIO()
    serve(reqs, out)
    raw_lines = out.getvalue().splitlines()
    assert "Infinity" not in raw_lines[0]
    r0 = json.loads(raw_lines[0])
    assert r0["status"] == "infeasible" and r0["lower_bound"] == "inf"
    assert json.loads(raw_lines[1]) == []


def test_rounding_method_config():
    """'rounding method': wedelin / best — the reference implements Wedelin
    but never dispatches it (incremental_mm_agreement_rounding.hxx:160);
    here it is a config choice ('best' runs both from the same snapshot and
    keeps the better objective — measured 16% better on loose flow
    families)."""
    from bdd_tpu.api import BddSolver
    from bdd_tpu.utils.problems import cell_tracking

    objs = {}
    for method in ("incremental", "wedelin", "best"):
        s = BddSolver({
            "relaxation solver": "uniform mma",
            "termination criteria": {"maximum iterations": 300},
            "rounding method": method,
        })
        s._ilp = cell_tracking(6, 6, seed=3)
        res = s.solve(verbose=False)
        assert res["status"] == "solved"
        assert "objective" in res, method
        objs[method] = res["objective"]
    assert objs["best"] <= min(objs["incremental"], objs["wedelin"]) + 1e-6


def test_rounding_objective_bias():
    """'incremental biased': objective-tilted tie-breaking (rounding.py
    objective_tilt). On dense random graph matching the reference's
    symmetric coin flips collapse assignments to slack (gm120 obj -29.9
    vs greedy -49.1); the tilt re-injects
    the primal cost preference at EQUAL variables only. bias=0 must
    reproduce the reference semantics draw-for-draw."""
    import numpy as np

    from bdd_tpu.api import BddSolver
    from bdd_tpu.frontends.graph_matching import construct_graph_matching_ilp
    from bdd_tpu.solver.rounding import objective_tilt
    from bdd_tpu.utils.problems import graph_matching

    # tilt: sign follows the cost, clipped to [-1, 1], median-normalized
    t = objective_tilt([-2.0, 0.5, 0.0, 4.0], 5)
    assert t[0] == -1.0 and 0 < t[1] < 1 and t[2] == 0.0 and t[3] == 1.0
    assert t[4] == 0.0  # vars beyond the objective get no tilt

    def solve(method):
        inst = graph_matching(12, 12, seed=2, candidates=4, nr_quadratic=120)
        ilp = construct_graph_matching_ilp(inst)[0]
        s = BddSolver({
            "relaxation solver": "uniform mma",
            "termination criteria": {"maximum iterations": 300},
            "rounding method": method,
        })
        s._ilp = ilp
        return s.solve(verbose=False)

    res = solve("incremental biased")
    assert res["status"] == "solved"
    assert "objective" in res
    # feasible certificate: objective >= dual bound
    assert res["objective"] >= res["lower_bound"] - 1e-4
