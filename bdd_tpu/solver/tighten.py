"""Cut tightening: intersect BDD groups around variables with vanishing
min-marginal differences.

Semantics of the reference's (experimental) include/bdd_tightening.h:168+:
after the dual has converged, variables whose aggregated min-marginal
difference is ~0 witness the relaxation's slack. BDDs containing such tight
variables are grouped by connected components over shared tight variables and
each group is melded (bdd_and) into one stronger subproblem; the group
members' Lagrange costs are summed per variable onto the melded BDD, so the
dual bound never decreases. Re-running MMA on the tightened collection can
close integrality gaps that no amount of dual iteration can.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bdd_tpu.bdd.collection import TOP, BddCollection


class _UnionFind:
    def __init__(self, n: int) -> None:
        self.p = list(range(n))

    def find(self, x: int) -> int:
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[ra] = rb


def tight_variables(flat_view, m0: np.ndarray, m1: np.ndarray, eps: float = 1e-6):
    """Variables whose summed mm difference magnitude is <= eps."""
    valid = flat_view.valid_layer_mask()
    v = flat_view.layer_var[valid]
    with np.errstate(invalid="ignore"):
        d = m1[valid] - m0[valid]
        # forced variables (infinite one-sided marginals) are the OPPOSITE
        # of tight — map to a huge finite magnitude, not 0
        d = np.where(
            np.isfinite(d), d, np.where(np.isfinite(m0[valid]), 1e9, -1e9)
        )
    sums = np.zeros(flat_view.nr_vars)
    np.add.at(sums, v, d)
    return np.nonzero(np.abs(sums) <= eps)[0]


def _conflict_graph(
    collection: BddCollection, tight: Optional[set]
) -> Tuple[Dict[Tuple[int, int], int], Dict[int, set]]:
    """The pairwise-conflict graph: an edge (u, v) per BDD that is
    structurally the at-most-1 constraint over exactly {u, v} (3 solutions,
    both-ones excluded), restricted to tight variables when given."""
    edge_bdd: Dict[Tuple[int, int], int] = {}
    adj: Dict[int, set] = {}
    for b in range(collection.nr_bdds()):
        vs = collection.variables(b)
        if len(vs) != 2:
            continue
        u, v = int(vs[0]), int(vs[1])
        if tight is not None and (u not in tight or v not in tight):
            continue
        if collection.nr_solutions(b) != 3:
            continue
        if collection.nr_solutions(b, positive_variables=[u, v]) != 0:
            continue
        e = (u, v) if u < v else (v, u)
        if e in edge_bdd:
            continue
        edge_bdd[e] = b
        adj.setdefault(u, set()).add(v)
        adj.setdefault(v, set()).add(u)
    return edge_bdd, adj


def conflict_odd_cycles(
    collection: BddCollection,
    tight_vars: Optional[Sequence[int]] = None,
    max_len: int = 7,
    used_edges: Optional[set] = None,
) -> Tuple[List[List[int]], set]:
    """Odd-cycle groups (length 5..max_len) in the pairwise-conflict graph.

    A chord-free odd cycle C of length k melds its k edge BDDs into the
    exact cycle polytope, whose Lagrange subproblem carries the odd-cycle
    inequality sum <= (k-1)/2 — the facet class BEYOND cliques (a triangle
    IS a 3-clique; this finds k >= 5). Shortest odd cycle through each
    vertex via BFS on the bipartite double cover ((v, parity) states: the
    shortest (s,0)->(s,1) walk is the shortest odd closed walk through s);
    non-simple walks are discarded, edges are used at most once (and not
    reused from ``used_edges`` — pass the clique pass's edge set to stack
    both separations). Returns (groups, used_edges_updated)."""
    tight = None if tight_vars is None else set(int(v) for v in tight_vars)
    edge_bdd, adj = _conflict_graph(collection, tight)
    used: set = set(used_edges or ())
    groups: List[List[int]] = []
    from collections import deque

    for s in sorted(adj):
        # BFS over (vertex, parity), depth-bounded by max_len
        start = (s, 0)
        parent: Dict[Tuple[int, int], Tuple[int, int]] = {start: start}
        depth = {start: 0}
        q = deque([start])
        found = None
        while q and found is None:
            node = q.popleft()
            v, p = node
            if depth[node] >= max_len:
                break
            for w in adj[v]:
                nxt = (w, 1 - p)
                if nxt in parent:
                    continue
                parent[nxt] = node
                depth[nxt] = depth[node] + 1
                if nxt == (s, 1):
                    found = nxt
                    break
                q.append(nxt)
        if found is None:
            continue
        # reconstruct the closed odd walk: (s,1) back to (s,0); the (s,1)
        # endpoint contributes s itself, so the collected vertices are
        # exactly the cycle (s appears once)
        walk = []
        node = found
        while node != start:
            walk.append(node[0])
            node = parent[node]
        cyc = walk[::-1]  # cycle vertices in order, wraparound implicit
        k = len(cyc)
        if k < 5 or k % 2 == 0:
            continue  # triangles belong to the clique pass
        if len(set(cyc)) != k:
            continue  # non-simple shortest odd walk — skip
        edges = []
        ok = True
        for i in range(k):
            a, b2 = cyc[i], cyc[(i + 1) % k]
            e = (a, b2) if a < b2 else (b2, a)
            if e in used or e not in edge_bdd:
                ok = False
                break
            edges.append(e)
        if not ok:
            continue
        used.update(edges)
        groups.append([edge_bdd[e] for e in edges])
    return groups, used


def conflict_cliques(
    collection: BddCollection,
    tight_vars: Optional[Sequence[int]] = None,
    max_clique: int = 8,
    used_edges: Optional[set] = None,
) -> Tuple[List[List[int]], set]:
    """Clique groups in the pairwise-conflict graph (MIS-style models).

    On MIS relaxations every edge constraint ``x_u + x_v <= 1`` is its own
    BDD and the LP optimum is the all-half fractional point where EVERY
    variable is tight — the generic shares-a-tight-variable clusters then
    meld arbitrary edge bags whose conjunctions rarely cut that point
    (measured: ~1% of the gap). A clique
    ``{v_1..v_k}``, k >= 3, melds its C(k,2) edge BDDs into the
    facet-defining ``sum <= 1`` (Padberg's clique inequality), which the
    fractional point violates by k/2 - 1. This finds edge-disjoint greedy
    cliques: per unused edge (u, v), grow from the common neighborhood by
    max-connectivity; accept at size >= 3. Only BDDs that ARE pairwise
    at-most-1 constraints participate (structural check via nr_solutions).

    Returns ``(groups, used_edges_updated)`` — explicit meld groups for
    ``tighten_collection(groups=...)`` plus the consumed edge set (same
    copy-and-return contract as ``conflict_odd_cycles``; the caller's set
    is never mutated).
    (ref: bdd_tightening.h's variable-grouping heuristic has no clique
    notion — this is a strengthening the BDD meld machinery makes cheap.)
    """
    tight = None if tight_vars is None else set(int(v) for v in tight_vars)
    edge_bdd, adj = _conflict_graph(collection, tight)
    used: set = set(used_edges or ())
    groups: List[List[int]] = []
    for (u, v) in sorted(edge_bdd):
        if (u, v) in used:
            continue
        cand = adj[u] & adj[v]
        clique = [u, v]
        cset = set(clique)
        while cand and len(clique) < max_clique:
            # max connectivity into the remaining candidates (deterministic
            # tie-break by id)
            w = max(cand, key=lambda x: (len(adj[x] & cand), -x))
            clique.append(w)
            cset.add(w)
            cand = cand & adj[w]
        if len(clique) < 3:
            continue
        edges = [
            (a, b2) if a < b2 else (b2, a)
            for i, a in enumerate(clique)
            for b2 in clique[i + 1 :]
        ]
        if any(e in used for e in edges):
            continue  # edge-disjoint cliques: each BDD melds once
        used.update(edges)
        groups.append([edge_bdd[e] for e in edges])
    return groups, used


def conflict_cuts(
    collection: BddCollection,
    tight_vars: Optional[Sequence[int]] = None,
    cliques: bool = True,
    odd_cycles: bool = True,
    max_clique: int = 8,
    max_cycle_len: int = 7,
) -> List[List[int]]:
    """Combined conflict-graph separation: clique facets first, then odd
    cycles over the edges no clique consumed (both edge-disjoint)."""
    groups: List[List[int]] = []
    used: set = set()
    if cliques:
        grp, used = conflict_cliques(
            collection, tight_vars, max_clique, used_edges=used
        )
        groups += grp
    if odd_cycles:
        cyc, used = conflict_odd_cycles(
            collection, tight_vars, max_cycle_len, used_edges=used
        )
        groups += cyc
    return groups


def tighten_collection(
    collection: BddCollection,
    tight_vars: Sequence[int],
    layer_costs: Optional[Dict[Tuple[int, int], Tuple[float, float]]] = None,
    max_group_size: int = 8,
    node_limit: int = 100000,
    explicit_groups: Optional[List[List[int]]] = None,
):
    """Meld groups of BDDs sharing tight variables.

    Returns (new_collection, new_layer_costs, groups) where groups maps each
    new bdd nr to the list of source bdd nrs. Groups whose meld would exceed
    ``node_limit`` nodes or ``max_group_size`` members fall back to keeping
    the members separate (the reference likewise bounds intersection size).

    ``explicit_groups``: bypass the tight-variable clustering and meld these
    exact BDD groups instead (the clique-cut path, ``conflict_cliques``).
    """
    tight = set(int(v) for v in tight_vars)
    nb = collection.nr_bdds()
    if explicit_groups is not None:
        groups = {
            gid: list(members)
            for gid, members in enumerate(explicit_groups)
        }
        max_group_size = max(
            [max_group_size] + [len(m) for m in groups.values()]
        )
        return _meld_groups(
            collection, groups, layer_costs, max_group_size, node_limit
        )
    uf = _UnionFind(nb)
    owner: Dict[int, int] = {}
    candidate = [False] * nb
    for b in range(nb):
        vs = [v for v in collection.variables(b) if v in tight]
        if not vs:
            continue
        candidate[b] = True
        for v in vs:
            if v in owner:
                uf.union(owner[v], b)
            else:
                owner[v] = b

    components: Dict[int, List[int]] = {}
    for b in range(nb):
        if candidate[b]:
            components.setdefault(uf.find(b), []).append(b)

    # Oversized components (e.g. every variable tight at an LP-optimal MIS
    # fractional point: ONE component spanning all constraints) are
    # partitioned into BFS clusters of <= max_group_size over the
    # shares-a-tight-variable adjacency, instead of being rejected outright —
    # melding neighborhoods is what closes local (odd-cycle-like) gaps.
    var_bdds: Dict[int, List[int]] = {}
    for b in range(nb):
        if candidate[b]:
            for v in collection.variables(b):
                if v in tight:
                    var_bdds.setdefault(v, []).append(b)
    groups: Dict[int, List[int]] = {}
    visited: set = set()
    gid = 0
    for root, members in components.items():
        if len(members) <= max_group_size:
            groups[gid] = members
            gid += 1
            continue
        mset = set(members)
        for start in members:
            if start in visited:
                continue
            cluster = [start]
            visited.add(start)
            frontier = [start]
            while frontier and len(cluster) < max_group_size:
                nxt: List[int] = []
                for b in frontier:
                    for v in collection.variables(b):
                        if v not in tight:
                            continue
                        for b2 in var_bdds.get(v, ()):  # neighbors
                            if b2 in mset and b2 not in visited:
                                visited.add(b2)
                                cluster.append(b2)
                                nxt.append(b2)
                                if len(cluster) >= max_group_size:
                                    break
                        if len(cluster) >= max_group_size:
                            break
                    if len(cluster) >= max_group_size:
                        break
                frontier = nxt
            groups[gid] = cluster
            gid += 1

    return _meld_groups(
        collection, groups, layer_costs, max_group_size, node_limit
    )


def _meld_groups(
    collection: BddCollection,
    groups: Dict[int, List[int]],
    layer_costs,
    max_group_size: int,
    node_limit: int,
):
    nb = collection.nr_bdds()
    # groups must be disjoint: a BDD melded into two groups would have its
    # transferred layer costs counted twice (the separators guarantee this
    # via edge-disjointness; guard against future composed callers)
    _all = [b for members in groups.values() for b in members]
    assert len(_all) == len(set(_all)), "meld groups must be disjoint"
    out = BddCollection()
    out_costs: Dict[Tuple[int, int], Tuple[float, float]] = {}
    group_of_new: Dict[int, List[int]] = {}
    merged: set = set()

    def copy_bdd(b: int) -> int:
        nb_new = out.add_bdd(collection.local_nodes(b))
        if layer_costs is not None:
            for v in collection.level_variables(b):
                out_costs[(nb_new, v)] = layer_costs.get((b, v), (0.0, 0.0))
        return nb_new

    for root, members in groups.items():
        if len(members) < 2 or len(members) > max_group_size:
            continue
        size_bound = 1
        for b in members:
            size_bound *= max(collection.nr_bdd_nodes(b), 1)
        if size_bound > node_limit * 100:
            continue  # product construction itself could blow up
        # meld into a SCRATCH collection; only the quasi-reduced result is
        # appended to `out` (no O(groups^2) rebuilds on reject/accept)
        scratch = BddCollection()
        try:
            melded = collection.bdd_and(members, scratch)
        except ValueError:
            continue  # unsat/trivial conjunction: leave members separate
        if scratch.nr_bdd_nodes(melded) > node_limit:
            continue  # too big: keep members separate
        new_nr = scratch.make_qbdd(melded, out)
        group_of_new[new_nr] = list(members)
        merged.update(members)
        covered = set(out.level_variables(new_nr))
        union_vars = set()
        for b in members:
            union_vars.update(collection.variables(b))
        if layer_costs is not None:
            for v in sorted(union_vars):
                lo_sum = 0.0
                hi_sum = 0.0
                for b in members:
                    c = layer_costs.get((b, v))
                    if c is not None:
                        lo_sum += c[0]
                        hi_sum += c[1]
                if v in covered:
                    out_costs[(new_nr, v)] = (lo_sum, hi_sum)
                elif lo_sum != 0.0 or hi_sum != 0.0:
                    # the product eliminated v (don't-care in the
                    # conjunction) — its Lagrange costs must stay in the
                    # decomposition: carry them on a free single-variable
                    # BDD, otherwise the objective silently changes
                    free_nr = out.add_bdd([(v, TOP, TOP)])
                    out_costs[(free_nr, v)] = (lo_sum, hi_sum)
                    group_of_new[free_nr] = []
        else:
            for v in sorted(union_vars - covered):
                # keep eliminated variables represented so an objective
                # redistribution over the new collection still covers them
                free_nr = out.add_bdd([(v, TOP, TOP)])
                group_of_new[free_nr] = []

    for b in range(nb):
        if b not in merged:
            new_nr = copy_bdd(b)
            group_of_new[new_nr] = [b]

    return out, (out_costs if layer_costs is not None else None), group_of_new


def tighten_and_resolve(
    pre,
    solver_cls_kwargs: Optional[dict] = None,
    eps: float = 1e-6,
    warm_start: bool = True,
    cliques: bool = False,
):
    """Convenience driver: take a preprocessor whose collection was solved to
    (near) dual optimality by a UniformSolver, tighten, and return a
    UniformSolver over the melded collection.

    ``warm_start`` (default, the reference's scheme — bdd_tightening.h
    transfers the converged Lagrange costs onto the melded BDDs): the new
    solver starts FROM the converged duals (melded layers carry the members'
    summed costs), so its initial bound equals the pre-meld converged bound
    and every iteration only improves it. A cold restart was measured
    NET-NEGATIVE at equal iterations on QAP (-8.6% gap) — the
    re-solve spent its whole budget re-deriving the pre-meld bound."""
    from bdd_tpu.solver.uniform_wrapper import UniformSolver

    kwargs = solver_cls_kwargs or {}
    base = UniformSolver(
        pre.collection,
        pre.total_nr_variables(),
        pre.objective_vector(),
        nr_primal_vars=pre.nr_primal_variables,
        **kwargs,
    )
    from bdd_tpu.solver.run import run_solver

    run_solver(base, max_iter=500, verbose=False, block_size=base.default_block_size)
    base.distribute_delta()
    m0, m1 = base.min_marginals()
    tv = tight_variables(base.f, m0, m1, eps)
    costs = base.export_layer_costs() if warm_start else None
    explicit = None
    if cliques:
        # conflict-graph separation (``conflict_cuts``): meld each clique's
        # C(k,2) edge BDDs into the facet sum <= 1, then odd cycles (k >= 5)
        # over the remaining edges; fall back to the generic tight-variable
        # clusters when the model has no pairwise-conflict structure
        explicit = conflict_cuts(pre.collection, tv) or None
    new_col, new_costs, groups = tighten_collection(
        pre.collection, tv, layer_costs=costs, explicit_groups=explicit
    )
    tightened = UniformSolver(
        new_col,
        pre.total_nr_variables(),
        pre.objective_vector(),
        nr_primal_vars=pre.nr_primal_variables,
        layer_costs=new_costs,
        **kwargs,
    )
    return tightened, groups
