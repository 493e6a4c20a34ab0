"""ILP data model.

Holds a 0-1 integer linear (or low-degree polynomial) program:
    min  c^T x + const
    s.t. for each constraint j:  sum_m coeff_{j,m} * prod_{v in monomial_{j,m}} x_v  (<=|>=|=)  rhs_j
    x binary.

Parity reference: include/ILP/ILP_input.h:15-133, src/ILP/ILP_input.cpp (data model,
normalization ILP_input.cpp:300-389, orderings ILP_input.cpp:604-688, reduce :508,
writers, evaluate/feasible ILP_input.h:147-199). Re-designed in Python; the ILP is
host-side preprocessing — its output feeds the flattened device arrays.
"""
from __future__ import annotations

import enum
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple


class Ineq(enum.Enum):
    LEQ = "<="
    GEQ = ">="
    EQ = "="


@dataclass
class Constraint:
    """One (possibly polynomial) constraint.

    ``monomials[m]`` is a tuple of variable indices whose product multiplies
    ``coefficients[m]``. Degree-1 monomials make the constraint linear.
    (ref: ILP_input.h:21-34)
    """

    coefficients: List[int] = field(default_factory=list)
    monomials: List[Tuple[int, ...]] = field(default_factory=list)
    ineq: Ineq = Ineq.LEQ
    rhs: int = 0
    name: str = ""

    def is_linear(self) -> bool:
        return all(len(m) == 1 for m in self.monomials)

    def is_normalized(self) -> bool:
        return all(
            self.monomials[i] < self.monomials[i + 1]
            for i in range(len(self.monomials) - 1)
        )

    def variables(self) -> List[int]:
        seen: Dict[int, None] = {}
        for m in self.monomials:
            for v in m:
                seen.setdefault(v, None)
        return list(seen.keys())

    def is_simplex(self) -> bool:
        """sum x_i = 1 with unit coefficients (ref: ILP_input.h simplex check)."""
        return (
            self.is_linear()
            and self.ineq == Ineq.EQ
            and self.rhs == 1
            and all(c == 1 for c in self.coefficients)
        )

    def normalize(self) -> "Constraint":
        """Sort monomials by variable tuple, merge duplicates, drop zero coeffs."""
        merged: Dict[Tuple[int, ...], int] = {}
        for c, m in zip(self.coefficients, self.monomials):
            key = tuple(sorted(set(m))) if len(m) > 1 else tuple(m)
            merged[key] = merged.get(key, 0) + c
        items = sorted((m, c) for m, c in merged.items() if c != 0)
        self.monomials = [m for m, _ in items]
        self.coefficients = [c for _, c in items]
        return self

    def evaluate(self, x: Sequence[int]) -> bool:
        lhs = 0
        for c, m in zip(self.coefficients, self.monomials):
            p = 1
            for v in m:
                p *= x[v]
            lhs += c * p
        if self.ineq == Ineq.LEQ:
            return lhs <= self.rhs
        if self.ineq == Ineq.GEQ:
            return lhs >= self.rhs
        return lhs == self.rhs


class ILPInput:
    """The ILP model (ref: ILP_input.h:15-133)."""

    def __init__(self) -> None:
        self.var_names: List[str] = []
        self.var_index: Dict[str, int] = {}
        self.objective_: List[float] = []
        self.constant_: float = 0.0
        self.constraints_: List[Constraint] = []
        self.coalesce_sets_: List[List[int]] = []

    # ---------------------------------------------------------------- variables
    def nr_variables(self) -> int:
        return len(self.var_names)

    def nr_constraints(self) -> int:
        return len(self.constraints_)

    def add_new_variable(self, name: str) -> int:
        if name in self.var_index:
            raise ValueError(f"variable {name!r} already exists")
        idx = len(self.var_names)
        self.var_names.append(name)
        self.var_index[name] = idx
        self.objective_.append(0.0)
        return idx

    def get_or_create_variable(self, name: str) -> int:
        idx = self.var_index.get(name)
        if idx is None:
            idx = self.add_new_variable(name)
        return idx

    def var_exists(self, name: str) -> bool:
        return name in self.var_index

    def get_var_index(self, name: str) -> int:
        return self.var_index[name]

    def get_var_name(self, idx: int) -> str:
        return self.var_names[idx]

    # ---------------------------------------------------------------- objective
    def add_to_objective(self, coefficient: float, var: "int | str") -> None:
        if isinstance(var, str):
            var = self.get_or_create_variable(var)
        self.objective_[var] += coefficient

    def objective(self) -> List[float]:
        return list(self.objective_)

    def objective_coeff(self, var: int) -> float:
        return self.objective_[var]

    # -------------------------------------------------------------- constraints
    def add_constraint(
        self,
        coefficients: Iterable[int],
        monomials: Iterable[Sequence[int]],
        ineq: Ineq,
        rhs: int,
        name: str = "",
    ) -> int:
        c = Constraint(
            coefficients=list(coefficients),
            monomials=[tuple(m) for m in monomials],
            ineq=ineq,
            rhs=rhs,
            name=name,
        )
        self.constraints_.append(c)
        return len(self.constraints_) - 1

    def add_linear_constraint(
        self,
        coefficients: Iterable[int],
        variables: Iterable[int],
        ineq: Ineq,
        rhs: int,
        name: str = "",
    ) -> int:
        return self.add_constraint(
            coefficients, [(v,) for v in variables], ineq, rhs, name
        )

    def constraints(self) -> List[Constraint]:
        return self.constraints_

    def add_coalesce_set(self, constraint_indices: Sequence[int]) -> None:
        self.coalesce_sets_.append(list(constraint_indices))

    def normalize(self) -> None:
        """Sort each constraint's monomials by variable; merge duplicates."""
        for c in self.constraints_:
            c.normalize()

    # --------------------------------------------------------------- evaluation
    def feasible(self, x: Sequence[int]) -> bool:
        assert len(x) >= self.nr_variables()
        return all(c.evaluate(x) for c in self.constraints_)

    def evaluate(self, x: Sequence[int]) -> float:
        """Objective of assignment; +inf if infeasible (ref: ILP_input.h:147-199)."""
        if not self.feasible(x):
            return math.inf
        return (
            sum(o * xi for o, xi in zip(self.objective_, x[: self.nr_variables()]))
            + self.constant_
        )

    # ------------------------------------------------------------- preprocessing
    def preprocess(self) -> bool:
        """Remove trivially-satisfied constraints; detect trivial infeasibility.

        Returns False if infeasibility was detected.
        (semantics of src/ILP/ILP_input.cpp:300-389)
        """
        kept: List[Constraint] = []
        old_to_new: Dict[int, int] = {}
        for old_idx, c in enumerate(self.constraints_):
            remove = False
            if len(c.monomials) == 0:
                if c.ineq == Ineq.LEQ and c.rhs < 0:
                    return False
                if c.ineq == Ineq.GEQ and c.rhs > 0:
                    return False
                if c.ineq == Ineq.EQ and c.rhs != 0:
                    return False
                remove = True
            elif len(c.monomials) == 1 and len(c.monomials[0]) == 1:
                coeff = c.coefficients[0]
                if c.ineq == Ineq.LEQ:
                    if min(coeff, 0) > c.rhs:
                        return False
                    if max(coeff, 0) <= c.rhs:
                        remove = True
                elif c.ineq == Ineq.GEQ:
                    if max(coeff, 0) < c.rhs:
                        return False
                    if min(coeff, 0) >= c.rhs:
                        remove = True
                else:
                    if c.rhs != 0 and c.rhs != coeff:
                        return False
            if not remove:
                old_to_new[old_idx] = len(kept)
                kept.append(c)
        self.constraints_ = kept
        self.coalesce_sets_ = [
            [old_to_new[i] for i in s if i in old_to_new] for s in self.coalesce_sets_
        ]
        self.coalesce_sets_ = [s for s in self.coalesce_sets_ if len(s) > 1]
        return True

    def reduce(self, zero_vars: Iterable[int], one_vars: Iterable[int]) -> "ILPInput":
        """Fix variables to 0/1 and return a reduced ILP (ref: ILP_input.h:88-89).

        Only linear constraints are substituted exactly; monomials containing a
        zero-fixed variable vanish, one-fixed variables are dropped from monomials.
        """
        zero = set(zero_vars)
        one = set(one_vars)
        if zero & one:
            raise ValueError("variable fixed to both 0 and 1")
        keep = [v for v in range(self.nr_variables()) if v not in zero and v not in one]
        remap = {v: i for i, v in enumerate(keep)}
        out = ILPInput()
        for v in keep:
            out.add_new_variable(self.var_names[v])
            out.objective_[remap[v]] = self.objective_[v]
        out.constant_ = self.constant_ + sum(self.objective_[v] for v in one)
        for c in self.constraints_:
            coeffs: List[int] = []
            monomials: List[Tuple[int, ...]] = []
            rhs = c.rhs
            for coeff, m in zip(c.coefficients, c.monomials):
                if any(v in zero for v in m):
                    continue
                reduced = tuple(remap[v] for v in m if v not in one)
                if len(reduced) == 0:
                    rhs -= coeff
                else:
                    coeffs.append(coeff)
                    monomials.append(reduced)
            out.add_constraint(coeffs, monomials, c.ineq, rhs, c.name)
        out.coalesce_sets_ = [list(s) for s in self.coalesce_sets_]
        return out

    # ---------------------------------------------------------------- orderings
    def variable_adjacency(self) -> List[List[int]]:
        """Adjacency: variables sharing a constraint (ref: ILP_input.h:112-116)."""
        adj: List[set] = [set() for _ in range(self.nr_variables())]
        for c in self.constraints_:
            vs = c.variables()
            # For very large constraints a clique blows up; chain + star keeps
            # connectivity-based orderings meaningful (locality, not exactness).
            if len(vs) > 64:
                for a, b in zip(vs, vs[1:]):
                    adj[a].add(b)
                    adj[b].add(a)
            else:
                for i, a in enumerate(vs):
                    for b in vs[i + 1 :]:
                        adj[a].add(b)
                        adj[b].add(a)
        return [sorted(s) for s in adj]

    @staticmethod
    def _pseudo_peripheral_start(adj, start: int, visited) -> int:
        """Double-sweep pseudo-peripheral node of ``start``'s unvisited
        component (ref: include/pseudo_peripheral_node.hxx:60-100 — repeated
        farthest-node BFS until the eccentricity stops growing; the
        reference's farthest_node has a bug returning its argument, fixed
        here). Deterministic tie-break: smallest index at max distance."""

        def farthest(x: int):
            dist = {x: 0}
            q = deque([x])
            best, best_d = x, 0
            while q:
                u = q.popleft()
                for v in adj[u]:
                    if not visited[v] and v not in dist:
                        dist[v] = dist[u] + 1
                        if dist[v] > best_d or (
                            dist[v] == best_d and v < best
                        ):
                            best, best_d = v, dist[v]
                        q.append(v)
            return best, best_d

        y, d_y = farthest(start)
        z, d_z = farthest(y)
        while d_z > d_y:
            y, d_y = z, d_z
            z, d_z = farthest(y)
        return y

    def _bfs_order(
        self,
        sort_neighbors_by_degree: bool,
        pseudo_peripheral_starts: bool = False,
    ) -> List[int]:
        n = self.nr_variables()
        adj = self.variable_adjacency()
        deg = [len(a) for a in adj]
        visited = [False] * n
        order: List[int] = []
        remaining = sorted(range(n), key=lambda v: deg[v])
        for start in remaining:
            if visited[start]:
                continue
            if pseudo_peripheral_starts:
                start = self._pseudo_peripheral_start(adj, start, visited)
            visited[start] = True
            q = deque([start])
            while q:
                u = q.popleft()
                order.append(u)
                nbrs = [v for v in adj[u] if not visited[v]]
                if sort_neighbors_by_degree:
                    nbrs.sort(key=lambda v: deg[v])
                for v in nbrs:
                    visited[v] = True
                    q.append(v)
        assert len(order) == n
        return order

    def reorder_bfs(self) -> List[int]:
        """Apply BFS variable ordering; returns the permutation used
        (new_index = perm.index(old)? -- see :meth:`reorder`)."""
        return self.reorder(self._bfs_order(sort_neighbors_by_degree=False))

    def reorder_cuthill_mckee(self) -> List[int]:
        """Cuthill-McKee with pseudo-peripheral start nodes per component
        (ref: include/cuthill-mckee.h:29 + pseudo_peripheral_node.hxx)."""
        return self.reorder(
            self._bfs_order(
                sort_neighbors_by_degree=True, pseudo_peripheral_starts=True
            )
        )

    def reorder_minimum_degree(self) -> List[int]:
        """Greedy minimum-degree ordering (approximate; no fill-in updates)."""
        n = self.nr_variables()
        adj = [set(a) for a in self.variable_adjacency()]
        order: List[int] = []
        alive = set(range(n))
        import heapq

        heap = [(len(adj[v]), v) for v in range(n)]
        heapq.heapify(heap)
        while heap:
            d, v = heapq.heappop(heap)
            if v not in alive or d != len(adj[v] & alive):
                if v in alive:
                    heapq.heappush(heap, (len(adj[v] & alive), v))
                continue
            alive.discard(v)
            order.append(v)
        return self.reorder(order)

    def reorder(self, order: Sequence[int]) -> List[int]:
        """Permute variables in-place so that old variable ``order[i]`` becomes
        new variable ``i``. Returns ``order`` (old index per new position)."""
        n = self.nr_variables()
        assert sorted(order) == list(range(n))
        new_of_old = [0] * n
        for new, old in enumerate(order):
            new_of_old[old] = new
        self.var_names = [self.var_names[old] for old in order]
        self.var_index = {name: i for i, name in enumerate(self.var_names)}
        self.objective_ = [self.objective_[old] for old in order]
        for c in self.constraints_:
            c.monomials = [tuple(new_of_old[v] for v in m) for m in c.monomials]
            c.normalize()
        return list(order)

    # ------------------------------------------------------------------ writers
    def write_lp(self) -> str:
        out = ["Minimize"]
        terms = []
        for v, o in enumerate(self.objective_):
            terms.append(f"{o:+.12g} {self.var_names[v]}")
        if self.constant_:
            terms.append(f"{self.constant_:+.12g}")
        out.append(" ".join(terms) if terms else "0")
        out.append("Subject To")
        # constraints referenced by a coalesce set need a name in the output
        # (the parser resolves coalesce members by name only)
        need_name = {i for s in self.coalesce_sets_ for i in s
                     if not self.constraints_[i].name}
        for ci, c in enumerate(self.constraints_):
            parts = []
            if c.name:
                parts.append(f"{c.name}:")
            elif ci in need_name:
                parts.append(f"c{ci}:")
            for coeff, m in zip(c.coefficients, c.monomials):
                mono = "*".join(self.var_names[v] for v in m)
                parts.append(f"{coeff:+d} {mono}")
            parts.append(c.ineq.value)
            parts.append(str(c.rhs))
            out.append(" ".join(parts))
        if self.coalesce_sets_:
            out.append("Coalesce")
            for s in self.coalesce_sets_:
                out.append(
                    " ".join(self.constraints_[i].name or f"c{i}" for i in s)
                )
        out.append("End")
        return "\n".join(out) + "\n"

    def write_opb(self) -> str:
        if any(o != int(o) for o in self.objective_):
            raise ValueError(
                "OPB requires integral objective coefficients "
                "(truncation would change the objective)")
        terms = " ".join(
            f"{int(o):+d} {self.var_names[v]}" for v, o in enumerate(self.objective_)
        )
        out = [f"min: {terms};"]
        for c in self.constraints_:
            parts = []
            for coeff, m in zip(c.coefficients, c.monomials):
                mono = " ".join(self.var_names[v] for v in m)
                parts.append(f"{coeff:+d} {mono}")
            op = {"<=": "<=", ">=": ">=", "=": "="}[c.ineq.value]
            out.append(f"{' '.join(parts)} {op} {c.rhs};")
        return "\n".join(out) + "\n"

    def write_mps(self) -> str:
        """Fixed-format MPS export (ref: ILP_input.h write_mps)."""
        out = ["NAME          bdd_tpu", "ROWS", " N  COST"]
        rown = []
        for i, c in enumerate(self.constraints_):
            if not c.is_linear():
                raise ValueError("MPS export requires linear constraints")
            tag = {"<=": "L", ">=": "G", "=": "E"}[c.ineq.value]
            name = c.name or f"R{i}"
            rown.append(name)
            out.append(f" {tag}  {name}")
        out.append("COLUMNS")
        # per-variable column entries
        entries = {v: [] for v in range(self.nr_variables())}
        for i, c in enumerate(self.constraints_):
            for coeff, m in zip(c.coefficients, c.monomials):
                entries[m[0]].append((rown[i], coeff))
        for v in range(self.nr_variables()):
            name = self.var_names[v]
            if self.objective_[v] != 0.0:
                out.append(f"    {name}  COST  {self.objective_[v]:.12g}")
            for rname, coeff in entries[v]:
                out.append(f"    {name}  {rname}  {coeff}")
        out.append("RHS")
        for i, c in enumerate(self.constraints_):
            out.append(f"    RHS  {rown[i]}  {c.rhs}")
        out.append("BOUNDS")
        for v in range(self.nr_variables()):
            out.append(f" BV BND  {self.var_names[v]}")
        out.append("ENDATA")
        return "\n".join(out) + "\n"

    def export_constraint_matrix(self):
        """COO incidence data (var_indices, con_indices, coefficients) for
        linear constraints (ref: ILP_instance_py incidence-matrix export)."""
        rows, cols, vals = [], [], []
        for i, c in enumerate(self.constraints_):
            for coeff, m in zip(c.coefficients, c.monomials):
                if len(m) == 1:
                    rows.append(i)
                    cols.append(m[0])
                    vals.append(coeff)
        return cols, rows, vals

    # --------------------------------------------------------------- diagnostics
    def connected_components(self) -> List[List[int]]:
        """Connected components of the variable adjacency graph."""
        adj = self.variable_adjacency()
        n = self.nr_variables()
        seen = [False] * n
        comps = []
        for s in range(n):
            if seen[s]:
                continue
            comp = []
            q = deque([s])
            seen[s] = True
            while q:
                u = q.popleft()
                comp.append(u)
                for v in adj[u]:
                    if not seen[v]:
                        seen[v] = True
                        q.append(v)
            comps.append(sorted(comp))
        return comps

    def __repr__(self) -> str:
        return (
            f"ILPInput(nr_variables={self.nr_variables()}, "
            f"nr_constraints={self.nr_constraints()})"
        )
