"""ILP → quasi-reduced BDD collection.

Pipeline (ref semantics: src/bdd_conversion/bdd_preprocessor.cpp:123-423):
  1. normalize constraints (sorted, merged monomials)
  2. each linear constraint -> reduced OBDD (lineq DP); trivially-true
     constraints are dropped, trivially-false ones raise InfeasibleError
  3. coalesce sets are melded into one BDD via bdd_and
  4. every BDD is made quasi-reduced (make_qbdd)
  5. variables appearing in no constraint get a free single-variable BDD so
     their objective cost is carried by exactly one subproblem
  6. (optional) long BDDs are split into depth-bounded chunks with one-hot
     auxiliary coupling variables (split_qbdd) — the "sequence parallelism"
     that bounds the hop-scan length (ref: bdd_preprocessor.cpp:374-415)

Nonlinear constraints: each degree->=2 monomial m = prod x_v is replaced by a
fresh product variable y_m plus the linking constraints
    y_m <= x_v (for each v),   y_m >= sum x_v - (|m|-1)
(Fortet linearization; the reference instead builds monomial BDDs directly,
convert_pb_to_bdd.h:29-34 — same feasible set).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

from bdd_tpu.bdd.collection import BddCollection
from bdd_tpu.bdd.lineq import ALWAYS_FALSE, ALWAYS_TRUE, bdd_from_inequality
from bdd_tpu.ilp.model import ILPInput, Ineq


class InfeasibleError(RuntimeError):
    pass


class BddPreprocessor:
    def __init__(
        self,
        ilp: ILPInput,
        split_chunk_size: Union[int, str, None] = None,
        split_implication_bdd: bool = False,
        add_free_variable_bdds: bool = True,
        coefficient_decomposition_threshold: int = 1 << 20,
    ) -> None:
        """``coefficient_decomposition_threshold``: constraints whose max
        |coefficient| exceeds this (and with >64 variables) are rewritten by
        binary coefficient decomposition into variable copies coupled by
        all_equal BDDs (ref: convert_pb_to_bdd.h:29-34, bdd_preprocessor.cpp:214
        chooses direct conversion when nr_vars<=64 or max_coeff<=100 — the DP
        here handles far larger coefficients directly, so the default threshold
        is generous)."""
        self.collection = BddCollection()
        self.ineq_to_bdd_nrs: List[List[int]] = []
        self.nr_aux_variables = 0

        self._coef_threshold = coefficient_decomposition_threshold
        ilp = self._linearize_nonlinear(ilp)
        ilp = self._decompose_huge_coefficients(ilp)
        # "primal" counts POST-transform variables (product vars and
        # coefficient copies included); split_qbdd aux vars come on top
        self.nr_primal_variables = ilp.nr_variables()
        ilp.normalize()
        if not ilp.preprocess():
            raise InfeasibleError("trivially infeasible constraint")
        self.ilp = ilp

        raw = BddCollection()
        raw_bdd_of_constraint: List[Optional[int]] = []
        for c in ilp.constraints():
            res = bdd_from_inequality(c, raw)
            if res == ALWAYS_FALSE:
                raise InfeasibleError(f"infeasible constraint {c.name or ''}")
            raw_bdd_of_constraint.append(None if res == ALWAYS_TRUE else res)

        # coalesce groups -> melded BDDs
        in_group: Dict[int, int] = {}
        for gi, group in enumerate(ilp.coalesce_sets_):
            for ci in group:
                in_group[ci] = gi
        group_bdd: Dict[int, int] = {}
        for gi, group in enumerate(ilp.coalesce_sets_):
            members = [
                raw_bdd_of_constraint[ci]
                for ci in group
                if raw_bdd_of_constraint[ci] is not None
            ]
            if members:
                group_bdd[gi] = raw.bdd_and(members)

        # qbdd + append in constraint order
        emitted_groups: set = set()
        for ci, b in enumerate(raw_bdd_of_constraint):
            gi = in_group.get(ci)
            if gi is None:
                if b is None:
                    self.ineq_to_bdd_nrs.append([])
                else:
                    self.ineq_to_bdd_nrs.append(
                        [raw.make_qbdd(b, self.collection)]
                    )
            else:
                if gi in emitted_groups or gi not in group_bdd:
                    self.ineq_to_bdd_nrs.append([])
                    continue
                emitted_groups.add(gi)
                self.ineq_to_bdd_nrs.append(
                    [raw.make_qbdd(group_bdd[gi], self.collection)]
                )

        if add_free_variable_bdds:
            covered = set(self.collection.var)
            for v in range(self.nr_primal_variables):
                if v not in covered and ilp.objective_coeff(v) != 0.0:
                    self.collection.add_bdd([(v, -1, -1)])  # lo=hi=TOP

        if split_chunk_size == "auto":
            split_chunk_size = self._auto_split_chunk_size()
        if split_chunk_size is not None:
            self._split_long_bdds(split_chunk_size, split_implication_bdd)

    # ------------------------------------------------------------------ helpers
    def _linearize_nonlinear(self, ilp: ILPInput) -> ILPInput:
        if all(c.is_linear() for c in ilp.constraints()):
            return ilp
        out = ILPInput()
        for name in ilp.var_names:
            out.add_new_variable(name)
        out.objective_ = list(ilp.objective_)
        out.constant_ = ilp.constant_
        out.coalesce_sets_ = [list(s) for s in ilp.coalesce_sets_]
        prod_var: Dict[Tuple[int, ...], int] = {}
        links: List[Tuple[List[int], List[int], Ineq, int]] = []
        for c in ilp.constraints():
            coeffs: List[int] = []
            monos: List[Tuple[int, ...]] = []
            for coeff, m in zip(c.coefficients, c.monomials):
                if len(m) == 1:
                    coeffs.append(coeff)
                    monos.append(tuple(m))
                    continue
                key = tuple(sorted(set(m)))
                if len(key) == 1:  # x*x = x
                    coeffs.append(coeff)
                    monos.append(key)
                    continue
                y = prod_var.get(key)
                if y is None:
                    y = out.add_new_variable("prod_" + "_".join(map(str, key)))
                    prod_var[key] = y
                    for v in key:
                        links.append(([1, -1], [y, v], Ineq.LEQ, 0))
                    links.append((
                        [1] + [-1] * len(key),
                        [y] + list(key),
                        Ineq.GEQ,
                        -(len(key) - 1),
                    ))
                coeffs.append(coeff)
                monos.append((y,))
            out.add_constraint(coeffs, monos, c.ineq, c.rhs, c.name)
        # Fortet linking constraints go AFTER the main constraints so the
        # original constraint indices (and thus coalesce sets) are preserved
        for lc, lv, li, lr in links:
            out.add_linear_constraint(lc, lv, li, lr)
        return out

    def _decompose_huge_coefficients(self, ilp: ILPInput) -> ILPInput:
        """Binary coefficient decomposition: c = sum 2^k b_k; variable x gets
        copies x_k with coefficient 2^k * b_k, coupled by an all_equal
        constraint. Keeps the lineq DP state space small for pathological
        coefficient ranges."""
        # direct conversion is preferred when the DP state space stays
        # small: few variables bound the per-level states regardless of the
        # coefficient magnitudes (ref bdd_preprocessor.cpp:214 gate:
        # nr_vars <= 64 or max_coeff small -> direct)
        needs_idx = {
            i
            for i, c in enumerate(ilp.constraints())
            if c.is_linear()
            and c.coefficients
            and max(abs(x) for x in c.coefficients) > self._coef_threshold
            and len(c.variables()) > 64
        }
        if not needs_idx:
            return ilp
        out = ILPInput()
        for name in ilp.var_names:
            out.add_new_variable(name)
        out.objective_ = list(ilp.objective_)
        out.constant_ = ilp.constant_
        out.coalesce_sets_ = [list(s) for s in ilp.coalesce_sets_]
        copies: Dict[int, List[int]] = {}

        def copy_var(v: int, k: int) -> int:
            lst = copies.setdefault(v, [])
            while len(lst) <= k:
                lst.append(out.add_new_variable(f"copy_{v}_{len(lst)}"))
            return lst[k]

        for ci, c in enumerate(ilp.constraints()):
            if ci not in needs_idx:
                out.add_constraint(c.coefficients, c.monomials, c.ineq, c.rhs, c.name)
                continue
            coeffs: List[int] = []
            monos: List[Tuple[int, ...]] = []
            for coeff, m in zip(c.coefficients, c.monomials):
                v = m[0]
                a = abs(coeff)
                sign = 1 if coeff > 0 else -1
                if a <= self._coef_threshold:
                    coeffs.append(coeff)
                    monos.append((v,))
                    continue
                k = 0
                first = True
                while a:
                    if a & 1:
                        cv = v if first else copy_var(v, k)
                        first = False
                        coeffs.append(sign * (1 << k))
                        monos.append((cv,))
                    a >>= 1
                    k += 1
            out.add_constraint(coeffs, monos, c.ineq, c.rhs, c.name)
        # all_equal couplings: x = copy_k for every copy
        for v, lst in copies.items():
            for cv in lst:
                out.add_linear_constraint([1, -1], [v, cv], Ineq.EQ, 0)
        return out

    def _auto_split_chunk_size(self) -> Optional[int]:
        """Split-length selection by a cost model (the analog of the
        reference's GPU occupancy model, bdd_preprocessor.cpp:32-121, which
        picks the largest chunk keeping avg kernel occupancy >= 0.5).

        The sweep over hops is the serial axis, so the tallest bucket sets
        the sequential depth: one hop is weighted like PACK_LAMBDA padded
        layer slots (see uniform.PACK_LAMBDA; not yet re-derived on the
        H100).
        Splitting a depth-d BDD into chunks of length c removes serial steps
        but each of the ceil(d/c) - 1 cuts adds the w one-hot auxiliary
        coupling variables as w extra layers on BOTH adjacent chunks (2*w
        depth overhead per interior chunk, measured exactly), where w is the
        frontier width at the cut. For each target height L (power-of-two
        multiple of PACK_H_CAP, so the chunks fit the shallow packing tier
        at L = PACK_H_CAP) the chunk length is c = L - 2*w_max; minimize
        L * PACK_LAMBDA + total coupling slots. Returns None when nothing
        exceeds PACK_H_CAP (no split — short splits only add coupling
        overhead, same spirit as the reference's min split length of 200)."""
        from bdd_tpu.solver.uniform import PACK_H_CAP, PACK_LAMBDA

        depths: List[int] = []
        mean_widths: List[float] = []
        max_widths: List[int] = []
        for b in range(self.collection.nr_bdds()):
            levels = self.collection.node_levels(b)
            if not levels:
                depths.append(0)
                mean_widths.append(0.0)
                max_widths.append(0)
                continue
            depth = max(levels) + 1
            counts: Dict[int, int] = {}
            for lvl in levels:
                counts[lvl] = counts.get(lvl, 0) + 1
            depths.append(depth)
            mean_widths.append(len(levels) / depth)
            max_widths.append(max(counts.values()))
        d_max = max(depths, default=0)
        if d_max <= PACK_H_CAP:
            return None
        best: Optional[Tuple[float, Optional[int]]] = (d_max * PACK_LAMBDA, None)
        L = PACK_H_CAP
        while L < d_max:
            w_max = max(
                (w for d, w in zip(depths, max_widths) if d > L), default=0
            )
            chunk = L - 2 * w_max
            # even chunks dominated by coupling layers win when they halve
            # the serial depth (measured: width-301 frontier, chunk 422 ->
            # 1.9x despite 60% coupling overhead); only reject degenerate
            # chunk lengths and let the slot cost model arbitrate the rest
            if chunk >= max(16, w_max // 4):
                # 2w layer slots per cut land in the exchange + sweeps
                cut_slots = sum(
                    ((d + chunk - 1) // chunk - 1) * 2.0 * w
                    for d, w in zip(depths, mean_widths)
                    if d > chunk
                )
                cost = L * PACK_LAMBDA + cut_slots
                if cost < best[0]:
                    best = (cost, chunk)
            L *= 2
        return best[1]

    def _split_long_bdds(self, chunk_size: int, implication: bool = False) -> None:
        assert chunk_size >= 2
        new = BddCollection()
        aux = self.nr_primal_variables
        remap: Dict[int, List[int]] = {}
        for b in range(self.collection.nr_bdds()):
            levels = self.collection.node_levels(b)
            depth = (max(levels) + 1) if levels else 0
            if depth <= chunk_size:
                # copy verbatim
                remap[b] = [new.add_bdd(self.collection.local_nodes(b))]
            else:
                nrs, aux = self.collection.split_qbdd(
                    b, chunk_size, aux, new, with_implication_bdd=implication
                )
                remap[b] = nrs
        self.nr_aux_variables = aux - self.nr_primal_variables
        self.collection = new
        self.ineq_to_bdd_nrs = [
            [nb for ob in lst for nb in remap[ob]] for lst in self.ineq_to_bdd_nrs
        ]

    def total_nr_variables(self) -> int:
        return self.nr_primal_variables + self.nr_aux_variables

    def objective_vector(self) -> List[float]:
        """Objective over primal + auxiliary (0-cost) variables."""
        obj = self.ilp.objective()
        return obj + [0.0] * self.nr_aux_variables
