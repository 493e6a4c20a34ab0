"""bdd_tpu — a JAX Lagrange-decomposition ILP solver (FastDOG family).

A from-scratch JAX/XLA/Pallas reimplementation of the LPMP/BDD solver suite:
0-1 integer linear programs are decomposed into per-constraint binary decision
diagrams (BDDs) coupled by Lagrange multipliers on duplicated primal variables;
the dual is maximized by min-marginal averaging (deferred block coordinate
ascent), massively parallel over all BDD nodes at equal hop distance.

Reference architecture (for parity auditing, not code provenance):
  /root/reference — LPMP/BDD, see SURVEY.md.

Layering (mirrors SURVEY.md §1, re-designed for an accelerator):
  bdd_tpu.ilp      — ILP data model + LP/OPB parsers          (ref: include/ILP)
  bdd_tpu.bdd      — BDD construction & flat collection        (ref: include/bdd_collection, bdd_conversion)
  bdd_tpu.solver   — hop-major flattening + JAX/Pallas solvers (ref: include/bdd_solver)
  bdd_tpu.api      — JSON-config pipeline + CLI                (ref: bdd_solver.cpp)
"""

__version__ = "0.1.0"

from bdd_tpu.ilp.model import ILPInput, Constraint, Ineq  # noqa: F401
