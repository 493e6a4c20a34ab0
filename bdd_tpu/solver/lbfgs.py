"""L-BFGS outer loop maximizing the Lagrange dual.

Faithful port of the reference's templated lbfgs wrapper (include/bdd_solver/
lbfgs.h:22-33, src/bdd_solver/lbfgs_impl.h; algorithm of Roetzer et al. 2023):

  x      = per-layer net solver costs (hi - lo + deferred share)
  grad f = per-BDD argmin solutions in {0,1} (a supergradient of the dual)
  history of (s = x_k - x_{k-1}, y = grad_{k-1} - grad_k, rho_inv = s.y),
  curvature skip when rho_inv <= 1e-8; two-loop recursion with initial
  Hessian-diagonal scaling rho_inv_last / |y_last|^2; the direction is
  zero-sum-projected per primal variable (make_dual_feasible) and applied to
  the hi costs with an adaptive step-size search (up to 6 trials, geometric
  decrease on failure / increase on weak success); falls back to plain MMA
  iterations until the history is full or after repeated failures.

Two execution paths with identical semantics:
  * device path (default for the dense and uniform backends): the WHOLE outer
    iteration — solution supergradient, history ring-buffer update, two-loop
    recursion, zero-sum projection, adaptive step search as a
    ``lax.while_loop``, and the trailing MMA iteration — is one jitted
    program; the step size / failure counters / lb history live on device.
    The reference runs this loop on-GPU with thrust for the same reason
    (lbfgs.cpp/.cu instantiations); a host-driven loop costs ~10-15 device
    round-trips per outer iteration.
  * host path (sharded backend, or BDD_TPU_LBFGS_HOST=1): readable reference
    control flow orchestrating the same jitted primitives.
"""
from __future__ import annotations

import collections
import os
from typing import Any, Deque, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from bdd_tpu.solver import jax_solver as js
from bdd_tpu.solver.wrapper import JaxSolver


def _tree_vdot(a, b) -> float:
    return float(
        sum(jnp.vdot(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    )


def _tree_axpy(alpha, x, y):
    """y + alpha * x over pytrees."""
    return jax.tree.map(lambda xx, yy: yy + alpha * xx, x, y)


class _Ops:
    """Backend dispatch: dense JaxSolver vs uniform bucketed solver vs the
    mesh-sharded solver (stacked pytrees; global reductions via psum)."""

    def __init__(self, base) -> None:
        self.base = base
        self.dense = isinstance(base, JaxSolver)
        self.sharded = hasattr(base, "state_stacked")

    def grad(self):
        if self.dense:
            sol = js.bdds_solution(self.base.geom, self.base.state.lo, self.base.state.hi)
            return jnp.where(
                self.base.geom.layer_valid,
                sol.astype(self.base.state.lo.dtype),
                0.0,
            )
        if self.sharded:
            b = self.base
            sols = b._sols(b.geom_stacked, b.state_stacked)
            return tuple(
                s.astype(l.dtype)
                for s, l in zip(sols, b.state_stacked.lo)
            )
        from bdd_tpu.solver import uniform as uf

        sols = uf.bdds_solution(self.base.geom, self.base.state)
        return tuple(
            s.astype(l.dtype) for s, l in zip(sols, self.base.state.lo)
        )

    def net_costs(self):
        if self.dense:
            return js.net_solver_costs(self.base.geom, self.base.state)
        if self.sharded:
            b = self.base
            return b._netc(b.geom_stacked, b.state_stacked)
        from bdd_tpu.solver import uniform as uf

        return uf.net_solver_costs(self.base.geom, self.base.state)

    def make_dual_feasible(self, g):
        if self.dense:
            return js.make_dual_feasible(self.base.geom, g)
        if self.sharded:
            b = self.base
            return b._feas(b.geom_stacked, g)
        from bdd_tpu.solver import uniform as uf

        return uf.make_dual_feasible(self.base.geom, g)

    def gradient_step(self, g, step):
        if self.dense:
            self.base.state = js.gradient_step(self.base.geom, self.base.state, g, step)
        elif self.sharded:
            b = self.base
            b.state_stacked = b._gstep(
                b.geom_stacked, b.state_stacked, g, step
            )
        else:
            from bdd_tpu.solver import uniform as uf

            self.base.state = uf.gradient_step(self.base.geom, self.base.state, g, step)


class _HistEntry(NamedTuple):
    s: Any  # pytree of per-layer arrays
    y: Any
    rho_inv: float


def _dev_vdot(a, b):
    """Device-resident pytree inner product (no host sync)."""
    return sum(
        jnp.vdot(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))
    )


def _push_scalar(buf, count, val, m):
    """Append to a rolling last-m ring kept oldest->newest."""
    shifted = jnp.where(count >= m, jnp.roll(buf, -1), buf)
    idx = jnp.minimum(count, m - 1)
    return jnp.where(jnp.arange(m) == idx, val, shifted), count + 1


class _DeviceLbfgs:
    """Fully jitted L-BFGS outer iteration for the dense / uniform backends.

    One device program per outer iteration; history (S, Y, rho_inv) as stacked
    [m, ...] ring buffers, the step-size search as a bounded lax.while_loop.
    Bit-for-bit the control flow of the host path below (= lbfgs_impl.h)."""

    def __init__(self, outer: "LbfgsSolver") -> None:
        base = outer.base
        self.base = base
        m = outer.m
        req = outer.req_rel_lb_increase
        dec, inc = outer.dec, outer.inc
        omega = base.omega

        if isinstance(base, JaxSolver):
            def grad_fn(geom, st):
                sol = js.bdds_solution(geom, st.lo, st.hi)
                return jnp.where(geom.layer_valid, sol.astype(st.lo.dtype), 0.0)

            netc = js.net_solver_costs
            feas = js.make_dual_feasible
            gstep = js.gradient_step
            lb = lambda geom, st: js.lower_bound_from_cft(geom, st.cft)
            mma = lambda geom, st: js.iteration(geom, st, omega)
        else:
            from bdd_tpu.solver import uniform as uf

            def grad_fn(geom, st):
                sols = uf.bdds_solution(geom, st)
                return tuple(
                    s.astype(l.dtype) for s, l in zip(sols, st.lo)
                )

            netc = lambda geom, st: uf.net_solver_costs(geom, st)
            feas = lambda geom, g: uf.make_dual_feasible(geom, g)
            gstep = uf.gradient_step
            lb = lambda geom, st: uf.lower_bound(geom, st)
            mma = lambda geom, st: uf.iterations(geom, st, 1, omega)

        def push_hist(hist, s_, y_, rho_new):
            count = hist["count"]
            full = count >= m
            idx = jnp.minimum(count, m - 1)

            def pb(buf, new):
                shifted = jnp.where(full, jnp.roll(buf, -1, axis=0), buf)
                onehot = (jnp.arange(m) == idx).reshape(
                    (m,) + (1,) * new.ndim
                )
                return jnp.where(onehot, new[None], shifted)

            rho_sh = jnp.where(full, jnp.roll(hist["rho"], -1), hist["rho"])
            return {
                "S": jax.tree.map(pb, hist["S"], s_),
                "Y": jax.tree.map(pb, hist["Y"], y_),
                "rho": jnp.where(jnp.arange(m) == idx, rho_new, rho_sh),
                "count": jnp.minimum(count + 1, m),
            }

        def two_loop(hist, grad):
            # only invoked when count == m: every ring entry is valid
            S, Y, rho = hist["S"], hist["Y"], hist["rho"]
            d = grad
            alphas = [None] * m
            for i in reversed(range(m)):
                Si = jax.tree.map(lambda b: b[i], S)
                Yi = jax.tree.map(lambda b: b[i], Y)
                a = _dev_vdot(Si, d) / rho[i]
                alphas[i] = a
                d = _tree_axpy(-a, Yi, d)
            Ym = jax.tree.map(lambda b: b[m - 1], Y)
            h0 = rho[m - 1] / (1e-8 + _dev_vdot(Ym, Ym))
            d = jax.tree.map(lambda x: h0 * x, d)
            for i in range(m):
                Si = jax.tree.map(lambda b: b[i], S)
                Yi = jax.tree.map(lambda b: b[i], Y)
                beta = _dev_vdot(Yi, d) / rho[i]
                d = _tree_axpy(alphas[i] - beta, Si, d)
            return d

        def search(geom, state, d, step_size, fails, past):
            lb_pre = lb(geom, state)
            denom = 1e-9 + jnp.maximum(past, 0.0)
            zero = jnp.zeros_like(step_size)

            def cond_fn(c):
                return ~c["done"]

            def body(c):
                st = gstep(geom, c["state"], d, c["step"] - c["prev_step"])
                prev_step = c["step"]
                cur_rel = (lb(geom, st) - lb_pre) / denom
                better = cur_rel > c["best_rel"]
                best_rel = jnp.where(better, cur_rel, c["best_rel"])
                best_step = jnp.where(better, prev_step, c["best_step"])
                new_step = jnp.where(
                    cur_rel <= 0.0,
                    c["step"] * dec,
                    jnp.where(cur_rel < req, c["step"] * inc, c["step"]),
                )
                exhausted = c["num_updates"] > 5
                num_updates = jnp.where(
                    exhausted, c["num_updates"], c["num_updates"] + 1
                )
                success = (cur_rel >= req) & ~exhausted
                return {
                    "state": st,
                    "prev_step": prev_step,
                    "step": new_step,
                    "best_step": best_step,
                    "best_rel": best_rel,
                    "num_updates": num_updates,
                    "done": exhausted | success,
                    "exhausted": exhausted,
                }

            c = lax.while_loop(
                cond_fn,
                body,
                {
                    "state": state,
                    "prev_step": zero,
                    "step": step_size,
                    "best_step": zero,
                    "best_rel": zero,
                    "num_updates": jnp.zeros((), jnp.int32),
                    "done": jnp.zeros((), bool),
                    "exhausted": jnp.zeros((), bool),
                },
            )
            kept = c["best_rel"] > req / 10.0
            final_step = jnp.where(kept, c["best_step"], zero)
            state = lax.cond(
                c["exhausted"],
                lambda op: gstep(geom, op[0], d, op[1]),
                lambda op: op[0],
                (c["state"], final_step - c["prev_step"]),
            )
            grew = (~c["exhausted"]) & (c["num_updates"] == 1) & (fails == 0)
            step_out = jnp.where(grew, c["step"] * inc, c["step"])
            fails_out = jnp.where(
                c["exhausted"],
                fails + (~kept).astype(fails.dtype),
                jnp.zeros_like(fails),
            )
            return state, step_out, fails_out

        def step_fn(geom, state, hist, aux):
            def plain_branch(op):
                st, h, a = op
                return mma(geom, st), h, a

            def full_branch(op):
                state, hist, aux = op
                lb0 = lb(geom, state)
                lb_buf, lb_count = lax.cond(
                    aux["lb_count"] == 0,
                    lambda bc: _push_scalar(bc[0], bc[1], lb0, m),
                    lambda bc: bc,
                    (aux["lb_buf"], aux["lb_count"]),
                )
                cur_grad = grad_fn(geom, state)
                cur_x = netc(geom, state)
                s_ = jax.tree.map(lambda a, b: a - b, cur_x, aux["prev_x"])
                y_ = jax.tree.map(
                    lambda a, b: a - b, aux["prev_grad"], cur_grad
                )
                rho = _dev_vdot(s_, y_)
                hist = lax.cond(
                    aux["have_prev"] & (rho > 1e-8),
                    lambda h: push_hist(h, s_, y_, rho),
                    lambda h: h,
                    hist,
                )
                past = jnp.where(
                    lb_count >= m, lb_buf[1] - lb_buf[0], jnp.zeros_like(lb0)
                )

                def with_update(op2):
                    st, step_size, fails = op2
                    d = feas(geom, two_loop(hist, cur_grad))
                    return search(geom, st, d, step_size, fails, past)

                state, step_size, fails = lax.cond(
                    (hist["count"] >= m) & (aux["fails"] <= 5),
                    with_update,
                    lambda op2: op2,
                    (state, aux["step"], aux["fails"]),
                )
                state = mma(geom, state)
                lb_buf, lb_count = _push_scalar(
                    lb_buf, lb_count, lb(geom, state), m
                )
                aux = {
                    **aux,
                    "step": step_size,
                    "fails": fails,
                    "prev_x": cur_x,
                    "prev_grad": cur_grad,
                    "have_prev": jnp.ones((), bool),
                    "lb_buf": lb_buf,
                    "lb_count": lb_count,
                }
                return state, hist, aux

            return lax.cond(
                aux["fails"] > 5, plain_branch, full_branch, (state, hist, aux)
            )

        self._step = jax.jit(step_fn)
        self._step_raw = step_fn
        self._block_fns: dict = {}
        xs = jax.eval_shape(netc, base.geom, base.state)
        zeros = lambda sd: jnp.zeros(sd.shape, sd.dtype)
        ztree = jax.tree.map(zeros, xs)
        dtype = jax.tree.leaves(xs)[0].dtype
        stack = lambda z: jnp.zeros((m,) + z.shape, z.dtype)
        self.hist = {
            "S": jax.tree.map(stack, ztree),
            "Y": jax.tree.map(stack, ztree),
            "rho": jnp.zeros((m,), dtype),
            "count": jnp.zeros((), jnp.int32),
        }
        self.aux = {
            "step": jnp.asarray(outer.step_size, dtype),
            "fails": jnp.zeros((), jnp.int32),
            "prev_x": ztree,
            "prev_grad": ztree,
            "have_prev": jnp.zeros((), bool),
            "lb_buf": jnp.zeros((m,), dtype),
            "lb_count": jnp.zeros((), jnp.int32),
        }

    def iteration(self) -> None:
        state, self.hist, self.aux = self._step(
            self.base.geom, self.base.state, self.hist, self.aux
        )
        self.base.state = state

    def iteration_block(self, n: int) -> None:
        """n outer iterations as ONE compiled scan — the lb fetch (a host
        sync) then happens once per block in run_solver instead of once per
        outer iteration (the same treatment run_solver's adaptive period
        gives plain MMA)."""
        if n == 1:
            self.iteration()
            return
        fn = self._block_fns.get(n)
        if fn is None:
            step = self._step_raw

            def block(geom, state, hist, aux):
                def body(carry, _):
                    return step(geom, *carry), None

                carry, _ = lax.scan(
                    body, (state, hist, aux), None, length=n
                )
                return carry

            fn = jax.jit(block)
            self._block_fns[n] = fn
        state, self.hist, self.aux = fn(
            self.base.geom, self.base.state, self.hist, self.aux
        )
        self.base.state = state

    def flush(self) -> None:
        self.hist = {**self.hist, "count": jnp.zeros((), jnp.int32)}
        self.aux = {
            **self.aux,
            "fails": jnp.zeros((), jnp.int32),
            "have_prev": jnp.zeros((), bool),
        }


class LbfgsSolver:
    """Wraps a JaxSolver; duck interface compatible with run_solver/rounding."""

    default_block_size = 1  # outer iterations need host control flow

    def __init__(
        self,
        base: JaxSolver,
        history_size: int = 5,
        init_step_size: float = 1e-6,
        required_relative_lb_increase: float = 1e-6,
        step_size_decrease_factor: float = 0.8,
        step_size_increase_factor: float = 1.1,
    ) -> None:
        self.base = base
        self.f = base.f
        self.m = history_size
        self.step_size = init_step_size
        self.req_rel_lb_increase = required_relative_lb_increase
        self.dec = step_size_decrease_factor
        self.inc = step_size_increase_factor
        self.history: Deque[_HistEntry] = collections.deque()
        self.ops = _Ops(base)
        self.prev_x = None
        self.prev_grad = None
        self.num_unsuccessful = 0
        self.lb_history: list = []
        self._dev: _DeviceLbfgs | None = None
        self._use_device = (
            not self.ops.sharded
            and os.environ.get("BDD_TPU_LBFGS_HOST") != "1"
        )
        # device path: outer iterations scan on-device, so run_solver can
        # amortize its lb host-sync over a block. Host /
        # sharded paths need per-iteration host control flow.
        if self._use_device:
            self.default_block_size = 10

    # ----------------------------------------------------------- base passthru
    def lower_bound(self) -> float:
        return self.base.lower_bound()

    def lower_bound_with_deferred(self) -> float:
        return self.base.lower_bound_with_deferred()

    def min_marginals(self):
        return self.base.min_marginals()

    def distribute_delta(self) -> None:
        self.base.distribute_delta()

    def update_costs(self, lo_per_var, hi_per_var) -> None:
        self._flush()
        self.base.update_costs(lo_per_var, hi_per_var)

    def _flush(self) -> None:
        self.history.clear()
        self.prev_x = None
        self.prev_grad = None
        self.num_unsuccessful = 0
        if self._dev is not None:
            self._dev.flush()

    # -------------------------------------------------------------- lbfgs core
    def _grad(self):
        return self.ops.grad()

    def _store_iterate(self, cur_grad) -> None:
        cur_x = self.ops.net_costs()
        if self.prev_x is not None:
            s = jax.tree.map(lambda a, b: a - b, cur_x, self.prev_x)
            y = jax.tree.map(lambda a, b: a - b, self.prev_grad, cur_grad)
            rho_inv = _tree_vdot(s, y)
            if rho_inv > 1e-8:
                self.history.append(_HistEntry(s, y, rho_inv))
                if len(self.history) > self.m:
                    self.history.popleft()
        self.prev_x = cur_x
        self.prev_grad = cur_grad

    def _update_possible(self) -> bool:
        return len(self.history) >= self.m and self.num_unsuccessful <= 5

    def _compute_direction(self, cur_grad):
        """Two-loop recursion (lbfgs_impl.h:227-316); gradients negated
        implicitly by the y convention (maximization)."""
        d = cur_grad
        alphas = []
        for h in reversed(self.history):
            a = _tree_vdot(h.s, d) / h.rho_inv
            alphas.append(a)
            d = _tree_axpy(-a, h.y, d)
        alphas.reverse()
        last = self.history[-1]
        y_norm = _tree_vdot(last.y, last.y)
        h0 = last.rho_inv / (1e-8 + y_norm)
        # r = H0 * q between the loops (lbfgs_impl.h / Nocedal alg. 7.4) —
        # scaling only the oldest entry's rho instead mis-weights every
        # curvature correction and leaves the raw-gradient component
        # unscaled, degrading toward mis-scaled supergradient ascent
        d = jax.tree.map(lambda x: h0 * x, d)
        for i, h in enumerate(self.history):
            rho = 1.0 / h.rho_inv
            beta = rho * _tree_vdot(h.y, d)
            d = _tree_axpy(alphas[i] - beta, h.s, d)
        return d

    def _search_step_size_and_apply(self, direction: jnp.ndarray) -> None:
        lb_pre = self.base.lower_bound()

        def rel_change() -> float:
            cur = self.base.lower_bound() - lb_pre
            if len(self.lb_history) >= self.m:
                past = self.lb_history[-(self.m - 1)] - self.lb_history[-self.m]
            else:
                past = 0.0
            return cur / (1e-9 + max(past, 0.0))

        prev_step = 0.0

        def apply(step: float) -> None:
            nonlocal prev_step
            net = step - prev_step
            if net != 0.0:
                self.ops.gradient_step(direction, net)
            prev_step = step

        num_updates = 0
        best_step, best_rel = 0.0, 0.0
        while True:
            apply(self.step_size)
            cur_rel = rel_change()
            if best_rel < cur_rel:
                best_rel, best_step = cur_rel, self.step_size
            if cur_rel <= 0.0:
                self.step_size *= self.dec
            elif cur_rel < self.req_rel_lb_increase:
                self.step_size *= self.inc
            if num_updates > 5:
                if best_rel > self.req_rel_lb_increase / 10.0:
                    apply(best_step)
                else:
                    apply(0.0)
                    self.num_unsuccessful += 1
                return
            num_updates += 1
            if cur_rel >= self.req_rel_lb_increase:
                break
        if num_updates == 1 and self.num_unsuccessful == 0:
            self.step_size *= self.inc
        self.num_unsuccessful = 0

    # --------------------------------------------------------------- iteration
    def iteration_block(self, n: int) -> None:
        """Device path: n outer iterations in one compiled program (no
        per-iteration lb sync). Elsewhere: a host loop (same semantics)."""
        if self._use_device:
            if self._dev is None:
                self._dev = _DeviceLbfgs(self)
            self._dev.iteration_block(n)
            return
        for _ in range(n):
            self.iteration()

    def iteration(self) -> None:
        if self._use_device:
            if self._dev is None:
                self._dev = _DeviceLbfgs(self)
            self._dev.iteration()
            return
        if self.num_unsuccessful > 5:
            # permanently disabled after repeated failed step searches
            # (ref lbfgs_impl.h:410-419): plain MMA, without paying the
            # gradient/net-cost/history machinery every iteration
            self.base.iteration()
            return
        if not self.lb_history:
            self.lb_history.append(self.base.lower_bound())
        cur_grad = self._grad()
        self._store_iterate(cur_grad)
        if self._update_possible():
            d = self._compute_direction(cur_grad)
            d = self.ops.make_dual_feasible(d)
            self._search_step_size_and_apply(d)
            self.base.iteration()
        else:
            self.base.iteration()
        self.lb_history.append(self.base.lower_bound())
