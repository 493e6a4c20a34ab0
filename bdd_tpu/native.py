"""ctypes bindings for the native host-preprocessing library (native/bdd_host.cpp).

Builds on demand with g++ (no pybind11 in this environment). The native path
covers the hot host pipeline — LP parse, orderings, lineq->BDD, qbdd, uniform
bucket flattening. Unsupported features (nonlinear monomials, coalesce,
OPB, split) raise NativeUnsupported so callers fall back to the Python path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List

import numpy as np

_LIB = None

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "native", "bdd_host.cpp")
_SO = os.path.join(_ROOT, "native", "build", "libbddhost.so")


class NativeUnsupported(RuntimeError):
    pass


def _fresh() -> bool:
    return os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)


def _build_if_needed() -> str:
    """Build ``native/build/libbddhost.so`` from ``native/bdd_host.cpp``
    unless a build newer than the source exists. The library is never
    committed: a fresh checkout builds it here, at first use. Concurrent
    processes (test workers) serialize on a lock file, and the library
    appears under its name only once complete."""
    if _fresh():
        return _SO
    import fcntl

    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    with open(_SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _fresh():
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O2", "-std=c++17", "-fopenmp", "-shared", "-fPIC",
                 "-o", tmp, _SRC],
                check=True,
            )
            os.replace(tmp, _SO)
    return _SO


def load_library():
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(_build_if_needed())
    lib.bh_create.restype = ctypes.c_void_p
    lib.bh_destroy.argtypes = [ctypes.c_void_p]
    lib.bh_error.argtypes = [ctypes.c_void_p]
    lib.bh_error.restype = ctypes.c_char_p
    lib.bh_parse_lp.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.bh_reorder.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bh_build.argtypes = [ctypes.c_void_p]
    lib.bh_nr_vars.argtypes = [ctypes.c_void_p]
    lib.bh_nr_bdds.argtypes = [ctypes.c_void_p]
    lib.bh_nr_constraints.argtypes = [ctypes.c_void_p]
    lib.bh_constant.argtypes = [ctypes.c_void_p]
    lib.bh_constant.restype = ctypes.c_double
    lib.bh_objective.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    lib.bh_var_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bh_var_name.restype = ctypes.c_char_p
    lib.bh_var_order.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bh_var_order.restype = ctypes.c_int
    lib.bh_bucket_shape.argtypes = [ctypes.c_void_p, ctypes.c_int] + [
        ctypes.POINTER(ctypes.c_int)
    ] * 4
    lib.bh_fill_bucket.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.bh_collection_sizes.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.bh_fill_collection.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_int64)
    ] * 4
    lib.bh_load_collection.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
    ] + [ctypes.POINTER(ctypes.c_int64)] * 4
    lib.bh_load_collection.restype = ctypes.c_int
    lib.bh_cpu_create.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.bh_cpu_create.restype = ctypes.c_void_p
    lib.bh_cpu_destroy.argtypes = [ctypes.c_void_p]
    lib.bh_cpu_iterations.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_double]
    lib.bh_cpu_lower_bound.argtypes = [ctypes.c_void_p]
    lib.bh_cpu_lower_bound.restype = ctypes.c_double
    lib.bh_cpu_lower_bound_deferred.argtypes = [ctypes.c_void_p]
    lib.bh_cpu_lower_bound_deferred.restype = ctypes.c_double
    lib.bh_cpu_nr_threads.argtypes = [ctypes.c_void_p]
    lib.bh_cpu_nr_layers.argtypes = [ctypes.c_void_p]
    lib.bh_cpu_nr_layers.restype = ctypes.c_int64
    lib.bh_cpu_layer_info.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.bh_cpu_get_costs.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_double)
    ] * 3
    lib.bh_cpu_set_costs.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_double)
    ] * 3
    # hybrid host+device consensus hooks (solver/hybrid.py)
    lib.bh_cpu_partial_delta.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)
    ]
    lib.bh_cpu_half_iteration_ext.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.bh_cpu_lower_bound_deferred_ext.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)
    ]
    lib.bh_cpu_lower_bound_deferred_ext.restype = ctypes.c_double
    lib.bh_cpu_min_marginals.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_double)
    ] * 2
    lib.bh_cpu_update_costs.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_double)
    ] * 2
    lib.bh_cpu_distribute_delta_ext.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)
    ]
    _LIB = lib
    return lib


def available() -> bool:
    try:
        load_library()
        return True
    except Exception:
        return False


_ORDER_MODES = {
    "input": 0,
    "bfs": 1,
    "cuthill": 2,  # pseudo-peripheral starts, like the reference
    "minimum degree": 3,
    "mindegree": 3,
}


class NativeHost:
    """One parsed+built instance. Raises NativeUnsupported on fallback cases."""

    def __init__(self, lp_text: str, variable_order: str = "input") -> None:
        lib = load_library()
        self._lib = lib
        self._ctx = lib.bh_create()
        if lib.bh_parse_lp(self._ctx, lp_text.encode()) != 0:
            err = lib.bh_error(self._ctx).decode()
            self.close()
            raise NativeUnsupported(f"native parse failed: {err}")
        if variable_order not in _ORDER_MODES:
            self.close()
            raise NativeUnsupported(f"order {variable_order!r} not native")
        lib.bh_reorder(self._ctx, _ORDER_MODES[variable_order])
        r = lib.bh_build(self._ctx)
        self._nr_buckets = max(r, 0)
        if r == -1:
            self.infeasible = True
        elif r < 0:
            err = lib.bh_error(self._ctx).decode()
            self.close()
            raise NativeUnsupported(f"native build failed: {err}")
        else:
            self.infeasible = False

    def close(self) -> None:
        if getattr(self, "_ctx", None):
            self._lib.bh_destroy(self._ctx)
            self._ctx = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------------ meta
    def nr_vars(self) -> int:
        return self._lib.bh_nr_vars(self._ctx)

    def nr_bdds(self) -> int:
        return self._lib.bh_nr_bdds(self._ctx)

    def constant(self) -> float:
        return self._lib.bh_constant(self._ctx)

    def objective(self) -> np.ndarray:
        out = np.zeros(self.nr_vars(), dtype=np.float64)
        self._lib.bh_objective(
            self._ctx, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        )
        return out

    def var_names(self) -> List[str]:
        return [
            self._lib.bh_var_name(self._ctx, i).decode()
            for i in range(self.nr_vars())
        ]

    def var_perm(self):
        """Old variable index per new position of the applied reorder, or
        None when the order was 'input' (identity)."""
        if self._lib.bh_var_order(self._ctx, 0) < 0:
            return None
        return [
            int(self._lib.bh_var_order(self._ctx, i))
            for i in range(self.nr_vars())
        ]

    # --------------------------------------------------------------- buckets
    def nr_buckets(self) -> int:
        return self._nr_buckets

    def bucket_arrays(self, k: int):
        lib = self._lib
        H = ctypes.c_int()
        P = ctypes.c_int()
        B = ctypes.c_int()
        nB = ctypes.c_int()
        lib.bh_bucket_shape(
            self._ctx, k, ctypes.byref(H), ctypes.byref(P), ctypes.byref(B), ctypes.byref(nB)
        )
        H, P, B, nB = H.value, P.value, B.value, nB.value
        node_valid = np.zeros((H, P, B), dtype=np.int8)
        lo_kind = np.zeros((H, P, B), dtype=np.int8)
        lo_slot = np.zeros((H, P, B), dtype=np.int32)
        hi_kind = np.zeros((H, P, B), dtype=np.int8)
        hi_slot = np.zeros((H, P, B), dtype=np.int32)
        layer_valid = np.zeros((H, B), dtype=np.int8)
        layer_var = np.zeros((H, B), dtype=np.int32)
        bdd_of_col = np.zeros(B, dtype=np.int64)
        depths = np.zeros(B, dtype=np.int32)

        def ptr(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        lib.bh_fill_bucket(
            self._ctx,
            k,
            ptr(node_valid, ctypes.c_int8),
            ptr(lo_kind, ctypes.c_int8),
            ptr(lo_slot, ctypes.c_int32),
            ptr(hi_kind, ctypes.c_int8),
            ptr(hi_slot, ctypes.c_int32),
            ptr(layer_valid, ctypes.c_int8),
            ptr(layer_var, ctypes.c_int32),
            ptr(bdd_of_col, ctypes.c_int64),
            ptr(depths, ctypes.c_int32),
        )
        return dict(
            H=H,
            P=P,
            B=B,
            nB=nB,
            node_valid=node_valid.astype(bool),
            lo_kind=lo_kind,
            lo_slot=lo_slot,
            hi_kind=hi_kind,
            hi_slot=hi_slot,
            layer_valid=layer_valid.astype(bool),
            layer_var=layer_var,
            bdd_of_col=bdd_of_col,
            depths=depths,
        )

    # ------------------------------------------------------------ collection
    def collection(self):
        """Export as a python BddCollection (tests / fallback interop)."""
        from bdd_tpu.bdd.collection import BddCollection

        lib = self._lib
        nn = ctypes.c_int64()
        nb = ctypes.c_int64()
        lib.bh_collection_sizes(self._ctx, ctypes.byref(nn), ctypes.byref(nb))
        var = np.zeros(nn.value, dtype=np.int64)
        lo = np.zeros(nn.value, dtype=np.int64)
        hi = np.zeros(nn.value, dtype=np.int64)
        delim = np.zeros(nb.value + 1, dtype=np.int64)

        def ptr(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

        lib.bh_fill_collection(self._ctx, ptr(var), ptr(lo), ptr(hi), ptr(delim))
        col = BddCollection()
        col.var = [int(v) for v in var]
        col.lo = [int(v) for v in lo]
        col.hi = [int(v) for v in hi]
        col.delim = [int(v) for v in delim]
        return col


    def cpu_solver(self, objective=None) -> "NativeCpuSolver":
        """Multi-core OpenMP parallel-MMA solver over this context's BDDs —
        the honest CPU performance baseline (reference semantics:
        src/bdd_solver/bdd_parallel_mma_base.cpp:815-1044)."""
        obj = self.objective() if objective is None else np.asarray(
            objective, dtype=np.float64
        )
        return NativeCpuSolver(self, obj)

    def make_uniform_host(self, dtype=None, pack=None):
        """Assemble a solver-ready UniformHost from the native bucket arrays.

        ``pack``: vertical column packing (uniform.pack_uniform_host);
        defaults to on for float32 (off for float64 bit-parity runs)."""
        import jax.numpy as jnp

        from bdd_tpu.solver import uniform as uf

        if dtype is None:
            dtype = jnp.float32
        V = self.nr_vars()
        raw = [self.bucket_arrays(k) for k in range(self.nr_buckets())]
        counts = np.zeros(V, dtype=np.int32)
        for a in raw:
            np.add.at(counts, a["layer_var"][a["layer_valid"]], 1)
        counts_safe = np.maximum(counts, 1)
        geoms = []
        layer_bdds = []
        for a in raw:
            alpha = np.zeros(a["layer_var"].shape)
            m = a["layer_valid"]
            alpha[m] = 1.0 / counts_safe[a["layer_var"][m]]
            lbdd = np.broadcast_to(a["bdd_of_col"][None, :], m.shape).copy()
            lbdd[~m] = -1
            layer_bdds.append(lbdd)
            geoms.append(
                uf.BucketGeom(
                    node_valid=jnp.asarray(a["node_valid"]),
                    lo_kind=jnp.asarray(a["lo_kind"], dtype=jnp.int32),
                    lo_slot=jnp.asarray(a["lo_slot"], dtype=jnp.int32),
                    hi_kind=jnp.asarray(a["hi_kind"], dtype=jnp.int32),
                    hi_slot=jnp.asarray(a["hi_slot"], dtype=jnp.int32),
                    layer_valid=jnp.asarray(a["layer_valid"]),
                    layer_var=jnp.asarray(a["layer_var"], dtype=jnp.int32),
                    alpha=jnp.asarray(alpha, dtype=dtype),
                )
            )
        geom = uf.UniformGeom(
            buckets=tuple(geoms),
            num_bdds_per_var=jnp.asarray(counts, dtype=jnp.int32),
            exchange=None,
        )
        host = uf.UniformHost(
            geom=geom,
            bdd_of_col=tuple(a["bdd_of_col"] for a in raw),
            depths=tuple(a["depths"] for a in raw),
            nr_vars=V,
            nr_primal_vars=V,
            nr_bdds=self.nr_bdds(),
            layer_bdd=tuple(layer_bdds),
        )
        if pack is None:
            pack = dtype == jnp.float32
        if pack and raw:
            host = uf.pack_uniform_host(host, dtype=dtype)
        return uf.attach_exchange_plan(host)


class NativeCpuSolver:
    """ctypes wrapper for the native OpenMP parallel-MMA CPU solver.

    Deferred min-marginal-averaging with the exact semantics of the numpy
    oracle (solver/ref_solver.py) / the reference's OpenMP parallel solver
    (src/bdd_solver/bdd_parallel_mma_base.cpp:815-1044), multi-threaded over
    BDDs. Keeps a reference to the owning NativeHost so the context outlives
    the solver.
    """

    def __init__(
        self, host: NativeHost, objective: np.ndarray, nbpv=None
    ) -> None:
        """``nbpv``: optional GLOBAL per-variable BDD counts — the hybrid
        host+device split (solver/hybrid.py) passes them so this solver's
        averaging weights match the joint monolithic decomposition (ref:
        bdd_multi_parallel_mma_base.cu total_nr_bdds_per_var_)."""
        self._host = host
        self._lib = host._lib
        obj = np.ascontiguousarray(objective, dtype=np.float64)
        self._nr_vars = obj.size
        nb_ptr = None
        if nbpv is not None:
            self._nbpv = np.ascontiguousarray(nbpv, dtype=np.int32)
            assert self._nbpv.size == self._nr_vars
            nb_ptr = self._nbpv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        self._ptr = self._lib.bh_cpu_create(
            host._ctx,
            obj.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            nb_ptr,
        )
        if not self._ptr:
            raise RuntimeError(
                "native cpu solver: " + self._lib.bh_error(host._ctx).decode()
            )

    def close(self) -> None:
        if getattr(self, "_ptr", None):
            self._lib.bh_cpu_destroy(self._ptr)
            self._ptr = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass

    def iterations(self, n: int, omega: float = 0.5) -> None:
        self._lib.bh_cpu_iterations(self._ptr, int(n), float(omega))

    def lower_bound(self) -> float:
        return float(self._lib.bh_cpu_lower_bound(self._ptr))

    def lower_bound_with_deferred(self) -> float:
        return float(self._lib.bh_cpu_lower_bound_deferred(self._ptr))

    def nr_threads(self) -> int:
        return int(self._lib.bh_cpu_nr_threads(self._ptr))

    def nr_layers(self) -> int:
        return int(self._lib.bh_cpu_nr_layers(self._ptr))

    def layer_info(self):
        n = self.nr_layers()
        bdd = np.zeros(n, dtype=np.int32)
        var = np.zeros(n, dtype=np.int32)
        self._lib.bh_cpu_layer_info(
            self._ptr,
            bdd.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            var.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return bdd, var

    def costs(self):
        n = self.nr_layers()
        lo = np.zeros(n, dtype=np.float64)
        hi = np.zeros(n, dtype=np.float64)
        mm = np.zeros(n, dtype=np.float64)
        p = ctypes.POINTER(ctypes.c_double)
        self._lib.bh_cpu_get_costs(
            self._ptr,
            lo.ctypes.data_as(p),
            hi.ctypes.data_as(p),
            mm.ctypes.data_as(p),
        )
        return lo, hi, mm

    # ------- hybrid host+device consensus hooks (solver/hybrid.py) --------
    def partial_delta(self) -> np.ndarray:
        """This solver's per-variable deferred delta [V, 2] (lo, hi)."""
        out = np.zeros((self._nr_vars, 2), dtype=np.float64)
        self._lib.bh_cpu_partial_delta(
            self._ptr, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        )
        return out

    def half_iteration_ext(self, omega: float, direction: int, delta) -> None:
        """One half-sweep (+1 fwd / -1 bwd) consuming an externally combined
        [V, 2] delta instead of recomputing the local one."""
        d = np.ascontiguousarray(delta, dtype=np.float64)
        self._lib.bh_cpu_half_iteration_ext(
            self._ptr,
            float(omega),
            int(direction),
            d.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )

    def lower_bound_deferred_ext(self, delta) -> float:
        d = np.ascontiguousarray(delta, dtype=np.float64)
        return float(
            self._lib.bh_cpu_lower_bound_deferred_ext(
                self._ptr, d.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
            )
        )

    def min_marginals(self):
        """Per-layer (m0, m1) with the current costs, bdd-major order."""
        n = self.nr_layers()
        m0 = np.zeros(n, dtype=np.float64)
        m1 = np.zeros(n, dtype=np.float64)
        p = ctypes.POINTER(ctypes.c_double)
        self._lib.bh_cpu_min_marginals(
            self._ptr, m0.ctypes.data_as(p), m1.ctypes.data_as(p)
        )
        return m0, m1

    def update_costs(self, lo_per_var, hi_per_var) -> None:
        lo = np.ascontiguousarray(lo_per_var, dtype=np.float64)
        hi = np.ascontiguousarray(hi_per_var, dtype=np.float64)
        assert lo.size == self._nr_vars and hi.size == self._nr_vars
        p = ctypes.POINTER(ctypes.c_double)
        self._lib.bh_cpu_update_costs(
            self._ptr, lo.ctypes.data_as(p), hi.ctypes.data_as(p)
        )

    def distribute_delta_ext(self, delta) -> None:
        d = np.ascontiguousarray(delta, dtype=np.float64)
        self._lib.bh_cpu_distribute_delta_ext(
            self._ptr, d.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        )

    def set_costs(self, lo, hi, mm) -> None:
        """Warm-start from externally computed duals (f64 per-layer arrays in
        this solver's bdd-major layer order) — the f32->f64 escalation path."""
        n = self.nr_layers()
        lo = np.ascontiguousarray(lo, dtype=np.float64)
        hi = np.ascontiguousarray(hi, dtype=np.float64)
        mm = np.ascontiguousarray(mm, dtype=np.float64)
        assert lo.shape == (n,) and hi.shape == (n,) and mm.shape == (n,)
        p = ctypes.POINTER(ctypes.c_double)
        self._lib.bh_cpu_set_costs(
            self._ptr,
            lo.ctypes.data_as(p),
            hi.ctypes.data_as(p),
            mm.ctypes.data_as(p),
        )


def cpu_solver_from_flat(
    var, lo, hi, delim, nr_vars: int, objective, nbpv=None
) -> NativeCpuSolver:
    """Native OpenMP CPU solver over flat qbdd arrays (per-node global var +
    lo/hi as node ids or TOP=-1/BOT=-2, bdd delimiters). ``nbpv``: optional
    global per-variable BDD counts (hybrid host+device split)."""
    lib = load_library()

    class _ColHost:
        """Minimal NativeHost stand-in owning a context loaded from arrays."""

        def __init__(self) -> None:
            self._lib = lib
            self._ctx = lib.bh_create()

        close = NativeHost.close
        __del__ = NativeHost.__del__

    host = _ColHost()
    var = np.ascontiguousarray(var, dtype=np.int64)
    lo = np.ascontiguousarray(lo, dtype=np.int64)
    hi = np.ascontiguousarray(hi, dtype=np.int64)
    delim = np.ascontiguousarray(delim, dtype=np.int64)
    p = ctypes.POINTER(ctypes.c_int64)
    r = lib.bh_load_collection(
        host._ctx,
        int(nr_vars),
        len(var),
        len(delim) - 1,
        var.ctypes.data_as(p),
        lo.ctypes.data_as(p),
        hi.ctypes.data_as(p),
        delim.ctypes.data_as(p),
    )
    if r != 0:
        raise NativeUnsupported(
            "load_collection: " + lib.bh_error(host._ctx).decode()
        )
    return NativeCpuSolver(
        host, np.asarray(objective, dtype=np.float64), nbpv=nbpv
    )


def cpu_solver_from_collection(col, nr_vars: int, objective) -> NativeCpuSolver:
    """Native OpenMP CPU-baseline solver over a python-built BddCollection
    (covers instances the native parser declines: nonlinear, coalesce, OPB,
    split). The collection must be quasi-reduced with topologically ordered
    nodes (the BddPreprocessor output)."""
    return cpu_solver_from_flat(
        col.var, col.lo, col.hi, col.delim, nr_vars, objective
    )
