"""Device-persistence registry — the analogue of DevicePersistent.

Counterpart: ogl_tpu/registry.py, carried over unchanged.  In the PyTorch
port the cached device objects are torch tensors resident on the solver's
device between solves; the JAX wording below is the original's.

The reference caches every expensive device object (sparsity arrays,
distributed matrix, vectors, preconditioners, executor handles) in
OpenFOAM's objectRegistry keyed by field name, so steady-state solves only
re-upload coefficients (reference DevicePersistent/Base/Base.H:75-115;
caching story in SURVEY.md §3.2).  On TPU the analogue is a process-level
cache of jax.Arrays (HBM-resident between solves) plus compiled-function
reuse (jit caches on static sparsity), and a small property store carrying
cross-solve scalars (prevSolveIters, residual-eval cost ratio,
preconditioner TTL — reference common/common.C:75-146).
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["Registry", "global_registry", "SolverProperties"]


class SolverProperties:
    """Per-field cross-solve scalar state (reference `<field>_gkoSolverProperties`
    IOdictionary, common/common.C:75-146)."""

    def __init__(self):
        self.prev_solve_iters: int = 0
        self.prev_rel_res_cost: float = 1.0
        self.precond_caching_left: int = 0
        self.init_residual: float = 0.0
        self.final_residual: float = 0.0


class Registry:
    """Keyed object cache with get-or-init and explicit update semantics
    (reference PersistentBase: init on miss, update() on hit-with-update,
    Base.H:84-115)."""

    def __init__(self):
        self._store: dict[str, Any] = {}
        self._props: dict[str, SolverProperties] = {}

    def get_or_init(self, key: str, init: Callable[[], Any]) -> Any:
        if key not in self._store:
            self._store[key] = init()
        return self._store[key]

    def get(self, key: str, default=None):
        return self._store.get(key, default)

    def put(self, key: str, value: Any) -> None:
        self._store[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._store

    def pop(self, key: str, default=None):
        return self._store.pop(key, default)

    def clear(self) -> None:
        self._store.clear()
        self._props.clear()

    def properties(self, field: str) -> SolverProperties:
        if field not in self._props:
            self._props[field] = SolverProperties()
        return self._props[field]


global_registry = Registry()
