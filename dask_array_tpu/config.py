"""Two-tier configuration: process-global defaults + context-local overrides.

Mirrors the role of ``dask.config`` in the reference (keys registered at
import in ``/root/reference/dask_array/__init__.py:21-29``), extended with
execution keys (mesh/layout/jit flags) under the ``tpu.`` prefix.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any

_global: dict[str, Any] = {
    # -- optimizer / planner (reference-parity keys) --
    "array.rechunk.threshold": 32,
    # "auto": explicit all_to_all when a mesh axis moves between array axes,
    # constraint otherwise; "tasks": never explicit; "collective"/"p2p":
    # always attempt the explicit schedule
    "array.rechunk.method": "auto",
    "array.rechunk.degree-limit": None,
    "array.unify-chunks-policy": "auto",  # "auto" | "coarse" | "refine"
    "array.unify-chunks-limit": "512 MiB",
    "array.chunk-size": "128 MiB",
    "array.chunk-size-tolerance": 1.25,
    "array.optimize-graph": True,
    "split_every": None,
    # -- execution --
    "tpu.jit": True,              # trace+jit whole lowered tree when possible
    "tpu.donate-leaves": False,   # donate leaf buffers into the jitted call
    "tpu.default-float": None,    # override default float dtype (e.g. "float32")
    "tpu.matmul-precision": "highest",  # jax.lax precision for contractions
    # PRNG implementation for random leaves: "rbg" | "threefry2x32"; both are
    # deterministic per (seed, chunk grid)
    "tpu.prng-impl": "rbg",
    # float64 samples are drawn at float32 and upcast ("float32"), or at the
    # requested precision ("native")
    "tpu.random-precision": "float32",
    # tall-skinny QR factorization: "cholqr2" (matmuls and one small
    # Cholesky per pass) | "householder" (XLA's QR per row block; bitwise-
    # stable for ill-conditioned inputs)
    "tpu.qr-method": "cholqr2",
    # small/in-core SVD kernel: "eigh" (Gram eigendecomposition) | "jacobi"
    # (jnp.linalg.svd)
    "tpu.svd-method": "eigh",
    # precision of the BIG (n x n via m-deep) Gram products inside
    # CholeskyQR passes: "highest" (full f32) | "high" (fewer bf16 passes).
    # The tall A @ R^-1 legs keep "highest" regardless
    "tpu.gram-precision": "highest",
    # map_overlap execution: "auto" = per-block halos (GSPMD inserts the
    # collective-permutes); "shard" = one shard_map stencil with an explicit
    # minimal ppermute ring per sharded halo axis (assumes the map_overlap
    # locality contract; see ops/_overlap.ShardStencil)
    "tpu.overlap-method": "auto",
    # mesh axes that ride the slow inter-slice DCN fabric instead of ICI
    # (multi-slice topologies).  None = auto-detect by name ("dcn"/"slice"/
    # "pod"); a tuple pins them explicitly.  DCN axes get a stable,
    # chunk-grid-independent array-axis assignment (so relayouts never move
    # data across slices) and relayout schedules order DCN stages last.
    "tpu.dcn-axes": None,
}

_local = threading.local()

# bumped on every mutation: optimization caches key on this so a config
# change (unify policy, rechunk method, ...) invalidates cached plans
_epoch = 0


def epoch() -> int:
    return _epoch


def _bump() -> None:
    global _epoch
    _epoch += 1


def _overrides() -> list[dict]:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def get(key: str, default: Any = None) -> Any:
    for layer in reversed(_overrides()):
        if key in layer:
            return layer[key]
    return _global.get(key, default)


def set_global(values: dict[str, Any]) -> None:
    _global.update(values)
    _bump()


_MISSING = object()


class set(contextlib.AbstractContextManager):
    """``with config.set({"array.rechunk.threshold": 4}): ...``

    Applies the values to the global layer immediately (imperative use); when
    used as a context manager, the previous values are restored on exit.
    """

    def __init__(self, values: dict[str, Any] | None = None, **kwargs):
        vals = dict(values or {})
        # dask-style keyword form: array__rechunk__threshold=4 means
        # "array.rechunk.threshold"; remaining single underscores map to
        # hyphens ONLY when that spelling is the registered key (some keys,
        # like "split_every", are canonically underscored)
        for k, v in kwargs.items():
            key = k.replace("__", ".")
            hyphened = key.replace("_", "-")
            if key not in _global and hyphened in _global:
                key = hyphened
            vals[key] = v
        self._saved = {k: _global.get(k, _MISSING) for k in vals}
        _global.update(vals)
        _bump()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for k, old in self._saved.items():
            if old is _MISSING:
                _global.pop(k, None)
            else:
                _global[k] = old
        _bump()
        return False


@contextlib.contextmanager
def scoped(values: dict[str, Any]):
    """Context-scoped override (thread-local)."""
    stack = _overrides()
    stack.append(dict(values))
    _bump()
    try:
        yield
    finally:
        stack.pop()
        _bump()
