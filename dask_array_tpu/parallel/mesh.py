"""Device mesh context for SPMD execution.

``use_mesh`` activates a mesh for every subsequent ``compute()``: leaf
buffers are device_put with chunk-aligned shardings, sharding constraints
are applied at layout boundaries (rechunk/shuffle), and XLA partitions the
traced program with ICI collectives (all_to_all for rechunk, psum trees for
reductions, ppermute for halos).
"""

from __future__ import annotations

import contextlib
import threading

_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


def current_mesh():
    """The active mesh, or None (single-device execution)."""
    st = _stack()
    return st[-1] if st else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate a ``jax.sharding.Mesh`` for computations in this context."""
    _stack().append(mesh)
    try:
        yield mesh
    finally:
        _stack().pop()


def set_mesh(mesh):
    """Imperatively set (or clear, with None) the process-default mesh."""
    st = _stack()
    st.clear()
    if mesh is not None:
        st.append(mesh)


#: mesh-axis names treated as inter-slice DCN fabric unless config
#: ``tpu.dcn-axes`` pins the set explicitly
DCN_AXIS_NAMES = frozenset({"dcn", "slice", "pod"})


def dcn_axis_names(mesh):
    """The mesh-axis names that cross the inter-slice DCN fabric.

    Multi-slice topologies (the scaling-book's data-parallel-over-DCN
    recipe) have one or more mesh axes whose links are ~10-100x slower than
    ICI; layout and collective scheduling treat them specially (see
    ``plan_layout`` and ``mesh_collective_relayout``).
    """
    from dask_array_tpu import config

    pinned = config.get("tpu.dcn-axes", None)
    if pinned is not None:
        return frozenset(pinned) & set(mesh.shape)
    return DCN_AXIS_NAMES & set(mesh.shape)


def multislice_mesh(n_slices, ici_axis_names=("x", "y"), devices=None):
    """Mesh over a multi-slice topology: leading ``dcn`` axis, ICI inside.

    Groups devices by their ``slice_index`` attribute when the platform
    reports one (real multi-slice pods); otherwise splits contiguously
    (virtual/CPU meshes).  Each slice's devices form a near-square ICI
    sub-mesh; the slice axis is named ``dcn`` so the layout solver and
    relayout scheduler apply the DCN discipline automatically.
    """
    import numpy as np
    import jax
    from jax.sharding import Mesh

    if devices is None:
        devices = jax.devices()
    groups = {}
    for d in devices:
        groups.setdefault(getattr(d, "slice_index", 0), []).append(d)
    if len(groups) == n_slices:
        slices = [groups[k] for k in sorted(groups)]
    else:
        if len(devices) % n_slices:
            raise ValueError(
                f"{len(devices)} devices do not split into {n_slices} slices"
            )
        per = len(devices) // n_slices
        slices = [devices[i * per : (i + 1) * per] for i in range(n_slices)]
    per = len(slices[0])
    if any(len(s) != per for s in slices):
        raise ValueError("slices have unequal device counts")
    a = int(np.sqrt(per))
    while per % a:
        a -= 1
    b = per // a
    if a == 1 or len(ici_axis_names) == 1:
        dev_array = np.asarray([list(s) for s in slices]).reshape(n_slices, per)
        return Mesh(dev_array, ("dcn", ici_axis_names[0]))
    dev_array = np.asarray([list(s) for s in slices]).reshape(n_slices, a, b)
    return Mesh(dev_array, ("dcn",) + tuple(ici_axis_names[:2]))


def auto_mesh(n_devices=None, axis_names=("x", "y"), devices=None):
    """Build a near-square 2-D mesh over the available devices."""
    import numpy as np
    import jax
    from jax.sharding import Mesh

    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    # factor n as close to square as possible
    a = int(np.sqrt(n))
    while n % a:
        a -= 1
    b = n // a
    dev_array = np.asarray(devices).reshape(a, b)
    return Mesh(dev_array, axis_names[: dev_array.ndim])
