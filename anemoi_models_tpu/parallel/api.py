"""Device-mesh context + sharding-constraint API.

The replacement for the reference's "model comm group" plumbing
(``distributed/primitives.py``, ``distributed/graph.py``): instead of
threading a ProcessGroup through every forward and hand-writing collective
autograd Functions, model code annotates tensors with named-sharding
constraints against an ambient ``jax.sharding.Mesh`` and GSPMD inserts the
collectives (all-gather/all-to-all/reduce-scatter) with adjoints derived by
JAX AD.

Axis convention:
- ``data``  — batch/ensemble axis (the reference delegates this to DDP)
- ``model`` — the spatial/grid (sequence) axis within one model instance
  (the reference's sequence sharding, ``distributed/graph.py:140-298``)

When no mesh is active (single device, unit tests), ``constrain`` is the
identity — the analogue of the reference's ``model_comm_group=None``
short-circuit (``primitives.py:42-44``).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["set_mesh", "get_mesh", "use_mesh", "constrain", "make_mesh", "make_hybrid_mesh", "batch_sharding"]

_MESH: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Install (or clear, with None) the ambient device mesh."""
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _MESH


@contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Scoped mesh installation."""
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def make_mesh(
    data: int = 1,
    model: int = 1,
    *,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (data, model) mesh over the available devices.

    A plain row-major reshape of JAX's device order: the cards of one host
    reach each other all to all over NVLink at one rate, so the mesh
    follows the algorithm alone. Within a host the model axis holds
    consecutive devices; across hosts, the data axis.
    """
    devices = list(devices if devices is not None else jax.devices())
    assert data * model <= len(devices), (
        f"Mesh {data}x{model} needs {data * model} devices, have {len(devices)}"
    )
    dev_array = np.array(devices[: data * model]).reshape(data, model)
    return Mesh(dev_array, axis_names=("data", "model"))


def constrain(x: jax.Array, spec: Sequence[Optional[str]]) -> jax.Array:
    """Attach a NamedSharding constraint if a mesh is active; else identity.

    Axis names absent from the active mesh are dropped to None so the same
    model code runs on 1-axis meshes.
    """
    mesh = _MESH
    if mesh is None:
        return x
    names = set(mesh.axis_names)
    cleaned = tuple(a if (a is None or a in names) else None for a in spec)
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, PartitionSpec(*cleaned)))


def batch_sharding(x_ndim: int, batch_axis: int = 0) -> Sequence[Optional[str]]:
    """Spec sharding only the batch axis on "data"."""
    return tuple("data" if i == batch_axis else None for i in range(x_ndim))


def make_hybrid_mesh(
    hosts: int,
    data_per_host: int = 1,
    model: int = 1,
) -> Mesh:
    """Multi-host mesh: the data axis spans hosts (and ``data_per_host``
    groups within each), the model axis stays inside one host's NVLink
    domain — the reference's intent of one model instance per
    tightly-coupled group (SURVEY.md §2.3) at cluster scale.

    JAX orders devices host by host, so consecutive devices share a host and
    a row-major reshape keeps each model group on one host; the two data
    factors are flattened into one "data" axis.
    """
    devices = jax.devices()
    n = hosts * data_per_host * model
    if len(devices) < n:
        raise ValueError(f"hybrid mesh needs {n} devices, have {len(devices)}")
    devices = np.asarray(devices[:n]).reshape(hosts * data_per_host, model)
    return Mesh(devices, axis_names=("data", "model"))
