"""Parameter / optimizer-state sharding (ZeRO-1 and FSDP-style).

The reference holds full weights and full Adam moments on every rank
(SURVEY §2.2: "TP absent — every rank holds full weights"; all Linear
layers unsharded, reference ``layers/block.py:333-341``) and leaves
optimizer memory to the external trainer. At AIFS production widths the
replicated params and fp32 Adam moments are pure per-device overhead of
a sharded O1280 train step.

The answer here: express the memory optimization as *shardings*, not new
collectives. Each large array leaf is assigned a
:class:`~jax.sharding.NamedSharding` that splits its largest divisible
dimension over a mesh axis; GSPMD then inserts the ZeRO collectives
automatically with AD-derived adjoints:

- ``"zero1"``  — parameters stay replicated; Adam moments (and any other
  large optimizer leaves) are sharded. The per-shard moment update reads a
  dynamic slice of the (replicated) gradient; ``optax.apply_updates`` emits
  one all-gather of the *updates* per step — exactly ZeRO stage 1 dataflow,
  for free. Saves ``2 x params x (N-1)/N`` bytes of fp32 moments.
- ``"fsdp"``   — parameters AND moments sharded. Each weight is all-gathered
  at its use site in forward/backward (and re-gathered under remat), the
  update never leaves the shard. Saves ``3 x params x (N-1)/N`` at the cost
  of per-layer weight all-gathers — the right trade once replicated params
  themselves pressure device memory, or when the data axis is wide and
  the gathers ride NVLink.

The axis is configurable: over ``"data"`` this is classic ZeRO/FSDP over
data-parallel replicas; over ``"model"`` it composes with the grid-sharded
(sequence-parallel) execution, where the weights are the only remaining
replicated state.
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = [
    "array_shardings",
    "train_state_shardings",
    "shard_train_state",
]

# leaves smaller than this many elements stay replicated: sharding tiny
# vectors (biases, LN scales) buys nothing and costs collective launches
DEFAULT_MIN_SIZE = 2**15


def _leaf_spec(shape: tuple, axis_size: int, axis_name: str, min_size: int) -> PartitionSpec:
    """Shard the largest dimension divisible by ``axis_size``; replicate if
    none qualifies or the leaf is small."""
    if int(np.prod(shape, dtype=np.int64)) < min_size:
        return PartitionSpec()
    dims = sorted(range(len(shape)), key=lambda d: shape[d], reverse=True)
    for d in dims:
        if shape[d] % axis_size == 0 and shape[d] >= axis_size:
            spec = [None] * len(shape)
            spec[d] = axis_name
            return PartitionSpec(*spec)
    return PartitionSpec()


def array_shardings(
    tree: Any,
    mesh: Mesh,
    axis: str = "data",
    min_size: Optional[int] = None,
    replicate: bool = False,
) -> Any:
    """A pytree of :class:`NamedSharding` matching ``tree``.

    ``replicate=True`` returns fully-replicated shardings (used for the
    params leg of ``"zero1"`` so donation keeps buffer layouts stable).
    """
    if min_size is None:
        min_size = DEFAULT_MIN_SIZE
    axis_size = int(mesh.shape[axis])

    def leaf_sharding(leaf):
        shape = getattr(leaf, "shape", ())
        if replicate or not shape or axis_size == 1:
            return NamedSharding(mesh, PartitionSpec())
        return NamedSharding(mesh, _leaf_spec(tuple(shape), axis_size, axis, min_size))

    return jax.tree_util.tree_map(leaf_sharding, tree)


def train_state_shardings(
    state: Any,
    mesh: Mesh,
    mode: str = "zero1",
    axis: str = "data",
    min_size: Optional[int] = None,
) -> Any:
    """Shardings for a :class:`~anemoi_models_tpu.training.step.TrainState`.

    ``mode``: ``"zero1"`` (replicated params, sharded moments) or ``"fsdp"``
    (params and moments both sharded). The step counter and any scalar
    optimizer leaves are always replicated.
    """
    if mode not in ("zero1", "fsdp"):
        raise ValueError(f"param sharding mode {mode!r}: expected 'zero1' or 'fsdp'")
    params_sh = array_shardings(
        state.params, mesh, axis=axis, min_size=min_size, replicate=(mode == "zero1")
    )
    opt_sh = array_shardings(state.opt_state, mesh, axis=axis, min_size=min_size)
    step_sh = NamedSharding(mesh, PartitionSpec())
    return type(state)(params=params_sh, opt_state=opt_sh, step=step_sh)


def shard_train_state(
    state: Any,
    mesh: Mesh,
    mode: str = "zero1",
    axis: str = "data",
    min_size: Optional[int] = None,
    ema: Optional[Any] = None,
):
    """Place ``state`` (and optionally an EMA params tree) onto ``mesh``
    under the requested sharding. Returns ``(state, ema, state_shardings,
    ema_shardings)`` — pass the sharding trees as the jitted step's
    in/out shardings so every step consumes and produces the same layout
    (donation then reuses the buffers in place)."""
    sh = train_state_shardings(state, mesh, mode=mode, axis=axis, min_size=min_size)
    state = jax.device_put(state, sh)
    ema_sh = None
    if ema is not None:
        # EMA mirrors the params: replicated under zero1, sharded under fsdp
        ema_sh = array_shardings(
            ema, mesh, axis=axis, min_size=min_size, replicate=(mode == "zero1")
        )
        ema = jax.device_put(ema, ema_sh)
    return state, ema, sh, ema_sh
