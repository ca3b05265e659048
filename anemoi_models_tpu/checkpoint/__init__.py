"""Checkpoint save/restore.

The reference repo only *hooks* checkpointing (``interface/__init__.py:40-41,
64-69`` carries metadata/supporting_arrays/uuid; actual save/load lives in
anemoi-training). Here the framework owns it: parameters + stateful processor
buffers (the persistent-buffer inclusion semantics of ``normalizer.py:104-107``
and ``imputer`` state) go to ``arrays.npz``, one entry per leaf, with each
leaf's tree path and dtype in ``arrays.json``; metadata/config/uuid go to a
JSON sidecar; supporting arrays to an ``.npz``. Values round-trip bit for
bit, bfloat16 included (stored as its raw 16-bit pattern).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Optional

import jax
import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint"]

LOGGER = logging.getLogger(__name__)

# format history:
# 1 — initial layout (round 1/2)
# 2 — kv_src_gather='auto' moved the forward mapper's emb_nodes_src from the
#     mapper scope into the block ('proc') scope on the default dense path;
#     load_checkpoint migrates either direction automatically (see
#     _migration_aliases), so v1 checkpoints stay restorable.
FORMAT_VERSION = 2


def _migration_aliases(keys: tuple) -> list[tuple]:
    """Alternate storage paths for a target path across format versions.

    The only structural move so far is emb_nodes_src crossing the
    mapper/'proc' scope boundary (format 1 → 2): a narrow-layout target finds
    a wide-layout save by dropping the 'proc' scope, and vice versa.
    """
    aliases = []
    for i, key in enumerate(keys):
        if key == "emb_nodes_src":
            if i > 0 and keys[i - 1] == "proc":
                aliases.append(keys[: i - 1] + keys[i:])
            aliases.append(keys[:i] + ("proc",) + keys[i:])
    return aliases


def _path_keys(path) -> tuple:
    """jax keypath → plain dict/list keys (GetAttrKey covers namedtuples)."""
    keys = []
    for entry in path:
        for attr in ("key", "name", "idx"):
            if hasattr(entry, attr):
                keys.append(getattr(entry, attr))
                break
        else:
            raise KeyError(f"unsupported tree path entry {entry!r}")
    return tuple(keys)


def _lookup(raw: Any, keys: tuple) -> Any:
    """Walk plain restored containers; an untargeted restore keeps
    sequence/namedtuple positions under string keys, so fall back to
    str(key)."""
    node = raw
    for key in keys:
        try:
            node = node[key]
        except (KeyError, IndexError, TypeError):
            node = node[str(key)]
    return node


def _migrate_restore(raw: Any, target: Any) -> Any:
    """Fill ``target``'s structure from an untargeted restore, applying the
    known cross-version path moves where the direct path is absent."""
    path_leaves, treedef = jax.tree_util.tree_flatten_with_path(target)
    values, moved = [], 0
    for path, _ in path_leaves:
        keys = _path_keys(path)
        try:
            values.append(_lookup(raw, keys))
            continue
        except (KeyError, IndexError, TypeError):
            pass
        for alias in _migration_aliases(keys):
            try:
                values.append(_lookup(raw, alias))
                moved += 1
                break
            except (KeyError, IndexError, TypeError):
                continue
        else:
            raise KeyError(
                f"checkpoint restore: no stored array at {keys} (or any known "
                "migration alias); the checkpoint does not match the target tree"
            )
    if moved:
        LOGGER.warning(
            "checkpoint migration: relocated %d emb_nodes_src array(s) across "
            "the mapper/proc scope boundary (format 1 -> 2 layout change)",
            moved,
        )
    return jax.tree_util.tree_unflatten(treedef, values)


def _write_arrays(path: str, tree: Any) -> None:
    """Leaves to ``arrays.npz`` (entries ``a0, a1, ...``), their paths and
    dtypes to ``arrays.json``; both written to temporary names first and
    renamed, so an interrupted save leaves the previous checkpoint whole."""
    index, arrays = [], {}
    for i, (kp, leaf) in enumerate(jax.tree_util.tree_leaves_with_path(tree)):
        value = np.asarray(jax.device_get(leaf))
        keys = [[type(k).__name__ == "int", k] for k in _path_keys(kp)]
        index.append({"path": keys, "dtype": str(value.dtype)})
        if value.dtype.type.__module__ != "numpy":  # e.g. bfloat16: raw bits
            value = value.view(np.dtype(f"u{value.dtype.itemsize}"))
        arrays[f"a{i}"] = value
    tmp_npz = os.path.join(path, "arrays.tmp.npz")
    np.savez(tmp_npz, **arrays)
    tmp_json = os.path.join(path, "arrays.tmp.json")
    with open(tmp_json, "w") as f:
        json.dump(index, f)
    os.replace(tmp_npz, os.path.join(path, "arrays.npz"))
    os.replace(tmp_json, os.path.join(path, "arrays.json"))


def _read_arrays(path: str) -> dict:
    """Nested dicts of the stored leaves (sequence positions as str keys)."""
    with open(os.path.join(path, "arrays.json")) as f:
        index = json.load(f)
    out: dict = {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for i, entry in enumerate(index):
            value = z[f"a{i}"]
            dtype = jax.numpy.dtype(entry["dtype"])
            if value.dtype != dtype:
                value = value.view(dtype)
            node = out
            keys = [str(k) for _, k in entry["path"]]
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = value
    return out


def _like(value: np.ndarray, target: Any) -> Any:
    value = np.asarray(value, dtype=getattr(target, "dtype", value.dtype))
    if isinstance(target, jax.Array):
        return jax.device_put(value, target.sharding)
    return value


def save_checkpoint(
    path: str,
    *,
    params: Any,
    processor_state: Optional[dict] = None,
    opt_state: Any = None,
    step: Optional[int] = None,
    metadata: Optional[dict] = None,
    config: Optional[dict] = None,
    supporting_arrays: Optional[dict] = None,
    run_id: Optional[str] = None,
) -> str:
    """Write a checkpoint directory; returns the path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)

    tree = {"params": params}
    if processor_state:
        tree["processor_state"] = processor_state
    if opt_state is not None:
        tree["opt_state"] = opt_state

    _write_arrays(path, tree)

    sidecar = {
        "step": step,
        "metadata": metadata or {},
        "config": config or {},
        "run_id": run_id,
        "format_version": FORMAT_VERSION,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(sidecar, f, default=str)

    if supporting_arrays:
        np.savez(os.path.join(path, "supporting_arrays.npz"), **supporting_arrays)
    return path


def load_checkpoint(path: str, target: Any = None) -> dict:
    """Restore a checkpoint directory into a dict.

    ``target``: optional pytree of matching structure (e.g.
    ``{"params": ..., "opt_state": ...}``) for sharded/layout-aware restore.
    A structure mismatch falls back to an untargeted restore with the known
    cross-version migrations applied (see ``_migration_aliases``), so
    format-1 checkpoints restore into format-2 parameter trees and back.
    """
    path = os.path.abspath(path)
    raw = _read_arrays(path)
    if target is not None:
        tree = _migrate_restore(raw, target)
        # each leaf takes the target's dtype and device layout (sharded
        # targets restore sharded)
        tree = jax.tree_util.tree_map(_like, tree, target)
    else:
        tree = raw

    out = dict(tree)
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            out.update(json.load(f))
    sup_path = os.path.join(path, "supporting_arrays.npz")
    if os.path.exists(sup_path):
        with np.load(sup_path) as z:
            out["supporting_arrays"] = {k: z[k] for k in z.files}
    return out
