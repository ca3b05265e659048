"""Minimal module system for the model layers (the subset of ``flax.linen``
this package uses), so the models need nothing beyond JAX itself.

Modules are dataclasses whose fields are their hyper-parameters. Parameters
live in a nested dict keyed by module names, with the same layout
``flax.linen`` gives: an unnamed submodule is called ``<ClassName>_<n>``
within its parent, and a named one keeps its name. ``init`` builds that dict;
``apply`` reads it.

- ``@compact`` methods create submodules inline; ``setup`` creates them
  eagerly on first use of a bound module.
- ``Dense`` and ``LayerNorm`` match ``flax.linen``'s numerics (dtype
  promotion, float32 statistics with the fast variance).
- ``remat(cls, policy=...)`` runs the module under ``jax.checkpoint``.
  Arguments that are not ``jax.Array`` leaves are closed over, so tables
  and flags stay static.
- ``scan(cls, length=L)`` stacks per-layer parameters on a leading axis and
  runs the layers through ``lax.scan``; every random stream is split per
  layer, arguments after the carry are passed to every layer unchanged.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import threading
import zlib
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "Module",
    "compact",
    "Dense",
    "LayerNorm",
    "initializers",
    "remat",
    "scan",
]

initializers = jax.nn.initializers


def _hash_path(path: tuple) -> int:
    return zlib.crc32("/".join(path).encode()) & 0x7FFFFFFF


class _Root:
    """Variables and random keys shared by one ``init`` or ``apply`` call."""

    def __init__(self, params: dict, rngs: dict, initializing: bool):
        self.params = params
        self.rngs = rngs
        self.initializing = initializing
        self.rng_counts: dict = {}

    def subtree(self, path: tuple, create: bool) -> Optional[dict]:
        node = self.params
        for key in path:
            if key not in node:
                if not create:
                    return None
                node[key] = {}
            node = node[key]
        return node

    def base_key(self, kind: str, path: tuple) -> jax.Array:
        if kind not in self.rngs:
            raise ValueError(
                f"no {kind!r} random key was passed to init/apply "
                f"(needed by module {'/'.join(path) or '<root>'})"
            )
        return jax.random.fold_in(self.rngs[kind], _hash_path(path))


class _Context(threading.local):
    def __init__(self):
        self.stack: list = []


_CTX = _Context()


class _push:
    """Make ``module`` the parent of modules created in this block (None:
    create them unbound)."""

    def __init__(self, module):
        self.module = module

    def __enter__(self):
        _CTX.stack.append(self.module)

    def __exit__(self, *exc):
        _CTX.stack.pop()


def compact(fn: Callable) -> Callable:
    """Mark a method that creates its submodules inline."""
    fn._nn_compact = True
    return fn


_NOT_WRAPPED = {"setup", "param", "make_rng", "is_initializing", "init", "apply", "clone"}


def _wrap_method(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if self._nn_scope is None:
            return fn(self, *args, **kwargs)
        self._nn_setup()
        with _push(self):
            if getattr(fn, "_nn_compact", False):
                self._nn_autoname = {}
            return fn(self, *args, **kwargs)

    wrapped._nn_wrapped = True
    return wrapped


class Module:
    """Base class: subclasses become dataclasses with a keyword-only
    ``name`` field, and their public methods bind submodules to them."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        ann = cls.__dict__.get("__annotations__", {})
        for attr, value in list(cls.__dict__.items()):
            if (
                inspect.isfunction(value)
                and attr not in ann  # a field's default, not a method
                and attr not in _NOT_WRAPPED
                and (attr == "__call__" or not attr.startswith("_"))
                and not getattr(value, "_nn_wrapped", False)
            ):
                setattr(cls, attr, _wrap_method(value))
        if "name" not in ann and not any(
            f.name == "name" for f in getattr(cls, "__dataclass_fields__", {}).values()
        ):
            cls.__annotations__ = {**ann, "name": Optional[str]}
            cls.name = dataclasses.field(default=None, kw_only=True)
        dataclasses.dataclass(cls, eq=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "_nn_scope", None)
        object.__setattr__(self, "_nn_setup_done", False)
        object.__setattr__(self, "_nn_autoname", {})
        parent = _CTX.stack[-1] if _CTX.stack else None
        if parent is not None and parent._nn_scope is not None:
            name = self.name
            if name is None:
                cls_name = type(self).__name__
                n = parent._nn_autoname.get(cls_name, 0)
                parent._nn_autoname[cls_name] = n + 1
                name = f"{cls_name}_{n}"
            root, path = parent._nn_scope
            self._nn_scope = (root, path + (name,))

    # -- binding ----------------------------------------------------------
    def _nn_bound_copy(self, root: _Root, path: tuple = ()) -> "Module":
        with _push(None):
            copy = dataclasses.replace(self)
        copy._nn_scope = (root, path)
        return copy

    def _nn_setup(self) -> None:
        if self._nn_setup_done:
            return
        self._nn_setup_done = True
        with _push(self):
            self.setup()

    def setup(self) -> None:
        """Create submodules eagerly (override); runs once per binding."""

    def __getattr__(self, attr: str):
        # attributes made in setup: run it on first access of a bound module
        d = self.__dict__
        if d.get("_nn_scope") is not None and not d.get("_nn_setup_done", True):
            self._nn_setup()
            return getattr(self, attr)
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {attr!r}")

    def _nn_bound(self) -> tuple:
        if self._nn_scope is None:
            raise RuntimeError(
                f"{type(self).__name__} is not bound: call it through init/apply "
                "or from a parent module's method"
            )
        return self._nn_scope

    # -- variables --------------------------------------------------------
    def param(self, name: str, init_fn: Callable, *init_args) -> jax.Array:
        """Read (apply) or create (init) the parameter ``name``."""
        root, path = self._nn_bound()
        node = root.subtree(path, create=root.initializing)
        if node is not None and name in node:
            return node[name]
        if not root.initializing:
            raise KeyError(f"parameter {'/'.join(path + (name,))} is missing")
        node[name] = init_fn(root.base_key("params", path + (name,)), *init_args)
        return node[name]

    def make_rng(self, kind: str) -> jax.Array:
        """A fresh key of stream ``kind``, distinct per module and per call."""
        root, path = self._nn_bound()
        count = root.rng_counts.get((kind, path), 0)
        root.rng_counts[(kind, path)] = count + 1
        return jax.random.fold_in(root.base_key(kind, path), count)

    def is_initializing(self) -> bool:
        return self._nn_bound()[0].initializing

    @property
    def variables(self) -> dict:
        root, path = self._nn_bound()
        return {"params": root.subtree(path, create=False) or {}}

    # -- entry points -----------------------------------------------------
    def init(self, rngs, *args, **kwargs) -> dict:
        """Build the parameter tree by running ``__call__``."""
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        root = _Root({}, dict(rngs), initializing=True)
        bound = self._nn_bound_copy(root)
        type(self).__call__(bound, *args, **kwargs)
        return {"params": root.params}

    def apply(self, variables: dict, *args, rngs: Optional[dict] = None, **kwargs):
        """Run ``__call__`` with the parameters in ``variables``."""
        root = _Root(variables.get("params", {}), dict(rngs or {}), initializing=False)
        bound = self._nn_bound_copy(root)
        return type(self).__call__(bound, *args, **kwargs)

    def clone(self, **updates) -> "Module":
        """An unbound copy with some fields replaced."""
        with _push(None):
            return dataclasses.replace(self, **updates)


def _array_args(args: tuple, kwargs: dict):
    """Split call arguments into ``jax.Array`` leaves (traced through a
    transform) and a rebuild function that closes over everything else."""
    leaves, treedef = jax.tree_util.tree_flatten((args, kwargs))
    idx = [i for i, leaf in enumerate(leaves) if isinstance(leaf, jax.Array)]

    def rebuild(*arrays):
        full = list(leaves)
        for i, a in zip(idx, arrays):
            full[i] = a
        return jax.tree_util.tree_unflatten(treedef, full)

    return [leaves[i] for i in idx], rebuild


def remat(module_class: type, policy: Optional[Callable] = None) -> type:
    """``module_class`` whose ``__call__`` is rematerialized in the backward
    pass (``jax.checkpoint`` with ``policy``)."""
    inner_call = module_class.__call__

    def __call__(self, *args, **kwargs):
        if self.is_initializing():
            return inner_call(self, *args, **kwargs)
        arrays, rebuild = _array_args(args, kwargs)

        def body(*arrays):
            a, kw = rebuild(*arrays)
            return inner_call(self, *a, **kw)

        return jax.checkpoint(body, policy=policy)(*arrays)

    return type("Checkpoint" + module_class.__name__, (module_class,), {"__call__": __call__})


def scan(module_class: type, length: int) -> type:
    """``module_class`` applied ``length`` times to a carry: its ``__call__``
    takes ``(carry, *broadcast_args)`` and returns ``(carry, y)``; the ``y``
    stack on a leading axis like the parameters."""
    fields = [f.name for f in dataclasses.fields(module_class) if f.name != "name"]

    def __call__(self, carry, *bargs):
        root, path = self._nn_bound()
        step_kwargs = {f: getattr(self, f) for f in fields}
        with _push(None):
            step = module_class(**step_kwargs)

        def layer_rngs(i):
            return {k: jax.random.fold_in(root.base_key(k, path), i) for k in root.rngs}

        if root.initializing:
            per_layer, ys = [], []
            for i in range(length):
                sub = _Root({}, layer_rngs(i), initializing=True)
                carry, y = type(step).__call__(step._nn_bound_copy(sub), carry, *bargs)
                per_layer.append(sub.params)
                ys.append(y)
            node = root.subtree(path, create=True)
            node.update(jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per_layer))
            return carry, jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *ys)

        stacked = root.subtree(path, create=False)
        if stacked is None:
            raise KeyError(f"parameters of scanned module {'/'.join(path)} are missing")

        def body(c, inputs):
            params_i, i = inputs
            sub = _Root(params_i, layer_rngs(i), initializing=False)
            return type(step).__call__(step._nn_bound_copy(sub), c, *bargs)

        return lax.scan(body, carry, (stacked, jnp.arange(length)), length=length)

    return type("Scan" + module_class.__name__, (module_class,), {"__call__": __call__})


def _promote(*args, dtype=None):
    dtype = dtype or jnp.result_type(*(a for a in args if a is not None))
    return [None if a is None else jnp.asarray(a, dtype) for a in args]


class Dense(Module):
    """``y = x @ kernel + bias`` over the last axis (kernel (in, features),
    lecun-normal; bias zeros; float32 parameters, computed in ``dtype``)."""

    features: int
    use_bias: bool = True
    dtype: Optional[Any] = None

    @compact
    def __call__(self, x: jax.Array) -> jax.Array:
        kernel = self.param(
            "kernel", initializers.lecun_normal(), (x.shape[-1], self.features), jnp.float32
        )
        bias = (
            self.param("bias", initializers.zeros, (self.features,), jnp.float32)
            if self.use_bias
            else None
        )
        x, kernel, bias = _promote(x, kernel, bias, dtype=self.dtype)
        y = lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
        if bias is not None:
            y += jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        return y


class LayerNorm(Module):
    """Layer normalization over the last axis with float32 statistics
    (``var = E[x^2] - E[x]^2``, clipped at 0; epsilon 1e-6; float32
    scale and bias)."""

    dtype: Optional[Any] = None
    use_bias: bool = True
    use_scale: bool = True

    @compact
    def __call__(self, x: jax.Array) -> jax.Array:
        stat_dtype = jnp.promote_types(self.dtype or x.dtype, jnp.float32)
        xf = x.astype(stat_dtype)
        mean = xf.mean(-1, keepdims=True)
        mean2 = lax.square(xf).mean(-1, keepdims=True)
        var = jnp.maximum(0.0, mean2 - lax.square(mean))
        y = x - mean
        mul = lax.rsqrt(var + 1e-6)
        out_args = [x]
        if self.use_scale:
            scale = self.param("scale", initializers.ones, (x.shape[-1],), jnp.float32)
            mul *= scale
            out_args.append(scale)
        y *= mul
        if self.use_bias:
            bias = self.param("bias", initializers.zeros, (x.shape[-1],), jnp.float32)
            y += bias
            out_args.append(bias)
        return jnp.asarray(y, self.dtype or jnp.result_type(*out_args))
