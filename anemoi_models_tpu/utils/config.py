"""Configuration utilities: DotDict + registry-based instantiate.

Replacement for the reference's OmegaConf/DotDict + hydra
``instantiate`` combination (see reference ``interface/__init__.py:76-92`` and
``models/encoder_processor_decoder.py:69-106``). We keep the same config
surface — nested dicts with ``_target_`` entries naming the class to build —
but resolve targets through a light registry + importlib instead of hydra,
so the framework has no heavyweight config dependencies.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable

__all__ = ["DotDict", "as_dotdict", "instantiate", "register", "resolve_target"]


class DotDict(dict):
    """A dict with attribute access, recursively applied to nested dicts.

    Mirrors the behavior of ``anemoi.utils.config.DotDict`` used throughout the
    reference configs, without the external dependency.
    """

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        for key, value in list(self.items()):
            self[key] = self._wrap(value)

    @classmethod
    def _wrap(cls, value: Any) -> Any:
        if isinstance(value, DotDict):
            return value
        if isinstance(value, dict):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return type(value)(cls._wrap(v) for v in value)
        return value

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = self._wrap(value)

    def __setitem__(self, name: Any, value: Any) -> None:
        super().__setitem__(name, self._wrap(value))

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def to_dict(self) -> dict:
        """Deep-convert back to plain dicts/lists."""

        def unwrap(value: Any) -> Any:
            if isinstance(value, dict):
                return {k: unwrap(v) for k, v in value.items()}
            if isinstance(value, (list, tuple)):
                return type(value)(unwrap(v) for v in value)
            return value

        return unwrap(dict(self))


def as_dotdict(config: Any) -> "DotDict":
    """Deep-convert any Mapping (incl. flax FrozenDict) into a DotDict."""
    from collections.abc import Mapping

    def unwrap(value: Any) -> Any:
        if isinstance(value, Mapping):
            return {k: unwrap(v) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return type(value)(unwrap(v) for v in value)
        return value

    return DotDict(unwrap(config))


# --------------------------------------------------------------------------
# Registry-based instantiate
# --------------------------------------------------------------------------

_REGISTRY: dict[str, Callable] = {}

# The reference configs use ``anemoi.models.*`` target paths; map them onto
# this package so existing configs keep working unmodified.
_TARGET_ALIASES = {
    "anemoi.models.": "anemoi_models_tpu.",
}


def register(name: str) -> Callable[[Callable], Callable]:
    """Decorator registering a callable under an explicit target name."""

    def deco(fn: Callable) -> Callable:
        _REGISTRY[name] = fn
        return fn

    return deco


def resolve_target(target: str) -> Callable:
    """Resolve a ``_target_`` string to a callable.

    Resolution order: explicit registry, alias rewrite, dotted import path.
    """
    if target in _REGISTRY:
        return _REGISTRY[target]
    for prefix, replacement in _TARGET_ALIASES.items():
        if target.startswith(prefix):
            aliased = replacement + target[len(prefix):]
            if aliased in _REGISTRY:
                return _REGISTRY[aliased]
            target = aliased
            break
    module_name, _, attr = target.rpartition(".")
    if not module_name:
        raise ValueError(f"Cannot resolve instantiate target {target!r}")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def instantiate(config: Any, *args: Any, **kwargs: Any) -> Any:
    """Instantiate an object from a config with a ``_target_`` entry.

    Non-recursive by default (matching the reference's ``_recursive_=False``
    usage): nested dicts are passed through as configs so the instantiated
    object can itself call ``instantiate`` on them.
    """
    if config is None:
        raise ValueError("instantiate() called with None config")
    cfg = dict(config)
    cfg.pop("_recursive_", None)
    cfg.pop("_convert_", None)
    target = cfg.pop("_target_", None)
    if target is None:
        raise ValueError(f"Config has no _target_ entry: {config}")
    fn = resolve_target(target)
    merged = {**cfg, **kwargs}
    return fn(*args, **merged)
