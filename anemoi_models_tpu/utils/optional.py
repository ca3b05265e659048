"""Packages that only some data readers need, imported when first used."""

from __future__ import annotations

import importlib
from types import ModuleType

__all__ = ["optional_import"]


def optional_import(name: str, purpose: str) -> ModuleType:
    """Import ``name``, or raise an ImportError that says what needs it."""
    try:
        return importlib.import_module(name)
    except ImportError as exc:
        raise ImportError(
            f"{purpose} needs the optional package {name!r}, which is not installed "
            f"(pip install {name})"
        ) from exc
