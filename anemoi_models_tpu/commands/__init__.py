"""CLI command registry.

Counterpart of reference ``commands/__init__.py`` + ``__main__.py``: an
argparse-based registry. Beyond the reference's placeholder ``hello``
(``commands/hello.py:12-32``), this CLI exposes real subcommands: ``info``
(environment/device report) and ``bench`` (run the standard benchmark).
"""

from __future__ import annotations

import argparse
from typing import Callable

__all__ = ["COMMANDS", "register_command", "main"]

COMMANDS: dict[str, Callable[[argparse.ArgumentParser], None]] = {}


def register_command(name: str):
    def deco(cls):
        COMMANDS[name] = cls()
        return cls

    return deco


from anemoi_models_tpu.commands import bench, evaluate, hello, info, predict, train, train_demo  # noqa: E402,F401


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="anemoi-models-tpu")
    sub = parser.add_subparsers(dest="command", required=True)
    for name, cmd in COMMANDS.items():
        p = sub.add_parser(name, help=cmd.__doc__)
        cmd.add_arguments(p)
    args = parser.parse_args(argv)
    from anemoi_models_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    return COMMANDS[args.command].run(args) or 0
