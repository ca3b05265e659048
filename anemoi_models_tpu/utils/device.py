"""What a measurement ran on: the JAX device and the card's power limit.

Every reported time names its device, and a GPU time also names the card's
power limit: a card set below its maximum holds lower clocks under load.
"""

from __future__ import annotations

import subprocess

import jax

__all__ = ["NVIDIA_SMI_QUERY", "device_report", "gpu_name_and_power_limit", "parse_nvidia_smi"]

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]


def parse_nvidia_smi(text: str) -> list[tuple[str, str]]:
    """``name, power.limit`` CSV lines -> [(name, power limit)], one per card."""
    cards = []
    for line in text.strip().splitlines():
        name, sep, limit = line.rpartition(",")
        if not sep or not name.strip() or not limit.strip():
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append((name.strip(), limit.strip()))
    if not cards:
        raise ValueError("nvidia-smi listed no card")
    return cards


def gpu_name_and_power_limit() -> tuple[str, str]:
    """(name, power limit) of the first card, as ``nvidia-smi`` reports them."""
    out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True, check=True, timeout=60)
    return parse_nvidia_smi(out.stdout)[0]


def device_report() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    devices = jax.devices()
    return {"platform": devices[0].platform, "kind": devices[0].device_kind, "count": len(devices)}
