"""Explicit device resolution.

A scene is built on the card ("cuda") unless its caller names the CPU,
and every tensor on the render path follows that scene.  Asking for
CUDA on a machine without a card raises; it never drops to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` (str or torch.device) -> torch.device, checked.

    Raises RuntimeError for a CUDA device when no card is present or the
    index is out of range.
    """
    if device is None:
        raise ValueError("a device must be named explicitly ('cpu' or 'cuda')")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but no CUDA card is available")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {dev} requested but only {torch.cuda.device_count()} "
                "CUDA card(s) are present")
        dev = torch.device("cuda", index)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}")
    return dev
