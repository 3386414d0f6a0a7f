"""Fenced host timing of device work."""

from __future__ import annotations

import time

import torch


def fence(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_rounds(fn, device: torch.device, rounds: int = 1, warmup: bool = True):
    """-> (the last round's result, seconds per round): one warm-up call,
    then ``rounds`` back-to-back calls between two fences."""
    if warmup:
        fn()
    fence(device)
    t0 = time.perf_counter()
    out = None
    for _ in range(rounds):
        out = fn()
    fence(device)
    return out, (time.perf_counter() - t0) / rounds
