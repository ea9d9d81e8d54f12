"""Logging/timing utilities (reference common/common.{H,C}).

Counterpart: ogl_tpu/common.py.  Leveled, field-aware log helpers
(LOG_0/1/2 equivalents keyed on the `verbose` config) and a wall-clock
timing context that prints `[OGL LOG] field: name: X [ms]` like
TIME_WITH_FIELDNAME (common.H:67-89).  CUDA work is asynchronous, so
`timed` synchronises the given CUDA device before it reads the clock at
either end: the interval then covers the device work enqueued inside it.
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["log", "timed", "Timings"]


def log(verbose: int, level: int, msg: str) -> None:
    if verbose > level:
        print(f"[OGL LOG] {msg}")


class Timings(dict):
    """Accumulates named wall-clock timings in seconds."""


def _sync(device: torch.device | None) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed(name: str, verbose: int = 0, field: str = "",
          sink: Timings | None = None, device: torch.device | None = None):
    _sync(device)
    t0 = time.perf_counter()
    yield
    _sync(device)
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + dt
    if verbose > 0:
        print(f"[OGL LOG] {field}: {name}: {dt * 1e3:.3f} [ms]")
