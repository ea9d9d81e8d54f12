"""Shared Krylov-solver plumbing.

Counterpart: ogl_tpu/solve/krylov.py.  Solvers are functions over vectors
parameterised by an `Ops` bundle; single-device reductions are torch.sum
and return 0-d tensors on the vectors' device (no host read).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

__all__ = ["Ops", "single_device_ops"]


@dataclasses.dataclass(frozen=True)
class Ops:
    """Device-op bundle a solver runs against.

    matvec:  x -> A @ x
    precond: r -> M^{-1} r  (identity when unpreconditioned)
    sum:     elementwise tensor -> 0-d sum
    global_size: number of DOF (for mean())
    allreduce: a stacked vector of partial sums -> the global sums; the
             grouped reductions of BiCGStab and the pipelined CG go through
             it (identity on one device, a collective in a later
             distributed layer)
    """

    matvec: Callable[[Any], Any]
    precond: Callable[[Any], Any]
    sum: Callable[[Any], Any]
    global_size: int
    allreduce: Callable[[Any], Any] = lambda v: v

    def dot(self, a, b):
        return self.sum(a * b)

    def norm1(self, a):
        return self.sum(torch.abs(a))

    def norm2(self, a):
        return torch.sqrt(self.sum(a * a))

    def mean(self, a):
        return self.sum(a) / self.global_size


def single_device_ops(matvec, n, precond=None) -> Ops:
    return Ops(
        matvec=matvec,
        precond=precond if precond is not None else (lambda r: r),
        sum=torch.sum,
        global_size=n,
    )
