"""ogl_tpu_torch — the PyTorch/CUDA port of ogl_tpu.

Counterpart: ogl_tpu/__init__.py.  The JAX package `ogl_tpu` stays the
reference; this package runs the same solver front end on torch tensors,
with every kernel of its path written by hand for NVIDIA Hopper in CUDA
C++ for sm_90a.  It imports torch and numpy and never jax or ogl_tpu.

Slices covered so far: the GKOCG pressure solve — OpenFOAM LDU ingest,
the Dia, Gdia and Xell formats with the reference's auto-routing between
them (and `reorder rcm`), the delta-gated coefficient upload, and the
merged two-kernel CG with the OpenFOAM stopping criterion, preconditioner
`none`, scalar `BJ` or `Multigrid` (AMG, Dia only) — GKOMultigrid, the
pipelined GKOCG (`pipelinedCG true`) and GKOBiCGStab on symmetric and
asymmetric matrices (merged with `fusedBiCGStab true`), GKOGMRES, blocked
`BJ` and ISAI/GISAI (over the native host runtime, native/); float32, one
device.  Controls outside those slices raise NotImplementedError (see
ogl_tpu_torch.foam.solver).  The measurement path of the reference's
bench: kernels/roofline.py (the read-peak kernel, chained timing over
CUDA graphs), kernels/device_time.py (device busy time from
torch.profiler) and bench.py, the headline lanes (`python -m
ogl_tpu_torch.bench`).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

__all__ = ["device_for", "__version__"]

_HOST_EXECUTORS = ("reference", "omp", "cpu")
_ACCELERATOR_EXECUTORS = ("cuda", "tpu", "hip", "dpcpp")


def device_for(executor: str) -> torch.device:
    """The torch device an fvSolution `executor` keyword selects
    (counterpart of ogl_tpu/foam/solver.py `_device_for`).

    reference/omp/cpu run on the host; every accelerator executor —
    including the default `tpu`, so an unchanged fvSolution runs on the
    card — maps to the CUDA device.  Without CUDA an accelerator executor
    raises: it never quietly falls back to the CPU."""
    if executor in _HOST_EXECUTORS:
        return torch.device("cpu")
    if executor in _ACCELERATOR_EXECUTORS:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"executor '{executor}' needs a CUDA device, and torch "
                "reports none; use executor cpu to run on the host")
        return torch.device("cuda")
    raise ValueError(
        f"unknown executor {executor!r}; valid: "
        f"{_HOST_EXECUTORS + _ACCELERATOR_EXECUTORS}")
