"""Dia (stencil) SpMV: the CUDA C++ kernel `csrc/dia_spmv.cu` (row body
`csrc/dia_rows.cuh`, in row quads) and its plain PyTorch twin.

Counterpart: ogl_tpu/kernels/pallas_spmv.py (`_kernel`, `dia_matvec`,
`dia_spmv`).  The port keeps vectors flat — (n,) float32 — and the Dia
data as a contiguous (nd, n) float32 tensor, so no padded (R, 128) view
or halo frame exists here.

`dia_spmv(plan, data, x)` launches the kernel for CUDA tensors and runs
`dia_spmv_plain` only for tensors on the CPU; on a CUDA tensor it never
falls back, it raises on a wrong device, dtype, shape or contiguity and on
a refused launch.
"""

from __future__ import annotations

import functools

import torch

from ogl_tpu_torch import kernels
from ogl_tpu_torch.kernels import _build

__all__ = ["DiaPlan", "dia_spmv", "dia_spmv_plain", "THREADS", "MAX_DIAGS",
           "SPMV_BLOCKS_PER_SM", "check_operands", "stream_of", "on_cpu", "require_cuda",
           "check_scalar", "sm_count", "persistent_launch"]

THREADS = 256  # threads per block of the standalone kernels
MAX_DIAGS = 64  # the kernels stage the offsets in a 64-entry shared array
# the SpMV's grid cap, blocks of THREADS per SM: one row quad per thread up to
# 8.4M rows (as K1B's and K2's, kernels/fused.py K2_BLOCKS_PER_SM)
SPMV_BLOCKS_PER_SM = 64


class DiaPlan:
    """Static structure of a Dia matrix on one device: n, the host offsets
    tuple and the same offsets as an int32 device tensor (what the CUDA
    kernels read).  Values are not part of the plan, so one plan serves
    every coefficient update of the same sparsity."""

    def __init__(self, n: int, offsets, device: torch.device | str):
        self.n = int(n)
        self.offsets = tuple(int(o) for o in offsets)
        if len(self.offsets) > MAX_DIAGS:
            raise ValueError(
                f"{len(self.offsets)} diagonals: the Dia kernels take at most {MAX_DIAGS}")
        self.offsets_dev = torch.tensor(self.offsets, dtype=torch.int32,
                                        device=device)
        self.device = self.offsets_dev.device  # resolved: cuda -> cuda:0

    @classmethod
    def of(cls, mat) -> "DiaPlan":
        return cls(mat.shape[0], mat.offsets, mat.data.device)


def dia_spmv_plain(data: torch.Tensor, offsets, x: torch.Tensor) -> torch.Tensor:
    """y = Σ_k data[k] ⊙ x[i + offsets[k]] (zero outside [0, n)), summed in
    offset order — the reference's `spmv_dia`."""
    n = x.shape[0]
    offs = tuple(offsets)
    lo = max(0, -min(offs)) if offs else 0
    hi = max(0, max(offs)) if offs else 0
    xp = torch.nn.functional.pad(x, (lo, hi))
    y = torch.zeros_like(x)
    for k, off in enumerate(offs):
        y = y + data[k] * xp[lo + off: lo + off + n]
    return y


def check_operands(plan: DiaPlan, data: torch.Tensor | None,
                   *vectors: torch.Tensor,
                   data_dtypes: tuple = (torch.float32,)) -> None:
    """Raise unless data (when given) is a contiguous (nd, n) tensor of one
    of `data_dtypes` and every vector a contiguous (n,) float32 tensor, all
    on the plan's device."""
    nd, n = len(plan.offsets), plan.n
    checks = [(f"vector {i}", v, (n,), (torch.float32,)) for i, v in enumerate(vectors)]
    if data is not None:
        checks.append(("data", data, (nd, n), data_dtypes))
    for name, t, shape, dtypes in checks:
        if t.device != plan.device:
            raise ValueError(f"{name} is on {t.device}, the plan on {plan.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernels take "
                            f"{' or '.join(str(d) for d in dtypes)}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---- dispatch helpers shared by every wrapper of the port ----------------


def on_cpu(*ts) -> bool:
    """True when every tensor argument lies on the CPU (the plain route)."""
    return all(t.device.type == "cpu" for t in ts if isinstance(t, torch.Tensor))


def require_cuda(what: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {t.device}")


@functools.lru_cache(maxsize=None)
def sm_count(index) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def persistent_launch(n: int, ptrs, sms: int, threads: int = 256,
                      blocks_per_sm: int = 4, tail: bool = False) -> tuple[int, int]:
    """(vec, blocks) of a grid-stride launch over n rows: vec = 1 takes a
    kernel's float4 branch over row quads, which needs every pointer of
    `ptrs` 16-byte aligned and n % 4 == 0 — or, with `tail`, a kernel that
    takes the last quad of an n % 4 != 0 row by row; the grid is
    persistent, `blocks_per_sm` blocks of `threads` per SM, fewer when the
    rows (quads) run out."""
    vec = int((tail or n % 4 == 0) and all(p % 16 == 0 for p in ptrs))
    steps = -(-n // 4) if vec else n
    return vec, max(min(-(-steps // threads), blocks_per_sm * sms), 1)


def check_scalar(name: str, s, device: torch.device) -> None:
    if not (isinstance(s, torch.Tensor) and s.dim() == 0
            and s.dtype == torch.float32 and s.device == device):
        raise TypeError(f"{name} must be a 0-d float32 tensor on {device}")


def dia_spmv(plan: DiaPlan, data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x for the Dia matrix (plan, data): row quads when n % 4 == 0
    and data, x and y are 16-byte aligned, else rows (csrc/dia_rows.cuh)."""
    if x.device.type == "cpu" and data.device.type == "cpu":
        return dia_spmv_plain(data, plan.offsets, x)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv: no kernel for device {x.device}")
    check_operands(plan, data, x)
    lib = _build.library()
    y = torch.empty_like(x)
    vec, blocks = persistent_launch(plan.n, [t.data_ptr() for t in (data, x, y)],
                                    sm_count(plan.device.index), THREADS,
                                    SPMV_BLOCKS_PER_SM)
    _build.check(lib.ogl_dia_spmv(
        data.data_ptr(), plan.offsets_dev.data_ptr(), len(plan.offsets),
        x.data_ptr(), y.data_ptr(), plan.n, vec, blocks, stream_of(x)), "dia_spmv")
    kernels.launches["dia_spmv"] += 1
    return y
