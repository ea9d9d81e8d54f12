"""Gdia — block-row DIA with per-entry source lanes: the container, its
host packing, the CUDA C++ kernels `csrc/gdia.cu` (SpMV and merged-CG K1,
whose row body `csrc/gdia_k1.cuh` is also the K1 phase of the CG loop
kernel's Gdia variants; THREADS threads per block, one row quad each) and
their plain PyTorch twins.

Counterpart: ogl_tpu/kernels/gdia.py (`Gdia`, `gdia_layout`,
`gdia_from_coo`, `spmv_gdia`, `gdia_matvec` and the Pallas `_gdia_kernel`)
and ogl_tpu/kernels/fused.py `_k1_gdia_kernel` (`GdiaCgKernels.k1`).  The
numpy packing is the reference's, carried over unchanged.

View vectors as (R, 128).  An entry (dst, src) has the block-row offset
q = src//128 − dst//128 (a static plane class) and the source lane
l = src % 128 (per-entry data).  Storage: per plane a (R, 128) stream of
float32 values and one of int8 source lanes; entries that hit the same
destination slot within one class spill to extra planes, so
`plane_offsets` repeats q once per such plane.  Unused slots hold value 0
and lane 0.

    y[r·128 + l] = Σ_p vals[p, r, l] · x[(r + q_p)·128 + lidx[p, r, l]]

On the TPU the lane gather is the only fast dynamic addressing, so the
format exists there for speed; the GPU gathers in hardware, and the port
keeps the format so that `matrixFormat Gdia` and the reference's
auto-routing behave the same.  A source index that falls outside [0, n)
(a padding slot, or the zero-padded tail of the last block row) is masked
in the kernels and in the plain versions alike, where the TPU reads a
zero-padded window.

Dispatch, as for every wrapper of the port: CPU tensors run the plain
version; CUDA tensors launch the kernel or raise.  Each launch counts in
`ogl_tpu_torch.kernels.launches` (`gdia_spmv`, `gdia_k1`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ogl_tpu_torch import kernels
from ogl_tpu_torch.core.formats import Coo
from ogl_tpu_torch.kernels import _build
from ogl_tpu_torch.kernels.dia_spmv import (THREADS, check_scalar, on_cpu, require_cuda,
                                            stream_of)

LANES = 128
MAX_PLANES = 1024  # the kernels stage the plane offsets in a table of this size

__all__ = ["Gdia", "GdiaPlan", "gdia_layout", "gdia_from_coo", "gdia_spmv_plain",
           "gdia_k1_plain", "gdia_spmv", "gdia_k1", "gdia_matvec", "spmv_gdia",
           "check_operands", "MAX_PLANES"]


@dataclasses.dataclass(frozen=True)
class Gdia:
    """vals/lidx: (n_planes, R, 128) float32 / int8 tensors on one device;
    plane_offsets[p] = block-row offset q of plane p (host tuple).
    `layout` keeps the host entry→slot map of the conversion (`dest` of
    `gdia_layout`) so that the value map need not recompute it (host
    numpy; not part of the matrix's identity)."""

    vals: torch.Tensor
    lidx: torch.Tensor
    plane_offsets: tuple[int, ...]
    shape: tuple[int, int]
    layout: np.ndarray | None = dataclasses.field(default=None, compare=False,
                                                  repr=False)


def gdia_layout(rows, cols, n: int, max_planes: int = 64, plane_table=None):
    """Entry→slot layout for Gdia packing (the reference's, unchanged).

    Returns (plane_offsets, r, dest, lanes): entry i goes to flat position
    dest[i] of the (n_planes, r, 128) storage, with source lane lanes[i].
    Shared by `gdia_from_coo` and the steady-state value map so both agree
    on plane assignment.  plane_table: an externally agreed plane_offsets
    tuple; raises if this sparsity does not fit it."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    r = max(math.ceil(n / LANES), 1)
    rd, ld = rows // LANES, rows % LANES
    rs, ls = cols // LANES, cols % LANES
    q = rs - rd

    base_of: dict[int, tuple[int, int]] = {}
    if plane_table is not None:
        for k, qv in enumerate(plane_table):
            b, c = base_of.get(int(qv), (k, 0))
            base_of[int(qv)] = (b, c + 1)

    plane_offsets: list[int] = []
    dest = np.zeros(len(rows), np.int64)
    plane_base = 0
    for qv in np.unique(q):
        sel = np.nonzero(q == qv)[0]
        # plane index = running occurrence count per destination slot
        dst = rd[sel] * LANES + ld[sel]
        order = np.argsort(dst, kind="stable")
        sel = sel[order]
        dst = dst[order]
        starts = np.searchsorted(dst, dst)  # first occurrence index
        plane_of = np.arange(len(dst)) - starts
        n_p = int(plane_of.max()) + 1 if len(dst) else 0
        if plane_table is not None:
            if int(qv) not in base_of or n_p > base_of[int(qv)][1]:
                raise ValueError(
                    f"sparsity does not fit the agreed Gdia plane table: "
                    f"offset {int(qv)} needs {n_p} planes, table has "
                    f"{base_of.get(int(qv), (0, 0))[1]}")
            dest[sel] = (base_of[int(qv)][0] + plane_of) * (r * LANES) + dst
        else:
            dest[sel] = (plane_base + plane_of) * (r * LANES) + dst
            plane_offsets.extend([int(qv)] * n_p)
            plane_base += n_p
    if plane_table is not None:
        plane_offsets = [int(qv) for qv in plane_table]
    if len(plane_offsets) > max_planes:
        raise ValueError(
            f"Gdia needs {len(plane_offsets)} planes (> {max_planes}); matrix "
            "bandwidth too large — renumber (core.reorder.rcm_permutation) "
            "or raise max_planes"
        )
    if not plane_offsets:
        plane_offsets = [0]
    return tuple(plane_offsets), r, dest, ls.astype(np.int8)


def gdia_from_coo(coo: Coo, max_planes: int = 64,
                  device: torch.device | str = "cpu") -> Gdia:
    """Host packing, uploaded to `device`.  Raises if the plane count
    exceeds max_planes — renumber with core.reorder.rcm_permutation."""
    n = coo.shape[0]
    rows = np.asarray(coo.rows).astype(np.int64)
    cols = np.asarray(coo.cols).astype(np.int64)
    vals = np.asarray(coo.vals)
    plane_offsets, r, dest, lanes = gdia_layout(rows, cols, n, max_planes)
    np_ = len(plane_offsets)
    v = np.zeros(np_ * r * LANES, vals.dtype)
    ll = np.zeros(np_ * r * LANES, np.int8)
    v[dest] = vals
    ll[dest] = lanes
    return Gdia(vals=torch.tensor(v.reshape(np_, r, LANES), device=device),
                lidx=torch.tensor(ll.reshape(np_, r, LANES), device=device),
                plane_offsets=plane_offsets, shape=tuple(coo.shape), layout=dest)


class GdiaPlan:
    """Static structure of a Gdia matrix on one device: n, R, the host
    plane offsets and the same as an int32 device tensor (what the kernels
    read).  Values and lanes travel as arguments, so one plan serves every
    coefficient update of the same sparsity."""

    def __init__(self, n: int, plane_offsets, device: torch.device | str):
        self.n = int(n)
        self.r = max(math.ceil(self.n / LANES), 1)
        self.plane_offsets = tuple(int(q) for q in plane_offsets)
        if len(self.plane_offsets) > MAX_PLANES:
            raise ValueError(f"{len(self.plane_offsets)} planes: the Gdia kernels take at "
                             f"most {MAX_PLANES}")
        self.offsets_dev = torch.tensor(self.plane_offsets, dtype=torch.int32,
                                        device=device)
        self.device = self.offsets_dev.device

    @classmethod
    def of(cls, m: Gdia) -> "GdiaPlan":
        return cls(m.shape[0], m.plane_offsets, m.vals.device)


# ---- plain PyTorch twins (CPU path, and the reference on the card) ------


def gdia_spmv_plain(vals, lidx, plane_offsets, x):
    """y = A x on the (R, 128) view, planes summed in order; sources
    outside [0, n) read 0 (the reference's `spmv_gdia`)."""
    n = x.shape[0]
    r = vals.shape[1]
    qmax = max((abs(q) for q in plane_offsets), default=0)
    x2 = torch.nn.functional.pad(x, (0, r * LANES - n)).view(r, LANES)
    xp = torch.nn.functional.pad(x2, (0, 0, qmax, qmax))
    acc = torch.zeros((r, LANES), dtype=x.dtype, device=x.device)
    for p, q in enumerate(plane_offsets):
        shifted = xp[qmax + q: qmax + q + r]
        g = torch.gather(shifted, 1, lidx[p].long())
        acc = acc + vals[p].to(x.dtype) * g
    return acc.reshape(-1)[:n]


def gdia_k1_plain(vals, lidx, plane_offsets, z, p, beta):
    """(p', q, δ) with p' = z + β·p, q = A p', δ = Σ p'·q."""
    pw = z + beta * p
    q = gdia_spmv_plain(vals, lidx, plane_offsets, pw)
    return pw, q, torch.sum(pw * q)


def spmv_gdia(m: Gdia, x):
    """Plain y = A x for a Gdia container."""
    return gdia_spmv_plain(m.vals, m.lidx, m.plane_offsets, x)


# ---- wrappers -------------------------------------------------------------


def check_operands(plan: GdiaPlan, vals, lidx, *vectors) -> None:
    """Raise unless vals/lidx are contiguous (planes, R, 128) float32/int8
    tensors and every vector a contiguous (n,) float32 tensor, all on the
    plan's device."""
    shape = (len(plan.plane_offsets), plan.r, LANES)
    checks = [("vals", vals, shape, torch.float32), ("lidx", lidx, shape, torch.int8)]
    checks += [(f"vector {i}", v, (plan.n,), torch.float32) for i, v in enumerate(vectors)]
    for name, t, want, dtype in checks:
        if t.device != plan.device:
            raise ValueError(f"{name} is on {t.device}, the plan on {plan.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernels take {dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _blocks(plan: GdiaPlan) -> int:
    """The kernels' grid: one row quad per thread of THREADS."""
    return max(-(-plan.n // (4 * THREADS)), 1)


def _vec(*vectors) -> int:
    """1 when every vector is 16-byte aligned: the kernels' float4 path."""
    return int(all(t.data_ptr() % 16 == 0 for t in vectors))


def gdia_spmv(plan: GdiaPlan, vals, lidx, x):
    """y = A x for the Gdia matrix (plan, vals, lidx)."""
    if on_cpu(vals, lidx, x):
        return gdia_spmv_plain(vals, lidx, plan.plane_offsets, x)
    require_cuda("gdia_spmv", x)
    check_operands(plan, vals, lidx, x)
    lib = _build.library()
    y = torch.empty_like(x)
    _build.check(lib.ogl_gdia_spmv(
        vals.data_ptr(), lidx.data_ptr(), plan.offsets_dev.data_ptr(),
        len(plan.plane_offsets), plan.r, x.data_ptr(), y.data_ptr(), plan.n,
        _vec(x, y), _blocks(plan), stream_of(x)), "gdia_spmv")
    kernels.launches["gdia_spmv"] += 1
    return y


def gdia_k1(plan: GdiaPlan, vals, lidx, z, p, beta):
    """Merged-CG K1 on a Gdia matrix: (p', q, δ), p' and q in new buffers,
    δ a 0-d tensor; beta a 0-d float32 tensor on the plan's device."""
    if on_cpu(vals, lidx, z, p, beta):
        return gdia_k1_plain(vals, lidx, plan.plane_offsets, z, p, beta)
    require_cuda("gdia_k1", z)
    check_operands(plan, vals, lidx, z, p)
    check_scalar("beta", beta, plan.device)
    lib = _build.library()
    pout = torch.empty_like(p)
    q = torch.empty_like(p)
    blocks = _blocks(plan)
    partials = torch.empty(blocks, dtype=torch.float32, device=plan.device)
    _build.check(lib.ogl_gdia_k1(
        vals.data_ptr(), lidx.data_ptr(), plan.offsets_dev.data_ptr(),
        len(plan.plane_offsets), plan.r, z.data_ptr(), p.data_ptr(), beta.data_ptr(),
        pout.data_ptr(), q.data_ptr(), partials.data_ptr(), plan.n, _vec(z, p, pout, q),
        blocks, stream_of(z)), "gdia_k1")
    kernels.launches["gdia_k1"] += 1
    return pout, q, torch.sum(partials)


def gdia_matvec(m: Gdia):
    """`x -> A @ x`: the Gdia SpMV kernel for CUDA tensors, the plain
    version for CPU tensors."""
    plan = GdiaPlan.of(m)
    vals, lidx = m.vals, m.lidx
    return lambda x: gdia_spmv(plan, vals, lidx, x)
