"""The AMG level operations of unstructured hierarchies: the smoother on an
Ell level and on a Gdia level, and the pgm transfers — each a hand-written
CUDA C++ kernel beside its plain PyTorch twin.

  EllSmoother   `csrc/amg_ell_smooth.cu` (`ogl_amg_ell_sweep`, `_resid`)
  GdiaSmoother  `csrc/amg_gdia_smooth.cu` (`ogl_amg_gdia_sweep`, `_resid`)
  PgmTransfer   `csrc/amg_transfer.cu` (`ogl_pgm_restrict`,
                `ogl_pgm_prolong_add`)

Counterpart: ogl_tpu/precond/amg.py `_smooth` (:420-430) around
`_apply_mat` (:402-417) — on a Gdia level of at least 32k rows the Pallas
`_gdia_kernel` (ogl_tpu/kernels/gdia.py:183), elsewhere the XLA SpMV — and
the pgm transfers `_restrict`/`_prolong` (:350-367, `jax.ops.segment_sum`
and `jnp.take`).  The Dia level's smoother stays kernels/fused.py
`CgKernels.ksweep`/`kresid` (csrc/amg_smooth.cu).

  sweep     x + relax·invd ⊙ (b − A x)
  resid     b − A x
  restrict  r_c[c] = Σ r[i] over the fine rows i of aggregate c
  prolong   x + e_c[agg]

The operator's values are packed in float32 or bfloat16 (the level's
`data_s`, the port's smoother packing); the kernels widen them to float32
and accumulate in float32.  Each twin repeats its kernel's arithmetic —
every product, sum and difference rounded on its own, in the kernel's
order (the Ell row's slots up to its 32-row group's longest row, the Gdia
planes in order, an aggregate's members in ascending row order) — so the
two give the same bits.  The restriction reads an aggregate table
(`PgmTransfer.starts`/`members`, built once per level on the host) and
writes each coarse row once: no float atomics, so its result is the same
on every run, which torch's `index_add_` on the card is not.

Dispatch, as every wrapper of the port: tensors on the CPU run the plain
twin; CUDA tensors launch the kernel or raise (wrong device, dtype, shape,
contiguity, a refused launch) — there is no fallback.  Every result is a
new buffer: a sweep reads x at other rows while it writes.  Each launch
counts in `ogl_tpu_torch.kernels.launches` (`amg_ell_sweep`,
`amg_ell_resid`, `amg_gdia_sweep`, `amg_gdia_resid`, `pgm_restrict`,
`pgm_prolong`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ogl_tpu_torch import kernels
from ogl_tpu_torch.core.formats import ELL_GROUP, Ell
from ogl_tpu_torch.kernels import _build
from ogl_tpu_torch.kernels.dia_spmv import on_cpu, require_cuda, sm_count, stream_of
from ogl_tpu_torch.kernels.gather_spmv import spmv_ell
from ogl_tpu_torch.kernels.gdia import LANES, Gdia, GdiaPlan, gdia_spmv_plain

__all__ = ["EllSmoother", "GdiaSmoother", "PgmTransfer", "ell_sweep_plain", "ell_resid_plain",
           "gdia_sweep_plain", "gdia_resid_plain", "pgm_restrict_plain",
           "pgm_prolong_add_plain", "aggregate_table", "SMOOTHER_DTYPES", "THREADS"]

THREADS = 256  # threads per block of the three kernels
BLOCKS_PER_SM = 64  # grid cap of their grid-stride loops (as the gather SpMVs')
# the coefficient types the smoother kernels take (their templates)
SMOOTHER_DTYPES = (torch.float32, torch.bfloat16)


# ---- plain PyTorch twins (CPU path, and the reference on the card) ------


def ell_resid_plain(cols, vals, warp_slots, x, b):
    """b − A x over the slot-major Ell storage, each row stopping at its
    32-row group's longest row (`spmv_ell`, values widened to float32)."""
    n = x.shape[0]
    return b - spmv_ell(Ell(cols=cols, vals=vals, shape=(n, n), warp_slots=warp_slots), x)


def ell_sweep_plain(cols, vals, warp_slots, x, b, invd, relax):
    """x + relax·invd ⊙ (b − A x) on an Ell level."""
    return x + relax * invd * ell_resid_plain(cols, vals, warp_slots, x, b)


def gdia_resid_plain(vals, lidx, plane_offsets, x, b):
    """b − A x on a Gdia level (`gdia_spmv_plain`, values widened)."""
    return b - gdia_spmv_plain(vals, lidx, plane_offsets, x)


def gdia_sweep_plain(vals, lidx, plane_offsets, x, b, invd, relax):
    """x + relax·invd ⊙ (b − A x) on a Gdia level."""
    return x + relax * invd * gdia_resid_plain(vals, lidx, plane_offsets, x, b)


def pgm_restrict_plain(table, r):
    """r_c from the member table (S, nc): row s holds each aggregate's s-th
    fine row, n where the aggregate has fewer; the sums add member position
    by member position from 0, as the kernel's thread adds its members (an
    added +0 of the padding leaves a sum that never is −0 unchanged)."""
    rp = torch.cat([r, r.new_zeros(1)])
    acc = torch.zeros(table.shape[1], dtype=r.dtype, device=r.device)
    for s in range(table.shape[0]):
        acc = acc + rp[table[s]]
    return acc


def pgm_prolong_add_plain(agg, x, ec):
    """x + e_c[agg]."""
    return x + ec.index_select(0, agg)


# ---- wrappers ---------------------------------------------------------------


def _blocks(items: int, device: torch.device) -> int:
    return max(min(-(-items // THREADS), BLOCKS_PER_SM * sm_count(device.index)), 1)


def _check(what: str, device, operands) -> None:
    """Raise unless each (name, tensor, shape, dtypes) is a contiguous tensor
    of that shape and one of those dtypes on `device`."""
    for name, t, shape, dtypes in operands:
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}; the kernel takes "
                            f"{' or '.join(map(str, dtypes))}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def _vectors(n: int, **vectors) -> list:
    return [(name, v, (n,), (torch.float32,)) for name, v in vectors.items()]


class _Smoother:
    """The sweep and residual wrappers of one level's sparsity: the
    subclass holds the static structure and its kernels' entry points; the
    packed values (`pack_values`) travel as the `vals` argument."""

    NAME: str

    def __init__(self, n: int, device: torch.device):
        self.n = int(n)
        self.device = device

    def pack_values(self, m, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The level's values as the smoother reads them: contiguous, in
        `dtype` (one of SMOOTHER_DTYPES)."""
        if dtype not in SMOOTHER_DTYPES:
            raise TypeError(f"{self.NAME}: smoother values of type {dtype}")
        return m.vals.to(dtype).contiguous()

    def sweep(self, vals, x, b, invd, relax: float):
        """One damped Jacobi sweep x + relax·invd ⊙ (b − A x), in a new buffer."""
        if on_cpu(vals, x, b, invd):
            return self.twin(vals, x, b, invd, relax)
        return self._launch(f"{self.NAME}_sweep", vals, x, b, invd, relax)

    def resid(self, vals, x, b):
        """The residual b − A x, in a new buffer."""
        if on_cpu(vals, x, b):
            return self.twin(vals, x, b, None, 0.0)
        return self._launch(f"{self.NAME}_resid", vals, x, b, None, 0.0)

    def _launch(self, name, vals, x, b, invd, relax):
        require_cuda(name, x)
        vecs = dict(x=x, b=b) if invd is None else dict(x=x, b=b, invd=invd)
        _check(name, self.device, [("vals", vals, self._vals_shape, SMOOTHER_DTYPES),
                                   *_vectors(self.n, **vecs)])
        out = torch.empty_like(x)
        args = (*self._head(vals), x.data_ptr(), b.data_ptr())
        lib = _build.library()
        if invd is None:
            code = getattr(lib, f"ogl_{self.NAME}_resid")(*args, out.data_ptr(), *self._tail(),
                                                          stream_of(x))
        else:
            code = getattr(lib, f"ogl_{self.NAME}_sweep")(*args, invd.data_ptr(), float(relax),
                                                          out.data_ptr(), *self._tail(),
                                                          stream_of(x))
        _build.check(code, name)
        kernels.launches[name] += 1
        return out


class EllSmoother(_Smoother):
    """The smoother of an Ell level (slot-major (K, n) cols, `warp_slots`):
    `csrc/amg_ell_smooth.cu`, one thread per row on a grid-stride grid of
    whole warps, each warp stopping at its 32-row group's longest row."""

    NAME = "amg_ell"

    def __init__(self, m: Ell):
        super().__init__(m.shape[0], m.vals.device)
        self.cols, self.warp_slots, self.width = m.cols, m.warp_slots, m.row_width
        self._vals_shape = (self.width, self.n)
        if self.device.type == "cpu":
            return
        groups = -(-self.n // ELL_GROUP)
        _check(self.NAME, self.device,
               [("cols", m.cols, self._vals_shape, (torch.int32,)),
                ("warp_slots", m.warp_slots, (groups,), (torch.int32,))])
        if groups and int(m.warp_slots.max()) > self.width:
            raise ValueError(f"{self.NAME}: a warp slot count exceeds the Ell width "
                             f"{self.width}")

    def twin(self, vals, x, b, invd, relax):
        """The plain twin of `sweep`, or of `resid` when invd is None, on
        any device."""
        if invd is None:
            return ell_resid_plain(self.cols, vals, self.warp_slots, x, b)
        return ell_sweep_plain(self.cols, vals, self.warp_slots, x, b, invd, relax)

    def _head(self, vals):
        return (self.cols.data_ptr(), vals.data_ptr(), int(vals.dtype == torch.bfloat16),
                self.warp_slots.data_ptr())

    def _tail(self):
        return (self.n, _blocks(self.n, self.device))


class GdiaSmoother(_Smoother):
    """The smoother of a Gdia level (its plane offsets and source lanes,
    kernels/gdia.py `GdiaPlan`): `csrc/amg_gdia_smooth.cu`, one thread per
    row quad, the plane offsets staged in shared memory."""

    NAME = "amg_gdia"

    def __init__(self, m: Gdia):
        super().__init__(m.shape[0], m.vals.device)
        self.gplan = GdiaPlan.of(m)
        self.lidx = m.lidx
        self.plane_offsets = self.gplan.plane_offsets
        self._vals_shape = (len(self.plane_offsets), self.gplan.r, LANES)
        if self.device.type != "cpu":
            _check(self.NAME, self.device, [("lidx", m.lidx, self._vals_shape, (torch.int8,))])

    def twin(self, vals, x, b, invd, relax):
        """The plain twin of `sweep`, or of `resid` when invd is None."""
        if invd is None:
            return gdia_resid_plain(vals, self.lidx, self.plane_offsets, x, b)
        return gdia_sweep_plain(vals, self.lidx, self.plane_offsets, x, b, invd, relax)

    def _head(self, vals):
        return (vals.data_ptr(), int(vals.dtype == torch.bfloat16), self.lidx.data_ptr(),
                self.gplan.offsets_dev.data_ptr(), len(self.plane_offsets), self.gplan.r)

    def _tail(self):
        return (self.n, _blocks(-(-self.n // 4), self.device))


def aggregate_table(agg: np.ndarray, nc: int) -> tuple[np.ndarray, np.ndarray]:
    """(starts (nc + 1,), members (n,)) int32: aggregate c's fine rows are
    members[starts[c]:starts[c + 1]], ascending."""
    agg = np.asarray(agg, np.int64)
    members = np.argsort(agg, kind="stable").astype(np.int32)
    starts = np.zeros(nc + 1, np.int64)
    np.cumsum(np.bincount(agg, minlength=nc), out=starts[1:])
    return starts.astype(np.int32), members


class PgmTransfer:
    """The transfers of one pgm level (agg[i] the aggregate of fine row i,
    nc aggregates, every one non-empty): `restrict` and `prolong_add`,
    `csrc/amg_transfer.cu`, over the aggregate table built here once."""

    def __init__(self, agg: np.ndarray, nc: int, device: torch.device | str):
        agg = np.asarray(agg, np.int64)
        self.n, self.nc = len(agg), int(nc)
        if self.n and (agg.min() < 0 or agg.max() >= self.nc):
            raise ValueError(f"pgm aggregates outside [0, {self.nc})")
        starts, members = aggregate_table(agg, self.nc)
        self.agg = torch.tensor(agg.astype(np.int32), device=device)
        self.starts = torch.tensor(starts, device=device)
        self.members = torch.tensor(members, device=device)
        self.device = self.agg.device

    @functools.cached_property
    def table(self) -> torch.Tensor:
        """The twin's (S, nc) member table: row s holds each aggregate's s-th
        fine row, n past its last."""
        starts = self.starts.long()
        sizes = starts.diff()
        width = int(sizes.max()) if self.nc else 0
        s = torch.arange(width, device=self.device)[:, None]
        at = (starts[:-1][None, :] + s).clamp(max=max(self.n - 1, 0))
        return torch.where(s < sizes[None, :], self.members.long()[at], self.n)

    def _on_cpu(self, *ts) -> bool:
        return self.device.type == "cpu" and on_cpu(*ts)

    def _checked(self, name, **vectors):
        v0 = next(iter(vectors.values()))
        require_cuda(name, v0)
        _check(name, self.device, [(k, v, (self.nc if k == "ec" else self.n,), (torch.float32,))
                                   for k, v in vectors.items()])
        return _build.library(), stream_of(v0)

    def restrict(self, r):
        """r_c (nc,): each aggregate's fine rows of r summed, in a new buffer."""
        if self._on_cpu(r):
            return pgm_restrict_plain(self.table, r)
        lib, stream = self._checked("pgm_restrict", r=r)
        rc = torch.empty(self.nc, dtype=r.dtype, device=r.device)
        _build.check(lib.ogl_pgm_restrict(self.starts.data_ptr(), self.members.data_ptr(),
                                          r.data_ptr(), rc.data_ptr(), self.nc,
                                          _blocks(self.nc, self.device), stream), "pgm_restrict")
        kernels.launches["pgm_restrict"] += 1
        return rc

    def prolong_add(self, x, ec):
        """x + e_c[agg] (n,), in a new buffer."""
        if self._on_cpu(x, ec):
            return pgm_prolong_add_plain(self.agg.long(), x, ec)
        lib, stream = self._checked("pgm_prolong", x=x, ec=ec)
        out = torch.empty_like(x)
        _build.check(lib.ogl_pgm_prolong_add(x.data_ptr(), ec.data_ptr(), self.agg.data_ptr(),
                                             out.data_ptr(), self.n,
                                             _blocks(self.n, self.device), stream),
                     "pgm_prolong")
        kernels.launches["pgm_prolong"] += 1
        return out
