"""The CG and general-BiCGStab loops on the gather formats: the base plan
`GatherCgKernels`, whose loops are one variant each of the two loop kernels
(`csrc/cg_loop.cu`, `csrc/bicgstab_gen_loop.cu`) with the format's row body
as their SpMV phases, and its plans for Csr (also the device Coo) and Sell:
`CsrCgKernels` (variant bit `LOOP_CSR`, body `csrc/csr_rows.cuh`
`csr_row`) and `SellCgKernels` (`LOOP_SELL`, `csrc/sell_rows.cuh`).  The
Ell and Hybrid plan, `EllCgKernels`, is in kernels/ell.py.

Counterpart: none in ogl_tpu.  The reference solves these formats on its
general loops (ogl_tpu/solve/cg.py, bicgstab.py) over XLA SpMVs; here
GKOCG and GKOBiCGStab with `none` or scalar `BJ` (GKOBiCGStab also with a
blocked BJ, `inv_t`) on them run their whole loop, criterion included, as
one cooperative launch on the card.

A plan holds the sparsity, checked once when it is made; the values travel
as `data = pack_values(mat)`, a tuple, so one plan serves every value
update of the sparsity.  Dispatch as everywhere in the port: CPU tensors
run the twins — `cg_loop_plain` over the plan's K1 (`gather_k1_plain`),
`bicgstab_gen_loop_plain` over its SpMV; CUDA tensors launch or raise, a
refused cooperative launch included.  Launches count as
`<format>_cg_loop` and `<format>_bicgstab_gen_loop` (`csr_`, `sell_`,
`ell_`).  The loop phases walk one lane per row, so a Csr whose SpMV takes
G > 1 lanes per row (`gather_spmv.csr_group`) has no plan
(solve/cg.py `why_not`).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ogl_tpu_torch import kernels
from ogl_tpu_torch.core.formats import Csr, Ell, Hybrid, Sell
from ogl_tpu_torch.kernels import _build, gather_spmv
from ogl_tpu_torch.kernels.dia_spmv import check_scalar, on_cpu, require_cuda, stream_of
from ogl_tpu_torch.kernels.fused import (LOOP_CSR, LOOP_JACOBI, LOOP_SELL, LOOP_THREADS,
                                         CgKernels, _ptr, _read_record, bicgstab_gen_loop_plain,
                                         cg_loop_plain, gen_loop_precond,
                                         gen_loop_preconditioner)

__all__ = ["GatherCgKernels", "CsrCgKernels", "SellCgKernels", "gather_k1_plain"]

_TWINS = {Csr: gather_spmv.spmv_csr, Ell: gather_spmv.spmv_ell, Sell: gather_spmv.spmv_sell,
          Hybrid: gather_spmv.spmv_hybrid}


def gather_k1_plain(m, z, p, beta):
    """(p', q, δ) with p' = z + β·p, q = A p' by the format's twin (a
    DeviceCoo as its Csr) and δ = Σ p'·q, on any device: the K1 of the loop
    kernel's twin."""
    pw = z + beta * p
    twin = next(f for t, f in _TWINS.items() if isinstance(m, t))
    q = twin(m, pw)
    return pw, q, torch.sum(pw * q)


class GatherCgKernels:
    """The loops on one gather-format sparsity on one device (the methods of
    kernels/xell.py `XellCgKernels`): `cg_loop`, `bicgstab_gen_loop`, their
    grids `loop_blocks`, `gen_loop_blocks`, and `k1`, `spmv`, `apply` over
    the format's SpMV kernel.  A subclass sets `NAME` (the C entries
    `ogl_cg_loop_<NAME>`, `ogl_bicgstab_gen_loop_<NAME>` and the counters),
    `LOOP` (its variant bit) and `SPMV` (its gather_spmv wrapper), and
    defines `pack_values`, `container` and `_operands`."""

    NAME: str
    LOOP: int
    SPMV: type

    def __init__(self, mat):
        self.shape = mat.shape
        self.n = mat.shape[0]
        self.device = (mat.ell if isinstance(mat, Hybrid) else mat).vals.device
        self.dtype = torch.float32
        self._d = CgKernels(self.n, (), self.device)
        self._loop_blocks: dict = {}
        self._gen_loop_blocks: dict = {}

    @classmethod
    def for_matrix(cls, mat) -> "GatherCgKernels":
        return cls(mat)

    def pack_values(self, mat) -> tuple:
        raise NotImplementedError

    def container(self, data):
        raise NotImplementedError

    def _operands(self, what: str, data, vectors) -> tuple:
        """The matrix arguments of a loop launch (those before x) after
        checking `data` and `vectors` against the plan."""
        raise NotImplementedError

    def spmv(self, data, x):
        """y = A x through the format's SpMV kernel (the twin for CPU
        tensors)."""
        return self.SPMV(self.container(data))(x)

    def apply(self, data, x):
        return self.spmv(data, x)

    def k1(self, data, z, p, beta):
        """(p', q, δ): p' = z + β·p and δ by torch ops, q by the SpMV kernel;
        on CPU tensors the twin's K1 (gather_k1_plain)."""
        pw = z + beta * p
        q = self.spmv(data, pw)
        return pw, q, torch.sum(pw * q)

    def _check_vectors(self, what, checks, vectors):
        gather_spmv._check(what, self.device, [
            *checks, *((f"vector {i}", v, (self.n,), torch.float32)
                       for i, v in enumerate(vectors))])

    # ---- the whole merged CG loop (CUDA C++) -----------------------------
    def loop_blocks(self, variant: int | None = None) -> int:
        """The co-resident blocks of LOOP_THREADS of the CG loop kernel's
        `variant` of this format (None: LOOP with identity; or with
        LOOP_JACOBI) on this plan's card, queried once per variant; raises on
        a card without cooperative launch."""
        return self._d._coop_blocks("cg_loop", self._loop_blocks,
                                    self.LOOP if variant is None else variant)

    def cg_loop(self, data, x, r, rho, absr, nf, cfg, invd=None, z=None):
        """The CG loop from the set-up's state, as CgKernels.cg_loop: x and r
        (and, with Jacobi, z = invd ⊙ r), updated in place; ρ = Σ r·z (Σ r·r
        with identity: invd and z None), ‖r‖₁ and the norm factor as 0-d
        tensors; cfg the StoppingParams.  One cooperative launch on the card
        (csrc/cg_loop.cu, this format's variant), then one host read of its
        record; CPU tensors run the twin `cg_loop_plain` over this plan's
        K1.  Returns (iterations, final and initial normalised residual,
        converged) — an int and three 0-d tensors (CPU tensors from the
        card's record)."""
        if (invd is None) != (z is None):
            raise ValueError("cg_loop: invd and z come together (Jacobi) or not at all")
        if on_cpu(*data, x, r, rho, absr, nf, invd, z):
            return cg_loop_plain(functools.partial(self.k1, data), x, r, rho, absr, nf, cfg,
                                 invd, z)
        what = f"{self.NAME}_cg_loop"
        require_cuda(what, x)
        jacobi = invd is not None
        vectors = (x, r, z, invd) if jacobi else (x, r)
        matrix = self._operands(what, data, vectors)
        for name, sc in (("rho", rho), ("absr", absr), ("nf", nf)):
            check_scalar(name, sc, self.device)
        variant = self.LOOP | (LOOP_JACOBI if jacobi else 0)
        blocks = min(self.loop_blocks(variant), -(-self.n // LOOP_THREADS))
        p, pn, q = torch.zeros_like(x), torch.empty_like(x), torch.empty_like(x)
        partials = torch.empty(3 * blocks, dtype=torch.float32, device=self.device)
        record = torch.empty(4, dtype=torch.float32, device=self.device)
        vec = int(self.n % 4 == 0 and all(t.data_ptr() % 16 == 0
                                          for t in (*vectors, p, pn, q)))
        _build.check(getattr(_build.library(), f"ogl_cg_loop_{self.NAME}")(
            variant, *matrix, x.data_ptr(), r.data_ptr(), z.data_ptr() if jacobi else None,
            invd.data_ptr() if jacobi else None, p.data_ptr(), pn.data_ptr(), q.data_ptr(),
            rho.data_ptr(), absr.data_ptr(), nf.data_ptr(), partials.data_ptr(),
            record.data_ptr(), self.n, cfg.tolerance, cfg.rel_tol, cfg.min_iter, cfg.max_iter,
            cfg.frequency, vec, LOOP_THREADS, blocks, stream_of(x)), what)
        kernels.launches[what] += 1
        return _read_record(record)

    # ---- the general BiCGStab: the whole loop (CUDA C++) ------------------
    def gen_loop_blocks(self, variant: int | None = None) -> int:
        """loop_blocks for the general-BiCGStab loop kernel's variants of
        this format."""
        return self._d._coop_blocks("bicgstab_gen_loop", self._gen_loop_blocks,
                                    self.LOOP if variant is None else variant)

    def bicgstab_gen_loop(self, data, x, r, rhat, rho, absr, nf, cfg, invd=None, inv_t=None):
        """The general BiCGStab loop of solve/bicgstab.py, as
        CgKernels.bicgstab_gen_loop: one cooperative launch of the loop
        kernel's variant of this format on the card (its two SpMV phases the
        format's row body over this plan; with inv_t its block-Jacobi
        phases), then one host read of its record; CPU tensors run the twin
        `bicgstab_gen_loop_plain` over this plan's SpMV."""
        pc = gen_loop_precond(x, invd, inv_t)
        if on_cpu(*data, x, r, rhat, rho, absr, nf, invd, inv_t):
            from ogl_tpu_torch.solve.krylov import single_device_ops  # solve imports this module
            ops = single_device_ops(functools.partial(self.spmv, data), self.n, precond=pc)
            return bicgstab_gen_loop_plain(ops, x, r, rhat, rho, absr, nf, cfg)
        what = f"{self.NAME}_bicgstab_gen_loop"
        require_cuda(what, x)
        vectors = (x, r, rhat) if invd is None else (x, r, rhat, invd)
        matrix = self._operands(what, data, vectors)
        for name, sc in (("rho", rho), ("absr", absr), ("nf", nf)):
            check_scalar(name, sc, self.device)
        bits, pc_ptr, bs, y, z = gen_loop_preconditioner(x, invd, inv_t)
        variant = self.LOOP | bits
        blocks = min(self.gen_loop_blocks(variant), -(-self.n // LOOP_THREADS))
        p, v = torch.zeros_like(x), torch.zeros_like(x)
        pn, vn, s, t = (torch.empty_like(x) for _ in range(4))
        partials = torch.empty(5 * blocks, dtype=torch.float32, device=self.device)
        record = torch.empty(4, dtype=torch.float32, device=self.device)
        vec = int(all(u.data_ptr() % 16 == 0 for u in (*vectors, p, pn, v, vn, s, t, y, z)
                      if u is not None))
        _build.check(getattr(_build.library(), f"ogl_bicgstab_gen_loop_{self.NAME}")(
            variant, *matrix, pc_ptr, bs, rhat.data_ptr(), x.data_ptr(), r.data_ptr(),
            p.data_ptr(), pn.data_ptr(), v.data_ptr(), vn.data_ptr(), s.data_ptr(), t.data_ptr(),
            _ptr(y), _ptr(z), rho.data_ptr(), absr.data_ptr(), nf.data_ptr(),
            partials.data_ptr(), record.data_ptr(), self.n, cfg.tolerance, cfg.rel_tol,
            cfg.min_iter, cfg.max_iter, cfg.frequency, vec, LOOP_THREADS, blocks,
            stream_of(x)), what)
        kernels.launches[what] += 1
        return _read_record(record)


class _FlatValuesPlan(GatherCgKernels):
    """A plan whose values are one flat array (Csr, Sell): data = (vals,);
    the plan keeps the matrix it was made from for its sparsity."""

    def __init__(self, mat):
        super().__init__(mat)
        self.mat = mat

    def pack_values(self, mat) -> tuple:
        """(values,) as the kernels take them; the matrix must have this
        plan's sparsity."""
        if type(mat) is not type(self.mat) or mat.vals.shape != self.mat.vals.shape:
            raise ValueError("matrix sparsity does not match this plan")
        return (mat.vals.contiguous(),)

    def container(self, data):
        """This plan's matrix with the values `data`."""
        return dataclasses.replace(self.mat, vals=data[0])


class CsrCgKernels(_FlatValuesPlan):
    """The loops on one Csr sparsity (or a DeviceCoo's): the K1 phase and
    the BiCGStab SpMV phases are `csr_row`, one lane per row, its entries in
    order — the CSR kernel's order at one lane per row, which its twin
    repeats.  Raises for a matrix whose SpMV takes more lanes per row."""

    NAME, LOOP, SPMV = "csr", LOOP_CSR, gather_spmv.CsrSpmv

    def __init__(self, mat: Csr):
        super().__init__(mat)
        group = gather_spmv.csr_group(self.n, mat.nnz)
        if group != 1:
            raise ValueError(f"CsrCgKernels: {mat.nnz / self.n:.1f} entries per row on mean take "
                             f"{group} lanes per row; the loop phases walk one")
        if self.device.type == "cuda":
            gather_spmv._check("CsrCgKernels", self.device, (
                ("row_ptr", mat.row_ptr, (self.n + 1,), torch.int32),
                ("cols", mat.cols, (mat.nnz,), torch.int32)))

    def _operands(self, what, data, vectors):
        """(row_ptr, cols, vals)."""
        m = self.mat
        self._check_vectors(what, (("vals", data[0], (m.nnz,), torch.float32),), vectors)
        return m.row_ptr.data_ptr(), m.cols.data_ptr(), data[0].data_ptr()


class SellCgKernels(_FlatValuesPlan):
    """The loops on one Sell sparsity: the K1 phase and the BiCGStab SpMV
    phases walk slots with `sell_slot`, each slice stopping at its longest
    row, and write each slot's sum at its row (a pad slot nothing)."""

    NAME, LOOP, SPMV = "sell", LOOP_SELL, gather_spmv.SellSpmv

    def __init__(self, mat: Sell):
        super().__init__(mat)
        if self.device.type == "cuda":
            gather_spmv.check_sell("SellCgKernels", mat, self.device, vals=False)

    def _operands(self, what, data, vectors):
        """(table, n_buckets, slice_buckets, slice_widths, slot_rows, cols,
        vals, slots, slice height)."""
        m = self.mat
        self._check_vectors(what, (("vals", data[0], (m.stored,), torch.float32),), vectors)
        return (*gather_spmv.sell_operands(m), data[0].data_ptr(), int(m.slot_rows.shape[0]),
                m.slice_height)
