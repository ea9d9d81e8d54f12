"""The CG and general-BiCGStab loops on an Ell or Hybrid matrix: the plan
`EllCgKernels`, whose loops are the Ell variants of the two loop kernels
(`csrc/cg_loop.cu`, `csrc/bicgstab_gen_loop.cu`; variant bit `LOOP_ELL`),
their SpMV phases the Ell row body `csrc/ell_rows.cuh` (a Hybrid's tail
added in the same row body), and the plain K1 `ell_k1_plain`.

Counterpart: none in ogl_tpu.  The reference solves Ell and Hybrid on its
general loops (ogl_tpu/solve/cg.py, bicgstab.py) over XLA SpMVs; here GKOCG
and GKOBiCGStab with `none` or scalar `BJ` on either format (an explicit
`matrixFormat`, or the ladder's Ell landing) run their whole loop,
criterion included, as one cooperative launch on the card.

The plan holds the sparsity — the Ell columns and per-warp slot counts, a
Hybrid's tail offsets and columns — checked once when it is made; the
values travel as `data = pack_values(mat)`, (Ell values, tail values or
None), so one plan serves every value update of the sparsity.  A Hybrid
with an empty tail launches as Ell (no tail offsets read).  Dispatch as
everywhere in the port: CPU tensors run the twins — `cg_loop_plain` over
this plan's K1, `bicgstab_gen_loop_plain` over its SpMV; CUDA tensors
launch or raise, a refused cooperative launch included.  Launches count as
`ell_cg_loop` and `ell_bicgstab_gen_loop`.
"""

from __future__ import annotations

import functools

import torch

from ogl_tpu_torch import kernels
from ogl_tpu_torch.core.formats import ELL_GROUP, Csr, Ell, Hybrid
from ogl_tpu_torch.kernels import _build, gather_spmv
from ogl_tpu_torch.kernels.dia_spmv import check_scalar, on_cpu, require_cuda, stream_of
from ogl_tpu_torch.kernels.fused import (LOOP_ELL, LOOP_JACOBI, LOOP_THREADS, CgKernels,
                                         _read_record, bicgstab_gen_loop_plain, cg_loop_plain)

__all__ = ["EllCgKernels", "ell_k1_plain"]


def ell_k1_plain(m: Ell | Hybrid, z, p, beta):
    """(p', q, δ) with p' = z + β·p, q = A p' by the Ell (Hybrid) twin and
    δ = Σ p'·q, on any device: the K1 of the loop kernel's twin."""
    pw = z + beta * p
    q = (gather_spmv.spmv_hybrid if isinstance(m, Hybrid) else gather_spmv.spmv_ell)(m, pw)
    return pw, q, torch.sum(pw * q)


class EllCgKernels:
    """The loops on one Ell or Hybrid sparsity on one device (the methods of
    kernels/xell.py `XellCgKernels`): `cg_loop`, `bicgstab_gen_loop`, their
    grids `loop_blocks`, `gen_loop_blocks`, and `k1`, `spmv`, `apply` over
    the format's SpMV kernel."""

    def __init__(self, mat: Ell | Hybrid):
        self.hybrid = isinstance(mat, Hybrid)
        ell = mat.ell if self.hybrid else mat
        tail = mat.tail if self.hybrid else None
        self.shape = mat.shape
        self.n, self.k = mat.shape[0], ell.row_width
        self.cols, self.warp_slots = ell.cols, ell.warp_slots
        self.tail_ptr, self.tail_cols = (tail.row_ptr, tail.cols) if self.hybrid else (None, None)
        self.n_tail = tail.nnz if self.hybrid else 0
        self.device = ell.vals.device
        self.dtype = torch.float32
        self._d = CgKernels(self.n, (), self.device)
        self._loop_blocks: dict = {}
        self._gen_loop_blocks: dict = {}
        if self.device.type != "cuda":
            return
        structure = [("ell cols", self.cols, (self.k, self.n), torch.int32),
                     ("ell warp_slots", self.warp_slots, (-(-self.n // ELL_GROUP),),
                      torch.int32)]
        if self.hybrid:
            structure += [("tail row_ptr", self.tail_ptr, (self.n + 1,), torch.int32),
                          ("tail cols", self.tail_cols, (self.n_tail,), torch.int32)]
        gather_spmv._check("EllCgKernels", self.device, structure)
        if self.n and int(self.warp_slots.max()) > self.k:
            raise ValueError(f"EllCgKernels: a warp slot count exceeds the Ell width {self.k}")

    @classmethod
    def for_matrix(cls, mat: Ell | Hybrid) -> "EllCgKernels":
        return cls(mat)

    def pack_values(self, mat: Ell | Hybrid) -> tuple:
        """(Ell values, tail values — None for Ell) as the kernels take them;
        the matrix must have this plan's sparsity."""
        ell = mat.ell if isinstance(mat, Hybrid) else mat
        tail = mat.tail if isinstance(mat, Hybrid) else None
        if (isinstance(mat, Hybrid) != self.hybrid or tuple(ell.vals.shape) != (self.k, self.n)
                or (tail.nnz if tail is not None else 0) != self.n_tail):
            raise ValueError("matrix sparsity does not match this plan")
        return ell.vals.contiguous(), None if tail is None else tail.vals.contiguous()

    def container(self, data):
        """This plan's matrix with the values `data`."""
        ell = Ell(cols=self.cols, vals=data[0], shape=self.shape, warp_slots=self.warp_slots)
        if not self.hybrid:
            return ell
        return Hybrid(ell=ell, tail=Csr(row_ptr=self.tail_ptr, cols=self.tail_cols,
                                        vals=data[1], shape=self.shape), shape=self.shape)

    def spmv(self, data, x):
        """y = A x through the format's SpMV kernel (gather_spmv.EllSpmv;
        the twin for CPU tensors)."""
        return gather_spmv.EllSpmv(self.container(data))(x)

    def apply(self, data, x):
        return self.spmv(data, x)

    def k1(self, data, z, p, beta):
        """(p', q, δ): p' = z + β·p and δ by torch ops, q by the SpMV kernel;
        on CPU tensors the twin's K1 (ell_k1_plain)."""
        pw = z + beta * p
        q = self.spmv(data, pw)
        return pw, q, torch.sum(pw * q)

    def _operands(self, what, data, vectors):
        """The pointers of a loop launch after checking `data` and `vectors`
        against the plan: (cols, vals, warp_slots, tail_ptr, tail_cols,
        tail_vals), the tail's three None without a tail."""
        vals, tail_vals = data
        checks = [("ell vals", vals, (self.k, self.n), torch.float32),
                  *((f"vector {i}", v, (self.n,), torch.float32) for i, v in enumerate(vectors))]
        if self.hybrid:
            checks.append(("tail vals", tail_vals, (self.n_tail,), torch.float32))
        gather_spmv._check(what, self.device, checks)
        tail = ((self.tail_ptr.data_ptr(), self.tail_cols.data_ptr(), tail_vals.data_ptr())
                if self.n_tail else (None,) * 3)
        return (self.cols.data_ptr(), vals.data_ptr(), self.warp_slots.data_ptr(), *tail)

    # ---- the whole merged CG loop (CUDA C++) -----------------------------
    def loop_blocks(self, variant: int = LOOP_ELL) -> int:
        """The co-resident blocks of LOOP_THREADS of the CG loop kernel's Ell
        `variant` (LOOP_ELL, with LOOP_JACOBI or not) on this plan's card,
        queried once per variant; raises on a card without cooperative
        launch."""
        return self._d._coop_blocks("cg_loop", self._loop_blocks, variant)

    def cg_loop(self, data, x, r, rho, absr, nf, cfg, invd=None, z=None):
        """The CG loop from the set-up's state, as CgKernels.cg_loop: x and r
        (and, with Jacobi, z = invd ⊙ r), updated in place; ρ = Σ r·z (Σ r·r
        with identity: invd and z None), ‖r‖₁ and the norm factor as 0-d
        tensors; cfg the StoppingParams.  One cooperative launch on the card
        (csrc/cg_loop.cu, an Ell variant), then one host read of its record;
        CPU tensors run the twin `cg_loop_plain` over this plan's K1.
        Returns (iterations, final and initial normalised residual,
        converged) — an int and three 0-d tensors (CPU tensors from the
        card's record)."""
        if (invd is None) != (z is None):
            raise ValueError("cg_loop: invd and z come together (Jacobi) or not at all")
        if on_cpu(*data, x, r, rho, absr, nf, invd, z):
            return cg_loop_plain(functools.partial(self.k1, data), x, r, rho, absr, nf, cfg,
                                 invd, z)
        require_cuda("ell_cg_loop", x)
        jacobi = invd is not None
        vectors = (x, r, z, invd) if jacobi else (x, r)
        matrix = self._operands("ell_cg_loop", data, vectors)
        for what, sc in (("rho", rho), ("absr", absr), ("nf", nf)):
            check_scalar(what, sc, self.device)
        variant = LOOP_ELL | (LOOP_JACOBI if jacobi else 0)
        blocks = min(self.loop_blocks(variant), -(-self.n // LOOP_THREADS))
        p, pn, q = torch.zeros_like(x), torch.empty_like(x), torch.empty_like(x)
        partials = torch.empty(3 * blocks, dtype=torch.float32, device=self.device)
        record = torch.empty(4, dtype=torch.float32, device=self.device)
        vec = int(self.n % 4 == 0 and all(t.data_ptr() % 16 == 0
                                          for t in (*vectors, p, pn, q)))
        _build.check(_build.library().ogl_cg_loop_ell(
            variant, *matrix, x.data_ptr(), r.data_ptr(), z.data_ptr() if jacobi else None,
            invd.data_ptr() if jacobi else None, p.data_ptr(), pn.data_ptr(), q.data_ptr(),
            rho.data_ptr(), absr.data_ptr(), nf.data_ptr(), partials.data_ptr(),
            record.data_ptr(), self.n, cfg.tolerance, cfg.rel_tol, cfg.min_iter, cfg.max_iter,
            cfg.frequency, vec, LOOP_THREADS, blocks, stream_of(x)), "ell_cg_loop")
        kernels.launches["ell_cg_loop"] += 1
        return _read_record(record)

    # ---- the general BiCGStab: the whole loop (CUDA C++) ------------------
    def gen_loop_blocks(self, variant: int = LOOP_ELL) -> int:
        """loop_blocks for the general-BiCGStab loop kernel's Ell variants."""
        return self._d._coop_blocks("bicgstab_gen_loop", self._gen_loop_blocks, variant)

    def bicgstab_gen_loop(self, data, x, r, rhat, rho, absr, nf, cfg, invd=None):
        """The general BiCGStab loop of solve/bicgstab.py, as
        CgKernels.bicgstab_gen_loop: one cooperative launch of the loop
        kernel's Ell variant on the card (its two SpMV phases the Ell row
        body over this plan), then one host read of its record; CPU tensors
        run the twin `bicgstab_gen_loop_plain` over this plan's SpMV."""
        if on_cpu(*data, x, r, rhat, rho, absr, nf, invd):
            from ogl_tpu_torch.solve.krylov import single_device_ops  # solve imports this module
            ops = single_device_ops(functools.partial(self.spmv, data), self.n,
                                    precond=None if invd is None else (lambda w: invd * w))
            return bicgstab_gen_loop_plain(ops, x, r, rhat, rho, absr, nf, cfg)
        require_cuda("ell_bicgstab_gen_loop", x)
        jacobi = invd is not None
        vectors = (x, r, rhat, invd) if jacobi else (x, r, rhat)
        matrix = self._operands("ell_bicgstab_gen_loop", data, vectors)
        for what, sc in (("rho", rho), ("absr", absr), ("nf", nf)):
            check_scalar(what, sc, self.device)
        variant = LOOP_ELL | (LOOP_JACOBI if jacobi else 0)
        blocks = min(self.gen_loop_blocks(variant), -(-self.n // LOOP_THREADS))
        p, v = torch.zeros_like(x), torch.zeros_like(x)
        pn, vn, s, t = (torch.empty_like(x) for _ in range(4))
        partials = torch.empty(5 * blocks, dtype=torch.float32, device=self.device)
        record = torch.empty(4, dtype=torch.float32, device=self.device)
        vec = int(all(u.data_ptr() % 16 == 0 for u in (*vectors, p, pn, v, vn, s, t)))
        _build.check(_build.library().ogl_bicgstab_gen_loop_ell(
            variant, *matrix, invd.data_ptr() if jacobi else None, rhat.data_ptr(),
            x.data_ptr(), r.data_ptr(), p.data_ptr(), pn.data_ptr(), v.data_ptr(), vn.data_ptr(),
            s.data_ptr(), t.data_ptr(), rho.data_ptr(), absr.data_ptr(), nf.data_ptr(),
            partials.data_ptr(), record.data_ptr(), self.n, cfg.tolerance, cfg.rel_tol,
            cfg.min_iter, cfg.max_iter, cfg.frequency, vec, LOOP_THREADS, blocks,
            stream_of(x)), "ell_bicgstab_gen_loop")
        kernels.launches["ell_bicgstab_gen_loop"] += 1
        return _read_record(record)
