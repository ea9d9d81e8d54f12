"""The CG and general-BiCGStab loops on an Ell or Hybrid matrix: the plan
`EllCgKernels` (its launch code kernels/gather_loop.py `GatherCgKernels`),
whose loops are the Ell variants of the two loop kernels (`csrc/cg_loop.cu`,
`csrc/bicgstab_gen_loop.cu`; variant bit `LOOP_ELL`), their SpMV phases
the Ell row body `csrc/ell_rows.cuh` (a Hybrid's tail added in the same
row body), and the plain K1 `ell_k1_plain`.

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

import torch

from ogl_tpu_torch.core.formats import ELL_GROUP, Csr, Ell, Hybrid
from ogl_tpu_torch.kernels import gather_spmv
from ogl_tpu_torch.kernels.fused import LOOP_ELL
from ogl_tpu_torch.kernels.gather_loop import GatherCgKernels, gather_k1_plain

__all__ = ["EllCgKernels", "ell_k1_plain"]


def ell_k1_plain(m: Ell | Hybrid, z, p, beta):
    """(p', q, δ) with p' = z + β·p, q = A p' by the Ell (Hybrid) twin and
    δ = Σ p'·q, on any device: the K1 of the loop kernel's twin."""
    return gather_k1_plain(m, z, p, beta)


class EllCgKernels(GatherCgKernels):
    """The loops on one Ell or Hybrid sparsity (kernels/gather_loop.py
    `GatherCgKernels`): data = (Ell values, tail values or None)."""

    NAME, LOOP, SPMV = "ell", LOOP_ELL, gather_spmv.EllSpmv

    def __init__(self, mat: Ell | Hybrid):
        super().__init__(mat)
        self.hybrid = isinstance(mat, Hybrid)
        ell = mat.ell if self.hybrid else mat
        tail = mat.tail if self.hybrid else None
        self.k = ell.row_width
        self.cols, self.warp_slots = ell.cols, ell.warp_slots
        self.tail_ptr, self.tail_cols = (tail.row_ptr, tail.cols) if self.hybrid else (None, None)
        self.n_tail = tail.nnz if self.hybrid else 0
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

    def _operands(self, what, data, vectors):
        """(cols, vals, warp_slots, tail_ptr, tail_cols, tail_vals), the
        tail's three None without a tail."""
        vals, tail_vals = data
        checks = [("ell vals", vals, (self.k, self.n), torch.float32)]
        if self.hybrid:
            checks.append(("tail vals", tail_vals, (self.n_tail,), torch.float32))
        self._check_vectors(what, checks, vectors)
        tail = ((self.tail_ptr.data_ptr(), self.tail_cols.data_ptr(), tail_vals.data_ptr())
                if self.n_tail else (None,) * 3)
        return (self.cols.data_ptr(), vals.data_ptr(), self.warp_slots.data_ptr(), *tail)
