"""LDU → row-major sparse conversion (the HostMatrix layer).

Counterpart: ogl_tpu/core/ldu.py.  The host half (sparsity build, raw
source blocks, host assembly) is the reference's: its native C++ sparsity
build and counting sort (ogl_tpu_torch/native `init_local_sparsity`,
`sort_coo`, bit-equal to the reference's library) where the native runtime
builds, else its numpy branch, carried over unchanged.  The device half is one gather on the solver's device:
`assemble_from_blocks` concatenates the resident source blocks and
gathers them into row-major entry order with `torch.index_select`.

OpenFOAM stores a matrix as (diag, upper, lower) plus face addressing
(lowerAddr = owner cell, upperAddr = neighbour cell per internal face).
Source-value layout (what `permute` indexes into):
  symmetric:      [ upper(0:F) | diag(F:F+n) | local_iface(F+n:) ]
  non-symmetric:  [ upper(0:F) | lower(F:2F) | diag(2F:2F+n) | local_iface ]
with F = n_faces.  Interface coefficients enter negated (HostMatrix.C:204).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ogl_tpu_torch.core import formats

__all__ = [
    "LocalInterface",
    "LduMatrix",
    "LduSparsity",
    "build_local_sparsity",
    "assemble_coeffs_host",
    "assemble_from_blocks",
    "ldu_to_coo_host",
]


@dataclasses.dataclass(frozen=True)
class LocalInterface:
    """A non-processor coupled boundary (cyclic patch): couples local cell
    `rows[i]` to local cell `cols[i]` (reference HostMatrix.C:309-331)."""

    rows: np.ndarray  # face_cells (owner cell per interface face)
    cols: np.ndarray  # coupled local cell
    coeffs: np.ndarray  # interfaceBouCoeffs for this patch (NOT yet negated)


@dataclasses.dataclass(frozen=True)
class LduMatrix:
    """One rank's LDU system (host container).

    upper_addr[f] = neighbour cell of face f (column of the upper entry);
    lower_addr[f] = owner cell of face f (row of the upper entry).
    `lower` is None for symmetric matrices (the lower triangle reuses the
    upper coefficients).  Processor interfaces belong to the distributed
    layer, which the port does not have yet.
    """

    n: int
    lower_addr: np.ndarray
    upper_addr: np.ndarray
    diag: np.ndarray
    upper: np.ndarray
    lower: np.ndarray | None = None
    local_interfaces: tuple[LocalInterface, ...] = ()

    @property
    def symmetric(self) -> bool:
        return self.lower is None

    @property
    def n_faces(self) -> int:
        return int(len(self.upper_addr))


@dataclasses.dataclass(frozen=True)
class LduSparsity:
    """Precomputed sparsity + gather table for one rank's local matrix.

    rows/cols: row-major sorted local COO structure (incl. local interfaces).
    permute:   dest→source gather indices into the source-value layout above.
    """

    n: int
    n_faces: int
    symmetric: bool
    rows: np.ndarray
    cols: np.ndarray
    permute: np.ndarray
    n_local_iface: int

    @property
    def nnz(self) -> int:
        return int(len(self.rows))


def _interior_sparsity(n: int, lower_addr, upper_addr, symmetric: bool):
    """Row-major sorted (rows, cols, permute) of the interior matrix
    (reference init_local_sparsity, HostMatrixFreeFunctions.C:105-201).
    permute: upper face f -> f; lower face f -> f (symmetric) or F + f;
    diag row r -> after_nbrs + r, after_nbrs = F (symmetric) or 2F."""
    from ogl_tpu_torch import native

    lower_addr = np.asarray(lower_addr, np.int64)
    upper_addr = np.asarray(upper_addr, np.int64)
    nat = native.init_local_sparsity(n, lower_addr, upper_addr, symmetric)
    if nat is not None:
        return nat  # int32 triple, as LduSparsity stores it
    nf = len(upper_addr)
    after_nbrs = nf if symmetric else 2 * nf
    faces = np.arange(nf, dtype=np.int64)
    diag_idx = np.arange(n, dtype=np.int64)

    rows = np.concatenate([lower_addr, upper_addr, diag_idx])
    cols = np.concatenate([upper_addr, lower_addr, diag_idx])
    src = np.concatenate(
        [faces, faces if symmetric else nf + faces, after_nbrs + diag_idx]
    )
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], src[order]


def build_local_sparsity(ldu: LduMatrix) -> LduSparsity:
    """Full local sparsity: interior + local (cyclic) interfaces merged
    row-major (reference HostMatrix.C:469-589).  Local-interface entry i
    (in interface enumeration order) gets permute = after_nbrs + n + i."""
    rows, cols, permute = _interior_sparsity(
        ldu.n, ldu.lower_addr, ldu.upper_addr, ldu.symmetric
    )
    n_iface = sum(len(li.rows) for li in ldu.local_interfaces)
    if n_iface:
        nf = ldu.n_faces
        after_nbrs = nf if ldu.symmetric else 2 * nf
        irows = np.concatenate([np.asarray(li.rows, np.int64) for li in ldu.local_interfaces])
        icols = np.concatenate([np.asarray(li.cols, np.int64) for li in ldu.local_interfaces])
        isrc = after_nbrs + ldu.n + np.arange(n_iface, dtype=np.int64)
        rows = np.concatenate([rows, irows])
        cols = np.concatenate([cols, icols])
        permute = np.concatenate([permute, isrc])
        from ogl_tpu_torch import native

        nat = native.sort_coo(ldu.n, rows, cols)
        if nat is not None:  # native counting sort (HostMatrix.C:506-586 role)
            rows, cols, order = nat
        else:
            order = np.lexsort((cols, rows))
            rows, cols = rows[order], cols[order]
        permute = permute[order]
    return LduSparsity(
        n=ldu.n,
        n_faces=ldu.n_faces,
        symmetric=ldu.symmetric,
        rows=np.asarray(rows, np.int32),
        cols=np.asarray(cols, np.int32),
        permute=np.asarray(permute, np.int32),
        n_local_iface=n_iface,
    )


def host_blocks(sp: LduSparsity, m: LduMatrix, dtype) -> list:
    """The raw LDU source blocks [upper, (lower,) diag, (-local_iface)] as
    separate host arrays, in the source-layout order.  Kept split so the
    solver uploads only the blocks whose values changed since the previous
    step: in transient CFD the off-diagonal coefficients are often constant
    while only diag/RHS carry the time-step terms."""
    parts = [np.asarray(m.upper, dtype)]
    if not sp.symmetric:
        parts.append(np.asarray(m.lower, dtype))
    parts.append(np.asarray(m.diag, dtype))
    if sp.n_local_iface:
        parts.append(-np.concatenate(
            [np.asarray(li.coeffs, dtype) for li in m.local_interfaces]))
    return parts


def assemble_from_blocks(blocks, permute: torch.Tensor, scale: float) -> torch.Tensor:
    """Device-side concat of the resident source blocks + the row-major
    gather (counterpart of `_assemble_from_blocks`): one `index_select`
    on the blocks' device, entries in the sparsity's row-major order."""
    src = torch.cat(blocks) if len(blocks) > 1 else blocks[0]
    vals = torch.index_select(src, 0, permute)
    return vals if scale == 1.0 else scale * vals


def assemble_coeffs_host(sp: LduSparsity, m: LduMatrix, dtype, scale=1.0) -> np.ndarray:
    """Row-major coefficient array assembled entirely on the host (numpy
    gather), for consumers that need the values host-side (format
    conversion, preconditioner setup)."""
    parts = host_blocks(sp, m, dtype)
    src = np.concatenate(parts) if len(parts) > 1 else np.asarray(parts[0])
    out = src[np.asarray(sp.permute)]
    if scale != 1.0:
        out = out * np.asarray(scale, src.dtype)
    return out


def ldu_to_coo_host(ldu: LduMatrix, scale=1.0, dtype=None) -> formats.Coo:
    """Host-only assembly: a Coo whose fields are numpy arrays."""
    sp = build_local_sparsity(ldu)
    parts = [np.asarray(ldu.upper)]
    if not ldu.symmetric:
        parts.append(np.asarray(ldu.lower))
    parts.append(np.asarray(ldu.diag))
    if ldu.local_interfaces:
        parts.append(-np.concatenate([np.asarray(li.coeffs) for li in ldu.local_interfaces]))
    src = np.concatenate(parts)
    if dtype is not None:
        src = src.astype(dtype)
    vals = (scale * src[sp.permute]).astype(src.dtype)
    return formats.Coo(rows=sp.rows, cols=sp.cols, vals=vals, shape=(ldu.n, ldu.n))
