"""Problem generators shared by tests and the chip smoke run.

Counterpart: ogl_tpu/testing.py (`grid_shape`, `poisson_ldu`,
`convection_diffusion_ldu`, `to_dense_ldu`, `poisson_dense`,
`channel_ldu`), carried over unchanged: the same numpy outputs, returned as
the port's LduMatrix.

The unstructured meshes have no counterpart there: `knn_ldu` is the
fully unstructured FV graph of the reference's bench (bench.py:987-1005,
with the shifted-Laplacian values of :1063-1076) in LDU form,
`shuffled_poisson_ldu` a Poisson grid renumbered inside each 128-cell run,
and `renumber_ldu` applies a cell renumbering to a symmetric LDU system.
`entries_update` writes a container's values from a COO entry array by
the steady step's own plans (the reference's `ValueMap.update`, which the
port does not carry).
"""

from __future__ import annotations

import numpy as np
import torch

from ogl_tpu_torch.core import formats, ldu

__all__ = ["poisson_ldu", "poisson_dense", "convection_diffusion_ldu",
           "to_dense_ldu", "grid_shape", "channel_ldu", "renumber_ldu", "knn_ldu",
           "shuffled_poisson_ldu", "entries_update"]


def entries_update(vm: formats.ValueMap, m, vals: torch.Tensor):
    """The container `m` with the values of the row-major COO entry array
    `vals` (on the matrix's device), written as a steady step writes one
    block read at positions 0..n-1: its `block_update_plans` plan, or the
    `accumulate_plan` where slots take several entries, through the
    value-update kernel into zeros."""
    from ogl_tpu_torch.kernels.value_update import value_update

    ident = np.arange(len(vals))
    plans = formats.block_update_plans(vm, ident, [len(vals)], vals.device)
    write = (plans[0].write(block=0, scale=1.0) if plans is not None else
             formats.accumulate_plan(vm, ident, vals.device).write(block=0, scale=1.0))
    flat = torch.zeros(int(np.prod(vm.out_shape)), dtype=vals.dtype, device=vals.device)
    value_update(flat, [(vals, None, None)], [write])
    return formats.with_values(m, flat.view(vm.out_shape))


def renumber_ldu(m: ldu.LduMatrix, inv) -> ldu.LduMatrix:
    """The symmetric system `m` with old cell i renamed inv[i]: faces keep
    owner < neighbour and are sorted by (owner, neighbour), as OpenFOAM
    orders them; the coefficients follow their faces and cells."""
    inv = np.asarray(inv, np.int64)
    lo, hi = inv[np.asarray(m.lower_addr)], inv[np.asarray(m.upper_addr)]
    own, nbr = np.minimum(lo, hi), np.maximum(lo, hi)
    order = np.lexsort((nbr, own))
    diag = np.empty(m.n, np.asarray(m.diag).dtype)
    diag[inv] = m.diag
    return ldu.LduMatrix(n=m.n, lower_addr=own[order], upper_addr=nbr[order], diag=diag,
                         upper=np.asarray(m.upper)[order])


def knn_ldu(n: int, seed: int = 0) -> tuple[ldu.LduMatrix, np.ndarray]:
    """The k-nearest-neighbour FV graph of the reference's unstructured
    bench lane: `n` random points in the unit cube (numpy default_rng
    `seed`), each joined to its 6 nearest neighbours, symmetrised; faces
    are the unique pairs owner < neighbour, upper = −1 and diag = degree +
    1 (the shifted graph Laplacian, SPD).  Returns the system in the
    points' numbering and the reverse Cuthill-McKee permutation of the
    graph (perm[k] = old cell of new cell k)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from scipy.spatial import cKDTree

    pts = np.random.default_rng(seed).random((n, 3))
    _, idx = cKDTree(pts).query(pts, k=7, workers=-1)
    src = np.repeat(np.arange(n), 6)
    dst = idx[:, 1:].ravel()
    keep = src != dst
    r = np.concatenate([src[keep], dst[keep]])
    c = np.concatenate([dst[keep], src[keep]])
    a = sp.coo_matrix((np.ones(len(r), np.int8), (r, c)), shape=(n, n)).tocsr()
    perm = np.ascontiguousarray(reverse_cuthill_mckee(a, symmetric_mode=True))
    a = a.tocoo()
    upper = a.row < a.col
    own, nbr = a.row[upper].astype(np.int64), a.col[upper].astype(np.int64)
    order = np.lexsort((nbr, own))
    deg = np.bincount(a.row, minlength=n)
    m = ldu.LduMatrix(n=n, lower_addr=own[order], upper_addr=nbr[order],
                      diag=deg + 1.0, upper=np.full(len(own), -1.0))
    return m, perm


def shuffled_poisson_ldu(dims, seed: int = 0) -> ldu.LduMatrix:
    """`poisson_ldu(dims)` with its cells renumbered by a random
    permutation (numpy default_rng `seed`) inside each run of 128
    consecutive cells: far more than 64 distinct diagonals, while every
    coupling stays within the block rows a stencil reaches."""
    m = poisson_ldu(dims)
    if m.n % 128:
        raise ValueError(f"{m.n} cells is not a whole number of 128-cell runs")
    runs = np.arange(m.n // 128)[:, None] * 128
    inv = (runs + np.random.default_rng(seed).permuted(
        np.tile(np.arange(128), (m.n // 128, 1)), axis=1)).ravel()
    return renumber_ldu(m, inv)


def grid_shape(dims):
    return (dims, 1, 1) if isinstance(dims, int) else tuple(dims) + (1,) * (3 - len(dims))


def poisson_ldu(dims, dirichlet_boundary: bool = True) -> ldu.LduMatrix:
    """FV Poisson (pressure-equation-like) system on a structured grid in
    OpenFOAM LDU form: faces sorted by (owner, neighbour) ascending owners,
    diag = number of neighbours (+ boundary contribution), upper = -1.

    dims: int or tuple up to 3-D.  With dirichlet_boundary=True boundary
    cells get an extra diagonal unit (pinning the nullspace, like a fixed-
    value patch); otherwise the matrix is singular (pure Neumann) like a
    real incompressible pressure equation.
    """
    nx, ny, nz = grid_shape(dims)
    n = nx * ny * nz
    cid = np.arange(n).reshape(nz, ny, nx)  # (k, j, i) layout

    owners, nbrs = [], []
    if nx > 1:
        owners.append(cid[:, :, :-1].ravel())
        nbrs.append(cid[:, :, 1:].ravel())
    if ny > 1:
        owners.append(cid[:, :-1, :].ravel())
        nbrs.append(cid[:, 1:, :].ravel())
    if nz > 1:
        owners.append(cid[:-1, :, :].ravel())
        nbrs.append(cid[1:, :, :].ravel())
    owners = np.concatenate(owners) if owners else np.zeros(0, np.int64)
    nbrs = np.concatenate(nbrs) if nbrs else np.zeros(0, np.int64)
    order = np.lexsort((nbrs, owners))
    lower_addr = owners[order].astype(np.int64)
    upper_addr = nbrs[order].astype(np.int64)
    diag = np.zeros(n)
    np.add.at(diag, lower_addr, 1.0)
    np.add.at(diag, upper_addr, 1.0)
    if dirichlet_boundary:
        # boundary faces contribute to the diagonal only
        bmask = np.zeros((nz, ny, nx))
        for ax, m in ((2, nx), (1, ny), (0, nz)):
            if m > 1:
                idx = [slice(None)] * 3
                idx[ax] = 0
                bmask[tuple(idx)] += 1
                idx[ax] = m - 1
                bmask[tuple(idx)] += 1
        diag += bmask.ravel()
    return ldu.LduMatrix(
        n=n,
        lower_addr=lower_addr,
        upper_addr=upper_addr,
        diag=diag,
        upper=np.full(len(lower_addr), -1.0),
    )


def convection_diffusion_ldu(dims, peclet: float = 0.5) -> ldu.LduMatrix:
    """Non-symmetric convection-diffusion system (upwinded convection adds
    ±peclet to the off-diagonals), exercising the asymmetric LDU path."""
    base = poisson_ldu(dims)
    nf = base.n_faces
    upper = base.upper - peclet  # downstream coupling
    lower = np.full(nf, -1.0) + peclet  # upstream coupling
    diag = base.diag + 2 * abs(peclet)  # keep diagonally dominant
    return ldu.LduMatrix(
        n=base.n,
        lower_addr=base.lower_addr,
        upper_addr=base.upper_addr,
        diag=diag,
        upper=upper,
        lower=lower,
    )


def to_dense_ldu(m: ldu.LduMatrix) -> np.ndarray:
    """Densify any LduMatrix (incl. non-symmetric and local interfaces)."""
    a = np.zeros((m.n, m.n))
    np.fill_diagonal(a, m.diag)
    lower = m.upper if m.symmetric else m.lower
    np.add.at(a, (np.asarray(m.lower_addr), np.asarray(m.upper_addr)),
              np.asarray(m.upper))
    np.add.at(a, (np.asarray(m.upper_addr), np.asarray(m.lower_addr)),
              np.asarray(lower))
    for li in m.local_interfaces:
        np.add.at(a, (np.asarray(li.rows), np.asarray(li.cols)),
                  -np.asarray(li.coeffs))
    return a


def poisson_dense(dims, dirichlet_boundary: bool = True) -> np.ndarray:
    return to_dense_ldu(poisson_ldu(dims, dirichlet_boundary))


def channel_ldu(dims, aniso: float = 4.0) -> ldu.LduMatrix:
    """Periodic-channel pressure system (the reference's second integration
    case family: periodicPlaneChannel/channel395, a cyclic-BC LES channel,
    test_matrix.json + integration.yaml): FV Poisson on a structured grid,
    PERIODIC in x via a cyclic LocalInterface pairing the first and last
    x-planes, wall-normal anisotropy `aniso` on the y-direction couplings
    (stretched-grid transmissibility).  Diagonal gets a small fixed-value
    pin so the periodic system stays SPD."""
    nx, ny, nz = grid_shape(dims)
    base = poisson_ldu(dims, dirichlet_boundary=False)
    n = base.n
    cid = np.arange(n).reshape(nz, ny, nx)

    # anisotropy: faces in the y direction carry coefficient -aniso
    upper = np.asarray(base.upper).copy()
    diag = np.asarray(base.diag).copy()
    if ny > 1:
        lo, up = base.lower_addr, base.upper_addr
        y_face = (up - lo) == nx  # neighbour one y-row away
        upper[y_face] = -aniso
        extra = (aniso - 1.0)
        np.add.at(diag, lo[y_face], extra)
        np.add.at(diag, up[y_face], extra)

    ifaces = ()
    if nx > 2:
        left = cid[:, :, 0].ravel()
        right = cid[:, :, -1].ravel()
        rows = np.concatenate([left, right])
        cols = np.concatenate([right, left])
        coeffs = np.ones(rows.shape[0])
        ifaces = (ldu.LocalInterface(rows=rows, cols=cols, coeffs=coeffs),)
        np.add.at(diag, left, 1.0)
        np.add.at(diag, right, 1.0)
    # pin the nullspace (pure-Neumann + periodic would be singular)
    diag[0] += 1.0
    return ldu.LduMatrix(
        n=n,
        lower_addr=base.lower_addr,
        upper_addr=base.upper_addr,
        diag=diag,
        upper=upper,
        local_interfaces=ifaces,
    )