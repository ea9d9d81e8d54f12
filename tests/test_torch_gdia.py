"""The port's Gdia format against the reference's: host packing and value
map (exact equality: the same numpy arithmetic), the plain SpMV and K1
twins against `spmv_gdia`, the Pallas `gdia_matvec(tile=16)` and
`GdiaCgKernels.k1` in interpret mode, and the RCM renumbering.

Tolerances: the plain versions sum the planes in the reference's order,
but the Pallas paths and sums of products may contract into fused
multiply-adds: elementwise rtol=atol=1e-5 of the output's max, the block
sum δ rtol 1e-5."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogl_tpu import testing as ref_testing
from ogl_tpu.core import formats as ref_formats
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu.core import reorder as ref_reorder
from ogl_tpu.kernels import gdia as ref_gdia
from ogl_tpu.kernels.fused import GdiaCgKernels as RefGdiaCgKernels
from ogl_tpu_torch import interop, kernels, registry, testing
from ogl_tpu_torch.core import formats, reorder
from ogl_tpu_torch.kernels import gdia, spmv
from ogl_tpu_torch.kernels.fused import GdiaCgKernels

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


def _random_sparse(seed, n):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n)) * (rng.random((n, n)) < 0.02)
    a = (a + a.T).astype(np.float32)
    np.fill_diagonal(a, 5.0)
    return a


def _ref_case(kind):
    """(reference Coo, max_planes): a structured stencil, a collision case
    (two entries of one row in one block-row class) and an RCM'd random
    graph."""
    if kind == "stencil":
        return ref_ldu.ldu_to_coo_host(ref_testing.poisson_ldu((64, 4, 2)),
                                       dtype=np.float32), 64
    if kind == "collision":
        a = np.eye(8, dtype=np.float32) * 4.0
        a[0, 1], a[0, 2], a[5, 0] = -1.0, -2.0, 0.5
        return ref_formats.coo_from_dense(a), 64
    coo = ref_formats.coo_from_dense(_random_sparse(1, 400))
    return ref_reorder.permute_coo(coo, ref_reorder.rcm_permutation(coo)), 512


def _port_coo(c):
    return formats.Coo(rows=np.asarray(c.rows), cols=np.asarray(c.cols),
                       vals=np.asarray(c.vals), shape=tuple(c.shape))


CASES = ["stencil", "collision", "rcm_graph"]


@pytest.fixture(scope="module", params=CASES)
def case(request):
    coo, max_planes = _ref_case(request.param)
    ref = ref_gdia.gdia_from_coo(coo, max_planes=max_planes)
    mat = gdia.gdia_from_coo(_port_coo(coo), max_planes=max_planes)
    rng = np.random.default_rng(11)
    vec = {k: rng.normal(size=coo.shape[0]).astype(np.float32) for k in ("x", "z", "p")}
    return coo, max_planes, ref, mat, vec


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def test_layout_and_container_match_reference(case):
    coo, max_planes, ref, mat, _ = case
    rows, cols = np.asarray(coo.rows), np.asarray(coo.cols)
    ours = gdia.gdia_layout(rows, cols, coo.shape[0], max_planes)
    theirs = ref_gdia.gdia_layout(rows, cols, coo.shape[0], max_planes)
    assert ours[:2] == theirs[:2]
    for a, b in zip(ours[2:], theirs[2:]):
        np.testing.assert_array_equal(a, b)
    assert mat.plane_offsets == ref.plane_offsets and mat.shape == ref.shape
    assert mat.vals.dtype == torch.float32 and mat.lidx.dtype == torch.int8
    np.testing.assert_array_equal(mat.vals.numpy(), np.asarray(ref.vals))
    np.testing.assert_array_equal(mat.lidx.numpy(), np.asarray(ref.lidx))
    back = interop.gdia_from_reference(ref)
    assert back.plane_offsets == mat.plane_offsets and back.shape == mat.shape
    assert torch.equal(back.vals, mat.vals) and torch.equal(back.lidx, mat.lidx)


def test_plain_spmv_matches_reference(case):
    coo, _, ref, mat, vec = case
    y = gdia.spmv_gdia(mat, torch.tensor(vec["x"]))
    _close(y.numpy(), ref_gdia.spmv_gdia(ref, jnp.asarray(vec["x"])))
    _close(y.numpy(), ref_gdia.gdia_matvec(ref, tile=16, interpret=True)(
        jnp.asarray(vec["x"])))
    a = np.asarray(ref_formats.to_dense(coo), np.float64)
    _close(y.numpy(), a @ vec["x"].astype(np.float64))


def test_plain_k1_matches_reference(case):
    _, _, ref, mat, vec = case
    n, beta = ref.shape[0], 0.37
    rk = RefGdiaCgKernels(n, ref.plane_offsets, interpret=True)
    pout, q, delta = rk.k1(rk.pack_values(ref), rk.frame(vec["z"]), rk.frame(vec["p"]), beta)
    p2, q2, d2 = gdia.gdia_k1_plain(mat.vals, mat.lidx, mat.plane_offsets,
                                    torch.tensor(vec["z"]), torch.tensor(vec["p"]),
                                    torch.tensor(np.float32(beta)))
    _close(p2.numpy(), rk.unframe(pout))
    _close(q2.numpy(), rk.unframe(q))
    np.testing.assert_allclose(float(d2), float(delta), rtol=1e-5)


def test_wrappers_dispatch_cpu_tensors_to_plain(case):
    _, _, ref, mat, vec = case
    n = ref.shape[0]
    plan = gdia.GdiaPlan.of(mat)
    x, z, p = (torch.tensor(vec[k]) for k in ("x", "z", "p"))
    beta = torch.tensor(np.float32(0.6))
    kernels.reset_launches()
    torch.testing.assert_close(gdia.gdia_spmv(plan, mat.vals, mat.lidx, x),
                               gdia.spmv_gdia(mat, x), rtol=0, atol=0)
    torch.testing.assert_close(spmv.matvec(mat)(x), spmv.spmv(mat, x), rtol=0, atol=0)
    kern = GdiaCgKernels(n, mat.plane_offsets, "cpu")
    data = kern.pack_values(mat)
    got = kern.k1(data, z, p, beta)
    want = gdia.gdia_k1_plain(mat.vals, mat.lidx, mat.plane_offsets, z, p, beta)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    torch.testing.assert_close(kern.apply(data, x), gdia.spmv_gdia(mat, x), rtol=0, atol=0)
    assert sum(kernels.launches.values()) == 0  # CPU tensors: plain versions
    with pytest.raises(ValueError, match="plane offsets"):
        GdiaCgKernels(n, (0,) * (len(mat.plane_offsets) + 1), "cpu").pack_values(mat)


@pytest.mark.parametrize("keep_layout", [True, False], ids=["layout_kept", "recomputed"])
@pytest.mark.parametrize("kind", CASES)
def test_value_map_update_equals_fresh_convert(kind, keep_layout):
    """The steady-state update equals a fresh conversion; a container that
    kept its conversion's host layout gives the same map as a recomputed
    one."""
    coo, max_planes = _ref_case(kind)
    pc = _port_coo(coo)
    mat = gdia.gdia_from_coo(pc, max_planes=max_planes)
    if not keep_layout:
        mat = dataclasses.replace(mat, layout=None)
    vm = formats.value_map(mat, pc.rows, pc.cols)
    assert vm.unique and vm.out_shape == tuple(mat.vals.shape)
    new = (np.random.default_rng(2).normal(size=len(pc.vals))).astype(np.float32)
    updated = testing.entries_update(vm, mat, torch.tensor(new))
    fresh = gdia.gdia_from_coo(formats.Coo(pc.rows, pc.cols, new, pc.shape),
                               max_planes=max_planes)
    torch.testing.assert_close(updated.vals, fresh.vals, rtol=0, atol=0)
    assert updated.lidx is mat.lidx and updated.plane_offsets == mat.plane_offsets
    ref_vm = ref_formats.value_map(ref_gdia.gdia_from_coo(coo, max_planes=max_planes),
                                   coo.rows, coo.cols)
    np.testing.assert_array_equal(vm.dest.numpy(), np.asarray(ref_vm.dest))


def test_value_map_rejects_changed_sparsity():
    coo, _ = _ref_case("stencil")
    mat = gdia.gdia_from_coo(_port_coo(coo))
    other = _port_coo(ref_ldu.ldu_to_coo_host(ref_testing.poisson_ldu((64, 8)),
                                              dtype=np.float32))
    with pytest.raises(ValueError, match="sparsity changed"):
        formats.value_map(mat, other.rows, other.cols)


def test_plane_cap_raises_like_reference():
    coo = ref_formats.coo_from_dense(_random_sparse(3, 600))
    for mod in (gdia, ref_gdia):
        with pytest.raises(ValueError, match="renumber"):
            mod.gdia_layout(np.asarray(coo.rows), np.asarray(coo.cols), 600, max_planes=4)


def test_reorder_matches_reference():
    coo = ref_formats.coo_from_dense(_random_sparse(4, 300))
    pc = _port_coo(coo)
    perm = reorder.rcm_permutation(pc)
    np.testing.assert_array_equal(perm, ref_reorder.rcm_permutation(coo))
    ours, theirs = reorder.permute_coo(pc, perm), ref_reorder.permute_coo(coo, perm)
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(ours, f), np.asarray(getattr(theirs, f)))
    assert reorder.bandwidth(ours) == ref_reorder.bandwidth(theirs) < reorder.bandwidth(pc)
