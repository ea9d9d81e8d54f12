"""The merged-CG and AMG-smoother kernels' plain versions (what the
wrappers run for CPU tensors) against the reference's Pallas K1/K2/K2i/K2n
and ksweep/kresid in interpret mode, on the same random inputs.
Elementwise outputs rtol=atol=1e-6; the block sums δ, ρ, ‖r‖₁ rtol=1e-5,
because they are summed in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogl_tpu import testing as ref_testing
from ogl_tpu.core import formats as ref_formats
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu.kernels.fused import make_cg_kernels
from ogl_tpu_torch import interop, kernels, registry
from ogl_tpu_torch.kernels.dia_spmv import dia_spmv_plain
from ogl_tpu_torch.kernels.fused import (CgKernels, k1_plain, k2_plain, k2i_plain,
                                         k2n_plain, kresid_plain, ksweep_plain)

torch.set_num_threads(2)

TILE = 16


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


@pytest.fixture(scope="module", params=[(128, 8), (96, 11)])
def case(request):
    ref = ref_formats.coo_to_dia(
        ref_ldu.ldu_to_coo_host(ref_testing.poisson_ldu(request.param), dtype=np.float32))
    rkern, data3 = make_cg_kernels(ref, tile=TILE, interpret=True)
    n = ref.shape[0]
    rng = np.random.default_rng(7)
    vec = {k: rng.normal(size=n).astype(np.float32) for k in ("x", "r", "p", "z", "q")}
    vec["invd"] = rng.uniform(0.1, 0.2, size=n).astype(np.float32)
    mat = interop.dia_from_arrays(np.asarray(ref.data), ref.offsets, ref.shape)
    return ref, rkern, data3, mat, vec


def _unframe(rkern, a):
    return interop.unframe_reference(np.asarray(a), rkern.n, rkern.tile)


def _t(a):
    return torch.tensor(a)


def _scalar(v):
    return torch.tensor(np.float32(v))


def test_k1_plain_matches_reference(case):
    ref, rkern, data3, mat, vec = case
    n, beta = ref.shape[0], 0.37
    pout, q, delta = rkern.k1(data3, rkern.frame(vec["z"]), rkern.frame(vec["p"]), beta)
    p2, q2, d2 = k1_plain(mat.data, mat.offsets, _t(vec["z"]), _t(vec["p"]), _scalar(beta))
    np.testing.assert_allclose(p2.numpy(), _unframe(rkern, pout), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(q2.numpy(), _unframe(rkern, q), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(d2), float(delta), rtol=1e-5)


def test_k2_plain_matches_reference(case):
    ref, rkern, data3, mat, vec = case
    n, alpha = ref.shape[0], -0.21
    fr = {k: rkern.frame(v) for k, v in vec.items()}
    xo, ro, zo, rho, absr = rkern.k2(alpha, fr["x"], fr["r"], fr["p"], fr["q"], fr["invd"])
    x, r, z = _t(vec["x"]), _t(vec["r"]), torch.empty(n)
    rho2, absr2 = k2_plain(_scalar(alpha), x, r, _t(vec["p"]), _t(vec["q"]),
                           _t(vec["invd"]), z)
    for got, want in ((x, xo), (r, ro), (z, zo)):
        np.testing.assert_allclose(got.numpy(), _unframe(rkern, want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(rho2), float(rho), rtol=1e-5)
    np.testing.assert_allclose(float(absr2), float(absr), rtol=1e-5)


def test_k2i_plain_matches_reference(case):
    ref, rkern, data3, mat, vec = case
    n, alpha = ref.shape[0], 0.55
    fr = {k: rkern.frame(v) for k, v in vec.items()}
    xo, ro, rho, absr = rkern.k2i(alpha, fr["x"], fr["r"], fr["p"], fr["q"])
    x, r = _t(vec["x"]), _t(vec["r"])
    rho2, absr2 = k2i_plain(_scalar(alpha), x, r, _t(vec["p"]), _t(vec["q"]))
    np.testing.assert_allclose(x.numpy(), _unframe(rkern, xo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(r.numpy(), _unframe(rkern, ro), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(rho2), float(rho), rtol=1e-5)
    np.testing.assert_allclose(float(absr2), float(absr), rtol=1e-5)


def test_apply_matches_spmv_and_reference(case):
    ref, rkern, data3, mat, vec = case
    n = ref.shape[0]
    kern = CgKernels(n, mat.offsets, "cpu")
    data = kern.pack_values(mat)
    kernels.reset_launches()
    y = kern.apply(data, _t(vec["x"]))
    assert sum(kernels.launches.values()) == 0  # CPU tensors: plain versions
    torch.testing.assert_close(y, dia_spmv_plain(data, mat.offsets, _t(vec["x"])))
    y_ref = _unframe(rkern, rkern.apply(data3, rkern.frame(jnp.asarray(vec["x"]))))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(y_ref).max()))


def test_wrappers_dispatch_cpu_tensors_to_plain(case):
    ref, rkern, data3, mat, vec = case
    n = ref.shape[0]
    kern = CgKernels(n, mat.offsets, "cpu")
    data = kern.pack_values(mat)
    alpha, beta = _scalar(0.3), _scalar(0.6)
    got = kern.k1(data, _t(vec["z"]), _t(vec["p"]), beta)
    want = k1_plain(data, mat.offsets, _t(vec["z"]), _t(vec["p"]), beta)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    x1, r1, z1 = _t(vec["x"]), _t(vec["r"]), torch.empty(n)
    x2, r2, z2 = _t(vec["x"]), _t(vec["r"]), torch.empty(n)
    s1 = kern.k2(alpha, x1, r1, _t(vec["p"]), _t(vec["q"]), _t(vec["invd"]), z1)
    s2 = k2_plain(alpha, x2, r2, _t(vec["p"]), _t(vec["q"]), _t(vec["invd"]), z2)
    for g, w in zip((x1, r1, z1, *s1), (x2, r2, z2, *s2)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="offsets"):
        CgKernels(n, mat.offsets[1:], "cpu").pack_values(mat)


def test_k2n_plain_matches_reference(case):
    ref, rkern, data3, mat, vec = case
    alpha = -0.37
    fr = {k: rkern.frame(v) for k, v in vec.items()}
    xo, ro, absr = rkern.k2n(alpha, fr["x"], fr["r"], fr["p"], fr["q"])
    x, r = _t(vec["x"]), _t(vec["r"])
    absr2 = k2n_plain(_scalar(alpha), x, r, _t(vec["p"]), _t(vec["q"]))
    np.testing.assert_allclose(x.numpy(), _unframe(rkern, xo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(r.numpy(), _unframe(rkern, ro), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(absr2), float(absr), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoother_plain_matches_reference(case, dtype):
    """ksweep/kresid on coefficients packed in `dtype` (the reference packs
    its smoother operators in bfloat16); both widen them to float32."""
    ref, rkern, data3, mat, vec = case
    relax = 0.9
    data3 = rkern.pack_values(ref, dtype=getattr(jnp, dtype))
    data = CgKernels(ref.shape[0], mat.offsets, "cpu").pack_values(
        mat, dtype=getattr(torch, dtype))
    fr = {k: rkern.frame(v) for k, v in vec.items()}
    want_sweep = _unframe(rkern, rkern.ksweep(data3, fr["x"], fr["r"], fr["invd"], relax))
    want_resid = _unframe(rkern, rkern.kresid(data3, fr["x"], fr["r"]))
    x, b, invd = _t(vec["x"]), _t(vec["r"]), _t(vec["invd"])
    np.testing.assert_allclose(ksweep_plain(data, mat.offsets, x, b, invd, relax).numpy(),
                               want_sweep, rtol=1e-6, atol=1e-6 * np.abs(want_sweep).max())
    np.testing.assert_allclose(kresid_plain(data, mat.offsets, x, b).numpy(),
                               want_resid, rtol=1e-6, atol=1e-6 * np.abs(want_resid).max())


def test_smoother_wrappers_dispatch_cpu_tensors_to_plain(case):
    ref, rkern, data3, mat, vec = case
    n = ref.shape[0]
    kern = CgKernels(n, mat.offsets, "cpu")
    data = kern.pack_values(mat, dtype=torch.bfloat16)
    x, b, invd = _t(vec["x"]), _t(vec["r"]), _t(vec["invd"])
    kernels.reset_launches()
    got = kern.ksweep(data, x, b, invd, 0.9)
    torch.testing.assert_close(got, ksweep_plain(data, mat.offsets, x, b, invd, 0.9),
                               rtol=0, atol=0)
    out = torch.empty(n)
    assert kern.kresid(data, x, b, out=out) is out
    torch.testing.assert_close(out, kresid_plain(data, mat.offsets, x, b), rtol=0, atol=0)
    a1, a2 = _t(vec["x"]), _t(vec["x"])
    r1, r2 = _t(vec["r"]), _t(vec["r"])
    s1 = kern.k2n(_scalar(0.3), a1, r1, _t(vec["p"]), _t(vec["q"]))
    s2 = k2n_plain(_scalar(0.3), a2, r2, _t(vec["p"]), _t(vec["q"]))
    for g, w in ((a1, a2), (r1, r2), (s1, s2)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert sum(kernels.launches.values()) == 0
    with pytest.raises(ValueError, match="overlaps"):
        kern.ksweep(data, x, b, invd, 0.9, out=x)
    with pytest.raises(ValueError, match="overlaps"):
        kern.kresid(data, x, b, out=b[1:])
