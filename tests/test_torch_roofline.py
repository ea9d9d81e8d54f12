"""The port's roofline module against the reference's (ogl_tpu/kernels/
roofline.py on JAX CPU): the read-peak data, the plane sum, the SpMV byte
and flop model, `Roofline`, the measurements on CPU tensors and the
published-rate table.

The reference's CPU `one_pass` computes sum(d3, 0)·s, which scales every
plane, while its TPU kernel `_rk` (and the port) scale only plane 0: the
two functions agree at s = c = 1, where the parity test is written.
Tolerance there: 1e-6 of the sum's largest magnitude (XLA may add the
planes in another order; 6 float32 roundings of partial sums below 10 are
below that)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogl_tpu import testing as ref_testing
from ogl_tpu.core import formats as ref_formats
from ogl_tpu.core import ldu as ref_ldu
from ogl_tpu.kernels import gdia as ref_gdia
from ogl_tpu.kernels import roofline as ref_roofline
from ogl_tpu.kernels import xell as ref_xell
from ogl_tpu_torch import kernels, testing
from ogl_tpu_torch.core import formats, ldu
from ogl_tpu_torch.kernels import device_time, gdia, roofline, xell
from ogl_tpu_torch.kernels.dia_spmv import DiaPlan, dia_spmv

torch.set_num_threads(2)

SHAPES = [(3, 256), (7, 64), (1, 16)]


@pytest.mark.parametrize("read_streams,rows", SHAPES)
def test_read_peak_data_equals_reference(read_streams, rows):
    _, d3, ref_bytes = ref_roofline._read_peak_kernel(read_streams, rows, 512)
    _, d, nbytes = roofline._read_peak_kernel(read_streams, rows, 512, device="cpu")
    assert d.dtype == torch.float32 and d.shape == (read_streams, rows * 128)
    np.testing.assert_array_equal(d.numpy(),
                                  np.asarray(d3).reshape(read_streams, rows * 128))
    assert nbytes == ref_bytes == (read_streams + 2) * rows * 128 * 4


@pytest.mark.parametrize("c", [1.0, 0.0, -2.5, 0.37])
@pytest.mark.parametrize("nd", [1, 3, 7, 9])
def test_plane_sum_plain_is_the_plane_order_accumulation(nd, c):
    d = np.random.default_rng(nd).normal(size=(nd, 1000)).astype(np.float32)
    want = d[0] * np.float32(c)
    for k in range(1, nd):
        want = want + d[k]
    got = roofline.plane_sum_plain(torch.tensor(c, dtype=torch.float32), torch.from_numpy(d))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("read_streams,rows", SHAPES[:2])
def test_plane_sum_matches_the_reference_at_c_one(read_streams, rows):
    ref_pass, d3, _ = ref_roofline._read_peak_kernel(read_streams, rows, 512)
    want = np.asarray(jnp.sum(d3, axis=0)).reshape(-1)
    one = torch.ones((), dtype=torch.float32)
    d = torch.from_numpy(np.array(d3).reshape(read_streams, -1))
    got = roofline.plane_sum_plain(one, d).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    one_pass, d_port, _ = roofline._read_peak_kernel(read_streams, rows, 512, device="cpu")
    # the chain's carry: sum(y)·1e-20 + 1 — 1.0 in float32 for both
    assert float(one_pass(one, d_port)) == float(ref_pass(jnp.float32(1.0), d3)) == 1.0


def test_plane_sum_on_cpu_tensors_runs_the_plain_version():
    d = torch.from_numpy(np.random.default_rng(1).normal(size=(7, 300)).astype(np.float32))
    c = torch.tensor(-0.5)
    kernels.reset_launches()
    assert torch.equal(roofline.plane_sum(c, d), roofline.plane_sum_plain(c, d))
    assert kernels.launches["read_peak"] == 0  # the count is of kernel launches only


def test_plane_sum_raises_without_a_kernel_for_the_device():
    d = torch.empty((7, 300), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        roofline.plane_sum(torch.ones((), device="meta"), d)


@pytest.mark.parametrize("n, d_ptr, y_ptr, want", [
    (256 * 256 * 128, 0, 512, (1, 528)),  # float4 quads, 4 blocks per SM
    (1 << 20, 256, 0, (1, 528)),
    (4096, 0, 0, (1, 4)),                 # fewer quads than the persistent grid
    (1000, 0, 0, (1, 1)),
    (1001, 0, 0, (0, 4)),                 # n % 4 != 0: the scalar branch
    (1002, 0, 0, (0, 4)),
    (1003, 0, 0, (0, 4)),
    (3, 0, 0, (0, 1)),                    # short n
    (1 << 20, 4, 0, (0, 528)),            # planes not 16-byte aligned
    (1 << 20, 0, 8, (0, 528)),            # y not 16-byte aligned
    (0, 0, 0, (1, 1)),
])
def test_plane_sum_launch_geometry(n, d_ptr, y_ptr, want):
    assert roofline.plane_sum_launch(n, d_ptr, y_ptr, 132) == want


def _systems(dims):
    m, ref_m = testing.poisson_ldu(dims), ref_testing.poisson_ldu(dims)
    coo = ldu.ldu_to_coo_host(m, dtype=np.float32)
    ref_coo = ref_ldu.ldu_to_coo_host(ref_m, dtype=np.float32)
    return {"Coo": (coo, ref_coo),
            "Dia": (formats.coo_to_dia(coo), ref_formats.coo_to_dia(ref_coo))}


@pytest.mark.parametrize("fmt", ["Coo", "Dia"])
@pytest.mark.parametrize("dims", [(24, 24), (12, 10, 8)], ids=str)
def test_spmv_bytes_and_flops_equal_the_reference(dims, fmt):
    port, ref = _systems(dims)[fmt]
    assert roofline.spmv_bytes(port) == ref_roofline.spmv_bytes(ref) > 0
    assert roofline.spmv_flops(port) == ref_roofline.spmv_flops(ref) > 0


@pytest.mark.parametrize("fmt", ["Gdia", "Xell"])
def test_spmv_bytes_of_unstructured_formats_raise_type_error(fmt):
    """Neither package models Gdia or Xell traffic: spmv_bytes raises
    TypeError in both; the port's spmv_flops too (the reference's fails on
    the missing nnz)."""
    port_coo, ref_coo = _systems((64, 64))["Coo"]
    if fmt == "Gdia":
        port, ref = gdia.gdia_from_coo(port_coo), ref_gdia.gdia_from_coo(ref_coo)
    else:
        port, ref = xell.xell_from_coo(port_coo), ref_xell.xell_from_coo(ref_coo)
    for fn in (roofline.spmv_bytes, roofline.spmv_flops, ref_roofline.spmv_bytes):
        with pytest.raises(TypeError):
            fn(ref if fn is ref_roofline.spmv_bytes else port)


@pytest.mark.parametrize("seconds,nbytes,peak", [(1e-4, 81_900_000, 819.0),
                                                  (3.3e-5, 301_989_888, 3350.0)])
def test_roofline_equals_the_reference(seconds, nbytes, peak):
    r = roofline.Roofline(seconds=seconds, bytes=nbytes, flops=7, peak_gbps=peak)
    ref = ref_roofline.Roofline(seconds=seconds, bytes=nbytes, flops=7, peak_gbps=peak)
    assert r.gbps == ref.gbps and r.fraction_of_peak == ref.fraction_of_peak


def _poisson_mv(dims):
    mat = formats.coo_to_dia(ldu.ldu_to_coo_host(testing.poisson_ldu(dims),
                                                 dtype=np.float32))
    plan = DiaPlan.of(mat)
    return mat, (lambda v, data: dia_spmv(plan, data, v))


def test_measure_chained_on_cpu_tensors():
    mat, mv = _poisson_mv((24, 24))
    x = torch.ones(mat.shape[0])
    r = roofline.measure_chained(mv, x, iters=64, operands=(mat.data,),
                                 bytes_moved=roofline.spmv_bytes(mat),
                                 flops=roofline.spmv_flops(mat))
    assert r.seconds > 0 and np.isfinite(r.gbps) and r.peak_gbps == 50.0
    r2 = roofline.measure_chained(mv, x, iters=256, operands=(mat.data,),
                                  bytes_moved=roofline.spmv_bytes(mat))
    assert r2.seconds < 20 * r.seconds  # the same order of magnitude
    auto = roofline.measure_chained(mv, x, target_seconds=0.05, operands=(mat.data,),
                                    bytes_moved=roofline.spmv_bytes(mat))
    assert auto.seconds > 0 and np.isfinite(auto.gbps)


def test_measure_on_cpu_tensors():
    mat, mv = _poisson_mv((16, 16))
    r = roofline.measure(mv, torch.ones(mat.shape[0]), mat.data, iters=5,
                         bytes_moved=roofline.spmv_bytes(mat))
    assert r.seconds > 0 and np.isfinite(r.gbps)


def test_stream_and_read_peaks_on_the_cpu():
    bw = roofline.measure_stream_peak(n=1 << 18, target_seconds=0.05, device="cpu")
    assert bw > 0 and np.isfinite(bw)
    bw = roofline.measure_read_peak(read_streams=3, rows=256, chain_len=50, device="cpu")
    assert bw > 0 and np.isfinite(bw)


def test_device_timeline_measurements_are_zero_on_the_cpu():
    mat, mv = _poisson_mv((16, 16))
    assert roofline.measure_device_chained(mv, torch.ones(mat.shape[0]), 8,
                                           operands=(mat.data,)) == 0.0
    assert roofline.measure_read_peak_device(read_streams=3, rows=16, iters=8,
                                             device="cpu") == 0.0


@pytest.mark.parametrize("name,gbps", [("NVIDIA H100 80GB HBM3", 3350.0),
                                       ("NVIDIA H200", 4800.0), ("cpu", 50.0)])
def test_hbm_peak_gbps_of_a_name(name, gbps):
    assert roofline.hbm_peak_gbps(name) == gbps


def test_hbm_peak_gbps_of_devices(monkeypatch):
    assert roofline.hbm_peak_gbps(torch.device("cpu")) == 50.0
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H200")
    assert roofline.hbm_peak_gbps(torch.device("cuda")) == 4800.0
    assert roofline.hbm_peak_gbps() == 4800.0  # None: the card
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert roofline.hbm_peak_gbps("cuda:0") == 3350.0


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe"])
def test_hbm_peak_gbps_of_an_unknown_card_raises(name):
    with pytest.raises(ValueError, match="no published memory rate"):
        roofline.hbm_peak_gbps(name)


@pytest.mark.parametrize("intervals,busy_us", [
    ([], 0.0),
    ([(0.0, 10.0)], 10.0),
    ([(0.0, 10.0), (20.0, 25.0)], 15.0),  # disjoint: the gap is idle
    ([(0.0, 10.0), (5.0, 12.0)], 12.0),  # overlapping: counted once
    ([(5.0, 12.0), (0.0, 30.0), (1.0, 2.0)], 30.0),  # nested, unsorted
])
def test_union_seconds_is_the_measure_of_the_union(intervals, busy_us):
    assert device_time.union_seconds(intervals) == pytest.approx(busy_us * 1e-6, abs=1e-15)
