"""The value update's body (ogl_tpu_torch/kernels/csrc/value_update.cuh) on
the CPU: compiled by g++ against the stand-ins for the CUDA runtime
(tests/cuda_emu), its work items run in a shuffled order, the decoded
blocks and the written values held bit-equal to the plain twin
(`value_update_plain`) — an affine block, a scatter, a gather through a
symmetric block's src table, a bfloat16 delta decoded while other items
gather the same positions, slots summed in entry order over all blocks,
and many blocks in one call."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ogl_tpu_torch.kernels import value_update as vu
from ogl_tpu_torch.kernels.value_update import Write

EMU = Path(__file__).parent / "cuda_emu"
CSRC = Path(vu.__file__).parent / "csrc"


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU stand-in")
    d = tmp_path_factory.mktemp("value_update_emu")
    shutil.copy(CSRC / "value_update.cuh", d)
    for f in EMU.iterdir():
        shutil.copy(f, d)
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-I", str(d),
                    "-o", str(d / "emu"), str(d / "value_update_main.cpp")], check=True,
                   capture_output=True)
    return d / "emu"


def _i32(t):
    return t.numpy().astype(np.int32).tobytes()


def run_emu(emu, tmp_path, flat, sources, writes, seed):
    path = tmp_path / f"in{seed}.bin"
    with open(path, "wb") as f:
        f.write(np.array([len(sources), len(writes), seed], np.int32).tobytes())
        f.write(np.int64(flat.numel()).tobytes())
        for old, delta, out in sources:
            f.write(np.int64(old.numel()).tobytes())
            f.write(np.array([delta is not None, out is not None], np.int32).tobytes())
            f.write(old.numpy().tobytes())
            if delta is not None:
                f.write(delta.view(torch.int16).numpy().tobytes())
        for w in writes:
            f.write(np.array([w.block, w.src is not None, w.dest is not None,
                              w.seg is not None], np.int32).tobytes())
            n_src = 0 if w.src is None else w.src.numel()
            f.write(np.array([w.start, w.items, n_src], np.int64).tobytes())
            f.write(np.float32(w.scale).tobytes())
            for t in (w.src, w.dest, w.seg):
                if t is not None:
                    f.write(_i32(t))
        f.write(flat.numpy().tobytes())
    subprocess.run([str(emu), str(path), str(tmp_path / "out.bin")], check=True, timeout=300)
    out = np.fromfile(tmp_path / "out.bin", np.float32)
    got_flat = torch.from_numpy(out[:flat.numel()].copy())
    got_outs, at = [], flat.numel()
    for old, _, o in sources:
        if o is not None:
            got_outs.append(torch.from_numpy(out[at:at + old.numel()].copy()))
            at += old.numel()
    return got_flat, got_outs


def _blocks(rng, sizes, delta=()):
    out = []
    for k, size in enumerate(sizes):
        old = torch.from_numpy(rng.normal(size=size).astype(np.float32))
        if k in delta:
            d = torch.from_numpy((1e-3 * rng.normal(size=size)).astype(np.float32))
            d[:2] = torch.tensor([-0.0, 3.0e-39])  # a signed zero and a subnormal
            out.append((old, d.to(torch.bfloat16), torch.empty(size)))
        else:
            out.append((old, None, None))
    return out


def _i(a):
    return torch.tensor(np.asarray(a, np.int32))


def _case(name, rng):
    """(flat, sources, writes) of one case."""
    n = 997
    if name == "affine":
        src = _blocks(rng, [n])
        return torch.zeros(5 * n), src, [Write(0, None, None, None, 2 * n, n, 1.0)]
    if name == "scatter":
        src = _blocks(rng, [n])
        return (torch.full((3 * n,), 7.0), src,
                [Write(0, None, _i(rng.permutation(3 * n)[:n]), None, 0, n, 2.5)])
    if name == "gather_scatter":  # a symmetric upper block: each position twice
        src = _blocks(rng, [n])
        pos = np.concatenate([np.arange(n), rng.permutation(n)])
        return (torch.zeros(2 * n + 5), src,
                [Write(0, _i(pos), _i(rng.permutation(2 * n + 5)[:2 * n]), None, 0, 2 * n,
                       -0.75)])
    if name == "bf16_decode":  # gathers read what the decode writes elsewhere
        src = _blocks(rng, [n, 2 * n], delta=(0, 1))
        pos = np.concatenate([np.arange(n), rng.permutation(n)])
        dest = rng.permutation(4 * n)
        return (torch.zeros(4 * n), src,
                [Write(0, _i(pos), _i(dest[:2 * n]), None, 0, 2 * n, 1.0),
                 Write(1, None, _i(dest[2 * n:]), None, 0, 2 * n, 1.0)])
    if name == "rhs_identity":  # the RHS delta: an identity plan into a new b
        src = _blocks(rng, [n], delta=(0,))
        src = [(src[0][0], src[0][1], None)]
        return torch.empty(n), src, [Write(0, None, None, None, 0, n, 1.0)]
    if name == "accumulate":  # slots of 1-4 entries over three blocks
        src = _blocks(rng, [n, 300, 41], delta=(1,))
        total = n + 300 + 41
        count = rng.integers(1, 5, size=600)
        seg = np.concatenate([[0], np.cumsum(count)])
        pos = rng.integers(0, total, size=int(seg[-1]))
        slots = np.sort(rng.permutation(2000)[:600])
        return (torch.zeros(2000), src,
                [Write(-1, _i(pos), _i(slots), _i(seg), 0, 600, 1.5)])
    if name == "many_blocks":  # four blocks, mixed plans, one call
        src = _blocks(rng, [n, n, 513, 64], delta=(2,))
        dest = n + rng.permutation(5 * n)  # clear of the affine run [0, n)
        return (torch.randn(6 * n, generator=torch.Generator().manual_seed(3)), src,
                [Write(0, None, None, None, 0, n, 2.0),
                 Write(1, _i(rng.permutation(n)), _i(dest[:n]), None, 0, n, 2.0),
                 Write(2, None, _i(dest[n:n + 513]), None, 0, 513, 2.0),
                 Write(3, _i(rng.integers(0, 64, 200)), _i(dest[n + 513:n + 713]), None, 0,
                       200, 2.0)])
    raise AssertionError(name)


CASES = ["affine", "scatter", "gather_scatter", "bf16_decode", "rhs_identity", "accumulate",
         "many_blocks"]


@pytest.mark.parametrize("name", CASES)
def test_value_update_body_matches_twin(emu, tmp_path, name):
    rng = np.random.default_rng(CASES.index(name))
    flat, sources, writes = _case(name, rng)
    want = flat.clone()
    vu.value_update_plain(want, sources, writes)
    for seed in (1, 2):
        got_flat, got_outs = run_emu(emu, tmp_path, flat, sources, writes, seed)
        assert torch.equal(got_flat.view(torch.int32), want.view(torch.int32))
        outs = [o for _, _, o in sources if o is not None]
        assert len(got_outs) == len(outs)
        for got, o in zip(got_outs, outs):
            assert torch.equal(got.view(torch.int32), o.view(torch.int32))


def test_twin_decodes_as_the_host_mirror():
    """The decoded copy is old + float(delta) in float32: the host mirror's
    numpy sum, bit for bit."""
    rng = np.random.default_rng(9)
    old = rng.normal(size=4096).astype(np.float32)
    delta = torch.from_numpy((1e-4 * rng.normal(size=4096)).astype(np.float32)).to(torch.bfloat16)
    out = torch.empty(4096)
    vu.value_update_plain(torch.empty(0), [(torch.from_numpy(old), delta, out)], [])
    np.testing.assert_array_equal(out.numpy(), old + delta.float().numpy())


def test_wrapper_runs_the_twin_on_cpu_and_counts_no_launch():
    from ogl_tpu_torch import kernels

    kernels.reset_launches()
    flat = torch.zeros(10)
    vu.value_update(flat, [(torch.arange(5.0), None, None)], [Write(0, None, None, None, 3, 5,
                                                                    2.0)])
    assert flat.tolist() == [0, 0, 0, 0, 2, 4, 6, 8, 0, 0]
    assert kernels.launches["value_update"] == 0


def test_bytes_moved_counts_each_table_once():
    src = [(torch.zeros(10), None, None), (torch.zeros(4), torch.zeros(4, dtype=torch.bfloat16),
                                            torch.zeros(4))]
    writes = [Write(0, None, None, None, 0, 10, 1.0),
              Write(1, _i(np.arange(4)), _i(np.arange(4)), None, 0, 4, 1.0)]
    # affine 10 x (4 + 4); decode 4 x 10; gather+scatter 4 x (4 + 4 + 2 + 4 + 4)
    assert vu.bytes_moved(src, writes) == 80 + 40 + 72
