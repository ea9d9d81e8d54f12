"""The block-Jacobi body (ogl_tpu_torch/kernels/csrc/block_jacobi.cuh) on the
CPU, run as the general-BiCGStab loop runs it in its P phase: compiled by
g++ against stand-ins for the CUDA runtime (tests/cuda_emu), one std::thread
per CUDA thread, CTAs of the loop's 512 threads (and of the standalone
launch's 256) walking the tiles grid-stride.  The direction p' = r + β·(p −
ω·v) and y = M⁻¹p' it writes must be bit-equal to the host loop's torch ops
and `block_jacobi_plain`, for block sizes that do and do not divide the
CTA, a ragged n and several CTA counts."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ogl_tpu_torch.kernels import block_jacobi

EMU = Path(__file__).parent / "cuda_emu"
CSRC = Path(block_jacobi.__file__).parent / "csrc"


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU stand-in")
    d = tmp_path_factory.mktemp("block_jacobi_emu")
    shutil.copy(CSRC / "block_jacobi.cuh", d)
    for f in EMU.iterdir():
        shutil.copy(f, d)
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-I", str(d),
                    "-o", str(d / "emu"), str(d / "block_jacobi_main.cpp")], check=True,
                   capture_output=True)
    return d / "emu"


# (n, bs, threads per CTA, CTAs): n ragged against bs and against the tile
CASES = [(1000, 2, 512, 2), (1001, 3, 512, 3), (4097, 4, 512, 2), (3000, 7, 512, 3),
         (2055, 8, 256, 2), (2081, 32, 512, 3), (700, 5, 512, 1), (33, 32, 256, 2)]


@pytest.mark.parametrize("n,bs,threads,ctas", CASES, ids=str)
def test_block_jacobi_body_as_a_loop_phase(emu, tmp_path, n, bs, threads, ctas):
    rng = np.random.default_rng(bs * 1000 + n)
    nb = -(-n // bs)
    inv_t = rng.normal(size=(nb, bs, bs)).astype(np.float32)
    r, p, v = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    beta, omega = np.float32(0.37), np.float32(-1.9)
    src = tmp_path / "in.bin"
    with open(src, "wb") as f:
        f.write(np.int64(n).tobytes() + np.array([bs, threads, ctas], np.int32).tobytes()
                + np.array([beta, omega], np.float32).tobytes())
        for a in (inv_t, r, p, v):
            f.write(a.tobytes())
    subprocess.run([str(emu), str(src), str(tmp_path / "out.bin")], check=True, timeout=300)
    out = np.fromfile(tmp_path / "out.bin", np.float32)
    pn, y = torch.from_numpy(out[:n].copy()), torch.from_numpy(out[n:].copy())
    tr, tp, tv = (torch.from_numpy(a) for a in (r, p, v))
    want_pn = tr + torch.tensor(beta) * (tp - torch.tensor(omega) * tv)  # the host loop's ops
    want_y = block_jacobi.block_jacobi_plain(torch.from_numpy(inv_t), want_pn)
    assert torch.equal(pn, want_pn)
    assert torch.equal(y, want_y)
