"""The GMRES recombination body (ogl_tpu_torch/kernels/csrc/gmres_combine.cuh)
on the CPU: compiled by g++ against stand-ins for the CUDA runtime
(tests/cuda_emu) and run thread by thread as the standalone launch runs it
(the body never synchronises).  Its Σ_{k<j} y_k V_k must be bit-equal to
`gmres_combine_plain` in float32 and bfloat16, at j odd and even against
the batch of rows, at a ragged n, with NaN in every row's padding and nothing
stored past n."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ogl_tpu_torch.kernels import gmres

EMU = Path(__file__).parent / "cuda_emu"
CSRC = Path(gmres.__file__).parent / "csrc"


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU stand-in")
    d = tmp_path_factory.mktemp("combine_emu")
    shutil.copy(CSRC / "gmres_combine.cuh", d)
    for f in EMU.iterdir():
        shutil.copy(f, d)
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-I", str(d),
                    "-o", str(d / "emu"), str(d / "combine_main.cpp")], check=True,
                   capture_output=True)
    return d / "emu"


@pytest.mark.parametrize("n,ctas", [(4096, 3), (5003, 2), (1, 1)], ids=str)
@pytest.mark.parametrize("j", [1, 7, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_combine_body_bit_equal_to_twin(emu, tmp_path, dtype, j, n, ctas):
    g = torch.Generator().manual_seed(j * 7 + n)
    V = gmres.new_basis(j, n, dtype, "cpu")  # rows of n rounded up to 8 entries
    V[:, n:] = float("nan")  # the padding: the body may load it, never use it
    V[:j, :n] = torch.randn((j, n), generator=g).to(dtype)
    y = torch.randn(j, generator=g)
    ld = V.shape[1]
    raw = V[:j].view(torch.int16 if dtype == torch.bfloat16 else torch.float32)
    src = tmp_path / "in.bin"
    with open(src, "wb") as f:
        f.write(np.array([int(dtype == torch.bfloat16)], np.int32).tobytes()
                + np.array([n, ld], np.int64).tobytes()
                + np.array([j, 64, ctas], np.int32).tobytes()
                + y.numpy().tobytes() + raw.numpy().tobytes())
    subprocess.run([str(emu), str(src), str(tmp_path / "out.bin")], check=True, timeout=300)
    out = torch.from_numpy(np.fromfile(tmp_path / "out.bin", np.float32))
    assert torch.equal(out[:n], gmres.gmres_combine_plain(V, y, j, n))
    assert bool(out[n:].isnan().all())  # nothing stored past n
