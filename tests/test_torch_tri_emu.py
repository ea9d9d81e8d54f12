"""The two triangular bodies of the ILU family's apply
(ogl_tpu_torch/kernels/csrc/tri_sweep.cuh `sweep_apply`, kernel 1, and
tri_levels.cuh `level_apply`, kernel 2) on the CPU: compiled by g++ against
stand-ins for the CUDA runtime (tests/cuda_emu), one std::thread per CUDA
thread, grid.sync() a barrier over all of them, as their cooperative
launches run them.  Each must give its plain twin's bits
(kernels/tri_solve.py `tri_sweep_plain`, `tri_levels_plain`) on the factors
of ILU(0), IC(0), ILUT and ICT, for sweep counts 0, 1, 3 and 8 and for grids
that do and do not cover the rows, and the levels body the bits of the
sweeps run to each factor's depth."""

import dataclasses
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ogl_tpu_torch import testing
from ogl_tpu_torch.core import ldu
from ogl_tpu_torch.kernels import tri_solve
from ogl_tpu_torch.precond import ilu

EMU = Path(__file__).parent / "cuda_emu"
CSRC = Path(tri_solve.__file__).parent / "csrc"
HEADERS = ("tri_sweep.cuh", "tri_levels.cuh", "csr_rows.cuh", "dia_rows.cuh", "cg_k1.cuh")


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU stand-in")
    d = tmp_path_factory.mktemp("tri_emu")
    for h in HEADERS:
        shutil.copy(CSRC / h, d)
    for f in EMU.iterdir():
        shutil.copy(f, d)
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-I", str(d),
                    "-o", str(d / "emu"), str(d / "tri_main.cpp")], check=True,
                   capture_output=True)
    return d / "emu"


def _state(kind, system, sweeps):
    m = {"poisson": lambda: testing.poisson_ldu((7, 5, 3)),
         "cd": lambda: testing.convection_diffusion_ldu((9, 6, 2)),
         "knn": lambda: testing.knn_ldu(300)[0]}[system]()
    coo = ldu.ldu_to_coo_host(m, dtype=np.float32)
    if kind in ("ilu", "ilut"):
        lo, up, ud = (ilu.ilu0_factors if kind == "ilu" else ilu.ilut_factors)(coo)
        return ilu.state_from_factors(lo, up, ud, "lu", "cpu", sweeps)
    lo, ld = (ilu.ic0_factor if kind == "ic" else ilu.ict_factor)(coo)
    return ilu.state_from_factors(lo, None, ld, "ic", "cpu", sweeps)


def _run(emu, tmp_path, mode, st, r, threads, ctas):
    n = r.numel()
    src = tmp_path / "in.bin"
    with open(src, "wb") as f:
        f.write(np.int32(mode).tobytes() + np.int64(n).tobytes()
                + np.array([threads, ctas], np.int32).tobytes())
        for t in (st.lower, st.upper):
            m = t.mat
            f.write(np.array([m.nnz, t.sweeps, t.d is not None, t.levels], np.int32).tobytes())
            for a in (m.row_ptr, m.cols, m.vals, t.d, t.order, t.level_ptr):
                if a is not None:
                    f.write(a.numpy().tobytes())
        f.write(r.numpy().tobytes())
    subprocess.run([str(emu), str(src), str(tmp_path / "out.bin")], check=True, timeout=300)
    return torch.from_numpy(np.fromfile(tmp_path / "out.bin", np.float32))


# (factorisation, system, sweeps, threads per CTA, CTAs): grids above and
# below the row count
CASES = [("ilu", "poisson", 8, 32, 2), ("ic", "poisson", 3, 64, 3), ("ilut", "cd", 1, 32, 1),
         ("ict", "knn", 8, 64, 2), ("ilu", "knn", 0, 32, 3), ("ic", "cd", 5, 32, 2)]


@pytest.mark.parametrize("kind,system,sweeps,threads,ctas", CASES, ids=str)
def test_sweep_body_gives_its_twins_bits(emu, tmp_path, kind, system, sweeps, threads, ctas):
    st = _state(kind, system, sweeps)
    r = torch.from_numpy(np.random.default_rng(sweeps).normal(size=st.lower.n)
                         .astype(np.float32))
    got = _run(emu, tmp_path, 0, st, r, threads, ctas)
    assert torch.equal(got, tri_solve.tri_sweep_plain(st.lower, st.upper, r))


@pytest.mark.parametrize("kind,system,sweeps,threads,ctas", CASES, ids=str)
def test_levels_body_gives_the_sweeps_to_depth(emu, tmp_path, kind, system, sweeps, threads,
                                               ctas):
    st = _state(kind, system, sweeps)
    r = torch.from_numpy(np.random.default_rng(7).normal(size=st.lower.n).astype(np.float32))
    got = _run(emu, tmp_path, 1, st, r, threads, ctas)
    assert torch.equal(got, tri_solve.tri_levels_plain(st.lower, st.upper, r))
    deep = (dataclasses.replace(t, sweeps=t.depth) for t in (st.lower, st.upper))
    assert torch.equal(got, tri_solve.tri_sweep_plain(*deep, r))
