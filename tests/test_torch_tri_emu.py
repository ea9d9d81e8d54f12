"""The two triangular bodies of the ILU family's apply
(ogl_tpu_torch/kernels/csrc/tri_sweep.cuh `sweep_apply`, kernel 1, and
tri_levels.cuh `level_apply`, kernel 2) on the CPU: compiled by g++ against
stand-ins for the CUDA runtime (tests/cuda_emu) and for the bulk copies
(tests/arnoldi_emu/tma.cuh), one std::thread per CUDA thread, as their
cooperative launches run them: kernel 1 with grid.sync() a barrier over all
threads, each CTA's rows brought into its own shared memory by copies that
land at random later times, and kernel 2 with no barrier, each row polling
its sources' ready words.  Each must give its plain twin's bits
(kernels/tri_solve.py `tri_sweep_plain`, `tri_levels_plain`) on the factors
of ILU(0), IC(0), ILUT and ICT, for sweep counts 0, 1, 3 and 8, for grids
that do and do not cover the rows, for shared memory that holds every row,
some or none, and for threads with more rows than kernel 1 keeps b and d
of in registers; the levels body the bits of the sweeps run to each
factor's depth, on a chain factor too, with the factors in level order
(`level_layout`) and over several applies on the same words; and a
schedule that places a row before its source must trap, not hang."""

import dataclasses
import re
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
BULK = Path(__file__).parent / "arnoldi_emu" / "tma.cuh"
H100_SMEM = 232448  # the shared memory a CTA of kernel 1 takes on the card
# rows per thread whose b and d kernel 1 keeps in registers
REG_ROWS = int(re.search(r"constexpr int kRegRows = (\d+);",
                         (CSRC / "tri_sweep.cuh").read_text()).group(1))


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
    shutil.copy(BULK, d)
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


def _run(emu, tmp_path, mode, st, r, threads, ctas, capacity=H100_SMEM, block=16,
         limit_ns=30 * 10**9, check=True):
    """The body of `mode` (0 sweeps, 1 levels) over the factors of `st` on
    each row of r ((n,) or (applies, n)), one apply after another; kernel 1
    with `capacity` bytes of shared memory per CTA, its rows held as far as
    they fit (0: every row streamed, dealt over the grid); kernel 2 loading
    the words of `block` entries (4 or 16) of a row at once."""
    rs = r.reshape(-1, r.shape[-1])
    n = rs.shape[1]
    src = tmp_path / "in.bin"
    with open(src, "wb") as f:
        f.write(np.int32(mode).tobytes() + np.int64(n).tobytes()
                + np.array([threads, ctas], np.int32).tobytes() + np.int64(capacity).tobytes()
                + np.array([block, rs.shape[0]], np.int32).tobytes()
                + np.int64(limit_ns).tobytes())
        for t in (st.lower, st.upper):
            m = t.mat
            f.write(np.array([m.nnz, t.sweeps, t.d is not None], np.int32).tobytes())
            lv = tri_solve.level_layout(t)
            for a in (m.row_ptr, m.cols, m.vals, t.d, lv.ptr, lv.src, lv.vals, lv.rows, lv.inv,
                      lv.d):
                if a is not None:
                    f.write(a.numpy().tobytes())
            f.write(np.int32(capacity > 0).tobytes())
            if capacity > 0:
                for a in tri_solve.plan_rows(m.row_ptr.numpy(), ctas, capacity):
                    f.write(a.tobytes())
        f.write(rs.numpy().tobytes())
    res = subprocess.run([str(emu), str(src), str(tmp_path / "out.bin")], check=check,
                         timeout=300)
    if not check:
        return res
    return torch.from_numpy(np.fromfile(tmp_path / "out.bin", np.float32)).reshape(rs.shape)


# (factorisation, system, sweeps, threads per CTA, CTAs): grids above and
# below the row count
CASES = [("ilu", "poisson", 8, 32, 2), ("ic", "poisson", 3, 64, 3), ("ilut", "cd", 1, 32, 1),
         ("ict", "knn", 8, 64, 2), ("ilu", "knn", 0, 32, 3), ("ic", "cd", 5, 32, 2)]


@pytest.mark.parametrize("kind,system,sweeps,threads,ctas", CASES, ids=str)
def test_sweep_body_gives_its_twins_bits(emu, tmp_path, kind, system, sweeps, threads, ctas):
    st = _state(kind, system, sweeps)
    r = torch.from_numpy(np.random.default_rng(sweeps).normal(size=st.lower.n)
                         .astype(np.float32))
    got = _run(emu, tmp_path, 0, st, r, threads, ctas)[0]
    assert torch.equal(got, tri_solve.tri_sweep_plain(st.lower, st.upper, r))


@pytest.mark.parametrize("kind,system,sweeps,threads,ctas", CASES, ids=str)
def test_levels_body_gives_the_sweeps_to_depth(emu, tmp_path, kind, system, sweeps, threads,
                                               ctas):
    st = _state(kind, system, sweeps)
    r = torch.from_numpy(np.random.default_rng(7).normal(size=st.lower.n).astype(np.float32))
    got = _run(emu, tmp_path, 1, st, r, threads, ctas)[0]
    assert torch.equal(got, tri_solve.tri_levels_plain(st.lower, st.upper, r))
    deep = (dataclasses.replace(t, sweeps=t.depth) for t in (st.lower, st.upper))
    assert torch.equal(got, tri_solve.tri_sweep_plain(*deep, r))


# (factorisation, system, sweeps, threads per CTA, CTAs, shared memory
# bytes): each CTA's range larger than its shared memory (the rest streamed
# in the same pass), and no shared memory (every row streamed, the rows
# dealt over the grid)
SMEM_CASES = [("ic", "poisson", 8, 32, 2, 1024), ("ilut", "cd", 3, 32, 3, 640),
              ("ict", "knn", 5, 64, 2, 2048), ("ilu", "knn", 8, 32, 2, 0)]


@pytest.mark.parametrize("kind,system,sweeps,threads,ctas,capacity", SMEM_CASES, ids=str)
def test_sweep_body_streams_what_shared_memory_cannot_hold(emu, tmp_path, kind, system, sweeps,
                                                           threads, ctas, capacity):
    st = _state(kind, system, sweeps)
    for t in (st.lower, st.upper):
        bounds, held = tri_solve.plan_rows(t.mat.row_ptr.numpy(), ctas, capacity)
        assert (held < bounds[1:]).any() or capacity == 0
    r = torch.from_numpy(np.random.default_rng(capacity).normal(size=st.lower.n)
                         .astype(np.float32))
    got = _run(emu, tmp_path, 0, st, r, threads, ctas, capacity)[0]
    assert torch.equal(got, tri_solve.tri_sweep_plain(st.lower, st.upper, r))


# (factorisation, system, sweeps, threads per CTA, CTAs): each thread with
# more rows than it keeps b and d of in registers, held (the H100's shared
# memory) and streamed (none)
ROUND_CASES = [("ic", "poisson", 8, 8, 2), ("ilut", "cd", 3, 16, 1), ("ict", "knn", 5, 16, 2),
               ("ilu", "knn", 8, 8, 3)]


@pytest.mark.parametrize("capacity", [H100_SMEM, 0], ids=["held", "streamed"])
@pytest.mark.parametrize("kind,system,sweeps,threads,ctas", ROUND_CASES, ids=str)
def test_sweep_body_past_the_rows_held_in_registers(emu, tmp_path, kind, system, sweeps,
                                                    threads, ctas, capacity):
    st = _state(kind, system, sweeps)
    assert REG_ROWS * threads * ctas < st.lower.n
    r = torch.from_numpy(np.random.default_rng(threads * ctas).normal(size=st.lower.n)
                         .astype(np.float32))
    got = _run(emu, tmp_path, 0, st, r, threads, ctas, capacity)[0]
    assert torch.equal(got, tri_solve.tri_sweep_plain(st.lower, st.upper, r))


def _chain(n, seed):
    """Strict factors where every row depends on the one before (lower) or
    after (upper): depth n - 1 each."""
    g = np.random.default_rng(seed)
    i = np.arange(1, n)
    lower = (i, i - 1, g.uniform(-0.9, 0.9, n - 1))
    upper = (i - 1, i, g.uniform(-0.9, 0.9, n - 1))
    diag = g.uniform(1.0, 2.0, n)
    return ilu.state_from_factors(lower, upper, diag, "lu", "cpu")


# (state, threads per CTA, CTAs, applies, entries a thread loads at once): a
# chain factor (depth n), grids of fewer threads than rows, several applies
# on the same words, rows longer than a block
LEVEL_CASES = {
    "chain": (lambda: _chain(400, 1), 32, 2, 1, 4),
    "chain, one CTA of 32, two applies": (lambda: _chain(257, 2), 32, 1, 2, 16),
    "ilut cd, 32 threads for 216 rows, blocks of 4": (lambda: _state("ilut", "cd", 8), 32, 1, 3,
                                                      4),
    "ict knn": (lambda: _state("ict", "knn", 8), 64, 2, 2, 16),
    "ic poisson, one CTA of 32, three applies": (lambda: _state("ic", "poisson", 8), 32, 1, 3,
                                                 4),
}


@pytest.mark.parametrize("case", list(LEVEL_CASES))
def test_levels_body_on_ready_words(emu, tmp_path, case):
    make, threads, ctas, applies, block = LEVEL_CASES[case]
    st = make()
    n = st.lower.n
    assert threads * ctas < 2 * n
    r = torch.from_numpy(np.random.default_rng(applies).normal(size=(applies, n))
                         .astype(np.float32))
    got = _run(emu, tmp_path, 1, st, r, threads, ctas, block=block)
    deep = [dataclasses.replace(t, sweeps=t.depth, _tables={}) for t in (st.lower, st.upper)]
    for a in range(applies):
        assert torch.equal(got[a], tri_solve.tri_levels_plain(st.lower, st.upper, r[a]))
        assert torch.equal(got[a], tri_solve.tri_sweep_plain(*deep, r[a]))


@pytest.mark.parametrize("ctas", [1, 2])
def test_levels_body_traps_on_a_row_before_its_source(emu, tmp_path, ctas):
    """The chain's lower rows in reverse order, more of them than threads:
    every row waits on a row at a later position, which a waiting thread
    holds; the wait passes its bound and the body traps."""
    st = _chain(200, 3)
    st.lower.order = torch.flip(st.lower.order, [0])
    r = torch.ones(st.lower.n)
    res = _run(emu, tmp_path, 1, st, r, 32, ctas, limit_ns=2 * 10**8, check=False)
    assert res.returncode != 0
