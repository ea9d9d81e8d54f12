"""The AMG level bodies (ogl_tpu_torch/kernels/csrc/amg_level.cuh over the Ell
row body ell_rows.cuh and the Gdia row-quad body gdia_k1.cuh) on the CPU:
compiled by g++ against stand-ins for the CUDA runtime (tests/cuda_emu,
`-ffp-contract=off`) and run thread by thread as their launches run them
(the bodies never synchronise).  The Ell and Gdia level smoothers' sweep and
residual, with float32 and bfloat16 values, and the pgm restriction and
prolongation must give their plain twins' bits (kernels/amg_level.py), on
the levels of real hierarchies — the kNN-6 mesh and the shuffled Poisson
grid, at row counts that are and are not multiples of 4 and 32 — and on
aggregates of 1 to 9 rows.

The staged Ell body of the device V-cycle (csrc/amg_stage.cuh: each warp
group's slots brought into shared memory by bulk copies) runs on the
stand-in of tests/arnoldi_emu instead — one std::thread per CUDA thread, the
copies landing at random later times, the shared memory NaN until they land
— as a sweep and a residual, and must give the same twins' bits, with the
chunk sizes the loop picks and smaller ones (several chunks per group, both
buffers in turn).  So do the device V-cycle's transfer phases on Gdia and
Ell levels (csrc/amg_loop.cuh, compiled whole against that stand-in): the
restricting residual, whose per-row residuals must be the twin's bits
(precond/amg.py `_resid` with `plain`) summed per coarse row in the
phase's lane order, and close to `_restrict` of them; and the last sweep
added to the fine rows, bit-equal to x + `_prolong` of the twin's sweep —
at natural widths that take the warp-group, quad-pair and group-of-8
walks, level sizes that are and are not multiples of 4 and 32, and partial
last aggregates."""

import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from ogl_tpu_torch import testing
from ogl_tpu_torch.core import ldu
from ogl_tpu_torch.kernels import amg_level, amg_loop
from ogl_tpu_torch.precond import amg

EMU = Path(__file__).parent / "cuda_emu"
CSRC = Path(amg_level.__file__).parent / "csrc"
HEADERS = ("amg_level.cuh", "ell_rows.cuh", "gdia_k1.cuh", "dia_rows.cuh", "cg_k1.cuh",
           "widen.cuh")
RELAX = 0.9


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU stand-in")
    d = tmp_path_factory.mktemp("amg_level_emu")
    for h in HEADERS:
        shutil.copy(CSRC / h, d)
    for f in EMU.iterdir():
        shutil.copy(f, d)
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-I", str(d),
                    "-o", str(d / "emu"), str(d / "amg_level_main.cpp")], check=True,
                   capture_output=True)
    return d / "emu"


_LEVELS: dict = {}


def _level(mesh, aggregation, index, dtype):
    """Level `index` of the hierarchy of `mesh`, its smoother values packed
    in `dtype`."""
    key = (mesh, aggregation, dtype)
    if key not in _LEVELS:
        m = (testing.knn_ldu(4096)[0] if mesh == "knn"
             else testing.shuffled_poisson_ldu((16, 16, 32)))
        c = ldu.ldu_to_coo_host(m, dtype=np.float32)
        _LEVELS[key] = amg.build_hierarchy(c, 9, 10, aggregation, width=8, smoother_dtype=dtype)
    return _LEVELS[key][index]


def _run(emu, tmp_path, header: bytes, arrays) -> np.ndarray:
    src = tmp_path / "in.bin"
    with open(src, "wb") as f:
        f.write(header)
        for a in arrays:
            f.write(np.ascontiguousarray(a).tobytes())
    subprocess.run([str(emu), str(src), str(tmp_path / "out.bin")], check=True, timeout=300)
    return np.fromfile(tmp_path / "out.bin", np.float32)


def _raw(vals: torch.Tensor) -> np.ndarray:
    """The values' bytes as the card holds them (bfloat16 as its 16 bits)."""
    return (vals.view(torch.int16) if vals.dtype == torch.bfloat16 else vals).numpy()


# (mesh, aggregation, level): the kNN fine level (4,096 rows, Ell) and its
# pgm levels of 1,901 and 870 rows (Ell) and 405 rows (Gdia); the shuffled
# grid's fine level (8,192 rows, Gdia)
ELL_LEVELS = [("knn", "auto", 0), ("knn", "pgm", 1), ("knn", "pgm", 2)]
GDIA_LEVELS = [("shuffled", "auto", 0), ("knn", "pgm", 3)]
DTYPES = [torch.float32, torch.bfloat16]


def _vectors(n, seed):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=n).astype(np.float32)) for _ in range(2)]


@pytest.mark.parametrize("sweep", [True, False], ids=["sweep", "resid"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("where", ELL_LEVELS + GDIA_LEVELS, ids=str)
def test_smoother_body_bit_equal_to_twin(emu, tmp_path, where, dtype, sweep):
    lv = _level(*where, dtype)
    kind = type(lv.mat).__name__
    assert kind == ("Ell" if where in ELL_LEVELS else "Gdia")
    n = lv.n
    x, b = _vectors(n, n)
    invd = lv.inv_diag
    flags = np.array([int(dtype == torch.bfloat16), int(sweep)], np.int32).tobytes() + \
        np.float32(RELAX).tobytes()
    if kind == "Ell":
        k = lv.kern.width
        header = np.int32(0).tobytes() + np.int64(n).tobytes() + np.int32(k).tobytes() + flags
        arrays = [lv.mat.cols.numpy(), _raw(lv.data_s), lv.mat.warp_slots.numpy()]
    else:
        header = (np.int32(1).tobytes() + np.int64(n).tobytes()
                  + np.int32(len(lv.kern.plane_offsets)).tobytes() + flags)
        arrays = [np.array(lv.kern.plane_offsets, np.int32), _raw(lv.data_s),
                  lv.mat.lidx.numpy()]
    out = _run(emu, tmp_path, header, arrays + [x.numpy(), b.numpy(), invd.numpy()])
    want = (lv.kern.sweep(lv.data_s, x, b, invd, RELAX) if sweep
            else lv.kern.resid(lv.data_s, x, b))
    assert torch.equal(torch.from_numpy(out), want)


@pytest.mark.parametrize("n,nc", [(4096, 1901), (3001, 1000), (7, 1)], ids=str)
def test_transfer_bodies_bit_equal_to_twins(emu, tmp_path, n, nc):
    rng = np.random.default_rng(n)
    agg = np.concatenate([np.arange(nc), rng.integers(0, nc, n - nc)])
    rng.shuffle(agg)
    tr = amg_level.PgmTransfer(agg, nc, "cpu")
    r, x = _vectors(n, nc)
    ec = torch.tensor(rng.normal(size=nc).astype(np.float32))
    head = np.int64(n).tobytes() + np.int64(nc).tobytes()
    got = _run(emu, tmp_path, np.int32(2).tobytes() + head,
               [tr.starts.numpy(), tr.members.numpy(), r.numpy()])
    assert torch.equal(torch.from_numpy(got), tr.restrict(r))
    got = _run(emu, tmp_path, np.int32(3).tobytes() + head,
               [tr.agg.numpy(), x.numpy(), ec.numpy()])
    assert torch.equal(torch.from_numpy(got), tr.prolong_add(x, ec))


# ---- the staged Ell body (csrc/amg_stage.cuh) on the threaded stand-in ------

ARNOLDI_EMU = Path(__file__).parent / "arnoldi_emu"
STAGE_HEADERS = ("amg_stage.cuh",) + HEADERS


@pytest.fixture(scope="module")
def stage_emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU stand-in")
    d = tmp_path_factory.mktemp("amg_stage_emu")
    for h in STAGE_HEADERS:
        shutil.copy(CSRC / h, d)
    for f in ARNOLDI_EMU.iterdir():  # the stand-ins, tma.cuh's among them
        shutil.copy(f, d)
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
                    "-Wno-unknown-pragmas", "-I", str(d), "-o", str(d / "emu"),
                    str(d / "amg_stage_main.cpp")], check=True, capture_output=True)
    return d / "emu"


# (level, CTAs, threads, slots: None = the loop's pick): the kNN fine level
# (4,096 rows, K 14: whole groups; two chunks a group at the pick, several at
# 3), and the kNN mesh's level of 512 rows (K 66: nine chunks at the pick)
ELL_STAGED = [(("knn", "auto", 0), 3, 64, None), (("knn", "auto", 0), 2, 96, 3),
              (("knn", "auto", 1), 2, 64, None), (("knn", "auto", 1), 1, 64, 5)]


@pytest.mark.parametrize("sweep", [True, False], ids=["sweep", "resid"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("where,ctas,threads,slots", ELL_STAGED, ids=str)
def test_staged_ell_body_bit_equal_to_twin(stage_emu, tmp_path, where, ctas, threads, slots,
                                           dtype, sweep):
    lv = _level(*where, dtype)
    n, k = lv.n, lv.kern.width
    pick = amg_loop.ell_stage_slots(n, k, dtype)
    assert pick > 0
    slots = pick if slots is None else slots
    x, b = _vectors(n, n + 7)
    head = (np.array([ctas, threads], np.int32).tobytes() + np.int64(n).tobytes()
            + np.array([k, int(dtype == torch.bfloat16), int(sweep), slots], np.int32).tobytes()
            + np.float32(RELAX).tobytes())
    out = _run(stage_emu, tmp_path, head,
               [lv.mat.cols.numpy(), _raw(lv.data_s), lv.mat.warp_slots.numpy(), x.numpy(),
                b.numpy(), lv.inv_diag.numpy()])
    want = (lv.kern.sweep(lv.data_s, x, b, lv.inv_diag, RELAX) if sweep
            else lv.kern.resid(lv.data_s, x, b))
    assert torch.equal(torch.from_numpy(out), want)


def test_staged_ell_needs_whole_16_byte_copies():
    """A level whose rows would make copies of a part of 16 bytes takes the
    register body: n % 4 (n % 8 in bfloat16); the chunk holds at most K and
    STAGE_SLOTS slots within the warp's stage bytes."""
    assert amg_loop.ell_stage_slots(1901, 17, torch.float32) == 0
    assert amg_loop.ell_stage_slots(4100, 17, torch.float32) == 6
    assert amg_loop.ell_stage_slots(4100, 17, torch.bfloat16) == 0
    assert amg_loop.ell_stage_slots(4104, 17, torch.bfloat16) == 8
    assert amg_loop.ell_stage_slots(4104, 5, torch.bfloat16) == 5


# ---- the device V-cycle's transfer phases (csrc/amg_loop.cuh) ---------------

CYCLE_HEADERS = ("amg_loop.cuh", "amg_smooth.cuh", "amg_stage.cuh", "block_sum.cuh", "cg_k2n.cuh",
                 "csr_rows.cuh", "loop.cuh", "tma.cuh") + HEADERS


@pytest.fixture(scope="module")
def cycle_emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU stand-in")
    d = tmp_path_factory.mktemp("amg_cycle_emu")
    for h in CYCLE_HEADERS:
        shutil.copy(CSRC / h, d)
    for f in ARNOLDI_EMU.iterdir():  # the stand-ins, tma.cuh's among them
        shutil.copy(f, d)
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread",
                    "-Wno-unknown-pragmas", "-I", str(d), "-o", str(d / "emu"),
                    str(d / "amg_cycle_main.cpp")], check=True, capture_output=True)
    return d / "emu"


def _natural(n, width):
    """The natural transfer of width `width` from n rows, as precond/amg.py's
    `_restrict` and `_prolong` read a level."""
    return types.SimpleNamespace(grid=None, natural=True, transfer=None, n=n, width=width,
                                 nc=-(-n // width))


def _lanes(v, k):
    """Lane 0's value of csrc/amg_loop.cuh `run_sum` over each row of the
    (groups, k) float32 array: the shuffle butterfly, xor k/2 down to 1."""
    for s in (k >> j for j in range(1, k.bit_length())):
        v = v + v[:, np.arange(k) ^ s]
    return v[:, 0]


def _restricted_in_phase_order(fmt, width, res, nc):
    """The coarse rows of the restricting residual from the per-row
    residuals `res`, in the phase's order: an Ell level with width dividing
    32 sums each run over its lanes; a Gdia level with runs of whole quads
    (their quad counts dividing 32) sums each quad's rows in order, then the
    run's quads over their lanes; otherwise each of 8 lanes sums the rows j,
    j + 8, ... of its coarse row in order, then the 8 over their lanes.
    Rows past the level add nothing."""
    r = np.zeros(nc * width, np.float32)
    r[:len(res)] = res
    if fmt == "Ell" and 32 % width == 0:
        return _lanes(r.reshape(nc, width), width)
    if fmt == "Gdia" and width % 4 == 0 and width <= 128 and 32 % (width // 4) == 0:
        q = r.reshape(-1, 4)
        return _lanes((((q[:, 0] + q[:, 1]) + q[:, 2]) + q[:, 3]).reshape(nc, width // 4),
                      width // 4)
    g = np.zeros((nc, 8), np.float32)
    rows = r.reshape(nc, width)
    for j in range(width):
        g[:, j % 8] = g[:, j % 8] + rows[:, j]
    return _lanes(g, 8)


def _cycle_run(cycle_emu, tmp_path, lv, dtype, mode, stage, width, m, fine_width, x, b,
               fx=None, ctas=2, threads=64):
    """One run of the stand-in program (tests/arnoldi_emu/amg_cycle_main.cpp) on level
    lv: modes 0-1 restrict with natural runs of `width` into m coarse rows,
    mode 2 adds the last sweep to fx, m rows of natural runs of
    `fine_width`."""
    gdia = type(lv.mat).__name__ == "Gdia"
    if gdia:
        nd, rows = len(lv.kern.plane_offsets), lv.mat.lidx.shape[1]
        lead = [lv.mat.lidx.numpy(), _raw(lv.data_s), np.array(lv.kern.plane_offsets, np.int32)]
    else:
        nd, rows = lv.kern.width, 0
        lead = [lv.mat.cols.numpy(), _raw(lv.data_s), lv.mat.warp_slots.numpy()]
    head = (np.array([mode, ctas, threads, int(dtype == torch.bfloat16), 1 if gdia else 2, nd,
                      stage, amg_loop.KIND_NATURAL, width, amg_loop.KIND_NATURAL, fine_width],
                     np.int32).tobytes()
            + np.array([lv.n, rows, m], np.int64).tobytes() + np.float32(RELAX).tobytes())
    tail = [] if fx is None else [fx.numpy()]
    out = _run(cycle_emu, tmp_path, head,
               lead + [x.numpy(), b.numpy(), lv.inv_diag.numpy()] + tail)
    return torch.from_numpy(out)


# (level, natural width, Ell stage: None = the loop's pick): the kNN fine
# level (4,096 rows, Ell) by warp runs staged and not, over a whole warp and
# by groups of 8 (width 6); its pgm levels of 1,901 and 870 rows (Ell, no
# whole quads or groups, partial last runs); the shuffled fine level (8,192
# rows, Gdia) by quad pairs, single quads and a warp of quads; the pgm level
# of 405 rows (Gdia: a partial quad and run) by quad pairs and groups of 8
RESTRICT_CASES = [(("knn", "auto", 0), 8, None), (("knn", "auto", 0), 8, 0),
                  (("knn", "auto", 0), 32, None), (("knn", "auto", 0), 6, None),
                  (("knn", "pgm", 1), 4, 0), (("knn", "pgm", 2), 16, 0),
                  (("shuffled", "auto", 0), 8, 0), (("shuffled", "auto", 0), 4, 0),
                  (("shuffled", "auto", 0), 128, 0), (("knn", "pgm", 3), 8, 0),
                  (("knn", "pgm", 3), 6, 0)]


def _stage(lv, dtype, stage):
    """An Ell level's slots per staged chunk: `stage`, or None for the
    loop's pick (which must stage); 0 on a Gdia level."""
    if type(lv.mat).__name__ == "Gdia":
        return 0
    if stage is None:
        stage = amg_loop.ell_stage_slots(lv.n, lv.kern.width, dtype)
        assert stage > 0
    return stage


@pytest.mark.parametrize("zero_guess", [False, True], ids=["x", "x1"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("where,width,stage", RESTRICT_CASES, ids=str)
def test_loop_restricting_residual_in_phase_order(cycle_emu, tmp_path, where, width, stage,
                                                  dtype, zero_guess):
    lv = _level(*where, dtype)
    fmt, n = type(lv.mat).__name__, lv.n
    stage = _stage(lv, dtype, stage)
    tr = _natural(n, width)
    x, b = _vectors(n, n + width)
    if zero_guess:
        x = RELAX * lv.inv_diag * b  # the zero-guess x1 of vcycle_plain
    out = _cycle_run(cycle_emu, tmp_path, lv, dtype, int(zero_guess), stage, width, tr.nc, 0,
                     x, b)
    res = amg._resid(lv, x, b, plain=True)
    want = _restricted_in_phase_order(fmt, width, res.numpy(), tr.nc)
    assert torch.equal(out[:tr.nc], torch.from_numpy(want))
    torch.testing.assert_close(out[:tr.nc], amg._restrict(tr, res), rtol=1e-5,
                               atol=1e-5 * float(res.abs().max()))
    if zero_guess:
        assert torch.equal(out[tr.nc:], x)


# (level, the level above's natural width, Ell stage): the last sweep of an
# Ell level staged and not, and of Gdia levels, added to a level above of
# m = n * width - width // 2 rows (a partial last run)
PROLONG_CASES = [(("knn", "auto", 0), 8, None), (("knn", "auto", 0), 8, 0),
                 (("knn", "pgm", 1), 6, 0), (("knn", "pgm", 2), 16, 0),
                 (("shuffled", "auto", 0), 8, 0), (("knn", "pgm", 3), 8, 0),
                 (("knn", "pgm", 3), 3, 0)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("where,width,stage", PROLONG_CASES, ids=str)
def test_loop_prolongation_bit_equal_to_twin(cycle_emu, tmp_path, where, width, stage, dtype):
    lv = _level(*where, dtype)
    n = lv.n
    m = n * width - width // 2
    x, b = _vectors(n, n + 3 * width)
    fx = _vectors(m, m)[0]
    out = _cycle_run(cycle_emu, tmp_path, lv, dtype, 2, _stage(lv, dtype, stage), 0, m, width,
                     x, b, fx, ctas=3, threads=96)
    e = amg._sweep(lv, x, b, RELAX, plain=True)
    assert torch.equal(out, fx + amg._prolong(_natural(m, width), e))
