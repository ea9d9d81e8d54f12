"""The AMG level bodies (ogl_tpu_torch/kernels/csrc/amg_level.cuh over the Ell
row body ell_rows.cuh and the Gdia row-quad body gdia_k1.cuh) on the CPU:
compiled by g++ against stand-ins for the CUDA runtime (tests/cuda_emu,
`-ffp-contract=off`) and run thread by thread as their launches run them
(the bodies never synchronise).  The Ell and Gdia level smoothers' sweep and
residual, with float32 and bfloat16 values, and the pgm restriction and
prolongation must give their plain twins' bits (kernels/amg_level.py), on
the levels of real hierarchies — the kNN-6 mesh and the shuffled Poisson
grid, at row counts that are and are not multiples of 4 and 32 — and on
aggregates of 1 to 9 rows."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ogl_tpu_torch import testing
from ogl_tpu_torch.core import ldu
from ogl_tpu_torch.kernels import amg_level
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
