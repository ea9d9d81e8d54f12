"""The Arnoldi step's CUDA body (ogl_tpu_torch/kernels/csrc/gmres_arnoldi.cuh)
on the CPU: compiled by g++ against stand-ins for the CUDA runtime, the
cooperative grid and the bulk copies (tests/arnoldi_emu), one std::thread per
CUDA thread, copies landing at random later times.  It checks the body as
written (the slices, the ring of stages and its barriers, the held slots,
the backward passes, w held or in device memory) against blocked MGS in
float64, on plans of `arnoldi_plan` and on others, with NaN in every byte
the body must not read or write."""

import re
import shutil
import subprocess
from pathlib import Path

import pytest

from ogl_tpu_torch.kernels import gmres

EMU = Path(__file__).parent / "arnoldi_emu"
CSRC = Path(gmres.__file__).parent / "csrc"

# ld.shared / st.shared become reads and writes of the CTA's stand-in memory
SHARED = {
    "float lds_f32(uint32_t a)": "{ float v; memcpy(&v, emu_smem_base + a, 4); return v; }",
    "uint32_t lds_u32(uint32_t a)": "{ uint32_t v; memcpy(&v, emu_smem_base + a, 4); return v; }",
    "void sts_f32(uint32_t a, float v)": "{ memcpy(emu_smem_base + a, &v, 4); }",
}


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU stand-in")
    d = tmp_path_factory.mktemp("arnoldi_emu")
    body = (CSRC / "gmres_arnoldi.cuh").read_text()
    for sig, repl in SHARED.items():
        body, k = re.subn(r"(__device__ __forceinline__ " + re.escape(sig) + r") \{.*?\n\}\n",
                          lambda m: m.group(1) + " " + repl + "\n", body, flags=re.S)
        assert k == 1, sig
    assert "asm" not in body
    (d / "gmres_arnoldi.cuh").write_text(body)
    shutil.copy(CSRC / "block_sum.cuh", d)
    for f in EMU.iterdir():
        shutil.copy(f, d)
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-Wno-unknown-pragmas", "-I", str(d),
                    "-o", str(d / "emu"), str(d / "main.cpp")], check=True, capture_output=True)
    return d / "emu"


def _plan(n, bf16, ctas):
    p = gmres.arnoldi_plan(n, bf16, ctas)
    return p.slice, p.resident, p.stages, int(p.w_resident), int(p.hint)


def _slice(n, ctas):
    return -(-(-(-n // ctas)) // 8) * 8


# (basis type, n, j, CTAs, (slice, resident rows, stages, w held, L2 hint))
CASES = {
    "planned float32": (0, 3001, 9, 3, _plan(3001, False, 3)),
    "planned bfloat16 ragged": (1, 5003, 17, 2, _plan(5003, True, 2)),
    "float32 three rows held, two stages": (0, 4099, 15, 2, (_slice(4099, 2), 3, 2, 1, 1)),
    "bfloat16 nothing held, w streamed, backward passes": (1, 8192, 17, 4,
                                                           (_slice(8192, 4), 0, 5, 0, 0)),
    "float32 five rows held, w streamed": (0, 4099, 9, 2, (_slice(4099, 2), 5, 8, 0, 1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_arnoldi_body_on_the_cpu(emu, case):
    bf16, n, j, ctas, plan = CASES[case]
    args = [bf16, n, j, ctas, *plan, 5]
    res = subprocess.run(["bash", "-c", "ulimit -s 1024 && exec \"$0\" \"$@\"", str(emu),
                          *map(str, args)], capture_output=True, text=True, timeout=600)
    assert res.returncode == 0 and res.stdout.rstrip().endswith("ok"), res.stdout + res.stderr
