"""The kernel build's process handling (ogl_tpu_torch/kernels/_build.py),
on stand-in commands: nvcc itself runs only where the CUDA toolkit is."""

import re
import sys

import pytest

from ogl_tpu_torch.kernels import _build


def test_wait_logs_each_process_wall_time_under_its_name():
    procs = [_build._start([sys.executable, "-c", f"import time; time.sleep({s}); print('out {n}')"],
                           n) for n, s in (("slow.cu", 0.6), ("fast.cu", 0.0))]
    log = _build._wait(procs)
    secs = dict(re.findall(r"^nvcc seconds: (\S+) ([\d.]+)$", log, re.M))
    assert set(secs) == {"slow.cu", "fast.cu"}
    assert float(secs["slow.cu"]) >= 0.5 > float(secs["fast.cu"])  # started together
    assert log.index("out slow.cu") < log.index("nvcc seconds: slow.cu") < log.index("out fast.cu")


def test_wait_raises_on_a_failed_process_with_its_output():
    procs = [_build._start([sys.executable, "-c", "print('fine')"], "a.cu"),
             _build._start([sys.executable, "-c", "import sys; sys.exit('bad source')"], "b.cu")]
    with pytest.raises(RuntimeError, match=r"nvcc failed \(1\).*bad source"):
        _build._wait(procs)
