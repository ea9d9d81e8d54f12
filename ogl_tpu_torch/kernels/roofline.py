"""Roofline model and measurements: the bytes/flops model of an SpMV, the
published memory rate of the card, chained timing of a device function,
the dense-stream (triad) and read-dominant (plane sum) peaks, and the
device-timeline versions of those timings.

Counterpart: ogl_tpu/kernels/roofline.py, with its names.  The plane-sum
kernel B2.1 (`_rk`) is the CUDA C++ kernel `csrc/read_peak.cu`, wrapped by
`plane_sum`; `plane_sum_plain` is its plain twin.

What the reference does with a jitted `fori_loop` — one device program
with no host dispatch between the applies — the port does with a CUDA
graph: `measure_chained` captures a short chain of dependent applies once
and replays it, timed with CUDA events as the slope between two replay
counts, so neither the host's launch cost nor a fixed cost enters the
per-apply time.  The device-timeline functions run their chain eagerly
under torch.profiler and take the union of the card's busy intervals
(kernels/device_time.py).  On CPU tensors every chain runs eagerly on the
host clock, as the reference does off the TPU, and the device-timeline
functions return 0.0.  Without an argument saying otherwise, the
measurements run on the card.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ogl_tpu_torch import kernels
from ogl_tpu_torch.core.formats import Coo, Csr, Dia, Ell, Hybrid, Sell
from ogl_tpu_torch.kernels import _build, device_time
from ogl_tpu_torch.kernels.dia_spmv import (check_scalar, on_cpu, persistent_launch,
                                            require_cuda, sm_count, stream_of)

__all__ = ["spmv_bytes", "spmv_flops", "hbm_peak_gbps", "Roofline", "measure",
           "measure_chained", "measure_stream_peak", "measure_read_peak",
           "measure_read_peak_device", "measure_device_chained", "plane_sum",
           "plane_sum_plain", "plane_sum_launch"]

# Published device-memory rate per card [GB/s] (NVIDIA's data sheets), keyed
# by substrings of torch.cuda.get_device_name; every substring must match.
_HBM_PEAK = (
    (("h200",), 4800.0),
    (("h100", "hbm3"), 3350.0),  # H100 SXM, "NVIDIA H100 80GB HBM3"
)
_CPU_PEAK = 50.0  # nominal, for relative numbers in CPU runs (as the reference's)
GRAPH_LEN = 8  # applies per captured CUDA graph of measure_chained
HOST_REPEATS = 3  # timings of each chain length on the host clock (measure_chained)
PLANE_SUM_THREADS = 256  # csrc/read_peak.cu kThreads
PLANE_SUM_BLOCKS_PER_SM = 4


def _device_name(device) -> str:
    """'cpu', or the card's name; `device` a torch.device, a device string
    ('cpu', 'cuda', 'cuda:0') or a card's name; None = the card."""
    if isinstance(device, str):
        try:
            device = torch.device(device)
        except RuntimeError:  # not a device string: a card's name
            return device
    device = torch.device("cuda") if device is None else device
    if device.type == "cpu":
        return "cpu"
    if device.type != "cuda":
        raise ValueError(f"no memory rate for device type {device.type}")
    return torch.cuda.get_device_name(device)


def hbm_peak_gbps(device=None) -> float:
    """The published device-memory rate [GB/s] of `device` (see
    _device_name); the nominal 50 for the CPU.  An unknown card raises."""
    name = _device_name(device)
    if name == "cpu":
        return _CPU_PEAK
    low = name.lower()
    for keys, gbps in _HBM_PEAK:
        if all(k in low for k in keys):
            return gbps
    raise ValueError(f"no published memory rate for the card {name!r}; add it to "
                     "ogl_tpu_torch/kernels/roofline.py _HBM_PEAK")


def _itemsize(m) -> int:
    vals = m.data if isinstance(m, Dia) else m.ell.vals if isinstance(m, Hybrid) else m.vals
    if isinstance(vals, torch.Tensor):
        return vals.element_size()
    return np.dtype(vals.dtype).itemsize


def spmv_bytes(m) -> int:
    """Minimal device traffic for one y = A@x: values (and indices) read
    once, x read once, y written once; int32 indices.  Hybrid (like Gdia
    and Xell) has no model, as in the reference: it raises TypeError."""
    n, nc = m.shape
    vs = _itemsize(m)
    if isinstance(m, Coo):
        return len(m.vals) * (vs + 2 * 4) + nc * vs + n * vs
    if isinstance(m, Csr):
        return m.nnz * (vs + 4) + (n + 1) * 4 + nc * vs + n * vs
    if isinstance(m, Ell):
        return n * m.row_width * (vs + 4) + nc * vs + n * vs
    if isinstance(m, Sell):
        return m.stored * (vs + 4) + nc * vs + n * vs
    if isinstance(m, Dia):
        return len(m.offsets) * n * vs + nc * vs + n * vs
    raise TypeError(type(m))


def spmv_flops(m) -> int:
    """2 flops per stored entry (padding included for Ell and Sell); for
    Hybrid, per nonzero of its Ell part and per tail entry, as the
    reference counts them."""
    if isinstance(m, Dia):
        return 2 * len(m.offsets) * m.shape[0]
    if isinstance(m, Ell):
        return 2 * m.shape[0] * m.row_width
    if isinstance(m, Sell):
        return 2 * m.stored
    if isinstance(m, Coo):
        return 2 * len(m.vals)
    if isinstance(m, (Csr, Hybrid)):
        return 2 * m.nnz
    raise TypeError(type(m))


@dataclasses.dataclass(frozen=True)
class Roofline:
    seconds: float
    bytes: int
    flops: int
    peak_gbps: float

    @property
    def gbps(self) -> float:
        return self.bytes / self.seconds / 1e9

    @property
    def fraction_of_peak(self) -> float:
        return self.gbps / self.peak_gbps


# ---- the plane-sum kernel (B2.1) -------------------------------------------


def plane_sum_plain(c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """y = c·d[0] + Σ_{k≥1} d[k], float32, summed in plane order."""
    acc = d[0] * c
    for k in range(1, d.shape[0]):
        acc = acc + d[k]
    return acc


def plane_sum_launch(n: int, d_ptr: int, y_ptr: int, sm_count: int) -> tuple[int, int]:
    """(vec, blocks) of a plane-sum launch: vec = 1 takes the kernel's float4
    branch, which needs every plane and y 16-byte aligned (n % 4 == 0 and
    aligned bases); the grid is persistent, PLANE_SUM_BLOCKS_PER_SM blocks
    of PLANE_SUM_THREADS per SM, fewer when the rows (quads) run out."""
    return persistent_launch(n, (d_ptr, y_ptr), sm_count, PLANE_SUM_THREADS,
                             PLANE_SUM_BLOCKS_PER_SM)


def plane_sum(c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The plane sum of the (nd, n) float32 tensor `d` with the 0-d float32
    tensor `c`: the kernel for CUDA tensors, the plain version for tensors
    on the CPU; raises on anything else."""
    if on_cpu(c, d):
        return plane_sum_plain(c, d)
    require_cuda("plane_sum", d)
    if d.dtype != torch.float32 or d.dim() != 2 or d.shape[0] < 1:
        raise TypeError(f"plane_sum takes an (nd >= 1, n) float32 tensor, not "
                        f"{d.dtype} of shape {tuple(d.shape)}")
    if not d.is_contiguous():
        raise ValueError("plane_sum: d is not contiguous")
    check_scalar("c", c, d.device)
    nd, n = d.shape
    lib = _build.library()
    y = torch.empty(n, dtype=torch.float32, device=d.device)
    vec, blocks = plane_sum_launch(n, d.data_ptr(), y.data_ptr(), sm_count(d.device.index))
    _build.check(lib.ogl_read_peak(c.data_ptr(), d.data_ptr(), nd, y.data_ptr(), n, vec,
                                   blocks, stream_of(d)), "read_peak")
    kernels.launches["read_peak"] += 1
    return y


def _read_peak_kernel(read_streams: int, rows: int, tile: int, device=None):
    """(one_pass, d, bytes_per_pass) of the read-peak measurements: d the
    reference's seeded planes (read_streams, rows, 128) kept flat as
    (read_streams, rows·128) on `device` (None = the card), one_pass(s, d)
    -> a 0-d carry.  Bytes per pass: nd plane reads + y write + y read
    (the carry's reduction).  `tile` is the reference's TPU block height and
    has no role on the card."""
    del tile
    lanes = 128
    rng = np.random.default_rng(0)
    d3 = rng.normal(size=(read_streams, rows, lanes)).astype(np.float32)
    d = torch.from_numpy(d3.reshape(read_streams, rows * lanes)).to(_device(device))

    def one_pass(s, d):
        return torch.sum(plane_sum(s, d)) * 1e-20 + 1.0

    return one_pass, d, (read_streams + 2) * rows * lanes * 4


def _device(device) -> torch.device:
    return torch.device("cuda") if device is None else torch.device(device)


# ---- timing ----------------------------------------------------------------


def measure(fn, *args, warmup: int = 3, iters: int = 20, bytes_moved=0, flops=0) -> Roofline:
    """Per-call seconds of `fn(*args)` over `iters` calls: CUDA events on the
    current stream for CUDA results (the host's launch cost is in it when
    the calls are short), the host clock otherwise."""
    out = fn(*args)
    for _ in range(warmup):
        out = fn(*args)
    cuda = isinstance(out, torch.Tensor) and out.device.type == "cuda"
    dev = out.device if isinstance(out, torch.Tensor) else torch.device("cpu")
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) * 1e-3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        dt = (time.perf_counter() - t0) / iters
    return Roofline(seconds=max(dt, 1e-12), bytes=bytes_moved, flops=flops,
                    peak_gbps=hbm_peak_gbps(dev))


def _chain(vec_fn, x, k: int, operands):
    for _ in range(k):
        x = vec_fn(x, *operands)
    return x


def _capture_chain(vec_fn, x0, length: int, operands=()):
    """A CUDA graph of `length` dependent applies of vec_fn from a static
    copy of x0: (graph, static input, output).  Each replay computes the
    same chain again from the static input, which the caller keeps alive
    while it replays.  vec_fn must not read back to the host; its
    allocations come from the graph's pool.  Raises when the capture fails —
    there is no eager timing in its place."""
    x_static = x0.clone()
    side = torch.cuda.Stream(device=x0.device)
    side.wait_stream(torch.cuda.current_stream(x0.device))
    with torch.cuda.stream(side):  # warm outside the capture: builds, JITs
        _chain(vec_fn, x_static, 2, operands)
    torch.cuda.current_stream(x0.device).wait_stream(side)
    torch.cuda.synchronize(x0.device)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = _chain(vec_fn, x_static, length, operands)
    except Exception as e:
        raise RuntimeError(f"measure_chained: the CUDA graph capture of the chain "
                           f"failed ({type(e).__name__}: {e})") from e
    return graph, x_static, out


def _replays_seconds(graph, k: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(k):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


def _host_seconds(vec_fn, x0, k: int, operands) -> float:
    t0 = time.perf_counter()
    _chain(vec_fn, x0, k, operands)
    return time.perf_counter() - t0


def measure_chained(vec_fn, x0, iters: int | None = None, warmup: int = 2,
                    bytes_moved=0, flops=0, target_seconds: float = 1.0,
                    operands=()) -> Roofline:
    """Seconds per apply of a vector -> vector function, chained.

    On the card: a CUDA graph of GRAPH_LEN dependent applies
    `x = vec_fn(x, *operands)` is captured once and replayed; CUDA events
    time r and 2r replays, and the slope over the r·GRAPH_LEN applies
    between them is the time per apply — the host's launch cost and any
    fixed cost cancel.  `iters` applies (None: as many as make the longer
    chain take about `target_seconds`, from a probe) set r.  On CPU tensors
    the chain runs eagerly on the host clock, with the same slope between
    the least of HOST_REPEATS timings of each length.  The rate derived from
    a working set that fits in the 50 MB L2 is an L2 rate.  The wrappers
    count their launches while the graph is captured, not at its replays."""
    for _ in range(max(warmup, 1)):
        vec_fn(x0, *operands)
    if x0.device.type == "cuda":
        graph, x_static, _ = _capture_chain(vec_fn, x0, GRAPH_LEN, operands)
        graph.replay()  # the first replay uploads the graph
        if iters is None:
            per_est = max(_replays_seconds(graph, 4) / (4 * GRAPH_LEN), 1e-9)
            iters = int(min(max(target_seconds / (2 * per_est), 256), 200_000))
        r = max(-(-iters // GRAPH_LEN), 1)
        t1, t2 = _replays_seconds(graph, r), _replays_seconds(graph, 2 * r)
        per_iter = max((t2 - t1) / (r * GRAPH_LEN), 1e-12)
        del graph, x_static
    else:
        if iters is None:
            per_est = max(_host_seconds(vec_fn, x0, 16, operands) / 16, 1e-9)
            iters = int(min(max(target_seconds / (2 * per_est), 32), 200_000))
        # the host clock: a preempted chain inflates one timing, and a single
        # slope t2 - t1 can then come out near zero or negative, so each
        # length takes the least of HOST_REPEATS timings, in turns; a slope
        # that still is not positive falls back to the longer chain's time
        # per apply (fixed cost included)
        t1 = t2 = float("inf")
        for _ in range(HOST_REPEATS):
            t1 = min(t1, _host_seconds(vec_fn, x0, iters, operands))
            t2 = min(t2, _host_seconds(vec_fn, x0, 2 * iters, operands))
        per_iter = (t2 - t1) / iters if t2 > t1 else t2 / (2 * iters)
        per_iter = max(per_iter, 1e-12)
    return Roofline(seconds=per_iter, bytes=bytes_moved, flops=flops,
                    peak_gbps=hbm_peak_gbps(x0.device))


def measure_stream_peak(n: int = 64 * 1024 * 1024, target_seconds: float = 1.0,
                        device=None) -> float:
    """Measured dense-streaming rate [GB/s]: a STREAM-triad chain, one
    torch.add(b, v, alpha=0.9999999) per step (read v, read b, write v':
    3 streams of 4·n bytes), timed by measure_chained.  With the read peak,
    a floor under the published rate in the roofline denominator."""
    dev = _device(device)
    b = torch.full((n,), 1.0000001, dtype=torch.float32, device=dev)
    x = torch.ones(n, dtype=torch.float32, device=dev)
    r = measure_chained(lambda v, b: torch.add(b, v, alpha=0.9999999), x,
                        target_seconds=target_seconds, operands=(b,))
    return 3 * n * 4 / r.seconds / 1e9


def measure_read_peak(read_streams: int = 7, rows: int = 65536, tile: int = 512,
                      chain_len: int = 1000, device=None) -> float:
    """Measured READ-dominant streaming rate [GB/s], shaped like the Dia
    SpMV: the plane-sum kernel reads `read_streams` planes and writes one,
    with no x reads — less work per byte than the SpMV, meant as a ceiling
    the SpMV is held to (the pass's separate reduction and scalar launches
    keep it near the Dia SpMV's rate on the H100: PERF.md §6).  Each pass
    feeds a 0-d carry to the next (c read through a device pointer).  Timed
    by measure_chained over chains of chain_len and 2·chain_len passes
    (CUDA events, the slope).

    Bytes per pass: (read_streams + 2)·rows·128·4."""
    one_pass, d, bytes_per_pass = _read_peak_kernel(read_streams, rows, tile, device)
    s0 = torch.ones((), dtype=torch.float32, device=d.device)
    r = measure_chained(one_pass, s0, iters=chain_len, operands=(d,))
    return bytes_per_pass / r.seconds / 1e9


def measure_read_peak_device(read_streams: int = 7, rows: int = 65536, tile: int = 512,
                             iters: int = 1500, device=None) -> float:
    """The read-dominant peak [GB/s] from the DEVICE timeline: the same
    plane-sum chain timed by measure_device_chained, the denominator of a
    device-timeline SpMV fraction (one clock for both).  0.0 on the CPU."""
    one_pass, d, bytes_per_pass = _read_peak_kernel(read_streams, rows, tile, device)
    s0 = torch.ones((), dtype=torch.float32, device=d.device)
    per = measure_device_chained(one_pass, s0, iters, operands=(d,))
    return bytes_per_pass / per / 1e9 if per > 0 else 0.0


def measure_device_chained(vec_fn, x0, iters: int, operands=()) -> float:
    """Per-apply seconds of a chain of `iters` applies, from the DEVICE
    timeline: the chain runs eagerly under torch.profiler (a replayed CUDA
    graph's kernels may not be reported) and the card's busy time is the
    union of its event intervals — blind to the host's gaps, so host-clock
    times can only be longer.  0.0 for CPU tensors (no device timeline);
    raises when a CUDA run records no device event."""
    if x0.device.type != "cuda":
        return 0.0
    _chain(vec_fn, x0, 2, operands)  # warm outside the profile
    torch.cuda.synchronize(x0.device)
    busy = device_time.device_busy_seconds(lambda: _chain(vec_fn, x0, iters, operands))
    return busy / iters
