"""The steady step's value update: resident LDU source blocks written into a
container's flat value storage (and an uploaded bfloat16 delta decoded on
the way), one hand-written CUDA C++ kernel launch for any number of blocks,
beside its plain PyTorch twin.

  value_update  `csrc/value_update.cu` (`ogl_value_update`), body
                `csrc/value_update.cuh`

Counterpart: ogl_tpu/foam/solver.py `_apply_block_updates` (:483-529, one
jit'd program per changed-block set), `_apply_delta` (:38-42) and the full
path's `_assemble_from_blocks` + `ValueMap.update` (ogl_tpu/core/
formats.py:641-654).  No TPU kernel: XLA ops in the reference.

A call takes
  sources  (old, delta, out) per resident block: old float32 (size,), delta
           None or bfloat16 (size,) — then every read of the block reads
           old + float(delta) —, out None or a float32 (size,) buffer of its
           own that receives old + float(delta) (the block's new resident
           copy);
  writes   `Write`s: `items` slots of `flat`, slot dest[k] (or start + k)
           set to scale · the value at source position src[k] (or k) of
           block `block` — or, with `seg`, the sum from 0 of scale · value
           over entries seg[k] .. seg[k + 1] - 1 in that order; block -1
           reads src over all sources in order (a value map whose slots take
           several entries, core/formats.py `accumulate_plan`).
Products and sums are rounded one by one, in the kernel's order, so the
kernel and `value_update_plain` give the same bits.

Dispatch, as every wrapper of the port: CPU tensors run the twin; CUDA
tensors launch the kernel or raise (wrong device, dtype, shape, contiguity,
too many blocks, a refused launch) — there is no fallback.  `flat` is
written in place: callers hand it a buffer no container shares
(`formats.fresh_values`, or zeros).  Each launch counts in
`ogl_tpu_torch.kernels.launches["value_update"]`.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ogl_tpu_torch import kernels
from ogl_tpu_torch.kernels import _build
from ogl_tpu_torch.kernels.dia_spmv import on_cpu, require_cuda, sm_count, stream_of

__all__ = ["Write", "value_update", "value_update_plain", "MAX_SOURCES", "MAX_WRITES",
           "THREADS"]

MAX_SOURCES = 8  # csrc/value_update.cuh kMaxSources
MAX_WRITES = 8  # kMaxWrites
THREADS = 256
BLOCKS_PER_SM = 64  # grid cap of the grid-stride loop


@dataclasses.dataclass(frozen=True)
class Write:
    """One write into the flat values: see the module's docstring.  Tables
    int32 on the flat's device."""

    block: int
    src: torch.Tensor | None
    dest: torch.Tensor | None
    seg: torch.Tensor | None
    start: int
    items: int
    scale: float


def _tensors(flat, sources, writes) -> list:
    ts = [flat]
    for s in sources:
        ts += [t for t in s if t is not None]
    for w in writes:
        ts += [t for t in (w.src, w.dest, w.seg) if t is not None]
    return ts


def value_update_plain(flat, sources, writes) -> None:
    """The twin: the kernel's function by torch ops, in its order (on any
    device: the wrapper runs it for CPU tensors, the checks on the card
    beside the kernel)."""
    vals = [old if delta is None else old + delta.float() for old, delta, _ in sources]
    for (_, delta, out), v in zip(sources, vals):
        if out is not None:
            out.copy_(v)
    for w in writes:
        space = vals[w.block] if w.block >= 0 else torch.cat(vals)
        scale = torch.tensor(w.scale, dtype=flat.dtype, device=flat.device)
        entries = w.items if w.seg is None else None
        if w.src is not None:
            e = space[w.src.long()]
        else:
            e = space if entries is None else space[:entries]
        e = scale * e
        if w.seg is None:
            v = e
        else:
            seg = w.seg.long()
            count = seg[1:] - seg[:-1]
            v = torch.zeros(w.items, dtype=flat.dtype, device=flat.device)
            for k in range(int(count.max()) if w.items else 0):
                live = count > k
                v[live] = v[live] + e[seg[:-1][live] + k]
        if w.dest is None:
            flat[w.start:w.start + w.items] = v
        else:
            flat[w.dest.long()] = v


def _check(flat, sources, writes) -> None:
    what = "value_update"
    device = flat.device
    if len(sources) > MAX_SOURCES or len(writes) > MAX_WRITES:
        raise ValueError(f"{what}: {len(sources)} blocks and {len(writes)} writes; the kernel "
                         f"takes at most {MAX_SOURCES} and {MAX_WRITES}")

    def tensor(name, t, dtype, numel=None):
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}; the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        if numel is not None and t.numel() != numel:
            raise ValueError(f"{what}: {name} has {t.numel()} entries, expected {numel}")

    tensor("flat", flat, torch.float32)
    for i, (old, delta, out) in enumerate(sources):
        tensor(f"block {i}", old, torch.float32)
        if old.dim() != 1:
            raise ValueError(f"{what}: block {i} is not 1-D")
        if delta is not None:
            tensor(f"delta {i}", delta, torch.bfloat16, old.numel())
        if out is not None:
            if delta is None:
                raise ValueError(f"{what}: block {i} has an out buffer and no delta")
            tensor(f"out {i}", out, torch.float32, old.numel())
            if out.data_ptr() == old.data_ptr():
                raise ValueError(f"{what}: block {i}'s out is its resident copy")
    for k, w in enumerate(writes):
        if not -1 <= w.block < len(sources):
            raise ValueError(f"{what}: write {k} reads block {w.block} of {len(sources)}")
        if w.dest is None and w.start + w.items > flat.numel():
            raise ValueError(f"{what}: write {k} runs past the {flat.numel()} values")
        if w.dest is not None:
            tensor(f"dest {k}", w.dest, torch.int32, w.items)
        if w.seg is not None:
            tensor(f"seg {k}", w.seg, torch.int32, w.items + 1)
        if w.src is not None:
            tensor(f"src {k}", w.src, torch.int32, w.items if w.seg is None else None)
        elif w.seg is None and w.block >= 0 and w.items > sources[w.block][0].numel():
            raise ValueError(f"{what}: write {k} reads past block {w.block}")


def value_update(flat: torch.Tensor, sources, writes) -> None:
    """Apply `writes` (and decode every source's delta into its `out`) in one
    launch; see the module's docstring."""
    sources = [tuple(s) for s in sources]
    if on_cpu(*_tensors(flat, sources, writes)):
        return value_update_plain(flat, sources, writes)
    require_cuda("value_update", flat)
    _check(flat, sources, writes)
    words = []
    offset = 0
    for old, delta, out in sources:
        words += [old.data_ptr(), 0 if delta is None else delta.data_ptr(),
                  0 if out is None else out.data_ptr(), old.numel(), offset]
        offset += old.numel()
    wwords = []
    for w in writes:
        wwords += [0 if t is None else t.data_ptr() for t in (w.src, w.dest, w.seg)]
        wwords += [w.start, w.items, w.block]
    src_words = (ctypes.c_int64 * max(len(words), 1))(*words)
    write_words = (ctypes.c_int64 * max(len(wwords), 1))(*wwords)
    scales = (ctypes.c_float * max(len(writes), 1))(*(w.scale for w in writes))
    items = sum(w.items for w in writes) + sum(
        old.numel() for old, _, out in sources if out is not None)
    blocks = max(min(-(-items // THREADS), BLOCKS_PER_SM * sm_count(flat.device.index)), 1)
    lib = _build.library()
    _build.check(lib.ogl_value_update(src_words, len(sources), write_words, scales,
                                      len(writes), flat.data_ptr(), blocks, stream_of(flat)),
                 "value_update")
    kernels.launches["value_update"] += 1


def bytes_moved(sources, writes, entries: int | None = None) -> int:
    """The least bytes of one call (each input read once, each output
    written once): per written slot its entry's 4-byte value read and 4
    written, 4 per int32 table entry read (dest, src, seg), 2 per delta
    value read at a gather and, per decoded position, 4 + 2 read and 4
    written.  `entries`: the summed entries of the accumulate writes (the
    host does not read the seg tables back)."""
    total = 0
    for old, delta, out in sources:
        if out is not None:
            total += old.numel() * 10
    for w in writes:
        n_e = w.items if w.seg is None else int(entries or w.items)
        per_entry = 4 + (4 if w.src is not None else 0)
        if w.block >= 0 and sources[w.block][1] is not None:
            per_entry += 2
        total += n_e * per_entry + w.items * 4
        if w.dest is not None:
            total += w.items * 4
        if w.seg is not None:
            total += (w.items + 1) * 4
    return int(np.int64(total))
