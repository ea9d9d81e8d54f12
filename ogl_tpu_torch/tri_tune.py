"""Where the ILU family's two triangular kernels stand on one NVIDIA GPU, over
the launch settings their wrappers leave open (kernels/tri_solve.py):

* kernel 2 (`tri_levels`, exact substitution on ready words): the entries
  whose words a thread loads at once, threads per block, blocks per SM and
  the longest backoff between two polls (`level_launch`'s settings), on a
  chain factor (µs per dependent hop), on
  empty factors (no row waits: the cost of a position), on the
  Poisson grid's IC(0) factors at 128x128x64 and 256x256x128 and on the
  262,144-cell kNN-6 mesh's ICT and ILUT factors;
* kernel 1 (`tri_sweep`, 8 + 8 Jacobi sweeps): the factors held as
  `SWEEP_HOLD_SHARE` has it, held as far as they fit whatever the share,
  and streamed, on the same factors in turns (three rounds, the settings in
  order and then in reverse), and sweep counts 1, 2, 4 and 8 at 1M (the
  cost of a pass and of the rest).

Each setting is launched through the wrapper's own launch function
(`tri_solve._launch_levels`, `tri_solve._launch_sweeps`), so nothing of
the wrapper is patched.

Every setting's result is held bit-equal to the plain twin before it is
timed (median ms of CUDA events around each call, after warm-up calls).

    python -m ogl_tpu_torch.tri_tune [--quick]

prints one JSON line per setting.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ogl_tpu_torch import testing
from ogl_tpu_torch.core import ldu
from ogl_tpu_torch.kernels import tri_solve
from ogl_tpu_torch.precond import ilu


def _ms(fn, reps=15, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _chain(n, device):
    g = np.random.default_rng(21)
    i = np.arange(1, n)
    return ilu.state_from_factors((i, i - 1, g.uniform(-0.9, 0.9, n - 1)),
                                  (i - 1, i, g.uniform(-0.9, 0.9, n - 1)),
                                  g.uniform(1.0, 2.0, n), "lu", device, exact=True)


def _coo(m):
    return ldu.ldu_to_coo_host(m, dtype=np.float32)


def _ic(coo, device):
    lo, d = ilu.ic0_factor(coo)
    return ilu.state_from_factors(lo, None, d, "ic", device)


def _ict(coo, device):
    lo, d = ilu.ict_factor(coo)
    return ilu.state_from_factors(lo, None, d, "ic", device)


def _empty(n, device, sweeps=8):
    """Factors of n rows without entries: no row waits on another (kernel 2's
    cost per position, kernel 1's per pass without a sum)."""
    none = np.zeros(0, np.int64)
    return ilu.state_from_factors((none, none, np.zeros(0)), (none, none, np.zeros(0)),
                                  np.ones(n), "lu", device, sweeps=sweeps, exact=True)


def _knn(n):
    m, perm = testing.knn_ldu(n)
    return testing.renumber_ldu(m, np.argsort(perm))


def level_settings(quick):
    if quick:
        return [(tri_solve.LEVEL_BLOCKS[0], *tri_solve.LEVEL_WIDE),
                (tri_solve.LEVEL_BLOCKS[1], *tri_solve.LEVEL_NARROW)]
    return [(block, t, b, nap) for block in tri_solve.LEVEL_BLOCKS
            for t, b in ((64, 1), (64, 4), (128, 2), (128, 4), (256, 1), (256, 2), (256, 4))
            for nap in (0, 32)]


def tune_levels(states, device, quick):
    want = {k: tri_solve.tri_levels_plain(st.lower, st.upper, r) for k, (st, r) in
            states.items()}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for cfg in level_settings(quick):
        block, threads, per_sm, sleep = cfg
        if per_sm * sms > tri_solve.level_grid(device.index or 0, threads, block):
            continue
        line = {"kernel": "tri_levels", "block": block, "threads": threads,
                "blocks_per_sm": per_sm, "sleep_ns": sleep}
        for k, (st, r) in states.items():
            def run(st=st, r=r, cfg=cfg):
                return tri_solve._launch_levels(st.lower, st.upper, r, cfg)

            if not torch.equal(run(), want[k]):
                raise RuntimeError(f"tri_levels {line} on {k} is not bit-equal to its twin")
            ms = _ms(run)
            line[k + "_ms"] = ms
            if k == "chain":
                line["hop_us"] = ms * 1e3 / (st.lower.depth + st.upper.depth)
        print(json.dumps(line), flush=True)


def sweep_settings(quick):
    """Kernel 1's hold shares by name: the rule's, any share (every factor
    held as far as it fits) and none (every factor streamed)."""
    held = {"held (rule)": tri_solve.SWEEP_HOLD_SHARE}
    return held if quick else {**held, "held as far as fits": 0.0, "streamed": math.inf}


def tune_sweeps(states, quick):
    """Kernel 1 under each hold share on each factor, in turns; then its
    cost per pass at 1M from sweep counts 1, 2, 4 and 8."""
    settings = sweep_settings(quick)
    for k, (st, r) in states.items():
        want = tri_solve.tri_sweep_plain(st.lower, st.upper, r)
        runs, times = {}, {name: [] for name in settings}
        for name, share in settings.items():
            def run(st=st, r=r, share=share):
                return tri_solve._launch_sweeps(st.lower, st.upper, r, share)

            if not torch.equal(run(), want):
                raise RuntimeError(f"tri_sweep {name} on {k} is not bit-equal to its twin")
            runs[name] = run
        for _ in range(3):
            for name in [*settings, *reversed(settings)]:
                times[name].append(_ms(runs[name]))
        for name in settings:
            print(json.dumps({"kernel": "tri_sweep", "factor": k, "setting": name,
                              "ms": times[name]}), flush=True)
    if quick or "ic1m" not in states:
        return
    st, r = states["ic1m"]
    for k in (1, 2, 4, 8):
        deep = [dataclasses.replace(t, sweeps=k, _tables={}) for t in (st.lower, st.upper)]
        line = {"kernel": "tri_sweep", "sweeps": k,
                "ic1m_ms": _ms(lambda deep=deep: tri_solve.tri_sweep(*deep, r))}
        print(json.dumps(line), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("tri_tune: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    quick = "--quick" in sys.argv[1:]
    device = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(21)
    coo1 = _coo(testing.poisson_ldu((128, 128, 64)))
    ic1 = _ic(coo1, device)
    knn_coo = _coo(_knn(1 << 18))
    knn = _ict(knn_coo, device)
    knn_ilut = ilu.state_from_factors(*ilu.ilut_factors(knn_coo), "lu", device)
    chain = _chain(4096, device)
    print(f"set-up {time.perf_counter() - t0:.1f} s; IC(0) 1M depth {ic1.lower.depth} + "
          f"{ic1.upper.depth}, kNN ICT depth {knn.lower.depth} + {knn.upper.depth}",
          flush=True)
    vec = lambda st: torch.randn(st.lower.n, device=device, generator=g)  # noqa: E731
    states = {"chain": (chain, vec(chain)), "ic1m": (ic1, vec(ic1)),
              "knn_ict": (knn, vec(knn)), "knn_ilut": (knn_ilut, vec(knn_ilut))}
    if not quick:
        ic8 = _ic(_coo(testing.poisson_ldu((256, 256, 128))), device)
        states["ic8m"] = (ic8, vec(ic8))
        for n, tag in ((1 << 20, "empty1m"), (1 << 23, "empty8m")):
            e = _empty(n, device)
            states[tag] = (e, vec(e))
    tune_levels(states, device, quick)
    states.pop("chain")
    tune_sweeps(states, quick)
    print(f"done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
