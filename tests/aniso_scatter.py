"""Iteration counts of float32 GKOBiCGStab + ILU (8 sweeps) on the 1000:1
anisotropic case of tests/test_trisolve_exact.py, in the JAX reference and
in the port on the CPU, from b = default_rng(seed) normals and from b
scaled by 1 + 2⁻²³ and 1 − 2⁻²³ (one float32 ulp of the scale).  Both
sides' counts scatter over an order of magnitude under that perturbation,
which is why tests/test_torch_ilu.py's anisotropic study counts the
8-sweep run converged or not.

    JAX_PLATFORMS=cpu python tests/aniso_scatter.py [seed ...]   # default 0 1 2 3
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from ogl_tpu import foam as ref_foam  # noqa: E402
from ogl_tpu import registry as ref_registry  # noqa: E402
from ogl_tpu import testing as ref_testing  # noqa: E402
from ogl_tpu_torch import foam, interop, registry  # noqa: E402

CONTROLS = {"solver": "GKOBiCGStab", "tolerance": 1e-6, "relTol": 0.0, "maxIter": 4000,
            "preconditioner": {"preconditioner": "ILU"}}
SCALES = (("1", 1.0), ("1+2^-23", 1 + 2.0 ** -23), ("1-2^-23", 1 - 2.0 ** -23))


def aniso(dims=(24, 24), ratio=1000.0):
    """The reference's stiff anisotropic diffusion (x couplings × ratio)."""
    m = ref_testing.poisson_ldu(dims)
    la, ua = np.asarray(m.lower_addr), np.asarray(m.upper_addr)
    upper = np.where((ua - la) == 1, m.upper * ratio, m.upper)
    diag = np.ones(m.n)
    np.add.at(diag, la, np.abs(upper))
    np.add.at(diag, ua, np.abs(upper))
    return dataclasses.replace(m, upper=upper.astype(m.upper.dtype),
                               diag=diag.astype(m.diag.dtype))


def main(seeds):
    m_ref = aniso()
    m = interop.ldu_from_arrays(m_ref.n, m_ref.lower_addr, m_ref.upper_addr, m_ref.diag,
                                m_ref.upper, None)
    for seed in seeds:
        b0 = np.random.default_rng(seed).normal(size=m.n)
        for tag, scale in SCALES:
            ref_registry.global_registry.clear()
            registry.global_registry.clear()
            _, pr = ref_foam.solve("p", m_ref, b0 * scale, CONTROLS)
            _, pp = foam.solve("p", m, b0 * scale, {**CONTROLS, "executor": "cpu"})
            print(f"seed {seed} b*{tag}: reference {pr.n_iterations} "
                  f"converged={pr.converged}; port {pp.n_iterations} "
                  f"converged={pp.converged}", flush=True)


if __name__ == "__main__":
    main([int(s) for s in sys.argv[1:]] or [0, 1, 2, 3])
