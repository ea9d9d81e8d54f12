"""Hand-written Hopper kernels of the port and their plain PyTorch twins.

Counterpart: ogl_tpu/kernels/.  Each kernel wrapper launches its kernel
for CUDA tensors (or raises) and runs the plain version only for tensors
on the CPU.  `launches` counts kernel launches per wrapper — incremented
right after a launch succeeds and nowhere else — so a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

launches: dict[str, int] = {"dia_spmv": 0, "cg_k1": 0, "cg_k2": 0, "cg_k2i": 0,
                            "cg_k2n": 0, "amg_sweep": 0, "amg_resid": 0,
                            "gdia_spmv": 0, "gdia_k1": 0, "xell_spmv": 0, "xell_k1": 0,
                            "cg_ka": 0, "cg_kb_pipe": 0, "bicgstab_k1b": 0,
                            "bicgstab_kb_update": 0, "read_peak": 0, "cg_loop": 0,
                            "cg_pipe_loop": 0, "bicgstab_loop": 0, "amg_cg_loop": 0,
                            "amg_ir_loop": 0, "bicgstab_gen_loop": 0,
                            "xell_cg_loop": 0, "csr_spmv": 0, "ell_spmv": 0,
                            "sell_spmv": 0, "hybrid_spmv": 0, "ell_cg_loop": 0,
                            "ell_bicgstab_gen_loop": 0, "csr_cg_loop": 0,
                            "csr_bicgstab_gen_loop": 0, "sell_cg_loop": 0,
                            "sell_bicgstab_gen_loop": 0, "block_jacobi": 0,
                            "gmres_arnoldi": 0, "gmres_combine": 0,
                            "tri_sweep": 0, "tri_levels": 0, "amg_ell_sweep": 0,
                            "amg_ell_resid": 0, "amg_gdia_sweep": 0, "amg_gdia_resid": 0,
                            "pgm_restrict": 0, "pgm_prolong": 0,
                            "value_update": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
