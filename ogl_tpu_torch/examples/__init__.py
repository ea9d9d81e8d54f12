"""The two example applications on the port: `cavity` (lid-driven cavity,
ψ–ω) and `karman` (vortex street past a square cylinder), each a time march
whose two linear systems per step go through `ogl_tpu_torch.foam`.

Counterpart: examples/ (the same applications on ogl_tpu).
"""
