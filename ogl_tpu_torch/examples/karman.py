#!/usr/bin/env python
"""Karman vortex street — flow past a square cylinder on the PyTorch/CUDA
port's solver stack (ogl_tpu_torch), on the card by default.

Counterpart: examples/karman.py, the same application on ogl_tpu; this copy
imports only the port (`foam`, `testing.poisson_ldu`, `core.ldu`), takes
its solutions back with `.cpu()`, and runs where `executor` says (`cuda` by
default, `cpu` for the tests).

This is the reference's headline demo (reference README.md:159-161: a
Karman vortex street with the momentum and pressure-Poisson solves
offloaded through OGL).  Same role here, OpenFOAM-free: a vorticity–
streamfunction channel flow past a square cylinder whose two linear
systems per time step ride the `foam` front end —

  * vorticity transport (implicit Euler + upwind, coefficients change
    every step with the advecting field) → GKOBiCGStab + BJ;
  * streamfunction Poisson (constant SPD operator, changing RHS)
    → GKOCG + Multigrid.

The cylinder is a block of Dirichlet-pinned nodes inside the structured
grid (the operator keeps its stencil structure: solid rows become
identity, fluid↔solid couplings fold into the RHS with Thom wall
vorticity), so the whole run stays on the Dia format and its loop kernels.

Shedding is self-sustained above Re ≈ 50; the script reports the
Strouhal number St = f·D/U from the probe-v zero crossings.  Square
cylinder at Re_D = 100: St ≈ 0.14-0.15 (Okajima 1982, Sohankar et al.).

Usage: python -m ogl_tpu_torch.examples.karman [--re 100] [--steps 4000] [--executor cuda]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ogl_tpu_torch import foam
from ogl_tpu_torch import testing as problems
from ogl_tpu_torch.core import ldu


class Karman:
    """Channel [0, L]x[0, H] with a square cylinder of side D centred at
    (x_c, H/2).  Interior nodes i = 0..nx-1, j = 0..ny-1 at spacing h;
    boundaries are ghost values: inlet ψ = U·y (uniform inflow), bottom
    ψ = 0 / top ψ = U·H (free-slip, ω = 0), outlet zero-gradient."""

    def __init__(self, nx=192, ny=64, d=8, re=100.0, dt=None,
                 xc_frac=0.25, wall_relax=0.6):
        self.nx, self.ny, self.d = nx, ny, d
        self.h = 1.0 / d  # cylinder side = unit length
        self.u0 = 1.0
        self.nu = self.u0 * 1.0 / re  # Re_D with D_phys = 1
        self.dt = dt if dt is not None else 0.4 * self.h / self.u0
        self.wall_relax = wall_relax
        h = self.h
        self.H = (ny + 1) * h
        self.psi_obs = self.u0 * self.H / 2.0

        # solid mask: d x d nodes centred at (xc, H/2)
        i0 = int(round(xc_frac * nx)) - d // 2
        j0 = (ny - d) // 2
        self.solid = np.zeros((ny, nx), bool)
        self.solid[j0 : j0 + d, i0 : i0 + d] = True
        self.i0, self.j0 = i0, j0

        self.psi = np.where(
            self.solid, self.psi_obs,
            self.u0 * (np.arange(1, ny + 1) * h)[:, None] * np.ones(nx))
        self.omega = np.zeros((ny, nx))
        self._wall = {}

        base = problems.poisson_ldu((nx, ny))
        self.lower_addr = np.asarray(base.lower_addr)
        self.upper_addr = np.asarray(base.upper_addr)
        self.x_faces = (self.upper_addr - self.lower_addr) == 1
        self.y_faces = ~self.x_faces
        sflat = self.solid.ravel()
        self.face_solid = sflat[self.lower_addr] | sflat[self.upper_addr]
        self.a_psi, self.rhs0_psi = self._assemble_psi()

    # --- constant streamfunction operator --------------------------------
    def _assemble_psi(self):
        """−∇²ψ·h² system: diag 4, off −1; inlet/walls Dirichlet (ghost
        known → RHS), outlet Neumann (ghost = P → diag 3), solid rows
        identity with fluid couplings folded to the RHS."""
        nx, ny, h = self.nx, self.ny, self.h
        n = nx * ny
        sflat = self.solid.ravel()
        upper = np.where(self.face_solid, 0.0, -1.0)
        diag = np.full(n, 4.0)
        d2 = diag.reshape(ny, nx)
        d2[:, -1] -= 1.0  # outlet: ψ_ghost = ψ_P
        diag[sflat] = 1.0

        rhs0 = np.zeros((ny, nx))
        yj = np.arange(1, ny + 1) * h
        rhs0[:, 0] += self.u0 * yj          # inlet ψ = U·y
        rhs0[-1, :] += self.u0 * self.H     # top wall
        # bottom wall ψ = 0 contributes nothing
        # fluid nodes next to the solid block: coupling × ψ_obs
        s = self.solid
        fold = np.zeros((ny, nx))
        fold[:, :-1] += s[:, 1:]   # east neighbour solid
        fold[:, 1:] += s[:, :-1]   # west
        fold[:-1, :] += s[1:, :]   # north
        fold[1:, :] += s[:-1, :]   # south
        rhs0 += np.where(~s, fold * self.psi_obs, 0.0)
        rhs0[s] = self.psi_obs      # identity rows
        m = ldu.LduMatrix(n=n, lower_addr=self.lower_addr,
                          upper_addr=self.upper_addr, diag=diag, upper=upper)
        return m, rhs0.ravel()

    # --- kinematics -------------------------------------------------------
    def _psi_ghosted(self):
        nx, ny, h = self.nx, self.ny, self.h
        pn = np.empty((ny + 2, nx + 2))
        pn[1:-1, 1:-1] = self.psi
        pn[0, 1:-1] = 0.0                       # bottom wall
        pn[-1, 1:-1] = self.u0 * self.H          # top wall
        pn[1:-1, 0] = self.u0 * np.arange(1, ny + 1) * h  # inlet
        pn[1:-1, -1] = self.psi[:, -1]           # outlet zero-gradient
        pn[0, 0] = pn[0, 1]
        pn[0, -1] = pn[0, -2]
        pn[-1, 0] = pn[-1, 1]
        pn[-1, -1] = pn[-1, -2]
        return pn

    def velocities(self):
        h = self.h
        pn = self._psi_ghosted()
        u = (pn[2:, 1:-1] - pn[:-2, 1:-1]) / (2 * h)
        v = -(pn[1:-1, 2:] - pn[1:-1, :-2]) / (2 * h)
        u[self.solid] = 0.0
        v[self.solid] = 0.0
        return u, v

    def _relaxed(self, key, value):
        lam = self.wall_relax
        old = self._wall.get(key)
        out = value if old is None else lam * value + (1 - lam) * old
        self._wall[key] = out
        return out

    # --- vorticity-transport assembly --------------------------------------
    def assemble_omega(self):
        nx, ny, h, nu, dt = self.nx, self.ny, self.h, self.nu, self.dt
        n = nx * ny
        u, v = self.velocities()
        uf, vf = u.ravel(), v.ravel()
        dcoef = nu / h**2

        lo, up = self.lower_addr, self.upper_addr
        upper = np.empty(len(lo))
        lower = np.empty(len(lo))
        xf, yf = self.x_faces, self.y_faces
        upper[xf] = np.minimum(uf[lo[xf]], 0.0) / h - dcoef
        lower[xf] = -np.maximum(uf[up[xf]], 0.0) / h - dcoef
        upper[yf] = np.minimum(vf[lo[yf]], 0.0) / h - dcoef
        lower[yf] = -np.maximum(vf[up[yf]], 0.0) / h - dcoef
        upper[self.face_solid] = 0.0
        lower[self.face_solid] = 0.0
        diag = 1.0 / dt + 4.0 * dcoef + (np.abs(uf) + np.abs(vf)) / h
        sflat = self.solid.ravel()
        diag[sflat] = 1.0

        rhs = (self.omega / dt).copy()
        s, psi = self.solid, self.psi
        # domain boundaries: inlet/top/bottom ω = 0 (nothing to fold);
        # outlet ghost = P → fold its coefficient into the diagonal
        cout = np.minimum(u[:, -1], 0.0) / h - dcoef
        d2 = diag.reshape(ny, nx)
        d2[:, -1] += cout
        # cylinder surface: Thom wall vorticity from the adjacent fluid ψ
        # (wall at the solid node, ψ_wall = ψ_obs, no tangential slip);
        # under-relaxed like the cavity's closure
        po = self.psi_obs
        for key, fluid, solidnb, coef in (
            # fluid has a solid EAST neighbour: c = u⁻/h − ν/h²
            ("e", (slice(None), slice(0, nx - 1)), (slice(None), slice(1, nx)),
             lambda ff: np.minimum(u[ff], 0.0) / h - dcoef),
            ("w", (slice(None), slice(1, nx)), (slice(None), slice(0, nx - 1)),
             lambda ff: -np.maximum(u[ff], 0.0) / h - dcoef),
            ("n", (slice(0, ny - 1), slice(None)), (slice(1, ny), slice(None)),
             lambda ff: np.minimum(v[ff], 0.0) / h - dcoef),
            ("s", (slice(1, ny), slice(None)), (slice(0, ny - 1), slice(None)),
             lambda ff: -np.maximum(v[ff], 0.0) / h - dcoef),
        ):
            adj = (~s[fluid]) & s[solidnb]  # fluid nodes with solid nb
            wall = self._relaxed(key, -2.0 * (psi[fluid] - po) / h**2)
            rhs[fluid] = np.where(adj, rhs[fluid] - coef(fluid) * wall,
                                  rhs[fluid])
        rhs[s] = 0.0
        m = ldu.LduMatrix(n=n, lower_addr=lo, upper_addr=up,
                          diag=diag, upper=upper, lower=lower)
        return m, rhs.ravel()


def run(nx=192, ny=64, d=8, re=100.0, steps=4000, verbose=True, seed=0,
        omega_controls=None, psi_controls=None, executor="cuda"):
    """Time-march; returns (case, probe trace of v at (x_c + 3D, H/2)).
    `executor` (`cuda`, or `cpu`) goes into both solvers' controls unless
    they name one."""
    k = Karman(nx=nx, ny=ny, d=d, re=re)
    # seed the instability: small antisymmetric vorticity noise in the wake
    rng = np.random.default_rng(seed)
    k.omega += 0.05 * rng.standard_normal(k.omega.shape) * (~k.solid)

    omega_controls = omega_controls or {
        "solver": "GKOBiCGStab", "tolerance": 1e-7, "relTol": 0.0,
        "maxIter": 1000,
        "preconditioner": {"preconditioner": "BJ", "maxBlockSize": 1}}
    psi_controls = psi_controls or {
        "solver": "GKOCG", "tolerance": 1e-7, "relTol": 0.0, "maxIter": 1000,
        "preconditioner": {"preconditioner": "Multigrid", "caching": 10**9}}
    osolver = foam.FoamSolver("karman_omega", {"executor": executor, **omega_controls})
    psolver = foam.FoamSolver("karman_psi", {"executor": executor, **psi_controls})

    ip = min(k.i0 + k.d + 3 * d, nx - 2)
    jp = ny // 2
    probe = []
    t0 = time.perf_counter()
    for step in range(1, steps + 1):
        m, rhs = k.assemble_omega()
        w, perf_w = osolver.solve(m, rhs, psi=k.omega.ravel())
        k.omega = w.cpu().numpy().reshape(ny, nx)
        p, perf_p = psolver.solve(
            k.a_psi, k.h**2 * k.omega.ravel() + k.rhs0_psi,
            psi=k.psi.ravel())
        k.psi = p.cpu().numpy().reshape(ny, nx)
        _, v = k.velocities()
        probe.append(float(v[jp, ip]))
        if verbose and step % 200 == 0:
            print(f"step {step:5d} (t={step * k.dt:7.2f}): omega "
                  f"{perf_w.n_iterations:3d} iters, psi "
                  f"{perf_p.n_iterations:3d} iters, probe v "
                  f"{probe[-1]:+.4f}", flush=True)
    if verbose:
        print(f"wall time {time.perf_counter() - t0:.1f}s for {steps} steps "
              f"({nx}x{ny}, Re={re})")
    return k, np.asarray(probe)


def strouhal(probe, dt, tail_frac=0.5):
    """St = f·D/U from the zero crossings of the probe-v tail (D = U = 1)."""
    tail = probe[int(len(probe) * (1 - tail_frac)):]
    sig = tail - tail.mean()
    sgn = np.sign(sig)
    crossings = np.count_nonzero(np.diff(sgn[sgn != 0]) != 0)
    window_t = len(tail) * dt
    return crossings / 2.0 / window_t, float(np.abs(sig).max())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--re", type=float, default=100.0)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--nx", type=int, default=192)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--executor", default="cuda")
    args = ap.parse_args()

    k, probe = run(nx=args.nx, ny=args.ny, re=args.re, steps=args.steps,
                   executor=args.executor)
    st, amp = strouhal(probe, k.dt)
    print(f"shedding amplitude |v'| = {amp:.4f}, Strouhal = {st:.4f} "
          f"(square cylinder Re=100 literature: 0.14-0.15)")
    if args.re == 100.0 and args.steps >= 3000:
        ok = amp > 0.05 and 0.10 < st < 0.20
        print("VALIDATION", "PASS" if ok else "FAIL")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
