#!/usr/bin/env python
"""Lid-driven cavity — a complete incompressible-flow mini-application on
the PyTorch/CUDA port's solver stack (ogl_tpu_torch), on the card by default.

Counterpart: examples/cavity.py, the same application on ogl_tpu; this copy
imports only the port (`foam`, `testing.poisson_ldu`, `core.ldu`), takes
its solutions back with `.cpu()`, and runs where `executor` says (`cuda` by
default, `cpu` for the tests).

The reference's "application" is any OpenFOAM binary that offloads its
linear solves through the GKO* classes (README.md:65, the Karman-vortex
momentum + pressure-Poisson demo, reference README.md:159-161).  This
example plays that role end-to-end without OpenFOAM: a vorticity–
streamfunction solver for the classic lid-driven cavity benchmark whose
two linear systems per time step go through the same `foam` front end an
OpenFOAM run would use —

  * vorticity transport (implicit Euler, first-order upwind convection):
    an ASYMMETRIC LduMatrix whose coefficients change every step →
    GKOBiCGStab + BJ, exercising the per-step coefficient-update path
    (delta uploads, compiled-program reuse; SURVEY §3.2);
  * streamfunction Poisson ∇²ψ = −ω: the SPD pressure-equation analogue →
    GKOCG + Multigrid (PGM-AMG), constant operator with a changing RHS.

Validated against Ghia, Ghia & Shin (JCP 1982): at Re=100 the primary-
vortex streamfunction minimum is ψ_min ≈ −0.1034; a first-order-upwind
solution on a modest grid lands within a few percent and converges toward
it with resolution.

Usage:
  python -m ogl_tpu_torch.examples.cavity [--n 96] [--re 100] [--dt 0.2] [--steps 120]
                                          [--executor cuda]

Numerics: interior nodes i,j = 1..N at spacing h = 1/(N+1); ψ = 0 on all
walls; wall vorticity by Thom's formula (the lid adds −2·U/h).  The
vorticity system is assembled in OpenFOAM LDU form (faces lex-sorted by
(owner, neighbour)) exactly as an fvMatrix would hand it over.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ogl_tpu_torch import foam
from ogl_tpu_torch import testing as problems
from ogl_tpu_torch.core import ldu


class Cavity:
    """State + assembly for the vorticity–streamfunction cavity."""

    def __init__(self, n: int, re: float, dt: float, lid_u: float = 1.0,
                 wall_relax: float = 0.5):
        self.n = n
        self.re = re
        self.nu = 1.0 / re
        self.dt = dt
        self.h = 1.0 / (n + 1)
        self.lid_u = lid_u
        # Thom's closure couples the boundary explicitly; under-relaxing
        # the wall-vorticity update (classic ψ-ω practice) keeps the outer
        # fixed point contractive at time steps far above the raw ~h²·Re
        # explicit limit
        self.wall_relax = wall_relax
        self.psi = np.zeros((n, n))  # [j, i] rows = y, cols = x
        self.omega = np.zeros((n, n))
        self._wall = None  # relaxed (bottom, top, left, right) state
        # constant sparsity: reuse the structured-FV addressing (faces
        # lex-sorted by owner, then neighbour — HostMatrix.C:469-589 input
        # contract) of the Poisson generator for both systems
        self.a_psi = problems.poisson_ldu((n, n))
        base = self.a_psi
        self.lower_addr = np.asarray(base.lower_addr)
        self.upper_addr = np.asarray(base.upper_addr)
        self.x_faces = (self.upper_addr - self.lower_addr) == 1
        self.y_faces = ~self.x_faces

    # --- kinematics -----------------------------------------------------
    def velocities(self):
        """u = ∂ψ/∂y, v = −∂ψ/∂x (central differences, ψ = 0 outside)."""
        h, psi = self.h, self.psi
        pn = np.pad(psi, 1)  # ψ with the wall ring
        u = (pn[2:, 1:-1] - pn[:-2, 1:-1]) / (2 * h)
        v = -(pn[1:-1, 2:] - pn[1:-1, :-2]) / (2 * h)
        return u, v

    def wall_vorticity(self):
        """Thom's first-order wall-vorticity closure, under-relaxed."""
        h, psi = self.h, self.psi
        thom = (-2.0 * psi[0, :] / h**2,
                -2.0 * psi[-1, :] / h**2 - 2.0 * self.lid_u / h,
                -2.0 * psi[:, 0] / h**2,
                -2.0 * psi[:, -1] / h**2)
        lam = self.wall_relax
        if self._wall is None or lam >= 1.0:
            self._wall = thom
        else:
            self._wall = tuple(lam * t + (1.0 - lam) * w
                               for t, w in zip(thom, self._wall))
        return self._wall

    # --- vorticity-transport assembly ------------------------------------
    def assemble_omega(self):
        """(1/Δt + u·∇ − ν∇²) ω^{n+1} = ω^n/Δt + boundary terms, upwind.

        Row P, east neighbour E:   c_PE = min(u_P,0)/h − ν/h²
        Row E, west neighbour P:   c_EP = −max(u_E,0)/h − ν/h²
        (y faces likewise with v); diag = 1/Δt + 4ν/h² + (|u|+|v|)/h.
        Returns (LduMatrix, rhs)."""
        n, h, nu, dt = self.n, self.h, self.nu, self.dt
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
        diag = 1.0 / dt + 4.0 * dcoef + (np.abs(uf) + np.abs(vf)) / h

        rhs = (self.omega / dt).ravel().copy()
        bot, top, left, right = self.wall_vorticity()
        # boundary neighbours are known: move c_Pb·ω_b to the RHS
        r2 = rhs.reshape(n, n)
        u2, v2 = u, v
        r2[0, :] -= (-np.maximum(v2[0, :], 0.0) / h - dcoef) * bot
        r2[-1, :] -= (np.minimum(v2[-1, :], 0.0) / h - dcoef) * top
        r2[:, 0] -= (-np.maximum(u2[:, 0], 0.0) / h - dcoef) * left
        r2[:, -1] -= (np.minimum(u2[:, -1], 0.0) / h - dcoef) * right

        m = ldu.LduMatrix(n=n * n, lower_addr=self.lower_addr,
                          upper_addr=self.upper_addr,
                          diag=diag, upper=upper, lower=lower)
        return m, rhs


def run(n=96, re=100.0, dt=None, steps=None, verbose=True,
        omega_controls=None, psi_controls=None, steady_tol=1e-4, executor="cuda"):
    """Time-march to steady state; returns (cavity, step_records).
    `executor` (`cuda`, or `cpu`) goes into both solvers' controls unless
    they name one.

    dt=None picks 2.5·h — the wall-vorticity closure (Thom) couples the
    boundary explicitly, which caps the stable step at O(h) even though
    the transport solve is implicit.  steps=None covers t ≈ 30 (ample for
    the Re=100 steady state; the |dω/dt|∞ criterion exits earlier)."""
    h = 1.0 / (n + 1)
    if dt is None:
        dt = 2.5 * h
    if steps is None:
        steps = int(30.0 / dt)
    cav = Cavity(n, re, dt)
    omega_controls = omega_controls or {
        "solver": "GKOBiCGStab", "tolerance": 1e-8, "relTol": 0.0,
        "maxIter": 1000,
        "preconditioner": {"preconditioner": "BJ", "maxBlockSize": 1},
    }
    psi_controls = psi_controls or {
        "solver": "GKOCG", "tolerance": 1e-8, "relTol": 0.0, "maxIter": 1000,
        "preconditioner": {"preconditioner": "Multigrid", "caching": 10**9},
    }
    omega_solver = foam.FoamSolver("omega", {"executor": executor, **omega_controls})
    psi_solver = foam.FoamSolver("psi", {"executor": executor, **psi_controls})

    records = []
    t0 = time.perf_counter()
    for step in range(1, steps + 1):
        m, rhs = cav.assemble_omega()
        w, perf_w = omega_solver.solve(m, rhs, psi=cav.omega.ravel())
        w = w.cpu().numpy()
        dw = np.abs(w - cav.omega.ravel()).max() / dt
        cav.omega = w.reshape(n, n)

        # ∇²ψ = −ω  (scaled by h²: the generator's unit-coefficient form)
        p, perf_p = psi_solver.solve(
            cav.a_psi, cav.h**2 * cav.omega.ravel(), psi=cav.psi.ravel())
        cav.psi = p.cpu().numpy().reshape(n, n)

        records.append({"step": step, "omega_iters": perf_w.n_iterations,
                        "psi_iters": perf_p.n_iterations, "dmax": dw})
        if verbose and (step <= 3 or step % 10 == 0):
            print(f"step {step:4d}: omega {perf_w.n_iterations:3d} iters, "
                  f"psi {perf_p.n_iterations:3d} iters, "
                  f"|dω/dt|∞ = {dw:.3e}", flush=True)
        if dw < steady_tol:
            if verbose:
                print(f"steady state at step {step} (|dω/dt|∞ < {steady_tol})")
            break
    if verbose:
        print(f"wall time {time.perf_counter() - t0:.1f}s for "
              f"{len(records)} steps at {n}x{n} (Re={re})")
    return cav, records


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--re", type=float, default=100.0)
    ap.add_argument("--dt", type=float, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--executor", default="cuda")
    args = ap.parse_args()

    cav, _ = run(args.n, args.re, args.dt, args.steps, executor=args.executor)
    psi_min = float(cav.psi.min())
    jc = args.n // 2
    u_centerline = (np.pad(cav.psi, 1)[2:, jc + 1]
                    - np.pad(cav.psi, 1)[:-2, jc + 1]) / (2 * cav.h)
    print(f"psi_min = {psi_min:.5f}  (Ghia et al. Re=100: -0.10342)")
    print(f"min u on vertical centerline = {u_centerline.min():.4f} "
          f"(Ghia: -0.2109)")
    if args.re == 100.0 and args.n >= 64:
        ok = -0.115 < psi_min < -0.085
        print("VALIDATION", "PASS" if ok else "FAIL")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
