"""Incompressible SPH (ISPH) dam break — projection method.

Rebuild of sph_jl/examples/collapse_dry_implicit.jl: predictor step with
gravity + viscosity, then a pressure-Poisson solve with the Morris Laplacian,
Lee (2008) free-surface detection λ = 1 − (1/d)∇·r with penalty
C_free·max(λ,0) on the diagonal (math :9-31, stencils :147-163), and a
pressure-corrected velocity update.

Difference from the reference: it assembles an explicit sparse matrix and
calls IterativeSolvers.cg (:222-231); here the operator is **matrix-free** —
one neighbor sweep per matvec — solved by jit-compiled CG with a Jacobi
preconditioner, the whole step inside jit (SURVEY §3.4 rebuild note).

Citations: constants :49-75, particle struct :86-95, geometry :100-112,
initialize!/viscous/internal/accelerate :118-141, div_L_lambda!
/projection_matrix/projection_vector :147-167, observables :174-194,
main :199-240.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import BoundaryLayer, Rectangle, Specification
from ..grids import Grid
from ..kernels import rDspline23
from ..ops.apply import apply_binary, apply_unary
from ..ops.solvers import assemble_matvec
from ..structs import ParticleState, ParticleSystem, generate_particles
from .common import frame_runner, masked_max, masked_sum

FLUID = 0.0
WALL = 1.0
DUMMY = 2.0


@dataclasses.dataclass(frozen=True)
class Config:
    # constants (collapse_dry_implicit.jl:54-75)
    dim: int = 2
    dr: float = 1.0e-2
    rho: float = 1000.0
    g: float = -9.8
    mu: float = 8.4e-4
    C_free: float = 10.0
    v_char: float = 5.0
    water_column_width: float = 1.0
    water_column_height: float = 2.0
    box_height: float = 3.0
    box_width: float = 4.0
    nlayers: float = 3.5
    t_end: float = 2.0
    n_frames: int = 200
    cg_tol: float = 1e-6
    cg_maxiter: int = 200
    dtype: str = "float64"

    @property
    def h(self) -> float:
        return 2.8 * self.dr

    @property
    def m(self) -> float:
        return self.dr**self.dim * self.rho

    @property
    def dt(self) -> float:
        return 0.1 * self.h / self.v_char

    @property
    def jdtype(self):
        return jnp.float64 if self.dtype == "float64" else jnp.float32


def make_system(cfg: Config) -> ParticleSystem:
    """Geometry with WALL + DUMMY layers (:100-112)."""
    grid = Grid(cfg.dr, "hexagonal")
    box = Rectangle(0.0, 0.0, cfg.box_width, cfg.box_height)
    fluid = Rectangle(0.0, 0.0, cfg.water_column_width, cfg.water_column_height)
    walls = Specification(BoundaryLayer(box, grid, 1.2 * cfg.dr),
                          lambda x: x[..., 1] < cfg.box_height)
    dummy = Specification(BoundaryLayer(box, grid, cfg.nlayers * cfg.dr) - walls,
                          lambda x: x[..., 1] < cfg.box_height)
    sys = ParticleSystem(
        fields={"x": 2, "v": 2, "Dv": 2, "P": 0, "div": 0, "L": 0,
                "lam": 0, "type": 0},
        domain=fluid + dummy + walls, h=cfg.h, dim=2, dtype=cfg.jdtype)
    generate_particles(sys, grid, fluid, lambda xs: {"type": FLUID})
    generate_particles(sys, grid, walls, lambda xs: {"type": WALL})
    generate_particles(sys, grid, dummy, lambda xs: {"type": DUMMY})
    return sys


def make_step(cfg: Config, engine):
    dt, m, rho, h, mu = cfg.dt, cfg.m, cfg.rho, cfg.h, cfg.mu

    def initialize(u):
        # predictor drift + gravity; reset projection fields (:118-126)
        fluid = (u.type == FLUID)[:, None]
        gvec = jnp.zeros_like(u.v).at[:, 1].set(cfg.g)
        return {"x": jnp.where(fluid, u.x + dt * u.v, u.x),
                "v": jnp.where(fluid, u.v + dt * gvec, u.v),
                "div": jnp.zeros_like(u.div),
                "L": jnp.zeros_like(u.L),
                "lam": jnp.ones_like(u.lam)}

    def viscous_force(p, q, r):
        k = 2.0 * m * mu * rDspline23(h, r) / rho**2
        return {"Dv": k[..., None] * (p.v - q.v)}  # (:128-130)

    def div_L_lambda(p, q, r):
        rDk = rDspline23(h, r)
        return {"div": -jnp.sum((p.x - q.x) * (p.v - q.v), axis=-1) * m * rDk,
                "L": -2.0 * m / rho * rDk,
                "lam": m / rho * rDk * r**2 / cfg.dim}  # (:147-152)

    def offdiag(p, q, r):
        return 2.0 * h**2 * m / rho * rDspline23(h, r)  # (:162)

    def internal_force(p, q, r):
        k = m * rDspline23(h, r) * (p.P + q.P) / rho**2
        return {"Dv": -k[..., None] * (p.x - q.x)}  # (:132-134)

    def accelerate(u):
        fluid = (u.type == FLUID)[:, None]
        return {"v": jnp.where(fluid, u.v + dt * u.Dv, u.v),
                "Dv": jnp.zeros_like(u.Dv)}

    def step(state: ParticleState) -> ParticleState:
        state = apply_unary(state, initialize)
        state, nbrs = engine.rebuild(state)
        state = apply_binary(engine, state, nbrs, viscous_force)
        state = apply_binary(engine, state, nbrs, div_L_lambda)

        # pressure-Poisson: matrix-free preconditioned CG (:154-167, :223-231)
        f = state.fields
        fluid = f["type"] == FLUID
        diag = h**2 * f["L"] + jnp.where(
            fluid, cfg.C_free * jnp.maximum(f["lam"], 0.0), 0.0)
        mv_off = assemble_matvec(engine, state, nbrs, offdiag,
                                 include_self=False)

        def matvec(v):
            return mv_off(v) + jnp.where(state.active, diag * v, 0.0)

        b = jnp.where(state.active, -h**2 * f["div"] / dt, 0.0)
        diag_safe = jnp.where(jnp.abs(diag) > 1e-30, diag, 1.0)
        # atol>0: zero-RHS guard, see isph_witch.py (same degenerate-CG trap)
        P, _ = jax.scipy.sparse.linalg.cg(
            matvec, b, x0=f["P"], M=lambda v: v / diag_safe,
            tol=cfg.cg_tol, atol=1e-18, maxiter=cfg.cg_maxiter)
        state = state.replace(P=jnp.where(state.active, P, 0.0))

        state = apply_binary(engine, state, nbrs, internal_force)
        state = apply_unary(state, accelerate)
        return state

    return step


def get_globals(cfg: Config, state: ParticleState):
    """(X, H, E) observables (:174-194)."""
    f = state.fields
    act = state.active
    fluid = act & (f["type"] == FLUID)
    X = masked_max(f["x"][:, 0] / cfg.water_column_width, fluid)
    col = fluid & (f["x"][:, 0] > cfg.h) & (f["x"][:, 0] < 2.0)
    H = masked_max(f["x"][:, 1] / cfg.water_column_height, col)
    kinetic = 0.5 * cfg.m * jnp.sum(f["v"] ** 2, axis=-1)
    potential = -cfg.m * cfg.g * f["x"][:, 1]
    E = masked_sum(kinetic + potential, act)
    return X, H, E


def run(cfg: Config = Config(), out_path: str | None = None,
        verbose: bool = False):
    from ..io import new_pvd_file, save_frame, save_pvd_file

    sys = make_system(cfg)
    state = sys.freeze()
    step = make_step(cfg, sys.engine)
    n_steps = int(round(cfg.t_end / cfg.dt))
    steps_per_frame = max(1, int(round(cfg.t_end / cfg.n_frames / cfg.dt)))
    run_frame = frame_runner(step, steps_per_frame)

    out = new_pvd_file(out_path) if out_path else None
    ts, Xs, Hs, Es = [], [], [], []
    k = 0
    while k < n_steps:
        state = run_frame(state)
        k += steps_per_frame
        t = k * cfg.dt
        X, H, E = get_globals(cfg, state)
        ts.append(t * np.sqrt(-2.0 * cfg.g))
        Xs.append(float(X)); Hs.append(float(H)); Es.append(float(E))
        if verbose:
            print(f"t = {t:.4f}  X = {float(X):.3f}  H = {float(H):.3f}  "
                  f"E = {float(E):.5e}")
        if out:
            save_frame(out, state, "v", "P", "type", time=t)
    if out:
        save_pvd_file(out)
    sys.state = state
    return {"t": np.asarray(ts), "X": np.asarray(Xs), "H": np.asarray(Hs),
            "E": np.asarray(Es), "state": state, "system": sys}
