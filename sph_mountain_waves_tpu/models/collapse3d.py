"""3-D WCSPH dam break.

Rebuild of sph_jl/examples/collapse3d.jl: the dam-break scheme in 3-D with
wendland3, a cubic lattice and Box geometry (:70-104). Exercises the 27-cell
stencil path of the engine.

Citations: constants :18-39, struct :49-64, geometry :70-86,
interactions :92-116, move/accelerate :118-130, energy :132-137,
main :141-155.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..geometry import Box, BoundaryLayer, Specification, boundarybox
from ..grids import Grid
from ..kernels import rDwendland3
from ..ops.apply import apply_binary, apply_unary
from ..structs import ParticleState, ParticleSystem, generate_particles
from .common import frame_runner, masked_sum

FLUID = 0.0
WALL = 1.0


@dataclasses.dataclass(frozen=True)
class Config:
    dr: float = 5.0e-3
    rho0: float = 1000.0
    c: float = 50.0
    g: float = -9.8            # along z (g = -9.8*VECZ, :24)
    mu: float = 8.4e-4
    nu: float = 1.0e-4
    water_column_width: float = 0.142
    water_column_height: float = 0.293
    box_height: float = 0.35
    box_width: float = 0.584
    box_depth: float = 0.15
    t_end: float = 0.5
    n_frames: int = 200
    dtype: str = "float64"
    # fast path: bucket-resident layout + 27-offset Pallas pair kernel
    # (requires float32; validated against the XLA path in tests/test_pallas.py)
    layout: str = "flat"
    skin: float = 0.0
    use_pallas: bool = False

    @property
    def h(self) -> float:
        return 2.0 * self.dr

    @property
    def m(self) -> float:
        return self.rho0 * self.dr**3

    @property
    def dt(self) -> float:
        return 0.1 * self.h / self.c

    @property
    def wall_width(self) -> float:
        return 2.5 * self.dr

    @property
    def jdtype(self):
        return jnp.float64 if self.dtype == "float64" else jnp.float32


def make_system(cfg: Config) -> ParticleSystem:
    grid = Grid(cfg.dr, "cubic")
    box = Box(0.0, 0.0, 0.0, cfg.box_width, cfg.box_height, cfg.box_depth)
    fluid = Box(0.0, 0.0, 0.0, cfg.water_column_width,
                cfg.water_column_height, cfg.box_depth)
    walls = Specification(BoundaryLayer(box, grid, cfg.wall_width),
                          lambda x: x[..., 1] < cfg.box_height)
    domain = boundarybox(walls)  # (:75)
    sys = ParticleSystem(
        fields={"x": 3, "v": 3, "a": 3, "P": 0, "rho": 0, "Drho": 0, "type": 0},
        domain=domain, h=cfg.h, dim=3, dtype=cfg.jdtype,
        defaults={"rho": cfg.rho0})
    sys.freeze_opts = {"layout": cfg.layout, "skin": cfg.skin}
    generate_particles(sys, grid, fluid, lambda xs: {"type": FLUID})
    generate_particles(sys, grid, walls, lambda xs: {"type": WALL})
    return sys


def make_step(cfg: Config, engine):
    dt, m, c, rho0 = cfg.dt, cfg.m, cfg.c, cfg.rho0
    h = cfg.h

    def balance_of_mass(p, q, r):
        ker = m * rDwendland3(h, r)
        return {"Drho": ker * (jnp.sum((p.x - q.x) * (p.v - q.v), axis=-1)
                               + 2 * cfg.nu * (p.rho - q.rho))}

    def find_pressure(u):
        rho = u.rho + u.Drho * dt
        return {"rho": rho, "Drho": jnp.zeros_like(rho),
                "P": c**2 * (rho - rho0)}

    def internal_force(p, q, r):
        # The reference writes p.P/rho + q.P/rho with `rho` an UNDEFINED
        # global (collapse3d.jl:101 — UndefVarError as committed; :122 also
        # reads a nonexistent p.rho0 field). We use the standard symmetric
        # form P/ρ² of the 2-D example (collapse_dry.jl:135-141).
        ker = m * rDwendland3(h, r)
        fluid = (p.type == FLUID)
        a = (-(ker * (p.P / p.rho**2 + q.P / q.rho**2))[..., None] * (p.x - q.x)
             + (2 * ker * cfg.mu / rho0**2)[..., None] * (p.v - q.v))
        return {"a": jnp.where(fluid[..., None], a, 0.0)}

    def move(u):
        fluid = (u.type == FLUID)[:, None]
        return {"x": jnp.where(fluid, u.x + dt * u.v, u.x),
                "a": jnp.zeros_like(u.a)}

    def accelerate(u):
        fluid = (u.type == FLUID)[:, None]
        gvec = jnp.zeros_like(u.v).at[:, 2].set(cfg.g)
        return {"v": jnp.where(fluid, u.v + 0.5 * dt * (u.a + gvec), u.v)}

    use_pallas = cfg.use_pallas and getattr(engine, "layout", "flat") == "bucket"
    if use_pallas:
        from ..ops.pallas_pairs import dambreak_force_pass, dambreak_mass_pass

    def step(state: ParticleState) -> ParticleState:
        state = apply_unary(state, move)
        state, nbrs = engine.rebuild(state)
        if use_pallas:
            drho = state.fields["Drho"] + dambreak_mass_pass(engine, state, cfg)
            state = state.replace(Drho=jnp.where(state.active, drho, 0.0))
        else:
            state = apply_binary(engine, state, nbrs, balance_of_mass)
        state = apply_unary(state, find_pressure)
        if use_pallas:
            acc = state.fields["a"] + jnp.stack(
                dambreak_force_pass(engine, state, cfg), axis=-1)
            state = state.replace(a=jnp.where(state.active[:, None], acc, 0.0))
        else:
            state = apply_binary(engine, state, nbrs, internal_force)
        state = apply_unary(state, accelerate)
        state = apply_unary(state, accelerate)  # (:143-153: two accelerates)
        return state

    return step


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
    Es = []
    k = 0
    while k < n_steps:
        state = run_frame(state)
        k += steps_per_frame
        f = state.fields
        kinetic = 0.5 * cfg.m * jnp.sum(f["v"] ** 2, axis=-1)
        potential = -cfg.m * cfg.g * f["x"][:, 2]
        E = float(masked_sum(kinetic + potential, state.active))
        Es.append(E)
        if verbose:
            print(f"t = {k * cfg.dt:.5f}  E = {E:.6e}  n = {int(state.n)}")
        if out:
            save_frame(out, state, "v", "P", "rho", "type", time=k * cfg.dt)
    if out:
        save_pvd_file(out)
    sys.state = state
    return {"E": np.asarray(Es), "state": state, "system": sys}
