"""2-D WCSPH dam break ("water collapse", explicit scheme).

JAX rebuild of the reference benchmark sph_jl/examples/collapse_dry.jl
(the Violeau dam-break recomputation): continuity-equation density with
δ-diffusion, linear EOS, symmetric pressure + viscous forces, two-half-drift
pressure-stabilized Verlet, wavefront X / column height H / total energy E
observables, validated against the digitized Violeau / Koshizuka–Oka curves
(sph_jl/examples/reference/dambreak_{X,H}_*.csv).

Physics citations (all into /root/reference/sph_jl/examples/collapse_dry.jl):
constants :44-68, geometry :88-102, balance_of_mass! :112-115,
find_pressure! :123-127, internal_force! :135-141, move!/accelerate!
:148-159, energy :166-171, observables :173-187, main loop :194-230.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import BoundaryLayer, Rectangle, Specification
from ..grids import Grid
from ..kernels import rDwendland2, wendland2
from ..ops.apply import apply_binary, apply_unary
from ..structs import ParticleState, ParticleSystem, generate_particles
from .common import (frame_runner, masked_max, masked_sum, maybe_checkpoint,
                     maybe_resume)

FLUID = 0.0
WALL = 1.0


@dataclasses.dataclass(frozen=True)
class Config:
    # physical (collapse_dry.jl:44-51)
    dr: float = 1.5e-2
    rho0: float = 1000.0
    c: float = 50.0
    g: float = -7.0          # gravity y-component (g = -7*VECY, :49)
    mu: float = 8.4e-4
    nu: float = 1.0e-6
    # geometrical (:54-58)
    water_column_width: float = 1.0
    water_column_height: float = 2.0
    box_height: float = 3.0
    box_width: float = 4.0
    # temporal (:61-63)
    t_end: float = 4.0
    n_frames: int = 200
    dtype: str = "float64"
    # fast path: bucket-resident layout + Pallas pair kernel (float32)
    layout: str = "flat"
    skin: float = 0.0
    use_pallas: bool = False
    # exact checkpoint/resume, same contract as WitchConfig (SURVEY §5)
    checkpoint_every: int = 0
    # per-frame terminal sparklines (unicodeplots-in-the-loop parity)
    live_plot: bool = False
    resume: str = ""

    @property
    def h(self) -> float:
        return 3.0 * self.dr

    @property
    def m(self) -> float:
        return self.rho0 * self.dr**2

    @property
    def dt(self) -> float:
        return 0.1 * self.h / self.c

    @property
    def wall_width(self) -> float:
        return 2.5 * self.dr


def make_system(cfg: Config) -> ParticleSystem:
    """Geometry + hydrostatic init (collapse_dry.jl:88-102)."""
    grid = Grid(cfg.dr, "hexagonal")
    box = Rectangle(0.0, 0.0, cfg.box_width, cfg.box_height)
    fluid = Rectangle(0.0, 0.0, cfg.water_column_width, cfg.water_column_height)
    walls = BoundaryLayer(box, grid, cfg.wall_width)
    walls = Specification(walls, lambda x: x[..., 1] < cfg.box_height)  # no top lid

    sys = ParticleSystem(
        fields={"x": 2, "v": 2, "Dv": 2, "rho": 0, "Drho": 0, "P": 0, "type": 0},
        domain=box + walls, h=cfg.h, dim=2,
        dtype=jnp.float64 if cfg.dtype == "float64" else jnp.float32)
    sys.freeze_opts = {"layout": cfg.layout, "skin": cfg.skin}
    generate_particles(sys, grid, fluid, lambda xs: {"type": FLUID})
    generate_particles(sys, grid, walls, lambda xs: {"type": WALL})
    # hydrostatic pressure/density init (:97-100)
    for chunk in sys._chunks:
        P = cfg.rho0 * cfg.g * (chunk["x"][:, 1] - cfg.water_column_height)
        chunk["P"] = P
        chunk["rho"] = cfg.rho0 + P / cfg.c**2
    return sys


def make_step(cfg: Config, engine):
    """Build the jit-safe Verlet step (collapse_dry.jl:202-211)."""
    dt, m, c, rho0, mu, nu, g = (cfg.dt, cfg.m, cfg.c, cfg.rho0, cfg.mu,
                                 cfg.nu, cfg.g)
    h = cfg.h

    def balance_of_mass(p, q, r):
        # Drho += m rDw (x_pq·v_pq + 2 nu (rho_p - rho_q))   (:112-115)
        ker = m * rDwendland2(h, r)
        x_pq = p.x - q.x
        v_pq = p.v - q.v
        return {"Drho": ker * (jnp.sum(x_pq * v_pq, axis=-1)
                               + 2.0 * nu * (p.rho - q.rho))}

    def find_pressure(u):
        rho = u.rho + u.Drho * dt
        return {"rho": rho, "Drho": jnp.zeros_like(rho),
                "P": c**2 * (rho - rho0)}  # (:123-127)

    def internal_force(p, q, r):
        # fluid-only momentum (:135-141)
        ker = m * rDwendland2(h, r)
        x_pq = p.x - q.x
        v_pq = p.v - q.v
        fluid = (p.type == FLUID)
        dv = (-(ker * (p.P / p.rho**2 + q.P / q.rho**2))[..., None] * x_pq
              + (2.0 * ker * mu / rho0**2)[..., None] * v_pq)
        return {"Dv": jnp.where(fluid[..., None], dv, 0.0)}

    def move(u):
        # half drift + acceleration reset (:148-153)
        fluid = (u.type == FLUID)[:, None]
        return {"x": jnp.where(fluid, u.x + 0.5 * dt * u.v, u.x),
                "Dv": jnp.zeros_like(u.Dv)}

    def accelerate(u):
        fluid = (u.type == FLUID)[:, None]
        gvec = jnp.zeros_like(u.v).at[:, 1].set(g)
        return {"v": jnp.where(fluid, u.v + 0.5 * dt * (u.Dv + gvec), u.v)}

    use_pallas = cfg.use_pallas and getattr(engine, "layout", "flat") == "bucket"
    if use_pallas:
        from ..ops.pallas_pairs import dambreak_force_pass, dambreak_mass_pass

    def pallas_mass(state):
        drho = state.fields["Drho"] + dambreak_mass_pass(engine, state, cfg)
        return state.replace(Drho=jnp.where(state.active, drho, 0.0))

    def pallas_force(state):
        dv = state.fields["Dv"] + jnp.stack(
            dambreak_force_pass(engine, state, cfg), axis=-1)
        return state.replace(Dv=jnp.where(state.active[:, None], dv, 0.0))

    def step(state: ParticleState) -> ParticleState:
        state = apply_unary(state, accelerate)
        state = apply_unary(state, move)
        state, nbrs = engine.rebuild(state)
        if use_pallas:
            state = pallas_mass(state)
        else:
            state = apply_binary(engine, state, nbrs, balance_of_mass)
        state = apply_unary(state, find_pressure)
        state = apply_unary(state, move)
        state, nbrs = engine.rebuild(state)
        if use_pallas:
            state = pallas_force(state)
        else:
            state = apply_binary(engine, state, nbrs, internal_force)
        state = apply_unary(state, accelerate)
        return state

    def init_forces(state: ParticleState) -> ParticleState:
        # reference main: create_cell_list! + apply!(internal_force!) (:200-201)
        state, nbrs = engine.rebuild(state)
        if use_pallas:
            return pallas_force(state)
        return apply_binary(engine, state, nbrs, internal_force)

    return step, init_forces


def get_globals(cfg: Config, state: ParticleState):
    """(X, H, E) observables (collapse_dry.jl:166-187)."""
    f = state.fields
    act = state.active
    fluid = act & (f["type"] == FLUID)
    X = masked_max(f["x"][:, 0] / cfg.water_column_width, fluid)
    col = fluid & (f["x"][:, 0] > cfg.h) & (f["x"][:, 0] < 2.0)
    H = masked_max(f["x"][:, 1] / cfg.water_column_height, col)
    kinetic = 0.5 * cfg.m * jnp.sum(f["v"] ** 2, axis=-1)
    potential = -cfg.m * cfg.g * f["x"][:, 1]
    rho_ratio = jnp.abs(f["rho"] / cfg.rho0)
    internal = cfg.m * cfg.c**2 * (jnp.log(rho_ratio) + cfg.rho0 / f["rho"] - 1.0)
    E = masked_sum(kinetic + potential + internal, act)
    return X, H, E


def run(cfg: Config = Config(), out_path: str | None = None, verbose: bool = False):
    """Full simulation (collapse_dry.jl main, :194-230). Returns a dict of
    time series: t (scaled by sqrt(-2g), :221), X, H, E."""
    from ..io import new_pvd_file, save_frame, save_pvd_file

    sys = make_system(cfg)
    state = sys.freeze()
    step, init_forces = make_step(cfg, sys.engine)

    n_steps = int(round(cfg.t_end / cfg.dt))
    steps_per_frame = max(1, int(round(cfg.t_end / cfg.n_frames / cfg.dt)))
    run_frame = frame_runner(step, steps_per_frame)

    # bitwise restart (SURVEY §5); the checkpointed state is post-
    # init_forces, so the half-kick bootstrap must not re-run on resume
    state, k0 = maybe_resume(cfg, state)
    if not k0:
        state = jax.jit(init_forces, donate_argnums=0)(state)
    out = new_pvd_file(out_path, resume=k0 > 0) if out_path else None

    ts, Xs, Hs, Es = [], [], [], []
    if not k0:
        ts.append(0.0)
        X, H, E = get_globals(cfg, state)
        Xs.append(float(X)); Hs.append(float(H)); Es.append(float(E))
        if out:
            save_frame(out, state, "v", "P", "type", time=0.0)

    k, frame = k0, 0
    while k < n_steps:
        state = run_frame(state)
        k += steps_per_frame
        frame += 1
        t = k * cfg.dt
        X, H, E = get_globals(cfg, state)
        ts.append(t * np.sqrt(-2.0 * cfg.g))
        Xs.append(float(X)); Hs.append(float(H)); Es.append(float(E))
        if verbose:
            print(f"t = {t:.4f} s  X = {float(X):.3f}  H = {float(H):.3f}  "
                  f"E = {float(E):.6e}")
        if cfg.live_plot:
            from ..utils.plots import live_plot
            live_plot({"X": Xs, "H": Hs})
        if out:
            save_frame(out, state, "v", "P", "type", time=t)
        maybe_checkpoint(cfg, out, state, sys.engine, k, t, frame,
                         last=k >= n_steps)
    if out:
        save_pvd_file(out)
        # the reference persists the observables as data.csv next to the
        # Paraview output (collapse_dry.jl:226-227)
        from ..io import save_csv
        import os as _os
        save_csv(_os.path.join(out.path, "data.csv"),
                 {"t": ts[: len(Xs)], "X": Xs, "H": Hs, "E": Es},
                 merge_history=k0 > 0)
        # ... and the make_plot() figures (:232-247): computed X(t)/H(t)
        # with the Violeau / Koshizuka–Oka reference points
        from ..utils.plots import plot_dambreak
        plot_dambreak(out.path, ts[: len(Xs)], Xs, Hs)
    sys.state = state  # earlier buffers were donated to the jitted frames
    return {"t": np.asarray(ts[: len(Xs)]), "X": np.asarray(Xs),
            "H": np.asarray(Hs), "E": np.asarray(Es), "state": state,
            "system": sys}
