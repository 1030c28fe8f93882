"""2-D Rayleigh-Bénard thermal convection — WCSPH + Boussinesq buoyancy.

BASELINE.json names "2D Rayleigh-Bénard thermal convection, WCSPH + buoyancy,
~50k particles" among its benchmark configs; the reference repo has no such
file, so this composes its WCSPH dam-break scheme
(sph_jl/examples/collapse_dry.jl:112-141 — continuity density, linear EOS,
symmetric pressure + viscous force, Verlet) with the thermal machinery of its
adiabatic witch schemes (src/legacy/adiabatic_static_witch.jl — per-particle
T with a conduction sweep):

  * Boussinesq buoyancy  a_y = g·β·(T − T_ref)  (gravity itself is absorbed
    into the hydrostatic reference state — no compression stratification),
  * Cleary–Monaghan conduction  DT += (2 m_q κ/(ρ_p ρ_q))·(T_p−T_q)·rDw,
  * isothermal walls: bottom T_hot, top T_cold, sides clamped to the
    conductive profile (conducting-sidewall cavity).

Dimensionless control: Ra = g β ΔT H³/(ν κ), Pr = ν/κ. Above the critical
Ra ≈ 1708 a seeded perturbation grows into convection rolls (gated in
tests/test_rayleigh_benard.py); below it the flow decays to conduction.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import BoundaryLayer, Rectangle
from ..grids import Grid
from ..kernels import rDwendland2
from ..ops.apply import apply_binary, apply_unary
from ..structs import ParticleState, ParticleSystem, generate_particles
from .common import (frame_runner, masked_mean, masked_sum, maybe_checkpoint,
                     maybe_resume)

FLUID = 0.0
WALL = 1.0        # isothermal (clamped-T) wall
WALL_ADIA = 2.0   # adiabatic (zero-flux) wall: excluded from conduction


@dataclasses.dataclass(frozen=True)
class Config:
    H: float = 1.0                 # cavity height
    aspect: float = 2.0            # width / height
    n_rows: int = 160              # fluid rows: ~160·320 ≈ 51k (BASELINE)
    rho0: float = 1000.0
    g: float = 10.0
    beta: float = 0.1              # thermal expansion coefficient
    T_hot: float = 1.0
    T_cold: float = 0.0
    Ra: float = 1.0e5
    Pr: float = 1.0
    c: float = 10.0                # artificial sound speed (≫ u_freefall)
    seed_amp: float = 1.0e-3       # initial temperature perturbation
    t_end: float = 5.0
    n_frames: int = 50
    # "conducting": sidewalls clamped to the conductive profile (default,
    # the BASELINE config). "adiabatic": zero-flux sidewalls — the
    # square-cavity configuration of the published steady Nu(Ra)
    # benchmark (Ouertatani et al. 2008), gated quantitatively in
    # tests/test_rayleigh_benard.py.
    sidewalls: str = "conducting"
    # "cleary": Brookshaw/Cleary–Monaghan pair Laplacian (the reference-
    # style form; O(h²)-consistent in the bulk only). "rkpm": quadratic-
    # consistent RKPM Laplacian (utils/rkpm.corrected_laplacian) — exact
    # on quadratic T everywhere INCLUDING the one-sided neighborhoods at
    # the plates and adiabatic sidewalls, the diagnosed source of the
    # steady-Nu deficit (VERDICT r3). XLA path only (use_pallas=False).
    conduction: str = "cleary"
    dtype: str = "float32"
    layout: str = "flat"
    skin: float = 0.0
    use_pallas: bool = False
    # exact checkpoint/resume, same contract as WitchConfig (SURVEY §5)
    checkpoint_every: int = 0
    resume: str = ""
    # per-frame terminal sparklines (unicodeplots-in-the-loop parity)
    live_plot: bool = False

    @property
    def dr(self) -> float:
        return self.H / self.n_rows

    @property
    def h(self) -> float:
        return 2.0 * self.dr

    @property
    def dT(self) -> float:
        return self.T_hot - self.T_cold

    @property
    def nu(self) -> float:
        """kinematic viscosity from (Ra, Pr): ν = √(Pr·gβΔT H³ / Ra)."""
        return float(np.sqrt(self.Pr * self.g * self.beta * self.dT
                             * self.H**3 / self.Ra))

    @property
    def kappa(self) -> float:
        return self.nu / self.Pr

    @property
    def mu(self) -> float:
        """dynamic viscosity (consumed by the shared dambreak_force_pass)."""
        return self.nu * self.rho0

    @property
    def m(self) -> float:
        return self.rho0 * self.dr**2

    @property
    def dt(self) -> float:
        visc_dt = 0.125 * self.h**2 / max(self.nu, self.kappa)
        return min(0.1 * self.h / self.c, visc_dt)

    @property
    def jdtype(self):
        return jnp.float64 if self.dtype == "float64" else jnp.float32


def conductive_T(cfg: Config, y):
    return cfg.T_hot - cfg.dT * np.clip(np.asarray(y) / cfg.H, 0.0, 1.0)


def make_system(cfg: Config) -> ParticleSystem:
    grid = Grid(cfg.dr, "square")
    box = Rectangle(0.0, 0.0, cfg.aspect * cfg.H, cfg.H)
    walls = BoundaryLayer(box, grid, 2.5 * cfg.dr)
    sys = ParticleSystem(
        fields={"x": 2, "v": 2, "Dv": 2, "rho": 0, "Drho": 0, "P": 0,
                "T": 0, "DT": 0, "type": 0},
        domain=box + walls, h=cfg.h, dim=2, dtype=cfg.jdtype,
        defaults={"rho": cfg.rho0})
    sys.freeze_opts = {"layout": cfg.layout, "skin": cfg.skin}
    generate_particles(sys, grid, box, lambda xs: {"type": FLUID})
    generate_particles(sys, grid, walls, lambda xs: {"type": WALL})
    # conductive profile + single-roll-seeding perturbation
    for chunk in sys._chunks:
        x, y = chunk["x"][:, 0], chunk["x"][:, 1]
        T = conductive_T(cfg, y)
        pert = (cfg.seed_amp * np.sin(np.pi * y / cfg.H)
                * np.cos(np.pi * x / cfg.H))
        chunk["T"] = np.where(chunk["type"] == FLUID, T + pert, T)
        if cfg.sidewalls == "adiabatic":
            # wall rows beyond the cavity's x-extent become zero-flux:
            # excluded from the conduction sweep (the top/bottom plates
            # stay clamped — they drive the instability)
            side = ((chunk["type"] == WALL)
                    & ((x < 0.0) | (x > cfg.aspect * cfg.H))
                    & (y >= 0.0) & (y <= cfg.H))
            chunk["type"] = np.where(side, WALL_ADIA, chunk["type"])
    return sys


def make_step(cfg: Config, engine):
    dt, m, c, rho0 = cfg.dt, cfg.m, cfg.c, cfg.rho0
    h = cfg.h
    mu = cfg.mu                    # dynamic viscosity
    T_ref = 0.5 * (cfg.T_hot + cfg.T_cold)

    def balance_of_mass(p, q, r):
        # continuity + δ-diffusion (collapse_dry.jl:112-115 form)
        ker = m * rDwendland2(h, r)
        return {"Drho": ker * jnp.sum((p.x - q.x) * (p.v - q.v), axis=-1)}

    def heat_conduction(p, q, r):
        # SPH Laplacian (Cleary–Monaghan with κ as thermal DIFFUSIVITY):
        # DT = κ·Σ 2 (m_q/ρ_q) (T_p − T_q) rDw  ≈ κ∇²T; rDw < 0.
        # (The conductivity form κ/(ρ_p ρ_q) with a diffusivity value
        # under-conducts by ρ0 — found by the mode-decay audit, which now
        # gates κ_eff in tests/test_rayleigh_benard.py.)
        # Adiabatic walls are zero-flux: pairs with a WALL_ADIA q exchange
        # no heat (q-side gate; the p side is already FLUID-gated)
        ker = 2.0 * m * cfg.kappa / q.rho * rDwendland2(h, r)
        fluid_p = p.type == FLUID
        conducts_q = q.type != WALL_ADIA
        return {"DT": jnp.where(fluid_p & conducts_q,
                                ker * (p.T - q.T), 0.0)}

    def find_pressure(u):
        rho = u.rho + u.Drho * dt
        fluid = u.type == FLUID
        T = jnp.where(fluid, u.T + u.DT * dt, u.T)
        return {"rho": rho, "Drho": jnp.zeros_like(rho),
                "P": c**2 * (rho - rho0),
                "T": T, "DT": jnp.zeros_like(u.DT)}

    def internal_force(p, q, r):
        ker = m * rDwendland2(h, r)
        fluid = (p.type == FLUID)
        dv = (-(ker * (p.P / p.rho**2 + q.P / q.rho**2))[..., None]
              * (p.x - q.x)
              + (2.0 * ker * mu / rho0**2)[..., None] * (p.v - q.v))
        return {"Dv": jnp.where(fluid[..., None], dv, 0.0)}

    def move(u):
        fluid = (u.type == FLUID)[:, None]
        return {"x": jnp.where(fluid, u.x + 0.5 * dt * u.v, u.x),
                "Dv": jnp.zeros_like(u.Dv)}

    def accelerate(u):
        fluid = (u.type == FLUID)[:, None]
        buoy = cfg.g * cfg.beta * (u.T - T_ref)  # Boussinesq anomaly force
        acc = u.Dv + jnp.stack([jnp.zeros_like(buoy), buoy], axis=-1)
        return {"v": jnp.where(fluid, u.v + 0.5 * dt * acc, u.v)}

    use_pallas = cfg.use_pallas and getattr(engine, "layout", "flat") == "bucket"
    if use_pallas:
        from ..ops.pallas_pairs import dambreak_force_pass, rb_mass_heat_pass
    if cfg.conduction == "rkpm":
        if use_pallas:
            raise ValueError("conduction='rkpm' runs on the XLA pair path "
                             "only (set use_pallas=False)")
        from ..utils.rkpm import corrected_laplacian

    def step(state: ParticleState) -> ParticleState:
        state = apply_unary(state, accelerate)
        state = apply_unary(state, move)
        state, nbrs = engine.rebuild(state)
        if use_pallas:
            drho, dT = rb_mass_heat_pass(engine, state, cfg)
            f = state.fields
            fluid = f["type"] == FLUID
            state = state.replace(
                Drho=jnp.where(state.active, f["Drho"] + drho, 0.0),
                DT=jnp.where(state.active & fluid, f["DT"] + dT, 0.0))
        elif cfg.conduction == "rkpm":
            state = apply_binary(engine, state, nbrs, balance_of_mass)
            f = state.fields
            # restrict BOTH the moment matrix and the sum to conducting
            # rows: the correction then adapts to the one-sided
            # neighborhood at adiabatic sidewalls and stays quadratic-
            # exact there (zero-flux wall = excluded from conduction,
            # same BC as the cleary form)
            inc = state.active & (f["type"] != WALL_ADIA)
            lap = corrected_laplacian(engine, state, nbrs, f["T"],
                                      include_q=inc,
                                      vol_of=lambda q: m / jnp.maximum(
                                          q.rho, 1e-30))
            fluid = f["type"] == FLUID
            state = state.replace(DT=jnp.where(
                state.active & fluid, f["DT"] + cfg.kappa * lap, f["DT"]))
        else:
            state = apply_binary(engine, state, nbrs, balance_of_mass)
            state = apply_binary(engine, state, nbrs, heat_conduction)
        state = apply_unary(state, find_pressure)
        state = apply_unary(state, move)
        state, nbrs = engine.rebuild(state)
        if use_pallas:
            # same fluid-gated symmetric P/ρ² + viscous sweep as the dam
            # break — shared kernel (cfg exposes m/h/mu/rho0, FLUID == 0)
            dv = dambreak_force_pass(engine, state, cfg)
            Dv = state.fields["Dv"] + jnp.stack(dv, axis=-1)
            state = state.replace(
                Dv=jnp.where(state.active[:, None], Dv, 0.0))
        else:
            state = apply_binary(engine, state, nbrs, internal_force)
        state = apply_unary(state, accelerate)
        return state

    return step


def diagnostics(cfg: Config, state: ParticleState):
    """(KE, Nu): fluid kinetic energy and a volume-averaged Nusselt number
    Nu = 1 + <v_y·T>/(κ ΔT / H) (convective heat-flux ratio; 1 = pure
    conduction)."""
    f = state.fields
    fluid = state.active & (f["type"] == FLUID)
    ke = masked_sum(0.5 * cfg.m * jnp.sum(f["v"] ** 2, axis=-1), fluid)
    conv = masked_mean(f["v"][:, 1] * (f["T"] - 0.5 * (cfg.T_hot + cfg.T_cold)),
                       fluid)
    nu_num = 1.0 + conv / (cfg.kappa * cfg.dT / cfg.H)
    return ke, nu_num


def baseline_config(**overrides) -> Config:
    """BASELINE.json config #2 sizing: '2D Rayleigh-Bénard thermal
    convection, WCSPH + buoyancy, ~50k particles' (n_rows=160 → ~51k
    fluid), in the production layout (bucket-resident + Pallas fused
    continuity+conduction sweep)."""
    kw = dict(n_rows=160, dtype="float32", layout="bucket", skin=0.15,
              use_pallas=True)
    kw.update(overrides)
    return Config(**kw)


def run(cfg: Config = Config(), out_path: str | None = None,
        verbose: bool = False):
    from ..io import new_pvd_file, save_frame, save_pvd_file

    sys = make_system(cfg)
    state = sys.freeze()
    state, k0 = maybe_resume(cfg, state)  # bitwise restart (SURVEY §5)
    step = make_step(cfg, sys.engine)
    n_steps = max(1, int(round(cfg.t_end / cfg.dt)))
    steps_per_frame = max(1, n_steps // max(cfg.n_frames, 1))
    run_frame = frame_runner(step, steps_per_frame)
    diag = jax.jit(lambda s: diagnostics(cfg, s))

    out = new_pvd_file(out_path, resume=k0 > 0) if out_path else None
    ts, KEs, Nus = [], [], []
    k, frame = k0, 0
    while k < n_steps:
        state = run_frame(state)
        k += steps_per_frame
        frame += 1
        t = k * cfg.dt
        ke, nu = diag(state)
        ts.append(t); KEs.append(float(ke)); Nus.append(float(nu))
        if verbose:
            print(f"t = {t:.3f}  KE = {float(ke):.4e}  Nu = {float(nu):.3f}  "
                  f"n = {int(state.n)}")
        if cfg.live_plot:
            from ..utils.plots import live_plot
            live_plot({"KE": KEs, "Nu": Nus})
        if out:
            save_frame(out, state, "v", "P", "T", "type", time=t)
        maybe_checkpoint(cfg, out, state, sys.engine, k, t, frame,
                         last=k >= n_steps)
    if out:
        save_pvd_file(out)
        from ..io import save_csv
        import os as _os
        save_csv(_os.path.join(out.path, "data.csv"),
                 {"t": ts, "KE": KEs, "Nu": Nus}, merge_history=k0 > 0)
        from ..utils.plots import plot_series
        plot_series(_os.path.join(out.path, "kinetic_energy.pdf"), ts,
                    {"KE": KEs}, ylabel="kinetic energy (J)")
        plot_series(_os.path.join(out.path, "nusselt.pdf"), ts,
                    {"Nu": Nus}, ylabel="Nusselt number")
    sys.state = state
    return {"t": np.asarray(ts), "KE": np.asarray(KEs), "Nu": np.asarray(Nus),
            "state": state, "system": sys}
