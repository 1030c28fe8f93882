"""3-D stratified mountain-wave flow (the BASELINE stretch configuration).

The reference suite is 2-D only (src/current/*.jl all use Rectangle +
hexagonal lattices); BASELINE.json's stretch config asks for a "3D
mountain-wave at 2M+ particles, domain-sharded over 8 chips". This module is
the 3-D extension of the WCSPH perturbed scheme: the same physics as
src/current/wcsph_perturbed_witch.jl (density summation :220-238, linear EOS
on the perturbation :195-199, buoyancy/Rayleigh sponge :245-256, symmetric
P' gradient + Monaghan viscosity :261-286, modified Verlet :309-332) lifted
to 3-D:

  * axes: x = along-flow (the slab-sharded axis of parallel/bucket.py),
    y = cross-flow depth, z = vertical (gravity/stratification),
  * cubic lattice, m = rho_bg * dr^3, wendland3/rDwendland3 kernels,
  * the Witch-of-Agnesi profile becomes a ridge extruded along y
    (h(x) = h_m a^2/(x^2+a^2), y-invariant), so 2-D physics cross-checks
    hold plane-by-plane,
  * the Pallas fast path reuses the dim-aware density/momentum passes
    (ops/pallas_pairs.py: 27-offset stencils, 9-row DMA windows).

The 2M-particle stretch sizing: `stretch_config()` returns n_rows=40
(dr = 650 m) with a 52 km cross-flow depth -> ~2.1M particles; shard with
parallel/bucket.make_bucket_runner over an 8-device mesh.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..geometry import BoundaryLayer, Box, Specification
from ..grids import Grid
from ..kernels import rDwendland3, wendland3
from ..ops.apply import apply_binary, apply_unary
from ..structs import ParticleState, ParticleSystem, generate_particles
from .wcsph_perturbed_witch import EXPORT_VARS, _run_witch_scheme
from .witch_common import (
    FLUID, WALL, WitchConfig, background_density, background_density_j,
    background_pot_temperature, background_pot_temperature_j,
    background_pressure, rayleigh_damping, witch_profile,
)

FIELDS = {"h": 0, "x": 3, "m": 0, "v": 3, "Dv": 3,
          "rho_bg": 0, "rho_p": 0, "rho": 0,
          "P_bg": 0, "P_p": 0, "P": 0,
          "theta_bg": 0, "theta_p": 0, "theta": 0,
          "T_bg": 0, "T_p": 0, "T": 0, "type": 0}


@dataclasses.dataclass(frozen=True)
class Witch3DConfig(WitchConfig):
    """WitchConfig constants (wcsph_perturbed_witch.jl:20-76) + the
    cross-flow extent. dr/h/dt/c derive exactly as in 2-D."""
    dom_depth: float = 56e3       # cross-flow (y) extent
    lattice: str = "cubic"
    # The cubic lattice overestimates the wendland3 kernel sum by ~11% at
    # eta=1.8 (the 2-D hexagonal lattice of the reference sums to ~1), and
    # the linear EOS P' = c^2 (rho - rho_bg) turns any summation bias into a
    # body force. setup renormalizes per-particle mass (m <- m rho_bg /
    # rho_sum, fixed-point with the adaptive h) so the initial summed
    # density IS the hydrostatic background — the 3-D analogue of the
    # reference's (disabled) packing! call (wcsph_perturbed_witch.jl:167).
    renormalize: bool = True
    renorm_iters: int = 4


def stretch_config(**overrides) -> Witch3DConfig:
    """The BASELINE stretch sizing: 2M+ fluid particles (n_rows=40 ->
    dr=650 m over 400 km x 56 km x 26 km), float32, bucket layout + Pallas,
    skin for deferred rescatters. Shard over several cards with
    parallel/bucket.py.

    lattice_cells sizes bucket cells to EXACTLY 2·dr (minus the 1e-6 edge
    nudge): every cell then holds exactly 2 cubic-lattice planes per axis
    = 8 particles, uniformly. Any other ratio aliases against the lattice
    — at skin 0.15 (cell = 2.07·dr) the ~7%/axis of cells that catch a
    3rd lattice plane produce occupancy 3^3 = 27 -> cap 40, i.e. ~5x the
    slot memory and ~2.7x the pair-sweep work of the aligned choice
    (occ 8 -> cap 16). For provably-static runs,
    bucket_cap=8 (zero headroom, overflow surfaced) halves the sweep
    again."""
    kw = dict(n_rows=40, dtype="float32", self_density=True,
              layout="bucket", skin=1.0 / 9.0, use_pallas=True,
              lattice_cells=True)
    kw.update(overrides)
    return Witch3DConfig(**kw)


def make_system(cfg: Witch3DConfig) -> ParticleSystem:
    """3-D domain + fence + mountain ridge (the 3-D lift of make_system,
    wcsph_perturbed_witch.jl:152-170; mountain particles are FLUID exactly
    as the reference generates them)."""
    grid = Grid(cfg.dr, cfg.lattice)
    domain = Box(-cfg.dom_length / 2.0, 0.0, 0.0,
                 cfg.dom_length / 2.0, cfg.dom_depth, cfg.dom_height)
    fence = BoundaryLayer(domain, grid, cfg.bc_width)
    mountain = Specification(
        domain, lambda x: x[..., 2] <= witch_profile(cfg, x[..., 0]))

    sys = ParticleSystem(fields=FIELDS, domain=domain + fence, h=cfg.h0,
                         dim=3, dtype=cfg.jdtype)
    sys.freeze_opts = {"layout": cfg.layout, "skin": cfg.skin,
                       # same irreducible-state argument as the 2-D scheme
                       # (wcsph_perturbed_witch.make_system)
                       "persistent": ("x", "v", "h", "m", "type", "T_bg")}
    if cfg.bucket_cap:
        sys.freeze_opts["cap"] = cfg.bucket_cap
    if cfg.lattice_cells:
        # cubic-lattice pitch: cells exactly 2·dr with the 1e-6 DOWNWARD
        # nudge (see WitchConfig.lattice_cells / make_witch_system): when
        # dr is not exactly representable (e.g. 26000/12), lattice points
        # sitting on bin edges otherwise flip bins per-point by float
        # rounding — measured occupancy 27 spikes and 22% overflow drops
        # at cap 8. Nudged: occupancy uniformly 8.
        sys.freeze_opts["cells"] = (2.0 * cfg.dr * (1.0 - 1e-6),) * 3
    generate_particles(sys, grid, domain - mountain, lambda xs: {"type": FLUID})
    generate_particles(sys, grid, fence, lambda xs: {"type": WALL})
    generate_particles(sys, grid, mountain, lambda xs: {"type": FLUID})

    # hydrostatic isothermal init (wcsph_perturbed_witch.jl:125-144) with
    # height = z (axis 2) and the 3-D mass element rho_bg * dr^3
    for chunk in sys._chunks:
        z = chunk["x"][:, 2]
        chunk["h"] = np.full_like(z, cfg.h0)
        rho_bg = background_density(cfg, z)
        chunk["rho_bg"] = rho_bg
        chunk["rho"] = rho_bg
        chunk["P_bg"] = background_pressure(cfg, z)
        chunk["P"] = chunk["P_bg"]
        chunk["theta_bg"] = background_pot_temperature(cfg, z)
        chunk["theta"] = chunk["theta_bg"]
        chunk["T_bg"] = np.full_like(z, cfg.T_bg)
        chunk["T"] = np.full_like(z, cfg.T_bg)
        chunk["m"] = rho_bg * cfg.dr**3
    return sys


def renormalize_mass(cfg: Witch3DConfig, engine, state: ParticleState
                     ) -> ParticleState:
    """Fixed-point mass renormalization: drive the kernel-summed initial
    density to the analytic hydrostatic background (see Witch3DConfig.
    renormalize). Also calibrates fence-edge particles whose neighborhoods
    are truncated. Converges to <0.1% in ~4 iterations."""
    import jax

    def dens(p, q, r):
        return {"rho": q.m * wendland3(p.h, r)}

    @jax.jit
    def one_iter(state):
        state, nbrs = engine.rebuild(state)
        state = state.replace(rho=jnp.zeros_like(state.fields["rho"]))
        state = apply_binary(engine, state, nbrs, dens,
                             self_interaction=cfg.self_density)
        rho_bg = background_density_j(cfg, state.fields["x"][:, 2])
        ratio = jnp.where(
            state.active,
            rho_bg / jnp.maximum(state.fields["rho"], cfg.rho_floor), 1.0)
        m = state.fields["m"] * ratio
        h = cfg.eta * jnp.cbrt(m / jnp.maximum(rho_bg, cfg.rho_floor))
        return state.replace(
            m=m, h=jnp.where(state.active, h, state.fields["h"]),
            rho=jnp.where(state.active, rho_bg, 0.0),
            rho_p=jnp.zeros_like(state.fields["rho_p"]))

    for _ in range(cfg.renorm_iters):
        state = one_iter(state)
    return state


def setup(cfg: Witch3DConfig, engine, state: ParticleState) -> ParticleState:
    if cfg.renormalize:
        state = renormalize_mass(cfg, engine, state)
    return state


def make_step(cfg: Witch3DConfig, engine):
    """One modified-Verlet step (verlet_step!, wcsph_perturbed_witch.jl
    :309-332) in 3-D; vertical physics acts on axis 2."""
    dt = cfg.dt

    def compute_density(p, q, r):
        return {"rho": q.m * wendland3(p.h, r)}  # (:226-228), 3-D kernel

    def reset_density(u):
        return {"rho": jnp.zeros_like(u.rho), "rho_p": jnp.zeros_like(u.rho_p)}

    def finalize_density(u):
        rho_bg = background_density_j(cfg, u.x[:, 2])
        return {"rho_bg": rho_bg, "rho_p": u.rho - rho_bg}

    def update_smoothing(u):
        # 3-D adaptive h: h = eta (m/rho)^(1/3) (the 3-D lift of :235-238)
        rho = jnp.maximum(u.rho, cfg.rho_floor)
        return {"h": cfg.eta * jnp.cbrt(u.m / rho)}

    def compute_pressure(u):
        # P_bg = R·T_bg·ρ_bg (isothermal): reuse finalize_density's fresh
        # ρ_bg — bitwise equal to background_pressure_j(cfg, z) (:195-199)
        P_bg = cfg.R_mass * cfg.T_bg * u.rho_bg
        P_p = cfg.c**2 * u.rho_p
        return {"P_bg": P_bg, "P_p": P_p, "P": P_bg + P_p}

    def find_temperature(u):
        T = u.P / (cfg.R_mass * jnp.maximum(u.rho, cfg.rho_floor))
        return {"T": T, "T_p": T - u.T_bg}  # (:205-208)

    def find_pot_temp(u):
        theta = u.T * ((cfg.T_bg * cfg.R_gas * cfg.rho0) / jnp.maximum(
            u.P, cfg.P_floor)) ** (2.0 / 7.0)
        theta_bg = background_pot_temperature_j(cfg, u.x[:, 2])
        return {"theta": theta, "theta_bg": theta_bg,
                "theta_p": theta - theta_bg}  # (:210-214)

    def balance_of_momentum(p, q, r):
        # symmetric P' gradient + Monaghan viscosity (:261-286), 3-D kernel
        x_pq = p.x - q.x
        v_pq = p.v - q.v
        dot_pq = jnp.sum(x_pq * v_pq, axis=-1)
        h_ij = 0.5 * (p.h + q.h)
        ker = rDwendland3(h_ij, r)
        prho = jnp.maximum(p.rho, cfg.rho_floor)
        qrho = jnp.maximum(q.rho, cfg.rho_floor)
        dv = -(q.m * (p.P_p / prho**2 + q.P_p / qrho**2) * ker)[..., None] * x_pq

        c_i = jnp.sqrt(jnp.maximum(cfg.gamma * p.P / prho, 0.0))
        c_j = jnp.sqrt(jnp.maximum(cfg.gamma * q.P / qrho, 0.0))
        c_ij = 0.5 * (c_i + c_j)
        rho_ij = 0.5 * (prho + qrho)
        mu_ij = (h_ij * dot_pq) / (r * r + cfg.eps * h_ij * h_ij)
        pi_ij = (-cfg.alpha * c_ij * mu_ij + cfg.beta * mu_ij**2) / rho_ij
        visc = jnp.where(dot_pq < 0.0, -q.m * pi_ij * ker, 0.0)
        return {"Dv": dv + visc[..., None] * x_pq}

    def move(u):
        fluid = (u.type == FLUID)[:, None]
        return {"x": jnp.where(fluid, u.x + dt * u.v, u.x)}  # (:292-296)

    def accelerate(u):
        # v += dt/2 (Dv + (buoyancy + damping) e_z); Dv reset (:298-303)
        fluid = (u.type == FLUID)[:, None]
        buoy = -cfg.g * u.rho_p / jnp.maximum(u.rho, cfg.rho_floor)
        damp = rayleigh_damping(cfg, u.x[:, 2])
        acc = u.Dv.at[:, 2].add(buoy + damp)
        return {"v": jnp.where(fluid, u.v + 0.5 * dt * acc, u.v),
                "Dv": jnp.zeros_like(u.Dv)}

    use_pallas = cfg.use_pallas and getattr(engine, "layout", "flat") == "bucket"
    if use_pallas:
        from ..ops.pallas_pairs import density_pass, momentum_pass

    def step(state: ParticleState) -> ParticleState:
        state = apply_unary(state, accelerate)
        state = apply_unary(state, move)
        state, nbrs = engine.rebuild(state)

        if use_pallas:
            rho = density_pass(engine, state, cfg)
            state = state.replace(rho=jnp.where(state.active, rho, 0.0))
        else:
            state = apply_unary(state, reset_density)
            state = apply_binary(engine, state, nbrs, compute_density,
                                 self_interaction=cfg.self_density)
        state = apply_unary(state, finalize_density)
        state = apply_unary(state, update_smoothing)

        state = apply_unary(state, compute_pressure)
        if not cfg.lazy_diagnostics:
            state = apply_unary(state, find_temperature)
            state = apply_unary(state, find_pot_temp)

        if use_pallas:
            dvs = momentum_pass(engine, state, cfg)
            Dv = state.fields["Dv"] + jnp.stack(dvs, axis=-1)
            state = state.replace(Dv=jnp.where(state.active[:, None], Dv, 0.0))
        else:
            state = apply_binary(engine, state, nbrs, balance_of_momentum)
        state = apply_unary(state, accelerate)
        return state

    return step


def make_finalize(cfg: Witch3DConfig):
    """Materialize the lazy diagnostics (T, θ), vertical = z (axis 2)."""
    def find_temperature(u):
        T = u.P / (cfg.R_mass * jnp.maximum(u.rho, cfg.rho_floor))
        return {"T": T, "T_p": T - u.T_bg}

    def find_pot_temp(u):
        theta = u.T * ((cfg.T_bg * cfg.R_gas * cfg.rho0) / jnp.maximum(
            u.P, cfg.P_floor)) ** (2.0 / 7.0)
        theta_bg = background_pot_temperature_j(cfg, u.x[:, 2])
        return {"theta": theta, "theta_bg": theta_bg,
                "theta_p": theta - theta_bg}

    def finalize(state):
        state = apply_unary(state, find_temperature)
        return apply_unary(state, find_pot_temp)

    return finalize


def run(cfg: Witch3DConfig = Witch3DConfig(), out_path: str | None = None,
        verbose: bool = False):
    """main() loop (wcsph_perturbed_witch.jl:356-407) on the 3-D system."""
    return _run_witch_scheme(
        cfg, make_system, make_step, EXPORT_VARS, out_path, verbose,
        setup=setup,
        finalize=make_finalize(cfg) if cfg.lazy_diagnostics else None)
