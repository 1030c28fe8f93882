"""WCSPH mountain-wave scheme on perturbation variables.

JAX rebuild of src/current/wcsph_perturbed_witch.jl: each particle
carries background+perturbation+total triplets for (ρ, P, θ, T); density by
kernel summation with per-particle adaptive h; linear EOS on the perturbation
P′ = c²ρ′; buoyancy −g ρ′/ρ; Rayleigh sponge; momentum = symmetric
pressure-gradient on P′ + Monaghan artificial viscosity (α, β, ε form);
modified Verlet with two cell-list rebuilds per step.

Physics citations into src/current/wcsph_perturbed_witch.jl:
compute_pressure! :195-199, find_temperature!/find_pot_temp! :205-214,
density pass :220-238, buoyancy/damping :245-256,
balance_of_momentum! :261-286, move!/accelerate! :292-303,
verlet_step! :309-332, main :356-407.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels import rDwendland2, wendland2
from ..ops.apply import apply_binary, apply_unary
from ..structs import ParticleState, ParticleSystem
from .common import frame_runner, maybe_checkpoint, maybe_resume
from .witch_common import (
    FLUID, WitchConfig, background_density_j, background_pot_temperature_j,
    make_witch_system, rayleigh_damping, velocity_diagnostics,
)

FIELDS = {"h": 0, "x": 2, "m": 0, "v": 2, "Dv": 2,
          "rho_bg": 0, "rho_p": 0, "rho": 0,
          "P_bg": 0, "P_p": 0, "P": 0,
          "theta_bg": 0, "theta_p": 0, "theta": 0,
          "T_bg": 0, "T_p": 0, "T": 0, "type": 0}


def flagship_config(**overrides) -> WitchConfig:
    """The flagship sizing: n_rows=246 → N ≈ 978k particles over the
    400 km × 26 km domain, float32, bucket layout with lattice-aligned cells
    (bucket cap 8, occupancy 4), lazy diagnostics."""
    kw = dict(n_rows=246, dtype="float32", self_density=True,
              layout="bucket", skin=0.15, lattice_cells=True,
              lazy_diagnostics=True)
    kw.update(overrides)
    return WitchConfig(**kw)


def make_system(cfg: WitchConfig) -> ParticleSystem:
    # Irreducible per-step state: the step recomputes rho/rho_p/rho_bg,
    # P*/T*/theta* after every rebuild before reading them, and Dv is zero
    # at rebuild time (kick-drift-rebuild order), so bucket rescatters move
    # only these + the constant T_bg (read by find_temperature's T_p).
    return make_witch_system(
        cfg, FIELDS, persistent=("x", "v", "h", "m", "type", "T_bg"))


def compute_density(p, q, r):
    """Binary action: ρ += q.m W(p.h, r)  (:226-228)."""
    return {"rho": q.m * wendland2(p.h, r)}


def momentum_action(cfg: WitchConfig):
    """Binary action: symmetric P′ gradient + Monaghan artificial
    viscosity (balance_of_momentum!, :261-286)."""
    def balance_of_momentum(p, q, r):
        x_pq = p.x - q.x
        v_pq = p.v - q.v
        dot_pq = jnp.sum(x_pq * v_pq, axis=-1)
        h_ij = 0.5 * (p.h + q.h)
        ker = rDwendland2(h_ij, r)
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

    return balance_of_momentum


def make_step(cfg: WitchConfig, engine):
    dt = cfg.dt
    balance_of_momentum = momentum_action(cfg)

    def reset_density(u):
        return {"rho": jnp.zeros_like(u.rho), "rho_p": jnp.zeros_like(u.rho_p)}

    def finalize_density(u):
        rho_bg = background_density_j(cfg, u.x[:, 1])
        return {"rho_bg": rho_bg, "rho_p": u.rho - rho_bg}

    def update_smoothing(u):
        rho = jnp.maximum(u.rho, cfg.rho_floor)
        return {"h": cfg.eta * jnp.sqrt(u.m / rho)}  # (:235-238)

    def compute_pressure(u):
        # P_bg = R·T_bg·ρ_bg (isothermal): reuse finalize_density's fresh
        # ρ_bg instead of re-evaluating the background exp — bitwise equal
        # to background_pressure_j(cfg, y) (:195-199)
        P_bg = cfg.R_mass * cfg.T_bg * u.rho_bg
        P_p = cfg.c**2 * u.rho_p
        return {"P_bg": P_bg, "P_p": P_p, "P": P_bg + P_p}

    def find_temperature(u):
        T = u.P / (cfg.R_mass * u.rho)
        return {"T": T, "T_p": T - u.T_bg}  # (:205-208)

    def find_pot_temp(u):
        theta = u.T * ((cfg.T_bg * cfg.R_gas * cfg.rho0) / u.P) ** (2.0 / 7.0)
        theta_bg = background_pot_temperature_j(cfg, u.x[:, 1])
        return {"theta": theta, "theta_bg": theta_bg,
                "theta_p": theta - theta_bg}  # (:210-214)

    def move(u):
        fluid = (u.type == FLUID)[:, None]
        return {"x": jnp.where(fluid, u.x + dt * u.v, u.x)}  # (:292-296)

    def accelerate(u):
        # v += dt/2 (Dv + buoyancy + damping); Dv reset (:298-303)
        fluid = (u.type == FLUID)[:, None]
        buoy = -cfg.g * u.rho_p / jnp.maximum(u.rho, cfg.rho_floor)  # (:253-256)
        damp = rayleigh_damping(cfg, u.x[:, 1])
        acc_y = u.Dv[:, 1] + buoy + damp
        acc = jnp.stack([u.Dv[:, 0], acc_y], axis=-1)
        return {"v": jnp.where(fluid, u.v + 0.5 * dt * acc, u.v),
                "Dv": jnp.zeros_like(u.Dv)}

    use_pallas = cfg.use_pallas and getattr(engine, "layout", "flat") == "bucket"
    if use_pallas:
        from ..ops.pallas_pairs import density_pass, momentum_pass

    def step(state: ParticleState) -> ParticleState:
        # verlet_step! (:309-332)
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
        # The reference rebuilds the cell list again here (:320) because h
        # changed — but the engine's cell size is the fixed system radius and
        # positions are unchanged, so the rebuild is a no-op; we reuse nbrs.

        state = apply_unary(state, compute_pressure)
        if not cfg.lazy_diagnostics:
            state = apply_unary(state, find_temperature)
            state = apply_unary(state, find_pot_temp)

        if use_pallas:
            dv0, dv1 = momentum_pass(engine, state, cfg)
            Dv = state.fields["Dv"] + jnp.stack([dv0, dv1], axis=-1)
            state = state.replace(Dv=jnp.where(state.active[:, None], Dv, 0.0))
        else:
            state = apply_binary(engine, state, nbrs, balance_of_momentum)
        state = apply_unary(state, accelerate)
        return state

    return step


def make_finalize(cfg: WitchConfig):
    """Materialize the lazy diagnostics (T, θ and their perturbations) —
    applied once per frame by run loops when cfg.lazy_diagnostics."""
    def find_temperature(u):
        T = u.P / (cfg.R_mass * jnp.maximum(u.rho, cfg.rho_floor))
        return {"T": T, "T_p": T - u.T_bg}

    def find_pot_temp(u):
        theta = u.T * ((cfg.T_bg * cfg.R_gas * cfg.rho0) / jnp.maximum(
            u.P, cfg.P_floor)) ** (2.0 / 7.0)
        theta_bg = background_pot_temperature_j(cfg, u.x[:, 1])
        return {"theta": theta, "theta_bg": theta_bg,
                "theta_p": theta - theta_bg}

    def finalize(state):
        state = apply_unary(state, find_temperature)
        return apply_unary(state, find_pot_temp)

    return finalize


EXPORT_VARS = ("v", "rho", "P", "theta", "T", "type")  # (:18)


def run(cfg: WitchConfig = WitchConfig(), out_path: str | None = None,
        verbose: bool = False):
    """main() loop (:356-407): frames every t_end/n_frames with avg/max
    velocity diagnostics; PVD output of (:v, :ρ, :P, :θ, :T, :type)."""
    return _run_witch_scheme(
        cfg, make_system, make_step, EXPORT_VARS, out_path, verbose,
        finalize=make_finalize(cfg) if cfg.lazy_diagnostics else None)


def _run_witch_scheme(cfg, make_system_fn, make_step_fn, export_vars,
                      out_path=None, verbose=False, setup=None,
                      finalize=None, extra_diag=None):
    """Shared main() skeleton of all witch schemes (SURVEY §2.2).
    ``finalize`` (lazy-diagnostics schemes) runs inside the per-frame jit.
    ``extra_diag(state) -> {name: scalar}`` adds scheme-specific per-frame
    observables (e.g. the legacy terrain schemes' mountain drag/lift) to the
    time series, the CSV channel, and the returned dict."""
    from ..io import new_pvd_file, save_frame, save_pvd_file

    sys = make_system_fn(cfg)
    state = sys.freeze()
    state, k0 = maybe_resume(cfg, state)  # bitwise restart (SURVEY §5)
    if not k0 and setup is not None:
        state = setup(cfg, sys.engine, state)
    step = make_step_fn(cfg, sys.engine)

    n_steps = int(round(cfg.t_end / cfg.dt))
    steps_per_frame = max(1, int(round(cfg.t_end / cfg.n_frames / cfg.dt)))
    run_frame = frame_runner(step, steps_per_frame, finalize=finalize)
    diag = jax.jit(velocity_diagnostics)
    extra_diag_j = jax.jit(extra_diag) if extra_diag is not None else None

    out = new_pvd_file(out_path, resume=k0 > 0) if out_path else None
    if out and not k0:
        save_frame(out, state, *export_vars, time=0.0)

    ts, u_avgs, u_maxs = [], [], []
    extra_hist: dict = {}
    k, frame = k0, 0
    while k < n_steps:
        state = run_frame(state)
        k += steps_per_frame
        frame += 1
        t = k * cfg.dt
        u_avg, u_max = diag(state)
        ts.append(t); u_avgs.append(float(u_avg)); u_maxs.append(float(u_max))
        extras = {}
        if extra_diag_j is not None:
            extras = {name: float(v)
                      for name, v in extra_diag_j(state).items()}
            for name, v in extras.items():
                extra_hist.setdefault(name, []).append(v)
        if verbose:
            tail = "".join(f"  {n} = {v:.4e}" for n, v in extras.items())
            print(f"t = {t:.3f}  n = {int(state.n)}  "
                  f"u_avg = {float(u_avg):.4e}  u_max = {float(u_max):.4e}"
                  + tail)
        if getattr(cfg, "live_plot", False):
            from ..utils.plots import live_plot
            live_plot({"u_max": u_maxs,
                       **{k: v for k, v in extra_hist.items()}})
        if out:
            save_frame(out, state, *export_vars, time=t)
        maybe_checkpoint(cfg, out, state, sys.engine, k, t, frame,
                         last=k >= n_steps)
    if out:
        save_pvd_file(out)
        # reference data.csv / unicodeplots channel
        # (src/current/wcsph_perturbed_witch.jl:393-405)
        from ..io import save_csv
        save_csv(os.path.join(out.path, "data.csv"),
                 {"t": ts, "u_avg": u_avgs, "u_max": u_maxs, **extra_hist},
                 merge_history=k0 > 0)
        # the reference's two-panel velocities figure (:393-405; its
        # savefig is committed commented-out — written here so production
        # runs keep their diagnostics)
        from ..utils.plots import plot_velocities
        plot_velocities(out.path, ts, u_avgs, u_maxs)
    sys.state = state
    return {"t": np.asarray(ts), "u_avg": np.asarray(u_avgs),
            "u_max": np.asarray(u_maxs),
            **{name: np.asarray(v) for name, v in extra_hist.items()},
            "state": state, "system": sys}
