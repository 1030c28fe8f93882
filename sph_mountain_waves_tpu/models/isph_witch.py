"""ISPH mountain-wave scheme — incompressible projection variant.

BASELINE.json names an "ISPH variant of the mountain-wave case
(pressure-Poisson CG path)" among its benchmark configs; the reference repo
has no such file, so this composes the two reference ingredients it points
at: the witch-of-Agnesi system (src/current/wcsph_perturbed_witch.jl:152-170
— geometry, hydrostatic background, Rayleigh sponge) and the projection
method of sph_jl/examples/collapse_dry_implicit.jl:9-31,147-167 (Morris
Laplacian pressure-Poisson with Lee free-surface penalty, CG solve,
pressure-corrected velocity).

Stratification is handled in the Boussinesq limit: density is frozen at the
hydrostatic background ρ_bg(y); buoyancy comes from an advected potential-
temperature perturbation b = g·θ′/θ_bg with Dθ′/Dt = −v_y·dθ_bg/dy and
dθ_bg/dy = θ_bg·N²/g, which reproduces the Brunt–Väisälä frequency N² of the
compressible schemes (witch_common.py constants, reference :49-54). The
pressure-Poisson solve is **matrix-free** (one neighbor sweep per matvec)
with jit-compiled Jacobi-preconditioned CG — the whole step is one XLA
program, zero host round-trips.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels import rDspline23
from ..ops.apply import apply_binary, apply_unary
from ..ops.solvers import assemble_matvec, pcg
from ..structs import ParticleState, ParticleSystem
from .witch_common import (
    FLUID, WitchConfig, background_pot_temperature_j, make_witch_system,
    rayleigh_damping, velocity_diagnostics,
)
from . import wcsph_perturbed_witch as _wcsph

FIELDS = {"h": 0, "x": 2, "m": 0, "v": 2, "Dv": 2, "P": 0,
          "div": 0, "L": 0, "lam": 0,
          "rho_bg": 0, "theta_bg": 0, "theta_p": 0, "type": 0,
          # solver observability (broadcast scalars, overwritten each step):
          # CG iteration count and final relative residual of the last
          # pressure solve — the reference's CG is run verbose
          # (collapse_dry_implicit.jl:222-231); exported per frame
          "cg_it": 0, "cg_res": 0}
EXPORT_VARS = ("v", "P", "theta_p", "type")


@dataclasses.dataclass(frozen=True)
class ISPHWitchConfig(WitchConfig):
    """Witch constants + projection-solver parameters
    (collapse_dry_implicit.jl:54-75 analogues)."""
    C_free: float = 10.0
    v_char: float = 50.0          # characteristic speed for the CFL dt
    mu_dyn: float = 1.8e-5        # dynamic viscosity of air
    # Production default 1e-4 (round-4): the solve controls velocity
    # divergence, and the projection's own spatial discretization error is
    # O(h²)-level — at the 208k baseline the rel-div left at tol 1e-4 is
    # ~1e-4 of the velocity scale, three orders below the rtol-1e-3
    # fidelity gates, while the solve needs 35 instead of 73 iterations
    # (round-3 measurement; the step is solver-bound).
    # Tighten to 1e-6 for solver studies; f32 stalls at ~7e-3 rel_res
    # either way (gate velocities, not P).
    cg_tol: float = 1e-4
    cg_maxiter: int = 200
    # pressure-solve preconditioner: "jacobi" | "mg" (additive two-level:
    # Galerkin coarse 9-point (2-D) / 27-point (3-D) stencil on the bucket
    # cell grid + V-cycle, ops/mg.py) | "mg_mult" (symmetrized
    # multiplicative, 2 extra matvecs per iteration). mg requires the
    # bucket layout (flat engines warn + fall back to Jacobi).
    precond: str = "mg"

    @property
    def dt_isph(self) -> float:
        return 0.1 * self.h0 / self.v_char


def make_system(cfg: ISPHWitchConfig) -> ParticleSystem:
    return make_witch_system(cfg, FIELDS)


def make_step(cfg: ISPHWitchConfig, engine):
    if (cfg.precond.startswith("mg")
            and getattr(engine, "layout", "flat") != "bucket"):
        # No silent degradation (advisor rounds 3-4): the two-level
        # preconditioner needs the bucket cell grid (ops/mg.py
        # coarse_stencil_2d/_3d — round 5 added the 27-tap 3-D stencil);
        # on flat engines the solve falls back to Jacobi and iteration
        # counts return to round-3 levels (73 vs 35 at the 208k witch).
        # Warn so a flat-engine benchmark doesn't read as an mg
        # regression. precond="jacobi" silences this.
        import warnings
        warnings.warn(
            f"ISPH precond={cfg.precond!r} requires a bucket engine "
            f"(got layout={getattr(engine, 'layout', 'flat')!r}); "
            f"falling back to Jacobi",
            RuntimeWarning, stacklevel=2)
    dt = cfg.dt_isph
    h = cfg.h0
    # m/ρ_bg = dr² exactly (mass init m = ρ_bg·dr², witch_common.py), so the
    # projection operator keeps the constant-coefficient Morris form of the
    # reference with m/ρ → dr²
    vol = cfg.dr**2

    def initialize(u):
        # predictor: buoyancy + sponge + drift; reset projection fields
        # (collapse_dry_implicit.jl:118-126 with gravity → buoyancy)
        fluid = (u.type == FLUID)[:, None]
        buoy = cfg.g * u.theta_p / u.theta_bg
        # true Rayleigh sponge −γ(z)·v (zero when static): the compressible
        # schemes add the reference's raw coefficient (faithful), but here
        # the projection offers no hydrostatic compensation, so the sponge
        # must vanish on the rest state
        damp = rayleigh_damping(cfg, u.x[:, 1])
        acc = jnp.stack([damp * u.v[:, 0], buoy + damp * u.v[:, 1]], axis=-1)
        v = jnp.where(fluid, u.v + dt * acc, u.v)
        return {"v": v, "x": jnp.where(fluid, u.x + dt * v, u.x),
                "div": jnp.zeros_like(u.div),
                "L": jnp.zeros_like(u.L),
                "lam": jnp.ones_like(u.lam)}

    def viscous_force(p, q, r):
        k = 2.0 * vol * cfg.mu_dyn / cfg.rho0 * rDspline23(h, r)
        return {"Dv": k[..., None] * (p.v - q.v)}  # (:128-130)

    def div_L_lambda(p, q, r):
        rDk = rDspline23(h, r)
        return {"div": -jnp.sum((p.x - q.x) * (p.v - q.v), axis=-1)
                        * p.rho_bg * vol * rDk,
                "L": -2.0 * vol * rDk,
                "lam": vol * rDk * r**2 / 2.0}  # (:147-152)

    def offdiag(p, q, r):
        return 2.0 * h**2 * vol * rDspline23(h, r)  # (:162)

    def internal_force(p, q, r):
        # pressure correction: symmetric gradient of P′/ρ_bg (:132-134)
        k = vol * rDspline23(h, r) * (p.P + q.P) / p.rho_bg
        return {"Dv": -k[..., None] * (p.x - q.x)}

    def accelerate(u):
        fluid = (u.type == FLUID)[:, None]
        return {"v": jnp.where(fluid, u.v + dt * u.Dv, u.v),
                "Dv": jnp.zeros_like(u.Dv)}

    def advect_theta(u):
        # Dθ′/Dt = −v_y·dθ_bg/dy with dθ_bg/dy = θ_bg·N²/g (Boussinesq
        # stratification carrying the witch schemes' N², :49-54)
        fluid = u.type == FLUID
        dthdy = u.theta_bg * cfg.N_bv**2 / cfg.g
        return {"theta_p": jnp.where(
            fluid, u.theta_p - dt * u.v[:, 1] * dthdy, u.theta_p),
            "theta_bg": background_pot_temperature_j(cfg, u.x[:, 1])}

    use_pallas = cfg.use_pallas and getattr(engine, "layout", "flat") == "bucket"
    if use_pallas:
        from ..ops.pallas_pairs import (
            isph_div_visc_pass, isph_grad_pass, isph_matvec_prepared)

    if (getattr(engine, "axis", None) is not None
            and not hasattr(engine, "refresh_ghost_vector")):
        # fail LOUDLY: on a sharded engine without per-iteration ghost
        # refresh, jax.scipy CG's node-local dots would silently solve a
        # block-diagonal approximation of the global Poisson system
        raise NotImplementedError(
            "sharded ISPH requires a distributed CG (psummed dots + "
            "refresh_ghost_vector); use the bucket decomposition "
            "(parallel/bucket.py), not the flat ShardEngine")

    def step(state: ParticleState) -> ParticleState:
        state = apply_unary(state, initialize)
        state, nbrs = engine.rebuild(state)
        if use_pallas:
            # one fused sweep yields the raw spline-weighted sums; the
            # p-constant physics factors of viscous_force/div_L_lambda are
            # applied here (identical algebra, hoisted out of the kernel)
            s_divv, s_L, s_lam, s_dv0, s_dv1 = isph_div_visc_pass(
                engine, state, cfg)
            f = state.fields
            act = state.active
            visc_c = 2.0 * vol * cfg.mu_dyn / cfg.rho0
            Dv = f["Dv"] + visc_c * jnp.stack([s_dv0, s_dv1], axis=-1)
            state = state.replace(
                Dv=jnp.where(act[:, None], Dv, 0.0),
                div=jnp.where(act, f["div"] - vol * f["rho_bg"] * s_divv, 0.0),
                L=jnp.where(act, f["L"] - 2.0 * vol * s_L, 0.0),
                lam=jnp.where(act, f["lam"] + 0.5 * vol * s_lam, 0.0))
        else:
            state = apply_binary(engine, state, nbrs, viscous_force)
            state = apply_binary(engine, state, nbrs, div_L_lambda)

        # pressure-Poisson: matrix-free preconditioned CG (:154-167, :223-231)
        f = state.fields
        fluid = f["type"] == FLUID
        diag = h**2 * f["L"] + jnp.where(
            fluid, cfg.C_free * jnp.maximum(f["lam"], 0.0), 0.0)
        if use_pallas:
            off_c = 2.0 * h**2 * vol
            mv_prep = isph_matvec_prepared(engine, state, cfg)
            mv_off = lambda v: off_c * mv_prep(v)
        else:
            mv_off = assemble_matvec(engine, state, nbrs, offdiag,
                                     include_self=False)

        diag_safe = jnp.where(jnp.abs(diag) > 1e-30, diag, 1.0)
        refresh = getattr(engine, "refresh_ghost_vector", None)
        if refresh is not None:
            # inside shard_map: the global SPD system is distributed over
            # slab devices. CG vectors live on OWNED slots only (zero
            # elsewhere, so psummed dots count each entry once); the matvec
            # refreshes the iterate's ghost copies each application (the
            # rebuild-time ghost refresh is stale for a changing iterate).
            owned = jnp.asarray(engine.owned_flat) & state.active

            def matvec(v):
                out = mv_off(refresh(v)) + diag * v
                return jnp.where(owned, out, 0.0)

            M = lambda v: v / diag_safe
            if (cfg.precond.startswith("mg")
                    and getattr(engine, "layout", "flat") == "bucket"):
                # per-slab additive Schwarz with the local coarse grid
                # (ghost cells = overlap); collective-free, SPD — the
                # distributed flavor of the single-device two-level M
                from ..ops.mg import two_level_preconditioner
                M = two_level_preconditioner(
                    engine, state,
                    lambda r: 2.0 * h**2 * vol * rDspline23(h, r),
                    jnp.where(state.active, diag, 0.0), matvec, diag_safe,
                    mode="add", mask=owned)
            b = jnp.where(owned, -h**2 * f["div"] / dt, 0.0)
            P, cg_it, cg_res = pcg(
                matvec, b, x0=jnp.where(owned, f["P"], 0.0),
                M=M, tol=cfg.cg_tol,
                maxiter=cfg.cg_maxiter, axis=engine.axis, return_info=True)
            # the pressure-gradient sweep below reads ghost P
            P = refresh(jnp.where(owned, P, 0.0))
        else:
            def matvec(v):
                return mv_off(v) + jnp.where(state.active, diag * v, 0.0)

            M = lambda v: v / diag_safe
            if (cfg.precond.startswith("mg")
                    and getattr(engine, "layout", "flat") == "bucket"):
                from ..ops.mg import two_level_preconditioner
                M = two_level_preconditioner(
                    engine, state,
                    lambda r: 2.0 * h**2 * vol * rDspline23(h, r),
                    jnp.where(state.active, diag, 0.0), matvec, diag_safe,
                    mode="mult" if cfg.precond == "mg_mult" else "add")
            b = jnp.where(state.active, -h**2 * f["div"] / dt, 0.0)
            # atol>0: on an exactly-static state div (and so b) is exactly 0
            # and the default atol=0 criterion can never be met — CG then
            # iterates on a zero residual (0/0 step sizes) and returns
            # noise-amplified junk pressure instead of the exact solution
            # P=0. Any physical RHS is astronomically above this floor, so
            # tol governs real solves.
            P, cg_it, cg_res = pcg(
                matvec, b, x0=f["P"], M=M,
                tol=cfg.cg_tol, atol=1e-18, maxiter=cfg.cg_maxiter,
                return_info=True)
        state = state.replace(
            P=jnp.where(state.active, P, 0.0),
            cg_it=jnp.full_like(f["cg_it"], cg_it),
            cg_res=jnp.full_like(f["cg_res"], cg_res))

        if use_pallas:
            s0, s1 = isph_grad_pass(engine, state, cfg)
            f = state.fields
            gk = vol / jnp.maximum(f["rho_bg"], 1e-6)
            Dv = f["Dv"] - gk[:, None] * jnp.stack([s0, s1], axis=-1)
            state = state.replace(
                Dv=jnp.where(state.active[:, None], Dv, 0.0))
        else:
            state = apply_binary(engine, state, nbrs, internal_force)
        state = apply_unary(state, accelerate)
        state = apply_unary(state, advect_theta)
        return state

    return step


def baseline_config(**overrides) -> ISPHWitchConfig:
    """BASELINE.json config #4 sizing: 'ISPH variant of mountain-wave case
    (pressure-Poisson CG path), ~200k particles', in the production
    layout (bucket-resident + Pallas fused sweeps + lattice-aligned cells)."""
    n_rows = max(8, int(round(math.sqrt(2e5 / (400e3 / 26e3) / 1.0746))))
    kw = dict(n_rows=n_rows, dtype="float32", self_density=True,
              layout="bucket", skin=0.15, use_pallas=True,
              lattice_cells=True)
    kw.update(overrides)
    return ISPHWitchConfig(**kw)


def run(cfg: ISPHWitchConfig | None = None, out_path: str | None = None,
        verbose: bool = False):
    cfg = cfg or ISPHWitchConfig()
    # reuse the witch main() skeleton; frame cadence from the ISPH dt
    cfg_frames = dataclasses.replace(cfg)
    return _run(cfg_frames, out_path, verbose)


def _run(cfg, out_path, verbose):
    from ..io import new_pvd_file, save_frame, save_pvd_file
    from .common import frame_runner, maybe_checkpoint, maybe_resume

    sys = make_system(cfg)
    state = sys.freeze()
    state, k0 = maybe_resume(cfg, state)  # bitwise restart (SURVEY §5)
    step = make_step(cfg, sys.engine)

    n_steps = max(1, int(round(cfg.t_end / cfg.dt_isph)))
    steps_per_frame = max(1, n_steps // max(cfg.n_frames, 1))
    run_frame = frame_runner(step, steps_per_frame)
    diag = jax.jit(velocity_diagnostics)

    out = new_pvd_file(out_path, resume=k0 > 0) if out_path else None
    if out and not k0:
        save_frame(out, state, *EXPORT_VARS, time=0.0)
    ts, u_avgs, u_maxs = [], [], []
    cg_its, cg_ress = [], []
    k, frame = k0, 0
    while k < n_steps:
        state = run_frame(state)
        k += steps_per_frame
        frame += 1
        t = k * cfg.dt_isph
        u_avg, u_max = diag(state)
        # last step's pressure-solve stats (broadcast scalars in the state)
        cg_it = float(state.fields["cg_it"][0])
        cg_res = float(state.fields["cg_res"][0])
        ts.append(t); u_avgs.append(float(u_avg)); u_maxs.append(float(u_max))
        cg_its.append(cg_it); cg_ress.append(cg_res)
        if verbose:
            print(f"t = {t:.3f}  n = {int(state.n)}  "
                  f"u_avg = {float(u_avg):.4e}  u_max = {float(u_max):.4e}  "
                  f"cg_it = {cg_it:.0f}  cg_res = {cg_res:.2e}")
        if getattr(cfg, "live_plot", False):
            from ..utils.plots import live_plot
            live_plot({"u_max": u_maxs, "cg_it": cg_its})
        if out:
            save_frame(out, state, *EXPORT_VARS, time=t)
        maybe_checkpoint(cfg, out, state, sys.engine, k, t, frame,
                         last=k >= n_steps)
    if out:
        save_pvd_file(out)
        from ..io import save_csv
        import os as _os
        save_csv(_os.path.join(out.path, "data.csv"),
                 {"t": ts, "u_avg": u_avgs, "u_max": u_maxs,
                  "cg_it": cg_its, "cg_res": cg_ress},
                 merge_history=k0 > 0)
        from ..utils.plots import plot_velocities
        plot_velocities(out.path, ts, u_avgs, u_maxs)
    sys.state = state
    return {"t": np.asarray(ts), "u_avg": np.asarray(u_avgs),
            "u_max": np.asarray(u_maxs), "cg_it": np.asarray(cg_its),
            "cg_res": np.asarray(cg_ress), "state": state, "system": sys}
