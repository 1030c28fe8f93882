"""Legacy mountain-wave schemes (src/legacy/).

Four schemes in two families, each with a static and a flow (open-boundary)
variant. The flow variants introduce the INFLOW/OUTFLOW/WALL/MOUNTAIN typed
open boundary: a constant U_max wind enters from the left, the inflow column
recycles (an INFLOW particle crossing the domain edge becomes FLUID and a
fresh INFLOW particle spawns one bc_width upstream,
src/legacy/isothermal_flow_witch.jl:175-186), and OUTFLOW particles are
deleted after packing (:114).

* isothermal: EOS P = ρRT at fixed T (isothermal_static_witch.jl:144-149);
  the static variant also evolves a per-particle adaptive h via
  balance_of_smoothing! (:123-125). The reference includes an unused RKPM
  kernel-correction sketch (correct_kernel, :202-210) — not ported (dead
  code, never called).
* adiabatic: entropy thermodynamics — S evolves by viscous production, s =
  S·ρ/m, T from (ρ, s), P = RρT (adiabatic_static_witch.jl:138-164).

Reference setups call the Colagrossi packing (broken as committed —
fixed version available via ``packing=True``).

Citations: isothermal_static_witch.jl:20-125,144-160,200-230;
isothermal_flow_witch.jl:20-80,96-186,200-230; adiabatic_static_witch.jl
:25-100,116-211; adiabatic_flow_witch.jl (same + inflow).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import BoundaryLayer, Rectangle, Specification
from ..grids import Grid
from ..kernels import rDwendland2, wendland2
from ..ops.apply import apply_binary, apply_unary
from ..structs import ParticleState, ParticleSystem, generate_particles
from .witch_common import witch_profile

FLUID = 0.0
INFLOW = 1.0
OUTFLOW = 2.0
WALL = 3.0
MOUNTAIN = 4.0
# static variants use WALL=1, MOUNTAIN=2 (adiabatic_static_witch.jl:61-62);
# we keep the flow numbering everywhere for a single field vocabulary.


@dataclasses.dataclass(frozen=True)
class LegacyConfig:
    """Shared constants (isothermal_static_witch.jl:24-57 /
    adiabatic_static_witch.jl:25-57)."""
    dom_height: float = 26e3
    dom_length: float = 400e3
    n_rows: int = 50
    h_m: float = 100.0
    a: float = 10e3
    bc_rows: int = 6
    rho0: float = 1.393
    mu: float = 15.98e-6
    U_max: float = 20.0          # flow variants only
    N_bv: float = float(np.sqrt(0.0196))
    g: float = 9.81
    R_mass: float = 287.05
    R_gas: float = 8.314
    T0: float = 250.0
    z_b: float = 12e3
    t_end: float = 100.0
    n_frames: int = 100
    flow: bool = False
    adiabatic: bool = False
    max_spawn: int = 256
    dtype: str = "float32"
    # exact checkpoint/resume, same contract as WitchConfig (SURVEY §5)
    checkpoint_every: int = 0
    resume: str = ""
    # frame-as-initial-condition boot (WitchConfig.init_vtp semantics)
    init_vtp: str = ""
    # per-frame terminal sparklines of the diagnostics (the reference's
    # unicodeplots-in-the-loop channel, wcsph_perturbed_witch.jl:15,393-405)
    live_plot: bool = False
    # Pallas pair-sweep kernel for the legacy pair sweeps — requires bucket
    # layout; honored like WitchConfig.use_pallas
    use_pallas: bool = False
    # engine layout (bucket = the production layout; required for Pallas
    # and for the sharded runner) — consumed by make_system's freeze_opts
    layout: str = "flat"
    skin: float = 0.15
    # Lattice-aligned bucket cells (WitchConfig.lattice_cells semantics):
    # cells sized to exact lattice-pitch multiples with the 1e-6 DOWNWARD
    # edge nudge. The flow variants seed a SQUARE lattice (pitch dr both
    # axes) → cells 2dr hold exactly 4 rows; misaligned default cells
    # (2.07·dr) alias — measured occupancy 4..9 at the terrain config →
    # cap 16 and banded trip counts, ~4x the pair-sweep work.
    lattice_cells: bool = False
    # bucket-capacity override (see WitchConfig.bucket_cap)
    bucket_cap: int | None = None
    # the legacy schemes export their diagnostics eagerly (the shared
    # sharded runner keys finalize on this flag, WitchConfig parity)
    lazy_diagnostics: bool = False
    # The reference's sponge is DEFECTIVE as committed
    # (isothermal_flow_witch.jl:192-198,213): damping_structure returns
    # γᵣ·sin²(π/2·(1−(zₜ−zᵦ)/zᵦ)) — a constant (the intended z is typo'd
    # as zᵦ) — and accelerate! subtracts it as a constant BODY FORCE, not
    # −γ·v. That ~1 m/s² force on the sponge region drives the whole
    # domain to u_avg ≈ 67 / u_max ≈ 400 m/s regardless of terrain
    # (measured). Default False = faithful. True = corrected Rayleigh
    # damping −γ(z)·v with the intended sin² ramp in z — required for any
    # quantitative wave observable (the linear drag gate uses it).
    true_rayleigh: bool = False
    # Corrected-sponge strength γ_max (s⁻¹; None = the reference's γᵣ =
    # 10·N_bv). γᵣ is ~70× the buoyancy frequency — a Rayleigh layer that
    # stiff acts as a RIGID LID (the wave meets γ ≈ N within the first
    # ~0.6 km of the 8 km ramp) and REFLECTS: the round-3 linear-drag run
    # measured the momentum flux at −D_lin (downward-radiating standing
    # component) with resonant u_max ≈ 110 m/s aloft. An absorbing sponge
    # wants γ_max ~ N/2 ramped over ≥ a vertical wavelength.
    sponge_gamma: float | None = None
    # Open right boundary. The reference deletes its OUTFLOW region at
    # init and never re-creates it (isothermal_flow_witch.jl:114), so the
    # rightmost fluid column has one-sided kernel support — a sustained
    # ~O(P/(ρh)) spurious edge acceleration that evacuates columns and
    # sends a disturbance left at ~c (the reference outruns it with
    # t_end=200 s in a 100 km domain; measured here: u_avg ~ 40 m/s once
    # it arrives). With outflow_buffer = w > 0 (meters, use ≥ 2·h0),
    # FLUID entering the last w of the domain converts to OUTFLOW:
    # force-frozen (accelerate skips it), still advected at its frozen
    # velocity, still a neighbor (kernel support for the interior), and
    # deleted once it leaves the grid — the reference's own OUTFLOW type
    # made into a working open boundary. 0 = off (faithful).
    outflow_buffer: float = 0.0
    # The reference's adiabatic entropy INIT is inconsistent with its own
    # EOS (adiabatic_static_witch.jl:85 vs :146): S = m·cv·ln(cv·T0·(γ−1)
    # /(γ·ρ^(γ−1))) recovers T(ρ,s) = T0/γ = 178.6 K, not T0 = 250 K —
    # every adiabatic run boots 29% below hydrostatic pressure and the
    # atmosphere collapses (measured: u_avg > 30 m/s within 15 s).
    # consistent_entropy=True drops the stray γ so T(ρ_init,s_init) = T0
    # exactly. Default False = faithful.
    consistent_entropy: bool = False
    # Monaghan artificial viscosity (α, β=2α, ε=0.01 form — the same
    # closure the current/ witch schemes carry, witch_common.py
    # monaghan_viscosity) added to internal_force. The legacy schemes have
    # NO AV as committed (only physical μ = 1.6e-5 Pa·s), so an impulsive
    # start leaves lattice-scale eddies (u′ ~ 100 m/s) that the floor
    # regenerates continuously — per-frame wave-flux noise σ ≈ 2.6·D_lin
    # at the linear-drag config (round 3). AV damping scales as
    # ν_AV·k² with ν_AV ≈ α·c·h0/8: lattice noise (k ~ π/dr) dies in
    # seconds at α = 0.02–0.05 while the mountain wave (k_z = N/U, λ_z ≫
    # h0) loses only ~e^(−ν k_z² z/c_gz) over its climb to the flux bands
    # — choose α from that separation. 0 = off (faithful). Applied to
    # FLUID–FLUID pairs ONLY (free-slip floor): ungated AV acts on the
    # always-approaching fluid↔MOUNTAIN floor pairs as a no-slip drag
    # that shields the ridge (measured round 4: ungated α=0.05 gave
    # u_avg 19.4 < U and flux −0.10·D_lin; the gate preserves AV's
    # noise win, σ 2.6→0.4·D_lin per frame).
    av_alpha: float = 0.0
    # Smooth analytic floor (round-4). The frozen MOUNTAIN/ground lattice
    # exerts a streamwise "washboard" pressure force on the sliding fluid
    # (~650× the linear wave drag at hₘ=300 m) that continuously
    # regenerates lattice-scale turbulence — AV cannot remove it without
    # damping the wave source (measured, BENCHMARKS.md round-4 campaign).
    # lj_floor=True removes the terrain PARTICLES entirely (no MOUNTAIN
    # rows, no ground fence) and replaces them with a Lennard-Jones-style
    # repulsion from the ANALYTIC witch surface y = h(x) — the same wall
    # closure the reference uses in collapse_symplectic.jl:119-122, but
    # evaluated against the smooth curve instead of particles: free-slip,
    # washboard-free, exactly the boundary condition linear wave theory
    # assumes. a_LJ = D·((r0/d)⁴ − (r0/d)²)·n̂ for the surface gap
    # d = (y − h(x))·cos θ < r0, n̂ the unit surface normal. Defaults:
    # r0 = dr, D = R·T0/dr — the acceleration that supports the full
    # hydrostatic column weight at (r0/d) ≈ 1.27, so the bottom row rides
    # at d ≈ 0.8·dr (ω_LJ·dt ≈ 0.08 at the linear-drag config: stable).
    # The reaction −Σ m·a_LJ is a CLEAN surface-drag observable
    # (lj_floor_drag). Flow variants only.
    lj_floor: bool = False
    lj_r0: float | None = None
    lj_D: float | None = None
    # isothermal files use cp = 7·R_gas/2 (isothermal_static_witch.jl:43 —
    # the universal constant, unlike current/ which uses R_mass);
    # adiabatic files use cp = 7·R_mass/2 (adiabatic_static_witch.jl:50)

    @property
    def dr(self) -> float:
        return self.dom_height / self.n_rows

    @property
    def h0(self) -> float:
        return 1.8 * self.dr

    @property
    def bc_width(self) -> float:
        return self.bc_rows * self.dr

    @property
    def c(self) -> float:
        return float(np.sqrt(65e3 * 1.4 / self.rho0))

    @property
    def cp(self) -> float:
        return 7 * (self.R_mass if self.adiabatic else self.R_gas) / 2

    @property
    def cv(self) -> float:
        return self.cp - self.R_mass

    @property
    def gamma(self) -> float:
        return self.cp / self.cv

    @property
    def gamma_r(self) -> float:
        return 10 * self.N_bv

    @property
    def c_av(self) -> float:
        """Signal speed for the av_alpha Monaghan viscosity: the scheme's
        EOS sound speed at the background temperature (isothermal
        c² = R·T0, adiabatic c² = γ·R·T0) — a compile-time constant, so
        the Pallas kernels don't stream a per-particle c."""
        fac = self.gamma if self.adiabatic else 1.0
        return float(np.sqrt(fac * self.R_mass * self.T0))

    @property
    def z_t(self) -> float:
        return self.dom_height

    @property
    def dt(self) -> float:
        return 0.01 * self.h0 / self.c

    @property
    def jdtype(self):
        return jnp.float64 if self.dtype == "float64" else jnp.float32

    @property
    def witch(self):
        from .witch_common import WitchConfig
        # reuse witch_common helpers expecting a WitchConfig-shaped object
        return WitchConfig(dom_height=self.dom_height,
                           dom_length=self.dom_length, n_rows=self.n_rows,
                           h_m=self.h_m, a=self.a, rho0=self.rho0,
                           T_bg=self.T0, dtype=self.dtype)


FIELDS = {"x": 2, "m": 0, "v": 2, "Dv": 2, "h": 0, "Dh": 0, "rho": 0,
          "Drho": 0, "P": 0, "theta": 0, "S": 0, "s": 0, "T": 0,
          "gGamma": 2, "type": 0}


def make_system(cfg: LegacyConfig) -> ParticleSystem:
    grid = Grid(cfg.dr, "hexagonal" if not cfg.flow else "square")
    domain = Rectangle(-cfg.dom_length / 2, 0.0, cfg.dom_length / 2,
                       cfg.dom_height)
    fence = BoundaryLayer(domain, grid, cfg.bc_width)
    mountain = Specification(
        domain, lambda x: x[..., 1] <= witch_profile(cfg.witch, x[..., 0]))

    fields = dict(FIELDS)
    if cfg.flow:
        # slot-bound spawn-drop accumulator (advisor round-3 finding):
        # "_"-prefixed = preserved in place by every rescatter flavor
        # (ops/neighbors._is_bookkeeping); read via global sum only
        fields["_spawn_drops"] = 0
    sys = ParticleSystem(fields=fields, domain=domain + fence, h=cfg.h0,
                         dim=2, dtype=cfg.jdtype)
    imported: set = set()
    if cfg.init_vtp:
        # frame-as-initial-condition boot (src/IO.jl:83-122 restart idiom);
        # missing fields are rebuilt from the background at saved positions
        from ..io import import_particles, read_vtp
        imported = set(read_vtp(cfg.init_vtp)[1])
        import_particles(sys, cfg.init_vtp)
    else:
        gen = partial(generate_particles, sys, grid)
        if cfg.lj_floor:
            # smooth analytic floor: NO terrain/ground particles at all —
            # fluid sits on the LJ repulsion from y = h(x) (free-slip,
            # washboard-free). Seed with ~equilibrium clearance so the
            # first kick is the supporting force, not a blowup.
            assert cfg.flow, "lj_floor supports the flow variants"
            clear = 0.75 * cfg.dr
            fluid_region = Specification(
                domain, lambda x: x[..., 1]
                > witch_profile(cfg.witch, x[..., 0]) + clear)
            gen(fluid_region, lambda xs: {"type": FLUID})
        else:
            gen(domain - mountain, lambda xs: {"type": FLUID})
            gen(mountain, lambda xs: {"type": MOUNTAIN})
        if cfg.flow:
            # fence split: ground+sky walls, wind inflow, sink outflow
            # (isothermal_flow_witch.jl:96-105)
            ground = Specification(fence, lambda x: x[..., 1] < 0)
            sky = Specification(fence, lambda x: x[..., 1] > cfg.dom_height)
            wind = Specification(
                fence, lambda x: (x[..., 0] <= -cfg.dom_length / 2)
                & (x[..., 1] >= 0) & (x[..., 1] <= cfg.dom_height))
            if cfg.lj_floor:
                # the inflow column advects at (U, 0) ignoring the LJ, so
                # its rows must respect the same surface clearance or a
                # converting bottom row materializes INSIDE the wall zone
                # and takes the capped-force kick
                clear = 0.75 * cfg.dr
                wind = Specification(
                    wind, lambda x: x[..., 1]
                    > witch_profile(cfg.witch, x[..., 0]) + clear)
                gen(wind, lambda xs: {"type": INFLOW})
                gen(sky, lambda xs: {"type": WALL})
            else:
                gen(wind, lambda xs: {"type": INFLOW})
                gen(ground + sky, lambda xs: {"type": WALL})
            # OUTFLOW region is dropped right after packing in the reference
            # (:114) — never generated here
        else:
            gen(fence, lambda xs: {"type": WALL})

    for chunk in sys._chunks:
        y = chunk["x"][:, 1]
        rho = cfg.rho0 * np.exp(-y * cfg.g / (cfg.R_mass * cfg.T0))
        upd = {"h": np.full_like(y, cfg.h0), "rho": rho,
               "m": rho * cfg.dr**2,
               "P": rho * cfg.T0 * cfg.R_mass,
               "T": np.full_like(y, cfg.T0)}
        upd["theta"] = cfg.T0 * ((cfg.T0 * cfg.R_mass * cfg.rho0)
                                 / upd["P"]) ** (cfg.R_gas / cfg.cp)
        if cfg.adiabatic:
            # faithful init carries a stray γ in the log denominator
            # (adiabatic_static_witch.jl:85) — see consistent_entropy
            gfac = 1.0 if cfg.consistent_entropy else cfg.gamma
            upd["S"] = upd["m"] * cfg.cv * np.log(
                (cfg.cv * cfg.T0 * (cfg.gamma - 1))
                / (gfac * rho ** (cfg.gamma - 1)))
        if cfg.flow and "v" not in imported:
            mob = (chunk["type"] == FLUID) | (chunk["type"] == INFLOW)
            upd["v"] = np.where(mob[:, None], [cfg.U_max, 0.0], 0.0)
        for name, val in upd.items():
            if name not in imported:  # frame-imported fields stay as loaded
                chunk[name] = val
    # engine defaults driven by the config so the module satisfies the
    # shared sharded-runner surface (run_sharded_witch_bucket builds the
    # engine from make_system alone); run()/callers may still override
    if cfg.layout == "bucket" or cfg.use_pallas:
        sys.freeze_opts.setdefault("layout", "bucket")
        sys.freeze_opts.setdefault("skin", cfg.skin)
    # irreducible per-row state: everything else is (a) uniformly zero at
    # rebuild time (Dv/Dh/Drho are reset before the rebuild each step) or
    # (b) recomputed from persistent fields before it is read (P/theta/s
    # in the isothermal EOS chain). The adiabatic EOS writes T/P only on
    # FLUID rows (walls keep their init values), so those must move too,
    # as must S (evolves by viscous production) and theta (adia never
    # recomputes it — export-only). Fewer sort payloads = cheaper
    # rescatters (each payload is ~1 ms per 2M slots).
    pers = ["x", "v", "h", "m", "rho", "type", "T"]
    if cfg.adiabatic:
        pers += ["S", "P", "theta"]
    elif not cfg.flow:
        # iso static never recomputes theta in-step (find_pot_temp is the
        # flow branch's diagnostic) — keep the init values moving
        pers += ["theta"]
    sys.freeze_opts.setdefault("persistent", tuple(pers))
    if cfg.bucket_cap:
        sys.freeze_opts.setdefault("cap", cfg.bucket_cap)
    if cfg.lattice_cells:
        if cfg.flow:  # square lattice: pitch dr on both axes
            c = 2.0 * cfg.dr * (1.0 - 1e-6)
            sys.freeze_opts.setdefault("cells", (c, c))
        else:  # hexagonal lattice: a-columns / b-rows (witch_common)
            a = (4.0 / 3.0) ** 0.25 * cfg.dr
            b = (3.0 / 4.0) ** 0.25 * cfg.dr
            sys.freeze_opts.setdefault(
                "cells", (2.0 * a * (1.0 - 1e-6), 2.0 * b * (1.0 - 1e-6)))
    if cfg.flow:
        # spawning writes arbitrary inactive slots -> the 1-cell-local
        # stencil rescatter's locality invariant does not hold
        sys.freeze_opts.setdefault("rescatter_mode", "sort")
        sys.freeze_opts.setdefault("capacity", int(sys.n_built * 1.3))
    return sys


def _lj_params(cfg: LegacyConfig):
    r0 = cfg.lj_r0 if cfg.lj_r0 is not None else cfg.dr
    D = cfg.lj_D if cfg.lj_D is not None else cfg.R_mass * cfg.T0 / cfg.dr
    return r0, D


def _floor_gap(cfg: LegacyConfig, x):
    """(d, n̂) — signed normal gap to the analytic witch surface y = h(x)
    and the unit surface normal, in-jit (jnp). Slopes are ≤ hₘ/a ≪ 1, so
    the normal gap is the vertical gap scaled by cos θ."""
    xs, ys = x[..., 0], x[..., 1]
    if cfg.a == 0.0 or cfg.h_m == 0.0:
        hh = jnp.zeros_like(xs)
        hp = jnp.zeros_like(xs)
    else:
        den = xs * xs + cfg.a**2
        hh = cfg.h_m * cfg.a**2 / den
        hp = -2.0 * cfg.h_m * cfg.a**2 * xs / (den * den)
    inv = 1.0 / jnp.sqrt(1.0 + hp * hp)
    d = (ys - hh) * inv
    n_hat = jnp.stack([-hp * inv, jnp.ones_like(inv) * inv], axis=-1)
    return d, n_hat


def _lj_floor_acc(cfg: LegacyConfig, x, v=None):
    """LJ-style repulsion from the analytic surface (LegacyConfig.lj_floor;
    wall form of sph_jl/examples/collapse_symplectic.jl:119-122 evaluated
    against the smooth curve): a = D·((r0/d)⁴ − (r0/d)²)·n̂ for d < r0.

    Two stabilizers beyond the raw potential (pilot-measured: without
    them a particle punched to d ≈ 0.05·r0 takes a (r0/d)⁴ ≈ 1.6e5·D
    slingshot — u_max spiked to 4e5 m/s):
      * magnitude cap at 20·D (stiff enough to stop anything the CFL dt
        admits, bounded enough to never outrun it — asserted in
        test_legacy), and
      * NORMAL-velocity damping −γ·(v·n̂)n̂ inside the contact range with
        γ = 4·√(D/r0) (overdamps the wall bounce; tangential velocity
        untouched — the floor stays free-slip)."""
    r0, D = _lj_params(cfg)
    d, n_hat = _floor_gap(cfg, x)
    dc = jnp.maximum(d, 0.05 * r0)
    s2 = (r0 / dc) ** 2
    mag = jnp.minimum(D * jnp.maximum(s2 * s2 - s2, 0.0), 20.0 * D)
    acc = mag[..., None] * n_hat
    if v is not None:
        gam = 4.0 * float(np.sqrt(D / r0))
        vn = jnp.sum(v * n_hat, axis=-1)
        contact = (d < r0).astype(v.dtype)
        acc = acc - (gam * contact * vn)[..., None] * n_hat
    return acc


@lru_cache(maxsize=None)
def _wall_fraction_table(n: int = 96, M: int = 600):
    """c(d/h): fraction of the 2-D Wendland kernel integral lying in the
    half-plane a normal distance d above the support center — the analytic
    wall-truncation renormalization for summation density at the lj_floor
    (rows near the smooth surface have no particles below it; dividing the
    kernel sum by c restores the hydrostatic density there)."""
    # pure-numpy Wendland (kernels.wendland2 shape; c is a RATIO so the
    # normalization cancels) — must stay host-side even when first called
    # under a jit trace
    ds = np.linspace(0.0, 1.0, n)
    xs = np.linspace(-1.0, 1.0, M)
    X, Y = np.meshgrid(xs, xs)
    R = np.sqrt(X * X + Y * Y)
    t = np.maximum(1.0 - R, 0.0)
    W = t**4 * (1.0 + 4.0 * R)
    tot = W.sum()
    cs = np.array([(W * (Y > -d)).sum() / tot for d in ds])
    # cache NUMPY: returning jnp arrays from an lru_cache first populated
    # under a jit trace leaks that trace's constants into every later
    # trace in the process (UnexpectedTracerError on the second config)
    return ds, cs


def _wall_fraction(cfg: LegacyConfig, x):
    """c(d/h₀) per row (1 beyond kernel support of the surface).

    The table abscissae are a uniform linspace, so interpolation is index
    arithmetic + a 2-element ``jnp.take`` from the constant table — NOT
    ``jnp.interp`` (a searchsorted lowering, and the only use of that op
    in the step). Result cast back to the state dtype (an f64 leak here
    breaks the scan carry on f32 configs under x64)."""
    _, cs_np = _wall_fraction_table()
    cs = jnp.asarray(cs_np, dtype=x.dtype)
    n = cs.shape[0]
    d, _ = _floor_gap(cfg, x)
    u = jnp.clip(d / cfg.h0, 0.0, 1.0) * (n - 1)
    i = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, n - 2)
    frac = (u - i.astype(u.dtype)).astype(x.dtype)
    return jnp.take(cs, i) * (1.0 - frac) + jnp.take(cs, i + 1) * frac


def lj_floor_drag(cfg: LegacyConfig):
    """Surface drag/lift under lj_floor: the reaction −Σ m·a_LJ of the
    fluid on the analytic surface — the washboard-free counterpart of
    ``mountain_force`` (same sign convention).

    The observable is the CONSERVATIVE LJ reaction only: the
    normal-velocity contact-damping term of ``_lj_floor_acc`` (active
    while d < r0) is deliberately excluded (``v`` not passed), so
    momentum transferred through the floor by contact damping is not
    counted.  For the wave-drag campaign that is the right call — the
    damping force is normal-directed (≈ lift-only for the near-flat
    floor) and vanishes in steady state — but a bouncing-impact study
    would need to pass ``v`` and include it."""
    def diag(state: ParticleState) -> dict:
        f = state.fields
        w = (state.active & (f["type"] == FLUID)).astype(f["m"].dtype)
        a = _lj_floor_acc(cfg, f["x"])
        F = -jnp.sum((w * f["m"])[:, None] * a, axis=0)
        return {"drag": F[0], "lift": F[1]}
    return diag


def make_step(cfg: LegacyConfig, engine):
    dt, h0 = cfg.dt, cfg.h0

    def damping(y):
        # faithful reference sponge (defective as committed — see
        # LegacyConfig.true_rayleigh): constant magnitude above zₜ−zᵦ
        mag = cfg.gamma_r * jnp.sin(
            jnp.pi / 2 * (1 - (cfg.z_t - cfg.z_b) / cfg.z_b)) ** 2
        return jnp.where(y >= cfg.z_t - cfg.z_b, mag, 0.0)

    def damping_gamma(y):
        # corrected Rayleigh coefficient γ(z): the intended sin² ramp
        # (0 at the sponge base, γ_max at the domain top; see
        # LegacyConfig.sponge_gamma for why γ_max must be ~N, not 10·N)
        gmax = cfg.gamma_r if cfg.sponge_gamma is None else cfg.sponge_gamma
        r = jnp.clip(1.0 - (cfg.z_t - y) / cfg.z_b, 0.0, 1.0)
        return gmax * jnp.sin(jnp.pi / 2 * r) ** 2

    # --- isothermal closures (isothermal_static_witch.jl:118-160) ---
    def iso_balance_of_mass(p, q, r):
        if cfg.flow:
            ker = q.m * rDwendland2(h0, r)  # flow variant: global h (:147)
            return {"Drho": ker * jnp.sum((p.x - q.x) * (p.v - q.v), axis=-1)}
        ker = (q.m / jnp.maximum(q.rho, 1e-30)) * rDwendland2(p.h, r)
        return {"Drho": p.rho * ker
                * jnp.sum((p.x - q.x) * (p.v - q.v), axis=-1)}

    def iso_balance_of_smoothing(u):
        return {"Dh": -0.5 * (u.h / jnp.maximum(u.rho, 1e-30)) * u.Drho}

    def iso_find_pressure(u):
        rho = u.rho + u.Drho * dt
        upd = {"rho": rho, "Drho": jnp.zeros_like(u.Drho),
               "P": rho * cfg.R_mass * cfg.T0}
        if not cfg.flow:
            upd["h"] = u.h + u.Dh * dt
            upd["Dh"] = jnp.zeros_like(u.Dh)
        return upd

    def find_pot_temp(u):
        # floor P: inactive slots carry P=0 and an Inf operand in the pow
        # would put Inf/NaN into the whole [slots]-wide transcendental
        # (active rows sit at ~1e2..1e5 Pa — unaffected)
        P = jnp.maximum(u.P, 1e-6)
        return {"theta": u.T * ((u.T * cfg.R_gas * cfg.rho0) / P)
                ** (cfg.R_gas / cfg.cp)}

    # --- adiabatic closures (adiabatic_static_witch.jl:130-164) ---
    def adia_find_density(p, q, r):
        # faithful: both-FLUID gate (adiabatic_static_witch.jl:134) — any
        # type boundary becomes a density hole (half kernel support) and
        # so a pressure hole that jets the adjacent fluid (measured: the
        # OUTFLOW conversion front accelerates a whole column to >150
        # m/s). The corrected open-boundary variant counts every
        # neighbor's mass, the standard boundary-contribution treatment.
        if cfg.outflow_buffer:
            # OUTFLOW rows get a density sum too: a row converting this
            # step was rho-reset while still FLUID (move!) and would
            # otherwise carry rho=0 into the force's P/rho^2
            ok = (p.type == FLUID) | (p.type == OUTFLOW)
        else:
            ok = (p.type == FLUID) & (q.type == FLUID)
        return {"rho": jnp.where(ok, q.m * wendland2(h0, r), 0.0)}

    def _eos_rows(u):
        # rows whose density is recomputed by summation each step and whose
        # thermodynamic state must follow: FLUID, plus the OUTFLOW buffer
        # under the corrected open boundary (S frozen there — production is
        # both-FLUID-gated — so T, P track the slowly-evolving rho)
        fl = u.type == FLUID
        if cfg.flow and cfg.outflow_buffer:
            fl = fl | (u.type == OUTFLOW)
        return fl

    def adia_find_s(u):
        fl = _eos_rows(u)
        return {"s": jnp.where(fl, u.S * u.rho / jnp.maximum(u.m, 1e-30), u.s)}

    def adia_find_pressure(u):
        fl = _eos_rows(u)
        T = (u.rho ** (cfg.gamma - 1.0)) * jnp.exp(
            u.s / jnp.maximum(u.rho, 1e-30) / cfg.cv) / (cfg.cv * (cfg.gamma - 1.0))
        T = jnp.where(fl, T, u.T)
        return {"T": T, "P": jnp.where(fl, cfg.R_mass * u.rho * T, u.P)}

    def adia_entropy_production(p, q, r):
        both = (p.type == FLUID) & (q.type == FLUID)
        ker = rDwendland2(h0, r)
        dux = jnp.sum((p.v - q.v) * (p.x - q.x), axis=-1)
        # floors: inactive rows carry T=rho=0 and the masked-but-computed
        # 0/0 NaN would leak through the masked sums
        denom = (jnp.maximum(p.T, 1e-30) * jnp.maximum(p.rho, 1e-30)
                 * jnp.maximum(q.rho, 1e-30))
        dS = (-4.0 * p.m * q.m * ker * cfg.mu / denom
              * dux**2 / (r * r + 0.01 * h0 * h0) * dt)
        return {"S": jnp.where(both, dS, 0.0)}

    def internal_force(p, q, r):
        hker = p.h if (not cfg.flow and not cfg.adiabatic) else h0
        ker = q.m * rDwendland2(hker, r)
        x_pq = p.x - q.x
        # rho floors: inactive rows carry rho=0 and a 0/0 NaN operand
        # would be computed (masked later) and can leak through sums
        rho_p = jnp.maximum(p.rho, 1e-30)
        rho_q = jnp.maximum(q.rho, 1e-30)
        du = -(ker * (p.P / rho_p**2 + q.P / rho_q**2))[..., None] * x_pq
        adaptive_h = not cfg.flow and not cfg.adiabatic
        denom = (r * r + 0.0025 * (p.h + q.h) ** 2 if adaptive_h
                 else r * r + 0.01 * h0 * h0)
        dot = jnp.sum((p.v - q.v) * x_pq, axis=-1)
        s = 8.0 * ker * cfg.mu / (rho_p * rho_q) * dot / denom
        if cfg.av_alpha:
            # Monaghan AV on approaching FLUID–FLUID pairs
            # (LegacyConfig.av_alpha): μ_pq = h̄·(v_pq·x_pq)/denom (reusing
            # the scheme's own ε-form denominator), Π = (−α·c·μ + 2α·μ²)·
            # (ρ̄⁻¹ ≈ ½(1/ρp + 1/ρq) — the mean the Pallas kernels form
            # from the streamed 1/ρ). The fluid–fluid gate is load-bearing:
            # fluid sliding over the static MOUNTAIN lattice always has
            # approaching floor pairs, so ungated AV is a no-slip floor
            # drag that decelerates the near-surface flow below U and
            # kills the wave launch (round 4: ungated α=0.05 measured
            # flux −0.10·D_lin with u_avg 19.4 < U; the noise DID damp,
            # σ 2.6→0.4·D_lin — free-slip gating keeps that win).
            h_av = 0.5 * (p.h + q.h) if adaptive_h else h0
            mu_av = h_av * dot / denom
            pi = ((-cfg.av_alpha * cfg.c_av * mu_av
                   + 2.0 * cfg.av_alpha * mu_av**2)
                  * 0.5 * (1.0 / rho_p + 1.0 / rho_q))
            both_fl = (p.type == FLUID) & (q.type == FLUID)
            s = s - jnp.where(both_fl & (dot < 0.0), ker * pi, 0.0)
        return {"Dv": du + s[..., None] * x_pq}

    def set_inflow_speed(u):
        v = jnp.stack([jnp.full_like(u.P, cfg.U_max),
                       jnp.zeros_like(u.P)], axis=-1)
        pinned = u.type == INFLOW
        if cfg.outflow_buffer:
            # prescribed-flux open boundary: the buffer advects at exactly
            # (U,0). Freezing conversion-time velocities instead lets the
            # buffer act as a suction (measured: downstream u_mean grows
            # 35→47 m/s with mean subsidence −5..−17 m/s)
            pinned = pinned | (u.type == OUTFLOW)
        return {"v": jnp.where(pinned[:, None], v, u.v)}

    def move(u):
        mob = (u.type == FLUID) | ((u.type == INFLOW) if cfg.flow else False)
        if cfg.flow and cfg.outflow_buffer:
            mob = mob | (u.type == OUTFLOW)  # frozen-v advection out
        upd = {"x": jnp.where(mob[:, None], u.x + dt * u.v, u.x),
               "Dv": jnp.zeros_like(u.Dv)}
        if cfg.adiabatic:  # static adiabatic resets rho in move! (:193)
            reset = u.type == FLUID
            if cfg.flow and cfg.outflow_buffer:
                # OUTFLOW density is recomputed by summation each step just
                # like FLUID (adia_find_density's p-gate) — without the
                # reset the sum ACCUMULATES and the buffer's rho grows
                # unboundedly, fading its force support
                reset = reset | (u.type == OUTFLOW)
            upd["rho"] = jnp.where(reset, 0.0, u.rho)
        return upd

    def to_outflow(u):
        # open-boundary buffer (cfg.outflow_buffer): FLUID entering the
        # last w of the domain freezes into OUTFLOW — advected, neighbor-
        # visible, force-skipped, deleted once outside the grid
        x_out = cfg.dom_length / 2 - cfg.outflow_buffer
        conv = (u.type == FLUID) & (u.x[:, 0] >= x_out)
        return {"type": jnp.where(conv, OUTFLOW, u.type)}

    def accelerate(u):
        fl = (u.type == FLUID)[:, None]
        if cfg.true_rayleigh:
            gam = damping_gamma(u.x[:, 1])
            # relax toward the background wind (U_max, 0) in flow
            # variants so the sponge doesn't fight the mean flow
            vx_ref = cfg.U_max if cfg.flow else 0.0
            acc = jnp.stack(
                [u.Dv[:, 0] - gam * (u.v[:, 0] - vx_ref),
                 u.Dv[:, 1] - cfg.g - gam * u.v[:, 1]], axis=-1)
        else:  # faithful constant-force sponge (reference :213)
            acc = jnp.stack([u.Dv[:, 0],
                             u.Dv[:, 1] - cfg.g - damping(u.x[:, 1])],
                            axis=-1)
        if cfg.lj_floor:
            acc = acc + _lj_floor_acc(cfg, u.x, u.v)
        return {"v": jnp.where(fl, u.v + 0.5 * dt * acc, u.v)}

    def add_new_particles(state: ParticleState) -> ParticleState:
        """Inflow recycling (isothermal_flow_witch.jl:175-186).

        Spawning is an *event*: an inflow column crosses the domain edge
        every dr/U_max seconds (≈700 steps at the terrain baseline dt), so
        the whole conversion+respawn — two capacity-size argsorts and ~13
        per-field scatters — sits under a ``lax.cond`` on "any column
        converted this step". On the ~699 quiet steps the cond's identity
        branch passes each field buffer through whole (the documented safe
        branch structure: per-field whole-buffer outputs, no stacking), so
        the step pays only the O(n) edge test.

        Under the slab decomposition (BucketShardEngine) both the source
        test and the free-slot pool are restricted to OWNED slots: a ghost
        copy of a converting column must neither convert nor spawn (its
        owner does), and a spawn written into a ghost column would be
        destroyed by the next halo refresh. The cond predicate is a local
        scalar and the branch contains no collectives, so devices take the
        spawn branch independently.

        Placement has two strategies. The free-POOL path writes spawns
        into arbitrary inactive slots and leaves their ``_xref`` stale, so
        the next rebuild's drift check forces a full rescatter before any
        pair sweep reads the (slot-implicit) cell membership — correct for
        any layout but requires ``rescatter_mode="sort"`` (a teleported
        row is farther than the stencil move reaches) and costs a ~100 ms
        sort event plus ~200 s of variadic-sort compile at the terrain
        config. The slot-TARGETED path (single-device bucket engine in
        stencil mode) instead places each spawn in a free slot of its HOME
        cell — binned exactly as ``_screen_and_key`` bins — and stamps
        ``_xref`` = x_new, so the 1-cell locality invariant of the stencil
        rescatter keeps holding and the spawn event triggers no rescatter
        at all. Spawns whose home cell has no free rank are dropped (the
        pool path's exhaustion semantics); cap headroom makes that rare —
        the freshly-advected-away inflow column leaves its cells
        under-occupied."""
        f = state.fields
        n = state.capacity
        edge = -cfg.dom_length / 2
        conv = state.active & (f["type"] == INFLOW) & (f["x"][:, 0] >= edge)
        owned = getattr(engine, "owned_flat", None)
        if owned is not None:
            conv = conv & jnp.asarray(owned)
        k = cfg.max_spawn
        slot_targeted = (
            owned is None
            and getattr(engine, "layout", "flat") == "bucket"
            and getattr(engine, "effective_rescatter_mode", "sort")
            == "stencil")

        def first_k(mask):
            # indices of the first k True entries via cumsum rank-packing —
            # one scan + one scatter instead of a capacity-size argsort
            # (cheaper to compile and to run inside the cond branch)
            rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
            rank = jnp.where(mask, rank, k)
            return jnp.full((k,), n, jnp.int32).at[rank].set(
                jnp.arange(n, dtype=jnp.int32), mode="drop")

        def spawn(f, active):
            new_type = jnp.where(conv, FLUID, f["type"])
            src_raw = first_k(conv)
            src = jnp.minimum(src_raw, n - 1)       # sentinel n -> clamp
            src_ok = (src_raw < n) & conv[src]
            x_new = f["x"][src] - jnp.asarray([cfg.bc_width, 0.0],
                                              f["x"].dtype)
            if slot_targeted:
                # home-cell binning, exactly as _screen_and_key bins
                L = jnp.asarray(engine.cell_size, x_new.dtype)
                cell = (jnp.floor(x_new / L).astype(jnp.int32)
                        - jnp.asarray(engine.phase, jnp.int32))
                cell = jnp.clip(cell, 0,
                                jnp.asarray(engine.lims, jnp.int32) - 1)
                C, cap = engine.num_cells, engine.cap
                # invalid candidates bin to the padding column C: they
                # consume free ranks only there and are never written
                c = jnp.where(src_ok, engine.flat_key(cell), C)
                free_cols = (~active).reshape(cap, C + 1)[:, c]  # [cap, k]
                # rank among same-cell spawns (stable: earlier candidate
                # gets the earlier free rank)
                ar = jnp.arange(k)
                order = jnp.sum((c[None, :] == c[:, None])
                                & (ar[None, :] < ar[:, None]), axis=1)
                fcount = jnp.cumsum(free_cols.astype(jnp.int32), axis=0)
                sel = free_cols & (fcount == (order + 1)[None, :])
                ok = src_ok & jnp.any(sel, axis=0)
                tgt = jnp.argmax(sel, axis=0).astype(jnp.int32) * (C + 1) + c
            else:
                free = ~active
                if owned is not None:
                    free = free & jnp.asarray(owned)
                tgt_raw = first_k(free)
                tgt = jnp.minimum(tgt_raw, n - 1)
                ok = src_ok & (tgt_raw < n) & free[tgt]
            tgt_safe = jnp.where(ok, tgt, n)
            y = x_new[:, 1]
            rho = cfg.rho0 * jnp.exp(-y * cfg.g / (cfg.R_mass * cfg.T0))
            fields = dict(f)
            fields["type"] = new_type.at[tgt_safe].set(INFLOW, mode="drop")
            fields["x"] = f["x"].at[tgt_safe].set(x_new, mode="drop")
            fields["v"] = f["v"].at[tgt_safe].set(
                jnp.stack([jnp.full(k, cfg.U_max, f["v"].dtype),
                           jnp.zeros(k, f["v"].dtype)], axis=-1), mode="drop")
            fields["rho"] = f["rho"].at[tgt_safe].set(rho, mode="drop")
            fields["m"] = f["m"].at[tgt_safe].set(rho * cfg.dr**2,
                                                  mode="drop")
            fields["P"] = f["P"].at[tgt_safe].set(
                rho * cfg.T0 * cfg.R_mass, mode="drop")
            fields["h"] = f["h"].at[tgt_safe].set(
                jnp.full(k, cfg.h0, f["h"].dtype), mode="drop")
            for name in ("Dv", "Dh", "Drho", "S", "s", "gGamma"):
                fields[name] = f[name].at[tgt_safe].set(
                    jnp.zeros((k,) + f[name].shape[1:], f[name].dtype),
                    mode="drop")
            fields["T"] = f["T"].at[tgt_safe].set(
                jnp.full(k, cfg.T0, f["T"].dtype), mode="drop")
            if cfg.adiabatic:
                gfac = 1.0 if cfg.consistent_entropy else cfg.gamma
                S = (rho * cfg.dr**2) * cfg.cv * jnp.log(
                    (cfg.cv * cfg.T0 * (cfg.gamma - 1))
                    / (gfac * rho ** (cfg.gamma - 1)))
                fields["S"] = fields["S"].at[tgt_safe].set(S, mode="drop")
            if slot_targeted and "_xref" in f:
                # placement is already slot-correct: stamp the rescatter
                # reference so the spawn event triggers no rescatter
                fields["_xref"] = f["_xref"].at[tgt_safe].set(x_new,
                                                              mode="drop")
            # surface dropped spawns (valid source, no free slot/rank):
            # mirrors Neighbors.overflow — a tight-cap inflow run must not
            # leak particles silently (advisor round-3 finding)
            n_drop = jnp.sum(src_ok & ~ok).astype(f["_spawn_drops"].dtype)
            fields["_spawn_drops"] = f["_spawn_drops"].at[0].add(n_drop)
            return fields, active.at[tgt_safe].set(ok, mode="drop")

        def no_op(f, active):
            return dict(f), active

        fields, active = jax.lax.cond(jnp.any(conv), spawn, no_op,
                                      f, state.active)
        return ParticleState(fields=fields, active=active)

    # Pallas fast path covers all four legacy variants: isothermal flow
    # (the terrain baseline config: fused fixed-h0 mass + force sweeps),
    # adiabatic static/flow (gated density + fused entropy+force sweep),
    # and isothermal static (adaptive per-particle h streamed through the
    # mass/force kernels).
    use_pallas = (cfg.use_pallas
                  and getattr(engine, "layout", "flat") == "bucket")
    if use_pallas:
        from ..ops.pallas_pairs import (adia_density_pass,
                                        adia_entropy_force_pass,
                                        iso_static_force_pass,
                                        iso_static_mass_pass,
                                        legacy_force_pass, legacy_mass_pass)

    def step(state: ParticleState) -> ParticleState:
        state = apply_unary(state, accelerate)
        state = apply_unary(state, move)
        if cfg.flow:
            if cfg.max_spawn:  # max_spawn=0 disables recycling (ablation)
                state = add_new_particles(state)
            state = apply_unary(state, set_inflow_speed)
            if cfg.outflow_buffer:
                state = apply_unary(state, to_outflow)
        state, nbrs = engine.rebuild(state)
        force_done = False
        if cfg.adiabatic:
            # adiabatic verlet (adiabatic_static_witch.jl:200-211)
            if use_pallas:
                rho_add = adia_density_pass(engine, state, cfg)
                typ = state.fields["type"]
                fl = typ == FLUID
                if cfg.flow and cfg.outflow_buffer:
                    fl = fl | (typ == OUTFLOW)  # match adia_find_density
                fl = state.active & fl
                state = state.replace(rho=jnp.where(
                    fl, state.fields["rho"] + rho_add, state.fields["rho"]))
            else:
                state = apply_binary(engine, state, nbrs, adia_find_density,
                                     self_interaction=True)
            if cfg.lj_floor:
                # wall-truncation completion: the summation density of rows
                # within kernel support of the (particle-free) smooth floor
                # misses the sub-surface part of the integral — ADD the
                # background-density image mass ρ_bg(y)·(1−c(d/h)) (the
                # additive form keeps dynamic fluctuations unamplified; a
                # multiplicative 1/c renorm scales them ~1.3x at the bottom
                # row and was measurably less stable)
                def _complete(u):
                    c = _wall_fraction(cfg, u.x)
                    rho_bg = cfg.rho0 * jnp.exp(
                        -u.x[:, 1] * cfg.g / (cfg.R_mass * cfg.T0))
                    return {"rho": jnp.where(u.type == FLUID,
                                             u.rho + rho_bg * (1.0 - c),
                                             u.rho)}
                state = apply_unary(state, _complete)
            state = apply_unary(state, adia_find_s)
            state = apply_unary(state, adia_find_pressure)
            if use_pallas:
                dS, *dv = adia_entropy_force_pass(engine, state, cfg)
                state = state.replace(
                    S=jnp.where(state.active, state.fields["S"] + dS, 0.0),
                    Dv=jnp.where(state.active[:, None],
                                 state.fields["Dv"] + jnp.stack(dv, axis=-1),
                                 0.0))
                force_done = True
            else:
                state = apply_binary(engine, state, nbrs,
                                     adia_entropy_production)
        else:
            # isothermal verlet (isothermal_static_witch.jl:213-224)
            if use_pallas:
                if cfg.flow:
                    drho = legacy_mass_pass(engine, state, cfg)
                else:  # static: Drho = p.rho · Σ (q.m/q.rho)·rDw(p.h)·dot
                    drho = (state.fields["rho"]
                            * iso_static_mass_pass(engine, state, cfg))
                Drho = state.fields["Drho"] + drho
                state = state.replace(
                    Drho=jnp.where(state.active, Drho, 0.0))
            else:
                state = apply_binary(engine, state, nbrs, iso_balance_of_mass)
            if not cfg.flow:
                state = apply_unary(state, iso_balance_of_smoothing)
            state = apply_unary(state, iso_find_pressure)
            if cfg.flow:
                state = apply_unary(state, find_pot_temp)
        if use_pallas and not force_done:
            force_pass = (legacy_force_pass if cfg.flow
                          else iso_static_force_pass)
            dv = force_pass(engine, state, cfg)
            Dv = state.fields["Dv"] + jnp.stack(dv, axis=-1)
            state = state.replace(
                Dv=jnp.where(state.active[:, None], Dv, 0.0))
        elif not force_done:
            state = apply_binary(engine, state, nbrs, internal_force)
        state = apply_unary(state, accelerate)
        return state

    return step


# sharded-runner surface (run_sharded_witch_bucket(model=legacy_witch)):
# the legacy frame exports; diagnostics are eager (lazy_diagnostics=False),
# so make_finalize is never consulted but completes the module contract
EXPORT_VARS = ("v", "P", "theta", "rho", "type")


def make_finalize(cfg: LegacyConfig):
    return None


def mountain_force(state: ParticleState) -> dict:
    """Net SPH force the air exerts on the terrain: Σ m·Dv over MOUNTAIN
    rows — the reference's obstacle-force pattern (calculate_force,
    sph_jl/examples/cylinder.jl:163-169) applied to the Witch of Agnesi.
    Mountain–mountain pair contributions cancel exactly (the symmetric
    pressure/viscous pair force is antisymmetric under p↔q), so the sum is
    the external force alone. Gravity and Rayleigh damping never enter Dv
    (they are applied inside accelerate), so the x-component is the
    **mountain-wave drag** — the BASELINE north-star observable for flow
    over terrain. Returns {"drag": F_x, "lift": F_y} (N per meter of
    spanwise depth in 2-D)."""
    f = state.fields
    w = (state.active & (f["type"] == MOUNTAIN)).astype(f["Dv"].dtype)
    F = jnp.sum((w * f["m"])[:, None] * f["Dv"], axis=0)
    return {"drag": F[0], "lift": F[1]}


def inflow_reservoir(state: ParticleState) -> dict:
    """INFLOW-row count — the spawn-leak detector (ADVICE round 3).
    Recycling conserves the INFLOW population exactly: every conversion
    (INFLOW→FLUID at the domain edge) spawns exactly one INFLOW row at the
    back of the queue, so a sustained decline in ``n_inflow`` means silent
    spawn drops — home-cell free-rank exhaustion at tight bucket caps
    (add_new_particles' slot-targeted path), pool exhaustion, or (sharded)
    a spawn binned outside the spawning device's slab. Exported per frame
    by the flow run loop (merged into every ``extra_diag``).

    ``spawn_drops`` (round 5): the cumulative DIRECT counter — spawns with
    a valid source but no free slot (slot-targeted: home-cell rank
    exhaustion; pool: capacity exhaustion) accumulate into the slot-bound
    ``_spawn_drops`` bookkeeping field at spawn time, the explicit
    counterpart of inferring leaks from the ``n_inflow`` trend.
    (Single-device exact; on sharded engines the per-device counter lands
    in slot 0 — a ghost column on interior devices — so there the
    ``n_inflow`` trend remains the authoritative leak observable.)"""
    f = state.fields
    out = {"n_inflow": jnp.sum(state.active & (f["type"] == INFLOW))}
    if "_spawn_drops" in f:
        out["spawn_drops"] = jnp.sum(f["_spawn_drops"]).astype(jnp.int32)
    return out


def wave_momentum_flux(cfg: LegacyConfig, z0: float, dz: float,
                       tag: str = "wave_flux", x_window: float | None = None):
    """Per-frame wave-drag observable D(z₀) = −∫ρ u′w′ dx: the vertical
    flux of horizontal momentum through the band |z − z₀| < dz/2
    (Eliassen–Palm). For steady linear hydrostatic waves D(z₀) equals the
    surface wave drag at every z₀ below dissipation, so a band placed a
    few rows above the terrain reads the SAME number as the surface
    integral while being immune to the lattice floor friction that
    dominates Σ m·Dv over the flat parts of the MOUNTAIN row (the sliding
    square lattice exerts a systematic streamwise "washboard" force ~650×
    the linear signal at hₘ=300 m — measured round 3). In SPH the
    band integral is Σ m·u′·w′ / dz over FLUID rows in the band.

    ``x_window``: restrict to |x| ≤ x_window. The wave's u′w′ is
    concentrated over the ridge while ambient turbulence noise is
    domain-wide, so a 3a window cuts the noise floor ~√(L/6a)× at ≤4.5%
    truncation bias (verified on the analytic solution across phases)."""
    def diag(state: ParticleState) -> dict:
        f = state.fields
        y = f["x"][:, 1]
        sel = (state.active & (f["type"] == FLUID)
               & (y >= z0 - dz / 2) & (y < z0 + dz / 2))
        if x_window is not None:
            sel = sel & (jnp.abs(f["x"][:, 0]) <= x_window)
        up = f["v"][:, 0] - cfg.U_max
        return {tag: -jnp.sum(jnp.where(sel, f["m"] * up * f["v"][:, 1],
                                        0.0)) / dz}
    return diag


def wave_momentum_flux_binned(cfg: LegacyConfig, z0: float, dz: float,
                              tag: str = "wave_flux", x_window: float = 15e3,
                              bin_w: float = 1000.0, bin_h: float = 400.0):
    """Scale-filtered EP flux: ``wave_momentum_flux`` computed from BINNED
    mean fields instead of raw particles — D(z₀) = −Σ_b M_b·ū′_b·w̄_b / dz
    with mass-weighted means over a 2-D grid of bins (``bin_w`` wide in x,
    ``bin_h`` tall in z) tiling the band.

    Why: the flux noise is EDDY momentum flux — the lattice floor sliding
    under the flow ("washboard", CLAUDE.md) continuously regenerates
    turbulence with u′ up to ~100 m/s at scales of a few dr, and Monaghan
    AV cannot remove it without damping the wave source region too
    (measured round 4: α = 0.05 leaves u_max 50–200 m/s AND reads flux
    ≈ 0). The wave, by contrast, lives at horizontal scales ≥ a (5 km in
    the linear-drag experiment). Binning is a top-hat Reynolds filter:
    the product of FILTERED fields keeps only structure correlated across
    a whole bin, so sub-bin eddy flux averages out (σ ∝ √n_bins instead
    of √N_particles) while the resolved wave passes through with
    O((bin_w/a)²) + O((m·bin_h)²/12) bias — bins must stay ≪ a
    horizontally and ≪ λ_z = 2πU/N vertically (a z-bin spanning ≳1 rad of
    wave phase multiplies phase-averaged factors and biases LOW; that is
    also why the band can be thick: z-sub-binning keeps the phase
    resolved). Gated against the analytic solution alongside the raw
    observable (tests/test_legacy.py)."""
    nbx = int(round(2 * x_window / bin_w))
    nbz = max(1, int(round(dz / bin_h)))

    def diag(state: ParticleState) -> dict:
        f = state.fields
        y = f["x"][:, 1]
        sel = (state.active & (f["type"] == FLUID)
               & (y >= z0 - dz / 2) & (y < z0 + dz / 2)
               & (jnp.abs(f["x"][:, 0]) <= x_window))
        m = jnp.where(sel, f["m"], 0.0)
        bx = jnp.clip(((f["x"][:, 0] + x_window) / bin_w).astype(jnp.int32),
                      0, nbx - 1)
        bz = jnp.clip(((y - (z0 - dz / 2)) / (dz / nbz)).astype(jnp.int32),
                      0, nbz - 1)
        b = bx * nbz + bz
        nb = nbx * nbz
        sm = jnp.zeros(nb, m.dtype).at[b].add(m)
        su = jnp.zeros(nb, m.dtype).at[b].add(m * (f["v"][:, 0] - cfg.U_max))
        sw = jnp.zeros(nb, m.dtype).at[b].add(m * f["v"][:, 1])
        sm_safe = jnp.maximum(sm, 1e-30)
        return {tag: -jnp.sum(su * sw / sm_safe) / dz}
    return diag


def wave_momentum_flux_profile(cfg: LegacyConfig, z_levels,
                               dz: float = 1000.0, tag: str = "fp",
                               x_window: float = 15e3,
                               bin_w: float = 1000.0, bin_h: float = 400.0):
    """Vertical PROFILE of the scale-filtered EP flux: one
    ``wave_momentum_flux_binned`` band per level in ``z_levels``, keys
    ``{tag}{z}``. The round-4 lj_floor run localized the linear-drag
    deficit to somewhere between the surface (reaction 2.55·D_lin) and
    the 3-km band (0.038·D_lin) — this diagnostic is how round 5 finds
    the altitude where the flux dies (linear theory: z-independent below
    dissipation; a sharp drop marks breaking/absorption)."""
    bands = [(int(z), wave_momentum_flux_binned(
        cfg, z0=float(z), dz=dz, tag=f"{tag}{int(z)}", x_window=x_window,
        bin_w=bin_w, bin_h=bin_h)) for z in z_levels]

    def diag(state: ParticleState) -> dict:
        out = {}
        for _, d in bands:
            out.update(d(state))
        return out
    return diag


def wave_amplitude_profile(cfg: LegacyConfig, z_levels, dz: float = 1000.0,
                           tag: str = "amp", x_window: float = 15e3,
                           bin_w: float = 1000.0, bin_h: float = 400.0):
    """Resolved wave AMPLITUDE per level: mass-weighted RMS of the BINNED
    mean perturbation velocities over the |x| ≤ x_window band at each
    z-level — keys ``{tag}u{z}`` (ū′ RMS) and ``{tag}w{z}`` (w̄ RMS).

    Companion to ``wave_momentum_flux_profile``: the flux alone cannot
    distinguish "wave never generated" from "wave present but u′ and w̄
    decorrelated / dissipated en route". Linear hydrostatic theory for the
    witch predicts |u′| ~ N·hₘ·√(ρ_s/ρ(z)) and |w| ~ U·hₘ/a·√(ρ_s/ρ(z))
    near the ridge; a measured amplitude at the prediction with flux far
    below D_lin indicts phase/correlation, a missing amplitude indicts
    generation or dissipation."""
    nbx = int(round(2 * x_window / bin_w))

    def one(z0):
        nbz = max(1, int(round(dz / bin_h)))

        def diag(state: ParticleState) -> dict:
            f = state.fields
            y = f["x"][:, 1]
            sel = (state.active & (f["type"] == FLUID)
                   & (y >= z0 - dz / 2) & (y < z0 + dz / 2)
                   & (jnp.abs(f["x"][:, 0]) <= x_window))
            m = jnp.where(sel, f["m"], 0.0)
            bx = jnp.clip(((f["x"][:, 0] + x_window) / bin_w)
                          .astype(jnp.int32), 0, nbx - 1)
            bz = jnp.clip(((y - (z0 - dz / 2)) / (dz / nbz))
                          .astype(jnp.int32), 0, nbz - 1)
            b = bx * nbz + bz
            nb = nbx * nbz
            sm = jnp.zeros(nb, m.dtype).at[b].add(m)
            su = jnp.zeros(nb, m.dtype).at[b].add(
                m * (f["v"][:, 0] - cfg.U_max))
            sw = jnp.zeros(nb, m.dtype).at[b].add(m * f["v"][:, 1])
            sm_safe = jnp.maximum(sm, 1e-30)
            M = jnp.maximum(jnp.sum(sm), 1e-30)
            return {f"{tag}u{int(z0)}":
                    jnp.sqrt(jnp.sum(sm * (su / sm_safe) ** 2) / M),
                    f"{tag}w{int(z0)}":
                    jnp.sqrt(jnp.sum(sm * (sw / sm_safe) ** 2) / M)}
        return diag

    bands = [one(float(z)) for z in z_levels]

    def diag(state: ParticleState) -> dict:
        out = {}
        for d in bands:
            out.update(d(state))
        return out
    return diag


def stationary_wave_bins(cfg: LegacyConfig, z0: float, dz: float = 500.0,
                         x_window: float = 15e3, bin_w: float = 1000.0,
                         tag: str = "s"):
    """Per-x-bin mean perturbation velocities in ONE low band — the
    GENERATION diagnostic (round 5). Keys ``{tag}u{i}``/``{tag}w{i}``,
    i = 0..2·x_window/bin_w−1, mass-weighted band means per x-bin.

    The wave is stationary, so time-averaging these over late frames
    (host-side) suppresses the unsteady internal-wave noise that
    dominates instantaneous RMS amplitudes and leaves the stationary
    wave's spatial pattern, directly comparable against the analytic
    linear solution at the band height — if the time-mean w̄(x) right
    above the ridge already sits below U·∂h/∂x propagated to z0, the
    drag deficit is at GENERATION; if it matches, the deficit is in
    propagation/phase."""
    nbx = int(round(2 * x_window / bin_w))

    def diag(state: ParticleState) -> dict:
        f = state.fields
        y = f["x"][:, 1]
        sel = (state.active & (f["type"] == FLUID)
               & (y >= z0 - dz / 2) & (y < z0 + dz / 2)
               & (jnp.abs(f["x"][:, 0]) <= x_window))
        m = jnp.where(sel, f["m"], 0.0)
        bx = jnp.clip(((f["x"][:, 0] + x_window) / bin_w).astype(jnp.int32),
                      0, nbx - 1)
        sm = jnp.maximum(jnp.zeros(nbx, m.dtype).at[bx].add(m), 1e-30)
        su = jnp.zeros(nbx, m.dtype).at[bx].add(
            m * (f["v"][:, 0] - cfg.U_max)) / sm
        sw = jnp.zeros(nbx, m.dtype).at[bx].add(m * f["v"][:, 1]) / sm
        out = {}
        for i in range(nbx):
            out[f"{tag}u{i}"] = su[i]
            out[f"{tag}w{i}"] = sw[i]
        return out
    return diag


def run(cfg: LegacyConfig, out_path: str | None = None, verbose: bool = False,
        packing: bool = False, capacity_factor: float = 1.3,
        extra_diag=None, setup_hook=None):
    """Shared main loop for all four legacy schemes. ``extra_diag``
    overrides the default per-frame observable bundle (``mountain_force``);
    use it to add wave_momentum_flux bands etc. ``setup_hook(state) ->
    state`` (optional) transforms the frozen state before the first step
    (after packing; skipped on resume like every setup) — experiment
    scripts superpose initial perturbations with it (e.g. the round-5
    internal-wave propagation probe, scripts/r5_wave_decay.py)."""
    from .wcsph_perturbed_witch import _run_witch_scheme

    def setup(cfg_, engine, state):
        if packing:
            from ..utils.packing import colagrossi_packing
            state = colagrossi_packing(cfg_.witch, engine, state,
                                       1e-10, 1e-10, 100)
        if setup_hook is not None:
            state = setup_hook(state)
        return state

    def _make_system(cfg_):
        # layout/skin/rescatter defaults come from make_system itself;
        # only the caller-tunable spawn-pool headroom is applied here
        sys = make_system(cfg_)
        if cfg_.flow:
            sys.freeze_opts["capacity"] = int(sys.n_built * capacity_factor)
            if sys.freeze_opts.get("layout") == "bucket":
                # single-device production: slot-targeted spawn
                # (add_new_particles) keeps the stencil rescatter valid —
                # no ~100 ms sort events, no ~200 s variadic-sort compile.
                # effective_rescatter_mode still degrades to "sort" (and
                # the spawn to the pool path) past the unroll-cost bound.
                sys.freeze_opts["rescatter_mode"] = "stencil"
        return sys

    diag = extra_diag or mountain_force
    if cfg.flow and cfg.max_spawn:
        # always ride the spawn-leak detector alongside whatever the
        # caller asked for (inflow_reservoir docstring)
        base_diag = diag

        def diag(state):
            return {**base_diag(state), **inflow_reservoir(state)}

    return _run_witch_scheme(cfg, _make_system, make_step,
                             ("v", "P", "theta", "rho", "type"),
                             out_path, verbose, setup=setup,
                             extra_diag=diag)


# named configurations mapping 1:1 to the reference files
def isothermal_static_config(**kw) -> LegacyConfig:
    kw.setdefault("t_end", 200.0)
    return LegacyConfig(flow=False, adiabatic=False, **kw)


def isothermal_flow_config(**kw) -> LegacyConfig:
    kw.setdefault("n_rows", 100)
    kw.setdefault("dom_length", 100e3)
    kw.setdefault("h_m", 13e3)
    kw.setdefault("t_end", 200.0)
    return LegacyConfig(flow=True, adiabatic=False, **kw)


def adiabatic_static_config(**kw) -> LegacyConfig:
    kw.setdefault("t_end", 100.0)
    return LegacyConfig(flow=False, adiabatic=True, **kw)


def adiabatic_flow_config(**kw) -> LegacyConfig:
    kw.setdefault("n_rows", 75)
    kw.setdefault("t_end", 200.0)
    return LegacyConfig(flow=True, adiabatic=True, **kw)


def terrain_baseline_config(**kw) -> LegacyConfig:
    """BASELINE config #3 — "2D stratified mountain-wave flow over terrain,
    ~200k particles": the isothermal flow scheme (U=20 m/s wind, inflow
    recycling) at the reference terrain (hₘ=13 km, a=10 km,
    src/legacy/isothermal_flow_witch.jl:30-34) scaled from the file's
    n_rows=100 to n_rows=228 (square lattice ⇒ N ≈ n_rows²·L/H ≈ 2.0e5
    including the mountain body). Wave drag/lift are exported per frame
    (``mountain_force``)."""
    kw.setdefault("n_rows", 228)
    # Rescatter cadence, not sweep width, bounds this config: the blocked
    # flow sustains u_max ≈ 400 m/s (measured over 2000 steps), so the
    # drift budget (cell−h)/2 sets how often the sort rescatter fires:
    # lattice 2·dr cells (cap 8) leave a 23 m budget, skin=0.6 (cap 16)
    # 123 m, skin=1.0 (cap 24) 205 m → a rescatter every ~64 steps. Wider
    # cells cost sweep width but rescatter far less often; skin=1.0 was
    # tuned before the move to the GPU and awaits measurement on the H100.
    kw.setdefault("skin", 1.0)
    return isothermal_flow_config(**kw)
