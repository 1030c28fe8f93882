"""Shared scaffolding for the mountain-wave (Witch of Agnesi) suite.

All five current/ schemes share one skeleton (SURVEY §2.2; reference
src/current/*.jl): a 400 km × 26 km rectangle with a 6·dr boundary fence,
hexagonal lattice at dr = 26 km/75, hydrostatic isothermal background at
T = 250 K, Brunt–Väisälä N² = 0.0196, Rayleigh damping above 12 km, and a
Witch-of-Agnesi mountain h(x) = hₘa²/(x²+a²) (disabled by default, hₘ=a=0 —
the static-atmosphere well-balancing configuration).

Constants and background-state functions cite
src/current/wcsph_perturbed_witch.jl:20-76 (identical across the suite) and
:177-189 (background density/pressure/potential temperature).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..geometry import BoundaryLayer, Rectangle, Specification
from ..grids import Grid
from ..kernels import rDwendland2
from ..structs import ParticleSystem, generate_particles
from .common import masked_mean, masked_max

FLUID = 0.0
WALL = 1.0
MOUNTAIN = 2.0


@dataclasses.dataclass(frozen=True)
class WitchConfig:
    """Constants of src/current/wcsph_perturbed_witch.jl:20-76."""
    # geometry (:25-30)
    dom_height: float = 26e3
    dom_length: float = 400e3
    n_rows: int = 75                  # dr = dom_height / n_rows
    bc_rows: int = 6                  # bc_width = 6 dr
    h_m: float = 0.0                  # mountain height (disabled by default)
    a: float = 0.0                    # mountain half-width
    # smoothing (:33-34)
    eta: float = 1.8
    # physical (:38-40)
    rho0: float = 1.393
    # artificial (:43-46)
    eps: float = 0.01
    alpha: float = 0.1
    # meteorological (:49-54)
    N_bv: float = float(np.sqrt(0.0196))
    g: float = 9.81
    R_mass: float = 287.05
    z_b: float = 12e3                 # bottom of damping layer
    # thermodynamical (:57-61)
    R_gas: float = 8.314
    T_bg: float = 250.0
    # temporal (:64-66)
    t_end: float = 20.0
    n_frames: int = 100
    # floors (:74-76)
    rho_floor: float = 1e-6
    P_floor: float = 1e-10
    dtype: str = "float32"
    # Reference-faithful density omits the kernel self-term (the reference
    # calls apply!(compute_density!) with self=false, wcsph_perturbed_witch.jl
    # :317 + src/core.jl:151-156), which biases summed density to ~0.59·ρ_bg
    # under the adaptive-h fixed point and makes the static atmosphere drift.
    # self_density=True enables the standard self-inclusive summation.
    self_density: bool = False
    # neighbor-engine options: "bucket" layout keeps the state resident in
    # transposed cell buckets (zero-gather/zero-scatter pair sweeps; the fast
    # single-chip path); skin > 0 widens cells to (1+skin)·h and defers the
    # rescatter until a particle drifts by skin·h/2
    layout: str = "flat"
    skin: float = 0.0
    # use the fused Pallas pair-sweep kernel for the density/momentum
    # sweeps (requires layout="bucket"; skips empty bucket slots with
    # dynamic trip counts; compiles for the GPU, interpret mode elsewhere)
    use_pallas: bool = False
    # T/θ are pure diagnostics — nothing in the dynamics reads them (momentum
    # uses P/P′/ρ only). The reference recomputes them every step
    # (find_temperature!/find_pot_temp!, wcsph_perturbed_witch.jl:313-315);
    # with lazy_diagnostics=True they materialize once per frame instead
    # (run loops apply the scheme's finalize), trajectories bitwise identical.
    lazy_diagnostics: bool = False
    # Size bucket cells to exact multiples of the hexagonal lattice pitch:
    # cells = (2a, 2b) with a=(4/3)^¼dr columns, b=(3/4)^¼dr rows, so every
    # interior cell holds exactly 2 lattice columns × 2 rows = 4 particles.
    # Misaligned (isotropic skin) cells catch a 3rd lattice row in some
    # cells — occupancy 6 over a mean of 4.27 — and pair-sweep work is
    # provably ∝ kmax/o_avg, so alignment is worth ~1.4x on the pair passes.
    # Requires 2b = 1.861·dr ≥ h (true for η=1.8 with self-density ρ≈ρ_bg;
    # NOT for the reference-faithful no-self-density ρ→0.593ρ_bg fixed
    # point, whose h grows to 2.34·dr — the engine asserts). Drift slack
    # before a rescatter is (2b − h)/2 ≈ 0.03·dr: fine for the near-static
    # mountain-wave flows, too tight for violent ones.
    lattice_cells: bool = False
    # Bucket-capacity override. None -> measured occupancy + ~25% headroom
    # rounded to a multiple of 8 (NeighborEngine._estimate_cap). Every
    # 8 slots of cap multiply the whole pair-sweep cost, so for runs whose
    # occupancy provably never exceeds the initial lattice packing (static
    # atmospheres), cap = exact occupancy halves the sweep when the
    # estimate lands 8 higher. Overflow stays observable: rescatter drops
    # are counted in Neighbors.overflow — watch it when using this.
    bucket_cap: int | None = None
    # Exact checkpoint/resume (SURVEY §5; utils/checkpoint.py). With
    # checkpoint_every=k > 0 and an out_path, the run overwrites
    # <out_path>/checkpoint.npz every k frames (a resume point, not an
    # archive). resume="<path>.npz" restarts from that state bitwise
    # (same cfg -> same engine/slots), skipping the setup hook whose
    # effect the checkpoint already contains.
    checkpoint_every: int = 0
    resume: str = ""
    # boot from a saved ParaView frame instead of the lattice (the
    # reference's import_particles!/init_vtp restart idiom, src/IO.jl:
    # 83-122): positions + frame-exported fields from the file, everything
    # else rebuilt from the hydrostatic background at the saved positions.
    # Approximate by construction (m/h are re-derived); bitwise restart is
    # the npz `resume` channel.
    init_vtp: str = ""
    # per-frame terminal sparklines of the diagnostics (the reference's
    # unicodeplots-in-the-loop channel, wcsph_perturbed_witch.jl:15,393-405)
    live_plot: bool = False

    @property
    def dr(self) -> float:
        return self.dom_height / self.n_rows

    @property
    def bc_width(self) -> float:
        return self.bc_rows * self.dr

    @property
    def h0(self) -> float:
        return self.eta * self.dr

    @property
    def c(self) -> float:
        return float(np.sqrt(65e3 * (7 / 5) / self.rho0))  # (:40)

    @property
    def nu(self) -> float:
        return 0.1 * self.h0 * self.c  # (:43)

    @property
    def beta(self) -> float:
        return 2.0 * self.alpha  # (:46)

    @property
    def gamma_r(self) -> float:
        return 10.0 * self.N_bv  # (:52)

    @property
    def z_t(self) -> float:
        return self.dom_height  # (:54)

    @property
    def cp(self) -> float:
        return 7.0 * self.R_mass / 2.0

    @property
    def cv(self) -> float:
        return self.cp - self.R_mass

    @property
    def gamma(self) -> float:
        return self.cp / self.cv

    @property
    def dt(self) -> float:
        return 0.01 * self.h0 / self.c  # (:64)

    @property
    def jdtype(self):
        return jnp.float64 if self.dtype == "float64" else jnp.float32


# ------------------------------------------------------- background state

def background_density(cfg: WitchConfig, y):
    """ρ_bg(y) = ρ0 exp(−y g / (R T_bg)) (:177-179)."""
    return cfg.rho0 * np.exp(-np.asarray(y) * cfg.g / (cfg.R_mass * cfg.T_bg))


def background_pressure(cfg: WitchConfig, y):
    """P_bg = R T_bg ρ_bg (:181-184)."""
    return cfg.R_mass * cfg.T_bg * background_density(cfg, y)


def background_pot_temperature(cfg: WitchConfig, y):
    """θ_bg = T_bg ((T_bg R_gas ρ0)/P_bg)^(2/7) (:186-189)."""
    P_bg = background_pressure(cfg, y)
    return cfg.T_bg * ((cfg.T_bg * cfg.R_gas * cfg.rho0) / P_bg) ** (2.0 / 7.0)


# jnp variants for use inside jit
def background_density_j(cfg: WitchConfig, y):
    return cfg.rho0 * jnp.exp(-y * cfg.g / (cfg.R_mass * cfg.T_bg))


def background_pressure_j(cfg: WitchConfig, y):
    return cfg.R_mass * cfg.T_bg * background_density_j(cfg, y)


def background_pot_temperature_j(cfg: WitchConfig, y):
    P_bg = background_pressure_j(cfg, y)
    return cfg.T_bg * ((cfg.T_bg * cfg.R_gas * cfg.rho0) / P_bg) ** (2.0 / 7.0)


def witch_profile(cfg: WitchConfig, x):
    """Mountain profile hₘa²/(x²+a²) (:158); 0 when disabled."""
    x = np.asarray(x, dtype=np.float64)
    if cfg.a == 0.0:
        return np.zeros_like(x)
    return cfg.h_m * cfg.a**2 / (x**2 + cfg.a**2)


# ------------------------------------------------------------- geometry

def make_witch_system(cfg: WitchConfig, fields: dict,
                      extra_capacity: int = 0,
                      persistent: tuple = ()) -> ParticleSystem:
    """Domain + fence + mountain geometry and particle generation
    (make_system, src/current/wcsph_perturbed_witch.jl:152-170). ``fields``
    must include the scheme's per-particle variables; common init (background
    triplets, mass) is applied here; scheme-specific init afterwards."""
    grid = Grid(cfg.dr, "hexagonal")
    domain = Rectangle(-cfg.dom_length / 2.0, 0.0, cfg.dom_length / 2.0,
                       cfg.dom_height)
    fence = BoundaryLayer(domain, grid, cfg.bc_width)
    mountain = Specification(
        domain, lambda x: x[..., 1] <= witch_profile(cfg, x[..., 0]))

    sys = ParticleSystem(fields=fields, domain=domain + fence, h=cfg.h0,
                         dim=2, dtype=cfg.jdtype)
    sys.freeze_opts = {"layout": cfg.layout, "skin": cfg.skin}
    if persistent:
        # scheme-declared irreducible state: every other field is derived
        # post-rebuild before being read, so rescatters move only these
        sys.freeze_opts["persistent"] = tuple(persistent)
    if getattr(cfg, "bucket_cap", None):
        sys.freeze_opts["cap"] = cfg.bucket_cap
    if getattr(cfg, "lattice_cells", False):
        # exact hex-pitch cells (see WitchConfig.lattice_cells). The 1e-6
        # DOWNWARD nudge puts lattice points that sit exactly on a bin edge
        # robustly ABOVE it (x/L = k(1+1e-6) for edge points), immune to f32
        # position roundoff (~6e-8 relative); an upward nudge would drop
        # every exact-edge row/column into the previous bin, tripling the
        # first bin (measured: occupancy 8 at the origin cell).
        a = (4.0 / 3.0) ** 0.25 * cfg.dr
        b = (3.0 / 4.0) ** 0.25 * cfg.dr
        sys.freeze_opts["cells"] = (2.0 * a * (1.0 - 1e-6),
                                    2.0 * b * (1.0 - 1e-6))
    imported: set = set()
    if getattr(cfg, "init_vtp", ""):
        # boot from a saved ParaView frame (the reference's restart idiom,
        # src/IO.jl:83-122 / sph_jl/examples/cylinder.jl:84-89): positions
        # and every frame-exported field come from the file; fields the
        # frame does not carry are rebuilt from the hydrostatic background
        # at the SAVED positions below. Exact (bitwise) restart is the npz
        # checkpoint channel — this is the frame-as-initial-condition one.
        from ..io import import_particles, read_vtp
        imported = set(read_vtp(cfg.init_vtp)[1])
        import_particles(sys, cfg.init_vtp)
    else:
        generate_particles(sys, grid, domain - mountain,
                           lambda xs: {"type": FLUID})
        generate_particles(sys, grid, fence, lambda xs: {"type": WALL})
        generate_particles(sys, grid, mountain, lambda xs: {"type": FLUID})

    # hydrostatic isothermal init common to all schemes (:125-144);
    # frame-imported fields are left as loaded
    for chunk in sys._chunks:
        y = chunk["x"][:, 1]
        if "h" in chunk and "h" not in imported:
            chunk["h"] = np.full_like(y, cfg.h0)
        rho_bg = background_density(cfg, y)
        for name, val in [
            ("rho_bg", rho_bg), ("rho", rho_bg),
            ("P_bg", background_pressure(cfg, y)),
            ("P", background_pressure(cfg, y)),
            ("theta_bg", background_pot_temperature(cfg, y)),
            ("theta", background_pot_temperature(cfg, y)),
            ("T_bg", np.full_like(y, cfg.T_bg)),
            ("T", np.full_like(y, cfg.T_bg)),
            ("m", rho_bg * cfg.dr**2),
        ]:
            if name in chunk and name not in imported:
                chunk[name] = val
    return sys


# ----------------------------------------------------------- diagnostics

def velocity_diagnostics(state):
    """(u_avg, u_max) over all particles (avg_velocity/max_velocity,
    src/current/wcsph_perturbed_witch.jl:338-350)."""
    v = jnp.sqrt(jnp.sum(state.fields["v"] ** 2, axis=-1))
    return masked_mean(v, state.active), masked_max(v, state.active)


def monaghan_viscosity(cfg: WitchConfig, p, q, r, h_ij=None):
    """Monaghan artificial-viscosity acceleration contribution (α, β, ε form;
    e.g. wcsph_perturbed_witch.jl:275-285): −q.m·π_ij·rDw(h_ij,r)·x_pq for
    approaching pairs, else 0. Returns [N, K, 2]."""
    x_pq = p.x - q.x
    dot_pq = jnp.sum(x_pq * (p.v - q.v), axis=-1)
    if h_ij is None:
        h_ij = 0.5 * (p.h + q.h)
    ker = rDwendland2(h_ij, r)
    prho = jnp.maximum(p.rho, cfg.rho_floor)
    qrho = jnp.maximum(q.rho, cfg.rho_floor)
    c_i = jnp.sqrt(jnp.maximum(cfg.gamma * p.P / prho, 0.0))
    c_j = jnp.sqrt(jnp.maximum(cfg.gamma * q.P / qrho, 0.0))
    c_ij = 0.5 * (c_i + c_j)
    rho_ij = 0.5 * (prho + qrho)
    mu_ij = (h_ij * dot_pq) / (r * r + cfg.eps * h_ij * h_ij)
    pi_ij = (-cfg.alpha * c_ij * mu_ij + cfg.beta * mu_ij**2) / rho_ij
    visc = jnp.where(dot_pq < 0.0, -q.m * pi_ij * ker, 0.0)
    return visc[..., None] * x_pq


def background_entropy_j(cfg: WitchConfig, y):
    """A_bg = P_bg/ρ_bg^γ (full_hopkins_perturbed_witch.jl:198-202)."""
    return background_pressure_j(cfg, y) / background_density_j(cfg, y) ** cfg.gamma


def background_entropy(cfg: WitchConfig, y):
    return background_pressure(cfg, y) / background_density(cfg, y) ** cfg.gamma


def rayleigh_damping(cfg: WitchConfig, y):
    """Sponge acceleration above zₜ−zᵦ (damping_structure, :245-251).
    Faithful to the reference, including its z-independent magnitude."""
    mag = -cfg.gamma_r * jnp.sin(
        jnp.pi / 2 * (1.0 - (cfg.z_t - cfg.z_b) / cfg.z_b)) ** 2
    return jnp.where(y >= (cfg.z_t - cfg.z_b), mag, 0.0)
