"""DFG flow-around-cylinder benchmark — dynamic particle count.

Rebuild of sph_jl/examples/cylinder.jl: channel flow past a cylinder with a
ramped parabolic inflow (:93-99), inflow-column recycling — when an INFLOW
particle crosses x ≥ 0 it becomes FLUID and a fresh INFLOW particle spawns
one bc_width upstream (add_new_particles!, :150-161) — and drag/lift
measured from the force on OBSTACLE particles against the published DFG
coefficients C_ref = (5.57953523384, 0.010618948146) (:163-216).

Dynamic N: spawning activates free rows of the fixed-capacity
state (outflow removal at x > chan_l frees rows each rebuild, so the slot
pool recycles — the fixed capacity only needs modest headroom).

The reference boots from a packaged VTP state (init/cylinder.vtp, :84-89);
here the initial condition is built geometrically (channel + fence +
obstacle + inflow column); ``import_particles`` can load a VTP instead.

Citations: constants :29-62, particle struct :67-82, inflow :93-99,
interactions :104-146, add_new_particles! :150-161, force :163-169,
main :171-216.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import BoundaryLayer, Circle, Rectangle, Specification
from ..grids import Grid
from ..kernels import rDwendland2
from ..ops.apply import apply_binary, apply_unary
from ..structs import ParticleState, ParticleSystem, generate_particles

FLUID = 0.0
INFLOW = 1.0
WALL = 2.0
OBSTACLE = 3.0


@dataclasses.dataclass(frozen=True)
class Config:
    chan_l: float = 2.2
    chan_w: float = 0.41
    cyl1: float = 0.2
    cyl2: float = 0.005
    cyl_r: float = 0.05
    n_around: int = 40            # dr = pi*cyl_r/n_around (:35)
    U_max: float = 0.3
    rho0: float = 1.0
    mu: float = 1.0e-3
    t_end: float = 40.0
    t_acc: float = 1.0
    n_frames: int = 200
    max_spawn: int = 128          # per-step spawn bound (static shape)
    dtype: str = "float64"

    @property
    def dr(self) -> float:
        return np.pi * self.cyl_r / self.n_around

    @property
    def h0(self) -> float:
        return 2.4 * self.dr

    @property
    def bc_width(self) -> float:
        return 6 * self.dr

    @property
    def m0(self) -> float:
        return self.rho0 * self.dr**2

    @property
    def c(self) -> float:
        return 20.0 * self.U_max

    @property
    def nu(self) -> float:
        return 0.1 * self.h0 * self.c

    @property
    def dt(self) -> float:
        return 0.1 * self.h0 / self.c

    @property
    def t_measure(self) -> float:
        return self.t_end / 2

    @property
    def jdtype(self):
        return jnp.float64 if self.dtype == "float64" else jnp.float32


FIELDS = {"x": 2, "v": 2, "a": 2, "rho": 0, "Drho": 0, "h": 0, "Dh": 0,
          "P": 0, "m": 0, "type": 0}


def make_system(cfg: Config, init_vtp: str | None = None) -> ParticleSystem:
    x2_min = -cfg.chan_w / 2 - cfg.bc_width
    x2_max = cfg.chan_w / 2 + cfg.bc_width
    domain = Rectangle(-cfg.bc_width, x2_min, cfg.chan_l, x2_max)
    sys = ParticleSystem(fields=FIELDS, domain=domain, h=cfg.h0, dim=2,
                         dtype=cfg.jdtype,
                         defaults={"rho": cfg.rho0, "h": cfg.h0, "m": cfg.m0})
    if init_vtp is not None:
        from ..io import import_particles
        import_particles(sys, init_vtp)
        return sys

    grid = Grid(cfg.dr, "hexagonal")
    channel = Rectangle(0.0, -cfg.chan_w / 2, cfg.chan_l, cfg.chan_w / 2)
    cyl = Circle(cfg.cyl1, cfg.cyl2, cfg.cyl_r)
    walls = Specification(BoundaryLayer(channel, grid, cfg.bc_width),
                          lambda x: (x[..., 0] > 0) & (x[..., 0] < cfg.chan_l))
    inflow = Rectangle(-cfg.bc_width, -cfg.chan_w / 2, -1e-9, cfg.chan_w / 2)
    generate_particles(sys, grid, channel - cyl, lambda xs: {"type": FLUID})
    generate_particles(sys, grid, cyl, lambda xs: {"type": OBSTACLE})
    generate_particles(sys, grid, walls, lambda xs: {"type": WALL})
    generate_particles(sys, grid, inflow, lambda xs: {"type": INFLOW})
    return sys


def make_step(cfg: Config, engine):
    dt = cfg.dt

    def set_inflow_speed(u, t):
        s = jnp.minimum(1.0, t / cfg.t_acc)
        v1 = s * cfg.U_max * (1.0 - (2.0 * u.x[:, 1] / cfg.chan_w) ** 2)
        v = jnp.stack([v1, jnp.zeros_like(v1)], axis=-1)
        return {"v": jnp.where((u.type == INFLOW)[:, None], v, u.v)}  # (:93-99)

    def balance_of_mass(p, q, r):
        ker = q.m * rDwendland2(p.h, r)
        conv = ker * jnp.sum((p.x - q.x) * (p.v - q.v), axis=-1)
        both = (p.type == FLUID) & (q.type == FLUID)
        diff = jnp.where(both, 2 * cfg.nu / p.rho * (p.rho - q.rho), 0.0)
        return {"Drho": conv + diff}  # (:104-111)

    def find_pressure(u):
        upd = u.x[:, 0] >= -cfg.bc_width + cfg.h0
        rho = jnp.where(upd, u.rho + u.Drho * dt, u.rho)
        return {"rho": rho, "Drho": jnp.zeros_like(u.Drho),
                "P": cfg.c**2 * (rho - cfg.rho0)}  # (:112-120)

    def internal_force(p, q, r):
        ker = q.m * rDwendland2(p.h, r)
        x_pq = p.x - q.x
        a = -(ker * (p.P / p.rho**2 + q.P / q.rho**2))[..., None] * x_pq
        visc = (8.0 * ker * cfg.mu / (p.rho * q.rho)
                * jnp.sum((p.v - q.v) * x_pq, axis=-1)
                / (r * r + 0.01 * p.h * p.h))
        return {"a": a + visc[..., None] * x_pq}  # (:122-128)

    def move(u):
        mob = ((u.type == FLUID) | (u.type == INFLOW))[:, None]
        return {"x": jnp.where(mob, u.x + dt * u.v, u.x),
                "a": jnp.zeros_like(u.a)}

    def stir(u):
        # the reference's artificial radial forcing toward the cylinder axis
        # ("gravity", :137-142)
        fx = cfg.cyl1 - u.x[:, 0]
        fy = -u.x[:, 1]
        absf2 = fx**2 + u.x[:, 1] ** 2
        return 0.3 * cfg.U_max**2 * jnp.stack([fx, fy], axis=-1) / absf2[:, None]

    def accelerate(u):
        fluid = (u.type == FLUID)[:, None]
        return {"v": jnp.where(fluid, u.v + 0.5 * dt * (u.a + stir(u)), u.v)}

    def add_new_particles(state: ParticleState) -> ParticleState:
        """INFLOW crossing x≥0 → FLUID; spawn INFLOW one bc_width upstream
        into free rows (:150-161)."""
        f = state.fields
        n = state.capacity
        conv = state.active & (f["type"] == INFLOW) & (f["x"][:, 0] >= 0.0)
        new_type = jnp.where(conv, FLUID, f["type"])

        k = cfg.max_spawn
        src_score = jnp.where(conv, jnp.arange(n, dtype=jnp.int32), jnp.int32(n))
        src = jnp.argsort(src_score)[:k]
        src_ok = conv[src]
        free_score = jnp.where(state.active, jnp.int32(n),
                               jnp.arange(n, dtype=jnp.int32))
        tgt = jnp.argsort(free_score)[:k]
        ok = src_ok & ~state.active[tgt]
        tgt_safe = jnp.where(ok, tgt, n)

        spawn_x = f["x"][src] - jnp.asarray([cfg.bc_width, 0.0], f["x"].dtype)
        fields = dict(f)
        fields["type"] = new_type.at[tgt_safe].set(INFLOW, mode="drop")
        fields["x"] = f["x"].at[tgt_safe].set(spawn_x, mode="drop")
        zero2 = jnp.zeros((k, 2), f["v"].dtype)
        fields["v"] = f["v"].at[tgt_safe].set(zero2, mode="drop")
        fields["a"] = f["a"].at[tgt_safe].set(zero2, mode="drop")
        for name, val in [("rho", cfg.rho0), ("Drho", 0.0), ("h", cfg.h0),
                          ("Dh", 0.0), ("P", 0.0), ("m", cfg.m0)]:
            fields[name] = f[name].at[tgt_safe].set(
                jnp.full(k, val, f[name].dtype), mode="drop")
        active = state.active.at[tgt_safe].set(ok, mode="drop")
        return ParticleState(fields=fields, active=active)

    def obstacle_force(state):
        """C = 2·Σ m·a / (L_char·U_mean²) over OBSTACLE rows (:163-169)."""
        f = state.fields
        mask = (state.active & (f["type"] == OBSTACLE))[:, None]
        F = jnp.sum(jnp.where(mask, f["m"][:, None] * f["a"], 0.0), axis=0)
        U_mean = 2.0 / 3.0 * cfg.U_max
        return 2.0 * F / (0.1 * U_mean**2)

    def step(carry):
        state, t, C_acc, nsamp = carry
        t = t + dt
        state = apply_unary(state, accelerate)
        state = apply_unary(state, move)
        state = add_new_particles(state)
        state = apply_unary(state, set_inflow_speed, t=t)
        state, nbrs = engine.rebuild(state)
        state = apply_binary(engine, state, nbrs, balance_of_mass)
        state = apply_unary(state, find_pressure)
        state = apply_binary(engine, state, nbrs, internal_force)
        measure = t > cfg.t_measure
        C_acc = C_acc + jnp.where(measure, obstacle_force(state), 0.0)
        nsamp = nsamp + jnp.where(measure, 1, 0)
        state = apply_unary(state, accelerate)
        return (state, t, C_acc, nsamp)

    return step


def run(cfg: Config = Config(), out_path: str | None = None,
        verbose: bool = False, capacity_factor: float = 1.5,
        init_vtp: str | None = None):
    from ..io import new_pvd_file, save_frame, save_pvd_file

    sys = make_system(cfg, init_vtp=init_vtp)
    state = sys.freeze(capacity=int(sys.n_built * capacity_factor))
    step = make_step(cfg, sys.engine)

    n_steps = int(round(cfg.t_end / cfg.dt))
    steps_per_frame = max(1, int(round(cfg.t_end / cfg.n_frames / cfg.dt)))

    @partial(jax.jit, donate_argnums=0)
    def run_frame(carry):
        def body(c, _):
            return step(c), None
        carry, _ = jax.lax.scan(body, carry, None, length=steps_per_frame)
        return carry

    out = new_pvd_file(out_path) if out_path else None
    dtype = cfg.jdtype
    carry = (state, jnp.zeros((), dtype), jnp.zeros(2, dtype),
             jnp.zeros((), jnp.int32))
    ns, Cs = [], []
    k = 0
    while k < n_steps:
        carry = run_frame(carry)
        k += steps_per_frame
        state, t, C_acc, nsamp = carry
        ns.append(int(state.n))
        C = np.asarray(C_acc) / max(int(nsamp), 1)
        Cs.append(C)
        if verbose:
            print(f"t = {float(t):.3f}  N = {ns[-1]}  C_drag = {C[0]:.4f}  "
                  f"C_lift = {C[1]:.5f}")
        if out:
            save_frame(out, state, "v", "P", "rho", "type", time=float(t))
    if out:
        save_pvd_file(out)
    C_ref = np.array([5.57953523384, 0.010618948146])
    C_SPH = Cs[-1]
    rel = np.linalg.norm(C_SPH - C_ref) / np.linalg.norm(C_ref)
    sys.state = state
    return {"C_SPH": C_SPH, "C_ref": C_ref, "relative_error": rel,
            "n": np.asarray(ns), "state": state, "system": sys}
