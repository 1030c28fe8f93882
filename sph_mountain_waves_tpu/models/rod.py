"""2-D elastic rod (SPH elasticity).

Rebuild of sph_jl/examples/rod.jl: per-particle distortion A, kernel
correction matrix H, stress B from the energy derivative (:86-95, :124-139),
first-Piola-type force with the "eta" correction terms required for energy
conservation (:141-156), pull force & Dirichlet clamp by *Lagrangian*
coordinate X (:158-170), and the energy-conservation audit (:186-194).

Matrices are [N, 2, 2] fields; the 2-D-specialized algebra of the reference
(:45-81) becomes batched closed-form 2×2 ops.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import Rectangle
from ..grids import Grid
from ..kernels import rDwendland2, wendland2
from ..ops.apply import apply_binary, apply_unary
from ..structs import ParticleState, ParticleSystem, generate_particles
from .common import frame_runner, masked_sum


@dataclasses.dataclass(frozen=True)
class Config:
    L: float = 2.0          # rod length (:19, inferred)
    W: float = 0.5
    r_free: float = 1.0
    pull_force: float = 1.0
    pull_time: float = 0.5
    c_l: float = 20.0
    c_s: float = 200.0
    rho0: float = 1.0
    nu: float = 1.0e-4
    n_width: int = 16       # dr = W/n_width
    t_end: float = 5.0
    n_plot: int = 400
    dtype: str = "float64"

    @property
    def c_0(self) -> float:
        return float(np.sqrt(self.c_l**2 + 4.0 / 3.0 * self.c_s**2))

    @property
    def dr(self) -> float:
        return self.W / self.n_width

    @property
    def h(self) -> float:
        return 2.5 * self.dr

    @property
    def vol(self) -> float:
        return self.dr**2

    @property
    def m(self) -> float:
        return self.rho0 * self.vol

    @property
    def dt(self) -> float:
        return 0.1 * self.h / self.c_0

    @property
    def jdtype(self):
        return jnp.float64 if self.dtype == "float64" else jnp.float32


# batched 2x2 helpers (reference :45-81)
def outer2(x, y):
    return x[..., :, None] * y[..., None, :]


def det2(A):
    return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]


def inv2(A):
    idet = 1.0 / det2(A)
    out = jnp.stack([
        jnp.stack([A[..., 1, 1], -A[..., 0, 1]], axis=-1),
        jnp.stack([-A[..., 1, 0], A[..., 0, 0]], axis=-1)], axis=-2)
    return idet[..., None, None] * out


def trans2(A):
    return jnp.swapaxes(A, -1, -2)


def dev2(G):
    # deviatoric with the implicit G33 = 1 (reference :74-81)
    lam = (G[..., 0, 0] + G[..., 1, 1] + 1.0) / 3.0
    out = G - lam[..., None, None] * jnp.eye(2, dtype=G.dtype)
    return out, (1.0 - lam)  # 2x2 block and the (3,3) element


def mv(A, x):
    # HIGHEST: a default-precision f32 product may run in reduced precision
    # (TF32 on the GPU) — the 2x2 elasticity algebra needs full f32/f64
    return jnp.einsum("...ij,...j->...i", A, x,
                      precision=jax.lax.Precision.HIGHEST)


def mm(A, B):
    # batched 2x2 product at full precision (see mv)
    return jnp.matmul(A, B, precision=jax.lax.Precision.HIGHEST)


def make_system(cfg: Config) -> ParticleSystem:
    grid = Grid(cfg.dr, "hexagonal")
    rod = Rectangle(0.0, 0.0, cfg.L, cfg.W)
    dom = Rectangle(-cfg.r_free, -cfg.r_free, cfg.L + cfg.r_free,
                    cfg.W + cfg.r_free)
    sys = ParticleSystem(
        fields={"x": 2, "v": 2, "f": 2, "X": 2, "A": (2, 2), "H": (2, 2),
                "B": (2, 2), "e": 0},
        domain=dom, h=cfg.h, dim=2, dtype=cfg.jdtype)
    generate_particles(sys, grid, rod, lambda xs: {"X": xs[:, :2]})
    return sys


def make_step(cfg: Config, engine):
    dt, m, h, vol = cfg.dt, cfg.m, cfg.h, cfg.vol

    def find_A(p, q, r):
        ker = wendland2(h, r)
        x_pq = p.x - q.x
        X_pq = p.X - q.X
        return {"A": -ker[..., None, None] * outer2(X_pq, x_pq),
                "H": -ker[..., None, None] * outer2(x_pq, x_pq)}

    def find_B(u):
        Hi = inv2(u.H)
        A = mm(u.A, Hi)
        At = trans2(A)
        G = mm(At, A)
        P = cfg.c_l**2 * (det2(A) - 1.0)
        G0, _ = dev2(G)
        B = mm(m * (P[..., None, None] * inv2(At) + cfg.c_s**2 * mm(A, G0)),
               Hi)
        return {"A": A, "B": B}

    def find_f(p, q, r):
        ker = wendland2(h, r)
        rDker = rDwendland2(h, r)
        x_pq = p.x - q.x
        X_pq = p.X - q.X
        f = -ker[..., None] * mv(trans2(p.A), mv(p.B, x_pq))
        f = f - ker[..., None] * mv(trans2(q.A), mv(q.B, x_pq))
        # eta correction (:148-152)
        k_pq = mv(trans2(p.B), X_pq - mv(p.A, x_pq))
        k_qp = -mv(trans2(q.B), X_pq - mv(q.A, x_pq))
        f = f + (rDker * jnp.sum(x_pq * k_pq, axis=-1))[..., None] * x_pq \
              + ker[..., None] * k_pq
        f = f - (rDker * jnp.sum(x_pq * k_qp, axis=-1))[..., None] * x_pq \
              - ker[..., None] * k_qp
        f = f + (2 * m * vol * rDker * cfg.nu)[..., None] * (p.v - q.v)
        return {"f": f}

    def pull(u, t):
        on = (u.X[:, 0] > cfg.L - h) & (t < cfg.pull_time)
        fy = vol * cfg.pull_force / (h * cfg.W)
        return {"f": u.f + jnp.where(on, fy, 0.0)[:, None]
                * jnp.asarray([0.0, 1.0], u.f.dtype)}

    def update_v(u):
        v = u.v + 0.5 * dt * u.f / m
        clamp = u.X[:, 0] < h  # Dirichlet clamp (:160-165)
        return {"v": jnp.where(clamp[:, None], 0.0, v)}

    def update_x(u):
        return {"x": u.x + dt * u.v,
                "H": jnp.zeros_like(u.H), "A": jnp.zeros_like(u.A),
                "f": jnp.zeros_like(u.f), "e": jnp.zeros_like(u.e)}

    def find_e(p, q, r):
        eta = mv(inv2(p.A), p.X - q.X) - (p.x - q.x)
        return {"e": jnp.sum(eta * eta, axis=-1)}

    def force_computation(state, nbrs, t):
        state = apply_binary(engine, state, nbrs, find_A)
        state = apply_unary(state, find_B)
        state = apply_binary(engine, state, nbrs, find_f)
        state = apply_unary(state, pull, t=t)
        return state

    def step(carry):
        state, t = carry
        state = apply_unary(state, update_v)
        state = apply_unary(state, update_x)
        state, nbrs = engine.rebuild(state)
        state = force_computation(state, nbrs, t)
        state = apply_unary(state, update_v)
        return (state, t + dt)

    return step, force_computation, find_e


def particle_energy(cfg: Config, state: ParticleState):
    f = state.fields
    A = f["A"]
    d = jnp.abs(det2(A))
    G = mm(trans2(A), A)
    G0, g33 = dev2(G)
    E_kin = 0.5 * cfg.m * jnp.sum(f["v"] ** 2, axis=-1)
    fro2 = jnp.sum(G0**2, axis=(-2, -1)) + g33**2
    E_shear = 0.25 * cfg.m * cfg.c_s**2 * fro2
    d_safe = jnp.maximum(d, 1e-12)
    E_press = cfg.m * cfg.c_l**2 * (d_safe - 1.0 - jnp.log(d_safe))
    return masked_sum(E_kin + E_shear + E_press, state.active)


def run(cfg: Config = Config(), out_path: str | None = None,
        verbose: bool = False):
    from functools import partial

    from ..io import new_pvd_file, save_frame, save_pvd_file

    sys = make_system(cfg)
    state = sys.freeze()
    step, force_computation, find_e = make_step(cfg, sys.engine)

    @jax.jit
    def init(state):
        state, nbrs = sys.engine.rebuild(state)
        return force_computation(state, nbrs, 0.0)

    state = init(state)
    n_steps = int(round(cfg.t_end / cfg.dt))
    steps_per_plot = max(1, int(round(cfg.t_end / cfg.n_plot / cfg.dt)))

    @partial(jax.jit, donate_argnums=0)
    def run_chunk(carry):
        def body(c, _):
            return step(c), None
        carry, _ = jax.lax.scan(body, carry, None, length=steps_per_plot)
        return carry

    # top-right corner particle amplitude (reference :183)
    def tip_height(state):
        f = state.fields
        score = jnp.where(state.active,
                          jnp.abs(f["x"][:, 0]) + jnp.abs(f["x"][:, 1]), -1.0)
        return f["x"][jnp.argmax(score), 1]

    out = new_pvd_file(out_path) if out_path else None
    carry = (state, jnp.zeros((), cfg.jdtype))
    ts, amps, Es = [], [], []
    k = 0
    while k < n_steps:
        carry = run_chunk(carry)
        k += steps_per_plot
        state, t = carry
        ts.append(float(t))
        amps.append(float(tip_height(state)))
        Es.append(float(particle_energy(cfg, state)))
        if verbose:
            print(f"t = {ts[-1]:.3f}  tip = {amps[-1]:.4f}  E = {Es[-1]:.6e}")
        if out:
            save_frame(out, state, "v", "A", "e", time=ts[-1])
    if out:
        save_pvd_file(out)
    sys.state = state
    return {"t": np.asarray(ts), "amplitude": np.asarray(amps),
            "E": np.asarray(Es), "state": state, "system": sys}
