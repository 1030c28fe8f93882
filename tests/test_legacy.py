"""Gates for the legacy suite: Kepler vortex, the four legacy witch schemes
(incl. inflow/outflow open boundaries), adiabatic_mass, and ICR."""
import numpy as np
import pytest

from sph_mountain_waves_tpu.models import adiabatic_mass as am
from sph_mountain_waves_tpu.models import kepler_vortex as kv
from sph_mountain_waves_tpu.models import legacy_witch as lw


@pytest.mark.smoke
def test_kepler_energy_conservation():
    out = kv.run(kv.Config(N_rings=15), n_orbits=0.05)
    E = out["E"]
    assert np.max(np.abs(E / E[0] - 1.0)) < 1e-6
    assert int(out["state"].n) == out["system"].n_built


@pytest.mark.parametrize("factory,kw", [
    (lw.isothermal_static_config, dict(n_rows=16)),
    (lw.adiabatic_static_config, dict(n_rows=16)),
], ids=["isothermal_static", "adiabatic_static"])
@pytest.mark.smoke
def test_legacy_static_schemes(factory, kw):
    cfg = factory(**kw, t_end=1.0, n_frames=2)
    out = lw.run(cfg)
    assert int(out["state"].n) == out["system"].n_built
    assert np.isfinite(out["u_avg"]).all()
    assert out["u_max"][-1] < 0.2 * cfg.c  # subsonic spurious motion


@pytest.mark.parametrize("factory,kw", [
    (lw.isothermal_flow_config, dict(n_rows=20)),
    (lw.adiabatic_flow_config, dict(n_rows=16)),
], ids=["isothermal_flow", "adiabatic_flow"])
def test_legacy_flow_schemes(factory, kw):
    cfg = factory(**kw, t_end=1.0, n_frames=2)
    out = lw.run(cfg)
    sys = out["system"]
    host = sys.host_fields()
    # inflow column exists and the run keeps (or grows) the particle count
    assert (host["type"] == lw.INFLOW).sum() > 0
    assert int(out["state"].n) >= sys.n_built * 0.95
    assert np.isfinite(out["u_avg"]).all()
    # no silent spawn loss (round 5): the run-loop rides the leak
    # detector; the direct drop counter must stay at zero
    assert int(np.asarray(out["spawn_drops"])[-1]) == 0


def test_mountain_wave_drag():
    """Wave drag on the terrain (BASELINE north-star observable): with a
    U=20 m/s wind over a resolved Witch of Agnesi the SPH force on the
    MOUNTAIN body has a robustly positive x-component; in the windless
    static atmosphere the same diagnostic cancels to force-summation noise
    (symmetric hydrostatic pressure), many orders below the hydrostatic
    lift. Discrimination gate, not a magnitude gate — the reference terrain
    is deep in the nonlinear (blocked-flow) regime where no closed form
    applies."""
    geo = dict(n_rows=24, dom_length=60e3, h_m=2000.0, a=6e3,
               t_end=9.0, n_frames=6, dtype="float64")
    out_flow = lw.run(lw.isothermal_flow_config(**geo))
    out_static = lw.run(lw.isothermal_static_config(**geo))
    drag_f, drag_s = out_flow["drag"], out_static["drag"]
    assert np.isfinite(drag_f).all() and np.isfinite(drag_s).all()
    assert (drag_f > 0).all()
    assert drag_f[-1] > 1e7  # measured ~1.5e8 at this resolution
    # static: x-cancellation noise ≪ the hydrostatic lift scale
    assert abs(drag_s[-1]) < 1e-6 * abs(out_static["lift"][-1])
    assert abs(drag_s[-1]) < 1e-6 * drag_f[-1]
    # terrain flow ran with zero dropped spawns (VERDICT r4 #6)
    assert int(np.asarray(out_flow["spawn_drops"])[-1]) == 0


def _active_fluid(state):
    act = np.asarray(state.active)
    typ = np.asarray(state.fields["type"])
    return act & (typ == lw.FLUID)


def test_consistent_entropy_recovers_T0():
    """The reference's adiabatic entropy init carries a stray γ
    (adiabatic_static_witch.jl:85 vs the EOS at :146), so T(ρ_init, s_init)
    = T0/γ ≈ 178.6 K, not T0 — every faithful adiabatic run boots 29% below
    hydrostatic pressure. consistent_entropy=True drops the γ so the EOS
    recovers T0 exactly."""
    kw = dict(n_rows=12, t_end=0.5, n_frames=1, dtype="float64")
    T_ratio = {}
    for flag in (False, True):
        out = lw.run(lw.adiabatic_static_config(consistent_entropy=flag, **kw))
        st = out["state"]
        fl = _active_fluid(st)
        T = np.asarray(st.fields["T"])[fl]
        T_ratio[flag] = float(np.mean(T)) / 250.0
    cfg = lw.adiabatic_static_config(**kw)
    assert abs(T_ratio[True] - 1.0) < 0.02
    assert abs(T_ratio[False] - 1.0 / cfg.gamma) < 0.05


def test_true_rayleigh_sponge_vs_faithful():
    """The faithful sponge is a constant downward BODY FORCE in the sponge
    region (damping_structure's z typo'd as z_b + accelerate! subtracting
    it unconditionally, isothermal_flow_witch.jl:192-198,213) — it drives
    mean subsidence there. The corrected −γ(z)·v Rayleigh damping
    (true_rayleigh=True) damps motion instead of creating it."""
    kw = dict(n_rows=16, t_end=2.0, n_frames=1, dtype="float64")
    w_sponge = {}
    for flag in (False, True):
        cfg = lw.isothermal_static_config(true_rayleigh=flag, **kw)
        out = lw.run(cfg)
        st = out["state"]
        fl = _active_fluid(st)
        y = np.asarray(st.fields["x"])[:, 1]
        in_sponge = fl & (y >= cfg.z_t - cfg.z_b)
        w_sponge[flag] = float(
            np.mean(np.asarray(st.fields["v"])[in_sponge, 1]))
    # both runs share the hydrostatic-lattice settling transient (~-0.5
    # m/s at t=2 s); the faithful body force roughly doubles the sponge
    # subsidence on top of it while the corrected damping suppresses it
    # (measured f64: faithful -1.30, corrected -0.54)
    assert w_sponge[False] < -0.8
    assert abs(w_sponge[True]) < 0.55 * abs(w_sponge[False])


def test_slot_targeted_spawn_matches_sort():
    """The stencil-mode spawn (add_new_particles' slot-TARGETED path:
    spawns placed in free slots of their home cells, _xref stamped, no
    forced rescatter) must reproduce the sort-mode run exactly across a
    real spawn event. Geometry from the sharded spawn gate: the boot
    inflow column sits ~333 m upstream of the edge and converts at
    U_max=20 after ~109 steps, so 120 steps spans conversion + spawn."""
    import jax

    cfg = lw.isothermal_flow_config(n_rows=12, dom_length=60e3,
                                    dtype="float64", layout="bucket",
                                    skin=0.3)
    outs, n_built = {}, None
    for mode in ("sort", "stencil"):
        sys_ = lw.make_system(cfg)
        sys_.freeze_opts["rescatter_mode"] = mode
        st = sys_.freeze()
        assert sys_.engine.effective_rescatter_mode == mode
        step = jax.jit(lw.make_step(cfg, sys_.engine))
        for _ in range(120):
            st = step(st)
        act = np.asarray(st.active)
        v = np.asarray(st.fields["v"])[act]
        s = np.sqrt((v ** 2).sum(-1))
        outs[mode] = (int(act.sum()), s.mean(), s.max(),
                      float(lw.mountain_force(st)["drag"]))
        n_built = sys_.n_built
        # spawn-drop counter (round 5): with default capacity headroom no
        # spawn may be dropped, in either placement path
        assert int(lw.inflow_reservoir(st)["spawn_drops"]) == 0
    assert outs["stencil"][0] > n_built          # the spawn event fired
    assert outs["stencil"][0] == outs["sort"][0]  # same particle count
    np.testing.assert_allclose(outs["stencil"][1:], outs["sort"][1:],
                               rtol=1e-12)


def test_spawn_drops_are_counted():
    """Silent spawn loss is forbidden (advisor round-3 finding): spawns
    with a valid source but no free slot must accumulate into the
    ``spawn_drops`` counter. Freeze the FLAT layout at capacity == n_built
    (zero pool headroom — bucket ignores ``capacity``, its slots are the
    grid) so EVERY respawn fails: the INFLOW reservoir then drains by
    exactly the counted drops."""
    import jax

    cfg = lw.isothermal_flow_config(n_rows=12, dom_length=60e3,
                                    dtype="float64")
    sys_ = lw.make_system(cfg)
    st = sys_.freeze(capacity=sys_.n_built)       # no free slots, ever
    assert sys_.engine.layout == "flat"
    n_inflow0 = int(lw.inflow_reservoir(st)["n_inflow"])
    step = jax.jit(lw.make_step(cfg, sys_.engine))
    for _ in range(120):
        st = step(st)
    diag = lw.inflow_reservoir(st)
    drops = int(diag["spawn_drops"])
    assert drops > 0                               # conversions did fire
    assert n_inflow0 - int(diag["n_inflow"]) == drops


def test_av_alpha_is_dissipative_and_conservative():
    """Monaghan artificial viscosity (LegacyConfig.av_alpha, the
    noise-control knob for the quantitative linear-drag runs): stepping
    the SAME pre-force state with av_alpha 0 and 1 isolates the AV
    acceleration exactly (av only enters internal_force; everything
    before the force evaluation is identical). The isolated term must be
    (a) active, (b) strictly dissipative (Σ m·v·ΔDv < 0), and (c) exactly
    momentum-conserving (the Π_pq pair force is antisymmetric)."""
    import jax
    import jax.numpy as jnp

    Dv, vf, m, act = {}, {}, None, None
    for av in (0.0, 1.0):
        cfg = lw.adiabatic_flow_config(
            n_rows=12, dom_length=40e3, h_m=500.0, a=6e3, dtype="float64",
            true_rayleigh=True, consistent_entropy=True, av_alpha=av)
        sys_ = lw.make_system(cfg)
        state = sys_.freeze()
        f = state.fields
        # lattice-scale (4·dr) velocity noise → plenty of approaching pairs
        x, y = f["x"][:, 0], f["x"][:, 1]
        k = 2 * np.pi / (4 * cfg.dr)
        fl = state.active & (f["type"] == lw.FLUID)
        noise = jnp.stack([3.0 * jnp.sin(k * x) * jnp.cos(k * y),
                           3.0 * jnp.cos(k * x) * jnp.sin(k * y)], -1)
        state = state.replace(v=jnp.where(fl[:, None], f["v"] + noise,
                                          f["v"]))
        s1 = jax.jit(lw.make_step(cfg, sys_.engine))(state)
        Dv[av] = np.asarray(s1.fields["Dv"])
        vf[av] = np.asarray(s1.fields["v"])
        m = np.asarray(s1.fields["m"])
        act = np.asarray(s1.active)
    dDv = (Dv[1.0] - Dv[0.0]) * act[:, None]
    m = m * act
    assert np.abs(dDv).max() > 0.1                       # wired and active
    assert float(np.sum(m[:, None] * vf[0.0] * dDv)) < 0  # dissipative
    # antisymmetric pair force: net momentum change ~ f64 roundoff
    net = np.abs((m[:, None] * dDv).sum(0))
    scale = (m[:, None] * np.abs(dDv)).sum(0)
    assert (net < 1e-12 * scale).all()


def test_outflow_buffer_conversion_and_freeze():
    """Open right boundary (outflow_buffer > 0): FLUID entering the last w
    of the domain converts to OUTFLOW, frozen at the prescribed flux (U, 0)
    and still advected — the reference's own OUTFLOW type (deleted at init,
    isothermal_flow_witch.jl:114) made into a working open boundary."""
    cfg = lw.isothermal_flow_config(
        n_rows=16, dom_length=80e3, t_end=1.0, n_frames=1, dtype="float64",
        outflow_buffer=2 * 1.8 * (26e3 / 16))
    out = lw.run(cfg)
    st = out["state"]
    act = np.asarray(st.active)
    typ = np.asarray(st.fields["type"])
    x = np.asarray(st.fields["x"])
    v = np.asarray(st.fields["v"])
    outflow = act & (typ == lw.OUTFLOW)
    assert outflow.sum() > 0
    np.testing.assert_allclose(v[outflow, 0], cfg.U_max, rtol=0, atol=1e-12)
    np.testing.assert_allclose(v[outflow, 1], 0.0, rtol=0, atol=1e-12)
    # every FLUID row past the conversion line has been converted (modulo
    # the one step of advection between to_outflow and the frame edge)
    x_out = cfg.dom_length / 2 - cfg.outflow_buffer
    fluid = _active_fluid(st)
    assert x[fluid, 0].max() <= x_out + cfg.U_max * cfg.dt + 1e-9
    assert np.isfinite(out["u_avg"]).all()


def test_wave_momentum_flux_reads_linear_drag():
    """Quantitative gate of the wave-drag observable: sample the ANALYTIC
    linear hydrostatic witch-of-Agnesi solution (uniform U, N; Boussinesq)
    ζ(x,z) = hₘ·a·(a·cos mz − x·sin mz)/(a²+x²), m = N/U, with
    w′ = U·ζₓ and u′ = −U·ζ_z, on a particle lattice; the band integral
    −Σ m·u′w′/dz must recover the closed form D = (π/4)·ρ·N·U·hₘ²
    at ANY band height (Eliassen–Palm flux is z-independent below
    dissipation). This is the observable the linear-drag run gates the
    end-to-end physics with (scripts/linear_drag.py)."""
    import jax.numpy as jnp
    from sph_mountain_waves_tpu.structs import ParticleState

    U, N_bv, h_m, a, rho = 20.0, 0.02, 300.0, 5e3, 1.0
    m_w = N_bv / U
    dr = 100.0
    X = 50 * a
    xs = np.arange(-X, X, dr) + 0.5 * dr
    z0, n_band = 4000.0, 4
    zs = z0 + (np.arange(n_band) - (n_band - 1) / 2) * dr
    xx, zz = np.meshgrid(xs, zs)
    denom = a**2 + xx**2
    zeta_x = h_m * a * (-np.sin(m_w * zz) * denom
                        - 2 * xx * (a * np.cos(m_w * zz)
                                    - xx * np.sin(m_w * zz))) / denom**2
    zeta_z = h_m * a * m_w * (-a * np.sin(m_w * zz)
                              - xx * np.cos(m_w * zz)) / denom
    up = -U * zeta_z
    wp = U * zeta_x
    n = xx.size
    fields = {
        "x": jnp.asarray(np.stack([xx.ravel(), zz.ravel()], -1)),
        "v": jnp.asarray(np.stack([U + up.ravel(), wp.ravel()], -1)),
        "m": jnp.full(n, rho * dr * dr),
        "type": jnp.zeros(n),
    }
    state = ParticleState(fields=fields, active=jnp.ones(n, bool))

    cfg = lw.LegacyConfig(U_max=U, flow=True)
    D_lin = (np.pi / 4) * rho * N_bv * U * h_m**2
    diag = lw.wave_momentum_flux(cfg, z0=z0, dz=n_band * dr)
    D = float(diag(state)["wave_flux"])
    np.testing.assert_allclose(D, D_lin, rtol=0.05)
    # the noise-cutting 3a x-window keeps ≤ ~5% truncation bias
    diag_w = lw.wave_momentum_flux(cfg, z0=z0, dz=n_band * dr, x_window=3 * a)
    np.testing.assert_allclose(float(diag_w(state)["wave_flux"]), D_lin,
                               rtol=0.10)
    # the scale-filtered (x-binned Reynolds filter) observable reads the
    # same resolved wave flux: bin_w = 1 km ≪ a = 5 km → O((bin_w/a)²)
    # bias on the wave, while sub-bin eddy flux (the washboard noise the
    # raw observable drowns in) averages out. Production geometry: 2-km
    # band (20 rows), 1-km bins → ~200 particles/bin; iid-noise σ scales
    # as m·σ²_u·√n_bin/dz — ~14x below the raw observable's √N_tot/dz.
    n_thick = 20
    zs_t = z0 + (np.arange(n_thick) - (n_thick - 1) / 2) * dr
    xx_t, zz_t = np.meshgrid(xs, zs_t)
    denom_t = a**2 + xx_t**2
    zeta_x_t = h_m * a * (-np.sin(m_w * zz_t) * denom_t
                          - 2 * xx_t * (a * np.cos(m_w * zz_t)
                                        - xx_t * np.sin(m_w * zz_t))) / denom_t**2
    zeta_z_t = h_m * a * m_w * (-a * np.sin(m_w * zz_t)
                                - xx_t * np.cos(m_w * zz_t)) / denom_t
    n_t = xx_t.size
    fields_t = {
        "x": jnp.asarray(np.stack([xx_t.ravel(), zz_t.ravel()], -1)),
        "v": jnp.asarray(np.stack([U - U * zeta_z_t.ravel(),
                                   U * zeta_x_t.ravel()], -1)),
        "m": jnp.full(n_t, rho * dr * dr),
        "type": jnp.zeros(n_t),
    }
    state_t = ParticleState(fields=fields_t, active=jnp.ones(n_t, bool))
    diag_b = lw.wave_momentum_flux_binned(cfg, z0=z0, dz=n_thick * dr,
                                          x_window=3 * a, bin_w=1000.0)
    np.testing.assert_allclose(float(diag_b(state_t)["wave_flux"]), D_lin,
                               rtol=0.10)
    # and it filters: superimpose zero-mean lattice-scale noise with
    # sigma_u >> wave amplitude; the binned reading stays near D_lin while
    # the raw one on the same state is swamped
    rng = np.random.default_rng(7)
    noise = 30.0 * rng.standard_normal((n_t, 2))
    state_n = ParticleState(
        fields={**fields_t, "v": fields_t["v"] + jnp.asarray(noise)},
        active=jnp.ones(n_t, bool))
    diag_w_t = lw.wave_momentum_flux(cfg, z0=z0, dz=n_thick * dr,
                                     x_window=3 * a)
    D_b_noisy = float(diag_b(state_n)["wave_flux"])
    D_raw_noisy = float(diag_w_t(state_n)["wave_flux"])
    assert abs(D_b_noisy - D_lin) < 0.5 * D_lin
    assert abs(D_b_noisy - D_lin) < 0.4 * abs(D_raw_noisy - D_lin)


def test_adiabatic_mass_expansion():
    cfg = am.Config(dr=0.04, t_end=0.4, n_frames=8)
    out = am.run(cfg)
    # gas escapes the left chamber monotonically (modulo bounce-back)
    assert out["left"][-1] < out["left"][0]
    # energy conserved (mu = 0: no entropy production, S constant)
    E = out["E"]
    assert np.max(np.abs(E / E[0] - 1.0)) < 1e-3
    S = out["S"]
    np.testing.assert_allclose(S, S[0], rtol=1e-12)
    A, lam, C = am.fit_left_decay(out["t"], out["left"].astype(float))
    assert lam >= 0.0


def test_adiabatic_mass_gram_determinant():
    cfg = am.Config(dr=0.08)
    sys = am.make_system(cfg)
    state = sys.freeze()
    det_scaled = am.gram_determinant(cfg, sys.engine, state)
    assert np.isfinite(det_scaled)


def test_icr_renormalization_reduces_density_error():
    import jax.numpy as jnp
    from sph_mountain_waves_tpu import Rectangle, ParticleSystem, Grid, generate_particles
    from sph_mountain_waves_tpu.kernels import wendland2
    from sph_mountain_waves_tpu.utils.icr import renormalize

    dr = 0.1
    h = 2.4 * dr
    dom = Rectangle(0.0, 0.0, 1.0, 1.0)
    sys = ParticleSystem(fields={"x": 2}, domain=dom, h=h, dim=2,
                         dtype=jnp.float64)
    generate_particles(sys, Grid(dr, "square"), dom, lambda xs: {})
    state = sys.freeze()

    # jitter + renormalize: the Newton iteration drives its own residual
    # |Σw − 1/dr²| down by orders of magnitude
    st3, info = renormalize(sys.engine, state, dr, max_steps=6, jitter=0.3,
                            return_info=True)
    errs = info["errs"]
    assert errs[-1] < 1e-2 * errs[0]
    assert np.isfinite(np.asarray(st3.fields["x"])).all()


def test_lj_floor_flow_scheme():
    """lj_floor (round 4): the terrain particles are replaced by LJ
    repulsion from the analytic witch surface — free-slip, washboard-free
    (the boundary linear wave theory actually assumes; wall closure form
    of sph_jl/examples/collapse_symplectic.jl:119-122)."""
    cfg = lw.adiabatic_flow_config(n_rows=16, t_end=1.0, n_frames=2,
                                   lj_floor=True)
    ljd = lw.lj_floor_drag(cfg)
    out = lw.run(cfg, extra_diag=ljd)
    host = out["system"].host_fields()
    # no MOUNTAIN particles exist — the floor is the analytic surface
    assert (host["type"] == lw.MOUNTAIN).sum() == 0
    assert np.isfinite(out["u_avg"]).all() and np.isfinite(out["drag"]).all()
    # the wall holds: no particle ends below the clamp depth (0.05*r0
    # above the surface is where the magnitude cap takes over)
    import jax.numpy as jnp
    f = out["state"].fields
    act = np.asarray(out["state"].active)
    d, _ = lw._floor_gap(cfg, f["x"])
    r0, _D = lw._lj_params(cfg)
    assert float(np.asarray(d)[act].min()) > -0.5 * r0


@pytest.mark.smoke
def test_lj_floor_acc_is_free_slip_and_capped():
    """Analytic properties of the LJ wall force: (a) the static force is
    parallel to the surface normal (free-slip: zero tangential drag on a
    tangentially sliding particle), (b) magnitude capped, (c) only the
    NORMAL velocity component is damped inside contact."""
    import jax.numpy as jnp
    cfg = lw.adiabatic_flow_config(n_rows=16, lj_floor=True)
    r0, D = lw._lj_params(cfg)
    xs = np.linspace(-2e3, 2e3, 41)
    # probe points a fixed normal distance above the surface
    x = np.stack([xs, np.zeros_like(xs)], axis=-1)
    d, n_hat = lw._floor_gap(cfg, jnp.asarray(x))
    pts = np.asarray(x) + (0.3 * r0 - np.asarray(d))[:, None] * np.asarray(n_hat)
    a0 = np.asarray(lw._lj_floor_acc(cfg, jnp.asarray(pts)))
    # the force is normal to the surface AT THE PROBE POINT — project on
    # the tangent recomputed there (the base-point normal differs by the
    # surface curvature over the 0.3·r0 offset)
    _, n_pts = lw._floor_gap(cfg, jnp.asarray(pts))
    n = np.asarray(n_pts)
    t = np.stack([-n[:, 1], n[:, 0]], axis=-1)
    # (a) static force has no tangential component
    assert np.abs(np.sum(a0 * t, axis=-1)).max() < 1e-6 * np.abs(a0).max()
    # (b) cap: even a deeply-penetrated point is bounded
    deep = np.asarray(x) + (0.01 * r0 - np.asarray(d))[:, None] * np.asarray(n_hat)
    a_deep = np.asarray(lw._lj_floor_acc(cfg, jnp.asarray(deep)))
    assert np.linalg.norm(a_deep, axis=-1).max() <= 20.0 * D * 1.0001
    # (c) a purely TANGENTIAL velocity adds no damping force
    v_t = 30.0 * t
    a_t = np.asarray(lw._lj_floor_acc(cfg, jnp.asarray(pts), jnp.asarray(v_t)))
    assert np.abs(a_t - a0).max() < 1e-6 * np.abs(a0).max()


def _analytic_linear_wave_state():
    """Particle cloud sampling the analytic steady linear hydrostatic
    witch wave (the closed form the quantitative drag gates reference):
    returns (state, cfg, D_lin, params)."""
    import jax.numpy as jnp
    from sph_mountain_waves_tpu.structs import ParticleState

    U, N_bv, h_m, a, rho = 20.0, 0.02, 300.0, 5e3, 1.0
    m_w = N_bv / U
    dr = 100.0
    X = 50 * a
    xs = np.arange(-X, X, dr) + 0.5 * dr
    zs = np.arange(500.0, 6500.0, dr)
    xx, zz = np.meshgrid(xs, zs)
    denom = a**2 + xx**2
    zeta_x = h_m * a * (-np.sin(m_w * zz) * denom
                        - 2 * xx * (a * np.cos(m_w * zz)
                                    - xx * np.sin(m_w * zz))) / denom**2
    zeta_z = h_m * a * m_w * (-a * np.sin(m_w * zz)
                              - xx * np.cos(m_w * zz)) / denom
    up = -U * zeta_z
    wp = U * zeta_x
    n = xx.size
    fields = {
        "x": jnp.asarray(np.stack([xx.ravel(), zz.ravel()], -1)),
        "v": jnp.asarray(np.stack([U + up.ravel(), wp.ravel()], -1)),
        "m": jnp.full(n, rho * dr * dr),
        "type": jnp.zeros(n),
    }
    state = ParticleState(fields=fields, active=jnp.ones(n, bool))
    cfg = lw.LegacyConfig(U_max=U, flow=True)
    D_lin = (np.pi / 4) * rho * N_bv * U * h_m**2
    params = dict(U=U, N_bv=N_bv, h_m=h_m, a=a, rho=rho, dr=dr,
                  up=up, wp=wp, xx=xx, zz=zz)
    return state, cfg, D_lin, params


def test_wave_momentum_flux_profile_is_z_independent():
    """The per-level flux profile (round-5 deficit-localization
    diagnostic) must read the SAME analytic linear flux at every level —
    EP flux is z-independent below dissipation — so a drop in a real run
    localizes real physics, not observable bias."""
    state, cfg, D_lin, p = _analytic_linear_wave_state()
    a = p["a"]
    levels = [1500.0, 2500.0, 3500.0, 4500.0, 5500.0]
    prof = lw.wave_momentum_flux_profile(cfg, levels, dz=1000.0,
                                         x_window=3 * a)
    out = prof(state)
    assert len(out) == len(levels)
    for z in levels:
        np.testing.assert_allclose(float(out[f"fp{int(z)}"]), D_lin,
                                   rtol=0.12)


def test_wave_amplitude_profile_reads_analytic_amplitude():
    """``wave_amplitude_profile`` (round-5 companion observable) must
    read the analytic wave's RMS ū′/w̄ per level — so a missing amplitude
    in a real run indicts generation/dissipation, not the observable."""
    state, cfg, D_lin, p = _analytic_linear_wave_state()
    a, xx, zz, up, wp = p["a"], p["xx"], p["zz"], p["up"], p["wp"]
    levels = [1500.0, 3500.0, 5500.0]
    amp = lw.wave_amplitude_profile(cfg, levels, dz=1000.0, x_window=3 * a)
    out = amp(state)
    for z in levels:
        sel = ((np.abs(xx) <= 3 * a) & (zz >= z - 500.0) & (zz < z + 500.0))
        # binning keeps the resolved wave: RMS of raw samples ≈ RMS of
        # bin means for structure at scales ≫ the bin (tol covers the
        # top-hat filter bias)
        np.testing.assert_allclose(float(out[f"ampu{int(z)}"]),
                                   np.sqrt(np.mean(up[sel] ** 2)),
                                   rtol=0.1)
        np.testing.assert_allclose(float(out[f"ampw{int(z)}"]),
                                   np.sqrt(np.mean(wp[sel] ** 2)),
                                   rtol=0.1)
