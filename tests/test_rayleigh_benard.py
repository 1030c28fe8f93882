"""Rayleigh-Bénard convection gates (BASELINE.json config #2): a seeded
perturbation must GROW into convection (KE up orders of magnitude, Nusselt
proxy > 1) above the critical Rayleigh number and DECAY to pure conduction
(Nu = 1) below it — the classic onset discrimination."""
import numpy as np
import pytest

from sph_mountain_waves_tpu.models import rayleigh_benard as rb


def test_convection_onset_discrimination():
    sup = rb.run(rb.Config(n_rows=20, Ra=1e6, t_end=8.0, n_frames=8))
    sub = rb.run(rb.Config(n_rows=20, Ra=300.0, t_end=8.0, n_frames=8))

    # supercritical: seeded roll grows into convection
    assert sup["KE"][-1] > 0.3
    assert sup["KE"][-1] > 30 * sup["KE"][2]
    assert sup["Nu"][-1] > 1.3

    # subcritical: conduction state, no sustained motion
    assert sub["KE"][-1] < 1e-3
    assert abs(sub["Nu"][-1] - 1.0) < 0.02
    assert np.all(np.isfinite(sub["KE"])) and np.all(np.isfinite(sup["KE"]))

    # particle budget intact in both
    assert int(sup["state"].n) == sup["system"].n_built
    assert int(sub["state"].n) == sub["system"].n_built


def test_config_dimensionless_control():
    # Ra and Pr uniquely set nu and kappa
    cfg = rb.Config(Ra=1e5, Pr=2.0)
    Ra_back = cfg.g * cfg.beta * cfg.dT * cfg.H**3 / (cfg.nu * cfg.kappa)
    assert abs(Ra_back / cfg.Ra - 1) < 1e-12
    assert abs(cfg.nu / cfg.kappa - cfg.Pr) < 1e-12


def test_rayleigh_benard_checkpoint_resume(tmp_path):
    """cfg-driven exact restart (SURVEY §5) on the thermal-convection
    model: resumed KE/Nu match the uninterrupted run bitwise."""
    base = dict(n_rows=24, t_end=0.2, n_frames=4, dtype="float64")
    full = rb.run(rb.Config(**base))

    p1 = tmp_path / "p1"
    rb.run(rb.Config(**{**base, "t_end": 0.1, "n_frames": 2,
                        "checkpoint_every": 2}), out_path=str(p1))
    res = rb.run(rb.Config(**base, resume=str(p1 / "checkpoint.npz")))
    assert len(res["KE"]) < len(full["KE"])
    assert res["t"][-1] == full["t"][-1]
    assert res["KE"][-1] == full["KE"][-1]
    assert res["Nu"][-1] == full["Nu"][-1]


def test_conduction_operator_consistency():
    """Point-wise quantitative gate on the conduction operator: for
    T' = sin(pi x)sin(pi y) on the boot lattice, the SPH Laplacian
    DT = kappa * sum 2(m/rho_q)(T_p - T_q) rDw must reproduce
    kappa * lap(T') to the square-lattice quadrature factor (0.974 at
    h = 2 dr). Guards the diffusivity normalization — the conductivity
    form (an extra 1/rho_0) under-conducted by 1000x and silently killed
    convection below Ra ~ 3e4 (caught by a mode-decay audit in round 3)."""
    import jax
    import jax.numpy as jnp

    from sph_mountain_waves_tpu.kernels import rDwendland2
    from sph_mountain_waves_tpu.ops.apply import apply_binary

    cfg = rb.Config(n_rows=24, aspect=1.0, Ra=1e-3, beta=1e-8,
                    seed_amp=0.0, dtype="float64")
    sys = rb.make_system(cfg)
    for chunk in sys._chunks:
        x, y = chunk["x"][:, 0], chunk["x"][:, 1]
        fl = chunk["type"] == rb.FLUID
        chunk["T"] = chunk["T"] + np.where(
            fl, 0.02 * np.sin(np.pi * np.clip(x, 0, 1))
            * np.sin(np.pi * np.clip(y, 0, 1)), 0.0)
    st = sys.freeze()
    eng = sys.engine
    st, nbrs = jax.jit(eng.rebuild)(st)
    m, h, kap = cfg.m, cfg.h, cfg.kappa

    def heat(p, q, r):  # the model's heat_conduction (conducting walls)
        ker = 2.0 * m * kap / q.rho * rDwendland2(h, r)
        return {"DT": jnp.where(p.type == rb.FLUID, ker * (p.T - q.T), 0.0)}

    st = st.replace(DT=jnp.zeros_like(st.fields["DT"]))
    st = apply_binary(eng, st, nbrs, heat)
    f = st.fields
    act = np.asarray(st.active)
    xy = np.asarray(f["x"])
    fl = act & (np.asarray(f["type"]) == rb.FLUID)
    mid = (fl & (xy[:, 0] > 0.3) & (xy[:, 0] < 0.7)
           & (xy[:, 1] > 0.3) & (xy[:, 1] < 0.7))
    Tp = (0.02 * np.sin(np.pi * xy[:, 0]) * np.sin(np.pi * xy[:, 1]))
    expect = -kap * 2 * np.pi ** 2 * Tp
    ratio = np.asarray(f["DT"])[mid] / expect[mid]
    assert abs(ratio.mean() - 0.974) < 0.03      # lattice quadrature factor
    assert ratio.std() < 1e-6                    # uniform on the lattice


@pytest.mark.slow
def test_nusselt_ra1e4_published_value():
    """Quantitative Nu(Ra) point (slow gate): steady square-cavity RB at
    Ra=1e4 with adiabatic sidewalls — the configuration of the published
    benchmark (Ouertatani et al. 2008: Nu = 2.158). A strong seed skips
    the slow linear growth; Nu is averaged over the saturated plateau.
    Measured convergence (rounds 3-5): 1.81 (24 rows) / 1.90 (32) /
    1.95 (48) / 1.96 (64, bucket layout) — the sequence saturates at ~0.91
    of the published value (kernel smoothing of the thermal boundary
    layer at h = 2dr; the same ~9% deficit holds at the second published
    point, Nu(1e5) = 3.54 vs 3.91). Round 5 tightens the round-3 15%
    gate to the measured convergence: 48 rows within 13% (measured
    bucket-path value 1.933 = 10.4% off; flat round-3 value 1.95)."""
    cfg = rb.Config(n_rows=48, aspect=1.0, Ra=1e4, sidewalls="adiabatic",
                    seed_amp=0.3, t_end=60.0, n_frames=20,
                    layout="bucket", skin=0.15)
    out = rb.run(cfg)
    nu = float(np.mean(out["Nu"][-8:]))
    assert abs(nu / 2.158 - 1.0) < 0.13, nu


@pytest.mark.slow
def test_nusselt_ra1e5_published_value():
    """Second published Nu(Ra) point (round 5): Ra = 1e5, same square
    adiabatic cavity (Ouertatani et al. 2008: Nu = 3.91). Measured on
    the bucket layout in round 5: Nu = 3.54 at 48 rows (9.4% below, the
    same thermal-BL smoothing deficit as Ra=1e4) — gate at 12%."""
    cfg = rb.Config(n_rows=48, aspect=1.0, Ra=1e5, sidewalls="adiabatic",
                    seed_amp=0.3, t_end=30.0, n_frames=20,
                    layout="bucket", skin=0.15)
    out = rb.run(cfg)
    nu = float(np.mean(out["Nu"][-8:]))
    assert abs(nu / 3.91 - 1.0) < 0.12, nu


@pytest.mark.smoke
def test_rkpm_conduction_exact_at_walls():
    """conduction="rkpm" (round-4): on the boot lattice with a quadratic
    T-profile, the RKPM Laplacian reads kappa*lap(T) exactly EVERYWHERE —
    including fluid rows adjacent to the plates and the adiabatic
    sidewalls, where the cleary form is inconsistent (sidewall rows are
    excluded from its sum with no compensation). Also: no quadrature
    factor — the correction absorbs the 0.974 lattice bias."""
    import jax

    from sph_mountain_waves_tpu.utils.rkpm import corrected_laplacian

    cfg = rb.Config(n_rows=20, aspect=1.0, Ra=1e-3, beta=1e-8,
                    seed_amp=0.0, sidewalls="adiabatic", dtype="float64")
    sys = rb.make_system(cfg)
    a2, b1 = 0.35, -0.2
    for chunk in sys._chunks:
        y = chunk["x"][:, 1]
        chunk["T"] = 0.7 + b1 * y + a2 * y * y  # quadratic: lap = 2*a2
    st = sys.freeze()
    eng = sys.engine
    st, nbrs = jax.jit(eng.rebuild)(st)
    f = st.fields
    inc = st.active & (np.asarray(f["type"]) != rb.WALL_ADIA)
    import jax.numpy as jnp
    lap = np.asarray(corrected_laplacian(
        eng, st, nbrs, f["T"], include_q=jnp.asarray(inc),
        vol_of=lambda q: cfg.m / jnp.maximum(q.rho, 1e-30)))
    act = np.asarray(st.active)
    fl = act & (np.asarray(f["type"]) == rb.FLUID)
    # every fluid row, including the ones hugging plates and sidewalls
    np.testing.assert_allclose(lap[fl], 2 * a2, rtol=5e-3, atol=1e-5)


def test_rkpm_conduction_short_run_stable():
    """Short supercritical run with conduction="rkpm": finite, bounded T
    (the RKPM Laplacian is not an M-matrix — guard against instability),
    and the seeded roll still grows."""
    out = rb.run(rb.Config(n_rows=16, Ra=1e6, t_end=8.0, n_frames=8,
                           conduction="rkpm"))
    T = np.asarray(out["state"].fields["T"])[np.asarray(out["state"].active)]
    assert np.isfinite(T).all()
    assert T.min() > -0.7 and T.max() < 1.7
    assert np.all(np.isfinite(out["KE"]))
    # the seeded roll grows out of the early transient dip into convection
    # (measured: KE ≈ 0.013 at frame 2 → 0.39 at frame 8, matching cleary
    # to ~0.3% — the correction changes the boundary operator, not the
    # bulk dynamics)
    assert out["KE"][-1] > 10 * out["KE"][2]
