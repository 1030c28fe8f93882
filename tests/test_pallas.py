"""Pallas pair-kernel gates: interpret mode on the CPU; the same kernel
compiles for the GPU through the Triton route, where the ``gpu``-marked
parity test runs it at the widths of the benchmarked configurations."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sph_mountain_waves_tpu.ops.pallas_pairs as pp
from sph_mountain_waves_tpu.models import wcsph_perturbed_witch as w
from sph_mountain_waves_tpu.models.witch_common import (
    WitchConfig, velocity_diagnostics,
)
from sph_mountain_waves_tpu.ops.apply import pair_sum
from sph_mountain_waves_tpu.kernels import wendland2


@pytest.fixture
def interpret_kernels(monkeypatch):
    orig = pp.make_pair_kernel_fn
    monkeypatch.setattr(pp, "make_pair_kernel_fn",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def test_density_kernel_matches_xla(interpret_kernels):
    cfg = WitchConfig(n_rows=10, dtype="float32", self_density=True,
                      layout="bucket", skin=0.2)
    sys_ = w.make_system(cfg)
    state = sys_.freeze()
    eng = sys_.engine
    state, nbrs = jax.jit(eng.rebuild)(state)
    ref = np.asarray(pair_sum(eng, state, nbrs,
                              lambda p, q, r: q.m * wendland2(p.h, r),
                              self_interaction=True))
    got = np.asarray(pp.density_pass(eng, state, cfg))
    act = np.asarray(state.active)
    np.testing.assert_allclose(got[act], ref[act], rtol=1e-5, atol=1e-6)


def _witch_state(**kw):
    cfg = WitchConfig(**{**dict(n_rows=10, dtype="float32", self_density=True,
                                layout="bucket", skin=0.2), **kw})
    sys_ = w.make_system(cfg)
    state = sys_.freeze()
    eng = sys_.engine
    state, nbrs = jax.jit(eng.rebuild)(state)
    return cfg, eng, state, nbrs


@pytest.mark.parametrize("tx", [128, 256])
def test_tile_width_bit_identical(interpret_kernels, monkeypatch, tx):
    """x-tiles of 128 lanes (three per 384-cell row) or 256 lanes (two per
    row, the second overhanging the row by 128 columns that the wrapper
    slices off) give the same bits as the interpreter's one 512-lane tile
    per row: each element's sum runs in the same order whatever the tiling.
    Density (static fields, self term) and momentum (two outputs, floor-
    padded h) both."""
    cfg, eng, state, _ = _witch_state(n_rows=36)
    assert eng.lims[0] == 384, eng.lims
    ref = [np.asarray(pp.density_pass(eng, state, cfg))] + [
        np.asarray(o) for o in pp.momentum_pass(eng, state, cfg)]
    wrapped = pp.make_pair_kernel_fn
    monkeypatch.setattr(pp, "make_pair_kernel_fn",
                        lambda *a, **k: wrapped(*a, **{**k, "tx": tx}))
    got = [np.asarray(pp.density_pass(eng, state, cfg))] + [
        np.asarray(o) for o in pp.momentum_pass(eng, state, cfg)]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("cap", [12, 24])
def test_kernel_cap_chunks_match_xla(interpret_kernels, cap):
    """Caps that are not a multiple of the 8-slot p chunk (12: a half-
    empty second chunk) or span three chunks (24, the terrain cap): density
    against pair_sum, momentum against the plain XLA sweep."""
    from sph_mountain_waves_tpu.ops.kernel_parity import reference_sweeps
    cfg, eng, state, nbrs = _witch_state(n_rows=8, bucket_cap=cap)
    assert eng.cap == cap
    assert int(np.asarray(state.active).sum()) == int(
        w.make_system(cfg).n_built)           # nothing dropped at this cap
    act = np.asarray(state.active)
    ref = np.asarray(pair_sum(eng, state, nbrs,
                              lambda p, q, r: q.m * wendland2(p.h, r),
                              self_interaction=True))
    got = np.asarray(pp.density_pass(eng, state, cfg))
    np.testing.assert_allclose(got[act], ref[act], rtol=1e-5, atol=1e-6)
    rng = np.random.default_rng(0)
    v = jnp.where(state.active[:, None],
                  jnp.asarray(rng.standard_normal(state.fields["v"].shape),
                              jnp.float32), 0.0)
    state = state.replace(v=v, rho=jnp.where(state.active, got, 0.0))
    got_m = [np.asarray(o) for o in pp.momentum_pass(eng, state, cfg)]
    with reference_sweeps():
        ref_m = [np.asarray(o) for o in pp.momentum_pass(eng, state, cfg)]
    for g, r in zip(got_m, ref_m):
        assert np.abs(g[act] - r[act]).max() <= 1e-5 * np.abs(r[act]).max()


def test_kernel_refuses_cpu_without_interpret():
    """Off the GPU the kernel raises instead of silently interpreting."""
    cfg, eng, state, _ = _witch_state()
    with pytest.raises(RuntimeError, match="GPU only"):
        pp.density_pass(eng, state, cfg)


def test_parity_check_interpret_small():
    """The card's parity check (ops/kernel_parity.py) runs end to end on
    the CPU for one small configuration: the Hopkins smoothed-pressure
    root (density-like) and two-kernel momentum (force-like) passes."""
    from sph_mountain_waves_tpu.ops import kernel_parity as kp
    recs = kp.check_kernel_parity(
        {"hopkins_total": kp.SMALL_CASES["hopkins_total"]}, interpret=True,
        log=lambda *_: None)
    assert [r["pass_"] for r in recs] == [
        "pressure_pass", "hopkins_momentum_pass", "hopkins_momentum_pass"]
    assert all(r["ok"] for r in recs)


@pytest.mark.gpu
def test_kernel_parity_on_card(gpu):
    """Every pass, compiled for the card, against the plain XLA sweep at the
    widths of the configurations that use it (ops/kernel_parity.py)."""
    from sph_mountain_waves_tpu.ops.kernel_parity import check_kernel_parity
    check_kernel_parity()


@pytest.mark.heavy
def test_full_step_pallas_matches_xla(interpret_kernels):
    outs = {}
    for up in (False, True):
        cfg = WitchConfig(n_rows=10, dtype="float32", self_density=True,
                          layout="bucket", skin=0.2, use_pallas=up)
        sys_ = w.make_system(cfg)
        state = sys_.freeze()
        step = jax.jit(w.make_step(cfg, sys_.engine))
        for _ in range(8):
            state = step(state)
        outs[up] = [float(v) for v in velocity_diagnostics(state)]
    assert outs[True][0] == pytest.approx(outs[False][0], rel=1e-5)
    assert outs[True][1] == pytest.approx(outs[False][1], rel=1e-5)


@pytest.mark.smoke
def test_row_kmax_band():
    cfg = WitchConfig(n_rows=10, dtype="float32", layout="bucket", skin=0.2)
    sys_ = w.make_system(cfg)
    state = sys_.freeze()
    eng = sys_.engine
    state, _ = jax.jit(eng.rebuild)(state)
    band_max, row_max = (np.asarray(a) for a in pp.row_kmax(eng, state))
    occ = np.asarray(state.active).reshape(eng.cap, eng.num_cells + 1)
    nx, ny = eng.lims
    per_row = occ[:, :eng.num_cells].sum(0).reshape(ny, nx).max(axis=1)
    for j in range(ny):
        band = per_row[max(0, j - 1): j + 2].max()
        assert band_max[j] >= band  # q trip count covers the stencil band
        assert row_max[j] >= per_row[j]  # p chunk bound covers the row


def _scheme_pallas_vs_xla(module, make_cfg, n_steps=8, rel=1e-5):
    outs, counts = {}, {}
    for up in (False, True):
        cfg = make_cfg(up)
        sys_ = module.make_system(cfg)
        state = sys_.freeze()
        step = jax.jit(module.make_step(cfg, sys_.engine))
        for _ in range(n_steps):
            state = step(state)
        outs[up] = [float(v) for v in velocity_diagnostics(state)]
        counts[up] = int(np.asarray(state.active).sum())
    # a NaN anywhere in the pallas path shows up as rebuild's failure screen
    # silently dropping particles (caught a 0·inf edge-row poisoning once) —
    # the count must match exactly, not just the velocity diagnostics
    assert counts[True] == counts[False]
    assert np.all(np.isfinite(outs[True])) and np.all(np.isfinite(outs[False]))
    assert outs[True][0] == pytest.approx(outs[False][0], rel=rel)
    assert outs[True][1] == pytest.approx(outs[False][1], rel=rel)


@pytest.mark.heavy
def test_hopkins_step_pallas_matches_xla(interpret_kernels):
    from sph_mountain_waves_tpu.models import hopkins_perturbed_witch as hp
    _scheme_pallas_vs_xla(hp, lambda up: WitchConfig(
        n_rows=10, dtype="float32", self_density=True,
        layout="bucket", skin=0.2, use_pallas=up))


@pytest.mark.heavy
def test_full_hopkins_step_pallas_matches_xla(interpret_kernels):
    from sph_mountain_waves_tpu.models import full_hopkins_perturbed_witch as fh
    _scheme_pallas_vs_xla(fh, lambda up: WitchConfig(
        n_rows=10, dtype="float32", self_density=True,
        layout="bucket", skin=0.2, use_pallas=up))


@pytest.mark.heavy
def test_hopkins_total_step_pallas_matches_xla(interpret_kernels):
    from sph_mountain_waves_tpu.models import hopkins_total_witch as ht
    _scheme_pallas_vs_xla(ht, lambda up: WitchConfig(
        n_rows=10, dtype="float32", self_density=True,
        layout="bucket", skin=0.2, use_pallas=up))


@pytest.mark.heavy
def test_collapse_dry_pallas_matches_xla(interpret_kernels):
    from sph_mountain_waves_tpu.models import collapse_dry as cd
    outs = {}
    for up in (False, True):
        cfg = cd.Config(dr=0.08, dtype="float32", layout="bucket",
                        skin=0.2, use_pallas=up, t_end=0.1)
        sys_ = cd.make_system(cfg)
        state = sys_.freeze()
        step, init = cd.make_step(cfg, sys_.engine)
        state = init(state)
        step = jax.jit(step)
        for _ in range(6):
            state = step(state)
        v = np.asarray(state.fields["v"])[np.asarray(state.active)]
        outs[up] = [float(np.abs(v).mean()), float(np.abs(v).max())]
    assert np.all(np.isfinite(outs[True]))
    np.testing.assert_allclose(outs[True], outs[False], rtol=1e-4)


@pytest.mark.heavy
def test_collapse3d_pallas_matches_xla(interpret_kernels):
    # exercises the 27-offset 3-D kernel path
    from sph_mountain_waves_tpu.models import collapse3d as c3
    outs = {}
    for up in (False, True):
        cfg = c3.Config(dr=2.0e-2, dtype="float32", layout="bucket",
                        skin=0.2, use_pallas=up, t_end=0.05)
        sys_ = c3.make_system(cfg)
        state = sys_.freeze()
        step = jax.jit(c3.make_step(cfg, sys_.engine))
        for _ in range(6):
            state = step(state)
        v = np.asarray(state.fields["v"])[np.asarray(state.active)]
        outs[up] = [float(np.abs(v).mean()), float(np.abs(v).max())]
    assert np.all(np.isfinite(outs[True]))
    np.testing.assert_allclose(outs[True], outs[False], rtol=1e-4)


def test_isph_witch_pallas_matches_xla(interpret_kernels):
    """Fused div/L/λ+viscous sweep, per-CG-iteration matvec kernel, and the
    pressure-gradient kernel vs the XLA closures. The CG solve runs the
    Pallas matvec inside lax.while_loop; f32 roundoff walks the iterates
    apart slightly, so the gate is on the stepped-state diagnostics."""
    from sph_mountain_waves_tpu.models import isph_witch as iw
    outs, counts = {}, {}
    for up in (False, True):
        cfg = iw.ISPHWitchConfig(n_rows=10, dtype="float32",
                                 layout="bucket", skin=0.2, use_pallas=up)
        sys_ = iw.make_system(cfg)
        state = sys_.freeze()
        # kick the fluid so the Poisson RHS is nonzero and the CG runs a
        # real (convergent) solve — the exactly-static start has b = 0,
        # where P is the atol early-exit, not an iterative solution
        rng = np.random.default_rng(3)
        f = state.fields
        state = state.replace(v=jnp.where(
            (f["type"] == 0.0)[:, None],
            jnp.asarray(0.1 * rng.standard_normal(f["v"].shape),
                        dtype=f["v"].dtype), f["v"]))
        step = jax.jit(iw.make_step(cfg, sys_.engine))
        for _ in range(4):
            state = step(state)
        act = np.asarray(state.active)
        v = np.asarray(state.fields["v"])[act]
        P = np.asarray(state.fields["P"])[act]
        assert np.isfinite(P).all()
        outs[up] = ([float(np.abs(v).mean()), float(np.abs(v).max())],
                    float(np.abs(P).mean()))
        counts[up] = int(act.sum())
    assert counts[True] == counts[False]
    assert np.all(np.isfinite(outs[True][0]))
    # the f32 CG stalls at its precision floor (rel_res ~7e-3, verified
    # identical at maxiter 200 vs 2000) and the stall iterate is
    # path-dependent, so raw P only matches at the percent level; the
    # projected *velocities* — the physics output — must agree tightly
    np.testing.assert_allclose(outs[True][0], outs[False][0], rtol=2e-3)
    assert outs[True][1] == pytest.approx(outs[False][1], rel=0.1)


def test_rayleigh_benard_pallas_matches_xla(interpret_kernels):
    # fused continuity+conduction pass and the shared dam-break force pass
    from sph_mountain_waves_tpu.models import rayleigh_benard as rb
    outs, counts = {}, {}
    for up in (False, True):
        cfg = rb.Config(n_rows=16, dtype="float32", layout="bucket",
                        skin=0.2, use_pallas=up)
        sys_ = rb.make_system(cfg)
        state = sys_.freeze()
        step = jax.jit(rb.make_step(cfg, sys_.engine))
        for _ in range(6):
            state = step(state)
        act = np.asarray(state.active)
        v = np.asarray(state.fields["v"])[act]
        T = np.asarray(state.fields["T"])[act]
        rho = np.asarray(state.fields["rho"])[act]
        outs[up] = [float(np.abs(v).mean()), float(np.abs(v).max()),
                    float(T.mean()), float(np.abs(rho - cfg.rho0).max())]
        counts[up] = int(act.sum())
    assert counts[True] == counts[False]
    assert np.all(np.isfinite(outs[True]))
    np.testing.assert_allclose(outs[True], outs[False], rtol=1e-4, atol=1e-8)


def test_pavelka_step_pallas_matches_xla(interpret_kernels):
    from sph_mountain_waves_tpu.models import pavelka_total_witch as pv
    _scheme_pallas_vs_xla(pv, lambda up: pv.PavelkaConfig(
        n_rows=10, dtype="float32", self_density=True,
        layout="bucket", skin=0.2, use_pallas=up))


@pytest.mark.parametrize("av", [0.0, 0.05], ids=["faithful", "av"])
def test_legacy_flow_step_pallas_matches_xla(interpret_kernels, av):
    """Terrain-baseline scheme (isothermal flow): the fused fixed-h0
    mass/force kernels against the apply_binary path, full steps incl.
    inflow recycling; mountain drag must agree too. av=0.05 wires the
    Monaghan artificial-viscosity branch (LegacyConfig.av_alpha) through
    both paths."""
    from sph_mountain_waves_tpu.models import legacy_witch as lw
    outs = {}
    for up in (False, True):
        cfg = lw.isothermal_flow_config(n_rows=16, dom_length=40e3,
                                        h_m=2000.0, a=6e3, dtype="float32",
                                        use_pallas=up, av_alpha=av)
        sys_ = lw.make_system(cfg)
        sys_.freeze_opts.update(capacity=int(sys_.n_built * 1.3),
                                rescatter_mode="sort", layout="bucket",
                                skin=0.15)
        state = sys_.freeze()
        step = jax.jit(lw.make_step(cfg, sys_.engine))
        for _ in range(8):
            state = step(state)
        F = lw.mountain_force(state)
        outs[up] = [float(v) for v in velocity_diagnostics(state)] + [
            float(F["drag"]), float(F["lift"])]
    assert np.all(np.isfinite(outs[True]))
    np.testing.assert_allclose(outs[True], outs[False], rtol=2e-4)


@pytest.mark.parametrize("av", [0.0, 0.05], ids=["faithful", "av"])
def test_iso_static_step_pallas_matches_xla(interpret_kernels, av):
    """Isothermal static scheme: the adaptive per-particle-h mass/force
    kernels against the apply_binary path; the evolving smoothing length
    (balance_of_smoothing integrates Dh from the Pallas Drho) must agree.
    av=0.05 wires the adaptive-h̄ Monaghan branch through both paths."""
    from sph_mountain_waves_tpu.models import legacy_witch as lw
    outs = {}
    for up in (False, True):
        cfg = lw.isothermal_static_config(n_rows=14, dom_length=40e3,
                                          h_m=2000.0, a=6e3, dtype="float32",
                                          use_pallas=up, av_alpha=av)
        sys_ = lw.make_system(cfg)
        sys_.freeze_opts.update(layout="bucket", skin=0.15)
        state = sys_.freeze()
        step = jax.jit(lw.make_step(cfg, sys_.engine))
        for _ in range(8):
            state = step(state)
        act = np.asarray(state.active)
        h = np.asarray(state.fields["h"])[act]
        rho = np.asarray(state.fields["rho"])[act]
        outs[up] = [float(v) for v in velocity_diagnostics(state)] + [
            float(h.mean()), float(np.abs(h - cfg.h0).max()),
            float(rho.mean())]
    assert np.all(np.isfinite(outs[True]))
    np.testing.assert_allclose(outs[True], outs[False], rtol=2e-4)


@pytest.mark.parametrize("flow,corrected", [
    (False, False), (True, False), (True, True),
], ids=["static", "flow", "flow_corrected"])
def test_adiabatic_step_pallas_matches_xla(interpret_kernels, flow, corrected):
    """Adiabatic legacy schemes: gated density + fused entropy+force
    kernels against the apply_binary path; entropy production must agree
    (it rides the fused sweep's both-FLUID gate). flow_corrected runs the
    corrected-physics bundle (the linear-drag configuration): ungated
    density with the FLUID|OUTFLOW p-side, Rayleigh sponge, consistent
    entropy — gates the Pallas path for quantitative drag runs."""
    from sph_mountain_waves_tpu.models import legacy_witch as lw
    factory = lw.adiabatic_flow_config if flow else lw.adiabatic_static_config
    extra = {}
    if corrected:
        extra = dict(true_rayleigh=True, consistent_entropy=True,
                     outflow_buffer=2 * 1.8 * (26e3 / 14), av_alpha=0.05)
    outs = {}
    for up in (False, True):
        cfg = factory(n_rows=14, dom_length=40e3, h_m=2000.0, a=6e3,
                      dtype="float32", use_pallas=up, **extra)
        sys_ = lw.make_system(cfg)
        sys_.freeze_opts.update(layout="bucket", skin=0.15)
        if flow:
            sys_.freeze_opts.update(capacity=int(sys_.n_built * 1.3),
                                    rescatter_mode="sort")
        state = sys_.freeze()
        step = jax.jit(lw.make_step(cfg, sys_.engine))
        for _ in range(8):
            state = step(state)
        act = np.asarray(state.active)
        S = np.asarray(state.fields["S"])[act]
        outs[up] = [float(v) for v in velocity_diagnostics(state)] + [
            float(S.sum()), float(np.abs(S).max())]
    assert np.all(np.isfinite(outs[True]))
    np.testing.assert_allclose(outs[True], outs[False], rtol=2e-4)
