"""3-D mountain-wave gates (the BASELINE stretch configuration):
static atmosphere stays near-static in 3-D, the 27-offset Pallas path
matches XLA, and the slab-sharded bucket run matches single-device."""
import jax
import numpy as np
import pytest

from sph_mountain_waves_tpu.models import witch3d as w3
from sph_mountain_waves_tpu.models.witch_common import (
    FLUID, velocity_diagnostics,
)

# bc_rows=3 (> kernel support h ≈ 2.3·dr) instead of the production 6: at
# n_rows=6 the fence is as thick as the domain and dominates grid/CPU cost
TINY = dict(n_rows=6, dom_length=60e3, dom_depth=10e3, bc_rows=3,
            self_density=True)


def run_steps(cfg, n, with_setup=False):
    sys = w3.make_system(cfg)
    state = sys.freeze()
    if with_setup:
        state = w3.setup(cfg, sys.engine, state)
    step = jax.jit(w3.make_step(cfg, sys.engine))
    for _ in range(n):
        state = step(state)
    return sys, state


@pytest.mark.smoke
def test_witch3d_static_atmosphere():
    """Hydrostatic 3-D init + mass renormalization must stay near-static
    (u_max << c ≈ 255 m/s) and conserve particles. Without renormalization
    the cubic-lattice summation bias (~11%) becomes a body force."""
    cfg = w3.Witch3DConfig(dtype="float64", **TINY)
    sys, state = run_steps(cfg, 12, with_setup=True)
    act = np.asarray(state.active)
    v = np.asarray(state.fields["v"])[act]
    assert np.isfinite(v).all()
    assert int(state.n) == sys.n_built
    assert float(np.max(np.linalg.norm(v, axis=1))) < 1.0  # m/s


def test_witch3d_mass_renormalization_converges():
    """After setup the kernel-summed density must equal the hydrostatic
    background to <0.1% in the bulk."""
    from sph_mountain_waves_tpu.models.witch_common import background_density
    cfg = w3.Witch3DConfig(dtype="float64", **TINY)
    sys = w3.make_system(cfg)
    state = sys.freeze()
    state = w3.setup(cfg, sys.engine, state)
    step = jax.jit(w3.make_step(cfg, sys.engine))
    state = step(state)  # one step recomputes rho by summation
    act = np.asarray(state.active)
    x = np.asarray(state.fields["x"])[act]
    rho = np.asarray(state.fields["rho"])[act]
    ratio = rho / background_density(cfg, x[:, 2])
    assert abs(np.median(ratio) - 1.0) < 1e-3


def test_witch3d_mass_element_is_cubic():
    cfg = w3.Witch3DConfig(dtype="float64", **TINY)
    sys = w3.make_system(cfg)
    host = sys.host_fields()
    from sph_mountain_waves_tpu.models.witch_common import background_density
    np.testing.assert_allclose(
        host["m"], background_density(cfg, host["x"][:, 2]) * cfg.dr**3)


@pytest.mark.heavy
def test_witch3d_pallas_matches_xla(monkeypatch):
    """27-offset density+momentum Pallas passes vs the XLA cell-dense path
    on the same bucket-layout trajectory (interpret mode on CPU)."""
    import sph_mountain_waves_tpu.ops.pallas_pairs as pp
    orig = pp.make_pair_kernel_fn
    monkeypatch.setattr(pp, "make_pair_kernel_fn",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    outs = {}
    for up in (False, True):
        # eta=1.2 keeps bucket occupancy (and the interpret-mode unroll,
        # which scales with cap x 27 offsets) ~5x smaller than eta=1.8
        cfg = w3.Witch3DConfig(dtype="float32", layout="bucket", skin=0.15,
                               use_pallas=up, eta=1.2, **TINY)
        sys, state = run_steps(cfg, 3)
        act = np.asarray(state.active)
        v = np.asarray(state.fields["v"])[act]
        outs[up] = [float(np.abs(v).mean()), float(np.abs(v).max())]
    assert np.all(np.isfinite(outs[True]))
    np.testing.assert_allclose(outs[True], outs[False], rtol=1e-4)


@pytest.mark.heavy
def test_witch3d_bucket_sharded_matches_single_device():
    """The stretch config's sharded path: slab-local bucket decomposition of
    the 3-D witch must reproduce the single-device run exactly."""
    from sph_mountain_waves_tpu.parallel.bucket import (
        build_bucket_sharding, make_bucket_runner, shard_state_bucket)
    from sph_mountain_waves_tpu.parallel.domain import make_mesh

    cfg = w3.Witch3DConfig(dtype="float64", layout="bucket", skin=0.3,
                           eta=1.2, **TINY)
    sys1, st1 = run_steps(cfg, 6)
    u1 = [float(v) for v in velocity_diagnostics(st1)]

    sys2 = w3.make_system(cfg)
    sys2.freeze()
    mesh = make_mesh(8)
    bds = build_bucket_sharding(sys2, 8)
    state = shard_state_bucket(bds, sys2, mesh)
    run_frame, diag = make_bucket_runner(
        bds, mesh, lambda e: w3.make_step(cfg, e), steps_per_frame=6)
    state = run_frame(state)
    ua, um, n = diag(state)
    assert int(n) == sys2.n_built
    np.testing.assert_allclose([float(ua), float(um)], u1, rtol=1e-10)


def test_stretch_config_sizing():
    """stretch_config() must size the BASELINE 3-D stretch at 2M+ particles
    (checked analytically — no host build at full size in the suite)."""
    cfg = w3.stretch_config()
    n_fluid = (cfg.dom_length / cfg.dr) * (cfg.dom_depth / cfg.dr) \
        * (cfg.dom_height / cfg.dr)
    assert n_fluid >= 2.0e6
    assert cfg.layout == "bucket" and cfg.use_pallas
    # bucket cells must be EXACTLY 2 lattice spacings wide: any other ratio
    # aliases against the cubic lattice (3 planes/axis in ~7% of cells ->
    # occupancy 27 -> cap 40 -> ~5x slot memory)
    assert cfg.lattice_cells
    # n_rows=12 -> dr=26000/12 is NOT exactly representable: the regression
    # case for per-point bin-edge flips (22% overflow drops un-nudged)
    cfg12 = w3.stretch_config(**{**TINY, "n_rows": 12})
    sys = w3.make_system(cfg12)
    cells = sys.freeze_opts["cells"]
    assert all(c == pytest.approx(2.0 * cfg12.dr, rel=1e-5) for c in cells)
    # the 1e-6 DOWNWARD nudge: edge points must land robustly above edges
    assert all(c < 2.0 * cfg12.dr for c in cells)
    import numpy as np
    pos = sys.host_fields()["x"]
    st = sys.freeze()
    eng = sys.engine
    ci = np.clip(np.floor(pos / np.asarray(eng.cell_size)).astype(np.int64)
                 - np.asarray(eng.phase), 0, np.asarray(eng.lims) - 1)
    key = ci[:, 0] + eng.lims[0] * (ci[:, 1] + eng.lims[1] * ci[:, 2])
    occ = np.bincount(key)
    assert occ.max() <= 8, occ.max()


@pytest.mark.heavy
def test_witch3d_production_sharded_run_applies_setup(tmp_path):
    """run_sharded_witch_bucket generalizes to the 3-D model: y-slabs by
    default, the mass-renormalization setup hook applied before sharding
    (boot chunks alone would drop it), artifacts exported, and the
    trajectory matching a single-device run WITH setup."""
    from sph_mountain_waves_tpu import read_vtp
    from sph_mountain_waves_tpu.parallel.run import run_sharded_witch_bucket

    cfg = w3.Witch3DConfig(dtype="float64", layout="bucket", skin=0.3,
                           eta=1.2, renorm_iters=2, **TINY)
    sys1, st1 = run_steps(cfg, 6, with_setup=True)
    u1 = [float(v) for v in velocity_diagnostics(st1)]

    out = run_sharded_witch_bucket(cfg, n_dev=8, n_frames=1,
                                   steps_per_frame=6, model=w3,
                                   out_path=str(tmp_path / "w3"))
    # tiny domain: y has too few cell planes for 8 devices, so the
    # adaptive default falls back to x (production stretch grids pick y —
    # see test_pick_slab_axis)
    assert out["sharding"].slab_w >= 2
    np.testing.assert_allclose([out["u_avg"][-1], out["u_max"][-1]], u1,
                               rtol=1e-10)
    pts, fields = read_vtp(str(tmp_path / "w3" / "frame1.vtp"))
    assert len(pts) == sys1.n_built


def test_pick_slab_axis():
    """Adaptive slab-axis default: y for production-shaped 3-D grids
    (nx is one 128-lane quantum), x in 2-D, fallback when an axis is too
    shallow for the ghost depth."""
    from sph_mountain_waves_tpu.ops.neighbors import NeighborEngine
    from sph_mountain_waves_tpu.parallel.bucket import pick_slab_axis

    def eng(lims):
        return NeighborEngine(dim=len(lims), h=1.0,
                              phase=(0,) * len(lims), lims=lims, cap=8)

    assert pick_slab_axis(eng((384, 88, 48)), 8) == 1   # stretch-shaped
    assert pick_slab_axis(eng((384, 8, 48)), 8) == 2    # y too shallow
    assert pick_slab_axis(eng((384, 8, 8)), 8) == 0     # only x scales
    assert pick_slab_axis(eng((1152, 16)), 8) == 0      # 2-D witch
    # narrow-x 2-D grid: x-slabs round straight back to the 128-lane
    # quantum (zero shrink) — the heuristic must measure that, not just
    # prefer x in 2-D
    assert pick_slab_axis(eng((128, 512)), 8) == 1
