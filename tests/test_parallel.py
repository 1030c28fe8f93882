"""Multi-chip domain-decomposition gates on the 8-device virtual CPU mesh:
sharded runs must match single-device physics, conserve particles across
migration, and the 3-D stretch configuration must compile and step."""
import jax
import numpy as np
import pytest

from sph_mountain_waves_tpu.models import wcsph_perturbed_witch as w
from sph_mountain_waves_tpu.models import collapse3d as c3
from sph_mountain_waves_tpu.models.witch_common import (
    WitchConfig, velocity_diagnostics,
)
from sph_mountain_waves_tpu.parallel.domain import make_mesh, shard_state
from sph_mountain_waves_tpu.parallel.run import (
    build_domain_sharding, make_sharded_runner, run_sharded_witch,
)


@pytest.mark.smoke
def test_sharded_witch_matches_single_device():
    cfg = WitchConfig(n_rows=14, dtype="float64", self_density=True)
    sys = w.make_system(cfg)
    state = sys.freeze()
    step = jax.jit(w.make_step(cfg, sys.engine))
    for _ in range(10):
        state = step(state)
    u_avg1, u_max1 = (float(v) for v in velocity_diagnostics(state))

    out = run_sharded_witch(cfg, n_dev=8, n_frames=1, steps_per_frame=10)
    assert out["n"][-1] == sys.n_built  # migration conserves particles
    assert out["u_avg"][-1] == pytest.approx(u_avg1, rel=1e-12)
    assert out["u_max"][-1] == pytest.approx(u_max1, rel=1e-12)


def test_sharded_3d_stretch_config():
    # 3-D mountain-wave-scale stretch: dam-break physics in 3-D, slab-sharded
    # over 8 devices (BASELINE.json stretch config at reduced size)
    cfg = c3.Config(dr=0.02, dtype="float64")
    sys = c3.make_system(cfg)
    sys.freeze()
    mesh = make_mesh(8)
    ds = build_domain_sharding(sys, 8)
    state = shard_state(ds, sys.state, mesh)
    run_frame, diag = make_sharded_runner(
        ds, mesh, lambda eng: c3.make_step(cfg, eng), steps_per_frame=3)
    state = run_frame(state)
    u_avg, u_max, n = diag(state)
    assert int(n) == sys.n_built
    assert np.isfinite(float(u_avg)) and np.isfinite(float(u_max))


def test_migration_across_slabs():
    # particles given a strong x-velocity must migrate between devices
    # without loss
    import jax.numpy as jnp
    from sph_mountain_waves_tpu import Rectangle, ParticleSystem
    from sph_mountain_waves_tpu.ops.apply import apply_unary

    dom = Rectangle(0.0, 0.0, 8.0, 1.0)
    sys = ParticleSystem(fields={"x": 2, "v": 2}, domain=dom, h=0.25, dim=2,
                         dtype=jnp.float64)
    rng = np.random.default_rng(3)
    xs = np.stack([rng.uniform(1.2, 6.8, size=500),
                   rng.uniform(0.05, 0.95, size=500)], axis=-1)
    vs = np.stack([rng.uniform(-1.0, 1.0, size=500),
                   np.zeros(500)], axis=-1)  # x-drift only: stay in-domain
    sys.add_particles(xs, {"v": vs})
    sys.freeze()
    mesh = make_mesh(8)
    ds = build_domain_sharding(sys, 8)
    state = shard_state(ds, sys.state, mesh)

    def make_step(engine):
        def step(state):
            state = apply_unary(state, lambda u: {"x": u.x + 0.05 * u.v})
            state, _ = engine.rebuild(state)
            return state
        return step

    run_frame, diag = make_sharded_runner(ds, mesh, make_step,
                                          steps_per_frame=5)
    for _ in range(4):  # 20 steps: each particle moves up to 1.0 in x
        state = run_frame(state)
    _, _, n = diag(state)
    assert int(n) == 500  # every migrant arrived somewhere


# ---------------------------------------------------------------- bucket

def _bucket_setup(cfg, n_dev=8):
    from sph_mountain_waves_tpu.parallel.bucket import (
        build_bucket_sharding, shard_state_bucket)
    sys = w.make_system(cfg)
    sys.freeze()
    mesh = make_mesh(n_dev)
    bds = build_bucket_sharding(sys, n_dev)
    state = shard_state_bucket(bds, sys, mesh)
    return sys, mesh, bds, state


def test_bucket_sharded_matches_single_device():
    """Slab-local bucket decomposition (parallel/bucket.py): per-device
    grids are local, halos are column-block ppermutes — must reproduce the
    single-device bucket run and conserve particles (VERDICT r1 item 5)."""
    from sph_mountain_waves_tpu.parallel.bucket import make_bucket_runner

    cfg = WitchConfig(n_rows=14, dtype="float64", self_density=True,
                      layout="bucket", skin=0.3)
    sys1 = w.make_system(cfg)
    st1 = sys1.freeze()
    step1 = jax.jit(w.make_step(cfg, sys1.engine))
    for _ in range(10):
        st1 = step1(st1)
    u1 = [float(v) for v in velocity_diagnostics(st1)]

    sys2, mesh, bds, state = _bucket_setup(cfg)
    run_frame, diag = make_bucket_runner(
        bds, mesh, lambda e: w.make_step(cfg, e), steps_per_frame=10)
    state = run_frame(state)
    ua, um, n = diag(state)
    assert int(n) == sys2.n_built
    np.testing.assert_allclose([float(ua), float(um)], u1, rtol=1e-10)


@pytest.mark.parametrize("rescatter_mode,slab_axis",
                         [("stencil", 0), ("sort", 0),
                          ("stencil", 1), ("sort", 1)])
def test_bucket_sharded_migration_conserves(rescatter_mode, slab_axis):
    """Strong winds force repeated collective rescatters + slab crossings;
    every migrant must arrive somewhere — under both the stencil (default)
    and sort-payload collective rescatters, and for both x-slabs and
    y-slabs (the long axis differs per workload; witch3d slabs y)."""
    import jax.numpy as jnp
    from sph_mountain_waves_tpu import Rectangle, ParticleSystem
    from sph_mountain_waves_tpu.ops.apply import apply_unary
    from sph_mountain_waves_tpu.parallel.bucket import (
        build_bucket_sharding, shard_state_bucket, make_bucket_runner)

    dom = Rectangle(0.0, 0.0, 8.0, 8.0)
    sys = ParticleSystem(fields={"x": 2, "v": 2}, domain=dom, h=0.25, dim=2,
                         dtype=jnp.float64)
    rng = np.random.default_rng(3)
    xs = np.stack([rng.uniform(1.2, 6.8, size=500),
                   rng.uniform(1.2, 6.8, size=500)], axis=-1)
    vs = np.stack([rng.uniform(-1.0, 1.0, size=500),
                   rng.uniform(-1.0, 1.0, size=500)], axis=-1)
    sys.add_particles(xs, {"v": vs})
    # random-walk clustering can exceed the boot-estimated cap (overflow
    # drops are counted, but this test asserts NO loss) — pin cap high
    sys.freeze(layout="bucket", skin=0.3, cap=24,
               rescatter_mode=rescatter_mode)
    mesh = make_mesh(8)
    bds = build_bucket_sharding(sys, 8, slab_axis=slab_axis)
    state = shard_state_bucket(bds, sys, mesh)

    def make_step(engine):
        def step(state):
            state = apply_unary(state, lambda u: {"x": u.x + 0.05 * u.v})
            state, _ = engine.rebuild(state)
            return state
        return step

    run_frame, diag = make_bucket_runner(bds, mesh, make_step,
                                         steps_per_frame=5)
    for _ in range(4):  # 20 steps: each particle moves up to 1.0 in x
        state = run_frame(state)
    _, _, n = diag(state)
    assert int(n) == 500


@pytest.mark.heavy
def test_bucket_sharded_balanced_slabs_dam_break():
    """Load-balanced (variable-width) slab partition: the dam-break boot
    state concentrates most particles in the left quarter of the box, so
    equal-WIDTH slabs idle most devices (step time = max over devices under
    synchronous collectives). ``balance=True`` picks equal-PARTICLE column
    boundaries; the balanced run must (a) reproduce the single-device
    trajectory, (b) conserve particles through migration, (c) split
    ownership measurably more evenly than the uniform partition."""
    from sph_mountain_waves_tpu.models import collapse_dry as cd
    from sph_mountain_waves_tpu.parallel.bucket import (
        _owned_mask_flat, build_bucket_sharding, make_bucket_runner,
        shard_state_bucket)

    n_dev = 4
    cfg = cd.Config(dr=0.04, dtype="float64", layout="bucket", skin=0.3)
    sys1 = cd.make_system(cfg)
    st1 = sys1.freeze()
    step1, init1 = cd.make_step(cfg, sys1.engine)
    st1 = jax.jit(init1)(st1)
    step1 = jax.jit(step1)
    for _ in range(10):
        st1 = step1(st1)
    u1 = [float(v) for v in velocity_diagnostics(st1)]

    sys2 = cd.make_system(cfg)
    sys2.freeze(layout="bucket", skin=0.3)
    mesh = make_mesh(n_dev)
    bds = build_bucket_sharding(sys2, n_dev, balance=True)
    widths = np.diff(np.asarray(bds.col_starts))
    assert widths.min() >= 2 and widths.max() > widths.min()  # truly variable
    state = shard_state_bucket(bds, sys2, mesh)

    def owned_counts(bds_, st):
        act = np.asarray(jax.device_get(st.active)).reshape(bds_.n_dev, -1)
        return np.array([(act[d] & _owned_mask_flat(bds_, d)).sum()
                         for d in range(bds_.n_dev)])

    # ownership balance: equal-particle boundaries vs equal-width ones
    bds_u = build_bucket_sharding(sys2, n_dev)
    state_u = shard_state_bucket(bds_u, sys2, mesh)
    cb, cu = owned_counts(bds, state), owned_counts(bds_u, state_u)
    assert cb.sum() == cu.sum() == sys2.n_built
    assert cb.max() / cb.sum() < 0.55 * cu.max() / cu.sum()  # measured ~0.3 vs ~0.9

    init_frame, _ = make_bucket_runner(
        bds, mesh, lambda e: cd.make_step(cfg, e)[1], steps_per_frame=1)
    run_frame, diag = make_bucket_runner(
        bds, mesh, lambda e: cd.make_step(cfg, e)[0], steps_per_frame=10)
    state = run_frame(init_frame(state))
    ua, um, n = diag(state)
    assert int(n) == sys2.n_built
    np.testing.assert_allclose([float(ua), float(um)], u1, rtol=1e-10)


def test_bucket_sharded_rayleigh_benard_matches_single_device():
    """The bucket runner is scheme-generic: the Rayleigh-Bénard step (two
    rebuilds per step, thermal fields) must reproduce its single-device run
    under the slab decomposition — a second model family over the
    production sharding beyond the witch suite."""
    from sph_mountain_waves_tpu.models import rayleigh_benard as rb
    from sph_mountain_waves_tpu.parallel.bucket import (
        build_bucket_sharding, make_bucket_runner, shard_state_bucket)

    cfg = rb.Config(n_rows=16, dtype="float64", layout="bucket", skin=0.3)
    sys1 = rb.make_system(cfg)
    st1 = sys1.freeze()
    step1 = jax.jit(rb.make_step(cfg, sys1.engine))
    for _ in range(10):
        st1 = step1(st1)
    act = np.asarray(st1.active)
    v1 = np.asarray(st1.fields["v"])[act]

    sys2 = rb.make_system(cfg)
    sys2.freeze()
    mesh = make_mesh(8)
    bds = build_bucket_sharding(sys2, 8)
    state = shard_state_bucket(bds, sys2, mesh)
    run_frame, diag = make_bucket_runner(
        bds, mesh, lambda e: rb.make_step(cfg, e), steps_per_frame=10)
    state = run_frame(state)
    ua, um, n = diag(state)
    assert int(n) == sys2.n_built
    # diag averages |v| (2-norm) over owned rows; compare mean/max speeds
    s1 = np.sqrt((v1 ** 2).sum(-1))
    np.testing.assert_allclose([float(ua), float(um)],
                               [s1.mean(), s1.max()], rtol=1e-10)


def test_bucket_sharded_isph_distributed_cg():
    """ISPH under the slab decomposition: the pressure-Poisson CG runs
    INSIDE shard_map with psummed dot products and a per-iteration
    ghost refresh of the iterate (solvers.pcg + refresh_ghost_vector).
    A seeded velocity kick makes the solve nontrivial; the projected flow
    must match the single-device run."""
    from sph_mountain_waves_tpu.models import isph_witch as iw
    from sph_mountain_waves_tpu.parallel.bucket import (
        build_bucket_sharding, make_bucket_runner, shard_state_bucket)

    # cg_tol pinned (production default is 1e-4): the agreement assertion
    # below is tolerance-set. Under the round-4 'mg' default the single-
    # device side runs the true two-level M while the sharded side runs
    # the per-slab Schwarz flavor — different preconditioners, same
    # solution to cg_tol, so this also gates the Schwarz variant.
    cfg = iw.ISPHWitchConfig(n_rows=12, dtype="float64",
                             layout="bucket", skin=0.3, cg_tol=1e-6)

    def kicked_system():
        sys = iw.make_system(cfg)
        rng = np.random.default_rng(7)
        for chunk in sys._chunks:
            fluid = chunk["type"] == 0.0
            kick = 0.5 * rng.standard_normal(chunk["v"].shape)
            chunk["v"] = np.where(fluid[:, None], kick, chunk["v"])
        return sys

    sys1 = kicked_system()
    st1 = sys1.freeze()
    step1 = jax.jit(iw.make_step(cfg, sys1.engine))
    for _ in range(5):
        st1 = step1(st1)
    act = np.asarray(st1.active)
    s1 = np.sqrt((np.asarray(st1.fields["v"])[act] ** 2).sum(-1))

    sys2 = kicked_system()
    sys2.freeze()
    mesh = make_mesh(8)
    bds = build_bucket_sharding(sys2, 8)
    state = shard_state_bucket(bds, sys2, mesh)
    run_frame, diag = make_bucket_runner(
        bds, mesh, lambda e: iw.make_step(cfg, e), steps_per_frame=5)
    state = run_frame(state)
    ua, um, n = diag(state)
    assert int(n) == sys2.n_built
    # single-device solves with jax.scipy CG, sharded with solvers.pcg —
    # same stopping rule, different recurrence rounding: agreement is set
    # by cg_tol (1e-6), not by f64 roundoff
    np.testing.assert_allclose([float(ua), float(um)],
                               [s1.mean(), s1.max()], rtol=1e-4)


def test_bucket_sharded_pallas_composes():
    """The Pallas fast path must run unchanged inside shard_map on the
    slab-local grid (interpret mode on CPU)."""
    import sph_mountain_waves_tpu.ops.pallas_pairs as pp
    from sph_mountain_waves_tpu.parallel.bucket import make_bucket_runner

    orig = pp.make_pair_kernel_fn
    pp.make_pair_kernel_fn = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        cfg = WitchConfig(n_rows=12, dtype="float32", self_density=True,
                          layout="bucket", skin=0.2, use_pallas=True)
        sys1 = w.make_system(cfg)
        st1 = sys1.freeze()
        step1 = jax.jit(w.make_step(cfg, sys1.engine))
        for _ in range(4):
            st1 = step1(st1)
        u1 = [float(v) for v in velocity_diagnostics(st1)]

        sys2, mesh, bds, state = _bucket_setup(cfg)
        run_frame, diag = make_bucket_runner(
            bds, mesh, lambda e: w.make_step(cfg, e), steps_per_frame=4)
        state = run_frame(state)
        ua, um, n = diag(state)
        assert int(n) == sys2.n_built
        np.testing.assert_allclose([float(ua), float(um)], u1, rtol=2e-5)
    finally:
        pp.make_pair_kernel_fn = orig


@pytest.mark.heavy
def test_bucket_sharded_3d_yslab_matches_single_device():
    """3-D bucket sharding slabs along y (slab_axis=1): the global nx is a
    single 128-lane quantum, so x-slabs cannot shrink the local grid, but
    y rounds to ×8 and scales. Trajectory must match the single-device
    bucket run (collapse3d dam break, reference sph_jl/examples/collapse3d.jl)."""
    from sph_mountain_waves_tpu.parallel.bucket import (
        build_bucket_sharding, shard_state_bucket, make_bucket_runner)

    cfg = c3.Config(dr=0.02, dtype="float64", layout="bucket", skin=0.25)
    sys1 = c3.make_system(cfg)
    st1 = sys1.freeze()
    step1 = jax.jit(c3.make_step(cfg, sys1.engine))
    for _ in range(6):
        st1 = step1(st1)
    u1 = [float(v) for v in velocity_diagnostics(st1)]

    sys2 = c3.make_system(cfg)
    sys2.freeze()
    mesh = make_mesh(4)
    bds = build_bucket_sharding(sys2, 4, slab_axis=1)
    assert bds.local_lims[1] < sys2.engine.lims[1]  # y actually shrinks
    state = shard_state_bucket(bds, sys2, mesh)
    run_frame, diag = make_bucket_runner(
        bds, mesh, lambda e: c3.make_step(cfg, e), steps_per_frame=6)
    state = run_frame(state)
    ua, um, n = diag(state)
    assert int(n) == sys2.n_built
    np.testing.assert_allclose([float(ua), float(um)], u1, rtol=1e-10)


def test_bucket_sharded_local_memory_shrinks():
    """Per-device state must scale ∝ 1/n_dev once the global grid is wide
    enough (the point of slab-local grids; VERDICT r1 weak #5)."""
    from sph_mountain_waves_tpu.parallel.bucket import build_bucket_sharding

    cfg = WitchConfig(n_rows=40, dtype="float32", layout="bucket", skin=0.2)
    sys = w.make_system(cfg)
    sys.freeze()
    bds = build_bucket_sharding(sys, 8)
    # local grid = round128(slab_w + 4): the ×128 x quantum floors the
    # local width at 128 columns, so the shrink at this test size is 3x
    # (384 -> 128); at production scale (nx=1792 -> 256) it is 7x
    assert bds.local_lims[0] == 128
    assert bds.slots_local <= sys.engine.slots / 2.9  # per-device shrink
    assert bds.slots_local * 8 < sys.engine.slots * 3.0  # bounded total


def test_bucket_sharded_production_run_exports_artifacts(tmp_path):
    """run_sharded_witch_bucket (the production multi-chip entry) leaves the
    full artifact channel behind — PVD frames of owned rows (each particle
    exactly once), data.csv, velocities figure — and its gathered frames
    agree with a single-device run's diagnostics."""
    from sph_mountain_waves_tpu import read_vtp
    from sph_mountain_waves_tpu.io import read_csv
    from sph_mountain_waves_tpu.parallel.run import run_sharded_witch_bucket

    cfg = WitchConfig(n_rows=14, dtype="float64", self_density=True,
                      layout="bucket", skin=0.3, lazy_diagnostics=True)
    out = run_sharded_witch_bucket(cfg, n_dev=8, n_frames=2,
                                   steps_per_frame=5,
                                   out_path=str(tmp_path / "witch"))
    pts, fields = read_vtp(str(tmp_path / "witch" / "frame2.vtp"))
    sys1 = w.make_system(cfg)
    assert len(pts) == sys1.n_built == out["n"][-1]  # each particle once
    # lazy T/theta materialized by the runner's finalize (not stale zeros)
    assert np.all(np.asarray(fields["T"]) > 100.0)
    assert (tmp_path / "witch" / "data.csv").exists()
    data = read_csv(str(tmp_path / "witch" / "data.csv"))
    np.testing.assert_allclose(data["u_max"], out["u_max"], rtol=1e-6)

    # physics parity: same trajectory as the unsharded bucket engine
    st1 = sys1.freeze()
    step1 = jax.jit(w.make_step(cfg, sys1.engine))
    for _ in range(10):
        st1 = step1(st1)
    u1 = [float(v) for v in velocity_diagnostics(st1)]
    np.testing.assert_allclose([out["u_avg"][-1], out["u_max"][-1]], u1,
                               rtol=1e-10)


def test_bucket_sharded_checkpoint_resume(tmp_path):
    """SURVEY §5 checkpoint/resume on the production multi-chip path: a run
    checkpointed mid-way and resumed reproduces the uninterrupted
    trajectory. Restore re-places rows from positions (slot assignment is a
    layout detail, not physics), so the gate is tight-rtol, not bitwise."""
    from sph_mountain_waves_tpu.parallel.bucket import load_checkpoint_bucket
    from sph_mountain_waves_tpu.parallel.run import run_sharded_witch_bucket

    cfg = WitchConfig(n_rows=14, dtype="float64", self_density=True,
                      layout="bucket", skin=0.3, lazy_diagnostics=True)
    full = run_sharded_witch_bucket(cfg, n_dev=8, n_frames=2,
                                    steps_per_frame=5)

    p1 = tmp_path / "part1"
    run_sharded_witch_bucket(cfg, n_dev=8, n_frames=1, steps_per_frame=5,
                             out_path=str(p1), checkpoint_every=1)
    ckpt = str(p1 / "checkpoint.npz")
    host, meta = load_checkpoint_bucket(ckpt)
    assert meta["extra"]["step"] == 5 and meta["n"] == len(host["x"])

    res = run_sharded_witch_bucket(cfg, n_dev=8, n_frames=2,
                                   steps_per_frame=5, resume=ckpt)
    assert len(res["u_max"]) == 1  # only the remaining frame ran
    assert res["n"][-1] == full["n"][-1]
    np.testing.assert_allclose([res["u_avg"][-1], res["u_max"][-1]],
                               [full["u_avg"][-1], full["u_max"][-1]],
                               rtol=1e-10)

    # rebalance-on-resume: restoring under the equal-particle partition
    # (boundaries re-derived from the CHECKPOINTED rows) is the production
    # rebalancing path and must reproduce the same trajectory
    res_b = run_sharded_witch_bucket(cfg, n_dev=8, n_frames=2,
                                     steps_per_frame=5, resume=ckpt,
                                     balance=True)
    assert res_b["n"][-1] == full["n"][-1]
    np.testing.assert_allclose([res_b["u_avg"][-1], res_b["u_max"][-1]],
                               [full["u_avg"][-1], full["u_max"][-1]],
                               rtol=1e-10)


def test_bucket_sharded_flow_spawn_conserves():
    """Dynamic-N flow scheme (inflow recycling) under the slab
    decomposition: the boot inflow column converts at step 1 (it sits
    exactly on the domain edge) and spawns a fresh upstream column, so the
    run crosses a real spawn event. Conversion and the free-slot pool are
    owned-gated (a ghost copy must neither convert nor spawn), so the
    global particle count, velocity diagnostics, and the wave-drag
    observable must all match the single-device run."""
    from sph_mountain_waves_tpu.models import legacy_witch as lw
    from sph_mountain_waves_tpu.parallel.bucket import (
        build_bucket_sharding, gather_state_bucket, make_bucket_runner,
        shard_state_bucket)

    cfg = lw.isothermal_flow_config(n_rows=12, dom_length=60e3,
                                    dtype="float64", layout="bucket",
                                    skin=0.3)
    # nearest boot inflow column sits ~333 m upstream of the edge and
    # crosses it at U_max=20 after ~109 steps — 120 steps spans the event
    n_steps = 120
    sys1 = lw.make_system(cfg)
    st1 = sys1.freeze()
    step1 = jax.jit(lw.make_step(cfg, sys1.engine))
    for _ in range(n_steps):
        st1 = step1(st1)
    n1 = int(np.asarray(st1.active).sum())
    assert n1 > sys1.n_built  # the spawn event fired
    act = np.asarray(st1.active)
    s1 = np.sqrt((np.asarray(st1.fields["v"])[act] ** 2).sum(-1))
    drag1 = float(lw.mountain_force(st1)["drag"])

    sys2 = lw.make_system(cfg)
    sys2.freeze()
    mesh = make_mesh(8)
    bds = build_bucket_sharding(sys2, 8)
    state = shard_state_bucket(bds, sys2, mesh)
    run_frame, diag = make_bucket_runner(
        bds, mesh, lambda e: lw.make_step(cfg, e), steps_per_frame=10)
    for _ in range(n_steps // 10):
        state = run_frame(state)
    ua, um, n = diag(state)
    assert int(n) == n1
    np.testing.assert_allclose([float(ua), float(um)],
                               [s1.mean(), s1.max()], rtol=1e-10)
    hstate = gather_state_bucket(bds, state)
    drag2 = float(lw.mountain_force(hstate)["drag"])
    np.testing.assert_allclose(drag2, drag1, rtol=1e-10)


def test_bucket_sharded_flow_spawn_first_slab_ownership():
    """Inflow respawn-zone ownership (ADVICE round 3, medium): a spawn is
    written into an owned slot of the device that owns the CONVERTING
    column, but its position x − bc_width bins up to bc_width further
    left. (a) With a pathological partition whose first slab is narrower
    than the respawn zone, the spawned rows are silently lost (interior
    slots are never ghost-exchanged, and the next sort rescatter drops
    them as un-owned). (b) The production runner's ``balance=True`` path
    clamps the first balanced slab past the respawn zone
    (``balanced_col_starts(min_first_width=...)``) and conserves the
    INFLOW reservoir exactly."""
    from sph_mountain_waves_tpu.models import legacy_witch as lw
    from sph_mountain_waves_tpu.parallel.bucket import (
        GHOST, build_bucket_sharding, gather_state_bucket,
        make_bucket_runner, shard_state_bucket)
    from sph_mountain_waves_tpu.parallel.run import run_sharded_witch_bucket

    n_dev = 4
    cfg = lw.isothermal_flow_config(n_rows=12, dom_length=60e3,
                                    dtype="float64", layout="bucket",
                                    skin=0.3)
    n_steps = 120  # spans the first conversion event (~109 steps)

    def inflow_count(st):
        act = np.asarray(st.active)
        return int((act & (np.asarray(st.fields["type"]) == lw.INFLOW)).sum())

    sys_a = lw.make_system(cfg)
    st0 = sys_a.freeze()
    n_inflow0 = inflow_count(st0)
    g = sys_a.engine
    edge = -cfg.dom_length / 2 + cfg.U_max * cfg.dt
    edge_col = int(np.floor(edge / float(np.asarray(g.cell_size)[0]))
                   - int(np.asarray(g.phase)[0]))
    assert edge_col >= GHOST  # the pathology is reachable in this config

    # (a) pathological explicit partition: device 0 owns only GHOST cols
    n_cols = int(g.lims[0])
    starts = [0, GHOST]
    for d in range(2, n_dev):
        starts.append(GHOST + (d - 1) * (n_cols - GHOST) // (n_dev - 1))
    starts.append(n_cols)
    mesh = make_mesh(n_dev)
    bds = build_bucket_sharding(sys_a, n_dev, col_starts=tuple(starts))
    state = shard_state_bucket(bds, sys_a, mesh)
    run_frame, diag = make_bucket_runner(
        bds, mesh, lambda e: lw.make_step(cfg, e), steps_per_frame=10)
    for _ in range(n_steps // 10):
        state = run_frame(state)
    lost = n_inflow0 - inflow_count(gather_state_bucket(bds, state))
    assert lost > 0  # the documented silent loss is real

    # (b) the production balanced path conserves the reservoir
    res = run_sharded_witch_bucket(cfg, n_dev=n_dev, model=lw,
                                   steps_per_frame=10, slab_axis=0,
                                   n_frames=n_steps // 10, balance=True)
    assert res["sharding"].col_starts[1] >= edge_col + 1  # clamp applied
    hstate = gather_state_bucket(res["sharding"], res["state"])
    assert inflow_count(hstate) == n_inflow0


def test_balanced_owned_flat_host_side_contract():
    """``owned_flat`` on a BALANCED partition is a traced per-device mask
    and must fail loud outside shard_map (ADVICE round 3) — host-side
    consumers get ``owned_flat_dev(d)``, which must agree with the static
    per-device masks and tile the partition exactly."""
    from sph_mountain_waves_tpu.models import collapse_dry as cd
    from sph_mountain_waves_tpu.parallel.bucket import (
        BucketShardEngine, build_bucket_sharding)

    cfg = cd.Config(dr=0.04, dtype="float64", layout="bucket", skin=0.3)
    sys = cd.make_system(cfg)
    sys.freeze(layout="bucket", skin=0.3)
    bds = build_bucket_sharding(sys, 4, balance=True)
    eng = BucketShardEngine(bds)
    with pytest.raises(RuntimeError, match="owned_flat_dev"):
        _ = eng.owned_flat
    masks = [eng.owned_flat_dev(d) for d in range(4)]
    for m in masks:
        assert m.dtype == bool and m.shape == masks[0].shape
    widths = np.diff(np.asarray(bds.col_starts))
    counts = np.asarray([m.sum() for m in masks])
    # owned slots per device = slab width × (slots per column): exact
    # proportionality, and the partition covers every column once
    slots_per_col = counts[0] // widths[0]
    assert slots_per_col > 0
    np.testing.assert_array_equal(counts, widths * slots_per_col)


def test_drift_triggered_auto_rebalance():
    """Drift-triggered automatic rebalancing (round-4): a compressing cloud
    run through the PRODUCTION runner (run_sharded_witch_bucket with
    rebalance_factor) must (a) trigger at least one mid-run rebalance as
    the owned-count imbalance crosses the factor, (b) conserve particles,
    and (c) reproduce the never-rebalanced trajectory to the compact
    re-shard tolerance (rows re-place by position; only reduction order
    changes)."""
    import dataclasses
    import types

    import jax.numpy as jnp

    from sph_mountain_waves_tpu import ParticleSystem, Rectangle
    from sph_mountain_waves_tpu.ops.apply import apply_unary
    from sph_mountain_waves_tpu.parallel.run import run_sharded_witch_bucket

    @dataclasses.dataclass(frozen=True)
    class Cfg:
        layout: str = "bucket"
        t_end: float = 1.2
        dt: float = 0.05
        n_frames: int = 8
        lazy_diagnostics: bool = False

    def make_system(cfg):
        dom = Rectangle(0.0, 0.0, 8.0, 8.0)
        sys = ParticleSystem(fields={"x": 2, "v": 2}, domain=dom, h=0.25,
                             dim=2, dtype=jnp.float64)
        rng = np.random.default_rng(5)
        xs = np.stack([rng.uniform(0.6, 7.4, size=600),
                       rng.uniform(0.6, 7.4, size=600)], axis=-1)
        # compression along the SLAB axis: this toy domain's x-grid rounds
        # to one 128-lane quantum, so pick_slab_axis slabs y — drive the
        # y-distribution toward y = 1.2 so the owned-count imbalance grows
        # (an x-compression would never change y-slab ownership at all)
        vs = np.stack([np.zeros(600), -0.9 * (xs[:, 1] - 1.2)], axis=-1)
        sys.add_particles(xs, {"v": vs})
        # cap 64: the compression peaks at ~39 arrivals in the densest
        # cell (measured) — cap 32 drops (counted) overflow rows there,
        # and this gate asserts exact conservation
        sys.freeze_opts = dict(layout="bucket", skin=0.3, cap=64)
        return sys

    def make_step(cfg, engine):
        def step(state):
            state = apply_unary(state, lambda u: {"x": u.x + cfg.dt * u.v})
            state, _ = engine.rebuild(state)
            return state
        return step

    model = types.SimpleNamespace(
        make_system=make_system, make_step=make_step,
        EXPORT_VARS=("v",), make_finalize=lambda cfg: None)

    cfg = Cfg()
    base = run_sharded_witch_bucket(cfg, n_dev=4, model=model, balance=True)
    auto = run_sharded_witch_bucket(cfg, n_dev=4, model=model, balance=True,
                                    rebalance_factor=1.35)
    assert auto["n_rebalances"] >= 1
    np.testing.assert_array_equal(auto["n"], base["n"])
    assert auto["n"][-1] == 600
    np.testing.assert_allclose(auto["u_avg"], base["u_avg"], rtol=1e-10)
    np.testing.assert_allclose(auto["u_max"], base["u_max"], rtol=1e-10)
    # and the final partition is genuinely different from the boot one
    assert auto["sharding"].col_starts != base["sharding"].col_starts
