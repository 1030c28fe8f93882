"""Sharded simulation runner: scheme steps under shard_map.

Builds the full distributed step — migrate/halo/rebuild (ShardEngine) plus
the scheme's unchanged physics closures — as one ``shard_map``-wrapped,
jitted function over a 1-D device mesh, with ``psum``/``pmax`` global
diagnostics. This is the multi-device analogue of scaling the reference by
thread count (SURVEY §2.6): slab domain decomposition, halos exchanged by
collectives between the cards.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..structs import ParticleState
from .domain import OWNED, DomainSharding, ShardEngine, make_mesh, shard_state

__all__ = ["make_sharded_runner", "build_domain_sharding",
           "run_sharded_witch", "run_sharded_witch_bucket"]


def build_domain_sharding(sys, n_dev: int, halo: int | None = None,
                          migr: int | None = None,
                          shard_headroom: float = 1.5) -> DomainSharding:
    """Size the per-device capacities from the built system: ``n_shard``
    comes from the actual max slab occupancy (load imbalance included),
    ``halo``/``migr`` from the boundary-column capacity."""
    eng = sys.engine
    slab_w = -(-eng.lims[0] // n_dev)
    x = sys.host_fields()["x"]
    cx = np.clip(np.floor(x[:, 0] / eng.cell_size[0]).astype(np.int64)
                 - eng.phase[0], 0, eng.lims[0] - 1)
    slab = np.clip(cx // slab_w, 0, n_dev - 1)
    max_occ = int(np.bincount(slab, minlength=n_dev).max()) if len(x) else 1
    n_shard = int(-(-int(max_occ * shard_headroom) // 8) * 8) + 8
    ny = eng.lims[1] if eng.dim >= 2 else 1
    nz = eng.lims[2] if eng.dim == 3 else 1
    if halo is None:
        halo = int(2 * ny * nz * eng.cap)
    if migr is None:
        migr = int(2 * ny * nz * eng.cap)
    return DomainSharding(engine=eng, n_dev=n_dev, n_shard=n_shard,
                          halo=halo, migr=migr)


def make_sharded_runner(ds: DomainSharding, mesh: Mesh, make_step,
                        steps_per_frame: int = 1):
    """``make_step(engine) -> step(state)`` is the scheme's step builder
    (already bound to its config). Returns (run_frame, diagnostics) —
    run_frame advances ``steps_per_frame`` steps fully on-device."""
    seng = ShardEngine(ds)
    step = make_step(seng)
    spec = P("x")

    @partial(jax.shard_map, mesh=mesh, in_specs=(spec,), out_specs=spec)
    def shard_step_chunk(state: ParticleState) -> ParticleState:
        def body(s, _):
            return step(s), None
        state, _ = jax.lax.scan(body, state, None, length=steps_per_frame)
        return state

    run_frame = jax.jit(shard_step_chunk, donate_argnums=0)

    @partial(jax.shard_map, mesh=mesh, in_specs=(spec,),
             out_specs=(P(), P(), P()))
    def _diag(state: ParticleState):
        owned = (state.fields[OWNED] > 0.5) & state.active
        v = jnp.sqrt(jnp.sum(state.fields["v"] ** 2, axis=-1))
        s = jax.lax.psum(jnp.sum(jnp.where(owned, v, 0)), "x")
        n = jax.lax.psum(jnp.sum(owned), "x")
        vmax = jax.lax.pmax(jnp.max(jnp.where(owned, v, 0)), "x")
        return s / jnp.maximum(n, 1), vmax, n

    return run_frame, jax.jit(_diag)


def run_sharded_witch_bucket(cfg, n_dev: int | None = None,
                             n_frames: int | None = None,
                             steps_per_frame: int | None = None,
                             slab_axis: int | None = None,
                             out_path: str | None = None,
                             model=None,
                             checkpoint_every: int | None = None,
                             resume: str | None = None,
                             balance: bool = False,
                             rebalance_factor: float | None = None,
                             verbose: bool = False):
    """Production multi-chip mountain-wave run: the slab-local bucket
    decomposition (parallel/bucket.py — per-device memory ∝ 1/n_dev, Pallas
    pair kernels inside shard_map) with the full artifact channel: PVD
    frames, data.csv, and the velocities figure, via a once-per-frame host
    gather of owned rows (``gather_state_bucket``). ``run_sharded_witch``
    (below) keeps the flat-layout cross-check engine.

    ``model``: any module with the witch-scheme surface (make_system,
    make_step, EXPORT_VARS, make_finalize) — default the 2-D WCSPH
    flagship; pass ``models.witch3d`` for the 3-D stretch config.
    ``slab_axis`` defaults adaptively (``pick_slab_axis``): x in 2-D, y in
    3-D (witch3d's global nx is one 128-lane quantum, so x-slabs cannot
    shrink the local grid), constrained to axes giving every device at
    least GHOST owned columns.

    ``checkpoint_every``: write ``<out_path>/checkpoint.npz`` every that
    many frames (overwriting — it is a resume point, not an archive).
    ``resume``: path of a checkpoint to restart from; the saved rows
    replace the boot state (setup hooks are NOT re-run — their effect is
    already in the checkpoint) and frame/time counters continue from the
    saved step.

    ``balance``: equal-PARTICLE slab boundaries instead of equal-width
    ones (parallel/bucket.py balanced_col_starts) — step time under
    synchronous collectives is the max over devices, so this is the lever
    for nonuniform workloads. Chosen from the rows actually sharded, so
    ``resume`` + ``balance`` REBALANCES a drifted run.

    ``rebalance_factor``: drift-triggered AUTOMATIC rebalancing — after
    each frame a [n_dev] owned-count monitor (``make_owned_counts``, one
    cheap shard_map) checks max/mean imbalance; past the factor the run
    round-trips through the in-memory compact state (gather owned rows →
    fresh ``balanced_col_starts`` → re-shard) exactly like resume+balance,
    without touching disk. Each trigger re-builds the runners (the
    partition tables are compile-time constants), so a rebalance costs one
    re-trace/compile, so the 1.5-ish factor keeps events rare. Implies balanced partitions from
    the start when combined with ``balance=True`` (recommended)."""
    from .bucket import (balanced_col_starts, build_bucket_sharding,
                         gather_state_bucket, load_checkpoint_bucket,
                         make_bucket_runner, make_owned_counts,
                         save_checkpoint_bucket, shard_state_bucket)

    if model is None:
        from ..models import wcsph_perturbed_witch as model
    w = model

    assert cfg.layout == "bucket", "production sharding needs layout='bucket'"
    mesh = make_mesh(n_dev)
    n_dev = mesh.devices.size
    sys = w.make_system(cfg)
    st0 = sys.freeze()  # builds the global bucket engine (binning authority)
    if slab_axis is None:
        from .bucket import pick_slab_axis
        slab_axis = pick_slab_axis(sys.engine, n_dev)
    host = None
    k0 = 0
    if resume is not None:
        host, meta = load_checkpoint_bucket(resume)
        k0 = int(meta["extra"].get("step", 0))
    setup = getattr(w, "setup", None)
    if resume is None and setup is not None:
        # model setup hooks (witch3d mass renormalization, packing) run on
        # the single-device engine; the transformed active rows are then
        # re-sharded (the boot chunks would drop the transformation)
        st0 = setup(cfg, sys.engine, st0)
        act = np.asarray(jax.device_get(st0.active))
        host = {k: np.asarray(jax.device_get(v))[act]
                for k, v in st0.fields.items() if k != "_xref"}
    # the partition is chosen from the rows actually being sharded (resume
    # rows / setup-transformed rows), so a resumed run REBALANCES to the
    # drifted distribution — the compact checkpoint is the rebalance path
    min_first = 0
    if (slab_axis == 0 and getattr(cfg, "flow", False)
            and getattr(cfg, "max_spawn", 0)):
        # inflow recycling: the spawn is written into an owned slot of
        # the device that owns the CONVERTING column (x ≈ domain edge),
        # and its new position x − bc_width bins up to bc_width left of
        # that — device 0 must own the whole respawn zone or the spawn
        # is silently lost at the next rescatter (no ghost block ever
        # carries an interior slot to the neighbor). Clamp the first
        # balanced slab to cover [grid origin .. edge column] + one
        # skin-drift safety column.
        g = sys.engine
        edge = -cfg.dom_length / 2 + cfg.U_max * cfg.dt
        edge_col = int(np.floor(edge / float(np.asarray(g.cell_size)[0]))
                       - int(np.asarray(g.phase)[0]))
        min_first = edge_col + 2
    col_starts = None
    if balance:
        col_starts = balanced_col_starts(
            sys, n_dev, slab_axis,
            host_x=host["x"] if host is not None else None,
            min_first_width=min_first)
    bds = build_bucket_sharding(sys, n_dev, slab_axis=slab_axis,
                                col_starts=col_starts)
    state = shard_state_bucket(bds, sys, mesh, host=host)
    # the boot state lives whole on the default device; it was only the
    # binning authority (and setup's input), so drop it rather than keep a
    # global replica on device 0 for the whole run
    del st0
    sys.state = None

    if steps_per_frame is None:
        n_steps = int(round(cfg.t_end / cfg.dt))
        n_frames = n_frames or cfg.n_frames
        steps_per_frame = max(1, n_steps // max(n_frames, 1))
    else:
        n_steps = steps_per_frame * (n_frames or 1)

    def _runners(bds_):
        rf, dg = make_bucket_runner(
            bds_, mesh, lambda eng: w.make_step(cfg, eng), steps_per_frame,
            finalize=w.make_finalize(cfg) if cfg.lazy_diagnostics else None)
        cf = (make_owned_counts(bds_, mesh)
              if rebalance_factor and n_dev > 1 else None)
        return rf, dg, cf

    run_frame, diag, counts_fn = _runners(bds)
    n_rebalances = 0

    out = None
    if out_path:
        from ..io import new_pvd_file, save_frame, save_pvd_file
        out = new_pvd_file(out_path, resume=resume is not None)
        if resume is None:
            save_frame(out, gather_state_bucket(bds, state),
                       *w.EXPORT_VARS, time=0.0)

    ts, u_avgs, u_maxs, ns = [], [], [], []
    k = k0
    frame = 0
    while k < n_steps:
        state = run_frame(state)
        k += steps_per_frame
        frame += 1
        u_avg, u_max, n = diag(state)
        ts.append(k * cfg.dt)
        u_avgs.append(float(u_avg)); u_maxs.append(float(u_max))
        ns.append(int(n))
        if verbose:
            print(f"t = {ts[-1]:.3f}  n = {ns[-1]}  u_avg = {u_avgs[-1]:.4e}  "
                  f"u_max = {u_maxs[-1]:.4e}")
        if counts_fn is not None:
            c = np.asarray(counts_fn(state))
            imb = float(c.max()) / max(float(c.mean()), 1.0)
            if imb > rebalance_factor:
                # drift-triggered rebalance: in-memory compact round-trip
                # (the disk-free analogue of resume+balance)
                hstate = gather_state_bucket(bds, state)
                act = np.asarray(hstate.active)
                rows = {k: np.asarray(v)[act]
                        for k, v in hstate.fields.items() if k != "_xref"}
                col_starts = balanced_col_starts(
                    sys, n_dev, slab_axis, host_x=rows["x"],
                    min_first_width=min_first)
                bds = build_bucket_sharding(sys, n_dev, slab_axis=slab_axis,
                                            col_starts=col_starts)
                state = shard_state_bucket(bds, sys, mesh, host=rows)
                run_frame, diag, counts_fn = _runners(bds)
                n_rebalances += 1
                if verbose:
                    print(f"rebalanced (imbalance {imb:.2f}) -> "
                          f"col_starts {col_starts}")
        ckpt_due = (checkpoint_every and out_path
                    and frame % checkpoint_every == 0)
        # one device->host gather feeds both the frame and the checkpoint
        # (the full state is multi-GB at production scale)
        hstate = gather_state_bucket(bds, state) if (out or ckpt_due) else None
        if out:
            save_frame(out, hstate, *w.EXPORT_VARS, time=ts[-1])
        if ckpt_due:
            import os as _os
            save_checkpoint_bucket(
                _os.path.join(out_path, "checkpoint.npz"), bds, state,
                extra={"step": k, "t": ts[-1]}, host_state=hstate)
    if out:
        import os as _os

        from ..io import save_csv
        from ..utils.plots import plot_velocities
        save_pvd_file(out)
        save_csv(_os.path.join(out.path, "data.csv"),
                 {"t": ts, "u_avg": u_avgs, "u_max": u_maxs},
                 merge_history=k0 > 0)
        plot_velocities(out.path, ts, u_avgs, u_maxs)
    return {"t": np.asarray(ts), "u_avg": np.asarray(u_avgs),
            "u_max": np.asarray(u_maxs), "n": np.asarray(ns),
            "n_rebalances": n_rebalances,
            "state": state, "system": sys, "sharding": bds, "mesh": mesh}


def run_sharded_witch(cfg, n_dev: int | None = None, n_frames: int | None = None,
                      steps_per_frame: int | None = None, verbose: bool = False):
    """Distributed mountain-wave run (flagship multi-chip path)."""
    from ..models import wcsph_perturbed_witch as w

    mesh = make_mesh(n_dev)
    n_dev = mesh.devices.size
    sys = w.make_system(cfg)
    sys.freeze()  # builds the global engine
    ds = build_domain_sharding(sys, n_dev)
    state = shard_state(ds, sys.state, mesh)

    if steps_per_frame is None:
        n_steps = int(round(cfg.t_end / cfg.dt))
        n_frames = n_frames or cfg.n_frames
        steps_per_frame = max(1, n_steps // max(n_frames, 1))
    else:
        n_steps = steps_per_frame * (n_frames or 1)

    run_frame, diag = make_sharded_runner(
        ds, mesh, lambda eng: w.make_step(cfg, eng), steps_per_frame)

    ts, u_avgs, u_maxs, ns = [], [], [], []
    k = 0
    while k < n_steps:
        state = run_frame(state)
        k += steps_per_frame
        u_avg, u_max, n = diag(state)
        ts.append(k * cfg.dt)
        u_avgs.append(float(u_avg)); u_maxs.append(float(u_max))
        ns.append(int(n))
        if verbose:
            print(f"t = {ts[-1]:.3f}  n = {ns[-1]}  u_avg = {u_avgs[-1]:.4e}  "
                  f"u_max = {u_maxs[-1]:.4e}")
    return {"t": np.asarray(ts), "u_avg": np.asarray(u_avgs),
            "u_max": np.asarray(u_maxs), "n": np.asarray(ns),
            "state": state, "system": sys, "sharding": ds, "mesh": mesh}
