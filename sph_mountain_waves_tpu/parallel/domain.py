"""Multi-device domain decomposition (L0): slab sharding over a 1-D mesh.

The reference parallelizes only with shared-memory threads (SURVEY §2.6);
its locality structure — interactions strictly r ≤ h through a uniform cell
grid with a fixed stencil (src/core.jl:105-107, src/structs.jl:66-82) — is
exactly what makes distributed domain decomposition work. Here:

  * the cell grid is split along x into contiguous slabs, one per device of
    a 1-D ``jax.sharding.Mesh`` axis,
  * every step, each device sends a 2-cell-deep **halo** of boundary
    particles to its neighbors with ``lax.ppermute`` — deep
    enough that ring-1 ghosts have complete neighborhoods locally, so ghost
    densities/pressures are recomputed locally instead of re-exchanged,
  * particles crossing a slab boundary **migrate** via the same ppermute
    channel into free slots on the receiving device,
  * global diagnostics reduce with ``psum``/``pmax``.

A ``ShardEngine`` exposes the same ``rebuild`` contract as
``NeighborEngine``, so scheme step functions (models/*.py) run unchanged
inside ``shard_map``: rebuild = migrate → halo-exchange → extended local
sort/bucket.

Capacity contract: each device holds ``n_shard`` owned slots + ``2·halo``
ghost slots. A migration/halo overflow drops particles (surfaced via the
owned-count diagnostic) — size with headroom.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.neighbors import NeighborEngine, Neighbors
from ..structs import ParticleState

__all__ = ["DomainSharding", "ShardEngine", "shard_state", "make_mesh"]

OWNED = "_owned"  # per-particle flag field: 1.0 owned, 0.0 ghost


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), axis_names=("x",))


@dataclasses.dataclass(frozen=True)
class DomainSharding:
    """Static sharding description (hashable)."""
    engine: NeighborEngine      # global-domain engine (shared cell grid)
    n_dev: int
    n_shard: int                # owned capacity per device
    halo: int                   # ghost slots per side
    migr: int                   # migration slots per side per rebuild

    @property
    def slab_width(self) -> int:
        return -(-self.engine.lims[0] // self.n_dev)  # ceil

    def slab_lo(self, d):
        return d * self.slab_width

    @property
    def n_ext(self) -> int:
        return self.n_shard + 2 * self.halo


def shard_state(ds: DomainSharding, state: ParticleState, mesh: Mesh) -> ParticleState:
    """Distribute a host/global state into per-device extended layout
    [n_dev, n_ext, ...], sharded over the mesh 'x' axis. Particles are
    assigned to slabs by cell-x coordinate."""
    eng = ds.engine
    x = np.asarray(state.fields["x"])
    active = np.asarray(state.active)
    cx = np.floor(x[:, 0] / eng.cell_size[0]).astype(np.int64) - eng.phase[0]
    cx = np.clip(cx, 0, eng.lims[0] - 1)
    dev = np.clip(cx // ds.slab_width, 0, ds.n_dev - 1)

    fields = {name: np.zeros((ds.n_dev, ds.n_ext) + arr.shape[1:],
                             dtype=np.asarray(arr).dtype)
              for name, arr in state.fields.items()}
    fields[OWNED] = np.zeros((ds.n_dev, ds.n_ext),
                             dtype=np.asarray(x).dtype)
    act = np.zeros((ds.n_dev, ds.n_ext), dtype=bool)
    for d in range(ds.n_dev):
        rows = np.where(active & (dev == d))[0]
        if len(rows) > ds.n_shard:
            raise ValueError(f"device {d}: {len(rows)} particles > n_shard={ds.n_shard}")
        for name, arr in state.fields.items():
            fields[name][d, : len(rows)] = np.asarray(arr)[rows]
        fields[OWNED][d, : ds.n_shard] = 1.0
        act[d, : len(rows)] = True

    # flatten device axis so shard_map blocks are [n_ext, ...]
    sharding = NamedSharding(mesh, P("x"))
    dev_fields = {k: jax.device_put(v.reshape((-1,) + v.shape[2:]), sharding)
                  for k, v in fields.items()}
    return ParticleState(fields=dev_fields,
                         active=jax.device_put(act.reshape(-1), sharding))


def _select_rows(fields: dict, active, pred, k: int):
    """Pack ≤k rows matching pred into a fixed [k]-row buffer + validity."""
    n = active.shape[0]
    score = jnp.where(pred, jnp.arange(n, dtype=jnp.int32), jnp.int32(n))
    order = jnp.argsort(score)[:k]
    valid = pred[order]
    buf = {name: arr[order] for name, arr in fields.items()}
    return buf, valid, order


def _ppermute_tree(tree, axis, perm):
    return jax.tree.map(lambda a: jax.lax.ppermute(a, axis, perm), tree)


@dataclasses.dataclass(frozen=True)
class ShardEngine:
    """Per-device engine presented to scheme step functions inside shard_map.
    ``rebuild`` = migrate + halo-exchange + local extended rebuild; the
    stencil/candidate machinery is inherited from the global engine."""
    ds: DomainSharding
    axis: str = "x"

    # delegate the NeighborEngine surface used by ops/apply.py
    @property
    def h(self):
        return self.ds.engine.h

    @property
    def cell_size(self):
        return self.ds.engine.cell_size

    @property
    def dim(self):
        return self.ds.engine.dim

    @property
    def cap(self):
        return self.ds.engine.cap

    @property
    def num_cells(self):
        return self.ds.engine.num_cells

    @property
    def lims(self):
        return self.ds.engine.lims

    @property
    def phase(self):
        return self.ds.engine.phase

    @property
    def stencil(self):
        return self.ds.engine.stencil

    @property
    def pair_mode(self):
        return self.ds.engine.pair_mode

    def flat_key(self, cell):
        return self.ds.engine.flat_key(cell)

    def stencil_candidates(self, nbrs, offset):
        return self.ds.engine.stencil_candidates(nbrs, offset)

    def bucketize(self, nbrs, arr):
        return self.ds.engine.bucketize(nbrs, arr)

    def occupancy(self, nbrs):
        return self.ds.engine.occupancy(nbrs)

    def shift_cells(self, B, offset):
        return self.ds.engine.shift_cells(B, offset)

    # ------------------------------------------------------------ rebuild
    def rebuild(self, state: ParticleState) -> tuple[ParticleState, Neighbors]:
        ds = self.ds
        eng = ds.engine
        axis = self.axis
        d = jax.lax.axis_index(axis)
        lo = d * ds.slab_width
        hi = jnp.minimum(lo + ds.slab_width, eng.lims[0])

        x = state.fields["x"]
        cx = (jnp.floor(x[:, 0] / eng.cell_size[0]).astype(jnp.int32)
              - jnp.int32(eng.phase[0]))
        cx = jnp.clip(cx, 0, eng.lims[0] - 1)
        owned = state.fields[OWNED] > 0.5
        act = state.active & owned

        # ---- migration (owned particles that left my slab)
        right_perm = [(i, i + 1) for i in range(ds.n_dev - 1)]
        left_perm = [(i + 1, i) for i in range(ds.n_dev - 1)]
        go_r = act & (cx >= hi)
        go_l = act & (cx < lo)
        fields_o = {k: v for k, v in state.fields.items()}

        buf_r, val_r, _ = _select_rows(fields_o, act, go_r, ds.migr)
        buf_l, val_l, _ = _select_rows(fields_o, act, go_l, ds.migr)
        recv_l = _ppermute_tree({**buf_r, "__v": val_r}, axis, right_perm)
        recv_r = _ppermute_tree({**buf_l, "__v": val_l}, axis, left_perm)
        # deactivate migrated-away rows
        act = act & ~go_r & ~go_l

        # place received migrants into free owned slots
        n_ext = ds.n_ext
        free = owned & ~act
        for recv in (recv_l, recv_r):
            v = recv.pop("__v")
            # choose ds.migr free slots
            score = jnp.where(free, jnp.arange(n_ext, dtype=jnp.int32),
                              jnp.int32(n_ext))
            slots = jnp.argsort(score)[: ds.migr]
            ok = v & free[slots]
            tgt = jnp.where(ok, slots, n_ext)  # out-of-range -> dropped
            new_fields = {}
            for name, arr in state.fields.items():
                if name == OWNED:
                    new_fields[name] = arr
                    continue
                new_fields[name] = arr.at[tgt].set(
                    recv[name].astype(arr.dtype), mode="drop")
            state = ParticleState(fields=new_fields, active=state.active)
            act = act | (jnp.zeros_like(act).at[tgt].set(ok, mode="drop"))
            free = free & ~(jnp.zeros_like(free).at[tgt].set(ok, mode="drop"))

        # recompute cx for migrated-in rows
        x = state.fields["x"]
        cx = (jnp.floor(x[:, 0] / eng.cell_size[0]).astype(jnp.int32)
              - jnp.int32(eng.phase[0]))
        cx = jnp.clip(cx, 0, eng.lims[0] - 1)

        # ---- halo exchange (2-cell-deep boundary bands, owned rows)
        band_r = act & (cx >= hi - 2) & (cx < hi)
        band_l = act & (cx >= lo) & (cx < lo + 2)
        buf_r, val_r, _ = _select_rows(state.fields, act, band_r, ds.halo)
        buf_l, val_l, _ = _select_rows(state.fields, act, band_l, ds.halo)
        ghost_l = _ppermute_tree({**buf_r, "__v": val_r}, axis, right_perm)
        ghost_r = _ppermute_tree({**buf_l, "__v": val_l}, axis, left_perm)

        # overwrite the ghost population: all non-owned rows refreshed
        gval_l = ghost_l.pop("__v")
        gval_r = ghost_r.pop("__v")
        score = jnp.where(owned, jnp.int32(n_ext),
                          jnp.arange(n_ext, dtype=jnp.int32))
        gslots = jnp.argsort(score)[: 2 * ds.halo]
        gl, gr = gslots[: ds.halo], gslots[ds.halo:]
        new_fields = {}
        for name, arr in state.fields.items():
            if name == OWNED:
                new_fields[name] = arr
                continue
            arr = arr.at[gl].set(ghost_l[name].astype(arr.dtype), mode="drop")
            arr = arr.at[gr].set(ghost_r[name].astype(arr.dtype), mode="drop")
            new_fields[name] = arr
        act = act.at[gl].set(gval_l).at[gr].set(gval_r)
        state = ParticleState(fields=new_fields, active=act)

        # ---- local extended rebuild (sort + buckets over the global grid)
        return eng.rebuild(state)
