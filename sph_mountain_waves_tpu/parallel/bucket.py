"""Bucket-resident slab decomposition — the scale-real multi-chip path.

The flat-layout ShardEngine (domain.py) re-sorts every device into the
GLOBAL cell grid, so per-device memory and stencil work do not shrink with
device count (kept as the reference-shaped cross-check). This module is the
production design: each device owns a **slab-local bucket grid** of
``slab_w + 4`` x-columns (2 ghost columns per side) rounded up to the
grid's ×128 x quantum, and the state lives in the resident bucket layout
(ops/neighbors.py layout="bucket"), so

  * per-device memory/work ∝ 1/n_dev (the local grid, not the global one),
  * halo exchange is a pure column-block ``lax.ppermute`` — boundary cells
    of the resident layout are contiguous strided slices, zero gathers,
  * the Pallas pair kernels run unchanged on the local grid inside
    ``shard_map`` (the engine surface below delegates to a local
    NeighborEngine), and
  * migration needs no separate channel: ghost columns mirror the
    neighbor's boundary columns verbatim, and the (collective) rescatter
    adopts any mirrored particle whose position falls in the local slab.

Binning parity: local cell coords are computed as GLOBAL cell coords minus
the slab offset (integer arithmetic), so a particle bins into exactly the
same physical cell as on a single device — no floating-point drift from
shifted origins.

Ghost-refresh cadence: ghost columns are refreshed once per rebuild (every
step). The 2-deep ghost band means ring-1 ghosts have complete neighborhoods
locally, so ghost densities/pressures are recomputed locally rather than
re-exchanged (SURVEY §2.6 halo-exchange plan: one halo collective per
step between neighbouring devices).

Drift/rescatter discipline: the skin-budget predicate is made collective
with ``pmax`` so every device rescatters on the same step — this keeps the
slot correspondence of mirrored ghost columns valid between rescatters.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.neighbors import (NeighborEngine, Neighbors,
                             sorted_slot_scatter)
from ..structs import ParticleState

__all__ = ["BucketDomainSharding", "BucketShardEngine",
           "build_bucket_sharding", "balanced_col_starts",
           "shard_state_bucket", "make_bucket_runner", "make_owned_counts",
           "gather_state_bucket", "pick_slab_axis",
           "save_checkpoint_bucket", "load_checkpoint_bucket"]

GHOST = 2  # ghost columns per side; also the boundary-band width exchanged


def _round_up(v, m):
    return -(-v // m) * m


# per-axis local-grid rounding: ×128 on x, ×8 on y, z unconstrained —
# matching NeighborEngine.create's global-grid rounding. The slab axis should be a
# LONG axis of the domain: x for the wide 2-D witch; y for witch3d, whose
# global nx is already one ×128 quantum so x-slabs cannot shrink it.
_AXIS_QUANTUM = (128, 8, 1)


@dataclasses.dataclass(frozen=True)
class BucketDomainSharding:
    """Static description of the slab decomposition (hashable).

    ``slab_axis``: spatial axis the slabs cut (0=x, 1=y, 2=z). Per-device
    local-grid size along it is ``slab_w + 2·GHOST`` rounded up to the
    axis quantum — pick the axis where that rounding wastes least
    (see _AXIS_QUANTUM).

    ``col_starts`` (optional): load-balanced partition — n_dev+1 monotone
    global column indices; device d owns columns [col_starts[d],
    col_starts[d+1]). None (default) = uniform ``ceil(lims/n_dev)``-wide
    slabs. With a variable partition the LOCAL grid is sized to the WIDEST
    slab (SPMD: one program, one shape on every device) and each device's
    owned band [GHOST, GHOST+w_d) is selected at runtime from per-device
    tables indexed by ``lax.axis_index`` — empty padding columns sweep at
    their dynamic trip count (~free). Since synchronous collectives make
    the step time the MAX over devices, equal-particle slabs — not
    equal-width ones — are what balance nonuniform workloads (a dam-break
    column concentrates everything in a few devices' slabs)."""
    engine: NeighborEngine       # GLOBAL bucket engine (binning authority)
    n_dev: int
    slab_axis: int = 0
    col_starts: tuple | None = None

    def __post_init__(self):
        assert self.engine.layout == "bucket", "bucket sharding needs bucket layout"
        assert 0 <= self.slab_axis < self.engine.dim
        if self.col_starts is not None:
            cs = np.asarray(self.col_starts)
            assert len(cs) == self.n_dev + 1, "need n_dev+1 boundaries"
            assert cs[0] == 0 and cs[-1] == self.engine.lims[self.slab_axis]
            # ghost mirrors only reach ADJACENT devices: every owned band
            # must be at least the ghost depth wide
            assert np.diff(cs).min() >= GHOST, (
                f"balanced partition has a slab narrower than the ghost "
                f"depth {GHOST}: {tuple(np.diff(cs))}")
        # ghost mirrors are exchanged with ADJACENT devices only: the
        # 2-deep ghost band must fit inside one neighbor's owned width
        assert self.slab_w >= GHOST, (
            f"slab width {self.slab_w} < ghost depth {GHOST}: too many "
            f"devices for {self.engine.lims[self.slab_axis]} cells along "
            f"axis {self.slab_axis}")

    @property
    def slab_w(self) -> int:
        """Owned width per device: uniform, or the WIDEST balanced slab
        (the local grid must hold any device's band)."""
        if self.col_starts is not None:
            return int(np.diff(np.asarray(self.col_starts)).max())
        return -(-self.engine.lims[self.slab_axis] // self.n_dev)

    # --- per-device partition tables (host numpy; jnp.asarray'd inside
    # shard_map and indexed with lax.axis_index on the variable path)
    @property
    def starts_np(self) -> np.ndarray:
        """[n_dev] int32: first owned global column of each device."""
        if self.col_starts is not None:
            return np.asarray(self.col_starts[:-1], dtype=np.int32)
        return (np.arange(self.n_dev, dtype=np.int32)
                * np.int32(self.slab_w))

    @property
    def widths_np(self) -> np.ndarray:
        """[n_dev] int32: owned width of each device (uniform: the last
        device's band may extend past the domain — harmless, those columns
        do not exist)."""
        if self.col_starts is not None:
            return np.diff(np.asarray(self.col_starts)).astype(np.int32)
        return np.full(self.n_dev, self.slab_w, dtype=np.int32)

    def owner_of_cols(self, cols: np.ndarray) -> np.ndarray:
        """Host-side owner device of global slab-axis columns."""
        if self.col_starts is not None:
            return np.clip(np.searchsorted(np.asarray(self.col_starts),
                                           cols, side="right") - 1,
                           0, self.n_dev - 1)
        return np.clip(cols // self.slab_w, 0, self.n_dev - 1)

    @property
    def local_lims(self) -> tuple:
        a = self.slab_axis
        n_a = _round_up(self.slab_w + 2 * GHOST, _AXIS_QUANTUM[a])
        lims = list(self.engine.lims)
        lims[a] = n_a
        return tuple(lims)

    @property
    def local_engine(self) -> NeighborEngine:
        """Slab-local engine: same h/cap/skin, local grid. Its own
        rebuild/screen is bypassed (BucketShardEngine implements the
        distributed rebuild); everything static (lims, stencil, resident
        views, Pallas row windows) runs on the local grid."""
        g = self.engine
        a = self.slab_axis
        L = g.cell_size[a]
        mins = list(g.mins)
        maxs = list(g.maxs)
        phase = list(g.phase)
        mins[a] = 0.0
        maxs[a] = (self.slab_w + 2 * GHOST) * L
        phase[a] = 0
        return NeighborEngine(
            dim=g.dim, h=g.h, phase=tuple(phase),
            lims=self.local_lims, cap=g.cap, dtype=g.dtype,
            mins=tuple(mins), maxs=tuple(maxs), pair_mode="cell",
            layout="bucket", skin=g.skin, cells=g.cell_size,
            persistent=g.persistent, rescatter_mode=g.rescatter_mode)

    @property
    def slots_local(self) -> int:
        return self.local_engine.slots

    @property
    def grid_axis(self) -> int:
        """Axis of the slab coordinate in the [cap, (nz,) ny, nx] resident
        grid view (x is the minor/last spatial axis)."""
        return 1 + (self.engine.dim - 1 - self.slab_axis)

    @property
    def owned_col_mask(self) -> np.ndarray:
        """[local_n_axis] bool: slab-axis planes owned by a device (uniform
        partition: same on every device; the last device simply has empty
        planes past the domain)."""
        return self.owned_col_mask_dev(0)

    def owned_col_mask_dev(self, d: int) -> np.ndarray:
        """[local_n_axis] bool: slab-axis planes owned by device ``d``
        (host-side; the owned band always starts at local column GHOST,
        only its width varies under a balanced partition)."""
        m = np.zeros(self.local_lims[self.slab_axis], dtype=bool)
        m[GHOST:GHOST + int(self.widths_np[d])] = True
        return m


def balanced_col_starts(sys, n_dev: int, slab_axis: int = 0,
                        host_x=None, min_first_width: int = 0) -> tuple:
    """Equal-PARTICLE slab boundaries from the build-time column histogram
    (n_dev+1 monotone global column indices; each owned band ≥ GHOST wide).
    Step time under synchronous collectives is the max over devices, so for
    nonuniform workloads (a dam-break column, a collapsing blob) this — not
    equal widths — is what balances the fleet. The partition is static; to
    REbalance a long run whose distribution has drifted, round-trip through
    the compact checkpoint (save_checkpoint_bucket →
    shard_state_bucket(host=...) with fresh boundaries — it re-places rows
    by position on any partition).

    ``min_first_width``: lower bound (in columns) on device 0's owned
    band. Inflow-recycling flow models need device 0 to own the WHOLE
    respawn zone — the spawn is written into an owned slot of the device
    that owns the CONVERTING column, so a first slab narrower than the
    inflow zone silently loses every spawn whose position bins left of
    it (ADVICE round 3, medium). run_sharded_witch_bucket derives this
    from the model config; the default 0 keeps GHOST as the bound."""
    g = sys.engine
    x = np.asarray(host_x if host_x is not None else sys.host_fields()["x"],
                   dtype=np.float64)
    L = g.cell_size
    cols = (np.floor(x[:, :g.dim] / np.asarray(L)).astype(np.int64)
            - np.asarray(g.phase))[:, slab_axis]
    n_cols = int(g.lims[slab_axis])
    first_w = max(GHOST, int(min_first_width))
    assert n_cols >= first_w + GHOST * (n_dev - 1), (
        f"{n_dev} devices need ≥ {first_w + GHOST * (n_dev - 1)} columns "
        f"(first slab ≥ {first_w}), grid has {n_cols}")
    counts = np.bincount(np.clip(cols, 0, n_cols - 1), minlength=n_cols)
    cum = np.cumsum(counts)
    total = int(cum[-1])
    starts = [0]
    for d in range(1, n_dev):
        b = int(np.searchsorted(cum, d * total / n_dev))
        lo = starts[-1] + GHOST if d > 1 else first_w
        starts.append(int(np.clip(b, lo, n_cols - GHOST * (n_dev - d))))
    starts.append(n_cols)
    return tuple(starts)


def build_bucket_sharding(sys, n_dev: int, slab_axis: int = 0,
                          balance: bool = False,
                          col_starts: tuple | None = None
                          ) -> BucketDomainSharding:
    """``balance=True`` chooses equal-particle slab boundaries from the
    built particles (``balanced_col_starts``); ``col_starts`` passes an
    explicit partition (e.g. re-derived at restore time). Default: uniform
    equal-width slabs."""
    assert sys.engine is not None, "freeze() the system first"
    if balance and col_starts is None:
        col_starts = balanced_col_starts(sys, n_dev, slab_axis)
    return BucketDomainSharding(engine=sys.engine, n_dev=n_dev,
                                slab_axis=slab_axis, col_starts=col_starts)


def pick_slab_axis(engine, n_dev: int) -> int:
    """Default slab axis for a production run: the axis whose slab-local
    grid (slab + 2-ghost band, rounded up to that axis's tile quantum —
    ×128 on x, ×8 on y) is SMALLEST relative to the global
    grid, i.e. the axis where slicing actually shrinks per-device memory
    and stencil work. This is what makes y win for the 3-D witch (global
    nx is one ×128 quantum — x-slabs round straight back to it) and x
    win for the wide 2-D witch. Axes too shallow for the ghost depth
    (slab_w < GHOST: mirrors only reach adjacent devices) are excluded;
    if none qualifies, fall back to the axis with the most cells."""
    best, best_ratio = None, None
    for a in range(engine.dim):
        slab_w = -(-engine.lims[a] // n_dev)
        if slab_w < GHOST:
            continue
        local = _round_up(slab_w + 2 * GHOST, _AXIS_QUANTUM[a])
        ratio = local / engine.lims[a]
        if best_ratio is None or ratio < best_ratio:
            best, best_ratio = a, ratio
    return int(np.argmax(engine.lims)) if best is None else best


def _slab_coord_of_cell(bds: BucketDomainSharding, n: int) -> np.ndarray:
    """Slab-axis component of the first ``n`` flat cell indices (cell =
    ix + nx·(iy + ny·iz))."""
    eng = bds.local_engine
    a = bds.slab_axis
    stride = int(np.prod(eng.lims[:a], dtype=np.int64)) if a else 1
    return (np.arange(n, dtype=np.int64) // stride) % eng.lims[a]


def _owned_mask_flat(bds: BucketDomainSharding, d: int = 0) -> np.ndarray:
    """[slots_local] bool: device ``d``'s slots in owned slab-axis planes
    (host-side static; uniform partitions are device-independent)."""
    eng = bds.local_engine
    C = eng.num_cells
    owned_cell = bds.owned_col_mask_dev(d)[_slab_coord_of_cell(bds, C + 1)]
    owned_cell[C] = False  # trash column is never owned
    return np.tile(owned_cell, eng.cap)


def _owned_cell_mask(bds: BucketDomainSharding, d: int = 0) -> np.ndarray:
    """[num_cells_local] bool: cells in owned slab-axis planes (static)."""
    return bds.owned_col_mask_dev(d)[
        _slab_coord_of_cell(bds, bds.local_engine.num_cells)]


def shard_state_bucket(bds: BucketDomainSharding, sys,
                       mesh: Mesh, host: dict | None = None) -> ParticleState:
    """Host-side initial distribution: place each built particle in its
    device's local resident slot (owned columns only; ghost columns fill on
    the first rebuild — _xref=inf forces a first-step rescatter+refresh).

    ``host`` (optional, name → [n(, d)] arrays) overrides the system's
    build-chunk fields — used to shard a state transformed after freeze
    (model ``setup`` hooks: witch3d mass renormalization, hopkins_total /
    pavelka packing)."""
    g = bds.engine
    eng = bds.local_engine
    L = g.cell_size
    dim = g.dim
    if host is None:
        host = sys.host_fields()
    x = np.asarray(host["x"], dtype=np.float64)
    n = len(x)
    cg = np.floor(x[:, :dim] / L).astype(np.int64) - np.asarray(g.phase)
    cg = np.clip(cg, 0, np.asarray(g.lims) - 1)
    sa = bds.slab_axis
    dev = bds.owner_of_cols(cg[:, sa])

    nx_l, C_l, cap = eng.lims[0], eng.num_cells, eng.cap
    slots = eng.slots
    dtype = np.dtype(jnp.dtype(sys.dtype))  # system state dtype (freeze parity)
    fields = {}
    for name, arr in host.items():
        arr = np.asarray(arr)
        fields[name] = np.zeros((bds.n_dev, slots) + arr.shape[1:],
                                dtype=dtype)
    xref = np.full((bds.n_dev, slots, dim), np.inf, dtype=dtype)
    active = np.zeros((bds.n_dev, slots), dtype=bool)

    for d in range(bds.n_dev):
        rows = np.where(dev == d)[0]
        cl = cg[rows].copy()
        cl[:, sa] = cl[:, sa] - (int(bds.starts_np[d]) - GHOST)
        key = cl[:, 0]
        stride = nx_l
        for a in range(1, dim):
            key = key + stride * cl[:, a]
            stride *= eng.lims[a]
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        counts = np.bincount(key_s, minlength=C_l + 1)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(len(rows)) - starts[key_s]
        if len(rank) and rank.max() >= cap:
            raise ValueError(f"device {d}: initial occupancy {rank.max()+1} "
                             f"> cap {cap}")
        slot = rank * (C_l + 1) + key_s
        for name in fields:
            fields[name][d, slot] = np.asarray(host[name])[rows[order]]
        active[d, slot] = True

    fields["_xref"] = xref
    sharding = NamedSharding(mesh, P("x"))
    dev_fields = {k: jax.device_put(v.reshape((-1,) + v.shape[2:]), sharding)
                  for k, v in fields.items()}
    return ParticleState(fields=dev_fields,
                         active=jax.device_put(active.reshape(-1), sharding))


def gather_state_bucket(bds: BucketDomainSharding,
                        state: ParticleState) -> ParticleState:
    """Host-side gather of a bucket-sharded state for frame export and
    checkpointing: fetch the global arrays once and mask off ghost-column
    mirrors, so exactly each device's owned active rows remain. The result
    is a host ParticleState directly consumable by ``io.save_frame`` /
    ``utils.checkpoint.save_checkpoint`` (each particle appears once —
    ghost copies are the only duplicates in the sharded layout)."""
    owned = np.concatenate([_owned_mask_flat(bds, d)
                            for d in range(bds.n_dev)])
    fields = {k: np.asarray(jax.device_get(v))
              for k, v in state.fields.items()}
    active = np.asarray(jax.device_get(state.active)) & owned
    return ParticleState(fields=fields, active=active)


def save_checkpoint_bucket(path: str, bds: BucketDomainSharding,
                           state: ParticleState,
                           extra: dict | None = None,
                           host_state: ParticleState | None = None) -> None:
    """Checkpoint a bucket-sharded run: gather each device's owned active
    rows to host and persist them compacted (positions/fields only — slot
    assignment is a layout detail recomputed on restore). Counterpart of
    ``utils.checkpoint.save_checkpoint`` for the multi-chip path; same npz
    container (``field:<name>`` arrays + ``__meta__`` JSON), atomic write.
    ``_xref`` is dropped: restore forces a first-step rescatter+refresh
    anyway. ``host_state``: a pre-gathered ``gather_state_bucket`` result
    (runners that just exported a frame pass it to avoid re-fetching the
    full state over the device link)."""
    import json

    from ..utils.checkpoint import atomic_savez

    host = host_state if host_state is not None \
        else gather_state_bucket(bds, state)
    act = np.asarray(host.active)
    arrays = {f"field:{k}": np.asarray(v)[act]
              for k, v in host.fields.items() if k != "_xref"}
    meta = {"extra": extra or {}, "n": int(act.sum()), "format": "rows",
            "slab_axis": bds.slab_axis, "n_dev": bds.n_dev}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    atomic_savez(path, arrays)


def load_checkpoint_bucket(path: str):
    """Return ``(host, meta)``: the compacted name → [n(, d)] field arrays
    (feed as ``shard_state_bucket(..., host=)`` — works on any device count
    or slab axis, not just the one that saved) and the saved metadata.
    Rejects ``"slots"``-format (single-device, slot-shaped) checkpoints:
    their inactive zero rows would be loaded as particles at the origin."""
    import json

    data = np.load(path if path.endswith(".npz") else path + ".npz")
    host = {k[len("field:"):]: data[k] for k in data.files
            if k.startswith("field:")}
    meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
    fmt = meta.get("format", "slots" if "active" in data.files else "rows")
    if fmt != "rows":
        raise ValueError(
            f"{path} is a {fmt!r}-format checkpoint (full slot-shaped "
            "single-device state) — restore it with "
            "utils.checkpoint.load_checkpoint / the model's cfg.resume")
    return host, meta


# ---------------------------------------------------------------- engine

def _col_view(eng: NeighborEngine, arr: jnp.ndarray) -> jnp.ndarray:
    """Flat [slots(, extra)] → [cap, (nz,) ny, nx(, extra)]: the resident
    grid view whose x-column slices are the exchange blocks."""
    cap = eng.cap
    C = eng.num_cells
    rest = arr.shape[1:]
    B = arr.reshape((cap, C + 1) + rest)[:, :C]
    if eng.dim == 2:
        nx, ny = eng.lims
        return B.reshape((cap, ny, nx) + rest)
    nx, ny, nz = eng.lims
    return B.reshape((cap, nz, ny, nx) + rest)


def _from_col_view(eng: NeighborEngine, G: jnp.ndarray,
                   trash: jnp.ndarray) -> jnp.ndarray:
    """Inverse of _col_view; ``trash`` is the [cap(, extra)] trash column."""
    cap = eng.cap
    C = eng.num_cells
    rest = G.shape[eng.dim + 1:]
    flat = G.reshape((cap, C) + rest)
    return jnp.concatenate([flat, trash[:, None]], axis=1).reshape(
        (cap * (C + 1),) + rest)


def _take_cols(ax, G, c0, w):
    """Slice ``w`` planes starting at ``c0`` along grid-view axis ``ax``
    (the slab axis: x columns are the last view axis, y/z planes earlier)."""
    return jax.lax.slice_in_dim(G, c0, c0 + w, axis=ax)


def _put_cols(ax, G, block, c0):
    # traced c0 (balanced partition): every index must share its dtype
    zero = jnp.zeros((), c0.dtype) if isinstance(c0, jnp.ndarray) else 0
    idx = [zero] * G.ndim
    idx[ax] = c0
    return jax.lax.dynamic_update_slice(G, block.astype(G.dtype), tuple(idx))


@dataclasses.dataclass(frozen=True)
class BucketShardEngine:
    """Per-device engine inside shard_map. Presents the NeighborEngine
    surface on the slab-local grid; ``rebuild`` = collective-skin rescatter
    + ghost-column refresh."""
    bds: BucketDomainSharding
    axis: str = "x"

    # ---- delegated static surface (ops/apply.py + pallas_pairs contract)
    @property
    def _eng(self):
        return self.bds.local_engine

    @property
    def layout(self):
        return "bucket"

    @property
    def h(self):
        return self._eng.h

    @property
    def cell_size(self):
        return self._eng.cell_size

    @property
    def skin(self):
        return self._eng.skin

    @property
    def dim(self):
        return self._eng.dim

    @property
    def cap(self):
        return self._eng.cap

    @property
    def num_cells(self):
        return self._eng.num_cells

    @property
    def lims(self):
        return self._eng.lims

    @property
    def phase(self):
        return self._eng.phase

    @property
    def stencil(self):
        return self._eng.stencil

    @property
    def pair_mode(self):
        return "cell"

    @property
    def slots(self):
        return self._eng.slots

    def flat_key(self, cell):
        return self._eng.flat_key(cell)

    def resident(self, arr):
        return self._eng.resident(arr)

    def pad_resident(self, B):
        return self._eng.pad_resident(B)

    def slice_resident(self, P_, offset):
        return self._eng.slice_resident(P_, offset)

    def shift_resident(self, B, offset):
        return self._eng.shift_resident(B, offset)

    def bucketize(self, nbrs, arr):
        return self._eng.bucketize(nbrs, arr)

    def occupancy(self, nbrs):
        return self._eng.occupancy(nbrs)

    def shift_cells(self, B, offset):
        return self._eng.shift_cells(B, offset)

    def stencil_candidates(self, nbrs, offset):
        return self._eng.stencil_candidates(nbrs, offset)

    # ---- per-device partition values (traced when balanced)
    def _dev_start_w(self):
        """(start, w): this device's first owned GLOBAL column and its
        owned width. ``start`` is always traced (axis_index arithmetic);
        ``w`` is a Python int on the uniform path and an axis_index-
        selected traced scalar under a balanced (variable-width)
        partition."""
        bds = self.bds
        d = jax.lax.axis_index(self.axis)
        if bds.col_starts is None:
            return d * bds.slab_w, bds.slab_w
        return (jnp.asarray(bds.starts_np)[d],
                jnp.asarray(bds.widths_np)[d])

    # ------------------------------------------------------------ exchange
    def _exchange_blocks(self, tree: dict, send_w: int):
        """ppermute the outermost ``send_w`` OWNED columns each way.
        Returns (recv_from_left, recv_from_right) column-block trees; edge
        devices receive zeros."""
        eng = self._eng
        ax = self.bds.grid_axis
        n_dev = self.bds.n_dev
        right_perm = [(i, i + 1) for i in range(n_dev - 1)]
        left_perm = [(i + 1, i) for i in range(n_dev - 1)]

        views = {k: _col_view(eng, v) for k, v in tree.items()}
        _, w = self._dev_start_w()
        if isinstance(w, int):  # uniform: static slice
            send_r = {k: _take_cols(ax, v, GHOST + w - send_w, send_w)
                      for k, v in views.items()}
        else:  # balanced: the owned band's right edge varies per device
            send_r = {k: jax.lax.dynamic_slice_in_dim(
                          v, GHOST + w - send_w, send_w, axis=ax)
                      for k, v in views.items()}
        send_l = {k: _take_cols(ax, v, GHOST, send_w)
                  for k, v in views.items()}
        recv_from_left = jax.tree.map(
            lambda a: jax.lax.ppermute(a, self.axis, right_perm), send_r)
        recv_from_right = jax.tree.map(
            lambda a: jax.lax.ppermute(a, self.axis, left_perm), send_l)
        return recv_from_left, recv_from_right

    def _exchange_tree(self, state: ParticleState) -> dict:
        t = {k: v for k, v in state.fields.items() if k != "_xref"}
        t["__active"] = state.active
        return t

    def _splice_ghosts(self, flat, block_l, block_r):
        """Place received neighbor boundary blocks into this device's ghost
        columns of ONE flat [slots_local(, d)] field — the single copy of
        the ghost-placement arithmetic, shared by the per-rebuild state
        refresh and the per-CG-iteration vector refresh."""
        eng = self._eng
        ax = self.bds.grid_axis
        trash = self.resident(flat)[:, eng.num_cells]
        _, w = self._dev_start_w()
        G = _col_view(eng, flat)
        G = _put_cols(ax, G, block_l, 0)
        G = _put_cols(ax, G, block_r, GHOST + w)  # traced pos if balanced
        return _from_col_view(eng, G, trash)

    def refresh_ghost_vector(self, vec: jnp.ndarray) -> jnp.ndarray:
        """Mirror the neighbors' boundary owned columns of ONE flat
        [slots_local] field into my ghost columns (one ppermute each way) —
        the per-iteration halo refresh for distributed matrix-free solves
        (the CG iterate changes every iteration, so the once-per-rebuild
        ghost refresh of ``rebuild`` is stale for it)."""
        recv_l, recv_r = self._exchange_blocks({"v": vec}, GHOST)
        return self._splice_ghosts(vec, recv_l["v"], recv_r["v"])

    @property
    def owned_flat(self):
        """[slots_local] bool: slots whose slab-axis plane this device owns
        (ghost copies excluded) — the vector space for distributed solves
        and psum diagnostics. Static numpy on the uniform partition; under
        a balanced partition a traced mask built from this device's width
        (valid only inside shard_map, which is the only place it is
        consulted)."""
        if self.bds.col_starts is None:
            return _owned_mask_flat(self.bds)
        eng = self._eng
        try:
            _, w = self._dev_start_w()
        except NameError as e:
            # lax.axis_index outside a shard_map trace — fail loud with
            # the actual contract instead of a deep axis NameError
            # (ADVICE round 3: the property silently changes type with
            # balance, so pre-balance host-side consumers break here)
            raise RuntimeError(
                "owned_flat on a BALANCED partition is a per-device traced "
                "mask (lax.axis_index tables) and exists only inside "
                "shard_map; host-side consumers should call "
                "owned_flat_dev(d) instead") from e
        col = jnp.asarray(
            _slab_coord_of_cell(self.bds, eng.num_cells + 1))
        owned_cell = (col >= GHOST) & (col < GHOST + w)
        owned_cell = owned_cell.at[eng.num_cells].set(False)  # trash col
        return jnp.tile(owned_cell, eng.cap)

    def owned_flat_dev(self, d: int) -> np.ndarray:
        """Host-side static [slots_local] owned mask for device ``d`` —
        the out-of-shard_map counterpart of ``owned_flat``, valid for both
        uniform and balanced partitions (diagnostics, ISPH tooling)."""
        return _owned_mask_flat(self.bds, d)

    def _owned_cells(self):
        """[num_cells_local] bool owned-cell mask (traced when balanced) —
        the drop-accounting restriction for the stencil rescatter."""
        if self.bds.col_starts is None:
            return jnp.asarray(_owned_cell_mask(self.bds))
        eng = self._eng
        _, w = self._dev_start_w()
        col = jnp.asarray(_slab_coord_of_cell(self.bds, eng.num_cells))
        return (col >= GHOST) & (col < GHOST + w)

    def _refresh_ghosts(self, state: ParticleState) -> ParticleState:
        """Mirror the neighbors' boundary owned columns into my ghost
        columns (one ppermute each way; pure slices)."""
        tree = self._exchange_tree(state)
        recv_l, recv_r = self._exchange_blocks(tree, GHOST)
        act_l = recv_l.pop("__active")
        act_r = recv_r.pop("__active")

        fields = dict(state.fields)
        for k in recv_l:
            fields[k] = self._splice_ghosts(fields[k], recv_l[k], recv_r[k])
        # ghost _xref mirrors ghost x so the drift predicate sees no ghost
        # drift of its own (owners decide)
        fields["_xref"] = self._splice_ghosts(fields["_xref"],
                                              recv_l["x"], recv_r["x"])
        active = self._splice_ghosts(state.active, act_l, act_r)
        return ParticleState(fields=fields, active=active)

    # ----------------------------------------------------------- rescatter
    def _local_keys(self, x, active):
        """Global-parity binning: global cell coords minus the slab offset
        (integer arithmetic — identical cells as a single-device run)."""
        g = self.bds.engine
        eng = self._eng
        dim = g.dim
        d = jax.lax.axis_index(self.axis)
        L = jnp.asarray(g.cell_size, dtype=x.dtype)

        finite = jnp.all(jnp.isfinite(x), axis=-1)
        xs = jnp.where(finite[:, None], x, 0.0)
        cg = (jnp.floor(xs / L).astype(jnp.int32)
              - jnp.asarray(g.phase, dtype=jnp.int32))
        # containment against the GLOBAL bounds on every axis
        mins = jnp.asarray(g.mins, dtype=x.dtype)
        maxs = jnp.asarray(g.maxs, dtype=x.dtype)
        inside = jnp.all((x >= mins) & (x <= maxs), axis=-1)
        ok = active & jnp.where(finite, inside, False)

        sa = self.bds.slab_axis
        start, w = self._dev_start_w()
        cl = cg.at[:, sa].add(-(start - GHOST))
        in_local = (cl[:, sa] >= 0) & (cl[:, sa] < w + 2 * GHOST)
        owned_col = (cl[:, sa] >= GHOST) & (cl[:, sa] < GHOST + w)
        cl = jnp.clip(cl, 0, jnp.asarray(eng.lims, dtype=jnp.int32) - 1)
        key = jnp.where(ok & in_local, eng.flat_key(cl), eng.num_cells)
        return key.astype(jnp.int32), ok, owned_col

    def _rescatter(self, state: ParticleState):
        """Collective rescatter: exchange fresh boundary blocks, re-place my
        owned particles + adopted migrants into local slots, then refresh
        ghosts. Returns (state, n_dropped_by_overflow_or_escape)."""
        eng = self._eng
        C, cap = eng.num_cells, eng.cap
        owned_flat = jnp.asarray(self.owned_flat)

        # 1. fresh copies of neighbor boundary particles (migrant source)
        tree = self._exchange_tree(state)
        recv_l, recv_r = self._exchange_blocks(tree, GHOST)

        def flat_rows(block_tree):
            out = {}
            for k, v in block_tree.items():
                out[k] = v.reshape((-1,) + v.shape[1 + eng.dim:])
            return out

        rows_l, rows_r = flat_rows(recv_l), flat_rows(recv_r)
        act_l = rows_l.pop("__active")
        act_r = rows_r.pop("__active")

        # 2. combined candidate rows: my owned + received
        my_act = state.active & owned_flat
        names = [k for k in state.fields if k != "_xref"]
        cat = {k: jnp.concatenate(
            [state.fields[k], rows_l[k].astype(state.fields[k].dtype),
             rows_r[k].astype(state.fields[k].dtype)], axis=0)
            for k in names}
        act_cat = jnp.concatenate([my_act, act_l, act_r], axis=0)

        key, ok, owned_col = self._local_keys(cat["x"], act_cat)
        keep = ok & owned_col          # adopt only rows in MY slab
        key = jnp.where(keep, key, C).astype(jnp.int32)
        # escapes: my owned active rows that went NaN / out of the global
        # domain (reference removal; observable in the count like
        # sph_jl/examples/cylinder.jl:202)
        lost = jnp.sum(my_act & ~ok[: my_act.shape[0]])

        # one variadic sort + one wide scatter (see sorted_slot_scatter);
        # key < C implies keep, so slot occupancy is the new active mask
        move = {k: cat[k] for k in names
                if not eng.persistent or k in eng.persistent}
        moved, active, overflow = sorted_slot_scatter(
            key, move, C, cap, eng.slots)
        fields = {}
        for k in names:
            fields[k] = moved.get(k, jnp.zeros_like(state.fields[k]))
        fields["_xref"] = fields["x"]
        new_state = ParticleState(fields=fields, active=active)

        # 3. rebuild ghost mirrors on the new layout
        new_state = self._refresh_ghosts(new_state)
        return new_state, (overflow + lost).astype(jnp.int32)

    def _stencil_rescatter(self, state: ParticleState):
        """Collective stencil rescatter (``rescatter_mode="stencil"``, the
        default): refresh ghost mirrors so migrant candidates sit in ghost
        columns at fresh positions, then run the 1-cell-local windowed
        compaction (NeighborEngine._stencil_compact) over the LOCAL grid
        with global-parity keys. Mirrored ghost rows keyed into owned cells
        are thereby adopted (migration); owned rows keyed into ghost cells
        are placed there transiently and overwritten by the post-compact
        refresh (the neighbor adopts its own mirror of them). Accounting:
        drops in owned cells (cap overflow, in-window teleports) come from
        the compaction; owned rows keyed nowhere local (domain escapes, or
        out-of-window teleports) are counted here. In-window teleports into
        ghost cells from non-mirror columns would go uncounted — teleports
        only arise from spawn pools, and spawning models must use "sort"
        (see NeighborEngine.rescatter_mode)."""
        eng = self._eng
        C = eng.num_cells
        owned_flat = jnp.asarray(self.owned_flat)
        state = self._refresh_ghosts(state)
        key, ok, _owned_col = self._local_keys(state.fields["x"],
                                               state.active)
        lost = jnp.sum(state.active & owned_flat & (key == C))
        new_state, dropped = eng._stencil_compact(
            state, key, count_cells=self._owned_cells())
        new_state = self._refresh_ghosts(new_state)
        return new_state, (dropped + lost).astype(jnp.int32)

    # ------------------------------------------------------------- rebuild
    def rebuild(self, state: ParticleState) -> tuple[ParticleState, Neighbors]:
        eng = self._eng
        C, cap = eng.num_cells, eng.cap
        owned_flat = jnp.asarray(self.owned_flat)

        x = state.fields["x"]
        d2 = jnp.sum((x - state.fields["_xref"]) ** 2, axis=-1)
        d2 = jnp.nan_to_num(jnp.where(state.active & owned_flat, d2, 0.0),
                            nan=jnp.inf, posinf=jnp.inf)
        budget = (0.5 * eng.skin_slack) ** 2
        need = jax.lax.pmax(jnp.max(d2), self.axis) > budget  # collective

        zero = jax.lax.pcast(jnp.zeros((), jnp.int32), self.axis,
                             to="varying")
        resc = (self._stencil_rescatter
                if eng.effective_rescatter_mode == "stencil"
                else self._rescatter)
        state, overflow = jax.lax.cond(
            need,
            resc,
            lambda s: (self._refresh_ghosts(s), zero),
            state)

        key_np, rank_np, cell_np, bucket_np = eng._implicit_consts()
        counts = jnp.sum(state.active.reshape(cap, C + 1),
                         axis=0).astype(jnp.int32)
        starts = jnp.concatenate([jnp.zeros(1, jnp.int32),
                                  jnp.cumsum(counts)[:-1].astype(jnp.int32)])
        nbrs = Neighbors(cell=jnp.asarray(cell_np), key=jnp.asarray(key_np),
                         rank=jnp.asarray(rank_np), counts=counts,
                         starts=starts, bucket=jnp.asarray(bucket_np),
                         overflow=overflow)
        return state, nbrs


# ---------------------------------------------------------------- runner

def make_bucket_runner(bds: BucketDomainSharding, mesh: Mesh, make_step,
                       steps_per_frame: int = 1, finalize=None):
    """(run_frame, diagnostics) over the bucket-sharded state. ``make_step``
    receives a BucketShardEngine, so scheme step functions — including their
    Pallas fast paths — run unchanged inside shard_map. ``finalize``
    (optional, per-slot elementwise) materializes lazy per-frame diagnostics
    after the scan, exactly like models.common.frame_runner."""
    seng = BucketShardEngine(bds)
    step = make_step(seng)
    spec = P("x")

    # check_vma=False: pallas_call outputs carry no varying-manual-axes
    # annotation, which the checker would otherwise reject inside shard_map
    @partial(jax.shard_map, mesh=mesh, in_specs=(spec,), out_specs=spec,
             check_vma=False)
    def shard_step_chunk(state: ParticleState) -> ParticleState:
        def body(s, _):
            return step(s), None
        state, _ = jax.lax.scan(body, state, None, length=steps_per_frame)
        if finalize is not None:
            state = finalize(state)
        return state

    run_frame = jax.jit(shard_step_chunk, donate_argnums=0)

    @partial(jax.shard_map, mesh=mesh, in_specs=(spec,),
             out_specs=(P(), P(), P()))
    def _diag(state: ParticleState):
        owned = jnp.asarray(seng.owned_flat) & state.active
        v = jnp.sqrt(jnp.sum(state.fields["v"] ** 2, axis=-1))
        s = jax.lax.psum(jnp.sum(jnp.where(owned, v, 0)), "x")
        n = jax.lax.psum(jnp.sum(owned), "x")
        vmax = jax.lax.pmax(jnp.max(jnp.where(owned, v, 0)), "x")
        return s / jnp.maximum(n, 1), vmax, n

    return run_frame, jax.jit(_diag)


def make_owned_counts(bds: BucketDomainSharding, mesh: Mesh):
    """[n_dev] per-device owned-active particle counts — the load-imbalance
    monitor for drift-triggered rebalancing. One cheap jitted shard_map
    (no collectives: each device reports its own scalar)."""
    seng = BucketShardEngine(bds)
    spec = P("x")

    @partial(jax.shard_map, mesh=mesh, in_specs=(spec,), out_specs=spec)
    def _counts(state: ParticleState):
        owned = jnp.asarray(seng.owned_flat) & state.active
        return jnp.sum(owned, dtype=jnp.int32)[None]

    return jax.jit(_counts)
