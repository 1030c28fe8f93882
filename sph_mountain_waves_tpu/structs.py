"""Domain model (L2): particle-system container + SoA state pytree.

The reference stores particles as a ``Vector{mutable struct}`` with a spatial
hash scaffold (src/structs.jl:43-92) and views fields through
``ParticleField`` (src/structs.jl:118-125). This design inverts the
layout: **state is a struct-of-arrays pytree** (``ParticleState``) with fixed
capacity and an ``active`` mask, so the whole simulation state flows through
``jit``/``lax.scan`` without reallocation, and "removing" a particle
(reference create_cell_list! compaction, src/core.jl:72-81) is a mask flip.

``ParticleSystem`` is the host-side builder: it mirrors the reference
constructor contract (particle type + domain + h, src/structs.jl:57-91) and
``generate_particles!`` (src/grids.jl:295-311), accumulating particles in
NumPy, then ``freeze()`` produces the device state plus a ``NeighborEngine``
whose cell-key arithmetic is exactly the reference's
(key_phase/key_lim/key_max, src/structs.jl:66-68, find_key :97-106).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from .geometry import Shape, boundarybox, is_inside

__all__ = ["ParticleState", "ParticleSystem", "ParticleField", "DataField",
           "generate_particles"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ParticleState:
    """Struct-of-arrays particle state: ``fields[name] -> [N_cap, ...]`` plus
    an ``active`` mask. A pytree — passes through jit/scan/shard_map."""
    fields: dict[str, jnp.ndarray]
    active: jnp.ndarray  # bool [N_cap]

    @property
    def capacity(self) -> int:
        return self.active.shape[0]

    @property
    def n(self) -> jnp.ndarray:
        """Number of active particles (traced value under jit)."""
        return jnp.sum(self.active)

    def replace(self, **fields) -> "ParticleState":
        new = dict(self.fields)
        new.update(fields)
        return ParticleState(fields=new, active=self.active)

    def with_active(self, active) -> "ParticleState":
        return ParticleState(fields=self.fields, active=active)

    def __getitem__(self, name: str) -> jnp.ndarray:
        return self.fields[name]


def _field_shape(spec) -> tuple:
    """Field spec: 0/() = scalar, d = d-vector, (a, b) = matrix."""
    if spec in (0, (), None):
        return ()
    if isinstance(spec, int):
        return (spec,)
    return tuple(spec)


class ParticleSystem:
    """Host-side simulation container (reference ParticleSystem,
    src/structs.jl:43-92).

    Parameters
    ----------
    fields : dict mapping field name -> shape spec (0 scalar, d vector,
        (a,b) matrix). Must contain ``x``. This replaces the reference's
        particle struct declaration.
    domain : Shape. Particles outside ``boundarybox(domain)`` are deactivated
        on every cell-list rebuild (reference removal, src/core.jl:63-81).
    h : interaction radius — pairs farther than ``h`` never interact
        (src/core.jl:105-107); also the cell size.
    dim : 2 or 3 (reference infers from key_lim[3]==1, src/structs.jl:70-82).
    defaults : optional dict of default field values for generated particles.
    dtype : state float dtype (float32 on the GPU; tests may use float64).
    """

    def __init__(self, fields: dict, domain: Shape, h: float, dim: int = 2,
                 defaults: dict | None = None, dtype=jnp.float32):
        assert h > 0.0, "invalid ParticleSystem declaration! (h must be positive)"
        assert "x" in fields, "particles must have a field `x`"
        self.h = float(h)
        self.domain_shape = domain
        self.domain = boundarybox(domain)  # reference stores the box (src/structs.jl:63,87)
        self.dim = int(dim)
        self.dtype = dtype
        self.field_specs = {name: _field_shape(spec) for name, spec in fields.items()}
        self.field_specs["x"] = (self.dim,)
        self.defaults = dict(defaults or {})
        self._chunks: list[dict[str, np.ndarray]] = []
        self.state: ParticleState | None = None
        self.engine = None  # set by freeze()
        self.freeze_opts: dict = {}  # default kwargs for freeze()

    # ---------------------------------------------------------------- build
    def add_particles(self, xs: np.ndarray, values: dict) -> None:
        """Append particles at positions ``xs`` [N, 2|3] with field values
        (scalars broadcast). Host-side; call before ``freeze``."""
        xs = np.asarray(xs, dtype=np.float64)
        if xs.ndim == 1:
            xs = xs[None]
        n = len(xs)
        if n == 0:
            return
        chunk: dict[str, np.ndarray] = {}
        for name, shape in self.field_specs.items():
            if name == "x":
                chunk["x"] = xs[:, : self.dim]
                continue
            if name in values:
                v = np.asarray(values[name], dtype=np.float64)
            elif name in self.defaults:
                v = np.asarray(self.defaults[name], dtype=np.float64)
            else:
                v = np.zeros(shape)
            v = np.broadcast_to(v, (n,) + shape).copy() if v.shape != (n,) + shape else v
            chunk[name] = v
        self._chunks.append(chunk)
        self.state = None  # invalidate frozen state

    @property
    def n_built(self) -> int:
        return sum(len(c["x"]) for c in self._chunks)

    def host_fields(self) -> dict[str, np.ndarray]:
        """Concatenated host-side field arrays of all built particles."""
        out = {}
        for name, shape in self.field_specs.items():
            if self._chunks:
                out[name] = np.concatenate(
                    [c.get(name, np.zeros((len(c["x"]),) + shape))
                     for c in self._chunks])
            else:
                out[name] = np.zeros((0,) + shape)
        return out

    # --------------------------------------------------------------- freeze
    def freeze(self, capacity: int | None = None, cap: int | None = None,
               engine=None, **engine_opts) -> ParticleState:
        """Materialize the device-side ``ParticleState`` (and a
        ``NeighborEngine``, stored as ``self.engine``).

        capacity : total particle slots (≥ built count); extra slots start
            inactive and serve as spawn pools (reference dynamic-N semantics,
            sph_jl/examples/cylinder.jl:150-161). Ignored for the bucket
            layout, whose capacity is the engine's slot count.
        cap : neighbor-cell bucket capacity override (default: measured
            max occupancy × 1.5 + margin).
        engine_opts : forwarded to NeighborEngine.create (layout, skin,
            pair_mode, …); defaults come from ``self.freeze_opts``.
        """
        from .ops.neighbors import NeighborEngine  # avoid import cycle

        host = self.host_fields()
        n = len(host["x"])
        opts = dict(self.freeze_opts)
        opts.update(engine_opts)
        if capacity is None:
            capacity = opts.pop("capacity", None)
        else:
            opts.pop("capacity", None)
        if cap is None:
            cap = opts.pop("cap", None)
        else:
            opts.pop("cap", None)
        if engine is None:
            engine = NeighborEngine.create(
                box=self.domain, h=self.h, dim=self.dim,
                positions=host["x"] if n else None, cap=cap, dtype=self.dtype,
                **opts)
        self.engine = engine

        if engine.layout == "bucket":
            # rows ARE bucket slots: place particles host-side directly in
            # their slots (rank*(C+1)+key, same f32 key arithmetic as
            # _screen_and_key) so no boot rescatter is needed and the
            # 1-cell-local stencil rescatter's assumption (rows near their
            # cells) holds from step 0. _xref = x.
            self.field_specs.setdefault("_xref", (self.dim,))
            capacity = engine.slots
            assert n <= capacity, (n, capacity)
            return self._freeze_bucket(engine, host, n)
        else:
            if capacity is None:
                capacity = max(n, 1)
            capacity = int(-(-capacity // 8) * 8)  # round up to multiple of 8

        fields = {}
        for name, shape in self.field_specs.items():
            arr = np.zeros((capacity,) + shape, dtype=np.float64)
            if name == "_xref":
                arr[:] = np.inf
            elif name in host:
                arr[:n] = host[name]
            fields[name] = jnp.asarray(arr, dtype=self.dtype)
        active = jnp.arange(capacity) < n
        self.state = ParticleState(fields=fields, active=active)
        return self.state

    def _freeze_bucket(self, engine, host: dict, n: int) -> ParticleState:
        """Host-side slot placement for the bucket layout (dtype-matched to
        the device key arithmetic of NeighborEngine._screen_and_key)."""
        C, cap = engine.num_cells, engine.cap
        slots = engine.slots
        sdt = np.dtype(jnp.dtype(self.dtype))
        if n:
            x = np.asarray(host["x"], dtype=np.float64).astype(sdt)[:, :self.dim]
            L = np.asarray(engine.cell_size, dtype=sdt)
            ci = np.floor(x / L).astype(np.int64) - np.asarray(engine.phase)
            ci = np.clip(ci, 0, np.asarray(engine.lims) - 1)
            key = ci[:, 0]
            stride = engine.lims[0]
            for a in range(1, self.dim):
                key = key + stride * ci[:, a]
                stride *= engine.lims[a]
            order = np.argsort(key, kind="stable")
            key_s = key[order]
            counts = np.bincount(key_s, minlength=C + 1)
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            rank = np.arange(n) - starts[key_s]
            if rank.size and rank.max() >= cap:
                raise ValueError(
                    f"initial occupancy {int(rank.max()) + 1} > cap {cap}")
            slot = rank * (C + 1) + key_s
        else:
            order = slot = np.zeros(0, dtype=np.int64)

        fields = {}
        for name, shape in self.field_specs.items():
            arr = np.zeros((slots,) + shape, dtype=np.float64)
            if name != "_xref" and name in host and n:
                arr[slot] = np.asarray(host[name])[order]
            fields[name] = jnp.asarray(arr, dtype=self.dtype)
        # _xref must be a DISTINCT buffer (not an alias of x): donated-arg
        # execution rejects the same buffer appearing twice in a pytree.
        fields["_xref"] = fields["x"] + jnp.zeros((), self.dtype)
        active = np.zeros(slots, dtype=bool)
        active[slot] = True
        self.state = ParticleState(fields=fields,
                                   active=jnp.asarray(active))
        return self.state

    # ------------------------------------------------------------ accessors
    def field(self, name: str) -> np.ndarray:
        """Host copy of an active-particle field (reference ParticleField view,
        src/structs.jl:118-125)."""
        assert self.state is not None, "freeze() the system first"
        act = np.asarray(self.state.active)
        return np.asarray(self.state.fields[name])[act]

    @property
    def n(self) -> int:
        if self.state is None:
            return self.n_built
        return int(np.sum(np.asarray(self.state.active)))


def ParticleField(sys: ParticleSystem, name: str) -> np.ndarray:
    """Reference-API shim: ``ParticleField(sys, :P)`` → host array of the
    field over active particles (src/structs.jl:108-125)."""
    return sys.field(name)


DataField = ParticleField  # reference exports both names (src/SmoothedParticles.jl:37)


def generate_particles(sys: ParticleSystem, grid, geometry: Shape,
                       constructor: Callable[[np.ndarray], dict]) -> int:
    """Create particles at every grid point inside ``geometry``
    (reference generate_particles!, src/grids.jl:295-311).

    ``constructor`` receives the [N, 3] lattice points and returns a dict of
    field values (vectorized); scalars broadcast. Returns the particle count
    added.
    """
    from .grids import covering
    xs = covering(grid, geometry)
    if len(xs) == 0:
        return 0
    values = constructor(xs)
    if "x" in values:
        xs = np.asarray(values.pop("x"))
    sys.add_particles(xs, values)
    return len(xs)
