"""Operator API (L3): ``apply_unary`` / ``apply_binary`` / pair & point sums.

Mirrors the reference's ``apply!`` dispatch surface (src/core.jl:151-161,
apply_unary! :138-142, apply_binary! :125-129, point/pair ``sum`` :240-291),
re-designed as pure functions over the SoA state:

  * a **unary** action is a function of the particle view returning a dict of
    updated field values (reference: mutate ``p`` in place),
  * a **binary** action is a function ``f(p, q, r) -> {field: contribution}``
    evaluated on every neighbor pair and *summed over neighbors* into the
    named fields of ``p`` — exactly the reference's "mutate p only" race
    discipline (src/core.jl:122-123), but enforced by construction, with a
    fixed deterministic reduction order.

Shapes inside a binary action: ``r`` is [N, K]; scalar fields are ``p.m`` →
[N, 1], ``q.m`` → [N, K]; vector fields are ``p.x`` → [N, 1, d], ``q.x`` →
[N, K, d]. Broadcast a scalar factor onto a vector with ``[..., None]``.
Pairs beyond the interaction radius are masked (their ``r`` is presented as
2h so compact-support kernels vanish), and masked contributions are zeroed.

``self_interaction=True`` adds the r=0 diagonal term once per particle
(reference ``apply!(…; self=true)``, src/core.jl:156).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..structs import ParticleState
from .neighbors import NeighborEngine, Neighbors

__all__ = ["apply_unary", "apply_binary", "pair_sum", "point_sum", "dist",
           "FieldsView"]


def dist(p_x, q_x):
    """Pair distance (reference dist, src/core.jl:8-10)."""
    return jnp.sqrt(jnp.sum((p_x - q_x) ** 2, axis=-1))


class FieldsView:
    """Attribute/item access to particle fields, optionally gathered/expanded.

    mode "p": scalar → [N, 1], vector → [N, 1, d] (broadcast against K axis)
    mode "q": gathered by candidate index [N, K] → [N, K(,d)]
    mode "u": raw [N(,d)] arrays (unary actions)
    """

    def __init__(self, fields: dict, idx=None, expand: bool = False):
        object.__setattr__(self, "_fields", fields)
        object.__setattr__(self, "_idx", idx)
        object.__setattr__(self, "_expand", expand)

    def __getitem__(self, name: str):
        arr = self._fields[name]
        if self._idx is not None:
            return arr[self._idx]
        if self._expand:
            return arr[:, None] if arr.ndim == 1 else arr[:, None, ...]
        return arr

    def __getattr__(self, name: str):
        try:
            return self.__getitem__(name)
        except KeyError as e:
            raise AttributeError(name) from e

    def keys(self):
        return self._fields.keys()


def apply_unary(state: ParticleState, action, where=None, **params) -> ParticleState:
    """Apply a pointwise action (reference apply_unary!, src/core.jl:138-142).

    ``action(p, **params)`` receives the raw-field view and returns a dict of
    new field values. If ``where`` is given (a boolean [N] mask or a function
    of the view returning one), updates apply only where true.
    """
    view = FieldsView(state.fields)
    updates = action(view, **params)
    if where is not None:
        mask = where(view) if callable(where) else where
        out = {}
        for name, val in updates.items():
            old = state.fields[name]
            m = mask if val.ndim == 1 else mask.reshape(mask.shape + (1,) * (val.ndim - 1))
            out[name] = jnp.where(m, val, old)
        updates = out
    # Zero every updated field on inactive rows. Inactive slots hold zeros;
    # unary physics on them (0/0, pow(0,·), …) breeds NaN/Inf, which a
    # masked pair sum can still pick up (0·NaN = NaN) — keep dead rows at
    # exactly 0.
    act = state.active
    updates = {name: jnp.where(
        act.reshape(act.shape + (1,) * (val.ndim - 1)), val, 0)
        for name, val in updates.items()}
    return state.replace(**updates)


def _bmask(mask, val):
    """Broadcast a pair mask over any trailing component dims of val."""
    return mask.reshape(mask.shape + (1,) * (val.ndim - mask.ndim))


def _masked_sum(contrib, mask, dtype):
    return jnp.sum(jnp.where(_bmask(mask, contrib), contrib.astype(dtype), 0),
                   axis=1)


def apply_binary(engine: NeighborEngine, state: ParticleState, nbrs: Neighbors,
                 action, add: bool = True, self_interaction: bool = False,
                 **params) -> ParticleState:
    """Apply a binary action over all neighbor pairs and sum into p's fields
    (reference apply_binary!, src/core.jl:94-129).

    ``action(p, q, r, **params)`` returns ``{field: [N, K(,d)] contribution}``.
    With ``add=True`` (the reference's ``+=`` idiom) sums are added to the
    existing field values; with ``add=False`` they replace them.
    """
    sums = _binary_sums(engine, state, nbrs, action, self_interaction, params)
    updates = {}
    for name, val in sums.items():
        updates[name] = (state.fields[name] + val) if add else val
    return state.replace(**updates)


def pair_sum(engine: NeighborEngine, state: ParticleState, nbrs: Neighbors,
             func, self_interaction: bool = False, **params) -> jnp.ndarray:
    """Per-particle neighbor sum of a scalar pair function (reference
    ``sum(sys, func, p)``, src/core.jl:271-291). ``func(p, q, r)`` → [N, K]."""
    sums = _binary_sums(engine, state, nbrs,
                        lambda p, q, r, **kw: {"__out__": func(p, q, r, **kw)},
                        self_interaction, params)
    return sums["__out__"]


class _BucketView:
    """Lazy bucketized field access for the cell-dense pair path.

    p-side ("p"): [ncells, cap_p, 1(, d)]; q-side at a stencil offset ("q"):
    [ncells, 1, cap_q(, d)] — both produced from one cached bucketization per
    field; the q-side shift is a pure pad+slice, never a gather."""

    def __init__(self, engine, nbrs, fields, cache, offset=None):
        object.__setattr__(self, "_e", engine)
        object.__setattr__(self, "_n", nbrs)
        object.__setattr__(self, "_f", fields)
        object.__setattr__(self, "_c", cache)
        object.__setattr__(self, "_off", offset)

    def _bucket(self, name):
        if name not in self._c:
            self._c[name] = self._e.bucketize(self._n, self._f[name])
        return self._c[name]

    def __getitem__(self, name):
        B = self._bucket(name)
        ncells = self._e.num_cells
        if self._off is None:  # p side
            return jnp.expand_dims(B[:ncells], 2)
        return jnp.expand_dims(self._e.shift_cells(B, self._off), 1)

    def __getattr__(self, name):
        try:
            return self.__getitem__(name)
        except KeyError as e:
            raise AttributeError(name) from e


def _binary_sums_cell(engine, state, nbrs, action, params) -> dict:
    """Cell-dense pair sums: dense [ncells, cap_p, cap_q] blocks per stencil
    offset, zero gathers in the pair loop (gathers happen once per field at
    bucketize time, one per output at the end)."""
    x = state.fields["x"]
    N = x.shape[0]
    dtype = x.dtype
    cap = engine.cap
    ncells = engine.num_cells
    h = jnp.asarray(engine.h, dtype=dtype)

    cache: dict = {}
    occ = engine.occupancy(nbrs)              # [ncells+1, cap]
    occ_p = occ[:ncells][:, :, None]          # [C, cap, 1]
    xB = engine.bucketize(nbrs, x)
    cache["x"] = xB
    xp = xB[:ncells][:, :, None, :]
    pview = _BucketView(engine, nbrs, state.fields, cache)

    slot_eye = (jnp.arange(cap, dtype=jnp.int32)[:, None]
                == jnp.arange(cap, dtype=jnp.int32)[None, :])

    acc: dict = {}
    for offset in engine.stencil:
        occ_q = engine.shift_cells(occ, offset)[:, None, :]
        xq = engine.shift_cells(xB, offset)[:, None, :, :]
        r = dist(xp, xq)                      # [C, cap, cap]
        mask = occ_p & occ_q & (r <= h)
        if all(o == 0 for o in offset):
            mask = mask & ~slot_eye[None, :, :]
        r_safe = jnp.where(mask, r, 2.0 * h)
        qview = _BucketView(engine, nbrs, state.fields, cache, offset=offset)
        contrib = action(pview, qview, r_safe, **params)
        for name, val in contrib.items():
            s = jnp.sum(jnp.where(_bmask(mask, val), val.astype(dtype), 0),
                        axis=2)  # q axis
            acc[name] = s if name not in acc else acc[name] + s

    # back to flat particle order: out[i] = acc[key_i, rank_i]
    ok = state.active & (nbrs.rank < cap)
    idx = jnp.where(ok, nbrs.key * cap + nbrs.rank, ncells * cap)
    out: dict = {}
    for name, val in acc.items():
        flat = val.reshape((ncells * cap,) + val.shape[2:])
        g = jnp.take(flat, jnp.minimum(idx, ncells * cap - 1), axis=0)
        m = ok if g.ndim == 1 else ok[:, None]
        out[name] = jnp.where(m, g, 0)
    return out


class _ResidentView:
    """Lazy resident-layout field access: the state flat rows are bucket
    slots, so views are pure reshapes/slices — zero gathers and scatters.

    p side: [cap, 1, C(, d)]; q side at an offset: [1, cap, C(, d)]."""

    def __init__(self, engine, fields, offset=None, cache=None):
        object.__setattr__(self, "_e", engine)
        object.__setattr__(self, "_f", fields)
        object.__setattr__(self, "_off", offset)
        object.__setattr__(self, "_c", cache if cache is not None else {})

    def _padded(self, name):
        # one materialized pad per field per sweep; all offsets slice it
        if name not in self._c:
            self._c[name] = self._e.pad_resident(
                self._e.resident(self._f[name]))
        return self._c[name]

    def __getitem__(self, name):
        e = self._e
        if self._off is None:
            B = e.resident(self._f[name])  # [cap, C+1(, d)]
            return jnp.expand_dims(B[:, : e.num_cells], 1)
        return jnp.expand_dims(e.slice_resident(self._padded(name), self._off), 0)

    def __getattr__(self, name):
        try:
            return self.__getitem__(name)
        except KeyError as exc:
            raise AttributeError(name) from exc


def _binary_sums_resident(engine, state, nbrs, action, params) -> dict:
    """Pair sums for bucket-resident state: dense [cap_p, cap_q, C] blocks
    with cells riding the vector lanes; no gathers or scatters anywhere."""
    cap = engine.cap
    C = engine.num_cells
    dtype = state.fields["x"].dtype
    h = jnp.asarray(engine.h, dtype=dtype)

    actB = engine.resident(state.active)              # [cap, C+1]
    occ_p = actB[:, : C][:, None, :]                  # [cap, 1, C]
    xB = engine.resident(state.fields["x"])           # [cap, C+1, d]
    xp = xB[:, : C][:, None, :, :]                    # [cap, 1, C, d]
    pview = _ResidentView(engine, state.fields)
    cache: dict = {}
    actP = engine.pad_resident(actB)
    xP = engine.pad_resident(xB)
    qviews = {off: _ResidentView(engine, state.fields, offset=off, cache=cache)
              for off in map(tuple, engine.stencil)}

    eye = (jnp.arange(cap, dtype=jnp.int32)[:, None]
           == jnp.arange(cap, dtype=jnp.int32)[None, :])[:, :, None]

    acc: dict = {}
    for offset in engine.stencil:
        occ_q = engine.slice_resident(actP, offset)[None]   # [1, cap, C]
        xq = engine.slice_resident(xP, offset)[None]        # [1, cap, C, d]
        r = dist(xp, xq)                                    # [cap, cap, C]
        mask = occ_p & occ_q & (r <= h)
        if all(o == 0 for o in offset):
            mask = mask & ~eye
        r_safe = jnp.where(mask, r, 2.0 * h)
        qview = qviews[tuple(offset)]
        contrib = action(pview, qview, r_safe, **params)
        for name, val in contrib.items():
            s = jnp.sum(jnp.where(_bmask(mask, val), val.astype(dtype), 0),
                        axis=1)  # q axis
            acc[name] = s if name not in acc else acc[name] + s

    # back to flat slot order: pad the trash column, reshape
    out: dict = {}
    for name, val in acc.items():  # val [cap, C(, d)]
        pad = ((0, 0), (0, 1)) + ((0, 0),) * (val.ndim - 2)
        out[name] = jnp.pad(val, pad).reshape(
            (cap * (C + 1),) + val.shape[2:])
    return out


def _binary_sums_gather(engine, state, nbrs, action, params) -> dict:
    x = state.fields["x"]
    N = x.shape[0]
    dtype = x.dtype
    h = jnp.asarray(engine.h, dtype=dtype)
    i_idx = jnp.arange(N, dtype=jnp.int32)
    pview = FieldsView(state.fields, expand=True)

    acc: dict = {}
    for offset in engine.stencil:
        cand, valid = engine.stencil_candidates(nbrs, offset)
        xq = x[cand]  # [N, K, d]
        r = dist(x[:, None, :], xq)
        mask = valid & (r <= h) & (cand != i_idx[:, None]) & state.active[:, None]
        r_safe = jnp.where(mask, r, 2.0 * h)
        qview = FieldsView(state.fields, idx=cand)
        contrib = action(pview, qview, r_safe, **params)
        for name, val in contrib.items():
            s = _masked_sum(val, mask, dtype)
            acc[name] = s if name not in acc else acc[name] + s
    return acc


def _binary_sums(engine, state, nbrs, action, self_interaction, params) -> dict:
    N = state.fields["x"].shape[0]
    dtype = state.fields["x"].dtype
    if getattr(engine, "layout", "flat") == "bucket":
        acc = _binary_sums_resident(engine, state, nbrs, action, params)
    elif getattr(engine, "pair_mode", "cell") == "cell":
        acc = _binary_sums_cell(engine, state, nbrs, action, params)
    else:
        acc = _binary_sums_gather(engine, state, nbrs, action, params)

    if self_interaction:
        # reference: apply_unary!(p -> action!(p, p, 0.0)) (src/core.jl:156)
        uview = FieldsView(state.fields, expand=True)
        zero_r = jnp.zeros((N, 1), dtype=dtype)
        contrib = action(uview, uview, zero_r, **params)
        amask = state.active[:, None]
        for name, val in contrib.items():
            acc[name] = acc[name] + _masked_sum(val, amask, dtype)
    return acc


def point_sum(engine: NeighborEngine, state: ParticleState, nbrs: Neighbors,
              func, xs, **params) -> jnp.ndarray:
    """SPH interpolation at arbitrary points (reference ``sum(sys, func, x)``,
    src/core.jl:240-260).

    ``xs`` is [M, dim]; ``func(q, r)`` receives q fields gathered to
    [M, K] and distances [M, K], returns [M, K]; result is the masked sum
    over all neighbors of each point.
    """
    xs = jnp.asarray(xs, dtype=state.fields["x"].dtype)
    if xs.ndim == 1:
        xs = xs[None]
    h = jnp.asarray(engine.h, dtype=xs.dtype)
    # bin with the per-axis cell widths, NOT h — cells are skin-widened
    # (and possibly lattice-aligned anisotropic)
    cell = (jnp.floor(xs / jnp.asarray(engine.cell_size, xs.dtype))
            .astype(jnp.int32)
            - jnp.asarray(engine.phase, dtype=jnp.int32))
    lims = jnp.asarray(engine.lims, dtype=jnp.int32)
    x = state.fields["x"]
    out = jnp.zeros(xs.shape[0], dtype=xs.dtype)
    for offset in engine.stencil:
        ncell = cell + jnp.asarray(offset, dtype=jnp.int32)
        in_grid = jnp.all((ncell >= 0) & (ncell < lims), axis=-1)
        nkey = jnp.where(in_grid, engine.flat_key(jnp.clip(ncell, 0, lims - 1)),
                         engine.num_cells)
        cnt = jnp.where(in_grid, nbrs.counts[nkey], 0)
        cand = nbrs.bucket[nkey]
        valid = jnp.arange(engine.cap, dtype=jnp.int32)[None, :] < cnt[:, None]
        r = dist(xs[:, None, :], x[cand])
        mask = valid & (r <= h)
        qview = FieldsView(state.fields, idx=cand)
        val = func(qview, jnp.where(mask, r, 2.0 * h), **params)
        out = out + jnp.sum(jnp.where(mask, val, 0), axis=1)
    return out
