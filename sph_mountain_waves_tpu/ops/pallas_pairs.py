"""Pallas pair-sweep kernel for the resident bucket layout (2-D + 3-D), on
the GPU through the Triton route.

The XLA cell-dense path (ops/apply.py ``_binary_sums_resident``) evaluates
every (slot_p, slot_q) pair of a dense ``[cap, cap, C]`` block per stencil
offset and re-reads every field once per offset. This kernel instead walks
the q-slot axis with a **dynamic per-row trip count** (the max occupancy
over the row's stencil band, ``row_kmax``), skipping empty slots, and sums
all 9 (2-D) / 27 (3-D) stencil contributions in registers before one store.

Program layout: one program = one grid row (2-D: a y row; 3-D: a (y, z)
row) × one x-tile of ``tx`` cells × one chunk of ``P_ROWS`` p-slots. The
p block is ``[P_ROWS, tx]``; each q slot at each stencil offset is a
``[tx]`` vector loaded straight from global memory with ``pl.ds`` (L1/L2
serve the halo). Tiling the cap axis in chunks of 8 keeps caps that are not
a power of two (terrain 24, collapse3d 40) free of padding waste.

Layout contract (NeighborEngine layout="bucket"): a field is [cap, C+1] with
C = nx·ny(·nz) flat row-major cells (slot = k·(C+1) + (z·ny+)y·nx + x). A
q row outside the grid is clamped for the load and masked; column overrun
at row edges wraps into the neighboring row exactly like the reference's
flat-key arithmetic (src/structs.jl:97-106) and is removed by the distance
cutoff.

Masking discipline: bodies receive ``maskf`` (float 0/1) and MULTIPLY it into
their contribution instead of select chains, which is safe because every
hoisted per-particle input is floored/flushed to keep empty rows finite
(0·NaN would survive the multiply-mask).

Used by the mountain-wave schemes (all five: wcsph/hopkins/full_hopkins/
hopkins_total/pavelka), the legacy terrain schemes, ISPH, Rayleigh-Bénard
and the dam breaks when cfg.use_pallas=True; validated against the plain
XLA sweep in tests (interpret mode on CPU) and on the card
(``ops/kernel_parity.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

__all__ = [
    "density_pass", "pressure_pass", "momentum_pass",
    "hopkins_momentum_pass", "pavelka_mass_pass",
    "pavelka_momentum_entropy_pass", "dambreak_mass_pass",
    "dambreak_force_pass", "legacy_mass_pass", "legacy_force_pass",
    "row_kmax", "make_pair_kernel_fn",
]

P_ROWS = 8        # p slots per program: one chunk of the cap axis
LANES = 128       # x-tile width on the card (a power of two; nx is ×128)
NUM_WARPS = 4     # a [8, 128] f32 block is 8 elements per thread at 4 warps
NUM_STAGES = 2    # software-pipeline depth of the q-slot loop


def _grid_rows(engine):
    """Number of grid rows: ny (2-D) or ny·nz (3-D)."""
    if engine.dim == 2:
        return engine.lims[1]
    return engine.lims[1] * engine.lims[2]


def row_kmax(engine, state):
    """(band_max, row_max): per-grid-row max bucket occupancy maxed over the
    stencil band (the q-slot trip bound) and for the row itself (the p-chunk
    bound). Each [R] int32 with R = ny (2-D) or ny·nz (3-D)."""
    C = engine.num_cells
    nx = engine.lims[0]
    R = _grid_rows(engine)
    occ = engine.resident(state.active)[:, :C]          # [cap, C]
    per_cell = jnp.sum(occ, axis=0)                     # [C]
    per_row = jnp.max(per_cell.reshape(R, nx), axis=1)  # [R]
    if engine.dim == 2:
        padded = jnp.pad(per_row, (1, 1))
        band = jnp.maximum(jnp.maximum(padded[:-2], padded[1:-1]), padded[2:])
    else:
        ny, nz = engine.lims[1], engine.lims[2]
        G = jnp.pad(per_row.reshape(nz, ny), ((1, 1), (1, 1)))
        band = jnp.zeros((nz, ny), per_row.dtype)
        for dk in range(3):
            for dj in range(3):
                band = jnp.maximum(band, G[dk:dk + nz, dj:dj + ny])
        band = band.reshape(R)
    return band.astype(jnp.int32), per_row.astype(jnp.int32)


def _tile_lanes(nx: int, interpret: bool) -> int:
    """x-tile width: ``LANES`` on the card; in interpret mode the smallest
    power of two covering the row, so the interpreter runs one program per
    row and p-chunk (its cost is per program, not per lane)."""
    if interpret:
        return 1 << (nx - 1).bit_length()
    return LANES


def _pad_fields(fields, pad_vals, cap_pad, tail):
    """[cap, C+1] resident fields → [cap_pad, 1 + C+1 + tail]: one leading
    column for the x = −1 neighbor of cell 0, ``tail`` columns for the
    overhang of a last x-tile wider than the row, and zero rows up to the
    8-aligned ``cap_pad`` (unoccupied, masked; never a q slot since the trip
    bound is ≤ cap).

    ``pad_vals`` sets the column pad value per field. Masked pad
    contributions must be EXACTLY zero, which needs every intermediate
    finite: a zero pad in a smoothing-length field flows through
    hinv = 1/0 = inf into ker = 0·inf = NaN (rdw(q.h) in the Hopkins
    momentum), and NaN survives the multiply-mask, so h-like fields pad
    with their floor, exactly like the in-grid empty slots they imitate."""
    out = []
    for f, v in zip(fields, pad_vals):
        f = jnp.pad(f, ((0, 0), (1, tail)), constant_values=v)
        out.append(jnp.pad(f, ((0, cap_pad - f.shape[0]), (0, 0))))
    return out


def _make_pair_kernel(engine, n_in, n_out, pair_body, self_pair, tx, ncx):
    """Build the kernel for one pair sweep.

    pair_body(p_fields, q_fields, r2, maskf) -> list of [P_ROWS, tx]
    contribs, each already multiplied by maskf. p_fields[i] is
    [P_ROWS, tx]; q_fields[i] is [tx] (one q slot at one stencil offset,
    broadcastable as ``q[None, :]``). Field 0 is the occupancy plane."""
    dim = engine.dim
    nx, ny = engine.lims[0], engine.lims[1]
    nz = engine.lims[2] if dim == 3 else 1
    h2 = engine.h * engine.h
    planes = (-1, 0, 1) if dim == 3 else (0,)
    out_w = ncx * tx    # output columns per grid row

    def kernel(kmax_ref, kmaxp_ref, *refs):
        in_refs, out_refs = refs[:n_in], refs[n_in:]
        row = pl.program_id(0)
        x0 = pl.program_id(1) * tx
        p0 = pl.program_id(2) * P_ROWS
        jy, jz = (row, 0) if dim == 2 else (row % ny, row // ny)

        # +1: the leading pad column of _pad_fields
        pstart = 1 + row * nx + x0
        p_all = [r[pl.ds(p0, P_ROWS), pl.ds(pstart, tx)] for r in in_refs]
        occ_p = p_all[0] > 0.5
        # a chunk past the row's occupancy has no p particle: zero trips
        trip = jnp.where(p0 < kmaxp_ref[row], kmax_ref[row], 0)
        slot_ids = p0 + jax.lax.broadcasted_iota(jnp.int32, (P_ROWS, tx), 0)

        # per-offset q start column and row validity (loop invariant). An
        # out-of-grid q row is clamped for the load and masked by `valid`.
        offsets = []
        for dk in planes:
            qz = jz + dk
            for dj in (-1, 0, 1):
                qy = jy + dj
                valid = (qy >= 0) & (qy < ny)
                qrow = jnp.clip(qy, 0, ny - 1)
                if dim == 3:
                    valid = valid & (qz >= 0) & (qz < nz)
                    qrow = qrow + ny * jnp.clip(qz, 0, nz - 1)
                for di in (-1, 0, 1):
                    center = dk == 0 and dj == 0 and di == 0
                    offsets.append((1 + qrow * nx + x0 + di, valid, center))

        def q_slot(kq, accs):
            tot = [None] * n_out
            for start, valid, center in offsets:
                q_all = [r[kq, pl.ds(start, tx)] for r in in_refs]
                r2 = (p_all[1] - q_all[1][None, :]) ** 2
                for a in range(2, 1 + dim):
                    r2 = r2 + (p_all[a] - q_all[a][None, :]) ** 2
                mask = (occ_p & (q_all[0] > 0.5)[None, :] & valid
                        & (r2 <= h2))
                if center and not self_pair:
                    mask = mask & (slot_ids != kq)
                contribs = pair_body(p_all, q_all, r2,
                                     mask.astype(jnp.float32))
                tot = [c if t is None else t + c
                       for t, c in zip(tot, contribs)]
            # the 9/27 stencil terms of one slot form independent chains;
            # the carry is touched once per slot
            return tuple(a + t for a, t in zip(accs, tot))

        zeros = jnp.zeros((P_ROWS, tx), jnp.float32)
        accs = jax.lax.fori_loop(0, trip, q_slot, (zeros,) * n_out)
        for o, a in zip(out_refs, accs):
            o[pl.ds(p0, P_ROWS), pl.ds(row * out_w + x0, tx)] = a

    return kernel


def make_pair_kernel_fn(engine, state, static_fields, n_dyn, pair_body,
                        n_out, self_pair, interpret=False, pad_vals=None,
                        tx=None):
    """Prepare a pair-sweep kernel with a static/dynamic field split and
    return ``call(dyn_fields) -> outs``. The occupancy plane, the padded
    STATIC field buffers and the per-row trip bounds (row_kmax) are built
    exactly once at prepare time; each ``call`` pads only the ``n_dyn``
    DYNAMIC resident fields and invokes the kernel. For solver loops
    (e.g. the per-CG-iteration matvec inside ``lax.while_loop``) this
    keeps the invariant pad/reshape work out of the loop body by
    construction instead of relying on XLA loop-invariant code motion.
    ``pair_body`` sees fields indexed [occ] + static + dynamic.

    The kernel compiles for the GPU only; ``interpret=True`` runs it in
    the Pallas interpreter on any backend (the CPU tests). ``tx`` overrides
    the x-tile width (a power of two)."""
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the Pallas pair-sweep kernel compiles for the GPU only "
            f"(backend is {jax.default_backend()!r}); use the XLA path "
            "(use_pallas=False) or interpret=True")
    nx = engine.lims[0]
    cap = engine.cap
    C = engine.num_cells
    R = _grid_rows(engine)
    n_static = len(static_fields)
    if pad_vals is None:
        pad_vals = [0.0] * (n_static + n_dyn)
    assert len(pad_vals) == n_static + n_dyn, \
        f"pad_vals has {len(pad_vals)} entries for {n_static + n_dyn} fields"
    pad_static = [0.0] + list(pad_vals[:n_static])  # occupancy pads 0
    pad_dyn = list(pad_vals[n_static:])
    n_in = 1 + n_static + n_dyn

    tx = tx or _tile_lanes(nx, interpret)
    assert tx & (tx - 1) == 0, f"x-tile width must be a power of two: {tx}"
    ncx = -(-nx // tx)
    tail = ncx * tx - nx   # last tile's overhang past the row
    cap_pad = -(-cap // P_ROWS) * P_ROWS
    occf = engine.resident(state.active).astype(jnp.float32)
    ins_static = _pad_fields([occf] + list(static_fields), pad_static,
                             cap_pad, tail)
    kmax, kmaxp = row_kmax(engine, state)
    kernel = _make_pair_kernel(engine, n_in, n_out, pair_body, self_pair,
                               tx, ncx)

    def call(dyn_fields):
        assert len(dyn_fields) == n_dyn
        ins_dyn = _pad_fields(list(dyn_fields), pad_dyn, cap_pad, tail)
        outs = pl.pallas_call(
            kernel,
            grid=(R, ncx, cap_pad // P_ROWS),
            out_shape=[jax.ShapeDtypeStruct((cap_pad, R * ncx * tx),
                                            jnp.float32)] * n_out,
            compiler_params=pltriton.CompilerParams(
                num_warps=NUM_WARPS, num_stages=NUM_STAGES),
            interpret=interpret,
            name="pair_sweep",
        )(kmax, kmaxp, *ins_static, *ins_dyn)
        if tail:   # drop the overhang columns of partial last tiles
            outs = [o[:cap].reshape(cap, R, ncx * tx)[:, :, :nx]
                    .reshape(cap, C) for o in outs]
        else:
            outs = [o[:cap] for o in outs]
        # back to [cap*(C+1)] flat with the trash column re-appended
        return [jnp.pad(o, ((0, 0), (0, 1))).reshape(cap * (C + 1))
                for o in outs]

    return call


def _run_pair_kernel(engine, state, fields, pair_body, n_out, self_pair,
                     interpret=False, pad_vals=None):
    return make_pair_kernel_fn(engine, state, fields, 0, pair_body, n_out,
                               self_pair, interpret=interpret,
                               pad_vals=pad_vals)([])


def _resident_xhm(engine, state, h_floor):
    """Common hoists: per-axis coords + floored h, resident layout."""
    f = state.fields
    x = f["x"]
    coords = [engine.resident(x[:, a]) for a in range(engine.dim)]
    hB = engine.resident(jnp.maximum(f["h"], h_floor))
    return coords, hB


def _hfloor(engine):
    # keeps 1/h finite on empty rows; far smaller than any physical h
    return 1e-3 * engine.h


# --------------------------------------------------------------------- W Σ

def weighted_w_pass(engine, state, cfg, weight, ker_h: str = "p",
                    interpret=False):
    """Σ weight_q · w(h, r) over the stencil — the shared shape of the
    kernel-summation passes:

    * density (compute_density!, wcsph_perturbed_witch.jl:226-228):
      weight = m, ker_h="p" (the gather kernel uses p's smoothing length)
    * Hopkins smoothed pressure root (compute_pressure!,
      hopkins_perturbed_witch.jl:205-208): weight = m·A^(1/γ), ker_h="sym"
      (symmetric h_ij = ½(hp+hq))

    ``weight`` is a per-particle [N] array; self term per cfg.self_density.
    """
    from ..kernels import wendland2, wendland3
    wfun = wendland2 if engine.dim == 2 else wendland3
    d = engine.dim
    CW = 2.228169203286535 if d == 2 else 3.3422538049298023  # kernels.py
    f = state.fields
    if ker_h == "p":
        # stream 1/h instead of h: the kernel value becomes divide-free
        # (w = C·pos(1-r·hinv)^4·(1+4·r·hinv)·hinv^dim), saving 2
        # divides per pair element vs wfun(h, r)
        hinvB = engine.resident(1.0 / jnp.maximum(f["h"], _hfloor(engine)))
        coords = [engine.resident(f["x"][:, a]) for a in range(d)]
        fields_h = coords + [hinvB]
    else:
        coords, hB = _resident_xhm(engine, state, _hfloor(engine))
        fields_h = coords + [hB]
    wB = engine.resident(weight)
    # edge cells read pad columns: h pads with its floor (a zero h
    # NaN-poisons via 1/h — see _pad_fields), everything else with 0
    pad_vals = ([0.0] * d + [0.0 if ker_h == "p" else _hfloor(engine)]
                + [0.0])

    def body(p_all, q_all, r2, maskf):
        wq = q_all[2 + d]
        r = jnp.sqrt(r2)
        if ker_h == "p":
            hinv = p_all[1 + d]
            x = r * hinv
            t = jnp.maximum(1.0 - x, 0.0)
            t2 = t * t
            hpow = hinv * hinv if d == 2 else hinv * hinv * hinv
            ker = CW * t2 * t2 * (1.0 + 4.0 * x) * hpow
        else:
            hk = 0.5 * (p_all[1 + d] + q_all[1 + d][None, :])
            ker = wfun(hk, r)
        return [maskf * wq[None, :] * ker]

    (out,) = _run_pair_kernel(engine, state, fields_h + [wB], body, 1,
                              self_pair=cfg.self_density, interpret=interpret,
                              pad_vals=pad_vals)
    return out


def density_pass(engine, state, cfg, interpret=False):
    """Σ q.m · w(p.h, r) (scheme compute_density!,
    wcsph_perturbed_witch.jl:226-228), self term per cfg.self_density."""
    return weighted_w_pass(engine, state, cfg, state.fields["m"],
                           ker_h="p", interpret=interpret)


def pressure_pass(engine, state, cfg, interpret=False):
    """Hopkins smoothed-pressure root Σ q.m·q.A^{1/γ}·w(h_ij, r)
    (compute_pressure!, hopkins_perturbed_witch.jl:205-208; identical pass in
    full_hopkins_perturbed_witch.jl:206-214 and hopkins_total_witch.jl:168-180)."""
    weight = state.fields["m"] * state.fields["A"] ** (1.0 / cfg.gamma)
    return weighted_w_pass(engine, state, cfg, weight, ker_h="sym",
                           interpret=interpret)


# ------------------------------------------------------------- momentum

def _rdw_const(dim):
    # -C of rDwendland{2,3} = (dw/dr)/r = -C·pos(1-r/h)^3 / h^{dim+2}
    return -44.563384065730695 if dim == 2 else -66.84507609859604


def momentum_pass(engine, state, cfg, interpret=False):
    """Perturbation-pressure + Monaghan-viscosity momentum sweep
    (balance_of_momentum!, wcsph_perturbed_witch.jl:261-286; identical form
    in hopkins_perturbed_witch.jl:276-301). Returns the per-axis Dv pair-sum
    contributions in flat slot order.

    Per-particle quantities (sound speed c = √(γP/ρ), pressure term P′/ρ²,
    floored ρ) are hoisted out of the kernel — the per-pair body carries a
    single sqrt."""
    f = state.fields
    d = engine.dim
    gamma, alpha, beta, eps = cfg.gamma, cfg.alpha, cfg.beta, cfg.eps
    rho_f = jnp.maximum(f["rho"], cfg.rho_floor)
    Aterm = f["P_p"] / rho_f**2
    cs = jnp.sqrt(jnp.maximum(gamma * f["P"] / rho_f, 0.0))
    coords, hB = _resident_xhm(engine, state, _hfloor(engine))
    fields = coords + [hB] + [engine.resident(a) for a in (
        (f["m"],) + tuple(f["v"][:, a] for a in range(d))
        + (rho_f, Aterm, cs))]
    DW = _rdw_const(d)

    def body(p_all, q_all, r2, maskf):
        hp = p_all[1 + d]
        mq, rhoq, Aq, cq = (q_all[2 + d][None, :], q_all[3 + 2 * d][None, :],
                            q_all[4 + 2 * d][None, :], q_all[5 + 2 * d][None, :])
        rhop, Ap, cp = p_all[3 + 2 * d], p_all[4 + 2 * d], p_all[5 + 2 * d]

        r = jnp.sqrt(r2)
        h_ij = 0.5 * (hp + q_all[1 + d][None, :])
        hinv = 1.0 / h_ij
        t = jnp.maximum(1.0 - r * hinv, 0.0) * maskf
        hinv2 = hinv * hinv
        ker = DW * t * t * t * (hinv2 * hinv2 if d == 2
                                else hinv2 * hinv2 * hinv)

        dx = [p_all[1 + a] - q_all[1 + a][None, :] for a in range(d)]
        dv = [p_all[3 + d + a] - q_all[3 + d + a][None, :] for a in range(d)]
        dot = sum(dx[a] * dv[a] for a in range(d))

        c_ij = 0.5 * (cp + cq)
        rho_ij = 0.5 * (rhop + rhoq)
        mu_ij = h_ij * dot / (r2 + eps * h_ij * h_ij)
        pi_ij = (-alpha * c_ij * mu_ij + beta * mu_ij * mu_ij) / rho_ij
        # fold pressure + viscosity into one -mq·ker·(...) product
        s = -mq * ker * (Ap + Aq
                         + (dot < 0.0).astype(jnp.float32) * pi_ij)
        return [s * dx[a] for a in range(d)]

    pad_vals = [0.0] * d + [_hfloor(engine)] + [0.0] * (4 + d)
    return _run_pair_kernel(engine, state, fields, body, d,
                            self_pair=False, interpret=interpret,
                            pad_vals=pad_vals)


def hopkins_momentum_pass(engine, state, cfg, background_split: bool,
                          interpret=False):
    """Hopkins two-kernel P^(1−2/γ) gradient momentum + Monaghan viscosity.

    background_split=False: total form (balance_of_momentum!,
    hopkins_total_witch.jl:229-263). background_split=True: a_tot − a_bg
    with background entropy A_bg (full_hopkins_perturbed_witch.jl:284-318).

    Hoisted per particle: Ag = A^{1/γ}, Pe = max(P, floor)^(1−2/γ), their
    _bg twins, floored ρ and sound speed; the pair body then computes
    prefac·(Pe_p·ker_p + Pe_q·ker_q) with per-particle-h kernels."""
    f = state.fields
    d = engine.dim
    gamma, alpha, beta, eps = cfg.gamma, cfg.alpha, cfg.beta, cfg.eps
    expfac = 1.0 - 2.0 / gamma
    rho_f = jnp.maximum(f["rho"], cfg.rho_floor)
    cs = jnp.sqrt(jnp.maximum(gamma * f["P"] / rho_f, 0.0))
    Ag = f["A"] ** (1.0 / gamma)
    Pe = jnp.maximum(f["P"], cfg.P_floor) ** expfac
    hoisted = [f["m"]] + [f["v"][:, a] for a in range(d)] + [rho_f, cs, Ag, Pe]
    if background_split:
        Abg_g = f["A_bg"] ** (1.0 / gamma)
        Pbg_e = jnp.maximum(f["P_bg"], cfg.P_floor) ** expfac
        hoisted += [Abg_g, Pbg_e]
    coords, hB = _resident_xhm(engine, state, _hfloor(engine))
    fields = coords + [hB] + [engine.resident(a) for a in hoisted]
    DW = _rdw_const(d)
    b0 = 2 + d  # index of first hoisted field (after occ, coords, h)

    def body(p_all, q_all, r2, maskf):
        hp = p_all[1 + d]
        hq = q_all[1 + d][None, :]
        mq = q_all[b0][None, :]
        rhop, rhoq = p_all[b0 + 1 + d], q_all[b0 + 1 + d][None, :]
        cp, cq = p_all[b0 + 2 + d], q_all[b0 + 2 + d][None, :]
        Agp, Agq = p_all[b0 + 3 + d], q_all[b0 + 3 + d][None, :]
        Pep, Peq = p_all[b0 + 4 + d], q_all[b0 + 4 + d][None, :]

        r = jnp.sqrt(r2)

        def rdw(h):
            hinv = 1.0 / h
            t = jnp.maximum(1.0 - r * hinv, 0.0) * maskf
            hinv2 = hinv * hinv
            return DW * t * t * t * (hinv2 * hinv2 if d == 2
                                     else hinv2 * hinv2 * hinv)

        ker_i = rdw(hp)
        ker_j = rdw(hq)
        s = -mq * Agp * Agq * (Pep * ker_i + Peq * ker_j)
        if background_split:
            Abgp, Abgq = p_all[b0 + 5 + d], q_all[b0 + 5 + d][None, :]
            Pbep, Pbeq = p_all[b0 + 6 + d], q_all[b0 + 6 + d][None, :]
            s = s + mq * Abgp * Abgq * (Pbep * ker_i + Pbeq * ker_j)

        dx = [p_all[1 + a] - q_all[1 + a][None, :] for a in range(d)]
        dv = [p_all[b0 + 1 + a] - q_all[b0 + 1 + a][None, :] for a in range(d)]
        dot = sum(dx[a] * dv[a] for a in range(d))
        h_ij = 0.5 * (hp + hq)
        ker = rdw(h_ij)
        c_ij = 0.5 * (cp + cq)
        rho_ij = 0.5 * (rhop + rhoq)
        mu_ij = h_ij * dot / (r2 + eps * h_ij * h_ij)
        pi_ij = (-alpha * c_ij * mu_ij + beta * mu_ij * mu_ij) / rho_ij
        visc = (dot < 0.0).astype(jnp.float32) * (-mq) * pi_ij * ker
        s = s + visc
        return [s * dx[a] for a in range(d)]

    pad_vals = ([0.0] * d + [_hfloor(engine)]
                + [0.0] * (len(hoisted)))
    return _run_pair_kernel(engine, state, fields, body, d,
                            self_pair=False, interpret=interpret,
                            pad_vals=pad_vals)


# ------------------------------------------------------------- dam break

def dambreak_mass_pass(engine, state, cfg, interpret=False):
    """WCSPH continuity with fixed h: Drho = Σ m·rDw(h,r)·(x_pq·v_pq
    + 2ν(ρp−ρq)) (collapse_dry.jl:112-115; collapse3d.jl:92-97). Works in
    2-D (9 offsets, rDwendland2) and 3-D (27 offsets, rDwendland3)."""
    f = state.fields
    d = engine.dim
    coords = [engine.resident(f["x"][:, a]) for a in range(d)]
    fields = coords + [engine.resident(a) for a in
                       [f["v"][:, a] for a in range(d)] + [f["rho"]]]
    # fixed h: fold m and the kernel normalization into one constant
    kc = cfg.m * _rdw_const(d) / cfg.h ** (d + 2)
    hinv = 1.0 / cfg.h
    nu = cfg.nu

    def body(p_all, q_all, r2, maskf):
        r = jnp.sqrt(r2)
        t = jnp.maximum(1.0 - r * hinv, 0.0) * maskf
        ker = kc * t * t * t
        dx = [p_all[1 + a] - q_all[1 + a][None, :] for a in range(d)]
        dv = [p_all[1 + d + a] - q_all[1 + d + a][None, :] for a in range(d)]
        dot = sum(dx[a] * dv[a] for a in range(d))
        drho = p_all[1 + 2 * d] - q_all[1 + 2 * d][None, :]
        return [ker * (dot + 2.0 * nu * drho)]

    (out,) = _run_pair_kernel(engine, state, fields, body, 1,
                              self_pair=False, interpret=interpret)
    return out


def dambreak_force_pass(engine, state, cfg, interpret=False):
    """WCSPH fluid-only momentum with fixed h: −m·rDw·(Pp/ρp²+Pq/ρq²)·x_pq
    + 2m·rDw·μ/ρ0²·v_pq (collapse_dry.jl:135-141; collapse3d.jl:99-116 with
    the committed undefined-rho defect replaced by the symmetric P/ρ² form).
    Returns per-axis acceleration contributions (p-side FLUID gate applied)."""
    f = state.fields
    d = engine.dim
    rho_f = jnp.maximum(f["rho"], 1e-12)
    Pterm = f["P"] / rho_f**2
    fluid = (f["type"] == 0.0).astype(jnp.float32)
    coords = [engine.resident(f["x"][:, a]) for a in range(d)]
    fields = coords + [engine.resident(a) for a in
                       [f["v"][:, a] for a in range(d)] + [Pterm, fluid]]
    kc = cfg.m * _rdw_const(d) / cfg.h ** (d + 2)
    hinv = 1.0 / cfg.h
    visc_c = 2.0 * cfg.mu / cfg.rho0**2

    def body(p_all, q_all, r2, maskf):
        r = jnp.sqrt(r2)
        t = jnp.maximum(1.0 - r * hinv, 0.0) * maskf * p_all[2 + 2 * d]
        ker = kc * t * t * t
        s = -ker * (p_all[1 + 2 * d] + q_all[1 + 2 * d][None, :])
        w = ker * visc_c
        return [s * (p_all[1 + a] - q_all[1 + a][None, :])
                + w * (p_all[1 + d + a] - q_all[1 + d + a][None, :])
                for a in range(d)]

    return _run_pair_kernel(engine, state, fields, body, d,
                            self_pair=False, interpret=interpret)


# ------------------------------------------------- legacy flow (terrain)

def legacy_mass_pass(engine, state, cfg, interpret=False):
    """Isothermal-flow continuity Σ q.m·rDw2(h0,r)·(x_pq·v_pq)
    (balance_of_mass! flow form, src/legacy/isothermal_flow_witch.jl:145-150;
    models/legacy_witch.py iso_balance_of_mass). Fixed global h0 folds the
    kernel normalization into one constant; per-particle mass is streamed
    (m = ρ_bg(y)·dr² varies with altitude)."""
    f = state.fields
    d = engine.dim
    coords = [engine.resident(f["x"][:, a]) for a in range(d)]
    fields = coords + [engine.resident(a) for a in
                       [f["v"][:, a] for a in range(d)] + [f["m"]]]
    kc = _rdw_const(d) / cfg.h0 ** (d + 2)
    hinv = 1.0 / cfg.h0

    def body(p_all, q_all, r2, maskf):
        r = jnp.sqrt(r2)
        t = jnp.maximum(1.0 - r * hinv, 0.0) * maskf
        ker = kc * t * t * t * q_all[1 + 2 * d][None, :]
        dx = [p_all[1 + a] - q_all[1 + a][None, :] for a in range(d)]
        dv = [p_all[1 + d + a] - q_all[1 + d + a][None, :] for a in range(d)]
        return [ker * sum(dx[a] * dv[a] for a in range(d))]

    (out,) = _run_pair_kernel(engine, state, fields, body, 1,
                              self_pair=False, interpret=interpret)
    return out


def legacy_force_pass(engine, state, cfg, interpret=False):
    """Legacy pressure+viscous momentum with fixed h0 (internal_force!,
    src/legacy/isothermal_flow_witch.jl:152-160): −q.m·rDw2(h0,r)·
    (Pp/ρp² + Pq/ρq²)·x_pq + 8·q.m·rDw2·μ/(ρpρq)·(v_pq·x_pq)/(r²+0.01h0²)
    ·x_pq. P/ρ² and 1/ρ are hoisted per particle; the per-pair body
    carries one divide. cfg.av_alpha adds
    the Monaghan Π term (models/legacy_witch.py internal_force) riding the
    same divide — μ_av = h0·dot·di is one extra FMA chain."""
    f = state.fields
    d = engine.dim
    rho_f = jnp.maximum(f["rho"], 1e-12)
    Pterm = f["P"] / rho_f**2
    rinv = 1.0 / rho_f
    av = getattr(cfg, "av_alpha", 0.0)
    c_av = cfg.c_av if av else 0.0
    coords = [engine.resident(f["x"][:, a]) for a in range(d)]
    scalars = [f["m"], Pterm, rinv]
    if av:  # fluid–fluid AV gate streams as one extra field (see
        # adia_entropy_force_pass: ungated AV = no-slip mountain drag)
        scalars.append((f["type"] == 0.0).astype(f["m"].dtype))
    fields = coords + [engine.resident(a) for a in
                       [f["v"][:, a] for a in range(d)] + scalars]
    kc = _rdw_const(d) / cfg.h0 ** (d + 2)
    hinv = 1.0 / cfg.h0
    eps_h2 = 0.01 * cfg.h0 * cfg.h0
    mu8 = 8.0 * cfg.mu

    def body(p_all, q_all, r2, maskf):
        r = jnp.sqrt(r2)
        t = jnp.maximum(1.0 - r * hinv, 0.0) * maskf
        ker = kc * t * t * t * q_all[1 + 2 * d][None, :]
        dx = [p_all[1 + a] - q_all[1 + a][None, :] for a in range(d)]
        dv = [p_all[1 + d + a] - q_all[1 + d + a][None, :] for a in range(d)]
        dot = sum(dx[a] * dv[a] for a in range(d))
        di = dot / (r2 + eps_h2)
        s = -ker * (p_all[2 + 2 * d] + q_all[2 + 2 * d][None, :])
        w = mu8 * ker * p_all[3 + 2 * d] * q_all[3 + 2 * d][None, :] * di
        if av:
            both = p_all[4 + 2 * d] * q_all[4 + 2 * d][None, :]
            mu_av = cfg.h0 * di
            pi = ((-av * c_av * mu_av + (2.0 * av) * mu_av * mu_av)
                  * 0.5 * (p_all[3 + 2 * d] + q_all[3 + 2 * d][None, :]))
            w = w - both * (dot < 0.0).astype(jnp.float32) * ker * pi
        return [(s + w) * dx[a] for a in range(d)]

    return _run_pair_kernel(engine, state, fields, body, d,
                            self_pair=False, interpret=interpret)


def iso_static_mass_pass(engine, state, cfg, interpret=False):
    """Adaptive-h isothermal continuity Σ (q.m/q.rho)·rDw2(p.h,r)·
    (x_pq·v_pq) (balance_of_mass! static form,
    src/legacy/isothermal_static_witch.jl:118-125). The gather kernel uses
    p's per-particle smoothing length, so 1/h streams as a p-side field and
    the kernel value is divide-free; the caller multiplies the returned sum
    by p.rho (a per-slot product, cheaper than per-pair)."""
    f = state.fields
    d = engine.dim
    hinvB = engine.resident(1.0 / jnp.maximum(f["h"], _hfloor(engine)))
    wq = f["m"] / jnp.maximum(f["rho"], 1e-12)
    coords = [engine.resident(f["x"][:, a]) for a in range(d)]
    fields = coords + [hinvB] + [engine.resident(a) for a in
                                 [f["v"][:, a] for a in range(d)] + [wq]]
    DW = _rdw_const(d)

    def body(p_all, q_all, r2, maskf):
        hinv = p_all[1 + d]
        r = jnp.sqrt(r2)
        t = jnp.maximum(1.0 - r * hinv, 0.0) * maskf
        h2 = hinv * hinv
        ker = DW * t * t * t * (h2 * h2 if d == 2 else h2 * h2 * hinv)
        ker = ker * q_all[2 + 2 * d][None, :]
        dx = [p_all[1 + a] - q_all[1 + a][None, :] for a in range(d)]
        dv = [p_all[2 + d + a] - q_all[2 + d + a][None, :] for a in range(d)]
        return [ker * sum(dx[a] * dv[a] for a in range(d))]

    (out,) = _run_pair_kernel(engine, state, fields, body, 1,
                              self_pair=False, interpret=interpret)
    return out


def iso_static_force_pass(engine, state, cfg, interpret=False):
    """Adaptive-h legacy momentum (internal_force! static form,
    src/legacy/isothermal_static_witch.jl:150-160): −q.m·rDw2(p.h,r)·
    (Pp/ρp² + Pq/ρq²)·x_pq + 8·q.m·rDw2·μ/(ρpρq)·(v_pq·x_pq)
    /(r² + 0.0025·(p.h+q.h)²)·x_pq. h streams raw (the viscous denominator
    needs hp+hq), so the pair body carries two divides (the kernel's 1/h
    and the viscous term)."""
    f = state.fields
    d = engine.dim
    rho_f = jnp.maximum(f["rho"], 1e-12)
    Pterm = f["P"] / rho_f**2
    rinv = 1.0 / rho_f
    av = getattr(cfg, "av_alpha", 0.0)
    c_av = cfg.c_av if av else 0.0
    coords, hB = _resident_xhm(engine, state, _hfloor(engine))
    scalars = [f["m"], Pterm, rinv]
    if av:  # fluid–fluid AV gate (see adia_entropy_force_pass)
        scalars.append((f["type"] == 0.0).astype(f["m"].dtype))
    fields = coords + [hB] + [engine.resident(a) for a in
                              [f["v"][:, a] for a in range(d)] + scalars]
    DW = _rdw_const(d)
    mu8 = 8.0 * cfg.mu

    def body(p_all, q_all, r2, maskf):
        hp = p_all[1 + d]
        r = jnp.sqrt(r2)
        hinv = 1.0 / hp
        t = jnp.maximum(1.0 - r * hinv, 0.0) * maskf
        h2 = hinv * hinv
        ker = DW * t * t * t * (h2 * h2 if d == 2 else h2 * h2 * hinv)
        ker = ker * q_all[2 + 2 * d][None, :]
        dx = [p_all[1 + a] - q_all[1 + a][None, :] for a in range(d)]
        dv = [p_all[2 + d + a] - q_all[2 + d + a][None, :] for a in range(d)]
        dot = sum(dx[a] * dv[a] for a in range(d))
        h_pq = hp + q_all[1 + d][None, :]
        di = dot / (r2 + 0.0025 * h_pq * h_pq)
        s = -ker * (p_all[3 + 2 * d] + q_all[3 + 2 * d][None, :])
        w = mu8 * ker * p_all[4 + 2 * d] * q_all[4 + 2 * d][None, :] * di
        if av:  # Monaghan Π, h̄ = ½(hp+hq), FLUID–FLUID only
            # (LegacyConfig.av_alpha)
            both = p_all[5 + 2 * d] * q_all[5 + 2 * d][None, :]
            mu_av = 0.5 * h_pq * di
            pi = ((-av * c_av * mu_av + (2.0 * av) * mu_av * mu_av)
                  * 0.5 * (p_all[4 + 2 * d] + q_all[4 + 2 * d][None, :]))
            w = w - both * (dot < 0.0).astype(jnp.float32) * ker * pi
        return [(s + w) * dx[a] for a in range(d)]

    pad_vals = [0.0] * d + [_hfloor(engine)] + [0.0] * (3 + d + (1 if av else 0))
    return _run_pair_kernel(engine, state, fields, body, d,
                            self_pair=False, interpret=interpret,
                            pad_vals=pad_vals)


def adia_density_pass(engine, state, cfg, interpret=False):
    """Both-FLUID-gated kernel summation Σ q.m·w(h, r) incl. the self term
    (find_density!, src/legacy/adiabatic_static_witch.jl:130-136). The
    q-side gate rides the streamed weight (m·[type==FLUID]); the caller
    applies the p-side gate (walls keep their density). The corrected
    open-boundary variant (cfg.outflow_buffer, models/legacy_witch.py
    adia_find_density) counts every neighbor's mass."""
    from types import SimpleNamespace
    f = state.fields
    if getattr(cfg, "outflow_buffer", 0.0):
        weight = f["m"]
    else:
        weight = f["m"] * (f["type"] == 0.0)  # legacy FLUID = 0.0
    return weighted_w_pass(engine, state, SimpleNamespace(self_density=True),
                           weight, ker_h="p", interpret=interpret)


def adia_entropy_force_pass(engine, state, cfg, interpret=False):
    """Fused entropy-production + pressure/viscous sweep for the adiabatic
    legacy schemes (entropy_production! + internal_force!,
    src/legacy/adiabatic_static_witch.jl:138-147,157-164). Both closures
    share the fixed-h0 rDwendland2 weight, the velocity·separation dot
    product, the hoisted 1/ρ, and the 1/(r²+0.01h0²) divide, so one sweep
    produces (ΔS, Dv_x, Dv_y): ΔS = −4·μ·dt·(m_p/T_p)·(q.m·rDw)·
    (v_pq·x_pq)²/(ρ_p ρ_q (r²+0.01h0²)) on FLUID–FLUID pairs; the force is
    the same form as legacy_force_pass (ungated, as the reference's)."""
    f = state.fields
    d = engine.dim
    rho_f = jnp.maximum(f["rho"], 1e-12)
    Pterm = f["P"] / rho_f**2
    rinv = 1.0 / rho_f
    fluid = (f["type"] == 0.0).astype(f["m"].dtype)
    mTi = f["m"] / jnp.maximum(f["T"], 1e-30)
    coords = [engine.resident(f["x"][:, a]) for a in range(d)]
    fields = coords + [engine.resident(a) for a in
                       [f["v"][:, a] for a in range(d)]
                       + [f["m"], Pterm, rinv, fluid, mTi]]
    kc = _rdw_const(d) / cfg.h0 ** (d + 2)
    hinv = 1.0 / cfg.h0
    eps_h2 = 0.01 * cfg.h0 * cfg.h0
    mu8 = 8.0 * cfg.mu
    mu4dt = 4.0 * cfg.mu * cfg.dt
    av = getattr(cfg, "av_alpha", 0.0)
    c_av = cfg.c_av if av else 0.0

    def body(p_all, q_all, r2, maskf):
        r = jnp.sqrt(r2)
        t = jnp.maximum(1.0 - r * hinv, 0.0) * maskf
        kerq = kc * t * t * t * q_all[1 + 2 * d][None, :]
        dx = [p_all[1 + a] - q_all[1 + a][None, :] for a in range(d)]
        dv = [p_all[1 + d + a] - q_all[1 + d + a][None, :] for a in range(d)]
        dot = sum(dx[a] * dv[a] for a in range(d))
        rr = p_all[3 + 2 * d] * q_all[3 + 2 * d][None, :]  # 1/(ρp·ρq)
        di = dot / (r2 + eps_h2)
        s = -kerq * (p_all[2 + 2 * d] + q_all[2 + 2 * d][None, :])
        both = p_all[4 + 2 * d] * q_all[4 + 2 * d][None, :]
        w = mu8 * kerq * rr * di
        if av:  # Monaghan Π on approaching FLUID–FLUID pairs (free-slip
            # floor — ungated AV is a no-slip mountain drag that kills the
            # wave launch; see models/legacy_witch.py internal_force)
            mu_av = cfg.h0 * di
            pi = ((-av * c_av * mu_av + (2.0 * av) * mu_av * mu_av)
                  * 0.5 * (p_all[3 + 2 * d] + q_all[3 + 2 * d][None, :]))
            w = w - both * (dot < 0.0).astype(jnp.float32) * kerq * pi
        dS = -mu4dt * p_all[5 + 2 * d] * kerq * rr * dot * di * both
        return [dS] + [(s + w) * dx[a] for a in range(d)]

    return _run_pair_kernel(engine, state, fields, body, 1 + d,
                            self_pair=False, interpret=interpret)


# ------------------------------------------------------------------ ISPH

def _rd_spline23(hinv, r, maskf):
    """Masked (dw/dr)/r of the 2-D cubic spline ((kernels.rDspline23,
    src/kernels.jl:51-60), fixed scalar h: the 1/h⁴ folds into hinv⁴).
    The outer branch's 1/x is guarded (x_safe ≥ 0.5; where() selects the
    inner polynomial below that, so the guard value is never used)."""
    C = 10.91348181201568  # 240/(7π), kernels._C_DSPLINE23
    x = r * hinv
    inner = 2.0 - 3.0 * x
    tpos = jnp.maximum(1.0 - x, 0.0)
    outer = tpos * tpos / jnp.maximum(x, 0.5)
    h4 = hinv * hinv
    return (-C * (h4 * h4)) * maskf * jnp.where(x < 0.5, inner, outer)


def isph_div_visc_pass(engine, state, cfg, interpret=False):
    """Fused divergence/L/λ + viscous sweep for the ISPH witch
    (models/isph_witch.py div_L_lambda + viscous_force closures;
    collapse_dry_implicit.jl:128-152 forms). Returns RAW spline-weighted
    pair sums (S_divv, S_L, S_lam, S_dv0, S_dv1) = Σ rDk·(x_pq·v_pq, 1,
    r², v_pq) — the caller applies the p-constant physics factors."""
    f = state.fields
    d = engine.dim
    coords = [engine.resident(f["x"][:, a]) for a in range(d)]
    fields = coords + [engine.resident(f["v"][:, a]) for a in range(d)]
    hinv = 1.0 / cfg.h0

    def body(p_all, q_all, r2, maskf):
        r = jnp.sqrt(r2)
        w = _rd_spline23(hinv, r, maskf)
        dx = [p_all[1 + a] - q_all[1 + a][None, :] for a in range(d)]
        dv = [p_all[1 + d + a] - q_all[1 + d + a][None, :] for a in range(d)]
        dot = sum(dx[a] * dv[a] for a in range(d))
        return [w * dot, w, w * r2] + [w * dv[a] for a in range(d)]

    return _run_pair_kernel(engine, state, fields, body, 3 + d,
                            self_pair=False, interpret=interpret)


def isph_matvec_prepared(engine, state, cfg, interpret=False):
    """CG-matvec off-diagonal sweep, prepared for solver loops: returns
    ``mv(v) = Σ_q rDk(h0, r)·v_q`` (the scalar 2h²·vol factor of
    isph_witch.offdiag is applied by the caller). The coordinate/occupancy
    padding and the per-row trip bounds are built ONCE here; each ``mv``
    call — one per CG iteration inside lax.while_loop — pads and streams
    only the iterate, keeping the loop-invariant work out of the loop body
    by construction. The spline weight is recomputed from streamed coords
    rather than stored (3 streamed fields ≈ 20x less HBM traffic than a
    materialized [slots, 9·cap] stencil matrix)."""
    f = state.fields
    d = engine.dim
    coords = [engine.resident(f["x"][:, a]) for a in range(d)]
    hinv = 1.0 / cfg.h0

    def body(p_all, q_all, r2, maskf):
        w = _rd_spline23(hinv, jnp.sqrt(r2), maskf)
        return [w * q_all[1 + d][None, :]]

    call = make_pair_kernel_fn(engine, state, coords, 1, body, 1,
                               self_pair=False, interpret=interpret)

    def mv(v):
        (out,) = call([engine.resident(v)])
        return out

    return mv


def isph_matvec_pass(engine, state, cfg, v, interpret=False):
    """One-shot form of ``isph_matvec_prepared`` (parity tests)."""
    return isph_matvec_prepared(engine, state, cfg, interpret=interpret)(v)


def isph_grad_pass(engine, state, cfg, interpret=False):
    """Symmetric pressure-correction gradient (isph_witch.internal_force,
    collapse_dry_implicit.jl:132-134): per-axis Σ rDk·(P_p+P_q)·x_pq raw
    sums; the caller applies −vol/ρ_bg (p-constant)."""
    f = state.fields
    d = engine.dim
    coords = [engine.resident(f["x"][:, a]) for a in range(d)]
    fields = coords + [engine.resident(f["P"])]
    hinv = 1.0 / cfg.h0

    def body(p_all, q_all, r2, maskf):
        w = _rd_spline23(hinv, jnp.sqrt(r2), maskf)
        s = w * (p_all[1 + d] + q_all[1 + d][None, :])
        return [s * (p_all[1 + a] - q_all[1 + a][None, :]) for a in range(d)]

    return _run_pair_kernel(engine, state, fields, body, d,
                            self_pair=False, interpret=interpret)


# ------------------------------------------------------ Rayleigh-Bénard

def rb_mass_heat_pass(engine, state, cfg, interpret=False):
    """Continuity + Cleary–Monaghan conduction fused into one sweep
    (models/rayleigh_benard.py balance_of_mass/heat_conduction closures;
    continuity form per collapse_dry.jl:112-115):

      Drho = Σ m·rDw(h,r)·(x_pq·v_pq)
      DT   = Σ 2·m·κ/ρ_q·rDw(h,r)·(T_p−T_q)   (κ = diffusivity)

    Fixed scalar h folds the kernel into a divide-free polynomial; 1/ρ is
    hoisted per particle (ρ floored at 1% ρ0 — inactive rows carry ρ=0).
    Zero-flux walls (cfg.sidewalls="adiabatic") are handled by folding a
    per-particle conduction weight ∈ {0,1} into the hoisted 1/ρ_q factor of
    the DT term (q-side gate, matching the heat_conduction closure).
    Returns raw pair sums in flat slot order; the caller applies the
    p-side FLUID gate on DT (a p-constant factor) and the active mask."""
    f = state.fields
    d = engine.dim
    rinv_c = 1.0 / jnp.maximum(f["rho"], 0.01 * cfg.rho0)
    if getattr(cfg, "sidewalls", "conducting") == "adiabatic":
        from ..models.rayleigh_benard import WALL_ADIA
        rinv_c = jnp.where(f["type"] == WALL_ADIA, 0.0, rinv_c)
    coords = [engine.resident(f["x"][:, a]) for a in range(d)]
    fields = coords + [engine.resident(a) for a in
                       [f["v"][:, a] for a in range(d)]
                       + [f["T"], rinv_c]]
    kc = cfg.m * _rdw_const(d) / cfg.h ** (d + 2)
    hinv = 1.0 / cfg.h
    twokap = 2.0 * cfg.kappa

    def body(p_all, q_all, r2, maskf):
        r = jnp.sqrt(r2)
        t = jnp.maximum(1.0 - r * hinv, 0.0) * maskf
        ker = kc * t * t * t
        dx = [p_all[1 + a] - q_all[1 + a][None, :] for a in range(d)]
        dv = [p_all[1 + d + a] - q_all[1 + d + a][None, :] for a in range(d)]
        dot = sum(dx[a] * dv[a] for a in range(d))
        dT = p_all[1 + 2 * d] - q_all[1 + 2 * d][None, :]
        # SPH Laplacian weight: 1/ρ_q only (conduction-gated copy)
        rr = q_all[2 + 2 * d][None, :]
        return [ker * dot, twokap * rr * ker * dT]

    return _run_pair_kernel(engine, state, fields, body, 2,
                            self_pair=False, interpret=interpret)


# --------------------------------------------------------------- pavelka

def pavelka_mass_pass(engine, state, cfg, interpret=False):
    """δ-SPH continuity sweep (balance_of_mass!, pavelka_total_witch.jl
    :195-201): Drho = Σ ρ_p·(m_q/ρ_q)·rDw(h_ij,r)·(x_pq·v_pq) + fluid-fluid
    diffusion (fixed Molteni–Colagrossi form when cfg.fixed_diffusion).
    FLUID type code is 0.0 (witch_common.py)."""
    f = state.fields
    d = engine.dim
    rho_f = jnp.maximum(f["rho"], cfg.rho_floor)
    wq = f["m"] / rho_f
    fluid = (f["type"] == 0.0).astype(jnp.float32)
    hoisted = [f["v"][:, a] for a in range(d)] + [rho_f, wq, fluid]
    coords, hB = _resident_xhm(engine, state, _hfloor(engine))
    fields = coords + [hB] + [engine.resident(a) for a in hoisted]
    DW = _rdw_const(d)
    nu = cfg.nu
    b0 = 2 + d
    fixed = cfg.fixed_diffusion

    def body(p_all, q_all, r2, maskf):
        hp = p_all[1 + d]
        hq = q_all[1 + d][None, :]
        rhop, rhoq = p_all[b0 + d], q_all[b0 + d][None, :]
        wqq = q_all[b0 + 1 + d][None, :]
        both = p_all[b0 + 2 + d] * q_all[b0 + 2 + d][None, :]

        r = jnp.sqrt(r2)
        h_ij = 0.5 * (hp + hq)
        hinv = 1.0 / h_ij
        t = jnp.maximum(1.0 - r * hinv, 0.0) * maskf
        hinv2 = hinv * hinv
        ker = wqq * DW * t * t * t * (hinv2 * hinv2 if d == 2
                                      else hinv2 * hinv2 * hinv)
        dx = [p_all[1 + a] - q_all[1 + a][None, :] for a in range(d)]
        dv = [p_all[b0 + a] - q_all[b0 + a][None, :] for a in range(d)]
        dot = sum(dx[a] * dv[a] for a in range(d))
        conv = rhop * ker * dot
        if fixed:
            diff = 2.0 * nu * (rhop - rhoq) * ker
        else:  # reference-faithful kernel-less form (:199-200), divergent
            diff = 2.0 * nu / rhop * (rhop - rhoq) * maskf
        return [conv + both * diff]

    pad_vals = [0.0] * d + [_hfloor(engine)] + [0.0] * len(hoisted)
    (out,) = _run_pair_kernel(engine, state, fields, body, 1,
                              self_pair=False, interpret=interpret,
                              pad_vals=pad_vals)
    return out


def pavelka_momentum_entropy_pass(engine, state, cfg, interpret=False):
    """Fused momentum + viscous entropy-production sweep
    (balance_of_momentum! :132-137 and entropy production :168-175 of
    pavelka_total_witch.jl): both sweeps share ker=(m_q/ρ_q)·rDw and
    x_pq·v_pq, so one Pallas pass returns (Dv_axes..., dS). dt is baked into
    dS per the reference."""
    f = state.fields
    d = engine.dim
    rho_f = jnp.maximum(f["rho"], cfg.rho_floor)
    wq = f["m"] / rho_f
    Pterm = f["P"] / rho_f**2
    T_f = jnp.maximum(f["T"], 1e-12)
    fluid = (f["type"] == 0.0).astype(jnp.float32)
    hoisted = ([f["m"]] + [f["v"][:, a] for a in range(d)]
               + [rho_f, wq, Pterm, T_f, fluid])
    coords, hB = _resident_xhm(engine, state, _hfloor(engine))
    fields = coords + [hB] + [engine.resident(a) for a in hoisted]
    DW = _rdw_const(d)
    mu, dt = cfg.mu, cfg.dt
    b0 = 2 + d

    def body(p_all, q_all, r2, maskf):
        hp = p_all[1 + d]
        hq = q_all[1 + d][None, :]
        mp, mq = p_all[b0], q_all[b0][None, :]
        rhop, rhoq = p_all[b0 + 1 + d], q_all[b0 + 1 + d][None, :]
        wqq = q_all[b0 + 2 + d][None, :]
        Ptp, Ptq = p_all[b0 + 3 + d], q_all[b0 + 3 + d][None, :]
        Tp = p_all[b0 + 4 + d]
        both = p_all[b0 + 5 + d] * q_all[b0 + 5 + d][None, :]

        r = jnp.sqrt(r2)
        h_ij = 0.5 * (hp + hq)
        hinv = 1.0 / h_ij
        t = jnp.maximum(1.0 - r * hinv, 0.0) * maskf
        hinv2 = hinv * hinv
        ker = wqq * DW * t * t * t * (hinv2 * hinv2 if d == 2
                                      else hinv2 * hinv2 * hinv)
        dx = [p_all[1 + a] - q_all[1 + a][None, :] for a in range(d)]
        dv = [p_all[b0 + 1 + a] - q_all[b0 + 1 + a][None, :] for a in range(d)]
        dot = sum(dx[a] * dv[a] for a in range(d))

        du = -rhop * ker * (Ptp + Ptq)
        visc = ((rhop * 8.0 * ker * mu / (rhop * rhoq) * dot)
                / (r2 + 0.0025 * (hp + hq) ** 2))
        s = du + visc
        dS = ((-4.0 * mp * mq * ker * mu / (Tp * rhoq) * dot * dot)
              / (r2 + 0.01 * hp * hq) * dt) * both
        return [s * dx[a] for a in range(d)] + [dS]

    # rho pads with its floor: it sits in the rhop·rhoq and Tp·rhoq
    # denominators, and 0·ker/0 = 0/0 = NaN even under the mask
    pad_vals = ([0.0] * d + [_hfloor(engine)]              # coords, h
                + [0.0] * (1 + d)                          # m, v
                + [cfg.rho_floor] + [0.0] * 4)             # rho, wq, Pt, T, fl
    return _run_pair_kernel(engine, state, fields, body, d + 1,
                            self_pair=False, interpret=interpret,
                            pad_vals=pad_vals)
