"""Kernel parity: every Pallas pair sweep against the plain XLA sweep.

``reference_pair_fn`` is a drop-in for ``pallas_pairs.make_pair_kernel_fn``
that evaluates the same pair body the way ``apply_binary`` does on the
bucket layout: dense ``[cap_p, cap_q, C]`` blocks per stencil offset, with
zero-padded stencil shifts (``engine.pad_resident``) and a ``where`` mask.
It shares nothing with the kernel but the pair body, so a difference is the
kernel's (loads, trip bounds, masking, padding, tiling) or the summation
order; the passes hold no matrix product, so TF32 is not involved.

``check_kernel_parity`` runs each pass both ways on the same state of the
configuration that uses it and checks:

* density-like sums (positive terms): ``rtol=1e-5`` element-wise over
  active rows;
* force-like sums (terms that cancel): ``max|kernel − ref| ≤ 1e-5 ·
  max|ref|`` over active rows.

Both sides are f32. ``chip_smoke.py`` calls it on the card at the widths of
the configurations in ``FULL_CASES``; ``SMALL_CASES`` covers the remaining
passes at the sizes of their tests.
"""
from __future__ import annotations

import contextlib
import time

import jax
import jax.numpy as jnp

from . import pallas_pairs as pp

__all__ = ["reference_pair_fn", "reference_sweeps", "check_kernel_parity",
           "FULL_CASES", "SMALL_CASES"]

RTOL = 1e-5


def reference_pair_fn(engine, state, static_fields, n_dyn, pair_body,
                      n_out, self_pair, interpret=False, pad_vals=None,
                      tx=None):
    """Plain XLA sweep with the signature of ``make_pair_kernel_fn``.
    p fields are ``[cap, 1, C]`` and q fields ``[cap, C]`` (the body's
    ``q[None, :]`` makes them ``[1, cap, C]``); masked pairs are removed
    with ``where``, so a NaN on a masked pair cannot leak. The stencil
    offsets run in a ``fori_loop`` over zero-padded grids, so the body is
    traced once (a 27-offset unroll takes minutes to compile in 3-D)."""
    del interpret, pad_vals, tx
    C = engine.num_cells
    cap = engine.cap
    dim = engine.dim
    h2 = engine.h * engine.h
    grid = tuple(reversed(engine.lims))           # [(nz,) ny, nx]
    offs = jnp.asarray([tuple(reversed(o)) for o in engine.stencil],
                       jnp.int32)                 # grid-axis order
    occ = engine.resident(state.active).astype(jnp.float32)
    eye = (jnp.arange(cap)[:, None] == jnp.arange(cap)[None, :])[:, :, None]

    def call(dyn_fields):
        fields = [occ] + list(static_fields) + list(dyn_fields)
        p_all = [f[:, None, :C] for f in fields]
        padded = [engine.pad_resident(f) for f in fields]

        def offset(k, acc):
            o = offs[k]
            start = (jnp.int32(0),) + tuple(1 + o[a] for a in range(dim))
            q_all = [jax.lax.dynamic_slice(P, start, (cap,) + grid)
                     .reshape(cap, C) for P in padded]
            r2 = sum((p_all[a] - q_all[a][None, :]) ** 2
                     for a in range(1, 1 + dim))
            mask = (p_all[0] > 0.5) & (q_all[0][None, :] > 0.5) & (r2 <= h2)
            if not self_pair:
                mask = mask & ~(eye & jnp.all(o == 0))
            contribs = pair_body(p_all, q_all, r2, mask.astype(jnp.float32))
            return tuple(a + jnp.sum(jnp.where(mask, c, 0.0), axis=1)
                         for a, c in zip(acc, contribs))

        zeros = (jnp.zeros((cap, C), jnp.float32),) * n_out
        acc = jax.lax.fori_loop(0, len(engine.stencil), offset, zeros)
        return [jnp.pad(a, ((0, 0), (0, 1))).reshape(cap * (C + 1))
                for a in acc]

    return call


@contextlib.contextmanager
def reference_sweeps():
    """Route every pass of ``pallas_pairs`` through ``reference_pair_fn``
    while the context is open."""
    orig = pp.make_pair_kernel_fn
    pp.make_pair_kernel_fn = reference_pair_fn
    try:
        yield
    finally:
        pp.make_pair_kernel_fn = orig


def _small_witch(m):
    return m.WitchConfig(n_rows=10, dtype="float32", self_density=True,
                         layout="bucket", skin=0.2)


def _legacy_small(factory):
    return lambda m: getattr(m, factory)(
        n_rows=14, dom_length=40e3, h_m=2000.0, a=6e3, dtype="float32",
        layout="bucket", av_alpha=0.05)


def _hopkins_momentum(split):
    return lambda e, s, c, **k: pp.hopkins_momentum_pass(
        e, s, c, background_split=split, **k)


def _matvec(e, s, c, **k):
    return pp.isph_matvec_pass(e, s, c, s.fields["P"], **k)


# name -> (model module, config(module), [(pass name, pass, kind)]);
# kind "sum" = density-like, "force" = cancelling sums
FULL_CASES = {
    "witch2d": ("wcsph_perturbed_witch", lambda m: m.flagship_config(), [
        ("density_pass", pp.density_pass, "sum"),
        ("momentum_pass", pp.momentum_pass, "force")]),
    "witch3d": ("witch3d", lambda m: m.stretch_config(bucket_cap=8), [
        ("density_pass", pp.density_pass, "sum"),
        ("momentum_pass", pp.momentum_pass, "force")]),
    "terrain": ("legacy_witch",
                lambda m: m.terrain_baseline_config(layout="bucket"), [
        ("legacy_mass_pass", pp.legacy_mass_pass, "force"),
        ("legacy_force_pass", pp.legacy_force_pass, "force")]),
    "isph": ("isph_witch", lambda m: m.baseline_config(), [
        ("isph_div_visc_pass", pp.isph_div_visc_pass, "force"),
        ("isph_matvec_pass", _matvec, "force"),
        ("isph_grad_pass", pp.isph_grad_pass, "force")]),
    "rb": ("rayleigh_benard", lambda m: m.baseline_config(), [
        ("rb_mass_heat_pass", pp.rb_mass_heat_pass, "force")]),
    "dam": ("collapse_dry", lambda m: m.Config(
        dr=0.014, dtype="float32", layout="bucket", skin=0.2), [
        ("dambreak_mass_pass", pp.dambreak_mass_pass, "force"),
        ("dambreak_force_pass", pp.dambreak_force_pass, "force")]),
}

SMALL_CASES = {
    "hopkins_total": ("hopkins_total_witch", _small_witch, [
        ("pressure_pass", pp.pressure_pass, "sum"),
        ("hopkins_momentum_pass", _hopkins_momentum(False), "force")]),
    "full_hopkins": ("full_hopkins_perturbed_witch", _small_witch, [
        ("hopkins_momentum_pass_split", _hopkins_momentum(True), "force")]),
    "pavelka": ("pavelka_total_witch", lambda m: m.PavelkaConfig(
        n_rows=10, dtype="float32", self_density=True, layout="bucket",
        skin=0.2), [
        ("pavelka_mass_pass", pp.pavelka_mass_pass, "force"),
        ("pavelka_momentum_entropy_pass", pp.pavelka_momentum_entropy_pass,
         "force")]),
    "iso_static": ("legacy_witch", _legacy_small("isothermal_static_config"), [
        ("iso_static_mass_pass", pp.iso_static_mass_pass, "force"),
        ("iso_static_force_pass", pp.iso_static_force_pass, "force")]),
    "adiabatic": ("legacy_witch", _legacy_small("adiabatic_static_config"), [
        ("adia_density_pass", pp.adia_density_pass, "sum"),
        ("adia_entropy_force_pass", pp.adia_entropy_force_pass, "force")]),
}


def kicked_state(module, cfg, seed: int = 0):
    """Build the configuration's system, place it in bucket slots, and
    perturb every floating field but positions, masses and types (1%
    multiplicative noise; fields that are zero on every active row, such
    as a static velocity, get additive noise of 0.01 instead) so that no
    pass sums an exactly static field. Active rows only; signs are kept.
    Returns (engine, state)."""
    sys_ = module.make_system(cfg)
    state = sys_.freeze()       # rows already sit in their bucket slots
    engine = sys_.engine

    @jax.jit
    def kick(state):
        key = jax.random.PRNGKey(seed)
        act = state.active
        upd = {}
        for i, (name, arr) in enumerate(sorted(state.fields.items())):
            if (name in ("x", "m", "type") or name.startswith("_")
                    or not jnp.issubdtype(arr.dtype, jnp.floating)):
                continue
            k1, k2 = jax.random.split(jax.random.fold_in(key, i))
            m = act if arr.ndim == 1 else act[:, None]
            zero = ~jnp.any(jnp.where(m, arr, 0.0) != 0.0)
            n1 = jax.random.normal(k1, arr.shape, arr.dtype)
            n2 = jax.random.normal(k2, arr.shape, arr.dtype)
            new = arr * (1 + 0.01 * n1) + jnp.where(zero, 0.01 * n2, 0.0)
            upd[name] = jnp.where(m, new, arr)
        return state.replace(**upd)

    return engine, jax.block_until_ready(kick(state))


def _compare(kind, got, ref, act):
    """Return (error, limit) for one output over active rows: the largest
    element-wise relative error for "sum" outputs (0 where both sides are
    0), the largest absolute error against RTOL·max|ref| for "force"."""
    got, ref = got[act], ref[act]
    diff = jnp.abs(got - ref)
    if kind == "sum":
        rel = jnp.where(ref != 0, diff / jnp.abs(ref),
                        jnp.where(diff == 0, 0.0, jnp.inf))
        return float(jnp.max(rel)), RTOL
    return float(jnp.max(diff)), RTOL * float(jnp.max(jnp.abs(ref)))


def check_kernel_parity(cases=None, interpret: bool = False, log=print):
    """Run every pass of ``cases`` (default: FULL_CASES then SMALL_CASES)
    through the kernel and the reference on one kicked state per case.
    Logs one line per pass and output; raises AssertionError listing every
    failure. Returns the list of records."""
    import importlib
    if cases is None:
        cases = {**FULL_CASES, **SMALL_CASES}
    records, failures = [], []
    for name, (mod_name, make_cfg, passes) in cases.items():
        module = importlib.import_module(
            f"sph_mountain_waves_tpu.models.{mod_name}")
        cfg = make_cfg(module)
        t0 = time.perf_counter()
        engine, state = kicked_state(module, cfg)
        act = state.active
        n = int(jnp.sum(act))
        log(f"parity {name}: N={n} cap={engine.cap} grid={engine.lims} "
            f"(set-up {time.perf_counter() - t0:.1f} s)")
        for pname, fn, kind in passes:
            # one side at a time, each synchronized: a device fault is
            # then reported at the call that caused it
            t0 = time.perf_counter()
            outs = jax.block_until_ready(jax.jit(
                lambda s: fn(engine, s, cfg, interpret=interpret))(state))
            t1 = time.perf_counter()
            with reference_sweeps():
                refs = jax.block_until_ready(
                    jax.jit(lambda s: fn(engine, s, cfg))(state))
            log(f"  {pname}: kernel {t1 - t0:.1f} s, reference "
                f"{time.perf_counter() - t1:.1f} s (compile included)")
            outs = outs if isinstance(outs, (list, tuple)) else [outs]
            refs = refs if isinstance(refs, (list, tuple)) else [refs]
            for i, (o, r) in enumerate(zip(outs, refs)):
                finite = bool(jnp.all(jnp.isfinite(o[act])))
                err, lim = _compare(kind, o, r, act)
                ok = finite and err <= lim
                rec = dict(case=name, n=n, pass_=pname, out=i, kind=kind,
                           err=err, limit=lim, ok=ok)
                records.append(rec)
                crit = "max rel" if kind == "sum" else "max abs"
                log(f"  {pname}[{i}] {crit} err {err:.3e} "
                    f"(limit {lim:.3e}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(rec)
    if failures:
        raise AssertionError(f"kernel parity failed: {failures}")
    return records
