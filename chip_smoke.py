"""Smoke test of the mountain-wave system on one GPU (the quickest proof
that the system starts and is right on the card).

    python chip_smoke.py                 # phases 1-5 on one card
    python chip_smoke.py --multichip 4   # only the 4-card sharded phase

Phases (any failure exits non-zero; nothing is caught and skipped):

1. device: JAX must run on a GPU; prints the card's name and power limit.
2. compile: the flagship step (2-D WCSPH mountain wave, ~978k particles,
   Pallas pair-sweep kernel) as a 100-step frame; prints memory_analysis().
3. parity: every Pallas pair sweep against the plain XLA sweep at the
   widths of the configurations that use it (ops/kernel_parity.py).
4. main path: ``w.run`` for 3 frames of 100 steps with PVD output; finite
   diagnostics, no particle lost, output readable; final u_max of the
   kernel path against the XLA path.
5. timing (information, not the benchmark): ms/step of kernel and XLA
   paths, alternating, and the density/momentum passes alone.

The last line of standard output is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

STEPS = 100      # steps per frame
FRAMES = 3
# Final-u_max agreement of kernel and XLA paths after 300 steps. Both are
# f32; the passes differ only in summation order (~1e-7 relative per pass,
# checked in phase 3), and the static atmosphere amplifies such differences
# little over 300 steps: 1e-3 leaves room for that growth while still
# catching a wrong term (which moves u_max by O(1)).
RUN_RTOL = 1e-3
# The 4-card run against the single-card run: the slab decomposition sums
# the same pairs in the same order, but ghost refreshes and the sharded
# diagnostics reduce in another order; same growth argument.
MULTI_RTOL = 1e-3


def card_line() -> str:
    """nvidia-smi's name and power limit of every card, from a child that
    does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def log(*a):
    print(*a, flush=True)


def _copy(state):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.copy, state)


def _timed(fn, state):
    """Seconds for fn(copy of state), ended by block_until_ready."""
    import jax
    s = _copy(state)
    jax.block_until_ready(s)
    t0 = time.perf_counter()
    out = fn(s)
    jax.block_until_ready(out)
    return time.perf_counter() - t0


def phase_compile(w, frame_runner):
    cfg = w.flagship_config(use_pallas=True)
    sys_ = w.make_system(cfg)
    state = sys_.freeze()
    t0 = time.perf_counter()
    run_frame = frame_runner(w.make_step(cfg, sys_.engine), STEPS,
                             finalize=w.make_finalize(cfg))
    compiled = run_frame.lower(state).compile()
    log(f"[compile] flagship N={sys_.n_built} grid={sys_.engine.lims} "
        f"cap={sys_.engine.cap}: {time.perf_counter() - t0:.1f} s")
    log(f"[compile] memory_analysis: {compiled.memory_analysis()}")
    return sys_, state, compiled


def phase_main(w, out_dir):
    import numpy as np

    from sph_mountain_waves_tpu.io import read_vtp
    res = {}
    for up in (True, False):
        cfg = w.flagship_config(use_pallas=up, n_frames=FRAMES,
                                t_end=FRAMES * STEPS * w.flagship_config().dt)
        t0 = time.perf_counter()
        out = w.run(cfg, out_path=out_dir if up else None)
        n0, n = out["system"].n_built, int(out["state"].n)
        ua, um = out["u_avg"], out["u_max"]
        tag = "kernel" if up else "xla"
        log(f"[main] {tag}: {len(ua)} frames in "
            f"{time.perf_counter() - t0:.1f} s, N {n0} -> {n}, "
            f"u_avg {ua.tolist()}, u_max {um.tolist()}")
        assert len(ua) == FRAMES and np.isfinite(ua).all() \
            and np.isfinite(um).all(), (ua, um)
        assert n == n0, f"{tag}: particles lost {n0} -> {n}"
        res[up] = float(um[-1])
    for name in ("result.pvd", "data.csv", f"frame{FRAMES}.vtp"):
        assert os.path.exists(os.path.join(out_dir, name)), name
    pts, fields = read_vtp(os.path.join(out_dir, f"frame{FRAMES}.vtp"))
    assert len(pts) == n0 and np.isfinite(np.asarray(fields["v"])).all()
    rel = abs(res[True] - res[False]) / abs(res[False])
    log(f"[main] final u_max kernel {res[True]:.9e} xla {res[False]:.9e} "
        f"rel diff {rel:.3e} (limit {RUN_RTOL:g})")
    assert rel <= RUN_RTOL, rel


def phase_timing(w, frame_runner, sys_, state, compiled_kernel, card):
    import jax

    from sph_mountain_waves_tpu.ops import pallas_pairs as pp
    from sph_mountain_waves_tpu.ops.apply import apply_binary, apply_unary
    cfg_x = w.flagship_config(use_pallas=False)
    run_x = frame_runner(w.make_step(cfg_x, sys_.engine), STEPS,
                         finalize=w.make_finalize(cfg_x)).lower(
                             state).compile()
    runs = {"kernel": compiled_kernel, "xla": run_x}
    # warm both, then a frame of real state to time the passes on
    for f in runs.values():
        _timed(f, state)
    warm = runs["xla"](_copy(state))
    n = sys_.n_built
    times = {"kernel": [], "xla": []}
    for tag in ("kernel", "xla", "xla", "kernel"):
        times[tag].append(_timed(runs[tag], state))
    for tag, ts in times.items():
        ms = 1e3 * min(ts) / STEPS
        log(f"[timing] {card} | flagship {tag}: {ms:.4f} ms/step "
            f"({[round(1e3 * t / STEPS, 4) for t in ts]}), "
            f"{n / (ms / 1e3):.4e} particle-steps/s")

    eng = sys_.engine
    cfg = w.flagship_config(use_pallas=True)
    warm, nbrs = jax.jit(eng.rebuild)(warm)
    reset = lambda u: {"rho": 0.0 * u.rho}  # noqa: E731
    passes = {
        "density_pass": jax.jit(lambda s: pp.density_pass(eng, s, cfg)),
        "density apply_binary": jax.jit(lambda s: apply_binary(
            eng, apply_unary(s, reset), nbrs, w.compute_density,
            self_interaction=True).fields["rho"]),
        "momentum_pass": jax.jit(lambda s: pp.momentum_pass(eng, s, cfg)),
        "momentum apply_binary": jax.jit(lambda s: apply_binary(
            eng, s, nbrs, w.momentum_action(cfg)).fields["Dv"]),
    }
    for fn in passes.values():
        jax.block_until_ready(fn(warm))
    reps = 20
    order = ["density_pass", "density apply_binary", "density apply_binary",
             "density_pass", "momentum_pass", "momentum apply_binary",
             "momentum apply_binary", "momentum_pass"]
    best = {}
    for name in order:
        t0 = time.perf_counter()
        for _ in range(reps):
            out = passes[name](warm)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        best[name] = min(best.get(name, dt), dt)
    for name, dt in best.items():
        log(f"[timing] {card} | {name}: {1e3 * dt:.4f} ms per call "
            f"(mean of {reps} calls, best of 2 turns)")


def phase_multichip(w, n_dev, out_dir):
    import jax
    import numpy as np

    from sph_mountain_waves_tpu.parallel.run import run_sharded_witch_bucket
    devs = jax.devices()
    assert len(devs) >= n_dev, f"need {n_dev} devices, have {len(devs)}"
    cfg = w.flagship_config(use_pallas=True, n_frames=FRAMES,
                            t_end=FRAMES * STEPS * w.flagship_config().dt)
    t0 = time.perf_counter()
    out = run_sharded_witch_bucket(cfg, n_dev=n_dev, n_frames=FRAMES,
                                   steps_per_frame=STEPS, out_path=out_dir)
    log(f"[multichip] {n_dev} cards: {FRAMES} frames in "
        f"{time.perf_counter() - t0:.1f} s, n {out['n'].tolist()}, "
        f"u_avg {out['u_avg'].tolist()}, u_max {out['u_max'].tolist()}")
    mesh = out["mesh"]
    assert mesh.devices.ndim == 1 and mesh.devices.size == n_dev
    # every device holds its own slab: each leaf is split into n_dev equal
    # shards, one per device
    for leaf in jax.tree.leaves(out["state"]):
        shards = leaf.addressable_shards
        assert len({s.device for s in shards}) == n_dev, leaf.shape
        assert len({s.data.shape for s in shards}) == 1, leaf.shape
    # ...and nothing piles up on device 0: bytes of every live array, per
    # device (allocator totals also count the runtime's own buffers; they
    # are printed for information)
    live = [0] * n_dev
    for a in jax.live_arrays():
        if a.is_deleted():          # donated frame inputs
            continue
        for s in a.addressable_shards:
            if s.device in devs[:n_dev]:
                live[devs.index(s.device)] += s.data.nbytes
    log(f"[multichip] live array bytes per device {live}")
    stats = [d.memory_stats() for d in devs[:n_dev]]
    if all(stats):    # the CPU backend of a rehearsal keeps none
        log(f"[multichip] bytes_in_use per device "
            f"{[st['bytes_in_use'] for st in stats]}, peak "
            f"{[st['peak_bytes_in_use'] for st in stats]}")
    assert max(live) <= 1.1 * min(live), f"uneven device arrays {live}"

    ref = w.run(cfg)
    n_ref = ref["system"].n_built
    log(f"[multichip] 1 card: u_avg {ref['u_avg'].tolist()}, "
        f"u_max {ref['u_max'].tolist()}, n {n_ref}")
    assert (out["n"] == n_ref).all(), (out["n"], n_ref)
    for key in ("u_avg", "u_max"):
        np.testing.assert_allclose(out[key], ref[key], rtol=MULTI_RTOL)
    rel = np.abs(out["u_max"] / ref["u_max"] - 1).max()
    log(f"[multichip] max rel diff of u_max vs 1 card: {rel:.3e} "
        f"(limit {MULTI_RTOL:g})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", type=int, default=0, metavar="N",
                    help="run only the N-card sharded phase")
    args = ap.parse_args()

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX runs on {dev.platform!r}, not a GPU",
              file=sys.stderr)
        return 2

    from sph_mountain_waves_tpu.models import wcsph_perturbed_witch as w
    from sph_mountain_waves_tpu.models.common import frame_runner
    from sph_mountain_waves_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    card = card_line()
    log(f"card: {card}")
    log(f"jax {jax.__version__}, {len(jax.devices())} x {dev.device_kind}")
    t_all = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")   # PVD output
    try:
        run_phases(args, w, frame_runner, card, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


def run_phases(args, w, frame_runner, card, out_dir):
    if args.multichip:
        phase_multichip(w, args.multichip,
                        os.path.join(out_dir, f"multichip{args.multichip}"))
    else:
        from sph_mountain_waves_tpu.ops.kernel_parity import (
            check_kernel_parity)
        sys_, state, compiled = phase_compile(w, frame_runner)
        t0 = time.perf_counter()
        check_kernel_parity(log=lambda *a: log("[parity]", *a))
        log(f"[parity] all passes within tolerance "
            f"({time.perf_counter() - t0:.1f} s)")
        phase_main(w, os.path.join(out_dir, "flagship"))
        phase_timing(w, frame_runner, sys_, state, compiled, card)


if __name__ == "__main__":
    sys.exit(main())
