"""Per-config machine-readable bench record for every BASELINE.json config.

Runs the configs one after another on the GPU, each in its own child
process (the parent never imports JAX, so only one process holds the card
at a time), and writes ``<checkout>/results/bench_all.json``: a list of
records with the same methodology as bench.py (f32, bucket layout + Pallas
pair-sweep kernel, lattice-aligned cells, N-step timed scans ended by
``block_until_ready``, best of 3, compile excluded) and the card's name
and power limit.

Usage: python scripts/bench_all.py
"""
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "results", "bench_all.json")
LOG = os.path.join(REPO, "results", "bench_all.log")

HEAD = r'''
import math, time, sys, json
from functools import partial
import jax, jax.numpy as jnp
assert jax.devices()[0].platform == "gpu", jax.devices()
from sph_mountain_waves_tpu.utils.cache import enable_persistent_cache
enable_persistent_cache()
def timed_scans(run, state, n, steps, reps=3):
    t0 = time.perf_counter()
    state = jax.block_until_ready(run(state))
    compile_s = time.perf_counter() - t0
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        state = jax.block_until_ready(run(state))
        best = min(best, (time.perf_counter() - t0) / steps)
    print("JSONRESULT " + json.dumps({
        "n": int(n), "ms_per_step": best * 1e3,
        "particle_steps_per_s": n / best, "compile_s": compile_s,
        "steps_per_scan": steps, "repeats": reps,
        "device_kind": jax.devices()[0].device_kind}), flush=True)
'''

JOBS = [
    ("witch2d_1m", 1800, HEAD + r'''
from sph_mountain_waves_tpu.models import wcsph_perturbed_witch as w
from sph_mountain_waves_tpu.models.common import frame_runner
cfg = w.flagship_config(use_pallas=True)
sys_ = w.make_system(cfg)
state = sys_.freeze()
run = frame_runner(w.make_step(cfg, sys_.engine), 100,
                   finalize=w.make_finalize(cfg))
timed_scans(run, state, sys_.n_built, 100)
'''),
    ("witch3d_stretch", 3600, HEAD + r'''
from sph_mountain_waves_tpu.models import witch3d as w3
from sph_mountain_waves_tpu.models.common import frame_runner
cfg = w3.stretch_config(bucket_cap=8)
sys_ = w3.make_system(cfg)
state = sys_.freeze()
state = w3.setup(cfg, sys_.engine, state)
run = frame_runner(w3.make_step(cfg, sys_.engine), 20,
                   finalize=w3.make_finalize(cfg))
timed_scans(run, state, sys_.n_built, 20)
'''),
    ("terrain_flow", 2400, HEAD + r'''
from sph_mountain_waves_tpu.models import legacy_witch as lw
cfg = lw.terrain_baseline_config(use_pallas=True)
sys_ = lw.make_system(cfg)
# production spawn path (lw.run parity): slot-targeted spawns under the
# stencil rescatter — no variadic-sort events or their compile cost
sys_.freeze_opts["capacity"] = int(sys_.n_built * 1.3)
if sys_.freeze_opts.get("layout") == "bucket":
    sys_.freeze_opts["rescatter_mode"] = "stencil"
state = sys_.freeze()
step = lw.make_step(cfg, sys_.engine)
@partial(jax.jit, donate_argnums=0)
def run(s):
    s, _ = jax.lax.scan(lambda s, _: (step(s), None), s, None, length=50)
    return s
timed_scans(run, state, sys_.n_built, 50)
'''),
    ("isph_witch", 2400, HEAD + r'''
from sph_mountain_waves_tpu.models import isph_witch as iw
cfg = iw.baseline_config()   # production: precond='mg', cg_tol=1e-4
sys_ = iw.make_system(cfg)
state = sys_.freeze()
step = iw.make_step(cfg, sys_.engine)
@partial(jax.jit, donate_argnums=0)
def run(s):
    s, _ = jax.lax.scan(lambda s, _: (step(s), None), s, None, length=20)
    return s
timed_scans(run, state, sys_.n_built, 20)
'''),
    ("rayleigh_benard", 1800, HEAD + r'''
from sph_mountain_waves_tpu.models import rayleigh_benard as rb
cfg = rb.baseline_config()
sys_ = rb.make_system(cfg)
state = sys_.freeze()
step = rb.make_step(cfg, sys_.engine)
@partial(jax.jit, donate_argnums=0)
def run(s):
    s, _ = jax.lax.scan(lambda s, _: (step(s), None), s, None, length=100)
    return s
timed_scans(run, state, sys_.n_built, 100)
'''),
    ("dam_break", 1800, HEAD + r'''
from sph_mountain_waves_tpu.models import collapse_dry as cd
cfg = cd.Config(dr=0.014, dtype="float32", layout="bucket", skin=0.15,
                use_pallas=True)
sys_ = cd.make_system(cfg)
state = sys_.freeze()
step, init_forces = cd.make_step(cfg, sys_.engine)
state = jax.jit(init_forces, donate_argnums=0)(state)
# 100-step scans from the fresh state: later in the run the developed
# sloshing phase triggers drift rescatters every few steps, a different
# (slower) regime
@partial(jax.jit, donate_argnums=0)
def run(s):
    s, _ = jax.lax.scan(lambda s, _: (step(s), None), s, None, length=100)
    return s
timed_scans(run, state, sys_.n_built, 100)
''')]


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main():
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    card = card_line()
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    results = []
    for name, timeout_s, code in JOBS:
        with open(LOG, "a") as f:
            f.write(f"--- {name} start {time.strftime('%H:%M:%S')}\n")
        rec = {"config": name, "ok": False}
        try:
            r = subprocess.run([sys.executable, "-c", code],
                               capture_output=True, text=True, env=env,
                               timeout=timeout_s, check=False)
            tail = "\n".join((r.stdout + r.stderr).splitlines()[-6:])
            with open(LOG, "a") as f:
                f.write(f"{name} rc={r.returncode}\n{tail}\n")
            for line in r.stdout.splitlines():
                if line.startswith("JSONRESULT "):
                    rec.update(json.loads(line[len("JSONRESULT "):]))
                    rec["ok"] = True
        except subprocess.TimeoutExpired:
            with open(LOG, "a") as f:
                f.write(f"{name} TIMEOUT {timeout_s}s\n")
            rec["error"] = f"timeout {timeout_s}s"
        results.append(rec)
        # persist incrementally so a crashed batch still leaves a record
        payload = {
            "methodology": (
                "one GPU; f32; bucket layout + Pallas pair-sweep kernel; "
                "lattice-aligned cells; lazy diagnostics; timed lax.scan "
                "chunks (steps_per_scan) ended by block_until_ready; best "
                "of `repeats`; compile excluded"),
            "card": card,
            "date": time.strftime("%Y-%m-%d"),
            "results": results}
        with open(OUT, "w") as f:
            json.dump(payload, f, indent=1)
    print(json.dumps(payload["results"], indent=1))


if __name__ == "__main__":
    main()
