"""Benchmark: particle-steps/sec on the 2-D mountain-wave flagship.

Runs the flagship WCSPH mountain-wave scheme (float32, ~1M particles by
default) on the GPU in this one process, times steady-state jitted frames
(compile excluded; each frame is one ``lax.scan`` of ``--steps`` steps
ended by ``block_until_ready``), and prints ONE JSON line naming the card:

  {"metric": "...", "value": N, "unit": "particle-steps/s",
   "device_kind": "...", "card": "<name>, <power limit>"}

Fails (non-zero exit) when JAX finds no GPU.

Usage: python bench.py [--particles 1000000] [--steps 200] [--repeats 3]
                       [--pallas | --no-pallas]
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=float, default=1e6)
    ap.add_argument("--steps", type=int, default=200,
                    help="steps per timed frame (one lax.scan)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--skin", type=float, default=0.15)
    ap.add_argument("--pallas", action=argparse.BooleanOptionalAction,
                    default=True, help="Pallas pair-sweep kernel (else the "
                                       "XLA bucket path)")
    ap.add_argument("--self-density", action=argparse.BooleanOptionalAction,
                    default=True, dest="self_density")
    return ap.parse_args(argv)


def card_line() -> str:
    """The card's name and power limit from nvidia-smi (a child process
    that does not touch the card through JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    args = parse_args()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: JAX runs on {dev.platform!r}, not a GPU",
              file=sys.stderr)
        return 2

    from sph_mountain_waves_tpu.models import wcsph_perturbed_witch as w
    from sph_mountain_waves_tpu.models.common import frame_runner
    from sph_mountain_waves_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()

    # pick n_rows so built particle count ≈ target (N ≈ n_rows^2 * L/H / hex_a)
    n_rows = max(8, int(round(math.sqrt(
        args.particles / (400e3 / 26e3) / 1.0746))))
    cfg = w.flagship_config(n_rows=n_rows, skin=args.skin,
                            self_density=args.self_density,
                            use_pallas=args.pallas)
    sys_ = w.make_system(cfg)
    state = sys_.freeze()
    run_frame = frame_runner(w.make_step(cfg, sys_.engine), args.steps,
                             finalize=w.make_finalize(cfg))
    state = jax.block_until_ready(run_frame(state))  # compile + one frame
    n = sys_.n_built

    best = 0.0
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        state = jax.block_until_ready(run_frame(state))
        best = max(best, n * args.steps / (time.perf_counter() - t0))
    path = "pallas" if args.pallas else "xla"
    print(json.dumps({
        "metric": f"particle-steps/sec (2D mountain-wave WCSPH, N={n}, "
                  f"{path} path)",
        "value": best,
        "unit": "particle-steps/s",
        "device_kind": dev.device_kind,
        "card": card_line(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
