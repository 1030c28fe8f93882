#!/bin/bash
# GPU production job: stratified mountain-wave flagship run.
# Counterpart of the reference's SLURM script (reference jobs/example.sh:
# 1 node, 16 Julia threads, 3h wall): one GPU, jit-compiled bucket-layout
# engine with the Pallas pair-sweep kernel, PVD frames to results/.
set -euo pipefail
cd "$(dirname "$0")/.."

echo "=== JOB START $(date) on $(hostname) ==="
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python - <<'PY'
from sph_mountain_waves_tpu.models import wcsph_perturbed_witch as w

# flagship layout: skin 0.15 keeps bucket cap 8, lattice-aligned cells keep
# occupancy uniform, diagnostics lazy per frame
cfg = w.flagship_config(n_rows=75, use_pallas=True, t_end=20.0)
out = w.run(cfg, out_path="results/wcsph_perturbed_witch", verbose=True)
print("final u_avg:", out["u_avg"][-1], "u_max:", out["u_max"][-1])
# multi-GPU variant (4 cards of one host over NVLink), same artifact set:
#   from sph_mountain_waves_tpu.parallel.run import run_sharded_witch_bucket
#   out = run_sharded_witch_bucket(cfg, n_dev=4,
#                                  out_path="results/witch_4gpu")
PY
echo "=== JOB END $(date) ==="
