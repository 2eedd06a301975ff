#!/usr/bin/env bash
# Native correctness pipeline — the reference's SLURM batch flow
# (`Unit test/correctness_test.sbatch:1-28`) without the cluster dependency:
# regenerate the kernel from the DSL, compile the differential harness with
# the local toolchain, run it, and report.
set -euo pipefail

workdir="$(mktemp -d)"
repo="$(cd "$(dirname "$0")/.." && pwd)"
native="$repo/exahype_jax/native"

echo "== regenerating kernel from the DSL =="
python - <<PY
from exahype_jax.backends.cpp_backend import CPPPrinter
from exahype_jax.models.rusanov import build_rusanov_kernel
kernel = build_rusanov_kernel(dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=5)
CPPPrinter(kernel, policy="golden", header="euler.h").file("$workdir/generated_kernel.cpp")
print("wrote $workdir/generated_kernel.cpp")
PY

echo "== compiling the differential harness =="
g++ -O2 -ffp-contract=off -I"$native" \
    "$native/correctness_main.cpp" \
    "$native/reference_kernel.cpp" \
    "$native/euler.cpp" \
    "$workdir/generated_kernel.cpp" \
    -o "$workdir/correctness_test"

echo "== running =="
"$workdir/correctness_test"
