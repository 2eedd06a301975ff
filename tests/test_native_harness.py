"""Standalone native correctness harness (L0 parity).

Builds the reference-style differential binary — generated kernel +
hand-written reference kernel + physics + harness main — runs it, and
expects the reference's success banner.
"""

import pathlib
import subprocess

from exahype_jax.backends.cpp_backend import CPPPrinter
from exahype_jax.backends.cpp_runtime import NATIVE_DIR
from exahype_jax.models.rusanov import build_rusanov_kernel


def test_native_correctness_binary(tmp_path):
    kb = build_rusanov_kernel(dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=5)
    generated = tmp_path / "generated_kernel.cpp"
    generated.write_text(CPPPrinter(kb, policy="golden", header="euler.h").code)

    binary = tmp_path / "correctness_test"
    cmd = [
        "g++", "-O2", "-ffp-contract=off", f"-I{NATIVE_DIR}",
        str(NATIVE_DIR / "correctness_main.cpp"),
        str(NATIVE_DIR / "reference_kernel.cpp"),
        str(NATIVE_DIR / "euler.cpp"),
        str(generated),
        "-o", str(binary),
    ]
    build = subprocess.run(cmd, capture_output=True, text=True)
    assert build.returncode == 0, build.stderr

    run = subprocess.run([str(binary)], capture_output=True, text=True)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "no differences! :)" in run.stdout
