"""Compile-and-load runtime for the C++ backend.

The native leg of the differential-test harness: where the reference compiles
its generated kernel with a SLURM batch script against a Peano checkout
(``Unit test/correctness_test.sbatch:20-24``), this module compiles the
generated source with the local toolchain into a shared object and loads
``time_step`` through ctypes, so native-vs-JAX parity runs inside pytest.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import tempfile
from typing import Optional, Sequence

import numpy as np

from exahype_jax.frontend.kernel_builder import KernelBuilder
from exahype_jax.utils.errors import LoweringError

NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"


def _ctype_of(type_name: str):
    t = type_name.strip()
    if t.endswith("*"):
        base = _ctype_of(t[:-1])
        return ctypes.POINTER(base)
    if t == "double":
        return ctypes.c_double
    if t in ("int", "const int"):
        return ctypes.c_int
    raise LoweringError(f"unsupported C type {type_name!r}")


class NativeKernel:
    """A compiled, loadable generated kernel."""

    def __init__(self, kernel: KernelBuilder, lib_path: pathlib.Path, function_name: str):
        self._kernel = kernel
        self._lib = ctypes.CDLL(str(lib_path))
        self._fn = getattr(self._lib, function_name)
        self._fn.restype = None
        self._fn.argtypes = [_ctype_of(t) for t in kernel.input_types]

    def __call__(self, Q: np.ndarray, *scalars) -> np.ndarray:
        """Run the kernel; returns the updated copy of ``Q``."""
        out = np.array(Q, dtype=np.float64, copy=True, order="C")
        args = [out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))]
        for t, val in zip(self._kernel.input_types[1:], scalars):
            args.append(_ctype_of(t)(val))
        self._fn(*args)
        return out


def compile_kernel(
    kernel: KernelBuilder,
    code: str,
    function_name: str = "time_step",
    extra_sources: Sequence[pathlib.Path] = (),
    defines: Optional[dict] = None,
    workdir: Optional[pathlib.Path] = None,
    extra_flags: Sequence[str] = (),
) -> NativeKernel:
    """g++-compile generated code (+ physics sources) into a loadable kernel."""
    tmp = pathlib.Path(workdir) if workdir else pathlib.Path(tempfile.mkdtemp(prefix="exahype_jax_"))
    tmp.mkdir(parents=True, exist_ok=True)
    src = tmp / "generated_kernel.cpp"
    src.write_text(code)
    lib = tmp / "kernel.so"
    # -ffp-contract=off: no FMA contraction, so native results are bitwise
    # reproducible against the oracle/JAX (1-ulp FMA drift otherwise).
    cmd = [
        "g++", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
        f"-I{NATIVE_DIR}", "-o", str(lib), str(src),
    ]
    cmd += list(extra_flags)
    cmd += [str(s) for s in extra_sources]
    for key, val in (defines or {}).items():
        cmd.append(f"-D{key}={val}")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise LoweringError(
            f"native compilation failed:\n{proc.stderr}\n--- source ---\n{code}"
        )
    return NativeKernel(kernel, lib, function_name)


def euler_sources() -> list[pathlib.Path]:
    return [NATIVE_DIR / "euler.cpp"]


GRID_RUNTIME_SOURCE = NATIVE_DIR / "grid_runtime.cpp"


class NativeGridDriver:
    """Standalone native solver runtime: the generated kernel linked with
    ``native/grid_runtime.cpp`` (periodic patch-grid halo exchange +
    chunked time loop, OpenMP over patches).

    The reference delegates this runtime layer to the Peano/ExaHyPE2 C++
    framework (SURVEY.md §0; the includes at
    ``exahype/printers/CPPPrinter.py:321-354`` are its only trace); here it
    is built in.  One FFI call runs a whole chunk of steps —
    ``run(Q, dt, n_steps)`` mirrors ``GridSolver.run`` (fixed dt), with the
    same ``kernel_dt`` λ-conversion.

    Differential guarantee (tested): the native halo exchange is
    element-identical to ``PatchGrid.halo_fill``, and a chunked native run
    is bitwise-equal to stepping the same compiled kernel from Python with
    the JAX-side exchange.
    """

    def __init__(
        self,
        grid,
        kernel: KernelBuilder,
        code: Optional[str] = None,
        dx: float = 1.0,
        kernel_dt: str = "physical",
        extra_sources: Sequence[pathlib.Path] = (),
        defines: Optional[dict] = None,
        workdir: Optional[pathlib.Path] = None,
        reflect_signs: Optional[np.ndarray] = None,
    ):
        from exahype_jax.backends.cpp_backend import CPPPrinter
        from exahype_jax.utils.errors import SemanticError

        cfg = grid.config
        kcfg = kernel.config
        mismatched = {
            field: (getattr(kcfg, field), getattr(cfg, field))
            for field in ("dim", "patch_size", "halo_size", "n_real", "n_aux",
                          "n_patches")
            if getattr(kcfg, field) != getattr(cfg, field)
        }
        if mismatched:
            # Native code has no shape checks: an oversized kernel would
            # write past the grid's state buffer (heap corruption) instead
            # of failing like the JAX path.  Fail in Python first.
            raise SemanticError(
                f"kernel config does not match grid config: {mismatched} "
                f"(kernel value, grid value) — the compiled time_step would "
                f"index out of the grid's state buffer"
            )
        boundary = getattr(grid, "boundary", "periodic")
        if boundary not in ("periodic", "reflective"):
            raise SemanticError(
                f"NativeGridDriver supports periodic/reflective grids, "
                f"got {boundary!r}"
            )
        self._reflective = boundary == "reflective"
        if self._reflective and reflect_signs is None:
            raise SemanticError(
                "reflective NativeGridDriver needs reflect_signs [dim, n_vars] "
                "(per-axis/per-variable mirror multipliers; the Euler wall "
                "hook is -1 on the normal momentum slot, +1 elsewhere)"
            )
        self._signs = (
            np.ascontiguousarray(reflect_signs, dtype=np.float64)
            if self._reflective
            else np.zeros((cfg.dim, cfg.n_vars))
        )
        if self._reflective and self._signs.shape != (cfg.dim, cfg.n_vars):
            raise SemanticError(
                f"reflect_signs shape {self._signs.shape} != "
                f"({cfg.dim}, {cfg.n_vars})"
            )
        if code is None:
            code = CPPPrinter(kernel, header="euler.h").code
        self.grid = grid
        self.kernel = kernel
        self.dx = dx
        self.kernel_dt = kernel_dt
        self._native = compile_kernel(
            kernel,
            code,
            extra_sources=[GRID_RUNTIME_SOURCE, *extra_sources],
            defines=defines,
            workdir=workdir,
            extra_flags=["-fopenmp"],
        )
        lib = self._native._lib
        c_dp = ctypes.POINTER(ctypes.c_double)
        c_ip = ctypes.POINTER(ctypes.c_int)
        self._run = lib.exa_run_grid_bc
        self._run.restype = None
        self._run.argtypes = [
            c_dp, ctypes.c_double, ctypes.c_int, c_ip,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, c_dp,
        ]
        self._fill = lib.exa_halo_fill_bc
        self._fill.restype = None
        self._fill.argtypes = [c_dp, c_ip, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int, c_dp]
        self._g = np.asarray(grid.grid_shape, dtype=np.int32)

    def _args(self, out):
        cfg = self.grid.config
        return (
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            self._g.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            ctypes.c_int(cfg.dim),
            ctypes.c_int(cfg.patch_size),
            ctypes.c_int(cfg.halo_size),
            ctypes.c_int(cfg.n_vars),
            ctypes.c_int(1 if self._reflective else 0),
            self._signs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )

    def halo_fill(self, Q: np.ndarray) -> np.ndarray:
        """Native halo exchange (periodic or wall-mirrored) on grid-shaped
        AoS state."""
        out = np.array(Q, dtype=np.float64, copy=True, order="C")
        ptr, g, dim, P, h, V, refl, signs = self._args(out)
        self._fill(ptr, g, dim, P, h, V, refl, signs)
        return out

    def run(self, Q: np.ndarray, dt: float, n_steps: int) -> np.ndarray:
        """``n_steps`` × (halo exchange + kernel), one native call."""
        kdt = dt / self.dx if self.kernel_dt == "lambda" else dt
        out = np.array(Q, dtype=np.float64, copy=True, order="C")
        ptr, g, dim, P, h, V, refl, signs = self._args(out)
        self._run(ptr, ctypes.c_double(kdt), ctypes.c_int(n_steps),
                  g, dim, P, h, V, refl, signs)
        return out
