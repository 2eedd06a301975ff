"""IR layer tests: builders, verifier, print/parse round-trips, passes, CLI.

The builder flow mirrors the reference's path-B example
(``examples/exahype_test.py:9-31`` producing ``examples/demo.mlir``).
"""

import copy

import pytest
import sympy

from exahype_jax.ir import (
    DType,
    FluxBuilder,
    IRBuilder,
    Kernel,
    PatchBuilder,
    StencilBuilder,
    for_to_parallel,
    kernel_to_loops,
    parse_function,
    parse_kernel,
    print_function,
    print_kernel,
    spec_to_loops,
)
from exahype_jax.ir.loop_ir import Loop
from exahype_jax.models.rusanov import build_rusanov_kernel
from exahype_jax.tools.exahype_opt import run as opt_run
from exahype_jax.utils.errors import VerifyError


def demo_kernel() -> Kernel:
    """The reference demo kernel (``examples/exahype_test.py``) via builders."""
    patch1 = PatchBuilder.build("Qcopy", [4, 4], type=DType.f64)
    patch2 = copy.deepcopy(patch1)

    flux_x = FluxBuilder.build("flux_x", "Flux_x", [4, 4], halo=[1, 0, 0])
    flux_y = FluxBuilder.build("flux_y", "Flux_y", [4, 4], halo=[0, 1, 0])
    eig_x = FluxBuilder.build("tmp_x_eigen", "X_max_eigenvalues", [4, 4], halo=[1, 0, 0])
    eig_y = FluxBuilder.build("tmp_y_eigen", "Y_max_eigenvalues", [4, 4], halo=[0, 1, 0])

    st1 = StencilBuilder.build(
        patch1, [flux_x, flux_y], ["0[010],0[0-10]", "1[001],1[00-1]"],
        [[1, -1], [1, -1]],
    )
    st2 = StencilBuilder.build(
        patch2, [eig_x, eig_y], ["0[010],0[0-10]", "1[001],1[00-1]"],
        [[0.5, 0.5], [0.5, 0.5]],
    )
    kernel = Kernel()
    kernel.addStencil(st1)
    kernel.addStencil(st2)
    return kernel


def test_builder_arity_check():
    patch = PatchBuilder.build("Q", [4, 4])
    flux = FluxBuilder.build("f", "F", [4, 4], halo=[1, 0, 0])
    with pytest.raises(VerifyError):
        StencilBuilder.build(patch, [flux], ["0[00]", "0[01]"], [[1], [1]])


def test_builder_does_not_mutate_flux_list():
    patch = PatchBuilder.build("Q", [4, 4])
    fluxes = [FluxBuilder.build("f", "F", [4, 4], halo=[1, 0, 0])]
    StencilBuilder.build(patch, fluxes, ["0[10],0[-10]"], [[1, -1]])
    assert len(fluxes) == 1  # reference inserts the patch into the caller's list


def test_kernel_ir_roundtrip(tmp_path):
    kernel = demo_kernel()
    text = print_kernel(kernel)
    assert "exahype.kernel" in text and 'func = "Flux_x"' in text
    parsed = parse_kernel(text)
    assert print_kernel(parsed) == text  # stable round-trip
    # IRBuilder writes the same text.
    out = tmp_path / "demo.eir"
    b = IRBuilder(str(out))
    k = b.addKernel()
    for st in kernel.stencils:
        k.addStencil(st)
    b.writeOutput()
    assert out.read_text() == text


def test_malformed_stencil_pattern_rejected():
    patch = PatchBuilder.build("Q", [4, 4])
    flux = FluxBuilder.build("f", "F", [4, 4], halo=[1, 0, 0])
    with pytest.raises(VerifyError):
        StencilBuilder.build(patch, [flux], ["nonsense"], [[1]])


def test_stencil_offsets_parse():
    kernel = demo_kernel()
    st = kernel.stencils[0]
    assert st.offsets(0) == [(0, [0, 1, 0]), (0, [0, -1, 0])]
    assert st.offsets(1) == [(1, [0, 0, 1]), (1, [0, 0, -1])]


def test_spec_to_loops_matches_backend_structure():
    kb = build_rusanov_kernel()
    fn = spec_to_loops(kb)
    text = print_function(fn)
    assert "loop.func @time_step(Q: memref<f64>, dt: f64)" in text
    assert "loop.alloc Q_copy : [1, 6, 6, 10]" in text
    assert "loop.for patch = 0 to 1 {" in text
    assert "loop.for i = 1 to 5 {" in text  # golden trimmed sweep
    assert "normal = 0.0" in text
    # Round-trip.
    parsed = parse_function(text)
    assert print_function(parsed) == text


def test_for_to_parallel():
    kb = build_rusanov_kernel()
    fn = for_to_parallel(spec_to_loops(kb))
    text = print_function(fn)
    assert "loop.parallel patch = 0 to 1 {" in text
    assert "loop.parallel i" not in text


def test_kernel_to_loops_lowering():
    fn = kernel_to_loops(demo_kernel())
    text = print_function(fn)
    assert "loop.alloc flux_x : [4, 4]" in text
    assert "Flux_x(Qcopy[i, j])" in text
    # Stencil accumulation with shifted reads (pattern offsets are 3-wide in
    # the reference example; the trailing axes map to i/j).
    assert "flux_x[" in text
    parsed = parse_function(text)
    assert print_function(parsed) == text


def test_opt_cli_kernel_roundtrip(tmp_path, capsys):
    path = tmp_path / "demo.eir"
    path.write_text(print_kernel(demo_kernel()))
    assert opt_run([str(path)]) == 0
    out = capsys.readouterr().out
    assert "exahype.kernel" in out


def test_opt_cli_pipeline(tmp_path, capsys):
    path = tmp_path / "demo.eir"
    path.write_text(print_kernel(demo_kernel()))
    out_file = tmp_path / "out.lir"
    assert opt_run([str(path), "-p", "exahype-to-standard,for-to-parallel", "-o", str(out_file)]) == 0
    text = out_file.read_text()
    assert "loop.func" in text


def test_opt_cli_bad_pass(tmp_path, capsys):
    path = tmp_path / "demo.eir"
    path.write_text(print_kernel(demo_kernel()))
    assert opt_run([str(path), "-p", "no-such-pass"]) == 1
    assert "error" in capsys.readouterr().err


def test_opt_cli_module_files(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "demo.eir"
    path.write_text(print_kernel(demo_kernel()))
    assert opt_run([str(path), "-p", "exahype-to-standard", "--output-module-files"]) == 0
    assert (tmp_path / "generated" / "kernel.lir").exists()


def test_kernel_ir_executes_through_loop_interpreter():
    """Path B end-to-end: structural Kernel IR -> Loop IR -> execution."""
    import numpy as np

    from exahype_jax.ir.interp import run_loop_function

    patch = PatchBuilder.build("Q", [6, 6])
    flux = FluxBuilder.build("flx", "Double", [6, 6], halo=[1, 0])
    stencil = StencilBuilder.build(patch, [flux], ["0[10],0[-10]"], [[0.5, 0.5]])
    kernel = Kernel()
    kernel.addStencil(stencil)
    fn = kernel_to_loops(kernel)

    rng = np.random.default_rng(0)
    Q0 = rng.normal(size=(6, 6))
    env = run_loop_function(fn, {"Q": Q0}, fns={"Double": lambda x: 2.0 * x})

    # flx = 2*Q on the halo-trimmed region [1,5) x [0,6).
    np.testing.assert_allclose(env["flx"][1:5, :], 2.0 * Q0[1:5, :])
    assert (env["flx"][0, :] == 0).all()  # untouched alloc rows stay zero
    # Patch accumulation: Q += 0.5*flx[i+1,j] + 0.5*flx[i-1,j] on [1,5)x[0,6).
    expected = Q0.copy()
    flx = env["flx"]
    for i in range(1, 5):
        for j in range(0, 6):
            expected[i, j] += 0.5 * flx[i + 1, j] + 0.5 * flx[i - 1, j]
    np.testing.assert_allclose(env["Q"], expected)


def test_spec_to_loops_interpreter_matches_oracle():
    """Loop IR execution of a full spec == the NumPy oracle (for a spec
    without pointer-ABI calls)."""
    import numpy as np

    from exahype_jax import KernelBuilder
    from exahype_jax.backends.numpy_oracle import run_oracle
    from exahype_jax.ir.interp import run_loop_function

    kb = KernelBuilder(dim=2, patch_size=4, halo_size=1, n_real=2, n_aux=0)
    Q = kb.item("Q")
    C = kb.item("C")
    dt = kb.const("dt")
    kb.single(C[0], Q[0])
    kb.directional(C[0], C[0] + dt * (Q[-1] - Q[1]))
    kb.single(Q[0], C[0])

    rng = np.random.default_rng(5)
    Q0 = rng.normal(size=kb.item_shape("Q"))
    want = run_oracle(kb, Q0, 0.01)

    fn = spec_to_loops(kb)
    env = run_loop_function(fn, {"Q": Q0}, scalars={"dt": 0.01})
    np.testing.assert_array_equal(env["Q"], want)


def test_opt_cli_spec_emit(tmp_path, capsys):
    import pathlib

    spec = pathlib.Path(__file__).resolve().parent.parent / "examples" / "spec_rusanov.py"
    for emit, marker in [
        ("cpp", 'extern "C" void time_step'),
        ("mlir", "builtin.module"),
        ("lir", "loop.func @time_step"),
    ]:
        assert opt_run([str(spec), "--spec", "--emit", emit]) == 0
        out = capsys.readouterr().out
        assert marker in out, emit


def test_mlir_generic_export(tmp_path):
    """Path-B interop: Kernel IR renders in MLIR generic-op syntax (any MLIR
    toolchain parses it with --allow-unregistered-dialect), covering the
    reference's registered-dialect interop (dialects/exahype.py:585-604)."""
    from exahype_jax.ir.kernel_ir import print_kernel, print_mlir_generic
    from exahype_jax.tools.exahype_opt import run

    k = demo_kernel()
    text = print_mlir_generic(k)
    assert text.startswith('"exahype.kernel"() ({')
    assert text.count("(") == text.count(")")
    assert text.count("{") == text.count("}")
    assert '"exahype.stencil"() ({' in text
    assert '"exahype.call_expr"()' in text
    assert 'func = "Flux_x"' in text
    assert text.rstrip().endswith(": () -> ()")

    eir = tmp_path / "k.eir"
    eir.write_text(print_kernel(k))
    out = tmp_path / "k.generic.mlir"
    rc = run([str(eir), "--mlir-generic", "-o", str(out)])
    assert rc == 0
    assert out.read_text() == text
