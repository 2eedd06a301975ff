"""exahype-opt — the IR driver CLI.

Working rebuild of the reference's broken driver
(``exahype/tools/exahype-opt:17-114``, whose two registered passes are
dangling imports and which references an undefined ``PsyOptMain``): parse a
textual IR file, verify it, optionally lower and run passes, print the
result or split modules into per-function files.

Usage:
    exahype-opt kernel.eir                          # parse + verify + print
    exahype-opt kernel.eir -p exahype-to-standard   # lower to Loop IR
    exahype-opt fn.lir -p for-to-parallel           # run Loop IR passes
    exahype-opt kernel.eir -p exahype-to-standard,for-to-parallel -o out.lir
    exahype-opt kernel.eir --output-module-files    # write generated/<name>

File kinds are inferred from content: ``exahype.kernel`` → Kernel IR,
``loop.func`` → Loop IR.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

from exahype_jax.ir import kernel_ir, loop_ir
from exahype_jax.ir.passes import LOOP_PASSES, kernel_to_loops
from exahype_jax.utils.errors import SemanticError, VerifyError

#: Pass aliases: the reference registered 'exahype-to-standard'
#: (``tools/exahype-opt:19-22``); our lowering keeps that name.
KERNEL_PASSES = {"exahype-to-standard": kernel_to_loops}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="exahype-opt", description="exahype_jax IR optimizer driver"
    )
    p.add_argument(
        "input",
        help="input IR file (.eir kernel IR / .lir loop IR), or a Python "
        "spec module when --spec is given",
    )
    p.add_argument(
        "-p",
        "--passes",
        default="",
        help="comma-separated pass pipeline "
        f"(kernel: {', '.join(KERNEL_PASSES)}; loop: {', '.join(LOOP_PASSES)})",
    )
    p.add_argument(
        "--spec",
        action="store_true",
        help="treat INPUT as a Python module defining build() -> KernelBuilder "
        "and generate code from the spec",
    )
    p.add_argument(
        "--emit",
        choices=("cpp", "mlir", "lir", "jaxpr"),
        default="lir",
        help="with --spec: which backend artifact to emit (default Loop IR)",
    )
    p.add_argument(
        "--mlir-generic",
        action="store_true",
        help="print Kernel IR in MLIR generic-op syntax (consumable by any "
        "MLIR toolchain via --allow-unregistered-dialect)",
    )
    p.add_argument("-o", "--output", default=None, help="output file (default stdout)")
    p.add_argument(
        "--output-module-files",
        action="store_true",
        help="write each function/kernel to generated/<name> instead of stdout",
    )
    return p


def _emit_from_spec(args) -> tuple[str, str]:
    """Load a Python spec module and emit the chosen backend artifact."""
    import runpy

    ns = runpy.run_path(args.input)
    build = ns.get("build") or ns.get("kernel")
    if build is None:
        raise SemanticError(
            f"{args.input}: spec module must define build() -> KernelBuilder"
        )
    kb = build() if callable(build) else build
    if args.emit == "cpp":
        from exahype_jax.backends.cpp_backend import CPPPrinter

        return CPPPrinter(kb).code, "kernel.cpp"
    if args.emit == "mlir":
        from exahype_jax.backends.mlir_backend import MLIRPrinter
        from exahype_jax.ir.mlir_text import parse_and_verify

        # ``-p for-to-parallel`` with the MLIR artifact emits the patch loop
        # as ``scf.parallel`` (the reference's dangling pass intent,
        # ``exahype/tools/exahype-opt:19-22``, completed end to end).
        passes = [p for p in args.passes.split(",") if p]
        unknown = [p for p in passes if p != "for-to-parallel"]
        if unknown:
            raise SemanticError(
                f"pass(es) {unknown} do not apply to --emit mlir"
            )
        code = MLIRPrinter(
            kb, parallel_patch_loop="for-to-parallel" in passes
        ).code
        parse_and_verify(code)  # machine-check the artifact before shipping
        return code, "kernel.mlir"
    if args.emit == "jaxpr":
        from exahype_jax.backends.jax_backend import JAXPrinter

        return JAXPrinter(kb).jaxpr_text, "kernel.jaxpr"
    from exahype_jax.ir.loop_ir import print_function
    from exahype_jax.ir.passes import spec_to_loops

    return print_function(spec_to_loops(kb)), "kernel.lir"


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.spec:
        try:
            out_text, out_name = _emit_from_spec(args)
        except (SemanticError, VerifyError) as err:
            print(f"exahype-opt: error: {err}", file=sys.stderr)
            return 1
        if args.output:
            pathlib.Path(args.output).write_text(out_text)
        else:
            sys.stdout.write(out_text)
        return 0

    text = pathlib.Path(args.input).read_text()

    try:
        module: object
        if "exahype.kernel" in text:
            module = kernel_ir.parse_kernel(text)
        elif "loop.func" in text:
            module = loop_ir.parse_function(text)
        else:
            raise SemanticError(
                f"{args.input}: neither Kernel IR (exahype.kernel) nor "
                "Loop IR (loop.func)"
            )

        for name in [p for p in args.passes.split(",") if p]:
            if isinstance(module, kernel_ir.Kernel) and name in KERNEL_PASSES:
                module = KERNEL_PASSES[name](module)
            elif isinstance(module, loop_ir.LoopFunction) and name in LOOP_PASSES:
                module = LOOP_PASSES[name](module)
            else:
                raise SemanticError(
                    f"pass {name!r} does not apply to {type(module).__name__}"
                )

        if isinstance(module, kernel_ir.Kernel):
            if args.mlir_generic:
                out_text = kernel_ir.print_mlir_generic(module)
                out_name = "kernel.generic.mlir"
            else:
                out_text = kernel_ir.print_kernel(module)
                out_name = "kernel.eir"
        else:
            out_text = loop_ir.print_function(module)
            out_name = f"{module.name}.lir"
    except (SemanticError, VerifyError) as err:
        print(f"exahype-opt: error: {err}", file=sys.stderr)
        return 1

    if args.output_module_files:
        outdir = pathlib.Path("generated")
        outdir.mkdir(exist_ok=True)
        (outdir / out_name).write_text(out_text)
        print(f"wrote generated/{out_name}")
    elif args.output:
        pathlib.Path(args.output).write_text(out_text)
    else:
        sys.stdout.write(out_text)
    return 0


def main() -> None:
    raise SystemExit(run())


if __name__ == "__main__":
    main()
