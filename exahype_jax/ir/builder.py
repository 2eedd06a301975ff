"""IR builders — parity with ``exahype/util/builder.py:8-77``.

Same four entry points (``PatchBuilder``, ``FluxBuilder``, ``StencilBuilder``,
``IRBuilder``) and arity checks; dtypes are proper enums instead of
zero-valued attr sentinels, and ``StencilBuilder`` no longer mutates its
caller's flux list in place (a reference hazard, ``util/builder.py:55``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from exahype_jax.ir.kernel_ir import (
    CallExpr,
    DType,
    Flux,
    Kernel,
    Patch,
    Stencil,
    print_kernel,
)
from exahype_jax.utils.errors import VerifyError


def _as_dtype(type_) -> DType:
    if isinstance(type_, DType):
        return type_
    name = getattr(type_, "__name__", str(type_)).lower()
    mapping = {
        "int32": DType.i32,
        "int64": DType.i64,
        "float32": DType.f32,
        "float64": DType.f64,
        "i32": DType.i32,
        "i64": DType.i64,
        "f32": DType.f32,
        "f64": DType.f64,
    }
    if name not in mapping:
        raise VerifyError(f"Type {type_} not supported")
    return mapping[name]


class PatchBuilder:
    @staticmethod
    def build(name: str, dims: Sequence[int], type=DType.f64) -> Patch:
        patch = Patch(name=name, shape=list(dims), dtype=_as_dtype(type))
        patch.verify()
        return patch


class FluxBuilder:
    @staticmethod
    def build(
        name: str,
        function_name: str,
        dims: Sequence[int],
        type=DType.f64,
        halo: Optional[Sequence[int]] = None,
    ) -> Flux:
        if not function_name:
            raise VerifyError("The Flux function name cannot be empty")
        flux = Flux(
            name=name,
            shape=list(dims),
            call=CallExpr(func=function_name),
            halo=list(halo) if halo is not None else [0] * len(dims),
            dtype=_as_dtype(type),
        )
        flux.verify()
        return flux


class StencilBuilder:
    @staticmethod
    def build(
        patch: Patch,
        fluxes: List[Flux],
        stencils: List[str],
        scales: List,
    ) -> Stencil:
        if len(stencils) != len(fluxes) or (scales and len(scales) != len(fluxes)):
            raise VerifyError(
                f"The number of stencils ({len(stencils)}), number of scales "
                f"({len(scales)}) must match the number of fluxes ({len(fluxes)})"
            )
        stencil = Stencil(
            patch=patch, fluxes=list(fluxes), stencil=list(stencils), scales=list(scales)
        )
        stencil.verify()
        return stencil


class IRBuilder:
    """Collects kernels and writes their textual form
    (``util/builder.py:60-77``)."""

    def __init__(self, filename: str):
        self._filename = filename
        self._kernels: list[Kernel] = []

    def addKernel(self) -> Kernel:
        kernel = Kernel()
        self._kernels.append(kernel)
        return kernel

    @property
    def kernels(self) -> list[Kernel]:
        return self._kernels

    def writeOutput(self) -> None:
        with open(self._filename, "w") as fh:
            for kernel in self._kernels:
                fh.write(print_kernel(kernel))
