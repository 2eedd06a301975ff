"""Structural Kernel-IR construction (path B of the reference).

Counterpart of ``examples/exahype_test.py``: builds two stencils via the
builder API and writes the textual IR (``demo.eir``, the analogue of
``examples/demo.mlir``).  Unlike the reference, the result can be parsed
back and lowered: try

    exahype-opt demo.eir -p exahype-to-standard,for-to-parallel
"""

import copy

from exahype_jax.ir import (
    DType,
    FluxBuilder,
    IRBuilder,
    PatchBuilder,
    StencilBuilder,
)

exahype = IRBuilder("demo.eir")
kernel1 = exahype.addKernel()

patch1 = PatchBuilder.build("Qcopy", [4, 4], type=DType.f64)
patch2 = copy.deepcopy(patch1)

flux_x = FluxBuilder.build("flux_x", "Flux_x", [4, 4], halo=[1, 0, 0])
flux_y = FluxBuilder.build("flux_y", "Flux_y", [4, 4], type=DType.f64, halo=[0, 1, 0])

tmp_x_eigen = FluxBuilder.build("tmp_x_eigen", "X_max_eigenvalues", [4, 4], halo=[1, 0, 0])
tmp_y_eigen = FluxBuilder.build("tmp_y_eigen", "Y_max_eigenvalues", [4, 4], halo=[0, 1, 0])

stencil1 = StencilBuilder.build(
    patch1, [flux_x, flux_y], ["0[010],0[0-10]", "1[001],1[00-1]"], [[1, -1], [1, -1]]
)
stencil2 = StencilBuilder.build(
    patch2,
    [tmp_x_eigen, tmp_y_eigen],
    ["0[010],0[0-10]", "1[001],1[00-1]"],
    [[0.5, 0.5], [0.5, 0.5]],
)

kernel1.addStencil(stencil1)
kernel1.addStencil(stencil2)

exahype.writeOutput()
print("wrote demo.eir")
