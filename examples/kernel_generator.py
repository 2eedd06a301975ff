"""ExaHyPE2-integrated kernel generation.

Counterpart of ``examples/kernel-generator.py``: the same Rusanov update but
typed against the ExaHyPE2 runtime — the patch data arrives as a
``::exahype2::CellData&`` whose members (``QIn``/``QOut``, ``dt``, ``t``,
cell geometry) are parent-qualified, physics functions live on a solver
instance, and the emitted file carries the Peano include block.
"""

from sympy.codegen.ast import integer, none, real

from exahype_jax import KernelBuilder
from exahype_jax.backends.cpp_backend import CPPPrinter

kernel = KernelBuilder(dim=2, patch_size=4, halo_size=1, n_real=4, n_aux=0)

Data = kernel.item("patchData", in_type="::exahype2::CellData&")
timer = kernel.const("timingComputeKernel", in_type="::tarch::timing::Measurement&")

Q = kernel.item("QOut", parent=Data)
Q_copy = kernel.item("QIn", parent=Data)
tmp_flux = kernel.directional_item("tmp_flx")
tmp_eig = kernel.directional_item("tmp_eigen", struct=False)

dt = kernel.const("dt", parent=Data)
t = kernel.const("t", parent=Data)
normal = kernel.directional_const("normal", (0, 1))
cellCentre = kernel.const("cellCentre", parent=Data)
cellSize = kernel.const("cellSize", parent=Data)

solver = "benchmarks::exahype2::kernelbenchmarks::repositories::instanceOfFVRusanovSolver"
Flux = kernel.function("flux", parent=solver)
Eigen = kernel.function("maxEigenvalue", parent=solver)
Max = kernel.function("max")
Centre = kernel.function("getVolumeCentre", parent="exahype2::fv::")
Size = kernel.function("getVolumeSize", parent="exahype2::fv::")

patch_size = kernel.all_items["patch_size"]
i = kernel.all_items["i"]
j = kernel.all_items["j"]

kernel.single(Q_copy[0], Q[0])
kernel.directional(
    Flux(
        Q_copy[0],
        Centre(cellCentre, cellSize, patch_size, {i, j}),
        Size(cellSize, patch_size),
        t,
        dt,
        normal,
        tmp_flux[0],
    )
)
kernel.directional(
    tmp_eig[0],
    Eigen(
        Q_copy[0],
        Centre(cellCentre, cellSize, patch_size, {i, j}),
        Size(cellSize, patch_size),
        t,
        dt,
        normal,
    ),
)
kernel.directional(Q_copy[0], Q_copy[0] + 0.5 * (tmp_flux[-1] - tmp_flux[1]))
left = -Max(tmp_eig[-1], tmp_eig[0]) * (Q[0] - Q[-1])
right = -Max(tmp_eig[1], tmp_eig[0]) * (Q[0] - Q[1])
kernel.directional(Q_copy[0], Q_copy[0] + 0.5 * dt * (left - right), struct=True)
kernel.single(Q[0], Q_copy[0])

CPPPrinter(kernel, exahype2=True, extern_c=False).file("generated_kernel.cpp")
print("wrote generated_kernel.cpp")
