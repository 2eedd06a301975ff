"""Kernel spec module for `exahype-opt --spec` codegen.

    exahype-opt examples/spec_rusanov.py --spec --emit cpp
    exahype-opt examples/spec_rusanov.py --spec --emit mlir
"""

from exahype_jax.models.rusanov import build_rusanov_kernel


def build():
    return build_rusanov_kernel(dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=5)
