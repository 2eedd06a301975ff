"""The canonical batched-stateless Rusanov kernel, end to end.

Counterpart of the reference's flagship example
(``examples/Batched_stateless.py``): builds the 2-D Euler Rusanov spec and
emits every backend artifact — native C++, Loop IR text (the analogue of the
reference's ``test.mlir``), and a jitted JAX kernel that it actually runs.
"""

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np

from exahype_jax.backends.cpp_backend import CPPPrinter
from exahype_jax.backends.jax_backend import JAXPrinter
from exahype_jax.ir import print_function, spec_to_loops
from exahype_jax.models.rusanov import build_rusanov_kernel

kernel = build_rusanov_kernel(dim=2, patch_size=4, halo_size=1, n_real=5, n_aux=5)

# Native backend -> test.cpp (compile with exahype_jax/native/euler.cpp).
CPPPrinter(kernel, header="euler.h").file("test.cpp")

# Loop IR -> test.lir (the inspectable lowered form).
with open("test.lir", "w") as fh:
    fh.write(print_function(spec_to_loops(kernel)))

# JAX backend: build, jit, run one step.
step = JAXPrinter(kernel).jit(donate_input=False)
rng = np.random.default_rng(0)
Q = rng.uniform(0.1, 1.0, size=kernel.item_shape("Q"))
Q[..., 0] += 1.0
Q[..., 3] += 5.0
out = step(Q, 0.01)
print("ran time_step:", out.shape, "finite:", bool(np.isfinite(np.asarray(out)).all()))
print("wrote test.cpp and test.lir")
