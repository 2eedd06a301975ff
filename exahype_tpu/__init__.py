"""The package's former name, kept so that existing imports go on working.

Importing it, or any submodule under it, returns the very module objects of
:mod:`exahype_jax` (one copy of every class, so ``isinstance`` and the
solvers' identity checks hold across both names).  New code imports
:mod:`exahype_jax`.
"""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

_NEW = "exahype_jax"
_OLD = __name__


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<old>.x.y`` to the already-imported ``exahype_jax.x.y``."""

    def find_spec(self, fullname, path, target=None):
        if fullname.startswith(_OLD + "."):
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(_NEW + spec.name[len(_OLD):])
        spec.loader_state = module.__spec__
        return module

    def exec_module(self, module):
        # The import system stamped the alias spec on the shared module;
        # give it back its own.
        module.__spec__ = module.__spec__.loader_state


warnings.warn(
    f"{_OLD} is now {_NEW}; import {_NEW} instead",
    DeprecationWarning,
    stacklevel=2,
)
if not any(isinstance(f, _Alias) for f in sys.meta_path):
    sys.meta_path.insert(0, _Alias())
sys.modules[_OLD] = importlib.import_module(_NEW)
