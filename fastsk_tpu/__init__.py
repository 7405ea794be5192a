"""Deprecated former name of :mod:`fastsk_jax`.

Existing scripts that import the package, or any module in it, under its
former name keep working: each such name resolves to the same module
object as its ``fastsk_jax`` counterpart, and importing this package
emits a :class:`DeprecationWarning`. Import ``fastsk_jax`` instead.
"""

import importlib
import importlib.abc
import importlib.util
import sys
import warnings

_OLD = __name__
_NEW = "fastsk_jax"


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<former name>.x.y`` to the loaded ``fastsk_jax.x.y``."""

    def find_spec(self, name, path=None, target=None):
        if name.startswith(_OLD + "."):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        return importlib.import_module(_NEW + spec.name[len(_OLD):])

    def exec_module(self, module):
        pass


warnings.warn(
    f"the {_OLD} package was renamed {_NEW}; import {_NEW} instead",
    DeprecationWarning,
    stacklevel=2,
)
sys.meta_path.insert(0, _AliasFinder())
sys.modules[_OLD] = importlib.import_module(_NEW)
