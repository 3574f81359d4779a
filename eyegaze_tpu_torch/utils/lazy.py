"""Packages imported at their first use.

The card's host has no pandas and no matplotlib, and every module of the
port must import there.  The modules that write tables or draw figures
(``utils/visualizers``, ``analysis/matlab_parity``, ``analysis/comparison``)
bind ``pd``, ``plt`` and the like to a ``LazyImport`` instead of the
package: the package is imported when a function first reaches into it, so
a function that needs a missing package stops there with an ``ImportError``
that names it, and the functions that need neither run.
"""

from __future__ import annotations

import importlib
from typing import Callable, Optional


def use_agg() -> None:
    """Selects matplotlib's headless backend, as the JAX package's plotting
    modules do when they are imported."""
    import matplotlib

    matplotlib.use("Agg")


class LazyImport:
    """Stands for the module ``module``, or its attribute ``attr``, and
    imports it at the first attribute access; ``setup`` runs once before
    that import."""

    def __init__(self, module: str, attr: Optional[str] = None,
                 setup: Optional[Callable[[], None]] = None):
        self._module, self._attr, self._setup, self._target = module, attr, setup, None

    def _load(self):
        if self._target is None:
            package = self._module.split(".")[0]
            try:
                if self._setup is not None:
                    self._setup()
                target = importlib.import_module(self._module)
            except ImportError as e:
                raise ImportError(f"this function needs {package}, which is not installed "
                                  "here; run it where it is", name=package) from e
            self._target = getattr(target, self._attr) if self._attr else target
        return self._target

    def __getattr__(self, name: str):
        return getattr(self._load(), name)
