"""Load the JAX package's pure-Python modules without importing its package.

``mystereomatching_tpu/config.py`` and ``data.py`` import only the standard
library and numpy, but importing them as ``mystereomatching_tpu.config``
runs ``mystereomatching_tpu/__init__.py``, which imports the pipeline and
with it jax. Loading the files by path keeps one source of truth for the
configuration and the synthetic scenes while the port stays jax-free.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

REFERENCE_PACKAGE = Path(__file__).resolve().parents[1] / "mystereomatching_tpu"


def load_module(filename: str, module_name: str):
    """Execute ``REFERENCE_PACKAGE/filename`` as module ``module_name``.

    The module is registered in ``sys.modules`` before it runs, because
    ``dataclasses`` resolves a class's string annotations through its
    module there.
    """
    if module_name in sys.modules:
        return sys.modules[module_name]
    spec = importlib.util.spec_from_file_location(
        module_name, REFERENCE_PACKAGE / filename)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[module_name]
        raise
    return module
