"""Frozen counts of the program's kernels' work, one module a kernel, and
the card's peaks (``peaks.py``)."""

import importlib
import pkgutil


def kernels() -> list:
    """Every kernel module here: those with ``work``, ``CAPTURE`` and
    ``KERNELS``."""
    mods = [importlib.import_module(f"{__name__}.{m.name}")
            for m in pkgutil.iter_modules(__path__)]
    return [m for m in mods
            if all(hasattr(m, a) for a in ("work", "CAPTURE", "KERNELS"))]
