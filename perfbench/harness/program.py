"""The program's own spans, for the per-layer readers that read them.

Importing this module turns the program's tracer on
(``sim_a_splat_torch.utils.profiling``).  The harness loads a per-layer
reader only in a ``--trace 1`` run, and only for the metrics of the cell, so
the runs that give the end-to-end metrics, and a cell none of whose
metrics reads the program's spans, keep tracing off.

A window step of the train loop is one ``step.train`` root span: of the
run's roots, the last ``ctx.trace_steps`` are the profiled steps, and the
``ctx.steps`` before them the measured window's (the warm step before
the window comes earlier still).  On a program without the tracer this
module does nothing and its readings are None.
"""

from __future__ import annotations

import importlib

ROOT_SPAN = "step.train"


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        mod = importlib.import_module("sim_a_splat_torch.utils.profiling")
    except ImportError:
        return None
    if not all(hasattr(mod, a) for a in ("enable", "roots")):
        return None
    return mod


def window_roots(ctx, root: str = ROOT_SPAN):
    """The measured window's root spans named ``root`` (each a
    ``profiling.Root``), or None where the tracer or any of them is
    missing."""
    t = tracer()
    if t is None or not ctx.steps:
        return None
    n = ctx.steps + ctx.trace_steps
    roots = t.roots(root, last=n)
    if len(roots) < n:
        return None
    return roots[:ctx.steps]


def span_ms(ctx, names, root: str = ROOT_SPAN):
    """Host milliseconds a window step in the spans ``names`` under the
    root spans ``root`` (every call of each name), or None where none ran."""
    roots = window_roots(ctx, root)
    if not roots or not any(n in r.by_name for r in roots for n in names):
        return None
    return sum(r.by_name.get(n, 0.0) for r in roots for n in names) \
        / len(roots) * 1e3


def self_ms(ctx, root: str = ROOT_SPAN):
    """Host milliseconds a window step in the root span ``root`` that no
    child span covers, or None."""
    roots = window_roots(ctx, root)
    if not roots:
        return None
    return sum(r.self_s for r in roots) / len(roots) * 1e3


_t = tracer()
if _t is not None:
    _t.enable(True)
