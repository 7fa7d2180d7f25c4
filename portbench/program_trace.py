"""The program's own spans and counters (``metalens_tpu_torch.trace``), as
the per-layer metrics of source ``program_span`` and ``program_counter``
read them after a traced stretch.

The program records while a torch profiler records, so the registry holds
the traced stretch alone.  Its snapshot is taken once per result line and
kept in the readers' shared ``ctx``.  A program without the registry, or a
stretch in which the layer did not run, reads None.

The readers of ``metrics_pending/`` are listed by no cell yet: a cell
reports one once its file moves into ``metrics/`` and the cell's
``per_layer`` list names it (``tests/test_portbench_program_trace.py``
installs them so into a copy and runs the cells traced).
"""

from __future__ import annotations


def snapshot(ctx):
    """The registry's snapshot for this traced stretch (None where the
    program has no registry)."""
    if "program_trace" not in ctx:
        try:
            from metalens_tpu_torch import trace
        except ImportError:
            ctx["program_trace"] = None
        else:
            ctx["program_trace"] = trace.snapshot()
    return ctx["program_trace"]


def span(ctx, name: str, key: str):
    """``key`` (``count``, ``host_ms``, ``self_ms`` or ``device_ms``) of the
    span ``name`` summed over the stretch; None where it was not
    recorded."""
    snap = snapshot(ctx)
    s = None if snap is None else snap["spans"].get(name)
    return None if s is None else s[key]


def counter(ctx, name: str, within: str):
    """The counter ``name`` over the stretch: 0 where the span ``within``
    ran and nothing was counted, None where ``within`` did not run."""
    if not span(ctx, within, "count"):
        return None
    return snapshot(ctx)["counters"].get(name, 0)


def per(value, n):
    """``value`` / ``n``, None where either is missing or ``n`` is 0."""
    return None if value is None or not n else value / n
