"""One run of one cell: set-up, the measured window, the traced stretch, the
check, and the result line.

A driver (``drivers/<name>.py``) provides

* ``setup(cell, seed, device) -> state``: inputs from the seed, every shape
  the traffic uses warmed up;
* ``run_unit(state, spans)``: one unit of the cell's work, ending when the
  device has finished it;
* ``end_to_end(state, units, window_s) -> {metric: value}``;
* ``trace_units(state) -> int``: how many units the traced stretch runs;
* ``release(state)``: drops the program's state before the check;
* ``check(state) -> (checks, attempted, failed)``, ``checks`` a list of
  ``{"name", "value", "max" or "min"}``, against the plain reference;

and, for a cell on several chips, ``execute(cell, seed, seconds, trace,
t_start) -> result`` instead of all of these.
"""

from __future__ import annotations

import json
import sys
import time

from . import harness, work


def window(driver, state, spans, seconds: float):
    """Units run back to back until ``seconds`` have passed; returns (units,
    seconds elapsed up to the end of the last unit)."""
    units = 0
    t0 = time.perf_counter()
    while True:
        driver.run_unit(state, spans)
        units += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return units, elapsed


def per_layer_values(cell, ctx) -> dict:
    out = {}
    for name, mod in cell.per_layer():
        v = mod.read(ctx)
        if v is not None:
            out[name] = {"value": v, "unit": mod.UNIT}
    return out


def passed(c) -> bool:
    v = c["value"]
    if v != v:                      # NaN
        return False
    return v <= c["max"] if "max" in c else v >= c["min"]


def execute(cell, seed: int, seconds: float, trace: int, device="cuda",
            t_start=None):
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    driver = cell.driver()
    if cell.chips > 1:
        return driver.execute(cell, seed, seconds, trace, t_start,
                              device=device)
    cuda = torch.device(device).type == "cuda"
    state = driver.setup(cell, seed, device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    spans = harness.Spans(torch, cuda)
    units, window_s = window(driver, state, spans, seconds)
    metrics, breakdown, extra = {}, None, {}
    if trace:
        n = driver.trace_units(state)
        tspans = harness.Spans(torch, cuda)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                driver.run_unit(state, tspans)
            traced_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        summary = harness.trace_summary(prof, torch, traced_s)
        del prof
        print(f"portbench: traced {n} unit(s) in {traced_s:.3f} s, read "
              f"the trace in {time.perf_counter() - t1:.3f} s",
              file=sys.stderr)
        ctx = {"summary": summary, "spans": tspans, "units": n,
               "state": state, "work": work}
        metrics = per_layer_values(cell, ctx)
        breakdown = {"device_ops": [[k, v] for k, v in summary["device_ops"]],
                     "idle_gaps": summary["idle_gaps"]}
        extra = {"busy_s": summary["busy_s"], "window_s": traced_s}
    else:
        values = driver.end_to_end(state, units, window_s)
        values["setup_s"] = setup_s
        for m in cell.end_to_end():
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    driver.release(state)
    if cuda:
        torch.cuda.empty_cache()
    checks, attempted, failed = driver.check(state)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak), **extra}
    result = {"correct": all(passed(c) for c in checks) and bool(checks),
              "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def report(result) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output."""
    for c in result["checks"]:
        lim = (f"<= {c['max']!r}" if "max" in c else f">= {c['min']!r}")
        print(f"check {c['name']}: {c['value']!r} {lim} "
              f"{'ok' if passed(c) else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
