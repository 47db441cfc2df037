"""run.py's --trace 1 run of one cell, with the program's spans read as
well (benchmark/spans.py):

    python3 benchmark/span_run.py --workload <name> --seed <n> --seconds <s>

In this process only, it wraps `common.reduce_profile` (to read the
program's spans from the loop's profiler), each loop's `profile` (to put
them, and the span table's change over the unprofiled window, into the
context) and `run.metrics_of` (to keep the context). It prints run.py's
line, then one more JSON line: `span_metrics` (spans.metrics), and
`spans`: the traced stretch's idle ms a step or image in all and by
innermost span, and by span the host ms a step or image of the traced
stretch (whole durations) and of the unprofiled window (count, whole and
self ms).
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402  (starts run.py's set-up clock)
from benchmark import common, spans  # noqa: E402
from benchmark.loops import plbl, train  # noqa: E402


def table() -> dict:
    """The program's span table now ({} for a program without one)."""
    try:
        from mulactseg_tpu_torch.utils import spans as program
    except ImportError:
        return {}
    return program.snapshot()


def install(state: dict, patch=setattr) -> None:
    """Wraps what span_run reads through, each by patch(owner, name,
    wrapper); fills `state` with program_spans, the window's span tables
    and the run's context."""
    reduce_profile, phases = common.reduce_profile, common.Phases.__call__

    def reduce_spans(prof, names=()):
        state["program_spans"] = spans.program_spans(prof)
        return reduce_profile(prof, names)

    def phase(self, name):
        phases(self, name)
        if name == "warm-up":  # the window starts next
            state["before"] = table()

    def wrap(fn):
        def wrapped(*args, **kw):
            state.setdefault("after", table())  # the window has ended
            return fn(*args, **kw)
        return wrapped

    def profile_of(fn):
        def profile(*args, **kw):
            state.setdefault("after", table())
            out = fn(*args, **kw)
            out["program_spans"] = state.pop("program_spans", [])
            out["span_totals"] = spans.delta(state.get("before", {}),
                                             state["after"])
            return out
        return profile

    def metrics_of(bench, cell, trace, out):
        state["ctx"] = out["ctx"]
        return keep(bench, cell, trace, out)

    keep = run.metrics_of
    patch(common, "reduce_profile", reduce_spans)
    patch(common.Phases, "__call__", phase)
    patch(train, "step_flops", wrap(train.step_flops))
    patch(train, "profile", profile_of(train.profile))
    patch(plbl, "profile", profile_of(plbl.profile))
    patch(run, "metrics_of", metrics_of)


def summary(ctx: dict) -> dict:
    """The span metrics and the figures beside them (module docstring)."""
    unit, window_unit = (("prof_steps", "steps") if ctx.get("prof_steps")
                         else ("prof_images", "images"))
    n, n_window = ctx.get(unit) or 0, ctx.get(window_unit) or 0
    prog = ctx.get("program_spans") or []
    caller = spans.caller_thread(prog)
    traced: dict = {}
    for s, e, name, thread in prog:
        if thread == caller and n:
            traced[name] = traced.get(name, 0.0) + (e - s) / n * 1e3
    parts = spans.idle_by_span(ctx, unit) or {}
    window = {name: [c, t / n_window * 1e-6, o / n_window * 1e-6]
              for name, (c, t, o) in (ctx.get("span_totals") or {}).items()
              if n_window}
    return {"span_metrics": spans.metrics(ctx),
            "spans": {"idle_ms": sum(parts.values()), "idle_by_span": parts,
                      "traced_host_ms": traced, "window_ms": window}}


def main(argv=None) -> int:
    state: dict = {}
    install(state)
    argv = list(sys.argv[1:] if argv is None else argv)
    rc = run.main(argv + ["--trace", "1"])
    if rc == 0:
        print(json.dumps(summary(state["ctx"])), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
