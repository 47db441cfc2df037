"""The program's own spans, read from a profiler trace and from the
program's span table, and the device's idle time put down to them.

The port opens a span at each layer boundary of its train step, loader
and pseudo-labeller (`mulactseg_tpu_torch/utils/spans.py`): a
`record_function` range of the span's name while torch.profiler records,
and always a row (count, total ns, self ns) of its table. This file reads
both from what a loop puts in the context:

- `program_spans`: the trace's spans whose names start with `train.`,
  `loader.` or `plbl.`, as (start_s, end_s, name, thread) on the clock of
  `common.reduce_profile`'s kernel spans (context key `program_spans`);
- `span_totals`: the table's change over the unprofiled window, name ->
  (count, total_ns, self_ns) (context key `span_totals`).

A reader returns None where it finds nothing to read: a program without
the span, or a run that did not record it.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark import yardstick

PREFIXES = ("train.", "loader.", "plbl.")
UNSPANNED = "unspanned"

# per-layer metric -> (span, self time?): host ms a step of the unprofiled
# window, from span_totals
HOST_MS_PER_STEP = {
    "train.host_ms_per_step": ("train.step", False),
    "train.h2d_host_ms_per_step": ("train.h2d", True),
    "model.forward_host_ms_per_step": ("train.forward", True),
    "loss.host_ms_per_step": ("train.loss", True),
    "train.backward_host_ms_per_step": ("train.backward", True),
    "optimizer.host_ms_per_step": ("train.optimizer", True),
    "loader.next_host_ms_per_step": ("loader.next", True),
    "loader.build_host_ms_per_step": ("loader.build", True),
}
# per-layer metric -> the innermost spans whose device idle ms it sums, a
# step or an image of the traced stretch; train.step's own code counts as
# unspanned
IDLE_MS_PER_STEP = {
    "device.idle_ms_per_step.h2d": ("train.h2d",),
    "device.idle_ms_per_step.forward": ("train.forward",),
    "device.idle_ms_per_step.loss": ("train.loss",),
    "device.idle_ms_per_step.backward": ("train.backward",),
    "device.idle_ms_per_step.optimizer": ("train.optimizer",),
    "device.idle_ms_per_step.unspanned": ("train.step", UNSPANNED),
}
IDLE_MS_PER_IMAGE = {
    "device.idle_ms_per_image.loader": ("plbl.next",),
    "device.idle_ms_per_image.forward": ("plbl.forward",),
    "device.idle_ms_per_image.prop": ("plbl.softmax", "plbl.k5",
                                      "plbl.pass1", "plbl.threshold",
                                      "plbl.pass2"),
    "device.idle_ms_per_image.upload": ("plbl.upload",),
    "device.idle_ms_per_image.fetch": ("plbl.fetch",),
    "device.idle_ms_per_image.save": ("plbl.save",),
    "device.idle_ms_per_image.unspanned": (UNSPANNED,),
}

Span = Tuple[float, float, str, int]


def program_spans(prof) -> List[Span]:
    """The profiler's host ranges of the program's spans, (start_s, end_s,
    name, thread), sorted."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start * 1e-6, e.time_range.end * 1e-6,
                   e.name, e.thread) for e in prof.events()
                  if e.device_type == DeviceType.CPU
                  and e.name.startswith(PREFIXES))


def caller_thread(spans: Sequence[Span]) -> Optional[int]:
    """The thread that called step() or generate(): the one whose train.
    and plbl. spans last longest (the loader's threads hold loader.build
    alone)."""
    held: Dict[int, float] = {}
    for s, e, name, thread in spans:
        if name.startswith(("train.", "plbl.")):
            held[thread] = held.get(thread, 0.0) + (e - s)
    return max(held, key=held.get) if held else None


def idle_parts(kernels: Sequence[Tuple[float, float]],
               spans: Sequence[Span]) -> Dict[str, float]:
    """Seconds of the device's idle intervals between the first kernel and
    the last (yardstick.gaps over their union), each instant put down to
    the innermost program span open then on the caller's thread, or to
    UNSPANNED. The parts sum to the idle time."""
    if not kernels:
        return {}
    lo = min(s for s, _ in kernels)
    hi = max(e for _, e in kernels)
    caller = caller_thread(spans)
    mine = [(s, e, n) for s, e, n, t in spans if t == caller]
    # between two neighbouring cuts every span is open throughout or not
    # at all; spans of one thread nest, so the latest to start is innermost
    cuts = sorted({x for s, e, _ in mine for x in (s, e)})
    names = []
    for a, b in zip(cuts, cuts[1:]):
        open_ = [(s, -e, n) for s, e, n in mine if s <= a and b <= e]
        names.append(max(open_)[2] if open_ else UNSPANNED)
    parts: Dict[str, float] = {}
    for g0, g1 in yardstick.gaps(kernels, lo, hi):
        i = bisect.bisect_right(cuts, g0)
        x = g0
        while x < g1:
            y = min(g1, cuts[i]) if i < len(cuts) else g1
            name = names[i - 1] if 0 < i < len(cuts) else UNSPANNED
            parts[name] = parts.get(name, 0.0) + (y - x)
            x, i = y, i + 1
    return parts


def idle_by_span(ctx: Dict, unit: str) -> Optional[Dict[str, float]]:
    """Device idle ms a step or image (`unit`: prof_steps or prof_images)
    of the traced stretch by innermost program span (idle_parts); None
    without kernel spans or program spans."""
    kernels, spans = ctx.get("prof_spans"), ctx.get("program_spans")
    n = ctx.get(unit)
    if not kernels or not spans or not n:
        return None
    parts = idle_parts([(s, e) for s, e, _ in kernels], spans)
    return {k: v / n * 1e3 for k, v in parts.items()}


def idle_ms(ctx: Dict, unit: str, names: Sequence[str]) -> Optional[float]:
    """The idle ms a unit under the innermost spans `names` (UNSPANNED
    among them for the rest); None when none of the named spans was in
    the trace."""
    parts = idle_by_span(ctx, unit)
    seen = {n for _, _, n, _ in ctx.get("program_spans") or ()}
    if parts is None or not (seen | {UNSPANNED}) & set(names):
        return None
    return sum(parts.get(n, 0.0) for n in names)


def host_ms(ctx: Dict, name: str, unit: str, own: bool = True
            ) -> Optional[float]:
    """Host ms a unit (`unit`: steps or images of the unprofiled window) in
    the span `name`, its self time (own) or its whole duration, from
    span_totals."""
    row = (ctx.get("span_totals") or {}).get(name)
    n = ctx.get(unit)
    if not row or not row[0] or not n:
        return None
    return (row[2] if own else row[1]) / n * 1e-6


def delta(before: Dict, after: Dict) -> Dict[str, Tuple[int, int, int]]:
    """after - before of two span tables, the spans that ran between."""
    out = {}
    for name, row in after.items():
        d = tuple(a - b for a, b in zip(row, before.get(name, (0, 0, 0))))
        if d[0]:
            out[name] = d
    return out


def metrics(ctx: Dict) -> Dict[str, float]:
    """Every span metric that reads in this context: a training loop's
    (prof_steps) or the pseudo-labeller's (prof_images)."""
    got: Dict[str, Optional[float]] = {}
    if ctx.get("prof_steps"):
        for m, (name, own) in HOST_MS_PER_STEP.items():
            got[m] = host_ms(ctx, name, "steps", own)
        for m, names in IDLE_MS_PER_STEP.items():
            got[m] = idle_ms(ctx, "prof_steps", names)
    elif ctx.get("prof_images"):
        for m, names in IDLE_MS_PER_IMAGE.items():
            got[m] = idle_ms(ctx, "prof_images", names)
    return {m: v for m, v in got.items() if v is not None}
