"""What the per-layer metric files share: sums over the traced stretch's
device spans by kind or by kernel, with the launch counters checked
against the spans. A reader returns None where it finds nothing to read."""

from __future__ import annotations

from typing import Dict, Optional

from benchmark import yardstick

# each wrapper's launch shows as this many spans with these names
LAUNCH_SPANS = {"pixel_ce_fwd": "pixel_ce_fwd_kernel",
                "pixel_ce_bwd": "pixel_ce_bwd_kernel",
                "ssm_fwd": "ssm_span_kernel", "ssm_bwd": "ssm_bwd_kernel",
                "seg_max_fwd": "seg_max_span_kernel"}


def kind_s(ctx: Dict, kind: str) -> Optional[float]:
    spans = ctx.get("prof_spans")
    if not spans:
        return None
    return sum(e - s for s, e, n in spans if yardstick.kind_of(n) == kind)


def kernels_s(ctx: Dict, kernels) -> Optional[float]:
    """Device seconds of the named wrappers' kernels, or None when none ran
    or a wrapper's launch count disagrees with the spans."""
    spans = ctx.get("prof_spans")
    launches = ctx.get("launches", {})
    if not spans or not any(launches.get(k) for k in kernels):
        return None
    for k in kernels:
        seen = sum(LAUNCH_SPANS[k] in n for _, _, n in spans)
        if seen != launches.get(k, 0):
            return None
    total = sum(e - s for s, e, n in spans
                if yardstick.kernel_of(n) in kernels)
    return total or None


def per(ctx: Dict, seconds: Optional[float], unit: str) -> Optional[float]:
    """ms per step or per image of the traced stretch."""
    n = ctx.get(unit)
    if seconds is None or not n:
        return None
    return seconds / n * 1e3


def idle_share(ctx: Dict) -> Optional[float]:
    """1 - the device's busy time a step (or image), from the traced
    stretch, over the unprofiled window's time a step (or image): the
    profiler slows the host, so the traced stretch's own length would
    overstate the idle share of the loop that the window times."""
    busy = ctx.get("prof_busy_s")
    n_prof = ctx.get("prof_steps") or ctx.get("prof_images")
    n, window = ctx.get("steps") or ctx.get("images"), ctx.get("window_s")
    if not (busy and n_prof and n and window):
        return None
    return (1.0 - (busy / n_prof) / (window / n)) * 100.0


def peak_gib(ctx: Dict) -> Optional[float]:
    b = ctx.get("peak_window_bytes")
    return b / 2 ** 30 if b else None


def range_s(ctx: Dict, names, key: str) -> Optional[float]:
    ranges = ctx.get("ranges", {})
    if not all(ranges.get(n, {}).get("count") for n in names):
        return None
    return sum(ranges[n][key] for n in names)
