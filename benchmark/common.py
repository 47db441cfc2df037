"""What the loops share: seeds, the weights made from the seed, the card's
description, the profiler's reduction, and the comparison with limits."""

from __future__ import annotations

import math
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import reference, yardstick


def seed_of(seed: int, stream: int) -> int:
    """A 63-bit seed for one use of `seed` (torch generators)."""
    s = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), stream])
    return int(s.generate_state(2, np.uint64)[0] >> np.uint64(1))


@torch.no_grad()
def make_weights(cfg: Dict, seed: int, dev) -> Dict[str, torch.Tensor]:
    """The configuration's reference network's weights and buffers by name,
    made on `dev` from the seed by its module's `weight_rule`: the drawn
    leaves in its order from one normal draw, each at its standard
    deviation, every other leaf filled."""
    ref = reference.of(cfg)
    with torch.device("meta"):
        net = ref.Net(cfg)
    drawn, fill = ref.weight_rule(net, cfg)
    shapes = dict(net.named_parameters())
    shapes.update(net.named_buffers())
    total = sum(shapes[n].numel() for n, _ in drawn)
    g = torch.Generator(device=dev).manual_seed(seed_of(seed, 1))
    z = torch.randn(total, generator=g, device=dev)
    out, at = {}, 0
    for n, std in drawn:
        shape = shapes[n].shape
        k = math.prod(shape)
        out[n] = (z[at:at + k] * std).view(shape)
        at += k
    for n, t in shapes.items():
        if n not in out:
            out[n] = torch.full(t.shape, fill[n], device=dev)
    return out


def reference_net(cfg: Dict, seed: int, dev):
    """The configuration's reference module, its network on `dev` holding
    the weights made from the seed, and those weights."""
    ref = reference.of(cfg)
    weights = make_weights(cfg, seed, dev)
    net = ref.Net(cfg).to(dev)
    load_weights(net, weights)
    return ref, net, weights


@torch.no_grad()
def load_weights(module: torch.nn.Module, weights: Dict[str, torch.Tensor]):
    """Copy weights into a module's parameters and buffers by name; the
    module and the weights have the same names and shapes."""
    own = dict(module.named_parameters())
    own.update(dict(module.named_buffers()))
    missing = sorted(set(own) - set(weights))
    extra = sorted(set(weights) - set(own))
    if missing or extra:
        raise KeyError(f"no weights made for {missing[:5]}; weights made "
                       f"for no leaf of the module: {extra[:5]}")
    for n, t in own.items():
        if t.shape != weights[n].shape:
            raise ValueError(f"{n}: the module's shape {tuple(t.shape)}, "
                             f"the weights' {tuple(weights[n].shape)}")
        t.copy_(weights[n])


class Phases:
    """Set-up's parts on standard error: seconds since process start at
    the end of each, so that a slow part shows."""

    def __init__(self, t0: float):
        self.t0 = self.last = t0

    def __call__(self, name: str):
        now = time.perf_counter()
        took = now - self.last
        print(f"phase {name}: {took:.3f} s, at {now - self.t0:.3f} s",
              file=sys.stderr, flush=True)
        self.last = now


def device_info(dev) -> Dict:
    """The card: its name, the cards this run uses, its power limit."""
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=20).stdout.strip()
        info["power_limit"] = out
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


def reduce_profile(prof, names=()) -> Dict:
    """A torch.profiler run reduced to what the metric readers read: the
    device kernel spans (start, end, name) in seconds, their union, and for
    each record_function range named in `names` its host seconds and the
    device seconds of the kernels launched inside it."""
    from torch.autograd import DeviceType

    spans = []
    ranges = {n: {"host_s": 0.0, "device_s": 0.0, "count": 0} for n in names}
    host_ops = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            if e.time_range.end > e.time_range.start:
                spans.append((e.time_range.start * 1e-6,
                              e.time_range.end * 1e-6, e.name))
        elif e.name in ranges:
            r = ranges[e.name]
            r["host_s"] += (e.time_range.end - e.time_range.start) * 1e-6
            r["device_s"] += e.device_time_total * 1e-6
            r["count"] += 1
        elif e.device_type == DeviceType.CPU:
            host_ops.append((e.time_range.start * 1e-6,
                             e.time_range.end * 1e-6, e.name))
    spans.sort()
    return {"spans": spans, "ranges": ranges, "host_ops": host_ops,
            "busy_s": yardstick.union([(s, e) for s, e, _ in spans])}


def breakdown(red: Dict, top: int = 10) -> Dict:
    """The device operations that took most time, and the longest idle
    gaps between the first and the last kernel, each named by the
    innermost host op running when it began."""
    by_name: Dict[str, float] = {}
    for s, e, n in red["spans"]:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = red["spans"]
    if not spans:
        return {"device_ops": [[n[:120], t] for n, t in ops],
                "idle_gaps": []}
    idle = yardstick.gaps([(s, e) for s, e, _ in spans], spans[0][0],
                          spans[-1][1])
    idle = sorted(idle, key=lambda g: g[0] - g[1])[:top]
    host = sorted(red["host_ops"])
    out = []
    for s, e in idle:
        inner = [h for h in host if h[0] <= s < h[1]]
        name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "none"
        out.append([name[:120], e - s])
    return {"device_ops": [[n[:120], t] for n, t in ops], "idle_gaps": out}


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> (bool, Dict[str, Dict[str, float]]):
    """Each number beside its limit; correct when every one is finite and
    at most its limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name, float("nan"))
        checks[name] = {"value": v, "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, checks


def rel_gap(a: float, b: float, scale: Optional[float] = None) -> float:
    return abs(a - b) / (abs(b) if scale is None else scale)


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: List[str], over=max) -> float:
    """The worst leaf's (or with over=np.median the median leaf's) gap
    between two norms, over the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    med = float(np.median([ref[n] for n in keep]))
    return float(over([abs(prog[n] - ref[n]) / max(ref[n], med)
                       for n in keep]))
