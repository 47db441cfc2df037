"""The benchmark of mulactseg_tpu_torch, one run of one cell:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The cell's entry in BENCHMARK.json names its
configuration (benchmark/configs/<config>.json), its traffic mix
(benchmark/traffic/<traffic>.json, whose `kind` picks the loop in
benchmark/loops/) and its correctness limits
(benchmark/limits/<workload>.json). The run sets up, measures for
--seconds, checks what the timed path produced against the plain
reference, and prints one JSON line last: the cell's end-to-end metrics
with --trace 0, its per-layer metrics (benchmark/metrics/<name>.py) with
--trace 1. It needs a CUDA card and never falls back to the CPU.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mulactseg_tpu")


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def cell_of(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in mods} & set(FORBIDDEN))


def reader(name):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench, cell, trace, out):
    """The cell's end-to-end metrics (trace 0) or per-layer metrics
    (trace 1), each listed for this cell or for every cell."""
    name = cell["name"]
    mine = [m for m in bench["per_layer" if trace else "end_to_end"]
            if name in m.get("workloads", [name])]
    got = {}
    for m in mine:
        if trace:
            v = reader(m["name"])(out["ctx"])
        else:
            v = out["end_to_end"].get(m["name"])
        if v is not None and math.isfinite(v):
            got[m["name"]] = {"value": v, "unit": m["unit"]}
    return got


def set_env():
    """Caches of the program inside the checkout; no JAX through
    transformers."""
    os.environ["USE_FLAX"] = "0"
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    set_env()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = cell_of(bench, args.workload)
    cfg = load_json("configs", f"{cell['config']}.json")
    mix = load_json("traffic", f"{cell['traffic']}.json")
    limits = load_json("limits", f"{cell['name']}.json")["limits"]

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    from benchmark import common

    loop = importlib.import_module(f"benchmark.loops.{mix['kind']}")
    out = loop.run(cell, cfg, mix, limits, args.seed, args.seconds,
                     bool(args.trace), dev, T0)
    out["end_to_end"] = {"setup_s": out["setup_s"], mix["rate"]: out["rate"]}
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3
    correct, checks = common.judge(out["values"], limits)
    device = common.device_info(dev)
    device["memory_peak_bytes"] = int(out["peak_bytes"])
    if args.trace:
        device["busy_s"] = out["ctx"].get("prof_busy_s", 0.0)
        device["window_s"] = out["ctx"].get("prof_window_s", 0.0)
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"],
              "metrics": metrics_of(bench, cell, args.trace, out),
              "device": device}
    if args.trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
