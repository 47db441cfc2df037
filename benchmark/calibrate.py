"""The readings that a cell's correctness limits are set from, on the card
at the cell's own size:

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 ...
        [--controls 3] [--faults 3] [--out FILE]

For each seed: the program's numbers against the plain reference (sound
runs: the lower reading is their largest), and on the first --controls
seeds the control's (the reference in float8 e4m3 convolutions in the
program's place) and on the first --faults seeds each fault's that the
cell can have (training: half of each batch left out, the mean taken over
the rest; pseudo-labels: the top half of each map's labels altered where it
is made). Each reading prints as one JSON line. The window is not run: the
training cells' numbers come from set-up's first steps, the
pseudo-labelling cell's from a short run of `check_images` images, one
of each source.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def half_batch(step):
    """The fault: each step takes the first half of its batch's rows."""
    def faulty(batch):
        n = len(batch["images"]) // 2
        return step({k: v[:n] for k, v in batch.items()})
    faulty.step = 0
    faulty.optimizer = step.optimizer
    return faulty


def train_readings(cfg, mix, seed, dev, control, fault):
    from benchmark import common, gen
    from benchmark.loops import train

    items = gen.make_items(seed, cfg, mix)
    rows = {}
    for kind in ["program"] + (["half_batch"] if fault else []):
        model, step, _ = train.build(
            cfg, mix, seed, dev,
            common.make_weights(cfg, seed, dev))
        if kind == "half_batch":
            step = half_batch(step)
        loader = train.loader_of(items, cfg, mix, seed)
        batches, *prog = train.first_steps(model, step, loader,
                                           mix["check_steps"])
        loader.close()
        rows[kind] = prog
        del model, step
    batches, bad = train.pool_batches(batches, items)
    ref = train.reference_numbers(cfg, mix, seed, dev, batches)
    out = {k: train.compare(v, ref, bad) for k, v in rows.items()}
    if control:
        out["control"] = train.compare(train.reference_numbers(
            cfg, mix, seed, dev, batches, fp8=True), ref)
    return out


def plbl_readings(cfg, mix, seed, dev, control, fault):
    import tempfile

    import torch

    from benchmark import common
    from benchmark.loops import plbl
    from mulactseg_tpu_torch.models.factory import get_model
    from mulactseg_tpu_torch.plbl.generator import PseudoLabelGenerator

    sources = plbl.make_sources(seed, cfg, mix)
    n = mix["check_images"]
    pcfg = plbl.port_config(cfg, seed)
    model = get_model(cfg["model"], cfg["num_outputs"], cfg["output_stride"],
                      separable_conv=cfg["separable_conv"], device=dev)
    common.load_weights(model, common.make_weights(cfg, seed, dev))
    model.eval()
    gen_ = PseudoLabelGenerator(model, pcfg, cfg["plbl"]["type"],
                                max_protos=cfg["plbl"]["max_protos"],
                                device=dev)
    suppix = {f"spx_{i}": s.selected.tolist() for i, s in enumerate(sources)}
    with tempfile.TemporaryDirectory() as out:
        feed = plbl.Feed(sources, limit=n)
        gen_.generate(None, feed, save_dir=out, suppix=suppix)
        got = [plbl.read_png_gray8(os.path.join(out, f"{k}.png"))
               for k in feed.names]
    del gen_, model
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    ref = plbl.reference_maps(cfg, seed, dev, sources[:n])

    def reading(maps):
        counts = [plbl.map_counts(g, w) for g, w in zip(maps, ref)]
        return {"plbl_pooled_gap": plbl.pooled_gap(counts),
                "per_image": counts}

    res = {"program": reading(got)}
    if fault:
        res["altered"] = reading([altered(g, cfg["num_outputs"])
                                  for g in got])
    if control:
        res["control"] = reading(plbl.reference_maps(cfg, seed, dev,
                                                     sources[:n], fp8=True))
    return res


def altered(labels, num_outputs):
    """The fault: the top half of a map takes the next class where it is
    labelled."""
    out = labels.copy()
    blk = out[:out.shape[0] // 2]
    lab = blk != 255
    blk[lab] = (blk[lab].astype(int) + 1) % num_outputs
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import run

    run.set_env()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = run.cell_of(bench, args.workload)
    cfg = run.load_json("configs", f"{cell['config']}.json")
    mix = run.load_json("traffic", f"{cell['traffic']}.json")
    dev = torch.device(args.device)
    readings = train_readings if mix["kind"] == "train" else plbl_readings
    lines = []
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        got = readings(cfg, mix, seed, dev, i < args.controls,
                       i < args.faults)
        line = {"workload": cell["name"], "seed": seed,
                "seconds": time.perf_counter() - t, **got}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
