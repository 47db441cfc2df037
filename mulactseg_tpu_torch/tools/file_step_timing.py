"""Where a file-backed stage-1 step's time goes, on one card:

    python3 mulactseg_tpu_torch/tools/file_step_timing.py [--images 8] \\
        [--workers 8] [--steps 12] [--out FILE]

Writes a Cityscapes-format tree of --images 1024x2048 images
(tools/cityscapes_tree.py, adaptive-filtered PNGs, nseg 2048) to a
temporary directory and builds the recipe's stage-1 training set over it
(RegionDatasetOr, rescale_769_multi_notrg, batch 4, 768x768, every
superpixel selected). Then, each timed with a synchronise at its end:
  - loader alone: one cold pass and then warm passes (files decoded, in
    each worker's cache), on --workers worker processes and on as many
    threads, items/s;
  - the parent's share of a batch: collate of the workers' items, the
    copy of the step's keys to the card (pageable), ms;
  - the train step alone (the full-width model, bf16, fused lossdecomp)
    on one batch already on the host, --steps steps: ms/step with a
    synchronise after each step, and over windows of 4 steps;
  - the train step fed by the warm process loader: ms/step, synchronised
    after each step and in windows of 4.
Prints the card's name and power limit, then one JSON line; --out writes
the line to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

if __package__ in (None, ""):  # run as a file: import this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

B = 4


def _sync():
    torch.cuda.synchronize()


def loader_pass(ds, processes: bool, workers: int, passes: int):
    """Items/s of each of `passes` passes over ds, one provider."""
    from mulactseg_tpu_torch.data.loader import DataProvider

    loader = DataProvider(ds, B, shuffle=True, drop_last=True,
                          infinite=True, num_workers=workers,
                          processes=processes)
    rates = []
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(len(ds) // B):
            next(loader)
        rates.append(B * (len(ds) // B) / (time.perf_counter() - t0))
    loader.close()
    return rates


def step_times(step, batches, steps: int):
    """ms/step with a synchronise after each step, and over windows of 4
    steps with one synchronise a window; batches is an iterator."""
    each, windows = [], []
    for _ in range(2):  # warm-up
        step(next(batches))
    _sync()
    for _ in range(steps):
        t0 = time.perf_counter()
        float(step(next(batches))["train_loss"])
        _sync()
        each.append((time.perf_counter() - t0) * 1e3)
    for _ in range(steps // 4):
        t0 = time.perf_counter()
        for _ in range(4):
            aux = step(next(batches))
        float(aux["train_loss"])
        _sync()
        windows.append((time.perf_counter() - t0) * 1e3 / 4)
    return {"synchronised_ms": each, "window_ms": windows}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--images", type=int, default=8)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--out")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("file_step_timing.py needs a CUDA device")
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.data.datasets import RegionDatasetOr
    from mulactseg_tpu_torch.data.loader import (
        DataProvider,
        collate,
        shutdown_workers,
    )
    from mulactseg_tpu_torch.data.transforms import get_train_transform
    from mulactseg_tpu_torch.engine.train import make_train_step
    from mulactseg_tpu_torch.models.factory import get_model
    from mulactseg_tpu_torch.tools.cityscapes_tree import write_tree

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    out = {"card": smi, "cpus": os.cpu_count(), "images": args.images,
           "workers": args.workers}
    with tempfile.TemporaryDirectory() as tmp:
        dl = write_tree(tmp, args.images, 0, processes=os.cpu_count() or 1)
        cfg = Config(data_root=tmp, datalist_dir=dl, separable_conv=True,
                     dtype="bfloat16").derive_paths()

        def dataset():
            return RegionDatasetOr(
                cfg, cfg.trg_datalist, cfg.region_dict, "active-label",
                transform=get_train_transform(cfg.train_transform, cfg))

        out["loader_items_per_s"] = {
            mode: loader_pass(dataset(), mode == "processes", args.workers,
                              3)
            for mode in ("processes", "threads")}

        ds = dataset()
        items = [ds[i] for i in range(B)]
        t0 = time.perf_counter()
        batch = collate(items)
        t1 = time.perf_counter()
        keys = ("images", "target_bits", "target", "spx")
        _sync()
        t2 = time.perf_counter()
        for k in keys:
            torch.as_tensor(batch[k]).to(dev)
        _sync()
        t3 = time.perf_counter()
        out["parent_ms"] = {"collate": (t1 - t0) * 1e3,
                            "to_card": (t3 - t2) * 1e3}

        model = get_model(cfg.model, cfg.num_model_classes,
                          cfg.output_stride, separable_conv=True, device=dev,
                          generator=torch.Generator().manual_seed(0))
        step = make_train_step(model, cfg, device=dev,
                               generator=torch.Generator(dev).manual_seed(0))

        def repeat():
            while True:
                yield batch

        out["step_alone"] = step_times(step, repeat(), args.steps)
        loader = DataProvider(dataset(), B, num_workers=args.workers)
        for _ in range(2 * len(ds) // B):  # warm every worker's cache
            next(loader)
        out["step_fed_by_loader"] = step_times(step, loader, args.steps)
        loader.close()
        shutdown_workers()
    for key in ("step_alone", "step_fed_by_loader"):
        for k, v in list(out[key].items()):
            out[key][k + "_median"] = float(np.median(v))
    line = json.dumps({"file_step_timing": out})
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
