"""Small sizes at which the CPU tests drive the benchmark's code: the
cells' own files with the crop, batch, superpixels and source images cut
so that a full-width model steps in seconds on the CPU."""

import json
import os

import torch

from benchmark import common

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load(kind, name):
    with open(os.path.join(ROOT, "benchmark", kind, f"{name}.json")) as f:
        return json.load(f)


def cut(cfg, mix):
    """A configuration and a traffic mix at the CPU size."""
    cfg.update(batch=2, crop=64, nseg=16)
    mix.update(source_hw=[64, 128], label_cells=[4, 4], source_images=4,
               items=8, selected_share=0.3, check_images=2, warm_images=1,
               profile_images=1, profile_steps=2, warm_steps=1)
    return cfg, mix


def cell(name):
    """(cell, cfg, mix, limits) of a workload, cut to a CPU size."""
    w = next(x for x in bench()["workloads"] if x["name"] == name)
    cfg, mix = cut(load("configs", w["config"]), load("traffic", w["traffic"]))
    return w, cfg, mix, load("limits", name)["limits"]


CPU = torch.device("cpu")


def pair(cfg, seed=3):
    """The port's model and the configuration's reference network on the
    CPU, both holding the weights made from the seed."""
    from mulactseg_tpu_torch.models.factory import get_model

    _, ref, w = common.reference_net(cfg, seed, CPU)
    port = get_model(cfg["model"], cfg["num_outputs"], cfg["output_stride"],
                     separable_conv=cfg["separable_conv"], device="cpu")
    common.load_weights(port, w)
    return port, ref
