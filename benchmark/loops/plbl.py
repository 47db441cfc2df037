"""The pseudo-labelling loop: the round's `PseudoLabelGenerator(model,
cfg, plbl_type).generate(...)` (`plbl/generator.py`) over single
full-resolution images, writing one PNG map an image under a directory of
TMPDIR, as the recipe's eval_al stage-2 command does.

The window's loader stops yielding at the deadline; the rate counts the
images whose maps were written, over the time to the end of the last one.
After the window the program's state is freed and the plain reference
recomputes the maps of a sample of the window's images, drawn from the
seed with one image of each source, from the same weights and inputs. The
number compared is the share of labelled pixels on which the maps differ,
pooled over the sample.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from benchmark import common, gen, yardstick
from benchmark.reference import plbl as ref_plbl

SPANS = ("plbl.forward", "plbl.softmax", "plbl.k5", "plbl.pass1",
         "plbl.threshold", "plbl.pass2", "plbl.fetch", "plbl.save")


def port_config(cfg: Dict, seed: int):
    from mulactseg_tpu_torch.config import Config

    p = cfg["plbl"]
    return Config(model=cfg["model"], num_classes=cfg["num_classes"],
                  output_stride=cfg["output_stride"],
                  separable_conv=cfg["separable_conv"],
                  dataset=cfg["dataset"], nseg=cfg["nseg"],
                  method=p["method"], dtype=cfg["dtype"], stage2=True,
                  cosprop_threshold_method=p["threshold"],
                  seed=seed % (2 ** 31))


class Feed:
    """Single-image batches, cycling over the sources, each under its own
    name; stops at the deadline (or after `limit` images)."""

    def __init__(self, sources: List, deadline: float = float("inf"),
                 limit: int = 1 << 30, first: int = 0):
        self.sources, self.deadline, self.limit = sources, deadline, limit
        self.first = first
        self.names: List[str] = []

    def batch(self, k: int) -> Dict:
        src = self.sources[k % len(self.sources)]
        spmask = np.isin(src.spx, src.selected)
        return {"images": src.norm[None], "labels": src.gt[None],
                "target": src.target[None], "spx": src.spx[None],
                "spmask": spmask[None],
                "fnames": [[f"img_{k}", f"lbl_{k:06d}.png",
                            f"spx_{k % len(self.sources)}"]]}

    def __iter__(self):
        k = self.first
        while time.perf_counter() < self.deadline and \
                k - self.first < self.limit:
            self.names.append(f"lbl_{k:06d}")
            yield self.batch(k)
            k += 1


def read_png_gray8(path: str) -> np.ndarray:
    """An 8-bit greyscale PNG as (H, W) uint8, read by Pillow."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode != "L":
            raise ValueError(f"{path}: mode {im.mode}, not 8-bit greyscale")
        return np.asarray(im, dtype=np.uint8).copy()


def reference_map(net, src, cfg, dev) -> np.ndarray:
    x = torch.as_tensor(src.norm[None]).to(dev)
    with torch.no_grad():
        feat, logits = net(x, return_feat=True)
        probs = torch.softmax(logits[0], dim=0)
        out = ref_plbl.pseudo_labels(feat[0], probs, src.spx, src.selected,
                                     src.target, cfg["plbl"]["max_protos"])
    return out.cpu().numpy()


def reference_maps(cfg, seed, dev, sources, fp8=False) -> List[np.ndarray]:
    """The reference's (or, with fp8, the control's) maps of `sources`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref, net, _ = common.reference_net(cfg, seed, dev)
    net.eval()
    ref.Quant.fp8 = fp8
    try:
        return [reference_map(net, s, cfg, dev) for s in sources]
    finally:
        ref.Quant.fp8 = False


def map_counts(got: np.ndarray, want: np.ndarray) -> List[int]:
    """[pixels on which the two maps differ, pixels that either labels],
    over the pixels that either map labels."""
    labelled = (got != 255) | (want != 255)
    return [int((got != want)[labelled].sum()), int(labelled.sum())]


def pooled_gap(counts: List[List[int]]) -> float:
    """The share of labelled pixels that differ, over all the maps."""
    return sum(c[0] for c in counts) / max(sum(c[1] for c in counts), 1)


def sample(rng, n: int, n_sources: int, k: int) -> List[int]:
    """Up to k of the window's n images, drawn from rng, no two of one
    source (image j is source j % n_sources)."""
    pick, seen = [], set()
    for j in rng.permutation(n).tolist():
        if j % n_sources not in seen:
            seen.add(j % n_sources)
            pick.append(j)
            if len(pick) == k:
                break
    return sorted(pick)


def make_sources(seed, cfg, mix):
    """The source images, each with its normalised pixels."""
    sources = gen.make_items(seed, cfg, mix)
    for s in sources:
        s.norm = gen.normalize(s.image)
    return sources


def run(cell: Dict, cfg: Dict, mix: Dict, limits: Dict, seed: int,
        seconds: float, trace: bool, dev, t0: float) -> Dict:
    from mulactseg_tpu_torch.models.factory import get_model
    from mulactseg_tpu_torch.ops import _build
    from mulactseg_tpu_torch.plbl.generator import PseudoLabelGenerator

    phases = common.Phases(t0)
    phases("imports")
    with ThreadPoolExecutor(max_workers=1) as pool:
        sources = pool.submit(make_sources, seed, cfg, mix)
        pcfg = port_config(cfg, seed)
        if pcfg.num_model_classes != cfg["num_outputs"]:
            raise ValueError(f"{pcfg.method} builds "
                             f"{pcfg.num_model_classes} outputs, the "
                             f"configuration states {cfg['num_outputs']}")
        model = get_model(cfg["model"], cfg["num_outputs"],
                          cfg["output_stride"],
                          separable_conv=cfg["separable_conv"], device=dev)
        common.load_weights(model, common.make_weights(cfg, seed, dev))
        model.eval()
        gen_ = PseudoLabelGenerator(model, pcfg, cfg["plbl"]["type"],
                                    max_protos=cfg["plbl"]["max_protos"],
                                    device=dev)
        phases("model")
        sources = sources.result()
        phases("items")
    suppix = {f"spx_{i}": s.selected.tolist() for i, s in enumerate(sources)}
    out = tempfile.mkdtemp(prefix="plbl-")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    try:
        warm = Feed(sources, limit=mix["warm_images"], first=1 << 20)
        gen_.generate(None, warm, save_dir=os.path.join(out, "warm"),
                      suppix=suppix)
        sync()
        phases("warm-up")
        setup_peak = 0
        if dev.type == "cuda":
            setup_peak = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - t0
        start = time.perf_counter()
        feed = Feed(sources, deadline=start + seconds)
        gen_.generate(None, feed, save_dir=out, suppix=suppix)
        sync()
        elapsed = time.perf_counter() - start
        n = len(feed.names)
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else 0)
        ctx = {"window_s": elapsed, "images": n, "peak_window_bytes": peak}
        breakdown = None
        if trace:
            ctx.update(profile(gen_, sources, suppix, out, cfg, mix, dev,
                               _build))
            breakdown = ctx.pop("breakdown")
        del gen_, model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        paths = [os.path.join(out, f"{name}.png") for name in feed.names]
        failed = sum(not os.path.exists(p) for p in paths)
        pick = sample(gen.rng_of(seed, 4), n, len(sources),
                      mix["check_images"])
        got = [read_png_gray8(paths[k]) for k in pick]
        phases("maps read")
        want = reference_maps(cfg, seed, dev,
                              [sources[k % len(sources)] for k in pick])
    finally:
        shutil.rmtree(out, ignore_errors=True)
    values = {"plbl_pooled_gap": pooled_gap(
        [map_counts(g, w) for g, w in zip(got, want)])}
    phases("reference")
    return {"setup_s": setup_s, "attempted": n, "failed": failed,
            "rate": n / elapsed, "ctx": ctx, "values": values,
            "peak_bytes": max(peak, setup_peak), "breakdown": breakdown}


def profile(gen_, sources, suppix, out, cfg, mix, dev, _build) -> Dict:
    """torch.profiler (CPU and CUDA) over a few images: the program's plbl
    spans, the kernels' spans and K5's launches and bound."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    feed = Feed(sources, limit=mix["profile_images"], first=1 << 21)
    before = _build.LAUNCHES.get("seg_max_fwd", 0)
    with tprofile(activities=acts) as prof:
        t = time.perf_counter()
        gen_.generate(None, feed, save_dir=os.path.join(out, "prof"),
                      suppix=suppix)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window = time.perf_counter() - t
    red = common.reduce_profile(prof, SPANS)
    k5 = 0.0
    for k in range(feed.first, feed.first + len(feed.names)):
        s = sources[k % len(sources)]
        P = s.spx.size
        n_valid = int(np.isin(s.spx, s.selected).sum())
        k5 += yardstick.k5_bound(n_valid, P, cfg["nseg"], cfg["num_outputs"])
    return {"prof_spans": red["spans"], "prof_busy_s": red["busy_s"],
            "prof_window_s": window, "prof_images": len(feed.names),
            "ranges": red["ranges"],
            "launches": {"seg_max_fwd": _build.LAUNCHES.get("seg_max_fwd", 0)
                         - before},
            "k5_bound_s": k5, "breakdown": common.breakdown(red)}
