"""The training loop: the port's train step (`engine/train.py`
`make_train_step`, AdamW and the poly schedule of `engine/state.py`) fed by
its `data/loader.DataProvider` on threads, the loop that
`engine/rounds.ALTrainer.train` runs, without validation.

Set-up builds one step object with its model and optimizer, drives it
through its first `check_steps` steps (the window's own call and feed, on
rows that all differ), keeps what the check reads (each step's loss, the
first gradient from AdamW's first moment, each leaf's change after those
steps), warms up, and hands the same object to the window. After the
window and the reading of the memory peak, the program's state is freed
and the plain reference follows the same first steps, on batches that the
benchmark collates from its own item pool: each row that the program's
loader gave is found in the pool by its content, every field compared
whole, so that a loader fault cannot reach both sides.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from benchmark import common, gen, reference, yardstick
from benchmark.reference import train as ref_train

ADAM_B1 = 0.9
SETTINGS = ("train_lr", "cls_lr_scale", "weight_decay", "power", "min_lr",
            "finetune_itrs", "coeff", "coeff_mc", "coeff_gm",
            "multi_ce_temp", "group_ce_temp", "ce_temp")


def port_config(cfg: Dict, stage: Dict, seed: int):
    from mulactseg_tpu_torch.config import Config

    keys = {k: stage[k] for k in SETTINGS if k in stage}
    return Config(model=cfg["model"], num_classes=cfg["num_classes"],
                  output_stride=cfg["output_stride"],
                  separable_conv=cfg["separable_conv"],
                  dataset=cfg["dataset"], nseg=cfg["nseg"],
                  method=stage["method"], optimizer=stage["optimizer"],
                  scheduler=stage["scheduler"], dtype=cfg["dtype"],
                  train_batch_size=cfg["batch"],
                  crop_size=(cfg["crop"], cfg["crop"]),
                  seed=seed % (2 ** 31), **keys)


def build(cfg: Dict, mix: Dict, seed: int, dev, weights):
    """The program's model and step for this cell."""
    from mulactseg_tpu_torch.engine.train import make_train_step
    from mulactseg_tpu_torch.models.factory import get_model

    stage = cfg[mix["stage"]]
    pcfg = port_config(cfg, stage, seed)
    if pcfg.num_model_classes != cfg["num_outputs"]:
        raise ValueError(f"{stage['method']} builds "
                         f"{pcfg.num_model_classes} outputs, the "
                         f"configuration states {cfg['num_outputs']}")
    model = get_model(cfg["model"], cfg["num_outputs"], cfg["output_stride"],
                      separable_conv=cfg["separable_conv"], device=dev)
    common.load_weights(model, weights)
    drop = torch.Generator(device=dev).manual_seed(common.seed_of(seed, 2))
    step = make_train_step(model, pcfg, device=dev, generator=drop)
    return model, step, pcfg


def loader_of(items, cfg, mix, seed):
    from mulactseg_tpu_torch.data.loader import DataProvider

    return DataProvider(items, cfg["batch"], shuffle=True,
                        drop_last=True, infinite=True,
                        num_workers=mix["loader_threads"],
                        seed=common.seed_of(seed, 3) % (2 ** 32),
                        processes=False)


def leaf_norms(tensors) -> List[float]:
    return torch.stack(torch._foreach_norm(list(tensors))).tolist()


def first_steps(model, step, loader, n: int):
    """The first n steps through the window's call and feed. Returns the
    batches, each step's loss, each leaf's first gradient norm and the
    signs of its elements (from AdamW's first moment after one step, int8
    on the host) and each leaf's change norm after n steps."""
    names = [k for k, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    batches, losses = [], []
    for k in range(n):
        batch = next(loader)
        batches.append(batch)
        aux = step(batch)
        losses.append(float(aux["train_loss"]))
        if k == 0:  # no moment: the optimizer saw no gradient
            st = step.optimizer.state
            first = [st[p]["exp_avg"] / (1.0 - ADAM_B1) if "exp_avg" in st[p]
                     else torch.zeros_like(p) for p in params]
            grads = leaf_norms(first)
            signs = grad_signs(first).cpu()
            del first
    change = leaf_norms(p.detach() - s for p, s in zip(params, start))
    del start
    return (batches, losses, dict(zip(names, grads)),
            dict(zip(names, change)), signs)


def grad_signs(grads) -> torch.Tensor:
    """Every element's sign (-1, 0, 1) of the leaves, in one int8 vector."""
    return torch.cat([g.detach().sign().to(torch.int8).reshape(-1)
                      for g in grads])


def row_key(row: Dict) -> bytes:
    """A cheap key of a row: a sparse sample of its image and ids."""
    return (np.asarray(row["images"])[:, ::61, ::59].tobytes()
            + np.asarray(row["spx"])[::61, ::59].tobytes())


def same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def pool_batches(batches: List[Dict], items: List[Dict]):
    """The reference's batches, stacked from the benchmark's item pool. Each
    row of the program's batches is looked up in the pool, every field
    compared whole (dtype, shape, values); the rows of the first steps must
    all differ. Returns the batches and the count of rows that are not a
    pool item or repeat one (a row not found keeps the program's, and the
    count fails the run)."""
    index: Dict[bytes, List[int]] = {}
    for i, it in enumerate(items):
        index.setdefault(row_key(it), []).append(i)
    keys = list(items[0])
    out, bad, seen = [], 0, set()
    for b in batches:
        rows = []
        for r in range(len(b["images"])):
            got = {k: b[k][r] if k in b else None for k in keys}
            hit = next((i for i in index.get(row_key(got), [])
                        if all(same(got[k], items[i][k]) for k in keys)),
                       None)
            if hit is None or hit in seen:
                bad += 1
                rows.append(got)
            else:
                seen.add(hit)
                rows.append(items[hit])
        out.append({k: np.stack([np.asarray(x[k]) for x in rows])
                    for k in keys})
    return out, bad


def reference_numbers(cfg, mix, seed, dev, batches, fp8=False,
                      phases=None):
    """The plain reference (or, with fp8, the control) over the same first
    steps: losses, first-gradient norms, change norms."""
    phases = phases or (lambda name: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref, net, weights = common.reference_net(cfg, seed, dev)
    drop = torch.Generator(device=dev).manual_seed(common.seed_of(seed, 2))
    for d in ref.dropouts(net):
        d.generator = drop
    phases("reference network")
    ref.Quant.fp8 = fp8
    try:
        losses, grads, first = ref_train.run_steps(
            net, batches, cfg[mix["stage"]], mix["stage"], dev)
    finally:
        ref.Quant.fp8 = False
    names = [k for k, _ in net.named_parameters()]
    change = leaf_norms(p.detach() - weights[k]
                        for k, p in net.named_parameters())
    signs = grad_signs(first)
    mags = torch.cat([g.abs().reshape(-1) for g in first])
    del net, weights, first
    return losses, grads, dict(zip(names, change)), (signs, mags)


def compare(prog, ref, bad_rows: int = 0) -> Dict[str, float]:
    """The numbers: the rows of the first steps' batches that are not items
    of the pool (`pool_batches`); the relative gap of the first step's loss and the
    largest of the later steps'; the gap of the first gradient's norm by
    the worst and by the median leaf, and of the change's norm by the worst
    leaf; the share of the first gradient's elements whose sign differs,
    and their share of its mass (the reference's absolute values). A
    cell's limits file names the numbers that decide `correct`. Leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out (they move by round-off alone)."""
    p_loss, p_grad, p_change, p_sign = prog
    r_loss, r_grad, r_change, (r_sign, r_mag) = ref
    if isinstance(p_sign, tuple):  # the control, a reference run
        p_sign = p_sign[0]
    wrong = p_sign.to(r_sign.device) != r_sign
    med = float(np.median(list(r_grad.values())))
    keep = [n for n, g in r_grad.items() if g >= 1e-3 * med]
    gaps = [common.rel_gap(a, b) for a, b in zip(p_loss, r_loss)]
    return {
        "rows_not_in_pool": float(bad_rows),
        "loss1_gap": gaps[0],
        "loss_later_gap": max(gaps[1:], default=0.0),
        "grad_gap": common.leaf_gap(p_grad, r_grad, keep),
        "grad_gap_median": common.leaf_gap(p_grad, r_grad, keep, np.median),
        "change_gap": common.leaf_gap(p_change, r_change, keep),
        "grad_sign_gap": float(wrong.float().mean()),
        "grad_sign_mass": float((r_mag * wrong).sum() / r_mag.sum()),
        "left_out": len(r_grad) - len(keep),
    }


def run(cell: Dict, cfg: Dict, mix: Dict, limits: Dict, seed: int,
        seconds: float, trace: bool, dev, t0: float) -> Dict:
    from mulactseg_tpu_torch.ops import _build

    phases = common.Phases(t0)
    phases("imports")
    with ThreadPoolExecutor(max_workers=1) as pool:
        items = pool.submit(gen.make_items, seed, cfg, mix)
        weights = common.make_weights(cfg, seed, dev)
        model, step, _ = build(cfg, mix, seed, dev, weights)
        del weights
        phases("model")
        items = items.result()
        phases("items")
    loader = loader_of(items, cfg, mix, seed)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    batches, *prog = first_steps(model, step, loader, mix["check_steps"])
    phases("first steps")
    for _ in range(mix["warm_steps"]):
        step(next(loader))
    sync()
    phases("warm-up")
    setup_peak = 0
    if dev.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t0

    # the window: steps until the deadline, then one synchronize
    losses, events, waits = [], [], []
    timing = trace and dev.type == "cuda"
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        if trace:
            w = time.perf_counter()
            batch = next(loader)
            waits.append(time.perf_counter() - w)
        else:
            batch = next(loader)
        losses.append(step(batch)["train_loss"])
        if timing:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
    sync()
    elapsed = time.perf_counter() - start
    n = len(losses)
    ctx = {"window_s": elapsed, "steps": n, "batch": cfg["batch"],
           "loader_wait_s": waits}
    if timing:
        ctx["step_ms"] = [events[i - 1].elapsed_time(events[i])
                          for i in range(1, n)]
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    ctx["peak_window_bytes"] = peak
    failed = int((~torch.isfinite(torch.stack(losses))).sum())

    breakdown = None
    if trace:
        ctx["flops_per_step"] = step_flops(cfg)
        prof_batches = [next(loader) for _ in range(mix["profile_steps"])]
        ctx.update(profile(step, prof_batches, cfg, mix, dev, _build))
        breakdown = ctx.pop("breakdown")
    loader.close()
    del model, step, loader
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    phases("program freed")
    batches, bad = pool_batches(batches, items)
    del items
    ref = reference_numbers(cfg, mix, seed, dev, batches, phases=phases)
    values = compare(prog, ref, bad)
    phases("reference steps")
    return {"setup_s": setup_s, "attempted": n, "failed": failed,
            "rate": n * cfg["batch"] / elapsed, "ctx": ctx,
            "values": values, "peak_bytes": max(peak, setup_peak),
            "breakdown": breakdown}


def step_flops(cfg: Dict) -> float:
    """Model FLOPs of one training step, forward and backward, counted on
    the configuration's reference network at the cell's shapes (meta
    tensors, no work)."""
    with torch.device("meta"):
        net = reference.of(cfg).Net(cfg)
        x = torch.empty(cfg["batch"], 3, cfg["crop"], cfg["crop"])
        return flops_of(net, x)


def flops_of(net, x) -> float:
    """FLOPs of net(x) and its backward pass, by torch's counter with the
    yardstick's formula for a convolution's backward pass."""
    from torch.utils.flop_counter import FlopCounterMode

    fix = {torch.ops.aten.convolution_backward: yardstick.conv_backward_flops}
    with FlopCounterMode(display=False, custom_mapping=fix) as fc:
        net(x).sum().backward()
    return float(fc.get_total_flops())


def profile(step, batches, cfg, mix, dev, _build) -> Dict:
    """torch.profiler (CPU and CUDA) over a short steady stretch; the
    kernels' spans, the loss kernels' launches and their bounds on these
    batches."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    before = dict(_build.LAUNCHES)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tprofile(activities=acts) as prof:
        t = time.perf_counter()
        for b in batches:
            step(b)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window = time.perf_counter() - t
    red = common.reduce_profile(prof)
    launches = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                if v - before.get(k, 0)}
    bounds: Dict[str, float] = {}
    if mix["stage"] == "stage1":
        C = cfg["num_outputs"]
        for b in batches:
            for k, v in yardstick.loss_kernel_bounds(
                    np.asarray(b["target_bits"]), np.asarray(b["spx"]),
                    np.asarray(b["target"]), C).items():
                bounds[k] = bounds.get(k, 0.0) + v
    return {"prof_spans": red["spans"], "prof_busy_s": red["busy_s"],
            "prof_window_s": window, "prof_steps": len(batches),
            "launches": launches, "loss_bounds": bounds,
            "breakdown": common.breakdown(red)}
