"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the hand-written CUDA
   kernels of mulactseg_tpu_torch/csrc/ (one nvcc per source, in parallel)
   and prints the build time and each kernel's registers and spills.
2. Builds the Cityscapes stage-1 model at full width
   (deeplabv3pluswn_resnet50deepstem, separable convs, 20 outputs, output
   stride 16) and carries a seeded numpy init into it through
   models/convert.py; makes synthetic batches the way bench.py does
   (irregular superpixels, multi-hot 15%, selection 50%, uint8 images,
   batch 4, 768x768, nseg 2048).
3. Holds each kernel (K1-K4) against its plain PyTorch version on the card
   at those shapes, on logits from a forward pass of the model, and times
   both with CUDA events (windows of 5 back-to-back calls, the kernels as
   CUDA graph replays, median of 20 windows); K4 is also timed beside the
   library's softmax backward.
4. Drives the main path: make_train_step for 3 warm-up and 20 timed steps
   (4 windows of 5 steps, each timed to a synchronise at its end), with
   every launch counter set to 0 just before and read just after;
   each kernel must have launched exactly once per step, and the loss and
   its three parts must be finite.
5. Holds lossdecomp_fused on the card (the kernels) against the CPU (the
   plain versions) on a small input: loss, its parts and the logits
   gradient.
6. Profiles 3 more steps with torch.profiler: the device time per step
   by kind of kernel, the top kernels and the device's idle share.

Prints, before the last line, the slice's numbers and one JSON line with
each kernel's check and times; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises and exits non-zero; there is no CPU fallback.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

B, NUM_CLASSES, H, W, NSEG = 4, 20, 768, 768, 2048
WARMUP, TIMED, WINDOW = 3, 20, 5
TIMING_RUNS, REPEATS = 20, 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

KERNELS = {
    "pixel_ce_fwd": ("K1", "mulactseg_tpu_torch/csrc/pixel_loss.cu",
                     "mulactseg_tpu/ops/pixel_loss_pallas.py:257"),
    "pixel_ce_bwd": ("K2", "mulactseg_tpu_torch/csrc/pixel_loss.cu",
                     "mulactseg_tpu/ops/pixel_loss_pallas.py:292"),
    "ssm_fwd": ("K3", "mulactseg_tpu_torch/csrc/segment.cu",
                "mulactseg_tpu/ops/segment_pallas.py:560"),
    "ssm_bwd": ("K4", "mulactseg_tpu_torch/csrc/segment.cu",
                "mulactseg_tpu/ops/segment_pallas.py:641"),
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, graph=False):
    """Per-call device time of fn(): CUDA events around REPEATS back-to-back
    calls, divided by REPEATS; the median of TIMING_RUNS such windows,
    after one warm-up call. With graph=True the calls are replays of one
    captured call (a CUDA graph), which keeps the Python wrapper's host
    time off the device's clock; the plain versions, which synchronise on
    boolean indexing, run eagerly."""
    fn()
    torch.cuda.synchronize()
    run = fn
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        run = g.replay
    times = []
    for _ in range(TIMING_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPEATS):
            run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / REPEATS)
    return statistics.median(times)


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def make_batches(n, seed):
    """bench.py's synthetic stage-1 batches, as numpy arrays."""
    from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
    from mulactseg_tpu_torch.losses.fused import pixel_target_bits

    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        target = (rng.rand(B, NSEG, NUM_CLASSES) < 0.15).astype(np.float32)
        spx = np.stack([irregular_superpixels(H, W, NSEG, rng)
                        for _ in range(B)]).astype(np.int32)
        sel = rng.rand(B, NSEG) < 0.5
        spmask = np.take_along_axis(sel, spx.reshape(B, H * W),
                                    axis=1).reshape(B, H, W)
        bits = np.stack([pixel_target_bits(target[b], spx[b], spmask[b])
                         for b in range(B)])
        images = rng.randint(0, 256, (B, 3, H, W)).astype(np.uint8)
        out.append({"images": images, "target": target,
                    "target_bits": bits, "spx": spx})
    return out


def kernel_checks(logits, batch, dev):
    """K1-K4 against their plain versions at the main path's shapes.
    Returns one row per kernel: (name, max abs err, ms, plain ms,
    (bound ms, bound by), library ms or None)."""
    from mulactseg_tpu_torch.ops import pixel_loss, segment
    from mulactseg_tpu_torch.losses.fused import _popcount

    HW = H * W
    P = B * HW
    S = B * NSEG
    C = NUM_CLASSES
    temp = 0.1
    xc = logits.reshape(B, C, HW).contiguous()
    bits3 = torch.as_tensor(batch["target_bits"]).to(dev).reshape(
        B, 1, HW).contiguous()
    spx = torch.as_tensor(batch["spx"]).to(dev).reshape(P).long()
    target = torch.as_tensor(batch["target"]).to(dev)
    n_cand = _popcount(bits3.reshape(P).long() & ((1 << C) - 1))
    off = torch.arange(B, device=dev).repeat_interleave(HW) * NSEG
    sid3 = torch.where(n_cand > 1, spx + off, S).int().reshape(B, 1, HW)
    # bytes each kernel must move: its inputs once, its outputs once, and
    # the logits only of the pixels this data needs (a pixel without
    # candidates, or outside the group term, needs none of them)
    n_live = int((n_cand > 0).sum())
    n_valid = int((n_cand > 1).sum())
    row_bytes = C * 4
    rows = []

    # K1
    got = pixel_loss.pixel_ce_fwd(xc, bits3, temp)
    want = pixel_loss.pixel_ce_fwd_plain(xc, bits3, temp)
    torch.cuda.synchronize()
    check(torch.equal(got[1::2], want[1::2]),
          f"K1 counts differ: {got.tolist()} vs {want.tolist()}")
    check(torch.allclose(got[0::2], want[0::2], rtol=1e-5, atol=0),
          f"K1 sums differ: {got.tolist()} vs {want.tolist()}")
    rows.append(("pixel_ce_fwd", (got - want).abs().max().item(),
                 time_ms(lambda: pixel_loss.pixel_ce_fwd(xc, bits3, temp),
                         graph=True),
                 time_ms(lambda: pixel_loss.pixel_ce_fwd_plain(xc, bits3,
                                                               temp)),
                 bound(P * 4 + n_live * row_bytes + 16, 8 * n_live * C),
                 None))

    # K2, with the cotangents the loss gives (coeff / (1 + count))
    g = torch.stack([16.0 / (1.0 + want[1]), 8.0 / (1.0 + want[3])]
                    ).float().contiguous()
    got = pixel_loss.pixel_ce_bwd(xc, bits3, g, temp)
    want_dl = pixel_loss.pixel_ce_bwd_plain(xc, bits3, g, temp)
    torch.cuda.synchronize()
    err = (got - want_dl).abs().max().item()
    scale = want_dl.abs().max().item()
    check(scale > 0 and err <= 1e-6 * scale,
          f"K2 dl differs: max abs err {err} vs max |dl| {scale}")
    del got
    rows.append(("pixel_ce_bwd", err,
                 time_ms(lambda: pixel_loss.pixel_ce_bwd(xc, bits3, g, temp),
                         graph=True),
                 time_ms(lambda: pixel_loss.pixel_ce_bwd_plain(xc, bits3, g,
                                                               temp)),
                 bound(P * 4 + n_live * row_bytes + P * row_bytes + 8,
                       12 * n_live * C),
                 None))
    del want_dl

    # K3
    vals, pix = segment.ssm_fwd(xc, sid3, S, temp)
    pvals, ppix = segment.ssm_fwd_plain(xc, sid3, S, temp)
    torch.cuda.synchronize()
    absent, pabsent = pix == P, ppix == P
    check(torch.equal(absent, pabsent), "K3 absent sets differ")
    check(bool((vals[absent] == 0).all()), "K3 absent value is not 0.0")
    err = (vals - pvals).abs().max().item()
    check(err <= 1e-6, f"K3 max values differ by {err}")
    # the kernel's argmax pixel attains the plain max (ties may resolve to
    # another pixel only where probabilities agree within rounding)
    probs = segment._softmax(xc, temp)
    q = pix[~absent].long()
    cls = torch.arange(C, device=dev).expand(S, C)[~absent]
    at = probs[q // HW, cls, q % HW]
    tie_err = (at - pvals[~absent]).abs().max().item()
    check(tie_err <= 1e-6, f"K3 argmax pixel off the max by {tie_err}")
    # the argmax pixels lie in their segments
    check(bool((sid3.reshape(P)[q] == torch.arange(S, device=dev)[:, None]
                .expand(S, C)[~absent]).all()), "K3 argmax outside segment")
    rows.append(("ssm_fwd", err,
                 time_ms(lambda: segment.ssm_fwd(xc, sid3, S, temp),
                         graph=True),
                 time_ms(lambda: segment.ssm_fwd_plain(xc, sid3, S, temp)),
                 bound(P * 4 + n_valid * row_bytes + S * C * 8,
                       8 * n_valid * C),
                 None))

    # K4, with the group term's cotangent of the max values
    mx = vals.clone().requires_grad_(True)
    present = (pix[:, 0] < P).reshape(B, NSEG)
    entry = (target > 0.5) & present[:, :, None]
    gnll = -torch.log(mx.reshape(B, NSEG, C) + 1e-8)
    (torch.where(entry, gnll, 0.0).sum() / (1.0 + entry.sum())).backward()
    gv = mx.grad.contiguous()
    got = segment.ssm_bwd(xc, vals, pix, gv, temp)
    want_dl = segment.ssm_bwd_plain(xc, vals, pix, gv, temp)
    torch.cuda.synchronize()
    err = (got - want_dl).abs().max().item()
    scale = want_dl.abs().max().item()
    check(scale > 0 and err <= 1e-6 * scale,
          f"K4 dl differs: max abs err {err} vs max |dl| {scale}")
    # the library's softmax backward computes the same dl from the softmax
    # and the dense cotangent of the probabilities (g / T at each argmax)
    live = (pix < P) & (gv != 0)
    qa = pix[live].long()
    dense_g = torch.zeros(B, C, HW, device=dev)
    dense_g[qa // HW, torch.arange(C, device=dev).expand(S, C)[live],
            qa % HW] = gv[live] / temp
    lib = torch.ops.aten._softmax_backward_data(dense_g, probs, 1,
                                               torch.float32)
    lib_err = (lib - got).abs().max().item()
    check(lib_err <= 1e-6 * scale,
          f"K4 dl differs from the softmax backward by {lib_err}")
    del got, want_dl, lib
    n_live_pix = int(torch.unique(qa).numel())
    rows.append(("ssm_bwd", err,
                 time_ms(lambda: segment.ssm_bwd(xc, vals, pix, gv, temp),
                         graph=True),
                 time_ms(lambda: segment.ssm_bwd_plain(xc, vals, pix, gv,
                                                       temp)),
                 bound(P * row_bytes + 3 * S * C * 4 + n_live_pix * row_bytes,
                       12 * n_live_pix * C),
                 time_ms(lambda: torch.ops.aten._softmax_backward_data(
                     dense_g, probs, 1, torch.float32), graph=True)))
    del probs, dense_g
    return rows


def small_reference_check(dev):
    """lossdecomp_fused on the card against the CPU on one small input."""
    from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
    from mulactseg_tpu_torch.losses.fused import (
        lossdecomp_fused,
        pixel_target_bits,
    )

    rng = np.random.RandomState(5)
    b, c, h, w, nseg = 2, NUM_CLASSES, 96, 80, 24
    spx = np.stack([irregular_superpixels(h, w, nseg, rng)
                    for _ in range(b)]).astype(np.int32)
    target = (rng.rand(b, nseg, c) < 0.15).astype(np.float32)
    spmask = np.take_along_axis(rng.rand(b, nseg) < 0.6, spx.reshape(b, -1),
                                axis=1).reshape(b, h, w)
    bits = np.stack([pixel_target_bits(target[i], spx[i], spmask[i])
                     for i in range(b)])
    logits = (rng.randn(b, c, h, w) * 3).astype(np.float32)
    out = {}
    for d in ("cpu", dev):
        x = torch.from_numpy(logits).to(d).requires_grad_(True)
        total, aux = lossdecomp_fused(
            x, torch.from_numpy(bits).to(d), torch.from_numpy(target).to(d),
            torch.from_numpy(spx).to(d), nseg=nseg)
        total.backward()
        out[str(d)] = ({k: float(v.detach()) for k, v in aux.items()},
                       x.grad.cpu())
    (ref, gref), (got, ggot) = out["cpu"], out[str(dev)]
    for k in ref:
        check(math.isclose(ref[k], got[k], rel_tol=1e-5) and ref[k] > 0,
              f"small lossdecomp {k}: card {got[k]} vs cpu {ref[k]}")
    err = (ggot - gref).abs().max().item()
    check(err <= 1e-5 * gref.abs().max().item(),
          f"small lossdecomp gradient differs by {err}")


def profile_steps(step, batches, n=3, top=25):
    """torch.profiler over n train steps: device time by kernel name, the
    kernels' share by kind, and the device's idle share between the first
    kernel's start and the last one's end (one stream, so busy time is the
    union of kernel intervals)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(batches[i % len(batches)])
        torch.cuda.synchronize()
    # device-side spans of record_function ranges (the optimizer step's)
    # enclose kernels already counted: leave them out
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.time_range.end > e.time_range.start)
    check(spans, "the profiler saw no device activity")
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    by_name = {}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    kinds = {"loss kernels (K1-K4)": ("pixel_ce", "ssm_"),
             "convolutions and matmuls": ("conv", "gemm", "xmma", "cutlass",
                                          "cudnn", "wgrad", "dgrad", "sm90"),
             "optimizer": ("multi_tensor", "adam", "Adam"),
             "reductions": ("reduce",),
             "elementwise and copies": ("elementwise", "copy", "Memcpy",
                                        "Memset", "fill")}
    by_kind = {}
    for name, t in by_name.items():
        kind = next((k for k, keys in kinds.items()
                     if any(key in name for key in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + t
    print(json.dumps({"profile": {
        "steps": n, "device_spans_per_step": len(spans) / n,
        "window_ms_per_step": window / n / 1e3,
        "device_busy_ms_per_step": busy / n / 1e3,
        "idle_share": 1.0 - busy / window,
        "kind_ms_per_step": {k: v / n / 1e3 for k, v in sorted(
            by_kind.items(), key=lambda kv: -kv[1])}}}))
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {t / n / 1e3:9.3f} ms/step  {name[:110]}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available()"
                 " is False")
    import mulactseg_tpu_torch

    check(Path(mulactseg_tpu_torch.__file__).resolve().parents[1] == HERE,
          "mulactseg_tpu_torch must come from this checkout")
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.engine.train import make_train_step
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.models.factory import get_model
    from mulactseg_tpu_torch.ops import _build

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    reports = _build.build_all(["pixel_loss", "segment"])
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s (parallel nvcc, sm_90a)", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    cfg = Config(num_classes=NUM_CLASSES - 1, nseg=NSEG, crop_size=(H, W),
                 train_batch_size=B, dtype="bfloat16", separable_conv=True,
                 method="active_joint_multi_predignore_lossdecomp")
    t0 = time.perf_counter()
    model = get_model(cfg.model, cfg.num_model_classes, cfg.output_stride,
                      separable_conv=cfg.separable_conv, device=dev)
    convert.load_variables(model, convert.random_variables(model, seed=0))
    batches = make_batches(2, seed=0)
    print(f"model {cfg.model} ({sum(p.numel() for p in model.parameters())}"
          f" params) and batches: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # realistic logits (upsampled cosine logits, with their near-ties) for
    # the kernel checks
    from mulactseg_tpu_torch.engine.train import _device_normalize

    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        logits = model(_device_normalize(
            torch.as_tensor(batches[0]["images"]).to(dev)))
    check(logits.shape == (B, NUM_CLASSES, H, W)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), "bad model logits")
    rows = kernel_checks(logits, batches[0], dev)
    del logits
    torch.cuda.synchronize()

    step = make_train_step(model, cfg, device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    for i in range(WARMUP):
        aux = step(batches[i % len(batches)])
    torch.cuda.synchronize()
    window_s = []
    for _ in range(TIMED // WINDOW):
        ts = time.perf_counter()
        for i in range(WINDOW):
            aux = step(batches[i % len(batches)])
        torch.cuda.synchronize()
        window_s.append(time.perf_counter() - ts)
    dt = sum(window_s)
    launches = dict(_build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = WARMUP + TIMED
    for name in KERNELS:
        check(launches.get(name, 0) == steps,
              f"{name} launched {launches.get(name, 0)} times in {steps} "
              "steps")
    losses = {k: float(v) for k, v in aux.items()}
    check(all(math.isfinite(v) for v in losses.values()),
          f"non-finite loss {losses}")

    small_reference_check(dev)
    profile_steps(step, batches)

    print(json.dumps({
        "slice": "cityscapes stage-1 train step", "card": smi,
        "img_per_s": B * TIMED / dt, "step_ms": dt / TIMED * 1e3,
        "window_step_ms": [t / WINDOW * 1e3 for t in window_s],
        "timed_steps": TIMED,
        "steps": steps, "peak_mem_gib": peak_gib,
        "ce_loss": losses["ce_loss"], "mc_loss": losses["mc_loss"],
        "group_loss": losses["group_loss"],
        "train_loss": losses["train_loss"]}))
    kernels = []
    for name, err, ms, plain_ms, (bound_ms, bound_by), lib_ms in rows:
        tag, source, replaces = KERNELS[name]
        kernels.append({
            "name": f"{tag} {name}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "max_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms})
    print(smi)
    print(json.dumps({"kernels": kernels, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
