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
   batch 4, 768x768), at nseg 2048 and at nseg 4096.
3. Holds each kernel (K1-K4) against its plain PyTorch version on the card
   at those shapes (nseg 2048), on logits from a forward pass of the model,
   and times both with CUDA events (windows of 5 back-to-back calls, the
   kernels as CUDA graph replays, median of 20 windows); K4 is also timed
   beside the library's softmax backward. K1 must give the same bits on a
   second call, and K1 and K2 are also held and timed on their 4-byte
   path (the logits one float into a larger storage, so not 16-byte
   aligned). K3 is held as well on
   adversarial ids at full size (one id per run of 4 pixels, ids equal
   modulo its shared slot count, more segments in a span than slots).
   Before K4 runs, every live argmax pixel must lie in its own segment
   (K4's precondition).
4. The same for the kernels past the reference's K3 guard
   (num_segments + 1 > 9216, mulactseg_tpu/ops/segment.py:653-654): K6
   with the nseg-4096 batch (S = 16,384), also on its 4-byte path (the
   logits one float into a larger storage; bitwise the same), K5 on K6's
   planes under the retired ids (bitwise, timed: the K5 of the nseg-4096
   step), and K4 on the pre-reduced term's outputs (precondition first);
   then, on the logits as
   (2,359,296, 20) rows, K7 and K8 (the row-major group term, rows divided
   by T) and K9 and K10 (the row-major pixel loss). K7 is held against
   its plain version (absent sets exact, maxima within 1e-6, argmax rows
   at the plain maximum within 1e-6: the plain version sums the softmax
   with torch's sum, the kernel in class order), and bitwise against the
   segment max of the softmax summed in class order (class_order_softmax,
   a reference of this script); K10, whose exp2 and reciprocal differ
   from the plain version's exp and divisions, within 1e-6 of max |dl|.
   Both are also held and timed on their 4-byte
   instances (the rows one float into a larger storage), which must give
   the 16-byte instances' bits. K6 and K8 write
   bf16-rounded values: bf16-exact, within one bf16 ulp of the plain
   version's and equal for > 99.9% of them, and a choice that differs
   from the plain version's must reach the block max within 1e-6. Behind
   each, K5 on the card's planes is held bitwise against its plain
   version, the op's output must be exactly K5's winners mapped back to
   pixels, and against the all-plain chain its maxima lie within one bf16
   ulp and its argmax pixels are equal or near-ties.
5. Drives the main path: make_train_step at nseg 2048 for 3 warm-up and 20
   timed steps (4 windows of 5 steps, each timed to a synchronise at its
   end), with every launch counter set to 0 just before and read just
   after; K1-K4 must have launched exactly once per step, and the loss and
   its three parts must be finite.
6. The same at nseg 4096 from the seeded weights again: 2 warm-up and 10
   timed steps; K1, K2, K6, K5 and K4 once per step, K3 never.
7. One autograd pass through each row-major op on those rows, counted:
   segment_softmax_max launches K7, with prereduce=True K8 and K5, and
   pixel_partial_ce K9 and K10, once each; each loss equals its plain
   versions' (rtol 1e-5).
8. Holds lossdecomp_fused on the card (the kernels) against the CPU (the
   plain versions) on small inputs, loss, its parts and the logits
   gradient: at 96x80, nseg 24 (K3), and at 192x192, nseg 4608 (S + 1 =
   9217, so K6 and K5; about 8 pixels per segment). Every gradient entry
   must lie within 1e-5 of the largest, except in a segment holding a K6
   value that rounds to bf16 the other way on the card.
8a. The active-learning main path, from a file of the seeded weights
   named like the recipe's ImageNet init (so the final classifier is
   stripped): run_al_rounds for 2 rounds on a SyntheticRegionDataset at
   768x768, nseg 2048, 19 classes (pool and label sets of AL_POOL images,
   val and eval sets of AL_VAL), my_random then
   my_bvsb_predclsbal_pwr_banignore with a budget of AL_BUDGET clicks,
   AL_ITRS stage-1 steps a round with the val_period gate firing twice
   (best-val checkpoints, the best one reloaded before eval); then the
   recipe's cosprop_includeonehot pseudo-labelling of the label set with
   round 2's best checkpoint (every PNG decoded and compared), and stage 2:
   AL_ITRS CE steps (active_predignore) on RegionDatasetPlbl over the
   images written as RGB PNGs and those PNGs (its items built in the
   loader's worker processes, started before the clock), from the
   classifier-stripped init file, then eval. Every launch counter is set to 0 just before the
   rounds and read just after, and again around the pseudo-labelling and
   stage 2: K1-K4 once per stage-1 step, K5 once per pseudo-labelled
   image, no kernel in selection or stage 2. Outside those windows K5 is
   held bitwise against its plain version (values and argmax pixels) on
   one label-set image's softmax planes and ids at 768x768, built as the
   generator builds them. The datalists, selections
   and checkpoints must exist, round 2 must select its budget, a
   checkpoint loaded back must be bitwise what was saved, and the losses
   must be finite. Then the paper's selector on the card against the CPU
   on two 96x80 images in float32 with the same weights: scores within
   1e-4, the same selected regions.
8b. The recipe's three commands over files (cli_recipe): a Cityscapes-
   format tree written by tools/cityscapes_tree.py (CLI_TRAIN training
   and CLI_VAL validation images at 1024x2048, adaptive-filtered RGB PNGs,
   8-bit label ids, .pkl superpixels at nseg 2048, the multi-hot tensors
   of tools/label_assignment with the 5x5 trim, the datalists and region
   dict of tools/gen_datalists), the seeded weights saved as the recipe's
   ImageNet init file, and the command lines of
   mulactseg_tpu_torch/scripts/train_city_mul_res50.sh (recorded by a stub
   `python`, so with the script's flags), cut to --finetune_itrs CLI_ITRS,
   --val_period CLI_VAL_PERIOD, --max_iterations CLI_ROUNDS and
   --active_selection_size at the recipe's 100,000 clicks for 2,975
   images, run in order through train_al.main, then eval_al.main and
   train_stage2.main for each of the CLI_ROUNDS rounds, on the card.
   Every launch counter is set to 0 just before each command and read
   just after: train_al launches K1-K4 once per stage-1 step, eval_al K5
   once per labelled image, stage 2 nothing; one pseudo-label PNG per
   labelled image, each decoding to a 1024x2048 map; finite losses and
   mIoUs, every checkpoint written. Then the loader alone over fresh
   copies of the training files, on worker processes and on threads, and
   one item's time by part. Its line: per-command seconds, per round
   train img/s (whole, first epoch with cold decode caches, the rest
   warm, validations taken out), plbl img/s, stage-2 img/s and mIoU,
   loader files/s, item ms by part, launches, peak GiB.
8c. The VOC recipe's commands over files (voc_recipe): a VOC-format tree
   written by tools/voc_tree.py (VOC_TRAIN training and VOC_VAL validation
   images at VOC's sizes, 375x500 to 500x500: baseline 4:2:0 JPEGs,
   palette label PNGs, .pkl superpixels at nseg 150, the 5x5-trimmed
   multi-hot tensors), a seeded 21-class model saved as the recipe's
   ImageNet init file, and the command lines of
   mulactseg_tpu_torch/scripts/train_voc_mul_res50.sh. First K1-K4 at the
   VOC stage-1 instance, held and timed as in item 3: logits (12, 21,
   513 * 513) of the seeded model on a stage-1 batch of the tree's files
   (C = 21 takes the kernels' run-time-C instance, the odd HW their 4-byte
   path), nseg 150 (S = 1,812: K3). Then the commands, cut to
   --finetune_itrs VOC_ITRS, --val_period VOC_VAL_PERIOD, --max_iterations
   VOC_ROUNDS and --active_selection_size at the recipe's 10,000 clicks
   for 1,464 images in stage 1 and VOC_S2_ITRS steps in stage 2, run as in
   item 8b: train_al launches K1-K4 once per stage-1 step, each eval_al
   (10-view TTA pseudo-labels) K5 once per labelled image, stage 2
   nothing; one pseudo-label PNG per labelled image, each the size of its
   JPEG. Then K5 held bitwise and timed on one pseudo-labelling image's
   TTA softmax planes (last round's checkpoint, its selected
   superpixels), and JPEG decoding timed a file at a time. Its line:
   per-command seconds, per round train img/s (whole, first epoch, the
   rest), plbl img/s and mIoU, stage-2 img/s and mIoU, JPEG decode ms per
   file, launches, peak GiB.
9. Reloads the seeded weights and, at full resolution (1x3x1024x2048,
   nseg 2048), holds K5 against its plain version, bitwise, on the
   softmax planes of an eval forward with ~30% of superpixels selected,
   and on signed values rounded to 1/8 (negative values and ties); times
   both.
10. Evaluation: Evaluator.run with predignore on 4 synthetic 1024x2048
   uint8 images (img/s, finite mIoU).
11. Pseudo-labelling, the recipe's cosprop_includeonehot step with
   cfg.dtype bfloat16 (so bf16 features and similarities):
   PseudoLabelGenerator.generate on tools_dev/bench_round.py's fixture
   (two base superpixel maps, 30% selected, 1-3 classes per superpixel),
   1 warm-up image and 8 timed ones, with every launch counter set to 0
   just before the 8 and read just after (K5 once per image, no other
   kernel); each PNG must decode to the map the generator computes. Then
   a profiled pass over the same 8 gives ms per image for each part and
   the device's idle share.
12. cosine_prototype_plbl on the card against the CPU at 96x80, nseg 24,
   sim_bf16 off: K5's outputs equal, the maps agree on >= 99.5% of pixels
   (the matmuls sum in another order, so near-ties may flip).
13. Profiles 1 + 3 stage-1 steps at each nseg with torch.profiler: the
   device time per step by kind of kernel and of each loss kernel, the
   top kernels and the device's idle share. Every timed run comes before these passes.

Prints, before the last line, the slices' numbers (the al_rounds line:
per round the selection seconds, train img/s, validations, eval mIoU,
checkpoint save and load seconds; then plbl img/s, stage-2 img/s and mIoU,
peak memory and the card; the cli_recipe line, item 8b; the voc_recipe
line, item 8c) and one JSON line with
each kernel's check and times (K5 three times: at plbl's shapes, on K6's
planes and on a VOC plbl image; K1-K4 twice: at Cityscapes' and VOC's
stage-1 shapes), its launches on each main path (launches_by_path) and
their sum (launches); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises and exits non-zero; there is no CPU fallback.
"""

from __future__ import annotations

import copy
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

B, NUM_CLASSES, H, W, NSEG = 4, 20, 768, 768, 2048
NSEG_LARGE, WARMUP_LARGE, TIMED_LARGE = 4096, 2, 10  # past the K3 guard
PH, PW, PLBL_IMAGES, EVAL_IMAGES = 1024, 2048, 8, 4  # plbl/eval resolution
WARMUP, TIMED, WINDOW = 3, 20, 5
# the active-learning phase: 768x768 grid-superpixel fixture at nseg 2048,
# pool and label sets of AL_POOL images, val and eval sets of AL_VAL
AL_POOL, AL_VAL, AL_ITRS, AL_VAL_PERIOD, AL_BUDGET = 8, 4, 12, 6, 3000
# the recipe's commands over files: a generated Cityscapes-format tree of
# CLI_TRAIN training and CLI_VAL validation images at PHxPW, the recipe's
# flags cut to CLI_ROUNDS rounds of CLI_ITRS steps, validating every
# CLI_VAL_PERIOD steps
CLI_TRAIN, CLI_VAL, CLI_ITRS, CLI_VAL_PERIOD, CLI_ROUNDS = 16, 4, 12, 6, 2
# the VOC recipe's commands over files: a generated VOC-format tree of
# VOC_TRAIN training and VOC_VAL validation images at VOC's sizes, the
# recipe's flags (batch VOC_B, VOC_CROP crops, nseg VOC_NSEG, VOC_CLASSES
# classes) cut to VOC_ROUNDS rounds of VOC_ITRS stage-1 steps validating
# every VOC_VAL_PERIOD, and VOC_S2_ITRS stage-2 steps a round validating
# every VOC_S2_VAL_PERIOD
VOC_TRAIN, VOC_VAL, VOC_ITRS, VOC_VAL_PERIOD, VOC_ROUNDS = 16, 4, 12, 6, 2
VOC_S2_ITRS, VOC_S2_VAL_PERIOD = 10, 5
VOC_B, VOC_CROP, VOC_NSEG, VOC_CLASSES = 12, 513, 150, 21
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
    "seg_max_fwd": ("K5", "mulactseg_tpu_torch/csrc/segment_max.cu",
                    "mulactseg_tpu/ops/segment_pallas.py:295"),
    "prereduce_nchw": ("K6", "mulactseg_tpu_torch/csrc/prereduce.cu",
                       "mulactseg_tpu/ops/segment_pallas.py:665"),
    "ssm_rows_fwd": ("K7", "mulactseg_tpu_torch/csrc/segment.cu",
                     "mulactseg_tpu/ops/segment_pallas.py:230"),
    "prereduce_rows": ("K8", "mulactseg_tpu_torch/csrc/prereduce.cu",
                       "mulactseg_tpu/ops/segment_pallas.py:351"),
    "pixel_ce_rows_fwd": ("K9", "mulactseg_tpu_torch/csrc/pixel_loss.cu",
                          "mulactseg_tpu/ops/pixel_loss_pallas.py:94"),
    "pixel_ce_rows_bwd": ("K10", "mulactseg_tpu_torch/csrc/pixel_loss.cu",
                          "mulactseg_tpu/ops/pixel_loss_pallas.py:130"),
}
STAGE1_KERNELS = ("pixel_ce_fwd", "pixel_ce_bwd", "ssm_fwd", "ssm_bwd")
STAGE1_LARGE_KERNELS = ("pixel_ce_fwd", "pixel_ce_bwd", "prereduce_nchw",
                        "seg_max_fwd", "ssm_bwd")
ROW_OP_KERNELS = ("ssm_rows_fwd", "prereduce_rows", "seg_max_fwd",
                  "pixel_ce_rows_fwd", "pixel_ce_rows_bwd")
BF16_ULP = 2.0 ** -7  # of the larger value; + 1e-38 for subnormals
PLBL_PARTS = ("plbl.forward", "plbl.softmax", "plbl.k5", "plbl.pass1",
              "plbl.threshold", "plbl.pass2", "plbl.fetch", "plbl.save")


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


def ptxas_summary(log):
    """One line per kernel of an nvcc -Xptxas -v report: its name
    (demangled by cu++filt, which ships beside nvcc, without its namespace
    and parameters), registers and spills."""
    from mulactseg_tpu_torch.ops import _build

    rows = re.findall(r"Compiling entry function '(\w+)'.*?"
                      r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
                      r"Used (\d+) registers", log, flags=re.S)
    if not rows:
        return []
    names = subprocess.run(
        [str(Path(_build._nvcc()).with_name("cu++filt"))],
        input="\n".join(r[0] for r in rows), check=True, capture_output=True,
        text=True).stdout.splitlines()
    # "void <unnamed>::k<(int)20>(const float *, ...)" -> "k<20>"
    names = [re.sub(r"\([\w ]+\)(?=-?\d)|<unnamed>::|\(anonymous "
                    r"namespace\)::", "", n).split("(")[0]
             .removeprefix("void ") for n in names]
    return [f"{name}: {regs} registers, {st}/{ld} bytes spilled "
            f"(stores/loads)"
            for name, (_, st, ld, regs) in zip(names, rows)]


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def class_order_softmax(scaled):
    """K7's probabilities in the kernel's own order: the float32 softmax of
    the bf16-rounded rows, exp(u - max) summed in class order, then e / z.
    The plain version sums with torch's sum; only this order lets K7 be
    held bitwise."""
    from mulactseg_tpu_torch.ops import segment

    u = segment._round_bf16(scaled)
    e = torch.exp(u - u.amax(dim=1, keepdim=True))
    z = e[:, 0]
    for c in range(1, e.shape[1]):
        z = z + e[:, c]
    return e / z[:, None]


def make_batches(n, seed, nseg=None):
    """bench.py's synthetic stage-1 batches, as numpy arrays (nseg NSEG
    unless given)."""
    from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
    from mulactseg_tpu_torch.losses.fused import pixel_target_bits

    nseg = nseg or NSEG
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        target = (rng.rand(B, nseg, NUM_CLASSES) < 0.15).astype(np.float32)
        spx = np.stack([irregular_superpixels(H, W, nseg, rng)
                        for _ in range(B)]).astype(np.int32)
        sel = rng.rand(B, nseg) < 0.5
        spmask = np.take_along_axis(sel, spx.reshape(B, H * W),
                                    axis=1).reshape(B, H, W)
        bits = np.stack([pixel_target_bits(target[b], spx[b], spmask[b])
                         for b in range(B)])
        images = rng.randint(0, 256, (B, 3, H, W)).astype(np.uint8)
        out.append({"images": images, "target": target,
                    "target_bits": bits, "spx": spx})
    return out


def stage1_ids(batch, dev, nseg):
    """(bits3, candidate counts, sid3) of lossdecomp_fused's group term,
    for a batch of any (B, H, W) and class count."""
    from mulactseg_tpu_torch.losses.fused import _popcount

    B, H, W = batch["spx"].shape
    C = batch["target"].shape[-1]
    HW, P = H * W, B * H * W
    bits3 = torch.as_tensor(batch["target_bits"]).to(dev).reshape(
        B, 1, HW).contiguous()
    spx = torch.as_tensor(batch["spx"]).to(dev).reshape(P).long()
    n_cand = _popcount(bits3.reshape(P).long() & ((1 << C) - 1))
    off = torch.arange(B, device=dev).repeat_interleave(HW) * nseg
    sid3 = torch.where(n_cand > 1, spx + off, B * nseg).int().reshape(
        B, 1, HW)
    return bits3, n_cand, sid3


def check_in_segment(sid3, pix, what):
    """K4's precondition: every live argmax pixel lies in its own segment
    (sid3[pix[s, c]] == s wherever pix[s, c] < P)."""
    S, C = pix.shape
    P = sid3.numel()
    live = pix < P
    seg = torch.arange(S, device=pix.device)[:, None].expand(S, C)[live]
    check(bool((sid3.reshape(P)[pix[live].long()].long() == seg).all()),
          f"{what}: an argmax pixel lies outside its segment")


def check_k3(xc, sid3, S, temp, vals, pix, what):
    """K3's (vals, pix) against its plain version on the same inputs:
    absent sets equal with value 0.0, maxima within 1e-6, each argmax pixel
    attaining the plain max within 1e-6 (ties may resolve to another pixel
    only where probabilities agree within rounding) and lying in its
    segment. Returns the max abs error of the values."""
    from mulactseg_tpu_torch.ops import segment

    _, C, HW = xc.shape
    P = sid3.numel()
    pvals, ppix = segment.ssm_fwd_plain(xc, sid3, S, temp)
    torch.cuda.synchronize()
    absent = pix == P
    check(torch.equal(absent, ppix == P), f"{what}: absent sets differ")
    check(bool((vals[absent] == 0).all()), f"{what}: absent value is not 0.0")
    err = (vals - pvals).abs().max().item()
    check(err <= 1e-6, f"{what}: max values differ by {err}")
    probs = segment._softmax(xc, temp)
    q = pix[~absent].long()
    cls = torch.arange(C, device=xc.device).expand(S, C)[~absent]
    tie_err = (probs[q // HW, cls, q % HW] - pvals[~absent]).abs().max()
    check(tie_err.item() <= 1e-6,
          f"{what}: argmax pixel off the max by {tie_err.item()}")
    check_in_segment(sid3, pix, what)
    return err


def colliding_ids(dev, S, B, HW):
    """Adversarial ids for K3 on (B, 1, HW) logits: one id per run of 4
    pixels (the last run cut short), ids equal modulo K3's shared slot
    count in groups of 32 runs (so most runs of a span find their slot
    held), a quarter of the runs invalid."""
    from mulactseg_tpu_torch.ops import segment

    gen = torch.Generator(device="cpu").manual_seed(1)
    runs = -(-B * HW // 4)
    r = torch.arange(runs)
    ids = (r * segment.K3_SLOTS + r // 32) % S
    ids = torch.where(torch.rand(runs, generator=gen) < 0.25, S, ids)
    return ids.repeat_interleave(4)[:B * HW].int().reshape(B, 1, HW).to(dev)


def group_cotangent(vals, pix, target, P):
    """The group term's cotangent of the max values, as lossdecomp_fused
    makes it: -log(max + 1e-8) over the present target entries, over one
    plus their count; P pixels in all."""
    mx = vals.clone().requires_grad_(True)
    present = (pix[:, 0] < P).reshape(target.shape[:2])
    entry = (target > 0.5) & present[:, :, None]
    gnll = -torch.log(mx.reshape(target.shape) + 1e-8)
    (torch.where(entry, gnll, 0.0).sum() / (1.0 + entry.sum())).backward()
    return mx.grad.contiguous()


def check_k4(xc, sid3, vals, pix, gv, temp, what):
    """K4's precondition on (vals, pix), then K4 against the dense plain
    backward: max abs error within 1e-6 of max |dl|. Returns (the kernel's
    dl, the error)."""
    from mulactseg_tpu_torch.ops import segment

    check_in_segment(sid3, pix, what)
    got = segment.ssm_bwd(xc, sid3, vals, pix, gv, temp)
    want = segment.ssm_bwd_plain(xc, vals, pix, gv, temp)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    check(scale > 0 and err <= 1e-6 * scale,
          f"{what}: dl differs, max abs err {err} vs max |dl| {scale}")
    return got, err


def kernel_checks(logits, batch, dev, nseg=NSEG, label=""):
    """K1-K4 against their plain versions at a main path's shapes: the
    (B, C, H, W) logits and the batch's ids at nseg. Returns one row per
    kernel: (name + label, max abs err, ms, plain ms, (bound ms, bound
    by), library ms or None)."""
    from mulactseg_tpu_torch.ops import pixel_loss, segment

    B, C, H, W = logits.shape
    HW = H * W
    P = B * HW
    S = B * nseg
    temp = 0.1
    xc = logits.reshape(B, C, HW).contiguous()
    bits3, n_cand, sid3 = stage1_ids(batch, dev, nseg)
    target = torch.as_tensor(batch["target"]).to(dev)
    # bytes each kernel must move: its inputs once, its outputs once, and
    # the logits only of the pixels this data needs (a pixel without
    # candidates, or outside the group term, needs none of them)
    n_live = int((n_cand > 0).sum())
    n_valid = int((n_cand > 1).sum())
    row_bytes = C * 4
    rows = []

    # K1, bitwise the same on a second call, and K1 and K2 on the 4-byte
    # path too: the logits one float into a larger storage (not 16-byte
    # aligned). The instance: C compiled where it is 20, else C at run
    # time; 16-byte loads where HW % 4 == 0 and the logits are aligned.
    store = torch.empty(xc.numel() + 1, device=dev)
    store[1:] = xc.reshape(-1)
    xu = store[1:].view(B, C, HW)
    nc = pixel_loss.compiled_classes(C)
    check(pixel_loss.instance(xc, bits3) == (nc, HW % 4 == 0)
          and pixel_loss.instance(xu, bits3) == (nc, False),
          f"K1/K2 instances: want C {nc or 'at run time'}, 16-byte path "
          f"{HW % 4 == 0} on the model's logits, 4-byte path on the "
          "shifted copy")
    got = pixel_loss.pixel_ce_fwd(xc, bits3, temp)
    want = pixel_loss.pixel_ce_fwd_plain(xc, bits3, temp)
    got_u = pixel_loss.pixel_ce_fwd(xu, bits3, temp)
    torch.cuda.synchronize()
    for what, k1 in (("K1", got), ("K1 on the 4-byte path", got_u)):
        check(torch.equal(k1[1::2], want[1::2]),
              f"{what} counts differ: {k1.tolist()} vs {want.tolist()}")
        check(torch.allclose(k1[0::2], want[0::2], rtol=1e-5, atol=0),
              f"{what} sums differ: {k1.tolist()} vs {want.tolist()}")
    check(torch.equal(pixel_loss.pixel_ce_fwd(xc, bits3, temp), got),
          "K1 is not bitwise reproducible")
    rows.append(("pixel_ce_fwd" + label, (got - want).abs().max().item(),
                 time_ms(lambda: pixel_loss.pixel_ce_fwd(xc, bits3, temp),
                         graph=True),
                 time_ms(lambda: pixel_loss.pixel_ce_fwd_plain(xc, bits3,
                                                               temp)),
                 bound(P * 4 + n_live * row_bytes + 16, 8 * n_live * C),
                 None))

    # K2, with the cotangents the loss gives (coeff / (1 + count))
    g = torch.stack([16.0 / (1.0 + want[1]), 8.0 / (1.0 + want[3])]
                    ).float().contiguous()
    want_dl = pixel_loss.pixel_ce_bwd_plain(xc, bits3, g, temp)
    scale = want_dl.abs().max().item()
    errs = []
    for what, x_in in (("K2", xc), ("K2 on the 4-byte path", xu)):
        got = pixel_loss.pixel_ce_bwd(x_in, bits3, g, temp)
        torch.cuda.synchronize()
        errs.append((got - want_dl).abs().max().item())
        check(scale > 0 and errs[-1] <= 1e-6 * scale,
              f"{what} dl differs: max abs err {errs[-1]} vs max |dl| "
              f"{scale}")
        del got
    err = errs[0]
    print(json.dumps({"pixel_loss_4byte_path" + label: {
        "K1_ms": time_ms(lambda: pixel_loss.pixel_ce_fwd(xu, bits3, temp),
                         graph=True),
        "K2_ms": time_ms(lambda: pixel_loss.pixel_ce_bwd(xu, bits3, g,
                                                         temp), graph=True),
        "K1_max_abs_err": (got_u - want).abs().max().item(),
        "K2_max_abs_err": errs[1]}}), flush=True)
    del store, xu
    rows.append(("pixel_ce_bwd" + label, err,
                 time_ms(lambda: pixel_loss.pixel_ce_bwd(xc, bits3, g, temp),
                         graph=True),
                 time_ms(lambda: pixel_loss.pixel_ce_bwd_plain(xc, bits3, g,
                                                               temp)),
                 bound(P * 4 + n_live * row_bytes + P * row_bytes + 8,
                       12 * n_live * C),
                 None))
    del want_dl

    # K3, on the recipe's ids and on adversarial ones
    vals, pix = segment.ssm_fwd(xc, sid3, S, temp)
    err = check_k3(xc, sid3, S, temp, vals, pix, "K3")
    adv = colliding_ids(dev, S, B, HW)
    adv_err = check_k3(xc, adv, S, temp, *segment.ssm_fwd(xc, adv, S, temp),
                       "K3 on colliding ids")
    print(f"K3 on colliding ids (one id per run of 4, slots held by other "
          f"ids): max abs err {adv_err}", flush=True)
    del adv
    rows.append(("ssm_fwd" + label, max(err, adv_err),
                 time_ms(lambda: segment.ssm_fwd(xc, sid3, S, temp),
                         graph=True),
                 time_ms(lambda: segment.ssm_fwd_plain(xc, sid3, S, temp)),
                 bound(P * 4 + n_valid * row_bytes + S * C * 8,
                       8 * n_valid * C),
                 None))

    # K4, with the group term's cotangent of the max values
    gv = group_cotangent(vals, pix, target, P)
    got, err = check_k4(xc, sid3, vals, pix, gv, temp, "K4")
    scale = got.abs().max().item()
    # the library's softmax backward computes the same dl from the softmax
    # and the dense cotangent of the probabilities (g / T at each argmax)
    probs = segment._softmax(xc, temp)
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
    del got, lib
    n_live_pix = int(torch.unique(qa).numel())
    rows.append(("ssm_bwd" + label, err,
                 time_ms(lambda: segment.ssm_bwd(xc, sid3, vals, pix, gv,
                                                 temp), graph=True),
                 time_ms(lambda: segment.ssm_bwd_plain(xc, vals, pix, gv,
                                                       temp)),
                 bound(P * row_bytes + 3 * S * C * 4 + n_live_pix * row_bytes,
                       12 * n_live_pix * C),
                 time_ms(lambda: torch.ops.aten._softmax_backward_data(
                     dense_g, probs, 1, torch.float32), graph=True)))
    del probs, dense_g
    return rows


def check_prereduce(got, want, probs, sid, nimg, hw, what):
    """K6 or K8 against its plain version: values bf16-exact, within one
    bf16 ulp of the plain ones (the exps may differ by a float32 ulp, which
    can move a value across a rounding boundary) and equal for more than
    99.9% of them; retired ids equal; and each choice that differs from the
    plain one picks a pixel of its leader's segment whose float32
    probability (probs, (C, P)) is within 1e-6 of the plain pick's.
    Returns (max abs error of the values, number of differing values,
    number of differing choices)."""
    from mulactseg_tpu_torch.ops.segment import _round_bf16

    (planes, choice, sid2), (pplanes, pchoice, psid2) = got, want
    check(torch.equal(planes, _round_bf16(planes)),
          f"{what} values are not rounded to bf16")
    err = (planes - pplanes).abs()
    tol = BF16_ULP * torch.maximum(planes.abs(), pplanes.abs()) + 1e-38
    check(bool((err <= tol).all()),
          f"{what} values differ by more than one bf16 ulp")
    n_vals = int((planes != pplanes).sum())
    check(n_vals < 1e-3 * planes.numel(),
          f"{what}: {n_vals} of {planes.numel()} values differ")
    check(torch.equal(sid2, psid2), f"{what} retired ids differ")
    C, NB = choice.shape
    nb = NB // nimg
    blk = torch.arange(NB, device=choice.device)
    lead = (blk // nb) * hw + (blk % nb) * 4
    check(bool(((blk % nb) * 4 + choice < hw).all()),
          f"{what} choice past its image")
    differ = choice != pchoice
    q = (lead + choice.long())[differ]
    pq = (lead + pchoice.long())[differ]
    cls = torch.arange(C, device=choice.device)[:, None].expand(C, NB)[differ]
    check(bool((sid[q] == sid[lead.expand(C, NB)[differ]]).all()),
          f"{what} choice outside its leader's segment")
    gap = (probs[cls, q] - probs[cls, pq]).abs()
    gap = gap.max().item() if gap.numel() else 0.0
    check(gap <= 1e-6, f"{what} choice off the block max by {gap}")
    return err.max().item(), n_vals, int(differ.sum())


def check_prereduced_term(got, want, term, probs, sid, nimg, hw, counts,
                          what):
    """The pre-reduced group term behind K6 or K8 (got, want: the kernel's
    and the plain version's (planes, choices, retired ids); term: the
    (values, pixels) the op returned on the card; counts: the numbers of
    values and choices in which got and want differ).
    1. K5 on the card's planes and retired ids is bitwise equal to its
       plain version, and the op's output is exactly K5's winners mapped
       back through the card's choices: K5 and the map back are exact.
    2. Against the plain chain (prereduce_plain, segment_max_plain, map
       back): absent sets equal, maxima within one bf16 ulp, and each
       argmax pixel equal, or a pixel of the same segment whose float32
       probability is within one bf16 ulp of the plain pick's (a value that
       rounded the other way can move the first maximum among bf16 ties).
    Returns the number of maxima and pixels that differ from the plain
    chain."""
    from mulactseg_tpu_torch.ops.segment import _pixel_of_row
    from mulactseg_tpu_torch.ops.segment_max import (
        seg_max_fwd,
        segment_max_plain,
    )

    (planes, choice, sid2), (pplanes, pchoice, psid2) = got, want
    vals, pix = term
    S, C = vals.shape
    P = nimg * hw
    kv, krow = seg_max_fwd(planes.t(), sid2, S)
    pv, prow = segment_max_plain(planes.t(), sid2, S)
    torch.cuda.synchronize()
    check(torch.equal(krow, prow) and torch.equal(kv.view(torch.int32),
                                                  pv.view(torch.int32)),
          f"K5 behind {what} differs from its plain version")
    check(torch.equal(vals.view(torch.int32), kv.view(torch.int32))
          and torch.equal(pix, _pixel_of_row(krow, choice, nimg, hw)),
          f"the group term behind {what} is not K5's winners mapped back")
    wv, wrow = segment_max_plain(pplanes.t(), psid2, S)
    wpix = _pixel_of_row(wrow, pchoice, nimg, hw)
    absent = pix == P
    check(torch.equal(absent, wpix == P) and bool(absent.any())
          and bool((~absent).any()),
          f"the group term behind {what}: absent sets differ")
    check(bool(((vals - wv).abs() <= BF16_ULP * torch.maximum(vals, wv)
                + 1e-38).all()),
          f"the group term behind {what}: maxima off by more than a bf16 ulp")
    cls = torch.arange(C, device=pix.device).expand(S, C)
    q, wq = pix.clamp(max=P - 1).long(), wpix.clamp(max=P - 1).long()
    pq, pw = probs[cls, q], probs[cls, wq]
    differ = pix != wpix
    near = (pq - pw).abs() <= BF16_ULP * torch.maximum(pq, pw) + 1e-38
    check(bool((near | ~differ).all()),
          f"the group term behind {what}: an argmax pixel is off the max")
    seg = torch.arange(S, device=pix.device)[:, None].expand(S, C)
    check(torch.equal(sid[q[~absent]], seg[~absent]),
          f"the group term behind {what}: argmax outside its segment")
    # a maximum can differ only through a differing value, a pixel only
    # through a differing value or choice, each at most one entry
    n_vals, n_pix = int((vals != wv).sum()), int(differ.sum())
    check(n_vals <= counts[0] and n_pix <= counts[0] + counts[1],
          f"the group term behind {what}: {n_vals} maxima and {n_pix} "
          f"pixels differ, from {counts} differing values and choices")
    return n_vals, n_pix


def large_kernel_checks(logits, batch, dev):
    """K6 at the stage-1 shapes with nseg 4096 (S = 16,384), then K7 and K8
    on the logits as pre-scaled (P, C) rows and K9 and K10 on them as
    rows, each against its plain version and timed beside it. Returns the
    kernels-line rows, the row inputs (rows, scaled rows, ids, bits) and
    K4's max abs error on the pre-reduced term's outputs."""
    from mulactseg_tpu_torch.ops import pixel_loss, segment
    from mulactseg_tpu_torch.ops.segment_max import (
        seg_max_fwd,
        segment_max_plain,
    )

    HW, P, C = H * W, B * H * W, NUM_CLASSES
    S = B * NSEG_LARGE
    temp = 0.1
    xc = logits.reshape(B, C, HW).contiguous()
    bits3, n_cand, sid3 = stage1_ids(batch, dev, NSEG_LARGE)
    sid = sid3.reshape(P)
    n_live = int((n_cand > 0).sum())
    n_valid = int((n_cand > 1).sum())
    row_bytes = C * 4
    # K6 and K8 write dense planes, choices and ids, so they need every
    # pixel's logits: read logits and ids, write planes, ids and choices
    def pre_bytes(nblocks):
        return 2 * P * row_bytes + 2 * P * 4 + nblocks * C * 4
    rows = []

    # K6, then the pre-reduced group term it feeds (K6, K5, map back)
    sid2d = sid3.reshape(B, HW)
    got = segment.prereduce_softmax_nchw(xc, sid3, S, temp)
    want = segment.prereduce_plain(xc, sid2d, S, temp)
    probs = segment._softmax(xc, temp).permute(1, 0, 2).reshape(C, P)
    torch.cuda.synchronize()
    err, *counts = check_prereduce(got, want, probs, sid, B, HW, "K6")
    pre_vals, pre_pix = segment._ssm_prereduced(xc, sid3, S, temp)
    term = check_prereduced_term(got, want, (pre_vals, pre_pix), probs, sid,
                                 B, HW, counts, "K6")
    print(f"K6: values within one bf16 ulp of the plain version; "
          f"{counts[0]} of {want[0].numel()} values and {counts[1]} of "
          f"{want[1].numel()} choices differ (each a near-tie). K6 -> K5 -> "
          f"map back: K5 bitwise; against the plain chain {term[0]} maxima "
          f"and {term[1]} argmax pixels of {S * C} differ (near-ties)",
          flush=True)
    # K6 on its 4-byte path too: the logits one float into a larger
    # storage (HW % 4 == 0, but not 16-byte aligned); bitwise the same
    store = torch.empty(xc.numel() + 1, device=dev)
    store[1:] = xc.reshape(-1)
    xu = store[1:].view(B, C, HW)
    check(segment.prereduce_instance(xc, sid3) == (C, True)
          and segment.prereduce_instance(xu, sid3) == (C, False),
          "K6 instances: want the C = 20 one, 16-byte path on the model's "
          "logits, 4-byte path on the shifted copy")
    got_u = segment.prereduce_softmax_nchw(xu, sid3, S, temp)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, got_u)),
          "K6 differs between its 16-byte and 4-byte paths")
    print(json.dumps({"prereduce_4byte_path": {
        "K6_ms": time_ms(lambda: segment.prereduce_softmax_nchw(
            xu, sid3, S, temp), graph=True)}}), flush=True)
    del store, xu, got_u
    # K5 where the stage-1 step runs it: on K6's planes under the retired
    # ids (S = 16,384), bitwise against its plain version
    planes, sid2 = got[0], got[2]
    kv, krow = seg_max_fwd(planes.t(), sid2, S)
    pv, prow = segment_max_plain(planes.t(), sid2, S)
    torch.cuda.synchronize()
    check(torch.equal(krow, prow) and torch.equal(kv.view(torch.int32),
                                                  pv.view(torch.int32)),
          "K5 on K6's planes differs from its plain version")
    n_k5 = int((sid2 < S).sum())
    k5_row = (f"seg_max_fwd@K6's planes, nseg {NSEG_LARGE}",
              (kv - pv).abs().max().item(),
              time_ms(lambda: seg_max_fwd(planes.t(), sid2, S), graph=True),
              time_ms(lambda: segment_max_plain(planes.t(), sid2, S)),
              bound(P * 4 + n_k5 * row_bytes + S * C * 8, n_k5 * C), None)
    print(f"K5 on K6's planes: bitwise; {n_k5} of {P} pixels valid under the "
          f"retired ids", flush=True)
    del got, want, probs, planes, sid2, kv, krow, pv, prow
    # K4 on the pre-reduced term's outputs, the backward of this path
    target = torch.as_tensor(batch["target"]).to(dev)
    _, k4_err = check_k4(xc, sid3, pre_vals, pre_pix,
                         group_cotangent(pre_vals, pre_pix, target, P), temp,
                         "K4 on the pre-reduced term")
    print(f"K4 on the pre-reduced term (nseg {NSEG_LARGE}): max abs err "
          f"{k4_err}", flush=True)
    rows.append(("prereduce_nchw", err,
                 time_ms(lambda: segment.prereduce_softmax_nchw(
                     xc, sid3, S, temp), graph=True),
                 time_ms(lambda: segment.prereduce_plain(xc, sid2d, S,
                                                         temp)),
                 bound(pre_bytes(B * -(-HW // 4)), 12 * P * C), None))
    rows.append(k5_row)

    # the logits as (P, C) rows, the row-major ops' layout
    x2d = logits.permute(0, 2, 3, 1).reshape(P, C).contiguous()
    scaled = x2d / temp
    bits = bits3.reshape(P)

    # the rows one float into a larger storage: K7's and K10's 4-byte
    # instances
    store = torch.empty(2 * P * C + 2, device=dev)
    store[1:P * C + 1] = x2d.reshape(-1)
    store[P * C + 2:] = scaled.reshape(-1)
    x2d_u = store[1:P * C + 1].view(P, C)
    scaled_u = store[P * C + 2:].view(P, C)
    check(segment.rows_instance(scaled) == (C, True)
          and segment.rows_instance(scaled_u) == (C, False)
          and pixel_loss.rows_instance(x2d, bits) == (C, True)
          and pixel_loss.rows_instance(x2d_u, bits) == (C, False),
          "K7/K10 instances: want the C = 20 ones, 16-byte units on the "
          "rows, 4-byte units on the shifted copies")
    four_byte = {}

    # K7: against its plain version, bitwise against the class-order
    # reference, and the same bits on both instances
    vals, pix = segment.ssm_rows_fwd(scaled, sid, S)
    pvals, ppix = segment.ssm_rows_fwd_plain(scaled, sid, S)
    uvals, upix = segment.ssm_rows_fwd(scaled_u, sid, S)
    torch.cuda.synchronize()
    absent = pix == P
    check(bool((pix < P).any() and absent.any()), "K7: no present or no "
          "absent entry")
    check(torch.equal(absent, ppix == P), "K7 absent sets differ")
    check(bool((vals[absent] == 0).all()), "K7 absent value is not 0.0")
    err = (vals - pvals).abs().max().item()
    check(err <= 1e-6, f"K7 max values differ by {err}")
    probs = torch.softmax(segment._round_bf16(scaled), dim=1)
    q = pix[~absent].long()
    cls = torch.arange(C, device=dev).expand(S, C)[~absent]
    tie_err = (probs[q, cls] - pvals[~absent]).abs().max().item()
    check(tie_err <= 1e-6, f"K7 argmax pixel off the max by {tie_err}")
    check(bool((sid[q] == torch.arange(S, device=dev)[:, None]
                .expand(S, C)[~absent]).all()), "K7 argmax outside segment")
    del probs
    cvals, cpix = segment.segment_max_plain(class_order_softmax(scaled),
                                            sid, S)
    check(torch.equal(pix, cpix) and torch.equal(vals.view(torch.int32),
                                                 cvals.view(torch.int32)),
          "K7 differs bitwise from the class-order reference")
    check(torch.equal(pix, upix) and torch.equal(vals.view(torch.int32),
                                                 uvals.view(torch.int32)),
          "K7 differs between its 16-byte and 4-byte instances")
    del cvals, cpix
    four_byte["K7_ms"] = time_ms(
        lambda: segment.ssm_rows_fwd(scaled_u, sid, S), graph=True)
    del uvals, upix
    rows.append(("ssm_rows_fwd", err,
                 time_ms(lambda: segment.ssm_rows_fwd(scaled, sid, S),
                         graph=True),
                 time_ms(lambda: segment.ssm_rows_fwd_plain(scaled, sid, S)),
                 bound(P * 4 + n_valid * row_bytes + S * C * 8,
                       8 * n_valid * C),
                 None))

    # K8, then the row op's pre-reduced branch (K8, K5, map back)
    got = segment.prereduce_softmax_rows(scaled, sid, S)
    want = segment.prereduce_plain(scaled.t()[None], sid[None], S, 1.0)
    probs = torch.softmax(scaled, dim=1).t()
    torch.cuda.synchronize()
    err, *counts = check_prereduce(got, want, probs, sid, 1, P, "K8")
    with torch.no_grad():
        out = segment.segment_softmax_max(scaled, sid, S, prereduce=True)
    term = check_prereduced_term(got, want, out, probs, sid, 1, P, counts,
                                 "K8")
    print(f"K8: values within one bf16 ulp of the plain version; "
          f"{counts[0]} of {want[0].numel()} values and {counts[1]} of "
          f"{want[1].numel()} choices differ (each a near-tie). K8 -> K5 -> "
          f"map back: K5 bitwise; against the plain chain {term[0]} maxima "
          f"and {term[1]} argmax pixels of {S * C} differ (near-ties)",
          flush=True)
    del got, want, probs, out
    rows.append(("prereduce_rows", err,
                 time_ms(lambda: segment.prereduce_softmax_rows(
                     scaled, sid, S), graph=True),
                 time_ms(lambda: segment.prereduce_plain(
                     scaled.t()[None], sid[None], S, 1.0)),
                 bound(pre_bytes(-(-P // 4)), 12 * P * C), None))

    # K9
    got = pixel_loss.pixel_ce_rows_fwd(x2d, bits, temp)
    want = pixel_loss.pixel_ce_fwd_plain(x2d.t()[None], bits[None, None],
                                         temp)
    torch.cuda.synchronize()
    check(torch.equal(got[1::2], want[1::2]),
          f"K9 counts differ: {got.tolist()} vs {want.tolist()}")
    check(torch.allclose(got[0::2], want[0::2], rtol=1e-5, atol=0),
          f"K9 sums differ: {got.tolist()} vs {want.tolist()}")
    rows.append(("pixel_ce_rows_fwd", (got - want).abs().max().item(),
                 time_ms(lambda: pixel_loss.pixel_ce_rows_fwd(x2d, bits,
                                                              temp),
                         graph=True),
                 time_ms(lambda: pixel_loss.pixel_ce_fwd_plain(
                     x2d.t()[None], bits[None, None], temp)),
                 bound(P * 4 + n_live * row_bytes + 16, 8 * n_live * C),
                 None))

    # K10, with the cotangents the loss gives (coeff / (1 + count))
    g = torch.stack([16.0 / (1.0 + want[1]), 8.0 / (1.0 + want[3])]
                    ).float().contiguous()
    got = pixel_loss.pixel_ce_rows_bwd(x2d, bits, g, temp)
    want_dl = pixel_loss.pixel_ce_bwd_plain(x2d.t()[None], bits[None, None],
                                            g, temp)[0].t()
    got_u = pixel_loss.pixel_ce_rows_bwd(x2d_u, bits, g, temp)
    torch.cuda.synchronize()
    err = (got - want_dl).abs().max().item()
    scale = want_dl.abs().max().item()
    check(scale > 0 and err <= 1e-6 * scale,
          f"K10 dl differs: max abs err {err} vs max |dl| {scale}")
    check(torch.equal(got.view(torch.int32), got_u.view(torch.int32)),
          "K10 differs between its 16-byte and 4-byte instances")
    del got, want_dl, got_u
    four_byte["K10_ms"] = time_ms(
        lambda: pixel_loss.pixel_ce_rows_bwd(x2d_u, bits, g, temp),
        graph=True)
    print(json.dumps({"rows_4byte_path": four_byte}), flush=True)
    del store, x2d_u, scaled_u
    rows.append(("pixel_ce_rows_bwd", err,
                 time_ms(lambda: pixel_loss.pixel_ce_rows_bwd(x2d, bits, g,
                                                              temp),
                         graph=True),
                 time_ms(lambda: pixel_loss.pixel_ce_bwd_plain(
                     x2d.t()[None], bits[None, None], g, temp)),
                 bound(P * 4 + n_live * row_bytes + P * row_bytes + 8,
                       12 * n_live * C),
                 None))
    return rows, (x2d, scaled, sid, bits), k4_err


def row_op_pass(x2d, scaled, sid, bits):
    """One autograd pass through each row-major op with every counter at 0
    just before: segment_softmax_max (K7), the same with prereduce=True (K8
    then K5) and pixel_partial_ce (K9, K10). Each loss must equal the one
    its plain versions give on the same rows (rtol 1e-5; the pre-reduced
    values may round a near-tie the other way, which moves a mean over
    ~10^5 entries far less), and each gradient must be finite and
    non-zero. Returns the launch counts and the losses."""
    from mulactseg_tpu_torch.ops import _build, pixel_loss, segment
    from mulactseg_tpu_torch.ops.segment_max import segment_max_plain

    P, S = x2d.shape[0], B * NSEG_LARGE

    def group_loss(mx, pix):
        present = pix < P
        return -(torch.log(mx + 1e-8) * present).sum() / (1.0 + present.sum())

    def ce_loss(sums):
        return 16.0 * sums[0] / (1.0 + sums[1]) + 8.0 * sums[2] / (
            1.0 + sums[3])

    torch.cuda.synchronize()
    _build.reset_launches()
    out = {}
    for name, prereduce in (("segment_softmax_max", False),
                            ("segment_softmax_max prereduce", True)):
        u = scaled.detach().requires_grad_(True)
        loss = group_loss(*segment.segment_softmax_max(
            u, sid, S, prereduce=prereduce))
        loss.backward()
        out[name] = (loss.detach(), u.grad)
    x = x2d.detach().requires_grad_(True)
    loss = ce_loss(pixel_loss.pixel_partial_ce(x, bits, 0.1))
    loss.backward()
    out["pixel_partial_ce"] = (loss.detach(), x.grad)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check(launches == {k: 1 for k in ROW_OP_KERNELS},
          f"row-op launches {launches}, want one each of {ROW_OP_KERNELS}")

    planes, choice, sid2 = segment.prereduce_plain(scaled.t()[None],
                                                   sid[None], S, 1.0)
    v8, r8 = segment_max_plain(planes.t(), sid2, S)
    want = {"segment_softmax_max": group_loss(*segment.ssm_rows_fwd_plain(
                scaled, sid, S)),
            "segment_softmax_max prereduce": group_loss(v8, r8),
            "pixel_partial_ce": ce_loss(pixel_loss.pixel_ce_fwd_plain(
                x2d.t()[None], bits[None, None], 0.1))}
    losses = {}
    for name, (loss, grad) in out.items():
        losses[name] = float(loss)
        check(math.isclose(losses[name], float(want[name]), rel_tol=1e-5)
              and losses[name] > 0,
              f"{name}: loss {losses[name]} vs plain {float(want[name])}")
        check(bool(torch.isfinite(grad).all()) and grad.abs().max() > 0,
              f"{name}: bad gradient")
    return launches, losses


def small_reference_check(dev, h=96, w=80, nseg=24):
    """lossdecomp_fused on the card against the CPU on one small input:
    loss and parts within rtol 1e-5, every gradient entry within 1e-5 of
    the largest. Past the K3 guard (2 * nseg + 1 > 9216) the group term is
    pre-reduced: the card must launch K6 and no K3. A K6 value next to a
    bf16 rounding boundary may round the other way on the card than on the
    CPU; that may move the gradient of its own segment only, so an entry
    outside the tolerance must lie in a segment that holds such a value
    (with none, every entry must be inside it). Returns (entries outside
    the tolerance, K6 values that round differently)."""
    from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
    from mulactseg_tpu_torch.losses.fused import (
        _popcount,
        lossdecomp_fused,
        pixel_target_bits,
    )
    from mulactseg_tpu_torch.ops import _build, segment

    rng = np.random.RandomState(5)
    b, c = 2, NUM_CLASSES
    prereduced = b * nseg + 1 > segment.SCATTER_MAX_SEGMENTS
    spx = np.stack([irregular_superpixels(h, w, nseg, rng)
                    for _ in range(b)]).astype(np.int32)
    target = (rng.rand(b, nseg, c) < 0.15).astype(np.float32)
    spmask = np.take_along_axis(rng.rand(b, nseg) < 0.6, spx.reshape(b, -1),
                                axis=1).reshape(b, h, w)
    bits = np.stack([pixel_target_bits(target[i], spx[i], spmask[i])
                     for i in range(b)])
    logits = (rng.randn(b, c, h, w) * 3).astype(np.float32)
    out = {}
    _build.reset_launches()
    for d in ("cpu", dev):
        x = torch.from_numpy(logits).to(d).requires_grad_(True)
        total, aux = lossdecomp_fused(
            x, torch.from_numpy(bits).to(d), torch.from_numpy(target).to(d),
            torch.from_numpy(spx).to(d), nseg=nseg)
        total.backward()
        out[str(d)] = ({k: float(v.detach()) for k, v in aux.items()},
                       x.grad.cpu())
    torch.cuda.synchronize()
    want = STAGE1_LARGE_KERNELS if prereduced else STAGE1_KERNELS
    check(dict(_build.LAUNCHES) == {k: 1 for k in want},
          f"small lossdecomp launches {dict(_build.LAUNCHES)}, want {want}")
    (ref, gref), (got, ggot) = out["cpu"], out[str(dev)]
    for k in ref:
        check(math.isclose(ref[k], got[k], rel_tol=1e-5) and ref[k] > 0,
              f"small lossdecomp {k}: card {got[k]} vs cpu {ref[k]}")
    bad = (ggot - gref).abs() > 1e-5 * gref.abs().max()
    hw, S = h * w, b * nseg
    may_differ = torch.zeros(b * hw, dtype=torch.bool)
    flips = 0
    if prereduced:
        # the group term's ids as lossdecomp_fused makes them
        bt = torch.from_numpy(bits).reshape(b * hw).long()
        sid = torch.where(_popcount(bt & ((1 << c) - 1)) > 1,
                          torch.from_numpy(spx).reshape(-1).long()
                          + torch.arange(b).repeat_interleave(hw) * nseg, S)
        xc = torch.from_numpy(logits).reshape(b, c, hw)
        sid3 = sid.int().reshape(b, 1, hw)
        cpu_planes, _, sid2 = segment.prereduce_softmax_nchw(xc, sid3, S,
                                                             0.1)
        card_planes = segment.prereduce_softmax_nchw(
            xc.to(dev), sid3.to(dev), S, 0.1)[0].cpu()
        flipped = (card_planes != cpu_planes) & (sid2 < S)
        flips = int(flipped.sum())
        touched = torch.zeros(S + 1, dtype=torch.bool)
        touched[sid[flipped.any(dim=0)]] = True
        may_differ = touched[sid]
    bad_pix = bad.permute(0, 2, 3, 1).reshape(b * hw, c).any(dim=1)
    check(not bool((bad_pix & ~may_differ).any()),
          f"small lossdecomp gradient: {int(bad.sum())} entries differ, "
          f"{int((bad_pix & ~may_differ).sum())} pixels outside the "
          f"segments of the {flips} values that round differently")
    return int(bad.sum()), flips


def device_spans(prof):
    """(kernel spans sorted by start, busy us, window us) of a profile:
    busy is the union of the spans (one stream), the window runs from the
    first span's start to the last one's end. Device-side spans of
    record_function ranges enclose kernels already counted and are left
    out."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.time_range.end > e.time_range.start)
    check(spans, "the profiler saw no device activity")
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e, _ in spans:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return spans, busy, spans[-1][1] - spans[0][0]


def profile_steps(step, batches, label, n=3, top=25):
    """torch.profiler over n train steps, after one warm-up step: device time
    by kernel name, the kernels' share by kind, and the device's idle share
    between the first kernel's start and the last one's end (one stream, so
    busy time is the union of kernel intervals)."""
    from torch.profiler import ProfilerActivity, profile

    step(batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            step(batches[i % len(batches)])
        torch.cuda.synchronize()
    spans, busy, window = device_spans(prof)
    by_name = {}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    kinds = {"loss kernels (K1-K10)": ("pixel_ce", "ssm_", "prereduce",
                                       "seg_max"),
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
    loss_keys = kinds["loss kernels (K1-K10)"]
    print(json.dumps({"profile": {
        "slice": label, "steps": n, "device_spans_per_step": len(spans) / n,
        "window_ms_per_step": window / n / 1e3,
        "device_busy_ms_per_step": busy / n / 1e3,
        "idle_share": 1.0 - busy / window,
        "kind_ms_per_step": {k: v / n / 1e3 for k, v in sorted(
            by_kind.items(), key=lambda kv: -kv[1])},
        "loss_kernel_ms_per_step": {
            name[:110]: t / n / 1e3 for name, t in by_name.items()
            if any(key in name for key in loss_keys)}}}))
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {t / n / 1e3:9.3f} ms/step  {name[:110]}")


def plbl_fixture(n, seed):
    """tools_dev/bench_round.py:135-157's pseudo-label fixture at
    1024x2048 in the port's layout: two base superpixel maps, 30% of
    superpixels selected, 1-3 candidate classes per superpixel (of C+1),
    uint8 NCHW images and GT; the first 600 superpixel ids count as
    labelled (suppix)."""
    from mulactseg_tpu_torch.data.synthetic import irregular_superpixels

    rng = np.random.RandomState(seed)
    base = [irregular_superpixels(PH, PW, NSEG, rng) for _ in range(2)]
    batches, suppix = [], {}
    for i in range(n):
        spx = base[i % 2]
        sel = np.nonzero(rng.rand(NSEG) < 0.3)[0]
        tgt = (rng.rand(NSEG, NUM_CLASSES) < 0.1).astype(np.float32)
        tgt[np.arange(NSEG), rng.randint(0, NUM_CLASSES, NSEG)] = 1.0
        batches.append({
            "images": rng.randint(0, 256, (1, 3, PH, PW)).astype(np.uint8),
            "labels": rng.randint(0, NUM_CLASSES - 1,
                                  (1, PH, PW)).astype(np.uint8),
            "target": tgt[None], "spx": spx[None],
            "spmask": np.isin(spx, sel)[None],
            "fnames": [["img", f"lbl_{i}.png", f"spx_{i}"]]})
        suppix[f"spx_{i}"] = np.unique(spx).tolist()[:600]
    return batches, suppix


def check_k5(values, sid, name, nseg=NSEG):
    """K5 on (P, C) values under (P,) ids against its plain version: the
    argmax pixels and the max values bitwise, with present and absent
    segments among the nseg. Returns the max abs error."""
    from mulactseg_tpu_torch.ops import segment_max

    vals, pix = segment_max.seg_max_fwd(values, sid, nseg)
    pvals, ppix = segment_max.segment_max_plain(values, sid, nseg)
    torch.cuda.synchronize()
    P = values.shape[0]
    check(torch.equal(pix, ppix), f"K5 argmax pixels differ ({name})")
    check(torch.equal(vals.view(torch.int32), pvals.view(torch.int32)),
          f"K5 max values differ bitwise ({name})")
    check(bool((pix < P).any()) and bool((pix == P).any()),
          f"K5 case {name} lacks present or absent segments")
    return (vals - pvals).abs().max().item()


def k5_checks(model, dev):
    """K5 against its plain version at the pseudo-labeller's shapes:
    the softmax planes of a full-resolution eval forward with ~30% of
    superpixels selected, then signed values rounded to 1/8. Both outputs
    must be bitwise equal. Returns the kernels-line row."""
    from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
    from mulactseg_tpu_torch.engine.evaluate import eval_forward
    from mulactseg_tpu_torch.ops import segment_max

    rng = np.random.RandomState(11)
    C, P = NUM_CLASSES, PH * PW
    image = rng.randint(0, 256, (1, 3, PH, PW)).astype(np.uint8)
    logits = eval_forward(model, image, dev, True)
    planes = torch.softmax(logits[0].float(), dim=0).reshape(C, P).t()
    del logits
    spx = irregular_superpixels(PH, PW, NSEG, rng)
    sel = rng.rand(NSEG) < 0.3
    sid = torch.from_numpy(np.where(sel[spx], spx, NSEG).reshape(-1).astype(
        np.int32)).to(dev)
    gen = torch.Generator(dev).manual_seed(0)
    signed = torch.round(torch.randn(P, C, device=dev, generator=gen) * 8) / 8
    err = max(check_k5(planes, sid, "softmax planes"),
              check_k5(signed, sid, "signed/8"))
    del signed
    n_valid = int((sid < NSEG).sum())
    print(f"K5 bitwise equal to its plain version on both inputs; "
          f"{n_valid} of {P} pixels valid", flush=True)
    return ("seg_max_fwd", err,
            time_ms(lambda: segment_max.seg_max_fwd(planes, sid, NSEG),
                    graph=True),
            time_ms(lambda: segment_max.segment_max_plain(planes, sid, NSEG)),
            bound(P * 4 + n_valid * C * 4 + NSEG * C * 8, n_valid * C),
            None)


def eval_slice(model, cfg, dev):
    """Evaluator.run with predignore on EVAL_IMAGES uint8 1024x2048 images
    (1 warm-up image first)."""
    from mulactseg_tpu_torch.engine.evaluate import Evaluator

    rng = np.random.RandomState(12)
    batches = []
    for _ in range(EVAL_IMAGES):
        labels = rng.randint(0, NUM_CLASSES - 1, (1, PH, PW)).astype(np.uint8)
        labels[rng.rand(1, PH, PW) < 0.1] = 255
        batches.append({"images": rng.randint(0, 256, (1, 3, PH, PW)).astype(
            np.uint8), "labels": labels})
    ev = Evaluator(model, cfg, device=dev)
    ev.run(None, batches[:1], predignore=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    miou, table = ev.run(None, batches, predignore=True)
    dt = time.perf_counter() - t0
    check(math.isfinite(miou) and len(table.split(",")) == NUM_CLASSES + 1,
          f"bad eval result {miou} {table}")
    return {"slice": "evaluation, predignore, 1024x2048", "images":
            EVAL_IMAGES, "img_per_s": EVAL_IMAGES / dt,
            "ms_per_image": dt / EVAL_IMAGES * 1e3, "miou": miou}


def plbl_slice(model, cfg, dev):
    """The recipe's pseudo-labelling step on the fixture: the main path's
    run (counted), the PNG check, and a profiled pass for the breakdown."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mulactseg_tpu_torch.ops import _build
    from mulactseg_tpu_torch.plbl.generator import PseudoLabelGenerator
    from mulactseg_tpu_torch.utils.png import read_gray8

    batches, suppix = plbl_fixture(PLBL_IMAGES + 1, seed=3)
    warm, timed = batches[:1], batches[1:]
    gen = PseudoLabelGenerator(model, cfg, "cosprop_includeonehot",
                               device=dev)
    check(gen.sim_bf16, "the recipe's plbl runs with bf16 similarities")
    with tempfile.TemporaryDirectory() as tmp:
        gen.generate(None, warm, save_dir=os.path.join(tmp, "warm"),
                     suppix=suppix)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        miou, iou, prec, rec = gen.generate(
            None, timed, save_dir=os.path.join(tmp, "run"), suppix=suppix)
        dt = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        check(launches == {"seg_max_fwd": PLBL_IMAGES},
              f"plbl launches {launches}, want seg_max_fwd once per image")
        check(math.isfinite(miou) and all(
            math.isfinite(float(v)) for t in (iou, prec, rec)
            for v in t.split(",")), f"bad plbl scores {miou} {iou}")
        labelled = []
        for b in timed:
            path = os.path.join(tmp, "run", b["fnames"][0][1])
            check(os.path.exists(path), f"missing {path}")
            want = gen.plbl_for_batch(b, suppix).to(torch.uint8).cpu().numpy()
            check(np.array_equal(read_gray8(path), want),
                  f"{path} does not decode to the generator's map")
            labelled.append(float((want != 255).mean()))

        host_prep_s = []
        for b in timed:
            t1 = time.perf_counter()
            gen.host_prep(b, suppix)
            host_prep_s.append(time.perf_counter() - t1)

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            gen.generate(None, timed, save_dir=os.path.join(tmp, "prof"),
                         suppix=suppix)
            torch.cuda.synchronize()
    _, busy, window = device_spans(prof)
    parts = {}
    for name in PLBL_PARTS:
        dev_us = [e.time_range.end - e.time_range.start for e in prof.events()
                  if e.name == name and e.device_type == DeviceType.CUDA]
        host_us = [e.time_range.end - e.time_range.start
                   for e in prof.events()
                   if e.name == name and e.device_type == DeviceType.CPU]
        parts[name] = {
            "device_ms": (sum(dev_us) / PLBL_IMAGES / 1e3 if dev_us
                          else None),
            "host_ms": sum(host_us) / PLBL_IMAGES / 1e3 if host_us else None}
    return {"slice": "plbl cosprop_includeonehot, 1024x2048, nseg 2048, "
            "bf16 features", "images": PLBL_IMAGES,
            "img_per_s": PLBL_IMAGES / dt,
            "ms_per_image": dt / PLBL_IMAGES * 1e3, "peak_mem_gib": peak_gib,
            "miou": miou, "labelled_share": statistics.mean(labelled),
            "host_prep_ms": statistics.mean(host_prep_s) * 1e3,
            "parts_per_image": parts,
            "profiled_window_ms_per_image": window / PLBL_IMAGES / 1e3,
            "profiled_device_busy_ms_per_image": busy / PLBL_IMAGES / 1e3,
            "profiled_idle_share": 1.0 - busy / window}, launches


def small_plbl_check(dev):
    """cosine_prototype_plbl on the card against the CPU on one small
    input with sim_bf16 off: K5's outputs equal, and the maps agree on
    >= 99.5% of pixels (the similarity matmuls sum in another order)."""
    from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
    from mulactseg_tpu_torch.ops.segment_max import seg_max_fwd
    from mulactseg_tpu_torch.plbl.cosine_prop import (
        cosine_prototype_plbl,
        selected_spx_adjacency,
    )

    rng = np.random.RandomState(13)
    h, w, nseg, C, Ch = 96, 80, 24, NUM_CLASSES, 256
    P = h * w
    spx = irregular_superpixels(h, w, nseg, rng)
    feats = rng.randn(Ch, P).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=0, keepdims=True)
    logits = rng.randn(C, P).astype(np.float32) * 3
    probs = np.exp(logits - logits.max(0))
    probs = (probs / probs.sum(0)).astype(np.float32)
    targets = np.zeros((nseg, C), np.float32)
    for s in range(nseg):
        targets[s, rng.choice(C, rng.randint(1, 4), replace=False)] = 1
    selected = np.nonzero(rng.rand(nseg) < 0.6)[0].tolist()
    proto = selected_spx_adjacency(spx, selected, nseg, targets, 256, True)
    valid = np.isin(spx, selected).reshape(-1)
    sid = np.where(valid, spx.reshape(-1), nseg).astype(np.int32)
    out = {}
    for d in ("cpu", dev):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(d)

        k5 = seg_max_fwd(t(probs).t(), t(sid), nseg)
        m = cosine_prototype_plbl(
            t(feats).t(), t(probs).t(), t(spx.reshape(-1)), t(valid),
            *(t(a) for a in proto), nseg=nseg, chunk=2048)
        out[str(d)] = (k5[0].cpu(), k5[1].cpu(), m.cpu())
    (cv, ci, cm), (gv, gi, gm) = out["cpu"], out[str(dev)]
    check(torch.equal(ci, gi) and torch.equal(cv, gv),
          "small plbl: K5 on the card differs from the CPU")
    differ = int((cm != gm).sum())
    print(f"small plbl: {differ} of {P} pixels differ between card and CPU",
          flush=True)
    check(differ <= 0.005 * P and bool((gm != 255).any()),
          f"small plbl: {differ} of {P} pixels differ")
    return differ


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _state_equal(payload, model, optimizer, step):
    """The checkpoint payload holds bitwise the model's and optimizer's
    state and the step."""
    if payload["step"] != step:
        return False
    sd = model.state_dict()
    if payload["model_state_dict"].keys() != sd.keys() or not all(
            torch.equal(payload["model_state_dict"][k], v.cpu())
            for k, v in sd.items()):
        return False
    want, got = optimizer.state_dict(), payload["optimizer_state_dict"]
    if want["param_groups"] != got["param_groups"] or \
            want["state"].keys() != got["state"].keys():
        return False
    return all(torch.equal(got["state"][i][k], v.cpu())
               for i, st in want["state"].items() for k, v in st.items())


def al_rounds_slice(variables, dev, smi, workdir):
    """The active-learning main path (docstring, item 8a): 2 rounds, the
    pseudo-labelling of the label set and stage 2, timed per part with
    wrappers around the trainer's and the selectors' methods, the launch
    counters read around each part. Returns (the al_rounds line, the
    path's launches)."""
    from mulactseg_tpu_torch.acquisition import selectors
    from mulactseg_tpu_torch.active import RegionActiveSet
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.data.datasets import RegionDatasetPlbl
    from mulactseg_tpu_torch.data.loader import DataProvider, start_workers
    from mulactseg_tpu_torch.data.synthetic import SyntheticRegionDataset
    from mulactseg_tpu_torch.engine import rounds
    from mulactseg_tpu_torch.engine.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from mulactseg_tpu_torch.engine.evaluate import eval_forward
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.models.factory import get_model
    from mulactseg_tpu_torch.ops import _build
    from mulactseg_tpu_torch.plbl.generator import (
        PseudoLabelGenerator,
        plbl_save_dir,
    )
    from mulactseg_tpu_torch.utils.png import read_gray8, write_rgb8

    sel2 = "my_bvsb_predclsbal_pwr_banignore"
    common = dict(num_classes=NUM_CLASSES - 1, nseg=NSEG, crop_size=(H, W),
                  train_batch_size=B, dtype="bfloat16", separable_conv=True,
                  finetune_itrs=AL_ITRS, val_period=AL_VAL_PERIOD,
                  val_start=0, log_period=AL_ITRS // 3, val_batch_size=B,
                  num_workers=4, val_num_workers=4)
    cfg = Config(method="active_joint_multi_predignore_lossdecomp",
                 max_iterations=2, active_selection_size=AL_BUDGET,
                 init_active_method="my_random", active_method=sel2,
                 model_save_dir=os.path.join(workdir, "run"), **common)
    t0 = time.perf_counter()
    model = get_model(cfg.model, cfg.num_model_classes, cfg.output_stride,
                      separable_conv=True, device=dev)
    convert.load_variables(model, variables)
    init = os.path.join(workdir, "deeplab_resnet50deepstem_imagenet_"
                        "pretrained_seed0.pth")
    save_checkpoint(init, model)
    del model

    def dataset(split, n, seed):
        return SyntheticRegionDataset(n_images=n, H=H, W=W,
                                      num_classes=NUM_CLASSES - 1, nseg=NSEG,
                                      split=split, seed=seed)

    pool = dataset("active-ulabel", AL_POOL, 7)
    label = dataset("active-label", AL_POOL, 7)
    label.suppix, label.im_idx = {}, []
    val, evalset = dataset("val", AL_VAL, 8), dataset("val", AL_VAL, 9)
    active = RegionActiveSet(cfg, pool, label)
    setup_s = time.perf_counter() - t0

    per_round = {r: {"select_s": [], "train_s": [], "train_img_per_s": [],
                     "validations": 0, "save_s": [], "load_s": []}
                 for r in (1, 2)}
    losses, checked = [], []
    real = {"train": rounds.ALTrainer.train, "save": rounds.ALTrainer.save,
            "load": rounds.ALTrainer.load,
            "validate": rounds.ALTrainer.validate,
            "select": selectors.RegionSelector.select_next_batch}

    def timed(fn, key):
        def wrapper(self, *a, **k):
            _sync(dev)
            t1 = time.perf_counter()
            out = fn(self, *a, **k)
            _sync(dev)
            per_round[self.selection_iter][key].append(
                time.perf_counter() - t1)
            return out
        return wrapper

    def train(self, *a, **k):
        t1 = time.perf_counter()
        rate = real["train"](self, *a, **k)
        per_round[self.selection_iter]["train_s"].append(
            time.perf_counter() - t1)
        per_round[self.selection_iter]["train_img_per_s"].append(rate)
        return rate

    def save(self, path=None):
        timed(real["save"], "save_s")(self, path)
        if not checked:  # the first checkpoint, loaded back
            checked.append(_state_equal(
                load_checkpoint(path or self.checkpoint_file), self.model,
                self.optimizer, self.step))

    def validate(self, trainiter):
        per_round[self.selection_iter]["validations"] += 1
        return real["validate"](self, trainiter)

    def select(self, trainer, active_set, n):
        _sync(dev)
        t1 = time.perf_counter()
        out = real["select"](self, trainer, active_set, n)
        per_round[active_set.selection_iter]["select_s"].append(
            time.perf_counter() - t1)
        return out

    rounds.ALTrainer.train, rounds.ALTrainer.save = train, save
    rounds.ALTrainer.load = timed(real["load"], "load_s")
    rounds.ALTrainer.validate = validate
    selectors.RegionSelector.select_next_batch = select
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        results = rounds.run_al_rounds(
            cfg, active, val_dataset=val, eval_dataset=evalset,
            init_checkpoint=init, device=dev,
            metrics_cb=lambda it, aux: losses.append(aux))
        _sync(dev)
        rounds_s = time.perf_counter() - t0
        round_launches = dict(_build.LAUNCHES)
    finally:
        rounds.ALTrainer.train, rounds.ALTrainer.save = (real["train"],
                                                         real["save"])
        rounds.ALTrainer.load = real["load"]
        rounds.ALTrainer.validate = real["validate"]
        selectors.RegionSelector.select_next_batch = real["select"]
    steps = 2 * AL_ITRS
    check(round_launches == {k: steps for k in STAGE1_KERNELS},
          f"al rounds launches {round_launches}, want each of "
          f"{STAGE1_KERNELS} once per stage-1 step ({steps}) and no other")
    check(checked == [True], "a checkpoint loaded back differs from the "
          "state that was saved")
    check(len(losses) == 6 and all(math.isfinite(v) for aux in losses
                                   for v in aux.values()),
          f"bad round losses {losses}")
    check(sorted(results) == [1, 2] and all(
        math.isfinite(m) for m in results.values()), f"bad mIoU {results}")
    run = cfg.model_save_dir
    for f in ("datalist_01.json", "datalist_02.json",
              "my_random_selection_01.json", f"{sel2}_selection_02.json",
              "checkpoint01", "checkpoint02"):
        check(os.path.exists(os.path.join(run, f)), f"missing {f}")
    for r in (1, 2):
        check(per_round[r]["validations"] == AL_ITRS // AL_VAL_PERIOD,
              f"round {r}: {per_round[r]['validations']} validations")
    with open(os.path.join(run, f"{sel2}_selection_02.json")) as f:
        chosen = json.load(f)
    clicks = [int(label.multi_hot_cls[label.id_to_index[p.split(",")[1]
                                                        .split(".")[0]],
                                      i].sum()) for _, p, i in chosen]
    check(sum(clicks[:-1]) <= AL_BUDGET < sum(clicks),
          f"round 2 selected {sum(clicks)} clicks in {len(chosen)} regions "
          f"for a budget of {AL_BUDGET}")

    # pseudo-labelling of the label set with round 2's best checkpoint
    pcfg = Config(num_classes=NUM_CLASSES - 1, nseg=NSEG, dtype="bfloat16",
                  method=cfg.method)
    model = get_model(cfg.model, cfg.num_model_classes, cfg.output_stride,
                      separable_conv=True, device=dev)
    ckpt2 = os.path.join(run, "checkpoint02")
    model.load_state_dict(load_checkpoint(ckpt2)["model_state_dict"])
    gen = PseudoLabelGenerator(model, pcfg, "cosprop_includeonehot",
                               device=dev)
    plbl_dir = plbl_save_dir(ckpt2, "cosprop_includeonehot", "02")
    loader = DataProvider(label, 1, shuffle=False, drop_last=False,
                          infinite=False, num_workers=2)
    _sync(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    plbl_miou = gen.generate(None, loader, save_dir=plbl_dir,
                             suppix=label.suppix)[0]
    _sync(dev)
    plbl_s = time.perf_counter() - t0
    plbl_launches = dict(_build.LAUNCHES)
    loader.close()
    n_lbl = len(label)
    check(n_lbl == AL_POOL and plbl_launches == {"seg_max_fwd": n_lbl},
          f"plbl of {n_lbl} images launched {plbl_launches}, want "
          "seg_max_fwd once per image")
    check(math.isfinite(plbl_miou), f"bad plbl mIoU {plbl_miou}")
    for i in range(n_lbl):
        b = {k: (v[None] if isinstance(v, np.ndarray) else [v])
             for k, v in label[i].items()}
        want = gen.plbl_for_batch(b, label.suppix).to(torch.uint8).cpu()
        path = os.path.join(plbl_dir, b["fnames"][0][1])
        check(np.array_equal(read_gray8(path), want.numpy()),
              f"{path} does not decode to the generator's map")
    # K5 at this path's shapes, outside the counted windows: one label-set
    # image's softmax planes and ids, built as plbl_for_batch builds them
    b = {k: (v[None] if isinstance(v, np.ndarray) else [v])
         for k, v in label[0].items()}
    pixel_valid = gen.host_prep(b, label.suppix)[-1]
    _, logits = eval_forward(model, b["images"], gen.dev, gen.autocast,
                             return_feat=True, feat_bf16=gen.sim_bf16)
    planes = torch.softmax(logits[0].float(), dim=0).reshape(
        NUM_CLASSES, H * W).t()
    sid = torch.from_numpy(np.where(pixel_valid, b["spx"][0].reshape(-1),
                                    NSEG).astype(np.int32)).to(dev)
    k5_err = check_k5(planes, sid, f"al_rounds label image, {H}x{W}")
    print(f"K5 bitwise equal to its plain version on a label-set image "
          f"({H}x{W}, {int((sid < NSEG).sum())} of {H * W} pixels valid)",
          flush=True)
    del gen, model, logits, planes

    # stage 2 on the pseudo-labels, the images read back from RGB PNGs
    im_idx = []
    for key in label.im_idx:
        img = os.path.join(workdir, "images", key[0])
        os.makedirs(os.path.dirname(img), exist_ok=True)
        write_rgb8(img, label.images[label.id_to_index[key[1].split(".")[0]]])
        im_idx.append([img, key[1], key[2]])
    s2cfg = Config(method="active_predignore", stage2=True,
                   model_save_dir=run, **common)
    stage2 = RegionDatasetPlbl(s2cfg, im_idx, plbl_dir)
    # its items are built in worker processes: start them before the clock
    start_workers(s2cfg.num_workers)

    class Stage2Set:
        def get_trainset(self):
            return stage2

    s2losses = []
    _build.reset_launches()
    t0 = time.perf_counter()
    trainer = rounds.ALTrainer(s2cfg, 2, val_dataset=val,
                               eval_dataset=evalset, device=dev)
    trainer.load(init)
    check(torch.equal(trainer.model.classifier.proxy.detach().cpu(),
                      get_model(cfg.model, cfg.num_model_classes,
                                cfg.output_stride, separable_conv=True,
                                device="cpu").classifier.proxy.detach()),
          "stage 2: the init file's classifier was not stripped")
    trainer.checkpoint_file = os.path.join(run, "stage2_checkpoint02")
    s2_rate = trainer.train(Stage2Set(), metrics_cb=lambda it, aux:
                            s2losses.append(aux))
    if trainer.best_iou == 0.0:
        trainer.save()
    s2_miou, _ = trainer.eval()
    _sync(dev)
    s2_s = time.perf_counter() - t0
    s2_launches = dict(_build.LAUNCHES)
    check(s2_launches == {}, f"stage 2 launched kernels {s2_launches}")
    check(len(s2losses) == 3 and all(math.isfinite(a["train_loss"])
                                     for a in s2losses),
          f"bad stage-2 losses {s2losses}")
    check(os.path.exists(trainer.checkpoint_file) and math.isfinite(s2_miou),
          f"stage 2: no checkpoint or bad mIoU {s2_miou}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    del trainer
    torch.cuda.empty_cache()

    line = {"al_rounds": {
        "card": smi, "config": f"{cfg.model} separable, {NUM_CLASSES} "
        f"outputs, bf16, batch {B}, {H}x{W}, nseg {NSEG}, pool {AL_POOL}, "
        f"val/eval {AL_VAL}, {AL_ITRS} steps a round, budget {AL_BUDGET} "
        "clicks", "setup_s": setup_s, "rounds_s": rounds_s,
        "rounds": {r: {"select_s": sum(v["select_s"]),
                       "train_img_per_s": v["train_img_per_s"][0],
                       "train_s": v["train_s"][0],
                       "validations": v["validations"],
                       "eval_miou": results[r],
                       "checkpoint_save_s": v["save_s"],
                       "checkpoint_load_s": v["load_s"]}
                   for r, v in per_round.items()},
        "round2_regions": len(chosen), "round2_clicks": sum(clicks),
        "plbl_img_per_s": n_lbl / plbl_s, "plbl_miou": plbl_miou,
        "stage2_img_per_s": s2_rate, "stage2_s": s2_s,
        "stage2_miou": s2_miou, "stage2_loss": s2losses[-1]["train_loss"],
        "k5_max_abs_err": k5_err, "peak_mem_gib": peak_gib}}
    launches = Counter(round_launches) + Counter(plbl_launches)
    return line, dict(launches)


def recipe_commands(script, workdir, data_root):
    """The commands the port's recipe script issues, in order, recorded by
    a stub `python` on PATH (bash runs the script; nothing else runs)."""
    rec = os.path.join(workdir, "argv.jsonl")
    stub = os.path.join(workdir, "bin", "python")
    os.makedirs(os.path.dirname(stub), exist_ok=True)
    with open(stub, "w") as f:
        f.write("#!/bin/bash\npython3 - \"$@\" <<'EOF'\nimport json, sys\n"
                f"open({rec!r}, 'a').write(json.dumps(sys.argv[1:]) + "
                "'\\n')\nEOF\n")
    os.chmod(stub, 0o755)
    env = dict(os.environ, PATH=f"{os.path.dirname(stub)}:{os.environ['PATH']}",
               DATA_ROOT=data_root)
    subprocess.run(["bash", str(HERE / "mulactseg_tpu_torch" / "scripts" /
                                script)], check=True, env=env,
                   capture_output=True)
    with open(rec) as f:
        return [json.loads(line) for line in f]


def recipe_cut(argv, workdir, dl_dir, cuts):
    """The recipe's command (`-m module` dropped) with the phase's cuts:
    the flag values in `cuts` replaced, the checkpoint paths moved under
    workdir, and the datalist directory of the generated tree."""
    out = list(argv[2:])
    for i, a in enumerate(out):
        if a in cuts and i + 1 < len(out):
            out[i + 1] = str(cuts[a])
        elif a.startswith("checkpoint/"):
            out[i] = os.path.join(workdir, a)
    return out + ["--datalist_dir", dl_dir]


class _Stamped:
    """A train step that synchronises after each call and stamps its end;
    every other attribute (the step count, the optimizer) is the step's."""

    def __init__(self, fn, dev, stamps, losses):
        self.__dict__.update(fn=fn, dev=dev, stamps=stamps, losses=losses)

    def __call__(self, batch):
        aux = self.fn(batch)
        self.losses.append(float(aux["train_loss"]))
        _sync(self.dev)
        self.stamps.append(time.perf_counter())
        return aux

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __setattr__(self, name, value):
        setattr(self.fn, name, value)


def _epoch_rates(rec, batch):
    """Train img/s over the first epoch (cold decode cache) and over the
    rest (warm), validation time taken out of each window."""
    stamps, vals = rec["stamps"], rec["validations"]
    steps = len(stamps) - 1
    epoch = min(max(rec["images"] // batch, 1), steps)

    def rate(a, b):
        t = stamps[b] - stamps[a] - sum(t1 - t0 for t0, t1 in vals
                                         if stamps[a] <= t0 < stamps[b])
        return batch * (b - a) / t if b > a else None

    return rate(0, epoch), rate(epoch, steps)


def _loader_rate(ds, processes, workers):
    """Items per second of one pass of a DataProvider over ds (batch B)."""
    from mulactseg_tpu_torch.data.loader import DataProvider

    t0 = time.perf_counter()
    loader = DataProvider(ds, B, shuffle=False, drop_last=False,
                          infinite=False, num_workers=workers,
                          processes=processes)
    n = sum(len(b["fnames"]) for b in loader)
    loader.close()
    return n / (time.perf_counter() - t0)


def _fresh_copy(ds, root, dst):
    """ds over copies of its files under dst (paths below root kept), so
    no decode cache holds them."""
    out = copy.copy(ds)
    out.im_idx = [[os.path.join(dst, os.path.relpath(p, root)) for p in k]
                  for k in ds.im_idx]
    for old, new in zip(ds.im_idx, out.im_idx):
        for a, b in zip(old, new):
            os.makedirs(os.path.dirname(b), exist_ok=True)
            shutil.copyfile(a, b)
    out.suppix = {new[2]: ds.suppix[old[2]]
                  for old, new in zip(ds.im_idx, out.im_idx)}
    return out


def run_commands(dev, commands):
    """Runs the (name, main, argv) commands in order on dev, each through
    its CLI's main(argv, device=dev), with every launch counter set to 0
    just before it and read just after; each training's steps are
    stamped (a synchronise after each) with its validations, and each
    pseudo-labelling is timed. Returns (wall s, launches, results by
    command; the trainings' records and the pseudo-labellings' seconds in
    order; peak GiB)."""
    from mulactseg_tpu_torch.engine import rounds
    from mulactseg_tpu_torch.ops import _build
    from mulactseg_tpu_torch.plbl import generator

    trains, real_train = [], rounds.ALTrainer.train
    real_validate = rounds.ALTrainer.validate
    plbl_s, real_generate = [], generator.PseudoLabelGenerator.generate

    def train(self, active_set, *a, **k):
        rec = {"stamps": [time.perf_counter()], "validations": [],
               "losses": [], "images": len(active_set.get_trainset())}
        trains.append(rec)
        step = self.train_step
        self.train_step = _Stamped(step, dev, rec["stamps"], rec["losses"])
        try:
            rec["img_per_s"] = real_train(self, active_set, *a, **k)
        finally:
            self.train_step = step
        return rec["img_per_s"]

    def validate(self, trainiter):
        t1 = time.perf_counter()
        out = real_validate(self, trainiter)
        _sync(dev)
        trains[-1]["validations"].append((t1, time.perf_counter()))
        return out

    def generate(self, *a, **k):
        t1 = time.perf_counter()
        out = real_generate(self, *a, **k)
        _sync(dev)
        plbl_s.append(time.perf_counter() - t1)
        return out

    rounds.ALTrainer.train, rounds.ALTrainer.validate = train, validate
    generator.PseudoLabelGenerator.generate = generate
    wall, launches, results = {}, {}, {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        for name, fn, argv in commands:
            _sync(dev)
            _build.reset_launches()
            t1 = time.perf_counter()
            results[name] = fn(argv, device=dev)
            _sync(dev)
            wall[name] = time.perf_counter() - t1
            launches[name] = dict(_build.LAUNCHES)
    finally:
        rounds.ALTrainer.train, rounds.ALTrainer.validate = (real_train,
                                                             real_validate)
        generator.PseudoLabelGenerator.generate = real_generate
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    return wall, launches, results, trains, plbl_s, peak_gib


def cli_recipe_slice(variables, dev, smi, workdir):
    """The recipe's three commands over files (docstring, item 8b): a
    generated Cityscapes-format tree, the port recipe's command lines cut
    to CLI_ROUNDS rounds, each run through its CLI's main(argv). Returns
    (the cli_recipe line, the path's launches)."""
    from mulactseg_tpu_torch.cli import eval_al, train_al, train_stage2
    from mulactseg_tpu_torch.config import parse_config
    from mulactseg_tpu_torch.data import datasets
    from mulactseg_tpu_torch.data.loader import collate
    from mulactseg_tpu_torch.data.transforms import get_train_transform
    from mulactseg_tpu_torch.engine.checkpoint import save_checkpoint
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.models.factory import get_model
    from mulactseg_tpu_torch.plbl import generator
    from mulactseg_tpu_torch.tools.cityscapes_tree import write_tree
    from mulactseg_tpu_torch.utils.png import read_gray8, read_rgb8

    t0 = time.perf_counter()
    root = os.path.join(workdir, "data")
    dl_dir = write_tree(root, CLI_TRAIN, CLI_VAL, PH, PW, NSEG, seed=0,
                        encoding="adaptive", processes=os.cpu_count() or 1)
    tree_s = time.perf_counter() - t0
    cmds = recipe_commands("train_city_mul_res50.sh", workdir, root)
    modules = ["train_al"] + ["eval_al", "train_stage2"] * 5
    check([c[:2] for c in cmds] == [["-m", f"mulactseg_tpu_torch.cli.{m}"]
                                    for m in modules],
          f"the recipe issued {[c[:2] for c in cmds]}")
    budget = round(CLI_TRAIN * 100_000 / 2_975)  # the recipe's clicks/image
    cuts = {"--finetune_itrs": CLI_ITRS, "--val_period": CLI_VAL_PERIOD,
            "--max_iterations": CLI_ROUNDS}
    stage1 = recipe_cut(cmds[0], workdir, dl_dir,
                        {**cuts, "--active_selection_size": budget})
    init = stage1[stage1.index("--init_checkpoint") + 1]
    check("imagenet_pretrained" in init, f"init {init}")
    model = get_model("deeplabv3pluswn_resnet50deepstem", NUM_CLASSES, 16,
                      separable_conv=True, device="cpu")
    convert.load_variables(model, variables)
    save_checkpoint(init, model)  # the seeded stand-in of the ImageNet init
    del model
    run = stage1[stage1.index("-p") + 1]
    commands = [("train_al", train_al.main, stage1)]
    for r in range(1, CLI_ROUNDS + 1):
        commands += [
            (f"eval_al_{r:02d}", eval_al.main,
             recipe_cut(cmds[2 * r - 1], workdir, dl_dir, cuts)),
            (f"train_stage2_{r:02d}", train_stage2.main,
             recipe_cut(cmds[2 * r], workdir, dl_dir, cuts))]
    wall, launches, results, trains, plbl_s, peak_gib = run_commands(
        dev, commands)

    steps = CLI_ROUNDS * CLI_ITRS
    check(launches["train_al"] == {k: steps for k in STAGE1_KERNELS},
          f"train_al launched {launches['train_al']}, want each of "
          f"{STAGE1_KERNELS} once per stage-1 step ({steps}) and no other")
    check(sorted(results["train_al"]) == list(range(1, CLI_ROUNDS + 1)) and
          all(math.isfinite(m) for m in results["train_al"].values()),
          f"bad train_al mIoU {results['train_al']}")
    check(len(trains) == 2 * CLI_ROUNDS and all(
        len(t["losses"]) == CLI_ITRS and all(map(math.isfinite, t["losses"]))
        and len(t["validations"]) == CLI_ITRS // CLI_VAL_PERIOD
        for t in trains), "a training ran other steps or validations, or a "
          "loss is not finite: " + str([(t["losses"], len(t["validations"]))
                                        for t in trains]))
    line_rounds = {}
    for r in range(1, CLI_ROUNDS + 1):
        with open(os.path.join(run, f"datalist_{r:02d}.json")) as f:
            labelled = json.load(f)["trg_label_im_idx"]
        plbl_dir = generator.plbl_save_dir(
            os.path.join(run, f"checkpoint{r:02d}"), "cosprop_includeonehot",
            f"{r:02d}")
        pngs = sorted(os.listdir(plbl_dir))
        check(len(pngs) == len(labelled) and pngs == sorted(
            os.path.basename(l).split(".")[0] + ".png" for _, l, _ in
            labelled), f"round {r}: {len(pngs)} pseudo-label PNGs for "
              f"{len(labelled)} labelled images")
        for p in pngs:  # every PNG decodes to a map of the image's size
            check(read_gray8(os.path.join(plbl_dir, p)).shape == (PH, PW),
                  f"{p}: bad pseudo-label map")
        check(launches[f"eval_al_{r:02d}"] == {"seg_max_fwd": len(labelled)},
              f"eval_al round {r} launched {launches[f'eval_al_{r:02d}']}, "
              f"want seg_max_fwd once per labelled image ({len(labelled)})")
        check(launches[f"train_stage2_{r:02d}"] == {},
              f"stage 2 launched {launches[f'train_stage2_{r:02d}']}")
        s2_miou = results[f"train_stage2_{r:02d}"]
        check(math.isfinite(results[f"eval_al_{r:02d}"]) and
              math.isfinite(s2_miou) and os.path.exists(os.path.join(
                  run, f"stage2_checkpoint{r:02d}")),
              f"round {r}: bad plbl or stage-2 result")
        s1, s2 = trains[r - 1], trains[CLI_ROUNDS + r - 1]
        cold, warm = _epoch_rates(s1, B)
        s2_cold, s2_warm = _epoch_rates(s2, B)
        line_rounds[r] = {
            "labelled_images": len(labelled), "plbl_pngs": len(pngs),
            "train_img_per_s": s1["img_per_s"], "train_cold_img_per_s": cold,
            "train_warm_img_per_s": warm, "eval_miou": results["train_al"][r],
            "plbl_img_per_s": len(labelled) / plbl_s[r - 1],
            "plbl_miou": results[f"eval_al_{r:02d}"],
            "stage2_img_per_s": s2["img_per_s"],
            "stage2_cold_img_per_s": s2_cold,
            "stage2_warm_img_per_s": s2_warm, "stage2_miou": s2_miou}

    # the loader alone: one pass over fresh copies of the training files
    # (cold caches) on worker processes and on threads, as many as cores
    cfg = parse_config(stage1)
    label = datasets.RegionDatasetOr(
        cfg, cfg.trg_datalist, cfg.region_dict, "active-label",
        transform=get_train_transform(cfg.train_transform, cfg,
                                      seed=cfg.seed))
    workers = min(8, os.cpu_count() or 1)
    rates = {}
    for mode in ("processes", "threads"):
        ds = _fresh_copy(label, root, os.path.join(workdir, mode))
        rates[mode] = _loader_rate(ds, mode == "processes", workers)
    # a file-backed item by part, in this process: decoding (the image PNG,
    # the superpixel pickle), the rest of the item (crop, resample,
    # normalise, bits) over decoded files, the batch's copy to the card
    img_p, _, spx_p = label.im_idx[0]
    t1 = time.perf_counter()
    read_rgb8(img_p)
    t2 = time.perf_counter()
    datasets._open_spx_impl(spx_p)
    t3 = time.perf_counter()
    for i in range(B):  # fills this process's decode cache
        label[i]
    t4 = time.perf_counter()
    batch = collate([label[i] for i in range(B)])
    t5 = time.perf_counter()
    _sync(dev)
    t6 = time.perf_counter()
    for k in ("images", "target_bits", "target", "spx"):
        torch.as_tensor(batch[k]).to(dev)
    _sync(dev)
    t7 = time.perf_counter()
    datasets._decode_cache.clear()

    line = {"cli_recipe": {
        "card": smi, "config": f"{cfg.model} separable, {NUM_CLASSES} "
        f"outputs, {cfg.dtype}, batch {cfg.train_batch_size}, crop "
        f"{cfg.crop_size[0]}x{cfg.crop_size[1]}, nseg {cfg.nseg}, the "
        f"recipe's flags; tree: {CLI_TRAIN} train and {CLI_VAL} val images "
        f"at {PH}x{PW}, adaptive-filtered RGB PNGs, .pkl superpixels",
        "cuts": {"finetune_itrs": CLI_ITRS, "val_period": CLI_VAL_PERIOD,
                 "max_iterations": CLI_ROUNDS,
                 "active_selection_size": budget,
                 "init": "seeded stand-in of the ImageNet init",
                 "stage-2 rounds": CLI_ROUNDS},
        "tree_s": tree_s, "command_s": wall, "rounds": line_rounds,
        "loader_files_per_s": {**rates, "workers": workers},
        "item_ms": {"decode_image_png": (t2 - t1) * 1e3,
                    "decode_superpixel_pkl": (t3 - t2) * 1e3,
                    "transform_and_bits": (t5 - t4) / B * 1e3,
                    "batch_to_card": (t7 - t6) * 1e3},
        "launches": {k: v for k, v in launches.items() if v},
        "peak_mem_gib": peak_gib}}
    total = Counter()
    for v in launches.values():
        total.update(v)
    return line, dict(total)


def voc_recipe_slice(dev, smi, workdir):
    """The VOC recipe's commands over files (docstring, item 8c): a
    generated VOC-format tree, the kernel instances of VOC stage 1 held
    against their plain versions, the port's VOC script cut to VOC_ROUNDS
    rounds and run through the CLIs' main(argv), and K5 held on a TTA
    pseudo-labelling image. Returns (the voc_recipe line, the path's
    launches, the kernels-line rows of the VOC instances)."""
    from mulactseg_tpu_torch.cli import eval_al, train_al, train_stage2
    from mulactseg_tpu_torch.cli.common import build_active_datasets
    from mulactseg_tpu_torch.config import parse_config
    from mulactseg_tpu_torch.data import datasets
    from mulactseg_tpu_torch.data.loader import collate
    from mulactseg_tpu_torch.data.transforms import get_train_transform
    from mulactseg_tpu_torch.engine.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from mulactseg_tpu_torch.engine.tta import tta_feat_forward
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.models.factory import get_model
    from mulactseg_tpu_torch.ops import segment_max
    from mulactseg_tpu_torch.plbl import generator
    from mulactseg_tpu_torch.tools.voc_tree import write_tree
    from mulactseg_tpu_torch.utils import jpeg
    from mulactseg_tpu_torch.utils.png import read_gray8

    t0 = time.perf_counter()
    root = os.path.join(workdir, "data")
    dl_dir = write_tree(root, VOC_TRAIN, VOC_VAL, VOC_NSEG, seed=0)
    tree_s = time.perf_counter() - t0
    cmds = recipe_commands("train_voc_mul_res50.sh", workdir, root)
    modules = ["train_al"] + ["eval_al", "train_stage2"] * 5
    check([c[:2] for c in cmds] == [["-m", f"mulactseg_tpu_torch.cli.{m}"]
                                    for m in modules],
          f"the VOC recipe issued {[c[:2] for c in cmds]}")
    budget = round(VOC_TRAIN * 10_000 / 1_464)  # the recipe's clicks/image
    stage1 = recipe_cut(cmds[0], workdir, dl_dir, {
        "--finetune_itrs": VOC_ITRS, "--val_period": VOC_VAL_PERIOD,
        "--max_iterations": VOC_ROUNDS, "--active_selection_size": budget})
    cfg = parse_config(stage1)
    check((cfg.dataset, cfg.num_classes, cfg.train_batch_size,
           cfg.crop_size, cfg.nseg, cfg.dtype) == (
              "voc", VOC_CLASSES, VOC_B, (VOC_CROP, VOC_CROP), VOC_NSEG,
              "bfloat16"), f"the VOC stage-1 command parsed to {cfg}")
    init = stage1[stage1.index("--init_checkpoint") + 1]
    check("imagenet_pretrained" in init, f"init {init}")
    model = get_model(cfg.model, VOC_CLASSES, 16, separable_conv=True,
                      device="cpu")
    convert.load_variables(model, convert.random_variables(model, seed=0))
    save_checkpoint(init, model)  # the seeded stand-in of the ImageNet init
    model.to(dev).eval()

    # the VOC instances of K1-K4 (C = 21 at run time; HW = 513 * 513 is
    # odd, so the 4-byte path): a stage-1 batch of the tree's files, half
    # of each image's superpixels selected, through the seeded model
    label = datasets.RegionDatasetOr(
        cfg, cfg.trg_datalist, cfg.region_dict, "active-label",
        transform=get_train_transform(cfg.train_transform, cfg,
                                      seed=cfg.seed),
        encode_fn=datasets.encode_identity)
    rng = np.random.RandomState(0)
    for k, ids in label.suppix.items():
        label.suppix[k] = sorted(rng.choice(ids, len(ids) // 2,
                                            replace=False).tolist())
    batch = collate([label[i % len(label)] for i in range(VOC_B)])
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        logits = model(torch.as_tensor(batch["images"]).to(dev))
    check(logits.shape == (VOC_B, VOC_CLASSES, VOC_CROP, VOC_CROP)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), "bad VOC model logits")
    shape = f"voc ({VOC_B}, {VOC_CLASSES}, {VOC_CROP * VOC_CROP})"
    rows = kernel_checks(logits, batch, dev, nseg=VOC_NSEG,
                         label=f"@{shape}")
    del logits, batch, label
    model.cpu()
    torch.cuda.empty_cache()

    run = stage1[stage1.index("-p") + 1]
    s2_cuts = {"--finetune_itrs": VOC_S2_ITRS,
               "--val_period": VOC_S2_VAL_PERIOD}
    commands = [("train_al", train_al.main, stage1)]
    for r in range(1, VOC_ROUNDS + 1):
        commands += [
            (f"eval_al_{r:02d}", eval_al.main,
             recipe_cut(cmds[2 * r - 1], workdir, dl_dir, {})),
            (f"train_stage2_{r:02d}", train_stage2.main,
             recipe_cut(cmds[2 * r], workdir, dl_dir, s2_cuts))]
    wall, launches, results, trains, plbl_s, peak_gib = run_commands(
        dev, commands)

    steps = VOC_ROUNDS * VOC_ITRS
    check(launches["train_al"] == {k: steps for k in STAGE1_KERNELS},
          f"VOC train_al launched {launches['train_al']}, want each of "
          f"{STAGE1_KERNELS} once per stage-1 step ({steps}) and no other")
    check(sorted(results["train_al"]) == list(range(1, VOC_ROUNDS + 1)) and
          all(math.isfinite(m) for m in results["train_al"].values()),
          f"bad VOC train_al mIoU {results['train_al']}")
    want = ([(VOC_ITRS, VOC_ITRS // VOC_VAL_PERIOD)] * VOC_ROUNDS
            + [(VOC_S2_ITRS, VOC_S2_ITRS // VOC_S2_VAL_PERIOD)] * VOC_ROUNDS)
    check([(len(t["losses"]), len(t["validations"])) for t in trains] == want
          and all(math.isfinite(x) for t in trains for x in t["losses"]),
          "a VOC training ran other steps or validations, or a loss is not "
          "finite: " + str([(t["losses"], len(t["validations"]))
                            for t in trains]))
    line_rounds, last = {}, None
    for r in range(1, VOC_ROUNDS + 1):
        with open(os.path.join(run, f"datalist_{r:02d}.json")) as f:
            labelled = json.load(f)["trg_label_im_idx"]
        plbl_dir = generator.plbl_save_dir(
            os.path.join(run, f"checkpoint{r:02d}"), "cosprop_includeonehot",
            f"{r:02d}")
        pngs = sorted(os.listdir(plbl_dir))
        check(len(pngs) == len(labelled) and pngs == sorted(
            os.path.basename(l).split(".")[0] + ".png" for _, l, _ in
            labelled), f"VOC round {r}: {len(pngs)} pseudo-label PNGs for "
              f"{len(labelled)} labelled images")
        for img, lbl, _ in labelled:  # each the size of its image
            p = os.path.join(plbl_dir,
                             os.path.basename(lbl).split(".")[0] + ".png")
            check(read_gray8(p).shape == jpeg.jpeg_size(img),
                  f"{p}: not a map of its image's size")
        check(launches[f"eval_al_{r:02d}"] == {"seg_max_fwd": len(labelled)},
              f"VOC eval_al round {r} launched "
              f"{launches[f'eval_al_{r:02d}']}, want seg_max_fwd once per "
              f"labelled image ({len(labelled)})")
        check(launches[f"train_stage2_{r:02d}"] == {},
              f"VOC stage 2 launched {launches[f'train_stage2_{r:02d}']}")
        s2_miou = results[f"train_stage2_{r:02d}"]
        check(math.isfinite(results[f"eval_al_{r:02d}"]) and
              math.isfinite(s2_miou) and os.path.exists(os.path.join(
                  run, f"stage2_checkpoint{r:02d}")),
              f"VOC round {r}: bad plbl or stage-2 result")
        s1, s2 = trains[r - 1], trains[VOC_ROUNDS + r - 1]
        cold, warm = _epoch_rates(s1, VOC_B)
        s2_batch = parse_config(commands[2 * r][2]).train_batch_size
        s2_cold, s2_warm = _epoch_rates(s2, s2_batch)
        line_rounds[r] = {
            "labelled_images": len(labelled), "plbl_pngs": len(pngs),
            "train_img_per_s": s1["img_per_s"], "train_cold_img_per_s": cold,
            "train_warm_img_per_s": warm, "eval_miou": results["train_al"][r],
            "plbl_img_per_s": len(labelled) / plbl_s[r - 1],
            "plbl_miou": results[f"eval_al_{r:02d}"],
            "stage2_batch": s2_batch, "stage2_img_per_s": s2["img_per_s"],
            "stage2_cold_img_per_s": s2_cold,
            "stage2_warm_img_per_s": s2_warm, "stage2_miou": s2_miou}
        last = commands[2 * r - 1][2]

    # K5 on one pseudo-labelling image of the last round, its planes as the
    # generator builds them: the TTA softmax of the round's checkpoint
    # under the image's selected superpixels
    ecfg = parse_config(last)
    active, _ = build_active_datasets(ecfg)
    active.selection_iter = ecfg.init_iteration
    active.load_datalist(ecfg.datalist_path)
    lds = active.trg_label_dataset
    item = datasets.EvalRegionDatasetAll(ecfg, lds, lds.suppix,
                                         emit_u8=True)[0]
    model.load_state_dict(load_checkpoint(ecfg.resume_checkpoint)[
        "model_state_dict"])
    model.to(dev)
    _, logits = tta_feat_forward(model, item["images"][None], dev, True)
    h, w = item["spx"].shape
    P = h * w
    planes = torch.softmax(logits[0].float(), dim=0).reshape(
        VOC_CLASSES, P).t()
    sid = torch.from_numpy(np.where(item["spmask"], item["spx"], VOC_NSEG)
                           .reshape(-1).astype(np.int32)).to(dev)
    k5_err = check_k5(planes, sid, f"VOC plbl image, {h}x{w}",
                      nseg=VOC_NSEG)
    n_valid = int((sid < VOC_NSEG).sum())
    rows.append((
        f"seg_max_fwd@voc plbl ({P}, {VOC_CLASSES}), {VOC_NSEG} segments",
        k5_err,
        time_ms(lambda: segment_max.seg_max_fwd(planes, sid, VOC_NSEG),
                graph=True),
        time_ms(lambda: segment_max.segment_max_plain(planes, sid,
                                                      VOC_NSEG)),
        bound(P * 4 + n_valid * VOC_CLASSES * 4 + VOC_NSEG * VOC_CLASSES * 8,
              n_valid * VOC_CLASSES), None))
    del model, logits, planes
    torch.cuda.empty_cache()

    # JPEG decoding, a file of the tree at a time, in this process
    decode_ms = []
    for img, _, _ in datasets.RegionDatasetOr(
            cfg, cfg.trg_datalist, cfg.region_dict, "active-ulabel",
            encode_fn=datasets.encode_identity).im_idx:
        t1 = time.perf_counter()
        jpeg.read_rgb8(img)
        decode_ms.append((time.perf_counter() - t1) * 1e3)

    line = {"voc_recipe": {
        "card": smi, "config": f"{cfg.model} separable, {VOC_CLASSES} "
        f"outputs, {cfg.dtype}, batch {VOC_B}, crop {VOC_CROP}x{VOC_CROP}, "
        f"nseg {VOC_NSEG}, the VOC recipe's flags (10-view TTA plbl); tree: "
        f"{VOC_TRAIN} train and {VOC_VAL} val images at VOC's sizes, "
        "baseline 4:2:0 JPEGs (quality 75), palette label PNGs, .pkl "
        "superpixels",
        "cuts": {"finetune_itrs": VOC_ITRS, "val_period": VOC_VAL_PERIOD,
                 "max_iterations": VOC_ROUNDS,
                 "active_selection_size": budget,
                 "stage-2 finetune_itrs": VOC_S2_ITRS,
                 "stage-2 val_period": VOC_S2_VAL_PERIOD,
                 "init": "seeded stand-in of the ImageNet init",
                 "stage-2 rounds": VOC_ROUNDS},
        "tree_s": tree_s, "command_s": wall, "rounds": line_rounds,
        "jpeg_decode_ms_per_file": statistics.median(decode_ms),
        "jpeg_decode_ms_range": [min(decode_ms), max(decode_ms)],
        "k5_plbl_image": {"pixels": P, "valid": n_valid,
                          "max_abs_err": k5_err},
        "launches": {k: v for k, v in launches.items() if v},
        "peak_mem_gib": peak_gib}}
    total = Counter()
    for v in launches.values():
        total.update(v)
    return line, dict(total), rows


def small_selector_check(dev, variables):
    """The paper's selector on the card against the CPU: the full-width
    model with the seeded weights in float32 (TF32 off) on two 96x80
    images, nseg 24; scores within 1e-4, the same selected regions."""
    from mulactseg_tpu_torch.acquisition import get_selector
    from mulactseg_tpu_torch.active import RegionActiveSet
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.data.synthetic import SyntheticRegionDataset
    from mulactseg_tpu_torch.engine.rounds import ALTrainer
    from mulactseg_tpu_torch.models import convert

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for d in ("cpu", dev):
            cfg = Config(num_classes=NUM_CLASSES - 1, nseg=24,
                         dtype="float32", separable_conv=True,
                         val_batch_size=2, val_num_workers=1,
                         model_save_dir=os.path.join(tmp, str(d)))
            kw = dict(n_images=2, H=96, W=80, num_classes=NUM_CLASSES - 1,
                      nseg=24, seed=5)
            pool = SyntheticRegionDataset(split="active-ulabel", **kw)
            label = SyntheticRegionDataset(**kw)
            label.suppix, label.im_idx = {}, []
            trainer = ALTrainer(cfg, 2, device=d)
            convert.load_variables(trainer.model, variables)
            sel = get_selector("my_bvsb_predclsbal_pwr_banignore", cfg)
            scores = sel.calculate_scores(trainer, pool)
            sel.select_next_batch(trainer, RegionActiveSet(cfg, pool, label),
                                  12)
            out[str(d)] = (scores, label.suppix)
    (cs, cl), (gs, gl) = out["cpu"], out[str(dev)]
    err = max(abs(a[0] - b[0]) for a, b in zip(cs, gs))
    check([s[1:] for s in cs] == [s[1:] for s in gs] and err <= 1e-4,
          f"small selector: card scores differ from the CPU by {err}")
    check(cl == gl and sum(len(v) for v in cl.values()) > 0,
          f"small selector: card selected {gl}, CPU {cl}")
    print(f"small selector (96x80, nseg 24, float32): scores within {err} "
          f"of the CPU, the same {sum(len(v) for v in cl.values())} regions",
          flush=True)
    return err


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available()"
                 " is False")
    import mulactseg_tpu_torch

    check(Path(mulactseg_tpu_torch.__file__).resolve().parents[1] == HERE,
          "mulactseg_tpu_torch must come from this checkout")
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.data.loader import shutdown_workers
    from mulactseg_tpu_torch.engine.train import make_train_step
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.models.factory import get_model
    # pixel_loss, segment and segment_max set their sources' -D constants
    # before the build
    from mulactseg_tpu_torch.ops import _build, pixel_loss, segment  # noqa: F401

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    card = f"{smi} (torch {torch.__version__}, CUDA {torch.version.cuda})"
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    reports = _build.build_all(["pixel_loss", "segment", "segment_max",
                                "prereduce"])
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s (parallel nvcc, sm_90a)", flush=True)
    for name, log in reports.items():
        for line in ptxas_summary(log):
            print(f"  {name}: {line}")

    cfg = Config(num_classes=NUM_CLASSES - 1, nseg=NSEG, crop_size=(H, W),
                 train_batch_size=B, dtype="bfloat16", separable_conv=True,
                 method="active_joint_multi_predignore_lossdecomp")
    t0 = time.perf_counter()
    model = get_model(cfg.model, cfg.num_model_classes, cfg.output_stride,
                      separable_conv=cfg.separable_conv, device=dev)
    variables = convert.random_variables(model, seed=0)
    convert.load_variables(model, variables)
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
    batches_large = make_batches(2, seed=1, nseg=NSEG_LARGE)
    large_rows, row_inputs, k4_pre_err = large_kernel_checks(
        logits, batches_large[0], dev)
    # K4's row gives its larger error of the two forward branches
    rows = [(n, max(e, k4_pre_err) if n == "ssm_bwd" else e, *rest)
            for n, e, *rest in rows]
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
    check(set(launches) == set(STAGE1_KERNELS),
          f"stage-1 launches {launches}, want {STAGE1_KERNELS}")
    for name in STAGE1_KERNELS:
        check(launches[name] == steps,
              f"{name} launched {launches[name]} times in {steps} steps")
    losses = {k: float(v) for k, v in aux.items()}
    check(all(math.isfinite(v) for v in losses.values()),
          f"non-finite loss {losses}")

    stage1_launches = launches

    # past the K3 guard: nseg 4096, from the seeded weights again. Every
    # timed run comes before the first torch.profiler pass, whose tracing
    # may stay armed and slow the host for the rest of the process.
    del step
    torch.cuda.empty_cache()
    convert.load_variables(model, variables)
    lcfg = Config(num_classes=NUM_CLASSES - 1, nseg=NSEG_LARGE,
                  crop_size=(H, W), train_batch_size=B, dtype="bfloat16",
                  separable_conv=True, method=cfg.method)
    lstep = make_train_step(model, lcfg, device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    for i in range(WARMUP_LARGE):
        aux = lstep(batches_large[i % len(batches_large)])
    torch.cuda.synchronize()
    large_window_s = []
    for _ in range(TIMED_LARGE // WINDOW):
        ts = time.perf_counter()
        for i in range(WINDOW):
            aux = lstep(batches_large[i % len(batches_large)])
        torch.cuda.synchronize()
        large_window_s.append(time.perf_counter() - ts)
    large_launches = dict(_build.LAUNCHES)
    large_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    large_steps = WARMUP_LARGE + TIMED_LARGE
    check(large_launches == {k: large_steps for k in STAGE1_LARGE_KERNELS},
          f"nseg {NSEG_LARGE} launches {large_launches}, want each of "
          f"{STAGE1_LARGE_KERNELS} once per step and no ssm_fwd (K3)")
    large_losses = {k: float(v) for k, v in aux.items()}
    check(all(math.isfinite(v) for v in large_losses.values()),
          f"non-finite loss at nseg {NSEG_LARGE}: {large_losses}")
    del lstep

    row_launches, row_losses = row_op_pass(*row_inputs)
    del row_inputs
    print(json.dumps({"row_ops": row_losses}), flush=True)
    small_reference_check(dev)
    bad, flips = small_reference_check(dev, h=192, w=192, nseg=4608)
    print(f"small lossdecomp past the guard (192x192, nseg 4608): {flips} "
          f"K6 values round differently on the card, {bad} gradient entries "
          "outside 1e-5 (all in their segments)", flush=True)

    # the active-learning main path (rounds, plbl, stage 2), from a file of
    # the seeded weights; it comes before the first profiler pass too
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        al_line, al_launches = al_rounds_slice(variables, dev, smi, tmp)
    small_selector_check(dev, variables)
    # the recipe's three commands over files on disk, after the rounds
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        cli_line, cli_launches = cli_recipe_slice(variables, dev, smi, tmp)
    shutdown_workers()  # the loader's worker processes
    print(json.dumps(cli_line), flush=True)
    # the VOC recipe's commands over a VOC-format tree, its kernel
    # instances held first
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        voc_line, voc_launches, voc_rows = voc_recipe_slice(dev, smi, tmp)
    shutdown_workers()
    print(json.dumps(voc_line), flush=True)

    # evaluation and pseudo-labelling at 1024x2048, from the seeded weights
    # again (BN in eval mode reads the running statistics)
    torch.cuda.empty_cache()
    convert.load_variables(model, variables)
    name, err, *rest = k5_checks(model, dev)  # K5 also held at al_rounds'
    rows.append((name, max(err, al_line["al_rounds"]["k5_max_abs_err"]),
                 *rest))
    pcfg = Config(num_classes=NUM_CLASSES - 1, nseg=NSEG, dtype="bfloat16",
                  method=cfg.method)
    eval_stats = eval_slice(model, pcfg, dev)
    print(json.dumps(eval_stats), flush=True)
    plbl_stats, plbl_launches = plbl_slice(model, pcfg, dev)
    small_plbl_check(dev)
    for c, b in ((cfg, batches), (lcfg, batches_large)):
        gen = torch.Generator(dev).manual_seed(0)
        profile_steps(make_train_step(model, c, device=dev, generator=gen), b,
                      f"stage-1, nseg {c.nseg}")
    rows += large_rows + voc_rows
    # each kernel's launches on each main path that runs it, and their sum
    by_path = {f"stage1_nseg{NSEG}": stage1_launches,
               f"stage1_nseg{NSEG_LARGE}": large_launches,
               "plbl": plbl_launches, "row_ops": row_launches,
               "al_rounds": al_launches, "cli_recipe": cli_launches,
               "voc": voc_launches}
    launches = sum((Counter(n) for n in by_path.values()), Counter())
    check(all(launches[name] > 0 for name in KERNELS),
          f"a kernel was never launched on a main path: {dict(launches)}")

    print(json.dumps({
        "slice": "cityscapes stage-1 train step", "card": smi,
        "img_per_s": B * TIMED / dt, "step_ms": dt / TIMED * 1e3,
        "window_step_ms": [t / WINDOW * 1e3 for t in window_s],
        "timed_steps": TIMED,
        "steps": steps, "peak_mem_gib": peak_gib,
        "ce_loss": losses["ce_loss"], "mc_loss": losses["mc_loss"],
        "group_loss": losses["group_loss"],
        "train_loss": losses["train_loss"]}))
    large_dt = sum(large_window_s)
    print(json.dumps({
        "slice": f"cityscapes stage-1 train step, nseg {NSEG_LARGE} "
                 "(pre-reduced group term)", "card": smi,
        "img_per_s": B * TIMED_LARGE / large_dt,
        "step_ms": large_dt / TIMED_LARGE * 1e3,
        "window_step_ms": [t / WINDOW * 1e3 for t in large_window_s],
        "timed_steps": TIMED_LARGE, "steps": large_steps,
        "peak_mem_gib": large_peak_gib, **large_losses}))
    print(json.dumps(plbl_stats))
    print(json.dumps(al_line))
    kernels = []
    for label, err, ms, plain_ms, (bound_ms, bound_by), lib_ms in rows:
        # a kernel timed at a second shape is labelled name@shape
        name, _, shape = label.partition("@")
        tag, source, replaces = KERNELS[name]
        kernels.append({
            "name": f"{tag} {name}" + (f" ({shape})" if shape else ""),
            "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_by_path": {path: n[name] for path, n in by_path.items()
                                 if n.get(name)},
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
