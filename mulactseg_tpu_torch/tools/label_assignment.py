"""Offline multi-hot and dominant label generation: the port's copy of
mulactseg_tpu/tools/label_assignment.py.

The tensor mode writes the multi_hot_cls.npy (N, nseg, C+1), sp_size.npy
and sp_gt_size.npy tensors that data/datasets.RegionDatasetOr and the
research rewrites read (the reference's tools/label_assignment_tensor.py:
50-67), vectorised: per image one boundary pass and one bincount over
(superpixel, class) pairs. The dominant mode writes one
gtFine_dominant*-style PNG per image, every pixel its superpixel's most
frequent class, that data/datasets.RegionDatasetDominant reads (the
reference's label_assignment_dominant.py). Files are read and written
with utils/png.py.

Boundary trim: superpixel boundaries (4-neighbor 'thick' mode) dilated
with a k x k kernel are excluded from each superpixel's histogram unless
that removes the superpixel entirely, in which case the untrimmed
histogram is used (region_cityscapes_tensor.py:42-59).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def boundaries_thick(spx: np.ndarray) -> np.ndarray:
    """4-neighbor thick-mode boundaries (skimage find_boundaries parity)."""
    b = np.zeros(spx.shape, bool)
    b[:-1] |= spx[:-1] != spx[1:]
    b[1:] |= spx[1:] != spx[:-1]
    b[:, :-1] |= spx[:, :-1] != spx[:, 1:]
    b[:, 1:] |= spx[:, 1:] != spx[:, :-1]
    return b


def dilate_square(mask: np.ndarray, k: int) -> np.ndarray:
    """Binary dilation with a k x k all-ones kernel via two 1-D passes."""
    r = k // 2
    m = mask.astype(np.uint8)
    H, W = m.shape
    pad = np.pad(m, ((r, k - 1 - r), (0, 0)))
    vert = np.zeros_like(m)
    for dy in range(k):
        vert |= pad[dy:dy + H]
    pad = np.pad(vert, ((0, 0), (r, k - 1 - r)))
    out = np.zeros_like(m)
    for dx in range(k):
        out |= pad[:, dx:dx + W]
    return out.astype(bool)


def _hist(spx_flat, gt_flat, nseg, num_classes, ignore_idx):
    """(nseg, C+1) presence counts; ignore pixels feed the last channel."""
    cls = np.where(gt_flat == ignore_idx, num_classes, gt_flat).astype(np.int64)
    ok = (spx_flat >= 0) & (spx_flat < nseg)
    key = spx_flat[ok] * (num_classes + 1) + cls[ok]
    counts = np.bincount(key, minlength=nseg * (num_classes + 1))
    return counts.reshape(nseg, num_classes + 1)


def multi_hot_for_image(gt: np.ndarray, spx: np.ndarray, nseg: int,
                        num_classes: int, ignore_idx: int = 255,
                        trim: bool = True, trim_kernel: int = 5,
                        return_class_sizes: bool = False):
    """Returns (multi_hot (nseg, C+1) uint8, sizes (nseg,) int32 with -1
    for absent superpixels[, class_sizes (nseg, C+1) int32 — the per-class
    GT pixel counts behind the multi-hot, -1 rows for absent superpixels;
    this is the `sp_gt_size.npy` tensor the *_gt research loaders consume,
    whose generator the reference repo does not ship])."""
    spx_f = spx.reshape(-1)
    gt_f = gt.reshape(-1)
    full = _hist(spx_f, gt_f, nseg, num_classes, ignore_idx)
    sizes_full = full.sum(1)
    if trim:
        bdry = dilate_square(boundaries_thick(spx), trim_kernel)
        spx_t = np.where(bdry.reshape(-1), nseg, spx_f)
        trimmed = _hist(spx_t, gt_f, nseg, num_classes, ignore_idx)
        sizes_t = trimmed.sum(1)
        vanished = (sizes_t == 0) & (sizes_full > 0)
        counts = np.where(vanished[:, None], full, trimmed)
        sizes = np.where(vanished, sizes_full, sizes_t)
    else:
        counts, sizes = full, sizes_full
    mh = (counts > 0).astype(np.uint8)
    sizes = np.where(sizes_full > 0, sizes, -1).astype(np.int32)
    mh[sizes_full == 0] = 0
    if return_class_sizes:
        cls_sizes = np.where(sizes_full[:, None] > 0, counts, -1).astype(
            np.int32)
        return mh, sizes, cls_sizes
    return mh, sizes


def dominant_label_for_image(gt: np.ndarray, spx: np.ndarray, nseg: int,
                             num_classes: int, ignore_idx: int = 255,
                             count_ignore: bool = True) -> np.ndarray:
    """Per-pixel dominant-class map: every pixel takes its superpixel's
    most frequent class (label_assignment_dominant.py). With
    count_ignore, the ignore class competes and wins as 255."""
    spx_f = spx.reshape(-1)
    gt_f = gt.reshape(-1)
    hist = _hist(spx_f, gt_f, nseg, num_classes, ignore_idx).astype(np.int64)
    if not count_ignore:
        hist[:, -1] = -1
    dom = hist.argmax(1)
    dom = np.where(hist.max(1) <= 0, num_classes, dom)
    dom_px = dom[np.clip(spx_f, 0, nseg - 1)]
    out = np.where(dom_px == num_classes, ignore_idx, dom_px)
    return out.reshape(gt.shape).astype(np.int32)


def write_dominant_labels(rows, data_root: str, save_dir: str, nseg: int,
                          num_classes: int, encode, generate_ignore: bool):
    """The dominant mode over datalist rows (img, lbl, spx): one
    {data_id}.png a row in save_dir, data_id the first three '_' tokens
    of the image's name (label_assignment_dominant.py:34-41). Without
    generate_ignore the 255 class does not vote, and the GT's 255 pixels
    stay 255 (region_cityscapes_dominant_all.py:51-54)."""
    from mulactseg_tpu_torch.data.datasets import open_label, open_spx
    from mulactseg_tpu_torch.utils.png import write_gray8

    os.makedirs(save_dir, exist_ok=True)
    for img, lbl, spx in rows:
        gt = encode(open_label(os.path.join(data_root, lbl)))
        sp = open_spx(os.path.join(data_root, spx))
        dom = dominant_label_for_image(gt, sp, nseg, num_classes,
                                       count_ignore=generate_ignore)
        if not generate_ignore:
            dom = np.where(gt == 255, 255, dom)
        stem = os.path.splitext(os.path.basename(img))[0]
        data_id = "_".join(stem.split("_")[:3])
        write_gray8(os.path.join(save_dir, f"{data_id}.png"),
                    dom.astype(np.uint8))


def generate_multi_hot_dataset(samples, nseg: int, num_classes: int,
                               out_dir: str, ignore_idx: int = 255,
                               trim: bool = True, trim_kernel: int = 5):
    """samples: iterable of (gt (H,W) int, spx (H,W) int). Writes
    multi_hot_cls.npy + sp_size.npy like tools/label_assignment_tensor.py."""
    mhs, sizes, cls_sizes = [], [], []
    for gt, spx in samples:
        mh, sz, cs = multi_hot_for_image(np.asarray(gt), np.asarray(spx),
                                         nseg, num_classes, ignore_idx, trim,
                                         trim_kernel, return_class_sizes=True)
        mhs.append(mh)
        sizes.append(sz)
        cls_sizes.append(cs)
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "multi_hot_cls.npy"), np.stack(mhs))
    np.save(os.path.join(out_dir, "sp_size.npy"), np.stack(sizes))
    np.save(os.path.join(out_dir, "sp_gt_size.npy"), np.stack(cls_sizes))
    return np.stack(mhs), np.stack(sizes)


def main(argv=None):
    """The reference's offline label tools, with their flag names; --mode
    tensor (label_assignment_tensor.py):

        python -m mulactseg_tpu_torch.tools.label_assignment \\
            --datalist train_seed2048.txt --data_root DATA --nseg 2048 \\
            --save_data_dir OUT --trim_multihot_boundary \\
            --trim_kernel_size 5

    OUT is the directory data/datasets.multi_hot_paths names for the
    training config (under DATA/superpixel_seed/). --mode dominant
    (label_assignment_dominant.py) writes one {data_id}.png per image
    into --save_data_dir (write_dominant_labels); --generate_ignore lets
    the 255 class win a superpixel (the gtFine_dominant_ignore twin).
    --ignore_size, --mark_topk and --num_worker are accepted and unused,
    as in the reference."""
    import argparse

    from mulactseg_tpu_torch.data.datasets import (
        encode_cityscapes,
        encode_identity,
        open_label,
        open_spx,
    )

    p = argparse.ArgumentParser("label_assignment")
    p.add_argument("--mode", choices=["tensor", "dominant"],
                   default="tensor")
    p.add_argument("--datalist", required=True,
                   help="img\\tlbl\\tspx datalist")
    p.add_argument("--data_root", "--trg_data_dir", dest="data_root",
                   default=".")
    p.add_argument("--save_data_dir", required=True)
    p.add_argument("--nseg", type=int, default=2048)
    p.add_argument("--num_classes", type=int, default=19)
    p.add_argument("--trim_kernel_size", type=int, default=3)
    p.add_argument("--trim_multihot_boundary", action="store_true")
    p.add_argument("--generate_ignore", action="store_true")
    p.add_argument("--label-encoding", choices=["cityscapes", "identity"],
                   default="cityscapes")
    p.add_argument("--num_worker", type=int, default=8)   # parity, unused
    p.add_argument("--ignore_size", type=int, default=0)  # parity, unused
    p.add_argument("--mark_topk", type=int, default=-1)   # parity, unused
    args = p.parse_args(argv)
    encode = (encode_cityscapes if args.label_encoding == "cityscapes"
              else encode_identity)
    with open(args.datalist) as f:
        rows = [l.split("\t") for l in f.read().splitlines() if l.strip()]
    if args.mode == "dominant":
        write_dominant_labels(rows, args.data_root, args.save_data_dir,
                              args.nseg, args.num_classes, encode,
                              args.generate_ignore)
        print(f"wrote {len(rows)} dominant PNGs to {args.save_data_dir}")
        return
    samples = ((encode(open_label(os.path.join(args.data_root, lbl))),
                open_spx(os.path.join(args.data_root, spx)))
               for _, lbl, spx in rows)
    generate_multi_hot_dataset(
        samples, args.nseg, args.num_classes, args.save_data_dir,
        trim=args.trim_multihot_boundary, trim_kernel=args.trim_kernel_size)
    print(f"wrote multi_hot_cls/sp_size/sp_gt_size .npy for {len(rows)} "
          f"images to {args.save_data_dir}")


if __name__ == "__main__":
    main()
