"""Writes a Cityscapes-format tree made from a seed, the files the
recipe's loaders read, for runs where the real dataset is absent:

    python -m mulactseg_tpu_torch.tools.cityscapes_tree --root DIR \\
        [--train 16] [--val 4] [--height 1024] [--width 2048] \\
        [--nseg 2048] [--seed 0] [--encoding adaptive] [--processes 4] \\
        [--extra-nseg 512 1024 8192] [--dominant]

Under DIR:
  - leftImg8bit/{train,val}/synth/synth_<i>_000019_leftImg8bit.png: RGB
    images, a smooth random field plus noise, written with libpng's
    adaptive row filters (tools/png_timing.encode; "filter0" writes every
    row unfiltered), so that decoding costs what a camera image costs;
  - gtFine/{train,val}/synth/..._gtFine_labelIds.png: 8-bit Cityscapes
    label ids (blobs of the 19 train classes, ~2% id 0, which encodes to
    255);
  - superpixels/seeds_<nseg>/train/synth/....pkl: {"labels": int32 map},
    jittered-grid superpixels (data/synthetic.irregular_superpixels);
  - dataloader/init_data/cityscapes/: train_seed<nseg>.txt and train.dict
    (tools/gen_datalists), train_seed<nseg>_dominant.txt (the same rows:
    the stage-2 command's --dominant_labeling names this list, whose rows
    only key the multi-hot tensor there) and val.txt;
  - superpixel_seed/cityscapes/seeds_<nseg>/train/
    gtFine_multi_tensor_trim_5x5/: multi_hot_cls.npy, sp_size.npy and
    sp_gt_size.npy (tools/label_assignment, 5x5 boundary trim; the
    research rewrites read sp_gt_size.npy).

--extra-nseg N ... adds, per N, maps at that granularity
(superpixels/seeds_<N>/..., the finer map of the hierarchy criteria or
the levels of the mixed-scale loaders), train_seed<N>.txt, and the
multi-hot tensors under seeds_<N>/; with it every granularity, <nseg>
too, gets its region dict train_seed<N>.dict, whose name carries the
nseg token the mixed-scale loaders swap. --dominant adds the dominant
labels (tools/label_assignment's dominant mode) under
superpixel_seed/cityscapes/seeds_<nseg>/train/gtFine_dominant/ (255
kept where the GT has it) and gtFine_dominant_ignore/ (255 votes), and
train_seed<nseg>_dominant_labels.txt, whose label column names the
former (the dominant loader swaps in the latter without
--known_ignore).

Pass --data_root DIR and --datalist_dir DIR/dataloader/init_data/cityscapes
to the CLIs.
"""

from __future__ import annotations

import argparse
import os
import pickle
import shutil
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

from mulactseg_tpu_torch.data.constants import ID_TO_TRAIN_ID

CITY = "synth"
TRIM = 5
# train id -> the first Cityscapes label id that encodes to it
TRAIN_TO_ID = np.asarray([int(np.flatnonzero(ID_TO_TRAIN_ID == t)[0])
                          for t in range(19)], np.uint8)


def _image(rng, H, W):
    """(H, W, 3) uint8: a 1/32-scale random field, bilinearly enlarged,
    plus N(0, 4) noise."""
    gh, gw = H // 32 + 2, W // 32 + 2
    base = rng.rand(gh, gw, 3) * 255
    ys, xs = np.linspace(0, gh - 1.001, H), np.linspace(0, gw - 1.001, W)
    y0, x0 = ys.astype(int), xs.astype(int)
    wy, wx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    rows = base[y0] * (1 - wy) + base[y0 + 1] * wy
    img = rows[:, x0] * (1 - wx) + rows[:, x0 + 1] * wx
    img += rng.randn(H, W, 3) * 4
    return np.clip(img, 0, 255).astype(np.uint8)


def _label_ids(rng, H, W, num_classes):
    """(H, W) uint8 Cityscapes label ids: 8x16 blocks of random train
    classes below num_classes with jittered edges, ~2% id 0."""
    grid = rng.randint(0, num_classes, (8, 16))
    ys = np.minimum((np.arange(H) + rng.randint(0, H // 16 + 1)) * 8 // H, 7)
    xs = np.minimum((np.arange(W) + rng.randint(0, W // 32 + 1)) * 16 // W,
                    15)
    ids = TRAIN_TO_ID[grid[np.ix_(ys, xs)]]
    ids[rng.rand(H, W) < 0.02] = 0
    return ids


def _names(split, i):
    stem = f"{CITY}_{i:06d}_000019"
    return (f"leftImg8bit/{split}/{CITY}/{stem}_leftImg8bit.png",
            f"gtFine/{split}/{CITY}/{stem}_gtFine_labelIds.png")


def _spx_rel(img_rel, nseg):
    return (img_rel.replace("leftImg8bit", f"superpixels/seeds_{nseg}", 1)
            .replace("_leftImg8bit.png", ".pkl"))


def _write_one(root, split, i, H, W, nseg, seed, encoding, num_classes,
               extra_nseg=()):
    """Writes image i of `split`; returns its (img, lbl[, spx]) paths
    relative to root. Each extra granularity's map draws from a stream of
    its own, so the others do not depend on them."""
    from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
    from mulactseg_tpu_torch.tools.png_timing import encode
    from mulactseg_tpu_torch.utils.png import write_gray8, write_rgb8

    rng = np.random.RandomState([seed, i, split == "val"])
    img_rel, lbl_rel = _names(split, i)
    for rel in (img_rel, lbl_rel):
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
    img = _image(rng, H, W)
    if encoding == "adaptive":
        encode(os.path.join(root, img_rel), img, "adaptive")
    else:
        write_rgb8(os.path.join(root, img_rel), img)
    write_gray8(os.path.join(root, lbl_rel),
                _label_ids(rng, H, W, num_classes))
    if split == "val":
        return img_rel, lbl_rel
    maps = [(nseg, rng)] + [(n, np.random.RandomState([seed, i, n]))
                            for n in extra_nseg]
    for n, r in maps:
        rel = _spx_rel(img_rel, n)
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        with open(os.path.join(root, rel), "wb") as f:
            pickle.dump({"labels": irregular_superpixels(H, W, n, r)}, f)
    return img_rel, lbl_rel, _spx_rel(img_rel, nseg)


def write_tree(root: str, n_train: int = 16, n_val: int = 4, H: int = 1024,
               W: int = 2048, nseg: int = 2048, seed: int = 0,
               encoding: str = "adaptive", processes: int = 1,
               num_classes: int = 19, dataset: str = "cityscapes",
               extra_nseg=(), dominant: bool = False) -> str:
    """Writes the tree (module docstring); returns the datalist dir.
    num_classes < 19 draws the GT from the first train classes only (the
    tests' small models); `dataset` names the multi-hot directory
    (superpixel_seed/<dataset>/...), as the config that reads it does."""
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.data.datasets import (
        encode_cityscapes,
        multi_hot_paths,
    )
    from mulactseg_tpu_torch.tools.gen_datalists import (
        gen_datalist,
        gen_region_dict,
    )
    from mulactseg_tpu_torch.tools.label_assignment import (
        generate_multi_hot_dataset,
        write_dominant_labels,
    )
    from mulactseg_tpu_torch.utils.png import read_gray

    def samples(rows):  # read past the loaders' decode cache
        for _, lbl, spx in rows:
            with open(os.path.join(root, spx), "rb") as f:
                labels = pickle.load(f)["labels"]
            yield (encode_cityscapes(read_gray(os.path.join(root, lbl))),
                   labels)

    if encoding not in ("adaptive", "filter0"):
        raise ValueError(f"unknown encoding {encoding!r}")
    jobs = [("train", i) for i in range(n_train)] + \
        [("val", i) for i in range(n_val)]
    extra_nseg = tuple(int(n) for n in extra_nseg)
    args = [(root, s, i, H, W, nseg, seed, encoding, num_classes,
             extra_nseg if s == "train" else ()) for s, i in jobs]
    if processes > 1:
        with ProcessPoolExecutor(processes,
                                 mp_context=get_context("spawn")) as pool:
            rows = list(pool.map(_write_one, *zip(*args)))
    else:
        rows = [_write_one(*a) for a in args]
    train, val = rows[:n_train], rows[n_train:]
    dl_dir = os.path.join(root, "dataloader", "init_data", "cityscapes")
    train_txt = os.path.join(dl_dir, f"train_seed{nseg}.txt")
    gen_datalist(train, train_txt)
    shutil.copyfile(train_txt, train_txt[:-4] + "_dominant.txt")
    gen_region_dict(train, nseg, os.path.join(dl_dir, "train.dict"),
                    data_root=root)
    if val:  # without val.txt the CLIs run no validation
        with open(os.path.join(dl_dir, "val.txt"), "w") as f:
            f.writelines(f"{img}\t{lbl}\n" for img, lbl in val)
    levels = {nseg: train}
    for n in extra_nseg:
        levels[n] = [(img, lbl, _spx_rel(img, n)) for img, lbl, _ in train]
        gen_datalist(levels[n], os.path.join(dl_dir, f"train_seed{n}.txt"))
    for n, rows in levels.items():
        if extra_nseg:
            gen_region_dict(rows, n, os.path.join(dl_dir,
                                                  f"train_seed{n}.dict"),
                            data_root=root)
        cfg = Config(data_root=root, nseg=n, dataset=dataset,
                     trim_kernel_size=TRIM, trim_multihot_boundary=True)
        out_dir = os.path.dirname(multi_hot_paths(cfg)["multi_hot_cls"])
        generate_multi_hot_dataset(samples(rows), n, num_classes, out_dir,
                                   trim=True, trim_kernel=TRIM)
    if dominant:
        seeds = f"superpixel_seed/{dataset}/seeds_{nseg}/train"
        for name, vote in (("gtFine_dominant", False),
                           ("gtFine_dominant_ignore", True)):
            write_dominant_labels(train, root, os.path.join(root, seeds, name),
                                  nseg, num_classes, encode_cityscapes, vote)
        with open(os.path.join(dl_dir, f"train_seed{nseg}_dominant_labels"
                               ".txt"), "w") as f:
            for img, _, spx in train:
                stem = os.path.basename(img)[:-len("_leftImg8bit.png")]
                f.write(f"{img}\t{seeds}/gtFine_dominant/{stem}.png\t"
                        f"{spx}\n")
    return dl_dir


def main(argv=None):
    p = argparse.ArgumentParser("cityscapes_tree")
    p.add_argument("--root", required=True)
    p.add_argument("--train", type=int, default=16)
    p.add_argument("--val", type=int, default=4)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--nseg", type=int, default=2048)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--encoding", choices=["adaptive", "filter0"],
                   default="adaptive")
    p.add_argument("--processes", type=int, default=1)
    p.add_argument("--extra-nseg", type=int, nargs="*", default=())
    p.add_argument("--dominant", action="store_true")
    a = p.parse_args(argv)
    dl_dir = write_tree(a.root, a.train, a.val, a.height, a.width, a.nseg,
                        a.seed, a.encoding, a.processes,
                        extra_nseg=a.extra_nseg, dominant=a.dominant)
    print(f"wrote {a.train} train and {a.val} val images under {a.root}; "
          f"datalists in {dl_dir}")


if __name__ == "__main__":
    main()
