"""Writes a PASCAL VOC-format tree made from a seed, the files the VOC
recipe's loaders read (scripts/train_voc_mul_res50.sh), for runs where
the real dataset is absent:

    python -m mulactseg_tpu_torch.tools.voc_tree --root DIR \\
        [--train 16] [--val 4] [--nseg 150] [--seed 0]

Under DIR (the recipe's --data_root):
  - VOC2012/JPEGImages/<id>.jpg: RGB images, a smooth random field plus
    noise (cityscapes_tree's), written as baseline 4:2:0 JPEGs at quality
    75 by utils/jpeg.write_jpeg, at VOC's sizes in turn (H x W 375x500,
    500x375, 333x500, 500x334, 500x500, 500x486);
  - VOC2012/SegmentationClass/<id>.png: palette PNGs with the VOC palette
    (data/constants.voc_cmap): background with 1-4 blobs of the 20 object
    classes, each object ringed by a 255 ("void") border 3 pixels wide;
  - superpixels/pascal_voc_seg/seeds_<nseg>/train/label/<id>.pkl:
    {"labels": int32 map}, jittered-grid superpixels
    (data/synthetic.irregular_superpixels);
  - dataloader/init_data/voc/: train_seed<nseg>.txt and train.dict
    (tools/gen_datalists), train_seed<nseg>_dominant.txt (the same rows:
    the stage-2 command's --dominant_labeling names this list, whose rows
    only key the multi-hot tensor there) and val.txt;
  - superpixels/pascal_voc_seg/seeds_<nseg>/train/
    gtFine_multi_tensor_trim_5x5/: multi_hot_cls.npy (N, nseg, 22),
    sp_size.npy and sp_gt_size.npy (tools/label_assignment, identity
    encoding, 5x5 boundary trim; the loader drops the last channel).

Pass --data_root DIR and --datalist_dir DIR/dataloader/init_data/voc to
the CLIs.
"""

from __future__ import annotations

import argparse
import os
import pickle
import shutil

import numpy as np

from mulactseg_tpu_torch.data.constants import voc_cmap

NUM_CLASSES = 21
TRIM = 5
BORDER = 3  # the width of the 255 ring around each object
# (H, W) of VOC images, in turn
VOC_SIZES = ((375, 500), (500, 375), (333, 500), (500, 334), (500, 500),
             (500, 486))


def _labels(rng, H, W):
    """(H, W) uint8 VOC class map: background, 1-4 elliptical objects of
    random classes 1..20 (later ones on top), each ringed by 255."""
    from mulactseg_tpu_torch.tools.label_assignment import (
        boundaries_thick,
        dilate_square,
    )

    lbl = np.zeros((H, W), np.uint8)
    yy, xx = np.mgrid[0:H, 0:W]
    for _ in range(rng.randint(1, 5)):
        cy, cx = rng.rand() * H, rng.rand() * W
        ry, rx = (0.1 + rng.rand() * 0.3) * H, (0.1 + rng.rand() * 0.3) * W
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
        lbl[inside] = rng.randint(1, NUM_CLASSES)
    ring = dilate_square(boundaries_thick(lbl), BORDER)
    lbl[ring] = 255
    return lbl


def _names(split, i, nseg):
    fid = f"{2007 if split == 'train' else 2008}_{i:06d}"
    return (f"VOC2012/JPEGImages/{fid}.jpg",
            f"VOC2012/SegmentationClass/{fid}.png",
            f"superpixels/pascal_voc_seg/seeds_{nseg}/train/label/{fid}.pkl")


def _write_one(root, split, i, size, nseg, seed):
    """Writes image i of `split` at size (H, W); returns its (img, lbl[,
    spx]) paths relative to root."""
    from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
    from mulactseg_tpu_torch.tools.cityscapes_tree import _image
    from mulactseg_tpu_torch.utils.jpeg import write_jpeg
    from mulactseg_tpu_torch.utils.png import write_palette8

    H, W = size
    rng = np.random.RandomState([seed, i, split == "val"])
    img_rel, lbl_rel, spx_rel = _names(split, i, nseg)
    rels = (img_rel, lbl_rel) if split == "val" else (img_rel, lbl_rel,
                                                       spx_rel)
    for rel in rels:
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
    write_jpeg(os.path.join(root, img_rel), _image(rng, H, W), quality=75)
    write_palette8(os.path.join(root, lbl_rel), _labels(rng, H, W),
                   voc_cmap())
    if split == "train":
        with open(os.path.join(root, spx_rel), "wb") as f:
            pickle.dump({"labels": irregular_superpixels(H, W, nseg, rng)},
                        f)
    return rels


def write_tree(root: str, n_train: int = 16, n_val: int = 4,
               nseg: int = 150, seed: int = 0, sizes=VOC_SIZES) -> str:
    """Writes the tree (module docstring), image i of each split at
    sizes[i % len(sizes)]; returns the datalist dir."""
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.data.datasets import multi_hot_paths
    from mulactseg_tpu_torch.tools.gen_datalists import (
        gen_datalist,
        gen_region_dict,
    )
    from mulactseg_tpu_torch.tools.label_assignment import (
        generate_multi_hot_dataset,
    )
    from mulactseg_tpu_torch.utils.png import read_gray

    train = [_write_one(root, "train", i, sizes[i % len(sizes)], nseg, seed)
             for i in range(n_train)]
    val = [_write_one(root, "val", i, sizes[i % len(sizes)], nseg, seed)
           for i in range(n_val)]
    dl_dir = os.path.join(root, "dataloader", "init_data", "voc")
    train_txt = os.path.join(dl_dir, f"train_seed{nseg}.txt")
    gen_datalist(train, train_txt)
    shutil.copyfile(train_txt, train_txt[:-4] + "_dominant.txt")
    gen_region_dict(train, nseg, os.path.join(dl_dir, "train.dict"),
                    data_root=root)
    if val:  # without val.txt the CLIs run no validation
        with open(os.path.join(dl_dir, "val.txt"), "w") as f:
            f.writelines(f"{img}\t{lbl}\n" for img, lbl in val)

    def samples():  # identity encoding: the palette index is the class
        for _, lbl, spx in train:
            with open(os.path.join(root, spx), "rb") as f:
                labels = pickle.load(f)["labels"]
            yield read_gray(os.path.join(root, lbl)).astype(np.int32), labels

    cfg = Config(data_root=root, nseg=nseg, dataset="voc",
                 trim_kernel_size=TRIM, trim_multihot_boundary=True)
    out_dir = os.path.dirname(multi_hot_paths(cfg)["multi_hot_cls"])
    generate_multi_hot_dataset(samples(), nseg, NUM_CLASSES, out_dir,
                               trim=True, trim_kernel=TRIM)
    return dl_dir


def main(argv=None):
    p = argparse.ArgumentParser("voc_tree")
    p.add_argument("--root", required=True)
    p.add_argument("--train", type=int, default=16)
    p.add_argument("--val", type=int, default=4)
    p.add_argument("--nseg", type=int, default=150)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    dl_dir = write_tree(a.root, a.train, a.val, a.nseg, a.seed)
    print(f"wrote {a.train} train and {a.val} val images under {a.root}; "
          f"datalists in {dl_dir}")


if __name__ == "__main__":
    main()
