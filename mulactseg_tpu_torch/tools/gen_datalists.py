"""Datalist and region-dict generation, the port's copy of
mulactseg_tpu/tools/gen_datalists.py: write train_seed{nseg}.txt (three
tab-separated paths per line) and train.dict ({spx_path: [size,
missing_ids]}) from (img, lbl, spx) path triples."""

from __future__ import annotations

import json
import os
from typing import Sequence, Tuple

import numpy as np

from mulactseg_tpu_torch.data.datasets import open_spx


def gen_datalist(triples: Sequence[Tuple[str, str, str]], out_txt: str):
    os.makedirs(os.path.dirname(os.path.abspath(out_txt)), exist_ok=True)
    with open(out_txt, "w") as f:
        for img, lbl, spx in triples:
            f.write(f"{img}\t{lbl}\t{spx}\n")


def gen_region_dict(triples: Sequence[Tuple[str, str, str]], nseg: int,
                    out_json: str, data_root: str = ""):
    """Scan each superpixel map for absent ids and store the reference's
    [size, missing_ids] format (parsed at region_cityscapes.py:137-153)."""
    out = {}
    for _, _, spx_rel in triples:
        path = os.path.join(data_root, spx_rel) if data_root else spx_rel
        spx = open_spx(path)
        present = np.unique(spx)
        present = present[(present >= 0) & (present < nseg)]
        missing = sorted(set(range(nseg)) - set(present.tolist()))
        out[spx_rel] = [nseg, missing]
    os.makedirs(os.path.dirname(os.path.abspath(out_json)), exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(out, f)
    return out


def main(argv=None):
    """Build train_seed{nseg}.txt + train.dict from an on-disk tree.

        python -m mulactseg_tpu_torch.tools.gen_datalists \
            --data_root data/cityscapes --nseg 2048 \
            --img-glob 'leftImg8bit/train/*/*_leftImg8bit.png' \
            --lbl-sub leftImg8bit=gtFine \
            --lbl-sub _leftImg8bit.png=_gtFine_labelIds.png \
            --spx-sub leftImg8bit=superpixels/seeds_2048 \
            --spx-sub _leftImg8bit.png=.pkl \
            --out-dir dataloader/init_data/cityscapes

    Label/superpixel paths derive from each image path by the ordered
    a=b substitutions. The region dict scans every superpixel map for
    absent ids (the reference ships these files pre-built under
    dataloader/init_data/ and no generator — format parsed at
    region_cityscapes.py:137-153)."""
    import argparse
    import glob as _glob

    p = argparse.ArgumentParser("gen_datalists")
    p.add_argument("--data_root", default=".")
    p.add_argument("--nseg", type=int, required=True)
    p.add_argument("--img-glob", required=True,
                   help="image glob relative to data_root")
    p.add_argument("--lbl-sub", action="append", default=[],
                   help="a=b substitution image->label path (ordered)")
    p.add_argument("--spx-sub", action="append", default=[],
                   help="a=b substitution image->superpixel path (ordered)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--split", default="train")
    args = p.parse_args(argv)

    def apply(subs, s):
        for pair in subs:
            a, b = pair.split("=", 1)
            s = s.replace(a, b)
        return s

    imgs = sorted(_glob.glob(os.path.join(args.data_root, args.img_glob)))
    if not imgs:
        raise SystemExit(f"no images match {args.img_glob!r} "
                         f"under {args.data_root}")
    rel = [os.path.relpath(i, args.data_root) for i in imgs]
    triples = [(r, apply(args.lbl_sub, r), apply(args.spx_sub, r))
               for r in rel]
    out_txt = os.path.join(args.out_dir,
                           f"{args.split}_seed{args.nseg}.txt")
    gen_datalist(triples, out_txt)
    out_json = os.path.join(args.out_dir, f"{args.split}.dict")
    gen_region_dict(triples, args.nseg, out_json, data_root=args.data_root)
    print(f"wrote {out_txt} + {out_json} ({len(triples)} images)")


if __name__ == "__main__":
    main()
