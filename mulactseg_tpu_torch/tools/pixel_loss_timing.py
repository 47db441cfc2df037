"""Times the pixel-loss kernels K1 (pixel_ce_fwd) and K2 (pixel_ce_bwd) at
the stage-1 recipe's shapes on one GPU, on both input paths, for each
pixels-per-block value asked for (ops/pixel_loss.PIXELS_PER_BLOCK,
csrc/pixel_loss.cu's -DPIXELS; each built anew).

    python3 mulactseg_tpu_torch/tools/pixel_loss_timing.py \
        [--pixels 256 512 1024] [--root DIR] [--out FILE] [--against FILE]

--root times the code of another checkout (its mulactseg_tpu_torch/ and
chip_smoke.py), so that two versions can be compared in one session on
one card; a checkout whose pixel_loss.cu takes no -D constant is timed
as it builds, and --pixels is refused for it. The inputs are chip_smoke.py's
synthetic stage-1 batch (B 4, C 20, 768x768, nseg 2048, 50% of
superpixels selected, 15% of classes multi-hot), with logits 3 N(0, 1)
from a seed. "aligned" takes the logits as allocated, "unaligned" a copy
that starts one float into a larger storage, so that the 16-byte path
cannot be taken. Each kernel is first held against its plain version
(K1's counts exact and sums to rtol 1e-5, K2 within 1e-6 of max |dl|),
then timed as chip_smoke.time_ms times it: the median of 20 windows of 5
CUDA graph replays. On the aligned logits both are also timed with every
pixel dead (K2 then only writes zeros) and every pixel live (every logit
read), beside two yardsticks of the same 189 MB: zero_ (the write alone)
and copy_ (a read and a write of every element).

K9 and K10 run on chip_smoke.py's stage-1 rows at nseg 4096 (the same
logits as (B HW, C) rows, the bitmasks of the nseg-4096 batch): K10 held
against its plain version (within 1e-6 of max |dl|) and timed on the
rows as allocated ("aligned": the 16-byte instance where the checkout
has one), on a copy one float into a larger storage ("unaligned": 4-byte
loads and stores), with every row dead (K10 only writes zeros) and every
row live; K9, which keeps K1's kernel, is the control. The digests of
K10's dl (and of K1's sums and K2's dl) on both views go into the line;
--out writes the line to FILE, and --against FILE fails unless K10's dl,
K1's sums and K2's dl are bitwise those of that run (the parent's, on the
same inputs) on both views. Prints the card's name
and power limit, then one JSON line per value, with the registers and
spills of its C = 20 kernels where they were built anew.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path


def digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pixels", type=int, nargs="*", default=[])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--out")
    ap.add_argument("--against")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    import chip_smoke as cs
    from mulactseg_tpu_torch.ops import _build, pixel_loss

    if not torch.cuda.is_available():
        sys.exit("pixel_loss_timing.py needs a CUDA device")
    defines = _build.DEFINES.get("pixel_loss")
    if args.pixels and not defines:
        sys.exit(f"{args.root}: pixel_loss.cu takes no -D constant")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    B, C, HW = cs.B, cs.NUM_CLASSES, cs.H * cs.W
    bits3, n_cand, _ = cs.stage1_ids(cs.make_batches(1, seed=0)[0], dev,
                                     cs.NSEG)
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.randn(B, C, HW, device=dev, generator=gen) * 3
    store = torch.empty(B * C * HW + 1, device=dev)
    store[1:] = x.reshape(-1)
    paths = {"aligned": x, "unaligned": store[1:].view(B, C, HW)}
    g = torch.tensor([0.5, 0.25], device=dev)
    # the row ops' inputs: the logits as rows, the nseg-4096 bitmasks
    x2d = x.permute(0, 2, 1).reshape(-1, C).contiguous()
    rbits = cs.stage1_ids(cs.make_batches(1, seed=1, nseg=cs.NSEG_LARGE)[0],
                          dev, cs.NSEG_LARGE)[0].reshape(-1).contiguous()
    rstore = torch.empty(x2d.numel() + 1, device=dev)
    rstore[1:] = x2d.reshape(-1)
    rows = {"aligned": x2d, "unaligned": rstore[1:].view(x2d.shape)}

    for pixels in args.pixels or [None]:
        if pixels:
            pixel_loss.PIXELS_PER_BLOCK = defines["PIXELS"] = pixels
        _build._LIBS.pop("pixel_loss", None)
        log = _build.build_all(["pixel_loss"]).get("pixel_loss", "")
        row = {"root": args.root, "defines": dict(defines or {}),
               "live_share": float((n_cand > 0).float().mean()),
               "card": smi, "registers": [
                   line for line in cs.ptxas_summary(log)
                   if "<20" in line or not defines]}
        for path, xp in paths.items():
            got = pixel_loss.pixel_ce_fwd(xp, bits3, 0.1)
            want = pixel_loss.pixel_ce_fwd_plain(xp, bits3, 0.1)
            cs.check(torch.equal(got[1::2], want[1::2]) and torch.allclose(
                got[0::2], want[0::2], rtol=1e-5, atol=0),
                f"K1 ({path}) {got.tolist()} vs {want.tolist()}")
            dl = pixel_loss.pixel_ce_bwd(xp, bits3, g, 0.1)
            want_dl = pixel_loss.pixel_ce_bwd_plain(xp, bits3, g, 0.1)
            err = (dl - want_dl).abs().max().item()
            cs.check(err <= 1e-6 * want_dl.abs().max().item(),
                     f"K2 ({path}) max abs err {err}")
            row[f"k1_k2_digest_{path}"] = digest(got, dl)
            del dl, want_dl
            if defines:
                row[f"instance_{path}"] = pixel_loss.instance(xp, bits3)
            row[f"k1_ms_{path}"] = cs.time_ms(
                lambda: pixel_loss.pixel_ce_fwd(xp, bits3, 0.1), graph=True)
            row[f"k2_ms_{path}"] = cs.time_ms(
                lambda: pixel_loss.pixel_ce_bwd(xp, bits3, g, 0.1),
                graph=True)
        for kind, b3 in (("dead", torch.zeros_like(bits3)),
                         ("live", torch.ones_like(bits3))):
            row[f"k1_ms_{kind}"] = cs.time_ms(
                lambda: pixel_loss.pixel_ce_fwd(x, b3, 0.1), graph=True)
            row[f"k2_ms_{kind}"] = cs.time_ms(
                lambda: pixel_loss.pixel_ce_bwd(x, b3, g, 0.1), graph=True)
        # K9 and K10 on the stage-1 rows at nseg 4096
        row["rows_live_share"] = float((rbits != 0).float().mean())
        got = pixel_loss.pixel_ce_rows_fwd(x2d, rbits, 0.1)
        want = pixel_loss.pixel_ce_fwd_plain(x2d.t()[None],
                                             rbits[None, None], 0.1)
        cs.check(torch.equal(got[1::2], want[1::2]) and torch.allclose(
            got[0::2], want[0::2], rtol=1e-5, atol=0),
            f"K9 {got.tolist()} vs {want.tolist()}")
        want_dl = pixel_loss.pixel_ce_bwd_plain(
            x2d.t()[None], rbits[None, None], g, 0.1)[0].t()
        scale = want_dl.abs().max().item()
        for path, xr in rows.items():
            dl = pixel_loss.pixel_ce_rows_bwd(xr, rbits, g, 0.1)
            err = (dl - want_dl).abs().max().item()
            cs.check(err <= 1e-6 * scale, f"K10 ({path}) max abs err {err}")
            row[f"k10_digest_{path}"] = digest(dl)
            row[f"k10_max_abs_err_{path}"] = err
            del dl
            if hasattr(pixel_loss, "rows_instance"):
                row[f"k10_instance_{path}"] = pixel_loss.rows_instance(
                    xr, rbits)
        del want_dl
        cs.check(row["k10_digest_aligned"] == row["k10_digest_unaligned"],
                 "K10 differs between its two views")
        if args.against:
            other = json.loads(Path(args.against).read_text())
            for key in (f"{k}_digest_{path}" for k in ("k10", "k1_k2")
                        for path in rows):
                cs.check(other[key] == row[key],
                         f"{key} differs bitwise from {other['root']}")
            row["k10_bitwise_against"] = other["root"]
        row["k9_ms"] = cs.time_ms(
            lambda: pixel_loss.pixel_ce_rows_fwd(x2d, rbits, 0.1),
            graph=True)
        for path, xr in rows.items():
            row[f"k10_ms_{path}"] = cs.time_ms(
                lambda: pixel_loss.pixel_ce_rows_bwd(xr, rbits, g, 0.1),
                graph=True)
        for kind, rb in (("dead", torch.zeros_like(rbits)),
                         ("live", torch.ones_like(rbits))):
            row[f"k10_ms_{kind}"] = cs.time_ms(
                lambda: pixel_loss.pixel_ce_rows_bwd(x2d, rb, g, 0.1),
                graph=True)
        n_live = int((rbits != 0).sum())
        P = x2d.shape[0]
        row["k10_bound_ms"] = cs.bound(P * 4 + n_live * C * 4
                                       + P * C * 4 + 8, 12 * n_live * C)[0]
        out = torch.empty_like(x)
        row["zero_ms"] = cs.time_ms(lambda: out.zero_(), graph=True)
        row["copy_ms"] = cs.time_ms(lambda: out.copy_(x), graph=True)
        print(json.dumps(row), flush=True)
        if args.out:
            Path(args.out).write_text(json.dumps(row))


if __name__ == "__main__":
    main()
