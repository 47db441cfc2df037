"""Times the large-S group-term kernels K6 (prereduce_softmax_nchw) and K5
(seg_max_fwd) on one GPU at the shapes of their main paths, for each K5
span and slot count asked for (ops/segment_max.K5_SPAN, K5_SLOTS,
csrc/segment_max.cu's -DSPAN and -DNSLOT; each pair built anew).

    python3 mulactseg_tpu_torch/tools/segment_timing.py \
        [--span 256 512 1024] [--slots 64 128] [--root DIR] \
        [--out FILE] [--against FILE]

--root times the code of another checkout (its mulactseg_tpu_torch/ and
chip_smoke.py), so that two versions can be compared in one run on
one card; a checkout whose segment_max.cu takes no -D constant is timed as
it builds, and --span and --slots are refused for it. --out writes the
JSON line to FILE as well; --against FILE holds K6's outputs bitwise
against the digests of another run's line (the parent's, on the same
inputs) and fails where they differ.

Inputs (seeded): chip_smoke.py's stage-1 batch at nseg 4096 (B 4, C 20,
768x768, S 16,384, the group term's ids) with logits uniform in [-1, 1],
the range of the model's cosine logits, T 0.1. K6 runs on the logits as
allocated ("aligned", the 16-byte path), on a copy that starts one float
into a larger storage ("unaligned"), and on logits 3 N(0, 1) ("wide",
16-byte path), far outside the cosine range, where its true division
takes its slow path for denormal quotients. K5 runs on four inputs: K6's
planes and retired ids ("s4", the stage-1 path past the guard), the
softmax planes of 1024x2048 logits 3 N(0, 1) under irregular superpixels
at nseg 2048 with 30% selected ("plbl", the pseudo-labeller's shapes),
those values as a contiguous (P, C) array ("rows"), and the plbl planes
under 4 segments that each cover a quarter of the image ("hot4": every
warp's run in one of 4 segments). Each output is first held against its
plain version (K6 within
one bf16 ulp, choices only at near-ties, retired ids exact, as
chip_smoke.check_prereduce; K5 bitwise), then timed as chip_smoke.time_ms
times it: the median of 20 windows of 5 CUDA graph replays. Beside them:
copy_ of the 189 MB logits, each kernel's bound (chip_smoke.bound: bytes
over 3.35 TB/s, K5 counting only its valid pixels' values), K5's bound
counting every 32-byte sector of the values that holds a valid pixel
(what any reader of the planes fetches), the valid pixel counts and the
registers and spills of the kernels built anew.
Prints the card's name and power limit, then one JSON line per K5
constant pair.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
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
    ap.add_argument("--span", type=int, nargs="*", default=[])
    ap.add_argument("--slots", type=int, nargs="*", default=[])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--out")
    ap.add_argument("--against")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
    from mulactseg_tpu_torch.ops import _build, segment, segment_max

    if not torch.cuda.is_available():
        sys.exit("segment_timing.py needs a CUDA device")
    defines = _build.DEFINES.get("segment_max")
    if (args.span or args.slots) and not defines:
        sys.exit(f"{args.root}: segment_max.cu takes no -D constant")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    logs = _build.build_all(["prereduce", "segment_max"])
    B, C, HW = cs.B, cs.NUM_CLASSES, cs.H * cs.W
    P, S, temp = B * HW, B * cs.NSEG_LARGE, 0.1
    _, _, sid3 = cs.stage1_ids(cs.make_batches(1, seed=1,
                                               nseg=cs.NSEG_LARGE)[0], dev,
                               cs.NSEG_LARGE)
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.rand(B, C, HW, device=dev, generator=gen) * 2 - 1
    store = torch.empty(B * C * HW + 1, device=dev)
    store[1:] = x.reshape(-1)
    paths = {"aligned": x, "unaligned": store[1:].view(B, C, HW)}
    wide = torch.randn(B, C, HW, device=dev, generator=gen) * 3
    probs = segment._softmax(x, temp).permute(1, 0, 2).reshape(C, P)
    want = segment.prereduce_plain(x, sid3.reshape(B, HW), S, temp)

    rng = np.random.RandomState(11)
    PP = cs.PH * cs.PW
    spx = irregular_superpixels(cs.PH, cs.PW, cs.NSEG, rng)
    sel = rng.rand(cs.NSEG) < 0.3
    psid = torch.from_numpy(np.where(sel[spx], spx, cs.NSEG).reshape(-1)
                            .astype(np.int32)).to(dev)
    pl = torch.randn(C, PP, device=dev, generator=gen) * 3
    pl = torch.softmax(pl, dim=0)
    hot = (torch.arange(PP, device=dev) // (PP // 4)).int()
    k5_inputs = {"plbl": (pl.t(), psid, cs.NSEG),
                 "rows": (pl.t().contiguous(), psid, cs.NSEG),
                 "hot4": (pl.t(), hot, 4)}

    base = {"root": args.root, "card": smi}
    if hasattr(segment, "prereduce_instance"):
        base["k6_instances"] = {k: segment.prereduce_instance(xp, sid3)
                                for k, xp in paths.items()}
    # K6: bitwise the same on both paths, each within a bf16 ulp of plain
    k6 = {}
    for name, xp in paths.items():
        got = segment.prereduce_softmax_nchw(xp, sid3, S, temp)
        torch.cuda.synchronize()
        err, n_vals, n_ch = cs.check_prereduce(got, want, probs,
                                               sid3.reshape(P), B, HW,
                                               f"K6 ({name})")
        k6[name] = got
        base[f"k6_digest_{name}"] = digest(*got)
        base[f"k6_vs_plain_{name}"] = {"max_abs_err": err,
                                       "values_differ": n_vals,
                                       "choices_differ": n_ch}
    cs.check(base["k6_digest_aligned"] == base["k6_digest_unaligned"],
             "K6 differs between its two paths")
    if args.against:
        other = json.loads(Path(args.against).read_text())
        cs.check(other["k6_digest_aligned"] == base["k6_digest_aligned"],
                 f"K6 differs bitwise from {other['root']}")
        base["k6_bitwise_against"] = other["root"]
    planes, _, sid2 = k6["aligned"]
    k5_inputs["s4"] = (planes.t(), sid2, S)
    base["k6_ms"] = {}
    for name, xp in paths.items():
        base["k6_ms"][name] = cs.time_ms(
            lambda: segment.prereduce_softmax_nchw(xp, sid3, S, temp),
            graph=True)
    base["k6_ms"]["wide"] = cs.time_ms(
        lambda: segment.prereduce_softmax_nchw(wide, sid3, S, temp),
        graph=True)
    del wide
    base["k6_bound_ms"] = cs.bound(2 * P * C * 4 + 2 * P * 4
                                   + B * -(-HW // 4) * C * 4, 12 * P * C)[0]
    out = torch.empty_like(x)
    base["copy_ms"] = cs.time_ms(lambda: out.copy_(x), graph=True)
    del out, store, paths, want, probs, k6
    base["k5_valid_pixels"] = {
        k: int(((s >= 0) & (s < n)).sum()) for k, (_, s, n) in
        k5_inputs.items()}
    base["k5_bound_ms"] = {
        k: cs.bound(v.shape[0] * 4 + base["k5_valid_pixels"][k] * C * 4
                    + n * C * 8, base["k5_valid_pixels"][k] * C)[0]
        for k, (v, _, n) in k5_inputs.items()}
    # sectors of 8 values (32 bytes) of one class holding a valid pixel
    base["k5_sector_bound_ms"] = {}
    for k in ("plbl", "s4", "hot4"):
        _, s, n = k5_inputs[k]
        Pk = s.numel()
        ok = ((s >= 0) & (s < n))[:Pk // 8 * 8].reshape(-1, 8).any(dim=1)
        sectors = int(ok.sum()) * C
        base["k5_sector_bound_ms"][k] = cs.bound(
            Pk * 4 + sectors * 32 + n * C * 8, 0)[0]
    if hasattr(segment_max, "layout"):
        base["k5_layouts"] = {k: segment_max.layout(v)
                              for k, (v, _, _) in k5_inputs.items()}

    pairs = list(itertools.product(args.span or [None],
                                   args.slots or [None]))
    for span, slots in pairs:
        if span:
            segment_max.K5_SPAN = defines["SPAN"] = span
        if slots:
            segment_max.K5_SLOTS = defines["NSLOT"] = slots
        if span or slots:
            _build._LIBS.pop("segment_max", None)
            logs.update(_build.build_all(["segment_max"]))
        row = dict(base, defines=dict(defines or {}), registers=[
            f"{name}: {line}" for name, lg in logs.items()
            for line in cs.ptxas_summary(lg)])
        row["k5_ms"] = {}
        for name, (v, s, n) in k5_inputs.items():
            vals, pix = segment_max.seg_max_fwd(v, s, n)
            pvals, ppix = segment_max.segment_max_plain(v, s, n)
            torch.cuda.synchronize()
            cs.check(torch.equal(pix, ppix) and torch.equal(
                vals.view(torch.int32), pvals.view(torch.int32)),
                f"K5 ({name}) differs from its plain version")
            row[f"k5_digest_{name}"] = digest(vals, pix)
            row["k5_ms"][name] = cs.time_ms(
                lambda: segment_max.seg_max_fwd(v, s, n), graph=True)
        print(json.dumps(row), flush=True)
        if args.out:
            Path(args.out).write_text(json.dumps(row))


if __name__ == "__main__":
    main()
