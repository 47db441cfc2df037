"""Times the large-S group-term kernels K6 (prereduce_softmax_nchw) and K5
(seg_max_fwd) on one GPU at the shapes of their main paths, for each K5
span and slot count asked for (ops/segment_max.K5_SPAN, K5_SLOTS,
csrc/segment_max.cu's -DSPAN and -DNSLOT; each pair built anew), and the
row-major group term K7 (ssm_rows_fwd) with K3 (ssm_fwd), which shares
its span walk, as the control, for each K7 span and slot count asked for
(ops/segment.K7_SPAN, K7_SLOTS, csrc/segment.cu's -DROWS_SPAN and
-DROWS_NSLOT; each pair built anew).

    python3 mulactseg_tpu_torch/tools/segment_timing.py \
        [--span 256 512 1024] [--slots 64 128] \
        [--rows-span 256 512] [--rows-slots 16 64] [--root DIR] \
        [--out FILE] [--against FILE]

--root times the code of another checkout (its mulactseg_tpu_torch/ and
chip_smoke.py), so that two versions can be compared in one run on
one card; a checkout whose segment_max.cu (segment.cu) takes no such -D
constant is timed as it builds, and --span and --slots (--rows-span and
--rows-slots) are refused for it. --out writes the last K5 line to FILE
as well; --against FILE holds K6's, K7's, K8's and K3's outputs bitwise
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

K7 runs on chip_smoke.py's stage-1 rows at nseg 4096: the logits above as
(B HW, C) rows divided by T, the nseg-4096 ids; on the rows as allocated
("aligned", the 16-byte instance where the checkout has one) and on a
copy one float into a larger storage ("unaligned", 4-byte loads). Each is
held against ssm_rows_fwd_plain (absent sets exact, maxima within 1e-6,
argmax pixels at the plain maximum within 1e-6; whether the outputs are
bitwise the plain version's goes into the line), and both views must
give the same bits. K3 runs on the same logits under the nseg-2048 ids
(S = 8,192, its main path), held against its plain version as
chip_smoke.check_k3 holds it. Beside them: K7's bound (chip_smoke.bound:
the ids, the valid rows and the key table) and the valid row count.

Prints the card's name and power limit, then one JSON line per K5
constant pair and one per K7 constant pair.
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
    ap.add_argument("--rows-span", type=int, nargs="*", default=[])
    ap.add_argument("--rows-slots", type=int, nargs="*", default=[])
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
    rdefines = _build.DEFINES.get("segment", {})
    if (args.rows_span or args.rows_slots) and "ROWS_SPAN" not in rdefines:
        sys.exit(f"{args.root}: segment.cu takes no K7 constant")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    logs = _build.build_all(["prereduce", "segment_max", "segment"])
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
    # K7 on the rows (nseg 4096 ids) and K3 on the NCHW logits (nseg 2048
    # ids), before K6 and K5 take their memory
    rows_case(cs, segment, x, sid3, S, temp, base, args.against)
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

    if args.against:
        base["k7_k3_bitwise_against"] = json.loads(
            Path(args.against).read_text())["root"]
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
    del k5_inputs, planes, sid2, pl, psid, hot

    # K7's span and slot grid
    scaled = x.permute(0, 2, 1).reshape(P, C) / temp
    sid = sid3.reshape(P)
    for span, slots in itertools.product(args.rows_span or [None],
                                         args.rows_slots or [None]):
        if span:
            segment.K7_SPAN = rdefines["ROWS_SPAN"] = span
        if slots:
            segment.K7_SLOTS = rdefines["ROWS_NSLOT"] = slots
        _build._LIBS.pop("segment", None)
        log = _build.build_all(["segment"]).get("segment", "")
        vals, pix = segment.ssm_rows_fwd(scaled, sid, S)
        torch.cuda.synchronize()
        cs.check(digest(vals, pix) == base["k7_digest_aligned"],
                 f"K7 at span {span}, {slots} slots differs")
        print(json.dumps({
            "root": args.root, "card": smi, "rows_defines": dict(rdefines),
            "k7_ms": cs.time_ms(lambda: segment.ssm_rows_fwd(scaled, sid, S),
                                graph=True),
            "registers": [f"segment: {line}"
                          for line in cs.ptxas_summary(log)
                          if "rows" in line]}), flush=True)


def rows_case(cs, segment, x, sid3, S, temp, base, against):
    """K7 on the logits as rows divided by T under the nseg-4096 ids, on
    both views, and K3 (the control) under the nseg-2048 ids: checks,
    digests (held against the other run's where asked) and times, into
    base."""
    import torch

    dev = x.device
    B, C, HW = x.shape
    P = B * HW
    scaled = x.permute(0, 2, 1).reshape(P, C) / temp
    sid = sid3.reshape(P)
    store = torch.empty(P * C + 1, device=dev)
    store[1:] = scaled.reshape(-1)
    views = {"aligned": scaled, "unaligned": store[1:].view(P, C)}
    pvals, ppix = segment.ssm_rows_fwd_plain(scaled, sid, S)
    probs = torch.softmax(segment._round_bf16(scaled), dim=1)
    absent_p = ppix == P
    n_valid = int(((sid >= 0) & (sid < S)).sum())
    base["k7_valid_rows"] = n_valid
    base["k7_bound_ms"] = cs.bound(P * 4 + n_valid * C * 4 + S * C * 8,
                                   8 * n_valid * C)[0]
    base["k7_ms"] = {}
    for name, u in views.items():
        vals, pix = segment.ssm_rows_fwd(u, sid, S)
        torch.cuda.synchronize()
        absent = pix == P
        cs.check(torch.equal(absent, absent_p), f"K7 ({name}) absent sets")
        cs.check(bool((vals[absent] == 0).all()), f"K7 ({name}) absent 0.0")
        err = (vals - pvals).abs().max().item()
        cs.check(err <= 1e-6, f"K7 ({name}) max values differ by {err}")
        q = pix[~absent].long()
        cls = torch.arange(C, device=dev).expand(S, C)[~absent]
        tie = (probs[q, cls] - pvals[~absent]).abs().max().item()
        cs.check(tie <= 1e-6, f"K7 ({name}) argmax off the max by {tie}")
        base[f"k7_digest_{name}"] = digest(vals, pix)
        base[f"k7_bitwise_plain_{name}"] = bool(
            torch.equal(pix, ppix) and torch.equal(vals.view(torch.int32),
                                                   pvals.view(torch.int32)))
        if hasattr(segment, "rows_instance"):
            base[f"k7_instance_{name}"] = segment.rows_instance(u)
        base["k7_ms"][name] = cs.time_ms(
            lambda: segment.ssm_rows_fwd(u, sid, S), graph=True)
    cs.check(base["k7_digest_aligned"] == base["k7_digest_unaligned"],
             "K7 differs between its two views")
    del store, views, probs
    # K8 (its bf16 rounding is csrc/common.cuh's): its digest only
    base["k8_digest"] = digest(*segment.prereduce_softmax_rows(scaled, sid,
                                                               S))

    _, _, sid3k = cs.stage1_ids(cs.make_batches(1, seed=0)[0], dev, cs.NSEG)
    Sk = B * cs.NSEG
    vals, pix = segment.ssm_fwd(x, sid3k, Sk, temp)
    torch.cuda.synchronize()
    cs.check_k3(x, sid3k, Sk, temp, vals, pix, "K3")
    base["k3_digest"] = digest(vals, pix)
    base["k3_ms"] = cs.time_ms(lambda: segment.ssm_fwd(x, sid3k, Sk, temp),
                               graph=True)
    if against:
        other = json.loads(Path(against).read_text())
        for key in ("k7_digest_aligned", "k7_digest_unaligned", "k3_digest",
                    "k8_digest"):
            cs.check(other[key] == base[key],
                     f"{key} differs bitwise from {other['root']}")


if __name__ == "__main__":
    main()
