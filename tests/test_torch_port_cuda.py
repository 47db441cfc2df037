"""The port's CUDA kernels (K1-K10) against their plain PyTorch versions on
the card, at small and ragged shapes the recipe run does not reach (HW not
a multiple of the block, C from 3 to 31, underflow, absent segments), and
at the VOC recipe's instance of K1-K4 (C = 21 at run time, HW % 4 != 0).

Marked `cuda`: each test skips without a card. On a machine with one
(no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_port_cuda.py

Tolerances: K1 sums rtol 1e-5 and counts exact; K2 gradient max abs
error <= 1e-6 of its largest entry (as chip_smoke.py); K3 absent sets
exact, max values to 1e-6, and each kernel argmax pixel attains the plain
max within 1e-6 (the kernel multiplies by 1/z where the plain version
divides, so probabilities one ulp apart may order differently). K4 is fed
random cotangents, so dl = (dlm - w p) / T can cancel far below its
operands: its error is held to 8 float32 ulps (8 * 2**-23) of the largest
operand (|dlm| + |w| p) / T, on K3's outputs and on the pre-reduced
term's. K3's cases reach around its spans and shared slots
(segment.K3_SPAN, K3_SLOTS): ids colliding in a slot, more segments in a
span than slots, one segment per image, an exact tie across a span border
and ragged last spans. K5 (segment max of arbitrary values) is
exact: both outputs equal the plain version's (-0.0 counts as +0.0 on
both sides), on each of its load paths and with ids around its spans and
slots. K6 and K8 write bf16-rounded values: within one bf16 ulp
(2**-7 of the larger; the exps may differ by a float32 ulp, which can move
a value across a rounding boundary), retired ids exact, and a choice that
differs from the plain one must pick a same-segment pixel whose float32
probability is within 1e-6 of the plain pick's. K7 maxima to 1e-6 with
argmax pixels held as K3's; the row op's gradient (its plain backward,
which cancels in dl_elem - w p) against the CPU to 8 float32 ulps of its
largest operand, C. K9 and K10 as K1 and K2. K7 and K10 also run each
instance (C = 20 compiled or C at run time; 16-byte units, or 4-byte ones
for rows a few floats off 16-byte alignment or C % 4 != 0) and must give
the same bits on an offset view as on an aligned copy of it; K7's cases
reach around its spans and slots (segment.K7_SPAN, K7_SLOTS) as K3's do.
Selection and checkpoints have no kernel, but run on the card: the
scoring functions and the paper's selector are held against the CPU
(top-1 ids, votes and selected regions exactly, scores within 1e-5, as
the card's atomics add the segment sums in another order), and a
checkpoint of a model and AdamW state on the card loads back bitwise.
The criteria's group term runs K5 once an image on the softmax planes.
On N(0, 0.2^2) and on saturating N(0, 1) logits the card and the CPU
each lie within float32's own rounding of a float64 run
(chip_smoke.group_term_float64: the loss within 8 * 2^-24 * (1 + loss),
each gradient entry within 8 rounding units of its operands) outside
segments with a near-tie (chip_smoke.near_tie_pixels, 1e-6); on the
N(0, 0.2^2) logits also the card against the CPU as the CPU tests hold
the port against JAX (loss within rtol 1e-5, gradient within 1e-5 of
its largest entry). A needs_feat step (pwce, wgroup) on a small float32
model with TF32 off gives the CPU's loss parts within rtol 1e-5 and
launches K5 once (pwce) or twice (wgroup) an image. The evals: K5 at a
small instance of the top-1 selection probe (softmax planes under spmask
ids, an absent superpixel) bitwise its plain version at 19 and 20
classes;
top1_selection_counts on the card equal to the CPU's (K5 once an image);
SlidingEval on a small float32 model, TF32 off, with 2 x 4 windows and
with one centre-padded window, the summed logits within 1e-4 of the
largest and the renormalised features within 1e-4 of the CPU's. Data
parallelism: two ranks sharing the card under gloo against one rank
(BN, dropout, a fused step), as chip_smoke.py's dp phase, and three
criteria with K5 in their step (the joint, an online and mseg), as its
dp_criteria phase.
"""

import numpy as np
import pytest
import torch

from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
from mulactseg_tpu_torch.losses.fused import (
    lossdecomp_fused,
    pixel_target_bits,
)
from mulactseg_tpu_torch.ops import _build, pixel_loss, segment, segment_max

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(rng, B, C, HW):
    kind = rng.randint(0, 3, (B, 1, HW))
    c1 = rng.randint(0, C, (B, 1, HW))
    one = 1 << c1
    many = one | (1 << ((c1 + 1) % C)) | rng.randint(0, 2 ** C, (B, 1, HW))
    return np.where(kind == 0, 0, np.where(kind == 1, one, many)).astype(
        np.int32)


@pytest.mark.parametrize("B,C,HW,offset", [
    (2, 20, 33 * 31, 0), (1, 3, 700, 0), (3, 31, 4096, 0),
    (2, 20, 4096, 0), (2, 20, 4097, 0), (1, 7, 4098, 0), (2, 20, 4099, 0),
    (2, 20, 4096, 1), (1, 3, 700, 3),
    # VOC stage 1: C = 21 at run time, HW = 513 * 513 odd (a band of it)
    (2, 21, 513 * 7, 0), (1, 21, 4097, 2)])
def test_pixel_ce_kernels_match_plain(dev, B, C, HW, offset):
    """K1 and K2 on both class instances (C = 20 compiled, others at run
    time) and both layouts: 16-byte loads where HW % 4 == 0 and the
    logits are aligned, 4-byte loads for HW % 4 in {1, 2, 3} and for
    logits that are a contiguous slice `offset` floats into a larger
    storage. K1 is bitwise reproducible and launches once however it
    finishes its sums."""
    rng = np.random.RandomState(C + HW + offset)
    n = B * C * HW
    store = torch.from_numpy((rng.randn(n + offset) * 3).astype(
        np.float32)).to(dev)
    x = store[offset:].view(B, C, HW)
    assert x.is_contiguous()
    bits = torch.from_numpy(_bits(rng, B, C, HW)).to(dev)
    nc, vec = pixel_loss.instance(x, bits)
    assert nc == (20 if C == 20 else 0)
    assert vec == (HW % 4 == 0 and offset % 4 == 0)
    first = pixel_loss.pixel_ce_fwd(x, bits, 0.1)
    _build.reset_launches()
    got = pixel_loss.pixel_ce_fwd(x, bits, 0.1)
    want = pixel_loss.pixel_ce_fwd_plain(x, bits, 0.1)
    assert torch.equal(got, first)
    assert torch.equal(got[1::2], want[1::2])
    torch.testing.assert_close(got[0::2], want[0::2], rtol=1e-5, atol=0)
    g = torch.tensor([2.0, 3.0], device=dev)
    dl = pixel_loss.pixel_ce_bwd(x, bits, g, 0.1)
    want_dl = pixel_loss.pixel_ce_bwd_plain(x, bits, g, 0.1)
    assert (dl - want_dl).abs().max() <= 1e-6 * want_dl.abs().max()
    assert (dl[(bits == 0).expand(B, C, HW)] == 0).all()
    assert dict(_build.LAUNCHES) == {"pixel_ce_fwd": 1, "pixel_ce_bwd": 1}


@pytest.mark.parametrize("live", [False, True])
def test_pixel_ce_kernels_all_dead_or_all_live(dev, live):
    """Every pixel without a candidate (K1 sums 0, K2 writes zeros only)
    or every pixel with one, on the 16-byte path at C = 20."""
    rng = np.random.RandomState(11 + live)
    B, C, HW = 2, 20, 4096
    x = torch.from_numpy((rng.randn(B, C, HW) * 3).astype(np.float32)).to(dev)
    bits = _bits(rng, B, C, HW)
    bits = np.where(bits == 0, 1, bits) if live else np.zeros_like(bits)
    bits = torch.from_numpy(bits.astype(np.int32)).to(dev)
    got = pixel_loss.pixel_ce_fwd(x, bits, 0.1)
    want = pixel_loss.pixel_ce_fwd_plain(x, bits, 0.1)
    assert torch.equal(got[1::2], want[1::2])
    assert float(got[1] + got[3]) == (B * HW if live else 0)
    torch.testing.assert_close(got[0::2], want[0::2], rtol=1e-5, atol=0)
    g = torch.tensor([2.0, 3.0], device=dev)
    dl = pixel_loss.pixel_ce_bwd(x, bits, g, 0.1)
    want_dl = pixel_loss.pixel_ce_bwd_plain(x, bits, g, 0.1)
    assert (dl - want_dl).abs().max() <= 1e-6 * want_dl.abs().max()
    assert bool((dl != 0).any()) == live


def _segments(rng, B, C, HW, nseg, underflow):
    x = rng.randn(B, C, HW).astype(np.float32)
    if underflow:
        x[:, 0] -= 40.0  # class 0 underflows to exactly 0.0
    else:
        x[:, :, 1::2] = x[:, :, 0:HW - 1:2]  # exact ties between pixel pairs
    local = np.repeat(rng.randint(0, nseg + 2, (B, -(-HW // 16))), 16,
                      axis=1)[:, :HW]
    local[local == 3] = nseg  # segment 3 of each image is absent
    S = B * nseg
    sid = np.where(local >= nseg, S, local + np.arange(B)[:, None] * nseg)
    return x, sid.reshape(B, 1, HW).astype(np.int32), S


SPAN, NSLOT = segment.K3_SPAN, segment.K3_SLOTS


def _segments_of(kind, rng, B, C, HW, underflow):
    """(logits, sid3, S) for K3's cases around its spans and slots:
    runs   runs of 16 pixels over 9 segments a image (_segments);
    collide  runs of 4 whose ids are equal modulo NSLOT in groups of 8, so
           most runs of a span find their slot held by another id; 20% of
           runs invalid;
    distinct every valid pixel its own id, S = min(HW, 9215) of them, so a
           span holds more segments than slots;
    whole  one segment per image;
    ties   runs of 16, plus one segment per image across the first span
           border whose class-0 maximum (probability 1.0) is tied exactly
           between the last pixel of one span and the first of the next.
    """
    if kind == "runs":
        return _segments(rng, B, C, HW, 9, underflow)
    x = rng.randn(B, C, HW).astype(np.float32)
    if underflow:
        x[:, 0] -= 40.0
    if kind == "collide":
        S = 8 * NSLOT
        r = np.arange(-(-HW // 4))
        local = np.repeat((r * NSLOT + r // 8) % S, 4)[:HW]
        local = np.where(np.repeat(rng.rand(B, r.size) < 0.2, 4, axis=1)
                         [:, :HW], S, local)
        sid = local  # one id space for all images
    elif kind == "distinct":
        S = min(B * HW, 9215)
        sid = np.full(B * HW, S)
        sid[np.sort(rng.choice(B * HW, S, replace=False))] = np.arange(S)
        sid = sid.reshape(B, HW)
    elif kind == "whole":
        S = B
        sid = np.repeat(np.arange(B)[:, None], HW, axis=1)
    else:  # ties
        x, sid, S = _segments(rng, B, C, HW, 9, False)
        sid = sid.reshape(B, HW)
        # local id 3 is absent elsewhere; class 0 is low on the segment but
        # for the tied pair
        sid[:, SPAN - 40:SPAN + 40] = (np.arange(B) * 9 + 3)[:, None]
        x[:, 0, SPAN - 40:SPAN + 40] = -10.0
        x[:, 0, SPAN - 1] = 50.0
        x[:, :, SPAN] = x[:, :, SPAN - 1]
    return x, sid.reshape(B, 1, HW).astype(np.int32), S


@pytest.mark.parametrize("kind,B,C,HW,underflow", [
    ("runs", 2, 20, 33 * 31, False), ("runs", 2, 20, 33 * 31, True),
    ("runs", 3, 7, 4096, False), ("runs", 3, 7, 4096, True),
    ("collide", 2, 20, 2 * SPAN + 100, False),
    ("distinct", 1, 20, 2 * SPAN + 5, False),
    ("whole", 2, 7, SPAN + 333, False), ("whole", 2, 20, SPAN + 333, True),
    ("ties", 2, 20, 2 * SPAN, False),
    # VOC stage 1: C = 21 at run time, HW = 513 * 513 odd (a band of it)
    ("runs", 2, 21, 513 * 7, False), ("runs", 2, 21, 513 * 7, True),
    ("collide", 2, 21, 2 * SPAN + 513, False)])
def test_segment_kernels_match_plain(dev, kind, B, C, HW, underflow):
    """K3 against its plain version, then K4 on K3's outputs (which meet
    K4's precondition) against the dense plain backward. HW is ragged
    (not a multiple of SPAN) in the collide, distinct and whole cases."""
    rng = np.random.RandomState(HW + C)
    x, sid3, S = _segments_of(kind, rng, B, C, HW, underflow)
    x, sid3 = torch.from_numpy(x).to(dev), torch.from_numpy(sid3).to(dev)
    P = B * HW
    _build.reset_launches()
    vals, pix = segment.ssm_fwd(x, sid3, S, 0.1)
    pvals, ppix = segment.ssm_fwd_plain(x, sid3, S, 0.1)
    absent = pix == P
    assert torch.equal(absent, ppix == P) and (~absent).any()
    # every id is present in the whole and distinct cases
    assert bool(absent.any()) == (kind in ("runs", "collide", "ties"))
    assert (vals[absent] == 0).all()
    assert (vals - pvals).abs().max() <= 1e-6
    probs = segment._softmax(x, 0.1)
    q = pix[~absent].long()
    cls = torch.arange(C, device=dev).expand(S, C)[~absent]
    assert (probs[q // HW, cls, q % HW] - pvals[~absent]).abs().max() <= 1e-6
    # every segment with a valid pixel records one for every class, the
    # underflowed class (probability exactly 0.0) included, inside itself
    seg_present = torch.zeros(S, dtype=torch.bool, device=dev)
    seg_present[sid3[sid3 < S].long()] = True
    assert torch.equal(~absent, seg_present[:, None].expand(S, C))
    seg = torch.arange(S, device=dev)[:, None].expand(S, C)[~absent]
    assert torch.equal(sid3.reshape(P)[q].long(), seg)
    if underflow:
        assert (vals[:, 0] == 0).all()
    if kind == "ties":
        # the tie across the span border goes to the earlier pixel
        tied = torch.arange(B, device=dev) * 9 + 3
        assert (vals[tied, 0] == 1.0).all()
        assert torch.equal(pix[tied, 0].long(),
                           torch.arange(B, device=dev) * HW + SPAN - 1)

    g = torch.from_numpy(rng.randn(S, C).astype(np.float32)).to(dev)
    g[0] = 0.0  # a row of zero cotangents
    g[-1, :C // 2] = 0.0  # and a row with some
    dl = segment.ssm_bwd(x, sid3, vals, pix, g, 0.1)
    want = segment.ssm_bwd_plain(x, vals, pix, g, 0.1)
    assert dict(_build.LAUNCHES) == {"ssm_fwd": 1, "ssm_bwd": 1}
    live = (pix < P) & (g != 0)
    dlm = torch.zeros(B, C, HW, device=dev)
    dlm[q // HW, cls, q % HW] = (g * vals)[~absent]
    w = dlm.sum(dim=1, keepdim=True)
    operand = ((dlm.abs() + w.abs() * probs) / 0.1).max()
    assert live.any() and operand > 0
    assert (dl - want).abs().max() <= 8 * 2.0 ** -23 * operand


@pytest.mark.parametrize("C,H,W,nseg", [(20, 37, 29, 12),
                                        (21, 41, 33, 30)])  # VOC: C = 21
def test_lossdecomp_on_card_matches_cpu(dev, C, H, W, nseg):
    rng = np.random.RandomState(3)
    B = 2
    spx = np.stack([irregular_superpixels(H, W, nseg, rng)
                    for _ in range(B)]).astype(np.int32)
    target = (rng.rand(B, nseg, C) < 0.2).astype(np.float32)
    spmask = np.take_along_axis(rng.rand(B, nseg) < 0.7, spx.reshape(B, -1),
                                axis=1).reshape(B, H, W)
    bits = np.stack([pixel_target_bits(target[b], spx[b], spmask[b])
                     for b in range(B)])
    logits = (rng.randn(B, C, H, W) * 3).astype(np.float32)
    out = []
    for d in ("cpu", dev):
        x = torch.from_numpy(logits).to(d).requires_grad_(True)
        total, aux = lossdecomp_fused(
            x, torch.from_numpy(bits).to(d), torch.from_numpy(target).to(d),
            torch.from_numpy(spx).to(d), nseg=nseg)
        total.backward()
        out.append(({k: float(v.detach()) for k, v in aux.items()},
                    x.grad.cpu()))
    (ref, gref), (got, ggot) = out
    for k in ref:
        assert ref[k] > 0
        assert got[k] == pytest.approx(ref[k], rel=1e-5), k
    assert (ggot - gref).abs().max() <= 1e-5 * gref.abs().max()


@pytest.mark.parametrize("P,C,signed", [(33 * 31, 20, False),
                                        (4096 + 17, 7, True)])
@pytest.mark.parametrize("planes", [False, True])
def test_segment_max_kernel_matches_plain(dev, P, C, signed, planes):
    rng = np.random.RandomState(P + C)
    S = 11
    if signed:
        # signed values rounded to 1/8: negative values and exact ties,
        # with -0.0 and +0.0 mixed in
        v = np.round(rng.randn(P, C) * 8) / 8
        v[rng.rand(P, C) < 0.1] = -0.0
    else:
        v = rng.rand(P, C)
    v = v.astype(np.float32)
    sid = np.repeat(rng.randint(0, S + 2, -(-P // 13)), 13)[:P]
    sid[sid == 3] = S  # segment 3 is absent; ids > S are invalid too
    v[sid == 5] = 0.0  # a present segment of 0.0 values
    sid = torch.from_numpy(sid.astype(np.int32)).to(dev)
    values = torch.from_numpy(v).to(dev)
    if planes:
        values = values.t().contiguous().t()
    _build.reset_launches()
    vals, pix = segment_max.seg_max_fwd(values, sid, S)
    pvals, ppix = segment_max.segment_max_plain(values, sid, S)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"seg_max_fwd": 1}
    assert torch.equal(pix, ppix) and torch.equal(vals, pvals)
    assert (pix[3] == P).all() and (vals[3] == 0).all()
    assert (pix[5] < P).all() and (vals[5] == 0).all()


def _k5_ids(kind, rng, P, S):
    """K5's ids around its spans and slots (S = 8 * K5_SLOTS):
    collide  runs of 4 whose ids are equal modulo K5_SLOTS in groups of 8,
             so most runs of a span find their slot held; 20% invalid;
    retired  runs of 12 of one id with 3 of every 4 pixels retired (S),
             as K6 leaves them, so valid pixels of a run are interleaved
             with invalid ones;
    plbl     runs of 40 over 64 ids with 70% of the runs invalid.
    Segment 3 is absent in each."""
    NSLOT = segment_max.K5_SLOTS
    if kind == "collide":
        r = np.arange(-(-P // 4))
        ids = np.repeat((r * NSLOT + r // 8) % S, 4)[:P]
        ids = np.where(np.repeat(rng.rand(r.size) < 0.2, 4)[:P], S, ids)
    elif kind == "retired":
        ids = np.repeat(rng.randint(0, S, -(-P // 12)), 12)[:P]
        ids = np.where((np.arange(P) % 4 != 0) & (rng.rand(P) < 0.9), S,
                       ids)
    else:
        ids = np.repeat(rng.randint(0, 64, -(-P // 40)), 40)[:P]
        ids = np.where(np.repeat(rng.rand(-(-P // 40)) < 0.7, 40)[:P], S,
                       ids)
    return np.where(ids == 3, S, ids)


@pytest.mark.parametrize("kind", ["collide", "retired", "plbl"])
@pytest.mark.parametrize("C,planes", [(20, True), (20, False), (7, True),
                                      (7, False)])
def test_segment_max_kernel_layouts(dev, kind, C, planes):
    """K5 on each load path (planes: (C, P) planes through .t(), P % 4 ==
    0; rows: a contiguous (P, C) array, the 16-byte path at C = 20, 4-byte
    loads at C = 7) with ids that collide in its shared slots, interleave
    retired pixels or leave long invalid runs, and with values in exact
    ties across span borders (each value repeats 3 spans later):
    bitwise equal to the plain version."""
    rng = np.random.RandomState(C + len(kind))
    SPAN = segment_max.K5_SPAN
    P, S = 5 * SPAN + 64, 8 * segment_max.K5_SLOTS
    v = (np.round(rng.rand(P, C) * 16) / 16).astype(np.float32)
    v[3 * SPAN:] = v[:P - 3 * SPAN]
    sid = torch.from_numpy(_k5_ids(kind, rng, P, S).astype(np.int32)).to(dev)
    values = torch.from_numpy(v).to(dev)
    if planes:
        values = values.t().contiguous().t()
    assert segment_max.layout(values) == (
        segment_max.PLANES if planes else
        segment_max.ROWS if C % 4 == 0 else segment_max.ANY)
    _build.reset_launches()
    vals, pix = segment_max.seg_max_fwd(values, sid, S)
    pvals, ppix = segment_max.segment_max_plain(values, sid, S)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"seg_max_fwd": 1}
    assert torch.equal(pix, ppix)
    assert torch.equal(vals.view(torch.int32), pvals.view(torch.int32))
    assert (pix < P).any() and (pix == P).any()


def _rows(rng, P, C, underflow):
    """(P, C) rows scaled by 1/T = 10 with exact ties between row pairs (or
    an underflowed class), runs of 6 rows, absent segment 3 and 5% invalid
    rows; S = 11."""
    x = rng.randn(P, C).astype(np.float32)
    if underflow:
        x[:, 0] -= 40.0
    else:
        x[1::2] = x[0:P - 1:2]
    S = 11
    sid = np.repeat(rng.randint(0, S, -(-P // 6)), 6)[:P]
    sid[sid == 3] = S
    sid[rng.rand(P) < 0.05] = S
    return (x * 10).astype(np.float32), sid.astype(np.int32), S


def _check_prereduce(got, want, probs, sid, B, HW):
    """K6/K8 outputs (planes (C, P), choice (C, B*nb), sid2) against the
    plain version's; probs (C, P) float32 are the plain probabilities."""
    (planes, choice, sid2), (pplanes, pchoice, psid2) = got, want
    # + 1e-38: a subnormal probability keeps fewer bits in bf16
    tol = 2.0 ** -7 * torch.maximum(planes.abs(), pplanes.abs()) + 1e-38
    assert ((planes - pplanes).abs() <= tol).all()
    assert (planes == pplanes).float().mean() > 0.999
    assert torch.equal(sid2, psid2)
    C, NB = choice.shape
    nb = NB // B
    blk = torch.arange(NB, device=choice.device)
    lead = (blk // nb) * HW + (blk % nb) * 4
    differ = choice != pchoice
    q, pq = lead + choice.long(), lead + pchoice.long()
    assert ((blk % nb) * 4 + choice < HW).all()
    cls = torch.arange(C, device=choice.device)[:, None].expand(C, NB)
    assert (sid[q[differ]] == sid[lead.expand(C, NB)[differ]]).all()
    assert ((probs[cls, q] - probs[cls, pq]).abs()[differ] <= 1e-6).all()


@pytest.mark.parametrize("B,C,HW,offset", [
    (2, 20, 33 * 31, 0), (3, 7, 4096, 0), (2, 20, 4096, 0), (2, 20, 4096, 1),
    (2, 20, 4098, 0), (1, 7, 700, 3)])
def test_prereduce_nchw_kernel_matches_plain(dev, B, C, HW, offset):
    """K6, and the pre-reduced group term it feeds (K6, K5, map back), on
    both class instances and both paths: the 16-byte path where HW % 4 ==
    0 and the logits are aligned, the 4-byte path at a ragged HW (a short
    last block per image) and for logits `offset` floats into a larger
    storage."""
    rng = np.random.RandomState(HW + C + 1)
    x, sid3, S = _segments(rng, B, C, HW, 9, False)
    store = torch.from_numpy(np.concatenate(
        [np.zeros(offset, np.float32), x.reshape(-1)])).to(dev)
    x, sid3 = store[offset:].view(B, C, HW), torch.from_numpy(sid3).to(dev)
    assert segment.prereduce_instance(x, sid3) == (
        20 if C == 20 else 0, HW % 4 == 0 and offset % 4 == 0)
    _build.reset_launches()
    got = segment.prereduce_softmax_nchw(x, sid3, S, 0.1)
    want = segment.prereduce_plain(x, sid3.reshape(B, HW), S, 0.1)
    probs = segment._softmax(x, 0.1).permute(1, 0, 2).reshape(C, B * HW)
    _check_prereduce(got, want, probs, sid3.reshape(-1), B, HW)
    vals, pix = segment._ssm_prereduced(x, sid3, S, 0.1)
    assert dict(_build.LAUNCHES) == {"prereduce_nchw": 2, "seg_max_fwd": 1}
    P = B * HW
    # K4 on the pre-reduced outputs, against the dense plain backward
    g = torch.from_numpy(rng.randn(S, C).astype(np.float32)).to(dev)
    dl = segment.ssm_bwd(x, sid3, vals, pix, g, 0.1)
    want_dl = segment.ssm_bwd_plain(x, vals, pix, g, 0.1)
    live = pix < P
    dlm = torch.zeros(B, C, HW, device=dev)
    ql = pix[live].long()
    dlm[ql // HW, torch.arange(C, device=dev).expand(S, C)[live],
        ql % HW] = (g * vals)[live]
    operand = ((dlm.abs() + dlm.sum(dim=1, keepdim=True).abs()
                * segment._softmax(x, 0.1)) / 0.1).max()
    assert operand > 0
    assert (dl - want_dl).abs().max() <= 8 * 2.0 ** -23 * operand
    absent = pix == P
    pvals, ppix = segment.ssm_fwd_plain(x, sid3, S, 0.1)
    assert torch.equal(absent, ppix == P) and absent.any()
    assert torch.equal(vals, segment._round_bf16(vals))
    assert ((vals - pvals).abs() <= 2.0 ** -7 * pvals + 1e-38).all()
    q = pix[~absent].long()
    cls = torch.arange(C, device=dev).expand(S, C)[~absent]
    seg = torch.arange(S, device=dev)[:, None].expand(S, C)[~absent]
    assert torch.equal(sid3.reshape(P)[q], seg)
    assert ((probs[cls, q] - pvals[~absent]).abs()
            <= 2.0 ** -7 * pvals[~absent] + 1e-6).all()


@pytest.mark.parametrize("P,C", [(2 * 33 * 31, 20), (4096 + 17, 7)])
def test_prereduce_rows_kernel_matches_plain(dev, P, C):
    """K8 over (P, C) rows, one run of blocks from row 0 (P % 4 != 0 in
    both shapes)."""
    rng = np.random.RandomState(P + C)
    u, sid, S = _rows(rng, P, C, False)
    u, sid = torch.from_numpy(u).to(dev), torch.from_numpy(sid).to(dev)
    _build.reset_launches()
    got = segment.prereduce_softmax_rows(u, sid, S)
    want = segment.prereduce_plain(u.t()[None], sid[None], S, 1.0)
    assert dict(_build.LAUNCHES) == {"prereduce_rows": 1}
    _check_prereduce(got, want, torch.softmax(u, dim=1).t(), sid, 1, P)


@pytest.mark.parametrize("underflow", [False, True])
@pytest.mark.parametrize("P,C", [(2 * 33 * 31, 20), (4096 + 17, 7)])
def test_segment_rows_kernel_matches_plain(dev, P, C, underflow):
    """K7 over (P, C) rows, and one autograd pass of the row op."""
    rng = np.random.RandomState(P + C + underflow)
    u, sid, S = _rows(rng, P, C, underflow)
    u, sid = torch.from_numpy(u).to(dev), torch.from_numpy(sid).to(dev)
    _build.reset_launches()
    vals, pix = segment.ssm_rows_fwd(u, sid, S)
    pvals, ppix = segment.ssm_rows_fwd_plain(u, sid, S)
    assert dict(_build.LAUNCHES) == {"ssm_rows_fwd": 1}
    absent = pix == P
    assert torch.equal(absent, ppix == P) and absent.any()
    assert (vals[absent] == 0).all()
    assert (vals - pvals).abs().max() <= 1e-6
    ur = segment._round_bf16(u)
    probs = torch.softmax(ur, dim=1)
    q = pix[~absent].long()
    cls = torch.arange(C, device=dev).expand(S, C)[~absent]
    assert (probs[q, cls] - pvals[~absent]).abs().max() <= 1e-6
    seg = torch.arange(S, device=dev)[:, None].expand(S, C)[~absent]
    assert torch.equal(sid[q], seg)
    if underflow:
        assert (vals[~absent[:, 0], 0] == 0).all()

    ut = u.clone().requires_grad_(True)
    mx, _ = segment.segment_softmax_max(ut, sid, S)
    mx.sum().backward()
    cpu = u.cpu().requires_grad_(True)
    mxc, _ = segment.segment_softmax_max(cpu, sid.cpu(), S)
    mxc.sum().backward()
    # dl = dl_elem - w p cancels: with g = 1 its operands are at most C
    # (w sums up to C entries g p_c <= 1), so hold it to 8 ulps of C
    assert (ut.grad.cpu() - cpu.grad).abs().max() <= 8 * 2.0 ** -23 * C


@pytest.mark.parametrize("N,C", [(33 * 31, 20), (4096 + 3, 31)])
def test_pixel_ce_rows_kernels_match_plain(dev, N, C):
    """K9 and K10 over (N, C) rows."""
    rng = np.random.RandomState(N + C)
    x = torch.from_numpy((rng.randn(N, C) * 3).astype(np.float32)).to(dev)
    bits = torch.from_numpy(_bits(rng, 1, C, N).reshape(N)).to(dev)
    _build.reset_launches()
    got = pixel_loss.pixel_ce_rows_fwd(x, bits, 0.1)
    want = pixel_loss.pixel_ce_fwd_plain(x.t()[None], bits[None, None], 0.1)
    assert torch.equal(got[1::2], want[1::2])
    torch.testing.assert_close(got[0::2], want[0::2], rtol=1e-5, atol=0)
    g = torch.tensor([2.0, 3.0], device=dev)
    dl = pixel_loss.pixel_ce_rows_bwd(x, bits, g, 0.1)
    want_dl = pixel_loss.pixel_ce_bwd_plain(x.t()[None], bits[None, None], g,
                                            0.1)[0].t()
    assert (dl - want_dl).abs().max() <= 1e-6 * want_dl.abs().max()
    assert dict(_build.LAUNCHES) == {"pixel_ce_rows_fwd": 1,
                                     "pixel_ce_rows_bwd": 1}


K7_SPAN, K7_SLOTS = segment.K7_SPAN, segment.K7_SLOTS


def _rows_of(kind, rng, P, C):
    """(rows divided by T, sid, S) for K7's cases:
    runs     _rows (runs of 6 over 11 ids, ties between row pairs, 5%
             invalid);
    collide  runs of 4 whose ids are equal modulo K7_SLOTS in groups of
             8, so most runs of a span find their slot held by another
             id; 20% of runs invalid;
    ties     runs of 6, plus one segment across the first span border whose
             class-0 maximum is tied exactly between the last row of one
             span and the first of the next."""
    if kind == "runs":
        return _rows(rng, P, C, False)
    x = rng.randn(P, C).astype(np.float32)
    if kind == "collide":
        S = 8 * K7_SLOTS
        r = np.arange(-(-P // 4))
        sid = np.repeat((r * K7_SLOTS + r // 8) % S, 4)[:P]
        sid = np.where(np.repeat(rng.rand(r.size) < 0.2, 4)[:P], S, sid)
    else:
        x, sid, S = _rows(rng, P, C, False)
        x = x / 10
        sid[K7_SPAN - 40:K7_SPAN + 40] = 3  # absent elsewhere
        x[K7_SPAN - 40:K7_SPAN + 40, 0] = -10.0
        x[K7_SPAN - 1, 0] = 5.0
        x[K7_SPAN] = x[K7_SPAN - 1]
    return (x * 10).astype(np.float32), sid.astype(np.int32), S


def _offset_view(a, offset, dev):
    """a (numpy) as a contiguous CUDA tensor `offset` floats into a larger
    storage."""
    store = torch.zeros(a.size + offset, dtype=torch.float32, device=dev)
    store[offset:] = torch.from_numpy(a.reshape(-1)).to(dev)
    return store[offset:].view(a.shape)


@pytest.mark.parametrize("kind,P,C,offset,want", [
    ("runs", 2 * 33 * 31, 20, 1, (20, False)),
    ("runs", 4096 + 17, 8, 0, (0, True)), ("runs", 4096 + 17, 8, 2, (0, False)),
    ("runs", 1000, 32, 4, (0, True)), ("runs", 1000, 31, 0, (0, False)),
    ("collide", 2 * K7_SPAN + 100, 20, 0, (20, True)),
    ("collide", 2 * K7_SPAN + 100, 20, 3, (20, False)),
    ("ties", 2 * K7_SPAN, 20, 0, (20, True))])
def test_segment_rows_kernel_instances(dev, kind, P, C, offset, want):
    """K7 on each instance, held as in test_segment_rows_kernel_matches_plain
    and bitwise equal to itself on an aligned copy of the rows."""
    rng = np.random.RandomState(P + C + offset)
    u, sid, S = _rows_of(kind, rng, P, C)
    x = _offset_view(u, offset, dev)
    sid = torch.from_numpy(sid).to(dev)
    assert segment.rows_instance(x) == want
    _build.reset_launches()
    vals, pix = segment.ssm_rows_fwd(x, sid, S)
    avals, apix = segment.ssm_rows_fwd(x.clone(), sid, S)
    assert dict(_build.LAUNCHES) == {"ssm_rows_fwd": 2}
    assert torch.equal(pix, apix)
    assert torch.equal(vals.view(torch.int32), avals.view(torch.int32))
    pvals, ppix = segment.ssm_rows_fwd_plain(x, sid, S)
    absent = pix == P
    assert torch.equal(absent, ppix == P) and (~absent).any()
    assert (vals[absent] == 0).all()
    assert (vals - pvals).abs().max() <= 1e-6
    probs = torch.softmax(segment._round_bf16(x), dim=1)
    q = pix[~absent].long()
    cls = torch.arange(C, device=dev).expand(S, C)[~absent]
    assert (probs[q, cls] - pvals[~absent]).abs().max() <= 1e-6
    seg = torch.arange(S, device=dev)[:, None].expand(S, C)[~absent]
    assert torch.equal(sid[q], seg)
    if kind == "ties":
        # the tie across the span border goes to the earlier row
        assert pix[3, 0] == K7_SPAN - 1


@pytest.mark.parametrize("N,C,offset,kind,want", [
    (33 * 31, 20, 1, "mixed", (20, False)),
    (4096 + 3, 8, 0, "mixed", (0, True)), (4096 + 3, 8, 2, "mixed", (0, False)),
    (1000, 28, 4, "mixed", (0, True)), (700, 31, 0, "mixed", (0, False)),
    (2 * 512 + 3, 20, 0, "dead", (20, True)),
    (2 * 512 + 3, 20, 0, "live", (20, True))])
def test_pixel_ce_rows_bwd_instances(dev, N, C, offset, kind, want):
    """K10 on each instance (C = 28 and 31 need more than 48 KB of shared
    memory a block), with a short last tile, against its plain version and
    bitwise equal to itself on an aligned copy of the rows; dead rows get
    exact zeros."""
    rng = np.random.RandomState(N + C + offset)
    xn = (rng.randn(N, C) * 3).astype(np.float32)
    bn = _bits(rng, 1, C, N).reshape(N)
    if kind != "mixed":
        bn = np.where(bn == 0, 1, bn) if kind == "live" else np.zeros_like(bn)
    x = _offset_view(xn, offset, dev)
    bits = torch.from_numpy(bn.astype(np.int32)).to(dev)
    assert pixel_loss.rows_instance(x, bits) == want
    g = torch.tensor([2.0, 3.0], device=dev)
    _build.reset_launches()
    dl = pixel_loss.pixel_ce_rows_bwd(x, bits, g, 0.1)
    adl = pixel_loss.pixel_ce_rows_bwd(x.clone(), bits, g, 0.1)
    assert dict(_build.LAUNCHES) == {"pixel_ce_rows_bwd": 2}
    assert torch.equal(dl.view(torch.int32), adl.view(torch.int32))
    want_dl = pixel_loss.pixel_ce_bwd_plain(x.t()[None], bits[None, None], g,
                                            0.1)[0].t()
    assert (dl - want_dl).abs().max() <= 1e-6 * want_dl.abs().max()
    assert (dl[bits == 0] == 0).all()
    assert bool((dl != 0).any()) == (kind != "dead")


# -- selection and checkpoints on the card (no kernel of their own) ----------

def test_scoring_on_card_matches_cpu(dev):
    """The scoring functions on the card against the CPU on the same
    logits, with exact ties in the top-1 class and absent regions: top-1
    ids, votes and the absent regions' 0.0 exactly, float values within
    1e-5 (atomics add the segment sums in another order)."""
    from mulactseg_tpu_torch.acquisition import scoring

    rng = np.random.RandomState(21)
    B, C, H, W, nseg = 3, 20, 37, 29, 40
    logits = (rng.randn(B, C, H, W) * 3).astype(np.float32)
    tie = rng.rand(B, H, W) < 0.1
    logits[:, 2] = np.where(tie, logits.max(axis=1), logits[:, 2])
    logits[:, 5] = np.where(tie, logits.max(axis=1), logits[:, 5])
    spx = rng.randint(0, nseg - 2, (B, H, W)).astype(np.int32)
    out = {}
    for d in ("cpu", dev):
        lt = torch.from_numpy(logits).to(d)
        st = torch.from_numpy(spx).to(d)
        bv, t1 = scoring.bvsb_top1(lt, 0.1)
        w = scoring.cls_weight_pwr(scoring.mean_softmax(lt, 0.1), 8.0)
        r, v = scoring.region_weighted_bvsb_and_votes(lt, st, w, nseg=nseg,
                                                      temp=0.1)
        plain = scoring.region_bvsb_scores(lt, st, nseg=nseg, temp=0.1,
                                           drop_last=True)
        n = scoring.minmax_normalize(plain)
        out[str(d)] = [x.cpu() for x in (bv, t1, w, r, v, plain, n,
                                         scoring.ban_ignore_dominant(n, v))]
    cpu, card = out["cpu"], out[str(dev)]
    for i in (1, 4):  # top-1 ids, votes
        assert torch.equal(cpu[i], card[i]), i
    for i in (0, 2, 3, 5, 6, 7):
        assert (cpu[i] - card[i]).abs().max() <= 1e-5, i
    for i in (3, 5):
        assert (card[i][:, nseg - 2:] == 0).all()


def test_selector_on_card_matches_cpu(dev, tmp_path):
    """The paper's selector with a stub trainer whose logits lie on the
    card, against the same logits on the CPU: the same regions in the
    same order, scores within 1e-5."""
    from mulactseg_tpu_torch.acquisition import get_selector
    from mulactseg_tpu_torch.active import RegionActiveSet
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.data.synthetic import SyntheticRegionDataset

    class Stub:
        def __init__(self, d):
            self.d = d

        def predict_logits(self, images):
            x = torch.as_tensor(images).to(self.d)
            w = torch.linspace(-2.0, 2.0, 3 * 7, device=self.d).view(7, 3)
            return torch.einsum("bchw,kc->bkhw", x, w) * 3

    got = {}
    for d in ("cpu", dev):
        cfg = Config(num_classes=6, nseg=16, val_batch_size=3,
                     val_num_workers=1, model_save_dir=str(tmp_path / str(d)))
        kw = dict(n_images=5, H=40, W=36, num_classes=6, nseg=16, seed=2)
        pool = SyntheticRegionDataset(split="active-ulabel", **kw)
        label = SyntheticRegionDataset(**kw)
        label.suppix, label.im_idx = {}, []
        active = RegionActiveSet(cfg, pool, label)
        sel = get_selector("my_bvsb_predclsbal_pwr_banignore", cfg)
        scores = sel.calculate_scores(Stub(d), pool)
        counts = sel.select_next_batch(Stub(d), active, 20)
        got[str(d)] = (scores, counts, label.suppix)
    (cs, cc, cl), (gs, gc, gl) = got["cpu"], got[str(dev)]
    assert [s[1:] for s in cs] == [s[1:] for s in gs]
    assert max(abs(a[0] - b[0]) for a, b in zip(cs, gs)) <= 1e-5
    assert cc == gc and cl == gl and cc[0] > 0


def test_checkpoint_round_trip_on_card(dev, tmp_path):
    """A model and AdamW state on the card, saved and loaded back into a
    fresh model and optimizer on the card: bitwise the same."""
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.engine.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from mulactseg_tpu_torch.engine.state import make_optimizer

    def build(seed):
        torch.manual_seed(seed)
        m = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3),
                                torch.nn.BatchNorm2d(8)).to(dev)
        return m, make_optimizer(m, Config(), total_itrs=5)

    model, opt = build(0)
    for _ in range(2):
        model(torch.randn(2, 3, 9, 9, device=dev)).square().mean().backward()
        opt.step()
    path = str(tmp_path / "checkpoint01")
    save_checkpoint(path, model, opt, step=2)
    payload = load_checkpoint(path)
    fresh, fopt = build(1)
    fresh.load_state_dict(payload["model_state_dict"])
    fopt.load_state_dict(payload["optimizer_state_dict"])
    assert payload["step"] == 2
    for k, t in model.state_dict().items():
        assert fresh.state_dict()[k].device.type == dev.type
        assert torch.equal(fresh.state_dict()[k], t), k
    a, b = opt.state_dict()["state"], fopt.state_dict()["state"]
    assert a.keys() == b.keys() and len(a)
    for i in a:
        for k, t in a[i].items():
            assert torch.equal(b[i][k].to(t.device), t), (i, k)


def test_resampler_built_on_the_card_host(dev):
    """csrc/resample.cpp built by g++ on the card's host (-march=native
    there) gives the numpy statement of Pillow's filter, on random boxes
    and on a recipe-size window (1024x2048 source, 768x768 crop)."""
    import importlib.util
    from pathlib import Path

    from mulactseg_tpu_torch import native

    # by path: another installed package may own the name `tests`
    spec = importlib.util.spec_from_file_location(
        "resample_reference",
        Path(__file__).with_name("test_torch_port_resample.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    _random_case, numpy_resize_bilinear = (ref._random_case,
                                           ref.numpy_resize_bilinear)
    assert native.build().exists()
    rng = np.random.RandomState(0)
    cases = [_random_case(rng) for _ in range(20)]
    src = rng.randint(0, 256, (1024, 2048, 3)).astype(np.uint8)
    cases.append((src[100:700, 300:1000], (768, 768),
                  (1.3, 2.7, 690.1, 590.4)))
    for img, size, box in cases:
        np.testing.assert_array_equal(
            native.resize_bilinear_u8(img, size, box=box),
            numpy_resize_bilinear(img, size, box),
            err_msg=str((img.shape, size, box)))


def test_process_loader_at_recipe_size(dev, tmp_path):
    """The recipe's training items (1024x2048 adaptive-filtered PNGs,
    nseg 2048 superpixels, rescale_769_multi_notrg, batch 4) built in 4
    worker processes equal the items of one process drawing in item
    order, and reach the card unchanged."""
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.data.datasets import RegionDatasetOr
    from mulactseg_tpu_torch.data.loader import DataProvider, collate
    from mulactseg_tpu_torch.data.transforms import get_train_transform
    from mulactseg_tpu_torch.tools.cityscapes_tree import write_tree

    root = str(tmp_path / "data")
    dl = write_tree(root, 4, 0, 1024, 2048, 2048, seed=0, processes=4)
    cfg = Config(data_root=root, datalist_dir=dl).derive_paths()

    def dataset():
        return RegionDatasetOr(
            cfg, cfg.trg_datalist, cfg.region_dict, "active-label",
            transform=get_train_transform(cfg.train_transform, cfg, seed=0))

    loader = DataProvider(dataset(), 4, infinite=False, num_workers=4,
                          seed=0)
    (got,) = list(loader)
    loader.close()
    order = np.arange(4)
    np.random.RandomState(0).shuffle(order)
    ref = dataset()
    want = collate([ref[int(i)] for i in order])
    assert got["images"].shape == (4, 3, 768, 768)
    assert got["fnames"] == want["fnames"]
    for k in ("images", "target", "spx", "spmask", "target_bits"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        on_card = torch.as_tensor(got[k]).to(dev)
        assert torch.equal(on_card.cpu(), torch.as_tensor(want[k])), k


def _region_batch(rng, B, H, W, nseg, C):
    spx = np.stack([irregular_superpixels(H, W, nseg, rng)
                    for _ in range(B)]).astype(np.int32)
    target = np.zeros((B, nseg, C), np.float32)
    for b in range(B):
        for s in range(nseg):
            n = rng.choice([0, 1, 2, 3], p=[0.15, 0.45, 0.25, 0.15])
            target[b, s, rng.choice(C, n, replace=False)] = 1.0
    spmask = np.take_along_axis(rng.rand(B, nseg) < 0.6, spx.reshape(B, -1),
                                1).reshape(B, H, W)
    return {"target": target, "spx": spx, "spmask": spmask}


@pytest.mark.parametrize("H,W,only_multi,scale", [
    (48, 40, False, 0.2), (37, 29, True, 0.2),
    (48, 40, False, 1.0), (37, 29, True, 1.0)])
def test_group_term_through_k5_matches_cpu(dev, H, W, only_multi, scale):
    from chip_smoke import group_term_float64, near_tie_pixels
    from mulactseg_tpu_torch.losses.partial import group_multi_label_ce

    rng = np.random.RandomState(H)
    B, C, nseg = 2, 7, 20
    batch = _region_batch(rng, B, H, W, nseg, C)
    logits = (rng.randn(B, C, H, W) * scale).astype(np.float32)
    args = [batch[k] for k in ("target", "spx", "spmask")]
    out = []
    _build.reset_launches()
    for d in ("cpu", dev):
        x = torch.from_numpy(logits).to(d).requires_grad_(True)
        loss = group_multi_label_ce(
            x, *(torch.from_numpy(a).to(d) for a in args),
            nseg=nseg, temp=0.1, slice_last=False, only_multi=only_multi)
        loss.backward()
        out.append((float(loss.detach()), x.grad.cpu().double()))
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"seg_max_fwd": B}
    l64, g64, unit = group_term_float64(logits, *args, nseg, temp=0.1,
                                        only_multi=only_multi)
    mask = batch["spmask"].reshape(B, -1)
    if only_multi:
        multi = batch["target"].sum(-1) > 1
        mask = mask & np.take_along_axis(multi, batch["spx"].reshape(B, -1),
                                         1)
    sid = np.where(mask, batch["spx"].reshape(B, -1), nseg)
    probs = torch.softmax(torch.from_numpy(logits).reshape(B, C, -1) / 0.1,
                          dim=1)
    ties = near_tie_pixels(probs, sid, nseg).reshape(B, 1, H, W)
    (ref, gref), (got, ggot) = out
    assert l64 > 0
    for lv, g in out:  # card and CPU each within float32's own rounding
        assert abs(lv - l64) <= 8 * 2.0 ** -24 * (1 + l64)
        assert bool((torch.where(ties, 0.0, (g - g64).abs())
                     <= 8 * unit).all())
    if scale < 1.0:  # unsaturated: card against CPU as the CPU tests
        assert got == pytest.approx(ref, rel=1e-5)
        bad = (ggot - gref).abs() > 1e-5 * gref.abs().max()
        assert not bool((bad & ~ties).any())


class _Tiny(torch.nn.Module):
    """3x3 conv, BN, ReLU and a biased 1x1 head; return_feat hands out
    the ReLU output."""

    def __init__(self, c):
        super().__init__()
        from mulactseg_tpu_torch.models.layers import Conv2d, FastBatchNorm

        self.conv = Conv2d(3, 16, 3)
        self.bn = FastBatchNorm(16)
        self.final = Conv2d(16, c, 1, bias=True)

    def forward(self, x, return_feat=False):
        y = torch.relu(self.bn(self.conv(x)))
        return (y, self.final(y)) if return_feat else self.final(y)


@pytest.mark.parametrize("method,k5", [
    ("active_pwce_multi_predignore", 1),
    ("active_joint_multi_predignore_wgroup", 2)])
def test_needs_feat_step_on_card_matches_cpu(dev, method, k5, monkeypatch):
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.engine.train import make_train_step

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rng = np.random.RandomState(4)
    B, C, H, W, nseg = 2, 7, 40, 48, 16
    batch = _region_batch(rng, B, H, W, nseg, C)
    batch["images"] = rng.randn(B, 3, H, W).astype(np.float32)
    cfg = Config(num_classes=C - 1, nseg=nseg, method=method,
                 dtype="float32", finetune_itrs=10)
    torch.manual_seed(0)
    model = _Tiny(C)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.3)
    auxes = []
    for d in ("cpu", dev):
        m = _Tiny(C).to(d)
        m.load_state_dict(model.state_dict())
        _build.reset_launches()
        auxes.append({k: float(v) for k, v in make_train_step(
            m, cfg, device=d)(batch).items()})
        if d != "cpu":
            torch.cuda.synchronize()
            assert dict(_build.LAUNCHES) == {"seg_max_fwd": k5 * B}
    for k, v in auxes[0].items():
        assert v > 0 and auxes[1][k] == pytest.approx(v, rel=1e-5), k


# the criteria that read more than a region batch: (method, Config
# overrides, K5 launches an image)
MORE_CRITERIA = [
    ("active_onlineplbl_multi_predignore", {"dorampup": True}, 1),
    ("active_onlinewplbl_multi_predignore", {"weight_wo_proto": True}, 1),
    ("active_onlinesimwplbl_multi_predignore", {"th_wplbl": 0.3}, 1),
    ("active_onlinewplblonly_multi_predignore", {}, 1),
    ("active_onlineplbl_multi_predignore_domc", {}, 2),
    ("active_onlinesimwplbl_multi_predignore_domc", {}, 2),
    ("active_joint_hier_multi", {}, 1),
    ("active_joint_hier_multi_async", {}, 1),
    ("active_joint_hier_multi_async_weight", {}, 2),
    ("active_joint_multi_predignore_mseg", {"nseg_list": (8, 20)}, 2),
]


@pytest.mark.parametrize("method,over,k5", MORE_CRITERIA,
                         ids=[m[0] for m in MORE_CRITERIA])
def test_more_criteria_on_card_match_cpu(dev, method, over, k5):
    """Each criterion on the card (K5) against the CPU on N(0, 0.2^2)
    logits: loss and parts within rtol 1e-5, the logits gradient within
    1e-5 of its largest entry outside segments with a near-tie (of the
    group terms' ids), and K5's launches."""
    from chip_smoke import near_tie_pixels
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.engine.train import CRITERIA

    rng = np.random.RandomState(len(method))
    B, H, W, nseg, small, weak_hw = 2, 40, 48, 20, 80, (56, 64)
    hier = "hier" in method
    C = 7 if not hier else 6  # the hierarchy criteria slice the last off
    batch = _region_batch(rng, B, H, W, nseg, 7)
    batch["spx_small"] = np.stack([irregular_superpixels(H, W, small, rng)
                                   for _ in range(B)]).astype(np.int32)
    for k, n in (("spx_weak", nseg), ("spx_small_weak", small)):
        batch[k] = np.stack([irregular_superpixels(*weak_hw, n, rng)
                             for _ in range(B)]).astype(np.int32)
    batch["spmask_weak"] = np.take_along_axis(
        rng.rand(B, nseg) < 0.6, batch["spx_weak"].reshape(B, -1),
        1).reshape(B, *weak_hw)
    levels = over.get("nseg_list", ())
    if levels:
        batch["mseg_spx"] = np.stack([np.stack([
            irregular_superpixels(H, W, n, rng) for n in levels])
            for _ in range(B)]).astype(np.int32)
        batch["mseg_spmask"] = rng.rand(B, len(levels), H, W) < 0.6
        for i, n in enumerate(levels):
            batch[f"mseg_target_{i}"] = (rng.rand(B, n, C) < 0.3).astype(
                np.float32)
    logits = (rng.randn(B, C, H, W) * 0.2).astype(np.float32)
    extra = {"feat": rng.randn(B, 8, H, W).astype(np.float32),
             "plbl_logits": (rng.randn(B, C, H, W) * 0.2).astype(
                 np.float32)}
    weak = (rng.randn(B, C, *weak_hw) * 0.2).astype(np.float32)
    cfg = Config(num_classes=C - 1, nseg=nseg, method=method,
                 finetune_itrs=10, small_nseg=small, **over)
    out = []
    for d in ("cpu", dev):
        crit = CRITERIA[method](cfg)
        x = torch.from_numpy(logits).to(d).requires_grad_(True)
        tb = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        tb["logits_weak"] = torch.from_numpy(weak).to(d)
        _build.reset_launches()
        if getattr(crit, "needs_feat", False):
            ex = {k: torch.from_numpy(v).to(d) for k, v in extra.items()}
            total, aux = crit(x, tb, dict(ex, frac=0.25))
        else:
            total, aux = crit(x, tb)
        total.backward()
        out.append(({k: float(v.detach()) for k, v in aux.items()},
                    x.grad.cpu()))
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"seg_max_fwd": k5 * B}
    (ref, gref), (got, ggot) = out
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-5, abs=1e-7), k
    assert ref["train_loss"] > 0
    bad = ((ggot - gref).abs() > 1e-5 * gref.abs().max()).any(dim=1)
    if bool(bad.any()):
        probs = torch.softmax(torch.from_numpy(logits).reshape(B, C, -1)
                              / cfg.group_ce_temp, dim=1)
        sid = np.where(batch["spmask"], batch["spx"], nseg).reshape(B, -1)
        ties = near_tie_pixels(probs, sid, nseg).reshape(B, H, W)
        assert not bool((bad & ~ties).any())


@pytest.mark.parametrize("C", [19, 20])
def test_segment_max_at_the_probe_instance(dev, C):
    """K5 as the top-1 selection probe calls it (one image's softmax
    planes under its spmask ids, absent superpixels among them): bitwise
    its plain version, at the probe's 19 classes (the run-time-C
    instance) and at the compiled 20."""
    rng = np.random.RandomState(21)
    H, W, nseg = 96, 80, 64
    logits = torch.from_numpy(rng.randn(C, H, W).astype(np.float32) * 3)
    spx = irregular_superpixels(H, W, nseg, rng)
    keep = rng.rand(H, W) < 0.5
    keep[spx == 5] = False  # an absent superpixel
    sid = np.where(keep, spx, nseg).reshape(-1).astype(np.int32)
    probs = torch.softmax(logits.to(dev), dim=0).reshape(C, -1).t()
    assert segment_max.layout(probs) == segment_max.PLANES
    _build.reset_launches()
    vals, pix = segment_max.seg_max_fwd(probs, torch.from_numpy(sid).to(dev),
                                        nseg)
    pv, pp = segment_max.segment_max_plain(probs, torch.from_numpy(sid).to(
        dev), nseg)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"seg_max_fwd": 1}
    assert torch.equal(pix, pp) and (pix[5] == H * W).all()
    assert torch.equal(vals.view(torch.int32), pv.view(torch.int32))


def test_top1_selection_counts_on_card_match_cpu(dev):
    from mulactseg_tpu_torch.engine.analysis import top1_selection_counts

    rng = np.random.RandomState(22)
    B, C, H, W, nseg = 3, 7, 40, 48, 16
    logits = rng.randn(B, C, H, W).astype(np.float32)
    spx = np.stack([irregular_superpixels(H, W, nseg, rng)
                    for _ in range(B)]).astype(np.int32)
    spmask = rng.rand(B, H, W) < 0.7
    spmask[2] = False  # an all-masked image
    multihot = (rng.rand(B, nseg, C + 1) < 0.4).astype(np.float32)
    gt = rng.randint(0, C, (B, H, W)).astype(np.int32)
    gt[rng.rand(B, H, W) < 0.1] = 255
    out = {}
    for d in ("cpu", dev):
        _build.reset_launches()
        out[str(d)] = [t.cpu() for t in top1_selection_counts(
            *(torch.from_numpy(a).to(d)
              for a in (logits, multihot, spx, spmask, gt)),
            nseg=nseg, num_classes=C)]
        if d != "cpu":
            assert dict(_build.LAUNCHES) == {"seg_max_fwd": B}
    for c, g in zip(out["cpu"], out[str(dev)]):
        assert torch.equal(c, g)
    assert float(out["cpu"][3]) > 0


@pytest.mark.parametrize("return_feat", [False, True])
def test_sliding_eval_on_card_matches_cpu(dev, return_feat, monkeypatch):
    """SlidingEval with crop 64 on a 96x160 image (2 x 4 windows) and on
    one smaller than a crop, float32, TF32 off: the summed logits within
    1e-4 of the largest, the renormalised features within 1e-4."""
    from mulactseg_tpu_torch.engine.sliding import SlidingEval

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    torch.manual_seed(0)
    model = _Tiny(7)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.3)
    rng = np.random.RandomState(23)
    for H, W in ((96, 160), (40, 56)):
        images = rng.randint(0, 256, (2, 3, H, W)).astype(np.uint8)
        out = {}
        for d in ("cpu", dev):
            m = _Tiny(7).to(d)
            m.load_state_dict(model.state_dict())
            se = SlidingEval(m, 6, crop_size=64, stride_rate=2 / 3,
                             return_feat=return_feat, device=d)
            got = se(images)
            # (logits,) or (logits, features)
            out[str(d)] = [t.cpu() for t in (got[::-1] if return_feat
                                             else (got,))]
            assert se.windows == (8 if H == 96 else 1)
        for i, (c, g) in enumerate(zip(out["cpu"], out[str(dev)])):
            assert c.shape == g.shape and g.shape[-2:] == (H, W)
            scale = c.abs().max().item() if i == 0 else 1.0
            assert (c - g).abs().max().item() <= 1e-4 * scale


def test_data_parallel_two_ranks_on_one_card(dev):
    """Two ranks sharing the card (parallel.spawn, gloo with CUDA
    tensors, each on cuda:<this card>) against this process alone, as
    chip_smoke.py's dp phase holds them: FastBatchNorm's output, input
    and parameter gradients and running statistics within rtol 1e-5,
    atol 1e-6, the dropout mask the rows of one rank's; a fused
    lossdecomp step of the small twin (float32, TF32 off) within the JAX
    dryrun's bounds (loss 1e-3 relative, gradient cosine >= 0.99, norm
    within 1e-2), K1-K4 once on each rank."""
    from mulactseg_tpu_torch.config import Config
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.parallel import mesh
    import torch_port_parallel_ranks as ranks  # beside this file

    card = f"cuda:{torch.cuda.current_device()}"
    rng = np.random.RandomState(14)
    B, H, nseg, C = 4, 65, 24, ranks.NC
    x = (rng.randn(B, 6, 5, 5) * np.linspace(0.5, 2.0, B)[:, None, None, None]
         + np.linspace(-1.0, 1.0, B)[:, None, None, None]).astype(np.float32)
    bn_args = (x, rng.randn(*x.shape).astype(np.float32),
               rng.uniform(0.5, 1.5, 6).astype(np.float32),
               rng.uniform(-0.2, 0.2, 6).astype(np.float32), (B, 3, 5, 5),
               card)
    batch = _region_batch(rng, B, H, H, nseg, C)
    batch["target_bits"] = np.stack([pixel_target_bits(
        batch["target"][b], batch["spx"][b], batch["spmask"][b])
        for b in range(B)])
    batch["images"] = (rng.randn(B, 3, H, H)
                       * np.linspace(0.5, 2.0, B)[:, None, None, None]
                       ).astype(np.float32)
    model = ranks.port_twin(separable=True)
    convert.load_variables(model, convert.random_variables(model, 3))
    cfg = Config(method="active_joint_multi_predignore_lossdecomp",
                 optimizer="sgd", dtype="float32", num_classes=C - 1,
                 nseg=nseg, crop_size=(H, H), train_batch_size=B)
    jobs = [("bn", "bn_and_dropout", bn_args),
            ("step", "train_steps", (model, cfg, [batch], card))]
    two = mesh.spawn(ranks.run_all, 2, "gloo", card, jobs, timeout=120)
    one = ranks.run_all(jobs)
    for r, res in enumerate(two):
        rows = mesh.local_rows(B, r, 2)
        for k in ("y", "dx"):
            np.testing.assert_allclose(res["bn"][k], one["bn"][k][rows],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(res["bn"]["mask"],
                                      one["bn"]["mask"][rows])
        for k in ("dw", "db", "mean", "var"):
            np.testing.assert_allclose(res["bn"][k], one["bn"][k],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        assert res["step"]["launches"] == {
            k: 1 for k in ("pixel_ce_fwd", "pixel_ce_bwd", "ssm_fwd",
                           "ssm_bwd")}
        got = res["step"]["losses"][0]["train_loss"]
        want = one["step"]["losses"][0]["train_loss"]
        assert abs(got - want) <= 1e-3 * abs(want)
        g = np.concatenate([a.ravel() for a in res["step"]["grads"].values()])
        w = np.concatenate([a.ravel() for a in one["step"]["grads"].values()])
        g, w = g.astype(np.float64), w.astype(np.float64)
        assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.99
        assert abs(np.linalg.norm(g) - np.linalg.norm(w)) <= \
            1e-2 * np.linalg.norm(w)


def test_criteria_data_parallel_two_ranks_on_one_card(dev):
    """Three criteria beside the fused one, each running K5 (the joint
    criterion's group term, an online criterion's prototypes and group
    term, mseg's levels), step 0 at world 2 (two ranks sharing the card
    under gloo) against this process alone, on the batch of
    tests/test_torch_port_parallel_criteria.py and the small twin in
    float32 with TF32 off: the loss parts within 1e-3 relative, the
    gradient cosine >= 0.99 and its norm within 1e-2 (the JAX dryrun's
    bounds, as chip_smoke.py's dp phases hold them), both ranks on one
    summed gradient; K5 launched on each rank for its own images, the
    two ranks' launches summing to world 1's."""
    from mulactseg_tpu_torch.models import convert
    from mulactseg_tpu_torch.parallel import mesh
    import torch_port_parallel_ranks as ranks  # beside this file

    card = f"cuda:{torch.cuda.current_device()}"
    batch = ranks.full_batch(np.random.RandomState(21))
    # (method, overrides, K5 launches an image)
    cases = {"active_joint_multi_predignore": ({}, 1),
             "active_onlinesimwplbl_multi_predignore_domc": ({}, 2),
             "active_joint_multi_predignore_mseg": ({}, len(ranks.LEVELS))}
    steps = [(m, ranks.cfg_for(m, over), [ranks.for_method(batch, m)])
             for m, (over, _) in cases.items()]
    spec = ("twin", convert.random_variables(ranks.port_twin(True), 3))
    jobs = [("steps", "criteria_steps", (spec, steps, card))]
    two = mesh.spawn(ranks.run_all, 2, "gloo", card, jobs, timeout=180)
    one = ranks.run_all(jobs)["steps"]
    for m, (_, k5) in cases.items():
        want = one[m]
        assert want["launches"] == {"seg_max_fwd": k5 * ranks.B}, m
        for res in two:
            got = res["steps"][m]
            assert got["launches"] == {"seg_max_fwd": k5 * ranks.B // 2}, m
            assert got["grad_sq"] == two[0]["steps"][m]["grad_sq"]
            for k, w in want["losses"][0].items():
                assert abs(got["losses"][0][k] - w) <= 1e-3 * abs(w), (m, k)
        g = np.concatenate([a.ravel() for a in
                            two[0]["steps"][m]["grads"].values()])
        w = np.concatenate([a.ravel() for a in want["grads"].values()])
        g, w = g.astype(np.float64), w.astype(np.float64)
        assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.99, m
        assert abs(np.linalg.norm(g) - np.linalg.norm(w)) <= \
            1e-2 * np.linalg.norm(w), m


@pytest.mark.parametrize("name", ["full", "twin", "voc"])
def test_bf16_path_holds_the_jax_reference(dev, name):
    """The port's bf16 path on the card, through its entry points, against
    the JAX package's dtype=bfloat16 model as the fixture's reference file
    holds it (tests/data/bf16_reference.npz, bf16_reference_voc.npz;
    chip_smoke.py's bf16_parity phase, one fixture): the weights rebuilt
    from seeds match the file's digest, each float output lies within
    chip_smoke.BF16_TOL (twice the JAX package's own spread under one
    bf16 ulp on 1% of its input pixels; the stage outputs, the TTA views'
    too, by the share of values that differ bitwise), each exact output
    equals the file's outside the pixels or regions that flip under the
    JAX package's own perturbations; K1-K4 once a step, K5 once a
    pseudo-labelled image; for VOC (21 classes, 97x97) every kernel at C
    at run time without the 16-byte path, and stage 2's step 0 on the
    file's pseudo-labels."""
    import chip_smoke as cs

    ref = cs.bf16_reference_of(name)
    variables = cs.bf16_variables(name)
    assert cs.variables_digest(variables) == str(ref["digest"])
    inputs = cs.bf16_inputs(name)
    s2 = ref["plbl"] if cs.bf16_recipe(name)["stage2"] else None
    _build.reset_launches()
    with cs.kernel_instances() as seen:
        out = cs.bf16_port_outputs(name, variables, inputs, dev,
                                   s2_labels=s2)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {
        **{k: cs.BF16_STEPS for k in cs.STAGE1_KERNELS},
        "seg_max_fwd": cs.BF16_FIXTURES[name]["batch"]}
    assert set(out) == cs.bf16_output_keys(ref)
    if name == "voc":
        assert seen == {"pixel_ce": {(21, 0, False)}, "ssm": {(21, 0)},
                        "seg_max_fwd": {(21, 0, segment_max.ANY)}}
    _, bad = cs.bf16_compare(name, ref, {"card": out},
                             inputs[0][0]["labels"])
    assert not bad["card"], bad


def test_bf16_world2_holds_the_jax_reference(dev):
    """The port's bf16 step at world 2 (two ranks sharing the card under
    gloo, chip_smoke.py's bf16_world2 phase) against the JAX package's
    step on a 2-device mesh (the 'world2/' entries of tests/data/
    bf16_reference_voc.npz): the summed step-0 gradient's sample and
    norms per leaf within the VOC fixture's grad0 and grad0_norm
    tolerances, the loss and its parts within loss0's, K1-K4 once on
    each rank."""
    import chip_smoke as cs

    card = torch.device("cuda", torch.cuda.current_device())
    line, launches = cs.bf16_world2_slice(card, "card")
    assert launches == {k: 2 for k in cs.STAGE1_KERNELS}
    assert set(line["bf16_world2"]["fixtures"]) == {"voc"}
