"""The port's CUDA kernels (K1-K4) against their plain PyTorch versions on
the card, at small and ragged shapes the recipe run does not reach (HW not
a multiple of the block, C from 3 to 31, underflow, absent segments).

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
operand (|dlm| + |w| p) / T.
"""

import numpy as np
import pytest
import torch

from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
from mulactseg_tpu_torch.losses.fused import (
    lossdecomp_fused,
    pixel_target_bits,
)
from mulactseg_tpu_torch.ops import _build, pixel_loss, segment

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


@pytest.mark.parametrize("B,C,HW", [(2, 20, 33 * 31), (1, 3, 700),
                                    (3, 31, 4096)])
def test_pixel_ce_kernels_match_plain(dev, B, C, HW):
    rng = np.random.RandomState(C)
    x = torch.from_numpy((rng.randn(B, C, HW) * 3).astype(np.float32)).to(dev)
    bits = torch.from_numpy(_bits(rng, B, C, HW)).to(dev)
    _build.reset_launches()
    got = pixel_loss.pixel_ce_fwd(x, bits, 0.1)
    want = pixel_loss.pixel_ce_fwd_plain(x, bits, 0.1)
    assert torch.equal(got[1::2], want[1::2])
    torch.testing.assert_close(got[0::2], want[0::2], rtol=1e-5, atol=0)
    g = torch.tensor([2.0, 3.0], device=dev)
    dl = pixel_loss.pixel_ce_bwd(x, bits, g, 0.1)
    want_dl = pixel_loss.pixel_ce_bwd_plain(x, bits, g, 0.1)
    assert (dl - want_dl).abs().max() <= 1e-6 * want_dl.abs().max()
    assert dict(_build.LAUNCHES) == {"pixel_ce_fwd": 1, "pixel_ce_bwd": 1}


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


@pytest.mark.parametrize("underflow", [False, True])
@pytest.mark.parametrize("B,C,HW", [(2, 20, 33 * 31), (3, 7, 4096)])
def test_segment_kernels_match_plain(dev, B, C, HW, underflow):
    rng = np.random.RandomState(HW + C)
    x, sid3, S = _segments(rng, B, C, HW, 9, underflow)
    x, sid3 = torch.from_numpy(x).to(dev), torch.from_numpy(sid3).to(dev)
    P = B * HW
    vals, pix = segment.ssm_fwd(x, sid3, S, 0.1)
    pvals, ppix = segment.ssm_fwd_plain(x, sid3, S, 0.1)
    absent = pix == P
    assert torch.equal(absent, ppix == P) and absent.any()
    assert (vals[absent] == 0).all()
    assert (vals - pvals).abs().max() <= 1e-6
    probs = segment._softmax(x, 0.1)
    q = pix[~absent].long()
    cls = torch.arange(C, device=dev).expand(S, C)[~absent]
    assert (probs[q // HW, cls, q % HW] - pvals[~absent]).abs().max() <= 1e-6
    # every segment with a valid pixel records one for every class, the
    # underflowed class (probability exactly 0.0) included
    seg_present = torch.zeros(S, dtype=torch.bool, device=dev)
    seg_present[sid3[sid3 < S].long()] = True
    assert torch.equal(~absent, seg_present[:, None].expand(S, C))
    if underflow:
        assert (vals[:, 0] == 0).all()

    g = torch.from_numpy(rng.randn(S, C).astype(np.float32)).to(dev)
    g[0] = 0.0
    dl = segment.ssm_bwd(x, vals, pix, g, 0.1)
    want = segment.ssm_bwd_plain(x, vals, pix, g, 0.1)
    live = (pix < P) & (g != 0)
    dlm = torch.zeros(B, C, HW, device=dev)
    dlm[q // HW, cls, q % HW] = (g * vals)[~absent]
    w = dlm.sum(dim=1, keepdim=True)
    operand = ((dlm.abs() + w.abs() * probs) / 0.1).max()
    assert live.any() and operand > 0
    assert (dl - want).abs().max() <= 8 * 2.0 ** -23 * operand


def test_lossdecomp_on_card_matches_cpu(dev):
    rng = np.random.RandomState(3)
    B, C, H, W, nseg = 2, 20, 37, 29, 12
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
