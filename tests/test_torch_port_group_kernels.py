"""The designs of the group-term kernels K3 and K4 (csrc/segment.cu),
stated in numpy and held on the CPU against the port's plain versions:

- K4's precondition: on the outputs of both forward branches (K3's plain
  version ssm_fwd_plain, and the pre-reduced term _ssm_prereduced), every
  live entry's pixel lies in its own segment.
- K4's gather by segment id, against the dense ssm_bwd_plain on those
  outputs.
- K3's span merge, with small spans and few slots so that slots collide
  and overflow, and warps merged in a random order, against
  ssm_fwd_plain: its keys make "max, first argmax" exact in any order.
- The span and slot counts the card tests build their ids around are the
  ones the source is built with.

Inputs are the fixtures of tests/test_torch_port_ops.py (B 2, C 20, 64x64,
runs of 16) and tests/test_torch_port_prereduce.py (B 2, C 6, HW 2048 and
the ragged 33x31, runs of 6, 5% invalid pixels), with and without an
underflowed class.

Tolerances: the gather and the dense form compute the softmax in another
order (numpy against torch, e * (1/z) against e / z), so dl agrees within
1e-6 of max |dl|, the tolerance chip_smoke.py holds the kernel to; the
span merge equals the plain version exactly (both take the same float32
probabilities).
"""

import numpy as np
import pytest
import torch

from mulactseg_tpu_torch.ops import _build, pixel_loss, segment, segment_max
from tests import test_torch_port_ops as ops_fixtures
from tests import test_torch_port_prereduce as pre_fixtures

torch.set_num_threads(1)

CASES = {
    "runs16": lambda: ops_fixtures._segment_case(1, 0.5),
    "runs16-underflow": lambda: ops_fixtures._segment_case(1, 0.1, True),
    "runs6": lambda: (*pre_fixtures._case(2, 0.5), pre_fixtures.S),
    "runs6-33x31": lambda: (*pre_fixtures._case(5, 0.5, hw=33 * 31),
                            pre_fixtures.S),
    "runs6-underflow": lambda: (*pre_fixtures._case(2, 0.1, True),
                                pre_fixtures.S),
}
TEMPS = {"runs16": 0.5, "runs16-underflow": 0.1, "runs6": 0.5,
         "runs6-33x31": 0.5, "runs6-underflow": 0.1}
BRANCHES = {"k3": segment.ssm_fwd_plain,
            "prereduced": segment._ssm_prereduced}


def _forward(case, branch):
    x, sid3, S = CASES[case]()
    temp = TEMPS[case]
    vals, pix = BRANCHES[branch](torch.from_numpy(x), torch.from_numpy(sid3),
                                 S, temp)
    return x, sid3, S, temp, vals.numpy(), pix.numpy()


def _gather_bwd(x, sid3, vals, pix, g, temp):
    """K4's gather by segment id in numpy float32: each pixel reads the row
    of its own segment, keeps g * max for the classes whose argmax is this
    pixel and g != 0, and only then needs its softmax. Returns (dl, the
    number of (pixel, class) coefficients found)."""
    b_, c_, hw = x.shape
    S = vals.shape[0]
    s = sid3.reshape(b_, hw)
    valid = (s >= 0) & (s < S)
    row = np.where(valid, s, 0)
    p = np.arange(b_ * hw).reshape(b_, hw)

    def by_pixel(t):  # (S, C) table -> each pixel's row, (B, C, HW)
        return t[row].transpose(0, 2, 1)

    gp = by_pixel(g)
    hit = valid[:, None] & (by_pixel(pix) == p[:, None]) & (gp != 0)
    d = np.where(hit, gp * by_pixel(vals), np.float32(0)).astype(np.float32)
    w = d.sum(axis=1, keepdims=True, dtype=np.float32)
    u = x * np.float32(1.0 / temp)
    e = np.exp(u - u.max(axis=1, keepdims=True))
    prob = e * (np.float32(1.0) / e.sum(axis=1, keepdims=True))
    dl = np.where((d != 0).any(axis=1, keepdims=True),
                  (d - w * prob) * np.float32(1.0 / temp), np.float32(0))
    return dl.astype(np.float32), int(hit.sum())


@pytest.mark.parametrize("branch", sorted(BRANCHES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_k4_precondition_holds_on_both_forward_branches(case, branch):
    """sid[pix[s, c]] == s wherever pix[s, c] < P."""
    _, sid3, S, _, vals, pix = _forward(case, branch)
    P = sid3.size
    live = pix < P
    assert live.any() and (~live).any()
    seg = np.broadcast_to(np.arange(S)[:, None], pix.shape)
    np.testing.assert_array_equal(sid3.reshape(P)[pix[live]], seg[live])


@pytest.mark.parametrize("branch", sorted(BRANCHES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_k4_gather_matches_dense_backward(case, branch):
    """The gather finds every live coefficient once and gives the dense
    form's dl."""
    x, sid3, S, temp, vals, pix = _forward(case, branch)
    P = sid3.size
    rng = np.random.RandomState(7)
    g = rng.randn(*vals.shape).astype(np.float32)
    g[rng.rand(*g.shape) < 0.2] = 0.0
    got, found = _gather_bwd(x, sid3, vals, pix, g, temp)
    want = segment.ssm_bwd_plain(torch.from_numpy(x), torch.from_numpy(vals),
                                 torch.from_numpy(pix), torch.from_numpy(g),
                                 temp).numpy()
    assert found == int(((pix < P) & (g != 0)).sum()) > 0
    # with an underflowed and a saturated class (p 0.0 and 1.0) every dl
    # entry is exactly 0 in both forms
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def _span_merge(probs, sid3, S, span, nslot, rng):
    """K3's merge in numpy. Per block of `span` pixels of one image, in
    warps of 32 lanes (taken in a random order, as the card may run
    them): each raster run of one id in a warp has its per-class key max
    go to slot id % nslot of the block's table if the id holds that slot
    (the first id to reach it claims it), else straight to the global
    table; after the block, each claimed slot goes to the global table."""
    b_, c_, hw = probs.shape
    bits = probs.view(np.uint32).astype(np.uint64)
    keys = np.zeros((S, c_), np.uint64)
    for b in range(b_):
        for start in range(0, hw, span):
            end = min(start + span, hw)
            tags, table = {}, np.zeros((nslot, c_), np.uint64)
            for w0 in rng.permutation(np.arange(start, end, 32)):
                lanes = np.arange(w0, min(w0 + 32, end))
                ids = sid3[b, 0, lanes]
                heads = np.flatnonzero(np.diff(ids, prepend=-1) != 0)
                for m in np.split(lanes, heads[1:]):
                    s = sid3[b, 0, m[0]]
                    if not 0 <= s < S:
                        continue
                    k = ((bits[b][:, m] << np.uint64(32))
                         | (~(b * hw + m).astype(np.uint32)).astype(
                             np.uint64)).max(axis=1)
                    slot = int(s) % nslot
                    if tags.setdefault(slot, s) == s:
                        table[slot] = np.maximum(table[slot], k)
                    else:
                        keys[s] = np.maximum(keys[s], k)
            for slot, s in tags.items():
                keys[s] = np.maximum(keys[s], table[slot])
    vals = (keys >> np.uint64(32)).astype(np.uint32).view(np.float32)
    pix = np.where(keys == 0, b_ * hw,
                   ~(keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return vals, pix.astype(np.int64)


@pytest.mark.parametrize("span,nslot", [(64, 4), (96, 2), (2048, 8)])
@pytest.mark.parametrize("case", ["runs16-underflow", "runs6",
                                  "runs6-33x31"])
def test_k3_span_merge_is_exact(case, span, nslot):
    """Colliding and overflowing slots, ties across warp and span borders
    (the fixtures repeat pixel pairs), an underflowed class and a ragged
    last span: the merge gives ssm_fwd_plain's values and pixels."""
    x, sid3, S = CASES[case]()
    temp = TEMPS[case]
    xt = torch.from_numpy(x)
    probs = segment._softmax(xt, temp).numpy()
    want_v, want_p = segment.ssm_fwd_plain(xt, torch.from_numpy(sid3), S,
                                           temp)
    got_v, got_p = _span_merge(probs, sid3, S, span, nslot,
                               np.random.RandomState(span + nslot))
    np.testing.assert_array_equal(got_p, want_p.numpy())
    np.testing.assert_array_equal(got_v.view(np.uint32),
                                  want_v.numpy().view(np.uint32))


def test_span_and_slot_counts_reach_the_build(monkeypatch):
    """segment.cu is built with K3_SPAN and K3_SLOTS as -D flags, and its
    cached library is keyed on them."""
    span, nslot = segment.K3_SPAN, segment.K3_SLOTS
    assert _build.flags("segment")[-2:] == (f"-DSPAN={span}",
                                            f"-DNSLOT={nslot}")
    # warps never straddle spans; slot = s & (NSLOT - 1)
    assert span % 32 == 0 and nslot & (nslot - 1) == 0
    built = _build._target("segment")
    monkeypatch.setitem(_build.DEFINES, "segment",
                        {"SPAN": 2 * span, "NSLOT": nslot})
    assert _build._target("segment") != built


def test_other_sources_build_without_defines(monkeypatch):
    """The -D constants of segment.cu are its own: prereduce.cu keeps the
    plain flags, pixel_loss.cu and segment_max.cu have only their own
    constants, and no cached library moves with K3's constants."""
    others = ("pixel_loss", "segment_max", "prereduce")
    built = {name: _build._target(name) for name in others}
    assert _build.flags("prereduce") == _build.NVCC_FLAGS
    assert _build.flags("pixel_loss") == _build.NVCC_FLAGS + (
        f"-DPIXELS={pixel_loss.PIXELS_PER_BLOCK}",)
    assert _build.flags("segment_max") == _build.NVCC_FLAGS + (
        f"-DSPAN={segment_max.K5_SPAN}", f"-DNSLOT={segment_max.K5_SLOTS}")
    monkeypatch.setitem(_build.DEFINES, "segment",
                        {"SPAN": 2 * segment.K3_SPAN,
                         "NSLOT": segment.K3_SLOTS})
    assert {name: _build._target(name) for name in others} == built
