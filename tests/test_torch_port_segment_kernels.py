"""The designs of the large-S group-term kernels K6 (csrc/prereduce.cu,
prereduce_nchw_kernel) and K5 (csrc/segment_max.cu), stated in numpy and
held on the CPU against the port's plain versions:

- K6: one thread per raster block of 4 pixels. The thread holds its
  block's 4 ids and 4 softmaxes, merges the pixels that share the
  leader's id (the others and pixels past the image count as -1) with
  fmax(fmax(v0, v1), fmax(v2, v3)), takes the first offset that reaches
  the max as the choice, rounds every value to bf16 (the kernel's bit
  trick), and retires the merged ids. On the float32 probabilities of
  prereduce_plain it equals prereduce_plain bitwise: planes, choices in
  tie order (the fixtures repeat pixel pairs, so blocks hold exact ties)
  and retired ids, at HW in {64*64, 33*31, 700} (a short last block per
  image where HW % 4 != 0).
- K5: spans of SPAN pixels, warps of 32 lanes taken in a random order,
  raster runs formed over the valid lanes only (an invalid lane is
  transparent), a run's first lane claiming slot id % NSLOT of the span's
  shared table (claims of one warp in a random order), the run's max key
  going to its slot if its id holds it, else straight to the global
  table, and each claimed slot flushed after the span. With small spans
  and few slots, so that slots collide and overflow, it equals
  segment_max_plain bitwise on a plbl-like fixture (superpixels with 30%
  selected, so long invalid runs), on K6's planes under the retired ids
  (interleaved retired pixels), and on signed values rounded to 1/8 with
  -0.0 mixed in (exact ties across warp and span borders).
- The wrappers' choices: K6's instance (C = 20 compiled, the 16-byte path
  only where HW % 4 == 0 and logits and ids are 16-byte aligned) and K5's
  load path (planes, rows or any), and K5's span and slot count reach the
  build as -D flags and key its cache.
"""

import numpy as np
import pytest
import torch

from mulactseg_tpu_torch.data.synthetic import irregular_superpixels
from mulactseg_tpu_torch.ops import _build, segment, segment_max

torch.set_num_threads(1)

TEMP = 0.1


def _bf16(a):
    """The kernels' round_bf16: round to nearest even, kept in float32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _k6_case(C, HW, B=2, seed=0):
    """Logits with exact ties between pixel pairs, runs of 3 pixels (so
    blocks of 4 mix segments), 10% invalid pixels."""
    rng = np.random.RandomState(seed + C + HW)
    x = rng.randn(B, C, HW).astype(np.float32)
    x[:, :, 1::2] = x[:, :, 0:HW - 1:2]
    nseg = 5
    local = np.repeat(rng.randint(0, nseg, (B, -(-HW // 3))), 3,
                      axis=1)[:, :HW]
    local[rng.rand(B, HW) < 0.1] = nseg
    S = B * nseg
    sid = np.where(local >= nseg, S, local + np.arange(B)[:, None] * nseg)
    return x, sid.astype(np.int32), S


def _k6_blocks(probs, sid, S):
    """K6's thread per raster block, vectorised over the blocks: probs
    (B, C, HW) float32, sid (B, HW) -> (planes (C, B*HW), choice
    (C, B*nb), sid2 (B*HW,))."""
    B, C, HW = probs.shape
    nb = -(-HW // 4)
    pad = nb * 4 - HW
    p = np.pad(probs, ((0, 0), (0, 0), (0, pad))).reshape(B, C, nb, 4)
    s = np.pad(sid, ((0, 0), (0, pad))).reshape(B, nb, 4)
    n = np.minimum(4, HW - 4 * np.arange(nb))  # pixels of each block
    inside = np.arange(4)[None, :] < n[:, None]
    match = inside[None] & (s == s[:, :, :1])
    v = [np.where(match[:, None, :, j], p[..., j], np.float32(-1))
         for j in range(4)]
    mx = np.fmax(np.fmax(v[0], v[1]), np.fmax(v[2], v[3]))
    ch = np.where(v[0] == mx, 0, np.where(v[1] == mx, 1,
                                          np.where(v[2] == mx, 2, 3)))
    out = p.copy()
    out[..., 0] = mx
    planes = _bf16(out.reshape(B, C, nb * 4)[:, :, :HW])
    retired = np.where((np.arange(4) > 0) & (s != s[:, :, :1]) | (
        np.arange(4) == 0), s, S)
    return (planes.transpose(1, 0, 2).reshape(C, B * HW),
            ch.transpose(1, 0, 2).reshape(C, B * nb),
            retired.reshape(B, nb * 4)[:, :HW].reshape(B * HW))


@pytest.mark.parametrize("C", [7, 20])
@pytest.mark.parametrize("HW", [64 * 64, 33 * 31, 700])
def test_k6_block_merge_equals_plain(C, HW):
    x, sid, S = _k6_case(C, HW)
    xt = torch.from_numpy(x)
    probs = segment._softmax(xt, TEMP).numpy()
    got = _k6_blocks(probs, sid, S)
    want = segment.prereduce_plain(xt, torch.from_numpy(sid), S, TEMP)
    for g, w in zip(got, want):
        w = w.numpy()
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.int32) if g.dtype ==
                                      np.float32 else g,
                                      w.view(np.int32) if w.dtype ==
                                      np.float32 else w)
    # the fixture reaches the tie order: blocks whose max is tied between
    # offsets choose the first (pairs (0, 1) and (2, 3) are equal)
    planes, choice, _ = got
    assert (choice == 0).any() and (choice == 2).any()
    assert (choice == 1).any() or (choice == 3).any()


def _order_keys(v):
    """K5's order_key: -0.0 -> +0.0, sign bit flipped for positives, all
    bits for negatives (uint32)."""
    u = np.asarray(v, np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    return np.where(u >> 31, u ^ np.uint32(0xFFFFFFFF),
                    u ^ np.uint32(0x80000000)).astype(np.uint32)


def _k5_span_merge(values, sid, S, span, nslot, rng):
    """K5's span and slot merge in numpy: values (P, C) float32, sid (P,)
    -> ((S, C) float32 max, (S, C) int64 first argmax pixel)."""
    P, C = values.shape
    keys32 = _order_keys(values).astype(np.uint64)
    table = np.zeros((S, C), np.uint64)
    for start in range(0, P, span):
        end = min(start + span, P)
        tags, slots = {}, np.zeros((nslot, C), np.uint64)
        for w0 in rng.permutation(np.arange(start, end, 32)):
            lanes = np.arange(w0, min(w0 + 32, end))
            ids = sid[lanes]
            live = lanes[(ids >= 0) & (ids < S)]  # invalid lanes transparent
            if live.size == 0:
                continue
            heads = np.flatnonzero(np.diff(sid[live], prepend=-1) != 0)
            runs = np.split(live, heads[1:])
            # the run heads of one warp claim their slots in any order
            held = {}
            for r in rng.permutation(len(runs)):
                s = int(sid[runs[r][0]])
                held[r] = tags.setdefault(s % nslot, s) == s
            for r, m in enumerate(runs):
                s = int(sid[m[0]])
                k = ((keys32[m] << np.uint64(32))
                     | (~m.astype(np.uint32)).astype(np.uint64)[:, None]
                     ).max(axis=0)
                if held[r]:
                    slots[s % nslot] = np.maximum(slots[s % nslot], k)
                else:
                    table[s] = np.maximum(table[s], k)
        for slot, s in tags.items():
            table[s] = np.maximum(table[s], slots[slot])
    hi = (table >> np.uint64(32)).astype(np.uint32)
    vals = np.where(hi >> 31, hi ^ np.uint32(0x80000000), ~hi).view(
        np.float32)
    vals = np.where(table == 0, np.float32(0), vals)
    pix = np.where(table == 0, P,
                   (~(table & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
    return vals.astype(np.float32), pix.astype(np.int64)


def _k5_plbl():
    """plbl-like: softmax planes of 48x80 logits under irregular
    superpixels, 30% selected (long invalid runs), S = 24."""
    rng = np.random.RandomState(3)
    h, w, nseg, C = 48, 80, 24, 20
    spx = irregular_superpixels(h, w, nseg, rng)
    sel = rng.rand(nseg) < 0.3
    sel[:2] = True
    sid = np.where(sel[spx], spx, nseg).reshape(-1).astype(np.int32)
    lg = rng.randn(C, h * w).astype(np.float32) * 3
    probs = np.exp(lg - lg.max(0))
    probs = (probs / probs.sum(0)).astype(np.float32)
    return np.ascontiguousarray(probs.T), sid, nseg


def _k5_retired():
    """K6's planes and retired ids on the 33x31 fixture."""
    x, sid, S = _k6_case(20, 33 * 31)
    planes, _, sid2 = segment.prereduce_plain(
        torch.from_numpy(x), torch.from_numpy(sid), S, TEMP)
    return planes.t().contiguous().numpy(), sid2.numpy(), S


def _k5_signed():
    """Signed values rounded to 1/8 (exact ties everywhere) with -0.0,
    class 0 negative and class 1 at most 0, runs of 7 pixels over 11 ids,
    segment 3 absent, ids -1 and above S invalid too."""
    rng = np.random.RandomState(5)
    P, C, S = 1000, 7, 11
    v = (np.round(rng.randn(P, C) * 8) / 8).astype(np.float32)
    v[:, 0] = -np.abs(v[:, 0]) - 0.125  # negative maxima
    v[:, 1] = -np.abs(v[:, 1])  # maxima of -0.0 and +0.0
    v[:, 1:][rng.rand(P, C - 1) < 0.1] = -0.0
    sid = np.repeat(rng.randint(-1, S + 3, -(-P // 7)), 7)[:P]
    sid[sid == 3] = S  # segment 3 is absent
    return v, sid.astype(np.int32), S


K5_CASES = {"plbl": _k5_plbl, "retired": _k5_retired, "signed": _k5_signed}


@pytest.mark.parametrize("span,nslot", [(32, 4), (96, 2), (2048, 8)])
@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_k5_span_merge_equals_plain(case, span, nslot):
    values, sid, S = K5_CASES[case]()
    got_v, got_p = _k5_span_merge(values, sid, S, span, nslot,
                                  np.random.RandomState(span + nslot))
    want_v, want_p = segment_max.segment_max_plain(
        torch.from_numpy(values), torch.from_numpy(sid), S)
    np.testing.assert_array_equal(got_p, want_p.numpy())
    np.testing.assert_array_equal(got_v.view(np.int32),
                                  want_v.numpy().view(np.int32))
    assert (got_p < values.shape[0]).any()
    assert (got_p == values.shape[0]).any() or case == "retired"


def test_k5_fixtures_reach_the_traps():
    """The plbl fixture has long invalid runs; K6's retired ids interleave
    invalid pixels inside runs of one id; the signed one has -0.0 and
    negative maxima."""
    _, sid, S = _k5_plbl()
    inv = (sid >= S).astype(np.int8)
    edges = np.flatnonzero(np.diff(inv) != 0)
    assert inv.mean() > 0.5 and np.diff(edges).max() >= 32
    _, sid2, S = _k5_retired()
    lead = sid2[0::4]
    assert ((sid2[1::4] == S) & (lead < S)).mean() > 0.2
    v, sid, S = _k5_signed()
    mx, _ = segment_max.segment_max_plain(torch.from_numpy(v),
                                          torch.from_numpy(sid), S)
    assert (v.view(np.uint32) == 0x80000000).any() and (mx < 0).any()


@pytest.mark.parametrize("HW,offset,want", [
    (4096, 0, (20, True)), (33 * 31, 0, (20, False)), (4096, 1, (20, False)),
    (4096, 4, (20, True)), (700, 2, (20, False))])
def test_k6_instance(HW, offset, want):
    B, C = 2, 20
    store = torch.zeros(B * C * HW + offset)
    xc = store[offset:].view(B, C, HW)
    sid3 = torch.zeros(B, 1, HW, dtype=torch.int32)
    assert segment.prereduce_instance(xc, sid3) == want
    assert segment.prereduce_instance(torch.zeros(B, 7, HW), sid3)[0] == 0


def test_k5_layout():
    P, C = 4096, 20
    planes = torch.zeros(C, P)
    assert segment_max.layout(planes.t()) == segment_max.PLANES
    assert segment_max.layout(torch.zeros(C, P + 2).t()) == segment_max.ANY
    assert segment_max.layout(torch.zeros(C, P + 1)[:, 1:].t()) \
        == segment_max.ANY
    assert segment_max.layout(torch.zeros(P, C)) == segment_max.ROWS
    assert segment_max.layout(torch.zeros(P, 7)) == segment_max.ANY
    assert segment_max.layout(torch.zeros(P * C + 1)[1:].view(P, C)) \
        == segment_max.ANY


def test_k5_span_and_slot_counts_reach_the_build(monkeypatch):
    """segment_max.cu is built with K5_SPAN and K5_SLOTS as -D flags, and
    its cached library is keyed on them."""
    span, nslot = segment_max.K5_SPAN, segment_max.K5_SLOTS
    assert _build.flags("segment_max")[-2:] == (f"-DSPAN={span}",
                                                f"-DNSLOT={nslot}")
    assert span % 32 == 0 and nslot & (nslot - 1) == 0 and nslot >= 4
    built = _build._target("segment_max")
    monkeypatch.setitem(_build.DEFINES, "segment_max",
                        {"SPAN": 2 * span, "NSLOT": nslot})
    assert _build._target("segment_max") != built
    monkeypatch.setitem(_build.DEFINES, "segment_max",
                        {"SPAN": span, "NSLOT": 2 * nslot})
    assert _build._target("segment_max") != built
