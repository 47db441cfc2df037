"""The designs of the pixel-loss kernels K1 and K2 (csrc/pixel_loss.cu),
stated in numpy and held on the CPU against the port's plain versions
(pixel_ce_fwd_plain, pixel_ce_bwd_plain):

- K1: each thread owns 4 pixels of its block (4 consecutive ones on the
  16-byte path, THREADS apart on the 4-byte path), a group without a
  candidate adds nothing, and the sums are added in the kernel's order:
  a thread's pixels in order, a shuffle-down tree in each warp, the warps
  in order, into one partial per block; the last block to take a ticket
  adds the partials (thread t takes partials t, t + THREADS, ... in
  double, then the same trees), so the loss does not depend on the order
  in which blocks finish.
- K2: the kernel's arithmetic, exp2((u - max) log2 e) and dl_c =
  (coef / sum) e_c (pos - t_c), zero for pixels without a candidate.
  Both statements take u = x / T as the plain version rounds it on the
  CPU: the kernels multiply by 1/T, as PyTorch's CUDA division by a
  scalar does, and at |u| ~ 70 one ulp of u moves p_c by ~1e-5.
- The pixels-per-block constant reaches the build and sizes K1's
  partials; the wrapper picks the C = 20 instance and the 16-byte path
  where it may.

Cases: C in {3, 20, 31}, HW in {64*64, 33*31, 700} (ragged last blocks,
HW % 4 != 0), bitmasks in runs of 6 pixels (so whole groups are dead),
every pixel dead and every pixel live, at the build's pixels per block
and at 128 (then the finish has more partials than threads).

Tolerances: K1's counts exact and its sums to rtol 1e-5 (float32 sums in
another order, exp2 against exp); K2 within 1e-6 of max |dl|, as
chip_smoke.py holds the kernel.
"""

import numpy as np
import pytest
import torch

from mulactseg_tpu_torch.ops import _build, pixel_loss

torch.set_num_threads(1)

TEMP = 0.1
LOG2E = np.float32(1.4426950408889634)
SHAPES = [(C, HW) for C in (3, 20, 31) for HW in (64 * 64, 33 * 31, 700)]


def _case(C, HW, kind="runs", B=2, seed=0):
    """Logits 3 N(0, 1) and bitmasks: dead, one-hot or multi-hot in runs
    of 6 pixels ("runs"), or every pixel dead or live."""
    rng = np.random.RandomState(seed + C + HW)
    x = (rng.randn(B, C, HW) * 3).astype(np.float32)
    runs = -(-HW // 6)
    which = np.repeat(rng.randint(0, 3, (B, runs)), 6, axis=1)[:, :HW]
    if kind != "runs":
        which[:] = 0 if kind == "dead" else 1 + rng.randint(0, 2, (B, HW))
    c1 = rng.randint(0, C, (B, HW))
    one = 1 << c1
    many = one | (1 << ((c1 + 1) % C)) | rng.randint(0, 2 ** C, (B, HW))
    bits = np.where(which == 0, 0, np.where(which == 1, one, many))
    return x, bits.astype(np.int32).reshape(B, 1, HW)


def _softmax_pos(x, bits):
    """The kernels' softmax over (B, C, HW): e (B, C, HW), 1 / sum and pos
    (B, HW), n (B, HW); sums over the classes in class order."""
    B, C, HW = x.shape
    u = x / np.float32(TEMP)
    e = np.exp2((u - u.max(axis=1, keepdims=True)) * LOG2E)
    t = (bits[:, None] >> np.arange(C)[None, :, None]) & 1
    z = np.zeros((B, HW), np.float32)
    s = np.zeros((B, HW), np.float32)
    for c in range(C):
        z += e[:, c]
        s += np.where(t[:, c] == 1, e[:, c], np.float32(0))
    rz = np.float32(1) / z
    return e, rz, s * rz, t.sum(axis=1)


def _by_thread(a, pixels, vec):
    """(B, HW) per-pixel values -> (B, blocks, threads, 4): thread t's
    pixel k is 4t + k of its block (vec) or k * threads + t, with pixels
    past HW zero."""
    B, HW = a.shape
    nb, threads = -(-HW // pixels), pixels // 4
    a = np.pad(a, ((0, 0), (0, nb * pixels - HW))).reshape(B, nb, pixels)
    if vec:
        return a.reshape(B, nb, threads, 4)
    return a.reshape(B, nb, 4, threads).transpose(0, 1, 3, 2)


def _tree(v, dtype):
    """A shuffle-down tree over the last axis (32 lanes): lane l adds lane
    l + d (its own value where l + d >= 32) for d = 16 .. 1; lane 0's."""
    v = v.astype(dtype)
    for d in (16, 8, 4, 2, 1):
        v = v + np.concatenate([v[..., d:], v[..., 32 - d:]], axis=-1)
    return v[..., 0]


def _block_sums(acc):
    """(..., threads, 4) float32 per-thread sums -> (..., 4): warps by the
    tree, then the warps in order."""
    w = acc.reshape(*acc.shape[:-2], -1, 32, 4)
    w = _tree(np.moveaxis(w, -1, -2), np.float32)  # (..., warps, 4)
    out = w[..., 0, :]
    for i in range(1, w.shape[-2]):
        out = out + w[..., i, :]
    return out


def _finish(partials, threads):
    """The last block's sum of (nblocks, 4) partials: thread t adds
    partials t, t + threads, ... in double, then the trees."""
    n = partials.shape[0]
    acc = np.zeros((threads, 4))
    for i in range(n):
        acc[i % threads] += partials[i].astype(np.float64)
    w = _tree(np.moveaxis(acc.reshape(-1, 32, 4), -1, -2), np.float64)
    out = w[0]
    for i in range(1, w.shape[0]):  # the warps in order
        out = out + w[i]
    return out


def _k1(x, bits, pixels, vec, order_seed=0):
    """K1 in numpy: per-thread groups, block partials written in a random
    completion order, and the last block's fixed-order finish."""
    bits = bits[:, 0]
    _, _, pos, n = _softmax_pos(x, bits)
    nll = -np.log(pos + np.float32(1e-8))
    zero = np.float32(0)
    per_pixel = np.stack([np.where(n == 1, nll, zero),
                          (n == 1).astype(np.float32),
                          np.where(n > 1, nll, zero),
                          (n > 1).astype(np.float32)], axis=-1)
    groups = np.stack([_by_thread(per_pixel[..., i], pixels, vec)
                       for i in range(4)], axis=-1)  # (B, nb, thr, 4, 4)
    live = _by_thread(n, pixels, vec).any(axis=-1)
    acc = np.zeros(groups.shape[:3] + (4,), np.float32)
    for k in range(4):  # a thread adds its pixels in order
        acc = acc + groups[:, :, :, k]
    acc[~live] = 0  # a dead group adds nothing
    sums = _block_sums(acc).reshape(-1, 4)  # index b * nb + block
    partials = np.empty_like(sums)
    for i in np.random.RandomState(order_seed).permutation(len(sums)):
        partials[i] = sums[i]  # each block writes its own slot
    return _finish(partials, pixels // 4).astype(np.float32)


def _k2(x, bits, g):
    """K2 in numpy: dl_c = (coef / sum) e_c (pos - t_c), 0 where n == 0."""
    bits = bits[:, 0]
    e, rz, pos, n = _softmax_pos(x, bits)
    gb = np.where(n == 1, g[0], g[1]).astype(np.float32)
    a = gb / (np.float32(TEMP) * (pos + np.float32(1e-8))) * rz
    t = (bits[:, None] >> np.arange(x.shape[1])[None, :, None]) & 1
    q = np.where(t == 1, (pos - np.float32(1))[:, None], pos[:, None])
    dl = e * (a[:, None] * q)
    return np.where((n > 0)[:, None], dl, np.float32(0)).astype(np.float32)


def _plain_fwd(x, bits):
    return pixel_loss.pixel_ce_fwd_plain(torch.from_numpy(x),
                                         torch.from_numpy(bits), TEMP).numpy()


def _held(got, want):
    np.testing.assert_array_equal(got[1::2], want[1::2])  # counts exact
    np.testing.assert_allclose(got[0::2], want[0::2], rtol=1e-5, atol=0)


PATHS = [(C, HW, vec) for C, HW in SHAPES for vec in (True, False)
         if HW % 4 == 0 or not vec]


@pytest.mark.parametrize("pixels", [pixel_loss.PIXELS_PER_BLOCK, 128])
@pytest.mark.parametrize("C,HW,vec", PATHS)
def test_k1_design_matches_plain(C, HW, vec, pixels):
    x, bits = _case(C, HW)
    got = _k1(x, bits, pixels, vec)
    want = _plain_fwd(x, bits)
    assert want[1] > 0 and want[3] > 0
    _held(got, want)


@pytest.mark.parametrize("kind", ["dead", "live"])
def test_k1_design_all_dead_or_all_live(kind):
    x, bits = _case(20, 64 * 64, kind)
    got = _k1(x, bits, pixel_loss.PIXELS_PER_BLOCK, True)
    want = _plain_fwd(x, bits)
    assert got[1] + got[3] == (0 if kind == "dead" else bits.size)
    _held(got, want)


def test_k1_finish_does_not_depend_on_the_last_block():
    """Blocks finish in any order; the sum is bitwise the same."""
    x, bits = _case(20, 64 * 64)
    runs = [_k1(x, bits, 128, True, order_seed=s) for s in range(3)]
    for r in runs[1:]:
        np.testing.assert_array_equal(r.view(np.uint32),
                                      runs[0].view(np.uint32))


@pytest.mark.parametrize("kind", ["runs", "dead", "live"])
@pytest.mark.parametrize("C,HW", SHAPES)
def test_k2_design_matches_plain(C, HW, kind):
    x, bits = _case(C, HW, kind, seed=1)
    g = np.array([2.0, 3.0], np.float32)
    got = _k2(x, bits, g)
    want = pixel_loss.pixel_ce_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(bits), torch.from_numpy(g),
        TEMP).numpy()
    assert (got[np.broadcast_to(bits == 0, got.shape)] == 0).all()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    assert (np.abs(want).max() > 0) == (kind != "dead")


def test_pixels_per_block_reaches_the_build(monkeypatch):
    """pixel_loss.cu is built with PIXELS_PER_BLOCK as -DPIXELS (its
    cached library is keyed on it), and K1's partials hold one float4 per
    block of that many pixels."""
    pixels = pixel_loss.PIXELS_PER_BLOCK
    assert _build.flags("pixel_loss")[-1] == f"-DPIXELS={pixels}"
    assert pixels % 128 == 0  # whole warps of 4-pixel threads
    assert pixel_loss.num_blocks(4, 768 * 768) == 4 * -(-768 * 768 // pixels)
    assert pixel_loss.num_blocks(2, 33 * 31) == 2 * -(-33 * 31 // pixels)
    built = _build._target("pixel_loss")
    monkeypatch.setitem(_build.DEFINES, "pixel_loss", {"PIXELS": 2 * pixels})
    assert _build._target("pixel_loss") != built


class _FakeLib:
    """Records each entry point's arguments in place of the library."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("C,HW,offset,want", [
    (20, 4096, 0, (20, True)), (7, 4096, 0, (0, True)),
    (20, 4097, 0, (20, False)), (20, 4096, 1, (20, False)),
    (31, 700, 4, (0, True)), (3, 1023, 0, (0, False))])
def test_wrapper_picks_the_instance(monkeypatch, C, HW, offset, want):
    """C = 20 takes the compiled instance and any other C the run-time
    one; the 16-byte path needs HW % 4 == 0 and 16-byte aligned logits.
    The wrappers pass that choice and size K1's partials by num_blocks."""
    store = torch.zeros(2 * C * HW + offset)
    x = store[offset:].view(2, C, HW)
    bits = torch.zeros(2, 1, HW, dtype=torch.int32)
    assert pixel_loss.instance(x, bits) == want
    assert pixel_loss.compiled_classes(C) == want[0]

    # the kernel path, on meta tensors, against a library that records
    lib, sized = _FakeLib(), []
    monkeypatch.setattr(pixel_loss, "_lib", lambda: lib)
    monkeypatch.setattr(_build, "LAUNCHES", type(_build.LAUNCHES)())
    monkeypatch.setattr(_build, "stream_ptr", lambda device: None)
    real = pixel_loss.num_blocks
    monkeypatch.setattr(pixel_loss, "num_blocks",
                        lambda *a: sized.append(a) or real(*a))
    monkeypatch.setattr(pixel_loss, "instance", lambda xc, b: want)
    xm, bm = x.to("meta"), bits.to("meta")
    pixel_loss.pixel_ce_fwd(xm, bm, TEMP)
    pixel_loss.pixel_ce_bwd(xm, bm, torch.empty(2, device="meta"), TEMP)
    pixel_loss.pixel_ce_rows_fwd(torch.empty(HW, C, device="meta"),
                                 bm[0, 0], TEMP)
    assert [c[0] for c in lib.calls] == ["pixel_ce_fwd", "pixel_ce_bwd",
                                         "pixel_ce_rows_fwd"]
    assert lib.calls[0][1][-3:-1] == want and lib.calls[1][1][-3:-1] == want
    assert lib.calls[2][1][-2] == want[0]
    assert sized == [(2, HW), (1, HW)]
    assert dict(_build.LAUNCHES) == {"pixel_ce_fwd": 1, "pixel_ce_bwd": 1,
                                     "pixel_ce_rows_fwd": 1}
