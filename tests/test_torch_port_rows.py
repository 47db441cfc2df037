"""The row-major loss ops of the port on the CPU against the JAX package:
segment_softmax_max over pre-scaled (P, C) rows (K7 by default, K8 then
K5 with prereduce=True) and pixel_partial_ce over (N, C) rows (K9, K10),
forward and backward. The JAX side runs its Pallas kernels in interpret
mode (MULACTSEG_FORCE_PALLAS_INTERPRET=1, and MULACTSEG_SSM_PREREDUCE=1
for the pre-reduced branch) or calls them directly with interpret=True.

Inputs are made with numpy from a seed at the shapes of
tests/test_fused_loss.py (P 4096 or a ragged 4093, C 6, S 40; N 1000).

Tolerances:
- K7 maxima: float32 softmaxes of the same bf16-rounded rows, whose exp
  may differ by an ulp: rtol 1e-6. Argmax pixels exact except at float32
  near-ties (the two sides' pixels within 1e-6 of each other), at most
  1% of entries. Absent sets exact.
- K8 maxima are bf16-rounded: within one bf16 ulp (2**-7 of the larger),
  argmax pixels exact except where the two pixels' float32 probabilities
  lie within one bf16 ulp. Absent sets exact.
- Gradients: the same formula in another summation order, rtol 1e-5 and
  atol 1e-5 of the largest entry.
- pixel_partial_ce sums rtol 1e-5 and counts exact (as
  tests/test_fused_loss.py); its gradient rtol 1e-5, atol 1e-5 against
  the Pallas backward and rtol 5e-3, atol 1e-5 against autodiff of the
  dense forward (the analytic and the autodiff chain cancel differently
  in saturated rows, as that file states).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mulactseg_tpu.ops import segment as jseg
from mulactseg_tpu.ops.pixel_loss_pallas import (
    _bwd_pallas,
    _dense_fwd,
    _fwd_pallas,
)
from mulactseg_tpu.ops.pixel_loss_pallas import (
    pixel_partial_ce as jax_pixel_partial_ce,
)
from mulactseg_tpu_torch.ops import _build, pixel_loss, segment
from tests.test_torch_port_prereduce import _bf16, _probs

torch.set_num_threads(1)

C, S = 6, 40
BF16_ULP = 2.0 ** -7


def _rows_case(seed, P, temp, underflow=False):
    """Pre-scaled rows with exact ties between row pairs (or an underflowed
    and a saturated class), runs of 6 rows, 5% invalid rows and an absent
    segment 3."""
    rng = np.random.RandomState(seed)
    x = rng.randn(P, C).astype(np.float32)
    if underflow:
        x[:, 0] -= 40.0
        x[:, 1] += 40.0
    else:
        x[1::2] = x[0:P - 1:2]
    sid = np.repeat(rng.randint(0, S, -(-P // 6)), 6)[:P]
    sid[sid == 3] = S
    sid[rng.rand(P) < 0.05] = S
    return (x / np.float32(temp)).astype(np.float32), sid.astype(np.int32)


def _check_pix(pix, jpix, p, rel, P):
    """Exact, except where the float32 values at the two pixels lie within
    rel of each other; absent sets exact; pixels in their segments."""
    absent = jpix == P
    np.testing.assert_array_equal(pix == P, absent)
    assert absent[3].all() and (~absent).any()
    cls = np.broadcast_to(np.arange(C), (S, C))
    q, jq = np.minimum(pix, P - 1), np.minimum(jpix, P - 1)
    differ = pix != jpix
    near = np.abs(p[q, cls] - p[jq, cls]) <= rel * p[jq, cls]
    assert (near | ~differ).all(), f"{differ.sum()} argmax pixels differ"
    assert differ.mean() <= 0.01
    return absent, q


@pytest.mark.parametrize("P", [4096, 4093])
@pytest.mark.parametrize("prereduce", [False, True])
@pytest.mark.parametrize("temp,underflow", [(0.5, False), (0.1, True)])
def test_segment_softmax_max_rows_matches_jax(monkeypatch, P, prereduce,
                                              temp, underflow):
    """(d) Both branches of the row-major segment_softmax_max, forward and
    backward, against JAX. P = 4093 gives the port a short last block;
    the JAX package pads P with invalid rows."""
    monkeypatch.setenv("MULACTSEG_FORCE_PALLAS_INTERPRET", "1")
    if prereduce:
        monkeypatch.setenv("MULACTSEG_SSM_PREREDUCE", "1")
    u, sid = _rows_case(P + 7 * underflow, P, temp, underflow)
    w = np.random.RandomState(9).rand(S, C).astype(np.float32)
    ut = torch.from_numpy(u).requires_grad_(True)
    _build.reset_launches()
    mx, pix = segment.segment_softmax_max(ut, torch.from_numpy(sid), S,
                                          prereduce=prereduce)
    (torch.from_numpy(w) * torch.log(mx + 1e-8)).sum().backward()
    assert dict(_build.LAUNCHES) == {}

    def f(v):
        m, q = jseg.segment_softmax_max(v, jnp.asarray(sid), S)
        return jnp.sum(jnp.asarray(w) * jnp.log(m + 1e-8)), (m, q)

    (_, (jmx, jpix)), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(u))
    jmx, jpix, jg = np.asarray(jmx), np.asarray(jpix), np.asarray(jg)
    mx, pix = mx.detach().numpy(), pix.numpy()
    if prereduce:
        p = _probs(u, 1.0)
        np.testing.assert_array_less(
            np.abs(mx - jmx), BF16_ULP * np.maximum(mx, jmx) + 1e-30)
        absent, q = _check_pix(pix, jpix, p, BF16_ULP, P)
    else:
        p = _probs(_bf16(u), 1.0)
        np.testing.assert_allclose(mx, jmx, rtol=1e-6, atol=0)
        absent, q = _check_pix(pix, jpix, p, 1e-6, P)
    assert (mx[absent] == 0.0).all()
    seg = np.broadcast_to(np.arange(S)[:, None], (S, C))
    assert (sid[q[~absent]] == seg[~absent]).all()
    if underflow:
        assert (mx[~absent[:, 0], 0] == 0.0).all()
    np.testing.assert_allclose(ut.grad.numpy(), jg, rtol=1e-5,
                               atol=1e-5 * np.abs(jg).max())


def test_row_branches_round_at_different_points():
    """K7 rounds the logits to bf16, K8 the probabilities: the two
    branches' maxima differ (as the reference's do), and K8's are bf16
    values."""
    u, sid = _rows_case(3, 4096, 0.5)
    ut, st = torch.from_numpy(u), torch.from_numpy(sid)
    mx7, _ = segment.segment_softmax_max(ut, st, S)
    mx8, _ = segment.segment_softmax_max(ut, st, S, prereduce=True)
    assert not torch.equal(mx7, mx8)
    assert torch.equal(mx8, segment._round_bf16(mx8))
    assert not torch.equal(mx7, segment._round_bf16(mx7))


@pytest.mark.parametrize("N,C_", [(1000, 6), (4096, 20)])
def test_pixel_partial_ce_matches_jax(N, C_):
    """(e) pixel_partial_ce forward (K9's plain version) against the Pallas
    forward in interpret mode and the dense forward, and its backward
    (K10's plain version, through autograd) against the Pallas backward
    and JAX's VJP."""
    rng = np.random.RandomState(N + C_)
    x = (rng.randn(N, C_) * 2).astype(np.float32)
    bits = (rng.randint(0, 2 ** C_, N) * (rng.rand(N) < 0.8)).astype(
        np.int32)
    bits[: N // 4] = 1 << rng.randint(0, C_, N // 4)  # one-hot pixels
    xt = torch.from_numpy(x).requires_grad_(True)
    out = pixel_loss.pixel_partial_ce(xt, torch.from_numpy(bits), 0.1)
    (2.0 * out[0] + 3.0 * out[2] + 5.0 * out[1]).backward()
    got = out.detach().numpy()
    assert got[1] > 0 and got[3] > 0
    xj, bj = jnp.asarray(x), jnp.asarray(bits)
    for ref in (_fwd_pallas(xj, bj, 0.1, interpret=True),
                _dense_fwd(xj, bj, 0.1)):
        ref = np.array([float(v) for v in ref])
        np.testing.assert_allclose(got[0::2], ref[0::2], rtol=1e-5)
        np.testing.assert_array_equal(got[1::2], ref[1::2])

    want = np.asarray(_bwd_pallas(xj, bj, jnp.float32(2.0), jnp.float32(3.0),
                                  0.1, interpret=True))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-5)

    def f(v):
        a, n1, c, _ = jax_pixel_partial_ce(v, bj, 0.1)
        return 2.0 * a + 3.0 * c + 5.0 * n1

    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jax.grad(f)(xj)),
                               rtol=5e-3, atol=1e-5)
    assert (xt.grad.numpy()[bits == 0] == 0).all()


def test_row_wrappers_match_nchw_plain_versions():
    """K9 and K10's plain versions are K1's and K2's on the rows' (1, C, N)
    view; the wrappers return the row layout."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(300, 7).astype(np.float32))
    bits = torch.from_numpy(rng.randint(0, 128, 300).astype(np.int32))
    g = torch.tensor([2.0, 3.0])
    view, bits3 = x.t().contiguous()[None], bits[None, None]
    # a contiguous copy vectorises in another order: float32 rounding,
    # which dl's cancellation (pos p - p t) lifts to 1e-6 of its largest
    # entry
    torch.testing.assert_close(pixel_loss.pixel_ce_rows_fwd(x, bits, 0.1),
                               pixel_loss.pixel_ce_fwd(view, bits3, 0.1),
                               rtol=1e-6, atol=0)
    dl = pixel_loss.pixel_ce_rows_bwd(x, bits, g, 0.1)
    assert dl.shape == x.shape
    torch.testing.assert_close(
        dl, pixel_loss.pixel_ce_bwd(view, bits3, g, 0.1)[0].t(), rtol=0,
        atol=1e-6 * float(dl.abs().max()))
