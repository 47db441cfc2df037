"""The port's kernels' plain versions (K1-K4, run on the CPU) against the JAX
package's Pallas kernels in interpret mode and its dense paths.

Tolerances: float32 sums and softmaxes computed in another order give
relative differences of a few ulps; sums over 8192 pixels are held to
rtol 1e-5, per-element values and gradients to rtol/atol 1e-5 (1e-6 for
the max probabilities), argmax pixels and absent sets exactly.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mulactseg_tpu.ops import segment as jseg
from mulactseg_tpu.ops.pixel_loss_pallas import (
    _bwd_pallas_cs,
    _dense_fwd_cs,
    _fwd_pallas_cs,
)
from mulactseg_tpu.ops.segment_pallas import (
    NCHW_CHUNK,
    scatter_softmax_bwd_nchw,
    scatter_softmax_max_nchw,
)
from mulactseg_tpu_torch.ops import pixel_loss, segment

torch.set_num_threads(1)

B, C, H, W = 2, 20, 64, 64
HW = H * W
P = B * HW


def _bits(rng):
    """Candidate bitmasks with n == 0, n == 1 and n > 1 pixels."""
    shape = (B, 1, HW)
    kind = rng.randint(0, 3, shape)
    c1 = rng.randint(0, C, shape)
    c2 = (c1 + 1 + rng.randint(0, C - 1, shape)) % C
    one = 1 << c1
    many = one | (1 << c2) | (rng.randint(0, 2 ** C, shape)
                              & rng.randint(0, 2 ** C, shape))
    bits = np.where(kind == 0, 0, np.where(kind == 1, one, many))
    return bits.astype(np.int32)


@pytest.fixture(scope="module")
def pixel_case():
    rng = np.random.RandomState(0)
    x = rng.randn(B, C, HW).astype(np.float32) * 2.0
    return x, _bits(rng)


def test_pixel_ce_fwd_matches_pallas_interpret(pixel_case):
    x, bits = pixel_case
    got = pixel_loss.pixel_ce_fwd(torch.from_numpy(x), torch.from_numpy(bits),
                                  0.1).numpy()
    want = _fwd_pallas_cs(jnp.asarray(x), jnp.asarray(bits), 0.1,
                          interpret=True)
    dense = _dense_fwd_cs(jnp.asarray(x), jnp.asarray(bits), 0.1)
    for ref in (want, dense):
        ref = np.array([float(v) for v in ref])
        np.testing.assert_allclose(got[0::2], ref[0::2], rtol=1e-5)
        np.testing.assert_array_equal(got[1::2], ref[1::2])  # counts exact
    assert got[1] > 0 and got[3] > 0  # both buckets populated


def test_pixel_ce_bwd_matches_pallas_interpret(pixel_case):
    x, bits = pixel_case
    g = np.array([2.0, 3.0], np.float32)
    got = pixel_loss.pixel_ce_bwd(torch.from_numpy(x), torch.from_numpy(bits),
                                  torch.from_numpy(g), 0.1).numpy()
    want = np.asarray(_bwd_pallas_cs(jnp.asarray(x), jnp.asarray(bits),
                                     jnp.float32(2.0), jnp.float32(3.0), 0.1,
                                     interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # n == 0 pixels carry no gradient
    dead = np.broadcast_to(bits == 0, got.shape)
    assert (got[dead] == 0).all()


def test_pixel_partial_ce_autograd_matches_jax_vjp(pixel_case):
    from mulactseg_tpu.ops.pixel_loss_pallas import pixel_partial_ce_nchw

    x, bits = pixel_case
    xt = torch.from_numpy(x).requires_grad_(True)
    s = pixel_loss.pixel_partial_ce_nchw(xt, torch.from_numpy(bits), 0.1)
    (2.0 * s[0] + 3.0 * s[2] + 5.0 * s[1]).backward()

    def f(v):
        a, n1, c, _ = pixel_partial_ce_nchw(v, jnp.asarray(bits), 0.1)
        return 2.0 * a + 3.0 * c + 5.0 * n1

    want = np.asarray(jax.grad(f)(jnp.asarray(x)))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-5)


def _segment_case(seed, temp, underflow=False):
    rng = np.random.RandomState(seed)
    nseg = 9
    S = B * nseg
    x = rng.randn(B, C, HW).astype(np.float32)
    if underflow:
        x[:, 0, :] -= 40.0  # class 0 underflows to exactly 0.0 everywhere
        x[:, 1, :] += 40.0  # class 1 saturates to 1.0 everywhere
    else:
        x[:, :, 1::2] = x[:, :, ::2]  # adjacent pixel pairs tie exactly
    # raster runs (some crossing chunk borders); ids >= nseg are absent
    local = np.repeat(rng.randint(0, nseg + 2, (B, HW // 16)), 16, axis=1)
    local[local == 3] = nseg  # segment 3 of each image is absent
    gsid = np.where(local >= nseg, S, local + np.arange(B)[:, None] * nseg)
    return x, gsid.reshape(B, 1, HW).astype(np.int32), S


@pytest.mark.parametrize("temp,underflow", [(0.5, False), (0.1, True)])
def test_segment_max_matches_pallas_interpret(temp, underflow):
    assert HW % NCHW_CHUNK == 0
    x, sid3, S = _segment_case(1, temp, underflow)
    mx, pix = segment.ssm_fwd(torch.from_numpy(x), torch.from_numpy(sid3), S,
                              temp)
    want_mx, want_pix = scatter_softmax_max_nchw(
        jnp.asarray(x), jnp.asarray(sid3), temp, S, interpret=True, dbl=6)
    np.testing.assert_array_equal(pix.numpy(), np.asarray(want_pix))
    np.testing.assert_allclose(mx.numpy(), np.asarray(want_mx), rtol=1e-6,
                               atol=1e-6)
    absent = pix.numpy() == P
    assert absent.any() and (~absent).any()
    assert (mx.numpy()[absent] == 0.0).all()
    if underflow:
        # a present segment whose class-0 probabilities are all 0.0 still
        # records its first pixel
        assert (mx.numpy()[~absent[:, 0], 0] == 0.0).all()
        assert (pix.numpy()[:, 0] < P).any()


def test_segment_max_matches_jax_dense():
    x, sid3, S = _segment_case(2, 0.5)
    mx, pix = segment.ssm_fwd(torch.from_numpy(x), torch.from_numpy(sid3), S,
                              0.5)
    want_mx, want_pix = jseg._ssm_nchw_dense(jnp.asarray(x),
                                             jnp.asarray(sid3), S, 0.5)
    np.testing.assert_array_equal(pix.numpy(), np.asarray(want_pix))
    np.testing.assert_allclose(mx.numpy(), np.asarray(want_mx), rtol=1e-6,
                               atol=1e-6)


def test_segment_bwd_matches_pallas_interpret():
    rng = np.random.RandomState(3)
    temp = 0.1
    S = 32
    x = rng.randn(B, C, HW).astype(np.float32)
    # sparse entries: distinct argmax pixels per class, some absent/zero
    pix = np.full((S, C), P, np.int32)
    for c in range(C):
        pix[:, c] = rng.choice(P, S, replace=False)
    pix[rng.rand(S, C) < 0.2] = P
    vals = rng.rand(S, C).astype(np.float32)
    g = rng.randn(S, C).astype(np.float32)
    g[rng.rand(S, C) < 0.2] = 0.0

    got = segment.ssm_bwd(torch.from_numpy(x), torch.from_numpy(vals),
                          torch.from_numpy(pix), torch.from_numpy(g),
                          temp).numpy()

    # the Pallas kernel takes dlm as a flat cell-major buffer
    G = HW // NCHW_CHUNK
    flat = np.zeros(B * C * HW, np.float32)
    for s in range(S):
        for c in range(C):
            q = pix[s, c]
            if q < P and g[s, c] != 0:
                b, hw = q // HW, q % HW
                cell, off = hw // NCHW_CHUNK, hw % NCHW_CHUNK
                flat[((b * G + cell) * C + c) * NCHW_CHUNK + off] = \
                    g[s, c] * vals[s, c]
    want = np.asarray(scatter_softmax_bwd_nchw(jnp.asarray(x),
                                               jnp.asarray(flat), temp,
                                               interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    dense, _ = jseg._ssm_nchw_bwd(
        S, temp, (jnp.asarray(x), jnp.asarray(vals), jnp.asarray(pix)),
        (jnp.asarray(g), jnp.zeros((S, C), jnp.int32)))
    np.testing.assert_allclose(got, np.asarray(dense), rtol=1e-5, atol=1e-5)


def test_segment_autograd_matches_jax_vjp():
    x, sid3, S = _segment_case(4, 0.5)
    w = np.random.RandomState(5).rand(S, C).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    mx, _ = segment.segment_softmax_max_nchw(xt, torch.from_numpy(sid3), S,
                                             0.5)
    (torch.from_numpy(w) * torch.log(mx + 1e-8)).sum().backward()

    def f(v):
        m, _ = jseg.segment_softmax_max_nchw(v, jnp.asarray(sid3.reshape(-1)),
                                             S, 0.5)
        return jnp.sum(jnp.asarray(w) * jnp.log(m + 1e-8))

    want = np.asarray(jax.grad(f)(jnp.asarray(x)))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-5)
