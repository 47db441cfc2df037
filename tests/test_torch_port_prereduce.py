"""The pre-reduced group term (K6, then K5, then the map back) and its
dispatch, on the CPU, against the JAX package's sorted branch
(mulactseg_tpu/ops/segment.py:670-742) run in interpret mode.

Inputs are made with numpy from a seed at the shapes of
tests/test_fused_loss.py (B 2, C 6, HW 2048, about 40 segments).

Tolerances:
- Values after the pre-reduction are bf16-rounded probabilities. Both
  sides compute the float32 softmax in the same op order, but their exp
  may differ by an ulp, and a value next to a rounding boundary can then
  round the other way: values agree within one bf16 ulp (2**-7 of the
  larger), and are expected to be equal almost everywhere.
- Choices and argmax pixels are compared exactly, except where the two
  sides' pixels hold float32 probabilities within one bf16 ulp of each
  other (a near-tie that such a rounding can flip); at most 1% of entries
  may be such near-ties. Absent sets are exact.
- The loss, its parts and the gradient: float32 sums in another order,
  rtol 1e-5 and gradient atol 1e-5 of its largest entry (as
  tests/test_torch_port_train.py); they hold because the bf16 values
  agree.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mulactseg_tpu.losses.fused import lossdecomp_fused as jax_lossdecomp
from mulactseg_tpu.ops import segment as jseg
from mulactseg_tpu.ops.segment_pallas import prereduce_softmax_nchw as jax_k6
from mulactseg_tpu_torch.losses.fused import lossdecomp_fused
from mulactseg_tpu_torch.ops import _build, segment
from tests.test_torch_port_train import make_batch

torch.set_num_threads(1)

B, C, HW, NSEG = 2, 6, 2048, 20
S = B * NSEG
P = B * HW
BF16_ULP = 2.0 ** -7


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's kernels, interpreted on the CPU, on the sorted
    (pre-reduced) branch of its NCHW group term."""
    monkeypatch.setenv("MULACTSEG_FORCE_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MULACTSEG_NCHW_SCATTER", "0")


def _case(seed, temp, underflow=False, hw=HW):
    """Logits with exact ties between pixel pairs (or an underflowed class
    and a saturated one), runs of 6 pixels (so blocks of 4 mix segments),
    5% invalid pixels and an absent segment 3 in each image."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, C, hw).astype(np.float32)
    if underflow:
        x[:, 0] -= 40.0  # probability exactly 0.0 at temp 0.1
        x[:, 1] += 40.0  # probability 1.0
    else:
        x[:, :, 1::2] = x[:, :, 0:hw - 1:2]
    local = np.repeat(rng.randint(0, NSEG, (B, -(-hw // 6))), 6,
                      axis=1)[:, :hw]
    local[local == 3] = NSEG
    local[rng.rand(B, hw) < 0.05] = NSEG
    sid = np.where(local >= NSEG, S, local + np.arange(B)[:, None] * NSEG)
    return x, sid.reshape(B, 1, hw).astype(np.int32)


def _bf16(a):
    """numpy round to nearest even bf16, kept in float32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _probs(x, temp):
    """(B, C, HW) float32 softmax of x * (1/T), in float64 then rounded."""
    u = x.astype(np.float64) * np.float32(1.0 / temp)
    e = np.exp(u - u.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def _assert_within_bf16_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = BF16_ULP * np.maximum(np.abs(got), np.abs(want))
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def _assert_same_or_near_tie(got, want, p_got, p_want, what):
    """got == want, except at near-ties: entries whose float32 values
    p_got and p_want (at the two sides' picks) lie within one bf16 ulp."""
    differ = got != want
    near = np.abs(p_got - p_want) <= BF16_ULP * np.maximum(p_got, p_want)
    assert (near | ~differ).all(), f"{what}: {differ.sum()} entries differ"
    assert differ.mean() <= 0.01, f"{what}: {differ.sum()} near-ties"


@pytest.mark.parametrize("temp,underflow", [(0.5, False), (0.1, True)])
def test_prereduce_plain_matches_pallas_interpret(temp, underflow):
    """(a) K6's plain version against prereduce_softmax_nchw."""
    x, sid3 = _case(1, temp, underflow)
    planes, choice, sid2 = segment.prereduce_softmax_nchw(
        torch.from_numpy(x), torch.from_numpy(sid3), S, temp)
    jv, jc = jax_k6(jnp.asarray(x), jnp.asarray(sid3), 4, temp,
                    interpret=True)
    want_v = np.asarray(jv, np.float32)[:, :C]
    got_v = planes.t().numpy()
    _assert_within_bf16_ulp(got_v, want_v)
    assert (got_v == want_v).mean() > 0.999
    # choices: compare the float32 probabilities of the two picked pixels
    p = np.swapaxes(_probs(x, temp), 1, 2).reshape(P, C)
    got_c, want_c = choice.t().numpy(), np.asarray(jc)
    lead = (np.arange(P // 4) * 4)[:, None]
    cls = np.arange(C)[None, :]
    _assert_same_or_near_tie(got_c, want_c, p[lead + got_c, cls],
                             p[lead + want_c, cls], "choice")
    # retired ids, as ops/segment.py:682-686 makes them
    sb = sid3.reshape(P // 4, 4)
    want_sid2 = np.where(np.arange(4) == 0, sb,
                         np.where(sb == sb[:, :1], S, sb)).reshape(P)
    np.testing.assert_array_equal(sid2.numpy(), want_sid2)
    if underflow:
        assert (got_v[:, 0] == 0.0).all()


@pytest.mark.parametrize("temp,underflow", [(0.5, False), (0.1, True)])
def test_prereduced_group_term_matches_sorted_branch(interpret, monkeypatch,
                                                     temp, underflow):
    """(b) segment_softmax_max_nchw past the guard (monkeypatched low),
    values, argmax pixels and the logits gradient, against the JAX sorted
    branch."""
    monkeypatch.setattr(segment, "SCATTER_MAX_SEGMENTS", 8)
    x, sid3 = _case(2, temp, underflow)
    w = np.random.RandomState(3).rand(S, C).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    _build.reset_launches()
    mx, pix = segment.segment_softmax_max_nchw(xt, torch.from_numpy(sid3), S,
                                               temp)
    (torch.from_numpy(w) * torch.log(mx + 1e-8)).sum().backward()
    assert dict(_build.LAUNCHES) == {}  # the CPU takes the plain versions

    def f(v):
        m, q = jseg.segment_softmax_max_nchw(
            v, jnp.asarray(sid3.reshape(-1)), S, temp)
        return jnp.sum(jnp.asarray(w) * jnp.log(m + 1e-8)), (m, q)

    (_, (jmx, jpix)), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(x))
    jmx, jpix, jg = np.asarray(jmx), np.asarray(jpix), np.asarray(jg)
    mx, pix = mx.detach().numpy(), pix.numpy()

    _assert_within_bf16_ulp(mx, jmx)
    absent = jpix == P
    np.testing.assert_array_equal(pix == P, absent)
    assert absent[3].all() and (~absent).any()
    assert (mx[absent] == 0.0).all()
    p = np.swapaxes(_probs(x, temp), 1, 2).reshape(P, C)
    cls = np.broadcast_to(np.arange(C), (S, C))
    q, jq = np.minimum(pix, P - 1), np.minimum(jpix, P - 1)
    _assert_same_or_near_tie(pix, jpix, p[q, cls], p[jq, cls], "argmax")
    # the argmax pixels lie in their segments
    seg = np.broadcast_to(np.arange(S)[:, None], (S, C))
    assert (sid3.reshape(P)[q[~absent]] == seg[~absent]).all()
    if underflow:
        # an underflowed class still records a pixel in every present
        # segment (a 0.0 value beats no value)
        assert (mx[~absent[:, 0], 0] == 0.0).all()
        assert (pix[~absent[:, 0], 0] < P).all()
    else:
        np.testing.assert_array_equal(pix, jpix)
    np.testing.assert_allclose(xt.grad.numpy(), jg, rtol=1e-5,
                               atol=1e-5 * np.abs(jg).max())


def test_prereduced_values_are_bf16_rounded(monkeypatch):
    """The pre-reduced term's maxima are the K3 maxima rounded to bf16: the
    fault of a port that ran K3 at every S (it differed from the reference
    by up to one bf16 ulp per entry past the guard)."""
    x, sid3 = _case(4, 0.1)
    xt, st = torch.from_numpy(x), torch.from_numpy(sid3)
    mx_k3, _ = segment.segment_softmax_max_nchw(xt, st, S, 0.1)
    monkeypatch.setattr(segment, "SCATTER_MAX_SEGMENTS", 8)
    mx_pre, _ = segment.segment_softmax_max_nchw(xt, st, S, 0.1)
    assert torch.equal(mx_pre, segment._round_bf16(mx_k3))
    assert not torch.equal(mx_pre, mx_k3)


def test_dispatch_follows_the_reference_guard(monkeypatch):
    """The dispatch picks K3 while S + 1 <= SCATTER_MAX_SEGMENTS and the
    pre-reduced term past it, as ops/segment.py:653-654 does."""
    assert segment.SCATTER_MAX_SEGMENTS == 9216
    calls = []
    monkeypatch.setattr(segment, "ssm_fwd",
                        lambda *a: calls.append("k3") or
                        segment.ssm_fwd_plain(*a))
    monkeypatch.setattr(segment, "_ssm_prereduced",
                        lambda *a: calls.append("pre") or
                        segment.ssm_fwd_plain(*a))
    x = torch.zeros(1, 3, 8)
    sid = torch.zeros(1, 1, 8, dtype=torch.int32)
    segment.segment_softmax_max_nchw(x, sid, 9215, 1.0)
    segment.segment_softmax_max_nchw(x, sid, 9216, 1.0)
    monkeypatch.setattr(segment, "SCATTER_MAX_SEGMENTS", 4)
    segment.segment_softmax_max_nchw(x, sid, 3, 1.0)
    segment.segment_softmax_max_nchw(x, sid, 4, 1.0)
    assert calls == ["k3", "pre", "k3", "pre"]


@pytest.mark.parametrize("H,W", [(32, 32), (33, 31)])
def test_lossdecomp_past_the_guard_matches_jax(interpret, monkeypatch, H, W):
    """(c) lossdecomp_fused with the port's guard monkeypatched low, so the
    group term is pre-reduced, against JAX on its sorted branch. At 33x31
    (HW % 4 == 3) the port's last block of each image is short, where
    the JAX package pads HW to 2048 with invalid pixels."""
    monkeypatch.setattr(segment, "SCATTER_MAX_SEGMENTS", 8)
    rng = np.random.RandomState(H * W)
    b, c, nseg = 2, 20, 16
    batch = make_batch(rng, b, H, W, c, nseg)
    logits = (rng.randn(b, c, H, W) * 3).astype(np.float32)
    kw = dict(nseg=nseg, coeff=16.0, coeff_mc=8.0, coeff_gm=1.0,
              multi_ce_temp=0.1, group_ce_temp=0.1)
    lt = torch.from_numpy(logits).requires_grad_(True)
    total, aux = lossdecomp_fused(
        lt, torch.from_numpy(batch["target_bits"]),
        torch.from_numpy(batch["target"]), torch.from_numpy(batch["spx"]),
        **kw)
    total.backward()

    def f(lg):
        return jax_lossdecomp(lg, jnp.asarray(batch["target_bits"]),
                              jnp.asarray(batch["target"]),
                              jnp.asarray(batch["spx"]), nchw=True, **kw)

    (jt, jaux), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jnp.asarray(logits))
    for k in ("ce_loss", "mc_loss", "group_loss", "train_loss"):
        assert float(aux[k].detach()) > 0.0, k
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]),
                                   rtol=1e-5, err_msg=k)
    jg = np.asarray(jg)
    np.testing.assert_allclose(lt.grad.numpy(), jg, rtol=1e-5,
                               atol=1e-5 * np.abs(jg).max())
    # the bf16 rounding reached the loss: K3's unrounded group term differs
    monkeypatch.setattr(segment, "SCATTER_MAX_SEGMENTS", 9216)
    _, aux3 = lossdecomp_fused(
        torch.from_numpy(logits), torch.from_numpy(batch["target_bits"]),
        torch.from_numpy(batch["target"]), torch.from_numpy(batch["spx"]),
        **kw)
    assert float(aux3["group_loss"]) != float(aux["group_loss"].detach())


def _brute_force(x, sid, temp, nseg_total):
    """numpy: per image, blocks of 4 from the image's first pixel (the last
    one short), the leader's block max over same-id pixels, bf16 values,
    first choices, retired ids; then the segment max with the smallest
    row and the map back to pixels."""
    b_, c_, hw = x.shape
    p = _probs(x, temp)
    nb = -(-hw // 4)
    planes = np.zeros((c_, b_ * hw), np.float32)
    choice = np.zeros((c_, b_ * nb), np.int64)
    sid2 = np.zeros(b_ * hw, np.int64)
    for b in range(b_):
        for k in range(nb):
            lo, hi = k * 4, min(k * 4 + 4, hw)
            ids = sid[b, lo:hi]
            same = ids == ids[0]
            for off in range(hi - lo):
                g = b * hw + lo + off
                sid2[g] = ids[off] if off == 0 or not same[off] else \
                    nseg_total
                planes[:, g] = p[b, :, lo + off]
            vals = np.where(same[None, :], p[b, :, lo:hi], -1.0)
            planes[:, b * hw + lo] = vals.max(axis=1)
            choice[:, b * nb + k] = vals.argmax(axis=1)  # first max
    planes = _bf16(planes)
    mx = np.zeros((nseg_total, c_), np.float32)
    pix = np.full((nseg_total, c_), b_ * hw, np.int64)
    for r in range(b_ * hw):  # rows in order: strict > keeps the first
        s = sid2[r]
        if s >= nseg_total:
            continue
        take = (planes[:, r] > mx[s]) | (pix[s] == b_ * hw)
        mx[s] = np.where(take, planes[:, r], mx[s])
        b, hw_r = divmod(r, hw)
        src = r + (choice[:, b * nb + hw_r // 4] if hw_r % 4 == 0 else 0)
        pix[s] = np.where(take, src, pix[s])
    return planes, choice, sid2, mx, pix


@pytest.mark.parametrize("hw", [1023, 4 * 97 + 2])
def test_short_blocks_match_brute_force(hw):
    """(f) HW % 4 != 0, port only: the blocks are cut per image, so an
    image's last block is short and no block spans two images."""
    x, sid3 = _case(5, 0.5, hw=hw)
    xt, st = torch.from_numpy(x), torch.from_numpy(sid3)
    planes, choice, sid2 = segment.prereduce_softmax_nchw(xt, st, S, 0.5)
    mx, pix = segment._ssm_prereduced(xt, st, S, 0.5)
    want = _brute_force(x, sid3[:, 0], 0.5, S)
    _assert_within_bf16_ulp(planes.numpy(), want[0])
    np.testing.assert_array_equal(sid2.numpy(), want[2])
    p = np.swapaxes(_probs(x, 0.5), 1, 2).reshape(B * hw, C)
    nb = -(-hw // 4)
    lead = np.concatenate([b * hw + np.arange(nb) * 4 for b in range(B)])
    cls = np.arange(C)[:, None]
    got_c = choice.numpy()
    assert (lead[None, :] + got_c < np.repeat(np.arange(1, B + 1) * hw,
                                              nb)[None, :]).all()
    _assert_same_or_near_tie(got_c, want[1], p[lead + got_c, cls],
                             p[lead + want[1], cls], "choice")
    _assert_within_bf16_ulp(mx.numpy(), want[3])
    q, wq = np.minimum(pix.numpy(), B * hw - 1), np.minimum(want[4],
                                                            B * hw - 1)
    cls = np.broadcast_to(np.arange(C), (S, C))
    np.testing.assert_array_equal(pix.numpy() == B * hw, want[4] == B * hw)
    _assert_same_or_near_tie(pix.numpy(), want[4], p[q, cls], p[wq, cls],
                             "argmax")
