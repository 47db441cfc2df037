"""SegFormer (models/segformer.py), an architecture of the port alone, held
to the benchmark's plain float32 reference (benchmark/reference/segformer.py)
on the CPU at a small size: widths 16/32/48/64 with 1 or 2 heads, depths
1/1/2/1, reduction ratios 4/2/2/1, decoder 32, 64 x 64 inputs, the same
seeded weights loaded into both by name.

Tolerances: the eval-mode logits and features within 1e-5 of the largest
(float32 on both sides; the port's LayerNorm, GELU and attention are
torch's kernels, the reference's are written out, which moves the last
bits); the train-mode loss within 1e-4 relative, and each leaf's gradient
within 1e-4 of the larger of its own largest entry and the median leaf's
(the biases in front of the decoder's BN have a gradient of zero in exact
arithmetic, so their round-off is held to the scale of the others). One
generator drives drop-path and Dropout2d on each side, seeded alike.

At full width, on the meta device, SegFormer-B5's names, shapes and
parameter count; `get_model` refuses another output stride; the `sdpa`
counters and the five spans of one forward; the drop-path masks.
"""

import json
import os

import pytest
import torch
import torch.nn.functional as F

from benchmark import common
from benchmark.reference import segformer as ref
from mulactseg_tpu_torch.models import segformer as port
from mulactseg_tpu_torch.models.factory import get_model
from mulactseg_tpu_torch.models.layers import Dropout, DropPath
from mulactseg_tpu_torch.ops import _build
from mulactseg_tpu_torch.utils import spans

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TINY = dict(embed_dims=[16, 32, 48, 64], depths=[1, 1, 2, 1],
            num_heads=[1, 2, 2, 1], sr_ratios=[4, 2, 2, 1], mlp_ratio=4,
            patch_sizes=[7, 3, 3, 3], strides=[4, 2, 2, 2],
            decoder_channels=32, drop_path=0.1)
SPANS = ("model.stage1", "model.stage2", "model.stage3", "model.stage4",
         "model.decode")


def tiny_cfg(**widths):
    return {"name": "tiny", "model": "segformerwn_mitb5",
            "reference": "segformer", "widths": dict(TINY, **widths),
            "output_stride": 32, "num_outputs": 20}


def pair(cfg, seed=5):
    """The port's network and the reference at cfg's widths, both holding
    the weights made from the seed."""
    _, r, w = common.reference_net(cfg, seed, CPU)
    p = port.segformer(cfg["num_outputs"], cfg["widths"])
    common.load_weights(p, w)
    return p, r


def images(seed=0, b=2, hw=64):
    return torch.randn(b, 3, hw, hw,
                       generator=torch.Generator().manual_seed(seed))


def test_eval_logits_and_features_match_the_reference():
    p, r = pair(tiny_cfg())
    p.eval(), r.eval()
    x = images()
    with torch.no_grad():
        got, want = p(x, return_feat=True), r(x, return_feat=True)
        logits = p(x)
    assert torch.equal(logits, got[1])
    for a, b in zip(got, want):  # features, logits
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_train_loss_and_gradients_match_the_reference():
    """Train mode at drop-path 0.5, so that the masks drop samples."""
    p, r = pair(tiny_cfg(drop_path=0.5))
    p.train(), r.train()
    gp, gr = (torch.Generator().manual_seed(11) for _ in range(2))
    kin = [m for m in p.modules() if isinstance(m, Dropout)]
    assert len(kin) == len(ref.dropouts(r)) == sum(TINY["depths"]) + 1
    for m in kin:
        m.generator = gp
    for m in ref.dropouts(r):
        m.generator = gr
    x = images(1)
    labels = torch.randint(0, 20, (2, 64, 64),
                           generator=torch.Generator().manual_seed(2))
    losses = []
    for net in (p, r):
        loss = F.cross_entropy(net(x) / 0.1, labels)
        loss.backward()
        losses.append(float(loss.detach()))
    assert losses[0] == pytest.approx(losses[1], rel=1e-4)
    want = dict(r.named_parameters())
    scale = {n: float(t.grad.abs().max()) for n, t in want.items()}
    med = sorted(scale.values())[len(scale) // 2]
    for n, t in p.named_parameters():
        gap = float((t.grad - want[n].grad).abs().max())
        assert gap <= 1e-4 * max(scale[n], med), n


def test_full_width_names_shapes_and_count():
    """SegFormer-B5 at its published widths: the port's leaves are the
    reference's, named and ordered alike, and their count is the one the
    configuration states."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "city_segformer_b5.json")) as f:
        cfg = json.load(f)
    with torch.device("meta"):
        p = port.segformer(cfg["num_outputs"])
        r = ref.Net(cfg)
    got = [(n, tuple(t.shape)) for n, t in p.named_parameters()]
    assert got == [(n, tuple(t.shape)) for n, t in r.named_parameters()]
    assert sum(t.numel() for t in p.parameters()) == cfg["params"] \
        == 84608704
    assert [n for n, _ in p.named_buffers()] == \
        [n for n, _ in r.named_buffers()]
    shapes = dict(got)
    assert [len(getattr(p.backbone, f"block{i}")) for i in range(1, 5)] == \
        [3, 6, 40, 3]
    assert [shapes[f"backbone.norm{i}.weight"] for i in range(1, 5)] == \
        [(64,), (128,), (320,), (512,)]
    assert [p.backbone.block3[0].attn.heads, p.backbone.block4[0].attn.heads
            ] == [5, 8]
    assert shapes["backbone.block1.0.attn.sr.weight"] == (64, 64, 8, 8)
    assert "backbone.block4.0.attn.sr.weight" not in shapes
    assert shapes["backbone.block3.39.mlp.dwconv.dwconv.weight"] == \
        (1280, 1, 3, 3)
    assert shapes["backbone.patch_embed1.proj.weight"] == (64, 3, 7, 7)
    assert shapes["classifier.linear_fuse.conv.weight"] == (768, 3072, 1, 1)
    assert shapes["classifier.proxy"] == (20, 768, 1, 1)
    rates = [b.drop_path.p for i in range(1, 5)
             for b in getattr(p.backbone, f"block{i}")]
    assert rates[0] == 0.0 and rates[-1] == pytest.approx(0.1)
    assert rates[26] == pytest.approx(0.1 * 26 / 51)


@pytest.mark.parametrize("stride", [8, 16])
def test_get_model_refuses_another_output_stride(stride):
    with pytest.raises(ValueError, match="output stride 32"):
        get_model("segformerwn_mitb5", 20, stride, device="cpu")


def test_sdpa_counters_add_up_to_the_shapes_products():
    p, _ = pair(tiny_cfg())
    p.eval()
    _build.reset_launches()
    with torch.no_grad():
        p(images(b=3, hw=96))
    calls, bhnmd, bhnpmd = 0, 0, 0
    side = 96 // 4
    for i, n in enumerate(TINY["depths"]):
        N = side * side
        M = (side // TINY["sr_ratios"][i]) ** 2
        h = TINY["num_heads"][i]
        d = TINY["embed_dims"][i] // h
        calls += n
        bhnmd += n * 3 * h * N * M * d
        bhnpmd += n * 3 * h * (N + M) * d
        side //= 2
    assert dict(_build.LAUNCHES) == {"sdpa": calls, "sdpa.bhnmd": bhnmd,
                                     "sdpa.bhnpmd": bhnpmd}
    _build.reset_launches()


def test_each_span_once_a_forward():
    p, _ = pair(tiny_cfg())
    p.eval()
    before = spans.snapshot()
    with torch.no_grad():
        p(images(), return_feat=True)
    now = spans.snapshot()
    assert {n: now[n][0] - before.get(n, (0,))[0] for n in SPANS} == \
        {n: 1 for n in SPANS}


def test_drop_path_masks_are_per_sample_and_reproduce():
    x = torch.ones(64, 5, 3)
    d = DropPath(0.3).train()
    outs = []
    for _ in range(2):
        d.generator = torch.Generator().manual_seed(4)
        outs.append(d(x))
    y = outs[0]
    assert torch.equal(outs[0], outs[1])
    kept = y[:, 0, 0] != 0
    assert torch.equal(y, kept[:, None, None] * (x / 0.7))
    assert 0 < int(kept.sum()) < 64
    d.generator = torch.Generator().manual_seed(5)
    assert not torch.equal(d(x), y)
    assert torch.equal(d.eval()(x), x)
