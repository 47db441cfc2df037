"""The reference network is a function of the configuration: each
configuration's `reference` names its module, whose network is built
from `widths`, `output_stride`, `separable_conv` and `model`. The
recipes' seeded weights and step FLOPs are held to the values they had
when the network was fixed in code; every configuration's network has
the port's parameter shapes and its stated count; a deeper network at
output stride 8 agrees with the port and drives a training run to
`correct` on the CPU.
"""

import copy
import hashlib
import os
import re
import time

import pytest
import torch

import bench_tiny
from benchmark import common, reference
from benchmark.loops import train

torch.set_num_threads(2)
CONFIGS = sorted(f[:-5] for f in os.listdir(
    os.path.join(bench_tiny.ROOT, "benchmark", "configs"))
    if f.endswith(".json"))

# recorded from the network fixed in code: sha256 over each name and its
# float32 bytes, in the order made, at seed 2**31 + 5 on the CPU
WEIGHTS = {
    "city_recipe": (326, "cedece8cca6b3e37169ebf66205118d7"
                         "030fdd8e72d8f96097cc4b7cf3032b61"),
    "voc_recipe": (326, "c64ba46350c7b15df0970d0fcf0c76eab"
                        "61b5847dfddea0c9cabf69ecb57beb0"),
}
NAMES = "bbfee02c9ab1cbed7307b34c7831934c88ec82a30edcd417852b8693c9adedf2"
FLOPS = {"city_stage1": 2415143682048.0, "voc_stage1": 3358862865792.0}


def resnet101_os8(cfg):
    """The Cityscapes DeepLabV3+ setting: ResNet-101 with the deep stem at
    output stride 8, ASPP rates (12, 24, 36)."""
    cfg = copy.deepcopy(cfg)
    cfg["model"] = "deeplabv3pluswn_resnet101deepstem"
    cfg["widths"].update(blocks=[3, 4, 23, 3], aspp_rates=[12, 24, 36])
    cfg.update(output_stride=8, params=45798352)
    return cfg


def made(name):
    if name == "resnet101_os8":
        return resnet101_os8(bench_tiny.load("configs", "city_recipe"))
    return bench_tiny.load("configs", name)


@pytest.mark.parametrize("name", sorted(WEIGHTS))
def test_recipe_weights_are_as_recorded(name):
    w = common.make_weights(made(name), 2 ** 31 + 5, bench_tiny.CPU)
    h = hashlib.sha256()
    for n, t in w.items():
        h.update(n.encode())
        h.update(t.contiguous().numpy().tobytes())
    assert len(w) == WEIGHTS[name][0]
    assert hashlib.sha256("\n".join(w).encode()).hexdigest() == NAMES
    assert h.hexdigest() == WEIGHTS[name][1]


@pytest.mark.parametrize("cell", sorted(FLOPS))
def test_step_flops_are_as_recorded(cell):
    w = next(x for x in bench_tiny.bench()["workloads"] if x["name"] == cell)
    assert train.step_flops(made(w["config"])) == FLOPS[cell]


def shapes(net):
    return [(n, tuple(p.shape)) for n, p in net.named_parameters()]


@pytest.mark.parametrize("name", CONFIGS + ["resnet101_os8"])
def test_reference_has_the_ports_shapes_and_stated_count(name):
    from mulactseg_tpu_torch.models.factory import get_model

    cfg = made(name)
    with torch.device("meta"):
        ref = reference.of(cfg).Net(cfg)
    port = get_model(cfg["model"], cfg["num_outputs"], cfg["output_stride"],
                     separable_conv=cfg["separable_conv"], device="cpu")
    assert shapes(ref) == shapes(port)
    assert sum(p.numel() for p in ref.parameters()) == cfg["params"]


def test_widths_that_disagree_with_the_model_fail():
    from mulactseg_tpu_torch.models.factory import get_model

    cfg = bench_tiny.load("configs", "city_recipe")
    cfg["widths"]["blocks"] = [3, 4, 23, 3]  # model still names ResNet-50
    with torch.device("meta"):
        ref = reference.of(cfg).Net(cfg)
    port = get_model(cfg["model"], cfg["num_outputs"], cfg["output_stride"],
                     separable_conv=cfg["separable_conv"], device="cpu")
    assert shapes(ref) != shapes(port)
    with pytest.raises(KeyError):
        common.load_weights(port, common.make_weights(cfg, 1,
                                                      bench_tiny.CPU))


@pytest.mark.parametrize("variant", ["resnet101_os8", "dense_os16"])
def test_forward_matches_the_port(variant):
    """Eval mode at the CPU size, the tolerance of the recipe's test."""
    _, cfg, _, _ = bench_tiny.cell("city_stage1")
    if variant == "resnet101_os8":
        cfg = resnet101_os8(cfg)
    else:
        cfg["separable_conv"] = False
    port, ref = bench_tiny.pair(cfg)
    port.eval(), ref.eval()
    x = torch.randn(2, 3, cfg["crop"], cfg["crop"],
                    generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a, b = port(x), ref(x)
    assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_a_deeper_network_at_output_stride_8_is_correct():
    """The training loop on ResNet-101 at output stride 8, driven as the
    fault tests drive it, under city_stage1's limits."""
    w, cfg, mix, limits = bench_tiny.cell("city_stage1")
    out = train.run(w, resnet101_os8(cfg), mix, limits, 2 ** 31 + 101, 0.5,
                    False, bench_tiny.CPU, time.perf_counter())
    ok, checks = common.judge(out["values"], limits)
    assert ok and out["values"]["rows_not_in_pool"] == 0, checks


def test_a_missing_reference_module_names_its_file():
    cfg = bench_tiny.load("configs", "city_recipe")
    cfg["reference"] = "segformer_b5"
    want = os.path.join("benchmark", "reference", "segformer_b5.py")
    with pytest.raises(FileNotFoundError, match=re.escape(want)):
        common.make_weights(cfg, 1, bench_tiny.CPU)


def test_an_unbuilt_head_names_the_configuration_key():
    cfg = bench_tiny.load("configs", "city_recipe")
    cfg["model"] = "deeplabv3plus_resnet50deepstem"
    with pytest.raises(ValueError, match="'model'"):
        reference.of(cfg).Net(cfg)
