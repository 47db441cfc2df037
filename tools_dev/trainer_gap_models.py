"""How far the port's ALTrainer and the JAX package's part after a few
AdamW steps from one init, on the small separable twin and on the tiny
conv/BN pair, at the sizes of tests/test_torch_port_profile.py (33x33,
nseg 16, 6 synthetic label images, every superpixel labelled, 2 steps,
float32, dropout off). The twin runs on the fixture's images as they are
and with test_torch_port_train.make_batch's per-image scale and offset.

The fixture's images are noise of one distribution, so the twin's ASPP
pooling branch normalises 4 nearly equal pooled values: its float32
single-pass variance (E[x^2] - m^2, on both sides) cancels, and AdamW's
first step turns the rounding into sign flips. This is why the
profiler test holds the JAX trainer to 1e-4 on the tiny pair.

Usage: JAX_PLATFORMS=cpu python tools_dev/trainer_gap_models.py [--steps N]
Prints one JSON line per case: the relative L2 gap of the parameters over
all leaves, how far the JAX run moved them, and each step's loss gap.
XLA runs at the test suite's optimisation level 0 (tests/conftest.py)
unless XLA_FLAGS says otherwise.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("XLA_FLAGS", "--xla_backend_optimization_level=0")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mulactseg_tpu.config import Config as JaxConfig  # noqa: E402
from mulactseg_tpu.data.synthetic import (  # noqa: E402
    SyntheticRegionDataset as JaxDataset,
)
from mulactseg_tpu.engine import rounds as jax_rounds  # noqa: E402
from mulactseg_tpu_torch.config import Config  # noqa: E402
from mulactseg_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticRegionDataset,
)
from mulactseg_tpu_torch.engine.rounds import ALTrainer  # noqa: E402
from mulactseg_tpu_torch.models import convert  # noqa: E402
from tests.test_torch_port_criteria_step import (  # noqa: E402
    _params_tree,
    tiny_pair,
)
from tests.test_torch_port_model import NC, jax_variables, twin_pair  # noqa
from tests.test_torch_port_profile import _Active, _sets  # noqa: E402
from tests.test_torch_port_rounds import _cfg_kw, _port_twin  # noqa: E402
from tests.test_torch_port_train import _global_rel  # noqa: E402


class Scaled:
    """A label set whose i-th image is scaled and offset as make_batch
    spreads its images (0.5-2.0, -2.0-2.0)."""

    def __init__(self, dataset):
        n = len(dataset)
        self.dataset = dataset
        self.scale = np.linspace(0.5, 2.0, n).astype(np.float32)
        self.offset = np.linspace(-2.0, 2.0, n).astype(np.float32)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        item = dict(self.dataset[i])
        item["images"] = item["images"] * self.scale[i] + self.offset[i]
        return item


def gap(model_name, scaled, steps, workdir):
    if model_name == "twin":
        _, ref = twin_pair(separable=True)
        v = jax_variables(ref, 9)
        port = _port_twin(v)
        port_params = lambda: convert.state_dict_to_variables(
            port.state_dict())["params"]
    else:
        port, ref, v = tiny_pair(NC, 3)
        port_params = lambda: _params_tree(port)
    wrap = Scaled if scaled else (lambda d: d)
    kw = _cfg_kw(os.path.join(workdir, "port"), finetune_itrs=steps,
                 val_period=2, log_period=1)
    losses = {"port": [], "jax": []}
    label, _ = _sets(SyntheticRegionDataset)
    ALTrainer(Config(**kw), 1, model=port, device="cpu").train(
        _Active(wrap(label)), metrics_cb=lambda i, a: losses["port"].append(
            a["train_loss"]))
    kw["model_save_dir"] = os.path.join(workdir, "jax")
    jt = jax_rounds.ALTrainer(JaxConfig(**kw), 1, model=ref)
    jt.state = jt.state.replace(params=v["params"],
                                batch_stats=v["batch_stats"],
                                opt_state=jt.state.tx.init(v["params"]))
    jlabel, _ = _sets(JaxDataset)
    jt.train(_Active(wrap(jlabel)), metrics_cb=lambda i, a: losses[
        "jax"].append(float(a["train_loss"])))
    want = jax.device_get(jt.state.params)
    return {"model": model_name, "scaled_images": scaled, "steps": steps,
            "param_rel_l2": float(_global_rel(port_params(), want)),
            "moved_rel_l2": float(_global_rel(v["params"], want)),
            "step_loss_rel": [abs(a - b) / abs(b) for a, b in
                              zip(losses["port"], losses["jax"])]}


def main():
    import tempfile

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    fnn.Dropout.__call__ = lambda self, x, **kw: x  # dropout off
    for model_name, scaled in (("twin", False), ("twin", True),
                               ("tiny", False)):
        with tempfile.TemporaryDirectory() as tmp:
            print(json.dumps(gap(model_name, scaled, args.steps, tmp)),
                  flush=True)


if __name__ == "__main__":
    main()
