"""The criteria's inputs on the bf16 step.

make_train_step runs each criterion outside autocast, on float32 inputs:
the logits come from the float32 cosine head (models/deeplab.py) through
float32 resizes, the features of a needs_feat criterion from the same
head, and a needs_weak_forward criterion's weak-view logits are cast by
.float() (engine/train.py). The JAX package does the same (its cosine
head and the weak view's logits in float32). So bf16 changes a criterion
only through the forward and its backward, which the bf16 reference files
hold (tests/test_torch_port_bf16_reference*.py, chip_smoke.py's
bf16_parity).

Here make_train_step runs on the CPU under CPU bfloat16 autocast (the
train module's bf16_autocast patched to answer True, the port's code as
it is) for one needs_feat criterion (active_onlineplbl_multi_predignore)
and one needs_weak_forward criterion (active_joint_hier_multi_async), on
the small twin: the stem's convolution computes in bfloat16, and every
tensor the criterion receives (logits, feat, plbl_logits, logits_weak)
is float32.
"""

import numpy as np
import pytest
import torch

import torch_port_parallel_ranks as ranks  # beside this file
from mulactseg_tpu_torch.config import Config
from mulactseg_tpu_torch.engine import train
from mulactseg_tpu_torch.models import convert

torch.set_num_threads(1)


@pytest.mark.parametrize("method,received", [
    ("active_onlineplbl_multi_predignore",
     {"logits", "feat", "plbl_logits"}),
    ("active_joint_hier_multi_async", {"logits", "logits_weak"})])
def test_criterion_inputs_are_float32_on_the_bf16_step(monkeypatch, method,
                                                       received):
    seen = {}
    make = train.CRITERIA[method]

    def recording(cfg):
        fn = make(cfg)

        def criterion(logits, batch, *extra):
            seen["logits"] = logits.dtype
            if "logits_weak" in batch:
                seen["logits_weak"] = batch["logits_weak"].dtype
            for k in ("feat", "plbl_logits"):
                if extra and k in extra[0]:
                    seen[k] = extra[0][k].dtype
            return fn(logits, batch, *extra)

        criterion.__dict__.update(fn.__dict__)  # keys, needs_* flags
        return criterion

    monkeypatch.setitem(train.CRITERIA, method, recording)
    monkeypatch.setattr(train, "bf16_autocast", lambda dev, cfg: True)
    cfg = Config(**{**ranks.cfg_kw(method, {}), "dtype": "bfloat16"})
    model = ranks.port_twin(separable=True)
    convert.load_variables(model, convert.random_variables(model, 3))
    stem = []
    model.backbone.conv1[0].register_forward_hook(
        lambda m, i, o: stem.append(o.dtype))
    step = train.make_train_step(model, cfg, device="cpu")
    batch = ranks.for_method(ranks.full_batch(np.random.RandomState(21)),
                             method)
    aux = step(batch)
    assert stem and set(stem) == {torch.bfloat16}
    assert seen == {k: torch.float32 for k in received}
    assert torch.isfinite(aux["train_loss"])
