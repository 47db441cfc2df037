"""The plain float32 reference: network, training step, pseudo-labeller.

A configuration names its network's module under the key `reference`:
`benchmark/reference/<reference>.py`, found by name as the loops and the
metrics are. Every such module provides

- `Net(cfg)`: the float32 plain-torch network, its parameters and buffers
  named as the port's (the backbone under `backbone.`, the head under
  `classifier.`); `forward(x, return_feat=False)` returns the logits at
  the input size, with `return_feat` (features, logits);
- `weight_rule(net, cfg)`: the leaves drawn from the seed, in draw order,
  each with its standard deviation, and the fill of every other parameter
  and buffer (`common.make_weights` draws and fills them);
- `dropouts(net)`: its dropout modules, whose `generator` the caller sets;
- `Quant`: the float8 control's switch, `Quant.fp8`.
"""

from __future__ import annotations

import importlib
import os
import re
from types import ModuleType
from typing import Dict

HERE = os.path.dirname(os.path.abspath(__file__))
PARTS = ("Net", "weight_rule", "dropouts", "Quant")


def of(cfg: Dict) -> ModuleType:
    """The reference module that the configuration names."""
    name = str(cfg.get("reference", ""))
    path = os.path.join(HERE, f"{name}.py")
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name) or \
            not os.path.isfile(path):
        raise FileNotFoundError(
            f"configuration {cfg.get('name')!r}: its reference {name!r} "
            f"names no module {path}")
    mod = importlib.import_module(f"benchmark.reference.{name}")
    missing = [p for p in PARTS if not hasattr(mod, p)]
    if missing:
        raise AttributeError(f"{path} lacks {missing}: a reference network "
                             f"provides {', '.join(PARTS)}")
    return mod
