"""Weight carry between the JAX package's flax variables and the port.

`variables_to_state_dict` maps a {"params", "batch_stats"} numpy tree
(HWIO kernels, BN scale/bias/mean/var) onto the port's state_dict (OIHW
weights, BN weight/bias/running_mean/running_var); `state_dict_to_variables`
is its inverse. Port names are the reference torch names that
mulactseg_tpu/models/torch_import.py:8-23 already reads; the separable
head convolutions use the reference's AtrousSeparableConvolution names
(`<conv>.body.0` depthwise, `<conv>.body.1` pointwise).

Every leaf must map exactly once: an unknown or duplicate name raises, and
`load_variables` loads strictly, so a leaf left over or missing raises too.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

# (port module path, flax module path, kind); {L}/{B}/{K} are integer
# fields copied between the two. First match wins, so the ASPP pooling
# branch (convs.4.{1,2}) precedes the generic convs.{K} rules.
_MODULES = [
    ("backbone.conv1.0", "backbone/stem_conv1", "conv"),
    ("backbone.conv1.3", "backbone/stem_conv2", "conv"),
    ("backbone.conv1.6", "backbone/stem_conv3", "conv"),
    ("backbone.conv1.1", "backbone/stem_bn1", "bn"),
    ("backbone.conv1.4", "backbone/stem_bn2", "bn"),
    ("backbone.conv1", "backbone/conv1", "conv"),
    ("backbone.bn1", "backbone/bn1", "bn"),
    ("backbone.layer{L}.{B}.conv{K}", "backbone/layer{L}_{B}/conv{K}", "conv"),
    ("backbone.layer{L}.{B}.bn{K}", "backbone/layer{L}_{B}/bn{K}", "bn"),
    ("backbone.layer{L}.{B}.downsample.0",
     "backbone/layer{L}_{B}/downsample_conv", "conv"),
    ("backbone.layer{L}.{B}.downsample.1",
     "backbone/layer{L}_{B}/downsample_bn", "bn"),
    ("classifier.aspp.convs.4.1", "classifier/aspp/pool_conv", "conv"),
    ("classifier.aspp.convs.4.2", "classifier/aspp/pool_bn", "bn"),
    ("classifier.final", "classifier/final", "conv"),
]
for _port, _flax in (("classifier.project", "classifier/project"),
                     ("classifier.aspp.convs.{K}", "classifier/aspp/b{K}"),
                     ("classifier.aspp.project", "classifier/aspp/project"),
                     ("classifier.classifier", "classifier/cls0"),
                     ("classifier.classifier", "classifier/cls1")):
    _c, _b = (3, 4) if _flax.endswith("cls1") else (0, 1)
    _MODULES += [
        (f"{_port}.{_c}", f"{_flax}/conv", "conv"),
        (f"{_port}.{_c}.body.0", f"{_flax}/depthwise", "conv"),
        (f"{_port}.{_c}.body.1", f"{_flax}/pointwise", "conv"),
        (f"{_port}.{_b}", f"{_flax}/bn", "bn"),
    ]

# port leaf -> (flax collection, flax leaf), per module kind
_LEAVES = {
    "conv": {"weight": ("params", "kernel"), "bias": ("params", "bias")},
    "bn": {"weight": ("params", "scale"), "bias": ("params", "bias"),
           "running_mean": ("batch_stats", "mean"),
           "running_var": ("batch_stats", "var")},
}


def _regex(pattern: str) -> "re.Pattern":
    parts = re.split(r"(\{[LBK]\})", pattern)
    body = "".join(f"(?P<{p[1]}>\\d+)" if re.fullmatch(r"\{[LBK]\}", p)
                   else re.escape(p) for p in parts)
    return re.compile(body)


_RULES = [(_regex(p), p, _regex(f), f, k) for p, f, k in _MODULES]


def _to_hwio(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _to_oihw(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (3, 2, 0, 1))


def port_to_flax(name: str) -> Tuple[Tuple[str, ...], bool]:
    """Port state_dict key -> (flax path incl. collection, is_conv_kernel)."""
    if name == "classifier.proxy":
        return ("params", "classifier", "proxy"), True
    module, leaf = name.rsplit(".", 1)
    for port_re, _, _, flax_pat, kind in _RULES:
        m = port_re.fullmatch(module)
        if m and leaf in _LEAVES[kind]:
            coll, fleaf = _LEAVES[kind][leaf]
            path = flax_pat.format(**m.groupdict()).split("/")
            return (coll, *path, fleaf), (kind == "conv" and leaf == "weight")
    raise KeyError(f"no flax counterpart for port parameter {name!r}")


def flax_to_port(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """Flax leaf path (collection first) -> (port key, is_conv_kernel)."""
    coll, *mods, fleaf = path
    if tuple(path) == ("params", "classifier", "proxy"):
        return "classifier.proxy", True
    module = "/".join(mods)
    for _, port_pat, flax_re, _, kind in _RULES:
        m = flax_re.fullmatch(module)
        if not m:
            continue
        for leaf, (c, fl) in _LEAVES[kind].items():
            if (c, fl) == (coll, fleaf):
                return (f"{port_pat.format(**m.groupdict())}.{leaf}",
                        kind == "conv" and leaf == "weight")
    raise KeyError(f"no port counterpart for flax leaf {'/'.join(path)!r}")


def _flatten(tree, prefix=()) -> Iterable[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def variables_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """{'params', 'batch_stats'} numpy tree -> port state_dict (float32
    CPU tensors). Raises on a leaf with no port name or on two leaves
    mapping to one name."""
    out: Dict[str, torch.Tensor] = {}
    for coll in variables:
        if coll not in ("params", "batch_stats"):
            raise KeyError(f"unexpected variable collection {coll!r}")
    for path, value in _flatten(variables):
        name, is_kernel = flax_to_port(path)
        if name in out:
            raise KeyError(f"two flax leaves map to {name!r}")
        arr = np.asarray(value, np.float32)
        out[name] = torch.from_numpy(
            np.ascontiguousarray(_to_oihw(arr) if is_kernel else arr))
    return out


def state_dict_to_variables(state_dict) -> Dict:
    """Inverse of variables_to_state_dict: port state_dict -> nested
    {'params': ..., 'batch_stats': ...} numpy tree."""
    tree: Dict = {}
    for name, value in state_dict.items():
        path, is_kernel = port_to_flax(name)
        arr = (value.detach().cpu().float().numpy()
               if isinstance(value, torch.Tensor)
               else np.asarray(value, np.float32))
        arr = np.array(_to_hwio(arr) if is_kernel else arr)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        if path[-1] in node:
            raise KeyError(f"two port parameters map to {'/'.join(path)!r}")
        node[path[-1]] = arr
    return tree


def load_variables(model: torch.nn.Module, variables) -> None:
    """Carry a flax variable tree into `model` (strict: every port
    parameter and buffer must be covered, nothing may be left over)."""
    sd = variables_to_state_dict(variables)
    model.load_state_dict(sd, strict=True)


def random_variables(model: torch.nn.Module, seed: int) -> Dict:
    """A seeded numpy init in the JAX package's layout (HWIO kernels,
    Kaiming-normal: fan_out in the backbone, fan_in in the heads and the
    proxy; BN scale 1 / bias 0 / mean 0 / var 1) for the parameters of
    `model`."""
    from mulactseg_tpu_torch.models.layers import kaiming_std

    rng = np.random.RandomState(seed)
    sd = {}
    for name, t in model.state_dict().items():
        module = name.rsplit(".", 1)[0]
        if name == "classifier.proxy" or name.endswith(".weight") and \
                t.dim() == 4:
            mode = ("fan_in" if name == "classifier.proxy"
                    else model.get_submodule(module).fan_mode)
            std = kaiming_std(t, mode)
            sd[name] = (rng.standard_normal(tuple(t.shape)) * std).astype(
                np.float32)
        elif name.endswith("running_var") or name.endswith(".weight"):
            sd[name] = np.ones(tuple(t.shape), np.float32)
        else:
            sd[name] = np.zeros(tuple(t.shape), np.float32)
    return state_dict_to_variables(sd)
