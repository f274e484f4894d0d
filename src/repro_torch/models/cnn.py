"""The paper's ResNet18/34 as unit lists, in PyTorch (port of
``repro.models.cnn``).

A model is a flat list of *units* (stem, residual blocks); NeuLite splits
the list into T blocks and trains them progressively.  Normalization is
GroupNorm, as in the reference.  Public functions take NHWC images and
return NHWC features (permuted views), as the reference does; inside,
activations are NCHW and convs go to cuDNN.  Conv weights are OIHW
(``bridge`` converts the reference's HWIO).  VGG11 and SqueezeNet units
come with a later part of the port.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.paramdef import ParamDef

PORTED_ARCHS = ("resnet18", "resnet34")


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    arch: str                      # resnet18 | resnet34
    num_classes: int = 10
    width_mult: float = 1.0
    in_channels: int = 3
    image_size: int = 32
    groups: int = 8                # GroupNorm groups

    def scaled(self, c: int) -> int:
        return max(self.groups, int(c * self.width_mult) // self.groups
                   * self.groups)


# --------------------------------------------------------------------------- #
# primitive layers
# --------------------------------------------------------------------------- #
def conv_defs(cin: int, cout: int, k: int = 3) -> dict:
    return {"w": ParamDef((cout, cin, k, k), scale=(2.0 / (k * k * cin)) ** 0.5)}


def conv(params, x, stride: int = 1):
    """SAME conv of an NCHW tensor with an OIHW weight.  As in XLA's SAME
    padding, an odd total pad puts the extra row/column at the end."""
    w = params["w"]
    k = w.shape[-1]
    H, W = x.shape[-2:]
    ph = max((-(-H // stride) - 1) * stride + k - H, 0)
    pw = max((-(-W // stride) - 1) * stride + k - W, 0)
    if ph == pw and ph % 2 == 0:
        return F.conv2d(x, w, stride=stride, padding=ph // 2)
    x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    return F.conv2d(x, w, stride=stride)


def gn_defs(c: int) -> dict:
    return {"scale": ParamDef((c,), init="ones"),
            "bias": ParamDef((c,), init="zeros")}


def groupnorm(params, x, groups: int = 8, eps: float = 1e-5):
    C = x.shape[1]
    g = min(groups, C)
    while C % g:
        g -= 1
    return F.group_norm(x, g, params["scale"], params["bias"], eps)


def linear_defs(cin: int, cout: int) -> dict:
    return {"w": ParamDef((cin, cout)),
            "b": ParamDef((cout,), init="zeros")}


def linear(params, x):
    return x @ params["w"] + params["b"]


# --------------------------------------------------------------------------- #
# units: (kind, meta, defs); meta carries static info (stride, cin, cout)
# --------------------------------------------------------------------------- #
def _stem_unit(cfg, cout):
    return ("stem", {"cin": cfg.in_channels, "cout": cout, "stride": 1},
            {"conv": conv_defs(cfg.in_channels, cout), "gn": gn_defs(cout)})


def _basic_unit(cfg, cin, cout, stride):
    d = {"conv1": conv_defs(cin, cout), "gn1": gn_defs(cout),
         "conv2": conv_defs(cout, cout), "gn2": gn_defs(cout)}
    if stride != 1 or cin != cout:
        d["proj"] = conv_defs(cin, cout, k=1)
    return ("basic", {"cin": cin, "cout": cout, "stride": stride}, d)


def _unit_apply(kind, meta, params, x, groups):
    s = meta["stride"]
    if kind == "stem":
        return F.relu(groupnorm(params["gn"], conv(params["conv"], x, s),
                                groups))
    if kind == "basic":
        h = F.relu(groupnorm(params["gn1"], conv(params["conv1"], x, s),
                             groups))
        h = groupnorm(params["gn2"], conv(params["conv2"], h, 1), groups)
        sc = conv(params["proj"], x, s) if "proj" in params else x
        return F.relu(h + sc)
    raise ValueError(kind)


def build_units(cfg: CNNConfig) -> List[Tuple[str, dict, dict]]:
    if cfg.arch not in PORTED_ARCHS:
        raise ValueError(f"arch {cfg.arch!r} is not ported yet; the port has "
                         f"{PORTED_ARCHS}")
    s = cfg.scaled
    n = [2, 2, 2, 2] if cfg.arch == "resnet18" else [3, 4, 6, 3]
    widths = [s(64), s(128), s(256), s(512)]
    units = [_stem_unit(cfg, widths[0])]
    cin = widths[0]
    for stage, (reps, cout) in enumerate(zip(n, widths)):
        for i in range(reps):
            stride = 2 if (i == 0 and stage > 0) else 1
            units.append(_basic_unit(cfg, cin, cout, stride))
            cin = cout
    return units


def cnn_defs(cfg: CNNConfig) -> dict:
    units = build_units(cfg)
    cout = units[-1][1]["cout"]
    return {"units": [d for _, _, d in units],
            "head": linear_defs(cout, cfg.num_classes)}


def unit_meta(cfg: CNNConfig) -> List[Tuple[str, dict]]:
    return [(k, m) for k, m, _ in build_units(cfg)]


def cnn_apply_units(cfg: CNNConfig, metas, params_list, x):
    for (kind, meta), p in zip(metas, params_list):
        x = _unit_apply(kind, meta, p, x, cfg.groups)
    return x


def nchw(images):
    """NHWC images -> an NCHW view (no copy)."""
    return images.float().permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def cnn_forward(params, cfg: CNNConfig, images):
    x = cnn_apply_units(cfg, unit_meta(cfg), params["units"], nchw(images))
    return linear(params["head"], x.mean(dim=(2, 3)))


# --------------------------------------------------------------------------- #
# NeuLite surrogate output module and nHSIC projector
# --------------------------------------------------------------------------- #
def cnn_surrogate_defs(cfg: CNNConfig, block_bounds: List[Tuple[int, int]]):
    """One 3x3 stride-2 conv 'basic layer' per replaceable block (paper
    Fig. 4), from the previous block's output channels to this block's."""
    metas = unit_meta(cfg)
    sur = []
    for (_s0, e0), (_s1, e1) in zip(block_bounds[:-1], block_bounds[1:]):
        cin = metas[e0 - 1][1]["cout"]
        cout = metas[e1 - 1][1]["cout"]
        sur.append({"conv": conv_defs(cin, cout), "gn": gn_defs(cout)})
    return sur


def cnn_apply_surrogates(cfg: CNNConfig, sur_params, x):
    for p in sur_params:
        x = F.relu(groupnorm(p["gn"], conv(p["conv"], x, 2), cfg.groups))
    return x


def cnn_projector_defs(cfg: CNNConfig, cin: int, out_dim: int = 64) -> dict:
    hid = 128
    return {"w1": linear_defs(cin, hid), "w2": linear_defs(hid, hid),
            "w3": linear_defs(hid, out_dim)}


def cnn_apply_projector(p, x_pooled):
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(linear(p["w1"], x_pooled), approximate="tanh")
    h = F.gelu(linear(p["w2"], h), approximate="tanh")
    return linear(p["w3"], h)


def cnn_stage_apply(frozen, trainable, cfg: CNNConfig, metas_split, inputs):
    """NeuLite stage forward.  ``metas_split`` holds the "prefix",
    "boundary" and "active" meta lists.  The frozen prefix runs under
    ``torch.no_grad``: it keeps no activations and gets no gradient.
    Returns (logits, feats) with NHWC ``x_embed`` / ``z_active``."""
    x = nchw(inputs["images"])
    if frozen.get("units"):
        with torch.no_grad():
            x = cnn_apply_units(cfg, metas_split["prefix"], frozen["units"],
                                x)
    x_embed = x
    if trainable.get("boundary_units"):
        x = cnn_apply_units(cfg, metas_split["boundary"],
                            trainable["boundary_units"], x)
    x = cnn_apply_units(cfg, metas_split["active"], trainable["units"], x)
    z_active = x
    if trainable.get("surrogates"):
        x = cnn_apply_surrogates(cfg, trainable["surrogates"], x)
    logits = linear(trainable["head"], x.mean(dim=(2, 3)))
    z_proj = None
    if trainable.get("projector") is not None:
        z_proj = cnn_apply_projector(trainable["projector"],
                                     z_active.mean(dim=(2, 3)))
    feats = {"x_embed": nhwc(x_embed), "z_active": nhwc(z_active),
             "z_proj": z_proj}
    return logits, feats
