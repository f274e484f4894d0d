"""The paper's CNN zoo, ResNet18/34, VGG11 and SqueezeNet, as unit lists,
in PyTorch (port of ``repro.models.cnn``).

A model is a flat list of *units* (stem, residual blocks, VGG conv layers,
fire modules); NeuLite splits the list into T blocks and trains them
progressively.  Normalization is GroupNorm, as in the reference.  Public
functions take NHWC images and return NHWC features (permuted views), as
the reference does; inside, activations are NCHW.  Every conv goes through
``CNNConfig.conv_impl``: by default cuDNN on the card, im2col on the CPU.
Conv weights are OIHW (``bridge`` converts the reference's HWIO).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.paramdef import ParamDef
from repro_torch.models.layers import cross_entropy


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    arch: str                      # resnet18 | resnet34 | vgg11 | squeezenet
    num_classes: int = 10
    width_mult: float = 1.0
    in_channels: int = 3
    image_size: int = 32
    groups: int = 8                # GroupNorm groups
    conv_impl: str = "auto"        # native | im2col | auto (resolve_conv_impl)

    def scaled(self, c: int) -> int:
        return max(self.groups, int(c * self.width_mult) // self.groups
                   * self.groups)


# --------------------------------------------------------------------------- #
# primitive layers
# --------------------------------------------------------------------------- #
def conv_defs(cin: int, cout: int, k: int = 3) -> dict:
    # OIHW: the reference's "model" on HWIO's O (axis 3) sits on axis 0
    return {"w": ParamDef((cout, cin, k, k), spec=("model",),
                          scale=(2.0 / (k * k * cin)) ** 0.5)}


def resolve_conv_impl(impl: str, device) -> str:
    """``conv_impl="auto"`` -> a concrete implementation for ``device``
    (the reference's rule, with the port's names: its ``"lax"`` is
    ``"native"`` here): im2col on the CPU, where patches and one einsum
    (one batched matmul under ``torch.func.vmap`` over per-cohort weights)
    beat a grouped convolution, and cuDNN on the card."""
    if impl == "auto":
        return "im2col" if torch.device(device).type == "cpu" else "native"
    return impl


def _same_pads(H, W, k, stride):
    """Total SAME padding of each spatial axis, as XLA computes it."""
    return (max((-(-H // stride) - 1) * stride + k - H, 0),
            max((-(-W // stride) - 1) * stride + k - W, 0))


def _conv_im2col(params, x, stride: int = 1):
    """SAME conv as patch extraction + one einsum (port of the reference's
    ``_conv_im2col``): k² strided slices of the SAME-padded NCHW input,
    concatenated to (B, k²·Cin, OH, OW) in (di, dj, cin) order, contracted
    with the OIHW weight laid out the same way.  Matmul-shaped, so it maps
    well under ``torch.func.vmap`` over per-cohort weights."""
    w = params["w"]
    cout, cin, k, _ = w.shape
    if k == 1 and stride == 1:
        return torch.einsum("bchw,oc->bohw", x, w[:, :, 0, 0])
    H, W = x.shape[-2:]
    oh, ow = -(-H // stride), -(-W // stride)
    ph, pw = _same_pads(H, W, k, stride)
    xp = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    cols = torch.cat([xp[..., di:di + (oh - 1) * stride + 1:stride,
                         dj:dj + (ow - 1) * stride + 1:stride]
                      for di in range(k) for dj in range(k)], dim=1)
    return torch.einsum("bphw,op->bohw", cols,
                        w.permute(0, 2, 3, 1).reshape(cout, k * k * cin))


def conv(params, x, stride: int = 1, impl: str = "native"):
    """SAME conv of an NCHW tensor with an OIHW weight: ``impl="native"``
    through ``F.conv2d`` (cuDNN on the card), ``"im2col"`` as patches and
    one einsum.  As in XLA's SAME padding, an odd total pad puts the extra
    row/column at the end."""
    if impl == "im2col":
        return _conv_im2col(params, x, stride)
    if impl != "native":
        raise ValueError(f"conv impl {impl!r}: expected 'native' or "
                         f"'im2col'")
    w = params["w"]
    ph, pw = _same_pads(*x.shape[-2:], w.shape[-1], stride)
    if ph == pw and ph % 2 == 0:
        return F.conv2d(x, w, stride=stride, padding=ph // 2)
    x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    return F.conv2d(x, w, stride=stride)


def gn_defs(c: int) -> dict:
    return {"scale": ParamDef((c,), init="ones"),
            "bias": ParamDef((c,), init="zeros")}


def groupnorm(params, x, groups: int = 8, eps: float = 1e-5):
    """GroupNorm of an NCHW tensor, on the input less its group means.

    The shift changes neither the output nor the gradient in exact
    arithmetic (GroupNorm is shift-invariant per group; the means are
    constants to autograd), but ``F.group_norm``'s backward works from the
    uncentred input and cancels where a group's mean is large against its
    spread: a width-sliced 2-channel stem had its gradients 2e-3 off the
    reference's, which centres first, as this does."""
    B, C = x.shape[:2]
    g = min(groups, C)
    while C % g:
        g -= 1
    xg = x.reshape(B, g, -1)
    xc = (xg - xg.detach().mean(-1, keepdim=True)).reshape(x.shape)
    return F.group_norm(xc, g, params["scale"], params["bias"], eps)


def linear_defs(cin: int, cout: int) -> dict:
    return {"w": ParamDef((cin, cout), spec=(None, "model")),
            "b": ParamDef((cout,), spec=("model",), init="zeros")}


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


def _vgg_unit(cfg, cin, cout, pool):
    return ("vgg", {"cin": cin, "cout": cout, "stride": 2 if pool else 1},
            {"conv": conv_defs(cin, cout), "gn": gn_defs(cout)})


def _fire_unit(cfg, cin, squeeze, expand, pool):
    d = {"squeeze": conv_defs(cin, squeeze, k=1), "gn": gn_defs(squeeze),
         "e1": conv_defs(squeeze, expand, k=1),
         "e3": conv_defs(squeeze, expand, k=3)}
    return ("fire", {"cin": cin, "cout": 2 * expand,
                     "stride": 2 if pool else 1}, d)


def _pool(h, stride):
    """A pooling unit's 2x2 max pool (floor mode, as the reference's VALID
    ``reduce_window``), skipped once the map is spatially flat (H < 2;
    NCHW, so H is axis 2)."""
    if stride == 2 and h.shape[2] >= 2:
        return F.max_pool2d(h, 2, 2)
    return h


def _unit_apply(kind, meta, params, x, groups, impl: str = "native"):
    s = meta["stride"]
    cv = functools.partial(conv, impl=impl)
    if kind == "stem":
        return F.relu(groupnorm(params["gn"], cv(params["conv"], x, s),
                                groups))
    if kind == "basic":
        h = F.relu(groupnorm(params["gn1"], cv(params["conv1"], x, s),
                             groups))
        h = groupnorm(params["gn2"], cv(params["conv2"], h, 1), groups)
        sc = cv(params["proj"], x, s) if "proj" in params else x
        return F.relu(h + sc)
    if kind == "vgg":
        return _pool(F.relu(groupnorm(params["gn"], cv(params["conv"], x),
                                      groups)), s)
    if kind == "fire":
        sq = F.relu(groupnorm(params["gn"], cv(params["squeeze"], x),
                              groups))
        h = torch.cat([F.relu(cv(params["e1"], sq)),
                       F.relu(cv(params["e3"], sq))], dim=1)
        return _pool(h, s)
    raise ValueError(kind)


def build_units(cfg: CNNConfig) -> List[Tuple[str, dict, dict]]:
    s = cfg.scaled
    if cfg.arch in ("resnet18", "resnet34"):
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
    if cfg.arch == "vgg11":
        plan = [(s(64), True), (s(128), True), (s(256), False),
                (s(256), True), (s(512), False), (s(512), True),
                (s(512), False), (s(512), True)]
        units, cin = [], cfg.in_channels
        for cout, pool in plan:
            units.append(_vgg_unit(cfg, cin, cout, pool))
            cin = cout
        return units
    if cfg.arch == "squeezenet":
        units = [_stem_unit(cfg, s(64))]
        plan = [(s(16), s(64), False), (s(16), s(64), True),
                (s(32), s(128), False), (s(32), s(128), True),
                (s(48), s(192), False), (s(48), s(192), False),
                (s(64), s(256), True), (s(64), s(256), False)]
        cin = s(64)
        for sq, ex, pool in plan:
            units.append(_fire_unit(cfg, cin, sq, ex, pool))
            cin = 2 * ex
        return units
    raise ValueError(cfg.arch)


def cnn_defs(cfg: CNNConfig) -> dict:
    units = build_units(cfg)
    cout = units[-1][1]["cout"]
    return {"units": [d for _, _, d in units],
            "head": linear_defs(cout, cfg.num_classes)}


def unit_meta(cfg: CNNConfig) -> List[Tuple[str, dict]]:
    return [(k, m) for k, m, _ in build_units(cfg)]


def cnn_apply_units(cfg: CNNConfig, metas, params_list, x):
    impl = resolve_conv_impl(cfg.conv_impl, x.device)
    for (kind, meta), p in zip(metas, params_list):
        x = _unit_apply(kind, meta, p, x, cfg.groups, impl)
    return x


def nchw(images):
    """NHWC images -> an NCHW view (no copy)."""
    return images.float().permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def cnn_forward(params, cfg: CNNConfig, images):
    x = cnn_apply_units(cfg, unit_meta(cfg), params["units"], nchw(images))
    return linear(params["head"], x.mean(dim=(2, 3)))


def cnn_loss(params, cfg: CNNConfig, batch):
    """Full-model training loss: mean cross-entropy of the logits."""
    logits = cnn_forward(params, cfg, batch["inputs"]["images"])
    return cross_entropy(logits, batch["labels"])


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
    impl = resolve_conv_impl(cfg.conv_impl, x.device)
    for p in sur_params:
        x = F.relu(groupnorm(p["gn"], conv(p["conv"], x, 2, impl),
                             cfg.groups))
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
