"""Random weights from the seed, made on the device in one draw.

The tree has the port's layout (`wav2vec2_tpu_torch.models.params`: JAX
names, dense kernels stored [in, out], the encoder layers stacked on a
leading axis) and the shapes and scales of its `init_params`, for each
encoder style the reference knows (`reference/models/`). Every norm affine, bias, folded
BatchNorm and the conformer's pos_bias_u/v are drawn too (1 + 0.2·N for a
scale, 0.2·N for a shift), where `init_params` leaves them at 1 or 0 and a
wrong transpose or a missed affine would pass unseen. All leaves are views
of one f32 buffer filled by one `normal_` call on a `torch.Generator` of
the device.
"""

from __future__ import annotations

import torch

from .reference import models
from .reference.models import dense, norm, under


def leaves(cfg: dict) -> list:
    """Every leaf of the tree for a config.json dict: (path, shape, (scale,
    offset)), the value offset + scale · N(0, 1). The encoder's come from
    the module of its `model_type` (`reference/models/`)."""
    group = cfg["feat_extract_norm"] == "group"
    out = []
    in_c = 1
    for i, (out_c, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        conv = [("weight", (out_c, in_c, k), ((1.0 / (in_c * k)) ** 0.5, 0.0))]
        if cfg.get("conv_bias"):
            conv.append(("bias", (out_c,), (0.2, 0.0)))
        layer = under("conv", conv)
        if not group or i == 0:
            layer += under("layer_norm", norm(out_c))
        out += under(("feature_extractor", "conv_layers", i), layer)
        in_c = out_c
    out += under(("feature_projection", "projection"), dense(in_c, cfg["hidden_size"]))
    out += under(("feature_projection", "layer_norm"), norm(in_c))
    out += under("encoder", models.load(cfg["model_type"]).encoder_leaves(cfg))
    out += under("lm_head", dense(cfg["hidden_size"], cfg["vocab_size"]))
    return out


def numel(cfg: dict) -> int:
    n = 0
    for _, shape, _ in leaves(cfg):
        size = 1
        for d in shape:
            size *= d
        n += size
    return n


def make(cfg: dict, seed: int, device) -> dict:
    """The f32 parameter tree on `device`, drawn from `seed`."""
    specs = leaves(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    flat = torch.empty(numel(cfg), dtype=torch.float32, device=device)
    flat.normal_(generator=gen)
    tree: dict = {}
    at = 0
    for path, shape, (scale, offset) in specs:
        size = 1
        for d in shape:
            size *= d
        leaf = flat[at: at + size].view(shape)
        leaf.mul_(scale).add_(offset)
        at += size
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    conv_layers = tree["feature_extractor"]["conv_layers"]
    tree["feature_extractor"]["conv_layers"] = [conv_layers[i] for i in sorted(conv_layers)]
    return tree
