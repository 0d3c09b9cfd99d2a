"""One module an encoder style, found by the config's `model_type`
(`wav2vec2-conformer` → `wav2vec2_conformer.py`). Each defines:

- `encoder(enc, x, cfg, quant)`: the plain f32 encoder over one
  utterance's projected features [T, H] (`quant` as in `forward.py`);
- `encoder_leaves(cfg)`: the leaves of its weight tree under `encoder`,
  (path, shape, (scale, offset)), in the port's layout and with the scales
  of its `init_params` (the value is offset + scale · N(0, 1));
- `encoder_flops(cfg, t)`: its FLOPs at T frames (an FMA is two; norms,
  activations and softmax left out).

A later encoder style is a new file here. The helpers below build leaves.
"""

from __future__ import annotations

import importlib


def load(model_type: str):
    return importlib.import_module(f"{__name__}.{model_type.replace('-', '_')}")


def dense(n_in, n_out, bias=True):
    leaves = [("kernel", (n_in, n_out), ((2.0 / (n_in + n_out)) ** 0.5, 0.0))]
    if bias:
        leaves.append(("bias", (n_out,), (0.2, 0.0)))
    return leaves


def norm(n):
    return [("weight", (n,), (0.2, 1.0)), ("bias", (n,), (0.2, 0.0))]


def under(prefix, leaves):
    head = prefix if isinstance(prefix, tuple) else (prefix,)
    return [(head + (path if isinstance(path, tuple) else (path,)), shape, init)
            for path, shape, init in leaves]


def ffn(h, inner):
    return under("intermediate_dense", dense(h, inner)) + under("output_dense", dense(inner, h))


def stacked(n_layers, leaves):
    """A layer's leaves stacked on a leading axis under `layers`."""
    return [(("layers",) + path, (n_layers,) + shape, init) for path, shape, init in leaves]
