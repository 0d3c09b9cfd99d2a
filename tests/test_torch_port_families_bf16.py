"""PyTorch port vs the JAX package: the wav2vec2-encoder families at bf16.

The families, weights and audio of tests/test_torch_port_families.py. Each
family's bf16 forward against its f32 forward passes bench.py's log-prob
gate (mean |Δ| ≤ 0.05, p99 ≤ 0.3 over the valid frames), bf16 weight
storage is exact under bf16 compute, and the port's bf16 cast stores in
f32 exactly the leaves the JAX cast (`wav2vec2_tpu.models.quantize.
cast_compute_weights_bf16`) keeps in f32, on these trees and on those of
SEW, SEW-D and w2v-BERT.
"""

import numpy as np
import pytest
import torch
import jax

from wav2vec2_tpu.config import Wav2Vec2ModelConfig as JaxCfg
from wav2vec2_tpu.models.params import init_params as jax_init_params
from wav2vec2_tpu.models.quantize import cast_compute_weights_bf16 as jax_cast_bf16
from wav2vec2_tpu_torch.models import ctc_model as torch_ctc
from wav2vec2_tpu_torch.models import params as torch_params

from test_torch_port_families import FAMILIES, SMALL, batch, models, torch_lp
from test_torch_port_sew import SEW_FAMILIES
from test_torch_port_w2v_bert import BERT_FAMILIES

# trees that hold the f32 leaves SEW, SEW-D and w2v-BERT bring: SEW-D's
# `output_norm`, `rel_embeddings` and `rel_embeddings_layer_norm`, w2v-BERT's
# `depthwise_layer_norm`, the BERT adapter's `residual_layer_norm`,
# `ffn_layer_norm` and `proj_layer_norm`
NEW_TREES = {"sew": {**SMALL, **SEW_FAMILIES["sew"]}, "sew-d": {**SMALL, **SEW_FAMILIES["sew-d"]},
             "w2v-bert": {**BERT_FAMILIES["w2v-bert"], "output_hidden_size": 48}}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_within_gate_of_f32_and_bf16_storage_is_exact(family):
    _, tcfg, _, tp = models(family)
    audio, lens = batch(2)
    ref = torch_lp(tp, tcfg, audio, lens)
    lp = torch_lp(tp, tcfg, audio, lens, dtype=torch.bfloat16)
    valid = torch_ctc.frame_lengths(tcfg, torch.from_numpy(lens)).numpy()
    d = np.concatenate([np.abs(lp[i, :t].astype(np.float64) - ref[i, :t]).ravel()
                        for i, t in enumerate(valid)])
    assert d.mean() <= 0.05 and np.percentile(d, 99) <= 0.3, (d.mean(), np.percentile(d, 99))
    cast = torch_params.cast_compute_weights_bf16(tp)
    np.testing.assert_array_equal(torch_lp(cast, tcfg, audio, lens, dtype=torch.bfloat16), lp)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.asarray(tree))


def _leaf_dtypes(tree, path=()):
    if isinstance(tree, (dict, list)):
        out = {}
        for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
            out.update(_leaf_dtypes(v, path + (k,)))
        return out
    return {path: str(tree.dtype).replace("torch.", "")}


@pytest.mark.parametrize("family", [*sorted(FAMILIES), "mms+wavlm", *sorted(NEW_TREES)])
def test_bf16_cast_keeps_the_jax_casts_f32_leaves(family):
    """Leaf by leaf, the port's cast stores in f32 exactly what the JAX
    cast does. "mms+wavlm" holds every kept subtree of the encoder
    families at once: the MMS adapter's `norm`, the conv adapter's
    `proj_layer_norm`, the pos-conv `batch_norm`, WavLM's `rel_attn_embed`
    and `gru_rel_pos_const`; the SEW, SEW-D and w2v-BERT trees hold the
    rest (`NEW_TREES`)."""
    if family == "mms+wavlm":
        d = {**SMALL, **FAMILIES["wavlm-pre-norm"], "adapter_attn_dim": 8,
             "add_adapter": True, "output_hidden_size": 48, "conv_pos_batch_norm": True}
    elif family in NEW_TREES:
        d = NEW_TREES[family]
    else:
        d = {**SMALL, **FAMILIES[family]}
    tree = jax.tree.map(np.asarray, jax_init_params(JaxCfg.from_dict(d), jax.random.PRNGKey(0)))
    want = _leaf_dtypes(jax_cast_bf16(tree))
    got = _leaf_dtypes(torch_params.cast_compute_weights_bf16(_torch_tree(tree)))
    assert got == want
    assert "float32" in got.values() and "bfloat16" in got.values()
