"""wav2vec2_tpu_torch — the PyTorch/CUDA port of `wav2vec2_tpu`.

CTC forced alignment (16 kHz mono audio + transcript → per-word
[start_ms, end_ms) boundaries with composite confidence) on an NVIDIA GPU.
The module layout and function names mirror the JAX package, which stays
the reference. The port imports torch and numpy only: never jax, the JAX
package, safetensors or transformers.

Ported so far: the wav2vec2-base CTC graph and the wav2vec2-conformer one
(layer-norm frontend; relative, rotary or no position embeddings) through
the single-utterance entry (`ForcedAlignerBuilder`), the padded-batch entry
(`BatchAligner`) and the long-form entry (`align_longform`), with every
kernel of the JAX package written in CUDA: the banded CTC Viterbi K1
(`csrc/viterbi.cu`), its blocked tiers K2, K3, K4
(`csrc/viterbi_blocked.cu`), and the fused Transformer-XL attention K5
(`csrc/flash_attention.cu`), which `BatchAligner` runs for the conformer
rel-pos family. Over them: `BatchAligner.align_stream`, word and phoneme
units, the native grouping engine, and the `alignment_report` CLI
(`python -m wav2vec2_tpu_torch.cli.alignment_report`) with its data
readers (FLAC, WAV, the LibriSpeech layout) and reports (JSON, perf
JSONL, TextGrid, SRT/VTT). Online alignment (`OnlineAligner`, loaded
lazily), the serving daemon (`python -m wav2vec2_tpu_torch.serve`), int8
serving (`BatchAligner(quantize_int8=True)`) and the environment check
(`python -m wav2vec2_tpu_torch.doctor`). The ONNX runtime (`onnx/`,
`pipeline/onnx_runtime.py`: the exported graph run as torch operations on
the card, the CLI's `--runtime onnx`) and CTC training on one device
(`parallel/train.py`, `utils/checkpoint.save_params` / `restore_params`).
"""

from .align.longform import align_longform

from .config import (
    AlignerHyperParams,
    ExpansionPolicyConfig,
    Wav2Vec2Config,
    Wav2Vec2ModelConfig,
    load_vocab,
)
from .errors import (
    AlignmentError,
    InvalidInputError,
    IoError,
    JsonError,
    RuntimeBackendError,
)
from .pipeline.builder import ForcedAlignerBuilder
from .pipeline.runtime import (
    AlignmentStageTimings,
    ForcedAligner,
    ProfiledAlignmentOutput,
    normalize_audio,
)
from .pipeline.traits import ForwardOutput
from .parallel.batching import BatchAligner
from .types import (
    AlignmentInput,
    AlignmentOutput,
    TokenSequence,
    WordConfidenceStats,
    WordTiming,
)


def __getattr__(name):
    # the online aligner loads lazily, as in the JAX package
    if name == "OnlineAligner":
        from .align.online import OnlineAligner

        return OnlineAligner
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AlignerHyperParams",
    "AlignmentError",
    "AlignmentInput",
    "AlignmentOutput",
    "AlignmentStageTimings",
    "BatchAligner",
    "ExpansionPolicyConfig",
    "ForcedAligner",
    "ForcedAlignerBuilder",
    "ForwardOutput",
    "InvalidInputError",
    "IoError",
    "JsonError",
    "OnlineAligner",
    "ProfiledAlignmentOutput",
    "RuntimeBackendError",
    "TokenSequence",
    "Wav2Vec2Config",
    "Wav2Vec2ModelConfig",
    "WordConfidenceStats",
    "WordTiming",
    "align_longform",
    "load_vocab",
    "normalize_audio",
]

__version__ = "0.1.0"
