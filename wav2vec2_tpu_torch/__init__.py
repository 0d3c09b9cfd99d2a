"""wav2vec2_tpu_torch — the PyTorch/CUDA port of `wav2vec2_tpu`.

CTC forced alignment (16 kHz mono audio + transcript → per-word
[start_ms, end_ms) boundaries with composite confidence) on an NVIDIA GPU.
The module layout and function names mirror the JAX package, which stays
the reference. The port imports torch and numpy only: never jax, the JAX
package, safetensors or transformers.

First slice: the wav2vec2-base CTC graph through the single-utterance
entry (`ForcedAlignerBuilder`) and the padded-batch entry
(`BatchAligner`), with the banded CTC Viterbi kernel (K1) written in CUDA
(`csrc/viterbi.cu`).
"""

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
    "ProfiledAlignmentOutput",
    "RuntimeBackendError",
    "TokenSequence",
    "Wav2Vec2Config",
    "Wav2Vec2ModelConfig",
    "WordConfidenceStats",
    "WordTiming",
    "load_vocab",
    "normalize_audio",
]

__version__ = "0.1.0"
