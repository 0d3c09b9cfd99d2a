"""Self-contained ONNX subsystem: protobuf codec, CTC-graph exporter, and
an embedded session with onnxruntime's surface that runs the graph as
torch operations on the card (counterpart of `wav2vec2_tpu.onnx`).

Gives the second model runtime (`pipeline/onnx_runtime.py`) an execution
path on every machine: exported files run under stock onnxruntime where it
is installed, and under `EmbeddedOnnxSession` on the asked torch device
everywhere else."""

from .export import export_ctc_model
from .proto import Model, load_model, save_model
from .reference_runtime import EmbeddedOnnxSession

__all__ = [
    "EmbeddedOnnxSession",
    "Model",
    "export_ctc_model",
    "load_model",
    "save_model",
]
