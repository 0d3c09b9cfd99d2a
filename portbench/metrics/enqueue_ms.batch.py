"""enqueue_ms.batch: Mean host milliseconds of the port's `batching.enqueue` span in the
traced window: one batch's host-to-device copy and the launch of its forward, log-softmax,
DP, evidence and host copies (what a CUDA graph would take off the host)."""

from portbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "batching.enqueue")
