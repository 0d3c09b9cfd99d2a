"""prepare_ms.batch: Mean host milliseconds of the port's `batching.prepare` span in the
traced window: one batch's host normalization, padding and fill rows before its launch."""

from portbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "batching.prepare")
