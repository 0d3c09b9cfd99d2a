"""copy_wait_ms.batch: Mean host milliseconds of the port's `batching.copy_wait` span in
the traced window: the drain's wait for one batch's host copies."""

from portbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "batching.copy_wait")
