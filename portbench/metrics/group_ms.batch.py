"""group_ms.batch: Mean host milliseconds of the port's `batching.group` span in the
traced window: the word grouping of one batch's rows."""

from portbench import program_spans


def read(run):
    return program_spans.mean_ms(run, "batching.group")
