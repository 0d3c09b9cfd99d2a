"""fill_share.batch: Samples of the rows that fill a batch to its pow2 size (repeats of
its last row) over all samples submitted, from the counts of the port's
`batching.prepare` spans in the traced window: the part of `pad_share.batch` that is fill
rows, not bucket padding."""

from portbench import program_spans


def read(run):
    found = program_spans.window_spans(run, "batching.prepare")
    if not found:
        return None
    fill = sum(s.counts["samples_fill"] for s in found)
    total = sum(s.counts["samples_total"] for s in found)
    return 100.0 * fill / total if total else None
