"""norm_on_card.batch: Real samples that the port's audio normalization kernel K7
(`ops.normalize`) normalized on the card over all the real samples submitted: the counts
`samples_card` and `samples_real` of the port's `batching.prepare` spans in the traced
window. None for a program whose spans carry no such counts."""

from portbench import program_spans


def read(run):
    found = program_spans.window_spans(run, "batching.prepare") or ()
    real = sum(s.counts.get("samples_real", 0) for s in found)
    if real <= 0:
        return None
    return 100.0 * sum(s.counts.get("samples_card", 0) for s in found) / real
