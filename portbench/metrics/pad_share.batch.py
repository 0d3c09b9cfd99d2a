"""pad_share.batch: Padded audio samples over all samples submitted in the window: the
pow2 audio buckets and the rows that fill a batch to its pow2 size."""

def read(run):
    batches = run.recorder.batches
    if not batches:
        return None
    real = sum(sum(b["audio_lens"]) for b in batches)
    total = sum(b["rows"] * b["n_pad"] for b in batches)
    return 100.0 * (total - real) / total
