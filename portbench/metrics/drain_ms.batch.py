"""drain_ms.batch: Host milliseconds per drained batch inside `group_batch`: the wait for
the batch's host copies and the word grouping."""

def read(run):
    d = run.recorder.drain_s
    return 1e3 * sum(d) / len(d) if d else None
