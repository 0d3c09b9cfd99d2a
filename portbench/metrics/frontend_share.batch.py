"""frontend_share.batch: Device seconds of the port's `forward.frontend` spans (CUDA
events around the conv or mel frontend through the feature projection) over the traced
window's busy seconds."""

from portbench import program_spans


def read(run):
    found = program_spans.window_spans(run, "forward.frontend")
    timed = [s.device_s for s in found or () if s.device_s is not None]
    if not timed or run.trace.busy_s <= 0:
        return None
    return 100.0 * sum(timed) / run.trace.busy_s
