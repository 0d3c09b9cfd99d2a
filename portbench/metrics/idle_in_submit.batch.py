"""idle_in_submit.batch: Time with nothing on the device while the host was inside the
port's `batching.prepare` or `batching.enqueue` span, over the traced window."""

from portbench import program_spans


def read(run):
    idle = program_spans.idle_by_span(run)
    if idle is None or not {"batching.prepare", "batching.enqueue"} & set(idle):
        return None
    seconds = idle.get("batching.prepare", 0.0) + idle.get("batching.enqueue", 0.0)
    return 100.0 * seconds / run.trace.window_s
