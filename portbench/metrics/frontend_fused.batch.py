"""frontend_fused.batch: Elements that the port's fused norm + GELU kernel K6 (`ops.norm_gelu`)
wrote inside the conv frontend over all the frontend's conv outputs' elements: the counts
`elems_fused` (added at each K6 launch) and `elems` of the `forward.frontend` spans in the
traced window. None for a program whose spans carry no such counts."""

from portbench import program_spans


def read(run):
    found = program_spans.window_spans(run, "forward.frontend") or ()
    total = sum(s.counts.get("elems", 0) for s in found)
    if total <= 0:
        return None
    return 100.0 * sum(s.counts.get("elems_fused", 0) for s in found) / total
