"""k1_roofline.batch: K1's bound, from the real rows of the window's batches that select
it, over K1's device time in the trace."""

from portbench import readers


def read(run):
    return readers.share(readers.dp_bound_batches(run, "k1"),
                         run.trace.device_seconds(readers.KERNELS["k1"]))
