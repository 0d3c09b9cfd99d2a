"""mfu.batch: Forward FLOPs of the real rows the traced window submitted (from the
config and each row's real length) over the window × the bf16 peak."""

from portbench import readers


def read(run):
    if not run.recorder.batches:
        return None
    return readers.mfu(run, readers.batch_flops(run))
