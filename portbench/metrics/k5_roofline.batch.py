"""k5_roofline.batch: K5's bound (the real rows at their real lengths; one launch a layer a
batch) summed over the window's batches, over K5's device time in the trace. The rows that
fill a batch to its pow2 size repeat the last one: padding, not counted."""

from portbench import readers


def read(run):
    from portbench import roofline
    from portbench.reference.forward import frames

    cfg = run.ctx.cfg
    nh = cfg["num_attention_heads"]
    hd = cfg["hidden_size"] // nh
    elem = 2 if run.ctx.dtype == "bfloat16" else 4
    bound = 0.0
    for b in run.recorder.batches:
        bound += cfg["num_hidden_layers"] * roofline.flash_bound_s(
            [frames(n, cfg) for n in b["audio_lens"]], nh, hd, elem,
            roofline.peak_ops(run.ctx.dtype))
    return readers.share(bound, run.trace.device_seconds(readers.KERNELS["k5"]))
