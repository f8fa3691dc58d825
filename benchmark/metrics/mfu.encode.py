"""Share of the card's TF32 peak that the overfitting steps reach: the model
FLOPs of the image steps (3 forwards of the configuration's count per image
step) over the host-clock seconds of the window's chunks that ran without the
profiler, in %. Nothing without such a chunk, or off a card with a known peak."""


def read(run):
    c = run.counters
    peak = run.peaks.get("tf32_flops")
    if not peak or not c.get("untraced_s"):
        return None
    flops = run.counts.train_step_flops(run.cell.config, c["height"], c["width"])
    return 100.0 * flops * c["untraced_image_steps"] / c["untraced_s"] / peak
