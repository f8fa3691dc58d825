"""Share of the card's TF32 peak that the whole-net training reaches: the
configuration's model FLOPs per trained sample (3 forwards of the latent
encoder, the resnet18, the heads and the decoder) times the samples of the
chunks that ran without the profiler, over their host-clock seconds, in %."""


def read(run):
    c = run.counters
    peak = run.peaks.get("tf32_flops")
    if not peak or not c.get("untraced_s"):
        return None
    flops = run.counts.train_sample_flops(run.cell.config)
    return 100.0 * flops * c["untraced_samples"] / c["untraced_s"] / peak
