"""Device milliseconds per train step: the summed time of every GPU event in
the chunk traced under the device's activity alone, over its steps
(validation included, one per chunk)."""


def read(run):
    t, c = run.trace, run.counters
    if t is None or t.n_gpu_events == 0 or not c.get("traced_steps"):
        return None
    return 1e3 * t.device_s() / c["traced_steps"]
