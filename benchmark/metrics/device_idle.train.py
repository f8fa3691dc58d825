"""Share of the traced chunk in which no operation ran on the device, in %
(the profiler's timeline: one minus the union of its GPU events over the
chunk's host-clock length)."""


def read(run):
    t = run.trace
    if t is None or t.n_gpu_events == 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
