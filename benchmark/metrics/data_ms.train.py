"""Host milliseconds per train step spent in ``next()`` of the benchmark's
batch iterator (host numpy), over the chunks that ran without the profiler."""


def read(run):
    c = run.counters
    if not c.get("untraced_steps"):
        return None
    return 1e3 * c["untraced_data_s"] / c["untraced_steps"]
