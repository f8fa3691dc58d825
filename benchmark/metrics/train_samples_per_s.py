"""Samples trained over the host-clock seconds of every chunk of the window:
data, copies, steps and validations."""


def read(run):
    c = run.counters
    return c["samples"] / c["window_s"]
