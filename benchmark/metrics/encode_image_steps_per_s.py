"""Optimizer steps summed over the images (``BatchPhaseLogs.n_train_steps``)
over the host-clock seconds of every chunk of the window, validations
included."""


def read(run):
    c = run.counters
    return c["image_steps"] / c["window_s"]
