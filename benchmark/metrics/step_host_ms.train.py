"""Host milliseconds per whole-net train step: the mean length of the
program's ``train.step`` spans (``coolchic_tpu_torch/utils/trace.py``), the
host's enqueue of the step, over the window's chunks that ran without the
profiler. Nothing where the program records no such spans."""


def read(run):
    try:
        from coolchic_tpu_torch.utils import trace
    except ImportError:
        return None
    chunks = [s for s in trace.spans("train") if s.attrs.get("n_samples") == run.cell.traffic["chunk_samples"]]
    roots = [s for s in chunks[-run.counters["attempted"]:] if not s.under_profiler]
    steps = [c.ns for r in roots for c in trace.children(r) if c.name == "train.step"]
    return 1e-6 * sum(steps) / len(steps) if steps else None
