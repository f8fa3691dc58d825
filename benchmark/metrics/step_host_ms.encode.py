"""Host milliseconds per batched overfitting step: the mean length of the
program's ``phase.step`` spans (``coolchic_tpu_torch/utils/trace.py``), the
host's enqueue of one ``train_step`` with any wait for room in the launch
queue, over the window's chunks that ran without the profiler. Nothing where
the program records no such spans."""


def read(run):
    try:
        from coolchic_tpu_torch.utils import trace
    except ImportError:
        return None
    chunks = [s for s in trace.spans("phase") if s.attrs.get("max_itr") == run.cell.traffic["chunk_itr"]]
    roots = [s for s in chunks[-run.counters["chunks"]:] if not s.under_profiler]
    steps = [c.ns for r in roots for c in trace.children(r) if c.name == "phase.step"]
    return 1e-6 * sum(steps) / len(steps) if steps else None
