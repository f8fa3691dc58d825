"""Host milliseconds per train step in the batch's copy to the device: the
mean length of the program's ``train.h2d`` spans
(``coolchic_tpu_torch/utils/trace.py``). The copy is from pageable memory,
so it includes the wait for the steps enqueued before it. Over the window's
chunks that ran without the profiler; nothing where the program records no
such spans."""


def read(run):
    try:
        from coolchic_tpu_torch.utils import trace
    except ImportError:
        return None
    chunks = [s for s in trace.spans("train") if s.attrs.get("n_samples") == run.cell.traffic["chunk_samples"]]
    roots = [s for s in chunks[-run.counters["attempted"]:] if not s.under_profiler]
    copies = [c.ns for r in roots for c in trace.children(r) if c.name == "train.h2d"]
    return 1e-6 * sum(copies) / len(copies) if copies else None
