"""Host milliseconds per validation of the phase engine from the end of its
device-to-host copy (the program's ``phase.wait`` span, which empties the
stream) to the start of the next ``phase.step`` (or the end of the chunk's
``phase`` span): the record bookkeeping and the schedules, in which the
device runs nothing but the bookkeeping's copies. Over the window's chunks
that ran without the profiler (``coolchic_tpu_torch/utils/trace.py``);
nothing where the program records no such spans."""


def read(run):
    try:
        from coolchic_tpu_torch.utils import trace
    except ImportError:
        return None
    chunks = [s for s in trace.spans("phase") if s.attrs.get("max_itr") == run.cell.traffic["chunk_itr"]]
    roots = [s for s in chunks[-run.counters["chunks"]:] if not s.under_profiler]
    waits = {w.parent: w for w in trace.spans("phase.wait")}  # one per validation
    gaps = []
    for root in roots:
        kids = trace.children(root)
        for i, validation in enumerate(kids):
            if validation.name != "phase.validate" or validation.id not in waits:
                continue
            refilled = next((k.start_ns for k in kids[i + 1:] if k.name == "phase.step"), root.end_ns)
            gaps.append(refilled - waits[validation.id].end_ns)
    return 1e-6 * sum(gaps) / len(gaps) if gaps else None
