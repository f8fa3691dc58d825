"""Share of the whole-net train steps that ran as a CUDA graph's replay, in
%: the ``graph_replays`` over the ``graph_replays`` plus ``eager_steps``
that the program's ``train`` spans (``coolchic_tpu_torch/utils/trace.py``)
carry, summed over the window's chunks that ran without the profiler.
Nothing where the program's spans carry no such counts."""


def read(run):
    try:
        from coolchic_tpu_torch.utils import trace
    except ImportError:
        return None
    chunks = [s for s in trace.spans("train") if s.attrs.get("n_samples") == run.cell.traffic["chunk_samples"]]
    roots = [s for s in chunks[-run.counters["attempted"]:] if not s.under_profiler]
    replays = sum(r.attrs.get("graph_replays", 0) for r in roots)
    steps = replays + sum(r.attrs.get("eager_steps", 0) for r in roots)
    if not steps or not all("graph_replays" in r.attrs for r in roots):
        return None
    return 100.0 * replays / steps
