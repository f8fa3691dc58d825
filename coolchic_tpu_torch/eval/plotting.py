"""RD plotting helpers. Counterpart of ``coolchic_tpu/eval/plotting.py``.

Matplotlib figures over the result-row dicts of
``eval/bd_rate.py::parse_result_summary`` (seq_name, lmbda, rate_bpp,
psnr_db, ...). Figures are returned, not shown. matplotlib is imported
inside the functions, with the headless Agg back end: importing this module
needs no matplotlib, and nothing of the encode or training paths imports it.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def gen_rd_plot(
    runs: Dict[str, List[dict]],
    seq_name: Optional[str] = None,
    title: Optional[str] = None,
):
    """One rate-distortion figure; ``runs`` maps a label (e.g. "reference",
    "ours") to result rows. Rows are filtered to ``seq_name`` when given,
    otherwise averaged per lambda across sequences
    (reference: plotting.py:12-27 gen_rd_plots)."""
    fig, ax = _pyplot().subplots(figsize=(6, 4.5))
    for label, rows in runs.items():
        if seq_name is not None:
            rows = [r for r in rows if r["seq_name"] == seq_name]
            pts = sorted(
                ((r["rate_bpp"], r["psnr_db"]) for r in rows), key=lambda p: p[0]
            )
        else:
            by_lmbda: Dict[float, List[dict]] = {}
            for r in rows:
                by_lmbda.setdefault(float(r.get("lmbda", 0.0)), []).append(r)
            pts = sorted(
                (
                    (
                        sum(x["rate_bpp"] for x in g) / len(g),
                        sum(x["psnr_db"] for x in g) / len(g),
                    )
                    for g in by_lmbda.values()
                ),
                key=lambda p: p[0],
            )
        if pts:
            ax.plot(*zip(*pts), marker="o", label=label)
    ax.set_xlabel("rate [bpp]")
    ax.set_ylabel("PSNR [dB]")
    ax.grid(True, alpha=0.3)
    ax.legend()
    ax.set_title(title or (seq_name or "dataset average"))
    fig.tight_layout()
    return fig


def print_md_table(results: Dict[str, float], value_name: str = "bd rate") -> str:
    """Markdown table of per-sequence values
    (reference: plotting.py:30-36)."""
    out = f"| seq_name | {value_name} |\n| :------- | ------: |\n"
    for seq, value in sorted(results.items()):
        out += f"| {seq} | {value:.2f} |\n"
    print(out)
    return out


def plot_bd_rate_vs_iterations(
    points: List[dict],
    anchor_name: Optional[str] = None,
    bd_vs_cc: Optional[float] = None,
):
    """BD-rate as a function of the per-loop iteration budget; ``points``
    rows need keys n_itr, avg_bd_rate, n_train_loops
    (reference: plotting.py:39-60 plot_bd_rate_n_itr)."""
    fig, ax = _pyplot().subplots(figsize=(6, 4.5))
    by_loops: Dict[int, List[dict]] = {}
    for p in points:
        by_loops.setdefault(int(p.get("n_train_loops", 1)), []).append(p)
    for loops, rows in sorted(by_loops.items()):
        rows = sorted(rows, key=lambda r: r["n_itr"])
        ax.plot(
            [r["n_itr"] for r in rows],
            [r["avg_bd_rate"] for r in rows],
            marker="o",
            label=f"{loops} loop(s)",
        )
    if bd_vs_cc is not None:
        ax.axhline(y=bd_vs_cc, color="red", linestyle="--", linewidth=2)
    if all(p["avg_bd_rate"] >= 0 for p in points):
        ax.set_ylim(0, None)
    ax.set_xlabel("iterations per loop")
    ax.set_ylabel("avg BD-rate [%]")
    ax.grid(True, alpha=0.3)
    ax.legend()
    ax.set_title(f"BD-rate vs iteration budget (anchor={anchor_name})")
    fig.tight_layout()
    return fig


def plot_rd_curves(summaries, seq_name, out_path=None):
    """Plot rate/PSNR curves of several codecs for one sequence.

    Args:
        summaries: {codec_name: parse_result_summary(...) output}.
    """
    fig, ax = _pyplot().subplots(figsize=(7, 5))
    for name, summary in summaries.items():
        if seq_name not in summary:
            continue
        rows = sorted(summary[seq_name], key=lambda r: r["rate_bpp"])
        ax.plot(
            [r["rate_bpp"] for r in rows],
            [r["psnr_db"] for r in rows],
            marker="o",
            label=name,
        )
    ax.set_xlabel("rate [bpp]")
    ax.set_ylabel("PSNR [dB]")
    ax.set_title(seq_name)
    ax.grid(True, alpha=0.3)
    ax.legend()
    if out_path is not None:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        _pyplot().close(fig)
    return fig


def plot_dataset_rd(dataset, anchors, seq_name, out_path=None):
    """Convenience: plot one sequence's published anchor curves."""
    from coolchic_tpu_torch.eval.bd_rate import anchor_path, parse_result_summary

    summaries = {a: parse_result_summary(anchor_path(dataset, a)) for a in anchors}
    return plot_rd_curves(summaries, seq_name, out_path)
