"""Bjontegaard metrics and BD-rate comparisons against published anchors.

Counterpart of ``coolchic_tpu/eval/bd_rate.py`` (numpy; scipy for the
piecewise variant): the Bjontegaard delta (a cubic fit of the RD curve in
log-rate, integrated over the overlapping quality range, VCEG-M33). The
anchors are the result TSVs under the repo's ``results/image/<dataset>/``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from coolchic_tpu_torch.utils.paths import RESULTS_DIR


def _poly_integral_mean(x, y, lo, hi):
    p = np.polyfit(x, y, 3)
    pint = np.polyint(p)
    return (np.polyval(pint, hi) - np.polyval(pint, lo)) / (hi - lo)


def bd_rate(
    rate_anchor: Sequence[float],
    psnr_anchor: Sequence[float],
    rate_test: Sequence[float],
    psnr_test: Sequence[float],
    piecewise: bool = False,
) -> float:
    """Average rate difference (%) of test vs anchor at equal quality.
    Negative = test is better."""
    l_r1 = np.log(np.asarray(rate_anchor, float))
    l_r2 = np.log(np.asarray(rate_test, float))
    p1 = np.asarray(psnr_anchor, float)
    p2 = np.asarray(psnr_test, float)

    lo = max(p1.min(), p2.min())
    hi = min(p1.max(), p2.max())

    if piecewise:
        import scipy.interpolate

        samples, interval = np.linspace(lo, hi, num=100, retstep=True)
        v1 = scipy.interpolate.pchip_interpolate(np.sort(p1), l_r1[np.argsort(p1)], samples)
        v2 = scipy.interpolate.pchip_interpolate(np.sort(p2), l_r2[np.argsort(p2)], samples)
        int1 = np.trapezoid(v1, dx=float(interval))
        int2 = np.trapezoid(v2, dx=float(interval))
        avg_exp_diff = (int2 - int1) / (hi - lo)
    else:
        avg_exp_diff = _poly_integral_mean(p2, l_r2, lo, hi) - _poly_integral_mean(
            p1, l_r1, lo, hi
        )
    return float((np.exp(avg_exp_diff) - 1.0) * 100.0)


def bd_psnr(
    rate_anchor: Sequence[float],
    psnr_anchor: Sequence[float],
    rate_test: Sequence[float],
    psnr_test: Sequence[float],
) -> float:
    """Average PSNR difference (dB) of test vs anchor at equal rate.
    Positive = test is better."""
    l_r1 = np.log(np.asarray(rate_anchor, float))
    l_r2 = np.log(np.asarray(rate_test, float))
    p1 = np.asarray(psnr_anchor, float)
    p2 = np.asarray(psnr_test, float)
    lo = max(l_r1.min(), l_r2.min())
    hi = min(l_r1.max(), l_r2.max())
    return float(
        _poly_integral_mean(l_r2, p2, lo, hi) - _poly_integral_mean(l_r1, p1, lo, hi)
    )


# --------------------------------------------------------------------------- #
# Result-summary parsing (schema of results/image/*/results.tsv)
# --------------------------------------------------------------------------- #
def parse_result_summary(path: Path) -> Dict[str, List[dict]]:
    """Parse a results TSV into {seq_name: [row dicts sorted by lmbda]}
    (reference: eval/results.py:84-100). Rows carry at least seq_name,
    lmbda (when present), rate_bpp, psnr_db."""
    rows_by_seq: Dict[str, List[dict]] = {}
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        for line in f:
            if not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            row = dict(zip(header, parts))
            for k, v in row.items():
                if k != "seq_name":
                    try:
                        row[k] = float(v)
                    except ValueError:
                        pass
            rows_by_seq.setdefault(row["seq_name"], []).append(row)
    for seq in rows_by_seq:
        key = "lmbda" if "lmbda" in rows_by_seq[seq][0] else "rate_bpp"
        rows_by_seq[seq].sort(key=lambda r: r.get(key, 0.0))
    return rows_by_seq


DATASETS = ("kodak", "clic20-pro-valid", "jvet")


def anchor_path(dataset: str, anchor: str) -> Path:
    return RESULTS_DIR / "image" / dataset / f"{anchor}.tsv"


def bd_rate_vs_anchor(
    summary: Dict[str, List[dict]],
    dataset: str,
    anchor: str = "results",
    rate_key: str = "rate_bpp",
) -> Dict[str, float]:
    """Per-sequence BD-rate of ``summary`` against a stored anchor TSV (the
    anchor is the reference curve; negative = summary is better)."""
    anch = parse_result_summary(anchor_path(dataset, anchor))
    out: Dict[str, float] = {}
    for seq, rows in summary.items():
        if seq not in anch:
            continue
        a = anch[seq]
        out[seq] = bd_rate(
            [r["rate_bpp"] for r in a],
            [r["psnr_db"] for r in a],
            [r[rate_key] for r in rows],
            [r["psnr_db"] for r in rows],
        )
    return out


def avg_bd_rate_vs_anchor(summary, dataset, anchor="results") -> float:
    per_seq = bd_rate_vs_anchor(summary, dataset, anchor)
    return float(np.mean(list(per_seq.values()))) if per_seq else float("nan")


def write_results_tsv(rows: List[dict], path: Path) -> None:
    """Write rows in the reference results.tsv schema."""
    keys = list(rows[0].keys())
    with open(path, "w") as f:
        f.write("\t".join(keys) + "\n")
        for row in rows:
            f.write("\t".join(str(row[k]) for k in keys) + "\n")
