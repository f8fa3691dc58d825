"""Evaluation analyses of the port. Counterpart of ``coolchic_tpu/eval/``:
BD-rate against the anchors of ``results/``, ``iterations_to_match`` of a
hypernet, and (imported on its own, it needs matplotlib) ``plotting``."""

from coolchic_tpu_torch.eval.bd_rate import (
    avg_bd_rate_vs_anchor,
    bd_psnr,
    bd_rate,
    bd_rate_vs_anchor,
    parse_result_summary,
    write_results_tsv,
)
from coolchic_tpu_torch.eval.hypernet import iterations_to_match

__all__ = [
    "avg_bd_rate_vs_anchor",
    "bd_psnr",
    "bd_rate",
    "bd_rate_vs_anchor",
    "iterations_to_match",
    "parse_result_summary",
    "write_results_tsv",
]
