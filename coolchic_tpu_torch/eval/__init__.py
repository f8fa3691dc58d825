"""Evaluation analyses of the port. Counterpart of ``coolchic_tpu/eval/``
(its ``hypernet`` module so far)."""

from coolchic_tpu_torch.eval.hypernet import iterations_to_match

__all__ = ["iterations_to_match"]
