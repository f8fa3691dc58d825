"""PyTorch / CUDA port of coolchic_tpu (Cool-chic overfitted image codec).

The package mirrors the JAX package's layout (``models/``, ``ops/``,
``train/``, ``io/``, ``utils/``, ``encode.py``) and keeps its parameter
layout: a frame's parameters are a dict of tensors

    {"latents": [[C_i, H_i, W_i], ...],
     "arm": {"layers": [{"weight", "bias"}, ...]},
     "upsampling": {"ups": [...], "preconcat": [...]},
     "synthesis": {"layers": [{"weight", "bias"}, ...]}}

Every eval-mode ARM rate on a CUDA tensor runs through the hand-written
kernel of ``ops/arm_rate.py`` (``csrc/arm_rate.cu``). Importing this
package imports neither JAX nor the JAX package.
"""
