"""PyTorch / CUDA port of coolchic_tpu (Cool-chic overfitted image codec).

The package mirrors the JAX package's layout (``models/``, ``ops/``,
``train/``, ``bitstream/``, ``io/``, ``utils/``, ``encode.py``,
``decode.py``) and keeps its parameter layout: a frame's parameters are a dict of tensors

    {"latents": [[C_i, H_i, W_i], ...],
     "arm": {"layers": [{"weight", "bias"}, ...]},
     "upsampling": {"ups": [...], "preconcat": [...]},
     "synthesis": {"layers": [{"weight", "bias"}, ...]}}

Every eval-mode ARM rate on a CUDA tensor runs through the hand-written
kernel of ``ops/arm_rate.py`` (``csrc/arm_rate.cu``). The ``.cool``
bitstream (``bitstream/``) is written and integer-decoded by host code
through the C++ backend of the repo's ``cpp/``; its float decode runs on the
GPU. Importing this package imports neither JAX nor the JAX package.
"""
