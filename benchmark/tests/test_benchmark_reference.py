"""The plain reference against the port on the CPU at small sizes, and the
control on the card: the reference computed with TF32 in the program's place
comes out not correct.

    python -m pytest benchmark/tests -q                 # CPU
    python -m pytest benchmark/tests -q -m cuda         # the card's tests
"""

from __future__ import annotations

import pytest
import torch

from benchmark.harness.core import BENCH_DIR, read_json
from benchmark.harness.program import decoder_config
from benchmark.reference import coolchic as cc
from benchmark.tests.conftest import tiny_cell

SEED = 2 ** 31 + 77


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_decoder_forward_matches_the_port(training):
    from coolchic_tpu_torch.models.coolchic import frame_forward
    from coolchic_tpu_torch.params import tree_map

    config = read_json(BENCH_DIR / "configs" / "coolchic-c3x.json")
    g = torch.Generator().manual_seed(3)
    params = cc.init_params(g, config, 40, 56, 2, "cpu")
    params["latents"] = [0.2 * torch.randn(y.shape, generator=g) for y in params["latents"]]
    params["synthesis"] = tree_map(lambda t: t + 0.05 * torch.randn(t.shape, generator=g), params["synthesis"])
    noise = [torch.randn(y.shape, generator=g) for y in params["latents"]]
    cfg = decoder_config(config, 40, 56)
    decoded, rate, _ = frame_forward(params, cfg, "gaussian", "softround", 0.3, 0.25, training=training,
                                     noise=noise if training else None)
    for b in range(2):
        d, r = cc.forward(cc.image_params(params, b), config, training, 0.3, [z[b] for z in noise], 0.25)
        torch.testing.assert_close(d, decoded[b], rtol=0, atol=1e-6)
        torch.testing.assert_close(r, rate[b], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["encode.c3x-kodak.b8", "train.hypernet-delta.b8"])
def test_tf32_control_is_not_correct(name, run_module):
    """The control at a size a test run holds (the cell's own size is run
    by ``benchmark/run.py --control tf32``)."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    cell = tiny_cell(name)
    cell.traffic.update({"height": 256, "width": 384} if "height" in cell.traffic else {})
    cell.config.update({"patch_size": [128, 128]} if "patch_size" in cell.config else {})
    for control, correct in ((None, True), ("tf32", False)):
        result, _ = run_module.execute(cell, torch.device("cuda"), SEED, 0.1, False, control)
        assert result["correct"] is correct, result["check"]
