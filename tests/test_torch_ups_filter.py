"""The upsampling's 1-D filters with their hand-written weight gradient
(``coolchic_tpu_torch/ops/ups_filter.py``) on the CPU, where the weight
gradient is the plain version.

* ``filter_1d``'s forward and input gradient are the library's, bit for
  bit; its weight gradient is within 1e-6 of autograd's through
  ``F.conv_transpose2d`` / ``F.conv2d``, relative to the largest tap (both
  f32 sums of the same products, in another order).
* ``upsampling_apply``'s gradients with respect to the half kernels and the
  latents match ``jax.grad`` of the JAX package's, at the gradient
  tolerance of ``tests/test_torch_models.py`` (rtol = 1e-4, atol = 1e-6).
* The weight gradient runs 4 times per x2 level in a training step that
  trains the upsampling, and never otherwise.
* The card tests' helpers (``torch_kernel_checks.py``): the recorder of a
  backward's weight gradients, and the error gate the kernel is held to.

The kernel itself is held to this plain version on the card
(``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from coolchic_tpu.models.config import CoolChicConfig as JaxConfig
from coolchic_tpu.models.coolchic import init_coolchic_params as jax_init_params
from coolchic_tpu.models.upsampling import upsampling_apply as jax_upsampling_apply
from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.models.coolchic import init_coolchic_params
from coolchic_tpu_torch.models.upsampling import upsampling_apply
from coolchic_tpu_torch.ops import ups_filter
from coolchic_tpu_torch.params import stack_params, tree_leaves
from coolchic_tpu_torch.train.presets import TrainerPhase
from coolchic_tpu_torch.train.step import AdamState, eval_metrics, train_step, trained_tensors
from torch_kernel_checks import cascade_weight_grads, recorded_weight_grads, weight_grad_error

# 1x1, odd H and W, W under and over a 32-column tile, a tall narrow plane.
RAGGED = ((1, 1), (5, 7), (13, 37), (40, 3))
CASES = [(True, k) for k in (4, 6, 8)] + [(False, k) for k in (3, 7)]


def _library(x, w, transposed, axis):
    stride, padding = ups_filter.conv_args(transposed, axis, w.shape[axis])
    if transposed:
        return F.conv_transpose2d(x, w, stride=stride, groups=x.shape[1])
    return F.conv2d(x, w, padding=padding, groups=x.shape[1])


@pytest.mark.parametrize("hw", RAGGED)
@pytest.mark.parametrize("n_images", [1, 3, 8])
@pytest.mark.parametrize("axis", [2, 3])
@pytest.mark.parametrize("transposed,k", CASES)
def test_filter_matches_the_library(transposed, k, axis, n_images, hw):
    rng = np.random.default_rng(k * 100 + axis * 10 + n_images)
    x = torch.tensor(rng.standard_normal((3, n_images, *hw)).astype(np.float32))
    w_shape = (n_images, 1, k, 1) if axis == 2 else (n_images, 1, 1, k)
    w = torch.tensor(rng.standard_normal(w_shape).astype(np.float32))
    x_lib, w_lib = x.clone().requires_grad_(), w.clone().requires_grad_()
    x_new, w_new = x.clone().requires_grad_(), w.clone().requires_grad_()
    y_lib = _library(x_lib, w_lib, transposed, axis)
    y_new = ups_filter.filter_1d(x_new, w_new, transposed, axis)
    assert torch.equal(y_new, y_lib)
    gy = torch.tensor(rng.standard_normal(y_lib.shape).astype(np.float32))
    gx_lib, gw_lib = torch.autograd.grad(y_lib, (x_lib, w_lib), gy)
    gx_new, gw_new = torch.autograd.grad(y_new, (x_new, w_new), gy)
    assert torch.equal(gx_new, gx_lib)
    assert gw_new.shape == w.shape
    assert (gw_new - gw_lib).abs().max() <= 1e-6 * gw_lib.abs().max()
    # Only the gradients asked for are computed: the weight alone, then x alone.
    gw_only, = torch.autograd.grad(ups_filter.filter_1d(x, w_new, transposed, axis), w_new, gy)
    assert torch.equal(gw_only, gw_new)
    gx_only, = torch.autograd.grad(ups_filter.filter_1d(x_new, w, transposed, axis), x_new, gy)
    assert torch.equal(gx_only, gx_lib)


def test_plain_weight_gradient_of_a_strided_input():
    """x as the pre-concat filter sees the latents: a [C, B, H, W] view of
    [B, C, H, W]; the plain gradient equals the contiguous input's."""
    rng = np.random.default_rng(5)
    latents = torch.tensor(rng.standard_normal((4, 2, 9, 11)).astype(np.float32))
    x = latents.transpose(0, 1)
    gy = torch.tensor(rng.standard_normal(x.shape).astype(np.float32))
    for axis in (2, 3):
        got = ups_filter.weight_grad_plain(x, gy, 7, False, axis)
        want = ups_filter.weight_grad_plain(x.contiguous(), gy, 7, False, axis)
        assert torch.equal(got, want)


def test_plans_cover_every_row_and_column():
    """The splits the kernel is given: every A row lies in one strip and
    every column in one group (along rows) or chunk (along columns), and no
    block is left without work along columns."""
    for n_c, n_b, h, w, k in [(6, 8, 264, 384, 8), (1, 8, 512, 768, 7), (1, 1, 1, 1, 3),
                              (6, 1, 68 + 8, 120, 8), (3, 40, 17, 30, 16)]:
        kmax, vec, strip, n_strips, n_cg, n_blk = ups_filter.rows_plan(n_c, n_b, h, w, k, 4, 132)
        assert kmax >= k and strip * n_strips >= h > strip * (n_strips - 1)
        assert n_cg * vec >= w and n_blk * ups_filter.THREADS >= n_c * n_strips * n_cg
        kmax, n_chunks, *_, n_blk = ups_filter.cols_plan(n_c, n_b, h, w, k, 132)
        assert kmax >= k and n_chunks * ups_filter.CHUNK >= w > (n_chunks - 1) * ups_filter.CHUNK
        assert 1 <= n_blk <= -(-n_c * h * n_chunks // (ups_filter.THREADS // 32))
    with pytest.raises(ValueError):
        ups_filter.kmax_for(ups_filter.MAX_K + 1)


# --------------------------------------------------------------------------- #
# upsampling_apply against jax.grad
# --------------------------------------------------------------------------- #
ARCH = dict(img_size=(29, 37), n_ft_per_res=(1, 1, 1, 1), dim_arm=8, n_hidden_layers_arm=1,
            layers_synthesis=("8-1-linear-relu", "X-1-linear-none"))
MASKED_HW = ((29, 37), (20, 37), (25, 30))


def _ups_inputs(seed):
    """Upsampling half kernels and latents of one image (numpy), perturbed
    from JAX's init so that every tap and latent is non-trivial."""
    params = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(seed), JaxConfig(**ARCH)))
    rng = np.random.default_rng(seed)
    ups = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
                       params["upsampling"])
    latents = [(0.3 * rng.standard_normal(a.shape)).astype(np.float32) for a in params["latents"]]
    return ups, latents


def _jax_grads(ups, latents, weight, valid_hw=None):
    def loss(u, y):
        return jnp.sum(jax_upsampling_apply(u, y, 8, 7, valid_hw=valid_hw) * weight)

    return jax.grad(loss, argnums=(0, 1))(jax.tree.map(jnp.asarray, ups),
                                          [jnp.asarray(a) for a in latents])


@pytest.mark.parametrize("case", ["one_image", "batch", "batch_masked"])
def test_upsampling_gradients_match_jax(case):
    n_images = 1 if case == "one_image" else len(MASKED_HW)
    rows = [_ups_inputs(seed) for seed in range(n_images)]
    rng = np.random.default_rng(11)
    n_grids = len(ARCH["n_ft_per_res"])  # one channel each: the dense output's channels
    weights = rng.standard_normal((n_images, n_grids, *ARCH["img_size"])).astype(np.float32)
    valid_hw = np.array(MASKED_HW, np.int32) if case == "batch_masked" else None
    want = [_jax_grads(*rows[b], weights[b], None if valid_hw is None else jnp.asarray(valid_hw[b]))
            for b in range(n_images)]

    if case == "one_image":
        ups = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), rows[0][0])
        latents = [torch.tensor(a, requires_grad=True) for a in rows[0][1]]
        weight = torch.tensor(weights[0])
    else:
        ups = {key: [torch.tensor(np.stack([r[0][key][i] for r in rows]), requires_grad=True)
                     for i in range(len(rows[0][0][key]))] for key in rows[0][0]}
        latents = [torch.tensor(np.stack([r[1][i] for r in rows]), requires_grad=True)
                   for i in range(len(rows[0][1]))]
        weight = torch.tensor(weights)
    out = upsampling_apply(ups, latents, 8, 7,
                           valid_hw=None if valid_hw is None else torch.tensor(valid_hw))
    leaves = tree_leaves(ups) + latents
    got = torch.autograd.grad((out * weight).sum(), leaves)
    n_ups = len(tree_leaves(ups))
    for b, (g_ups, g_lat) in enumerate(want):
        for i, (g, w) in enumerate(zip(got, jax.tree.leaves(g_ups) + list(g_lat))):
            row = g.numpy() if case == "one_image" else g[b].numpy()
            what = f"image {b}, {'half kernel' if i < n_ups else 'latent grid'} {i}"
            np.testing.assert_allclose(row, np.asarray(w), rtol=1e-4, atol=1e-6, err_msg=what)


# --------------------------------------------------------------------------- #
# When the weight gradient runs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("modules,calls", [(("all",), 24), (("upsampling",), 24),
                                           (("arm", "synthesis", "latents"), 0)])
def test_weight_gradient_runs_only_when_the_upsampling_trains(modules, calls):
    """The default decoder (7 grids, 6 x2 levels) at B = 2: one batched
    training step computes the weight gradient 24 times (4 filters per
    level) when the upsampling trains, never when it does not (the latents
    still get their gradient through the filters), and an eval forward
    never does; no kernel launches on the CPU."""
    cfg = CoolChicConfig(img_size=(64, 96))
    assert cfg.latent_n_grids == 7
    gen = torch.Generator().manual_seed(0)
    params = stack_params([init_coolchic_params(gen, cfg, "cpu", "normal") for _ in range(2)])
    phase = TrainerPhase(lr=1e-3, optimized_module=modules)
    tensors = trained_tensors(params, phase.optimized_module)
    for t in tensors:
        t.requires_grad_(True)
    targets = torch.rand(2, 3, 64, 96, generator=gen)
    lmbdas = torch.tensor([1e-3, 4e-3])
    before = [t.detach().clone() for t in tree_leaves(params["latents"])]
    count = ups_filter.launch_count
    with recorded_weight_grads() as seen:
        train_step(params, tensors, AdamState.zeros(tensors), targets, lmbdas, cfg, phase, 1e-3,
                   0.3, 0.25, gen)
        assert len(seen) == calls
        if calls:
            assert sorted({c[2:] for c in seen}) == [(7, False, 2), (7, False, 3), (8, True, 2),
                                                     (8, True, 3)]
        moved = any(not torch.equal(a, b) for a, b in zip(before, tree_leaves(params["latents"])))
        assert moved == ("latents" in modules or "all" in modules)
        for t in tensors:
            t.requires_grad_(False)
        eval_metrics(params, cfg, targets, lmbdas)
        assert len(seen) == calls
    assert ups_filter.launch_count == count


# --------------------------------------------------------------------------- #
# The helpers the card tests hold the kernel with
# --------------------------------------------------------------------------- #
def test_cascade_weight_grads_records_the_backward_in_order():
    """At 64x96, B = 2: the 24 weight gradients of one backward, finest level
    first, each level's pre-concat filter (W, then H) before its x2 step (W,
    then H), with the shapes the filters see; ``ups_filter.weight_grad`` is
    the module's own again after the block, and after an error in it."""
    real = ups_filter.weight_grad
    calls = cascade_weight_grads((64, 96), 2, "cpu")
    assert ups_filter.weight_grad is real
    assert [c[2:] for c in calls] == [(7, False, 3), (7, False, 2), (8, True, 3),
                                      (8, True, 2)] * 6
    sizes = [tuple(c[0].shape[2:]) for c in calls[::4]]
    assert sizes == [(64 >> i, 96 >> i) for i in range(6)]
    for x, gy, k, transposed, axis in calls:
        assert x.shape[:2] == gy.shape[:2] and x.shape[1] == 2
        want = 2 * (x.shape[axis] - 1) + k if transposed else x.shape[axis]
        assert gy.shape[axis] == want and not x.requires_grad
    with pytest.raises(RuntimeError, match="inside"):
        with recorded_weight_grads():
            assert ups_filter.weight_grad is not real
            raise RuntimeError("inside the block")
    assert ups_filter.weight_grad is real


def test_weight_grad_error_passes_the_plain_version_and_fails_a_moved_tap():
    """The card tests' gate, ``weight_grad_error`` <= 1e-5: the plain f32
    weight gradient of each recorded call is under it; the same with one tap
    moved by 1e-3 of that tap's sum of |terms| reads 1e-4 or more."""
    for x, gy, k, transposed, axis in cascade_weight_grads((64, 96), 2, "cpu"):
        got = ups_filter.weight_grad_plain(x, gy, k, transposed, axis)
        assert weight_grad_error(got, x, gy, k, transposed, axis) < 1e-5
        scale = ups_filter.weight_grad_plain(x.abs(), gy.abs(), k, transposed, axis)
        moved = got.clone()
        moved[1, k // 2] += 1e-3 * scale[1, k // 2]
        assert weight_grad_error(moved, x, gy, k, transposed, axis) >= 1e-4
