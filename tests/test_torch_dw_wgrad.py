"""The latent encoder's depthwise 7x7 convolution with its hand-written
weight and bias gradient (``coolchic_tpu_torch/ops/dw_wgrad.py``) on the
CPU, where that gradient is the plain version.

* The plain weight and bias gradients match ``jax.grad`` of the JAX
  package's flax depthwise convolution (``coolchic_tpu/hypernet/blocks.py``:
  ``nn.Conv(c, (7, 7), padding="SAME", feature_group_count=c)``) at the
  gradient tolerance of ``tests/test_torch_models.py`` (rtol = 1e-4,
  atol = 1e-6), the atol scaled by each tap's sum of |terms|: the two are f32
  sums of up to 2 M products in other orders.
* ``depthwise_conv``'s forward and input gradient are the library's, bit for
  bit; under ``torch.no_grad()`` the autograd Function is not entered.
* The latent encoder's backward computes the weight gradient once per
  ConvNeXt block (21 at 7 levels), its eval forward never.
* ``ConvNeXtBlock``'s gradient through the Function matches ``jax.grad`` of
  the flax block (rtol = atol = 1e-4, as ``tests/test_torch_hypernet.py``).
* The card tests' gate (``torch_kernel_checks.py::dw_grad_error``).

Shapes: the 7 levels at B = 8 (the two finest at 4 channels, the next at 8,
to keep the CPU's time and memory small; the kernel is held at 64 on the
card, ``tests/test_torch_cuda.py``), odd planes and a single pixel.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.func import functional_call

from coolchic_tpu.hypernet import blocks as jbl
from coolchic_tpu_torch.hypernet import blocks as tbl
from coolchic_tpu_torch.hypernet.bridge import flax_to_state_dict, state_dict_to_flax
from coolchic_tpu_torch.ops import dw_wgrad
from torch_kernel_checks import dw_grad_error

SHAPES = [(8, 4, 256, 256), (8, 4, 128, 128), (8, 8, 64, 64), (8, 64, 32, 32), (8, 64, 16, 16),
          (8, 64, 8, 8), (8, 64, 4, 4), (8, 5, 17, 30), (3, 64, 9, 9), (8, 64, 1, 1)]
BLOCK_SHAPES = [(2, 8, 17, 30), (8, 8, 16, 16), (3, 8, 9, 9), (2, 8, 1, 1)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed):
    """x, the output gradient, the weight [C, 1, 7, 7] and the bias, numpy f32."""
    rng = np.random.default_rng(seed)
    n_c = shape[1]
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in (shape, shape, (n_c, 1, 7, 7), (n_c,)))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_gradients_match_jax(shape):
    x, gy, w, b = _inputs(shape, sum(shape))
    n_c = shape[1]
    conv = fnn.Conv(n_c, (7, 7), padding="SAME", feature_group_count=n_c)
    params = {"kernel": jnp.asarray(np.transpose(w, (2, 3, 1, 0))), "bias": jnp.asarray(b)}
    x_nhwc, gy_nhwc = (jnp.asarray(np.transpose(a, (0, 2, 3, 1))) for a in (x, gy))
    want = jax.jit(jax.grad(lambda p: jnp.sum(conv.apply({"params": p}, x_nhwc) * gy_nhwc)))(params)
    got_w, got_b = dw_wgrad.weight_grad_plain(torch.tensor(x), torch.tensor(gy))
    assert got_w.shape == (n_c, 1, 7, 7) and got_b.shape == (n_c,)
    scale_w, scale_b = dw_wgrad.weight_grad_plain(torch.tensor(np.abs(x)), torch.tensor(np.abs(gy)))
    for got, want_, scale in ((got_w, np.transpose(np.asarray(want["kernel"]), (3, 2, 0, 1)), scale_w),
                              (got_b, np.asarray(want["bias"]), scale_b)):
        err = np.abs(got.numpy() - want_)
        assert np.all(err <= 1e-4 * np.abs(want_) + 1e-6 * scale.numpy()), err.max()


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_input_gradient_are_the_library_s(shape, channels_last):
    """Bit for bit against autograd through ``F.conv2d`` on the same output
    gradient, contiguous or channels-last (as the layer norm hands it back);
    the weight and bias gradients are the plain version's on x and the
    output gradient made channels-last (what the kernel takes); a gradient
    asked for alone equals the same one asked for with the others."""
    x, gy, w, b = (torch.tensor(a) for a in _inputs(shape, 7 + sum(shape)))
    n_c = shape[1]
    if channels_last:
        gy = gy.contiguous(memory_format=torch.channels_last)
    lib = [t.clone().requires_grad_() for t in (x, w, b)]
    new = [t.clone().requires_grad_() for t in (x, w, b)]
    y_lib = F.conv2d(*lib, padding=3, groups=n_c)
    y_new = dw_wgrad.depthwise_conv(*new)
    assert torch.equal(y_new, y_lib)
    assert type(y_new.grad_fn).__name__ == "_DepthwiseConvBackward"
    gx_lib, = torch.autograd.grad(y_lib, lib[0], gy)
    gx_new, gw_new, gb_new = torch.autograd.grad(y_new, new, gy)
    assert torch.equal(gx_new, gx_lib)
    last = torch.channels_last
    want_w, want_b = dw_wgrad.weight_grad_plain(x.contiguous(memory_format=last),
                                                gy.contiguous(memory_format=last))
    assert torch.equal(gw_new, want_w) and torch.equal(gb_new, want_b)
    gw_only, = torch.autograd.grad(dw_wgrad.depthwise_conv(x, new[1], b), new[1], gy)
    assert torch.equal(gw_only, gw_new)
    gb_only, = torch.autograd.grad(dw_wgrad.depthwise_conv(x, w, new[2]), new[2], gy)
    assert torch.equal(gb_only, gb_new)
    gx_only, = torch.autograd.grad(dw_wgrad.depthwise_conv(new[0], w, b), new[0], gy)
    assert torch.equal(gx_only, gx_lib)


@pytest.mark.parametrize("shape", [(2, 3, 17, 30), (8, 64, 4, 4), (1, 2, 1, 1)])
def test_no_grad_does_not_enter_the_function(shape, monkeypatch):
    """Without autograd (no grad mode, or nothing requiring a gradient) the
    call is ``F.conv2d`` alone: no Function in the graph, no weight gradient,
    no launch."""
    x, _, w, b = (torch.tensor(a) for a in _inputs(shape, 3))
    calls = []
    monkeypatch.setattr(dw_wgrad, "_DepthwiseConv", None)  # entering it would raise
    monkeypatch.setattr(dw_wgrad, "weight_grad", lambda *a: calls.append(a))
    count = dw_wgrad.launch_count
    want = F.conv2d(x, w, b, padding=3, groups=shape[1])
    with torch.no_grad():
        y = dw_wgrad.depthwise_conv(x, w.requires_grad_(), b.requires_grad_())
    assert y.grad_fn is None and torch.equal(y, want)
    y = dw_wgrad.depthwise_conv(x, w.detach(), b.detach())
    assert y.grad_fn is None and torch.equal(y, want)
    assert calls == [] and dw_wgrad.launch_count == count


def test_depthwise_conv_refuses_other_weights():
    x = torch.zeros(2, 4, 9, 9)
    for shape in ((4, 1, 6, 6), (4, 1, 5, 5), (4, 2, 7, 7), (3, 1, 7, 7), (4, 1, 7, 5)):
        with pytest.raises(ValueError):
            dw_wgrad.depthwise_conv(x, torch.zeros(shape), torch.zeros(4))


def test_latent_encoder_computes_the_weight_gradient_once_per_block(monkeypatch):
    """``LatentHyperNet`` at 7 levels (a 64x64 input, 8 channels): a backward
    computes the weight gradient 21 times (3 ConvNeXt blocks a level); the
    block's input and output gradient reach the Function channels-last, so
    that the kernel's layout costs no copy; an eval forward never computes
    it; nothing launches on the CPU."""
    module = tbl.LatentHyperNet(7, 8)
    state = {k: v.requires_grad_() for k, v in
             tbl.init_params(module, torch.Generator().manual_seed(0), "cpu").items()}
    real, real_backward, seen = dw_wgrad.weight_grad, dw_wgrad._DepthwiseConv.backward, []
    last = torch.channels_last

    def recorded_backward(ctx, gy):
        x, _ = ctx.saved_tensors
        seen.append((tuple(x.shape), all(t.is_contiguous(memory_format=last) for t in (x, gy))))
        return real_backward(ctx, gy)

    def recorded(x, gy):
        seen.append(tuple(gy.shape))
        return real(x, gy)

    monkeypatch.setattr(dw_wgrad, "weight_grad", recorded)
    monkeypatch.setattr(dw_wgrad._DepthwiseConv, "backward", staticmethod(recorded_backward))
    count = dw_wgrad.launch_count
    img = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    outs = functional_call(module, state, (img,))
    torch.autograd.grad(sum((o * o).sum() for o in outs), list(state.values()))
    assert len(seen) == 42 and seen[1::2] == [shape for shape, _ in seen[::2]]
    assert sorted(set(seen[::2])) == sorted({((2, 8, 64 >> i, 64 >> i), True) for i in range(7)})
    with torch.no_grad():
        functional_call(module, state, (img,))
    assert len(seen) == 42 and dw_wgrad.launch_count == count


def _perturb(tree, rng, scale=0.05):
    """Every leaf plus ``scale`` N(0, 1); ``layer_scale`` in [0.5, 1.5] (at
    its 1e-6 init a ConvNeXt block is the identity)."""
    if isinstance(tree, dict):
        return {k: (rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32) if k == "layer_scale"
                    else _perturb(v, rng, scale)) for k, v in tree.items()}
    return (np.asarray(tree) + scale * rng.standard_normal(np.shape(tree))).astype(np.float32)


@pytest.mark.parametrize("shape", BLOCK_SHAPES)
def test_convnext_block_gradient_matches_flax(shape):
    """The block's output and its gradients with respect to every parameter
    and the input, through the Function, against ``jax.grad`` of the flax
    block with the same weights."""
    n_c = shape[1]
    rng = np.random.default_rng(sum(shape))
    module = tbl.ConvNeXtBlock(n_c)
    params = _perturb(state_dict_to_flax(tbl.init_params(module, torch.Generator().manual_seed(0),
                                                         "cpu")), rng)
    x = rng.standard_normal(shape).astype(np.float32)
    weight = rng.standard_normal(shape).astype(np.float32)

    def loss(p, x_nhwc):
        out = jbl.ConvNeXtBlock(n_c).apply({"params": p}, x_nhwc)
        return jnp.sum(out * jnp.transpose(weight, (0, 2, 3, 1))), out

    (_, want_out), (want_p, want_x) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                                 has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
    state = {k: v.requires_grad_() for k, v in flax_to_state_dict(params).items()}
    x_t = torch.tensor(x, requires_grad=True)
    out = functional_call(module, state, (x_t,))
    grads = torch.autograd.grad((out * torch.tensor(weight)).sum(), [x_t, *state.values()])
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.transpose(np.asarray(want_out), (0, 3, 1, 2)), **tol)
    np.testing.assert_allclose(grads[0].numpy(), np.transpose(np.asarray(want_x), (0, 3, 1, 2)),
                               **tol)
    want_sd = flax_to_state_dict(jax.tree.map(np.asarray, want_p))
    assert sorted(want_sd) == sorted(state)
    for name, got in zip(state, grads[1:]):
        np.testing.assert_allclose(got.numpy(), want_sd[name].numpy(), err_msg=name, **tol)


def test_plan_covers_every_row_and_column():
    """The kernel's split: every row lies in one strip and every column in
    one group, and each channel group's blocks hold all its items."""
    for n_b, n_c, h, w in [(8, 64, 256, 256), (8, 64, 4, 4), (1, 64, 135, 240), (8, 64, 1, 1),
                           (1, 3, 9, 15), (40, 64, 512, 768)]:
        strip, n_strips, n_seg, n_blk = dw_wgrad.plan(n_b, n_c, h, w, 132)
        assert strip * n_strips >= h > strip * (n_strips - 1)
        assert n_seg * dw_wgrad.VEC >= w > (n_seg - 1) * dw_wgrad.VEC
        items = dw_wgrad.THREADS // dw_wgrad.CHANNELS  # of a block
        assert n_blk * items >= n_b * n_strips * n_seg > (n_blk - 1) * items


def test_dw_grad_error_passes_the_plain_version_and_fails_a_moved_tap():
    """The card tests' gate, ``dw_grad_error`` <= 1e-5: the plain f32
    gradients are under it; the same with one tap or the bias moved by 1e-4
    of its leaf's norm read 5e-5 or more."""
    for shape in [(8, 4, 64, 64), (2, 8, 17, 30), (8, 64, 1, 1)]:
        x, gy, _, _ = (torch.tensor(a) for a in _inputs(shape, 11))
        gw, gb = dw_wgrad.weight_grad_plain(x, gy)
        assert dw_grad_error((gw, gb), x, gy) < 1e-5
        moved = gw.clone()
        moved[1, 0, 3, 3] += 1e-4 * gw.norm()
        assert dw_grad_error((moved, gb), x, gy) >= 5e-5
        moved = gb.clone()
        moved[0] += 1e-4 * gb.norm()
        assert dw_grad_error((gw, moved), x, gy) >= 5e-5
