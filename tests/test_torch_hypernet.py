"""The hypernet's nets in the PyTorch port against their flax twins in the
JAX package, on random numpy inputs made from a seed, with the same weights
on both sides (bridged with ``coolchic_tpu_torch.hypernet.bridge``): the
ConvNeXt blocks, the latent encoder, the MLP heads, the ResNet backbone, the
bicubic latent resize, the whole ``CoolchicHyperNet`` in each of its modes
and ``SmallCoolchicHyperNet``; the parameter counts and head shapes; the
bridge's round trip; one test per parity trap (each would fail with the
trap taken: it holds the port's layer to flax's and the trap's layer away
from it); and the initializers' distributions.

Weights: flax's ``init`` (or the port's, bridged to flax where the flax init
would only cost compile time), then every leaf perturbed with a seeded numpy
draw, so that no layer sits at its zero or identity start.
Tolerance: rtol = atol = 1e-4 in f32.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from coolchic_tpu.hypernet import backbone as jbb
from coolchic_tpu.hypernet import blocks as jbl
from coolchic_tpu.hypernet import heads as jhd
from coolchic_tpu.models.config import CoolChicConfig as JaxConfig
from coolchic_tpu_torch.hypernet import backbone as tbb
from coolchic_tpu_torch.hypernet import blocks as tbl
from coolchic_tpu_torch.hypernet import heads as thd
from coolchic_tpu_torch.hypernet.bridge import flax_to_state_dict, state_dict_to_flax
from coolchic_tpu_torch.models.config import CoolChicConfig

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = dict(n_ft_per_res=(1, 1, 1), layers_synthesis=("8-1-linear-relu", "X-1-linear-none"),
            dim_arm=8, n_hidden_layers_arm=1)
HN_KW = dict(synthesis_hidden_dim=32, synthesis_n_layers=1, arm_hidden_dim=32, arm_n_layers=1,
             ups_hidden_dim=16, ups_n_layers=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small convolutions gain nothing from intra-op threads, and test
    processes that each spin a thread per core slow each other down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturb(tree, seed=0, scale=0.05):
    """Every leaf plus ``scale`` N(0, 1); ``layer_scale`` drawn in [0.5, 1.5]
    (at its 1e-6 init a ConvNeXt block is the identity)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "layer_scale":
                out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
            else:
                out[k] = (np.asarray(v) + scale * rng.standard_normal(np.shape(v))).astype(np.float32)
        return out

    return walk(tree)


def nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def to_nchw(y):
    return np.transpose(np.asarray(y), (0, 3, 1, 2))


def flax_module_params(module, x_nchw, torch_module, seed=0, scale=0.05):
    """The port's seeded init of ``torch_module``, perturbed, in flax's
    layout; checked to have exactly the names and shapes of flax's init of
    ``module`` on the NHWC form of ``x_nchw`` (traced, not run)."""
    gen = torch.Generator().manual_seed(seed)
    params = perturb(state_dict_to_flax(tbl.init_params(torch_module, gen, "cpu")), seed, scale)
    want = jax.eval_shape(module.init, jax.random.PRNGKey(0), nhwc(x_nchw))["params"]
    assert jax.tree.structure(params) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
        assert a.shape == b.shape
    return params


def run_torch(module, params, x_nchw):
    """The port's module with flax weights, on the NCHW input."""
    module.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        return module(torch.tensor(x_nchw))


def rand(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def assert_close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


# --------------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("hw", [(9, 11), (16, 16)])
def test_convnext_block_matches_flax(hw):
    x = rand((2, 8) + hw)
    jm, tm = jbl.ConvNeXtBlock(8), tbl.ConvNeXtBlock(8)
    params = flax_module_params(jm, x, tm)
    want = to_nchw(jax.jit(jm.apply)({"params": params}, nhwc(x)))
    assert_close(run_torch(tm, params, x), want)


@pytest.mark.parametrize("in_ch,out_ch,down,hw", [
    (3, 8, 1, (13, 17)),  # the first level
    (8, 8, 2, (13, 17)),  # odd sizes: the pool pads a zero row and column
    (8, 8, 2, (5, 5)),
    (8, 8, 2, (16, 24)),
])
def test_residual_block_matches_flax(in_ch, out_ch, down, hw):
    x = rand((2, in_ch) + hw)
    jm, tm = jbl.ResidualBlock(in_ch, out_ch, down), tbl.ResidualBlock(in_ch, out_ch, down)
    params = flax_module_params(jm, x, tm)
    want = to_nchw(jax.jit(jm.apply)({"params": params}, nhwc(x)))
    got = run_torch(tm, params, x)
    assert got.shape == want.shape
    assert_close(got, want)


def test_latent_hypernet_matches_flax_per_level():
    x = np.random.default_rng(2).uniform(size=(2, 3, 33, 45)).astype(np.float32)
    jm, tm = jbl.LatentHyperNet(n_latents=4, n_hidden_channels=8), tbl.LatentHyperNet(4, 8)
    params = flax_module_params(jm, x, tm)
    want = jax.jit(jm.apply)({"params": params}, nhwc(x))
    got = run_torch(tm, params, x)
    assert [tuple(g.shape) for g in got] == [(2, 1, 33, 45), (2, 1, 17, 23), (2, 1, 9, 12),
                                             (2, 1, 5, 6)]
    for g, w in zip(got, want):
        assert_close(g, to_nchw(w))


@pytest.mark.parametrize("activation", [None, "tanh", "relu", "leaky_relu"])
@pytest.mark.parametrize("zero_init", [False, True])
def test_mlp_matches_flax(activation, zero_init):
    x = rand((3, 20))
    jm = jbl.MLP(output_size=7, hidden_size=16, n_hidden_layers=2, output_activation=activation,
                 zero_init_output=zero_init)
    params = perturb(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]))
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = tbl.MLP(20, 7, 16, 2, activation, zero_init)
    tm.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        assert_close(tm(torch.tensor(x)), want)


# --------------------------------------------------------------------------- #
# Backbone
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("block,in_ch,filters,stride,hw", [
    ("BasicBlock", 64, 64, 1, (9, 11)),
    ("BasicBlock", 64, 128, 2, (9, 11)),  # 1x1 stride-2 shortcut on odd sizes: no padding
    ("Bottleneck", 64, 64, 1, (7, 9)),
    ("Bottleneck", 256, 128, 2, (7, 9)),
])
def test_resnet_blocks_match_flax(block, in_ch, filters, stride, hw):
    x = rand((2, in_ch) + hw)
    jm, tm = getattr(jbb, block)(filters, stride), getattr(tbb, block)(in_ch, filters, stride)
    params = flax_module_params(jm, x, tm)
    want = to_nchw(jax.jit(jm.apply)({"params": params}, nhwc(x)))
    got = run_torch(tm, params, x)
    assert got.shape == want.shape
    assert_close(got, want)


@pytest.mark.parametrize("hw", [(32, 32), (33, 45)])
def test_resnet18_matches_flax(hw):
    x = rand((2, 3) + hw, seed=3)
    jm, n_feats = jbb.get_backbone("resnet18")
    tm, t_feats = tbb.get_backbone("resnet18")
    params = flax_module_params(jm, x, tm, scale=0.01)
    want = jax.jit(jm.apply)({"params": params}, nhwc(x))
    assert t_feats == n_feats == 512
    assert_close(run_torch(tm, params, x), want)


# --------------------------------------------------------------------------- #
# The latent resize
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("grids,out_hw", [
    (((5, 7),), (37, 53)),  # odd, non-power-of-two ratios
    (((37, 53), (19, 27), (10, 14), (5, 7)), (37, 53)),  # a ceil-divided pyramid
    (((4, 6),), (16, 24)),
])
def test_upsample_latents_matches_jax(grids, out_hw):
    lats = [rand((2, 1) + hw, seed=i) for i, hw in enumerate(grids)]
    want = jbl.upsample_latents([nhwc(y) for y in lats], out_hw)
    got = tbl.upsample_latents([torch.tensor(y) for y in lats], out_hw)
    assert_close(got, to_nchw(want))


# --------------------------------------------------------------------------- #
# The whole hypernets
# --------------------------------------------------------------------------- #
CFG = dict(img_size=(32, 32), **ARCH)


def assert_outputs_close(got, want):
    got_lat, *got_nets = got
    want_lat, *want_nets = want
    for g, w in zip(got_lat, want_lat):
        assert_close(g, to_nchw(w))
    for g, w in zip(got_nets, want_nets):
        g_leaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), g))
        w_leaves = jax.tree.leaves(w)
        assert len(g_leaves) == len(w_leaves)
        for a, b in zip(g_leaves, w_leaves):
            assert a.shape == b.shape
            assert_close(a, b)


HYPERNET_VARIANTS = {
    "deltas": {},
    "no_deltas": dict(deltas=False),
    "only_biases_arm": dict(only_biases_arm=True),
    "only_biases_synthesis": dict(only_biases_synthesis=True),
    "double_backbone": dict(double_backbone=True),
}


@pytest.mark.parametrize("variant", sorted(HYPERNET_VARIANTS))
def test_coolchic_hypernet_matches_flax(variant):
    kw = dict(n_hidden_channels=8, **HN_KW, **HYPERNET_VARIANTS[variant])
    x = np.random.default_rng(4).uniform(size=(2, 3, 32, 32)).astype(np.float32)
    jm = jhd.CoolchicHyperNet(cfg=JaxConfig(**CFG), **kw)
    tm = thd.CoolchicHyperNet(CoolChicConfig(**CFG), **kw)
    params = flax_module_params(jm, x, tm, seed=5, scale=0.01)
    want = jax.jit(jm.apply)({"params": params}, nhwc(x))
    assert_outputs_close(run_torch(tm, params, x), want)


def test_small_coolchic_hypernet_matches_flax():
    kw = dict(n_hidden_channels=8, synthesis_hidden_dim=32, synthesis_n_layers=1,
              arm_hidden_dim=32, arm_n_layers=1)
    x = np.random.default_rng(6).uniform(size=(2, 3, 32, 32)).astype(np.float32)
    jm = jhd.SmallCoolchicHyperNet(cfg=JaxConfig(**CFG), **kw)
    tm = thd.SmallCoolchicHyperNet(CoolChicConfig(**CFG), **kw)
    params = flax_module_params(jm, x, tm, seed=7, scale=0.01)
    want = jax.jit(jm.apply)({"params": params}, nhwc(x))
    assert_outputs_close(run_torch(tm, params, x), want)


DEC_CFGS = {
    "tiny": CFG,
    "default": dict(img_size=(24, 40)),
    "hop": dict(img_size=(16, 16), dim_arm=16, n_hidden_layers_arm=2,
                layers_synthesis=("48-1-linear-relu", "X-1-linear-none", "X-3-residual-relu",
                                  "X-3-residual-none")),
}


@pytest.mark.parametrize("name", sorted(DEC_CFGS))
def test_param_counts_and_head_shapes_match_jax(name):
    jcfg, tcfg = JaxConfig(**DEC_CFGS[name]), CoolChicConfig(**DEC_CFGS[name])
    for only in (False, True):
        assert thd.arm_param_count(tcfg.dim_arm, tcfg.n_hidden_layers_arm, only_biases=only) == \
            jhd.arm_param_count(jcfg.dim_arm, jcfg.n_hidden_layers_arm, only_biases=only)
        assert thd.synthesis_param_count(tcfg, only_biases=only) == \
            jhd.synthesis_param_count(jcfg, only_biases=only)
    assert thd.arm_param_count(16, 2, biases=False) == jhd.arm_param_count(16, 2, biases=False)
    assert thd.upsampling_param_count(tcfg) == jhd.upsampling_param_count(jcfg)

    pairs = [
        (thd.shape_arm, jhd.shape_arm, thd.arm_param_count(tcfg.dim_arm, tcfg.n_hidden_layers_arm),
         {}),
        (thd.shape_arm, jhd.shape_arm,
         thd.arm_param_count(tcfg.dim_arm, tcfg.n_hidden_layers_arm, only_biases=True),
         {"only_biases": True}),
        (thd.shape_synthesis, jhd.shape_synthesis, thd.synthesis_param_count(tcfg), {}),
        (thd.shape_synthesis, jhd.shape_synthesis,
         thd.synthesis_param_count(tcfg, only_biases=True), {"only_biases": True}),
        (thd.shape_upsampling, jhd.shape_upsampling, thd.upsampling_param_count(tcfg), {}),
    ]
    for t_fn, j_fn, n, kw in pairs:
        flat = rand((3, n), seed=n)
        got = jax.tree.map(lambda t: t.numpy(), t_fn(torch.tensor(flat), tcfg, **kw))
        want = j_fn(jnp.asarray(flat), jcfg, **kw)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.fixture(scope="module")
def flax_hypernet_init():
    """flax's own init of a CoolchicHyperNet (resnet18, delta mode)."""
    jm = jhd.CoolchicHyperNet(cfg=JaxConfig(**CFG), n_hidden_channels=8, **HN_KW)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    return jax.tree.map(np.asarray, params)


def test_bridge_round_trip_is_bit_identical(flax_hypernet_init):
    tree = perturb(flax_hypernet_init)
    sd = flax_to_state_dict(tree)
    tm = thd.CoolchicHyperNet(CoolChicConfig(**CFG), n_hidden_channels=8, **HN_KW)
    assert set(sd) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert sd[k].shape == v.shape, k
    back = state_dict_to_flax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # A depthwise kernel and a dense kernel in their torch layouts.
    dw = tree["LatentHyperNet_0"]["ResidualBlock_0"]["ConvNeXtBlock_0"]["Conv_0"]["kernel"]
    assert dw.shape == (7, 7, 1, 8)
    np.testing.assert_array_equal(
        sd["LatentHyperNet_0.ResidualBlock_0.ConvNeXtBlock_0.Conv_0.weight"].numpy(),
        np.transpose(dw, (3, 2, 0, 1)))
    np.testing.assert_array_equal(sd["MLP_1.Dense_0.weight"].numpy(),
                                  tree["MLP_1"]["Dense_0"]["kernel"].T)


def test_init_distributions_follow_flax(flax_hypernet_init):
    """The port's init against flax's: zeros where flax has zeros, ones for
    the norms' scales, 1e-6 for layer_scale, and for every random kernel the
    same truncated normal (std within 10 % where the kernel has 1,000
    values or more, and no value past the truncation at 2 std before
    flax's variance correction)."""
    tm = thd.CoolchicHyperNet(CoolChicConfig(**CFG), n_hidden_channels=8, **HN_KW)
    got = state_dict_to_flax(tbl.init_params(tm, torch.Generator().manual_seed(0), "cpu"))
    want = flax_hypernet_init
    n_random = 0
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        name = jax.tree_util.keystr(path)
        assert a.shape == b.shape, name
        if not b.any() or name.endswith("['layer_scale']") or name.endswith("['scale']"):
            np.testing.assert_array_equal(a, b, err_msg=name)
            continue
        n_random += 1
        if b.size >= 1000:
            assert abs(a.std() / b.std() - 1.0) < 0.1, name
        # the truncation: |x| <= 2 std / 0.88 (lecun) or 2 * 0.02 (ConvNeXt).
        bound = max(2.0 * 0.02, 2.0 * float(b.std()) / 0.87962566 * 1.15)
        assert np.abs(a).max() <= bound and np.abs(b).max() <= bound, name
    assert n_random > 50
    # the delta heads' output layers start at zero, the ConvNeXt scale at 1e-6
    assert not got["MLP_0"]["Dense_2"]["kernel"].any()
    np.testing.assert_array_equal(
        got["LatentHyperNet_0"]["ResidualBlock_1"]["ConvNeXtBlock_2"]["layer_scale"],
        np.full(8, 1e-6, np.float32))


# --------------------------------------------------------------------------- #
# Parity traps: the port's layer holds to flax, the trap's misses it.
# --------------------------------------------------------------------------- #
def test_trap_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    want = np.asarray(fnn.gelu(jnp.asarray(x)))
    assert_close(tbl.gelu(torch.tensor(x)), want, rtol=0, atol=1e-6)
    assert np.abs(F.gelu(torch.tensor(x)).numpy() - want).max() > 1e-4  # the exact GELU


def test_trap_group_norm_epsilon():
    """Groups of small variance, where epsilon 1e-5 against 1e-6 shows."""
    x = 1e-3 * rand((2, 64, 5, 7))
    params = {"scale": np.ones(64, np.float32), "bias": np.zeros(64, np.float32)}
    want = to_nchw(fnn.GroupNorm(num_groups=32).apply({"params": params}, nhwc(x)))
    assert_close(tbl.GroupNorm(64)(torch.tensor(x)).detach(), want)
    trap = torch.nn.GroupNorm(32, 64)(torch.tensor(x)).detach().numpy()
    assert np.abs(trap - want).max() > 1e-2


def test_trap_layer_norm_over_channels():
    x = rand((2, 8, 5, 7))
    params = {"scale": np.ones(8, np.float32), "bias": np.zeros(8, np.float32)}
    want = to_nchw(fnn.LayerNorm(epsilon=1e-6).apply({"params": params}, nhwc(x)))
    assert_close(tbl.LayerNorm(8)(torch.tensor(x)).detach(), want)
    trap = torch.nn.LayerNorm(7, eps=1e-6)(torch.tensor(x)).detach().numpy()  # the last axis
    assert np.abs(trap - want).max() > 0.1


@pytest.mark.parametrize("hw", [(5, 5), (9, 12)])
def test_trap_average_pool_counts_the_padding(hw):
    x = rand((2, 3) + hw)
    want = to_nchw(fnn.avg_pool(nhwc(x), (2, 2), strides=(2, 2), padding=((0, 1), (0, 1))))
    assert_close(tbl.avg_pool_down(torch.tensor(x), 2), want)
    trap = F.avg_pool2d(torch.tensor(x), 2, ceil_mode=True).numpy()
    assert trap.shape == want.shape and np.abs(trap - want).max() > 0.1


def test_trap_bicubic_resize_is_keys_half_pixel():
    lat = rand((2, 1, 4, 6))
    want = to_nchw(jbl.upsample_latents([nhwc(lat)], (16, 24)))
    assert_close(tbl.upsample_latents([torch.tensor(lat)], (16, 24)), want)
    trap = F.interpolate(torch.tensor(lat), size=(16, 24), mode="bicubic", align_corners=False)
    assert np.abs(trap.numpy() - want).max() > 0.05


def test_trap_stem_pool_pads_minus_infinity():
    x = rand((2, 4, 9, 11)) - 3.0  # all negative: a zero pad would win the max
    want = to_nchw(fnn.max_pool(nhwc(x), (3, 3), strides=(2, 2), padding=((1, 1), (1, 1))))
    assert_close(tbb.stem_pool(torch.tensor(x)), want, rtol=0, atol=0)
    trap = F.max_pool2d(F.pad(torch.tensor(x), (1, 1, 1, 1)), 3, stride=2).numpy()
    assert trap.shape == want.shape and np.abs(trap - want).max() > 1.0



@pytest.mark.parametrize("k,stride,hw", [(1, 2, (9, 11)), (7, 1, (9, 11)), (3, 2, (9, 11))])
def test_trap_conv_padding(k, stride, hw):
    """flax "SAME" for the 1x1 stride-2 shortcut pads nothing; the 7x7
    depthwise conv pads 3; the strided 3x3 pads 1. A padded shortcut
    (torch's padding=1 for a 3x3, kept for a 1x1) would shift every output."""
    x = rand((2, 4) + hw)
    groups = 4 if k == 7 else 1
    padding = "SAME" if k != 3 else 1
    jm = fnn.Conv(4, (k, k), strides=stride, padding=padding, feature_group_count=groups)
    params = perturb(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), nhwc(x))["params"]))
    want = to_nchw(jax.jit(jm.apply)({"params": params}, nhwc(x)))
    tm = tbl.Conv(4, 4, k, stride=stride, padding=0 if k == 1 else None if k == 7 else 1,
                  groups=groups)
    got = run_torch(tm, params, x)
    assert got.shape == want.shape
    assert_close(got, want)
    if k == 1:
        trap = F.conv2d(torch.tensor(x), tm.weight, tm.bias, stride=2, padding=1).detach()
        assert trap.shape != want.shape
