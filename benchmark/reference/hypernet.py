"""Plain PyTorch reference of the delta whole net (the amortized encoder of
Cool-chic's hypernet fork) and of its training step.

Written from ``coolchic/hypernet/hypernet.py`` of pepborrell/cool-chic and
its flax counterparts: a ConvNeXt latent encoder (one residual block and a
1x1 head per latent grid), a resnet18 with GroupNorm(32), and three MLP heads
that emit per-image deltas to a shared Cool-chic decoder. It imports nothing
of the program under test. The weights are a flat dict under flax's module
names (the program's interface, built by the benchmark and handed to both
sides); every layer here is written out from ``torch.nn.functional`` calls:
channel LayerNorm and GroupNorm with epsilon 1e-6, tanh GELU, a zero-padded
average pool that counts its padding, a -inf-padded stem max-pool.

The optimizer is optax's ``chain(clip_by_global_norm(1.0), scale_by_adam())``
over every leaf of the hypernet and the shared decoder, with one step count,
then ``p -= lr * update``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import coolchic as cc

EPS = 1e-6
GRAD_CLIP = 1.0
RESNET18_STAGES = (2, 2, 2, 2)


def conv(sd: Dict, name: str, x: torch.Tensor, stride: int = 1, padding=None, groups: int = 1):
    w = sd[name + ".weight"]
    k = w.shape[-1]
    return F.conv2d(x, w, sd.get(name + ".bias"), stride, (k - 1) // 2 if padding is None else padding,
                    groups=groups)


def layer_norm(sd: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """Normalize each pixel's channels (dim 1)."""
    mean = x.mean(dim=1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + EPS)
    return y * sd[name + ".weight"][:, None, None] + sd[name + ".bias"][:, None, None]


def group_norm(sd: Dict, name: str, x: torch.Tensor, groups: int = 32) -> torch.Tensor:
    b, c, h, w = x.shape
    g = x.reshape(b, groups, -1)
    mean = g.mean(dim=2, keepdim=True)
    var = ((g - mean) ** 2).mean(dim=2, keepdim=True)
    y = ((g - mean) / torch.sqrt(var + EPS)).reshape(b, c, h, w)
    return y * sd[name + ".weight"][:, None, None] + sd[name + ".bias"][:, None, None]


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def convnext(sd: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    c = x.shape[1]
    z = layer_norm(sd, name + ".LayerNorm_0", conv(sd, name + ".Conv_0", x, groups=c))
    z = conv(sd, name + ".Conv_2", gelu(conv(sd, name + ".Conv_1", z)))
    return sd[name + ".layer_scale"][:, None, None] * z + x


def residual_block(sd: Dict, name: str, x: torch.Tensor, stride: int) -> torch.Tensor:
    z = gelu(layer_norm(sd, name + ".LayerNorm_0", conv(sd, name + ".Conv_0", x, stride, 1)))
    z = convnext(sd, name + ".ConvNeXtBlock_0", z)
    y = F.avg_pool2d(F.pad(x, (0, 1, 0, 1)), 2, stride=stride) if stride > 1 else x
    z = z + conv(sd, name + ".Conv_1", y)
    return convnext(sd, name + ".ConvNeXtBlock_2", convnext(sd, name + ".ConvNeXtBlock_1", z))


def latent_encoder(sd: Dict, x: torch.Tensor, n_grids: int) -> List[torch.Tensor]:
    out = []
    for i in range(n_grids):
        x = residual_block(sd, f"LatentHyperNet_0.ResidualBlock_{i}", x, 1 if i == 0 else 2)
        out.append(conv(sd, f"LatentHyperNet_0.Conv_{i}", x))
    return out


def resnet18(sd: Dict, x: torch.Tensor) -> torch.Tensor:
    p = "ResNet_0."
    x = torch.relu(group_norm(sd, p + "GroupNorm_0", conv(sd, p + "Conv_0", x, 2, 3)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    block = 0
    for stage, n in enumerate(RESNET18_STAGES):
        for j in range(n):
            name = f"{p}BasicBlock_{block}"
            stride = 2 if stage > 0 and j == 0 else 1
            y = torch.relu(group_norm(sd, name + ".GroupNorm_0", conv(sd, name + ".Conv_0", x, stride, 1)))
            y = group_norm(sd, name + ".GroupNorm_1", conv(sd, name + ".Conv_1", y, 1, 1))
            if name + ".Conv_2.weight" in sd:
                x = group_norm(sd, name + ".GroupNorm_2", conv(sd, name + ".Conv_2", x, stride, 0))
            x = torch.relu(y + x)
            block += 1
    return x.mean(dim=(2, 3))


def mlp(sd: Dict, name: str, x: torch.Tensor) -> torch.Tensor:
    n = sum(1 for k in sd if k.startswith(name + ".Dense_") and k.endswith(".weight"))
    for i in range(n):
        x = F.linear(x, sd[f"{name}.Dense_{i}.weight"], sd[f"{name}.Dense_{i}.bias"])
        x = torch.relu(x) if i < n - 1 else torch.tanh(x)
    return x


def decoder_deltas(flat_syn: torch.Tensor, flat_arm: torch.Tensor, flat_ups: torch.Tensor, dec: Dict,
                   ) -> Dict:
    """The heads' flat outputs of one image, laid out as the decoder's leaves:
    synthesis (weight, bias per layer), ARM (weight, bias per layer), and per
    upsampling stage the x2 half kernel and the pre-concat half kernel, each
    followed by one unused output."""
    syn, p, in_ft = [], 0, len(dec["n_ft_per_res"])
    for out_ft, k, _res, _relu in cc.parse_synthesis(dec["layers_synthesis"]):
        n_w = out_ft * in_ft * k * k
        syn.append({"weight": flat_syn[p:p + n_w].reshape(out_ft, in_ft, k, k),
                    "bias": flat_syn[p + n_w:p + n_w + out_ft]})
        p += n_w + out_ft
        in_ft = out_ft
    arm, p, c = [], 0, dec["dim_arm"]
    for out in [c] * dec["n_hidden_layers_arm"] + [2]:
        n_w = out * c
        arm.append({"weight": flat_arm[p:p + n_w].reshape(out, c), "bias": flat_arm[p + n_w:p + n_w + out]})
        p += out * c + out
    n_ups, n_pre = (dec["ups_k_size"] + 1) // 2, (dec["ups_preconcat_k_size"] + 1) // 2
    ups, pre, p = [], [], 0
    for _ in range(len(dec["n_ft_per_res"]) - 1):
        ups.append(flat_ups[p:p + n_ups])
        p += n_ups + 1
        pre.append(flat_ups[p:p + n_pre])
        p += n_pre + 1
    return {"arm": {"layers": arm}, "upsampling": {"ups": ups, "preconcat": pre},
            "synthesis": {"layers": syn}}


def add_trees(a, b):
    if isinstance(a, dict):
        return {k: add_trees(a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [add_trees(x, y) for x, y in zip(a, b)]
    return a + b


def forward(hyper: Dict, decoder: Dict, imgs: torch.Tensor, dec: Dict, training: bool,
            temperature: float = 0.3, noise: Sequence[torch.Tensor] | None = None,
            noise_parameter: float = 0.25):
    """Per image b: (synthesis output [3, H, W], neither clipped nor rounded,
    rate bits) of the decoder base + its predicted deltas on its predicted
    latents."""
    latents = latent_encoder(hyper, imgs, len(dec["n_ft_per_res"]))
    feats = resnet18(hyper, imgs)
    flat = [mlp(hyper, f"MLP_{i}", feats) for i in range(3)]
    out = []
    for b in range(imgs.shape[0]):
        params = add_trees(decoder, decoder_deltas(flat[0][b], flat[1][b], flat[2][b], dec))
        params["latents"] = [y[b] for y in latents]
        out.append(cc.forward(params, dec, training, temperature,
                              None if noise is None else [z[b] for z in noise], noise_parameter,
                              frame=False))
    return out


def batch_loss(outs, imgs: torch.Tensor, lmbda: float):
    """(mean loss, mean PSNR, mean latent bpp) over the batch."""
    rows = [cc.rd_loss(d, r, imgs[b], lmbda) for b, (d, r) in enumerate(outs)]
    return tuple(torch.stack([row[i] for row in rows]).mean() for i in range(3))


def _f32_correction(beta: float, count: int) -> float:
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(count))


class WholeNetState:
    """Flat leaves (the hypernet's in ``names`` order, then the decoder's in
    ``template``'s order), Adam's moments and step count."""

    def __init__(self, names, template, leaves, mu=None, nu=None, count: int = 0):
        self.names, self.template = list(names), template
        self.leaves = [t.detach().clone() for t in leaves]
        self.mu = [torch.zeros_like(t) for t in leaves] if mu is None else [m.detach().clone() for m in mu]
        self.nu = [torch.zeros_like(t) for t in leaves] if nu is None else [v.detach().clone() for v in nu]
        self.count = count

    @classmethod
    def initial(cls, hyper: Dict, decoder: Dict) -> "WholeNetState":
        return cls(hyper, decoder, list(hyper.values()) + cc.leaves(decoder))

    def nets(self):
        n = len(self.names)
        return dict(zip(self.names, self.leaves[:n])), cc.rebuild(self.template, self.leaves[n:])


def step(state: WholeNetState, imgs: torch.Tensor, lmbda: float, dec: Dict,
         schedule: Tuple[float, float, float], noise, frozen_rows: int = 0):
    """One training step from ``state`` (left untouched) on ``imgs`` with (lr,
    temperature, noise parameter) and its raw noise (one [B, 1, h, w] tensor
    per grid). Returns (loss, clipped gradient per leaf, the next state).
    ``frozen_rows`` plants a fault for the benchmark's controls: the batch's
    last rows left out of the loss (the mean taken over the rest)."""
    lr, temperature, noise_parameter = schedule
    new = WholeNetState(state.names, state.template, state.leaves, state.mu, state.nu, state.count + 1)
    for t in new.leaves:
        t.requires_grad_(True)
    keep = imgs.shape[0] - frozen_rows
    hyper, decoder = new.nets()
    outs = forward(hyper, decoder, imgs[:keep], dec, True, temperature, [z[:keep] for z in noise],
                   noise_parameter)
    loss = batch_loss(outs, imgs[:keep], lmbda)[0]
    grads = torch.autograd.grad(loss, new.leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(new.leaves, grads)]
    for t in new.leaves:
        t.requires_grad_(False)
    with torch.no_grad():
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        if float(norm) >= GRAD_CLIP:
            grads = [g / norm.float() * GRAD_CLIP for g in grads]
        c1, c2 = _f32_correction(cc.ADAM_B1, new.count), _f32_correction(cc.ADAM_B2, new.count)
        for t, g, m, v in zip(new.leaves, grads, new.mu, new.nu):
            m.mul_(cc.ADAM_B1).add_(g, alpha=1.0 - cc.ADAM_B1)
            v.mul_(cc.ADAM_B2).addcmul_(g, g, value=1.0 - cc.ADAM_B2)
            t.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + cc.ADAM_EPS))
    return float(loss.detach()), grads, new


def trainer_schedule(phase: Dict, batch_size: int, n_samples: int, n_steps: int):
    """(lr, temperature, noise parameter) of the first ``n_steps`` steps of a
    training run of ``n_samples`` samples: the cosine LR on the sample clock
    (with ``schedule_lr``), temperature and noise linear in it."""
    (t0, t1), (n0, n1) = phase["softround_temperature"], phase["noise_parameter"]
    out = []
    for i in range(n_steps):
        frac = i * batch_size / n_samples
        lr = phase["lr"] * 0.5 * (1 + math.cos(math.pi * frac)) if phase["schedule_lr"] else phase["lr"]
        out.append((lr, t0 + frac * (t1 - t0), n0 + frac * (n1 - n0)))
    return out


def train_steps(hyper: Dict, decoder: Dict, batches: Sequence[torch.Tensor], lmbda: float, dec: Dict,
                schedule: Sequence[Tuple[float, float, float]], noises, frozen_rows: int = 0):
    """len(schedule) steps of the whole net from (``hyper``, ``decoder``), step
    i on ``batches[i]`` with ``schedule[i]`` and ``noises[i]``. Returns
    (losses, first clipped gradient per leaf, the state after each step)."""
    state = WholeNetState.initial(hyper, decoder)
    losses, first, states = [], None, []
    for imgs, sched, noise in zip(batches, schedule, noises):
        loss, grads, state = step(state, imgs, lmbda, dec, sched, noise, frozen_rows)
        losses.append(loss)
        first = grads if first is None else first
        states.append(state)
    return losses, first, states


@torch.no_grad()
def evaluate(hyper: Dict, decoder: Dict, imgs: torch.Tensor, lmbda: float, dec: Dict):
    """(mean loss, mean PSNR dB, mean latent bpp) in eval mode."""
    outs = forward(hyper, decoder, imgs, dec, training=False)
    return tuple(float(v) for v in batch_loss(outs, imgs, lmbda))
