"""Plain PyTorch reference of one Cool-chic image decoder and its training step.

Written from Cool-chic's published description (Orange-OpenSource/Cool-Chic,
v3.4: ``models/arm.py``, ``models/upsampling.py``, ``models/synthesis.py``,
``models/quantizer.py``, ``training/loss.py``) and optax's ``clip_by_global_norm``
and ``scale_by_adam``. It imports nothing of the program under test: one image
at a time, every operation a plain ``torch`` call, float32 unless the caller
switches TF32 on (the control). The parameter layout is the program's
interface (the benchmark builds it and hands the same tensors to both sides):

    {"latents": [[1, H_i, W_i] x n_grids],
     "arm": {"layers": [{"weight", "bias"}, ...]},
     "upsampling": {"ups": [half kernels], "preconcat": [half kernels]},
     "synthesis": {"layers": [{"weight", "bias"}, ...]}}

Departures from the published code, each one that the program shares:
clamps pass half of the gradient at a tie (JAX's ``clip``); the x2
upsampling is two 1-D transposed convolutions over an edge-padded grid.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

# Offsets inside the 9x9 causal window (row-major index) of the 24 context
# pixels: a format constant of the Cool-chic bitstream.
ARM_CONTEXT_24 = (4, 11, 12, 13, 14, 15, 19, 20, 21, 22, 23, 24, 25, 28, 29, 30, 31,
                  32, 33, 34, 36, 37, 38, 39)
ARM_CONTEXTS = {24: ARM_CONTEXT_24}
WINDOW = 9
PAD = WINDOW // 2
PROBA_FLOOR = 2.0 ** -16
ENCODER_GAIN = 16
GRAD_CLIP = 0.1
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
UPS_CORE_8 = (0.0351562, 0.1054687, -0.2617187, -0.8789063)

Params = Dict


def parse_synthesis(layers: Sequence[str], out_channels: int = 3) -> List[Tuple[int, int, bool, bool]]:
    """``"40-1-linear-relu"`` -> (out_ft, kernel, residual, relu); X = out_channels."""
    out = []
    for spec in layers:
        ft, k, mode, act = spec.split("-")
        out.append((out_channels if ft == "X" else int(ft), int(k), mode == "residual", act == "relu"))
    return out


def latent_shapes(height: int, width: int, n_grids: int) -> List[Tuple[int, int, int]]:
    return [(1, math.ceil(height / 2 ** i), math.ceil(width / 2 ** i)) for i in range(n_grids)]


def _lower_clip(x: torch.Tensor, lo: float) -> torch.Tensor:
    return torch.maximum(x, torch.full((), lo, dtype=x.dtype, device=x.device))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.minimum(_lower_clip(x, lo), torch.full((), hi, dtype=x.dtype, device=x.device))


def init_params(generator: torch.Generator, dec: Dict, height: int, width: int, n_images: int,
                device) -> Params:
    """Cool-chic's initialisation for ``n_images`` decoders at once ([B] leading
    axis on every leaf): zero latents; ARM hidden layers zero, head N(0, 1) / 4,
    biases zero; x2 filters the 4-tap core, pre-concat filters a Dirac;
    synthesis linear layers U(-sqrt(k), sqrt(k)) / out^2 with k = 1 / (C_in k^2),
    residual layers zero."""
    b = n_images
    dim, n_hidden = dec["dim_arm"], dec["n_hidden_layers_arm"]
    n_grids = len(dec["n_ft_per_res"])
    latents = [torch.zeros((b, *s), device=device) for s in latent_shapes(height, width, n_grids)]
    arm = [{"weight": torch.zeros(b, dim, dim, device=device), "bias": torch.zeros(b, dim, device=device)}
           for _ in range(n_hidden)]
    head = torch.randn(b, 2, dim, generator=generator, device=device) / 4.0
    arm.append({"weight": head, "bias": torch.zeros(b, 2, device=device)})
    n_half_ups = (dec["ups_k_size"] + 1) // 2
    n_half_pre = (dec["ups_preconcat_k_size"] + 1) // 2
    ups_half = torch.zeros(n_half_ups, device=device)
    ups_half[n_half_ups - 4:] = torch.tensor(UPS_CORE_8, device=device)
    pre_half = torch.zeros(n_half_pre, device=device)
    pre_half[-1] = 1.0
    ups = {"ups": [ups_half.expand(b, -1).clone() for _ in range(n_grids - 1)],
           "preconcat": [pre_half.expand(b, -1).clone() for _ in range(n_grids - 1)]}
    syn, in_ft = [], n_grids
    for out_ft, k, residual, _relu in parse_synthesis(dec["layers_synthesis"]):
        shape = (b, out_ft, in_ft, k, k)
        if residual:
            w = torch.zeros(shape, device=device)
        else:
            bound = math.sqrt(1.0 / (in_ft * k * k))
            w = (torch.rand(shape, generator=generator, device=device) - 0.5) * 2.0 * bound / out_ft ** 2
        syn.append({"weight": w, "bias": torch.zeros(b, out_ft, device=device)})
        in_ft = out_ft
    return {"latents": latents, "arm": {"layers": arm}, "upsampling": ups, "synthesis": {"layers": syn}}


def leaves(tree) -> List[torch.Tensor]:
    """Tensor leaves in a fixed order: dict insertion order, then list order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def rebuild(template, new_leaves: Sequence[torch.Tensor]):
    """``template``'s nested dicts and lists with its leaves taken from ``new_leaves`` in order."""
    it = iter(new_leaves)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v) for v in tree]
        return next(it)
    return walk(template)


def image_params(params: Params, b: int) -> Params:
    """Image b's decoder (the [B] axis dropped), as leaves that require grad."""
    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [pick(v) for v in tree]
        return tree[b].detach().clone()
    return pick(params)


# ---------------------------------------------------------------- forward


def softround(x: torch.Tensor, t: float) -> torch.Tensor:
    f = torch.floor(x)
    return f + 0.5 * torch.tanh((x - f - 0.5) / t) / math.tanh(1.0 / (2.0 * t)) + 0.5


def quantize(x: torch.Tensor, training: bool, temperature: float, noise: torch.Tensor | None,
             noise_parameter: float) -> torch.Tensor:
    """Training: softround(softround(x) + sigma n), n gaussian; eval: round."""
    if not training:
        return torch.round(x)
    return softround(softround(x, temperature) + noise_parameter * noise, temperature)


def arm_contexts(plane: torch.Tensor, dim_arm: int) -> torch.Tensor:
    """[H, W] -> [H*W, dim_arm]: the causal neighbours of each latent, the
    plane zero-padded by 4."""
    h, w = plane.shape
    padded = F.pad(plane, (PAD, PAD, PAD, PAD))
    cols = [padded[i // WINDOW: i // WINDOW + h, i % WINDOW: i % WINDOW + w].reshape(-1)
            for i in ARM_CONTEXTS[dim_arm]]
    return torch.stack(cols, dim=1)


def laplace_cdf(x: torch.Tensor, mu: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    d = x - mu
    return 0.5 - 0.5 * torch.sign(d) * torch.expm1(-torch.abs(d) / scale)


def arm_rate(y_hat: Sequence[torch.Tensor], arm: Params, dim_arm: int) -> torch.Tensor:
    """Bits of every latent, [n_latents] in grid then raster order: a
    residual MLP on the context, a Laplace of the head's (mu, log scale), the
    probability of the latent's unit bin floored at 2^-16."""
    values = torch.cat([y.reshape(-1) for y in y_hat])
    x = torch.cat([arm_contexts(y[0], dim_arm) for y in y_hat], dim=0)
    for layer in arm["layers"][:-1]:
        x = torch.relu(F.linear(x, layer["weight"], layer["bias"]) + x)
    head = arm["layers"][-1]
    out = F.linear(x, head["weight"], head["bias"])
    mu, log_scale = out[:, 0], out[:, 1]
    scale = torch.exp(_clip(log_scale - 4.0, -4.6, 5.0))
    proba = laplace_cdf(values + 0.5, mu, scale) - laplace_cdf(values - 0.5, mu, scale)
    return -torch.log2(_lower_clip(proba, PROBA_FLOOR))


def _symmetric(half: torch.Tensor, k: int) -> torch.Tensor:
    return torch.cat([half, torch.flip(half, (0,))[k % 2:]])


def upsample_x2(x: torch.Tensor, half: torch.Tensor, k: int) -> torch.Tensor:
    """[1, 1, H, W] -> [1, 1, 2H, 2W]: along each axis an edge pad of k/2, a
    transposed convolution of stride 2, and a crop of 2(k/2) - 1 + k/2."""
    taps = _symmetric(half, k)
    p = k // 2
    crop = 2 * p - 1 + k // 2
    h, w = x.shape[-2:]
    y = F.pad(x, (0, 0, p, p), mode="replicate")
    y = F.conv_transpose2d(y, taps.view(1, 1, k, 1), stride=(2, 1))[:, :, crop:crop + 2 * h]
    y = F.pad(y, (p, p, 0, 0), mode="replicate")
    return F.conv_transpose2d(y, taps.view(1, 1, 1, k), stride=(1, 2))[..., crop:crop + 2 * w]


def preconcat(x: torch.Tensor, half: torch.Tensor, k: int) -> torch.Tensor:
    """Separable symmetric odd filter with zero padding, plus the input."""
    taps = _symmetric(half, k)
    y = F.conv2d(x, taps.view(1, 1, k, 1), padding=(k // 2, 0))
    return F.conv2d(y, taps.view(1, 1, 1, k), padding=(0, k // 2)) + x


def upsampling(y_hat: Sequence[torch.Tensor], ups: Params, k: int, k_pre: int) -> torch.Tensor:
    """Latent grids (finest first) -> dense [1, n_grids, H, W], channels in
    grid order: from the coarsest, each step upsamples the running tensor,
    crops it to the next grid and puts the filtered grid before it."""
    grids = [y[None] for y in reversed(y_hat)]  # [1, 1, h, w], coarsest first
    acc = grids[0]
    for i, target in enumerate(grids[1:]):
        # Every channel of the running tensor through the same filter.
        up = upsample_x2(acc.transpose(0, 1), ups["ups"][i], k).transpose(0, 1)
        up = up[..., :target.shape[-2], :target.shape[-1]]
        acc = torch.cat([preconcat(target, ups["preconcat"][i], k_pre), up], dim=1)
    return acc


def synthesis(x: torch.Tensor, syn: Params, layers: Sequence[Tuple[int, int, bool, bool]]) -> torch.Tensor:
    for layer, (_out, k, residual, relu) in zip(syn["layers"], layers):
        p = (k - 1) // 2
        inp = F.pad(x, (p, p, p, p), mode="replicate") if p else x
        out = F.conv2d(inp, layer["weight"], layer["bias"])
        if residual:
            out = out + x
        x = torch.relu(out) if relu else out
    return x


def forward(params: Params, dec: Dict, training: bool, temperature: float = 0.3,
            noise: Sequence[torch.Tensor] | None = None, noise_parameter: float = 0.25,
            frame: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image: (decoded [3, H, W], rate bits [n_latents]). As a frame the
    decoded image is clipped to [0, 1], and in eval rounded to 8-bit levels;
    with ``frame=False`` it is the synthesis output as it stands (what the
    amortized encoder's whole net trains and evaluates on)."""
    y_hat = [quantize(lat * ENCODER_GAIN, training, temperature,
                      None if noise is None else noise[i], noise_parameter)
             for i, lat in enumerate(params["latents"])]
    rate = arm_rate(y_hat, params["arm"], dec["dim_arm"])
    dense = upsampling(y_hat, params["upsampling"], dec["ups_k_size"], dec["ups_preconcat_k_size"])
    out = synthesis(dense, params["synthesis"], parse_synthesis(dec["layers_synthesis"]))[0]
    if not frame:
        return out, rate
    if not training:
        out = torch.round(out * 255.0) / 255.0
    return _clip(out, 0.0, 1.0), rate


def rd_loss(decoded: torch.Tensor, rate: torch.Tensor, target: torch.Tensor, lmbda: float):
    """(loss, PSNR in dB, latent rate in bpp): MSE + lambda * bits / pixels."""
    mse = torch.mean((decoded - target) ** 2)
    bpp = rate.sum() / (target.shape[-2] * target.shape[-1])
    return mse + lmbda * bpp, -10.0 * torch.log10(mse + 1e-10), bpp


# ---------------------------------------------------------------- training


class Adam:
    """optax's chain(clip_by_global_norm(0.1), scale_by_adam()) of one
    decoder, then p -= lr * update."""

    def __init__(self, tensors: List[torch.Tensor]):
        self.mu = [torch.zeros_like(t) for t in tensors]
        self.nu = [torch.zeros_like(t) for t in tensors]
        self.count = 0

    @torch.no_grad()
    def step(self, tensors: List[torch.Tensor], grads: List[torch.Tensor], lr: float) -> List[torch.Tensor]:
        """Update ``tensors`` in place; returns the clipped gradients."""
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        if float(norm) >= GRAD_CLIP:
            grads = [g * (GRAD_CLIP / norm) for g in grads]
        self.count += 1
        c1, c2 = 1.0 - ADAM_B1 ** self.count, 1.0 - ADAM_B2 ** self.count
        for t, g, m, v in zip(tensors, grads, self.mu, self.nu):
            m.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
            v.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
            t.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS))
        return grads


def train_steps(params: Params, b: int, dec: Dict, target: torch.Tensor, lmbda: float,
                schedule: Sequence[Tuple[float, float, float]], noises: Sequence[Sequence[torch.Tensor]],
                frozen: bool = False):
    """Image b of a batch through len(schedule) training steps, each step
    (lr, temperature, noise parameter) with its raw noise (one [1, h, w]
    tensor per grid). Returns (losses, first clipped gradient per leaf,
    parameter leaves after the last step); ``params`` is left untouched.
    ``frozen`` plants a fault for the benchmark's controls: the image is
    left out of the step (zero gradients)."""
    p = image_params(params, b)
    tensors = leaves(p)
    opt = Adam(tensors)
    losses, first_grads = [], None
    for (lr, temperature, noise_parameter), noise in zip(schedule, noises):
        for t in tensors:
            t.requires_grad_(True)
        decoded, rate = forward(p, dec, True, temperature, noise, noise_parameter)
        loss = rd_loss(decoded, rate, target, lmbda)[0]
        grads = torch.autograd.grad(loss, tensors)
        if frozen:
            grads = [torch.zeros_like(g) for g in grads]
        for t in tensors:
            t.requires_grad_(False)
        clipped = opt.step(tensors, list(grads), lr)
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = [g.clone() for g in clipped]
    return losses, first_grads, [t.clone() for t in tensors]


@torch.no_grad()
def evaluate_image(p: Params, dec: Dict, target: torch.Tensor, lmbda: float):
    """(loss, PSNR dB, latent bpp) of one decoder in eval mode."""
    decoded, rate = forward(p, dec, training=False)
    return tuple(float(v) for v in rd_loss(decoded, rate, target, lmbda))


def evaluate(params: Params, b: int, dec: Dict, target: torch.Tensor, lmbda: float):
    """(loss, PSNR dB, latent bpp) of image b's decoder in eval mode."""
    return evaluate_image(image_params(params, b), dec, target, lmbda)


# A validation sets a record with a lower loss and a rate at most this much
# higher (bpp) or a PSNR more than this much higher (dB).
RECORD_BPP, RECORD_PSNR = 0.001, 0.001


def first_block(params: Params, b: int, dec: Dict, phase: Dict, target: torch.Tensor, lmbda: float,
                noises: Sequence[Sequence[torch.Tensor]], frozen: bool = False):
    """Image b through the first validation block of a training phase whose
    block is ``len(noises)`` steps long, as the encoder runs it: validate,
    take the steps at the block's schedule (the cosine LR and the linear
    temperature and noise schedules at their start, as they are stepped once
    per block), validate, and keep the trained decoder only where it sets a
    record. Returns (losses, first clipped gradient per leaf, the kept
    decoder's leaves, whether it was a record); ``frozen`` as in
    ``train_steps``."""
    start = evaluate(params, b, dec, target, lmbda)
    schedule = [(phase["lr"], phase["softround_temperature"][0], phase["noise_parameter"][0])] * len(noises)
    losses, grads, stepped = train_steps(params, b, dec, target, lmbda, schedule, noises, frozen)
    end = evaluate_image(rebuild(image_params(params, b), stepped), dec, target, lmbda)
    record = end[0] < start[0] and (end[2] - start[2] < RECORD_BPP or end[1] - start[1] > RECORD_PSNR)
    return losses, grads, stepped if record else leaves(image_params(params, b)), record
