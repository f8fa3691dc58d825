"""Configuration of one encode run (an image, or a ``.yuv`` video), and of a
hypernet training run.

Counterpart of the CLI part of ``coolchic_tpu/utils/types.py``
(``DecoderConfig``, ``EncoderConfig``, ``RunConfig``, ``UserConfig``,
``HyperNetParams``, ``HyperNetConfig``, ``HypernetRunConfig``), as plain
dataclasses. Decoder configs are read from ``cfg/dec/*.yaml``; the training
recipe from ``preset_cfg/*.yaml`` (``train/presets.py``). A ``UserConfig``
YAML gives ``input``, ``lmbda`` and ``dec_cfg`` each as a value or a list and
expands into the cartesian product of runs. A ``HypernetRunConfig`` YAML is
read by ``load_config``.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field, fields, replace
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Type, TypeVar

import torch

from coolchic_tpu_torch.models.config import CoolChicConfig
from coolchic_tpu_torch.train.presets import Preset, load_preset


@dataclass
class DecoderConfig:
    """Decoder architecture descriptor (the default is the flagship width)."""

    config_name: Optional[str] = None
    layers_synthesis: str = "40-1-linear-relu,X-1-linear-none,X-3-residual-relu,X-3-residual-none"
    arm: str = "24,2"
    ups_k_size: int = 8
    ups_preconcat_k_size: int = 7
    n_ft_per_res: str = "1,1,1,1,1,1,1"
    encoder_gain: int = 16

    @classmethod
    def from_dict(cls, d: Dict[str, Any], where: str = "") -> "DecoderConfig":
        return cls(**_known_fields(cls, d, f"decoder config{where}"))

    @classmethod
    def from_yaml(cls, path: str | Path) -> "DecoderConfig":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {}, f" in {path}")

    @property
    def dim_arm(self) -> int:
        return int(self.arm.split(",")[0])

    @property
    def n_hidden_layers_arm(self) -> int:
        return int(self.arm.split(",")[1])

    def to_coolchic_config(
        self, img_size: Tuple[int, int], out_channels: int = 3, frame_data_type: str = "rgb"
    ) -> CoolChicConfig:
        layers = tuple(x for x in self.layers_synthesis.split(",") if x != "")
        n_ft = tuple(int(x) for x in self.n_ft_per_res.split(",") if x != "")
        if not layers:
            raise ValueError("Synthesis should have at least one layer.")
        if set(n_ft) != {1}:
            raise ValueError(f"n_ft_per_res should only contain 1. Found {self.n_ft_per_res}")
        return CoolChicConfig(
            img_size=img_size,
            layers_synthesis=layers,
            n_ft_per_res=n_ft,
            dim_arm=self.dim_arm,
            n_hidden_layers_arm=self.n_hidden_layers_arm,
            encoder_gain=self.encoder_gain,
            ups_k_size=self.ups_k_size,
            ups_preconcat_k_size=self.ups_preconcat_k_size,
            out_channels=out_channels,
            frame_data_type=frame_data_type,
        )


@dataclass
class EncoderConfig:
    """Training recipe of a run: a named preset of ``preset_cfg/``, or a
    recipe given inline (a dict of the preset files' layout), whose first
    phase lasts ``n_itr`` iterations when given; for a ``.yuv`` input, the
    coding structure of its GOP (``intra_period`` inter frames after the
    intra frame, P frames every ``p_period``; 0 for ``max(intra_period, 1)``).
    A config file names exactly one of ``recipe`` and ``std_recipe_name``."""

    # A key of the JAX package's YAML files (``cfg/enc/*.yaml``) that nothing
    # reads: the recipe's phases set their learning rates. Read and dropped.
    IGNORED_KEYS = ("start_lr",)

    std_recipe_name: Optional[str] = "c3x"
    n_itr: Optional[int] = None
    n_train_loops: int = 1
    recipe: Optional[Preset] = None
    intra_period: int = 0
    p_period: int = 0

    def __post_init__(self):
        if self.recipe is None:
            self.recipe = load_preset(self.std_recipe_name, self.n_itr)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EncoderConfig":
        kw = _known_fields(
            cls, {k: v for k, v in d.items() if k not in cls.IGNORED_KEYS}, "encoder config")
        recipe, name = kw.get("recipe"), kw.get("std_recipe_name")
        if not recipe and not name:
            raise ValueError("One of 'recipe' or 'std_recipe_name' must be provided.")
        if recipe and name:
            raise ValueError("Only one of 'recipe' or 'std_recipe_name' must be provided.")
        if recipe:
            kw["recipe"] = Preset.from_dict(recipe).with_first_phase_itr(kw.get("n_itr"))
            kw["std_recipe_name"] = None
        return cls(**kw)


@dataclass
class RunConfig:
    input: Path
    lmbda: float = 1e-3
    workdir: Optional[Path] = None
    output: Optional[Path] = None  # the .cool bitstream
    enc_cfg: EncoderConfig = field(default_factory=EncoderConfig)
    dec_cfg: DecoderConfig = field(default_factory=DecoderConfig)


def _known_fields(cls, d: Dict[str, Any], what: str) -> Dict[str, Any]:
    unknown = set(d) - {f.name for f in fields(cls)}
    if unknown:
        raise ValueError(f"unknown {what} fields {sorted(unknown)}")
    return dict(d)


def _as_list(value: Any) -> List[Any]:
    return value if isinstance(value, list) else [value]


@dataclass
class UserConfig:
    """A multi-valued config: ``input``, ``lmbda`` and ``dec_cfg`` are lists
    (a single value in the YAML is a list of one) and ``get_run_configs``
    expands them into runs."""

    input: List[Path]
    enc_cfg: EncoderConfig
    dec_cfg: List[DecoderConfig]
    lmbda: List[float] = field(default_factory=lambda: [1e-3])
    output: Optional[Path] = None
    workdir: Optional[Path] = None

    # Keys of the JAX package's user config that do nothing here, as they do
    # nothing in its CLI: read and dropped.
    IGNORED_KEYS = ("job_duration_min", "disable_wandb", "load_models", "user_tag")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "UserConfig":
        kw = _known_fields(
            cls, {k: v for k, v in d.items() if k not in cls.IGNORED_KEYS}, "user config")
        for key in ("input", "enc_cfg", "dec_cfg"):
            if key not in kw:
                raise ValueError(f"the user config needs '{key}'")
        kw["input"] = [Path(p) for p in _as_list(kw["input"])]
        if "lmbda" in kw:
            kw["lmbda"] = [float(v) for v in _as_list(kw["lmbda"])]
        kw["enc_cfg"] = EncoderConfig.from_dict(kw["enc_cfg"])
        kw["dec_cfg"] = [DecoderConfig.from_dict(c) for c in _as_list(kw["dec_cfg"])]
        for key in ("output", "workdir"):
            if kw.get(key) is not None:
                kw[key] = Path(kw[key])
        return cls(**kw)

    @classmethod
    def from_yaml(cls, path: str | Path) -> "UserConfig":
        import yaml

        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f) or {})

    def get_run_configs(self) -> List[RunConfig]:
        """The cartesian product input x lmbda x dec_cfg, the last varying
        fastest; every run shares ``enc_cfg``, ``output`` and ``workdir``."""
        return [
            RunConfig(input=inp, lmbda=lmbda, workdir=self.workdir, output=self.output,
                      enc_cfg=self.enc_cfg, dec_cfg=replace(dec_cfg))
            for inp, lmbda, dec_cfg in itertools.product(self.input, self.lmbda, self.dec_cfg)
        ]


@dataclass
class HyperNetParams:
    """Widths of one weight head of the hypernet."""

    hidden_dim: int
    n_layers: int
    biases: bool = True
    only_biases: bool = False
    output_activation: Optional[str] = "tanh"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HyperNetParams":
        return cls(**_known_fields(cls, d, "hypernet head config"))


RESNET_OPTIONS = ("resnet18", "resnet50", "resnet101")


@dataclass
class HyperNetConfig:
    """The amortized encoder: its decoder, heads, backbone and patch size."""

    dec_cfg: DecoderConfig
    synthesis: HyperNetParams = field(default_factory=lambda: HyperNetParams(1024, 3))
    arm: HyperNetParams = field(default_factory=lambda: HyperNetParams(1024, 3))
    upsampling: HyperNetParams = field(default_factory=lambda: HyperNetParams(256, 3))
    backbone_arch: str = "resnet18"
    double_backbone: bool = False
    n_hidden_channels: int = 64
    patch_size: Tuple[int, int] = (256, 256)

    def __post_init__(self):
        if self.backbone_arch not in RESNET_OPTIONS:
            raise ValueError(f"backbone_arch must be one of {RESNET_OPTIONS}, "
                             f"found {self.backbone_arch}")
        self.patch_size = tuple(int(v) for v in self.patch_size)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HyperNetConfig":
        kw = _known_fields(cls, d, "hypernet config")
        if "dec_cfg" not in kw:
            raise ValueError("the hypernet config needs 'dec_cfg'")
        kw["dec_cfg"] = DecoderConfig.from_dict(kw["dec_cfg"])
        for key in ("synthesis", "arm", "upsampling"):
            if key in kw:
                kw[key] = HyperNetParams.from_dict(kw[key])
        return cls(**kw)

    @property
    def n_latents(self) -> int:
        return len([x for x in self.dec_cfg.n_ft_per_res.split(",") if x != ""])


@dataclass
class HypernetRunConfig:
    """One hypernet training run (``hypernet_train.py --config``). The
    recipe's first phase is the training phase; a recipe whose name holds
    "hnet" may have no quantization phase."""

    n_samples: int
    recipe: Preset
    hypernet_cfg: HyperNetConfig
    batch_size: int = 1
    lmbda: float = 1e-3
    unfreeze_backbone: int = 0
    workdir: Optional[Path] = None
    model_weights: Optional[Path] = None
    checkpoint: Optional[Path] = None
    disable_wandb: bool = False
    unique_id: Optional[str] = None
    user_tag: Optional[str] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HypernetRunConfig":
        kw = _known_fields(cls, d, "hypernet run config")
        for key in ("n_samples", "recipe", "hypernet_cfg"):
            if key not in kw:
                raise ValueError(f"the hypernet run config needs '{key}'")
        kw["recipe"] = Preset.from_dict(kw["recipe"])
        kw["hypernet_cfg"] = HyperNetConfig.from_dict(kw["hypernet_cfg"])
        if "lmbda" in kw:
            kw["lmbda"] = float(kw["lmbda"])  # YAML reads "1e-3" as a string
        for key in ("workdir", "model_weights", "checkpoint"):
            if kw.get(key) is not None:
                kw[key] = Path(kw[key])
        return cls(**kw)


T = TypeVar("T")


def load_config(config_path: str | Path, config_class: Type[T]) -> T:
    """Read a YAML file into ``config_class`` (``HypernetRunConfig``, or any
    config here with ``from_dict``)."""
    import yaml

    with open(config_path) as stream:
        return config_class.from_dict(yaml.safe_load(stream) or {})


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for and none is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "coolchic_tpu_torch runs on a CUDA device by default, and "
            "torch.cuda.is_available() is False here: pass device='cpu' "
            "(or --device cpu) to run on the CPU"
        )
    return device
