"""Repository paths, found from this file: the port's package lies at the
repo's root, beside ``preset_cfg/`` and ``results/``."""

from pathlib import Path

COOLCHIC_REPO_ROOT = Path(__file__).resolve().parents[2]
PRESET_CFG_DIR = COOLCHIC_REPO_ROOT / "preset_cfg"
RESULTS_DIR = COOLCHIC_REPO_ROOT / "results"
