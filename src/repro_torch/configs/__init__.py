"""Architecture registry: the 10 assigned configs + shape cells (a copy
of ``repro.configs`` that builds the port's ``ModelConfig``).

Every (arch × shape) pair defines one dry-run cell (40 total).
``long_500k`` requires sub-quadratic sequence mixing and is therefore
only applicable to the SSM/hybrid archs (DESIGN.md §4 records the
skips); the inapplicable cells are listed with ``applicable=False`` so
the dry-run report shows them as explicit skips, not omissions.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

from repro_torch.models.config import ModelConfig, reduced_for_smoke

_MODULES = {
    "llama3-8b": "llama3_8b",
    "command-r-plus-104b": "command_r_plus_104b",
    "llama3-405b": "llama3_405b",
    "command-r-35b": "command_r_35b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a27b",
    "zamba2-1.2b": "zamba2_1_2b",
    "whisper-small": "whisper_small",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "qwen2-vl-2b": "qwen2_vl_2b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    """(applicable?, reason-if-not)."""
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, ("full quadratic attention at 524288 context — "
                       "skipped per instructions (DESIGN.md §4)")
    return True, ""


def all_cells() -> List[Tuple[str, str, bool, str]]:
    """[(arch_id, shape_name, applicable, reason)] — the 40 cells."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES:
            ok, why = cell_applicable(cfg, s)
            out.append((a, s, ok, why))
    return out
