"""Architecture registry: the 10 assigned configs and the shape sets.

A copy of ``repro/configs/__init__.py`` (data only; the port keeps its own
copy rather than import the JAX package).  ``get_config(name)`` works as
in the reference.  ``SHAPES`` gives the serving shapes that
``chip_smoke.py`` times the decode kernel at; the dry-run cell list
(``applicable_cells``) waits for the mesh layer (ROADMAP.md §1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from ..models.config import ModelConfig

from .internlm2_20b import CONFIG as internlm2_20b
from .minitron_4b import CONFIG as minitron_4b
from .olmo_1b import CONFIG as olmo_1b
from .qwen2_1_5b import CONFIG as qwen2_1_5b
from .mixtral_8x7b import CONFIG as mixtral_8x7b
from .phi3_5_moe import CONFIG as phi3_5_moe
from .rwkv6_7b import CONFIG as rwkv6_7b
from .jamba_v0_1 import CONFIG as jamba_v0_1
from .musicgen_medium import CONFIG as musicgen_medium
from .llava_next_34b import CONFIG as llava_next_34b

REGISTRY: Dict[str, ModelConfig] = {
    c.name: c for c in [
        internlm2_20b, minitron_4b, olmo_1b, qwen2_1_5b, mixtral_8x7b,
        phi3_5_moe, rwkv6_7b, jamba_v0_1, musicgen_medium, llava_next_34b,
    ]
}

ARCH_IDS = list(REGISTRY)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
