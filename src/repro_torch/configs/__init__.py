"""Architecture config registry (the port's copy of ``repro.configs``).

Every architecture id of the reference stays known, so an unknown name and
a name the port has not reached yet fail differently.  Every family is
ported: the dense family (deepseek_7b, mistral_nemo_12b, yi_34b,
starcoder2_15b), the hybrid family (zamba2_2p7b), the VLM (pixtral_12b),
the encoder (hubert_xlarge), the moe family (deepseek_v2_236b with MLA
attention, llama4_maverick_400b) and the xlstm family (xlstm_350m).  An
arch listed in ``_NOT_PORTED`` would make ``get()``/``get_smoke()``
raise ``NotImplementedError`` naming its family (none is listed now; the
gateway answers such an arch with a 501).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig, SHAPES_BY_NAME, ShapeConfig

ARCH_IDS: List[str] = [
    "llama4_maverick_400b",
    "deepseek_v2_236b",
    "xlstm_350m",
    "starcoder2_15b",
    "deepseek_7b",
    "mistral_nemo_12b",
    "yi_34b",
    "pixtral_12b",
    "hubert_xlarge",
    "zamba2_2p7b",
]

_ALIASES = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "xlstm-350m": "xlstm_350m",
    "starcoder2-15b": "starcoder2_15b",
    "deepseek-7b": "deepseek_7b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "yi-34b": "yi_34b",
    "pixtral-12b": "pixtral_12b",
    "hubert-xlarge": "hubert_xlarge",
    "zamba2-2.7b": "zamba2_2p7b",
}

#: arch id -> family, for the archs whose family is not ported yet
_NOT_PORTED: Dict[str, str] = {}


def canonical(name: str) -> str:
    name = _ALIASES.get(name, name).replace("-", "_")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return name


def _module(name: str):
    name = canonical(name)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} ({_NOT_PORTED[name]} family) is not yet ported "
            f"to repro_torch; ported: "
            f"{[a for a in ARCH_IDS if a not in _NOT_PORTED]}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def shape(name: str) -> ShapeConfig:
    return SHAPES_BY_NAME[name]


# --- assigned-cell table: which (arch, shape) cells execute vs. skip -------

def cell_status(arch: str, shape_name: str) -> str:
    """'run' or a skip reason (documented in DESIGN.md §Arch-applicability)."""
    arch = canonical(arch)
    cfg = get(arch)
    if shape_name in ("decode_32k", "long_500k") and cfg.is_encoder:
        return "skip: encoder-only arch has no autoregressive decode"
    if shape_name == "long_500k" and cfg.family not in ("xlstm", "hybrid"):
        return "skip: full-attention arch; 500k ctx needs sub-quadratic mixing"
    return "run"


def all_cells():
    """Yield (arch, shape_name, status) for the full 40-cell assignment."""
    for a in ARCH_IDS:
        for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            yield a, s, cell_status(a, s)
