"""Architecture registry (PyTorch port of ``repro.configs``).

Each module exposes ``config()`` (the exact published architecture) and
``smoke_config()`` (a reduced same-family variant for CPU tests).  The
port carries every config of the reference's registry, in its order;
``PAPER_MODELS`` are the paper's own BERT models, as in the reference.
``mamba2_tiny``, ``hybrid_tiny`` and ``moe_tiny`` (CPU-sized 'M', 'R' and
MoE configs for the serving parity tests) stay out of ``ARCHITECTURES``,
as in the reference.
"""
from __future__ import annotations

import importlib
from typing import List

ARCHITECTURES: List[str] = [
    "mamba2_130m",
    "internlm2_1_8b",
    "recurrentgemma_2b",
    "qwen2_5_3b",
    "mixtral_8x22b",
    "internvl2_1b",
    "starcoder2_7b",
    "qwen3_moe_235b_a22b",
    "gemma3_27b",
    "whisper_tiny",
]

# The paper's own models (DropCompute §5: BERT-Large + BERT-1.5B); encoder
# stacks the port trains and never serves
PAPER_MODELS: List[str] = ["bert_large", "bert_1_5b"]


def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str):
    return importlib.import_module(f"repro_torch.configs.{_norm(name)}").config()


def get_smoke_config(name: str):
    return importlib.import_module(f"repro_torch.configs.{_norm(name)}").smoke_config()


def all_configs():
    return {a: get_config(a) for a in ARCHITECTURES}
