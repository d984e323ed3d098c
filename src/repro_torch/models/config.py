"""Unified model configuration (PyTorch port of ``repro.models.config``).

Same fields, defaults and properties as the reference dataclass, so
``dataclasses.asdict`` of a port config equals the reference's.  The
per-layer block sequence is ``layer_pattern`` repeated/truncated to
``n_layers``:

    'G' — global (full causal) attention block
    'L' — local (sliding-window) attention block
    'B' — bidirectional (encoder) attention block
    'R' — RG-LRU recurrent block (Griffin / RecurrentGemma)
    'M' — Mamba-2 SSD block

The port runs 'G'/'L'/'R'/'M' decoder stacks and trains 'B' encoder
stacks; the other families refuse with ``UnsupportedPatternError`` at init
(``models.model``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

#: dtype strings the configs and KV specs may name
DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
}


def torch_dtype(name: str) -> torch.dtype:
    """Map a dtype string to the torch dtype; raises on unknown names."""
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; want one of {sorted(DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense|moe|ssm|hybrid|vlm|audio
    # Trunk
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None  # default d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1000
    # Attention
    layer_pattern: str = "G"
    sliding_window: int = 1024
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_qk_norm: bool = False
    logit_softcap: float = 0.0
    # Block/act/norm
    act: str = "swiglu"  # swiglu|geglu|gelu
    norm: str = "rmsnorm"  # rmsnorm|layernorm
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    top_k: int = 2
    moe_d_ff: int = 0  # per-expert hidden; 0 -> d_ff
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # SSM (Mamba-2 / SSD  [arXiv:2405.21060])
    ssm_state: int = 128
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    # RG-LRU (Griffin  [arXiv:2402.19427])
    rglru_expand: float = 1.5
    rglru_conv: int = 4
    # Encoder (audio enc-dec; the conv/mel frontend is a stub per spec)
    enc_layers: int = 0
    enc_seq: int = 1500
    # VLM prefix (the ViT encoder + projector is a stub per spec)
    prefix_len: int = 0
    # Numerics
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    # Positional scheme: rope|learned|none
    pos: str = "rope"

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def pattern(self) -> str:
        """Per-layer block types, length n_layers."""
        p = (self.layer_pattern * (self.n_layers // len(self.layer_pattern) + 1))
        return p[: self.n_layers]

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Exact total parameter count, from the port's own initializer
        run on the ``meta`` device (no allocation), cached."""
        return _exact_param_count(self)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top-k experts)."""
        if self.n_experts == 0:
            return self.param_count()
        full_moe = self.n_experts * self._expert_params()
        active_moe = self.top_k * self._expert_params()
        return self.param_count() - len(self.pattern) * (full_moe - active_moe) // 1

    def _attn_params(self) -> int:
        d, h, kv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.hd
        n = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.qkv_bias:
            n += (h + 2 * kv) * hd
        return n

    def _mlp_params(self, dff: int) -> int:
        mult = 3 if self.act in ("swiglu", "geglu") else 2
        return mult * self.d_model * dff

    def _expert_params(self) -> int:
        return self._mlp_params(self.expert_d_ff)

    def _block_params(self, kind: str) -> int:
        d = self.d_model
        norms = 2 * d
        if kind in ("G", "L"):
            mix = self._attn_params()
        elif kind == "R":
            dr = int(self.rglru_expand * d)
            mix = 2 * d * dr + dr * d + self.rglru_conv * dr + 2 * dr * dr // 8 + 2 * dr
        elif kind == "M":
            di = self.ssm_expand * d
            nh = di // self.ssm_head_dim
            mix = d * (2 * di + 2 * self.ssm_state + nh) + self.ssm_conv * (
                di + 2 * self.ssm_state
            ) + di * d + 2 * nh
        else:
            raise ValueError(kind)
        if self.n_experts > 0 and kind in ("G", "L"):
            ff = self.n_experts * self._expert_params() + d * self.n_experts
        else:
            ff = self._mlp_params(self.d_ff)
        if kind == "M":
            ff = 0
            norms = d
        return mix + ff + norms

    def validate(self) -> "ModelConfig":
        # raised, never assert-ed: under python -O a bad config would
        # surface later as a shape error deep inside a layer
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError(
                f"GQA group mismatch: n_heads={self.n_heads} is not a "
                f"multiple of n_kv_heads={self.n_kv_heads}"
            )
        if "M" in self.pattern:
            di = self.ssm_expand * self.d_model
            if di % self.ssm_head_dim != 0:
                raise ValueError(
                    f"SSD inner dim {di} (ssm_expand * d_model) is not a "
                    f"multiple of ssm_head_dim={self.ssm_head_dim}"
                )
        if self.n_experts and not 0 < self.top_k <= self.n_experts:
            raise ValueError(
                f"top_k={self.top_k} must be in [1, n_experts="
                f"{self.n_experts}]"
            )
        return self


@dataclasses.dataclass(frozen=True)
class InputShape:
    """A workload shape (the reference's): sequence length, global batch,
    mode ("train" | "prefill" | "decode") and, to train, DropCompute's M."""

    name: str
    seq_len: int
    global_batch: int
    mode: str
    microbatches: int = 8


@functools.lru_cache(maxsize=64)
def _exact_param_count(cfg: ModelConfig) -> int:
    from . import model as _model  # lazy: avoids an import cycle
    from .transformer import tree_leaves

    params = _model.init_params(cfg, device="meta")
    return sum(x.numel() for x in tree_leaves(params))
