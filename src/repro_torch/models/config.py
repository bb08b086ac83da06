"""Model configuration schema for the assigned architecture zoo.

Port of ``repro.models.config``, field for field; ``activation_dtype``
gives a torch dtype.

One generic decoder (plus optional encoder) covers all ten architectures via
a *period pattern*: layers repeat a short static block pattern (e.g. gemma3's
5 local + 1 global sliding-window period, jamba's 7 mamba + 1 attention
period), which lets the layer stack compile as ``lax.scan`` over period-blocks
with a compact HLO (the port runs the layers as a Python loop).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_zloss: float = 1e-3
    every: int = 1           # MoE every N layers (jamba: 2), dense otherwise


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256         # SSD chunk length


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    seq_len: int             # e.g. whisper's 1500 mel frames (stubbed embeds)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                      # 0 => d_model // n_heads
    # layer pattern, repeated every len(pattern) layers; entries:
    #   "attn" | "local" (sliding window) | "mamba"
    pattern: Sequence[str] = ("attn",)
    window: int = 1024                     # sliding window for "local"
    rope: str = "rope"                     # "rope" | "rope2d" | "mrope" | "none"
    rope_theta: float = 10_000.0
    logit_softcap: float = 0.0             # gemma-style final softcap
    scale_embed: bool = False              # gemma: x * sqrt(d_model)
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None  # enc-dec (whisper): cross-attn on
    frontend: str = "none"                 # "none" | "audio_stub" | "vision_stub"
    n_patches: int = 256                   # vision stub patch count
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    # §Perf knobs (EXPERIMENTS.md): "dense" materializes S x T scores;
    # "banded" computes sliding-window layers block-banded (exact, O(S·w))
    attn_impl: str = "dense"
    # ZeRO-3 weight-gather granularity: "off" | "step" (whole tree gathered
    # once per step — small/mid models) | "block" (per scan block inside the
    # layer loop — models whose gathered weights exceed HBM, e.g. jamba-398B)
    zero3: str = "off"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_layers % len(self.pattern) == 0, \
            f"{self.name}: n_layers {self.n_layers} % period {len(self.pattern)}"

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_blocks(self) -> int:
        return self.n_layers // self.period

    @property
    def activation_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        for kind in self.pattern:
            blocks = self.n_layers // self.period
            if kind == "mamba" and self.ssm is not None:
                s = self.ssm
                d_in = s.expand * d
                n_heads = d_in // s.head_dim
                # in_proj (x, z, B, C, dt) + conv + out_proj + norms
                per = d * (2 * d_in + 2 * s.n_groups * s.d_state + n_heads)
                per += s.conv_width * (d_in + 2 * s.n_groups * s.d_state)
                per += d_in * d + n_heads * 2 + d_in + 2 * d
                total += per * blocks
            else:
                # attention
                hd = self.head_dim
                per = d * (self.n_heads * hd + 2 * self.n_kv * hd) \
                    + self.n_heads * hd * d
                if self.encoder is not None:
                    per *= 2                 # + cross attention
                per += 2 * d                 # norms
                total += per * blocks
            # FFN / MoE follows EVERY layer kind (jamba: after mamba too)
            total += self._ffn_params_per_layer() * blocks
        if self.encoder is not None:
            d = self.d_model
            enc_per = d * (self.n_heads * self.head_dim * 2 + 2 * self.n_kv * self.head_dim)
            enc_per += 3 * d * self.d_ff + 2 * d
            total += self.encoder.n_layers * enc_per
        return total

    def _ffn_params_per_layer(self) -> int:
        d = self.d_model
        if self.moe is None:
            return 3 * d * self.d_ff        # gated (wi, wg, wo)
        m = self.moe
        dense_layers = (m.every - 1) / m.every
        moe_layers = 1.0 / m.every
        per_moe = m.n_experts * 3 * d * m.d_ff_expert + d * m.n_experts
        per_moe += m.n_shared * 3 * d * (m.d_ff_shared or m.d_ff_expert)
        per_dense = 3 * d * self.d_ff if self.d_ff else per_moe
        return int(moe_layers * per_moe + dense_layers * (per_dense if m.every > 1 else 0))

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        d = self.d_model
        moe_layers = self.n_layers // m.every
        unused = m.n_experts - m.top_k
        full -= moe_layers * unused * 3 * d * m.d_ff_expert
        return full
