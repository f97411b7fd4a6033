"""Model configuration: one dataclass covering the dense / MoE / SSM /
hybrid families of the assigned architecture pool.

A copy of ``repro/models/config.py`` (framework-free; the port keeps its
own copy rather than import the JAX package).  The port runs the dense
family so far; the other fields are kept so that every configuration of
the registry loads and the unported ones raise where they are used."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # attention
    head_dim: int = 0                # 0 -> d_model // n_heads
    attention: str = "full"          # full | swa
    swa_window: int = 4096
    qkv_bias: bool = False
    rope_theta: float = 10_000.0

    # norms
    norm: str = "rmsnorm"            # rmsnorm | layernorm | nonparametric_ln
    norm_eps: float = 1e-5

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden (0 -> d_ff)
    capacity_factor: float = 1.25
    moe_every: int = 1               # MoE replaces the FFN every k-th layer

    # hybrid (Jamba): one attention layer per `attn_period` layers,
    # the rest are Mamba mixers
    attn_period: int = 0             # 0 -> pure attention (or pure ssm)

    # SSM (mamba / rwkv6)
    ssm_kind: str = ""               # "" | mamba | rwkv6
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    rwkv_head_size: int = 64

    # modality frontend (stubbed per task spec: the dry-run feeds
    # precomputed embeddings for audio / vision)
    modality: str = "text"           # text | audio_stub | vlm_stub

    tie_embeddings: bool = False
    max_seq_len: int = 532_480

    # -- derived -------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_kinds(self) -> Tuple[str, ...]:
        """Mixer kind per layer in one scan group.

        dense/moe: ("attn",); ssm: (ssm_kind,); hybrid: a group of
        ``attn_period`` mixers with the attention layer in the middle
        (Jamba places it at index 4 of each 8-layer block)."""
        if self.family == "ssm":
            return (self.ssm_kind,)
        if self.family == "hybrid" and self.attn_period > 1:
            group = ["mamba"] * self.attn_period
            group[self.attn_period // 2] = "attn"
            return tuple(group)
        return ("attn",)

    def ffn_kinds(self) -> Tuple[str, ...]:
        """FFN kind per layer within one scan group ("mlp" | "moe")."""
        group = len(self.layer_kinds())
        kinds = []
        for i in range(group):
            kinds.append("moe" if (self.n_experts > 0
                                   and (i % self.moe_every
                                        == self.moe_every - 1
                                        or self.moe_every == 1))
                         else "mlp")
        return tuple(kinds)

    @property
    def n_groups(self) -> int:
        g = len(self.layer_kinds())
        assert self.n_layers % g == 0, (self.name, self.n_layers, g)
        return self.n_layers // g

    # -- parameter counting (for roofline MODEL_FLOPS) ---------------------------
    def param_counts(self) -> dict:
        """Analytic parameter counts: total and active-per-token."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        dh = self.head_dim_
        counts = {"embed": V * D, "head": 0 if self.tie_embeddings else D * V}
        total_layer, active_layer = 0, 0
        for kind, ffn in zip(self.layer_kinds() * self.n_groups,
                             self.ffn_kinds() * self.n_groups):
            p = 0
            if kind == "attn":
                H, Hk = self.n_heads, self.n_kv_heads
                p += D * (H * dh) + 2 * D * (Hk * dh) + (H * dh) * D
                if self.qkv_bias:
                    p += (H + 2 * Hk) * dh
            elif kind == "mamba":
                di = self.expand * D
                p += (D * 2 * di            # in_proj
                      + di * self.d_conv    # conv
                      + di * (self.d_state * 2 + di // 16 + 1)  # B,C,dt
                      + di * self.d_state   # A
                      + di                  # D skip
                      + di * D)             # out_proj
            elif kind == "rwkv6":
                dh_r = self.rwkv_head_size
                p += 4 * D * D + D * D      # r,k,v,g,out
                p += 2 * (D * 32 * 5 + D)   # ddlerp loras (approx)
                p += 2 * D * D + D * int(3.5 * D)  # channel mix
            f = 0
            if ffn == "moe":
                fe = self.moe_d_ff or F
                f_all = self.n_experts * 3 * D * fe + D * self.n_experts
                f_act = self.top_k * 3 * D * fe + D * self.n_experts
            else:
                f_all = f_act = 3 * D * F
            total_layer += p + f_all
            active_layer += p + f_act
        counts["layers_total"] = total_layer
        counts["layers_active"] = active_layer
        counts["total"] = counts["embed"] + counts["head"] + total_layer
        counts["active"] = counts["embed"] + counts["head"] + active_layer
        return counts

    # -- smoke-test reduction -------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        group = len(self.layer_kinds())
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=group if self.family == "hybrid" else 2,
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16 if self.n_heads else 0,
            d_ff=128,
            moe_d_ff=64 if self.n_experts else 0,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            vocab_size=256,
            d_state=8,
            expand=2,
            rwkv_head_size=16,
            swa_window=32,
            max_seq_len=128,
        )
