"""Architecture & shape configuration system.

Every assigned architecture gets one ``<id>.py`` module in this package exposing
``CONFIG: ArchConfig``.  The registry maps ``--arch <id>`` to that config.

Configs are *exact* per the assignment table (public-literature sources recorded
in each file).  ``ArchConfig.reduced()`` produces a same-family shrunken config
for CPU tests; the full configs run on the GPU.

This is the port's own copy of the reference package's configs: every field
equals the reference's (``tests/test_torch_configs.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence


# ---------------------------------------------------------------------------
# Shape configs (shared by all LM-family archs per the assignment)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: (name, seq_len, global_batch, kind)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES: tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


# ---------------------------------------------------------------------------
# Architecture configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared_experts: int = 0
    expert_d_ff: int = 0          # d_ff per routed expert
    shared_d_ff: int = 0          # d_ff per shared expert
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # "ep": experts sharded over the model axis; "tp": d_ff sharded per expert.
    parallelism: str = "ep"


@dataclass(frozen=True)
class HybridConfig:
    """Layer-pattern description for hybrid / mixed-block stacks.

    ``pattern`` is a tuple of block kinds applied cyclically, e.g.
    ``("rec", "rec", "attn")`` for RecurrentGemma's 1:2 local-attn ratio or
    ``("mlstm",)*7 + ("slstm",)`` for xLSTM[7:1].
    """

    pattern: tuple[str, ...]
    window: int = 0               # sliding-attention window (local attn blocks)
    lru_width: int = 0            # RG-LRU recurrence width (0 => d_model)
    conv_width: int = 4           # temporal-conv width in recurrent blocks


@dataclass(frozen=True)
class ArchConfig:
    # -- identity ------------------------------------------------------------
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    source: str                   # public-literature citation string
    # -- transformer backbone (assignment table values) -----------------------
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    # -- family knobs ---------------------------------------------------------
    d_head: int = 0               # 0 => d_model // n_heads
    activation: str = "swiglu"    # swiglu | sq_relu | gelu
    norm: str = "rmsnorm"         # rmsnorm | layernorm | nonparam_ln
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    tie_embeddings: bool = False
    logit_softcap: float = 0.0    # grok/gemma-style tanh soft-capping (0 = off)
    moe: Optional[MoEConfig] = None
    hybrid: Optional[HybridConfig] = None
    # -- enc-dec (whisper) ----------------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    max_source_positions: int = 1500   # whisper: 30 s of audio frames
    # -- modality frontend stubs ----------------------------------------------
    # "none": token ids.  "patch_stub"/"frame_stub": input_specs() provides
    # precomputed patch/frame embeddings of width ``d_model`` (per assignment).
    frontend: str = "none"
    # -- attention complexity class (drives long_500k applicability) ----------
    #   "quadratic": full attention  -> long_500k skipped
    #   "subquadratic": SSM / recurrent / windowed -> long_500k runs
    attention_class: str = "quadratic"
    # -- numerics --------------------------------------------------------------
    dtype: str = "bfloat16"
    # optimizer-moment dtype: "float32" | "bfloat16" | "int8" (block-quantized)
    moment_dtype: str = "float32"

    # -- derived ---------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return max(1, self.n_heads // max(1, self.n_kv_heads))

    def param_count(self) -> int:
        """Analytical parameter count (used for 6ND model-FLOPs and memory math)."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        hd = self.head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        if self.qkv_bias:
            attn += (nq + 2 * nkv) * hd
        if self.moe is not None:
            m = self.moe
            routed = m.n_experts * 3 * d * m.expert_d_ff
            shared = m.n_shared_experts * 3 * d * m.shared_d_ff
            router = d * m.n_experts
            ffn = routed + shared + router
        elif self.activation in ("swiglu", "geglu"):
            ffn = 3 * d * self.d_ff
        else:
            ffn = 2 * d * self.d_ff
        block = attn + ffn
        if self.hybrid is not None:
            block = self._hybrid_block_params()
        emb = V * d * (1 if self.tie_embeddings else 2)
        enc = 0
        if self.is_encoder_decoder:
            # encoder self-attn (MHA, kv == q heads) + ffn + decoder cross-attn
            enc_attn = 4 * d * d
            enc_ffn = 2 * d * self.d_ff
            enc = self.n_encoder_layers * (enc_attn + enc_ffn)
            block += 4 * d * d  # decoder cross-attention
        return L * block + emb + enc

    def _hybrid_block_params(self) -> int:
        """Average per-layer params for pattern-mixed stacks."""
        assert self.hybrid is not None
        d, hd = self.d_model, self.head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        h = self.hybrid
        per_kind = {}
        attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        if self.activation in ("swiglu", "geglu"):
            ffn = 3 * d * self.d_ff
        else:
            ffn = 2 * d * self.d_ff
        per_kind["attn"] = attn + ffn
        w = h.lru_width or d
        # RG-LRU block: in/out proj + gates + conv
        per_kind["rec"] = 2 * d * w + 2 * w * w // 8 + h.conv_width * w + ffn
        # mLSTM: qkv + out + gates; sLSTM: recurrent gates (4 gates, block-diag)
        per_kind["mlstm"] = 4 * d * d + 2 * d
        per_kind["slstm"] = 8 * d * d // max(1, self.n_heads) * self.n_heads // 4 + 4 * d * d
        total = sum(per_kind.get(k, attn + ffn) for k in h.pattern)
        return total // len(h.pattern)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        m = self.moe
        full = self.param_count()
        routed_all = L * m.n_experts * 3 * d * m.expert_d_ff
        routed_active = L * m.top_k * 3 * d * m.expert_d_ff
        return full - routed_all + routed_active

    # -- smoke-test reduction --------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // max(1, self.n_heads))),
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            d_head=16,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2,
                n_shared_experts=min(1, self.moe.n_shared_experts),
                expert_d_ff=32, shared_d_ff=32 if self.moe.n_shared_experts else 0)
        if self.hybrid is not None:
            pat = self.hybrid.pattern
            kw["hybrid"] = dataclasses.replace(
                self.hybrid, window=32, lru_width=64 if self.hybrid.lru_width else 0)
            kw["n_layers"] = len(pat)  # one full pattern period
        if self.is_encoder_decoder:
            kw["n_encoder_layers"] = 2
            kw["max_source_positions"] = 64
        return dataclasses.replace(self, **kw)

    def shapes(self) -> tuple[ShapeConfig, ...]:
        """The shape cells assigned to this arch (incl. inapplicable ones)."""
        return ALL_SHAPES

    def shape_applicable(self, shape: ShapeConfig) -> tuple[bool, str]:
        """(runs?, reason-if-skipped) per assignment rules."""
        if self.is_encoder_decoder and shape.seq_len > 448 \
                and shape.kind != "train":
            return False, ("whisper decoder context is 448 tokens by "
                           "construction; 32k/500k decoder prompts/KV "
                           "inapplicable")
        if shape.name == "long_500k" and self.attention_class == "quadratic":
            return False, "full-attention O(S^2); long-context decode skipped per spec"
        return True, ""

    def effective_seq(self, shape: ShapeConfig) -> int:
        """Decoder sequence actually lowered for this cell.  Whisper's
        decoder is 448 tokens by construction, so train_4k clips the target
        length."""
        if self.is_encoder_decoder:
            return min(shape.seq_len, 448)
        return shape.seq_len
