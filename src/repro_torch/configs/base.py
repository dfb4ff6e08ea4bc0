"""Model configuration system (the port's own copy of ``repro.configs.base``).

One ``ModelConfig`` describes an architecture; the fields, defaults and
registry are the reference's, so a configuration reads the same in both
packages.  Each architecture the port runs has one module here that builds
its exact config (``full()``) plus a reduced smoke-test variant
(``smoke()``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Architecture families
# ---------------------------------------------------------------------------
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
VLM = "vlm"
AUDIO = "audio"


@dataclass(frozen=True)
class ModelConfig:
    # -- identity ----------------------------------------------------------
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""                  # citation from the assignment table

    # -- core dims ---------------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 1024
    vocab_size: int = 32000

    # -- attention flavour ---------------------------------------------------
    qkv_bias: bool = False            # qwen1.5 style
    o_bias: bool = False
    parallel_block: bool = False      # command-r: attn and FFN in parallel
    rope_fraction: float = 1.0        # chatglm3: rope on half the head dims
    rope_theta: float = 10000.0
    sliding_window: int = 0           # 0 = full attention
    # long-context serving variant: ring-buffer window used ONLY for the
    # long_500k shape on otherwise-full-attention archs (see DESIGN.md §5)
    long_context_window: int = 4096

    # -- MLA (deepseek-v2) ---------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # -- MoE -----------------------------------------------------------------
    n_experts: int = 0                # routed experts
    n_shared_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0              # per-expert intermediate
    d_ff_dense: int = 0               # intermediate of dense layers in a MoE stack
    first_dense_layers: int = 0       # deepseek-v2: layer 0 is dense
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # -- SSM / RWKV ----------------------------------------------------------
    ssm_state: int = 0                # mamba state size (hymba)
    ssm_conv: int = 4                 # depthwise conv width in the SSM branch
    rwkv_head_dim: int = 64           # rwkv6 "Finch"
    rwkv_lora: int = 64               # rank of the data-dependent-decay LoRA
    rwkv_chunk: int = 0               # chunked-parallel wkv (0 = step scan)

    # -- encoder/decoder (whisper) -------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_frames: int = 1500              # stubbed audio frontend output length
    frontend_dim: int = 0             # stub embedding dim (== d_model for audio)
    max_target_positions: int = 448

    # -- VLM (internvl) --------------------------------------------------------
    is_vlm: bool = False
    n_patches: int = 256              # stubbed ViT frontend output length
    vit_dim: int = 1024               # InternViT-300M hidden (stub input dim)

    # -- norms / act / misc ----------------------------------------------------
    norm_type: str = "rmsnorm"        # rmsnorm | layernorm
    norm_eps: float = 1e-6
    act: str = "silu"                 # silu (gated) | gelu (plain mlp)
    gated_mlp: bool = True
    tie_embeddings: bool = False
    logit_soft_cap: float = 0.0       # grok uses 30.0
    max_seq_len: int = 8192

    # -- compute -----------------------------------------------------------
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"      # master params (EPS-resident)
    use_pallas: bool = False          # use Pallas flash-attention kernel
    attn_chunk: int = 512             # KV chunk for memory-efficient attention
    # -- beyond-paper perf knobs (see EXPERIMENTS.md §Perf) ------------------
    grouped_decode_attn: bool = False  # GQA decode w/o kv-head expansion
    moe_ep_constraint: bool = False    # sharding constraints on MoE dispatch

    # ------------------------------------------------------------------
    @property
    def n_q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == SSM

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (for roofline MODEL_FLOPS) -----------------
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count.  ``active_only`` counts only the
        per-token-active expert params for MoE (top-k + shared)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == SSM:  # rwkv6
            # time-mix: r,k,v,g,w projections + out  (~6 d^2) + channel mix
            per_layer = 6 * d * d + d * self.d_ff + self.d_ff * d + d * d
        else:
            if self.use_mla:
                r = self.kv_lora_rank
                qd = self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                per_layer += d * qd                      # q proj
                per_layer += d * (r + self.qk_rope_dim)  # kv down + k_rope
                per_layer += r * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                per_layer += self.n_heads * self.v_head_dim * d
            else:
                per_layer += d * self.n_heads * self.d_head        # q
                per_layer += 2 * d * self.n_kv_heads * self.d_head  # k,v
                per_layer += self.n_heads * self.d_head * d         # o
            if self.family == HYBRID:
                dI = self.d_model
                per_layer += 2 * d * dI + dI * self.ssm_state * 2 + dI * d
            # mlp / moe
            if self.n_experts:
                fe = self.d_ff_expert
                n_mats = 3 if self.gated_mlp else 2
                routed = self.n_experts * n_mats * d * fe
                shared = self.n_shared_experts * n_mats * d * fe
                if active_only:
                    routed = self.experts_per_token * n_mats * d * fe
                per_layer += routed + shared + d * self.n_experts
            else:
                n_mats = 3 if self.gated_mlp else 2
                per_layer += n_mats * d * ff
        total = emb + self.n_layers * per_layer
        if self.is_encoder_decoder:
            # encoder layers: self-attn + mlp; decoder already counted has
            # an extra cross-attn block
            enc = self.n_encoder_layers * (4 * d * d + 2 * d * ff)
            xattn = self.n_layers * 4 * d * d
            total += enc + xattn
        if self.first_dense_layers and self.n_experts:
            # first layer(s) use the dense FFN width instead of MoE
            n_mats = 3 if self.gated_mlp else 2
            fe = self.d_ff_expert
            moe_per = (self.n_experts if not active_only else
                       self.experts_per_token) * n_mats * d * fe \
                + self.n_shared_experts * n_mats * d * fe + d * self.n_experts
            dense_per = n_mats * d * (self.d_ff_dense or ff)
            total += self.first_dense_layers * (dense_per - moe_per)
        return int(total)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: dict = {}


def register(arch_id: str, full_fn, smoke_fn):
    _REGISTRY[arch_id] = (full_fn, smoke_fn)


def get_config(arch_id: str, variant: str = "full") -> ModelConfig:
    if arch_id not in _REGISTRY:
        _load_all()
    full_fn, smoke_fn = _REGISTRY[arch_id]
    return full_fn() if variant == "full" else smoke_fn()


# ---------------------------------------------------------------------------
# Input shapes (the reference's, for the sharding rules' batch specs)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def list_archs():
    _load_all()
    return sorted(_REGISTRY.keys())


def _load_all():
    # import registers
    from repro_torch.configs import (bert_large, chatglm3_6b,  # noqa: F401
                                     command_r_35b, deepseek_v2_lite_16b,
                                     granite_3_8b, grok_1_314b,
                                     hymba_1_5b, internvl2_1b,
                                     qwen1_5_110b, rwkv6_1_6b,
                                     whisper_base)
