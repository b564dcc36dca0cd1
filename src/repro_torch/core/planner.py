"""Model → GeMV workload → per-matrix Cambricon-LLM plans.

``model_matrices`` enumerates every weight matrix a model streams during
decode (the paper's unit of work: >95% of single-batch decode is GeMV).
``plan_model`` applies the §V tiling/α-split to each matrix and aggregates the
analytic per-token time; ``sim/llm_perf.py`` runs the same plans through the
event-driven channel simulator for the faithful numbers.

The port's copy of ``repro.core.planner`` (pure Python; the port imports
nothing of the JAX package).  Its figures describe the paper's edge hardware
and models; none of them times the H100.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hw import FlashSpec, NPUSpec
from repro_torch.core import tiling


@dataclasses.dataclass(frozen=True)
class GemvMatrix:
    """One distinct weight matrix shape in the model.

    ``count``        — stored instances (contributes to capacity/params).
    ``active_count`` — instances streamed per decoded token (MoE: top-k routed
                       + shared; zamba2 shared block: one stored copy streamed
                       at every invocation).
    """

    name: str
    h: int  # output dim (GeMV result length)
    w: int  # input dim
    count: int
    active_count: int = -1  # -1 -> == count
    is_expert: bool = False

    def __post_init__(self):
        if self.active_count < 0:
            object.__setattr__(self, "active_count", self.count)

    @property
    def params(self) -> int:
        return self.h * self.w * self.count

    @property
    def active_params(self) -> int:
        return self.h * self.w * self.active_count


def _attn_matrices(cfg: ModelConfig, n_layers: int, prefix: str = "",
                   active_mult: int = 1, stored: int | None = None) -> list[GemvMatrix]:
    stored = n_layers if stored is None else stored
    active = n_layers * active_mult
    qkv_out = cfg.n_heads * cfg.d_head
    kv_out = cfg.n_kv_heads * cfg.d_head
    return [
        GemvMatrix(prefix + "attn.q", qkv_out, cfg.d_model, stored, active),
        GemvMatrix(prefix + "attn.k", kv_out, cfg.d_model, stored, active),
        GemvMatrix(prefix + "attn.v", kv_out, cfg.d_model, stored, active),
        GemvMatrix(prefix + "attn.o", cfg.d_model, qkv_out, stored, active),
    ]


def _ffn_matrices(cfg: ModelConfig, d_ff: int, n_layers: int, prefix: str = "",
                  active_mult: int = 1, stored: int | None = None) -> list[GemvMatrix]:
    stored = n_layers if stored is None else stored
    active = n_layers * active_mult
    mats = []
    if cfg.gated_ffn:
        mats.append(GemvMatrix(prefix + "ffn.gate", d_ff, cfg.d_model, stored, active))
    mats.append(GemvMatrix(prefix + "ffn.up", d_ff, cfg.d_model, stored, active))
    mats.append(GemvMatrix(prefix + "ffn.down", cfg.d_model, d_ff, stored, active))
    return mats


def _moe_matrices(cfg: ModelConfig, n_moe_layers: int) -> list[GemvMatrix]:
    mats = [GemvMatrix("moe.router", cfg.n_experts, cfg.d_model, n_moe_layers)]
    gate_mats = 2 if cfg.gated_ffn else 1
    # routed experts: stored n_experts per layer, active top_k per layer
    for nm, h, w in [("gate", cfg.moe_d_ff, cfg.d_model),
                     ("up", cfg.moe_d_ff, cfg.d_model),
                     ("down", cfg.d_model, cfg.moe_d_ff)][2 - gate_mats:]:
        mats.append(GemvMatrix(
            f"moe.expert.{nm}", h, w,
            count=n_moe_layers * cfg.n_experts,
            active_count=n_moe_layers * cfg.top_k, is_expert=True))
        if cfg.n_shared_experts:
            mats.append(GemvMatrix(
                f"moe.shared.{nm}", h, w,
                count=n_moe_layers * cfg.n_shared_experts))
    return mats


def _mla_matrices(cfg: ModelConfig, n_layers: int) -> list[GemvMatrix]:
    qk_head = cfg.qk_nope_dim + cfg.qk_rope_dim
    return [
        GemvMatrix("mla.q", cfg.n_heads * qk_head, cfg.d_model, n_layers),
        GemvMatrix("mla.kv_a", cfg.kv_lora_rank + cfg.qk_rope_dim, cfg.d_model, n_layers),
        GemvMatrix("mla.kv_b", cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim),
                   cfg.kv_lora_rank, n_layers),
        GemvMatrix("mla.o", cfg.d_model, cfg.n_heads * cfg.v_head_dim, n_layers),
    ]


def _ssm_matrices(cfg: ModelConfig, n_layers: int) -> list[GemvMatrix]:
    d_in = cfg.d_inner
    proj_out = 2 * d_in + 2 * cfg.ssm_ngroups * cfg.ssm_state + cfg.ssm_nheads
    return [
        GemvMatrix("ssm.in_proj", proj_out, cfg.d_model, n_layers),
        GemvMatrix("ssm.out_proj", cfg.d_model, d_in, n_layers),
    ]


def model_matrices(cfg: ModelConfig) -> list[GemvMatrix]:
    mats: list[GemvMatrix] = []
    f = cfg.family
    if f in ("dense", "vlm"):
        mats += _attn_matrices(cfg, cfg.n_layers)
        mats += _ffn_matrices(cfg, cfg.d_ff, cfg.n_layers)
    elif f == "moe":
        mats += _attn_matrices(cfg, cfg.n_layers)
        mats += _moe_matrices(cfg, cfg.n_layers)
    elif f == "mla_moe":
        mats += _mla_matrices(cfg, cfg.n_layers)
        n_moe = cfg.n_layers - cfg.first_k_dense
        if cfg.first_k_dense:
            mats += _ffn_matrices(cfg, cfg.dense_d_ff, cfg.first_k_dense, "dense.")
        mats += _moe_matrices(cfg, n_moe)
    elif f == "audio":
        # encoder weights: stored, but not streamed per decoded token
        mats += _attn_matrices(cfg, cfg.n_encoder_layers, "enc.", active_mult=0)
        mats += _ffn_matrices(cfg, cfg.d_ff, cfg.n_encoder_layers, "enc.", active_mult=0)
        mats += _attn_matrices(cfg, cfg.n_layers, "dec.")
        # cross attention: k/v applied to encoder states at prefill only
        qkv_out = cfg.n_heads * cfg.d_head
        mats += [
            GemvMatrix("dec.xattn.q", qkv_out, cfg.d_model, cfg.n_layers),
            GemvMatrix("dec.xattn.k", qkv_out, cfg.d_model, cfg.n_layers, 0),
            GemvMatrix("dec.xattn.v", qkv_out, cfg.d_model, cfg.n_layers, 0),
            GemvMatrix("dec.xattn.o", cfg.d_model, qkv_out, cfg.n_layers),
        ]
        mats += _ffn_matrices(cfg, cfg.d_ff, cfg.n_layers, "dec.")
    elif f == "hybrid":
        mats += _ssm_matrices(cfg, cfg.n_layers)
        n_invocations = cfg.n_layers // cfg.shared_attn_every
        mats += _attn_matrices(cfg, 1, "shared.", active_mult=n_invocations)
        mats += _ffn_matrices(cfg, cfg.d_ff, 1, "shared.", active_mult=n_invocations)
    elif f == "ssm":
        mats += _ssm_matrices(cfg, cfg.n_layers)
    else:
        raise ValueError(f"unknown family {f!r}")
    # LM head: one GeMV per token (tied or not, it is streamed).
    mats.append(GemvMatrix("lm_head", cfg.vocab_size, cfg.d_model, 1))
    if not cfg.tie_embeddings:
        # embedding table: stored; lookup is a row-gather, not a streamed GeMV
        mats.append(GemvMatrix("embed", cfg.vocab_size, cfg.d_model, 1, 0))
    return mats


# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelPlan:
    cfg: ModelConfig
    flash: FlashSpec
    bytes_per_elem: float
    plans: tuple[tuple[GemvMatrix, tiling.MatrixPlan], ...]

    @property
    def stored_bytes(self) -> float:
        return sum(m.params for m, _ in self.plans) * self.bytes_per_elem

    @property
    def streamed_bytes_per_token(self) -> float:
        return sum(m.active_params for m, _ in self.plans) * self.bytes_per_elem

    def analytic_token_time(self, npu: NPUSpec | None = None,
                            seq_len: int = 1024) -> float:
        """Sum of per-matrix GeMV times + NPU-side attention/KV-cache time."""
        npu = npu or NPUSpec()
        t = 0.0
        for mat, plan in self.plans:
            t += mat.active_count * tiling.matrix_time_analytic(plan, self.flash, npu)
        t += kv_cache_time(self.cfg, seq_len, npu)
        return t


def kv_cache_time(cfg: ModelConfig, seq_len: int, npu: NPUSpec) -> float:
    """DRAM-side time: stream the KV cache (or SSM state) once per token."""
    kv_bytes = kv_cache_bytes(cfg, seq_len, batch=1)
    return kv_bytes / npu.dram_bw


def kv_cache_bytes(cfg: ModelConfig, seq_len: int, batch: int,
                   bytes_per_elem: int = 2) -> int:
    """KV cache (or SSM state) footprint for ``batch`` sequences."""
    f = cfg.family
    if f == "ssm":
        # state: (nheads, headdim, state) + rolling conv window, per layer
        per_layer = (cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state
                     + cfg.ssm_conv * (cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state))
        return batch * cfg.n_layers * per_layer * bytes_per_elem
    if f == "hybrid":
        ssm_state = (cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state
                     + cfg.ssm_conv * (cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state))
        n_inv = cfg.n_layers // cfg.shared_attn_every
        attn_kv = 2 * n_inv * cfg.n_kv_heads * cfg.d_head * seq_len
        return batch * (cfg.n_layers * ssm_state + attn_kv) * bytes_per_elem
    if f == "mla_moe":
        per_tok = cfg.kv_lora_rank + cfg.qk_rope_dim  # compressed MLA cache
        return batch * cfg.n_layers * per_tok * seq_len * bytes_per_elem
    if f == "audio":
        self_kv = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.d_head * seq_len
        cross_kv = 2 * cfg.n_layers * cfg.n_heads * cfg.d_head * cfg.encoder_seq
        return batch * (self_kv + cross_kv) * bytes_per_elem
    return batch * 2 * cfg.n_layers * cfg.n_kv_heads * cfg.d_head * seq_len * bytes_per_elem


def plan_model(cfg: ModelConfig, flash: FlashSpec,
               bytes_per_elem: float = 1.0,
               alpha_override: float | None = None,
               tile_override: tiling.TileShape | None = None) -> ModelPlan:
    plans = []
    for mat in model_matrices(cfg):
        plans.append((mat, tiling.plan_matrix(
            mat.h, mat.w, flash, bytes_per_elem,
            alpha_override=alpha_override, tile_override=tile_override)))
    return ModelPlan(cfg=cfg, flash=flash, bytes_per_elem=bytes_per_elem,
                     plans=tuple(plans))


# ---------------------------------------------------------------------------
# Ordered per-token execution stream (for the whole-model channel simulation)
# ---------------------------------------------------------------------------


def decode_execution_stream(cfg: ModelConfig) -> list[tuple]:
    """The decode step as an ordered list of execution items.

    Items: ``("gemv", h, w)`` — one weight-matrix GeMV;
           ``("attn",)``      — NPU attention + KV-cache phase (one layer);
           ``("ssm",)``       — NPU SSD state update phase (one layer).
    """
    items: list[tuple] = []
    qkv = cfg.n_heads * cfg.d_head
    kvo = cfg.n_kv_heads * cfg.d_head

    def attn_block():
        items.append(("gemv", qkv, cfg.d_model))
        items.append(("gemv", kvo, cfg.d_model))
        items.append(("gemv", kvo, cfg.d_model))
        items.append(("attn",))
        items.append(("gemv", cfg.d_model, qkv))

    def mla_block():
        qk_head = cfg.qk_nope_dim + cfg.qk_rope_dim
        items.append(("gemv", cfg.n_heads * qk_head, cfg.d_model))
        items.append(("gemv", cfg.kv_lora_rank + cfg.qk_rope_dim, cfg.d_model))
        items.append(("gemv", cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim),
                      cfg.kv_lora_rank))
        items.append(("attn",))
        items.append(("gemv", cfg.d_model, cfg.n_heads * cfg.v_head_dim))

    def ffn_block(d_ff: int):
        if cfg.gated_ffn:
            items.append(("gemv", d_ff, cfg.d_model))
        items.append(("gemv", d_ff, cfg.d_model))
        items.append(("gemv", cfg.d_model, d_ff))

    def moe_block():
        items.append(("gemv", cfg.n_experts, cfg.d_model))  # router
        for _ in range(cfg.top_k + cfg.n_shared_experts):
            ffn_block(cfg.moe_d_ff)

    def ssm_block():
        d_in = cfg.d_inner
        proj = 2 * d_in + 2 * cfg.ssm_ngroups * cfg.ssm_state + cfg.ssm_nheads
        items.append(("gemv", proj, cfg.d_model))
        items.append(("ssm",))
        items.append(("gemv", cfg.d_model, d_in))

    f = cfg.family
    if f in ("dense", "vlm"):
        for _ in range(cfg.n_layers):
            attn_block()
            ffn_block(cfg.d_ff)
    elif f == "moe":
        for _ in range(cfg.n_layers):
            attn_block()
            moe_block()
    elif f == "mla_moe":
        for i in range(cfg.n_layers):
            mla_block()
            if i < cfg.first_k_dense:
                ffn_block(cfg.dense_d_ff)
            else:
                moe_block()
    elif f == "audio":
        for _ in range(cfg.n_layers):  # decoder-only weights stream per token
            attn_block()  # self attention
            items.append(("gemv", qkv, cfg.d_model))  # cross-attn q
            items.append(("attn",))                   # cross attention
            items.append(("gemv", cfg.d_model, qkv))  # cross-attn o
            ffn_block(cfg.d_ff)
    elif f == "hybrid":
        for i in range(cfg.n_layers):
            ssm_block()
            if cfg.shared_attn_every and (i + 1) % cfg.shared_attn_every == 0:
                attn_block()
                ffn_block(cfg.d_ff)
    elif f == "ssm":
        for _ in range(cfg.n_layers):
            ssm_block()
    else:
        raise ValueError(f)
    items.append(("gemv", cfg.vocab_size, cfg.d_model))  # lm head
    return items
