"""Functional model API of the port: init / forward / paged prefill and
decode for the dense, hybrid and ssm families.

Counterpart of ``repro.models.model`` for the paged serving path:

    init_params(cfg, seed, max_seq, device, dtype)           -> params
    forward(params, cfg, tokens)                    -> logits [B, S, V]
    init_paged_cache(cfg, slots, max_seq, dtype, page_size, num_pages,
                     device)                                 -> cache
    prefill_into_slots(params, cfg, tokens, true_lens, cache, slot_ids)
                                             -> (last_logits [M, V], cache)
    decode_step_paged(params, cfg, token, cache, active)
                                             -> (logits [B, V], cache)
    checkpoint_slot_state(cache, slot) / restore_slot_state(cache, slot, ck)

Params are plain dicts of tensors with the JAX package's key names; where
the JAX package stacks layers on a leading axis the port keeps lists:
``params["layers"][i]`` (dense, ssm), ``params["groups"][g][i]`` and
``params["tail"][i]`` (hybrid, zamba2's Mamba layers; ``tail`` is None when
the layer count divides), beside ``params["shared"]``, the one dense block
every group applies.  The paged cache holds the page pools ``k``/``v``
``[L, P, page, Hkv, Dh]`` (hybrid: one layer per group), the per-slot
lengths ``lens``, for the hybrid family the Mamba state pools ``mamba``
(``conv`` ``[G, every, slots, K-1, C]``, ``state`` ``[G, every, slots, H, P,
N]``) and ``tail`` (``[T, slots, ...]`` or None), and, passed in by the
caller, the block table ``block``.

Where the JAX functions return a new cache, these write the page and state
pools IN PLACE and return a shallow copy of the cache dict with a new
``lens``.  Families without a branch here (moe, vlm, mla_moe, audio, the
parallel-block dense models) raise NotImplementedError; the ssm family has
``forward`` only (its serving needs the wave-mode engine).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (_w4a16_matmul, dense_weight, ffn,
                                       init_ffn, init_linear)

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


MODEL_FAMILIES = ("dense", "hybrid", "ssm")   # init_params, forward
PAGED_FAMILIES = ("dense", "hybrid")          # the paged serving path
# param subtrees the JAX package stacks on leading layer axes, which the
# port keeps as (nested) lists -> the number of those axes
STACKED = {"layers": 1, "groups": 2, "tail": 1}
# rows per float32 lm_head product: a library GEMM may pick its algorithm,
# and so its summation order, by the row count, so every product has this
# many rows (the last block zero-padded) and a row's logits do not depend
# on the batch around it
LM_HEAD_ROWS = 8


def _check_family(cfg: ModelConfig, families: tuple[str, ...]) -> None:
    if cfg.family not in families or cfg.parallel_block:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}"
            f"{' (parallel block)' if cfg.parallel_block else ''} is not "
            f"ported for this function (ported: {', '.join(families)})")


def _init_dense_layer(gen, cfg: ModelConfig, dtype, device) -> dict:
    return {
        "attn_norm": blocks.init_norm(cfg, dtype, device),
        "attn": blocks.init_attn(gen, cfg, dtype, device),
        "ffn_norm": blocks.init_norm(cfg, dtype, device),
        "ffn": init_ffn(gen, cfg, cfg.d_ff, dtype, device),
    }


def init_params(cfg: ModelConfig, seed: int = 0, max_seq: int = 4096,
                device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random weights (bf16 by default) with the JAX package's
    distributions (normal * 0.02 embeddings, normal / sqrt(d_in) linears,
    unit norms), drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device``.  The bits differ from ``jax.random``'s; parity tests carry
    JAX weights over with ``repro_torch.bridge`` instead."""
    _check_family(cfg, MODEL_FAMILIES)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p: dict = {}
    p["embed"] = (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                              dtype=torch.float32, device=dev) * 0.02).to(dtype)
    p["final_norm"] = blocks.init_norm(cfg, dtype, dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size, False,
                                   dtype, dev)
    if cfg.family == "dense":
        p["layers"] = [_init_dense_layer(gen, cfg, dtype, dev)
                       for _ in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        n_groups, every, tail = _hybrid_layout(cfg)
        p["groups"] = [[ssm_mod.init_mamba_block(gen, cfg, dtype, dev)
                        for _ in range(every)] for _ in range(n_groups)]
        p["tail"] = [ssm_mod.init_mamba_block(gen, cfg, dtype, dev)
                     for _ in range(tail)] if tail else None
        p["shared"] = _init_dense_layer(gen, cfg, dtype, dev)
    else:  # ssm
        p["layers"] = [ssm_mod.init_mamba_block(gen, cfg, dtype, dev)
                       for _ in range(cfg.n_layers)]
    if cfg.rope_mode == "learned":
        p["pos_embed"] = (torch.randn((max_seq, cfg.d_model), generator=gen,
                                      dtype=torch.float32, device=dev)
                          * 0.02).to(dtype)
    return p


def lm_head(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """float32 logits.  A W4A16 head goes through the B4 kernel on CUDA
    (the product of x, read in its own dtype, with the dequantized weights,
    which the JAX package materializes first); a float or W8A8 head is
    dequantized to float32, as the JAX package does, and multiplied outside
    any kernel."""
    if cfg.tie_embeddings:
        return _fixed_row_matmul(x.float(), params["embed"].float().T)
    head = params["lm_head"]
    if "w_p4" in head:
        return _w4a16_matmul(head["w_p4"], head["scale4"], x, torch.float32)
    return _fixed_row_matmul(x.float(), dense_weight(head).float())


def _fixed_row_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, V] as products of LM_HEAD_ROWS rows each."""
    xf = x.reshape(-1, x.shape[-1])
    m = xf.shape[0]
    if m == 0:
        return x @ w
    xf = torch.cat([xf, xf.new_zeros(((-m) % LM_HEAD_ROWS, xf.shape[1]))])
    out = torch.cat([xf[i:i + LM_HEAD_ROWS] @ w
                     for i in range(0, len(xf), LM_HEAD_ROWS)])
    return out[:m].reshape(*x.shape[:-1], w.shape[1])


# ---------------------------------------------------------------------------
# full-sequence layer application (prefill): returns the layer's K/V
# ---------------------------------------------------------------------------


def _dense_layer_full(lp, x, cfg: ModelConfig, positions):
    h = blocks.norm(cfg, lp["attn_norm"], x)
    attn_out, k, v = blocks.attn_full(lp["attn"], h, cfg, positions)
    x = x + attn_out
    x = x + ffn(lp["ffn"], blocks.norm(cfg, lp["ffn_norm"], x), cfg.gated_ffn)
    return x, (k, v)


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.rope_mode == "learned":
        x = x + params["pos_embed"][:x.shape[1]][None]
    return x


def _mamba_full(lp, x, cfg: ModelConfig, valid=None):
    out, state = ssm_mod.mamba_block(lp, x, cfg, valid=valid)
    return x + out, state


def forward(params: dict, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced full-sequence logits f32 [B, S, V] (the dense, hybrid
    and ssm branches of the JAX ``forward``): attention runs causally
    through the B3 kernel on CUDA, every Mamba layer's intra-chunk term
    through B6."""
    _check_family(cfg, MODEL_FAMILIES)
    x = _embed(params, cfg, tokens)
    b, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=x.device).expand(b, s)
    if cfg.family == "dense":
        for lp in params["layers"]:
            x, _ = _dense_layer_full(lp, x, cfg, positions)
    elif cfg.family == "hybrid":
        for gp in params["groups"]:
            for lp in gp:
                x, _ = _mamba_full(lp, x, cfg)
            x, _ = _dense_layer_full(params["shared"], x, cfg, positions)
        for lp in params.get("tail") or ():
            x, _ = _mamba_full(lp, x, cfg)
    else:  # ssm
        for lp in params["layers"]:
            x, _ = _mamba_full(lp, x, cfg)
    x = blocks.norm(cfg, params["final_norm"], x)
    return lm_head(params, cfg, x)


# ---------------------------------------------------------------------------
# paged cache
# ---------------------------------------------------------------------------


def supports_paged(cfg: ModelConfig) -> bool:
    """The port pages the dense family's K/V and the hybrid family's
    shared-attention K/V (its Mamba state lives in a slot-indexed pool);
    the other families come later (ssm with the wave-mode engine)."""
    return cfg.family in PAGED_FAMILIES and not cfg.parallel_block


def has_slot_state(cfg: ModelConfig) -> bool:
    """True when the paged cache carries per-slot recurrent state (the
    hybrid family's Mamba conv window + SSM state)."""
    return cfg.family == "hybrid"


def _hybrid_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_groups, layers_per_group, tail_layers) of the zamba2-style stack."""
    every = cfg.shared_attn_every
    n_groups = cfg.n_layers // every
    return n_groups, every, cfg.n_layers - n_groups * every


def init_paged_cache(cfg: ModelConfig, num_slots: int, max_seq: int,
                     dtype: torch.dtype = torch.bfloat16, page_size: int = 16,
                     num_pages: int | None = None,
                     device: str | torch.device = "cuda") -> dict:
    """Block-table KV cache: a shared page pool + per-slot state.

      k/v   [L, P, page, Hkv, Dh]   page pools (page 0 is the null page);
                                    hybrid: L = n_groups, one shared-attn
                                    application per group
      mamba {conv [G, every, slots, K-1, C] (dtype),
             state [G, every, slots, H, P, N] float32}   hybrid only
      tail  the same with a leading [T, slots] axis, or None
      lens  [slots] int32           per-slot valid lengths

    The block table ``[slots, pages_per_slot]`` int32 is kept by the caller
    and passed in as ``cache["block"]``; ``paged_slot_capacity`` is
    ``pages_per_slot * page``.  By default P fits every slot at max_seq.
    """
    _check_family(cfg, PAGED_FAMILIES)
    dev = resolve_device(device)
    pages_per_slot = -(-max_seq // page_size)
    if num_pages is None:
        num_pages = num_slots * pages_per_slot + 1
    n_kv = cfg.n_layers
    out: dict = {}
    if cfg.family == "hybrid":
        n_kv, every, tail = _hybrid_layout(cfg)
        one = ssm_mod.init_mamba_cache(cfg, num_slots, dtype, dev)
        out["mamba"] = {k: torch.zeros((n_kv, every, *v.shape), dtype=v.dtype,
                                       device=dev) for k, v in one.items()}
        out["tail"] = ({k: torch.zeros((tail, *v.shape), dtype=v.dtype,
                                       device=dev) for k, v in one.items()}
                       if tail else None)
    shape = (n_kv, num_pages, page_size, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            **out,
            "lens": torch.zeros((num_slots,), dtype=torch.int32, device=dev)}


def checkpoint_slot_state(cache: dict, slot: int):
    """Snapshot one slot's recurrent state (hybrid Mamba conv window + SSM
    state) as host tensors; None for families without per-slot state."""
    if "mamba" not in cache:
        return None
    out = {"mamba": {k: v[:, :, slot].cpu().clone()
                     for k, v in cache["mamba"].items()}}
    if cache.get("tail") is not None:
        out["tail"] = {k: v[:, slot].cpu().clone()
                       for k, v in cache["tail"].items()}
    return out


def restore_slot_state(cache: dict, slot: int, ckpt) -> dict:
    """Write a ``checkpoint_slot_state`` snapshot back into the slot's rows
    of the state pools (in place); returns the cache."""
    if ckpt is None:
        return cache
    for k, pool in cache["mamba"].items():
        pool[:, :, slot] = ckpt["mamba"][k].to(pool.device, pool.dtype)
    if ckpt.get("tail") is not None and cache.get("tail") is not None:
        for k, pool in cache["tail"].items():
            pool[:, slot] = ckpt["tail"][k].to(pool.device, pool.dtype)
    return cache


def paged_slot_capacity(cache: dict) -> int:
    """Max tokens one slot can hold (pages_per_slot * page_size)."""
    return cache["block"].shape[1] * cache["k"].shape[2]


def _first_rows(slot_ids: torch.Tensor) -> torch.Tensor:
    """Index of the first row of each distinct slot id.  The engine pads a
    prefill group by repeating its first row; the repeats carry the same
    values, but an index_put with duplicate indices is a write race on a
    card, so only these rows are written."""
    uniq, inv = torch.unique(slot_ids, return_inverse=True)
    m = slot_ids.shape[0]
    first = torch.full(uniq.shape, m, dtype=torch.long,
                       device=slot_ids.device)
    return first.scatter_reduce_(0, inv, torch.arange(
        m, device=slot_ids.device), reduce="amin")


def prefill_into_slots(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                       true_lens: torch.Tensor, cache: dict,
                       slot_ids: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """Prefill M requests into M slots of a paged cache, in one pass.

    tokens: [M, Sp] right-padded to a common bucket length; true_lens: [M]
    int32 valid lengths; slot_ids: [M].  Only the named slots' pages
    (already in their block-table rows) and state rows are written.
    Returns (per-request last-valid-position logits [M, V], cache).

    Right-padding keeps every row's positions 0-based; causality keeps the
    pads out of every valid position's attention, and pad K/V land in the
    row's own pages (or the null page past its allocation), masked by
    ``lens``.  The Mamba recurrence would fold trailing pads into the
    state, so (hybrid) pad positions get dt = 0, an identity state update,
    and the decode conv window is gathered at each row's own length.
    """
    _check_family(cfg, PAGED_FAMILIES)
    x = _embed(params, cfg, tokens)
    m, s = x.shape[0], x.shape[1]
    positions = torch.arange(s, device=x.device).expand(m, s)
    true_lens = true_lens.to(device=x.device, dtype=torch.int32)
    slot_ids = slot_ids.to(device=x.device).long()
    rows = _first_rows(slot_ids)
    slots = slot_ids[rows]
    page = cache["k"].shape[2]
    n_pages = -(-s // page)
    pids = cache["block"][slots][:, :n_pages].long()      # [U, n_pages]

    def write_kv(li: int, k: torch.Tensor, v: torch.Tensor) -> None:
        # [M, S, Hkv, Dh] -> the slots' pages [U, n_pages, page, Hkv, Dh]
        for name, arr in (("k", k), ("v", v)):
            arr = arr[rows]
            pad = n_pages * page - s
            if pad:
                arr = torch.nn.functional.pad(arr, (0, 0, 0, 0, 0, pad))
            pool = cache[name]
            pool[li][pids] = arr.reshape(
                rows.shape[0], n_pages, page, *arr.shape[2:]).to(pool.dtype)

    if cfg.family == "dense":
        for li, lp in enumerate(params["layers"]):
            x, (k, v) = _dense_layer_full(lp, x, cfg, positions)
            write_kv(li, k, v)
    else:  # hybrid
        valid = torch.arange(s, device=x.device)[None, :] < true_lens[:, None]

        def mamba(lp, h, pool: dict):
            # pool: one layer's {conv [slots, K-1, C], state [slots, H, P, N]}
            out, state = _mamba_full(lp, h, cfg, valid)
            conv = ssm_mod.conv_tail_at(lp, h, cfg, true_lens)
            pool["conv"][slots] = conv[rows].to(pool["conv"].dtype)
            pool["state"][slots] = state[rows].to(pool["state"].dtype)
            return out

        for gi, gp in enumerate(params["groups"]):
            for li, lp in enumerate(gp):
                x = mamba(lp, x, {k: v[gi, li]
                                  for k, v in cache["mamba"].items()})
            x, (k, v) = _dense_layer_full(params["shared"], x, cfg, positions)
            write_kv(gi, k, v)
        for ti, lp in enumerate(params.get("tail") or ()):
            x = mamba(lp, x, {k: v[ti] for k, v in cache["tail"].items()})
    lens = cache["lens"].clone()
    lens[slots] = true_lens[rows]
    x_last = x[torch.arange(m, device=x.device), true_lens.long() - 1]
    x_last = blocks.norm(cfg, params["final_norm"], x_last)
    return lm_head(params, cfg, x_last), {**cache, "lens": lens}


def _dense_layer_decode(lp, x, cfg: ModelConfig, k_pages, v_pages, block,
                        lens, active):
    hn = blocks.norm(cfg, lp["attn_norm"], x)
    x = x + blocks.attn_decode_paged(lp["attn"], hn, cfg, k_pages, v_pages,
                                     block, lens, active)
    return x + ffn(lp["ffn"], blocks.norm(cfg, lp["ffn_norm"], x),
                   cfg.gated_ffn)


def decode_step_paged(params: dict, cfg: ModelConfig, token: torch.Tensor,
                      cache: dict, active: torch.Tensor
                      ) -> tuple[torch.Tensor, dict]:
    """One decode step over mixed-progress slots of a paged cache.

    token: int [B]; active: bool [B].  Each slot attends its own valid
    prefix (``cache["lens"]``) through its block-table row; inactive slots
    write to the null page and keep their length, and (hybrid) their conv
    window and SSM state stay bit-identical, so their lanes are pure
    padding.  Returns (logits [B, V], cache); logits of inactive slots are
    garbage and must be ignored by the caller.
    """
    _check_family(cfg, PAGED_FAMILIES)
    x = params["embed"][token.long()]
    lens = cache["lens"]
    # a slot at capacity must not decode: its page write would clamp onto
    # its own last page, so its lane is deactivated instead
    active = active.to(torch.bool) & (lens < paged_slot_capacity(cache))
    if cfg.rope_mode == "learned":
        x = x + params["pos_embed"][lens.long()]
    block = cache["block"]
    if cfg.family == "dense":
        for li, lp in enumerate(params["layers"]):
            x = _dense_layer_decode(lp, x, cfg, cache["k"][li],
                                    cache["v"][li], block, lens, active)
    else:  # hybrid
        # the JAX step returns each conv window in the promoted dtype of the
        # pool and this step's activations, so a float32 model over a bf16
        # cache carries float32 conv pools from its first decode step on;
        # the port's pools take that dtype too (a no-op for a bf16 model)
        for pools in (cache["mamba"], cache.get("tail")):
            if pools is not None:
                pools["conv"] = pools["conv"].to(
                    torch.promote_types(pools["conv"].dtype, x.dtype))

        def mamba(lp, h, pool: dict):
            # pool: one layer's state views, updated in place
            out, new = ssm_mod.mamba_decode_step(lp, h, pool, cfg,
                                                 active=active)
            for k, v in pool.items():
                v.copy_(new[k])
            return h + out

        for gi, gp in enumerate(params["groups"]):
            for li, lp in enumerate(gp):
                x = mamba(lp, x, {k: v[gi, li]
                                  for k, v in cache["mamba"].items()})
            x = _dense_layer_decode(params["shared"], x, cfg, cache["k"][gi],
                                    cache["v"][gi], block, lens, active)
        for ti, lp in enumerate(params.get("tail") or ()):
            x = mamba(lp, x, {k: v[ti] for k, v in cache["tail"].items()})
    cache = {**cache, "lens": lens + active.to(torch.int32)}
    x = blocks.norm(cfg, params["final_norm"], x)
    return lm_head(params, cfg, x), cache
