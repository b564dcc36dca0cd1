"""Plain PyTorch oracle for the prefill flash attention kernel: the
model's own ``chunked_attention``, causal or bidirectional, as ``attn_full``
calls it."""

from __future__ import annotations

import torch

from repro_torch.models.attention import chunked_attention


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: [B, S, H, D]; k/v: [B, Skv, Hkv, D] -> [B, S, H, D].  Causal:
    Skv == S.  Bidirectional: any Skv (cross-attention); the keys are
    sliced into chunks, not padded, so no key past Skv enters."""
    return chunked_attention(q, k, v, causal=causal)


# ---------------------------------------------------------------------------
# the float32 pair (csrc/flash_attention_f32.cu), tile by tile
# ---------------------------------------------------------------------------

# queries and keys of a tile, at absolute multiples of TILE
TILE = 64
NEG_INF = -1e30
# keys a step of the forward kernel's walk (kFwdStep in
# csrc/flash_attention_f32.cu)
FWD_STEP = 32
# the portable thread-block cluster size: the most CTAs that share a key
# tile's dK/dV
MAX_CTAS = 8


def attention_f32_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          tile: int = TILE, step: int = FWD_STEP
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's schedule in torch (any float dtype; float32 on
    the card is its plain version): causal, q [B, S, H, D], k/v [B, S, Hkv,
    D].  Per query tile the keys 0 .. the tile's last in steps of ``step``
    keys (the kernel's ``FWD_STEP`` by default), an online softmax;
    returns (O [B, S, H, D], lse [B, H, S]) with lse = m + log(l)."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    scale = d ** -0.5
    qf = q.transpose(1, 2)
    kf = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vf = v.transpose(1, 2).repeat_interleave(g, dim=1)
    pos = torch.arange(s, device=q.device)
    o = torch.empty_like(qf)
    lse = q.new_empty((b, h, s))
    for q0 in range(0, s, tile):
        qb = qf[:, :, q0:q0 + tile]
        m = q.new_full(qb.shape[:-1], NEG_INF)
        l = q.new_zeros(qb.shape[:-1])
        acc = torch.zeros_like(qb)
        for k0 in range(0, min(q0 + tile, s), step):
            sc = (qb @ kf[:, :, k0:k0 + step].transpose(-1, -2)) * scale
            keep = pos[q0:q0 + tile, None] >= pos[None, k0:k0 + step]
            sc = torch.where(keep, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ vf[:, :, k0:k0 + step]
            m = m_new
        o[:, :, q0:q0 + tile] = acc / torch.clamp_min(l, 1e-20)[..., None]
        lse[:, :, q0:q0 + tile] = m + torch.log(l)
    return o.transpose(1, 2).contiguous(), lse


def _probs(qb, kb, lse_b, q0: int, k0: int, scale: float) -> torch.Tensor:
    """P = exp(S scale - lse) of a (query tile, key tile) pair, 0 where the
    key is after the query."""
    sc = (qb @ kb.transpose(-1, -2)) * scale
    i = torch.arange(qb.shape[-2], device=qb.device)[:, None] + q0
    j = torch.arange(kb.shape[-2], device=qb.device)[None, :] + k0
    return torch.where(j <= i, torch.exp(sc - lse_b[..., None]), 0.0)


def group_ctas(group: int) -> int:
    """CTAs that share a key tile's dK/dV in the kernel (one thread-block
    cluster): the largest divisor of the query group up to MAX_CTAS."""
    return next(c for c in range(min(group, MAX_CTAS), 0, -1)
                if group % c == 0)


def attention_f32_dkdv_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, o: torch.Tensor,
                           lse: torch.Tensor, do: torch.Tensor,
                           tile: int = TILE, ctas: int | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dK/dV kernel's schedule: delta = rowsum(dO * O) [B, H, S]; per
    key tile, the group's heads dealt to ``ctas`` ranks (``group_ctas`` of
    the group unless given; rank r takes heads r, r + ctas, ...), each rank
    over its heads in order, then the query tiles from the key tile's on
    (the kernel walks them in steps of 32 queries at D 64, 16 at D 128), P
    recomputed from lse, dV += P^T dO, dS = P (dP - delta), dK += dS^T Q;
    then the ranks' partials summed in rank order and dK scaled once.
    Returns (dk, dv [B, S, Hkv, D], delta)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    ctas = group_ctas(g) if ctas is None else ctas
    scale = d ** -0.5
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    qf, dof = q.transpose(1, 2), do.transpose(1, 2)    # [B, H, S, D]
    kf, vf = k.transpose(1, 2), v.transpose(1, 2)      # [B, Hkv, S, D]
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for k0 in range(0, s, tile):
        kb, vb = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        dk_t = dv_t = None
        for rank in range(ctas):
            dk_r, dv_r = torch.zeros_like(kb), torch.zeros_like(vb)
            for gi in range(rank, g, ctas):
                heads = torch.arange(hkv, device=q.device) * g + gi
                for q0 in range(k0, s, tile):
                    sl = slice(q0, q0 + tile)
                    qb, dob = qf[:, heads, sl], dof[:, heads, sl]
                    p = _probs(qb, kb, lse[:, heads, sl], q0, k0, scale)
                    dv_r = dv_r + p.transpose(-1, -2) @ dob
                    ds = p * (dob @ vb.transpose(-1, -2)
                              - delta[:, heads, sl, None])
                    dk_r = dk_r + ds.transpose(-1, -2) @ qb
            dk_t = dk_r if dk_t is None else dk_t + dk_r
            dv_t = dv_r if dv_t is None else dv_t + dv_r
        dk[:, :, k0:k0 + tile] = dk_t * scale
        dv[:, :, k0:k0 + tile] = dv_t
    return (dk.transpose(1, 2).contiguous(), dv.transpose(1, 2).contiguous(),
            delta)


def attention_f32_dq_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lse: torch.Tensor, do: torch.Tensor,
                         delta: torch.Tensor, tile: int = TILE
                         ) -> torch.Tensor:
    """The dQ kernel's schedule: per query tile over the key tiles up to
    it, dQ += dS K, scaled once at the end.  Returns dq [B, S, H, D]."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    scale = d ** -0.5
    qf, dof = q.transpose(1, 2), do.transpose(1, 2)
    kr = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vr = v.transpose(1, 2).repeat_interleave(g, dim=1)
    dq = torch.zeros_like(qf)
    for q0 in range(0, s, tile):
        sl = slice(q0, q0 + tile)
        qb, dob = qf[:, :, sl], dof[:, :, sl]
        acc = torch.zeros_like(qb)
        for k0 in range(0, q0 + 1, tile):
            kb, vb = kr[:, :, k0:k0 + tile], vr[:, :, k0:k0 + tile]
            p = _probs(qb, kb, lse[:, :, sl], q0, k0, scale)
            ds = p * (dob @ vb.transpose(-1, -2) - delta[:, :, sl, None])
            acc = acc + ds @ kb
        dq[:, :, sl] = acc * scale
    return dq.transpose(1, 2).contiguous()


def attention_f32_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          o: torch.Tensor, lse: torch.Tensor,
                          do: torch.Tensor, tile: int = TILE
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both backward schedules: (dq [B, S, H, D], dk, dv [B, S, Hkv, D])."""
    dk, dv, delta = attention_f32_dkdv_ref(q, k, v, o, lse, do, tile)
    return attention_f32_dq_ref(q, k, v, lse, do, delta, tile), dk, dv
