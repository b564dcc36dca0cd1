"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060].

Counterpart of ``repro.models.ssm``, formula for formula: chunked SSD for
prefill / forward (quadratic within chunks, linear across) and a
constant-memory recurrent step for decode.  The intra-chunk ``y_diag`` term
of ``ssd_chunked`` goes through the B6 kernel wrapper
(``kernels/ssd_scan``): on a CUDA tensor the Hopper kernel, on a CPU tensor
its plain version.  The chunk summaries, the inter-chunk recurrence, the
decode step and the convolutions are plain tensor code, as they are jnp in
the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk
from repro_torch.models.layers import init_linear, linear, rms_norm

NEG_INF = -1e30


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: [..., T] -> lower-triangular pairwise sums a(j..i] as [..., T, T],
    NEG_INF above the diagonal."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, torch.full_like(diff, NEG_INF))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no linear branch above a
    threshold (``F.softplus`` returns x above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, b_mat: torch.Tensor,
                c_mat: torch.Tensor, chunk: int = 128,
                init_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. x: [B,S,H,P]; a: [B,S,H] (log decay = dt*A, negative);
    b_mat/c_mat: [B,S,G,N]. Returns (y [B,S,H,P], final_state [B,H,P,N])."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // chunk
    rep = h // g
    # 1) intra-chunk (the "duality" quadratic part): the B6 kernel
    y_diag = ssd_intra_chunk(x, a, b_mat, c_mat, chunk)       # f32
    xc = x.reshape(bsz, nc, chunk, h, p).float()
    ac = a.reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2)     # [B,H,C,Q]
    bc = torch.repeat_interleave(
        b_mat.reshape(bsz, nc, chunk, g, n), rep, dim=3).float()
    cc = torch.repeat_interleave(
        c_mat.reshape(bsz, nc, chunk, g, n), rep, dim=3).float()
    a_cumsum = torch.cumsum(ac, dim=-1)                       # [B,H,C,Q]
    # 2) chunk summaries
    decay_states = torch.exp(a_cumsum[..., -1:] - a_cumsum).float()
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", bc, decay_states, xc)
    # 3) inter-chunk recurrence, one chunk at a time
    chunk_decay = torch.exp(a_cumsum[..., -1])                # [B,H,C]
    carry = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for ci in range(nc):
        prev.append(carry)   # the state *entering* chunk ci
        carry = carry * chunk_decay[:, :, ci, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                    # [B,C,H,P,N]
    # 4) inter-chunk contribution
    state_decay = torch.exp(a_cumsum).float()                 # [B,H,C,Q]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", cc, prev_states,
                         state_decay)
    y = (y_diag.reshape(bsz, nc, chunk, h, p) + y_off).reshape(
        bsz, nc * chunk, h, p)
    return y[:, :s].to(x.dtype), carry


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                    b_mat: torch.Tensor, c_mat: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step. state: [B,H,P,N]; x: [B,H,P]; a: [B,H];
    b_mat/c_mat: [B,G,N]. Returns (y [B,H,P], new_state)."""
    rep = x.shape[1] // b_mat.shape[1]
    bb = torch.repeat_interleave(b_mat, rep, dim=1).float()   # [B,H,N]
    cc = torch.repeat_interleave(c_mat, rep, dim=1).float()
    new_state = (state * torch.exp(a.float())[..., None, None]
                 + torch.einsum("bhp,bhn->bhpn", x.float(), bb))
    y = torch.einsum("bhpn,bhn->bhp", new_state, cc)
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Full Mamba-2 block
# ---------------------------------------------------------------------------


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig,
                     dtype: torch.dtype, device: torch.device) -> dict:
    """The JAX package's distributions: normal / sqrt(d_in) projections,
    normal * 0.2 conv taps, A = 1..16 over the heads, unit skip and norm."""
    d_in = cfg.d_inner
    g, n, hh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    conv_ch = d_in + 2 * g * n
    proj_out = 2 * d_in + 2 * g * n + hh
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": init_linear(gen, cfg.d_model, proj_out, False, dtype,
                               device),
        "conv_w": (torch.randn((cfg.ssm_conv, conv_ch), generator=gen, **f32)
                   * 0.2).to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((hh,), **f32),
        "a_log": torch.log(torch.linspace(1.0, 16.0, hh, **f32)),
        "d_skip": torch.ones((hh,), **f32),
        "norm": torch.ones((d_in,), dtype=dtype, device=device),
        "out_proj": init_linear(gen, d_in, cfg.d_model, False, dtype,
                                device),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_in = cfg.d_inner
    g, n, hh = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * g * n, hh], dim=-1)
    return z, xbc, dt  # xbc still fused for the conv


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over [B, S, C] with kernel [K, C]; products and
    sums in the input dtype, as the reference takes them."""
    k = w.shape[0]
    xp = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + xbc.shape[1], :] * w[i][None, None, :]
              for i in range(k))
    return F.silu((out + b[None, None, :]).float()).to(xbc.dtype)


def mamba_block(params: dict, x: torch.Tensor, cfg: ModelConfig,
                chunk: int = 128, init_state: torch.Tensor | None = None,
                valid: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence mamba2 block. x: [B, S, D] -> ([B, S, D], final_state).

    ``valid`` ([B, S] bool) zeroes the dt of pad positions, which makes their
    state update the identity (decay exp(0)=1, zero input): a RIGHT-padded
    row ends the scan with exactly the state of its valid prefix.  Outputs
    at invalid positions are garbage (callers mask them)."""
    d_in = cfg.d_inner
    g, n, hh, p = (cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads,
                   cfg.ssm_headdim)
    bsz, s, _ = x.shape
    z, xbc, dt = _split_proj(cfg, linear(params["in_proj"], x))
    xbc = _causal_conv(xbc, params["conv_w"], params["conv_b"])
    xs, b_mat, c_mat = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    dt = _softplus(dt.float() + params["dt_bias"].float())     # [B,S,H]
    if valid is not None:
        dt = torch.where(valid[..., None], dt, torch.zeros_like(dt))
    a = -torch.exp(params["a_log"].float())[None, None, :] * dt
    xh = xs.reshape(bsz, s, hh, p)
    xin = xh * dt[..., None].to(xh.dtype)
    y, state = ssd_chunked(xin, a, b_mat.reshape(bsz, s, g, n),
                           c_mat.reshape(bsz, s, g, n), chunk,
                           init_state=init_state)
    y = y + xh * params["d_skip"][None, None, :, None].to(xh.dtype)
    y = y.reshape(bsz, s, d_in)
    y = y * F.silu(z.float()).to(y.dtype)
    y = rms_norm(y, params["norm"], cfg.norm_eps)
    return linear(params["out_proj"], y), state


def mamba_decode_step(params: dict, x: torch.Tensor, cache: dict,
                      cfg: ModelConfig, active: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, dict]:
    """One-token step. x: [B, D]; cache: {"conv": [B,K-1,C], "state":
    [B,H,P,N]}.  Returns (out [B, D], new cache); the input cache is not
    written.

    ``active`` ([B] bool) freezes inactive lanes' recurrent state: their conv
    window and SSM state come back bit-identical (a suspended serving slot
    resumes exactly where it stopped).  Their output is garbage."""
    d_in = cfg.d_inner
    g, n, hh, p = (cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads,
                   cfg.ssm_headdim)
    bsz = x.shape[0]
    z, xbc, dt = _split_proj(cfg, linear(params["in_proj"], x))
    # in the promoted dtype of the window and this step's input, as
    # jnp.concatenate gives it
    window = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)  # [B,K,C]
    conv_out = torch.einsum("bkc,kc->bc", window.float(),
                            params["conv_w"].float())
    xbc = F.silu(conv_out + params["conv_b"].float()).to(x.dtype)
    new_conv = window[:, 1:, :]
    xs, b_mat, c_mat = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    dt = _softplus(dt.float() + params["dt_bias"].float())     # [B,H]
    a = -torch.exp(params["a_log"].float())[None, :] * dt
    xh = xs.reshape(bsz, hh, p) * dt[..., None].to(x.dtype)
    y, new_state = ssd_decode_step(cache["state"], xh, a,
                                   b_mat.reshape(bsz, g, n),
                                   c_mat.reshape(bsz, g, n))
    y = y + xs.reshape(bsz, hh, p) * params["d_skip"][None, :, None].to(
        x.dtype)
    y = y.reshape(bsz, d_in)
    y = y * F.silu(z.float()).to(y.dtype)
    y = rms_norm(y, params["norm"], cfg.norm_eps)
    if active is not None:
        am = active.to(device=x.device, dtype=torch.bool)
        new_conv = torch.where(am[:, None, None], new_conv, cache["conv"])
        new_state = torch.where(am[:, None, None, None], new_state,
                                cache["state"])
    return linear(params["out_proj"], y), {"conv": new_conv,
                                           "state": new_state}


def conv_tail_at(params: dict, h: torch.Tensor, cfg: ModelConfig,
                 true_lens: torch.Tensor) -> torch.Tensor:
    """Per-row decode conv window from a right-padded prefill pass.

    h: [B, S, D] layer input; true_lens: [B] valid lengths.  Returns
    [B, K-1, C]: the PRE-activation conv inputs at the last K-1 *valid*
    positions of each row, zeroed where the row is shorter than the window
    (matching the zero-initialised conv cache).  The [B, K-1, D] input
    window is gathered first, so in_proj runs over K-1 positions only."""
    k = cfg.ssm_conv - 1
    d_in = cfg.d_inner
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    hp = F.pad(h, (0, 0, k, 0))
    # padded index j holds original position j - k; the originals wanted
    # are [true_len - k, true_len), i.e. padded [true_len, true_len + k)
    idx = (true_lens.to(device=h.device, dtype=torch.long)[:, None]
           + torch.arange(k, device=h.device))
    hw = torch.take_along_dim(hp, idx[..., None], dim=1)      # [B, K-1, D]
    xbc = linear(params["in_proj"], hw)[..., d_in:d_in + d_in + 2 * g * n]
    # positions before the row's start mirror the zero-init conv cache
    return torch.where((idx >= k)[..., None], xbc, torch.zeros_like(xbc))


def init_mamba_cache(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: str | torch.device = "cpu") -> dict:
    d_in = cfg.d_inner
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    conv_ch = d_in + 2 * g * n
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_headdim, n),
                             dtype=torch.float32, device=device),
    }
