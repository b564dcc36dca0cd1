"""CPU rehearsals of the port's tensor-core kernels, which only a card runs.

* B3 (``csrc/flash_attention.cu``): the kernel's roundings written out in
  plain PyTorch -- blocks of 64 keys from key 0, the head dim zero-padded
  to 64 or 128, a float32 online softmax, and P entering the P.V product
  as bf16 hi + bf16 lo (lo the rounding residual) with float32 sums --
  held against the JAX package's ``chunked_attention`` (causal) under the
  gate the card's check uses (chip_smoke.py, tests/test_torch_gpu.py):
  each output within two bf16 steps of the reference plus 1e-5.  The worst
  |err|/limit of a single bf16 P is printed beside it for the record.
* B2 (``csrc/int8_gemm.cu``): the wrapper's rule ``gemm_variant``, which
  picks the kernel variant from the shape and the operands' alignment
  alone, for every W8A8 linear of the served models.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import attention as jattn
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.int8_pagegemv.ops import GEMV_MAX_M, gemm_variant
from repro_torch.serving.kv_cache import prefill_bucket

BF16_STEPS = 2
F32_NOISE = 1e-5
BLOCK = 64   # keys per K/V block of the kernel


def b3_rehearsal(q, k, v, split_p: bool = True) -> torch.Tensor:
    """Causal attention rounded as the B3 kernel rounds.  q [B, S, H, D],
    k/v [B, S, Hkv, D] bf16 -> bf16 [B, S, H, D].  A block above a query's
    diagonal (never loaded by the kernel) is all masked here, which leaves
    that query's running max, sum and output unchanged bit for bit."""
    b, s, h, d = q.shape
    dp = 64 if d <= 64 else 128
    rep = h // k.shape[2]
    qf = F.pad(q.float(), (0, dp - d)).transpose(1, 2)           # [B,H,S,DP]
    kf, vf = (F.pad(t.float(), (0, dp - d)).repeat_interleave(rep, dim=2)
              .transpose(1, 2) for t in (k, v))
    scale = float(np.float32(d ** -0.5))
    pos = torch.arange(s)
    m = torch.full((b, h, s), -1e30)
    l = torch.zeros((b, h, s))
    o = torch.zeros((b, h, s, dp))
    for k0 in range(0, s, BLOCK):
        kb, vb = kf[:, :, k0:k0 + BLOCK], vf[:, :, k0:k0 + BLOCK]
        sc = (qf @ kb.transpose(-1, -2)) * scale
        sc = torch.where(pos[k0:k0 + BLOCK][None, :] > pos[:, None], -1e30, sc)
        m_new = torch.maximum(m, sc.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * corr + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        o = o * corr[..., None] + hi @ vb
        if split_p:
            o = o + (p - hi).to(torch.bfloat16).float() @ vb
        m = m_new
    out = o / torch.clamp_min(l, 1e-20)[..., None]
    return out[..., :d].transpose(1, 2).to(torch.bfloat16)


def _gate_ratio(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst |err| / (two bf16 steps of |ref| + 1e-5)."""
    got, ref = got.float(), ref.float()
    step = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -126)))
                      - 7)
    return float(((got - ref).abs() / (BF16_STEPS * step + F32_NOISE)).max())


@pytest.mark.parametrize("d", [64, 112, 128])
def test_b3_rounding_rehearsal_vs_jax_chunked_attention(d):
    """S = 200 (three full blocks and a ragged one), 4 heads on 2 kv heads."""
    rng = np.random.RandomState(d)
    b, s, h, hkv = 1, 200, 4, 2
    q, k, v = (torch.from_numpy(rng.randn(b, s, n, d).astype(np.float32))
               .to(torch.bfloat16) for n in (h, hkv, hkv))
    ref = torch.from_numpy(np.array(jattn.chunked_attention(
        *(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
          for t in (q, k, v)), causal=True).astype(jnp.float32)))
    ratio = _gate_ratio(b3_rehearsal(q, k, v), ref)
    single = _gate_ratio(b3_rehearsal(q, k, v, split_p=False), ref)
    print(f"B3 rehearsal D={d}: worst |err|/limit {ratio:.3f} with P as bf16 "
          f"hi + lo, {single:.3f} with a single bf16 P")
    assert ratio <= 1.0


def _w8a8_linears(arch: str) -> list[tuple[int, int]]:
    """(K, N) of every W8A8 linear the served model runs at prefill."""
    cfg = get_arch(arch)
    d, qd = cfg.d_model, cfg.n_heads * cfg.d_head
    kvd = cfg.n_kv_heads * cfg.d_head
    dense = [(d, qd), (d, kvd), (d, kvd), (qd, d), (d, cfg.d_ff),
             (d, cfg.d_ff), (cfg.d_ff, d)]
    if cfg.family != "hybrid":
        return dense
    n_in = (2 * cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
            + cfg.ssm_nheads)
    return dense + [(d, n_in), (cfg.d_inner, d)]   # Mamba in_proj, out_proj


@pytest.mark.parametrize("arch", ["llama2-7b", "zamba2-7b", "smollm-360m"])
def test_b2_every_prefill_shape_takes_the_tensor_cores(arch):
    """Every prefill bucket (4 slots x 8..1024 tokens) of every linear goes
    to the wgmma variant; the 1..4-token decode batches to the GeMV."""
    linears = _w8a8_linears(arch)
    if arch == "zamba2-7b":
        assert (3584, 14576) in linears and (7168, 3584) in linears
    buckets = sorted({prefill_bucket(n) for n in range(1, 1025)})
    for k, _n in linears:
        for bucket in buckets:
            assert gemm_variant(4 * bucket, k, 0, 256) == "int8_gemm_tc"
        for m in range(1, 5):
            assert gemm_variant(m, k, 0, 256) == "int8_gemv"


@pytest.mark.parametrize("m,k,x_ptr,w_ptr,variant", [
    (1, 4096, 0, 0, "int8_gemv"),
    (GEMV_MAX_M, 1000, 3, 5, "int8_gemv_dp4a"),   # K % 16 != 0, misaligned
    (GEMV_MAX_M + 1, 4096, 0, 0, "int8_gemm_tc"),  # M = 9
    (130, 3584, 512, 1024, "int8_gemm_tc"),
    (2048, 960, 0, 16, "int8_gemm_tc"),            # smollm: K = 60 x 16
    (37, 1000, 0, 0, "int8_gemm"),                 # K % 16 != 0
    (2048, 4104, 0, 0, "int8_gemm"),               # K % 16 == 8
    (2048, 4096, 8, 0, "int8_gemm"),               # x base not 16-aligned
    (2048, 4096, 0, 4, "int8_gemm"),               # w base not 16-aligned
])
def test_b2_dispatch_rule(m, k, x_ptr, w_ptr, variant):
    assert gemm_variant(m, k, x_ptr, w_ptr) == variant
