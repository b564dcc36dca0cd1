"""CPU rehearsal of the float32 causal attention pair that only a card
runs (``csrc/flash_attention_f32.cu``), and the wrapper's refusals.

The kernels' schedule in torch (``kernels/flash_attention/ref.py``:
``attention_f32_fwd_ref`` saves O and each row's log-sum-exp;
``attention_f32_bwd_ref`` recomputes P from them, delta = rowsum(dO * O),
dK/dV per 64-key tile over the group's heads and the query tiles from the
key tile's on, dQ per 64-query tile over the key tiles up to it) is held
against autograd of attention written out in float64 (softmax of the
masked scores), in float64 and in float32, at query groups 1, 3 and 8,
head dims 64 and 128 and sequence lengths that are not multiples of 64;
and in float32 against JAX's ``chunked_attention`` under ``jax.vjp`` (the
oracle the JAX package trains with).

Tolerances, per output tensor against its max |ref|: float64 1e-12
(rounding only); float32 1e-5 (float32 sums over up to ~200 keys in
another order; measured ~1e-6).  The card's check (chip_smoke.py, the
kernels phase) holds the kernels to the same float32 bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401  (autouse)
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention.ops import (check_f32_inputs,
                                                     flash_attention)
from repro_torch.kernels.flash_attention.ref import (attention_f32_bwd_ref,
                                                     attention_f32_fwd_ref)
from repro_torch.models.attention import chunked_attention

REL = {torch.float64: 1e-12, torch.float32: 1e-5}
CASES = [(2, 100, 6, 2, 64), (1, 130, 8, 1, 128), (2, 64, 3, 3, 64),
         (1, 200, 24, 3, 64), (2, 65, 4, 4, 128)]   # (B, S, H, Hkv, D)


def _inputs(b, s, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for shape in
            ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d))]


def _exact(q, k, v, do):
    """(O, dq, dk, dv) of causal attention in float64 by autograd."""
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    g = q.shape[2] // k.shape[2]
    kr, vr = (t.repeat_interleave(g, dim=2).transpose(1, 2) for t in (k, v))
    sc = (q.transpose(1, 2) @ kr.transpose(-1, -2)) * q.shape[-1] ** -0.5
    s = q.shape[1]
    mask = torch.ones(s, s, dtype=torch.bool).tril()
    p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
    o = (p @ vr).transpose(1, 2)
    o.backward(torch.from_numpy(do))
    return o.detach(), q.grad, k.grad, v.grad


def _rel(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}-S{}-H{}-Hkv{}-D{}"
                         .format(*c))
def test_tiled_pair_matches_autograd(case, dtype):
    q, k, v, do = _inputs(*case)
    want = _exact(q, k, v, do)
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v, do)]
    o, lse = attention_f32_fwd_ref(*t[:3])
    assert lse.shape == (case[0], case[2], case[1])
    got = (o, *attention_f32_bwd_ref(*t[:3], o, lse, t[3]))
    for name, g, w in zip(("O", "dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert _rel(g, w) <= REL[dtype], (name, _rel(g, w))


@pytest.mark.parametrize("case", CASES[:3], ids=lambda c: "S{1}-H{2}-Hkv{3}"
                         .format(*c))
def test_tiled_pair_matches_jax_chunked_attention(case):
    q, k, v, do = (x.astype(np.float32) for x in _inputs(*case, seed=1))
    out, vjp = jax.vjp(lambda a, b, c: jattn.chunked_attention(
        a, b, c, causal=True), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = (out, *vjp(jnp.asarray(do)))
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = attention_f32_fwd_ref(*t[:3])
    got = (o, *attention_f32_bwd_ref(*t[:3], o, lse, t[3]))
    for name, g, w in zip(("O", "dq", "dk", "dv"), got, want):
        assert _rel(g, torch.from_numpy(np.array(w))) <= REL[torch.float32], \
            name


def test_cpu_dispatch_trains_through_the_plain_version():
    """On the CPU ``flash_attention`` is ``chunked_attention``, whose
    autograd the tiled pair matches."""
    q, k, v, do = (torch.from_numpy(x.astype(np.float32))
                   for x in _inputs(2, 70, 4, 2, 64, seed=2))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves)
    out.backward(do)
    assert torch.equal(out.detach(), chunked_attention(q, k, v))
    o, lse = attention_f32_fwd_ref(q, k, v)
    for g, r in zip((leaves[0].grad, leaves[1].grad, leaves[2].grad),
                    attention_f32_bwd_ref(q, k, v, o, lse, do)):
        assert _rel(g, r) <= REL[torch.float32]


def _f32(*shape, offset=0):
    t = torch.zeros(int(np.prod(shape)) + offset)
    return t[offset:].view(shape)


@pytest.mark.parametrize("what", [
    "bidirectional", "bf16", "head dim 96", "H % Hkv", "k's length",
    "head stride off the grid", "base off the grid", "last axis strided"])
def test_float32_wrapper_refuses(what):
    q, k, v = _f32(2, 8, 4, 64), _f32(2, 8, 2, 64), _f32(2, 8, 2, 64)
    causal, err = True, ValueError
    if what == "bidirectional":
        causal = False
    elif what == "bf16":
        q, err = q.bfloat16(), TypeError
    elif what == "head dim 96":
        q, k, v = _f32(2, 8, 4, 96), _f32(2, 8, 2, 96), _f32(2, 8, 2, 96)
    elif what == "H % Hkv":
        q = _f32(2, 8, 3, 64)
    elif what == "k's length":
        k = _f32(2, 9, 2, 64)
    elif what == "head stride off the grid":
        q = _f32(2, 8, 4, 66)[..., :64]
    elif what == "base off the grid":
        q = _f32(2, 8, 4, 64, offset=1)
    elif what == "last axis strided":
        q = _f32(2, 8, 4, 128)[..., ::2]
    with pytest.raises(err):
        check_f32_inputs(q, k, v, causal)
    check_f32_inputs(_f32(2, 8, 4, 64), _f32(2, 8, 2, 64), _f32(2, 8, 2, 64))


def test_wrapper_refuses_other_devices():
    q = torch.zeros((1, 4, 2, 64), device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
