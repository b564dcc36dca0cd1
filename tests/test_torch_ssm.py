"""The port's Mamba-2 SSD block and the plain version of its B6 kernel
against the JAX package, on the same numpy-seeded inputs.

``repro_torch.models.ssm`` is the counterpart of ``repro.models.ssm``; its
``ssd_chunked`` takes the intra-chunk term from the B6 wrapper, which on
the CPU runs the plain version (``kernels/ssd_scan/ref.py``).  That plain
version is also held against the JAX package's Pallas kernel in interpret
mode, as tests/test_kernels.py runs it.

Tolerance: float32 on both sides, sums taken in another order: rtol = atol
= 2e-5 (the JAX package's kernel-test tolerance, as
tests/test_torch_kernels.py states it).  Inactive decode lanes must come
back bit-identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.kernels.ssd_scan.ops import ssd_intra_chunk_op
from repro.models import ssm as jssm
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk
from repro_torch.kernels.ssd_scan.ref import (ssd_intra_chunk_model_ref,
                                              ssd_intra_chunk_ref)
from repro_torch.models import ssm as tssm
from _torch_threads import one_thread  # noqa: F401  (autouse)

TOL = dict(rtol=2e-5, atol=2e-5)


def _cfgs(groups: int = 1):
    """zamba2-7b.reduced() (8 heads of 16, state 16), optionally with
    ``groups`` B/C groups, on both sides."""
    j = jget_arch("zamba2-7b").reduced()
    t = get_arch("zamba2-7b").reduced()
    if groups != 1:
        j = dataclasses.replace(j, ssm_ngroups=groups)
        t = dataclasses.replace(t, ssm_ngroups=groups)
    return j, t


def _ssd_inputs(rng, b, s, h, g, p, n, decay=0.1):
    x = rng.randn(b, s, h, p).astype(np.float32)
    a = (-np.abs(rng.randn(b, s, h)) * decay).astype(np.float32)
    bm = (rng.randn(b, s, g, n) * 0.3).astype(np.float32)
    cm = (rng.randn(b, s, g, n) * 0.3).astype(np.float32)
    return x, a, bm, cm


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _mamba_params(jcfg, seed):
    jp = jssm.init_mamba_block(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    # non-trivial dt_bias / d_skip / conv bias, so every term is exercised
    rng = np.random.RandomState(seed)
    hh = jcfg.ssm_nheads
    jp = {**jp,
          "dt_bias": jnp.asarray(rng.randn(hh).astype(np.float32) * 0.5),
          "d_skip": jnp.asarray(1.0 + rng.randn(hh).astype(np.float32) * 0.1),
          "conv_b": jnp.asarray(rng.randn(*jp["conv_b"].shape)
                                .astype(np.float32) * 0.1)}
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def test_segsum_matches_jax():
    a = np.random.RandomState(0).randn(3, 2, 16).astype(np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    got = tssm._segsum(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got == -1e30, want == -1e30)


@pytest.mark.parametrize("b,s,h,g,p,n,chunk", [
    (1, 64, 4, 1, 32, 16, 32),    # two chunks
    (2, 32, 4, 2, 16, 32, 16),    # G > 1
])
def test_plain_intra_chunk_matches_pallas(b, s, h, g, p, n, chunk):
    """The port's plain B6 (both layouts) against the Pallas kernel run in
    interpret mode through its JAX front end."""
    x, a, bm, cm = _ssd_inputs(np.random.RandomState(s * h), b, s, h, g, p, n)
    want = np.asarray(ssd_intra_chunk_op(jnp.asarray(x), jnp.asarray(a),
                                         jnp.asarray(bm), jnp.asarray(cm),
                                         chunk=chunk, interpret=True))
    tx, ta, tb, tc = _t(x, a, bm, cm)
    got = ssd_intra_chunk_model_ref(tx, ta, tb, tc, chunk).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(ssd_intra_chunk(tx, ta, tb, tc, chunk)
                                  .numpy(), got)
    # the kernel layout of the reference, against the Pallas-layout oracle
    nc = s // chunk
    ar = ta.reshape(b, nc, chunk, h).permute(0, 3, 1, 2).reshape(b * h, nc,
                                                                 chunk)
    br = tb.reshape(b, nc, chunk, g, n).permute(0, 3, 1, 2, 4).reshape(
        b * g, nc, chunk, n)
    cr = tc.reshape(b, nc, chunk, g, n).permute(0, 3, 1, 2, 4).reshape(
        b * g, nc, chunk, n)
    xr = tx.reshape(b, nc, chunk, h, p).permute(0, 3, 1, 2, 4).reshape(
        b * h, nc, chunk, p)
    y = ssd_intra_chunk_ref(ar, br, cr, xr)
    y = y.reshape(b, h, nc, chunk, p).permute(0, 2, 3, 1, 4).reshape(
        b, s, h, p)
    np.testing.assert_allclose(y.numpy(), want, **TOL)


@pytest.mark.parametrize("s,chunk,g,with_state", [
    (64, 16, 1, False),   # four chunks
    (40, 16, 1, True),    # S not a multiple of the chunk, init_state
    (48, 16, 2, True),    # G > 1
    (8, 128, 1, False),   # chunk clipped to S
])
def test_ssd_chunked_matches_jax(s, chunk, g, with_state):
    b, h, p, n = 2, 4, 16, 16
    rng = np.random.RandomState(s + g)
    x, a, bm, cm = _ssd_inputs(rng, b, s, h, g, p, n, decay=0.5)
    st = rng.randn(b, h, p, n).astype(np.float32) if with_state else None
    jy, js = jssm.ssd_chunked(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(bm), jnp.asarray(cm),
        chunk, init_state=None if st is None else jnp.asarray(st))
    tx, ta, tb, tc = _t(x, a, bm, cm)
    ty, ts = tssm.ssd_chunked(tx, ta, tb, tc, chunk,
                              init_state=None if st is None
                              else torch.from_numpy(st))
    assert ty.shape == (b, s, h, p) and ts.shape == (b, h, p, n)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step_matches_jax(g):
    b, h, p, n = 3, 4, 16, 8
    rng = np.random.RandomState(g)
    state = rng.randn(b, h, p, n).astype(np.float32)
    x = rng.randn(b, h, p).astype(np.float32)
    a = (-np.abs(rng.randn(b, h))).astype(np.float32)
    bm, cm = (rng.randn(b, g, n).astype(np.float32) for _ in range(2))
    jy, js = jssm.ssd_decode_step(*map(jnp.asarray, (state, x, a, bm, cm)))
    ty, ts = tssm.ssd_decode_step(*_t(state, x, a, bm, cm))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_block_matches_jax(masked, groups):
    """Full-sequence block, with and without the right-padding mask."""
    jcfg, tcfg = _cfgs(groups)
    jp, tp = _mamba_params(jcfg, seed=3 + groups)
    rng = np.random.RandomState(7)
    x = rng.randn(3, 24, jcfg.d_model).astype(np.float32)
    valid = None
    if masked:
        lens = np.array([24, 9, 2])
        valid = np.arange(24)[None, :] < lens[:, None]
    jy, js = jssm.mamba_block(jp, jnp.asarray(x), jcfg, chunk=8,
                              valid=None if valid is None
                              else jnp.asarray(valid))
    ty, ts = tssm.mamba_block(tp, torch.from_numpy(x), tcfg, chunk=8,
                              valid=None if valid is None
                              else torch.from_numpy(valid))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    if masked:   # a padded row ends with the state of its valid prefix
        _, short = tssm.mamba_block(tp, torch.from_numpy(x[1:2, :9]), tcfg,
                                    chunk=8)
        np.testing.assert_allclose(ts[1:2].numpy(), short.numpy(), **TOL)


def test_mamba_decode_step_matches_jax_and_freezes_inactive():
    jcfg, tcfg = _cfgs()
    jp, tp = _mamba_params(jcfg, seed=11)
    rng = np.random.RandomState(12)
    b = 4
    conv_ch = jcfg.d_inner + 2 * jcfg.ssm_ngroups * jcfg.ssm_state
    cache = {"conv": rng.randn(b, jcfg.ssm_conv - 1, conv_ch)
             .astype(np.float32),
             "state": rng.randn(b, jcfg.ssm_nheads, jcfg.ssm_headdim,
                                jcfg.ssm_state).astype(np.float32)}
    active = np.array([True, False, True, False])
    x = rng.randn(b, jcfg.d_model).astype(np.float32)
    jy, jc = jssm.mamba_decode_step(jp, jnp.asarray(x),
                                    jax.tree.map(jnp.asarray, cache), jcfg,
                                    active=jnp.asarray(active))
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    ty, tc = tssm.mamba_decode_step(tp, torch.from_numpy(x), tcache, tcfg,
                                    active=torch.from_numpy(active))
    live = active.nonzero()[0]
    np.testing.assert_allclose(ty.numpy()[live], np.asarray(jy)[live], **TOL)
    for k in cache:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **TOL)
        # inactive lanes come back bit for bit; the input is not written
        np.testing.assert_array_equal(tc[k].numpy()[~active],
                                      cache[k][~active])
        np.testing.assert_array_equal(tcache[k].numpy(), cache[k])
        assert not np.array_equal(tc[k].numpy()[active], cache[k][active])


def test_conv_tail_at_matches_jax():
    """Rows shorter than the K-1 window are zero-filled before their
    start, as the zero-initialised conv cache is."""
    jcfg, tcfg = _cfgs()
    jp, tp = _mamba_params(jcfg, seed=5)
    rng = np.random.RandomState(6)
    h = rng.randn(4, 16, jcfg.d_model).astype(np.float32)
    lens = np.array([16, 5, 2, 1], np.int32)
    want = np.asarray(jssm.conv_tail_at(jp, jnp.asarray(h), jcfg,
                                        jnp.asarray(lens)))
    got = tssm.conv_tail_at(tp, torch.from_numpy(h), tcfg,
                            torch.from_numpy(lens)).numpy()
    assert got.shape == (4, jcfg.ssm_conv - 1, want.shape[-1])
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[2, 0].any() and not got[3, :2].any()


def test_init_mamba_cache_matches_jax():
    jcfg, tcfg = _cfgs()
    j = jssm.init_mamba_cache(jcfg, 3, jnp.bfloat16)
    t = tssm.init_mamba_cache(tcfg, 3, torch.bfloat16)
    for k in j:
        assert tuple(t[k].shape) == j[k].shape
        assert str(t[k].dtype).split(".")[-1] == str(j[k].dtype)
        assert not t[k].any()
