"""The port's threefry keys and per-request sampler against ``jax.random``
and ``repro.serving.sampler`` (jax 0.9.0, partitionable threefry).

Exact: keys (``PRNGKey``, ``fold_in``), raw bits and ``uniform``: integer
arithmetic and one exactly rounded float32 subtraction.  Gumbel noise is
-log(-log(u)) on the same u, and each framework's float32 log is within
1 ulp of the other's; near g = 0 the outer log cancels (its argument is
within an ulp of 1), so the noise is held within GUMBEL_ULPS ulps of
max(|g|, 1).  Sampled tokens: greedy rows bit-equal; a stochastic row's
token equal wherever the top-2 gap of its cut logits plus noise exceeds
MARGIN (the noise's own error is ~1e-6; the top-p cut's cumulative sum may
differ in its last bit, which moves no token in these cases).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampler as JS
from repro_torch.serving import sampler as TS
from repro_torch.serving import threefry

SEEDS = [0, -7, 2**31 - 1, 12345]
COUNTS = [0, 1, 1000, 2**31 - 1]
GUMBEL_ULPS = 2
MARGIN = 1e-4


def _np(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = threefry.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    assert tk[0] == 0 and tk[1] == seed & 0xFFFFFFFF
    for c in COUNTS:
        np.testing.assert_array_equal(threefry.fold_in(tk, c).numpy(),
                                      _np(jax.random.fold_in(jk, c)))


@pytest.mark.parametrize("v", [32, 32000])
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_bit_exact(seed, v):
    for c in COUNTS[:3]:
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), c)
        tk = threefry.fold_in(threefry.PRNGKey(seed), c)
        np.testing.assert_array_equal(
            threefry.bits(tk, (v,)).numpy(),
            _np(jax.random.bits(jk, (v,))))
        ju = np.asarray(jax.random.uniform(jk, (v,)))
        tu = threefry.uniform(tk, (v,)).numpy()
        np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))
    # a 2-D shape counts over the flattened index
    np.testing.assert_array_equal(threefry.bits(tk, (3, 11)).numpy(),
                                  _np(jax.random.bits(jk, (3, 11))))


def test_batched_keys_match_vmapped_jax():
    seeds = np.array(SEEDS + [5, -1], np.int32)
    counts = np.array([0, 3, 9, 2**31 - 1, 7, 1], np.int32)
    jk = jax.vmap(lambda s, c: jax.random.fold_in(jax.random.PRNGKey(s), c)
                  )(seeds, counts)
    tk = threefry.fold_in(threefry.PRNGKey(torch.from_numpy(seeds)),
                          torch.from_numpy(counts))
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    np.testing.assert_array_equal(
        threefry.bits(tk, (100,)).numpy(),
        _np(jax.vmap(lambda k: jax.random.bits(k, (100,)))(jk)))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_two_ulps(seed):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    tk = threefry.fold_in(threefry.PRNGKey(seed), 3)
    jg = np.asarray(jax.jit(lambda k: jax.random.gumbel(k, (32000,)))(jk))
    tg = threefry.gumbel(tk, (32000,)).numpy()
    ulp = np.maximum(np.spacing(np.abs(jg)), np.spacing(np.float32(1)))
    assert np.isfinite(tg).all()
    assert (np.abs(tg - jg) <= GUMBEL_ULPS * ulp).all(), \
        float((np.abs(tg - jg) / ulp).max())


def _rows(b, rng):
    """Mixed rows: greedy, top-k, top-p, both, plain temperature."""
    kinds = [(0.0, 0, 1.0), (0.8, 20, 1.0), (1.0, 0, 0.9), (0.7, 5, 0.5),
             (1.3, 0, 1.0), (0.9, 50, 0.95)]
    temps, topk, topp = (np.array([kinds[i % len(kinds)][j]
                                   for i in range(b)], dt)
                         for j, dt in enumerate((np.float32, np.int32,
                                                 np.float32)))
    seeds = rng.randint(-2**31, 2**31 - 1, b).astype(np.int32)
    counts = rng.randint(0, 500, b).astype(np.int32)
    return seeds, counts, temps, topk, topp


def _cut_logits_plus_noise(logits, seeds, counts, temps, topk, topp):
    """The port's sample_batch up to the argmax: the cut logits plus each
    row's gumbel noise."""
    t = [torch.from_numpy(a) for a in (logits, seeds, counts, temps, topk,
                                       topp)]
    lg = t[0].float() / torch.clamp_min(t[3], 1e-6)[:, None]
    b, v = lg.shape
    order = torch.argsort(-lg, dim=-1, stable=True)
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(v).expand(b, v))
    lg = torch.where(ranks < torch.where(t[4] > 0, t[4], v)[:, None], lg,
                     TS.NEG_INF)
    sorted_lg = torch.gather(lg, 1, order)
    cum = torch.cumsum(torch.softmax(sorted_lg, -1), -1)
    idx = (cum < t[5][:, None]).sum(-1, keepdim=True)
    cut = torch.gather(sorted_lg, 1, idx.clamp_max(v - 1))
    lg = torch.where((lg < cut) & (idx < v), TS.NEG_INF, lg)
    keys = threefry.fold_in(threefry.PRNGKey(t[1]), t[2])
    return lg + threefry.gumbel(keys, (v,))


@pytest.mark.parametrize("v", [32, 32000])
def test_sample_batch_matches_jax(v):
    rng = np.random.RandomState(v)
    b = 24
    logits = (rng.randn(b, v) * 3).astype(np.float32)
    rows = _rows(b, rng)
    want = np.asarray(jax.jit(JS.sample_batch)(logits, *rows))
    got = TS.sample_batch(*(torch.from_numpy(a)
                            for a in (logits, *rows))).numpy()
    assert got.dtype == np.int32
    greedy = rows[2] <= 0
    np.testing.assert_array_equal(got[greedy], want[greedy])
    np.testing.assert_array_equal(got[greedy], logits[greedy].argmax(-1))
    z = _cut_logits_plus_noise(logits, *rows)
    np.testing.assert_array_equal(z.argmax(-1).numpy()[~greedy],
                                  got[~greedy])
    top2 = torch.topk(z, 2).values
    wide = ((top2[:, 0] - top2[:, 1]) > MARGIN).numpy() & ~greedy
    assert wide.sum() >= 0.9 * (~greedy).sum()   # the check has teeth
    np.testing.assert_array_equal(got[wide], want[wide])
    # top-k rows never draw outside their k best logits
    for r in np.flatnonzero((rows[3] > 0) & ~greedy):
        rank = (logits[r] > logits[r, got[r]]).sum()
        assert rank < rows[3][r]


def test_fused_sample_greedy_only_is_the_argmax():
    rng = np.random.RandomState(3)
    logits = torch.from_numpy((rng.randn(6, 300) * 2).astype(np.float32))
    rows = [torch.from_numpy(a) for a in _rows(6, rng)]
    rows[2] = torch.zeros(6)   # every row greedy
    fused = TS.fused_sample(logits, *rows, greedy_only=True)
    np.testing.assert_array_equal(fused.numpy(), TS.greedy(logits).numpy())
    np.testing.assert_array_equal(
        TS.fused_sample(logits, *rows, greedy_only=False).numpy(),
        fused.numpy())


def test_ties_go_to_the_lower_index():
    """jnp.argsort and jnp.argmax keep the lower vocab id first among ties;
    so do the port's stable argsort and argmax: top_k = 1 over a three-way
    tie keeps id 1 alone, whatever the noise."""
    logits = np.array([[1.0, 3.0, 3.0, 0.0, 3.0]] * 4, np.float32)
    seeds = np.array([0, 1, 2, 3], np.int32)
    counts = np.zeros(4, np.int32)
    temps = np.array([0.0, 1.0, 1.0, 1.0], np.float32)
    topk = np.array([0, 1, 1, 1], np.int32)
    topp = np.ones(4, np.float32)
    args = (logits, seeds, counts, temps, topk, topp)
    want = np.asarray(jax.jit(JS.sample_batch)(*args))
    got = TS.sample_batch(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, [1, 1, 1, 1])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (10, 1.0), (0, 0.8),
                                         (40, 0.9)])
def test_sample_matches_jax(top_k, top_p):
    """The global-setting sampler: one key draws the noise of the whole
    [B, V] batch."""
    rng = np.random.RandomState(top_k)
    logits = (rng.randn(4, 1000) * 2).astype(np.float32)
    want = np.asarray(JS.sample(jnp.asarray(logits), jax.random.PRNGKey(9),
                                temperature=0.7, top_k=top_k, top_p=top_p))
    got = TS.sample(torch.from_numpy(logits), threefry.PRNGKey(9),
                    temperature=0.7, top_k=top_k, top_p=top_p).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        TS.sample(torch.from_numpy(logits), threefry.PRNGKey(9),
                  temperature=0.0).numpy(), logits.argmax(-1))
