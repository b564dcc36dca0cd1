"""The port's moe family (qwen2-moe-a2.7b, reduced: 8 routed experts
padded to 16, top-2, one shared expert, ``moe_d_ff`` 32) against the JAX
package, on the same weights.

JAX initialises the params (float32 unless a case says bf16); the bridge
carries them over bit for bit; both sides run the same inputs.  Compared:

- the config, the param tree, the bridge (every leaf bit for bit) and the
  router's exemption from ``quantize_params`` (codes bit for bit);
- ``_route`` against ``lax.top_k`` on planted ties (the lower expert index
  first);
- the grouped GEMM's plain version against ``jax.lax.ragged_dot``
  (float32 within 1e-5 (|x| @ |W|), bf16 within 2 bf16 steps of |ref|
  plus that), with empty groups, one full group and rows past the groups'
  sum; and its row invariance: a row's bits alone and inside groups of 2,
  7, 16 and 136 rows at any place;
- ``moe_ffn`` (float32 within rtol 1e-5 of JAX's, atol 1e-5 of the sum of
  the magnitudes it adds up; bf16 within 2 bf16 steps of JAX's plus 2 bf16
  steps of that magnitude, a one-step flip of a bf16 expert output
  upstream), W8A8 shared experts included;
- ``forward``, the paged prefill and decode logits (tests/test_torch_
  model.py's tolerances: 1e-4 float32, 5e-3 W8A8 and W4A16);
- chunked == one-shot bit for bit in float32 at budgets 1, 7 and 16;
- the engines' greedy streams on margin-checked prompts, over bf16 and
  int8 KV pools.

Routing decides several of these equalities: a token whose k-th and
(k+1)-th router logits are within float32 noise could take another expert
on either side.  Every such comparison asserts the router's top-k margin
first (at every layer and position of the run), as the logit margin is
asserted before greedy streams are compared
(tests/test_quant_serving.py:83-99).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.quant.convert import quantize_params as jquantize
from repro.serving.core import EngineCore as JEngine, Request as JRequest
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.grouped_gemm import ops as gg_ops
from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models.layers import fixed_row_matmul
from repro_torch.quant.convert import quantize_params as tquantize
from repro_torch.serving.core import EngineCore as TEngine, Request as TRequest
from _torch_threads import one_thread  # noqa: F401  (autouse)
from test_torch_chunked import _chunked_then_decode
from test_torch_hybrid import _assert_same_tree, _bridge, _jax_params
from test_torch_serving import _drive

ARCH = "qwen2-moe-a2.7b"
ATOL = {"float": 1e-4, "w8a8": 5e-3, "w4a16": 5e-3}
MARGIN = 1e-2          # logit and router margins of the engine prompts
ROUTE_MARGIN = 1e-3    # router margin of the direct comparisons
SLOTS, MAX_SEQ, PAGE = 3, 32, 4


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _bf16_step(a: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126))) - 7)


@contextlib.contextmanager
def _router_margins():
    """Record, for every ``_route`` call the port makes inside the block,
    each row's k-th / (k+1)-th router logit gap (a float32 tensor)."""
    seen = []
    orig = TMOE._route

    def route(params, xt, cfg, e):
        logits = fixed_row_matmul(xt.float(), params["router"]["w"].float())
        top = torch.sort(logits[:, :cfg.n_experts], -1, descending=True)[0]
        seen.append(top[:, cfg.top_k - 1] - top[:, cfg.top_k])
        return orig(params, xt, cfg, e)

    TMOE._route = route
    try:
        yield seen
    finally:
        TMOE._route = orig


def _margin_of(x: np.ndarray, w: np.ndarray, cfg) -> float:
    """Smallest k-th / (k+1)-th router logit gap over the rows of x,
    computed in float64."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ w.astype(
        np.float64)[:, :cfg.n_experts]
    top = -np.sort(-logits, -1)
    return float((top[:, cfg.top_k - 1] - top[:, cfg.top_k]).min())


def _clear_prompt(cfg, params, n, rng) -> list[int]:
    """The first of ``rng``'s n-token prompts whose every position clears
    ROUTE_MARGIN at every layer (the port's ``forward``), the way the
    engine tests draw margin-checked prompts."""
    while True:
        prompt = rng.randint(0, cfg.vocab_size, n).tolist()
        with _router_margins() as margins:
            TM.forward(params, cfg, torch.tensor([prompt]))
        if min(float(m.min()) for m in margins) > ROUTE_MARGIN:
            return prompt


@pytest.fixture(scope="module", params=["float", "w8a8"])
def case(request):
    jcfg, jparams = _jax_params(ARCH, request.param)
    return request.param, jcfg, jparams, _bridge(jparams)


# ---------------------------------------------------------------------------
# config, params, bridge, quantization
# ---------------------------------------------------------------------------


def test_config_and_padding_match_jax():
    for full in (True, False):
        j = jget_arch(ARCH) if full else jget_arch(ARCH).reduced()
        t = get_arch(ARCH) if full else get_arch(ARCH).reduced()
        assert j.__dict__ == t.__dict__
        assert TMOE.padded_experts(t) == JMOE.padded_experts(j) \
            == (64 if full else 16)
    assert TM.supports_paged(t) and TM.supports_chunked_prefill(t)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_init_params_tree_matches_jax(dtype):
    """The port's own init: the bridged JAX tree's keys, shapes and dtypes
    (the router float32 whatever the model dtype)."""
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jparams = JM.init_params(jget_arch(ARCH).reduced(),
                             jax.random.PRNGKey(0), dtype=jd, max_seq=64)
    want = _shapes(_bridge(jparams))
    got = _shapes(TM.init_params(get_arch(ARCH).reduced(), device="cpu",
                                 dtype=dtype, max_seq=64))
    assert got == want
    assert got["layers"][0]["moe"]["router"]["w"][1] == torch.float32


@pytest.mark.parametrize("quant", ["float", "w8a8", "w4a16"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_bridge_round_trips_every_leaf(dtype, quant):
    """Every leaf of the JAX tree, layer i of a stacked leaf against the
    port's ``layers[i]``, bit for bit (bf16 through its 16-bit pattern)."""
    jparams = JM.init_params(jget_arch(ARCH).reduced(),
                             jax.random.PRNGKey(2), dtype=dtype, max_seq=64)
    if quant != "float":
        jparams = jquantize(jparams, mode=quant)
    tparams = _bridge(jparams)
    leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(leaves) > 10
    for path, leaf in leaves:
        keys = [p.key for p in path]
        arr = np.asarray(leaf)
        if keys[0] == "layers":
            items = [(arr[i], tparams["layers"][i]) for i in range(len(arr))]
            keys = keys[1:]
        else:
            items = [(arr, tparams)]
        for want, node in items:
            for k in keys:
                node = node[k]
            if want.dtype.name == "bfloat16":
                assert node.dtype == torch.bfloat16, keys
                np.testing.assert_array_equal(
                    node.view(torch.int16).numpy(), want.view(np.int16))
            else:
                np.testing.assert_array_equal(node.numpy(), want,
                                              err_msg=str(keys))


@pytest.mark.parametrize("mode", ["w8a8", "w4a16"])
def test_quantize_exempts_the_router_as_jax_does(mode):
    """``quantize_params`` on the bridged float32 tree equals JAX's on its
    own, bit for bit: the router stays a float32 ``{"w"}``, the routed
    stacks stay float, the shared experts become W8A8 (stacked under
    ``layers``, so W8A8 under ``w4a16`` too), the lm_head W4A16 under
    ``w4a16``."""
    jcfg, jparams = _jax_params(ARCH, "float")
    got = tquantize(_bridge(jparams), mode=mode)
    want = _bridge(jquantize(jparams, mode=mode))
    _assert_same_tree(got, want)
    moe = got["layers"][1]["moe"]
    assert set(moe["router"]) == {"w"} and moe["router"]["w"].dtype \
        == torch.float32
    assert set(moe["shared"]["up"]) == {"w_q", "scale"}
    assert moe["up"].dim() == 3 and moe["up"].dtype == torch.float32
    assert ("w_p4" in got["lm_head"]) == (mode == "w4a16")


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def test_route_breaks_ties_as_lax_top_k():
    """Planted ties: duplicated router columns (experts 1 = 0, 5 = 3 = 4)
    and an all-zero token, whose real experts all score 0.  The experts
    and probabilities equal JAX's ``_route``: the lower index first among
    equals, never a padded expert."""
    cfg = get_arch(ARCH).reduced()
    jcfg = jget_arch(ARCH).reduced()
    e = TMOE.padded_experts(cfg)
    rng = np.random.RandomState(5)
    w = rng.randn(cfg.d_model, e).astype(np.float32)
    w[:, 1] = w[:, 0]
    w[:, 4] = w[:, 5] = w[:, 3]
    x = rng.randn(9, cfg.d_model).astype(np.float32)
    x[4] = 0.0
    x[7] = -x[2]
    ji, jp = JMOE._route({"router": {"w": jnp.asarray(w)}}, jnp.asarray(x),
                         jcfg, e)
    ti, tp = TMOE._route({"router": {"w": torch.from_numpy(w)}},
                         torch.from_numpy(x), cfg, e)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5)
    assert ti[4].tolist() == [0, 1]
    assert (ti < cfg.n_experts).all()


# ---------------------------------------------------------------------------
# the grouped GEMM's plain version
# ---------------------------------------------------------------------------

GROUPS = {
    "empty groups": [3, 0, 0, 5, 1, 0, 7, 2],
    "one full group": [0, 0, 18, 0, 0, 0, 0, 0],
    "rows past the sum": [2, 0, 4, 0, 3, 0, 0, 1],
    "all singletons": [1] * 8,
}


def _gg_inputs(rng, r, k, n, e, dtype):
    x = rng.randn(r, k).astype(np.float32)
    w = (rng.randn(e, k, n) * k ** -0.5).astype(np.float32)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    return (jx, jw, torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt),
            torch.tensor(np.asarray(jw.astype(jnp.float32))).to(tdt))


def _abs_product(x, w, sizes):
    """(|x| @ |W_e(r)|) per row, float64; rows past the sum 0."""
    x = np.abs(x.astype(np.float64))
    w = np.abs(w.astype(np.float64))
    out = np.zeros((x.shape[0], w.shape[2]))
    start = 0
    for e, g in enumerate(sizes):
        out[start:start + g] = x[start:start + g] @ w[e]
        start += g
    return out


@pytest.mark.parametrize("groups", sorted(GROUPS))
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_grouped_gemm_ref_matches_ragged_dot(groups, dtype):
    sizes = GROUPS[groups]
    r, k, n = 18, 64, 40
    jx, jw, tx, tw = _gg_inputs(np.random.RandomState(len(groups)), r, k, n,
                                len(sizes), dtype)
    gs = np.array(sizes, np.int32)
    want = np.asarray(jax.lax.ragged_dot(jx, jw, jnp.asarray(gs)).astype(
        jnp.float32))
    before = dict(gg_ops.LAUNCHES)
    got = gg_ops.grouped_gemm(tx, tw, torch.from_numpy(gs))
    assert gg_ops.LAUNCHES == before    # a CPU tensor takes the plain version
    assert got.dtype == tx.dtype and got.shape == (r, n)
    mag = _abs_product(_np(tx), _np(tw), sizes)
    limit = 1e-5 * mag
    if dtype == jnp.bfloat16:
        limit = limit + 2 * _bf16_step(want)
    err = np.abs(_np(got) - want)
    assert (err <= limit).all(), float((err - limit).max())
    tail = sum(sizes)
    assert not _np(got)[tail:].any() and not want[tail:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_grouped_gemm_ref_row_bits_do_not_depend_on_the_group(dtype):
    """Expert 3's row v: alone (a group of 1) and inside groups of 2, 7,
    16 and 136 rows, first, in the middle and last, with other experts'
    rows before and after: the same bits every time."""
    gen = torch.Generator().manual_seed(7)
    k, n, e = 64, 48, 16
    w = (torch.randn((e, k, n), generator=gen) * k ** -0.5).to(dtype)
    v = torch.randn((1, k), generator=gen).to(dtype)

    def row_of(size, place):
        sizes = torch.zeros(e, dtype=torch.int32)
        sizes[1], sizes[3], sizes[9] = 5, size, 3
        x = torch.randn((int(sizes.sum()), k), generator=gen).to(dtype)
        at = 5 + {"first": 0, "middle": size // 2, "last": size - 1}[place]
        x[at] = v[0]
        return grouped_gemm_ref(x, w, sizes)[at]

    alone = row_of(1, "first")
    for size in (2, 7, 16, 136):
        for place in ("first", "middle", "last"):
            assert torch.equal(row_of(size, place), alone), (size, place)


def test_grouped_gemm_wrapper_refuses_other_devices():
    x = torch.empty((4, 16), dtype=torch.bfloat16, device="meta")
    w = torch.empty((2, 16, 8), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        gg_ops.grouped_gemm(x, w, torch.zeros(2, dtype=torch.int32,
                                              device="meta"))


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------


def _moe_magnitude(tlp, xt, cfg) -> torch.Tensor:
    """float32 [n, D]: what ``moe_ffn`` adds up, in magnitude: each chosen
    expert's |output| weighted by its probability, plus the shared
    experts' |output|."""
    e = TMOE.padded_experts(cfg)
    topi, probs = TMOE._route(tlp, xt, cfg, e)
    rows = []
    for r in range(len(xt)):
        acc = torch.zeros(cfg.d_model)
        for j in range(cfg.top_k):
            one = torch.zeros(e, dtype=torch.int32)
            one[topi[r, j]] = 1
            acc += probs[r, j] * TMOE._expert_gemm(
                tlp, xt[r:r + 1], one, cfg)[0].float().abs()
        rows.append(acc)
    return torch.stack(rows) + TMOE._shared_ffn(tlp, xt, cfg).float().abs()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_moe_ffn_matches_jax(case, dtype, monkeypatch):
    """Layer 1's MoE on 2 x 7 tokens against JAX's; the router margin
    asserted first.

    JAX's ``moe_ffn`` runs op by op, each ``linear`` of it under jit: under
    jit XLA's CPU backend keeps excess precision and skips some of the
    bf16 roundings the source writes (the silu cast, the expert outputs;
    up to 4 bf16 steps of the output here), while a W8A8 linear's
    activation scale is what the jitted engine computes (a multiply by the
    float32 reciprocal of 127, as the port computes it; see
    ``models/layers.py::_w8a8_matmul``)."""
    quant, jcfg, jparams, _ = case
    jlp = jax.tree.map(lambda a: a[1], jparams["layers"]["moe"])
    if dtype == jnp.bfloat16:   # the model's dtype; the router stays f32
        jlp = {k: (v if k == "router" else jax.tree.map(
            lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32
            and a.ndim > 1 else a, v)) for k, v in jlp.items()}
    tlp = _bridge(jlp)
    cfg = get_arch(ARCH).reduced()
    x = np.random.RandomState(9).randn(2, 7, cfg.d_model).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    x32 = np.array(jx.astype(jnp.float32))
    assert _margin_of(x32, _np(tlp["router"]["w"]), cfg) > ROUTE_MARGIN
    monkeypatch.setattr(JMOE, "linear", jax.jit(JMOE.linear))
    want = np.asarray(JMOE.moe_ffn(jlp, jx, jcfg).astype(jnp.float32))
    tx = torch.from_numpy(x32).to(torch.float32 if dtype == jnp.float32
                                  else torch.bfloat16)
    got = TMOE.moe_ffn(tlp, tx, cfg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    mag = _np(_moe_magnitude(tlp, tx.reshape(-1, cfg.d_model), cfg)
              ).reshape(want.shape)
    err = np.abs(_np(got) - want)
    if dtype == jnp.float32:
        limit = 1e-5 * np.abs(want) + 1e-5 * mag
    else:
        limit = 2 * _bf16_step(want) + 2 * _bf16_step(mag)
    assert (err <= limit).all(), float((err - limit).max())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", ["float", "w8a8", "w4a16"])
def test_forward_matches_jax(quant):
    """Teacher-forced logits on 2 x 10 tokens (W4A16: the lm_head W4A16
    over W8A8 layers, as JAX quantizes the tree)."""
    jcfg, jparams = _jax_params(ARCH, quant)
    tparams = _bridge(jparams)
    cfg = get_arch(ARCH).reduced()
    toks = np.random.RandomState(13).randint(0, cfg.vocab_size, (2, 10)
                                             ).astype(np.int32)
    with _router_margins() as margins:
        tl = TM.forward(tparams, cfg, torch.from_numpy(toks))
    assert min(float(m.min()) for m in margins) > ROUTE_MARGIN
    jl = jax.jit(lambda p, t: JM.forward(p, jcfg, t))(jparams, toks)
    assert tl.shape == (2, 10, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL[quant])


def test_paged_prefill_and_decode_match_jax(case):
    """Two right-padded prompts into slots 2 and 0 of pages out of order,
    then 3 decode steps with slot 1 idle: logits, lengths and pages."""
    quant, jcfg, jparams, tparams = case
    cfg = get_arch(ARCH).reduced()
    rng = np.random.RandomState(11)
    lens = np.array([5, 13], np.int32)
    toks = np.zeros((2, 16), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = _clear_prompt(cfg, tparams, n, rng)
    slot_ids = np.array([2, 0], np.int32)
    block = np.zeros((SLOTS, MAX_SEQ // PAGE), np.int32)
    block[2, :4] = [7, 3, 9, 1]
    block[0, :5] = [2, 11, 4, 5, 6]
    jcache = JM.init_paged_cache(jcfg, SLOTS, MAX_SEQ, dtype=jnp.float32,
                                 page_size=PAGE)
    jcache["block"] = jnp.asarray(block)
    tcache = TM.init_paged_cache(cfg, SLOTS, MAX_SEQ, dtype=torch.float32,
                                 page_size=PAGE, device="cpu")
    tcache["block"] = torch.from_numpy(block)
    jprefill = jax.jit(lambda p, t, tl, c, s: JM.prefill_into_slots(
        p, jcfg, t, tl, c, s))
    jdecode = jax.jit(lambda p, t, c, a: JM.decode_step_paged(
        p, jcfg, t, c, a))
    with _router_margins() as margins:
        tl, tcache = TM.prefill_into_slots(
            tparams, cfg, torch.from_numpy(toks), torch.from_numpy(lens),
            tcache, torch.from_numpy(slot_ids))
    # the pads route too; only the valid tokens' margins count
    valid = torch.from_numpy(np.arange(16)[None] < lens[:, None]).reshape(-1)
    assert min(float(m[valid].min()) for m in margins) > ROUTE_MARGIN
    jl, jcache = jprefill(jparams, toks, lens, jcache, slot_ids)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL[quant])
    active = np.array([True, False, True])
    nxt = np.zeros((SLOTS,), np.int32)
    nxt[slot_ids] = np.argmax(np.asarray(jl), -1)
    for step in range(3):
        jl, jcache = jdecode(jparams, nxt, jcache, active)
        with _router_margins() as margins:
            tl, tcache = TM.decode_step_paged(
                tparams, cfg, torch.from_numpy(nxt), tcache,
                torch.from_numpy(active))
        live = active.nonzero()[0]
        assert min(float(m[live].min()) for m in margins) > ROUTE_MARGIN
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   rtol=0, atol=ATOL[quant],
                                   err_msg=f"decode step {step}")
        nxt = np.where(active, np.argmax(np.asarray(jl), -1), 0
                       ).astype(np.int32)
    np.testing.assert_array_equal(tcache["lens"].numpy(),
                                  np.asarray(jcache["lens"]))
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=0, atol=ATOL[quant])


@pytest.mark.parametrize("budget", [1, 7, 16])
def test_chunked_prefill_bit_identical_to_one_shot(budget):
    """float32 weights and pools: a 21-token prompt prefilled in chunks of
    ``budget`` leaves the valid K/V rows, the first token's logits and 5
    decode logits equal, bit for bit, to the single chunk's."""
    _, jparams = _jax_params(ARCH, "float")
    params, cfg = _bridge(jparams), get_arch(ARCH).reduced()
    prompt = np.random.RandomState(21).randint(0, cfg.vocab_size, 21
                                               ).tolist()
    one_shot, one_rows = _chunked_then_decode(cfg, params, prompt,
                                              len(prompt), "bf16")
    got, rows = _chunked_then_decode(cfg, params, prompt, budget, "bf16")
    for key in one_rows:
        assert torch.equal(rows[key], one_rows[key]), key
    for a, b in zip(one_shot, got):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ENG = dict(max_batch=3, max_seq=48, eos_id=-1, page_size=8)


def _margins(cfg, params, prompt, n_new) -> tuple[float, float]:
    """(smallest top-1 / top-2 logit gap, smallest router gap) of the
    port's greedy run of ``prompt`` alone (tests/test_torch_serving.py's
    ``_min_margin``, which the engine's bf16 pools match)."""
    cache = TM.init_paged_cache(cfg, 1, 64, dtype=torch.bfloat16,
                                page_size=8, device="cpu")
    cache["block"] = torch.arange(1, 9, dtype=torch.int32)[None]
    gaps = []
    with _router_margins() as routes:
        logits, cache = TM.prefill_into_slots(
            params, cfg, torch.tensor([prompt]), torch.tensor([len(prompt)]),
            cache, torch.tensor([0]))
        for _ in range(n_new):
            top = torch.topk(logits[0], 2).values
            gaps.append(float(top[0] - top[1]))
            tok = torch.argmax(logits, -1).to(torch.int32)
            logits, cache = TM.decode_step_paged(params, cfg, tok, cache,
                                                 torch.tensor([True]))
    return min(gaps), min(float(m.min()) for m in routes)


@pytest.mark.parametrize("quant", ["float", "w8a8", "w4a16"])
def test_engine_streams_match_jax(quant):
    """Arrivals while other slots decode (the admission groups route
    together with the decoding slots' rows): the same events at the same
    steps as the JAX engine, on prompts whose greedy runs clear MARGIN in
    the logits and in the router."""
    jcfg, jparams = _jax_params(ARCH, quant)
    tparams, cfg = _bridge(jparams), get_arch(ARCH).reduced()
    rng = np.random.RandomState(3)
    max_new = [8, 4, 7, 6, 5]
    prompts = []
    while len(prompts) < len(max_new):
        p = rng.randint(0, cfg.vocab_size, rng.randint(3, 20)).tolist()
        if min(_margins(cfg, tparams, p, max_new[len(prompts)])) > MARGIN:
            prompts.append(p)
    arrive = [0, 0, 1, 3, 4]
    trace = [(a, rid, p, mn) for rid, (a, p, mn)
             in enumerate(zip(arrive, prompts, max_new))]
    j = JEngine(jcfg, jparams, **ENG)
    t = TEngine(cfg, tparams, **ENG, device="cpu")
    jsteps, jreqs = _drive(j, JRequest, trace)
    tsteps, treqs = _drive(t, TRequest, trace)
    assert tsteps == jsteps
    for rid in jreqs:
        assert treqs[rid].out_tokens == jreqs[rid].out_tokens
    assert t.stats.prefills == j.stats.prefills > 1


def test_int8_kv_engine_streams_match_jax():
    """The same trace over int8 KV pools (the dense family's pages, rows
    quantized at their write): the port's events equal the JAX int8
    engine's, synchronous and overlapped."""
    jcfg, jparams = _jax_params(ARCH, "float")
    tparams, cfg = _bridge(jparams), get_arch(ARCH).reduced()
    rng = np.random.RandomState(8)
    prompts = []
    while len(prompts) < 3:
        p = rng.randint(0, cfg.vocab_size, rng.randint(3, 20)).tolist()
        if min(_margins(cfg, tparams, p, 6)) > MARGIN:
            prompts.append(p)
    trace = [(a, rid, p, 6) for rid, (a, p) in enumerate(zip([0, 0, 2],
                                                             prompts))]
    jsteps, jreqs = _drive(JEngine(jcfg, jparams, kv_dtype="int8", **ENG),
                           JRequest, trace)
    for overlap in (False, True):
        t = TEngine(cfg, tparams, kv_dtype="int8", overlap=overlap, **ENG,
                    device="cpu")
        tsteps, treqs = _drive(t, TRequest, trace)
        if not overlap:   # the overlapped loop reads each token a step late
            assert tsteps == jsteps
        assert {r: treqs[r].out_tokens for r in treqs} \
            == {r: jreqs[r].out_tokens for r in jreqs}
