"""The layer-by-layer build and the blocked float32 ``lm_head``.

``serving.fleet.worker.build_params`` quantizes each top-level entry and
each layer as ``init_params`` makes it (its ``finish`` callable), so no
more than one layer's float weights are alive at a time.  Held here:

- the result equals the whole model's ``init_params`` followed by
  ``quantize_params``, tensor for tensor (``torch.equal``, dtypes and key
  sets too), for one reduced configuration of every ported family (and
  opt-6.7b: a tied embedding, learned positions, LayerNorm), W8A8 and
  W4A16;
- each layer's float weights are gone before the next layer's are drawn;
- ``init_params`` with no ``finish`` is unchanged (the same bits as with
  an identity ``finish``).

``models.model.lm_head`` multiplies a float or W8A8 head LM_HEAD_BLOCK
vocabulary rows at a time.  Against one block over the whole vocabulary
(vocabulary 256, blocks of 48 rows: five full blocks and a short one):
|blocked - one block| <= 1e-6 (|x| @ |W|) + 1e-7, float32 summation noise
of a product over another column count (on this CPU the two agree bit for
bit).  A row's bits stay independent of the batch at any block size.
"""

import gc
import weakref

import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.models import model as TM
from repro_torch.quant import convert
from repro_torch.serving.fleet.worker import build_params

ARCHS = ("smollm-360m", "opt-6.7b", "qwen2-vl-72b", "qwen2-moe-a2.7b",
         "deepseek-v2-lite-16b", "zamba2-7b", "mamba2-130m", "whisper-small",
         "command-r-plus-104b")


def _assert_equal_trees(got, want, path="params"):
    if want is None:
        assert got is None, path
    elif isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_equal_trees(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal_trees(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and torch.equal(got, want), path


def test_every_ported_family_is_covered():
    fams = {get_arch(a).family for a in ARCHS}
    assert fams == set(TM.MODEL_FAMILIES), fams


@pytest.mark.parametrize("mode", ["w8a8", "w4a16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_layer_by_layer_build_equals_init_then_quantize(arch, mode):
    cfg = get_arch(arch).reduced()
    want = convert.quantize_params(
        TM.init_params(cfg, seed=3, max_seq=32, device="cpu"), mode=mode)
    got_cfg, got = build_params(arch, reduced=True, max_seq=32, seed=3,
                                quant=mode, device="cpu")
    assert got_cfg == cfg
    _assert_equal_trees(got, want)
    if mode == "w4a16" and "lm_head" in want:
        assert "w_p4" in got["lm_head"]     # the unstacked head is W4A16


@pytest.mark.parametrize("arch", ["command-r-plus-104b", "qwen2-vl-72b",
                                  "deepseek-v2-lite-16b"])
def test_a_cut_config_builds_the_whole_models_first_layers(arch):
    """``build_params`` given a ModelConfig cut to fewer layers (how a
    model the card cannot hold whole is served at a depth cut) draws the
    whole model's embedding, head, norms and first layers bit for bit
    (mla_moe: its dense first layer among them)."""
    import dataclasses

    cfg = get_arch(arch).reduced()
    whole_cfg = dataclasses.replace(cfg, n_layers=4)
    cut_cfg = dataclasses.replace(cfg, n_layers=2)
    _, whole = build_params(whole_cfg, reduced=False, max_seq=32, seed=4,
                            quant="w8a8", device="cpu")
    got_cfg, cut = build_params(cut_cfg, reduced=False, max_seq=32, seed=4,
                                quant="w8a8", device="cpu")
    assert got_cfg == cut_cfg
    n_stack = cut_cfg.n_layers - cut_cfg.first_k_dense
    assert len(cut["layers"]) == n_stack < len(whole["layers"])
    _assert_equal_trees(cut, {**whole, "layers": whole["layers"][:n_stack]})


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "zamba2-7b",
                                  "deepseek-v2-lite-16b"])
def test_no_two_layers_of_float_weights_alive(arch, monkeypatch):
    """Every float matrix handed to the quantizer is dead (no reference
    left anywhere) by the time the next subtree reaches it."""
    quantize, seen, calls, depth = convert.quantize_params, [], [], [0]

    def floats(tree):
        if isinstance(tree, dict):
            return [t for v in tree.values() for t in floats(v)]
        if isinstance(tree, list):
            return [t for v in tree for t in floats(v)]
        if isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16 \
                and tree.dim() >= 2:
            return [tree]
        return []

    def watched(tree, *a, **kw):
        if depth[0]:    # the quantizer's own recursion into the subtree
            return quantize(tree, *a, **kw)
        gc.collect()
        alive = [i for i, r in seen if r() is not None]
        assert not alive, f"float weights of subtrees {alive} still alive"
        calls.append(1)
        mats = floats(tree)
        depth[0] += 1
        try:
            out = quantize(tree, *a, **kw)
        finally:
            depth[0] -= 1
        # the embedding (and bf16 expert stacks) stay as they are
        kept = {id(t) for t in floats(out)}
        seen.extend((len(calls), weakref.ref(t)) for t in mats
                    if id(t) not in kept)
        return out

    monkeypatch.setattr(convert, "quantize_params", watched)
    build_params(arch, reduced=True, max_seq=32, quant="w8a8", device="cpu")
    cfg = get_arch(arch).reduced()
    assert len(calls) >= cfg.n_layers + 3


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "opt-6.7b"])
def test_init_without_finish_is_unchanged(arch):
    cfg = get_arch(arch).reduced()
    plain = TM.init_params(cfg, seed=5, max_seq=32, device="cpu")
    same = TM.init_params(cfg, seed=5, max_seq=32, device="cpu",
                          finish=lambda tree, stacked: tree)
    _assert_equal_trees(same, plain)


def _head(kind):
    import dataclasses

    from repro_torch.models.layers import init_linear

    cfg = get_arch("llama2-7b").reduced()
    gen = torch.Generator().manual_seed(17)
    if kind == "tied":
        cfg = dataclasses.replace(cfg, tie_embeddings=True)
        return cfg, {"embed": torch.randn((cfg.vocab_size, cfg.d_model),
                                          generator=gen) * 0.02}, gen
    params = {"lm_head": init_linear(gen, cfg.d_model, cfg.vocab_size, False,
                                     torch.float32, torch.device("cpu"))}
    if kind == "w8a8":
        params = convert.quantize_params(params)
    return cfg, params, gen


@pytest.mark.parametrize("kind", ["w8a8", "float", "tied"])
def test_blocked_lm_head_matches_one_block(kind, monkeypatch):
    cfg, params, gen = _head(kind)
    x = torch.randn((11, cfg.d_model), generator=gen)
    assert cfg.vocab_size <= TM.LM_HEAD_BLOCK    # the tests' one block
    one = TM.lm_head(params, cfg, x)
    w = TM._head_block(params, cfg, 0, cfg.vocab_size)
    monkeypatch.setattr(TM, "LM_HEAD_BLOCK", 48)
    blocked = TM.lm_head(params, cfg, x)
    assert blocked.shape == (11, cfg.vocab_size)
    limit = 1e-6 * (x.abs() @ w.abs()) + 1e-7
    assert bool(((blocked - one).abs() <= limit).all())
    alone = torch.cat([TM.lm_head(params, cfg, x[r:r + 1])
                       for r in range(11)])
    for m in (1, 3, 8, 11):
        assert torch.equal(TM.lm_head(params, cfg, x[:m]), alone[:m]), m
