"""The port's distributed modules on SPMD ranks (8 gloo CPU processes,
``repro_torch.distributed.mesh.run_spmd``) against the JAX package's
sharded functions on a forced 8-device CPU mesh.

Both sides run once per module, each in processes of their own: the JAX
references in one subprocess (``tests/_jax_distributed_ref.py``, as
tests/test_distributed.py runs the JAX package's multi-device tests), the
port's cases on one 8-rank run (``tests/_torch_spmd_cases.py``); the
inputs come from numpy with fixed seeds, the params from ``jax.random``
bridged into the port.  Tolerances (float32 throughout):

- expert-parallel MoE (qwen2-moe-a2.7b reduced, meshes (2, 4) and (1, 2)):
  within MOE_TOL of max |y| of JAX's sharded ``moe_ffn`` (JAX's own test
  allows 2e-2 of its local path), and the port's local path on the same
  rank bit for bit, in float32 and in bf16 at the full config's top-4;
  a rank's buffer holds dump rows past its groups' sum;
- split-K decode (smollm-360m reduced, 2 kv heads over a model axis of
  4): prefill, then 4 ``decode_step``s; logits within DECODE_ATOL of
  JAX's ``decode_step`` under ``lowering_ctx(mesh=...)`` and of the
  port's unsharded ``decode_step``; the cache shards equal the unsharded
  cache's rows bit for bit where both paths wrote the same inputs (every
  prefill row, layer 0's decode rows; a later layer's decode rows come
  from hidden states the two attentions round differently: within
  DECODE_ATOL);
- pipeline (JAX's case): within 1e-5 of JAX's ``pipelined_forward``, the
  same bits as the port's sequential loop over the same microbatches;
- hybrid_stream: JAX's ``test_hybrid_stream_primitives`` fails in the
  reference (alpha 0 and 1 give an empty shard, which jax 0.9 refuses), so
  ``streamed_matmul_chain`` and ``alpha_split_matmul`` (alpha 0, 0.25,
  0.5, 1) are held to the plain chained product within 1e-4 (the JAX
  test's bound), and to JAX's wherever JAX's runs;
- grad_compress: ``psum_compressed`` over 8 ranks bit for bit against
  JAX's (the JAX test's own check fails on indexing its sharded output),
  and within relative error 0.05 of the float32 mean; ``compress`` /
  ``decompress`` and the error-feedback transform bit for bit against
  JAX's jitted ones (C1: ``* float32(1/127)``); one
  ``make_train_step(grad_transform=...)`` step against JAX's jitted one;
- elastic: smollm-360m reduced resharded over 8, 6 and 4 ranks and
  gathered back gives the host tree's bits, and ``forward`` on it the
  same logits.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_distributed_ref as R
from _torch_threads import one_thread  # noqa: F401  (autouse)
from repro.distributed import grad_compress as jgc
from repro.distributed.elastic import plan_remesh as jplan_remesh
from repro.models import model as JM
from repro.training.optimizer import init_adamw as jinit_adamw
from repro.training.train_loop import make_train_step as jmake_train_step
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import grad_compress as tgc
from repro_torch.distributed.mesh import run_spmd
from repro_torch.models import model as TM
from repro_torch.training.optimizer import init_adamw
from repro_torch.training.train_loop import make_train_step

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")
WORLD = 8
MOE_TOL = 1e-5          # of max |y|
DECODE_ATOL = 1e-4      # tests/test_torch_model.py's float32 logits bound
STREAM_TOL = 1e-4       # tests/test_distributed.py:56, 63


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}"}
    r = subprocess.run([sys.executable, os.path.join(TESTS,
                                                     "_jax_distributed_ref.py"),
                        str(out)], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every rank's results (``_torch_spmd_cases.run_all``)."""
    _, mp, mx = R.moe_case()
    _, dp, prompt, toks = R.decode_case()
    ws, xs = R.pipeline_case()
    sx, sws = R.stream_case()
    inp = {"moe_arch": R.MOE_ARCH, "moe_params": _bridge(mp),
           "moe_x": torch.from_numpy(mx), "decode_arch": R.DECODE_ARCH,
           "decode_params": _bridge(dp),
           "decode_prompt": torch.from_numpy(prompt),
           "decode_tokens": torch.from_numpy(toks),
           "decode_max_seq": R.DECODE_MAX_SEQ,
           "pipe_ws": torch.from_numpy(ws), "pipe_xs": torch.from_numpy(xs),
           "stream_x": torch.from_numpy(sx),
           "stream_ws": torch.from_numpy(sws), "alphas": R.ALPHAS,
           "grad": torch.from_numpy(R.grad_case()),
           "elastic_tokens": torch.from_numpy(
               np.random.RandomState(5).randint(0, 256, (2, 8)))}
    path = tmp_path_factory.mktemp("spmd") / "inputs.pt"
    torch.save(inp, path)
    from _torch_spmd_cases import run_all

    return run_spmd(run_all, WORLD, "gloo", "cpu", args=(str(path),),
                    log=lambda msg: None)


def _ranks(port, case):
    return [(r, out[case]) for r, out in enumerate(port) if case in out]


@pytest.mark.parametrize("mesh", ["2x4", "1x2"])
def test_moe_expert_parallel(port, jax_ref, mesh):
    """Every rank returns the whole output, the same bits on every rank,
    within MOE_TOL of JAX's sharded ``moe_ffn``, the local path's bits."""
    cfg = get_arch(R.MOE_ARCH).reduced()
    _, mp, mx = R.moe_case()
    want = jax_ref[f"moe_{mesh}"]
    ranks = _ranks(port, f"moe_{mesh}")
    n_model = int(mesh.split("x")[1])
    assert len(ranks) == int(np.prod([int(s) for s in mesh.split("x")]))
    first = ranks[0][1]["y"]
    scale = np.abs(want).max()
    for r, got in ranks:
        assert got["experts"] == 16 // n_model, r   # its experts only
        assert torch.equal(got["y"], first), r
        err = np.abs(got["y"].numpy() - want).max()
        assert err <= MOE_TOL * scale, (r, err, scale)
        # the local path's bits (float32; bf16 at top-4)
        assert torch.equal(got["y"], got["local"]), r
        assert torch.equal(got["y_bf16"], got["local_bf16"]), r
    assert np.abs(first.numpy() - jax_ref["moe_local"]).max() \
        <= MOE_TOL * scale
    # a rank's capacity buffer holds rows past its groups' sum (dump rows)
    # where fewer pairs hit its experts than the capacity: on every rank
    # of (2, 4); on (1, 2) the second rank's experts are all padding
    # (8 routed experts padded to 16), so its groups' sum is 0
    from repro_torch.models import moe as TMOE

    p = _bridge(mp)
    x = torch.from_numpy(mx)
    n_data = int(mesh.split("x")[0])
    for d in range(n_data):
        xt = x[d * 4 // n_data:(d + 1) * 4 // n_data].reshape(-1,
                                                              cfg.d_model)
        topi, _ = TMOE._route(p, xt, cfg, 16)
        n, k = xt.shape[0], cfg.top_k
        cap = min(max(int(-(-n * k * TMOE.CAPACITY_FACTOR // n_model)), 64),
                  n * k)
        e_loc = 16 // n_model
        hits = [int(((topi >= m * e_loc) & (topi < (m + 1) * e_loc)).sum())
                for m in range(n_model)]
        short = [h < cap for h in hits]
        assert all(short) if n_model == 4 else short == [False, True], \
            (d, hits, cap)


def test_splitk_decode(port, jax_ref):
    cfg = get_arch(R.DECODE_ARCH).reduced()
    _, dp, prompt, toks = R.decode_case()
    assert cfg.n_kv_heads % R.DECODE_MESH[1] != 0   # takes the branch
    params = _bridge(dp)
    cache = TM.init_cache(cfg, R.DECODE_BATCH, R.DECODE_MAX_SEQ,
                          dtype=torch.float32, device="cpu")
    _, cache = TM.prefill(params, cfg, torch.from_numpy(prompt), cache)
    prefill_k, prefill_v = cache["k"].clone(), cache["v"].clone()
    plain = []
    for t in toks:
        lg, cache = TM.decode_step(params, cfg, torch.from_numpy(t), cache)
        plain.append(lg)
    plain = torch.stack(plain)
    ranks = _ranks(port, "splitk")
    assert len(ranks) == 4
    s_loc = R.DECODE_MAX_SEQ // 4
    for r, got in ranks:
        assert got["spec"] == (None, "data", "model", None, None)
        assert got["len"] == R.DECODE_PROMPT + len(toks)
        assert torch.equal(got["logits"], ranks[0][1]["logits"]), r
        for i in range(len(toks)):
            want = jax_ref[f"decode_step{i}"]
            assert np.abs(got["logits"][i].numpy() - want).max() \
                <= DECODE_ATOL, (r, i)
        assert (got["logits"] - plain).abs().max() <= DECODE_ATOL, r
        rows = slice(r * s_loc, (r + 1) * s_loc)
        for key, pre in (("k", prefill_k), ("v", prefill_v)):
            shard, whole = got[key], cache[key][:, :, rows]
            assert shard.shape == whole.shape
            # every prefill row and layer 0's decode rows: the same inputs
            n_pre = max(0, min(s_loc, R.DECODE_PROMPT - r * s_loc))
            assert torch.equal(shard[:, :, :n_pre], pre[:, :, rows][:, :,
                                                                  :n_pre])
            assert torch.equal(shard[0], whole[0]), (r, key)
            assert (shard - whole).abs().max() <= DECODE_ATOL, (r, key)
            jwant = jax_ref[f"decode_{key}"][:, :, rows]
            assert np.abs(shard.numpy() - jwant).max() <= DECODE_ATOL


def test_pipeline(port, jax_ref):
    ws, xs = (torch.from_numpy(a) for a in R.pipeline_case())
    seq = []
    for x in xs:                      # the same microbatches, one by one
        for w in ws:
            x = torch.tanh(x @ w)
        seq.append(x)
    seq = torch.stack(seq)
    ranks = _ranks(port, "pipeline")
    assert len(ranks) == 4
    for r, got in ranks:
        assert torch.equal(got, seq), r
        assert np.abs(got.numpy() - jax_ref["pipeline"]).max() <= 1e-5, r


def test_hybrid_stream(port, jax_ref):
    x, ws = (torch.from_numpy(a) for a in R.stream_case())
    ref = x
    for w in ws:
        ref = ref @ w
    ranks = _ranks(port, "stream")
    assert len(ranks) == WORLD
    for r, got in ranks:
        assert (got["chain"] - ref).abs().max() < STREAM_TOL, r
        assert np.abs(got["chain"].numpy()
                      - jax_ref["stream_chain"]).max() < STREAM_TOL, r
        # the prefetch: three gathers of the shards, no other traffic
        shard = ws[0].numel() * 4 // WORLD
        assert got["chain_moved"] == {"all_gather": 3 * shard * (WORLD - 1)}
        for a in R.ALPHAS:
            y = got[f"alpha{a}"]
            assert (y - x @ ws[0]).abs().max() < STREAM_TOL, (r, a)
            if f"stream_alpha{a}" in jax_ref:
                assert np.abs(y.numpy() - jax_ref[f"stream_alpha{a}"]).max() \
                    < STREAM_TOL, (r, a)
    assert {"stream_alpha0.25", "stream_alpha0.5"} <= set(jax_ref)


def test_psum_compressed(port, jax_ref):
    g = R.grad_case()
    ranks = _ranks(port, "psum_compressed")
    assert len(ranks) == WORLD
    mean = g.mean(0)
    for r, got in ranks:
        assert np.array_equal(got.numpy(), jax_ref["psum_compressed"][r]), r
        rel = np.linalg.norm(got.numpy() - mean) / np.linalg.norm(mean)
        assert rel < 0.05, (r, rel)


@pytest.mark.parametrize("n", [8, 6, 4])
def test_elastic_reshard(port, n):
    dims, names = jplan_remesh(n, prefer_model=4)
    shape = dict(zip(names, dims))
    ranks = _ranks(port, f"elastic_{n}")
    assert len(ranks) == n
    for r, got in ranks:
        assert got["shape"] == shape
        assert got["same_bits"] and got["forward_equal"], r
        assert got["local_elems"] < got["total_elems"], r


@pytest.mark.parametrize("shape", [(257,), (16, 33), (5,)])
def test_compress_is_bit_exact(shape):
    """compress / decompress as the jitted train step traces them (C1);
    the all-zero gradient takes the 1e-12 floor."""
    rng = np.random.RandomState(sum(shape))
    jcompress, jdecompress = jax.jit(jgc.compress), jax.jit(jgc.decompress)
    for g in (rng.randn(*shape).astype(np.float32) * 1e-3,
              np.zeros(shape, np.float32)):
        jq, js = jcompress(jnp.asarray(g))
        tq, ts = tgc.compress(torch.from_numpy(g))
        assert np.array_equal(np.asarray(jq), tq.numpy())
        assert np.asarray(js).tobytes() == ts.numpy().tobytes()
        jd = jdecompress(jq, js)
        assert np.array_equal(np.asarray(jd), tgc.decompress(tq, ts).numpy())


def test_error_feedback_transform_is_bit_exact():
    """The compressed gradients bit for bit against JAX's jitted transform
    (and its eager one); the new error ``g - q * scale`` bit for bit
    against the eager transform, the source's arithmetic: XLA's CPU
    ``jit`` contracts it into one fused multiply-add (ROADMAP C13, as C10
    and C12), within a rounding of |g| of the jitted one."""
    rng = np.random.RandomState(7)
    tree = {"a": rng.randn(3, 5).astype(np.float32),
            "b": [rng.randn(7).astype(np.float32) * 10,
                  rng.randn(2, 2).astype(np.float32)]}
    err = jax.tree.map(lambda a: (a * 0.01).astype(np.float32), tree)
    jinit, jtr = jgc.make_error_feedback_transform()
    tinit, ttr = tgc.make_error_feedback_transform()
    jout, jerr = jax.jit(jtr)(tree, err)
    eout, eerr = jtr(tree, err)
    tt = jax.tree.map(torch.from_numpy, tree)
    tout, terr = ttr(tt, jax.tree.map(torch.from_numpy, err))
    np_leaves = lambda t: [np.asarray(a) for a in jax.tree.leaves(t)]
    tout, terr = (jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), x))
                  for x in (tout, terr))
    for a, b, c in zip(np_leaves(jout), np_leaves(eout), tout):
        assert np.array_equal(a, c) and np.array_equal(b, c)
    for a, b, c, g in zip(np_leaves(jerr), np_leaves(eerr), terr,
                          np_leaves(tree)):
        assert np.array_equal(b, c)
        assert np.abs(a - c).max() <= 2.0 ** -23 * np.abs(g).max()
    zero = tinit(tt)
    assert all(float(z.abs().max()) == 0 and z.dtype == torch.float32
               for z in jax.tree.leaves(zero))


def test_error_feedback_transform_stacked_layers():
    """On a model's gradient tree the port's transform takes one scale for
    each leaf of JAX's layout: the tensors of a layer list share the
    scale of the leaf JAX stacks them into.  smollm-360m reduced's tree,
    random gradients and error buffers: the compressed gradients equal
    JAX's jitted transform over the stacked tree bit for bit, the new
    error buffers within a rounding of |g| (C13, as above)."""
    cfg = get_arch("smollm-360m").reduced()
    jparams = JM.init_params(R.ASSIGNED_ARCHS["smollm-360m"].reduced(),
                             jax.random.PRNGKey(4), dtype=jnp.float32,
                             max_seq=32)
    rng = np.random.RandomState(9)
    # a per-layer spread of magnitudes, so a per-layer scale would differ
    grads = jax.tree.map(
        lambda p: (rng.randn(*p.shape) * rng.choice([0.01, 1.0, 30.0])
                   ).astype(np.float32), jparams)
    err = jax.tree.map(
        lambda p: (rng.randn(*p.shape) * 0.01).astype(np.float32), jparams)
    _, jtr = jgc.make_error_feedback_transform()
    jout, jerr = jax.jit(jtr)(grads, err)
    _, ttr = tgc.make_error_feedback_transform()
    tout, terr = ttr(params_from_numpy(grads), params_from_numpy(err))
    assert isinstance(params_from_numpy(grads)["layers"], list)
    assert cfg.n_layers > 1
    want = jax.tree.leaves(jax.tree.map(np.asarray, jout))
    want_e = jax.tree.leaves(jax.tree.map(np.asarray, jerr))
    got = jax.tree.leaves(params_to_numpy(tout))
    got_e = jax.tree.leaves(params_to_numpy(terr))
    g_l = jax.tree.leaves(grads)
    assert len(got) == len(want) == len(g_l)
    for a, b, ea, eb, g in zip(got, want, got_e, want_e, g_l):
        assert np.array_equal(a, b)
        assert np.abs(ea - eb).max() <= 2.0 ** -23 * np.abs(g).max() * 2


def test_train_step_with_grad_transform():
    """One step of smollm-360m reduced with the error-feedback transform
    against JAX's jitted step.  The loss within 1e-5.  After one AdamW
    step the first moment is (1 - b1) x the compressed gradient, so
    127 mu / max |mu| gives each leaf's int8 codes: the port's and JAX's
    lie on the int8 grid (within 1e-3 of a code: the transform ran, with
    one scale a leaf of JAX's layout), agree but for at most 1e-4 of them
    and by at most one code (the float32 gradients differ in their last
    bits, so a value near a code's edge rounds either way), and mu is
    within one code ((1 - b1) x the leaf's scale) of JAX's.  Where the
    codes agree each param is within 1e-3 x lr of JAX's (a rounding of
    the update); where they differ, within lr (one step's update)."""
    cfg = get_arch("smollm-360m").reduced()
    jparams = JM.init_params(R.ASSIGNED_ARCHS["smollm-360m"].reduced(),
                             jax.random.PRNGKey(2), dtype=jnp.float32,
                             max_seq=32)
    toks = np.random.RandomState(6).randint(0, cfg.vocab_size, (4, 16))
    jinit, jtr = jgc.make_error_feedback_transform()
    jerr = jinit(jparams)
    lr = 3e-4
    jstep = jax.jit(jmake_train_step(
        R.ASSIGNED_ARCHS["smollm-360m"].reduced(), lr=lr, remat=False,
        grad_transform=lambda g: jtr(g, jerr)[0]))
    jp, jopt, jloss = jstep(jparams, jinit_adamw(jparams),
                            jnp.asarray(toks, jnp.int32), None)
    params = _bridge(jparams)
    tinit, ttr = tgc.make_error_feedback_transform()
    terr = tinit(params)
    tstep = make_train_step(cfg, lr=lr, remat=False,
                            grad_transform=lambda g: ttr(g, terr)[0])
    tp, topt, tloss = tstep(params, init_adamw(params),
                            torch.from_numpy(toks).to(torch.int32))
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))

    def stacked(tree):   # the leaves in JAX's layout
        return jax.tree.leaves(params_to_numpy(tree))

    def jax_side(tree):
        return stacked(params_from_numpy(jax.tree.map(np.asarray, tree)))

    t_mu, j_mu = stacked(topt.mu), jax_side(jopt.mu)
    t_p, j_p = stacked(tp), jax_side(jp)
    assert len(t_mu) == len(j_mu) == len(t_p) == len(j_p)
    flips = total = 0
    for mt, mj, pt, pj in zip(t_mu, j_mu, t_p, j_p):
        top = np.abs(mj).max()
        assert top > 0 and np.abs(mt).max() > 0
        codes = []
        for m in (mt, mj):
            c = 127 * m.astype(np.float64) / np.abs(m).max()
            assert np.abs(c - np.rint(c)).max() <= 1e-3
            codes.append(np.rint(c))
        d = np.abs(codes[0] - codes[1])
        assert d.max() <= 1
        flips += int((d > 0).sum())
        total += d.size
        assert np.abs(mt - mj).max() <= top / 127 * 1.001
        same = d == 0
        assert np.abs(pt - pj)[same].max() <= 1e-3 * lr
        if (~same).any():
            assert np.abs(pt - pj)[~same].max() <= lr * 1.001 + 1e-7
    assert flips <= 1e-4 * total


def test_lowering_ctx_remat_and_constrain():
    """``lowering_ctx(remat=True)`` recomputes each layer in the backward
    and gives the same loss and gradients bit for bit; a ``constrain`` hook
    sees JAX's sites (the residual after the embedding and each layer,
    attention's q / k / v / out, the logits, the embedding's gradient);
    ``unroll_scans`` changes nothing; the context is restored after."""
    from repro_torch.distributed import ctx
    from repro_torch.distributed.checkpoint import tree_leaves
    from repro_torch.training.train_loop import value_and_grad

    cfg = get_arch("smollm-360m").reduced()
    params = TM.init_params(cfg, seed=3, max_seq=32, device="cpu",
                            dtype=torch.float32)
    toks = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    loss, grads = value_and_grad(params, cfg, toks)
    seen = []

    def hook(x, kind):
        seen.append(kind)
        return x

    with ctx.lowering_ctx(constrain=hook, remat=True, unroll_scans=True):
        loss_r, grads_r = value_and_grad(params, cfg, toks)
    assert ctx.mesh() is None and ctx.constrain("x") == "x"
    assert torch.equal(loss, loss_r)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads_r)):
        assert torch.equal(a, b)
    # the forward: the embedding's output and each layer's (resid), 4
    # attention sites a layer (heads, again when the backward recomputes
    # the layer), the logits; the backward: the embedding's cotangent
    # (resid) and gradient (embed)
    n = cfg.n_layers
    assert seen.count("resid") == 1 + n + 1
    assert seen.count("heads") == 4 * n * 2
    assert seen.count("logits") == 1 and seen.count("embed") == 1
