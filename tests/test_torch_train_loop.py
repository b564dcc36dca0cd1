"""The port's training substrate against the JAX package's: the data
pipeline, AdamW, microbatches, remat, the training checkpoints both
packages read, and the families the card cannot train.

* ``make_batch``: the same tokens bit for bit (both draw with numpy).
* ``adamw_update`` on the same params, gradients and moments: bit-exact
  against the JAX function run as written (eagerly).  Under ``jit`` XLA's
  CPU backend contracts ``b1 * m + (1 - b1) * g`` and the other
  multiply-adds into fused multiply-adds (ROADMAP C12; C10's finding for
  the biased linear), so the jitted function differs from its source by up
  to hundreds of ulps where the two terms cancel; the port computes what
  the source writes.
* Microbatches 2 against 1: the loss and the updated params within 1e-4,
  the JAX package's own bound (tests/test_substrate.py).  Remat against no
  remat: the same bits (the recomputed forward is the same computation).
  The loss falls over 8 steps.
* Checkpoints: ``(params, AdamWState)`` in JAX's layout; one written by the
  JAX package's ``save_checkpoint`` after two jitted steps resumes in the
  port's trainer, whose next loss matches JAX's next step within 1e-5,
  relative; one written by the port's trainer resumes in JAX the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401  (autouse)
from repro.configs.registry import ASSIGNED_ARCHS
from repro.distributed import checkpoint as jckpt
from repro.models import model as JM
from repro.training import optimizer as jopt_mod
from repro.training.data import DataState as JDataState
from repro.training.data import make_batch as jmake_batch
from repro.training.train_loop import make_train_step as jmake_train_step
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.distributed import checkpoint as tckpt
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as TM
from repro_torch.training import optimizer as topt_mod
from repro_torch.training.data import DataState, make_batch
from repro_torch.training.train_loop import (NO_BACKWARD, check_trainable,
                                             make_train_step, value_and_grad)

ARCH = "smollm-360m"
RESUME_RTOL = 1e-5


@pytest.fixture(scope="module")
def dense():
    cfg = get_arch(ARCH).reduced()
    params = TM.init_params(cfg, 0, max_seq=64, device="cpu",
                            dtype=torch.float32)
    return cfg, params


@pytest.mark.parametrize("seed,step,batch,seq,vocab", [
    (0, 0, 4, 32, 256), (0, 7, 8, 256, 49152), (3, 1, 2, 17, 5),
    (11, 100, 3, 64, 2048)])
def test_make_batch_is_bit_exact(seed, step, batch, seq, vocab):
    want, jnext = jmake_batch(JDataState(seed, step), batch, seq, vocab)
    got, tnext = make_batch(DataState(seed, step), batch, seq, vocab,
                            device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (tnext.seed, tnext.step) == (jnext.seed, jnext.step)


def _adam_inputs(seed: int):
    rng = np.random.default_rng(seed)
    shapes = {"a": (64, 33), "b": [(1000,), (7, 5, 3)]}

    def tree(draw):
        return {"a": draw(shapes["a"]), "b": [draw(s) for s in shapes["b"]]}

    p = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    g = tree(lambda s: (rng.standard_normal(s)
                        * 10.0 ** rng.integers(-6, 2, s)).astype(np.float32))
    m = tree(lambda s: (rng.standard_normal(s) * 1e-2).astype(np.float32))
    n = tree(lambda s: (np.abs(rng.standard_normal(s)) * 1e-4
                        ).astype(np.float32))
    return p, g, m, n


@pytest.mark.parametrize("step,lr", [(0, 3e-4), (1, 1e-3), (99, 3e-4),
                                     (12345, 1e-3)])
def test_adamw_update_is_bit_exact(step, lr):
    p, g, m, n = _adam_inputs(step)
    as_t = lambda tree: jax.tree.map(lambda a: torch.from_numpy(a.copy()),
                                     tree)
    jp, js = jopt_mod.adamw_update(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
        jopt_mod.AdamWState(jnp.asarray(step, jnp.int32),
                            jax.tree.map(jnp.asarray, m),
                            jax.tree.map(jnp.asarray, n)), lr=lr)
    tp, ts = topt_mod.adamw_update(
        as_t(p), as_t(g),
        topt_mod.AdamWState(torch.tensor(step, dtype=torch.int32), as_t(m),
                            as_t(n)), lr=lr)
    assert int(ts.step) == int(js.step) == step + 1
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                     got)),
                        jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))


def _max_diff(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(
        tckpt.tree_leaves(a), tckpt.tree_leaves(b)))


def test_microbatches_match_one_batch(dense):
    cfg, params = dense
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (4, 16)).astype(np.int32))
    p1, _, l1 = make_train_step(cfg, microbatches=1, remat=False)(
        params, topt_mod.init_adamw(params), toks)
    p2, _, l2 = make_train_step(cfg, microbatches=2, remat=False)(
        params, topt_mod.init_adamw(params), toks)
    assert abs(float(l1) - float(l2)) < 1e-4
    assert _max_diff(p1, p2) < 1e-4


def test_remat_gives_the_same_bits(dense):
    cfg, params = dense
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    l0, g0 = value_and_grad(params, cfg, toks, remat=False)
    l1, g1 = value_and_grad(params, cfg, toks, remat=True)
    assert torch.equal(l0, l1)
    for a, b in zip(tckpt.tree_leaves(g0), tckpt.tree_leaves(g1)):
        assert torch.equal(a, b)


def test_loss_falls_over_eight_steps(dense):
    cfg, params = dense
    step = make_train_step(cfg, microbatches=1, lr=1e-3, remat=False)
    opt = topt_mod.init_adamw(params)
    ds, losses = DataState(0, 0), []
    for _ in range(8):
        toks, ds = make_batch(ds, 4, 32, cfg.vocab_size, device="cpu")
        params, opt, loss = step(params, opt, toks)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses


def test_training_state_treedef_is_jax(dense):
    """The port's (params, AdamWState) checkpoint tree flattens to the text
    JAX's does (the NamedTuple as ``CustomNode(namedtuple[AdamWState],
    ...)``)."""
    cfg, params = dense
    jparams = JM.init_params(ASSIGNED_ARCHS[ARCH].reduced(),
                             jax.random.PRNGKey(0), dtype=jnp.float32,
                             max_seq=64)
    jtree = (jparams, jopt_mod.init_adamw(jparams))
    ttree = tlaunch._jax_layout(params, topt_mod.init_adamw(params))
    leaves, treedef = tckpt._flatten(ttree)
    assert treedef == str(jax.tree.flatten(jtree)[1])
    assert [np.shape(x) for x in leaves] == [
        np.shape(x) for x in jax.tree.leaves(jtree)]
    back = tckpt.tree_unflatten(ttree, leaves)
    assert type(back[1]) is topt_mod.AdamWState


def _jax_run(steps: int, batch: int, seq: int, state=None):
    """JAX's trainer loop (launch/train.py) on the reduced smollm: the
    state after ``steps`` steps from ``state`` (or from PRNGKey(0)) and the
    losses."""
    cfg = ASSIGNED_ARCHS[ARCH].reduced()
    if state is None:
        params = JM.init_params(cfg, jax.random.PRNGKey(0),
                                dtype=jnp.float32, max_seq=seq)
        state = (params, jopt_mod.init_adamw(params), 0)
    params, opt, start = state
    step_fn = jax.jit(jmake_train_step(cfg, remat=False))
    ds, losses = JDataState(0, start), []
    for _ in range(start, steps):
        toks, ds = jmake_batch(ds, batch, seq, cfg.vocab_size)
        params, opt, loss = step_fn(params, opt, toks, None)
        losses.append(float(loss))
    return (params, opt, steps), losses


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    batch, seq = 4, 32
    (jp, jo, _), _ = _jax_run(2, batch, seq)
    jckpt.save_checkpoint(str(tmp_path), 2, (jp, jo),
                          extra={"train_step": 2, "data_step": 2})
    want = _jax_run(3, batch, seq, state=(jp, jo, 2))[1]
    got = tlaunch.train(ARCH, True, steps=3, batch=batch, seq=seq,
                        ckpt_dir=str(tmp_path), device="cpu",
                        log=lambda msg: None)
    assert len(got) == 1
    assert abs(got[0] - want[0]) <= RESUME_RTOL * abs(want[0]), (got, want)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    batch, seq = 4, 32
    tlaunch.train(ARCH, True, steps=2, batch=batch, seq=seq,
                  ckpt_dir=str(tmp_path), ckpt_every=2, device="cpu",
                  log=lambda msg: None)
    cfg = ASSIGNED_ARCHS[ARCH].reduced()
    like = JM.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32,
                          max_seq=seq)
    (jp, jo), extra = jckpt.restore_checkpoint(
        str(tmp_path), (like, jopt_mod.init_adamw(like)))
    assert extra == {"train_step": 2, "data_step": 2}
    assert int(jo.step) == 2
    want = _jax_run(3, batch, seq, state=(jp, jo, 2))[1]
    got = tlaunch.train(ARCH, True, steps=3, batch=batch, seq=seq,
                        ckpt_dir=str(tmp_path), device="cpu",
                        log=lambda msg: None)
    assert abs(got[0] - want[0]) <= RESUME_RTOL * abs(want[0]), (got, want)


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2-vl-72b",
                                  "qwen2-moe-a2.7b", "deepseek-v2-lite-16b",
                                  "zamba2-7b", "mamba2-130m",
                                  "whisper-small"])
def test_families_without_a_backward_kernel_refuse_the_card(arch):
    cfg = get_arch(arch)
    check_trainable(cfg, torch.device("cpu"))
    if cfg.family not in NO_BACKWARD:
        check_trainable(cfg, torch.device("cuda"))
        return
    with pytest.raises(NotImplementedError, match="no|none"):
        check_trainable(cfg, torch.device("cuda"))
