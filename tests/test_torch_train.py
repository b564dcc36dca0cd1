"""The port's training loss and gradients against the JAX package's, per
family, on the same weights.

For each of ``conftest.py``'s five families (dense, moe, vlm, mla_moe,
hybrid), reduced, JAX initialises float32 params, ``repro_torch.bridge``
carries them over bit for bit, and both packages take the loss of the same
numpy-seeded tokens (the vlm family also the same vision embeddings):
JAX through ``jax.value_and_grad(loss_fn)``, the port through torch
autograd of its ``loss_fn`` on the CPU (the plain versions of the kernels;
the embedding's gradient is JAX's scatter-add in float32).  One JAX run a
family is shared by the module's tests.

Tolerances (float32 throughout, sums in other orders): the loss within
1e-5 of its value, relative (measured ~1e-7); every gradient leaf within
1e-4 of that leaf's max |g| (measured ~1e-6), after
``bridge.params_to_numpy`` stacks the port's layer lists back in JAX's
layout.  Three ``make_train_step`` steps (2 microbatches, remat) on the
pipeline's batches stay within 1e-4 of JAX's losses, relative: Adam's
first steps move each parameter by about ``lr * sign(g)``, so a gradient
element near 0 whose sign differs between the two packages moves a
parameter by ``2 lr``, and the later losses drift by far less than that
bound but more than a float32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401  (autouse)
from conftest import FAMILY_ARCHS
from repro.configs.registry import ASSIGNED_ARCHS
from repro.models import model as JM
from repro.training import train_loop as jtl
from repro.training.data import DataState as JDataState
from repro.training.data import make_batch as jmake_batch
from repro.training.optimizer import init_adamw as jinit_adamw
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs.registry import get_arch
from repro_torch.training import train_loop as ttl
from repro_torch.training.data import DataState, make_batch
from repro_torch.training.optimizer import init_adamw

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
STEP_RTOL = 1e-4
BATCH, SEQ = 2, 16


def _tokens_extras(cfg, seed=0, batch=BATCH):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (batch, SEQ)).astype(np.int32)
    extras = None
    if cfg.family == "vlm":
        extras = {"vision_embeds": rng.randn(
            batch, cfg.n_vision_tokens, cfg.d_model).astype(np.float32)}
    return toks, extras


def _torch_extras(extras):
    return None if extras is None else {
        k: torch.from_numpy(v) for k, v in extras.items()}


def _jax_extras(extras):
    return None if extras is None else {
        k: jnp.asarray(v) for k, v in extras.items()}


@pytest.fixture(scope="module", params=sorted(FAMILY_ARCHS),
                ids=lambda f: f"fam_{f}")
def run(request):
    """(cfg, port cfg, JAX params, port params, tokens, extras, JAX loss,
    JAX grads) of one family."""
    arch = FAMILY_ARCHS[request.param]
    jcfg = ASSIGNED_ARCHS[arch].reduced()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32,
                             max_seq=64)
    toks, extras = _tokens_extras(jcfg)
    loss, grads = jax.jit(jax.value_and_grad(jtl.loss_fn),
                          static_argnums=1)(jparams, jcfg, jnp.asarray(toks),
                                            _jax_extras(extras))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return (jcfg, get_arch(arch).reduced(), jparams, tparams, toks, extras,
            float(loss), jax.tree.map(np.asarray, grads))


def test_loss_matches_jax(run):
    _, tcfg, _, tparams, toks, extras, jloss, _ = run
    loss = ttl.loss_fn(tparams, tcfg, torch.from_numpy(toks),
                       _torch_extras(extras))
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss), (
        float(loss), jloss)


def test_every_gradient_leaf_matches_jax(run):
    _, tcfg, _, tparams, toks, extras, jloss, jgrads = run
    loss, grads = ttl.value_and_grad(tparams, tcfg, torch.from_numpy(toks),
                                     _torch_extras(extras))
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)
    got, tdef = jax.tree.flatten(params_to_numpy(grads))
    want, jdef = jax.tree.flatten(jgrads)
    assert str(tdef) == str(jdef)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    for path, g, w in zip(paths, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= GRAD_REL * scale + 1e-30, (path, err, scale)


def test_three_train_steps_track_jax(run):
    jcfg, tcfg, jparams, tparams, _, extras, _, _ = run
    jstep = jax.jit(jtl.make_train_step(jcfg, microbatches=2, lr=1e-3,
                                        remat=True))
    tstep = ttl.make_train_step(tcfg, microbatches=2, lr=1e-3, remat=True)
    jopt, topt = jinit_adamw(jparams), init_adamw(tparams)
    jds, tds = JDataState(0, 0), DataState(0, 0)
    for _ in range(3):
        jt, jds = jmake_batch(jds, BATCH * 2, SEQ, jcfg.vocab_size)
        tt, tds = make_batch(tds, BATCH * 2, SEQ, tcfg.vocab_size,
                             device="cpu")
        _, ex = _tokens_extras(jcfg, batch=BATCH * 2)
        jparams, jopt, jl = jstep(jparams, jopt, jt, _jax_extras(ex))
        tparams, topt, tl = tstep(tparams, topt, tt, _torch_extras(ex))
        assert abs(float(tl) - float(jl)) <= STEP_RTOL * abs(float(jl)), (
            float(tl), float(jl))
