"""The JAX package's sharded functions on a forced 8-device CPU mesh: the
references that tests/test_torch_distributed.py holds the port's SPMD
ranks against.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_jax_distributed_ref.py OUT.npz

runs them once and writes their outputs to OUT.npz (the test runs it in a
subprocess, as tests/test_distributed.py runs the JAX package's own
multi-device tests, so the rest of the suite keeps seeing one device).
The inputs come from numpy with fixed seeds and the params from
``jax.random`` keys, through the builders below, which the test calls too
to bridge the same params into the port.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.registry import ASSIGNED_ARCHS
from repro.models import model as JM
from repro.models import moe as JMOE

MOE_ARCH, DECODE_ARCH = "qwen2-moe-a2.7b", "smollm-360m"
MOE_MESHES = ((2, 4), (1, 2))
DECODE_MESH = (1, 4)
DECODE_BATCH, DECODE_PROMPT, DECODE_MAX_SEQ, DECODE_STEPS = 2, 10, 32, 4
ALPHAS = (0.0, 0.25, 0.5, 1.0)


def moe_case():
    """(cfg, float32 params, x [4, 8, D] float32)."""
    cfg = ASSIGNED_ARCHS[MOE_ARCH].reduced()
    params = JMOE.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
    x = np.random.RandomState(0).randn(4, 8, cfg.d_model).astype(np.float32)
    return cfg, params, x


def decode_case():
    """(cfg, float32 params, prompt tokens [B, P], decode tokens [steps,
    B]) of the split-K case: 2 kv heads over a model axis of 4."""
    cfg = ASSIGNED_ARCHS[DECODE_ARCH].reduced()
    params = JM.init_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32,
                            max_seq=DECODE_MAX_SEQ)
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, cfg.vocab_size,
                         (DECODE_BATCH, DECODE_PROMPT)).astype(np.int32)
    toks = rng.randint(0, cfg.vocab_size,
                       (DECODE_STEPS, DECODE_BATCH)).astype(np.int32)
    return cfg, params, prompt, toks


def pipeline_case():
    """JAX's test case: 4 stages, 6 microbatches of 2, d 16."""
    rng = np.random.RandomState(2)
    ws = (rng.randn(4, 16, 16) * 0.3).astype(np.float32)
    xs = rng.randn(6, 2, 16).astype(np.float32)
    return ws, xs


def stream_case():
    """x [4, 64] and three [64, 64] weights (JAX's test's shapes)."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 64).astype(np.float32)
    ws = (rng.randn(3, 64, 64) * 0.1).astype(np.float32)
    return x, ws


def grad_case():
    """g [8, 128]: row r is rank r's gradient (JAX's test's shape)."""
    return (np.random.RandomState(4).randn(8, 128) * 0.1).astype(np.float32)


def _mesh(shape, names):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, names, devices=jax.devices()[:n])


def main(out_path: str) -> None:
    from jax.sharding import PartitionSpec as P

    from repro.distributed import ctx
    from repro.distributed.grad_compress import psum_compressed
    from repro.distributed.hybrid_stream import (alpha_split_matmul,
                                                 streamed_matmul_chain)
    from repro.distributed.pipeline import pipelined_forward
    from repro.kernels.compat import shard_map

    out = {}
    cfg, p, x = moe_case()
    out["moe_local"] = np.asarray(JMOE.moe_ffn(p, jnp.asarray(x), cfg))

    def sharded_moe(shape):
        """One trace a mesh: the mesh is read while tracing."""
        mesh = _mesh(shape, ("data", "model"))
        with ctx.lowering_ctx(mesh=mesh), mesh:
            return jax.jit(lambda p, x: JMOE.moe_ffn(p, x, cfg))(p, x)

    for shape in MOE_MESHES:
        out[f"moe_{shape[0]}x{shape[1]}"] = np.asarray(sharded_moe(shape))

    cfg, params, prompt, toks = decode_case()
    cache = JM.init_cache(cfg, DECODE_BATCH, DECODE_MAX_SEQ, jnp.float32)
    logits, cache = JM.prefill(params, cfg, jnp.asarray(prompt), cache)
    out["decode_prefill"] = np.asarray(logits)
    mesh = _mesh(DECODE_MESH, ("data", "model"))
    step = jax.jit(lambda p, t, c: JM.decode_step(p, cfg, t, c))
    with ctx.lowering_ctx(mesh=mesh), mesh:
        for i, t in enumerate(toks):
            logits, cache = step(params, jnp.asarray(t), cache)
            out[f"decode_step{i}"] = np.asarray(logits)
    out["decode_k"] = np.asarray(cache["k"])
    out["decode_v"] = np.asarray(cache["v"])

    ws, xs = pipeline_case()
    mesh = _mesh((4,), ("pod",))
    with mesh:
        out["pipeline"] = np.asarray(pipelined_forward(
            lambda w, x: jnp.tanh(x @ w), jnp.asarray(ws), jnp.asarray(xs),
            mesh, "pod"))

    x, ws = stream_case()
    mesh = _mesh((8,), ("data",))
    with mesh:
        out["stream_chain"] = np.asarray(streamed_matmul_chain(
            jnp.asarray(x), [jnp.asarray(w) for w in ws], mesh, "data"))
        for a in ALPHAS:
            # alpha 0 and 1 give an empty shard, which jax 0.9 refuses
            # (the JAX package's own test fails there)
            try:
                y = alpha_split_matmul(jnp.asarray(x), jnp.asarray(ws[0]),
                                       mesh, a)
                out[f"stream_alpha{a}"] = np.asarray(y)
            except AssertionError:
                pass
        g = grad_case()
        got = shard_map(lambda g: psum_compressed(g, "data"), mesh=mesh,
                        in_specs=P("data"), out_specs=P("data"),
                        check_vma=False)(jnp.asarray(g))
        out["psum_compressed"] = np.asarray(got)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
