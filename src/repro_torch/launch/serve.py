"""Serving driver of the port over the ServingClient surface.

Counterpart of ``repro.launch.serve``: builds the model (random weights
from a seeded ``torch.Generator`` on the device), quantizing it to W8A8 by
default layer by layer as it is drawn (``--quant w4a16``: W4A16 where the
JAX launcher makes it, which on the dense family is the ``lm_head``, the
layers staying W8A8), puts
``--replicas`` engine replicas behind a router and serves ``--requests``
random prompts, greedy, or sampled under ``--temperature`` / ``--top-k`` /
``--top-p`` (each request's seed is ``--seed`` + its id).  ``--overlap``
runs the overlapped decode loop (one fused decode + sample step a round,
its tokens read back one step late).  ``--chunk-prefill N`` prefills a
prompt longer than N tokens in chunks of N, one a step between decode
steps (dense and moe families; hybrid, mla_moe and vlm engines prefill
in one shot);
``--kv-dtype int8`` keeps the KV pages in int8 with a float32 scale per
row and head.  ``--kv-tier flash`` spills KV pages of suspended slots to
a cold tier (pinned host memory on a card; ``--flash-pages`` bounds it,
``--num-pages`` sizes the hot pool below the demand) and prefetches them
back before their slot decodes; ``--prefix-cache`` shares prefill-written
pages among requests with a common prompt prefix; replicas migrate slots
off a page-starved replica unless ``--no-migrate``.  ``--workers N``
serves through a fleet router instead (``serving/fleet/router.py``): N
workers behind the fleet wire protocol, ``--spares`` hot spares,
checkpoints and failover; ``--transport loopback`` keeps them in this
process, ``--transport socket`` spawns one subprocess worker each, which
rebuilds the weights from ``(--arch, --seed)``; the fleet's counters are
printed on shutdown.  ``--mode wave`` serves in wave mode (the
shared-cursor cache: a wave of up to ``--max-batch`` prompts, left-padded
to its longest, prefilled together and decoded in lockstep until every
row finishes); ``--mode auto`` (the default) picks it for the families the
engine cannot page (mamba2-130m, whisper-small) and continuous mode for the
others; socket workers always take ``auto``, as the JAX worker CLI does.
``--device`` defaults to ``cuda``, where each decode step is one replayed
CUDA graph; ``--device cpu`` runs the plain PyTorch versions of the
kernels.

  python src/repro_torch/launch/serve.py --arch smollm-360m --requests 8 \\
      --max-new 16 --replicas 2 --route least_loaded
  python src/repro_torch/launch/serve.py --arch zamba2-7b --reduced 0
  python src/repro_torch/launch/serve.py --overlap --temperature 0.8 \\
      --top-k 20 --top-p 0.9 --device cpu
  python src/repro_torch/launch/serve.py --chunk-prefill 4 --kv-dtype int8 \\
      --device cpu
  python src/repro_torch/launch/serve.py --kv-tier flash --num-pages 6 \\
      --prefix-cache --replicas 2 --route session_affinity --device cpu
  python src/repro_torch/launch/serve.py --workers 2 --spares 1 \\
      --transport socket --device cpu
  python src/repro_torch/launch/serve.py --arch whisper-small --device cpu
  python src/repro_torch/launch/serve.py --arch mamba2-130m --reduced 0 \\
      --max-seq 1024 --overlap
  python src/repro_torch/launch/serve.py --arch llama2-7b --mode wave \\
      --device cpu
  python src/repro_torch/launch/serve.py --arch qwen2-moe-a2.7b \\
      --chunk-prefill 4 --device cpu
  python src/repro_torch/launch/serve.py --arch deepseek-v2-lite-16b \\
      --kv-dtype int8 --device cpu
  python src/repro_torch/launch/serve.py --arch qwen2-vl-72b --device cpu
  python src/repro_torch/launch/serve.py --arch qwen2-vl-72b --reduced 0 \\
      --max-seq 1024

``--arch`` takes every configuration of ``configs/registry.py``: the dense
family, the moe qwen2-moe-a2.7b (60 routed experts, top-4, through the
grouped GEMM kernel, and 4 shared experts), the mla_moe
deepseek-v2-lite-16b (multi-head latent attention over compressed KV
pages through the MLA decode kernel, a dense first layer, 64 routed
experts top-6 and 2 shared; it prefills in one shot, as in JAX), the vlm
qwen2-vl-72b (M-RoPE over 256 prepended vision embeddings, zeros from the
stub frontend; one-shot prefill) and the hybrid zamba2-7b
(Mamba-2 layers and a shared attention block) in either mode, the ssm
mamba2-130m and the audio whisper-small (an encoder over stub frame
embeddings, zeros, and a decoder with cross-attention) in wave mode.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

if __package__ in (None, ""):  # run as a script: put src/ on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.serving.client import ServingClient  # noqa: E402
from repro_torch.serving.fleet.worker import build_params  # noqa: E402
from repro_torch.serving.router import ROUTE_POLICIES  # noqa: E402
from repro_torch.serving.scheduler import (POLICIES, SamplingParams,  # noqa: E402
                                           make_scheduler)


def build_client(arch: str | ModelConfig, reduced: bool = True,
                 quant: str = "w8a8", max_batch: int = 4,
                 max_seq: int = 128, page_size: int = 16,
                 replicas: int = 1, route: str = "round_robin",
                 policy: str = "fcfs", seed: int = 0, eos_id: int = -1,
                 overlap: bool = False, chunk_prefill: int = 0,
                 kv_dtype: str = "bf16", kv_tier: str = "none",
                 flash_pages: int | None = None,
                 num_pages: int | None = None, prefix_cache: bool = False,
                 migrate: bool = True, workers: int = 0, spares: int = 0,
                 transport: str = "loopback", mode: str = "auto",
                 device: str = "cuda"
                 ) -> tuple[ModelConfig, ServingClient]:
    """The model and serving stack the driver serves: ``init_params`` on
    the device from ``seed``, each layer W8A8 or W4A16 as soon as it is
    drawn (one layer's bf16 alive at a time), then a ServingClient over
    ``replicas`` engines (``overlap``: the overlapped decode loop;
    ``chunk_prefill``: the
    chunk budget, 0 for none; ``kv_dtype``: "bf16" or "int8" page pools;
    ``kv_tier`` / ``flash_pages`` / ``num_pages``: the flash KV tier and
    the hot pool's size; ``prefix_cache``; ``migrate``: slot migration
    between replicas or workers; ``workers`` / ``spares`` / ``transport``:
    a fleet router over loopback or subprocess workers; ``mode``: the
    engine's "auto", "wave" or "continuous", which socket workers take as
    "auto").  The weights come from ``fleet.worker.build_params``, the
    calls a socket worker makes; ``arch`` is a registered name or, served
    in this process, a ``ModelConfig``."""
    if workers and transport == "socket":
        if not isinstance(arch, str):
            raise ValueError("socket workers rebuild the model from its "
                             "registered name")
        # subprocess workers rebuild the weights themselves from (arch,
        # seed) and quantize locally, so nothing heavy ships over the wire;
        # the prefix cache and the flash tier's bounds are per-worker
        # features the worker CLI does not expose, as in the JAX driver
        from repro_torch.serving.fleet.router import FleetRouter
        cfg = get_arch(arch)
        if reduced:
            cfg = cfg.reduced()
        router = FleetRouter.build_socket(
            arch, workers=workers, spares=spares, policy=route,
            migrate=migrate, sched_policy=policy, reduced=reduced,
            max_batch=max_batch, max_seq=max_seq, page_size=page_size,
            eos_id=eos_id, overlap=overlap, chunk_prefill=chunk_prefill,
            kv_dtype=kv_dtype, kv_tier=kv_tier,
            num_pages=0 if num_pages is None else num_pages,
            quant=quant, seed=seed, device=device)
        return cfg, ServingClient(router=router, seed_base=seed)
    cfg, params = build_params(arch, reduced=reduced, max_seq=max_seq,
                               seed=seed, quant=quant, device=device)
    client = ServingClient(
        cfg, params, replicas=replicas, route=route, seed_base=seed,
        migrate=migrate, workers=workers, spares=spares,
        transport=transport, max_batch=max_batch, max_seq=max_seq,
        eos_id=eos_id, page_size=page_size,
        scheduler=make_scheduler(policy, chunk_tokens=chunk_prefill or None),
        overlap=overlap, kv_dtype=kv_dtype, kv_tier=kv_tier,
        flash_pages=flash_pages, num_pages=num_pages,
        prefix_cache=prefix_cache, mode=mode, device=device)
    return cfg, client


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", type=int, default=1)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="slots PER replica")
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--route", default="round_robin",
                    choices=ROUTE_POLICIES)
    ap.add_argument("--no-migrate", action="store_true",
                    help="disable cross-replica slot migration")
    ap.add_argument("--workers", type=int, default=0,
                    help="fleet mode: N workers behind the fleet wire "
                         "protocol with heartbeat health tracking and "
                         "snapshot-based failover (0 = in-process "
                         "replicas)")
    ap.add_argument("--transport", default="loopback",
                    choices=["loopback", "socket"],
                    help="fleet transport: loopback = in-process workers "
                         "behind the byte-faithful wire codec; socket = "
                         "subprocess workers over TCP")
    ap.add_argument("--spares", type=int, default=0,
                    help="hot spare workers promoted on failover")
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "wave", "continuous"])
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="refcounted prefix caching: repeated prompts map "
                         "shared KV pages instead of re-prefilling them")
    ap.add_argument("--kv-tier", default="none", choices=["none", "flash"],
                    help="flash: spill suspended slots' KV pages to a cold "
                         "tier and prefetch them back")
    ap.add_argument("--flash-pages", type=int, default=0,
                    help="cold-tier capacity in pages (0 = unbounded)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="hot page pool per replica (0 = every slot at "
                         "max_seq)")
    ap.add_argument("--policy", default="fcfs", choices=sorted(POLICIES))
    ap.add_argument("--deadline", type=float, default=0.0)
    ap.add_argument("--chunk-prefill", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="weight seed and sampling seed base")
    ap.add_argument("--stream", action="store_true",
                    help="print each RequestOutput token event")
    ap.add_argument("--quant", default="w8a8",
                    choices=["none", "w8a8", "w4a16", "int8"])
    ap.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.quant == "int8":
        args.quant = "w8a8"

    cfg, client = build_client(
        args.arch, reduced=bool(args.reduced), quant=args.quant,
        max_batch=args.max_batch, max_seq=args.max_seq,
        page_size=args.page_size, replicas=args.replicas, route=args.route,
        policy=args.policy, seed=args.seed, overlap=args.overlap,
        chunk_prefill=args.chunk_prefill, kv_dtype=args.kv_dtype,
        kv_tier=args.kv_tier, flash_pages=args.flash_pages or None,
        num_pages=args.num_pages or None, prefix_cache=args.prefix_cache,
        migrate=not args.no_migrate, workers=args.workers,
        spares=args.spares, transport=args.transport, mode=args.mode,
        device=args.device)
    rng = np.random.RandomState(42)
    for i in range(args.requests):
        plen = int(rng.randint(2, 9))
        prompt = [int(t) for t in rng.randint(0, cfg.vocab_size, plen)]
        client.submit(prompt, max_new_tokens=args.max_new, priority=i % 3,
                      deadline_s=args.deadline if args.deadline > 0 else None,
                      session=f"user-{i % 4}",
                      sampling=SamplingParams(temperature=args.temperature,
                                              top_k=args.top_k,
                                              top_p=args.top_p))
    t0 = time.monotonic()
    for out in client.stream():
        if out.finished:
            print(f"rid={out.rid} done n_out={out.n_out} "
                  f"reason={out.finish_reason} "
                  f"ttft={out.ttft_s if out.ttft_s is not None else -1:.3f}s "
                  f"preempt={out.sched['preemptions']}")
        elif args.stream:
            print(f"rid={out.rid} tok[{out.n_out - 1}]={out.token}")
    dt = time.monotonic() - t0
    tokens = sum(s.tokens_out for s in client.router.stats)
    steps = sum(s.decode_steps for s in client.router.stats)
    print(f"requests={args.requests} tokens_out={tokens} "
          f"decode_steps={steps} wall={dt:.1f}s tok/s={tokens / dt:.1f} "
          f"device={args.device}")
    print(client.summary())
    fleet = getattr(client.router, "fleet", None)
    if fleet is not None:   # fleet mode: surface the failover counters
        print(f"fleet shutdown: workers_lost={fleet.workers_lost} "
              f"failovers={fleet.failovers} "
              f"requests_replayed={fleet.requests_replayed} "
              f"tokens_replayed={fleet.tokens_replayed} "
              f"heartbeat_misses={fleet.heartbeat_misses}")
        client.router.close()


if __name__ == "__main__":
    main()
