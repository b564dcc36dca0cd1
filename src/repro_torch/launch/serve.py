"""Serving driver of the port over the ServingClient surface.

Counterpart of ``repro.launch.serve``: builds the model (random weights
from a seeded ``torch.Generator`` on the device), quantizes it to W8A8 by
default (``--quant w4a16``: W4A16 where the JAX launcher makes it, which on
the dense family is the ``lm_head``, the layers staying W8A8), puts
``--replicas`` engine replicas behind a router and serves ``--requests``
random prompts, greedy.  ``--device`` defaults to ``cuda``;
``--device cpu`` runs the plain PyTorch versions of the kernels.

  python src/repro_torch/launch/serve.py --arch smollm-360m --requests 8 \\
      --max-new 16 --replicas 2 --route least_loaded

Flags of the JAX driver whose features are not ported yet (fleet workers,
overlap, prefix cache, int8 KV, wave mode, chunked prefill, stochastic
sampling) exit with a message naming what is missing.  Replicas never
migrate slots (migration is not ported), so there is no ``--no-migrate``.
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
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.quant.convert import quantize_params  # noqa: E402
from repro_torch.serving.client import ServingClient  # noqa: E402
from repro_torch.serving.router import ROUTE_POLICIES  # noqa: E402
from repro_torch.serving.scheduler import POLICIES, make_scheduler  # noqa: E402


def build_client(arch: str, reduced: bool = True, quant: str = "w8a8",
                 max_batch: int = 4, max_seq: int = 128, page_size: int = 16,
                 replicas: int = 1, route: str = "round_robin",
                 policy: str = "fcfs", seed: int = 0, eos_id: int = -1,
                 device: str = "cuda") -> tuple[ModelConfig, ServingClient]:
    """The model and serving stack the driver serves: ``init_params`` on
    the device from ``seed``, W8A8 or W4A16 quantization matrix by matrix
    (each bf16 matrix freed as it goes), then a ServingClient over ``replicas``
    engines."""
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    params = model_lib.init_params(cfg, seed=seed, max_seq=max_seq,
                                   device=device)
    if quant in ("w8a8", "w4a16"):
        params = quantize_params(params, consume=True, mode=quant)
    elif quant != "none":
        raise ValueError(f"unknown quantization {quant!r}")
    client = ServingClient(
        cfg, params, replicas=replicas, route=route, seed_base=seed,
        max_batch=max_batch, max_seq=max_seq, eos_id=eos_id,
        page_size=page_size, scheduler=make_scheduler(policy),
        device=device)
    return cfg, client


def _unported(args) -> list[str]:
    out = []
    if args.workers:
        out.append("--workers (fleet serving)")
    if args.overlap:
        out.append("--overlap (overlapped decode loop)")
    if args.prefix_cache:
        out.append("--prefix-cache")
    if args.kv_dtype != "bf16":
        out.append("--kv-dtype int8 (int8 KV pools)")
    if args.mode == "wave":
        out.append("--mode wave")
    if args.chunk_prefill:
        out.append("--chunk-prefill (paged-chunk flash attention)")
    if args.temperature > 0.0:
        out.append("--temperature > 0 (threefry sampler)")
    return out


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
    ap.add_argument("--workers", type=int, default=0)
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "wave", "continuous"])
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--policy", default="fcfs", choices=sorted(POLICIES))
    ap.add_argument("--deadline", type=float, default=0.0)
    ap.add_argument("--chunk-prefill", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
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
    missing = _unported(args)
    if missing:
        ap.exit(2, "not ported to the PyTorch stack yet: "
                + ", ".join(missing) + "\n")

    cfg, client = build_client(
        args.arch, reduced=bool(args.reduced), quant=args.quant,
        max_batch=args.max_batch, max_seq=args.max_seq,
        page_size=args.page_size, replicas=args.replicas, route=args.route,
        policy=args.policy, seed=args.seed, device=args.device)
    rng = np.random.RandomState(42)
    for i in range(args.requests):
        plen = int(rng.randint(2, 9))
        prompt = [int(t) for t in rng.randint(0, cfg.vocab_size, plen)]
        client.submit(prompt, max_new_tokens=args.max_new, priority=i % 3,
                      deadline_s=args.deadline if args.deadline > 0 else None,
                      session=f"user-{i % 4}")
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


if __name__ == "__main__":
    main()
