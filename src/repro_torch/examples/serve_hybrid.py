"""End-to-end serving demo of the port on the attention/SSM-hybrid family.

Twin of the JAX package's ``examples/serve_hybrid.py``, through the
three-layer serving API: a ServingClient hands requests to a Router, which
spreads them over two EngineCore replicas (least-loaded) and migrates
slots between them when one runs out of KV pages.  zamba2's
shared-attention KV is paged like any dense cache, while the per-slot
Mamba state lives in the slot-indexed state pool; both travel inside a
migration snapshot.

Each replica runs the paper's deployment scenario: W8A8 weights,
continuous batching over the paged per-slot KV cache and the straggler
watchdog (decode step 3 is reported slow once and re-dispatched).  With
6 requests and 2 slots a replica, a queued request is admitted as soon as
a slot frees anywhere.  The model is ``zamba2-7b``'s reduced config with
random weights from seed 0.

  python src/repro_torch/examples/serve_hybrid.py               # the card
  python src/repro_torch/examples/serve_hybrid.py --device cpu  # plain
"""

from __future__ import annotations

import argparse
import os
import sys
import time

if __package__ in (None, ""):  # run as a script: put src/ on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.quant.convert import quantize_params  # noqa: E402
from repro_torch.serving.client import ServingClient  # noqa: E402

PROMPTS = [[1, 2, 3], [7, 8], [11, 12, 13, 14], [21], [31, 32], [41, 42, 43]]


def run(device: str = "cuda", seed: int = 0) -> tuple[ServingClient, list]:
    """Serve PROMPTS (request i asks for 12 - i tokens) over two replicas
    of 2 slots; returns the client and the request handles."""
    cfg = get_arch("zamba2-7b").reduced()
    params = quantize_params(model_lib.init_params(
        cfg, seed=seed, max_seq=128, device=device))
    slow_steps = {3}   # decode step 3 "straggles": the engine re-dispatches

    def watchdog(step: int, dt: float) -> bool:
        if step in slow_steps:
            slow_steps.discard(step)
            return True
        return False

    client = ServingClient(cfg, params, replicas=2, route="least_loaded",
                           max_batch=2, max_seq=128, eos_id=-1,
                           watchdog=watchdog, mode="continuous",
                           page_size=16, device=device)
    handles = [client.submit(p, max_new_tokens=12 - i)
               for i, p in enumerate(PROMPTS)]
    client.run()
    return client, handles


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t0 = time.time()
    client, handles = run(args.device, args.seed)
    dt = time.time() - t0
    for h in handles:
        r = h.request
        print(f"req {r.rid}: prompt={r.prompt} -> {r.out_tokens} "
              f"(reason={h.finish_reason})")
    stats = client.router.stats
    tokens = sum(s.tokens_out for s in stats)
    print(f"\n{tokens} tokens in {dt:.1f}s ({tokens / dt:.1f} tok/s, "
          f"{args.device}, the build included), prefills="
          f"{sum(s.prefills for s in stats)}, straggler re-dispatches="
          f"{sum(s.straggler_events for s in stats)}")
    print(client.summary())


if __name__ == "__main__":
    main()
