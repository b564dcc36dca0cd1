"""Train a width-reduced smollm for a few hundred steps with checkpoint /
restart fault tolerance: the port's twin of the JAX package's
``examples/train_smollm.py``.

A smollm of 4 layers at d_model 256 (4 heads over 2, head dim 64, d_ff
768, vocab 2,048) runs the whole substrate: the data pipeline ->
microbatched AdamW (2 microbatches) -> checkpoint -> crash -> resume, and
asserts that the loss falls.  On the card (the default) attention and its
gradient run the float32 kernels; ``--device cpu`` runs the plain versions.

  python src/repro_torch/examples/train_smollm.py [--steps 300]
  python src/repro_torch/examples/train_smollm.py --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import tempfile
import time

if __package__ in (None, ""):  # run as a script: put src/ on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import torch  # noqa: E402

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.distributed.checkpoint import tree_leaves  # noqa: E402
from repro_torch.launch.train import (restore_train_state,  # noqa: E402
                                      save_train_state)
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.training.data import DataState, make_batch  # noqa: E402
from repro_torch.training.optimizer import init_adamw  # noqa: E402
from repro_torch.training.train_loop import make_train_step  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(
        get_arch("smollm-360m"), n_layers=4, d_model=256, n_heads=4,
        n_kv_heads=2, d_head=64, d_ff=768, vocab_size=2048,
        name="smollm-mini")
    params = model_lib.init_params(cfg, 0, max_seq=args.seq, device=dev,
                                   dtype=torch.float32)
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"{cfg.name}: {n / 1e6:.1f}M params, {args.steps} steps of "
          f"{args.batch}x{args.seq} on {dev}")

    opt = init_adamw(params)
    step_fn = make_train_step(cfg, microbatches=2, lr=1e-3, remat=False)
    ds = DataState(seed=0, step=0)
    ckpt = tempfile.mkdtemp(prefix="repro_torch_train_ckpt_")
    try:
        t0 = time.time()
        first = last = None
        for i in range(args.steps):
            toks, ds = make_batch(ds, args.batch, args.seq, cfg.vocab_size,
                                  device=dev)
            params, opt, loss = step_fn(params, opt, toks, None)
            last = float(loss)
            if first is None:
                first = last
            if i % 20 == 0:
                print(f"step {i:4d} loss {last:.4f}", flush=True)
            if i == args.steps // 2:
                save_train_state(ckpt, i, params, opt,
                                 extra={"data_step": ds.step})
                print(f"-- checkpoint at step {i}; simulating crash + "
                      f"restart --")
                params, opt, extra = restore_train_state(ckpt, params, opt,
                                                         dev)
                ds = DataState(seed=0, step=extra["data_step"])
        tps = args.steps * args.batch * args.seq / (time.time() - t0)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'LEARNING' if last < first else 'NOT LEARNING'}), "
          f"{tps:,.0f} tok/s")
    if not last < first:
        raise SystemExit("training failed to reduce loss")


if __name__ == "__main__":
    main()
