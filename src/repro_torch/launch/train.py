"""End-to-end training driver of the port (one device).

Counterpart of ``repro.launch.train``: float32 weights from the port's
``init_params`` seed 0, the numpy data pipeline (the JAX package's batches,
bit for bit), ``make_train_step`` without remat, AdamW.  ``--device``
defaults to ``cuda``, where attention and its gradient run the float32
kernels (``csrc/flash_attention_f32.cu``) and, for the moe family, the
routed experts' product and its gradient the float32 grouped GEMM
(``csrc/grouped_gemm_f32.cu``); ``--device cpu`` runs the plain versions.

Checkpoints (``--ckpt-dir``, every ``--ckpt-every`` steps) are the JAX
package's: ``(params, AdamWState)`` in JAX's layout (layers stacked,
``bridge.params_to_numpy``) with ``train_step`` and ``data_step`` in the
manifest's extra, so either package resumes a run the other saved.

  python -m repro_torch.launch.train --arch smollm-360m --reduced 0 \\
      --steps 300 --batch 8 --seq 256
  python -m repro_torch.launch.train --arch smollm-360m --reduced 1 \\
      --steps 8 --device cpu
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
import torch  # noqa: E402

from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.distributed.checkpoint import (  # noqa: E402
    latest_step, restore_checkpoint, save_checkpoint, tree_leaves)
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.training.data import DataState, make_batch  # noqa: E402
from repro_torch.training.optimizer import AdamWState, init_adamw  # noqa: E402
from repro_torch.training.train_loop import make_train_step  # noqa: E402


def _jax_layout(params, opt: AdamWState) -> tuple:
    return (params_to_numpy(params),
            AdamWState(step=opt.step.cpu().numpy(),
                       mu=params_to_numpy(opt.mu),
                       nu=params_to_numpy(opt.nu)))


def save_train_state(ckpt_dir: str, step: int, params, opt: AdamWState,
                     extra: dict) -> str:
    """``(params, opt)`` as the JAX trainer saves them."""
    return save_checkpoint(ckpt_dir, step, _jax_layout(params, opt),
                           extra=extra)


def restore_train_state(ckpt_dir: str, params, opt: AdamWState,
                        device: str | torch.device
                        ) -> tuple[dict, AdamWState, dict]:
    """The latest ``(params, opt)`` of ``ckpt_dir`` (the port's or the JAX
    trainer's) in the port's layout on ``device``, and the extra."""
    (jp, jopt), extra = restore_checkpoint(ckpt_dir, _jax_layout(params, opt))
    dev = torch.device(device)
    opt = AdamWState(step=torch.from_numpy(np.asarray(jopt.step)).to(dev),
                     mu=params_from_numpy(jopt.mu, dev),
                     nu=params_from_numpy(jopt.nu, dev))
    return params_from_numpy(jp, dev), opt, extra


def train(arch: str = "smollm-360m", reduced: bool = True, steps: int = 300,
          batch: int = 8, seq: int = 256, lr: float = 3e-4,
          microbatches: int = 1, ckpt_dir: str = "", ckpt_every: int = 100,
          log_every: int = 10, device: str | torch.device = "cuda",
          log=print) -> list[float]:
    """The driver's loop; returns the losses of the steps it ran."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    params = model_lib.init_params(cfg, 0, max_seq=seq, device=dev,
                                   dtype=torch.float32)
    opt = init_adamw(params)
    ds = DataState(seed=0, step=0)
    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        params, opt, extra = restore_train_state(ckpt_dir, params, opt, dev)
        ds = DataState(seed=0, step=extra["data_step"])
        start = extra["train_step"]
        log(f"resumed from step {start}")
    step_fn = make_train_step(cfg, microbatches=microbatches, lr=lr,
                              remat=False)
    n_params = sum(p.numel() for p in tree_leaves(params))
    log(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
        f"batch={batch}x{seq} device={dev}")
    losses = []
    t0 = time.time()
    for i in range(start, steps):
        toks, ds = make_batch(ds, batch, seq, cfg.vocab_size, device=dev)
        params, opt, loss = step_fn(params, opt, toks, None)
        losses.append(float(loss))
        if i % log_every == 0 or i == steps - 1:
            tps = batch * seq * (i - start + 1) / (time.time() - t0)
            log(f"step {i:5d} loss {losses[-1]:.4f} tok/s {tps:,.0f}")
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            save_train_state(ckpt_dir, i + 1, params, opt,
                             extra={"train_step": i + 1,
                                    "data_step": ds.step})
    log("done")
    return losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", type=int, default=1)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    train(args.arch, bool(args.reduced), args.steps, args.batch, args.seq,
          args.lr, args.microbatches, args.ckpt_dir, args.ckpt_every,
          args.log_every, args.device,
          log=lambda msg: print(msg, flush=True))


if __name__ == "__main__":
    main()
