"""Quickstart of the port: the paper's technique end to end on one matrix.

Twin of steps 1-3 of the JAX package's ``examples/quickstart.py``:

1. plan the GeMV with the section V hardware-aware tiling (optimal tile and
   alpha split) on Cambricon-LLM-S;
2. quantize to INT8 and protect the flash-resident region with the section
   VI outlier ECC;
3. inject NAND-grade bit flips and run the hybrid NPU+flash GeMV (the B5
   ECC-decode and B2 int8 kernels on the card), with and without the ECC.

The matrix is ``d_model x d_model`` of ``--arch`` (4096 x 4096 for
llama2-7b, the JAX example's shape).  Step 4 of the JAX example, the
end-to-end decode-speed estimate, needs the event simulator (``sim/*``)
and ``core/{planner,schedule}``, which are not ported yet.

  python src/repro_torch/examples/quickstart.py               # on the card
  python src/repro_torch/examples/quickstart.py --device cpu  # plain versions
"""

from __future__ import annotations

import argparse
import os
import sys

if __package__ in (None, ""):  # run as a script: put src/ on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import torch  # noqa: E402

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import tiling  # noqa: E402
from repro_torch.core.hw import CAMBRICON_LLM_S  # noqa: E402
from repro_torch.core.hybrid_gemv import (corrupt_flash_region,  # noqa: E402
                                          hybrid_gemv, plan_and_quantize)
from repro_torch.device import resolve_device  # noqa: E402

BER = 2e-4   # NAND-grade raw bit-error rate, as the JAX example injects


def rel_error(y: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))


def run(arch: str = "llama2-7b", reduced: bool = False,
        device: str = "cuda", seed: int = 0) -> dict:
    """Plan, quantize, protect, corrupt and multiply one matrix; returns
    the plan and the three relative errors against the float product."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    h = w = cfg.d_model
    spec = CAMBRICON_LLM_S
    plan = tiling.plan_matrix(h, w, spec)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    W = torch.randn((h, w), generator=gen, device=dev) * 0.05
    x = torch.randn((w,), generator=gen, device=dev)
    ref = W @ x
    hw = plan_and_quantize(W, spec, with_ecc=True, plan=plan)
    noisy = corrupt_flash_region(hw, BER, gen)
    return {
        "arch": cfg.name, "shape": (h, w), "plan": plan,
        "clean": rel_error(hybrid_gemv(hw, x), ref),
        "ecc": rel_error(hybrid_gemv(noisy, x), ref),
        "no_ecc": rel_error(hybrid_gemv(noisy._replace(ecc=None), x), ref),
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--reduced", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    r = run(args.arch, bool(args.reduced), args.device, args.seed)
    plan = r["plan"]
    h, w = r["shape"]
    print(f"matrix {h}x{w} ({r['arch']}) on Cambricon-LLM-S:")
    print(f"  optimal tile  : {plan.tile.h} x {plan.tile.w} "
          f"(paper Fig.13 optimum: 256 x 2048)")
    print(f"  alpha (flash) : {plan.alpha:.2f} -> {plan.flash_rows} rows "
          f"in-flash, {plan.npu_rows} rows streamed to NPU")
    print(f"\nhybrid GeMV rel-error vs float ({args.device}):")
    print(f"  clean weights        : {r['clean']:.4f} (int8 noise)")
    print(f"  BER {BER:.0e}, with ECC   : {r['ecc']:.4f}")
    print(f"  BER {BER:.0e}, without ECC: {r['no_ecc']:.4f}")


if __name__ == "__main__":
    main()
