"""AdamW in plain PyTorch, the port's copy of ``repro.training.optimizer``.

Float32 arithmetic in the JAX function's order, op by op: ``t`` is the
step as float32 and ``b1 ** t`` a float32 power; each Python constant
(``b1``, ``1 - b1``, ``eps``, ``weight_decay``, ``lr``) enters as the
float32 it rounds to, as JAX's weak typing makes it; every product and sum
is a separate rounding (no fused multiply-add), as the JAX source writes
it; the square root is correctly rounded, as XLA's is.  Moments are
float32 whatever the parameter's dtype; the update runs in float32 and
casts back.  ``mu`` / ``nu`` mirror the params' tree (the
port's layout: layers in lists).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.distributed.checkpoint import tree_leaves, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor     # int32 []
    mu: dict
    nu: dict


def tree_map(fn, tree):
    """``fn`` over the tensor leaves of a params tree (dicts, lists,
    None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def init_adamw(params) -> AdamWState:
    dev = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.  CUDA's ``sqrtf`` and XLA's
    are; torch's vectorized CPU kernel is not (it misses by an ulp on ~0.4%
    of inputs), so on the CPU the root is taken in float64, which rounds
    to the correctly rounded float32 root."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _f32(x: float) -> float:
    """The float32 a Python constant rounds to (JAX's weak typing)."""
    return float(torch.tensor(x, dtype=torch.float32))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr: float = 3e-4,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> tuple[dict, AdamWState]:
    step = state.step + 1
    t = step.float()
    one = torch.ones((), dtype=torch.float32, device=t.device)
    c1 = one - torch.pow(torch.full_like(t, _f32(b1)), t)
    c2 = one - torch.pow(torch.full_like(t, _f32(b2)), t)
    k_b1, k_1b1 = _f32(b1), _f32(1 - b1)
    k_b2, k_1b2 = _f32(b2), _f32(1 - b2)
    k_eps, k_wd, k_lr = _f32(eps), _f32(weight_decay), _f32(lr)

    def upd(p, g, m, n):
        g = g.float()
        pf = p.float()
        m = m * k_b1 + g * k_1b1
        n = n * k_b2 + g.square() * k_1b2
        mh = m / c1
        nh = n / c2
        step_val = mh / (_sqrt(nh) + k_eps) + pf * k_wd
        return (pf - step_val * k_lr).to(p.dtype), m, n

    flat_p = tree_leaves(params)
    outs = [upd(p, g, m, n) for p, g, m, n in zip(
        flat_p, tree_leaves(grads), tree_leaves(state.mu),
        tree_leaves(state.nu))]
    new_p = tree_unflatten(params, [o[0] for o in outs])
    new_m = tree_unflatten(params, [o[1] for o in outs])
    new_n = tree_unflatten(params, [o[2] for o in outs])
    return new_p, AdamWState(step=step, mu=new_m, nu=new_n)
