"""Training loop: loss, microbatched gradient accumulation, activation
checkpointing (remat), train step.  The port's copy of
``repro.training.train_loop``.

Gradients come from torch autograd through the port's ``forward``: on the
CPU the plain versions of every kernel; on the card the float32 causal
attention pair (``kernels/flash_attention/ops.py`` ``AttentionF32``: a
forward, a dK/dV and a dQ kernel), the moe family's float32 grouped GEMM
(``kernels/grouped_gemm/ops.py`` ``GroupedGemmF32``: a forward, a dX and a
dW kernel), the embedding's JAX gradient (``models/model.py``
``_EmbedLookup``) and library products for the linears.  So the dense,
vlm and moe families train on the card.  A family whose forward on the
card runs a kernel that has no backward raises ``NotImplementedError``
there (``NO_BACKWARD``); each of them trains on the CPU.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.checkpoint import tree_leaves, tree_unflatten
from repro_torch.models import model as model_lib
from repro_torch.training.optimizer import AdamWState, adamw_update

# family -> the kernel on its CUDA forward path that has no backward
NO_BACKWARD = {
    "mla_moe": "B3 at head dim 192 (csrc/flash_attention.cu; the float32 "
               "pair takes head dims 64 and 128)",
    "hybrid": "the SSD intra-chunk kernel B6 (csrc/ssd_scan.cu)",
    "ssm": "the SSD intra-chunk kernel B6 (csrc/ssd_scan.cu)",
    "audio": "B3's bidirectional mode (csrc/flash_attention.cu)",
}


def check_trainable(cfg: ModelConfig, device: torch.device) -> None:
    """Raise where the card has no backward for the family's forward."""
    if device.type == "cuda" and cfg.family in NO_BACKWARD:
        raise NotImplementedError(
            f"{cfg.name}: training the {cfg.family} family on CUDA needs a "
            f"backward for {NO_BACKWARD[cfg.family]}, which has none; "
            f"train it with device='cpu'")


def loss_fn(params, cfg: ModelConfig, tokens: torch.Tensor,
            extras: dict | None = None) -> torch.Tensor:
    """Causal LM loss (teacher forcing, shift-by-one): the mean of
    log-sum-exp minus the target's logit, in float32; the vlm family's
    vision rows produce no loss.  The target is picked with ``gather``,
    the exact value JAX's one-hot sum gives."""
    logits = model_lib.forward(params, cfg, tokens, extras)
    start = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    logits = logits[:, start:, :][:, :-1].float()
    tgt = tokens[:, 1:].long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, tgt[..., None])[..., 0]
    return (lse - picked).mean()


def value_and_grad(params, cfg: ModelConfig, tokens: torch.Tensor,
                   extras: dict | None = None, remat: bool = False
                   ) -> tuple[torch.Tensor, dict]:
    """(loss, grads) of ``loss_fn`` with respect to every leaf of
    ``params`` (grads in the params' tree).  ``remat``: the forward under
    ``torch.utils.checkpoint`` (non-reentrant), recomputed in the backward
    instead of keeping its activations, as ``jax.checkpoint`` does."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    tree = tree_unflatten(params, leaves)
    with torch.enable_grad():
        if remat:
            loss = checkpoint(loss_fn, tree, cfg, tokens, extras,
                              use_reentrant=False)
        else:
            loss = loss_fn(tree, cfg, tokens, extras)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig, microbatches: int = 1,
                    lr: float = 3e-4, remat: bool = True,
                    grad_transform=None):
    """``train_step(params, opt_state, tokens, extras=None) -> (params,
    opt_state, loss)``.

    ``microbatches`` splits the batch's rows into that many consecutive
    groups; their float32 gradients and losses are summed in order from
    zeros and divided by the count (JAX's ``lax.scan``).
    ``grad_transform`` maps the gradient tree before the update."""

    def train_step(params, opt_state: AdamWState, tokens, extras=None):
        check_trainable(cfg, tokens.device)
        if microbatches == 1:
            loss, grads = value_and_grad(params, cfg, tokens, extras, remat)
        else:
            mb = tokens.reshape(microbatches, -1, tokens.shape[-1])
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in tree_leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(microbatches):
                ex = None if extras is None else {
                    k: a.reshape((microbatches, -1) + a.shape[1:])[i]
                    for k, a in extras.items()}
                l_i, g_i = value_and_grad(params, cfg, mb[i], ex, remat)
                grads = [a + b.float()
                         for a, b in zip(grads, tree_leaves(g_i))]
                loss = loss + l_i
            grads = tree_unflatten(params, [g / microbatches for g in grads])
            loss = loss / microbatches
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state = adamw_update(params, grads, opt_state, lr=lr)
        return params, opt_state, loss

    return train_step
