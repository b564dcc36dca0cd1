"""One engine's decode step as a replayed CUDA graph.

The port's counterpart of the JAX engine's jitted decode dispatches
(``repro.serving.core._jit_decode_paged``, ``_jit_decode_sample_paged``
and, in wave mode, ``_jit_decode`` and ``_jit_decode_sample``): where XLA
makes a decode step one compiled dispatch, the port captures the step's
few thousand kernel launches once and replays them with one host call.
An engine owns one :class:`DecodeGraph`, which holds up to three graphs,
all over the same static buffers and one memory pool.  A continuous-mode
engine's kinds:

* ``"sync"``: ``decode_step_paged``, the logits left in a static output
  (the synchronous loop samples them in a second dispatch);
* ``"fused"`` and ``"fused_greedy"``: ``decode_and_sample_paged`` with
  ``sampler.fused_sample`` for ``greedy_only`` False and True, the tokens
  written to the static ``tok_dev``, which both read as the chained input
  of the next step, so the chain survives a switch between them.

A wave-mode engine's (``wave=True``), over the shared-cursor cache:
``"wave"`` (``decode_step``) and ``"wave_fused"`` / ``"wave_fused_greedy"``
(``decode_and_sample``), the new cursor copied into ``cache["len"]`` in
place.

The host fills the inputs (last tokens, ``use_dev``, the active mask, the
block table and the five sampling rows) into one pinned staging buffer of
int32 words, two of them used in turns, and one non-blocking copy moves it
to the static device buffer ahead of the replay.  A staging buffer is
rewritten only after the copy that last read it has finished, so the host
never races the card.  ``readback`` queues the tokens' copy into one of
two pinned buffers right after a fused step and records an event; the
overlapped loop waits on that event only, never on a younger step.

A graph keeps the addresses it was captured with: the page pools (and an
int8 cache's scale pools) or the wave cache's K/V (and cross-attention)
tensors, the lengths ``lens`` (which every step, and a prefill chunk
between steps, rewrites in place) or the cursor ``len``, and the Mamba
state pools.  Before each replay they are checked against the cache the
engine passes, and a moved tensor raises; nothing is recaptured or run
eagerly in its place.  On the CPU, and inside :func:`disabled`, the same
step runs eagerly on the same buffers.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models import model as model_lib
from repro_torch.serving import sampler

KINDS = ("sync", "fused", "fused_greedy")
WAVE_KINDS = ("wave", "wave_fused", "wave_fused_greedy")
_ENABLED = True


@contextlib.contextmanager
def disabled():
    """Run every decode step eagerly on the card (the counterpart of
    ``jax.disable_jit``): the oracle that a replayed step gives the bits
    of the eager one.  For tests and ``chip_smoke.py``."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, False
    try:
        yield
    finally:
        _ENABLED = prev


def enabled() -> bool:
    return _ENABLED


def _cache_tensors(cache: dict) -> list[torch.Tensor]:
    """The tensors of a paged or wave cache a step reads and writes in
    place."""
    if "lens" in cache:
        out = [cache[key] for key in blocks.paged_pool_keys(cache)]
        out.append(cache["lens"])
    else:
        out = [cache[key] for key in ("k", "v", "ckv", "krope", "xk", "xv")
               if key in cache]
        out.append(cache["len"])
    for pools in model_lib.state_pools(cache):
        out += [pools[name] for name in sorted(pools)]
    return out


def keep_step_state(cache: dict) -> dict:
    """Device copies of what a decode step overwrites with new values in
    place: the lengths (``lens``, or a wave cache's ``len``) and the Mamba
    state pools."""
    key = "lens" if "lens" in cache else "len"
    kept = {key: cache[key].clone()}
    for name in ("mamba", "tail", "layers"):
        pools = cache.get(name)
        if isinstance(pools, dict):
            kept[name] = {k: v.clone() for k, v in pools.items()}
    return kept


def restore_step_state(cache: dict, kept: dict) -> None:
    """Copy :func:`keep_step_state`'s tensors back in place (the storage a
    captured graph reads stays put)."""
    for key, val in kept.items():
        if isinstance(val, dict):
            for k, v in val.items():
                cache[key][k].copy_(v)
        else:
            cache[key].copy_(val)


class DecodeGraph:
    """Static inputs and the captured decode steps of one engine."""

    def __init__(self, cfg: ModelConfig, params: dict, max_batch: int,
                 pages_per_slot: int, device: torch.device,
                 wave: bool = False):
        self.cfg = cfg
        self.params = params
        self.device = device
        self.wave = wave
        self.kinds = WAVE_KINDS if wave else KINDS
        b = max_batch
        # packed int32 words: tok_host, use_dev, active, seeds, counts,
        # top_k, temperature (float32 bits), top_p (float32 bits), block
        n = 8 * b + b * pages_per_slot
        self.buf = torch.zeros((n,), dtype=torch.int32, device=device)
        self.tok_host, self.use_dev, self.active, self.seeds, self.counts, \
            self.top_k = (self.buf[i * b:(i + 1) * b] for i in range(6))
        self.temps = self.buf[6 * b:7 * b].view(torch.float32)
        self.top_p = self.buf[7 * b:8 * b].view(torch.float32)
        self.block = self.buf[8 * b:].view(b, pages_per_slot)
        self.tok_dev = torch.zeros((b,), dtype=torch.int32, device=device)
        self._b = b
        self._cuda = device.type == "cuda"
        self._graphs: dict[str, torch.cuda.CUDAGraph] = {}
        self._outputs: dict[str, torch.Tensor] = {}
        self._deltas: dict[str, dict[str, int]] = {}
        self._pointers: dict[str, list[int]] = {}
        self._pool = None
        self.replays = 0
        self.capture_s: dict[str, float] = {}  # warm-up + capture, wall
        if self._cuda:
            self._staging = [torch.zeros((n,), dtype=torch.int32,
                                         pin_memory=True) for _ in range(2)]
            # an event not yet recorded synchronizes at once
            self._staged = [torch.cuda.Event(), torch.cuda.Event()]
            self._stage_turn = 0
            self._readback = [torch.zeros((b,), dtype=torch.int32,
                                          pin_memory=True) for _ in range(2)]
            self._read_events = [torch.cuda.Event(), torch.cuda.Event()]
            self._read_turn = 0
            self._host = self._staging[0].numpy()
        else:
            self._host = self.buf.numpy()

    def _cache_size(self) -> int:
        """The number of captured graphs (at most one a step kind): the
        sanitizer's retrace budget reads it, as it reads a jitted
        function's trace-cache size."""
        return len(self._graphs)

    # ------------------------------------------------------------------
    # inputs and outputs
    # ------------------------------------------------------------------
    def stage(self, tok_host: np.ndarray, active: np.ndarray,
              block: np.ndarray, use_dev: Optional[np.ndarray] = None,
              rows: Optional[tuple[np.ndarray, ...]] = None) -> None:
        """Write one step's inputs on the host; ``run`` moves them to the
        card.  ``rows`` are the sampling rows (seeds, counts, temperature,
        top_k, top_p) of a fused step with a stochastic row.  A wave step
        has no active mask or block table (None)."""
        b = self._b
        if self._cuda:
            turn = self._stage_turn
            self._staged[turn].synchronize()
            self._host = self._staging[turn].numpy()
        h = self._host
        h[0:b] = tok_host
        h[b:2 * b] = 0 if use_dev is None else use_dev
        if active is not None:
            h[2 * b:3 * b] = active
        if rows is not None:
            seeds, counts, temps, top_k, top_p = rows
            h[3 * b:4 * b] = seeds
            h[4 * b:5 * b] = counts
            h[5 * b:6 * b] = top_k
            h[6 * b:7 * b].view(np.float32)[:] = temps
            h[7 * b:8 * b].view(np.float32)[:] = top_p
        if block is not None:
            h[8 * b:] = block.reshape(-1)

    def readback(self):
        """Queue the copy of the last fused step's tokens to the host;
        returns a handle for :meth:`tokens`."""
        if not self._cuda:
            return self.tok_dev.numpy().copy()
        turn = self._read_turn
        self._read_turn ^= 1
        self._readback[turn].copy_(self.tok_dev, non_blocking=True)
        self._read_events[turn].record()
        return turn

    def tokens(self, handle) -> np.ndarray:
        """The tokens of a :meth:`readback`, waiting for that copy only."""
        if not self._cuda:
            return handle
        self._read_events[handle].synchronize()
        return self._readback[handle].numpy().copy()

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _body(self, kind: str, cache: dict) -> torch.Tensor:
        if self.wave:
            return self._wave_body(kind, cache)
        c = {**cache, "block": self.block}
        active = self.active != 0
        if kind == "sync":
            logits, new = model_lib.decode_step_paged(
                self.params, self.cfg, self.tok_host, c, active)
            cache["lens"].copy_(new["lens"])
            return logits
        greedy_only = kind == "fused_greedy"
        tok, new = model_lib.decode_and_sample_paged(
            self.params, self.cfg, self.tok_host, self.tok_dev,
            self.use_dev != 0, c, active,
            lambda lg: sampler.fused_sample(
                lg, self.seeds, self.counts, self.temps, self.top_k,
                self.top_p, greedy_only=greedy_only))
        cache["lens"].copy_(new["lens"])
        self.tok_dev.copy_(tok)
        return self.tok_dev

    def _wave_body(self, kind: str, cache: dict) -> torch.Tensor:
        if kind == "wave":
            logits, new = model_lib.decode_step(self.params, self.cfg,
                                                self.tok_host, cache)
            cache["len"].copy_(new["len"])
            return logits
        greedy_only = kind == "wave_fused_greedy"
        tok, new = model_lib.decode_and_sample(
            self.params, self.cfg, self.tok_host, self.tok_dev,
            self.use_dev != 0, cache,
            lambda lg: sampler.fused_sample(
                lg, self.seeds, self.counts, self.temps, self.top_k,
                self.top_p, greedy_only=greedy_only))
        cache["len"].copy_(new["len"])
        self.tok_dev.copy_(tok)
        return self.tok_dev

    def _settled(self, cache: dict) -> bool:
        """False while a Mamba step would still promote a conv pool to its
        activations' dtype (a float32 model over a bf16 cache, on its first
        step): that step rebinds the pool, so it runs eagerly."""
        x_dtype = self.params["embed"].dtype
        for pools in model_lib.state_pools(cache):
            if pools["conv"].dtype != \
                    torch.promote_types(pools["conv"].dtype, x_dtype):
                return False
        return True

    def run(self, kind: str, cache: dict) -> torch.Tensor:
        """One decode step of ``kind`` over the staged inputs and
        ``cache`` (written in place).  Returns the static logits ("sync")
        or ``tok_dev`` (fused kinds)."""
        if kind not in self.kinds:
            raise ValueError(f"unknown decode step {kind!r} "
                             f"(this graph's: {self.kinds})")
        if not self._cuda:
            return self._body(kind, cache)
        graph = enabled() and self._settled(cache)
        if graph and kind not in self._graphs:
            self._capture(kind, cache)
        turn = self._stage_turn
        self._stage_turn ^= 1
        self.buf.copy_(self._staging[turn], non_blocking=True)
        self._staged[turn].record()
        if not graph:
            return self._body(kind, cache)
        now = [t.data_ptr() for t in _cache_tensors(cache)]
        if now != self._pointers[kind]:
            raise RuntimeError(
                f"decode graph {kind!r}: a cache tensor (pools, lens or "
                f"state) moved since capture; a replay would read and write "
                f"memory the cache no longer owns")
        self._graphs[kind].replay()
        self.replays += 1
        kernels.add_launch_counts(self._deltas[kind])
        return self._outputs[kind]

    def _capture(self, kind: str, cache: dict) -> None:
        """Warm the step up eagerly on a side stream with every lane
        inactive (the pools, lengths and states stay as they are; the null
        page takes the writes), which loads the kernel library and its
        modules, then capture it into the engine's memory pool.  A wave
        step has no inactive lane: its warm-up writes the K/V rows at the
        cursor, which the replay that follows rewrites, and the cursor and
        the Mamba states, which are copied back.  The wrappers count their
        launches while capturing; those are taken back and added again on
        every replay."""
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        saved_tok = self.tok_dev.clone()
        kept = keep_step_state(cache) if self.wave else None
        self.active.zero_()
        self.use_dev.zero_()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._body(kind, cache)
        cur.wait_stream(side)
        self.tok_dev.copy_(saved_tok)
        if kept is not None:
            restore_step_state(cache, kept)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = kernels.launch_counts()
        with torch.cuda.graph(graph, pool=self._pool):
            out = self._body(kind, cache)
        after = kernels.launch_counts()
        delta = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        kernels.add_launch_counts({k: -n for k, n in delta.items()})
        self._graphs[kind] = graph
        self._outputs[kind] = out
        self._deltas[kind] = delta
        self._pointers[kind] = [t.data_ptr() for t in _cache_tensors(cache)]
        self.capture_s[kind] = time.perf_counter() - t0
