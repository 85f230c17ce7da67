"""Batched serving engine: prefill + decode with a persistent cache.

The engine is the unit the paper's scheduler dispatches: a `prefill` call or a
`decode_run` (n greedy steps) is one "task"; pools own one engine each and
serve FCFS — mirroring the paper's real-platform setup (OpenCL contexts with
one queue per device, Sec. 7.1).

PyTorch runs eagerly, so there is no compiled prefill/decode: the engine
calls the model's methods, and on a card the model's attention and SSD
prefill go through the hand-written kernels (`repro_torch.kernels.ops`).
Serves the dense, hybrid and ssm families; recurrent states (Mamba2's,
mLSTM's and sLSTM's) stay float32 in the cache.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import Model


class ServeEngine:
    def __init__(self, model: Model, max_len: int = 512):
        """Serve `model` with caches of `max_len` positions.

        The serving copy of the weights is bf16, as in the reference: every
        floating parameter (norm weights, A_log, dt_bias and Dskip
        included) is cast to bfloat16 IN PLACE, so the float32 master is
        not kept beside it (at zamba2-7b width the two would hold 40 GB)."""
        self.model = model.to(torch.bfloat16)
        self.cfg = model.cfg
        self.max_len = max_len
        self.device = model.device

    def synchronize(self) -> None:
        """Wait for the engine's queued device work (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prefill(self, batch: dict):
        return self.model.prefill(batch, cache_len=self.max_len)

    def _greedy_next(self, logits):
        """Greedy token from last-position logits: (emitted, feed) where
        `emitted` is (B,) and `feed` has the trailing length-1 axis
        `decode_step` expects."""
        nxt = torch.argmax(logits[:, -1], dim=-1)
        return nxt, nxt[:, None]

    def decode_run(self, first_token, cache, start_pos: int, steps: int):
        """Greedy-decode `steps` tokens. Returns (tokens (B, steps), cache);
        the tokens stay on the device (no host sync per step)."""
        tok = first_token
        out = []
        pos = start_pos
        for _ in range(steps):
            logits, cache = self.model.decode_step(tok, cache, pos)
            nxt, tok = self._greedy_next(logits)
            out.append(nxt)
            pos += 1
        if not out:
            return first_token[:, :0], cache
        return torch.stack(out, dim=1), cache

    def generate(self, batch: dict, steps: int):
        """prefill + greedy decode; returns generated token ids (B, steps)."""
        logits, cache = self.prefill(batch)
        first, feed = self._greedy_next(logits)
        start = batch["tokens"].shape[1]
        toks, cache = self.decode_run(feed, cache, start, steps - 1)
        return torch.cat([first[:, None], toks], dim=1)


def request_service_fns(engine: ServeEngine, batch: dict, toks,
                        slowdown: int = 3):
    """Two request classes on two heterogeneous pools, as real work.

    Class 0 is a PREFILL request (one batched prefill — the interactive,
    latency-sensitive class) and class 1 a DECODE request (short prefill +
    a greedy decode run — the batch class). Pool 0 favors prefill, pool 1
    decode; the off-diagonal runs `slowdown` repetitions, giving the 2 x 2
    heterogeneous affinity the paper's CAB/GrIn placement exploits. Returns
    `service_fns` for `repro_torch.sched.virtual.VirtualTimeCluster`. Each
    task ends in a device synchronize, so a wall-clock service time covers
    the device's work, not its enqueue.
    """
    def prefill_task(size):
        engine.prefill(batch)
        engine.synchronize()

    def decode_task(size):
        _, cache = engine.prefill({k: (v[:, :4] if k == "tokens" else v)
                                   for k, v in batch.items()})
        engine.decode_run(toks[:, :1], cache, 4, 4)
        engine.synchronize()

    def slow(fn, n):
        return lambda size: [fn(size) for _ in range(n)]

    return [{0: prefill_task, 1: slow(decode_task, slowdown)},
            {0: slow(prefill_task, slowdown), 1: decode_task}]


def with_retries(service_fn, *, max_attempts: int = 3,
                 retryable: tuple = (RuntimeError, OSError),
                 on_wasted=None):
    """Wrap one service fn with transient-failure re-execution.

    A retryable exception loses the whole attempt (full re-execution — there
    is no mid-request checkpoint in serving), the task re-runs up to
    `max_attempts` times, and every lost attempt is reported through
    `on_wasted(attempt_index)` so a caller can account wasted work against
    goodput. Non-retryable exceptions and exhaustion propagate.
    """
    if max_attempts < 1:
        raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")

    def wrapped(size):
        for attempt in range(max_attempts):
            try:
                return service_fn(size)
            except retryable:
                if on_wasted is not None:
                    on_wasted(attempt)
                if attempt + 1 >= max_attempts:
                    raise
    return wrapped
