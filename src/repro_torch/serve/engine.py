"""Continuous-batching serving engine (the JAX package's
``serve/engine.py``) over an LM's decode step:

- fixed ``max_batch`` decode slots backed by one cache (KV, SSM state or
  both; the KV part a ring buffer when ``window`` is set);
- a FIFO admission queue; finished slots are refilled between decode steps
  (continuous batching: no head-of-line blocking on long generations);
- per-request states QUEUED -> PREFILL -> DECODE -> DONE, with max-token
  and EOS termination.

A request's prompt is prefilled by stepping it through the decode step
token by token in its slot, as the reference does (one step function for
both phases).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step
from repro_torch.models.registry import CACHE_LAYOUT, build_model


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int = 32
    eos_id: int = -1  # -1 = never
    # runtime state
    generated: List[int] = dataclasses.field(default_factory=list)
    state: str = "QUEUED"
    slot: int = -1
    enqueue_t: float = 0.0
    finish_t: float = 0.0


class ServeEngine:
    """Continuous-batching decode engine over one model.

    ``params`` (the model's param tree on ``device``) skips the random
    init from ``seed``; ``device=None`` is the CUDA card.
    """

    def __init__(self, cfg: ArchConfig, *, max_batch: int = 8, cache_len: int = 256,
                 window: int = 0, seed: int = 0, device=None, params: Optional[Any] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            params = self.model.init(gen, self.device)
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.window = window
        self.cache = self.model.init_cache(max_batch, cache_len, self.device)
        self._decode = make_decode_step(self.model, window=window)
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int64)
        self.next_token = np.zeros(max_batch, np.int32)
        self.steps = 0
        self.completed: List[Request] = []

    # ------------------------------------------------------------------
    def _batch(self) -> Dict[str, torch.Tensor]:
        """Device inputs for one decode call, copied from the host buffers.

        ``next_token``/``slot_pos`` are mutated in place between calls; in
        the reference the copies are load-bearing (a zero-copy alias raced
        the asynchronous dispatch and wrote the final prompt token at every
        position), so the inputs are fresh copies here too.
        """
        tokens = torch.from_numpy(np.array(self.next_token)).reshape(-1, 1)
        pos = torch.from_numpy(np.array(self.slot_pos, np.int32))
        return {"tokens": tokens.to(self.device), "pos": pos.to(self.device)}

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.enqueue_t = time.time()
        self.queue.append(req)

    def _reset_slot_cache(self, slot: int) -> None:
        """Invalidate one slot's cache entries before admitting a request,
        in place: each written leaf's rows at the slot (its batch dim,
        ``registry.CACHE_LAYOUT``) set empty."""
        for name, t in self.cache.items():
            lay = CACHE_LAYOUT[name]
            if lay.kind != "read":
                t[(slice(None),) * lay.batch + (slot,)] = lay.empty

    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            req.state = "PREFILL"
            req.slot = slot
            self._reset_slot_cache(slot)
            with obs.span("serve.prefill", slot=slot, tokens=len(req.prompt)):
                for t, tok in enumerate(req.prompt):
                    self.next_token[slot] = tok
                    self.slot_pos[slot] = t
                    logits, self.cache = self._decode(self.params, self.cache, self._batch())
            first = int(torch.argmax(logits[slot]))
            req.generated.append(first)
            self.next_token[slot] = first
            self.slot_pos[slot] = len(req.prompt)
            req.state = "DECODE"
            self.slots[slot] = req

    def _retire(self, slot: int) -> None:
        req = self.slots[slot]
        req.state = "DONE"
        req.finish_t = time.time()
        self.completed.append(req)
        self.slots[slot] = None

    def step(self) -> int:
        """One engine iteration: admit, decode one token for every active
        slot, retire finished requests. Returns the number of active slots."""
        self._admit()
        active = [s for s in range(self.max_batch) if self.slots[s]]
        if not active:
            return 0
        with obs.span("serve.decode", active=len(active)):
            logits, self.cache = self._decode(self.params, self.cache, self._batch())
        toks = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        self.steps += 1
        obs.metrics.inc("serve.decode_steps")
        obs.metrics.inc("serve.tokens", len(active))
        for s in active:
            req = self.slots[s]
            tok = int(toks[s])
            req.generated.append(tok)
            self.next_token[s] = tok
            self.slot_pos[s] += 1
            done = (len(req.generated) >= req.max_new_tokens
                    or tok == req.eos_id
                    or self.slot_pos[s] >= self.cache_len - 1)
            if done:
                self._retire(s)
        return len(active)

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        while (self.queue or any(self.slots)) and self.steps < max_steps:
            self.step()
        return self.completed

    def stats(self) -> Dict[str, float]:
        if not self.completed:
            return {"completed": 0}
        lat = [r.finish_t - r.enqueue_t for r in self.completed]
        toks = sum(len(r.generated) for r in self.completed)
        return {
            "completed": len(self.completed),
            "decode_steps": self.steps,
            "tokens": toks,
            "mean_latency_s": float(np.mean(lat)),
            "tokens_per_step": toks / max(self.steps, 1),
        }
