"""Slot-based continuous-batching serving engine.

A fixed pool of ``max_slots`` decode slots shares one cache allocation (KV
caches and, for recurrent layers, their states).
Requests prefill at batch 1 straight into a free slot's stripe of the cache;
every engine iteration decodes *all* slots in one batched ``decode_step``
call with per-slot positions; finished slots (EOS or max-tokens) free
immediately and admit queued requests: the standard continuous-batching
discipline (Orca/vLLM style).

The slot axis of the cache is known, not searched for: axis 1 of the stacked
``groups`` leaves ``[G,B,S,Hk,D]`` and axis 0 of the ``rem`` leaves, so a
server with ``max_slots=1`` works like any other.

SLO accounting mirrors the paper's measurement: per-request end-to-end
latency (arrival -> last token) and time-to-first-token.

Spans (``repro_torch.spans``, recorded only while a profiler records):
``engine.step`` around each iteration, holding ``engine.admit`` (the
batch-1 prefills, each an ``engine.prefill`` with its first token read
back, after an ``engine.queue`` record of its wait from ``submit``),
``engine.decode`` (the decode step's enqueue), ``engine.readback`` (the
sampled tokens copied to the host, which waits for the device) and
``engine.bookkeep`` (the per-slot loop after it).  A request's spans share
its ``rid``.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.common import resolve_device
from repro_torch.models.registry import init_model

PyTree = Any


@dataclass
class ServeConfig:
    max_slots: int = 4
    max_len: int = 256
    max_new_tokens: int = 32
    eos_id: int = 1
    greedy: bool = True


@dataclass
class Request:
    rid: int
    tokens: np.ndarray                 # [S] prompt
    arrival: float = 0.0
    max_new_tokens: Optional[int] = None
    # stamped by ``submit`` on the spans' clock (time.perf_counter_ns)
    t_submit_ns: int = 0
    queued_ahead: int = 0              # requests queued before it
    # filled by the engine
    output: list[int] = field(default_factory=list)
    t_first_token: Optional[float] = None
    t_finish: Optional[float] = None


class SlotServer:
    """Continuous-batching server for decoder-only configs.

    ``device=None`` means the GPU; the server raises when there is none
    rather than run on the CPU unasked.
    """

    def __init__(self, cfg: ArchConfig, params: Optional[PyTree] = None, *,
                 serve_cfg: Optional[ServeConfig] = None, seed: int = 0,
                 clock: Optional[Callable[[], float]] = None, device=None):
        if cfg.is_encoder_decoder:
            raise ValueError(
                "SlotServer serves decoder-only LMs; serve an encoder-"
                "decoder model through repro_torch.models.registry."
                "serve_prefill / serve_decode")
        self.cfg = cfg
        self.device = resolve_device(device)
        # a ServeConfig() default argument would be evaluated once and
        # shared by every server: mutating one server's sc (e.g. tuning
        # max_new_tokens) would silently retune all of them
        self.sc = serve_cfg if serve_cfg is not None else ServeConfig()
        self.params = (params if params is not None
                       else init_model(cfg, seed=seed, device=self.device))
        self.clock = clock or (lambda: 0.0)
        B, L = self.sc.max_slots, self.sc.max_len
        self.caches = transformer.init_caches(cfg, B, L, device=self.device)
        self.pos = np.zeros(B, np.int64)            # next position per slot
        self.budget = np.zeros(B, np.int64)         # tokens left per slot
        self.active = np.zeros(B, bool)
        self.slot_req: list[Optional[Request]] = [None] * B
        self.queue: list[Request] = []
        self.done: list[Request] = []
        self._rid = itertools.count()
        self.n_steps = 0
        self._last = torch.zeros(B, dtype=torch.long,
                                 device=self.device)   # last sampled token

    # -- compute -----------------------------------------------------------------

    def _prefill(self, tokens: np.ndarray, slot: int) -> torch.Tensor:
        """Batch-1 prefill written straight into ``slot``'s stripe of the
        shared cache.  Returns the last position's logits [V]."""
        toks = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        logits, _ = transformer.prefill(self.params, self.cfg, toks,
                                        caches=self.caches, slot=slot)
        return logits[0]

    def _decode(self) -> torch.Tensor:
        """One decode step over all slots (per-slot positions); inactive
        slots still compute but their outputs are ignored.  An active slot
        is at most at ``max_len - 1``; a slot that finished by reaching the
        end of its stripe is left at ``max_len``, one past it, so stale
        positions are clamped into the cache before they index it."""
        pos = torch.as_tensor(np.minimum(self.pos, self.sc.max_len - 1),
                              device=self.device)
        logits, _ = transformer.decode_step(self.params, self.cfg, self._last,
                                            pos, self.caches)
        return torch.argmax(logits, dim=-1)

    # -- public API -----------------------------------------------------------------

    def submit(self, tokens: np.ndarray,
               max_new_tokens: Optional[int] = None) -> Request:
        req = Request(next(self._rid), np.asarray(tokens, np.int32),
                      arrival=self.clock(),
                      max_new_tokens=max_new_tokens,
                      t_submit_ns=time.perf_counter_ns(),
                      queued_ahead=len(self.queue))
        self.queue.append(req)
        return req

    def _admit(self):
        with spans.span("engine.admit") as sp:
            queued = len(self.queue)
            for slot in range(self.sc.max_slots):
                if self.active[slot] or not self.queue:
                    continue
                req = self.queue.pop(0)
                toks = req.tokens[-(self.sc.max_len - 1):][None, :]
                spans.record("engine.queue", req.t_submit_ns, rid=req.rid,
                             ahead=req.queued_ahead)
                with spans.span("engine.prefill", rid=req.rid,
                                tokens=toks.shape[1], slot=slot):
                    logits = self._prefill(toks, slot)
                    first = int(torch.argmax(logits, -1))
                req.output.append(first)
                req.t_first_token = self.clock()
                self.slot_req[slot] = req
                self.pos[slot] = toks.shape[1]
                self.budget[slot] = (req.max_new_tokens or
                                     self.sc.max_new_tokens) - 1
                self.active[slot] = True
                self._last[slot] = first
                if first == self.sc.eos_id or self.budget[slot] <= 0:
                    self._finish(slot)
            sp.set(prefills=queued - len(self.queue))

    def _finish(self, slot: int):
        req = self.slot_req[slot]
        req.t_finish = self.clock()
        self.done.append(req)
        self.slot_req[slot] = None
        self.active[slot] = False

    def step(self) -> int:
        """One engine iteration: admit then decode all active slots.
        Returns number of active slots decoded."""
        with spans.span("engine.step") as sp:
            sp.set(step=self.n_steps, queue=len(self.queue))
            self.n_steps += 1
            self._admit()
            if not self.active.any():
                return 0
            with spans.span("engine.decode") as sp:
                if sp:
                    sp.set(rows=int(self.active.sum()),
                           kv_tokens=int(self.pos[self.active].sum()))
                nxt = self._decode()
            with spans.span("engine.readback"):
                nxt_np = nxt.cpu().numpy()
            with spans.span("engine.bookkeep") as sp:
                n, done = 0, len(self.done)
                for slot in range(self.sc.max_slots):
                    if not self.active[slot]:
                        continue
                    n += 1
                    tok = int(nxt_np[slot])
                    req = self.slot_req[slot]
                    req.output.append(tok)
                    self.pos[slot] += 1
                    self.budget[slot] -= 1
                    if (tok == self.sc.eos_id or self.budget[slot] <= 0
                            or self.pos[slot] >= self.sc.max_len - 1):
                        self._finish(slot)
                self._last = nxt
                sp.set(tokens=n, finished=len(self.done) - done)
            return n

    def run_until_drained(self, max_iters: int = 10_000) -> list[Request]:
        for _ in range(max_iters):
            if not self.queue and not self.active.any():
                break
            self.step()
        return self.done

    # -- metrics ------------------------------------------------------------------------

    def latencies(self) -> list[float]:
        return [r.t_finish - r.arrival for r in self.done
                if r.t_finish is not None]
