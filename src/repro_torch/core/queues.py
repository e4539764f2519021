"""Launch-queue / client / job plumbing for the simulator.

Semantics mirror the CUDA stream model LithOS interposes on (§4.2):

* A *client* (tenant application) owns one launch queue (stream).
* Work arrives as *jobs* — one inference request or one training step.
* A job is a list of *batches*; each batch is a kernel sequence followed by
  an explicit sync event (the decode loop syncs every iteration to sample a
  token; training syncs per step).  Sync events delimit the predictor's
  ordinal indexing (§4.7).
* Within a queue kernels are strictly FIFO: kernel n+1 cannot start before
  kernel n completes (stream ordering).  Because dispatch happens exactly at
  the predecessor's completion instant and launch overhead is charged inside
  kernel latency, this is equivalent to a pipelined stream.

Open-loop clients (inference) have Poisson arrivals; closed-loop clients
(best-effort training) start the next job the moment the previous finishes.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.types import KernelTask, Priority
from repro_torch.core.workloads import (AppSpec, ContinuousBatchState, OpDesc,
                                        bucket_kv, continuous_decode_trace,
                                        continuous_prefill_trace,
                                        sample_prompt_len)


@dataclass
class Batch:
    tasks: list[KernelTask]


@dataclass
class Job:
    batches: list[Batch]
    arrival: float
    jid: int
    t_finish: Optional[float] = None

    def n_kernels(self) -> int:
        return sum(len(b.tasks) for b in self.batches)


def _build_batches(ops: list[OpDesc], client_id: int, queue_id: int,
                   batch_marks: list[int], kids=None) -> list[Batch]:
    """Split an op list into batches at the given boundaries, assigning
    per-batch ordinals.  ``kids`` is the owning simulator's kernel-id
    stream (None falls back to the module-global one)."""
    batches, prev = [], 0
    for end in batch_marks + [len(ops)]:
        if end <= prev:
            continue
        tasks = []
        for i, op in enumerate(ops[prev:end]):
            extra = {} if kids is None else {"kid": next(kids)}
            tasks.append(KernelTask(op.name, op.work(), client_id=client_id,
                                    queue_id=queue_id, ordinal=i,
                                    phase=op.phase, **extra))
        batches.append(Batch(tasks))
        prev = end
    return batches


class Client:
    """One tenant: job generation + launch-queue state."""

    def __init__(self, cid: int, spec: AppSpec, horizon: float,
                 seed: int = 0):
        self.cid = cid
        self.spec = spec
        self.rng = np.random.default_rng((seed, spec.seed, cid))
        self.horizon = horizon
        self.pending: deque[Job] = deque()          # arrived, not started
        self.current: Optional[Job] = None
        self.batch_idx = 0
        self.kernel_idx = 0                          # next kernel within batch
        self.outstanding = 0                         # dispatched, incomplete
        self.completed: list[Job] = []
        self.jobs_issued = 0
        self.job_kernel_counts: list[int] = []   # kernels per issued job
        self.slice_seconds = 0.0
        self._arrivals = spec.arrivals(horizon, self.rng)
        # Continuous batching (llm_continuous): arrivals deliver *requests*
        # into this state machine; jobs are per-iteration batches built in
        # start_next_job.  None for every other kind.
        self.cbs: Optional[ContinuousBatchState] = (
            ContinuousBatchState(spec.cfg, spec.max_batch)
            if spec.kind == "llm_continuous" else None)
        # Live KV-cache footprint (bytes) — the scheduler's memory-floor
        # input (kv_floor_slices).  0 for tenants without a KV cache.
        self.kv_bytes = 0.0
        # Kernel-id stream: the owning simulator's, so kid assignment is a
        # per-simulator sequence no matter how several simulators' event
        # loops interleave (the hierarchy tiers' parity contract).
        self.kids = None
        # Engine hook (VecSimulator): notified after every queue-state
        # mutation so the engine can maintain incremental ready/startable
        # sets instead of scanning all clients per event.  None under the
        # reference engine (one attribute test per mutation, nothing more).
        self._watch = None
        # Lean-memory mode (collect_records=False): completed jobs drop
        # their batch/task objects — million-request traces would otherwise
        # retain every KernelTask ever executed.
        self._drop_batches = False

    # -- job generation -------------------------------------------------------

    @property
    def priority(self) -> Priority:
        return self.spec.priority

    def arrivals(self) -> list[float]:
        return self._arrivals

    def make_job(self, arrival: float) -> Job:
        ops = self.spec.job_trace(self.rng)
        # batch boundaries: decode-loop iterations sync individually.  The
        # trace builder emits prefill ops then repeated decode-step blocks;
        # for simplicity we sync per job for train/fwd and keep LLM decode
        # steps as separate batches via marker search on the "embed" op.
        marks: list[int] = []
        if self.spec.kind in ("llm_infer", "llm_decode"):
            marks = [i for i, op in enumerate(ops)
                     if i > 0 and op.name.startswith("embed")]
        self.jobs_issued += 1
        job = Job(_build_batches(ops, self.cid, self.cid, marks,
                                 kids=self.kids),
                  arrival, jid=self.jobs_issued)
        # record the *actual* kernels of each issued job: fractional-progress
        # metrics must divide by the sim's own traces, not resample them
        self.job_kernel_counts.append(job.n_kernels())
        return job

    def on_arrival(self, now: float):
        """One open-loop arrival: a *request* (continuous batching) or a
        whole job.  This is the single arrival entry point for both
        engines, so every stochastic draw happens here, in the client's
        own RNG stream, in arrival order — engine interleaving and
        prefill/decode phase splits cannot reorder the draws."""
        if self.cbs is not None:
            S = sample_prompt_len(self.spec.prompt_mix, self.rng)
            n_out = max(1, int(self.rng.geometric(
                1.0 / self.spec.decode_tokens)))
            n_out = min(n_out, 4 * self.spec.decode_tokens)
            self.cbs.add_request(S, n_out, now)
        elif self.spec.kind != "train":
            self.pending.append(self.make_job(now))
        self.start_next_job(now)      # train: the t=0 closed-loop kick

    def _make_iteration_job(self, now: float) -> Job:
        """One continuous-batching iteration as a job: a prefill segment
        per joining request (each its own batch — its own sync/ordinal
        space) followed by one fused decode step over the resident batch.
        Composition comes from ContinuousBatchState; no RNG draws here."""
        joiners, decoders = self.cbs.begin_iteration()
        cfg, fusion = self.spec.cfg, self.spec.fusion
        ops: list[OpDesc] = []
        marks: list[int] = []
        for r in joiners:
            if ops:
                marks.append(len(ops))
            ops = ops + continuous_prefill_trace(cfg, r.prompt_len, fusion)
        if decoders:
            if ops:
                marks.append(len(ops))
            mean_kv = (sum(r.kv_len for r in decoders)
                       + len(decoders) - 1) // len(decoders)
            ops = ops + continuous_decode_trace(cfg, len(decoders),
                                                bucket_kv(mean_kv), fusion)
        self.kv_bytes = self.cbs.total_kv_bytes
        self.jobs_issued += 1
        job = Job(_build_batches(ops, self.cid, self.cid, marks,
                                 kids=self.kids),
                  now, jid=self.jobs_issued)
        self.job_kernel_counts.append(job.n_kernels())
        return job

    # -- queue state ------------------------------------------------------------

    @property
    def closed_loop(self) -> bool:
        return self.spec.kind == "train" or self.spec.rps <= 0

    def _startable_now(self) -> bool:
        """Could start_next_job succeed right now?  The vec engine's
        incremental startable-set predicate — must mirror start_next_job
        exactly."""
        if self.current is not None:
            return False
        if self.cbs is not None:
            return self.cbs.has_work
        return bool(self.pending) or self.closed_loop

    def start_next_job(self, now: float) -> bool:
        if self.current is not None:
            return False
        if self.cbs is not None:
            if not self.cbs.has_work:
                return False
            self.current = self._make_iteration_job(now)
        elif self.pending:
            self.current = self.pending.popleft()
        elif self.closed_loop:
            self.current = self.make_job(now)
        else:
            return False
        self.batch_idx = 0
        self.kernel_idx = 0
        if self._watch is not None:
            self._watch._client_refresh(self)
        return True

    def peek(self) -> Optional[KernelTask]:
        """Next dispatchable kernel (strict FIFO: only when nothing is in
        flight for this queue)."""
        if self.current is None or self.outstanding > 0:
            return None
        b = self.current.batches[self.batch_idx]
        if self.kernel_idx < len(b.tasks):
            return b.tasks[self.kernel_idx]
        return None

    def pop(self) -> KernelTask:
        t = self.peek()
        assert t is not None
        self.kernel_idx += 1
        self.outstanding += 1
        if self._watch is not None:
            self._watch._client_refresh(self)
        return t

    def requeue(self, task: KernelTask):
        """Put a killed in-flight kernel back at the queue head (REEF-style
        reset preemption loses all progress)."""
        assert self.outstanding == 1
        self.outstanding -= 1
        self.kernel_idx -= 1
        b = self.current.batches[self.batch_idx]
        assert b.tasks[self.kernel_idx].kid == task.kid
        if self._watch is not None:
            self._watch._client_refresh(self)

    def undispatched_tasks(self):
        """Queued tasks not yet dispatched, in launch order — the queue
        contents that travel with the client on a migration.  (Completed
        tasks are excluded on purpose: completion records hold those very
        objects, so they must never be mutated.)"""
        if self.current is not None:
            b = self.current.batches[self.batch_idx]
            yield from b.tasks[self.kernel_idx:]
            for nb in self.current.batches[self.batch_idx + 1:]:
                yield from nb.tasks
        for j in self.pending:
            for b in j.batches:
                yield from b.tasks

    def kernel_done(self, now: float) -> bool:
        """Mark the in-flight kernel complete.  Returns True if this
        finished the whole job."""
        self.outstanding -= 1
        assert self.outstanding == 0
        done = False
        b = self.current.batches[self.batch_idx]
        if self.kernel_idx >= len(b.tasks):
            # batch done -> sync event -> next batch
            self.batch_idx += 1
            self.kernel_idx = 0
            if self.batch_idx >= len(self.current.batches):
                self.current.t_finish = now
                self.completed.append(self.current)
                if self._drop_batches:
                    self.current.batches = []
                self.current = None
                done = True
                if self.cbs is not None:
                    # iteration complete: one token per resident request,
                    # exhausted requests leave and their KV is reclaimed
                    # (before the watch refresh — has_work must be current)
                    self.cbs.finish_iteration(now)
                    self.kv_bytes = self.cbs.total_kv_bytes
        if self._watch is not None:
            self._watch._client_refresh(self)
        return done

    # -- metrics -----------------------------------------------------------------

    def latencies(self) -> list[float]:
        return [j.t_finish - j.arrival for j in self.completed]

    def req_latencies(self) -> list[float]:
        """Request-level latencies (arrival -> last token).  Continuous
        tenants only; job latencies() are per-iteration (TBT) there."""
        return list(self.cbs.req_latencies) if self.cbs is not None else []

    def kv_peak_bytes(self) -> float:
        return self.cbs.kv_peak_bytes if self.cbs is not None else 0.0

    def throughput(self, horizon: float) -> float:
        return len(self.completed) / horizon
