"""The port's spans (``repro_torch.spans``) in the serving engine and the
trainer: nothing while no profiler records; under one, every span in the
profiler's trace and in the ring, nested and tied to its request, with the
served tokens and the trained state as without it."""
import dataclasses
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.configs.registry import get_config
from repro_torch.models.common import tree_leaves
from repro_torch.serve import ServeConfig, SlotServer
from repro_torch.train.step import TrainConfig, make_train_step

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from portbench import tracing  # noqa: E402

ENGINE = ("engine.step", "engine.queue", "engine.admit", "engine.prefill",
          "engine.decode", "engine.readback", "engine.bookkeep")
TRAIN = ("train.forward", "train.backward", "train.optimizer")


def _cfg():
    return dataclasses.replace(get_config("olmo-1b").reduced(),
                               dtype="float32")


def _serve(cfg, params=None, slots=2, n=3, clock=None):
    srv = SlotServer(cfg, params=params, serve_cfg=ServeConfig(
        max_slots=slots, max_len=32, max_new_tokens=3), device="cpu",
        clock=clock)
    rng = np.random.default_rng(0)
    reqs = [srv.submit(rng.integers(2, 200, 6 + i)) for i in range(n)]
    srv.run_until_drained()
    return srv, reqs


def _train(cfg, n_micro=2, seed=0):
    init, step = make_train_step(cfg, TrainConfig(n_micro=n_micro),
                                 device="cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(2, 200, (4, 16), generator=g)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    state, m = step(init(seed=seed), batch)
    return state, m, batch


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.fixture(autouse=True)
def _empty_ring():
    spans.clear()
    yield
    spans.clear()


def test_without_a_profiler_no_range_opens_and_nothing_is_kept(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a span opened a range with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    cfg = _cfg()
    srv, reqs = _serve(cfg)
    assert all(len(r.output) == 3 for r in reqs)
    assert all(r.t_submit_ns > 0 for r in reqs)
    _train(cfg)
    assert spans.records() == []


def test_every_span_is_a_user_annotation_of_the_trace(tmp_path):
    cfg = _cfg()

    def work():
        _serve(cfg)
        _train(cfg)

    _, prof = _profiled(work)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(ENGINE + TRAIN) <= names
    assert {r["name"] for r in spans.records()} == set(ENGINE + TRAIN)
    # the benchmark's reading of a trace keeps its own ``pb.`` ranges only
    trace = tracing.read_trace(path)
    assert trace.ranges == {} and trace.markers == {}


def test_engine_spans_nest_inside_the_step():
    _profiled(lambda: _serve(_cfg()))
    recs = spans.records()
    steps = {r["id"] for r in recs if r["name"] == "engine.step"}
    for name in ("engine.admit", "engine.decode", "engine.readback",
                 "engine.bookkeep"):
        inner = [r for r in recs if r["name"] == name]
        assert inner and all(r["parent"] in steps for r in inner), name
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        if r["name"] in ("engine.prefill", "engine.queue"):
            assert by_id[r["parent"]]["name"] == "engine.admit"
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["t0_ns"] <= r["t1_ns"] <= p["t1_ns"]
    decode = [r for r in recs if r["name"] == "engine.decode"]
    assert all(r["attrs"]["rows"] >= 1 and r["attrs"]["kv_tokens"] > 0
               for r in decode)
    emitted = sum(r["attrs"]["tokens"] for r in recs
                  if r["name"] == "engine.bookkeep")
    assert emitted == 3 * 2       # three requests, two decoded tokens each


def test_queue_wait_runs_from_submit_to_prefill_on_one_slot():
    (srv, reqs), _ = _profiled(lambda: _serve(
        _cfg(), slots=1, n=2, clock=time.perf_counter_ns))
    recs = spans.records()
    first, second = reqs
    q = [r for r in recs if r["name"] == "engine.queue"
         and r["rid"] == second.rid]
    p = [r for r in recs if r["name"] == "engine.prefill"
         and r["rid"] == second.rid]
    assert len(q) == len(p) == 1
    q, p = q[0], p[0]
    assert q["t0_ns"] == second.t_submit_ns
    assert first.t_finish <= q["t1_ns"] <= p["t0_ns"]
    assert p["t0_ns"] - q["t1_ns"] < 5_000_000
    assert q["attrs"]["ahead"] == 1
    assert p["attrs"]["tokens"] == len(second.tokens) and p["attrs"][
        "slot"] == 0


def test_microbatches_give_a_forward_and_backward_each():
    (_, _, batch), _ = _profiled(lambda: _train(_cfg(), n_micro=2))
    recs = spans.records()
    fwd = [r for r in recs if r["name"] == "train.forward"]
    bwd = [r for r in recs if r["name"] == "train.backward"]
    opt = [r for r in recs if r["name"] == "train.optimizer"]
    assert (len(fwd), len(bwd), len(opt)) == (2, 2, 1)
    for side in (fwd, bwd):
        assert [r["attrs"]["micro"] for r in side] == [0, 1]
        assert sum(r["attrs"]["tokens"] for r in side) == \
            batch["labels"].numel()
        assert all(r["device_ms"] is None for r in side)     # off the card
    assert fwd[0]["t1_ns"] <= bwd[0]["t0_ns"] <= bwd[0]["t1_ns"] \
        <= fwd[1]["t0_ns"] <= bwd[1]["t1_ns"] <= opt[0]["t0_ns"]
    assert opt[0]["attrs"]["params"] > 0


def test_trained_state_is_bit_identical_with_spans_on_and_off():
    cfg = _cfg()
    off, m_off, _ = _train(cfg)
    (on, m_on, _), _ = _profiled(lambda: _train(cfg))
    assert len(spans.records()) == 5
    assert torch.equal(m_off["loss"], m_on["loss"])
    for a, b in zip(tree_leaves(off.params) + tree_leaves(off.opt.mu),
                    tree_leaves(on.params) + tree_leaves(on.opt.mu)):
        assert torch.equal(a, b)


def test_the_ring_drops_the_oldest_records_past_its_capacity():
    extra = 5

    def work():
        for i in range(spans.CAPACITY + extra):
            spans.record("engine.queue", 0, rid=i)

    _profiled(work)
    recs = spans.records()
    assert len(recs) == spans.CAPACITY
    assert [r["rid"] for r in recs[:2]] == [extra, extra + 1]
    assert recs[-1]["rid"] == spans.CAPACITY + extra - 1
    spans.clear()
    assert spans.records() == []


@pytest.mark.gpu
def test_train_spans_time_the_forward_and_backward_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: device time comes from CUDA events")
    # head_dim 64: one the attention backward takes on the card
    cfg = dataclasses.replace(get_config("olmo-1b").reduced(), d_head=64,
                              dtype="bfloat16")
    init, step = make_train_step(cfg, TrainConfig(n_micro=2), device="cuda")
    state = init(seed=0)
    toks = torch.randint(2, 200, (4, 256), device="cuda")
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    step(state, batch)                                     # warm-up
    torch.cuda.synchronize()
    spans.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        step(state, batch)
    recs = spans.records()
    for name in TRAIN:
        got = [r["device_ms"] for r in recs if r["name"] == name]
        assert got and all(ms > 0 for ms in got), (name, got)
