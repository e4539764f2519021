"""The slice as a whole: the port's serving engine against the JAX package's.

Same converted float32 parameters, same prompts (numpy, seeded) -> the two
``SlotServer``s must emit IDENTICAL greedy token lists.  Float32 on both
sides keeps the argmax free of rounding ties; no tolerance is involved.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import make_pair
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import SlotServer as JaxSlotServer
from repro_torch import spans
from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import serve
from repro_torch.models.common import tree_paths
from repro_torch.models.registry import init_model
from repro_torch.serve import Request, ServeConfig, SlotServer


def _prompts(seed=0, n=5, lo=4, hi=16):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 200, int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def _drain(server, prompts, max_new):
    for p in prompts:
        server.submit(p, max_new_tokens=max_new)
    return [r.output for r in sorted(server.run_until_drained(),
                                     key=lambda r: r.rid)]


@pytest.mark.parametrize("arch", ["llama3-8b", "olmo-1b"])
def test_greedy_tokens_identical_to_jax_slotserver(arch):
    jcfg, jparams, tcfg, tparams = make_pair(arch)
    prompts = _prompts()
    kw = dict(max_slots=3, max_len=48, max_new_tokens=6)
    jax_out = _drain(JaxSlotServer(jcfg, jparams, serve_cfg=JaxServeConfig(**kw)),
                     prompts, 6)
    port_out = _drain(SlotServer(tcfg, tparams, serve_cfg=ServeConfig(**kw),
                                 device="cpu"), prompts, 6)
    assert port_out == jax_out
    assert all(len(o) == 6 or o[-1] == 1 for o in port_out)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "grok-1-314b",
                                  "recurrentgemma-9b", "xlstm-1.3b"])
def test_greedy_tokens_identical_for_moe_and_hybrid(arch):
    """MoE, hybrid and recurrent decoders: five requests on two slots, so
    slots are reused (the recurrent states of a reused slot start afresh),
    prompts past the reduced window of 32 (the ring buffer wraps at
    prefill and again while decoding), and a cut at max_len - 1."""
    jcfg, jparams, tcfg, tparams = make_pair(arch)
    prompts = [p for p in _prompts(seed=3, n=3, lo=4, hi=16)]
    prompts += [np.arange(2, 42, dtype=np.int32) % 200 + 2,
                np.arange(7, 60, dtype=np.int32)]
    kw = dict(max_slots=2, max_len=48, max_new_tokens=8)
    jax_out = _drain(JaxSlotServer(jcfg, jparams,
                                   serve_cfg=JaxServeConfig(**kw)), prompts, 8)
    port_out = _drain(SlotServer(tcfg, tparams, serve_cfg=ServeConfig(**kw),
                                 device="cpu"), prompts, 8)
    assert port_out == jax_out
    assert len(port_out) == 5 and any(len(o) < 8 for o in port_out)


@pytest.mark.parametrize("traced", [False, True], ids=["spans_off",
                                                      "spans_on"])
def test_greedy_tokens_identical_with_truncation_and_length_limit(traced):
    """A prompt longer than max_len-1 is cut to its tail, and a request that
    reaches max_len-1 finishes early, in both engines alike; the port's
    tokens are the same with its spans recording (under a profiler)."""
    jcfg, jparams, tcfg, tparams = make_pair("llama3-8b", seed=1)
    prompts = _prompts(seed=2, n=4, lo=20, hi=40)
    kw = dict(max_slots=2, max_len=24, max_new_tokens=8)
    jax_out = _drain(JaxSlotServer(jcfg, jparams, serve_cfg=JaxServeConfig(**kw)),
                     prompts, 8)
    spans.clear()
    with (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) if traced
          else contextlib.nullcontext()):
        port_out = _drain(SlotServer(tcfg, tparams,
                                     serve_cfg=ServeConfig(**kw),
                                     device="cpu"), prompts, 8)
    assert port_out == jax_out
    assert any(len(o) < 8 for o in port_out)
    assert (len(spans.records()) > 0) == traced
    spans.clear()


def test_slotserver_matches_sequential_decode():
    """Continuous batching must produce the same tokens as serving each
    request alone (greedy decoding, same params)."""
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), dtype="float32")
    sc = ServeConfig(max_slots=3, max_len=48, max_new_tokens=6)
    srv = SlotServer(cfg, serve_cfg=sc, seed=0, device="cpu")
    prompts = _prompts()
    for p in prompts:
        srv.submit(p, max_new_tokens=6)
    done = sorted(srv.run_until_drained(), key=lambda r: r.rid)
    for i, p in enumerate(prompts):
        solo = SlotServer(cfg, params=srv.params, serve_cfg=sc, device="cpu")
        solo.submit(p, max_new_tokens=6)
        ref = solo.run_until_drained()[0]
        assert done[i].output == ref.output, i


def test_slotserver_slot_reuse_under_load():
    cfg = get_config("olmo-1b").reduced()
    srv = SlotServer(cfg, serve_cfg=ServeConfig(max_slots=2, max_len=32,
                                                max_new_tokens=4),
                     device="cpu")
    for i in range(7):
        srv.submit(np.arange(2, 8, dtype=np.int32), max_new_tokens=3)
    done = srv.run_until_drained()
    assert len(done) == 7
    assert len({tuple(r.output) for r in done}) == 1     # same prompt, same out


def test_reused_slot_keeps_stale_entries_beyond_the_prompt_harmlessly():
    """The port prefills straight into the slot's stripe and does not zero
    what a longer earlier request left beyond the new prompt; those entries
    are masked by the per-slot lengths, so a short request after a long one
    decodes as it does on a fresh server."""
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), dtype="float32")
    sc = ServeConfig(max_slots=1, max_len=40, max_new_tokens=5)
    long_p, short_p = np.arange(2, 32, dtype=np.int32), np.arange(5, 11, dtype=np.int32)
    srv = SlotServer(cfg, serve_cfg=sc, seed=0, device="cpu")
    srv.submit(long_p)
    srv.submit(short_p)
    both = sorted(srv.run_until_drained(), key=lambda r: r.rid)
    k = srv.caches["groups"]["0"]["k"]
    assert k[:, 0, 20:30].abs().sum() > 0                # stale, never zeroed
    fresh = SlotServer(cfg, params=srv.params, serve_cfg=sc, device="cpu")
    fresh.submit(short_p)
    assert both[1].output == fresh.run_until_drained()[0].output


def test_max_slots_one_works():
    """The reference finds the slot axis as the first axis whose size differs
    and fails with one slot; the port knows the axis."""
    jcfg, jparams, tcfg, tparams = make_pair("olmo-1b")
    prompts = _prompts(n=3)
    one = _drain(SlotServer(tcfg, tparams, device="cpu", serve_cfg=ServeConfig(
        max_slots=1, max_len=32, max_new_tokens=4)), prompts, 4)
    three = _drain(SlotServer(tcfg, tparams, device="cpu", serve_cfg=ServeConfig(
        max_slots=3, max_len=32, max_new_tokens=4)), prompts, 4)
    assert one == three and all(len(o) >= 1 for o in one)
    with pytest.raises((StopIteration, RuntimeError)):
        _drain(JaxSlotServer(jcfg, jparams, serve_cfg=JaxServeConfig(
            max_slots=1, max_len=32, max_new_tokens=4)), prompts[:1], 4)


def test_finish_conditions_eos_budget_and_length():
    cfg = dataclasses.replace(get_config("olmo-1b").reduced(), dtype="float32")
    params = init_model(cfg, seed=0, device="cpu")
    prompt = np.arange(2, 10, dtype=np.int32)
    probe = SlotServer(cfg, params, device="cpu", serve_cfg=ServeConfig(
        max_slots=1, max_len=64, max_new_tokens=6))
    out = _drain(probe, [prompt], 6)[0]
    assert len(out) == 6                                     # budget
    # make the third emitted token the EOS id: the request stops there
    eos = SlotServer(cfg, params, device="cpu", serve_cfg=ServeConfig(
        max_slots=1, max_len=64, max_new_tokens=6, eos_id=out[2]))
    got = _drain(eos, [prompt], 6)[0]
    assert got == out[:out.index(out[2]) + 1]
    # the cache's length ends a request: pos reaches max_len - 1
    short = SlotServer(cfg, params, device="cpu", serve_cfg=ServeConfig(
        max_slots=1, max_len=12, max_new_tokens=50, eos_id=-1))
    got = _drain(short, [prompt], 50)[0]
    assert len(got) == 1 + (12 - 1 - len(prompt))
    # per-request budget of one token finishes at admission
    srv = SlotServer(cfg, params, device="cpu")
    r = srv.submit(prompt, max_new_tokens=1)
    srv.run_until_drained()
    assert len(r.output) == 1 and r.t_finish is not None and not srv.active.any()


def test_clock_and_latencies():
    cfg = get_config("olmo-1b").reduced()
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    srv = SlotServer(cfg, device="cpu", clock=clock,
                     serve_cfg=ServeConfig(max_slots=2, max_len=32,
                                           max_new_tokens=3))
    reqs = [srv.submit(np.arange(2, 6, dtype=np.int32)) for _ in range(3)]
    assert isinstance(reqs[0], Request) and [r.rid for r in reqs] == [0, 1, 2]
    srv.run_until_drained()
    lats = srv.latencies()
    assert len(lats) == 3 and all(x > 0 for x in lats)
    assert all(r.arrival < r.t_first_token <= r.t_finish for r in reqs)


# -- ports of tests/test_serve_config.py ------------------------------------

def test_slotserver_default_config_not_shared():
    cfg = get_config("olmo-1b").reduced()
    s1 = SlotServer(cfg, device="cpu")
    s1.sc.max_new_tokens = 99
    s1.sc.max_slots = 1
    s2 = SlotServer(cfg, device="cpu")
    assert s2.sc.max_new_tokens == ServeConfig().max_new_tokens
    assert s2.sc.max_slots == ServeConfig().max_slots
    assert s1.sc is not s2.sc


def test_slotserver_explicit_config_still_honored():
    cfg = get_config("olmo-1b").reduced()
    sc = ServeConfig(max_slots=2, max_len=64, max_new_tokens=4)
    srv = SlotServer(cfg, serve_cfg=sc, device="cpu")
    assert srv.sc is sc
    srv.submit(np.arange(2, 10, dtype=np.int32))
    done = srv.run_until_drained()
    assert len(done) == 1 and len(done[0].output) <= 4


def test_serve_config_defaults_match_reference():
    assert dataclasses.asdict(ServeConfig()) == dataclasses.asdict(JaxServeConfig())


# -- launch.serve ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmo-1b", "llama3-8b", "qwen1.5-32b",
                                  "nemotron-4-340b"])
def test_launch_serve_drains_on_cpu(arch, capsys):
    cfg = get_config(arch).reduced()
    done, lats = serve(cfg, n_requests=5, max_slots=2, max_len=32, max_new=4,
                       seed=1, device="cpu")
    assert len(done) == 5 and len(lats) == 5
    assert all(1 <= len(r.output) <= 4 for r in done)
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.output)
    assert "[serve] 5 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "recurrentgemma-9b",
                                  "xlstm-1.3b"])
def test_launch_serve_drains_moe_and_hybrid_on_cpu(arch, capsys):
    cfg = get_config(arch).reduced()
    done, lats = serve(cfg, n_requests=4, max_slots=2, max_len=80, max_new=4,
                       seed=1, device="cpu")
    assert len(done) == 4 and len(lats) == 4
    assert all(1 <= len(r.output) <= 4 for r in done)
    assert "[serve] 4 requests" in capsys.readouterr().out


def test_launch_serve_is_seeded_and_takes_params():
    cfg = get_config("llama3-8b").reduced()
    a, _ = serve(cfg, n_requests=3, max_len=32, max_new=3, seed=5,
                 device="cpu", verbose=False)
    b, _ = serve(cfg, n_requests=3, max_len=32, max_new=3, seed=5,
                 device="cpu", verbose=False)
    assert [r.output for r in a] == [r.output for r in b]
    params = init_model(cfg, seed=5, device="cpu")
    c, _ = serve(cfg, n_requests=3, max_len=32, max_new=3, seed=5,
                 device="cpu", verbose=False, params=params)
    assert [r.output for r in c] == [r.output for r in a]
    assert all(x.device.type == "cpu" for _, x in tree_paths(params))
