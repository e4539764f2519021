"""Serving driver: an open loop of requests into the port's
``serve.engine.SlotServer``, each submitted when due and timed from then.

Set-up: the kernels built and loaded, the weights made from the seed, the
server (``max_slots`` x ``max_len`` of cache), one prefill of the mix's
longest and of its shortest prompt and a decode step over every slot.
The window: the mix's requests are due over ``--seconds``; the loop
submits each when due, stamping the due time itself, and steps the server
until every request has finished (at most ``drain_s`` past the close).
TTFT is first token minus due time; ITL every gap between consecutive
output tokens (a token's time is when the step that made it returned),
printed on the window's line.  Each engine step is timed on the host's
clock, with the prefills it admitted, the slots it decoded, the cache's
tokens in use after it and whether the profiler recorded it.

Correctness (after the window, the server freed): a sample of finished
requests drawn from the seed, the one with the most output tokens and the
one with the longest prompt in it, until ``served_tokens`` tokens; the
float32 reference runs over each prompt with its served tokens, and the
widest gap by which a served token's logit lies below the reference's best
is compared with the limit.  ``control="fp8"`` also reads that gap for the
tokens the fp8 reference puts first at the same positions.
"""
from __future__ import annotations

import time

import numpy as np

from portbench import reference, traffic, weights


def _percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def latencies(recs) -> tuple[list, list]:
    """(TTFT ms of every request that got a first token, measured from its
    due time; every gap in ms between consecutive output tokens of every
    request)."""
    ttft = [(r["req"].t_first_token - r["due"]) * 1e3 for r in recs
            if r["req"].t_first_token is not None]
    gaps = [(b - a) * 1e3 for r in recs
            for a, b in zip(r["times"], r["times"][1:])]
    return ttft, gaps


def setup(ctx, torch):
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeConfig, SlotServer
    ctx.part("imports")
    if ctx.on_card:
        dops._library()
        fops._library()
    ctx.part("extensions")
    layout = transformer.init_lm(ctx.cfg, device="meta")
    W = weights.make(layout, ctx.seed, ctx.device)
    ctx.sync()
    ctx.part("weights")
    mix = ctx.mix
    sc = ServeConfig(max_slots=mix["max_slots"], max_len=mix["max_len"],
                     max_new_tokens=mix["output_tokens"]["max"],
                     eos_id=-1, greedy=True)
    server = SlotServer(ctx.cfg, params=W, serve_cfg=sc,
                        clock=time.perf_counter, device=ctx.device)
    reqs = traffic.serve_requests(mix, ctx.seed, ctx.seconds,
                                  ctx.cfg.vocab_size)
    lens = sorted(len(r.prompt) for r in reqs)
    rng = np.random.default_rng(0)
    for n in {lens[-1], lens[0]}:
        server.submit(rng.integers(2, ctx.cfg.vocab_size, size=n), 2)
    server.run_until_drained()
    # a decode step over every slot at once
    for _ in range(sc.max_slots):
        server.submit(rng.integers(2, ctx.cfg.vocab_size, size=lens[0]), 2)
    server.run_until_drained()
    ctx.sync()
    server.done.clear()
    ctx.part("warmup")
    return W, server, reqs


def window(ctx, torch, server, reqs):
    """Drive the open loop; returns per-request and per-step records."""
    drain = ctx.mix.get("drain_s", 60.0)
    live, recs, steps = [], [], []
    i, n = 0, len(reqs)
    t0 = time.perf_counter()
    max_queue = 0
    while True:
        now = time.perf_counter()
        while i < n and t0 + reqs[i].due_s <= now:
            r = server.submit(reqs[i].prompt, reqs[i].max_new)
            rec = {"req": r, "due": t0 + reqs[i].due_s, "late": now - (
                t0 + reqs[i].due_s), "times": [], "P": len(reqs[i].prompt)}
            live.append(rec)
            recs.append(rec)
            i += 1
        if ctx.profiled is not None:
            ctx.profiled.tick(now - t0)
        max_queue = max(max_queue, len(server.queue))
        if server.queue or server.active.any():
            queued = len(server.queue)
            traced = ctx.profiled is not None and ctx.profiled.open
            s0 = time.perf_counter()
            decoded = server.step()
            t = time.perf_counter()
            steps.append({"at_s": s0 - t0, "wall_s": t - s0,
                          "prefills": queued - len(server.queue),
                          "decoded": decoded, "traced": traced,
                          "kv_tokens": int(server.pos[server.active].sum())})
            keep = []
            for rec in live:
                r = rec["req"]
                for j in range(len(rec["times"]), len(r.output)):
                    rec["times"].append(r.t_first_token if j == 0 else t)
                if r.t_finish is None:
                    keep.append(rec)
            live = keep
        elif i >= n:
            break
        else:
            time.sleep(max(0.0, min(t0 + reqs[i].due_s - now, 0.002)))
        if now - t0 > ctx.seconds + drain:
            break
    ctx.sync()
    if ctx.profiled is not None:
        ctx.profiled.end()
    return recs, steps, time.perf_counter() - t0, max_queue


def check(ctx, torch, W, recs, served_tokens: int):
    """(numbers compared, control readings) of the finished requests."""
    done = [r for r in recs if r["req"].t_finish is not None
            and len(r["req"].output) > 0]
    rng = np.random.default_rng([ctx.seed, 7])
    pick = {max(range(len(done)), key=lambda k: len(done[k]["req"].output)),
            max(range(len(done)), key=lambda k: done[k]["P"])}
    for k in rng.permutation(len(done)):
        if sum(len(done[j]["req"].output) for j in pick) >= served_tokens:
            break
        pick.add(int(k))
    seqs, firsts, outs = [], [], []
    for k in sorted(pick):
        r = done[k]["req"]
        out = np.asarray(r.output, np.int64)
        toks = np.concatenate([r.tokens.astype(np.int64), out[:-1]])
        seqs.append(torch.as_tensor(toks, device=ctx.device))
        firsts.append(len(r.tokens) - 1)
        outs.append(torch.as_tensor(out, device=ctx.device))
    with reference.no_tf32():
        ref = reference.served_logits(W, ctx.arch, seqs, firsts, "f32")
    gaps = [(lg.max(-1).values - lg.gather(-1, o[:, None])[:, 0])
            for lg, o in zip(ref, outs)]
    gap = float(torch.cat(gaps).max())
    agree = float(torch.cat([(lg.argmax(-1) == o).float()
                             for lg, o in zip(ref, outs)]).mean())
    checks = {"max_logit_gap": gap}
    info = {"checked_requests": len(seqs),
            "checked_tokens": int(sum(len(o) for o in outs)),
            "argmax_agreement": agree}
    control = {}
    if ctx.control == "fp8":
        with reference.no_tf32():
            low = reference.served_logits(W, ctx.arch, seqs, firsts, "fp8")
        cg = [(lg.max(-1).values - lg.gather(-1, c.argmax(-1)[:, None])[:, 0])
              for lg, c in zip(ref, low)]
        control["max_logit_gap"] = float(torch.cat(cg).max())
    return checks, info, control


def step_stats(steps, seconds: float) -> dict:
    """The engine's steps in brief: the mean wall ms of a step that only
    decoded, traced and not; the slots decoding and the cache's tokens in
    use, weighted by time over the steps begun in the window."""
    def mean_ms(traced):
        w = [s["wall_s"] for s in steps if s["prefills"] == 0
             and s["decoded"] > 0 and s["traced"] == traced]
        return 1e3 * sum(w) / len(w) if w else None
    inside = [s for s in steps if s["at_s"] < seconds]
    wall = sum(s["wall_s"] for s in inside) or 1.0
    return {"steps": len(steps),
            "decode_only_ms": {"untraced": mean_ms(False),
                               "traced": mean_ms(True)},
            "active_slots_mean": sum(s["decoded"] * s["wall_s"]
                                     for s in inside) / wall,
            "kv_tokens_mean": sum(s["kv_tokens"] * s["wall_s"]
                                  for s in inside) / wall,
            "kv_tokens_max": max((s["kv_tokens"] for s in inside),
                                 default=0)}


def run(ctx):
    import torch
    if ctx.fault:
        raise ValueError("serving plants no fault of its own; the tests "
                         "plant them under the port")
    W, server, reqs = setup(ctx, torch)
    setup_s = ctx.setup_done()
    spans = ctx.open_spans(torch)
    if spans is not None:
        spans.serving(server)
    ctx.reset_peak()
    try:
        ctx.smi_start()
        recs, steps, wall, max_queue = window(ctx, torch, server, reqs)
    finally:
        ctx.smi_stop()
        if spans is not None:
            spans.close()
    peak = ctx.peak()
    ttft, gaps = latencies(recs)
    failed = sum(1 for r in recs if r["req"].t_finish is None)
    late = [r["late"] * 1e3 for r in recs]
    ctx.emit("window", requests=len(recs), finished=len(recs) - failed,
             engine=step_stats(steps, ctx.seconds),
             kv_pool_tokens=ctx.mix["max_slots"] * ctx.mix["max_len"],
             wall_s=wall, max_queue=max_queue,
             rate_per_s=ctx.mix["rate_per_s"],
             generator_late_ms={"median": _percentile(late, 50),
                                "p95": _percentile(late, 95),
                                "max": max(late)},
             ttft_ms={"p50": _percentile(ttft, 50),
                      "p95": _percentile(ttft, 95), "max": max(ttft)},
             itl_ms={"p50": _percentile(gaps, 50),
                     "p95": _percentile(gaps, 95), "max": max(gaps)},
             output_tokens=sum(len(r["req"].output) for r in recs),
             memory_peak_bytes=peak)
    del server
    ctx.empty_cache()
    checks, info, control = {}, {}, {}
    if ctx.check:
        checks, info, control = check(ctx, torch, W, recs,
                                      ctx.mix["served_tokens"])
        ctx.emit("check", **info)
    return {"metrics": {"ttft_p95_ms": _percentile(ttft, 95),
                        "setup_s": setup_s},
            "attempted": len(recs), "failed": failed,
            "memory_peak_bytes": peak, "checks": checks,
            "control": control, "host": {"engine_steps": steps},
            "records": spans.records if spans is not None else None}
