"""Training driver: the port's ``train.step.make_train_step`` on batches
of the frozen packing pipeline.

Set-up builds one training state from the benchmark's weights and drives
it through ``checked_steps`` steps of the window's own call and feed, on
rows that all differ: that is the warm-up, and what the check compares.
The program's readings are taken then: each step's loss, each layer
slice's norm of the first gradient as the optimizer got it (its first
moment after one step over ``1 - b1``), and each slice's norm of the
parameters' change after the checked steps.  The same state runs on in
the window: whole steps until ``--seconds`` have passed on the host, then
a synchronize; the rate is the tokens of every step over that time.

After the window the state is freed and the plain reference follows the
checked steps in float32 from the same weights and rows.  Each number is
the worst over steps or layer slices: the loss gap, and for the gradient
and the change the gap of the two norms over the larger of the
reference's norm of that slice and of the median slice.  Slices whose
reference gradient is under a thousandth of the median slice's are left
out of the change (they move by round-off alone).
"""
from __future__ import annotations

import time

import numpy as np

from portbench import reference, traffic, weights

def slices(tree: dict):
    """(name, tensor) of every leaf, a stacked leaf as its layer slices,
    in the sorted order of paths."""
    for path, t in reference.tree_items(tree):
        if path.startswith("blocks/"):
            for g in range(t.shape[0]):
                yield f"{path}[{g}]", t[g]
        else:
            yield path, t


def norms(torch, tree: dict, minus: dict = None, scale: float = 1.0):
    out = {}
    other = dict(slices(minus)) if minus is not None else {}
    for name, t in slices(tree):
        x = t.to(torch.float32)
        if name in other:
            x = x - other[name].to(torch.float32)
        out[name] = float(torch.linalg.vector_norm(x)) * scale
    return out


def gap(prog: dict, ref: dict, keep=None) -> float:
    names = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in names]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in names)


def rate(steps: int, rows: int, seq_len: int, wall_s: float) -> float:
    """Tokens a second: every token of every whole step over the time from
    the first step's start to the synchronize after the last."""
    return steps * rows * seq_len / wall_s


def setup(ctx, torch):
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import transformer
    from repro_torch.train.step import TrainConfig, make_train_step
    ctx.part("imports")
    if ctx.on_card:
        fops._library()
        fops._bwd_library()
    ctx.part("extensions")
    mix, opt = ctx.mix, ctx.mix["optimizer"]
    layout = transformer.init_lm(ctx.cfg, device="meta")
    W = weights.make(layout, ctx.seed, ctx.device)
    ctx.sync()
    ctx.part("weights")
    tc = TrainConfig(remat=mix["remat"], n_micro=mix["n_micro"],
                     lr=opt["lr"], warmup_steps=opt["warmup_steps"],
                     total_steps=opt["total_steps"],
                     weight_decay=opt["weight_decay"],
                     grad_clip=opt["grad_clip"])
    init_state, train_step = make_train_step(ctx.cfg, tc, device=ctx.device)
    if ctx.fault == "half_batch":
        inner = train_step

        def train_step(state, batch):
            half = batch["tokens"].shape[0] // 2
            return inner(state, {k: v[:half] for k, v in batch.items()})
    elif ctx.fault == "unchanged":
        inner = train_step

        def train_step(state, batch):
            return state, inner(state, batch)[1]
    host = traffic.train_batches(mix, ctx.seed, ctx.cfg.vocab_size,
                                 mix["pool"])
    pool = [{k: torch.as_tensor(v, dtype=torch.long, device=ctx.device)
             for k, v in b.items()} for b in host]
    ctx.part("batches")
    state = init_state(params=W)
    losses = []
    for k in range(mix["checked_steps"]):
        state, m = train_step(state, pool[k])
        losses.append(m["loss"])
        if k == 0:
            g1 = norms(torch, state.opt.mu, scale=1.0 / (1.0 - opt["b1"]))
    ctx.sync()
    prog = {"losses": [float(x) for x in losses], "grad": g1,
            "change": norms(torch, state.params, minus=W)}
    del W
    ctx.part("checked_steps")
    return state, train_step, pool, prog


def window(ctx, torch, state, train_step, pool):
    mix = ctx.mix
    first = mix["checked_steps"]
    losses, marks = [], []
    prof = ctx.profiled
    trace_from = mix.get("trace_after_steps", 2)
    trace_n = mix.get("trace_steps", 3)
    t0 = time.perf_counter()
    n = 0
    while True:
        if prof is not None and n == trace_from:
            prof.begin()
        marks.append(ctx.event())
        state, m = train_step(state, pool[(first + n) % len(pool)])
        losses.append(m["loss"])
        n += 1
        if prof is not None and n == trace_from + trace_n:
            prof.end()
        if time.perf_counter() - t0 >= ctx.seconds and (
                prof is None or prof.done):
            break
    marks.append(ctx.event())
    ctx.sync()
    wall = time.perf_counter() - t0
    step_ms = [ctx.elapsed_ms(a, b) for a, b in zip(marks, marks[1:])]
    loss = torch.stack(losses).float().cpu().numpy()
    return state, n, wall, step_ms, loss


def check(ctx, torch, prog: dict):
    mix, opt = ctx.mix, ctx.mix["optimizer"]
    from repro_torch.models import transformer
    layout = transformer.init_lm(ctx.cfg, device="meta")
    W = weights.make(layout, ctx.seed, ctx.device)
    host = traffic.train_batches(mix, ctx.seed, ctx.cfg.vocab_size,
                                 mix["checked_steps"])
    batches = [{k: torch.as_tensor(v, dtype=torch.long, device=ctx.device)
                for k, v in b.items()} for b in host]
    def readings(mode):
        with reference.no_tf32():
            r = reference.train_steps(W, ctx.arch, batches, opt, mode)
        grad = {}
        for name, t in slices(_tree(r["first_grad"])):
            grad[name] = float(torch.linalg.vector_norm(t))
        change = norms(torch, _tree(r["params"]), minus=W)
        return {"losses": r["losses"], "grad": grad, "change": change}

    ref = readings("f32")
    med = float(np.median(list(ref["grad"].values())))
    keep = {k for k, v in ref["grad"].items() if v >= 1e-3 * med}

    def compare(side):
        return {"loss_gap": max(abs(a - b) for a, b in
                                zip(side["losses"], ref["losses"])),
                "grad_norm_gap": gap(side["grad"], ref["grad"]),
                "change_norm_gap": gap(side["change"], ref["change"], keep)}

    checks = compare(prog)
    info = {"program_losses": prog["losses"],
            "reference_losses": ref["losses"],
            "slices": len(ref["grad"]), "change_slices": len(keep)}
    control = compare(readings("fp8")) if ctx.control == "fp8" else {}
    return checks, info, control


def _tree(flat: dict) -> dict:
    out: dict = {}
    for path, t in flat.items():
        reference.tree_set(out, path, t)
    return out


def run(ctx):
    import torch
    state, train_step, pool, prog = setup(ctx, torch)
    setup_s = ctx.setup_done()
    spans = ctx.open_spans(torch)
    if spans is not None:
        spans.training()
    ctx.reset_peak()
    try:
        ctx.smi_start()
        state, steps, wall, step_ms, loss = window(ctx, torch, state,
                                                   train_step, pool)
    finally:
        ctx.smi_stop()
        if spans is not None:
            spans.close()
    peak = ctx.peak()
    mix = ctx.mix
    tokens = steps * mix["rows"] * mix["seq_len"]
    failed = int((~np.isfinite(loss)).sum())
    ctx.emit("window", steps=steps, wall_s=wall, tokens=tokens,
             step_ms={"min": min(step_ms), "median": float(
                 np.median(step_ms)), "max": max(step_ms),
                 "first": step_ms[0], "last": step_ms[-1]},
             loss_first=float(loss[0]), loss_last=float(loss[-1]),
             memory_peak_bytes=peak)
    del state, pool
    ctx.empty_cache()
    checks, info, control = {}, {}, {}
    if ctx.check:
        checks, info, control = check(ctx, torch, prog)
        ctx.emit("check", **info)
    return {"metrics": {"train_tokens_per_s": rate(steps, mix["rows"],
                                                   mix["seq_len"], wall),
                        "setup_s": setup_s},
            "attempted": steps, "failed": failed,
            "memory_peak_bytes": peak, "checks": checks,
            "control": control,
            "records": spans.records if spans is not None else None}
