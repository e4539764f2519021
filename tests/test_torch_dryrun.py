"""The port's dry-run against the JAX package's, on the CPU.

* ``roofline/comm.py``'s ring accounting equals ``repro.roofline.hlo``'s
  on the same five collectives (kinds, sizes, group sizes).
* ``roofline/cost.py``'s counter on one rank (a step on ``meta``
  tensors) against ``repro.roofline.hlo_cost``'s walk of the reference's
  compiled step, for reduced olmo-1b and qwen2-moe-a2.7b train steps and
  llama3-8b prefill and decode.  Two differences are the port's own work
  and are taken out of its matrix-product FLOPs before they are held to
  2 %: the attention backward kernel recomputes the scores and dP of every
  visited block (14·D FLOPs a score element against the 8·D of XLA's
  backward), and the loss recomputes each chunk's logits in the backward
  (XLA folds that recomputation into the forward's product).  Total FLOPs
  are held to 10 %; of a decode step's, the reference's copies,
  broadcasts and transposes of the caches around its functional update
  are taken out first (the port updates them in place).
* A fake-process-group dry-run of a reduced train cell on a (4, 2) mesh,
  in a subprocess (one process holds one default group): it completes,
  writes the reference's keys, records collectives, and its per-device
  matrix-product FLOPs times 8 are the one-rank count's, to 2 %.
* The kernels' ``meta`` route charges its formula under a counter and
  still raises outside one.
* ``roofline/report.py`` prints the reference's table and summary for the
  same two cells.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JaxShape
from repro.configs.registry import get_config as jax_get_config
from repro.data.pipeline import make_batch_specs as jax_batch_specs
from repro.models import registry as jax_registry
from repro.models import transformer as jax_tf
from repro.roofline import hlo as jax_hlo
from repro.roofline import hlo_cost
from repro.roofline import report as jax_report
from repro.train.step import TrainConfig as JaxTrainConfig
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bwd)
from repro_torch.models import registry, transformer
from repro_torch.roofline import comm, cost, report
from repro_torch.train.step import TrainConfig, make_train_step

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

HLO = textwrap.dedent("""
  %ag = bf16[16,1024]{1,0} all-gather(bf16[1,1024]{1,0} %a), replica_groups=[16,16]<=[256], dimensions={0}
  %rs = f32[64,32]{1,0} reduce-scatter(f32[256,32]{1,0} %b), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = f32[2048]{0} all-reduce(f32[2048]{0} %c), replica_groups=[32,8]<=[256], to_apply=%sum
  %aa = bf16[8,512,64]{2,1,0} all-to-all(bf16[8,512,64]{2,1,0} %d), replica_groups={{0,1}}, dimensions={0}
  %cp = f32[128,128]{1,0} collective-permute(f32[128,128]{1,0} %e), source_target_pairs={{0,1},{1,0}}
""")
# the same five: (kind, result bytes, group size)
OPS = [("all-gather", 16 * 1024 * 2, 16), ("reduce-scatter", 64 * 32 * 4, 4),
       ("all-reduce", 2048 * 4, 8), ("all-to-all", 8 * 512 * 64 * 2, 2),
       ("collective-permute", 128 * 128 * 4, 2)]


def test_ring_accounting_is_the_references():
    want = jax_hlo.collective_bytes(HLO)
    ops = [comm.collective_op(*o) for o in OPS]
    assert comm.collective_bytes(ops) == want
    parsed = jax_hlo.parse_collectives(HLO)
    assert [(p.kind, p.result_bytes, p.group_size) for p in parsed] == [
        (k, float(b), g) for k, b, g in OPS[:4]] + [
        ("collective-permute", float(OPS[4][1]), 2)]
    counts = comm.count_ops(ops, dots=3, kernels=2)
    ref = jax_hlo.count_ops(HLO)
    assert {k: counts[k] for k in comm.COLLECTIVE_KINDS} == {
        k: ref[k] for k in comm.COLLECTIVE_KINDS}
    assert (counts["dot"], counts["kernel"]) == (3, 2)


# ---------------------------------------------------------------------------
# FLOPs on one rank against hlo_cost
# ---------------------------------------------------------------------------

class _DotCost(hlo_cost.HloCostModel):
    """hlo_cost's walk with every FLOP but a ``dot``'s dropped."""

    def _local_cost(self, comp, ins, top_level):
        c = super()._local_cost(comp, ins, top_level)
        if c is not None and ins.op not in ("dot", "fusion"):
            c.flops = 0.0
        return c


def _cfgs(arch):
    return (dataclasses.replace(jax_get_config(arch).reduced(),
                                dtype="float32"),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32"))


class _MoveCost(hlo_cost.HloCostModel):
    """hlo_cost's walk, FLOPs of ``copy``, ``broadcast`` and ``transpose``
    only: XLA's moves of whole caches around a functional decode update,
    which the port's in-place update does not make."""

    def _local_cost(self, comp, ins, top_level):
        c = super()._local_cost(comp, ins, top_level)
        if c is not None and ins.op not in ("copy", "broadcast",
                                            "transpose", "fusion"):
            c.flops = 0.0
        return c


def _reference(kind, jcfg, B, S):
    """(dot FLOPs, FLOPs, data-movement FLOPs of a decode step) of the
    reference's compiled step, by hlo_cost."""
    key = jax.random.PRNGKey(0)
    if kind == "train":
        init, step = jax_make_train_step(jcfg, JaxTrainConfig())
        args = (jax.eval_shape(init, key),
                jax_batch_specs(jcfg, JaxShape("t", S, B, "train")))
        fn = step
    else:
        params = jax.eval_shape(lambda k: jax_registry.init_model(jcfg, k),
                                key)
        if kind == "prefill":
            batch = jax_batch_specs(jcfg, JaxShape("p", S, B, "prefill"))
            batch.pop("labels")
            args = (params, batch)

            def fn(p, b):
                return jax_registry.serve_prefill(p, jcfg, b, max_len=S)
        else:
            caches = jax.eval_shape(lambda: jax_tf.init_caches(jcfg, B, S))
            tok = jax.ShapeDtypeStruct((B,), np.int32)
            pos = jax.ShapeDtypeStruct((), np.int32)
            args = (params, tok, pos, caches)

            def fn(p, t, q, c):
                return jax_registry.serve_decode(p, jcfg, t, q, c)
    hlo = jax.jit(fn).lower(*args).compile().as_text()
    moves = _MoveCost(hlo).total().flops if kind == "decode" else 0.0
    return (_DotCost(hlo).total().flops, hlo_cost.analyze(hlo).flops,
            moves)


def _port(kind, tcfg, B, S):
    """The counter of the port's step on ``meta`` tensors, one rank."""
    if kind == "train":
        init, step = make_train_step(tcfg, TrainConfig(), device="meta")
        state = init(seed=0)
        batch = make_batch_specs(tcfg, ShapeConfig("t", S, B, "train"),
                                 dtype=torch.int64)
        run = lambda: step(state, batch)                        # noqa: E731
    else:
        params = registry.init_model(tcfg, device="meta")
        if kind == "prefill":
            tok = torch.empty((B, S), dtype=torch.int64, device="meta")
            run = lambda: registry.serve_prefill(               # noqa: E731
                params, tcfg, {"tokens": tok}, max_len=S)
        else:
            caches = transformer.init_caches(tcfg, B, S, device="meta")
            tok = torch.empty((B,), dtype=torch.int64, device="meta")
            run = lambda: registry.serve_decode(                # noqa: E731
                params, tcfg, tok, S - 1, caches)
    with cost.CostCounter() as c:
        run()
    return c


def _own_work(kind, tcfg, c, B, S) -> float:
    """The port's matrix-product FLOPs that the reference's compiled step
    does not have (see the module's docstring)."""
    if kind != "train":
        return 0.0
    D, Hq = tcfg.head_dim, tcfg.n_heads
    scores = B * Hq * cost.attention_blocks(S, S, causal=True, window=0)
    attn = c.kernels["flash_attention_bwd"] * (
        cost.BWD_DOT_FLOPS_PER_D - 8) * D * scores
    head = 2.0 * B * S * tcfg.d_model * tcfg.vocab_size
    return attn + head


CELLS = [("olmo-1b", "train", 4, 64), ("qwen2-moe-a2.7b", "train", 4, 64),
         ("llama3-8b", "prefill", 2, 128), ("llama3-8b", "decode", 4, 256)]


@pytest.mark.parametrize("arch,kind,B,S", CELLS,
                         ids=[f"{a}-{k}" for a, k, _, _ in CELLS])
def test_counter_flops_match_hlo_cost_on_one_rank(arch, kind, B, S):
    jcfg, tcfg = _cfgs(arch)
    ref_dots, ref_flops, ref_moves = _reference(kind, jcfg, B, S)
    c = _port(kind, tcfg, B, S)
    dots = c.dot_flops - _own_work(kind, tcfg, c, B, S)
    print(f"{arch} {kind}: dot FLOPs / reference {c.dot_flops / ref_dots:.4f}"
          f" ({dots / ref_dots:.4f} without the port's own work), FLOPs / "
          f"reference {c.flops / ref_flops:.4f} "
          f"({c.flops / (ref_flops - ref_moves):.4f} without its moves)")
    assert dots == pytest.approx(ref_dots, rel=0.02)
    assert c.flops == pytest.approx(ref_flops - ref_moves, rel=0.10)
    want_kernel = {"train": "flash_attention_bwd", "prefill":
                   "flash_attention", "decode": "decode_attention"}[kind]
    assert c.kernels[want_kernel] == transformer.attention_layers(tcfg)


# ---------------------------------------------------------------------------
# a fake group of 8 ranks
# ---------------------------------------------------------------------------

MESH_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(get_config("olmo-1b").reduced(),
                              dtype="bfloat16")
    res = dryrun.run_cell("olmo-1b", "train_4k", cfg=cfg,
                          shape=ShapeConfig("train_4k", 64, 8, "train"),
                          mesh_name="d4m2")
    print(json.dumps(res))
""")


def test_fake_group_dry_run_shards_the_step_over_8_ranks():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", MESH_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["status"] == "ok" and res["chips"] == 8
    assert set(res) >= {"arch", "shape", "mesh", "status", "chips", "kind",
                        "t_lower_s", "t_compile_s", "memory", "cost",
                        "collectives", "hlo_ops", "roofline", "param_count",
                        "active_param_count"}
    assert res["t_compile_s"] is None
    assert set(res["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "code_bytes"}
    assert res["collectives"]["all-reduce"] > 0
    assert res["collectives"]["total"] == pytest.approx(
        sum(v for k, v in res["collectives"].items() if k != "total"))
    assert res["hlo_ops"]["dot"] > 0
    # the same step on one rank: every product's dims divide the mesh
    tcfg = dataclasses.replace(get_config("olmo-1b").reduced(),
                               dtype="bfloat16")
    init, step = make_train_step(tcfg, TrainConfig(remat="dots",
                                                   loss_chunk=512),
                                 device="meta")
    state = init(seed=0)
    batch = make_batch_specs(tcfg, ShapeConfig("t", 64, 8, "train"),
                             dtype=torch.int64)
    with cost.CostCounter() as c:
        step(state, batch)
    assert res["cost"]["dot_flops_per_device"] * 8 == pytest.approx(
        c.dot_flops, rel=0.02)
    assert res["cost"]["kernel_calls"] == dict(c.kernels)
    r = res["roofline"]
    assert r["hlo_flops"] == pytest.approx(
        res["cost"]["flops_per_device"] * 8)
    assert r["dominant"] in ("compute", "memory", "collective")


DECODE_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="bfloat16")
    res = dryrun.run_cell("llama3-8b", "decode_32k", cfg=cfg,
                          shape=ShapeConfig("decode_32k", 1024, 8, "decode"),
                          mesh_name="d2m4")
    print(json.dumps(res))
""")


def test_fake_group_decode_leaves_a_sequence_sharded_cache_in_place():
    """Reduced llama3-8b (1 kv head) decoding at the end of 1024 positions
    on a (2, 4) mesh: the cache is sharded by sequence over ``model``, and
    the step's collectives (the cross-rank combine, the residual stream's
    reductions) stay below one layer's local K+V, which the step before
    the combine gathered four times over; the kernel runs once a layer on
    each rank, as on one."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", DECODE_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["status"] == "ok" and res["chips"] == 8
    tcfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                               dtype="bfloat16")
    # one layer's K and V on one rank: 8 / 2 rows x 1024 / 4 positions
    local_kv = 2 * (8 // 2) * (1024 // 4) * tcfg.n_kv_heads * tcfg.head_dim * 2
    assert 0 < res["collectives"]["total"] < local_kv
    assert res["hlo_ops"]["all-reduce"] > 0
    c = _port("decode", tcfg, 8, 1024)
    assert res["cost"]["kernel_calls"] == dict(c.kernels) == {
        "decode_attention": transformer.attention_layers(tcfg)}


# ---------------------------------------------------------------------------
# the kernels' meta route
# ---------------------------------------------------------------------------

def test_kernels_charge_their_work_on_meta_under_a_counter_only():
    q = torch.empty(2, 256, 8, 64, device="meta", dtype=torch.bfloat16)
    k = torch.empty(2, 256, 2, 64, device="meta", dtype=torch.bfloat16)
    with cost.CostCounter() as c:
        o, lse = flash_attention(q, k, k, return_lse=True)
        assert o.shape == q.shape and o.is_meta
        assert lse.shape == (2, 8, 256) and lse.dtype == torch.float32
        dq, dk, dv = flash_attention_bwd(q, k, k, o, o, lse)
        assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
        od = decode_attention(q[:, 0], k, k, torch.empty(
            2, dtype=torch.int32, device="meta"))
        assert od.shape == (2, 8, 64)
    assert dict(c.kernels) == {"flash_attention": 1,
                               "flash_attention_bwd": 1,
                               "decode_attention": 1}
    # 256 queries and keys: one 256-row block, every element visited
    scores = 2 * 8 * 256 * 256
    decode_scores = 2 * 8 * 256
    assert c.dot_flops == (4 * 64 * scores + 14 * 64 * scores
                           + 4 * 64 * decode_scores)
    assert c.flops == c.dot_flops + (cost.SCORE_FLOPS * scores
                                     + cost.SCORE_FLOPS_BWD * scores
                                     + cost.SCORE_FLOPS * decode_scores)
    # a longer causal sequence visits the lower triangle of 512-blocks
    assert cost.attention_blocks(2048, 2048, causal=True, window=0) == (
        10 * 512 * 512)
    assert cost.attention_blocks(2048, 2048, causal=False, window=0) == (
        16 * 512 * 512)
    for call in (lambda: flash_attention(q, k, k),
                 lambda: flash_attention_bwd(q, k, k, q, q, torch.empty(
                     2, 8, 256, device="meta")),
                 lambda: decode_attention(q[:, 0], k, k, torch.ones(
                     2, dtype=torch.int32, device="meta"))):
        with pytest.raises(RuntimeError, match="no path for device"):
            call()


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------

def _cell(arch, shape, dom, frac, t):
    return {"arch": arch, "shape": shape, "mesh": "pod16x16", "status": "ok",
            "memory": {"temp_bytes": 3.2e9},
            "roofline": {"dominant": dom, "t_compute_s": t,
                         "t_memory_s": t / 3, "t_collective_s": t / 7,
                         "useful_ratio": 0.8, "roofline_fraction": frac}}


def test_report_prints_the_references_table_and_summary(tmp_path,
                                                        monkeypatch):
    d = tmp_path / "pod16x16"
    d.mkdir()
    cells = [_cell("olmo-1b", "train_4k", "compute", 0.61, 0.18),
             {"arch": "whisper-small", "shape": "long_500k",
              "mesh": "pod16x16", "status": "skipped",
              "reason": "whisper decoder context is 448 tokens"},
             _cell("llama3-8b", "decode_32k", "memory", 0.002, 2e-4)]
    for c in cells:
        (d / f"{c['arch']}__{c['shape']}.json").write_text(json.dumps(c))
    monkeypatch.setattr(jax_report, "REPORT_DIR", str(tmp_path))
    monkeypatch.setattr(report, "REPORT_DIR", str(tmp_path))
    assert report.roofline_table("pod16x16") == \
        jax_report.roofline_table("pod16x16")
    assert report.summary("pod16x16") == jax_report.summary("pod16x16")
    assert "| olmo-1b | train_4k | comp |" in report.roofline_table(
        "pod16x16")
    assert report.fmt_s(2e-4) == "200us" and report.fmt_b(3.2e9) == "3.2GB"
