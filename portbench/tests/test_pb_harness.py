"""The benchmark's harness on the CPU: cells and metrics found by name, a
cell, a mix and a metric added by new files alone, the arithmetic of the
end-to-end metrics, the frozen counts, the check for JAX, and a
``--trace 0`` run opening no profiler."""
import json
import sys

import numpy as np
import pytest

from portbench import counts, harness
from portbench.tests import _pb_tiny as tiny


def test_every_cell_finds_its_files():
    bench = harness.Bench()
    for w in bench.spec["workloads"]:
        conf = bench.config(w["config"])
        mix = bench.traffic(w["traffic"])
        assert set(bench.limits(w["name"]))
        assert bench.driver(mix["kind"]).run
        cfg = harness.arch_config(conf["arch"])
        assert cfg.n_layers == conf["arch"]["n_layers"]
        e2e = {m["name"] for m in bench.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = bench.per_layer(w["name"])
        assert layers
        for m in layers:
            assert m["moves"] in e2e
            assert bench.reader(m["name"]).read


def test_config_files_match_the_port_but_for_reduced_keys():
    import dataclasses
    from repro_torch.configs.llava_next_34b import CONFIG as LLAVA
    from repro_torch.configs.olmo_1b import CONFIG as OLMO
    bench = harness.Bench()
    for entry, port in zip(bench.spec["configs"], (LLAVA, OLMO)):
        conf = bench.config(entry["name"])
        want = dataclasses.asdict(port)
        changed = {k for k, v in conf["arch"].items() if want[k] != v}
        assert changed == set(entry["reduced"]) == set(conf["reduced"])


def test_adding_a_cell_a_mix_and_a_metric_takes_new_files_only(tmp_path):
    root = tiny.make_copy(tmp_path)
    pb = root / "portbench"
    (pb / "metrics" / "decode_rows.serve.py").write_text(
        "def read(run):\n"
        "    recs = run.of('decode')\n"
        "    return float(len(recs)) if recs else None\n")
    (pb / "metrics" / "nothing.serve.py").write_text(
        "def read(run):\n    return None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name in ("decode_rows.serve", "nothing.serve"):
        bench["per_layer"].append(
            {"name": name, "unit": "steps", "better": "higher",
             "source": "program_span", "layer": "model",
             "moves": "ttft_p95_ms", "workloads": [tiny.SERVE]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = tiny.run_cell(root, tiny.SERVE, trace=1)
    assert res["metrics"]["decode_rows.serve"]["value"] > 0
    assert "nothing.serve" not in res["metrics"]
    assert "ttft_p95_ms" not in res["metrics"]
    assert set(res["device"]) >= {"busy_s", "window_s"}
    res = tiny.run_cell(root, tiny.SERVE, trace=0)
    assert set(res["metrics"]) == {"ttft_p95_ms", "setup_s"}
    assert list(res)[-1] == "checks"


def test_percentiles_are_over_all_requests_and_gaps():
    from types import SimpleNamespace
    drv = harness.Bench().driver("serve")
    recs = []
    for i in range(40):
        times = [10.0 + i + 0.1 * k * (1 + i % 3) for k in range(5)]
        req = SimpleNamespace(t_first_token=times[0])
        recs.append({"req": req, "due": 10.0 + i - 0.01 * i,
                     "times": times})
    ttft, gaps = drv.latencies(recs)
    assert len(ttft) == 40 and len(gaps) == 160
    assert np.percentile(ttft, 95) == pytest.approx(
        np.percentile([10 * i for i in range(40)], 95))
    assert sorted(gaps)[-1] == pytest.approx(300.0)


def test_rate_counts_every_token_of_every_whole_step():
    drv = harness.Bench().driver("train")
    assert drv.rate(7, 8, 2048, 2.0) == 7 * 8 * 2048 / 2.0


def test_counts_match_the_kernel_table_bounds():
    fl, nb = counts.k2_counts(2, 2048, 2048, 16, 16, 128)
    assert counts.bound_s(fl, nb) * 1e3 == pytest.approx(0.0348, rel=2e-3)
    fl, nb = counts.k2bwd_counts(2, 2048, 16, 16, 128)
    assert counts.bound_s(fl, nb) * 1e3 == pytest.approx(0.08690, rel=1e-3)
    fl, nb = counts.k1_counts([300, 700, 1000, 1040], 32, 8, 128)
    assert counts.bound_s(fl, nb) * 1e3 == pytest.approx(0.00374, rel=1e-2)
    fl, nb = counts.k2_counts(1, 1000, 1000, 32, 8, 128)
    assert counts.bound_s(fl, nb) * 1e3 == pytest.approx(0.00829, rel=1e-2)


def test_model_flops_of_the_configurations():
    bench = harness.Bench()
    olmo = bench.config("olmo-1b")["arch"]
    layers, head = counts.matmul_params(olmo)
    assert layers + head == pytest.approx(1.177e9, rel=1e-3)
    llava = bench.config("llava-next-34b-l30")["arch"]
    layers, head = counts.matmul_params(llava)
    assert layers == pytest.approx(16.73e9, rel=1e-3)


@pytest.mark.parametrize("name,found", [
    ("jax", ["jax"]), ("jax.numpy", ["jax"]), ("jaxlib", ["jaxlib"]),
    ("flax.linen", ["flax"]), ("repro", ["repro"]),
    ("repro.core.types", ["repro"]), ("repro_torch", []),
    ("repro_torch.models", []), ("jaxtyping", []), ("reproducible", [])])
def test_forbidden_modules_compare_whole_top_level_names(monkeypatch, name,
                                                         found):
    for m in [m for m in sys.modules
              if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == found


def test_trace_0_opens_no_profiler_and_no_span(tmp_path, monkeypatch):
    import torch

    def refuse(*a, **kw):
        raise AssertionError("a --trace 0 run opened the profiler")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd, "_enable_profiler", refuse)
    root = tiny.make_copy(tmp_path)
    for w in (tiny.SERVE, tiny.TRAIN):
        res = tiny.run_cell(root, w, trace=0, seconds=1.0)
        assert res["correct"]


def test_trace_gives_device_events_to_ranges_across_threads(tmp_path):
    """A range on the main thread owns what the autograd thread launched
    inside its interval; markers bracket the backward; busy time is the
    union of device events; gaps are labelled by span and operator."""
    from portbench import tracing

    def x(cat, name, ts, dur, tid, corr=None):
        ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
              "tid": tid}
        if corr is not None:
            ev["args"] = {"correlation": corr}
        return ev

    events = [
        x("user_annotation", "pb.window#0", 0, 100, 1),
        x("user_annotation", "pb.fwdbwd#1", 10, 60, 1),
        x("cpu_op", "aten::mm", 12, 2, 1),
        x("cuda_runtime", "cudaLaunchKernel", 12.5, 1, 1, 7),
        x("kernel", "gemm", 14, 10, 0, 7),
        x("user_annotation", "pb.k2bwd_begin#2", 30, 0, 2),
        x("cpu_op", "aten::add", 31, 2, 2),
        x("cuda_runtime", "cudaLaunchKernel", 31.5, 1, 2, 8),
        x("kernel", "bwd", 40, 20, 0, 8),
        x("user_annotation", "pb.k2bwd_end#2", 33, 0, 2),
        x("cuda_runtime", "cudaLaunchKernel", 80, 1, 1, 9),
        x("kernel", "adam", 85, 5, 0, 9),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tr = tracing.read_trace(str(path))
    assert [e[2] for e in tr.span_events("fwdbwd#1")] == ["gemm", "bwd"]
    assert [e[2] for e in tr.span_events("k2bwd#2")] == ["bwd"]
    assert tr.present("k2bwd#2") and not tr.present("k2bwd#3")
    assert tr.window() == (0.0, 100.0)
    assert tr.busy_us(0, 100) == pytest.approx(35.0)
    gaps = dict(tr.idle_gaps(0, 100))
    assert gaps["fwdbwd___aten::mm"] == pytest.approx(14e-6)
    assert gaps["fwdbwd___aten::add"] == pytest.approx(16e-6)
    assert gaps["(no span)___adam"] == pytest.approx(25e-6)
    assert gaps["(after the last launch)"] == pytest.approx(10e-6)

