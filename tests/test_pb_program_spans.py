"""The benchmark's readers of the program's own spans
(``portbench/metrics/*``, through ``portbench/program_spans.py``) on the
tiny cells of ``portbench/tests/_pb_tiny.py``, on the CPU.

Each run is a process of its own: a run refuses to report when JAX or the
JAX package is loaded, as other test files of this process may have done."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from portbench.tests import _pb_tiny as tiny  # noqa: E402
from repro_torch import spans  # noqa: E402

SERVE_METRICS = ("queue_wait_p50_ms.serve", "decode_enqueue_ms.serve",
                 "decode_readback_ms.serve")
TRAIN_METRICS = ("forward_ms_per_ktok.train", "backward_ms_per_ktok.train")
ALL = SERVE_METRICS + TRAIN_METRICS

CHILD = """
import json, sys
from pathlib import Path
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
from portbench.tests import _pb_tiny as tiny
from repro_torch import spans
res = tiny.run_cell(Path(sys.argv[2]), sys.argv[3], trace=int(sys.argv[4]),
                    seconds=float(sys.argv[5]))
names = sorted({r["name"] for r in spans.records()})
print("CHILD " + json.dumps({"result": res, "spans": names}))
"""


def _run(root, cell, trace, seconds=1.5):
    """(result, names of the program's span records, standard output) of
    one run of ``cell`` in a process of its own."""
    p = subprocess.run([sys.executable, "-c", CHILD, str(REPO), str(root),
                        cell, str(trace), str(seconds)],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    line = [x for x in p.stdout.splitlines() if x.startswith("CHILD ")][-1]
    got = json.loads(line[len("CHILD "):])
    return got["result"], set(got["spans"]), p.stdout


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("pb_spans"))


def test_traced_serving_reads_queue_wait_enqueue_and_readback(root):
    res, names, _ = _run(root, tiny.SERVE, trace=1)
    assert res["correct"]
    for name in SERVE_METRICS:
        m = res["metrics"][name]
        assert m["value"] >= 0 and m["unit"] == "ms", name
    assert not set(TRAIN_METRICS) & set(res["metrics"])
    assert {"engine.queue", "engine.decode", "engine.readback"} <= names


@pytest.mark.parametrize("cell", [tiny.TRAIN, tiny.ACCUM])
def test_traced_training_reads_no_device_time_off_the_card(root, cell):
    res, names, _ = _run(root, cell, trace=1)
    assert res["correct"]
    assert "idle_share.train" in res["metrics"]
    assert not set(ALL) & set(res["metrics"])
    assert names == {"train.forward", "train.backward", "train.optimizer"}


@pytest.mark.parametrize("cell", [tiny.SERVE, tiny.TRAIN])
def test_untraced_runs_print_none_of_the_span_metrics(root, cell):
    res, names, out = _run(root, cell, trace=0, seconds=1.0)
    assert res["correct"]
    assert not set(ALL) & set(res["metrics"])
    assert not any(name in out for name in ALL)
    assert names == set()


def test_a_program_without_spans_gives_no_reading(root, monkeypatch):
    """The readers read the program's records; an older commit of the
    program has no ``repro_torch.spans``, and each reader then returns None
    and does not raise."""
    from portbench import harness
    bench = harness.Bench(root)
    spans.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            spans.record("engine.queue", time.perf_counter_ns() - 2_000_000)
            with spans.span("engine.decode"):
                pass
        assert bench.reader("queue_wait_p50_ms.serve").read(None) >= 2.0
        assert bench.reader("decode_enqueue_ms.serve").read(None) >= 0.0
        import repro_torch
        monkeypatch.delattr(repro_torch, "spans")
        monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
        for name in ALL:
            assert bench.reader(name).read(None) is None, name
    finally:
        spans.clear()
    added = {m["name"] for m in bench.spec["per_layer"]}
    assert set(ALL) <= added
