"""A copy of the benchmark in a temporary directory with tiny cells added
(configurations, mixes and limits as new files only), and a way to run a
cell of it on the CPU."""
import json
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for _p in (str(REPO / "src"), str(REPO)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

SERVE, TRAIN, ACCUM = "tiny-llava.serve.tiny", "tiny-olmo.train.tiny", \
    "tiny-olmo.train.tiny.accum2"
# limits of the tiny cells, between the largest reading of their sound runs
# on the CPU over 8 seeds (serve 0.00146; train 0.00017, 0.00113, 0.00184)
# and the smallest of the fp8 control's (serve 0.0175; train 0.00046,
# 0.0105, 0.00302)
TINY_LIMITS = {"serve": {"max_logit_gap": 0.005},
               "train": {"loss_gap": 0.0003, "grad_norm_gap": 0.004,
                         "change_norm_gap": 0.0025}}


def _dump(obj, path: Path) -> None:
    path.write_text(json.dumps(obj, indent=1))


def make_copy(tmp: Path) -> Path:
    root = tmp / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root)
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "src").symlink_to(REPO / "src")
    pb = root / "portbench"
    small = dict(n_layers=2, d_model=64, n_heads=4, d_head=16, d_ff=128,
                 vocab_size=256)
    for src, name, kv in (("llava-next-34b-l30", "tiny-llava", 2),
                          ("olmo-1b", "tiny-olmo", 4)):
        conf = json.loads((pb / "configs" / f"{src}.json").read_text())
        conf["name"] = name
        conf["arch"].update(small, n_kv_heads=kv)
        _dump(conf, pb / "configs" / f"{name}.json")
    mix = json.loads((pb / "traffic" / "serve.code.json").read_text())
    mix.update(rate_per_s=20.0, max_slots=4, max_len=64, served_tokens=64,
               prompt_tokens={"median": 16, "sigma": 0.6, "min": 4,
                              "max": 48},
               output_tokens={"median": 4, "sigma": 0.5, "min": 2, "max": 8},
               trace_start_s=0.0, trace_s=1.0)
    _dump(mix, pb / "traffic" / "serve.tiny.json")
    for name, micro in (("train.tiny", 1), ("train.tiny.accum2", 2)):
        mix = json.loads((pb / "traffic" / "train.b8s2048.json").read_text())
        mix.update(rows=4, seq_len=32, n_micro=micro, mean_doc_len=16,
                   pool=4, trace_after_steps=1, trace_steps=2)
        _dump(mix, pb / "traffic" / f"{name}.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"] += [
        {"name": n, "source": "https://arxiv.org/abs/2402.00838",
         "file": f"portbench/configs/{n}.json", "reduced": [], "why": "t"}
        for n in ("tiny-llava", "tiny-olmo")]
    bench["workloads"] += [
        {"name": SERVE, "config": "tiny-llava", "traffic": "serve.tiny",
         "chips": 1, "why": "t"},
        {"name": TRAIN, "config": "tiny-olmo", "traffic": "train.tiny",
         "chips": 1, "why": "t"},
        {"name": ACCUM, "config": "tiny-olmo", "traffic": "train.tiny.accum2",
         "chips": 1, "why": "t"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        ws = m.get("workloads")
        if ws is None:
            continue
        if any(".serve." in w for w in ws):
            ws.append(SERVE)
        if any(".train." in w for w in ws):
            ws += [TRAIN, ACCUM]
    _dump(bench, root / "BENCHMARK.json")
    _dump(TINY_LIMITS["serve"], pb / "limits" / f"{SERVE}.json")
    for w in (TRAIN, ACCUM):
        _dump(TINY_LIMITS["train"], pb / "limits" / f"{w}.json")
    return root


def load_run(root: Path):
    """The copy's ``run.py`` as a module of its own."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"pb_run_{abs(hash(str(root)))}", root / "portbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(root: Path, workload: str, *, seed: int = 3_000_000_007,
             seconds: float = 1.5, trace: int = 0, extra=()):
    mod = load_run(root)
    return mod.main(["--workload", workload, "--seed", str(seed),
                     "--seconds", str(seconds), "--trace", str(trace),
                     *extra], t_start=time.perf_counter(),
                    require_cuda=False)
