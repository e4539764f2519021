"""Dev sanity: run every system under both engines of ``repro_torch.core``,
demand bit-for-bit equality.  The port of ``scripts/parity_check.py``; the
committed parity suite is tests/test_torch_core.py.

    python scripts/parity_check_torch.py [horizon] [--profile h100|a100]

``--profile h100`` (the default) simulates ``DeviceSpec.h100_like``;
``a100`` the reference's ``a100_like``, where every line equals the
reference script's.  Exits 1 if any configuration differs.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import types as T  # noqa: E402
from repro_torch.core.lithos import evaluate, SYSTEMS  # noqa: E402
from repro_torch.core.scheduler import LithOSConfig  # noqa: E402
from repro_torch.core.types import DeviceSpec, Priority  # noqa: E402
from repro_torch.core.workloads import AppSpec  # noqa: E402

PROFILES = {"h100": DeviceSpec.h100_like, "a100": DeviceSpec.a100_like}
OLMO = get_config("olmo-1b")
LLAMA = get_config("llama3-8b")


def hp_app(rps=20.0, name="hp"):
    return AppSpec(name, OLMO, "fwd_infer", priority=Priority.HIGH,
                   rps=rps, prompt_mix=((128, 1.0),), batch=4, fusion=8)


def be_train(name="be"):
    return AppSpec(name, LLAMA, "train", priority=Priority.BEST_EFFORT,
                   train_batch=2, train_seq=2048, fusion=8)


def cont_app(name="cont", rps=40.0):
    return AppSpec(name, OLMO, "llm_continuous", priority=Priority.HIGH,
                   rps=rps, max_batch=4, decode_tokens=8, fusion=8,
                   prompt_mix=((256, 0.7), (1024, 0.3)), seed=5)


def rec_sig(res):
    return [(r.task.kid, r.task.queue_id, r.task.ordinal, r.t_submit,
             r.t_start, r.t_end, r.slices, r.freq) for r in res.records]


def run(dev, system, engine, horizon, cfg=None, apps=None):
    T.reset_kernel_ids()
    return evaluate(system, dev, apps or [hp_app(), be_train()],
                    horizon=horizon, seed=0, engine=engine,
                    lithos_config=cfg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("horizon", nargs="?", type=float, default=2.0)
    ap.add_argument("--profile", choices=sorted(PROFILES), default="h100")
    args = ap.parse_args(argv)
    dev = PROFILES[args.profile]()
    horizon = args.horizon
    configs = {s: (None, None) for s in SYSTEMS}
    configs["lithos-full"] = (LithOSConfig(rightsize=True, dvfs=True), None)
    # continuous-batching serving: dynamic per-iteration batch composition
    llm_apps = [cont_app(), be_train()]
    configs["lithos-llm"] = (None, llm_apps)
    configs["mps-llm"] = (None, llm_apps)
    configs["lithos-full-llm"] = (LithOSConfig(rightsize=True, dvfs=True),
                                  llm_apps)
    failures = 0
    for label, (cfg, apps) in configs.items():
        system = label.split("-")[0]
        a = run(dev, system, "ref", horizon, cfg, apps)
        b = run(dev, system, "vec", horizon, cfg, apps)
        ok = True
        msgs = []
        if rec_sig(a) != rec_sig(b):
            sa, sb = rec_sig(a), rec_sig(b)
            ok = False
            n = next((i for i, (x, y) in enumerate(zip(sa, sb)) if x != y),
                     min(len(sa), len(sb)))
            msgs.append(f"records differ at #{n}/{len(sa)}v{len(sb)}: "
                        f"{sa[n] if n < len(sa) else '<end>'} vs "
                        f"{sb[n] if n < len(sb) else '<end>'}")
        if a.energy != b.energy:
            ok = False
            msgs.append(f"energy {a.energy!r} vs {b.energy!r}")
        if a.busy_slice_seconds != b.busy_slice_seconds:
            ok = False
            msgs.append(f"busy {a.busy_slice_seconds!r} vs "
                        f"{b.busy_slice_seconds!r}")
        for ca, cb in zip(a.clients, b.clients):
            if ca.slice_seconds != cb.slice_seconds:
                ok = False
                msgs.append(f"{ca.name} slice_seconds {ca.slice_seconds!r} "
                            f"vs {cb.slice_seconds!r}")
            if ca.latencies != cb.latencies:
                ok = False
                msgs.append(f"{ca.name} latencies differ "
                            f"({len(ca.latencies)} vs {len(cb.latencies)})")
            if ca.req_latencies != cb.req_latencies:
                ok = False
                msgs.append(f"{ca.name} req_latencies differ "
                            f"({len(ca.req_latencies or [])} vs "
                            f"{len(cb.req_latencies or [])})")
        print(f"{'OK ' if ok else 'FAIL'} {label:14s} "
              f"records={len(a.records)}")
        for m in msgs:
            print(f"     {m}")
        failures += not ok
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
