"""Multi-tenant serving: the paper's inference-stacking experiment in
miniature — two HP services with SLOs plus a best-effort tenant, compared
across all nine scheduling systems.  The port of
``examples/multitenant_serving.py`` on ``repro_torch.core`` (host code: the
simulator runs no kernel).

``--profile h100`` (the default) simulates ``DeviceSpec.h100_like``, whose
constants the card measured; ``--profile a100`` the reference's
``a100_like``, where every line equals the reference script's.

Run:  PYTHONPATH=src python examples/multitenant_serving_torch.py [--profile a100]
"""
import argparse
from dataclasses import replace

from repro_torch.configs.registry import get_config
from repro_torch.core.lithos import SYSTEMS, evaluate, run_alone
from repro_torch.core.types import DeviceSpec, Priority
from repro_torch.core.workloads import AppSpec, mean_demand

PROFILES = {"h100": DeviceSpec.h100_like, "a100": DeviceSpec.a100_like}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", choices=sorted(PROFILES), default="h100")
    args = ap.parse_args(argv)
    dev = PROFILES[args.profile]()
    hpa = AppSpec("hpA", get_config("olmo-1b"), "fwd_infer",
                  priority=Priority.HIGH, quota_slices=40, batch=8,
                  prompt_mix=((128, 1.0),), fusion=8)
    hpb = AppSpec("hpB", get_config("llama3-8b"), "llm_infer",
                  priority=Priority.HIGH, quota_slices=14,
                  prompt_mix=((2048, 1.0),), decode_tokens=6, fusion=8)
    # BE: sustained 8k-prompt pressure, TRT-LLM-style fused prefill kernels
    be = AppSpec("be", get_config("qwen2-moe-a2.7b"), "llm_infer",
                 priority=Priority.BEST_EFFORT, rps=0.0,
                 prompt_mix=((8192, 1.0),), decode_tokens=8, fusion=16)
    be2 = replace(be, name="be2", seed=97)
    # calibrate loads: HP A at 50% util, HP B at 15%
    da, db = mean_demand(hpa, dev), mean_demand(hpb, dev)
    hpa = replace(hpa, rps=0.5 / da, slo_latency=4 * da)
    hpb = replace(hpb, rps=0.15 / db, slo_latency=8 * db)

    ideal = run_alone(dev, hpa, horizon=8.0, seed=0).client("hpA").p99
    print(f"{'system':10s} {'hpA p99':>10s} {'vs ideal':>9s} "
          f"{'hpA SLO%':>9s} {'hpB done':>9s} {'BE done':>8s} {'util':>6s}")
    for system in SYSTEMS:
        res = evaluate(system, dev, [hpa, hpb, be, be2], horizon=8.0, seed=0)
        A, B, E = res.client("hpA"), res.client("hpB"), res.client("be")
        print(f"{system:10s} {A.p99*1e3:9.1f}ms {A.p99/ideal:8.1f}x "
              f"{A.slo_attainment(hpa.slo_latency)*100:8.1f}% "
              f"{B.n_completed:9d} {E.n_completed + res.client('be2').n_completed:8d} "
              f"{res.utilization:6.2f}")


if __name__ == "__main__":
    main()
