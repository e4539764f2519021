"""Right-sizing + DVFS walkthrough: LithOS learns per-kernel Amdahl curves
and frequency sensitivities online (calibration phase), then trades a
bounded latency slip for capacity and energy (measurement phase) — the
steady state a minutes-long production run reaches.  The port of
``examples/rightsizing_dvfs.py`` on ``repro_torch.core`` (host code).

``--profile h100`` (the default) simulates ``DeviceSpec.h100_like``;
``--profile a100`` the reference's ``a100_like``, where every line equals
the reference script's.

Run:  PYTHONPATH=src python examples/rightsizing_dvfs_torch.py [--profile a100]
"""
import argparse
import dataclasses
from dataclasses import replace

from repro_torch.configs.registry import get_config
from repro_torch.core.lithos import make_policy, run_alone
from repro_torch.core.scheduler import LithOSConfig
from repro_torch.core.simulator import Simulator
from repro_torch.core.types import DeviceSpec, Priority
from repro_torch.core.workloads import AppSpec, mean_demand

PROFILES = {"h100": DeviceSpec.h100_like, "a100": DeviceSpec.a100_like}


def calibrated_run(dev, app, cfg, *, horizon, seed):
    """Calibrate (probes, f-exploration) then measure with learned state."""
    solo = replace(app, quota_slices=dev.n_slices)
    cal = make_policy("lithos", dev, [solo], lithos_config=cfg)
    Simulator(dev, [solo], cal, horizon=horizon, seed=seed + 1).run()
    meas = make_policy("lithos", dev, [solo],
                       lithos_config=dataclasses.replace(cfg,
                                                         probe_low=False))
    meas.predictor, meas.rightsizer, meas.governor = (
        cal.predictor, cal.rightsizer, cal.governor)
    meas.governor.current_f, meas.governor.last_switch = 1.0, -1e9
    sim = Simulator(dev, [solo], meas, horizon=horizon, seed=seed)
    res = sim.run()
    res.policy = meas
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", choices=sorted(PROFILES), default="h100")
    args = ap.parse_args(argv)
    dev = PROFILES[args.profile]()
    app = AppSpec("svc", get_config("llama3-8b"), "llm_infer",
                  priority=Priority.HIGH, prompt_mix=((2048, 1.0),),
                  decode_tokens=8, fusion=8)
    d = mean_demand(app, dev)
    app = replace(app, rps=0.25 / d, slo_latency=5 * d)

    base = run_alone(dev, app, horizon=12.0, seed=0,
                     lithos_config=LithOSConfig(rightsize=False, dvfs=False,
                                                occupancy_filter=False))
    b99 = base.client("svc").p(99, 0.3)
    for slip in (1.05, 1.1, 1.25):
        res = calibrated_run(dev, app,
                             LithOSConfig(rightsize=True, dvfs=True,
                                          slip=slip),
                             horizon=12.0, seed=0)
        rs, gov = res.policy.rightsizer, res.policy.governor
        cap = 1 - res.client("svc").slice_seconds / max(
            base.client("svc").slice_seconds, 1e-9)
        en = 1 - (res.energy / max(res.client("svc").n_completed, 1)) / (
            base.energy / max(base.client("svc").n_completed, 1))
        p99r = res.client("svc").p(99, 0.3) / b99
        print(f"slip={slip:.2f}: capacity saved {cap*100:5.1f}%  "
              f"energy/job saved {en*100:5.1f}%  p99 {p99r:.2f}x  "
              f"f_final {gov.current_f:.2f}  "
              f"fits {sum(f.fitted for f in rs.fits.values())} kernels")
    print("\nhigher slip => more capacity savings for more latency — the "
          "paper's k knob (§4.5/4.6).  Note energy/JOB can worsen once the "
          "slowdown eats throughput: the governor bounds per-kernel slip, "
          "not queueing amplification (the paper's conservative 1.1 choice).")


if __name__ == "__main__":
    main()
