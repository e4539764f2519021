"""A kernel whose remaining work is below the simulated clock's resolution
completes, in both engines of the port's simulator.

The simulated clock is a float64: at time t it cannot advance by less than
about t * 2**-53.  A kernel that is left with a sliver of divisible work
(more than the completion test's 1e-9, but done in less time than the clock
resolves) would have its completion re-armed at the same instant forever.
The port's control-plane daemon met this on its default ``h100`` profile,
32.08 simulated seconds into a serving job of ``scripts/ctl_smoke_torch.sh``'s
shape: the daemon kept stepping events at that instant and never finished
the job.  The reference's simulator never runs the ``h100`` profile and
stays as it is; the port completes such a kernel at once (ROADMAP §C)."""
import pytest

from repro_torch.ctl import store
from repro_torch.ctl.daemon import ControlPlane, DaemonConfig
from repro_torch.ctl.state import JobState

pytestmark = pytest.mark.ctl

SERVE_40S = {"kind": "serve", "rps": 25.0, "duration": 40.0,
             "priority": "hp", "quota_slices": 6}


def serve_to_the_end(d, engine, max_ticks=5000):
    store.request_submit(d, SERVE_40S, job_id="svc-a")
    cp = ControlPlane(d, DaemonConfig(n_devices=2, device="h100",
                                      engine=engine, poll_interval=0.0))
    for _ in range(max_ticks):
        cp.tick()
        if cp.jobs["svc-a"].terminal:
            break
    sim_now = cp.coord.sims[cp.jobs["svc-a"].device].now
    cp.shutdown()
    return cp.jobs["svc-a"], sim_now


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each engine's serving job, run to its end once for the module."""
    return {engine: serve_to_the_end(str(tmp_path_factory.mktemp(engine)),
                                     engine)
            for engine in ("ref", "vec")}


@pytest.mark.parametrize("engine", ["ref", "vec"])
def test_serving_window_past_the_h100_stall_completes(runs, engine):
    job, sim_now = runs[engine]
    assert job.state is JobState.DONE, (job.state, sim_now)
    assert sim_now > 39.0
    assert job.result["n_completed"] > 0


def test_both_engines_complete_the_same_work(runs):
    assert runs["ref"][0].result == runs["vec"][0].result
