"""``examples/quickstart_torch.py`` against the reference quickstart, on the
CPU.

Its ``run`` on a float32 copy of the reduced olmo-1b, with the parameters
the reference's ``launch.train`` draws (converted), gives the reference's
losses (rtol 1e-5: two f32 computations in other orders, as
``test_torch_train.py``), the same served tokens and the same simulation
lines at ``--profile a100``.  The command line ``--reduced --device cpu``
runs to the end and prints the reference quickstart's simulation lines.
"""
import numpy as np

from _torch_port import make_pair
from repro.launch.train import train as jax_train
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import SlotServer as JaxSlotServer
from repro.train.step import TrainConfig as JaxTrainConfig
from test_torch_examples import load, stdout_of


def test_run_gives_the_references_losses_tokens_and_lines(capsys):
    jcfg, _, tcfg, tparams = make_pair("olmo-1b")
    # the reference quickstart's parts 1 and 2 on the f32 config
    state, jl = jax_train(jcfg, steps=20, batch=8, seq=64,
                          tc=JaxTrainConfig(total_steps=20, warmup_steps=2),
                          log_every=5, verbose=False)
    srv = JaxSlotServer(jcfg, params=state.params,
                        serve_cfg=JaxServeConfig(max_slots=3, max_len=64,
                                                 max_new_tokens=8))
    rng = np.random.default_rng(0)
    for _ in range(6):
        srv.submit(rng.integers(2, jcfg.vocab_size, 12).astype(np.int32))
    jout = [list(map(int, r.output)) for r in srv.run_until_drained()]
    ref_lines = [line for line in stdout_of(
        capsys, load("examples/quickstart.py").main).splitlines()
        if "inference p99" in line]

    got = load("examples/quickstart_torch.py").run(
        tcfg, device="cpu", params=tparams, profile="a100", verbose=False)
    np.testing.assert_allclose(got["losses"], jl, rtol=1e-5)
    assert got["outputs"] == jout
    assert got["sim"] == ref_lines and len(ref_lines) == 2


def test_command_line_reduced_on_the_cpu(capsys):
    out = load("examples/quickstart_torch.py").main(
        ["--reduced", "--device", "cpu", "--profile", "a100"])
    text = capsys.readouterr().out
    assert len(out["losses"]) == 20 and np.isfinite(out["losses"]).all()
    assert "served 6 requests" in text and len(out["outputs"]) == 6
    assert all(line in text for line in out["sim"])
    assert "inference p99" in out["sim"][0]
