"""The port's examples and scripts against the reference's, on the CPU.

``examples/rightsizing_dvfs_torch.py`` and ``scripts/parity_check_torch.py``
at ``--profile a100`` print exactly what the reference scripts print (the
simulator's arithmetic is copied, so every digit agrees); at ``h100``, their
default, they run to the end.  ``examples/multitenant_serving_torch.py`` at
``h100`` runs to the end here (its ``a100`` comparison is in
``test_torch_examples_multitenant.py``).  ``train_lm_torch`` trains, then
resumes from its checkpoint; ``ctl_smoke_torch.sh`` ends with its OK line.
Scripts run in this process (``main(argv)``), with both packages' kernel
ids reset first, as a fresh process would have them.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from _torch_port import to_numpy
from repro.configs.registry import get_config as jax_get_config
from repro.core import types as jax_types
from repro.models.registry import init_model as jax_init_model
from repro_torch.convert import from_jax_params
from repro_torch.core import types as torch_types

ROOT = Path(__file__).resolve().parents[1]


def load(rel: str):
    """The script at ``ROOT/rel`` as a module (examples/ and scripts/ are
    not packages)."""
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        path.stem + "_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stdout_of(capsys, fn) -> str:
    """What ``fn()`` prints, with both packages' kernel ids reset first."""
    jax_types.reset_kernel_ids()
    torch_types.reset_kernel_ids()
    capsys.readouterr()
    fn()
    return capsys.readouterr().out


def test_rightsizing_dvfs_a100_prints_the_references_lines(capsys):
    ref = stdout_of(capsys, load("examples/rightsizing_dvfs.py").main)
    got = stdout_of(capsys, lambda: load(
        "examples/rightsizing_dvfs_torch.py").main(["--profile", "a100"]))
    assert got == ref and ref.count("slip=") == 3


def test_rightsizing_dvfs_h100_runs(capsys):
    out = stdout_of(capsys, lambda: load(
        "examples/rightsizing_dvfs_torch.py").main([]))
    assert out.count("slip=") == 3 and "capacity saved" in out


def test_parity_check_a100_prints_the_references_lines(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["parity_check.py", "0.5"])
    with pytest.raises(SystemExit) as done:
        stdout_of(capsys, load("scripts/parity_check.py").main)
    assert done.value.code == 0
    ref = capsys.readouterr().out
    torch_types.reset_kernel_ids()
    code = load("scripts/parity_check_torch.py").main(
        ["0.5", "--profile", "a100"])
    got = capsys.readouterr().out
    assert code == 0 and got == ref and "FAIL" not in ref


def test_parity_check_h100_holds_both_engines_equal(capsys):
    torch_types.reset_kernel_ids()
    code = load("scripts/parity_check_torch.py").main(["0.5"])
    lines = capsys.readouterr().out.splitlines()
    assert code == 0
    assert len(lines) == 13 and all(x.startswith("OK") for x in lines)


def test_multitenant_serving_h100_runs(capsys):
    out = stdout_of(capsys, lambda: load(
        "examples/multitenant_serving_torch.py").main([]))
    lines = out.splitlines()
    assert lines[0].split()[:3] == ["system", "hpA", "p99"]
    assert [x.split()[0] for x in lines[1:]] == list(
        load("examples/multitenant_serving_torch.py").SYSTEMS)


def test_train_lm_trains_then_resumes(tmp_path, capsys):
    """``train_lm_torch --steps 3 --device cpu --ckpt-dir <tmp>`` from the
    reference's init of its config (converted), which runs to the end,
    loss decreasing as the reference's does from that init; then
    ``--resume``: nothing left to do at step 3; 5 steps resumed restore
    step 3 and take 2 more (through ``run``: two steps say nothing of the
    loss's trend)."""
    tl = load("examples/train_lm_torch.py")
    jcfg = dataclasses.replace(
        jax_get_config("olmo-1b"), n_layers=6, d_model=384, n_heads=6,
        n_kv_heads=6, d_ff=1536, vocab_size=8192)
    params = from_jax_params(to_numpy(jax_init_model(
        jcfg, jax.random.PRNGKey(0))), device="cpu")
    ckpt = str(tmp_path / "ckpt")
    common = ["--device", "cpu", "--ckpt-dir", ckpt]
    out = tl.main(["--steps", "3", *common], params=params)
    text = capsys.readouterr().out
    assert "model: olmo-family 17M params" in text and "tok/s on cpu" in text
    assert len(out["losses"]) == 3 and out["losses"][-1] < out["losses"][0]
    assert (tmp_path / "ckpt" / "step_3" / "COMMIT").exists()
    again = tl.main(["--steps", "3", "--resume", *common])
    assert again["losses"] == [] and "nothing to do" in capsys.readouterr().out
    more = tl.run(tl.config(), steps=5, batch=4, seq=128, ckpt_dir=ckpt,
                  resume=True, device="cpu")
    assert "restored checkpoint at step 3" in capsys.readouterr().out
    assert len(more["losses"]) == 2
    assert (tmp_path / "ckpt" / "step_5" / "COMMIT").exists()


def test_ctl_smoke_script_ends_with_its_ok_line(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path))
    run = subprocess.run(
        ["timeout", "120", "bash", str(ROOT / "scripts" / "ctl_smoke_torch.sh")],
        cwd=ROOT, env=env, capture_output=True, text=True)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-2000:]
    last = run.stdout.strip().splitlines()[-1]
    assert last.startswith("ctl smoke OK") and "recovered once" in last
