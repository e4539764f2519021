"""Training over a mesh of ranks: the port's ``launch.train.train(mesh=...)``
in 4 gloo processes (one rank each, DTensor state) against the JAX
package's ``repro.launch.train.train(mesh=...)`` on the same mesh of 4
logical XLA devices, in a subprocess.

f32 reduced configs; the parameters are the reference's init, crossed by
conversion.  Each case takes 4 steps.  Losses are held to the reference's
to 1e-5 relative; the gathered parameters after the last step to the
port's own run on one rank (no mesh) to 1e-5 (int8 cases: but for
``INT8_FLIPS`` elements, each within lr).  Cases: a (2, 2) mesh for
olmo-1b (two microbatches), llama3-8b (one kv head: q's heads shard over
``model`` while the kv head replicates) and qwen2-moe-a2.7b (experts over
``model``), and a (1, 4) mesh for llama3-8b, where each rank holds one q
head; then int8 gradient compression with int8 moments (olmo-1b (2, 2),
llama3-8b (1, 4)) and int8 moments alone (llama3-8b (2, 2)).
"""
import dataclasses
import json
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from _torch_ranks import (SRC, load_params, rank_env, save_tree, start_ranks,
                          wait_ranks)
from repro.configs.registry import get_config as jax_get_config
from repro.models.registry import init_model as jax_init_model
from repro_torch.configs.registry import get_config
from repro_torch.launch.train import train
from repro_torch.models.common import tree_paths
from repro_torch.train.step import TrainConfig

LOSS = dict(rtol=1e-5, atol=1e-6)
# AdamW normalises each update, so a gradient summed in another order moves
# a parameter whose gradient is near zero by up to ~lr times its rounding:
# parameters are held to 1e-5 absolute and relative
PARAMS = dict(rtol=1e-5, atol=1e-5)
# int8 blocks (gradient compression, int8 moments): where the mesh's f32
# gradient differs from one rank's in its last bit, round(x / scale) can
# land one level apart, and that element's Adam update moves by up to ~lr.
# Each such case showed one element past PARAMS, of ~10^5: at most
# INT8_FLIPS elements may be, each within lr
INT8_FLIPS = 2
TC = dict(total_steps=4, warmup_steps=1)
CASES = [
    dict(name="olmo_2x2", arch="olmo-1b", mesh=[2, 2],
         tc=dict(TC, n_micro=2)),
    dict(name="llama_2x2", arch="llama3-8b", mesh=[2, 2], tc=TC),
    dict(name="moe_2x2", arch="qwen2-moe-a2.7b", mesh=[2, 2], tc=TC),
    dict(name="llama_1x4", arch="llama3-8b", mesh=[1, 4], tc=TC),
    # int8 gradient compression and int8 moments: blocks of the whole leaf,
    # whose last dim the mesh cuts below QBLOCK on these reduced widths
    dict(name="olmo_2x2_compress", arch="olmo-1b", mesh=[2, 2],
         tc=dict(TC, grad_compress=True, moment_dtype="int8")),
    dict(name="llama_1x4_compress", arch="llama3-8b", mesh=[1, 4],
         tc=dict(TC, grad_compress=True, moment_dtype="int8")),
    dict(name="llama_2x2_int8", arch="llama3-8b", mesh=[2, 2],
         tc=dict(TC, moment_dtype="int8")),
]
for c in CASES:
    c.update(axes=["data", "model"], steps=4, batch=4, seq=32)

REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json, sys
    import jax
    from jax.sharding import AxisType
    from repro.configs.registry import get_config
    from repro.launch.train import train
    from repro.train.step import TrainConfig

    cases, out = json.loads(sys.argv[1]), sys.argv[2]
    assert len(jax.devices()) == 4
    res = {}
    for c in cases:
        cfg = dataclasses.replace(get_config(c["arch"]).reduced(),
                                  dtype="float32")
        # Auto axes: the reference's sharding constraints (jax.make_mesh
        # defaults to Explicit axes in recent jax)
        mesh = jax.make_mesh(tuple(c["mesh"]), tuple(c["axes"]),
                             axis_types=(AxisType.Auto,) * len(c["mesh"]))
        _, losses = train(cfg, steps=c["steps"], batch=c["batch"],
                          seq=c["seq"], tc=TrainConfig(**c["tc"]), mesh=mesh,
                          verbose=False)
        res[c["name"]] = losses
    with open(out, "w") as f:
        json.dump(res, f)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs (one subprocess) and the port's (one gloo job
    of 4 ranks), started together."""
    d = tmp_path_factory.mktemp("mesh_train")
    for c in CASES:
        cfg = dataclasses.replace(jax_get_config(c["arch"]).reduced(),
                                  dtype="float32")
        params = jax_init_model(cfg, jax.random.PRNGKey(0))
        c["params"] = str(d / f"{c['name']}_init.npz")
        save_tree(c["params"], [(jax.tree_util.keystr(p, simple=True,
                                                      separator="/"), x)
                                for p, x in
                                jax.tree_util.tree_flatten_with_path(
                                    params)[0]])
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, json.dumps(CASES),
         str(d / "ref.json")], env=rank_env(PYTHONPATH=SRC),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = start_ranks(4, {"cases": CASES, "out": str(d)},
                        str(d / "job.json"))
    wait_ranks(ranks)
    _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-4000:]
    with open(d / "ref.json") as f:
        ref_losses = json.load(f)
    return d, ref_losses


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_mesh_train_matches_the_reference_and_one_rank(runs, case):
    d, ref_losses = runs
    with open(d / f"{case['name']}.json") as f:
        got = json.load(f)
    assert got["leaf_types"] == ["DTensor"]
    assert len(got["losses"]) == case["steps"]
    np.testing.assert_allclose(got["losses"], ref_losses[case["name"]],
                               **LOSS)
    # the same run on one rank, without a mesh
    cfg = dataclasses.replace(get_config(case["arch"]).reduced(),
                              dtype="float32")
    state, losses = train(
        cfg, steps=case["steps"], batch=case["batch"], seq=case["seq"],
        tc=TrainConfig(**case["tc"]), device="cpu", verbose=False,
        params=load_params(case["params"], cfg))
    np.testing.assert_allclose(got["losses"], losses, **LOSS)
    gathered = dict(np.load(d / f"{case['name']}.npz"))
    one = {p: x.numpy() for p, x in tree_paths(state.params)}
    assert set(gathered) == set(one)
    flips = INT8_FLIPS if "int8" in case["tc"].values() else 0
    off = []
    for p in one:
        bad = ~np.isclose(gathered[p], one[p], **PARAMS)
        off += list(np.abs(gathered[p] - one[p])[bad])
        if len(off) > flips:
            np.testing.assert_allclose(gathered[p], one[p], err_msg=p,
                                       **PARAMS)
    assert max(off, default=0.0) <= TrainConfig(**case["tc"]).lr, off
