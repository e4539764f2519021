"""The port's checkpoints against the JAX package's, on the CPU: the same
on-disk format both ways (every leaf bit for bit, ``QTensor`` moments and
error feedback included), the same ``manifest.json`` for the same state,
crash consistency, keep-last-k, refused templates, async saves, and the
launcher's resume (the ports of ``test_substrates.py``'s checkpoint tests).

States are made by the JAX package and converted, with every leaf filled
from a numpy seed (so moments, scales and the step are not their zero
inits).  Checkpoint contents are compared bit for bit; losses of a resumed
run against the reference's to 1e-5 relative, as
``test_launch_train_three_steps_match_reference_losses``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import make_pair
from repro.checkpoint.sharded import CheckpointManager as JaxManager
from repro.checkpoint.sharded import restore_checkpoint as jax_restore
from repro.checkpoint.sharded import save_checkpoint as jax_save
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.launch.train import train as jax_train
from repro.train.step import TrainConfig as JaxTrainConfig
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint.sharded import _flatten
from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_train_state
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.train import state_template, to_device, train
from repro_torch.optim.optimizers import QTensor
from repro_torch.train.step import TrainConfig, make_train_step

LOSS = dict(rtol=1e-5, atol=1e-6)
MOMENTS = {"f32": dict(moment_dtype="float32"),
           "bf16": dict(moment_dtype="bfloat16"),
           "int8_compress": dict(moment_dtype="int8", grad_compress=True)}


def _scramble(tree, seed):
    """Every leaf of a JAX tree refilled from a numpy seed, in its dtype."""
    rng = np.random.default_rng(seed)

    def leaf(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return rng.integers(-127, 128, x.shape).astype(x.dtype)
        return rng.standard_normal(x.shape).astype(x.dtype)
    return jax.tree.map(leaf, tree)


def _jax_state(moments, seed=1):
    """(reference TrainState with every leaf from a numpy seed, port cfg,
    port TrainConfig) for reduced olmo-1b (bf16 params)."""
    jcfg = make_pair("olmo-1b", dtype="bfloat16")[0]
    init, _ = jax_make_train_step(jcfg, JaxTrainConfig(**MOMENTS[moments]))
    return (_scramble(init(jax.random.PRNGKey(0)), seed),
            get_config("olmo-1b").reduced(), TrainConfig(**MOMENTS[moments]))


def _bits(x) -> np.ndarray:
    """A leaf of either package as numpy, bfloat16 / fp8 as their bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16,):
            return x.view(torch.int16).numpy()
        if x.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            return x.view(torch.uint8).numpy()
        return x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16)
    if x.dtype.name.startswith("float8"):
        return x.view(np.uint8)
    return x


def _jax_leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_bit_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        a, b = _bits(got[k]), _bits(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


def assert_states_equal(a, b):
    """Two port states: the same keys, dtypes, shapes and bits; a QTensor
    keeps its shape."""
    fa, fb = _flatten(a), _flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k
    for qa, qb in zip(_qtensors(a.opt.mu), _qtensors(b.opt.mu)):
        assert qa.shape == qb.shape


def _qtensors(tree):
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _qtensors(tree[k])]
    return [tree] if isinstance(tree, QTensor) else []


# ---------------------------------------------------------------------------
# the format: port -> port, reference <-> port, the manifest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moments", ["f32", "int8_compress"])
def test_port_round_trip_of_a_train_state(tmp_path, moments):
    jstate, cfg, tc = _jax_state(moments)
    state = from_jax_train_state(jstate, device="cpu")
    if moments == "int8_compress":
        assert isinstance(state.opt.mu["embed"]["tok"], QTensor)
        assert state.err_fb is not None
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, 3)
    mgr.wait_all()
    restored = mgr.restore(state_template(cfg, tc), device="cpu")
    assert all(x.device.type == "cpu" for x in _flatten(restored).values())
    assert_states_equal(restored, state)
    assert int(restored.opt.step) == int(state.opt.step)


@pytest.mark.parametrize("moments", list(MOMENTS))
def test_reference_checkpoint_restores_in_the_port(tmp_path, moments):
    jstate, cfg, tc = _jax_state(moments, seed=2)
    jax_save(jstate, str(tmp_path), 7, async_write=False).wait()
    restored = restore_checkpoint(state_template(cfg, tc), str(tmp_path),
                                  device="cpu")
    assert latest_step(str(tmp_path)) == 7
    assert_states_equal(restored, from_jax_train_state(jstate, device="cpu"))
    assert_bit_equal(_flatten(restored), _jax_leaves(jstate))


@pytest.mark.parametrize("moments", list(MOMENTS))
def test_port_checkpoint_restores_in_the_reference(tmp_path, moments):
    jstate, _, _ = _jax_state(moments, seed=3)
    save_checkpoint(from_jax_train_state(jstate, device="cpu"),
                    str(tmp_path), 5).wait()
    restored = jax_restore(jstate, str(tmp_path))
    assert_bit_equal(_jax_leaves(restored), _jax_leaves(jstate))


@pytest.mark.parametrize("moments", list(MOMENTS))
def test_both_packages_write_the_same_manifest(tmp_path, moments):
    jstate, _, _ = _jax_state(moments, seed=4)
    jax_save(jstate, str(tmp_path / "ref"), 2, async_write=False).wait()
    save_checkpoint(from_jax_train_state(jstate, device="cpu"),
                    str(tmp_path / "port"), 2, async_write=False).wait()
    text = {side: (tmp_path / side / "step_2" / "manifest.json").read_text()
            for side in ("ref", "port")}
    ref, port = (json.loads(text[s]) for s in ("ref", "port"))
    assert list(port["leaves"]) == list(ref["leaves"])     # same order
    assert port == ref
    assert text["port"] == text["ref"]
    assert sorted(os.listdir(tmp_path / "port" / "step_2")) == sorted(
        os.listdir(tmp_path / "ref" / "step_2"))
    dtypes = {m["dtype"] for m in ref["leaves"].values()}
    assert {"bfloat16", "int32"} <= dtypes
    if moments == "int8_compress":
        assert {"int8", "float32"} <= dtypes
        assert ".opt.mu['embed']['tok'][<flat index 0>]" in ref["leaves"]


def test_bf16_and_fp8_leaves_cross_as_their_bits(tmp_path):
    """Every bf16 / fp8 bit pattern of a few, NaN and inf codes included,
    both ways."""
    rng = np.random.default_rng(5)
    tree = {"b": torch.from_numpy(rng.integers(-2**15, 2**15, (3, 40),
                                               dtype=np.int16)
                                  ).view(torch.bfloat16),
            "e4": torch.arange(256, dtype=torch.uint8
                               ).view(torch.float8_e4m3fn),
            "e5": torch.arange(256, dtype=torch.uint8).view(torch.float8_e5m2),
            "i": torch.arange(5, dtype=torch.int32)}
    save_checkpoint(tree, str(tmp_path / "port"), 1, async_write=False).wait()
    like = {torch.bfloat16: jnp.bfloat16, torch.float8_e4m3fn:
            jnp.float8_e4m3fn, torch.float8_e5m2: jnp.float8_e5m2,
            torch.int32: jnp.int32}
    jtree = jax_restore({k: np.zeros(tuple(v.shape), like[v.dtype])
                         for k, v in tree.items()}, str(tmp_path / "port"))
    assert {k: np.asarray(v).dtype.name for k, v in jtree.items()} == {
        "b": "bfloat16", "e4": "float8_e4m3fn", "e5": "float8_e5m2",
        "i": "int32"}
    assert_bit_equal({k: jtree[k] for k in sorted(tree)},
                     {k: tree[k] for k in sorted(tree)})
    jax_save(jtree, str(tmp_path / "ref"), 1, async_write=False).wait()
    back = restore_checkpoint(tree, str(tmp_path / "ref"), device="cpu")
    for k in tree:
        assert back[k].dtype == tree[k].dtype
        assert np.array_equal(_bits(back[k]), _bits(tree[k])), k


# ---------------------------------------------------------------------------
# the ports of test_substrates.py's checkpoint tests
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_gc(tmp_path):
    cfg = get_config("olmo-1b").reduced()
    init_state, _ = make_train_step(cfg, TrainConfig(moment_dtype="int8"),
                                    device="cpu")
    state = init_state(seed=1)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(state, s)
    mgr.wait_all()
    assert latest_step(str(tmp_path)) == 4
    kept = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert kept == ["step_3", "step_4"]
    assert_states_equal(mgr.restore(state, device="cpu"), state)


def test_checkpoint_crash_consistency(tmp_path):
    """A step dir without COMMIT is never considered restorable."""
    state = {"w": torch.arange(8, dtype=torch.float32)}
    h = save_checkpoint(state, str(tmp_path), 5, async_write=False)
    h.wait()
    os.makedirs(tmp_path / "step_9")              # torn write, no COMMIT
    os.makedirs(tmp_path / "step_11.tmp")
    assert latest_step(str(tmp_path)) == 5
    restored = restore_checkpoint(state, str(tmp_path), device="cpu")
    assert torch.equal(restored["w"], state["w"])
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        restore_checkpoint(state, str(tmp_path / "none"), device="cpu")


def test_checkpoint_elastic_restore_smaller_template_fails_loudly(tmp_path):
    state = {"w": torch.zeros(4, 4), "b": torch.zeros(4)}
    save_checkpoint(state, str(tmp_path), 1, async_write=False).wait()
    with pytest.raises(ValueError, match="extra leaves"):
        restore_checkpoint({"w": torch.zeros(4, 4)}, str(tmp_path),
                           device="cpu")
    with pytest.raises(ValueError, match="missing leaves"):
        restore_checkpoint({**state, "c": torch.zeros(1)}, str(tmp_path),
                           device="cpu")
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint({"w": torch.zeros(4, 5), "b": torch.zeros(4)},
                           str(tmp_path), device="cpu")


def test_async_save_snapshots_when_called_and_wait_joins(tmp_path):
    """``save`` copies every leaf before it returns: writing the live state
    afterwards changes nothing on disk.  ``wait`` returns once COMMIT is
    there; a failed write is raised by ``wait``."""
    state = {"w": torch.arange(6, dtype=torch.float32),
             "s": torch.ones(2, dtype=torch.bfloat16)}
    want = {k: v.clone() for k, v in state.items()}
    h = save_checkpoint(state, str(tmp_path), 3)
    state["w"].add_(100.0)
    state["s"].zero_()
    h.wait()
    assert h.committed and (tmp_path / "step_3" / "COMMIT").exists()
    got = restore_checkpoint(state, str(tmp_path), device="cpu")
    for k in want:
        assert torch.equal(got[k], want[k]), k
    (tmp_path / "blocked").write_text("a file where a directory goes")
    bad = save_checkpoint(state, str(tmp_path / "blocked"), 1)
    with pytest.raises(RuntimeError, match="did not commit"):
        bad.wait()


def test_restore_places_leaves_on_the_gpu_unless_told(tmp_path):
    """A template on ``meta`` says nothing of where leaves go: ``device``
    does, ``sharding_fn`` per leaf, and None means the GPU (an error here,
    never a CPU restore by itself); the leaf takes the template's dtype."""
    state = {"a": torch.arange(4, dtype=torch.float32),
             "b": torch.arange(3, dtype=torch.int32)}
    save_checkpoint(state, str(tmp_path), 1, async_write=False).wait()
    meta = {"a": torch.empty(4, dtype=torch.bfloat16, device="meta"),
            "b": torch.empty(3, dtype=torch.int32, device="meta")}
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_checkpoint(meta, str(tmp_path))
    seen = []

    def where(key):
        seen.append(key)
        return torch.device("cpu") if key == "['a']" else None
    got = restore_checkpoint(meta, str(tmp_path), sharding_fn=where,
                             device="cpu")
    assert seen == ["['a']", "['b']"]
    assert got["a"].dtype == torch.bfloat16 and got["a"].device.type == "cpu"
    assert torch.equal(got["a"].float(), state["a"])
    assert torch.equal(got["b"], state["b"])


# ---------------------------------------------------------------------------
# the launcher's resume
# ---------------------------------------------------------------------------

def test_resume_replays_the_data_from_batch_zero_in_both_packages(tmp_path):
    """A run restored at step k trains its next step on batch 0, not on
    batch k (``repro/launch/train.py:63-65``, ``data/pipeline.py:49-71``;
    ROADMAP §C): in each package the first resumed loss equals one step from
    the restored state on batch 0, and differs from a step on batch k.  The
    two packages' resumed losses agree."""
    jcfg, _, tcfg, tparams = make_pair("olmo-1b")
    kw = dict(total_steps=3, warmup_steps=1)
    data_kw = dict(vocab_size=jcfg.vocab_size, seq_len=16, global_batch=2,
                   seed=0)
    jd, td = str(tmp_path / "ref"), str(tmp_path / "port")

    # the reference
    jax_train(jcfg, steps=2, batch=2, seq=16, tc=JaxTrainConfig(**kw),
              ckpt_dir=jd, verbose=False)
    _, jl = jax_train(jcfg, steps=3, batch=2, seq=16,
                      tc=JaxTrainConfig(**kw), ckpt_dir=jd, verbose=False)
    init, step = jax_make_train_step(jcfg, JaxTrainConfig(**kw))
    restored = JaxManager(jd).restore(
        jax.eval_shape(init, jax.random.PRNGKey(0)), step=2)
    batches = JaxSyntheticLM(JaxDataConfig(**data_kw)).batches()
    jstep = jax.jit(step)
    losses = [float(jstep(restored, {k: jax.numpy.asarray(v) for k, v in
                                     next(batches).items()})[1]["loss"])
              for _ in range(3)]
    assert len(jl) == 1 and jl[0] == losses[0] and jl[0] != losses[2]

    # the port, from the reference's initial parameters
    train(tcfg, steps=2, batch=2, seq=16, tc=TrainConfig(**kw), ckpt_dir=td,
          params=tparams, device="cpu", verbose=False)
    _, tl = train(tcfg, steps=3, batch=2, seq=16, tc=TrainConfig(**kw),
                  ckpt_dir=td, device="cpu", verbose=False)
    _, tstep = make_train_step(tcfg, TrainConfig(**kw), device="cpu")
    trestored = CheckpointManager(td).restore(
        state_template(tcfg, TrainConfig(**kw)), step=2, device="cpu")
    batches = SyntheticLM(DataConfig(**data_kw)).batches()
    tlosses = [float(tstep(trestored, to_device(next(batches), "cpu"))[1]
                     ["loss"]) for _ in range(3)]
    assert len(tl) == 1 and tl[0] == tlosses[0] and tl[0] != tlosses[2]
    np.testing.assert_allclose(tl, jl, **LOSS)


def test_launch_train_resume_matches_reference_losses(tmp_path):
    """``train`` to step 4 with checkpoints, then again to step 6: the port
    restores step 4 and trains steps 5-6 on batches 0-1, as the reference
    does; every loss within 1e-5 of the reference's."""
    jcfg, _, tcfg, tparams = make_pair("olmo-1b")
    kw = dict(total_steps=6, warmup_steps=1, n_micro=2)
    run = dict(batch=4, seq=32, verbose=False)
    jd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    _, j1 = jax_train(jcfg, steps=4, tc=JaxTrainConfig(**kw), ckpt_dir=jd,
                      ckpt_every=2, **run)
    _, j2 = jax_train(jcfg, steps=6, tc=JaxTrainConfig(**kw), ckpt_dir=jd,
                      **run)
    _, t1 = train(tcfg, steps=4, tc=TrainConfig(**kw), ckpt_dir=td,
                  ckpt_every=2, params=tparams, device="cpu", **run)
    assert latest_step(td) == 4
    _, t2 = train(tcfg, steps=6, tc=TrainConfig(**kw), ckpt_dir=td,
                  device="cpu", **run)
    assert len(t2) == 2 and latest_step(td) == 6
    np.testing.assert_allclose(t1 + t2, j1 + j2, **LOSS)
    # the resumed run's first two losses are batches 0 and 1 again
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd)) == [
        "step_2", "step_4", "step_6"]
