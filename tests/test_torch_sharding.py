"""The port's sharding rules against the JAX package's, on the CPU: logical
axes of every config's parameters, divisibility dropping, and the specs of
whole train states, batches, caches and logits, resolved on the port's
meshes of ranks and on the reference's ``AbstractMesh`` of the same shape
(no devices needed on either side), compared leaf by leaf and element by
element.

States are shapes only: the reference's by ``jax.eval_shape``, the port's
on the ``meta`` device (``launch.train.state_template``), so full-size
configs cost nothing.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JaxNamedSharding

from repro.configs.registry import get_config as jax_get_config
from repro.launch import shardings as jax_sh
from repro.models import transformer as jax_tf
from repro.models.common import logical_axes as jax_logical_axes
from repro.models.common import tree_paths as jax_tree_paths
from repro.models.registry import init_model as jax_init_model
from repro.models.sharding import resolve_rules as jax_resolve_rules
from repro.models.sharding import spec_for_axes as jax_spec_for_axes
from repro.train.step import TrainConfig as JaxTrainConfig
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.checkpoint.sharded import _flatten
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import make_mesh, single_device_mesh
from repro_torch.launch.train import state_template, train
from repro_torch.models import transformer
from repro_torch.models.common import (cast_tree, logical_axes,
                                       logical_axes_for_path, tree_paths)
from repro_torch.models.registry import init_model
from repro_torch.models.sharding import (P, placements, resolve_rules,
                                         spec_for_axes)
from repro_torch.train.step import TrainConfig

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "pod2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
MOE = ("qwen2-moe-a2.7b", "grok-1-314b")


def _meshes(name):
    shape, axes = MESHES[name] if name in MESHES else name
    return make_mesh(shape, axes), AbstractMesh(shape, axes)


def _cfgs(arch, reduced=True, parallelism=None):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    if parallelism is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, parallelism=parallelism))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, parallelism=parallelism))
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_state_shapes(arch, reduced, moments, parallelism=None):
    jcfg, _ = _cfgs(arch, reduced, parallelism)
    init, _ = jax_make_train_step(jcfg, JaxTrainConfig(**dict(moments)))
    return jax.eval_shape(init, jax.random.PRNGKey(0))


def _jax_specs(tree) -> dict:
    return {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JaxNamedSharding))[0]}


def _port_specs(tree) -> dict:
    return {k: tuple(s.spec) for k, s in _flatten(tree).items()}


def _assert_train_state_specs(arch, mesh, ruleset, moments, reduced=True,
                              parallelism=None):
    jcfg, tcfg = _cfgs(arch, reduced, parallelism)
    tmesh, jmesh = _meshes(mesh)
    moments = tuple(sorted(moments.items()))
    want = _jax_specs(jax_sh.train_state_shardings(
        _jax_state_shapes(arch, reduced, moments, parallelism), jcfg, jmesh,
        ruleset))
    got = _port_specs(sh.train_state_shardings(
        state_template(tcfg, TrainConfig(**dict(moments))), tcfg, tmesh,
        ruleset))
    assert list(got) == list(want)
    assert got == want


INT8 = dict(moment_dtype="int8", grad_compress=True)


@pytest.mark.parametrize("ruleset", ["tp_dp", "fsdp_tp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_state_shardings_match_reference(arch, mesh, ruleset):
    """int8 moments (``QTensor``: ``q`` and ``scale`` specs) and error
    feedback; the MoE configs with their own parallelism (EP for
    qwen2-moe-a2.7b, TP for grok-1-314b)."""
    _assert_train_state_specs(arch, mesh, ruleset, INT8)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", MOE)
def test_train_state_shardings_with_expert_parallelism_flipped(arch, mesh):
    """The MoE configs with ``ep`` and ``tp`` swapped, under both rule-sets
    and f32 moments."""
    flip = {"ep": "tp", "tp": "ep"}[get_config(arch).moe.parallelism]
    for ruleset in ("tp_dp", "fsdp_tp"):
        _assert_train_state_specs(arch, mesh, ruleset, {}, parallelism=flip)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_size_train_state_shardings_on_the_production_mesh(arch):
    """Every config at full size, its own moment dtype and the default
    rule-set, on (16, 16)."""
    cfg = get_config(arch)
    assert sh.default_ruleset(cfg) == jax_sh.default_ruleset(
        jax_get_config(arch))
    assert sh.use_ep(cfg) == jax_sh.use_ep(jax_get_config(arch))
    _assert_train_state_specs(arch, ((16, 16), ("data", "model")), None,
                              dict(moment_dtype=cfg.moment_dtype),
                              reduced=False)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_axes_match_reference(arch):
    """The port of ``test_logical_axes_cover_all_params``: every leaf of
    every config's reduced tree gets the reference's logical axes, of the
    leaf's rank."""
    jcfg, tcfg = _cfgs(arch)
    jshapes = jax.eval_shape(lambda k: jax_init_model(jcfg, k),
                             jax.random.PRNGKey(0))
    params = init_model(tcfg, device="meta")
    want = dict(jax_tree_paths(jax_logical_axes(jshapes)))
    got = dict(tree_paths(logical_axes(params)))
    assert got == want
    for path, leaf in tree_paths(params):
        assert len(got[path]) == leaf.ndim, (path, got[path], leaf.shape)
    assert logical_axes_for_path("blocks/0/attn/wq", 4) == (
        "layers", "embed", "q_heads", "head")
    assert logical_axes_for_path("nothing/known", 2) == (None, None)


@pytest.mark.parametrize("mesh", list(MESHES) + ["16x16"])
def test_spec_divisibility_dropping(mesh):
    """The port of ``test_spec_divisibility_dropping``, over shapes that
    divide and shapes that do not."""
    if mesh == "16x16":
        mesh = ((16, 16), ("data", "model"))
    tmesh, jmesh = _meshes(mesh)
    for ruleset in ("tp_dp", "fsdp_tp"):
        for ep in (False, True):
            rules = resolve_rules(ruleset, tmesh, ep=ep)
            jrules = jax_resolve_rules(ruleset, jmesh, ep=ep)
            assert rules == jrules
            for axes in [("embed", "kv_heads", "head"), ("vocab", "embed"),
                         ("layers", "experts", "embed", "expert_ff"),
                         ("embed", "embed"), (None, "ff")]:
                for shape in [(64, 8, 16, 4), (12, 6, 3, 5), (32, 16, 1, 2),
                              (7, 7, 7, 7)]:
                    shp = shape[:len(axes)]
                    got = spec_for_axes(axes, rules, shape=shp, mesh=tmesh)
                    want = jax_spec_for_axes(axes, jrules, shape=shp,
                                             mesh=jmesh)
                    assert tuple(got) == tuple(want), (axes, shp)
                assert tuple(spec_for_axes(axes, rules)) == tuple(
                    jax_spec_for_axes(axes, jrules))
    one = single_device_mesh()
    spec = spec_for_axes(("embed", "kv_heads", "head"),
                         resolve_rules("tp_dp", one), shape=(64, 8, 16),
                         mesh=one)
    assert spec == P(None, "model", None)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_logits_shardings_match_reference(mesh):
    tmesh, jmesh = _meshes(mesh)
    for B in (1, 2, 6, 8):
        shapes = {"tokens": np.zeros((B, 16), np.int32),
                  "labels": np.zeros((B, 16), np.int32),
                  "frames": np.zeros((B, 30, 8), np.float32),
                  "scalar": np.zeros((), np.int32)}
        got = sh.batch_shardings(shapes, tmesh)
        want = jax_sh.batch_shardings(
            {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
             for k, v in shapes.items()}, jmesh)
        assert {k: tuple(v.spec) for k, v in got.items()} == {
            k: tuple(v.spec) for k, v in want.items()}
        for vocab in (256, 257, 50304):
            assert tuple(sh.logits_sharding(tmesh, vocab, B).spec) == tuple(
                jax_sh.logits_sharding(jmesh, vocab, B).spec)
    assert tuple(sh.replicated(tmesh).spec) == tuple(
        jax_sh.replicated(jmesh).spec) == ()


CACHE_ARCHS = ("olmo-1b", "llama3-8b", "qwen2-moe-a2.7b", "recurrentgemma-9b",
               "xlstm-1.3b", "llava-next-34b")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_shardings_match_reference(arch, mesh):
    """Each decode-state leaf's spec depends on its shape only; the two
    packages nest their caches differently, so the (shape, spec) pairs are
    compared as multisets."""
    jcfg, tcfg = _cfgs(arch)
    tmesh, jmesh = _meshes(mesh)
    for batch in (4, 6):
        jc = jax.eval_shape(lambda: jax_tf.init_caches(jcfg, batch, 32))
        tc = transformer.init_caches(tcfg, batch, 32, device="meta")
        jspecs = jax.tree.leaves(
            jax_sh.cache_shardings(jc, jcfg, jmesh, batch),
            is_leaf=lambda x: isinstance(x, JaxNamedSharding))
        want = sorted((tuple(x.shape), repr(tuple(s.spec)))
                      for x, s in zip(jax.tree.leaves(jc), jspecs))
        got = sorted((tuple(x.shape), repr(tuple(s.spec))) for (_, x), (_, s)
                     in zip(tree_paths(tc), tree_paths(
                         sh.cache_shardings(tc, tcfg, tmesh, batch))))
        assert got == want


def test_placements_map_specs_to_shard_and_replicate():
    from torch.distributed.tensor import Replicate, Shard
    m42 = make_mesh((4, 2), ("data", "model"))
    assert placements(P(None, "model"), m42) == (Replicate(), Shard(1))
    assert placements(P("data", None, "model"), m42) == (Shard(0), Shard(2))
    assert placements(P(), m42) == (Replicate(), Replicate())
    pod = make_mesh((2, 2, 2), ("pod", "data", "model"))
    assert placements(P(("pod", "data"), None), pod) == (
        Shard(0), Shard(0), Replicate())
    # a whole train state's specs all map
    cfg = get_config("olmo-1b").reduced()
    for s in _flatten(sh.train_state_shardings(
            state_template(cfg, TrainConfig(**INT8)), cfg, m42)).values():
        assert len(placements(s.spec, m42)) == 2


def test_cast_tree_casts_floating_leaves_only():
    import torch
    tree = {"a": torch.ones(2, dtype=torch.float32),
            "b": {"c": torch.ones(2, dtype=torch.int32),
                  "d": torch.ones(3, dtype=torch.bfloat16)}}
    out = cast_tree(tree, torch.bfloat16)
    assert out["a"].dtype == torch.bfloat16
    assert out["b"]["c"].dtype == torch.int32
    assert out["b"]["d"].dtype == torch.bfloat16


def test_launch_train_takes_a_mesh_of_one_rank_and_refuses_more():
    cfg = get_config("olmo-1b").reduced()
    _, losses = train(cfg, steps=1, batch=2, seq=8, device="cpu",
                      mesh=single_device_mesh(), verbose=False)
    assert len(losses) == 1 and np.isfinite(losses[0])
    # more ranks need a process group to hold them (one process a rank:
    # tests/test_torch_mesh_train.py)
    with pytest.raises(RuntimeError, match="no process group"):
        train(cfg, steps=1, batch=2, seq=8, device="cpu",
              mesh=make_mesh((4, 2), ("data", "model")), verbose=False)
