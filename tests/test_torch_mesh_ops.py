"""The port's activation constraints against the JAX package's, on the CPU:
``act_spec`` (every ``_ACT_SPECS`` kind) and ``dims_spec`` (every
``shard_dims`` tag) equal the spec that the reference's ``shard_act`` /
``shard_dims`` hand to ``jax.lax.with_sharding_constraint`` (captured by
monkeypatching it), on shapes whose dims divide the mesh axes and shapes
whose dims do not, over (2, 2), (1, 4), (16, 16) and (2, 16, 16) meshes.
Both sides take shapes only; no process group is needed.

Also: ``shard_act`` / ``shard_dims`` / ``local_rows`` / ``local_pointwise``
leave plain tensors alone (with or without a mesh), ``use_mesh`` needs a
process group to build its ``DeviceMesh``,
``kernels/sharded._kv_heads_of`` gives each rank the kv heads its q heads
read, and gradient compression over DTensor gradients takes the whole
leaf's int8 blocks.
"""
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.models import sharding as jax_sharding
from repro_torch.kernels.sharded import _kv_heads_of
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.sharding import (_ACT_SPECS, _current_mesh, act_spec,
                                         dims_spec, local_pointwise,
                                         local_rows, shard_act, shard_dims,
                                         use_mesh)

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# dims that divide every mesh above, and dims that divide none or some
SHAPES = [(64, 32, 48, 16), (3, 5, 40, 7), (32, 6, 8, 128), (2, 4096, 1, 64),
          (512, 1, 24, 3)]
TAGS = [("dp",), ("dp", None, None, None), ("dp", None, None, "tp"),
        (None, "tp"), ("tp", "dp"), (None, None, "dp", "tp"), ("dp", "tp"),
        ()]


def _captured(monkeypatch):
    """Makes the reference's constraint return the spec it was given."""
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: tuple(s.spec))


def _both(name):
    shape, axes = MESHES[name]
    return make_mesh(shape, axes), AbstractMesh(shape, axes)


def _padded(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("kind", sorted(_ACT_SPECS))
def test_act_spec_is_the_references_constraint(monkeypatch, mesh_name, kind):
    _captured(monkeypatch)
    mesh, jmesh = _both(mesh_name)
    for shape in SHAPES:
        for ndim in (2, 3, 4):
            shp = shape[:ndim]
            want = jax_sharding.shard_act(
                jax.ShapeDtypeStruct(shp, np.float32), kind, jmesh)
            got = act_spec(kind, shp, mesh)
            assert _padded(got, ndim) == _padded(want, ndim), (shp, kind)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_dims_spec_is_the_references_constraint(monkeypatch, mesh_name):
    _captured(monkeypatch)
    mesh, jmesh = _both(mesh_name)
    for shape, tags in itertools.product(SHAPES, TAGS):
        want = jax_sharding.shard_dims(
            jax.ShapeDtypeStruct(shape, np.float32), tags, jmesh)
        assert tuple(dims_spec(tags, shape, mesh)) == want, (shape, tags)


def test_constraints_leave_plain_tensors_alone():
    x = torch.randn(4, 8, 6)
    mesh = make_mesh((2, 2), ("data", "model"))
    assert _current_mesh() is None
    assert shard_act(x, "act_btd") is x
    assert shard_dims(x, ("dp", None, "tp")) is x
    with use_mesh(None):
        assert shard_act(x, "act_bthd") is x
    # entering a mesh builds its DeviceMesh, which needs a process group
    with pytest.raises(RuntimeError, match="no process group"):
        with use_mesh(mesh, "cpu"):
            pass
    assert _current_mesh() is None
    assert shard_act(x, "act_btv", mesh) is x
    assert torch.equal(local_rows(lambda a, b: a * b, x, 2.0), x * 2.0)
    assert torch.equal(local_pointwise(torch.sigmoid, x), torch.sigmoid(x))


@pytest.mark.parametrize("hq,hk,ranks", [(4, 1, 2), (4, 1, 4), (32, 8, 16),
                                         (12, 4, 4), (12, 3, 4), (40, 8, 8)])
def test_each_rank_gets_the_kv_heads_of_its_q_heads(hq, hk, ranks):
    """q head h reads kv head h // G; a rank holding q heads [r*n, (r+1)*n)
    must get exactly the kv heads those read, in an order that keeps the
    kernel's grouping (local q head j reads local kv head j // G_local)."""
    kv = torch.arange(hk).float().reshape(1, 1, hk, 1)
    group, n = hq // hk, hq // ranks
    for r in range(ranks):
        got = _kv_heads_of(kv, r, n, group, 2)[0, 0, :, 0].long().tolist()
        want = [(r * n + j) // group for j in range(n)]
        g_local = n // len(got)
        assert [got[j // g_local] for j in range(n)] == want, (r, got)


COMPRESS_SCRIPT = """
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim.optimizers import QBLOCK
from repro_torch.train.step import _compress_grads
# rank 1 holds the model axis' second piece; the fake group's gather repeats
# this rank's piece, so each leaf is two equal halves: gathered, it is whole
dist.init_process_group("fake", store=FakeStore(), rank=1, world_size=4)
dm = make_mesh((2, 2), ("data", "model")).device_mesh("cpu")
assert list(dm.get_coordinate()) == [0, 1]
gen = torch.Generator().manual_seed(0)
for w in (100, QBLOCK):
    half = torch.randn(8, w, generator=gen)
    half[:, 0] = 10.0             # each row's largest value opens its piece
    g = torch.cat([half, half], 1)
    e = 1e-3 * torch.cat([torch.randn(8, w, generator=gen)] * 2, 1)
    mine = slice(w, 2 * w)
    pl = [Replicate(), Shard(1)]
    dec, err = _compress_grads(
        {"w": distribute_tensor(g, dm, pl, src_data_rank=None)},
        {"w": distribute_tensor(e, dm, pl, src_data_rank=None)})
    want_dec, want_err = _compress_grads({"w": g}, {"w": e})
    per_shard = _compress_grads({"w": g[:, mine]}, {"w": e[:, mine]})[0]
    print(w, tuple(dec["w"].placements) == tuple(pl),
          tuple(err["w"].placements) == tuple(pl),
          torch.equal(dec["w"].to_local(), want_dec["w"][:, mine]),
          torch.equal(err["w"].to_local(), want_err["w"][:, mine]),
          torch.equal(per_shard["w"], want_dec["w"][:, mine]))
"""


def test_grad_compress_over_a_mesh_takes_the_whole_leafs_blocks():
    """int8 gradient compression of a leaf whose last dim the mesh cuts
    below ``QBLOCK`` (pieces of 100) equals it on the whole leaf, bit for
    bit, decoded gradient and residual alike, each at the gradient's
    placements; blocking each rank's piece would differ.  Pieces of whole
    blocks (``QBLOCK``) are taken as they lie and equal it too.  (In a
    process of its own: one default group a process.)"""
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", COMPRESS_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = [line.split() for line in out.stdout.splitlines()]
    assert rows == [["100", "True", "True", "True", "True", "False"],
                    ["128", "True", "True", "True", "True", "True"]]
