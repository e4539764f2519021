"""The fused AdamW kernels (``csrc/adamw.cu``) on the card, against the
plain route of ``optim/optimizers.py``.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip (the
decision is made inside a fixture, never at import).  Run them on the GPU
machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_adamw_gpu.py

The update kernel repeats the plain route's arithmetic operation for
operation, so given the same clip its parameters and moments are compared
bit for bit.  The norm sums in another order than ``global_norm``: it is held
to 1e-6 of a float64 norm (a sum of squares of ~1e6 values in f32 within a
16-byte vector and f64 beyond drifts ~1e-7 at most), and to its own bits at
a second call.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.configs.registry import get_config
from repro_torch.kernels.adamw import ops as fused
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import optimizers as opt
from repro_torch.train.step import TrainConfig, make_train_step

pytestmark = pytest.mark.gpu

NORM_TOL = 1e-6
LR = 1e-2          # large enough that most bf16 parameters change a step


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _tensor(rng, shape, dtype, dev, scale=1.0, offset=0, positive=False):
    """A contiguous tensor of ``shape``; with ``offset``, a view that many
    elements into a larger buffer (its data not 16-byte aligned)."""
    n = math.prod(shape)
    x = rng.standard_normal(n + offset).astype(np.float32) * scale
    if positive:
        x = np.abs(x)
    t = torch.from_numpy(x).to(dtype).to(dev)
    return t[offset:].view(shape)


def _scalars(step: int, dev, clip: float = 0.731):
    cfg = opt.AdamWConfig()
    stepf = torch.tensor(step, dtype=torch.int32, device=dev).to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=dev), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=dev), stepf)
    return (torch.tensor(LR, device=dev), torch.tensor(clip, device=dev), c1,
            c2)


LEAVES = {
    # name: (shape, offsets of p, g, mu, nu)
    "vector_1d": ((1001,), (0, 0, 0, 0)),          # no decay, 1001 % 8 = 1
    "stacked_3d": ((3, 37, 129), (0, 0, 0, 0)),    # decay, 14319 % 8 = 7
    "unaligned_views": ((5, 203), (1, 3, 2, 5)),   # no operand 16-byte aligned
}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("leaf", list(LEAVES))
@pytest.mark.parametrize("step", [1, 5])
@pytest.mark.parametrize("m_dtype", DTYPES, ids=["mu_f32", "mu_bf16"])
@pytest.mark.parametrize("g_dtype", DTYPES, ids=["g_f32", "g_bf16"])
@pytest.mark.parametrize("p_dtype", DTYPES, ids=["p_f32", "p_bf16"])
def test_update_kernel_bit_equal_to_plain(cuda, p_dtype, g_dtype, m_dtype,
                                          step, leaf):
    shape, (op, og, om, on) = LEAVES[leaf]
    rng = np.random.default_rng(step * 100 + len(shape))
    p = _tensor(rng, shape, p_dtype, cuda, 0.05, op)
    g = _tensor(rng, shape, g_dtype, cuda, 0.3, og)
    if step == 1:                    # a fresh state
        mu = torch.zeros(shape, dtype=m_dtype, device=cuda)
        nu = torch.zeros(shape, dtype=m_dtype, device=cuda)
    else:
        mu = _tensor(rng, shape, m_dtype, cuda, 0.02, om)
        nu = _tensor(rng, shape, m_dtype, cuda, 1e-3, on, positive=True)
    lr, clip, c1, c2 = _scalars(step, cuda)
    cfg = opt.AdamWConfig(moment_dtype=str(m_dtype).split(".")[1])
    olds = [t.clone() for t in (p, g, mu, nu)]
    want = opt.adamw_leaf(p, g, mu, nu, cfg, lr, clip, c1, c2)
    before = fused.launches
    got = fused.update_leaf(p, g, mu, nu, lr=lr, clip=clip, c1=c1, c2=c2,
                            b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                            weight_decay=cfg.weight_decay)
    torch.cuda.synchronize()
    assert fused.launches == before + 1
    for name, a, b in zip(("p", "mu", "nu"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, (a != b).sum().item())
    # the update is functional: the inputs are as they were
    assert all(torch.equal(a, b) for a, b in zip((p, g, mu, nu), olds))
    if p_dtype == torch.bfloat16:    # the comparison sees real updates
        assert (got[0] != p).float().mean() > 0.5


@pytest.mark.parametrize("dtypes", ["float32", "bfloat16", "mixed", "many"])
def test_grad_norm_kernel_against_float64(cuda, dtypes):
    rng = np.random.default_rng(7)
    shapes = [(1,), (7,), (1001,), (3, 37, 129), (1024, 1024), (5, 203)]
    if dtypes == "many":             # more leaves than one launch takes
        shapes = [(int(rng.integers(1, 5000)),) for _ in range(150)]
    leaves = []
    for i, s in enumerate(shapes):
        dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
            dtypes, DTYPES[i % 2])
        leaves.append(_tensor(rng, s, dt, cuda, 10.0 ** (i % 5 - 2),
                              offset=i % 3))
    want = math.sqrt(sum(float(x.double().square().sum()) for x in leaves))
    before = fused.launches
    got = fused.grad_norm(leaves)
    again = fused.grad_norm(leaves)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= NORM_TOL * want
    assert torch.equal(got, again)
    groups = -(-len(leaves) // fused.max_leaves())
    assert fused.launches - before == 2 * (groups + 1)


# the gradients' layouts the update takes: as autograd lays most out, a
# transposed one (a tied embedding's, from autograd on the card), and views
# cut from padded int8 blocks (``grad_compress``: a leaf whose last dim is not
# a multiple of QBLOCK)
GRAD_LAYOUTS = ["contiguous", "transposed", "dequantized"]


@pytest.mark.parametrize("layout", GRAD_LAYOUTS)
def test_adamw_update_on_the_card(cuda, layout):
    """A whole update takes the fused route, whatever the gradients'
    layout: launches as ``launches_per_step`` says, the old state unwritten,
    and every leaf bit-equal to the plain route's given the kernel's clip."""
    cfg = opt.AdamWConfig()
    rng = np.random.default_rng(3)
    shapes = {"emb": (300, 64), "blocks": {"w": (4, 64, 96), "s": (4, 64)},
              "norm": (64,)}
    params = tree_map(lambda s: _tensor(rng, s, torch.bfloat16, cuda, 0.05),
                      shapes)
    grads = tree_map(lambda s: _tensor(rng, s, torch.bfloat16, cuda, 0.3),
                     shapes)
    if layout == "transposed":
        grads["emb"] = _tensor(rng, (64, 300), torch.bfloat16, cuda, 0.3).t()
    elif layout == "dequantized":
        grads = tree_map(lambda g: opt.quantize_roundtrip(g.float()), grads)
        assert not grads["emb"].is_contiguous()
    state = opt.adamw_init(params, cfg)
    assert opt.fused_route(params, grads, state, cfg)
    params, state, _ = opt.adamw_update(params, grads, state, cfg)
    state_leaves = [*tree_leaves(params), *tree_leaves(state.mu),
                    *tree_leaves(state.nu)]
    olds = [t.clone() for t in state_leaves]
    n = len(tree_leaves(params))
    before = fused.launches
    lr = torch.tensor(LR, device=cuda)
    new_p, new_s, m = opt.adamw_update(params, grads, state, cfg, lr)
    torch.cuda.synchronize()
    assert fused.launches - before == fused.launches_per_step(n) == n + 2
    assert all(torch.equal(a, b) for a, b in zip(state_leaves, olds))
    assert int(new_s.step) == 2
    gnorm = m["grad_norm"]
    want_norm = opt.global_norm(grads)
    assert abs(float(gnorm) - float(want_norm)) <= NORM_TOL * float(want_norm)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    _, _, c1, c2 = _scalars(2, cuda)
    for p, g, mu, nu, a, b, c in zip(
            *(tree_leaves(t) for t in (params, grads, state.mu, state.nu,
                                       new_p, new_s.mu, new_s.nu))):
        want = opt.adamw_leaf(p, g, mu, nu, cfg, lr, clip, c1, c2)
        assert all(torch.equal(x, y) for x, y in zip((a, b, c), want))


@pytest.mark.parametrize("grad_compress", [False, True],
                         ids=["plain_grads", "grad_compress"])
def test_train_step_counts_fused_leaves(cuda, grad_compress):
    """The trainer's steps go through the kernels, with f32 moments and
    with int8-compressed gradients too (the reduced config's leaves are 64
    wide: their dequantized gradients are views cut from padded blocks), and
    the ``train.optimizer`` span counts the leaves they updated."""
    # head_dim 64: one the attention backward takes on the card
    cfg = dataclasses.replace(get_config("olmo-1b").reduced(), d_head=64)
    init_state, train_step = make_train_step(
        cfg, TrainConfig(grad_compress=grad_compress), device=cuda)
    state = init_state(seed=0)
    n = len(tree_leaves(state.params))
    assert all(m.dtype == torch.float32 for m in tree_leaves(state.opt.mu))
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 64)),
                                device=cuda) for k in ("tokens", "labels")}
    before = fused.launches
    state, _ = train_step(state, batch)
    spans.clear()
    with torch.profiler.profile():
        state, m = train_step(state, batch)
    torch.cuda.synchronize()
    assert fused.launches - before == 2 * fused.launches_per_step(n)
    rec = [r for r in spans.records() if r["name"] == "train.optimizer"]
    assert len(rec) == 1 and rec[0]["attrs"]["fused"] == n
    assert math.isfinite(float(m["loss"]))
    assert all(torch.isfinite(p.float()).all() for p in
               tree_leaves(state.params))
