"""The port's optimizer and schedules against the JAX package's, on the CPU.

Inputs are made from a seed with numpy and handed to both sides.

Tolerances:
* int8 codes are compared exactly: both sides divide by the same f32 scale
  and round half to even (``jnp.round``, ``torch.round``).  Only a value
  within an ulp of a half-step could round the other way; such codes are
  allowed to differ by one and are counted (none occur at these seeds).
* scales and dequantized values: 1e-7 relative (the same f32 operations).
* AdamW: 1e-6 relative on params and moments after several steps (the same
  f32 elementwise operations; the global norm sums leaves in the same
  order, the elements within a leaf in another).
* schedules: exact to 1e-7 relative (f32 on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import as_np
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched

SHAPES = [(5,), (128,), (300,), (3, 7), (2, 3, 260), (4, 256)]


def _pair(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(x.copy()), jnp.asarray(x)


def test_qblock_is_the_reference_block():
    assert topt.QBLOCK == jopt.QBLOCK == 128


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_matches_reference(shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    t, j = _pair(rng, shape, scale=3.0)
    tq, jq = topt.quantize(t), jopt.quantize(j)
    assert tq.shape == jq.shape == shape
    assert tuple(tq.q.shape) == jq.q.shape and tq.q.dtype == torch.int8
    np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                               rtol=1e-7)
    diff = np.abs(tq.q.numpy().astype(int) - np.asarray(jq.q).astype(int))
    # a code may differ only where x/scale lies within an ulp of a half
    x = np.pad(t.numpy().reshape(-1, shape[-1]),
               ((0, 0), (0, tq.q.shape[-1] - shape[-1])))
    ratio = (x.reshape(-1, tq.q.shape[-1] // 128, 128)
             / tq.scale.numpy().reshape(-1, tq.q.shape[-1] // 128, 1))
    near_half = np.abs(np.abs(ratio - np.trunc(ratio)) - 0.5) < 1e-6
    assert diff.max() <= 1
    assert not (diff.reshape(near_half.shape) & ~near_half).any()
    np.testing.assert_allclose(as_np(topt.dequantize(tq)),
                               np.asarray(jopt.dequantize(jq)), rtol=1e-7,
                               atol=1e-12)


@pytest.mark.parametrize("n", [1, 127, 128, 129, 1000, 4000])
def test_quantize_roundtrip_error_bound(n):
    """The port of ``test_substrates.test_quantize_roundtrip_error_bound``
    at its block of 128: each value within half a step of its block."""
    x = (np.random.default_rng(n).standard_normal(n) * 7.0).astype(np.float32)
    d = topt.dequantize(topt.quantize(torch.from_numpy(x))).numpy()
    for b in range(-(-n // 128)):
        blk = slice(b * 128, (b + 1) * 128)
        step = np.abs(x[blk]).max() / 127.0
        np.testing.assert_allclose(d[blk], x[blk], atol=step / 2 + 1e-9)


def test_quantize_zeros_and_ties_round_half_to_even():
    z = topt.quantize(torch.zeros(3, 130))
    assert (z.q == 0).all() and torch.equal(z.scale,
                                            torch.full((3, 2), 1e-12))
    # 127 * k / 254 for k = 1, 3, 5: exact halves of the step once scaled
    x = torch.tensor([254.0, 1.0, 3.0, 5.0, -1.0])
    q = topt.quantize(x)
    jq = jopt.quantize(jnp.asarray(x.numpy()))
    assert q.q.tolist()[:5] == np.asarray(jq.q).tolist()[:5]
    assert q.q.tolist()[:5] == [127, 0, 2, 2, 0]


def _tree_pair(rng, dtype="float32"):
    """A small parameter tree as both sides hold one: a stacked matrix, a
    stacked [G, D] norm scale (2-D as stored: decayed), a bias (1-D: not
    decayed) and a 3-D leaf with a ragged last dim."""
    shapes = {"blocks": {"w": (2, 6, 130), "scale": (2, 6)}, "bias": (9,),
              "emb": {"tok": (3, 5, 7)}}

    def build(s):
        if isinstance(s, dict):
            out = {k: build(v) for k, v in s.items()}
            return ({k: v[0] for k, v in out.items()},
                    {k: v[1] for k, v in out.items()})
        x = rng.standard_normal(s).astype(np.float32)
        if dtype == "bfloat16":
            t = torch.from_numpy(x).to(torch.bfloat16)
            return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return torch.from_numpy(x), jnp.asarray(x)

    return build(shapes)


def _assert_tree_close(t, j, **tol):
    if isinstance(t, dict):
        assert set(t) == set(j)
        for k in t:
            _assert_tree_close(t[k], j[k], **tol)
        return
    if isinstance(t, topt.QTensor):
        np.testing.assert_allclose(as_np(topt.dequantize(t)),
                                   np.asarray(jopt.dequantize(j), np.float32),
                                   **tol)
        return
    np.testing.assert_allclose(as_np(t), as_np(j), **tol)


@pytest.mark.parametrize("moment_dtype,param_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"), ("int8", "float32"),
    ("float32", "bfloat16")])
def test_adamw_update_matches_reference(moment_dtype, param_dtype):
    rng = np.random.default_rng(3)
    tp, jp = _tree_pair(rng, param_dtype)
    kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0,
              moment_dtype=moment_dtype)
    tcfg, jcfg = topt.AdamWConfig(**kw), jopt.AdamWConfig(**kw)
    ts, js = topt.adamw_init(tp, tcfg), jopt.adamw_init(jp, jcfg)
    for step in range(4):
        tg, jg = _tree_pair(rng)
        scale = 0.3 if step % 2 else 3.0       # clipped and not
        tg = {k: v for k, v in _scaled(tg, scale).items()}
        jg = jax.tree.map(lambda x: x * scale, jg)
        lr = None if step < 2 else (torch.tensor(5e-3), jnp.float32(5e-3))
        tp, ts, tm = topt.adamw_update(tp, tg, ts, tcfg,
                                       None if lr is None else lr[0])
        jp, js, jm = jopt.adamw_update(jp, jg, js, jcfg,
                                       None if lr is None else lr[1])
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert int(ts.step) == int(js.step) == step + 1
    tol = (dict(rtol=1e-6, atol=1e-6) if param_dtype == "float32"
           else dict(rtol=8e-3, atol=8e-3))     # one bf16 rounding apart
    _assert_tree_close(tp, jp, **tol)
    _assert_tree_close(ts.mu, js.mu, rtol=1e-5, atol=1e-6)
    _assert_tree_close(ts.nu, js.nu, rtol=1e-5, atol=1e-7)
    assert tp["blocks"]["w"].dtype == getattr(torch, param_dtype)


def _scaled(tree, s):
    if isinstance(tree, dict):
        return {k: _scaled(v, s) for k, v in tree.items()}
    return tree * s


def test_weight_decay_by_ndim_as_stored():
    """With zero gradients only the decay moves a parameter: every leaf of
    two or more dims (the stacked [G, D] norm scale too), no 1-D leaf."""
    rng = np.random.default_rng(4)
    tp, _ = _tree_pair(rng)
    zero = {k: _scaled(v, 0.0) for k, v in tp.items()}
    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.5, grad_clip=0.0)
    new, _, _ = topt.adamw_update(tp, zero, topt.adamw_init(tp, cfg), cfg)
    assert torch.equal(new["bias"], tp["bias"])
    for a, b in ((new["blocks"]["scale"], tp["blocks"]["scale"]),
                 (new["blocks"]["w"], tp["blocks"]["w"]),
                 (new["emb"]["tok"], tp["emb"]["tok"])):
        torch.testing.assert_close(a, b * (1 - 0.1 * 0.5))


def test_int8_moments_are_qtensors_in_the_sqrt_domain():
    cfg = topt.AdamWConfig(moment_dtype="int8", grad_clip=0.0)
    p = {"w": torch.ones(2, 200)}
    st = topt.adamw_init(p, cfg)
    g = {"w": torch.full((2, 200), 2.0)}
    _, st, _ = topt.adamw_update(p, g, st, cfg)
    assert isinstance(st.nu["w"], topt.QTensor)
    assert st.nu["w"].q.shape == (2, 256) and st.nu["w"].q.dtype == torch.int8
    # nu = (1 - b2) g^2 = 0.2, stored as sqrt(0.2)
    torch.testing.assert_close(topt.dequantize(st.nu["w"]),
                               torch.full((2, 200), 0.2 ** 0.5))


def test_global_norm_matches_reference():
    rng = np.random.default_rng(5)
    tp, jp = _tree_pair(rng, "bfloat16")
    np.testing.assert_allclose(topt.global_norm(tp).item(),
                               float(jopt.global_norm(jp)), rtol=1e-6)


def test_adamw_quadratic_convergence():
    """The port of ``test_substrates.test_adamw_quadratic_convergence``."""
    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0, grad_clip=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = topt.adamw_init(params, cfg)
    for _ in range(200):
        params, state, _ = topt.adamw_update(params, {"w": 2 * params["w"]},
                                             state, cfg)
    assert float(params["w"].abs().max()) < 0.1


def test_make_optimizer():
    cfg, init, update = topt.make_optimizer("bfloat16", lr=0.5)
    assert cfg.lr == 0.5 and cfg.moment_dtype == "bfloat16"
    p = {"w": torch.ones(3, 4)}
    st = init(p)
    assert st.mu["w"].dtype == torch.bfloat16
    new, st, m = update(p, {"w": torch.ones(3, 4)}, st)
    assert int(st.step) == 1
    assert m["grad_norm"].item() == pytest.approx(12 ** .5)
    assert (new["w"] < 1).all()


@pytest.mark.parametrize("warmup,total", [(1, 10), (10, 100), (100, 10_000),
                                          (0, 50)])
def test_schedules_match_reference(warmup, total):
    for step in sorted({0, 1, warmup - 1, warmup, warmup + 1, total // 2,
                        total - 1, total, total + 7} - {-1}):
        t = tsched.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                   3e-4, total, warmup)
        j = jsched.cosine_schedule(jnp.int32(step), 3e-4, total, warmup)
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.item(), float(j), rtol=1e-7)
        tw = tsched.linear_warmup(step, 3e-4, warmup)
        jw = jsched.linear_warmup(jnp.int32(step), 3e-4, warmup)
        np.testing.assert_allclose(tw.item(), float(jw), rtol=1e-7)
