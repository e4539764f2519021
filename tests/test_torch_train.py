"""The port's training path against the JAX package's, on the CPU:
``lm_loss``, ``train_loss`` with its gradients, one ``make_train_step``
step and three steps of ``launch.train``.

Parameters are initialised by the JAX package and converted (a jitter from
a numpy seed sets the constant leaves apart); tokens, labels and frames are
made with numpy.  Everything runs in float32 on reduced configs, where the
two sides differ only in the order of their f32 sums, and the port's
attention backward is the plain version of the backward kernel (the
reference differentiates its jnp attention by autodiff).

Tolerances (measured worst cases ~1e-6 of the quantity's scale):
* loss and metrics: 1e-5 relative;
* each gradient leaf: 1e-4 of that leaf's largest |g| plus 1e-6 of the
  tree's largest |g| (leaves whose true gradient is zero, the key biases
  under softmax's shift invariance, read ~1e-10 on both sides);
* the error feedback of gradient compression: 1e-6, except for the few
  int8 codes that round the other way (see the test);
* updated params after one AdamW step: 1e-5 absolute, except where the
  reference's |g| < 1e-6 of the leaf's largest: Adam's first step is about
  lr * sign(g), and a gradient within rounding of zero can take the other
  sign in the other package and move the parameter by 2 lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import make_pair
from repro.launch.train import train as jax_train
from repro.models import registry as jax_registry
from repro.models import transformer as jax_tf
from repro.optim.optimizers import adamw_init as jax_adamw_init
from repro.optim.optimizers import AdamWConfig as JaxAdamWConfig
from repro.train.step import TrainConfig as JaxTrainConfig
from repro.train.step import TrainState as JaxTrainState
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train
from repro_torch.models import registry, transformer
from repro_torch.models.common import (tree_leaves, tree_map, tree_paths,
                                       tree_unflatten)
from repro_torch.optim.optimizers import dequantize
from repro_torch.train.step import TrainConfig, make_train_step

LOSS = dict(rtol=1e-5, atol=1e-6)


def _keystr(path: str) -> str:
    return "".join(f"['{k}']" for k in path.split("/"))


def _jax_leaves(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def assert_grads_close(tgrads, jgrads, rel=1e-4, floor=1e-6):
    ref = _jax_leaves(jgrads)
    top = max(np.abs(v).max() for v in ref.values())
    paths = tree_paths(tgrads)
    assert sorted(_keystr(p) for p, _ in paths) == sorted(ref)
    for path, g in paths:
        want = ref[_keystr(path)]
        got = g.detach().float().numpy()
        assert got.shape == want.shape, path
        np.testing.assert_allclose(
            got, want, rtol=0, err_msg=path,
            atol=rel * np.abs(want).max() + floor * top)


def _batch(cfg, rng, B=2, S=40, masked=3, frames=24):
    toks = rng.integers(2, cfg.vocab_size, (B, S))
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    labels[0, :masked] = -1
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    if cfg.is_encoder_decoder:
        fr = rng.standard_normal((B, frames, cfg.d_model)).astype(np.float32)
        jb["frames"], tb["frames"] = jnp.asarray(fr), torch.as_tensor(fr)
    return jb, tb


def _grads_of(loss_fn, params):
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(live)
    leaves = tree_leaves(live)
    g = torch.autograd.grad(loss, leaves, allow_unused=True)
    g = [torch.zeros_like(p) if x is None else x for p, x in zip(leaves, g)]
    return loss, metrics, tree_unflatten(params, g)


# ---------------------------------------------------------------------------
# lm_loss and train_loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [16, 512])
def test_lm_loss_matches_reference(chunk):
    """Chunked at 16 over 40 positions (a ragged last chunk) and in one
    chunk; masked labels (-1) are left out of the mean."""
    jcfg, jparams, tcfg, tparams = make_pair("olmo-1b", jitter=0.02)
    rng = np.random.default_rng(1)
    jb, tb = _batch(tcfg, rng)
    h = rng.standard_normal((2, 40, tcfg.d_model)).astype(np.float32)
    got = transformer.lm_loss(tparams, tcfg, torch.as_tensor(h),
                              tb["labels"], chunk=chunk)
    want = jax_tf.lm_loss(jparams, jcfg, jnp.asarray(h), jb["labels"],
                          chunk=chunk)
    np.testing.assert_allclose(got.item(), float(want), **LOSS)
    mask = np.ones((2, 40), np.float32)
    mask[1, 10:] = 0
    got = transformer.lm_loss(tparams, tcfg, torch.as_tensor(h),
                              tb["labels"], chunk=chunk,
                              mask=torch.as_tensor(mask))
    want = jax_tf.lm_loss(jparams, jcfg, jnp.asarray(h), jb["labels"],
                          chunk=chunk, mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.item(), float(want), **LOSS)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-moe-a2.7b",
                                  "recurrentgemma-9b", "xlstm-1.3b",
                                  "whisper-small"])
def test_train_loss_and_gradients_match_reference(arch):
    """Dense, MoE (aux losses weighted in), RG-LRU (through the out-of-place
    ``linear_scan``) with windowed attention, xLSTM, and the
    encoder-decoder: loss, metrics and every leaf's gradient."""
    jcfg, jparams, tcfg, tparams = make_pair(arch, jitter=0.02)
    jb, tb = _batch(tcfg, np.random.default_rng(0))
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jax_registry.train_loss(p, jcfg, jb, loss_chunk=16),
        has_aux=True)(jparams)
    tl, tm, tg = _grads_of(
        lambda p: registry.train_loss(p, tcfg, tb, loss_chunk=16), tparams)
    np.testing.assert_allclose(tl.item(), float(jl), **LOSS)
    assert set(tm) == set(jm)
    for k in tm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), **LOSS)
    if tcfg.moe is not None:
        assert tm["lb_loss"].item() > 0 and tm["z_loss"].item() > 0
    assert_grads_close(tg, jg)


@pytest.mark.parametrize("arch,fields", [
    ("recurrentgemma-9b", {"d_head": 256}), ("olmo-1b", {"d_head": 64})],
    ids=["recurrentgemma-d256", "olmo-d64"])
def test_backward_head_dims_of_the_card_match_reference(arch, fields):
    """The head dims the attention backward now takes on the card, through
    the training path in float32 (its f32 tiles, ``ops.bwd_blocks``):
    recurrentgemma-9b at head_dim 256 with MQA and its window of 32 (40
    positions, so the window cuts), olmo-1b at 64.  The loss and every
    gradient against ``jax.value_and_grad`` of the reference."""
    jcfg, jparams, tcfg, tparams = make_pair(arch, jitter=0.02, **fields)
    assert transformer.attention_layers(tcfg) > 0
    assert tcfg.head_dim == fields["d_head"]
    jb, tb = _batch(tcfg, np.random.default_rng(4))
    (jl, _), jg = jax.value_and_grad(
        lambda p: jax_registry.train_loss(p, jcfg, jb, loss_chunk=16),
        has_aux=True)(jparams)
    calls = []
    saved = flash_ops.flash_attention_bwd_atom

    def bwd(q, *a, **kw):
        calls.append((q.dtype, q.shape[-1]))
        return saved(q, *a, **kw)

    flash_ops.flash_attention_bwd_atom = bwd
    try:
        tl, _, tg = _grads_of(
            lambda p: registry.train_loss(p, tcfg, tb, loss_chunk=16),
            tparams)
    finally:
        flash_ops.flash_attention_bwd_atom = saved
    assert calls and set(calls) == {(torch.float32, fields["d_head"])}
    np.testing.assert_allclose(tl.item(), float(jl), **LOSS)
    assert_grads_close(tg, jg)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_gradients_of_no_remat(remat):
    """``remat`` changes what the backward recomputes, not its result: the
    same gradients as without it (to f32 rounding), and as the reference's
    own ``remat``."""
    jcfg, jparams, tcfg, tparams = make_pair("olmo-1b", jitter=0.02)
    jb, tb = _batch(tcfg, np.random.default_rng(2))
    _, _, base = _grads_of(lambda p: registry.train_loss(p, tcfg, tb),
                           tparams)
    tl, _, tg = _grads_of(
        lambda p: registry.train_loss(p, tcfg, tb, remat=remat), tparams)
    for (path, a), b in zip(tree_paths(base), tree_leaves(tg)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=path)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jax_registry.train_loss(p, jcfg, jb, remat=remat),
        has_aux=True)(jparams)
    np.testing.assert_allclose(tl.item(), float(jl), **LOSS)
    assert_grads_close(tg, jg)


def test_remat_recomputes_the_forward_attention():
    """Launch counts on the CPU path: none / dots launch the attention
    forward once a layer, full twice (the recompute); the backward once a
    layer in each."""
    _, _, tcfg, tparams = make_pair("olmo-1b")
    _, tb = _batch(tcfg, np.random.default_rng(3))
    counts = {}
    saved = (flash_ops.flash_attention_atom,
             flash_ops.flash_attention_bwd_atom)
    calls = {"fwd": 0, "bwd": 0}

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return saved[0](*a, **kw)

    def bwd(*a, **kw):
        calls["bwd"] += 1
        return saved[1](*a, **kw)

    flash_ops.flash_attention_atom, flash_ops.flash_attention_bwd_atom = (
        fwd, bwd)
    try:
        for remat in ("none", "full", "dots"):
            calls.update(fwd=0, bwd=0)
            _grads_of(lambda p: registry.train_loss(p, tcfg, tb,
                                                    remat=remat), tparams)
            counts[remat] = dict(calls)
    finally:
        (flash_ops.flash_attention_atom,
         flash_ops.flash_attention_bwd_atom) = saved
    L = tcfg.n_layers
    assert counts["none"] == {"fwd": L, "bwd": L}
    assert counts["full"] == {"fwd": 2 * L, "bwd": L}
    assert counts["dots"]["bwd"] == L


def test_remat_refuses_an_unknown_policy():
    _, _, tcfg, tparams = make_pair("olmo-1b")
    _, tb = _batch(tcfg, np.random.default_rng(3))
    with pytest.raises(ValueError, match="remat"):
        registry.train_loss(tparams, tcfg, tb, remat="some")


def test_forward_returns_moe_aux_losses_and_serving_keeps_no_grad():
    jcfg, jparams, tcfg, tparams = make_pair("qwen2-moe-a2.7b")
    jb, tb = _batch(tcfg, np.random.default_rng(4))
    h, (lb, zl) = transformer.forward(tparams, tcfg, tb["tokens"])
    jh, (jlb, jzl) = jax_tf.forward(jparams, jcfg, jb["tokens"])
    np.testing.assert_allclose(lb.item(), float(jlb), **LOSS)
    np.testing.assert_allclose(zl.item(), float(jzl), **LOSS)
    live = tree_map(lambda p: p.detach().requires_grad_(True), tparams)
    logits, _ = registry.serve_prefill(live, tcfg, tb, max_len=48)
    assert not logits.requires_grad
    logits, _ = transformer.prefill(live, tcfg, tb["tokens"])
    assert not logits.requires_grad


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

def _jax_state(jcfg, jparams, tc):
    opt = jax_adamw_init(jparams, JaxAdamWConfig(
        lr=tc.lr, weight_decay=tc.weight_decay, grad_clip=tc.grad_clip,
        moment_dtype=tc.moment_dtype))
    err = (jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jparams)
           if tc.grad_compress else None)
    return JaxTrainState(jparams, opt, err)


@pytest.mark.parametrize("n_micro,grad_compress,moment_dtype", [
    (1, False, "float32"), (2, False, "float32"), (2, True, "int8"),
    (1, False, "bfloat16")])
def test_one_train_step_matches_reference(n_micro, grad_compress,
                                          moment_dtype):
    """Reduced olmo-1b in f32 from converted params: loss, gradient global
    norm, learning rate, updated params (and the error feedback)."""
    jcfg, jparams, tcfg, tparams = make_pair("olmo-1b", jitter=0.02)
    kw = dict(n_micro=n_micro, grad_compress=grad_compress,
              moment_dtype=moment_dtype, loss_chunk=16, lr=1e-3,
              warmup_steps=2, total_steps=10)
    _, jstep = jax_make_train_step(jcfg, JaxTrainConfig(**kw))
    init, step = make_train_step(tcfg, TrainConfig(**kw), device="cpu")
    jb, tb = _batch(tcfg, np.random.default_rng(5), B=4, S=32)
    jstate = _jax_state(jcfg, jparams, JaxTrainConfig(**kw))
    jnew, jm = jax.jit(jstep)(jstate, jb)
    # the reference's gradients, to mask Adam's sign flips below
    (_, _), jg = jax.value_and_grad(
        lambda p: jax_registry.train_loss(p, jcfg, jb, loss_chunk=16),
        has_aux=True)(jparams)
    tnew, tm = step(init(params=tparams), tb)
    assert set(tm) == set(jm)
    for k in ("loss", "lr", "grad_norm", "ce"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert int(tnew.opt.step) == int(jnew.opt.step) == 1
    ref, gref = _jax_leaves(jnew.params), _jax_leaves(jg)
    for path, p in tree_paths(tnew.params):
        key = _keystr(path)
        g = np.abs(gref[key])
        keep = g >= 1e-6 * g.max()
        np.testing.assert_allclose(p.numpy()[keep], ref[key][keep],
                                   rtol=0, atol=1e-5, err_msg=path)
        assert keep.mean() > 0.5, path
    if grad_compress:
        # the residual is within half an int8 step; a code that rounds the
        # other way (a value within an ulp of a half-step) moves it by one
        # step, twice the largest residual: a few such, the rest to 1e-6
        err = _jax_leaves(jnew.err_fb)
        for path, e in tree_paths(tnew.err_fb):
            want = err[_keystr(path)]
            diff = np.abs(e.numpy() - want)
            assert np.abs(want).max() > 0, path
            assert diff.max() <= 2.01 * np.abs(want).max() + 1e-7, path
            assert (diff > 1e-6).sum() <= max(1, 1e-3 * diff.size), path
    if moment_dtype == "int8":
        mu = tree_leaves(tnew.opt.mu)[0]
        assert mu.q.dtype == torch.int8
        assert torch.isfinite(dequantize(mu)).all()


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_train_step_remat_gives_equal_updates(remat):
    _, _, tcfg, tparams = make_pair("olmo-1b", jitter=0.02)
    _, tb = _batch(tcfg, np.random.default_rng(6), B=2, S=32)
    out = {}
    for r in ("none", remat):
        init, step = make_train_step(tcfg, TrainConfig(remat=r, lr=1e-3),
                                     device="cpu")
        out[r] = step(init(params=tparams), tb)
    (a, ma), (b, mb) = out["none"], out[remat]
    assert ma["grad_norm"].item() == pytest.approx(mb["grad_norm"].item(),
                                                   rel=1e-6)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-6)


def test_train_step_leaves_the_old_state_as_it_was():
    _, _, tcfg, tparams = make_pair("olmo-1b")
    before = tree_map(lambda p: p.clone(), tparams)
    init, step = make_train_step(tcfg, TrainConfig(n_micro=2), device="cpu")
    state = init(params=tparams)
    _, tb = _batch(tcfg, np.random.default_rng(7), B=2, S=16)
    new, _ = step(state, tb)
    for a, b in zip(tree_leaves(state.params), tree_leaves(before)):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(new.params), tree_leaves(before)))
    with pytest.raises(ValueError, match="microbatches"):
        step(state, {k: v[:1] for k, v in tb.items()})


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launch_train_three_steps_match_reference_losses():
    jcfg, jparams, tcfg, tparams = make_pair("olmo-1b")
    kw = dict(total_steps=3, warmup_steps=1, n_micro=2)
    _, jl = jax_train(jcfg, steps=3, batch=4, seq=32,
                      tc=JaxTrainConfig(**kw), seed=0, verbose=False)
    _, tl = train(tcfg, steps=3, batch=4, seq=32, tc=TrainConfig(**kw),
                  seed=0, device="cpu", params=tparams, verbose=False)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert all(np.isfinite(tl)) and tl[-1] < tl[0] + 0.1


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_train_features_converge(moment_dtype):
    """The port of ``test_substrates.test_train_features_converge``."""
    cfg = make_pair("olmo-1b")[2]
    tc = TrainConfig(moment_dtype=moment_dtype, n_micro=2,
                     grad_compress=(moment_dtype == "int8"))
    _, losses = train(cfg, steps=6, batch=4, seq=32, tc=tc, device="cpu",
                      verbose=False)
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] + 0.1


def test_launch_train_cli(capsys, tmp_path):
    train_main(["--reduced", "--device", "cpu", "--steps", "2", "--batch",
                "2", "--seq", "16", "--remat", "full"])
    assert "first loss" in capsys.readouterr().out
    ckpt = tmp_path / "ckpt"
    train_main(["--reduced", "--device", "cpu", "--steps", "2", "--batch",
                "2", "--seq", "16", "--ckpt-dir", str(ckpt)])
    assert "first loss" in capsys.readouterr().out
    assert (ckpt / "step_2" / "COMMIT").exists()
    train_main(["--reduced", "--device", "cpu", "--steps", "2",
                "--ckpt-dir", str(ckpt)])
    assert "nothing to do" in capsys.readouterr().out


def test_train_defaults_to_the_gpu():
    assert not torch.cuda.is_available()
    _, _, tcfg, _ = make_pair("olmo-1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(tcfg, steps=1, batch=2, seq=8, verbose=False)
