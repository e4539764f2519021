"""Shared helpers of the ``test_torch_*`` files: parameters cross from the JAX
package to the port by conversion through numpy, never by seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models.registry import init_model as jax_init_model
from repro_torch.configs.registry import get_config
from repro_torch.convert import from_jax_params


def to_numpy(tree):
    """A JAX parameter tree as nested dicts of numpy arrays, each leaf in its
    own dtype (bfloat16 as numpy's extension dtype of that name)."""
    return jax.tree.map(np.asarray, tree)


def make_pair(arch: str, *, dtype: str = "float32", seed: int = 0,
              jitter: float = 0.0, **fields):
    """(jax cfg, jax params, port cfg, port params) for reduced ``arch``,
    with ``fields`` (``d_head=256``, say) replaced in both configs.

    The JAX package initialises; the port receives the same numbers.  With
    ``jitter`` the leaves that initialise to constants (norm scales, biases)
    are perturbed from a numpy seed so that a test can tell them apart from
    their defaults."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype,
                               **fields)
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                               **fields)
    jparams = jax_init_model(jcfg, jax.random.PRNGKey(seed))
    if jitter:
        rng = np.random.default_rng(seed)
        jparams = jax.tree.map(
            lambda x: (x + jitter * rng.standard_normal(x.shape)
                       ).astype(x.dtype), jparams)
    tparams = from_jax_params(to_numpy(jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def normal_pair(rng, shape, dtype="float32"):
    """(torch tensor, JAX array) of the same standard-normal numbers from
    numpy; for bfloat16 the values are rounded once (by torch) and handed to
    JAX already representable."""
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        t = torch.from_numpy(x).to(torch.bfloat16)
        return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return torch.from_numpy(x), jnp.asarray(x)


def as_np(x):
    """A torch tensor or JAX array as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def ref_state(kind: str, st) -> dict:
    """A block cache of the JAX package (a dict, a tuple or a ``NamedTuple``)
    as the port's dict of named leaves."""
    if kind == "attn":
        return dict(st)
    if kind == "rec":
        h, conv = st
        return {"h": h, "conv": conv}
    if kind == "mlstm":
        inner, conv = st
        return {"C": inner.C, "n": inner.n, "m": inner.m, "conv": conv}
    if kind == "slstm":
        return {"c": st.c, "n": st.n, "h": st.h, "m": st.m}
    raise ValueError(kind)


def assert_states_close(port: dict, ref: dict, *, rtol, atol, upto=None):
    """Leaf by leaf: the same names, shapes and (within tolerance) values.
    ``upto`` compares K/V only over the first ``upto`` slots, which the port
    writes while the reference also zeroes the rest."""
    assert set(port) == set(ref), (sorted(port), sorted(ref))
    for name in port:
        a, b = as_np(port[name]), as_np(ref[name])
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if upto is not None and name in ("k", "v"):
            a, b = a[..., :upto, :, :], b[..., :upto, :, :]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


def assert_caches_close(tcaches, jcaches, cfg, *, rtol, atol, upto=None):
    """Every block cache of a model (``groups`` and ``rem``) against the
    reference's, leaf by leaf."""
    pat = cfg.hybrid.pattern if cfg.hybrid is not None else ("attn",)
    assert set(tcaches["groups"]) == set(jcaches["groups"])
    assert set(tcaches["rem"]) == set(jcaches["rem"])
    for pos, c in tcaches["groups"].items():
        assert_states_close(c, ref_state(pat[int(pos)], jcaches["groups"][pos]),
                            rtol=rtol, atol=atol, upto=upto)
    for i, c in tcaches["rem"].items():
        assert_states_close(c, ref_state(pat[int(i)], jcaches["rem"][i]),
                            rtol=rtol, atol=atol, upto=upto)
