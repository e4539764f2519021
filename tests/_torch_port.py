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
    """A JAX parameter tree as nested dicts of numpy arrays: floating leaves
    as float32 (bfloat16 included), integer leaves as they are."""
    def leaf(x):
        if jax.numpy.issubdtype(x.dtype, jax.numpy.integer):
            return np.asarray(x)
        return np.asarray(x, np.float32)
    return jax.tree.map(leaf, tree)


def make_pair(arch: str, *, dtype: str = "float32", seed: int = 0,
              jitter: float = 0.0):
    """(jax cfg, jax params, port cfg, port params) for reduced ``arch``.

    The JAX package initialises; the port receives the same numbers.  With
    ``jitter`` the leaves that initialise to constants (norm scales, biases)
    are perturbed from a numpy seed so that a test can tell them apart from
    their defaults."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    jparams = jax_init_model(jcfg, jax.random.PRNGKey(seed))
    if jitter:
        rng = np.random.default_rng(seed)
        jparams = jax.tree.map(
            lambda x: (x + jitter * rng.standard_normal(x.shape)
                       ).astype(x.dtype), jparams)
    tparams = from_jax_params(to_numpy(jparams), tcfg, device="cpu")
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
