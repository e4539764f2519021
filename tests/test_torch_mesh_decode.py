"""Decode over a mesh of ranks: the port's ``models/registry.serve_decode``
in 4 gloo processes (one rank each; parameters and caches laid out by
``launch/shardings``, as DTensors) against the JAX package's
``serve_decode`` and against the port's own run on one rank.

f32 reduced configs, the parameters the reference's init crossed by
conversion.  Each rank prefills the prompt alone (every rank alike), then
takes 3 greedy decode steps over the mesh.  Logits are held to the
reference's to 2e-5 and to the one-rank run's to 1e-5; the greedy tokens
must be identical.  Cases: llama3-8b (4 q heads, 1 kv head) on (1, 4) and
(2, 2), where the kv head does not divide ``model`` and the cache is
sharded by sequence (the partial softmax and cross-rank combine of
``kernels/sharded.py``), and on (2, 2) with its weights sharded over
``data`` too (``fsdp_tp``); recurrentgemma-9b on (1, 4), its ring of 32
slots split 4 ways and wrapped by a prompt of 40 tokens; xlstm-1.3b on
(2, 2), whose mLSTM state splits its k dim over ``model``.  No collective
of a decode step may be as large as one layer's local cache or state:
none of them moves it.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import load_params, save_tree, start_ranks, wait_ranks
from repro.configs.registry import get_config as jax_get_config
from repro.models import registry as jax_registry
from repro.models.registry import init_model as jax_init_model
from repro_torch.configs.registry import get_config
from repro_torch.models import registry

STEPS = 3
CASES = [
    dict(name="llama_1x4", arch="llama3-8b", mesh=[1, 4], prompt=20,
         max_len=128),
    dict(name="llama_2x2", arch="llama3-8b", mesh=[2, 2], prompt=20,
         max_len=128),
    # the weights sharded over ``data`` too (FSDP, the rule of the configs
    # above 20 B parameters): a serving product keeps them in place and
    # moves the token's activations (``models/sharding.local_contract``)
    dict(name="llama_2x2_fsdp", arch="llama3-8b", mesh=[2, 2], prompt=20,
         max_len=128, ruleset="fsdp_tp"),
    dict(name="recurrentgemma_1x4", arch="recurrentgemma-9b", mesh=[1, 4],
         prompt=40, max_len=64),
    dict(name="xlstm_2x2", arch="xlstm-1.3b", mesh=[2, 2], prompt=20,
         max_len=64),
]
for c in CASES:
    c.update(kind="decode", axes=["data", "model"], steps=STEPS)


def _reference(cfg, params, tokens, max_len):
    logits, caches = jax_registry.serve_prefill(
        params, cfg, {"tokens": jnp.asarray(tokens)}, max_len=max_len)
    out, toks = [], []
    tok = jnp.argmax(logits, -1)
    for step in range(STEPS):
        logits, caches = jax_registry.serve_decode(
            params, cfg, tok, jnp.int32(tokens.shape[1] + step), caches)
        tok = jnp.argmax(logits, -1)
        out.append(np.asarray(logits))
        toks.append(np.asarray(tok))
    return out, toks


def _one_rank(cfg, params, tokens, max_len):
    logits, caches = registry.serve_prefill(
        params, cfg, {"tokens": torch.from_numpy(tokens)}, max_len=max_len)
    out, toks = [], []
    tok = logits.argmax(-1)
    for step in range(STEPS):
        logits, caches = registry.serve_decode(params, cfg, tok,
                                               tokens.shape[1] + step, caches)
        tok = logits.argmax(-1)
        out.append(logits.numpy())
        toks.append(tok.numpy())
    return out, toks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's gloo job of 4 ranks, and meanwhile the reference's and
    the one-rank runs in this process."""
    d = tmp_path_factory.mktemp("mesh_decode")
    rng = np.random.default_rng(0)
    inits = {}
    for c in CASES:
        jcfg = dataclasses.replace(jax_get_config(c["arch"]).reduced(),
                                   dtype="float32")
        params = jax_init_model(jcfg, jax.random.PRNGKey(0))
        c["params"] = str(d / f"{c['name']}_init.npz")
        save_tree(c["params"], [(jax.tree_util.keystr(p, simple=True,
                                                      separator="/"), x)
                                for p, x in
                                jax.tree_util.tree_flatten_with_path(
                                    params)[0]])
        c["tokens"] = rng.integers(0, jcfg.vocab_size,
                                   (4, c["prompt"])).tolist()
        inits[c["name"]] = (jcfg, params)
    ranks = start_ranks(4, {"cases": CASES, "out": str(d)},
                        str(d / "job.json"))
    expected = {}
    try:
        for c in CASES:
            jcfg, jparams = inits[c["name"]]
            tokens = np.asarray(c["tokens"], np.int32)
            cfg = dataclasses.replace(get_config(c["arch"]).reduced(),
                                      dtype="float32")
            expected[c["name"]] = (
                _reference(jcfg, jparams, tokens, c["max_len"]),
                _one_rank(cfg, load_params(c["params"], cfg),
                          tokens.astype(np.int64), c["max_len"]))
    finally:
        wait_ranks(ranks)
    return d, expected


def _size(kind, result_bytes, group) -> float:
    """The larger of a collective's operand and result on one rank."""
    return result_bytes * group if kind == "reduce-scatter" else result_bytes


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_mesh_decode_matches_the_reference_and_one_rank(runs, case):
    d, expected = runs
    (ref_logits, ref_toks), (one_logits, one_toks) = expected[case["name"]]
    with open(d / f"{case['name']}.json") as f:
        got = json.load(f)
    assert len(got["logits"]) == STEPS
    for step in range(STEPS):
        logits = np.asarray(got["logits"][step], np.float32)
        np.testing.assert_allclose(logits, ref_logits[step], rtol=2e-5,
                                   atol=2e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(logits, one_logits[step], rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {step}")
        assert got["tokens"][step] == ref_toks[step].tolist()
        assert got["tokens"][step] == one_toks[step].tolist()
        sizes = [_size(*op) for op in got["collectives"][step]]
        assert sizes and max(sizes) < got["layer_cache_bytes"], (
            max(sizes), got["layer_cache_bytes"])
