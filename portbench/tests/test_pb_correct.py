"""The check that decides ``correct``, on the CPU at tiny sizes: the port
against the plain reference comes out correct, and each fault a cell can
have, planted under the timed path, comes out not correct."""
import pytest
import torch

from portbench import reference
from portbench.tests import _pb_tiny as tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("pb"))


@pytest.mark.parametrize("workload", [tiny.SERVE, tiny.TRAIN, tiny.ACCUM])
def test_sound_runs_are_correct(root, workload):
    res = tiny.run_cell(root, workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def test_fp8_control_fails_a_number(root):
    for w in (tiny.SERVE, tiny.TRAIN):
        res = tiny.run_cell(root, w, extra=("--control", "fp8"))
        assert res["program"]["correct"], res["program"]["checks"]
        assert not res["correct"], res["checks"]


def _altered_token(monkeypatch):
    from repro_torch.serve import engine
    orig = engine.SlotServer._decode

    def decode(self):
        return (orig(self) + 1) % self.cfg.vocab_size

    monkeypatch.setattr(engine.SlotServer, "_decode", decode)


def _cache_unchanged(monkeypatch):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "update_kv_cache",
                        lambda k, v, *a, **kw: (k, v))


def _half_the_batch(monkeypatch):
    from repro_torch.models import transformer
    orig = transformer.decode_step

    def decode_step(params, cfg, token, pos, caches, **kw):
        logits, caches = orig(params, cfg, token, pos, caches, **kw)
        half = logits.shape[0] // 2         # the first slots are the busiest
        return torch.cat([torch.zeros_like(logits[:half]), logits[half:]]), \
            caches

    monkeypatch.setattr(transformer, "decode_step", decode_step)


@pytest.mark.parametrize("plant", [_altered_token, _cache_unchanged,
                                   _half_the_batch])
def test_serving_faults_are_not_correct(root, monkeypatch, plant):
    plant(monkeypatch)
    res = tiny.run_cell(root, tiny.SERVE, seconds=2.0)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("workload", [tiny.TRAIN, tiny.ACCUM])
def test_training_faults_are_not_correct(root, workload, fault):
    res = tiny.run_cell(root, workload, extra=("--fault", fault))
    assert not res["correct"], res["checks"]


def test_reference_follows_the_port_forward():
    """The plain reference's logits against the port's forward at a tiny
    size (float32 both sides)."""
    import dataclasses
    from repro_torch.configs.olmo_1b import CONFIG
    from repro_torch.models import transformer
    from portbench import weights
    for norm, tie in (("nonparam_ln", True), ("rmsnorm", False)):
        cfg = dataclasses.replace(CONFIG.reduced(), norm=norm,
                                  tie_embeddings=tie, dtype="float32",
                                  n_kv_heads=2)
        arch = dataclasses.asdict(cfg)
        W = weights.make(transformer.init_lm(cfg, device="meta"), 5, "cpu",
                         dtype=torch.float32)
        toks = torch.randint(2, cfg.vocab_size, (1, 24))
        h, _ = transformer.forward(W, cfg, toks)
        want = transformer.lm_logits(W, cfg, h)[0]
        got = reference.served_logits(W, arch, [toks[0]], [0])[0]
        assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)
