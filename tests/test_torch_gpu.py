"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need an NVIDIA Hopper GPU and ``nvcc``; elsewhere they skip (the
decision is made inside a fixture, never at import).  Run them on the GPU
machine with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

``chip_smoke.py`` makes the same comparisons at the serving path's shapes;
this file adds seeded random shapes and the model path end to end.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import transformer
from repro_torch.models.common import tree_map
from repro_torch.models.registry import init_model

pytestmark = pytest.mark.gpu

# float32: same f32 math, other summation order.  bfloat16: one rounding of an
# O(1) result to bf16 on each side (and of P inside the flash kernel).
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dtype).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", range(6))
def test_decode_kernel_random_shapes(cuda, seed, dtype):
    rng = np.random.default_rng(seed)
    B, Hk = int(rng.integers(1, 6)), int(rng.integers(1, 5))
    G, D = int(rng.choice([1, 2, 3, 4, 12])), int(rng.choice([64, 128]))
    S = int(rng.integers(1, 700))
    q = _randn(rng, (B, Hk * G, D), dtype, cuda)
    kc = _randn(rng, (B, S, Hk, D), dtype, cuda)
    vc = _randn(rng, (B, S, Hk, D), dtype, cuda)
    lens = torch.from_numpy(rng.integers(0, S + 1, B).astype(np.int32)).to(cuda)
    before = decode_ops.launches
    n_atoms = int(rng.integers(1, 5))
    got = decode_ops.decode_attention(q, kc, vc, lens, n_atoms=n_atoms)
    torch.cuda.synchronize()
    assert decode_ops.launches == before + min(n_atoms, B * Hk)
    want = decode_attention_ref(q, kc, vc, lens)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert torch.equal(got, decode_ops.decode_attention(q, kc, vc, lens))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", range(6))
def test_flash_kernel_random_shapes(cuda, seed, dtype):
    rng = np.random.default_rng(100 + seed)
    B, Hk = int(rng.integers(1, 3)), int(rng.integers(1, 4))
    G, D = int(rng.choice([1, 2, 4])), int(rng.choice([64, 128]))
    Sk = int(rng.integers(1, 400))
    Sq = int(rng.integers(1, Sk + 1)) if seed % 2 else Sk
    causal = bool(seed % 3)
    q = _randn(rng, (B, Sq, Hk * G, D), dtype, cuda)
    k = _randn(rng, (B, Sk, Hk, D), dtype, cuda)
    v = _randn(rng, (B, Sk, Hk, D), dtype, cuda)
    got = flash_ops.flash_attention(q, k, v, causal=causal,
                                    n_atoms=int(rng.integers(1, 5)))
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, causal=causal)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert torch.equal(got, flash_ops.flash_attention(q, k, v, causal=causal))


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 4, 16, device=cuda)          # head_dim 16
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 4, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 and bfloat16"):
        flash_ops.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 4, 64, device=cuda)
    with pytest.raises(ValueError, match="block_q"):
        flash_ops.flash_attention(q, q, q, block_q=32)
    with pytest.raises(ValueError, match="stride"):
        # same shape, but the head_dim axis is not the contiguous one
        flash_ops.flash_attention(
            q.transpose(2, 3).contiguous().transpose(2, 3), q, q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_on_gpu_matches_cpu(cuda, dtype):
    """Prefill and two decode steps with the kernels on the card against the
    same parameters with the plain versions on the CPU (head_dim 64: the
    smallest the kernels take)."""
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), d_head=64,
                              dtype=dtype)
    cpu = init_model(cfg, seed=0, device="cpu")
    gpu = tree_map(lambda t: t.to(cuda), cpu)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(2, 256, (3, 70)))
    tol = 1e-3 if dtype == "float32" else 5e-2
    before = flash_ops.launches, decode_ops.launches
    lc, cc = transformer.prefill(cpu, cfg, toks, max_len=80)
    lg, cg = transformer.prefill(gpu, cfg, toks.to(cuda), max_len=80)
    assert (lg.cpu() - lc).abs().max().item() <= tol
    for step in range(2):
        nxt = torch.from_numpy(rng.integers(2, 256, (3,)))
        pos = torch.tensor([70 + step] * 3)
        lc, _ = transformer.decode_step(cpu, cfg, nxt, pos, cc)
        lg, _ = transformer.decode_step(gpu, cfg, nxt.to(cuda), pos.to(cuda), cg)
        assert (lg.cpu() - lc).abs().max().item() <= tol
    assert flash_ops.launches == before[0] + cfg.n_layers
    assert decode_ops.launches == before[1] + 2 * cfg.n_layers
