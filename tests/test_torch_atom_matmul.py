"""The port's atomized matmul, roofline terms and atom-count sweep against
the JAX package's, on the CPU.

Inputs are made from a seed with numpy and handed to both sides.  The JAX
side runs as its own tests run it: the Pallas kernel in interpret mode
(``repro.kernels.atom_matmul``) and its pure-jnp oracle.  On the CPU the
port's wrapper takes its plain PyTorch version, atom schedule included; the
CUDA kernel is held against that plain version on the GPU by
``chip_smoke.py`` and ``tests/test_torch_gpu.py``.

Tolerances are the reference's own (``tests/test_kernels.py``): float32
2e-5 (two f32 sums of the same products in different orders), bfloat16 2e-2
(each side rounds an f32 sum to 8 bits of mantissa once, on inputs that
were rounded the same way on both sides).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS as JAX_ARCH_IDS
from repro.configs.registry import get_config as jax_get_config
from repro.kernels.atom_matmul.kernel import matmul_atom as jax_matmul_atom
from repro.kernels.atom_matmul.ops import atom_ranges as jax_atom_ranges
from repro.kernels.atom_matmul.ops import atom_matmul as jax_atom_matmul
from repro.kernels.atom_matmul.ref import matmul_ref as jax_matmul_ref
from repro.roofline import analysis as jax_analysis
from repro_torch.configs.base import ALL_SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.kernels.atom_matmul import ops
from repro_torch.kernels.atom_matmul.ref import matmul_atom_ref, matmul_ref
from repro_torch.kernels.atoms import tile_count
from repro_torch.launch import atoms as sweep_mod
from repro_torch.roofline import analysis

from _torch_port import as_np, normal_pair

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SHAPES = [(128, 128, 128), (300, 260, 200), (64, 512, 96), (257, 129, 65)]
SENTINEL = 7.0


# ---------------------------------------------------------------------------
# the op, case for case with tests/test_kernels.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,N,K", SHAPES)
@pytest.mark.parametrize("n_atoms", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_atom_matmul_sweep(M, N, K, n_atoms, dtype):
    rng = np.random.default_rng(0)
    (a, ja), (b, jb) = (normal_pair(rng, (M, K), dtype),
                        normal_pair(rng, (K, N), dtype))
    out = ops.atom_matmul(a, b, n_atoms=n_atoms, block_m=128, block_n=128,
                          block_k=64)
    assert out.shape == (M, N) and out.dtype == a.dtype
    pallas = jax_atom_matmul(ja, jb, n_atoms=n_atoms, block_m=128,
                             block_n=128, block_k=64, interpret=True)
    oracle = jax_matmul_ref(ja, jb)
    tol = TOL[dtype]
    np.testing.assert_allclose(as_np(out), as_np(pallas), rtol=tol, atol=tol)
    np.testing.assert_allclose(as_np(out), as_np(oracle), rtol=tol, atol=tol)
    np.testing.assert_allclose(as_np(out), as_np(matmul_ref(a, b)),
                               rtol=tol, atol=tol)


def test_atom_matmul_order_free():
    """Atoms compose in any order (disjoint output tiles), bit for bit."""
    rng = np.random.default_rng(1)
    (a, ja), (b, jb) = (normal_pair(rng, (256, 128)),
                        normal_pair(rng, (128, 256)))
    base = ops.atom_matmul(a, b, n_atoms=4, block_m=128, block_n=128,
                           block_k=128)
    perm = ops.atom_matmul(a, b, n_atoms=4, order=(3, 1, 0, 2), block_m=128,
                           block_n=128, block_k=128)
    assert torch.equal(base, perm)
    assert torch.equal(base, ops.atom_matmul(a, b, block_m=128, block_n=128))
    pallas = jax_atom_matmul(ja, jb, n_atoms=4, order=(3, 1, 0, 2),
                             block_m=128, block_n=128, block_k=128,
                             interpret=True)
    np.testing.assert_allclose(as_np(perm), as_np(pallas), rtol=2e-5,
                               atol=2e-5)


def test_atom_matmul_default_blocks_and_block_k_leave_the_tile_space():
    """block_k orders the reference's sum and changes no tile; the default
    tiles are 256 x 256, as the reference's."""
    rng = np.random.default_rng(2)
    (a, ja), (b, jb) = (normal_pair(rng, (300, 200)),
                        normal_pair(rng, (200, 520)))
    out = ops.atom_matmul(a, b, n_atoms=3)
    for bk in (16, 64, 200):
        assert torch.equal(out, ops.atom_matmul(a, b, n_atoms=3, block_k=bk))
    pallas = jax_atom_matmul(ja, jb, n_atoms=3, interpret=True)
    np.testing.assert_allclose(as_np(out), as_np(pallas), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("bm,bn", [(128, 128), (256, 256), (128, 256)])
@pytest.mark.parametrize("M,N,K", [(300, 260, 200), (257, 520, 65)])
def test_one_atom_changes_the_tiles_the_reference_changes(M, N, K, bm, bn):
    """One atom on a C filled with a sentinel changes exactly the elements
    that the JAX atom changes (the reference pads to whole tiles; its pads
    are cut off before comparing), with the same values."""
    rng = np.random.default_rng(3)
    (a, ja), (b, jb) = normal_pair(rng, (M, K)), normal_pair(rng, (K, N))
    total = tile_count(M, N, bm, bn)
    start, num = total // 3, max(1, total // 2)
    c = torch.full((M, N), SENTINEL)
    assert ops.matmul_atom(a, b, c, start=start, num_tiles=num, block_m=bm,
                           block_n=bn) is c
    bk = 64
    Mp, Np, Kp = (-(-M // bm) * bm, -(-N // bn) * bn, -(-K // bk) * bk)
    jc = jax_matmul_atom(jnp.pad(ja, ((0, Mp - M), (0, Kp - K))),
                         jnp.pad(jb, ((0, Kp - K), (0, Np - N))),
                         jnp.full((Mp, Np), SENTINEL, jnp.float32),
                         start=start, num_tiles=num, block_m=bm, block_n=bn,
                         block_k=bk, interpret=True)
    want = as_np(jc)[:M, :N]
    changed = as_np(c) != SENTINEL
    np.testing.assert_array_equal(changed, want != SENTINEL)
    assert changed.any() and not changed.all()
    np.testing.assert_allclose(as_np(c)[changed], want[changed], rtol=2e-5,
                               atol=2e-5)


def test_atoms_cover_the_output_once():
    """One-tile atoms over the whole tile space (any block size on the CPU)
    write every element of C, and together give the product."""
    rng = np.random.default_rng(4)
    (a, _), (b, _) = normal_pair(rng, (130, 40)), normal_pair(rng, (40, 300))
    c = torch.full((130, 300), SENTINEL)
    for t in range(tile_count(130, 300, 64, 128)):
        matmul_atom_ref(a, b, c, start=t, num_tiles=1, block_m=64,
                        block_n=128)
    assert not (c == SENTINEL).any()
    torch.testing.assert_close(c, matmul_ref(a, b), rtol=2e-5, atol=2e-5)


def test_wrapper_checks_its_inputs():
    a, b = torch.zeros(8, 4), torch.zeros(4, 6)
    with pytest.raises(ValueError, match="share K"):
        ops.atom_matmul(a, torch.zeros(5, 6))
    with pytest.raises(ValueError, match="2-D"):
        ops.atom_matmul(a[None], b)
    with pytest.raises(ValueError, match="is not"):
        ops.matmul_atom(a, b, torch.zeros(8, 5), start=0, num_tiles=1)
    with pytest.raises(TypeError, match="one dtype"):
        ops.atom_matmul(a, b.double())
    with pytest.raises(ValueError, match="outside"):
        ops.matmul_atom(a, b, torch.zeros(8, 6), start=0, num_tiles=2)
    with pytest.raises(ValueError, match="block_k"):
        ops.atom_matmul(a, b, block_k=0)
    with pytest.raises(ValueError, match="permutation"):
        ops.atom_matmul(torch.zeros(300, 4), b, n_atoms=2, block_m=128,
                        order=(0, 0))


def test_a_non_cpu_tensor_never_takes_the_plain_version():
    a = torch.empty(8, 4, device="meta")
    b = torch.empty(4, 6, device="meta")
    with pytest.raises(RuntimeError, match="no path for device"):
        ops.atom_matmul(a, b)


# ---------------------------------------------------------------------------
# the kernel's schedule and routing, mirrored in Python
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(10))
def test_cta_tiles_cover_c_once_and_stay_in_their_atom(seed):
    """Over random shapes, block sizes, paths and the reference's atom
    partitions: every element of C lies in exactly one CTA tile of one atom,
    each CTA tile lies inside one of its atom's tiles, and an atom's CTA
    tiles come in the kernel's order (atom tiles row-major, then sub-tiles
    row-major)."""
    rng = np.random.default_rng(seed)
    M, N = (int(x) for x in rng.integers(1, 1300, 2))
    bm, bn = (int(x) for x in rng.choice([128, 256, 384, 512], 2))
    dtype = (torch.float32, torch.bfloat16)[int(rng.integers(0, 2))]
    cm, cn = ops.cta_shape(dtype, bn, bool(rng.integers(0, 2)))
    nn = -(-N // bn)
    owner = np.full((M, N), -1)
    ranges = jax_atom_ranges(tile_count(M, N, bm, bn), int(rng.integers(1, 9)))
    for i, (start, num) in enumerate(ranges):
        origins = ops.cta_tiles(M, N, bm, bn, start, num, cm, cn)
        keys = []
        for r, c in origins:
            t = (r // bm) * nn + c // bn
            assert start <= t < start + num
            assert (r % bm) % cm == 0 and (c % bn) % cn == 0
            assert r % bm + cm <= bm and c % bn + cn <= bn
            assert (owner[r:r + cm, c:c + cn] == -1).all()
            owner[r:r + cm, c:c + cn] = i
            keys.append((t, (r % bm) // cm, (c % bn) // cn))
        assert keys == sorted(keys)
    assert (owner >= 0).all()


@pytest.mark.parametrize("block_n", [128, 256, 384, 512, 640, 1024])
def test_cta_shape_is_128x256_exactly_on_the_bf16_16_byte_path(block_n):
    wide = block_n % 256 == 0
    assert ops.cta_shape(torch.bfloat16, block_n, True) == (
        (128, 256) if wide else (128, 128))
    for dtype, vec16 in ((torch.bfloat16, False), (torch.float32, True),
                         (torch.float32, False)):
        assert ops.cta_shape(dtype, block_n, vec16) == (128, 128)


def test_cta_tiles_of_the_headline_atom():
    """One atom of every 256 x 256 tile at the widest llama3-8b projection
    of a 1000-token prefill: 448 CTA tiles of 128 x 256, the last row 104
    rows high."""
    origins = ops.cta_tiles(1000, 14336, 256, 256, 0,
                            tile_count(1000, 14336, 256, 256), 128, 256)
    assert len(origins) == 448
    assert origins[:3] == [(0, 0), (128, 0), (0, 256)]
    assert max(r for r, _ in origins) == 896


def _view(dtype, rows, width, pitch, offset=0):
    """A [rows, width] view of a [rows, pitch] buffer, ``offset`` elements
    in."""
    return torch.zeros(rows, pitch + offset, dtype=dtype)[:, offset:offset
                                                           + width]


@pytest.mark.parametrize("a,b,want", [
    (_view(torch.bfloat16, 64, 128, 128), _view(torch.bfloat16, 128, 256, 256),
     True),                                                    # contiguous
    (_view(torch.bfloat16, 64, 65, 65), _view(torch.bfloat16, 65, 256, 256),
     False),                                                   # K = 65
    (_view(torch.bfloat16, 64, 128, 128), _view(torch.bfloat16, 128, 129, 129),
     False),                                                   # N = 129
    (_view(torch.bfloat16, 64, 128, 152, 8),
     _view(torch.bfloat16, 128, 256, 264), True),              # column ranges
    (_view(torch.bfloat16, 64, 128, 140, 3),
     _view(torch.bfloat16, 128, 256, 256), False),             # base not 16 B
    (_view(torch.bfloat16, 64, 128, 132), _view(torch.bfloat16, 128, 256, 256),
     False),                                                   # pitch 132
    (_view(torch.float32, 64, 128, 132), _view(torch.float32, 128, 256, 260),
     True),                                                    # f32: 4 a chunk
    (_view(torch.float32, 64, 128, 128), _view(torch.float32, 128, 130, 130),
     False),                                                   # f32 N = 130
], ids=["contiguous", "K65", "N129", "column-ranges", "base-unaligned",
        "pitch132", "f32", "f32-N130"])
def test_vec16_routes_by_rows_of_whole_16_byte_chunks(a, b, want):
    c = torch.zeros(a.shape[0], b.shape[1], dtype=a.dtype)
    assert ops.vec16(a, b, c) is want
    if want:       # the output's rows count too
        wide = torch.zeros(c.shape[0], c.shape[1] + 4, dtype=c.dtype)
        assert not ops.vec16(a, b, wide[:, 2:2 + c.shape[1]])


def test_vec16_raises_for_an_operand_the_kernel_does_not_take():
    a = torch.zeros(64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="last stride 1"):
        ops.vec16(a, a.T, a)
    with pytest.raises(TypeError, match="float32 and bfloat16"):
        ops.vec16(a.half(), a.half(), a.half())


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["v5e", "h100"])
def test_roofline_terms_field_by_field(which):
    """Same numbers in, same terms out, under the same hardware record."""
    if which == "v5e":
        jhw = jax_analysis.V5E
        thw = analysis.HW(jhw.name, jhw.peak_flops, jhw.hbm_bw, jhw.link_bw)
    else:
        thw = analysis.H100
        jhw = jax_analysis.HW(thw.name, thw.peak_flops, thw.hbm_bw,
                              thw.link_bw)
    for arch in ("llama3-8b", "qwen2-moe-a2.7b"):
        for shape in ALL_SHAPES:
            args = ("tp_dp", 4, 3.1e15, 2.2e12, 5.5e9)
            jt = jax_analysis.derive_terms(jax_get_config(arch), shape, *args)
            tt = analysis.derive_terms(get_config(arch), shape, *args)
            for t, hw in ((jt, jhw), (tt, thw)):
                t.hw = hw
                t.__post_init__()
            assert tt.row() == jt.row()
            for f in ("t_compute", "t_memory", "t_collective", "bound_time",
                      "useful_ratio", "roofline_fraction"):
                assert getattr(tt, f) == getattr(jt, f), f


def test_h100_record_is_the_data_sheet():
    h = analysis.H100
    assert (h.peak_flops, h.peak_flops_f32, h.hbm_bw, h.link_bw) == (
        989e12, 67e12, 3.35e12, 450e9)
    assert analysis.RooflineTerms("a", "s", "m", 1, 1.0, 1.0, 0.0,
                                  1.0).hw is h


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_the_reference(arch):
    assert ARCH_IDS == JAX_ARCH_IDS
    for shape in ALL_SHAPES:
        want = jax_analysis.model_flops(jax_get_config(arch), shape)
        assert analysis.model_flops(get_config(arch), shape) == want


# ---------------------------------------------------------------------------
# the atom-count sweep
# ---------------------------------------------------------------------------

def _run(*args) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.atoms",
                           *args], env=env, capture_output=True, text=True,
                          timeout=300)


def test_sweep_on_the_cpu_runs_every_atom_count_with_error_zero():
    out = _run("--device", "cpu", "--quick")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == sweep_mod.fmt_csv("bench", "case", "value", "unit")
    rows = lines[1:]
    assert len(rows) == len(sweep_mod.cases(quick=True)) * len(
        sweep_mod.QUICK_N_ATOMS)
    assert all(r.startswith("atoms,") and "maxerr=0.0e+00" in r
               and "not measured" in r for r in rows)


def test_sweep_defaults_to_the_gpu_and_raises_without_one():
    out = _run("--quick")
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_sweep_records():
    recs = sweep_mod.sweep(device="cpu")
    assert {r["n_atoms"] for r in recs} == set(sweep_mod.QUICK_N_ATOMS)
    for r in recs:
        assert r["max_abs_err"] == 0.0
        assert r["plain_err"] <= r["plain_limit"]
        assert r["device_ms"] is None and r["waves"] is None
        assert 1 <= r["atoms"] <= min(r["n_atoms"], r["tiles"])


@pytest.mark.parametrize("kernel", ["atom_matmul", "flash_attention"])
def test_sweep_holds_one_atom_against_the_plain_version(monkeypatch, kernel):
    """A fault that every atom count repeats the same way (so n atoms still
    equal one) is caught by the comparison with the plain version."""
    mod = sweep_mod.mm_ops if kernel == "atom_matmul" else sweep_mod.fa_ops
    right = getattr(mod, kernel)
    monkeypatch.setattr(mod, kernel, lambda *a, **kw: right(*a, **kw) + 1)
    with pytest.raises(RuntimeError, match="differs from the plain version"):
        sweep_mod.sweep(device="cpu")


def test_full_sweep_cases_are_the_llama3_8b_prefill_shapes():
    cfg = get_config("llama3-8b")
    mm = {c.name: c.shape for c in sweep_mod.cases(quick=False)
          if c.kernel == "atom_matmul"}
    T, d, ff = sweep_mod.PREFILL_TOKENS, cfg.d_model, cfg.d_ff
    assert mm["ref_1024_f32"] == dict(M=1024, N=1024, K=1024, block=256)
    assert {(s["M"], s["K"], s["N"]) for n, s in mm.items()
            if n.startswith("llama")} == {(T, d, d), (T, d, 1024),
                                          (T, d, ff), (T, ff, d)}
    assert sweep_mod.N_ATOMS == (1, 2, 4, 8, 16, 32)
