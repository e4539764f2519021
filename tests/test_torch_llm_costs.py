"""``repro_torch.core.llm_costs`` on the Hopper kernels' geometry, and the
``h100_like`` profile's rates: the port's versions of the reference's
decode-roofline pins (``tests/test_llm_workloads.py``), held where the two
kernels' geometries agree against ``repro.core.llm_costs``."""
import math

import pytest

from repro.configs.registry import get_config as ref_get_config
from repro.core import llm_costs as r_llm
from repro_torch.configs.registry import get_config
from repro_torch.core import types as p_types
from repro_torch.core.costmodel import CostModel
from repro_torch.core.llm_costs import (H100_CLUSTER_FIT,
                                        decode_attention_work,
                                        decode_cost_table,
                                        flash_attention_work,
                                        roofline_terms,
                                        seed_decode_predictor)
from repro_torch.core.predictor import LatencyPredictor
from repro_torch.core.types import DeviceSpec, KernelTask, KernelWork
from repro_torch.core.workloads import (continuous_decode_trace,
                                        decode_attention_op)
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.roofline.analysis import H100

LLAMA = get_config("llama3-8b")
OLMO = get_config("olmo-1b")
PROFILES = {"h100_like": DeviceSpec.h100_like,
            "a100_like": DeviceSpec.a100_like}


@pytest.mark.parametrize("profile", PROFILES)
def test_decode_cost_table_matches_roofline(profile):
    """CostModel ground truth == roofline bound_time x wave quantization
    + launch overhead, for every entry; decode is memory-bound."""
    dev = PROFILES[profile]()
    cost = CostModel(dev)
    table = decode_cost_table(LLAMA, dev)
    assert [(e.batch, e.kv_len) for e in table] == [
        (B, S) for B in (1, 2, 4, 8) for S in (512, 2048, 8192)]
    for e in table:
        ph = cost.phases(e.work)
        t_eff = max(1, min(dev.n_slices, ph.max_useful_slices))
        quant = ph.quantization(t_eff, dev.occupancy)
        expect = e.roofline_s * quant + dev.launch_overhead
        assert e.latency_s == pytest.approx(expect, rel=1e-9), \
            f"B={e.batch} S={e.kv_len}"
        assert not cost.is_compute_bound(e.work)


@pytest.mark.parametrize("cfg", ["llama3-8b", "olmo-1b"])
@pytest.mark.parametrize("S", [512, 2048, 8192])
@pytest.mark.parametrize("B", [1, 2, 4, 8])
def test_decode_work_equals_reference_at_aligned_lengths(B, S, cfg):
    """Where neither kernel pads (S a multiple of both key blocks), the
    port's work equals the reference's and the sim's trace op in flops and
    bytes; only the grid differs."""
    c, rc = get_config(cfg), ref_get_config(cfg)
    got = decode_attention_work(B, S, c.n_heads, c.n_kv_heads, c.head_dim)
    want = r_llm.decode_attention_work(B, S, rc.n_heads, rc.n_kv_heads,
                                       rc.head_dim)
    op = decode_attention_op("d", B, S, c.n_heads, c.n_kv_heads, c.head_dim)
    assert (got.flops, got.bytes) == (want.flops, want.bytes)
    assert got.flops == pytest.approx(op.flops, rel=1e-12)
    assert got.bytes == pytest.approx(op.bytes, rel=1e-12)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 300, 512, 2048, 2049, 8192])
@pytest.mark.parametrize("B", [1, 4, 8, 40])
def test_decode_grid_follows_kv_split(B, S):
    """One thread block per (row, split), the split from ``kv_split`` at
    the card's cluster occupancy; keys padded by less than one block."""
    c = LLAMA
    w = decode_attention_work(B, S, c.n_heads, c.n_kv_heads, c.head_dim)
    R = B * c.n_kv_heads
    nsplit, chunk = decode_ops.kv_split(R, S, H100_CLUSTER_FIT)
    assert w.n_blocks == R * nsplit
    assert nsplit * chunk >= S
    G = c.n_heads // c.n_kv_heads
    Sp = w.flops / (4.0 * R * G * c.head_dim)
    assert Sp % decode_ops.KEY_BLOCK == 0 and 0 <= Sp - S < 64
    # another card's occupancy gives another grid, the same work
    w1 = decode_attention_work(B, S, c.n_heads, c.n_kv_heads, c.head_dim,
                               fit=(1, 1, 1, 1))
    assert (w1.flops, w1.bytes, w1.n_blocks) == (w.flops, w.bytes, R)


def test_cluster_fit_constant_is_a_fit():
    """One entry per split count, non-increasing as clusters grow."""
    assert len(H100_CLUSTER_FIT) == len(decode_ops.SPLITS)
    assert all(a >= b > 0 for a, b in zip(H100_CLUSTER_FIT,
                                          H100_CLUSTER_FIT[1:]))


@pytest.mark.parametrize("Sq,Skv", [(512, 512), (1000, 1000), (700, 1500),
                                    (2048, 2048), (4096, 4096), (1, 65)])
@pytest.mark.parametrize("B", [1, 2])
def test_flash_work_tiles_and_bounded_padding(B, Sq, Skv):
    """``B*Hq*ceil(Sq/64)`` q tiles; flops and bytes exceed the unpadded
    square by at most one block a dim, and equal the reference's where
    neither kernel pads."""
    c = LLAMA
    w = flash_attention_work(B, Sq, Skv, c.n_heads, c.n_kv_heads, c.head_dim)
    assert w.n_blocks == B * c.n_heads * math.ceil(Sq / flash_ops.BLOCK_Q)
    ideal = 4.0 * B * c.n_heads * Sq * Skv * c.head_dim
    pad = ((math.ceil(Sq / 64) * 64) / Sq) * ((math.ceil(Skv / 64) * 64)
                                               / Skv)
    assert ideal <= w.flops <= ideal * pad * (1 + 1e-12)
    assert (math.ceil(Sq / 64) * 64 - Sq < 64
            and math.ceil(Skv / 64) * 64 - Skv < 64)
    if Sq % 512 == 0 and Skv % 512 == 0:
        want = r_llm.flash_attention_work(B, Sq, Skv, c.n_heads,
                                          c.n_kv_heads, c.head_dim)
        assert (w.flops, w.bytes) == (want.flops, want.bytes)


@pytest.mark.parametrize("profile", PROFILES)
def test_seed_decode_predictor_warm_start(profile):
    dev = PROFILES[profile]()
    pred = LatencyPredictor()
    trace = continuous_decode_trace(LLAMA, 4, 2048, 6)
    n = seed_decode_predictor(pred, 7, trace, dev, dev.n_slices)
    assert n == len(trace)
    cost = CostModel(dev)
    for ordinal, op in enumerate(trace):
        t = KernelTask(op.name, op.work(), client_id=7, queue_id=7,
                       ordinal=ordinal)
        assert pred.predict(t, dev.n_slices) == pytest.approx(
            cost.latency(op.work(), dev.n_slices), rel=1e-6)


def test_roofline_terms_effective_parallelism_on_h100():
    dev = DeviceSpec.h100_like()
    terms = roofline_terms(KernelWork(1e12, 1e9, dev.occupancy), dev)
    assert terms.chips == 1               # occupancy-capped, not 66
    big = roofline_terms(KernelWork(1e12, 1e9, 10_000), dev)
    assert big.chips == dev.n_slices
    # the profile's record, not the port's default whole-card record
    assert big.hw.peak_flops == dev.peak_flops
    assert big.bound_time == pytest.approx(
        max(1e12 / H100.peak_flops, 1e9 / H100.hbm_bw), rel=1e-12)


def test_h100_rates_sum_to_the_data_sheet():
    dev = DeviceSpec.h100_like()
    assert dev.n_slices == 66
    assert dev.peak_flops * 66 == pytest.approx(H100.peak_flops, rel=1e-12)
    assert dev.hbm_bw * 66 == pytest.approx(H100.hbm_bw, rel=1e-12)
    assert dev.hbm_capacity * 66 == pytest.approx(p_types.H100_MEMORY,
                                                  rel=1e-12)
