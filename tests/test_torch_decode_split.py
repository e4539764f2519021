"""The split-KV schedule of decode attention (K1's kernels), on the CPU.

``ops.kv_split`` is the Python mirror of the schedule the CUDA kernel runs
(the library checks the two agree when it loads); ``ops.plan`` is the
routing made before a launch; ``ref.decode_attention_split_ref`` repeats the
kernel's arithmetic: per-split partials merged in split order.  The merge is
held against the JAX package's decode attention, run as its own tests run it
(the Pallas kernel in interpret mode, and its oracle), at the reference's
tolerances: float32 2e-5 (two f32 implementations that sum in different
orders), bfloat16 3e-2 (outputs of O(1) rounded to 8 bits of mantissa).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ref import (
    decode_attention_ref as jax_decode_ref)
from repro_torch.kernels.atoms import schedule
from repro_torch.kernels.decode_attention import ops
from repro_torch.configs.registry import get_config
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, decode_attention_split_ref)
from repro_torch.launch import decode_compare as dc

from _torch_port import as_np, normal_pair

# clusters of 1, 2, 4, 8 CTAs a card runs at once (``ops.cluster_fit``): two
# CTAs an SM on 132 SMs, fewer of the larger clusters, since a cluster's CTAs
# must share one GPC
FIT = (264, 132, 62, 30)


def _chunk(S, nsplit):
    """The chunk the kernel gives ``nsplit`` splits of ``S`` keys."""
    return -(-(-(-S // ops.KEY_BLOCK)) // nsplit) * ops.KEY_BLOCK


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fit", [FIT, (132, 66, 30, 15), (1, 1, 1, 1)])
@pytest.mark.parametrize("R_total", [1, 8, 30, 31, 32, 66, 131, 264, 1000])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 128, 300, 2048, 8192])
def test_kv_split_covers_the_keys_once(R_total, S, fit):
    nsplit, chunk = ops.kv_split(R_total, S, fit)
    assert nsplit in ops.SPLITS
    assert chunk % ops.KEY_BLOCK == 0 and chunk > 0
    assert nsplit <= -(-S // ops.KEY_BLOCK)
    seen = []
    for j in range(nsplit):
        seen.extend(range(j * chunk, min((j + 1) * chunk, S)))
    assert seen == list(range(S))
    # the largest split count whose R_total clusters all run at once
    i = ops.SPLITS.index(nsplit)
    assert nsplit == 1 or fit[i] >= R_total
    for j in range(i + 1, len(ops.SPLITS)):
        assert fit[j] < R_total or ops.SPLITS[j] > -(-S // ops.KEY_BLOCK)


@pytest.mark.parametrize("R_total,S,want", [
    (32, 2048, (4, 512)),     # 4 slots of llama3-8b: 32 clusters of 8 do not fit
    (30, 2048, (8, 256)),
    (8, 8192, (8, 1024)),     # one slot at the full 8192-token context
    (8, 50, (1, 64)),         # one key block: no split
    (8, 130, (2, 128)),       # three blocks: at most two splits
    (8, 300, (4, 128)),       # five blocks: at most four
    (264, 2048, (1, 2048)),   # enough rows to fill the card
    (132, 2048, (2, 1024)),
])
def test_kv_split_values(R_total, S, want):
    assert ops.kv_split(R_total, S, FIT) == want


def test_kv_split_is_the_same_for_every_atom():
    """The schedule is a function of the whole call (R_total = B*Hk, S, the
    card), so every atom of every schedule runs a row the same way."""
    B, Hk, S = 5, 8, 2048
    R = B * Hk
    want = ops.kv_split(R, S, FIT)
    for n_atoms in (1, 2, 3, 7, R):
        for start, num in schedule(R, n_atoms, tuple(reversed(range(
                min(n_atoms, R))))):
            assert 0 <= start and start + num <= R
            assert ops.kv_split(R, S, FIT) == want


# ---------------------------------------------------------------------------
# routing, decided before the launch
# ---------------------------------------------------------------------------

def _plan(monkeypatch, q, k, v, fit=FIT, asked=None):
    def cluster_fit(device, head_dim, dtype=torch.bfloat16):
        if asked is not None:
            asked.append((head_dim, dtype))
        return fit
    monkeypatch.setattr(ops, "cluster_fit", cluster_fit)
    return ops.plan(q, k, v)


def test_plan_bf16_aligned_caches_take_the_split_kernel(monkeypatch):
    q = torch.zeros(4, 32, 128, dtype=torch.bfloat16)
    kc = torch.zeros(4, 2048, 8, 128, dtype=torch.bfloat16)
    assert _plan(monkeypatch, q, kc, kc) == {"route": "split", "nsplit": 4,
                                             "chunk": 512}


def test_plan_stacked_cache_slice_takes_the_split_kernel(monkeypatch):
    """A slot range of a stacked cache, as the server holds it: pitches are
    whole 16-byte chunks, so TMA addresses it where it lies."""
    full = torch.zeros(2, 6, 300, 2, 64, dtype=torch.bfloat16)
    kc = full[1, 1:5]
    q = torch.zeros(4, 8, 64, dtype=torch.bfloat16)
    assert _plan(monkeypatch, q, kc, kc)["route"] == "split"


def _unaligned(B, S, Hk, D, offset=0):
    """A bf16 cache with a key pitch of Hk*D + 1 elements, from ``offset``."""
    wide = torch.zeros(B, S, Hk * D + 1, dtype=torch.bfloat16)
    return wide[:, :, offset:offset + Hk * D].unflatten(-1, (Hk, D))


@pytest.mark.parametrize("which", ["k", "v", "both"])
@pytest.mark.parametrize("D", [64, 128])
def test_plan_bf16_unaligned_pitch_raises(monkeypatch, which, D):
    """Key pitches that are not whole 16-byte chunks: TMA does not address
    them, so the wrapper raises before any launch, as it did before the
    split kernel."""
    B, S, Hk = 2, 100, 2
    q = torch.zeros(B, 4, D, dtype=torch.bfloat16)
    good = torch.zeros(B, S, Hk, D, dtype=torch.bfloat16)
    odd = _unaligned(B, S, Hk, D)
    assert odd.stride(1) % 8
    k, v = (odd if which in ("k", "both") else good,
            odd if which in ("v", "both") else good)
    with pytest.raises(ValueError, match="multiples of 8"):
        _plan(monkeypatch, q, k, v)


def test_plan_bf16_misaligned_data_raises(monkeypatch):
    """Whole 16-byte pitches but data 2 bytes past a 16-byte boundary."""
    base = torch.zeros(2 * 100 * 2 * 64 + 8, dtype=torch.bfloat16)
    kc = base[1:1 + 2 * 100 * 2 * 64].view(2, 100, 2, 64)
    assert kc.data_ptr() % 16
    q = torch.zeros(2, 4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        _plan(monkeypatch, q, kc, kc)


@pytest.mark.parametrize("fit,nsplit", [(FIT, 4), ((132, 66, 30, 15), 2),
                                        ((264, 132, 66, 33), 8)])
def test_plan_f32_takes_the_split_schedule_of_its_own_fit_and_needs_aligned_rows(
        monkeypatch, fit, nsplit):
    """float32 takes the split-KV kernel (``split_f32``) at ``kv_split``'s
    schedule over the f32 kernel's own cluster fit, asked for by dtype;
    unaligned pitches raise, as for bf16."""
    q = torch.zeros(4, 32, 128)
    kc = torch.zeros(4, 2048, 8, 128)
    asked = []
    assert _plan(monkeypatch, q, kc, kc, fit, asked) == {
        "route": "split_f32", "nsplit": nsplit, "chunk": 2048 // nsplit}
    assert asked == [(128, torch.float32)]
    q = torch.zeros(2, 4, 64)
    kc = torch.zeros(2, 50, 2, 64)
    assert _plan(monkeypatch, q, kc, kc, fit) == {
        "route": "split_f32", "nsplit": 1, "chunk": 64}
    odd = torch.zeros(2, 50, 2 * 64 + 1)[:, :, :128].unflatten(-1, (2, 64))
    with pytest.raises(ValueError, match="multiples of 8"):
        _plan(monkeypatch, q, odd, odd, fit)


# ---------------------------------------------------------------------------
# the split arithmetic against the JAX package
# ---------------------------------------------------------------------------

def _boundary_lens(S, chunk):
    """0, 1, chunk - 1, chunk, chunk + 1 and S (clamped to S), plus a row
    whose keys all fall in split 0."""
    return [min(x, S) for x in (0, 1, chunk - 1, chunk, chunk + 1, S, 5)]


@pytest.mark.parametrize("nsplit", [1, 2, 4, 8])
def test_split_ref_matches_jax_f32(nsplit):
    rng = np.random.default_rng(20 + nsplit)
    S, Hk, G, D = 300, 2, 2, 32
    chunk = _chunk(S, nsplit)
    lens = np.array(_boundary_lens(S, chunk), np.int32)
    B = len(lens)
    (q, jq), (kc, jkc), (vc, jvc) = (normal_pair(rng, (B, Hk * G, D)),
                                     normal_pair(rng, (B, S, Hk, D)),
                                     normal_pair(rng, (B, S, Hk, D)))
    out = decode_attention_split_ref(q, kc, vc, torch.from_numpy(lens),
                                     nsplit, chunk)
    oracle = jax_decode_ref(jq, jkc, jvc, jnp.asarray(lens))
    np.testing.assert_allclose(as_np(out), as_np(oracle), rtol=2e-5,
                               atol=2e-5)
    assert (out[lens == 0] == 0).all()
    # the Pallas kernel returns the mean of V for a row of length 0 (a known
    # fault of the reference kernel), so it is compared on the other rows
    pallas = jax_decode(jq, jkc, jvc, jnp.asarray(lens), block_k=32,
                        interpret=True)
    keep = lens > 0
    np.testing.assert_allclose(as_np(out)[keep], as_np(pallas)[keep],
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("nsplit", [2, 8])
def test_split_ref_matches_jax_bf16(nsplit):
    rng = np.random.default_rng(30 + nsplit)
    S, Hk, G, D = 200, 2, 4, 64
    chunk = _chunk(S, nsplit)
    lens = np.array(_boundary_lens(S, chunk)[1:], np.int32)
    B = len(lens)
    (q, jq), (kc, jkc), (vc, jvc) = (
        normal_pair(rng, (B, Hk * G, D), "bfloat16"),
        normal_pair(rng, (B, S, Hk, D), "bfloat16"),
        normal_pair(rng, (B, S, Hk, D), "bfloat16"))
    out = decode_attention_split_ref(q, kc, vc, torch.from_numpy(lens),
                                     nsplit, chunk)
    assert out.dtype == torch.bfloat16
    pallas = jax_decode(jq, jkc, jvc, jnp.asarray(lens), block_k=32,
                        interpret=True)
    np.testing.assert_allclose(as_np(out), as_np(pallas), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("nsplit", [1, 2, 4, 8])
@pytest.mark.parametrize("S", [64, 130, 1000])
def test_split_ref_matches_unsplit(nsplit, S):
    rng = np.random.default_rng(S + nsplit)
    Hk, G, D = 2, 3, 64
    chunk = _chunk(S, nsplit)
    lens = torch.tensor(_boundary_lens(S, chunk) + [S + 7, -3],
                        dtype=torch.int32)         # clamped to [0, S]
    B = len(lens)
    (q, _), (kc, _), (vc, _) = (normal_pair(rng, (B, Hk * G, D)),
                                normal_pair(rng, (B, S, Hk, D)),
                                normal_pair(rng, (B, S, Hk, D)))
    split = decode_attention_split_ref(q, kc, vc, lens, nsplit, chunk)
    np.testing.assert_allclose(as_np(split),
                               as_np(decode_attention_ref(q, kc, vc, lens)),
                               rtol=2e-5, atol=2e-5)
    assert torch.isfinite(split).all()
    assert (split[lens <= 0] == 0).all()


def test_split_ref_more_splits_than_key_blocks():
    """Splits that start past S (and past every len) contribute nothing."""
    rng = np.random.default_rng(40)
    (q, _), (kc, _), (vc, _) = (normal_pair(rng, (2, 4, 32)),
                                normal_pair(rng, (2, 70, 2, 32)),
                                normal_pair(rng, (2, 70, 2, 32)))
    lens = torch.tensor([70, 9], dtype=torch.int32)
    np.testing.assert_allclose(
        as_np(decode_attention_split_ref(q, kc, vc, lens, 8, 64)),
        as_np(decode_attention_ref(q, kc, vc, lens)), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the timed shapes and the limit they are held to (``launch/decode_compare``)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(dc.COMPARE_SHAPES))
def test_timed_shapes_are_llama3_8b(name):
    cfg = get_config("llama3-8b")
    B, Hq, Hk, D, S, lens = dc.COMPARE_SHAPES[name]
    assert (Hq, Hk, D) == (cfg.n_heads, cfg.n_kv_heads,
                           cfg.d_model // cfg.n_heads)
    assert len(lens) == B and all(0 < n <= S for n in lens)


@pytest.mark.parametrize("D", [64, 128])
def test_masked_attention_matches_jax(D):
    rng = np.random.default_rng(D)
    B, S, Hk, G = 4, 200, 2, 3
    lens = np.array([0, 1, 77, 200], np.int32)
    (q, jq), (kc, jkc), (vc, jvc) = (normal_pair(rng, (B, Hk * G, D)),
                                     normal_pair(rng, (B, S, Hk, D)),
                                     normal_pair(rng, (B, S, Hk, D)))
    keep = torch.arange(S)[None, :] < torch.from_numpy(lens)[:, None]
    out = dc._masked_attention(q, kc, vc, keep)
    np.testing.assert_allclose(
        as_np(out), as_np(jax_decode_ref(jq, jkc, jvc, jnp.asarray(lens))),
        rtol=2e-5, atol=2e-5)
    assert (out[0] == 0).all()


def test_dropped_split_err_one_split_reads_the_whole_output():
    """Rows whose keys all lie in split 0: leaving it out leaves zeros."""
    rng = np.random.default_rng(5)
    (q, _), (kc, _), (vc, _) = (normal_pair(rng, (2, 4, 32)),
                                normal_pair(rng, (2, 300, 2, 32)),
                                normal_pair(rng, (2, 300, 2, 32)))
    lens = torch.tensor([64, 9], dtype=torch.int32)
    full = decode_attention_ref(q, kc, vc, lens)
    assert dc.dropped_split_err(q, kc, vc, lens, 64) == pytest.approx(
        full.abs().max().item(), rel=1e-5)


def test_dropped_split_err_is_the_least_split():
    """Three splits of 64 keys in one row: the reading is at most what
    dropping the last one reads, which is attention over the first two
    (the JAX oracle at length 128)."""
    rng = np.random.default_rng(6)
    (q, jq), (kc, jkc), (vc, jvc) = (normal_pair(rng, (1, 8, 32)),
                                     normal_pair(rng, (1, 192, 2, 32)),
                                     normal_pair(rng, (1, 192, 2, 32)))
    lens = np.array([192], np.int32)
    last = (as_np(jax_decode_ref(jq, jkc, jvc, jnp.asarray(lens)))
            - as_np(jax_decode_ref(jq, jkc, jvc, jnp.asarray(lens - 64))))
    got = dc.dropped_split_err(q, kc, vc, torch.from_numpy(lens), 64)
    assert 0 < got <= np.abs(last).max() * (1 + 1e-5)


def test_headline_limit_takes_one_bf16_rounding():
    rng = np.random.default_rng(7)
    want = torch.from_numpy(rng.standard_normal((4, 32, 128)) * 0.07).float()
    err = (want.bfloat16().float() - want).abs().max().item()
    assert 0 < err <= dc.headline_limit(want) / 2


@pytest.mark.parametrize("name", sorted(dc.DECODE_SHAPES))
def test_headline_limit_sees_a_dropped_split(name):
    """At each timed shape, with the split schedule the H100 gives it, the
    limit lies below what a kernel that left out one split would read."""
    B, Hq, Hk, D, S, lens = dc.DECODE_SHAPES[name][0]
    gen = torch.Generator().manual_seed(0)
    q, kc, vc = (torch.randn(shape, generator=gen).bfloat16() for shape in
                 ((B, Hq, D), (B, S, Hk, D), (B, S, Hk, D)))
    lens_t = torch.tensor(lens, dtype=torch.int32)
    _, chunk = ops.kv_split(B * Hk, S, FIT)
    limit = dc.headline_limit(decode_attention_ref(q, kc, vc, lens_t))
    assert dc.dropped_split_err(q, kc, vc, lens_t, chunk) > 4 * limit
