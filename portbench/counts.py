"""Frozen operation and byte counts, and the chip's published peaks.

What the algorithm needs, given the shapes: a later change to a kernel
cannot move these.  Copied from the port's ``chip_smoke.py``
(``causal_pairs``) and its PERF table's ``bound_ms`` (K1, K2, K2-bwd), and
from ``roofline/analysis.py::H100``.
"""
from __future__ import annotations

# NVIDIA's data sheet, one H100 SXM at 700 W, dense rates
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def causal_pairs(S: int, window: int = 0) -> int:
    """Unmasked (query, key) pairs of causal self-attention over S tokens,
    each query seeing at most its last ``window`` keys (0: all)."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of its two terms."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def k2_counts(B: int, Sq: int, Sk: int, Hq: int, Hk: int, D: int, *,
              causal: bool = True, window: int = 0, elem: int = 2,
              lse: bool = False) -> tuple[float, float]:
    """Flash forward: (flops, bytes).  Two products of 2 D flops a pair and
    head; q, k, v read once, o (and the f32 lse) written once."""
    pairs = causal_pairs(Sk, window) if causal else Sq * Sk
    flops = 4.0 * D * pairs * Hq * B
    nbytes = elem * D * B * (2 * Sq * Hq + 2 * Sk * Hk)
    if lse:
        nbytes += 4 * B * Hq * Sq
    return flops, float(nbytes)


def k2bwd_counts(B: int, S: int, Hq: int, Hk: int, D: int, *,
                 causal: bool = True, window: int = 0,
                 elem: int = 2) -> tuple[float, float]:
    """Flash backward (delta pass and one atom): (flops, bytes).  10 D flops
    a pair and head (S recomputed, dP, dV, dQ, dK); q, k, v, o, do and the
    f32 lse read once, dq, dk, dv written once."""
    pairs = causal_pairs(S, window) if causal else S * S
    flops = 10.0 * D * pairs * Hq * B
    nbytes = elem * D * B * S * (3 * Hq + 2 * Hk) \
        + elem * D * B * S * (Hq + 2 * Hk) + 4 * B * Hq * S
    return flops, float(nbytes)


def k1_counts(lens, Hq: int, Hk: int, D: int, *,
              elem: int = 2) -> tuple[float, float]:
    """Decode attention of one new token a row against its first
    ``lens[b]`` cached keys: (flops, bytes).  K and V read over each row's
    length, q read and o written once."""
    keys = float(sum(int(n) for n in lens))
    flops = 4.0 * D * Hq * keys
    nbytes = elem * D * (2 * Hk * keys + 2 * Hq * len(lens))
    return flops, float(nbytes)


def matmul_params(arch: dict) -> tuple[int, int]:
    """(parameters in the layers' products, parameters of the LM head's
    product) of a dense decoder: the weights a token multiplies."""
    d, L = arch["d_model"], arch["n_layers"]
    hd = arch.get("d_head") or d // arch["n_heads"]
    nq, nkv = arch["n_heads"], arch["n_kv_heads"]
    attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
    gated = arch.get("activation", "swiglu") in ("swiglu", "geglu")
    ffn = (3 if gated else 2) * d * arch["d_ff"]
    return L * (attn + ffn), d * arch["vocab_size"]


def attn_flops_fwd(arch: dict, pairs: float) -> float:
    """Attention's forward flops over ``pairs`` (query, key) pairs in every
    layer: two products of 2 D flops a pair and query head."""
    hd = arch.get("d_head") or arch["d_model"] // arch["n_heads"]
    return 4.0 * hd * arch["n_heads"] * pairs * arch["n_layers"]


def train_step_flops(arch: dict, rows: int, S: int) -> float:
    """Model flops of one training step over ``rows`` rows of ``S`` tokens:
    6 N a token and causal attention's forward and backward (3 times the
    forward); recomputation not counted."""
    layers, head = matmul_params(arch)
    return (6.0 * (layers + head) * rows * S
            + 3.0 * attn_flops_fwd(arch, rows * causal_pairs(S)))


def prefill_flops(arch: dict, S: int) -> float:
    """Model flops of one prompt's prefill: 2 N a prompt token through the
    layers, the head on the last position, causal attention."""
    layers, head = matmul_params(arch)
    return 2.0 * layers * S + 2.0 * head + attn_flops_fwd(
        arch, causal_pairs(S))


def decode_flops(arch: dict, lens) -> float:
    """Model flops of one decode step over the rows of ``lens`` (keys each
    new token reads, itself included)."""
    layers, head = matmul_params(arch)
    return (2.0 * (layers + head) * len(lens)
            + attn_flops_fwd(arch, float(sum(int(n) for n in lens))))
