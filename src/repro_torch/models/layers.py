"""Core layers: norms, MLPs, rotary embeddings, token embedding / LM head."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (dot, dot_f32, fan_in_init,
                                       is_dtensor, normal_init, ones_init,
                                       zeros_init)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(gen, d: int, kind: str, dtype, stack: tuple = ()):
    if kind == "rmsnorm":
        return {"scale": ones_init(gen, stack + (d,), dtype)}
    if kind == "layernorm":
        return {"scale": ones_init(gen, stack + (d,), dtype),
                "bias": zeros_init(gen, stack + (d,), dtype)}
    if kind == "nonparam_ln":      # OLMo: LN without learnable params
        return {}
    raise ValueError(kind)


def apply_norm(params, x, kind: str, eps: float = 1e-6):
    """f32 math, population variance, output in x.dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (y * params["scale"].float()).to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP  (swiglu / geglu / sq_relu / gelu)
# ---------------------------------------------------------------------------

def init_mlp(gen, d: int, f: int, activation: str, dtype, stack: tuple = ()):
    n = len(stack)
    p = {"wi": normal_init(gen, stack + (d, f), dtype),
         "wo": fan_in_init(gen, stack + (f, d), dtype, fan_axis=n)}
    if activation in ("swiglu", "geglu"):
        p["wg"] = normal_init(gen, stack + (d, f), dtype)
    return p


def apply_mlp(params, x, activation: str):
    h = dot(x, params["wi"])
    if activation == "swiglu":
        h = F.silu(dot(x, params["wg"])) * h
    elif activation == "geglu":             # Gemma family: gated GELU
        h = F.gelu(dot(x, params["wg"]), approximate="tanh") * h
    elif activation == "sq_relu":           # Nemotron-4: squared ReLU
        h = torch.square(F.relu(h))
    elif activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(activation)
    return dot(h, params["wo"])


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split, f32)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)              # [head_dim/2]


def rope_table(positions, head_dim: int, theta: float):
    """(cos, sin) of the rotation angles, each [..., seq, 1, head_dim/2] f32.
    A model computes it once per call and hands it to every layer."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs          # [..., seq, hd/2]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x, positions, theta: float, table=None):
    """x: [..., seq, heads, head_dim]; positions: broadcastable to [..., seq].
    ``table`` is ``rope_table(positions, head_dim, theta)`` if the caller
    already has it."""
    cos, sin = table if table is not None else rope_table(
        positions, x.shape[-1], theta)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def init_embed(gen, vocab: int, d: int, dtype, with_pos: int = 0):
    p = {"tok": normal_init(gen, (vocab, d), dtype)}
    if with_pos:
        p["pos"] = normal_init(gen, (with_pos, d), dtype)
    return p


def embed_tokens(params, tokens):
    table = params["tok"]
    if is_dtensor(table):
        return _embed_sharded(table, tokens)
    return table[tokens]


def _embed_sharded(table, tokens):
    """``table[tokens]`` of a DTensor table [V,D], each rank looking its
    tokens up in its own rows of the vocabulary (zeros for the others',
    a partial sum over the vocabulary's split), so the backward is a local
    index write (DTensor's rule for it fails on some torch versions).
    Tokens keep their batch split; the table is gathered over those mesh
    dims and over any split of D.  Where autograd does not record
    (serving) and it moves fewer bytes, a split of D stays and the tokens
    are gathered instead (the rows then relaid to the tokens' split): a
    decode step's few ids against a table that FSDP splits over the data
    axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.models.sharding import as_dtensor, dtensor
    dm = table.device_mesh
    tokens = as_dtensor(tokens, dm)
    tok_pl, tab_pl, grad_pl, out_pl = [], [], [], []
    # bytes a rank moves to keep a split of D: the looked-up rows, relaid
    rows_bytes = tokens.numel() * table.shape[1] * table.element_size() \
        / dm.size()
    keep_width = (not torch.is_grad_enabled()
                  and rows_bytes < table.to_local().nbytes)
    for i, (pt, pw) in enumerate(zip(tokens.placements, table.placements)):
        width = (keep_width and isinstance(pw, Shard) and pw.dim == 1
                 and dm.size(i) > 1)
        rows = not width and isinstance(pt, Shard) and pt.dim == 0
        vocab = not rows and isinstance(pw, Shard) and pw.dim == 0
        tok_pl.append(Shard(0) if rows else Replicate())
        tab_pl.append(Shard(0) if vocab else Shard(1) if width
                      else Replicate())
        grad_pl.append(Partial() if rows else tab_pl[-1])
        out_pl.append(Shard(0) if rows else Partial() if vocab
                      else Shard(tokens.ndim) if width else Replicate())
    tok = tokens.redistribute(dm, tok_pl).to_local()
    t = table.redistribute(dm, tab_pl).to_local(grad_placements=grad_pl)
    _, offset = compute_local_shape_and_global_offset(table.shape, dm,
                                                      tab_pl)
    idx = tok - offset[0]
    inside = (idx >= 0) & (idx < t.shape[0])
    out = torch.where(inside[..., None], t[idx.clamp(0, t.shape[0] - 1)],
                      0)
    return dtensor(out, dm, out_pl, tuple(tokens.shape) + (table.shape[1],))


def init_head(gen, d: int, vocab: int, dtype):
    return {"w": normal_init(gen, (d, vocab), dtype)}


def apply_head(params, x, embed_params=None, softcap: float = 0.0):
    """LM head, f32 logits; uses the tied embedding's transpose when
    ``params`` is None."""
    w = embed_params["tok"].T if params is None else params["w"]
    logits = dot_f32(x, w)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits
