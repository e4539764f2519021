"""xLSTM blocks (arXiv:2405.04517): chunk-parallel mLSTM + sequential sLSTM.

mLSTM (matrix memory, exponentially gated):
    C_t = f_t C_{t-1} + i_t v_t k_t^T        n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, 1)
computed in the *stabilised chunkwise-parallel* form of the reference
(log-space gate cumsums, a per-row running max M_t floored at -50, the
state carried as (C^, n^, m) with C^ = C e^{-m}): within a chunk the work is
attention-like, across chunks a Python loop over at most S / 256 chunks.

sLSTM (scalar memory, recurrent head-wise connections) is a true nonlinear
recurrence: one step a token.  The four gates' recurrent matrices are
applied as one product a step.

States are dicts of named tensors: mLSTM ``{"C", "n", "m"}`` (f32) beside
its conv tail, sLSTM ``{"c", "n", "h", "m"}`` (f32).  ``m`` starts at
``NEG_INF``, not at 0.

The reference pads a prompt to a whole number of chunks with forget-gate
logits of 0, so every padded step multiplies the carried state by
sigmoid(0) = 1/2: the state after a prompt of S > chunk tokens with
S % chunk != 0 is scaled by 2^-pad.  This port reproduces that, so that the
two packages agree token for token (ROADMAP, section C).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models.common import (dot, einsum, fan_in_init, is_dtensor,
                                       normal_init, zeros_init)
from repro_torch.models.layers import apply_mlp
from repro_torch.models.rglru import causal_conv
from repro_torch.models.sharding import (local_pointwise, local_rows,
                                         shard_dims)
from repro_torch.models.sharding import pad as pad_
from repro_torch.roofline import cost

MLSTM_EXPANSION = 2.0
SLSTM_FF_EXPANSION = 8.0 / 3.0
NEG_INF = -1e30
_GATES = ("i", "f", "z", "o")


def _logsigmoid(x):
    """``F.logsigmoid``, on each rank's shard of a DTensor (its backward has
    no DTensor rule)."""
    return local_pointwise(F.logsigmoid, x)


# ===========================================================================
# mLSTM
# ===========================================================================

def init_mlstm_block(gen, d: int, n_heads: int, conv_width: int, dtype,
                     stack: tuple = ()):
    n = len(stack)
    di = int(MLSTM_EXPANSION * d)
    hd = di // n_heads
    f32 = torch.float32
    return {
        "w_up": normal_init(gen, stack + (d, 2 * di), dtype),
        "conv_w": normal_init(gen, stack + (conv_width, di), dtype, scale=0.1),
        "w_q": normal_init(gen, stack + (di, n_heads, hd), dtype),
        "w_k": normal_init(gen, stack + (di, n_heads, hd), dtype),
        "w_v": normal_init(gen, stack + (di, n_heads, hd), dtype),
        "w_ig": normal_init(gen, stack + (di, n_heads), dtype, scale=0.01),
        "b_ig": zeros_init(gen, stack + (n_heads,), f32),
        "w_fg": normal_init(gen, stack + (di, n_heads), dtype, scale=0.01),
        "b_fg": torch.full(stack + (n_heads,), 3.0, dtype=f32,
                           device=gen.device),
        "w_down": fan_in_init(gen, stack + (di, d), dtype, fan_axis=n),
    }


def init_mlstm_state(batch: int, n_heads: int, hd: int, device) -> dict:
    f32 = torch.float32
    return {"C": torch.zeros((batch, n_heads, hd, hd), dtype=f32,
                             device=device),
            "n": torch.zeros((batch, n_heads, hd), dtype=f32, device=device),
            "m": torch.full((batch, n_heads), NEG_INF, dtype=f32,
                            device=device)}


@functools.lru_cache(maxsize=None)
def _k_scale(hd: int, dtype) -> float:
    """sqrt(hd) as the reference divides k by it: taken in f32, then rounded
    to the activations' dtype.  A Python float, so that dividing by it
    copies nothing to the card."""
    return float(torch.tensor(float(hd), dtype=torch.float32).sqrt().to(dtype))


def _mlstm_qkv_gates(params, x):
    """x: [B,S,D] -> q,k,v [B,S,H,hd], i/f gate logits [B,S,H] (f32), the
    o-gate input."""
    u = dot(x, params["w_up"])
    c_in, o_in = torch.chunk(u, 2, dim=-1)
    c_conv = F.silu(causal_conv(c_in, params["conv_w"]))
    q = einsum("btd,dhk->bthk", c_conv, params["w_q"])
    k = einsum("btd,dhk->bthk", c_conv, params["w_k"]) / _k_scale(
        q.shape[-1], x.dtype)
    v = einsum("btd,dhk->bthk", c_in, params["w_v"])
    ig = einsum("btd,dh->bth", c_in, params["w_ig"],
                out_dtype=torch.float32) + params["b_ig"]
    fg = einsum("btd,dh->bth", c_in, params["w_fg"],
                out_dtype=torch.float32) + params["b_fg"]
    return q, k, v, ig, fg, o_in


def _mlstm_chunk(state: dict, q, k, v, ig, fg):
    """One chunk of length L, all in f32.  q/k/v: [B,L,H,hd]; ig/fg:
    [B,L,H].  Returns (new state, h [B,L,H,hd])."""
    L = q.shape[1]
    q, k, v = (t.float().transpose(1, 2) for t in (q, k, v))   # [B,H,L,hd]
    ig = ig.transpose(1, 2)                                    # [B,H,L]
    logf = _logsigmoid(fg).transpose(1, 2)
    b = torch.cumsum(logf, dim=-1)            # cumulative log forget
    b_total = b[..., -1]
    m0 = state["m"]

    # scores D[t,s] = b_t - b_s + ig_s   (s <= t)
    Dm = b[..., :, None] - b[..., None, :] + ig[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    Dm = torch.where(mask, Dm, torch.full_like(Dm, NEG_INF))
    m_intra = Dm.amax(dim=-1)                                  # [B,H,L]
    m_inter = b + m0[..., None]                 # C_0 contribution scale
    M = torch.maximum(m_intra, m_inter)
    M = torch.clamp(M, min=-50.0)               # floor against underflow
    P = torch.exp(Dm - M[..., None])                           # [B,H,L,L]

    scores = q @ k.transpose(-1, -2)            # k pre-scaled by 1/sqrt(hd)
    W = P * scores
    num_intra = W @ v
    den_intra = torch.einsum("bhts,bhsd->bht", W, k)

    inter_scale = torch.exp(b + m0[..., None] - M)             # [B,H,L]
    num_inter = (q @ state["C"]) * inter_scale[..., None]
    den_inter = torch.einsum("bhtd,bhd->bht", q, state["n"]) * inter_scale

    num = num_intra + num_inter
    den = den_intra + den_inter
    h = num / torch.maximum(den.abs(), torch.exp(-M))[..., None]

    # state update to the end of the chunk
    decay = b_total[..., None] - b + ig                        # [B,H,L]
    m_new = torch.maximum(b_total + m0, decay.amax(dim=-1))
    carry_scale = torch.exp(b_total + m0 - m_new)
    upd = torch.exp(decay - m_new[..., None])                  # [B,H,L]
    C_new = (state["C"] * carry_scale[..., None, None]
             + (upd[..., None] * k).transpose(-1, -2) @ v)
    n_new = state["n"] * carry_scale[..., None] + torch.einsum(
        "bhs,bhsd->bhd", upd, k)
    return {"C": C_new, "n": n_new, "m": m_new}, h.transpose(1, 2)


_MLSTM_STATE = ("C", "n", "m")


def _mlstm_scan(q, k, v, ig, fg, *state, chunk: int):
    """The chunks of q/k/v [B,S,H,hd], ig/fg [B,S,H] (S a multiple of
    ``chunk``) from ``state`` (C, n, m): (h [B,S,H,hd], C, n, m at the
    end).  Traced on ``meta`` under a dry-run's counter, one chunk stands
    for all."""
    if q.is_meta and cost.counting():
        def one(*args):
            st, h = _mlstm_chunk(dict(zip(_MLSTM_STATE, args[5:])),
                                 *(t[:, :chunk] for t in args[:5]))
            return (h, *(st[n] for n in _MLSTM_STATE))
        outs = [(tuple(q.shape), torch.float32)] + [
            (tuple(t.shape), t.dtype) for t in state]
        return cost.loop_once(one, q.shape[1] // chunk, outs, q, k, v, ig,
                              fg, *state)
    st = dict(zip(_MLSTM_STATE, state))
    hs = []
    for c0 in range(0, q.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        st, h = _mlstm_chunk(st, q[:, sl], k[:, sl], v[:, sl], ig[:, sl],
                             fg[:, sl])
        hs.append(h)
    return (torch.cat(hs, dim=1), *(st[n] for n in _MLSTM_STATE))


def apply_mlstm_block(params, x, *, chunk: int = 256, state: dict = None,
                      return_state: bool = False):
    """x: [B,S,D] -> [B,S,D] (chunkwise-parallel mLSTM).

    With ``return_state`` returns (out, (state, conv_tail)), conv_tail the
    last ``conv_width - 1`` pre-conv activations (the decode carry)."""
    B, S, _ = x.shape
    q, k, v, ig, fg, o_in = _mlstm_qkv_gates(params, x)
    H, hd = q.shape[2], q.shape[3]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        # the reference's padding: zeros for q/k/v and the forget logits,
        # NEG_INF for the input logits
        q, k, v = (pad_(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        ig = pad_(ig, (0, 0, 0, pad), value=NEG_INF)
        fg = pad_(fg, (0, 0, 0, pad))
    st = (state if state is not None
          else init_mlstm_state(B, H, hd, x.device))
    # over a mesh each rank runs its rows' chunks on local tensors
    h, *last = local_rows(functools.partial(_mlstm_scan, chunk=chunk), q, k,
                          v, ig, fg, *(st[n] for n in _MLSTM_STATE))
    st = dict(zip(_MLSTM_STATE, last))
    h = h.reshape(B, S + pad, H * hd)[:, :S].to(x.dtype)
    out = dot(h * F.silu(o_in), params["w_down"])
    if return_state:
        cw = params["conv_w"].shape[0]
        c_in = dot(x, params["w_up"])[..., :params["w_q"].shape[0]]
        tail = pad_(c_in, (0, 0, cw - 1, 0))[:, -(cw - 1):]
        return out, (st, tail)
    return out


def _mlstm_step(q, k, v, ig, fg, C, n, m, *, k_rows=slice(None),
                total=lambda t: t):
    """One token's recurrence: q/k/v [B,H,hd] and the gate logits ig/fg
    [B,H] (f32) from the state (C, n, m): (h [B,H,hd], C, n, m).  ``C`` may
    hold only rows ``k_rows`` of its k dim (dim 2); then ``C q`` over them
    is a partial sum, which ``total`` completes."""
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(logf + m, ig)
    f_s = torch.exp(logf + m - m_new)
    i_s = torch.exp(ig - m_new)
    C = (C * f_s[..., None, None]
         + i_s[..., None, None] * k[..., k_rows, None] * v[..., None, :])
    n = n * f_s[..., None] + i_s[..., None] * k
    num = total((q[..., None, k_rows] @ C)[..., 0, :])
    den = (q * n).sum(-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h, C, n, m_new


def _mlstm_step_sharded(q, k, v, ig, fg, C, n, m):
    """``_mlstm_step`` over a mesh, the state C [B,H,hd,hd] left where
    ``launch/shardings.cache_shardings`` puts it: rows over the data axes,
    its k dim (or, where hd does not divide, its heads) over ``model``.
    The token's q, k, v, gates and n, m (B x H x hd at most) are laid out
    by C's rows and heads; each rank updates its block of C and reduces
    ``C q`` over a split k dim: no collective carries the state, as in the
    reference's step."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.models.sharding import as_dtensor, dtensor
    dm = C.device_mesh
    # the token tensors share C's first two dims (rows, heads)
    pl = [p if p.is_shard(0) or p.is_shard(1) else Replicate()
          for p in C.placements]
    split = [p.is_shard(2) for p in C.placements]

    def local(t):
        return as_dtensor(t, dm).redistribute(dm, pl).to_local()

    def total(num):
        part = [Partial() if s else p for s, p in zip(split, pl)]
        return dtensor(num, dm, part, tuple(q.shape)).redistribute(
            dm, pl).to_local()

    size, first = compute_local_shape_and_global_offset(C.shape, dm,
                                                        C.placements)
    h, c, nl, ml = _mlstm_step(
        *(local(t) for t in (q, k, v, ig, fg)), C.to_local(), local(n),
        local(m), k_rows=slice(first[2], first[2] + size[2]), total=total)
    return (dtensor(h, dm, pl, tuple(q.shape)),
            dtensor(c, dm, C.placements, tuple(C.shape)),
            dtensor(nl, dm, pl, tuple(n.shape)),
            dtensor(ml, dm, pl, tuple(m.shape)))


def decode_mlstm_block(params, x, state: dict, conv_state):
    """Single-token recurrent step.  x: [B,1,D] -> (out, state, conv).

    Over a mesh the recurrence runs on the state's own layout
    (``_mlstm_step_sharded``), and the inputs of v, the gates and the down
    projection are split over ``model`` as their weights are, so that those
    products leave partial sums instead of gathering the weights."""
    u = dot(x, params["w_up"])
    c_in, o_in = torch.chunk(u, 2, dim=-1)
    hist = torch.cat([conv_state.to(c_in.dtype), c_in], dim=1)  # [B,cw,Di]
    c_conv = F.silu(einsum("btd,td->bd", hist, params["conv_w"]))[:, None]
    c_in = shard_dims(c_in, ("dp", None, "tp"))
    q = einsum("btd,dhk->bthk", c_conv, params["w_q"])[:, 0].float()
    k = (einsum("btd,dhk->bthk", c_conv, params["w_k"])[:, 0]
         / _k_scale(q.shape[-1], x.dtype)).float()
    v = einsum("btd,dhk->bthk", c_in, params["w_v"])[:, 0].float()
    ig = (einsum("btd,dh->bth", c_in, params["w_ig"],
                 out_dtype=torch.float32)[:, 0] + params["b_ig"])
    fg = (einsum("btd,dh->bth", c_in, params["w_fg"],
                 out_dtype=torch.float32)[:, 0] + params["b_fg"])
    st = (state[name] for name in _MLSTM_STATE)
    step = _mlstm_step_sharded if is_dtensor(state["C"]) else _mlstm_step
    h, C, n, m = step(q, k, v, ig, fg, *st)
    h = h.reshape(x.shape[0], 1, -1).to(x.dtype)
    out = dot(shard_dims(h * F.silu(o_in), ("dp", None, "tp")),
              params["w_down"])
    return out, {"C": C, "n": n, "m": m}, hist[:, 1:]


# ===========================================================================
# sLSTM
# ===========================================================================

def init_slstm_block(gen, d: int, n_heads: int, dtype, stack: tuple = ()):
    n = len(stack)
    hd = d // n_heads
    p = {}
    for g in _GATES:
        p[f"w_{g}"] = normal_init(gen, stack + (d, n_heads, hd), dtype)
        p[f"r_{g}"] = normal_init(gen, stack + (n_heads, hd, hd), dtype,
                                  scale=0.02)
        p[f"b_{g}"] = torch.full(stack + (n_heads, hd),
                                 2.0 if g == "f" else 0.0,
                                 dtype=torch.float32, device=gen.device)
    f = int(SLSTM_FF_EXPANSION * d) // 64 * 64 or 64
    p["ffn_wi"] = normal_init(gen, stack + (d, f), dtype)
    p["ffn_wg"] = normal_init(gen, stack + (d, f), dtype)
    p["ffn_wo"] = fan_in_init(gen, stack + (f, d), dtype, fan_axis=n)
    return p


def init_slstm_state(batch: int, n_heads: int, hd: int, device) -> dict:
    z = torch.zeros((batch, n_heads, hd), dtype=torch.float32, device=device)
    return {"c": z, "n": z.clone(), "h": z.clone(), "m": z + NEG_INF}


def _slstm_step(params, R, state: dict, wx):
    """One step.  R: the four recurrent matrices side by side [H,hd,4hd]
    (f32); wx: the input contributions [B,H,4,hd] of this step."""
    H, hd = R.shape[0], R.shape[1]
    rec = torch.einsum("bhd,hdk->bhk", state["h"], R).view(-1, H, 4, hd)
    pre = wx + rec
    il = pre[:, :, 0] + params["b_i"]
    fl = pre[:, :, 1] + params["b_f"]
    zl = torch.tanh(pre[:, :, 2] + params["b_z"])
    ol = torch.sigmoid(pre[:, :, 3] + params["b_o"])
    logf = _logsigmoid(fl)
    m_new = torch.maximum(logf + state["m"], il)
    i_s = torch.exp(il - m_new)
    f_s = torch.exp(logf + state["m"] - m_new)
    c = f_s * state["c"] + i_s * zl
    n = torch.clamp(f_s * state["n"] + i_s, min=1e-6)
    h = ol * c / n
    return {"c": c, "n": n, "h": h, "m": m_new}


_STATE = ("c", "n", "h", "m")


def _slstm_scan(wx, R, b_i, b_f, b_z, b_o, *state):
    """The recurrence over the S steps of wx [B,S,H,4,hd] from ``state``
    (c, n, h, m): (h [B,S,H,hd], c, n, h, m at the end).  Traced on
    ``meta`` under a dry-run's counter, one step stands for the S."""
    params = {"b_i": b_i, "b_f": b_f, "b_z": b_z, "b_o": b_o}
    if wx.is_meta and cost.counting():
        def one(wx, R, *rest):
            p = dict(zip(("b_i", "b_f", "b_z", "b_o"), rest[:4]))
            st = _slstm_step(p, R, dict(zip(_STATE, rest[4:])), wx[:, 0])
            return tuple(st[k] for k in _STATE)
        B, S, H, _, hd = wx.shape
        outs = [((B, S, H, hd), torch.float32)] + [
            (tuple(t.shape), t.dtype) for t in state]
        return cost.loop_once(one, S, outs, wx, R, b_i, b_f, b_z, b_o,
                              *state)
    st = dict(zip(_STATE, state))
    hs = []
    for t in range(wx.shape[1]):
        st = _slstm_step(params, R, st, wx[:, t])
        hs.append(st["h"])
    return (torch.stack(hs, dim=1), *(st[k] for k in _STATE))


def apply_slstm_block(params, x, *, state: dict = None,
                      return_state: bool = False):
    """x: [B,S,D] -> [B,S,D] (a step a token; inherent to the sLSTM)."""
    B, S, D = x.shape
    H, hd = params["w_i"].shape[1], params["w_i"].shape[2]
    wx = torch.stack([einsum("btd,dhk->bthk", x, params[f"w_{g}"],
                             out_dtype=torch.float32) for g in _GATES],
                     dim=3)                                    # [B,S,H,4,hd]
    R = torch.cat([params[f"r_{g}"].float() for g in _GATES], dim=-1)
    st = state if state is not None else init_slstm_state(B, H, hd, x.device)
    # over a mesh each rank runs its rows' recurrence on local tensors
    h, *last = local_rows(_slstm_scan, wx, R,
                          *(params[f"b_{g}"] for g in _GATES),
                          *(st[k] for k in _STATE), shared=(1, 2, 3, 4, 5))
    st = dict(zip(_STATE, last))
    h = h.reshape(B, S, D).to(x.dtype)
    out = h + apply_mlp({"wi": params["ffn_wi"], "wg": params["ffn_wg"],
                         "wo": params["ffn_wo"]}, h, "swiglu")
    if return_state:
        return out, st
    return out


def decode_slstm_block(params, x, state: dict):
    return apply_slstm_block(params, x, state=state, return_state=True)
