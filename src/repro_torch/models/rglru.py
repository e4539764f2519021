"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Structure per recurrent block:
    x -> w_in -> u -----conv1d(w=4, causal)----> RG-LRU ---*--- w_out -> out
    x -> w_gate_in -> gelu gate -----------------------------^

RG-LRU:  r_t = sigmoid(u_t W_a),  i_t = sigmoid(u_t W_i)
         log a_t = -c * softplus(lam) * r_t          (c = 8)
         h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Prefill computes the linear recurrence ``h_t = a_t h_{t-1} + b_t`` as a
log-depth doubling scan over the whole prompt in f32 (the reference's
``jax.lax.associative_scan``: a handful of tensor passes, never a Python
loop over tokens); decode is one recurrent step with O(1) state: ``h`` and
the conv's last ``conv_width - 1`` inputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dot, fan_in_init, normal_init, zeros_init
from repro_torch.models.sharding import pad as pad_
from repro_torch.models.sharding import shard_dims

_C = 8.0


def init_rglru_block(gen, d: int, width: int, conv_width: int, dtype,
                     stack: tuple = ()):
    n = len(stack)
    return {
        "w_in": normal_init(gen, stack + (d, width), dtype),
        "w_gate_in": normal_init(gen, stack + (d, width), dtype),
        "conv_w": normal_init(gen, stack + (conv_width, width), dtype,
                              scale=0.1),
        "conv_b": zeros_init(gen, stack + (width,), dtype),
        "w_a": normal_init(gen, stack + (width, width), dtype, scale=0.02),
        "w_i": normal_init(gen, stack + (width, width), dtype, scale=0.02),
        # the decay parameter stays f32 whatever the model's dtype
        "lam": normal_init(gen, stack + (width,), torch.float32, scale=0.5),
        "w_out": fan_in_init(gen, stack + (width, d), dtype, fan_axis=n),
    }


def causal_conv(u, conv_w, conv_b=None):
    """u: [B,S,W]; depthwise causal conv along S (zeros before the start)."""
    cw, S = conv_w.shape[0], u.shape[1]
    pad = pad_(u, (0, 0, cw - 1, 0))
    out = pad[:, 0:S] * conv_w[0]
    for i in range(1, cw):
        out = out + pad[:, i:i + S] * conv_w[i]
    return out if conv_b is None else out + conv_b


def _gates(params, u):
    """(a, b) of the recurrence h_t = a_t h_{t-1} + b_t, both f32."""
    r = torch.sigmoid(dot(u, params["w_a"]).float())
    i = torch.sigmoid(dot(u, params["w_i"]).float())
    log_a = -_C * F.softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    b_scale = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, b_scale * i * u.float()


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along axis 1 with h_{-1} = 0: a doubling
    (Hillis-Steele) scan of the associative pairs (a, b), log2(S) passes.
    Each pass builds new tensors (no in-place writes), so autograd can take
    its backward."""
    h = b
    S, shift = a.shape[1], 1
    while shift < S:
        h = torch.cat([h[:, :shift],
                       torch.addcmul(h[:, shift:], a[:, shift:],
                                     h[:, :-shift])], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return h


def apply_rglru_block(params, x, *, h0=None, conv_state=None,
                      return_state: bool = False):
    """x: [B,S,D] -> [B,S,D].  ``h0`` / ``conv_state``: a decode-style
    initial state.  With ``return_state`` also returns (h [B,W], conv
    [B,cw-1,W]), both in x.dtype (``conv`` None without ``conv_state``)."""
    u = dot(x, params["w_in"])
    gate = F.gelu(dot(x, params["w_gate_in"]), approximate="tanh")
    if conv_state is not None:
        cw = params["conv_w"].shape[0]
        hist = torch.cat([conv_state.to(u.dtype), u], dim=1)   # [B,cw-1+S,W]
        uc = causal_conv(hist, params["conv_w"], params["conv_b"])[:, cw - 1:]
        new_conv_state = hist[:, -(cw - 1):]
    else:
        uc = causal_conv(u, params["conv_w"], params["conv_b"])
        new_conv_state = None

    a, b = _gates(params, uc)
    if h0 is not None:
        # seed the scan with the carried state via a virtual step 0
        a = torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0[:, None].float(), b], dim=1)
    hh = linear_scan(a, b)
    if h0 is not None:
        hh = hh[:, 1:]
    h = hh.to(x.dtype)
    # over a mesh: split as w_out's rows are, a partial sum and no gather of
    # the weight (the carried state h0 is whole on ``model``)
    out = dot(shard_dims(gate * h, ("dp", None, "tp")), params["w_out"])
    if return_state:
        return out, (h[:, -1], new_conv_state)
    return out


def decode_rglru_block(params, x, h_prev, conv_state):
    """x: [B,1,D]; state h [B,W], conv [B,cw-1,W] -> (out [B,1,D], h,
    conv)."""
    out, (h, new_conv) = apply_rglru_block(
        params, x, h0=h_prev, conv_state=conv_state, return_state=True)
    return out, h, new_conv
