"""Mixture-of-Experts layer with sort-based capacity dispatch.

The reference's algorithm (``repro/models/moe.py``), step for step:

  1. top-k routing in f32 -> (token, expert, gate) triples, T*k of them
  2. stable sort of the triples by expert id (token-major, k-minor before it)
  3. position in expert from the exclusive cumsum of the expert counts
  4. scatter of the token activations into an [E, C, D] buffer; a triple
     past its expert's capacity goes to the drop slot ``E*C``
  5. the experts' SwiGLU as batched matrix products over E
  6. gather back and the f32 gate-weighted combine

Each batch row is one group with its own capacity ``C`` (from the row's
``S`` tokens), so a decode step (``T = 1``) has ``C = 8``.  Shared experts
run as one dense SwiGLU.  The Switch load-balance loss and the router
z-loss are returned beside the output.

Routing is discontinuous: a tiny change of the router's input can flip a
top-k choice.  ``apply_moe`` therefore returns the expert ids it chose when
asked (``return_ids``) and takes them back (``expert_ids``), so that two
runs that should agree up to rounding elsewhere can share one routing.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.sharding import local_rows, shard_dims
from repro_torch.models.common import einsum, fan_in_init, normal_init
from repro_torch.models.layers import apply_mlp


def init_moe(gen, d: int, cfg: MoEConfig, dtype, stack: tuple = ()):
    n = len(stack)
    E, F_ = cfg.n_experts, cfg.expert_d_ff
    p = {
        "router": normal_init(gen, stack + (d, E), dtype, scale=0.02),
        "wi": normal_init(gen, stack + (E, d, F_), dtype),
        "wg": normal_init(gen, stack + (E, d, F_), dtype),
        "wo": fan_in_init(gen, stack + (E, F_, d), dtype, fan_axis=n + 1),
    }
    if cfg.n_shared_experts:
        f_shared = cfg.shared_d_ff * cfg.n_shared_experts
        p["shared_wi"] = normal_init(gen, stack + (d, f_shared), dtype)
        p["shared_wg"] = normal_init(gen, stack + (d, f_shared), dtype)
        p["shared_wo"] = fan_in_init(gen, stack + (f_shared, d), dtype,
                                     fan_axis=n)
    return p


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(8, (c + 7) // 8 * 8)


def _moe_grouped(params, xg, cfg: MoEConfig, C: int,
                 expert_ids: Optional[torch.Tensor] = None):
    """Grouped dispatch + expert MLP.  xg: [G, T, D] with G = batch rows.
    Returns (out [G,T,D] f32, lb_loss, z_loss, expert_ids [G,T,K])."""
    G, T, D = xg.shape
    E, K = cfg.n_experts, cfg.top_k

    logits = einsum("gtd,de->gte", xg, params["router"],
                    out_dtype=torch.float32)
    probs = torch.softmax(logits, dim=-1)                         # [G,T,E]
    if expert_ids is None:
        gate_vals, expert_ids = torch.topk(probs, K, dim=-1)      # [G,T,K]
    else:
        gate_vals = torch.gather(probs, -1, expert_ids)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    # aux losses (Switch LB + router z), averaged over groups
    me = probs.mean(dim=1)                                        # [G,E]
    counts = F.one_hot(expert_ids, E).sum(dim=(1, 2))             # [G,E]
    ce = counts.float() / (T * K)
    lb_loss = (E * (me * ce).sum(-1)).mean()
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # sort-based dispatch within each group (all ops batched over G)
    flat_eid = expert_ids.reshape(G, T * K)
    flat_tok = torch.arange(T, device=xg.device).repeat_interleave(K)
    flat_tok = flat_tok.expand(G, T * K)
    flat_gate = gate_vals.reshape(G, T * K)
    order = torch.argsort(flat_eid, dim=1, stable=True)
    s_eid = torch.gather(flat_eid, 1, order)
    s_tok = torch.gather(flat_tok, 1, order)
    s_gate = torch.gather(flat_gate, 1, order)

    starts = torch.cumsum(counts, dim=1) - counts                 # exclusive
    pos_in_e = (torch.arange(T * K, device=xg.device)[None]
                - torch.gather(starts, 1, s_eid))
    keep = pos_in_e < C
    slot = torch.where(keep, s_eid * C + pos_in_e,
                       torch.full_like(s_eid, E * C))             # drop slot

    expert_in = local_rows(functools.partial(_dispatch, E=E, C=C), xg, slot,
                           s_tok)
    expert_in = shard_dims(expert_in, ("dp", None, None, None))

    h = einsum("gecd,edf->gecf", expert_in, params["wi"])
    g = einsum("gecd,edf->gecf", expert_in, params["wg"])
    h = shard_dims(F.silu(g) * h, ("dp", None, None, "tp"))
    expert_out = einsum("gecf,efd->gecd", h, params["wo"])
    expert_out = shard_dims(expert_out, ("dp", None, None, None))

    out = local_rows(functools.partial(_combine, T=T), expert_out, slot,
                     s_tok, s_gate)
    return out, lb_loss, z_loss, expert_ids


def _dispatch(xg, slot, s_tok, *, E: int, C: int):
    """Each kept (token, choice) of a group into its expert's slot:
    [G,T,D] -> [G,E,C,D]."""
    G, TK = slot.shape
    D = xg.shape[-1]
    gathered = torch.gather(xg, 1, s_tok[..., None].expand(G, TK, D))
    buf = torch.zeros((G, E * C + 1, D), dtype=xg.dtype, device=xg.device)
    # every kept triple has its own slot; the dropped ones all land in the
    # drop slot, which is cut off below
    buf.scatter_(1, slot[..., None].expand(G, TK, D), gathered)
    return buf[:, :-1].reshape(G, E, C, D)


def _combine(expert_out, slot, s_tok, s_gate, *, T: int):
    """The experts' outputs back to their tokens, gate-weighted, in f32:
    [G,E,C,D] -> [G,T,D]."""
    G, E, C, D = expert_out.shape
    TK = slot.shape[1]
    flat_out = torch.cat([expert_out.reshape(G, E * C, D),
                          expert_out.new_zeros((G, 1, D))], dim=1)
    picked = torch.gather(flat_out, 1, slot[..., None].expand(G, TK, D))
    contrib = picked.float() * s_gate[..., None]
    out = torch.zeros((G, T, D), dtype=torch.float32,
                      device=expert_out.device)
    out.scatter_add_(1, s_tok[..., None].expand(G, TK, D), contrib)
    return out


def apply_moe(params, x, cfg: MoEConfig, *,
              expert_ids: Optional[torch.Tensor] = None,
              return_ids: bool = False):
    """x: [B,S,D] (or [T,D]).  Returns (out, (lb_loss, z_loss)); with
    ``return_ids`` also the chosen experts [G,T,K].  ``expert_ids`` replays
    a routing instead of choosing one (the gates are still this call's)."""
    orig_shape = x.shape
    D = x.shape[-1]
    if x.ndim == 3:
        xg = x
        C = _capacity(x.shape[1], cfg)
    else:
        xg = x.reshape(1, -1, D)
        C = _capacity(xg.shape[1], cfg)
    out, lb_loss, z_loss, ids = _moe_grouped(params, xg, cfg, C, expert_ids)
    out = out.reshape(orig_shape)

    if cfg.n_shared_experts:
        sh = {"wi": params["shared_wi"], "wg": params["shared_wg"],
              "wo": params["shared_wo"]}
        out = out + apply_mlp(sh, x, "swiglu").float()
    out = out.to(x.dtype)
    if return_ids:
        return out, (lb_loss, z_loss), ids
    return out, (lb_loss, z_loss)
