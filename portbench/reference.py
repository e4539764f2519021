"""Plain PyTorch reference of the benchmark's dense decoders.

It imports nothing of the port and takes nothing the port made: it reads
the weights the benchmark made (``weights.make``) in the port's layout, as
nested dicts ``{"embed": {"tok"}, "head": {"w"}, "final_norm",
"blocks": {"0": {"ln1", "attn": {"wq","wk","wv","wo"}, "ln2",
"mlp": {"wi","wg","wo"}}}}`` with a leading layer axis under ``blocks``,
and the same tokens.  Each layer's weights are upcast to float32 when the
layer runs, so the model never sits in float32 at once.

``mode`` is the precision of every product: ``"f32"`` (TF32 off) or
``"fp8"``, the control: both operands of each product rounded to float8
e4m3 with a per-tensor scale (accumulation in float32), the gradient
passing straight through the rounding.

The equations follow the port's configurations: pre-norm blocks (RMSNorm
with a scale, or OLMo's LayerNorm without parameters, eps 1e-6), GQA with
half-split RoPE, SwiGLU, a final norm, the head (or the tied embedding's
transpose) in float32.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

EPS = 1e-6
FP8_MAX = 448.0
Q_CHUNK = 1024          # queries a block of the serving reference's attention


@contextlib.contextmanager
def no_tf32():
    """TF32 off for the block: float32 products in float32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "fp8":
        a, b = _fp8(a), _fp8(b)
    return a @ b


def norm(x, scale, kind: str):
    if kind == "rmsnorm":
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * scale
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + EPS)
    if kind == "layernorm":
        raise ValueError("layernorm with parameters is not in this reference")
    return y


def rope(x, positions, theta: float):
    """x [..., T, H, D]; positions [T]."""
    D = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                         device=x.device) / D)
    ang = positions.to(torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def layer(W: dict, g: int) -> dict:
    """Layer ``g``'s weights in float32 (norm scales absent for OLMo)."""
    b = W["blocks"]["0"]

    def f(t):
        return t[g].to(torch.float32)

    return {"ln1": f(b["ln1"]["scale"]) if b.get("ln1") else None,
            "ln2": f(b["ln2"]["scale"]) if b.get("ln2") else None,
            **{k: f(v) for k, v in b["attn"].items()},
            **{"m_" + k: f(v) for k, v in b["mlp"].items()}}


def n_layers(W: dict) -> int:
    return W["blocks"]["0"]["attn"]["wq"].shape[0]


def attention(q, k, v, mode: str, q0: int = 0):
    """Causal GQA over one sequence: q [Tq, Hq, D] at positions q0.. against
    k, v [Tk, Hk, D] at positions 0.. -> [Tq, Hq, D]."""
    Tq, Hq, D = q.shape
    Tk, Hk, _ = k.shape
    G = Hq // Hk
    qg = q.reshape(Tq, Hk, G, D).permute(1, 2, 0, 3)          # [Hk,G,Tq,D]
    kt = k.permute(1, 2, 0)[:, None]                          # [Hk,1,D,Tk]
    s = mm(qg, kt, mode) / math.sqrt(D)                       # [Hk,G,Tq,Tk]
    qpos = q0 + torch.arange(Tq, device=q.device)[:, None]
    kpos = torch.arange(Tk, device=q.device)[None, :]
    s = s.masked_fill(kpos > qpos, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = mm(p, v.permute(1, 0, 2)[:, None], mode)              # [Hk,G,Tq,D]
    return o.permute(2, 0, 1, 3).reshape(Tq, Hq, D)


def block(p: dict, x, arch: dict, positions, mode: str, q_chunk: int = 0):
    """One pre-norm block on one sequence x [T, d] (f32)."""
    kind = arch["norm"]
    h = norm(x, p["ln1"], kind)
    T = x.shape[0]

    def proj(w):                                    # [d, H, D]
        return mm(h, w.reshape(w.shape[0], -1), mode).reshape(
            T, w.shape[1], w.shape[2])

    q = rope(proj(p["wq"]), positions, arch["rope_theta"])
    k = rope(proj(p["wk"]), positions, arch["rope_theta"])
    v = proj(p["wv"])
    if q_chunk:
        o = torch.cat([attention(q[c:c + q_chunk], k[:c + q_chunk],
                                 v[:c + q_chunk], mode, c)
                       for c in range(0, T, q_chunk)])
    else:
        o = attention(q, k, v, mode)
    wo = p["wo"]
    x = x + mm(o.reshape(T, -1), wo.reshape(-1, wo.shape[-1]), mode)
    h = norm(x, p["ln2"], kind)
    a = F.silu(mm(h, p["m_wg"], mode)) * mm(h, p["m_wi"], mode)
    return x + mm(a, p["m_wo"], mode)


def head_weight(W: dict) -> torch.Tensor:
    if "head" in W:
        return W["head"]["w"].to(torch.float32)
    return W["embed"]["tok"].to(torch.float32).T


def final_norm(W: dict, x, arch: dict):
    fn = W.get("final_norm") or {}
    scale = fn["scale"].to(torch.float32) if "scale" in fn else None
    return norm(x, scale, arch["norm"])


@torch.no_grad()
def served_logits(W: dict, arch: dict, seqs: list, firsts: list,
                  mode: str = "f32") -> list:
    """Float32 logits [T_i - first_i, V] at positions first_i .. T_i - 1 of
    each token sequence ``seqs[i]`` (a 1-D device tensor), layer by layer
    over all sequences."""
    xs = [W["embed"]["tok"][s].to(torch.float32) for s in seqs]
    pos = [torch.arange(len(s), device=s.device) for s in seqs]
    for g in range(n_layers(W)):
        p = layer(W, g)
        xs = [block(p, x, arch, ps, mode, Q_CHUNK) for x, ps in zip(xs, pos)]
        del p
    hw = head_weight(W)
    return [mm(final_norm(W, x[f:], arch), hw, mode)
            for x, f in zip(xs, firsts)]


def loss_sum(params: dict, arch: dict, tokens, labels, mode: str):
    """Sum of the next-token NLL over one row's valid labels (>= 0), and
    their count; ``params`` as ``W`` but float32 leaves."""
    x = params["embed"]["tok"][tokens]
    positions = torch.arange(tokens.shape[0], device=tokens.device)
    for g in range(n_layers(params)):
        x = block(layer(params, g), x, arch, positions, mode)
    logits = mm(final_norm(params, x, arch), head_weight(params), mode)
    valid = labels >= 0
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, labels.clamp_min(0)[:, None])[:, 0]
    return (nll * valid).sum(), valid.sum()


def tree_items(tree: dict, prefix: str = ""):
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from tree_items(v, path)
        else:
            yield path, v


def tree_set(tree: dict, path: str, value) -> None:
    *head, last = path.split("/")
    for k in head:
        tree = tree.setdefault(k, {})
    tree[last] = value


def lr_at(step: int, opt: dict) -> float:
    """The cosine schedule with linear warm-up, of the 0-based step."""
    base, warm = opt["lr"], opt["warmup_steps"]
    total, min_ratio = opt["total_steps"], 0.1
    if step < warm:
        return base * min(1.0, (step + 1) / max(1, warm))
    frac = min(max((step - warm) / max(1, total - warm), 0.0), 1.0)
    return base * (min_ratio + (1 - min_ratio) * 0.5
                   * (1 + math.cos(math.pi * frac)))


def train_steps(W: dict, arch: dict, batches: list, opt: dict,
                mode: str = "f32") -> dict:
    """AdamW steps from the bf16 weights ``W``, one a batch of ``batches``
    ({"tokens", "labels"} [R, S] on the device), a row at a time with the
    gradients summed in float32.  Parameters are stored in the weights'
    dtype after each update, as the configuration states; the moments in
    float32.  Returns each step's loss, the first step's clipped gradient
    (per path, float32) and the parameters after the last step."""
    store = {p: t for p, t in tree_items(W)}
    mu = {p: torch.zeros(t.shape, device=t.device) for p, t in store.items()}
    nu = {p: torch.zeros(t.shape, device=t.device) for p, t in store.items()}
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses, first_grad = [], None
    for i, batch in enumerate(batches):
        leaves = {p: t.to(torch.float32).requires_grad_(True)
                  for p, t in store.items()}
        tree: dict = {}
        for p, t in leaves.items():
            tree_set(tree, p, t)
        grads = {p: torch.zeros_like(t) for p, t in leaves.items()}
        toks, labs = batch["tokens"], batch["labels"]
        count = int((labs >= 0).sum())
        total = 0.0
        for r in range(toks.shape[0]):
            s, _ = loss_sum(tree, arch, toks[r], labs[r], mode)
            s = s / count
            gs = torch.autograd.grad(s, list(leaves.values()),
                                     allow_unused=True)
            for (p, _), gr in zip(leaves.items(), gs):
                if gr is not None:
                    grads[p] += gr
            total += float(s.detach())
        losses.append(total)
        gnorm = math.sqrt(sum(float((g * g).sum()) for g in grads.values()))
        clip = min(1.0, opt["grad_clip"] / max(gnorm, 1e-12))
        lr = lr_at(i, opt)
        c1, c2 = 1 - b1 ** (i + 1), 1 - b2 ** (i + 1)
        with torch.no_grad():
            for p, t in store.items():
                g = grads[p] * clip
                mu[p] = b1 * mu[p] + (1 - b1) * g
                nu[p] = b2 * nu[p] + (1 - b2) * g * g
                upd = (mu[p] / c1) / (torch.sqrt(nu[p] / c2) + eps)
                if t.ndim >= 2:
                    upd = upd + wd * t.to(torch.float32)
                store[p] = (t.to(torch.float32) - lr * upd).to(t.dtype)
                if i == 0:
                    grads[p] = g
        if i == 0:
            first_grad = grads
        del leaves, tree
    return {"losses": losses, "first_grad": first_grad, "params": store}
