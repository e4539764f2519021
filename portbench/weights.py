"""The benchmark's weights: drawn on the device from ``--seed`` in a few
large calls, in the dtype they are served in, laid out as the port's
parameter tree (``transformer.init_lm`` on the ``meta`` device gives the
shapes; nothing is drawn there).

Every leaf is a view of one flat buffer filled by ``normal_`` from one
``torch.Generator`` a chunk of ``CHUNK`` elements at a time, then scaled
in place as the port's initialisers scale it: 0.02, except an output
projection ``wo`` (``1/sqrt`` of its first axis after the layer axis);
norm scales are ones and biases zeros.
"""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 30
ALIGN = 256          # elements: every leaf starts 512-byte aligned


def _paths(tree: dict, prefix: str = ""):
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _paths(v, path)
        else:
            yield path, v


def _std(path: str, shape: tuple) -> float:
    name = path.rsplit("/", 1)[-1]
    if name == "wo":
        stacked = path.startswith("blocks/")
        return 1.0 / math.sqrt(shape[1 if stacked else 0])
    return 0.02


def make(layout: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """A tree shaped as ``layout`` (a tree of tensors whose shapes count,
    e.g. on ``meta``), filled from ``seed`` on ``device``."""
    leaves = list(_paths(layout))
    offsets, total = [], 0
    for _, t in leaves:
        offsets.append(total)
        total += -(-t.numel() // ALIGN) * ALIGN
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for i in range(0, total, CHUNK):
        flat[i:i + CHUNK].normal_(0.0, 1.0, generator=gen)
    out: dict = {}
    for (path, t), off in zip(leaves, offsets):
        view = flat[off:off + t.numel()].view(t.shape)
        name = path.rsplit("/", 1)[-1]
        if name == "scale":
            view.fill_(1)
        elif name.startswith("b") and name != "blocks":
            view.zero_()
        else:
            view.mul_(_std(path, tuple(t.shape)))
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = view
    _keep_empty(layout, out)
    return out


def _keep_empty(layout: dict, out: dict) -> None:
    """Empty groups of the layout (a norm without parameters) stay empty
    dicts in the made tree, as the port's code looks them up."""
    for k, v in layout.items():
        if isinstance(v, dict):
            if k not in out:
                out[k] = {}
            _keep_empty(v, out[k])
