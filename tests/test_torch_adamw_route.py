"""Which route the port's AdamW update takes, decided on the CPU.

``optim.optimizers.fused_route`` picks the fused kernels of
``kernels/adamw`` from what the inputs are: every leaf a plain CUDA tensor,
f32 or bf16 moments.  CPU leaves, int8 moments and DTensor leaves keep the
plain route and launch nothing; a gradient in any layout (transposed, or a
view cut from int8 blocks by ``grad_compress``) takes the fused route; a CUDA
tree the kernels cannot take (mixed devices, float16) raises.
CUDA leaves are fake tensors here (``FakeTensorMode``: a device and a dtype,
no storage), so the decision is tested without a card, and the update runs
where the leaves are real: on the CPU, and as DTensors in a process of its
own under a one-rank gloo group.
"""
import contextlib
import subprocess
import sys
import textwrap

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_ranks import free_port, rank_env
from repro_torch.kernels.adamw import ops as fused
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import optimizers as opt

SHAPES = {"a": (3, 7), "b": {"w": (2, 3, 260)}, "n": (5,)}

# the state of one update under a one-rank process group: every leaf a
# DTensor over a (1,) mesh of the CPU
DTENSOR_JOB = textwrap.dedent("""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.kernels.adamw import ops as fused
    from repro_torch.optim import optimizers as opt
    dist.init_process_group("gloo", init_method="tcp://localhost:{port}",
                            rank=0, world_size=1)
    mesh = init_device_mesh("cpu", (1,))
    gen = torch.Generator().manual_seed(0)

    def leaf(shape):
        return DTensor.from_local(torch.randn(shape, generator=gen), mesh,
                                  [Replicate()])

    cfg = opt.AdamWConfig()
    params = {{"a": leaf((3, 7)), "n": leaf((5,))}}
    grads = {{"a": leaf((3, 7)), "n": leaf((5,))}}
    state = opt.adamw_init(params, cfg)
    assert not opt.fused_route(params, grads, state, cfg)
    with implicit_replication():
        new, st, _ = opt.adamw_update(params, grads, state, cfg)
    assert all(isinstance(x, DTensor) for x in (*new.values(), *st.mu.values()))
    assert fused.launches == 0
    dist.destroy_process_group()
    print("plain")
""")


def _tree(device, dtype, moments, *, grad_device=None, transpose=False,
          dequantize=False):
    """(params, grads, state, cfg) of ``SHAPES`` on ``device``; the grads
    on ``grad_device`` if given, the first one transposed if asked, each an
    f32 view cut from padded int8-sized blocks if asked (as ``dequantize``
    returns a leaf whose last dim is not a multiple of QBLOCK)."""
    def draw(shape, dev):
        return torch.randn(shape, dtype=dtype, device=dev)

    cfg = opt.AdamWConfig(moment_dtype=moments)
    params = tree_map(lambda s: draw(s, device), SHAPES)
    grads = tree_map(lambda s: draw(s, grad_device or device), SHAPES)
    if transpose:
        grads["a"] = draw((7, 3), device).t()
    if dequantize:
        grads = tree_map(lambda s: draw(
            s[:-1] + (s[-1] + (-s[-1]) % opt.QBLOCK,), device).float().narrow(
                -1, 0, s[-1]), SHAPES)
        assert not grads["a"].is_contiguous()
    if moments == "int8" and device != "cpu":
        # int8 moments as adamw_init lays them out (its quantize of zeros
        # does not run on fake tensors)
        def zero_blocks(s):
            blocks = s[:-1] + (-(-s[-1] // opt.QBLOCK),)
            return opt.QTensor(
                torch.zeros(blocks[:-1] + (blocks[-1] * opt.QBLOCK,),
                            dtype=torch.int8, device=device),
                torch.full(blocks, 1e-12, device=device), s)
        state = opt.OptState(torch.zeros((), dtype=torch.int32, device=device),
                             tree_map(zero_blocks, SHAPES),
                             tree_map(zero_blocks, SHAPES))
        return params, grads, state, cfg
    return params, grads, opt.adamw_init(params, cfg), cfg


CASES = {
    # case: (leaves' device, dtype, moments, what the route does)
    "cpu_float32": ("cpu", torch.float32, "float32", "plain"),
    "cpu_bfloat16": ("cpu", torch.bfloat16, "bfloat16", "plain"),
    "cpu_int8": ("cpu", torch.float32, "int8", "plain"),
    "cuda_int8": ("cuda", torch.bfloat16, "int8", "plain"),
    "cuda_float32_moments": ("cuda", torch.bfloat16, "float32", "fused"),
    "cuda_bfloat16_moments": ("cuda", torch.float32, "bfloat16", "fused"),
    "mixed_devices": ("cuda", torch.bfloat16, "float32", ValueError),
    "not_contiguous": ("cuda", torch.bfloat16, "float32", "fused"),
    "dequantized_grads": ("cuda", torch.bfloat16, "float32", "fused"),
    "float16_leaves": ("cuda", torch.float16, "float32", TypeError),
    "dtensor": (None, None, None, "plain"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_adamw_route(case, monkeypatch):
    monkeypatch.setattr(fused, "launches", 0)
    device, dtype, moments, want = CASES[case]
    if case == "dtensor":
        out = subprocess.run(
            [sys.executable, "-c", DTENSOR_JOB.format(port=free_port())],
            env=rank_env(), capture_output=True, text=True, timeout=240)
        assert out.returncode == 0, out.stderr[-4000:]
        assert out.stdout.split() == ["plain"]
        return
    mode = FakeTensorMode() if device == "cuda" else contextlib.nullcontext()
    with mode:
        params, grads, state, cfg = _tree(
            device, dtype, moments,
            grad_device="cpu" if case == "mixed_devices" else None,
            transpose=case == "not_contiguous",
            dequantize=case == "dequantized_grads")
        if isinstance(want, type):
            with pytest.raises(want):
                opt.fused_route(params, grads, state, cfg)
            with pytest.raises(want):      # before anything is launched
                opt.adamw_update(params, grads, state, cfg)
        elif want == "fused":
            assert opt.fused_route(params, grads, state, cfg)
        else:
            assert not opt.fused_route(params, grads, state, cfg)
        if want == "plain" and device == "cpu":
            new, _, _ = opt.adamw_update(params, grads, state, cfg)
            assert all(n.device == p.device and n.dtype == p.dtype
                       for n, p in zip(tree_leaves(new), tree_leaves(params)))
    assert fused.launches == 0
