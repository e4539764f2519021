"""The port stands alone: no import of JAX or of the JAX package, entry
points that import with no GPU stack present, and a GPU default that never
turns into a CPU run by itself."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

IMPORT = re.compile(
    r"^\s*(?:import\s+(?:jax|repro)(?:[.\s,]|$)"
    r"|from\s+(?:jax|repro)(?:\.[\w.]*)?\s+import)", re.M)


def test_port_has_files():
    assert len(FILES) > 20
    assert sorted(p.name for p in (PORT / "kernels" / "csrc").glob("*.cu")) == [
        "atom_matmul.cu", "decode_attention.cu", "flash_attention.cu"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_of_the_jax_package(path):
    assert not IMPORT.search(path.read_text()), path


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_library_attention_or_compile(path):
    """The port's attention is its own kernels.  (``chip_smoke.py`` times the
    library call as a yardstick, so it is exempt from the first word.)"""
    text = path.read_text()
    assert "torch.compile" not in text
    if path.name != "chip_smoke.py":
        assert "scaled_dot_product_attention" not in text


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_leaves_jax_and_triton_out():
    out = _run(
        "import sys\n"
        "import repro_torch\n"
        "import repro_torch.launch.serve, repro_torch.serve.engine\n"
        "import repro_torch.models.registry, repro_torch.convert\n"
        "import repro_torch.kernels.build\n"
        "import repro_torch.kernels.decode_attention.ops\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.atom_matmul.ops\n"
        "import repro_torch.roofline.analysis, repro_torch.launch.atoms\n"
        "import torch\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton')]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_available()\n"
        "print('clean')\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_device_none_means_gpu_and_raises_without_one():
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.registry import init_model
    from repro_torch.serve.engine import SlotServer
    assert not torch.cuda.is_available()
    cfg = get_config("olmo-1b").reduced()
    for call in (lambda: serve(cfg, n_requests=1, verbose=False),
                 lambda: SlotServer(cfg),
                 lambda: init_model(cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_cli_defaults_to_gpu_and_takes_device_cpu():
    out = _run("from repro_torch.launch.serve import main\n"
               "main(['--reduced', '--requests', '2', '--max-new', '2'])\n")
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    out = _run("from repro_torch.launch.serve import main\n"
               "main(['--reduced', '--requests', '2', '--max-new', '2', "
               "'--max-len', '32', '--device', 'cpu'])\n")
    assert out.returncode == 0, out.stderr
    assert "[serve] 2 requests" in out.stdout and "on cpu" in out.stdout


def test_cli_refuses_the_control_plane_flag():
    out = _run("from repro_torch.launch.serve import main\n"
               "main(['--ctl-state-dir', 'state', '--device', 'cpu'])\n")
    assert out.returncode != 0 and "not ported" in out.stderr


def test_wrapper_on_a_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel or raises: here,
    with no GPU, a ``meta`` tensor must raise, not fall back."""
    import torch
    from repro_torch.kernels.atom_matmul.ops import atom_matmul
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    q = torch.empty(1, 8, 4, 64, device="meta")
    k = torch.empty(1, 8, 2, 64, device="meta")
    with pytest.raises(RuntimeError, match="no path for device"):
        flash_attention(q, k, k)
    with pytest.raises(RuntimeError, match="no path for device"):
        decode_attention(q[:, 0], k, k,
                         torch.ones(1, dtype=torch.int32, device="meta"))
    with pytest.raises(RuntimeError, match="no path for device"):
        atom_matmul(q[0, 0], k[0, 0].T)


def test_atom_matmul_wrapper_reaches_torch_matmul_only_through_its_ref():
    """The matmul wrapper launches its kernel or, for a CPU tensor, calls
    ``ref.py``; no library product stands in for the kernel."""
    products = {"matmul", "mm", "bmm", "addmm", "einsum", "linear",
                "tensordot", "dot"}
    ops = (PORT / "kernels" / "atom_matmul" / "ops.py").read_text()
    for node in ast.walk(ast.parse(ops)):
        assert not (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.MatMult))
        assert not (isinstance(node, ast.Attribute) and node.attr in products)
    assert ("from repro_torch.kernels.atom_matmul.ref import matmul_atom_ref"
            in ops)
    ref = (PORT / "kernels" / "atom_matmul" / "ref.py").read_text()
    assert "torch.matmul" in ref


def test_chip_smoke_fails_without_a_gpu():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
