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
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "tools").glob("*.py"))
         + sorted((ROOT / "examples").glob("*_torch.py"))
         + [ROOT / "scripts" / "parity_check_torch.py"])

IMPORT = re.compile(
    r"^\s*(?:import\s+(?:jax|repro|ml_dtypes)(?:[.\s,]|$)"
    r"|from\s+(?:jax|repro|ml_dtypes)(?:\.[\w.]*)?\s+import)", re.M)


def test_port_has_files():
    assert len(FILES) > 20
    assert sorted(p.name for p in (PORT / "kernels" / "csrc").glob("*.cu")) == [
        "adamw.cu", "atom_matmul.cu", "decode_attention.cu",
        "flash_attention.cu", "flash_attention_bwd.cu"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_of_the_jax_package(path):
    """Nor of ``ml_dtypes``: the checkpoints keep bf16 / fp8 as raw bits
    without it."""
    assert not IMPORT.search(path.read_text()), path


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_library_attention_or_compile(path):
    """The port's attention is its own kernels.  (``chip_smoke.py`` times the
    library call as a yardstick, so it is exempt from the first word.)"""
    text = path.read_text()
    assert "torch.compile" not in text
    if path.name != "chip_smoke.py":
        assert "scaled_dot_product_attention" not in text


CSRC = sorted((PORT / "kernels" / "csrc").glob("*.cu*"))
INCLUDE = re.compile(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]', re.M)
LIBRARY_HEADERS = ("cublas", "cudnn", "cutlass/gemm/device",
                   "cutlass/gemm/collective", "cutlass/epilogue/collective")


@pytest.mark.parametrize("path", CSRC, ids=lambda p: p.name)
def test_kernel_sources_include_no_library_kernel(path):
    """The kernels are written by hand: no cuBLAS, cuDNN or CUTLASS
    device-level / collective GEMM header in any source."""
    for inc in INCLUDE.findall(path.read_text()):
        assert not any(w in inc.lower() for w in LIBRARY_HEADERS), (path, inc)


def test_bf16_paths_issue_wgmma_on_tiles_loaded_by_tma():
    hopper = (PORT / "kernels" / "csrc" / "hopper.cuh").read_text()
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait",
                "setmaxnreg", "wgmma.wait_group"):
        assert ptx in hopper, ptx
    # the tensor maps are __grid_constant__ kernel parameters (the
    # backward's in one struct of them)
    for name, maps in (("atom_matmul.cu", "CUtensorMap"),
                       ("flash_attention.cu", "CUtensorMap"),
                       ("flash_attention_bwd.cu", "Maps")):
        src = (PORT / "kernels" / "csrc" / name).read_text()
        assert '#include "hopper.cuh"' in src
        assert re.search(r"wgmma_m64n\d+k16_(ss|rs)<", src), name
        assert "tma_load_" in src and f"const __grid_constant__ {maps}" in src
    assert re.search(r"struct Maps \{[^}]*CUtensorMap", (
        PORT / "kernels" / "csrc" / "flash_attention_bwd.cu").read_text())
    # tensor maps are looked up through the CUDA runtime: no -lcuda
    assert "cudaGetDriverEntryPoint" in hopper
    from repro_torch.kernels import build
    assert not any("cuda" in f and f.startswith("-l") for f in build.NVCC_FLAGS)


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__a1850d8c_14_atom_matmul_cu_d52b758024matmul_bf16_wgmma_kernelILi256EEEv14CUtensorMap_stS1_NS_4ArgsEi' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__a1850d8c_14_atom_matmul_cu_d52b758024matmul_bf16_wgmma_kernelILi256EEEv14CUtensorMap_stS1_NS_4ArgsEi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__a1850d8c_14_atom_matmul_cu_d52b758017matmul_f32_kernelILb1EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__a1850d8c_14_atom_matmul_cu_d52b758017matmul_f32_kernelILb1EEEvNS_4ArgsE
    48 bytes stack frame, 48 bytes spill stores, 60 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 48 bytes cumulative stack size
ptxas warning : (C7508) setmaxnreg ignored; unable to determine register count at entry
"""


def test_ptxas_report_reads_registers_spills_and_warnings(monkeypatch,
                                                          tmp_path):
    from repro_torch.kernels import build
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    build.library_path("atom_matmul").with_suffix(".log").write_text(PTXAS_LOG)
    rep = build.ptxas_report("atom_matmul")
    assert rep["kernels"] == {
        "matmul_bf16_wgmma_kernel<256>": {"spill_stores": 0, "spill_loads": 0,
                                          "registers": 168},
        "matmul_f32_kernel<1>": {"spill_stores": 48, "spill_loads": 60,
                                 "registers": 128}}
    assert len(rep["warnings"]) == 1 and "C7508" in rep["warnings"][0]


PTXAS_LOG_CALL = """\
ptxas info    : Function properties for _ZN12_GLOBAL__N_110mbar_faultEv
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are serialized due to insufficient register resources for the function '_ZN12_GLOBAL__N_121flash_attn_bwd_kernelILi128EEEvNS_4MapsENS_4ArgsE'
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121flash_attn_bwd_kernelILi128EEEvNS_4MapsENS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_121flash_attn_bwd_kernelILi128EEEvNS_4MapsENS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Function properties for _ZN12_GLOBAL__N_110mbar_faultEv
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
"""


def test_ptxas_report_keeps_called_functions_out_of_kernels(monkeypatch,
                                                           tmp_path):
    """A called function's properties (the waits' trap) are not a kernel's;
    a serialized-wgmma note is reported with the warnings."""
    from repro_torch.kernels import build
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    build.library_path("flash_attention_bwd").with_suffix(".log").write_text(
        PTXAS_LOG_CALL)
    rep = build.ptxas_report("flash_attention_bwd")
    assert rep["kernels"] == {
        "flash_attn_bwd_kernel<128>": {"spill_stores": 0, "spill_loads": 0,
                                       "registers": 168}}
    assert len(rep["warnings"]) == 1 and "C7512" in rep["warnings"][0]


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
        "import repro_torch.launch.train, repro_torch.train.step\n"
        "import repro_torch.optim, repro_torch.data\n"
        "import repro_torch.checkpoint, repro_torch.distributed\n"
        "import repro_torch.launch.mesh, repro_torch.launch.shardings\n"
        "import repro_torch.models.sharding, repro_torch.kernels.sharded\n"
        "import repro_torch.launch.dryrun, repro_torch.roofline.report\n"
        "import repro_torch.roofline.cost, repro_torch.roofline.comm\n"
        "import repro_torch.core.cluster, repro_torch.ctl.cli\n"
        "import repro_torch.ctl.daemon\n"
        "import torch\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton', 'ml_dtypes')]\n"
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


CTL_ARGV = ["--arch", "llama3-8b", "--max-slots", "4", "--max-new", "16",
            "--priority", "hp", "--quota", "8", "--slo", "0.2"]


def test_cli_refuses_the_control_plane_flag(tmp_path):
    """Under ``--ctl-state-dir`` the serving CLI refuses to serve: it drops
    the deployment's spec in the daemon's inbox and prints the job id,
    importing neither ``torch`` nor JAX.  The spec equals the one the
    reference's ``repro.launch.serve`` submits for the same arguments."""
    from repro.launch.serve import main as ref_main
    from repro_torch.ctl import store
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    argv = CTL_ARGV + ["--ctl-state-dir", str(port_dir)]
    out = _run("import sys\n"
               "from repro_torch.launch.serve import main\n"
               f"main({argv!r})\n"
               "bad = [m for m in sys.modules if m.split('.')[0] in "
               "('torch', 'jax', 'jaxlib', 'repro', 'triton')]\n"
               "assert not bad, bad\n")
    assert out.returncode == 0, out.stderr
    jid = out.stdout.strip()
    ref_main(CTL_ARGV + ["--ctl-state-dir", str(ref_dir)])
    got, = store.scan_inbox(str(port_dir))[0]
    want, = store.scan_inbox(str(ref_dir))[0]
    assert got["job_id"] == jid and jid.startswith("job-")
    assert got["spec"] == want["spec"]
    assert list(got["spec"]) == list(want["spec"])
    assert got["spec"]["reduced"] is False and got["spec"]["batch"] == 4


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
