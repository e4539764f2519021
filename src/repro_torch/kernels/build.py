"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with ``ctypes``.
Libraries are built at first use and cached under the build directory
(``$REPRO_TORCH_BUILD_DIR``, else ``build/kernels`` at the repository root),
keyed by a hash of the source, the shared headers and the flags.  ``build_all`` starts one
``nvcc`` per source at the same time.  A failed build raises with the
compiler's output; nothing here falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("decode_attention", "flash_attention", "atom_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# dtype codes of the C interface, and the head dims the attention kernels are
# built for
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}
HEAD_DIMS = (64, 128)

_loaded: dict[str, ctypes.CDLL] = {}


def _dtype_code(kernel: str, name: str, t) -> int:
    code = DTYPE_CODES.get(str(t.dtype))
    if code is None:
        raise TypeError(f"{kernel} kernel takes float32 and bfloat16, "
                        f"not {t.dtype} ({name})")
    return code


def check_attention_operand(kernel: str, name: str, t) -> int:
    """Raise unless the attention kernels can take tensor ``t`` (dtype, head
    dim, layout: 16-byte vector loads along a contiguous last axis).  Returns
    the dtype code of the C interface."""
    code = _dtype_code(kernel, name, t)
    if t.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{kernel} kernel is built for head_dim in "
                         f"{HEAD_DIMS}, not {t.shape[-1]} ({name})")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{kernel} kernel: {name} needs last stride 1, the "
                         f"other strides multiples of 8 elements and 16-byte "
                         f"aligned data (strides {t.stride()})")
    return code


def check_matmul_operand(kernel: str, name: str, t) -> tuple[int, bool]:
    """Raise unless the matmul kernel can take the row-major 2-D tensor ``t``
    (dtype, rank, last stride 1).  Returns the dtype code of the C interface
    and whether its rows are whole 16-byte chunks (width, row pitch and base
    address), which the 16-byte load path needs; any other width or pitch
    takes the kernel's guarded element loads."""
    code = _dtype_code(kernel, name, t)
    if t.dim() != 2:
        raise ValueError(f"{kernel} kernel takes 2-D operands, not "
                         f"{tuple(t.shape)} ({name})")
    if t.stride(1) != 1:
        raise ValueError(f"{kernel} kernel: {name} needs last stride 1 "
                         f"(strides {t.stride()})")
    chunk = 16 // t.element_size()
    vec16 = (t.shape[1] % chunk == 0 and t.stride(0) % chunk == 0
             and t.data_ptr() % 16 == 0)
    return code, vec16


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _source(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(src)
    return src


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(_source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):      # shared by the sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, out: Path) -> tuple[subprocess.Popen, Path]:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names: tuple[str, ...] = KERNELS) -> dict[str, Path]:
    """Build every missing library, all compilers started together."""
    paths = {n: library_path(n) for n in names}
    running = []
    try:
        for n, p in paths.items():
            if not p.exists():
                running.append((n, *_start(n, p)))
        for n, proc, tmp in running:
            _finish(n, proc, tmp, paths[n])
    finally:
        for _, proc, tmp in running:      # after a failure: leave nothing behind
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                tmp.unlink(missing_ok=True)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if need be."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all((name,))[name]
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
