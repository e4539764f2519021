"""Hand-written Hopper kernels, each beside its plain PyTorch version.

``csrc/*.cu``          CUDA C++ sources (sm_90a), plain C interface
``build.py``           compiles them with nvcc at first use, loads with ctypes
``atoms.py``           the atom schedule shared by every kernel wrapper
``<name>/ops.py``      wrapper: launches the kernel for a CUDA tensor, takes
                       the plain version only for a tensor on the CPU
``<name>/ref.py``      the plain PyTorch version, atom form included
"""
