"""PyTorch/CUDA port of the LithOS reproduction, for NVIDIA Hopper (H100).

Same sub-package layout as the JAX package it was ported from, so the
counterpart of a module is found by its path.  This package imports
``torch`` (plus numpy and the standard library) and nothing of JAX.

Ported so far: the dense decoder-only serving path
(``launch.serve`` -> ``serve.engine.SlotServer`` -> ``models.transformer``
``prefill`` / ``decode_step``) with hand-written CUDA kernels for decode
attention and flash attention (``kernels/csrc``).
"""
