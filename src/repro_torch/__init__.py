"""PyTorch/CUDA port of the LithOS reproduction, for NVIDIA Hopper (H100).

Same sub-package layout as the JAX package it was ported from, so the
counterpart of a module is found by its path.  This package imports
``torch`` (plus numpy and the standard library) and nothing of JAX.

Every module of the JAX package is ported, with hand-written CUDA kernels
(``kernels/csrc``) for each of its TPU kernels (decode attention, flash
attention, the atom matmul) and for the attention backward that the JAX
package leaves to autodiff.  The serving engine
(``serve.engine.SlotServer``) and the trainer (``train.step``) record spans
while a profiler records (``spans``).
"""
