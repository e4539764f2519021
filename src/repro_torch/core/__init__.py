"""LithOS control plane: the paper's contribution, as a composable library.

Layers (DESIGN.md §2-3, §5):
  execution plane — the port's models and CUDA kernels (repro_torch.models,
                    repro_torch.kernels)
  control plane   — scheduler/atomizer/rightsizer/DVFS/predictor (here),
                    backed by the SliceMap resource subsystem (slices.py)
  timing plane    — calibrated discrete-event simulator (simulator.py)
  node layer      — multi-device placement/routing (node.py) over NodeSpec,
                    and the cluster tier (cluster.py) over ClusterSpec
"""
from repro_torch.core.types import (CompletionRecord, DeviceSpec, KernelTask,
                                    KernelWork, NodeSpec, Priority, Quota)
from repro_torch.core.costmodel import CostModel
from repro_torch.core.lithos import SYSTEMS, evaluate, run_alone
from repro_torch.core.slices import SliceMap
