"""§4.4 Kernel Atomizer.

Splits a kernel's grid into contiguous block-index ranges ("atoms") that are
independently schedulable.  The split count is ``predicted_duration /
atom_duration``; short kernels are left whole (the extra launches are not
worth it) and kernels with huge grids get a larger effective atom_duration
(the paper's adaptive aggressiveness knob).

On Hopper an atom is one launch of ``grid=(n,)`` whose program id is offset
by ``start`` (``repro_torch/kernels/atoms.py``, the port's kernels), so
there are no Prelude early-exit blocks and no dead-block traffic.  An atom
still costs more than its blocks: atoms on one stream do not overlap, so
each ends in a partial wave of thread blocks, and the host enqueues one
launch an atom.  ``chip_smoke.py``'s ``lithos_atoms`` line measures that
extra cost on the card beside what the simulator charges for it (each
atom's cost-model latency, ``launch_overhead`` included).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from repro_torch.core.types import KernelTask


@dataclass
class AtomizerConfig:
    atom_duration: float = 1e-3        # target atom runtime (s)
    min_duration: float = 250e-6       # below this, never atomize
    max_atoms: int = 32
    min_blocks_per_atom: int = 8       # don't shred tiny grids
    # adaptive: grids larger than this get atom_duration scaled up so the
    # added launch traffic stays bounded (§4.4 "Performance Optimizations")
    large_grid_blocks: int = 4096
    large_grid_scale: float = 2.0


def atom_ranges(n_blocks: int, n_atoms: int) -> list[tuple[int, int]]:
    """Split [0, n_blocks) into ``n_atoms`` contiguous (start, len) ranges."""
    n_atoms = max(1, min(n_atoms, n_blocks))
    base, rem = divmod(n_blocks, n_atoms)
    out, start = [], 0
    for i in range(n_atoms):
        ln = base + (1 if i < rem else 0)
        out.append((start, ln))
        start += ln
    return out


class KernelAtomizer:
    def __init__(self, config: Optional[AtomizerConfig] = None):
        self.cfg = config or AtomizerConfig()
        self.atomized = 0
        self.passed_through = 0
        # Kernel-id stream for fresh atom ids — set to the owning
        # simulator's stream on policy attach (falls back to the module
        # global for standalone use in tests).
        self.kids = None

    def plan(self, task: KernelTask, predicted_latency: Optional[float],
             *, unseen_conservative: bool = False) -> int:
        """Number of atoms for this kernel (1 = pass through).

        ``unseen_conservative``: no latency estimate exists yet, but the
        kernel belongs to a best-effort tenant — split by grid size alone
        so a first encounter can never monopolize the device for a whole
        unknown kernel duration.  With grid-range atoms this costs a launch
        and a partial wave per atom, and no Prelude early-exit traffic."""
        c = self.cfg
        if task.phase == "decode":
            # decode steps are memory-bound and already sub-quantum (one
            # token per sync) — atomizing them only adds launch overhead
            # on the latency-critical path.  Prefill atomizes like training.
            return 1
        if predicted_latency is None:
            if not unseen_conservative:
                return 1
            n = min(c.max_atoms, task.work.n_blocks // c.min_blocks_per_atom)
            return max(1, n)
        if predicted_latency < c.min_duration:
            return 1
        dur = c.atom_duration
        if task.work.n_blocks > c.large_grid_blocks:
            dur *= c.large_grid_scale
        n = int(predicted_latency / dur)
        n = min(n, c.max_atoms, task.work.n_blocks // c.min_blocks_per_atom)
        return max(1, n)

    def split(self, task: KernelTask, n_atoms: int) -> list[KernelTask]:
        """Materialize atoms: disjoint block ranges covering the full grid.

        Work terms scale with the block fraction; every block is executed
        exactly once across the returned atoms (property-tested).
        """
        if n_atoms <= 1:
            self.passed_through += 1
            return [task]
        ranges = atom_ranges(task.work.n_blocks, n_atoms)
        n = len(ranges)
        atoms = []
        for i, (start, ln) in enumerate(ranges):
            frac = ln / task.work.n_blocks
            atoms.append(replace(
                task,
                work=task.work.scaled(frac),
                kid=-1,                       # fresh id
                atom_of=(task.kid, i, n)))
        # fresh kids for atoms (dataclass replace keeps default factory out)
        from repro_torch.core import types as _t
        kids = self.kids if self.kids is not None else _t._kernel_ids
        for a in atoms:
            a.kid = next(kids)
            a.work.n_blocks = max(1, a.work.n_blocks)
        self.atomized += 1
        return atoms
