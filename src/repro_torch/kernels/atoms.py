"""The atom schedule: contiguous ranges of a kernel's flattened grid.

A LithOS atom (paper section 4.4) is a launch that executes blocks
``[start, start+n)`` of a kernel's grid and writes in place into the running
output.  Atoms over disjoint ranges covering ``[0, total)`` compose to the
full result in any order.  These helpers are pure Python.
"""
from __future__ import annotations

from typing import Sequence


def atom_ranges(total_tiles: int, n_atoms: int) -> list[tuple[int, int]]:
    """Split [0, total) into n contiguous (start, len) ranges (len may differ
    by 1): the atomizer's default schedule."""
    n_atoms = max(1, min(n_atoms, total_tiles))
    base, rem = divmod(total_tiles, n_atoms)
    out, start = [], 0
    for i in range(n_atoms):
        ln = base + (1 if i < rem else 0)
        out.append((start, ln))
        start += ln
    return out


def tile_count(M: int, N: int, block_m: int = 256, block_n: int = 256) -> int:
    """Schedulable tiles for an (M, N) output: the atomizer's grid size."""
    return -(-M // block_m) * -(-N // block_n)


def schedule(total: int, n_atoms: int,
             order: Sequence[int] = ()) -> list[tuple[int, int]]:
    """``atom_ranges`` in execution order; ``order`` permutes the atoms."""
    ranges = atom_ranges(total, n_atoms)
    if order:
        if sorted(order) != list(range(len(ranges))):
            raise ValueError(f"order {tuple(order)} is not a permutation of "
                             f"{len(ranges)} atoms")
        ranges = [ranges[i] for i in order]
    return ranges
