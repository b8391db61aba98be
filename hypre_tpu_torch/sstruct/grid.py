"""SStructGrid — a union of structured parts (HYPRE_SStructGridCreate,
``sstruct_mv/_hypre_sstruct_mv.h:139-184``).

Copy of ``hypre_tpu/sstruct/grid.py`` (numpy only), kept in the port so
that it imports nothing of the JAX package. Each part is a dense box grid;
the global index space concatenates the flattened parts (hypre's
part-major global numbering). Couplings between parts are graph entries on
the matrix (``matrix.py``), not grid metadata.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SStructGrid:
    part_shapes: tuple[tuple[int, ...], ...]

    @property
    def nparts(self) -> int:
        return len(self.part_shapes)

    @property
    def part_sizes(self) -> tuple[int, ...]:
        return tuple(int(np.prod(s)) for s in self.part_shapes)

    @property
    def part_offsets(self) -> tuple[int, ...]:
        """Global index of each part's first cell."""
        sizes = self.part_sizes
        return tuple(int(x) for x in np.concatenate([[0], np.cumsum(sizes)[:-1]]))

    @property
    def total_size(self) -> int:
        return int(sum(self.part_sizes))

    def global_index(self, part: int, index: tuple[int, ...]) -> int:
        """Flat global index of a cell (cell-centred, one variable)."""
        shape = self.part_shapes[part]
        flat = 0
        for d in range(len(shape)):
            flat = flat * shape[d] + index[d]
        return self.part_offsets[part] + flat

    def split(self, x):
        """Flat global vector (last dim) -> list of part-shaped views; any
        leading dims are kept."""
        lead = tuple(x.shape[:-1])
        return [x[..., off:off + size].reshape(lead + tuple(shape))
                for off, size, shape in zip(self.part_offsets,
                                            self.part_sizes,
                                            self.part_shapes)]
