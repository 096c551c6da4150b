"""Device mesh construction.

The reference's "distribution" is four OS processes talking HTTP
(SURVEY.md §2.12). Here distribution is a jax.sharding.Mesh: the corpus
axis shards over 'data' (each device scans its slice of the embedding
matrix in its own memory), and the query batch can shard over 'batch'
(data-parallel query streams). Multi-host extends the same mesh across
hosts via jax.distributed.initialize."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(axes: Sequence[tuple[str, int]] | None = None,
              devices: Optional[list] = None) -> Mesh:
    """Build a mesh. Default: all local devices on one 'data' axis.

    axes: ordered (name, size) pairs; sizes must multiply to len(devices).
    Example: make_mesh([("batch", 2), ("data", 4)]) on 8 devices.
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if axes is None:
        axes = [("data", n)]
    names = [a for a, _ in axes]
    sizes = [s for _, s in axes]
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(f"mesh axes {axes} need {total} devices, have {n}")
    arr = np.asarray(devices).reshape(sizes)
    return Mesh(arr, names)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Multi-host init (DCN). No-op when single-process."""
    if num_processes and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
