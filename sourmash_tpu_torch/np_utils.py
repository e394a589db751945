"""Memory-mapped numpy helpers (parity: reference `np_utils.py:1-23`).

Used by the parallel compare path to share the similarity matrix between
worker processes without copying."""

import tempfile


def to_memmap(array):
    """Write `array` to a memory-mapped binary file on disk.

    Returns (memmapped array, filename)."""
    import numpy as np

    with tempfile.NamedTemporaryFile(
        prefix="array", suffix=".mmap", delete=False
    ) as tf:
        filename = tf.name

    writer = np.memmap(filename, mode="w+", shape=array.shape, dtype=array.dtype)
    writer[:] = array[:]
    del writer  # flush to disk

    return np.memmap(filename, dtype=array.dtype, shape=array.shape), filename
