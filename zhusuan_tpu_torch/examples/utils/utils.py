"""Misc example utilities.

Port of ``examples/utils/utils.py``: ``save_image_collections``
(reference ``examples/utils/utils.py:20-57``) tiles generated samples into
one grid image. PIL is imported inside the function, as in the JAX
package, so the module imports without it.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["save_image_collections"]


def save_image_collections(x, filename, shape=(10, 10), scale_each=False,
                           transpose=False):
    """Tile a batch of images into a grid and save it as a PNG.

    :param x: uint8 or float array ``[N, H, W, C]`` (values in [0, 1] if
        float), or a tensor (copied to the host).
    :param filename: output path (PNG); directories are created.
    """
    from PIL import Image

    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    if x.dtype == np.uint8:
        x = x.astype(np.float64) / 255.0
    if transpose:
        x = np.transpose(x, (0, 2, 3, 1))
    if scale_each:
        mins = x.min(axis=(1, 2, 3), keepdims=True)
        maxs = x.max(axis=(1, 2, 3), keepdims=True)
        x = (x - mins) / np.maximum(maxs - mins, 1e-8)
    n = min(x.shape[0], shape[0] * shape[1])
    h, w, c = x.shape[1:]
    grid = np.zeros((shape[0] * h, shape[1] * w, c), dtype=np.float64)
    for i in range(n):
        r, col = divmod(i, shape[1])
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = x[i]
    grid = (np.clip(grid, 0, 1) * 255).astype(np.uint8)
    if c == 1:
        grid = grid[..., 0]
    dirname = os.path.dirname(filename)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    Image.fromarray(grid).save(filename)
