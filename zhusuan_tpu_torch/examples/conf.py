"""Shared example configuration.

Port of ``examples/conf.py`` (reference ``examples/conf.py``: the data
directory).
"""

from zhusuan_tpu_torch.examples.utils.dataset import data_dir

__all__ = ["data_dir"]
