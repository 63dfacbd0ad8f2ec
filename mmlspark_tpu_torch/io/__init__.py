"""IO readers of the PyTorch port (see ``mmlspark_tpu/io/__init__.py``):
the image and binary-file readers; ``columnar.py``, ``http.py``,
``minibatch.py`` and ``ooc.py`` are imported by module."""

from mmlspark_tpu_torch.io.binary import read_binary_files
from mmlspark_tpu_torch.io.image import read_images, write_images

__all__ = ["read_binary_files", "read_images", "write_images"]
