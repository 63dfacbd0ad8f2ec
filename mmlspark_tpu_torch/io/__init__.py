"""IO readers of the PyTorch port (see ``mmlspark_tpu/io/__init__.py``):
the image and binary-file readers, the columnar serving-ingress codecs
(``columnar.py``) and the out-of-core chunked ingest layer
(``ooc.py``); ``http.py``, ``minibatch.py`` and ``shm.py`` are imported
by module."""

from mmlspark_tpu_torch.io.binary import read_binary_files
from mmlspark_tpu_torch.io.columnar import (
    CodecError, ColumnarBatch, StagingPool, decode_columnar,
    encode_columns, negotiate,
)
from mmlspark_tpu_torch.io.image import read_images, write_images
from mmlspark_tpu_torch.io.ooc import (
    ChunkedTable, table_nbytes, write_arrow_ipc,
)

__all__ = ["ChunkedTable", "CodecError", "ColumnarBatch", "StagingPool",
           "decode_columnar", "encode_columns", "negotiate",
           "read_binary_files", "read_images", "table_nbytes",
           "write_arrow_ipc", "write_images"]
