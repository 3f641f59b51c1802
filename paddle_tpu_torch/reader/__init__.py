"""Reader composition toolkit (reference: python/paddle/reader/): the
decorators, PyReader and the padding-bucket policy, exported as the JAX
package's `paddle_tpu/reader/__init__.py` exports them."""

from .decorator import (map_readers, buffered, compose, chain, shuffle,  # noqa: F401
                        firstn, xmap_readers, cache, batch,
                        multiprocess_reader, ComposeNotAligned,
                        PipeReader, Fake)
from .py_reader import (PyReader, create_py_reader_by_data,  # noqa: F401
                        read_file, double_buffer)
from .bucketing import (pow2_boundaries, bucket_for, pad_to_bucket,  # noqa: F401
                        bucketed)

__all__ = ["map_readers", "buffered", "compose", "chain", "shuffle",
           "firstn", "xmap_readers", "cache", "batch",
           "multiprocess_reader", "ComposeNotAligned", "PipeReader",
           "Fake", "PyReader", "create_py_reader_by_data", "read_file",
           "double_buffer", "pow2_boundaries",
           "bucket_for", "pad_to_bucket", "bucketed"]
