"""Reader toolkit of the port: the padding-bucket policy
(`reader/bucketing.py`). The reader decorators and PyReader
(`paddle_tpu/reader/{decorator,py_reader}.py`) come with ROADMAP A.12."""

from .bucketing import (pow2_boundaries, bucket_for, pad_to_bucket,  # noqa: F401
                        bucketed)

__all__ = ["pow2_boundaries", "bucket_for", "pad_to_bucket", "bucketed"]
