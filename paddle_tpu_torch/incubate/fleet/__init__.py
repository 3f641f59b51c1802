"""Fleet: unified distributed-training API (reference:
python/paddle/fluid/incubate/fleet/). Port of `paddle_tpu/incubate/fleet/`:
the base and the parameter-server mode; the collective mode comes with the
port's parallelism (ROADMAP A.8)."""

from . import base  # noqa: F401
from . import parameter_server  # noqa: F401
