"""Incubating APIs (reference: python/paddle/fluid/incubate/). Port of
`paddle_tpu/incubate/`: data generators and the fleet API's base and
parameter-server mode."""

from . import data_generator  # noqa: F401
from . import fleet  # noqa: F401
from .fleet.base import fleet_base, role_maker  # noqa: F401
from .fleet.base.fleet_base import (Fleet, Mode,  # noqa: F401
                                    DistributedOptimizer)
from .fleet.base.role_maker import (Role, RoleMakerBase,  # noqa: F401
                                    UserDefinedRoleMaker,
                                    PaddleCloudRoleMaker)
