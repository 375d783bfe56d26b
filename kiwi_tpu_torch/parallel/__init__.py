"""Multi-device SPMD on torch.distributed (port of kiwi_tpu/parallel/):
source-axis sharding (sharding.py) and GF-distance sharding (gfshard.py)."""

from . import gfshard  # noqa: F401
from .sharding import Mesh, make_mesh, sharded_forward, sharded_grad, spawn_ranks  # noqa: F401
