from .base import SOURCE_REGISTRY, SourceModel, get_source_model  # noqa: F401
from . import bilat, circular, eikonal, moment_tensor, point_lp  # noqa: F401
