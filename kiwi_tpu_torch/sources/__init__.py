from .base import SOURCE_REGISTRY, SourceModel, get_source_model  # noqa: F401
from . import bilat  # noqa: F401
