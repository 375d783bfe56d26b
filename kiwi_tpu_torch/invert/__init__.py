"""Inversions on the port's engine: grid search with bootstrap statistics
and Levenberg-Marquardt refinement (port of kiwi_tpu/invert; the batched
MINPACK lmdif is the submodule kiwi_tpu_torch.invert.lmdif)."""

from .source import Source, source_grid  # noqa: F401
from .gridsearch import MisfitGrid, MisfitGridStats, make_global_misfits  # noqa: F401
from .lm import minimize_lm, shape_buckets  # noqa: F401
from . import lmdif  # noqa: F401
