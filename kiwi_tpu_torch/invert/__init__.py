"""Inversions on the port's engine: grid search with bootstrap statistics,
Levenberg-Marquardt refinement and multi-start gradient descent with the
linearized covariance (port of kiwi_tpu/invert; the batched MINPACK lmdif
is the submodule kiwi_tpu_torch.invert.lmdif)."""

from .source import Source, source_grid  # noqa: F401
from .gridsearch import MisfitGrid, MisfitGridStats, make_global_misfits  # noqa: F401
from .lm import minimize_lm, shape_buckets  # noqa: F401
from .gradient import covariance, minimize_gradient, minimize_multistart  # noqa: F401
from . import lmdif  # noqa: F401
