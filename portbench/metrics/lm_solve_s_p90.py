"""The 90th percentile of one inversion's seconds over every inversion the
window completed (host clock; linear between order statistics)."""


def read(run):
    import numpy as np

    return float(np.percentile(np.asarray(run.field("t")), 90.0))
