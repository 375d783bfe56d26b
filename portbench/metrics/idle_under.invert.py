"""Share of the traced window in which the card was idle while the
innermost open span of the program's main thread was one of the invert
layer's (kiwi.invert.*), in % (torch.profiler: the program's spans and the
device intervals of one trace; portbench/layers.py's layer_idle)."""


def read(run):
    t = run.trace
    idle = getattr(t, "layer_idle", None)
    return 100.0 * idle["invert"] / t.window_s if idle is not None else None
