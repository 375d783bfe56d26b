"""Share of the traced window in which the card was idle while the
innermost open span of the program's main thread was one of the misfit
layer's (kiwi.misfit.*), in % (torch.profiler: the program's spans and the
device intervals of one trace; portbench/layers.py's layer_idle)."""


def read(run):
    t = run.trace
    idle = getattr(t, "layer_idle", None)
    return 100.0 * idle["misfit"] / t.window_s if idle is not None else None
