"""Device activities (kernels, copies, sets) in the traced calls of the
window, per call (torch.profiler)."""


def read(run):
    t = run.trace
    return t.device_ops / t.calls if t is not None and t.calls else None
