"""Share of the traced window in which no device activity ran: one minus
the union of the device intervals over the window's host seconds, in %
(torch.profiler)."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t is not None else None
