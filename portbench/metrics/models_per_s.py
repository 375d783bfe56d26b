"""Models whose global misfits reached the host in the window, per second
of the window (host clock; the window ends with the last call's answer)."""


def read(run):
    return sum(run.field("units")) / run.window_s
