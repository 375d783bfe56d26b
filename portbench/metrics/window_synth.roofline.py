"""The window_synth kernel's share of its roofline in %: the least time the card
could take for the traced calls' work (kernels/window_synth.py: the larger of
bytes over the HBM rate and float32 operations over the FP32 peak,
peaks.json) over the device time launched inside its spans."""


def read(run):
    return run.roofline("window_synth")
