"""The eik_sweep kernel's share of its roofline in %: the least time the card
could take for the traced calls' work (kernels/eik_sweep.py: the larger of
bytes over the HBM rate and float32 operations over the FP32 peak,
peaks.json) over the device time of its device kernels."""


def read(run):
    return run.roofline("eik_sweep")
