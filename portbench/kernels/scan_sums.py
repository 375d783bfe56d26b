"""The floating-shift scan over precomputed synthetics
(ops.float_scan.scan_sums, csrc/scan_sums.cu) as the misfit module calls it.

Work of the plain arithmetic: per (shift, rc, model, sample) the
difference, its absolute value or square and the sum (3 S RC B W flops);
the reference rows [S*RC, W] and the synthetics [RC, B, W] read once, the
sums [S, B, RC] written once, 4 bytes a value."""

MODULE = "kiwi_tpu_torch.misfit"
ATTR = "scan_sums"
DEVICE_KERNELS = ("scan_sums_kernel",)


def key(args, kwargs):
    return tuple(args[0].shape) + tuple(args[1].shape)


def work(args, kwargs):
    ref, syn = args[0], args[1]
    rc, b, w = syn.shape
    s = ref.shape[0] // rc
    return 3 * s * rc * b * w, 4 * (ref.numel() + syn.numel() + s * b * rc)
