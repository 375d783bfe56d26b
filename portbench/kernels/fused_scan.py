"""The fused synthesis + floating-scan kernel (ops.float_scan.fused_scan_sums,
csrc/float_scan.cu) as the misfit module calls it.

Work of the plain arithmetic at the call's shapes: the synthesis
syn[rc, b, w] = sum_t wgt[rc, t, b] v[rc // k, t, w] (2 RC T B W flops),
then per trial shift the difference, its absolute value or square and the
sum (3 RC S B W); each operand read once and the sums [RC, S, B] written
once, 4 bytes a value."""

MODULE = "kiwi_tpu_torch.misfit"
ATTR = "fused_scan_sums"
DEVICE_KERNELS = ("fused_scan_kernel",)


def _ops(args, kwargs):
    names = ("ref", "v", "wgt", "lo", "hi")
    ops = dict(zip(names, args))
    ops.update({k: v for k, v in kwargs.items() if k in names})
    return ops


def key(args, kwargs):
    ops = _ops(args, kwargs)
    return tuple(tuple(ops[k].shape) for k in ("ref", "v", "wgt")) + (ops.get("lo") is not None,)


def work(args, kwargs):
    ops = _ops(args, kwargs)
    rc, s, w = ops["ref"].shape
    t, b = ops["wgt"].shape[1:]
    flops = 2 * rc * t * b * w + 3 * rc * s * b * w
    nbytes = 4 * (ops["ref"].numel() + ops["v"].numel() + ops["wgt"].numel() + rc * s * b)
    if ops.get("lo") is not None:
        nbytes += 4 * (ops["lo"].numel() + ops["hi"].numel())
    return flops, nbytes
