"""The batched eikonal solve (ops.eik_sweep.sweep_solve_batch,
csrc/eik_sweep.cu) as the device eikonal discretizer calls it.

Work of the plain arithmetic: per cell update 27 float operations (the two
neighbour minima, the reciprocal of the speed, the two-sided candidate and
its test, the one-sided candidate, the choice and the running minimum;
ops/eik_sweep.sweep_solve_batch_reference), for every cell of the batch's
grids in each of the 4 directions of each of the n_rounds rounds.  Bytes:
the speeds read and the times written once, and the per-source deltas and
seeds, 4 bytes a value.  The kernel is bound by its chain of (nx + ny - 1)
x 4 x n_rounds dependent steps, which this count does not see."""

MODULE = "kiwi_tpu_torch.ops.eik_sweep"
ATTR = "sweep_solve_batch"
DEVICE_KERNELS = ("eik_wavefront_kernel", "eik_diagonal_kernel")
FLOPS_PER_UPDATE = 27


def _rounds(args, kwargs):
    return int(kwargs.get("n_rounds", args[4] if len(args) > 4 else 3))


def key(args, kwargs):
    return tuple(args[0].shape) + (_rounds(args, kwargs),)


def work(args, kwargs):
    b, nx, ny = args[0].shape
    cells = b * nx * ny
    return FLOPS_PER_UPDATE * cells * 4 * _rounds(args, kwargs), 4 * (2 * cells + 4 * b)
