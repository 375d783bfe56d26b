"""The finite-source window synthesis (ops.synth_window.window_forward,
csrc/synth_window.cu) as synthesize_ard_batch calls it.

Work of the plain arithmetic on the call's live data (a centroid whose
moment weights f1..f6 are all zero adds nothing and needs nothing):
per live group (b, r, p) the bilinear blend of its 4 node rows over the
nt_out + 1 samples a shift needs (4 products and 3 sums per GF component
and sample); per live centroid the contraction of the blended rows with
its weights into (away, right, down) and the rotation (23 flops a sample
with 10 GF components, 17 + 6; 19 with 8), the 2-tap fractional shift (9
a sample) and the sum over centroids (3 a sample).  Bytes: the distinct
node rows the live groups' stencils read (ng x nt_ext values each), the
kinematic operands, and the output [B, R, 3, nt_out], 4 bytes a value."""

MODULE = "kiwi_tpu_torch.ops.synth_window"
ATTR = "window_forward"
DEVICE_KERNELS = ("window_direct_kernel", "window_tile_kernel")


def key(args, kwargs):
    ext, node_rows, _s3, kk, wrows, _wsp, nt_out = args
    return tuple(ext.shape) + tuple(wrows.shape) + (int(nt_out),)


def work(args, kwargs):
    import torch

    ext, node_rows, strides3, kk, wrows, wsp, nt_out = args
    _n, ng, nt_ext = ext.shape
    live = (wrows[..., :6] != 0).any(-1)  # [B, R, P, G]
    live_groups = live.any(-1)  # [B, R, P]
    ncent = int(live.sum())
    ngroup = int(live_groups.sum())
    per_sample = 23 if ng == 10 else 19
    flops = (ngroup * 7 * ng * (nt_out + 1)
             + ncent * (per_sample * (nt_out + 1) + 12 * nt_out))
    offs = torch.tensor((0,) + tuple(int(s) for s in strides3), device=node_rows.device)
    nodes = (node_rows[live_groups].long()[:, None] + offs).unique().numel()
    nbytes = 4 * (nodes * ng * nt_ext + node_rows.numel() + kk.numel() + wrows.numel()
                  + wsp.numel() + node_rows.shape[0] * node_rows.shape[1] * 3 * nt_out)
    return flops, nbytes
