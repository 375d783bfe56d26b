"""The roofline counts of portbench/kernels against counts made by hand on
small shapes."""

from __future__ import annotations

import os

import torch

from portbench import harness

KDIR = os.path.join(harness.HERE, "kernels")


def kernel(name):
    return harness.load_module(os.path.join(KDIR, name + ".py"), "kernel_" + name)


def test_fused_scan_counts():
    k = kernel("fused_scan")
    ref, v, wgt = torch.zeros(2, 3, 4), torch.zeros(2, 5, 4), torch.zeros(2, 5, 6)
    # synthesis 2*RC*T*B*W = 480, scan 3*RC*S*B*W = 432; values 24 + 40 + 60 + out 36
    assert k.work((ref, v, wgt), {}) == (912, 640)
    lo = hi = torch.zeros(3, 2, dtype=torch.int32)
    assert k.work((ref, v, wgt), {"lo": lo, "hi": hi}) == (912, 688)
    assert k.key((ref, v, wgt), {}) != k.key((ref, v, wgt), {"lo": lo, "hi": hi})


def test_scan_sums_counts():
    k = kernel("scan_sums")
    ref, syn = torch.zeros(6, 4), torch.zeros(2, 5, 4)  # S 3, RC 2, B 5, W 4
    assert k.work((ref, syn), {"l2": False}) == (360, 4 * (24 + 40 + 30))


def test_window_synth_counts_live_work():
    k = kernel("window_synth")
    ext = torch.zeros(12, 10, 8)  # N 12, ng 10, nt_ext 8
    node_rows = torch.tensor([[[0, 1]]], dtype=torch.int32)  # B 1, R 1, P 2
    kk = torch.zeros(1, 2, 2, dtype=torch.int32)  # G 2
    wrows = torch.ones(1, 1, 2, 2, 10)
    wrows[0, 0, 1, 1, :6] = 0.0  # one centroid with no moment: no work
    wsp = torch.zeros(1, 1, 2, 4)
    flops, nbytes = k.work((ext, node_rows, (1, 3, 4), kk, wrows, wsp, 5), {})
    # blend: 2 groups x 7 x 10 comps x 6 samples = 840; 3 live centroids x
    # (23 x 6 + 12 x 5) = 594
    assert flops == 840 + 594
    # nodes {0, 1, 3, 4} | {1, 2, 4, 5}: 6 rows of 10 x 8; operands 2 + 4 + 40 + 8; out 15
    assert nbytes == 4 * (480 + 2 + 4 + 40 + 8 + 15)
