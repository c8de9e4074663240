"""Per-layer cost profiles for the paper's own evaluation models.

VGG19 / ResNet34 at 224x224, FLOPs per the conv formula of Molchanov et
al. [14] (2 * K^2 * C_in * H_out * W_out * C_out, i.e. 2 FLOPs per MAC),
``d_jl`` = fp32 activation bytes of the layer output (post-pool where a pool
immediately follows).  Totals cross-check against the literature:
VGG19 ~= 39 GFLOP, ResNet34 ~= 7.3 GFLOP per image.
"""
from __future__ import annotations

import numpy as np


def _conv(cin, cout, hw, k=3, stride=1):
    hout = hw // stride
    flops = 2.0 * k * k * cin * cout * hout * hout
    return flops, hout


def vgg19_profile(*, batch: int = 1) -> tuple[np.ndarray, np.ndarray]:
    comp, data = [], [float(batch * 224 * 224 * 3 * 4)]
    hw, cin = 224, 3
    plan = [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]
    for cout, reps in plan:
        for r in range(reps):
            f, _ = _conv(cin, cout, hw)
            comp.append(batch * f)
            out_hw = hw // 2 if r == reps - 1 else hw  # pool after last conv
            data.append(float(batch * out_hw * out_hw * cout * 4))
            cin = cout
        hw //= 2
    # FC 25088->4096->4096->1000
    for cin_fc, cout_fc in [(7 * 7 * 512, 4096), (4096, 4096), (4096, 1000)]:
        comp.append(batch * 2.0 * cin_fc * cout_fc)
        data.append(float(batch * cout_fc * 4))
    return np.asarray(comp, np.float64), np.asarray(data, np.float64)


def resnet34_profile(*, batch: int = 1) -> tuple[np.ndarray, np.ndarray]:
    comp, data = [], [float(batch * 224 * 224 * 3 * 4)]
    # conv1 7x7/2 then 3x3 maxpool/2
    f, _ = _conv(3, 64, 224, k=7, stride=2)
    comp.append(batch * f)
    data.append(float(batch * 56 * 56 * 64 * 4))
    hw, cin = 56, 64
    for cout, blocks in [(64, 3), (128, 4), (256, 6), (512, 3)]:
        for b in range(blocks):
            stride = 2 if (b == 0 and cout != 64) else 1
            f1, hout = _conv(cin, cout, hw, stride=stride)
            comp.append(batch * f1)
            data.append(float(batch * hout * hout * cout * 4))
            f2, _ = _conv(cout, cout, hout)
            comp.append(batch * f2)
            data.append(float(batch * hout * hout * cout * 4))
            cin, hw = cout, hout
    comp.append(batch * 2.0 * 512 * 1000)           # fc after global avgpool
    data.append(float(batch * 1000 * 4))
    return np.asarray(comp, np.float64), np.asarray(data, np.float64)
