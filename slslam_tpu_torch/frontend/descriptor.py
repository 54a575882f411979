"""72-dimensional line descriptor (MSLD-style) of the port.

Port of ``slslam_tpu/frontend/descriptor.py``.  The segment's support
region is split into 9 subregions along its length; each accumulates an
8-bin histogram of gradient orientations measured relative to the segment
direction and weighted by gradient magnitude (9 x 8 = 72, the reference's
DESC_DIM, voctree_bf.h:20), then L2-normalized, clipped at 0.3 and
renormalized.  The whole frame's segments run as one batch of tensor
operations on the maps' device, in float32 as in the JAX package; the
sample positions follow the JAX function's dtypes with x64 on (the
reference the tests hold it to) before they are rounded half to even to
pixel indices.  JAX's power-of-two segment pad
(descriptor.py:89-97) spared XLA a retrace per detection count; rows are
independent, so the port describes the N segments as they are.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NUM_SUBREGIONS = 9
NUM_ORIENT_BINS = 8
DESC_DIM = NUM_SUBREGIONS * NUM_ORIENT_BINS  # 72
SAMPLES_PER_SUB = 8
BAND_HALF_WIDTH = 3.0  # pixels perpendicular to the segment
BAND_SAMPLES = 5


def _describe_batch(mag: torch.Tensor, angle: torch.Tensor,
                    segs: torch.Tensor) -> torch.Tensor:
    """mag, angle: (H, W) float32 maps; segs: (N, 4) float32 pixel
    segments on the same device.  Returns (N, 72) unnormalized histograms
    (descriptor.py:31-81)."""
    H, W = mag.shape
    dev = mag.device
    p1 = segs[:, 0:2]
    p2 = segs[:, 2:4]
    d = p2 - p1
    length = torch.linalg.vector_norm(d, dim=1, keepdim=True)
    u = d / torch.clamp(length, min=1e-6)               # along
    n = torch.stack([-u[:, 1], u[:, 0]], dim=1)          # normal
    seg_theta = torch.atan2(u[:, 1], u[:, 0])            # (N,)

    # sample grid: (N, S*P, B) points, with JAX's dtypes under x64: the
    # positions along the segment in float32 (its ``ts`` is weakly typed),
    # the band offsets added in float64
    SP = NUM_SUBREGIONS * SAMPLES_PER_SUB
    ts = ((torch.arange(SP, dtype=torch.float64, device=dev) + 0.5)
          / SP).to(torch.float32)
    bs = torch.linspace(-BAND_HALF_WIDTH, BAND_HALF_WIDTH, BAND_SAMPLES,
                        dtype=torch.float64, device=dev)
    along = (p1[:, None, None, :]
             + ts[None, :, None, None] * d[:, None, None, :])
    pts = (along.double()
           + bs[None, None, :, None] * n.double()[:, None, None, :])
    xi = torch.round(pts[..., 0]).long().clamp_(0, W - 1)
    yi = torch.round(pts[..., 1]).long().clamp_(0, H - 1)

    m = mag[yi, xi]                                      # (N, SP, B)
    a = angle[yi, xi] - seg_theta[:, None, None]         # relative

    # soft-assign into 8 orientation bins
    a = torch.remainder(a, 2 * math.pi)
    bin_f = a / (2 * math.pi) * NUM_ORIENT_BINS
    fl = torch.floor(bin_f)
    b0 = torch.remainder(fl.long(), NUM_ORIENT_BINS)
    b1 = torch.remainder(b0 + 1, NUM_ORIENT_BINS)
    w1 = bin_f - fl
    w0 = 1.0 - w1

    # the subregion is sample_position // SAMPLES_PER_SUB (a reshape) and
    # the bins contract one-hot, as in JAX: no scatter
    N = segs.shape[0]
    oh0 = torch.nn.functional.one_hot(b0, NUM_ORIENT_BINS).to(mag.dtype)
    oh1 = torch.nn.functional.one_hot(b1, NUM_ORIENT_BINS).to(mag.dtype)
    contrib = (m * w0)[..., None] * oh0 + (m * w1)[..., None] * oh1
    desc = contrib.reshape(N, NUM_SUBREGIONS, SAMPLES_PER_SUB, BAND_SAMPLES,
                           NUM_ORIENT_BINS).sum(dim=(2, 3))
    return desc.reshape(N, DESC_DIM)


def describe(mag: torch.Tensor, angle: torch.Tensor,
             segs: np.ndarray) -> np.ndarray:
    """(N, 4) pixel segments -> (N, 72) L2-normalized float32 descriptors
    (descriptor.py:84-106), computed on the device of the (H, W) maps
    ``mag`` and ``angle`` and returned to the host in one copy."""
    if len(segs) == 0:
        return np.zeros((0, DESC_DIM), np.float32)
    s = torch.as_tensor(np.asarray(segs, np.float32), device=mag.device)
    d = _describe_batch(mag.to(torch.float32), angle.to(torch.float32), s)
    # SIFT-style: normalize, clip, renormalize
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True),
                        min=1e-12)
    d = torch.clamp(d, max=0.3)
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True),
                        min=1e-12)
    return d.cpu().numpy()
