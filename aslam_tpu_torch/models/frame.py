"""Per-frame record: features + undistorted coords + 3D backprojection.

Port of `aslam_tpu/models/frame.py`: extract features, sample depth at the
keypoints (refined by a gated 3x3 depth-plane fit), undistort, backproject
to camera-frame 3D and compute the pseudo-stereo coordinate u - bf/z.

`_make_frame_impl` also takes a batch of frames with the batch first
(`models/batch_vo.py::batch_frame`): every field of the FrameData then has
that leading axis, and one frame runs what it ran before the axis existed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aslam_tpu_torch.config import SystemConfig
from aslam_tpu_torch.models.extractor import Features, _extract_impl
from aslam_tpu_torch.ops.index import take_pixels
from aslam_tpu_torch.ops.linalg import chol_solve
from aslam_tpu_torch.utils import camera


class FrameData(NamedTuple):
    feat: Features            # padded keypoint set (level-0 raw pixel coords)
    xy_und: torch.Tensor      # [M,2] undistorted pixel coords
    p3d: torch.Tensor         # [M,3] camera-frame backprojection
    ur: torch.Tensor          # [M] pseudo-stereo right-u, -1 where no depth
    depth: torch.Tensor       # [M] sampled depth (m), 0 where invalid
    has_depth: torch.Tensor   # [M] bool
    T_cw: torch.Tensor        # [4,4] world-to-camera pose
    depth_map: torch.Tensor   # [H,W] full depth image (m)
    # (batched: a leading [B] on every field)


def _make_frame_impl(img: torch.Tensor, depth_map: torch.Tensor,
                     grid_thresholds: torch.Tensor, cfg: SystemConfig):
    """img [..., H, W] (uint8 or float32 gray), depth_map [..., H, W] (uint16
    counts or float32 metres), grid_thresholds [..., g, g], all on one
    device -> (FrameData, new grid thresholds)."""
    cam = cfg.camera
    lead = img.shape[:-2]
    height, width = img.shape[-2:]
    # raw sensor dtypes are converted on the device
    if img.dtype != torch.float32:
        img = img.to(torch.float32)
    if depth_map.dtype == torch.uint16:
        # read the counts through int16, whose kernels every device has
        counts = depth_map.view(torch.int16).to(torch.int32) & 0xFFFF
        depth_map = counts.to(torch.float32) * cam.depth_factor
    elif depth_map.dtype in (torch.int32, torch.int64):
        depth_map = depth_map.to(torch.float32) * cam.depth_factor
    elif depth_map.dtype != torch.float32:
        depth_map = depth_map.to(torch.float32)

    feat, new_grid = _extract_impl(img, grid_thresholds, cfg.extractor)

    # depth at the raw (distorted) keypoint pixel
    xi = torch.clamp(torch.round(feat.xy[..., 0]).to(torch.int64), 0, width - 1)
    yi = torch.clamp(torch.round(feat.xy[..., 1]).to(torch.int64), 0,
                     height - 1)
    z = take_pixels(depth_map, yi, xi)
    has_depth = feat.valid & (z > 0.05) & torch.isfinite(z)
    z = torch.where(has_depth, z, torch.zeros_like(z))

    # fit a local plane z(u,v) = z0 + gx du + gy dv over the k x k window
    # (weighted LS, neighbours gated to 3-sigma Khoshelham agreement with the
    # centre) and read z0 at the sub-pixel keypoint
    r = (cfg.extractor.depth_patch - 1) // 2
    if r > 0:
        gate = camera.khoshelham_gate(z)
        S = torch.zeros_like(z)
        Su = torch.zeros_like(z)
        Sv = torch.zeros_like(z)
        Suu = torch.zeros_like(z)
        Svv = torch.zeros_like(z)
        Suv = torch.zeros_like(z)
        Sz = torch.zeros_like(z)
        Suz = torch.zeros_like(z)
        Svz = torch.zeros_like(z)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                yy = torch.clamp(yi + dy, 0, height - 1)
                xx = torch.clamp(xi + dx, 0, width - 1)
                zn = take_pixels(depth_map, yy, xx)
                ok = (zn > 0.05) & torch.isfinite(zn) \
                    & (torch.abs(zn - z) <= gate)
                w = ok.to(z.dtype)
                du = xx.to(z.dtype) - feat.xy[..., 0]
                dv = yy.to(z.dtype) - feat.xy[..., 1]
                S = S + w
                Su = Su + w * du
                Sv = Sv + w * dv
                Suu = Suu + w * du * du
                Svv = Svv + w * dv * dv
                Suv = Suv + w * du * dv
                Sz = Sz + w * zn
                Suz = Suz + w * du * zn
                Svz = Svz + w * dv * zn
        # ridged 3x3 normal equations, SPD
        A = torch.stack([
            torch.stack([S + 1e-6, Su, Sv], -1),
            torch.stack([Su, Suu + 1e-4, Suv], -1),
            torch.stack([Sv, Suv, Svv + 1e-4], -1),
        ], -2)
        z0 = chol_solve(A, torch.stack([Sz, Suz, Svz], -1))[..., 0]
        z_mean = Sz / torch.clamp(S, min=1.0)
        # a plane needs >= 4 gated supports and must stay inside the gate;
        # otherwise the gated mean
        plane_ok = (S >= 4) & torch.isfinite(z0) & (torch.abs(z0 - z) <= gate)
        z = torch.where(has_depth, torch.where(plane_ok, z0, z_mean),
                        torch.zeros_like(z))

    xy_und = camera.undistort_points(cam, feat.xy)
    frame = FrameData(
        feat=feat,
        xy_und=xy_und,
        p3d=camera.unproject(cam, xy_und, z),
        ur=camera.u_right(cam, xy_und[..., 0], z),
        depth=z,
        has_depth=has_depth,
        T_cw=torch.eye(4, dtype=torch.float32, device=img.device).expand(
            lead + (4, 4)).contiguous(),
        depth_map=depth_map,
    )
    return frame, new_grid


def make_frame(img: torch.Tensor, depth_map: torch.Tensor, cfg: SystemConfig,
               grid_thresholds: torch.Tensor):
    """-> (FrameData at the identity pose, new grid thresholds)."""
    return _make_frame_impl(img, depth_map, grid_thresholds, cfg)


def with_pose(frame: FrameData, T_cw: torch.Tensor) -> FrameData:
    return frame._replace(T_cw=T_cw)
