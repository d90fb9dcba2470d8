#!/usr/bin/env python3
"""Why batched VO runs two products once per lane: on a CUDA card, a
batched cuBLAS product rounds otherwise than the single image's call.

    python scripts/batch_bits_probe.py          (from the repository root;
                                                 needs one card)

Prints, at full width (640x480, 1024 keypoints, B = 16 rendered frames):
  1. for each batched form of the pyramid resize (`wy.T @ img @ wx` on
     [B,H,W] by broadcasting; folded into one 2-D product per side), how
     many lanes of each level differ from the single image's call;
  2. how many of the [B*K] IC angles a [B*K, 961] product gives differ from
     the per-lane [K, 961] products;
  3. lanes 0-3 of a B = 16 `BatchVisualOdometry` run with injected draws
     against the unbatched `track_frame` chain (max |dT|, descriptor bits
     apart), with the per-lane products of `ops/pyramid.py` and
     `ops/orb.py` and with the batched forms swapped in.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch


def _frames(cam, B, F):
    from aslam_tpu_torch.utils import synthetic

    seqs = [synthetic.make_sequence(n_frames=F, n_points=1500, cam=cam,
                                    seed=50 + b) for b in range(B)]
    imgs = np.stack([np.clip(s[0], 0, 255).astype(np.uint8) for s in seqs])
    deps = np.stack([np.clip(s[1] / cam.depth_factor, 0, 65535)
                     .astype(np.uint16) for s in seqs])
    return imgs, deps


def _resize_broadcast(img, h, w):
    from aslam_tpu_torch.ops import pyramid

    H, W = img.shape[-2:]
    wy = pyramid._resize_weights_on(H, h, img.device)
    wx = pyramid._resize_weights_on(W, w, img.device)
    return wy.T @ img @ wx


def _resize_folded(img, h, w):
    from aslam_tpu_torch.ops import pyramid

    B, H, W = img.shape
    wy = pyramid._resize_weights_on(H, h, img.device)
    wx = pyramid._resize_weights_on(W, w, img.device)
    t = (wy.T @ img.transpose(0, 1).reshape(H, B * W)).reshape(
        h, B, W).transpose(0, 1)
    return (t.reshape(B * h, W) @ wx).reshape(B, h, w)


def _ic_angle_folded(patches):
    from aslam_tpu_torch.ops import orb

    wx, wy, _ = orb._tables_on(patches.device)
    flat = patches.reshape(-1, orb.PATCH * orb.PATCH)
    return torch.atan2(flat @ wy, flat @ wx).reshape(patches.shape[:-2])


def _lanes_vs_chain(cfg, imgs, deps, dev, F):
    """Lanes 0-3 of a B-lane run with injected draws against the unbatched
    chain -> (max |dT|, descriptor bits apart)."""
    from aslam_tpu_torch.models import odometry
    from aslam_tpu_torch.models.batch_vo import BatchVisualOdometry
    from aslam_tpu_torch.models.extractor import init_grid_thresholds
    from aslam_tpu_torch.models.frame import make_frame
    from aslam_tpu_torch.ops.orb import unpack_bits

    B = imgs.shape[0]
    H, S = cfg.ransac.n_hypotheses, cfg.ransac.sample_size
    draws = torch.from_numpy(np.random.default_rng(90).integers(
        0, 100, (B, F - 1, H, S))).to(dev)
    imgs_d = torch.from_numpy(imgs).to(dev)
    deps_d = torch.from_numpy(deps).to(dev)
    bvo = BatchVisualOdometry(cfg, B, dev)
    descs = []
    for f in range(F):
        bvo.process(imgs_d[:, f], deps_d[:, f],
                    draws=None if f == 0 else draws[:, f - 1])
        descs.append(bvo.prev.feat.desc[:4])
    traj = bvo.trajectories()
    dT, bits = 0.0, 0
    for b in range(4):
        grid = init_grid_thresholds(cfg.extractor, dev)
        frame, grid = make_frame(imgs_d[b, 0], deps_d[b, 0], cfg, grid)
        for f in range(1, F):
            frame, grid, res = odometry.track_frame(
                frame, imgs_d[b, f], deps_d[b, f], grid, None, cfg,
                draws=draws[b, f - 1])
            bits += int((unpack_bits(frame.feat.desc)
                         != unpack_bits(descs[f][b])).sum())
            dT = max(dT, float(np.abs(res.T_cw2.cpu().numpy()
                                      - traj[f - 1, b]).max()))
    return dT, bits


def main():
    if not torch.cuda.is_available():
        raise SystemExit("batch_bits_probe: needs a CUDA card")
    import aslam_tpu_torch  # noqa: F401  (the precision policy: full f32)
    from aslam_tpu_torch.config import CameraModel, SystemConfig
    from aslam_tpu_torch.models.extractor import init_grid_thresholds
    from aslam_tpu_torch.models.frame import _make_frame_impl
    from aslam_tpu_torch.ops import desc, orb, pyramid

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cam = CameraModel(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640,
                      height=480)
    cfg = SystemConfig(camera=cam)
    B, F = 16, 8
    imgs, deps = _frames(cam, B, F)
    img = torch.from_numpy(imgs[:, 1]).to(dev).float()

    # 1. the resize
    shapes = [pyramid.level_shape(480, 640, cfg.extractor.scale_factor, l)
              for l in range(1, cfg.extractor.n_levels)]
    for name, fn in (("broadcast", _resize_broadcast),
                     ("folded", _resize_folded)):
        prev, bad = img, []
        for h, w in shapes:
            single = torch.stack([pyramid.resize(x, h, w) for x in prev])
            batched = fn(prev, h, w)
            bad.append(sum(int(not torch.equal(batched[b], single[b]))
                           for b in range(B)))
            prev = single
        print(f"1. resize, {name}: lanes of {B} that differ from the single "
              f"image's call, levels 1-{len(shapes)}: {bad} [{card}]",
              flush=True)

    # 2. the IC angle at the FAST keypoints of the single-frame call
    g = init_grid_thresholds(cfg.extractor, dev)
    xy = torch.stack([_make_frame_impl(img[b], torch.from_numpy(deps[b, 1])
                                       .to(dev), g, cfg)[0].feat.xy
                      for b in range(B)])
    patches = orb.extract_patches(pyramid.gaussian_blur(img), xy)
    per_lane = orb.ic_angle(patches)
    folded = _ic_angle_folded(patches)
    n_bad = int((folded != per_lane).sum())
    print(f"2. IC angle, one [B*K, 961] product: {n_bad} of "
          f"{per_lane.numel()} angles differ from the per-lane products "
          f"[{card}]", flush=True)

    # 3. what the lanes do with each
    for name in ("per lane (the port)", "batched products swapped in"):
        if name.startswith("batched"):
            orig = pyramid.resize, orb.ic_angle

            def resize(x, h, w, _orig=orig[0]):
                if x.dim() == 2:
                    return _orig(x, h, w)
                return _resize_broadcast(x, h, w)

            def ic_angle(p, _orig=orig[1]):
                return _orig(p) if p.dim() == 3 else _ic_angle_folded(p)

            pyramid.resize = resize
            orb.ic_angle = desc.ic_angle = ic_angle
        dT, bits = _lanes_vs_chain(cfg, imgs, deps, dev, F)
        print(f"3. B = {B} with injected draws, lanes 0-3 against the "
              f"unbatched chain over {F} frames, {name}: max |dT| {dT:.3e}, "
              f"{bits} descriptor bits apart [{card}]", flush=True)


if __name__ == "__main__":
    sys.exit(main())
