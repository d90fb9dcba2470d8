"""Where the batched VO's per-lane ATE gap to the JAX package comes from.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python scripts/batch_ate_witness.py

On the CPU at full width (640x480, 1024 keypoints, 256 hypotheses), over
the 16 frames of `chip_smoke.py` phase 9(b)'s lanes 0-3 (`make_sequence(
n_frames=16, n_points=1500, seed=50 + b)`, uint8 / uint16), it prints the
per-lane ATE (cm) of:

  1. the JAX package's `BatchVisualOdometry` (seed 0): `JAX_BATCH_ATE_M`;
  2. the port's `batch_rba` chained over the JAX package's own frames with
     its RANSAC draws (its key recurrence rebuilt per step): the port's
     odometry alone;
  3. the port's `BatchVisualOdometry`, extracting its own frames, fed the
     same draws: the port's front end;
  4. the same with the port's own generator, seeds 0-2: the draws' share.

If 2 equals 1 and 3 equals 4 whatever the seed, the gap is in the frames
(the pyramid, the extractor), not in matching, RANSAC or the draws.  A
research script: it imports both packages, as the port's tests do; ~6 min
and ~2 GB on a CPU.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_parity as P
from aslam_tpu.config import CameraModel, SystemConfig
from aslam_tpu.models import batch_vo as jbatch
from aslam_tpu.utils import synthetic
from aslam_tpu_torch import convert
from aslam_tpu_torch.models import batch_vo as tbatch
from aslam_tpu_torch.utils import trajectory

CAM = CameraModel(fx=517.3, fy=516.5, cx=318.6, cy=255.3, width=640,
                  height=480)
B, F = 4, 16


def main():
    torch.set_num_threads(4)
    cfg = SystemConfig(camera=CAM)
    pcfg = P.port_config(cfg)
    seqs = [synthetic.make_sequence(n_frames=F, n_points=1500, cam=CAM,
                                    seed=50 + b) for b in range(B)]
    imgs = np.stack([np.clip(s[0], 0, 255).astype(np.uint8) for s in seqs])
    deps = np.stack([np.clip(s[1] / CAM.depth_factor, 0, 65535)
                     .astype(np.uint16) for s in seqs])

    def ates(traj):
        return [round(100 * trajectory.ate_rmse(
            trajectory.camera_centers(
                np.concatenate([np.eye(4)[None], traj[:, b]])),
            trajectory.camera_centers(seqs[b][2])), 4) for b in range(B)]

    def lane(tree, b):
        return jax.tree.map(lambda x: x[b], tree)

    t0 = time.time()
    h, w = imgs.shape[2:]
    ref = jbatch.BatchVisualOdometry(cfg, batch=B, seed=0)
    port = tbatch.BatchVisualOdometry(pcfg, B, "cpu")
    prev_t, on_ref = None, []
    for f in range(F):
        im, de = imgs[:, f], deps[:, f]
        cur, _ = jbatch.batch_frame(jnp.asarray(im), jnp.asarray(de),
                                    ref.grids, cfg, h, w)
        cur_t = convert.frame_data(P.tree_np(cur), "cpu")
        d = None
        if f:
            _, sub = jax.random.split(ref.key)
            keys = jax.random.split(sub, B)
            d = np.stack([P.ref_draws(lane(ref.prev, b), lane(cur, b),
                                      keys[b], cfg) for b in range(B)])
            res = tbatch.batch_rba(prev_t, cur_t, None, pcfg, draws=P.t(d))
            cur_t = cur_t._replace(T_cw=res.T_cw2)
            on_ref.append(P.n(res.T_cw2))
        prev_t = cur_t
        ref.process(im, de)
        port.process(P.t(im), P.t(de), draws=None if d is None else P.t(d))
    print("1. JAX BatchVisualOdometry, seed 0:          ",
          ates(ref.trajectories()), flush=True)
    print("2. port batch_rba on JAX's frames and draws: ",
          ates(np.stack(on_ref)), flush=True)
    print("3. port BatchVisualOdometry, JAX's draws:    ",
          ates(port.trajectories()), flush=True)
    for seed in range(3):
        own = tbatch.BatchVisualOdometry(pcfg, B, "cpu", seed=seed)
        for f in range(F):
            own.process(P.t(imgs[:, f]), P.t(deps[:, f]))
        print(f"4. port BatchVisualOdometry, own seed {seed}:    ",
              ates(own.trajectories()), flush=True)
    print(f"{time.time() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    main()
