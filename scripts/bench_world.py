"""Where bench.py's camera leaves its world, and where lvt_tpu loses track.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/bench_world.py [--frames 208]

bench.py times 400 frames of a camera moving 0.9 m a frame through 6000
points spread over 160 m of depth, so the camera drives out of them. This
script renders bench.py's sequence (its recipe, lvt_tpu's SyntheticWorld),
counts the world's points in the left image at each frame, and tracks the
frames with lvt_tpu's ``VOSystem.track_chunk`` in bench.py's chunks of 16
(on the CPU, about 3 s a chunk after compiling). It prints per chunk the
points in view at its first frame and the statuses, then the first frame
that is not TRACKING and the ATE over the frames before it.
"""

import argparse

import numpy as np

from __graft_entry__ import _kitti_config
from lvt_tpu.core.system import VOSystem
from lvt_tpu.io.synthetic import SyntheticWorld, ate_rmse

CHUNK = 16      # bench.py's


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=13 * CHUNK)
    n = p.parse_args().frames // CHUNK * CHUNK
    config = _kitti_config()
    world = SyntheticWorld(
        width=config.img_width, height=config.img_height,
        fx=config.fx, fy=config.fy, cx=config.cx, cy=config.cy,
        baseline=config.baseline, n_points=6000,
        extent_x=80.0, extent_y=20.0, extent_z=160.0,
    )
    frames = list(world.stereo_sequence(n, speed=0.9))
    left = np.stack([f[0].astype(np.uint8) for f in frames])
    right = np.stack([f[1].astype(np.uint8) for f in frames])
    rot = np.array([f[2][0] for f in frames])
    pos = np.array([f[2][1] for f in frames])

    # as SyntheticWorld.render draws: in front, inside a 4-pixel margin
    cam = np.einsum("fji,fpj->fpi", rot, world.points[None] - pos[:, None])
    z = cam[..., 2]
    front = z > 0.5
    u = world.fx * cam[..., 0] / np.where(front, z, 1.0) + world.cx
    v = world.fy * cam[..., 1] / np.where(front, z, 1.0) + world.cy
    seen = (front & (u > 4) & (u < world.width - 4) & (v > 4)
            & (v < world.height - 4)).sum(-1)

    vo = VOSystem(config)
    status, est = [], []
    for c in range(0, n, CHUNK):
        poses, metrics = vo.track_chunk(left[c:c + CHUNK],
                                        right[c:c + CHUNK])
        status += np.asarray(metrics.status).tolist()
        est.append(np.asarray(poses.t))
        print(f"frames {c}-{c + CHUNK - 1}: {seen[c]} points in view at "
              f"frame {c}, statuses {status[-CHUNK:]}", flush=True)
    est = np.concatenate(est)
    lost = next((i for i, s in enumerate(status) if s != 2), n)
    err = ate_rmse(est[:lost], pos[:lost])
    dist = float(np.linalg.norm(pos[lost - 1] - pos[0]))
    print(f"first frame not TRACKING: {lost} ({seen[lost] if lost < n else '-'}"
          f" points in view; frame {lost - 1}: {seen[lost - 1]}); ATE over "
          f"frames 0-{lost - 1}: {err:.4f} m over {dist:.2f} m "
          f"({100 * err / dist:.3f}%); no point in view from frame "
          f"{int(np.argmax(seen == 0)) if (seen == 0).any() else '-'}")


if __name__ == "__main__":
    main()
