"""Host-side visualization: per-frame artifacts, off the tracking path.

Port of lvt_tpu/viz.py, in capability the reference's
``lvt_visualization`` (lvt/src/lvt_visualization.cpp): 2-D feature
overlays colored by map-point age with unmatched features as white boxes
(:99-135), and the 3-D map view (map points, staged points, camera
trail, :137-322), rendered to PNG files with matplotlib from the
VOSystem's state (read back to the host). matplotlib is imported when a
drawing function runs, not with the module: the machine that runs the
port on the card may lack it.
"""

from __future__ import annotations

import os

import numpy as np


def _host(x) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _require_matplotlib():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_features(
    img: np.ndarray,
    keypoints: np.ndarray,       # [K, 2]
    kp_valid: np.ndarray,        # [K]
    matched_age: np.ndarray | None = None,  # [K] age of the matching map
    #                              point, -1 for unmatched features
    out_path: str | None = None,
    max_age: int = 20,
):
    """Feature overlay: matched features colored by age (young=green ->
    old=red like the reference's age coloring), unmatched as white boxes."""
    plt = _require_matplotlib()
    fig, ax = plt.subplots(figsize=(12, 12 * img.shape[0] / img.shape[1]))
    ax.imshow(_host(img), cmap="gray", vmin=0, vmax=255)
    kp = _host(keypoints)[_host(kp_valid).astype(bool)]
    if matched_age is not None:
        age = _host(matched_age)[_host(kp_valid).astype(bool)]
        unmatched = age < 0
        ax.scatter(kp[unmatched, 0], kp[unmatched, 1], s=30, marker="s",
                   facecolors="none", edgecolors="white", linewidths=0.8)
        m = ~unmatched
        ax.scatter(kp[m, 0], kp[m, 1], s=18, c=np.clip(age[m] / max_age, 0, 1),
                   cmap="RdYlGn_r", vmin=0, vmax=1)
    else:
        ax.scatter(kp[:, 0], kp[:, 1], s=18, c="lime")
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    if out_path:
        fig.savefig(out_path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig


def draw_map(
    state,
    trajectory: np.ndarray | None = None,  # [N, 3] camera positions
    out_path: str | None = None,
):
    """Top-down (x-z) map view: map points blue, staged green, trajectory
    red — the reference's Pangolin viewer content as a static plot."""
    plt = _require_matplotlib()
    fig, ax = plt.subplots(figsize=(9, 9))
    mp = _host(state.map.pos)[_host(state.map.valid)]
    sp = _host(state.staged.pos)[_host(state.staged.valid)]
    if len(mp):
        ax.scatter(mp[:, 0], mp[:, 2], s=4, c="tab:blue", label="map")
    if len(sp):
        ax.scatter(sp[:, 0], sp[:, 2], s=4, c="tab:green", label="staged")
    if trajectory is not None and len(trajectory):
        t = np.asarray(trajectory)
        ax.plot(t[:, 0], t[:, 2], "r-", lw=1.5, label="trajectory")
        ax.plot(t[-1, 0], t[-1, 2], "r^", ms=9)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="upper right")
    ax.grid(alpha=0.3)
    if out_path:
        fig.savefig(out_path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig


def plot_trajectories(
    trajectories: dict[str, np.ndarray],  # name -> [N, 3]
    out_path: str | None = None,
):
    """x-z trajectory comparison plot (est vs ground truth etc.)."""
    plt = _require_matplotlib()
    fig, ax = plt.subplots(figsize=(9, 9))
    for name, xyz in trajectories.items():
        xyz = np.asarray(xyz)
        ax.plot(xyz[:, 0], xyz[:, 2], lw=1.5, label=name)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend()
    ax.grid(alpha=0.3)
    if out_path:
        fig.savefig(out_path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return out_path
    return fig


def feature_debug(vo, img: np.ndarray):
    """Per-feature debug data for the age-colored overlay
    (lvt_visualization::display_features, lvt_visualization.cpp:99-135).

    Extracts the frame's features again and matches them against the
    CURRENT map at the current pose, with the port's extraction and
    matching on the VOSystem's device, off the tracking path. Pass the
    image given to track(); with ``rectify_maps`` the raw frame is
    rectified here too, so the keypoints are where the step saw them.
    Returns (display_img [H, W], the possibly rectified frame the
    keypoints lie in; keypoints [K, 2]; valid [K]; matched_age [K], -1 =
    unmatched), all numpy. Draw on display_img, not on the raw input."""
    from lvt_tpu_torch.core import extract, step as step_mod
    from lvt_tpu_torch.device import upload
    from lvt_tpu_torch.ops import matching
    from lvt_tpu_torch.ops.undistort import remap_bilinear

    config = vo.config
    img = upload(np.asarray(img), vo.device).float()
    maps = getattr(vo, "rectify_maps", None)
    if maps is not None:
        img = remap_bilinear(img, maps[0])
    feats = extract.extract_features(img, config)
    st = vo.state
    mm = matching.find_map_matches(
        st.map.pos, st.map.desc, st.map.valid, st.pose, feats,
        tracking_radius=config.tracking_radius,
        ratio_threshold=config.tracking_ratio_test_threshold,
        abs_threshold=config.descriptor_matching_threshold,
        retry_min_matches=config.n_matches_threshold,
        **step_mod._camera_kwargs(config),
    )
    kp = _host(feats.kp)
    valid = _host(feats.valid)
    match_idx = _host(mm.match_idx)
    map_age = _host(st.map.age)
    age = np.full(kp.shape[0], -1, np.int32)
    hit = match_idx >= 0
    age[match_idx[hit]] = map_age[hit]
    return _host(img), kp, valid, age


class FrameDumper:
    """Optional per-frame artifact writer wired like the reference's
    visualization hooks: call after each tracked frame."""

    def __init__(self, out_dir: str, every: int = 1):
        self.out_dir = out_dir
        self.every = every
        self._i = 0
        self.trajectory: list[np.ndarray] = []
        os.makedirs(out_dir, exist_ok=True)

    def update(self, vo, img: np.ndarray | None = None) -> None:
        self.trajectory.append(_host(vo.last_pose.t).copy())
        if self._i % self.every == 0:
            if img is not None:
                disp, kp, valid, age = feature_debug(vo, img)
                draw_features(
                    disp, kp, valid, matched_age=age,
                    out_path=os.path.join(self.out_dir,
                                          f"features_{self._i:06d}.png"),
                )
            draw_map(
                vo.state, np.array(self.trajectory),
                out_path=os.path.join(self.out_dir, f"map_{self._i:06d}.png"),
            )
        self._i += 1
