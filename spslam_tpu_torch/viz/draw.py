"""Map, trajectory and frame pictures written to image files (port of
spslam_tpu/viz/draw.py, the stand-in for the reference's Pangolin viewer):
map points, plane normals, keyframes, trajectory against ground truth,
keypoint overlays and the plane segmentation, as PNG through matplotlib
(Agg) or OpenCV.

Host code on numpy arrays.  matplotlib and OpenCV are imported inside the
functions, since the rest of the port needs neither: draw_frame and
draw_plane_segmentation need OpenCV, draw_map_topdown needs matplotlib.
"""

from __future__ import annotations

import numpy as np


def draw_map_topdown(store, poses_est=None, poses_gt=None, path="map.png"):
    """Top-down (x-z) view: map points, planes, keyframes, trajectories."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..geometry.np_lie import camera_center

    fig, ax = plt.subplots(figsize=(8, 8))
    pts = store.pt_pos[store.pt_valid]
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], s=0.5, c="#888888", label=f"{len(pts)} points")
    kf = store.kf_pose[store.kf_valid]
    if len(kf):
        C = camera_center(kf)
        ax.plot(C[:, 0], C[:, 2], "b.-", lw=0.8, ms=3, label=f"{len(kf)} keyframes")
    if poses_est is not None and len(poses_est):
        C = camera_center(np.asarray(poses_est))
        ax.plot(C[:, 0], C[:, 2], "g-", lw=1.0, label="estimate")
    if poses_gt is not None and len(poses_gt):
        C = camera_center(np.asarray(poses_gt))
        ax.plot(C[:, 0], C[:, 2], "r--", lw=1.0, label="ground truth")
    # planes as normal arrows from their centroid-on-plane point
    for l in np.nonzero(store.pl_valid)[0]:
        n, d = store.pl_coef[l, :3], store.pl_coef[l, 3]
        p0 = -d * n  # closest point to origin
        ax.annotate(
            "", xy=(p0[0] + 0.5 * n[0], p0[2] + 0.5 * n[2]), xytext=(p0[0], p0[2]),
            arrowprops=dict(arrowstyle="->", color="m"),
        )
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title(f"map: {int(store.pt_valid.sum())} pts, "
                 f"{int(store.pl_valid.sum())} planes, {int(store.kf_valid.sum())} KFs")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def draw_frame(gray, uv, valid, matched=None, path="frame.png"):
    """Keypoint overlay like the reference's FrameDrawer: green = tracked
    map point, blue = detected keypoint."""
    import cv2

    img = cv2.cvtColor(gray.astype(np.uint8), cv2.COLOR_GRAY2BGR)
    uv = np.asarray(uv)
    valid = np.asarray(valid)
    matched = np.asarray(matched) if matched is not None else np.zeros(len(uv), bool)
    for i in np.nonzero(valid)[0]:
        p = (int(uv[i, 0]), int(uv[i, 1]))
        color = (0, 255, 0) if matched[i] else (255, 128, 0)
        cv2.circle(img, p, 2, color, -1)
    cv2.imwrite(path, img)
    return path


def draw_plane_segmentation(gray, block_label, block: int = 8, path="planes.png"):
    """Colorize the per-block plane segmentation over the image."""
    import cv2

    img = cv2.cvtColor(gray.astype(np.uint8), cv2.COLOR_GRAY2BGR)
    lbl = np.asarray(block_label)
    colors = np.array(
        [[255, 64, 64], [64, 255, 64], [64, 64, 255], [255, 255, 64],
         [255, 64, 255], [64, 255, 255], [192, 128, 64], [128, 64, 192]],
        np.uint8,
    )
    up = np.kron(lbl, np.ones((block, block), np.int32))
    up = up[: img.shape[0], : img.shape[1]]
    overlay = img.copy()
    for k in range(8):
        overlay[up == k] = colors[k]
    out = cv2.addWeighted(img, 0.6, overlay, 0.4, 0)
    cv2.imwrite(path, out)
    return path
