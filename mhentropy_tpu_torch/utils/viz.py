"""Visualisation: 2D/3D skeleton plots, mesh export, rotating-GIF export,
and the 3D viewer.

Port of mhentropy_tpu/utils/viz.py, from `_finger_chains` :23 to
`show_scene` :228: per-finger colour palettes, 2D keypoint overlays on
crops, 3D pose axes with linked fingers, mesh export (trimesh where it
imports, else a plain OBJ writer, as in JAX), rotating-GIF turntables
(imageio; without it `export_pose3d_gif` raises), the mesh-axis
transform, and the matplotlib viewer (`display_hand`, `show_scene`) with
`generate_random_hand` through the port's MANO on the model's device.
matplotlib, trimesh and imageio are imported lazily, so the compute path
never depends on them.
"""

from __future__ import annotations

import numpy as np

# Per-finger colour ramps (5 shades each, thumb..pinky), pred=red / gt=blue
# families as in the reference's colour lists (viz.py / preprocess.py:6-7).
COLORS_PRED = ("#660000", "#b30000", "#ff0000", "#ff4d4d", "#ff9999")
COLORS_GT = ("#000066", "#0000b3", "#0000ff", "#4d4dff", "#9999ff")

# RHD ordering: wrist 0; finger f occupies joints [1+4f, 1+4(f+1)).
FINGER_SLICES = tuple((1 + 4 * f, 1 + 4 * (f + 1)) for f in range(5))


def _finger_chains(points: np.ndarray):
    for (start, end) in FINGER_SLICES:
        yield np.concatenate([points[start:end], points[0:1]], axis=0)


def plot_pose2d(ax, uv: np.ndarray, colors=COLORS_PRED, image=None, s=8,
                norm: str = "auto"):
    """2D skeleton overlay (viz.py:133-235).

    norm: the image's value convention — "pm1" ([-1,1] dataset
    normalisation), "unit" ([0,1]), "u8" (raw 0-255), or "auto" (guess).
    The guess cannot distinguish a BRIGHT [-1,1] crop (all pixels >= 0)
    from a genuine [0,1] image — pass norm explicitly for debug overlays
    where brightness fidelity matters."""
    if image is not None:
        img = np.asarray(image)
        if norm == "pm1":
            img = (img + 1.0) / 2.0
        elif norm == "u8":
            img = img.astype(np.float32) / 255.0
        elif norm == "unit":
            img = img.astype(np.float32)
        elif img.min() < 0:  # auto: [-1,1] normalised
            img = (img + 1.0) / 2.0
        elif img.max() > 1.0 or img.dtype == np.uint8:
            # Raw 0-255 pixels (the default u8 transport) — clipping
            # them to [0, 1] rendered a blank panel.
            img = img.astype(np.float32) / 255.0
        ax.imshow(np.clip(img, 0, 1))
    uv = uv.reshape(-1, 2)
    for chain, c in zip(_finger_chains(uv), colors):
        ax.plot(chain[:, 0], chain[:, 1], color=c, linewidth=1.5)
    ax.scatter(uv[:, 0], uv[:, 1], s=s, c="w", edgecolors="k", zorder=3)
    ax.axis("off")


def plot_pose3d(ax, xyz: np.ndarray, colors=COLORS_PRED, lim=2.0):
    """3D skeleton axes (viz.py:247-330)."""
    xyz = xyz.reshape(-1, 3)
    for chain, c in zip(_finger_chains(xyz), colors):
        ax.plot(chain[:, 0], chain[:, 1], chain[:, 2], color=c)
    ax.scatter(xyz[:, 0], xyz[:, 1], xyz[:, 2], s=4, c="k")
    for setter in (ax.set_xlim3d, ax.set_ylim3d, ax.set_zlim3d):
        setter(-lim, lim)


def viz_2djoints(image, uvs, path: str, gt_uv=None, titles=None):
    """Save a row of images with hypothesis overlays (viz.py usage in
    network.py/criteria.py debug paths)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    uvs = np.asarray(uvs)
    if uvs.ndim == 1:  # one flat (2K,) pose
        uvs = uvs[None]
    if uvs.ndim == 2 and uvs.shape[-1] == 2:
        # A single (K, 2) pose is ONE hypothesis (np.atleast_3d appended
        # the axis at the END, splitting a skeleton into K one-dot panels).
        uvs = uvs[None]
    n = uvs.shape[0]
    fig, axes = plt.subplots(1, n, figsize=(3 * n, 3), squeeze=False)
    for i in range(n):
        plot_pose2d(axes[0, i], uvs[i], image=image)
        if gt_uv is not None:
            plot_pose2d(axes[0, i], gt_uv, colors=COLORS_GT)
        if titles:
            axes[0, i].set_title(titles[i])
    fig.savefig(path, bbox_inches="tight", dpi=100)
    plt.close(fig)
    return path


def mesh_axis_tsfm(verts: np.ndarray) -> np.ndarray:
    """Axis flip applied before mesh export (viz.py mesh-axis transform):
    MANO camera coords -> y-up viewer coords."""
    out = np.asarray(verts).copy()
    out[:, 1] *= -1.0
    out[:, 2] *= -1.0
    return out


def export_mano_mesh(verts: np.ndarray, faces: np.ndarray, path: str):
    """Mesh export (viz.py:72-93): trimesh when available, plain Wavefront
    OBJ writer otherwise."""
    v = mesh_axis_tsfm(np.asarray(verts).reshape(-1, 3))
    f = np.asarray(faces).reshape(-1, 3)
    try:
        import trimesh

        trimesh.Trimesh(vertices=v, faces=f, process=False).export(path)
        return path
    except Exception:
        pass  # absent or stubbed trimesh -> plain OBJ writer below
    with open(path, "w") as fp:
        for x, y, z in v:
            fp.write(f"v {x:.6f} {y:.6f} {z:.6f}\n")
        for a, b, c in f + 1:  # OBJ is 1-indexed
            fp.write(f"f {a} {b} {c}\n")
    return path


def _imageio():
    """imageio's v2 interface (the package itself before it had one);
    without imageio the GIF export raises, and writes nothing else."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        try:
            import imageio
        except ImportError as e:
            raise ImportError("export_pose3d_gif writes the GIF with imageio, which is not "
                              "installed") from e
    return imageio


def export_pose3d_gif(xyz: np.ndarray, path: str, frames: int = 36, lim=2.0):
    """Rotating-turntable GIF of a 3D pose (viz.py:247-330)."""
    imageio = _imageio()
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    images = []
    fig = plt.figure(figsize=(3, 3))
    ax = fig.add_subplot(111, projection="3d")
    for i in range(frames):
        ax.cla()
        plot_pose3d(ax, xyz, lim=lim)
        ax.view_init(elev=20, azim=i * 360.0 / frames)
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        images.append(buf.copy())
    plt.close(fig)
    imageio.mimsave(path, images, fps=12)
    return path


# ---------------------------------------------------------------- 3D viewer
# The reference's interactive surface: manopth/demo.py:10-59 (display_hand /
# cam_equal_aspect_3d / generate_random_hand) and the Open3D scene viewer in
# ho3d_vis_utils.py:249-330 (open3dVisualize). Open3D is not in this
# environment; the viewer renders the same scene with matplotlib 3D —
# interactive when a display exists, PNG export otherwise.


def cam_equal_aspect_3d(ax, verts: np.ndarray, flip_x: bool = False):
    """Center the view on the verts cuboid, invert y/z (demo.py:44-59)."""
    extents = np.stack([verts.min(0), verts.max(0)], axis=1)
    sz = extents[:, 1] - extents[:, 0]
    centers = np.mean(extents, axis=1)
    r = max(abs(sz)) / 2
    if flip_x:
        ax.set_xlim(centers[0] + r, centers[0] - r)
    else:
        ax.set_xlim(centers[0] - r, centers[0] + r)
    ax.set_ylim(centers[1] + r, centers[1] - r)
    ax.set_zlim(centers[2] + r, centers[2] - r)


def display_hand(hand_info: dict, mano_faces=None, ax=None, alpha=0.2,
                 batch_idx: int = 0, show: bool = True, path: str | None = None):
    """Mesh + joints 3D display (demo.py:18-41). Saves to `path` (or just
    returns the axis) when headless/show=False."""
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    fig = None
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
    verts = np.asarray(hand_info["verts"][batch_idx])
    joints = np.asarray(hand_info["joints"][batch_idx])
    if mano_faces is None:
        ax.scatter(verts[:, 0], verts[:, 1], verts[:, 2], alpha=0.1)
    else:
        mesh = Poly3DCollection(verts[np.asarray(mano_faces)], alpha=alpha)
        mesh.set_edgecolor((50 / 255,) * 3)
        mesh.set_facecolor((141 / 255, 184 / 255, 226 / 255))
        ax.add_collection3d(mesh)
    ax.scatter(joints[:, 0], joints[:, 1], joints[:, 2], color="r")
    cam_equal_aspect_3d(ax, verts)
    if path is not None:
        # Save the composed figure even when the caller supplied the ax
        # (a silently skipped export loses headless composition output).
        target_fig = fig if fig is not None else ax.figure
        target_fig.savefig(path)
        if fig is not None:
            plt.close(fig)
    elif show:
        plt.show()
    return ax


def generate_random_hand(model, batch_size: int = 1, ncomps: int = 6,
                         seed: int = 0) -> dict:
    """Random MANO hands for the viewer (demo.py:10-15), decoded by the
    port's MANO on the device of `model`'s tensors; numpy out."""
    import torch

    from mhentropy_tpu_torch.core import mano as mano_lib
    from mhentropy_tpu_torch.core.mano import ManoConfig

    rng = np.random.RandomState(seed)
    pose = rng.rand(batch_size, ncomps + 3).astype(np.float32)
    betas = np.zeros((batch_size, 10), np.float32)
    dev = model.v_template.device
    with torch.no_grad():
        verts, joints = mano_lib.mano_forward(
            model, torch.from_numpy(pose).to(dev), torch.from_numpy(betas).to(dev),
            ManoConfig(use_pca=True, ncomps=ncomps, flat_hand_mean=False),
        )
    return {"verts": verts.cpu().numpy(), "joints": joints.cpu().numpy(),
            "faces": model.faces.cpu().numpy()}


def show_scene(meshes, colors=None, path: str | None = None, show: bool = True):
    """Multi-mesh scene viewer (ho3d_vis_utils.py:304-330 open3dVisualize
    equivalent): meshes = [(verts, faces), ...], colors = per-mesh RGB.
    Interactive window when a display exists; PNG export via `path`."""
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    default = [(0.6, 0.2, 0.2), (0.5, 0.5, 0.5), (0.2, 0.5, 0.2)]
    all_verts = []
    for i, (verts, faces) in enumerate(meshes):
        verts = np.asarray(verts)
        all_verts.append(verts)
        color = (colors or default)[i % len(colors or default)]
        poly = Poly3DCollection(verts[np.asarray(faces)], alpha=0.3)
        poly.set_facecolor(color)
        ax.add_collection3d(poly)
    cam_equal_aspect_3d(ax, np.concatenate(all_verts, 0))
    if path is not None:
        fig.savefig(path)
        plt.close(fig)
        return path
    if show:
        plt.show()
    return ax
