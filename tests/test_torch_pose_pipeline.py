"""The port's RLE human-pose data stack (data/pose_pipeline.py) against the
JAX package's, on the same seeded inputs; PoseDataset on a COCO-format tree
the test writes; and the input-pipeline bench (bench_input_pipeline.py) at
its smallest size.

Both modules are host numpy (and cv2) on the same formulas, so every output
is held equal exactly: each public function, SimpleTransform and
SimpleTransform3D in eval and train mode (the train draws from the
module-global random / np.random streams, seeded the same before each
side, and from a per-item RandomState), PoseDataset's items and
HeatmapToCoord.
"""

import json
import random

import numpy as np
import pytest

from mhentropy_tpu.data import pose_pipeline as jpp
from mhentropy_tpu_torch import bench_input_pipeline
from mhentropy_tpu_torch.data import pose_pipeline as pp

pytest.importorskip("cv2")

PAIRS = [[1, 2], [3, 4], [5, 6]]


def _equal(got, want, path="out"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (tuple, list)) and not np.isscalar(want):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _equal(a, b, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


def _cases(rng):
    """name -> argument tuples, seeded."""
    joints = np.zeros((7, 3, 2), np.float32)
    joints[:, :, 0] = rng.uniform(0, 60, (7, 3))
    joints[:, :2, 1] = (rng.rand(7, 1) > 0.2).astype(np.float32)
    bbox = (10.0, 12.0, 90.0, 110.0)
    hms = rng.rand(7, 16, 12).astype(np.float32)
    pts3 = rng.randn(21, 3) * 100 + np.array([0, 0, 3000.0])
    return {
        "get_dir": [([0.0, -12.5], 0.3)],
        "get_3rd_point": [(rng.randn(2).astype(np.float32), rng.randn(2).astype(np.float32))],
        "get_affine_transform": [((50.0, 60.0), np.array([80.0, 100.0]), 17.0, [48, 64]),
                                 ((50.0, 60.0), 90.0, -30.0, [64, 64], np.array([0.1, 0.0],
                                                                                  np.float32), 1)],
        "affine_transform": [(rng.randn(5, 2), rng.randn(2, 3))],
        "transform_preds": [(rng.rand(7, 2) * 16, (50.0, 60.0), np.array([80.0, 100.0]), [12, 16])],
        "heatmap_to_coord": [(rng.rand(2, 7, 3) - 0.5, rng.rand(2, 7, 1), (16, 12), bbox),
                             (rng.rand(7, 3) - 0.5, rng.rand(7, 1), (16, 12), bbox, True)],
        "get_max_pred": [(hms,)],
        "get_max_pred_batch": [(np.stack([hms, hms[::-1]]),)],
        "heatmap_to_coord_simple": [(hms, bbox)],
        "get_warpmatrix": [(23.0, (64, 48), (63.0, 47.0), (64.0, 48.0)),
                           (-11.0, (64, 48), (63.0, 47.0), (64.0, 48.0), 200.0)],
        "get_warpmatrix_inverse": [(23.0, (64, 48), (63.0, 47.0), (0.4, 0.3))],
        "bbox_xywh_to_xyxy": [((5.0, 6.0, 30.0, 40.0),), (rng.rand(4, 4) * 50,)],
        "bbox_xyxy_to_xywh": [((5.0, 6.0, 30.0, 40.0),), (rng.rand(4, 4) * 50,)],
        "bbox_clip_xyxy": [((-5.0, 6.0, 300.0, 40.0), 100, 80), (rng.randn(4, 4) * 90, 100, 80)],
        "bbox_iou": [(rng.rand(3, 4) * 50 + np.array([0, 0, 50, 50]),
                      rng.rand(2, 4) * 50 + np.array([0, 0, 50, 50]))],
        "box_to_center_scale": [(5.0, 6.0, 30.0, 40.0), (5.0, 6.0, 60.0, 20.0, 0.75, 1.0)],
        "center_scale_to_box": [((50.0, 60.0), (30.0, 40.0))],
        "flip_joints_3d": [(joints, 64, PAIRS)],
        "flip_heatmap": [(hms, PAIRS), (hms[None], PAIRS, True)],
        "flip_coord": [((rng.randn(2, 21), rng.rand(2, 7, 1)), PAIRS, 12),
                       ((rng.randn(2, 7, 3), rng.rand(2, 7, 1)), PAIRS, 12, True, False)],
        "flip_output": [({"heatmap": hms[None], "pred_jts": rng.randn(1, 7, 3),
                          "maxvals": rng.rand(1, 7, 1)}, PAIRS, 12, True)],
        "box_transform": [(list(bbox), 0.3, 100, 120, False), (list(bbox), 0.3, 100, 120, True)],
        "count_visible": [(bbox, joints * 2)],
        "gaussian_heatmap_target": [(joints, 7, (16, 12), np.array([4.0, 4.0]), 2)],
        "integral_target_2d": [(joints, 7, 64, 48)],
        "integral_target_3d": [(joints, 7, 64, 48, 2000.0)],
        "half_body_transform": [(joints[:, :, 0], joints[:, :1, 1], 7, (0, 1, 2, 3), 0.75)],
        "compute_similarity_transform": [(rng.randn(21, 3), rng.randn(21, 3))],
        "compute_similarity_transform_batch": [(rng.randn(3, 21, 3), rng.randn(3, 21, 3))],
        "reconstruction_error": [(rng.randn(3, 21, 3), rng.randn(3, 21, 3))],
        "world2cam": [(rng.randn(3, 5), rng.randn(3, 3), rng.randn(3, 1))],
        "weak_cam2pixel": [(pts3, 3000.0, (1100.0, 1120.0), (500.0, 510.0))],
        "cam2pixel": [(pts3, (1100.0, 1120.0), (500.0, 510.0))],
        "cam2pixel_matrix": [(pts3.astype(np.float32), np.concatenate(
            [pp.get_intrinsic_metrix((1100.0, 1120.0), (500.0, 510.0)), np.zeros((3, 1))], 1))],
        "pixel2cam": [(pts3, (1100.0, 1120.0), (500.0, 510.0))],
        "pixel2cam_matrix": [(pts3, pp.get_intrinsic_metrix((1100.0, 1120.0), (500.0, 510.0)))],
        "rigid_transform_3d": [(pts3, pts3 @ np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]))],
        "rigid_align": [(pts3, pts3[::-1])],
        "get_intrinsic_metrix": [((1100.0, 1120.0), (500.0, 510.0)),
                                 ((1100.0, 1120.0), (500.0, 510.0), True)],
    }


def test_every_public_function_is_covered():
    public = sorted(n for n, v in vars(jpp).items() if callable(v) and not n.startswith("_")
                    and getattr(v, "__module__", "") == jpp.__name__ and not isinstance(v, type))
    assert public == sorted(_cases(np.random.RandomState(0)))
    assert all(callable(getattr(pp, n)) for n in public)


@pytest.mark.parametrize("name", sorted(_cases(np.random.RandomState(0))))
def test_function_matches_jax(name):
    for args in _cases(np.random.RandomState(1))[name]:
        random.seed(3)
        np.random.seed(3)
        want = getattr(jpp, name)(*args)
        random.seed(3)
        np.random.seed(3)
        got = getattr(pp, name)(*args)
        _equal(got, want, name)


class _Dataset:
    """The attributes SimpleTransform(3D) reads of their dataset."""
    joint_pairs = PAIRS
    num_joints_half_body = 3
    prob_half_body = 0.3
    upper_body_ids = (0, 1, 2, 3)
    lower_body_ids = (4, 5, 6)
    root_idx = 0


def _label(rng, three_d=False):
    joints = np.zeros((7, 3, 2), np.float32)
    joints[:, :2, 0] = rng.uniform(40, 200, (7, 2))
    joints[:, :2, 1] = 1.0
    label = {"bbox": (30.0, 25.0, 210.0, 230.0), "width": 240, "height": 260,
             "joints_3d": joints}
    if three_d:
        label.update(joint_img=np.concatenate([joints[:, :2, 0], rng.randn(7, 1) * 100], 1),
                     joint_vis=np.ones((7, 3), np.float32),
                     root_cam=np.array([10.0, -20.0, 3000.0], np.float32),
                     f=(1100.0, 1120.0), c=(120.0, 130.0), action=2)
    return label


@pytest.mark.parametrize("kind", ["2d", "3d_coord", "3d_heatmap"])
@pytest.mark.parametrize("train", [False, True])
def test_simple_transforms_match_jax(kind, train):
    """Seeded draws: the global streams (the reference's order) and a
    per-item RandomState, as PoseDataset passes."""
    rng = np.random.RandomState(4)
    src = rng.randint(0, 255, (260, 240, 3)).astype(np.uint8)
    label = _label(rng, three_d=kind != "2d")
    outs = []
    for mod in (jpp, pp):
        if kind == "2d":
            t = mod.SimpleTransform(_Dataset, 0.25, (64, 48), (16, 12), 30, 2, train)
        else:
            t = mod.SimpleTransform3D(_Dataset, 0.25, 0.2, False, False, (64, 48), (16, 12),
                                      (2000, 2000, 2000), 30, 2, train,
                                      loss_type="heatmap" if kind == "3d_heatmap" else "coord")
        random.seed(5)
        np.random.seed(5)
        out = {"global": t(src, {k: np.copy(v) if isinstance(v, np.ndarray) else v
                                 for k, v in label.items()}),
               "item": t(src, dict(label, joints_3d=label["joints_3d"].copy()),
                         rng=np.random.RandomState(6)),
               "test": t.test_transform(src, label["bbox"])}
        outs.append(out)
    _equal(outs[1], outs[0], kind)


def _coco_tree(tmp_path, n=3):
    import cv2

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.RandomState(12)
    images, annotations = [], []
    for i in range(n):
        name = f"{100 + i}.png"
        cv2.imwrite(str(img_dir / name), rng.randint(0, 255, (240, 320, 3), dtype=np.uint8))
        images.append({"id": 100 + i, "file_name": name, "width": 320, "height": 240})
        kps = []
        for _ in range(17):
            kps += [float(rng.uniform(60, 260)), float(rng.uniform(50, 190)), 2.0]
        annotations.append({"id": i, "image_id": 100 + i, "category_id": 1,
                            "bbox": [50.0, 40.0, 200.0, 160.0], "keypoints": kps})
    annotations.append({"id": n, "image_id": 100, "category_id": 1,
                        "bbox": [5.0, 5.0, 20.0, 20.0], "keypoints": [0.0] * 51})
    with open(tmp_path / "ann.json", "w") as fp:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": 1, "name": "person"}]}, fp)
    return annotations


@pytest.mark.parametrize("train", [False, True])
def test_pose_dataset_matches_jax(tmp_path, train):
    """PoseDataset reads COCO-format annotations (no pycocotools; an empty
    annotation skipped) and yields (img, target, img_id, bbox) equal to the
    JAX module's, at epochs 0 and 1 in train mode; the integral targets map
    back onto the keypoints through heatmap_to_coord."""
    annotations = _coco_tree(tmp_path)
    kw = dict(train=train, ROOT=str(tmp_path), IMG_PREFIX="imgs", ANN="ann.json",
              PRESET={"IMAGE_SIZE": (256, 192), "HEATMAP_SIZE": (64, 48), "SIGMA": 2},
              AUG={"SCALE_FACTOR": 0.25, "ROT_FACTOR": 30, "NUM_JOINTS_HALF_BODY": 8,
                   "PROB_HALF_BODY": 0.3}, heatmap2coord="coord", seed=7)
    ds, jds = pp.PoseDataset(**kw), jpp.PoseDataset(**kw)
    assert len(ds) == len(jds) == 3
    for epoch in ((0, 1) if train else (0,)):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        for i in range(len(ds)):
            _equal(ds[i], jds[i], f"item {i} epoch {epoch}")
    img, target, img_id, bbox = ds[0]
    assert img.shape == (256, 192, 3) and img_id == 100 and len(bbox) == 4
    assert target["target_uv"].shape == (34,) and target["target_hm"].shape == (17, 64, 48)
    if not train:
        uv = target["target_uv"].reshape(1, 17, 2)
        preds, _ = pp.HeatmapToCoord((64, 48))(
            {"pred_jts": np.concatenate([uv, np.zeros((1, 17, 1))], -1),
             "maxvals": np.ones((1, 17, 1))}, bbox, 0)
        want, _ = jpp.HeatmapToCoord((64, 48))(
            {"pred_jts": np.concatenate([uv, np.zeros((1, 17, 1))], -1),
             "maxvals": np.ones((1, 17, 1))}, bbox, 0)
        _equal(preds, want)
        gt = np.array(annotations[0]["keypoints"]).reshape(17, 3)[:, :2]
        valid = (np.abs(uv[0]) < 0.5).all(-1)
        np.testing.assert_allclose(preds[0, valid, :2], gt[valid], atol=1e-3)


def test_bench_input_pipeline_smallest(capsys, monkeypatch):
    """One batch of 8 a configuration, from the 8-item RHD tree the bench
    writes: one JSON line each for "full" and "auto", with the JAX tool's
    keys."""
    monkeypatch.setattr(bench_input_pipeline, "RHD_ITEMS", 8)
    monkeypatch.setattr(bench_input_pipeline, "BATCH", 8)
    assert bench_input_pipeline.main(["1", "evaluation", "--demand", "100"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["target_fields"] for line in lines] == ["full", "auto"]
    for line in lines:
        assert {"metric", "target_fields", "imgs_per_sec_per_core", "train_step_demand_imgs_s",
                "cores_needed_per_chip"} <= set(line)
        assert line["imgs_per_sec_per_core"] > 0
        assert line["cores_needed_per_chip"] == pytest.approx(100 / line["imgs_per_sec_per_core"])
