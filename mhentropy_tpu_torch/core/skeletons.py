"""Skeleton index permutations between hand-keypoint orderings.

A copy of mhentropy_tpu/core/skeletons.py (whose package import pulls in
JAX). These are data constants of the respective datasets, not code;
tests/test_torch_imports.py holds the two copies equal.
"""


import numpy as np

RHD2BIGHAND = np.array(
    [0, 4, 8, 12, 16, 20, 3, 2, 1, 7, 6, 5, 11, 10, 9, 15, 14, 13, 19, 18, 17]
)
MANO2BIGHAND = np.array(
    [0, 13, 1, 4, 10, 7, 14, 15, 16, 2, 3, 17, 5, 6, 18, 11, 12, 19, 8, 9, 20]
)
STB2BIGHAND = np.array(
    [0, 17, 13, 9, 5, 1, 18, 19, 20, 14, 15, 16, 10, 11, 12, 6, 7, 8, 2, 3, 4]
)
FREIHAND2RHD = np.array(
    [0, 4, 3, 2, 1, 8, 7, 6, 5, 12, 11, 10, 9, 16, 15, 14, 13, 20, 19, 18, 17]
)
BIGHAND2RHD = np.array(
    [0, 8, 7, 6, 1, 11, 10, 9, 2, 14, 13, 12, 3, 17, 16, 15, 4, 20, 19, 18, 5]
)
RHD2FREIHAND = np.array(
    [0, 4, 3, 2, 1, 8, 7, 6, 5, 12, 11, 10, 9, 16, 15, 14, 13, 20, 19, 18, 17]
)
BIGHAND2MANO = np.array(
    [0, 2, 9, 10, 3, 12, 13, 5, 18, 19, 4, 15, 16, 1, 6, 7, 8, 11, 14, 17, 20]
)

# MANO's native kinematic joint order (wrist + 15 articulated + 5 fingertips
# appended) -> visualisation order used by manopth (manolayer.py:260).
MANOCHAIN2VIZ = np.array(
    [0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20]
)

# FreiHAND 21-keypoint assembly from (16 regressed joints, 5 mesh fingertips).
# keypoint_id -> regressed-joint index (ManoLayer.py:122-127).
FREIHAND_KP_FROM_REGRESSED = {
    0: 0, 5: 1, 6: 2, 7: 3, 9: 4, 10: 5, 11: 6, 17: 7, 18: 8, 19: 9,
    13: 10, 14: 11, 15: 12, 1: 13, 2: 14, 3: 15,
}
# keypoint_id -> mesh vertex id for fingertips (ManoLayer.py:112-118).
FREIHAND_TIP_VERTS = {4: 744, 8: 320, 12: 443, 16: 555, 20: 672}

# Fingertip vertex ids appended by the MANO kinematic path
# (manopth/manolayer.py:251-253).
MANO_TIPS_RIGHT = np.array([745, 317, 444, 556, 673])
MANO_TIPS_LEFT = np.array([745, 317, 445, 556, 673])

# Dataset-specific root / bone-normalisation joint indices
# (network.py:476-478).
ROOT_IDX = {"rhd": 12, "freihand": 9, "ho3d": 12, "mixed_ho3d_rhd": 12}
NORM_IDX = {"rhd": 11, "freihand": 10, "ho3d": 11, "mixed_ho3d_rhd": 11}
# mixed: both members share RHD joint order (the HO3D loader reorders,
# data/ho3d.py HO3D2RHD), so root/norm indices coincide.


def freihand_gather_indices():
    """Static gathers to assemble the FreiHAND 21-keypoint set.

    Returns:
        (kp_src, tip_ids, tip_verts): ``kp_src[k]`` is the regressed-joint
        index feeding keypoint k (fingertips filled with 0, masked out),
        ``tip_ids`` the 5 fingertip keypoint slots, ``tip_verts`` the mesh
        vertex each fingertip reads.
    """
    kp_src = np.zeros(21, dtype=np.int64)
    for kp, reg in FREIHAND_KP_FROM_REGRESSED.items():
        kp_src[kp] = reg
    tip_ids = np.array(sorted(FREIHAND_TIP_VERTS))
    tip_verts = np.array([FREIHAND_TIP_VERTS[k] for k in tip_ids])
    return kp_src, tip_ids, tip_verts
