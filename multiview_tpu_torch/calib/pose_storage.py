"""Timestamped pose storage with O(log n) interpolated lookup (the role of
``StampedPoseStorage`` / ``findInterpPose``, dense_map_utils.cc:331-449).
Port of ``multiview_tpu/calib/pose_storage.py``: world poses [7] keyed by
timestamp, queried at any time inside the stored range; the poses are
float64 numpy on the host."""

from __future__ import annotations

import bisect
from typing import List, Optional

import numpy as np
import torch

from multiview_tpu_torch.geometry import pose as pose_mod


class StampedPoseStorage:
    """Sorted timestamp -> pose [7] store with interpolated queries."""

    def __init__(self):
        self._times: List[float] = []
        self._poses: List[np.ndarray] = []

    def add(self, timestamp: float, pose: np.ndarray):
        i = bisect.bisect_left(self._times, timestamp)
        self._times.insert(i, float(timestamp))
        self._poses.insert(i, np.asarray(pose, float))

    def __len__(self):
        return len(self._times)

    def interp_pose(self, desired_time: float) -> Optional[np.ndarray]:
        """Interpolated pose at desired_time; None when out of range
        (findInterpPose semantics: exact hits allowed at the ends)."""
        if not self._times:
            return None
        i = bisect.bisect_right(self._times, desired_time)
        if i == 0:
            if self._times[0] == desired_time:
                return self._poses[0]
            return None
        left = i - 1
        if self._times[left] == desired_time:
            return self._poses[left]
        if i == len(self._times):
            return None
        t0, t1 = self._times[left], self._times[i]
        alpha = (desired_time - t0) / (t1 - t0)
        return pose_mod.pose_interp(alpha, torch.as_tensor(self._poses[left]),
                                    torch.as_tensor(self._poses[i])).numpy()


def max_rotation_angle(pose_a: np.ndarray, pose_b: np.ndarray) -> float:
    """Rotation angle (degrees) between two poses (maxRotationAngle role,
    dense_map_utils.cc:362-373, via the quaternion geodesic)."""
    qa = pose_mod.pose_q(torch.as_tensor(np.asarray(pose_a, float)))
    qb = pose_mod.pose_q(torch.as_tensor(np.asarray(pose_b, float)))
    rel = pose_mod.quat_mul(pose_mod.quat_conj(qa), qb)
    return float(np.degrees(np.linalg.norm(pose_mod.quat_log(rel).numpy())))
