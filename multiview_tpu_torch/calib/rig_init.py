"""Rig initialization and rig-based pose computation. Port of
``multiview_tpu/calib/rig_init.py`` (rig_calibrator.cc:792-867,1190-1265):

- world->cam for every entry from rig transforms + bracketed interpolation
  (calc_world_to_cam_using_rig);
- initial rig transforms as the per-entry median of
  world_to_cam * interp(world_to_ref)^-1, renormalized to a rotation
  (calc_rig_using_word_to_cam).

Small host-side problems: computed in float64 on the CPU.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from multiview_tpu_torch.calib.bracketing import CameraEntry
from multiview_tpu_torch.geometry import pose as pose_mod


def _f64(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def calc_world_to_cam_using_rig(cams: Sequence[CameraEntry],
                                world_to_ref: np.ndarray,
                                ref_timestamps: np.ndarray,
                                ref_to_cam: np.ndarray,
                                ref_to_cam_timestamp_offsets: np.ndarray) -> np.ndarray:
    """[N,7] world->cam poses of every entry (calc_world_to_cam_using_rig,
    rig_calibrator.cc:792-820)."""
    beg_i = np.asarray([c.beg_ref_index for c in cams])
    end_i = np.asarray([c.end_ref_index for c in cams])
    sensor = np.asarray([c.camera_type for c in cams])
    ts = np.asarray([c.timestamp for c in cams])
    ref_ts = np.asarray(ref_timestamps)
    w2r = np.asarray(world_to_ref)
    out = pose_mod.world_to_cam_from_bracket(
        _f64(w2r[beg_i]), _f64(w2r[end_i]), _f64(np.asarray(ref_to_cam)[sensor]),
        _f64(ts - ref_ts[beg_i]), _f64(ref_ts[end_i] - ref_ts[beg_i]),
        _f64(np.asarray(ref_to_cam_timestamp_offsets)[sensor]))
    return out.numpy()


def calc_rig_using_world_to_cam(num_sensors: int,
                                cams: Sequence[CameraEntry],
                                world_to_ref: np.ndarray,
                                world_to_cam: np.ndarray,
                                ref_timestamps: np.ndarray,
                                ref_to_cam_timestamp_offsets: np.ndarray) -> np.ndarray:
    """Initial rig: per-sensor median of world_to_cam[i] *
    interp(world_to_ref at t_i)^-1, projected onto SE(3) -> [S,7]."""
    n = len(cams)
    sensor = np.asarray([c.camera_type for c in cams])
    beg_i = np.asarray([c.beg_ref_index for c in cams])
    end_i = np.asarray([c.end_ref_index for c in cams])
    ts = np.asarray([c.timestamp for c in cams])
    ref_ts = np.asarray(ref_timestamps)
    offs = np.asarray(ref_to_cam_timestamp_offsets)[sensor]
    w2r = np.asarray(world_to_ref)

    interp = pose_mod.interp_world_to_ref(
        _f64(w2r[beg_i]), _f64(w2r[end_i]), _f64(ts - ref_ts[beg_i]),
        _f64(ref_ts[end_i] - ref_ts[beg_i]), _f64(offs))
    M_all = pose_mod.pose_to_matrix(
        torch.cat([interp, _f64(world_to_cam)])).numpy()
    M_interp, M_cam = M_all[:n], M_all[n:]
    rel = M_cam @ np.linalg.inv(M_interp)
    rel[sensor == 0] = np.eye(4)

    meds = []
    for s in range(num_sensors):
        stack = rel[sensor == s]
        if stack.shape[0] == 0:
            raise ValueError(f"No poses were found for rig sensor with id: {s}")
        med = np.median(stack, axis=0)
        L = med[:3, :3]
        det = np.linalg.det(L)
        if det <= 0:
            raise ValueError(f"Degenerate median rig transform for sensor {s}")
        L = L / det ** (1.0 / 3.0)
        U, _, Vt = np.linalg.svd(L)
        R = U @ Vt
        if np.linalg.det(R) < 0:
            R = U @ np.diag([1.0, 1.0, -1.0]) @ Vt
        M = np.eye(4)
        M[:3, :3] = R
        M[:3, 3] = med[:3, 3]
        meds.append(M)
    return pose_mod.matrix_to_pose(_f64(np.stack(meds))).numpy()
