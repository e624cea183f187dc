"""Problem assembly: rig config + bracketed camera entries + tracks ->
RigState + Observations. Port of ``multiview_tpu/calib/assemble.py`` (the
glue of rig_calibrator.cc main, :1269-1550): ref timestamps/poses from the
bracketed entries, rig transforms and intrinsics from the rig config, track
rows bucketed per sensor into observation tensors with pre-differenced
timestamps. Host bookkeeping is numpy; the tensors land on ``device``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from multiview_tpu_torch.calib import problem as prob
from multiview_tpu_torch.calib.bracketing import CameraEntry
from multiview_tpu_torch.geometry import pose as pose_mod
from multiview_tpu_torch.io import rig_config as rc
from multiview_tpu_torch.sfm.tracks import TrackSet


def affine_to_pose(M: np.ndarray) -> np.ndarray:
    """4x4 (or 3x4) affine -> [7] pose (float64, host)."""
    return pose_mod.matrix_to_pose(torch.as_tensor(np.asarray(M, np.float64))).numpy()


def _unit_scale(M: np.ndarray) -> Tuple[np.ndarray, float]:
    """Split an affine with uniform scale into (rigid 4x4, scale)."""
    M = np.asarray(M, float)
    scale = np.linalg.det(M[:3, :3]) ** (1.0 / 3.0)
    out = M.copy()
    if scale > 0:
        out[:3, :3] = M[:3, :3] / scale
    else:
        scale = 1.0
    return out, float(scale)


def build_state(rig: rc.RigConfig, cams: Sequence[CameraEntry],
                world_to_cam: np.ndarray, ref_timestamps: np.ndarray,
                world_to_ref: np.ndarray, num_points: int,
                no_rig: bool = False, affine_depth: bool = False,
                dtype=torch.float64, device=None) -> prob.RigState:
    """RigState from config + poses. In no-rig mode world_to_ref holds one
    pose per entry (= world_to_cam). The depth-to-image scale is separated
    as det^(1/3) (rig_calibrator.cc:1447-1457)."""
    rig_poses = np.stack([affine_to_pose(s.ref_to_sensor) for s in rig.sensors])
    if affine_depth:
        d2i = np.stack([
            np.concatenate([_unit_scale(s.depth_to_image)[0][:3, :3].reshape(9),
                            np.asarray(s.depth_to_image, float)[:3, 3]])
            for s in rig.sensors])
    else:
        d2i = np.stack([affine_to_pose(_unit_scale(s.depth_to_image)[0])
                        for s in rig.sensors])
    d2i_scale = np.asarray([_unit_scale(s.depth_to_image)[1] for s in rig.sensors])

    def t(x):
        return torch.as_tensor(np.array(x, np.float64), dtype=dtype, device=device)

    return prob.RigState(
        world_to_ref=t(world_to_cam if no_rig else world_to_ref),
        ref_to_cam=t(rig_poses),
        timestamp_offsets=t([s.timestamp_offset for s in rig.sensors]),
        focal=t([s.focal_length for s in rig.sensors]),
        optical_center=t(np.stack([s.optical_center for s in rig.sensors])),
        dist=tuple(t(s.distortion) for s in rig.sensors),
        depth_to_image=t(d2i),
        depth_scale=t(d2i_scale),
        points=torch.zeros((num_points, 3), dtype=dtype, device=device),
    )


def build_observations(rig: rc.RigConfig, cams: Sequence[CameraEntry],
                       ref_timestamps: np.ndarray, trackset: TrackSet,
                       no_rig: bool = False, dtype=torch.float64, device=None
                       ) -> Tuple[prob.Observations, int]:
    """Tracks -> per-sensor PixelObs with bracketing indices and
    pre-differenced timestamps. Returns (observations, num_points)."""
    S = len(rig.sensors)
    rows: Dict[int, Dict[str, list]] = {
        s: dict(pix=[], beg=[], end=[], pid=[], dtc=[], dtb=[]) for s in range(S)}
    for pid, track in enumerate(trackset.tracks):
        for cid, fid in track.items():
            cam = cams[cid]
            s = cam.camera_type
            if no_rig:
                beg = end = cid
                dtc = dtb = 0.0
            else:
                beg, end = cam.beg_ref_index, cam.end_ref_index
                dtc = cam.timestamp - ref_timestamps[beg]
                dtb = ref_timestamps[end] - ref_timestamps[beg]
            r = rows[s]
            r["pix"].append(trackset.keypoints[cid][fid])
            r["beg"].append(beg)
            r["end"].append(end)
            r["pid"].append(pid)
            r["dtc"].append(dtc)
            r["dtb"].append(dtb)

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    def i(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    pixel_obs = []
    for s in range(S):
        r = rows[s]
        if not r["pix"]:
            continue
        half = np.asarray(rig.sensors[s].image_size, float) / 2.0
        pixel_obs.append(prob.PixelObs(
            pix=f(np.stack(r["pix"])), beg_idx=i(r["beg"]), end_idx=i(r["end"]),
            point_idx=i(r["pid"]), dt_cam=f(r["dtc"]), dt_bracket=f(r["dtb"]),
            mask=torch.ones(len(r["pix"]), dtype=torch.bool, device=device),
            dist_half_size=f(half), sensor=s))
    return prob.Observations(pixels=tuple(pixel_obs)), len(trackset.tracks)


def ref_data_from_entries(cams: Sequence[CameraEntry], world_to_cam: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray, Dict[int, int]]:
    """(ref_timestamps, world_to_ref [R,7], entry->ref-index map) from the
    reference-sensor entries (world_to_cam: [N,7] per entry), indexed by the
    entries' position in the ref stream."""
    ref_rows = [i for i, c in enumerate(cams) if c.camera_type == 0]
    ref_rows.sort(key=lambda i: cams[i].beg_ref_index)
    n_ref = max(c.end_ref_index for c in cams) + 1
    world_to_ref = np.tile(np.asarray([0, 0, 0, 0, 0, 0, 1.0]), (n_ref, 1))
    ref_stamps = np.zeros(n_ref)
    for i in ref_rows:
        idx = cams[i].beg_ref_index
        world_to_ref[idx] = world_to_cam[i]
        ref_stamps[idx] = cams[i].timestamp
    return ref_stamps, world_to_ref, {i: cams[i].beg_ref_index for i in ref_rows}
