"""Time-sync core: image lookup and ref-camera bracketing.

Host-side (numpy) re-implementation of the reference's bracketing machinery
(`rig_calibrator/src/dense_map_utils.cc:702-739,1441-1805`)
with exact parity on the edge cases that decide which images enter the
problem at all: the nextafter adjustment for an equal final timestamp, the
closest-to-bracket-midpoint selection, best_time == beg_timestamp admission,
the bracket_len gate, and the derived legal [min,max] bounds for floatable
timestamp offsets (with the 1e-5 precision-loss tightening).

This is inherently sequential/irregular logic over small lists — host code
by design; the arrays it produces feed the batched residual kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class ImageRecord:
    """One timestamped image (ImageMessage analogue, camera_image.h:28-47)."""

    timestamp: float
    name: str = ""
    payload: Any = None  # image array or None


@dataclasses.dataclass
class CameraEntry:
    """One selected camera sample (dense_map::cameraImage, camera_image.h:49-70)."""

    camera_type: int
    timestamp: float          # in this sensor's clock
    ref_timestamp: float      # timestamp - ref_to_cam_offset
    beg_ref_index: int
    end_ref_index: int
    image_name: str = ""
    image: Any = None
    depth_name: str = ""
    depth_cloud: Any = None
    cloud_timestamp: float = -1.0


def lookup_image(desired_time: float, msgs: Sequence[ImageRecord], start_pos: int
                 ) -> Tuple[Optional[int], int, float]:
    """Find the first record at/after desired_time scanning forward from
    start_pos (lookupImage, dense_map_utils.cc:702-739).
    Returns (index or None, new_start_pos, found_time)."""
    prev_time = -1.0
    found_time = -1.0
    pos = start_pos
    for local_pos in range(start_pos, len(msgs)):
        pos = local_pos
        found_time = msgs[local_pos].timestamp
        if found_time < prev_time:
            raise ValueError("Found images not in chronological order.")
        prev_time = found_time
        if found_time >= desired_time:
            return local_pos, pos, found_time
    return None, pos, found_time


def lookup_images_and_brackets(
    ref_timestamps: Sequence[float],
    image_data: Sequence[Sequence[ImageRecord]],   # per sensor, time-sorted
    depth_data: Sequence[Sequence[ImageRecord]],   # per sensor (may be empty lists)
    ref_to_cam_timestamp_offsets: Sequence[float],
    bracket_len: float = 0.6,
    timestamp_offsets_max_change: float = 1.0,
) -> Tuple[List[CameraEntry], np.ndarray, np.ndarray]:
    """lookupImagesAndBrackets parity (dense_map_utils.cc:1441-1658).

    Every non-ref image must fall inside [beg_ref+offset, end_ref+offset);
    among candidates the one closest to the bracket midpoint wins; brackets
    longer than bracket_len only admit best_time == beg_timestamp.
    Returns (cams, min_timestamp_offset [S], max_timestamp_offset [S]).
    """
    num_ref = len(ref_timestamps)
    S = len(image_data)
    cams: List[CameraEntry] = []
    min_off = np.full(S, -1.0e100)
    max_off = np.full(S, 1.0e100)

    image_start = [0] * S
    cloud_start = [0] * S

    for beg_ref_it in range(num_ref):
        end_ref_it = beg_ref_it + 1
        last_timestamp = end_ref_it == num_ref
        if last_timestamp:
            end_ref_it = beg_ref_it

        for cam_type in range(S):
            cam: Optional[CameraEntry] = None

            if cam_type == 0:  # ref sensor: exact-time lookup
                t = ref_timestamps[beg_ref_it]
                idx, image_start[cam_type], found = lookup_image(
                    t, image_data[cam_type], image_start[cam_type])
                if idx is None or found != t:
                    raise ValueError(f"Cannot look up camera at time {t!r}.")
                rec = image_data[cam_type][idx]
                cam = CameraEntry(cam_type, t, t, beg_ref_it, beg_ref_it,
                                  rec.name, rec.payload)
            else:
                offset = ref_to_cam_timestamp_offsets[cam_type]
                beg_t = ref_timestamps[beg_ref_it] + offset
                end_t = ref_timestamps[end_ref_it] + offset
                if end_t == beg_t and last_timestamp:
                    end_t = math.nextafter(end_t, end_t + 1.0)
                if end_t <= beg_t:
                    raise ValueError("Ref timestamps must be in strictly "
                                     "increasing order.")
                mid_t = (beg_t + end_t) / 2.0

                start_pos = image_start[cam_type]
                curr_t = beg_t
                best_dist = 1.0e100
                best_time = -1.0
                best_rec: Optional[ImageRecord] = None
                found = -1.0
                while True:
                    if found > end_t:
                        break
                    idx, start_pos, found = lookup_image(
                        curr_t, image_data[cam_type], start_pos)
                    if idx is None:
                        break
                    in_bracket = beg_t <= found < end_t
                    curr_dist = abs(found - mid_t)
                    if curr_dist < best_dist and in_bracket:
                        best_dist = curr_dist
                        best_time = found
                        image_start[cam_type] = start_pos
                        best_rec = image_data[cam_type][idx]
                    curr_t = math.nextafter(found, found + 1.0)

                if best_time < 0.0:
                    continue
                if best_time > beg_t and end_t - beg_t > bracket_len:
                    continue
                if best_time < beg_t or best_time >= end_t:
                    continue

                cam = CameraEntry(cam_type, best_time, best_time - offset,
                                  beg_ref_it, end_ref_it,
                                  best_rec.name, best_rec.payload)

            if cam is None:
                continue

            if cam_type != 0:
                min_off[cam_type] = max(
                    min_off[cam_type], cam.timestamp - ref_timestamps[cam.end_ref_index])
                max_off[cam_type] = min(
                    max_off[cam_type], cam.timestamp - ref_timestamps[cam.beg_ref_index])

            if depth_data and len(depth_data[cam_type]) > 0:
                didx, cloud_start[cam_type], dfound = lookup_image(
                    cam.timestamp, depth_data[cam_type], cloud_start[cam_type])
                if didx is not None:
                    rec = depth_data[cam_type][didx]
                    cam.depth_name = rec.name
                    cam.depth_cloud = rec.payload
                    cam.cloud_timestamp = dfound

            cams.append(cam)

    # adjust bounds for timestamp_offsets_max_change + precision tightening
    for cam_type in range(1, S):
        off = ref_to_cam_timestamp_offsets[cam_type]
        min_off[cam_type] = max(min_off[cam_type], off - timestamp_offsets_max_change)
        max_off[cam_type] = min(max_off[cam_type], off + timestamp_offsets_max_change)
        min_off[cam_type] += 1.0e-5
        max_off[cam_type] -= 1.0e-5

    return cams, min_off, max_off


def lookup_images_no_brackets(
    image_data: Sequence[Sequence[ImageRecord]],
    depth_data: Sequence[Sequence[ImageRecord]],
) -> Tuple[List[CameraEntry], np.ndarray, np.ndarray]:
    """lookupImagesNoBrackets parity (dense_map_utils.cc:1664-1741): every
    image of every sensor is its own camera."""
    S = len(image_data)
    cams: List[CameraEntry] = []
    cloud_start = [0] * S
    for cam_type in range(S):
        for cam_it, rec in enumerate(image_data[cam_type]):
            cam = CameraEntry(cam_type, rec.timestamp, rec.timestamp,
                              cam_it, cam_it, rec.name, rec.payload)
            if depth_data and len(depth_data[cam_type]) > 0:
                didx, cloud_start[cam_type], dfound = lookup_image(
                    cam.timestamp, depth_data[cam_type], cloud_start[cam_type])
                if didx is not None:
                    drec = depth_data[cam_type][didx]
                    cam.depth_name = drec.name
                    cam.depth_cloud = drec.payload
                    cam.cloud_timestamp = dfound
            cams.append(cam)
    return cams, np.full(S, -1.0e100), np.full(S, 1.0e100)


def lookup_images(
    no_rig: bool,
    ref_timestamps: Sequence[float],
    image_data: Sequence[Sequence[ImageRecord]],
    depth_data: Sequence[Sequence[ImageRecord]],
    ref_to_cam_timestamp_offsets: Sequence[float],
    bracket_len: float = 0.6,
    timestamp_offsets_max_change: float = 1.0,
    verbose: bool = False,
) -> Tuple[List[CameraEntry], np.ndarray, np.ndarray]:
    """lookupImages parity (dense_map_utils.cc:1745-1805): dispatch, per-sensor
    counting, and the final sort by ref-clock timestamp (timestampLess)."""
    if not no_rig:
        cams, min_off, max_off = lookup_images_and_brackets(
            ref_timestamps, image_data, depth_data, ref_to_cam_timestamp_offsets,
            bracket_len, timestamp_offsets_max_change)
    else:
        cams, min_off, max_off = lookup_images_no_brackets(image_data, depth_data)

    counts = {s: 0 for s in range(len(image_data))}
    for c in cams:
        counts[c.camera_type] += 1
    if verbose:
        for s, n in counts.items():
            print(f"Number of images for sensor {s}: {n}")
    if any(n == 0 for n in counts.values()):
        raise ValueError("Could not find images for all sensors. Cannot continue.")

    cams.sort(key=lambda c: c.ref_timestamp)  # timestampLess (dense_map_utils.cc:1394)
    return cams, min_off, max_off
