"""rig_config.txt read/write, byte-format compatible with the reference
(`rig_calibrator/src/dense_map_utils.cc:779-1057`): per-sensor
focal/optical-center/distortion(+type)/image sizes/ref_to_sensor_transform/
depth_to_image_transform/timestamp offset; the reference sensor must be
sensor 0. Interop with the reference toolchain = testability.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List

import numpy as np

from multiview_tpu_torch.geometry.distortion import model_from_num_coeffs

# dense_map_utils.h:58-61
DISTORTION_TYPE_NAMES = {
    "none": "no_distortion",
    "fov": "fisheye",
    "tsai": "radtan",
    "rpc": "rpc",
}
MODEL_FROM_TYPE_NAME = {v: k for k, v in DISTORTION_TYPE_NAMES.items()}


@dataclasses.dataclass
class SensorConfig:
    name: str
    focal_length: float
    optical_center: np.ndarray          # [2]
    distortion: np.ndarray              # [d]
    image_size: tuple                   # (w, h)
    distorted_crop_size: tuple
    undistorted_image_size: tuple
    ref_to_sensor: np.ndarray           # [4,4] affine (world of ref -> sensor)
    depth_to_image: np.ndarray          # [4,4]
    timestamp_offset: float = 0.0

    @property
    def model(self) -> str:
        return model_from_num_coeffs(len(self.distortion))


@dataclasses.dataclass
class RigConfig:
    sensors: List[SensorConfig]

    @property
    def ref_sensor_name(self) -> str:
        return self.sensors[0].name


def _affine_to_str(M: np.ndarray) -> str:
    """Row-major linear part then translation, 17 significant digits
    (affineToStr, transform_utils.cc:30-40)."""
    T = np.asarray(M, float)
    vals = [T[0, 0], T[0, 1], T[0, 2], T[1, 0], T[1, 1], T[1, 2],
            T[2, 0], T[2, 1], T[2, 2], T[0, 3], T[1, 3], T[2, 3]]
    return " ".join(repr(float(v)) for v in vals)


def _vec_to_affine(vals) -> np.ndarray:
    """12 values -> 4x4 (vecToAffine, transform_utils.cc:44-72)."""
    v = np.asarray(vals, float)
    if v.size != 12:
        raise ValueError("An affine transform must have 12 parameters.")
    M = np.eye(4)
    M[0, :3] = v[0:3]
    M[1, :3] = v[3:6]
    M[2, :3] = v[6:9]
    M[:3, 3] = v[9:12]
    return M


def write_rig_config(path, rig: RigConfig, model_rig: bool = True):
    """Mirror of writeRigConfig (dense_map_utils.cc:779-850)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write(f"ref_sensor_name: {rig.ref_sensor_name}\n")
        for i, s in enumerate(rig.sensors):
            f.write("\n")
            f.write(f"sensor_name: {s.name}\n")
            f.write(f"focal_length: {float(s.focal_length)!r}\n")
            f.write(f"optical_center: {float(s.optical_center[0])!r} "
                    f"{float(s.optical_center[1])!r}\n")
            f.write("distortion_coeffs: "
                    + " ".join(repr(float(d)) for d in s.distortion) + "\n")
            f.write(f"distortion_type: {DISTORTION_TYPE_NAMES[s.model]}\n")
            f.write(f"image_size: {s.image_size[0]} {s.image_size[1]}\n")
            f.write(f"distorted_crop_size: {s.distorted_crop_size[0]} "
                    f"{s.distorted_crop_size[1]}\n")
            f.write(f"undistorted_image_size: {s.undistorted_image_size[0]} "
                    f"{s.undistorted_image_size[1]}\n")
            T = s.ref_to_sensor if model_rig else np.eye(4)
            f.write(f"ref_to_sensor_transform: {_affine_to_str(T)}\n")
            f.write(f"depth_to_image_transform: {_affine_to_str(s.depth_to_image)}\n")
            f.write(f"ref_to_sensor_timestamp_offset: {float(s.timestamp_offset)!r}\n")


def _read_tagged(lines, pos, tag, count=None):
    """readConfigVals semantics (dense_map_utils.cc:855-936): skip comments
    and blanks, demand the tag, return the values after it."""
    while pos < len(lines):
        line = lines[pos].split("#")[0].strip()
        pos += 1
        if not line:
            continue
        parts = line.split()
        if parts[0] != tag:
            raise ValueError(f"Could not read value for: {tag} (got {parts[0]})")
        vals = parts[1:]
        if count is not None and len(vals) != count:
            raise ValueError(f"Read an incorrect number of values for: {tag}")
        return vals, pos
    raise EOFError(f"Could not read value for: {tag}")


def read_rig_config(path) -> RigConfig:
    """Mirror of readRigConfig (dense_map_utils.cc:940-1057)."""
    lines = Path(path).read_text().splitlines()
    pos = 0
    (ref_name,), pos = _read_tagged(lines, pos, "ref_sensor_name:", 1)

    sensors = []
    while True:
        try:
            (name,), pos = _read_tagged(lines, pos, "sensor_name:", 1)
        except (EOFError, ValueError):
            break
        if (len(sensors) == 0 and name != ref_name) or \
           (len(sensors) != 0 and name == ref_name):
            raise ValueError("The reference sensor must be the first sensor "
                             "specified in the rig configuration.")
        (fl,), pos = _read_tagged(lines, pos, "focal_length:", 1)
        oc, pos = _read_tagged(lines, pos, "optical_center:", 2)
        dist, pos = _read_tagged(lines, pos, "distortion_coeffs:")
        (dtype_name,), pos = _read_tagged(lines, pos, "distortion_type:", 1)
        dist = np.asarray([float(d) for d in dist])
        expect = DISTORTION_TYPE_NAMES[model_from_num_coeffs(len(dist))] \
            if len(dist) != 0 or dtype_name != "no_distortion" else "no_distortion"
        if len(dist) == 0:
            expect = "no_distortion"
        if dtype_name != expect:
            raise ValueError(f"distortion type {dtype_name} does not match "
                             f"{len(dist)} coefficients")
        isz, pos = _read_tagged(lines, pos, "image_size:", 2)
        csz, pos = _read_tagged(lines, pos, "distorted_crop_size:", 2)
        usz, pos = _read_tagged(lines, pos, "undistorted_image_size:", 2)
        r2s, pos = _read_tagged(lines, pos, "ref_to_sensor_transform:", 12)
        d2i, pos = _read_tagged(lines, pos, "depth_to_image_transform:", 12)
        (toff,), pos = _read_tagged(lines, pos, "ref_to_sensor_timestamp_offset:", 1)

        sensors.append(SensorConfig(
            name=name,
            focal_length=float(fl),
            optical_center=np.asarray([float(v) for v in oc]),
            distortion=dist,
            image_size=tuple(int(float(v)) for v in isz),
            distorted_crop_size=tuple(int(float(v)) for v in csz),
            undistorted_image_size=tuple(int(float(v)) for v in usz),
            ref_to_sensor=_vec_to_affine([float(v) for v in r2s]),
            depth_to_image=_vec_to_affine([float(v) for v in d2i]),
            timestamp_offset=float(toff)))

    if not sensors:
        raise ValueError(f"No sensors found in {path}")
    return RigConfig(sensors=sensors)
