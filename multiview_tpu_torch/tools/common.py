"""Shared helpers for the CLI tools: rig-config <-> CameraParams, image
directory scanning (``<images_dir>/<sensor_name>/<timestamp>.<ext>``),
grayscale and colour loading. Port of ``multiview_tpu/tools/common.py``.

``load_gray`` and ``load_color`` read binary PGM and PPM with numpy alone;
other formats go through imageio when it is installed, and raise a clear
error when it is not.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence

import numpy as np
import torch

from multiview_tpu_torch.calib.bracketing import ImageRecord
from multiview_tpu_torch.geometry.camera import CameraParams
from multiview_tpu_torch.io import rig_config as rc
from multiview_tpu_torch.utils.images import read_pgm, read_ppm

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".tif", ".tiff", ".pgm")


def cam_params_from_sensor(s: rc.SensorConfig, dtype=torch.float64,
                           device=None) -> CameraParams:
    """CameraParams of one rig-config sensor; ``device=None`` means the first
    CUDA card (an error when there is none)."""
    return CameraParams.create(
        s.image_size, s.focal_length, s.optical_center, s.distortion,
        undistorted_size=s.undistorted_image_size,
        distorted_crop_size=s.distorted_crop_size, dtype=dtype, device=device)


def sensor_from_cam_params(name: str, cam: CameraParams, ref_to_sensor=None,
                           depth_to_image=None, timestamp_offset=0.0) -> rc.SensorConfig:
    """The rig-config sensor of a camera's intrinsics (the inverse of
    ``cam_params_from_sensor``); 4x4 transforms default to the identity."""
    return rc.SensorConfig(
        name=name,
        focal_length=float(cam.mean_focal),
        optical_center=cam.optical_offset.cpu().numpy(),
        distortion=cam.dist_coeffs.cpu().numpy(),
        image_size=cam.distorted_size,
        distorted_crop_size=cam.distorted_crop_size,
        undistorted_image_size=cam.undistorted_size,
        ref_to_sensor=np.eye(4) if ref_to_sensor is None else ref_to_sensor,
        depth_to_image=np.eye(4) if depth_to_image is None else depth_to_image,
        timestamp_offset=timestamp_offset)


def _read_image(path: Path) -> np.ndarray:
    """A file's pixels as float32: PGM / PPM with numpy, the rest through imageio."""
    if path.suffix.lower() == ".pgm":
        return read_pgm(path).astype(np.float32)
    if path.suffix.lower() == ".ppm":
        return read_ppm(path).astype(np.float32)
    try:
        import imageio.v3 as iio
    except ImportError as e:
        raise RuntimeError(
            f"cannot read {path.name}: reading {path.suffix} images needs imageio, "
            "which is not installed (binary .pgm / .ppm images need nothing)") from e
    return np.asarray(iio.imread(path)).astype(np.float32)


def load_gray(path) -> np.ndarray:
    """[H,W] float32 grayscale in [0,1] (8-bit sources scaled by 1/255)."""
    img = _read_image(Path(path))
    if img.ndim == 3:
        img = img[..., :3].mean(-1)
    if img.max() > 1.5:
        img = img / 255.0
    return img


def load_color(path) -> np.ndarray:
    """[H,W,3] float32 in [0,1]: the texturing path textures in colour like
    the reference (bin/texrecon:108-131,164-173); grayscale sources are
    replicated across the channels."""
    img = _read_image(Path(path))
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    img = img[..., :3]
    if img.max() > 1.5:
        img = img / 255.0
    return img


def scan_image_dir(images_dir, sensor_names: Sequence[str], load: bool = True,
                   color: bool = False) -> List[List[ImageRecord]]:
    """Per-sensor time-sorted ImageRecords; timestamp parsed from the file
    stem (the reference's <sensor>/<timestamp>.ext layout). ``color`` loads
    [H,W,3] images (``load_color``) instead of grayscale."""
    images_dir = Path(images_dir)
    loader = load_color if color else load_gray
    out: List[List[ImageRecord]] = []
    for name in sensor_names:
        recs = []
        d = images_dir / name
        if d.is_dir():
            for p in sorted(d.iterdir()):
                if p.suffix.lower() not in IMAGE_EXTS:
                    continue
                try:
                    ts = float(p.stem)
                except ValueError:
                    continue
                recs.append(ImageRecord(ts, str(p), loader(p) if load else None))
        recs.sort(key=lambda r: r.timestamp)
        out.append(recs)
    return out


def scan_depth_dir(images_dir, sensor_names: Sequence[str]) -> List[List[ImageRecord]]:
    """Per-sensor .pc depth clouds alongside the images; the clouds stay on
    the host as numpy xyz-images."""
    from multiview_tpu_torch.io import depth_io
    images_dir = Path(images_dir)
    out: List[List[ImageRecord]] = []
    for name in sensor_names:
        recs = []
        d = images_dir / name
        if d.is_dir():
            for p in sorted(d.glob("*.pc")):
                try:
                    ts = float(p.stem)
                except ValueError:
                    continue
                recs.append(ImageRecord(ts, str(p), depth_io.read_xyz_image(p)))
        recs.sort(key=lambda r: r.timestamp)
        out.append(recs)
    return out


def add_sift_args(p):
    """The reference's detector flags (interest_point.cc:51-57)."""
    p.add_argument("--feature_detector", default="SIFT",
                   help="SIFT (DoG + gradient histograms) or SURF (determinant of "
                        "Hessian + Haar-style sums)")
    p.add_argument("--sift_nFeatures", type=int, default=None,
                   help="overrides --max_features when given")
    p.add_argument("--sift_nOctaveLayers", type=int, default=3)
    p.add_argument("--sift_contrastThreshold", type=float, default=None,
                   help="detection-response threshold (default DoG contrast 0.015)")
    p.add_argument("--sift_edgeThreshold", type=float, default=10.0)
    p.add_argument("--sift_sigma", type=float, default=1.6)
    p.add_argument("--num_nearest_neighbors_for_global_descriptor_matching",
                   type=int, default=0,
                   help=">0: pick match pairs by global-descriptor (VLAD) retrieval "
                        "instead of temporal --num_overlaps (theia_flags.txt:57-62)")
    p.add_argument("--num_gmm_clusters_for_fisher_vector", type=int, default=16,
                   help="retrieval codebook size (theia_flags.txt:61)")
    p.add_argument("--match_out_of_core", action="store_true",
                   help="spill features to disk and match through an LRU cache "
                        "(theia_flags.txt:30-46)")
    p.add_argument("--matching_working_directory", default=None,
                   help="feature-spill directory for --match_out_of_core")
    p.add_argument("--matching_max_num_images_in_cache", type=int, default=128,
                   help="images kept in memory with --match_out_of_core")


def frontend_config_from_args(args, **overrides):
    """FrontendConfig from the shared CLI flags (+ per-tool overrides)."""
    from multiview_tpu_torch.sfm.pipeline import FrontendConfig

    kw = dict(
        max_features=args.sift_nFeatures or args.max_features,
        num_scales=args.sift_nOctaveLayers,
        sigma0=args.sift_sigma,
        feature_detector=args.feature_detector.lower(),
        contrast_threshold=args.sift_contrastThreshold,
        edge_threshold=args.sift_edgeThreshold,
        num_overlaps=args.num_overlaps,
        retrieval_neighbors=args.num_nearest_neighbors_for_global_descriptor_matching,
        retrieval_clusters=args.num_gmm_clusters_for_fisher_vector,
        match_out_of_core=args.match_out_of_core,
        matching_working_directory=args.matching_working_directory,
        matching_max_num_images_in_cache=args.matching_max_num_images_in_cache)
    kw.update(overrides)
    return FrontendConfig(**kw)
