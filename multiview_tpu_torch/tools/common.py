"""Shared helpers for the CLI tools: rig-config -> CameraParams, image
directory scanning (``<images_dir>/<sensor_name>/<timestamp>.<ext>``),
grayscale loading. Port of ``multiview_tpu/tools/common.py``.

``load_gray`` reads binary PGM with numpy alone; other formats go through
imageio when it is installed, and raise a clear error when it is not.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence

import numpy as np
import torch

from multiview_tpu_torch.calib.bracketing import ImageRecord
from multiview_tpu_torch.geometry.camera import CameraParams
from multiview_tpu_torch.io import rig_config as rc
from multiview_tpu_torch.utils.images import read_pgm

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".tif", ".tiff", ".pgm")


def cam_params_from_sensor(s: rc.SensorConfig, dtype=torch.float64,
                           device=None) -> CameraParams:
    return CameraParams.create(
        s.image_size, s.focal_length, s.optical_center, s.distortion,
        undistorted_size=s.undistorted_image_size,
        distorted_crop_size=s.distorted_crop_size, dtype=dtype, device=device)


def load_gray(path) -> np.ndarray:
    """[H,W] float32 grayscale in [0,1] (8-bit sources scaled by 1/255)."""
    path = Path(path)
    if path.suffix.lower() == ".pgm":
        img = read_pgm(path).astype(np.float32)
    else:
        try:
            import imageio.v3 as iio
        except ImportError as e:
            raise RuntimeError(
                f"cannot read {path.name}: reading {path.suffix} images needs imageio, "
                "which is not installed (binary .pgm images need nothing)") from e
        img = np.asarray(iio.imread(path)).astype(np.float32)
    if img.ndim == 3:
        img = img[..., :3].mean(-1)
    if img.max() > 1.5:
        img = img / 255.0
    return img


def scan_image_dir(images_dir, sensor_names: Sequence[str], load: bool = True
                   ) -> List[List[ImageRecord]]:
    """Per-sensor time-sorted ImageRecords; timestamp parsed from the file
    stem (the reference's <sensor>/<timestamp>.ext layout)."""
    images_dir = Path(images_dir)
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
                recs.append(ImageRecord(ts, str(p), load_gray(p) if load else None))
        recs.sort(key=lambda r: r.timestamp)
        out.append(recs)
    return out


def add_sift_args(p):
    """The reference's detector flags (interest_point.cc:51-57)."""
    p.add_argument("--feature_detector", default="SIFT",
                   help="SIFT (DoG + gradient histograms); SURF is not ported yet")
    p.add_argument("--sift_nFeatures", type=int, default=None,
                   help="overrides --max_features when given")
    p.add_argument("--sift_nOctaveLayers", type=int, default=3)
    p.add_argument("--sift_contrastThreshold", type=float, default=None,
                   help="detection-response threshold (default DoG contrast 0.015)")
    p.add_argument("--sift_edgeThreshold", type=float, default=10.0)
    p.add_argument("--sift_sigma", type=float, default=1.6)
    # retrieval and out-of-core matching are not ported: the two switches
    # raise in the tool, and the settings that only they read are ignored
    p.add_argument("--num_nearest_neighbors_for_global_descriptor_matching",
                   type=int, default=0, help="retrieval pair selection (not ported yet)")
    p.add_argument("--num_gmm_clusters_for_fisher_vector", type=int, default=16,
                   help="ignored (retrieval is not ported yet)")
    p.add_argument("--match_out_of_core", action="store_true",
                   help="out-of-core matching (not ported yet)")
    p.add_argument("--matching_working_directory", default=None,
                   help="ignored (out-of-core matching is not ported yet)")
    p.add_argument("--matching_max_num_images_in_cache", type=int, default=128,
                   help="ignored (out-of-core matching is not ported yet)")


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
        num_overlaps=args.num_overlaps)
    kw.update(overrides)
    return FrontendConfig(**kw)
