"""``undistort`` tool: undistort images through a sensor's model and write
the undistorted intrinsics (the undistort_image_texrecon role). Port of
``multiview_tpu/tools/undistort_tool.py`` with the same flags (image lists,
output lists, crop window, scale, color output, histogram equalization).

Runs on the first CUDA card (float32) and raises when there is none;
``--device cpu`` asks for the CPU (float64). Binary PGM / PPM images are read
and written with numpy alone; other formats need imageio.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

_PNM = (".pgm", ".ppm", ".pnm")


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--rig_config", required=True)
    p.add_argument("--sensor", "--rig_sensor", dest="sensor", required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to compute: the first CUDA card (float32; an error "
                        "when there is none) or the CPU (float64)")
    p.add_argument("--images", nargs="+", default=None)
    p.add_argument("--image_list", default=None,
                   help="file listing images to undistort, one per line "
                        "(undistort_image_texrecon.cc:54-56)")
    p.add_argument("--output_list", default=None,
                   help="file listing the output names, one per input line")
    p.add_argument("--out_dir", default=None,
                   help="output directory (ignored with --output_list)")
    p.add_argument("--crop_width", type=int, default=0)
    p.add_argument("--crop_height", type=int, default=0)
    p.add_argument("--undistorted_crop_win", default="",
                   help="'w h' central crop of the undistorted image "
                        "(:65-69); overrides --crop_width/--crop_height")
    p.add_argument("--scale", type=float, default=1.0,
                   help="undistort at width = original width * scale (:62-64)")
    p.add_argument("--save_bgr", action="store_true",
                   help="keep 3 color channels in the output (:71-73)")
    p.add_argument("--histogram_equalization", action="store_true")
    p.add_argument("--undistorted_intrinsics", default=None,
                   help="path for the undistorted-intrinsics file (:60)")


def _hist_equalize(img: np.ndarray) -> np.ndarray:
    """Global histogram equalization of a float [0,1] image (per channel)."""
    def eq(ch):
        u8 = np.clip(ch * 255.0, 0, 255).astype(np.uint8)
        hist = np.bincount(u8.ravel(), minlength=256).astype(np.float64)
        cdf = hist.cumsum()
        nonzero = cdf[cdf > 0]
        if len(nonzero) == 0:
            return ch
        cdf = (cdf - nonzero[0]) / max(cdf[-1] - nonzero[0], 1.0)
        return cdf[u8].astype(np.float32)

    if img.ndim == 2:
        return eq(img)
    return np.stack([eq(img[..., c]) for c in range(img.shape[-1])], -1)


def _imageio(path, what):
    try:
        import imageio.v3 as iio
    except ImportError as e:
        raise RuntimeError(f"cannot {what} {Path(path).name}: {Path(path).suffix} images need "
                           "imageio, which is not installed (binary .pgm / .ppm need "
                           "nothing)") from e
    return iio


def load_color(path) -> np.ndarray:
    """[H,W,3] float32 in [0,1] (8-bit sources scaled by 1/255); a gray
    image is repeated over the three channels."""
    from multiview_tpu_torch.utils.images import read_pgm, read_ppm
    suffix = Path(path).suffix.lower()
    if suffix in _PNM:
        with open(path, "rb") as f:
            magic = f.read(2)
        img = read_ppm(path) if magic == b"P6" else read_pgm(path)
    else:
        img = _imageio(path, "read").imread(path)
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    img = img[..., :3]
    if img.max() > 1.5:  # the guarded normalization of load_gray
        img = img / 255.0
    return img


def save_u8(path, img: np.ndarray) -> None:
    """Write a [H,W] or [H,W,3] uint8 image: binary PGM / PPM for .pgm,
    .ppm and .pnm names, imageio for the rest."""
    from multiview_tpu_torch.utils.images import write_pgm, write_ppm
    if Path(path).suffix.lower() in _PNM:
        (write_pgm if img.ndim == 2 else write_ppm)(path, img)
    else:
        _imageio(path, "write").imwrite(path, img)


def run(args):
    import torch

    from multiview_tpu_torch.io import rig_config as rc
    from multiview_tpu_torch.tools import common
    from multiview_tpu_torch.utils import undistort as und
    from multiview_tpu_torch.utils.device import resolve_device, working_dtype

    device = resolve_device(args.device)
    rig = rc.read_rig_config(args.rig_config)
    s = rig.sensors[rig.sensor_index(args.sensor)]
    cam = common.cam_params_from_sensor(s, dtype=working_dtype(device), device=device)

    images = list(args.images or [])
    if args.image_list:
        images += [ln.strip() for ln in Path(args.image_list).read_text().splitlines()
                   if ln.strip()]
    if not images:
        raise SystemExit("Provide --images or --image_list")
    outputs = None
    if args.output_list:
        outputs = [ln.strip() for ln in Path(args.output_list).read_text().splitlines()
                   if ln.strip()]
        if len(outputs) != len(images):
            raise SystemExit("--output_list length must match the image count")
    elif not args.out_dir:
        raise SystemExit("Provide --out_dir or --output_list")

    if args.undistorted_crop_win:
        cw, ch = (int(v) for v in args.undistorted_crop_win.split())
        crop = (cw, ch)
    elif args.crop_width and args.crop_height:
        crop = (args.crop_width, args.crop_height)
    else:
        crop = None

    out = Path(args.out_dir) if args.out_dir else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
    exp_cols = int(round(args.scale * cam.distorted_size[0]))
    exp_rows = int(round(args.scale * cam.distorted_size[1]))
    K = None
    out_size = None
    for idx, img_path in enumerate(images):
        img = load_color(img_path) if args.save_bgr else common.load_gray(img_path)
        if img.shape[0] != exp_rows or img.shape[1] != exp_cols:
            raise SystemExit(
                f"The input image {img_path} has wrong dimensions "
                f"{img.shape[1]}x{img.shape[0]}; expected {exp_cols}x{exp_rows}"
                " (= scale * calibrated distorted size, "
                "undistort_image_texrecon.cc:298-301)")
        if args.histogram_equalization:
            # on the distorted input, like cv::equalizeHist in the reference
            img = _hist_equalize(img)
        u, K = und.undistort_image(torch.as_tensor(img, device=device), cam,
                                   crop_window=crop, scale=args.scale)
        u = u.cpu().numpy()
        out_size = (u.shape[1], u.shape[0])
        dst = Path(outputs[idx]) if outputs else out / Path(img_path).name
        dst.parent.mkdir(parents=True, exist_ok=True)
        save_u8(dst, (np.clip(u, 0, 1) * 255).astype(np.uint8))
        print(f"Writing: {dst}")

    if args.undistorted_intrinsics or out is not None:
        # no intrinsics file unless a destination is explicit
        # (undistort_image_texrecon.cc:357-367)
        intr_path = (Path(args.undistorted_intrinsics) if args.undistorted_intrinsics
                     else out / "undistorted_intrinsics.txt")
        intr_path.parent.mkdir(parents=True, exist_ok=True)
        with open(intr_path, "w") as f:
            f.write("# undistorted camera intrinsics: width height focal cx cy\n")
            w, h = out_size
            f.write(f"{w} {h} {float(K[0, 0])!r} {float(K[0, 2])!r} {float(K[1, 2])!r}\n")
        print(f"Writing: {intr_path}")
    return 0
