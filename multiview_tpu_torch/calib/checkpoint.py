"""Checkpoint/resume of the BA state. Port of
``multiview_tpu/calib/checkpoint.py``: the full optimization state
(RigState, inlier masks, pass index) is written after each pass, so a killed
calibration resumes mid-run; the optimizer's monotone outlier masks make a
resumed run continue exactly.

Files per pass: ``state_<pass>.npz`` (the RigState fields, distortion
vectors as ``dist_<sensor>``), ``masks_<pass>.npz`` (``pix_<sensor>``,
``depth_<sensor>``) and ``latest.json`` ({"pass": n}).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from multiview_tpu_torch.calib import problem as prob
from multiview_tpu_torch.parallel import sharding as sh


def save_checkpoint(ckpt_dir, state: prob.RigState, observations: prob.Observations,
                    pass_index: int):
    """Write the checkpoint of one finished pass."""
    ckpt_dir = Path(ckpt_dir).resolve()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    arrays = prob.to_numpy(state)
    dist = arrays.pop("dist")
    arrays.update({f"dist_{i}": d for i, d in enumerate(dist)})
    np.savez(ckpt_dir / f"state_{pass_index}.npz", **arrays)
    masks = {f"pix_{o.sensor}": o.mask.cpu().numpy() for o in sh.gathered_pixels(observations)}
    masks.update({f"depth_{o.sensor}": o.mask.cpu().numpy() for o in observations.depths})
    np.savez(ckpt_dir / f"masks_{pass_index}.npz", **masks)
    (ckpt_dir / "latest.json").write_text(json.dumps({"pass": pass_index}))


def latest_pass(ckpt_dir) -> Optional[int]:
    f = Path(ckpt_dir) / "latest.json"
    if not f.exists():
        return None
    return int(json.loads(f.read_text())["pass"])


def load_checkpoint(ckpt_dir, template_state: prob.RigState,
                    observations: prob.Observations, pass_index: Optional[int] = None
                    ) -> Tuple[prob.RigState, prob.Observations, int]:
    """Restore (state, observations-with-masks, pass_index) onto the
    template's device and dtype; sharded pixel families keep their shards."""
    ckpt_dir = Path(ckpt_dir).resolve()
    if pass_index is None:
        pass_index = latest_pass(ckpt_dir)
        if pass_index is None:
            raise FileNotFoundError(f"No checkpoint in {ckpt_dir}")
    dev, dt = template_state.device, template_state.dtype
    with np.load(ckpt_dir / f"state_{pass_index}.npz") as z:
        kw = {f.name: torch.as_tensor(z[f.name], dtype=dt, device=dev)
              for f in dataclasses.fields(prob.RigState) if f.name != "dist"}
        kw["dist"] = tuple(torch.as_tensor(z[f"dist_{i}"], dtype=dt, device=dev)
                           for i in range(len(template_state.dist)))
    state = prob.RigState(**kw)

    with np.load(ckpt_dir / f"masks_{pass_index}.npz") as m:
        def masked(kind, obs_list):
            return tuple(sh.with_mask(o, torch.as_tensor(m[f"{kind}_{o.sensor}"]))
                         for o in obs_list)
        obs = dataclasses.replace(observations, pixels=masked("pix", observations.pixels),
                                  depths=masked("depth", observations.depths))
    return state, obs, pass_index
