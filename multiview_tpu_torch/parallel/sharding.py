"""Sharding of the BA observations and of the TSDF volume over several
devices. Port of ``multiview_tpu/parallel/sharding.py``.

The reference is single-node shared memory (SURVEY.md 2.3); the JAX package
shards keyframe observations over TPU chips along the observation axis and
lets GSPMD insert the reductions. Here the same layout is explicit:

- a ``ShardMesh`` is this process's ordered list of devices (a device may
  repeat: ``[cpu] * 8`` in the tests, ``[cuda:0] * 4`` on one card,
  ``cuda:0 .. n-1`` on a multi-card host), its axis names and global shape
  (1-D, or 2-D host x chip), and an optional ``torch.distributed`` process
  group that joins the processes of several hosts;
- every cross-shard sum goes through ``ShardMesh.sum``: the local partials
  are added in shard order on the lead device, then all-reduced over the
  group, so reruns are bit-identical and every rank holds the same bits;
- a sharded pixel family (``ShardedPixelObs``) keeps this process's shards,
  each on its device, padded to equal rows with ``mask=False`` rows that
  contribute exactly zero, and each shard's global row offset, so the
  calibrator gathers it back without the padding and puts mask updates back
  onto the same shards;
- the state, the depth rows and the xyz priors stay whole on the lead device
  (``replicate``); the solver hands each shard what it needs.

TSDF volumes split into X slabs (1-D mesh) or X x Y blocks (2-D mesh); each
block integrates the replicated depth image on its own device with no
communication (``dense/tsdf.py``), and marching gathers the blocks first.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multiview_tpu_torch.calib import problem as prob
from multiview_tpu_torch.dense import tsdf as tsdf_mod

OBS_AXIS = "obs"

_ROW_FIELDS = ("pix", "beg_idx", "end_idx", "point_idx", "dt_cam", "dt_bracket", "mask")


@dataclasses.dataclass(frozen=True, eq=False)
class ShardMesh:
    """This process's shards: ``devices`` in shard order (repeats allowed),
    ``axis_names`` and the global ``shape`` (all processes' shards; the
    processes of ``group`` split the first axis, rank r holding shards
    ``r * len(devices) ...``). ``group`` is a ``torch.distributed`` process
    group, or None for one process."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (OBS_AXIS,)
    shape: Tuple[int, ...] = ()
    group: Optional[object] = None

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a ShardMesh needs at least one device")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        shape = tuple(int(s) for s in self.shape) or (self.world * len(devs),)
        object.__setattr__(self, "shape", shape)
        if len(shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {shape} does not fit axes {self.axis_names}")
        if int(np.prod(shape)) != self.world * len(devs) or shape[0] % self.world:
            raise ValueError(f"mesh shape {shape}: {self.world} process(es) of "
                             f"{len(devs)} device(s) each do not fill it")

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards over every process."""
        return self.world * self.local_size

    @property
    def lead(self) -> torch.device:
        return self.devices[0]

    def global_index(self, i: int) -> int:
        """Global shard index of local shard ``i``."""
        return self.rank * self.local_size + i

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of one partial per local shard, on the lead device: added
        in shard order (a 2-D mesh in its row-major order, so in one process
        it sums as the 1-D mesh of its shards does), then all-reduced over
        the group."""
        total = parts[0].to(self.lead)
        for p in parts[1:]:
            total = total + p.to(self.lead)
        if self.group is not None:
            total = total.clone()           # the partials stay the caller's
            dist.all_reduce(total, group=self.group)
        return total

    def _all_gather(self, local: torch.Tensor) -> List[torch.Tensor]:
        """Every process's ``local`` (equal shapes), in rank order, on the
        lead device."""
        if self.group is None:
            return [local.to(self.lead)]
        x = local.to(self.lead)
        dtype = x.dtype
        if dtype == torch.bool:
            x = x.to(torch.uint8)
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return [p.to(dtype) for p in parts]

    def gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """Rows of every process (each holds an equal share), in rank order."""
        return torch.cat(self._all_gather(local))

    def gather_blocks(self, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every shard's block (equal shapes) in global shard order."""
        local = torch.stack([b.to(self.lead) for b in blocks])
        return [b for part in self._all_gather(local) for b in part]


def make_mesh(devices: Sequence, axis: str = OBS_AXIS, group=None) -> ShardMesh:
    """1-D mesh over ``devices`` (this process's shards, in order)."""
    return ShardMesh(tuple(devices), (axis,), (), group)


def make_mesh_2d(shape, devices: Sequence, host_axis: str = "host",
                 chip_axis: str = OBS_AXIS, group=None) -> ShardMesh:
    """2-D (host x chip) mesh of global ``shape``: observation rows shard over
    both axes in row-major order; across processes the sums add each host's
    shards first, then all-reduce over the hosts.
    In one process ``devices`` holds all ``shape[0] * shape[1]`` shards; with
    a group of ``shape[0]`` processes each holds one row of ``shape[1]``."""
    world = 1 if group is None else dist.get_world_size(group)
    n = int(shape[0]) * int(shape[1]) // world
    return ShardMesh(tuple(devices)[:n], (host_axis, chip_axis),
                     (int(shape[0]), int(shape[1])), group)


def _pad_rows(t: torch.Tensor, n: int, fill=0) -> torch.Tensor:
    pad = n - t.shape[0]
    if pad == 0:
        return t
    return torch.cat([t, torch.full((pad,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                                    device=t.device)])


def pad_pixel_obs(obs: prob.PixelObs, multiple: int) -> prob.PixelObs:
    """Pad the observation rows to a multiple of ``multiple``; padding rows
    have ``mask=False`` (and index pose 0, point 0), so their residuals and
    Jacobians are exactly zero."""
    n = len(obs)
    n_pad = -(-n // multiple) * multiple
    if n_pad == n:
        return obs
    return dataclasses.replace(obs, **{
        f: _pad_rows(getattr(obs, f), n_pad, False if f == "mask" else 0)
        for f in _ROW_FIELDS})


@dataclasses.dataclass(frozen=True)
class ShardedPixelObs:
    """The pixel observations of one sensor, sharded over a ``ShardMesh``:
    this process's ``shards`` (PixelObs of equal rows, each on its device;
    the last ones end in padding rows) with the global row of each one's
    first row. ``len`` is the row count without the padding. The
    per-row fields are reached through ``gather()``, never directly."""

    shards: Tuple[prob.PixelObs, ...]
    row_offsets: Tuple[int, ...]
    num_rows: int
    mesh: ShardMesh
    sensor: int = 0

    def __len__(self):
        return self.num_rows

    def gather(self) -> prob.PixelObs:
        """The whole family on the lead device, without the padding (a
        collective over the mesh's group when it has one)."""
        lead = self.mesh.lead
        fields = {f: self.mesh.gather_rows(torch.cat([getattr(s, f).to(lead)
                                                      for s in self.shards]))[:self.num_rows]
                  for f in _ROW_FIELDS}
        return prob.PixelObs(dist_half_size=self.shards[0].dist_half_size.to(lead),
                             sensor=self.sensor, **fields)

    def with_mask(self, mask) -> "ShardedPixelObs":
        """The same shards with the mask replaced by the global (unpadded)
        ``mask`` [num_rows]; padding rows stay False."""
        mask = torch.as_tensor(mask, dtype=torch.bool)
        shards = []
        for s, off in zip(self.shards, self.row_offsets):
            part = mask[off:off + len(s)].to(s.mask.device)
            m = torch.zeros(len(s), dtype=torch.bool, device=s.mask.device)
            m[:len(part)] = part
            shards.append(dataclasses.replace(s, mask=m))
        return dataclasses.replace(self, shards=tuple(shards))


def shard_pixel_obs(obs, mesh: ShardMesh) -> ShardedPixelObs:
    """Split the rows of one pixel family over the mesh's global shards
    (padded to a multiple of their count) and keep this process's shards,
    each moved to its device. The per-sensor ``dist_half_size`` is copied to
    every shard. A family that is already sharded is gathered first."""
    if isinstance(obs, ShardedPixelObs):
        obs = obs.gather()
    n = len(obs)
    obs = pad_pixel_obs(obs, mesh.size)
    per = len(obs) // mesh.size
    shards, offsets = [], []
    for i, dev in enumerate(mesh.devices):
        g = mesh.global_index(i)
        sl = slice(g * per, (g + 1) * per)
        shards.append(dataclasses.replace(
            obs, dist_half_size=obs.dist_half_size.to(dev),
            **{f: getattr(obs, f)[sl].to(dev) for f in _ROW_FIELDS}))
        offsets.append(g * per)
    return ShardedPixelObs(tuple(shards), tuple(offsets), n, mesh, obs.sensor)


def shard_observations(observations: prob.Observations, mesh: ShardMesh) -> prob.Observations:
    """Shard the pixel families; depth rows and xyz priors stay whole (they
    are the reference's smaller families, and the solver counts them once,
    on the lead shard of rank 0)."""
    return dataclasses.replace(
        observations, pixels=tuple(shard_pixel_obs(o, mesh) for o in observations.pixels))


def gathered(obs):
    """A pixel family whole: a ``ShardedPixelObs`` gathered without its
    padding, a ``PixelObs`` as it is."""
    return obs.gather() if isinstance(obs, ShardedPixelObs) else obs


def gathered_pixels(observations: prob.Observations) -> Tuple[prob.PixelObs, ...]:
    return tuple(gathered(o) for o in observations.pixels)


def with_mask(obs, mask: torch.Tensor):
    """``obs`` with its (whole, unpadded) mask replaced, keeping its layout."""
    if isinstance(obs, ShardedPixelObs):
        return obs.with_mask(mask)
    return dataclasses.replace(obs, mask=mask.to(obs.mask.device))


def replicate(tree, mesh: ShardMesh):
    """The state (a dataclass, tuple or tensor tree) on the mesh's lead
    device, where the replicated vectors live; shards take copies as they
    use them."""
    if torch.is_tensor(tree):
        return tree.to(mesh.lead)
    if isinstance(tree, tuple):
        return tuple(replicate(x, mesh) for x in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: replicate(getattr(tree, f.name), mesh)
                                            for f in dataclasses.fields(tree)})
    return tree


# ----------------------------------------------------------------------------
# TSDF map-block sharding (SURVEY.md 2.3: voxblox's role over several devices)
# ----------------------------------------------------------------------------


def pad_tsdf_grid(grid: tsdf_mod.TsdfGrid, multiple: int, y_multiple: int = 1
                  ) -> tsdf_mod.TsdfGrid:
    """Pad the grid's X extent to a multiple of ``multiple`` (and Y to one of
    ``y_multiple``) with zero-weight voxels, which extraction ignores (and
    which a ``ShardedTsdfGrid``'s integration keeps at zero weight); the
    origin is unchanged (padding grows the +X / +Y sides)."""
    pad_x = (-grid.shape[0]) % multiple
    pad_y = (-grid.shape[1]) % y_multiple
    if pad_x == 0 and pad_y == 0:
        return grid

    def padxy(a):
        X, Y = a.shape[:2]
        out = torch.zeros((X + pad_x, Y + pad_y) + tuple(a.shape[2:]), dtype=a.dtype,
                          device=a.device)
        out[:X, :Y] = a
        return out

    return dataclasses.replace(grid, tsdf=padxy(grid.tsdf), weight=padxy(grid.weight),
                               intensity=padxy(grid.intensity))


def shard_tsdf_grid(grid: tsdf_mod.TsdfGrid, mesh: ShardMesh) -> tsdf_mod.ShardedTsdfGrid:
    """Split the volume into X slabs over a 1-D mesh, or X over the host axis
    and Y over the chip axis of a 2-D mesh (padded to fit: the padding keeps
    zero weight through every integration); this process keeps its blocks,
    each on its shard's device with the whole grid's origin and the index of
    its first voxel."""
    if len(mesh.shape) == 1:
        nx, ny = mesh.size, 1
    elif len(mesh.shape) == 2:
        nx, ny = mesh.shape
    else:
        raise ValueError(f"TSDF sharding takes a 1-D or 2-D mesh, got shape {mesh.shape}")
    extent = grid.shape[:2]
    grid = pad_tsdf_grid(grid, nx, ny)
    bx, by = grid.shape[0] // nx, grid.shape[1] // ny
    starts = tuple((a * bx, b * by) for a in range(nx) for b in range(ny))
    blocks = []
    for i, dev in enumerate(mesh.devices):
        x0, y0 = starts[mesh.global_index(i)]

        def cut(t):
            return t[x0:x0 + bx, y0:y0 + by].to(dev)

        blocks.append(dataclasses.replace(grid, tsdf=cut(grid.tsdf), weight=cut(grid.weight),
                                          intensity=cut(grid.intensity),
                                          origin=grid.origin.to(dev)))
    return tsdf_mod.ShardedTsdfGrid(tuple(blocks), starts, mesh.global_index(0),
                                    grid.shape, extent, mesh)
