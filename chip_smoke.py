#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``multiview_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit (nvcc). It imports nothing of JAX or of the JAX package.

Phases (each raises on failure; the script then exits non-zero without
printing a result):

0. set-up: require CUDA, print versions and the card, build the two matcher
   kernels (csrc/knn2_wgmma.cu, csrc/knn2.cu), the Schur matvec kernel and
   the one-launch CG solve (csrc/schur_mv.cu), the row blocks kernel
   (csrc/row_blocks.cu), the assembly kernel (csrc/lm_assembly.cu), the
   CG step kernel (csrc/cg_step.cu) and the LM step kernel
   (csrc/lm_step.cu) for sm_90a, one nvcc each, started
   together (the local headers csrc/cg_step.cuh and csrc/row_tiles.cuh are
   compiled into the sources that include them), and the track builder's
   host library (native/mv_native.cpp) with g++;
1. the matcher on the card (``knn2_cuda``: the tensor-core kernel for every
   width, two kernels a call) against ``knn2_plain``, against
   ``knn2_split_plain`` and against the FMA kernel (the FP32 oracle), at the
   main path's shape (8 pairs of 4096x4096x128), at 10000x10000x128, on a
   ragged 1000x1037 case with planted exact duplicates and near-ties, at
   D = 64, at D = 96 (ragged, and the shape of phase 2b), at the CLI's
   default chunk (8 pairs of 1000x1000x128), at D = 256 and on a ragged
   D = 160 case with the planted rows; median times over distinct inputs of
   the kernel, the FMA kernel, the plain version and the product
   ``torch.matmul`` alone, beside the operation bound and the 3xTF32 floor;
   the device kernels of one call (torch.profiler, at most two); the FMA
   kernel held to the plain version at every shape;
2. the main path without the depth camera: a two-sensor rig workspace
   (1280x960, focal 1120 px, 12 reference + 11 radtan frames with a 0.13 s
   clock offset; the frames are rendered once, in worker processes, for this
   phase and phase 4) and ``python -m multiview_tpu_torch calibrate`` in
   process, through the tensor-core kernel; checks the launch count, the
   track count, the cost decrease, the recovered rig transform (1 deg /
   0.05 m) and the output files;
2b. the odd-width path: ``match_pairs_batched`` over five images of 1000
   planted features with 96-wide descriptors, through the tensor-core kernel
   (three 32-dimension slabs); checks the launch count and the planted
   correspondences;
3. Schur-LM bundle adjustment at the bench's size (cube scene 160 images x
   20x20 points per face, about 384k observations, float32, 10 LM x 30 CG
   at cg_tolerance 0.1): finite, decreasing cost, LM iterations per second,
   the CG count and the matvecs run (CG stops at the reference's test, taken
   on the device at every step of the one-launch solve: the matvecs equal
   the CG count); a solve with every host sync between an LM iteration's
   start and its stop test made an error; then the same solver with
   ``debug_force_cg=30`` (the whole budget, every step taken): its rate and
   final cost;
3b. the four linear solvers of ``make_schur_solver`` on phase 3's problem
   and settings (``cg_blocks``, matrix-free ``cg``, ``cg_dense_j``,
   ``dense_schur``): LM it/s, LM and CG counts, matvecs, peak memory and
   final cost; the two other CG modes held to ``cg_blocks`` and
   ``dense_schur`` (an exact solve) to the forced-budget solve of phase 3,
   both within 1e-4 relative (phase 9a's float32 bar);
3c. the Schur matvec kernel (``solver/schur_matvec.py``, csrc/schur_mv.cu)
   against its plain version on the first system of phase 3's solve (the
   benchmark's cube, 384000 rows) and of phase 4's (three sensors and depth
   rows): S x, the right-hand side and the back-substitution's products
   within 1e-4 of max |plain| (float32); per matvec the launches (one
   cooperative launch on one shard), the launch's grid, tile rows and
   slots, the rows kept in shared memory between its passes, its pose
   window, and the bytes its design reads; microseconds per matvec of the
   kernel, the plain version, the plain version replayed from a CUDA graph,
   the kernel from a graph (where the capture takes the cooperative
   launch), and the bound with its share; the kernel launched as the LM
   loop launches it, through the selector of the loop's halves (half 1
   read), held to the plain version and timed eager and from a graph (the
   same for the row blocks, the assembly and the CG solve in 3d-3f);
3d. the row blocks kernel (``solver/row_blocks.py``, csrc/row_blocks.cu:
   per-row residuals and block Jacobians by forward-mode dual numbers, the
   chain split where the blocks meet)
   against its plain version (autograd) in float64 on the same inputs, on
   every family that phases 3 and 4 handed the solver first (the cube's
   384000 tsai rows; calibrate's three pixel sensors and depth rows), and on
   the cube's rows with an rpc of degree 2 in place of tsai, within
   SCHUR_RTOL of max |plain| for each output with the family's float32
   tensors and ROW_RTOL_F64 with them in float64, beside the plain float32
   version's own error: ms a call of the kernel, the plain version, the
   plain version from a CUDA graph (or why it could not be captured), the
   kernel from a graph (whose capture must work), the bound (the bytes, or
   the FLOPs of the function, ``row_block_flops``, over the FP32 rate) and
   its share, registers and spills from the build's ptxas report; then the
   planted rows of
   tests/row_block_scenes.py (every family, model and branch) in float32
   (SCHUR_RTOL) and float64 (ROW_RTOL_F64);
3e. the assembly kernel (``solver/assembly.py``, csrc/lm_assembly.cu: the
   gradient, Hpp, the Jacobi diagonal, Hpp^-1, dc, the preconditioner and
   the SCHUR_JACOBI 7x7 inverses) against its plain version in float64 on
   the first assembly of phase 3 (the cube, jacobi) and of phase 4
   (calibrate's four families, SCHUR_JACOBI): every output within
   SCHUR_RTOL of its max |plain| (ROW_RTOL_F64 with the tensors in float64),
   beside the plain float32 version's own error; the launches (one on one
   shard) and the launch's shape (the warps' pose window, tile rows, slots,
   the rows the blocks pass found in shared memory, the bytes of rows read),
   each pass's time from the kernel's own %globaltimer stamps; ms of the
   kernel through the solve's ``AssemblyPlan`` and without one, the plain
   version, both from a CUDA graph where they can be captured, the bound
   and its share, registers, spills and stack;
3f. the one-launch CG solve (``solver/cg_solve.py``, cg_solve_kernel of
   csrc/schur_mv.cu) on the first CG of phases 3 and 4: 30 forced steps
   against the plain solve in float64, x within SCHUR_RTOL with the tensors
   in float64; in float32 one step within SCHUR_RTOL and 30 within CG_DRIFT
   times the plain float32 solve's own drift; one launch a solve, and none
   of the matvec or the CG step kernel; the early-stopped CG count, in
   float32 and float64, equal to the plain float64 loop's; ms a solve and a
   step of the kernel, the per-step path (csrc/schur_mv.cu's matvecs and
   csrc/cg_step.cu's steps), the plain solve eager and from a CUDA graph,
   the kernel from a graph, the bound, the bytes of rows a step reads from
   device memory, registers and spills; whether two launches give the
   same bits (forced and early-stopped; the sums' atomics may change the
   last bits), the float64 check repeated 20 times on phase 4's system
   (each launch's pass counted), a step's time against the bound of what a
   step must read (the rows that the grid's shared memory cannot hold,
   once, and the vectors), the launch's grid barriers a step; the per-step path (the sharded
   paths') against the same plain solve, at the same bars, its early-stopped
   count equal to the plain loop's; then the CG step kernel of the
   per-step path: ms a step of the kernel, the plain
   step, both from a CUDA graph, the bound, and an empty launch measured
   beside them (the step's practical floor);
3g. the LM step kernel (``solver/lm_step.py``, csrc/lm_step.cu: an LM
   iteration's trial point, model reduction, accept and lam update) on the
   first trial and accept of phases 3 and 4 (the trial's inputs those of the
   CG solve that wrote it in its tail, one shard of cg_blocks), the current
   and trial state in the halves of the LM loop (``lm_step.Halves``) as the
   path left them: the trial kernel against the plain trial in float64 and
   bit for bit against the CG solve's trial point, the accept at an accepted and a
   forced rejected step against the plain accept (decisions, ``sel``,
   counters and the stop flag equal, the scalars within LM_RTOL, both halves
   bit for bit as they were: nothing copied, the current half kept; two
   launches and two replays of one CUDA graph alike); ms of the kernel and
   the plain version, eager and from a CUDA graph, the bound, the accepted
   accept against the rejected one from graphs, registers; phase 3's
   solve with the LM state read every iteration and every second one (the
   counts equal, the cost within the spread of two runs); per LM iteration
   the kernel launches (4: row blocks, assembly, CG solve, accept; no trial
   launch), the host reads and the eager ATen operations (none);
4. the main path with the depth camera, ``--sharded`` (on one card it shards
   nothing and prints no sharding line): the same workspace plus haz_cam (11
   pinhole frames with a ``.pc`` cloud each) whose depth_to_image in
   rig_config.txt is off the truth by a scale of 1.03 and a rotation of one
   degree; ``calibrate`` with ``--depth_tri_weight 25 --float_scale
   --depth_to_image_transforms_to_float haz_cam``; checks the launch count,
   the attached depth rows, the cost decrease in both passes, both rig
   transforms (1 deg / 0.05 m), the recovered depth_to_image (0.5% / 0.1 deg;
   the scale in the truth's metres: the written one times the world scale of
   the calibration's free gauge),
   the depth clouds' alignment with the terrain (median under 5 mm) and the
   output files;
4b. the mesh families: ``ray_mesh_intersect`` on the card (float32) at 20000
   rays x the tessellated terrain (at least 100k triangles) against the same
   function in float64 on the card, itself held to the CPU in float64 on
   every fifth ray; then ``calibrate`` on the phase 4 workspace with
   ``--mesh --mesh_tri_weight --depth_mesh_weight``: hits for most inlier
   rows, cost decrease, rig transforms, time of the per-pass ray cast;
5. the dense LM and the RPC fit on the card: ``fit_rpc_dist_undist`` of one
   radtan camera (degree 5, round trip under 0.01 px) and ``optimize_rig`` with the
   dense back end on a small cube scene;
6. ``python -m multiview_tpu_torch sfm-init`` in process on the three-sensor
   workspace of phase 4 (34 images, 4096 features, 3 overlaps, 90 iterations
   of the refinement BA), GLOBAL, on the card: stage times, images,
   view-graph edges, tracks, triangulated tracks, matcher launches counted
   from 0, every view registered, and the
   trajectory against the truth after a similarity alignment (ATE RMSE and
   mean rotation error under the bars below); then the two-view stage alone
   (``view_graph_from_matches`` on the correspondences of that run) on the
   card and on the CPU, in turns;
6b. ``sfm-init --reconstruction_estimator INCREMENTAL`` on the first row of
   the two-sensor workspace of phase 2 (8 + 7 of its 23 images: the grid's
   row change joins the rows through one image only, which incremental
   registration cannot cross, a point needing two registered views):
   every view registered, the same bars;
6c. the reference workflow end to end: ``calibrate --nvm`` from phase 6's
   cameras.nvm (no rig, floating camera poses, the tool's default 2 passes of
   20 iterations, with the front end's matches merged in): the cost falls,
   the trajectory meets the bars of the JAX package's hard-scene test (0.05 m,
   2 deg) and is no worse than phase 6's;
2c. the rest of the front end: ``calibrate`` on the phase 2 workspace with
   SURF features, out-of-core matching through a cache of 4 images, the
   match-file export and registration to 8 control points made from the
   truth: tensor-core launches, the rig, the registration error, the camera
   centres against the truth with no alignment, the match files read back;
7. the dense path: ``python -m multiview_tpu_torch fuse-mesh`` in process on
   the three-sensor workspace (31 consecutive pairs of 1280x960, SGM, 64
   planes, the left-right check, 0.02 m voxels): the file layout, per-pair
   point counts, the fused
   mesh against the analytic terrain (median and 90th percentile vertical
   error), the stage times, a resume from ``mesh_gen`` that writes the same
   mesh; then one pair on the card alone (cost pass, SGM and the cloud
   filter's k-NN timed) and at 640x480 with 32 planes on the card (float32)
   against the CPU (float64);
7b. ``python -m multiview_tpu_torch undistort`` of the 11 sci_cam frames:
   the intrinsics file, and one undistorted frame against a pinhole render of
   the terrain from its pose with the undistorted intrinsics;
8. ``python -m multiview_tpu_torch texture`` in process on phase 7's fused
   mesh with all 34 frames and the tool's defaults (colour, ``auto``
   occlusion, which must choose the grid march, gauss clamping, the MRF,
   global and local seam leveling, 0.01 m texels): stage seconds, the
   occlusion method, the atlas, the MRF energies (ICM no higher than
   argmin), the global leveling's sweeps and residual (converged or at its
   cap), the seam steps (no larger after local leveling), the PNG read back
   equal to the page, every filled texel of a visible face against the
   terrain's analytic albedo at its 3D point, and the peak device memory;
8b. a 0.5 m x 0.5 m window of the same mesh with all 34 views: ``view_costs``
   with the exact ray cast and with the grid march on the card, timed, and
   their agreement; ``view_costs`` (grid) + ``mrf_view_selection`` on the
   card (float32) against the CPU (float64), the share of equal labels;
8c. ``calibrate --mesh --out_texture_dir`` on the two-sensor workspace (one
   pass of 5 iterations, a terrain mesh of 0.2 m cells): one OBJ/MTL/PNG
   triple per image, each PNG the image the run held, faces kept for every
   camera, the projection step's seconds, the matcher's launches;
9. sharding (``multiview_tpu_torch/parallel``), on the one card: 9a phase
   3's solve with its observations in 4 shards on cuda:0 (and over every
   card where there are several) against the unsharded solve, both walls and
   LM it/s, under the float32 bars below; 9b ``calibrate`` with the depth
   camera through ``run(args, mesh)`` with a 4-shard mesh, held to phase 4's
   bars, the sharding line printed; 9c the front end on phase 4's 34 images
   in 4 shards: keypoints, descriptors, match sets and tracks bit for bit the
   unsharded path's, the sharded ``detect_match_features``'s launches; 9d two
   processes (this script with ``--phase9d-worker``) of 2 shards each joined
   by gloo on CUDA tensors: the ranks bit for bit equal, a gather across
   them whole, both within 9a's bars of the unsharded solve; then NCCL at
   world size 1 with 4 shards; 9e three of phase 7's clouds fused into 4 X
   slabs against the whole grid (1e-5) and the same mesh;
10. the benchmark's ``ba_cube_384k`` cell (``bench_torch/ba_cube.py``) once
   through its own entry, at seed 0: one warm and one timed solve, its input
   hash against the recorded one, its ``correct`` (the cost falls, the
   reprojection RMS under its bar) and its metric line. It launches no
   kernel of this repo.

Every path that runs the BA (phases 2, 2c, 3, 3b's ``cg_blocks``, 4, 4b, 6,
6b, 6c, 8c, 9a, 9b, 9d and 10) counts the Schur matvec kernel's and the CG
step kernel's launches from 0 and must have launched both; each of them and
phase 3b's other three modes counts the row blocks kernel's and the
assembly kernel's launches from 0 and must have launched both (and taken no
family to the plain version), the modes ``cg`` and ``cg_dense_j`` the CG
step kernel's too.

The last three lines of standard output are the kernel record (JSON: each
kernel with its launches on its paths (the tensor-core kernel's is the sum
over phases 2, 2b, 2c, 4, 4b, 6, 6b, 6c, 8c, 9b and 9c, each counted from 0
and each required to be positive; ``launches_by_path`` has them all; the
texture path of phases 8-8b launches no kernel; the FMA kernel, the FP32
oracle, is launched by no path), its time, its plain version's, the
product ``torch.matmul``'s as ``library_ms``, its bound and largest error at
the main path's chunk; the Schur matvec kernel with its launches per path
and phase 3c's figures at the cube, ``library_ms`` null; the row blocks
kernel with its launches per path and phase 3d's figures at the cube, every
family's under ``by_family``, ``library_ms`` null; the assembly and the CG
step kernels with their launches per path and phases 3e / 3f's figures at
the cube, calibrate's under ``by_system``, ``library_ms`` null), the card's
name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# ratio-test agreement bar (fraction of the rows whose ratio test the
# reference decides by more than the distance tolerance) and distance
# tolerances: the kernels and cuBLAS+topk sum the products in different
# orders, so float32 distances of unit descriptors differ by a few 1e-7
# absolute
MASK_AGREEMENT = 0.9999
DIST_RTOL = 1e-5
DIST_ATOL = 1e-6

# published peaks of one H100 SXM (data sheet, dense): the bound of the matcher
# is its 2 P N M D operations over the TF32 tensor-core rate, or its bytes
# (inputs read once, outputs written once) over the memory rate
TF32_PEAK = 495e12
FP32_CORES_PEAK = 67e12
MEM_PEAK = 3.35e12
WGMMA_SOURCE = "multiview_tpu_torch/csrc/knn2_wgmma.cu"
FMA_SOURCE = "multiview_tpu_torch/csrc/knn2.cu"
TRACKS_EXPECTED = 5145     # phase 2 with the FMA kernel on this workspace
N_REF = 12                 # reference frames of the rendered workspace
SIZE, FOCAL = (1280, 960), 1120.0
# what rig_config.txt says of haz_cam's depth_to_image in phase 4 (the truth is
# the identity): a scale and a rotation vector of 0.01755 rad = 1.006 deg
D2I_GUESS_SCALE, D2I_GUESS_ROTVEC = 1.03, (0.01, -0.012, 0.008)
RAY_CHECK = 20000          # rays of the phase 4b ray-cast check
MESH_STEP = 0.03           # terrain grid step: 334 x 267 cells x 2 = 178k triangles
ODD_PATH = (5, 1000, 96)   # phase 2b: images, features per image, descriptor width
# phases 6-6c: trajectory bars after a similarity alignment. sfm-init's result
# on this near-planar scene has two modes, measured on an H100 in 12 runs with
# 90 iterations (PERF.md; 4 of phase 6's command, 8 with a tighter
# re-resection threshold or a float64 BA): where its re-resection step
# replaces a pose and the refinement BA runs again, ATE 0.00085 to 0.0133 m and
# 0.13 to 0.27 deg (9 runs); where no pose is replaced, the BA rests at 0.053
# to 0.058 m and 1.3 to 2.04 deg (3 runs), as it does after the tool's default
# of 30 iterations (0.053 to 0.069 m, up to 2.07 deg, 7 runs). The JAX package's hard-scene
# test holds 0.05 m and 2 deg; the bars here admit both modes with a factor
# of 1.45
ATE_MAX_M, ROT_MEAN_MAX_DEG = 0.10, 3.0
# depth of sfm-init's refinement BA in phases 6 and 6b: before the BA the
# trajectory is 0.111 m / 3.9 deg off, and the better mode needs the second BA
# to run long enough (30 + 30 iterations leave 0.053 m, 90 + 90 reach it)
SFM_BA_ITERATIONS = 90
ROW_REF = 8                # reference frames of the first row of the lawnmower grid
# phase 6c: calibrate's default depth. Measured on an H100 (PERF.md,
# scripts/torch_sfm_probe.py --calibrate): from sfm-init's 5 to 7 cm mode one
# pass of 10 iterations ends at 0.033 to 0.054 m, two passes of 20 at 0.00135
# to 0.00143 m and 0.17 to 0.18 deg, so the workflow's end is held to the bars
# of the JAX package's hard-scene test whatever mode sfm-init landed in
CALIB_PASSES, CALIB_ITERATIONS = 2, 20
WORKFLOW_ATE_MAX_M, WORKFLOW_ROT_MEAN_MAX_DEG = 0.05, 2.0
# phase 2c: control points for the registration, and its bars
CONTROL_POINTS = 8
REGISTRATION_MAX_M, CENTRE_MAX_M = 0.01, 0.02
# phase 7: fuse-mesh flags (the cameras fly 2 m above terrain of +-0.25 m
# relief) and the bar on the fused mesh's median vertical error (one voxel).
# With the reference's unchecked depths the mesh is 0.227 m off (median,
# scripts/torch_dense_probe.py on an H100, PERF.md): each pair's pixels that
# its neighbour does not see take a wrong, too great depth (12-17% of the
# points more than 5 cm below the terrain), whose rays carve free space under
# the surface; the left-right check removes them
FUSE_FLAGS = ["--stereo_algorithm", "sgm", "--num_planes", "64", "--min_depth", "1.5",
              "--max_depth", "3.0", "--voxel_size", "0.02", "--grid_dim", "320",
              "--left_right_check"]
# with it, measured on an H100: median 0.00653 m, 90th percentile 0.106 m,
# 169443 vertices, 161951 points per pair (median; the row change's nav_cam
# pair keeps none); the bars leave a factor of two or more
FUSE_PAIRS = 31
MESH_MEDIAN_MAX_M, MESH_P90_MAX_M = 0.02, 0.2
MIN_MEDIAN_PAIR_POINTS, MIN_MESH_VERTICES = 100000, 100000
# phase 7b: |undistorted - pinhole render| in gray levels, measured on an
# H100: median 0.992, 90th percentile 1.48
UNDISTORT_MEDIAN_MAX = 2.0
# phase 8: texture phase 7's fused mesh from the 34 frames with the tool's
# defaults. Bars on the textured page against the terrain's analytic albedo,
# in gray levels over the filled texels of the visible faces. The first run on
# an H100 (PERF.md) read a median of 20.26 and a 90th percentile of 88.82 for
# the tool's page: the global seam leveling, fit to face-centre colours,
# carries texture across the view seams (in the JAX package too). The bars
# leave a factor of 1.5 and 1.35. The same labels rendered without gains are
# held to the albedo more tightly (a CPU rehearsal at 320x240 read 0.76 and
# 2.9 gray levels; the first on the H100 0.935 and 8.883: bars of 2 and 15).
TEXTURE_FLAGS = ["--pixel_size", "0.01"]
ALBEDO_MEDIAN_MAX, ALBEDO_P90_MAX = 30.0, 120.0
RENDER_MEDIAN_MAX, RENDER_P90_MAX = 2.0, 15.0
# phase 8b: a window of the fused mesh (faces whose centres lie in a square
# of this side, in metres: 21951 faces), and the share of its visible faces
# that must get the same MRF label on the card (float32) as on the CPU
# (float64), both with the grid march (the exact cast of the window's 746k
# face-view pairs took 306 s on the CPU). With the exact cast the first run
# on an H100 read 1.00000 of 5003 faces; the bar leaves a margin for cells
# the march's samples reach on one device only
WINDOW_SIDE = 0.5
LABEL_AGREEMENT_MIN = 0.98
# phase 8c: calibrate --out_texture_dir with a coarse terrain mesh (0.2 m
# cells: 4000 triangles) on the two-sensor workspace, one short pass
OUT_TEXTURE_MESH_STEP = 0.2
# phase 9: shards on the one card; the reduced cube of the two-process run
# (images, points per face side); the float32 bars of a sharded solve against
# the unsharded one (initial cost: 1e-6 relative). Measured on an H100 at 4
# shards (phase 9a, two calls): final cost 3.62e-7 and 4.52e-6 relative,
# cameras 2.07e-4 and 1.96e-4 (the focal of 600 px has a float32 step of
# 6e-5; the poses float with a free gauge, and index_add_ sums in no fixed
# order on the card, unsharded too); the bars leave a factor of about 10. A
# family counted twice would move the cost by a factor, not 1e-4
SHARDS = 4
MP_CUBE = (40, 10)
# phase 3's solver settings (those of bench.py)
BA_SETTINGS = dict(max_iterations=10, cg_iterations=30, cg_tolerance=0.1)
SHARDED_COST_RTOL, SHARDED_CAM_ATOL = 1e-4, 2e-3
# phase 3c: the Schur matvec kernel against its plain version, max |diff| over
# max |plain| in float32 (atomics and index_add_ sum in different orders)
SCHUR_RTOL = 1e-4
SCHUR_SOURCE = "multiview_tpu_torch/csrc/schur_mv.cu"
# phase 3d: the row blocks kernel against its plain version in float64 on the
# same inputs, max |diff| over max |plain| of each output (forward against
# reverse mode): float32 tensors at SCHUR_RTOL, float64 ones at ROW_RTOL_F64
ROW_RTOL_F64 = 1e-9
ROW_SOURCE = "multiview_tpu_torch/csrc/row_blocks.cu"
# phases 3e-3f: the assembly and the CG step kernels against their plain
# versions in float64 on the same inputs, max |diff| over max |plain| of each
# output: float32 tensors at SCHUR_RTOL, float64 ones at ROW_RTOL_F64; the CG
# run for CG_FORCED forced steps. CG amplifies rounding: after 30 forced
# steps the plain float32 loop's x is 1.57e-3 (cube) and 4.7e-3 (calibrate's
# system) of max |x| off the plain float64 loop's, and the float64 kernels'
# 1e-10 and 3.6e-8 (measured on an H100, PERF.md). So one forced float32 step
# is held at SCHUR_RTOL, 30 at CG_DRIFT times the plain float32 loop's own
# drift (SCHUR_RTOL where that is less), and 30 in float64 at SCHUR_RTOL
CG_DRIFT = 2.0
ASM_SOURCE = "multiview_tpu_torch/csrc/lm_assembly.cu"
CG_SOURCE = "multiview_tpu_torch/csrc/cg_step.cu"
# launches of phase 3f's float64 check on phase 4's system
F64_REPEATS = 20
CG_FORCED = 30
# phase 3g: the LM step kernel against its plain version on the same inputs:
# the accept's scalars (float64 sums in both, in other orders) within LM_RTOL
# relative of the plain ones
LM_RTOL = 1e-12
LM_SOURCE = "multiview_tpu_torch/csrc/lm_step.cu"


class Tee(io.TextIOBase):
    """Copy writes to the real stdout and keep them for parsing."""

    def __init__(self, out):
        self.out = out
        self.buf = io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# launches of csrc/schur_mv.cu (the matvec's schur_kernel; the CG solve's
# cg_solve_kernel), csrc/row_blocks.cu, csrc/lm_assembly.cu and csrc/cg_step.cu
# per path, each counted from 0 (schur_counted)
SCHUR_PATHS = {}
SOLVE_PATHS = {}
# of the LM step kernel's launches, the trial's (0 on one shard of cg_blocks,
# whose CG solve writes the trial point)
TRIAL_PATHS = {}
ROW_PATHS = {}
ASM_PATHS = {}
CG_PATHS = {}
LM_PATHS = {}
# the first call of each row-block family of a path's BA, caught for phase 3d
# (its entry point's arguments; ROW_HALVES: the outputs and the LM loop's
# halves it was bound to)
ROW_CALLS = {}
ROW_HALVES = {}
# the arguments of the first assembly and the first CG solve of a path's BA
# (one shard: ``cg_solve.solve``), caught for phases 3c-3f
ASM_CALLS = {}
SOLVE_CALLS = {}
# the first trial and accept of a path's BA (``first_lm_step``), for phase 3g
LM_CALLS = {}
# the kernels each kind of BA path launches besides the row blocks and the
# assembly: "solve" one shard of cg_blocks (one cg_solve_kernel launch an LM
# iteration, no matvec or CG step launch of its own), "sharded" cg_blocks on
# several shards (the matvec's passes and a CG step launch a step), "steps"
# the linear solvers cg and cg_dense_j (a CG step launch a step),
# "dense" dense_schur (no CG)
PATH_KERNELS = {"solve": {"cg_solve"}, "sharded": {"schur_mv", "cg_step"},
                "steps": {"cg_step"}, "dense": set()}


@contextlib.contextmanager
def schur_counted(tag, path: str = "solve"):
    """Sets the counts of the BA's kernels to 0 just before a BA path and
    reads them just after: the path must have launched the row blocks
    kernel, the assembly kernel, the LM step kernel and the kernels of its
    kind (``PATH_KERNELS``), and no other; on a "solve" path one CG solve
    launch an assembly launch (one each an LM iteration)."""
    from multiview_tpu_torch.solver import (assembly as asm, cg, cg_solve, lm_step as lm,
                                            row_blocks as rb, schur_matvec as smv)
    smv.LAUNCHES = rb.LAUNCHES = asm.LAUNCHES = cg.LAUNCHES = cg_solve.LAUNCHES = 0
    lm.LAUNCHES = lm.TRIAL_LAUNCHES = 0
    yield
    TRIAL_PATHS[tag] = lm.TRIAL_LAUNCHES
    if path == "solve" and lm.TRIAL_LAUNCHES:
        raise AssertionError(f"{tag}: {lm.TRIAL_LAUNCHES} trial launches on one shard of "
                             f"cg_blocks (the CG solve writes the trial point)")
    wanted = PATH_KERNELS[path] | {"row_blocks", "lm_assembly", "lm_step"}
    for name, paths, mod in (("schur_mv", SCHUR_PATHS, smv), ("cg_solve", SOLVE_PATHS, cg_solve),
                             ("row_blocks", ROW_PATHS, rb), ("lm_assembly", ASM_PATHS, asm),
                             ("cg_step", CG_PATHS, cg), ("lm_step", LM_PATHS, lm)):
        if name in wanted:
            paths[tag] = mod.LAUNCHES
        if (mod.LAUNCHES > 0) != (name in wanted):
            raise AssertionError(f"{tag} ({path}): the BA launched the {name} kernel "
                                 f"{mod.LAUNCHES} times")
    if path == "solve" and cg_solve.LAUNCHES != asm.LAUNCHES:
        raise AssertionError(f"{tag}: {cg_solve.LAUNCHES} CG solve launches for "
                             f"{asm.LAUNCHES} LM iterations")


@contextlib.contextmanager
def first_row_blocks(key):
    """Keeps the first call of each family (kind, sensor, variant) that the
    path's BA hands the row-block launches of ``solver/schur.py`` (the LM
    loop on the card binds each family's launch once a solve, at its
    current and at its trial point): the entry points' arguments (state,
    family, ...; the state's tensors are the solve's own)."""
    from multiview_tpu_torch.solver import schur
    names = ("pixel_row_launch", "depth_row_launch", "prior_row_launch")
    originals = {n: getattr(schur, n) for n in names}
    calls = ROW_CALLS.setdefault(key, {})
    bound = ROW_HALVES.setdefault(key, {})

    def spy(name):
        def fn(*args):
            obs = args[1]
            tag = (name.split("_")[0], getattr(obs, "sensor", None),
                   args[3] if name == "depth_row_launch" else None)
            calls.setdefault(tag, args[:4])
            bound.setdefault(tag, args[4:6])
            return originals[name](*args)
        return fn

    for n in names:
        setattr(schur, n, spy(n))
    try:
        yield
    finally:
        for n in names:
            setattr(schur, n, originals[n])


def kept(x):
    """``x`` with every tensor in it cloned (in lists, tuples, NamedTuples and
    a ``SchurSystem``, whose kernel tables are then made anew and which keeps
    no halves: its blocks are the clones): the assembly's outputs, which a
    solve's CG reads, are overwritten by its next LM iteration."""
    import dataclasses
    import torch
    from multiview_tpu_torch.solver import schur_matvec as smv
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(kept(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(kept(v) for v in x)
    if isinstance(x, smv.SchurSystem):
        return dataclasses.replace(x, J=kept(x.J), cam_free=kept(x.cam_free), dc=kept(x.dc),
                                   hpp_inv=kept(x.hpp_inv), halves=None, _plans=None)
    return x


@contextlib.contextmanager
def first_assembly_and_cg(key):
    """Keeps the arguments of the first ``assembly.assemble`` and the first
    ``cg_solve.solve`` the path's BA calls (their tensors cloned: ``kept``)."""
    from multiview_tpu_torch.solver import assembly as asm, cg_solve
    originals = (asm.assemble, cg_solve.solve)

    def spy(calls, i):
        def fn(*args):
            if key not in calls:
                calls[key] = kept(args)
            return originals[i](*args)
        return fn

    asm.assemble, cg_solve.solve = spy(ASM_CALLS, 0), spy(SOLVE_CALLS, 1)
    try:
        yield
    finally:
        asm.assemble, cg_solve.solve = originals


@contextlib.contextmanager
def first_lm_step(key):
    """Keeps the arguments of the first ``lm_step.trial`` and
    ``lm_step.accept`` the path's BA calls (tensors cloned: ``kept``), with
    the LM state's values as the call found them and both halves of the
    LM loop's arrays that each reads (``lm_halves``: the cameras and points;
    the accept's also every block and residual). Where the CG solve writes
    the trial point (one shard of cg_blocks), the first such call's trial
    inputs in ``lm_step.trial``'s order (its x and J_p^T u among them) and
    what it wrote (``"folded"``: dp, step_c and the trial's cameras and
    points)."""
    from multiview_tpu_torch.solver import cg_solve, lm_step as lm
    originals = (lm.trial, lm.accept, cg_solve.solve)
    calls = LM_CALLS.setdefault(key, {})

    def solve_spy(*args):
        tin = args[11] if len(args) > 11 else None
        if tin is None or "trial" in calls:
            return originals[2](*args)
        st, h = tin.st, tin.halves
        values, typed = st.values.clone(), st.typed.clone()
        pairs = [h.pair(tin.cam).clone(), h.pair(tin.points).clone()]
        out = originals[2](*args)
        system, g_p = args[0], args[2]
        calls["trial"] = (values, typed,
                          kept((tin.cam, tin.points, out.x, system.cam_free, tin.lower, tin.upper,
                                system.hpp_inv, g_p, out.jtp_u, h)), pairs)
        sel = int(st.sel)
        calls["folded"] = [x.clone() for x in (out.trial.cam[1 - sel], out.trial.points[1 - sel],
                                               out.trial.dp, out.trial.step_c)]
        return out

    def spy(i, name):
        def fn(st, *args):
            if name not in calls:
                h = args[-1]
                arrays = list(args[:2]) if name == "trial" else lm_arrays(args[3], args[4], args[8],
                                                                         args[9])
                calls[name] = (st.values.clone(), st.typed.clone(), kept(args),
                               [None if a is None else h.pair(a).clone() for a in arrays])
            return originals[i](st, *args)
        return fn

    lm.trial, lm.accept, cg_solve.solve = spy(0, "trial"), spy(1, "accept"), solve_spy
    try:
        yield
    finally:
        lm.trial, lm.accept, cg_solve.solve = originals


def lm_arrays(J, r, cam, points):
    """The LM loop's arrays an accept reads, flat: the cameras, the points,
    each shard's residual, then each shard's camera blocks and point blocks
    (None where a family has none)."""
    return [cam, points, *r] + [a for jc, jp in J for a in (*jc, *jp)]


def lm_unflat(arrays, J):
    """``lm_arrays``' list back to (cam, points, r, J), J shaped as given."""
    it = iter(arrays)
    cam, points = next(it), next(it)
    r = [next(it) for _ in J]
    Jn = [([next(it) for _ in jc], [next(it) for _ in jp]) for jc, jp in J]
    return cam, points, r, Jn


def lm_halves(torch, st, pairs):
    """(``lm_step.Halves`` on ``st``, half-0 arrays): each of ``pairs``
    ([2, ...] each, None stays None) copied half for half."""
    from multiview_tpu_torch.solver import lm_step as lm
    sel = int(st.sel)
    return lm.halves_for(st, [None if p is None else p[sel] for p in pairs],
                         [None if p is None else p[1 - sel] for p in pairs])


def halved(torch, J, r=None, sel=1):
    """(J, r, halves): copies of the blocks ``J`` and residuals ``r`` (per
    shard; r None: none) in both halves of new ``lm_step.Halves`` whose
    selector reads ``sel``: a kernel timed as the LM loop launches it, its
    table on half 0 and its reads ``sel`` halves on."""
    from multiview_tpu_torch.solver import lm_step as lm
    first = next(x for jc, jp in J for x in (*jc, *jp) if x is not None)
    st = lm.LMState(first.dtype, first.device)
    st.sel.fill_(sel)
    flat = [x for jc, jp in J for x in (*jc, *jp)] + ([] if r is None else list(r))
    h, arrays = lm.halves_for(st, flat)
    it = iter(arrays)
    Jh = [([next(it) for _ in jc], [next(it) for _ in jp]) for jc, jp in J]
    return Jh, (None if r is None else [next(it) for _ in r]), h


@contextlib.contextmanager
def no_sync_inside_lm(torch):
    """Makes every host sync raise (``torch.cuda.set_sync_debug_mode``) from
    the start of each LM iteration's assembly to the loop's read of the LM
    state (``lm_step.read``: done, the counts and the singular flag in one
    sync, every ``LM_CHECK_EVERY`` iterations)."""
    from multiview_tpu_torch.solver import assembly as asm, lm_step as lm
    originals = (asm.assemble, lm.read)

    def assemble(*args):
        torch.cuda.set_sync_debug_mode("error")
        return originals[0](*args)

    def read(*args):
        torch.cuda.set_sync_debug_mode(0)
        return originals[1](*args)

    asm.assemble, lm.read = assemble, read
    try:
        yield
    finally:
        asm.assemble, lm.read = originals
        torch.cuda.set_sync_debug_mode(0)


def descriptors(gen, p, n, d, device):
    """SIFT-like rows: non-negative, unit norm."""
    import torch
    x = torch.randn((p, n, d), generator=gen, device=device).abs()
    return (x / x.norm(dim=-1, keepdim=True)).contiguous()


def median_ms(torch, fn, inputs):
    times = []
    for q, t in inputs:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn(q, t)
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return sorted(times)[len(times) // 2]


def compare(torch, mm, label, other, got, ref):
    """Holds ``got`` to ``ref`` under the bars above; returns the largest
    distance difference."""
    gap = ref.second_dist - ref.best_dist
    # the relative bar (1e-4 of the best distance) plus an absolute floor: float32 cancellation
    # in |q|^2+|t|^2-2q.t errs by ~1e-7 absolute, so near-duplicate rows
    # (best ~1e-6) are near-ties whatever their relative gap
    decided = gap > 1e-4 * ref.best_dist + 2 * DIST_ATOL
    idx_bad = int(((got.best_idx != ref.best_idx) & decided).sum())
    err = max(float((got.best_dist - ref.best_dist).abs().max()),
              float((got.second_dist - ref.second_dist).abs().max()))
    close = (torch.allclose(got.best_dist, ref.best_dist, rtol=DIST_RTOL, atol=DIST_ATOL)
             and torch.allclose(got.second_dist, ref.second_dist, rtol=DIST_RTOL,
                                atol=DIST_ATOL))
    # the ratio test is held only where the reference decides it by more than
    # the distance tolerance: best < 0.64 second with a margin above 4 atol
    margin = (ref.best_dist - 0.64 * ref.second_dist).abs()
    held = margin > 4 * DIST_ATOL
    same = mm.ratio_test_mask(got) == mm.ratio_test_mask(ref)
    agree = float(same[held].float().mean())
    print(f"[phase1] {label} vs {other}: idx mismatches on decided rows {idx_bad}; "
          f"max |dist err| {err:.3g}; ratio-mask agreement {agree:.6f} on {int(held.sum())} "
          f"rows ({int((~held).sum())} within tolerance of the ratio, "
          f"{int((~same & ~held).sum())} of them differ)", flush=True)
    if idx_bad or not close or agree < MASK_AGREEMENT:
        raise AssertionError(f"phase 1 {label}: the kernel disagrees with {other} "
                             f"(idx {idx_bad}, close {close}, mask agreement {agree})")
    return err


def kernels_a_call(torch, fn, q, t):
    """The names of the device kernels one call of ``fn`` runs (torch.profiler)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn(q, t)
        torch.cuda.synchronize()
    return [ev.name for ev in prof.events()
            if str(getattr(ev, "device_type", "")).endswith("CUDA")]


# phase 1's shapes: label, pairs, N, M, D; the rows planted with exact
# duplicates and near-ties in PLANTED
PHASE1_SHAPES = [("main_path_8x4096", 8, 4096, 4096, 128), ("10k", 1, 10000, 10000, 128),
                 ("ragged_1000x1037", 1, 1000, 1037, 128),
                 ("d64_4x2048x2000", 4, 2048, 2000, 64), ("odd_d96_ragged", 2, 1000, 1037, 96),
                 ("odd_path_d96", 2 * ODD_PATH[0] - 3, ODD_PATH[1], ODD_PATH[1], ODD_PATH[2]),
                 ("cli_default_8x1000", 8, 1000, 1000, 128),
                 ("d256_2x2048x2000", 2, 2048, 2000, 256), ("odd_d160_ragged", 1, 1000, 1037, 160)]
PLANTED = ("ragged_1000x1037", "odd_d160_ragged")
MAX_KERNELS_A_CALL = 2


def phase1(torch, mm, device, card):
    """The matcher on the card against its plain versions and the FMA kernel.
    Returns {label: record} with times, bound and largest error per shape."""
    gen = torch.Generator(device=device).manual_seed(1)
    reps = 5
    out = {}
    product = lambda q, t: torch.matmul(q, t.transpose(-1, -2))  # noqa: E731
    for label, P, N, M, D in PHASE1_SHAPES:
        inputs = []
        for _ in range(reps):
            q = descriptors(gen, P, N, D, device)
            t = descriptors(gen, P, M, D, device)
            if label in PLANTED:
                t[0, 10] = q[0, 3]                      # exact duplicates:
                t[0, 900] = q[0, 3]                     # second == best
                t[0, 500] = q[0, 7]
                near = q[0, 20] + 1e-4 * torch.randn(D, generator=gen, device=device)
                t[0, 21] = near / near.norm()           # near-tie pair
                near = q[0, 20] + 1e-4 * torch.randn(D, generator=gen, device=device)
                t[0, 1036] = near / near.norm()
            inputs.append((q.contiguous(), t.contiguous()))
        name = mm.kernel_for(D)
        times = {}
        order = [("kernel", mm.knn2_cuda), ("fma", mm.knn2_cuda_fma),
                 ("plain", mm.knn2_plain), ("product", product)]
        for key, fn in order + order[::-1]:             # in turns, the better of two
            ms = median_ms(torch, fn, inputs)
            times[key] = min(times.get(key, ms), ms)
        q, t = inputs[0]
        before = (mm.WGMMA_LAUNCHES, mm.FMA_LAUNCHES)
        got = mm.knn2_cuda(q, t)
        torch.cuda.synchronize()
        launched = (mm.WGMMA_LAUNCHES - before[0], mm.FMA_LAUNCHES - before[1])
        if name != "knn2_wgmma" or launched != (1, 0):
            raise AssertionError(f"phase 1 {label}: D={D} must launch the tensor-core kernel "
                                 f"once and the FMA kernel never, counted (tensor-core, FMA) = "
                                 f"{launched} ({name})")
        kernels = kernels_a_call(torch, mm.knn2_cuda, q, t)
        print(f"[phase1] {label}: {len(kernels)} device kernels a call: {kernels}", flush=True)
        if not 1 <= len(kernels) <= MAX_KERNELS_A_CALL or not any("knn2_wgmma" in k
                                                                    for k in kernels):
            raise AssertionError(f"phase 1 {label}: knn2_cuda ran {kernels}; at most "
                                 f"{MAX_KERNELS_A_CALL} kernels, knn2_wgmma among them")
        plain = mm.knn2_plain(q, t)
        err = compare(torch, mm, label, "knn2_plain", got, plain)
        fma = mm.knn2_cuda_fma(q, t)
        fma_err = compare(torch, mm, label + " (FMA kernel)", "knn2_plain", fma, plain)
        compare(torch, mm, label, "knn2_split_plain", got, mm.knn2_split_plain(q, t))
        compare(torch, mm, label, "the FMA kernel", got, fma)
        flop = 2.0 * P * N * M * D
        nbytes = 4.0 * P * (N + M) * D + 12.0 * P * N
        bound_ms = max(flop / TF32_PEAK, nbytes / MEM_PEAK) * 1e3
        bound_by = "operations" if flop / TF32_PEAK >= nbytes / MEM_PEAK else "bytes"
        floor_ms = 3 * flop / TF32_PEAK * 1e3
        print(f"[phase1] {label}: P={P} N={N} M={M} D={D} -> {name} {times['kernel']:.4f} ms "
              f"({flop / times['kernel'] / 1e9:.2f} TFLOP/s); FMA kernel {times['fma']:.4f} ms; "
              f"plain {times['plain']:.4f} ms; torch.matmul (product only, no top-2) "
              f"{times['product']:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} (TF32 tensor "
              f"cores; 3xTF32 floor {floor_ms:.4f} ms; FP32 CUDA cores "
              f"{flop / FP32_CORES_PEAK * 1e3:.4f} ms; memory {nbytes / MEM_PEAK * 1e3:.4f} ms); "
              f"share of bound {bound_ms / times['kernel']:.4f}, of the 3xTF32 floor "
              f"{floor_ms / times['kernel']:.4f}; {len(kernels)} kernels a call [{card}]",
              flush=True)
        if label in PLANTED:
            print(f"[phase1] {label} duplicates: row 3 -> idx {int(got.best_idx[0, 3])} "
                  f"best {float(got.best_dist[0, 3]):.3g} second "
                  f"{float(got.second_dist[0, 3]):.3g}", flush=True)
            if int(got.best_idx[0, 3]) != 10 or float(got.second_dist[0, 3]) != float(
                    got.best_dist[0, 3]):
                raise AssertionError("exact duplicate: lowest index and second == best expected")
        out[label] = {"ms": times["kernel"], "fma_ms": times["fma"], "plain_ms": times["plain"],
                      "library_ms": times["product"], "bound_ms": bound_ms, "bound_by": bound_by,
                      "floor_3xtf32_ms": floor_ms, "kernels_a_call": len(kernels),
                      "max_abs_err": err, "fma_max_abs_err": fma_err}
    return out


def d2i_guess():
    """The 4x4 depth_to_image that phase 4's rig_config.txt gives haz_cam."""
    import numpy as np
    import torch
    from multiview_tpu_torch.geometry import pose as P
    guess = np.eye(4)
    rot = P.quat_to_matrix(P.quat_exp(torch.tensor(D2I_GUESS_ROTVEC, dtype=torch.float64)))
    guess[:3, :3] = D2I_GUESS_SCALE * rot.numpy()
    return guess


def render_workspaces(workdir: Path):
    """The three-sensor workspace, rendered in worker processes, and the
    two-sensor workspace of phase 2 made of the same nav and sci frames."""
    from multiview_tpu_torch.utils import synthetic as syn

    t0 = time.perf_counter()
    rig_true = syn.build_rig_workspace(workdir / "ws3", N_REF, SIZE, FOCAL, depth=True,
                                       depth_to_image_guess=d2i_guess(), workers=7)
    syn.build_rig_workspace(workdir / "ws", N_REF, SIZE, FOCAL, frames_from=workdir / "ws3")
    syn.build_rig_workspace(workdir / "ws_row", ROW_REF, SIZE, FOCAL,
                            frames_from=workdir / "ws3")
    print(f"[render] {3 * N_REF - 2} frames of {SIZE[0]}x{SIZE[1]} ({N_REF - 1} with a .pc "
          f"cloud) in 7 processes, and the two-sensor workspaces ({2 * N_REF - 1} and "
          f"{2 * ROW_REF - 1} frames) from the same frames: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rig_true


def ba_summary(seen):
    lm, cg, mv = (sum(x[i] for x in seen) for i in range(3))
    return (f"BA solves (LM, CG, matvecs) {seen}: {lm} LM iterations, {cg} CG iterations, "
            f"{mv} matvecs run")


def run_calibrate(torch, mm, tag, ws: Path, out: Path, extra, every_pass: bool = True,
                  passes: int = 2, mesh=None):
    """``calibrate`` in process on a rendered workspace, with the launch
    counts set to 0 just before and read just after. Returns what the checks
    read: launches, wall time, the parsed log, the written rig config. The BA
    cost must decrease over the run and rise in no pass; with ``every_pass``
    it must decrease in each of the ``passes`` passes (two unless ``extra``
    sets --calibrator_num_passes). With ``mesh`` the tool runs through
    ``run(args, mesh)``, the library entry that takes a shard mesh."""
    import argparse

    from multiview_tpu_torch.__main__ import main as cli_main
    from bench_torch.rig_calibrate import ba_counts
    from multiview_tpu_torch.io import rig_config as rc
    from multiview_tpu_torch.tools import calibrate as cal_tool

    def cli(argv):
        if mesh is None:
            return cli_main(argv)
        parser = argparse.ArgumentParser()
        cal_tool.add_args(parser)
        return cal_tool.run(parser.parse_args(argv[1:]), mesh=mesh)

    argv = ["calibrate", "--rig_config", str(ws / "rig_config.txt"),
            "--camera_poses", str(ws / "cameras.txt"), "--images", str(ws / "images"),
            "--out_dir", str(out), "--rig_transforms_to_float", "--camera_poses_to_float",
            "--bracket_len", "1.5", "--max_features", "4096", "--num_overlaps", "3",
            "--num_iterations", "20", "--calibrator_num_passes", "2", "--profile"] + extra
    tee = Tee(sys.stdout)
    mm.WGMMA_LAUNCHES = mm.FMA_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with schur_counted(tag, "solve" if mesh is None else "sharded"), ba_counts() as ba, \
            contextlib.redirect_stdout(tee):
        ret = cli(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fma_launches = mm.WGMMA_LAUNCHES, mm.FMA_LAUNCHES
    text = tee.buf.getvalue()
    if ret != 0:
        raise AssertionError(f"{tag}: calibrate returned {ret}")
    nobs = re.search(r"Assembled (\d+) pixel observations of (\d+) points", text)
    depth = re.search(r"Attached (\d+) depth measurements", text)
    run = {
        "launches": launches, "wall": wall, "text": text, "ba": ba,
        "costs": [(float(a), float(b)) for a, b in re.findall(
            r"BA pass \d+: cost (\S+) -> (\S+)", text)],
        "stages": {k: float(v) for k, v in re.findall(r"\[profile\] cli (\S+): (\S+)s", text)},
        "passes": re.findall(r"\[profile\] (pass \d+: .*)", text),
        "tracks": int(re.search(r"Built (\d+) tracks", text).group(1)),
        "pixel_rows": int(nobs.group(1)), "points": int(nobs.group(2)),
        "depth_rows": int(depth.group(1)) if depth else 0,
        "rig": rc.read_rig_config(out / "rig_config.txt")}
    if launches <= 0 or fma_launches != 0:
        raise AssertionError(f"{tag}: the path (D = 128) must launch the tensor-core matcher "
                             f"and only it: counted {launches} and {fma_launches} (FMA)")
    costs = run["costs"]
    if len(costs) != passes or not costs[-1][1] < costs[0][0] or any(b > a for a, b in costs) \
            or (every_pass and any(not b < a for a, b in costs)):
        raise AssertionError(f"{tag}: BA cost did not decrease: {costs}")
    return run


def rig_errors(torch, run, rig_true, names):
    """{sensor: (rotation deg, translation m)} of the written ref_to_sensor
    against the truth; raises beyond 1 deg / 0.05 m."""
    import numpy as np
    from multiview_tpu_torch.geometry import pose as P

    out = {}
    for s in run["rig"].sensors:
        if s.name not in names:
            continue
        est = P.matrix_to_pose(torch.as_tensor(s.ref_to_sensor))
        rel = P.pose_compose(P.pose_inverse(est), torch.as_tensor(rig_true[s.name]))
        rot = float(np.degrees(np.linalg.norm(P.quat_log(P.pose_q(rel)).numpy())))
        trans = float(np.linalg.norm(P.pose_t(rel).numpy()))
        out[s.name] = (round(rot, 4), round(trans, 5))
        if not (rot < 1.0 and trans < 0.05):
            raise AssertionError(f"rig transform of {s.name} off: {rot} deg, {trans} m")
    return out


def phase2(torch, mm, card, workdir: Path, rig_true):
    """Calibrate the two-sensor workspace through the CLI entry."""
    out = workdir / "calib"
    run = run_calibrate(torch, mm, "phase 2", workdir / "ws", out, [], every_pass=False)
    errs = rig_errors(torch, run, rig_true, ("sci_cam",))
    print(f"[phase2] calibrate wall {run['wall']:.2f} s; stages "
          + " ".join(f"{k}={v}s" for k, v in run["stages"].items())
          + f"; tracks {run['tracks']}; pixel observations {run['pixel_rows']} of "
          f"{run['points']} points; costs {run['costs']}; tensor-core matcher launches "
          f"{run['launches']} (FMA kernel 0); rig error (deg, m) {errs} [{card}]", flush=True)
    if abs(run["tracks"] - TRACKS_EXPECTED) > 0.01 * TRACKS_EXPECTED:
        raise AssertionError(f"{run['tracks']} tracks, expected {TRACKS_EXPECTED} within 1%")
    for f in ("rig_config.txt", "cameras.txt"):
        if not (out / f).is_file():
            raise AssertionError(f"missing output {f}")
    return run["launches"]


def depth_alignment(torch, calib: Path, ws: Path, sample: int = 37):
    """How far the haz_cam clouds, lifted to the world through the
    *calibrated* chain (depth_to_image with its scale, refined pose), lie
    from the true terrain: |z - terrain_height(x, y)| over every ``sample``-th
    cloud point, after a similarity alignment of the calibrated camera
    centres to the true ones (a calibration has a free global gauge).
    Returns (points, median m, 95th percentile m)."""
    import numpy as np
    from multiview_tpu_torch.geometry import registration as reg
    from multiview_tpu_torch.io import depth_io, nvm as nvm_io, rig_config as rc
    from multiview_tpu_torch.utils.synthetic import terrain_height

    haz = next(s for s in rc.read_rig_config(calib / "rig_config.txt").sensors
               if s.name == "haz_cam")
    d2i = np.asarray(haz.depth_to_image)
    names, mats = nvm_io.read_camera_poses(calib / "cameras.txt")
    truth = {Path(n).name: M for n, M in zip(*nvm_io.read_camera_poses(ws / "cameras.txt"))}
    centre = lambda M: -M[:3, :3].T @ M[:3, 3]  # noqa: E731
    est_c = torch.as_tensor(np.stack([centre(M) for M in mats]))
    true_c = torch.as_tensor(np.stack([centre(truth[Path(n).name]) for n in names]))
    scale, spose = reg.find_similarity_transform(est_c, true_c)
    res = []
    for n, M in zip(names, mats):
        if Path(n).parent.name != "haz_cam":
            continue
        xyz = depth_io.read_xyz_image(Path(n).with_suffix(".pc")).reshape(-1, 3)[::sample]
        xyz = xyz[np.linalg.norm(xyz, axis=-1) > 1e-6].astype(np.float64)
        cam_pts = xyz @ d2i[:3, :3].T + d2i[:3, 3]
        c2w = np.linalg.inv(M)
        world = reg.apply_similarity(scale, spose, torch.as_tensor(
            cam_pts @ c2w[:3, :3].T + c2w[:3, 3])).numpy()
        res.append(np.abs(world[:, 2] - terrain_height(world[:, 0], world[:, 1])))
    r = np.concatenate(res)
    return len(r), float(np.median(r)), float(np.percentile(r, 95))


def calibrate_with_depth(torch, mm, card, tag, workdir: Path, out: Path, rig_true, extra,
                         mesh=None):
    """``calibrate`` with the depth camera on the three-sensor workspace and
    phase 4's checks; returns the run."""
    import numpy as np
    from bench_torch import checks as bench_checks
    from multiview_tpu_torch.geometry import pose as P

    ws = workdir / "ws3"
    label = tag.replace(" ", "")
    run = run_calibrate(torch, mm, tag, ws, out, [
        "--depth_tri_weight", "25.0", "--float_scale",
        "--depth_to_image_transforms_to_float", "haz_cam", "--save_nvm"] + extra, mesh=mesh)
    errs = rig_errors(torch, run, rig_true, ("sci_cam", "haz_cam"))
    d2i = np.asarray(next(s for s in run["rig"].sensors if s.name == "haz_cam").depth_to_image)
    raw_scale = float(np.linalg.det(d2i[:3, :3]) ** (1.0 / 3.0))
    # in the truth's metres, as the benchmark's check reads it: with floating
    # poses and --float_scale the calibration's world scale is free, and the
    # written scale carries it
    world = bench_checks.gauge(bench_checks.read_camera_poses(out / "cameras.txt"),
                               bench_checks.read_camera_poses(ws / "cameras.txt"))[0]
    scale = raw_scale * world
    rot = P.matrix_to_quat(torch.as_tensor(d2i[:3, :3] / raw_scale))
    rot_deg = float(np.degrees(np.linalg.norm(P.quat_log(rot).numpy())))
    n_pts, med, p95 = depth_alignment(torch, out, ws)
    st = run["stages"]
    print(f"[{label}] calibrate with the depth camera: wall {run['wall']:.2f} s; front end "
          f"{st['frontend_tracks']:.2f} s; BA {st['optimize_rig']:.2f} s; read+scan "
          f"{st['read+scan']:.2f} s; assemble {st['assemble']:.2f} s; tracks {run['tracks']}; "
          f"pixel rows {run['pixel_rows']} of {run['points']} points; depth rows "
          f"{run['depth_rows']}; costs {run['costs']}; tensor-core matcher launches "
          f"{run['launches']} (FMA kernel 0); rig error (deg, m) {errs}; depth_to_image of "
          f"haz_cam from scale {D2I_GUESS_SCALE} / 1.006 deg to scale {scale:.5f} / "
          f"{rot_deg:.4f} deg off the truth (written scale {raw_scale:.5f}, world scale "
          f"{world:.5f}); depth alignment over {n_pts} cloud points: "
          f"median {med:.5f} m, 95th percentile {p95:.5f} m; {ba_summary(run['ba'])} "
          f"[{card}]", flush=True)
    for line in run["passes"]:
        print(f"[{label}] {line}", flush=True)
    if run["depth_rows"] <= 0:
        raise AssertionError(f"{tag}: no depth measurement was attached")
    # measured on an H100: 0.012-0.015% (written: 0.11-0.78%, the world scale
    # 1.001-1.008) and 0.007 deg off; the bars leave a factor of four over
    # the written scale of earlier runs
    if not (abs(scale - 1.0) < 0.005 and rot_deg < 0.1):
        raise AssertionError(f"{tag}: depth_to_image not recovered: scale {scale}, "
                             f"{rot_deg} deg")
    if not med < 0.005:                              # measured: 0.8 mm
        raise AssertionError(f"{tag}: depth clouds {med} m (median) off the terrain")
    for f in ("rig_config.txt", "cameras.txt", "cameras.nvm"):
        if not (out / f).is_file():
            raise AssertionError(f"missing output {f}")
    return run


def phase4(torch, mm, card, workdir: Path, rig_true):
    """``calibrate --sharded`` with the depth camera: depth rows against the
    triangulated points, depth_to_image and its scale floated from a guess
    that is off the truth. On one card ``--sharded`` shards nothing, as the
    reference's does on one chip."""
    with first_row_blocks("rig"), first_assembly_and_cg("rig"), first_lm_step("rig"):
        run = calibrate_with_depth(torch, mm, card, "phase 4", workdir, workdir / "calib3",
                                   rig_true, ["--sharded"])
    sharded = "Sharded observations" in run["text"]
    if sharded != (torch.cuda.device_count() > 1):
        raise AssertionError(f"phase 4: --sharded on {torch.cuda.device_count()} card(s) "
                             f"printed the sharding line: {sharded}")
    return run["launches"]


def ray_cast_check(torch, device, card, tri_np):
    """``ray_mesh_intersect`` in float32 on the card against float64 on the
    card at RAY_CHECK rays x all triangles, and float64 on the card against
    float64 on the CPU on every fifth ray."""
    import numpy as np
    from multiview_tpu_torch.texture import raycast

    g = np.random.default_rng(3)
    o = np.column_stack([g.uniform(-0.5, 4.0, RAY_CHECK), g.uniform(-0.5, 1.5, RAY_CHECK),
                         g.uniform(1.5, 2.5, RAY_CHECK)])
    d = np.column_stack([g.uniform(-0.6, 0.6, (RAY_CHECK, 2)), -np.ones(RAY_CHECK)])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::50, 2] *= -1.0                                   # rays that leave upwards: misses
    kw = dict(min_dist=0.1, max_dist=2.6)                # some hits lie beyond max_dist

    def cast(dev, dtype, sl=slice(None)):
        args = [torch.as_tensor(a[sl], dtype=dtype, device=dev) for a in (o, d)]
        tri = torch.as_tensor(tri_np, dtype=dtype, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = raycast.ray_mesh_intersect(*args, tri, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return [x.cpu() for x in out], time.perf_counter() - t0

    cast(device, torch.float32, slice(0, 256))           # warm-up
    (t32, i32, h32), s32 = cast(device, torch.float32)
    (t64, i64, h64), s64 = cast(device, torch.float64)
    (tc, ic, hc), sc = cast(torch.device("cpu"), torch.float64, slice(None, None, 5))
    if not (torch.equal(h64[::5], hc) and torch.equal(i64[::5], ic)
            and torch.allclose(t64[::5], tc, rtol=1e-12, atol=1e-12)):
        raise AssertionError("phase 4b: float64 ray cast differs between the card and the CPU")
    # a float32 hit flag is held where float64 decides it by a margin: the
    # distance is not within 1e-4 relative of either end of the search window
    edge = ((t64 - kw["min_dist"]).abs() < 1e-4 * t64) | ((t64 - kw["max_dist"]).abs() < 1e-4 * t64)
    decided = ~edge
    flips = int((h32 != h64)[decided].sum())
    both = h32 & h64
    rel = float(((t32.double() - t64).abs() / t64)[both].max())
    same_tri = float((i32 == i64)[both].double().mean())
    pairs = RAY_CHECK * len(tri_np)
    print(f"[phase4b] ray_mesh_intersect {RAY_CHECK} rays x {len(tri_np)} triangles: float32 on "
          f"the card {s32 * 1e3:.1f} ms ({pairs / s32 / 1e9:.2f} G ray-triangle tests/s), "
          f"float64 on the card {s64 * 1e3:.1f} ms, float64 on the CPU (every fifth ray) "
          f"{sc:.1f} s; hits {int(h64.sum())} of {RAY_CHECK}; float64 card == CPU; float32 vs "
          f"float64: hit flags differ on {flips} decided rays ({int((h32 != h64).sum())} in "
          f"all), max relative |dt| {rel:.3g}, same triangle on {same_tri:.6f} of the hits "
          f"[{card}]", flush=True)
    if not 0.5 * RAY_CHECK < int(h64.sum()) < RAY_CHECK:
        raise AssertionError("phase 4b: the ray-cast check needs both hits and misses")
    if flips or not rel < 1e-4:
        raise AssertionError(f"phase 4b: float32 ray cast off: {flips} flags, {rel} relative")
    return s32


def phase4b(torch, mm, device, card, workdir: Path, rig_true):
    """The mesh families: the ray cast alone, then ``calibrate --mesh``."""
    from multiview_tpu_torch.utils import synthetic as syn

    ws, out = workdir / "ws3", workdir / "calib3_mesh"
    n_tri = syn.write_terrain_mesh(ws / "terrain.ply", step=MESH_STEP)
    if n_tri < 100000:
        raise AssertionError(f"the terrain mesh has only {n_tri} triangles")
    verts, faces = syn.terrain_mesh(step=MESH_STEP)
    ray_cast_check(torch, device, card, verts[faces])
    run = run_calibrate(torch, mm, "phase 4b", ws, out, [
        "--depth_tri_weight", "25.0", "--float_scale",
        "--depth_to_image_transforms_to_float", "haz_cam", "--mesh", str(ws / "terrain.ply"),
        "--mesh_tri_weight", "5.0", "--depth_mesh_weight", "10.0", "--max_ray_dist", "10.0"])
    errs = rig_errors(torch, run, rig_true, ("sci_cam", "haz_cam"))
    hits = [int(n) for n in re.findall(r"depth_mesh_x_m: .* \((\d+) residuals\)", run["text"])]
    tri_rows = [int(n) for n in re.findall(r"depth_tri_x_m: .* \((\d+) residuals\)",
                                           run["text"])]
    cast_s = [float(x) for x in re.findall(r"mesh_intersections=(\S+)s", run["text"])]
    print(f"[phase4b] calibrate --mesh ({n_tri} triangles): wall {run['wall']:.2f} s; BA "
          f"{run['stages']['optimize_rig']:.2f} s; mesh_intersections per pass {cast_s} s "
          f"({run['pixel_rows']} rays x {n_tri} triangles); depth rows {run['depth_rows']}; "
          f"inlier depth rows with a mesh hit {hits[-1]} of {tri_rows[-1]}; costs "
          f"{run['costs']}; tensor-core matcher launches {run['launches']}; rig error "
          f"(deg, m) {errs} [{card}]", flush=True)
    for line in run["passes"]:
        print(f"[phase4b] {line}", flush=True)
    if not hits or hits[-1] < 0.9 * tri_rows[-1]:
        raise AssertionError(f"phase 4b: mesh hits for {hits} of {tri_rows} inlier depth rows")
    return run["launches"]


def phase2b(torch, mm, device, card):
    """Descriptors of a width that is neither 64 nor 128 (96: three of the
    tensor-core kernel's 32-dimension slabs), through the front end's batched
    matcher: planted correspondences must come back."""
    from multiview_tpu_torch.sfm import features as feat
    from multiview_tpu_torch.sfm import pipeline as fe

    n_img, k, d = ODD_PATH
    gen = torch.Generator(device=device).manual_seed(2)
    base_desc = descriptors(gen, 1, k, d, device)[0]
    base_xy = torch.rand((k, 2), generator=gen, device=device) * 1000.0
    shift = torch.tensor([7.0, -3.0], device=device)
    kps, descs, perms = [], [], []
    for i in range(n_img):
        perm = torch.randperm(k, generator=gen, device=device)
        noisy = base_desc[perm] + 0.01 * torch.randn((k, d), generator=gen, device=device)
        descs.append((noisy / noisy.norm(dim=-1, keepdim=True)).contiguous())
        xy = base_xy[perm] + i * shift
        kps.append(feat.Keypoints(xy, torch.ones(k, device=device), torch.ones(k, device=device),
                                  torch.zeros(k, device=device),
                                  torch.ones(k, dtype=torch.bool, device=device)))
        perms.append(perm)
    pair_ids = [(i, j) for i in range(n_img) for j in range(i + 1, min(i + 3, n_img))]
    mm.WGMMA_LAUNCHES = mm.FMA_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    matches = fe.match_pairs_batched(kps, descs, pair_ids, fe.FrontendConfig())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fma_launches = mm.WGMMA_LAUNCHES, mm.FMA_LAUNCHES
    found = 0
    for (i, j), (xi, xj) in matches.items():
        off = xj - xi - (j - i) * shift.cpu().numpy()
        if len(xi) and float(abs(off).max()) > 1e-3:
            raise AssertionError(f"phase 2b pair {(i, j)}: a match off the planted shift")
        found += len(xi)
    print(f"[phase2b] {len(pair_ids)} pairs of {k}x{k}x{d} through match_pairs_batched in "
          f"{wall * 1e3:.1f} ms: {found} of {len(pair_ids) * k} planted matches; tensor-core "
          f"kernel launches {launches} (FMA {fma_launches}) [{card}]", flush=True)
    if launches <= 0 or fma_launches != 0:
        raise AssertionError(f"D = {d} must launch the tensor-core kernel and only it: counted "
                             f"{launches} and {fma_launches} (FMA)")
    if found < 0.95 * len(pair_ids) * k:
        raise AssertionError(f"phase 2b: only {found} of {len(pair_ids) * k} planted matches")
    return launches


def ba_problem(torch, dev, n_images: int, n_per_face: int):
    """Phase 3's bundle adjustment (cube scene, float32, poses and the
    intrinsics floating, 10 LM x 30 CG): (scene, start state, solver(**kw)),
    the last building the solver with ``kw`` added to phase 3's settings."""
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.solver import schur
    from multiview_tpu_torch.utils import synthetic as syn

    scene = syn.make_cube_scene(n_images=n_images, n_per_face=n_per_face,
                                dist_coeffs=(-0.1, 0.02, 1e-4, -1e-4), pix_noise=0.5,
                                dtype=torch.float32, device=dev)
    state0 = syn.perturb_state(scene.true_state, pose_rot=0.01, pose_trans=0.02,
                               point_sigma=0.02)
    cam_mask = prob.build_mask(
        state0, prob.FloatSpec(cam_poses=True, focal=(0,), optical_center=(0,),
                               distortion=(0,)), no_rig=True, include_points=False)

    def solver(**kw):
        return schur.make_schur_solver(state0, scene.observations, scene.models,
                                       prob.BAOptions(no_rig=True), cam_mask,
                                       **{**BA_SETTINGS, **kw})
    return scene, state0, solver


def timed_solves(torch, solver, cam0, points0, reps: int = 3):
    """A warm solve, then ``reps`` timed ones: (the last result, the fastest
    wall time, every wall time, peak device memory in GiB)."""
    solver(cam0, points0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = solver(cam0, points0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return res, min(times), times, torch.cuda.max_memory_allocated() / 2 ** 30


def ba_line(res, wall):
    return (f"cost {float(res.initial_cost):.7g} -> {float(res.cost):.7g} in {res.iterations} "
            f"LM iterations ({int(res.cg_iters_total)} CG, {res.matvecs} matvecs run), "
            f"{res.iterations / wall:.3f} LM iterations/s")


def rel_gap(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def phase3(torch, card):
    """Schur LM at the bench's size, float32 on the card: the early-stopped
    CG, then the whole budget forced. Returns the problem and both solves for
    phase 3b."""
    from multiview_tpu_torch.calib import problem as prob

    scene, state0, solver = ba_problem(torch, torch.device("cuda", 0), 160, 20)
    n_obs = sum(len(o) for o in scene.observations.pixels)
    cam0 = prob.pack_state(state0, include_points=False)
    with schur_counted("phase 3"), first_row_blocks("cube"), first_assembly_and_cg("cube"), \
            first_lm_step("cube"):
        res, wall, times, _ = timed_solves(torch, solver(), cam0, state0.points)
        forced, wall_f, times_f, _ = timed_solves(torch, solver(debug_force_cg=30), cam0,
                                                  state0.points)
    # no host sync between an LM iteration's start and its stop test
    with no_sync_inside_lm(torch):
        guarded = solver()(cam0, state0.points)
    torch.cuda.synchronize()
    c0, c1 = float(res.initial_cost), float(res.cost)
    print(f"[phase3] cube 160x20: {n_obs} observations; CG stopped at cg_tolerance "
          f"{BA_SETTINGS['cg_tolerance']} (tested on the device at every step, one launch "
          f"a CG solve): {ba_line(res, wall)}; with every host sync inside an LM iteration "
          f"made an error: {guarded.iterations} LM, {int(guarded.cg_iters_total)} CG; solve times "
          f"{[round(t, 4) for t in times]} s; debug_force_cg=30 (the whole budget): "
          f"{ba_line(forced, wall_f)}, solve times {[round(t, 4) for t in times_f]} s; "
          f"early stop / forced rate {wall_f / wall:.3f}x; final costs "
          f"{c1:.7g} / {float(forced.cost):.7g} [{card}]", flush=True)
    if not (c1 == c1 and c1 < c0):
        raise AssertionError(f"phase 3 cost not finite and decreasing: {c0} -> {c1}")
    if not res.matvecs == int(res.cg_iters_total):
        raise AssertionError(f"phase 3: {res.matvecs} matvecs run for {int(res.cg_iters_total)} "
                             f"CG iterations in {res.iterations} LM iterations")
    if not (forced.matvecs == int(forced.cg_iters_total) == 30 * forced.iterations):
        raise AssertionError(f"phase 3: debug_force_cg=30 ran {forced.matvecs} matvecs")
    return {"problem": (scene, state0, solver), "res": res, "forced": forced}


def phase3b(torch, card, p3):
    """The four linear solvers on phase 3's problem and settings."""
    from multiview_tpu_torch.calib import problem as prob

    scene, state0, solver = p3["problem"]
    cam0 = prob.pack_state(state0, include_points=False)
    for mode in ("cg_blocks", "cg", "cg_dense_j", "dense_schur"):
        with schur_counted("phase 3b" if mode == "cg_blocks" else f"phase 3b ({mode})",
                           {"cg_blocks": "solve", "dense_schur": "dense"}.get(mode, "steps")):
            res, wall, times, peak = timed_solves(torch, solver(linear_solver=mode), cam0,
                                                  state0.points, reps=2)
        # dense_schur solves each step exactly: its trajectory is the one of
        # CG run to the whole budget, not of CG stopped at cg_tolerance 0.1
        ref = p3["forced"] if mode == "dense_schur" else p3["res"]
        gap = rel_gap(res.cost, ref.cost)
        print(f"[phase3b] {mode}: {ba_line(res, wall)}, solve times "
              f"{[round(t, 4) for t in times]} s, peak {peak:.2f} GiB; final cost "
              f"{gap:.3g} relative from {'the forced-budget' if mode == 'dense_schur' else 'the'}"
              f" cg_blocks solve [{card}]", flush=True)
        if not (gap <= SHARDED_COST_RTOL and float(res.cost) < float(res.initial_cost)):
            raise AssertionError(f"phase 3b: {mode} ends at {float(res.cost)}, {gap:.3g} "
                                 f"relative from cg_blocks (bar {SHARDED_COST_RTOL})")
        if mode == "dense_schur" and not (res.matvecs == 0 == int(res.cg_iters_total)):
            raise AssertionError("phase 3b: dense_schur ran CG")


def schur_work(system):
    """(bytes, operations) of one S x: every input read once (the camera and
    point blocks of the families with a camera block, their int64 indices,
    x, cam_free, dc, Hpp^-1) and the output written once; its
    multiply-adds."""
    item = system.cam_free.element_size()
    nbytes = item * (4 * system.total + 9 * system.num_points)
    flop = 18 * system.num_points + 3 * system.total
    for fams, (jc, jp) in zip(system.shards, system.J):
        for a, b in zip(jc, jp):
            if a is None:
                continue
            n, k, B = a.shape
            nbytes += item * a.numel() + 8 * (2 * n + B - 14)
            flop += 4 * n * k * B
            if b is not None:
                nbytes += item * b.numel() + 8 * n
                flop += 12 * n * k
    return nbytes, flop


def schur_bound(system):
    """(bound ms, "bytes" | "operations") of one S x: ``schur_work``'s
    bytes over the memory rate, its operations over the FP32 rate."""
    nbytes, flop = schur_work(system)
    t_bytes, t_ops = nbytes / MEM_PEAK, flop / FP32_CORES_PEAK
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def graphed(torch, fn, repeat: int = 1):
    """``fn`` captured in a CUDA graph (warmed on a side stream first),
    ``repeat`` calls of it back to back: returns the replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(repeat):
            fn()
    return graph.replay


def per_call_ms(torch, fn, reps: int = 50):
    """Device time per call of ``reps`` calls back to back (CUDA events):
    where the host enqueues slower than the card runs, the host's time."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def schur_design_bytes(system, record):
    """Bytes one S x of csrc/schur_mv.cu moves by its design: every row's J_c,
    J_p and indices read in the point pass, u written there and read back,
    and the rows that did not stay in shared memory read again in the camera
    pass (an upper bound of the device-memory traffic: part of the rereads
    come from L2)."""
    item = system.cam_free.element_size()
    rows = per_row = u_bytes = 0
    for a, b in zip(*system.J[0]):
        if a is not None:
            n, k, B = a.shape
            rows += n
            per_row += n * (item * k * B + 16 + (item * k * 3 + 8 if b is not None else 0))
            u_bytes += 2 * n * k * item
    mean = per_row / max(rows, 1)
    return int(per_row + u_bytes + mean * (rows - record.get("resident_rows", 0)))


def phase3c(torch, card):
    """The Schur matvec kernel (csrc/schur_mv.cu) against its plain version
    on the systems phases 3 and 4 handed it first: the benchmark's cube at
    384000 rows, and calibrate's three sensors with depth rows. Per matvec:
    the launches (one, cooperative, on one shard), the launch's shape, the
    bytes its design reads (``schur_design_bytes``), then the times of the
    kernel, the plain version, the plain version replayed from a CUDA graph
    (the launch overhead a graph removes is not the kernel's gain), the
    kernel from a graph (its device time alone, where the cooperative launch
    can be captured), and the bound; then the kernel as the LM loop launches
    it, its blocks in the halves (``halved``: half 1 read through the
    selector), held to the plain version alike and timed eager and from a
    graph. Returns the records by system."""
    import dataclasses
    from multiview_tpu_torch.solver import schur_matvec as smv

    out = {}
    for label in ("cube", "rig"):
        # the first system the path's CG solved, x its first search direction
        system, g_c, g_p, M = SOLVE_CALLS[label][:4]
        x = M.apply(smv.schur_rhs_plain(system, g_c, g_p))
        fams = [(tuple(a.shape), b is not None) for a, b in zip(*system.J[0]) if a is not None]
        before, smv.RECORD_LAUNCH = smv.LAUNCHES, True
        try:
            got = smv.schur_matvec_cuda(system, x)
            torch.cuda.synchronize()
            launch = dict(smv.LAST_LAUNCH)
        finally:
            smv.RECORD_LAUNCH = False
        launches = smv.LAUNCHES - before
        if system.mesh.size == 1 and not (launches == 1 and launch["passes"] == 3):
            raise AssertionError(f"phase 3c {label}: S x took {launches} launches "
                                 f"({launch}), not one launch of both passes")
        design_bytes = schur_design_bytes(system, launch)
        ref = smv.schur_matvec_plain(system, x)
        g_p = torch.randn((system.num_points, 3), dtype=x.dtype, device=x.device)
        rhs = (smv.schur_rhs_cuda(system, x, g_p), smv.schur_rhs_plain(system, x, g_p))
        rows = (smv.row_products_cuda(system, x), smv.row_products_plain(system, x))
        Jh, _, hh = halved(torch, system.J)
        sys_h = dataclasses.replace(system, J=Jh, halves=hh, _plans=None)
        got_h = smv.schur_matvec_cuda(sys_h, x)
        torch.cuda.synchronize()
        errs = {"matvec": (got - ref, ref), "matvec_sel": (got_h - ref, ref),
                "rhs": (rhs[0] - rhs[1], rhs[1]),
                "u": (torch.cat(rows[0][0]) - torch.cat(rows[1][0]), torch.cat(rows[1][0])),
                "J_p^T u": (rows[0][1] - rows[1][1], rows[1][1])}
        rel = {k: float(d.abs().max()) / max(float(r.abs().max()), 1e-30)
               for k, (d, r) in errs.items()}
        err = float((got - ref).abs().max())
        runs = [("kernel", lambda: smv.schur_matvec_cuda(system, x)),
                ("plain", lambda: smv.schur_matvec_plain(system, x)),
                ("plain_graph", graphed(torch, lambda: smv.schur_matvec_plain(system, x)))]
        graph_note = ""
        runs.append(("kernel_sel", lambda: smv.schur_matvec_cuda(sys_h, x)))
        try:
            runs.append(("kernel_graph", graphed(torch, lambda: smv.schur_matvec_cuda(system, x))))
            runs.append(("kernel_sel_graph",
                         graphed(torch, lambda: smv.schur_matvec_cuda(sys_h, x))))
        except Exception as e:          # a cooperative launch the capture refuses is reported
            torch.cuda.synchronize()
            graph_note = f" (kernel not captured in a CUDA graph: {type(e).__name__}: " \
                         f"{str(e).splitlines()[0][:160]})"
        times = {}
        for key, fn in runs + runs[::-1]:                # in turns, the better of two
            ms = per_call_ms(torch, fn)
            times[key] = min(times.get(key, ms), ms)
        sel_text = " ".join(f"{times[k] * 1e3:.1f}" if k in times else "not measured"
                            for k in ("kernel_sel", "kernel_sel_graph"))
        bound_ms, bound_by = schur_bound(system)
        kg = times.get("kernel_graph")
        kg_text = (f"{kg * 1e3:.1f}" if kg else "not measured") + graph_note
        share_graph = f"{bound_ms / kg:.4f}" if kg else "not measured"
        print(f"[phase3c] {label}: {system.mesh.size} shard(s), families with a camera block "
              f"(shape, point block) {fams}, {system.num_points} points, {system.total} "
              f"camera parameters, {x.dtype}: {launches} launch(es) a matvec, cooperative "
              f"grid {launch['grid']} x {launch['threads']} threads, {launch['tile_rows']} rows "
              f"a tile, {launch['slots']} slots, {launch['resident_rows']} rows kept in shared "
              f"memory between the passes, pose window {launch['window_poses']} of "
              f"{system.num_ref} ({launch['pose_copies']} copies), x in shared memory "
              f"{bool(launch['x_in_shared'])}; the design "
              f"reads {design_bytes / 1e6:.2f} MB a matvec; us per matvec kernel "
              f"{times['kernel'] * 1e3:.1f}, plain {times['plain'] * 1e3:.1f}, plain from a "
              f"CUDA graph {times['plain_graph'] * 1e3:.1f}, kernel from a CUDA graph "
              f"{kg_text}, through the LM loop's selector (half 1 of the halves read) eager "
              f"and from a graph {sel_text}, bound {bound_ms * 1e3:.1f} by {bound_by} "
              f"(share of bound {bound_ms / times['kernel']:.4f}; from a graph "
              f"{share_graph}); kernel against plain, max |diff| / "
              f"max |plain|: {', '.join(f'{k} {v:.3g}' for k, v in rel.items())} [{card}]",
              flush=True)
        if not all(v <= SCHUR_RTOL for v in rel.values()):
            raise AssertionError(f"phase 3c {label}: the Schur kernel disagrees with its plain "
                                 f"version: {rel} (bar {SCHUR_RTOL})")
        out[label] = {"ms": times["kernel"], "plain_ms": times["plain"],
                      "plain_graph_ms": times["plain_graph"],
                      "kernel_graph_ms": times.get("kernel_graph"), "bound_ms": bound_ms,
                      "bound_by": bound_by, "max_abs_err": err, "library_ms": None,
                      "sel_ms": times["kernel_sel"], "sel_graph_ms": times.get("kernel_sel_graph"),
                      "launches_a_matvec": launches, "launch": launch,
                      "design_bytes": design_bytes}
    return out


def ptxas_report(source: str):
    """{mangled kernel: (registers, spill store bytes, spill load bytes, stack
    frame bytes)} from this process's nvcc -Xptxas -v report of ``source``."""
    from multiview_tpu_torch.utils import cuda_build
    text = cuda_build.build_reports.get(source, (0.0, ""))[1]
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = [None, None, None, None]
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and cur:
            out[cur][1:] = [int(m.group(2)), int(m.group(3)), int(m.group(1))]
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def row_family(torch, kind, args):
    """(label, kernel symbol, tensors read, the entry points' arguments) of a
    row-block family caught from a path (``first_row_blocks``)."""
    from multiview_tpu_torch.solver import row_blocks as rb
    st, obs = args[0], args[1]
    t = "f" if st.dtype == torch.float32 else "d"
    if kind == "pixel":
        model, s = args[2], obs.sensor
        d = int(st.dist[s].numel())
        code = rb.model_code(model, d)
        reads = [st.world_to_ref, st.points, obs.beg_idx, obs.end_idx, obs.point_idx, obs.pix,
                 obs.dt_cam, obs.dt_bracket, obs.mask, st.ref_to_cam[s], st.optical_center[s],
                 st.dist[s], obs.dist_half_size, st.focal[s], st.timestamp_offsets[s]]
        return (f"pixel sensor {s} ({model} {d})", f"12pixel_kernelI{t}Li{code}EE", reads)
    if kind == "depth":
        opts, mesh, s = args[2], args[3], obs.sensor
        a = int(opts.affine_depth_to_image)
        reads = [st.world_to_ref, obs.beg_idx, obs.end_idx, obs.dt_cam, obs.dt_bracket, obs.mask,
                 obs.depth_xyz, st.ref_to_cam[s], st.depth_to_image[s], st.depth_scale[s],
                 st.timestamp_offsets[s]]
        reads += ([obs.mesh_xyz] + ([obs.mesh_mask] if obs.mesh_mask is not None else [])
                  if mesh else [st.points, obs.point_idx])
        return (f"depth sensor {s} ({'mesh' if mesh else 'triangulated'}, "
                f"{'affine' if a else 'pose'})", f"12depth_kernelI{t}Lb{a}ELb{int(mesh)}EE",
                reads)
    return ("xyz prior", f"12prior_kernelI{t}EE", [st.points, obs.point_idx, obs.ref_xyz,
                                                   obs.mask])


# The FLOPs of the function the row blocks kernel computes, a row: the value
# V of the robustified residual as the plain version (solver/row_blocks.py)
# computes it, branches as this call's rows take them (an add, multiply,
# divide, square root or transcendental counts 1), and its reverse-mode
# Jacobian, k sweeps back through the value's graph at 2 FLOPs a forward
# operation: V (1 + 2k). V's parts, counted from the code: a quaternion
# normalised on read 12; a vector rotated 30; pose_apply 45;
# world_to_cam_from_bracket 161 (alpha 2, the translation's lerp 10, two
# normalisations 24, slerp 40, the rig composed 85), 87 fewer where
# dt_bracket == 0 (alpha 0, no rig) and 8 fewer on slerp's lerp branch;
# pixel rows: pose_apply 45, the projection 4, the distortion (none 4, fov
# 22 on its ru > 1e-5 branch, tsai 36 or 40 with k3, rpc of degree g with n
# numerator and n - 1 denominator monomials 5n + 4(n - 1) + 2g + 2), the
# residual 4, the Cauchy weight and mask 11 (counted on every row); depth
# rows: depth_to_image 51 as a pose with its scale (9 affine), the camera
# point 18, the pose inverted 42, pose_apply 45, the residual 6, the weight
# 14; xyz priors: the residual 6 and the Cauchy weight 14 (th > 0) or the
# mask 3.
def row_block_flops(torch, kind, args) -> int:
    from multiview_tpu_torch.geometry import distortion as dist_mod
    st, obs = args[0], args[1]
    if kind == "prior":
        return (6 + (14 if args[3] > 0 else 3)) * 7 * int(obs.point_idx.shape[0])
    n = len(obs)
    q0, q1 = (st.world_to_ref[i, 3:] for i in (obs.beg_idx, obs.end_idx))
    dot = ((q0 / q0.norm(dim=-1, keepdim=True)) * (q1 / q1.norm(dim=-1, keepdim=True))).sum(-1)
    lerp = int((dot.abs() > 1 - 16 * torch.finfo(st.dtype).eps).sum())
    value = 161 * n - 87 * int((obs.dt_bracket == 0).sum()) - 8 * lerp
    if kind == "pixel":
        model, d = args[2], int(st.dist[obs.sensor].numel())
        if model == "rpc":
            g = dist_mod.rpc_degree_from_num_params(d // 2)
            m = (g + 1) * (g + 2) // 2
            dist = 5 * m + 4 * (m - 1) + 2 * g + 2
        else:
            dist = {"none": 4, "fov": 22, "tsai": 36 if d == 4 else 40}[model]
        return (value + n * (45 + 4 + dist + 4 + 11)) * (1 + 2 * 2)
    affine = args[2].affine_depth_to_image
    return (value + n * ((9 if affine else 51) + 18 + 42 + 45 + 6 + 14)) * (1 + 2 * 3)


def row_rel(got, ref):
    """max |kernel - plain| / max |plain| of each output (J_cam, J_pt, res)."""
    out = {}
    for name, g, r in zip(("J_cam", "J_pt", "res"), got, ref):
        if (g is None) != (r is None):
            raise AssertionError(f"phase 3d: {name} is None on one side only")
        if r is not None:
            if g.shape != r.shape or not bool(g.isfinite().all()):
                raise AssertionError(f"phase 3d: {name} has shape {tuple(g.shape)} (plain "
                                     f"{tuple(r.shape)}) or a value that is not finite")
            out[name] = float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
    return out


def phase3d(torch, card):
    """The row blocks kernel (csrc/row_blocks.cu) against its plain version
    (autograd) on every family that phases 3 (the benchmark's cube, 384000
    rows) and 4 (calibrate's three sensors with depth rows) handed the solver
    first, on the cube's rows with an rpc of degree 2 in place of tsai, then
    on the planted rows of tests/row_block_scenes.py in float32 and float64.
    The reference is the plain version in float64 on the same inputs: the
    kernel computes in float64 and rounds its float32 outputs, while the
    plain version's own float32 results err by up to a few 1e-4 of max |res|
    on calibrate's families (printed beside). Per family: the error of each
    output over max |plain| (float32 tensors at SCHUR_RTOL, the same family
    in float64 at ROW_RTOL_F64), ms a call of the kernel, the plain version
    (both float32, the main path's dtype), the plain version replayed from a
    CUDA graph (or why it was not captured) and the kernel from a graph (a
    capture of the kernel that fails is a fault), the bound (the bytes read
    and written once over 3.35 TB/s, or the FLOPs of ``row_block_flops``
    over the FP32 rate) with its share, and the registers and spills of the
    family's kernel. Each family of phases 3 and 4 is also launched as the LM
    loop binds it (a ``RowLaunch`` over the path's own halves, reading half
    1 through the selector): its outputs bit for bit the entry point's on
    that half's state, its time eager and from a graph. Returns the
    records."""
    import dataclasses
    from multiview_tpu_torch.solver import row_blocks as rb
    sys.path.insert(0, str(ROOT / "tests"))
    import row_block_scenes as rbs

    entry = {"pixel": (rb.pixel_row_blocks_cuda, rb.pixel_row_blocks_plain),
             "depth": (rb.depth_row_blocks_cuda, rb.depth_row_blocks_plain),
             "prior": (rb.prior_row_blocks_cuda, rb.prior_row_blocks_plain)}
    regs = ptxas_report("row_blocks.cu")
    launchers = {"pixel": rb.pixel_row_launch, "depth": rb.depth_row_launch,
                 "prior": rb.prior_row_launch}
    families = [(path, kind, args, ROW_HALVES[path][tag]) for path in ("cube", "rig")
                for tag, args in ROW_CALLS[path].items() for kind in [tag[0]]]
    st, obs, _, opts = next(a for path, kind, a, _ in families
                            if path == "cube" and kind == "pixel")
    dist = list(st.dist)
    dist[obs.sensor] = torch.tensor(rbs.rpc_coeffs(2), dtype=st.dtype,
                                    device=st.world_to_ref.device)
    families.append(("cube-rpc", "pixel", (dataclasses.replace(st, dist=tuple(dist)), obs, "rpc",
                                           opts), None))
    out = {"families": {}}
    for path, kind, args, bound in families:
        kernel, plain = entry[kind]
        label, symbol, reads = row_family(torch, kind, args)
        args64 = rbs.in_float64(args)
        got, ref, ref32, got64 = (((None,) if kind == "prior" else ()) + tuple(fn(*a))
                                  for fn, a in ((kernel, args), (plain, args64),
                                                (plain, args), (kernel, args64)))
        torch.cuda.synchronize()
        rel, rel64 = row_rel(got, ref), row_rel(got64, ref)
        plain_own, against_f32 = row_rel(ref32, ref), row_rel(got, ref32)
        err = max(float((g.double() - r).abs().max()) for g, r in zip(got, ref)
                  if r is not None)
        runs = [("kernel", lambda: kernel(*args)), ("plain", lambda: plain(*args)),
                ("kernel_graph", graphed(torch, lambda: kernel(*args)))]
        sel_same = None
        if bound is not None:
            # as the LM loop launches it: half 1 of the path's halves read
            outs, hh = bound
            rl = launchers[kind](*args, outs, hh)
            flip = 1 ^ int(hh.st.sel)
            rl(None, flip)
            want = kernel(row_state_at(hh, args[0], 1), *args[1:])
            torch.cuda.synchronize()
            sel_same = all(torch.equal(hh.pair(o)[1], w) for o, w in zip(outs, want)
                           if o is not None)
            runs += [("kernel_sel", lambda: rl(None, flip)),
                     ("kernel_sel_graph", graphed(torch, lambda: rl(None, flip)))]
        graph_note = ""
        try:
            runs.append(("plain_graph", graphed(torch, lambda: plain(*args))))
        except Exception as e:          # autograd that cannot be captured is reported
            torch.cuda.synchronize()
            graph_note = f"; plain not captured in a CUDA graph: {type(e).__name__}: " \
                         f"{str(e).splitlines()[0][:160]}"
        times = {}
        for key, fn in runs + runs[::-1]:            # in turns, the better of two
            ms = per_call_ms(torch, fn, reps=20)
            times[key] = min(times.get(key, ms), ms)
        nbytes = sum(t.numel() * t.element_size() for t in reads + [x for x in got
                                                                    if x is not None])
        flops = row_block_flops(torch, kind, args)
        t_bytes, t_ops = nbytes / MEM_PEAK * 1e3, flops / FP32_CORES_PEAK * 1e3
        bound_ms, bound_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                                   else "operations")
        found = [v for k, v in regs.items() if symbol in k]
        rec = {"path": path, "rows": int(got[-1].shape[0]), "dtype": str(got[-1].dtype),
               "B": None if got[0] is None else int(got[0].shape[2]),
               "ms": times["kernel"], "plain_ms": times["plain"],
               "plain_graph_ms": times.get("plain_graph"),
               "kernel_graph_ms": times["kernel_graph"], "bound_ms": bound_ms,
               "bound_by": bound_by, "bytes": nbytes, "flops": flops,
               "max_abs_err": err, "rel": rel, "rel_float64": rel64,
               "plain_float32_rel": plain_own, "rel_to_plain_float32": against_f32,
               "library_ms": None, "sel_ms": times.get("kernel_sel"),
               "sel_graph_ms": times.get("kernel_sel_graph"), "sel_bit_for_bit": sel_same,
               "registers_spills_stack": found[0] if found else None}
        plain_graph = (f"plain from a CUDA graph {rec['plain_graph_ms']:.4f}"
                       if rec["plain_graph_ms"] is not None else "plain not graphed")
        fmt = lambda d: ", ".join(f"{k} {v:.3g}" for k, v in d.items())   # noqa: E731
        print(f"[phase3d] {path} {label}: {rec['rows']} rows, B = {rec['B']}, "
              f"{rec['dtype']}; max |diff| / max |plain in float64|: kernel {fmt(rel)} "
              f"(in float64: {fmt(rel64)}); the plain version in float32 {fmt(plain_own)}; "
              f"kernel against plain in float32 {fmt(against_f32)}; ms a call: kernel "
              f"{rec['ms']:.4f}, plain {rec['plain_ms']:.4f}, {plain_graph}, kernel from a "
              f"CUDA graph {rec['kernel_graph_ms']:.4f}{graph_note}"
              + (f", through the LM loop's selector (half 1 of the path's halves; bit for bit "
                 f"the entry point's: {sel_same}) {rec['sel_ms']:.4f}, from a graph "
                 f"{rec['sel_graph_ms']:.4f}" if bound is not None else "")
              + f"; bound {bound_ms:.4f} ms "
              f"by {bound_by} ({nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP), share "
              f"{bound_ms / rec['ms']:.4f}; registers, spill stores and loads, stack (bytes) of "
              f"{symbol}: {found[0] if found else 'not in the build report'} [{card}]",
              flush=True)
        if sel_same is False:
            raise AssertionError(f"phase 3d {path} {label}: the row blocks launched through the "
                                 f"LM loop's selector differ from the entry point's on that half")
        if not (all(v <= SCHUR_RTOL for v in rel.values())
                and all(v <= ROW_RTOL_F64 for v in rel64.values())):
            raise AssertionError(f"phase 3d {path} {label}: the row blocks kernel disagrees "
                                 f"with its plain version: {rel} (bar {SCHUR_RTOL}), in "
                                 f"float64 {rel64} (bar {ROW_RTOL_F64})")
        out["families"][f"{path} {label}"] = rec
        if path == "cube":
            out.setdefault("cube", rec)
    kernel = {k: v[0] for k, v in entry.items()}
    plain = {k: v[1] for k, v in entry.items()}
    for dtype, tol in ((torch.float32, SCHUR_RTOL), (torch.float64, ROW_RTOL_F64)):
        worst = {}
        for name, case in rbs.planted_rows(0, dtype, torch.device("cuda", 0)).items():
            rel = row_rel(rbs.row_blocks_of(case, kernel),
                          rbs.row_blocks_of(case, plain, float64=True))
            worst[name] = max(rel.values())
            if not all(v <= tol for v in rel.values()):
                raise AssertionError(f"phase 3d planted {name} {dtype}: the row blocks kernel "
                                     f"disagrees with its plain version: {rel} (bar {tol})")
        print(f"[phase3d] planted rows, {dtype}: worst max |diff| / max |plain in float64| by "
              f"case {json.dumps({k: float(f'{v:.3g}') for k, v in worst.items()})} (bar {tol}) "
              f"[{card}]", flush=True)
    print(f"[phase3d] ptxas (registers, spill stores, spill loads, stack) of every kernel of "
          f"csrc/row_blocks.cu: {json.dumps(regs)}", flush=True)
    return out


def row_state_at(h, state, half: int):
    """``state`` (a ``RigState`` of half-0 arrays of the halves ``h``) read in
    half ``half``."""
    import dataclasses

    def pick(t):
        return h.pair(t)[half] if t.numel() else t
    return dataclasses.replace(state, **{
        f.name: (tuple(pick(t) for t in v) if isinstance(v, tuple) else pick(v))
        for f in dataclasses.fields(state) for v in [getattr(state, f.name)]})


def in64(torch, x):
    """Tensors (in lists, tuples, NamedTuples) in float64; the rest as it is."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(in64(torch, v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(in64(torch, v) for v in x)
    return x


def rel_err(got, ref):
    """max |got - ref| / max |ref| (ref in float64)."""
    return float((got.double() - ref).abs().max()) / max(float(ref.abs().max()), 1e-300)


def assembly_bound(args):
    """(bound ms, "bytes" | "operations", bytes) of one assembly: every input
    read once (the camera and point blocks, the residuals where the gradient
    is asked, the int64 indices, cam_free, lam), every output written once
    (g_c, g_p where asked, Hpp, pt_diag, Hpp^-1, the diagonal, dc, the
    preconditioner, the 7x7 inverses where asked), over the memory rate; its
    operations over the FP32 rate: a camera row 4 k B (gradient and
    diagonal), a point row 18 k, a SCHUR_JACOBI row and side 2 (7 + 28 + 21)
    k + 294, a point 60, a pose 2 7^3."""
    mesh, shards, J, r, cam_free, lam, num_ref, num_points, block = args[:9]
    item = cam_free.element_size()
    C, P, R = cam_free.shape[0], num_points, num_ref
    nbytes = item * (C + 1 + 4 * C + 24 * P + (C + 3 * P if r is not None else 0)
                     + (49 * R if block else 0))
    flop = 60 * P + (2 * 343 * R if block else 0)
    for s, (fams, (jc, jp)) in enumerate(zip(shards, J)):
        if r is not None:
            nbytes += item * r[s].numel()
        for a, b in zip(jc, jp):
            if a is not None:
                n, k, B = a.shape
                nbytes += item * a.numel() + 8 * (2 * n + B - 14)
                flop += 4 * n * k * B + (2 * (2 * (7 + 28 + 21) * k + 294) * n if block else 0)
            if b is not None:
                n, k, _ = b.shape
                nbytes += item * b.numel() + 8 * n
                flop += 18 * n * k
    t_bytes, t_ops = nbytes / MEM_PEAK * 1e3, flop / FP32_CORES_PEAK * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def pass_times_us(marks, grid: int, passes: int):
    """{pass: us} from the assembly kernel's %globaltimer stamps (a row a
    block: its start, the end of each pass it ran): the launch's spread of
    block starts, then each pass from the last block to leave the one
    before to the last block to leave it (the grid barrier between them
    included)."""
    m = marks[:grid].cpu()
    names = [n for bit, n in ((1, "rows"), (2, "points"), (4, "blocks"), (8, "poses"))
             if passes & bit]
    cols = [c for bit, c in ((1, 1), (2, 2), (4, 3), (8, 4)) if passes & bit]
    out = {"block_start_spread": (int(m[:, 0].max()) - int(m[:, 0].min())) / 1e3}
    last = int(m[:, 0].min())
    for n, c in zip(names, cols):
        end = int(m[:, c].max())
        out[n] = (end - last) / 1e3
        last = end
    return out


def phase3e(torch, card):
    """The assembly kernel (csrc/lm_assembly.cu) against its plain version on
    the first assembly of phase 3's solve (the benchmark's cube, 384000 rows,
    jacobi) and of phase 4's (calibrate's four families, SCHUR_JACOBI). The
    reference is the plain version in float64 on the same inputs (the kernel
    computes in float64 and rounds its outputs); every output (g_c, g_p, Hpp,
    the Jacobi diagonal, pt_diag, Hpp^-1, dc, the preconditioner, the 7x7
    inverses) within SCHUR_RTOL of its max |plain| with the path's float32
    tensors and ROW_RTOL_F64 with them in float64, beside the plain float32
    version's own error. Per assembly: the launches (one on one shard), the
    launch's shape (the warps' pose window, rows a tile, slots, the rows the
    blocks pass found in shared memory, the bytes of rows read from device
    memory), each pass's time from the kernel's own %globaltimer stamps, ms
    of the kernel through an ``AssemblyPlan`` (the LM loop's call: the table
    refreshed, the buffers reused) and without one (table and buffers built
    by the call), the plain version, both from a CUDA graph where they can be
    captured, the bound (``assembly_bound``) and its share, the kernel's
    registers, spills and stack; then the kernel as the LM loop launches it,
    J and r in the halves (``halved``: half 1 read through the selector),
    held to the plain version alike and timed through a plan, eager and from
    a graph. Returns the records by system."""
    from multiview_tpu_torch.solver import assembly as asm

    regs = {k: v for k, v in ptxas_report("lm_assembly.cu").items() if "assembly_kernel" in k}
    out = {}
    for label in ("cube", "rig"):
        args = ASM_CALLS[label][:9]
        mesh, shards, J, r, cam_free, lam, num_ref, num_points, block = args
        args64 = tuple(in64(torch, a) for a in args)
        for _ in range(3):          # warm: the first launches load the module
            asm.assemble_cuda(*args)
        torch.cuda.synchronize()
        before, asm.RECORD_LAUNCH, asm.RECORD_MARKS = asm.LAUNCHES, True, True
        try:
            got = asm.assemble_cuda(*args)
            torch.cuda.synchronize()
            launch, marks = dict(asm.LAST_LAUNCH), asm.LAST_MARKS
        finally:
            asm.RECORD_LAUNCH = asm.RECORD_MARKS = False
        launches = asm.LAUNCHES - before
        if mesh.size == 1 and launches != 1:
            raise AssertionError(f"phase 3e {label}: the assembly took {launches} launches")
        passes_us = pass_times_us(marks, launch["grid"], launch["passes"])
        ref, ref32 = asm.assemble_plain(*args64), asm.assemble_plain(*args)
        got64 = asm.assemble_cuda(*args64)
        torch.cuda.synchronize()
        names = [n for n, v in zip(ref._fields, ref) if v is not None]
        for n in ref._fields:
            g = getattr(got, n)
            if (g is None) != (getattr(ref, n) is None) or (
                    g is not None and not bool(torch.isfinite(g).all())):
                raise AssertionError(f"phase 3e {label}: {n} is None on one side only or "
                                     f"not finite")
        rel = {n: rel_err(getattr(got, n), getattr(ref, n)) for n in names}
        Jh, rh, hh = halved(torch, J, r)
        args_h = (mesh, shards, Jh, rh) + args[4:]
        plan_h, plan_hg = asm.AssemblyPlan(), asm.AssemblyPlan()
        got_h = plan_h(*args_h, halves=hh)
        torch.cuda.synchronize()
        rel.update({f"{n} (sel)": rel_err(getattr(got_h, n), getattr(ref, n)) for n in names})
        rel64 = {n: rel_err(getattr(got64, n), getattr(ref, n)) for n in names}
        plain_own = {n: rel_err(getattr(ref32, n), getattr(ref, n)) for n in names}
        err = max(float((getattr(got, n).double() - getattr(ref, n)).abs().max())
                  for n in names)
        plan, plan_g = asm.AssemblyPlan(), asm.AssemblyPlan()
        runs = [("kernel", lambda: plan(*args)),
                ("kernel_unplanned", lambda: asm.assemble_cuda(*args)),
                ("plain", lambda: asm.assemble_plain(*args)),
                ("kernel_sel", lambda: plan_h(*args_h, halves=hh))]
        notes = []
        for key, fn in (("plain_graph", lambda: asm.assemble_plain(*args)),
                        ("kernel_graph", lambda: plan_g(*args)),
                        ("kernel_sel_graph", lambda: plan_hg(*args_h, halves=hh))):
            try:
                runs.append((key, graphed(torch, fn)))
            except Exception as e:      # a capture that fails is reported
                torch.cuda.synchronize()
                notes.append(f"{key} not captured: {type(e).__name__}: "
                             f"{str(e).splitlines()[0][:160]}")
        times = {}
        for key, fn in runs + runs[::-1]:            # in turns, the better of two
            ms = per_call_ms(torch, fn, reps=20)
            times[key] = min(times.get(key, ms), ms)
        bound_ms, bound_by, nbytes = assembly_bound(args)
        rows = sum((b if a is None else a).shape[0] for fams, (jc, jp) in zip(shards, J)
                   for a, b in zip(jc, jp))
        fmt = lambda d: ", ".join(f"{k} {v:.3g}" for k, v in d.items())   # noqa: E731
        opt = lambda k: f"{times[k]:.4f}" if k in times else "not measured"   # noqa: E731
        kg = times.get("kernel_graph")
        print(f"[phase3e] {label}: {mesh.size} shard(s), {len(shards[0])} families, {rows} "
              f"rows, {num_points} points, {cam_free.shape[0]} camera parameters, "
              f"{'SCHUR_JACOBI' if block else 'jacobi'}, {cam_free.dtype}: {launches} "
              f"launch(es), cooperative grid {launch['grid']} x {launch['threads']} threads, "
              f"{launch['shared_bytes']} B of shared memory, the warps' pose window "
              f"{launch['window_poses']} of {num_ref}, {launch['tile_rows']} rows a tile, "
              f"{launch['slots']} slots, {launch['resident_rows']} rows found in shared memory "
              f"by the blocks pass, {launch['row_bytes_read'] / 1e6:.2f} MB of rows read from "
              f"device memory; us a pass (%globaltimer): {fmt(passes_us)}; max |diff| / max "
              f"|plain in float64|: kernel {fmt(rel)} (in float64: {fmt(rel64)}); the plain "
              f"version in float32 {fmt(plain_own)}; ms an assembly: kernel through a plan "
              f"{times['kernel']:.4f}, without one {times['kernel_unplanned']:.4f}, plain "
              f"{times['plain']:.4f}, plain from a CUDA graph {opt('plain_graph')}, kernel "
              f"from a CUDA graph {opt('kernel_graph')}, through the LM loop's selector (half 1 "
              f"of the halves read) {opt('kernel_sel')}, from a graph "
              f"{opt('kernel_sel_graph')}{'; ' if notes else ''}{'; '.join(notes)}; "
              f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB), share "
              f"{bound_ms / times['kernel']:.4f}, from a graph "
              f"{f'{bound_ms / kg:.4f}' if kg else 'not measured'}; ptxas (registers, spill "
              f"stores, spill loads, stack bytes): {json.dumps(regs)} [{card}]", flush=True)
        if not (all(v <= SCHUR_RTOL for v in rel.values())
                and all(v <= ROW_RTOL_F64 for v in rel64.values())):
            raise AssertionError(f"phase 3e {label}: the assembly kernel disagrees with its "
                                 f"plain version: {rel} (bar {SCHUR_RTOL}), in float64 {rel64} "
                                 f"(bar {ROW_RTOL_F64})")
        out[label] = {"ms": times["kernel"], "plain_ms": times["plain"],
                      "unplanned_ms": times["kernel_unplanned"],
                      "plain_graph_ms": times.get("plain_graph"),
                      "kernel_graph_ms": times.get("kernel_graph"), "bound_ms": bound_ms,
                      "bound_by": bound_by, "bytes": nbytes, "max_abs_err": err,
                      "sel_ms": times["kernel_sel"], "sel_graph_ms": times.get("kernel_sel_graph"),
                      "library_ms": None, "launches_an_assembly": launches, "launch": launch,
                      "pass_us": passes_us, "ptxas": regs, "rel": rel, "rel_float64": rel64,
                      "plain_float32_rel": plain_own}
    return out


def cg_step_bound(n: int, nposes: int, item: int):
    """(bound ms, "bytes" | "operations") of one CG step after its matvec:
    x, r, p, Ap, the preconditioner, the 7x7 inverses and the state read
    once, x, r, p and the state written once, over the memory rate; three
    dots, three axpys and M^-1 r (13 operations a pose entry, 1 a scalar
    one) over the FP32 rate."""
    nbytes = item * (8 * n + 49 * nposes) + 64
    flop = 12 * n + 13 * 7 * nposes + (n - 7 * nposes)
    t_bytes, t_ops = nbytes / MEM_PEAK * 1e3, flop / FP32_CORES_PEAK * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cg_solve_bound(system, nposes: int, steps: int):
    """(bound ms, "bytes" | "operations") of one CG solve of ``steps`` steps
    with its right-hand side and back-substitution: every input read once (a
    matvec's, ``schur_work``, and g_c, g_p, the preconditioner, the 7x7
    inverses), the outputs written once (x, u, J_p^T u), over the memory
    rate; the operations of steps + 1 matvecs (the right-hand side's camera
    pass and the back-substitution's point pass make one more) and of the
    steps' vector work (``cg_step_bound``'s) over the FP32 rate."""
    item = system.cam_free.element_size()
    C, P = system.total, system.num_points
    mv_bytes, mv_flop = schur_work(system)
    rows_k = sum((b if a is None else a).shape[0] * (b if a is None else a).shape[1]
                 for a, b in zip(*system.J[0]))
    nbytes = mv_bytes + item * (C + 3 * P + C + 49 * nposes + rows_k + 3 * P)
    flop = (steps + 1) * mv_flop + steps * (12 * C + 13 * 7 * nposes + (C - 7 * nposes))
    t_bytes, t_ops = nbytes / MEM_PEAK * 1e3, flop / FP32_CORES_PEAK * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def grid_smem_bytes(torch) -> int:
    """The shared memory that one block an SM can hold across the card: the
    SMs times a block's opt-in shared memory (227 KiB on an H100 where the
    properties do not give it)."""
    props = torch.cuda.get_device_properties(0)
    return props.multi_processor_count * getattr(props, "shared_memory_per_block_optin",
                                                 227 * 1024)


def cg_step_read_bound(system, nposes: int, smem: int):
    """(bound ms, "bytes" | "operations", bytes) of one CG step of the
    one-launch solve, from the system and the card: the rows a matvec reads
    (the blocks and their int64 indices, ``schur_work``'s) less the ``smem``
    bytes the grid's shared memory could keep between steps, read once, and
    the step's vectors (p, Ap, r, x, dc, cam_free, the preconditioner, the
    7x7 inverses and Hpp^-1) over the memory rate; a matvec's operations and
    a step's vector work over the FP32 rate."""
    item = system.cam_free.element_size()
    C, P = system.total, system.num_points
    mv_bytes, mv_flop = schur_work(system)
    rows = mv_bytes - item * (4 * C + 9 * P)
    nbytes = max(0, rows - smem) + item * (8 * C + 49 * nposes + 9 * P)
    flop = mv_flop + 12 * C + 13 * 7 * nposes + (C - 7 * nposes)
    t_bytes, t_ops = nbytes / MEM_PEAK * 1e3, flop / FP32_CORES_PEAK * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def phase3f(torch, card):
    """The one-launch CG solve (``solver/cg_solve.py``, cg_solve_kernel of
    csrc/schur_mv.cu) and the CG step kernel of the per-step path
    (``solver/cg.py``, csrc/cg_step.cu) on the first CG of phase 3's solve
    (the cube, jacobi) and of phase 4's (calibrate's system, SCHUR_JACOBI).
    The solve: CG_FORCED forced steps (``debug_force_cg``) against the plain
    solve (the plain right-hand side, loop and back-substitution) in float64
    on the same inputs, x within SCHUR_RTOL of max |plain| with the tensors
    in float64; with the path's float32 tensors one step within SCHUR_RTOL
    and all of them within CG_DRIFT times the plain float32 solve's own
    error (CG's drift in float32, printed beside); the launches of a solve
    (one, and no matvec or CG step launch); the early-stopped CG count in
    float32 and float64 against the plain float64 loop's (equal); ms a solve
    and a step (the solve's time over its steps) of the kernel, of the
    per-step path (schur_mv.cu's right-hand side, matvecs and
    back-substitution, cg_step.cu's steps), of the plain solve eager and
    from a CUDA graph, and of the kernel from a graph (where the capture
    takes the cooperative launch); the bound (``cg_solve_bound``); the bytes
    of rows a step reads from device memory (the rows not kept in shared
    memory between the passes); its registers, spills and stack. The
    per-step path (cg_step.cu after each schur_mv.cu matvec, tested every
    ``check_every`` steps and masked between) against the same plain solve
    in float64: x in float64 and one float32 step within SCHUR_RTOL,
    CG_FORCED float32 steps within the same drift bar, its early-stopped CG
    count equal to the plain loop's; its error is cg_step's ``max_abs_err``.
    The step kernel: ms a step of the kernel, the plain step (the update, the mask,
    the stop test and the count, around the same matvec result), both from a
    CUDA graph, the bound (``cg_step_bound``) and, the step's practical
    floor, one empty launch on the card. The solve is also run as the LM loop
    launches it, its blocks in the halves (``halved``: half 1 read through
    the selector): x held to the plain solve alike, timed eager and from a
    graph. Whether two forced solves and two early-stopped ones give x, u,
    J_p^T u and the count bit for bit (printed: the sums' float atomics may
    change the last bits); phase 4's system's float64 check repeated
    F64_REPEATS times (the passes printed and recorded); the launch's grid
    barriers a step and a step's time (a CG_FORCED-step solve less a 0-step
    one, over CG_FORCED) against the bound of what a step must read
    (``cg_step_read_bound``) beside the solve's (``cg_solve_bound``). The
    trial point the solve writes in its tail is held to csrc/lm_step.cu's
    trial kernel in phase 3g. Returns the records by system."""
    import dataclasses
    from multiview_tpu_torch.solver import cg, cg_solve, schur_matvec as smv

    dev = torch.device("cuda", 0)
    empty_ms = min(per_call_ms(torch, lambda: cg.empty_launch(dev), reps=200) for _ in range(3))
    empty_graph = graphed(torch, lambda: cg.empty_launch(dev))
    empty_graph_ms = min(per_call_ms(torch, empty_graph, reps=200) for _ in range(3))
    regs = {k: v for k, v in ptxas_report("schur_mv.cu").items() if "cg_solve_kernel" in k}
    smem = grid_smem_bytes(torch)
    out = {}
    for label in ("cube", "rig"):
        system, g_c, g_p, M, iterations, tolerance, check_every = SOLVE_CALLS[label][:7]
        sys64 = dataclasses.replace(system, J=in64(torch, system.J),
                                    cam_free=system.cam_free.double(), dc=system.dc.double(),
                                    hpp_inv=system.hpp_inv.double(), _plans=None)
        M64, g_c64, g_p64 = in64(torch, M), g_c.double(), g_p.double()
        nposes = 0 if M.pose_inv is None else M.pose_inv.shape[0]

        def fused(s, m, gc, gp, force=CG_FORCED):
            return cg_solve.solve_cuda(s, gc, gp, m, iterations, tolerance, force)

        def plain(s, m, gc, gp, force=CG_FORCED):
            return cg_solve.solve_plain(s, gc, gp, m, iterations, tolerance, 1, force)

        def per_step(s, m, gc, gp, force=CG_FORCED):
            rhs = smv.schur_rhs_cuda(s, gc, gp)
            x, k = cg.pcg_cuda(lambda v: smv.schur_matvec_cuda(s, v), m, rhs, iterations,
                               tolerance, check_every, force)
            return x, smv.row_products_cuda(s, x), k

        counts = (cg_solve.LAUNCHES, smv.LAUNCHES, cg.LAUNCHES)
        cg_solve.RECORD_LAUNCH = True
        try:
            sol = fused(system, M, g_c, g_p)
            torch.cuda.synchronize()
            launch = dict(cg_solve.LAST_LAUNCH)
        finally:
            cg_solve.RECORD_LAUNCH = False
        launches = tuple(b - a for a, b in zip(counts, (cg_solve.LAUNCHES, smv.LAUNCHES,
                                                         cg.LAUNCHES)))
        if launches != (1, 0, 0) or int(sol.count) != CG_FORCED:
            raise AssertionError(f"phase 3f {label}: {CG_FORCED} forced steps took (solve, "
                                 f"matvec, step) launches {launches}, {int(sol.count)} steps")
        # whether two launches, forced and stopped by the test, give the same bits
        same_bits = {}
        for force in (CG_FORCED, None):
            one, two = ([t.clone() for t in (o.x, o.u[0], o.jtp_u, o.count)]
                        for o in (fused(system, M, g_c, g_p, force),
                                  fused(system, M, g_c, g_p, force)))
            same_bits["forced" if force else "stopped"] = all(
                torch.equal(x, y) for x, y in zip(one, two))
        sol64 = fused(sys64, M64, g_c64, g_p64)
        ref = plain(sys64, M64, g_c64, g_p64)
        ref32 = plain(system, M, g_c, g_p)
        rel, rel64, plain_own = rel_err(sol.x, ref.x), rel_err(sol64.x, ref.x), \
            rel_err(ref32.x, ref.x)
        rel_jtpu = rel_err(sol64.jtp_u, ref.jtp_u)
        passes64 = None
        if label == "rig":
            passes64 = 0
            for _ in range(F64_REPEATS):
                again = fused(sys64, M64, g_c64, g_p64)
                passes64 += int(rel_err(again.x, ref.x) <= SCHUR_RTOL
                                and rel_err(again.jtp_u, ref.jtp_u) <= SCHUR_RTOL)
            print(f"[phase3f] {label}: the float64 check (x and J_p^T u within {SCHUR_RTOL} of "
                  f"the plain float64 solve after {CG_FORCED} forced steps) passed {passes64} of "
                  f"{F64_REPEATS} more launches [{card}]", flush=True)
        err = float((sol.x.double() - ref.x).abs().max())
        rel1 = rel_err(fused(system, M, g_c, g_p, 1).x, plain(sys64, M64, g_c64, g_p64, 1).x)
        Jh, _, hh = halved(torch, system.J)
        sys_h = dataclasses.replace(system, J=Jh, halves=hh, _plans=None)
        rel_sel = rel_err(fused(sys_h, M, g_c, g_p).x, ref.x)
        k_fused = int(fused(system, M, g_c, g_p, None).count)
        k_fused64 = int(fused(sys64, M64, g_c64, g_p64, None).count)
        k_plain = int(plain(sys64, M64, g_c64, g_p64, None).count)
        # the per-step path (cg_step.cu after each schur_mv.cu matvec) on the same inputs
        ps_x = per_step(system, M, g_c, g_p)[0]
        ps_rel, ps_rel64 = rel_err(ps_x, ref.x), rel_err(per_step(sys64, M64, g_c64, g_p64)[0],
                                                         ref.x)
        ps_err = float((ps_x.double() - ref.x).abs().max())
        ps_rel1 = rel_err(per_step(system, M, g_c, g_p, 1)[0],
                          plain(sys64, M64, g_c64, g_p64, 1).x)
        ps_k = int(per_step(system, M, g_c, g_p, None)[2])
        runs = [("kernel", lambda: fused(system, M, g_c, g_p)),
                ("kernel0", lambda: fused(system, M, g_c, g_p, 0)),
                ("per_step", lambda: per_step(system, M, g_c, g_p)),
                ("plain", lambda: plain(system, M, g_c, g_p)),
                ("plain_graph", graphed(torch, lambda: plain(system, M, g_c, g_p))),
                ("kernel_sel", lambda: fused(sys_h, M, g_c, g_p))]
        graph_note = ""
        try:
            runs.append(("kernel_graph", graphed(torch, lambda: fused(system, M, g_c, g_p))))
            runs.append(("kernel_sel_graph", graphed(torch, lambda: fused(sys_h, M, g_c, g_p))))
        except Exception as e:          # a cooperative launch the capture refuses is reported
            torch.cuda.synchronize()
            graph_note = f" (not captured: {type(e).__name__}: {str(e).splitlines()[0][:160]})"
        times = {}
        for key, fn in runs + runs[::-1]:            # in turns, the better of two
            ms = per_call_ms(torch, fn, reps=10)
            times[key] = min(times.get(key, ms), ms)
        bound_ms, bound_by = cg_solve_bound(system, nposes, CG_FORCED)
        step_bound, step_bound_by, step_bytes = cg_step_read_bound(system, nposes, smem)
        per = {k: v / CG_FORCED for k, v in times.items()}
        a_step = (times["kernel"] - times["kernel0"]) / CG_FORCED
        kg = times.get("kernel_graph")
        print(f"[phase3f] {label} solve: {system.total} camera parameters, "
              f"{'SCHUR_JACOBI' if nposes else 'jacobi'}, {g_c.dtype}: {CG_FORCED} forced "
              f"steps in (solve, matvec, step) launches {launches}, grid {launch['grid']}, "
              f"{launch['tile_rows']} rows a tile, {launch['slots']} slots, "
              f"{launch['resident_rows']} rows in shared memory at a pass's start, "
              f"x * cam_free in shared memory {bool(launch['x_in_shared'])}, "
              f"row_bytes_a_step {launch['row_bytes_a_step']} "
              f"({launch['row_bytes_a_step'] / 1e6:.3f} MB of rows read from device memory a "
              f"step), barriers_a_step {launch['barriers_a_step']}; two launches bit for bit "
              f"alike: {json.dumps(same_bits)}; x max |diff| / max |plain "
              f"in float64|: kernel {rel:.3g} (in float64 "
              f"{rel64:.3g}, J_p^T u {rel_jtpu:.3g}; one step {rel1:.3g}); the plain solve in "
              f"float32 {plain_own:.3g}; early-stopped CG (tolerance {tolerance:g}, tested "
              f"every step): {k_fused} steps in float32, {k_fused64} in float64, {k_plain} "
              f"with the plain loop in float64; ms a solve (a step): kernel "
              f"{times['kernel']:.4f} ({per['kernel']:.5f}), per-step path "
              f"{times['per_step']:.4f} ({per['per_step']:.5f}), plain {times['plain']:.4f} "
              f"({per['plain']:.5f}), plain from a CUDA graph {times['plain_graph']:.4f} "
              f"({per['plain_graph']:.5f}), kernel from a CUDA graph "
              f"{f'{kg:.4f}' if kg else 'not measured'}{graph_note}; through the LM loop's "
              f"selector (half 1 of the halves read; x {rel_sel:.3g} off the plain float64 "
              f"solve) {times['kernel_sel']:.4f}, from a graph "
              f"{times['kernel_sel_graph'] if 'kernel_sel_graph' in times else 'not measured'}"
              f"; bound of the solve (every input once) {bound_ms:.4f} ms by {bound_by}, share "
              f"{bound_ms / times['kernel']:.4f}; a step (a {CG_FORCED}-step solve less a "
              f"0-step one) {a_step:.5f} ms, its bound (the rows that {smem} bytes of the "
              f"grid's shared memory cannot keep, once, and the vectors: "
              f"{step_bytes / 1e6:.3f} MB) {step_bound:.5f} ms by {step_bound_by}, share "
              f"{step_bound / a_step:.4f}; ptxas (registers, spill stores, spill loads, stack "
              f"bytes): {json.dumps(regs)} [{card}]", flush=True)
        bar = max(SCHUR_RTOL, CG_DRIFT * plain_own)
        if not (rel1 <= SCHUR_RTOL and rel <= bar and rel_sel <= bar and rel64 <= SCHUR_RTOL
                and rel_jtpu <= SCHUR_RTOL):
            raise AssertionError(f"phase 3f {label}: the CG solve's x is off the plain "
                                 f"solve's: one step {rel1:.3g} (bar {SCHUR_RTOL}), "
                                 f"{CG_FORCED} steps {rel:.3g} (through the selector "
                                 f"{rel_sel:.3g}; bar {bar:.3g}), in float64 "
                                 f"{rel64:.3g}, J_p^T u {rel_jtpu:.3g} (bar {SCHUR_RTOL})")
        if not k_fused == k_fused64 == k_plain:
            raise AssertionError(f"phase 3f {label}: CG counts {k_fused} (float32), "
                                 f"{k_fused64} (float64) against the plain loop's {k_plain}")
        print(f"[phase3f] {label} per-step path (cg_step.cu, schur_mv.cu) against the plain "
              f"solve in float64: x max |diff| / max |plain|: {CG_FORCED} steps {ps_rel:.3g} "
              f"(bar {bar:.3g}), in float64 {ps_rel64:.3g}, one step {ps_rel1:.3g} (bar "
              f"{SCHUR_RTOL}); max |diff| {ps_err:.3g}; early-stopped CG (tested every "
              f"{check_every} steps, masked between) {ps_k} steps against the plain loop's "
              f"{k_plain} [{card}]", flush=True)
        if not (ps_rel1 <= SCHUR_RTOL and ps_rel <= bar and ps_rel64 <= SCHUR_RTOL):
            raise AssertionError(f"phase 3f {label}: the per-step path's x is off the plain "
                                 f"solve's: one step {ps_rel1:.3g} (bar {SCHUR_RTOL}), "
                                 f"{CG_FORCED} steps {ps_rel:.3g} (bar {bar:.3g}), in float64 "
                                 f"{ps_rel64:.3g} (bar {SCHUR_RTOL})")
        if ps_k != k_plain:
            raise AssertionError(f"phase 3f {label}: the per-step path's CG count {ps_k} "
                                 f"against the plain loop's {k_plain}")
        record = {"ms": times["kernel"], "plain_ms": times["plain"],
                  "per_step_path_ms": times["per_step"], "plain_graph_ms": times["plain_graph"],
                  "kernel_graph_ms": kg, "ms_a_step": per, "bound_ms": bound_ms,
                  "a_step_ms": a_step, "step_bound_ms": step_bound,
                  "step_bound_by": step_bound_by, "step_bound_bytes": step_bytes,
                  "float64_passes": passes64, "same_bits": same_bits,
                  "barriers_a_step": launch["barriers_a_step"],
                  "sel_ms": times["kernel_sel"], "sel_graph_ms": times.get("kernel_sel_graph"),
                  "rel_sel": rel_sel,
                  "bound_by": bound_by, "max_abs_err": err, "library_ms": None,
                  "steps": CG_FORCED, "launches": launches, "launch": launch, "rel": rel,
                  "rel_float64": rel64, "rel_one_step": rel1, "plain_float32_rel": plain_own,
                  "cg_kernel": k_fused, "cg_kernel_float64": k_fused64,
                  "cg_plain_float64": k_plain, "ptxas": regs}

        # the per-step path's kernel: one step's work around a fixed matvec result
        rhs = smv.schur_rhs_cuda(system, g_c, g_p)
        state = cg.CudaCG(M, rhs, tolerance)
        state.start()
        Ap = smv.schur_matvec_cuda(system, state.p)
        x0, r0, p0 = rhs * 0, rhs.clone(), M.apply(rhs)
        rz0 = (r0 * p0).sum()
        stop2 = tolerance ** 2 * (rhs * rhs).sum()
        active = torch.ones((), dtype=torch.bool, device=dev)

        def plain_step():
            act = active & ((r0 * r0).sum() > stop2)
            new = cg.update_plain(M, x0, r0, p0, rz0, Ap)
            return [torch.where(act, a, b) for a, b in zip(new, (x0, r0, p0, rz0))] + [act]

        step_runs = [("kernel", lambda: state.step(Ap, forced=True)), ("plain", plain_step),
                     ("plain_graph", graphed(torch, plain_step)),
                     ("kernel_graph", graphed(torch, lambda: state.step(Ap, forced=True)))]
        step_times = {}
        for key, fn in step_runs + step_runs[::-1]:
            ms = per_call_ms(torch, fn, reps=100)
            step_times[key] = min(step_times.get(key, ms), ms)
        step_bound, step_by = cg_step_bound(rhs.shape[0], nposes, rhs.element_size())
        print(f"[phase3f] {label} step kernel (the per-step path): ms a step: kernel "
              f"{step_times['kernel']:.4f}, plain {step_times['plain']:.4f}, plain from a CUDA "
              f"graph {step_times['plain_graph']:.4f}, kernel from a CUDA graph "
              f"{step_times['kernel_graph']:.4f}; bound {step_bound:.6f} ms by {step_by}; an "
              f"empty launch {empty_ms:.4f} ms, from a graph {empty_graph_ms:.4f} ms; the "
              f"step's share of the empty launch {empty_ms / step_times['kernel']:.4f}, from "
              f"graphs {empty_graph_ms / step_times['kernel_graph']:.4f} [{card}]", flush=True)
        out[label] = {"solve": record, "step": {
            "ms": step_times["kernel"], "plain_ms": step_times["plain"],
            "plain_graph_ms": step_times["plain_graph"],
            "kernel_graph_ms": step_times["kernel_graph"], "bound_ms": step_bound,
            "bound_by": step_by, "empty_launch_ms": empty_ms,
            "empty_launch_graph_ms": empty_graph_ms, "library_ms": None,
            "max_abs_err": ps_err, "rel": ps_rel, "rel_float64": ps_rel64,
            "rel_one_step": ps_rel1, "cg_per_step_path": ps_k}}
    return out


def lm_step_bound(targs, aargs):
    """(bound ms, "bytes" | "operations", bytes) of one LM iteration's trial
    and accept. The bound: each launch's inputs read once (the trial's cam,
    x, cam_free, lower and upper where given, points, Hpp^-1, g_p and J_p^T
    u; the accept's r_t, u or Jd, the current point blocks and their int64
    point indices, dp, step_c, g_c, g_p, the two diagonals, the state) and
    its outputs written once (cam_t, step_c, pts_t, dp, the state), over the
    memory rate; the operations (the trial's 3x3 solve 21 a point and 4 a
    camera entry, the accept's 2 a residual, 8 a row component with a point
    block, 2 otherwise, 6 a camera entry and 6 a point entry) over the FP32
    rate."""
    (_cam, _points, _x, _cam_free, lower, upper, _hpp_inv, _g_p, _jtp_u) = targs[:9]
    (mesh, shards, num_ref, J, r, _J_t, _r_t, t, cam, points, g_c, g_p, cam_diag, pt_diag,
     u, jd, cg_count, gate) = aargs[:18]
    item = cam.element_size()
    C, P = cam.shape[0], points.shape[0]
    bounds = sum(b is not None for b in (lower, upper))
    state = 8 * 16
    # the trial: cam, x, cam_free, the bounds; points, g_p, J_p^T u, Hpp^-1;
    # then cam_t, step_c, pts_t, dp written
    nbytes = item * ((3 + bounds) * C + 9 * P + 9 * P + 2 * C + 6 * P)
    # the accept: step_c, g_c, cam_diag; dp, g_p, pt_diag; the state
    nbytes += item * (3 * C + 9 * P) + 2 * state
    flop = 21 * P + 4 * C + 6 * C + 6 * 3 * P
    for s, (jc, jp) in enumerate(J):
        nbytes += 2 * item * r[s].numel()            # r_t and u (or Jd)
        flop += 2 * r[s].numel()
        for a, b in zip(jc, jp):
            n, k = (b if a is None else a).shape[:2]
            flop += (8 if b is not None else 2) * n * k
            if b is not None:
                nbytes += item * b.numel() + 8 * n
    t_bytes, t_ops = nbytes / MEM_PEAK * 1e3, flop / FP32_CORES_PEAK * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


@contextlib.contextmanager
def count_aten(torch):
    """Counts the ATen operations dispatched inside (``TorchDispatchMode``), by
    name: ``{"n": total, "names": {name: count}}``."""
    from torch.utils._python_dispatch import TorchDispatchMode
    counts = {"n": 0, "names": {}}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func.overloadpacket.__name__)
            counts["n"] += 1
            counts["names"][name] = counts["names"].get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    with Count():
        yield counts


# phase 3g: the accept's time from graphs is taken over LM_GRAPH_REPEAT
# accepts (each after a reset of the state) in one graph, less as many resets
LM_GRAPH_REPEAT = 10
# phase 3g: the accepted accept's time from graphs at most this far above the
# rejected one's (an accepted step copies nothing)
LM_ACCEPT_RATIO = 1.10


def phase3g(torch, card, p3):
    """The LM step kernel (``solver/lm_step.py``, csrc/lm_step.cu) on the
    first trial and accept of phase 3's solve (the cube) and of phase 4's
    (calibrate's system), the current and the trial state in the LM loop's
    halves as the path left them (``first_lm_step``; copied half for half
    into new halves, ``lm_halves``): the trial point against the plain trial
    in float64 on the same inputs (SCHUR_RTOL of max |plain| with float32
    tensors, ROW_RTOL_F64 with float64 ones); the accept at an accepted and a
    forced rejected step against the plain accept on the same inputs: good,
    done, ``sel`` (flipped on the accepted step only), the counters and the
    stop flag equal, the scalars (new_cost, pred, rho, lam, nu,
    rel_decrease, cost) within LM_RTOL relative (both sum in float64), both
    halves of every array bit for bit as they were (an accepted step copies
    nothing, a rejected one keeps the current half), two launches and two
    replays of one captured graph bit for bit alike (the last block resets
    the ticket counter); ms of the trial and of the accept (accepted and
    rejected) for the kernel and the plain version, eager and from a CUDA
    graph (each accept after a reset of the state, whose time is taken out;
    from graphs LM_GRAPH_REPEAT accepts a graph), the accepted accept against
    the rejected one from graphs (at most LM_ACCEPT_RATIO), the bound
    (``lm_step_bound``), registers and spills. Then phase 3's solve with the
    host reading the state every iteration and every second one
    (``LM_CHECK_EVERY`` 1 and 2), two runs each: LM, CG and matvec counts
    equal, the final cost within the larger spread of two runs of one
    setting plus 1e-6 relative (atomics vary the last bits); and per LM
    iteration of the cube's solve the kernel launches, the host reads of the
    state and the eager ATen operations (``count_aten`` over
    ``debug_unroll_lm`` solves of 4 and 8 iterations: the difference over
    4). Returns the records by system."""
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.solver import (assembly as asm, cg_solve, lm_step as lm,
                                            row_blocks as rb, schur, schur_matvec as smv)

    regs = ptxas_report("lm_step.cu")
    out = {}
    for label in ("cube", "rig"):
        tv, tt, targs, tpairs = LM_CALLS[label]["trial"]
        av, at, aargs, apairs = LM_CALLS[label]["accept"]
        (mesh, shards, num_ref, J, r, _, _, t, cam, points, g_c, g_p, cam_diag, pt_diag,
         u, jd, cg_count, gate) = aargs[:18]
        rest = targs[2:9]              # x, cam_free, lower, upper, hpp_inv, g_p, jtp_u
        dt, dev = cam.dtype, cam.device
        C, P = cam.shape[0], points.shape[0]
        sel0 = int(av.view(torch.int32)[2 * lm.SEL])

        def state(values, typed, d=dt):
            st = lm.LMState(d, dev, C, P)
            st.values.copy_(values)
            st.typed.copy_(typed)
            return st

        # the trial: the kernel reads half sel, writes half 1 - sel
        st = state(tv, tt)
        sel_t = int(st.sel)
        h, (cam_h, pts_h) = lm_halves(torch, st, tpairs)
        kt = lm.trial_cuda(st, cam_h, pts_h, *rest, halves=h)
        kt = [x.clone() for x in (kt.cam[1 - sel_t], kt.points[1 - sel_t], kt.dp, kt.step_c)]
        st64 = state(tv, tt, torch.float64)
        h64, (cam64, pts64) = lm_halves(torch, st64, [p.double() for p in tpairs])
        kt64 = lm.trial_cuda(st64, cam64, pts64, *in64(torch, rest), halves=h64)
        kt64 = [x.clone() for x in (kt64.cam[1 - sel_t], kt64.points[1 - sel_t], kt64.dp,
                                    kt64.step_c)]
        pt64 = lm.trial_plain(st, tpairs[0][sel_t].double(), tpairs[1][sel_t].double(),
                              *in64(torch, rest))
        torch.cuda.synchronize()
        trial_rel = max(rel_err(a, b) for a, b in zip(kt, pt64))
        trial_rel64 = max(rel_err(a, b) for a, b in zip(kt64, pt64))
        trial_err = max(float((a.double() - b).abs().max()) for a, b in zip(kt, pt64))
        if not (trial_rel <= SCHUR_RTOL and trial_rel64 <= ROW_RTOL_F64):
            raise AssertionError(f"phase 3g {label}: the trial kernel disagrees with its plain "
                                 f"version: {trial_rel} (bar {SCHUR_RTOL}), in float64 "
                                 f"{trial_rel64} (bar {ROW_RTOL_F64})")
        # the trial point the path's CG solve wrote in its tail: bit for bit the
        # trial kernel's on the same inputs (the solve's x and J_p^T u)
        folded = LM_CALLS[label].get("folded")
        folded_equal = folded is not None and all(torch.equal(a, b) for a, b in zip(folded, kt))
        print(f"[phase3g] {label}: the trial point of the path's CG solve (its tail) against "
              f"the trial kernel on the same inputs: cameras, points, dp and step_c bit for bit "
              f"{folded_equal} [{card}]", flush=True)
        if not folded_equal:
            raise AssertionError(f"phase 3g {label}: the CG solve's trial point differs from "
                                 f"the trial kernel's")

        # the accept: the plain one on the halves' current and trial copies
        now = lm_unflat([None if p is None else p[sel0] for p in apairs], J)
        nxt = lm_unflat([None if p is None else p[1 - sel0] for p in apairs], J)
        t_plain = lm.Trial(nxt[0], nxt[1], t.dp, t.step_c)

        def kernel_accept(values, typed):
            """A fresh state and halves: (state, halves, its arrays, accept)."""
            s = state(values, typed)
            hk, arrays = lm_halves(torch, s, apairs)
            _, _, rk, Jk = lm_unflat(arrays, J)

            def go():
                lm.accept_cuda(s, mesh, shards, Jk, rk, t, g_c, g_p, cam_diag, pt_diag, u, jd,
                               cg_count, gate, halves=hk)
            return s, hk, [a for a in arrays if a is not None], go

        def both_halves(hk, arrays):
            return [hk.pair(a).clone() for a in arrays]

        lm.RECORD_LAUNCH = True
        try:
            natural, _, _, go = kernel_accept(av, at)
            go()
            torch.cuda.synchronize()
            launch = dict(lm.LAST_LAUNCH)
        finally:
            lm.RECORD_LAUNCH = False
        new_cost = float(natural.values[lm.NEW_COST])
        cases = {"accepted": 2.0 * abs(new_cost) + 1.0, "rejected": 0.5 * new_cost}
        scalars = (("new_cost", lm.NEW_COST), ("pred", lm.PRED), ("rho", lm.RHO),
                   ("lam", lm.LAM), ("nu", lm.NU), ("rel_decrease", lm.REL), ("cost", lm.COST))
        resets = {case: av.clone() for case in cases}
        for case, cost in cases.items():
            resets[case][lm.COST] = cost
        rec, runs, notes = {}, {}, []
        for case in cases:
            ks = []
            for _ in range(2):
                s, hk, arrays, go = kernel_accept(resets[case], at)
                before = both_halves(hk, arrays)
                go()
                torch.cuda.synchronize()
                moved = not all(torch.equal(a, b) for a, b in zip(before, both_halves(hk,
                                                                                      arrays)))
                if moved:
                    raise AssertionError(f"phase 3g {label} {case}: the accept changed the "
                                         f"halves' arrays (it must copy nothing)")
                ks.append(s)
            ps = state(resets[case], at)
            lm.accept_plain(ps, mesh, shards, num_ref, now[3], now[2], nxt[3], nxt[2], t_plain,
                            now[0], now[1], g_c, g_p, cam_diag, pt_diag, u, jd, cg_count, gate)
            torch.cuda.synchronize()
            kv, pv = ks[0].values.cpu(), ps.values.cpu()
            good = bool(kv[lm.GOOD])
            if good != (case == "accepted") or bool(pv[lm.GOOD]) != good:
                raise AssertionError(f"phase 3g {label} {case}: good {good} (plain "
                                     f"{bool(pv[lm.GOOD])})")
            for slot in (lm.DONE, lm.ITER, lm.CG_TOTAL):
                if float(kv[slot]) != float(pv[slot]):
                    raise AssertionError(f"phase 3g {label} {case}: slot {slot} {float(kv[slot])} "
                                         f"against the plain {float(pv[slot])}")
            sels = (int(ks[0].sel), int(ps.sel), sel0 ^ good)
            if bool(ks[0].halt) != bool(ps.halt) or len(set(sels)) != 1:
                raise AssertionError(f"phase 3g {label} {case}: the stop flag or sel differs "
                                     f"(sel kernel, plain, wanted: {sels})")
            rels = {n: abs(float(kv[s_]) - float(pv[s_])) / max(abs(float(pv[s_])), 1e-300)
                    for n, s_ in scalars}
            if not all(v <= LM_RTOL for v in rels.values()):
                raise AssertionError(f"phase 3g {label} {case}: scalars off the plain accept: "
                                     f"{rels} (bar {LM_RTOL})")
            if not (torch.equal(ks[0].values, ks[1].values)
                    and torch.equal(ks[0].typed, ks[1].typed)):
                raise AssertionError(f"phase 3g {label} {case}: two launches differ")
            # two replays of one captured accept, the state reset first in each
            s, hk, arrays, go = kernel_accept(resets[case], at)
            v0 = s.values.clone()

            def reset_go(s=s, v0=v0, go=go):
                s.values.copy_(v0)
                go()
            replay = graphed(torch, reset_go)
            replays = []
            for _ in range(2):
                replay()
                torch.cuda.synchronize()
                replays.append(s.values.clone())
            if not (torch.equal(replays[0], replays[1]) and torch.equal(replays[0], ks[0].values)):
                raise AssertionError(f"phase 3g {label} {case}: two replays of a captured "
                                     f"accept differ, or differ from a launch")
            rec[case] = {"good": good, "done": bool(kv[lm.DONE]), "sel": sels[0], "rel": rels}
            # the times of this case: eager after a reset; LM_GRAPH_REPEAT in a graph
            runs[f"accept_{case}"] = reset_go
            runs[f"accept_{case}_graph"] = graphed(torch, reset_go, LM_GRAPH_REPEAT)
            sp = state(resets[case], at)
            v0p = sp.values.clone()

            def plain_go(sp=sp, v0p=v0p):
                sp.values.copy_(v0p)
                lm.accept_plain(sp, mesh, shards, num_ref, now[3], now[2], nxt[3], nxt[2],
                                t_plain, now[0], now[1], g_c, g_p, cam_diag, pt_diag, u, jd,
                                cg_count, gate)
            runs[f"accept_{case}_plain"] = plain_go
            try:
                runs[f"accept_{case}_plain_graph"] = graphed(torch, plain_go, LM_GRAPH_REPEAT)
            except Exception as e:      # a capture that fails is reported
                torch.cuda.synchronize()
                notes.append(f"plain {case} not captured from a graph: {type(e).__name__}: "
                             f"{str(e).splitlines()[0][:120]}")
            if case == "accepted":
                runs["reset"] = lambda s=s, v0=v0: s.values.copy_(v0)
                runs["reset_graph"] = graphed(torch, runs["reset"], LM_GRAPH_REPEAT)

        # the trial's times (the state never halted: it writes the same half)
        st_t = state(tv, tt)
        h_t, (cam_t, pts_t) = lm_halves(torch, st_t, tpairs)
        runs["trial"] = lambda: lm.trial_cuda(st_t, cam_t, pts_t, *rest, halves=h_t)
        runs["trial_graph"] = graphed(torch, runs["trial"])
        runs["trial_plain"] = lambda: lm.trial_plain(st_t, tpairs[0][sel_t], tpairs[1][sel_t],
                                                     *rest)
        runs["trial_plain_graph"] = graphed(torch, runs["trial_plain"])
        times = {}
        order = list(runs.items())
        for key, fn in order + order[::-1]:          # in turns, the better of two
            ms = per_call_ms(torch, fn, reps=20)
            if key.endswith("_graph") and (key.startswith("accept") or key.startswith("reset")):
                ms /= LM_GRAPH_REPEAT
            times[key] = min(times.get(key, ms), ms)
        ms = {}
        for key in times:
            if key.startswith("accept"):
                base = "reset_graph" if key.endswith("_graph") else "reset"
                ms[key] = times[key] - times[base]
            elif not key.startswith("reset"):
                ms[key] = times[key]
        bound, bound_by, nbytes = lm_step_bound(targs, aargs)
        ratio = ms["accept_accepted_graph"] / ms["accept_rejected_graph"]
        rows = sum(x.numel() for x in r)
        opt = lambda k: f"{ms[k]:.4f}" if k in ms else "not measured"   # noqa: E731
        print(f"[phase3g] {label}: {mesh.size} shard(s), {rows} residuals, {P} points, {C} "
              f"camera parameters, {dt}, the path's sel {sel0}: trial max |diff| / max |plain "
              f"in float64| {trial_rel:.3g} (in float64 {trial_rel64:.3g}); accept (the "
              f"natural step {'accepted' if bool(natural.values[lm.GOOD]) else 'rejected'}) "
              f"against the plain accept: {json.dumps(rec)}; both halves bit for bit as they "
              f"were after each accept; ms: trial {opt('trial')} (graph {opt('trial_graph')}), "
              f"plain {opt('trial_plain')} (graph {opt('trial_plain_graph')}); accept accepted "
              f"{opt('accept_accepted')} (graph {opt('accept_accepted_graph')}), rejected "
              f"{opt('accept_rejected')} (graph {opt('accept_rejected_graph')}); plain accepted "
              f"{opt('accept_accepted_plain')} (graph {opt('accept_accepted_plain_graph')}), "
              f"rejected {opt('accept_rejected_plain')} (graph "
              f"{opt('accept_rejected_plain_graph')}); a state reset {times['reset']:.4f} (graph "
              f"{times['reset_graph']:.4f}; taken out of each accept); accepted / rejected "
              f"accept from graphs {ratio:.4f} (bar {LM_ACCEPT_RATIO}); bound of a trial and an "
              f"accept {bound:.4f} ms ({nbytes / 1e6:.2f} MB, by {bound_by}; share "
              f"{bound / (ms['trial'] + ms['accept_accepted']):.4f} of a trial and an accepted "
              f"accept, from graphs "
              f"{bound / (ms['trial_graph'] + ms['accept_accepted_graph']):.4f}; of the accept "
              f"alone from a graph {bound / ms['accept_rejected_graph']:.4f} rejected); grid "
              f"{launch or 'not recorded'}; {'; '.join(notes)}{'; ' if notes else ''}ptxas "
              f"(registers, spill stores, spill loads, stack bytes): {json.dumps(regs)} "
              f"[{card}]", flush=True)
        if label == "cube" and ratio > LM_ACCEPT_RATIO:
            raise AssertionError(f"phase 3g {label}: an accepted accept takes {ratio:.4f} times "
                                 f"a rejected one from graphs (bar {LM_ACCEPT_RATIO})")
        out[label] = {"ms": ms["trial"] + ms["accept_accepted"],
                      "plain_ms": ms["trial_plain"] + ms["accept_accepted_plain"],
                      "kernel_graph_ms": ms["trial_graph"] + ms["accept_accepted_graph"],
                      "plain_graph_ms": (ms["trial_plain_graph"]
                                         + ms["accept_accepted_plain_graph"]
                                         if "accept_accepted_plain_graph" in ms else None),
                      "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
                      "accepted_over_rejected_graph": ratio, "max_abs_err": trial_err,
                      "library_ms": None, "times_ms": ms, "accept": rec, "grid": launch,
                      "ptxas": regs}

    # LM_CHECK_EVERY 1 against 2 on phase 3's solve, two runs each
    scene, state0, solver = p3["problem"]
    cam0 = prob.pack_state(state0, include_points=False)
    every0, runs = schur.LM_CHECK_EVERY, {}
    reads = []
    read0 = lm.read

    def counted_read(st):
        reads.append(1)
        return read0(st)

    lm.read = counted_read
    try:
        for every in (1, 2, 2, 1):
            schur.LM_CHECK_EVERY = every
            del reads[:]
            res = solver()(cam0, state0.points)
            torch.cuda.synchronize()
            runs.setdefault(every, []).append((res.iterations, int(res.cg_iters_total),
                                               res.matvecs, float(res.cost), len(reads)))
    finally:
        schur.LM_CHECK_EVERY, lm.read = every0, read0
    counts = {e: {x[:3] for x in v} for e, v in runs.items()}
    spread = max(abs(v[0][3] - v[1][3]) for v in runs.values())
    gap = abs(runs[1][0][3] - runs[2][0][3])
    bar = spread + 1e-6 * abs(runs[2][0][3])
    print(f"[phase3g] phase 3's solve read every iteration and every second one, two runs each "
          f"(LM, CG, matvecs, final cost, host reads): {json.dumps(runs)}; the settings' cost "
          f"gap {gap:.3g}, bar {bar:.3g} (the larger spread of two runs of one setting "
          f"{spread:.3g} + 1e-6 relative) [{card}]", flush=True)
    if not (len(counts[1]) == len(counts[2]) == 1 and counts[1] == counts[2] and gap <= bar):
        raise AssertionError(f"phase 3g: LM_CHECK_EVERY 1 and 2 disagree: {runs}")

    # launches, host reads and eager ATen operations per LM iteration
    mods = {"row_blocks": rb, "lm_assembly": asm, "cg_solve": cg_solve, "schur_mv": smv,
            "lm_step": lm}
    per = {}
    for k in (4, 8):
        before = {n: m.LAUNCHES for n, m in mods.items()}
        before["trial"] = lm.TRIAL_LAUNCHES
        del reads[:]
        lm.read = counted_read
        try:
            with count_aten(torch) as ops:
                solver(debug_unroll_lm=k)(cam0, state0.points)
                torch.cuda.synchronize()
        finally:
            lm.read = read0
        counted = {n: m.LAUNCHES - before[n] for n, m in mods.items()}
        counted["trial"] = lm.TRIAL_LAUNCHES - before["trial"]
        per[k] = (counted, ops["n"], dict(ops["names"]))
    launches = {n: (per[8][0][n] - per[4][0][n]) / 4 for n in per[8][0]}
    ops_it = (per[8][1] - per[4][1]) / 4
    names = {n: (per[8][2].get(n, 0) - per[4][2].get(n, 0)) / 4
             for n in set(per[8][2]) | set(per[4][2])}
    names = {n: v for n, v in names.items() if v}
    reads_it = runs[2][0][4] / runs[2][0][0]
    print(f"[phase3g] per LM iteration of phase 3's solve (one shard, cg_blocks): kernel "
          f"launches {json.dumps(launches)}; host reads of the LM state {reads_it:.3f} "
          f"(LM_CHECK_EVERY {schur.LM_CHECK_EVERY}); eager ATen operations {ops_it:g} "
          f"{json.dumps(names)} [{card}]", flush=True)
    if ops_it != 0 or names:
        raise AssertionError(f"phase 3g: an LM iteration ran eager ATen operations: {names}")
    total = sum(v for n, v in launches.items() if n != "trial")
    print(f"[phase3g] per LM iteration: {total:g} kernel launches, {launches['trial']:g} of them "
          f"the trial kernel's (the CG solve writes the trial point) [{card}]", flush=True)
    if total != 4 or launches["trial"] != 0:
        raise AssertionError(f"phase 3g: {total} launches and {launches['trial']} trial "
                             f"launches an LM iteration (expected 4 and 0)")
    out["per_iteration"] = {"launches": launches, "reads": reads_it, "aten_ops": ops_it}
    return out


def phase5(torch, device, card):
    """The dense LM on the card: an RPC fit with its inverse, and a dense
    ``optimize_rig`` on a small cube scene."""
    from multiview_tpu_torch.calib import calibrator as cal, problem as prob
    from multiview_tpu_torch.geometry import camera as cam_mod, rpc_fit
    from multiview_tpu_torch.utils import synthetic as syn

    cam = cam_mod.CameraParams.create(SIZE, FOCAL, (SIZE[0] / 2.0, SIZE[1] / 2.0),
                                      (-0.12, 0.03, 5e-4, -4e-4), dtype=torch.float32,
                                      device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coeffs = rpc_fit.fit_rpc_dist_undist(cam, rpc_degree=5, num_samples=40, num_iterations=50)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    err = rpc_fit.eval_rpc_dist_undist(cam, coeffs, num_samples=60)
    print(f"[phase5] fit_rpc_dist_undist, degree 5 on 40x40 samples of the sci_cam model: "
          f"{len(coeffs)} coefficients on {coeffs.device} in {fit_s:.2f} s, round trip "
          f"{err:.3g} px [{card}]", flush=True)
    if not (coeffs.is_cuda and err < 0.01):
        raise AssertionError(f"phase 5: RPC round trip {err} px")

    scene = syn.make_cube_scene(n_images=8, n_per_face=4, pix_noise=0.3,
                                dtype=torch.float32, device=device)
    state0 = syn.perturb_state(scene.true_state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cal.optimize_rig(state0, scene.observations, scene.models,
                           prob.FloatSpec(cam_poses=True), prob.BAOptions(no_rig=True),
                           num_passes=2, num_iterations=15, backend="dense")
    torch.cuda.synchronize()
    costs = [(float(r.initial_cost), float(r.cost)) for r in res.lm_results]
    print(f"[phase5] dense optimize_rig, cube 8x4: "
          f"{sum(len(o) for o in scene.observations.pixels)} observations, costs {costs}, "
          f"{[r.iterations for r in res.lm_results]} LM iterations in "
          f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)
    if any(not (b == b and b < a) for a, b in costs):
        raise AssertionError(f"phase 5: dense LM cost not finite and decreasing: {costs}")


def run_sfm_init(torch, mm, tag, ws: Path, out: Path, extra, spy=None):
    """``sfm-init`` in process on a rendered workspace, with the launch counts
    set to 0 just before and read just after. ``spy`` (a dict) receives the
    arguments of the run's ``view_graph_from_matches`` call. Returns what the
    checks read; raises unless every image is registered and the trajectory
    meets the bars."""
    from bench_torch.rig_calibrate import ba_counts
    from multiview_tpu_torch.__main__ import main as cli_main
    from multiview_tpu_torch.io import nvm as nvm_io
    from multiview_tpu_torch.sfm import global_sfm
    from multiview_tpu_torch.utils import synthetic as syn

    argv = ["sfm-init", "--rig_config", str(ws / "rig_config.txt"), "--images",
            str(ws / "images"), "--out_dir", str(out), "--max_features", "4096",
            "--num_overlaps", "3"] + extra
    original = global_sfm.view_graph_from_matches

    def recording(pair_data, num_views, *args, **kw):
        spy.update(pair_data=pair_data, num_views=num_views, pair_pids=kw.get("pair_pids"))
        return original(pair_data, num_views, *args, **kw)

    tee = Tee(sys.stdout)
    had = os.environ.get("MV_PROFILE")
    os.environ["MV_PROFILE"] = "1"                   # run_global_sfm prints its stages
    if spy is not None:
        global_sfm.view_graph_from_matches = recording
    mm.WGMMA_LAUNCHES = mm.FMA_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with schur_counted(tag), ba_counts() as ba, contextlib.redirect_stdout(tee):
            ret = cli_main(argv)
    finally:
        global_sfm.view_graph_from_matches = original
        if had is None:
            del os.environ["MV_PROFILE"]
        else:
            os.environ["MV_PROFILE"] = had
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fma_launches = mm.WGMMA_LAUNCHES, mm.FMA_LAUNCHES
    text = tee.buf.getvalue()
    if ret != 0:
        raise AssertionError(f"{tag}: sfm-init returned {ret}")
    tri = re.search(r"Triangulated (\d+)/(\d+) tracks", text)
    data = nvm_io.read_nvm(out / "cameras.nvm")
    run = {
        "launches": launches, "wall": wall, "ba": ba,
        "stages": {k: float(v) for k, v in re.findall(r"\[sfm-init\] (.+): (\S+) s", text)},
        "global": {k: float(v) for k, v in re.findall(r"\[global-sfm\] (\S+): (\S+) s", text)},
        "images": int(re.search(r"Found (\d+) images", text).group(1)),
        "edges": int(re.search(r"View graph edges: (\d+)", text).group(1)),
        "tracks": int(re.search(r"Built (\d+) tracks", text).group(1)),
        "triangulated": int(tri.group(1)), "views": len(data.cid_to_filename),
        "replaced": len(re.findall(r"re-resection: view", text)),
        "ate": syn.compute_ate(data.cid_to_filename, data.world_to_cam, ws / "cameras.txt")}
    if launches <= 0 or fma_launches != 0:
        raise AssertionError(f"{tag}: the path (D = 128) must launch the tensor-core matcher "
                             f"and only it: counted {launches} and {fma_launches} (FMA)")
    if run["views"] != run["images"] or run["ate"]["n_poses"] != run["images"]:
        raise AssertionError(f"{tag}: {run['views']} of {run['images']} views registered")
    ate = run["ate"]
    if not (ate["ate_rmse_m"] < ATE_MAX_M and ate["rot_mean_deg"] < ROT_MEAN_MAX_DEG):
        raise AssertionError(f"{tag}: trajectory off the truth: {ate}")
    if run["triangulated"] < 0.9 * run["tracks"] or len(data.pid_to_cid_fid) != run["triangulated"]:
        raise AssertionError(f"{tag}: {run['triangulated']} of {run['tracks']} tracks "
                             f"triangulated, {len(data.pid_to_cid_fid)} written")
    return run


def sfm_summary(run):
    return (f"wall {run['wall']:.2f} s; stages "
            + " | ".join(f"{k} {v} s" for k, v in run["stages"].items())
            + (("; global stages " + " | ".join(f"{k} {v} s" for k, v in run["global"].items()))
               if run["global"] else "")
            + f"; images {run['images']}; view graph edges {run['edges']}; tracks "
            f"{run['tracks']}; triangulated {run['triangulated']}; views registered "
            f"{run['views']}; poses replaced by re-resection {run['replaced']}; "
            f"tensor-core matcher launches {run['launches']} (FMA kernel 0); ATE "
            f"{run['ate']['ate_rmse_m']:.5f} m, rotation mean {run['ate']['rot_mean_deg']:.4f} "
            f"deg, max {run['ate']['rot_max_deg']:.4f} deg")


def two_view_stage_times(torch, card, spy, ws: Path):
    """The two-view stage of phase 6 alone, on the card and on the CPU in
    turns: ``view_graph_from_matches`` on the correspondences of that run.
    The draws differ between the devices' generators and the SVD libraries'
    sign conventions break the ties of planar pairs differently, so the two
    graphs are each held to the true relative rotations (cameras.txt of the
    workspace), not to each other bit for bit."""
    import numpy as np
    from multiview_tpu_torch.geometry import pose as P
    from multiview_tpu_torch.io import nvm as nvm_io
    from multiview_tpu_torch.sfm import global_sfm

    graphs, times = {}, {"cuda": [], "cpu": []}
    for dev in ("cuda", "cpu", "cuda"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph, _ = global_sfm.view_graph_from_matches(
            spy["pair_data"], spy["num_views"], pair_pids=spy["pair_pids"], device=dev)
        torch.cuda.synchronize()
        times[dev].append(time.perf_counter() - t0)
        graphs[dev] = graph
    # the true relative rotation of every edge: views are the images in time order
    names, mats = nvm_io.read_camera_poses(ws / "cameras.txt")
    order = sorted(range(len(names)), key=lambda k: float(Path(names[k]).stem))
    q_true = P.matrix_to_quat(torch.as_tensor(np.stack([mats[k][:3, :3] for k in order])))

    def against_truth(graph):
        e = graph.edges.cpu()
        rel_true = P.quat_mul(q_true[e[:, 1]], P.quat_conj(q_true[e[:, 0]]))
        err = P.quat_log(P.quat_mul(P.quat_conj(rel_true), graph.rel_rot.cpu().double()))
        return np.degrees(np.linalg.norm(err.numpy(), axis=-1))

    errs = {dev: against_truth(g) for dev, g in graphs.items()}
    g, c = graphs["cuda"], graphs["cpu"]
    ge = {tuple(e): k for k, e in enumerate(g.edges.cpu().numpy().tolist())}
    ce = {tuple(e): k for k, e in enumerate(c.edges.cpu().numpy().tolist())}
    both = sorted(set(ge) & set(ce))
    qg = g.rel_rot.cpu()[[ge[e] for e in both]]
    qc = c.rel_rot.cpu()[[ce[e] for e in both]]
    deg = np.degrees(np.linalg.norm(
        P.quat_log(P.quat_mul(P.quat_conj(qc), qg)).numpy(), axis=-1))
    sizes = sorted(len(v[0]) for v in spy["pair_data"].values())
    truth = "; ".join(
        f"{name}: median {np.median(errs[dev]):.4f} deg off the truth, more than 2 deg on "
        f"{int((errs[dev] > 2.0).sum())} of {len(errs[dev])} edges"
        for dev, name in (("cuda", "card"), ("cpu", "CPU")))
    print(f"[phase6] two-view stage alone ({len(sizes)} pairs of {sizes[0]}..{sizes[-1]} "
          f"correspondences, median {sizes[len(sizes) // 2]}; 512 hypotheses each for the "
          f"essential matrix and the homography, float64): on the card "
          f"{[round(t, 3) for t in times['cuda']]} s, on the CPU "
          f"{[round(t, 3) for t in times['cpu']]} s; edges {len(ge)} (card) / {len(ce)} "
          f"(CPU), {len(both)} in both; {truth}; card against CPU on the shared edges: median "
          f"{np.median(deg):.4f} deg, more than one degree on {int((deg > 1.0).sum())} "
          f"[{card}]", flush=True)
    bad = {dev: float((errs[dev] > 2.0).mean()) for dev in errs}
    # the card's graph must be as good as the CPU's, within the spread of the draws
    if len(both) < 0.9 * max(len(ge), len(ce)) or bad["cuda"] > bad["cpu"] + 0.1 \
            or np.median(errs["cuda"]) > 1.5 * np.median(errs["cpu"]) + 0.1:
        raise AssertionError(
            f"phase 6: the two-view stage on the card is further off the truth than on the "
            f"CPU: median {np.median(errs['cuda'])} against {np.median(errs['cpu'])} deg, "
            f"share over 2 deg {bad['cuda']:.3f} against {bad['cpu']:.3f}")


def phase6(torch, mm, card, workdir: Path):
    """``sfm-init`` GLOBAL on the three-sensor workspace, on the card."""
    spy = {}
    run = run_sfm_init(torch, mm, "phase 6", workdir / "ws3", workdir / "sfm3",
                       ["--num_ba_iterations", str(SFM_BA_ITERATIONS)], spy=spy)
    print(f"[phase6] sfm-init GLOBAL, {SFM_BA_ITERATIONS} iterations of the refinement BA: "
          f"{sfm_summary(run)}; {ba_summary(run['ba'])} [{card}]", flush=True)
    two_view_stage_times(torch, card, spy, workdir / "ws3")
    return run


def phase6b(torch, mm, card, workdir: Path):
    """``sfm-init`` INCREMENTAL on the first row of the two-sensor workspace,
    on the card."""
    run = run_sfm_init(torch, mm, "phase 6b", workdir / "ws_row", workdir / "sfm_inc",
                       ["--reconstruction_estimator", "INCREMENTAL",
                        "--num_ba_iterations", str(SFM_BA_ITERATIONS)])
    print(f"[phase6b] sfm-init INCREMENTAL, {SFM_BA_ITERATIONS} iterations of the refinement "
          f"BA: {sfm_summary(run)} [{card}]", flush=True)
    return run["launches"]


def calibrate_from_nvm(torch, mm, tag, ws: Path, nvm: Path, out: Path, passes: int,
                       iterations: int):
    """``calibrate --nvm`` in process from an ``sfm-init`` result (no rig,
    floating camera poses, the front end's matches merged with the NVM's),
    with the launch counts set to 0 just before and read just after. Returns
    launches, wall, tracks, per-pass costs and the trajectory error against
    the workspace's true poses; raises unless the matcher ran on the
    tensor-core kernel alone and the cost fell."""
    from multiview_tpu_torch.__main__ import main as cli_main
    from multiview_tpu_torch.io import nvm as nvm_io
    from multiview_tpu_torch.utils import synthetic as syn

    argv = ["calibrate", "--rig_config", str(ws / "rig_config.txt"), "--nvm", str(nvm),
            "--images", str(ws / "images"), "--out_dir", str(out), "--no_rig",
            "--camera_poses_to_float", "--num_iterations", str(iterations),
            "--calibrator_num_passes", str(passes), "--max_features", "4096",
            "--num_overlaps", "3", "--profile"]
    tee = Tee(sys.stdout)
    mm.WGMMA_LAUNCHES = mm.FMA_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with schur_counted(tag), contextlib.redirect_stdout(tee):
        ret = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fma_launches = mm.WGMMA_LAUNCHES, mm.FMA_LAUNCHES
    text = tee.buf.getvalue()
    if ret != 0:
        raise AssertionError(f"{tag}: calibrate returned {ret}")
    costs = [(float(a), float(b)) for a, b in re.findall(
        r"BA pass \d+: cost (\S+) -> (\S+)", text)]
    names, mats = nvm_io.read_camera_poses(out / "cameras.txt")
    run = {"launches": launches, "wall": wall, "costs": costs,
           "tracks": int(re.search(r"Built (\d+) tracks", text).group(1)),
           "ate": syn.compute_ate(names, mats, ws / "cameras.txt")}
    if launches <= 0 or fma_launches != 0:
        raise AssertionError(f"{tag}: counted {launches} tensor-core and {fma_launches} FMA "
                             f"matcher launches")
    if len(costs) != passes or not costs[-1][1] < costs[0][0]:
        raise AssertionError(f"{tag}: BA cost did not decrease: {costs}")
    return run


def phase6c(torch, mm, card, workdir: Path, sfm_run):
    """``calibrate --nvm`` from phase 6's cameras.nvm: the reference workflow
    (sfm-init, then the calibrator) end to end."""
    run = calibrate_from_nvm(torch, mm, "phase 6c", workdir / "ws3",
                             workdir / "sfm3" / "cameras.nvm", workdir / "calib_from_sfm",
                             CALIB_PASSES, CALIB_ITERATIONS)
    ate, before = run["ate"], sfm_run["ate"]
    print(f"[phase6c] calibrate --nvm from phase 6's cameras.nvm, {CALIB_PASSES} pass(es) of "
          f"{CALIB_ITERATIONS} iterations: wall {run['wall']:.2f} s; tracks {run['tracks']}; "
          f"costs {run['costs']}; tensor-core matcher launches {run['launches']} (FMA kernel "
          f"0); ATE {ate['ate_rmse_m']:.5f} m (sfm-init: {before['ate_rmse_m']:.5f} m), "
          f"rotation mean {ate['rot_mean_deg']:.4f} deg (sfm-init: "
          f"{before['rot_mean_deg']:.4f} deg) [{card}]", flush=True)
    if ate["n_poses"] != sfm_run["images"]:
        raise AssertionError(f"phase 6c: {ate['n_poses']} of {sfm_run['images']} poses written")
    if not (ate["ate_rmse_m"] < WORKFLOW_ATE_MAX_M
            and ate["rot_mean_deg"] < WORKFLOW_ROT_MEAN_MAX_DEG):
        raise AssertionError(f"phase 6c: the workflow's trajectory is off the truth: {ate}")
    # and no worse than sfm-init's own trajectory: within a tenth of it plus
    # 1.5 mm and 0.15 deg. The calibrator, under another robust threshold on
    # the merged tracks, ends at 1.3 to 1.8 mm and 0.17 to 0.21 deg whatever
    # sfm-init left, so from sfm-init's best (0.85 mm) it reads 0.5 mm higher
    if not (ate["ate_rmse_m"] <= 1.1 * before["ate_rmse_m"] + 1.5e-3
            and ate["rot_mean_deg"] <= 1.1 * before["rot_mean_deg"] + 0.15):
        raise AssertionError(f"phase 6c: the calibrated trajectory is worse than "
                             f"sfm-init's: {ate} against {before}")
    return run["launches"]


def phase2c(torch, mm, card, workdir: Path, rig_true):
    """``calibrate`` with SURF, out-of-core matching, the match files and
    registration to control points made from the truth."""
    import numpy as np
    from multiview_tpu_torch.io import match_file, nvm as nvm_io, rig_config as rc
    from multiview_tpu_torch.tools import common
    from multiview_tpu_torch.utils import synthetic as syn

    ws, out = workdir / "ws", workdir / "calib_surf"
    names, mats = nvm_io.read_camera_poses(ws / "cameras.txt")
    nav = [i for i, n in enumerate(names) if Path(n).parent.name == "nav_cam"][2:4]
    cam = common.cam_params_from_sensor(rc.read_rig_config(ws / "rig_config.txt").sensors[0],
                                        device="cpu")
    syn.write_control_points(workdir / "control.pto", workdir / "control.xyz",
                             [names[i] for i in nav], mats[nav], [cam, cam], n=CONTROL_POINTS)
    run = run_calibrate(torch, mm, "phase 2c", ws, out, [
        "--feature_detector", "SURF", "--match_out_of_core", "--matching_working_directory",
        str(workdir / "features"), "--matching_max_num_images_in_cache", "4",
        "--save_matches", "--registration", "--hugin_file", str(workdir / "control.pto"),
        "--xyz_file", str(workdir / "control.xyz")], every_pass=False)
    errs = rig_errors(torch, run, rig_true, ("sci_cam",))
    reg_err = float(re.search(r"Registration mean absolute error: (\S+) meters",
                              run["text"]).group(1))
    truth = {Path(n).name: M for n, M in zip(names, mats)}
    centre = lambda M: -M[:3, :3].T @ M[:3, 3]  # noqa: E731
    est_names, est_mats = nvm_io.read_camera_poses(out / "cameras.txt")
    centre_err = max(float(np.linalg.norm(centre(M) - centre(truth[Path(n).name])))
                     for n, M in zip(est_names, est_mats))
    files = sorted((out / "matches").glob("*.match"))
    counts = [tuple(len(x) for x in match_file.read_match_file(f)) for f in files]
    spilled = len(list((workdir / "features").glob("feat_*.npz")))
    print(f"[phase2c] calibrate --feature_detector SURF --match_out_of_core (cache of 4, "
          f"{spilled} feature files) --save_matches --registration ({CONTROL_POINTS} control "
          f"points): wall {run['wall']:.2f} s; stages "
          + " ".join(f"{k}={v}s" for k, v in run["stages"].items())
          + f"; tracks {run['tracks']}; costs {run['costs']}; tensor-core matcher launches "
          f"{run['launches']} (FMA kernel 0); rig error (deg, m) {errs}; registration error "
          f"{reg_err:.6g} m; largest camera-centre error against the truth, unaligned, "
          f"{centre_err:.5f} m over {len(est_names)} cameras; {len(files)} match files, "
          f"{sum(a for a, _ in counts)} matches read back [{card}]", flush=True)
    if spilled != len(est_names):
        raise AssertionError(f"phase 2c: {spilled} feature files for {len(est_names)} images")
    if not reg_err < REGISTRATION_MAX_M:
        raise AssertionError(f"phase 2c: registration error {reg_err} m")
    if not centre_err < CENTRE_MAX_M:
        raise AssertionError(f"phase 2c: a camera centre is {centre_err} m off the truth")
    if not files or any(a != b or a == 0 for a, b in counts):
        raise AssertionError(f"phase 2c: match files {counts}")
    return run["launches"]


def mesh_terrain_error(path):
    """(vertices, median m, 90th percentile m) of |z - terrain_height(x, y)|
    over a mesh's vertices."""
    import numpy as np
    from multiview_tpu_torch.io import ply
    from multiview_tpu_torch.utils.synthetic import terrain_height

    v = ply.read_ply(path)["vertices"]
    err = np.abs(v[:, 2] - terrain_height(v[:, 0], v[:, 1]))
    return len(v), float(np.median(err)), float(np.percentile(err, 90))


def fuse_mesh(torch, out: Path, ws: Path, extra):
    """``fuse-mesh`` in process; returns (wall, log)."""
    from multiview_tpu_torch.__main__ import main as cli_main

    argv = ["fuse-mesh", "--rig_config", str(ws / "rig_config.txt"), "--camera_poses",
            str(ws / "cameras.txt"), "--images", str(ws / "images"), "--out_dir", str(out)]
    tee = Tee(sys.stdout)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        ret = cli_main(argv + FUSE_FLAGS + extra)
    torch.cuda.synchronize()
    if ret != 0:
        raise AssertionError(f"fuse-mesh returned {ret}")
    return time.perf_counter() - t0, tee.buf.getvalue()


def dense_pair_checks(torch, dev, card, ws: Path):
    """One pair of the workspace: at full size on the card, the cost pass, the
    SGM aggregation and the cloud filter's k-NN timed alone; at 640x480 with
    32 planes, ``plane_sweep`` (SGM) on the card in float32 against the CPU in
    float64."""
    import numpy as np
    from multiview_tpu_torch.dense import pc_filter, stereo
    from multiview_tpu_torch.geometry import pose as P
    from multiview_tpu_torch.io import nvm as nvm_io, rig_config as rc
    from multiview_tpu_torch.tools import common
    from multiview_tpu_torch.utils import images, undistort

    names, mats = nvm_io.read_camera_poses(ws / "cameras.txt")
    sci = [i for i, n in enumerate(names) if Path(n).parent.name == "sci_cam"][3:5]
    sensor = rc.read_rig_config(ws / "rig_config.txt").sensors[1]
    cam = common.cam_params_from_sensor(sensor, dtype=torch.float32, device=dev)
    imgs = [undistort.undistort_image(torch.as_tensor(common.load_gray(names[i]), device=dev),
                                      cam)[0] for i in sci]
    K = cam.intrinsic_matrix("undistorted").double().cpu().numpy()
    w2c = [P.matrix_to_pose(torch.as_tensor(mats[i])) for i in sci]
    r2n = P.pose_compose(w2c[1], P.pose_inverse(w2c[0])).numpy()
    focal, center = K[[0, 1], [0, 1]], K[:2, 2]
    sweep = dict(min_depth=1.5, max_depth=3.0)

    def timed(fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    stereo.plane_sweep(*imgs, focal, center, r2n, num_planes=64, **sweep)       # warm-up
    _, wta_s = timed(stereo.plane_sweep, *imgs, focal, center, r2n, num_planes=64, **sweep)
    res, sgm_total_s = timed(stereo.plane_sweep, *imgs, focal, center, r2n, num_planes=64,
                             aggregate="sgm", **sweep)
    H, W = imgs[0].shape
    cost = torch.rand((H, W, 64), device=dev)
    _, sgm_s = timed(stereo.sgm_aggregate, cost)
    del cost
    cloud = stereo.stereo_pair_to_cloud(res, focal, center, subsample=2)
    pts = torch.as_tensor(cloud, dtype=torch.float32, device=dev)
    _, knn_s = timed(pc_filter.knn_mean_distance, pts)
    print(f"[phase7] one sci_cam pair at {W}x{H} on the card: plane sweep with 64 planes "
          f"(cost pass and winner-take-all) {wta_s * 1e3:.1f} ms, with SGM {sgm_total_s * 1e3:.1f} "
          f"ms; sgm_aggregate alone on [{H},{W},64] {sgm_s * 1e3:.1f} ms; knn_mean_distance "
          f"(k = 8) of its cloud of {len(cloud)} points {knn_s * 1e3:.1f} ms "
          f"({len(cloud) ** 2 / knn_s / 1e9:.2f} G pair distances/s) [{card}]", flush=True)

    half = [images.adjust_image_size((W // 2, H // 2), im.double().cpu().numpy()) for im in imgs]
    f2, c2 = focal / 2.0, (center - 0.5) / 2.0
    out = {}
    for name, d, dt in (("cuda", dev, torch.float32), ("cpu", torch.device("cpu"), torch.float64)):
        a, b = (torch.as_tensor(h, dtype=dt, device=d) for h in half)
        out[name], sec = timed(stereo.plane_sweep, a, b, f2, c2, r2n, num_planes=32,
                               aggregate="sgm", **sweep)
        out[name] = [x.cpu() for x in out[name]]
        out[name + "_s"] = sec
    vg, vc = out["cuda"][2], out["cpu"][2]
    agree = float((vg == vc).double().mean())
    both = vg & vc
    rel = ((out["cuda"][0].double() - out["cpu"][0]).abs() / out["cpu"][0])[both]
    print(f"[phase7] plane_sweep SGM at {W // 2}x{H // 2}, 32 planes: card (float32) "
          f"{out['cuda_s']:.2f} "
          f"s, CPU (float64) {out['cpu_s']:.2f} s; valid masks agree on {agree:.5f} of the "
          f"pixels ({int(vg.sum())} and {int(vc.sum())} valid); relative depth difference "
          f"where both are valid: median {float(rel.median()):.3g}, 99th percentile "
          f"{float(rel.quantile(0.99)):.3g}, max {float(rel.max()):.3g} [{card}]", flush=True)
    if agree < 0.98 or float(rel.median()) > 1e-3:
        raise AssertionError(f"phase 7: plane sweep on the card disagrees with the CPU: "
                             f"masks {agree}, median relative depth {float(rel.median())}")


def phase7(torch, dev, card, workdir: Path):
    """``fuse-mesh`` on the three-sensor workspace, a resume from mesh_gen,
    and the one-pair checks."""
    import numpy as np
    from multiview_tpu_torch.io import ply

    ws, out = workdir / "ws3", workdir / "fused"
    wall, text = fuse_mesh(torch, out, ws, [])
    counts = [int(n) for n in re.findall(r"^pair \S+ / \S+: (\d+) points", text, re.M)]
    kept = [(int(a), int(b)) for a, b in re.findall(r"kept (\d+)/(\d+)", text)]
    stages = dict(re.findall(r"(\w+)=(\S+)", re.search(r"stage seconds: (.*)", text).group(1)))
    pair_dirs = sorted(out.glob("*/stereo/*"))
    layout_ok = all((d / f).is_file() for d in pair_dirs for f in (
        "run-PC.pcd", "run-PC-filter.pcd", "run-PC-debug.ply", "run_cam2world.txt"))
    index_lines = sum(len((out / s / "voxblox_index.txt").read_text().splitlines())
                      for s in ("nav_cam", "sci_cam", "haz_cam"))
    n_vert, med, p90 = mesh_terrain_error(out / "fused_mesh.ply")
    print(f"[phase7] fuse-mesh on {len(counts)} pairs of 1280x960 ({' '.join(FUSE_FLAGS)}): "
          f"wall {wall:.2f} s; stage seconds {stages}; points per pair min {min(counts)} "
          f"median {int(np.median(counts))} max {max(counts)}; kept by pc_filter "
          f"{sum(a for a, _ in kept) / sum(b for _, b in kept):.4f}; fused mesh {n_vert} "
          f"vertices, vertical error against the terrain median {med:.5f} m, 90th "
          f"percentile {p90:.5f} m [{card}]", flush=True)
    if len(counts) != FUSE_PAIRS or len(pair_dirs) != FUSE_PAIRS or not layout_ok \
            or index_lines != 2 * FUSE_PAIRS:
        raise AssertionError(f"phase 7: {len(counts)} pairs, {len(pair_dirs)} pair directories "
                             f"(layout complete: {layout_ok}), {index_lines} index lines")
    if np.median(counts) < MIN_MEDIAN_PAIR_POINTS or n_vert < MIN_MESH_VERTICES:
        raise AssertionError(f"phase 7: too few points ({np.median(counts)} per pair, median) "
                             f"or vertices ({n_vert})")
    if not (med <= MESH_MEDIAN_MAX_M and p90 <= MESH_P90_MAX_M):
        raise AssertionError(f"phase 7: fused mesh {med} m (median), {p90} m (90th percentile) "
                             f"off the terrain")

    first = ply.read_ply(out / "fused_mesh.ply")
    wall2, _ = fuse_mesh(torch, out, ws, ["--first_step", "mesh_gen"])
    again = ply.read_ply(out / "fused_mesh.ply")
    same = (np.array_equal(first["faces"], again["faces"])
            and np.allclose(first["vertices"], again["vertices"], rtol=0, atol=1e-9))
    print(f"[phase7] resume with --first_step mesh_gen: wall {wall2:.2f} s, the same mesh: "
          f"{same} [{card}]", flush=True)
    if not same:
        raise AssertionError("phase 7: the resumed run wrote another mesh")
    dense_pair_checks(torch, dev, card, ws)


def phase7b(torch, card, workdir: Path):
    """``undistort`` of the sci_cam frames; one frame against a pinhole render
    of the terrain with the undistorted intrinsics."""
    import numpy as np
    from multiview_tpu_torch.__main__ import main as cli_main
    from multiview_tpu_torch.geometry import camera as cam_mod, pose as P
    from multiview_tpu_torch.io import nvm as nvm_io, rig_config as rc
    from multiview_tpu_torch.tools import common
    from multiview_tpu_torch.utils import images, synthetic as syn

    ws, out = workdir / "ws3", workdir / "undistorted"
    frames = sorted((ws / "images" / "sci_cam").glob("*.pgm"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ret = cli_main(["undistort", "--rig_config", str(ws / "rig_config.txt"), "--sensor",
                    "sci_cam", "--images", *map(str, frames), "--out_dir", str(out)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    intr = out / "undistorted_intrinsics.txt"
    if ret != 0 or not intr.is_file() or len(list(out.glob("*.pgm"))) != len(frames):
        raise AssertionError(f"phase 7b: undistort returned {ret} or wrote too little")
    w, h, f, cx, cy = (float(v) for v in intr.read_text().splitlines()[1].split())
    names, mats = nvm_io.read_camera_poses(ws / "cameras.txt")
    k = len(frames) // 2
    w2c = mats[[Path(n).name for n in names].index(frames[k].name)]
    pinhole = cam_mod.CameraParams.create((int(w), int(h)), f, (cx, cy), device="cpu")
    render = syn.render_terrain(pinhole, P.matrix_to_pose(torch.as_tensor(w2c)).numpy())
    got = images.read_pgm(out / frames[k].name).astype(np.float64)
    # the valid area: undistorted pixels whose source lies a pixel inside the frame
    sensor = rc.read_rig_config(ws / "rig_config.txt").sensors[1]
    cam = common.cam_params_from_sensor(sensor, device="cpu")
    vs, us = np.mgrid[0:int(h), 0:int(w)]
    src = cam.convert(torch.as_tensor(np.stack([us, vs], -1), dtype=torch.float64),
                      cam_mod.UNDISTORTED, cam_mod.DISTORTED).numpy()
    inside = ((src[..., 0] >= 1) & (src[..., 0] <= sensor.image_size[0] - 2)
              & (src[..., 1] >= 1) & (src[..., 1] <= sensor.image_size[1] - 2))
    diff = np.abs(got - np.clip(render * 255.0, 0, 255))[inside]
    print(f"[phase7b] undistort of {len(frames)} sci_cam frames of 1280x960: wall {wall:.2f} s; "
          f"undistorted intrinsics {w:.0f}x{h:.0f} f {f} c ({cx}, {cy}); frame {frames[k].name} "
          f"against a pinhole render of its pose over {inside.mean():.4f} of the pixels: "
          f"median |difference| {np.median(diff):.3f} gray levels, 90th percentile "
          f"{np.percentile(diff, 90):.3f} [{card}]", flush=True)
    if not np.median(diff) < UNDISTORT_MEDIAN_MAX:
        raise AssertionError(f"phase 7b: undistorted frame {np.median(diff)} gray levels "
                             f"(median) off the pinhole render")


def texture_spies(texturing):
    """Wrap ``render_atlas`` and ``write_textured_obj`` of the texturing
    module to keep what the ``texture`` tool hands them: the render's
    arguments (atlas, mesh, labels, visibility, images, cameras, poses), the
    atlas and the final pages. Returns (record, undo)."""
    record = {}
    render, write = texturing.render_atlas, texturing.write_textured_obj

    def render_spy(*a, **kw):
        record["render_args"] = a
        return render(*a, **kw)

    def write_spy(prefix, vertices, faces, atlas, page):
        record["atlas"], record["pages"] = atlas, page
        return write(prefix, vertices, faces, atlas, page)

    texturing.render_atlas, texturing.write_textured_obj = render_spy, write_spy

    def undo():
        texturing.render_atlas, texturing.write_textured_obj = render, write
    return record, undo


def texel_albedo_error(atlas, pages, visible):
    """|page - albedo| in gray levels at every texel of the charts of the
    visible faces: each texel lifted to 3D (the chart origin plus its basis
    times the texel offset and the pixel size) and the terrain's analytic
    albedo (``synthetic._texture_at``, a function of x and y; the renders
    carry no shading) read there."""
    import numpy as np
    from multiview_tpu_torch.utils import synthetic as syn

    pages = pages if isinstance(pages, list) else [pages]
    errs = []
    for f_sel in np.array_split(np.nonzero(visible)[0], 64):
        wh = atlas.face_wh[f_sel]
        n = (wh[:, 0] * wh[:, 1]).astype(np.int64)
        face = np.repeat(f_sel, n)
        j = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
        tx, ty = j % atlas.face_wh[face, 0], j // atlas.face_wh[face, 0]
        pts = (atlas.face_origin3d[face]
               + (tx * atlas.pixel_size)[:, None] * atlas.face_basis[face, 0]
               + (ty * atlas.pixel_size)[:, None] * atlas.face_basis[face, 1])
        got = np.zeros(len(face))
        pg = atlas.face_page[face]
        for p in np.unique(pg):
            m = pg == p
            texel = pages[p][atlas.face_uv0[face[m], 1] + ty[m], atlas.face_uv0[face[m], 0] + tx[m]]
            got[m] = texel.mean(axis=-1) if texel.ndim == 2 else texel
        errs.append(np.abs(got - syn._texture_at(pts)) * 255.0)
    return np.concatenate(errs)


def phase8(torch, card, workdir: Path):
    """``texture`` in process on phase 7's fused mesh with the 34 frames of the
    three-sensor workspace and the tool's defaults."""
    import ast

    import numpy as np
    from multiview_tpu_torch.__main__ import main as cli_main
    from multiview_tpu_torch.texture import texturing
    from multiview_tpu_torch.utils.images import read_png

    ws, out = workdir / "ws3", workdir / "textured"
    argv = ["texture", "--rig_config", str(ws / "rig_config.txt"), "--camera_poses",
            str(ws / "cameras.txt"), "--images", str(ws / "images"), "--mesh",
            str(workdir / "fused" / "fused_mesh.ply"), "--out_dir", str(out)] + TEXTURE_FLAGS
    record, undo = texture_spies(texturing)
    tee = Tee(sys.stdout)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            ret = cli_main(argv)
    finally:
        undo()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    text = tee.buf.getvalue()
    if ret != 0:
        raise AssertionError(f"phase 8: texture returned {ret}")
    n_vert, n_face = (int(v) for v in re.search(r"Mesh: (\d+) verts, (\d+) faces", text).groups())
    views = int(re.search(r"Texturing from (\d+) views", text).group(1))
    method, pairs = re.search(r"Occlusion: (\w+) for (\d+) face-view pairs", text).groups()
    stages = {k: float(v) for k, v in re.findall(r"\[texture\] (.+?): (\S+) s", text)}
    e_arg, e_icm = (float(v) for v in re.search(r"argmin (\S+) -> ICM (\S+)", text).groups())
    sweeps, resid = re.search(r"Global seam leveling: (\d+) sweeps, relative residual (\S+)",
                              text).groups()
    seam = {k: ast.literal_eval(v) for k, v in re.findall(
        r"Seam step (before|after) local leveling: (\{.*\})", text)}
    atlas, pages = record["atlas"], record["pages"]
    pages = pages if isinstance(pages, list) else [pages]
    multi = len(pages) > 1
    png_equal = all(np.array_equal(
        read_png(out / (f"textured_mesh_{p}.png" if multi else "textured_mesh.png")),
        (np.clip(pg, 0, 1) * 255).astype(np.uint8)) for p, pg in enumerate(pages))
    verts, faces, _, visible = (np.asarray(a) for a in record["render_args"][1:5])
    tri = verts[faces]
    down = float((np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])[:, 2] < 0).mean())
    err = texel_albedo_error(atlas, pages, visible)
    med, p90 = float(np.median(err)), float(np.percentile(err, 90))
    # the same labels rendered without the seam leveling's gains
    raw = texel_albedo_error(atlas, texturing.render_atlas(*record["render_args"]), visible)
    raw_med, raw_p90 = float(np.median(raw)), float(np.percentile(raw, 90))
    print(f"[phase8] texture of the fused mesh ({n_vert} vertices, {n_face} faces) from {views} "
          f"views ({' '.join(TEXTURE_FLAGS)}): wall {wall:.2f} s; stage seconds {stages}; "
          f"occlusion {method} for {pairs} face-view pairs; visible faces {int(visible.sum())} "
          f"(faces whose normal points down: {down:.4f}); "
          f"atlas {atlas.num_pages} page(s) {list(atlas.page_sizes)}; MRF energy argmin "
          f"{e_arg:.4f} -> ICM {e_icm:.4f}; global leveling {sweeps} sweeps, relative residual "
          f"{resid}; seam step before {seam.get('before')}; after {seam.get('after')}; PNG "
          f"reads back equal: {png_equal}; texels of visible faces {len(err)}: |page - albedo| "
          f"median {med:.3f}, 90th percentile {p90:.3f} gray levels; rendered without the "
          f"leveling's gains: median {raw_med:.3f}, 90th percentile {raw_p90:.3f}; peak device "
          f"memory {peak / 2**30:.2f} GiB [{card}]", flush=True)
    if method != "grid" or int(pairs) != n_face * views or views != 3 * N_REF - 2:
        raise AssertionError(f"phase 8: occlusion {method} for {pairs} pairs, {views} views")
    if not all((out / f"textured_mesh.{e}").is_file() for e in ("obj", "mtl")) or not png_equal:
        raise AssertionError("phase 8: the OBJ, MTL or PNG is missing, or the PNG reads back "
                             "other pixels than the page")
    if not e_icm <= e_arg:
        raise AssertionError(f"phase 8: ICM energy {e_icm} above argmin's {e_arg}")
    if not (float(resid) <= 1e-4 or int(sweeps) >= 2000):
        raise AssertionError(f"phase 8: global leveling stopped at {sweeps} sweeps with a "
                             f"relative residual {resid}")
    if not seam["after"]["seam_mean"] <= seam["before"]["seam_mean"]:
        raise AssertionError(f"phase 8: local leveling raised the seam step: {seam}")
    if not (med <= ALBEDO_MEDIAN_MAX and p90 <= ALBEDO_P90_MAX
            and raw_med <= RENDER_MEDIAN_MAX and raw_p90 <= RENDER_P90_MAX):
        raise AssertionError(f"phase 8: texture {med} (median), {p90} (90th percentile) gray "
                             f"levels off the albedo; without gains {raw_med}, {raw_p90}")
    return {"wall": wall, "stages": stages}


def phase8b(torch, dev, card, workdir: Path):
    """A window of the fused mesh with all 34 views: ``view_costs`` with the
    exact ray cast and with the grid march on the card, timed, and the labels
    of ``view_costs`` (grid) + ``mrf_view_selection`` on the card (float32)
    against the CPU (float64)."""
    import numpy as np
    from multiview_tpu_torch.geometry import pose as P
    from multiview_tpu_torch.io import nvm as nvm_io, ply
    from multiview_tpu_torch.texture import texturing as TT

    mesh = ply.read_ply(workdir / "fused" / "fused_mesh.ply")
    verts, faces = mesh["vertices"], mesh["faces"]
    ctr = verts[faces].mean(axis=1)
    lo = np.median(ctr[:, :2], axis=0) - WINDOW_SIDE / 2
    inside = np.all((ctr[:, :2] >= lo) & (ctr[:, :2] < lo + WINDOW_SIDE), axis=1)
    win = faces[inside]
    _, mats = nvm_io.read_camera_poses(workdir / "ws3" / "cameras.txt")
    poses = P.matrix_to_pose(torch.as_tensor(np.asarray(mats, np.float64)))

    def timed(fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    def on(device, dtype):
        return (torch.as_tensor(verts, dtype=dtype, device=device),
                torch.as_tensor(win, device=device).long(), poses.to(device=device, dtype=dtype))

    v, f, p = on(dev, torch.float32)
    TT.view_costs(v, f, p, occlusion_method="exact")                 # warm-up
    TT.view_costs(v, f, p, occlusion_method="grid")
    (_, exact), exact_s = timed(TT.view_costs, v, f, p, occlusion_method="exact")
    (_, grid), grid_s = timed(TT.view_costs, v, f, p, occlusion_method="grid")
    _, free = TT.view_costs(v, f, p, occlusion=False)
    agree = float((exact == grid)[free].double().mean())
    nbr = TT.face_neighbors(win, TT.face_adjacency(win))
    labels = {}
    for name, d, dt in (("cuda", dev, torch.float32), ("cpu", torch.device("cpu"), torch.float64)):
        vv, ff, pp = on(d, dt)
        (cost, usable), sec = timed(TT.view_costs, vv, ff, pp, occlusion_method="grid")
        best, vis = TT.mrf_view_selection(cost, usable, nbr)
        labels[name] = (best.cpu().numpy(), vis.cpu().numpy(), sec)
    (bg, vg, sg), (bc, vc, sc) = labels["cuda"], labels["cpu"]
    both = vg & vc
    same = float((bg == bc)[both].mean())
    n_rays = int(free.sum())
    print(f"[phase8b] window of {WINDOW_SIDE} m x {WINDOW_SIDE} m: {len(win)} faces x "
          f"{len(poses)} views, {n_rays} geometrically usable face-view pairs; view_costs on the "
          f"card: exact ray cast {exact_s * 1e3:.1f} ms ({n_rays} rays x {len(win)} triangles), "
          f"grid march {grid_s * 1e3:.1f} ms; usable exact {int(exact.sum())}, grid "
          f"{int(grid.sum())}; they agree on {agree:.5f} of the usable entries; view_costs "
          f"(grid) + MRF labels: card (float32) {sg * 1e3:.1f} ms, CPU (float64) {sc * 1e3:.1f} "
          f"ms, visible {int(vg.sum())} / {int(vc.sum())}, equal labels on {same:.5f} of the "
          f"faces visible in both [{card}]", flush=True)
    if len(win) < 100 or not (vg == vc).mean() > LABEL_AGREEMENT_MIN \
            or not same >= LABEL_AGREEMENT_MIN:
        raise AssertionError(f"phase 8b: {len(win)} faces; labels on the card and the CPU "
                             f"agree on {same} (visibility {(vg == vc).mean()})")
    return {"exact_ms": exact_s * 1e3, "grid_ms": grid_s * 1e3, "agree": agree}


def phase8c(torch, mm, card, workdir: Path):
    """``calibrate --mesh --out_texture_dir`` on the two-sensor workspace, one
    short pass: one OBJ/MTL/PNG triple per image, each PNG the image the run
    held, faces kept for every camera; the projection step timed."""
    import numpy as np
    from multiview_tpu_torch.io import nvm as nvm_io
    from multiview_tpu_torch.tools import common
    from multiview_tpu_torch.utils import synthetic as syn
    from multiview_tpu_torch.utils.images import read_png

    ws, out, tex = workdir / "ws", workdir / "calib_tex", workdir / "tex_per_camera"
    n_tri = syn.write_terrain_mesh(workdir / "coarse.ply", step=OUT_TEXTURE_MESH_STEP)
    run = run_calibrate(torch, mm, "phase 8c", ws, out, [
        "--num_iterations", "5", "--calibrator_num_passes", "1", "--mesh",
        str(workdir / "coarse.ply"), "--out_texture_dir", str(tex)], passes=1)
    # the images the run kept (the bracketing's camera entries)
    images = [Path(n) for n in nvm_io.read_camera_poses(out / "cameras.txt")[0]]
    want = {f"{float(p.stem):10.7f}_{p.parent.name}": p for p in images}
    got = sorted(tex.iterdir())
    names_ok = sorted(q.name for q in got) == sorted(
        f"{k}.{e}" for k in want for e in ("obj", "mtl", "png"))
    png_ok = names_ok and all(np.array_equal(
        read_png(tex / f"{k}.png"),
        (np.clip(common.load_gray(p), 0, 1) * 255).astype(np.uint8)) for k, p in want.items())
    kept = [sum(ln.startswith("f ") for ln in (tex / f"{k}.obj").read_text().splitlines())
            for k in want] if names_ok else []
    print(f"[phase8c] calibrate --mesh ({n_tri} triangles) --out_texture_dir, 1 pass of 5 "
          f"iterations: wall {run['wall']:.2f} s; projection step "
          f"{run['stages'].get('out_texture')} s for {len(want)} images; files {len(got)}; "
          f"PNGs equal to the images held: {png_ok}; faces kept per camera min "
          f"{min(kept, default=0)} max {max(kept, default=0)}; matcher launches "
          f"{run['launches']} [{card}]", flush=True)
    if not (names_ok and png_ok and kept and min(kept) > 0):
        raise AssertionError(f"phase 8c: names {names_ok}, PNGs {png_ok}, faces kept {kept}")
    return run["launches"]


def solve_gap(ref, got):
    """(initial cost, final cost) relative gaps and the largest camera-vector
    difference of two solves."""
    return (rel_gap(got.initial_cost, ref.initial_cost), rel_gap(got.cost, ref.cost),
            float((got.cam.to(ref.cam.device) - ref.cam).abs().max()))


def hold_gap(tag, gap):
    """Phase 9's bars on a sharded solve against the unsharded one."""
    if not (gap[0] <= 1e-6 and gap[1] <= SHARDED_COST_RTOL and gap[2] <= SHARDED_CAM_ATOL):
        raise AssertionError(f"{tag}: the sharded solve is off the unsharded one: initial "
                             f"cost {gap[0]:.3g}, final cost {gap[1]:.3g} (bar "
                             f"{SHARDED_COST_RTOL}), cameras {gap[2]:.3g} (bar "
                             f"{SHARDED_CAM_ATOL})")


def phase9a(torch, card):
    """Phase 3's solve with its observations sharded 4 ways on cuda:0 (and
    over every card where there are several) against the unsharded solve."""
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.parallel import sharding as sh

    dev = torch.device("cuda", 0)
    scene, state0, make = ba_problem(torch, dev, 160, 20)
    solver = make()
    cam0 = prob.pack_state(state0, include_points=False)

    def timed(obs):
        solver(cam0, state0.points, obs)                # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver(cam0, state0.points, obs)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    ref, wall1 = timed(None)
    meshes = [("4 shards on cuda:0", sh.make_mesh([dev] * SHARDS))]
    if torch.cuda.device_count() > 1:
        meshes.append((f"{torch.cuda.device_count()} cards",
                       sh.make_mesh([torch.device("cuda", i)
                                     for i in range(torch.cuda.device_count())])))
    out = {"wall_unsharded": wall1}
    for what, mesh in meshes:
        with schur_counted(f"phase 9a ({what})", "sharded"):
            got, wall = timed(sh.shard_observations(scene.observations, mesh))
        gap = solve_gap(ref, got)
        print(f"[phase9a] cube 160x20, 10 LM x 30 CG, float32: unsharded wall {wall1:.4f} s "
              f"({ref.iterations / wall1:.3f} LM it/s, {ref.iterations} LM, "
              f"{int(ref.cg_iters_total)} CG); sharded over {what}: wall {wall:.4f} s "
              f"({got.iterations / wall:.3f} LM it/s, {got.iterations} LM, "
              f"{int(got.cg_iters_total)} CG); cost {float(ref.initial_cost):.7g} -> "
              f"{float(ref.cost):.7g} unsharded, {float(got.initial_cost):.7g} -> "
              f"{float(got.cost):.7g} sharded; relative gaps initial {gap[0]:.3g}, final "
              f"{gap[1]:.3g}; cameras max |diff| {gap[2]:.3g} [{card}]", flush=True)
        hold_gap(f"phase 9a ({what})", gap)
        out.setdefault("wall_sharded", wall)
        out.setdefault("gap", gap)
    return out


def phase9b(torch, mm, card, workdir: Path, rig_true):
    """``calibrate`` with the depth camera through ``run(args, mesh)`` with a
    4-shard mesh on cuda:0, held to phase 4's bars."""
    from multiview_tpu_torch.parallel import sharding as sh

    mesh = sh.make_mesh([torch.device("cuda", 0)] * SHARDS)
    run = calibrate_with_depth(torch, mm, card, "phase 9b", workdir, workdir / "calib9b",
                               rig_true, [], mesh=mesh)
    line = f"Sharded observations over {SHARDS} devices (1 process(es))"
    if line not in run["text"]:
        raise AssertionError(f"phase 9b: calibrate did not print '{line}'")
    return run["launches"]


def phase9c(torch, mm, card, workdir: Path):
    """The front end on phase 4's 34 images sharded 4 ways on cuda:0:
    keypoints, descriptors, match sets and tracks bit for bit the unsharded
    path's; the sharded ``detect_match_features`` launches counted."""
    import numpy as np
    from multiview_tpu_torch.parallel import sharding as sh
    from multiview_tpu_torch.sfm import pipeline as fe
    from multiview_tpu_torch.tools import common

    dev = torch.device("cuda", 0)
    recs = common.scan_image_dir(workdir / "ws3" / "images", ["nav_cam", "sci_cam", "haz_cam"])
    images = [r.payload for rs in recs for r in rs]
    n = len(images)
    cfg = fe.FrontendConfig(max_features=4096, num_overlaps=3)
    pair_ids = [(i, j) for i in range(n) for j in range(i + 1, min(i + 4, n))]
    mesh = sh.make_mesh([dev] * SHARDS)
    kps1, descs1 = fe.detect_all(images, cfg, device=dev)
    raw1 = fe.match_pairs_batched(kps1, descs1, pair_ids, cfg)
    kps4, descs4 = fe.detect_all(images, cfg, mesh=mesh)
    raw4 = fe.match_pairs_batched(kps4, descs4, pair_ids, cfg, mesh=mesh)
    same_feat = all(torch.equal(a, b) for k1, k4 in zip(kps1, kps4) for a, b in zip(k1, k4)) \
        and all(torch.equal(a, b) for a, b in zip(descs1, descs4))
    same_match = list(raw1) == list(raw4) and all(
        np.array_equal(a, b) for k in raw1 for a, b in zip(raw1[k], raw4[k]))
    walls, launches, tracks = {}, {}, {}
    for what, kw in (("unsharded", {"device": dev}), ("sharded", {"mesh": mesh})):
        mm.WGMMA_LAUNCHES = mm.FMA_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracks[what] = fe.detect_match_features(images, cfg, **kw)
        torch.cuda.synchronize()
        walls[what] = time.perf_counter() - t0
        launches[what] = (mm.WGMMA_LAUNCHES, mm.FMA_LAUNCHES)
    same_tracks = tracks["sharded"].tracks == tracks["unsharded"].tracks
    print(f"[phase9c] front end on {n} images of 1280x960 ({len(pair_ids)} pairs, 4096 "
          f"features), {SHARDS} shards on cuda:0: keypoints and descriptors equal {same_feat}; "
          f"match sets equal {same_match} ({sum(len(v[0]) for v in raw4.values())} matches); "
          f"tracks equal {same_tracks} ({len(tracks['sharded'].tracks)}); "
          f"detect_match_features wall unsharded {walls['unsharded']:.3f} s, sharded "
          f"{walls['sharded']:.3f} s; (tensor-core, FMA) launches unsharded "
          f"{launches['unsharded']}, sharded {launches['sharded']} [{card}]", flush=True)
    if not (same_feat and same_match and same_tracks):
        raise AssertionError("phase 9c: the sharded front end differs from the unsharded one")
    if launches["sharded"][0] <= 0 or launches["sharded"][1] != 0:
        raise AssertionError(f"phase 9c: launches {launches['sharded']}")
    return launches["sharded"][0]


def phase9e(torch, card, workdir: Path):
    """Three of phase 7's stereo clouds fused into a grid of 4 X slabs on
    cuda:0 against the whole grid, as fuse-mesh fuses them."""
    import numpy as np
    from multiview_tpu_torch.dense import marching, tsdf
    from multiview_tpu_torch.geometry import pose as P
    from multiview_tpu_torch.io import depth_io
    from multiview_tpu_torch.parallel import sharding as sh

    dev = torch.device("cuda", 0)
    files = sorted((workdir / "fused").glob("*/stereo/*/run-PC-filter.pcd"))[:3]
    clouds = [(depth_io.read_pcd(f)[0], np.loadtxt(f.parent / "run_cam2world.txt"))
              for f in files]
    voxel = float(FUSE_FLAGS[FUSE_FLAGS.index("--voxel_size") + 1])
    allc = np.concatenate([xyz @ c2w[:3, :3].T + c2w[:3, 3] for xyz, c2w in clouds])
    lo = np.percentile(allc, 2, axis=0) - 2 * voxel
    hi = np.percentile(allc, 98, axis=0) + 2 * voxel
    dims = tuple(int(d) for d in np.minimum(np.ceil((hi - lo) / voxel).astype(int) + 1, 320))
    grid = tsdf.make_grid(dims, origin=lo, voxel_size=voxel, device=dev)
    mesh = sh.make_mesh([dev] * SHARDS)

    def fuse(g):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pts, c2w in clouds:
            vres = max(64, int(np.sqrt(len(pts)) * 2))
            g = tsdf.integrate_point_cloud(
                g, torch.as_tensor(pts, dtype=torch.float32, device=dev),
                P.matrix_to_pose(torch.as_tensor(c2w)), focal=(vres * 0.8, vres * 0.8),
                image_size=(vres, (vres * 3) // 4), max_range=3.0)
        torch.cuda.synchronize()
        return g, time.perf_counter() - t0

    whole, wall1 = fuse(grid)
    sharded, wall4 = fuse(sh.shard_tsdf_grid(grid, mesh))
    back = sharded.gather()
    err = max(float((back.tsdf - whole.tsdf).abs().max()),
              float((back.weight - whole.weight).abs().max()))
    m1, m4 = marching.extract_mesh(whole), marching.extract_mesh(sharded)
    same_mesh = all(np.array_equal(a, b) for a, b in zip(m1, m4))
    print(f"[phase9e] {len(clouds)} stereo clouds of phase 7 into a {dims} grid: whole "
          f"{wall1 * 1e3:.1f} ms, {SHARDS} X slabs of {sharded.blocks[0].shape} on cuda:0 "
          f"{wall4 * 1e3:.1f} ms; max |diff| {err:.3g} (bar 1e-5); voxels hit "
          f"{int((whole.weight > 0).sum())}; meshes equal {same_mesh} ({len(m1[0])} vertices) "
          f"[{card}]", flush=True)
    if not (err <= 1e-5 and same_mesh and float(whole.weight.sum()) > 0):
        raise AssertionError(f"phase 9e: the slab-sharded grid is off the whole one: {err}")


def phase9d_worker(rank: int, world: int, port: int, out: str) -> int:
    """One of phase 9d's two ranks on cuda:0: a gloo group, 2 shards a rank."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.parallel import distributed as pdist, sharding as sh
    from multiview_tpu_torch.solver import (assembly as asm, cg, cg_solve, row_blocks as rb,
                                            schur_matvec as smv)

    if not pdist.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo"):
        raise AssertionError("phase 9d: the worker joined no group")
    dev = torch.device("cuda", 0)
    mesh = sh.make_mesh([dev] * 2, group=dist.group.WORLD)
    scene, state0, make = ba_problem(torch, dev, *MP_CUBE)
    solver = make()
    obs = sh.shard_observations(scene.observations, mesh)
    res = solver(prob.pack_state(state0, include_points=False), state0.points, obs)
    # the gloo collectives take the CUDA tensors as they are: the solve's
    # all-reduces, and the all-gather of the calibrator's bookkeeping
    whole = sh.gathered(obs.pixels[0])
    gathered = all(torch.equal(getattr(whole, f), getattr(scene.observations.pixels[0], f))
                   for f in ("pix", "point_idx", "mask"))
    torch.cuda.synchronize()
    np.savez(out, cam=res.cam.cpu().numpy(), points=res.points.cpu().numpy(),
             cost=float(res.cost), initial_cost=float(res.initial_cost),
             iterations=res.iterations, cg=int(res.cg_iters_total), lam=float(res.lam),
             size=mesh.size, gathered=gathered, device=str(res.cam.device),
             schur_launches=smv.LAUNCHES, row_launches=rb.LAUNCHES, asm_launches=asm.LAUNCHES,
             cg_launches=cg.LAUNCHES, solve_launches=cg_solve.LAUNCHES)
    dist.destroy_process_group()
    return 0


def phase9d(torch, card, workdir: Path):
    """Two processes on the one card, 2 shards each, joined by gloo: both
    ranks bit for bit equal, and within phase 9a's bars of the one-process
    unsharded solve; then NCCL at world size 1 with 4 shards."""
    import numpy as np
    import socket
    import torch.distributed as dist
    from multiview_tpu_torch.calib import problem as prob
    from multiview_tpu_torch.parallel import distributed as pdist, sharding as sh

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    port = free_port()
    outs = [workdir / f"rank{r}.npz" for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-u", str(ROOT / "chip_smoke.py"),
                               "--phase9d-worker", str(r), "2", str(port), str(outs[r])],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"phase 9d: a rank failed:\n{log[-3000:]}")
    r0, r1 = (dict(np.load(o)) for o in outs)
    counts = {"schur_launches": SCHUR_PATHS, "row_launches": ROW_PATHS,
              "asm_launches": ASM_PATHS, "cg_launches": CG_PATHS}
    for key, paths in counts.items():
        paths["phase 9d (2 gloo ranks)"] = int(r0[key] + r1[key])
    if not all(r[k] > 0 for r in (r0, r1) for k in counts) or r0["solve_launches"] or \
            r1["solve_launches"]:
        raise AssertionError("phase 9d: a rank launched csrc/schur_mv.cu, csrc/row_blocks.cu, "
                             "csrc/lm_assembly.cu or csrc/cg_step.cu no time, or the one-launch "
                             "CG solve, which one shard alone runs")
    same = all(np.array_equal(r0[k], r1[k]) for k in r0
               if k not in counts and k != "solve_launches")

    dev = torch.device("cuda", 0)
    scene, state0, make = ba_problem(torch, dev, *MP_CUBE)
    solver = make()
    cam0 = prob.pack_state(state0, include_points=False)
    ref = solver(cam0, state0.points)

    gap = solve_gap(ref, types.SimpleNamespace(
        cam=torch.as_tensor(r0["cam"], device=dev), cost=r0["cost"],
        initial_cost=r0["initial_cost"]))
    pdist.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        backend = dist.get_backend()
        mesh = sh.make_mesh([dev] * SHARDS, group=dist.group.WORLD)
        with schur_counted("phase 9d (nccl)", "sharded"):
            nccl = solver(cam0, state0.points, sh.shard_observations(scene.observations, mesh))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    gap_nccl = solve_gap(ref, nccl)
    n_obs = sum(len(o) for o in scene.observations.pixels)
    print(f"[phase9d] cube {MP_CUBE[0]}x{MP_CUBE[1]} ({n_obs} observations), 2 processes x 2 "
          f"shards on cuda:0 over gloo: {int(r0['size'])} shards, wall {wall:.2f} s with "
          f"start-up; ranks bit for bit equal {same} ({int(r0['iterations'])} LM, "
          f"{int(r0['cg'])} CG, results on {r0['device']}); gloo all-reduce and all-gather "
          f"of CUDA tensors: the gathered rows whole {bool(r0['gathered'])}; against one "
          f"process unsharded: gaps initial {gap[0]:.3g}, final {gap[1]:.3g}, cameras "
          f"{gap[2]:.3g}; {backend} at world size 1 with {SHARDS} shards: gaps "
          f"{gap_nccl[0]:.3g}, {gap_nccl[1]:.3g}, {gap_nccl[2]:.3g} [{card}]", flush=True)
    if not (same and bool(r0["gathered"])):
        raise AssertionError("phase 9d: the two ranks differ, or a gather lost rows")
    hold_gap("phase 9d (gloo, 2 ranks)", gap)
    hold_gap("phase 9d (nccl, world size 1)", gap_nccl)


def phase10(torch, card):
    """The benchmark's BA cell once, through ``bench_torch``'s entry."""
    from bench_torch import ba_cube
    from bench_torch.common import load_config, workloads

    cell = workloads()["ba_cube_384k"]
    with schur_counted("phase 10"):
        rec = ba_cube.run(load_config(cell), dict(cell, runs={"warm": 1, "timed": 1,
                                                             "traced": 0}),
                          seed=0, log=lambda s: print(f"[phase10] {s}", flush=True))
    keys = ("cell", "seed", "correct", "attempted", "failed", "failures", "metric", "value",
            "unit", "per_layer", "checks")
    print(f"[phase10] {json.dumps({k: rec[k] for k in keys})} [{card}]", flush=True)
    if not rec["correct"] or rec["setup"]["input_sha256_recorded"] is not True:
        raise AssertionError(f"phase 10: the ba_cube_384k cell is not correct: "
                             f"{rec['failures']}, input hash recorded: "
                             f"{rec['setup']['input_sha256_recorded']}")


def main() -> int:
    if not (ROOT / "multiview_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke.py: run it from a checkout of the repository "
                         "(multiview_tpu_torch/ not found beside it)")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; this script only runs on the GPU")
    if sys.argv[1:2] == ["--phase9d-worker"]:
        rank, world, port, out = sys.argv[2:6]
        return phase9d_worker(int(rank), int(world), int(port), out)
    from multiview_tpu_torch.sfm import matching as mm
    from multiview_tpu_torch.utils import cuda_build

    t_start = time.perf_counter()
    card = card_line()
    print(f"[phase0] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} [{card}]", flush=True)
    t0 = time.perf_counter()
    sources = ["knn2_wgmma.cu", "knn2.cu", "schur_mv.cu", "row_blocks.cu", "lm_assembly.cu",
               "cg_step.cu", "lm_step.cu"]
    cuda_build.build_libraries(sources)        # one nvcc each, started together
    print(f"[phase0] built csrc/{{{','.join(sources)}}} for sm_90a in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for src in sources:
        build_s, report = cuda_build.build_reports.get(src, (0.0, "already built"))
        print(f"[phase0] csrc/{src}: nvcc {build_s:.2f} s\n{report}", flush=True)
        cuda_build.load_library(src)
    # the host library of the track builder (g++), built here so that the
    # timed calibrate run of phase 2 does not include its compile
    from multiview_tpu_torch import native
    t0 = time.perf_counter()
    if native.load() is None:
        raise RuntimeError("the host library native/mv_native.cpp did not build (g++): "
                           "phase 2 would time the Python track builder instead")
    print(f"[phase0] host library native/mv_native.cpp built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    dev = torch.device("cuda", 0)
    p1 = phase1(torch, mm, dev, card)
    with tempfile.TemporaryDirectory(prefix="mv_chip_smoke_") as tmp:
        rig_true = render_workspaces(Path(tmp))
        paths = {"phase2": phase2(torch, mm, card, Path(tmp), rig_true),
                 "phase2c": phase2c(torch, mm, card, Path(tmp), rig_true),
                 "phase4": phase4(torch, mm, card, Path(tmp), rig_true),
                 "phase4b": phase4b(torch, mm, dev, card, Path(tmp), rig_true)}
        sfm_run = phase6(torch, mm, card, Path(tmp))
        paths["phase6"] = sfm_run["launches"]
        paths["phase6b"] = phase6b(torch, mm, card, Path(tmp))
        paths["phase6c"] = phase6c(torch, mm, card, Path(tmp), sfm_run)
        phase7(torch, dev, card, Path(tmp))
        phase7b(torch, card, Path(tmp))
        phase8(torch, card, Path(tmp))
        phase8b(torch, dev, card, Path(tmp))
        paths["phase8c"] = phase8c(torch, mm, card, Path(tmp))
        t9 = time.perf_counter()
        paths["phase9b"] = phase9b(torch, mm, card, Path(tmp), rig_true)
        paths["phase9c"] = phase9c(torch, mm, card, Path(tmp))
        phase9e(torch, card, Path(tmp))
        phase9d(torch, card, Path(tmp))
        t9 = time.perf_counter() - t9
    paths["phase2b"] = phase2b(torch, mm, dev, card)
    p3 = phase3(torch, card)
    phase3b(torch, card, p3)
    p3c = phase3c(torch, card)
    p3d = phase3d(torch, card)
    p3e = phase3e(torch, card)
    p3f = phase3f(torch, card)
    p3g = phase3g(torch, card, p3)
    phase5(torch, dev, card)
    t0 = time.perf_counter()
    phase9a(torch, card)
    print(f"[phase9] {t9 + time.perf_counter() - t0:.1f} s in all", flush=True)
    phase10(torch, card)

    print(f"[done] total {time.perf_counter() - t_start:.1f} s", flush=True)
    replaces = "multiview_tpu/sfm/matching.py:118"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    chunk = p1["main_path_8x4096"]
    print(json.dumps({"kernels": [
        {"name": "knn2_wgmma", "route": "cuda", "source": WGMMA_SOURCE, "replaces": replaces,
         "launches": sum(paths.values()), "launches_by_path": paths,
         **{k: chunk[k] for k in keys}, "floor_3xtf32_ms": chunk["floor_3xtf32_ms"],
         "kernels_a_call": chunk["kernels_a_call"],
         "by_shape": {label: {k: r[k] for k in ("ms", "library_ms", "bound_ms",
                                                "floor_3xtf32_ms", "kernels_a_call")}
                      for label, r in p1.items()}},
        # the FP32 oracle: no path launches it
        {"name": "knn2_top2", "route": "cuda", "source": FMA_SOURCE, "replaces": replaces,
         "launches": 0, "on_path": False,
         **{k: chunk[k] for k in keys if k not in ("ms", "max_abs_err")},
         "ms": chunk["fma_ms"], "max_abs_err": chunk["fma_max_abs_err"]},
        # no single PyTorch call computes S x: library_ms is null
        {"name": "schur_mv", "route": "cuda", "source": SCHUR_SOURCE,
         "replaces": "multiview_tpu/solver/schur.py:1147 (schur_mv of cg_blocks, XLA code: "
                     "no pallas_call)",
         "launches": sum(SCHUR_PATHS.values()), "launches_by_path": SCHUR_PATHS,
         **{k: p3c["cube"][k] for k in keys}, "plain_graph_ms": p3c["cube"]["plain_graph_ms"],
         "kernel_graph_ms": p3c["cube"]["kernel_graph_ms"]},
        # no single PyTorch call computes a row's block Jacobian: library_ms is null
        {"name": "row_blocks", "route": "cuda", "source": ROW_SOURCE,
         "replaces": "multiview_tpu/solver/schur.py:88-244 (_pixel/_depth/_prior_row_blocks, "
                     "XLA code: no pallas_call)",
         "launches": sum(ROW_PATHS.values()), "launches_by_path": ROW_PATHS,
         **{k: p3d["cube"][k] for k in keys}, "plain_graph_ms": p3d["cube"]["plain_graph_ms"],
         "kernel_graph_ms": p3d["cube"]["kernel_graph_ms"],
         "by_family": p3d["families"]},
        # no single PyTorch call computes the assembly: library_ms is null
        {"name": "lm_assembly", "route": "cuda", "source": ASM_SOURCE,
         "replaces": "multiview_tpu/solver/schur.py:960-1081 (the gradient, Hpp, the Jacobi "
                     "diagonal, the SCHUR_JACOBI blocks) and :295-330 (inv3x3_spd), XLA code: "
                     "no pallas_call",
         "launches": sum(ASM_PATHS.values()), "launches_by_path": ASM_PATHS,
         **{k: p3e["cube"][k] for k in keys}, "share": p3e["cube"]["bound_ms"] / p3e["cube"]["ms"],
         "plain_graph_ms": p3e["cube"]["plain_graph_ms"],
         "kernel_graph_ms": p3e["cube"]["kernel_graph_ms"], "by_system": p3e},
        # no single PyTorch call computes a CG solve: library_ms is null; the
        # times are of one solve of CG_FORCED steps with its right-hand side
        # and back-substitution
        {"name": "cg_solve", "route": "cuda", "source": SCHUR_SOURCE,
         "replaces": "multiview_tpu/solver/schur.py:1200-1233 (the CG's while_loop: cg_body, "
                     "cg_cond), :1084-1094 (precond_apply), :1147 (schur_mv), XLA code: no "
                     "pallas_call",
         "launches": sum(SOLVE_PATHS.values()), "launches_by_path": SOLVE_PATHS,
         **{k: p3f["cube"]["solve"][k] for k in keys},
         "share": p3f["cube"]["solve"]["bound_ms"] / p3f["cube"]["solve"]["ms"],
         "steps": CG_FORCED, "per_step_path_ms": p3f["cube"]["solve"]["per_step_path_ms"],
         "plain_graph_ms": p3f["cube"]["solve"]["plain_graph_ms"],
         "kernel_graph_ms": p3f["cube"]["solve"]["kernel_graph_ms"],
         "a_step_ms": p3f["cube"]["solve"]["a_step_ms"],
         "step_bound_ms": p3f["cube"]["solve"]["step_bound_ms"],
         "by_system": {k: v["solve"] for k, v in p3f.items()}},
        # no single PyTorch call computes a CG step: library_ms is null; the
        # sharded paths launch it
        {"name": "cg_step", "route": "cuda", "source": CG_SOURCE,
         "replaces": "multiview_tpu/solver/schur.py:1200-1233 (cg_body, cg_cond) and "
                     ":1084-1094 (precond_apply), XLA code: no pallas_call",
         "launches": sum(CG_PATHS.values()), "launches_by_path": CG_PATHS,
         **{k: p3f["cube"]["step"][k] for k in keys},
         "share": p3f["cube"]["step"]["bound_ms"] / p3f["cube"]["step"]["ms"],
         "plain_graph_ms": p3f["cube"]["step"]["plain_graph_ms"],
         "kernel_graph_ms": p3f["cube"]["step"]["kernel_graph_ms"],
         "by_system": {k: v["step"] for k, v in p3f.items()}},
        # no single PyTorch call computes an LM step's trial and accept:
        # library_ms is null; the times are of a trial and an accepted step's
        # accept (nothing copied: the halves' selector flips), max_abs_err the
        # trial's
        {"name": "lm_step", "route": "cuda", "source": LM_SOURCE,
         "replaces": "multiview_tpu/solver/schur.py:1241-1295 (the LM body's trial point, "
                     "model reduction, accept and lam update), XLA code: no pallas_call",
         "launches": sum(LM_PATHS.values()), "launches_by_path": LM_PATHS,
         **{k: p3g["cube"][k] for k in keys},
         "share": p3g["cube"]["bound_ms"] / p3g["cube"]["ms"],
         "accepted_over_rejected_graph": p3g["cube"]["accepted_over_rejected_graph"],
         "plain_graph_ms": p3g["cube"]["plain_graph_ms"],
         "kernel_graph_ms": p3g["cube"]["kernel_graph_ms"],
         "per_iteration": p3g["per_iteration"],
         "trial_launches_by_path": TRIAL_PATHS,
         "by_system": {k: v for k, v in p3g.items() if k != "per_iteration"}}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
