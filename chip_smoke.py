#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Build the CUDA kernels from ``cpu_ray_tracing_implementation_tpu_torch/csrc``
   (one nvcc per source, in parallel). Then write the stand-in glTF assets
   into a temporary directory with the port's ``utils/procgen.py`` (the
   reference's Fox and Sponza are absent): an ellipsoid Fox of 576
   triangles (the real Fox's count: 5 chunks, the packet route) and one
   of 480 (one dense table), each with u32 indices, NORMAL, TEXCOORD_0, a
   node transform and a PNG baseColorTexture, and Sponza.gltf + .bin
   holding the colonnade's 257,916 triangles. ``$CRT_ASSETS`` points at
   one of them only while a glTF scene is built.
2. Hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes:
   - K1 (planar closest hit) in quad and triangle mode and K2 (sphere
     closest hit): 512*512 rays against the 1-chunk views of cornell_box,
     three_material_ball and random_motion_ball (337 spheres in 384
     lanes, where K2 does real work), primary and secondary rays, random
     700-primitive, 6-chunk tables, random 6-chunk planar and sphere
     tables whose active lanes have holes (about half live, lane 0 of each
     chunk dead, lane 127 live), K2 at ragged ray counts (1 to 513), and
     K1 on the colonnade's light view (1 live lane of 128, timed too).
     Equal hit masks and materials; t within rtol 1e-4 / atol 1e-4; every
     other output row (K1: normal, u, v; K2: center, rad) within atol
     1e-3. K2 is timed at three_material_ball's and random_motion_ball's
     primary rays; the kernels line takes random_motion_ball's.
   - K3 (cull + top-V select): the colonnade's 2,015 chunk boxes, 40,000
     primary camera rays and 40,000 secondary rays, packed and exact mode,
     phase 1 and the phase after it, as the unmarked loop asks it and with
     the rays that phase 1 and a real K4 sweep left done marked exhausted
     (as the phase loop asks it); and sphereflake's 58 sphere-chunk boxes
     at its 160,000 primary rays. ids, nears and rest bit-equal. K3's time
     at phase 1 and at both phase-2 forms.
   - K4 (visit-list sweep) on the ids, nears and input best of the
     per-ray phase loop (``profiling.sweep_phases``): triangles (the
     colonnade table, primary rays at every phase the loop runs, each
     timed, the kernels line taking phase 1; secondary rays at phase 1)
     and spheres (a random 6,000-sphere table, 47 chunks, and
     sphereflake's 7,381 spheres in 58 chunks at its primary rays, timed:
     the wavefront's main path). All 8 columns bit for bit equal to the
     plain version's. Each timed case prints its bound, counted from what
     the sequential sweep needs of that run's data (``sweep_needs``), and
     the bound at the count before K4's redesign.
   - The opt-in per-ray routes' kernels at the colonnade's 40,000 primary
     rays: K3 on the sub-tile boxes (CS 32: 8,060 at V 24; CS 16: 16,120
     at V 24; CS 8: 32,240 at V 32), bit-equal; K7 (the sub-tile sweep, one
     instance a row kind for every width) on the lists K3 gives there, at
     each of those widths, timed with its bound and its time by stage
     (memset, count, scatter, tile, fold: ``profiling.sweep_stage_ms``);
     K8 (the quantized-row sweep) on the chunk route's phase-1 lists,
     timed against K4 on the same lists and by stage, with two bounds: the
     cull bound (what its group boxes need: ``q16_cull_needs``; the kernels
     line's ``bound_ms``) and the row bound (every primitive of each
     sequentially visited row; ``row_bound_ms`` there), and on
     the grazing set (rays aimed at every vertex of small and large
     quantized chunks at +-1,200 units, along the axes and grazing). K7 and K8 all 8 columns bit for
     bit equal to their plain versions (``sweep_plain`` at the sub-tile
     width, ``sweep_q16_plain``); K3 timed at CS 32.
   - K1 and K2 with their pid output (the winner's lane, which the
     gradient path replays) against the plain versions' pid, at the same
     Cornell, three_material_ball and random_motion_ball shapes: equal
     wherever hit masks and materials are equal and the ray is no near-tie
     (counted and printed); K1's time with and without pid; K1's and K2's
     pid on the holed tables too.
   - The traffic of next-event estimation, volumes and the noise scenes:
     K1 and K2 on the shadow rays of cornell_box_with_sphere_light at
     600x600 (from every lane's first hit toward a sampled light point,
     inactive lanes included, as the render traces them), K1 on
     cornell_box_with_volume's primary rays, and at perlin_texture_ball's
     600x600 (2,401 quads in 19 chunks) K3 and K4 at every phase of its
     primary rays and of shadow-like rays toward its light quad with half
     the lanes dead, and K2 on its two spheres; the same tolerances.
   - The traffic of spectral dispersion and the importance-sampled sky:
     K1 and K2 on dispersion_prism's 400x400 primary rays and on the two
     generations its hits scatter at random hero wavelengths (the rays
     refracted into the glass sphere leave its surface inward, and K2
     finds their exit), and K2 on sunlit_spheres' primary rays and on the
     NEE shadow rays from its first hits toward importance-sampled sky
     directions; the same tolerances.
   - The glTF scenes' traffic: K1 with its pid output on the 480-triangle
     stand-in's dense view at textured_fox's 600x600 primary rays and
     first secondary rays (hit masks equal except on rays within 1e-4 of a
     triangle edge, counted; materials equal; pids equal except counted
     near-ties; t within rtol 1e-4; the raw and the interpolated normal and
     (u, v) within atol 1e-3), with K1's time there; K3 (bit-equal) and K4
     (all 8 columns bit for bit, the pid column that indexes the attribute
     table included) at every phase of the 576-triangle stand-in's primary
     and secondary rays.
   - K6 (the tile-packet closest hit, planar and sphere entries) against
     its plain version (the per-tile loop of ``ops/packet.py``) on every
     PACKET_PLAIN_STRIDE-th tile of each case (all the rays of those
     tiles; every tile of the 16 px colonnade's) at ``packet.AUTO_TILE``:
     sphereflake's 160,000 primary rays on its 58 chunks and the same rays
     after one bounce, coherence-sorted; its table doubled, each chunk
     followed by a copy with the same entry t (the tie rule, on every 4th primary ray: each keeps the first
     copy's sphere); perlin_texture_ball's 600x600 primary rays on its 19
     quad chunks; the 16 px colonnade's 71 triangle chunks and the
     576-triangle Fox stand-in's 5, primary and secondary rays. Timed
     (kernel, bound, visits per tile, registers and resident blocks): the
     sphereflake and perlin cases at AUTO_TILE and at tiles of 128, 256
     and 512 (sphereflake's primary rays at JAX's 2,048 too), the Fox
     stand-in's at AUTO_TILE. Spheres:
     masks, pids, materials and each tile's visit count equal, t within
     rtol 1e-4; planar: masks equal but at an edge, pids equal but for
     near-ties (both counted), materials, t and payload at K1's
     tolerances where the pids agree, visit counts equal in all but 1% of
     the tiles. Each timed case prints its bound, counted from K6's own
     visit counts at that tile and each tile's crossed chunks in the plain
     version's visit order (``lanes_tested``: a slab test per tile lane and
     chunk, a ray test per tile lane and live primitive of each visited
     chunk), and the plain version's time on the tiles it checks.
   - K5 (gather-sum probe) against its plain version (rel err max |a - b| /
     (|b| + 1) <= 1e-5, and the count of outputs whose bits differ) at the
     probe's defaults (an 11.5 MB table, inside the L2) and with a 738 MB
     table (K 131,072: device memory), with its time, its bound (the named
     rows, ids and output moved once) and share of it, and the
     embedding_bag call's time and gathered GB/s (a row per ray and slot).
   - K9 (one bounce's scatter) against its plain version on every bounce
     of one sample: the Cornell box at the scan cell's 600x600, depth 4,
     under both ``CRT_COSINE`` samplers, and all_materials_fixture, the
     volume box, the sphere-light box and dispersion_prism at 256x256
     (``kernel_ab.scatter_check``: continues equal, new_dir and weight
     within atol 1e-5 / rtol 1e-4 but on at most 1 lane in 10,000, each at
     a light's edge, printed with the lanes equal bit for bit); timed on
     the Cornell box's second bounce, with its bound (bytes).
   Kernel and plain times from CUDA events.
3. Checks, their launches not counted: cornell_box, three_material_ball,
   random_motion_ball, sponza (the colonnade) and the scenes that need
   picture textures, the other cameras or chunked spheres (sphereflake,
   white_sphere, different_fuzz_metal, the rotated- and specular-box
   Cornell variants, the lens camera's
   three_material_ball_with_defocus_blur, the fisheye's
   skybox_and_fisheye), the noise scenes (perlin_texture_ball and the four
   test_*_noise), cornell_box_with_sphere_light and
   cornell_box_with_volume, dispersion_prism and sunlit_spheres at the
   golden workload (16 px, 4 spp, depth 3, key 42; image mean within 2e-3
   of tests/test_golden.py); the Cornell box at the golden workload under
   ``camera.qmc`` and under ``CRT_RNG=threefry``, and the 16 px colonnade
   under ``camera.qmc`` (through K6), within 2e-3 of the port's own
   CPU render of the same key; the seven
   scenes whose asset is missing (F1: earthmap.jpg, and the fallbacks of
   smoke_fox, glass_fox and textured_fox without Fox.gltf) within 2e-3 of
   the port's own CPU render of the same scene and key; with the stand-in
   assets, glass_fox, textured_fox (both stand-ins) and smoke_fox at the
   golden workload, and sponza from Sponza.gltf (built once on the card at
   200 px, its chunk tables against the procedural colonnade's, max abs
   difference printed, and rendered with the 16 px golden camera), each
   within 2e-3 of the port's own CPU render of the same scene and key;
   ``render_image_adaptive`` at rel_tol=0 bitwise the uniform render on
   the Cornell box at 64x64, 16 spp; the Cornell
   C++ reference parity gate of tests/test_parity.py (300 px 16 spp: PSNR
   > 30 dB, mean rel err < 0.04); and the per-ray closest hit (K3 + K4)
   against the chunk-scan oracle on the full colonnade: the same winner's
   t within rtol 1e-4 or, for grazing hits at the colonnade's +-1,200
   coordinates, hit points within 1e-3 along the plane's normal; a ray
   whose winners or hit masks differ must have a hit the two triangle
   tests round apart (a near-tie, a triangle edge, or the surface the ray
   leaves; counted and printed).
4. Main paths, full workloads: cornell_box at 512x512, 256 spp, depth 8;
   three_material_ball at its parity size (320 px, 16 spp, depth 5),
   which must pass its parity gate (> 38 dB, mean rel err < 0.02); the
   colonnade at 200x200, 30 spp, depth 5; and random_motion_ball at
   1280x720, 20 spp, depth 50 (its own size). Each image must be finite;
   prints seconds, camera rays/s, the mean and, for the colonnade, the
   selection phases per bounce and the share of rays still live in each
   phase. Then the gradient path (``diff.loss_and_grads``): cornell_box at
   512x512, 256 spp, depth 8 (bench.py's workload), geometry=False then
   True, and the colonnade at 200x200, depth 5, 8 spp; each prints
   seconds, fwd+bwd camera rays/s, peak device memory, each pass's seconds
   and, for Cornell, (fwd+bwd - fwd) / fwd against the forward render
   above. Loss and gradients must be finite. Before the gradient path,
   the path-regeneration wavefront: the colonnade at 200x200, 30 spp,
   depth 5 and sphereflake at 400x400, 50 spp, depth 5 (its own size), at
   the automatic lane pool; each prints seconds, camera rays/s, loop
   iterations and host synchronisations per iteration. The colonnade's
   image is held against the scan's of the same key above, sphereflake's
   at 4 spp against a 4-spp scan (rtol 1e-5, atol 1e-5: each path's
   radiance is the scan's, only the order of the sums differs). Then the
   per-ray route's pool and batch sizes on the card, at POOL_SPP: the
   colonnade's wavefront at the automatic pool and at 8,192 lanes (the automatic pool
   is the whole frame), and its scan in batches of 8,192 pixels and
   whole; each warmed up, then timed twice in alternation; the batched and
   whole scan images must be bitwise equal (sphereflake, packet routed,
   is cut from this comparison). Last, after every timed run
   (the profiler may leave per-launch costs behind on these host-bound
   paths), K3's and K4's summed device time in one more colonnade render
   under torch.profiler, K6's in a 4-spp sphereflake scan render, and K2's
   in a random_motion_ball render at 2 spp (its share of device time per
   bounce), each with its wrapper calls there and the device kernels one
   call runs (K4: four, and a memset). The new estimator paths at their
   scenes' own sizes: dispersion_prism at 400x400, 200 spp, depth 6, and
   its wavefront at 4 spp against a 4-spp scan (WAVEFRONT_TOL);
   sunlit_spheres at 400 px (aspect 1.78), 50 spp, depth 5, plain and with
   NEE (means within NEE_MEAN_RTOL); the Cornell box at 512x512, 256 spp,
   depth 8 under ``camera.qmc`` and under ``CRT_RNG=threefry``
   (THREEFRY_SPP samples); ``loss_and_grads`` of dispersion_prism cut to
   PRISM_GRAD (``mat_dispersion`` finite and nonzero, the kernel route
   equal to plain autograd under deterministic algorithms) and of the
   Cornell box under ``camera.qmc`` at QMC_GRAD. Each prints seconds,
   camera rays/s and the mean. The glTF scenes at their own sizes:
   textured_fox 600x600, 100 spp, depth 5 with the 576-triangle stand-in
   (K6 with pid) and with the 480-triangle one (K1 with pid);
   glass_fox 600x600, 200 spp, depth 5 (576); sponza from Sponza.gltf at
   200x200, 30 spp, depth 5, its load-and-build seconds, its image against
   the procedural colonnade's (max abs difference, means within 2e-3);
   ``render_image_adaptive`` on the Cornell box at 512x512, depth 8
   (ADAPTIVE), its samples against 256 x 512^2 and its mean against the
   uniform 256-spp render's (within ADAPTIVE_MEAN_RTOL); ``render_aovs``
   (AOV_SPP) and ``denoise`` of the 256-spp Cornell image, each timed;
   ``loss_and_grads`` of textured_fox at FOX_GRAD (576), finite, the kernel
   route equal to plain autograd (every closest hit's plain version on the
   card) under deterministic algorithms.
5. Kernel launch counts of each phase-4 run, set to 0 just before it and
   read just after: the Cornell render must launch K1 and K9 (K9 spp x
   depth times, as in a render at the scan cell's 600x600, 40 spp, depth
   4: 160), the
   three_material_ball render K2, the colonnade render K1 (its light
   quad), K3 and K4, and the random_motion_ball render K2 exactly spp x
   depth = 1,000 times; the colonnade wavefront K1, K3 and K4, the
   sphereflake wavefront K6 (their launches go on a line of their own). Cornell's gradient runs launch K1 and K9 spp x depth times in the
   forward pass (2,048 at 256 spp) and none in the backward pass (the winners are
   replayed from the tape; the backward's scatter is the differentiable eager one); the colonnade's gradient run launches K1, K3
   and K4 in both passes (no tape on chunked tables: the accelerator runs
   again). ``loss_and_grads`` with next-event estimation through
   cornell_box_with_volume, cut to 256x256, 4 spp, depth 5: K1 launched
   spp x (2 depth - 1) = 36 times in the forward pass and none in the
   backward (the tape replays the shadow rays' and the volumes' winners
   too), and its gradients equal plain autograd's (the closest hits'
   plain versions on the card) under PyTorch's deterministic algorithms at
   LOSS_RTOL, SCENE_TOL and CAMERA_TOL. K5 is on no path: its launches are those of one probe call. The
   ``kernels`` line gives each kernel's launches in the render of its own
   slice's scene (K2's: random_motion_ball's; three_material_ball's 80 and
   K2's time there go on the line before it; the sphere-light renders' K1
   and K2 launches, plain and with NEE, on a line of their own before it).
   The spectral, QMC and threefry runs: the prism scan launches K1 and K2
   each spp x depth = 1,200 times; sunlit_spheres K2 250 times plain and
   450 with NEE (spp x (2 depth - 1)) and K1 never; the QMC and threefry
   Cornell renders K1 spp x depth times (2,048 at 256 spp); the gradient
   runs K1 (and on the prism K2) spp x depth times in the forward pass and
   none in the backward. Their counts go on a line of their own before the
   ``kernels`` line. The glTF runs: the 576-triangle textured_fox and
   glass_fox renders launch K6 and no K1, K3 or K4, the 480-triangle one K1
   and no K3, K4 or K6, the glTF sponza K1 (its light), K3 and K4; the
   adaptive render K1 depth x the largest per-pixel spp times, the AOV
   pass K1 once per sample; textured_fox's gradient run K6 in both
   passes (on a line of their own before the ``kernels`` line).
   The opt-in per-ray routes: the colonnade at 200x200, 30 spp, depth 5,
   scan and wavefront, under ``CRT_SUBTILE=1`` (K3 on the sub-tile boxes +
   K7) and under ``CRT_SWEEP_Q16=1`` (K3 + K8), each render's launches
   counted alone (K1, K3 and the route's sweep launched, K4 not), its
   selection phases per call, its image against the default route's of
   the same key (means within MODE_MEAN_ATOL; under CRT_SUBTILE, which is
   exact, at least MODE_PIXEL_SHARE of the pixels within 1e-3 too; PSNR
   and the share printed), and its walls against the default route's in
   turns (default, switched, switched, default); under CRT_SWEEP_Q16 a
   MODE_TWIN_SPP scan through K8 bitwise equal to one through K8's plain
   version (the quantized surfaces change secondary paths, MODE_MEAN_ATOL's
   comment);
   the colonnade's primary and secondary rays under CRT_SUBTILE against
   the chunk route (equal hit masks and t; pids equal but at shared edges,
   counted); sphereflake's primary rays under ``CRT_ACCEL=ray CRT_SUBTILE=1``
   against the chunk route's (equal hit masks and pids) and the chunk-scan
   oracle (differing only where the chunk route differs, counted); ``loss_and_grads`` of the colonnade at
   COLONNADE_GRAD_SPP under deterministic algorithms; at MODE_TWIN_SPP
   under each switch against the same route on K7's or K8's plain version
   (LOSS_RTOL, SCENE_TOL, CAMERA_TOL); under CRT_SUBTILE against the
   default route's, on all but MODE_GRAD_OUTLIERS of each family's elements (ties at
   shared edges; counted); under CRT_SWEEP_Q16 its difference from the
   default route's printed.
6. The packet route (``CRT_ACCEL`` unset: tables under 256 chunks take
   K6, as in the JAX package): sphereflake 400x400x50 depth 5 through the
   wavefront and the scan, perlin_texture_ball 600x600 at 32 spp depth 5,
   textured_fox (600x600x100) and glass_fox (600x600x200) on the
   576-triangle stand-in, each rendered on the packet route and under
   CRT_ACCEL=ray, then timed again in turns (ray, packet); the packet
   render launches K6 and neither K3 nor K4, the per-ray render K3 and K4
   and no K6, and the two images' means agree within 2e-3 (the share of
   pixels within 1e-3 printed). The BVH oracle (``CRT_ACCEL=bvh``) on
   sphereflake cut to 64x64, 1 spp, depth 2: its hits on primary and
   secondary rays against the chunk route's (equal masks and pids), its
   image's mean against the chunk route's. ``render_with_checkpoint`` on
   the Cornell box 512x512 depth 8 at CKPT_CORNELL_SPP in chunks of 16 and on the
   sphereflake wavefront in chunks of 16, stopped after two chunks and
   resumed: the scan bitwise the uninterrupted render, the wavefront
   within rtol 1e-5 (its flush is an atomic float ``index_add_`` on the
   card). The ``kernels`` line takes K6's planar launches from the
   perlin render, its sphere launches from the sphereflake wavefront.
7. Multi-device renders and gradients (``parallel/mesh.py`` over
   ``torch.distributed``) on the one card, each run's launches of K1, K2,
   K3, K4 and K6 counted on its own (the ``kernels`` line's
   ``sharded_launches``), its wall printed beside the single-device one:
   (a) a 1-rank NCCL group in this process: the pixel-sharded,
   spp-sharded and 2-D renders of the Cornell box at SHARD_CORNELL,
   bitwise ``render_image``; the sharded wavefronts of the colonnade and
   sphereflake against phase 4's single-device wavefront images (within
   CKPT_WF_TOL: the flush is atomic); ``render_loss_and_grad_sharded`` of
   Cornell at SHARD_GRAD against ``loss_and_grads`` under deterministic
   algorithms (SHARD_LOSS_RTOL, SHARD_SCENE_TOL, SHARD_CAMERA_TOL).
   (b) GLOO_RANKS spawned ranks sharing the card over gloo (NCCL refuses
   two ranks on one device): which collectives gloo takes on card tensors
   (the mesh hands them card tensors), then the pixel- and spp-sharded
   Cornell, the colonnade's and sphereflake's sharded wavefronts, the
   sharded adaptive Cornell (SHARD_ADAPTIVE), a sharded checkpoint in
   chunks of SHARD_CKPT_CHUNK stopped after two chunks and resumed, and
   the sharded training step of all_materials_fixture at SHARD_MATERIALS
   (K1 and K2); every rank's results held here against the single-device
   ones (pixel sharding, adaptive and the resumed checkpoint bitwise, spp
   sharding within atol 1e-5, the wavefronts within CKPT_WF_TOL, the
   training step at the sharded tolerances under deterministic algorithms
   with every family of LIVE nonzero), every kernel its path runs
   launched in every rank. (c) the CLI,
   ``python -m cpu_ray_tracing_implementation_tpu_torch.cli cornell_box
   --width 128 --spp 8 -o <tmp>/x.png``, must exit 0. No result crosses
   cards: the machine has one.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line (each
kernel's ``plain_ms_on`` says what its plain time covers: K6's per-tile
loop is timed on every PACKET_PLAIN_STRIDE-th tile, ``ms`` on all), and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero without
printing a result when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from cpu_ray_tracing_implementation_tpu_torch.kernels import build
from cpu_ray_tracing_implementation_tpu_torch.models import (adaptive, aov, catalog, diff, film,
                                                             integrator)
from cpu_ray_tracing_implementation_tpu_torch.models.scene import SceneBuilder
from cpu_ray_tracing_implementation_tpu_torch.ops import chunked as ch
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_intersect as fi
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_scatter as fsc
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_select as fs
from cpu_ray_tracing_implementation_tpu_torch.ops import fused_sweep as fsw
from cpu_ray_tracing_implementation_tpu_torch.ops import intersect as isect
from cpu_ray_tracing_implementation_tpu_torch.ops import bvh, keys, packet, perray, raysort
from cpu_ray_tracing_implementation_tpu_torch.ops import materials as mat_ops
from cpu_ray_tracing_implementation_tpu_torch.ops import spectrum
from cpu_ray_tracing_implementation_tpu_torch.ops import vecmath as vm
from cpu_ray_tracing_implementation_tpu_torch.parallel import collectives
from cpu_ray_tracing_implementation_tpu_torch.parallel import mesh as pm
from cpu_ray_tracing_implementation_tpu_torch.utils import (checkpoint, denoise, gather_probe,
                                                            kernel_ab, procgen, profiling)
from cpu_ray_tracing_implementation_tpu_torch.utils.profiling import (
    FP32_INSTR_PER_S, HBM_BYTES_PER_S, camera_rays, cuda_ms, secondary)

TMIN = 1e-3
INF = float("inf")
R_MAIN = 512 * 512
COLONNADE_PX = 200
R_COLONNADE = COLONNADE_PX * COLONNADE_PX
GOLDEN_MEANS = {"cornell_box": 0.160999, "three_material_ball": 0.563181,
                "random_motion_ball": 0.426140, "sponza": 0.402695,
                "cornell_box_with_rotated_box": 0.535078,
                "cornell_box_with_specular_box": 0.488185,
                "different_fuzz_metal": 0.322772, "skybox_and_fisheye": 0.633859,
                "sphereflake": 0.592463,
                "three_material_ball_with_defocus_blur": 0.605853,
                "white_sphere": 1.000000,
                # noise textures, sphere lights and volumes
                "perlin_texture_ball": 0.418168, "test_perlin_noise": 0.507109,
                "test_value_noise": 0.496078, "test_worley_noise": 0.322421,
                "test_voronoi_noise": 0.462877,
                "cornell_box_with_sphere_light": 0.427467,
                "cornell_box_with_volume": 0.487237,
                # spectral dispersion and the importance-sampled sky
                "dispersion_prism": 0.782510, "sunlit_spheres": 0.090164}
# scenes whose asset is missing here (ROADMAP F1: earthmap.jpg, and
# smoke_fox's Fox.gltf, for which it bounds its medium by a fallback mesh):
# held to the port's own CPU render of the same scene and key, which takes
# the same fallback
F1_SCENES = ("cornell_box_with_glossy_ball", "infinite_reflection",
             "skybox_and_motion_blur", "simple_light_earth", "smoke_fox",
             "glass_fox", "textured_fox")
# the wavefront against the scan on the same scene and key: each path's
# radiance is the scan's, only the order of the per-pixel sums differs
WAVEFRONT_TOL = dict(rtol=1e-5, atol=1e-5)
# samples of the sphereflake scan and wavefront renders held against each
# other (its timed wavefront render takes the scene's 50)
SPHEREFLAKE_CHECK_SPP = 4
# the scan's pixel batch timed against the whole frame
SCAN_TILE = 8192
# Depth cuts that keep the script inside half its time limit with phase 7
# (it took 602.7 s with only this one on an NVIDIA H100 80GB HBM3 at 700 W,
# PERF.md section 6). Each run cut feeds no printed ratio. The colonnade's
# pool and batch sizes are timed at this spp, cut from its 30 (~30 s)
POOL_SPP = 8
PARITY = {"cornell_box": (300, 16, 4, 30.0, 0.04),
          "three_material_ball": (320, 16, 4, 38.0, 0.02)}
PKG = "cpu_ray_tracing_implementation_tpu_torch/csrc/"
JAX = "cpu_ray_tracing_implementation_tpu/"
# name -> (id, source, the TPU kernel it replaces)
KERNELS = {
    "planar_closest": ("K1", PKG + "closest_hit.cu", JAX + "ops/pallas_intersect.py:81"),
    "sphere_closest": ("K2", PKG + "closest_hit.cu", JAX + "ops/pallas_intersect.py:267"),
    "cull_select": ("K3", PKG + "cull_select.cu", JAX + "ops/pallas_select.py:48"),
    "visit_sweep": ("K4", PKG + "visit_sweep.cu", JAX + "ops/pallas_sweep.py:175"),
    "gather_sum": ("K5", PKG + "gather_sum.cu", "tools/dma_gather_probe.py:40"),
    # K6 has no Pallas counterpart: it replaces the XLA packet route's
    # per-tile loops (lax.map over _planar_tile / _sphere_tile)
    "packet_planar": ("K6", PKG + "packet_closest.cu", JAX + "ops/packet.py:110"),
    "packet_sphere": ("K6", PKG + "packet_closest.cu", JAX + "ops/packet.py:158"),
    # K7 and K8 replace the XLA sweeps of the JAX package's opt-in per-ray
    # routes (no Pallas counterpart): the sub-tile sweep and the q16 sweep
    "visit_sweep_sub": ("K7", PKG + "visit_sweep.cu", JAX + "ops/perray.py:567"),
    "visit_sweep_q16": ("K8", PKG + "visit_sweep.cu", JAX + "ops/perray.py:840"),
    # K9 replaces no Pallas kernel: the JAX package leaves the scatter's
    # elementwise graph to XLA's fusion
    "scatter": ("K9", PKG + "scatter.cu", JAX + "ops/materials.py:328"),
}
# K9's launches: the scan cell's render (600x600, 40 spp, depth 4), once a
# bounce
SCAN_CELL = dict(width=600, spp=40, max_depth=4)
# gradient tolerances: the JAX package's replay-against-remat test
# (tests/test_replay.py:106-112)
LOSS_RTOL = 1e-4
SCENE_TOL = dict(rtol=2e-3, atol=1e-5)
CAMERA_TOL = dict(rtol=5e-3, atol=1e-4)
# the families __graft_entry__.py asserts live on all_materials_fixture
LIVE = ("tex_color0", "tex_color1", "mat_fuzz", "mat_ior", "mat_smoothness",
        "mat_spec_prob", "pos", "lookat", "fovy_deg", "focal_length", "geo_sph_c1")
COLONNADE_GRAD_SPP = 8
# samples of the profiled random_motion_ball render (the timed one takes
# the scene's 20): K2's share of device time per bounce, at a tenth of the
# trace
MOTION_BALL_PROFILED_SPP = 2
# next-event estimation and Russian roulette as the full NEE render takes
# them (roulette from bounce 3 of 4)
NEE = dict(nee=True, rr_depth=3)
# the NEE render's image mean against the plain render's: the two
# estimators are unbiased, so they agree within Monte-Carlo distance (the
# JAX package's tests/test_nee.py holds its specular scene to 2%)
NEE_MEAN_RTOL = 0.02
# samples of the wavefront-against-scan checks on the new paths
ESTIMATOR_CHECK_SPP = 4
# perlin_texture_ball's full render: 600x600 at depth 5, its 500 spp cut to
# 32 for the time limit (the marble's 7 octaves run on every lane of every
# bounce)
PERLIN_SPP = 32
# the NEE + volume gradient run, cut from 600x600x100 depth 5 to this
# size (the plain-autograd reference runs the chunk scan on the card)
VOLUME_GRAD = dict(width=256, spp=4, max_depth=5)
# the gradient runs of the spectral and QMC paths: dispersion_prism cut from
# 400x400, 200 spp to this size, and the Cornell box under camera.qmc
PRISM_GRAD = dict(width=128, spp=8, max_depth=6)
QMC_GRAD = dict(width=256, spp=4, max_depth=8)
# the Cornell render under CRT_RNG=threefry, cut from Cornell's 256 spp
# (~15 s; see POOL_SPP): its mean is held against camera.qmc's
THREEFRY_SPP = 64
# FP32 instructions (a fused multiply-add counts once, a divide, square
# root, min, max or compare once) per (ray, primitive) or (ray, box) pair,
# counted from each kernel's source: K1 the plane and edge tests of a live
# quad (contracted into FMAs); K2 the expanded quadratic of a live sphere
# and its discriminant's compare (12 for d.c, 12 for o.c, 4 for c.c, 2 for
# b, 4 for c, 3 for the discriminant, 1 compare), and, only for the pairs
# whose discriminant is positive, counted from the run's rays
# (``sphere_roots``), the root: a square root, two sums, two divides and up
# to four compares ("sphere_root"); K3 one slab test and key; K4, per
# (ray, primitive) of a slot the sequential sweep visits, the test's
# ray-dependent start (planar: the plane's t and its range; sphere: up to
# the discriminant's sign), the edge tests of a plane whose t is in [tmin,
# running best] ("_edges"), the sphere root where the discriminant is
# positive, and each primitive's constants once per distinct row visited
# ("_row"), all counted from csrc/visit_sweep.cu; K2, K3 and K4 round each
# product and sum on its own
OPS = {"planar_closest": 36, "sphere_closest": 38, "sphere_root": 9,
       "cull_select": 30, "visit_sweep_planar": 16, "visit_sweep_planar_edges": 30,
       "visit_sweep_sphere": 26, "visit_sweep_planar_row": 57,
       "visit_sweep_sphere_row": 4,
       # K8's row: K4's 57 and the dequantization (corner: a product and a
       # sum per axis; edges: a difference and a product per axis and edge)
       "visit_sweep_q16_row": 57 + 18,
       # K8's row stage (csrc/visit_sweep.cu q16_group_box), per primitive of
       # a row beyond its constants: three compares of the normal with 0,
       # |eu|^2 and |ev|^2 (5 each), S^2 (a product and a divide), its
       # compare and max, four square roots, L, and per axis r_i + s_i
       # (two divides, a sum), S times it, nu_i (a divide), S times it and
       # the pad's two terms (3 and 4): 61; a group leader's corners, B, A
       # and C (33 a group of 32, rounded up to 1 a primitive). Its tile
       # stage per (visit, live group): the limit, three pads (a product and
       # a sum), six face t (a difference, a sum or difference and a
       # product), the entry's and exit's five min / max each, two compares
       # (37); per visit the origin's magnitude and three reciprocals with
       # their compares (8)
       "visit_sweep_q16_box": 61 + 1, "visit_sweep_q16_group": 37,
       "visit_sweep_q16_visit": 8}
# K4's count before its redesign: the whole test, constants included, per
# pair; its bound is printed beside the new one
OPS_PER_PAIR_BEFORE = {"planar": 130, "sphere": 50}


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def rng_stream(name):
    """Renders inside draw from the ``CRT_RNG`` stream ``name``."""
    saved = os.environ.get("CRT_RNG")
    os.environ["CRT_RNG"] = name
    try:
        yield
    finally:
        if saved is None:
            del os.environ["CRT_RNG"]
        else:
            os.environ["CRT_RNG"] = saved


T_START = time.perf_counter()


def phase_log(msg):
    """A phase's heading, with the seconds since the script started."""
    log(f"{msg} (at {time.perf_counter() - T_START:.1f} s)")


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ------------------------------------------------------------ phase 2
def random_planar(gen, dev, K=6, C=128, n=700, holes=False):
    """K chunks of C random quads (or triangles): the first n active or,
    with ``holes``, a random half of each chunk with its first lane dead
    and its last lane live (an active set that is no prefix)."""
    corner = torch.rand(K * C, 3, generator=gen) * 20 - 10
    eu = torch.randn(K * C, 3, generator=gen)
    ev = torch.randn(K * C, 3, generator=gen)
    act = torch.arange(K * C) < n
    if holes:
        act = (torch.rand(K, C, generator=gen) < 0.5)
        act[:, 0], act[:, -1] = False, True
        act = act.reshape(-1)
    mat = (torch.arange(K * C) % 3).to(torch.int32)
    pts = torch.stack([corner, corner + eu, corner + ev, corner + eu + ev])
    inf = torch.tensor(float("inf"))
    lo = torch.where(act[:, None], pts.amin(0), inf).reshape(K, C, 3).amin(1)
    hi = torch.where(act[:, None], pts.amax(0), -inf).reshape(K, C, 3).amax(1)
    return ch.PlanarChunks(*[x.to(dev) for x in (
        corner.reshape(K, C, 3), eu.reshape(K, C, 3), ev.reshape(K, C, 3),
        mat.reshape(K, C), act.reshape(K, C), lo, hi)])


def random_spheres(gen, dev, K=6, C=128, n=700, holes=False):
    """K chunks of C random moving spheres, active as in ``random_planar``."""
    c0 = torch.rand(K * C, 3, generator=gen) * 20 - 10
    c1 = c0 + 0.3 * torch.randn(K * C, 3, generator=gen)
    rad = torch.rand(K * C, generator=gen) * 0.8 + 0.05
    act = torch.arange(K * C) < n
    if holes:
        act = (torch.rand(K, C, generator=gen) < 0.5)
        act[:, 0], act[:, -1] = False, True
        act = act.reshape(-1)
    mat = (torch.arange(K * C) % 3).to(torch.int32)
    inf = torch.tensor(float("inf"))
    lo = torch.where(act[:, None], torch.minimum(c0, c1) - rad[:, None], inf)
    hi = torch.where(act[:, None], torch.maximum(c0, c1) + rad[:, None], -inf)
    return ch.SphereChunks(*[x.to(dev) for x in (
        c0.reshape(K, C, 3), c1.reshape(K, C, 3), rad.reshape(K, C),
        mat.reshape(K, C), act.reshape(K, C), lo.reshape(K, C, 3).amin(1),
        hi.reshape(K, C, 3).amax(1))])


# payload fields before mat: the kernel wrappers' (t, (*fields, mat)); the
# plain versions add a primitive id after mat, which is not compared
PLANAR_FIELDS = ("normal", "u", "v")
SPHERE_FIELDS = ("center", "rad")


def max_abs(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def compare(label, got, ref, fields):
    """Hold a kernel's (t, payload) against its plain version's: equal hit
    masks and materials, t within rtol 1e-4 / atol 1e-4, every other
    payload field within atol 1e-3. Returns the largest abs error."""
    t, payload = got
    t_r, payload_r = ref
    valid = torch.isfinite(t_r)
    if not torch.equal(torch.isfinite(t), valid):
        raise AssertionError(f"{label}: hit masks differ in "
                             f"{int((torch.isfinite(t) != valid).sum())} rays")
    m, m_r = payload[len(fields)][valid], payload_r[len(fields)][valid]
    if not torch.equal(m, m_r):
        raise AssertionError(f"{label}: materials differ in {int((m != m_r).sum())} rays")
    torch.testing.assert_close(t[valid], t_r[valid], rtol=1e-4, atol=1e-4)
    err = {"t": max_abs(t[valid], t_r[valid])}
    for i, name in enumerate(fields):
        x, x_r = payload[i][valid], payload_r[i][valid]
        torch.testing.assert_close(x, x_r, rtol=0, atol=1e-3,
                                   msg=lambda m, n=name: f"{label}: {n}: {m}")
        err[name] = max_abs(x, x_r)
    log(f"  {label}: rays {t.shape[0]} hits {int(valid.sum())} max abs err {err}")
    return max(err.values())


def bound(nbytes: float, ops: float):
    """(bound ms, "bytes" or "operations"): the least time the card could
    take to move ``nbytes`` once and issue ``ops`` FP32 instructions."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_INSTR_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# rows of the [8,R] ray pack each closest-hit kernel reads: K1 org and dir,
# K2 the ray time too
RAY_ROWS = {"planar_closest": 6, "sphere_closest": 7}


def closest_bound(name, R, pack, live, roots=0):
    """K1's or K2's bound: the ray rows it reads, [8,R] hit rows written,
    the pack read once; ``live`` primitives tested per ray and, for K2,
    the root taken for ``roots`` (ray, sphere) pairs."""
    nbytes = 4 * (RAY_ROWS[name] * R + pack.numel() + 8 * R)
    return bound(nbytes, R * live * OPS[name] + roots * OPS["sphere_root"])


def sphere_roots(org, dirs, time, view, step=65_536) -> int:
    """(ray, live sphere) pairs whose discriminant is positive: those for
    which K2 takes the root. The plain version's test of one chunk, with
    [tmin, tmax] unbounded, is finite exactly there."""
    n = 0
    for s in range(0, org.shape[0], step):
        o, d, tm = org[s:s + step], dirs[s:s + step], time[s:s + step]
        tmax = torch.full((o.shape[0],), INF, device=o.device)
        for k in range(view.rad.shape[0]):
            ts = ch._sphere_chunk_ts(o, d, tm, view.c0[k], view.c1[k], view.rad[k],
                                     view.active[k], -INF, tmax)
            n += int(torch.isfinite(ts).sum())
    return n


def phase_kernels(dev):
    """K1 and K2 against their plain versions; returns (errs, times,
    bounds) keyed by kernel name."""
    gen = torch.Generator().manual_seed(0)
    errs = {"planar_closest": 0.0, "sphere_closest": 0.0}
    times, bounds = {}, {}

    def planar_case(label, org, dirs, view, pack, tri, timed=False):
        got = fi.planar_closest_fused(org, dirs, view, TMIN, tri, pack=pack)
        ref = ch.planar_closest(org, dirs, view, TMIN, tri)
        errs["planar_closest"] = max(errs["planar_closest"],
                                     compare(label, got, ref, PLANAR_FIELDS))
        if timed:
            rays = fi.pack_rays(org, dirs)
            times["planar_closest"] = (
                cuda_ms(lambda: fi.planar_closest_kernel(rays, pack, TMIN, triangle=tri)),
                cuda_ms(lambda: ch.planar_closest(org, dirs, view, TMIN, tri)),
                cuda_ms(lambda: fi.planar_closest_fused(org, dirs, view, TMIN, tri,
                                                        pack=pack)))
            bounds["planar_closest"] = closest_bound(
                "planar_closest", org.shape[0], pack, int(view.active.sum()))
        return ref

    def sphere_case(label, org, dirs, time, view, pack, timed=None):
        """``timed``: the key its times and bound go under."""
        got = fi.sphere_closest_fused(org, dirs, time, view, TMIN, pack=pack)
        ref = ch.sphere_closest(org, dirs, time, view, TMIN)
        errs["sphere_closest"] = max(errs["sphere_closest"],
                                     compare(label, got, ref, SPHERE_FIELDS))
        if timed:
            rays = fi.pack_rays(org, dirs, time)
            times[timed] = (
                cuda_ms(lambda: fi.sphere_closest_kernel(rays, pack, TMIN)),
                cuda_ms(lambda: ch.sphere_closest(org, dirs, time, view, TMIN)),
                cuda_ms(lambda: fi.sphere_closest_fused(org, dirs, time, view, TMIN,
                                                        pack=pack)))
            live = int(view.active.sum())
            roots = sphere_roots(org, dirs, time, view)
            bounds[timed] = closest_bound("sphere_closest", org.shape[0], pack, live,
                                          roots)
            log(f"  {label}, timed ({live} live lanes of "
                f"{view.active.numel()}, {org.shape[0]} rays, {roots} of the "
                f"{org.shape[0] * live} (ray, sphere) pairs take the root): kernel "
                f"{times[timed][0]:.4f} ms, plain {times[timed][1]:.4f} ms, bound "
                f"{bounds[timed][0]:.4f} ms ({bounds[timed][1]}), bound / kernel "
                f"{bounds[timed][0] / times[timed][0]:.3f}")
        return ref

    scene, org, dirs, _ = camera_rays("cornell_box", gen, dev)
    view, pack = scene.quad_view
    ref = planar_case("K1 quad, cornell view, primary", org, dirs, view, pack,
                      False, timed=True)
    o2, d2 = secondary(org, dirs, ref[0], gen)
    planar_case("K1 quad, cornell view, secondary", o2, d2, view, pack, False)
    planar_case("K1 tri, cornell view as triangles, primary", org, dirs, view,
                pack, True)
    planar_case("K1 tri, cornell view as triangles, secondary", o2, d2, view,
                pack, True)

    # K2's slice-1 shape (4 live lanes of 128) and random_motion_ball's, where
    # it does real work (337 of 384: three slices, the last 81 live); the
    # kernels line takes random_motion_ball's time and bound
    for name, key in (("three_material_ball", "sphere_closest_tmb"),
                      ("random_motion_ball", "sphere_closest")):
        scene, org, dirs, time = camera_rays(name, gen, dev)
        view, pack = scene.sphere_view
        ref = sphere_case(f"K2, {name} view, primary", org, dirs, time, view, pack,
                          timed=key)
        o2, d2 = secondary(org, dirs, ref[0], gen)
        sphere_case(f"K2, {name} view, secondary", o2, d2, time, view, pack)
    mb_view, mb_pack = view, pack

    org = (torch.rand(R_MAIN, 3, generator=gen) * 24 - 12).to(dev)
    dirs = torch.randn(R_MAIN, 3, generator=gen).to(dev)
    time = torch.rand(R_MAIN, generator=gen).to(dev)
    chunks = random_planar(gen, dev)
    pack = fi.pack_prim_constants(chunks)
    planar_case("K1 quad, random 700 in 6 chunks", org, dirs, chunks, pack, False)
    planar_case("K1 tri, random 700 in 6 chunks", org, dirs, chunks, pack, True)
    chunks = random_planar(gen, dev, holes=True)
    pack = fi.pack_prim_constants(chunks)
    log(f"  holed table: {int(chunks.active.sum())} of {chunks.active.numel()} lanes "
        "active, lane 0 of each chunk dead, lane 127 live")
    planar_case("K1 quad, holed random table in 6 chunks", org, dirs, chunks, pack, False)
    planar_case("K1 tri, holed random table in 6 chunks", org, dirs, chunks, pack, True)
    chunks = random_spheres(gen, dev)
    sphere_case("K2, random 700 in 6 chunks", org, dirs, time, chunks,
                fi.pack_sphere_constants(chunks))
    chunks = random_spheres(gen, dev, holes=True)
    log(f"  holed sphere table: {int(chunks.active.sum())} of "
        f"{chunks.active.numel()} lanes active, lane 0 of each chunk dead, lane 127 live")
    sphere_case("K2, holed random table in 6 chunks", org, dirs, time, chunks,
                fi.pack_sphere_constants(chunks))
    for n in (1, 77, 129, 511, 513):   # ragged R: not a multiple of a block's rays
        sphere_case(f"K2, random_motion_ball view, first {n} rays", org[:n] * 0.5,
                    dirs[:n], time[:n], mb_view, mb_pack)
    torch.cuda.synchronize()
    return errs, times, bounds


# ------------------------------------------------- phase 2: K3 and K4
def colonnade_rays(scene, cam, gen):
    """R_COLONNADE primary camera rays of the colonnade and their caps."""
    org, dirs, _, cap = profiling.scene_rays(scene, cam, gen)
    return org, dirs, cap


def colonnade_secondary(scene, org, dirs, t, gen):
    """Rays leaving the primary hits in random directions; a tenth of the
    lanes dead (cap = tmin), as terminated paths are in the render."""
    o2, d2 = secondary(org, dirs, t, gen)
    alive = (torch.rand(org.shape[0], generator=gen) > 0.1).to(org.device)
    return o2, d2, isect._packet_cap(scene, o2, d2, alive, INF, TMIN)


def bits_equal(label, got, ref) -> float:
    """K3 outputs bit-equal (NaN where NaN); returns the largest abs error
    of the finite nears (0.0 when bit-equal)."""
    for name, x, y in zip(("ids", "nears", "rest"), got, ref):
        if x.dtype == torch.float32:
            same = ((x.view(torch.int32) == y.view(torch.int32))
                    | (torch.isnan(x) & torch.isnan(y)))
        else:
            same = x == y
        if not bool(same.all()):
            raise AssertionError(f"{label}: {name} differ in {int((~same).sum())} "
                                 "entries")
    fin = torch.isfinite(ref[1])
    log(f"  {label}: bit-equal; finite slots {int(fin.sum())} of {fin.numel()}, "
        f"rays with a finite rest {int(torch.isfinite(ref[2]).sum())}")
    return max_abs(got[1][fin], ref[1][fin])


def sweep_compare(label, got, ref, cap, sphere) -> float:
    """K4 against its plain version: all 8 columns bit for bit (the kernel
    rounds as the plain version does). Reports each column's largest abs
    error over the hits (0) and returns the largest."""
    hit = ref[:, 0] < cap
    same = got.view(torch.int32) == ref.view(torch.int32)
    if not bool(same.all()):
        raise AssertionError(f"{label}: {int((~same.all(1)).sum())} rays differ from "
                             f"the plain version's (columns {torch.nonzero(~same.all(0))[:, 0].tolist()})")
    names = (("t", "cx", "cy", "cz", "rad", "v") if sphere
             else ("t", "nx", "ny", "nz", "u", "v"))
    err = {name: max_abs(got[hit, i], ref[hit, i]) for i, name in enumerate(names)}
    log(f"  {label}: rays {got.shape[0]} hits {int(hit.sum())}, bit-equal; max abs err {err}")
    return max(err.values())


def sweep_needs(rays, ids, nears, best, table, tri, sphere, step=16_384):
    """What the sequential sweep needs of one call's inputs, replayed with
    the plain version's operations: (visited (ray, slot) pairs, distinct
    rows visited, (ray, primitive) pairs of those slots that take the rest
    of the test: planar, a plane whose t lies in [tmin, the running best
    t]; sphere, a positive discriminant)."""
    K = table.shape[0]
    cid = ids.clamp(0, K - 1)
    org, dirs, tm = rays[:, 0:3], rays[:, 3:6], rays[:, 6]
    t_run = best[:, 0].clone()
    visits, more, rows = 0, 0, []
    for s in range(ids.shape[1]):
        vis = torch.nonzero(nears[:, s] < t_run)[:, 0]
        visits += vis.numel()
        rows.append(cid[vis, s])
        for a in range(0, vis.numel(), step):
            r = vis[a:a + step]
            row = table[cid[r, s]]
            if sphere:
                ts, _ = fsw._sphere_slot(org[r], dirs[r], tm[r], row, -INF,
                                         torch.full_like(t_run[r], INF))
                more += int(torch.isfinite(ts).sum())
                ts, _ = fsw._sphere_slot(org[r], dirs[r], tm[r], row, TMIN, t_run[r])
            else:
                n = torch.cross(row[:, 3:6], row[:, 6:9], dim=1)
                un = n * torch.rsqrt(torch.clamp((n * n).sum(1, keepdim=True), min=1e-30))
                d_n = (un * dirs[r][:, :, None]).sum(1)
                t = ((un * row[:, 0:3]).sum(1) - (un * org[r][:, :, None]).sum(1)) / d_n
                more += int(((d_n.abs() > 1e-20) & (t >= TMIN)
                             & (t <= t_run[r][:, None])).sum())
                ts, _ = fsw._planar_slot(org[r], dirs[r], row, TMIN, t_run[r], tri)
            t_run[r] = torch.minimum(t_run[r], ts.amin(1))
    return visits, int(torch.unique(torch.cat(rows)).numel()), more


def q16_cull_needs(rays, ids, nears, best, q, tri, step=16_384):
    """What K8's cull needs of one call's inputs, the sequential sweep
    replayed with its group boxes (``fused_sweep.q16_group_boxes`` and
    ``q16_group_slab``): (visited (ray, slot) pairs, (visit, live group)
    slab tests, (ray, primitive) pairs tested: the groups a visit enters
    before its running minimum, that is, exit >= tmin and entry <= the
    smaller of the running best t and the row's minimum over the groups
    before; of those, the pairs that take the edge tests: a plane whose t
    lies in [tmin, that limit])."""
    K, _, C = q.words.shape
    G = C // fsw.Q16_GROUP
    boxes = fsw.q16_group_boxes(q.words, q.lo, q.scale, fsw.Q16_PAD, tri)
    cid = ids.clamp(0, K - 1)
    org, dirs = rays[:, 0:3], rays[:, 3:6]
    t_run = best[:, 0].clone()
    visits = slabs = tested = edges = 0
    for s in range(ids.shape[1]):
        vis = torch.nonzero(nears[:, s] < t_run)[:, 0]
        visits += vis.numel()
        for a in range(0, vis.numel(), step):
            r = vis[a:a + step]
            k = cid[r, s]
            n = r.numel()
            row = fsw.dequant_q16(q.words[k], q.lo[k], q.scale[k])
            ts, _ = fsw._planar_slot(org[r], dirs[r], row, TMIN, t_run[r], tri)
            gmin = ts.reshape(n, G, fsw.Q16_GROUP).amin(-1)
            before = torch.cat([t_run[r][:, None], gmin[:, :-1]], 1).cummin(1).values
            blo, bhi, A, Cp, live = (x[k] for x in boxes)
            entry, exit_ = fsw.q16_group_slab(rays[r], blo, bhi, A, Cp)
            enter = live & (exit_ >= TMIN) & (entry <= before)
            slabs += int(live.sum())
            tested += int(enter.sum()) * fsw.Q16_GROUP
            nrm = torch.cross(row[:, 3:6], row[:, 6:9], dim=1)
            un = nrm * torch.rsqrt(torch.clamp((nrm * nrm).sum(1, keepdim=True), min=1e-30))
            d_n = (un * dirs[r][:, :, None]).sum(1)
            t = ((un * row[:, 0:3]).sum(1) - (un * org[r][:, :, None]).sum(1)) / d_n
            lim = before.repeat_interleave(fsw.Q16_GROUP, 1)
            edges += int(((d_n.abs() > 1e-20) & (t >= TMIN) & (t <= lim)
                          & enter.repeat_interleave(fsw.Q16_GROUP, 1)).sum())
            t_run[r] = torch.minimum(t_run[r], ts.amin(1))
    return visits, slabs, tested, edges


def q16_cull_bound(rays, ids, nears, best, q, tri):
    """K8's bound at what its cull needs (``q16_cull_needs``): the row
    bound's bytes; operations per visit, per slab test, per tested pair
    and edge test, and per primitive of each distinct row visited (its
    constants, dequantization and group boxes). -> (bound, needs)."""
    R, V = ids.shape
    C = q.words.shape[2]
    needs = q16_cull_needs(rays, ids, nears, best, q, tri)
    visits, slabs, tested, edges = needs
    rows = int(torch.unique(ids.clamp(0, q.words.shape[0] - 1)[nears < best[:, :1]]).numel())
    nbytes = 4 * (8 * R + 2 * R * V + 8 * R + 8 * R) + rows * 4 * (fsw.Q16_WORDS * C + 6)
    ops = (visits * OPS["visit_sweep_q16_visit"] + slabs * OPS["visit_sweep_q16_group"]
           + tested * OPS["visit_sweep_planar"] + edges * OPS["visit_sweep_planar_edges"]
           + rows * C * (OPS["visit_sweep_q16_row"] + OPS["visit_sweep_q16_box"]))
    return bound(nbytes, ops), needs


def q16_grazing_check(dev):
    """K8 against its plain version, all 8 columns bit for bit, on the
    grazing set (``procgen.grazing_table`` and ``vertex_rays``: rays aimed
    at every vertex of 6 small and large chunks at +-1,200 units, from
    random directions, along the axes and grazing), triangles and quads:
    slots (aimed-at chunk, the next, the aimed-at again, id -1), every near
    0, the input best t inf or 2 (the vertex lies at t = 1); two more
    chunks get no visit. Returns the largest error (0 when bit-equal)."""
    err = 0.0
    for kind in ("tri", "quad"):
        corner, eu, ev, act, lo, hi = procgen.grazing_table(kind == "quad", K=8)
        t = lambda x: torch.as_tensor(x, device=dev)
        q = perray.planar_q16(ch.PlanarChunks(
            t(corner), t(eu), t(ev), torch.zeros(act.shape, dtype=torch.int32, device=dev),
            t(act), t(lo), t(hi)))
        org, dirs, chunk = procgen.vertex_rays(q.words.cpu().numpy(), q.lo.cpu().numpy(),
                                               q.scale.cpu().numpy(), kind == "quad")
        keep = np.nonzero(chunk < 6)[0]
        org, dirs, chunk = t(org[keep]), t(dirs[keep]), t(chunk[keep])
        R = chunk.numel()
        ids = torch.stack([chunk, (chunk + 1) % 6, chunk, torch.full_like(chunk, -1)], 1)
        ids = ids.to(torch.int32).contiguous()
        nears = torch.zeros((R, 4), device=dev)
        t_in = torch.where(torch.arange(R, device=dev) % 2 == 0, INF, 2.0)
        z = torch.zeros_like(t_in)
        best = fsw.pack_best_planar(t_in, torch.zeros_like(org), z, z, z.int(), z.int())
        rays = fsw.pack_rays(org, dirs)
        got = fsw.sweep_q16_kernel(rays, ids, nears, best, q.words, q.lo, q.scale, TMIN,
                                   kind == "tri")
        ref = fsw.sweep_q16_plain(rays, ids, nears, best, q.words, q.lo, q.scale, TMIN,
                                  kind == "tri")
        err = max(err, sweep_compare(f"K8 {kind}, grazing set ({R} rays aimed at vertices, "
                                     "on axes and grazing, +-1,200 units)", got, ref,
                                     best[:, 0], False))
    return err


def sweep_check(label, rays, ids, nears, best, table, tri, sphere, timed=False,
                kernel=fsw.sweep_kernel, plain=fsw.sweep_plain, q16=None):
    """K4 (or ``kernel``: K7 on sub-tile rows) against its plain version on
    one call's inputs (bit for bit); ``q16``: (words, lo, scale), K8 on the
    quantized rows whose dequantized table is ``table``. ``timed``: also
    the kernel's and the plain version's times, the bound (what the
    sequential sweep needs, ``sweep_needs``, at the redesigned count) and
    the bound at the count before the redesign. Returns (err, (ms,
    plain_ms), bound), the last two None unless timed."""
    if q16 is not None:
        kernel = lambda r, i, n, b, _t, *a: fsw.sweep_q16_kernel(r, i, n, b, *q16, *a[:2])
        plain = lambda r, i, n, b, _t, *a: fsw.sweep_q16_plain(r, i, n, b, *q16, *a[:2])
    got = kernel(rays, ids, nears, best, table, TMIN, tri, sphere)
    ref = plain(rays, ids, nears, best, table, TMIN, tri, sphere)
    err = sweep_compare(label, got, ref, best[:, 0], sphere)
    if not timed:
        return err, None, None
    ms = cuda_ms(lambda: kernel(rays, ids, nears, best, table, TMIN, tri, sphere))
    plain_ms = cuda_ms(lambda: plain(rays, ids, nears, best, table, TMIN, tri, sphere))
    R, V = ids.shape
    F, C = table.shape[1], table.shape[2]
    kind = "sphere" if sphere else "planar"
    visits, rows, more = sweep_needs(rays, ids, nears, best, table, tri, sphere)
    # a quantized row: 5 words a primitive and the chunk's lo and scale
    row_bytes = 4 * (fsw.Q16_WORDS * C + 6) if q16 is not None else 4 * F * C
    row_ops = OPS["visit_sweep_q16_row"] if q16 is not None else OPS[f"visit_sweep_{kind}_row"]
    nbytes = 4 * (8 * R + 2 * R * V + 8 * R + 8 * R) + rows * row_bytes
    b = bound(nbytes, visits * C * OPS[f"visit_sweep_{kind}"]
              + rows * C * row_ops
              + more * OPS["sphere_root" if sphere else "visit_sweep_planar_edges"])
    b_old = bound(nbytes, visits * C * OPS_PER_PAIR_BEFORE[kind])
    log(f"  {label}, timed: {R} rays, {visits} (ray, slot) pairs visited by the "
        f"sequential sweep ({int((nears < best[:, :1]).sum())} below the input best) "
        f"of {R * V}, {rows} distinct rows, {more} (ray, primitive) pairs "
        + ("take the root" if sphere else "test the edges")
        + f": kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}), "
        f"share {b[0] / ms:.3f}; the count before the redesign "
        f"({OPS_PER_PAIR_BEFORE[kind]} per pair, the whole test whatever the data: "
        f"no floor) gives {b_old[0]:.4f} ms, {b_old[0] / ms:.3f} of the kernel's time")
    return err, (ms, plain_ms), b


def phase_select_sweep(scene, cam, dev):
    """K3 and K4 against their plain versions at the colonnade's shapes;
    returns (errs, times, bounds) keyed by kernel name."""
    gen = torch.Generator().manual_seed(1)
    tabs = scene.tri_perray
    K = scene.tri_chunks.corner.shape[0]
    V = min(perray.VISIT_BLOCK, K)
    errs = {"cull_select": 0.0, "visit_sweep": 0.0}
    times, bounds = {}, {}

    org, dirs, cap = colonnade_rays(scene, cam, gen)
    t, _ = perray.planar_closest_perray(org, dirs, scene.tri_chunks, TMIN, True,
                                        cap, tabs=tabs)
    o2, d2, cap2 = colonnade_secondary(scene, org, dirs, t, gen)
    lists = {}
    for which, (o, d, c) in (("primary", (org, dirs, cap)),
                             ("secondary", (o2, d2, cap2))):
        R = o.shape[0]
        rays = fs.pack_rays(o, d, c)
        z = torch.zeros_like(c)
        best0 = fsw.pack_best_planar(c, torch.zeros_like(o), z, z, z.int(), z.int())
        for packed in (True, False):
            mode = "packed" if packed else "exact"
            excl1 = fs.first_excl(R, dev)
            got = fs.cull_select_kernel(rays, tabs.boxes, excl1, V, K, TMIN, packed)
            ref = fs.cull_select_plain(rays, tabs.boxes, excl1, V, K, TMIN, packed)
            errs["cull_select"] = max(errs["cull_select"], bits_equal(
                f"K3 {mode}, colonnade {which}, phase 1", got, ref))
            if packed:
                lists[which] = (o, d, c, got[0], got[1])
            # phase 2 as the unmarked loop asks it, and as the phase loop
            # asks it: the rays a real K4 sweep left done marked exhausted
            best = fsw.sweep_kernel(fsw.pack_rays(o, d), got[0], got[1], best0,
                                    tabs.table, TMIN, True, False)
            done = ~(got[2] < best[:, 0])
            excl2 = {"phase 2": fs.next_excl(*got[:2]),
                     "phase 2, done rays marked": fs.next_excl(got[0], got[1], done,
                                                               TMIN, packed)}
            log(f"  K3 {mode}, colonnade {which}: {int(done.sum())} of {R} rays done "
                "after phase 1 and its K4 sweep")
            for label, excl in excl2.items():
                got2 = fs.cull_select_kernel(rays, tabs.boxes, excl, V, K, TMIN, packed)
                ref2 = fs.cull_select_plain(rays, tabs.boxes, excl, V, K, TMIN, packed)
                errs["cull_select"] = max(errs["cull_select"], bits_equal(
                    f"K3 {mode}, colonnade {which}, {label}", got2, ref2))
            if which == "primary" and packed:
                times["cull_select"] = (
                    cuda_ms(lambda: fs.cull_select_kernel(rays, tabs.boxes, excl1, V, K,
                                                          TMIN)),
                    cuda_ms(lambda: fs.cull_select_plain(rays, tabs.boxes, excl1, V, K,
                                                         TMIN)))
                ms2 = {label: cuda_ms(lambda e=e: fs.cull_select_kernel(
                    rays, tabs.boxes, e, V, K, TMIN)) for label, e in excl2.items()}
                log(f"  K3 at the colonnade's primary rays: phase 1 "
                    f"{times['cull_select'][0]:.4f} ms; " + "; ".join(
                        f"{label} {ms:.4f} ms" for label, ms in ms2.items()))
                times["cull_select_phase2"] = ms2["phase 2, done rays marked"]
                nbytes = 4 * (8 * R + tabs.boxes.numel() + 2 * R + 2 * V * R + R)
                bounds["cull_select"] = bound(nbytes, R * K * OPS["cull_select"])

    # K1 on the colonnade's light view: one live lane of 128
    view, pack = scene.quad_view
    got = fi.planar_closest_fused(org, dirs, view, TMIN, False, pack=pack)
    ref = ch.planar_closest(org, dirs, view, TMIN, False)
    errs["planar_closest_light"] = compare("K1 quad, colonnade light view, primary",
                                           got, ref, PLANAR_FIELDS)
    rays1 = fi.pack_rays(org, dirs)
    R = org.shape[0]
    live = int(view.active.sum())
    times["planar_closest_light"] = cuda_ms(lambda: fi.planar_closest_kernel(
        rays1, pack, TMIN))
    b_ms, b_by = closest_bound("planar_closest", R, pack, live)
    log(f"  K1 at the colonnade's light view ({live} live lane of {view.active.numel()}, "
        f"{R} rays): {times['planar_closest_light']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    def sweep_case(label, o, d, time, c, ids, nears, table, tri, sphere):
        z = torch.zeros_like(c)
        best = (fsw.pack_best_sphere(c, torch.zeros_like(o), z + 1, z.int(), z.int())
                if sphere else
                fsw.pack_best_planar(c, torch.zeros_like(o), z, z, z.int(), z.int()))
        err = sweep_check(label, fsw.pack_rays(o, d, time), ids, nears, best, table, tri,
                          sphere)[0]
        errs["visit_sweep"] = max(errs["visit_sweep"], err)

    # K4 at every phase the per-ray loop gives the colonnade's primary rays
    # (phase 2 with the rays phase 1 left done marked exhausted), timed; the
    # kernels line takes phase 1
    rays4, calls = profiling.sweep_phases(org, dirs, None, cap, tabs, K, TMIN, True, False)
    for p, (ids, nears, best) in enumerate(calls):
        err, ms, b = sweep_check(f"K4 triangles, colonnade primary, phase {p + 1}", rays4,
                                 ids, nears, best, tabs.table, True, False, timed=True)
        errs["visit_sweep"] = max(errs["visit_sweep"], err)
        times[f"visit_sweep_phase{p + 1}"], bounds[f"visit_sweep_phase{p + 1}"] = ms, b
    times["visit_sweep"], bounds["visit_sweep"] = times.pop("visit_sweep_phase1"), \
        bounds.pop("visit_sweep_phase1")
    o, d, c, ids, nears = lists["secondary"]
    sweep_case("K4 triangles, colonnade secondary, phase 1", o, d, None, c, ids, nears,
               tabs.table, True, False)

    # spheres: a random table of 6,000 moving spheres (47 chunks)
    rng = np.random.default_rng(2)
    b = SceneBuilder()
    mats = [b.lambertian((0.5, 0.5, 0.5)), b.metal((0.7, 0.7, 0.7))]
    for i, c in enumerate(rng.uniform(-30, 30, (6000, 3))):
        b.moving_sphere(c, c + rng.normal(0, 0.2, 3), rng.uniform(0.2, 1.2), mats[i % 2])
    sph = b.build(dev)
    stabs = sph.sphere_perray
    Ks = sph.sphere_chunks.rad.shape[0]
    o = (torch.rand(R_COLONNADE, 3, generator=gen) * 70 - 35).to(dev)
    d = torch.randn(R_COLONNADE, 3, generator=gen).to(dev)
    time = torch.rand(R_COLONNADE, generator=gen).to(dev)
    c = isect._packet_cap(sph, o, d, None, INF, TMIN)
    ids, nears, _ = fs.cull_select_kernel(fs.pack_rays(o, d, c), stabs.boxes,
                                          fs.first_excl(R_COLONNADE, dev),
                                          min(perray.VISIT_BLOCK, Ks), Ks, TMIN)
    sweep_case(f"K4 spheres, random 6000 in {Ks} chunks, phase 1", o, d, time, c,
               ids, nears, stabs.table, False, True)
    torch.cuda.synchronize()
    return errs, times, bounds



def phase_sphereflake(scene, cam, dev):
    """K3 and K4's sphere branch at sphereflake's shape (its 160,000
    primary camera rays against 7,381 spheres in 58 chunks, the first main
    path on which K4's sphere branch does real work): ids, nears and rest
    bit-equal, the sweep against its plain version; returns (errs, times,
    bound) with K4's time and bound there."""
    gen = torch.Generator().manual_seed(6)
    tabs = scene.sphere_perray
    K = scene.sphere_chunks.rad.shape[0]
    V = min(perray.VISIT_BLOCK, K)
    R = cam.width * cam.height
    org, dirs, time_, cap = profiling.scene_rays(scene, cam, gen)
    rays = fs.pack_rays(org, dirs, cap)
    excl = fs.first_excl(R, dev)
    got = fs.cull_select_kernel(rays, tabs.boxes, excl, V, K, TMIN)
    ref = fs.cull_select_plain(rays, tabs.boxes, excl, V, K, TMIN)
    errs = {"cull_select": bits_equal("K3 packed, sphereflake primary, phase 1",
                                      got, ref)}
    srays = fsw.pack_rays(org, dirs, time_)
    z = torch.zeros_like(cap)
    best = fsw.pack_best_sphere(cap, torch.zeros_like(org), z + 1, z.int(), z.int())
    errs["visit_sweep"], ms, b = sweep_check(
        f"K4 spheres, sphereflake primary ({K} chunks), phase 1", srays, got[0], got[1],
        best, tabs.table, False, True, timed=True)
    k3_ms = cuda_ms(lambda: fs.cull_select_kernel(rays, tabs.boxes, excl, V, K, TMIN))
    k3_bytes = 4 * (8 * R + tabs.boxes.numel() + 2 * R + 2 * V * R + R)
    k3_b = bound(k3_bytes, R * K * OPS["cull_select"])
    log(f"  K3 phase 1 at sphereflake's primary rays: {k3_ms:.4f} ms, bound "
        f"{k3_b[0]:.4f} ms ({k3_b[1]})")
    torch.cuda.synchronize()
    return errs, ms, b


# ----------------------- phase 2: the opt-in per-ray routes' K3, K7 and K8
# the switches of the JAX package's opt-in per-ray routes (ops/perray.py)
MODES = {"subtile": {"CRT_SUBTILE": "1"}, "q16": {"CRT_SWEEP_Q16": "1"}}
# K7's widths held against the plain version and timed: the default 32
# (8,060 colonnade sub-tiles), 16 (16,120: above the 8,192 buckets a count
# keeps in shared memory, had K7 kept a bucket a sub-tile) and 8 (32,240;
# K3 at V 32)
SUB_WIDTHS_CHECKED = (32, 16, 8)
# K3's and K7's timed sub-tile width (the default CRT_SUBC)
SUBTILE_TIMED = perray.SUBTILE_C
# an image under a switch against the default route's of the same key
# (the pixel share holds for the sub-tile route, which is exact; the
# quantized rows move the colonnade's surfaces by up to a quantum, 0.11
# units in its largest chunks and above tmin in 48% of them, so secondary
# rays change winners and the q16 image is held to the default's by its
# mean, and bitwise to the q16 route run on K8's plain version)
MODE_MEAN_ATOL = 2e-3
MODE_PIXEL_SHARE = 0.99
# the sub-tile route's gradient against the default route's: a ray through
# a shared edge (two triangles at one t) keeps the first in visit order,
# and sub-tiles order them otherwise than chunks, so a few vertex gradients
# move (on the card 3, 6 and 3 of geo_tri_v0/v1/v2's 773,748, from 2 and 1
# tied rays of 40,000 primary and secondary); every family within the JAX
# tolerances on all but this share of its elements (set after that run)
MODE_GRAD_OUTLIERS = 2e-5
# samples of the runs held against the same route on K7's or K8's plain
# version (the plain sweep runs every slot of every ray: ~40-60 ms a call)
MODE_TWIN_SPP = 2


@contextlib.contextmanager
def switches(env):
    """The environment switches ``env`` set inside the block."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_modes_kernels(scene, cam, dev):
    """K3 on the colonnade's sub-tile boxes (V 24, 24, 32), K7 at CS 32, 16
    and 8 on the lists K3 gives there, and K8 on the chunk route's phase-1
    lists (V 16), each against its plain version (K3 bit-equal, K7 and K8
    all 8 columns bit for bit) at the colonnade's 40,000 primary rays;
    phase 1 timed (K3 at CS 32; K7 at each width, with its time by
    stage). Returns (errs, times, bounds)."""
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(1)
    tabs = scene.tri_perray
    K = scene.tri_chunks.corner.shape[0]
    org, dirs, cap = colonnade_rays(scene, cam, gen)
    R = org.shape[0]
    rays, srays = fs.pack_rays(org, dirs, cap), fsw.pack_rays(org, dirs)
    excl = fs.first_excl(R, dev)
    z = torch.zeros_like(cap)
    best = fsw.pack_best_planar(cap, torch.zeros_like(org), z, z, z.int(), z.int())
    errs = {"cull_select": 0.0}
    times, bounds = {}, {}
    for CS in SUB_WIDTHS_CHECKED:
        t0 = time.perf_counter()
        sub = tabs.subtile(CS)
        KG = sub.table.shape[0]
        V = perray.subtile_v(KG, CS)
        log(f"  colonnade sub-tile tables at CS {CS}: {KG} boxes (Kp "
            f"{sub.boxes.shape[1]}, id bits {fs.id_bits(sub.boxes.shape[1])}), V {V}, "
            f"built in {time.perf_counter() - t0:.2f} s")
        got = fs.cull_select_kernel(rays, sub.boxes, excl, V, KG, TMIN)
        ref = fs.cull_select_plain(rays, sub.boxes, excl, V, KG, TMIN)
        errs["cull_select"] = max(errs["cull_select"], bits_equal(
            f"K3 packed, colonnade sub-tile boxes (CS {CS}), V {V}, phase 1", got, ref))
        err, ms, b = sweep_check(
            f"K7 triangles, colonnade sub-tiles (CS {CS}), phase 1", srays, got[0],
            got[1], best, sub.table, True, False, timed=True,
            kernel=fsw.sweep_sub_kernel)
        errs["visit_sweep_sub"] = max(errs.get("visit_sweep_sub", 0.0), err)
        times[f"visit_sweep_sub_cs{CS}"], bounds[f"visit_sweep_sub_cs{CS}"] = ms, b
        stages = profiling.sweep_stage_ms(lambda n: fsw.sweep_sub_kernel(
            srays, got[0], got[1], best, sub.table, TMIN, True, False, stages=n))
        log(f"  K7 at CS {CS} by stage (CUDA events, each stage added in turn): "
            + ", ".join(f"{name} {1e3 * t:.2f} us" for name, t in stages.items())
            + f"; sum {1e3 * sum(stages.values()):.2f} us, whole call {1e3 * ms[0]:.2f} us, "
            f"bound {1e3 * b[0]:.2f} us ({b[1]}), share {b[0] / ms[0]:.3f}")
        if CS == SUBTILE_TIMED:
            k3 = (cuda_ms(lambda: fs.cull_select_kernel(rays, sub.boxes, excl, V, KG,
                                                        TMIN)),
                  cuda_ms(lambda: fs.cull_select_plain(rays, sub.boxes, excl, V, KG,
                                                       TMIN)))
            nbytes = 4 * (8 * R + sub.boxes.numel() + 2 * R + 2 * V * R + R)
            times["cull_select_subtile"] = k3
            bounds["cull_select_subtile"] = bound(nbytes, R * KG * OPS["cull_select"])
            log(f"  K3 at the colonnade's sub-tile boxes (CS {CS}, V {V}), phase 1: "
                f"kernel {k3[0]:.4f} ms, plain {k3[1]:.4f} ms, bound "
                f"{bounds['cull_select_subtile'][0]:.4f} ms "
                f"({bounds['cull_select_subtile'][1]})")
    times["visit_sweep_sub"] = times[f"visit_sweep_sub_cs{SUBTILE_TIMED}"]
    bounds["visit_sweep_sub"] = bounds[f"visit_sweep_sub_cs{SUBTILE_TIMED}"]
    # K8 on the chunk route's phase-1 lists (K4's phase-1 inputs)
    q = tabs.q16()
    V = min(perray.VISIT_BLOCK, K)
    ids, nears, _ = fs.cull_select_kernel(rays, tabs.boxes, excl, V, K, TMIN)
    err, ms, b = sweep_check("K8 triangles, colonnade quantized rows, phase 1", srays, ids,
                             nears, best, fsw.dequant_q16(q.words, q.lo, q.scale), True,
                             False, timed=True, q16=(q.words, q.lo, q.scale))
    errs["visit_sweep_q16"] = max(err, q16_grazing_check(dev))
    times["visit_sweep_q16"], bounds["visit_sweep_q16_row"] = ms, b
    k4 = cuda_ms(lambda: fsw.sweep_kernel(srays, ids, nears, best, tabs.table, TMIN, True,
                                          False))
    log(f"  K8 against K4 on the same lists, in this call: K8 {ms[0]:.4f} ms, K4 "
        f"{k4:.4f} ms ({ms[0] / k4:.3f}x)")
    # K8's bound: what its group boxes need (the row bound, kept beside it
    # to compare with K4 and with K8 before its redesign, tests every
    # primitive of each sequentially visited row)
    cull, (visits, slabs, tested, edges) = q16_cull_bound(srays, ids, nears, best, q, True)
    bounds["visit_sweep_q16"] = cull
    stages = profiling.sweep_stage_ms(lambda n: fsw.sweep_q16_kernel(
        srays, ids, nears, best, q.words, q.lo, q.scale, TMIN, True, stages=n))
    log(f"  K8 cull: of {visits} sequentially visited slots, {slabs} (visit, live "
        f"group) slab tests, {tested} (ray, primitive) pairs tested in the groups "
        f"entered (against {visits * q.words.shape[2]} in whole rows), {edges} take "
        f"the edge tests; bound at this count {1e3 * cull[0]:.2f} us ({cull[1]}), "
        f"share {cull[0] / ms[0]:.3f}; row bound {1e3 * b[0]:.2f} us, share "
        f"{b[0] / ms[0]:.3f}")
    log("  K8 by stage (CUDA events, each stage added in turn; its tile stage is "
        "q16_derive, the row stage, and q16_sweep_tile): "
        + ", ".join(f"{name} {1e3 * t:.2f} us" for name, t in stages.items())
        + f"; sum {1e3 * sum(stages.values()):.2f} us, whole call {1e3 * ms[0]:.2f} us")
    torch.cuda.synchronize()
    log(f"  the opt-in routes' kernels took {time.perf_counter() - t_phase:.1f} s")
    return errs, times, bounds


def phase_estimator_kernels(dev):
    """The traffic of next-event estimation, volumes and the noise scenes
    through K1-K4, against the plain versions: K1 and K2 on the shadow rays
    of cornell_box_with_sphere_light at 600x600 (from every lane's first
    hit toward a sampled point of the light; the render traces them with
    the inactive lanes too); K1 on cornell_box_with_volume's primary rays;
    at perlin_texture_ball's 600x600 (2,401 quads in 19 chunks) K3 (bit-
    equal) and K4 (bit for bit) at every phase of its primary rays' phase
    loop, and at phase 1 of shadow-like rays toward its light quad with half
    the lanes dead (cap = tmin), and K2 on its two spheres. Returns the
    largest error per kernel."""
    gen = torch.Generator().manual_seed(7)
    errs = {"planar_closest": 0.0, "sphere_closest": 0.0, "cull_select": 0.0,
            "visit_sweep": 0.0}

    scene, cam = catalog.cornell_box_with_sphere_light(spp=1, device=dev)
    org, dirs, time, _ = profiling.scene_rays(scene, cam, gen)
    R = org.shape[0]
    hit = isect.intersect_brute(scene, org, dirs, time, TMIN,
                                torch.zeros((R, scene.n_volumes), device=dev))
    u = torch.rand(R, 3, generator=gen).to(dev)
    sh_dirs = mat_ops.light_sample(scene, hit.p, u[:, 0], u[:, 1], u[:, 2])
    log(f"  cornell_box_with_sphere_light {cam.width}x{cam.height}: "
        f"{int(hit.valid.sum())} of {R} first hits cast a live shadow ray")
    closest_check("sphere-light Cornell, shadow rays", hit.p.contiguous(), sh_dirs,
                  time, scene, errs)
    scene, cam = catalog.cornell_box_with_volume(spp=1, device=dev)
    org, dirs, time, _ = profiling.scene_rays(scene, cam, gen)
    closest_check("volume Cornell, primary", org, dirs, time, scene, errs)

    scene, cam = catalog.perlin_texture_ball(spp=1, device=dev)
    tabs, K = scene.quad_perray, scene.quad_chunks.corner.shape[0]
    V = min(perray.VISIT_BLOCK, K)
    log(f"  perlin_texture_ball {cam.width}x{cam.height}: {scene.counts[1]} quads in "
        f"{K} chunks, {scene.counts[0]} spheres")
    org, dirs, time, cap = profiling.scene_rays(scene, cam, gen)
    closest_check("perlin_texture_ball view, primary", org, dirs, time, scene, errs)
    t, _ = perray.planar_closest_perray(org, dirs, scene.quad_chunks, TMIN, False,
                                        cap, tabs=tabs)
    p = org + torch.where(torch.isfinite(t), t, torch.zeros_like(t))[:, None] * dirs
    light = torch.tensor([123.0, 554.0, 147.0], device=dev)
    uv = torch.rand(org.shape[0], 2, generator=gen).to(dev)
    target = light + uv[:, :1] * torch.tensor([300.0, 0, 0], device=dev) \
        + uv[:, 1:] * torch.tensor([0, 0, 265.0], device=dev)
    sh = (p.contiguous(), (target - p).contiguous())
    live = (torch.rand(org.shape[0], generator=gen) < 0.5).to(dev) & torch.isfinite(t)
    sh_cap = isect._packet_cap(scene, *sh, live, INF, TMIN)
    log(f"  perlin_texture_ball shadow-like rays: {int(live.sum())} of "
        f"{org.shape[0]} live")
    for label, (o, d, c) in (("primary", (org, dirs, cap)),
                             ("shadow-like, half dead", (*sh, sh_cap))):
        excl = fs.first_excl(o.shape[0], dev)
        rays = fs.pack_rays(o, d, c)
        got = fs.cull_select_kernel(rays, tabs.boxes, excl, V, K, TMIN)
        ref = fs.cull_select_plain(rays, tabs.boxes, excl, V, K, TMIN)
        errs["cull_select"] = max(errs["cull_select"], bits_equal(
            f"K3 packed, perlin_texture_ball {label}, phase 1", got, ref))
        rays4, calls = profiling.sweep_phases(o, d, None, c, tabs, K, TMIN, False,
                                              False)
        for n, (ids, nears, best) in enumerate(calls):
            errs["visit_sweep"] = max(errs["visit_sweep"], sweep_check(
                f"K4 quads, perlin_texture_ball {label}, phase {n + 1}", rays4, ids,
                nears, best, tabs.table, False, False)[0])
    torch.cuda.synchronize()
    return errs


def closest_check(label, org, dirs, time, scene, errs):
    """K1 on a dense scene's quads and K2 on its spheres against the plain
    versions, on the given rays; the largest errors go into ``errs``."""
    if scene.counts[1] and scene.quad_chunks is None:
        view, pack = scene.quad_view
        got = fi.planar_closest_fused(org, dirs, view, TMIN, False, pack=pack)
        ref = ch.planar_closest(org, dirs, view, TMIN, False)
        errs["planar_closest"] = max(errs["planar_closest"], compare(
            f"K1 quad, {label}", got, (ref[0], ref[1][:4]), PLANAR_FIELDS))
    if scene.counts[0] and scene.sphere_chunks is None:
        view, pack = scene.sphere_view
        got = fi.sphere_closest_fused(org, dirs, time, view, TMIN, pack=pack)
        ref = ch.sphere_closest(org, dirs, time, view, TMIN)
        errs["sphere_closest"] = max(errs["sphere_closest"], compare(
            f"K2, {label}", got, (ref[0], ref[1][:3]), SPHERE_FIELDS))


def phase_spectral_kernels(dev):
    """The traffic of the spectral and env-light scenes through K1 and K2,
    against the plain versions: at dispersion_prism's 400x400 its primary
    rays (K1 on the three light strips, K2 on the glass sphere), then the
    rays its first hits scatter at random hero wavelengths (those refracted
    into the sphere leave from its surface inward, and K2 finds them the
    exit) and the third generation; at sunlit_spheres' own size (400 px
    wide, aspect 1.78) K2 on its primary rays and on the NEE shadow rays
    from every first hit toward an importance-sampled sky direction.
    Returns the largest error per kernel."""
    gen = torch.Generator().manual_seed(11)
    errs = {"planar_closest": 0.0, "sphere_closest": 0.0}
    scene, cam = catalog.dispersion_prism(spp=1, device=dev)
    org, dirs, time, _ = profiling.scene_rays(scene, cam, gen)
    R = org.shape[0]
    wl = integrator._wavelength(torch.rand(R, generator=gen).to(dev))
    shift = spectrum.cauchy_ior_shift(wl)
    for gen_no in (1, 2, 3):
        closest_check(f"dispersion_prism, generation {gen_no}", org, dirs, time, scene,
                      errs)
        if gen_no == 3:
            break
        hit = isect.intersect_brute(scene, org, dirs, time, TMIN,
                                    torch.zeros((R, 0), device=dev))
        u = torch.rand(R, mat_ops.NSLOT, generator=gen).to(dev)
        new_dir, _, cont = mat_ops.scatter(scene, hit, dirs, u, shift)
        inward = cont & (vm.dot(new_dir, hit.normal) < 0)
        log(f"  dispersion_prism {cam.width}x{cam.height}, generation {gen_no + 1}: "
            f"{int(cont.sum())} of {R} rays scatter, {int(inward.sum())} of them "
            "refracted into the glass")
        org, dirs = hit.p.contiguous(), new_dir.contiguous()
    scene, cam = catalog.sunlit_spheres(spp=1, device=dev)
    org, dirs, time, _ = profiling.scene_rays(scene, cam, gen)
    R = org.shape[0]
    closest_check(f"sunlit_spheres {cam.width}x{cam.height}, primary", org, dirs, time,
                  scene, errs)
    hit = isect.intersect_brute(scene, org, dirs, time, TMIN,
                                torch.zeros((R, 0), device=dev))
    u = torch.rand(R, 3, generator=gen).to(dev)
    sh_dirs = mat_ops.light_sample(scene, hit.p, u[:, 0], u[:, 1], u[:, 2])
    log(f"  sunlit_spheres: {int(hit.valid.sum())} of {R} first hits cast a live "
        "shadow ray toward the sky")
    closest_check("sunlit_spheres, NEE shadow rays toward the sky", hit.p.contiguous(),
                  sh_dirs.contiguous(), time, scene, errs)
    torch.cuda.synchronize()
    return errs


# ------------------------------------------- phase 2: K6 (the packet route)
# the tiles K6 is timed at on sphereflake's primary and secondary rays and
# perlin's primary rays, packet.AUTO_TILE among them; on sphereflake's
# primary rays JAX's 2,048 too (79 blocks on 132 SMs)
PACKET_TILES = (128, 256, 512)
# a tile's visit count may differ from the plain version's where the two
# round a planar hit apart and a chunk's entry t falls between their bests:
# at most this share of the tiles (spheres: none, K2's rounding is the
# plain version's); dropping the early exit changes nearly every tile's
PACKET_VISIT_SHARE = 0.01
# the share of sphereflake's primary rays that hold K6's tie rule on its
# doubled table (every 4th: the plain version's host loop is slow)
DOUBLED_STRIDE = 4
# the plain version's per-tile host loop (a synchronisation at every tile
# and at every chunk a tile visits) holds K6 on every 8th tile: at tile 32
# the whole loop took 12.6 s (sphereflake) and 40.4 s (perlin) a call on an
# NVIDIA H100 80GB HBM3 (700 W)
PACKET_PLAIN_STRIDE = 8


def packet_compare(label, got, ref, sphere, tri, dirs):
    """K6 against its plain version: hit masks equal (planar: except rays
    whose hit lies within EDGE_EPS of an edge or on the surface the ray
    leaves, within OWN_EPS of its origin along the normal, counted), pids
    and materials equal (planar: except near-ties, t within rtol 1e-4, and
    those marginal rays, counted; spheres: all), t within rtol 1e-4 / atol
    1e-4 and the payload within atol 1e-3 where the pids agree (a grazing
    planar hit whose t is off by more is held by its hit point along the
    normal, within 1e-3, counted), each tile's visit count equal (planar:
    all but PACKET_VISIT_SHARE of the tiles).
    Returns the largest abs error."""
    t, pay, visits = got
    t_r, pay_r, visited = ref
    nf = 2 if sphere else 3
    hit, hit_r = torch.isfinite(t), torch.isfinite(t_r)
    mat, pid, mat_r, pid_r = pay[nf], pay[nf + 1], pay_r[nf], pay_r[nf + 1]

    def edge(h, u, v):
        far = torch.minimum(u, v)
        far = torch.minimum(far, 1.0 - u - v) if tri else torch.minimum(
            far, torch.minimum(1.0 - u, 1.0 - v))
        return h & (far < EDGE_EPS)

    def own(h, t_, n):
        return h & ((torch.where(h, t_, torch.zeros_like(t_))
                     * vm.dot(n, dirs)).abs() <= OWN_EPS)

    explained = torch.zeros_like(hit) if sphere else (
        edge(hit, pay[1], pay[2]) | edge(hit_r, pay_r[1], pay_r[2])
        | own(hit, t, pay[0]) | own(hit_r, t_r, pay_r[0]))
    mask = hit != hit_r
    if bool((mask & ~explained).any()):
        raise AssertionError(f"{label}: hit masks differ in "
                             f"{int((mask & ~explained).sum())} rays away from an edge "
                             "and from the surface they leave")
    both = hit & hit_r
    differ = both & (pid != pid_r)
    near = differ & ((t - t_r).abs() <= 1e-4 * t_r.abs())
    if sphere and bool(differ.any()):
        raise AssertionError(f"{label}: pid differs in {int(differ.sum())} rays")
    if bool((differ & ~(near | explained)).any()):
        raise AssertionError(f"{label}: pid differs in "
                             f"{int((differ & ~(near | explained)).sum())} rays that are "
                             "no near-tie and at no edge")
    if bool((~hit & (pid != 0)).any()):
        raise AssertionError(f"{label}: pid is not 0 on a miss")
    same = both & (pid == pid_r)
    if not torch.equal(mat[same], mat_r[same]):
        raise AssertionError(f"{label}: materials differ")
    # a ray that meets the surface it leaves has for t the rounding of its
    # own origin: t is held where the hit is away from the origin
    same = same & ~explained if not sphere else same
    grazing = torch.zeros_like(same)
    if not sphere:
        # the plane's t rounds n.c - n.o apart by a few ulp of the
        # coordinates, which a grazing ray divides by a small n.d: such a
        # ray is held by its hit point along the normal, within 1e-3, as
        # the per-ray route is held to its oracle (perray_vs_oracle)
        d_err = (t - t_r).abs()
        grazing = same & (d_err > 1e-4 + 1e-4 * t_r.abs()) & (
            d_err * vm.dot(pay_r[0], dirs).abs() <= 1e-3)
        same = same & ~grazing
    torch.testing.assert_close(t[same], t_r[same], rtol=1e-4, atol=1e-4)
    err = {"t": max_abs(t[same], t_r[same])}
    for i, name in enumerate(SPHERE_FIELDS if sphere else PLANAR_FIELDS):
        torch.testing.assert_close(pay[i][same], pay_r[i][same], rtol=0, atol=1e-3,
                                   msg=lambda m, n=name: f"{label}: {n}: {m}")
        err[name] = max_abs(pay[i][same], pay_r[i][same])
    v_r = torch.tensor([len(v) for v in visited], dtype=torch.int32, device=visits.device)
    off = int((visits != v_r).sum())
    if off > (0 if sphere else PACKET_VISIT_SHARE * v_r.numel()):
        raise AssertionError(f"{label}: visit counts differ in {off} of {v_r.numel()} "
                             f"tiles ({int(visits.sum())} against {int(v_r.sum())} visits)")
    log(f"  {label}: rays {t.shape[0]} hits {int(hit_r.sum())}; masks differ at an edge "
        f"or on the surface left in {int(mask.sum())}; pid differs in {int(differ.sum())} (near-ties "
        f"{int(near.sum())}); grazing hits held along the normal {int(grazing.sum())}; "
        f"tiles {v_r.numel()}, visits {int(v_r.sum())} (per tile "
        f"{float(v_r.float().mean()):.2f}, max {int(v_r.max()) if v_r.numel() else 0}), "
        f"tiles whose count differs {off}; max abs err {err}")
    return max(err.values())


# FP32 instructions of one (ray, chunk) slab test in K6's cull, counted from
# csrc/packet_closest.cu: 6 subtractions, 6 products, 6 min/max of the
# pairs, 4 min/max for near and far, 3 compares, a max with tmin and a
# select; the per-ray reciprocals and the warp reduction are not counted
OPS["packet_cull"] = 27


def packet_bound(sphere, R, T, K, pack, n_tiles, lane_tests):
    """K6's bound: bytes, its ray rows (6, or 7 with the time) and cap read,
    8 hit rows and pid written per ray, the pack and boxes read once; ops,
    a slab test for every (tile lane, chunk) pair of the cull of each of
    ``n_tiles`` tiles and a test for each of ``lane_tests`` (tile lane,
    live primitive) pairs of the chunks the tiles visited
    (``lanes_tested``; the sphere roots are not counted)."""
    nbytes = 4 * ((7 if sphere else 6) * R + R + 9 * R + pack.numel() + 6 * K)
    ops = n_tiles * T * K * OPS["packet_cull"] + lane_tests * OPS[
        "sphere_closest" if sphere else "planar_closest"]
    return bound(nbytes, ops)


def lanes_tested(org, dirs, cap, chunks, T, visits) -> int:
    """The (tile lane, live primitive) pairs K6 tests in tiles of T rays:
    each tile visits the first ``visits[g]`` (the count K6 reports, held
    to the plain version's on the tiles ``packet_case`` checks) of the
    chunks its rays cross, in (entry t, chunk id) order, the plain
    version's order (``packet._chunk_hits`` of every tile at once)."""
    R, K = org.shape[0], chunks.lo.shape[0]
    o, d, c = packet._pad_tiles([org, dirs, cap], R, T)            # [G,T,...]
    inv = 1.0 / torch.where(d.abs() > 1e-20, d, torch.full_like(d, 1e-20))
    t0 = (chunks.lo[None, None] - o[:, :, None]) * inv[:, :, None]   # [G,T,K,3]
    t1 = (chunks.hi[None, None] - o[:, :, None]) * inv[:, :, None]
    near = torch.minimum(t0, t1).amax(-1)
    far = torch.maximum(t0, t1).amin(-1)
    del t0, t1
    ok = (near <= far) & (far >= TMIN) & (near <= c[:, :, None])
    near_c = torch.where(ok, torch.clamp(near, min=TMIN), torch.full_like(near, INF))
    keyed = torch.where(ok.any(1), near_c.amin(1), torch.full_like(near_c[:, 0], INF))
    order = torch.argsort(keyed, dim=1, stable=True)                 # [G,K]
    live = chunks.active.sum(dim=1)
    take = torch.arange(K, device=org.device)[None] < visits.long()[:, None]
    return T * int((live[order] * take).sum())


def packet_case(label, kind, org, dirs, time_, cap, chunks, pack, errs, tile=None,
                timed=None, times=None, bounds=None, tiles=None,
                stride=PACKET_PLAIN_STRIDE):
    """K6 (``kind`` "sphere", "quad" or "tri") on these rays against its
    plain version on every ``stride``-th tile (all rays of those tiles,
    and their visit counts); ``timed``: the key its kernel time,
    the plain version's time on those tiles and the bound go under, at
    ``tile`` and at each of ``tiles`` (the key's own at ``tile``; the
    bound from K6's own visit counts at each tile, ``lanes_tested``). Each
    timed tile's line gives the visits per tile (mean, max) and the
    instance's registers per thread and resident blocks per SM."""
    sphere, tri = kind == "sphere", kind == "tri"
    name = "packet_sphere" if sphere else "packet_planar"
    tile = tile or packet.AUTO_TILE
    R, k = org.shape[0], stride
    T0 = min(tile, R)
    sel = (torch.arange(R, device=org.device) // T0) % k == 0
    if sphere:
        got = packet.sphere_packet_hit(org, dirs, time_, chunks, TMIN, cap, tile, pack)
        plain = lambda: packet.sphere_packet_plain(org[sel], dirs[sel], time_[sel], chunks,
                                                   TMIN, cap[sel], T0)
    else:
        got = packet.planar_packet_hit(org, dirs, chunks, TMIN, tri, cap, tile, pack)
        plain = lambda: packet.planar_packet_plain(org[sel], dirs[sel], chunks, TMIN, tri,
                                                   cap[sel], T0)
    # the plain loop synchronises at every tile and every chunk a tile
    # visits: its one call is timed on the host's clock
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    got_k = (got[0][sel], tuple(p[sel] for p in got[1]), got[2][::k])
    errs[name] = max(errs.get(name, 0.0), packet_compare(
        f"{label}, every {k}th tile", got_k, ref, sphere, tri, dirs[sel]))
    log(f"  K6 {kind}, {label}: plain version {plain_ms:.4f} ms a call on every {k}th "
        f"tile ({len(ref[2])} of {got[2].numel()} tiles)")
    if not timed:
        return got
    K = int(chunks.mat.shape[0])
    rays = fi.pack_rays(org, dirs, time_ if sphere else None)
    lo, hi = chunks.lo.contiguous(), chunks.hi.contiguous()

    def kernel(t):
        if sphere:
            return packet.packet_sphere_kernel(rays, cap, pack, lo, hi, TMIN, t)
        return packet.packet_planar_kernel(rays, cap, pack, lo, hi, TMIN, t, tri)

    for t in sorted({tile, *(tiles or ())}):
        T = min(t, R)
        ms = cuda_ms(lambda: kernel(T))
        visits = got[2] if T == T0 else kernel(T)[2]
        b = packet_bound(sphere, R, T, K, pack, visits.numel(),
                         lanes_tested(org, dirs, cap, chunks, T, visits))
        key = timed if T == T0 else f"{timed}_tile{T}"
        times[key] = (ms, plain_ms) if T == T0 else (ms,)
        bounds[key] = b
        info = packet.kernel_info(kind, T, K)
        log(f"  K6 {kind}, {label}, tile {T} ({visits.numel()} blocks): kernel {ms:.4f} "
            f"ms, visits {int(visits.sum())} (per tile {float(visits.float().mean()):.2f}, "
            f"max {int(visits.max())}), bound {b[0]:.4f} ms ({b[1]}), bound / kernel "
            f"{b[0] / ms:.3f}; {info['registers']} registers, {info['threads']} threads, "
            f"{info['rays_per_thread']} rays a thread, {info['threads_per_ray']} threads a "
            f"ray, {info['blocks_per_sm']} blocks per SM")
    return got


def duplicated_spheres(chunks):
    """The table twice over: chunk k + K holds chunk k's spheres, so the
    two give every ray the same t and the same entry t, and the tie rule
    (entry t, then chunk id; a hit kept only where strictly nearer) must
    keep chunk k's."""
    cat = lambda a: torch.cat([a, a]).contiguous()
    return ch.SphereChunks(*[cat(getattr(chunks, f.name))
                             for f in dataclasses.fields(chunks)])


def phase_packet(dev, sf_scene, sf_cam, roots):
    """K6 against its plain version at the packet route's shapes:
    sphereflake's 160,000 primary rays on its 58 chunks (timed at each
    PACKET_TILES and 2,048) and the same rays after one bounce,
    coherence-sorted (timed at each PACKET_TILES); its table doubled (the
    tie rule); perlin_texture_ball's 600x600 primary rays on its 19 quad
    chunks (timed at each PACKET_TILES); the 16 px colonnade's 71 triangle
    chunks and the 576-triangle Fox stand-in's 5, primary and secondary
    rays (the Fox's timed). Returns (errs, times, bounds)."""
    gen = torch.Generator().manual_seed(12)
    errs, times, bounds = {}, {}, {}
    chunks, pack = sf_scene.sphere_chunks, sf_scene.sphere_pack
    org, dirs, time_, cap = profiling.scene_rays(sf_scene, sf_cam, gen)
    t, _, _ = packet_case(f"sphereflake {sf_cam.width}x{sf_cam.height} primary "
                          f"({chunks.rad.shape[0]} chunks)", "sphere", org, dirs, time_,
                          cap, chunks, pack, errs, timed="packet_sphere", times=times,
                          bounds=bounds, tiles=PACKET_TILES + (2048,))
    o2, d2 = secondary(org, dirs, t, gen)
    lo, hi = org.new_tensor(sf_scene.world_lo), org.new_tensor(sf_scene.world_hi)
    (o2, d2, t2), _ = raysort.sort_rays(raysort.coherence_keys(o2, d2, lo, hi),
                                        [o2, d2, time_])
    cap2 = isect._packet_cap(sf_scene, o2, d2, None, INF, TMIN)
    packet_case("sphereflake secondary, coherence-sorted", "sphere", o2, d2, t2, cap2,
                chunks, pack, errs, timed="packet_sphere_secondary", times=times,
                bounds=bounds, tiles=PACKET_TILES)
    # the tie rule on every DOUBLED_STRIDE-th primary ray
    dup = duplicated_spheres(chunks)
    k = DOUBLED_STRIDE
    got = packet_case(f"sphereflake primary, every {k}th ray, its table doubled "
                      f"({dup.rad.shape[0]} chunks)", "sphere", org[::k].contiguous(),
                      dirs[::k].contiguous(), time_[::k].contiguous(), cap[::k].contiguous(),
                      dup, fi.pack_sphere_constants(dup), errs)
    n_first = chunks.rad.numel()
    if bool((got[1][3] >= n_first).any()):
        raise AssertionError("K6 doubled table: a ray kept the copy's sphere")

    scene, cam = catalog.perlin_texture_ball(spp=1, device=dev)
    org, dirs, time_, cap = profiling.scene_rays(scene, cam, gen)
    packet_case(f"perlin_texture_ball {cam.width}x{cam.height} primary "
                f"({scene.quad_chunks.corner.shape[0]} quad chunks)", "quad", org, dirs,
                time_, cap, scene.quad_chunks, scene.quad_pack, errs,
                timed="packet_planar", times=times, bounds=bounds, tiles=PACKET_TILES)
    with assets(roots["fox576"]):
        fox = catalog.textured_fox(device=dev)
    for label, (scene, cam) in (
            ("16 px colonnade", catalog.sponza(width=16, spp=1, device=dev)),
            ("576-triangle Fox stand-in", fox)):
        org, dirs, time_, cap = profiling.scene_rays(scene, cam, gen)
        K = scene.tri_chunks.corner.shape[0]
        for which in ("primary", "secondary"):
            # the Fox's rays are the traffic of textured_fox's and glass_fox's
            # K6 launches: timed
            timed = f"packet_planar_fox_{which}" if "Fox" in label else None
            # the 16 px colonnade's 8 tiles are all checked
            t, _, _ = packet_case(f"{label} {cam.width}x{cam.height} {which} ({K} triangle "
                                  "chunks)", "tri", org, dirs, time_, cap,
                                  scene.tri_chunks, scene.tri_pack, errs, timed=timed,
                                  times=times, bounds=bounds,
                                  stride=PACKET_PLAIN_STRIDE if timed else 1)
            org, dirs = secondary(org, dirs, t, gen)
            cap = isect._packet_cap(scene, org, dirs, None, INF, TMIN)
    torch.cuda.synchronize()
    return errs, times, bounds



# --------------------------- phases 4, 5: the packet route and checkpoints
# the packet-routed renders, each against CRT_ACCEL=ray: the images agree
# as two exact routes do, by their means (golden atol); the share of
# pixels within 1e-3 is printed (paths that graze a primitive can branch
# apart, and the mirrors of sphereflake amplify that)
ROUTE_MEAN_ATOL = 2e-3
# the BVH oracle's run on sphereflake, cut from 400x400x50 depth 5
BVH_CUT = dict(width=64, spp=1, max_depth=2)
# two float32 solves of a grazing hit on a sphereflake sphere, each up to
# 1.6e-4 of t from the float64 root (ROADMAP section 3)
SPHERE_GRAZING_RTOL = 3.2e-4
# checkpoint runs: Cornell 512x512 depth 8 at CKPT_CORNELL_SPP, cut from
# 256 (~15 s; see POOL_SPP), in chunks of 16 spp, and the sphereflake
# wavefront 400x400x50 depth 5 in chunks of 16; each interrupted after two
# chunks and resumed
CKPT_CHUNKS = {"cornell": 16, "sphereflake": 16}
CKPT_CORNELL_SPP = 64
# the card's wavefront flushes with an atomic float index_add_: resumed and
# uninterrupted agree to float32 summation order there, not bitwise
CKPT_WF_TOL = dict(rtol=1e-5, atol=1e-6)


@contextlib.contextmanager
def accel(mode):
    """``CRT_ACCEL`` set to ``mode`` (None: unset) inside the block."""
    saved = os.environ.get("CRT_ACCEL")
    os.environ.pop("CRT_ACCEL", None)
    if mode is not None:
        os.environ["CRT_ACCEL"] = mode
    try:
        yield
    finally:
        os.environ.pop("CRT_ACCEL", None)
        if saved is not None:
            os.environ["CRT_ACCEL"] = saved


def packet_route(label, render, cam, want, refuse=()):
    """One render on the default (packet) route and one under
    CRT_ACCEL=ray, each with its launches counted alone (the packet route:
    ``want``, which is K6's entry, and no K3 or K4; the per-ray route: K3
    and K4 and no K6), then the two timed again in turns (ray, packet).
    Their means must agree within ROUTE_MEAN_ATOL. Returns (packet walls,
    ray walls, packet launches, packet image). ``refuse``: kernels neither
    route may launch."""
    walls, counts, imgs = {"packet": [], "ray": []}, {}, {}
    for route in ("packet", "ray", "ray", "packet"):
        with accel(None if route == "packet" else "ray"):
            profiling.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = render()
            torch.cuda.synchronize()
            walls[route].append(time.perf_counter() - t0)
            counts.setdefault(route, profiling.launches())
        imgs.setdefault(route, img)
        if not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{label} ({route}): non-finite values")
    pk, ry = counts["packet"], counts["ray"]
    if pk[want] <= 0 or pk["cull_select"] or pk["visit_sweep"]:
        raise AssertionError(f"{label}: the packet route launched {pk}")
    if ry["cull_select"] <= 0 or ry["visit_sweep"] <= 0 or ry[want]:
        raise AssertionError(f"{label}: the per-ray route launched {ry}")
    if any(pk[n] or ry[n] for n in refuse):
        raise AssertionError(f"{label}: a route launched one of {refuse}")
    a, b = imgs["packet"], imgs["ray"]
    close = float(((a - b).abs().amax(-1) <= 1e-3).float().mean())
    rays = cam.width * cam.height * cam.spp
    log(f"  {label}: packet route {', '.join(f'{w:.3f}' for w in walls['packet'])} s "
        f"({rays / min(walls['packet']) / 1e6:.3f} M camera rays/s), per-ray route "
        f"{', '.join(f'{w:.3f}' for w in walls['ray'])} s; means {float(a.mean()):.6f} / "
        f"{float(b.mean()):.6f}, pixels within 1e-3 {close:.4f}; launches packet {pk}, "
        f"ray {ry}")
    if abs(float(a.mean()) - float(b.mean())) > ROUTE_MEAN_ATOL:
        raise AssertionError(f"{label}: the packet and per-ray images' means differ")
    return walls["packet"], walls["ray"], pk, a


def bvh_oracle(dev):
    """The BVH oracle on sphereflake cut to BVH_CUT: its hits on the
    primary rays and on their mirror reflections against the chunk route's
    (K2 over the whole table): masks and pids equal but on marginal rays,
    whose hit in either route grazes its sphere (|cos| < 0.05 against the
    normal) or lies within 1e-2 of the origin (the surface the ray leaves),
    or near-ties (two spheres within SPHERE_GRAZING_RTOL of one t), counted; t within rtol 1e-4 / atol 2e-4 (the expanded quadratic rounded
    in two orders) or, for an ill-conditioned hit, SPHERE_GRAZING_RTOL. Its
    render against the chunk route's: means within ROUTE_MEAN_ATOL."""
    scene, cam = catalog.sphereflake(device=dev, **BVH_CUT)
    gen = torch.Generator().manual_seed(13)
    org, dirs, time_, _ = profiling.scene_rays(scene, cam, gen)
    for which in ("primary", "mirror-reflected"):
        t, pay = bvh.sphere_closest_bvh(org, dirs, time_, scene.sphere_chunks,
                                        scene.sphere_tree, TMIN)
        t_r, pay_r = fi.sphere_closest_fused(org, dirs, time_, scene.sphere_chunks, TMIN,
                                             pack=scene.sphere_pack)
        _, (_, _, _, pid_c) = ch.sphere_closest(org, dirs, time_, scene.sphere_chunks, TMIN)
        hit, hit_r = torch.isfinite(t), torch.isfinite(t_r)

        def normal_of(tt, ctr, rad):
            fin = torch.where(torch.isfinite(tt), tt, torch.zeros_like(tt))
            return (org + fin[:, None] * dirs - ctr) / rad[:, None], fin

        def marginal(tt, ctr, rad):
            n, fin = normal_of(tt, ctr, rad)
            cos = vm.dot(n, dirs).abs() / vm.length(dirs)
            return torch.isfinite(tt) & ((cos < 0.05) | (fin * vm.length(dirs) < 1e-2))

        both = hit & hit_r
        differ = (hit != hit_r) | (both & (pay[3] != pid_c))
        # a near-tie: two spheres at one depth (sphereflake's children touch
        # their parent), within the solves' rounding
        tie = both & ((t - t_r).abs() <= SPHERE_GRAZING_RTOL * t_r.abs())
        explained = tie | marginal(t, pay[0], pay[1]) | marginal(t_r, pay_r[0], pay_r[1])
        if bool((differ & ~explained).any()):
            i = int(torch.nonzero(differ & ~explained)[0, 0])
            raise AssertionError(
                f"BVH oracle, sphereflake {which}: hits differ in "
                f"{int((differ & ~explained).sum())} rays that are not marginal; e.g. ray "
                f"{i}: t {float(t[i])} / {float(t_r[i])}, pid {int(pay[3][i])} / "
                f"{int(pid_c[i])}")
        same = both & ~differ
        # the two round the expanded quadratic (|o|^2 ~ 1.2e5 against rad^2
        # ~ 0.15) in other orders: a grazing hit on sphereflake's small
        # spheres lies up to 1.6e-4 from a float64 solve in either (ROADMAP
        # section 3), so two solves may differ by 3.2e-4 of t there
        err = (t - t_r).abs()
        grazing = same & (err > 2e-4 + 1e-4 * t_r.abs())
        if bool((grazing & (err > SPHERE_GRAZING_RTOL * t_r.abs())).any()):
            raise AssertionError(f"BVH oracle, sphereflake {which}: t off the chunk "
                                 "route's beyond a grazing hit's rounding")
        log(f"  BVH oracle, sphereflake {cam.width}x{cam.height} {which}: {int(hit_r.sum())} "
            f"hits of {hit.numel()}; masks or pids differ on {int(differ.sum())} marginal "
            f"rays; t max abs err {max_abs(t[same & ~grazing], t_r[same & ~grazing]):.3g} "
            f"(rtol 1e-4, atol 2e-4); {int(grazing.sum())} ill-conditioned hits within "
            f"rtol {SPHERE_GRAZING_RTOL}")
        n, fin = normal_of(t_r, pay_r[0], pay_r[1])
        org = org + fin[:, None] * dirs
        dirs = dirs - 2.0 * vm.dot(dirs, n)[:, None] * n
    imgs = {}
    for mode in ("bvh", "chunked"):
        with accel(mode):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            imgs[mode] = integrator.render_image(scene, cam, keys.key(0))
            torch.cuda.synchronize()
            log(f"  sphereflake {cam.width}x{cam.height} {cam.spp}spp depth "
                f"{cam.max_depth} (cut from 400x400x50 depth 5), CRT_ACCEL={mode}: "
                f"{time.perf_counter() - t0:.3f} s, mean {float(imgs[mode].mean()):.6f}")
    if abs(float(imgs["bvh"].mean()) - float(imgs["chunked"].mean())) > ROUTE_MEAN_ATOL:
        raise AssertionError("BVH oracle: the image's mean is off the chunk route's")


def checkpoint_runs(dev, sf_scene, sf_cam):
    """``render_with_checkpoint`` interrupted after two chunks and resumed,
    against the uninterrupted run: the Cornell scan bitwise, the
    sphereflake wavefront within CKPT_WF_TOL. Returns seconds by run."""
    secs = {}
    scene, cam = catalog.cornell_box(width=512, spp=CKPT_CORNELL_SPP, max_depth=8,
                                     device=dev)
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_")
    for label, sc_, cm, wf in (("cornell", scene, cam, False),
                               ("sphereflake", sf_scene, sf_cam, True)):
        kw = dict(seed=0, chunk_spp=CKPT_CHUNKS[label], use_wavefront=wf)
        path = os.path.join(work.name, f"{label}.ckpt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole = checkpoint.render_with_checkpoint(sc_, cm, log=lambda *_: None, **kw)
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        chunks = []

        def stop(msg):
            if msg.startswith("[render]"):
                chunks.append(msg)
                if len(chunks) == 3:
                    raise KeyboardInterrupt

        try:
            checkpoint.render_with_checkpoint(sc_, cm, ckpt_path=path, log=stop, **kw)
            raise AssertionError(f"checkpoint {label}: the render was not interrupted")
        except KeyboardInterrupt:
            pass
        logs = []
        t0 = time.perf_counter()
        img = checkpoint.render_with_checkpoint(sc_, cm, ckpt_path=path, log=logs.append,
                                                **kw)
        torch.cuda.synchronize()
        secs[f"{label} resumed"] = time.perf_counter() - t0
        if not any("resuming at" in m for m in logs) or os.path.exists(path):
            raise AssertionError(f"checkpoint {label}: not resumed, or not removed")
        err = max_abs(img, whole)
        if wf:
            torch.testing.assert_close(img, whole, **CKPT_WF_TOL)
        elif not torch.equal(img, whole):
            raise AssertionError(f"checkpoint {label}: resumed scan not bitwise the "
                                 f"uninterrupted one (max abs diff {err:.3g})")
        log(f"  render_with_checkpoint {label} {cm.width}x{cm.height} {cm.spp}spp depth "
            f"{cm.max_depth} ({'wavefront' if wf else 'scan'}, chunks of "
            f"{CKPT_CHUNKS[label]} spp): uninterrupted {secs[label]:.3f} s; stopped after "
            f"two chunks and resumed ({logs[0]}): {secs[label + ' resumed']:.3f} s for the "
            f"rest; resumed against uninterrupted max abs diff {err:.3g} "
            f"({'within rtol 1e-5' if wf else 'bitwise'})")
    work.cleanup()
    return secs


# ----------------------------------------------- phase 2: pid and K5
def pid_compare(label, out, pid, ref_t, ref_pid, ref_mat, valid_row, mat_row):
    """A kernel's pid output against the plain version's: equal on every
    ray whose hit mask and material agree, unless a near-tie (both t within
    rtol 1e-4: two primitives at one depth). Returns (rays whose pid
    differs, near-ties among them, rays whose mask or material differs)."""
    hit = out[valid_row] > 0.5
    hit_r = torch.isfinite(ref_t)
    mat = torch.round(out[mat_row]).to(torch.int32)
    agree = (hit == hit_r) & (~hit | (mat == ref_mat))
    differ = agree & hit & (pid != ref_pid)
    near = differ & ((out[0] - ref_t).abs() <= 1e-4 * ref_t.abs())
    if bool((differ & ~near).any()):
        raise AssertionError(f"{label}: pid differs from the plain version's in "
                             f"{int((differ & ~near).sum())} rays that are no near-tie")
    if bool((~hit & (pid != 0)).any()):
        raise AssertionError(f"{label}: pid is not 0 on a miss")
    counts = (int(differ.sum()), int(near.sum()), int((~agree).sum()))
    log(f"  {label}: rays {pid.shape[0]} hits {int(hit_r.sum())}; pid differs in "
        f"{counts[0]} (near-ties {counts[1]}); mask or material differs in {counts[2]}")
    return counts


def phase_pid(dev):
    """K1 and K2 with their pid output against the plain versions' pid, at
    the Cornell, three_material_ball and random_motion_ball shapes and on
    holed tables; returns K1's ms without and with pid on Cornell's primary
    rays."""
    gen = torch.Generator().manual_seed(4)
    scene, org, dirs, _ = camera_rays("cornell_box", gen, dev)
    view, pack = scene.quad_view
    rays0 = fi.pack_rays(org, dirs)
    for which in ("primary", "secondary"):
        rays = fi.pack_rays(org, dirs)
        for tri in (False, True):
            out, pid = fi.planar_closest_kernel(rays, pack, TMIN, triangle=tri,
                                                with_pid=True)
            t_r, pay_r = ch.planar_closest(org, dirs, view, TMIN, tri)
            pid_compare(f"K1 pid {'tri' if tri else 'quad'}, cornell view, {which}",
                        out, pid, t_r, pay_r[4], pay_r[3], fi.OUT_VALID, fi.OUT_MAT)
            if not tri:
                t_quad = t_r
        org, dirs = secondary(org, dirs, t_quad, gen)
    ms = (cuda_ms(lambda: fi.planar_closest_kernel(rays0, pack, TMIN)),
          cuda_ms(lambda: fi.planar_closest_kernel(rays0, pack, TMIN, with_pid=True)))
    log(f"  K1 at the Cornell primary shape: {ms[0]:.4f} ms without pid, "
        f"{ms[1]:.4f} ms with pid")
    chunks = random_planar(gen, dev, holes=True)
    pack = fi.pack_prim_constants(chunks)
    org = (torch.rand(R_MAIN, 3, generator=gen) * 24 - 12).to(dev)
    dirs = torch.randn(R_MAIN, 3, generator=gen).to(dev)
    rays = fi.pack_rays(org, dirs)
    for tri in (False, True):
        out, pid = fi.planar_closest_kernel(rays, pack, TMIN, triangle=tri, with_pid=True)
        t_r, pay_r = ch.planar_closest(org, dirs, chunks, TMIN, tri)
        pid_compare(f"K1 pid {'tri' if tri else 'quad'}, holed random table", out, pid,
                    t_r, pay_r[4], pay_r[3], fi.OUT_VALID, fi.OUT_MAT)

    for name in ("three_material_ball", "random_motion_ball"):
        scene, org, dirs, time_ = camera_rays(name, gen, dev)
        view, pack = scene.sphere_view
        for which in ("primary", "secondary"):
            out, pid = fi.sphere_closest_kernel(fi.pack_rays(org, dirs, time_), pack,
                                                TMIN, with_pid=True)
            t_r, pay_r = ch.sphere_closest(org, dirs, time_, view, TMIN)
            pid_compare(f"K2 pid, {name} view, {which}", out, pid, t_r, pay_r[3],
                        pay_r[2], fi.SOUT_VALID, fi.SOUT_MAT)
            org, dirs = secondary(org, dirs, t_r, gen)
    chunks = random_spheres(gen, dev, holes=True)
    org = (torch.rand(R_MAIN, 3, generator=gen) * 24 - 12).to(dev)
    dirs = torch.randn(R_MAIN, 3, generator=gen).to(dev)
    out, pid = fi.sphere_closest_kernel(fi.pack_rays(org, dirs, time_),
                                        fi.pack_sphere_constants(chunks), TMIN,
                                        with_pid=True)
    t_r, pay_r = ch.sphere_closest(org, dirs, time_, chunks, TMIN)
    pid_compare("K2 pid, holed random sphere table", out, pid, t_r, pay_r[3], pay_r[2],
                fi.SOUT_VALID, fi.SOUT_MAT)
    torch.cuda.synchronize()
    return ms


def phase_gather(dev):
    """K5 against its plain version at both table sizes; returns the
    probe's results (the first at the defaults)."""
    R, _, V, rowf = gather_probe.DEFAULTS
    results = []
    for K in gather_probe.TABLE_ROWS:
        r = gather_probe.measure(R, K, V, rowf, dev)
        log(f"  K5 {R} rays x {V} slots from a {r['table_mb']:.1f} MB table "
            f"({r['named_rows']} of {K} rows named): kernel {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), share {r['share']:.3f}; plain "
            f"{r['plain_ms']:.4f} ms; embedding_bag {r['library_ms']:.4f} ms "
            f"({r['library_gbps']:.1f} GB/s gathered, a row per ray and slot); rel err "
            f"{r['rel_err']:.3g} (embedding_bag {r['library_rel_err']:.3g}), "
            f"{r['bit_unequal']} of {R} outputs bit-unequal to the plain version's")
        if not r["rel_err"] <= 1e-5:
            raise AssertionError(f"K5 rel err {r['rel_err']} > 1e-5 at K {K}")
        results.append(r)
    return results


def phase_scatter(dev):
    """K9 against its plain version (``kernel_ab.scatter_check``) on every
    bounce of one sample: the Cornell box at the scan cell's 600x600,
    depth 4, under both cosine samplers, and all_materials_fixture, the
    volume box, the sphere-light box and dispersion_prism at 256x256; then
    K9 and its plain version timed on the Cornell box's second bounce.
    Returns (max abs err, (ms, plain ms), (bound ms, bound term))."""
    scenes = [("cornell_box 600x600 (the scan cell's bounces)", "sphere",
               lambda: catalog.cornell_box(width=600, spp=1, max_depth=4, device=dev))]
    scenes.append(("cornell_box 600x600 under CRT_COSINE=onb", "onb", scenes[0][2]))
    for name in ("all_materials_fixture", "cornell_box_with_volume",
                 "cornell_box_with_sphere_light", "dispersion_prism"):
        scenes.append((f"{name} 256x256", "sphere",
                       lambda n=name: getattr(catalog, n)(width=256, spp=1, max_depth=4,
                                                          device=dev)))
    err = 0.0
    for label, cosine, make in scenes:
        with switches({"CRT_COSINE": cosine}):
            scene, cam = make()
            calls = kernel_ab.scatter_calls(scene, cam, keys.key(0))
            r = kernel_ab.scatter_check(scene, calls)
        log(f"  K9 {label}: {len(calls)} bounces, {r['lanes']} lanes, {r['bit_equal']} "
            f"bit for bit with the plain version, max abs err {r['max_abs_err']:.3g}; "
            f"beyond atol {kernel_ab.SCATTER_TOL['atol']} / rtol "
            f"{kernel_ab.SCATTER_TOL['rtol']} (bounce, lane), each at a light's edge: "
            f"{r['outliers']}")
        if not r["ok"]:
            raise AssertionError(f"K9 {label}: differs from its plain version")
        err = max(err, r["max_abs_err"])
    scene, cam = scenes[0][2]()
    hit, ray_dir, u, ior_shift, pre = kernel_ab.scatter_calls(scene, cam, keys.key(0))[1]
    with torch.no_grad():
        ms = profiling.cuda_ms(lambda: fsc.scatter(scene, hit, ray_dir, u, ior_shift, *pre))
        plain_ms = profiling.cuda_ms(lambda: mat_ops.scatter_plain(scene, hit, ray_dir, u,
                                                                   ior_shift, pre))
    R = hit.p.shape[0]
    bound_ms = kernel_ab.scatter_bytes(R, False) / profiling.HBM_BYTES_PER_S * 1e3
    log(f"  K9 at the Cornell box's second bounce ({R} rays): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes), share {bound_ms / ms:.3f}")
    return err, (ms, plain_ms), (bound_ms, "bytes")


# ------------------------------------------------- phase 3: gradients
def grads_close(label, got, ref, loss_rtol=LOSS_RTOL, scene_tol=SCENE_TOL,
                camera_tol=CAMERA_TOL):
    """(loss, (scene grads, camera grads)) against a reference, by default
    at the tolerances above; logs each family's largest abs error."""
    loss, (gs, gc) = got
    loss_r, (gs_r, gc_r) = ref
    torch.testing.assert_close(float(loss), float(loss_r), rtol=loss_rtol, atol=0)
    err = {}
    for grads, grads_r, tol in ((gs, gs_r, scene_tol), (gc, gc_r, camera_tol)):
        if grads.keys() != grads_r.keys():
            raise AssertionError(f"{label}: parameter sets differ")
        for name, g in grads.items():
            g, g_r = g.detach().cpu(), grads_r[name].detach().cpu()
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{label}: {name} is not finite")
            torch.testing.assert_close(g, g_r, **tol,
                                       msg=lambda m, n=name: f"{label}: {n}: {m}")
            err[name] = max_abs(g, g_r)
    log(f"  {label}: loss {float(loss):.6f} / {float(loss_r):.6f}; max abs err "
        + ", ".join(f"{k} {v:.2e}" for k, v in err.items()))


def grads_of(scene, cam, seed, **kw):
    target = torch.zeros((cam.height, cam.width, 3), device=scene.device)
    return diff.loss_and_grads(scene, cam, keys.key(seed), target, cam.spp, **kw)


def kernel_route_grads(dev):
    """K1's and K2's autograd route (kernel forward, chunk-scan backward)
    against plain autograd through the chunk scan on the same CUDA tensors
    (rtol 1e-4). Per-ray gradients are the same operations; table gradients
    sum 262,144 rays' terms, which the gathers' backward adds atomically in
    no fixed order, so two runs of either route differ by ~1e-4 of a sum.
    PyTorch's deterministic algorithms are on for this check only: the sums
    then run in one order, and what is compared is the kernel's decision."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _kernel_route_grads(dev)
    finally:
        torch.use_deterministic_algorithms(False)


def _kernel_route_grads(dev):
    gen = torch.Generator().manual_seed(5)
    for name in ("cornell_box", "three_material_ball"):
        scene, org, dirs, time_ = camera_rays(name, gen, dev)
        view, pack = scene.quad_view if name == "cornell_box" else scene.sphere_view
        fields = ("corner", "eu", "ev") if name == "cornell_box" else ("c0", "c1", "rad")
        view = dataclasses.replace(view, **{f: getattr(view, f).clone().requires_grad_()
                                            for f in fields})
        org = org.clone().requires_grad_()
        dirs = dirs.clone().requires_grad_()
        leaves = [org, dirs] + [getattr(view, f) for f in fields]
        w = torch.randn((org.shape[0], 8), generator=gen).to(dev)

        def weighted(outs):
            total = 0.0
            for i, x in enumerate(outs):
                x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
                x = x.reshape(x.shape[0], -1)
                total = total + (x * w[:, i:i + x.shape[1]]).sum()
            return total

        if name == "cornell_box":
            t, pay = fi.planar_closest_fused(org, dirs, view, TMIN, False, pack=pack)
            t_r, pay_r = ch.planar_closest(org, dirs, view, TMIN, False)
            got, ref = (t, *pay[:3]), (t_r, *pay_r[:3])
        else:
            t, pay = fi.sphere_closest_fused(org, dirs, time_, view, TMIN, pack=pack)
            t_r, pay_r = ch.sphere_closest(org, dirs, time_, view, TMIN)
            got, ref = (t, *pay[:2]), (t_r, *pay_r[:2])
        g = torch.autograd.grad(weighted(got), leaves)
        g_r = torch.autograd.grad(weighted(ref), leaves)
        errs = []
        for a, b, n in zip(g, g_r, ["org", "dirs", *fields]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6,
                                       msg=lambda m, n=n: f"{name}: d/d {n}: {m}")
            errs.append(f"{n} {max_abs(a, b):.2e}")
        log(f"  {'K1' if name == 'cornell_box' else 'K2'} autograd route vs plain "
            f"autograd, {name} view, {org.shape[0]} rays: max abs err " + ", ".join(errs))


def finite_difference(dev):
    """Central differences of the replay loss against its gradient on the
    card: a wall albedo and the back wall's depth (cornell_box, 10 px, 2
    spp, depth 2, key 5; tests/test_torch_diff.py's cases)."""
    scene, cam = catalog.cornell_box(width=10, spp=2, max_depth=2, device=dev)
    target = torch.zeros((cam.height, cam.width, 3), device=dev)
    key = keys.key(5)
    _, (gs, _) = diff.loss_and_grads(scene, cam, key, target, 2)
    p0 = diff.scene_params(scene)
    for name, idx, eps, rtol in (("tex_color0", (1, 0), 1e-2, 2e-2),
                                 ("geo_quad_corner", (4, 2), 0.3, 1e-2)):
        def loss_at(delta):
            p = dict(p0)
            p[name] = p0[name].clone()
            p[name][idx] += delta
            return float(diff.image_loss(diff.apply_scene_params(scene, p), cam, key,
                                         target, 2))

        fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
        ad = float(gs[name][idx])
        log(f"  finite differences, {name}{list(idx)}: gradient {ad:.6e}, central "
            f"difference (eps {eps}) {fd:.6e}, rel err {abs(ad - fd) / abs(fd):.2e} "
            f"(gate {rtol})")
        if not (abs(ad) > 1e-6 and abs(ad - fd) <= rtol * abs(fd)):
            raise AssertionError(f"finite differences of {name} disagree")


def phase_grad_checks(dev):
    kernel_route_grads(dev)
    scene, cam = catalog.cornell_box(width=64, spp=4, max_depth=4, device=dev)
    grads_close("cornell_box 64 px 4 spp depth 4, replay vs oracle route",
                grads_of(scene, cam, 3), grads_of(scene, cam, 3, replay_isect=False))
    finite_difference(dev)
    mk = lambda d: catalog.all_materials_fixture(width=24, spp=4, max_depth=3, device=d)
    got = grads_of(*mk(dev), 0)
    grads = {**got[1][0], **got[1][1]}
    dead = [n for n in LIVE if not float(grads[n].norm()) > 0.0]
    if dead:
        raise AssertionError(f"all_materials_fixture: families with no gradient: {dead}")
    log("  all_materials_fixture 24 px 4 spp depth 3, gradient norms: "
        + ", ".join(f"{n} {float(grads[n].norm()):.3e}" for n in LIVE))
    grads_close("all_materials_fixture, card vs CPU port", got, grads_of(*mk("cpu"), 0))
    mk = lambda d: catalog.sponza(width=16, spp=2, max_depth=2, device=d)
    grads_close("colonnade 16 px 2 spp depth 2 (vertex gradients), card vs CPU port",
                grads_of(*mk(dev), 6), grads_of(*mk("cpu"), 6))


# ------------------------------------------- phases 4, 5: gradient runs
def grad_path(label, scene, cam, geometry=True, fwd_secs=None):
    """One ``diff.loss_and_grads`` at the camera's spp, its launches counted
    by pass: every count set to 0 just before it, read where the backward
    pass starts and again at the end. Returns (seconds, fwd+bwd camera
    rays/s, (forward-pass launches, backward-pass launches))."""
    target = torch.zeros((cam.height, cam.width, 3), device=scene.device)
    marks = {}
    backward_pass = diff._backward_pass

    def counted(*a, **k):
        torch.cuda.synchronize()
        marks["fwd"] = (time.perf_counter(), profiling.launches())
        return backward_pass(*a, **k)

    diff._backward_pass = counted
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        profiling.reset_counts()
        t0 = time.perf_counter()
        loss, (gs, gc) = diff.loss_and_grads(scene, cam, keys.key(0), target, cam.spp,
                                             geometry=geometry)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        diff._backward_pass = backward_pass
    total = profiling.launches()
    fwd = marks["fwd"][1]
    bwd = {k: total[k] - fwd[k] for k in total}
    bad = [n for n, g in {**gs, **gc}.items() if not bool(torch.isfinite(g).all())]
    if not np.isfinite(float(loss)) or bad:
        raise AssertionError(f"{label}: loss {float(loss)}, non-finite gradients {bad}")
    rays = cam.width * cam.height * cam.spp
    fwd_pass = marks["fwd"][0] - t0
    log(f"  {label}: {secs:.3f} s, {rays / secs / 1e6:.3f} M fwd+bwd camera rays/s, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; forward "
        f"pass {fwd_pass:.3f} s, backward pass {secs - fwd_pass:.3f} s; loss "
        f"{float(loss):.6f}"
        + (f"; (fwd+bwd - fwd) / fwd = {(secs - fwd_secs) / fwd_secs:.3f} against "
           f"the forward render's {fwd_secs:.3f} s" if fwd_secs else ""))
    log(f"  launches: forward pass {fwd}, backward pass {bwd}")
    return secs, rays / secs, (fwd, bwd)


# ----------------------------- phases 4, 5: the opt-in per-ray routes
def psnr(img, ref) -> float:
    """PSNR in dB of ``img`` against ``ref``, both clipped to [0, 1]."""
    mse = float(((img.clamp(0, 1) - ref.clamp(0, 1)) ** 2).mean())
    return float("inf") if mse == 0 else 10.0 * float(np.log10(1.0 / mse))


def hold_mode(label, img, ref, pixels=True) -> dict:
    """An image under a switch against the default route's of the same key:
    means within MODE_MEAN_ATOL and, with ``pixels``, at least
    MODE_PIXEL_SHARE of the pixels within 1e-3 (every channel)."""
    share = float(((img - ref).abs().amax(-1) <= 1e-3).float().mean())
    out = {"mean": float(img.mean()), "ref_mean": float(ref.mean()), "share": share,
           "psnr": psnr(img, ref), "max_abs": max_abs(img, ref)}
    log(f"  {label}: mean {out['mean']:.6f} against the default route's "
        f"{out['ref_mean']:.6f}; pixels within 1e-3 {share:.4f}; PSNR "
        f"{out['psnr']:.2f} dB; max abs diff {out['max_abs']:.3g}")
    if abs(out["mean"] - out["ref_mean"]) > MODE_MEAN_ATOL or (
            pixels and share < MODE_PIXEL_SHARE):
        raise AssertionError(f"{label}: the image is outside the gates (mean within "
                             f"{MODE_MEAN_ATOL}"
                             + (f", >= {MODE_PIXEL_SHARE} of pixels within 1e-3)"
                                if pixels else ")"))
    return out


@contextlib.contextmanager
def plain_sweeps():
    """K7's and K8's plain versions in place of the kernels inside the
    block: the reference of a check on the card (the package itself has no
    such switch)."""
    saved = fsw.sweep_sub, fsw.sweep_q16
    fsw.sweep_sub, fsw.sweep_q16 = fsw.sweep_plain, fsw.sweep_q16_plain
    try:
        yield
    finally:
        fsw.sweep_sub, fsw.sweep_q16 = saved


def grads_near(label, got, ref, max_share=MODE_GRAD_OUTLIERS):
    """Loss within LOSS_RTOL; every gradient family within SCENE_TOL /
    CAMERA_TOL on all but ``max_share`` of its elements (counted)."""
    loss, (gs, gc) = got
    loss_r, (gs_r, gc_r) = ref
    torch.testing.assert_close(float(loss), float(loss_r), rtol=LOSS_RTOL, atol=0)
    out = {}
    for grads, grads_r, tol in ((gs, gs_r, SCENE_TOL), (gc, gc_r, CAMERA_TOL)):
        for name, g in grads.items():
            g, g_r = g.detach().float(), grads_r[name].detach().float()
            bad = (g - g_r).abs() > tol["atol"] + tol["rtol"] * g_r.abs()
            out[name] = (int(bad.sum()), g.numel())
            if not bool(torch.isfinite(g).all()) or bad.sum() > max_share * g.numel():
                raise AssertionError(f"{label}: {name}: {int(bad.sum())} of {g.numel()} "
                                     "elements outside the tolerances")
    log(f"  {label}: loss {float(loss):.6f} / {float(loss_r):.6f}; elements outside the "
        "tolerances: " + (", ".join(f"{k} {n} of {m}" for k, (n, m) in out.items() if n)
                          or "none"))


def mode_walls(label, render, env):
    """The default route and the route under ``env`` timed in turns
    (default, switched, switched, default); returns both lists of walls."""
    walls = {"default": [], "switched": []}
    for which in ("default", "switched", "switched", "default"):
        with switches(env if which == "switched" else {}):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render()
            torch.cuda.synchronize()
            walls[which].append(time.perf_counter() - t0)
    log(f"  {label} walls in turns: default {', '.join(f'{w:.3f}' for w in walls['default'])}"
        f" s, under {env} {', '.join(f'{w:.3f}' for w in walls['switched'])} s")
    return walls


def sphereflake_subtile(sf_scene, sf_cam, dev):
    """Sphereflake's primary rays on the per-ray route under CRT_SUBTILE
    (K3 on 232 sub-tile boxes, K7 at width 32) against the chunk route's
    (K3 + K4; the same sphere test, so equal hit masks and pids) and, with
    it, against the chunk-scan oracle, whose expanded quadratic rounds
    apart at sphereflake's tangent spheres and silhouettes: the sub-tile
    route may differ from the oracle only on the rays the chunk route
    differs on."""
    gen = torch.Generator().manual_seed(6)
    org, dirs, time_, cap = profiling.scene_rays(sf_scene, sf_cam, gen)
    chunks = sf_scene.sphere_chunks
    out = {}
    for mode, env in (("chunk", {}), ("subtile", MODES["subtile"])):
        with switches({"CRT_ACCEL": "ray", **env}):
            profiling.reset_counts()
            perray.reset_phases()
            out[mode] = perray.sphere_closest_perray(org, dirs, time_, chunks, TMIN, cap,
                                                     tabs=sf_scene.sphere_perray)
            torch.cuda.synchronize()
            launches, phases = profiling.launches(), perray.PHASES["phases"]
    t_o, pay_o = ch.sphere_closest(org, dirs, time_, chunks, TMIN, tmax=cap)

    def differs(t, pay):
        hit = torch.isfinite(t)
        return (hit != torch.isfinite(t_o)) | (hit & (pay[-1] != pay_o[-1]))

    (t_c, pay_c), (t_s, pay_s) = out["chunk"], out["subtile"]
    same = torch.equal(torch.isfinite(t_s), torch.isfinite(t_c)) and torch.equal(
        pay_s[-1][torch.isfinite(t_c)], pay_c[-1][torch.isfinite(t_c)])
    d_c, d_s = differs(t_c, pay_c), differs(t_s, pay_s)
    log(f"  sphereflake primary rays under CRT_ACCEL=ray CRT_SUBTILE=1: {org.shape[0]} "
        f"rays, hits {int(torch.isfinite(t_s).sum())}, {phases} phases; hit masks and pids "
        f"{'equal' if same else 'NOT equal'} to the chunk route's; rays whose hit differs "
        f"from the oracle's: sub-tile {int(d_s.sum())}, chunk route {int(d_c.sum())}, "
        f"sub-tile only {int((d_s & ~d_c).sum())}; launches {launches}")
    if not same or bool((d_s & ~d_c).any()):
        raise AssertionError("sphereflake under CRT_SUBTILE: hits differ from the chunk "
                             "route's")
    if launches["visit_sweep_sub"] <= 0 or launches["visit_sweep"]:
        raise AssertionError(f"sphereflake under CRT_SUBTILE launched {launches}")


def colonnade_subtile_hits(scene, cam):
    """The colonnade's primary and secondary rays on the sub-tile route
    against the chunk route (the same triangle test): equal hit masks and
    t; pids equal but where two triangles give the ray the same t (a
    shared edge), which the two routes visit in other orders (counted)."""
    gen = torch.Generator().manual_seed(3)
    org, dirs, cap = colonnade_rays(scene, cam, gen)
    t, _ = perray.planar_closest_perray(org, dirs, scene.tri_chunks, TMIN, True, cap,
                                        tabs=scene.tri_perray)
    for which, (o, d, c) in (("primary", (org, dirs, cap)),
                             ("secondary", colonnade_secondary(scene, org, dirs, t, gen))):
        out = {}
        for mode, env in (("chunk", {}), ("subtile", MODES["subtile"])):
            with switches(env):
                out[mode] = perray.planar_closest_perray(o, d, scene.tri_chunks, TMIN, True,
                                                         c, tabs=scene.tri_perray)
        (t_c, pay_c), (t_s, pay_s) = out["chunk"], out["subtile"]
        hit = torch.isfinite(t_c)
        other = hit & (pay_s[-1] != pay_c[-1])
        log(f"  colonnade {which} rays, sub-tile route against the chunk route: hits "
            f"{int(hit.sum())} of {o.shape[0]}; another winner {int(other.sum())}, each at "
            "the same t")
        if not (torch.equal(torch.isfinite(t_s), hit) and torch.equal(t_s[hit], t_c[hit])):
            raise AssertionError(f"colonnade {which}: the sub-tile route's hits differ")


def phase_modes(dev, col_scene, col_cam, col_img, col_wf_img, sf):
    """The colonnade at its full workload under each opt-in route, scan and
    wavefront, each render's launches counted alone (K3 and the route's
    sweep, K7 or K8, launched; K4 not, the triangle table being the one
    the switch reroutes); images against the default route's; walls in
    turns with the default's; phases per call; then sphereflake's primary
    rays under CRT_SUBTILE, and a colonnade fwd+bwd at COLONNADE_GRAD_SPP
    under each switch against the default route's under deterministic
    algorithms. Returns ({mode: launches of its scan render}, {label:
    walls})."""
    want = {"subtile": "visit_sweep_sub", "q16": "visit_sweep_q16"}
    label = (f"colonnade {COLONNADE_PX}x{COLONNADE_PX} {col_cam.spp}spp depth "
             f"{col_cam.max_depth}")
    counts, walls = {}, {}
    for mode, env in MODES.items():
        with switches(env):
            perray.reset_phases()
            _, _, img, launches = main_path(f"{label} scan under {env}", col_scene, col_cam,
                                            ("planar_closest", "cull_select", want[mode]))
            calls, phases = perray.PHASES["calls"], perray.PHASES["phases"]
            live = perray.PHASES["live"]
            perray.reset_phases()
            wf = wavefront_path(f"{label} wavefront under {env}", col_scene, col_cam,
                                ("planar_closest", "cull_select", want[mode]))
        for name, c in (("scan", launches), ("wavefront", wf[3])):
            if c["visit_sweep"] or c[want[mode]] <= 0:
                raise AssertionError(f"{label} {name} under {env}: launched {c}")
        log(f"  {label} scan under {env}: {calls} per-ray calls, {phases} selection "
            f"phases, {phases / max(calls, 1):.3f} per call; share of rays live by phase: "
            + ", ".join(f"{p + 1}: {n / live[0]:.4f}" for p, n in enumerate(live)))
        exact = mode == "subtile"
        hold_mode(f"{label} scan under {env}", img, col_img, exact)
        hold_mode(f"{label} wavefront under {env}", wf[2], col_wf_img, exact)
        if not exact:
            with switches(env):
                sweep_twin(f"colonnade {COLONNADE_PX}x{COLONNADE_PX} {MODE_TWIN_SPP}spp "
                           f"depth {col_cam.max_depth} scan under {env}", col_scene,
                           col_cam.replace(spp=MODE_TWIN_SPP))
        counts[mode] = launches
        walls[f"scan {mode}"] = mode_walls(
            f"{label} scan", lambda: integrator.render_image(col_scene, col_cam, keys.key(0)),
            env)
        walls[f"wavefront {mode}"] = mode_walls(
            f"{label} wavefront",
            lambda: integrator.render_image_wavefront(col_scene, col_cam, keys.key(0)), env)
    colonnade_subtile_hits(col_scene, col_cam)
    sphereflake_subtile(*sf, dev)
    grad_cam = col_cam.replace(spp=COLONNADE_GRAD_SPP)
    glabel = f"colonnade {COLONNADE_PX}x{COLONNADE_PX} {COLONNADE_GRAD_SPP}spp fwd+bwd"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref = grads_of(col_scene, grad_cam, 0)
        for mode, env in MODES.items():
            with switches(env):
                profiling.reset_counts()
                got = grads_of(col_scene, grad_cam, 0)
                c = profiling.launches()
                twin_cam = col_cam.replace(spp=MODE_TWIN_SPP)
                kernel = grads_of(col_scene, twin_cam, 0)
                with plain_sweeps():
                    twin = grads_of(col_scene, twin_cam, 0)
            if c[want[mode]] <= 0 or c["visit_sweep"]:
                raise AssertionError(f"{glabel} under {env}: launched {c}")
            kid = "K7" if mode == "subtile" else "K8"
            grads_close(f"colonnade {COLONNADE_PX}x{COLONNADE_PX} {MODE_TWIN_SPP}spp "
                        f"fwd+bwd under {env} against the same route on {kid}'s plain "
                        "version", kernel, twin)
            if mode == "subtile":
                grads_near(f"{glabel} under {env} against the default route's", got, ref)
                continue
            log(f"  {glabel} under {env} against the default route's (not gated: the "
                f"quantized surfaces change paths): loss {float(got[0]):.6f} / "
                f"{float(ref[0]):.6f}; max abs err " + ", ".join(
                    f"{k} {max_abs(g, ref[1][0][k]):.2e}" for k, g in got[1][0].items()))
    finally:
        torch.use_deterministic_algorithms(False)
    return counts, walls


def sweep_twin(label, scene, cam):
    """The scan under CRT_SWEEP_Q16 through K8 and through its plain
    version on the card: the images bitwise equal (K8 is its plain
    version's, bit for bit, on every call)."""
    imgs = []
    for plain in (False, True):
        with plain_sweeps() if plain else contextlib.nullcontext():
            profiling.reset_counts()
            imgs.append(integrator.render_image(scene, cam, keys.key(0)))
            c = profiling.launches()
        if (c["visit_sweep_q16"] > 0) == plain:
            raise AssertionError(f"{label}: launches {c} with the plain version {plain}")
    if not torch.equal(imgs[0], imgs[1]):
        raise AssertionError(f"{label}: K8's image differs from its plain version's (max "
                             f"abs diff {max_abs(*imgs):.3g})")
    log(f"  {label}: through K8 and through its plain version bitwise equal")


# ------------------------------------------------------------ phases 3-5
def parity_scene(name, dev):
    width, spp = PARITY[name][:2]
    return catalog.SCENES[name](width=width, spp=spp, device=dev)


def psnr_gate(name, img):
    """The C++ reference parity gate of tests/test_parity.py on ``img``,
    rendered at the scene's parity size with key 0."""
    width, spp, f, min_psnr, max_rel = PARITY[name]
    ref = np.load(f"tests/data/parity_{name}.npz")["ref_ds"].astype(np.float64)
    ours = np.clip(film.linear_to_gamma(img).cpu().numpy(), 0.0, 1.0)
    h, w = (ours.shape[0] // f) * f, (ours.shape[1] // f) * f
    a = ours[:h, :w].reshape(h // f, f, w // f, f, 3).mean(axis=(1, 3))
    if a.shape != ref.shape:
        raise AssertionError(f"{name}: downsampled shape {a.shape} != {ref.shape}")
    psnr = 10.0 * np.log10(1.0 / max(float(np.mean((a - ref) ** 2)), 1e-12))
    rel = abs(ours.mean() - ref.mean()) / ref.mean()
    log(f"  parity {name} {width}px {spp}spp: PSNR {psnr:.3f} dB (gate > {min_psnr}), "
        f"mean rel err {rel:.5f} (gate < {max_rel})")
    if not (psnr > min_psnr and rel < max_rel):
        raise AssertionError(f"{name}: parity gate failed")


def golden(name, dev):
    """The golden workload (16 px, 4 spp, depth 3, key 42) on the card
    against the recorded mean or, for an F1 scene, the port's own CPU
    render; atol 2e-3."""
    def render(device):
        scene, cam = catalog.SCENES[name](width=16, spp=4, max_depth=3, device=device)
        return integrator.render_image(scene, cam, keys.key(42))

    img = render(dev)
    mean = float(img.mean())
    if name in GOLDEN_MEANS:
        want, what = GOLDEN_MEANS[name], "recorded"
    else:
        want, what = float(render("cpu").mean()), "the port on the CPU"
    log(f"  golden {name}: mean {mean:.6f} ({what} {want:.6f}, atol 2e-3)")
    if not (torch.isfinite(img).all() and abs(mean - want) <= 2e-3):
        raise AssertionError(f"{name}: golden mean off")


def estimator_goldens(dev):
    """The golden workload of the Cornell box under camera.qmc and under
    CRT_RNG=threefry, and the 16 px colonnade under camera.qmc (71 chunks:
    through K6), on the card against the port's own CPU render of the same key
    (atol 2e-3)."""
    def render(name, device, stream, qmc):
        scene, cam = catalog.SCENES[name](width=16, spp=4, max_depth=3, device=device)
        with rng_stream(stream):
            return integrator.render_image(scene, cam.replace(qmc=qmc), keys.key(42))

    for name, stream, qmc in (("cornell_box", "fast", True),
                              ("cornell_box", "threefry", False),
                              ("sponza", "fast", True)):
        label = f"{name} 16 px, {'camera.qmc' if qmc else 'CRT_RNG=' + stream}"
        profiling.reset_counts()
        img = render(name, dev, stream, qmc)
        launched = profiling.launches()
        want = float(render(name, "cpu", stream, qmc).mean())
        mean = float(img.mean())
        log(f"  {label}: mean {mean:.6f} (the port on the CPU {want:.6f}, atol 2e-3); "
            f"launches {launched}")
        if not (torch.isfinite(img).all() and abs(mean - want) <= 2e-3):
            raise AssertionError(f"{label}: mean off the CPU render's")
        if name == "sponza" and not launched["packet_planar"] > 0:
            raise AssertionError(f"{label}: K6 was not launched")


def perray_vs_oracle(scene, cam, dev):
    """The per-ray closest hit (K3 + K4) against the chunk-scan oracle on
    the full colonnade, primary and secondary rays."""
    gen = torch.Generator().manual_seed(3)
    org, dirs, cap = colonnade_rays(scene, cam, gen)
    rays = {"primary": (org, dirs, cap)}
    t, _ = perray.planar_closest_perray(org, dirs, scene.tri_chunks, TMIN, True,
                                        cap, tabs=scene.tri_perray)
    rays["secondary"] = colonnade_secondary(scene, org, dirs, t, gen)
    for which, (o, d, c) in rays.items():
        t, pay = perray.planar_closest_perray(o, d, scene.tri_chunks, TMIN, True,
                                              c, tabs=scene.tri_perray)
        t0 = time.perf_counter()
        t_o, pay_o = ch.planar_closest(o, d, scene.tri_chunks, TMIN, True, tmax=c)
        secs = time.perf_counter() - t0
        # The same winner: t within rtol 1e-4 or hit points within 1e-3 (8
        # ulp of 1,200) along the normal: the two formulas round n.c - n.o
        # apart by a few ulp of the coordinates, which a grazing ray divides
        # by a small n.d. A ray whose winners or hit masks differ must have
        # a hit the two triangle tests can round apart: a near-tie (both
        # hit, t as close as above: two surfaces at one depth), a hit within
        # 1e-2 of an edge of its triangle (at +-1,200 the edge coefficients
        # of the columns' sliver triangles, 0.12 units wide, step by
        # ~1e-3), or a hit on the surface the ray leaves, within 5e-3 of
        # its origin along the normal (a secondary ray starts where the
        # primary's t, itself ~1e-3 off, put it).
        hit, hit_o = torch.isfinite(t), torch.isfinite(t_o)

        def marginal(tt, p):
            u, v = p[1], p[2]
            edge = torch.minimum(torch.minimum(u, v), 1.0 - u - v) < 1e-2
            fin = torch.where(torch.isfinite(tt), tt, torch.zeros_like(tt))
            own = (fin * (p[0] * d).sum(-1)).abs() <= 5e-3
            return torch.isfinite(tt) & (edge | own)

        both = hit & hit_o
        same = both & (pay[4] == pay_o[4])
        other = both & ~same
        masks = hit != hit_o
        err = (t - t_o).abs()
        close = both & ((err <= 1e-4 * t_o.abs())
                        | (err * (pay[0] * d).sum(-1).abs() <= 1e-3))
        explained = close | marginal(t, pay) | marginal(t_o, pay_o)
        bad = (same & ~close) | ((other | masks) & ~explained)
        if bool(bad.any()):
            rows = [f"ray {i}: t {float(t[i])} / {float(t_o[i])}, pid "
                    f"{int(pay[4][i])} / {int(pay_o[4][i])}, u v {float(pay[1][i])} "
                    f"{float(pay[2][i])} / {float(pay_o[1][i])} {float(pay_o[2][i])}, "
                    f"n.d {float((pay[0][i] * d[i]).sum())} / "
                    f"{float((pay_o[0][i] * d[i]).sum())}"
                    for i in torch.nonzero(bad)[:8, 0].tolist()]
            raise AssertionError(f"per-ray vs oracle, {which}: {int(bad.sum())} "
                                 "rays disagree:\n  " + "\n  ".join(rows))
        log(f"  per-ray vs oracle, colonnade {which}: rays {o.shape[0]} hits "
            f"{int(hit_o.sum())}; same winner {int(same.sum())}, t max abs err "
            f"{max_abs(t[same], t_o[same]):.3g}, "
            f"{int((same & (err > 1e-4 * t_o.abs())).sum())} outside rtol 1e-4; "
            f"another winner {int(other.sum())} (near-ties "
            f"{int((other & close).sum())}, largest t gap "
            f"{float(err[other].max()) if bool(other.any()) else 0.0:.3g}); hit "
            f"in one only {int(masks.sum())}; oracle {secs:.2f} s")


def full_render(label, scene, cam):
    """Render the whole image once with key 0; returns (seconds, camera
    rays/s, image)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = integrator.render_image(scene, cam, keys.key(0))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if img.shape != (cam.height, cam.width, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{label}: wrong shape or non-finite values")
    rays = cam.width * cam.height * cam.spp
    log(f"  {label}: {secs:.3f} s, {rays / secs / 1e6:.3f} M camera rays/s, "
        f"mean {float(img.mean()):.6f}")
    return secs, rays / secs, img


def main_path(label, scene, cam, names):
    """One main-path render, its kernel launches counted alone: every count
    set to 0 just before it and read just after. Fails unless each kernel
    in ``names`` launched. Returns (seconds, camera rays/s, image,
    launches)."""
    profiling.reset_counts()
    secs, rps, img = full_render(label, scene, cam)
    launches = profiling.launches()
    log(f"  launches in this render: {launches}")
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {label} path")
    return secs, rps, img, launches


def wavefront_path(label, scene, cam, names):
    """One wavefront render at the automatic lane pool, key 0, its kernel
    launches counted alone (as ``main_path``). Returns (seconds, camera
    rays/s, image, launches, loop iterations, selection phases)."""
    profiling.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = integrator.render_image_wavefront(scene, cam, keys.key(0))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = profiling.launches()
    its, phases = integrator.WAVEFRONT["iterations"], perray.PHASES["phases"]
    if img.shape != (cam.height, cam.width, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{label}: wrong shape or non-finite values")
    n_pix = cam.width * cam.height
    rays = n_pix * cam.spp
    log(f"  {label}: {secs:.3f} s, {rays / secs / 1e6:.3f} M camera rays/s, mean "
        f"{float(img.mean()):.6f}; lane pool "
        f"{integrator.wavefront_lanes(scene, n_pix) or n_pix}, {its} loop "
        f"iterations, {phases} selection phases, "
        f"{(its + phases) / max(its, 1):.3f} host synchronisations per iteration")
    log(f"  launches in this render: {launches}")
    for name in names:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the {label} path")
    return secs, rays / secs, img, launches, its, phases


def hold_wavefront(label, img, ref):
    """The wavefront image against the scan's of the same scene and key."""
    err = max_abs(img, ref)
    log(f"  {label}: wavefront against scan, max abs diff {err:.3g} (rtol "
        f"{WAVEFRONT_TOL['rtol']}, atol {WAVEFRONT_TOL['atol']})")
    torch.testing.assert_close(img, ref, **WAVEFRONT_TOL)
    return err


def time_settings(label, cam, runs):
    """Each of ``runs`` (name -> a function rendering ``cam.spp`` samples)
    once to warm up, then twice in alternation, on the host clock ending in
    a synchronize. Prints each wall, camera rays/s and, for wavefront runs,
    loop iterations and synchronisations per iteration; returns name ->
    (walls, image of the last run)."""
    out = {}
    for name, fn in runs.items():
        fn()
    for _ in range(2):
        for name, fn in runs.items():
            profiling.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            walls = out.setdefault(name, ([], None))[0]
            walls.append(secs)
            out[name] = (walls, img)
            its, phases = integrator.WAVEFRONT["iterations"], perray.PHASES["phases"]
            extra = (f", {its} loop iterations, {(its + phases) / its:.3f} host "
                     "synchronisations per iteration" if its else
                     f", {phases} selection phases")
            log(f"  {label}, {name}: {secs:.3f} s, "
                f"{cam.width * cam.height * cam.spp / secs / 1e6:.3f} M camera "
                f"rays/s{extra}")
    best = min(out, key=lambda n: min(out[n][0]))
    log(f"  {label}: fastest {best} ({min(out[best][0]):.3f} s)")
    return out


def phase_estimators(dev):
    """The full renders of the estimator paths, each render's launches
    counted on its own; returns (line of results, K1 and K2 launches of the
    plain and the NEE sphere-light renders)."""
    out = {}
    scene, cam = catalog.cornell_box_with_sphere_light(device=dev)
    label = (f"cornell_box_with_sphere_light {cam.width}x{cam.height} {cam.spp}spp "
             f"depth {cam.max_depth}")
    secs, _, img, plain = main_path(label, scene, cam,
                                    ("planar_closest", "sphere_closest"))
    want = cam.spp * cam.max_depth
    for name in ("planar_closest", "sphere_closest"):
        if plain[name] != want:
            raise AssertionError(f"{label}: {name} launched {plain[name]} times, "
                                 f"want spp x depth = {want}")
    nee_cam = cam.replace(**NEE)
    nee_secs, _, nee_img, nee = main_path(f"{label}, nee, rr_depth {NEE['rr_depth']}",
                                          scene, nee_cam,
                                          ("planar_closest", "sphere_closest"))
    # the scan skips the last bounce's shadow ray on the host
    want_nee = cam.spp * (2 * cam.max_depth - 1)
    for name in ("planar_closest", "sphere_closest"):
        if nee[name] != want_nee:
            raise AssertionError(f"{label} with NEE: {name} launched {nee[name]} "
                                 f"times, want spp x (2 depth - 1) = {want_nee}")
    m, m_nee = float(img.mean()), float(nee_img.mean())
    log(f"  sphere-light means: plain {m:.6f}, NEE + RR {m_nee:.6f}, rel diff "
        f"{abs(m_nee - m) / m:.5f} (gate {NEE_MEAN_RTOL}); walls {secs:.3f} s and "
        f"{nee_secs:.3f} s")
    if not abs(m_nee - m) <= NEE_MEAN_RTOL * m:
        raise AssertionError("the NEE render's mean is off the plain render's")
    out["sphere_light"], out["sphere_light_nee"] = secs, nee_secs
    chk = nee_cam.replace(spp=ESTIMATOR_CHECK_SPP)
    out["wf_err_nee"] = hold_wavefront(
        f"sphere-light NEE + RR {ESTIMATOR_CHECK_SPP}spp",
        integrator.render_image_wavefront(scene, chk, keys.key(0)),
        integrator.render_image(scene, chk, keys.key(0)))

    scene, cam = catalog.cornell_box_with_volume(device=dev)
    label = (f"cornell_box_with_volume {cam.width}x{cam.height} {cam.spp}spp depth "
             f"{cam.max_depth}")
    out["volume"], _, _, vol = main_path(label, scene, cam, ("planar_closest",))
    if vol["planar_closest"] != cam.spp * cam.max_depth:
        raise AssertionError(f"{label}: K1 launched {vol['planar_closest']} times")
    chk = cam.replace(spp=ESTIMATOR_CHECK_SPP)
    out["wf_err_volume"] = hold_wavefront(
        f"volume Cornell {ESTIMATOR_CHECK_SPP}spp",
        integrator.render_image_wavefront(scene, chk, keys.key(0)),
        integrator.render_image(scene, chk, keys.key(0)))

    scene, cam = catalog.perlin_texture_ball(spp=PERLIN_SPP, device=dev)
    walls, ray_walls, per, _ = packet_route(
        f"perlin_texture_ball {cam.width}x{cam.height} {cam.spp}spp (cut from 500) "
        f"depth {cam.max_depth}",
        lambda: integrator.render_image(scene, cam, keys.key(0)), cam, "packet_planar")
    out["perlin"], out["perlin ray"] = walls[0], ray_walls[0]
    if not per["sphere_closest"]:
        raise AssertionError("perlin_texture_ball: K2 (its two spheres) not launched")
    log(f"  launches per render (K1 planar_closest, K2 sphere_closest, K3, K4): "
        f"sphere-light plain {plain}; sphere-light NEE + RR {nee}; volume {vol}; "
        f"perlin_texture_ball {per}")
    return out, plain, nee, per


@contextlib.contextmanager
def plain_versions():
    """Every closest-hit wrapper takes its plain version, on the card (K6's
    wrappers follow ``fused_intersect._on_card`` too)."""
    saved = fi._on_card, fs.cull_select, fsw.sweep
    fi._on_card = lambda x: False
    fs.cull_select, fsw.sweep = fs.cull_select_plain, fsw.sweep_plain
    try:
        yield
    finally:
        fi._on_card, fs.cull_select, fsw.sweep = saved


def volume_grad(dev):
    """``loss_and_grads`` with NEE through cornell_box_with_volume (at
    VOLUME_GRAD): the backward pass launches no closest-hit kernel, and the
    kernel route's gradients equal plain autograd's (the closest hits' plain
    versions in the kernels' place, on the card) under PyTorch's
    deterministic algorithms, at the JAX tolerances."""
    scene, cam = catalog.cornell_box_with_volume(device=dev, **VOLUME_GRAD)
    cam = cam.replace(nee=True)
    label = (f"cornell_box_with_volume {cam.width}x{cam.height} {cam.spp}spp depth "
             f"{cam.max_depth} NEE loss_and_grads")
    secs, _, (fwd, bwd) = grad_path(label, scene, cam)
    want = cam.spp * (2 * cam.max_depth - 1)
    if fwd["planar_closest"] != want or bwd["planar_closest"] != 0:
        raise AssertionError(f"{label}: K1 launched {fwd['planar_closest']} times in "
                             f"the forward pass (want {want}) and "
                             f"{bwd['planar_closest']} in the backward (want 0)")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got = grads_of(scene, cam, 0)
        with plain_versions():
            ref = grads_of(scene, cam, 0)
    finally:
        torch.use_deterministic_algorithms(False)
    grads_close(f"{label}, kernel route vs plain autograd", got, ref)
    return secs


def phase_spectral(dev):
    """The full renders of the spectral, env-light, QMC and threefry paths,
    each render's launches counted on its own, and their gradient runs;
    returns (walls by run, launches by run)."""
    walls, counts = {}, {}

    def exact(label, got, want):
        for name, n in want.items():
            if got[name] != n:
                raise AssertionError(f"{label}: {name} launched {got[name]} times, "
                                     f"want {n}")

    scene, cam = catalog.dispersion_prism(device=dev)
    label = (f"dispersion_prism {cam.width}x{cam.height} {cam.spp}spp depth "
             f"{cam.max_depth}")
    walls["prism"], _, _, counts["prism"] = main_path(
        label, scene, cam, ("planar_closest", "sphere_closest"))
    bounces = cam.spp * cam.max_depth
    exact(label, counts["prism"], {"planar_closest": bounces, "sphere_closest": bounces})
    chk = cam.replace(spp=ESTIMATOR_CHECK_SPP)
    walls["wf_err_prism"] = hold_wavefront(
        f"dispersion_prism {ESTIMATOR_CHECK_SPP}spp",
        integrator.render_image_wavefront(scene, chk, keys.key(0)),
        integrator.render_image(scene, chk, keys.key(0)))

    scene, cam = catalog.sunlit_spheres(device=dev)
    label = (f"sunlit_spheres {cam.width}x{cam.height} {cam.spp}spp depth "
             f"{cam.max_depth}")
    walls["sunlit"], _, img, counts["sunlit"] = main_path(label, scene, cam,
                                                          ("sphere_closest",))
    exact(label, counts["sunlit"], {"planar_closest": 0,
                                    "sphere_closest": cam.spp * cam.max_depth})
    walls["sunlit_nee"], _, nee_img, counts["sunlit_nee"] = main_path(
        f"{label}, nee", scene, cam.replace(nee=True), ("sphere_closest",))
    exact(f"{label}, nee", counts["sunlit_nee"],
          {"planar_closest": 0, "sphere_closest": cam.spp * (2 * cam.max_depth - 1)})
    m, m_nee = float(img.mean()), float(nee_img.mean())
    log(f"  sunlit_spheres means: plain {m:.6f}, NEE {m_nee:.6f}, rel diff "
        f"{abs(m_nee - m) / m:.5f} (gate {NEE_MEAN_RTOL})")
    if not abs(m_nee - m) <= NEE_MEAN_RTOL * m:
        raise AssertionError("sunlit_spheres: the NEE render's mean is off the plain one's")

    scene, cam = catalog.cornell_box(width=512, spp=256, max_depth=8, device=dev)
    imgs = {}
    for run, c, stream in (("qmc", cam.replace(qmc=True), "fast"),
                           ("threefry", cam.replace(spp=THREEFRY_SPP), "threefry")):
        label = (f"cornell_box {c.width}x{c.height} {c.spp}spp depth {c.max_depth}, "
                 + ("camera.qmc" if c.qmc else f"CRT_RNG={stream}"))
        with rng_stream(stream):
            walls[run], _, imgs[run], counts[run] = main_path(label, scene, c,
                                                              ("planar_closest",))
        exact(label, counts[run], {"planar_closest": c.spp * c.max_depth})
    # two streams over the same pixels: near means, different images
    log(f"  cornell_box camera.qmc mean {float(imgs['qmc'].double().mean()):.9f}, "
        f"CRT_RNG=threefry mean {float(imgs['threefry'].double().mean()):.9f}; "
        f"max abs pixel diff {max_abs(imgs['qmc'], imgs['threefry']):.6f}")
    if torch.equal(imgs["qmc"], imgs["threefry"]):
        raise AssertionError("cornell_box: the QMC and threefry images are equal")

    # the gradient runs: the backward pass replays the tape (no closest hit)
    scene, cam = catalog.dispersion_prism(device=dev, **PRISM_GRAD)
    label = (f"dispersion_prism {cam.width}x{cam.height} {cam.spp}spp depth "
             f"{cam.max_depth} loss_and_grads")
    walls["prism_grad"], _, (fwd, bwd) = grad_path(label, scene, cam)
    counts["prism_grad"] = (fwd, bwd)
    bounces = cam.spp * cam.max_depth
    exact(f"{label}, forward pass", fwd, {"planar_closest": bounces,
                                         "sphere_closest": bounces})
    exact(f"{label}, backward pass", bwd, {"planar_closest": 0, "sphere_closest": 0})
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got = grads_of(scene, cam, 0)
        with plain_versions():
            ref = grads_of(scene, cam, 0)
    finally:
        torch.use_deterministic_algorithms(False)
    g = got[1][0]["mat_dispersion"]
    log(f"  {label}: mat_dispersion gradient {g.detach().cpu().tolist()}")
    if not (bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0):
        raise AssertionError(f"{label}: mat_dispersion gradient not finite or zero")
    grads_close(f"{label}, kernel route vs plain autograd", got, ref)

    scene, cam = catalog.cornell_box(device=dev, **QMC_GRAD)
    cam = cam.replace(qmc=True)
    label = (f"cornell_box {cam.width}x{cam.height} {cam.spp}spp depth "
             f"{cam.max_depth} camera.qmc loss_and_grads")
    walls["qmc_grad"], _, (fwd, bwd) = grad_path(label, scene, cam)
    counts["qmc_grad"] = (fwd, bwd)
    exact(f"{label}, forward pass", fwd, {"planar_closest": cam.spp * cam.max_depth})
    exact(f"{label}, backward pass", bwd, {"planar_closest": 0})
    return walls, counts


def device_time(label, scene, cam, names):
    """The summed device time of each kernel in ``names`` in one more render
    of ``scene`` under torch.profiler, its wrapper calls (counted here, not
    on a main path) and the device kernels each call ran; and the render's
    memsets (one per K4 call)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    profiling.reset_counts()
    with torch.profiler.profile(activities=acts) as prof:
        integrator.render_image(scene, cam, keys.key(0))
        torch.cuda.synchronize()
    calls = profiling.launches()
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages() if e.device_type == cuda]
    total = sum(e.self_device_time_total for e in kern) / 1e3
    msg = []
    for name in names:
        hits = [e for e in kern if profiling.KERNELS[name] in e.key]
        ms = sum(e.self_device_time_total for e in hits) / 1e3
        n = sum(e.count for e in hits)
        msg.append(f"{name} {calls[name]} calls, {n} kernels ({n / max(calls[name], 1):.2f} "
                   f"per call: " + ", ".join(
                       f"{profiling.kernel_name(e.key)} {e.count} "
                       f"{e.self_device_time_total / 1e3:.4f} ms" for e in hits)
                   + f") {ms:.4f} ms ({ms / total:.4f} of device time)")
    memsets = sum(e.count for e in kern if "Memset" in e.key)
    log(f"  {label} under the profiler: device time {total:.4f} ms over "
        f"{sum(e.count for e in kern)} kernels and memsets ({memsets} memsets); "
        + "; ".join(msg))


# ---------------------------------- the glTF scenes, adaptive sampling, AOVs
# the stand-in assets this script writes for the glTF scenes (the
# reference's Fox and Sponza are absent, ROADMAP F1): ellipsoids of 24
# segments, 13 rings (576 triangles, the Fox's count: 5 chunks, the per-ray
# route) and 11 rings (480: one dense table, K1's 1-chunk view), and the
# colonnade's 257,916 triangles as Sponza.gltf + .bin
FOX_STANDINS = {"fox576": (24, 13), "fox480": (24, 11)}
# the stand-in Fox's node transform (translation, quaternion, scale)
FOX_NODE = {"mesh": 0, "translation": [0.0, 45.0, 0.0],
            "rotation": [0.0, 0.38268343, 0.0, 0.92387953], "scale": [1.2, 1.0, 1.2]}
# a ray whose hit lies within EDGE_EPS of a triangle edge (barycentric), or
# on the surface it leaves (within OWN_EPS of its origin along the normal:
# a secondary ray starts where the primary's float32 t put it, ~1e-4 off
# the surface at the stand-ins' ~300-unit camera distance), may hit in K1
# and miss in its plain version, or the reverse: counted, not failed
EDGE_EPS = 1e-4
OWN_EPS = 1e-3
# the adaptive render on the Cornell box at 512x512 (depth 8, its main
# path's camera), its samples spent against the uniform 256-spp render's
ADAPTIVE = dict(rel_tol=0.05, min_spp=8, max_spp=256, chunk_spp=8)
# the adaptive image's mean against the uniform render's: both estimate the
# same image, the adaptive one with a stopping bias that min_spp bounds, so
# they agree within Monte-Carlo distance (as NEE_MEAN_RTOL)
ADAPTIVE_MEAN_RTOL = 0.02
AOV_SPP = 16
# textured_fox's gradient run (the 576-triangle stand-in), cut from 600x600,
# 100 spp to this size
FOX_GRAD = dict(width=128, spp=4, max_depth=5)


def write_assets(root: str) -> dict:
    """Write the stand-in assets under ``root`` with ``utils/procgen.py``;
    returns {"fox576", "fox480", "sponza": the directory to point
    $CRT_ASSETS at}. Each Fox has u32 indices, NORMAL, TEXCOORD_0, a node
    transform and a PNG baseColorTexture (the 576's in a data URI, the
    480's in a bufferView)."""
    roots = {}
    for name, (segments, rings) in FOX_STANDINS.items():
        pos, nrm, uv, idx = procgen.ellipsoid_mesh(segments, rings)
        roots[name] = os.path.join(root, name)
        procgen.write_gltf(os.path.join(roots[name], "Fox", "glTF", "Fox.gltf"), pos, idx,
                           nrm, uv, png=procgen.checker_png(),
                           image_in="data" if name == "fox576" else "bufferView",
                           nodes=[FOX_NODE])
    verts = procgen.colonnade_hall(target_tris=catalog.SUBSTITUTE_TRIS)
    roots["sponza"] = os.path.join(root, "sponza")
    procgen.write_gltf(os.path.join(roots["sponza"], "Sponza", "glTF", "Sponza.gltf"),
                       verts.reshape(-1, 3), np.arange(verts.shape[0] * 3))
    log(f"  stand-in assets: Fox {', '.join(f'{n} ({s * 2 * (r - 1)} triangles)' for n, (s, r) in FOX_STANDINS.items())}, "
        f"Sponza.gltf + .bin ({len(verts)} triangles, "
        f"{os.path.getsize(os.path.join(roots['sponza'], 'Sponza', 'glTF', 'Sponza.bin')) / 2**20:.1f} MiB)")
    return roots


@contextlib.contextmanager
def assets(root):
    """Scenes built inside load their glTF from ``root`` ($CRT_ASSETS)."""
    saved = os.environ.get("CRT_ASSETS")
    os.environ["CRT_ASSETS"] = root
    try:
        yield
    finally:
        if saved is None:
            del os.environ["CRT_ASSETS"]
        else:
            os.environ["CRT_ASSETS"] = saved


def attr_compare(label, scene, dirs, out, pid, t_r, pay_r) -> float:
    """K1 with its pid on an attributed mesh against the plain version:
    hit masks equal except on rays whose hit lies within EDGE_EPS of a
    triangle edge or on the surface the ray leaves (OWN_EPS), materials
    equal, pids equal except near-ties (t within rtol 1e-4) and those
    marginal rays, and where the pids agree t within rtol 1e-4 (unless the
    hit is on the surface left) and the raw and interpolated normal and
    (u, v) within atol 1e-3. Returns the largest abs error."""
    hit, hit_r = out[fi.OUT_VALID] > 0.5, torch.isfinite(t_r)
    n_k, u_k, v_k = out[fi.OUT_NX:fi.OUT_NZ + 1].T, out[fi.OUT_U], out[fi.OUT_V]
    n_r, u_r, v_r, mat_r, pid_r = pay_r

    def own(h, t, n):
        return h & ((torch.where(h, t, torch.zeros_like(t)) * vm.dot(n, dirs)).abs()
                    <= OWN_EPS)

    def edge(h, u, v):
        return h & (torch.minimum(torch.minimum(u, v), 1.0 - u - v) < EDGE_EPS)

    own_k, own_r = own(hit, out[fi.OUT_T], n_k), own(hit_r, t_r, n_r)
    mask = hit != hit_r
    explained = own_k | own_r | edge(hit, u_k, v_k) | edge(hit_r, u_r, v_r)
    if bool((mask & ~explained).any()):
        i = int(torch.nonzero(mask & ~explained)[0, 0])
        raise AssertionError(
            f"{label}: hit masks differ in {int((mask & ~explained).sum())} rays away "
            f"from a triangle edge and the surface they leave; e.g. ray {i}: t "
            f"{float(out[fi.OUT_T][i])} / {float(t_r[i])}, u v {float(u_k[i])} "
            f"{float(v_k[i])} / {float(u_r[i])} {float(v_r[i])}")
    both = hit & hit_r
    mat = torch.round(out[fi.OUT_MAT]).to(torch.int32)
    if not torch.equal(mat[both], mat_r[both]):
        raise AssertionError(f"{label}: materials differ")
    differ = both & (pid != pid_r)
    near = differ & ((out[fi.OUT_T] - t_r).abs() <= 1e-4 * t_r.abs())
    if bool((differ & ~(near | explained)).any()):
        raise AssertionError(f"{label}: pid differs in "
                             f"{int((differ & ~(near | explained)).sum())} rays that are "
                             "no near-tie, at no edge and not on the surface left")
    if bool((~hit & (pid != 0)).any()):
        raise AssertionError(f"{label}: pid is not 0 on a miss")
    same = both & (pid == pid_r)
    # a ray that meets the surface it leaves has for t the rounding of its
    # own origin: t is held where the hit is away from the origin
    away = same & ~(own_k | own_r)
    torch.testing.assert_close(out[fi.OUT_T][away], t_r[away], rtol=1e-4, atol=1e-4)

    def shade(n, u, v, p):
        geo = torch.where((vm.dot(dirs, n) < 0.0)[:, None], n, -n)
        return isect.interpolate_tri_attrs(scene.tri_attrs, p, u, v, geo)

    err = {}
    pairs = {"normal": (n_k, n_r), "u": (u_k, u_r), "v": (v_k, v_r)}
    for name, g, r in zip(("smooth normal", "texture u", "texture v"),
                          shade(n_k, u_k, v_k, pid), shade(n_r, u_r, v_r, pid_r)):
        pairs[name] = (g, r)
    for name, (g, r) in pairs.items():
        torch.testing.assert_close(g[same], r[same], rtol=0, atol=1e-3,
                                   msg=lambda m, n=name: f"{label}: {n}: {m}")
        err[name] = max_abs(g[same], r[same])
    log(f"  {label}: rays {pid.shape[0]} hits {int(hit_r.sum())}; masks differ at an "
        f"edge or on the surface left in {int(mask.sum())}; pid differs in "
        f"{int(differ.sum())} (near-ties {int(near.sum())}); hits on the surface left "
        f"{int((same & ~away).sum())}; max abs err {err}")
    return max(err.values())


def phase_gltf_kernels(dev, roots):
    """K1 with its pid on the 480-triangle stand-in's dense view at
    textured_fox's 600x600 primary rays and first secondary rays (its time
    with pid too), and K3 (bit-equal) and K4 (bit for bit, the pid column
    included) at every phase of the per-ray loop on the 576-triangle
    stand-in, primary and secondary rays. Returns errs by kernel."""
    gen = torch.Generator().manual_seed(11)
    errs = {"planar_closest": 0.0, "cull_select": 0.0, "visit_sweep": 0.0}
    with assets(roots["fox480"]):
        scene, cam = catalog.textured_fox(device=dev)
    if scene.tri_chunks is not None or scene.counts[2] != 480 or scene.tri_attrs is None:
        raise AssertionError("the 480-triangle stand-in is not a dense attributed table")
    view, pack = scene.tri_view
    org, dirs, _, _ = profiling.scene_rays(scene, cam, gen)
    rays0 = fi.pack_rays(org, dirs)
    for which in ("primary", "secondary"):
        out, pid = fi.planar_closest_kernel(fi.pack_rays(org, dirs), pack, TMIN,
                                            triangle=True, with_pid=True)
        t_r, pay_r = ch.planar_closest(org, dirs, view, TMIN, True)
        errs["planar_closest"] = max(errs["planar_closest"], attr_compare(
            f"K1 pid, textured_fox 480-triangle stand-in {cam.width}x{cam.height}, {which}",
            scene, dirs, out, pid, t_r, pay_r))
        org, dirs = secondary(org, dirs, t_r, gen)
    R = rays0.shape[1]
    ms = cuda_ms(lambda: fi.planar_closest_kernel(rays0, pack, TMIN, triangle=True,
                                                  with_pid=True))
    plain_ms = cuda_ms(lambda: ch.planar_closest(rays0[0:3].T, rays0[3:6].T, view, TMIN,
                                                 True))
    b_ms, b_by = closest_bound("planar_closest", R, pack, 480)
    log(f"  K1 with pid at textured_fox's primary rays (480 live lanes of "
        f"{view.active.numel()}, {R} rays): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), share {b_ms / ms:.3f}")

    with assets(roots["fox576"]):
        scene, cam = catalog.textured_fox(device=dev)
    if scene.tri_chunks is None or scene.counts[2] != 576:
        raise AssertionError("the 576-triangle stand-in is not chunked")
    tabs = scene.tri_perray
    K = scene.tri_chunks.corner.shape[0]
    V = min(perray.VISIT_BLOCK, K)
    org, dirs, _, cap = profiling.scene_rays(scene, cam, gen)
    for which in ("primary", "secondary"):
        rays = fs.pack_rays(org, dirs, cap)
        excl = fs.first_excl(org.shape[0], dev)
        errs["cull_select"] = max(errs["cull_select"], bits_equal(
            f"K3 packed, textured_fox 576-triangle stand-in ({K} chunks), {which}, phase 1",
            fs.cull_select_kernel(rays, tabs.boxes, excl, V, K, TMIN, True),
            fs.cull_select_plain(rays, tabs.boxes, excl, V, K, TMIN, True)))
        rays4, calls = profiling.sweep_phases(org, dirs, None, cap, tabs, K, TMIN, True,
                                              False)
        for p, (ids, nears, best) in enumerate(calls):
            err = sweep_check(f"K4 triangles with pid, textured_fox 576-triangle stand-in, "
                              f"{which}, phase {p + 1}", rays4, ids, nears, best, tabs.table,
                              True, False)[0]
            errs["visit_sweep"] = max(errs["visit_sweep"], err)
        t, _ = perray.planar_closest_perray(org, dirs, scene.tri_chunks, TMIN, True, cap,
                                            tabs=tabs)
        org, dirs = secondary(org, dirs, t, gen)
        cap = isect._packet_cap(scene, org, dirs, None, INF, TMIN)
    torch.cuda.synchronize()
    return errs


def gltf_goldens(dev, roots, col_scene):
    """The glTF scenes at the golden workload (16 px, 4 spp, depth 3, key
    42) against the port's own CPU render of the same scene and key (atol
    2e-3); the adaptive render at rel_tol=0 bitwise the uniform one on the
    Cornell box at 64x64, 16 spp. Returns the glTF sponza on the card (at
    the colonnade's 200 px) and its load-and-build seconds."""
    for name, root in (("glass_fox", "fox576"), ("textured_fox", "fox576"),
                       ("textured_fox", "fox480"), ("smoke_fox", "fox576")):
        with assets(roots[root]):
            def render(device):
                scene, cam = catalog.SCENES[name](width=16, spp=4, max_depth=3,
                                                  device=device)
                return scene, integrator.render_image(scene, cam, keys.key(42))

            scene, img = render(dev)
            want = float(render("cpu")[1].mean())
        mean = float(img.mean())
        log(f"  golden {name} ({root} stand-in, {scene.counts[2]} triangles, "
            f"{scene.volumes.mesh_v0.shape[0] if scene.volumes.mesh_v0 is not None else 0} "
            f"boundary triangles): mean {mean:.6f} (the port on the CPU {want:.6f}, "
            "atol 2e-3)")
        if not (torch.isfinite(img).all() and abs(mean - want) <= 2e-3):
            raise AssertionError(f"{name} ({root}): golden mean off")
    # sponza from the glTF: built once on the card at 200 px (the main path
    # renders it) and once on the CPU; the golden camera at 16 px
    with assets(roots["sponza"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g_scene, g_cam = catalog.sponza(device=dev)
        torch.cuda.synchronize()
        build_secs = time.perf_counter() - t0
        c_scene, c_cam = catalog.sponza(width=16, spp=4, max_depth=3, device="cpu")
    log(f"  sponza from Sponza.gltf: loaded and built on the card in {build_secs:.2f} s, "
        f"{g_scene.counts[2]} triangles in {g_scene.tri_chunks.corner.shape[0]} chunks")
    if g_scene.counts != col_scene.counts:
        raise AssertionError(f"sponza glTF counts {g_scene.counts} against the "
                             f"colonnade's {col_scene.counts}")
    diff_v = max(max_abs(getattr(g_scene.tri_chunks, f), getattr(col_scene.tri_chunks, f))
                 for f in ("corner", "eu", "ev"))
    log(f"  sponza glTF branch against the procedural branch: chunk tables max abs "
        f"difference {diff_v:.3g}")
    golden_cam = g_cam.replace(width=16, height=16, spp=4, max_depth=3)
    img = integrator.render_image(g_scene, golden_cam, keys.key(42))
    want = float(integrator.render_image(c_scene, c_cam, keys.key(42)).mean())
    mean = float(img.mean())
    log(f"  golden sponza (glTF, {g_scene.counts[2]} triangles): mean {mean:.6f} (the "
        f"port on the CPU {want:.6f}, atol 2e-3)")
    if not (torch.isfinite(img).all() and abs(mean - want) <= 2e-3):
        raise AssertionError("sponza (glTF): golden mean off")
    scene, cam = catalog.cornell_box(width=64, spp=16, max_depth=8, device=dev)
    a = adaptive.render_image_adaptive(scene, cam, keys.key(0), rel_tol=0.0, min_spp=8,
                                       max_spp=16, chunk_spp=8)
    if not torch.equal(a, integrator.render_image(scene, cam, keys.key(0), spp=16)):
        raise AssertionError("adaptive at rel_tol=0 is not bitwise the uniform render")
    log("  adaptive, Cornell 64x64 16 spp, rel_tol=0: bitwise the uniform render")
    return g_scene, g_cam, build_secs


def gltf_path(label, scene, cam, want, refuse=()):
    """``main_path`` of a glTF scene, which must launch each kernel of
    ``want`` and none of ``refuse``."""
    out = main_path(label, scene, cam, want)
    for name in refuse:
        if out[3][name]:
            raise AssertionError(f"{label}: kernel {name} launched {out[3][name]} times")
    return out


def phase_gltf(dev, roots, g_scene, g_cam, build_secs, col_img, cornell, cornell_img):
    """The glTF scenes at their own sizes, the adaptive render, AOVs and
    the denoiser on the Cornell box, and textured_fox's gradients; each
    run's launches counted on its own. Returns (seconds by run, launches by
    run)."""
    secs, counts = {}, {}
    for name, root, want, refuse in (
            ("textured_fox", "fox576", ("packet_planar",),
             ("planar_closest", "cull_select", "visit_sweep")),
            ("textured_fox", "fox480", ("planar_closest",),
             ("cull_select", "visit_sweep", "packet_planar")),
            ("glass_fox", "fox576", ("packet_planar",),
             ("planar_closest", "cull_select", "visit_sweep"))):
        with assets(roots[root]):
            scene, cam = catalog.SCENES[name](device=dev)
        key = f"{name} {root}"
        label = (f"{name} ({root} stand-in) {cam.width}x{cam.height} {cam.spp}spp depth "
                 f"{cam.max_depth}")
        if root == "fox576":   # the packet route, timed against the per-ray route
            # packet_route holds K3 and K4 off the packet route itself
            walls, ray_walls, counts[key], _ = packet_route(
                label, lambda s=scene, c=cam: integrator.render_image(s, c, keys.key(0)),
                cam, want[0], ("planar_closest",))
            secs[key], secs[key + " ray"] = walls[0], ray_walls[0]
            continue
        s, _, _, counts[key] = gltf_path(label, scene, cam, want, refuse)
        secs[key] = s
    s, _, img, counts["sponza glTF"] = gltf_path(
        f"sponza (Sponza.gltf, loaded and built in {build_secs:.2f} s) "
        f"{g_cam.width}x{g_cam.height} {g_cam.spp}spp depth {g_cam.max_depth}",
        g_scene, g_cam, ("planar_closest", "cull_select", "visit_sweep"))
    secs["sponza glTF"] = s
    d = max_abs(img, col_img)
    log(f"  sponza glTF against the procedural colonnade's render (key 0): max abs "
        f"difference {d:.3g}, means {float(img.mean()):.6f} / {float(col_img.mean()):.6f}")
    if abs(float(img.mean()) - float(col_img.mean())) > 2e-3:
        raise AssertionError("sponza glTF: mean off the procedural branch's")

    scene, cam = cornell
    profiling.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, spp_map = adaptive.render_image_adaptive(scene, cam, keys.key(0),
                                                  return_spp_map=True, **ADAPTIVE)
    torch.cuda.synchronize()
    secs["adaptive"] = time.perf_counter() - t0
    counts["adaptive"] = profiling.launches()
    spent = int(spp_map.sum())
    full = ADAPTIVE["max_spp"] * cam.width * cam.height
    log(f"  adaptive Cornell {cam.width}x{cam.height} rel_tol {ADAPTIVE['rel_tol']} spp "
        f"{ADAPTIVE['min_spp']}..{ADAPTIVE['max_spp']} (rounds of {ADAPTIVE['chunk_spp']}): "
        f"{secs['adaptive']:.3f} s, {spent} samples of {full} ({spent / full:.4f}), "
        f"{spent / secs['adaptive'] / 1e6:.3f} M camera rays/s; mean {float(img.mean()):.6f} "
        f"against the uniform 256-spp render's {float(cornell_img.mean()):.6f}; spp per "
        f"pixel min {spp_map.min()} median {int(np.median(spp_map))} max {spp_map.max()}; "
        f"launches {counts['adaptive']}")
    if not bool(torch.isfinite(img).all()) or abs(float(img.mean()) - float(
            cornell_img.mean())) > ADAPTIVE_MEAN_RTOL * float(cornell_img.mean()):
        raise AssertionError("adaptive Cornell: non-finite or mean off the uniform render")
    if counts["adaptive"]["planar_closest"] != cam.max_depth * int(spp_map.max()):
        raise AssertionError("adaptive Cornell: K1 not launched depth x spp rounds times")

    profiling.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bufs = aov.render_aovs(scene, cam, keys.key(0), spp=AOV_SPP)
    torch.cuda.synchronize()
    secs["aovs"] = time.perf_counter() - t0
    counts["aovs"] = profiling.launches()
    t0 = time.perf_counter()
    out = denoise.denoise(cornell_img, bufs)
    torch.cuda.synchronize()
    secs["denoise"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    denoise.denoise(cornell_img, bufs)
    torch.cuda.synchronize()
    secs["denoise again"] = time.perf_counter() - t0
    bad = [k for k, v in bufs.items() if not bool(torch.isfinite(v).all())]
    if bad or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"AOVs or denoise not finite: {bad}")
    if counts["aovs"]["planar_closest"] != AOV_SPP:
        raise AssertionError("render_aovs: K1 not launched once per sample")
    log(f"  render_aovs Cornell {cam.width}x{cam.height} {AOV_SPP}spp: {secs['aovs']:.3f} s, "
        f"coverage {float(bufs['coverage'].mean()):.4f}; launches {counts['aovs']}; "
        f"denoise of the 256-spp image: {secs['denoise']:.3f} s, again "
        f"{secs['denoise again']:.3f} s, mean {float(out.mean()):.6f} against "
        f"{float(cornell_img.mean()):.6f}")

    with assets(roots["fox576"]):
        scene, cam = catalog.textured_fox(device=dev, **FOX_GRAD)
    label = (f"textured_fox (fox576 stand-in) {cam.width}x{cam.height} {cam.spp}spp depth "
             f"{cam.max_depth} loss_and_grads")
    secs["textured_fox grad"], _, counts["textured_fox grad"] = grad_path(label, scene, cam)
    fwd, bwd = counts["textured_fox grad"]
    if not (fwd["packet_planar"] > 0 and bwd["packet_planar"] > 0):
        raise AssertionError(f"{label}: K6 not launched in both passes")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got = grads_of(scene, cam, 0)
        with plain_versions():
            ref = grads_of(scene, cam, 0)
    finally:
        torch.use_deterministic_algorithms(False)
    grads_close(f"{label}, kernel route vs plain autograd", got, ref)
    return secs, counts


# ------------------------------------- phase 7: multi-device renders and grads
# the sharded paths (parallel/mesh.py). The card is one: (a) runs a 1-rank
# NCCL group in this process, so every call goes through NCCL's
# collectives; (b) spawns GLOO_RANKS ranks that share the card over gloo
# (NCCL refuses two ranks on one device). Nothing here is a cross-card
# result.
SHARD_CORNELL = dict(width=512, spp=16, max_depth=8)
SHARD_GRAD = dict(width=128, spp=4, max_depth=8)
SHARD_ADAPTIVE = dict(rel_tol=0.05, min_spp=8, max_spp=32, chunk_spp=8)
SHARD_CKPT_CHUNK = 4
# phase 3's all_materials_fixture check size: its sharded training step
# launches K1 and K2 in every rank
SHARD_MATERIALS = dict(width=24, spp=4, max_depth=3)
GLOO_RANKS = 2
# a collective that a failed rank left waiting errors out after this long;
# the script waits this long for a spawned rank's results
GLOO_TIMEOUT_S = 600
# the sharded training step against the single-device one (the JAX
# package's own sharded-against-single tolerances, tests/test_parallel.py)
SHARD_LOSS_RTOL = 1e-5
SHARD_SCENE_TOL = dict(rtol=2e-4, atol=1e-7)
SHARD_CAMERA_TOL = dict(rtol=2e-4, atol=1e-6)
# the kernels whose launches the sharded runs count
SHARD_KERNELS = ("planar_closest", "sphere_closest", "cull_select", "visit_sweep",
                 "packet_sphere")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sharded_run(label, fn, names, mesh=None):
    """``fn()`` with every launch count set to 0 just before and read just
    after, timed on the host clock (a barrier first when ``mesh`` is
    given, a synchronise at both ends on the card). Fails unless each
    kernel of ``names`` launched (on the card: a CPU run launches none).
    Returns (result, seconds, launches)."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else lambda: None
    if mesh is not None:
        collectives.barrier(mesh)
    profiling.reset_counts()
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    secs = time.perf_counter() - t0
    counts = profiling.launches()
    missing = [n for n in names if counts[n] <= 0 and torch.cuda.is_available()]
    if missing:
        raise AssertionError(f"{label}: kernels {missing} were not launched ({counts})")
    return out, secs, {n: counts[n] for n in SHARD_KERNELS}


def gloo_probe(dev) -> dict:
    """Which collectives gloo takes on card tensors: each is called once on
    a 4-float tensor of the card by every rank (a refusal is raised by
    each rank before it sends anything). The mesh hands gloo card tensors
    (``parallel/collectives.py``): this is the record that it may."""
    calls = {"all_reduce": lambda t: dist.all_reduce(t),
             "all_gather": lambda t: dist.all_gather([torch.empty_like(t)
                                                      for _ in range(GLOO_RANKS)], t),
             "broadcast": lambda t: dist.broadcast(t, 0)}
    found = {}
    for name, call in calls.items():
        try:
            call(torch.ones(4, device=dev))
            found[name] = "takes"
        except (RuntimeError, ValueError) as e:
            found[name] = "refuses: " + str(e).strip().splitlines()[0][:160]
    return found


def gloo_rank(rank: int, store: str, ckpt_path: str, device: str, scenes: dict,
              conn) -> None:
    """One of GLOO_RANKS spawned ranks of phase 7 (b), all on ``device`` (the
    card) in one gloo group at the ``file://`` store: each sharded path
    once on the scenes ``scenes`` names (key -> catalog function, its
    arguments), its launches counted; sends ("ok", results) or ("error",
    traceback)."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        build_ = lambda k: getattr(catalog, scenes[k][0])(device=dev, **scenes[k][1])
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=GLOO_RANKS,
                                timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
        out = {"probe": gloo_probe(dev)}
        mesh = pm.make_mesh(device=dev)
        scene, cam = build_("cornell")
        key = keys.key(0)
        runs = {}

        def run(label, fn, names, warm=True):
            if warm:   # this process's first call of a path loads its kernels
                fn()
            res, secs, counts = sharded_run(label, fn, names, mesh)
            runs[label] = (secs, counts)
            return res

        out["pixel"] = run("cornell pixel-sharded", lambda: pm.render_image_sharded(
            scene, cam, key, mesh), ("planar_closest",)).cpu().numpy()
        out["spp"] = run("cornell spp-sharded", lambda: pm.render_image_spp_sharded(
            scene, cam, key, mesh), ("planar_closest",)).cpu().numpy()
        col_scene, col_cam = build_("colonnade")
        out["colonnade"] = run("colonnade wavefront", lambda: (
            pm.render_image_wavefront_sharded(col_scene, col_cam, key, mesh)),
            ("planar_closest", "cull_select", "visit_sweep")).cpu().numpy()
        del col_scene
        sf_scene, sf_cam = build_("sphereflake")
        out["sphereflake"] = run("sphereflake wavefront", lambda: (
            pm.render_image_wavefront_sharded(sf_scene, sf_cam, key, mesh)),
            ("packet_sphere",)).cpu().numpy()
        img, spp_map = run("cornell adaptive", lambda: adaptive.render_image_adaptive(
            scene, cam, key, mesh=mesh, return_spp_map=True, **SHARD_ADAPTIVE),
            ("planar_closest",), warm=False)
        out["adaptive"] = (img.cpu().numpy(), spp_map)

        class Stop(Exception):
            pass

        done = []

        def stop(msg):
            done.append(msg)
            if sum(m.startswith("[render]") for m in done) == 3:
                raise Stop   # two chunks are in the file

        try:
            checkpoint.render_with_checkpoint(scene, cam, chunk_spp=SHARD_CKPT_CHUNK,
                                              ckpt_path=ckpt_path, log=stop, mesh=mesh)
            raise AssertionError("sharded checkpoint: the render was not stopped")
        except Stop:
            pass
        logs = []
        img = run("cornell checkpoint resumed", lambda: checkpoint.render_with_checkpoint(
            scene, cam, chunk_spp=SHARD_CKPT_CHUNK, ckpt_path=ckpt_path, log=logs.append,
            mesh=mesh), ("planar_closest",), warm=False)
        out["checkpoint"] = (img.cpu().numpy(), [m for m in logs if "resuming" in m])
        am_scene, am_cam = catalog.all_materials_fixture(device=dev, **SHARD_MATERIALS)
        am_target = torch.zeros((am_cam.height, am_cam.width, 3), device=dev)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            loss, (gs, gc) = run("all_materials grad sharded", lambda: (
                pm.render_loss_and_grad_sharded(am_scene, am_cam, key, am_target, mesh)),
                ("planar_closest", "sphere_closest"), warm=False)
        finally:
            torch.use_deterministic_algorithms(False)
        out["grads"] = (float(loss), ({k: v.cpu().numpy() for k, v in gs.items()},
                                      {k: v.cpu().numpy() for k, v in gc.items()}))
        out["runs"] = runs
        log(f"  gloo rank {rank} of {GLOO_RANKS}, in its own process: launches of "
            "K1 planar_closest, K2 sphere_closest, K3 cull_select, K4 visit_sweep, K6 "
            "packet_sphere "
            + "; ".join(f"{k} {v[1]}" for k, v in runs.items()))
        conn.send(("ok", out))
    except Exception:  # noqa: BLE001  (sent to the parent, which fails)
        conn.send(("error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        conn.close()


def hold_sharded(label, got, ref, tol=None):
    """A sharded image against the single-device one: bitwise, or within
    ``tol``. Returns the max abs difference."""
    got, ref = torch.as_tensor(got).cpu(), ref.detach().cpu()
    err = max_abs(got, ref)
    if tol is None and not torch.equal(got, ref):
        raise AssertionError(f"{label}: not bitwise the single-device image "
                             f"(max abs diff {err:.3g})")
    if tol is not None:
        torch.testing.assert_close(got, ref, **tol, msg=lambda m: f"{label}: {m}")
    log(f"  {label}: against the single-device image, max abs diff {err:.3g} "
        f"({'bitwise' if tol is None else tol})")
    return err


def phase_sharded_nccl(dev, col, sf):
    """(a): the sharded paths in a 1-rank NCCL group in this process, each
    against the single-device path: the pixel-sharded, spp-sharded and 2-D
    Cornell SHARD_CORNELL renders (bitwise; the 1x1 mesh's sample sum is
    the single one's), the sharded wavefronts of the colonnade and
    sphereflake against their single-device wavefront images ``col`` and
    ``sf`` (scene, camera, image; CKPT_WF_TOL: the atomic flush), and the
    sharded training step of Cornell SHARD_GRAD against
    ``diff.loss_and_grads`` under deterministic algorithms. Returns (the
    single-device Cornell image, walls, launches by run)."""
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = pm.make_mesh(device=dev)
        mesh2 = pm.make_mesh_2d(device=dev)
        # NCCL sets up a communicator at its first collective: not timed
        _, setup, _ = sharded_run("NCCL set-up", lambda: [
            collectives.all_reduce(torch.zeros(1, device=dev), g)
            for g in (mesh.group, mesh2.samp_group, mesh2.tile_group)], ())
        log(f"  1-rank mesh: backend {dist.get_backend(mesh.group)}, device "
            f"{mesh.device}; 2-D shape {mesh2.shape}; the "
            f"communicators' first all-reduces {setup:.3f} s")
        scene, cam = catalog.cornell_box(device=dev, **SHARD_CORNELL)
        key = keys.key(0)
        walls, counts = {}, {}
        ref, walls["cornell single"], _ = sharded_run(
            "cornell single", lambda: integrator.render_image(scene, cam, key),
            ("planar_closest",))
        for label, fn, tol in (
                ("cornell pixel-sharded", lambda: pm.render_image_sharded(
                    scene, cam, key, mesh), None),
                ("cornell spp-sharded", lambda: pm.render_image_spp_sharded(
                    scene, cam, key, mesh), None),
                ("cornell 2-D", lambda: pm.render_image_sharded_2d(
                    scene, cam, key, mesh2), None)):
            img, walls[label], counts[label] = sharded_run(label, fn, ("planar_closest",))
            hold_sharded(f"NCCL 1 rank, {label} {cam.width}x{cam.height} {cam.spp}spp "
                         f"depth {cam.max_depth}", img, ref, tol)
        for label, (sc_, cm, img_r), names in (
                ("colonnade wavefront", col, ("planar_closest", "cull_select",
                                              "visit_sweep")),
                ("sphereflake wavefront", sf, ("packet_sphere",))):
            img, walls[label], counts[label] = sharded_run(
                label, lambda: pm.render_image_wavefront_sharded(sc_, cm, key, mesh), names)
            hold_sharded(f"NCCL 1 rank, {label} {cm.width}x{cm.height} {cm.spp}spp depth "
                         f"{cm.max_depth}", img, img_r, CKPT_WF_TOL)
        g_scene, g_cam = catalog.cornell_box(device=dev, **SHARD_GRAD)
        target = torch.zeros((g_cam.height, g_cam.width, 3), device=dev)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            got, walls["cornell grad sharded"], counts["cornell grad sharded"] = sharded_run(
                "cornell grad sharded", lambda: pm.render_loss_and_grad_sharded(
                    g_scene, g_cam, key, target, mesh), ("planar_closest",))
            ref_g = diff.loss_and_grads(g_scene, g_cam, key, target, g_cam.spp)
        finally:
            torch.use_deterministic_algorithms(False)
        grads_close(f"NCCL 1 rank, render_loss_and_grad_sharded cornell "
                    f"{g_cam.width}x{g_cam.height} {g_cam.spp}spp depth "
                    f"{g_cam.max_depth} against loss_and_grads", got, ref_g,
                    SHARD_LOSS_RTOL, SHARD_SCENE_TOL, SHARD_CAMERA_TOL)
    finally:
        dist.destroy_process_group()
    log("  NCCL 1-rank walls (s): " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))
    log("  NCCL 1-rank launches: " + "; ".join(f"{k} {v}" for k, v in counts.items()))
    return ref, walls, counts


def phase_sharded_gloo(dev, cornell_ref, col_img, sf_img, scenes):
    """(b): GLOO_RANKS spawned ranks on the one card over gloo run the
    pixel- and spp-sharded Cornell SHARD_CORNELL, the colonnade's and
    sphereflake's sharded wavefronts, the sharded adaptive Cornell
    (SHARD_ADAPTIVE), a sharded checkpoint in chunks of SHARD_CKPT_CHUNK
    stopped after two chunks and resumed, and the sharded training step
    of all_materials_fixture at SHARD_MATERIALS. Every rank's results are
    held here against the single-device ones: pixel-sharded bitwise (a)'s
    image, spp-sharded within atol 1e-5, the wavefronts within
    CKPT_WF_TOL, adaptive bitwise (image and spp map), the resumed
    checkpoint bitwise the uninterrupted single-device run, and the
    training step at the sharded tolerances, under deterministic
    algorithms on both sides, with every family of LIVE nonzero.
    ``scenes``: key -> (catalog function, arguments) of the scenes the
    ranks build ("cornell", "colonnade", "sphereflake"); the Cornell box's
    is this function's too. Returns (walls by rank, launches by rank)."""
    scene, cam = getattr(catalog, scenes["cornell"][0])(device=dev, **scenes["cornell"][1])
    key = keys.key(0)
    (ad_img, ad_map), secs, _ = sharded_run(
        "single-device adaptive", lambda: adaptive.render_image_adaptive(
            scene, cam, key, return_spp_map=True, **SHARD_ADAPTIVE), ())
    log(f"  single-device adaptive Cornell {SHARD_ADAPTIVE}: {secs:.3f} s, "
        f"{ad_map.mean():.2f} spp a pixel")
    ck_img = checkpoint.render_with_checkpoint(scene, cam, chunk_spp=SHARD_CKPT_CHUNK,
                                               log=lambda *_: None)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        am_ref = grads_of(*catalog.all_materials_fixture(device=dev, **SHARD_MATERIALS), 0)
    finally:
        torch.use_deterministic_algorithms(False)
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_gloo_")
    ctx = multiprocessing.get_context("spawn")
    procs, pipes = [], []
    try:
        for r in range(GLOO_RANKS):
            ours, theirs = ctx.Pipe()
            p = ctx.Process(target=gloo_rank, args=(r, os.path.join(work.name, "store"),
                                                    os.path.join(work.name, "c.ckpt"),
                                                    str(dev), scenes, theirs))
            p.start()
            procs.append(p)
            pipes.append(ours)
        outs = []
        for r, c in enumerate(pipes):
            if not c.poll(GLOO_TIMEOUT_S):
                raise AssertionError(f"gloo rank {r} sent nothing in {GLOO_TIMEOUT_S} s")
            status, out = c.recv()
            if status != "ok":
                raise AssertionError(f"gloo rank {r} failed:\n{out}")
            outs.append(out)
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
                p.join()
        work.cleanup()
    walls, counts = {}, {}
    for r, out in enumerate(outs):
        tag = f"gloo {GLOO_RANKS} ranks on one card, rank {r}"
        log(f"  {tag}: collectives on card tensors: {out['probe']}")
        hold_sharded(f"{tag}, cornell pixel-sharded", out["pixel"], cornell_ref)
        hold_sharded(f"{tag}, cornell spp-sharded", out["spp"], cornell_ref,
                     dict(rtol=0, atol=1e-5))
        hold_sharded(f"{tag}, colonnade wavefront", out["colonnade"], col_img, CKPT_WF_TOL)
        hold_sharded(f"{tag}, sphereflake wavefront", out["sphereflake"], sf_img,
                     CKPT_WF_TOL)
        hold_sharded(f"{tag}, cornell adaptive", out["adaptive"][0], ad_img)
        if not np.array_equal(out["adaptive"][1], ad_map):
            raise AssertionError(f"{tag}: the adaptive spp map is not the single one's")
        img, resumed = out["checkpoint"]
        if not resumed:
            raise AssertionError(f"{tag}: the sharded checkpoint did not resume")
        hold_sharded(f"{tag}, cornell checkpoint stopped after two chunks and resumed "
                     f"({resumed[0]})", img, ck_img)
        loss, families = out["grads"]
        got = (loss, tuple({k: torch.from_numpy(v) for k, v in f.items()}
                           for f in families))
        grads_close(f"{tag}, render_loss_and_grad_sharded all_materials_fixture "
                    f"{SHARD_MATERIALS} against loss_and_grads", got, am_ref,
                    SHARD_LOSS_RTOL, SHARD_SCENE_TOL, SHARD_CAMERA_TOL)
        grads = {**got[1][0], **got[1][1]}
        dead = [n for n in LIVE if not float(grads[n].norm()) > 0.0]
        if dead:
            raise AssertionError(f"{tag}: all_materials_fixture families with no "
                                 f"gradient: {dead}")
        walls[r] = {k: v[0] for k, v in out["runs"].items()}
        counts[r] = {k: v[1] for k, v in out["runs"].items()}
        log(f"  {tag}: walls (s) " + ", ".join(f"{k} {v:.3f}" for k, v in walls[r].items()))
        log(f"  {tag}: launches " + "; ".join(f"{k} {v}" for k, v in counts[r].items()))
    return walls, counts


def cli_run():
    """(c): the port's CLI once on the card, in its own process."""
    out_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_cli_")
    out = os.path.join(out_dir.name, "x.png")
    cmd = [sys.executable, "-m", "cpu_ray_tracing_implementation_tpu_torch.cli",
           "cornell_box", "--width", "128", "--spp", "8", "-o", out]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.getsize(out):
        raise AssertionError(f"cli: exit {proc.returncode}\n{proc.stdout}\n{proc.stderr}")
    done = [ln for ln in proc.stdout.splitlines() if ln.startswith("Done")]
    log(f"  cli {' '.join(cmd[3:-2])}: exit 0 in {secs:.2f} s of process; {done[0]}")
    out_dir.cleanup()
    return secs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    phase_log("phase 1: build kernels")
    t0 = time.perf_counter()
    build.load()
    log(f"  built {build.library_path().name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.last_build['seconds']:.2f} s, cached {build.last_build['cached']}; "
        "per source " + ", ".join(f"{name} {sec:.2f} s" for name, sec in
                                  build.last_build["sources"].items()) + ")")
    for line in build.last_build["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  " + line.strip())

    phase_log("phase 2: kernels against their plain versions")
    asset_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_assets_")
    roots = write_assets(asset_dir.name)
    errs, times, bounds = phase_kernels(dev)
    t0 = time.perf_counter()
    col_scene, col_cam = catalog.sponza(device=dev)
    log(f"  colonnade {COLONNADE_PX} px built in {time.perf_counter() - t0:.2f} s: "
        f"{col_scene.counts[2]} triangles in {col_scene.tri_chunks.corner.shape[0]} "
        f"chunks, {col_scene.counts[1]} light quad")
    e, t, b = phase_select_sweep(col_scene, col_cam, dev)
    errs["planar_closest"] = max(errs["planar_closest"], e.pop("planar_closest_light"))
    errs.update(e)
    times.update(t)
    bounds.update(b)
    e, t, b = phase_modes_kernels(col_scene, col_cam, dev)
    errs["cull_select"] = max(errs["cull_select"], e.pop("cull_select"))
    errs.update(e)
    times.update(t)
    bounds.update(b)
    t0 = time.perf_counter()
    sf_scene, sf_cam = catalog.sphereflake(device=dev)
    log(f"  sphereflake {sf_cam.width} px built in {time.perf_counter() - t0:.2f} s: "
        f"{sf_scene.counts[0]} spheres in {sf_scene.sphere_chunks.rad.shape[0]} chunks")
    e, sf_k4_times, sf_k4_bound = phase_sphereflake(sf_scene, sf_cam, dev)
    for name, err in e.items():
        errs[name] = max(errs[name], err)
    phase_pid(dev)
    for name, err in phase_estimator_kernels(dev).items():
        errs[name] = max(errs[name], err)
    for name, err in phase_spectral_kernels(dev).items():
        errs[name] = max(errs[name], err)
    for name, err in phase_gltf_kernels(dev, roots).items():
        errs[name] = max(errs[name], err)
    e, t, b = phase_packet(dev, sf_scene, sf_cam, roots)
    errs.update(e)
    times.update(t)
    bounds.update(b)
    probes = phase_gather(dev)
    r = probes[0]
    errs["gather_sum"] = r["max_abs_err"]
    times["gather_sum"] = (r["ms"], r["plain_ms"])
    bounds["gather_sum"] = (r["bound_ms"], r["bound_by"])
    errs["scatter"], times["scatter"], bounds["scatter"] = phase_scatter(dev)

    phase_log("phase 3: checks (their launches are not counted)")
    for name in (*GOLDEN_MEANS, *F1_SCENES):
        golden(name, dev)
    psnr_gate("cornell_box", full_render("cornell_box parity size",
                                         *parity_scene("cornell_box", dev))[2])
    estimator_goldens(dev)
    g_scene, g_cam, g_build_secs = gltf_goldens(dev, roots, col_scene)
    perray_vs_oracle(col_scene, col_cam, dev)
    phase_grad_checks(dev)

    phase_log("phase 4, 5: main paths, each render's launches counted on its own")
    scene, cam = catalog.cornell_box(width=512, spp=256, max_depth=8, device=dev)
    cornell_secs, cornell_rps, cornell_img, launches_cornell = main_path(
        "cornell_box 512x512 256spp depth 8", scene, cam, ("planar_closest", "scatter"))
    _, _, _, launches_scan = main_path(
        "cornell_box 600x600 40spp depth 4 (the scan cell)",
        *catalog.cornell_box(**SCAN_CELL, device=dev), ("planar_closest", "scatter"))
    for label, c, want in (("cornell_box 512x512", launches_cornell, cam.spp * cam.max_depth),
                           ("the scan cell", launches_scan,
                            SCAN_CELL["spp"] * SCAN_CELL["max_depth"])):
        if c["scatter"] != want:
            raise AssertionError(f"{label}: K9 launched {c['scatter']} times, want spp x "
                                 f"depth = {want}")
    # the slice-1 path's sphere scene at its parity size, which the gate reads
    _, _, img, launches_ball = main_path(
        "three_material_ball 320px 16spp depth 5",
        *parity_scene("three_material_ball", dev), ("sphere_closest",))
    psnr_gate("three_material_ball", img)
    perray.reset_phases()
    col_secs, col_rps, col_img, launches_col = main_path(
        f"colonnade {COLONNADE_PX}x{COLONNADE_PX} {col_cam.spp}spp depth "
        f"{col_cam.max_depth}", col_scene, col_cam,
        ("planar_closest", "cull_select", "visit_sweep"))
    calls, phases = perray.PHASES["calls"], perray.PHASES["phases"]
    live = perray.PHASES["live"]
    log(f"  colonnade render: {calls} per-ray closest-hit calls (bounces), "
        f"{phases} selection phases, {phases / max(calls, 1):.3f} per bounce; share "
        "of rays still live by phase: " + ", ".join(
            f"{p + 1}: {n / live[0]:.4f}" for p, n in enumerate(live)))
    # K2 where it does real work: 337 spheres, 921,600 rays a bounce
    mb_scene, mb_cam = catalog.random_motion_ball(device=dev)
    mb_label = (f"random_motion_ball {mb_cam.width}x{mb_cam.height} {mb_cam.spp}spp "
                f"depth {mb_cam.max_depth}")
    mb_secs, mb_rps, _, launches_mb = main_path(mb_label, mb_scene, mb_cam,
                                                ("sphere_closest",))
    want = mb_cam.spp * mb_cam.max_depth
    if launches_mb["sphere_closest"] != want:
        raise AssertionError(f"{mb_label}: K2 launched {launches_mb['sphere_closest']} "
                             f"times, want spp x depth = {want}")

    phase_log("phase 4, 5: the path-regeneration wavefront, each render's "
              "launches counted on its own")
    col_wf = wavefront_path(
        f"colonnade wavefront {COLONNADE_PX}x{COLONNADE_PX} {col_cam.spp}spp depth "
        f"{col_cam.max_depth}", col_scene, col_cam,
        ("planar_closest", "cull_select", "visit_sweep"))
    wf_err = {"colonnade": hold_wavefront("colonnade", col_wf[2], col_img)}
    sf_label = (f"sphereflake {sf_cam.width}x{sf_cam.height} {sf_cam.spp}spp depth "
                f"{sf_cam.max_depth}")
    sf_wf = wavefront_path(f"{sf_label} wavefront", sf_scene, sf_cam, ("packet_sphere",))
    sf_check = sf_cam.replace(spp=SPHEREFLAKE_CHECK_SPP)
    wf_err["sphereflake"] = hold_wavefront(
        f"sphereflake {SPHEREFLAKE_CHECK_SPP}spp",
        integrator.render_image_wavefront(sf_scene, sf_check, keys.key(0)),
        integrator.render_image(sf_scene, sf_check, keys.key(0)))
    log(f"  wavefront launches per render (K1 planar_closest, K3 cull_select, K4 "
        f"visit_sweep, K6 packet_*): colonnade {col_wf[3]}, sphereflake {sf_wf[3]}")

    phase_log("phase 4, 5: the packet route (K6) against the per-ray route (K3 + "
              "K4), each render's launches counted on its own")
    sf_walls = {}
    sf_walls["wavefront"], sf_walls["wavefront ray"], _, _ = packet_route(
        f"{sf_label} wavefront",
        lambda: integrator.render_image_wavefront(sf_scene, sf_cam, keys.key(0)), sf_cam,
        "packet_sphere")
    sf_walls["scan"], sf_walls["scan ray"], _, _ = packet_route(
        f"{sf_label} scan", lambda: integrator.render_image(sf_scene, sf_cam, keys.key(0)),
        sf_cam, "packet_sphere")
    with accel("ray"):
        sf_ray = wavefront_path(f"{sf_label} wavefront, CRT_ACCEL=ray", sf_scene, sf_cam,
                                ("cull_select", "visit_sweep"))
    bvh_oracle(dev)
    ckpt_secs = checkpoint_runs(dev, sf_scene, sf_cam)

    phase_log("phase 4, 5: next-event estimation, Russian roulette, volumes and "
              "the perlin marble, each render's launches counted on its own")
    est, launches_sl, launches_nee, launches_perlin = phase_estimators(dev)

    phase_log("phase 4, 5: spectral dispersion, the importance-sampled sky, "
              "Owen-Sobol QMC and the threefry stream, each run's launches "
              "counted on its own")
    spec, spec_counts = phase_spectral(dev)

    phase_log("phase 4, 5: the glTF scenes, adaptive sampling, AOVs and the denoiser, "
              "each run's launches counted on its own")
    gl, gl_counts = phase_gltf(dev, roots, g_scene, g_cam, g_build_secs, col_img,
                               (scene, cam), cornell_img)
    del g_scene

    # the per-ray route's pool and batch sizes (sphereflake, now packet
    # routed and so whole-frame as in the JAX package, is cut from this
    # phase: its walls against the per-ray route are the packet phase's)
    phase_log("phase 4: pool and batch sizes timed on the card")
    n_pix = col_cam.width * col_cam.height
    pool_cam = col_cam.replace(spp=POOL_SPP)
    auto = integrator.wavefront_lanes(col_scene, n_pix)
    runs = {f"wavefront, pool {auto or n_pix} (automatic)": lambda: (
                integrator.render_wavefront(col_scene, pool_cam, keys.key(0), POOL_SPP,
                                            lanes=auto)),
            f"wavefront, pool {n_pix} (L)": lambda: (
                integrator.render_wavefront(col_scene, pool_cam, keys.key(0), POOL_SPP))}
    if auto is None:
        runs = {f"wavefront, pool {n_pix} (L, automatic)":
                    runs[f"wavefront, pool {n_pix} (L)"],
                "wavefront, pool 8192": lambda: (
                    integrator.render_wavefront(col_scene, pool_cam, keys.key(0),
                                                POOL_SPP, lanes=8192))}
    time_settings("colonnade", pool_cam, runs)
    scan_runs = {
        f"batch {SCAN_TILE}": lambda: integrator.accumulate_samples(
            col_scene, pool_cam, keys.key(0), 0, POOL_SPP, batch_pixels=SCAN_TILE),
        "whole frame": lambda: integrator.accumulate_samples(
            col_scene, pool_cam, keys.key(0), 0, POOL_SPP)}
    scan_walls = time_settings("colonnade scan", pool_cam, scan_runs)
    imgs = [v[1] for v in scan_walls.values()]
    if not torch.equal(imgs[0], imgs[1]):
        raise AssertionError("colonnade scan: the batched image is not bitwise the "
                             f"unbatched one (max abs diff {max_abs(*imgs):.3g})")
    log(f"  colonnade scan: batch {SCAN_TILE} and whole frame bitwise equal; the "
        f"render's automatic batch is {integrator.scan_batch_pixels(col_scene)}")

    phase_log("phase 4, 5: the gradient path, each run's launches counted by pass")
    grad_secs = {}
    for geometry in (False, True):
        label = (f"cornell_box 512x512 256spp depth 8 loss_and_grads, geometry="
                 f"{geometry}")
        grad_secs[geometry], _, (fwd, bwd) = grad_path(label, scene, cam, geometry,
                                                       fwd_secs=cornell_secs)
        want = cam.spp * cam.max_depth
        for kid, name in (("K1", "planar_closest"), ("K9", "scatter")):
            if fwd[name] != want or bwd[name] != 0:
                raise AssertionError(f"{label}: {kid} launched {fwd[name]} times in the "
                                     f"forward pass (want {want}) and {bwd[name]} in the "
                                     "backward (want 0)")
    col_grad_cam = col_cam.replace(spp=COLONNADE_GRAD_SPP)
    perray.reset_phases()
    col_grad_secs, col_grad_rps, (fwd, bwd) = grad_path(
        f"colonnade {COLONNADE_PX}x{COLONNADE_PX} {COLONNADE_GRAD_SPP}spp depth "
        f"{col_cam.max_depth} loss_and_grads", col_scene, col_grad_cam)
    log("  colonnade gradient: chunked tables are not taped; the backward pass runs "
        f"the per-ray accelerator again (K3 {fwd['cull_select']} + "
        f"{bwd['cull_select']}, K4 {fwd['visit_sweep']} + {bwd['visit_sweep']} "
        "launches in the forward + backward pass)")
    for name in ("planar_closest", "cull_select", "visit_sweep"):
        if not (fwd[name] > 0 and bwd[name] > 0):
            raise AssertionError(f"colonnade gradient: kernel {name} was not "
                                 "launched in both passes")
    vol_grad_secs = volume_grad(dev)

    phase_log("phase 4, 5: the opt-in per-ray routes (CRT_SUBTILE: K3 + K7; "
              "CRT_SWEEP_Q16: K3 + K8), each run's launches counted on its own")
    mode_counts, mode_walls_ = phase_modes(dev, col_scene, col_cam, col_img, col_wf[2],
                                           (sf_scene, sf_cam))

    phase_log("phase 7: multi-device renders and gradients (torch.distributed) on the "
              "one card, each run's launches counted on its own; then the CLI")
    shard_ref, nccl_walls, nccl_counts = phase_sharded_nccl(
        dev, (col_scene, col_cam, col_wf[2]), (sf_scene, sf_cam, sf_wf[2]))
    gloo_walls, gloo_counts = phase_sharded_gloo(
        dev, shard_ref, col_wf[2], sf_wf[2], {"cornell": ("cornell_box", SHARD_CORNELL),
                                              "colonnade": ("sponza", {}),
                                              "sphereflake": ("sphereflake", {})})
    del shard_ref
    cli_secs = cli_run()
    # K5 lies on no path: its launches are those of one probe call
    profiling.reset_counts()
    R, K, V, rowf = gather_probe.DEFAULTS
    gen = torch.Generator(device=dev).manual_seed(0)
    gather_probe.gather_sum(torch.randint(0, K, (R, V), generator=gen, device=dev,
                                          dtype=torch.int32),
                            torch.randn((K, rowf), generator=gen, device=dev))
    launches_probe = profiling.launches()
    log(f"  launches in one gather-probe call: {launches_probe}")
    phase_log("phase 4: the profiled renders (last of the timed work)")
    # last of the timed work: the profiler may leave per-launch costs behind
    device_time("colonnade render", col_scene, col_cam, ("cull_select", "visit_sweep"))
    device_time(f"sphereflake {SPHEREFLAKE_CHECK_SPP}spp scan render", sf_scene, sf_check,
                ("packet_sphere",))
    device_time(f"random_motion_ball {MOTION_BALL_PROFILED_SPP}spp render", mb_scene,
                mb_cam.replace(spp=MOTION_BALL_PROFILED_SPP), ("sphere_closest",))
    # each kernel's launches in the render of its own slice's scene (K2's:
    # random_motion_ball, where it does real work)
    log(f"  K2 at three_material_ball: {launches_ball['sphere_closest']} launches in "
        f"its render; kernel {times['sphere_closest_tmb'][0]:.4f} ms, plain "
        f"{times['sphere_closest_tmb'][1]:.4f} ms, bound "
        f"{bounds['sphere_closest_tmb'][0]:.4f} ms ({bounds['sphere_closest_tmb'][1]})")
    launches = {"planar_closest": launches_cornell["planar_closest"],
                "sphere_closest": launches_mb["sphere_closest"],
                "cull_select": launches_col["cull_select"],
                "visit_sweep": launches_col["visit_sweep"],
                "gather_sum": launches_probe["gather_sum"],
                "packet_planar": launches_perlin["packet_planar"],
                "packet_sphere": sf_wf[3]["packet_sphere"],
                "visit_sweep_sub": mode_counts["subtile"]["visit_sweep_sub"],
                "visit_sweep_q16": mode_counts["q16"]["visit_sweep_q16"],
                "scatter": launches_scan["scatter"]}
    library_ms = {"gather_sum": r["library_ms"]}
    log(f"  K4 spheres at sphereflake (its wavefront under CRT_ACCEL=ray): "
        f"{sf_ray[3]['visit_sweep']} launches in that render; kernel "
        f"{sf_k4_times[0]:.4f} ms, plain {sf_k4_times[1]:.4f} ms, bound "
        f"{sf_k4_bound[0]:.4f} ms ({sf_k4_bound[1]})")
    log(f"  K3 at the colonnade's sub-tile boxes (CS {SUBTILE_TIMED}), phase 1: kernel "
        f"{times['cull_select_subtile'][0]:.4f} ms, plain "
        f"{times['cull_select_subtile'][1]:.4f} ms, bound "
        f"{bounds['cull_select_subtile'][0]:.4f} ms ({bounds['cull_select_subtile'][1]}); "
        f"{mode_counts['subtile']['cull_select']} launches in the colonnade scan under "
        f"CRT_SUBTILE, {mode_counts['q16']['cull_select']} under CRT_SWEEP_Q16")
    log("  K7 at the colonnade's sub-tile widths, phase 1: " + "; ".join(
        f"CS {CS}: kernel {times[f'visit_sweep_sub_cs{CS}'][0]:.4f} ms, plain "
        f"{times[f'visit_sweep_sub_cs{CS}'][1]:.4f} ms, bound "
        f"{bounds[f'visit_sweep_sub_cs{CS}'][0]:.4f} ms "
        f"({bounds[f'visit_sweep_sub_cs{CS}'][1]})" for CS in SUB_WIDTHS_CHECKED))
    log(f"  K8 at the colonnade's phase 1: kernel {times['visit_sweep_q16'][0]:.4f} ms, "
        f"cull bound {bounds['visit_sweep_q16'][0]:.4f} ms ({bounds['visit_sweep_q16'][1]}), "
        f"row bound {bounds['visit_sweep_q16_row'][0]:.4f} ms")
    log("  K4 triangles at the colonnade's later phases: " + "; ".join(
        f"{k.replace('visit_sweep_', '')}: kernel {v[0]:.4f} ms, plain {v[1]:.4f} ms, "
        f"bound {bounds[k][0]:.4f} ms ({bounds[k][1]})"
        for k, v in times.items() if k.startswith("visit_sweep_phase")))

    log(f"  NEE launches: cornell_box_with_sphere_light {launches_sl['planar_closest']} "
        f"K1 / {launches_sl['sphere_closest']} K2 plain, "
        f"{launches_nee['planar_closest']} K1 / {launches_nee['sphere_closest']} K2 "
        f"with NEE + RR (spp x (2 depth - 1): the last bounce's shadow ray is "
        f"skipped on the host)")
    k12 = lambda c: f"{c['planar_closest']} K1 / {c['sphere_closest']} K2"
    log(f"  spectral, QMC and threefry launches: dispersion_prism scan "
        f"{k12(spec_counts['prism'])}; sunlit_spheres {k12(spec_counts['sunlit'])} "
        f"plain, {k12(spec_counts['sunlit_nee'])} with NEE; Cornell camera.qmc "
        f"{k12(spec_counts['qmc'])}; Cornell threefry {k12(spec_counts['threefry'])}; "
        f"dispersion_prism loss_and_grads {k12(spec_counts['prism_grad'][0])} forward, "
        f"{k12(spec_counts['prism_grad'][1])} backward; Cornell camera.qmc "
        f"loss_and_grads {k12(spec_counts['qmc_grad'][0])} forward, "
        f"{k12(spec_counts['qmc_grad'][1])} backward")
    k134 = lambda c: (f"{c['planar_closest']} K1 / {c['cull_select']} K3 / "
                      f"{c['visit_sweep']} K4 / {c['packet_planar']} K6")
    log("  glTF, adaptive and AOV launches: " + "; ".join(
        f"{k} {k134(c)}" for k, c in gl_counts.items() if k != "textured_fox grad")
        + f"; textured_fox loss_and_grads {k134(gl_counts['textured_fox grad'][0])} "
        f"forward, {k134(gl_counts['textured_fox grad'][1])} backward")
    kernels = []
    for name, (kid, source, replaces) in KERNELS.items():
        ms, plain_ms = times[name][:2]
        bound_ms, bound_by = bounds[name]
        # K6's plain per-tile loop is timed on the tiles it is checked on
        plain_on = (f"every {PACKET_PLAIN_STRIDE}th tile" if name.startswith("packet_")
                    else "the whole call")
        log(f"  {kid} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (on "
            f"{plain_on}), bound {bound_ms:.4f} ms ({bound_by})"
            + (f", with the wrapper's packing {times[name][2]:.4f} ms"
               if len(times[name]) > 2 else ""))
        # the sharded runs' launches, summed over each rank's runs of phase 7
        sharded = {"nccl_1_rank": sum(c.get(name, 0) for c in nccl_counts.values()),
                   **{f"gloo_rank{r}": sum(c.get(name, 0) for c in runs.values())
                      for r, runs in gloo_counts.items()}}
        kernels.append({"name": f"{kid} {name}", "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                        "plain_ms_on": plain_on,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms.get(name), "sharded_launches": sharded,
                        # K8: its bound before its cull too (every primitive
                        # of each sequentially visited row)
                        **({"row_bound_ms": bounds["visit_sweep_q16_row"][0]}
                           if name == "visit_sweep_q16" else {})})
    n_cornell = cam.width * cam.height * cam.spp
    log(f"full workloads: cornell_box {cornell_secs:.3f} s, {cornell_rps:.1f} camera "
        f"rays/s; colonnade {col_secs:.3f} s, {col_rps:.1f} camera rays/s; "
        f"random_motion_ball {mb_secs:.3f} s, {mb_rps:.1f} camera rays/s; cornell_box "
        f"fwd+bwd {grad_secs[False]:.3f} s ({n_cornell / grad_secs[False]:.1f} camera "
        f"rays/s), with geometry {grad_secs[True]:.3f} s ({n_cornell / grad_secs[True]:.1f}"
        f"); colonnade fwd+bwd {col_grad_secs:.3f} s ({col_grad_rps:.1f} camera rays/s); "
        f"colonnade wavefront {col_wf[0]:.3f} s ({col_wf[1]:.1f} camera rays/s); "
        f"sphereflake wavefront {sf_wf[0]:.3f} s ({sf_wf[1]:.1f} camera rays/s); "
        f"packet route against the per-ray route (first timed run each): sphereflake "
        f"wavefront {sf_walls['wavefront'][0]:.3f} / {sf_walls['wavefront ray'][0]:.3f} s, "
        f"scan {sf_walls['scan'][0]:.3f} / {sf_walls['scan ray'][0]:.3f} s, "
        f"perlin_texture_ball {est['perlin']:.3f} / {est['perlin ray']:.3f} s; "
        f"render_with_checkpoint " + ", ".join(f"{k} {v:.3f} s" for k, v in ckpt_secs.items())
        + "; "
        f"wavefront against scan max abs diff {wf_err}; "
        f"sphere-light {est['sphere_light']:.3f} s, with NEE + RR "
        f"{est['sphere_light_nee']:.3f} s; volume Cornell {est['volume']:.3f} s; "
        f"perlin_texture_ball ({PERLIN_SPP} spp) {est['perlin']:.3f} s; NEE volume "
        f"fwd+bwd {vol_grad_secs:.3f} s; dispersion_prism {spec['prism']:.3f} s "
        f"(wavefront against scan {spec['wf_err_prism']:.3g}); sunlit_spheres "
        f"{spec['sunlit']:.3f} s, with NEE {spec['sunlit_nee']:.3f} s; Cornell "
        f"camera.qmc {spec['qmc']:.3f} s, CRT_RNG=threefry ({THREEFRY_SPP} spp) "
        f"{spec['threefry']:.3f} s; dispersion_prism fwd+bwd {spec['prism_grad']:.3f} s; "
        f"Cornell camera.qmc fwd+bwd {spec['qmc_grad']:.3f} s; "
        + "; ".join(f"{k} {v:.3f} s" for k, v in gl.items()) + "; "
        f"fwd+bwd against the render, per camera ray: cornell_box "
        f"{grad_secs[False] / cornell_secs:.3f}, with geometry "
        f"{grad_secs[True] / cornell_secs:.3f}, colonnade {col_rps / col_grad_rps:.3f}; "
        + "opt-in per-ray routes (colonnade, default / switched walls in turns): "
        + "; ".join(f"{k} {', '.join(f'{w:.3f}' for w in v['default'])} / "
                    f"{', '.join(f'{w:.3f}' for w in v['switched'])} s"
                    for k, v in mode_walls_.items()) + "; "
        f"sharded walls, NCCL 1 rank: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in nccl_walls.items()) + "; gloo "
        f"{GLOO_RANKS} ranks on one card: " + "; ".join(
            f"rank {r} " + ", ".join(f"{k} {v:.3f} s" for k, v in w.items())
            for r, w in gloo_walls.items()) + f"; cli {cli_secs:.2f} s; "
        f"total {time.perf_counter() - t_start:.1f} s")
    asset_dir.cleanup()
    log(gpu_name_and_power())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
