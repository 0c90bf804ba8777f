#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout around this file; it
exits non-zero (and prints no result line) without them.  It imports nothing
of JAX.  Phases, one JSON line each:

  1. device          the card's name and power limit (nvidia-smi);
  2. build           nvcc builds both SpMV kernels, one process per source,
                     started together (csrc/dia_spmv.cu, csrc/ell_spmv.cu);
                     B3 (csrc/explicit_step.cu) builds at its first launch,
                     one library per element shape and type;
  3. kernel          each kernel against its plain PyTorch SpMV on the card,
                     in float32 (relative error <= 1e-5) and float64
                     (<= 1e-12).  DIA: the box_tet n=96 lattice system and a
                     ragged one, each also through the halo entry with both
                     halos None, which must give the same bits (every DIA
                     case of the script is held so, and launched twice).  ELL (B2 takes the sliced layout of
                     sparse/sliced.py; every block checked to hold no slice
                     wider than its longest row, and a block laid out here
                     also against spmv_ell on its padded (N, K) form):
                     box_tet n=96 with its
                     nodes randomly renumbered (857,375 rows, K = 16) in the
                     solve's row order and unordered, a ragged rectangular
                     block with both sentinels, and a one-slot rectangular
                     block with empty slices and a part slice.  Then small
                     float64 solves on the card
                     against the same solves on the CPU (box_tet n=8 on the
                     DIA path, scrambled Delaunay n=32 on the ELL path);
  4. solve           solve_poisson on box_tet n=96, float32, rtol 1e-6
                     (the lattice path, kernel B1): converged, relres <=
                     1e-6, 271 +- 10 iterations, nodal error <= 2e-4 against
                     u = x^2+y^2+z^2, B1 launches >= iterations;
  5. solve_ell       solve_implicit on the renumbered n=96 mesh with
                     recover=False (the ELL path, float32, so the hybrid
                     operator: lex order, 15 dense diagonals, no remainder):
                     the same bars, B1 launches = iterations + 2 (r0, one
                     an iteration, the answer's residual after the loop),
                     B2 launches = 0; the ELL assembly repeated bit for bit;
                     and the host pattern build's seconds;
  6. solve_recovered solve_poisson on box_tet n=48 with its nodes renumbered:
                     the structure is recovered, B1 launches >= iterations,
                     B2 launches = 0, iterations = the lattice solve's +- 1;
  7. elasticity3d    solve_elasticity on box_tet n=48 clamped on x=0 (the
                     tetra preset: E = 240.565, nu = 0.3, body force
                     (0.1, 0, 0)), float32 and float64, rtol 1e-6: the flat
                     59-diagonal DIA system on B1 (B2 launches = 0); the
                     float32 count within 15% of the JAX package's 1240;
                     float32 within 2e-3 of float64; B1 and B2 against their
                     plain versions on that matrix; and an all-face patch
                     test (Dirichlet values of a linear field, n=32, float32,
                     nodal error <= 5e-7);
  8. elasticity2d    rect_tria [0,2]x[0,1] at 1024x512 clamped on x=0 with
                     unit +x point loads on x=2, plane stress, float64, rtol
                     1e-6: on the DIA path (B1, 17 diagonals), then with its
                     nodes renumbered by default_rng(0) and recover=False on
                     the ELL path (B2, K = 16, B1 launches = 0); the two
                     solutions agree and so do the counts (+- 2);
  9. explicit        the tria preset on rect_tria [0,10]x[0,2] at 1000x200,
                     x=0 clamped, probes 670/671, 2,500 steps: float32 twice
                     bit for bit, 1,250 + checkpoint + 1,250 bit for bit,
                     float64 against float32 on the probes; a quad preset
                     (hourglass) run, float64, card against CPU bit for bit;
                     ms per step (the steps run through kernel B3,
                     csrc/explicit_step.cu: each run counts B3's launches
                     from zero and checks explicit.kernel_steps = steps, an
                     element and a node pass a step of the mesh's own
                     library and no other, the hourglass quad's its own
                     (B3_HG) with explicit.hg_kernel_steps = steps, none on
                     the CPU);
 9b. explicit_b3     B3 as explicit_dynamics builds it: one step on the card
                     against the same step on the CPU, bit for bit (the
                     element pass's forces, the node pass's new disp and
                     velo), one launch of each pass of the shape's library,
                     on phase 9's tria case from its last states, on the
                     explicit cell's 1,572,864-element tetra4 box and on the
                     hourglass cell's 4096 x 2048 quad4 plate (its
                     hourglass pass and velocity-form node pass) from
                     seeded states, float32 and float64; each pass's
                     device us, back to back and each behind a write that
                     empties the L2, beside the bytes it must move (its
                     bound at the card's HBM peak); the box's float32 case
                     is the `kernels` line's B3 entry;
 10. cli             `python -m pfemfort_tpu_torch` elasticity and explicit
                     as subprocesses on .dat files, --device cuda;
 11. mg            solve_poisson on box_tet n=96, float32, bc_mode='full',
                     precond='mg', rtol 1e-6, maxiter 100 (the JAX bench's
                     flagship MG stage): 7 +- 1 iterations, nodal error <=
                     2e-4, 4 levels, B1 launched on every smoothing level
                     (the coarsest, 13^3, is the dense inverse);
 12. cheby, ic0      solve_poisson on the same lattice, reduced, float32,
                     rtol 1e-6: each under the Jacobi solve's count and
                     within 10% of the JAX package's float64 count on the
                     CPU;
 13. amg             solve_implicit on box_tet n=96 renumbered by
                     default_rng(2), recover=False, float32, rtol 1e-6,
                     precond='amg' (the JAX bench's amg stage): <= 20
                     iterations, the fine operator the hybrid (B1), B2
                     launched on the rectangular transfers; beside it
                     Jacobi on the same system (B1 only), time to solution;
 14. elasticity_mg   the elasticity3d system with bc_mode='full',
                     precond='mg', float32: under half the float32 Jacobi
                     count of phase 7 and within 2e-3 of its float64
                     solution;
 15. large           box_tet n=200 (48M elements): float32 Jacobi-CG, rtol
                     1e-6, 546 +- 15 iterations; refine=True to a true
                     float64 relres <= 1e-8 with nodal error <= 1e-5; peak
                     device memory and the assembly's chunk count;
 16. kernel          B2 on an SA-AMG P0, its P0^T and an IC(0) T of the
                     renumbered n=96 system in its solve's row order, B1 on
                     the 13^3 multigrid level and on the full-system DIA,
                     each against its plain version (float32 and float64);
 17. cli             poisson --bc-mode full --precond mg, --refine and an
                     options file with -pc_type gamg, as subprocesses;
 18. pattern_native  the host library's ELL pattern builder against the numpy
                     builder on the renumbered n=32 box, every array bit for
                     bit; the n=96 ELL solves' pattern_s (rng 0 and 2);
 19. hybrid          scrambled Delaunay n=60 (205,379 rows), float32, rtol
                     1e-6: dense diagonals and a remainder, so the solve
                     launches B1 and B2 (each iterations + 2); the hybrid
                     product against the plain ELL product of the ordered
                     system (<= 1e-5), each part against its plain version;
 20. matfree         solve_poisson(matrix_free=True), float32, rtol 1e-6, on
                     box_tet n=96 (271 +- 10 iterations, nodal error <=
                     2e-4) and n=200 (546 +- 15): no SpMV launch, ms per
                     iteration and peak device memory;
 21. highprec        solve_box_poisson_1e8 on box_tet n=96 and n=200: true
                     float64 relres <= 1e-8, <= 6 outer iterations, nodal
                     error <= 1e-7 (n=96) / 1e-6 (n=200); B1 in float32 on
                     every smoothing level and in float64 on the outer
                     residual; stage seconds and peak device memory;
 22. cfd             fractional_step_ns in float32: the lid-driven cavity on
                     rect_tria 512x512 (nu 0.01, dt 5e-5 under the viscous
                     bound h^2/(4 nu), 50 steps; B1), the 3D Taylor-Green
                     vortex on box_tet 64x64x32 of [0,pi]^2 x [0,pi/2]
                     (free slip, 125 steps; energy within 30% of
                     exp(-4 nu t); B1) and a renumbered 64x64 cavity (B2);
                     ms per step, CG iterations and launches per step, and
                     the steps whose pressure CG stopped at its cap;
 23. cli             partition (rcb, greedy), poisson --matrix-free and cfd
                     on a renumbered cavity's .dat files, as subprocesses;
 24. timing          kernel, plain and library SpMV times (plain, kernel,
                     library, kernel, plain; the library call is
                     torch.sparse_csr_tensor(...) @ x, i.e. cuSPARSE, built
                     from the same matrix and checked against the kernel) of
                     B1 on the n=96 lattice system and of B2 on the same
                     matrix in the solve's row order, in lattice order and
                     unordered; of B1 (59 diagonals; float32, and float64
                     as the f64 solve launches it) and B2 (the same
                     matrix as ELL) on the 3D elasticity system, of B1 (17
                     diagonals) and B2 (K = 16, renumbered, the solve's row
                     order) on the 2D one; of the phase-16 blocks and the
                     hybrid's two parts on the Delaunay matrix; each timed
                     twice: back to back (host cost per call included) and
                     queued behind a sleep kernel (device time only); B2, for
                     a block under 50 MB, also with a cold L2 (a 256 MB
                     scratch write before each product); bytes,
                     the bound at the card's data-sheet memory rate,
                     launches per solve, the GB/s they imply, and each
                     solve's seconds by stage, launches and ms per
                     iteration;
 25. dist_kernel     kernel B1's halo entry (the in-shard product of the
                     sharded DIA route: x read from [left | x_l | right])
                     against its plain version, f32 (<= 1e-5) and f64
                     (<= 1e-12), with both halos and with an edge rank's
                     missing one, at one rank of the 8-way slab of box_tet
                     n=200 (990,025 rows = whole lattice planes, 15
                     diagonals, w = 39,608) and of the 4-way slab of the
                     3D elasticity n=48 system (86,440 rows, 59
                     diagonals, w = 7,064); each timed in f32 as phase 24 times B1,
                     beside its byte bound and cuSPARSE on the CSR of the
                     same (P, P + 2w) block;
 26. dist_dia        a world-size-1 NCCL group (parallel/multihost.py), then
                     solve_implicit_sharded on box_tet n=96, f32, rtol 1e-6
                     (271 +- 10 iterations, within 2 of phase 4's, relres
                     <= 1e-6, nodal error <= 2e-4, layout 'dia', B1 halo
                     launches >= iterations, no B2) and on the phase-7
                     elasticity system in f64 with Jacobi (within 2 of
                     phase 7's f64 count, u within 1e-9) and block-Jacobi;
                     stage seconds, ms per iteration, peak device memory
                     above what the script held before the solve, and the
                     host cost of CG's reduced dot pair (one all_reduce and
                     the flag read) against the local pair; after each
                     solve, B1's halo entry against its plain version on
                     that solve's own (D, P) block, f32 and f64, with both
                     halos None (as the solve launched it) and random ones,
                     and timed there in the solve's dtype with both halos
                     None (n=96 f32, elasticity f64 Jacobi) beside its
                     bound and cuSPARSE;
 27. dist_ell        distributed_cg_solve (the all-gather ELL route) at
                     world size 1 on the n=96 box's ELL system, f32, rtol
                     1e-6: 271 +- 10 iterations, B2 launches >= iterations;
 28. dist_ell_halo   solve_implicit_sharded's ELL route (per-rank ELL
                     assembly, the stash exchange, ghost-exchange Krylov)
                     at world size 1.  float32 solves run the per-rank
                     hybrid (B1 on the rank's dense local diagonals and its
                     own x, B2 on the remainder and the ghost-extended x):
                     the n=96 box renumbered by default_rng(0),
                     recover=False, rtol 1e-6, 15 diagonals and no
                     remainder, Jacobi (the bars of phase 4; B1 launches =
                     iterations + 1, B2 none) and per-rank IC(0) (within
                     10% of 90; B1 launches = iterations + 1, B2 = 6
                     (iterations + 1), its T and T^T); phase 19's Delaunay
                     n=60 mesh, Jacobi (a non-empty remainder, B1 and B2
                     each launched >= iterations, the count within 5% of
                     phase 19's); the renumbered phase-7 elasticity
                     system, f64, block-Jacobi on B2 (within 1% of 1,044;
                     u within 1e-6 of phase 26's); stage seconds, ms per
                     iteration beside the single-device and DIA-route
                     solves, peak device memory, the set-up's host and
                     device bytes; after each solve, on that solve's own
                     blocks (random x, ghost slots included), f32 and f64:
                     the hybrid's two parts against their plain versions
                     and their sum against spmv_sliced on the whole
                     ghost-extended block, or B2 on that block, and IC(0)
                     T and T^T; B2
                     at rank 1 of an 8-way RCB partition of the renumbered
                     n=96 box (laid out on the host without a group), timed
                     beside its bound and cuSPARSE, and the cost of the
                     ghost-extended vector's concatenation; and
                     solve_poisson_partitioned on one rank's files (a
                     renumbered n=24 box) against the single-device solve
                     (u within 1e-8, float64);
 29. cli             `poisson --shards 2 --device cpu` (two gloo ranks the
                     CLI starts under torchrun) against the single-device
                     CLI solve on the card (u within the VTK's 1e-6), on a
                     box (the DIA route) and on a scrambled Delaunay n=12
                     mesh (the ELL route), and `--shards 2 --device cuda`,
                     which must fail naming the card count;
 30. dist_mg         precond='mg' at world size 1 (parallel/dist_mg.py):
                     box_tet n=96 f32, rtol 1e-6 (the full system, 912,673
                     rows; iterations within 1 of phase 11's, nodal error
                     <= 2e-4, precond_used 'mg', distributed_mg) and the
                     phase-7 elasticity system f32 (under half of phase 7's
                     f32 Jacobi count, within 2e-3 of its f64 solution);
                     B1 halo-entry launches >= 3 x iterations, coarse B1
                     launches > 0, no B2; after each solve B1's halo entry
                     against its plain version on the solve's own fine
                     block (f32, f64; halos None and random), timed there;
                     stage seconds, ms per iteration, peak device memory;
 31. dist_amg        precond='amg' on the sharded ELL route at world size
                     1: the n=96 box renumbered by default_rng(2),
                     recover=False, f32, rtol 1e-6 (<= 20 iterations, nodal
                     error <= 2e-4, precond_used 'amg', layout 'ell'); the
                     fine operator is the per-rank hybrid: B1 launches on
                     its 15 diagonals and B2 launches on the P0_s and
                     P0_s^T blocks (each >= iterations), none on the whole
                     ghost-extended block; each block against its plain
                     version (f32, f64); amg_setup_s, the levels and ms per
                     iteration beside phase 13's;
 32. dist_partition  rcb_partition_device on the element centroids of
                     box_tet n=200 (48M, made on the card), 8 parts: every
                     part within 1.05 E/8 + 64 and non-empty, every part's
                     extent product under 0.35 of the volume, the same ids
                     as the port's CPU run; seconds on the card and the CPU;
 33. dist_explicit   explicit_dynamics_sharded on phase 9's tria case
                     (2,500 steps, probes 670/671) at world size 1: f32
                     twice bit for bit, within 1e-6 (f32) and 1e-12 (f64)
                     relative of phase 9's single-device runs on disp and
                     the probes; ms per step beside phase 9's;
 34. dryrun          pfemfort_tpu_torch.dryrun's four cases at world size 1
                     with the JAX package's assertions, their iterations.
 35. bench           the port's bench harness through the CLI, as a
                     subprocess: `python -m pfemfort_tpu_torch bench 32 0
                     160 --device cuda` (flagship, partition_quality,
                     unstructured, amg and dist_spmv at n=32; large_unstructured
                     at its full n=160: box_tet permuted by default_rng(0),
                     24,576,000 elements, the general ELL pattern, its row
                     order and the hybrid).  Exit code 0, its last line
                     parsed, every stage true, JAX's edge cuts (3,539 /
                     8,911 / 161,549), large_unstructured's rows
                     (4,019,679), nonzeros (59,690,347), no hybrid
                     remainder, 440 +- 15 iterations and nodal error <=
                     3e-4; the stages' counted launches (B1 on every
                     Jacobi solve, B2 on the AMG transfers) go into the
                     kernels line.  The two host programs (pfem_gentet,
                     pfem_partition, built beside the kernels in phase 2)
                     write a box and partition it;
 36. scaling         the weak-scaling harness (pfemfort_tpu_torch/
                     bench_scaling.py) at --per-shard-n 96 --shards 1 on the
                     card (one torchrun rank, NCCL): converged, 271 +- 10
                     iterations, B1's halo entry launched on every
                     iteration.  No scaling number is claimed (one card).

The command-line phases (10, 17, 23, 29) start their subprocesses at once
and wait for them all; a subprocess's `seconds` counts from that start.

Every launch count is set to 0 just before its path is driven and read just
after; from phase 11 on, a plain SpMV called on a card tensor would also be
counted, and none may be.  Then one JSON line describing the kernels
(launches summed over the counted paths; times, bound and library time on
the n=96 matrix; the errors of every case; the halo entry's, the ghost
block's and the per-rank hybrid's shapes and launches), and the result line
{"ok": true, "device": {...}} last, after the process group is torn
down.  Any failed check raises.
"""

import collections
import contextlib
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from pfemfort_tpu_torch import Mesh, build_dofmap, explicit_dynamics, \
    generate, host_native, mesh_io, solve_elasticity, solve_poisson
from pfemfort_tpu_torch.assembly import pattern as pattern_mod
from pfemfort_tpu_torch.assembly import structured
from pfemfort_tpu_torch.cfd import fractional_step_ns
from pfemfort_tpu_torch.cfd.navierstokes import PRESSURE_CG_MAXITER
from pfemfort_tpu_torch.assembly.fullsystem import zero_dirichlet_rows
from pfemfort_tpu_torch.drivers import presets
from pfemfort_tpu_torch.drivers.common import build_ell_ordering, \
    build_reduced_assembler, solve_implicit
from pfemfort_tpu_torch.dynamics import explicit_cuda
from pfemfort_tpu_torch.dynamics.checkpoint import load_state, save_state, \
    ExplicitState
from pfemfort_tpu_torch.elements.elasticity import apply_residual, dmat_3d, \
    dmat_plane_stress, elasticity_stiffness
from pfemfort_tpu_torch.elements.geometry import to_element_minor
from pfemfort_tpu_torch.elements.poisson import poisson_element_matrices
from pfemfort_tpu_torch.assembly.assemble import assemble_ell_values, \
    assemble_rhs, build_assembly_plan, dirichlet_rhs_correction
from pfemfort_tpu_torch.drivers import sharded as sharded_driver
from pfemfort_tpu_torch.drivers.partitioned import read_partitioned_local, \
    solve_poisson_partitioned
from pfemfort_tpu_torch.drivers.sharded import solve_implicit_sharded
from pfemfort_tpu_torch.mesh.reorder import recover_structure
from pfemfort_tpu_torch import dryrun
from pfemfort_tpu_torch.utils.timing import stage_seconds
from pfemfort_tpu_torch.dynamics.sharded import explicit_dynamics_sharded
from pfemfort_tpu_torch.parallel import dist_mg, multihost, shard_cg
from pfemfort_tpu_torch.parallel.dist_partition import rcb_partition_device
from pfemfort_tpu_torch.parallel.dist_assembly import build_dist_setup
from pfemfort_tpu_torch.parallel.dist_ell import local_columns, reader_plan
from pfemfort_tpu_torch.parallel.halo import halo_width
from pfemfort_tpu_torch.parallel.shard import build_sharded_system
from pfemfort_tpu_torch.solve import amg_device
from pfemfort_tpu_torch.solve.amg import build_samg
from pfemfort_tpu_torch.solve.highprec import solve_box_poisson_1e8
from pfemfort_tpu_torch.solve.ic0 import build_ic0_from_csr
from pfemfort_tpu_torch.solve.multigrid import build_gmg
from pfemfort_tpu_torch.sparse import dia_spmv_cuda, ell_spmv_cuda, hybrid
from pfemfort_tpu_torch.sparse import ops as sparse_ops
from pfemfort_tpu_torch.sparse.dia import DIAMatrix, decompose_offsets, \
    spmv_dia, spmv_dia_halo_local
from pfemfort_tpu_torch.sparse.formats import ELLMatrix, round_up
from pfemfort_tpu_torch.sparse.ordering import coord_lex_order, \
    permuted_sorted_cols
from pfemfort_tpu_torch.sparse.sliced import SLICE, ell_to_sliced, \
    slice_ell, unslice
from pfemfort_tpu_torch.sparse.spmv import spmv_ell, spmv_sliced
from pfemfort_tpu_torch.utils.timing import device_ms as _device_ms, \
    library_csr as _csr_library, peak_gbps, spmv_bound as _bound

N_FLAGSHIP = 96
N_RECOVERED = 48
N_DELAUNAY = 32
ITERS_BAR, ITERS_SLACK = 271, 10     # f32 Jacobi-CG to rtol 1e-6 (JAX package)
NODAL_ERR_MAX = 2e-4
REL_ERR_MAX = {torch.float32: 1e-5, torch.float64: 1e-12}
KERNELS = {"dia_spmv": dia_spmv_cuda.kernel, "ell_spmv": ell_spmv_cuda.kernel}
COLD_L2_BELOW_BYTES = 50e6    # the L2's size: a smaller block may stay there
ROOT = Path(__file__).resolve().parent

# Implicit elasticity (the tetra preset).  The JAX package's counts for the
# 3D configuration, f32 and f64 Jacobi-CG to rtol 1e-6, measured on the CPU
# (command in PERF.md).  The f32 count moves with the order of the sums: the
# port's own f32 run on the CPU took 1130, so the band is 15%.
E_EL, NU_EL = 240.565, 0.3
N_EL3D = 48
EL3D_JAX_ITERS = {torch.float32: 1240, torch.float64: 1096}
EL3D_ITERS_BAND = 0.15
EL3D_F32_VS_F64 = 2e-3      # relative; 3.4e-4 on the CPU
N_PATCH, PATCH_ERR_MAX = 32, 5e-7
EL2D_CELLS = (1024, 512)
EL2D_U_REL = 1e-8           # DIA vs ELL solutions, float64, rtol 1e-6
# Explicit dynamics: the tria preset; float32 drifts from float64 by a few
# per cent of the probes' range over 5,000 steps (up to 6% on a 250x50 mesh
# on the CPU), so the bound is 25%.  Run for 2,500 steps (5,000 until PR 8,
# cut to keep the whole script well inside its time limit).
EXPLICIT_CELLS, EXPLICIT_STEPS = (1000, 200), 2500
EXPLICIT_F32_VS_F64 = 0.25
B3_BOX_CELLS = 64           # phase 9b: the explicit cell's box, 1,572,864 tetra4
QUAD_CELLS, QUAD_STEPS = (200, 40), 500
HG_PLATE_CELLS = (4096, 2048)   # phase 9b: the hourglass cell's plate
# Preconditioners, the full system and refinement.  Bars from the JAX
# package: its bench's flagship MG stage (7 iterations, 4 levels), its amg
# stage (12 iterations, levels [857375, 107983, 38008, 542]) and its 48M
# flagship (546 float32 Jacobi iterations); the cheby/ic0 counts of the JAX
# package for this system on the CPU (commands in PERF.md), in float64:
# its float32 counts there (231, 105) carry XLA-CPU float32 round-off (its
# float32 Jacobi count is 344, against 271 in float64 and on the card).
MG_ITERS, MG_SLACK, MG_LEVELS = 7, 1, 4
PC_JAX_CPU_ITERS = {"cheby": 198, "ic0": 90}
PC_JAX_CPU_F32_ITERS = {"cheby": 231, "ic0": 105}
PC_BAND = 0.10
AMG_ITERS_MAX = 20
EL_MG_FRACTION = 0.5        # of the elasticity3d phase's float32 count
N_LARGE, LARGE_ITERS, LARGE_SLACK = 200, 546, 15
LARGE_RELRES, LARGE_NODAL_ERR = 1e-8, 1e-5
# The host pattern build of the renumbered n=96 ELL solves with the numpy
# builder (PERF.md, PR 4's chip run), default_rng(0) and (2).
PR4_PATTERN_S = {0: 28.28, 2: 27.70}
N_DELAUNAY_F32 = 60         # 59^3 = 205,379 free rows
# Matrix-free: (iterations, slack, nodal error bound or None) per box size;
# the counts of the assembled float32 Jacobi-CG solves.
MATFREE_BARS = {N_FLAGSHIP: (ITERS_BAR, ITERS_SLACK, NODAL_ERR_MAX),
                N_LARGE: (LARGE_ITERS, LARGE_SLACK, None)}
# solve_box_poisson_1e8: the JAX package's bars (tests/test_highprec.py) and
# its 48M run (round 5: 2 outer, 13 inner iterations).
HIGHPREC_NODAL = {N_FLAGSHIP: 1e-7, N_LARGE: 1e-6}
HIGHPREC_MAX_OUTER = 6
JAX_48M_OUTER_INNER = (2, 13)
# CFD: (cells per side, steps, dt, nu); the cavity's dt is half the viscous
# bound h^2 / (4 nu) = 9.5e-5; Taylor-Green as the JAX test
# (tests/test_cfd.py:86) at 64x64x32 cells.  The bars are per step or
# relative to exp(-4 nu t), so the step counts (100 and 250 until PR 8) were
# halved to keep the whole script well inside its time limit.
CFD_CAVITY = (512, 50, 5e-5, 0.01)
CFD_TG3D = (64, 125, 2e-3, 0.05)
CFD_RENUMBERED = (64, 20, 1e-3, 0.05)
CFD_RTOL_P = 1e-6           # pressure CG, as every float32 solve here
# The sharded routes (phases 25-29).  dist_kernel's shapes: one rank of
# the 8-way slab of box_tet n=200 (P = whole planes of the 199^3 lattice,
# 15 diagonals) and of the 4-way slab of the 3D elasticity n=48 system (59
# diagonals).  dist_dia's counts, u and ms per iteration against the
# single-device solves of phases 4 and 7 (f64) of this run.
N_SLAB, SLAB_RANKS, EL3D_SLAB_RANKS = 200, 8, 4
DIST_ITERS_SLACK = 2
DIST_EL3D_U_REL = 1e-9
# The sharded ELL route (phase 28).  At world size 1 the renumbered n=96
# box takes the single-device bars (one rank: RCB with one part and the
# geometric order within it give the lattice system), IC(0) within PC_BAND
# of the JAX package's count; the renumbered elasticity system in f64 with
# block-Jacobi within 1% of the 1,044 iterations the DIA route takes on the
# H100 (PERF.md), u within the solves' relres of this run's DIA route.  B2
# is timed at rank 1 of an ELL_RANKS-way RCB partition of the n=96 box.
DIST_ELL_EL3D_BJ_ITERS, DIST_ELL_EL3D_BAND = 1044, 0.01
DIST_ELL_EL3D_U_REL = 1e-6
# float32 solves on the route take the per-rank hybrid; the phase-19
# Delaunay mesh there: its count within 5% of phase 19's single-device
# hybrid (which took 340 iterations on the H100).
DELAUNAY_ROUTE_BAND = 0.05
ELL_RANKS = 8
N_PARTITIONED = 24
PARTITIONED_U_TOL = 1e-8    # float64 solves to rtol 1e-10, two row orders
N_DELAUNAY_CLI = 12
# Phases 30-34.  dist_mg holds the single-device bars of phases 11 and 14
# (MG_SLACK, EL_MG_FRACTION, EL3D_F32_VS_F64), dist_amg phase 13's
# (AMG_ITERS_MAX).  dist_partition: 8 parts of the n=200 box's element
# centroids; the JAX test's bars (tests/test_dist_partition.py): each part
# within 5% (+64) of E/8, and each part's extent product under 0.35 of the
# box's volume (1).  dist_explicit: the sharded loop at world size 1
# against the single-device loop of phase 9 on disp and the probes.
RCB_PARTS, RCB_EXTENT_SHARE = 8, 0.35
DIST_EXPLICIT_REL = {torch.float32: 1e-6, torch.float64: 1e-12}
CLI_SHARDED_U_TOL = 1e-6 * (1 + 1e-9)   # one unit of the VTK's 6 decimals
# Phases 35-36: the bench harness's arguments and stages (large_unstructured
# at its full size), JAX's edge cuts and the bars of its large_unstructured
# stage (BENCH_DETAIL.json), the scaling harness's box per rank.
BENCH_ARGS = ("32", "0", "160")
BENCH_STAGES = {"flagship", "partition_quality", "unstructured", "amg",
                "large_unstructured", "dist_spmv"}
PARTITION_CUTS = {"rcb": 3539, "greedy": 8911, "random": 161549}
LU_ROWS, LU_NNZ, LU_ITERS, LU_SLACK, LU_NODAL = (4_019_679, 59_690_347, 440,
                                                 15, 3e-4)
SCALING_N = N_FLAGSHIP
# Plain SpMV calls made on a card tensor (the kernel wrappers route card
# tensors to their kernels, so this must stay empty).
PLAIN_ON_CARD = collections.Counter()
# Launches by kernel, dtype and shape of each labelled counted path.
SOLVE_SHAPES = {}
# Every phase line carries its seconds since the script started (at_s).
_START = time.perf_counter()



def _phase(name, **fields):
    print(json.dumps(dict(phase=name, **fields,
                          at_s=time.perf_counter() - _START)), flush=True)


def _check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _poisson_fn(coords_em):
    return poisson_element_matrices(coords_em, "tetra4", source=-6.0)


def _reset_launches():
    for k in KERNELS.values():
        k.launches = 0
        k.entry_launches.clear()


def _launches():
    return {name: k.launches for name, k in KERNELS.items()}


def _flagship_system(device, dtype):
    n = N_FLAGSHIP
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    dofmap = build_dofmap(mesh, 1, dbc, with_elem=False)
    assemble = build_reduced_assembler(mesh, 1, dofmap, _poisson_fn, dtype,
                                       device)
    coords = torch.as_tensor(to_element_minor(mesh.elem_coords()),
                             dtype=dtype, device=device)
    A, _ = assemble(coords)
    return A


def _permuted_box(n, seed=0):
    """box_tet n with its nodes randomly renumbered (no structure left)."""
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    perm = np.random.default_rng(seed).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    return mesh, dbc


def _scrambled_delaunay(n, seed=0):
    """Delaunay tets of a jittered (n+1)^3 lattice of the unit cube, nodes
    randomly renumbered; Dirichlet u = x^2+y^2+z^2 on the hull."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    g = np.linspace(0, 1, n + 1)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    pts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    interior = ((pts > 1e-9) & (pts < 1 - 1e-9)).all(axis=1)
    pts[interior] += rng.uniform(-0.25, 0.25, (int(interior.sum()), 3)) / n
    tri = Delaunay(pts)
    conn = tri.simplices.astype(np.int64)
    a, b, c, d = (pts[conn[:, i]] for i in range(4))
    vol6 = np.einsum("ij,ij->i", np.cross(b - a, c - a), d - a)
    conn[vol6 < 0] = conn[vol6 < 0][:, [0, 2, 1, 3]]
    conn = conn[np.abs(vol6) > 1e-12]
    hull = np.unique(tri.convex_hull)
    dbc = np.stack([hull, np.zeros(len(hull)), (pts[hull] ** 2).sum(1)], 1)
    perm = rng.permutation(len(pts))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(pts))
    dbc[:, 0] = perm[hull]
    return Mesh("tetra4", pts[inv], perm[conn]), dbc


def _flagship_ell(device, dtype):
    """The renumbered n=96 system as the ELL path builds it: the unordered
    assembly, its row ordering, the host set-up seconds by step, and the
    geometric (lex) row order, which is the lattice's own numbering."""
    secs = {}
    t0 = time.perf_counter()
    mesh, dbc = _permuted_box(N_FLAGSHIP)
    dofmap = build_dofmap(mesh, 1, dbc)
    secs["mesh_and_dofmap_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    assemble = build_reduced_assembler(mesh, 1, dofmap, _poisson_fn, dtype,
                                       device)
    torch.cuda.synchronize()
    secs["pattern_and_plan_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    coords = torch.as_tensor(to_element_minor(mesh.elem_coords()),
                             dtype=dtype, device=device)
    torch.cuda.synchronize()
    secs["coords_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ordering = build_ell_ordering(assemble.pattern,
                                  mesh.coords[dofmap.assy_for_soln],
                                  dofmap.assy_for_soln % 1, device)
    torch.cuda.synchronize()
    secs["ordering_s"] = time.perf_counter() - t0
    lex = coord_lex_order(mesh.coords[dofmap.assy_for_soln])
    return assemble, coords, ordering, secs, lex


def _ragged_ell(device, rng):
    """K = 7, a rectangular block (n_cols = n_rows + 10,007), padded slots
    holding either sentinel (n_cols, 2 * n_rows + 128)."""
    n_rows, k = 300_007, 7
    n_cols = n_rows + 10_007
    cols = rng.integers(0, n_cols, (n_rows, k))
    pad = rng.random((n_rows, k)) < 0.3
    cols = np.where(pad, np.where(rng.random((n_rows, k)) < 0.5, n_cols,
                                  2 * n_rows + 128), cols)
    vals = np.where(pad, 0.0, rng.standard_normal((n_rows, k)))
    return ELLMatrix(cols=torch.as_tensor(cols, dtype=torch.int32,
                                          device=device),
                     vals=torch.as_tensor(vals, dtype=torch.float32,
                                          device=device),
                     n_cols=n_cols)


def _skinny_ell(device, rng):
    """K = 1, a rectangular block (n_cols = n_rows // 8, as an AMG P0), with
    runs of empty slices and a part slice at the end (n_rows % 32 != 0)."""
    n_rows = 100_003
    n_cols = n_rows // 8
    cols = rng.integers(0, n_cols, (n_rows, 1))
    empty = (np.arange(n_rows) // SLICE) % 5 == 3
    cols[empty] = n_cols
    vals = np.where(empty[:, None], 0.0, rng.standard_normal((n_rows, 1)))
    return ELLMatrix(cols=torch.as_tensor(cols, dtype=torch.int32,
                                          device=device),
                     vals=torch.as_tensor(vals, dtype=torch.float32,
                                          device=device),
                     n_cols=n_cols)


def _tight(S):
    """True when no slice of the sliced block S is wider than its longest
    row (counted from S's own columns)."""
    count = (unslice(S).cols < S.n_cols).sum(1)
    count = torch.cat([count, count.new_zeros(S.n_slices * SLICE
                                              - S.n_rows)])
    width = (S.slice_ptr[1:] - S.slice_ptr[:-1]) // SLICE
    return bool(torch.equal(count.view(-1, SLICE).amax(1)
                            if S.n_slices else width, width))


def _ragged_dia(device, dtype, rng):
    n = 300_007
    offsets = (-(n + 5), -4097, -1, 0, 3, 12_345, n + 2)
    vals = torch.as_tensor(rng.standard_normal((len(offsets), n)),
                           dtype=dtype, device=device)
    return DIAMatrix(vals=vals, offsets=offsets, n_rows=n)


def _errors(y, y_ref):
    torch.cuda.synchronize()
    err = float((y - y_ref).abs().max())
    return err, err / float(y_ref.abs().max())


def _time_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _timed_pairs(plain, kernel, library, reps=100):
    """Mean ms of (plain, kernel, library, kernel, plain) runs, and each
    run."""
    run = {"plain": plain, "kernel": kernel, "library": library}
    for fn in run.values():
        _time_ms(fn, 10)
    times = {k: [] for k in run}
    for k in ("plain", "kernel", "library", "kernel", "plain"):
        times[k].append(_time_ms(run[k], reps))
    return {k: float(np.mean(v)) for k, v in times.items()}, times


def _timed_device(run):
    """_device_ms of each function of the dict `run`, in its order and then
    back (plain, kernel, library, kernel, plain): means, and for each
    whether all its runs hid the host."""
    times = {k: [] for k in run}
    hidden = {k: True for k in run}
    for k in [*run, *reversed(run)]:
        ms, ok = _device_ms(run[k])
        times[k].append(ms)
        hidden[k] = hidden[k] and ok
    return {k: float(np.mean(v)) for k, v in times.items()}, hidden


def _each_device_ms(fn, scratch=None, reps=30, sleep_cycles=200_000_000):
    """Device ms of fn, each call timed alone by its own pair of events,
    all queued behind a sleep kernel; with `scratch`, a write of it (more
    than the L2 holds) before each call, so that each finds the L2 cold."""
    pairs = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
             for _ in range(reps)]
    torch.cuda._sleep(sleep_cycles)
    for start, end in pairs:
        if scratch is not None:
            scratch.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.mean([start.elapsed_time(end) for start, end in pairs]))


def _check_solve(label, res, u_exact):
    st = res.stats
    nodal_err = float(np.abs(res.u_full - u_exact).max())
    _check(st.converged and st.relres <= 1e-6, f"{label}: {st}")
    _check(abs(st.iters - ITERS_BAR) <= ITERS_SLACK,
           f"{label}: {st.iters} iterations, not {ITERS_BAR} +- "
           f"{ITERS_SLACK}")
    _check(bool(np.isfinite(res.u_full).all())
           and res.u_full.shape == u_exact.shape, f"{label}: solution")
    _check(nodal_err <= NODAL_ERR_MAX, f"{label}: nodal error {nodal_err}")
    return nodal_err


def _clamped(mesh):
    """Every component of the nodes on the face coords[:, 0] == min."""
    nodes = np.nonzero(mesh.coords[:, 0] == mesh.coords[:, 0].min())[0]
    d = mesh.ndim
    return np.stack([np.repeat(nodes, d), np.tile(np.arange(d), len(nodes)),
                     np.zeros(d * len(nodes))], 1).astype(np.float64)


def _edge_loads(mesh, value=1.0):
    """+x point loads on the nodes of the face coords[:, 0] == max."""
    nodes = np.nonzero(mesh.coords[:, 0] == mesh.coords[:, 0].max())[0]
    return np.stack([nodes, np.zeros(len(nodes)),
                     np.full(len(nodes), value)], 1).astype(np.float64)


def _renumber(mesh, *tables, seed=0):
    perm = np.random.default_rng(seed).permutation(mesh.n_node)
    out = [mesh.renumbered(perm.astype(np.int64))]
    for t in tables:
        t = t.copy()
        t[:, 0] = perm[t[:, 0].astype(np.int64)]
        out.append(t)
    return perm, out


def _elastic_fn(etype, D):
    return lambda c: elasticity_stiffness(c, etype, D)


def _assembled(mesh, dbc, fn, dtype, device, ordered):
    """(A, pattern) of the reduced system as its solve assembles it; ordered:
    in the ELL row order of the solve."""
    ndof = mesh.ndim
    dofmap = build_dofmap(mesh, ndof, dbc)
    assemble = build_reduced_assembler(mesh, ndof, dofmap, fn, dtype, device)
    A, b = assemble(torch.as_tensor(to_element_minor(mesh.elem_coords()),
                                    dtype=dtype, device=device))
    if ordered:
        ordering = build_ell_ordering(
            assemble.pattern, mesh.coords[dofmap.assy_for_soln // ndof],
            dofmap.assy_for_soln % ndof, device)
        A, b = ordering.system(A, b)
    return A, assemble.pattern


def _ell_from_dia(A):
    """The DIA matrix as padded ELL in the same (lattice) row order: each
    row's nonzero diagonals in offset order, sentinel n_rows after them."""
    N = A.n_rows
    offs = torch.tensor(A.offsets, dtype=torch.int64, device=A.vals.device)
    cols = torch.arange(N, device=A.vals.device)[:, None] + offs[None, :]
    vals = A.vals.t()
    valid = (cols >= 0) & (cols < N) & (vals != 0)
    k = int(valid.sum(1).max())
    order = torch.sort((~valid).to(torch.int8), dim=1,
                       stable=True).indices[:, :k]
    cols = torch.where(valid, cols, N).gather(1, order)
    vals = torch.where(valid, vals, 0.0).gather(1, order)
    return ELLMatrix(cols=cols.to(torch.int32).contiguous(),
                     vals=vals.contiguous(), n_cols=N)


def _ell_errors(label, A, x, errs):
    """B2 against spmv_sliced on the sliced block A; an ELLMatrix is laid
    out here first, and B2 is then also held against spmv_ell on the padded
    block, which does not go through the layout."""
    refs = {}
    if isinstance(A, ELLMatrix):
        refs["padded"] = spmv_ell(dataclasses.replace(
            A, vals=A.vals.to(x.dtype)), x)
        A = ell_to_sliced(A)
    _check(_tight(A), f"ell_spmv {label}: a slice is wider than its rows")
    Ad = dataclasses.replace(A, vals=A.vals.to(x.dtype))
    y = ell_spmv_cuda.ell_spmv(Ad, x)
    refs["sliced"] = spmv_sliced(Ad, x)
    err = {k: _errors(y, ref) for k, ref in refs.items()}
    abs_err = max(a for a, _ in err.values())
    rel_err = max(r for _, r in err.values())
    errs[("ell_spmv", label, x.dtype)] = abs_err
    _phase("kernel", kernel="ell_spmv", case=label, dtype=str(x.dtype),
           rows=A.n_rows, n_cols=A.n_cols, max_width=A.max_width,
           slots=A.n_slots, max_abs_err=abs_err, max_rel_err=rel_err,
           max_rel_err_by_reference={k: r for k, (_, r) in err.items()},
           bound=REL_ERR_MAX[x.dtype])
    _check(rel_err <= REL_ERR_MAX[x.dtype],
           f"ell_spmv {label} {x.dtype}: rel err {rel_err}")


def _kernel_errors(label, A, errs, rng):
    """Each kernel against its plain version on A in float32 and float64;
    B1 also through its halo entry with both halos None and launched
    twice, each bit for bit the single-device product."""
    dev = A.vals.device
    is_dia = isinstance(A, DIAMatrix)
    x64 = rng.standard_normal(A.n_rows if is_dia else A.n_cols)
    for dtype in (torch.float32, torch.float64):
        x = torch.as_tensor(x64, dtype=dtype, device=dev)
        if not is_dia:
            _ell_errors(label, A, x, errs)
            continue
        Ad = DIAMatrix(vals=A.vals.to(dtype), offsets=A.offsets,
                       n_rows=A.n_rows, lattice=A.lattice)
        y = dia_spmv_cuda.dia_spmv(Ad, x)
        abs_err, rel_err = _errors(y, spmv_dia(Ad, x))
        same = {"halo entry, halos None": torch.equal(
                    y, dia_spmv_cuda.dia_spmv_halo(Ad, x, None, None)),
                "second launch": torch.equal(y, dia_spmv_cuda.dia_spmv(Ad, x))}
        errs[("dia_spmv", label, dtype)] = abs_err
        _phase("kernel", kernel="dia_spmv", case=label, dtype=str(dtype),
               rows=A.n_rows, diagonals=len(A.offsets), max_abs_err=abs_err,
               max_rel_err=rel_err, bound=REL_ERR_MAX[dtype],
               bit_equal=same)
        _check(rel_err <= REL_ERR_MAX[dtype] and all(same.values()),
               f"dia_spmv {label} {dtype}: rel err {rel_err}, bit equal "
               f"{same}")


def _counted(fn, counted, label=None):
    """Run one path with every launch count set to 0 just before it and
    read just after; add the counts to `counted`.  With a label, the
    path's launches by kernel, dtype and shape go to SOLVE_SHAPES[label]."""
    shapes = collections.Counter()
    _reset_launches()
    with _shapes_recorded(shapes):
        out = fn()
    launches = _launches()
    for k, v in launches.items():
        counted[k] += v
    # of B1's launches, those of its halo entry (the sharded route)
    counted["dia_spmv_halo"] += sum(
        v for e, v in dia_spmv_cuda.kernel.entry_launches.items()
        if e.startswith("dia_spmv_halo"))
    if label is not None:
        SOLVE_SHAPES[label] = shapes
    return out, launches


def _check_elastic(label, res, launches, on):
    st = res.stats
    _check(st.converged and st.relres <= 1e-6, f"{label}: {st}")
    _check(bool(np.isfinite(res.u_full).all()), f"{label}: non-finite u")
    off = "ell_spmv" if on == "dia_spmv" else "dia_spmv"
    _check(launches[on] >= st.iters and launches[off] == 0,
           f"{label}: launches {launches} vs {st.iters} iterations")
    _check(("order_s" in res.timings) == (on == "ell_spmv"),
           f"{label}: took the wrong path ({res.timings})")


def _elasticity3d(dev, counted, errs, rng):
    n = N_EL3D
    mesh, _ = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    dbc = _clamped(mesh)
    A, _ = _assembled(mesh, dbc, _elastic_fn("tetra4", dmat_3d(E_EL, NU_EL)),
                      torch.float32, dev, ordered=False)
    _check(len(A.offsets) == 59 and A.lattice is None
           and A.n_rows == 3 * n * (n + 1) ** 2,
           f"3D elasticity DIA is {A.n_rows} rows x {len(A.offsets)} "
           f"diagonals, lattice {A.lattice}")
    A_ell = _ell_from_dia(A)
    _kernel_errors("elasticity3d n=48", A, errs, rng)
    _kernel_errors("elasticity3d n=48 as ELL", A_ell, errs, rng)
    A_ell = ell_to_sliced(A_ell)
    res = {}
    for dtype in (torch.float32, torch.float64):
        label = f"elasticity3d {dtype}"
        r, launches = _counted(lambda: solve_elasticity(
            mesh, dbc, E_EL, NU_EL, bforce=(0.1, 0.0, 0.0), device=dev,
            dtype=dtype, rtol=1e-6), counted, label)
        _check_elastic(label, r, launches, "dia_spmv")
        jax_iters = EL3D_JAX_ITERS[dtype]
        _phase("elasticity3d", n=n, dtype=str(dtype), elements=mesh.n_elem,
               dofs=int(r.u_reduced.numel()), iters=r.stats.iters,
               jax_iters=jax_iters, relres=r.stats.relres,
               u_max=float(np.abs(r.u_full).max()), launches=launches,
               **r.timings)
        _check(abs(r.stats.iters - jax_iters) <= EL3D_ITERS_BAND * jax_iters,
               f"{label}: {r.stats.iters} iterations, JAX {jax_iters}")
        res[dtype] = r
    u32, u64 = res[torch.float32].u_full, res[torch.float64].u_full
    rel = float(np.abs(u32 - u64).max() / np.abs(u64).max())
    _phase("elasticity3d", f32_vs_f64_rel=rel, bound=EL3D_F32_VS_F64)
    _check(rel <= EL3D_F32_VS_F64, f"elasticity3d f32 vs f64: {rel}")

    # patch test: Dirichlet values of a linear field on all faces
    pm, _ = generate.box_tet(0, 1, N_PATCH, 0, 1, N_PATCH, 0, 1, N_PATCH)
    G = np.array([[1e-3, 2e-3, -1e-3], [0.5e-3, -2e-3, 1e-3],
                  [3e-3, 1e-3, 2e-3]])
    u_lin = pm.coords @ G.T + np.array([1e-3, -2e-3, 0.5e-3])
    bd = generate.boundary_nodes(pm)
    pdbc = np.stack([np.repeat(bd, 3), np.tile(np.arange(3), len(bd)),
                     u_lin[bd].reshape(-1)], 1)
    r, launches = _counted(lambda: solve_elasticity(
        pm, pdbc, E_EL, NU_EL, device=dev, dtype=torch.float32, rtol=1e-6),
        counted)
    _check_elastic("patch", r, launches, "dia_spmv")
    err = float(np.abs(r.u_full - u_lin.reshape(-1)).max())
    _phase("elasticity3d", patch_n=N_PATCH, iters=r.stats.iters,
           nodal_err=err, u_max=float(np.abs(u_lin).max()),
           bound=PATCH_ERR_MAX, launches=launches)
    _check(err <= PATCH_ERR_MAX, f"patch test nodal error {err}")
    return A, A_ell, res


def _elasticity2d(dev, counted, errs, rng):
    nx, ny = EL2D_CELLS
    mesh = generate.rect_tria(0, 2, nx, 0, 1, ny)
    dbc, fbc = _clamped(mesh), _edge_loads(mesh)
    D = dmat_plane_stress(E_EL, NU_EL)
    dtype = torch.float64
    A_dia, _ = _assembled(mesh, dbc, _elastic_fn("tria3", D), dtype, dev,
                          ordered=False)
    _check(len(A_dia.offsets) == 17 and A_dia.n_rows == 2 * nx * (ny + 1),
           f"2D DIA is {A_dia.n_rows} rows x {len(A_dia.offsets)}")
    r_dia, l_dia = _counted(lambda: solve_elasticity(
        mesh, dbc, E_EL, NU_EL, force_bc=fbc, device=dev, dtype=dtype,
        rtol=1e-6), counted, "elasticity2d dia f64")
    _check_elastic("elasticity2d dia", r_dia, l_dia, "dia_spmv")
    _phase("elasticity2d", path="dia", cells=[nx, ny], nodes=mesh.n_node,
           elements=mesh.n_elem, dofs=int(r_dia.u_reduced.numel()),
           iters=r_dia.stats.iters, relres=r_dia.stats.relres,
           u_max=float(np.abs(r_dia.u_full).max()), launches=l_dia,
           **r_dia.timings)

    perm, (pmesh, pdbc, pfbc) = _renumber(mesh, dbc, fbc)
    A_ell, pat = _assembled(pmesh, pdbc, _elastic_fn("tria3", D), dtype, dev,
                            ordered=True)
    # the pattern pads K to a multiple of 8; the sliced block reads no slot
    # past a slice's longest row (a tria3 node couples to at most 7 nodes)
    _phase("elasticity2d", pattern_k=pat.ell_k,
           sliced_max_width=A_ell.max_width, slots=A_ell.n_slots,
           nnz=pat.nnz)
    _check(pat.ell_k == 16 and A_ell.max_width == 14,
           f"renumbered 2D ELL: K = {pat.ell_k}, sliced max width "
           f"{A_ell.max_width}")
    _kernel_errors("elasticity2d 1024x512", A_dia, errs, rng)
    _kernel_errors("elasticity2d renumbered, ordered", A_ell, errs, rng)
    r_ell, l_ell = _counted(lambda: solve_implicit(
        pmesh, 2, pdbc, _elastic_fn("tria3", D), force_bc=pfbc, device=dev,
        dtype=dtype, rtol=1e-6, recover=False), counted,
        "elasticity2d ell f64")
    _check_elastic("elasticity2d ell", r_ell, l_ell, "ell_spmv")
    u_back = r_ell.u_full.reshape(-1, 2)[perm].reshape(-1)
    rel = float(np.abs(u_back - r_dia.u_full).max()
                / np.abs(r_dia.u_full).max())
    _phase("elasticity2d", path="ell", iters=r_ell.stats.iters,
           relres=r_ell.stats.relres, dia_iters=r_dia.stats.iters,
           u_rel_to_dia=rel, bound=EL2D_U_REL, launches=l_ell,
           **r_ell.timings)
    _check(rel <= EL2D_U_REL, f"elasticity2d ELL vs DIA u: {rel}")
    _check(abs(r_ell.stats.iters - r_dia.stats.iters) <= 2,
           f"elasticity2d iterations {r_ell.stats.iters} (ELL) vs "
           f"{r_dia.stats.iters} (DIA)")
    return A_dia, A_ell, r_dia, r_ell


def _b3_library(mesh, dtype, hourglass):
    """The key of B3's library that explicit_dynamics builds for `mesh`."""
    from pfemfort_tpu_torch.elements.basis import tabulate_basis

    ngp = 1 if hourglass else len(tabulate_basis(mesh.etype)[1])
    return (mesh.conn.shape[1], mesh.ndim, ngp, dtype, bool(hourglass))


def _explicit_run(mesh, dbc, preset, nsteps, device, dtype, **kw):
    """explicit_dynamics with kernel B3's counters at zero: (result,
    seconds, B3's launches by entry point).  Checks that every step on the
    card ran through B3, in the one library of the mesh's shape and type
    (`_b3_library`; under use_hourglass the hourglass library, B3_HG=1):
    its element and node passes once a step, the hourglass pass counted in
    explicit.hg_kernel_steps, and no other library launched; on the CPU
    none."""
    bforce = torch.tensor(preset.bforce, dtype=dtype, device=device)
    if preset.pulse_t is None:
        bforce_fn = lambda t: bforce
    else:
        pulse = torch.tensor(preset.pulse_t, dtype=dtype, device=device)
        bforce_fn = lambda t: bforce * torch.where(t <= pulse, 1.0, 0.0)
    for k in explicit_cuda._KERNELS.values():
        k.launches = 0
        k.entry_launches.clear()
    t0 = time.perf_counter()
    res = explicit_dynamics(
        mesh, dbc, preset.E, preset.nu, preset.dens, preset.dt, nsteps,
        bforce_fn=bforce_fn, thickness=preset.thickness,
        use_hourglass=preset.use_hourglass, device=device, dtype=dtype, **kw)
    seconds = time.perf_counter() - t0
    by_library = {key: dict(+collections.Counter(k.entry_launches))
                  for key, k in explicit_cuda._KERNELS.items()
                  if k.launches}
    on_card = torch.device(device).type == "cuda"
    want = {} if not on_card else {
        _b3_library(mesh, dtype, preset.use_hourglass):
        {"explicit_step_element": nsteps, "explicit_step_node": nsteps}}
    kernel_steps = res.timings["explicit.kernel_steps"]
    hg_steps = res.timings["explicit.hg_kernel_steps"]
    _check(kernel_steps == (nsteps if on_card else 0)
           and hg_steps == (kernel_steps if preset.use_hourglass else 0)
           and by_library == want,
           f"explicit on {device}: {nsteps} steps, {kernel_steps} through "
           f"B3 ({hg_steps} hourglass), launches {by_library}")
    launches = collections.Counter()
    for entries in by_library.values():
        launches.update(entries)
    return res, seconds, dict(+launches)


def _same(a, b, fields=("disp", "disp_prev", "velo", "acce",
                        "probe_history")):
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in fields)


def _explicit(dev):
    p = presets.TRIA_EXPLICIT
    nx, ny = EXPLICIT_CELLS
    mesh = generate.rect_tria(0, 10, nx, 0, 2, ny)
    dbc = _clamped(mesh)
    kw = dict(probe_dofs=p.probe_dofs)
    f32 = torch.float32
    counted = []        # B3's launches in each run, counted from zero

    def run(label, *args, **kwargs):
        res, seconds, launches = _explicit_run(*args, **kwargs)
        counted.append(dict(run=label, steps=res.timings["steps"],
                            kernel_steps=res.timings["explicit.kernel_steps"],
                            launches=launches))
        return res, seconds

    a, ta = run("tria f32", mesh, dbc, p, EXPLICIT_STEPS, dev, f32, **kw)
    b, _ = run("tria f32 again", mesh, dbc, p, EXPLICIT_STEPS, dev, f32,
               **kw)
    half_steps = EXPLICIT_STEPS // 2
    half, th = run("tria f32 first half", mesh, dbc, p, half_steps, dev, f32,
                   **kw)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "state.npz")
        save_state(path, ExplicitState(disp=half.disp,
                                       disp_prev=half.disp_prev,
                                       velo=half.velo, step=half_steps))
        state = load_state(path)
    rest, _ = run("tria f32 resumed", mesh, dbc, p,
                  EXPLICIT_STEPS - half_steps, dev, f32, init_state=state,
                  **kw)
    c, t64 = run("tria f64", mesh, dbc, p, EXPLICIT_STEPS, dev,
                 torch.float64, **kw)
    repeat = _same(a, b)
    resumed = _same(rest, a, ("disp", "disp_prev", "velo", "acce")) \
        and np.array_equal(np.concatenate([half.probe_history,
                                           rest.probe_history]),
                           a.probe_history)
    # each probe column against the f64 range of its kind (displacements,
    # velocities): a component that hardly moves has no range of its own
    h32, h64 = a.probe_history.astype(np.float64), c.probe_history
    n_p = len(p.probe_dofs)
    scale = np.repeat([np.abs(h64[:, :n_p]).max(), np.abs(h64[:, n_p:]).max()],
                      n_p)
    rel = np.abs(h32 - h64).max(axis=0) / scale
    ms_step = 1e3 * (ta - th) / (EXPLICIT_STEPS - half_steps)
    _phase("explicit", preset="tria", cells=[nx, ny], nodes=mesh.n_node,
           elements=mesh.n_elem, steps=EXPLICIT_STEPS,
           bit_identical_repeat=repeat, bit_identical_resume=resumed,
           f32_vs_f64_probe_rel=rel.tolist(), bound=EXPLICIT_F32_VS_F64,
           probe_range_f64=scale.tolist(), seconds_f32=ta, seconds_f64=t64,
           ms_per_step_f32=ms_step, ms_per_step_f64_with_setup=1e3 * t64
           / EXPLICIT_STEPS, finite=bool(np.isfinite(a.disp).all()))
    _check(repeat, "explicit f32 run does not repeat bit for bit")
    _check(resumed, "explicit resume differs from the uninterrupted run")
    _check(bool(np.isfinite(h32).all()) and scale.min() > 0
           and a.probe_history.shape == (EXPLICIT_STEPS, 4),
           "explicit probes")
    _check(float(rel.max()) <= EXPLICIT_F32_VS_F64,
           f"explicit f32 vs f64 probes: {rel}")
    single = {"ms_per_step": ms_step, torch.float32: a, torch.float64: c}

    q = presets.QUAD_EXPLICIT
    qx, qy = QUAD_CELLS
    qmesh = generate.rect_quad(0, 10, qx, 0, 2, qy)
    qkw = dict(force_bc=_edge_loads(qmesh, 1e3), probe_dofs=(2 * qx + 1,))
    (qc, _), (qg, tq) = (run(f"quad (hourglass) f64 {d}", qmesh,
                             _clamped(qmesh), q, QUAD_STEPS, d,
                             torch.float64, **qkw)
                         for d in ("cpu", dev))
    qrel = float(np.abs(qg.disp - qc.disp).max() / np.abs(qc.disp).max())
    _phase("explicit", preset="quad (hourglass)", cells=[qx, qy],
           steps=QUAD_STEPS, card_vs_cpu_rel=qrel, bound=0.0,
           bit_identical=_same(qg, qc), seconds=tq,
           u_max=float(np.abs(qc.disp).max()))
    _phase("explicit", b3_launches=counted)
    _check(_same(qg, qc) and np.abs(qc.disp).max() > 0,
           f"quad preset card vs CPU: {qrel}")
    single["b3_launches"] = counted
    return single


def _b3_step(mesh, dbc, preset, device, dtype, b, state):
    """One step of explicit_dynamics from `state` under the constant body
    force b: (result, what the step computed its forces with).  On the
    card that is the loop's own kernel B3 step (`ExplicitStep`), on the CPU
    the forces `apply_residual` (`quad_hg_residual` under the preset's
    use_hourglass) returned, element-major."""
    from unittest import mock
    from pfemfort_tpu_torch.dynamics import explicit as explicit_mod

    seen = []

    class Kept(explicit_cuda.ExplicitStep):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)

    residual = "quad_hg_residual" if preset.use_hourglass \
        else "apply_residual"
    plain = getattr(explicit_mod, residual)

    def kept_residual(*args, **kwargs):
        fe = plain(*args, **kwargs)
        seen.append(fe)
        return fe

    on_card = torch.device(device).type == "cuda"
    with mock.patch.object(explicit_mod, *(("ExplicitStep", Kept) if on_card
                                           else (residual, kept_residual))):
        res = explicit_dynamics(
            mesh, dbc, preset.E, preset.nu, preset.dens, preset.dt, 1,
            bforce_fn=lambda t: b, thickness=preset.thickness,
            use_hourglass=preset.use_hourglass, device=device, dtype=dtype,
            init_state=state)
    if on_card:
        return res, seen[0]
    npe, nd = mesh.conn.shape[1], mesh.ndim
    return res, seen[0].reshape(npe, nd, -1).permute(2, 0, 1).reshape(-1)


def _b3_case(dev, smi, peak, label, mesh, dbc, preset, dtype, b, state):
    """One B3 case of phase 9b: the card's step against the CPU's from the
    same state, bit for bit (the element pass's forces, and the new
    displacements and velocities of the node pass), the launches of the
    shape's own library (`_b3_library`), and each pass's device us beside
    its bytes at the card's HBM peak.  Under the preset's use_hourglass the
    element pass is the hourglass pass, which reads the velocities too,
    and the node pass the velocity form's, whose carry is the half-step
    velocity (u^n - u^{n-1}) / dt."""
    nd, E, npe = mesh.ndim, mesh.n_elem, mesh.conn.shape[1]
    hg = preset.use_hourglass
    size = torch.tensor([], dtype=dtype).element_size()
    cpu, fe_cpu = _b3_step(mesh, dbc, preset, "cpu", dtype, b.cpu(), state)
    library = explicit_cuda.kernel(*_b3_library(mesh, dtype, hg)[:4],
                                   hourglass=hg)
    before = dict(library.entry_launches)
    card, step = _b3_step(mesh, dbc, preset, dev, dtype, b.to(dev), state)
    launched = {k: v - before.get(k, 0)
                for k, v in library.entry_launches.items()}
    ud, upd, vd = (torch.as_tensor(a, dtype=dtype, device=dev)
                   for a in (state.disp, state.disp_prev, state.velo))
    carry = (ud - upd) / torch.as_tensor(preset.dt, dtype=dtype,
                                         device=dev) if hg else upd
    fe = step.forces(ud, vd, None)
    differ = {"forces": int((fe.cpu() != fe_cpu).sum()),
              "disp": int((card.disp != cpu.disp).sum()),
              "velo": int((card.velo != cpu.velo).sum())}
    n_full = mesh.n_node * nd
    if hg:
        # read: node ids, the five values of geometry, u, v; write: Fe.
        # read: offsets, the plan's entries, Fe, fext, M, upd (bytes), u,
        # w; write: u, w, v
        bytes_el = E * (npe * 4 + 5 * size + npe * nd * size) \
            + 2 * n_full * size
        node_vectors = 7
    else:
        # read: node ids, gradN, dvol, u; write: Fe.  read: offsets, the
        # plan's entries, Fe, fext, M, upd (bytes), u, u_prev; write: u, v
        G = step.element.gradN.shape[0]
        bytes_el = E * (npe * 4 + G * (nd * npe + 1) * size
                        + npe * nd * size) + n_full * size
        node_vectors = 6
    bytes_node = (mesh.n_node + 1) * 4 + E * npe * 4 + E * npe * nd * size \
        + n_full * (node_vectors * size + 1)
    times, hidden, cold = {}, {}, {}
    scratch = torch.empty(2 * int(COLD_L2_BELOW_BYTES) // 4,
                          dtype=torch.float32, device=dev)
    for name, fn in (("element", lambda: step.forces(ud, vd, None)),
                     ("node", lambda: step.update(fe, ud, carry)),
                     ("step", lambda: step(ud, carry, vd, None))):
        fn()
        times[name], hidden[name] = _device_ms(fn, reps=50)
        cold[name] = _each_device_ms(fn, scratch)
    del scratch
    bound = {k: v / (peak * 1e9) * 1e3 for k, v in (
        ("element", bytes_el), ("node", bytes_node),
        ("step", bytes_el + bytes_node))}
    case = dict(case=label, dtype=str(dtype)[6:], elements=E, dofs=n_full,
                differ_from_cpu=differ, launches=launched,
                device_us={k: 1e3 * v for k, v in times.items()},
                cold_l2_device_us={k: 1e3 * v for k, v in cold.items()},
                host_hidden=hidden,
                bound_us={k: 1e3 * v for k, v in bound.items()},
                bytes={"element": bytes_el, "node": bytes_node},
                cold_l2_share_of_bound={k: bound[k] / cold[k]
                                        for k in bound})
    _phase("explicit_b3", card=smi, **case)
    _check(not any(differ.values()),
           f"B3 {label} {dtype} differs from the CPU's step: {differ}")
    _check(launched == {"explicit_step_element": 1, "explicit_step_node": 1},
           f"B3 {label} {dtype}: the step's launches of its library "
           f"{launched}")
    return case


def _explicit_b3(dev, single, smi, peak):
    """Phase 9b: kernel B3 as explicit_dynamics builds it, one step on the
    card against the same step on the CPU, bit for bit, and each pass's
    device time beside the bytes it must move: phase 9's tria case from
    phase 9's last states, the explicit benchmark cell's 1,572,864 tetra4
    box and the hourglass cell's 4096 x 2048 quad4 plate from seeded
    states, each in float32 and float64."""
    out = {"name": "explicit_step", "route": "cuda",
           "source": "pfemfort_tpu_torch/csrc/explicit_step.cu",
           "replaces": None, "cases": []}
    p = presets.TRIA_EXPLICIT
    nx, ny = EXPLICIT_CELLS
    tria = generate.rect_tria(0, 10, nx, 0, 2, ny)
    for dtype in (torch.float32, torch.float64):
        r = single[dtype]
        state = ExplicitState(disp=r.disp, disp_prev=r.disp_prev,
                              velo=r.velo, step=EXPLICIT_STEPS)
        out["cases"].append(_b3_case(
            dev, smi, peak, f"tria3 {nx}x{ny}", tria, _clamped(tria), p,
            dtype, torch.tensor(p.bforce, dtype=dtype), state))
    # the cell's box (benchmark/configs/elastodynamics3d_box64.json): 16 a
    # side, 64 cells, x = 0 clamped, the prism preset's material, dt and
    # body force
    n = B3_BOX_CELLS
    box, _ = generate.box_tet(0, 16, n, 0, 16, n, 0, 16, n)
    cell = presets.PRISM_EXPLICIT
    rng = np.random.default_rng(21)
    n_full = box.n_node * 3
    fixed = _clamped(box)[:, :2].astype(np.int64) @ np.array([3, 1])
    u = 1e-4 * rng.standard_normal((2, n_full))
    u[:, fixed] = 0.0
    for dtype in (torch.float32, torch.float64):
        state = ExplicitState(disp=u[0], disp_prev=u[1],
                              velo=np.zeros(n_full), step=0)
        out["cases"].append(_b3_case(
            dev, smi, peak, f"tetra4 box {n}^3", box, _clamped(box), cell,
            dtype, torch.tensor(cell.bforce, dtype=dtype), state))
    # the hourglass cell's plate
    # (benchmark/configs/elastodynamics2d_quadhg_4096x2048.json): h = 0.006,
    # x = 0 clamped, the quad preset's material, thickness and dt (the
    # configuration's), a body force to load the pass's body-force term
    qx, qy = HG_PLATE_CELLS
    plate = generate.rect_quad(0, qx * 0.006, qx, 0, qy * 0.006, qy)
    q = presets.QUAD_EXPLICIT
    n_full = plate.n_node * 2
    fixed = _clamped(plate)[:, :2].astype(np.int64) @ np.array([2, 1])
    u = 1e-4 * rng.standard_normal((3, n_full))
    u[2] *= 1e4                                # velocities of ~1 m/s
    u[:, fixed] = 0.0
    for dtype in (torch.float32, torch.float64):
        state = ExplicitState(disp=u[0], disp_prev=u[1], velo=u[2], step=0)
        out["cases"].append(_b3_case(
            dev, smi, peak, f"hourglass quad4 plate {qx}x{qy}", plate,
            _clamped(plate), q, dtype,
            torch.tensor([0.0, -9.81], dtype=dtype), state))
    cell_f32, plate_f32 = out["cases"][2], out["cases"][4]
    out.update(shape=f"tetra4 box {n}^3, {box.n_elem} elements, float32 "
                     f"(the explicit cell's)",
               device_us=cell_f32["cold_l2_device_us"]["step"],
               warm_device_us=cell_f32["device_us"]["step"],
               bound_us=cell_f32["bound_us"]["step"], bound_by="bytes",
               hourglass={"shape": f"quad4 plate {qx}x{qy}, "
                                   f"{plate.n_elem} elements, float32 (the "
                                   f"hourglass cell's)",
                          "device_us": plate_f32["cold_l2_device_us"],
                          "warm_device_us": plate_f32["device_us"],
                          "bound_us": plate_f32["bound_us"]})
    return out


@contextlib.contextmanager
def _cli_batch(jobs):
    """Start `python -m pfemfort_tpu_torch` once for each (label, argv) of
    `jobs`, all at once (they share the card and the host's cores), and
    yield a function that waits for one label's process and returns
    (CompletedProcess, seconds since the batch started).  Every process
    still running when the block ends is killed."""
    t0 = time.perf_counter()
    procs = {label: subprocess.Popen(
        [sys.executable, "-m", "pfemfort_tpu_torch", *argv], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for label, argv in jobs}

    def result(label):
        p = procs[label]
        out, err = p.communicate(timeout=600)
        return (subprocess.CompletedProcess(p.args, p.returncode, out, err),
                time.perf_counter() - t0)

    try:
        yield result
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


def _cli(dev):
    """The port's command line as a user runs it, in subprocesses (the
    two solves at once)."""
    with tempfile.TemporaryDirectory() as tmp:
        prefix = str(Path(tmp) / "beam")
        subprocess.run([sys.executable, "-m", "pfemfort_tpu_torch",
                        "genmesh", "tria", "0", "2", "256", "0", "1", "128",
                        "-o", prefix], cwd=ROOT, check=True,
                       capture_output=True, timeout=600)
        mesh = mesh_io.read_mesh(prefix + "-nodes.dat", prefix + "-elems.dat")
        mesh_io.write_dat(prefix, mesh, dirichlet=_clamped(mesh),
                          force=_edge_loads(mesh))
        files = [prefix + s for s in ("-nodes.dat", "-elems.dat",
                                      "-DirichBC.dat", "-ForceBC.dat")]
        probe = Path(tmp) / "probe.dat"
        jobs = [("elasticity", ["elasticity", *files, "--device", dev.type,
                                "-o", str(Path(tmp) / "u.vtk")]),
                ("explicit", ["explicit", *files[:3], "--preset", "tria",
                              "--nsteps", "1000", "--device", dev.type,
                              "--probe-out", str(probe),
                              "-o", str(Path(tmp) / "x.vtk")])]
        with _cli_batch(jobs) as result:
            for label, _ in jobs:
                proc, secs = result(label)
                _check(proc.returncode == 0,
                       f"pfemfort_tpu_torch {label} exited "
                       f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
                out = proc.stdout
                if label == "elasticity":
                    line = next((ln for ln in out.splitlines()
                                 if "Convergence in" in ln), None)
                    _phase("cli", subcommand="elasticity", seconds=secs,
                           output=out.strip().splitlines())
                    _check(line is not None,
                           "CLI elasticity printed no convergence line")
                else:
                    hist = np.loadtxt(probe)
                    _phase("cli", subcommand="explicit", seconds=secs,
                           output=out.strip().splitlines(),
                           probe_shape=hist.shape)
                    _check("1000 steps in" in out and hist.shape == (1000, 5)
                           and bool(np.isfinite(hist).all()),
                           "CLI explicit output")


def _guard_plain_spmv():
    """Count plain SpMV calls on card tensors inside the kernel wrappers
    and the sharded solve's routing."""
    for mod, name in ((dia_spmv_cuda, "spmv_dia"),
                      (dia_spmv_cuda, "spmv_dia_halo_local"),
                      (ell_spmv_cuda, "spmv_sliced"),
                      (shard_cg, "spmv_dia_halo")):
        plain = getattr(mod, name)

        def counted(*args, plain=plain, name=name):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                PLAIN_ON_CARD[name] += 1
            return plain(*args)

        setattr(mod, name, counted)


def _stage_seconds(r):
    return stage_seconds(r.timings)


def _per_iter(r, launches):
    """Launches and ms per Krylov iteration of one counted solve."""
    it = max(r.stats.iters, 1)
    return dict(launches_per_iter={k: v / it for k, v in launches.items()},
                ms_per_iter=1e3 * r.timings["solve_s"] / it,
                time_to_solution_s=_stage_seconds(r))


@contextlib.contextmanager
def _shapes_recorded(into):
    """Count the kernels' launches by shape into the Counter `into` while
    the block runs, keyed as _shape_key keys a matrix.  Each launch still
    counts in its kernel's own total, once."""
    for name, k in KERNELS.items():
        def launch(entry, *args, name=name, inner=k.launch):
            # dia: (vals, plan, ...), the plan holding n and D; ell: (vals,
            # cols, slice_ptr, n_rows, n_cols, ...), and the widest slice
            # of the block, the wrapper's `A`, tells two blocks of one size
            # apart; the entry's suffix is the dtype
            if name == "dia_spmv":
                key = (entry, int(args[1].n), int(args[1].n_diag))
            else:
                key = (entry, int(args[3]), int(args[4]),
                       sys._getframe(1).f_locals["A"].max_width)
            into[key] += 1
            return inner(entry, *args)
        k.launch = launch
    try:
        yield into
    finally:
        for k in KERNELS.values():
            del k.launch


def _shape_key(A):
    """The launch key of one product with A (see _shapes_recorded)."""
    suffix = {torch.float32: "f32", torch.float64: "f64"}[A.vals.dtype]
    if isinstance(A, DIAMatrix):
        return (f"dia_spmv_{suffix}", A.n_rows, len(A.offsets))
    return (f"ell_spmv_{suffix}", A.n_rows, A.n_cols, A.max_width)


def _check_pc(label, r, launches, on):
    _check(r.timings.get("precond_used") == r.timings.get(
        "precond_requested"), f"{label}: precond {r.timings}")
    _check(r.stats.converged and r.stats.relres <= 1e-6, f"{label}: "
           f"{r.stats}")
    _check(bool(np.isfinite(r.u_full).all()), f"{label}: non-finite u")
    _check(launches[on] >= r.stats.iters, f"{label}: launches {launches}")
    _check(not PLAIN_ON_CARD, f"{label}: plain SpMVs on the card "
           f"{dict(PLAIN_ON_CARD)}")


def _mg(dev, counted):
    """Phase 11: the full system under geometric multigrid; the rows of
    every B1 launch are recorded to show each smoothing level ran on it."""
    n = N_FLAGSHIP
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    rows = collections.Counter()
    launch = sparse_ops.dia_spmv

    def recorded(A, x):
        rows[A.n_rows] += 1
        return launch(A, x)

    run = lambda: solve_poisson(mesh, dbc, device=dev, dtype=torch.float32,
                                rtol=1e-6, maxiter=100, bc_mode="full",
                                precond="mg")
    sparse_ops.dia_spmv = recorded
    try:
        r, launches = _counted(run, counted, "box_tet n=96 full f32 mg")
    finally:
        sparse_ops.dia_spmv = launch
    # a second run times the cycle once its kernels are loaded
    warm, _ = _counted(run, counted)
    levels = r.timings["mg_levels"]
    nodal_err = float(np.abs(r.u_full - (mesh.coords ** 2).sum(1)).max())
    _phase("mg", n=n, dofs=mesh.n_node, iters=r.stats.iters,
           relres=r.stats.relres, nodal_err=nodal_err, levels=levels,
           b1_launches_by_rows={str(k): v for k, v in sorted(rows.items())},
           launches=launches, **_per_iter(r, launches), **r.timings,
           warm_solve_s=warm.timings["solve_s"],
           warm_ms_per_iter=1e3 * warm.timings["solve_s"] / warm.stats.iters)
    _check_pc("mg", r, launches, "dia_spmv")
    _check(abs(r.stats.iters - MG_ITERS) <= MG_SLACK,
           f"mg: {r.stats.iters} iterations, not {MG_ITERS} +- {MG_SLACK}")
    _check(nodal_err <= NODAL_ERR_MAX, f"mg: nodal error {nodal_err}")
    _check(warm.stats == r.stats, f"mg: a second run gave {warm.stats}")
    _check(len(levels) == MG_LEVELS and all(rows[m] > 0
                                            for m in levels[:-1]),
           f"mg: levels {levels}, B1 launches by rows {dict(rows)}")
    return r


def _cheby_ic0(dev, counted, jacobi):
    """Phase 12: Chebyshev and IC(0) on the reduced lattice system."""
    n = N_FLAGSHIP
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    out = {}
    for pc, jax_iters in PC_JAX_CPU_ITERS.items():
        amg_device.route_calls.clear()
        r, launches = _counted(lambda: solve_poisson(
            mesh, dbc, device=dev, dtype=torch.float32, rtol=1e-6,
            precond=pc), counted, f"box_tet n=96 f32 {pc}")
        nodal_err = float(np.abs(r.u_full - (mesh.coords ** 2).sum(1)).max())
        _phase(pc, n=n, iters=r.stats.iters, relres=r.stats.relres,
               jacobi_iters=jacobi.stats.iters, jax_cpu_f64_iters=jax_iters,
               jax_cpu_f32_iters=PC_JAX_CPU_F32_ITERS[pc],
               under_0p7_jacobi=r.stats.iters < 0.7 * jacobi.stats.iters,
               nodal_err=nodal_err, launches=launches,
               routes=dict(amg_device.route_calls), **_per_iter(r, launches),
               **r.timings)
        _check_pc(pc, r, launches, "dia_spmv")
        _check(r.stats.iters < jacobi.stats.iters,
               f"{pc}: {r.stats.iters} iterations, Jacobi "
               f"{jacobi.stats.iters}")
        _check(abs(r.stats.iters - jax_iters) <= PC_BAND * jax_iters,
               f"{pc}: {r.stats.iters} iterations, JAX on the CPU "
               f"{jax_iters}")
        _check(nodal_err <= NODAL_ERR_MAX, f"{pc}: nodal error {nodal_err}")
        out[pc] = (r, launches)
    return out


def _amg(dev, counted):
    """Phase 13: SA-AMG on the renumbered n=96 ELL system, and Jacobi on
    the same system."""
    pmesh, pdbc = _permuted_box(N_FLAGSHIP, seed=2)
    u_exact = (pmesh.coords ** 2).sum(1)
    out = {}
    for pc in ("amg", "jacobi"):
        amg_device.route_calls.clear()
        r, launches = _counted(lambda: solve_implicit(
            pmesh, 1, pdbc, _poisson_fn, device=dev, dtype=torch.float32,
            rtol=1e-6, recover=False, precond=pc), counted,
            f"renumbered n=96 rng(2) f32 {pc}")
        routes = dict(amg_device.route_calls)
        nodal_err = float(np.abs(r.u_full - u_exact).max())
        _phase("amg", precond=pc, iters=r.stats.iters,
               relres=r.stats.relres, nodal_err=nodal_err,
               launches=launches, routes=routes,
               b2_rectangular_launches=routes.get("ell_rect", 0),
               **_per_iter(r, launches), **r.timings)
        _check(r.stats.converged and r.stats.relres <= 1e-6
               and nodal_err <= NODAL_ERR_MAX, f"amg phase {pc}: {r.stats}")
        # the float32 fine operator is the hybrid: lex order, 15 dense
        # diagonals, no remainder, so B1 carries every fine-level product
        _check(launches["dia_spmv"] >= r.stats.iters + 1
               and r.timings.get("hybrid_diagonals") == 15
               and r.timings.get("hybrid_nnz_rem") == 0 and not PLAIN_ON_CARD,
               f"amg phase {pc}: launches {launches}, {r.timings}")
        out[pc] = (r, launches, routes)
    _check(out["jacobi"][1]["ell_spmv"] == 0,
           f"amg phase jacobi: B2 launched {out['jacobi'][1]}")
    r, launches, routes = out["amg"]
    _check_pc("amg", r, launches, "ell_spmv")
    _check(r.stats.iters <= AMG_ITERS_MAX,
           f"amg: {r.stats.iters} iterations > {AMG_ITERS_MAX}")
    _check(routes.get("ell_rect", 0) >= 2 * r.stats.iters,
           f"amg: the transfers did not launch B2 ({routes})")
    _phase("amg", time_to_solution_s={
        pc: _stage_seconds(o[0]) for pc, o in out.items()},
        amg_over_jacobi=_stage_seconds(out["amg"][0])
        / _stage_seconds(out["jacobi"][0]))
    return out


def _elasticity_mg(dev, counted, el3):
    """Phase 14: the elasticity3d system, full, under geometric MG."""
    n = N_EL3D
    mesh, _ = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    dbc = _clamped(mesh)
    r, launches = _counted(lambda: solve_elasticity(
        mesh, dbc, E_EL, NU_EL, bforce=(0.1, 0.0, 0.0), device=dev,
        dtype=torch.float32, rtol=1e-6, bc_mode="full", precond="mg"),
        counted, "elasticity3d full f32 mg")
    u64 = el3[torch.float64].u_full
    rel = float(np.abs(r.u_full - u64).max() / np.abs(u64).max())
    bar = EL_MG_FRACTION * el3[torch.float32].stats.iters
    _phase("elasticity_mg", n=n, iters=r.stats.iters, relres=r.stats.relres,
           jacobi_f32_iters=el3[torch.float32].stats.iters, bar=bar,
           rel_to_f64_reduced=rel, bound=EL3D_F32_VS_F64, launches=launches,
           **_per_iter(r, launches), **r.timings)
    _check_pc("elasticity_mg", r, launches, "dia_spmv")
    _check(r.stats.iters < bar, f"elasticity_mg: {r.stats.iters} >= {bar}")
    _check(rel <= EL3D_F32_VS_F64, f"elasticity_mg vs f64: {rel}")
    return r, launches


def _large(dev, counted):
    """Phase 15: the 48M-element box: float32 Jacobi-CG and the refined
    float64 solve, with peak device memory."""
    n = N_LARGE
    t0 = time.perf_counter()
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    mesh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    to_element_minor(mesh.elem_coords())
    coords_s = time.perf_counter() - t0
    u_exact = (mesh.coords ** 2).sum(1)
    out = {}
    for label, kw in (("f32", dict(dtype=torch.float32, rtol=1e-6)),
                      ("refined", dict(refine=True, rtol=LARGE_RELRES))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        r, launches = _counted(lambda: solve_poisson(mesh, dbc, device=dev,
                                                     **kw), counted,
                               f"box_tet n=200 {label}")
        peak = torch.cuda.max_memory_allocated()
        nodal_err = float(np.abs(r.u_full - u_exact).max())
        _phase("large", run=label, n=n, elements=mesh.n_elem,
               dofs=int(r.u_reduced.numel()), iters=r.stats.iters,
               relres=r.stats.relres, nodal_err=nodal_err,
               peak_device_bytes=peak, mesh_s=mesh_s,
               elem_coords_to_element_minor_s=coords_s, launches=launches,
               **_per_iter(r, launches), **r.timings)
        _check(r.stats.converged and bool(np.isfinite(r.u_full).all())
               and launches["dia_spmv"] >= r.stats.iters
               and launches["ell_spmv"] == 0 and not PLAIN_ON_CARD,
               f"large {label}: {r.stats}, launches {launches}")
        out[label] = (r, launches)
    r32, r64 = out["f32"][0], out["refined"][0]
    _check(abs(r32.stats.iters - LARGE_ITERS) <= LARGE_SLACK,
           f"large f32: {r32.stats.iters} iterations, not {LARGE_ITERS} +- "
           f"{LARGE_SLACK}")
    _check(r64.stats.relres <= LARGE_RELRES
           and float(np.abs(r64.u_full - u_exact).max()) <= LARGE_NODAL_ERR,
           f"large refined: relres {r64.stats.relres}")
    return out, mesh, dbc


def _csr_of_ell(A: ELLMatrix):
    """Host CSR (indptr, indices, float64 vals) of an ELL matrix whose
    columns ascend per row with sentinels last."""
    cols, vals = A.cols.cpu().numpy(), A.vals.cpu().double().numpy()
    valid = cols < A.n_cols
    indptr = np.zeros(A.n_rows + 1, np.int64)
    np.cumsum(valid.sum(1), out=indptr[1:])
    return indptr, cols[valid], vals[valid]


def _to(A: ELLMatrix, dev):
    return ELLMatrix(cols=A.cols.to(dev), vals=A.vals.to(dev),
                     n_cols=A.n_cols)


def _preconditioner_blocks(dev, errs, rng, A_ord):
    """Phase 16: the preconditioners' blocks at the main path's shapes, each
    kernel against its plain version.  Returns {label: matrix} (the ELL
    blocks sliced)."""
    t0 = time.perf_counter()
    indptr, indices, vals = _csr_of_ell(unslice(A_ord))
    n = A_ord.n_rows
    arrs, meta = build_samg(indptr, indices, vals, n, ndof=1,
                            dtype=torch.float32, device="cpu")
    amg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ic0 = build_ic0_from_csr(indptr, indices, vals, n, dtype=torch.float32,
                             device="cpu")
    ic0_s = time.perf_counter() - t0
    blocks = {"amg P0": _to(arrs.p0[0], dev), "amg P0^T": _to(arrs.p0t[0], dev),
              "ic0 T": _to(ic0.t, dev)}
    _phase("kernel", case="preconditioner set-up, renumbered n=96 in its "
           "solve's row order", amg_levels=list(meta.sizes),
           amg_setup_s=amg_s, ic0_setup_s=ic0_s,
           t_sentinel_rows=int((ic0.t.cols >= n).all(1).sum()))

    m = N_FLAGSHIP
    mesh, dbc = generate.box_tet(0, 1, m, 0, 1, m, 0, 1, m)
    bc = np.zeros(mesh.n_node, bool)
    bc[dbc[:, 0].astype(np.int64)] = True
    arrays, gmeta = build_gmg(mesh, 1, bc, _poisson_fn, dtype=torch.float32,
                              device=dev)
    blocks["gmg 13^3 level"] = arrays.mats[-1]
    plan = structured.build_structured_plan(m, m, m)
    coords = torch.as_tensor(to_element_minor(mesh.elem_coords()),
                             dtype=torch.float32, device=dev)
    Ke, Fe = _poisson_fn(coords)
    A_full, _ = zero_dirichlet_rows(
        structured.assemble_dia_structured(Ke, plan),
        structured.assemble_rhs_structured(Fe, plan),
        torch.as_tensor(bc, device=dev),
        torch.zeros(mesh.n_node, dtype=torch.float32, device=dev))
    del Ke, Fe, coords
    blocks["full system"] = A_full
    _check(gmeta.shapes[-1] == (13, 13, 13), f"gmg levels {gmeta.shapes}")
    for label, A in blocks.items():
        _kernel_errors(label, A, errs, rng)
    return {label: ell_to_sliced(A) if isinstance(A, ELLMatrix) else A
            for label, A in blocks.items()}


def _cli_preconditioners(dev):
    """Phase 17: the new command-line options as subprocesses, at once."""
    with tempfile.TemporaryDirectory() as tmp:
        prefix = str(Path(tmp) / "box")
        subprocess.run([sys.executable, "-m", "pfemfort_tpu_torch",
                        "genmesh", "tet", "0", "1", "32", "0", "1", "32",
                        "0", "1", "32", "-o", prefix], cwd=ROOT, check=True,
                       capture_output=True, timeout=600)
        opts = Path(tmp) / "petsc_options.dat"
        opts.write_text("-ksp_type cg\n-pc_type gamg\n-ksp_rtol 1e-8\n")
        files = [prefix + s for s in ("-nodes.dat", "-elems.dat",
                                      "-DirichBC.dat")]
        jobs = [("poisson " + " ".join(extra[:2]),
                 ["poisson", *files, "--device", dev.type, *extra])
                for extra in (["--bc-mode", "full", "--precond", "mg"],
                              ["--refine"], ["--options-file", str(opts)])]
        with _cli_batch(jobs) as result:
            for label, argv in jobs:
                proc, secs = result(label)
                out = proc.stdout.strip().splitlines()
                _phase("cli", subcommand=label, seconds=secs,
                       exit=proc.returncode, output=out)
                _check(proc.returncode == 0
                       and any("Convergence in" in ln for ln in out),
                       f"CLI {label}: {proc.stdout}{proc.stderr}")


def _pattern_native():
    """Phase 18, first part: the host library's ELL pattern builder against
    the numpy builder on the renumbered n=32 box, every array bit for bit."""
    mesh, dbc = _permuted_box(32)
    dm = build_dofmap(mesh, 1, dbc)
    t0 = time.perf_counter()
    a = pattern_mod.build_pattern(dm.elem_dof, dm.total_dof, layout="ell")
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = pattern_mod._ell_pattern_numpy(dm.elem_dof, dm.total_dof, 8,
                                       a.rhs_dest)
    numpy_s = time.perf_counter() - t0
    fields = ("indptr", "indices", "ell_cols", "mat_perm", "mat_segids")
    same = all(np.array_equal(getattr(a, f), getattr(b, f))
               and getattr(a, f).dtype == getattr(b, f).dtype
               for f in fields) \
        and (a.ell_k, a.nnz, a.mat_nsegs) == (b.ell_k, b.nnz, b.mat_nsegs)
    _phase("pattern_native", case="renumbered box_tet n=32", rows=dm.total_dof,
           nnz=a.nnz, k=a.ell_k, entries=len(a.mat_perm),
           bit_identical_to_numpy=same, native_s=native_s, numpy_s=numpy_s)
    _check(same, "the native ELL pattern differs from the numpy builder")


def _timed_delaunay(n):
    t0 = time.perf_counter()
    md, dd = _scrambled_delaunay(n)
    return md, dd, time.perf_counter() - t0


def _delaunay_f32(dev, counted, errs, rng, mesh_future):
    """Phase 19: the scrambled Delaunay mesh at 205,379 rows in float32:
    the hybrid has dense diagonals and a remainder, so the solve launches
    B1 and B2; the hybrid against the plain ELL product of the same ordered
    system, and each part against its plain version.  The mesh comes from
    `mesh_future`: qhull releases the GIL, so main() builds it in a thread
    while the card runs the phases before this one."""
    t0 = time.perf_counter()
    md, dd, mesh_s = mesh_future.result()
    mesh_wait_s = time.perf_counter() - t0
    r, launches = _counted(lambda: solve_poisson(
        md, dd, device=dev, dtype=torch.float32, rtol=1e-6), counted,
        f"Delaunay n={N_DELAUNAY_F32} f32 hybrid")
    t = r.timings
    nodal_err = float(np.abs(r.u_full - (md.coords ** 2).sum(1)).max())
    _phase("hybrid", case=f"scrambled Delaunay n={N_DELAUNAY_F32} f32 Jacobi",
           nodes=md.n_node, elements=md.n_elem,
           rows=int(r.u_reduced.numel()), iters=r.stats.iters,
           relres=r.stats.relres, nodal_err=nodal_err, launches=launches,
           mesh_s=mesh_s, mesh_wait_s=mesh_wait_s,
           **_per_iter(r, launches), **t)
    _check(r.stats.converged and r.stats.relres <= 1e-6
           and bool(np.isfinite(r.u_full).all()), f"delaunay f32: {r.stats}")
    _check(r.u_reduced.numel() >= 200_000 and t.get("hybrid_diagonals", 0) > 0
           and t.get("hybrid_nnz_rem", 0) > 0
           and launches["dia_spmv"] == r.stats.iters + 2
           and launches["ell_spmv"] == r.stats.iters + 2,
           f"delaunay f32 did not run both parts: {launches} {t}")

    # the same system: ordered ELL, its hybrid split, their products
    dofmap = build_dofmap(md, 1, dd)
    assemble = build_reduced_assembler(md, 1, dofmap, _poisson_fn,
                                       torch.float32, dev)
    A0, b0 = assemble(torch.as_tensor(to_element_minor(md.elem_coords()),
                                      dtype=torch.float32, device=dev))
    ordering = build_ell_ordering(assemble.pattern,
                                  md.coords[dofmap.assy_for_soln],
                                  dofmap.assy_for_soln % 1, dev, hybrid=True)
    A_ord, _ = ordering.system(A0, b0)
    H = ordering.hybrid.pack(A0.vals)
    x = torch.as_tensor(rng.standard_normal(A_ord.n_rows),
                        dtype=torch.float32, device=dev)
    abs_err, rel_err = _errors(hybrid.apply_hybrid(H, x),
                               spmv_sliced(A_ord, x))
    errs[("hybrid", "delaunay f32", torch.float32)] = abs_err
    _phase("kernel", kernel="hybrid (B1 + B2)", case=f"scrambled Delaunay "
           f"n={N_DELAUNAY_F32} in its solve's row order", rows=A_ord.n_rows,
           diagonals=len(H.dia.offsets), k_rem=t["hybrid_k_rem"],
           rem_max_width=H.rem.max_width, k=assemble.pattern.ell_k,
           max_width=A_ord.max_width,
           ordering=ordering.name, max_abs_err=abs_err, max_rel_err=rel_err,
           bound=REL_ERR_MAX[torch.float32])
    _check(rel_err <= REL_ERR_MAX[torch.float32],
           f"hybrid vs plain ELL: rel err {rel_err}")
    _kernel_errors("delaunay hybrid dense diagonals", H.dia, errs, rng)
    _kernel_errors("delaunay hybrid remainder", H.rem, errs, rng)
    return r, launches, {"delaunay hybrid B1 part": H.dia,
                         "delaunay hybrid B2 part": H.rem,
                         "delaunay ordered ELL": A_ord}


def _matfree(dev, counted, mesh, dbc, assembled):
    """Phase 20: solve_poisson(matrix_free=True) in float32: iterations,
    nodal error, ms per iteration and peak device memory; the assembled
    Jacobi solve of the same mesh (B1) beside it."""
    n = mesh.structure["nex"]
    iters, slack, nodal_bar = MATFREE_BARS[n]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r, launches = _counted(lambda: solve_poisson(
        mesh, dbc, device=dev, dtype=torch.float32, rtol=1e-6,
        matrix_free=True), counted)
    peak = torch.cuda.max_memory_allocated()
    nodal_err = float(np.abs(r.u_full - (mesh.coords ** 2).sum(1)).max())
    diff = float(np.abs(r.u_full - assembled.u_full).max())
    _phase("matfree", n=n, elements=mesh.n_elem, iters=r.stats.iters,
           relres=r.stats.relres, nodal_err=nodal_err, nodal_bar=nodal_bar,
           assembled_iters=assembled.stats.iters,
           assembled_ms_per_iter=1e3 * assembled.timings["solve_s"]
           / assembled.stats.iters, u_vs_assembled=diff,
           peak_device_bytes=peak, launches=launches,
           **_per_iter(r, launches), **r.timings)
    _check(r.stats.converged and r.stats.relres <= 1e-6
           and bool(np.isfinite(r.u_full).all())
           and abs(r.stats.iters - iters) <= slack,
           f"matfree n={n}: {r.stats}, not {iters} +- {slack}")
    _check(nodal_bar is None or nodal_err <= nodal_bar,
           f"matfree n={n}: nodal error {nodal_err}")
    _check(sum(launches.values()) == 0 and not PLAIN_ON_CARD,
           f"matfree n={n}: SpMV launches {launches}")
    return r


def _highprec(dev, counted, mesh, dbc):
    """Phase 21: solve_box_poisson_1e8 (float64 full system on the card,
    MG-preconditioned float32 inner CG, float64 outer residual on B1); the
    rows and dtype of every B1 launch are recorded."""
    n = mesh.structure["nex"]
    rows = collections.Counter()
    launch = sparse_ops.dia_spmv

    def recorded(A, x):
        rows[(A.n_rows, str(x.dtype)[6:])] += 1
        return launch(A, x)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sparse_ops.dia_spmv = recorded
    try:
        (u, st, timings), launches = _counted(
            lambda: solve_box_poisson_1e8(mesh, dbc, device=dev), counted,
            f"box_tet n={n} solve_box_poisson_1e8")
    finally:
        sparse_ops.dia_spmv = launch
    peak = torch.cuda.max_memory_allocated()
    nodal_err = float(np.abs(u - (mesh.coords ** 2).sum(1)).max())
    levels = timings["mg_levels"]
    _phase("highprec", n=n, elements=mesh.n_elem, dofs=mesh.n_node,
           outer_iters=st.outer_iters, inner_iters=st.total_inner_iters,
           jax_48m_outer_inner=JAX_48M_OUTER_INNER,
           relres_true_f64=st.relres, converged=st.converged,
           nodal_err=nodal_err, nodal_bar=HIGHPREC_NODAL[n],
           b1_launches_by_rows_and_dtype={f"{k[0]} {k[1]}": v for k, v in
                                          sorted(rows.items())},
           peak_device_bytes=peak, launches=launches, **timings)
    _check(st.converged and st.relres <= 1e-8
           and st.outer_iters <= HIGHPREC_MAX_OUTER, f"highprec n={n}: {st}")
    _check(nodal_err <= HIGHPREC_NODAL[n],
           f"highprec n={n}: nodal error {nodal_err}")
    # B1 in float32 on every smoothing level (the coarsest too when it is
    # above the dense-inverse cap, 4096 rows, and smoothed by Chebyshev),
    # in float64 on the outer residual (once per outer iteration and once
    # before the first)
    smoothed = levels if levels[-1] > 4096 else levels[:-1]
    _check(all(rows[(m, "float32")] > 0 for m in smoothed)
           and rows[(levels[0], "float64")] == st.outer_iters + 1
           and launches["ell_spmv"] == 0 and not PLAIN_ON_CARD,
           f"highprec n={n}: B1 launches {dict(rows)}, {launches}")
    return st, timings


def _cavity_bcs(mesh, lid=1.0):
    """Lid-driven cavity on [0,1]^2: u = (lid, 0) on y = 1 (its corners
    0), no slip on the other walls."""
    x, y = mesh.coords[:, 0], mesh.coords[:, 1]
    wall = np.isclose(x, 0) | np.isclose(x, 1) | np.isclose(y, 0)
    top = np.isclose(y, 1) & ~wall
    nodes = np.nonzero(wall | top)[0]
    vals = np.stack([np.where(top[nodes], lid, 0.0), np.zeros(len(nodes))], 1)
    return np.stack([np.repeat(nodes, 2), np.tile([0, 1], len(nodes)),
                     vals.reshape(-1)], 1).astype(np.float64)


def _free_slip_bcs(mesh):
    """u_d = 0 on the two faces normal to axis d, for every d."""
    X = mesh.coords
    rows = []
    for d in range(mesh.ndim):
        for v in (X[:, d].min(), X[:, d].max()):
            nodes = np.nonzero(np.isclose(X[:, d], v))[0]
            rows.append(np.stack([nodes, np.full(len(nodes), d),
                                  np.zeros(len(nodes))], 1))
    return np.concatenate(rows).astype(np.float64)


def _cfd(dev, counted):
    """Phase 22: fractional_step_ns on the card in float32: the 2D
    lid-driven cavity and the 3D Taylor-Green vortex on lattice numbering
    (pressure CG on B1), a renumbered cavity (B2)."""
    def run(label, mesh, bcs, nu, dt, steps, **kw):
        t0 = time.perf_counter()
        r, launches = _counted(lambda: fractional_step_ns(
            mesh, bcs, nu_visc=nu, dt=dt, nsteps=steps, rtol_p=CFD_RTOL_P,
            dtype=torch.float32, device=dev, **kw), counted, f"cfd {label}")
        secs = time.perf_counter() - t0
        cg = int(r.cg_iters.sum())
        # ROADMAP C.6: a step whose pressure CG hit its cap goes on
        # unconverged (both packages); count them
        capped = int((r.cg_iters >= PRESSURE_CG_MAXITER).sum())
        fields = dict(case=label, nodes=mesh.n_node, elements=mesh.n_elem,
                      nu=nu, dt=dt, steps=steps, rtol_p=CFD_RTOL_P,
                      seconds=secs,
                      ms_per_step=1e3 * secs / steps,
                      cg_iters_per_step=cg / steps,
                      cg_iters_first_last=[int(r.cg_iters[0]),
                                           int(r.cg_iters[-1])],
                      cg_steps_at_cap=capped,
                      cg_maxiter=PRESSURE_CG_MAXITER,
                      launches=launches,
                      launches_per_step={k: v / steps
                                         for k, v in launches.items()},
                      div_first=float(r.div_history[0]),
                      div_last=float(r.div_history[-1]))
        _check(bool(np.isfinite(r.velocity).all()
                    and np.isfinite(r.pressure).all()
                    and np.isfinite(r.div_history).all()),
               f"cfd {label}: non-finite state")
        # one CG per step, each iters + 1 products
        on = "ell_spmv" if "renumbered" in label else "dia_spmv"
        off = "dia_spmv" if on == "ell_spmv" else "ell_spmv"
        _check(launches[on] == cg + steps and launches[off] == 0
               and not PLAIN_ON_CARD,
               f"cfd {label}: launches {launches}, {cg} CG iterations")
        return r, fields

    nx, steps, dt, nu = CFD_CAVITY
    mesh = generate.rect_tria(0, 1, nx, 0, 1, nx)
    dt_bound = (1.0 / nx) ** 2 / (4 * nu)
    r, fields = run(f"lid-driven cavity rect_tria {nx}x{nx}", mesh,
                    _cavity_bcs(mesh), nu, dt, steps)
    speed = float(np.linalg.norm(r.velocity, axis=1).max())
    d = r.div_history
    _phase("cfd", dt_viscous_bound=dt_bound, max_speed=speed, **fields)
    _check(dt <= dt_bound and speed <= 1.5 and d[-1] <= 1.5 * d[0],
           f"cfd cavity: speed {speed}, div {d[0]} -> {d[-1]}")
    out = {"cavity": fields}

    nx3, steps3, dt3, nu3 = CFD_TG3D
    mesh3, _ = generate.box_tet(0, np.pi, nx3, 0, np.pi, nx3,
                                0, np.pi / 2, nx3 // 2)
    x, y = mesh3.coords[:, 0], mesh3.coords[:, 1]
    u0 = np.stack([np.sin(x) * np.cos(y), -np.cos(x) * np.sin(y),
                   np.zeros_like(x)], axis=1)
    r3, fields = run(f"Taylor-Green box_tet {nx3}x{nx3}x{nx3 // 2}", mesh3,
                     _free_slip_bcs(mesh3), nu3, dt3, steps3, u0=u0)
    ratio = float((r3.velocity ** 2).sum() / (u0 ** 2).sum())
    expect = float(np.exp(-4 * nu3 * steps3 * dt3))
    w_max = float(np.abs(r3.velocity[:, 2]).max())
    _phase("cfd", energy_ratio=ratio, exp_minus_4_nu_t=expect, w_max=w_max,
           **fields)
    _check(0.7 * expect < ratio < 1.3 * expect and w_max < 0.05,
           f"cfd Taylor-Green energy ratio {ratio}, expected {expect}, "
           f"w_max {w_max}")
    out["taylor_green"] = fields

    nr, steps_r, dt_r, nu_r = CFD_RENUMBERED
    cm = generate.rect_tria(0, 1, nr, 0, 1, nr)
    _, (pm, pbc) = _renumber(cm, _cavity_bcs(cm), seed=3)
    rr, fields = run(f"renumbered cavity rect_tria {nr}x{nr}", pm, pbc, nu_r,
                     dt_r, steps_r)
    _phase("cfd", **fields)
    out["renumbered"] = fields
    return out


def _cli_ported(dev):
    """Phase 23: partition (rcb, greedy), poisson --matrix-free and cfd on a
    renumbered cavity's .dat files (pressure on B2), as subprocesses, the
    four at once."""
    with tempfile.TemporaryDirectory() as tmp:
        prefix = str(Path(tmp) / "box")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "pfemfort_tpu_torch",
                               "genmesh", "tet", "0", "1", "32", "0", "1",
                               "32", "0", "1", "32", "-o", prefix], cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        _phase("cli", subcommand="genmesh", seconds=time.perf_counter() - t0,
               exit=proc.returncode, output=proc.stdout.strip().splitlines())
        _check(proc.returncode == 0, f"CLI genmesh: {proc.stdout}"
               f"{proc.stderr}")
        files = [prefix + s for s in ("-nodes.dat", "-elems.dat",
                                      "-DirichBC.dat")]
        cm = generate.rect_tria(0, 1, 64, 0, 1, 64)
        _, (pm, pbc) = _renumber(cm, _cavity_bcs(cm), seed=4)
        cav = str(Path(tmp) / "cavity")
        mesh_io.write_dat(cav, pm, dirichlet=pbc)
        jobs = [(f"partition --method {method}",
                 ["partition", *files[:2], "--nparts", "8", "--method",
                  method, "-o", str(Path(tmp) / f"{method}.vtk")])
                for method in ("rcb", "greedy")]
        jobs += [("poisson --matrix-free",
                  ["poisson", *files, "--device", dev.type,
                   "--matrix-free"]),
                 ("cfd (renumbered cavity)",
                  ["cfd", cav + "-nodes.dat", cav + "-elems.dat",
                   cav + "-DirichBC.dat", "--nsteps", "50", "--dt", "1e-3",
                   "--device", dev.type, "-o", str(Path(tmp) / "cfd.vtk")])]
        expect = {"partition --method rcb": ("into 8 parts",),
                  "partition --method greedy": ("into 8 parts",),
                  "poisson --matrix-free": ("Convergence in",),
                  "cfd (renumbered cavity)": ("50 steps in", "max|div u|")}
        with _cli_batch(jobs) as result:
            for label, _ in jobs:
                proc, secs = result(label)
                _phase("cli", subcommand=label, seconds=secs,
                       exit=proc.returncode,
                       output=proc.stdout.strip().splitlines())
                _check(proc.returncode == 0
                       and all(w in proc.stdout for w in expect[label]),
                       f"CLI {label}: {proc.stdout}{proc.stderr}")


def _slab_rows(total, ranks, plane=1, lane_pad=8):
    """Rows per rank of parallel/shard.py's slab partition: total / ranks
    rounded up to lane_pad, then to whole lattice planes."""
    P = round_up(-(-total // ranks), lane_pad)
    return plane * (-(-P // plane))


def _halo_csr(A, w):
    """torch.sparse_csr_tensor of a rank's (P, P + 2w) block over its
    extended x = [left | x_l | right] (nonzero in-range entries): its
    product with the extended x is one cuSPARSE SpMV.  Returns (csr,
    nnz)."""
    dev, P = A.vals.device, A.n_rows
    offs = torch.tensor(A.offsets, dtype=torch.int64, device=dev)
    cols = torch.arange(P, device=dev)[:, None] + offs[None, :] + w
    vals = A.vals.t()
    keep = (cols >= 0) & (cols < P + 2 * w) & (vals != 0)
    crow = torch.zeros(P + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(keep.sum(1), 0)
    csr = torch.sparse_csr_tensor(crow.to(torch.int32),
                                  cols[keep].to(torch.int32), vals[keep],
                                  size=(P, P + 2 * w))
    return csr, int(crow[-1])


def _dist_kernel(dev, errs, rng, A_lat, A_el3, smi, peak):
    """Phase 25: B1's halo entry at two real per-rank shapes, against its
    plain version (f32, f64; both halos, and an edge rank's missing one),
    then timed in f32 as phase 24 times B1: back to back, queued behind a
    sleep kernel, its byte bound and cuSPARSE on the CSR of the block."""
    L = N_SLAB - 1
    shifts = decompose_offsets(A_lat.offsets, A_lat.lattice)
    offs = tuple(sorted(a * L * L + b * L + c for a, b, c in shifts))
    P = _slab_rows(L ** 3, SLAB_RANKS, plane=L * L)
    lat_vals = torch.as_tensor(rng.standard_normal((len(offs), P)),
                               dtype=torch.float32, device=dev)
    Pe = _slab_rows(A_el3.n_rows, EL3D_SLAB_RANKS)
    shapes = {
        f"box_tet n={N_SLAB}, rank 1 of {SLAB_RANKS} (slab)":
            DIAMatrix(vals=lat_vals, offsets=offs, n_rows=P),
        f"elasticity3d n={N_EL3D}, rank 1 of {EL3D_SLAB_RANKS} (slab)":
            DIAMatrix(vals=A_el3.vals[:, Pe:2 * Pe].contiguous(),
                      offsets=A_el3.offsets, n_rows=Pe)}
    timing = []
    for label, A in shapes.items():
        w = halo_width(A.offsets)
        _check(w <= A.n_rows and len(A.offsets) in (15, 59),
               f"dist_kernel {label}: w {w}, {len(A.offsets)} diagonals")
        x64, l64, r64 = (rng.standard_normal(n)
                         for n in (A.n_rows, w, w))
        for dtype in (torch.float32, torch.float64):
            Ad = DIAMatrix(vals=A.vals.to(dtype), offsets=A.offsets,
                           n_rows=A.n_rows)
            x, left, right = (torch.as_tensor(v, dtype=dtype, device=dev)
                              for v in (x64, l64, r64))
            for halos, (lh, rh) in (("halos", (left, right)),
                                    ("edge rank", (None, right))):
                abs_err, rel_err = _errors(
                    dia_spmv_cuda.dia_spmv_halo(Ad, x, lh, rh),
                    spmv_dia_halo_local(Ad, x, lh, rh))
                case = f"halo {label}, {halos}"
                errs[("dia_spmv", case, dtype)] = abs_err
                _phase("dist_kernel", kernel="dia_spmv (halo entry)",
                       case=case, dtype=str(dtype), rows=A.n_rows, w=w,
                       diagonals=len(A.offsets), max_abs_err=abs_err,
                       max_rel_err=rel_err, bound=REL_ERR_MAX[dtype])
                _check(rel_err <= REL_ERR_MAX[dtype],
                       f"dia_spmv_halo {case} {dtype}: rel err {rel_err}")
        x, left, right = (torch.as_tensor(v, dtype=torch.float32,
                                          device=dev)
                          for v in (x64, l64, r64))
        csr, nnz = _halo_csr(A, w)
        x_ext = torch.cat([left, x, right])
        kern = lambda A=A, x=x, l=left, r=right: \
            dia_spmv_cuda.dia_spmv_halo(A, x, l, r)
        plain = lambda A=A, x=x, l=left, r=right: \
            spmv_dia_halo_local(A, x, l, r)
        lib = lambda csr=csr, xe=x_ext: csr @ xe
        _, lib_rel = _errors(lib(), kern())
        _check(lib_rel <= REL_ERR_MAX[torch.float32],
               f"dist_kernel {label}: the library product differs by "
               f"{lib_rel}")
        ms, runs = _timed_pairs(plain, kern, lib)
        device, hidden = _timed_device({"plain": plain, "kernel": kern,
                                        "library": lib})
        bound_ms, bound_by, nbytes = _bound(A, nnz, peak, halo=2 * w)
        row = dict(shape=label, rows=A.n_rows, w=w,
                   diagonals=len(A.offsets), nnz=nnz, spmv_bytes=nbytes,
                   bound_ms=bound_ms, bound_by=bound_by, peak_gbps=peak,
                   kernel_ms=ms["kernel"], plain_ms=ms["plain"],
                   library_ms=ms["library"], kernel_ms_runs=runs["kernel"],
                   device_kernel_ms=device["kernel"],
                   device_plain_ms=device["plain"],
                   device_library_ms=device["library"],
                   device_host_hidden=hidden,
                   device_kernel_share_of_bound=bound_ms / device["kernel"],
                   device_kernel_over_library=device["kernel"]
                   / device["library"], library_rel_err=lib_rel)
        _phase("dist_kernel", card=smi, dtype="float32", **row)
        timing.append(row)
        del csr, x_ext
    return timing


def _dist_stages(label, r, base, extra, phase="dist_dia"):
    """Print a sharded solve's stages; `base`: the bytes the script held on
    the card when the solve began (the peak since then is printed above
    it too)."""
    it = max(r.stats.iters, 1)
    peak = torch.cuda.max_memory_allocated()
    _phase(phase, run=label, iters=r.stats.iters, relres=r.stats.relres,
           converged=r.stats.converged, ms_per_iter=1e3 * r.timings["solve_s"]
           / it, time_to_solution_s=_stage_seconds(r),
           peak_device_gb=peak / 1e9, peak_above_start_gb=(peak - base) / 1e9,
           **extra, **r.timings)


def _reduction_cost(v, reps=300):
    """Host ms per call of CG's reduced dot pair (parallel/shard_cg.py: two
    local dots stacked into one all_reduce) and of the local pair, each
    followed by the flag read the Krylov loop makes, on the solve's vector
    `v`.  The difference is what a collective adds to every CG iteration,
    twice (p.Ap, then the pair after the preconditioner)."""
    _, dot2 = shard_cg._reduced_dots()
    pairs = {"local": lambda: (torch.dot(v, v), torch.dot(v, v)),
             "reduced": lambda: dot2(v, v, v, v)}
    ms = {}
    for name, pair in pairs.items():
        for _ in range(2):          # the first pass warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                bool(pair()[1] > 0)
            ms[name] = (time.perf_counter() - t0) / reps * 1e3
    return {"dot_pair_local_ms": ms["local"],
            "dot_pair_all_reduce_ms": ms["reduced"]}


def _timing_row(phase, label, run, bound, nnz, smi, peak, **extra):
    """Time run = {"plain", "kernel", "library"} as phase 24 does (back to
    back, then queued behind a sleep kernel) beside `bound` = (bound ms,
    'bytes' or 'operations', bytes); print and return the row."""
    ms, runs = _timed_pairs(run["plain"], run["kernel"], run["library"])
    device, hidden = _timed_device(run)
    bound_ms, bound_by, nbytes = bound
    row = dict(shape=label, nnz=nnz, spmv_bytes=nbytes, bound_ms=bound_ms,
               bound_by=bound_by, peak_gbps=peak, kernel_ms=ms["kernel"],
               plain_ms=ms["plain"], library_ms=ms["library"],
               kernel_ms_runs=runs["kernel"],
               device_kernel_ms=device["kernel"],
               device_plain_ms=device["plain"],
               device_library_ms=device["library"],
               device_host_hidden=hidden,
               device_kernel_share_of_bound=bound_ms / device["kernel"],
               device_kernel_over_library=device["kernel"]
               / device["library"], **extra)
    _phase(phase, card=smi, **row)
    return row


def _halo_entry_on_block(label, block, errs, rng, timed=None,
                         phase="dist_dia"):
    """B1's halo entry on a sharded solve's own (D, P) block against its
    plain version, f32 and f64: with both halos None, as every launch of a
    world-size-1 solve has them, and with random non-zero halos.  With
    `timed` = (smi, peak), also timed in the solve's dtype with both halos
    None (the main path's launches), beside its byte bound and cuSPARSE on
    the CSR of the same (P, P) block; returns that row."""
    offsets, vals = block
    P, dev = vals.shape[1], vals.device
    w = halo_width(offsets)
    x64, l64, r64 = (rng.standard_normal(n) for n in (P, w, w))
    if timed is not None:
        A = DIAMatrix(vals=vals, offsets=offsets, n_rows=P)
        x = torch.as_tensor(x64, dtype=vals.dtype, device=dev)
        csr, nnz = _csr_library(A)
        kern = lambda: dia_spmv_cuda.dia_spmv_halo(A, x, None, None)
        lib = lambda: csr @ x
        _, lib_rel = _errors(lib(), kern())
        _check(lib_rel <= REL_ERR_MAX[vals.dtype],
               f"halo {label}: the library product differs by {lib_rel}")
        row = _timing_row(
            phase, f"{label} solve block, no neighbours",
            {"plain": lambda: spmv_dia_halo_local(A, x, None, None),
             "kernel": kern, "library": lib},
            _bound(A, nnz, timed[1]), nnz, *timed, rows=P, w=w,
            diagonals=len(offsets), dtype=str(vals.dtype)[6:],
            library_rel_err=lib_rel)
        del csr
    for dtype in (torch.float32, torch.float64):
        A = DIAMatrix(vals=vals.to(dtype), offsets=offsets, n_rows=P)
        x, left, right = (torch.as_tensor(v, dtype=dtype, device=dev)
                          for v in (x64, l64, r64))
        for halos, (lh, rh) in (("no neighbours", (None, None)),
                                ("halos", (left, right))):
            abs_err, rel_err = _errors(
                dia_spmv_cuda.dia_spmv_halo(A, x, lh, rh),
                spmv_dia_halo_local(A, x, lh, rh))
            case = f"halo {label} solve block, {halos}"
            errs[("dia_spmv", case, dtype)] = abs_err
            _phase(phase, kernel="dia_spmv (halo entry)", case=case,
                   dtype=str(dtype), rows=P, w=w, diagonals=len(offsets),
                   max_abs_err=abs_err, max_rel_err=rel_err,
                   bound=REL_ERR_MAX[dtype])
            _check(rel_err <= REL_ERR_MAX[dtype],
                   f"dia_spmv_halo {case} {dtype}: rel err {rel_err}")
    return row if timed is not None else None


def _dist_dia(dev, counted, solve_dia, el3, errs, rng, smi, peak):
    """Phase 26: solve_implicit_sharded on a world-size-1 NCCL group: the
    n=96 Poisson box (f32) and the phase-7 elasticity system (f64, Jacobi
    and block-Jacobi), every in-shard product on B1's halo entry; after
    each solve, B1's halo entry against its plain version on that solve's
    own block, and timed there (Jacobi) as the solve launches it.
    Returns (the solves, the timing rows)."""
    wd = multihost.world()
    _check(wd.size == 1 and wd.device.type == "cuda",
           f"dist_dia: the group is {wd}")
    n = N_FLAGSHIP
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rec = {}
    with _recorded(rec, "distributed_cg_solve_dia"):
        res, launches = _counted(lambda: solve_implicit_sharded(
            mesh, 1, dbc, _poisson_fn, dtype=torch.float32, rtol=1e-6,
            device=dev), counted, "sharded n=96 f32 jacobi (world 1)")
    halo = dia_spmv_cuda.kernel.entry_launches["dia_spmv_halo_f32"]
    nodal_err = _check_solve("dist_dia", res, (mesh.coords ** 2).sum(1))
    st = res.stats
    single_it = solve_dia.stats.iters
    _dist_stages(f"box_tet n={n} f32 jacobi", res, base, dict(
        nodal_err=nodal_err, launches=launches, halo_launches=halo,
        single_device_iters=single_it,
        single_device_ms_per_iter=1e3 * solve_dia.timings["solve_s"]
        / max(single_it, 1), **_reduction_cost(res.u_reduced)))
    _check(res.timings["assembly_layout"] == "dia"
           and res.timings["distributed_assembly"],
           f"dist_dia n={n}: {res.timings}")
    _check(halo >= st.iters and launches["ell_spmv"] == 0,
           f"dist_dia n={n}: halo launches {halo}, {launches} vs "
           f"{st.iters} iterations")
    _check(abs(st.iters - single_it) <= DIST_ITERS_SLACK,
           f"dist_dia n={n}: {st.iters} iterations, single device "
           f"{single_it}")
    _check(not PLAIN_ON_CARD, f"dist_dia: plain SpMVs on the card "
           f"{dict(PLAIN_ON_CARD)}")
    blocks = rec.pop("distributed_cg_solve_dia")
    _check(len(blocks) == 1, f"dist_dia n={n}: {len(blocks)} blocks")
    rows = [_halo_entry_on_block(f"box_tet n={n}", blocks[0][0][:2], errs,
                                 rng, (smi, peak))]
    runs = {"sharded n=96 f32 (world 1)": res}
    del res

    m3, _ = generate.box_tet(0, 1, N_EL3D, 0, 1, N_EL3D, 0, 1, N_EL3D)
    d3 = _clamped(m3)
    D = dmat_3d(E_EL, NU_EL)
    efn = lambda c: elasticity_stiffness(c, "tetra4", D,
                                         bforce=(0.1, 0.0, 0.0))
    ref = el3[torch.float64]
    for pc in ("jacobi", "bjacobi"):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with _recorded(rec, "distributed_cg_solve_dia"):
            r, launches = _counted(lambda: solve_implicit_sharded(
                m3, 3, d3, efn, dtype=torch.float64, rtol=1e-6, precond=pc,
                device=dev), counted,
                f"sharded elasticity3d f64 {pc} (world 1)")
        halo = dia_spmv_cuda.kernel.entry_launches["dia_spmv_halo_f64"]
        rel = float(np.abs(r.u_full - ref.u_full).max()
                    / np.abs(ref.u_full).max())
        _dist_stages(f"elasticity3d n={N_EL3D} f64 {pc}", r, base, dict(
            launches=launches, halo_launches=halo,
            single_device_iters=ref.stats.iters, u_rel_vs_single=rel))
        _check(r.stats.converged and r.stats.relres <= 1e-6,
               f"dist_dia elasticity {pc}: {r.stats}")
        _check(r.timings["precond_used"] == pc,
               f"dist_dia elasticity {pc}: {r.timings}")
        _check(halo >= r.stats.iters and launches["ell_spmv"] == 0,
               f"dist_dia elasticity {pc}: launches {launches}")
        if pc == "jacobi":
            _check(abs(r.stats.iters - ref.stats.iters) <= DIST_ITERS_SLACK
                   and rel <= DIST_EL3D_U_REL,
                   f"dist_dia elasticity: {r.stats.iters} iterations vs "
                   f"{ref.stats.iters}, u rel {rel}")
        blocks = rec.pop("distributed_cg_solve_dia")
        _check(len(blocks) == 1, f"dist_dia elasticity {pc}: "
               f"{len(blocks)} blocks")
        row = _halo_entry_on_block(f"elasticity3d n={N_EL3D} {pc}",
                                   blocks[0][0][:2], errs, rng,
                                   (smi, peak) if pc == "jacobi" else None)
        rows += [row] if row else []
        runs[f"sharded elasticity3d f64 {pc} (world 1)"] = r
    return runs, rows


def _recorded(into, *names):
    """Record in into[name] the (args, kwargs, result) of every call that
    drivers/sharded.py makes to each function of `names` while the block
    runs."""
    return _recorded_in(sharded_driver, into, *names)


@contextlib.contextmanager
def _recorded_in(module, into, *names):
    """Record in into[name] the (args, kwargs, result) of every call that
    `module` makes to each function of `names` while the block runs."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            into.setdefault(name, []).append((args, kw, out))
            return out
        return call

    for name, fn in saved.items():
        setattr(module, name, wrap(name, fn))
    try:
        yield into
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def _host_bytes(obj):
    """Bytes of the numpy arrays held in obj's dataclass fields, nested."""
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if dataclasses.is_dataclass(obj):
        return sum(_host_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


def _ell_route_blocks(label, call, errs, rng):
    """The kernels on a sharded ELL solve's own blocks against their plain
    versions, f32 and f64, x random in every column (ghost slots
    included): with the per-rank hybrid, B1 on its dense local diagonals
    and B2 on its remainder, and the two parts' sum against spmv_sliced
    on the rank's whole ghost-extended block; else B2 on that whole
    (P, P + S*Wx) block, laid out as the solve lays it out; and the
    rank's IC(0) T and T^T when the solve had them.  Returns the hybrid's
    blocks by name (none without it)."""
    (cols_local, vals, _, halo), kw, _ = call
    H = kw.get("hybrid")
    whole = slice_ell(cols_local, halo.n_cols).pack(vals)
    blocks = {}
    if H is None:
        blocks[f"{label} ghost-extended block"] = whole
    else:
        blocks[f"{label} hybrid dense diagonals"] = H.dia
        if H.rem is not None:
            blocks[f"{label} hybrid remainder"] = H.rem
        x64 = rng.standard_normal(halo.n_cols)
        for dtype in (torch.float32, torch.float64):
            x = torch.as_tensor(x64, dtype=dtype, device=vals.device)
            dia = dataclasses.replace(H.dia, vals=H.dia.vals.to(dtype))
            y = dia_spmv_cuda.dia_spmv(dia, x[:H.n_rows])
            if H.rem is not None:
                y = y + ell_spmv_cuda.ell_spmv(dataclasses.replace(
                    H.rem, vals=H.rem.vals.to(dtype)), x)
            abs_err, rel_err = _errors(y, spmv_sliced(dataclasses.replace(
                whole, vals=whole.vals.to(dtype)), x))
            errs[("hybrid", label, dtype)] = abs_err
            _phase("kernel", kernel="hybrid (B1 + B2), per rank", case=label,
                   dtype=str(dtype), rows=H.n_rows, n_cols=halo.n_cols,
                   diagonals=len(H.dia.offsets),
                   rem_max_width=0 if H.rem is None else H.rem.max_width,
                   max_abs_err=abs_err, max_rel_err=rel_err,
                   bound=REL_ERR_MAX[dtype])
            _check(rel_err <= REL_ERR_MAX[dtype],
                   f"{label}: the hybrid's parts against the whole block "
                   f"{dtype}: rel err {rel_err}")
    if kw.get("ic0") is not None:
        blocks[f"{label} IC(0) T"] = kw["ic0"].t
        blocks[f"{label} IC(0) T^T"] = kw["ic0"].tt
    for case, M in blocks.items():
        _kernel_errors(case, M, errs, rng)
    return {k: v for k, v in blocks.items() if " hybrid " in k}


def _dist_ell_halo(dev, counted, single, dia_bjacobi, delaunay, errs, rng,
                   smi, peak):
    """Phase 28: solve_implicit_sharded's ELL route on a world-size-1 NCCL
    group (per-rank ELL assembly, the stash exchange, the ghost-exchange
    Krylov solve): the renumbered n=96 box f32 with Jacobi and IC(0) on
    the per-rank hybrid (15 dense diagonals on B1, no remainder), the
    phase-19 Delaunay mesh f32 on the hybrid with a remainder (B1 and B2),
    the renumbered 3D elasticity system f64 with block-Jacobi on B2; the
    kernels on each solve's own blocks; B2 timed at one rank of an 8-way
    RCB partition of the renumbered n=96 box, laid out on the host without
    a group; the per-rank-file input mode against the single-device solve.
    `delaunay`: (mesh, dbc, phase 19's single-device solve).  Returns (the
    solves, the timing rows, the route's launches by kernel, the hybrid's
    blocks by name)."""
    wd = multihost.world()
    _check(wd.size == 1 and wd.device.type == "cuda",
           f"dist_ell_halo: the group is {wd}")
    runs, route, hybrid_blocks = {}, collections.Counter(), {}
    pmesh, pdbc = _permuted_box(N_FLAGSHIP)
    for pc in ("jacobi", "ic0"):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rec = {}
        with _recorded(rec, "build_dist_ell_setup",
                       "distributed_cg_solve_ell"):
            res, launches = _counted(lambda: solve_implicit_sharded(
                pmesh, 1, pdbc, _poisson_fn, dtype=torch.float32, rtol=1e-6,
                recover=False, precond=pc, device=dev), counted,
                f"sharded ELL renumbered n=96 f32 {pc} (world 1)")
        st, t = res.stats, res.timings
        route.update(launches)
        nodal_err = float(np.abs(res.u_full
                                 - (pmesh.coords ** 2).sum(1)).max())
        # the hybrid: one B1 product an iteration and one for r0, and no
        # remainder, so no B2 product; IC(0)'s T and T^T stay on B2,
        # 2(m - 1) = 6 an application, one an iteration and one for z0
        b2_per_apply = 6 if pc == "ic0" else 0
        setup = rec["build_dist_ell_setup"][0][2]
        ref = single[pc]
        _dist_stages(f"renumbered n={N_FLAGSHIP} f32 {pc}, ELL route", res,
                     base, dict(
                         nodal_err=nodal_err, launches=launches,
                         b1_launches_expected=st.iters + 1,
                         b2_launches_expected=b2_per_apply * (st.iters + 1),
                         single_device=ref.timings.get("ordering", "lattice"),
                         single_device_iters=ref.stats.iters,
                         single_device_ms_per_iter=1e3
                         * ref.timings["solve_s"] / max(ref.stats.iters, 1),
                         host_global_bytes=_host_bytes(setup.sys),
                         host_own_block_bytes=setup.coords.nbytes
                         + setup.ubc.nbytes,
                         device_index_bytes=sum(
                             v.numel() * v.element_size() for v in (
                                 setup.perm, setup.segids,
                                 setup.recv_mat_dest, setup.recv_rhs_dest))),
                     phase="dist_ell_halo")
        _check(t["assembly_layout"] == "ell" and t["distributed_assembly"]
               and t["inshard_kernel"] == "hybrid"
               and t.get("hybrid_diagonals") == 15
               and t.get("hybrid_nnz_rem") == 0
               and t["precond_used"] == pc,
               f"dist_ell_halo n=96 {pc}: {t}")
        if pc == "jacobi":
            _check_solve("dist_ell_halo", res, (pmesh.coords ** 2).sum(1))
        else:
            bar = PC_JAX_CPU_ITERS["ic0"]
            _check(st.converged and st.relres <= 1e-6
                   and abs(st.iters - bar) <= PC_BAND * bar
                   and nodal_err <= NODAL_ERR_MAX,
                   f"dist_ell_halo n=96 ic0: {st}, nodal {nodal_err}, "
                   f"not within {PC_BAND:.0%} of {bar}")
        _check(launches["dia_spmv"] == st.iters + 1
               and launches["ell_spmv"] == b2_per_apply * (st.iters + 1),
               f"dist_ell_halo n=96 {pc}: launches {launches} vs "
               f"{st.iters} iterations")
        _check(not PLAIN_ON_CARD, f"dist_ell_halo: plain SpMVs on the card "
               f"{dict(PLAIN_ON_CARD)}")
        call = rec["distributed_cg_solve_ell"][0]
        p_world1 = call[0][0].shape[0]
        hybrid_blocks.update(_ell_route_blocks(f"sharded ELL n=96 {pc}",
                                               call, errs, rng))
        runs[f"sharded ELL renumbered n=96 f32 {pc} (world 1)"] = res
        del rec, setup, call

    m3, _ = generate.box_tet(0, 1, N_EL3D, 0, 1, N_EL3D, 0, 1, N_EL3D)
    perm, (rm3, rd3) = _renumber(m3, _clamped(m3))
    D = dmat_3d(E_EL, NU_EL)
    efn = lambda c: elasticity_stiffness(c, "tetra4", D,
                                         bforce=(0.1, 0.0, 0.0))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rec = {}
    with _recorded(rec, "distributed_cg_solve_ell"):
        r, launches = _counted(lambda: solve_implicit_sharded(
            rm3, 3, rd3, efn, dtype=torch.float64, rtol=1e-6,
            precond="bjacobi", recover=False, device=dev), counted,
            "sharded ELL renumbered elasticity3d f64 bjacobi (world 1)")
    route.update(launches)
    u = r.u_full.reshape(-1, 3)[perm].reshape(-1)
    rel = float(np.abs(u - dia_bjacobi.u_full).max()
                / np.abs(dia_bjacobi.u_full).max())
    bar = DIST_ELL_EL3D_BJ_ITERS
    _dist_stages(f"renumbered elasticity3d n={N_EL3D} f64 bjacobi, ELL "
                 "route", r, base, dict(
                     launches=launches, dia_route_iters=dia_bjacobi.stats.iters,
                     dia_route_ms_per_iter=1e3 * dia_bjacobi.timings["solve_s"]
                     / max(dia_bjacobi.stats.iters, 1),
                     u_rel_vs_dia_route=rel), phase="dist_ell_halo")
    _check(r.stats.converged and r.stats.relres <= 1e-6
           and r.timings["assembly_layout"] == "ell"
           and r.timings["inshard_kernel"] == "ell_spmv"
           and r.timings["precond_used"] == "bjacobi",
           f"dist_ell_halo elasticity: {r.stats} {r.timings}")
    _check(abs(r.stats.iters - bar) <= DIST_ELL_EL3D_BAND * bar
           and rel <= DIST_ELL_EL3D_U_REL,
           f"dist_ell_halo elasticity: {r.stats.iters} iterations, not "
           f"within {DIST_ELL_EL3D_BAND:.0%} of {bar}; u rel {rel}")
    _check(launches["ell_spmv"] == r.stats.iters + 1
           and launches["dia_spmv"] == 0,
           f"dist_ell_halo elasticity: launches {launches}")
    _ell_route_blocks("sharded ELL elasticity3d bjacobi",
                      rec["distributed_cg_solve_ell"][0], errs, rng)
    runs["sharded ELL renumbered elasticity3d f64 bjacobi (world 1)"] = r
    del rec

    # phase 19's Delaunay mesh on the route: at world size 1 the rank's
    # hybrid keeps the dense diagonals of its geometric order and has a
    # remainder, so every product launches B1 and B2
    md, dd, r19 = delaunay
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rec = {}
    label = f"sharded ELL Delaunay n={N_DELAUNAY_F32} f32 jacobi (world 1)"
    with _recorded(rec, "distributed_cg_solve_ell"):
        r, launches = _counted(lambda: solve_implicit_sharded(
            md, 1, dd, _poisson_fn, dtype=torch.float32, rtol=1e-6,
            recover=False, device=dev), counted, label)
    route.update(launches)
    it, t = r.stats.iters, r.timings
    nodal_err = float(np.abs(r.u_full - (md.coords ** 2).sum(1)).max())
    _dist_stages(f"scrambled Delaunay n={N_DELAUNAY_F32} f32 jacobi, ELL "
                 "route", r, base, dict(
                     nodal_err=nodal_err, launches=launches,
                     single_device_iters=r19.stats.iters,
                     single_device_hybrid={
                         k: v for k, v in r19.timings.items()
                         if k.startswith("hybrid_") or k == "ordering"},
                     single_device_ms_per_iter=1e3 * r19.timings["solve_s"]
                     / max(r19.stats.iters, 1)), phase="dist_ell_halo")
    _check(r.stats.converged and r.stats.relres <= 1e-6
           and bool(np.isfinite(r.u_full).all())
           and t["assembly_layout"] == "ell"
           and t["inshard_kernel"] == "hybrid"
           and t.get("hybrid_diagonals", 0) > 0
           and t.get("hybrid_nnz_rem", 0) > 0,
           f"dist_ell_halo Delaunay: {r.stats} {t}")
    _check(abs(it - r19.stats.iters) <= DELAUNAY_ROUTE_BAND * r19.stats.iters,
           f"dist_ell_halo Delaunay: {it} iterations, not within "
           f"{DELAUNAY_ROUTE_BAND:.0%} of the single device's "
           f"{r19.stats.iters}")
    _check(launches["dia_spmv"] >= it and launches["ell_spmv"] >= it,
           f"dist_ell_halo Delaunay: launches {launches} for {it} "
           "iterations")
    _check(not PLAIN_ON_CARD, f"dist_ell_halo: plain SpMVs on the card "
           f"{dict(PLAIN_ON_CARD)}")
    hybrid_blocks.update(_ell_route_blocks(
        f"sharded ELL Delaunay n={N_DELAUNAY_F32}",
        rec["distributed_cg_solve_ell"][0], errs, rng))
    runs[label] = r
    del rec

    # B2 at one rank of an 8-way RCB partition: the block that rank's every
    # product reads, laid out here without a process group
    t0 = time.perf_counter()
    S, rk = ELL_RANKS, 1
    sys_ = build_sharded_system(pmesh, 1, pdbc, S, method="rcb",
                                layout="ell")
    P, n_rows = sys_.rows_per_shard, sys_.n_rows_padded
    Ke, _ = _poisson_fn(torch.as_tensor(to_element_minor(
        pmesh.elem_coords()), dtype=torch.float32, device=dev))
    A_all = assemble_ell_values(Ke, build_assembly_plan(sys_.pattern, dev))
    del Ke
    plans = [reader_plan(A_all.cols[t * P:(t + 1) * P], t, S, n_rows)
             for t in range(S)]
    wx = round_up(max(max(int(p.counts.max()) for p in plans), 1), 8)
    cols = local_columns(A_all.cols[rk * P:(rk + 1) * P], plans[rk], rk, S,
                         n_rows, wx)
    A = slice_ell(cols, P + S * wx).pack(A_all.vals[rk * P:(rk + 1) * P])
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    del A_all
    label = f"renumbered box_tet n={N_FLAGSHIP}, rank {rk} of {S} (rcb)"
    _kernel_errors(f"{label} ghost-extended block", A, errs, rng)
    x = torch.as_tensor(rng.standard_normal(A.n_cols), dtype=torch.float32,
                        device=dev)
    csr, nnz = _csr_library(A)
    _, lib_rel = _errors(csr @ x, ell_spmv_cuda.ell_spmv(A, x))
    _check(lib_rel <= REL_ERR_MAX[torch.float32],
           f"dist_ell_halo {label}: the library product differs by {lib_rel}")
    row = _timing_row(
        "dist_ell_halo", label,
        {"plain": lambda: spmv_sliced(A, x),
         "kernel": lambda: ell_spmv_cuda.ell_spmv(A, x),
         "library": lambda: csr @ x}, _bound(A, nnz, peak), nnz, smi, peak,
        rows=P, n_cols=A.n_cols, wx=wx,
        ghosts=int(plans[rk].counts.sum()), max_width=A.max_width,
        slots=A.n_slots, dtype="float32", host_layout_s=layout_s,
        library_rel_err=lib_rel)
    del csr
    # what the exchange's concatenation [x_l | ghosts] costs a product, at
    # this rank's shape and at world size 1's (8 ghost slots)
    cat = {}
    for name, (p_rows, n_ghost) in {
            "rank 1 of 8": (P, S * wx),
            "world size 1": (p_world1, 8)}.items():
        x_l = torch.ones(p_rows, device=dev)
        ghosts = torch.zeros(n_ghost, device=dev)
        fn = lambda: torch.cat([x_l, ghosts])
        cat[name] = dict(rows=p_rows, ghost_slots=n_ghost,
                         device_ms=_device_ms(fn)[0],
                         back_to_back_ms=_time_ms(fn, 200))
    _phase("dist_ell_halo", case="ghost-extended vector by concatenation",
           card=smi, **cat)
    row["concatenation"] = cat

    # the per-rank-file input mode (triapoissonparallelimpl2): one rank's
    # files, against the single-device solve of the mesh they hold
    with tempfile.TemporaryDirectory() as tmp:
        mesh, dbc = _permuted_box(N_PARTITIONED)
        prefix = str(Path(tmp) / "box")
        mesh_io.write_partitioned(prefix, mesh, 1, dirichlet=dbc,
                                  method="rcb")
        rmesh, res = solve_poisson_partitioned(
            prefix, 1, multiprocess=True, dtype=torch.float64, rtol=1e-10,
            recover=False, device=dev)
        lmesh, ldbc = read_partitioned_local(prefix, [0])
    ref = solve_implicit(lmesh, 1, ldbc, _poisson_fn, dtype=torch.float64,
                         rtol=1e-10, recover=False, device=dev)
    diff = float(np.abs(res.u_full - ref.u_full).max())
    nodal_err = float(np.abs(res.u_full - (rmesh.coords ** 2).sum(1)).max())
    _phase("dist_ell_halo", case=f"solve_poisson_partitioned, renumbered "
           f"box_tet n={N_PARTITIONED}, one rank's files", nodes=rmesh.n_node,
           iters=res.stats.iters, single_device_iters=ref.stats.iters,
           max_abs_u_diff=diff, bound=PARTITIONED_U_TOL, nodal_err=nodal_err,
           **res.timings)
    _check(res.stats.converged and res.timings["assembly_layout"] == "ell"
           and np.array_equal(rmesh.coords, lmesh.coords)
           and diff <= PARTITIONED_U_TOL and nodal_err <= 1e-6,
           f"solve_poisson_partitioned: {res.stats}, u differs by {diff}, "
           f"nodal {nodal_err}")
    return runs, [row], dict(route), hybrid_blocks


def _dist_ell(dev, counted):
    """Phase 27: distributed_cg_solve (the all-gather ELL route) at world
    size 1 on the n=96 box's ELL system, f32: every product on B2."""
    n = N_FLAGSHIP
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    t0 = time.perf_counter()
    sys_ = build_sharded_system(mesh, 1, dbc, 1, layout="ell")
    plan = build_assembly_plan(sys_.pattern, dev)
    t_pattern = time.perf_counter() - t0
    coords = torch.as_tensor(to_element_minor(mesh.elem_coords()),
                             dtype=torch.float32, device=dev)
    Ke, Fe = _poisson_fn(coords)
    A = assemble_ell_values(Ke, plan)
    ubc = torch.as_tensor(
        sys_.dofmap.bc_values_full[sys_.dofmap.elem_nodedof].T,
        dtype=torch.float32, device=dev)
    b = assemble_rhs(Fe + dirichlet_rhs_correction(Ke, ubc), plan)
    del Ke, Fe, coords, ubc
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (x, st), launches = _counted(lambda: shard_cg.distributed_cg_solve(
        A.cols, A.vals, b, rtol=1e-6), counted,
        "all-gather ELL n=96 f32 (world 1)")
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    u = sys_.dofmap.expand_solution(
        sys_.reduce_solution(x.cpu().to(torch.float64).numpy()))
    nodal_err = float(np.abs(u - (mesh.coords ** 2).sum(1)).max())
    _phase("dist_ell", n=n, rows=sys_.n_rows_padded, k=A.k,
           iters=st.iters, relres=st.relres, converged=st.converged,
           nodal_err=nodal_err, launches=launches, pattern_s=t_pattern,
           solve_s=t_solve, ms_per_iter=1e3 * t_solve / max(st.iters, 1))
    _check(st.converged and st.relres <= 1e-6, f"dist_ell: {st}")
    _check(abs(st.iters - ITERS_BAR) <= ITERS_SLACK,
           f"dist_ell: {st.iters} iterations, not {ITERS_BAR} +- "
           f"{ITERS_SLACK}")
    _check(launches["ell_spmv"] >= st.iters and launches["dia_spmv"] == 0,
           f"dist_ell: launches {launches} vs {st.iters} iterations")
    _check(nodal_err <= NODAL_ERR_MAX, f"dist_ell: nodal error {nodal_err}")


def _vtk_point_values(path):
    body = Path(path).read_text().split("POINT_DATA")[1].split("\n", 2)[2]
    if body.startswith("LOOKUP_TABLE"):
        body = body.split("\n", 1)[1]
    return np.array(body.split(), dtype=np.float64)


def _route(mesh, dbc, ranks):
    """The route solve_implicit_sharded takes for a Poisson mesh on `ranks`
    ranks (after its structure recovery): 'dia' or 'ell'."""
    rec = recover_structure(mesh, 1, dbc, None)
    if rec is not None:
        mesh, dbc = rec[0], rec[1]
    try:
        build_dist_setup(mesh, 1, dbc, ranks, 0)
    except ValueError:
        return "ell"
    return "dia"


def _cli_sharded(dev):
    """Phase 29: `poisson --shards 2 --device cpu` (two gloo ranks started
    by the CLI) against the single-device solve on the card, on a box
    (the DIA route; the single-device CLI) and on a scrambled Delaunay
    mesh (the ELL route; solve_poisson in this process), and `--shards 2
    --device cuda` on this one-card machine, which must fail naming the
    card count.  The four subprocesses run at once."""
    meshes = {"box_tet 8x8x16": generate.box_tet(0, 1, 8, 0, 1, 8, 0, 1, 16),
              f"scrambled Delaunay n={N_DELAUNAY_CLI}":
                  _scrambled_delaunay(N_DELAUNAY_CLI)}
    with tempfile.TemporaryDirectory() as tmp:
        jobs, cases = [], []
        for (name, (mesh, dbc)), route in zip(meshes.items(),
                                              ("dia", "ell")):
            _check(_route(mesh, dbc, 2) == route,
                   f"CLI sharded {name}: not the {route} route at 2 ranks")
            prefix = str(Path(tmp) / name.split()[0])
            mesh_io.write_dat(prefix, mesh, dirichlet=dbc)
            files = [prefix + s for s in ("-nodes.dat", "-elems.dat",
                                          "-DirichBC.dat")]
            vd, vs = prefix + "-dist.vtk", prefix + "-single.vtk"
            if route == "dia":
                jobs.append((f"poisson {name} (single device)",
                             ["poisson", *files, "--device", dev.type,
                              "--dtype", "float64", "-o", vs]))
            label = f"poisson {name} --shards 2 --device cpu ({route} route)"
            jobs.append((label, ["poisson", *files, "--shards", "2",
                                 "--device", "cpu", "--dtype", "float64",
                                 "-o", vd]))
            cases.append((name, route, prefix, vd, vs, label))
        jobs.append(("poisson --shards 2 --device cuda",
                     ["poisson", *files, "--shards", "2", "--device",
                      "cuda"]))

        def finished(label):
            proc, secs = result(label)
            _phase("cli", subcommand=label, seconds=secs,
                   exit=proc.returncode,
                   output=proc.stdout.strip().splitlines(),
                   stderr_tail=proc.stderr.strip().splitlines()[-2:])
            return proc

        with _cli_batch(jobs) as result:
            for name, route, prefix, vd, vs, label in cases:
                if route == "dia":
                    single = finished(f"poisson {name} (single device)")
                    _check(single.returncode == 0, f"CLI poisson {name}: "
                           f"{single.stdout}{single.stderr}")
                    u_single = _vtk_point_values(vs)
                else:
                    # the single-device solve of the same files, in this
                    # process (one interpreter start fewer)
                    m_r, d_r, _ = mesh_io.read_problem(prefix)
                    u_single = solve_poisson(m_r, d_r, device=dev,
                                             dtype=torch.float64).u_full
                dist = finished(label)
                _check(dist.returncode == 0, f"CLI sharded poisson {name}: "
                       f"{dist.stdout}{dist.stderr}")
                _check(dist.stdout.count("Convergence in") == 1
                       and "Mesh statistics" in dist.stdout,
                       f"CLI sharded poisson {name}: rank 0's report "
                       f"{dist.stdout}")
                diff = float(np.abs(_vtk_point_values(vd) - u_single).max())
                _phase("cli", subcommand=f"poisson {name} --shards 2 vs "
                       "single device", route=route, max_abs_u_diff=diff,
                       bound=CLI_SHARDED_U_TOL)
                _check(diff <= CLI_SHARDED_U_TOL,
                       f"CLI sharded {name}: u differs by {diff}")
            bad = finished("poisson --shards 2 --device cuda")
        found = torch.cuda.device_count()
        _check(bad.returncode != 0 and f"found {found}" in bad.stderr
               and "needs 2 CUDA cards" in bad.stderr,
               f"CLI --shards 2 --device cuda on {found} card(s): "
               f"{bad.returncode} {bad.stderr}")


def _b1_entry_launches(halo):
    """B1's launches of the last counted path through its halo entries
    (halo=True) or its single-device entries."""
    return sum(v for e, v in dia_spmv_cuda.kernel.entry_launches.items()
               if e.startswith("dia_spmv_halo") == halo)


def _dist_mg(dev, counted, mg_single, el3, errs, rng, smi, peak):
    """Phase 30: precond='mg' on the world-size-1 NCCL group, the
    distributed geometric multigrid (parallel/dist_mg.py): box_tet n=96
    f32 (the full system, 912,673 rows) and the phase-7 elasticity system
    f32 with the port's vector smoothing; every fine product on B1's halo
    entry, the replicated coarse levels on B1; after each solve, B1's halo
    entry against its plain version on the solve's own fine block.
    Returns (the solves, the timing rows)."""
    n = N_FLAGSHIP
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    D = dmat_3d(E_EL, NU_EL)
    m3, _ = generate.box_tet(0, 1, N_EL3D, 0, 1, N_EL3D, 0, 1, N_EL3D)
    cases = {
        f"box_tet n={n} f32": (mesh, 1, dbc, _poisson_fn),
        f"elasticity3d n={N_EL3D} f32": (
            m3, 3, _clamped(m3), lambda c: elasticity_stiffness(
                c, "tetra4", D, bforce=(0.1, 0.0, 0.0)))}
    runs, rows = {}, []
    for label, (m, ndof, d, efn) in cases.items():
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rec = {}
        with _recorded_in(dist_mg, rec, "fine_spmv_factory"):
            r, launches = _counted(lambda: solve_implicit_sharded(
                m, ndof, d, efn, dtype=torch.float32, rtol=1e-6,
                maxiter=100 if ndof == 1 else 1000, precond="mg",
                device=dev), counted, f"sharded {label} mg (world 1)")
        halo, coarse = _b1_entry_launches(True), _b1_entry_launches(False)
        it = r.stats.iters
        extra = dict(launches=launches, halo_launches=halo,
                     coarse_b1_launches=coarse, rows=m.n_node * ndof)
        if ndof == 1:
            nodal_err = float(np.abs(r.u_full - (m.coords ** 2).sum(1)).max())
            extra.update(nodal_err=nodal_err,
                         single_device_iters=mg_single.stats.iters,
                         single_device_ms_per_iter=1e3 * mg_single.timings[
                             "solve_s"] / mg_single.stats.iters)
            _check(abs(it - mg_single.stats.iters) <= MG_SLACK
                   and nodal_err <= NODAL_ERR_MAX,
                   f"dist_mg {label}: {it} iterations (single device "
                   f"{mg_single.stats.iters}), nodal error {nodal_err}")
        else:
            u64 = el3[torch.float64].u_full
            rel = float(np.abs(r.u_full - u64).max() / np.abs(u64).max())
            bar = EL_MG_FRACTION * el3[torch.float32].stats.iters
            extra.update(rel_to_f64_reduced=rel, bound=EL3D_F32_VS_F64,
                         jacobi_f32_iters=el3[torch.float32].stats.iters,
                         bar=bar)
            _check(it < bar and rel <= EL3D_F32_VS_F64,
                   f"dist_mg {label}: {it} iterations (bar {bar}), u rel "
                   f"{rel}")
        _dist_stages(label, r, base, extra, phase="dist_mg")
        _check(r.stats.converged and r.stats.relres <= 1e-6
               and bool(np.isfinite(r.u_full).all()),
               f"dist_mg {label}: {r.stats}")
        _check(r.timings.get("distributed_mg") is True
               and r.timings["precond_used"] == "mg",
               f"dist_mg {label}: {r.timings}")
        _check(halo >= 3 * it and coarse > 0 and launches["ell_spmv"] == 0,
               f"dist_mg {label}: B1 halo {halo}, coarse {coarse}, "
               f"{launches} for {it} iterations")
        _check(not PLAIN_ON_CARD, f"dist_mg: plain SpMVs on the card "
               f"{dict(PLAIN_ON_CARD)}")
        calls = rec.pop("fine_spmv_factory")
        _check(len(calls) == 1, f"dist_mg {label}: {len(calls)} fine blocks")
        (setup, vals_l), _, _ = calls[0]
        row = _halo_entry_on_block(f"dist_mg {label}",
                                   (tuple(setup.offsets), vals_l), errs, rng,
                                   (smi, peak), phase="dist_mg")
        rows.append(row)
        runs[f"sharded {label} mg (world 1)"] = r
        del calls, setup, vals_l
    return runs, rows


def _dist_amg(dev, counted, amg_single, errs, rng):
    """Phase 31: precond='amg' on the sharded ELL route at world size 1:
    the renumbered n=96 box (default_rng(2), recover=False), f32, so the
    fine operator is the per-rank hybrid (15 dense diagonals, no
    remainder): B1 on its diagonals, B2 on the P0_s and P0_s^T blocks,
    each launched during the solve and held against its plain version;
    B2 on the whole ghost-extended block not at all.  Returns the
    solve."""
    pmesh, pdbc = _permuted_box(N_FLAGSHIP, seed=2)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rec = {}
    label = "sharded renumbered n=96 rng(2) f32 amg (world 1)"
    with _recorded(rec, "distributed_cg_solve_ell"):
        r, launches = _counted(lambda: solve_implicit_sharded(
            pmesh, 1, pdbc, _poisson_fn, dtype=torch.float32, rtol=1e-6,
            recover=False, precond="amg", device=dev), counted, label)
    nodal_err = float(np.abs(r.u_full - (pmesh.coords ** 2).sum(1)).max())
    call = rec.pop("distributed_cg_solve_ell")[0]
    (cols_local, vals, _, halo), kw, _ = call
    amg, H = kw["amg"], kw["hybrid"]
    ghost = slice_ell(cols_local, halo.n_cols).pack(vals)
    shapes = SOLVE_SHAPES[label]
    by_block = {name: shapes[_shape_key(A)]
                for name, A in (("hybrid dense diagonals", H.dia),
                                ("ghost-extended block", ghost),
                                ("P0_s", amg.p0), ("P0_s^T", amg.p0t))}
    it = r.stats.iters
    _dist_stages("renumbered n=96 rng(2) f32 amg", r, base, dict(
        nodal_err=nodal_err, launches=launches,
        b2_launches_by_block=by_block,
        single_device_iters=amg_single.stats.iters,
        single_device_levels=amg_single.timings["amg_levels"],
        single_device_amg_setup_s=amg_single.timings["amg_setup_s"],
        single_device_ms_per_iter=1e3 * amg_single.timings["solve_s"]
        / amg_single.stats.iters), phase="dist_amg")
    _check(r.stats.converged and r.stats.relres <= 1e-6
           and it <= AMG_ITERS_MAX and nodal_err <= NODAL_ERR_MAX,
           f"dist_amg: {r.stats}, nodal error {nodal_err}")
    _check(r.timings["precond_used"] == "amg"
           and r.timings["assembly_layout"] == "ell"
           and r.timings["inshard_kernel"] == "hybrid"
           and H.rem is None and len(H.dia.offsets) == 15,
           f"dist_amg: {r.timings}")
    _check(by_block["hybrid dense diagonals"] >= it
           and by_block["ghost-extended block"] == 0
           and by_block["P0_s"] >= it and by_block["P0_s^T"] >= it,
           f"dist_amg: launches by block {by_block} for {it} iterations")
    _check(not PLAIN_ON_CARD, f"dist_amg: plain SpMVs on the card "
           f"{dict(PLAIN_ON_CARD)}")
    for name, A in (("hybrid dense diagonals", H.dia), ("P0_s", amg.p0),
                    ("P0_s^T", amg.p0t)):
        _kernel_errors(f"dist_amg {name}", A, errs, rng)
    return r


def _dist_partition(dev):
    """Phase 32: rcb_partition_device on the 48M element centroids of
    box_tet n=200, made on the card, 8 parts: balance, the JAX test's
    geometric bar, and the same ids as the port's CPU run on the same
    centroids."""
    n, k = N_LARGE, RCB_PARTS
    coords_em = generate.box_tet_coords_em_device(0, 1, n, 0, 1, n, 0, 1, n,
                                                  device=dev)
    cent = coords_em.mean(dim=0).t().contiguous()
    del coords_em
    E = cent.shape[0]
    torch.cuda.synchronize()
    secs = {}
    for rep in ("first", "second"):
        t0 = time.perf_counter()
        part = rcb_partition_device(cent, k, device=dev)
        torch.cuda.synchronize()
        secs[rep] = time.perf_counter() - t0
    counts = torch.bincount(part, minlength=k).cpu().numpy()
    idx = part.long()[:, None].expand(E, 3)
    lo = torch.full((k, 3), float("inf"), device=dev).scatter_reduce_(
        0, idx, cent, reduce="amin")
    hi = torch.full((k, 3), -float("inf"), device=dev).scatter_reduce_(
        0, idx, cent, reduce="amax")
    ext = (hi - lo + 1e-9).prod(dim=1).cpu().numpy()
    del idx, lo, hi
    cent_h = cent.cpu()
    part_h = part.cpu().numpy()
    del cent, part
    t0 = time.perf_counter()
    cpu = rcb_partition_device(cent_h, k, device="cpu").numpy()
    cpu_s = time.perf_counter() - t0
    same = bool(np.array_equal(part_h, cpu))
    bal = 1.05 * E / k + 64
    _phase("dist_partition", n=n, elements=E, parts=k, counts=counts.tolist(),
           balance_bound=bal, extent_products=ext.tolist(),
           extent_bound=RCB_EXTENT_SHARE, card_s=secs["second"],
           card_first_s=secs["first"], cpu_s=cpu_s, card_equals_cpu=same)
    _check(counts.min() > 0 and counts.max() <= bal,
           f"dist_partition: counts {counts.tolist()}")
    _check(float(ext.max()) < RCB_EXTENT_SHARE,
           f"dist_partition: extent products {ext.tolist()}")
    _check(same, "dist_partition: the card's part ids differ from the CPU's")


def _dist_explicit(dev, single):
    """Phase 33: explicit_dynamics_sharded on phase 9's tria case at world
    size 1: float32 twice, bit for bit; against the single-device loop of
    phase 9 (float32 within 1e-6 relative, float64 within 1e-12) on disp
    and the probes; ms per step beside phase 9's."""
    p = presets.TRIA_EXPLICIT
    nx, ny = EXPLICIT_CELLS
    mesh = generate.rect_tria(0, 10, nx, 0, 2, ny)
    dbc = _clamped(mesh)

    def run(dtype, nsteps):
        bforce = torch.tensor(p.bforce, dtype=dtype, device=dev)
        pulse = torch.tensor(p.pulse_t, dtype=dtype, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = explicit_dynamics_sharded(
            mesh, dbc, p.E, p.nu, p.dens, p.dt, nsteps,
            bforce_fn=lambda t: bforce * torch.where(t <= pulse, 1.0, 0.0),
            probe_dofs=p.probe_dofs, dtype=dtype, device=dev)
        return res, time.perf_counter() - t0

    half = EXPLICIT_STEPS // 2
    (a, ta), (b, _), (_, th) = (run(torch.float32, s) for s in
                                (EXPLICIT_STEPS, EXPLICIT_STEPS, half))
    c, t64 = run(torch.float64, EXPLICIT_STEPS)
    fields = ("disp", "velo", "acce", "probe_history")
    repeat = all(np.array_equal(getattr(a, f), getattr(b, f))
                 for f in fields)

    def rel(x, ref):
        return float(np.abs(x - ref).max() / np.abs(ref).max())

    errs = {str(dt)[6:]: {f: rel(getattr(r, f), getattr(single[dt], f))
                          for f in ("disp", "probe_history")}
            for dt, r in ((torch.float32, a), (torch.float64, c))}
    ms_step = 1e3 * (ta - th) / (EXPLICIT_STEPS - half)
    _phase("dist_explicit", preset="tria", cells=[nx, ny],
           elements=mesh.n_elem, steps=EXPLICIT_STEPS,
           bit_identical_repeat=repeat, rel_to_single_device=errs,
           bound={"float32": DIST_EXPLICIT_REL[torch.float32],
                  "float64": DIST_EXPLICIT_REL[torch.float64]},
           seconds_f32=ta, seconds_f64=t64, ms_per_step_f32=ms_step,
           single_device_ms_per_step_f32=single["ms_per_step"],
           finite=bool(np.isfinite(a.disp).all()))
    _check(repeat, "dist_explicit: float32 does not repeat bit for bit")
    for dt, r in ((torch.float32, a), (torch.float64, c)):
        worst = max(errs[str(dt)[6:]].values())
        _check(worst <= DIST_EXPLICIT_REL[dt] and np.isfinite(r.disp).all(),
               f"dist_explicit {dt}: {errs[str(dt)[6:]]}")


def _dryrun(dev, counted):
    """Phase 34: the port's dry run (pfemfort_tpu_torch/dryrun.py) at world
    size 1 on the card, float32, with the JAX package's assertions."""
    t0 = time.perf_counter()
    iters, launches = _counted(lambda: dryrun.dryrun(device=dev,
                                                     verbose=False), counted)
    _phase("dryrun", world_size=multihost.world().size, iters=iters,
           launches=launches, seconds=time.perf_counter() - t0)
    _check(set(iters) == {"halo/dia", "dist/ell", "dist_mg", "dist_amg"},
           f"dryrun: {iters}")
    _check(launches["dia_spmv"] > 0 and launches["ell_spmv"] > 0,
           f"dryrun: launches {launches}")


def _add_launches(counted, launches):
    """Add a subprocess's counted launches (bench.py:launch_counts) to
    this run's."""
    for k, v in launches.items():
        counted[k] += v


def _host_programs():
    """pfem_gentet writes a 4^3 box, pfem_partition splits it 4 ways
    (RCB) and writes its VTK."""
    with tempfile.TemporaryDirectory() as tmp:
        prefix = str(Path(tmp) / "box")
        gen = subprocess.run([host_native.binary("pfem_gentet"), "0", "1",
                              "4", "0", "1", "4", "0", "1", "4", prefix],
                             capture_output=True, text=True, timeout=60)
        part = subprocess.run(
            [host_native.binary("pfem_partition"), "3", "4", "0", "4",
             f"{prefix}-nodes.dat", f"{prefix}-elems.dat",
             f"{prefix}.vtk"], capture_output=True, text=True, timeout=60)
        vtk = Path(f"{prefix}.vtk")
        ok = (gen.returncode == 0 and part.returncode == 0
              and "edge-cut" in part.stdout and vtk.exists()
              and b"SCALARS procid int 1" in vtk.read_bytes())
        return ok, part.stdout.strip().splitlines()


def _bench(counted):
    """Phase 35: the bench harness through the CLI, as a subprocess, and
    the two host programs."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        detail = Path(tmp) / "detail.json"
        proc = subprocess.run(
            [sys.executable, "-m", "pfemfort_tpu_torch", "bench",
             *BENCH_ARGS, "--device", "cuda", "--detail", str(detail)],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        seconds = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        _check(proc.returncode == 0 and lines and detail.exists(),
               f"bench exited {proc.returncode}: {proc.stderr[-3000:]}")
        last = json.loads(lines[-1])
        det = json.loads(detail.read_text())
    stages = last["stages"]
    pq, lu = det["partition_quality"], det["large_unstructured"]
    cuts = {m: pq[f"{m}_edge_cut"] for m in PARTITION_CUTS}
    launches = {st: det[st].get("launches", {}) for st in sorted(stages)}
    for per_stage in launches.values():
        for solve in per_stage.values():
            _add_launches(counted, solve)
    programs_ok, partition_report = _host_programs()
    _phase("bench", seconds=seconds, args=list(BENCH_ARGS), last_line=last,
           card=det.get("card"),
           stage_seconds={st: det[st].get("stage_s") for st in stages},
           large_unstructured={k: lu.get(k) for k in (
               "n_elem", "n_dof", "nnz", "cg_iters", "cg_relres",
               "nodal_err_vs_exact", "pattern_s", "order_s", "assemble_s",
               "solve_s", "ms_per_iter", "hybrid_diagonals",
               "hybrid_nnz_rem", "peak_device_bytes", "total_s")},
           edge_cuts=cuts, flagship_spmv=det["flagship"].get("spmv"),
           dist_spmv={k: det["dist_spmv"].get(k)
                      for k in ("b1_halo", "b2_ghost")},
           launches=launches, host_programs=partition_report)
    _check(set(stages) == BENCH_STAGES and all(stages.values()),
           f"bench stages {stages}")
    _check(cuts == PARTITION_CUTS, f"bench edge cuts {cuts}")
    _check(lu["n_dof"] == LU_ROWS and lu["nnz"] == LU_NNZ
           and lu["hybrid_nnz_rem"] == 0
           and abs(lu["cg_iters"] - LU_ITERS) <= LU_SLACK
           and lu["nodal_err_vs_exact"] <= LU_NODAL,
           f"bench large_unstructured {lu}")
    for st in ("flagship", "unstructured", "large_unstructured"):
        got = launches[st]["jacobi"]["dia_spmv"]
        _check(got >= det[st]["cg_iters"] if "cg_iters" in det[st]
               else got > 0, f"bench {st}: B1 launches {got}")
    _check(launches["amg"]["amg"]["ell_spmv"] > 0,
           f"bench amg: B2 launches {launches['amg']}")
    _check(programs_ok, f"host programs: {partition_report}")


def _scaling(counted):
    """Phase 36: the weak-scaling harness at world size 1 on the card."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pfemfort_tpu_torch.bench_scaling",
         "--per-shard-n", str(SCALING_N), "--shards", "1", "--device",
         "cuda"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    _check(proc.returncode == 0 and len(lines) == 1,
           f"bench_scaling exited {proc.returncode}: {proc.stderr[-3000:]}")
    r = json.loads(lines[0])
    _add_launches(counted, r["launches"])
    _phase("scaling", seconds=time.perf_counter() - t0, **r)
    _check(r["converged"] and abs(r["iters"] - ITERS_BAR) <= ITERS_SLACK
           and r["launches"]["dia_spmv_halo"] >= r["iters"],
           f"scaling: {r}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    _phase("device", kind=kind, count=torch.cuda.device_count(),
           nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    mesher = ThreadPoolExecutor(1)
    delaunay_mesh = mesher.submit(_timed_delaunay, N_DELAUNAY_F32)

    # 2. build: one compiler process per source (nvcc for the kernels, the
    # host C++ compiler for the host library), started together
    def build(lib):
        t0 = time.perf_counter()
        lib.build()
        return time.perf_counter() - t0

    # B3 in the shapes and types of phases 9 and 9b (tria3 f32/f64, the
    # hourglass quad4 f32/f64, the tetra4 box f32/f64)
    b3 = {f"explicit_step {npe},{nd},{g}{' hg' if hg else ''} "
          f"{str(dt)[6:]}": explicit_cuda.kernel(npe, nd, g, dt, hg)
          for npe, nd, g, dt, hg in (
              (3, 2, 1, torch.float32, False), (3, 2, 1, torch.float64, False),
              (4, 2, 1, torch.float32, True), (4, 2, 1, torch.float64, True),
              (4, 3, 1, torch.float32, False),
              (4, 3, 1, torch.float64, False))}
    libs = dict(KERNELS, **b3, host_native=host_native.library)
    with ThreadPoolExecutor(len(libs) + len(host_native.PROGRAMS)) as pool:
        builds = {name: pool.submit(build, k) for name, k in libs.items()}
        programs = {name: pool.submit(build, p)
                    for name, p in host_native.PROGRAMS.items()}
        for name, fut in builds.items():
            seconds = fut.result()
            libs[name].lib()
            _phase("build", **{"host" if name == "host_native" else
                               "kernel": name},
                   library=libs[name].library_path().name, seconds=seconds)
        for name, fut in programs.items():
            _phase("build", program=name, seconds=fut.result(),
                   path=host_native.PROGRAMS[name].path().name)
    _pattern_native()

    # 3. kernels vs plain
    errs = {}
    A32 = _flagship_system(dev, torch.float32)
    _check(A32.n_rows == 857_375 and len(A32.offsets) == 15,
           f"flagship DIA is {A32.n_rows} rows x {len(A32.offsets)} diagonals")
    for label, A in {"flagship": A32,
                     "ragged": _ragged_dia(dev, torch.float32, rng)}.items():
        x64 = rng.standard_normal(A.n_rows)
        for dtype in (torch.float32, torch.float64):
            Ad = DIAMatrix(vals=A.vals.to(dtype), offsets=A.offsets,
                           n_rows=A.n_rows, lattice=A.lattice)
            x = torch.as_tensor(x64, dtype=dtype, device=dev)
            y = dia_spmv_cuda.dia_spmv(Ad, x)
            abs_err, rel_err = _errors(y, spmv_dia(Ad, x))
            same = torch.equal(y, dia_spmv_cuda.dia_spmv_halo(Ad, x, None,
                                                              None))
            errs[("dia_spmv", label, dtype)] = abs_err
            _phase("kernel", kernel="dia_spmv", case=label, dtype=str(dtype),
                   rows=A.n_rows, diagonals=len(A.offsets),
                   max_abs_err=abs_err, max_rel_err=rel_err,
                   bound=REL_ERR_MAX[dtype], bit_equal_halo_none=same)
            _check(rel_err <= REL_ERR_MAX[dtype] and same,
                   f"dia_spmv {label} {dtype}: rel err {rel_err}, halo "
                   f"entry bit equal {same}")

    assemble, coords, ordering, setup_s, lex = _flagship_ell(dev,
                                                              torch.float32)
    A_un, b_un = assemble(coords)
    A_ord, b_ord = ordering.system(A_un, b_un)
    _check(A_un.n_rows == 857_375 and A_un.k == 16,
           f"renumbered n=96 ELL is {A_un.n_rows} rows x K = {A_un.k}")
    _phase("kernel", kernel="ell_spmv", case="set-up of the n=96 ELL system",
           ordering=ordering.name, nnz=assemble.pattern.nnz,
           sliced_max_width=A_ord.max_width, sliced_slots=A_ord.n_slots,
           **setup_s)
    ell_cases = {"ordered": A_ord, "unordered": A_un,
                 "ragged": _ragged_ell(dev, rng),
                 "skinny, empty slices": _skinny_ell(dev, rng)}
    for label, A in ell_cases.items():
        _kernel_errors(label, A, errs, rng)

    m8, d8 = generate.box_tet(0, 1, 8, 0, 1, 8, 0, 1, 8)
    small = [solve_poisson(m8, d8, device=d, dtype=torch.float64, rtol=1e-10)
             for d in ("cpu", dev)]
    u_diff = float(np.abs(small[0].u_full - small[1].u_full).max())
    _phase("kernel", kernel="dia_spmv", case="box_tet n=8 f64 solve, card "
           "vs cpu", iters=[r.stats.iters for r in small],
           max_abs_u_diff=u_diff)
    _check(small[0].stats.iters == small[1].stats.iters and u_diff <= 1e-10,
           "small f64 DIA solve on the card differs from the CPU solve")
    md, dd = _scrambled_delaunay(N_DELAUNAY)
    # The card sums in another order than the CPU.  On this mesh CG's count
    # is sensitive to that: relative perturbations of 1e-15 to 1e-14 in A
    # and b spread it over 2 to 6 iterations at every rtol from 1e-6 to
    # 1e-12 (PERF.md).  The check holds because both sides are
    # deterministic; at rtol 1e-10 the two counts came out one apart.
    dl = [solve_poisson(md, dd, device=d, dtype=torch.float64, rtol=1e-10)
          for d in ("cpu", dev)]
    u_diff = float(np.abs(dl[0].u_full - dl[1].u_full).max())
    _phase("kernel", kernel="ell_spmv", case=f"scrambled Delaunay "
           f"n={N_DELAUNAY} f64 solve, card vs cpu", nodes=md.n_node,
           elements=md.n_elem, iters=[r.stats.iters for r in dl],
           max_abs_u_diff=u_diff, timings_card=dl[1].timings)
    _check(all("order_s" in r.timings for r in dl),
           "the Delaunay solve did not take the ELL path")
    _check(abs(dl[0].stats.iters - dl[1].stats.iters) <= 1
           and u_diff <= 1e-10,
           "Delaunay f64 ELL solve on the card differs from the CPU solve")

    # 4. the lattice path, counted
    n = N_FLAGSHIP
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    u_exact = (mesh.coords ** 2).sum(axis=1)
    counted = collections.Counter()
    res, launches_dia = _counted(lambda: solve_poisson(
        mesh, dbc, device=dev, dtype=torch.float32, rtol=1e-6), counted,
        "box_tet n=96 f32 jacobi")
    nodal_err = _check_solve("solve", res, u_exact)
    st = res.stats
    _phase("solve", n=n, elements=mesh.n_elem, dofs=int(res.u_reduced.numel()),
           iters=st.iters, relres=st.relres, converged=st.converged,
           nodal_err=nodal_err, launches=launches_dia,
           finite=bool(np.isfinite(res.u_full).all()), **res.timings)
    _check(launches_dia["dia_spmv"] >= st.iters and
           launches_dia["ell_spmv"] == 0,
           f"lattice solve launches {launches_dia} vs {st.iters} iters")
    solve_dia = res

    # 5. the ELL path, counted: float32, so the hybrid operator, which in
    # lex order is the 15 lattice diagonals on B1 and no remainder
    pmesh, pdbc = _permuted_box(N_FLAGSHIP)
    res, launches_ell = _counted(lambda: solve_implicit(
        pmesh, 1, pdbc, _poisson_fn, device=dev, dtype=torch.float32,
        rtol=1e-6, recover=False), counted, "renumbered n=96 f32 jacobi")
    nodal_err = _check_solve("solve_ell", res, (pmesh.coords ** 2).sum(1))
    st = res.stats
    (A1, b1), (A2, b2) = (ordering.system(*assemble(coords))
                          for _ in range(2))
    repeat = (torch.equal(A1.vals, A2.vals) and torch.equal(b1, b2)
              and torch.equal(A1.vals, A_ord.vals) and torch.equal(b1, b_ord))
    _phase("solve_ell", n=n, elements=pmesh.n_elem,
           dofs=int(res.u_reduced.numel()), iters=st.iters,
           relres=st.relres, converged=st.converged, nodal_err=nodal_err,
           launches=launches_ell, assembly_bit_identical=repeat,
           pr4_pattern_s=PR4_PATTERN_S[0], **res.timings)
    _phase("hybrid", case="renumbered box_tet n=96 f32 Jacobi",
           iters=st.iters, launches=launches_ell,
           **{k: v for k, v in res.timings.items()
              if k.startswith("hybrid_") or k == "ordering"})
    _check("order_s" in res.timings, "solve_ell did not take the ELL path")
    _check(res.timings.get("ordering") == "lex"
           and res.timings.get("hybrid_diagonals") == 15
           and res.timings.get("hybrid_nnz_rem") == 0,
           f"solve_ell: the hybrid is not the lattice stencil {res.timings}")
    # one product for r0, one an iteration and one for the answer's
    # residual after the loop (drivers/common.py:_held_to_its_residual)
    _check(launches_ell["dia_spmv"] == st.iters + 2 and
           launches_ell["ell_spmv"] == 0,
           f"ELL solve launches {launches_ell} vs {st.iters} iters")
    _check(repeat, "ELL assembly on the card is not bit-for-bit repeatable")
    solve_ell = res

    # 6. the recovered-structure path, counted
    nr = N_RECOVERED
    lm, ld = generate.box_tet(0, 1, nr, 0, 1, nr, 0, 1, nr)
    lattice = solve_poisson(lm, ld, device=dev, dtype=torch.float32,
                            rtol=1e-6)
    rmesh, rdbc = _permuted_box(nr)
    res, launches_rec = _counted(lambda: solve_poisson(
        rmesh, rdbc, device=dev, dtype=torch.float32, rtol=1e-6), counted,
        "recovered n=48 f32 jacobi")
    st = res.stats
    nodal_err = float(np.abs(res.u_full - (rmesh.coords ** 2).sum(1)).max())
    _phase("solve_recovered", n=nr, iters=st.iters, relres=st.relres,
           converged=st.converged, lattice_iters=lattice.stats.iters,
           nodal_err=nodal_err, launches=launches_rec, **res.timings)
    _check(res.timings.get("structure_recovered") is True,
           "the renumbered n=48 mesh was not recovered")
    _check(st.converged and st.relres <= 1e-6, f"solve_recovered: {st}")
    _check(abs(st.iters - lattice.stats.iters) <= 1,
           f"recovered {st.iters} vs lattice {lattice.stats.iters} iters")
    _check(launches_rec["dia_spmv"] >= st.iters and
           launches_rec["ell_spmv"] == 0,
           f"recovered solve launches {launches_rec} vs {st.iters} iters")
    _check(nodal_err <= NODAL_ERR_MAX, f"recovered nodal error {nodal_err}")
    _guard_plain_spmv()

    # 7.-10. elasticity, explicit dynamics and the command line
    A_el3, A_el3_ell, el3 = _elasticity3d(dev, counted, errs, rng)
    A_el2, A_el2_ell, el2_dia, el2_ell = _elasticity2d(dev, counted, errs,
                                                       rng)
    explicit_single = _explicit(dev)
    b3 = _explicit_b3(dev, explicit_single, smi, peak_gbps(kind))
    _cli(dev)

    # 11.-14. preconditioners and the full system
    pc_runs = {"mg": _mg(dev, counted)}
    for pc, (r, _) in _cheby_ic0(dev, counted, solve_dia).items():
        pc_runs[pc] = r
    amg_runs = _amg(dev, counted)
    pc_runs["amg"], pc_runs["jacobi (amg system)"] = (
        amg_runs["amg"][0], amg_runs["jacobi"][0])
    pc_runs["elasticity_mg"] = _elasticity_mg(dev, counted, el3)[0]
    _phase("pattern_native", case="renumbered box_tet n=96, the ELL solves' "
           "host pattern build", card=smi,
           pattern_s={"rng(0) jacobi": solve_ell.timings["pattern_s"],
                      "rng(2) amg": amg_runs["amg"][0].timings["pattern_s"],
                      "rng(2) jacobi":
                      amg_runs["jacobi"][0].timings["pattern_s"]},
           pr4_numpy_pattern_s={f"rng({k})": v
                                for k, v in PR4_PATTERN_S.items()})

    # 19.-21. the hybrid with both parts; matrix-free and the 1e-8 float64
    # solve at n=96
    pc_runs["delaunay f32 hybrid"], _, hybrid_blocks = _delaunay_f32(
        dev, counted, errs, rng, delaunay_mesh)
    delaunay = (*delaunay_mesh.result()[:2], pc_runs["delaunay f32 hybrid"])
    mesher.shutdown()
    pc_runs["matfree n=96"] = _matfree(dev, counted, mesh, dbc, solve_dia)
    highprec = {N_FLAGSHIP: _highprec(dev, counted, mesh, dbc)}

    # 15., 20., 21. the 48M-element box: assembled, matrix-free, 1e-8
    large, lmesh, ldbc = _large(dev, counted)
    pc_runs["large f32"], pc_runs["large refined"] = (large["f32"][0],
                                                      large["refined"][0])
    pc_runs["matfree n=200"] = _matfree(dev, counted, lmesh, ldbc,
                                        large["f32"][0])
    highprec[N_LARGE] = _highprec(dev, counted, lmesh, ldbc)
    del large, lmesh, ldbc
    torch.cuda.empty_cache()

    # 16.-17. the preconditioners' blocks, the command-line options
    blocks = _preconditioner_blocks(dev, errs, rng, A_ord)
    _cli_preconditioners(dev)

    # 22.-23. Navier-Stokes, the ported subcommands
    _cfd(dev, counted)
    _cli_ported(dev)

    # 24. timing: plain, kernel and library SpMV on every B1/B2 shape: B1
    # on the n=96 lattice system; B2 on the same matrix in the solve's row
    # order, in lattice order (lex, the numbering B1 runs in) and
    # unordered; the elasticity matrices (3D in float32: B1 59 diagonals,
    # B2 the same matrix as ELL; B1 also on its values in float64, the
    # shape of the f64 Jacobi solve; 2D in float64, the dtype of its solves:
    # B1 17 diagonals, B2 K = 16 renumbered in the solve's row order); the
    # phase-16 blocks and the Delaunay hybrid's parts in float32
    peak = peak_gbps(kind)
    N = A32.n_rows
    cols, src, _ = permuted_sorted_cols(assemble.pattern.ell_cols, N, lex, N)
    A_lex = ell_to_sliced(ELLMatrix(
        cols=torch.as_tensor(cols.astype(np.int32), device=dev),
        vals=A_un.vals.reshape(-1)[torch.as_tensor(src.reshape(-1),
                                                   device=dev)
                                   ].reshape(A_un.vals.shape),
        n_cols=N))
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    mats = {"dia": A32, "ell_ordered": A_ord, "ell_lex": A_lex,
            "ell_unordered": ell_to_sliced(A_un), "dia_el3d": A_el3,
            "dia_el3d_f64": DIAMatrix(vals=A_el3.vals.to(torch.float64),
                                      offsets=A_el3.offsets,
                                      n_rows=A_el3.n_rows),
            "ell_el3d": A_el3_ell,
            "dia_el2d": A_el2, "ell_el2d": A_el2_ell, **blocks,
            **hybrid_blocks}
    ms, device, bounds = {}, {}, {}
    for label, A in mats.items():
        is_dia = isinstance(A, DIAMatrix)
        x = torch.as_tensor(rng.standard_normal(A.n_rows if is_dia
                                                else A.n_cols),
                            dtype=A.vals.dtype, device=dev)
        csr, nnz = _csr_library(A)
        lib = lambda csr=csr, x=x: csr @ x
        if is_dia:
            plain = lambda A=A, x=x: spmv_dia(A, x)
            kern = lambda A=A, x=x: dia_spmv_cuda.dia_spmv(A, x)
            run = {"plain": plain, "kernel": kern, "library": lib}
        else:
            _check(_tight(A), f"timing {label}: a slice is wider than its "
                   "rows")
            plain = lambda A=A, x=x: spmv_sliced(A, x)
            kern = lambda A=A, x=x: ell_spmv_cuda.ell_spmv(A, x)
            run = {"plain": plain, "kernel": kern, "library": lib}
        _, lib_rel = _errors(lib(), kern())
        _check(lib_rel <= REL_ERR_MAX[A.vals.dtype],
               f"timing {label}: the library product differs by {lib_rel}")
        ms[label], runs = _timed_pairs(plain, kern, lib)
        device[label], hidden = _timed_device(run)
        dev_ms = device[label]
        bound_ms, bound_by, nbytes = _bound(A, nnz, peak)
        bounds[label] = (bound_ms, bound_by)
        key = _shape_key(A)
        per_solve = {path: shapes[key] for path, shapes in SOLVE_SHAPES.items()
                     if shapes[key]}
        b2 = {}
        if not is_dia:
            b2 = dict(slots=A.n_slots)
            if nbytes < COLD_L2_BELOW_BYTES:
                b2.update(
                    each_warm_kernel_ms=_each_device_ms(kern),
                    each_warm_library_ms=_each_device_ms(lib),
                    cold_l2_kernel_ms=_each_device_ms(kern, scratch),
                    cold_l2_library_ms=_each_device_ms(lib, scratch))
        _phase("timing", matrix=label, card=smi, dtype=str(A.vals.dtype)[6:],
               rows=A.n_rows, n_cols=A.n_rows if is_dia else A.n_cols,
               width=len(A.offsets) if is_dia else A.max_width, nnz=nnz,
               spmv_bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
               peak_gbps=peak, kernel_ms=ms[label]["kernel"],
               plain_ms=ms[label]["plain"], library_ms=ms[label]["library"],
               kernel_ms_runs=runs["kernel"], plain_ms_runs=runs["plain"],
               library_ms_runs=runs["library"],
               kernel_share_of_bound=bound_ms / ms[label]["kernel"],
               kernel_over_library=ms[label]["kernel"]
               / ms[label]["library"],
               device_kernel_ms=dev_ms["kernel"],
               device_plain_ms=dev_ms["plain"],
               device_library_ms=dev_ms["library"],
               device_host_hidden=hidden,
               device_kernel_share_of_bound=bound_ms / dev_ms["kernel"],
               device_kernel_over_library=dev_ms["kernel"]
               / dev_ms["library"], library_rel_err=lib_rel,
               kernel_gbps=nbytes / (ms[label]["kernel"] * 1e-3) / 1e9,
               launches_per_solve=per_solve, **b2)
        del csr
    _phase("timing", matrix="b2_over_b1",
           ordering=ordering.name,
           ordered=ms["ell_ordered"]["kernel"] / ms["dia"]["kernel"],
           lex=ms["ell_lex"]["kernel"] / ms["dia"]["kernel"],
           unordered=ms["ell_unordered"]["kernel"] / ms["dia"]["kernel"])
    _phase("timing", matrix="el3d_b2_over_b1",
           ratio=ms["ell_el3d"]["kernel"] / ms["dia_el3d"]["kernel"])
    for label, r in (("solve", solve_dia), ("solve_ell", solve_ell),
                     ("elasticity3d f32", el3[torch.float32]),
                     ("elasticity3d f64", el3[torch.float64]),
                     ("elasticity2d dia f64", el2_dia),
                     ("elasticity2d ell f64", el2_ell)):
        _phase("timing", stages=label, card=smi, cg_iters=r.stats.iters,
               cg_ms_per_iter=1e3 * r.timings["solve_s"]
               / max(r.stats.iters, 1), **r.timings)
    for label, r in pc_runs.items():
        _phase("timing", stages=label, card=smi, cg_iters=r.stats.iters,
               cg_ms_per_iter=1e3 * r.timings["solve_s"]
               / max(r.stats.iters, 1),
               time_to_solution_s=_stage_seconds(r), **r.timings)
    for n, (st, timings) in highprec.items():
        _phase("timing", stages=f"highprec n={n}", card=smi,
               outer_iters=st.outer_iters, inner_iters=st.total_inner_iters,
               time_to_solution_s=stage_seconds(timings), **timings)

    # 25.-29. the sharded routes on one card: B1's halo entry at real
    # per-rank shapes, the sharded DIA solves at world size 1 (NCCL), the
    # all-gather and the ghost-exchange ELL routes on B2, the command
    # line's --shards
    halo_timing = _dist_kernel(dev, errs, rng, A32, A_el3, smi, peak)
    multihost.initialize(device="cuda")
    dist_runs, main_halo_timing = _dist_dia(dev, counted, solve_dia, el3,
                                            errs, rng, smi, peak)
    _dist_ell(dev, counted)
    ell_runs, ghost_timing, route_launches, route_hybrid = _dist_ell_halo(
        dev, counted, {"jacobi": solve_ell, "ic0": pc_runs["ic0"]},
        dist_runs["sharded elasticity3d f64 bjacobi (world 1)"], delaunay,
        errs, rng, smi, peak)
    del delaunay
    dist_runs.update(ell_runs)
    _cli_sharded(dev)

    # 30.-34. the distributed preconditioners, the device RCB, the sharded
    # explicit loop and the dry run, in the same world-size-1 group
    mg_runs, mg_timing = _dist_mg(dev, counted, pc_runs["mg"], el3, errs,
                                  rng, smi, peak)
    dist_runs.update(mg_runs)
    dist_runs["sharded renumbered n=96 f32 amg (world 1)"] = _dist_amg(
        dev, counted, amg_runs["amg"][0], errs, rng)
    torch.cuda.empty_cache()
    _dist_partition(dev)
    torch.cuda.empty_cache()
    _dist_explicit(dev, explicit_single)
    _dryrun(dev, counted)
    torch.cuda.empty_cache()

    # 35.-36. the bench harness and the weak-scaling harness, as a user
    # runs them (subprocesses)
    _bench(counted)
    _scaling(counted)
    for label, r in dist_runs.items():
        _phase("timing", stages=label, card=smi, cg_iters=r.stats.iters,
               cg_ms_per_iter=1e3 * r.timings["solve_s"]
               / max(r.stats.iters, 1),
               time_to_solution_s=_stage_seconds(r), **r.timings)

    def cases(name):
        return [{"case": case, "dtype": str(dtype)[6:], "max_abs_err": err}
                for (kname, case, dtype), err in errs.items()
                if kname == name]

    def entry(name, source, replaces, label, err_case, dtype):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": counted[name],
                "max_abs_err": errs[(name, err_case, dtype)],
                "ms": ms[label]["kernel"], "plain_ms": ms[label]["plain"],
                "bound_ms": bounds[label][0], "bound_by": bounds[label][1],
                "library_ms": ms[label]["library"],
                "device_ms": device[label]["kernel"],
                "device_library_ms": device[label]["library"], "shape": label,
                "cases": cases(name)}

    dia_entry = entry("dia_spmv", "pfemfort_tpu_torch/csrc/dia_spmv.cu",
                      "pfemfort_tpu/sparse/pallas_spmv.py:48", "dia",
                      "flagship", torch.float32)
    dia_entry["halo_entry"] = {
        "replaces": "pfemfort_tpu/sparse/pallas_spmv.py:167",
        "launches": counted["dia_spmv_halo"],
        "shapes": halo_timing + main_halo_timing + mg_timing}
    ell_entry = entry("ell_spmv", "pfemfort_tpu_torch/csrc/ell_spmv.cu",
                      "pfemfort_tpu/sparse/slotgather.py:403", "ell_el2d",
                      "elasticity2d renumbered, ordered", torch.float64)
    ell_entry["ghost_block"] = {"launches": route_launches["ell_spmv"],
                                "shapes": ghost_timing}

    def rank_hybrid(is_dia):
        """The per-rank hybrid's blocks of phase 28 that this kernel
        multiplies, with their launches in each counted solve."""
        shapes = []
        for name, A in route_hybrid.items():
            if isinstance(A, DIAMatrix) != is_dia:
                continue
            key = _shape_key(A)
            shapes.append(dict(
                block=name, rows=A.n_rows,
                **({"diagonals": len(A.offsets)} if is_dia else
                   {"n_cols": A.n_cols, "max_width": A.max_width}),
                launches_per_solve={path: n[key] for path, n in
                                    SOLVE_SHAPES.items() if n[key]},
                max_abs_err={str(dt)[6:]: errs[(
                    "dia_spmv" if is_dia else "ell_spmv", name, dt)]
                    for dt in (torch.float32, torch.float64)}))
        return shapes

    dia_entry["rank_hybrid"] = {
        "replaces": "pfemfort_tpu/parallel/dist_ell.py:449 (the DIA part)",
        "launches": route_launches["dia_spmv"], "shapes": rank_hybrid(True)}
    ell_entry["rank_hybrid"] = {
        "replaces": "pfemfort_tpu/parallel/dist_ell.py:449 (the remainder)",
        "shapes": rank_hybrid(False)}
    b3["launches"] = explicit_single["b3_launches"]
    print(json.dumps({"kernels": [dia_entry, ell_entry, b3]}), flush=True)
    multihost.shutdown()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
