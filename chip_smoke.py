#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (pampi_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order (any failed phase makes the script exit non-zero before
the last line):

1. build every kernel in pampi_tpu_torch/csrc/ with nvcc (one process per
   source, all started together) and print the build seconds;
2. hold each kernel K1-K4 against its plain PyTorch version on the same
   CUDA inputs, float32 and float64, on an even grid (1024²) and an odd one
   (1023x1021) where the kernel takes odd grids, each with its stated
   tolerance, and K5-K8 likewise on an even (k, j, i) = (32, 48, 64) grid
   and an odd (31, 47, 63) one (K6 on the even one only; K7/K8 with the
   dcavity3d and the canal3d boundary sets), and once more at the canal3d
   main path's grid, dtype and boundary conditions (configs/canal3d.par:
   200x50x50 float64, and the same with slip front/back faces); solve the
   same Poisson problem
   50 times per 2-D SOR layout and the same 3-D pressure problem 50 times
   per 3-D layout, and require identical iteration counts and bitwise
   identical fields;
3. hold each kernel against its plain version once more at the main
   paths' shapes (4096² float32 for K1-K4, 128³ and 256³ float32 for
   K5-K8), with phase 2's tolerances, then time both and compute the least
   time the card could take;
4. the main paths, each with every launch count set to 0 just before it
   and read just after: Poisson 4096² float32 with tpu_sor_inner 4 for a
   fixed 400 iterations in both SOR layouts (K1, K2); NS-2D dcavity 4096²
   float32 (re 1000, itermax 100) for 16 steps through NS2DSolver, split
   into PRE / solve / POST with CUDA events and once more with the flat
   solve to price the solve loop's host syncs; NS-3D configs/dcavity3d.par
   (128³ float32, re 1000) with itermax 100 and eps 0 for 16 steps
   through NS3DSolver in the auto (octants, K6) and checkerboard (K5)
   layouts, split the same way, with the host syncs priced by the same 25
   solve calls back to back; then configs/canal3d.par (200x50x50,
   float64) for 8 steps; every kernel of a path must have been launched;
5. configs/dcavity.par (100², float64) with te 0.02, once on the card and
   once on the CPU (`python -m pampi_tpu_torch --device cpu` in a process
   of its own, started with the card half after the timed phases and
   read at the end): the written .dat fields must agree to 1e-9;
6. configs/dcavity3d.par at 32³ float64, te 1.0, and configs/canal3d.par
   at 48x16x16, te 0.5, both with tpu_sor_inner 1, on the card against the
   reference's own VTK output in tests/fixtures: 1e-6, and 112 steps for
   dcavity3d.

The alternative pressure solvers (`tpu_solver mg|fft`) add to phases 2-5:

2. the fused V-cycle's DOWN and UP kernels K9-K12 against their plain
   versions, float32 and float64, 2-D at 512² (2 levels) and 1024² (3), 3-D
   at 64³ (2) and 64x96x128 (3), required bitwise; 50 repeated mg solves
   per dimension with identical cycle counts and bitwise fields;
3. K9-K12 once more at the main shapes (4096² float32, 5 levels; 128³ and
   256³ float32) and their times beside the bound, with the DCT bottom and
   the whole 4096² fft solve as library times;
4. Poisson 4096² float32 mg for exactly 8 V-cycles (split DOWN / bottom /
   UP / residual check), the ladder (tpu_mg_fused off) once at 4096²,
   NS-2D dcavity 4096² float32 for 16 steps with mg (4 cycles a step) and
   with fft, configs/dcavity3d_fast.par (128³ float32 fft) for 16 steps and
   the same grid with mg, each with the launch counts reset before it;
5. dcavity 512² float64 (20 steps) and dcavity3d 64³ float64 (10 steps),
   with mg and with fft, on the card and on the CPU: fields within 1e-9 and
   the same cycle count in every step.

The distributed layer (a 2-D mesh of shards driven by one process; the
shards of a mesh larger than the card count share the card) adds:

2. the per-shard quarter kernel K13 against its plain version, float32 and
   float64, on random stacked planes of shards at the offsets (0,0), (8,4)
   and (0,12) of a 32² grid and of every shard of 1024² on 2x2 and 2x4
   and of 100² on 2x2 (the CLI path's shards), planes required bitwise; the rank-id halo harness on a (2, 4) and a
   (2, 2, 2) mesh on the card, every ghost face holding the neighbour's
   rank id or, at a wall, its own;
3. K13 once more on the four 2048² shards of 4096² float32 on 2x2, and its
   time per shard call beside the bound;
4. Poisson 4096² float32 on a 2x2 mesh (tpu_sor_inner 4, eps 0, 400
   iterations) through DistPoissonSolver, against the single-device K1
   solve of the same grid (limit 1e-5 of scale, 0.0 expected), with the
   quarter exchange's share of the solve's rounds from CUDA events; then
   `python -m pampi_tpu_torch` on configs/poisson.par with tpu_mesh 2x2 on
   the card and on the CPU (K13's plain version) and with tpu_mesh 1 on the
   card: the same iteration count, the field p.dat is written from equal
   between card and CPU on 2x2 (1e-12 of scale) and within 1e-9 of the
   single-device one.

The distributed NS-3D slice (a 3-D mesh of shards driven by one process,
its eight shards on the one card) adds:

2. the per-shard octant kernel K14 against its plain version, float32 and
   float64, two calls each in the `out=` form, on every shard of 32³ on
   2x2x2 and of 32x48x64 on 1x2x4 (n = 1..4), volumes and residuals
   required bitwise, and on a 1x1x1 mesh against K6 (volume bitwise,
   residual to 1e-5 / 1e-12: the two sum in other orders); K7/K8 in their
   distributed mode (K7 on a shard's deep block, K8 on its halo-1 blocks)
   at every shard of 64³ on 2x2x2 with the dcavity3d and canal3d
   boundary sets (copies and maxima bitwise, the rest to the tolerance);
3. K14 at 256³ on 2x2x2 against its plain version (float32 and float64,
   n = 1..4, bitwise), K14 per shard call at 256³ float32 (n = 4) with its
   CUDA launches a call, and K7/K8 distributed per shard call (a 128³
   shard of 256³), beside their bounds;
4. configs/dcavity3d.par (128³ float32) with tpu_mesh 2x2x2, itermax 100,
   eps 0, 16 steps after one warm-up through NS3DDistSolver: PRE / solve /
   POST and the exchanges' share of the step from CUDA events, the fields
   against NS3DSolver (K6) over the same 17 steps (limit 1e-5 of scale,
   0.0 expected), and K6 never launched on the path; configs/canal3d.par
   (200x50x50 float64) on 1x1x4 for 8 steps against one device (1e-9 of
   scale); dcavity3d 32³ te 1.0 and canal3d 48x16x16 te 0.5 on 2x2x2
   against tests/fixtures (1e-6, 112 steps for dcavity3d); `python -m
   pampi_tpu_torch` on dcavity3d 16³ float64 with tpu_mesh 2x2x2 and
   tpu_vtk sharded, on the card and on the CPU (fields 1e-9).

The float64 solves check convergence every iteration on one device and
every tpu_ca_inner iterations on a mesh (utils/dispatch.sor_cadence), so
phase 2 also holds K1, K2, K5, K6, K13 and K14 against their plain
versions at n = 1.

The distributed NS-2D slice (a 2-D mesh, divisible or ragged, its shards
on the one card) adds:

2. the per-shard flag-masked kernel K15 against its plain version (two
   calls, blocks bitwise) and K3/K4 in their distributed mode (K3 on a
   shard's deep block, K4 on its halo-1 blocks; copies and maxima
   bitwise, the rest to the tolerance) on every shard of the main path's
   runs (dcavity 4096² f32 on 2x2, the ragged 3x1 and 2x2 under
   tpu_sor_layout checkerboard) and of configs/dcavity.par on 3x3 and
   configs/canal.par on 3x2 (f64, ragged); K15 on a 1x1 mesh with
   all-fluid flags against K2 (1e-12 / 1e-5 of scale: the relaxation
   factor is formed from the flags);
3. K15 per 1366x4096 shard call of 4096² f32 on the ragged 3x1 (n = 4,
   deep block 1384x4114) and K3/K4 distributed per shard call, beside
   their bounds; K15 and K16 (both redesigned: one pass through shared
   memory a call) time their `out=` form, the solvers' form, and count
   their CUDA launches a call from torch.profiler's trace; they are also
   held against their plain versions and timed on the float64 shards of
   the CLI runs that make most of their launches (configs/dcavity.par on
   3x3, configs/canal_obstacle.par on 2x2, configs/canal3d_obstacle.par
   on 2x2x2, n = 1);
4. dcavity 4096² f32 (re 1000, tpu_sor_inner 4, itermax 100, eps 0), 16
   steps after one warm-up through NS2DDistSolver on 2x2 (K13), the ragged
   3x1 (K15) and 2x2 checkerboard (K15): PRE / solve / POST and the
   exchanges' share of the step from CUDA events, the launches, the
   fields against NS2DSolver (K1) over the same 17 steps (1e-5 of scale,
   0.0 expected on 2x2); on a machine with four cards the 2x2 run once
   more with one shard per card (skipped, with a line, on one card);
   `python -m pampi_tpu_torch` on configs/dcavity.par (te cut to 0.001:
   its first solves run to itermax 1000) on 2x2 and 3x3 and
   configs/canal.par (te 0.5) on 2x2, 3x3 and 3x2, on the card and on the
   CPU: pressure.dat and velocity.dat within 1e-9, the same step count;
   and configs/dcavity.par to te 0.02 on 2x2 and 3x3 on the
   card, each in a process of its own beside those runs, against the
   single-device card run of phase 5: u, v, p within 1e-9 of scale, the
   same steps and t.

The 3-D obstacle slice (configs/canal3d_obstacle.par: a box in a channel,
flag-field masks) adds:

2. the masked mode of K5 against its plain version (float32 and float64,
   n = 1..4, two calls in the `out=` form) on the shipped 128x32x32
   flags, on an odd 63x47x31 grid with a box, on a 90x300x40 one of many
   tiles and slabs and on a 16x12x10 one smaller than a tile, fields and
   residuals bitwise; K16 against
   its plain version on every shard of 128x32x32 on 2x2x2 (n = 1 and 2,
   two calls), blocks and residuals bitwise, and on 1x1x1 against masked
   K5 (volume and residual bitwise); K7/K8 in flag mode on one device and
   on every shard of 2x2x2 (copies and maxima bitwise, the rest to the
   tolerance);
3. masked K5 against its plain version at 512x128x128 (float32 and
   float64, n = 1..4, bitwise), masked K5 (n = 4, with its CUDA launches a
   call) and K7/K8 in flag mode at 512x128x128 float32 and
   K16 per (128, 128, 512) shard of 1024x256x256 on 2x2x2 (n = 4), beside
   their bounds;
4. the shipped geometry at 512x128x128 float32 (re 100, tpu_sor_inner 4,
   itermax 100, eps 0), 16 steps after one warm-up, through NS3DSolver
   and through NS3DDistSolver on 2x2x2 (one card): the split, the
   exchanges' share, the launches (no K6, K14 or unmasked K5/K7/K8), the
   mesh fields against one device (1e-5 of scale, 0.0 expected);
5. `python -m pampi_tpu_torch configs/canal3d_obstacle.par` as shipped on
   the card, once on one device and once with tpu_mesh 2x2x2 (in a
   process of its own, `--cli3-child`): fields 1e-9 of scale apart, the
   same steps and t; and cut to te 0.5 (binary VTK) on the card against
   the CPU (its own process): 1e-9 of scale, the same steps.

The 2-D obstacle slice (configs/canal_obstacle.par: a box in a 16x4
channel, flag-field masks) and K17 add:

2. the masked mode of K2 (float32 and float64, n = 1 and 4, two calls),
   K3/K4 in flag mode on one device, K15 on the real flags and K3/K4's
   distributed flag mode on every shard of 2x2 and the ragged 3x2, all on
   the box scaled onto 1024x256 and 1023x257; K17 on 1024² and 1023x1021
   against its plain version and against K2 at n_inner 1. Fields, copies,
   maxima and the residuals of masked K2 and K17 bitwise (K15's residual
   and K3/K4's F/G/rhs are also held to the tolerance);
3. masked K2 (n = 4, and n = 1 for the residual sum's fixed cost) and
   K3/K4 in flag mode at 8192x2048 float32 (the box 512x512 cells), K17
   at 4096², K15 per 4096x1024 shard of 8192x2048 on 2x2 on the real
   flags (n = 4), beside their bounds;
4. canal_obstacle.par's geometry at 8192x2048 float32 (re 100,
   tpu_sor_inner 4, itermax 100, eps 0), 16 steps after one warm-up,
   through NS2DSolver and NS2DDistSolver on 2x2 (one card): the split,
   the exchanges' share, the launches (no K1, K13 or unmasked K2/K3/K4),
   the mesh fields against one device (1e-5 of scale, 0.0 expected),
   then K15 and K3/K4 on that run's own shards; Poisson 4096² float32
   through make_rb_step_padded, kernel "blocked" (K17) and "fused" (K2 at
   n_inner 1), 400 iterations each: fields bitwise;
5. `python -m pampi_tpu_torch configs/canal_obstacle.par` at te 0.5 on
   the card on one device, and with tpu_mesh 2x2 and 3x2 and on the CPU in
   processes of their own (`--cli2-child`): fields 1e-9 of scale from the
   one-card run, the same steps (and t on the card); and
   configs/canal_obstacle2048.par at te 0.1 on one card.

K13 and masked K2, redesigned as one pass through shared memory a call
(one launch, the solvers' `out=` form), add or extend:

2. K13 against its plain version, float32 and float64, n = 1..4, planes
   and residuals bitwise, in the `out=` form, on every case
   above and on every shard of 1024x680 on 2x2 (planes of several tiles,
   cut at the planes' edges); masked K2 the same way at n = 1..4;
3. K13 on the four 2048² shards of 4096² at float32 and float64, n =
   1..4, bitwise, then its time and its CUDA launches a call at n = 4 and
   1 (torch.profiler's trace; must be 1); masked K2 at 8192x2048 the same
   way; both at the CLI runs' float64 shapes at n = 1 (configs/
   dcavity.par's 50² shards on 2x2, canal_obstacle.par, canal_obstacle2048
   .par): bitwise, ms a call, bound, one launch a call;
5. poisson.par on 2x2 must take 2388 iterations on the card and the CPU,
   and canal_obstacle2048.par, cut to te 0.004, on one card against the
   CPU (its own process): fields 1e-9 of scale, the same steps.

The fleet's shape-class mg lane (K18, the one-launch class V-cycle)
adds:

2. K18 against its plain version, float32 and float64, three chained
   cycles, in the 16², 64² and 256² classes, each with a full-class lane,
   an odd 9x13 lane (a one-level plan: the bottom sweeps run at level 0),
   a 12x12 lane whose plan stops early, a ragged lane and an inactive one:
   fields and residuals bitwise, the inactive lane passed through; 50
   class solves of one 8-lane batch of the 64² class with identical
   cycle counts and bitwise fields;
3. K18 at bucket A's shape (256 lanes of the 64² class, float32) beside
   its bound;
4. FleetScheduler(classes="on") on the card, float32, with the launch
   counts reset: bucket A, 256 dcavity mg requests in the 64² class
   (tools/perf_fleet.py --classes at its TPU size: imax 48 + i%17, jmax 64
   - i%17, re 10, te 0.05, itermax 10 V-cycles), and bucket B, 32 canal
   mg requests in the 256² class (imax 256 - 2i, jmax 160 + 3i,
   configs/canal.par's physics on a square 4x4 box, each lane's te 20 of
   its first steps), served cold and then warm with fresh ids: scenarios/s
   from the run walls, ms per chunk, K18's calls and ms per call (CUDA
   events around its wrapper); every lane finite, none diverged, only K18
   launched, the warm run bitwise the cold one; four of bucket A's
   requests served alone in the 128² class, bitwise their bucket-A lanes;
5. 8 mg class requests (dcavity in the 16² class, canal in the 32² class)
   and a sor request (a class lane since the sor class lane, below),
   float64, on the card and on the CPU: fields within 1e-9 of scale, the
   same steps.

The obstacle multigrid on one card (the masked mode of K9-K12) adds:

2. masked DOWN and UP against their plain versions, float32 and float64,
   bitwise, on canal_obstacle.par's box at 1024x256, an odd box on two
   walls at 512² (coarsening keeps it on every level's edge),
   canal3d_obstacle.par as shipped and an odd box on three walls at 64³;
3. the masked mode once more at 8192x2048 and 512x128x128 float32 (the
   obstacle paths' geometries) and its times beside the bound;
4. NS-2D canal_obstacle 8192x2048 and NS-3D canal3d_obstacle 512x128x128
   float32 under tpu_solver mg (re 100, eps 0, 4 V-cycles a step), 16
   steps after one warm-up: ms/step, PRE / solve / POST and the cycle's
   DOWN / bottom / UP / residual check from CUDA events, beside the masked
   SOR steps of the same run; the 2-D ladder (tpu_mg_fused off, masked K2
   at omega = 1 on its large levels) for 4 steps; only the masked cycle
   (or masked K2) launched;
5. `python -m pampi_tpu_torch` with tpu_solver auto on
   configs/canal_obstacle.par and canal3d_obstacle.par at te 0.5 on the
   card and on the CPU (processes of their own): fields within 1e-9 of
   scale, the same steps; and configs/canal_obstacle2048.par at te 0.1 on
   the card, with its seconds.

NS-3D on a mesh that does not divide the grid (the ragged pad-with-mask
decomposition: ceil-divided shards whose trailing cells are dead; K8's
ragged mode, the live-mask multiply, and K7 at uneven shard bounds)
adds:

2. K7 on every shard's deep block and K8 in its ragged mode on its
   halo-1 blocks against their plain versions, float32 and float64,
   without and with a box's flags, on configs/dcavity3d.par's 128³ on
   1x2x3 (six 128x64x43 shards) and 9x64x64 on 4x1x1 (the last shard
   holds only the HI ghost plane and dead cells), and in flag mode on
   the obstacle path's 512x128x128 on 1x2x3: copies, maxima and the dead
   cells (0) bitwise, the rest to the tolerance;
3. K7 and K8's ragged mode (and its unragged mode on the same block) per
   call at the two paths' last shards, float32, beside their bounds;
4. configs/dcavity3d.par 128³ float32 (itermax 100, eps 0) and
   canal3d_obstacle.par's geometry at 512x128x128 float32 on the ragged
   1x2x3, 16 and 7 steps after one warm-up through NS3DDistSolver: PRE /
   solve / POST and the exchanges' share from CUDA events, the fields
   against one device (1e-5 of scale), K14, K16, K5, K6 and K8's
   unragged modes never launched;
5. `python -m pampi_tpu_torch` on configs/canal3d.par with tpu_mesh
   2x3x3 and canal3d_obstacle.par with 3x3x3, te cut to 0.1, on the card,
   and cut to 0.04 (one step) on the CPU, each in a process of its own,
   against one card at the same te: fields within 1e-9 of scale, the
   same steps.

The fleet's sor shape-class lane (the dynamic-extent mode of K2 and the
class mode of K3/K4, entries `rb_sor_class`, `ns2d_pre_class`,
`ns2d_post_class`) adds:

2. each against its plain version, float32 and float64, on bucket A's 256
   lanes of the 64² class, a mixed 8-lane batch of the 64² class (a 64x64
   lane, a 12x12 one, a 33x61 one, a canal-box lane, one that does not
   step, three more) and 4 lanes of the 256² class: K2 at n = 4 then 1
   (per-lane residuals bitwise, fields to the tolerance, dead cells and
   the lane that does not solve untouched), K3/K4 with the dcavity and the
   canal boundary sets (copies and maxima bitwise, F/G/rhs and the
   projected fields to the tolerance, dead cells 0);
3. the three at bucket A's shape, float32, beside their bounds (bytes:
   each lane's class block, p and rhs read and p written for K2, 5
   field-sizes for K3/K4);
4. FleetScheduler(classes="on") on the card, float32, with the launch
   counts reset: bucket A as 256 dcavity sor requests (tools/
   perf_fleet.py --classes at its TPU size) and bucket B as 32 canal sor
   requests in the 256² class (the mg buckets' extents and end times,
   canal.par's itermax 500), served cold and then warm with fresh ids:
   scenarios/s from the run walls, ms per chunk, each class-mode kernel's
   calls and ms per call (CUDA events around its wrapper), the host-sync
   share of the solve (its wall blocked in the per-round residual
   read-backs); every lane finite, none diverged, only the three
   class-mode kernels launched, warm bitwise cold, four of bucket A
   alone in the 128² class bitwise their bucket-A lanes; then bucket A's
   first 32 requests served solo, for contrast (printed, not gated);
5. 8 sor class requests (dcavity in the 16², canal in the 32² class,
   float64) under tpu_fuse_phases auto and on, one step a chunk, on the
   card and on the CPU: fields within 1e-9 of scale, the same steps and
   per-step iteration counts.

The fleet's 3-D shape-class rungs (the class mode of K7/K8, entries
`ns3d_pre_class`, `ns3d_post_class`, around the masked class solve in
plain torch) add:

2. both against their plain versions, float32 and float64, on bucket C's
   128 lanes of the 32³ class, a mixed 6-lane batch of the 16³ class (a
   16³ lane, an 8³ one, a 10x9x8 one, a canal3d-box lane, one that does
   not step, one more) and 4 lanes of the 64x16x16 class, with the
   dcavity3d and the canal3d boundary sets: copies, dead cells (0) and
   maxima bitwise, F/G/H/rhs and the projected fields to the tolerance,
   the lane that does not step passed through bitwise;
3. both at bucket C's shape, float32, beside their bounds (7 field-sizes
   each over the lanes' live corners);
4. FleetScheduler(classes="on") on the card, float32, with the launch
   counts reset: bucket C as 128 dcavity3d sor requests in the 32³ class
   (the 2-D bucket A's knobs) and bucket D as 16 canal3d sor requests in
   the 64x16x16 class (configs/canal3d.par's physics, te 1.0), served
   cold and then warm with fresh ids: scenarios/s from the run walls, ms
   per chunk, each class kernel's calls and ms per call (CUDA events
   around its wrapper), the solve's share of the run and the host-sync
   share of the solve; every lane finite, none diverged, only class K7
   and class K8 launched, warm bitwise cold, four of bucket C alone in
   the 64³ class bitwise their bucket-C lanes; then bucket C's first 16
   requests served solo, for contrast (printed, not gated);
5. dcavity3d 8³ and 10x9x8 in the 16³ class and canal3d 20x10x10 in the
   32x16x16 class (float64) under tpu_fuse_phases auto and off, one step
   a chunk, on the card and on the CPU: fields within 1e-9 of scale, the
   same steps and per-step iteration counts.

The overlapped exchange schedule (`tpu_overlap on`; the grid-band mode of
K3 and K7, entries `ns2d_pre_band`, `ns3d_pre_band`) adds:

2. both halves (the interior and the boundary bands of the port's region
   plan) of each band mode on every shard of dcavity 4096² on 2x2,
   canal_obstacle.par on 2x2 (flags), dcavity3d 128³ and
   canal3d_obstacle.par on 2x2x2 (flags), float32 and float64: the BCs and
   every output on the bands' rows bitwise the full call's, and within the
   tolerance of the band plain version;
3. each half on a 2048² shard of 4096² and a 64³ shard of 128³, float32,
   beside the full call and the bound (the bytes of the rows it covers,
   over 3.35 TB/s and over the card's rate measured by a 1 GiB copy);
4. NS-2D dcavity 4096² f32 on 2x2 (K13) and NS-3D dcavity3d 128³ f32 on
   2x2x2 (K14), 16 steps after a warm-up with `tpu_overlap on` and with
   `off`, each with the launch counts reset: ms/step, the PRE / solve /
   POST split, fields bitwise, t and the counts equal, and from
   torch.profiler's trace of two more steps the side stream's device time
   and the part of it beside the main stream's work; configs/dcavity.par
   f64 on 2x2 with `on`, four steps (two a call, then two in one), card
   against CPU: each step's count, t, fields within 1e-12 of scale;
   configs/canal_obstacle.par on 2x2 (flag K3 band, K15), five steps, `on`
   against `off`: counts, t and fields bitwise.

`tpu_dtype bfloat16` (K1's bf16-storage mode, entry
`rb_sor_quarters_bf16`: bf16 planes, float32 inside a call, one launch a
call; K3/K4 at bf16, entries `ns2d_pre_bf16`, `ns2d_post_bf16`: every
operation rounded to bf16) adds:

2. K1 bf16 against its plain version at 1024² and 1022x1020, n = 1..4,
   three chained calls in the `out=` form, and at n = 40 (a call in
   passes): planes and the float32 residual bitwise; K3/K4 bf16 on
   dcavity and canal 1024²: u', v' copies and maxima bitwise, F, G, rhs,
   u'', v'' bitwise or within 1 bf16 ulp of scale, the count of differing
   cells logged;
3. K1 bf16 at 4096² (n = 4) beside K1 float32 in the same run, and
   K3/K4 bf16 at 4096²: ms a call (CUDA events), CUDA launches a call
   (torch.profiler), the bound (2 bytes a cell);
4. Poisson 4096² bf16 (400 iterations, tpu_sor_inner 4): ms/iteration;
   NS-2D dcavity 4096² (itermax 100, eps 0) at bf16 and float32, 16
   steps after a warm-up: ms/step, PRE / solve / POST; u and v of the bf16
   run within 0.05 of scale of the float32 run, the p gap logged;
5. `python -m pampi_tpu_torch` on configs/dcavity.par at bf16, te cut
   to 0.0025 (eps 1e-3 lies under the bf16 floor: every solve runs its
   1000 iterations), on the card and on the CPU (a process of its own):
   the same steps, the .dat fields within 1 bf16 ulp of scale.

K6's on-chip design (entry `rb_sor3d_octants_onchip`: one cooperative
launch a call, each CTA's tile of the octants in shared memory; the
multi-launch design keeps `rb_sor3d_octants` for fields past the capacity
rule) and flag K7's tiled launch (no snapshot of u, v, w) add:

2. K6 at configs/dcavity3d.par's 128³ float32 and configs/canal3d.par's
   200x50x50 float64, n = 1..4, two calls: the on-chip design ran (its
   counter and the dispatch record), volume and residual bitwise the
   plain version's; the phases above hold K6 multi-launch at 256³, K14 on
   1x1x1 bitwise K6's volume, and flag K7 on one device, on the 2x2x2
   deep blocks, at the 1x2x3 uneven bounds and in both band halves;
3. flag K7's CUDA launches a call (torch.profiler) beside its time, and
   whether F/G/H/rhs came out bitwise;
4. the NS-3D main paths count K6 on chip (dcavity3d.par 128³ and
   canal3d.par) and fail on a multi-launch call there.

K1 in one pass a call (q_tiled: one launch with `out=`, the residual per
tile in an order its plain version repeats) and K2's class mode in one
launch (cls_tiled) add:

2. K1 bitwise its plain version, planes and residual, at 4096², 1022x1020
   and 100², float32 and float64, n = 1..4, two chained calls out of place
   and one in place, and its CUDA launches a call (torch.profiler: 1 at
   4096² n = 4 and 100² n = 1 and 4); phase 2's other K1 checks (1024²,
   the n = 1 cadence) bitwise too; class K2 out of place into a block that
   held NaN (n = 4, 1 and 30, a call in passes): residuals and blocks
   bitwise, dead cells and lanes that do not solve copied;
3. K1 timed out of place, as the solve loop calls it, with its CUDA
   launches a call; class K2 timed out of place.

It then prints the kernels line (JSON; K5-K8 and K11/K12 at 256³, where a
field outgrows the L2 and the bound is a floor, with their 128³ numbers
under main_shape_* keys, K6 on chip at 128³, the distributed modes of
K3/K4 and K7/K8 under dist_* keys and K7 at uneven bounds under
ragged_* keys), the card's name and power limit from nvidia-smi, and as
its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

`python3 chip_smoke.py --kernel-times [ROOT [PREFIX ...]]` times only
K1 (4096² float32 and float64 n = 4, the 100² CLI call float64 n = 1,
bf16 at 4096² and 100² n = 4), K2's class mode (bucket A: 256 lanes of
the 64² class; bucket B: 32 lanes of the 256² class; float32 n = 4), K13,
masked K2, K15, masked K5, K14, K16, K6 (128³ float32 n = 4,
canal3d.par float64 n = 1, 256³ float32 n = 4) and flag K7
(512x128x128 float32, canal3d_obstacle.par float64) of the package under
ROOT (another checkout: run old, new, new, old in one call on the card to
compare two), or the rows whose keys start with a PREFIX (k1_, k1bf16,
k2c, k6, k7f, ...), and prints one JSON line.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from types import SimpleNamespace
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
FP64_FLOPS = 34e12          # H100 SXM float64 outside the tensor cores
MAIN = (4096, 4096)         # the 2-D main path's grid (jmax, imax)
MAIN3 = (128, 128, 128)     # the NS-3D main path's grid (kmax, jmax, imax)
BIG3 = (256, 256, 256)      # where a 3-D field (68.7 MB) outgrows the L2
# --checks-only: the first call after a kernel edit; builds with the
# compiler's register/shared-memory report and stops after phase 2
CHECKS_ONLY = "--checks-only" in sys.argv
FAILED = []


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name):
    """Run fn as a named phase; a failure is recorded, not raised."""
    def wrap(fn):
        def run(*a, **kw):
            log(f"== {name}")
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
            except Exception:  # every phase failure is reported, then fails the run
                traceback.print_exc()
                FAILED.append(name)
                log(f"-- {name}: FAILED")
                return None
            log(f"-- {name}: ok ({time.perf_counter() - t0:.1f} s)")
            return out
        return run
    return wrap


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn over reps back-to-back calls (after one
    warm-up call), from CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def rng_fields(torch, np, shape, dtype, n, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape)).to("cuda", dtype)
            for _ in range(n)]


def tol(torch, dtype) -> float:
    # kernel and plain version keep the same association, so fields agree
    # bitwise; the sum of r² is reduced in another order, which moves it by
    # at most ~log2(n)·ulp (~1e-6 f32, ~2e-15 f64 at 4096²). The limit holds
    # fields relative to their scale and the residual relative to itself.
    return 1e-12 if dtype == torch.float64 else 1e-5


def rel_err(a, b) -> float:
    scale = max(1.0, float(b.abs().max()))
    return float((a - b).abs().max()) / scale


def bound(nbytes, flops, peak=FP32_FLOPS):
    """(ms, "bytes" | "operations"): the larger of bytes over the memory
    rate and operations over the card's peak rate for their type (float32
    unless `peak` says otherwise)."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def cuda_launches(torch, fn, calls=20):
    """The device operations (kernels, copies, fills) of one call of fn,
    counted in torch.profiler's trace of `calls` calls after a warm-up
    call and rounded (the trace has been seen to miss one event of a
    run); None where the trace holds none (the profiler cannot see the
    card): the count is then not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return round(n / calls) if n else None


def device_trace(torch, fn, calls=20):
    """(device operations, their device ms) per call of fn, from
    torch.profiler's trace of `calls` calls after a warm-up call: the
    count as cuda_launches takes it, and the sum of those operations'
    durations on the card (busy time: gaps between them excluded). (None,
    None) where the trace holds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        return None, None
    busy = sum(e.time_range.end - e.time_range.start for e in ops) / 1e3
    return round(len(ops) / calls), busy / calls


def launches_text(n):
    return "not measured" if n is None else f"{n:g}"


@phase("build")
def build_kernels():
    from pampi_tpu_torch.kernels import build as kb

    t0 = time.perf_counter()
    secs = kb.build(verbose=CHECKS_ONLY)
    log(f"build seconds: {json.dumps({k: round(v, 2) for k, v in secs.items()})}"
        f" (wall {time.perf_counter() - t0:.2f} s)")


@phase("kernels vs plain versions")
def check_kernels(torch, np):
    from pampi_tpu_torch.ops import ns2d_fused as nf
    from pampi_tpu_torch.ops import sor_kernels as sk
    from pampi_tpu_torch.ops.sor_quarters import stack_quarters
    from pampi_tpu_torch.utils.params import Parameter

    bad = []
    for dtype in (torch.float32, torch.float64):
        t = tol(torch, dtype)
        for J, I in ((1024, 1024), (1023, 1021)):
            shape = (J + 2, I + 2)
            fac, idx2, idy2 = sk.sor_coefficients(1.0 / I, 1.0 / J, 1.9)
            p, rhs = rng_fields(torch, np, shape, dtype, 2, 11)
            layouts = [("rb_sor_checkerboard", sk.rb_sor_checkerboard,
                        sk.rb_sor_checkerboard_plain, p, rhs)]
            if J % 2 == 0 and I % 2 == 0:
                layouts.append(("rb_sor_quarters", sk.rb_sor_quarters,
                                sk.rb_sor_quarters_plain,
                                stack_quarters(p), stack_quarters(rhs)))
            for name, kern, plain, x, f in layouts:
                xk, xp = x.clone(), x.clone()
                for _ in range(3):  # ghosts carried across calls
                    rk = kern(xk, f, 4, fac, idx2, idy2)
                    rp = plain(xp, f, 4, fac, idx2, idy2)
                e = rel_err(xk, xp)
                er = abs(float(rk) - float(rp)) / abs(float(rp))
                ok = e <= t and er <= t
                if name == "rb_sor_quarters":  # one pass a call: bitwise
                    ok = torch.equal(xk, xp) and torch.equal(rk, rp)
                log(f"{name} {dtype} {J}x{I}: field max_rel_err {e:.3e}, "
                    f"residual rel_err {er:.3e} (tol {t:g}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    bad.append(name)
            for problem, bc in (("dcavity", (1, 1, 1, 1)),
                                ("canal", (3, 3, 1, 1))):
                param = Parameter(name=problem, imax=I, jmax=J, re=100.0,
                                  bcLeft=bc[0], bcRight=bc[1],
                                  bcBottom=bc[2], bcTop=bc[3])
                cfg = nf.StepConfig.from_param(param)
                u, v, pp = rng_fields(torch, np, shape, dtype, 3, 5)
                dt = torch.tensor(0.013, dtype=dtype, device="cuda")
                uk, vk = u.clone(), v.clone()
                fk, gk, rk = nf.ns2d_pre(uk, vk, dt, cfg)
                u1, v1, f1, g1, r1 = nf.ns2d_pre_plain(u, v, dt, cfg)
                copies = torch.equal(uk, u1) and torch.equal(vk, v1)
                e = max(rel_err(fk, f1), rel_err(gk, g1), rel_err(rk, r1))
                ok = copies and e <= t
                log(f"ns2d_pre {problem} {dtype} {J}x{I}: u', v' bitwise "
                    f"{copies}, F/G/rhs max_rel_err {e:.3e} (tol {t:g}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    bad.append("ns2d_pre")
                umax, vmax = nf.ns2d_post(uk, vk, fk, gk, pp, dt, cfg.dx,
                                          cfg.dy)
                u2, v2, um2, vm2 = nf.ns2d_post_plain(
                    u1, v1, f1, g1, pp, dt, cfg.dx, cfg.dy)
                e = max(rel_err(uk, u2), rel_err(vk, v2))
                own = (torch.equal(umax, uk.abs().max())
                       and torch.equal(vmax, vk.abs().max()))
                em = max(abs(float(umax - um2)), abs(float(vmax - vm2)))
                ok = e <= t and own and em <= t * max(1.0, float(um2))
                log(f"ns2d_post {problem} {dtype} {J}x{I}: u'', v'' "
                    f"max_rel_err {e:.3e}, maxima bitwise vs own fields "
                    f"{own}, vs plain {em:.3e} (tol {t:g}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    bad.append("ns2d_post")
    if bad:
        raise AssertionError(f"kernels disagree with plain versions: {bad}")


@phase("K1 vs its plain version, bitwise: 4096², 1022x1020 and 100², "
       "float32 and float64, n = 1..4, out of place and in place; its "
       "CUDA launches a call")
def check_k1(torch, np):
    """K1 (one pass through shared memory a call) against its
    plain version: planes and residual bitwise, two chained calls as the
    solve loop makes them (`out=`, the planes swapped), then one in place;
    one CUDA launch a call with `out=` at 4096² n = 4 and 100² n = 1
    (torch.profiler's trace)."""
    from pampi_tpu_torch.ops import sor_kernels as sk
    from pampi_tpu_torch.ops.sor_quarters import stack_quarters

    bad = []
    for dtype in (torch.float32, torch.float64):
        for J, I in ((4096, 4096), (1022, 1020), (100, 100)):
            coef = sk.sor_coefficients(1.0 / I, 1.0 / J, 1.9)
            p, rhs = rng_fields(torch, np, (J + 2, I + 2), dtype, 2, 13)
            q, f = stack_quarters(p), stack_quarters(rhs)
            del p, rhs
            for n in (1, 2, 3, 4):
                qk, qp, out = q.clone(), q.clone(), torch.empty_like(q)
                same = True
                for _ in range(2):
                    keep = qk.clone()
                    rk = sk.rb_sor_quarters(qk, f, n, *coef, out=out)
                    same = same and torch.equal(qk, keep)
                    qk, out = out, qk
                    rp = sk.rb_sor_quarters_plain(qp, f, n, *coef)
                    same = (same and torch.equal(qk, qp)
                            and torch.equal(rk, rp))
                ri = sk.rb_sor_quarters(qk, f, n, *coef)
                rp = sk.rb_sor_quarters_plain(qp, f, n, *coef)
                same = same and torch.equal(qk, qp) and torch.equal(ri, rp)
                log(f"rb_sor_quarters {dtype} {J}x{I} n={n}: planes and "
                    f"residual bitwise {same} {'ok' if same else 'FAIL'}")
                if not same:
                    bad.append(f"{dtype} {J}x{I} n={n}")
                del qk, qp, out
            if (J, n) in ((4096, 4), (100, 4)):
                out = torch.empty_like(q)
                for m in ((4,) if J == 4096 else (1, 4)):
                    n_dev = cuda_launches(torch, lambda: sk.rb_sor_quarters(
                        q, f, m, *coef, out=out))
                    log(f"rb_sor_quarters {dtype} {J}x{I} n={m}: "
                        f"{launches_text(n_dev)} CUDA launches a call "
                        f"(torch.profiler)")
                    if n_dev is not None and n_dev != 1:
                        bad.append(f"{dtype} {J}x{I} n={m}: {n_dev} launches")
            del q, f
            torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version: {bad}")


CASES_3D = (("dcavity3d", {}),
            ("canal3d", dict(bcLeft=3, bcRight=3, bcFront=2, bcBack=2)))


def check_sor3d(kern, plain, x, f, n_inner, coef, tol_):
    """Three consecutive calls of a 3-D SOR kernel and its plain version
    on copies of x (the ghosts carried across calls). Returns (field
    max_rel_err, residual rel_err, max_abs_err, ok)."""
    xk, xp = x.clone(), x.clone()
    for _ in range(3):
        rk = kern(xk, f, n_inner, *coef)
        rp = plain(xp, f, n_inner, *coef)
    e = rel_err(xk, xp)
    er = abs(float(rk) - float(rp)) / abs(float(rp))
    return e, er, float((xk - xp).abs().max()), e <= tol_ and er <= tol_


def check_step3d(torch, u, v, w, p, dt, cfg, tol_, flags=None):
    """K7 then K8 against their plain versions on copies of u, v, w (in
    the flag mode with `flags`). Returns (copies bitwise, F/G/H/rhs
    max_rel_err, u''/v''/w'' max_rel_err, maxima bitwise vs own fields,
    maxima vs plain, K7's max_abs_err over its outputs, K8's max_abs_err
    over its outputs, ok)."""
    from pampi_tpu_torch.ops import ns3d_fused as nf3

    def abs_err(pairs):
        return max(float((a - b).abs().max()) for a, b in pairs)

    uk, vk, wk = u.clone(), v.clone(), w.clone()
    fk, gk, hk, rk = nf3.ns3d_pre(uk, vk, wk, dt, cfg, flags=flags)
    u1, v1, w1, f1, g1, h1, r1 = nf3.ns3d_pre_plain(u, v, w, dt, cfg,
                                                    flags=flags)
    walls = ((uk, u1), (vk, v1), (wk, w1))
    copies = all(torch.equal(a, b) for a, b in walls)
    pre = ((fk, f1), (gk, g1), (hk, h1), (rk, r1))
    e_pre = max(rel_err(a, b) for a, b in pre)
    err_pre = abs_err(walls + pre)
    maxima = nf3.ns3d_post(uk, vk, wk, fk, gk, hk, p, dt, cfg.dx, cfg.dy,
                           cfg.dz, flags=flags)
    u2, v2, w2, *pm = nf3.ns3d_post_plain(u1, v1, w1, f1, g1, h1, p, dt,
                                          cfg.dx, cfg.dy, cfg.dz,
                                          flags=flags)
    post = ((uk, u2), (vk, v2), (wk, w2))
    e_post = max(rel_err(a, b) for a, b in post)
    em = max(abs(float(m - q)) for m, q in zip(maxima, pm))
    err_post = max(abs_err(post), em)
    own = all(torch.equal(m, a.abs().max())
              for m, a in zip(maxima, (uk, vk, wk)))
    scale = max(1.0, *(float(q) for q in pm))
    ok = copies and e_pre <= tol_ and e_post <= tol_ and own and \
        em <= tol_ * scale
    return copies, e_pre, e_post, own, em, err_pre, err_post, ok


def check_grid_3d(torch, np, params, dtype):
    """K5, K6 (on an even grid), K7 and K8 against their plain versions on
    the grid of params[0] in dtype; K7/K8 once for each param's boundary
    conditions. Returns the names of the kernels that disagree."""
    from pampi_tpu_torch.ops import ns3d_fused as nf3
    from pampi_tpu_torch.ops import sor3d_kernels as sk3
    from pampi_tpu_torch.ops.sor3d import sor_coefficients_3d
    from pampi_tpu_torch.ops.sor_octants import stack_octants

    bad = []
    t = tol(torch, dtype)
    g = params[0]
    K, J, I = g.kmax, g.jmax, g.imax
    shape = (K + 2, J + 2, I + 2)
    coef = sor_coefficients_3d(g.xlength / I, g.ylength / J, g.zlength / K,
                               g.omg)
    p, rhs = rng_fields(torch, np, shape, dtype, 2, 13)
    layouts = [("rb_sor3d_checkerboard", sk3.rb_sor3d_checkerboard,
                sk3.rb_sor3d_checkerboard_plain, p, rhs)]
    if K % 2 == 0 and J % 2 == 0 and I % 2 == 0:
        layouts.append(("rb_sor3d_octants", sk3.rb_sor3d_octants,
                        sk3.rb_sor3d_octants_plain,
                        stack_octants(p), stack_octants(rhs)))
    for name, kern, plain, x, f in layouts:
        e, er, _err, ok = check_sor3d(kern, plain, x, f, 4, coef, t)
        log(f"{name} {dtype} {K}x{J}x{I}: field max_rel_err {e:.3e}, "
            f"residual rel_err {er:.3e} (tol {t:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"{name} {K}x{J}x{I}")
    for param in params:
        cfg = nf3.StepConfig3D.from_param(param)
        bcs = "".join(str(b) for b in (
            param.bcTop, param.bcBottom, param.bcLeft, param.bcRight,
            param.bcFront, param.bcBack))
        u, v, w, pp = rng_fields(torch, np, shape, dtype, 4, 17)
        dt = torch.tensor(0.013, dtype=dtype, device="cuda")
        copies, e_pre, e_post, own, em, _ep, _eq, ok = check_step3d(
            torch, u, v, w, pp, dt, cfg, t)
        log(f"ns3d_pre/post {param.name} (BCs t/b/l/r/f/b {bcs}) {dtype} "
            f"{K}x{J}x{I}: u', v', w' bitwise {copies}, F/G/H/rhs "
            f"max_rel_err {e_pre:.3e}, u'', v'', w'' max_rel_err "
            f"{e_post:.3e}, maxima bitwise vs own fields {own}, vs plain "
            f"{em:.3e} (tol {t:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"ns3d_pre/post {param.name} {bcs} {K}x{J}x{I}")
    return bad


@phase("3-D kernels vs plain versions")
def check_kernels_3d(torch, np):
    from pampi_tpu_torch.utils.params import Parameter, read_parameter
    from pampi_tpu_torch.utils.precision import resolve_dtype

    bad = []
    for dtype in (torch.float32, torch.float64):
        for K, J, I in ((32, 48, 64), (31, 47, 63)):
            bad += check_grid_3d(torch, np, [
                Parameter(name=problem, imax=I, jmax=J, kmax=K, re=100.0,
                          omg=1.8, **bckw)
                for problem, bckw in CASES_3D], dtype)
    # the canal3d main path's grid (200x50x50), dtype (float64) and
    # boundary conditions, and the same grid with slip front/back faces
    canal = read_parameter(os.path.join(ROOT, "configs", "canal3d.par"))
    bad += check_grid_3d(torch, np, [canal, canal.replace(bcFront=2,
                                                          bcBack=2)],
                         resolve_dtype(canal.tpu_dtype))
    if bad:
        raise AssertionError(f"3-D kernels disagree with plain versions: {bad}")


@phase("K6 on chip vs its plain version at the main path's fields")
def check_k6_onchip(torch, np):
    """K6 at configs/dcavity3d.par's 128³ float32 and configs/canal3d.par's
    200x50x50 float64 (its lengths and omega), n = 1..4, two calls: the
    on-chip design ran (its counter, the record), volume and residual
    bitwise the plain version's."""
    from pampi_tpu_torch.ops import sor3d_kernels as sk3
    from pampi_tpu_torch.ops.sor3d import sor_coefficients_3d
    from pampi_tpu_torch.ops.sor_octants import stack_octants
    from pampi_tpu_torch.utils import dispatch

    canal = config("canal3d.par")
    bad = []
    for param, dtype in ((config("dcavity3d.par"), torch.float32),
                         (canal, torch.float64)):
        K, J, I = param.kmax, param.jmax, param.imax
        coef = sor_coefficients_3d(param.xlength / I, param.ylength / J,
                                   param.zlength / K, param.omg)
        p, rhs = rng_fields(torch, np, (K + 2, J + 2, I + 2), dtype, 2, 211)
        q, f = stack_octants(p), stack_octants(rhs)
        del p, rhs
        for n in (1, 2, 3, 4):
            xk, xp = q.clone(), q.clone()
            before = sk3.RB_SOR3D_OCTANTS_ONCHIP.launches
            for _ in range(2):  # ghosts carried across calls
                rk = sk3.rb_sor3d_octants(xk, f, n, *coef)
                rp = sk3.rb_sor3d_octants_plain(xp, f, n, *coef)
            design = dispatch.last("sor3d_octants")
            ran = sk3.RB_SOR3D_OCTANTS_ONCHIP.launches - before
            vol, res = torch.equal(xk, xp), torch.equal(rk, rp)
            ok = vol and res and ran == 2 and design.startswith("on chip")
            log(f"rb_sor3d_octants {param.name} {I}x{J}x{K} {dtype} n={n}, "
                f"two calls ({design}; {ran} on-chip launches): volume "
                f"bitwise {vol}, residual bitwise {res}, max_abs_err "
                f"{float((xk - xp).abs().max()):.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"{param.name} {dtype} n={n}")
    if bad:
        raise AssertionError(f"K6 on chip differs from its plain version: "
                             f"{bad}")


def repeat_solve(torch, label, solve, p0, rhs, eps, cap=20000):
    """50 solves of the same problem: identical iteration counts and
    residuals, bitwise identical fields, and convergence."""
    first = None
    for _ in range(50):
        p, res, it = solve(p0.clone(), rhs)
        if first is None:
            first = (p, res, it)
        elif it != first[2] or res != first[1] or not torch.equal(p, first[0]):
            raise AssertionError(
                f"{label}: solve not reproducible ({it} vs {first[2]})")
    if not first[1] < eps * eps:
        raise AssertionError(f"{label}: no convergence ({first[1]})")
    log(f"{label}: 50 solves, {first[2]} iterations each (cap {cap}), "
        f"residual {first[1]:.6e} (eps² {eps * eps:g}), fields bitwise "
        f"identical")


@phase("iteration counts over 50 solves")
def check_repeat_solves(torch):
    from pampi_tpu_torch.models.ns3d import make_pressure_solve_3d
    from pampi_tpu_torch.models.poisson import (
        init_fields,
        make_pressure_solve,
        make_solver_fn,
    )
    from pampi_tpu_torch.utils.params import Parameter

    for layout, dtype, (J, I), eps in (
            ("quarters", torch.float32, (128, 128), 1e-2),
            ("checkerboard", torch.float64, (127, 125), 1e-5)):
        param = Parameter(imax=I, jmax=J)
        p0, rhs = init_fields(param, 2, dtype, "cuda")
        solve = make_solver_fn(I, J, 1.0 / I, 1.0 / J, 1.9, eps, 20000,
                               dtype, n_inner=4, layout=layout)
        repeat_solve(torch, f"{layout} {dtype} {J}x{I}", solve, p0, rhs, eps)

    for layout, dtype, (K, J, I), eps in (
            ("octants", torch.float32, (32, 32, 32), 1e-2),
            ("checkerboard", torch.float64, (31, 33, 29), 1e-4)):
        # rhs = sin(2π i dx) on the interior (zero mean), p starts at 0
        rhs = sine_rhs(torch, (K, J, I), dtype)
        p0 = torch.zeros_like(rhs)
        solve = make_pressure_solve_3d(I, J, K, 1.0 / I, 1.0 / J, 1.0 / K,
                                       1.8, eps, 20000, dtype, n_inner=4,
                                       layout=layout, device="cuda")
        repeat_solve(torch, f"3-D {layout} {dtype} {K}x{J}x{I}", solve, p0,
                     rhs, eps)

    # the fused MG cycle: 2-D 1024² float64 (3 levels), 3-D 64x96x128
    # float32 (3 levels), each stopping on eps (the stall detector off)
    makers = {2: make_pressure_solve, 3: make_pressure_solve_3d}
    for dims, dtype, eps in (((1024, 1024), torch.float64, 1e-6),
                             ((64, 96, 128), torch.float32, 1e-2)):
        rhs = sine_rhs(torch, dims, dtype)
        sp = tuple(1.0 / n for n in reversed(dims))
        solve = makers[len(dims)](*reversed(dims), *sp, 1.0, eps, 50, dtype,
                                  solver="mg", stall_rtol=0, mg_fused="on",
                                  device="cuda")
        repeat_solve(torch, f"mg {dtype} {'x'.join(map(str, dims))}", solve,
                     torch.zeros_like(rhs), rhs, eps, cap=50)


def sine_rhs(torch, dims, dtype):
    """rhs = sin(2π i dx) on the interior of a (J, I) or (K, J, I) grid, 0
    on the ghosts: a consistent Neumann rhs (zero mean)."""
    i = torch.arange(dims[-1] + 2, dtype=torch.float64, device="cuda")
    rhs = torch.zeros(tuple(n + 2 for n in dims), dtype=torch.float64,
                      device="cuda")
    inner = (slice(1, -1),) * len(dims)
    rhs[inner] = torch.sin(2.0 * torch.pi * i[1:-1] / dims[-1])
    return rhs.to(dtype)


@phase("kernels vs plain versions and their times at 4096² float32")
def time_kernels(torch, np):
    from pampi_tpu_torch.ops import ns2d_fused as nf
    from pampi_tpu_torch.ops import sor_kernels as sk
    from pampi_tpu_torch.ops.sor_quarters import stack_quarters
    from pampi_tpu_torch.utils.params import Parameter

    J, I = MAIN
    dtype = torch.float32
    t = tol(torch, dtype)
    size = 4
    cells = (J + 2) * (I + 2)
    ring = 2 * (I + 2) + 2 * J  # the ghost cells of one field
    interior = J * I
    fac, idx2, idy2 = sk.sor_coefficients(1.0 / I, 1.0 / J, 1.8)
    p, rhs, u, v, pp = rng_fields(torch, np, (J + 2, I + 2), dtype, 5, 3)
    q, f = stack_quarters(p), stack_quarters(rhs)
    param = Parameter(name="dcavity", imax=I, jmax=J, re=1000.0)
    cfg = nf.StepConfig.from_param(param)
    dt = torch.tensor(1e-4, dtype=dtype, device="cuda")
    n_inner = 4
    rows, bad = {}, []

    def verdict(name, ok, detail):
        log(f"{name} 4096² f32 vs plain: {detail} {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(name)

    # SOR: p and rhs read once, p written once; ~12 flops per update
    sor_bound = bound(3 * cells * size, 12 * n_inner * interior)
    qout = torch.empty_like(q)

    def k1(x, r, n, *c):  # as the solve loop calls it: out of place
        return sk.rb_sor_quarters(x, r, n, *c, out=qout)

    for name, kern, plain, x, r in (
            ("rb_sor_quarters", k1, sk.rb_sor_quarters_plain, q, f),
            ("rb_sor_checkerboard", sk.rb_sor_checkerboard,
             sk.rb_sor_checkerboard_plain, p, rhs)):
        xk, xp = x.clone(), x.clone()
        rk = kern(xk, r, n_inner, fac, idx2, idy2)
        rp = plain(xp, r, n_inner, fac, idx2, idy2)
        if name == "rb_sor_quarters":
            xk = qout  # the new planes
        err = float((xk - xp).abs().max())
        e, er = rel_err(xk, xp), abs(float(rk) - float(rp)) / abs(float(rp))
        if name == "rb_sor_quarters":
            verdict(name, torch.equal(xk, xp) and torch.equal(rk, rp),
                    f"planes bitwise {torch.equal(xk, xp)}, residual bitwise "
                    f"{torch.equal(rk, rp)}")
        else:
            verdict(name, e <= t and er <= t,
                    f"field max_rel_err {e:.3e}, residual rel_err {er:.3e} "
                    f"(tol {t:g})")
        src = x if name == "rb_sor_quarters" else xk
        ms = cuda_ms(torch, lambda: kern(src, r, n_inner, fac, idx2, idy2),
                     20)
        pms = cuda_ms(torch, lambda: plain(xp, r, n_inner, fac, idx2, idy2), 5)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                          bound_ms=sor_bound[0], bound_by=sor_bound[1],
                          cuda_launches_per_call=cuda_launches(
                              torch, lambda: kern(src, r, n_inner, fac, idx2,
                                                  idy2)))
    # PRE, in place: reads u and v; writes F, G, rhs and the ghost ring of u
    # and v (the TPU kernel writes whole new u and v arrays); ~80 flops/cell
    uk, vk = u.clone(), v.clone()
    fk, gk, rk = nf.ns2d_pre(uk, vk, dt, cfg)
    plain_out = nf.ns2d_pre_plain(u, v, dt, cfg)
    err = max(float((a - b).abs().max())
              for a, b in zip((uk, vk, fk, gk, rk), plain_out))
    copies = torch.equal(uk, plain_out[0]) and torch.equal(vk, plain_out[1])
    e = max(rel_err(a, b) for a, b in zip((fk, gk, rk), plain_out[2:]))
    verdict("ns2d_pre", copies and e <= t,
            f"u', v' bitwise {copies}, F/G/rhs max_rel_err {e:.3e} (tol {t:g})")
    u1, v1 = plain_out[0], plain_out[1]
    u2, v2 = uk.clone(), vk.clone()  # POST's inputs, before PRE is re-timed
    ms = cuda_ms(torch, lambda: nf.ns2d_pre(uk, vk, dt, cfg), 20)
    pms = cuda_ms(torch, lambda: nf.ns2d_pre_plain(u, v, dt, cfg), 5)
    b = bound((5 * cells + 2 * ring) * size, 80 * interior)
    rows["ns2d_pre"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                            bound_ms=b[0], bound_by=b[1])
    # POST, in place: reads F, G, p and the ghost ring of u and v (for the
    # maxima); writes the interior of u and v (the TPU kernel reads and
    # writes whole u and v arrays); ~10 flops per cell
    umax, vmax = nf.ns2d_post(u2, v2, fk, gk, pp, dt, cfg.dx, cfg.dy)
    up, vp, ump, vmp = nf.ns2d_post_plain(u1, v1, fk, gk, pp, dt, cfg.dx,
                                          cfg.dy)
    err = max(float((u2 - up).abs().max()), float((v2 - vp).abs().max()))
    e = max(rel_err(u2, up), rel_err(v2, vp))
    own = (torch.equal(umax, u2.abs().max())
           and torch.equal(vmax, v2.abs().max()))
    em = max(abs(float(umax - ump)), abs(float(vmax - vmp)))
    verdict("ns2d_post", e <= t and own and em <= t * max(1.0, float(ump)),
            f"u'', v'' max_rel_err {e:.3e}, maxima bitwise vs own fields "
            f"{own}, vs plain {em:.3e} (tol {t:g})")
    ms = cuda_ms(torch, lambda: nf.ns2d_post(u2, v2, fk, gk, pp, dt, cfg.dx,
                                             cfg.dy), 20)
    pms = cuda_ms(torch, lambda: nf.ns2d_post_plain(u1, v1, fk, gk, pp, dt,
                                                    cfg.dx, cfg.dy), 5)
    b = bound((5 * cells + 2 * ring) * size, 10 * interior)
    rows["ns2d_post"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                             bound_ms=b[0], bound_by=b[1])
    for name, r in rows.items():
        log(f"{name} 4096² f32: {r['ms']:.4f} ms/call (plain {r['plain_ms']:.4f},"
            f" bound {r['bound_ms']:.4f} by {r['bound_by']}), "
            f"max_abs_err vs plain {r['max_abs_err']:.3e}")
    if bad:
        raise AssertionError(f"kernels disagree with plain versions at "
                             f"4096²: {bad}")
    return rows


@phase("3-D kernels vs plain versions and their times at 128³ and 256³ "
       "float32")
def time_kernels_3d(torch, np):
    from pampi_tpu_torch.ops import ns3d_fused as nf3
    from pampi_tpu_torch.ops import sor3d_kernels as sk3
    from pampi_tpu_torch.ops.sor3d import sor_coefficients_3d
    from pampi_tpu_torch.ops.sor_octants import stack_octants
    from pampi_tpu_torch.utils.params import Parameter

    from pampi_tpu_torch.utils import dispatch

    dtype = torch.float32
    t = tol(torch, dtype)
    size = 4
    n_inner = 4
    rows, bad = {}, []
    for K, J, I in (MAIN3, BIG3):
        shape = (K + 2, J + 2, I + 2)
        cells = shape[0] * shape[1] * shape[2]
        interior = K * J * I
        ghosts = cells - interior  # the ghost cells of one field
        tag = f"{K}³"
        coef = sor_coefficients_3d(1.0 / I, 1.0 / J, 1.0 / K, 1.8)
        p, rhs = rng_fields(torch, np, shape, dtype, 2, 3)
        res = {}
        # SOR: p and rhs read once, p written once; ~13 flops per update
        sor_bound = bound(3 * cells * size, 13 * n_inner * interior)
        for name, kern, plain, x, f in (
                ("rb_sor3d_octants", sk3.rb_sor3d_octants,
                 sk3.rb_sor3d_octants_plain, stack_octants(p),
                 stack_octants(rhs)),
                ("rb_sor3d_checkerboard", sk3.rb_sor3d_checkerboard,
                 sk3.rb_sor3d_checkerboard_plain, p, rhs)):
            e, er, err, ok = check_sor3d(kern, plain, x, f, n_inner, coef,
                                         t)
            if name == "rb_sor3d_octants":
                # K6's design at this shape (octant_tiles): its own row
                if sk3.octant_tiles(*x.shape[1:], size) is not None:
                    name = "rb_sor3d_octants_onchip"
                log(f"{name} {tag} f32: {dispatch.last('sor3d_octants')}")
            log(f"{name} {tag} f32 vs plain: field max_rel_err {e:.3e}, "
                f"residual rel_err {er:.3e} (tol {t:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"{name} {tag}")
            xk = x.clone()
            ms = cuda_ms(torch, lambda: kern(xk, f, n_inner, *coef), 20)
            pms = cuda_ms(torch, lambda: plain(xk, f, n_inner, *coef), 3)
            res[name] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                             bound_ms=sor_bound[0], bound_by=sor_bound[1])
        param = Parameter(name="dcavity3d", imax=I, jmax=J, kmax=K,
                          re=1000.0)
        cfg = nf3.StepConfig3D.from_param(param)
        u, v, w, pp = rng_fields(torch, np, shape, dtype, 4, 5)
        dt = torch.tensor(1e-3, dtype=dtype, device="cuda")
        copies, e_pre, e_post, own, em, err_pre, err_post, ok = check_step3d(
            torch, u, v, w, pp, dt, cfg, t)
        log(f"ns3d_pre/post {tag} f32 vs plain: u', v', w' bitwise {copies},"
            f" F/G/H/rhs max_rel_err {e_pre:.3e}, u'', v'', w'' max_rel_err "
            f"{e_post:.3e}, maxima bitwise vs own fields {own}, vs plain "
            f"{em:.3e} (tol {t:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"ns3d_pre/post {tag}")
        uk, vk, wk = u.clone(), v.clone(), w.clone()
        fk, gk, hk, _r = nf3.ns3d_pre(uk, vk, wk, dt, cfg)
        # PRE, in place: reads u, v, w; writes F, G, H, rhs and the ghost
        # cells of u, v, w; ~190 flops per interior cell
        b = bound((7 * cells + 3 * ghosts) * size, 190 * interior)
        ms = cuda_ms(torch, lambda: nf3.ns3d_pre(uk, vk, wk, dt, cfg), 20)
        pms = cuda_ms(torch, lambda: nf3.ns3d_pre_plain(u, v, w, dt, cfg), 3)
        res["ns3d_pre"] = dict(max_abs_err=err_pre, ms=ms, plain_ms=pms,
                               bound_ms=b[0], bound_by=b[1])
        # POST, in place: reads F, G, H, p and the ghost cells of u, v, w
        # (for the maxima); writes the interior of u, v, w; ~15 flops/cell
        b = bound((7 * cells + 3 * ghosts) * size, 15 * interior)
        ms = cuda_ms(torch, lambda: nf3.ns3d_post(
            uk, vk, wk, fk, gk, hk, pp, dt, cfg.dx, cfg.dy, cfg.dz), 20)
        pms = cuda_ms(torch, lambda: nf3.ns3d_post_plain(
            uk, vk, wk, fk, gk, hk, pp, dt, cfg.dx, cfg.dy, cfg.dz), 3)
        res["ns3d_post"] = dict(max_abs_err=err_post, ms=ms, plain_ms=pms,
                                bound_ms=b[0], bound_by=b[1])
        for name, r in res.items():
            log(f"{name} {tag} f32: {r['ms']:.4f} ms/call (plain "
                f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by "
                f"{r['bound_by']}), max_abs_err vs plain "
                f"{r['max_abs_err']:.3e}")
        rows[(K, J, I)] = res
        del p, rhs, u, v, w, pp, uk, vk, wk, fk, gk, hk
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"3-D kernels disagree with plain versions: "
                             f"{bad}")
    # the kernels line carries 256³, where the fields outgrow the L2 and the
    # bound is a floor, and the main path's 128³ under main_shape_* keys;
    # K6 runs on chip at 128³ (its row there) and multi-launch at 256³
    onchip = rows[MAIN3].pop("rb_sor3d_octants_onchip")
    out = {name: dict(r, shape="x".join(map(str, BIG3)),
                      main_shape="x".join(map(str, MAIN3)),
                      **{f"main_shape_{k}": rows[MAIN3][name][k]
                         for k in ("ms", "plain_ms", "bound_ms",
                                   "max_abs_err")})
           for name, r in rows[BIG3].items()
           if name != "rb_sor3d_octants"}
    out["rb_sor3d_octants"] = dict(
        rows[BIG3]["rb_sor3d_octants"], shape="x".join(map(str, BIG3)),
        main_shape="none: the main path's fields run on chip")
    out["rb_sor3d_octants_onchip"] = dict(
        onchip, shape="x".join(map(str, MAIN3)))
    return out


MG2 = ((512, 512), (1024, 1024))      # 2 and 3 levels
MG3 = ((64, 64, 64), (64, 96, 128))   # 2 and 3 levels


def mg_plan(extents):
    """The fused cycle's plan for a (J, I) or (K, J, I) grid of unit
    length, as the solvers build it (ops/multigrid._make_vcycle)."""
    from pampi_tpu_torch.ops import mg_fused as mf
    from pampi_tpu_torch.ops import multigrid as mg

    levels = mg._truncate_levels(mg.mg_levels(*extents),
                                 mg._DCT_BOTTOM_MAX_CELLS)
    return mf.make_cycle_plan(levels,
                              tuple(1.0 / n for n in reversed(extents)))


def check_mg_cycle(torch, np, plan, dtype, seed):
    """DOWN then UP, kernel and plain version on the same inputs. Returns
    (max_abs_err over every output, max_rel_err, bitwise, the kernel's
    pstk, rstk, the bottom plane)."""
    from pampi_tpu_torch.ops import mg_fused as mf

    L = len(plan.levels)
    p, rhs = rng_fields(torch, np, plan.shape(0), dtype, 2, seed)
    (pbot,) = rng_fields(torch, np, plan.shape(L - 1), dtype, 1, seed + 1)
    pstk, rstk = mf.mg_down(plan, p, rhs)
    pk, rk = mf.mg_down_plain(plan, p, rhs)
    pairs = list(zip(pstk + rstk, pk + rk))
    pairs.append((mf.mg_up(plan, pstk, rstk, pbot),
                  mf.mg_up_plain(plan, pk, rk, pbot)))
    err = max(float((a - b).abs().max()) for a, b in pairs)
    rel = max(rel_err(a, b) for a, b in pairs)
    bitwise = all(torch.equal(a, b) for a, b in pairs)
    return err, rel, bitwise, pstk, rstk, pbot


def mg_obstacle_plan(fluid, spacings, dtype):
    """The masked plan of the obstacle MG solve over the bool flags
    `fluid` (ghosts fluid), as make_obstacle_mg_solve_2d/3d builds it, on
    the card. spacings = (dx, dy[, dz])."""
    from pampi_tpu_torch.ops import mg_fused as mf
    from pampi_tpu_torch.ops import multigrid as mg

    extents = tuple(n - 2 for n in fluid.shape)
    levels = mg._truncate_levels(mg.mg_levels(*extents),
                                 mg._DENSE_BOTTOM_MAX_CELLS)
    lvs = mg.obstacle_levels(fluid, levels, spacings, dtype, "cuda")
    return mf.make_cycle_plan(levels, spacings,
                              fluid_levels=[lv.flags for lv in lvs],
                              factor_levels=[lv.fac_ext for lv in lvs])


def obstacle2d_geometry(jmax, imax):
    """(bool flags, (dx, dy)) of configs/canal_obstacle.par on a jmax x
    imax grid."""
    from pampi_tpu_torch.ops import obstacle as obst

    param = obstacle2d_config(jmax, imax)
    dx, dy = param.xlength / imax, param.ylength / jmax
    return obst.build_fluid(imax, jmax, dx, dy, param.obstacles), (dx, dy)


def obstacle3d_geometry(**grid):
    """(bool flags, (dx, dy, dz)) of configs/canal3d_obstacle.par on the
    given grid (as shipped without one)."""
    param = obstacle_config(**grid)
    return obstacle_fluid(param), (param.xlength / param.imax,
                                   param.ylength / param.jmax,
                                   param.zlength / param.kmax)


def mg_obstacle_checks(np):
    """(tag, flags, spacings) of the masked cycle's checks:
    canal_obstacle.par's box at 1024x256, an odd box on the south and east
    walls at 512² (coarsening keeps it on every level's edge),
    canal3d_obstacle.par as shipped (128x32x32), an odd box on three walls
    at 64³."""
    odd2 = np.ones((514, 514), bool)
    odd2[1:38, 301:513] = False
    odd3 = np.ones((66, 66, 66), bool)
    odd3[1:20, 33:65, 7:30] = False
    return (("canal_obstacle 1024x256", *obstacle2d_geometry(256, 1024)),
            ("odd box on two walls 512x512", odd2, (1 / 512, 1 / 512)),
            ("canal3d_obstacle 128x32x32", *obstacle3d_geometry()),
            ("odd box on three walls 64x64x64", odd3, (1 / 64,) * 3))


@phase("MG cycle kernels K9-K12 vs plain versions, plain and masked")
def check_mg_kernels(torch, np):
    bad = []
    for dtype in (torch.float32, torch.float64):
        for dims in MG2 + MG3:
            plan = mg_plan(dims)
            err, rel, bitwise, *_ = check_mg_cycle(torch, np, plan, dtype, 31)
            tag = "x".join(map(str, dims))
            log(f"mg_down/mg_up {len(dims)}-D {dtype} {tag} (L={len(plan.levels)})"
                f": bitwise {bitwise}, max_abs_err {err:.3e}, max_rel_err "
                f"{rel:.3e} {'ok' if bitwise else 'FAIL'}")
            if not bitwise:
                bad.append(f"{tag} {dtype}")
        for tag, fluid, spacings in mg_obstacle_checks(np):
            plan = mg_obstacle_plan(fluid, spacings, dtype)
            err, rel, bitwise, *_ = check_mg_cycle(torch, np, plan, dtype, 37)
            log(f"mg_down/mg_up masked {plan.nd}-D {dtype} {tag} (L="
                f"{len(plan.levels)}, {int((~fluid).sum())} obstacle cells): "
                f"bitwise {bitwise}, max_abs_err {err:.3e}, max_rel_err "
                f"{rel:.3e} {'ok' if bitwise else 'FAIL'}")
            if not bitwise:
                bad.append(f"masked {tag} {dtype}")
    if bad:
        raise AssertionError(f"MG cycle kernels differ from plain: {bad}")


def mg_bytes(plan, size):
    """Least bytes of one DOWN and one UP: DOWN reads the fine p and rhs
    and writes every stored level and every restricted rhs; UP reads the
    stored levels, their rhs and the bottom, and writes the fine p. The
    masked mode also reads the flags (1 byte) and the factor of every
    level it relaxes, once each half."""
    import math

    cells = [math.prod(plan.shape(lvl)) for lvl in range(len(plan.levels))]
    down = (2 * cells[0] + sum(cells) + sum(cells[1:])) * size
    up = (2 * sum(cells[:-1]) + cells[-1] + cells[0]) * size
    if plan.masked:
        down += sum(cells[:-1]) * (1 + size)
        up += sum(cells[:-1]) * (1 + size)
    return down, up


def mg_flops(plan):
    """Operations of one DOWN and one UP: per cell update ~12 (masked:
    8 per axis, the sums, the flag product and the update: 21 in 2-D, 30
    in 3-D; n sweeps on each level but the last), per fine cell in the
    restriction ~13 (masked 20 / 29: its residual and its share of the
    sum), per fine cell in the prolongation 1 (masked 2: the flag
    product)."""
    import math

    nd = plan.nd
    upd, restrict = (8 * nd + nd + 3, 8 * nd + nd + 2) if plan.masked \
        else (12, 13)
    inner = [math.prod(e) for e in plan.levels[:-1]]
    down = sum((upd * plan.n_pre + restrict) * n for n in inner)
    up = sum((upd * plan.n_post + 1 + plan.masked) * n for n in inner)
    return down, up


@phase("MG cycle kernels vs plain versions and their times at 4096², 128³ "
       "and 256³ float32, the masked mode at 8192x2048 and 512x128x128")
def time_mg_kernels(torch, np):
    from pampi_tpu_torch.ops import dctpoisson as dct
    from pampi_tpu_torch.ops import mg_fused as mf

    dtype = torch.float32
    rows, library, bad = {}, {}, []
    for dims in (MAIN, MAIN3, BIG3):
        plan = mg_plan(dims)
        nd, L = len(dims), len(plan.levels)
        tag = "x".join(map(str, dims))
        err, rel, bitwise, pstk, rstk, pbot = check_mg_cycle(
            torch, np, plan, dtype, 41)
        log(f"mg_down/mg_up {tag} f32 (L={L}) vs plain: bitwise {bitwise}, "
            f"max_abs_err {err:.3e} {'ok' if bitwise else 'FAIL'}")
        if not bitwise:
            bad.append(tag)
        p, rhs = rng_fields(torch, np, plan.shape(0), dtype, 2, 43)
        bd, bu = mg_bytes(plan, 4)
        fd, fu = mg_flops(plan)
        for kind, nbytes, flops, kern, plain in (
                ("down", bd, fd, lambda: mf.mg_down(plan, p, rhs),
                 lambda: mf.mg_down_plain(plan, p, rhs)),
                ("up", bu, fu, lambda: mf.mg_up(plan, pstk, rstk, pbot),
                 lambda: mf.mg_up_plain(plan, pstk, rstk, pbot))):
            b = bound(nbytes, flops)
            rows.setdefault(f"mg_{kind}_{nd}d", {})[dims] = dict(
                max_abs_err=err, ms=cuda_ms(torch, kern, 20),
                plain_ms=cuda_ms(torch, plain, 3), bound_ms=b[0],
                bound_by=b[1], levels=L)
        # the exact bottom between DOWN and UP, and (2-D) the whole fft
        # solve: one library matrix-product chain each
        bottom = dct.make_poisson_dct(
            plan.levels[-1], tuple(1.0 / n for n in plan.levels[-1]), dtype,
            "cuda")
        r = rstk[-1][(slice(1, -1),) * nd].contiguous()
        library[f"dct_bottom_{'x'.join(map(str, plan.levels[-1]))}_of_{tag}"] \
            = cuda_ms(torch, lambda: bottom(r), 20)
        if nd == 2:
            solve = dct.make_dct_solve_2d(dims[1], dims[0], 1.0 / dims[1],
                                          1.0 / dims[0], dtype,
                                          device="cuda")
            library[f"fft_solve_{tag}"] = cuda_ms(
                torch, lambda: solve(p, rhs), 5)
        del p, rhs, pstk, rstk, pbot
        torch.cuda.empty_cache()
    # the masked mode at the obstacle main paths' grids and geometries
    for dims, (fluid, spacings) in (
            (OBST2_MAIN, obstacle2d_geometry(*OBST2_MAIN)),
            (tuple(OBST_MAIN[k] for k in ("kmax", "jmax", "imax")),
             obstacle3d_geometry(**OBST_MAIN))):
        plan = mg_obstacle_plan(fluid, spacings, dtype)
        nd, L = plan.nd, len(plan.levels)
        tag = "x".join(map(str, reversed(dims)))
        err, rel, bitwise, pstk, rstk, pbot = check_mg_cycle(
            torch, np, plan, dtype, 47)
        log(f"mg_down/mg_up masked {tag} f32 (L={L}) vs plain: bitwise "
            f"{bitwise}, max_abs_err {err:.3e} {'ok' if bitwise else 'FAIL'}")
        if not bitwise:
            bad.append(f"masked {tag}")
        p, rhs = rng_fields(torch, np, plan.shape(0), dtype, 2, 49)
        bd, bu = mg_bytes(plan, 4)
        fd, fu = mg_flops(plan)
        for kind, nbytes, flops, kern, plain in (
                ("down", bd, fd, lambda: mf.mg_down(plan, p, rhs),
                 lambda: mf.mg_down_plain(plan, p, rhs)),
                ("up", bu, fu, lambda: mf.mg_up(plan, pstk, rstk, pbot),
                 lambda: mf.mg_up_plain(plan, pstk, rstk, pbot))):
            b = bound(nbytes, flops)
            rows[f"mg_{kind}_{nd}d_masked"] = {dims: dict(
                max_abs_err=err, ms=cuda_ms(torch, kern, 20),
                plain_ms=cuda_ms(torch, plain, 3), bound_ms=b[0],
                bound_by=b[1], levels=L)}
        del p, rhs, pstk, rstk, pbot, plan
        torch.cuda.empty_cache()
    for name, by in rows.items():
        for dims, r in by.items():
            log(f"{name} {'x'.join(map(str, dims))} f32 (L={r['levels']}): "
                f"{r['ms']:.4f} ms/call (plain {r['plain_ms']:.4f}, bound "
                f"{r['bound_ms']:.4f} by {r['bound_by']}), max_abs_err vs "
                f"plain {r['max_abs_err']:.3e}")
    log(f"library (one chain of torch matrix products, f32, ms): "
        f"{json.dumps(library)}")
    if bad:
        raise AssertionError(f"MG cycle kernels differ from plain at the "
                             f"main shapes: {bad}")

    def line(r, dims):
        return dict({k: v for k, v in r.items() if k != "levels"},
                    shape="x".join(map(str, dims)))

    out = {f"mg_{k}_2d": line(rows[f"mg_{k}_2d"][MAIN], MAIN)
           for k in ("down", "up")}
    for name, by in rows.items():
        if name.endswith("_masked"):
            ((dims, r),) = by.items()
            out[name] = line(r, tuple(reversed(dims)))
    for k in ("down", "up"):
        by = rows[f"mg_{k}_3d"]
        out[f"mg_{k}_3d"] = dict(
            line(by[BIG3], BIG3), main_shape="x".join(map(str, MAIN3)),
            **{f"main_shape_{q}": by[MAIN3][q]
               for q in ("ms", "plain_ms", "bound_ms", "max_abs_err")})
    return out, library


def drive_path(kb, name, kernels, run):
    """Set every launch count to 0, run one main path, read the counts;
    fail if a kernel of that path was not launched."""
    kb.reset_launches()
    out = run()
    counts = {k: v.launches for k, v in kb.KERNELS.items()}
    log(f"{name} launches: {json.dumps(counts)}")
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels not launched: {missing}")
    return counts, out


PHASES = ("pre", "solve", "post", "end")  # the NS solvers' phase marks
CYCLE = ("down", "bottom", "up", "check")  # cycle_marks' spans


def event_marks(torch):
    """(marks, mark): mark(name) records a CUDA event and appends it to
    marks under name."""
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    return marks, mark


def span_ms(marks, names, per):
    """ms per `per` of each span in names: a mark opens the span of its
    name and the next mark closes it (the events have completed)."""
    out = dict.fromkeys(names, 0.0)
    for (name, a), (_, b) in zip(marks, marks[1:]):
        if name in out:
            out[name] += a.elapsed_time(b) / per
    return out


@contextlib.contextmanager
def cycle_marks(mark):
    """Wrap the fused cycle's DOWN and UP wrappers so that mark() opens
    "down" before DOWN, "bottom" after it, "up" before UP and "check"
    after it (the residual check and the loop, up to the next mark). The
    solvers look the wrappers up at call time, so this times the path's
    own calls and adds no launch."""
    from pampi_tpu_torch.ops import mg_fused as mf

    down, up = mf.mg_down, mf.mg_up

    def timed(fn, before, after):
        def run(*a):
            mark(before)
            r = fn(*a)
            mark(after)
            return r
        return run

    mf.mg_down, mf.mg_up = timed(down, "down", "bottom"), timed(up, "up",
                                                                 "check")
    try:
        yield
    finally:
        mf.mg_down, mf.mg_up = down, up


def timed_steps(torch, s, n, cycles=0):
    """n steps of an NS solver after one warm-up step: ms/step on the host
    clock and the PRE / solve / POST split from CUDA events placed by the
    solver's phase hook. With `cycles` (fused V-cycles a step) the same
    steps also give the cycle's DOWN / bottom / UP / check split, in ms
    per cycle."""
    s.run_steps(1)  # warm-up: loads the kernels
    marks, mark = event_marks(torch)
    s.phase_hook = mark
    torch.cuda.synchronize()
    with cycle_marks(mark) if cycles else contextlib.nullcontext():
        t0 = time.perf_counter()
        s.run_steps(n)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    s.phase_hook = None
    phases = [m for m in marks if m[0] in PHASES]
    split = span_ms(phases, ("pre", "solve", "post"), n)
    if cycles:
        split["cycle"] = span_ms(marks, CYCLE, n * cycles)
    return dict(ms_per_step=wall, **split)


@phase("main path: Poisson 4096² and NS-2D dcavity 4096²")
def main_path(torch, out):
    from pampi_tpu_torch.kernels import build as kb
    from pampi_tpu_torch.models.ns2d import NS2DSolver
    from pampi_tpu_torch.models.poisson import PoissonSolver
    from pampi_tpu_torch.utils.params import Parameter

    J, I = MAIN

    def poisson():
        for layout in ("auto", "checkerboard"):
            param = Parameter(name="poisson", imax=I, jmax=J, itermax=400,
                              eps=0.0, omg=1.9, tpu_dtype="float32",
                              tpu_sor_inner=4, tpu_sor_layout=layout)
            s = PoissonSolver(param, device="cuda")
            s.solve()  # warm-up: loads the kernels
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            it, res = s.solve()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            if (it != 400 or not res == res
                    or not bool(torch.isfinite(s.p).all())):
                raise AssertionError(f"Poisson {layout}: it={it} res={res}")
            log(f"Poisson 4096² f32 layout {layout}: {it} iterations, "
                f"{sec / it * 1e3:.4f} ms/iteration, "
                f"{J * I * it / sec:.4e} site-updates/s, residual {res:.4e}")
            out[f"poisson_{layout}_ms_per_iter"] = sec / it * 1e3

    def ns2d():
        for flat in (0, 1):
            # eps 0: every solve runs its itermax (a 4096² cavity never
            # converges within 100 iterations), so flat and checked solves
            # do the same work and differ only by the checks' host syncs
            param = Parameter(name="dcavity", imax=I, jmax=J, re=1000.0,
                              itermax=100, eps=0.0, te=1e9,
                              tpu_dtype="float32", tpu_sor_inner=4,
                              tpu_flat_solve=flat)
            s = NS2DSolver(param, device="cuda")
            r = timed_steps(torch, s, 16)
            finite = all(bool(torch.isfinite(x).all())
                         for x in (s.u, s.v, s.p))
            if not finite or s.nt != 17:
                raise AssertionError(f"NS-2D: finite={finite} nt={s.nt}")
            log(f"NS-2D dcavity 4096² f32 (flat solve {flat}): "
                f"{r['ms_per_step']:.3f} ms/step (host clock); PRE "
                f"{r['pre']:.3f} / solve {r['solve']:.3f} / POST "
                f"{r['post']:.3f} ms (CUDA events), t={s.t:.6e}")
            out[f"ns2d_flat{flat}"] = r

    counts = [drive_path(kb, "Poisson", ("rb_sor_quarters",
                                         "rb_sor_checkerboard"), poisson)[0],
              drive_path(kb, "NS-2D", ("rb_sor_quarters", "ns2d_pre",
                                       "ns2d_post"), ns2d)[0]]
    synced = out["ns2d_flat0"]["solve"]
    flat_solve = out["ns2d_flat1"]["solve"]
    log(f"host-sync share of the NS solve loop: "
        f"{(synced - flat_solve) / synced:.3f} ({synced:.3f} vs flat "
        f"{flat_solve:.3f} ms/step)")
    return counts


@phase("main path: NS-3D configs/dcavity3d.par 128³ and configs/canal3d.par")
def main_path_3d(torch):
    from pampi_tpu_torch.kernels import build as kb
    from pampi_tpu_torch.models.ns3d import NS3DSolver
    from pampi_tpu_torch.ops import sor3d_kernels as sk3
    from pampi_tpu_torch.ops.sor3d import sor_coefficients_3d
    from pampi_tpu_torch.ops.sor_octants import stack_octants, unstack_octants
    from pampi_tpu_torch.utils.params import read_parameter

    def config(name, **kw):
        return read_parameter(os.path.join(ROOT, "configs", name)).replace(
            **kw)

    counts = []
    for layout, kern in (("auto", "rb_sor3d_octants_onchip"),
                         ("checkerboard", "rb_sor3d_checkerboard")):
        # eps 0: every solve runs its itermax (25 calls at tpu_sor_inner 4)
        param = config("dcavity3d.par", itermax=100, eps=0.0, te=1e9,
                       tpu_sor_inner=4, tpu_sor_layout=layout)
        s = NS3DSolver(param, device="cuda")
        c, r = drive_path(kb, f"NS-3D dcavity3d {layout}",
                          (kern, "ns3d_pre", "ns3d_post"),
                          lambda: timed_steps(torch, s, 16))
        counts.append(c)
        if c.get("rb_sor3d_octants", 0):
            raise AssertionError("dcavity3d.par 128³ ran K6 multi-launch")
        finite = all(bool(torch.isfinite(x).all())
                     for x in (s.u, s.v, s.w, s.p))
        if not finite or s.nt != 17 or s.dtype != torch.float32:
            raise AssertionError(f"NS-3D {layout}: finite={finite} "
                                 f"nt={s.nt} dtype={s.dtype}")
        # the host syncs of the solve loop: the same 25 calls (and layout
        # conversions) back to back, with no residual read in between
        g = s.grid
        coef = sor_coefficients_3d(g.dx, g.dy, g.dz, param.omg)
        rhs = torch.zeros_like(s.p)  # a call's work does not depend on it
        if kern == "rb_sor3d_octants_onchip":
            def flat():
                q, f = stack_octants(s.p), stack_octants(rhs)
                for _ in range(25):
                    sk3.rb_sor3d_octants(q, f, 4, *coef)
                s.p.copy_(unstack_octants(q))
        else:
            def flat():
                for _ in range(25):
                    sk3.rb_sor3d_checkerboard(s.p, rhs, 4, *coef)
        flat_ms = cuda_ms(torch, flat, 5)
        log(f"NS-3D dcavity3d 128³ f32 layout {layout}: "
            f"{r['ms_per_step']:.3f} ms/step (host clock); PRE "
            f"{r['pre']:.3f} / solve {r['solve']:.3f} / POST {r['post']:.3f}"
            f" ms (CUDA events), t={s.t:.6e}; the same 25 solve calls back "
            f"to back {flat_ms:.3f} ms, host-sync share of the solve "
            f"{(r['solve'] - flat_ms) / r['solve']:.3f}")

    param = config("canal3d.par", te=1e9)
    s = NS3DSolver(param, device="cuda")

    def canal():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run_steps(8)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 8 * 1e3

    c, ms = drive_path(kb, "NS-3D canal3d", ("rb_sor3d_octants_onchip",
                                              "ns3d_pre", "ns3d_post"), canal)
    counts.append(c)
    if c.get("rb_sor3d_octants", 0):
        raise AssertionError("canal3d.par ran K6 multi-launch")
    finite = all(bool(torch.isfinite(x).all()) for x in (s.u, s.v, s.w, s.p))
    if not finite or s.nt != 8 or s.dtype != torch.float64:
        raise AssertionError(f"canal3d: finite={finite} nt={s.nt}")
    log(f"NS-3D canal3d 200x50x50 f64 (itermax 500, eps 1e-4): "
        f"{ms:.3f} ms/step over 8 steps (host clock, first step included),"
        f" t={s.t:.6e}")
    return counts


def cycle_split(torch, solve, cycles):
    """Run solve() once and return ms per cycle of DOWN, the bottom
    (DOWN's end to UP's start), UP, and the residual check with the loop
    (UP's end to the next DOWN, or to the solve's end), from CUDA
    events."""
    marks, mark = event_marks(torch)
    with cycle_marks(mark):
        solve()
    mark("end")
    torch.cuda.synchronize()
    return span_ms(marks, CYCLE, cycles)


@phase("main path: tpu_solver mg and fft (Poisson 4096², NS-2D 4096², "
       "NS-3D configs/dcavity3d_fast.par 128³)")
def main_path_mg(torch, sor_ns2d):
    from pampi_tpu_torch.kernels import build as kb
    from pampi_tpu_torch.models.ns2d import NS2DSolver
    from pampi_tpu_torch.models.ns3d import NS3DSolver
    from pampi_tpu_torch.models.poisson import PoissonSolver
    from pampi_tpu_torch.utils.params import Parameter, read_parameter

    J, I = MAIN
    fixed = dict(eps=0.0, tpu_mg_stall_rtol=0.0)  # every solve runs itermax
    out, counts = {}, []

    def poisson(fused, itermax):
        param = Parameter(name="poisson", imax=I, jmax=J, itermax=itermax,
                          tpu_dtype="float32", tpu_solver="mg",
                          tpu_mg_fused=fused, **fixed)
        s = PoissonSolver(param, device="cuda")
        s.solve()  # warm-up: loads the kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        it, res = s.solve()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / it * 1e3
        if it != itermax or not res == res or not bool(
                torch.isfinite(s.p).all()):
            raise AssertionError(f"Poisson mg {fused}: it={it} res={res}")
        return s, it, ms, res

    def poisson_fused():
        s, it, ms, res = poisson("auto", 8)
        split = cycle_split(torch, s.solve, it)
        log(f"Poisson 4096² f32 mg (fused, L=5): {it} V-cycles, {ms:.4f} "
            f"ms/cycle (host clock); DOWN {split['down']:.4f} / bottom "
            f"{split['bottom']:.4f} / UP {split['up']:.4f} / residual check "
            f"{split['check']:.4f} ms (CUDA events), residual {res:.4e}")
        out["poisson_mg"] = dict(ms_per_cycle=ms, **split)

    def poisson_ladder():
        _s, it, ms, res = poisson("off", 2)
        log(f"Poisson 4096² f32 mg ladder (tpu_mg_fused off): {it} V-cycles,"
            f" {ms:.4f} ms/cycle (host clock), residual {res:.4e}")
        out["poisson_mg_ladder"] = dict(ms_per_cycle=ms)

    def steps(label, s, cycles):
        mg = s.param.tpu_solver == "mg"
        r = timed_steps(torch, s, 16, cycles if mg else 0)
        fields = [s.u, s.v, s.p] + ([s.w] if hasattr(s, "w") else [])
        finite = all(bool(torch.isfinite(x).all()) for x in fields)
        if not finite or s.nt != 17 or s.last_it != cycles:
            raise AssertionError(f"{label}: finite={finite} nt={s.nt} "
                                 f"cycles={s.last_it}")
        log(f"{label}: {r['ms_per_step']:.3f} ms/step (host clock); PRE "
            f"{r['pre']:.3f} / solve {r['solve']:.3f} / POST {r['post']:.3f}"
            f" ms (CUDA events), {cycles} solve iterations a step, "
            f"t={s.t:.6e}")
        if mg:
            c = r["cycle"]
            log(f"{label} fused V-cycle (the same 16 steps): DOWN "
                f"{c['down']:.4f} / bottom {c['bottom']:.4f} / UP "
                f"{c['up']:.4f} / residual check {c['check']:.4f} ms per "
                f"cycle (CUDA events)")
        out[label] = r

    def ns2d(solver):
        kw = dict(itermax=4, **fixed) if solver == "mg" else {}
        param = Parameter(name="dcavity", imax=I, jmax=J, re=1000.0, te=1e9,
                          tpu_dtype="float32", tpu_solver=solver, **kw)
        return lambda: steps(f"NS-2D dcavity 4096² f32 {solver}",
                             NS2DSolver(param, device="cuda"),
                             4 if solver == "mg" else 1)

    def ns3d(solver):
        param = read_parameter(os.path.join(ROOT, "configs",
                                            "dcavity3d_fast.par"))
        kw = dict(itermax=4, **fixed) if solver == "mg" else {}
        param = param.replace(te=1e9, tpu_solver=solver, **kw)
        return lambda: steps(f"NS-3D dcavity3d_fast 128³ f32 {solver}",
                             NS3DSolver(param, device="cuda"),
                             4 if solver == "mg" else 1)

    for name, kernels, run in (
            ("Poisson mg", ("mg_down_2d", "mg_up_2d"), poisson_fused),
            ("Poisson mg ladder", ("rb_sor_checkerboard",), poisson_ladder),
            ("NS-2D mg", ("mg_down_2d", "mg_up_2d", "ns2d_pre", "ns2d_post"),
             ns2d("mg")),
            ("NS-2D fft", ("ns2d_pre", "ns2d_post"), ns2d("fft")),
            ("NS-3D fft", ("ns3d_pre", "ns3d_post"), ns3d("fft")),
            ("NS-3D mg", ("mg_down_3d", "mg_up_3d", "ns3d_pre", "ns3d_post"),
             ns3d("mg"))):
        counts.append(drive_path(kb, name, kernels, run)[0])
    if sor_ns2d is not None:
        log(f"NS-2D dcavity 4096² f32 ms/step: sor (itermax 100, this run) "
            f"{sor_ns2d['ms_per_step']:.3f}, mg (4 cycles) "
            f"{out['NS-2D dcavity 4096² f32 mg']['ms_per_step']:.3f}, fft "
            f"{out['NS-2D dcavity 4096² f32 fft']['ms_per_step']:.3f}")
    return counts


@phase("tpu_solver mg and fft: card vs CPU (dcavity 512², dcavity3d 64³, "
       "float64)")
def mg_fft_card_vs_cpu(torch):
    from pampi_tpu_torch.models.ns2d import NS2DSolver
    from pampi_tpu_torch.models.ns3d import NS3DSolver
    from pampi_tpu_torch.utils.params import read_parameter

    bad = []
    for par, cls, kw, n in (
            ("dcavity.par", NS2DSolver, dict(imax=512, jmax=512), 20),
            ("dcavity3d.par", NS3DSolver, dict(imax=64, jmax=64, kmax=64),
             10)):
        for solver in ("mg", "fft"):
            param = read_parameter(os.path.join(ROOT, "configs", par)).replace(
                te=1e9, tpu_dtype="float64", tpu_solver=solver, **kw)
            runs = {}
            for device in ("cuda", "cpu"):
                t0 = time.perf_counter()
                s = cls(param, device=device)
                its = []
                s.phase_hook = lambda ph, s=s, its=its: (
                    its.append(s.last_it) if ph == "end" else None)
                s.run_steps(n)
                runs[device] = (s, its, time.perf_counter() - t0)
            (a, ia, ta), (b, ib, tb) = runs["cuda"], runs["cpu"]
            names = ("u", "v", "w", "p") if cls is NS3DSolver else \
                ("u", "v", "p")
            diff = max(float((getattr(a, f).cpu() - getattr(b, f)).abs().max())
                       for f in names)
            ok = ia == ib and diff <= 1e-9 and a.nt == b.nt == n
            log(f"{par} {kw} f64 {solver}, {n} steps: card {ta:.1f} s, CPU "
                f"{tb:.1f} s; solve iterations per step card {ia} / CPU {ib};"
                f" max |card - cpu| {diff:.3e} (tol 1e-9), t {a.t:.9e} / "
                f"{b.t:.9e} {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"{par} {solver}")
    if bad:
        raise AssertionError(f"card and CPU disagree: {bad}")


# the CPU half of this check is the script's longest single run: at
# float64 it checks convergence every iteration (utils/dispatch.
# sor_cadence), and te 0.2 (1601 steps) took 358 s of it on the CPU and 45
# s on the card; te 0.05 (400 steps) took 143.7 s on the CPU, so it runs
# in a process of its own beside the card's last phases. te 0.03 since the
# ragged NS-3D phases joined those processes: at te 0.05 the 3x3 mesh run
# of dist2d_cli (host-bound, 361-618 s) took the script to 855-1013 s; te
# 0.02 since the overlapped schedule's phases: at te 0.03 the mesh runs
# took 393-468 s of a 690-880 s script
DCAVITY_TE = 0.02
# the card's fields at DCAVITY_TE (full precision, and as written to the
# .dat files), which the CPU half and the mesh runs of dist2d_cli are held
# against; the CPU half's process and directory
DCAVITY_CARD = {}
DCAVITY_CPU = {}


def dcavity_par(tmp, te):
    """configs/dcavity.par with te replaced, written into tmp."""
    import re

    text = open(os.path.join(ROOT, "configs", "dcavity.par")).read()
    path = os.path.join(tmp, "dcavity.par")
    with open(path, "w") as fh:
        fh.write(re.sub(r"^te .*$", f"te {te}", text, flags=re.M))
    return path


# every process the script starts, stopped on the way out
PROCS = []


def start(args, cwd, log_path, env=None):
    """Start a process of the script's own, its output to log_path."""
    with open(log_path, "w") as out:
        proc = subprocess.Popen(args, cwd=cwd, stdout=out,
                                stderr=subprocess.STDOUT, env=env)
    PROCS.append(proc)
    return proc


def stop_procs():
    """Stop every process the script started that still runs; remove the
    CPU half's files."""
    import shutil

    for proc in PROCS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for files in (DCAVITY_CPU, OBST_RUNS, OBST2_RUNS, RAGGED_RUNS,
                  DIST2D_RUNS, BF16_RUN):
        if "tmp" in files:
            shutil.rmtree(files.pop("tmp"), ignore_errors=True)


@phase(f"configs/dcavity.par te {DCAVITY_TE}: the card half, the CPU half "
       "started beside it")
def dcavity_card(np):
    from pampi_tpu_torch.models.ns2d import NS2DSolver
    from pampi_tpu_torch.utils.datio import read_pressure, read_velocity
    from pampi_tpu_torch.utils.params import read_parameter

    tmp = tempfile.mkdtemp(prefix="dcavity_cpu_")
    DCAVITY_CPU["tmp"] = tmp
    par = dcavity_par(tmp, DCAVITY_TE)
    env = dict(os.environ, OMP_NUM_THREADS="4",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    DCAVITY_CPU["proc"] = start(
        [sys.executable, "-m", "pampi_tpu_torch", "--device", "cpu", par],
        tmp, os.path.join(tmp, "cli.log"), env)
    t0 = time.perf_counter()
    s = NS2DSolver(read_parameter(par), device="cuda")
    s.run(progress=False)
    pp = os.path.join(tmp, "pressure_cuda.dat")
    vp = os.path.join(tmp, "velocity_cuda.dat")
    s.write_result(pp, vp)
    DCAVITY_CARD.update(nt=s.nt, t=s.t,
                        dat=(read_pressure(pp), *read_velocity(vp)),
                        **{k: getattr(s, k).cpu().numpy() for k in "uvp"})
    log(f"cuda: {s.nt} steps to t={s.t:.6f} in "
        f"{time.perf_counter() - t0:.1f} s")


@phase(f"configs/dcavity.par te {DCAVITY_TE}: card vs CPU")
def dcavity_card_vs_cpu(np):
    from pampi_tpu_torch.utils.datio import read_pressure, read_velocity

    if "dat" not in DCAVITY_CARD or "proc" not in DCAVITY_CPU:
        raise AssertionError("the card half did not run")
    tmp, proc = DCAVITY_CPU["tmp"], DCAVITY_CPU["proc"]
    waited = time.perf_counter()
    rc = proc.wait(timeout=600)
    waited = time.perf_counter() - waited
    out = open(os.path.join(tmp, "cli.log")).read()
    if rc != 0:
        log(out[-4000:])
        raise AssertionError(f"the CPU half exited {rc}")
    took = [ln for ln in out.splitlines() if ln.startswith("Solution took")]
    cpu = (read_pressure(os.path.join(tmp, "pressure.dat")),
           *read_velocity(os.path.join(tmp, "velocity.dat")))
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(DCAVITY_CARD["dat"], cpu))
    log(f"cpu: python -m pampi_tpu_torch --device cpu in its own process: "
        f"{took[-1] if took else 'no timing line'}; waited {waited:.1f} s "
        f"for it here")
    log(f"dcavity.par te {DCAVITY_TE} f64: max |card - cpu| over the .dat "
        f"fields {diff:.3e} (tol 1e-9)")
    if not diff <= 1e-9:
        raise AssertionError(f".dat fields differ by {diff}")


@phase("NS-3D on the card against the reference's VTK output")
def ns3d_vs_fixtures(np):
    from pampi_tpu_torch.models.ns3d import NS3DSolver
    from pampi_tpu_torch.utils.params import read_parameter
    from pampi_tpu_torch.utils.vtkio import read_vtk_ascii

    fixtures = os.path.join(ROOT, "tests", "fixtures")
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        for par, kw, fixture, steps in (
                ("dcavity3d.par", dict(imax=32, jmax=32, kmax=32, te=1.0),
                 "dcavity3d_32_te1.0.vtk", 112),
                ("canal3d.par", dict(imax=48, jmax=16, kmax=16, te=0.5),
                 "canal3d_48x16x16_te0.5.vtk", None)):
            param = read_parameter(os.path.join(ROOT, "configs", par)).replace(
                tpu_dtype="float64", tpu_sor_inner=1, **kw)
            t0 = time.perf_counter()
            s = NS3DSolver(param, device="cuda")
            s.run(progress=False)
            out = os.path.join(tmp, "out.vtk")
            s.write_result(out, fmt="ascii")
            so, vo = read_vtk_ascii(out)
            sg, vg = read_vtk_ascii(os.path.join(fixtures, fixture))
            dp = float(np.abs(so["pressure"] - sg["pressure"]).max())
            dv = max(float(np.abs(vo["velocity"][c] - vg["velocity"][c]).max())
                     for c in range(3))
            ok = dp <= 1e-6 and dv <= 1e-6 and steps in (None, s.nt)
            log(f"{par} {kw} f64 on the card: {s.nt} steps to t={s.t:.6f} in "
                f"{time.perf_counter() - t0:.1f} s; max |card - {fixture}| "
                f"pressure {dp:.3e}, velocity {dv:.3e} (tol 1e-6"
                f"{'' if steps is None else f', {steps} steps'}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(par)
    if bad:
        raise AssertionError(f"NS-3D disagrees with the reference: {bad}")


def qdist_shards(jmax, imax, dims, n):
    """(geometry, [(joff/2, ioff/2) per shard]) of a (jmax, imax) grid on a
    dims mesh, the CA depth clamped as the solver clamps it."""
    from pampi_tpu_torch.parallel import quarters_dist as qd

    jl, il = jmax // dims[0], imax // dims[1]
    g = qd.make_qgeom(jmax, imax, jl, il, qd.qdist_clamp(n, jl, il))
    return g, [(cj * jl // 2, ci * il // 2)
               for cj in range(dims[0]) for ci in range(dims[1])]


def check_qdist(torch, np, g, qoffs, dtype, seed, calls=2):
    """K13 and its plain version in the solvers' form (reading one plane,
    writing `out`, the two swapped each call) on copies of random stacked
    planes at each shard offset, `calls` calls each (ghosts carried across
    calls). Returns (planes bitwise, residuals bitwise, max_abs_err)."""
    from pampi_tpu_torch.ops import sor_qdist as sq
    from pampi_tpu_torch.ops.sor_kernels import sor_coefficients

    coef = sor_coefficients(1.0 / g.imax, 1.0 / g.jmax, 1.9)
    fb, rb, err = True, True, 0.0
    for k, offs in enumerate(qoffs):
        x, f = rng_fields(torch, np, (4, g.jq, g.iq), dtype, 2, seed + k)
        xk, xp, yk, yp = (x.clone(), x.clone(), torch.empty_like(x),
                          torch.empty_like(x))
        for _ in range(calls):
            rk = sq.rb_sor_qdist(xk, f, g, offs, *coef, out=yk)
            rp = sq.rb_sor_qdist_plain(xp, f, g, offs, *coef, out=yp)
            xk, yk, xp, yp = yk, xk, yp, xp
        fb = fb and torch.equal(xk, xp)
        rb = rb and torch.equal(rk, rp)
        err = max(err, float((xk - xp).abs().max()))
    return fb, rb, err


def qdist_check_cases():
    """K13's check cases as (label, jmax, imax, dims, n): a 32² grid's
    16x8 shard at the offsets (0,0), (8,4), (0,12) (dims None), every shard
    of 1024² on 2x2 and 2x4, of 1024x680 on 2x2 (planes of several tiles,
    cut at the planes' edges) and of 100² on 2x2 (the CLI paths' shards),
    each at n = 1..4 (clamped as the solver clamps it)."""
    cases = []
    for n in (1, 2, 3, 4):
        cases.append(("32² (16x8 shard) at offsets (0,0), (8,4), (0,12)",
                      32, 32, None, n))
        for jmax, imax, dims in ((1024, 1024, (2, 2)), (1024, 1024, (2, 4)),
                                 (1024, 680, (2, 2)), (100, 100, (2, 2))):
            cases.append((f"{imax}x{jmax} on {dims[0]}x{dims[1]}, every "
                          f"shard", jmax, imax, dims, n))
    return cases


@phase("distributed quarter kernel K13 vs plain version")
def check_qdist_kernel(torch, np):
    from pampi_tpu_torch.parallel import quarters_dist as qd

    bad = []
    for dtype in (torch.float32, torch.float64):
        for label, jmax, imax, dims, n in qdist_check_cases():
            if dims is None:
                g = qd.make_qgeom(jmax, imax, 16, 8, qd.qdist_clamp(n, 16, 8))
                qoffs = [(0, 0), (8, 4), (0, 12)]
            else:
                g, qoffs = qdist_shards(jmax, imax, dims, n)
            fb, rb, err = check_qdist(torch, np, g, qoffs, dtype, 51)
            ok = fb and rb
            log(f"rb_sor_qdist {dtype} {label} (n={g.n}, planes "
                f"{g.jq}x{g.iq}), two calls, out=: planes "
                f"bitwise {fb}, residuals bitwise {rb}, max_abs_err "
                f"{err:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"{label} n={g.n} {dtype}")
    if bad:
        raise AssertionError(f"K13 differs from its plain version: {bad}")


@phase("halo-exchange harness on the card: (2, 4) and (2, 2, 2) meshes")
def halo_on_card(np):
    from pampi_tpu_torch.parallel.comm import CartComm
    from pampi_tpu_torch.parallel.halo_debug import rank_id_blocks

    bad = []
    for dims, local in (((2, 4), (4, 6)), ((2, 2, 2), (3, 4, 5))):
        comm = CartComm(ndims=len(dims), dims=dims)
        comm.print_config()
        inner = (slice(1, -1),) * len(dims)
        for coords, blk in rank_id_blocks(comm, local).items():
            rid = int(np.ravel_multi_index(coords, dims))
            ok = bool((blk[inner] == rid).all())
            for a in range(len(dims)):
                for step, idx in ((-1, 0), (1, -1)):
                    c = list(coords)
                    c[a] += step
                    want = (int(np.ravel_multi_index(c, dims))
                            if 0 <= c[a] < dims[a] else rid)
                    face = list(inner)
                    face[a] = idx
                    ok = ok and bool((blk[tuple(face)] == want).all())
            if not ok:
                bad.append(f"{dims} shard {coords}")
        log(f"halo harness {dims} on {sorted(set(map(str, comm.devices)))}: "
            f"every ghost face holds the neighbour's rank id or, at a wall, "
            f"its own: {'ok' if not bad else 'FAIL'}")
    if bad:
        raise AssertionError(f"wrong ghost faces: {bad}")


@phase("K13 vs plain version (f32 and f64, n = 1..4) and its time at 4096² "
       "float32 on 2x2")
def time_qdist(torch, np):
    from pampi_tpu_torch.ops import sor_qdist as sq
    from pampi_tpu_torch.ops.sor_kernels import sor_coefficients

    bad, errs = [], {}
    for dtype, size in ((torch.float32, 4), (torch.float64, 8)):
        for n in (1, 2, 3, 4):
            g, qoffs = qdist_shards(*MAIN, (2, 2), n)
            fb, rb, errs[dtype, n] = check_qdist(torch, np, g, qoffs, dtype,
                                                 61, 1)
            log(f"rb_sor_qdist 4096² {dtype} on 2x2 ({g.jl}² shards, n={g.n},"
                f" {len(sq.qdist_tiles(g, size))} tiles a plane) vs plain, "
                f"every shard: planes bitwise {fb}, residuals bitwise {rb} "
                f"{'ok' if fb and rb else 'FAIL'}")
            if not (fb and rb):
                bad.append(f"{dtype} n={n}")
    if bad:
        raise AssertionError(f"K13 differs from its plain version at 4096²: "
                             f"{bad}")
    g, qoffs = qdist_shards(*MAIN, (2, 2), 4)
    coef = sor_coefficients(1.0 / MAIN[1], 1.0 / MAIN[0], 1.9)
    planes = [rng_fields(torch, np, (4, g.jq, g.iq), torch.float32, 2, 71 + k)
              for k in range(4)]
    outs = [torch.empty_like(x) for x, _ in planes]

    def shards(fn):
        return lambda: [fn(x, f, g, o, *coef, out=y)
                        for (x, f), y, o in zip(planes, outs, qoffs)]

    ms = cuda_ms(torch, shards(sq.rb_sor_qdist), 20) / 4
    pms = cuda_ms(torch, shards(sq.rb_sor_qdist_plain), 3) / 4
    (x, f), y, o = planes[0], outs[0], qoffs[0]
    calls = cuda_launches(torch, lambda: sq.rb_sor_qdist(x, f, g, o, *coef,
                                                         out=y))
    g1, q1 = qdist_shards(*MAIN, (2, 2), 1)
    x1, f1, y1 = rng_fields(torch, np, (4, g1.jq, g1.iq), torch.float32, 3,
                            79)
    calls1 = cuda_launches(torch, lambda: sq.rb_sor_qdist(x1, f1, g1, q1[0],
                                                          *coef, out=y1))
    if (calls or 1) > 1 or (calls1 or 1) > 1:
        raise AssertionError(f"K13 made {calls} / {calls1} CUDA launches a "
                             f"call at n = 4 / 1")
    # per shard call: the plane and its rhs read once, the plane written
    # once; ~12 flops per cell update
    b = bound(3 * 4 * g.jq * g.iq * 4, 12 * g.n * g.jl * g.il)
    log(f"rb_sor_qdist 4096² f32 on 2x2: {ms:.4f} ms per shard call (plain "
        f"{pms:.4f}, bound {b[0]:.4f} by {b[1]}), the four shards on one "
        f"card, out= form; {launches_text(calls)} / {launches_text(calls1)} "
        f"CUDA launches a call at n = 4 / 1")
    return {"rb_sor_qdist": dict(
        max_abs_err=errs[torch.float32, 4], ms=ms, plain_ms=pms,
        bound_ms=b[0], bound_by=b[1], cuda_launches_a_call=calls, n1_cuda_launches_a_call=calls1,
        shape=f"{g.jl}x{g.il} shard of {MAIN[0]}x{MAIN[1]} on 2x2, n={g.n}")}


@contextlib.contextmanager
def exchange_marks(mark):
    """Wrap the quarter exchange of the solve's rounds (the calls that pass
    the prebuilt copies) so that mark() opens "exchange" before it and
    "compute" after it, and the unpack after the loop so that mark() closes
    the last round: the set-up's rhs exchange and the copies' build fall in
    neither span. The solver looks both functions up at call time."""
    from pampi_tpu_torch.parallel import quarters_dist as qd

    q_exchange, unpack = qd.q_exchange, qd.unpack_q_to_ext

    def timed(*a):
        if len(a) < 4:  # the set-up's rhs exchange
            return q_exchange(*a)
        mark("exchange")
        out = q_exchange(*a)
        mark("compute")
        return out

    def unpacked(*a):
        mark("unpack")
        return unpack(*a)

    qd.q_exchange, qd.unpack_q_to_ext = timed, unpacked
    try:
        yield
    finally:
        qd.q_exchange, qd.unpack_q_to_ext = q_exchange, unpack


@phase("main path: distributed Poisson 4096² float32 on a 2x2 mesh")
def main_path_dist(torch, qdist_row):
    from pampi_tpu_torch.kernels import build as kb
    from pampi_tpu_torch.models.poisson import PoissonSolver
    from pampi_tpu_torch.models.poisson_dist import DistPoissonSolver
    from pampi_tpu_torch.parallel.comm import CartComm
    from pampi_tpu_torch.utils.params import Parameter

    J, I = MAIN
    param = Parameter(name="poisson", imax=I, jmax=J, itermax=400, eps=0.0,
                      omg=1.9, tpu_dtype="float32", tpu_sor_inner=4,
                      tpu_mesh="2x2")
    # warm-up: loads K13 and K1
    DistPoissonSolver(param.replace(itermax=4), CartComm(dims=(2, 2))).solve()
    PoissonSolver(param.replace(itermax=4, tpu_mesh="1"),
                  device="cuda").solve()
    out = {}

    def dist():
        s = DistPoissonSolver(param, CartComm(dims=(2, 2)))
        s.comm.print_config()
        marks, mark = event_marks(torch)
        torch.cuda.synchronize()
        with exchange_marks(mark):
            t0 = time.perf_counter()
            it, res = s.solve()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        mark("end")
        torch.cuda.synchronize()
        split = span_ms(marks, ("exchange", "compute"), 1)
        out.update(it=it, res=res, ms=sec / it * 1e3, split=split,
                   field=s.comm.collect(s.p))
        return s

    counts, s = drive_path(kb, "Poisson dist 2x2", ("rb_sor_qdist",), dist)
    single = PoissonSolver(param.replace(tpu_mesh="1"), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    it1, res1 = single.solve()
    torch.cuda.synchronize()
    ms1 = (time.perf_counter() - t0) / it1 * 1e3
    # the interiors: the corner ghosts are float32 casts in one and
    # float64 in the other's full_field
    ref = single.p[1:-1, 1:-1].double().cpu().numpy()
    diff = float(abs(out["field"] - ref).max())
    scale = max(1.0, float(abs(ref).max()))
    sp = out["split"]
    loop = sp["exchange"] + sp["compute"]
    share = sp["exchange"] / loop
    ok = (out["it"] == it1 == 400 and diff <= 1e-5 * scale
          and out["res"] == out["res"])
    log(f"Poisson 4096² f32 on 2x2 ({s.jl}² shards on "
        f"{[str(d) for d in s.comm.devices]}, {s.param.tpu_sor_inner} "
        f"iterations per exchange): {out['it']} iterations, {out['ms']:.4f} "
        f"ms/iteration (host clock, set-up included), residual "
        f"{out['res']:.4e}; the loop {loop / out['it']:.4f} ms/iteration, "
        f"exchange {sp['exchange']:.3f} ms of {loop:.3f} ms (CUDA events "
        f"on {s.comm.devices[0]}), "
        f"share {share:.3f}; single-device K1 {it1} "
        f"iterations, {ms1:.4f} ms/iteration, residual {res1:.4e}; max "
        f"|dist - single| {diff:.3e} (limit {1e-5 * scale:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    if qdist_row is not None:
        log(f"rb_sor_qdist per shard call (phase above): "
            f"{qdist_row['ms']:.4f} ms, bound {qdist_row['bound_ms']:.4f} "
            f"ms; main path launches {counts['rb_sor_qdist']}")
    if not ok:
        raise AssertionError("distributed Poisson disagrees with K1")
    return counts


@phase("main path: python -m pampi_tpu_torch configs/poisson.par with "
       "tpu_mesh 2x2, card and CPU")
def dist_cli(np):
    import io

    from pampi_tpu_torch import cli
    from pampi_tpu_torch.kernels import build as kb
    from pampi_tpu_torch.models import poisson, poisson_dist
    from pampi_tpu_torch.utils import datio

    text = open(os.path.join(ROOT, "configs", "poisson.par")).read()
    runs = {}
    fields = []

    def keep(p, path):
        # the field p.dat is written from, at full precision (p.dat holds
        # six decimals)
        fields.append(datio._host(p))
        datio.write_matrix(p, path)

    with tempfile.TemporaryDirectory() as tmp, \
            mock.patch.object(poisson, "write_matrix", keep), \
            mock.patch.object(poisson_dist, "write_matrix", keep):
        for label, mesh, device in (("card 2x2", "2x2", "cuda"),
                                    ("CPU 2x2", "2x2", "cpu"),
                                    ("card single", "1", "cuda")):
            d = os.path.join(tmp, label.replace(" ", "_"))
            os.makedirs(d)
            par = os.path.join(d, "poisson.par")
            with open(par, "w") as fh:
                fh.write(text.replace("tpu_mesh   auto", f"tpu_mesh   {mesh}"))
            buf = io.StringIO()
            cwd = os.getcwd()
            os.chdir(d)

            def run():
                with contextlib.redirect_stdout(buf):
                    return cli.main(["pampi_tpu_torch", "--device", device,
                                     par])
            try:
                t0 = time.perf_counter()
                if label == "card 2x2":
                    counts, rc = drive_path(kb, "Poisson dist CLI",
                                            ("rb_sor_qdist",), run)
                else:
                    rc = run()
                sec = time.perf_counter() - t0
            finally:
                os.chdir(cwd)
            line = [ln for ln in buf.getvalue().splitlines()
                    if "Walltime" in ln]
            runs[label] = (rc, line[0].split()[0] if line else None,
                           fields.pop() if fields else np.full(1, np.nan))
            log(f"{label}: rc {rc}, '{line[0] if line else ''}' "
                f"({sec:.1f} s)")
    (rc_c, it_c, p_c), (rc_h, it_h, p_h), (rc_s, it_s, p_s) = (
        runs["card 2x2"], runs["CPU 2x2"], runs["card single"])
    # the CPU run is K13's plain version on the same shards and exchanges
    plain = float(np.abs(p_c - p_h).max())
    limit = 1e-12 * max(1.0, float(np.abs(p_h).max()))
    diff = float(np.abs(p_c - p_s).max())
    ok = (rc_c == rc_h == rc_s == 0 and it_c == it_h == it_s == "2388"
          and plain <= limit and diff <= 1e-9)
    log(f"poisson.par 100² f64 tpu_mesh 2x2: {it_c} iterations on the card, "
        f"{it_h} on the CPU, {it_s} single-device; max |p card - CPU| on "
        f"2x2 {plain:.3e} (tol {limit:.3e}, bitwise "
        f"{bool((p_c == p_h).all())}); max |p 2x2 - single| on the card "
        f"{diff:.3e} (tol 1e-9) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the poisson.par mesh run disagrees")
    return counts


# ----------------------------------------------------------------------
# The distributed NS-3D slice: K14 and the distributed mode of K7/K8
# ----------------------------------------------------------------------


def odist_shards(ext, dims, n):
    """(geometry, [(koff/2, joff/2, ioff/2) per shard]) of an (kmax, jmax,
    imax) grid on a dims mesh, the CA depth clamped as the solver clamps
    it."""
    from pampi_tpu_torch.parallel import octants_dist as od

    local = tuple(e // d for e, d in zip(ext, dims))
    g = od.make_ogeom(*ext, *local, od.odist_clamp(n, *local, dims),
                      dims=dims)
    offs = [tuple(c * e // 2 for c, e in zip(mesh_coords(s, dims), local))
            for s in range(dims[0] * dims[1] * dims[2])]
    return g, offs


def mesh_coords(s, dims):
    k, r = divmod(s, dims[1] * dims[2])
    j, i = divmod(r, dims[2])
    return (k, j, i)


def check_odist(torch, np, g, qoffs, dtype, seed, calls=2):
    """K14 and its plain version on copies of random stacked volumes at
    each shard offset, `calls` calls each in the solvers' form (each call
    reads one volume and writes the other of a pair, and the two swap;
    ghosts carried across calls). Returns (volumes bitwise, residuals
    bitwise, max_abs_err)."""
    from pampi_tpu_torch.ops import sor_odist as so
    from pampi_tpu_torch.ops.sor3d import sor_coefficients_3d

    coef = sor_coefficients_3d(1.0 / g.imax, 1.0 / g.jmax, 1.0 / g.kmax, 1.8)
    bitwise, rbit, err = True, True, 0.0
    for k, offs in enumerate(qoffs):
        x, f = rng_fields(torch, np, (8, g.kq, g.jq, g.iq), dtype, 2,
                          seed + k)
        xk = [x.clone(), torch.empty_like(x)]
        xp = [x.clone(), torch.empty_like(x)]
        for _ in range(calls):
            rk = so.rb_sor_odist(xk[0], f, g, offs, *coef, xk[1])
            rp = so.rb_sor_odist_plain(xp[0], f, g, offs, *coef, xp[1])
            xk.reverse()
            xp.reverse()
        bitwise = bitwise and torch.equal(xk[0], xp[0])
        rbit = rbit and torch.equal(rk, rp)
        err = max(err, float((xk[0] - xp[0]).abs().max()))
    return bitwise, rbit, err


def step3d_shard(torch, cfg, offs, G, u, v, w, p, dt, flags=(None, None),
                 ragged=False):
    """K7 on copies of one shard's deep blocks u, v, w, then K8 on the
    stripped halo-1 blocks, each against its plain version on the same
    inputs (in the flag mode with flags = (deep block, halo-1 block); K8
    in its ragged mode when `ragged`, whose dead cells must then be 0 and
    bitwise the plain version's). Returns (copies, maxima and dead cells
    bitwise, F/G/H/rhs and u''/v''/w'' max_rel_err, max_abs_err, K7's
    F/G/H/rhs, the halo-1 u/v/w K8 read)."""
    from pampi_tpu_torch.ops import ns3d as ops3
    from pampi_tpu_torch.ops import ns3d_fused as nf3

    uk, vk, wk = u.clone(), v.clone(), w.clone()
    fk = nf3.ns3d_pre(uk, vk, wk, dt, cfg, offs, G, 2, flags=flags[0])
    pl = nf3.ns3d_pre_plain(u, v, w, dt, cfg, offs, G, 2, flags=flags[0])
    exact = all(torch.equal(a, b) for a, b in zip((uk, vk, wk), pl[:3]))
    strip = (slice(2, -2),) * 3
    h1 = [a[strip].contiguous() for a in (uk, vk, wk)]
    post = [a.clone() for a in h1]
    mk = nf3.ns3d_post(*post, *fk[:3], p, dt, cfg.dx, cfg.dy, cfg.dz, offs, G,
                       flags=flags[1], ragged=ragged)
    mp = nf3.ns3d_post_plain(*(a[strip] for a in pl[:3]), *pl[3:6], p, dt,
                             cfg.dx, cfg.dy, cfg.dz, offs, G, flags[1],
                             ragged)
    exact = exact and all(torch.equal(m, a.abs().max())
                          for m, a in zip(mk, post))
    if ragged:
        gk, gj, gi = ops3.index_grids(post[0].shape, 0, offs, "cuda")
        dead = ((gk > G[0] + 1) | (gj > G[1] + 1)
                | (gi > G[2] + 1)).expand(post[0].shape)
        exact = exact and all(
            torch.equal(a[dead], b[dead]) and not a[dead].any()
            for a, b in zip(post, mp[:3]))
    pairs = list(zip(fk, pl[3:])) + list(zip(post, mp[:3]))
    e = max(rel_err(a, b) for a, b in pairs)
    err = max([float((a - b).abs().max()) for a, b in pairs]
              + [abs(float(a - b)) for a, b in zip(mk, mp[3:])])
    return exact, e, err, fk, h1


def check_step3d_dist(torch, np, dims, param, dtype, seed, ragged=False):
    """K7 on every shard's deep block and K8 on its halo-1 blocks of the
    param's grid on a dims mesh against their plain versions (`ragged`: a
    mesh that does not divide the grid, its blocks ceil-divided, K8 in
    its ragged mode). Returns (copies, maxima and dead cells bitwise,
    F/G/H/rhs and u''/v''/w'' max_rel_err, max_abs_err)."""
    from pampi_tpu_torch.ops import ns3d_fused as nf3

    cfg = nf3.StepConfig3D.from_param(param)
    G = (param.kmax, param.jmax, param.imax)
    local = tuple(-(-e // d) for e, d in zip(G, dims))
    exact, e, err = True, 0.0, 0.0
    dt = torch.tensor(0.013, dtype=dtype, device="cuda")
    fluid = obstacle_fluid(param) if param.obstacles.strip() else None
    for s in range(dims[0] * dims[1] * dims[2]):
        offs = tuple(c * n for c, n in zip(mesh_coords(s, dims), local))
        u, v, w = rng_fields(torch, np, tuple(n + 6 for n in local), dtype,
                             3, seed + s)
        (p,) = rng_fields(torch, np, tuple(n + 2 for n in local), dtype, 1,
                          seed + 100 + s)
        # the flag mode: the shard's deep (PRE) and halo-1 (POST) blocks
        flags = (None, None) if fluid is None else tuple(
            shard_flags(fluid, offs, local, H) for H in (3, 1))
        ex, es, errs, _, _ = step3d_shard(torch, cfg, offs, G, u, v, w, p, dt,
                                          flags, ragged)
        exact, e, err = exact and ex, max(e, es), max(err, errs)
    return exact, e, err


def config(name, **kw):
    """configs/<name> with the given keys replaced."""
    from pampi_tpu_torch.utils.params import read_parameter

    return read_parameter(os.path.join(ROOT, "configs", name)).replace(**kw)


def dist3d_main_configs():
    """The distributed NS-3D main path's runs as (param, mesh dims):
    dcavity3d 128³ f32 on 2x2x2 with eps 0 (every solve runs its itermax,
    25 K14 rounds at n = 4) and canal3d 200x50x50 f64 on 1x1x4 as
    shipped. The kernel checks take their shapes from here."""
    return ((config("dcavity3d.par", itermax=100, eps=0.0, te=1e9,
                    tpu_sor_inner=4), (2, 2, 2)),
            (config("canal3d.par", te=1e9, tpu_mesh="1x1x4"), (1, 1, 4)))


@phase("distributed octant kernel K14 and K7/K8 distributed vs plain")
def check_dist3d_kernels(torch, np):
    from pampi_tpu_torch.ops import sor3d_kernels as sk3
    from pampi_tpu_torch.ops import sor_odist as so
    from pampi_tpu_torch.ops.sor3d import sor_coefficients_3d
    from pampi_tpu_torch.parallel import octants_dist as od
    from pampi_tpu_torch.utils.params import Parameter
    from pampi_tpu_torch.utils.precision import resolve_dtype

    bad = []
    dtypes = (torch.float32, torch.float64)

    def label(ext, dims, g):
        return (f"{'x'.join(map(str, ext))} on {'x'.join(map(str, dims))} "
                f"(n={g.n}, volumes {(8, g.kq, g.jq, g.iq)}), every shard")

    cases = []
    for ext, dims in (((32, 32, 32), (2, 2, 2)), ((32, 48, 64), (1, 2, 4))):
        for n in (1, 2, 3, 4):
            g, offs = odist_shards(ext, dims, n)
            cases += [(label(ext, dims, g), g, offs, dt) for dt in dtypes]
    # the shard geometries of the distributed main path, in its dtype
    main = dist3d_main_configs()
    for param, dims in main:
        ext = (param.kmax, param.jmax, param.imax)
        g, offs = odist_shards(
            ext, dims, max(param.tpu_ca_inner, param.tpu_sor_inner))
        cases.append((f"{param.name} {label(ext, dims, g)}", g, offs,
                      resolve_dtype(param.tpu_dtype)))
    for name, g, offs, dtype in cases:
        bitwise, rbit, err = check_odist(torch, np, g, offs, dtype, 81)
        ok = bitwise and rbit
        log(f"rb_sor_odist {dtype} {name}: volumes bitwise {bitwise}, "
            f"residuals bitwise {rbit}, max_abs_err {err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"{name} {dtype}")
    steps = []
    for dtype in dtypes:
        # (1, 1, 1): the shard's volume is K6's stacked octants, bitwise;
        # the two residuals sum in other orders
        rtol = 1e-5 if dtype == torch.float32 else 1e-12
        g = od.make_ogeom(32, 32, 32, 32, 32, 32, 2, dims=(1, 1, 1))
        coef = sor_coefficients_3d(1 / 32, 1 / 32, 1 / 32, 1.8)
        x, f = rng_fields(torch, np, (8, g.kq, g.jq, g.iq), dtype, 2, 91)
        x14, x6 = [x.clone(), torch.empty_like(x)], x.clone()
        for _ in range(2):
            r14 = so.rb_sor_odist(x14[0], f, g, (0, 0, 0), *coef, x14[1])
            x14.reverse()
            r6 = sk3.rb_sor3d_octants(x6, f, g.n, *coef)
        vol = torch.equal(x14[0], x6)
        er = abs(float(r14) - float(r6)) / abs(float(r6))
        ok = vol and er <= rtol
        log(f"rb_sor_odist {dtype} 32³ on 1x1x1 vs rb_sor3d_octants (K6): "
            f"volume bitwise {vol}, residual rel_err {er:.3e} (tol {rtol:g})"
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"K14 vs K6 {dtype}")
        for problem, bckw in CASES_3D:
            steps.append((Parameter(name=problem, imax=64, jmax=64, kmax=64,
                                    re=100.0, **bckw), (2, 2, 2), dtype))
    # the main path's shards, with its configs' BCs, in its dtype
    steps += [(param, dims, resolve_dtype(param.tpu_dtype))
              for param, dims in main]
    for param, dims, dtype in steps:
        t = tol(torch, dtype)
        exact, e, err = check_step3d_dist(torch, np, dims, param, dtype, 61)
        ok = exact and e <= t
        shape = f"{param.imax}x{param.jmax}x{param.kmax}"
        log(f"ns3d_pre/post distributed {param.name} {dtype} {shape} on "
            f"{'x'.join(map(str, dims))}, every shard: u', v', w' and maxima"
            f" bitwise {exact}, max_rel_err {e:.3e}, max_abs_err {err:.3e} "
            f"(tol {t:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"ns3d_pre/post distributed {param.name} {shape} "
                       f"{dtype}")
    if bad:
        raise AssertionError(f"distributed 3-D kernels disagree: {bad}")


@phase("K14 and K7/K8 distributed: times at 256³ float32 on 2x2x2")
def time_dist3d(torch, np):
    from pampi_tpu_torch.ops import ns3d_fused as nf3
    from pampi_tpu_torch.ops import sor_odist as so
    from pampi_tpu_torch.ops.sor3d import sor_coefficients_3d
    from pampi_tpu_torch.utils.params import Parameter

    dims, size = (2, 2, 2), 4
    bad = []
    for dtype in (torch.float32, torch.float64):
        for n in (1, 2, 3, 4):
            g, qoffs = odist_shards(BIG3, dims, n)
            bitwise, rbit, err = check_odist(torch, np, g, qoffs, dtype,
                                             101, 1)
            if dtype == torch.float32 and n == 4:
                err4 = err
            log(f"rb_sor_odist 256³ {dtype} on 2x2x2 ({g.kl}³ shards, "
                f"n={g.n}) vs plain, every shard: volumes bitwise {bitwise}"
                f", residuals bitwise {rbit} "
                f"{'ok' if bitwise and rbit else 'FAIL'}")
            if not (bitwise and rbit):
                bad.append(f"{dtype} n={n}")
    if bad:
        raise AssertionError(f"K14 differs from its plain version at 256³: "
                             f"{bad}")
    g, qoffs = odist_shards(BIG3, dims, 4)
    coef = sor_coefficients_3d(1 / BIG3[2], 1 / BIG3[1], 1 / BIG3[0], 1.8)
    vols = [rng_fields(torch, np, (8, g.kq, g.jq, g.iq), torch.float32, 3,
                       111 + k) for k in range(8)]

    def shards(fn):
        return lambda: [fn(x, f, g, o, *coef, y)
                        for (x, f, y), o in zip(vols, qoffs)]

    ms = cuda_ms(torch, shards(so.rb_sor_odist), 20) / 8
    pms = cuda_ms(torch, shards(so.rb_sor_odist_plain), 2) / 8
    x, f, y = vols[0]
    calls = cuda_launches(torch, lambda: so.rb_sor_odist(
        x, f, g, qoffs[0], *coef, y))
    cells = 8 * g.kq * g.jq * g.iq
    # per shard call: the volume and its rhs read once, the volume written
    # once; ~13 flops per cell update
    b = bound(3 * cells * size, 13 * g.n * g.kl * g.jl * g.il)
    rows = {"rb_sor_odist": dict(
        max_abs_err=err4, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
        cuda_launches_a_call=calls,
        shape=f"{g.kl}³ shard of 256³ on 2x2x2, n={g.n}")}
    log(f"rb_sor_odist 256³ f32 on 2x2x2: {ms:.4f} ms per shard call (plain "
        f"{pms:.4f}, bound {b[0]:.4f} by {b[1]}), {launches_text(calls)} "
        f"CUDA launches a call, the eight shards on one card")
    del vols, x, f, y
    # K7 on a deep block, K8 on the halo-1 blocks of the (1, 1, 1) shard
    # of 256³ on 2x2x2 (interfaces on three sides, walls on the other
    # three)
    K, J, I = BIG3
    param = Parameter(name="dcavity3d", imax=I, jmax=J, kmax=K, re=1000.0)
    cfg = nf3.StepConfig3D.from_param(param)
    l = K // 2
    offs, G = (l, l, l), BIG3
    u, v, w = rng_fields(torch, np, (l + 6,) * 3, torch.float32, 3, 121)
    (p,) = rng_fields(torch, np, (l + 2,) * 3, torch.float32, 1, 124)
    dt = torch.tensor(1e-3, dtype=torch.float32, device="cuda")
    exact, e, perr, fk, h1 = step3d_shard(torch, cfg, offs, G, u, v, w, p,
                                          dt)
    ok = exact and e <= tol(torch, torch.float32)
    log(f"ns3d_pre/post distributed 256³ f32 on 2x2x2 (the 128³ shard at "
        f"{offs}) vs plain: u', v', w' and maxima bitwise {exact}, "
        f"max_rel_err {e:.3e}, max_abs_err {perr:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K7/K8 differ from their plain versions at 256³")
    uk, vk, wk = u.clone(), v.clone(), w.clone()
    deep, ext = (l + 6) ** 3, (l + 2) ** 3
    ms = cuda_ms(torch, lambda: nf3.ns3d_pre(uk, vk, wk, dt, cfg, offs, G,
                                             2), 20)
    pms = cuda_ms(torch, lambda: nf3.ns3d_pre_plain(u, v, w, dt, cfg, offs,
                                                    G, 2), 3)
    # PRE: reads the three deep blocks, writes F, G, H, rhs on the halo-1
    # block (and the shard's three wall faces of u, v, w, not counted);
    # ~190 flops a cell
    bpre = bound((3 * deep + 4 * ext) * size, 190 * l ** 3)
    qms = cuda_ms(torch, lambda: nf3.ns3d_post(
        *h1, *fk[:3], p, dt, cfg.dx, cfg.dy, cfg.dz, offs, G), 20)
    qpms = cuda_ms(torch, lambda: nf3.ns3d_post_plain(
        *h1, *fk[:3], p, dt, cfg.dx, cfg.dy, cfg.dz, offs, G), 3)
    # POST: reads F, G, H, p and u, v, w (the maxima), writes u, v, w
    bpost = bound(10 * ext * size, 15 * l ** 3)
    rows["ns3d_pre"] = dict(dist_ms=ms, dist_plain_ms=pms,
                            dist_bound_ms=bpre[0], dist_bound_by=bpre[1],
                            dist_max_abs_err=perr)
    rows["ns3d_post"] = dict(dist_ms=qms, dist_plain_ms=qpms,
                             dist_bound_ms=bpost[0], dist_bound_by=bpost[1],
                             dist_max_abs_err=perr)
    log(f"ns3d_pre distributed 256³ f32 on 2x2x2 (one 128³ shard, deep "
        f"block {l + 6}³): {ms:.4f} ms per shard call (plain {pms:.4f}, "
        f"bound {bpre[0]:.4f} by {bpre[1]}); ns3d_post distributed: "
        f"{qms:.4f} ms (plain {qpms:.4f}, bound {bpost[0]:.4f} by "
        f"{bpost[1]})")
    return rows


def global_diff(dist, single):
    """max |dist - single| over the global u, v, w, p, and the scale."""
    gd = dist.global_fields()
    diff = scale = 0.0
    for n in "uvwp":
        ref = getattr(single, n).double().cpu().numpy()
        diff = max(diff, float(abs(gd[n] - ref).max()))
        scale = max(scale, float(abs(ref).max()))
    return diff, max(1.0, scale)


@contextlib.contextmanager
def exchange_spans(mark, *targets):
    """Wrap the exchange functions `targets` ((module, name) pairs, which
    the solvers look up at call time) so that mark() opens "exchange"
    before each call and "compute" after it."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def timed(fn):
        def run(*a, **kw):
            mark("exchange")
            out = fn(*a, **kw)
            mark("compute")
            return out
        return run

    for mod, name, fn in saved:
        setattr(mod, name, timed(fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@phase("main path: distributed NS-3D configs/dcavity3d.par 128³ on 2x2x2 "
       "and configs/canal3d.par on 1x1x4")
def main_path_dist3d(torch):
    from pampi_tpu_torch.kernels import build as kb
    from pampi_tpu_torch.models.ns3d import NS3DSolver
    from pampi_tpu_torch.models.ns3d_dist import NS3DDistSolver
    from pampi_tpu_torch.parallel import comm as pc
    from pampi_tpu_torch.parallel import octants_dist as od
    from pampi_tpu_torch.parallel.comm import CartComm

    counts = []
    (dcavity, _), (canal, canal_dims) = dist3d_main_configs()
    # One card holds the eight shards of 2x2x2; several cards take the
    # `auto` mesh, one shard per card.
    several = torch.cuda.device_count() > 1
    param = dcavity.replace(tpu_mesh="auto" if several else "2x2x2")
    s = NS3DDistSolver(param, CartComm(
        ndims=3, dims=None if several else (2, 2, 2),
        extents=(param.kmax, param.jmax, param.imax)))
    s.comm.print_config()
    out = {}

    def dist():
        s.run_steps(1)  # warm-up: loads the kernels
        marks, mark = event_marks(torch)
        s.phase_hook = mark
        torch.cuda.synchronize()
        with exchange_spans(mark, (pc, "halo_exchange"), (od, "o_exchange")):
            t0 = time.perf_counter()
            s.run_steps(16)
            torch.cuda.synchronize()
            out["ms"] = (time.perf_counter() - t0) / 16 * 1e3
        s.phase_hook = None
        phases = [m for m in marks if m[0] in PHASES]
        out.update(span_ms(phases, ("pre", "solve", "post"), 16))
        out["exchange"] = span_ms(marks, ("exchange",), 16)["exchange"]

    mesh = "x".join(map(str, s.comm.dims))
    c, _ = drive_path(kb, f"NS-3D dcavity3d {mesh}",
                      ("rb_sor_odist", "ns3d_pre", "ns3d_post"), dist)
    counts.append(c)
    if c["rb_sor3d_octants"] or c["rb_sor3d_octants_onchip"]:
        raise AssertionError("the distributed path launched K6")
    single = NS3DSolver(param.replace(tpu_mesh="1"), device="cuda")
    single.run_steps(17)
    diff, scale = global_diff(s, single)
    step = out["pre"] + out["solve"] + out["post"]
    ok = (s.nt == single.nt == 17 and s.t == single.t
          and diff <= 1e-5 * scale)
    log(f"NS-3D dcavity3d 128³ f32 on {mesh} ({s.kl}x{s.jl}x{s.il} shards on "
        f"{sorted(set(map(str, s.comm.devices)))}, {s._n_o} iterations per "
        f"exchange): {out['ms']:.3f} ms/step (host clock); PRE "
        f"{out['pre']:.3f} / solve {out['solve']:.3f} / POST "
        f"{out['post']:.3f} ms (CUDA events); exchanges {out['exchange']:.3f}"
        f" ms/step, share {out['exchange'] / step:.3f} of the step; "
        f"t={s.t:.6e}, single-device t={single.t:.6e}; max |dist - single| "
        f"{diff:.3e} (limit {1e-5 * scale:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("distributed dcavity3d disagrees with K6")
    del s, single
    torch.cuda.empty_cache()

    param = canal
    s = NS3DDistSolver(param, CartComm(ndims=3, dims=canal_dims))

    def canal():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run_steps(8)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 8 * 1e3

    c, ms = drive_path(kb, "NS-3D canal3d 1x1x4",
                       ("rb_sor_odist", "ns3d_pre", "ns3d_post"), canal)
    counts.append(c)
    single = NS3DSolver(param.replace(tpu_mesh="1"), device="cuda")
    single.run_steps(8)
    diff, scale = global_diff(s, single)
    ok = s.nt == single.nt == 8 and diff <= 1e-9 * scale
    log(f"NS-3D canal3d 200x50x50 f64 on 1x1x4 (itermax 500, eps 1e-4): "
        f"{ms:.3f} ms/step over 8 steps (host clock, first step included), "
        f"t={s.t:.6e}, single-device t={single.t:.6e}; max |dist - single| "
        f"{diff:.3e} (limit {1e-9 * scale:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("distributed canal3d disagrees with one device")
    return counts


@phase("distributed NS-3D on 2x2x2 on the card against the reference's VTK")
def ns3d_dist_vs_fixtures(np):
    from pampi_tpu_torch.models.ns3d_dist import NS3DDistSolver
    from pampi_tpu_torch.parallel.comm import CartComm
    from pampi_tpu_torch.utils.params import read_parameter
    from pampi_tpu_torch.utils.vtkio import read_vtk_ascii

    fixtures = os.path.join(ROOT, "tests", "fixtures")
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        for par, kw, fixture, steps in (
                ("dcavity3d.par", dict(imax=32, jmax=32, kmax=32, te=1.0),
                 "dcavity3d_32_te1.0.vtk", 112),
                ("canal3d.par", dict(imax=48, jmax=16, kmax=16, te=0.5),
                 "canal3d_48x16x16_te0.5.vtk", None)):
            param = read_parameter(os.path.join(ROOT, "configs", par)).replace(
                tpu_dtype="float64", tpu_sor_inner=1, **kw)
            t0 = time.perf_counter()
            s = NS3DDistSolver(param, CartComm(ndims=3, dims=(2, 2, 2)))
            s.run(progress=False)
            out = os.path.join(tmp, "out.vtk")
            s.write_result(out, fmt="ascii")
            so, vo = read_vtk_ascii(out)
            sg, vg = read_vtk_ascii(os.path.join(fixtures, fixture))
            dp = float(np.abs(so["pressure"] - sg["pressure"]).max())
            dv = max(float(np.abs(vo["velocity"][c] - vg["velocity"][c]).max())
                     for c in range(3))
            ok = dp <= 1e-6 and dv <= 1e-6 and steps in (None, s.nt)
            log(f"{par} {kw} f64 on 2x2x2 on the card: {s.nt} steps to "
                f"t={s.t:.6f} in {time.perf_counter() - t0:.1f} s; max "
                f"|card - {fixture}| pressure {dp:.3e}, velocity {dv:.3e} "
                f"(tol 1e-6{'' if steps is None else f', {steps} steps'}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(par)
    if bad:
        raise AssertionError(f"distributed NS-3D disagrees: {bad}")


@phase("main path: python -m pampi_tpu_torch dcavity3d 16³ with tpu_mesh "
       "2x2x2 and tpu_vtk sharded, card and CPU")
def dist3d_cli(np):
    import io
    import re

    from pampi_tpu_torch import cli
    from pampi_tpu_torch.kernels import build as kb

    text = open(os.path.join(ROOT, "configs", "dcavity3d.par")).read()
    for key, val in (("imax", 16), ("jmax", 16), ("kmax", 16), ("te", 0.5),
                     ("tpu_dtype", "float64"), ("tpu_mesh", "2x2x2")):
        text = re.sub(rf"^{key} .*$", f"{key} {val}", text, flags=re.M)
    text += "\ntpu_sor_inner 1\ntpu_vtk sharded\n"
    files, counts = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        for device in ("cuda", "cpu"):
            d = os.path.join(tmp, device)
            os.makedirs(d)
            par = os.path.join(d, "dcavity3d.par")
            with open(par, "w") as fh:
                fh.write(text)
            buf = io.StringIO()
            cwd = os.getcwd()
            os.chdir(d)

            def run():
                with contextlib.redirect_stdout(buf):
                    return cli.main(["pampi_tpu_torch", "--device", device,
                                     par])
            try:
                t0 = time.perf_counter()
                if device == "cuda":
                    counts, rc = drive_path(
                        kb, "NS-3D dist CLI",
                        ("rb_sor_odist", "ns3d_pre", "ns3d_post"), run)
                else:
                    rc = run()
                sec = time.perf_counter() - t0
            finally:
                os.chdir(cwd)
            with open(os.path.join(d, "dcavity.vtk"), "rb") as fh:
                files[device] = fh.read()
            placed = "8 shards share 1 device(s)" in buf.getvalue()
            log(f"{device}: rc {rc}, shard placement printed {placed} "
                f"({sec:.1f} s)")
            if rc != 0 or not placed:
                raise AssertionError(f"the {device} CLI run failed")
    a, b = files["cuda"], files["cpu"]
    head = a.index(b"LOOKUP_TABLE default\n") + 21
    n = 16 ** 3
    same = a[:head] == b[:head] and len(a) == len(b)
    pa = np.frombuffer(a[head:head + 8 * n], ">f8")
    pb = np.frombuffer(b[head:head + 8 * n], ">f8")
    vhead = a.index(b"VECTORS velocity double\n") + 24
    va = np.frombuffer(a[vhead:vhead + 24 * n], ">f8")
    vb = np.frombuffer(b[vhead:vhead + 24 * n], ">f8")
    diff = max(float(abs(pa - pb).max()), float(abs(va - vb).max()))
    ok = same and diff <= 1e-9
    log(f"dcavity3d 16³ f64 tpu_mesh 2x2x2 tpu_vtk sharded: headers and "
        f"lengths equal {same}, max |card - CPU| {diff:.3e} (tol 1e-9, "
        f"bytes equal {a == b}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the sharded VTK of card and CPU disagree")
    return counts


# ---------------------------------------------------------------------------
# The distributed NS-2D slice: K15 and the distributed mode of K3/K4
# ---------------------------------------------------------------------------


def dist2d_main_configs():
    """The distributed NS-2D main path's runs as (label, param, mesh dims):
    dcavity 4096² f32 (re 1000, tpu_sor_inner 4, itermax 100, eps 0: every
    solve runs 25 rounds at n = 4) on 2x2 (K13), on the ragged 3x1 (K15,
    1366-row shards) and on 2x2 under tpu_sor_layout checkerboard (K15).
    The kernel checks take their shapes from here."""
    J, I = MAIN
    base = config("dcavity.par", imax=I, jmax=J, re=1000.0, itermax=100,
                  eps=0.0, te=1e9, tpu_dtype="float32", tpu_sor_inner=4)
    return (("2x2", base.replace(tpu_mesh="2x2"), (2, 2)),
            ("3x1 ragged", base.replace(tpu_mesh="3x1"), (3, 1)),
            ("2x2 checkerboard", base.replace(
                tpu_mesh="2x2", tpu_sor_layout="checkerboard"), (2, 2)))


def dist2d_check_configs():
    """The main path's runs and the CLI phase's shipped configs on their
    ragged meshes: configs/dcavity.par (100² f64) on 3x3 (34² shards) and
    configs/canal.par (200x50 f64) on 3x2."""
    return dist2d_main_configs() + (
        ("dcavity.par 3x3", config("dcavity.par", tpu_mesh="3x3"), (3, 3)),
        ("canal.par 3x2", config("canal.par", tpu_mesh="3x2"), (3, 2)))


def dist2d_solver(param, dims):
    """NS2DDistSolver of param on a dims mesh of the card(s)."""
    from pampi_tpu_torch.models.ns2d_dist import NS2DDistSolver
    from pampi_tpu_torch.parallel.comm import CartComm

    return NS2DDistSolver(param, CartComm(ndims=2, dims=dims))


def check_obsdist(torch, np, solve, param, dtype, seed, calls=2):
    """K15 and its plain version on copies of random deep blocks of every
    shard of a solver's K15 solve (its geometry, flags and offsets),
    `calls` calls each. Returns (blocks bitwise, residual rel_err,
    max_abs_err)."""
    from pampi_tpu_torch.ops import sor_obsdist as sod

    g = solve.geom
    dx, dy = param.xlength / param.imax, param.ylength / param.jmax
    coef = (param.omg, 1.0 / (dx * dx), 1.0 / (dy * dy))
    bitwise, er, err = True, 0.0, 0.0
    for k, (fl, offs) in enumerate(zip(solve.flags, solve.offs)):
        x, f = rng_fields(torch, np, g.shape, dtype, 2, seed + k)
        xk, xp = x.clone(), x.clone()
        for _ in range(calls):
            rk = sod.rb_sor_obsdist(xk, f, fl, g, offs, *coef)
            rp = sod.rb_iters_obsdist_plain(xp, f, fl, g, offs, *coef)
        bitwise = bitwise and torch.equal(xk, xp)
        er = max(er, abs(float(rk) - float(rp)) / abs(float(rp)))
        err = max(err, float((xk - xp).abs().max()))
    return bitwise, er, err


def time_obsdist_shards(torch, solve, blocks, coef, reps=20):
    """K15 (K16 where solve.geom is 3-D) as the solve calls it (reading a
    block, writing `out`) and its plain version on every shard's random
    (p, rhs) of `blocks`, with the solve's flags and offsets: (ms a shard
    call, plain ms a shard call, CUDA launches a call)."""
    from pampi_tpu_torch.ops import sor_obsdist as sod
    from pampi_tpu_torch.ops import sor_obsdist3d as sod3

    three = isinstance(solve.geom, sod3.ObsGeom3)
    kern = sod3.rb_sor_obsdist3d if three else sod.rb_sor_obsdist
    plain = (sod3.rb_iters_obsdist3d_plain if three
             else sod.rb_iters_obsdist_plain)
    g, nsh = solve.geom, len(solve.offs)
    outs = [torch.empty_like(x) for x, _ in blocks]
    shards = list(zip(blocks, outs, solve.flags, solve.offs))

    def run():
        return [kern(x, f, fl, g, o, *coef, out=y)
                for (x, f), y, fl, o in shards]

    ms = cuda_ms(torch, run, reps) / nsh
    pms = cuda_ms(torch, lambda: [plain(x.clone(), f, fl, g, o, *coef)
                                  for (x, f), _, fl, o in shards], 2) / nsh
    calls = cuda_launches(torch, lambda: kern(
        blocks[0][0], blocks[0][1], solve.flags[0], g, solve.offs[0], *coef,
        out=outs[0]))
    # the solvers' form: one launch for K15, three for K16 (its residual's
    # row sums and their sum)
    if calls is not None and calls > (3 if three else 1):
        raise AssertionError(f"{kern.__name__} made {calls} CUDA launches "
                             f"a call")
    return ms, pms, calls


def step2d_shard(torch, cfg, offs, G, u, v, p, dt, ragged,
                 flags=(None, None)):
    """K3 on copies of one shard's deep blocks u, v, then K4 on the
    stripped halo-1 blocks, each against its plain version on the same
    inputs (`flags`: the shard's deep and halo-1 flag blocks, the flag
    mode). Returns (copies and maxima bitwise, every output bitwise,
    F/G/rhs and u''/v'' max_rel_err, max_abs_err, K3's F/G/rhs, the
    halo-1 u/v K4 read)."""
    from pampi_tpu_torch.ops import ns2d as ops2
    from pampi_tpu_torch.ops import ns2d_fused as nf

    uk, vk = u.clone(), v.clone()
    fk = nf.ns2d_pre(uk, vk, dt, cfg, offs, G, 2, flags[0])
    pl = nf.ns2d_pre_plain(u, v, dt, cfg, offs, G, 2, flags[0])
    exact = torch.equal(uk, pl[0]) and torch.equal(vk, pl[1])
    strip = (slice(2, -2),) * 2
    h1 = [a[strip].contiguous() for a in (uk, vk)]
    post = [a.clone() for a in h1]
    mk = nf.ns2d_post(*post, *fk[:2], p, dt, cfg.dx, cfg.dy, offs, G,
                      ragged, flags[1])
    mp = nf.ns2d_post_plain(*(a[strip] for a in pl[:2]), *pl[2:4], p, dt,
                            cfg.dx, cfg.dy, offs, G, ragged, flags[1])
    gj, gi = ops2.index_grids_2d(p.shape, 0, offs, p.device)
    valid = (gj <= G[0] + 1) & (gi <= G[1] + 1)
    exact = exact and all(
        torch.equal(m, torch.where(valid, a.abs(), 0).max())
        for m, a in zip(mk, post))
    pairs = list(zip(fk, pl[2:])) + list(zip(post, mp[:2]))
    every = exact and all(torch.equal(a, b) for a, b in pairs)
    e = max(rel_err(a, b) for a, b in pairs)
    err = max([float((a - b).abs().max()) for a, b in pairs]
              + [abs(float(a - b)) for a, b in zip(mk, mp[2:])])
    return exact, every, e, err, fk, h1


@phase("distributed flag-masked kernel K15 and K3/K4 distributed vs plain")
def check_dist2d_kernels(torch, np):
    from pampi_tpu_torch.ops import sor_kernels as sk
    from pampi_tpu_torch.ops import sor_obsdist as sod
    from pampi_tpu_torch.ops.ns2d_fused import StepConfig
    from pampi_tpu_torch.parallel.stencil2d import embed_deep, strip_deep
    from pampi_tpu_torch.utils.params import Parameter

    bad = []
    for label, param, dims in dist2d_check_configs():
        s = dist2d_solver(param, dims)
        dtype, name = s.dtype, f"{param.name} {label}"
        t = tol(torch, dtype)
        if s._solve_k is not None:
            g = s._solve_k.geom
            bitwise, er, err = check_obsdist(torch, np, s._solve_k, param,
                                             dtype, 131)
            ok = bitwise and er <= t
            log(f"rb_sor_obsdist {dtype} {name} (n={g.n}, H={g.H}, deep "
                f"blocks {g.shape}), every shard: blocks bitwise {bitwise},"
                f" max_abs_err {err:.3e}, residual rel_err {er:.3e} (tol "
                f"{t:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"K15 {name}")
        cfg = StepConfig.from_param(param)
        dt = torch.tensor(0.013, dtype=dtype, device="cuda")
        exact, every, e, err = True, True, 0.0, 0.0
        for k, off in enumerate(s.offs):
            u, v = rng_fields(torch, np, (s.jl + 6, s.il + 6), dtype, 2,
                              141 + k)
            (p,) = rng_fields(torch, np, (s.jl + 2, s.il + 2), dtype, 1,
                              151 + k)
            ex, ev, es, errs, _, _ = step2d_shard(torch, cfg, off, s.gext,
                                                  u, v, p, dt, s.ragged)
            exact, every = exact and ex, every and ev
            e, err = max(e, es), max(err, errs)
        ok = exact and e <= t
        log(f"ns2d_pre/post distributed {dtype} {name} ({s.jl}x{s.il} "
            f"shards), every shard: u', v' and maxima bitwise {exact}, "
            f"every output bitwise {every}, max_rel_err {e:.3e}, "
            f"max_abs_err {err:.3e} (tol {t:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"K3/K4 distributed {name}")
        del s
    # K15 on a 1x1 mesh with all-fluid flags against K2 on the same field:
    # the same iterations, the relaxation factor formed from the flags
    for dtype in (torch.float32, torch.float64):
        J = I = 1024
        param = Parameter(name="dcavity", imax=I, jmax=J, omg=1.8, eps=0.0,
                          tpu_sor_layout="checkerboard", tpu_mesh="1x1",
                          tpu_dtype="float32" if dtype == torch.float32
                          else "float64")
        s = dist2d_solver(param, (1, 1))
        solve = s._solve_k
        g = solve.geom
        p, rhs = rng_fields(torch, np, (J + 2, I + 2), dtype, 2, 161)
        pd = embed_deep(p, g.H).contiguous()
        rd = embed_deep(rhs, g.H).contiguous()
        dx, dy = 1.0 / I, 1.0 / J
        r15 = sod.rb_sor_obsdist(pd, rd, solve.flags[0], g, (0, 0),
                                 param.omg, 1.0 / (dx * dx), 1.0 / (dy * dy))
        r2 = sk.rb_sor_checkerboard(p, rhs, g.n,
                                    *sk.sor_coefficients(dx, dy, param.omg))
        e = rel_err(strip_deep(pd, g.H), p)
        er = abs(float(r15) - float(r2)) / abs(float(r2))
        t = tol(torch, dtype)
        ok = e <= t and er <= t
        log(f"rb_sor_obsdist {dtype} 1024² on 1x1 (n={g.n}) vs "
            f"rb_sor_checkerboard (K2): field rel_err {e:.3e}, residual "
            f"rel_err {er:.3e} (tol {t:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"K15 vs K2 {dtype}")
    if bad:
        raise AssertionError(f"distributed 2-D kernels disagree: {bad}")


@phase("K15 and K3/K4 distributed: times per 1366x4096 shard of 4096² "
       "float32 on the ragged 3x1")
def time_dist2d(torch, np):
    from pampi_tpu_torch.ops import ns2d_fused as nf
    from pampi_tpu_torch.ops.ns2d_fused import StepConfig

    _, param, dims = dist2d_main_configs()[1]
    s = dist2d_solver(param, dims)
    solve, size = s._solve_k, 4
    g = solve.geom
    bitwise, er, err = check_obsdist(torch, np, solve, param, s.dtype, 171,
                                     1)
    ok = bitwise and er <= tol(torch, s.dtype)
    log(f"rb_sor_obsdist 4096² f32 on 3x1 (deep blocks {g.shape}, n={g.n}) "
        f"vs plain, every shard: blocks bitwise {bitwise}, residual rel_err "
        f"{er:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K15 differs from its plain version at 4096²")
    blocks = [rng_fields(torch, np, g.shape, torch.float32, 2, 181 + k)
              for k in range(len(solve.offs))]
    coef = (param.omg, 1.0 / (s.dx * s.dx), 1.0 / (s.dy * s.dy))

    nsh = len(solve.offs)
    ms, pms, calls = time_obsdist_shards(torch, solve, blocks, coef)
    # per shard call: p, rhs (4 bytes) and the flags (1) of the cells K15
    # reads, read once, p written once (the mean over the three shards,
    # whose times are averaged); ~20 flops per cell update
    read = sum(k15_read_cells(g, o) for o in solve.offs) / nsh
    b = bound(read * (3 * size + 1), 20 * g.n * g.jl * g.il)
    rows = {"rb_sor_obsdist": dict(
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
        cuda_launches_a_call=calls,
        shape=f"{g.jl}x{g.il} shard of 4096x4096 on 3x1 (deep "
              f"{g.shape[0]}x{g.shape[1]}), n={g.n}, {read:.0f} cells "
              f"read a shard")}
    log(f"rb_sor_obsdist 4096² f32 on 3x1: {ms:.4f} ms per shard call "
        f"(plain {pms:.4f}, bound {b[0]:.4f} by {b[1]}), "
        f"{launches_text(calls)} CUDA launches a call, the three shards "
        f"on one card")
    del blocks
    # K3 on a deep block, K4 on the halo-1 blocks of the middle shard
    # (interfaces above and below, the side walls)
    cfg = StepConfig.from_param(param)
    off = s.offs[1]
    jl, il = s.local
    u, v = rng_fields(torch, np, (jl + 6, il + 6), torch.float32, 2, 191)
    (p,) = rng_fields(torch, np, (jl + 2, il + 2), torch.float32, 1, 193)
    dt = torch.tensor(1e-3, dtype=torch.float32, device="cuda")
    exact, every, e, perr, fk, h1 = step2d_shard(torch, cfg, off, s.gext, u,
                                                 v, p, dt, s.ragged)
    ok = exact and e <= tol(torch, torch.float32)
    log(f"ns2d_pre/post distributed 4096² f32 on 3x1 (the shard at {off}) "
        f"vs plain: u', v' and maxima bitwise {exact}, every output bitwise "
        f"{every}, max_rel_err {e:.3e}, max_abs_err {perr:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K3/K4 differ from their plain versions")
    uk, vk = u.clone(), v.clone()
    deep, ext = (jl + 6) * (il + 6), (jl + 2) * (il + 2)
    ms = cuda_ms(torch, lambda: nf.ns2d_pre(uk, vk, dt, cfg, off, s.gext,
                                            2), 20)
    pms = cuda_ms(torch, lambda: nf.ns2d_pre_plain(u, v, dt, cfg, off,
                                                   s.gext, 2), 3)
    # PRE: reads the two deep blocks, writes F, G, rhs on the halo-1 block
    # (and the shard's wall strips of u, v, not counted); ~70 flops a cell
    bpre = bound((2 * deep + 3 * ext) * size, 70 * jl * il)
    qms = cuda_ms(torch, lambda: nf.ns2d_post(
        *h1, *fk[:2], p, dt, cfg.dx, cfg.dy, off, s.gext, s.ragged), 20)
    qpms = cuda_ms(torch, lambda: nf.ns2d_post_plain(
        *h1, *fk[:2], p, dt, cfg.dx, cfg.dy, off, s.gext, s.ragged), 3)
    # POST: reads F, G, p and the ghost ring of u and v (the maxima; the
    # interior of u and v is overwritten, dead cells multiplied by 0),
    # writes u and v, as single-device K4 is bounded
    ring = 2 * (il + 2) + 2 * jl
    bpost = bound((5 * ext + 2 * ring) * size, 10 * jl * il)
    rows["ns2d_pre"] = dict(dist_ms=ms, dist_plain_ms=pms,
                            dist_bound_ms=bpre[0], dist_bound_by=bpre[1],
                            dist_max_abs_err=perr)
    rows["ns2d_post"] = dict(dist_ms=qms, dist_plain_ms=qpms,
                             dist_bound_ms=bpost[0], dist_bound_by=bpost[1],
                             dist_max_abs_err=perr)
    log(f"ns2d_pre distributed 4096² f32 on 3x1 (one {jl}x{il} shard, deep "
        f"block {jl + 6}x{il + 6}): {ms:.4f} ms per shard call (plain "
        f"{pms:.4f}, bound {bpre[0]:.4f} by {bpre[1]}); ns2d_post "
        f"distributed: {qms:.4f} ms (plain {qpms:.4f}, bound {bpost[0]:.4f} "
        f"by {bpost[1]})")
    return rows


def dist2d_steps(torch, s, n):
    """n steps of a distributed NS solver after one warm-up step:
    ms/step on the host clock, the PRE / solve / POST split and the
    exchanges (halo and quarter) from CUDA events, per step."""
    from pampi_tpu_torch.parallel import comm as pc
    from pampi_tpu_torch.parallel import quarters_dist as qd

    s.run_steps(1)  # warm-up: loads the kernels
    marks, mark = event_marks(torch)
    s.phase_hook = mark
    torch.cuda.synchronize()
    with exchange_spans(mark, (pc, "halo_exchange"), (qd, "q_exchange")):
        t0 = time.perf_counter()
        s.run_steps(n)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    s.phase_hook = None
    phases = [m for m in marks if m[0] in PHASES]
    out = dict(ms=wall, **span_ms(phases, ("pre", "solve", "post"), n))
    out["exchange"] = span_ms(marks, ("exchange",), n)["exchange"]
    return out


def field_diff(dist, single):
    """max |dist - single| over the global u, v, p, and the scale."""
    gd = dist.global_fields()
    diff = scale = 0.0
    for n in "uvp":
        ref = getattr(single, n).double().cpu().numpy()
        diff = max(diff, float(abs(gd[n] - ref).max()))
        scale = max(scale, float(abs(ref).max()))
    return diff, max(1.0, scale)


@phase("main path: distributed NS-2D dcavity 4096² float32 on 2x2, the "
       "ragged 3x1 and 2x2 checkerboard")
def main_path_dist2d(torch):
    from pampi_tpu_torch.kernels import build as kb
    from pampi_tpu_torch.models.ns2d import NS2DSolver

    runs = dist2d_main_configs()
    single = NS2DSolver(runs[0][1].replace(tpu_mesh="1"), device="cuda")
    single.run_steps(17)
    torch.cuda.synchronize()
    counts = []
    for label, param, dims in runs:
        s = dist2d_solver(param, dims)
        s.comm.print_config()
        solve = "rb_sor_qdist" if s._rb_q is not None else "rb_sor_obsdist"
        c, r = drive_path(kb, f"NS-2D dcavity 4096² {label}",
                          (solve, "ns2d_pre", "ns2d_post"),
                          lambda: dist2d_steps(torch, s, 16))
        counts.append(c)
        if c["rb_sor_quarters"] != 0:
            raise AssertionError(f"{label}: the distributed path launched K1")
        diff, scale = field_diff(s, single)
        step = r["pre"] + r["solve"] + r["post"]
        ok = (s.nt == single.nt == 17 and s.t == single.t
              and diff <= 1e-5 * scale)
        n = s._qg.n if s._rb_q is not None else s._solve_k.n
        log(f"NS-2D dcavity 4096² f32 on {label} ({s.jl}x{s.il} shards on "
            f"{sorted(set(map(str, s.comm.devices)))}, {solve}, {n} "
            f"iterations per exchange): {r['ms']:.3f} ms/step (host clock);"
            f" PRE {r['pre']:.3f} / solve {r['solve']:.3f} / POST "
            f"{r['post']:.3f} ms (CUDA events); exchanges "
            f"{r['exchange']:.3f} ms/step, share {r['exchange'] / step:.3f} "
            f"of the step; launches per step {c[solve] / 17:.1f} {solve}, "
            f"{c['ns2d_pre'] / 17:.1f} ns2d_pre, {c['ns2d_post'] / 17:.1f} "
            f"ns2d_post; t={s.t:.6e}, single-device t={single.t:.6e}; max "
            f"|dist - single| {diff:.3e} (limit {1e-5 * scale:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"distributed dcavity {label} disagrees "
                                 f"with K1")
        del s
        torch.cuda.empty_cache()
    log(f"single-device K1 run of the same 17 steps: t={single.t:.6e}")
    return counts


@phase("several cards: distributed NS-2D dcavity 4096² on 2x2, one shard "
       "per card")
def dist2d_several_cards(torch):
    from pampi_tpu_torch.kernels import build as kb
    from pampi_tpu_torch.models.ns2d import NS2DSolver

    if torch.cuda.device_count() < 4:
        log(f"{torch.cuda.device_count()} card(s): skipped (needs four)")
        return {}
    _, param, dims = dist2d_main_configs()[0]
    s = dist2d_solver(param, dims)
    s.comm.print_config()
    c, r = drive_path(kb, "NS-2D dcavity 4096² 2x2, four cards",
                      ("rb_sor_qdist", "ns2d_pre", "ns2d_post"),
                      lambda: dist2d_steps(torch, s, 16))
    single = NS2DSolver(param.replace(tpu_mesh="1"), device="cuda")
    single.run_steps(17)
    diff, scale = field_diff(s, single)
    ok = s.nt == single.nt == 17 and s.t == single.t and diff <= 1e-5 * scale
    step = r["pre"] + r["solve"] + r["post"]
    log(f"NS-2D dcavity 4096² f32 on 2x2, one shard per card: "
        f"{r['ms']:.3f} ms/step (host clock); PRE {r['pre']:.3f} / solve "
        f"{r['solve']:.3f} / POST {r['post']:.3f} ms ({s.comm.devices[0]}'s "
        f"events); exchanges share {r['exchange'] / step:.3f}; max |dist - "
        f"single| {diff:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("four-card dcavity disagrees with one card")
    return c


# (config, te, ((mesh, its solve kernel), ...)), card against CPU:
# configs/dcavity.par's first steps run every solve to its itermax (1000),
# which takes the CPU half ~4 s a step on 2x2, so it is cut to te 0.001 (9
# steps); canal.par 200x50 on 2x2 has odd shard extents and solves on the
# grid path (no kernel)
DIST2D_CLI = (("dcavity.par", 0.001, (("2x2", "rb_sor_qdist"),
                                      ("3x3", "rb_sor_obsdist"))),
              ("canal.par", 0.5, (("2x2", None), ("3x3", "rb_sor_obsdist"),
                                  ("3x2", "rb_sor_obsdist"))))
# configs/dcavity.par on the card alone to DCAVITY_TE (te 0.05 was 400
# steps, 381140 solve iterations), held against the single-device card run of
# dcavity_card, which is held against the CPU; each mesh in a process of
# its own (cli_child): the runs are bound by the host's launches (0.45 and
# 1.27 ms an iteration on 2x2 and 3x3 on the H100, against 0.06 on one
# device), so they overlap each other and the card-vs-CPU runs
DIST2D_CARD = (("dcavity.par", DCAVITY_TE, (("2x2", "rb_sor_qdist"),
                                            ("3x3", "rb_sor_obsdist"))),)


def cli_child(par, out):
    """`chip_smoke.py --cli-child <par> <out.npz>`, started by dist2d_cli:
    the CLI on the card on `par`, with the launch counts set to 0 before
    it; saves the full-precision global fields, nt, t, the solve's label,
    the counts and the seconds to `out`."""
    import io

    import numpy as np

    sys.path.insert(0, ROOT)
    from pampi_tpu_torch import cli
    from pampi_tpu_torch.kernels import build as kb
    from pampi_tpu_torch.models.ns2d_dist import NS2DDistSolver
    from pampi_tpu_torch.utils import dispatch

    write = NS2DDistSolver.write_result
    got = {}

    def record(self, *a, **kw):
        got.update(self.global_fields(), nt=self.nt, t=self.t,
                   label=dispatch.last("ns2d_dist"))
        return write(self, *a, **kw)

    kb.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), \
            mock.patch.object(NS2DDistSolver, "write_result", record):
        rc = cli.main(["pampi_tpu_torch", "--device", "cuda", par])
    counts = {k: v.launches for k, v in kb.KERNELS.items()}
    np.savez(out, rc=rc, secs=time.perf_counter() - t0,
             counts=json.dumps(counts), **got)
    return rc


DIST2D_RUNS = {}


def dist2d_par_text(par, te, mesh):
    """configs/<par>'s text with te and tpu_mesh set."""
    import re

    text = open(os.path.join(ROOT, "configs", par)).read()
    text = re.sub(r"^te .*$", f"te {te}", text, flags=re.M)
    return re.sub(r"^tpu_mesh .*$", f"tpu_mesh {mesh}", text, flags=re.M)


@phase(f"configs/dcavity.par te {DCAVITY_TE} on 2-D meshes: the card runs "
       "started in processes of their own")
def dist2d_card_start():
    """Start DIST2D_CARD's runs (cli_child) before the card half of
    dcavity_card, so that the longest of them, bound by the host's
    launches, runs beside it and the other CLI phases."""
    tmp = tempfile.mkdtemp(prefix="dist2d_card_")
    DIST2D_RUNS["tmp"] = tmp
    children = []
    for par, te, meshes in DIST2D_CARD:
        for mesh, solve in meshes:
            d = os.path.join(tmp, f"{par}{te}{mesh}")
            os.makedirs(d)
            path = os.path.join(d, par)
            with open(path, "w") as fh:
                fh.write(dist2d_par_text(par, te, mesh))
            out = os.path.join(d, "fields.npz")
            children.append((par, te, mesh, solve, out, start(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                 "--cli-child", path, out], d,
                os.path.join(d, "child.log"))))
    DIST2D_RUNS["children"] = children


@phase("main path: python -m pampi_tpu_torch configs/dcavity.par and "
       "configs/canal.par on 2-D meshes, card and CPU, card and one device")
def dist2d_cli(np):
    import io

    from pampi_tpu_torch import cli
    from pampi_tpu_torch.kernels import build as kb
    from pampi_tpu_torch.models.ns2d_dist import NS2DDistSolver
    from pampi_tpu_torch.utils import dispatch
    from pampi_tpu_torch.utils.datio import read_pressure, read_velocity

    write = NS2DDistSolver.write_result
    counts, bad = [], []

    def run_cli(par, mesh, body, device, solve, d):
        """The CLI on `body` (a .par text) in directory d; returns the
        pressure.dat and velocity.dat arrays, (nt, t, the solve's label,
        the full-precision global fields) and the seconds taken."""
        os.makedirs(d)
        path = os.path.join(d, par)
        with open(path, "w") as fh:
            fh.write(body)
        steps = []

        def record(self, *a, **kw):
            steps.append((self.nt, self.t, dispatch.last("ns2d_dist"),
                          self.global_fields()))
            return write(self, *a, **kw)

        def run():
            with contextlib.redirect_stdout(io.StringIO()), \
                    mock.patch.object(NS2DDistSolver, "write_result",
                                      record):
                return cli.main(["pampi_tpu_torch", "--device", device,
                                 path])
        cwd = os.getcwd()
        os.chdir(d)
        t0 = time.perf_counter()
        try:
            if device == "cuda":
                c, rc = drive_path(kb, f"{par} {mesh} CLI",
                                   ("ns2d_pre", "ns2d_post")
                                   + ((solve,) if solve else ()), run)
                counts.append(c)
            else:
                rc = run()
        finally:
            os.chdir(cwd)
        if rc != 0 or len(steps) != 1:
            raise AssertionError(f"{par} {d} {device}: rc {rc}")
        return (read_pressure(os.path.join(d, "pressure.dat")),
                *read_velocity(os.path.join(d, "velocity.dat")), steps[0],
                time.perf_counter() - t0)

    if not DCAVITY_CARD:
        raise AssertionError("no single-device card run to hold the mesh "
                             "runs against")
    if "children" not in DIST2D_RUNS:
        raise AssertionError(f"the te {DCAVITY_TE} mesh runs did not start")
    children = DIST2D_RUNS["children"]
    with tempfile.TemporaryDirectory() as tmp:
        for par, te, meshes in DIST2D_CLI:
            for mesh, solve in meshes:
                body = dist2d_par_text(par, te, mesh)
                a, b = (run_cli(par, mesh, body, device, solve,
                                os.path.join(tmp, f"{par}{te}{mesh}{device}"))
                        for device in ("cuda", "cpu"))
                diff = max(float(np.abs(x - y).max())
                           for x, y in zip(a[:3], b[:3]))
                ok = (diff <= 1e-9 and a[3][0] == b[3][0]
                      and a[3][2] == b[3][2])
                log(f"{par} te {te} tpu_mesh {mesh} ({a[3][2]}): {a[3][0]} "
                    f"steps on the card ({a[4]:.1f} s), {b[3][0]} on the CPU"
                    f" ({b[4]:.1f} s); max |card - CPU| over pressure.dat "
                    f"and velocity.dat {diff:.3e} (tol 1e-9) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    bad.append(f"{par} {mesh}")
        one = DCAVITY_CARD
        for par, te, mesh, solve, out, proc in children:
            rc = proc.wait(timeout=900)
            if rc != 0:
                log(open(os.path.join(os.path.dirname(out),
                                      "child.log")).read()[-4000:])
                raise AssertionError(f"{par} {mesh} te {te}: rc {rc}")
            with np.load(out) as z:
                g = {k: z[k] for k in "uvp"}
                nt, t, label = int(z["nt"]), float(z["t"]), str(z["label"])
                c, secs = json.loads(str(z["counts"])), float(z["secs"])
            log(f"{par} te {te} {mesh} CLI launches: {json.dumps(c)}")
            missing = [k for k in ("ns2d_pre", "ns2d_post")
                       + ((solve,) if solve else ()) if c[k] == 0]
            if missing:
                raise AssertionError(f"{par} {mesh} te {te}: kernels not "
                                     f"launched: {missing}")
            counts.append(c)
            diff = max(float(np.abs(g[k] - one[k]).max()) for k in "uvp")
            scale = max(float(np.abs(one[k]).max()) for k in "uvp")
            ok = diff <= 1e-9 * scale and (nt, t) == (one["nt"], one["t"])
            log(f"{par} te {te} tpu_mesh {mesh} ({label}) on the card, its "
                f"own process: {nt} steps in {secs:.1f} s (one device: "
                f"{one['nt']}), t equal {t == one['t']}; max |mesh - one "
                f"device| over u, v, p {diff:.3e} (tol 1e-9 of scale "
                f"{scale:.3e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"{par} {mesh} te {te}")
    if bad:
        raise AssertionError(f"runs disagree: {bad}")
    return counts


@phase("kernels at n = 1, the float64 cadence: K1, K2, K5, K6, K13, K14")
def check_cadence_one(torch, np):
    """The float64 solves now run one iteration a call (utils/dispatch.
    sor_cadence); every SOR kernel against its plain version at n = 1."""
    from pampi_tpu_torch.ops import sor3d_kernels as sk3
    from pampi_tpu_torch.ops import sor_kernels as sk
    from pampi_tpu_torch.ops.sor3d import sor_coefficients_3d
    from pampi_tpu_torch.ops.sor_octants import stack_octants
    from pampi_tpu_torch.ops.sor_quarters import stack_quarters

    bad = []
    f64 = torch.float64
    coef = sk.sor_coefficients(1 / 256, 1 / 256, 1.8)
    p, f = rng_fields(torch, np, (258, 258), f64, 2, 201)
    pairs = [("rb_sor_checkerboard", sk.rb_sor_checkerboard,
              sk.rb_sor_checkerboard_plain, p, f, coef),
             ("rb_sor_quarters", sk.rb_sor_quarters, sk.rb_sor_quarters_plain,
              stack_quarters(p), stack_quarters(f), coef)]
    coef3 = sor_coefficients_3d(1 / 32, 1 / 32, 1 / 32, 1.8)
    p3, f3 = rng_fields(torch, np, (34, 34, 34), f64, 2, 203)
    pairs += [("rb_sor3d_checkerboard", sk3.rb_sor3d_checkerboard,
               sk3.rb_sor3d_checkerboard_plain, p3, f3, coef3),
              ("rb_sor3d_octants", sk3.rb_sor3d_octants,
               sk3.rb_sor3d_octants_plain, stack_octants(p3),
               stack_octants(f3), coef3)]
    for name, kern, plain, x, rhs, c in pairs:
        xk, xp = x.clone(), x.clone()
        rk, rp = kern(xk, rhs, 1, *c), plain(xp, rhs, 1, *c)
        ok = (torch.equal(xk, xp)
              and abs(float(rk) - float(rp)) <= 1e-12 * abs(float(rp)))
        if name == "rb_sor_quarters":
            ok = ok and torch.equal(rk, rp)
        log(f"{name} f64 n=1: field bitwise {torch.equal(xk, xp)}, "
            f"residual {float(rk):.6e} / {float(rp):.6e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(name)
    g, qoffs = qdist_shards(256, 256, (2, 2), 1)
    fb, rb, _ = check_qdist(torch, np, g, qoffs, f64, 205)
    log(f"rb_sor_qdist f64 n={g.n}, 256² on 2x2: planes bitwise {fb}, "
        f"residuals bitwise {rb}")
    if not (fb and rb):
        bad.append("rb_sor_qdist")
    g, offs = odist_shards((32, 32, 32), (2, 2, 2), 1)
    bitwise, rbit, _ = check_odist(torch, np, g, offs, f64, 207)
    log(f"rb_sor_odist f64 n={g.n}, 32³ on 2x2x2: volumes bitwise {bitwise},"
        f" residuals bitwise {rbit}")
    if not (bitwise and rbit):
        bad.append("rb_sor_odist")
    if bad:
        raise AssertionError(f"kernels at n = 1 disagree: {bad}")


# ---------------------------------------------------------------------------
# The 3-D obstacle slice: K16, the masked mode of K5, the flag mode of K7/K8
# ---------------------------------------------------------------------------

OBST_MAIN = dict(imax=512, jmax=128, kmax=128)  # the main path's grid
OBST_K16 = dict(imax=1024, jmax=256, kmax=256)  # K16's timed shard's grid


def obstacle_config(**kw):
    """configs/canal3d_obstacle.par with the given keys replaced (its box
    stays where it is in physical coordinates)."""
    return config("canal3d_obstacle.par", **kw)


def obstacle_fluid(param):
    """The boolean fluid field of param's grid and obstacles."""
    from pampi_tpu_torch.ops import obstacle3d as o3

    return o3.build_fluid_3d(param.imax, param.jmax, param.kmax,
                             param.xlength / param.imax,
                             param.ylength / param.jmax,
                             param.zlength / param.kmax, param.obstacles)


def shard_flags(fluid, offs, local, H):
    """A shard's (l + 2H)-extent block of the flags as uint8 on the card:
    the global field padded with H-1 dead cells per side (and on the HI
    sides by a ragged shard's overhang past the grid), cut at the shard's
    offsets (ops/obstacle3d.deep_flag_block_3d's slice)."""
    import numpy as np
    import torch

    over = [max(0, o + n + 2 - g) for o, n, g in zip(offs, local,
                                                     fluid.shape)]
    wide = np.pad(fluid.astype(np.uint8), [(H - 1, H - 1 + e) for e in over])
    blk = wide[tuple(slice(o, o + n + 2 * H) for o, n in zip(offs, local))]
    return torch.from_numpy(np.ascontiguousarray(blk)).to("cuda")


def inverse_squares(param):
    """(idx2, idy2, idz2) of param's grid."""
    return tuple(1.0 / (d * d) for d in (param.xlength / param.imax,
                                         param.ylength / param.jmax,
                                         param.zlength / param.kmax))


def check_masked_k5(torch, np, param, flags, dtype, n, seed, calls=2):
    """Masked K5 and its plain version on copies of random p, rhs, `calls`
    calls each in the solver's form (each call reads one field and writes
    the other of a pair, and the two swap). Returns (fields bitwise,
    residuals bitwise, max_abs_err)."""
    from pampi_tpu_torch.ops import sor3d_kernels as sk3

    c = inverse_squares(param)
    x, f = rng_fields(torch, np, tuple(flags.shape), dtype, 2, seed)
    xk, xp = [x.clone(), torch.empty_like(x)], x.clone()
    for _ in range(calls):
        rk = sk3.rb_sor3d_checkerboard(xk[0], f, n, 0.0, *c, flags=flags,
                                       omega=param.omg, out=xk[1])
        xk.reverse()
        rp = sk3.rb_sor3d_masked_plain(xp, f, flags, n, param.omg, *c)
    return (torch.equal(xk[0], xp), torch.equal(rk, rp),
            float((xk[0] - xp).abs().max()))


def check_k16(torch, np, param, fluid, offs, local, n, dtype, seed,
              calls=2):
    """K16 and its plain version on copies of a random deep block at the
    shard offsets offs, `calls` calls each. Returns (blocks bitwise,
    residuals bitwise, max_abs_err, the geometry)."""
    from pampi_tpu_torch.ops import sor_obsdist3d as sod3

    g = sod3.ObsGeom3(param.kmax, param.jmax, param.imax, *local, n)
    flags = shard_flags(fluid, offs, local, g.H)
    c = inverse_squares(param)
    x, f = rng_fields(torch, np, g.shape, dtype, 2, seed)
    xk, xp = x.clone(), x.clone()
    for _ in range(calls):
        rk = sod3.rb_sor_obsdist3d(xk, f, flags, g, offs, param.omg, *c)
        rp = sod3.rb_iters_obsdist3d_plain(xp, f, flags, g, offs, param.omg,
                                           *c)
    return (torch.equal(xk, xp), torch.equal(rk, rp),
            float((xk - xp).abs().max()), g)


def check_obsdist3d(torch, np, solve, param, dtype, seed, calls=2):
    """K16 and its plain version on copies of random deep blocks of every
    shard of a solver's K16 solve (its geometry, flags and offsets),
    `calls` calls each. Returns (blocks bitwise, residuals bitwise,
    max_abs_err)."""
    from pampi_tpu_torch.ops import sor_obsdist3d as sod3

    g, c = solve.geom, inverse_squares(param)
    bitwise = rbits = True
    err = 0.0
    for k, (fl, offs) in enumerate(zip(solve.flags, solve.offs)):
        x, f = rng_fields(torch, np, g.shape, dtype, 2, seed + k)
        xk, xp = x.clone(), x.clone()
        for _ in range(calls):
            rk = sod3.rb_sor_obsdist3d(xk, f, fl, g, offs, param.omg, *c)
            rp = sod3.rb_iters_obsdist3d_plain(xp, f, fl, g, offs,
                                               param.omg, *c)
        bitwise = bitwise and torch.equal(xk, xp)
        rbits = rbits and torch.equal(rk, rp)
        err = max(err, float((xk - xp).abs().max()))
    return bitwise, rbits, err


def deep_read_cells(glob, local, offs, H):
    """The cells of a deep block that the per-shard flag-masked kernels
    (K15, K16) read: the owned cells, H layers on each side that faces
    another shard and the one global ghost layer on each wall side (the
    dead padding beyond a wall's ghost layer, and a ragged shard's
    overhang beyond the global grid, are neither loaded nor written)."""
    cells = 1
    for G, n, o in zip(glob, local, offs):
        own = min(n, G - o)
        cells *= own + (1 if o == 0 else H) + (1 if o + own == G else H)
    return cells


def k15_read_cells(g, offs):
    """deep_read_cells of K15's 2-D geometry g at offsets offs."""
    return deep_read_cells((g.jmax, g.imax), (g.jl, g.il), offs, g.H)


def k16_read_cells(g, offs):
    """deep_read_cells of K16's 3-D geometry g at offsets offs."""
    return deep_read_cells((g.kmax, g.jmax, g.imax), (g.kl, g.jl, g.il),
                           offs, g.H)


@phase("obstacle kernels vs plain versions: masked K5, K16, K7/K8 in flag "
       "mode")
def check_obstacle3d_kernels(torch, np):
    from pampi_tpu_torch.ops import sor3d_kernels as sk3
    from pampi_tpu_torch.ops import sor_obsdist3d as sod3
    from pampi_tpu_torch.ops.ns3d_fused import StepConfig3D
    from pampi_tpu_torch.parallel.stencil2d import embed_deep, strip_deep
    from pampi_tpu_torch.utils.params import Parameter

    bad = []
    dtypes = (torch.float32, torch.float64)
    shipped = obstacle_config()  # 128x32x32
    odd = Parameter(name="dcavity3d", imax=63, jmax=47, kmax=31, re=100.0,
                    obstacles="0.3,0.2,0.35,0.7,0.6,0.75")
    # masked K5 alone: a field of several (j, i) tiles and k slabs, tiles
    # cut at every face, and one smaller than a tile
    tiled = Parameter(name="dcavity3d", imax=90, jmax=300, kmax=40,
                      re=100.0, obstacles="0.3,0.2,0.35,0.7,0.6,0.75")
    small = Parameter(name="dcavity3d", imax=16, jmax=12, kmax=10,
                      re=100.0, obstacles="0.3,0.2,0.3,0.7,0.6,0.7")
    grids = [(p, obstacle_fluid(p)) for p in (shipped, odd)]
    for param, fluid in grids + [(p, obstacle_fluid(p))
                                 for p in (tiled, small)]:
        flags = torch.from_numpy(fluid.astype(np.uint8)).to("cuda")
        shape = f"{param.imax}x{param.jmax}x{param.kmax}"
        for dtype in dtypes:
            for n in (1, 2, 3, 4):
                fb, rb, err = check_masked_k5(torch, np, param, flags, dtype,
                                              n, 151)
                log(f"rb_sor3d_checkerboard masked {dtype} {shape} n={n}, "
                    f"two calls: fields bitwise {fb}, residual bitwise {rb}"
                    f", max_abs_err {err:.3e} {'ok' if fb and rb else 'FAIL'}")
                if not (fb and rb):
                    bad.append(f"masked K5 {shape} {dtype} n={n}")
    for param, fluid in grids:
        flags = torch.from_numpy(fluid.astype(np.uint8)).to("cuda")
        shape = f"{param.imax}x{param.jmax}x{param.kmax}"
        for dtype in dtypes:
            t = tol(torch, dtype)
            u, v, w, pp = rng_fields(torch, np, tuple(flags.shape), dtype, 4,
                                     157)
            dt = torch.tensor(0.013, dtype=dtype, device="cuda")
            copies, e_pre, e_post, own, em, _a, _b, ok = check_step3d(
                torch, u, v, w, pp, dt, StepConfig3D.from_param(param), t,
                flags)
            log(f"ns3d_pre/post flag mode {param.name} {dtype} {shape}: u',"
                f" v', w' bitwise {copies}, F/G/H/rhs max_rel_err "
                f"{e_pre:.3e}, u'', v'', w'' max_rel_err {e_post:.3e}, "
                f"maxima bitwise vs own fields {own}, vs plain {em:.3e} "
                f"(tol {t:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"K7/K8 flag mode {shape} {dtype}")
    # K16 on every shard of the shipped grid on 2x2x2, and on 1x1x1
    # against masked K5
    param, fluid = grids[0]
    dims = (2, 2, 2)
    G = (param.kmax, param.jmax, param.imax)
    local = tuple(e // d for e, d in zip(G, dims))
    for dtype in dtypes:
        for n in (1, 2):
            fb = rb = True
            err = 0.0
            for s in range(8):
                offs = tuple(c * e for c, e in zip(mesh_coords(s, dims),
                                                   local))
                b1, r1, e1, g = check_k16(torch, np, param, fluid, offs,
                                          local, n, dtype, 161 + s)
                fb, rb, err = fb and b1, rb and r1, max(err, e1)
            log(f"rb_sor_obsdist3d {dtype} 128x32x32 on 2x2x2 (n={n}, deep "
                f"blocks {g.shape}), every shard, two calls: blocks bitwise "
                f"{fb}, residuals bitwise {rb}, max_abs_err {err:.3e} "
                f"{'ok' if fb and rb else 'FAIL'}")
            if not (fb and rb):
                bad.append(f"K16 2x2x2 {dtype} n={n}")
        g = sod3.ObsGeom3(*G, *G, 2)
        flags16 = shard_flags(fluid, (0, 0, 0), G, g.H)
        flags5 = torch.from_numpy(fluid.astype(np.uint8)).to("cuda")
        c = inverse_squares(param)
        x, f = rng_fields(torch, np, tuple(flags5.shape), dtype, 2, 171)
        x5, xd = [x.clone(), torch.empty_like(x)], embed_deep(x, g.H)
        xd, fd = xd.contiguous(), embed_deep(f, g.H).contiguous()
        for _ in range(2):
            r16 = sod3.rb_sor_obsdist3d(xd, fd, flags16, g, (0, 0, 0),
                                        param.omg, *c)
            r5 = sk3.rb_sor3d_checkerboard(x5[0], f, g.n, 0.0, *c,
                                           flags=flags5, omega=param.omg,
                                           out=x5[1])
            x5.reverse()
        ok = torch.equal(strip_deep(xd, g.H), x5[0]) and torch.equal(r16, r5)
        log(f"rb_sor_obsdist3d {dtype} 128x32x32 on 1x1x1 (n=2) vs masked "
            f"K5, two calls: volume and residual bitwise {ok}")
        if not ok:
            bad.append(f"K16 vs masked K5 {dtype}")
        t = tol(torch, dtype)
        exact, e, err = check_step3d_dist(torch, np, dims, param, dtype, 181)
        ok = exact and e <= t
        log(f"ns3d_pre/post distributed flag mode {dtype} 128x32x32 on 2x2x2,"
            f" every shard: u', v', w' and maxima bitwise {exact}, "
            f"max_rel_err {e:.3e}, max_abs_err {err:.3e} (tol {t:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"K7/K8 distributed flag mode {dtype}")
    if bad:
        raise AssertionError(f"obstacle kernels disagree: {bad}")


@phase("masked K5, K16 and K7/K8 in flag mode: times, float32")
def time_obstacle3d(torch, np):
    from pampi_tpu_torch.ops import ns3d_fused as nf3
    from pampi_tpu_torch.ops import sor3d_kernels as sk3

    size, rows = 4, {}
    param = obstacle_config(**OBST_MAIN)
    fluid = obstacle_fluid(param)
    flags = torch.from_numpy(fluid.astype(np.uint8)).to("cuda")
    cells = flags.numel()
    K, J, I = (n - 2 for n in flags.shape)
    shape = f"{I}x{J}x{K}"
    c = inverse_squares(param)
    bad = []
    for dtype in (torch.float32, torch.float64):
        for n in (1, 2, 3, 4):
            fb, rb, e = check_masked_k5(torch, np, param, flags, dtype, n,
                                        191, calls=1)
            if dtype == torch.float32 and n == 4:
                err = e
            log(f"rb_sor3d_checkerboard masked {dtype} {shape} n={n} vs "
                f"plain: field bitwise {fb}, residual bitwise {rb} "
                f"{'ok' if fb and rb else 'FAIL'}")
            if not (fb and rb):
                bad.append(f"{dtype} n={n}")
    if bad:
        raise AssertionError(f"masked K5 differs from its plain version at "
                             f"{shape}: {bad}")
    x, f, y = rng_fields(torch, np, tuple(flags.shape), torch.float32, 3,
                         193)

    def masked():
        return sk3.rb_sor3d_checkerboard(x, f, 4, 0.0, *c, flags=flags,
                                         omega=param.omg, out=y)

    ms = cuda_ms(torch, masked, 20)
    pms = cuda_ms(torch, lambda: sk3.rb_sor3d_masked_plain(
        x, f, flags, 4, param.omg, *c), 2)
    calls = cuda_launches(torch, masked)
    # p and rhs read, p written, the flags read once: 13 bytes a cell;
    # ~33 flops a cell update
    b = bound(13 * cells, 33 * 4 * K * J * I)
    rows["rb_sor3d_checkerboard_masked"] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
        cuda_launches_a_call=calls,
        shape=f"{shape} f32, n=4, the box of canal3d_obstacle.par")
    log(f"rb_sor3d_checkerboard masked {shape} f32 n=4: {ms:.4f} ms per call"
        f" (plain {pms:.4f}, bound {b[0]:.4f} by {b[1]}), "
        f"{launches_text(calls)} CUDA launches a call")
    del x, f, y
    # K7/K8 in flag mode on the same grid
    pk = obstacle_config(**OBST_MAIN, tpu_dtype="float32")
    cfg = nf3.StepConfig3D.from_param(pk)
    u, v, w, pp = rng_fields(torch, np, tuple(flags.shape), torch.float32, 4,
                             197)
    dt = torch.tensor(1e-3, dtype=torch.float32, device="cuda")
    copies, e_pre, e_post, own, em, err_pre, err_post, ok = check_step3d(
        torch, u, v, w, pp, dt, cfg, tol(torch, torch.float32), flags)
    if not ok:
        raise AssertionError(f"K7/K8 flag mode differ from their plain "
                             f"versions at {shape}")
    uk, vk, wk = u.clone(), v.clone(), w.clone()
    ms = cuda_ms(torch, lambda: nf3.ns3d_pre(uk, vk, wk, dt, cfg,
                                             flags=flags), 20)
    pms = cuda_ms(torch, lambda: nf3.ns3d_pre_plain(u, v, w, dt, cfg,
                                                    flags=flags), 3)
    fk = nf3.ns3d_pre(uk, vk, wk, dt, cfg, flags=flags)
    qms = cuda_ms(torch, lambda: nf3.ns3d_post(
        uk, vk, wk, *fk[:3], pp, dt, cfg.dx, cfg.dy, cfg.dz, flags=flags), 20)
    qpms = cuda_ms(torch, lambda: nf3.ns3d_post_plain(
        uk, vk, wk, *fk[:3], pp, dt, cfg.dx, cfg.dy, cfg.dz, flags=flags), 3)
    # 7 field-sizes each, as without flags, plus the flags' byte a cell
    b = bound((7 * size + 1) * cells, 200 * K * J * I)
    q = bound((7 * size + 1) * cells, 20 * K * J * I)
    calls = cuda_launches(torch, lambda: nf3.ns3d_pre(uk, vk, wk, dt, cfg,
                                                      flags=flags))
    rows["ns3d_pre_flags"] = dict(
        max_abs_err=err_pre, ms=ms, plain_ms=pms, bound_ms=b[0],
        bound_by=b[1], cuda_launches_a_call=calls,
        shape=f"{shape} f32, canal3d_obstacle.par's BCs")
    rows["ns3d_post_flags"] = dict(
        max_abs_err=err_post, ms=qms, plain_ms=qpms, bound_ms=q[0],
        bound_by=q[1], shape=f"{shape} f32, canal3d_obstacle.par's BCs")
    log(f"ns3d_pre flag mode {shape} f32: {ms:.4f} ms (plain {pms:.4f}, "
        f"bound {b[0]:.4f} by {b[1]}), {launches_text(calls)} CUDA launches "
        f"a call, F/G/H/rhs bitwise the plain version's {e_pre == 0.0}; "
        f"ns3d_post flag mode: {qms:.4f} ms "
        f"(plain {qpms:.4f}, bound {q[0]:.4f} by {q[1]})")
    del u, v, w, pp, uk, vk, wk, fk, flags
    torch.cuda.empty_cache()
    # K16 per (128, 128, 512) shard of 1024x256x256 on 2x2x2, n = 4: only
    # that shard's blocks on the card
    big = obstacle_config(**OBST_K16)
    fluid = obstacle_fluid(big)
    local = (big.kmax // 2, big.jmax // 2, big.imax // 2)
    offs = local  # the shard at mesh coordinates (1, 1, 1)
    fb, rb, err, g = check_k16(torch, np, big, fluid, offs, local, 4,
                               torch.float32, 199, calls=1)
    if not (fb and rb):
        raise AssertionError("K16 differs from its plain version at the "
                             "timed shard")
    flags = shard_flags(fluid, offs, local, g.H)
    c = inverse_squares(big)
    solve = SimpleNamespace(geom=g, flags=[flags], offs=[offs])
    blocks = [rng_fields(torch, np, g.shape, torch.float32, 2, 201)]
    ms, pms, calls = time_obsdist_shards(torch, solve, blocks,
                                         (big.omg, *c))
    # p, rhs and the flags of the cells K16 reads: at mesh coordinates
    # (1, 1, 1) H layers on the three interface sides, the ghost layer on
    # the three wall sides
    read = k16_read_cells(g, offs)
    b = bound(13 * read, 33 * 4 * local[0] * local[1] * local[2])
    rows["rb_sor_obsdist3d"] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
        cuda_launches_a_call=calls,
        shape=f"(128, 128, 512) shard of 1024x256x256 f32 on 2x2x2, n=4, "
              f"deep block {g.shape}, {read} cells read")
    log(f"rb_sor_obsdist3d per (128, 128, 512) shard of 1024x256x256 f32 on "
        f"2x2x2, n=4 (deep block {g.shape}, {read} cells read): {ms:.4f} ms"
        f" per shard call (plain {pms:.4f}, bound {b[0]:.4f} by {b[1]}), "
        f"{launches_text(calls)} CUDA launches a call")
    del blocks, flags, solve
    torch.cuda.empty_cache()
    return rows


# the one-device SOR obstacle steps of this run (main_path_obstacle2d/3d),
# printed beside the obstacle multigrid's
OBST_SOR_STEP = {}
OBST_PATH = ("ns3d_pre_flags", "ns3d_post_flags")
NOT_ON_OBSTACLE_PATHS = ("rb_sor3d_octants", "rb_sor3d_octants_onchip",
                         "rb_sor_odist", "rb_sor3d_checkerboard", "ns3d_pre",
                         "ns3d_post")


def check_not_launched(counts, label):
    """K6 and K14 (and the unmasked K5, K7, K8) never run on an obstacle
    path."""
    wrong = [k for k in NOT_ON_OBSTACLE_PATHS if counts.get(k, 0)]
    if wrong:
        raise AssertionError(f"{label} launched {wrong}")


@phase("main path: NS-3D with obstacles, canal3d_obstacle.par's geometry "
       "at 512x128x128 float32, one device and 2x2x2")
def main_path_obstacle3d(torch):
    import numpy as np

    from pampi_tpu_torch.kernels import build as kb
    from pampi_tpu_torch.models.ns3d import NS3DSolver
    from pampi_tpu_torch.models.ns3d_dist import NS3DDistSolver
    from pampi_tpu_torch.parallel.comm import CartComm

    param = obstacle_config(**OBST_MAIN, tpu_dtype="float32", re=100.0,
                            tpu_sor_inner=4, itermax=100, eps=0.0, te=1e9)
    counts = []
    single = NS3DSolver(param.replace(tpu_mesh="1"), device="cuda")
    c, r = drive_path(kb, "NS-3D obstacle one device",
                      ("rb_sor3d_checkerboard_masked",) + OBST_PATH,
                      lambda: timed_steps(torch, single, 16))
    check_not_launched(c, "the one-device obstacle path")
    counts.append(c)
    OBST_SOR_STEP["3d"] = r
    log(f"NS-3D canal3d_obstacle 512x128x128 f32 one device (re 100, "
        f"itermax 100, eps 0, masked K5 n=4): {r['ms_per_step']:.3f} ms/step"
        f" (host clock); PRE {r['pre']:.3f} / solve {r['solve']:.3f} / POST "
        f"{r['post']:.3f} ms (CUDA events); launches per step "
        f"{c['rb_sor3d_checkerboard_masked'] / 17:.1f} masked K5")
    s = NS3DDistSolver(param.replace(tpu_mesh="2x2x2"),
                       CartComm(ndims=3, dims=(2, 2, 2)))
    s.comm.print_config()
    c, r = drive_path(kb, "NS-3D obstacle 2x2x2",
                      ("rb_sor_obsdist3d",) + OBST_PATH,
                      lambda: dist2d_steps(torch, s, 16))
    check_not_launched(c, "the 2x2x2 obstacle path")
    counts.append(c)
    diff, scale = global_diff(s, single)
    step = r["pre"] + r["solve"] + r["post"]
    ok = (s.nt == single.nt == 17 and s.t == single.t
          and diff <= 1e-5 * scale)
    log(f"NS-3D canal3d_obstacle 512x128x128 f32 on 2x2x2 ({s.kl}x{s.jl}x"
        f"{s.il} shards on {sorted(set(map(str, s.comm.devices)))}, K16 n="
        f"{s._obs_solve.n}): {r['ms']:.3f} ms/step (host clock); PRE "
        f"{r['pre']:.3f} / solve {r['solve']:.3f} / POST {r['post']:.3f} ms "
        f"(CUDA events); exchanges {r['exchange']:.3f} ms/step, share "
        f"{r['exchange'] / step:.3f} of the step; launches per step "
        f"{c['rb_sor_obsdist3d'] / 17:.1f} K16; t={s.t:.6e}, single-device "
        f"t={single.t:.6e}; max |dist - single| {diff:.3e} (limit "
        f"{1e-5 * scale:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the 2x2x2 obstacle run disagrees with one "
                             "device")
    # the kernels of the mesh path against their plain versions at this
    # path's own shapes: K16 on the solve's deep blocks, flags and offsets,
    # K7/K8 in distributed flag mode on its shards
    g = s._obs_solve.geom
    fb, rb, err = check_obsdist3d(torch, np, s._obs_solve, param,
                                  torch.float32, 211)
    log(f"rb_sor_obsdist3d f32 on the 2x2x2 path's own shards (n={g.n}, "
        f"deep blocks {g.shape}), every shard, two calls: blocks bitwise "
        f"{fb}, residuals bitwise {rb}, max_abs_err {err:.3e} "
        f"{'ok' if fb and rb else 'FAIL'}")
    t = tol(torch, torch.float32)
    exact, e, err = check_step3d_dist(torch, np, (2, 2, 2), param,
                                      torch.float32, 221)
    ok = exact and e <= t
    log(f"ns3d_pre/post distributed flag mode f32 on the 2x2x2 path's own "
        f"shards ({s.kl}x{s.jl}x{s.il}), every shard: u', v', w' and maxima"
        f" bitwise {exact}, max_rel_err {e:.3e}, max_abs_err {err:.3e} (tol"
        f" {t:g}) {'ok' if ok else 'FAIL'}")
    if not (fb and rb and ok):
        raise AssertionError("a kernel of the 2x2x2 obstacle path differs "
                             "from its plain version at the path's shapes")
    del s, single
    torch.cuda.empty_cache()
    return counts


def run_cli_ns(par, device, ndim):
    """The CLI on an NS-2D (ndim 2) or NS-3D (ndim 3) .par in the current
    directory, with the launch counts set to 0 before it: (rc, seconds,
    counts, what the run wrote: the fields at full precision (NS-3D the
    cell-centred ug, vg, wg, pg; NS-2D the global u, v, p), nt, t, the
    dispatch record)."""
    import io

    from pampi_tpu_torch import cli
    from pampi_tpu_torch.kernels import build as kb
    from pampi_tpu_torch.utils import dispatch

    if ndim == 3:
        from pampi_tpu_torch.models.ns3d import NS3DSolver as One
        from pampi_tpu_torch.models.ns3d_dist import NS3DDistSolver as Dist

        def fields(s):
            return dict(zip(("ug", "vg", "wg", "pg"), s.collect()))
    else:
        from pampi_tpu_torch.models.ns2d import NS2DSolver as One
        from pampi_tpu_torch.models.ns2d_dist import NS2DDistSolver as Dist

        def fields(s):
            if isinstance(s, Dist):
                return s.global_fields()
            return {k: getattr(s, k).cpu().numpy() for k in "uvp"}

    got = {}

    def recorder(cls):
        write = cls.write_result

        def record(self, *a, **kw):
            got.update(fields(self), nt=self.nt, t=self.t,
                       record=json.dumps(dispatch.snapshot()))
            return write(self, *a, **kw)

        return mock.patch.object(cls, "write_result", record)

    kb.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()), recorder(One), \
            recorder(Dist):
        rc = cli.main(["pampi_tpu_torch", "--device", device, par])
    secs = time.perf_counter() - t0
    return rc, secs, {k: v.launches for k, v in kb.KERNELS.items()}, got


def cli_ns_child(ndim, par, out, device):
    """`chip_smoke.py --cli3-child|--cli2-child <par> <out.npz> <device>`:
    run_cli_ns in the .par's directory, saved to out."""
    import numpy as np

    sys.path.insert(0, ROOT)
    os.chdir(os.path.dirname(os.path.abspath(par)))
    rc, secs, counts, got = run_cli_ns(par, device, ndim)
    np.savez(out, rc=rc, secs=secs, counts=json.dumps(counts), **got)
    return rc


OBST_RUNS = {}


def config_text(name, **keys):
    """configs/<name>'s text with the given keys set (a key the file lacks
    is appended)."""
    import re

    text = open(os.path.join(ROOT, "configs", name)).read()
    for key, val in keys.items():
        text, n = re.subn(rf"^{key}\s.*$", f"{key} {val}", text, flags=re.M)
        if n == 0:
            text += f"\n{key} {val}\n"
    return text


def obstacle_par(te, **keys):
    """configs/canal3d_obstacle.par's text with te and the given keys
    set."""
    return config_text("canal3d_obstacle.par", te=te, **keys)


@phase("configs/canal3d_obstacle.par: the 2x2x2 card run and the CPU run "
       "started in processes of their own")
def obstacle3d_cli_start():
    tmp = tempfile.mkdtemp(prefix="obstacle3d_")
    OBST_RUNS["tmp"] = tmp
    env = dict(os.environ, OMP_NUM_THREADS="2")
    for name, text, device in (
            ("mesh", obstacle_par(5.0, tpu_mesh="2x2x2"), "cuda"),
            ("cpu05", obstacle_par(0.5, tpu_vtk="binary"), "cpu")):
        d = os.path.join(tmp, name)
        os.makedirs(d)
        par = os.path.join(d, "canal3d_obstacle.par")
        with open(par, "w") as fh:
            fh.write(text)
        out = os.path.join(d, "fields.npz")
        OBST_RUNS[name] = (out, start(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--cli3-child", par, out, device], d,
            os.path.join(d, "child.log"), env))


def vtk_fields(np, path, n):
    """The pressure and velocity arrays of a binary float64 VTK file."""
    data = open(path, "rb").read()
    head = data.index(b"LOOKUP_TABLE default\n") + 21
    vhead = data.index(b"VECTORS velocity double\n") + 24
    return (np.frombuffer(data[head:head + 8 * n], ">f8"),
            np.frombuffer(data[vhead:vhead + 24 * n], ">f8"))


@phase("main path: python -m pampi_tpu_torch configs/canal3d_obstacle.par "
       "on the card, one device and 2x2x2, and at te 0.5 against the CPU")
def obstacle3d_cli(np):
    from pampi_tpu_torch.kernels import build as kb

    if "mesh" not in OBST_RUNS:
        raise AssertionError("the child runs did not start")
    tmp = OBST_RUNS["tmp"]
    counts, one = [], {}
    for name, text in (("one", obstacle_par(5.0)),
                       ("card05", obstacle_par(0.5, tpu_vtk="binary"))):
        d = os.path.join(tmp, name)
        os.makedirs(d)
        par = os.path.join(d, "canal3d_obstacle.par")
        with open(par, "w") as fh:
            fh.write(text)
        cwd = os.getcwd()
        os.chdir(d)
        try:
            c, (rc, secs, _c, got) = drive_path(
                kb, f"canal3d_obstacle.par {name} CLI",
                ("rb_sor3d_checkerboard_masked",) + OBST_PATH,
                lambda: run_cli_ns(par, "cuda", 3))
        finally:
            os.chdir(cwd)
        check_not_launched(c, f"the {name} CLI run")
        counts.append(c)
        if rc != 0:
            raise AssertionError(f"the {name} CLI run exited {rc}")
        one[name] = got
        log(f"canal3d_obstacle.par {'as shipped (te 5.0)' if name == 'one' else 'te 0.5, tpu_vtk binary'}"
            f" on one card: {got['nt']} steps to t={got['t']:.6f} in "
            f"{secs:.1f} s (wall, the CLI's whole run, beside the other "
            f"processes)")
    bad = []
    results = {}
    for name in ("cpu05", "mesh"):
        out, proc = OBST_RUNS[name]
        rc = proc.wait(timeout=900)
        if rc != 0:
            log(open(os.path.join(os.path.dirname(out),
                                  "child.log")).read()[-4000:])
            raise AssertionError(f"the {name} child exited {rc}")
        with np.load(out) as z:
            results[name] = {k: z[k] for k in z.files}
    # te 0.5: the card's and the CPU's VTK files
    cpu = results["cpu05"]
    n = 128 * 32 * 32
    a = vtk_fields(np, os.path.join(tmp, "card05", "canal.vtk"), n)
    b = vtk_fields(np, os.path.join(tmp, "cpu05", "canal.vtk"), n)
    diff = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
    scale = max(1.0, *(float(np.abs(y).max()) for y in b))
    ok = diff <= 1e-9 * scale and int(cpu["nt"]) == one["card05"]["nt"]
    log(f"canal3d_obstacle.par te 0.5 f64: {one['card05']['nt']} steps on "
        f"the card, {int(cpu['nt'])} on the CPU ({float(cpu['secs']):.1f} s "
        f"in its own process); max |card - CPU| over the VTK fields "
        f"{diff:.3e} (tol 1e-9 of scale {scale:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        bad.append("te 0.5 card vs CPU")
    mesh, ref = results["mesh"], one["one"]
    c = json.loads(str(mesh["counts"]))
    log(f"canal3d_obstacle.par 2x2x2 CLI launches: {json.dumps(c)}")
    missing = [k for k in ("rb_sor_obsdist3d",) + OBST_PATH if c[k] == 0]
    if missing:
        raise AssertionError(f"the 2x2x2 CLI run did not launch {missing}")
    check_not_launched(c, "the 2x2x2 CLI run")
    counts.append(c)
    diff = max(float(np.abs(mesh[k] - ref[k]).max())
               for k in ("ug", "vg", "wg", "pg"))
    scale = max(1.0, *(float(np.abs(ref[k]).max())
                       for k in ("ug", "vg", "wg", "pg")))
    same = (int(mesh["nt"]), float(mesh["t"])) == (ref["nt"], ref["t"])
    label = json.loads(str(mesh["record"])).get("obstacle3d_dist")
    ok = same and diff <= 1e-9 * scale
    log(f"canal3d_obstacle.par te 5.0 tpu_mesh 2x2x2 ({label}) on the card, "
        f"its own process: {int(mesh['nt'])} steps in "
        f"{float(mesh['secs']):.1f} s (one device: {ref['nt']}), t equal "
        f"{float(mesh['t']) == ref['t']}; max |mesh - one device| over the "
        f"cell-centred u, v, w, p {diff:.3e} (tol 1e-9 of scale "
        f"{scale:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        bad.append("te 5.0 2x2x2 vs one device")
    if bad:
        raise AssertionError(f"canal3d_obstacle.par runs disagree: {bad}")
    return counts


# ---------------------------------------------------------------------------
# The 2-D obstacle slice: the masked mode of K2, K17 (B.5), the flag mode of
# K3/K4 on one device and on a mesh, K15 on real flags
# ---------------------------------------------------------------------------

OBST2_MAIN = (2048, 8192)  # the main path's grid (jmax, imax): box 512x512
OBST2_CHECK = ((256, 1024), (257, 1023))
K17_MAIN = (4096, 4096)
K17_CHECK = ((1024, 1024), (1021, 1023))
OBST2_PATH = ("ns2d_pre_flags", "ns2d_post_flags")
NOT_ON_OBSTACLE2D_PATHS = ("rb_sor_quarters", "rb_sor_checkerboard",
                           "rb_sor_qdist", "ns2d_pre", "ns2d_post")


def obstacle2d_config(jmax, imax, **kw):
    """configs/canal_obstacle.par on a jmax x imax grid (its box stays
    where it is in physical coordinates)."""
    return config("canal_obstacle.par", imax=imax, jmax=jmax, **kw)


def obstacle2d_flags(param):
    """The uint8 fluid flags of param's grid and box, on the card."""
    from pampi_tpu_torch.ops import obstacle as obst

    dx, dy = param.xlength / param.imax, param.ylength / param.jmax
    return obst.make_masks(
        obst.build_fluid(param.imax, param.jmax, dx, dy, param.obstacles),
        dx, dy, param.omg).flags("cuda")


def inverse_squares_2d(param):
    """(idx2, idy2) of param's grid."""
    return tuple(1.0 / (d * d) for d in (param.xlength / param.imax,
                                         param.ylength / param.jmax))


def check_masked_k2(torch, np, param, flags, dtype, n, seed, calls=2):
    """Masked K2 in the solver's form (reading one field, writing `out`, the
    two swapped each call) and its plain version (in place) on copies of
    random p, rhs, `calls` calls each. Returns (fields bitwise, residuals
    bitwise, max_abs_err)."""
    from pampi_tpu_torch.ops import sor_kernels as sk

    c = inverse_squares_2d(param)
    x, f = rng_fields(torch, np, tuple(flags.shape), dtype, 2, seed)
    xk, xp, y = x.clone(), x.clone(), torch.empty_like(x)
    for _ in range(calls):
        rk = sk.rb_sor_checkerboard(xk, f, n, 0.0, *c, flags=flags,
                                    omega=param.omg, out=y)
        xk, y = y, xk
        rp = sk.rb_sor_masked_plain(xp, f, flags, n, param.omg, *c)
    return (torch.equal(xk, xp), torch.equal(rk, rp),
            float((xk - xp).abs().max()))


def check_k17(torch, np, shape, dtype, seed, calls=2):
    """K17 against its plain version and against K2 at n_inner 1, on
    copies of random p, rhs of a (jmax, imax) grid, `calls` calls each.
    Returns (fields bitwise vs plain, residuals bitwise, fields bitwise vs
    K2, max_abs_err)."""
    from pampi_tpu_torch.ops import sor_kernels as sk

    jmax, imax = shape
    coef = sk.sor_coefficients(1.0 / imax, 1.0 / jmax, 1.9)
    x, f = rng_fields(torch, np, (jmax + 2, imax + 2), dtype, 2, seed)
    xk, xp, x2 = x.clone(), x.clone(), x.clone()
    for _ in range(calls):
        rk = sk.rb_sor_blocked(xk, f, *coef)
        rp = sk.rb_sor_blocked_plain(xp, f, *coef)
        sk.rb_sor_checkerboard(x2, f, 1, *coef)
    return (torch.equal(xk, xp), torch.equal(rk, rp), torch.equal(xk, x2),
            float((xk - xp).abs().max()))


def check_step2d_flags(torch, u, v, p, dt, cfg, flags, t):
    """K3 then K4 in flag mode on one device against their plain versions
    on the same inputs. Returns (ok, copies and maxima bitwise, every
    output bitwise, max_rel_err, max_abs_err, K3's F/G/rhs, the u, v K4
    projected)."""
    from pampi_tpu_torch.ops import ns2d_fused as nf

    uk, vk = u.clone(), v.clone()
    fk = nf.ns2d_pre(uk, vk, dt, cfg, flags=flags)
    pl = nf.ns2d_pre_plain(u, v, dt, cfg, flags=flags)
    exact = torch.equal(uk, pl[0]) and torch.equal(vk, pl[1])
    mp = nf.ns2d_post_plain(pl[0], pl[1], *pl[2:4], p, dt, cfg.dx, cfg.dy,
                            flags=flags)
    mk = nf.ns2d_post(uk, vk, *fk[:2], p, dt, cfg.dx, cfg.dy, flags=flags)
    exact = exact and all(torch.equal(m, a.abs().max())
                          for m, a in zip(mk, (uk, vk)))
    pairs = list(zip(fk, pl[2:])) + list(zip((uk, vk), mp[:2]))
    every = exact and all(torch.equal(a, b) for a, b in pairs)
    e = max(rel_err(a, b) for a, b in pairs)
    err = max(float((a - b).abs().max()) for a, b in pairs)
    return exact and e <= t, exact, every, e, err, fk, (uk, vk)


def check_dist2d_flags(torch, np, s, dtype, seed):
    """K3/K4's distributed flag mode against their plain versions on every
    shard of an obstacle NS2DDistSolver (its offsets and deep and halo-1
    flag blocks), on random blocks. Returns (copies and maxima bitwise,
    every output bitwise, max_rel_err, max_abs_err)."""
    from pampi_tpu_torch.ops.ns2d_fused import StepConfig

    cfg = StepConfig.from_param(s.param)
    dt = torch.tensor(0.013, dtype=dtype, device="cuda")
    exact, every, e, err = True, True, 0.0, 0.0
    for k, off in enumerate(s.offs):
        u, v = rng_fields(torch, np, (s.jl + 6, s.il + 6), dtype, 2,
                          seed + k)
        (p,) = rng_fields(torch, np, (s.jl + 2, s.il + 2), dtype, 1,
                          seed + 50 + k)
        ex, ev, es, errs, _, _ = step2d_shard(torch, cfg, off, s.gext, u, v,
                                              p, dt, s.ragged, s._flags[k])
        exact, every = exact and ex, every and ev
        e, err = max(e, es), max(err, errs)
    return exact, every, e, err


@phase("2-D obstacle kernels vs plain versions: masked K2, K17, K3/K4 in "
       "flag mode (one device and distributed), K15 on real flags")
def check_obstacle2d_kernels(torch, np):
    from pampi_tpu_torch.ops.ns2d_fused import StepConfig

    bad = []
    dtypes = (torch.float32, torch.float64)
    for jmax, imax in OBST2_CHECK:
        shape = f"{imax}x{jmax}"
        for dtype in dtypes:
            name = "float32" if dtype == torch.float32 else "float64"
            param = obstacle2d_config(jmax, imax, tpu_dtype=name, eps=0.0)
            flags = obstacle2d_flags(param)
            for n in (1, 2, 3, 4):
                fb, rb, err = check_masked_k2(torch, np, param, flags, dtype,
                                              n, 251)
                log(f"rb_sor_checkerboard masked {dtype} {shape} n={n}, two "
                    f"calls, out=: fields bitwise {fb}, "
                    f"residuals bitwise {rb}, "
                    f"max_abs_err {err:.3e} {'ok' if fb and rb else 'FAIL'}")
                if not (fb and rb):
                    bad.append(f"masked K2 {shape} {dtype} n={n}")
            t = tol(torch, dtype)
            u, v, pp = rng_fields(torch, np, tuple(flags.shape), dtype, 3,
                                  253)
            dt = torch.tensor(0.013, dtype=dtype, device="cuda")
            ok, exact, every, e, err, _, _ = check_step2d_flags(
                torch, u, v, pp, dt, StepConfig.from_param(param), flags, t)
            log(f"ns2d_pre/post flag mode {dtype} {shape}: u', v' and maxima"
                f" bitwise {exact}, every output bitwise {every}, "
                f"max_rel_err {e:.3e}, max_abs_err {err:.3e} (tol {t:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"K3/K4 flag mode {shape} {dtype}")
            for dims in ((2, 2), (3, 2)):
                mesh = "x".join(map(str, dims))
                s = dist2d_solver(param.replace(tpu_mesh=mesh), dims)
                g = s._solve_k.geom
                bitwise, er, err = check_obsdist(torch, np, s._solve_k,
                                                 param, dtype, 255)
                ok = bitwise and er <= t
                log(f"rb_sor_obsdist {dtype} {shape} on {mesh} on real flags"
                    f" (n={g.n}, H={g.H}, deep blocks {g.shape}), every "
                    f"shard, two calls: blocks bitwise {bitwise}, residual "
                    f"rel_err {er:.3e}, max_abs_err {err:.3e} (tol {t:g}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    bad.append(f"K15 real flags {shape} {mesh} {dtype}")
                exact, every, e, err = check_dist2d_flags(torch, np, s, dtype,
                                                          261)
                ok = exact and e <= t
                log(f"ns2d_pre/post distributed flag mode {dtype} {shape} on"
                    f" {mesh} ({s.jl}x{s.il} shards), every shard: u', v' "
                    f"and maxima bitwise {exact}, every output bitwise "
                    f"{every}, max_rel_err {e:.3e}, max_abs_err {err:.3e} "
                    f"(tol {t:g}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    bad.append(f"K3/K4 distributed flag mode {shape} {mesh} "
                               f"{dtype}")
                del s
    for shape in K17_CHECK:
        for dtype in dtypes:
            fb, rb, same, err = check_k17(torch, np, shape, dtype, 271)
            ok = fb and rb and same
            log(f"rb_sor_blocked {dtype} {shape[1]}x{shape[0]}, two calls: "
                f"fields bitwise {fb}, residual bitwise {rb}, fields bitwise "
                f"vs rb_sor_checkerboard n_inner 1 {same}, max_abs_err "
                f"{err:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"K17 {shape} {dtype}")
    if bad:
        raise AssertionError(f"2-D obstacle kernels disagree: {bad}")


@phase("masked K2 and K3/K4 flag mode at 8192x2048, K17 at 4096² and K15 "
       "per 4096x1024 shard on real flags: times, float32")
def time_obstacle2d(torch, np):
    from pampi_tpu_torch.ops import ns2d_fused as nf
    from pampi_tpu_torch.ops import sor_kernels as sk

    size, rows, f32 = 4, {}, torch.float32
    J, I = OBST2_MAIN
    param = obstacle2d_config(J, I, tpu_dtype="float32", eps=0.0)
    flags = obstacle2d_flags(param)
    cells, interior = flags.numel(), J * I
    ring = 2 * (I + 2) + 2 * J
    c = inverse_squares_2d(param)
    shape = f"{I}x{J}"
    bad = []
    for dtype in (f32, torch.float64):
        for n in (1, 2, 3, 4):
            fb, rb, err = check_masked_k2(torch, np, param, flags, dtype, n,
                                          281, calls=1)
            log(f"rb_sor_checkerboard masked {shape} {dtype} n={n} vs plain,"
                f" out=: fields bitwise {fb}, residuals bitwise "
                f"{rb} {'ok' if fb and rb else 'FAIL'}")
            if not (fb and rb):
                bad.append(f"{dtype} n={n}")
            if dtype == f32 and n == 4:
                err4 = err
    if bad:
        raise AssertionError(f"masked K2 differs from its plain version at "
                             f"{shape}: {bad}")
    x, f = rng_fields(torch, np, tuple(flags.shape), f32, 2, 283)
    y = torch.empty_like(x)

    def masked(n, p=x, out=y):
        return lambda: sk.rb_sor_checkerboard(p, f, n, 0.0, *c, flags=flags,
                                              omega=param.omg, out=out)

    ms = cuda_ms(torch, masked(4), 20)
    pms = cuda_ms(torch, lambda: sk.rb_sor_masked_plain(
        x.clone(), f, flags, 4, param.omg, *c), 2)
    ms1 = cuda_ms(torch, masked(1), 20)
    calls, calls1 = cuda_launches(torch, masked(4)), cuda_launches(
        torch, masked(1))
    if (calls or 1) > 1 or (calls1 or 1) > 1:
        raise AssertionError(f"masked K2 made {calls} / {calls1} CUDA "
                             f"launches a call at n = 4 / 1")
    # p and rhs read, p written, the flags read once: 13 bytes a cell;
    # ~20 flops a cell update
    b = bound(13 * cells, 20 * 4 * interior)
    rows["rb_sor_checkerboard_masked"] = dict(
        max_abs_err=err4, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
        n1_ms=ms1, cuda_launches_a_call=calls, n1_cuda_launches_a_call=calls1,
        shape=f"{shape} f32, n=4, canal_obstacle.par's box (512x512 cells)")
    log(f"rb_sor_checkerboard masked {shape} f32 n=4: {ms:.4f} ms per call "
        f"(plain {pms:.4f}, bound {b[0]:.4f} by {b[1]}); n=1 {ms1:.4f} ms; "
        f"out= form, {launches_text(calls)} / {launches_text(calls1)} CUDA "
        f"launches a call at n = 4 / 1")
    del x, f, y
    # K3/K4 in flag mode on the same grid
    cfg = nf.StepConfig.from_param(param)
    u, v, pp = rng_fields(torch, np, tuple(flags.shape), f32, 3, 287)
    dt = torch.tensor(1e-4, dtype=f32, device="cuda")
    ok, exact, every, e, err, fk, (uk, vk) = check_step2d_flags(
        torch, u, v, pp, dt, cfg, flags, tol(torch, f32))
    if not ok:
        raise AssertionError(f"K3/K4 flag mode differ from their plain "
                             f"versions at {shape}")
    ms = cuda_ms(torch, lambda: nf.ns2d_pre(uk, vk, dt, cfg, flags=flags),
                 20)
    pms = cuda_ms(torch, lambda: nf.ns2d_pre_plain(u, v, dt, cfg,
                                                   flags=flags), 3)
    qms = cuda_ms(torch, lambda: nf.ns2d_post(
        uk, vk, *fk[:2], pp, dt, cfg.dx, cfg.dy, flags=flags), 20)
    qpms = cuda_ms(torch, lambda: nf.ns2d_post_plain(
        uk, vk, *fk[:2], pp, dt, cfg.dx, cfg.dy, flags=flags), 3)
    # as K3/K4 are bounded (5 field-sizes and two ghost rings each), plus
    # the flags' byte a cell
    b = bound((5 * cells + 2 * ring) * size + cells, 80 * interior)
    q = bound((5 * cells + 2 * ring) * size + cells, 10 * interior)
    rows["ns2d_pre_flags"] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
        shape=f"{shape} f32, canal_obstacle.par's BCs and box")
    rows["ns2d_post_flags"] = dict(
        max_abs_err=err, ms=qms, plain_ms=qpms, bound_ms=q[0], bound_by=q[1],
        shape=f"{shape} f32, canal_obstacle.par's BCs and box")
    log(f"ns2d_pre flag mode {shape} f32: {ms:.4f} ms (plain {pms:.4f}, "
        f"bound {b[0]:.4f} by {b[1]}); ns2d_post flag mode: {qms:.4f} ms "
        f"(plain {qpms:.4f}, bound {q[0]:.4f} by {q[1]})")
    del u, v, pp, uk, vk, fk, flags
    torch.cuda.empty_cache()
    # K17 at 4096²: one iteration a call
    J2, I2 = K17_MAIN
    fb, rb, same, err = check_k17(torch, np, K17_MAIN, f32, 289, calls=1)
    if not (fb and rb and same):
        raise AssertionError("K17 differs from its plain version or K2 at "
                             "4096²")
    coef = sk.sor_coefficients(1.0 / I2, 1.0 / J2, 1.9)
    x, f = rng_fields(torch, np, (J2 + 2, I2 + 2), f32, 2, 291)
    ms = cuda_ms(torch, lambda: sk.rb_sor_blocked(x, f, *coef), 20)
    pms = cuda_ms(torch, lambda: sk.rb_sor_blocked_plain(x, f, *coef), 2)
    k2 = cuda_ms(torch, lambda: sk.rb_sor_checkerboard(x, f, 1, *coef), 20)
    # p and rhs read once, p written once: 12 bytes a cell; ~12 flops an
    # update
    b = bound(12 * (J2 + 2) * (I2 + 2), 12 * J2 * I2)
    rows["rb_sor_blocked"] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
        k2_n1_ms=k2, shape=f"{I2}x{J2} f32, one iteration a call")
    log(f"rb_sor_blocked {I2}x{J2} f32: {ms:.4f} ms per call (plain "
        f"{pms:.4f}, bound {b[0]:.4f} by {b[1]}; rb_sor_checkerboard at "
        f"n_inner 1 {k2:.4f})")
    del x, f
    torch.cuda.empty_cache()
    # K15 per 4096x1024 shard of 8192x2048 on 2x2 on the real flags, n = 4
    s = dist2d_solver(param.replace(tpu_mesh="2x2", tpu_sor_inner=4), (2, 2))
    solve = s._solve_k
    g = solve.geom
    bitwise, er, err = check_obsdist(torch, np, solve, param, f32, 293, 1)
    if not (bitwise and er <= tol(torch, f32)):
        raise AssertionError("K15 differs from its plain version on the real"
                             " flags")
    blocks = [rng_fields(torch, np, g.shape, f32, 2, 295 + k)
              for k in range(len(solve.offs))]
    coef = (param.omg, *c)
    nsh = len(solve.offs)
    ms, pms, calls = time_obsdist_shards(torch, solve, blocks, coef)
    # the cells K15 reads on each (corner) shard: H layers on the two
    # interface sides, the ghost layer on the two wall sides
    read = sum(k15_read_cells(g, o) for o in solve.offs) / nsh
    b = bound(read * (3 * size + 1), 20 * g.n * g.jl * g.il)
    rows["rb_sor_obsdist"] = dict(
        real_flags_ms=ms, real_flags_plain_ms=pms, real_flags_bound_ms=b[0],
        real_flags_bound_by=b[1], real_flags_max_abs_err=err,
        real_flags_cuda_launches_a_call=calls,
        real_flags_shape=f"{g.jl}x{g.il} shard of {I}x{J} on 2x2 (deep "
                         f"{g.shape[0]}x{g.shape[1]}, {read:.0f} cells "
                         f"read), n={g.n}, canal_obstacle.par's box")
    log(f"rb_sor_obsdist per {g.il}x{g.jl} shard of {shape} f32 on 2x2, real"
        f" flags, n={g.n} (deep block {g.shape}): {ms:.4f} ms per shard call"
        f" (plain {pms:.4f}, bound {b[0]:.4f} by {b[1]}), "
        f"{launches_text(calls)} CUDA launches a call")
    del blocks, s, solve
    torch.cuda.empty_cache()
    return rows


def obsdist_cli_configs():
    """The CLI runs whose rounds make most of K15's and K16's launches, as
    (kernel, label, param, mesh dims): configs/dcavity.par on 3x3 (34²
    shards), configs/canal_obstacle.par on 2x2 (256x64 shards) and
    configs/canal3d_obstacle.par on 2x2x2 (64x16x16 shards), all float64
    at n = 1 (tpu_ca_inner 1)."""
    return (("rb_sor_obsdist", "dcavity.par 3x3",
             config("dcavity.par", tpu_mesh="3x3"), (3, 3)),
            ("rb_sor_obsdist", "canal_obstacle.par 2x2",
             config("canal_obstacle.par", tpu_mesh="2x2"), (2, 2)),
            ("rb_sor_obsdist3d", "canal3d_obstacle.par 2x2x2",
             config("canal3d_obstacle.par", tpu_mesh="2x2x2"), (2, 2, 2)))


@phase("K15 and K16 at the CLI runs' float64 shards: vs plain, times, "
       "CUDA launches a call")
def time_obsdist_cli(torch, np):
    from pampi_tpu_torch.models.ns3d_dist import NS3DDistSolver
    from pampi_tpu_torch.parallel.comm import CartComm

    rows, bad = {"rb_sor_obsdist": {}, "rb_sor_obsdist3d": {}}, []
    f64 = torch.float64
    for name, label, param, dims in obsdist_cli_configs():
        key = "cli_" + label.split(".")[0]
        if name == "rb_sor_obsdist":
            s = dist2d_solver(param, dims)
            solve = s._solve_k
            fb, er, err = check_obsdist(torch, np, solve, param, f64, 301)
            rb = er <= tol(torch, f64)
            dx, dy = param.xlength / param.imax, param.ylength / param.jmax
            coef = (param.omg, 1.0 / (dx * dx), 1.0 / (dy * dy))
            reads = [k15_read_cells(solve.geom, o) for o in solve.offs]
            g = solve.geom
            cells, flops = g.jl * g.il, 20
        else:
            s = NS3DDistSolver(param, CartComm(ndims=3, dims=dims))
            solve = s._obs_solve
            fb, rb, err = check_obsdist3d(torch, np, solve, param, f64, 311)
            coef = (param.omg, *inverse_squares(param))
            reads = [k16_read_cells(solve.geom, o) for o in solve.offs]
            g = solve.geom
            cells, flops = g.kl * g.jl * g.il, 33
        blocks = [rng_fields(torch, np, g.shape, f64, 2, 321 + k)
                  for k in range(len(solve.offs))]
        ms, pms, calls = time_obsdist_shards(torch, solve, blocks, coef,
                                             reps=200)
        read = sum(reads) / len(reads)
        b = bound(read * (3 * 8 + 1), flops * g.n * cells, FP64_FLOPS)
        rows[name].update({
            f"{key}_ms": ms, f"{key}_plain_ms": pms, f"{key}_bound_ms": b[0],
            f"{key}_bound_by": b[1], f"{key}_max_abs_err": err,
            f"{key}_cuda_launches_a_call": calls,
            f"{key}_shape": f"{label} f64 shards, deep {g.shape}, n={g.n}"})
        log(f"{name} f64 {label} (deep blocks {g.shape}, n={g.n}), every "
            f"shard vs plain: blocks bitwise {fb}, residual "
            f"{'bitwise' if name.endswith('3d') else 'within tol'} {rb}; "
            f"{ms:.4f} ms a shard call (plain {pms:.4f}, bound {b[0]:.6f} "
            f"by {b[1]}), {launches_text(calls)} CUDA launches a call")
        if not (fb and rb):
            bad.append(label)
        del s, solve, blocks
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"K15/K16 differ from their plain versions at "
                             f"the CLI shards: {bad}")
    return rows


@phase("K13 and masked K2 at the CLI runs' float64 shapes (n = 1): vs "
       "plain, times, CUDA launches a call")
def time_sor_cli(torch, np):
    """K13 on configs/dcavity.par's 50² shards on 2x2 and masked K2 on
    configs/canal_obstacle.par (512x128) and canal_obstacle2048.par
    (2048x512), float64 at the CLI's n = 1, in the solvers' `out=` form:
    bitwise their plain versions, ms a call from CUDA events over
    back-to-back calls (the host's rate where its work exceeds the
    card's), CUDA launches a call (must be 1)."""
    from pampi_tpu_torch.ops import sor_kernels as sk
    from pampi_tpu_torch.ops import sor_qdist as sq

    f64, rows, bad = torch.float64, {}, []
    s = dist2d_solver(config("dcavity.par", tpu_mesh="2x2"), (2, 2))
    g = s._qg
    qoffs = [(jo // 2, io // 2) for jo, io in s.offs]
    fb, rb, err = check_qdist(torch, np, g, qoffs, f64, 331)
    coef = sk.sor_coefficients(1.0 / g.imax, 1.0 / g.jmax, s.param.omg)
    planes = [rng_fields(torch, np, (4, g.jq, g.iq), f64, 2, 333 + k)
              for k in range(len(qoffs))]
    outs = [torch.empty_like(x) for x, _ in planes]
    ms = cuda_ms(torch, lambda: [
        sq.rb_sor_qdist(x, f, g, o, *coef, out=y)
        for (x, f), y, o in zip(planes, outs, qoffs)], 200) / len(qoffs)
    pms = cuda_ms(torch, lambda: [
        sq.rb_sor_qdist_plain(x, f, g, o, *coef, out=y)
        for (x, f), y, o in zip(planes, outs, qoffs)], 5) / len(qoffs)
    (x, f), y = planes[0], outs[0]
    calls = cuda_launches(torch, lambda: sq.rb_sor_qdist(
        x, f, g, qoffs[0], *coef, out=y))
    b = bound(3 * 4 * g.jq * g.iq * 8, 12 * g.n * g.jl * g.il, FP64_FLOPS)
    rows["rb_sor_qdist"] = dict(
        cli_dcavity_ms=ms, cli_dcavity_plain_ms=pms,
        cli_dcavity_bound_ms=b[0], cli_dcavity_bound_by=b[1],
        cli_dcavity_max_abs_err=err, cli_dcavity_cuda_launches_a_call=calls,
        cli_dcavity_shape=f"dcavity.par 2x2 f64 shards, planes "
                          f"{g.jq}x{g.iq}, n={g.n}")
    log(f"rb_sor_qdist f64 dcavity.par 2x2 (planes {g.jq}x{g.iq}, n={g.n}), "
        f"every shard vs plain: planes bitwise {fb}, residuals bitwise {rb};"
        f" {ms:.4f} ms a shard call (plain {pms:.4f}, bound {b[0]:.6f} by "
        f"{b[1]}), {launches_text(calls)} CUDA launches a call")
    if not (fb and rb and (calls or 1) == 1):
        bad.append("K13 dcavity.par 2x2")
    del s, planes, outs
    rows["rb_sor_checkerboard_masked"] = {}
    for par in ("canal_obstacle.par", "canal_obstacle2048.par"):
        key = "cli_" + par.split(".")[0]
        param = config(par)
        flags = obstacle2d_flags(param)
        fb, rb, err = check_masked_k2(torch, np, param, flags, f64, 1, 341)
        c = inverse_squares_2d(param)
        x, f = rng_fields(torch, np, tuple(flags.shape), f64, 2, 343)
        y = torch.empty_like(x)

        def call(x=x, f=f, y=y, flags=flags, c=c, omega=param.omg):
            return sk.rb_sor_checkerboard(x, f, 1, 0.0, *c, flags=flags,
                                          omega=omega, out=y)

        ms = cuda_ms(torch, call, 200)
        pms = cuda_ms(torch, lambda: sk.rb_sor_masked_plain(
            x.clone(), f, flags, 1, param.omg, *c), 5)
        calls = cuda_launches(torch, call)
        cells, interior = flags.numel(), param.imax * param.jmax
        b = bound((3 * 8 + 1) * cells, 20 * interior, FP64_FLOPS)
        rows["rb_sor_checkerboard_masked"].update({
            f"{key}_ms": ms, f"{key}_plain_ms": pms,
            f"{key}_bound_ms": b[0], f"{key}_bound_by": b[1],
            f"{key}_max_abs_err": err,
            f"{key}_cuda_launches_a_call": calls,
            f"{key}_shape": f"{par} {param.imax}x{param.jmax} f64, n=1"})
        log(f"rb_sor_checkerboard masked f64 {par} ({param.imax}x"
            f"{param.jmax}, n=1) vs plain: fields bitwise {fb}, residuals "
            f"bitwise {rb}; {ms:.4f} ms a call (plain {pms:.4f}, bound "
            f"{b[0]:.6f} by {b[1]}), {launches_text(calls)} CUDA launches a "
            f"call")
        if not (fb and rb and (calls or 1) == 1):
            bad.append(f"masked K2 {par}")
        del x, f, y
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"at the CLI shapes: {bad}")
    return rows


def kernel_times(root, only=()) -> int:
    """--kernel-times [ROOT [PREFIX ...]]: K1 (float32, float64 and bf16),
    K2's class mode (the fleet's buckets A and B), K13, masked K2 and K15,
    masked K5, K14, K16, K6 and flag K7 of the package under ROOT (default:
    this checkout) at their timed shapes and the CLI's shapes
    (kernel_times_3d),
    each called as that checkout's solvers call it (with `out=` where its
    wrapper takes it): device ms a call (CUDA events over back-to-back
    calls) and CUDA launches a call (torch.profiler's trace). With
    PREFIXes, only the rows whose keys start with one of them (k1_,
    k1bf16, k2c, k13, k2_, k15, k5m, k14, k16, k6, k7f). Prints the card and one JSON line. Run
    it for two checkouts in one call on the card, in the order old, new,
    new, old, to compare them."""
    import inspect

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(root))
    from pampi_tpu_torch.ops import sor_kernels as sk
    from pampi_tpu_torch.ops import sor_obsdist as sod
    from pampi_tpu_torch.ops import sor_qdist as sq
    from pampi_tpu_torch.ops.sor_quarters import stack_quarters
    from pampi_tpu_torch.parallel.stencil2d import ca_halo

    def with_out(fn, y):
        return {"out": y} if "out" in inspect.signature(fn).parameters else {}

    def row(calls, reps, label):
        ms = cuda_ms(torch, lambda: [c() for c in calls], reps) / len(calls)
        return {"shape": label, "ms": ms,
                "cuda_launches_a_call": cuda_launches(torch, calls[0])}

    def want(key):
        return not only or key.startswith(tuple(only))

    f32, f64, out = torch.float32, torch.float64, {}
    for key, (jmax, imax), dtype, n, reps in (
            ("k13_4096_2x2_f32", MAIN, f32, 4, 20),
            ("k13_dcavity_2x2_f64", (100, 100), f64, 1, 500)):
        if not want(key):
            continue
        g, qoffs = qdist_shards(jmax, imax, (2, 2), n)
        coef = sk.sor_coefficients(1.0 / imax, 1.0 / jmax, 1.9)
        calls = []
        for k, o in enumerate(qoffs):
            x, f, y = rng_fields(torch, np, (4, g.jq, g.iq), dtype, 3, 11 + k)
            kw = with_out(sq.rb_sor_qdist, y)
            calls.append(lambda x=x, f=f, o=o, kw=kw: sq.rb_sor_qdist(
                x, f, g, o, *coef, **kw))
        out[key] = row(calls, reps, f"{g.jl}x{g.il} shard of {imax}x{jmax} "
                                    f"on 2x2, n={g.n}, {dtype}")
    for key, par, dims, dtype, n, reps in (
            ("k2_8192x2048_f32_n4", "canal_obstacle.par", (2048, 8192), f32,
             4, 20),
            ("k2_8192x2048_f32_n1", "canal_obstacle.par", (2048, 8192), f32,
             1, 20),
            ("k2_canal_obstacle_f64", "canal_obstacle.par", None, f64, 1,
             500),
            ("k2_canal_obstacle2048_f64", "canal_obstacle2048.par", None,
             f64, 1, 200)):
        if not want(key):
            continue
        param = config(par) if dims is None else obstacle2d_config(*dims)
        flags = obstacle2d_flags(param)
        c = inverse_squares_2d(param)
        x, f, y = rng_fields(torch, np, tuple(flags.shape), dtype, 3, 31)
        kw = with_out(sk.rb_sor_checkerboard, y)
        out[key] = row([lambda: sk.rb_sor_checkerboard(
            x, f, n, 0.0, *c, flags=flags, omega=param.omg, **kw)], reps,
            f"{par} geometry at {param.imax}x{param.jmax}, n={n}, {dtype}")
    for key, (jmax, imax), dtype, n, reps in (
            ("k1_4096_f32_n4", MAIN, f32, 4, 50),
            ("k1_4096_f64_n4", MAIN, f64, 4, 20),
            ("k1_100_f64_n1", (100, 100), f64, 1, 500),
            ("k1bf16_4096_n4", MAIN, torch.bfloat16, 4, 50),
            ("k1bf16_100_n4", (100, 100), torch.bfloat16, 4, 500)):
        if not want(key):
            continue
        coef = sk.sor_coefficients(1.0 / imax, 1.0 / jmax, 1.9)
        x, f, y = (stack_quarters(a) for a in rng_fields(
            torch, np, (jmax + 2, imax + 2), dtype, 3, 13))
        # as that checkout's solve loop calls it: out of place where its
        # K1 takes `out=` at every dtype, else in place (float32 and
        # float64 in the multi-launch design)
        kw = ({"out": y} if hasattr(sk, "quarters_launch_plan")
              or dtype == torch.bfloat16 else {})
        # the planes and their rhs read, the planes written
        b = bound(3 * x.numel() * x.element_size(), 0)[0]
        out[key] = {**row([lambda: sk.rb_sor_quarters(x, f, n, *coef, **kw)],
                          reps, f"{imax}x{jmax} quarters {tuple(x.shape)}, "
                          f"n={n}, {dtype}"), "bound_ms": b}
        del x, f, y
    for key, cls, lanes, reps in (
            ("k2c_A_64_f32_n4", 64, fleet_lanes_a(), 200),
            ("k2c_B_256_f32_n4", 256, [(256, 256)] * FLEET_B, 50)):
        if not want(key):
            continue
        bt = sor_class_batch(torch, np, cls, lanes, f32, 611)
        y = torch.empty_like(bt["p"])
        # out of place where the class solve alternates two blocks (the
        # one-launch design), else in place
        kw = {"out": y} if hasattr(sk, "class_launch_plan") else {}
        corner = sum((j + 2) * (i + 2) for j, i in lanes) * 4
        call = [lambda: sk.rb_sor_class(bt["p"], bt["rhs"], 4, bt["ext"],
                                        bt["geo"], bt["active"], **kw)]
        n_dev, busy = device_trace(torch, call[0])
        out[key] = {**row(call, reps, f"{len(lanes)} lanes of the {cls}² "
                          f"class, n=4, float32"),
                    "device_busy_ms": busy, "bound_ms": bound(3 * corner,
                                                              0)[0]}
        del bt, y
    if want("k15"):
        g = sod.ObsGeom(4096, 4096, 1366, 4096, 4, ca_halo(4, True))
        x, f, y = rng_fields(torch, np, g.shape, f32, 3, 61)
        fl = torch.ones(g.shape, dtype=torch.uint8, device="cuda")
        out["k15_3x1_f32_n4"] = row([lambda: sod.rb_sor_obsdist(
            x, f, fl, g, (1366, 0), 1.9, 4096.0 ** 2, 4096.0 ** 2, out=y)],
            50, "1366x4096 shard (deep 1384x4114) of 4096² on 3x1, n=4, "
            "float32, all fluid")
        del x, f, y, fl
    out.update(kernel_times_3d(torch, np, with_out, row, want))
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
    print(json.dumps({"root": os.path.abspath(root), **out}))
    return 0


def kernel_times_3d(torch, np, with_out, row, want):
    """kernel_times' 3-D rows: masked K5 at 512x128x128 float32, n = 4,
    and at configs/canal3d_obstacle.par's 128x32x32 float64, n = 1; K14
    per 128³ shard of 256³ on 2x2x2 float32, n = 4, and on the shards of
    configs/dcavity3d.par on 2x2x2 (64³, float32 at its cadence and
    float64 at n = 1); K16 per (128, 128, 512) shard of 1024x256x256 on
    2x2x2 float32, n = 4; K6 at configs/dcavity3d.par's 128³ float32, n =
    4, configs/canal3d.par's 200x50x50 float64, n = 1, and 256³ float32, n
    = 4; flag K7 at canal3d_obstacle.par's geometry at 512x128x128 float32
    and as shipped (128x32x32 float64). Every row but K16's with its
    bound."""
    from pampi_tpu_torch.models.ns3d_dist import NS3DDistSolver
    from pampi_tpu_torch.ops import ns3d_fused as nf3
    from pampi_tpu_torch.ops import sor3d_kernels as sk3
    from pampi_tpu_torch.ops import sor_obsdist3d as sod3
    from pampi_tpu_torch.ops import sor_odist as so
    from pampi_tpu_torch.ops.sor3d import sor_coefficients_3d
    from pampi_tpu_torch.ops.sor_octants import stack_octants
    from pampi_tpu_torch.parallel.comm import CartComm

    f32, f64, out = torch.float32, torch.float64, {}
    for key, param, dtype, n, reps in (
            ("k6_dcavity3d_128_f32_n4", config("dcavity3d.par"), f32, 4, 50),
            ("k6_canal3d_f64_n1", config("canal3d.par"), f64, 1, 500),
            ("k6_256_f32_n4", config("dcavity3d.par", imax=256, jmax=256,
                                     kmax=256), f32, 4, 20)):
        if not want(key):
            continue
        K, J, I = param.kmax, param.jmax, param.imax
        coef = sor_coefficients_3d(param.xlength / I, param.ylength / J,
                                   param.zlength / K, param.omg)
        q, f = (stack_octants(a) for a in rng_fields(
            torch, np, (K + 2, J + 2, I + 2), dtype, 2, 43))
        # the octants of p and rhs read, those of p written
        b = bound(3 * q.numel() * q.element_size(), 0)[0]
        out[key] = {**row([lambda: sk3.rb_sor3d_octants(q, f, n, *coef)],
                          reps, f"{I}x{J}x{K} octants {tuple(q.shape)}, "
                          f"n={n}, {dtype}"), "bound_ms": b}
        del q, f
    for key, param, dtype, reps in (
            ("k7f_512x128x128_f32", obstacle_config(**OBST_MAIN), f32, 20),
            ("k7f_canal3d_obstacle_f64", obstacle_config(), f64, 500)):
        if not want(key):
            continue
        flags = torch.from_numpy(obstacle_fluid(param).astype(
            np.uint8)).to("cuda")
        cfg = nf3.StepConfig3D.from_param(param)
        u, v, w = rng_fields(torch, np, tuple(flags.shape), dtype, 3, 47)
        dt = torch.tensor(1e-3, dtype=dtype, device="cuda")
        # 7 field-sizes, as without flags, plus the flags' byte a cell
        b = bound((7 * u.element_size() + 1) * flags.numel(), 0)[0]
        out[key] = {**row([lambda: nf3.ns3d_pre(u, v, w, dt, cfg,
                                                flags=flags)], reps,
                          f"canal3d_obstacle.par geometry at {param.imax}x"
                          f"{param.jmax}x{param.kmax}, {dtype}"),
                    "bound_ms": b}
        del u, v, w, flags
    for key, param, dtype, n, reps in (
            ("k5m_512x128x128_f32_n4", obstacle_config(**OBST_MAIN), f32, 4,
             20),
            ("k5m_canal3d_obstacle_f64_n1", obstacle_config(), f64, 1, 500)):
        if not want(key):
            continue
        flags = torch.from_numpy(obstacle_fluid(param).astype(
            np.uint8)).to("cuda")
        c = inverse_squares(param)
        x, f, y = rng_fields(torch, np, tuple(flags.shape), dtype, 3, 41)
        kw = with_out(sk3.rb_sor3d_checkerboard, y)
        label = (f"canal3d_obstacle.par geometry at {param.imax}x"
                 f"{param.jmax}x{param.kmax}, n={n}, {dtype}")
        # p, rhs and the flags read, p written
        b = bound((3 * x.element_size() + 1) * flags.numel(), 0)[0]
        out[key] = {**row([lambda: sk3.rb_sor3d_checkerboard(
            x, f, n, 0.0, *c, flags=flags, omega=param.omg, **kw)], reps,
            label), "bound_ms": b}
        del x, f, y, flags
    cases = [("k14_256_2x2x2_f32_n4", odist_shards(BIG3, (2, 2, 2), 4), f32,
              sor_coefficients_3d(1 / 256, 1 / 256, 1 / 256, 1.8), 20)]
    for dtype in (f32, f64) if want("k14") else ():
        param = config("dcavity3d.par", tpu_mesh="2x2x2",
                       tpu_dtype=str(dtype).split(".")[1])
        s = NS3DDistSolver(param, CartComm(ndims=3, dims=(2, 2, 2)))
        cases.append((f"k14_dcavity3d_2x2x2_f{str(dtype)[-2:]}_n{s._og.n}",
                      (s._og, [tuple(o // 2 for o in off) for off in s.offs]),
                      dtype, s._coef, 200))
        del s
    for key, (g, qoffs), dtype, coef, reps in cases:
        if not want(key):
            continue
        vols = [rng_fields(torch, np, (8, g.kq, g.jq, g.iq), dtype, 3, 51 + k)
                for k in range(len(qoffs))]
        calls = [lambda x=x, f=f, o=o, kw=with_out(so.rb_sor_odist, y):
                 so.rb_sor_odist(x, f, g, o, *coef, **kw)
                 for (x, f, y), o in zip(vols, qoffs)]
        label = f"{g.kl}x{g.jl}x{g.il} shard, volume {(8, g.kq, g.jq, g.iq)}"
        label += f", n={g.n}, {dtype}"
        # the volume and its rhs read, the volume written
        b = bound(3 * vols[0][0].numel() * vols[0][0].element_size(), 0)[0]
        out[key] = {**row(calls, reps, label), "bound_ms": b}
        del vols, calls
    if want("k16"):
        big = obstacle_config(**OBST_K16)
        local = (big.kmax // 2, big.jmax // 2, big.imax // 2)
        g = sod3.ObsGeom3(big.kmax, big.jmax, big.imax, *local, 4)
        flags = shard_flags(obstacle_fluid(big), local, local, g.H)
        x, f, y = rng_fields(torch, np, g.shape, f32, 3, 71)
        c = inverse_squares(big)
        out["k16_1024x256x256_2x2x2_f32_n4"] = row(
            [lambda: sod3.rb_sor_obsdist3d(x, f, flags, g, local, big.omg,
                                           *c, out=y)], 20,
            f"(128, 128, 512) shard of 1024x256x256 on 2x2x2, deep "
            f"{g.shape}, n=4, float32")
        del x, f, y, flags
    torch.cuda.empty_cache()
    return out


def check_not_launched_2d(counts, label):
    """K1, unmasked K2, K13 and the unflagged K3/K4 never run on a 2-D
    obstacle path."""
    wrong = [k for k in NOT_ON_OBSTACLE2D_PATHS if counts.get(k, 0)]
    if wrong:
        raise AssertionError(f"{label} launched {wrong}")


@phase("main path: NS-2D with obstacles, canal_obstacle.par's geometry at "
       "8192x2048 float32, one device and 2x2; Poisson 4096² through "
       "make_rb_step_padded(kernel=\"blocked\")")
def main_path_obstacle2d(torch):
    import numpy as np

    from pampi_tpu_torch.kernels import build as kb
    from pampi_tpu_torch.models.ns2d import NS2DSolver
    from pampi_tpu_torch.models.poisson import (
        PoissonSolver,
        make_rb_step_padded,
    )
    from pampi_tpu_torch.utils.params import Parameter

    J, I = OBST2_MAIN
    param = obstacle2d_config(J, I, tpu_dtype="float32", tpu_sor_inner=4,
                              itermax=100, eps=0.0, te=1e9)
    counts = []
    single = NS2DSolver(param.replace(tpu_mesh="1"), device="cuda")
    c, r = drive_path(kb, "NS-2D obstacle one device",
                      ("rb_sor_checkerboard_masked",) + OBST2_PATH,
                      lambda: timed_steps(torch, single, 16))
    check_not_launched_2d(c, "the one-device 2-D obstacle path")
    counts.append(c)
    OBST_SOR_STEP["2d"] = r
    log(f"NS-2D canal_obstacle {I}x{J} f32 one device (re 100, itermax 100, "
        f"eps 0, masked K2 n=4): {r['ms_per_step']:.3f} ms/step (host "
        f"clock); PRE {r['pre']:.3f} / solve {r['solve']:.3f} / POST "
        f"{r['post']:.3f} ms (CUDA events); launches per step "
        f"{c['rb_sor_checkerboard_masked'] / 17:.1f} masked K2")
    s = dist2d_solver(param.replace(tpu_mesh="2x2"), (2, 2))
    s.comm.print_config()
    c, r = drive_path(kb, "NS-2D obstacle 2x2",
                      ("rb_sor_obsdist",) + OBST2_PATH,
                      lambda: dist2d_steps(torch, s, 16))
    check_not_launched_2d(c, "the 2x2 obstacle path")
    counts.append(c)
    diff, scale = field_diff(s, single)
    step = r["pre"] + r["solve"] + r["post"]
    ok = (s.nt == single.nt == 17 and s.t == single.t
          and diff <= 1e-5 * scale)
    log(f"NS-2D canal_obstacle {I}x{J} f32 on 2x2 ({s.jl}x{s.il} shards on "
        f"{sorted(set(map(str, s.comm.devices)))}, K15 n={s._solve_k.n}): "
        f"{r['ms']:.3f} ms/step (host clock); PRE {r['pre']:.3f} / solve "
        f"{r['solve']:.3f} / POST {r['post']:.3f} ms (CUDA events); "
        f"exchanges {r['exchange']:.3f} ms/step, share "
        f"{r['exchange'] / step:.3f} of the step; launches per step "
        f"{c['rb_sor_obsdist'] / 17:.1f} K15; t={s.t:.6e}, single-device "
        f"t={single.t:.6e}; max |dist - single| {diff:.3e} (limit "
        f"{1e-5 * scale:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the 2x2 obstacle run disagrees with one device")
    # the kernels of the mesh path against their plain versions at this
    # path's own shapes: K15 on the solve's deep blocks, flags and offsets,
    # K3/K4 in distributed flag mode on its shards
    g = s._solve_k.geom
    fb, er, err = check_obsdist(torch, np, s._solve_k, param, torch.float32,
                                301)
    t = tol(torch, torch.float32)
    log(f"rb_sor_obsdist f32 on the 2x2 path's own shards (n={g.n}, deep "
        f"blocks {g.shape}, real flags), every shard, two calls: blocks "
        f"bitwise {fb}, residual rel_err {er:.3e}, max_abs_err {err:.3e} "
        f"{'ok' if fb and er <= t else 'FAIL'}")
    exact, every, e, err = check_dist2d_flags(torch, np, s, torch.float32,
                                              311)
    ok = exact and e <= t
    log(f"ns2d_pre/post distributed flag mode f32 on the 2x2 path's own "
        f"shards ({s.jl}x{s.il}), every shard: u', v' and maxima bitwise "
        f"{exact}, every output bitwise {every}, max_rel_err {e:.3e}, "
        f"max_abs_err {err:.3e} (tol {t:g}) {'ok' if ok else 'FAIL'}")
    if not (fb and er <= t and ok):
        raise AssertionError("a kernel of the 2x2 obstacle path differs from "
                             "its plain version at the path's shapes")
    del s, single
    torch.cuda.empty_cache()
    # Poisson 4096² f32 through make_rb_step_padded: K17 ("blocked") and
    # K2 at n_inner 1 ("fused"), 400 iterations each from the same fields
    J2, I2 = K17_MAIN
    pp = Parameter(name="poisson", imax=I2, jmax=J2, tpu_dtype="float32")
    base = PoissonSolver(pp, device="cuda")
    dx, dy = pp.xlength / I2, pp.ylength / J2
    out = {}

    def poisson():
        for kernel in ("blocked", "fused"):
            step, pad, unpad = make_rb_step_padded(
                I2, J2, dx, dy, pp.omg, torch.float32, kernel=kernel,
                device="cuda")
            p, rhs = pad(base.p), pad(base.rhs)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(400):
                p, res = step(p, rhs)
            b.record()
            b.synchronize()
            out[kernel] = (unpad(p), float(res), a.elapsed_time(b) / 400)

    c, _ = drive_path(kb, "Poisson 4096² make_rb_step_padded",
                      ("rb_sor_blocked",), poisson)
    counts.append(c)
    (pb, rb, mb), (pf, rf, mf) = out["blocked"], out["fused"]
    ok = (torch.equal(pb, pf) and c["rb_sor_blocked"] == 400
          and np.isfinite(rb) and abs(rb - rf) <= 1e-5 * abs(rf))
    log(f"Poisson {I2}x{J2} f32, 400 iterations through "
        f"make_rb_step_padded: kernel=\"blocked\" (K17) {mb:.4f} ms per "
        f"iteration, kernel=\"fused\" (K2 n_inner 1) {mf:.4f}; fields "
        f"bitwise {torch.equal(pb, pf)}, residuals {rb:.6e} / {rf:.6e}, K17 "
        f"launches {c['rb_sor_blocked']} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K17's Poisson run disagrees with K2's")
    return counts


OBST2_RUNS = {}
OBST2_TE = 0.5     # canal_obstacle.par: ~50 steps
# canal_obstacle2048.par: 0.2 took 263 steps and 49.5 s on one card (a
# masked K2 call and a host check an iteration at float64), so 0.1
OBST2048_TE = 0.1
# canal_obstacle2048.par cut to this te for the card-vs-CPU comparison: the
# CPU process took 561 s for te 0.01 (14 steps, its first solves at itermax
# 500, ~80 ms a plain masked iteration at 2048x512 f64 beside the other
# processes), which slowed the host-bound card runs beside it
OBST2048_CPU_TE = 0.004


@phase("configs/canal_obstacle.par: the CPU run and the 2x2 and 3x2 card "
       "runs started in processes of their own")
def obstacle2d_cli_start():
    tmp = tempfile.mkdtemp(prefix="obstacle2d_")
    OBST2_RUNS["tmp"] = tmp
    env = dict(os.environ, OMP_NUM_THREADS="2")
    for name, mesh, device, src, te in (
            ("cpu", "1", "cpu", "canal_obstacle.par", OBST2_TE),
            ("2x2", "2x2", "cuda", "canal_obstacle.par", OBST2_TE),
            ("3x2", "3x2", "cuda", "canal_obstacle.par", OBST2_TE),
            ("cpu2048", "1", "cpu", "canal_obstacle2048.par",
             OBST2048_CPU_TE)):
        d = os.path.join(tmp, name)
        os.makedirs(d)
        par = os.path.join(d, src)
        with open(par, "w") as fh:
            fh.write(config_text(src, te=te, tpu_mesh=mesh))
        out = os.path.join(d, "fields.npz")
        OBST2_RUNS[name] = (out, start(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--cli2-child", par, out, device], d,
            os.path.join(d, "child.log"), env))


@phase(f"main path: python -m pampi_tpu_torch configs/canal_obstacle.par "
       f"(te {OBST2_TE}) on the card, one device, 2x2 and 3x2, and on the "
       f"CPU; configs/canal_obstacle2048.par (te {OBST2048_TE}) on the card, "
       f"and at te {OBST2048_CPU_TE} on the card and the CPU")
def obstacle2d_cli(np):
    from pampi_tpu_torch.kernels import build as kb

    if "2x2" not in OBST2_RUNS:
        raise AssertionError("the child runs did not start")
    tmp = OBST2_RUNS["tmp"]
    counts, one = [], {}
    for name, par, te in (("one", "canal_obstacle.par", OBST2_TE),
                          ("2048", "canal_obstacle2048.par", OBST2048_TE),
                          ("2048cut", "canal_obstacle2048.par",
                           OBST2048_CPU_TE)):
        d = os.path.join(tmp, name)
        os.makedirs(d)
        path = os.path.join(d, par)
        with open(path, "w") as fh:
            fh.write(config_text(par, te=te))
        cwd = os.getcwd()
        os.chdir(d)
        try:
            c, (rc, secs, _c, got) = drive_path(
                kb, f"{par} te {te} CLI",
                ("rb_sor_checkerboard_masked",) + OBST2_PATH,
                lambda: run_cli_ns(path, "cuda", 2))
        finally:
            os.chdir(cwd)
        check_not_launched_2d(c, f"the {par} CLI run")
        counts.append(c)
        finite = all(np.isfinite(got[k]).all() for k in "uvp")
        if rc != 0 or not finite:
            raise AssertionError(f"the {par} CLI run: rc {rc}, finite "
                                 f"{finite}")
        one[name] = got
        log(f"{par} te {te} (f64) on one card: {got['nt']} steps to "
            f"t={got['t']:.6f} in {secs:.1f} s (wall, the CLI's whole run, "
            f"beside the other processes); fields finite")
    bad = []
    for name in ("cpu", "2x2", "3x2", "cpu2048"):
        ref = one["2048cut" if name == "cpu2048" else "one"]
        scale = max(1.0, *(float(np.abs(ref[k]).max()) for k in "uvp"))
        out, proc = OBST2_RUNS[name]
        rc = proc.wait(timeout=900)
        if rc != 0:
            log(open(os.path.join(os.path.dirname(out),
                                  "child.log")).read()[-4000:])
            raise AssertionError(f"the {name} child exited {rc}")
        with np.load(out) as z:
            got = {k: z[k] for k in z.files}
        c = json.loads(str(got["counts"]))
        cpu = name.startswith("cpu")
        if not cpu:
            log(f"canal_obstacle.par {name} CLI launches: {json.dumps(c)}")
            missing = [k for k in ("rb_sor_obsdist",) + OBST2_PATH
                       if c[k] == 0]
            if missing:
                raise AssertionError(f"the {name} CLI run did not launch "
                                     f"{missing}")
            check_not_launched_2d(c, f"the {name} CLI run")
            counts.append(c)
        diff = max(float(np.abs(got[k] - ref[k]).max()) for k in "uvp")
        same = (int(got["nt"]), float(got["t"])) == (ref["nt"], ref["t"])
        label = json.loads(str(got["record"])).get(
            "obstacle_dist", "one device")
        ok = diff <= 1e-9 * scale and (same if not cpu
                                       else int(got["nt"]) == ref["nt"])
        par, te = (("canal_obstacle2048.par", OBST2048_CPU_TE)
                   if name == "cpu2048" else ("canal_obstacle.par", OBST2_TE))
        log(f"{par} te {te} {name} ({label}), its own "
            f"process on the {'CPU' if cpu else 'card'}: "
            f"{int(got['nt'])} steps in {float(got['secs']):.1f} s (one "
            f"card: {ref['nt']}), t equal {float(got['t']) == ref['t']}; max "
            f"|{name} - one card| over u, v, p {diff:.3e} (tol 1e-9 of scale "
            f"{scale:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(name)
    if bad:
        raise AssertionError(f"canal_obstacle runs disagree: {bad}")
    return counts


# ----------------------------------------------------------------------
# obstacle multigrid on one card: the masked mode of K9-K12
# ----------------------------------------------------------------------

MG_OBST_CYCLES = 4  # V-cycles a step on the obstacle mg main paths
UNMASKED_MG = ("mg_down_2d", "mg_up_2d", "mg_down_3d", "mg_up_3d")


def check_not_launched_mg(counts, label, also=()):
    """The unmasked fused cycle (and `also`) never runs on an obstacle mg
    path."""
    wrong = [k for k in UNMASKED_MG + tuple(also) if counts.get(k, 0)]
    if wrong:
        raise AssertionError(f"{label} launched {wrong}")


@phase("main path: NS-2D canal_obstacle 8192x2048 and NS-3D canal3d_obstacle "
       "512x128x128 float32 under tpu_solver mg (fused masked cycle, and "
       "the 2-D ladder)")
def main_path_obstacle_mg(torch):
    from pampi_tpu_torch.kernels import build as kb
    from pampi_tpu_torch.models.ns2d import NS2DSolver
    from pampi_tpu_torch.models.ns3d import NS3DSolver
    from pampi_tpu_torch.utils import dispatch

    mg = dict(tpu_dtype="float32", re=100.0, itermax=MG_OBST_CYCLES, eps=0.0,
              tpu_mg_stall_rtol=0.0, te=1e9, tpu_solver="mg", tpu_mesh="1")
    counts, bad = [], []
    for label, make, kernels, sor, not_on in (
            ("NS-2D canal_obstacle 8192x2048 f32 mg",
             lambda: NS2DSolver(obstacle2d_config(*OBST2_MAIN, **mg),
                                device="cuda"),
             ("mg_down_2d_masked", "mg_up_2d_masked") + OBST2_PATH,
             OBST_SOR_STEP.get("2d"), NOT_ON_OBSTACLE2D_PATHS
             + ("rb_sor_checkerboard_masked",)),
            ("NS-3D canal3d_obstacle 512x128x128 f32 mg",
             lambda: NS3DSolver(obstacle_config(**OBST_MAIN, **mg),
                                device="cuda"),
             ("mg_down_3d_masked", "mg_up_3d_masked") + OBST_PATH,
             OBST_SOR_STEP.get("3d"), NOT_ON_OBSTACLE_PATHS
             + ("rb_sor3d_checkerboard_masked",))):
        s = make()
        rec = dispatch.snapshot()
        c, r = drive_path(kb, label, kernels, lambda: timed_steps(
            torch, s, 16, MG_OBST_CYCLES))
        check_not_launched_mg(c, label, not_on)
        counts.append(c)
        fields = [s.u, s.v, s.p] + ([s.w] if hasattr(s, "w") else [])
        finite = all(bool(torch.isfinite(x).all()) for x in fields)
        ok = finite and s.nt == 17 and s.last_it == MG_OBST_CYCLES
        cyc = r["cycle"]
        key = "mg2d_obstacle_fused" if "NS-2D" in label else \
            "mg3d_obstacle_fused"
        down = [k for k in kernels if "down" in k][0]
        log(f"{label} (re 100, eps 0, {MG_OBST_CYCLES} V-cycles a step, "
            f"L={len(s._solve.levels)}, {rec.get(key)}): "
            f"{r['ms_per_step']:.3f} ms/step (host clock); PRE "
            f"{r['pre']:.3f} / solve {r['solve']:.3f} / POST {r['post']:.3f}"
            f" ms (CUDA events); V-cycle: DOWN {cyc['down']:.4f} / bottom "
            f"{cyc['bottom']:.4f} / UP {cyc['up']:.4f} / residual check "
            f"{cyc['check']:.4f} ms (CUDA events, the same 16 steps); "
            f"cycles a step {s.last_it}, DOWN calls {c[down]}; finite "
            f"{finite} {'ok' if ok else 'FAIL'}")
        if sor is not None:
            log(f"{label}: {r['ms_per_step']:.3f} ms/step beside the masked "
                f"SOR step of this run (itermax 100, eps 0, n=4) "
                f"{sor['ms_per_step']:.3f} ms/step, solve {r['solve']:.3f} "
                f"vs {sor['solve']:.3f} ms")
        if not ok:
            bad.append(label)
        del s
        torch.cuda.empty_cache()
    # the ladder (tpu_mg_fused off): its large levels smooth through masked
    # K2 at omega = 1
    s = NS2DSolver(obstacle2d_config(*OBST2_MAIN, tpu_mg_fused="off", **mg),
                   device="cuda")
    label = "NS-2D canal_obstacle 8192x2048 f32 mg ladder"
    c, r = drive_path(kb, label, ("rb_sor_checkerboard_masked",)
                      + OBST2_PATH, lambda: timed_steps(torch, s, 4))
    check_not_launched_mg(c, label, ("mg_down_2d_masked", "mg_up_2d_masked"))
    counts.append(c)
    finite = all(bool(torch.isfinite(x).all()) for x in (s.u, s.v, s.p))
    log(f"{label} (tpu_mg_fused off, {MG_OBST_CYCLES} V-cycles a step, 4 "
        f"steps): {r['ms_per_step']:.3f} ms/step (host clock), solve "
        f"{r['solve']:.3f} ms (CUDA events); masked K2 launches "
        f"{c['rb_sor_checkerboard_masked']}; finite {finite} "
        f"{'ok' if finite and s.nt == 5 else 'FAIL'}")
    if not (finite and s.nt == 5):
        bad.append(label)
    del s
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"obstacle mg paths failed: {bad}")
    return counts


MG_OBST_RUNS = {}
# the CLI runs of tpu_solver auto on the obstacle configs held card vs CPU:
# (config, NS dimension, te)
MG_OBST_CLI = (("canal_obstacle.par", 2, 0.5),
               ("canal3d_obstacle.par", 3, 0.5))
MG_OBST2048_TE = 0.1


@phase("tpu_solver auto on the obstacle configs: the CPU runs started in "
       "processes of their own")
def obstacle_mg_cli_start():
    tmp = tempfile.mkdtemp(prefix="obstacle_mg_")
    MG_OBST_RUNS["tmp"] = tmp
    env = dict(os.environ, OMP_NUM_THREADS="2")
    for src, ndim, te in MG_OBST_CLI:
        d = os.path.join(tmp, f"cpu_{src}")
        os.makedirs(d)
        par = os.path.join(d, src)
        with open(par, "w") as fh:
            fh.write(config_text(src, te=te, tpu_solver="auto", tpu_mesh="1",
                                 tpu_vtk="binary"))
        out = os.path.join(d, "fields.npz")
        MG_OBST_RUNS[src] = (out, start(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             f"--cli{ndim}-child", par, out, "cpu"], d,
            os.path.join(d, "child.log"), env))


@phase(f"main path: python -m pampi_tpu_torch with tpu_solver auto (obstacle "
       f"multigrid) on configs/canal_obstacle.par and canal3d_obstacle.par "
       f"(te 0.5) on the card against the CPU, and canal_obstacle2048.par "
       f"(te {MG_OBST2048_TE}) on the card")
def obstacle_mg_cli(np):
    from pampi_tpu_torch.kernels import build as kb

    if not all(src in MG_OBST_RUNS for src, _n, _te in MG_OBST_CLI):
        raise AssertionError("the CPU child runs did not start")
    tmp = MG_OBST_RUNS["tmp"]
    counts, bad = [], []
    for src, ndim, te in MG_OBST_CLI + (("canal_obstacle2048.par", 2,
                                         MG_OBST2048_TE),):
        d = os.path.join(tmp, f"card_{src}")
        os.makedirs(d)
        path = os.path.join(d, src)
        with open(path, "w") as fh:
            fh.write(config_text(src, te=te, tpu_solver="auto", tpu_mesh="1",
                                 tpu_vtk="binary"))
        kernels = ((f"mg_down_{ndim}d_masked", f"mg_up_{ndim}d_masked")
                   + (OBST2_PATH if ndim == 2 else OBST_PATH))
        cwd = os.getcwd()
        os.chdir(d)
        try:
            c, (rc, secs, _c, got) = drive_path(
                kb, f"{src} te {te} auto CLI", kernels,
                lambda: run_cli_ns(path, "cuda", ndim))
        finally:
            os.chdir(cwd)
        check_not_launched_mg(c, f"the {src} CLI run")
        counts.append(c)
        names = ("u", "v", "p") if ndim == 2 else ("ug", "vg", "wg", "pg")
        finite = rc == 0 and all(np.isfinite(got[k]).all() for k in names)
        rec = json.loads(got["record"]) if finite else {}
        key = f"mg{ndim}d_obstacle_fused"
        log(f"{src} te {te} tpu_solver auto (f64) on one card: rc {rc}, "
            f"{got.get('nt')} steps to t={got.get('t', float('nan')):.6f} in "
            f"{secs:.1f} s (wall, the CLI's whole run); "
            f"{rec.get('solver_auto')}; {rec.get(key)}; DOWN calls "
            f"{c[kernels[0]]}; fields finite {finite}")
        if not finite or "fused" not in str(rec.get(key)):
            bad.append(f"{src} card")
            continue
        if src not in MG_OBST_RUNS:
            continue
        out, proc = MG_OBST_RUNS[src]
        crc = proc.wait(timeout=900)
        if crc != 0:
            log(open(os.path.join(os.path.dirname(out),
                                  "child.log")).read()[-4000:])
            bad.append(f"{src} cpu exited {crc}")
            continue
        with np.load(out) as z:
            cpu = {k: z[k] for k in z.files}
        scale = max(1.0, *(float(np.abs(got[k]).max()) for k in names))
        diff = max(float(np.abs(cpu[k] - got[k]).max()) for k in names)
        ok = diff <= 1e-9 * scale and int(cpu["nt"]) == got["nt"]
        log(f"{src} te {te} tpu_solver auto on the CPU (its own process): "
            f"{int(cpu['nt'])} steps in {float(cpu['secs']):.1f} s (card: "
            f"{got['nt']}), t equal {float(cpu['t']) == got['t']}; max "
            f"|cpu - card| over {', '.join(names)} {diff:.3e} (tol 1e-9 of "
            f"scale {scale:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"{src} card vs cpu")
    if bad:
        raise AssertionError(f"obstacle mg CLI runs failed: {bad}")
    return counts


# ----------------------------------------------------------------------
# NS-3D on a mesh that does not divide the grid: the ragged pad-with-mask
# decomposition, K8's ragged mode and K7 at uneven shard bounds
# ----------------------------------------------------------------------

RAGGED_MESH = (1, 2, 3)  # the ragged main paths' mesh: 128 and 512 by 3
RAGGED_BOX = "0.3,0.3,0.3,0.7,0.7,0.7"  # flags for the unit-box grids
RAGGED_RUNS = {}
# the ragged CLI runs: (name, config, tpu_mesh, te, the CPU half's te): on
# the card on the mesh to te, held against one card; on the CPU on the
# mesh to the cut te (one step: the CPU half is host-bound, ~2 minutes a
# step of canal3d.par beside the other processes), held against one card
# at that te
RAGGED_CLI = (("canal3d", "canal3d.par", "2x3x3", 0.1, 0.04),
              ("obstacle", "canal3d_obstacle.par", "3x3x3", 0.1, 0.04))


def ragged3d_configs():
    """The ragged main paths' runs: configs/dcavity3d.par (128³ float32,
    re 1000) and canal3d_obstacle.par's geometry at 512x128x128 float32
    (re 100), each with itermax 100 and eps 0, on RAGGED_MESH."""
    kw = dict(itermax=100, eps=0.0, te=1e9, tpu_sor_inner=4,
              tpu_mesh="x".join(map(str, RAGGED_MESH)))
    return (config("dcavity3d.par", **kw),
            obstacle_config(**OBST_MAIN, tpu_dtype="float32", re=100.0,
                            **kw))


def ragged_check_cases(torch):
    """(param, mesh dims, dtype) of phase 2's ragged K7/K8 checks: every
    shard of dcavity3d 128³ on 1x2x3 and of 9x64x64 on 4x1x1 (its last
    shard holds only the HI ghost plane and dead cells), plain and with a
    box's flags, and of the obstacle path's 512x128x128 on 1x2x3, at
    float32 and float64."""
    from pampi_tpu_torch.utils.params import Parameter

    dcav, obst = ragged3d_configs()
    thin = Parameter(name="dcavity3d", imax=64, jmax=64, kmax=9, re=1000.0)
    cases = []
    for dtype in (torch.float32, torch.float64):
        for param, dims in ((dcav, RAGGED_MESH), (thin, (4, 1, 1))):
            cases += [(param, dims, dtype),
                      (param.replace(obstacles=RAGGED_BOX), dims, dtype)]
        cases.append((obst, RAGGED_MESH, dtype))
    return cases


@phase("K8's ragged mode and K7 at uneven shard bounds vs plain versions")
def check_ragged3d_kernels(torch, np):
    bad = []
    for param, dims, dtype in ragged_check_cases(torch):
        t = tol(torch, dtype)
        exact, e, err = check_step3d_dist(torch, np, dims, param, dtype, 231,
                                          ragged=True)
        ok = exact and e <= t
        mode = "flags" if param.obstacles.strip() else "plain"
        shape = f"{param.kmax}x{param.jmax}x{param.imax}"
        log(f"ns3d_pre/post ragged {mode} {dtype} {shape} on "
            f"{'x'.join(map(str, dims))}, every shard: u', v', w', maxima and"
            f" dead cells bitwise {exact}, max_rel_err {e:.3e}, max_abs_err "
            f"{err:.3e} (tol {t:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"{mode} {shape} {dtype}")
    if bad:
        raise AssertionError(f"ragged K7/K8 disagree: {bad}")


def last_shard(param, dims):
    """(local extents, offsets) of a mesh's last shard, the one the
    ceil division leaves ragged."""
    G = (param.kmax, param.jmax, param.imax)
    local = tuple(-(-n // d) for n, d in zip(G, dims))
    return local, tuple((d - 1) * n for d, n in zip(dims, local))


@phase("K8's ragged mode and K7 at uneven bounds: times at the ragged "
       "paths' last shards")
def time_ragged3d(torch, np):
    from pampi_tpu_torch.ops import ns3d_fused as nf3

    rows = {}
    for param, post, pre in zip(ragged3d_configs(),
                                ("ns3d_post_ragged", "ns3d_post_flags_ragged"),
                                ("ns3d_pre", "ns3d_pre_flags")):
        cfg = nf3.StepConfig3D.from_param(param)
        G = (param.kmax, param.jmax, param.imax)
        local, offs = last_shard(param, RAGGED_MESH)
        flags = (None, None)
        if param.obstacles.strip():
            fluid = obstacle_fluid(param)
            flags = tuple(shard_flags(fluid, offs, local, H) for H in (3, 1))
        u, v, w = rng_fields(torch, np, tuple(n + 6 for n in local),
                             torch.float32, 3, 241)
        (p,) = rng_fields(torch, np, tuple(n + 2 for n in local),
                          torch.float32, 1, 244)
        dt = torch.tensor(1e-3, dtype=torch.float32, device="cuda")
        exact, e, err, fk, h1 = step3d_shard(torch, cfg, offs, G, u, v, w, p,
                                             dt, flags, ragged=True)
        if not (exact and e <= tol(torch, torch.float32)):
            raise AssertionError(f"{post} / {pre} differ at the timed shard")
        uk, vk, wk = u.clone(), v.clone(), w.clone()
        size, one = 4, 1 if flags[0] is not None else 0
        deep = math.prod(n + 6 for n in local)
        ext = math.prod(n + 2 for n in local)
        cells = math.prod(local)
        ms = cuda_ms(torch, lambda: nf3.ns3d_pre(
            uk, vk, wk, dt, cfg, offs, G, 2, flags=flags[0]), 20)
        pms = cuda_ms(torch, lambda: nf3.ns3d_pre_plain(
            u, v, w, dt, cfg, offs, G, 2, flags=flags[0]), 3)
        # PRE: the three deep blocks (and their flags) read, F, G, H, rhs
        # written on the halo-1 block; ~190 flops a cell
        bpre = bound((3 * deep + 4 * ext) * size + deep * one, 190 * cells)

        def post_call(ragged):
            return lambda: nf3.ns3d_post(*h1, *fk[:3], p, dt, cfg.dx, cfg.dy,
                                         cfg.dz, offs, G, flags=flags[1],
                                         ragged=ragged)

        qms = cuda_ms(torch, post_call(True), 20)
        ums = cuda_ms(torch, post_call(False), 20)
        qpms = cuda_ms(torch, lambda: nf3.ns3d_post_plain(
            *h1, *fk[:3], p, dt, cfg.dx, cfg.dy, cfg.dz, offs, G, flags[1],
            True), 3)
        calls = cuda_launches(torch, post_call(True))
        # POST: F, G, H, p read and u, v, w written (7 field-sizes; the
        # flags 1 byte a cell more); ~15 flops a cell
        bpost = bound(7 * ext * size + ext * one, 15 * cells)
        shape = (f"{'x'.join(map(str, local))} shard at {offs} of "
                 f"{'x'.join(map(str, G))} on "
                 f"{'x'.join(map(str, RAGGED_MESH))}")
        rows[post] = dict(max_abs_err=err, ms=qms, plain_ms=qpms,
                          bound_ms=bpost[0], bound_by=bpost[1],
                          unragged_ms=ums, cuda_launches_a_call=calls,
                          shape=shape)
        rows[pre] = dict(ragged_ms=ms, ragged_plain_ms=pms,
                         ragged_bound_ms=bpre[0], ragged_bound_by=bpre[1],
                         ragged_max_abs_err=err, ragged_shape=shape)
        log(f"{pre} at uneven bounds f32 ({shape}, deep block "
            f"{tuple(n + 6 for n in local)}): {ms:.4f} ms per shard call "
            f"(plain {pms:.4f}, bound {bpre[0]:.4f} by {bpre[1]}); {post}: "
            f"{qms:.4f} ms (its unragged mode on the same block {ums:.4f}, "
            f"plain {qpms:.4f}, bound {bpost[0]:.4f} by {bpost[1]}), "
            f"{launches_text(calls)} CUDA launches a call")
    return rows


NOT_ON_RAGGED_PATHS = ("rb_sor_odist", "rb_sor_obsdist3d", "rb_sor3d_octants",
                       "rb_sor3d_octants_onchip", "rb_sor3d_checkerboard",
                       "ns3d_post", "ns3d_post_flags")


def check_launched(counts, kernels, label):
    """Every kernel of a path run in a process of its own was launched."""
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label} did not launch {missing}")


def check_not_launched_ragged(counts, label, also=()):
    """K14 and K16 (divisible meshes only), K6 and K5 (one device) and K8's
    unragged modes never run on a ragged path."""
    wrong = [k for k in NOT_ON_RAGGED_PATHS + also if counts.get(k, 0)]
    if wrong:
        raise AssertionError(f"{label} launched {wrong}")


@phase("main path: NS-3D on the ragged 1x2x3: configs/dcavity3d.par 128³ "
       "and canal3d_obstacle.par's geometry at 512x128x128, float32")
def main_path_ragged3d(torch):
    from pampi_tpu_torch.kernels import build as kb
    from pampi_tpu_torch.models.ns3d import NS3DSolver
    from pampi_tpu_torch.models.ns3d_dist import NS3DDistSolver
    from pampi_tpu_torch.parallel.comm import CartComm
    from pampi_tpu_torch.utils import dispatch

    counts = []
    for param, steps, path, also in (
            (ragged3d_configs()[0], 16, ("ns3d_pre", "ns3d_post_ragged"),
             ("ns3d_pre_flags", "ns3d_post_flags_ragged")),
            (ragged3d_configs()[1], 7,
             ("ns3d_pre_flags", "ns3d_post_flags_ragged"),
             ("ns3d_pre", "ns3d_post_ragged"))):
        s = NS3DDistSolver(param, CartComm(ndims=3, dims=RAGGED_MESH))
        label = (dispatch.last("ns3d_dist"), dispatch.last("obstacle3d_dist")
                 if param.obstacles.strip() else None)
        s.comm.print_config()
        c, r = drive_path(kb, f"NS-3D ragged {param.name} "
                          f"{'x'.join(map(str, RAGGED_MESH))}", path,
                          lambda: dist2d_steps(torch, s, steps))
        check_not_launched_ragged(c, "a ragged path", also)
        counts.append(c)
        single = NS3DSolver(param.replace(tpu_mesh="1"), device="cuda")
        single.run_steps(steps + 1)
        diff, scale = global_diff(s, single)
        step = r["pre"] + r["solve"] + r["post"]
        ok = s.ragged and s.nt == single.nt and diff <= 1e-5 * scale
        shape = f"{param.kmax}x{param.jmax}x{param.imax}"
        log(f"NS-3D {param.name} {shape} f32 on the ragged "
            f"{'x'.join(map(str, RAGGED_MESH))} ({s.kl}x{s.jl}x{s.il} "
            f"shards, {label}): {r['ms']:.3f} ms/step over {steps} steps "
            f"after a warm-up (host clock); PRE {r['pre']:.3f} / solve "
            f"{r['solve']:.3f} / POST {r['post']:.3f} ms (CUDA events); "
            f"exchanges {r['exchange']:.3f} ms/step, share "
            f"{r['exchange'] / step:.3f} of the step; t={s.t:.6e}, "
            f"single-device t={single.t:.6e}; max |mesh - one device| "
            f"{diff:.3e} (limit {1e-5 * scale:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the ragged {param.name} run disagrees "
                                 "with one device")
        del s, single
        torch.cuda.empty_cache()
    return counts


@phase("ragged NS-3D CLI runs: the card's mesh runs and the CPU runs started "
       "in processes of their own")
def ragged3d_cli_start():
    tmp = tempfile.mkdtemp(prefix="ragged3d_")
    RAGGED_RUNS["tmp"] = tmp
    env = dict(os.environ, OMP_NUM_THREADS="2")
    for name, src, mesh, te, te_cpu in RAGGED_CLI:
        for device, t in (("cuda", te), ("cpu", te_cpu)):
            d = os.path.join(tmp, f"{name}_{device}")
            os.makedirs(d)
            par = os.path.join(d, src)
            with open(par, "w") as fh:
                fh.write(config_text(src, te=t, tpu_mesh=mesh))
            out = os.path.join(d, "fields.npz")
            RAGGED_RUNS[name, device] = (out, start(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                 "--cli3-child", par, out, device], d,
                os.path.join(d, "child.log"), env))


@phase("main path: python -m pampi_tpu_torch on ragged meshes: "
       "configs/canal3d.par on 2x3x3 and canal3d_obstacle.par on 3x3x3, "
       "card against one card and against the CPU")
def ragged3d_cli(np):
    from pampi_tpu_torch.kernels import build as kb

    if "tmp" not in RAGGED_RUNS:
        raise AssertionError("the child runs did not start")
    tmp = RAGGED_RUNS["tmp"]
    counts, bad = [], []
    names = ("ug", "vg", "wg", "pg")
    for name, src, mesh, te, te_cpu in RAGGED_CLI:
        obst = name == "obstacle"
        one = {}
        for t in (te, te_cpu):
            d = os.path.join(tmp, f"{name}_one_{t}")
            os.makedirs(d)
            par = os.path.join(d, src)
            with open(par, "w") as fh:
                fh.write(config_text(src, te=t, tpu_mesh="1"))
            cwd = os.getcwd()
            os.chdir(d)
            try:
                rc, secs, _c, one[t] = run_cli_ns(par, "cuda", 3)
            finally:
                os.chdir(cwd)
            if rc != 0:
                raise AssertionError(f"the one-card {src} te {t} run exited "
                                     f"{rc}")
        runs = {}
        for device in ("cuda", "cpu"):
            out, proc = RAGGED_RUNS[name, device]
            crc = proc.wait(timeout=900)
            if crc != 0:
                log(open(os.path.join(os.path.dirname(out),
                                      "child.log")).read()[-4000:])
                raise AssertionError(f"the {name} {device} child exited "
                                     f"{crc}")
            with np.load(out) as z:
                runs[device] = {k: z[k] for k in z.files}
        card = runs["cuda"]
        c = json.loads(str(card["counts"]))
        path = ("ns3d_pre_flags", "ns3d_post_flags_ragged") if obst else (
            "ns3d_pre", "ns3d_post_ragged")
        log(f"{src} tpu_mesh {mesh} CLI launches: {json.dumps(c)}")
        check_launched(c, path, f"the {src} {mesh} CLI run")
        check_not_launched_ragged(c, f"the {src} {mesh} CLI run")
        counts.append(c)
        rec = json.loads(str(card["record"]))
        label = rec.get("obstacle3d_dist" if obst else "ns3d_dist")
        for who, run, t in (("the card", card, te),
                            ("the CPU", runs["cpu"], te_cpu)):
            ref = one[t]
            scale = max(1.0, *(float(np.abs(ref[k]).max()) for k in names))
            diff = max(float(np.abs(run[k] - ref[k]).max()) for k in names)
            ok = int(run["nt"]) == int(ref["nt"]) and diff <= 1e-9 * scale
            log(f"{src} te {t} f64 tpu_mesh {mesh} ({label}) on {who}, its "
                f"own process: {int(run['nt'])} steps in "
                f"{float(run['secs']):.1f} s; one card: {int(ref['nt'])} "
                f"steps; max |mesh - one card| over the cell-centred u, v, "
                f"w, p {diff:.3e} (tol 1e-9 of scale {scale:.3e}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"{src} {mesh} te {t} on {who}")
    if bad:
        raise AssertionError(f"ragged CLI runs disagree: {bad}")
    return counts


# ----------------------------------------------------------------------
# the fleet's shape-class mg lane: K18, the one-launch class V-cycle
# ----------------------------------------------------------------------

CARD = "cuda"          # where the fleet phases run
CLASS_CHECK = (16, 64, 256)
FLEET_A = 256          # bucket A: dcavity mg requests in the 64² class
FLEET_B = 32           # bucket B: canal mg requests in the 256² class
FLEET_B_STEPS = 20     # each bucket-B lane's te is ~this many first steps


def class_inputs(torch, np, cls, lanes, dtype, seed, active=None):
    """Lane-stacked K18 inputs in a cls² class for (jmax, imax) lanes of
    unit length: random p on each lane's live corner, random rhs on its
    interior, 0 elsewhere; the lanes' level plans; active (N,) int32."""
    from pampi_tpu_torch.ops import mg_fused as mf

    rng = np.random.default_rng(seed)
    n, lmax = len(lanes), mf.class_level_max(cls, cls)
    p = np.zeros((n, cls + 2, cls + 2))
    rhs = np.zeros((n, cls + 2, cls + 2))
    plans = []
    for k, (jl, il) in enumerate(lanes):
        p[k, :jl + 2, :il + 2] = rng.normal(size=(jl + 2, il + 2))
        rhs[k, 1:jl + 1, 1:il + 1] = rng.normal(size=(jl, il))
        plans.append(mf.class_level_plan(jl, il, float(il * il),
                                          float(jl * jl), lmax, dtype))
    act = torch.tensor([1] * n if active is None else active,
                       dtype=torch.int32, device=CARD)
    return (torch.from_numpy(p).to(CARD, dtype),
            torch.from_numpy(rhs).to(CARD, dtype),
            torch.stack([e for e, _ in plans]).to(CARD),
            torch.stack([g for _, g in plans]).to(CARD), act)


def check_class(torch, inputs, calls=3):
    """`calls` chained cycles of K18 and of its plain version on the same
    inputs. Returns (bitwise, max_abs_err, the kernel's last p, rsq)."""
    from pampi_tpu_torch.ops import mg_fused as mf

    p, rhs, ext, geo, act = inputs
    pk = pp = p
    same, err = True, 0.0
    for _ in range(calls):
        pk, rk = mf.class_cycle(pk, rhs, ext, geo, act)
        pp, rp = mf.class_cycle_plain(pp, rhs, ext, geo, act)
        same = same and torch.equal(pk, pp) and torch.equal(rk, rp)
        err = max(err, float((pk - pp).abs().max()),
                  float((rk - rp).abs().max()))
    return same, err, pk, rk


def fleet_lanes_a():
    """Bucket A's (jmax, imax): tools/perf_fleet.py --classes at its TPU
    size, imax = 48 + i%17, jmax = 64 - i%17."""
    return [(64 - i % 17, 48 + i % 17) for i in range(FLEET_A)]


@phase("class V-cycle kernel K18 vs its plain version (16², 64², 256², "
       "float32/float64) and 50 repeated class solves")
def check_class_kernel(torch, np):
    from pampi_tpu_torch.fleet import shapeclass as sc
    from pampi_tpu_torch.utils.params import Parameter

    bad = []
    for dtype in (torch.float32, torch.float64):
        for cls in CLASS_CHECK:
            # a full-class lane, an odd one (one level: the bottom sweeps
            # run at level 0), one whose plan stops early, a ragged one,
            # an inactive one
            lanes = [(cls, cls), (9, 13), (12, 12), (cls - 3, cls - 1),
                     (cls, cls)]
            inputs = class_inputs(torch, np, cls, lanes, dtype, 501 + cls,
                                  active=[1, 1, 1, 1, 0])
            same, err, pk, rk = check_class(torch, inputs)
            passed = (torch.equal(pk[4], inputs[0][4])
                      and float(rk[4]) == 0.0)
            ok = same and passed
            log(f"mg_class_cycle_2d {cls}² {dtype}, lanes {lanes[:4]} + an "
                f"inactive one, 3 chained cycles: fields and rsq bitwise "
                f"{same}, max_abs_err {err:.3e}, inactive lane passed "
                f"{passed} {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"{cls} {dtype}")
    # 50 class solves of one batch (8 lanes of the 64² class, f32)
    dtype = torch.float32
    lanes = fleet_lanes_a()[:8]
    params = [Parameter(name="dcavity", imax=i, jmax=j, eps=1e-3,
                        itermax=30, tpu_solver="mg") for j, i in lanes]
    gm = np.array([sc.lane_geometry(q) for q in params])
    cl = sc.class_lanes(gm, 64, 64, dtype, CARD, mg=True)
    solve = sc.make_class_mg_solve(params[0], 64, 64, dtype, CARD)
    p0, rhs, *_ = class_inputs(torch, np, 64, lanes, dtype, 509)
    p0 = torch.zeros_like(p0)
    for k, (j, i) in enumerate(lanes):  # a zero-mean rhs: the solves converge
        inner = rhs[k, 1:j + 1, 1:i + 1]
        inner -= inner.mean()
    runs = [solve(p0, rhs, cl, np.ones(len(lanes), bool))
            for _ in range(50)]
    same = all(torch.equal(r[0], runs[0][0]) and (r[2] == runs[0][2]).all()
               and (r[1] == runs[0][1]).all() for r in runs)
    log(f"50 class solves, 8 lanes of the 64² class f32 (eps 1e-3, itermax "
        f"30): V-cycles per lane {runs[0][2].tolist()}, identical counts, "
        f"residuals and bitwise fields {same} {'ok' if same else 'FAIL'}")
    if not same:
        bad.append("50 repeated class solves")
    if bad:
        raise AssertionError(f"K18 differs from its plain version: {bad}")


def class_work(ext_rows, size, n_pre=2, n_post=2, n_bottom=8):
    """(bytes, operations) of one K18 cycle of one lane, from its plan:
    the fine p and rhs read and p written, every live coarser level's p
    and rhs once; ~12 operations a cell update (n_pre + n_post sweeps a
    live level, n_bottom more at the deepest), ~14 a fine cell for the
    restriction, 1 for the prolongation, 13 for the residual sum."""
    from pampi_tpu_torch.ops import mg_fused as mf

    levels = mf._live_levels(ext_rows)
    cells = [(j + 2) * (i + 2) for j, i in levels]
    nbytes = (3 * cells[0] + 2 * sum(cells[1:])) * size
    ops = 13 * levels[0][0] * levels[0][1]
    for lvl, (j, i) in enumerate(levels):
        sweeps = n_pre + n_post + (n_bottom if lvl == len(levels) - 1
                                   else 0)
        ops += 12 * sweeps * j * i
        if lvl + 1 < len(levels):
            ops += 15 * j * i
    return nbytes, ops


@phase("K18 at the fleet main path's shape (bucket A: 256 lanes of the 64² "
       "class, float32) and its time beside the bound")
def time_class_kernel(torch, np):
    from pampi_tpu_torch.ops import mg_fused as mf

    dtype = torch.float32
    lanes = fleet_lanes_a()
    inputs = class_inputs(torch, np, 64, lanes, dtype, 511)
    same, err, _pk, _rk = check_class(torch, inputs, calls=1)
    if not same:
        raise AssertionError("K18 differs from its plain version at bucket "
                             "A's shape")
    p, rhs, ext, geo, act = inputs
    work = torch.empty(len(lanes) * mf.class_work_cells(64, 64,
                                                        ext.shape[1]),
                       dtype=dtype, device=CARD)
    ms = cuda_ms(torch, lambda: mf.class_cycle(p, rhs, ext, geo, act,
                                               work=work), 20)
    pms = cuda_ms(torch, lambda: mf.class_cycle_plain(p, rhs, ext, geo,
                                                      act), 1)
    nbytes = ops = 0
    for rows in ext.tolist():
        b, o = class_work(rows, 4)
        nbytes, ops = nbytes + b, ops + o
    b = bound(nbytes, ops)
    shape = (f"256 lanes of the 64² class f32 (imax 48..64, jmax 48..64), "
             f"one V-cycle each")
    log(f"mg_class_cycle_2d {shape}: {ms:.4f} ms per call (plain {pms:.4f}),"
        f" bound {b[0]:.5f} ms by {b[1]} (bytes {nbytes / 1e6:.2f} MB over "
        f"3.35 TB/s = {nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms; operations "
        f"{ops / 1e6:.1f} M over 67 TFLOP/s = {ops / FP32_FLOPS * 1e3:.5f} "
        f"ms); bitwise its plain version")
    return {"mg_class_cycle_2d": dict(
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
        bound_bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        bound_operations_ms=ops / FP32_FLOPS * 1e3, shape=shape)}


def fleet_requests(torch, sid0="", solver="mg"):
    """(bucket A, bucket B) requests of the fleet main path, f32: A 256
    dcavity requests in the 64² class (tools/perf_fleet.py --classes at
    its TPU size, itermax 10: V-cycles under mg, iterations under sor), B
    32 canal requests in the 256² class with configs/canal.par's physics
    on a square box (xlength cut from 30 to its ylength 4: on the 30x4 box
    these grids' cells are 4.7-9.8 times longer than high, and the class
    V-cycle, point red-black Gauss-Seidel with piecewise-constant
    prolongation as on the TPU, diverges there), each lane's te 20 of its
    first steps' dt (tau·dt_bound: the inflow's CFL limit is larger),
    itermax 20 V-cycles under mg and canal.par's own itermax 500 and eps
    1e-5 under sor."""
    from pampi_tpu_torch.fleet import ScenarioRequest
    from pampi_tpu_torch.fleet import shapeclass as sc
    from pampi_tpu_torch.utils.params import read_parameter

    a = [ScenarioRequest(f"{sid0}a{i}", pa) for i, pa in enumerate(
        read_parameter(os.path.join(ROOT, "configs", "dcavity.par")).replace(
            imax=48 + i % 17, jmax=64 - i % 17, re=10.0, te=0.05, tau=0.5,
            eps=1e-4, omg=1.7, gamma=0.9, u_init=0.001 * i, itermax=10,
            tpu_solver=solver, tpu_dtype="float32", tpu_mesh="1")
        for i in range(FLEET_A))]
    canal = read_parameter(os.path.join(ROOT, "configs", "canal.par"))
    b = []
    for i in range(FLEET_B):
        q = canal.replace(imax=256 - 2 * i, jmax=160 + 3 * i,
                          itermax=20 if solver == "mg" else canal.itermax,
                          xlength=canal.ylength, tpu_solver=solver,
                          tpu_dtype="float32", tpu_mesh="1")
        dtb = sc.lane_geometry(q)[sc.G_DTB]
        b.append(ScenarioRequest(f"{sid0}b{i}", q.replace(
            te=FLEET_B_STEPS * q.tau * dtb)))
    return a, b


@contextlib.contextmanager
def class_cycle_events(torch, calls):
    """Wrap K18's wrapper so that each call records CUDA events, kept in
    calls[class width] (the fleet looks the wrapper up at call time, so
    this times the path's own calls and adds no launch)."""
    from pampi_tpu_torch.ops import mg_fused as mf

    inner = mf.class_cycle

    def timed(p, *a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = inner(p, *a, **kw)
        ev[1].record()
        calls.setdefault(p.shape[-1] - 2, []).append(ev)
        return out

    mf.class_cycle = timed
    try:
        yield
    finally:
        mf.class_cycle = inner


@phase("main path: the fleet's mg class lane on the card, f32: 256 dcavity "
       "requests in the 64² class and 32 canal requests in the 256² class, "
       "cold and warm; four of them alone in the 128² class")
def main_path_fleet(torch):
    import numpy as np

    from pampi_tpu_torch.fleet import BatchedSolver, FleetScheduler
    from pampi_tpu_torch.fleet import shapeclass as sc
    from pampi_tpu_torch.kernels import build as kb

    sched = FleetScheduler(classes="on", device=CARD)
    runs, calls = {}, {}

    def serve():
        for name in ("cold", "warm"):
            a, b = fleet_requests(torch, "" if name == "cold" else "w")
            for r in a + b:
                sched.submit(r)
            calls.clear()
            with class_cycle_events(torch, calls):
                runs[name] = sched.run()
            torch.cuda.synchronize()
            runs[name + "_calls"] = {
                w: (len(ev), sum(x.elapsed_time(y) for x, y in ev))
                for w, ev in calls.items()}
        # four of bucket A's requests alone in the 128² class
        a, _b = fleet_requests(torch)
        four = [a[k] for k in (0, 5, 16, min(200, FLEET_A - 1))]
        tpl = sc.ClassSolver(four[0].param, ic=128, jc=128, device=CARD)
        batch = BatchedSolver(tpl, [r.param for r in four],
                              [r.sid for r in four])
        runs["128"] = batch.results(batch.run())

    counts, _ = drive_path(kb, "fleet class lane", ("mg_class_cycle_2d",),
                           serve)
    others = [k for k, v in counts.items()
              if v and k != "mg_class_cycle_2d"]
    if others:
        raise AssertionError(f"the class path launched {others}")
    bad = []
    for name in ("cold", "warm"):
        res = runs[name]
        n_bad = [s.sid for s in res.scenarios
                 if s.diverged or not all(np.isfinite(f).all()
                                          for f in s.fields)]
        if n_bad or len(res.scenarios) != FLEET_A + FLEET_B:
            bad.append(f"{name}: {len(n_bad)} lanes not finite or diverged")
        for row in res.summary["buckets"]:
            n_calls, ms = runs[name + "_calls"].get(row["grid"][0], (0, 0.0))
            nts = [s.nt for s in res.scenarios if s.bucket == row["bucket"]]
            div = [s.sid for s in res.scenarios
                   if s.bucket == row["bucket"] and s.diverged]
            if div:
                log(f"diverged in {row['grid']}: {div}")
            log(f"fleet {name} bucket {row['grid']} ({row['lanes']} lanes, "
                f"mode {row['mode']}): set-up {row['compile_wall_s']:.3f} s, "
                f"run {row['run_wall_s']:.4f} s, {row['chunks']} chunks, "
                f"{row['run_wall_s'] / max(1, row['chunks']) * 1e3:.2f} ms "
                f"per chunk; steps per lane {min(nts)}..{max(nts)}; K18 "
                f"{n_calls} calls, {ms / max(1, n_calls):.4f} ms per call "
                f"(CUDA events), {ms:.2f} ms in all")
            if row["mode"] != "class":
                bad.append(f"{row['bucket']} ran {row['mode']}")
        log(f"fleet {name}: {res.summary['n_scenarios']} scenarios, "
            f"{res.summary['scenarios_per_s']} scenarios/s (run walls), "
            f"diverged {res.summary['divergence_census']['diverged']}")
    b_nts = [s.nt for s in runs["cold"].scenarios if s.sid.startswith("b")]
    if not 15 <= min(b_nts) <= max(b_nts) <= 30:
        bad.append(f"bucket B lanes ran {min(b_nts)}..{max(b_nts)} steps")
    # the warm run serves the same requests: bitwise the cold one
    cold, warm = runs["cold"], runs["warm"]
    differ = [s.sid for s in cold.scenarios
              if s.nt != warm.by_sid("w" + s.sid).nt or not all(
                  np.array_equal(x, y, equal_nan=True) for x, y in
                  zip(s.fields, warm.by_sid("w" + s.sid).fields))]
    log(f"warm run bitwise the cold one: {not differ}")
    if differ:
        bad.append(f"warm differs from cold in {differ}")
    same = all(r["nt"] == cold.by_sid(r["sid"]).nt and all(
        np.array_equal(x, y) for x, y in zip(
            r["fields"], cold.by_sid(r["sid"]).fields))
        for r in runs["128"])
    log(f"four bucket-A requests alone in the 128² class: steps "
        f"{[r['nt'] for r in runs['128']]}, fields bitwise their 64²-class "
        f"lanes {same} {'ok' if same else 'FAIL'}")
    if not same:
        bad.append("the 128² re-run differs")
    if bad:
        raise AssertionError(f"fleet main path: {bad}")
    return counts


@phase("the fleet card vs CPU, float64: 8 mg class requests across the 16² "
       "and 32² classes and a sor class request; 8 sor class requests "
       "(dcavity 16², canal 32²) under tpu_fuse_phases auto and on, and 3 "
       "3-D class requests (dcavity3d 16³, canal3d 32x16x16) under auto and "
       "off, step by step")
def fleet_card_vs_cpu(np):
    from pampi_tpu_torch.fleet import FleetScheduler
    from pampi_tpu_torch.utils.params import Parameter

    base = dict(tpu_mesh="1", tpu_solver="mg", tau=0.5, gamma=0.9,
                tpu_dtype="float64")
    dcav = dict(base, name="dcavity", re=10.0, te=0.15, itermax=10,
                eps=1e-4, omg=1.7)
    canal = dict(base, name="canal", re=100.0, te=0.6, itermax=20,
                 eps=1e-5, omg=1.8, xlength=3.0, ylength=1.0, bcLeft=3,
                 bcRight=3)
    reqs = {f"d{k}": dict(dcav, imax=i, jmax=j, u_init=0.01 * k)
            for k, (j, i) in enumerate(((12, 12), (9, 16), (14, 10),
                                        (13, 13)))}
    reqs.update({f"c{k}": dict(canal, imax=i, jmax=j)
                 for k, (j, i) in enumerate(((24, 28), (20, 30), (30, 17),
                                             (18, 26)))})
    reqs["s0"] = dict(dcav, imax=12, jmax=10, tpu_solver="sor",
                      itermax=200)
    out = []
    for dev in (CARD, "cpu"):
        sched = FleetScheduler(classes="on", device=dev)
        for sid, kw in reqs.items():
            sched.submit_param(sid, Parameter(**kw))
        t0 = time.perf_counter()
        out.append((sched.run(), time.perf_counter() - t0))
    (card, tc), (cpu, tp) = out
    bad = []
    for sid in reqs:
        a, b = card.by_sid(sid), cpu.by_sid(sid)
        diff = max(float(np.abs(x - y).max()) / max(1.0, float(np.abs(y).max()))
                   for x, y in zip(a.fields, b.fields))
        ok = (a.nt == b.nt and a.mode == b.mode and diff <= 1e-9
              and not a.diverged)
        log(f"{sid} ({a.mode}, {b.fields[0].shape[1] - 2}x"
            f"{b.fields[0].shape[0] - 2}): steps card {a.nt} / CPU {b.nt}, "
            f"max |card - cpu| / scale {diff:.3e} (limit 1e-9) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(sid)
    modes = sorted(r["mode"] for r in card.summary["buckets"])
    log(f"card {tc:.1f} s, CPU {tp:.1f} s; bucket modes {modes}")
    if modes != ["class", "class", "class"] or bad:
        raise AssertionError(f"fleet card and CPU disagree: {bad} {modes}")
    # sor class batches step by step: the same steps and per-step counts
    batches = {
        "dcavity": (16, [dict(dcav, tpu_solver="sor", itermax=200,
                              eps=1e-3, imax=i, jmax=j, u_init=0.01 * k)
                         for k, (j, i) in enumerate(((12, 12), (9, 16),
                                                     (14, 10), (13, 13)))]),
        "canal": (32, [dict(canal, tpu_solver="sor", itermax=200,
                            eps=1e-3, imax=i, jmax=j)
                       for j, i in ((24, 28), (20, 30), (30, 17),
                                    (18, 26))])}
    for knob in ("auto", "on"):
        for name, (cls, kws) in batches.items():
            params = [Parameter(**kw, tpu_fuse_phases=knob) for kw in kws]
            sids = [f"{name}{k}" for k in range(len(params))]
            (rc, sc_), (rp, sp) = (class_steps(params, sids, (cls, cls), dev)
                                   for dev in (CARD, "cpu"))
            diff = max(max(float(np.abs(x - y).max())
                           / max(1.0, float(np.abs(y).max()))
                           for x, y in zip(a["fields"], b["fields"]))
                       for a, b in zip(rc, rp))
            ok = (sc_ == sp and [a["nt"] for a in rc] == [b["nt"] for b in rp]
                  and diff <= 1e-9 and not any(a["diverged"] for a in rc))
            its = sorted({x for step in sc_ for x in step if x})
            its = its if len(its) <= 6 else its[:3] + ["..."] + its[-2:]
            log(f"sor class {name} {cls}² f64 tpu_fuse_phases {knob}: steps "
                f"card {[a['nt'] for a in rc]} / CPU {[b['nt'] for b in rp]},"
                f" per-step iteration counts equal {sc_ == sp} (counts seen "
                f"{its}), max |card - cpu| / scale {diff:.3e} (limit 1e-9) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"sor {name} {knob}")
    bad += fleet3d_card_vs_cpu(np)
    if bad:
        raise AssertionError(f"fleet sor card and CPU disagree: {bad}")


# ----------------------------------------------------------------------
# the fleet's sor shape-class lane: the dynamic-extent mode of K2 and the
# class mode of K3/K4
# ----------------------------------------------------------------------

SOR_CLASS_KERNELS = ("rb_sor_class", "ns2d_pre_class", "ns2d_post_class")
SOR_CLASS_ROWS = {}   # max_abs_err of each class-mode kernel, from its check
SOLO_CONTRAST = 32    # bucket A's first requests served solo, for contrast


def sor_class_batch(torch, np, cls, lanes, dtype, seed, canal=(),
                    inactive=()):
    """Lane-stacked inputs of the sor class lane's kernels in a cls²
    class for (jmax, imax) lanes: u, v, p, rhs random on each live corner
    and 0 on the dead cells; the lanes' extents, SOR constants, cell sizes
    (unit box, or canal.par's 30x4 box for the lanes in `canal`), dt, and
    the active flags (false for the lanes in `inactive`)."""
    from pampi_tpu_torch.fleet import shapeclass as sc
    from pampi_tpu_torch.utils.params import Parameter

    rng = np.random.default_rng(seed)
    n = len(lanes)
    fields = np.zeros((4, n, cls + 2, cls + 2))
    gm = []
    for k, (j, i) in enumerate(lanes):
        fields[:, k, :j + 2, :i + 2] = rng.normal(size=(4, j + 2, i + 2))
        box = (30.0, 4.0) if k in canal else (1.0, 1.0)
        gm.append(sc.lane_geometry(Parameter(
            imax=i, jmax=j, xlength=box[0], ylength=box[1], omg=1.7)))
    gm = np.array(gm)
    real = np.float64 if dtype == torch.float64 else np.float32
    u, v, p, rhs = (torch.from_numpy(x).to(CARD, dtype) for x in fields)
    return dict(
        u=u, v=v, p=p, rhs=rhs,
        ext=torch.tensor(lanes, dtype=torch.int32, device=CARD),
        geo=torch.from_numpy(np.ascontiguousarray(
            gm[:, [sc.G_FACTOR, sc.G_IDX2, sc.G_IDY2]], real)).to(CARD),
        cell=torch.from_numpy(np.ascontiguousarray(
            gm[:, [sc.G_DX, sc.G_DY]], real)).to(CARD),
        dt=torch.from_numpy(0.004 + 0.0001 * (np.arange(n) % 7)).to(CARD,
                                                                    dtype),
        active=torch.tensor([k not in inactive for k in range(n)],
                            device=CARD))


def sor_class_batches():
    """(label, class, lanes, canal lanes, inactive lanes) of the class-mode
    checks: bucket A's 256 lanes of the 64² class; a mixed 8-lane batch of
    the 64² class (a 64x64 lane, a 12x12 one, a 33x61 one, a canal lane,
    one that does not step, and three more); 4 lanes of the 256² class."""
    return (
        ("bucket A", 64, fleet_lanes_a(), (), ()),
        ("mixed", 64, [(64, 64), (12, 12), (61, 33), (16, 64), (64, 60),
                       (9, 64), (40, 17), (50, 50)], (3,), (4,)),
        ("256²", 256, [(256, 256), (200, 256), (256, 130), (131, 255)],
         (), ()))


def dead_cells_equal(torch, a, b, ext):
    """Whether every lane's cells past its live corner are equal in a, b."""
    return all(torch.equal(a[k, j + 2:], b[k, j + 2:])
               and torch.equal(a[k, :, i + 2:], b[k, :, i + 2:])
               for k, (j, i) in enumerate(ext.tolist()))


@phase("the sor class lane's kernels vs their plain versions: K2's "
       "dynamic-extent mode and K3/K4's class mode (bucket A's 256 lanes, "
       "a mixed 8-lane batch, 4 lanes of the 256² class; float32/float64)")
def check_sor_class_kernels(torch, np):
    from pampi_tpu_torch.ops import ns2d_fused as nf
    from pampi_tpu_torch.ops import sor_kernels as sk
    from pampi_tpu_torch.utils.params import Parameter

    bad = []
    errs = {k: 0.0 for k in SOR_CLASS_KERNELS}
    for dtype in (torch.float32, torch.float64):
        t = tol(torch, dtype)
        for label, cls, lanes, canal, inactive in sor_class_batches():
            b = sor_class_batch(torch, np, cls, lanes, dtype,
                                601 + len(lanes), canal, inactive)
            # K2, n = 4 then 1 (the f32 and f64 cadences) and 30 (a call
            # in passes), chained as the solve calls it: out of place into
            # a block that held NaN, so that every cell the kernel does
            # not write shows
            pk, pp = b["p"].clone(), b["p"].clone()
            spare = torch.full_like(pk, float("nan"))
            same = fields_ok = True
            for n in (4, 1, 30):
                rk = sk.rb_sor_class(pk, b["rhs"], n, b["ext"], b["geo"],
                                     b["active"], out=spare)
                pk, spare = spare, pk
                rp = sk.rb_sor_class_plain(pp, b["rhs"], n, b["ext"],
                                           b["geo"], b["active"])
                same = same and torch.equal(rk, rp)
                fields_ok = fields_ok and rel_err(pk, pp) <= t
                errs["rb_sor_class"] = max(errs["rb_sor_class"],
                                           float((pk - pp).abs().max()))
            dead = dead_cells_equal(torch, pk, b["p"], b["ext"])
            off = [k for k in inactive if not torch.equal(pk[k], b["p"][k])]
            ok = same and fields_ok and dead and not off
            log(f"rb_sor_class {label} ({len(lanes)} lanes of the {cls}² "
                f"class) {dtype}, n = 4, 1, 30, out of place: residuals "
                f"bitwise {same}, "
                f"fields within {t:g} of scale {fields_ok} (bitwise "
                f"{torch.equal(pk, pp)}), dead cells untouched {dead}, "
                f"inactive lanes passed {not off} {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"rb_sor_class {label} {dtype}")
            # K3/K4 with the dcavity and the canal boundary sets
            for problem in ("dcavity", "canal"):
                cfg = sor_class_cfg(Parameter, problem)
                uk, vk = b["u"].clone(), b["v"].clone()
                kw = dict(ext=b["ext"], geo=b["cell"], active=b["active"])
                fk, gk, rk = nf.ns2d_pre(uk, vk, b["dt"], cfg, **kw)
                up, vp, fp, gp, rp = nf.ns2d_pre_plain(b["u"], b["v"],
                                                       b["dt"], cfg, **kw)
                copies = torch.equal(uk, up) and torch.equal(vk, vp)
                stencil = max(rel_err(a, c) for a, c in
                              ((fk, fp), (gk, gp), (rk, rp)))
                errs["ns2d_pre_class"] = max(
                    errs["ns2d_pre_class"],
                    max(float((a - c).abs().max()) for a, c in
                        ((fk, fp), (gk, gp), (rk, rp))))
                mk = nf.ns2d_post(uk, vk, fk, gk, b["p"], b["dt"], None,
                                  None, **kw)
                u2, v2, *mp = nf.ns2d_post_plain(up, vp, fk, gk, b["p"],
                                                 b["dt"], None, None, **kw)
                post = max(rel_err(uk, u2), rel_err(vk, v2))
                errs["ns2d_post_class"] = max(
                    errs["ns2d_post_class"], float((uk - u2).abs().max()),
                    float((vk - v2).abs().max()))
                maxima = all(torch.equal(x, y) for x, y in zip(mk, mp))
                zero = torch.zeros_like(uk)
                dead = (dead_cells_equal(torch, uk, zero, b["ext"])
                        and dead_cells_equal(torch, vk, zero, b["ext"]))
                off = [k for k in inactive
                       if not (torch.equal(uk[k], b["u"][k])
                               and torch.equal(vk[k], b["v"][k]))]
                ok = (copies and stencil <= t and post <= t and maxima
                      and dead and not off)
                log(f"ns2d_pre_class/ns2d_post_class {problem} {label} "
                    f"{dtype}: copies bitwise {copies}, F/G/rhs "
                    f"{stencil:.2e} and projected u, v {post:.2e} of scale "
                    f"(limit {t:g}), maxima bitwise {maxima}, dead cells 0 "
                    f"{dead}, inactive lanes passed {not off} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    bad.append(f"K3/K4 class {problem} {label} {dtype}")
    SOR_CLASS_ROWS.update({k: {"max_abs_err": v} for k, v in errs.items()})
    if bad:
        raise AssertionError(f"class-mode kernels differ: {bad}")


def sor_class_cfg(Parameter, problem):
    """The phase kernels' static configuration of a dcavity or a canal
    (canal.par's boundary set and box) class lane."""
    from pampi_tpu_torch.ops import ns2d_fused as nf

    if problem == "canal":
        return nf.StepConfig.from_param(Parameter(
            name="canal", bcLeft=3, bcRight=3, re=100.0, xlength=30.0,
            ylength=4.0))
    return nf.StepConfig.from_param(Parameter(name="dcavity", re=10.0))


@phase("the sor class lane's kernels at bucket A's shape (256 lanes of the "
       "64² class, float32) and their times beside the bound")
def time_sor_class_kernels(torch, np):
    from pampi_tpu_torch.ops import ns2d_fused as nf
    from pampi_tpu_torch.ops import sor_kernels as sk
    from pampi_tpu_torch.utils.params import Parameter

    dtype, size = torch.float32, 4
    b = sor_class_batch(torch, np, 64, fleet_lanes_a(), dtype, 611)
    n = len(fleet_lanes_a())
    # one field-size over every lane's class block, and over every lane's
    # live corner (the (jmax+2, imax+2) cells a class-mode kernel reads)
    block = n * 66 * 66 * size
    corner = sum((j + 2) * (i + 2) for j, i in fleet_lanes_a()) * size
    cfg = sor_class_cfg(Parameter, "dcavity")
    kw = dict(ext=b["ext"], geo=b["cell"], active=b["active"])
    live = sum((j * i) for j, i in fleet_lanes_a())
    p, u, v = b["p"].clone(), b["u"].clone(), b["v"].clone()
    pout = torch.empty_like(p)
    f, g, rhs = nf.ns2d_pre(u, v, b["dt"], cfg, **kw)
    calls = {
        "rb_sor_class": (
            lambda: sk.rb_sor_class(p, b["rhs"], 4, b["ext"], b["geo"],
                                    b["active"], out=pout),
            lambda: sk.rb_sor_class_plain(p.clone(), b["rhs"], 4, b["ext"],
                                          b["geo"], b["active"]),
            3 * corner, 4 * 11 * live,
            "n = 4 iterations, out of place (1 launch)"),
        "ns2d_pre_class": (
            lambda: nf.ns2d_pre(u, v, b["dt"], cfg, **kw),
            lambda: nf.ns2d_pre_plain(u, v, b["dt"], cfg, **kw),
            2 * corner + 3 * block, 70 * live, "3 launches"),
        "ns2d_post_class": (
            lambda: nf.ns2d_post(u, v, f, g, p, b["dt"], None, None, **kw),
            lambda: nf.ns2d_post_plain(u, v, f, g, p, b["dt"], None, None,
                                       **kw),
            5 * block, 8 * live, "2 launches"),
    }
    rows = {}
    shape = "256 lanes of the 64² class f32 (imax 48..64, jmax 48..64)"
    for name, (fn, plain, nbytes, ops, what) in calls.items():
        ms = cuda_ms(torch, fn, 20)
        pms = cuda_ms(torch, plain, 1)
        bd = bound(nbytes, ops)
        # the call's own device time: at this size the host's enqueue of
        # the launches can take longer than the card's work
        n_dev, busy = device_trace(torch, fn)
        busy_text = "not measured" if busy is None else f"{busy:.4f} ms"
        log(f"{name} {shape}, {what}: {ms:.4f} ms per call (plain "
            f"{pms:.4f}), bound {bd[0]:.5f} ms by {bd[1]} (bytes "
            f"{nbytes / 1e6:.2f} MB over 3.35 TB/s; operations "
            f"{ops / 1e6:.1f} M over 67 TFLOP/s = {ops / FP32_FLOPS * 1e3:.5f}"
            f" ms); the card busy {busy_text} a call in "
            f"{launches_text(n_dev)} device operations (torch.profiler)")
        rows[name] = dict(
            SOR_CLASS_ROWS.get(name, {"max_abs_err": None}), ms=ms,
            plain_ms=pms, bound_ms=bd[0], bound_by=bd[1],
            device_busy_ms=busy, device_ops_per_call=n_dev,
            bound_bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bound_operations_ms=ops / FP32_FLOPS * 1e3, shape=shape)
    return rows


@contextlib.contextmanager
def wrapper_events(torch, calls, saved=None):
    """Wrap the class-mode wrappers (default sk.rb_sor_class, nf.ns2d_pre,
    nf.ns2d_post; `saved` names others as (module, name) pairs), which the
    class chunks look up at call time, so that each class-mode call (a
    `*_class` wrapper, or a call with `ext=`) records CUDA events, kept in
    calls[name of its kernel entry]."""
    from pampi_tpu_torch.ops import ns2d_fused as nf
    from pampi_tpu_torch.ops import sor_kernels as sk

    if saved is None:
        saved = [(sk, "rb_sor_class"), (nf, "ns2d_pre"), (nf, "ns2d_post")]
    inner = {name: getattr(mod, name) for mod, name in saved}

    def timed(name):
        def call(*a, **kw):
            if not name.endswith("_class") and kw.get("ext") is None:
                return inner[name](*a, **kw)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = inner[name](*a, **kw)
            ev[1].record()
            key = name if name.endswith("_class") else f"{name}_class"
            calls.setdefault(key, []).append(ev)
            return out
        return call

    for mod, name in saved:
        setattr(mod, name, timed(name))
    try:
        yield
    finally:
        for mod, name in saved:
            setattr(mod, name, inner[name])


@phase("main path: the fleet's sor class lane on the card, f32: 256 dcavity "
       "sor requests in the 64² class and 32 canal sor requests in the "
       "256² class, cold and warm; four of them alone in the 128² class; "
       "32 served solo for contrast")
def main_path_fleet_sor(torch):
    import numpy as np

    from pampi_tpu_torch.fleet import BatchedSolver, FleetScheduler
    from pampi_tpu_torch.fleet import shapeclass as sc
    from pampi_tpu_torch.kernels import build as kb

    sched = FleetScheduler(classes="on", device=CARD)
    runs = {}

    def serve():
        for name in ("cold", "warm"):
            a, b = fleet_requests(torch, "" if name == "cold" else "w",
                                  solver="sor")
            for r in a + b:
                sched.submit(r)
            calls = {}
            stats0 = {k: dict(t.solve_stats or {})
                      for k, t in sched._templates.items()}
            with wrapper_events(torch, calls):
                runs[name] = sched.run()
            torch.cuda.synchronize()
            runs[name + "_calls"] = {
                k: (len(ev), sum(x.elapsed_time(y) for x, y in ev))
                for k, ev in calls.items()}
            runs[name + "_stats"] = {
                t.jc: {k: v - stats0.get(sig, {}).get(k, 0)
                       for k, v in (t.solve_stats or {}).items()}
                for sig, t in sched._templates.items()}
        a, _b = fleet_requests(torch, solver="sor")
        four = [a[k] for k in (0, 5, 16, min(200, FLEET_A - 1))]
        tpl = sc.ClassSolver(four[0].param, ic=128, jc=128, device=CARD)
        batch = BatchedSolver(tpl, [r.param for r in four],
                              [r.sid for r in four])
        runs["128"] = batch.results(batch.run())

    counts, _ = drive_path(kb, "fleet sor class lane", SOR_CLASS_KERNELS,
                           serve)
    others = [k for k, v in counts.items()
              if v and k not in SOR_CLASS_KERNELS]
    if others:
        raise AssertionError(f"the sor class path launched {others}")
    bad = []
    for name in ("cold", "warm"):
        res = runs[name]
        n_bad = [s.sid for s in res.scenarios
                 if s.diverged or not all(np.isfinite(f).all()
                                          for f in s.fields)]
        if n_bad or len(res.scenarios) != FLEET_A + FLEET_B:
            bad.append(f"{name}: {len(n_bad)} lanes not finite or diverged")
        for row in res.summary["buckets"]:
            nts = [s.nt for s in res.scenarios if s.bucket == row["bucket"]]
            st = runs[name + "_stats"].get(row["grid"][1], {})
            share = st.get("sync_s", 0.0) / max(1e-12, st.get("solve_s", 0.0))
            log(f"fleet sor {name} bucket {row['grid']} ({row['lanes']} "
                f"lanes, mode {row['mode']}): set-up "
                f"{row['compile_wall_s']:.3f} s, run {row['run_wall_s']:.4f}"
                f" s, {row['chunks']} chunks, "
                f"{row['run_wall_s'] / max(1, row['chunks']) * 1e3:.2f} ms "
                f"per chunk; steps per lane {min(nts)}..{max(nts)}; solve "
                f"{st.get('solve_s', 0.0):.4f} s in {st.get('rounds', 0)} "
                f"rounds, the residual read-backs {st.get('sync_s', 0.0):.4f}"
                f" s: host-sync share of the solve {share:.3f}")
            if row["mode"] != "class":
                bad.append(f"{row['bucket']} ran {row['mode']}")
        for k, (n_calls, ms) in sorted(runs[name + "_calls"].items()):
            log(f"fleet sor {name} {k}: {n_calls} calls, "
                f"{ms / max(1, n_calls):.4f} ms per call (CUDA events "
                f"around the wrapper), {ms:.2f} ms in all")
        log(f"fleet sor {name}: {res.summary['n_scenarios']} scenarios, "
            f"{res.summary['scenarios_per_s']} scenarios/s (run walls), "
            f"diverged {res.summary['divergence_census']['diverged']}")
    b_nts = [s.nt for s in runs["cold"].scenarios if s.sid.startswith("b")]
    if not 15 <= min(b_nts) <= max(b_nts) <= 30:
        bad.append(f"bucket B lanes ran {min(b_nts)}..{max(b_nts)} steps")
    cold, warm = runs["cold"], runs["warm"]
    differ = [s.sid for s in cold.scenarios
              if s.nt != warm.by_sid("w" + s.sid).nt or not all(
                  np.array_equal(x, y, equal_nan=True) for x, y in
                  zip(s.fields, warm.by_sid("w" + s.sid).fields))]
    log(f"warm run bitwise the cold one: {not differ}")
    if differ:
        bad.append(f"warm differs from cold in {differ}")
    same = all(r["nt"] == cold.by_sid(r["sid"]).nt and all(
        np.array_equal(x, y) for x, y in zip(
            r["fields"], cold.by_sid(r["sid"]).fields))
        for r in runs["128"])
    log(f"four bucket-A sor requests alone in the 128² class: steps "
        f"{[r['nt'] for r in runs['128']]}, fields bitwise their 64²-class "
        f"lanes {same} {'ok' if same else 'FAIL'}")
    if not same:
        bad.append("the 128² re-run differs")
    # the contrast: bucket A's first requests served solo (not gated)
    solo = FleetScheduler(classes="off", device=CARD)
    a, _b = fleet_requests(torch, "s", solver="sor")
    for r in a[:SOLO_CONTRAST]:
        solo.submit(r)
    t0 = time.perf_counter()
    sres = solo.run()
    wall = time.perf_counter() - t0
    log(f"contrast: bucket A's first {SOLO_CONTRAST} sor requests served "
        f"solo (classes off): {sres.summary['scenarios_per_s']} scenarios/s "
        f"(run walls), {wall:.2f} s in all; the class buckets above "
        f"{cold.summary['scenarios_per_s']} (cold) / "
        f"{warm.summary['scenarios_per_s']} (warm)")
    if bad:
        raise AssertionError(f"fleet sor main path: {bad}")
    return counts


def class_steps(params, sids, grid, device):
    """A class batch of sor requests in the class grid (ic, jc) or (ic, jc,
    kc), run one step a chunk (tpu_chunk 1): (results, each step's per-lane
    iteration counts)."""
    from pampi_tpu_torch.fleet import BatchedSolver
    from pampi_tpu_torch.fleet import shapeclass as sc
    from pampi_tpu_torch.fleet.batch import T_DRIVE

    params = [q.replace(tpu_chunk=1) for q in params]
    if len(grid) == 3:
        tpl = sc.Class3DSolver(params[0], *grid, device=device)
    else:
        tpl = sc.ClassSolver(params[0], *grid, device=device)
    b = BatchedSolver(tpl, params, sids)
    state, steps = b.initial_state(), []
    while float(state[b.slot(T_DRIVE)]) <= b.drive_te():
        state = b.chunk(state)
        steps.append(tpl.last_iters.tolist())
    return b.results(state), steps


# ----------------------------------------------------------------------
# the fleet's 3-D shape-class rungs: the class mode of K7/K8 around the
# masked class solve
# ----------------------------------------------------------------------

CLASS3D_KERNELS = ("ns3d_pre_class", "ns3d_post_class")
CLASS3D_ROWS = {}      # max_abs_err of each class-mode kernel, from its check
FLEET_C = 128          # bucket C: dcavity3d sor requests in the 32³ class
FLEET_D = 16           # bucket D: canal3d sor requests in the 64x16x16 class
SOLO_CONTRAST_3D = 16  # bucket C's first requests served solo, for contrast


def fleet_lanes_c():
    """Bucket C's (kmax, jmax, imax) extents, all in the 32³ class."""
    return [(20 + i % 13, 32 - i % 9, 24 + i % 9) for i in range(FLEET_C)]


def fleet_lanes_d():
    """Bucket D's (kmax, jmax, imax) extents, all in the 64x16x16 class."""
    return [(10 + i % 5, 10 + i % 7, 40 + i % 17) for i in range(FLEET_D)]


def class3d_batch(torch, np, cls, lanes, dtype, seed, canal=(),
                  inactive=()):
    """Lane-stacked inputs of K7/K8's class mode in a class of interior
    extents cls = (kc, jc, ic) for (kmax, jmax, imax) lanes: u, v, w, p
    random on each live corner and 0 on the dead cells; the lanes'
    extents, cell sizes (unit box, or canal3d.par's 30x4x4 box for the
    lanes in `canal`), dt, and the active flags (false for the lanes in
    `inactive`)."""
    from pampi_tpu_torch.fleet import shapeclass as sc
    from pampi_tpu_torch.utils.params import Parameter

    rng = np.random.default_rng(seed)
    n = len(lanes)
    fields = np.zeros((4, n) + tuple(c + 2 for c in cls))
    gm = []
    for q, (k, j, i) in enumerate(lanes):
        fields[:, q, :k + 2, :j + 2, :i + 2] = rng.normal(
            size=(4, k + 2, j + 2, i + 2))
        box = (30.0, 4.0, 4.0) if q in canal else (1.0, 1.0, 1.0)
        gm.append(sc.lane_geometry_3d(Parameter(
            name="dcavity3d", imax=i, jmax=j, kmax=k, xlength=box[0],
            ylength=box[1], zlength=box[2])))
    gm = np.array(gm)
    real = np.float64 if dtype == torch.float64 else np.float32
    u, v, w, p = (torch.from_numpy(x).to(CARD, dtype) for x in fields)
    return dict(
        u=u, v=v, w=w, p=p,
        ext=torch.tensor(lanes, dtype=torch.int32, device=CARD),
        cell=torch.from_numpy(np.ascontiguousarray(
            gm[:, [sc.G3_DX, sc.G3_DY, sc.G3_DZ]], real)).to(CARD),
        dt=torch.from_numpy(0.004 + 0.0001 * (np.arange(n) % 7)).to(CARD,
                                                                    dtype),
        active=torch.tensor([q not in inactive for q in range(n)],
                            device=CARD))


def class3d_batches():
    """(label, class (kc, jc, ic), lanes, canal lanes, inactive lanes) of
    the class-mode checks: bucket C's 128 lanes of the 32³ class; a mixed
    6-lane batch of the 16³ class (a 16³ lane, an 8³ one, a 10x9x8 one, a
    canal3d lane, one that does not step, and a 13x16x11 one); 4 lanes of
    the 64x16x16 class."""
    return (
        ("bucket C", (32, 32, 32), fleet_lanes_c(), (), ()),
        ("mixed", (16, 16, 16), [(16, 16, 16), (8, 8, 8), (8, 9, 10),
                                 (8, 8, 16), (12, 14, 9), (11, 16, 13)],
         (3,), (4,)),
        ("64x16x16", (16, 16, 64), fleet_lanes_d()[:4], (0, 1, 2, 3), ()))


def class3d_cfg(Parameter, problem):
    """K7's static configuration of a dcavity3d or a canal3d (canal3d.par's
    boundary set and box) class lane."""
    from pampi_tpu_torch.ops import ns3d_fused as nf3

    if problem == "canal3d":
        return nf3.StepConfig3D.from_param(Parameter(
            name="canal3d", bcLeft=3, bcRight=3, re=100.0, xlength=30.0,
            ylength=4.0, zlength=4.0))
    return nf3.StepConfig3D.from_param(Parameter(name="dcavity3d", re=10.0))


def dead_cells_zero_3d(torch, a, ext):
    """Whether every lane's cells past its live corner hold 0 in a."""
    return all(not (a[q, k + 2:].any() or a[q, :, j + 2:].any()
                    or a[q, :, :, i + 2:].any())
               for q, (k, j, i) in enumerate(ext.tolist()))


@phase("the 3-D class rungs' kernels vs their plain versions: K7/K8's class "
       "mode (bucket C's 128 lanes of the 32³ class, a mixed 6-lane batch of "
       "the 16³ class, 4 lanes of the 64x16x16 class; float32/float64)")
def check_class3d_kernels(torch, np):
    from pampi_tpu_torch.ops import ns3d_fused as nf3
    from pampi_tpu_torch.utils.params import Parameter

    bad = []
    errs = {k: 0.0 for k in CLASS3D_KERNELS}
    for dtype in (torch.float32, torch.float64):
        t = tol(torch, dtype)
        for label, cls, lanes, canal, inactive in class3d_batches():
            b = class3d_batch(torch, np, cls, lanes, dtype, 701 + len(lanes),
                              canal, inactive)
            kw = dict(ext=b["ext"], geo=b["cell"], active=b["active"])
            for problem in ("dcavity3d", "canal3d"):
                cfg = class3d_cfg(Parameter, problem)
                uk, vk, wk = b["u"].clone(), b["v"].clone(), b["w"].clone()
                fk, gk, hk, rk = nf3.ns3d_pre(uk, vk, wk, b["dt"], cfg, **kw)
                up, vp, wp, fp, gp, hp, rp = nf3.ns3d_pre_plain(
                    b["u"], b["v"], b["w"], b["dt"], cfg, **kw)
                copies = all(torch.equal(x, y) for x, y in
                             ((uk, up), (vk, vp), (wk, wp)))
                pairs = ((fk, fp), (gk, gp), (hk, hp), (rk, rp))
                stencil = max(rel_err(x, y) for x, y in pairs)
                errs["ns3d_pre_class"] = max(
                    errs["ns3d_pre_class"],
                    max(float((x - y).abs().max()) for x, y in pairs))
                mk = nf3.ns3d_post(uk, vk, wk, fk, gk, hk, b["p"], b["dt"],
                                   None, None, None, **kw)
                *uvw, m1, m2, m3 = nf3.ns3d_post_plain(
                    up, vp, wp, fk, gk, hk, b["p"], b["dt"], None, None,
                    None, **kw)
                post = max(rel_err(x, y) for x, y in zip((uk, vk, wk), uvw))
                errs["ns3d_post_class"] = max(
                    errs["ns3d_post_class"],
                    max(float((x - y).abs().max())
                        for x, y in zip((uk, vk, wk), uvw)))
                maxima = all(torch.equal(x, y) for x, y in
                             zip(mk, (m1, m2, m3)))
                dead = all(dead_cells_zero_3d(torch, a, b["ext"])
                           for a in (uk, vk, wk))
                off = [q for q in inactive
                       if not all(torch.equal(x[q], y[q]) for x, y in
                                  ((uk, b["u"]), (vk, b["v"]), (wk, b["w"])))]
                ok = (copies and stencil <= t and post <= t and maxima
                      and dead and not off)
                rung = "x".join(map(str, cls[::-1]))
                log(f"ns3d_pre_class/ns3d_post_class {problem} {label} "
                    f"({len(lanes)} lanes of the {rung} class) {dtype}: "
                    f"copies bitwise {copies}, F/G/H/rhs "
                    f"{stencil:.2e} and projected u, v, w {post:.2e} of scale "
                    f"(limit {t:g}), maxima bitwise {maxima}, dead cells 0 "
                    f"{dead}, inactive lanes passed {not off} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    bad.append(f"K7/K8 class {problem} {label} {dtype}")
    CLASS3D_ROWS.update({k: {"max_abs_err": v} for k, v in errs.items()})
    if bad:
        raise AssertionError(f"3-D class-mode kernels differ: {bad}")


@phase("the 3-D class rungs' kernels at bucket C's shape (128 lanes of the "
       "32³ class, float32) and their times beside the bound")
def time_class3d_kernels(torch, np):
    from pampi_tpu_torch.ops import ns3d_fused as nf3
    from pampi_tpu_torch.utils.params import Parameter

    dtype, size = torch.float32, 4
    lanes = fleet_lanes_c()
    b = class3d_batch(torch, np, (32, 32, 32), lanes, dtype, 711)
    # one field-size over every lane's live corner (the cells a class-mode
    # kernel must read or write); the predictor's ~190 operations a cell
    corner = sum((k + 2) * (j + 2) * (i + 2) for k, j, i in lanes) * size
    live = sum(k * j * i for k, j, i in lanes)
    cfg = class3d_cfg(Parameter, "dcavity3d")
    kw = dict(ext=b["ext"], geo=b["cell"], active=b["active"])
    u, v, w, p = b["u"], b["v"], b["w"], b["p"]
    f, g, h, rhs = nf3.ns3d_pre(u, v, w, b["dt"], cfg, **kw)
    calls = {
        "ns3d_pre_class": (
            lambda: nf3.ns3d_pre(u, v, w, b["dt"], cfg, **kw),
            lambda: nf3.ns3d_pre_plain(u, v, w, b["dt"], cfg, **kw),
            7 * corner, 190 * live,
            "5 launches (reads u, v, w; writes F, G, H, rhs)"),
        "ns3d_post_class": (
            lambda: nf3.ns3d_post(u, v, w, f, g, h, p, b["dt"], None, None,
                                  None, **kw),
            lambda: nf3.ns3d_post_plain(u, v, w, f, g, h, p, b["dt"], None,
                                        None, None, **kw),
            7 * corner, 15 * live,
            "2 launches (reads F, G, H, p; writes u, v, w)"),
    }
    rows = {}
    shape = ("128 lanes of the 32³ class f32 (kmax 20..32, jmax 24..32, "
             "imax 24..32)")
    for name, (fn, plain, nbytes, ops, what) in calls.items():
        ms = cuda_ms(torch, fn, 20)
        pms = cuda_ms(torch, plain, 3)
        bd = bound(nbytes, ops)
        n_dev, busy = device_trace(torch, fn)
        busy_text = "not measured" if busy is None else f"{busy:.4f} ms"
        log(f"{name} {shape}, {what}: {ms:.4f} ms per call (plain "
            f"{pms:.4f}), bound {bd[0]:.5f} ms by {bd[1]} (bytes "
            f"{nbytes / 1e6:.2f} MB over the lanes' live corners over 3.35 "
            f"TB/s; operations {ops / 1e6:.1f} M over 67 TFLOP/s = "
            f"{ops / FP32_FLOPS * 1e3:.5f} ms); the card busy {busy_text} a "
            f"call in {launches_text(n_dev)} device operations "
            f"(torch.profiler)")
        rows[name] = dict(
            CLASS3D_ROWS.get(name, {"max_abs_err": None}), ms=ms,
            plain_ms=pms, bound_ms=bd[0], bound_by=bd[1],
            device_busy_ms=busy, device_ops_per_call=n_dev,
            bound_bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bound_operations_ms=ops / FP32_FLOPS * 1e3, shape=shape)
    return rows


def fleet_requests_3d(sid0=""):
    """(bucket C, bucket D) requests of the 3-D fleet main path, f32: C 128
    dcavity3d sor requests in the 32³ class with the 2-D bucket A's knobs
    (re 10, te 0.05, tau 0.5, itermax 10, eps 1e-4, omg 1.7, gamma 0.9),
    D 16 canal3d sor requests in the 64x16x16 class with configs/
    canal3d.par's physics and te 1.0."""
    from pampi_tpu_torch.fleet import ScenarioRequest
    from pampi_tpu_torch.utils.params import read_parameter

    dcav = read_parameter(os.path.join(ROOT, "configs", "dcavity3d.par"))
    c = [ScenarioRequest(f"{sid0}c{q}", dcav.replace(
        imax=i, jmax=j, kmax=k, re=10.0, te=0.05, tau=0.5, eps=1e-4,
        omg=1.7, gamma=0.9, u_init=0.001 * q, itermax=10, tpu_solver="sor",
        tpu_dtype="float32", tpu_mesh="1"))
        for q, (k, j, i) in enumerate(fleet_lanes_c())]
    canal = read_parameter(os.path.join(ROOT, "configs", "canal3d.par"))
    d = [ScenarioRequest(f"{sid0}d{q}", canal.replace(
        imax=i, jmax=j, kmax=k, te=1.0, tpu_solver="sor",
        tpu_dtype="float32", tpu_mesh="1"))
        for q, (k, j, i) in enumerate(fleet_lanes_d())]
    return c, d


@phase("main path: the fleet's 3-D class rungs on the card, f32: 128 "
       "dcavity3d sor requests in the 32³ class and 16 canal3d sor requests "
       "in the 64x16x16 class, cold and warm; four of them alone in the 64³ "
       "class; 16 served solo for contrast")
def main_path_fleet_3d(torch):
    import numpy as np

    from pampi_tpu_torch.fleet import BatchedSolver, FleetScheduler
    from pampi_tpu_torch.fleet import shapeclass as sc
    from pampi_tpu_torch.kernels import build as kb
    from pampi_tpu_torch.ops import ns3d_fused as nf3

    sched = FleetScheduler(classes="on", device=CARD)
    runs = {}

    def serve():
        for name in ("cold", "warm"):
            c, d = fleet_requests_3d("" if name == "cold" else "w")
            for r in c + d:
                sched.submit(r)
            calls = {}
            stats0 = {k: dict(t.solve_stats) for k, t in
                      sched._templates.items()}
            with wrapper_events(torch, calls, [(nf3, "ns3d_pre"),
                                               (nf3, "ns3d_post")]):
                runs[name] = sched.run()
            torch.cuda.synchronize()
            runs[name + "_calls"] = {
                k: (len(ev), sum(x.elapsed_time(y) for x, y in ev))
                for k, ev in calls.items()}
            runs[name + "_stats"] = {
                t.ic: {k: v - stats0.get(sig, {}).get(k, 0)
                       for k, v in t.solve_stats.items()}
                for sig, t in sched._templates.items()}
        c, _d = fleet_requests_3d()
        four = [c[q] for q in (0, 5, 16, 100)]
        tpl = sc.Class3DSolver(four[0].param, ic=64, jc=64, kc=64,
                               device=CARD)
        batch = BatchedSolver(tpl, [r.param for r in four],
                              [r.sid for r in four])
        runs["64"] = batch.results(batch.run())

    counts, _ = drive_path(kb, "fleet 3-D class rungs", CLASS3D_KERNELS,
                           serve)
    others = [k for k, v in counts.items()
              if v and k not in CLASS3D_KERNELS]
    if others:
        raise AssertionError(f"the 3-D class path launched {others}")
    bad = []
    for name in ("cold", "warm"):
        res = runs[name]
        n_bad = [s.sid for s in res.scenarios
                 if s.diverged or not all(np.isfinite(f).all()
                                          for f in s.fields)]
        if n_bad or len(res.scenarios) != FLEET_C + FLEET_D:
            bad.append(f"{name}: {len(n_bad)} lanes not finite or diverged")
        for row in res.summary["buckets"]:
            nts = [s.nt for s in res.scenarios if s.bucket == row["bucket"]]
            st = runs[name + "_stats"].get(row["grid"][0], {})
            solve_s = st.get("solve_s", 0.0)
            log(f"fleet 3-D {name} bucket {row['grid']} ({row['lanes']} "
                f"lanes, mode {row['mode']}): set-up "
                f"{row['compile_wall_s']:.3f} s, run {row['run_wall_s']:.4f}"
                f" s, {row['chunks']} chunks, "
                f"{row['run_wall_s'] / max(1, row['chunks']) * 1e3:.2f} ms "
                f"per chunk; steps per lane {min(nts)}..{max(nts)}; solve "
                f"{solve_s:.4f} s in {st.get('rounds', 0)} iterations, "
                f"{solve_s / max(1e-12, row['run_wall_s']):.3f} of the run; "
                f"the residual read-backs {st.get('sync_s', 0.0):.4f} s: "
                f"host-sync share of the solve "
                f"{st.get('sync_s', 0.0) / max(1e-12, solve_s):.3f}")
            if row["mode"] != "class":
                bad.append(f"{row['bucket']} ran {row['mode']}")
        for k, (n_calls, ms) in sorted(runs[name + "_calls"].items()):
            log(f"fleet 3-D {name} {k}: {n_calls} calls, "
                f"{ms / max(1, n_calls):.4f} ms per call (CUDA events "
                f"around the wrapper), {ms:.2f} ms in all")
        log(f"fleet 3-D {name}: {res.summary['n_scenarios']} scenarios, "
            f"{res.summary['scenarios_per_s']} scenarios/s (run walls), "
            f"diverged {res.summary['divergence_census']['diverged']}")
    cold, warm = runs["cold"], runs["warm"]
    differ = [s.sid for s in cold.scenarios
              if s.nt != warm.by_sid("w" + s.sid).nt or not all(
                  np.array_equal(x, y, equal_nan=True) for x, y in
                  zip(s.fields, warm.by_sid("w" + s.sid).fields))]
    log(f"warm run bitwise the cold one: {not differ}")
    if differ:
        bad.append(f"warm differs from cold in {differ}")
    same = all(r["nt"] == cold.by_sid(r["sid"]).nt and all(
        np.array_equal(x, y) for x, y in zip(
            r["fields"], cold.by_sid(r["sid"]).fields))
        for r in runs["64"])
    log(f"four bucket-C requests alone in the 64³ class: steps "
        f"{[r['nt'] for r in runs['64']]}, fields bitwise their 32³-class "
        f"lanes {same} {'ok' if same else 'FAIL'}")
    if not same:
        bad.append("the 64³ re-run differs")
    # the contrast: bucket C's first requests served solo (not gated)
    solo = FleetScheduler(classes="off", device=CARD)
    c, _d = fleet_requests_3d("s")
    for r in c[:SOLO_CONTRAST_3D]:
        solo.submit(r)
    t0 = time.perf_counter()
    sres = solo.run()
    wall = time.perf_counter() - t0
    log(f"contrast: bucket C's first {SOLO_CONTRAST_3D} requests served solo "
        f"(classes off): {sres.summary['scenarios_per_s']} scenarios/s (run "
        f"walls), {wall:.2f} s in all; the class buckets above "
        f"{cold.summary['scenarios_per_s']} (cold) / "
        f"{warm.summary['scenarios_per_s']} (warm)")
    if bad:
        raise AssertionError(f"fleet 3-D main path: {bad}")
    return counts


def fleet3d_card_vs_cpu(np):
    """The 3-D part of fleet_card_vs_cpu: dcavity3d 8³ and 10x9x8 in the
    16³ class (eps 1e-3, so that the solves converge before itermax) and
    canal3d 20x10x10 in the 32x16x16 class (configs/canal3d.par's physics,
    itermax cut to 100 for the CPU half's time), f64, under
    tpu_fuse_phases auto and off, step by step. Returns the failures."""
    from pampi_tpu_torch.utils.params import Parameter

    base = dict(tpu_mesh="1", tpu_solver="sor", tau=0.5, gamma=0.9,
                tpu_dtype="float64")
    batches = {
        "dcavity3d": ((16, 16, 16), [
            dict(base, name="dcavity3d", re=10.0, te=0.05, itermax=200,
                 eps=1e-3, omg=1.7, imax=i, jmax=j, kmax=k, u_init=0.01 * q)
            for q, (k, j, i) in enumerate(((8, 8, 8), (8, 9, 10)))]),
        "canal3d": ((32, 16, 16), [
            dict(base, name="canal3d", re=100.0, te=1.5, itermax=100,
                 eps=1e-4, omg=1.3, xlength=30.0, ylength=4.0, zlength=4.0,
                 u_init=1.0, bcLeft=3, bcRight=3, imax=20, jmax=10,
                 kmax=10)])}
    bad = []
    for knob in ("auto", "off"):
        for name, (cls, kws) in batches.items():
            params = [Parameter(**kw, tpu_fuse_phases=knob) for kw in kws]
            sids = [f"{name}{q}" for q in range(len(params))]
            (rc, sc_), (rp, sp) = (class_steps(params, sids, cls, dev)
                                   for dev in (CARD, "cpu"))
            diff = max(max(float(np.abs(a - b).max())
                           / max(1.0, float(np.abs(b).max()))
                           for a, b in zip(x["fields"], y["fields"]))
                       for x, y in zip(rc, rp))
            ok = (sc_ == sp and [a["nt"] for a in rc] == [b["nt"] for b in rp]
                  and diff <= 1e-9 and not any(a["diverged"] for a in rc))
            its = sorted({x for step in sc_ for x in step if x})
            its = its if len(its) <= 6 else its[:3] + ["..."] + its[-2:]
            log(f"3-D class {name} {'x'.join(map(str, cls))} f64 "
                f"tpu_fuse_phases {knob}: steps card {[a['nt'] for a in rc]} "
                f"/ CPU {[b['nt'] for b in rp]}, per-step iteration counts "
                f"equal {sc_ == sp} (counts seen {its}), max |card - cpu| / "
                f"scale {diff:.3e} (limit 1e-9) {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"3-D {name} {knob}")
    return bad


# -- the overlapped exchange schedule (`tpu_overlap on`): the grid-band mode
# of K3 and K7 and the overlapped NS-2D and NS-3D steps --------------------

def band_cases_2d():
    """(label, param, mesh, shard index) of the K3 band checks: the 2048²
    shards of dcavity 4096² on 2x2 (the main path's) and canal_obstacle.par
    (512x128) on 2x2 with its flags."""
    J, I = MAIN
    return (("dcavity 4096² 2x2", config("dcavity.par", imax=I, jmax=J),
             (2, 2)),
            ("canal_obstacle.par 2x2", config("canal_obstacle.par"), (2, 2)))


def band_cases_3d():
    """(label, param, mesh) of the K7 band checks: the 64³ shards of
    dcavity3d 128³ on 2x2x2 and canal3d_obstacle.par (128x32x32) on 2x2x2
    with its flags."""
    return (("dcavity3d 128³ 2x2x2", config("dcavity3d.par"), (2, 2, 2)),
            ("canal3d_obstacle.par 2x2x2", config("canal3d_obstacle.par"),
             (2, 2, 2)))


def band_plan(local, dims, rows):
    """The port's region plan of a shard geometry (the overlapped step's)
    and its interior mask on the card."""
    from pampi_tpu_torch.parallel import overlap as ovl

    part = tuple(d > 1 for d in dims)
    return (ovl.pre_plan(local, part, 2, rows),
            ovl.interior_mask(local, ovl.OVERLAP_RIM, part, "cuda"))


def band_call(torch, pre, plain, deep, tail, bands, full):
    """One band call (kernel `pre`) on copies of the deep blocks against
    the full kernel call `full` ((deep blocks after the BCs, outputs)) and
    the band plain version: (BCs bitwise, outputs bitwise the full call's
    on their rows, max abs error against the plain version there, its
    rel_err, plain bitwise)."""
    blocks = [x.clone() for x in deep]
    out = pre(*blocks, *tail, bands=bands)
    pl = plain(*deep, *tail, bands=bands)
    nd = len(deep)
    bcs = all(torch.equal(a, b) for a, b in zip(blocks, full[0]))
    exact = every = True
    err = rel = 0.0
    for a, b, c in zip(out, full[1], pl[nd:]):
        rows = ~torch.isnan(c)  # the plain version's NaN: outside the bands
        exact = exact and torch.equal(a[rows], b[rows])
        every = every and torch.equal(a[rows], c[rows])
        err = max(err, float((a[rows] - c[rows]).abs().max()))
        rel = max(rel, rel_err(a[rows], c[rows]))
    return bcs, exact, err, rel, every


def check_band_family(torch, np, three_d, label, param, dims, dtype, seed):
    """Every shard of one mesh: each half (interior and boundary bands of
    the port's plan) of K3's or K7's band mode against the full call and
    the band plain version; returns (ok, max_abs_err, text)."""
    from pampi_tpu_torch.ops import ns2d_fused as nf
    from pampi_tpu_torch.ops import ns3d_fused as nf3
    from pampi_tpu_torch.parallel.comm import CartComm

    comm = CartComm(ndims=len(dims), dims=dims, devices=["cuda"])
    names = ("kmax", "jmax", "imax")[3 - len(dims):]
    gext = tuple(getattr(param, n) for n in names)
    local = comm.local_shape(gext, ragged=True)
    plan, _mask = band_plan(local, dims, nf3.BAND_ROWS if three_d
                            else nf.BAND_ROWS)
    if plan is None:
        raise AssertionError(f"{label}: the shards have no interior region")
    fl = [None] * comm.size
    if param.obstacles.strip():
        fl = obstacle_flag_blocks(param, comm, local, three_d)
    if three_d:
        cfg = nf3.StepConfig3D.from_param(param)
        pre, plain, nfield = nf3.ns3d_pre, nf3.ns3d_pre_plain, 3
    else:
        cfg = nf.StepConfig.from_param(param)
        pre, plain, nfield = nf.ns2d_pre, nf.ns2d_pre_plain, 2
    dt = torch.tensor(1e-3, dtype=dtype, device="cuda")
    ok, err, worst = True, 0.0, 0.0
    for s in range(comm.size):
        off = comm.offsets(s, local)
        deep = rng_fields(torch, np, tuple(e + 6 for e in local), dtype,
                          nfield, seed + s)
        tail = (dt, cfg, off, gext, 2, fl[s])
        blocks = [x.clone() for x in deep]
        full = (blocks, pre(*blocks, *tail))
        for half in ("int_bands", "bnd_bands"):
            bcs, exact, e, r, every = band_call(torch, pre, plain, deep,
                                                tail, plan[half], full)
            ok = ok and bcs and exact and r <= tol(torch, dtype)
            err, worst = max(err, e), max(worst, r)
    kind = "K7" if three_d else "K3"
    text = (f"{kind} band {dtype} {label} ({'x'.join(map(str, local))} "
            f"shards, bands {plan['int_bands']} / {plan['bnd_bands']}), every "
            f"shard, both halves: BCs and outputs bitwise the full call's "
            f"inside the bands, max_abs_err vs plain {err:.3e}, max_rel_err "
            f"{worst:.3e} (tol {tol(torch, dtype):g}) "
            f"{'ok' if ok else 'FAIL'}")
    return ok, err, text


def obstacle_flag_blocks(param, comm, local, three_d):
    """Every shard's deep flag block (uint8, on the card) of an obstacle
    config, as the distributed solvers cut them."""
    if three_d:
        from pampi_tpu_torch.ops import obstacle3d as obst3
        from pampi_tpu_torch.utils.grid import Grid

        g = Grid(imax=param.imax, jmax=param.jmax, kmax=param.kmax,
                 xlength=param.xlength, ylength=param.ylength,
                 zlength=param.zlength)
        m = obst3.make_masks_3d(obst3.build_fluid_3d(
            g.imax, g.jmax, g.kmax, g.dx, g.dy, g.dz, param.obstacles),
            g.dx, g.dy, g.dz, param.omg)
        return [obst3.deep_flag_block_3d(m, comm, s, *local, 3, "cuda")
                for s in range(comm.size)]
    from pampi_tpu_torch.ops import obstacle as obst

    dx, dy = param.xlength / param.imax, param.ylength / param.jmax
    m = obst.make_masks(obst.build_fluid(param.imax, param.jmax, dx, dy,
                                         param.obstacles), dx, dy, param.omg)
    return [obst.deep_flag_block(m, comm, s, *local, 3, param.jmax,
                                 param.imax, "cuda")
            for s in range(comm.size)]


BAND_ERR = {}  # each band kernel's max_abs_err, from its checks


@phase("grid-band K3 and K7 vs the full call and their plain versions")
def check_band_kernels(torch, np):
    bad = []
    for three_d, cases in ((False, band_cases_2d()), (True, band_cases_3d())):
        name = "ns3d_pre_band" if three_d else "ns2d_pre_band"
        for label, param, dims in cases:
            for dtype in (torch.float32, torch.float64):
                ok, err, text = check_band_family(torch, np, three_d, label,
                                                  param, dims, dtype, 211)
                log(text)
                BAND_ERR[name] = max(BAND_ERR.get(name, 0.0), err)
                if not ok:
                    bad.append(f"{name} {label} {dtype}")
                torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"band kernels disagree: {bad}")


def copy_rate(torch):
    """The card's measured device-memory rate, bytes/s: a 1 GiB
    device-to-device copy (2 GiB moved), CUDA events."""
    x = torch.empty(1 << 28, dtype=torch.float32, device="cuda")
    y = torch.empty_like(x)
    ms = cuda_ms(torch, lambda: y.copy_(x), 10)
    return 2 * x.numel() * 4 / (ms * 1e-3)


def band_bytes(ranges, local, size, three_d):
    """Bytes a band call must move: u, v (w) read on its rows and the rows
    their stencils reach (one more each side, and one below each band for
    the F/G/H row that rhs reads), F, G (H) written on its rows and the
    row below, rhs on its rows; the BC strips not counted."""
    nf = 3 if three_d else 2
    row = 1
    for e in local[1:]:
        row *= e + 2
    deep_row = 1
    for e in local[1:]:
        deep_row *= e + 6
    rows = sum(hi - lo for lo, hi in ranges)
    return size * (nf * (rows + 3 * len(ranges)) * deep_row
                   + nf * (rows + len(ranges)) * row + rows * row)


@phase("grid-band K3 and K7: times per shard call (4096² f32 on 2x2, 128³ "
       "f32 on 2x2x2)")
def time_band_kernels(torch, np):
    from pampi_tpu_torch.ops import ns2d_fused as nf
    from pampi_tpu_torch.ops import ns3d_fused as nf3
    from pampi_tpu_torch.parallel import overlap as ovl
    from pampi_tpu_torch.parallel.comm import CartComm

    rate = copy_rate(torch)
    rows = {}
    for three_d, (label, param, dims) in ((False, band_cases_2d()[0]),
                                          (True, band_cases_3d()[0])):
        mod = nf3 if three_d else nf
        name = "ns3d_pre_band" if three_d else "ns2d_pre_band"
        comm = CartComm(ndims=len(dims), dims=dims, devices=["cuda"])
        names = ("kmax", "jmax", "imax")[3 - len(dims):]
        gext = tuple(getattr(param, n) for n in names)
        local = comm.local_shape(gext)
        plan, _ = band_plan(local, dims, mod.BAND_ROWS)
        cfg = (nf3.StepConfig3D if three_d else nf.StepConfig).from_param(
            param)
        pre, plain = ((nf3.ns3d_pre, nf3.ns3d_pre_plain) if three_d else
                      (nf.ns2d_pre, nf.ns2d_pre_plain))
        nfield = 3 if three_d else 2
        deep = rng_fields(torch, np, tuple(e + 6 for e in local),
                          torch.float32, nfield, 223)
        dt = torch.tensor(1e-3, dtype=torch.float32, device="cuda")
        tail = (dt, cfg, comm.offsets(0, local), gext, 2)
        full_ms = cuda_ms(torch, lambda: pre(*deep, *tail), 20)
        _fops, fbusy = device_trace(torch, lambda: pre(*deep, *tail))
        row = {}
        for half, key in (("int_bands", ""), ("bnd_bands", "boundary_")):
            bands = plan[half]
            ranges = ovl.band_ranges(bands, mod.BAND_ROWS, local[0] + 6, 2,
                                     mod.MAX_BANDS)
            ms = cuda_ms(torch, lambda: pre(*deep, *tail, bands=bands), 20)
            ops, busy = device_trace(torch, lambda: pre(*deep, *tail,
                                                         bands=bands))
            pms = cuda_ms(torch, lambda: plain(*deep, *tail, bands=bands), 3)
            nbytes = band_bytes(ranges, local, 4, three_d)
            # ~70 (2-D) or ~100 (3-D) flops a cell of the predictor
            cells = sum(hi - lo for lo, hi in ranges)
            for e in local[1:]:
                cells *= e + 2
            b = bound(nbytes, (100 if three_d else 70) * cells)
            row.update({f"{key}ms": ms, f"{key}plain_ms": pms,
                        f"{key}busy_ms": busy, f"{key}device_ops": ops,
                        f"{key}bound_ms": b[0], f"{key}bound_by": b[1],
                        f"{key}bound_measured_rate_ms":
                            nbytes / rate * 1e3,
                        f"{key}bands": [list(x) for x in bands]})
            log(f"{name} {label} f32, {'interior' if not key else 'boundary'}"
                f" half (bands {bands}, {sum(h - l for l, h in ranges)} of "
                f"{local[0] + 2} rows): {ms:.4f} ms per shard call, the card "
                f"busy {'not measured' if busy is None else f'{busy:.4f}'} "
                f"ms of it in {launches_text(ops)} device operations (plain "
                f"{pms:.4f}; the full call {full_ms:.4f}, busy "
                f"{'not measured' if fbusy is None else f'{fbusy:.4f}'}); "
                f"bound {b[0]:.4f} "
                f"ms by {b[1]} at 3.35 TB/s, {nbytes / rate * 1e3:.4f} ms at "
                f"the measured {rate / 1e12:.3f} TB/s")
        row.update(full_call_ms=full_ms, full_call_busy_ms=fbusy,
                   measured_rate_tb_s=rate / 1e12,
                   max_abs_err=BAND_ERR.get(name, 0.0),
                   shape=f"{'x'.join(map(str, local))} shard of "
                         f"{'x'.join(map(str, gext))} on "
                         f"{'x'.join(map(str, dims))}, f32")
        rows[name] = row
        del deep
        torch.cuda.empty_cache()
    return rows


def side_overlap(torch, run):
    """torch.profiler's trace of run(): (the device time of operations on
    streams other than the busiest one, the part of it that ran while the
    busiest stream ran, in ms, and a summary {stream: (operations, busy
    ms, the commonest operation's name)}); (None, None, None) where the
    trace holds no device event or no stream ids."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    streams, names = {}, {}
    for e in ops:
        sid = getattr(e, "device_resource_id", None)
        if sid is None:
            return None, None, None
        streams.setdefault(sid, []).append(
            (e.time_range.start, e.time_range.end))
        names.setdefault(sid, Counter())[e.name[:40]] += 1
    summary = {sid: (len(iv), sum(b - a for a, b in iv) / 1e3,
                     names[sid].most_common(1)[0][0])
               for sid, iv in streams.items()}
    if len(streams) < 2:
        return (0.0, 0.0, summary) if ops else (None, None, None)
    main = max(streams, key=lambda k: sum(b - a for a, b in streams[k]))
    busy = sorted(streams.pop(main))
    side = sum(b - a for k in streams for a, b in streams[k])
    hidden = 0
    for k in streams:
        for a, b in streams[k]:
            for c, d in busy:
                if c >= b:
                    break
                hidden += max(0, min(b, d) - max(a, c))
    return side / 1e3, hidden / 1e3, summary


def per_step_counts(s, n):
    """n steps one call each (a prologue exchange every step under the
    overlapped schedule), every step's iteration count."""
    its = []
    for _ in range(n):
        s.run_steps(1)
        its.append(int(s.last_it))
    return its


def same_fields(a, b):
    """Whether two distributed solvers hold bitwise equal global fields."""
    import numpy as np

    ga, gb = a.global_fields(), b.global_fields()
    return all(np.array_equal(ga[k], gb[k], equal_nan=True) for k in ga)


@phase("main path: the overlapped schedule (tpu_overlap on) of NS-2D "
       "4096² on 2x2 and NS-3D 128³ on 2x2x2, dcavity.par f64 card vs CPU, "
       "canal_obstacle.par on against off")
def main_path_overlap(torch):
    from pampi_tpu_torch.kernels import build as kb
    from pampi_tpu_torch.models.ns2d_dist import NS2DDistSolver
    from pampi_tpu_torch.models.ns3d_dist import NS3DDistSolver
    from pampi_tpu_torch.parallel.comm import CartComm
    from pampi_tpu_torch.utils import dispatch

    counts, bad = [], []
    (_, p2, d2) = dist2d_main_configs()[0]
    (p3, d3), _ = dist3d_main_configs()
    for label, cls, param, dims, kernels in (
            ("NS-2D dcavity 4096² f32 2x2", NS2DDistSolver, p2, d2,
             ("rb_sor_qdist", "ns2d_pre_band", "ns2d_post")),
            ("NS-3D dcavity3d 128³ f32 2x2x2", NS3DDistSolver,
             p3.replace(tpu_mesh="2x2x2"), d3,
             ("rb_sor_odist", "ns3d_pre_band", "ns3d_post"))):
        fam = "ns3d_dist" if cls is NS3DDistSolver else "ns2d_dist"
        res = {}
        solvers = {}
        for knob in ("on", "off"):
            s = cls(param.replace(tpu_overlap=knob),
                    CartComm(ndims=len(dims), dims=dims))
            solvers[knob] = s
            rec = {k: dispatch.last(f"{k}_{fam}")
                   for k in ("overlap", "overlap_grid", "sweep_split")}
            c, r = drive_path(kb, f"{label} tpu_overlap {knob}",
                              kernels if knob == "on" else
                              (kernels[0], kernels[1][:-5], kernels[2]),
                              lambda: dist2d_steps(torch, s, 16))
            counts.append(c)
            res[knob] = r
            log(f"{label} tpu_overlap {knob}: {r['ms']:.3f} ms/step (host "
                f"clock); PRE {r['pre']:.3f} / solve {r['solve']:.3f} / POST "
                f"{r['post']:.3f} ms (CUDA events); records {rec}; PRE "
                f"launches a step {c[kernels[1]] / 17:.1f} band, "
                f"{c[kernels[1][:-5]] / 17:.1f} full")
        on, off = solvers["on"], solvers["off"]
        bitwise = same_fields(on, off)
        text = (f"nt {on.nt} / {off.nt}, t {on.t!r} / {off.t!r}, last "
                f"counts {on.last_it} / {off.last_it}, fields bitwise "
                f"{bitwise}")
        ok = (on.nt == off.nt == 17 and on.t == off.t
              and on.last_it == off.last_it and bitwise)
        side, hidden, streams = side_overlap(torch,
                                             lambda: on.run_steps(2))
        log(f"{label}: on against off over 17 steps: {text}; "
            f"ms/step on {res['on']['ms']:.3f} against off "
            f"{res['off']['ms']:.3f}; the side stream's device time over 2 "
            f"steps (torch.profiler): "
            + ("not measured" if side is None else
               f"{side:.3f} ms, {hidden:.3f} ms of it beside the main "
               f"stream's work; streams (operations, busy ms, commonest) "
               f"{streams}") + f" {'ok' if ok else 'FAIL'}")
        del on, off, solvers
        torch.cuda.empty_cache()
        # the timing once more in the other order (on, off, off, on), on
        # fresh solvers
        again = {}
        for knob in ("off", "on"):
            s = cls(param.replace(tpu_overlap=knob),
                    CartComm(ndims=len(dims), dims=dims))
            again[knob] = dist2d_steps(torch, s, 16)
            del s
            torch.cuda.empty_cache()
        log(f"{label}, again (off, then on): ms/step off "
            f"{again['off']['ms']:.3f} (PRE {again['off']['pre']:.3f} / "
            f"solve {again['off']['solve']:.3f} / POST "
            f"{again['off']['post']:.3f}), on {again['on']['ms']:.3f} (PRE "
            f"{again['on']['pre']:.3f} / solve {again['on']['solve']:.3f} / "
            f"POST {again['on']['post']:.3f})")
        OVERLAP_STEPS[label] = dict(
            on_ms=[res["on"]["ms"], again["on"]["ms"]],
            off_ms=[res["off"]["ms"], again["off"]["ms"]],
            on_split=[res["on"], again["on"]],
            off_split=[res["off"], again["off"]], side_ms=side,
            side_hidden_ms=hidden)
        if not ok:
            bad.append(f"{label} on vs off")

    # configs/dcavity.par f64 on 2x2, overlapped, card against CPU: each
    # step's count, t and the fields (1e-12 of scale)
    par = config("dcavity.par", tpu_mesh="2x2", tpu_overlap="on",
                 tpu_overlap_restrict="on", te=1e9)
    card = NS2DDistSolver(par, CartComm(ndims=2, dims=(2, 2)))
    cpu = NS2DDistSolver(par, CartComm(ndims=2, dims=(2, 2),
                                       devices=["cpu"]))

    def steps(s):
        # two steps a call each (a prologue each), then two in one call
        # (POST's maxima carried)
        its = per_step_counts(s, 2)
        s.run_steps(2)
        return its

    c, its = drive_path(kb, "dcavity.par f64 2x2 tpu_overlap on",
                        ("rb_sor_qdist", "ns2d_pre_band", "ns2d_post"),
                        lambda: steps(card))
    counts.append(c)
    cits = steps(cpu)
    gc, gp = card.global_fields(), cpu.global_fields()
    diff = max(float(abs(gc[k] - gp[k]).max()) for k in gc)
    scale = max(1.0, max(float(abs(gp[k]).max()) for k in gp))
    ok = its == cits and card.t == cpu.t and diff <= 1e-12 * scale
    log(f"configs/dcavity.par f64 on 2x2, tpu_overlap on, 4 steps: counts "
        f"card {its} / CPU {cits}, t {card.t!r} / {cpu.t!r}, max |card - "
        f"CPU| {diff:.3e} (limit {1e-12 * scale:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        bad.append("dcavity.par 2x2 card vs CPU")

    # canal_obstacle.par on 2x2 (flag K3 band, K15 on real flags): on
    # against off on the card, bitwise
    par = config("canal_obstacle.par", tpu_mesh="2x2", te=1e9)
    runs = {}
    for knob in ("on", "off"):
        s = NS2DDistSolver(par.replace(tpu_overlap=knob),
                           CartComm(ndims=2, dims=(2, 2)))
        c, its = drive_path(kb, f"canal_obstacle.par 2x2 tpu_overlap {knob}",
                            ("rb_sor_obsdist", "ns2d_pre_band" if knob == "on"
                             else "ns2d_pre_flags", "ns2d_post_flags"),
                            lambda: per_step_counts(s, 5))
        counts.append(c)
        runs[knob] = (s, its)
    (on, ion), (off, ioff) = runs["on"], runs["off"]
    ok = ion == ioff and on.t == off.t and same_fields(on, off)
    log(f"canal_obstacle.par f64 on 2x2, 5 steps: counts on {ion} / off "
        f"{ioff}, t {on.t!r} / {off.t!r}, fields bitwise "
        f"{same_fields(on, off)} {'ok' if ok else 'FAIL'}")
    if not ok:
        bad.append("canal_obstacle.par on vs off")
    if bad:
        raise AssertionError(f"the overlapped schedule disagrees: {bad}")
    return counts


OVERLAP_STEPS = {}  # main_path_overlap's ms/step, on and off


# -- tpu_dtype bfloat16: K1's bf16-storage mode, K3/K4 at bf16 --------------

BF16_ULP = 2.0 ** -7   # bf16's ulp at 1 (8 significant bits)
BF16_ERR = {}          # each bf16 kernel's max_abs_err, from its checks
BF16_TE = 0.0025       # configs/dcavity.par's te for the bf16 CLI run
BF16_RUN = {}          # the CPU half's process and directory


def bf16_rand(torch, np, shape, seed, n=1):
    """n bf16 fields on the card from a seeded normal draw."""
    return [x.to(torch.bfloat16) for x in
            rng_fields(torch, np, shape, torch.float32, n, seed)]


def bf16_gap(a, b):
    """(max |a - b| in bf16 ulps of b's scale max(1, max|b|), the count of
    cells that differ at all, max |a - b|)."""
    d = (a.float() - b.float()).abs()
    scale = max(1.0, float(b.float().abs().max()))
    return (float(d.max()) / (BF16_ULP * scale), int((d > 0).sum()),
            float(d.max()))


def check_k1_bf16(torch, sk, q, f, n, coef, calls=3):
    """K1's bf16 mode (`out=`, the solvers' form) against its plain
    version on the card, `calls` chained calls: (planes bitwise, residual
    bitwise, max_abs_err)."""
    qk, qp, out = q.clone(), q.clone(), torch.empty_like(q)
    for _ in range(calls):
        rk = sk.rb_sor_quarters(qk, f, n, *coef, out=out)
        qk, out = out, qk
        rp = sk.rb_sor_quarters_plain(qp, f, n, *coef)
    torch.cuda.synchronize()
    return (torch.equal(qk, qp), torch.equal(rk, rp),
            float((qk.float() - qp.float()).abs().max()))


def check_k34_bf16(torch, nf, cfg, u, v, p, dt):
    """K3/K4's bf16 mode against their plain versions on the card: (u', v'
    copies and maxima bitwise, {output: bf16_gap}), the outputs F, G, rhs,
    u'', v''."""
    uk, vk = u.clone(), v.clone()
    fk, gk, rk = nf.ns2d_pre(uk, vk, dt, cfg)
    u1, v1, f1, g1, r1 = nf.ns2d_pre_plain(u, v, dt, cfg)
    copies = torch.equal(uk, u1) and torch.equal(vk, v1)
    umax, vmax = nf.ns2d_post(uk, vk, fk, gk, p, dt, cfg.dx, cfg.dy)
    u2, v2, um2, vm2 = nf.ns2d_post_plain(u1, v1, f1, g1, p, dt, cfg.dx,
                                          cfg.dy)
    maxima = torch.equal(umax, um2) and torch.equal(vmax, vm2)
    gaps = {k: bf16_gap(a, b) for k, a, b in (
        ("F", fk, f1), ("G", gk, g1), ("rhs", rk, r1), ("u''", uk, u2),
        ("v''", vk, v2))}
    return copies, maxima, gaps


def bf16_step_config(Parameter, nf, problem, J, I):
    bc = (1, 1, 1, 1) if problem == "dcavity" else (3, 3, 1, 1)
    return nf.StepConfig.from_param(Parameter(
        name=problem, imax=I, jmax=J, re=1000.0, gamma=0.9, bcLeft=bc[0],
        bcRight=bc[1], bcBottom=bc[2], bcTop=bc[3]))


@phase("bf16 kernels vs plain versions")
def check_bf16_kernels(torch, np):
    from pampi_tpu_torch.ops import ns2d_fused as nf
    from pampi_tpu_torch.ops import sor_kernels as sk
    from pampi_tpu_torch.ops.sor_quarters import stack_quarters
    from pampi_tpu_torch.utils.params import Parameter

    bad = []
    for J, I in ((1024, 1024), (1022, 1020)):
        coef = sk.sor_coefficients(1.0 / I, 1.0 / J, 1.9)
        p, rhs = bf16_rand(torch, np, (J + 2, I + 2), 61, 2)
        q, f = stack_quarters(p), stack_quarters(rhs)
        for n in (1, 2, 3, 4):
            fields, res, err = check_k1_bf16(torch, sk, q, f, n, coef)
            BF16_ERR["rb_sor_quarters_bf16"] = max(
                BF16_ERR.get("rb_sor_quarters_bf16", 0.0), err)
            ok = fields and res
            log(f"rb_sor_quarters_bf16 {J}x{I} n={n}: planes bitwise "
                f"{fields}, float32 residual bitwise {res} (3 calls) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"rb_sor_quarters_bf16 {J}x{I} n={n}")
    # a call too deep for one pass: float32 planes between the passes
    coef = sk.sor_coefficients(1.0 / 1024, 1.0 / 1024, 1.9)
    p, rhs = bf16_rand(torch, np, (1026, 1026), 62, 2)
    fields, res, _ = check_k1_bf16(torch, sk, stack_quarters(p),
                                   stack_quarters(rhs), 40, coef, calls=1)
    log(f"rb_sor_quarters_bf16 1024² n=40 (passes): planes bitwise {fields},"
        f" residual bitwise {res} {'ok' if fields and res else 'FAIL'}")
    if not (fields and res):
        bad.append("rb_sor_quarters_bf16 n=40")
    J = I = 1024
    for problem in ("dcavity", "canal"):
        cfg = bf16_step_config(Parameter, nf, problem, J, I)
        u, v, pp = bf16_rand(torch, np, (J + 2, I + 2), 63, 3)
        dt = torch.tensor(1.3e-3, dtype=torch.bfloat16, device="cuda")
        copies, maxima, gaps = check_k34_bf16(torch, nf, cfg, u, v, pp, dt)
        worst = max(g[0] for g in gaps.values())
        for name, keys in (("ns2d_pre_bf16", ("F", "G", "rhs")),
                           ("ns2d_post_bf16", ("u''", "v''"))):
            BF16_ERR[name] = max([BF16_ERR.get(name, 0.0)]
                                 + [gaps[k][2] for k in keys])
        ok = copies and maxima and worst <= 1.0
        log(f"ns2d_pre/post_bf16 {problem} {J}²: u', v' bitwise {copies}, "
            f"maxima bitwise {maxima}; "
            + ", ".join(f"{k} {g[0]:.3g} ulp of scale ({g[1]} cells differ)"
                        for k, g in gaps.items())
            + f" (tol 1 ulp) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"ns2d_pre/post_bf16 {problem}")
    if bad:
        raise AssertionError(f"bf16 kernels disagree: {bad}")


@phase("bf16 kernels at 4096²: K1 bf16 beside K1 float32, K3/K4 bf16")
def time_bf16_kernels(torch, np):
    from pampi_tpu_torch.ops import ns2d_fused as nf
    from pampi_tpu_torch.ops import sor_kernels as sk
    from pampi_tpu_torch.ops.sor_quarters import stack_quarters
    from pampi_tpu_torch.utils.params import Parameter

    J, I = MAIN
    n = 4
    cells = (J + 2) * (I + 2)
    ring = 2 * (I + 2) + 2 * J
    interior = J * I
    coef = sk.sor_coefficients(1.0 / I, 1.0 / J, 1.8)
    p, rhs = bf16_rand(torch, np, (J + 2, I + 2), 64, 2)
    q, f = stack_quarters(p), stack_quarters(rhs)
    rows = {}
    fields, res, err = check_k1_bf16(torch, sk, q, f, n, coef, calls=1)
    if not (fields and res):
        raise AssertionError("K1 bf16 disagrees with its plain version at "
                             "4096²")
    out, qp = torch.empty_like(q), q.clone()
    ms = cuda_ms(torch, lambda: sk.rb_sor_quarters(q, f, n, *coef, out=out),
                 20)
    pms = cuda_ms(torch, lambda: sk.rb_sor_quarters_plain(qp, f, n, *coef),
                  3)
    launches = cuda_launches(torch, lambda: sk.rb_sor_quarters(
        q, f, n, *coef, out=out))
    # p and rhs read once and p written once at 2 bytes a cell; the
    # iterations run on float32 cores: ~12 flops an update
    b = bound(3 * cells * 2, 12 * n * interior)
    rows["rb_sor_quarters_bf16"] = dict(
        max_abs_err=BF16_ERR.get("rb_sor_quarters_bf16", err), ms=ms,
        plain_ms=pms, bound_ms=b[0], bound_by=b[1],
        cuda_launches_per_call=launches)
    q32, f32 = q.float(), f.float()
    o32 = torch.empty_like(q32)
    ms32 = cuda_ms(torch, lambda: sk.rb_sor_quarters(q32, f32, n, *coef,
                                                     out=o32), 20)
    l32 = cuda_launches(torch, lambda: sk.rb_sor_quarters(q32, f32, n,
                                                          *coef, out=o32))
    b32 = bound(3 * cells * 4, 12 * n * interior)
    log(f"K1 4096² n={n}: bf16 {ms:.4f} ms/call, {launches_text(launches)} "
        f"CUDA launches a call, bound {b[0]:.4f} ({b[1]}); float32 "
        f"{ms32:.4f} ms/call, {launches_text(l32)} launches, bound "
        f"{b32[0]:.4f}; bf16 plain {pms:.4f}")
    cfg = bf16_step_config(Parameter, nf, "dcavity", J, I)
    u, v, pp = bf16_rand(torch, np, (J + 2, I + 2), 65, 3)
    dt = torch.tensor(1e-4, dtype=torch.bfloat16, device="cuda")
    copies, maxima, gaps = check_k34_bf16(torch, nf, cfg, u, v, pp, dt)
    if not (copies and maxima and max(g[0] for g in gaps.values()) <= 1.0):
        raise AssertionError(f"K3/K4 bf16 disagree at 4096²: {gaps}")
    uk, vk = u.clone(), v.clone()
    fk, gk, _ = nf.ns2d_pre(uk, vk, dt, cfg)
    for name, kern, plain, flops in (
            ("ns2d_pre_bf16", lambda: nf.ns2d_pre(uk, vk, dt, cfg),
             lambda: nf.ns2d_pre_plain(u, v, dt, cfg), 80),
            ("ns2d_post_bf16",
             lambda: nf.ns2d_post(uk, vk, fk, gk, pp, dt, cfg.dx, cfg.dy),
             lambda: nf.ns2d_post_plain(u, v, fk, gk, pp, dt, cfg.dx,
                                        cfg.dy), 10)):
        ms = cuda_ms(torch, kern, 20)
        pms = cuda_ms(torch, plain, 3)
        launches = cuda_launches(torch, kern)
        # the float32 rows' five field-sizes and the ghost rings, at 2 bytes
        b = bound((5 * cells + 2 * ring) * 2, flops * interior)
        rows[name] = dict(max_abs_err=BF16_ERR.get(name, 0.0), ms=ms,
                          plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                          cuda_launches_per_call=launches)
    for name, r in rows.items():
        log(f"{name} 4096² bf16: {r['ms']:.4f} ms/call (plain "
            f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']}), {launches_text(r['cuda_launches_per_call'])}"
            f" CUDA launches a call, max_abs_err vs plain "
            f"{r['max_abs_err']:.3e}")
    return rows


@phase("main path: Poisson 4096² and NS-2D dcavity 4096² at tpu_dtype "
       "bfloat16, beside float32")
def main_path_bf16(torch):
    from pampi_tpu_torch.kernels import build as kb
    from pampi_tpu_torch.models.ns2d import NS2DSolver
    from pampi_tpu_torch.models.poisson import PoissonSolver
    from pampi_tpu_torch.utils.params import Parameter

    J, I = MAIN
    kernels = ("rb_sor_quarters_bf16", "ns2d_pre_bf16", "ns2d_post_bf16")

    def poisson():
        param = Parameter(name="poisson", imax=I, jmax=J, itermax=400,
                          eps=0.0, omg=1.9, tpu_dtype="bfloat16",
                          tpu_sor_inner=4)
        s = PoissonSolver(param, device="cuda")
        s.solve()  # warm-up: loads the kernels
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        it, res = s.solve()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if (it != 400 or not res == res or s.p.dtype != torch.bfloat16
                or not bool(torch.isfinite(s.p).all())):
            raise AssertionError(f"Poisson bf16: it={it} res={res}")
        log(f"Poisson 4096² bf16 (quarters, tpu_sor_inner 4): {it} "
            f"iterations, {sec / it * 1e3:.4f} ms/iteration, "
            f"{J * I * it / sec:.4e} site-updates/s, residual {res:.4e} "
            "(float32)")

    runs = {}

    def ns2d(dtype):
        param = Parameter(name="dcavity", imax=I, jmax=J, re=1000.0,
                          itermax=100, eps=0.0, te=1e9, tpu_dtype=dtype,
                          tpu_sor_inner=4)
        s = NS2DSolver(param, device="cuda")
        r = timed_steps(torch, s, 16)
        finite = all(bool(torch.isfinite(x).all()) for x in (s.u, s.v, s.p))
        if not finite or s.nt != 17:
            raise AssertionError(f"NS-2D {dtype}: finite={finite} "
                                 f"nt={s.nt}")
        log(f"NS-2D dcavity 4096² {dtype}: {r['ms_per_step']:.3f} "
            f"ms/step (host clock); PRE {r['pre']:.3f} / solve "
            f"{r['solve']:.3f} / POST {r['post']:.3f} ms (CUDA "
            f"events), t={s.t:.6e}")
        runs[dtype] = s

    # each dtype's run is a path of its own: counts set to 0 before it
    # and read after it
    counts = [drive_path(kb, "Poisson bf16", kernels[:1], poisson)[0],
              drive_path(kb, "NS-2D bf16", kernels,
                         lambda: ns2d("bfloat16"))[0],
              drive_path(kb, "NS-2D float32 (the comparison run)",
                         ("rb_sor_quarters", "ns2d_pre", "ns2d_post"),
                         lambda: ns2d("float32"))[0]]
    lo, hi = runs["bfloat16"], runs["float32"]
    gaps = {k: float((getattr(lo, k).float() - getattr(hi, k)).abs().max())
            / max(1.0, float(getattr(hi, k).abs().max())) for k in "uvp"}
    log(f"bf16 against float32 after 17 steps, max |diff| / scale: "
        f"u {gaps['u']:.4f}, v {gaps['v']:.4f} (limit 0.05), p "
        f"{gaps['p']:.4f} (logged); t {lo.t:.6e} vs {hi.t:.6e}")
    if not (gaps["u"] <= 0.05 and gaps["v"] <= 0.05):
        raise AssertionError(f"bf16 run strays from float32: {gaps}")
    return counts


def bf16_dcavity_par(tmp):
    """configs/dcavity.par at tpu_dtype bfloat16 with te BF16_TE, in tmp."""
    import re

    path = dcavity_par(tmp, BF16_TE)
    text = open(path).read()
    with open(path, "w") as fh:
        fh.write(re.sub(r"^tpu_dtype .*$", "tpu_dtype bfloat16", text,
                        flags=re.M))
    return path


@phase(f"configs/dcavity.par at bf16, te {BF16_TE}: the CPU half started")
def bf16_cli_start():
    tmp = tempfile.mkdtemp(prefix="bf16_cpu_")
    BF16_RUN["tmp"] = tmp
    par = bf16_dcavity_par(tmp)
    env = dict(os.environ, OMP_NUM_THREADS="4", PAMPI_VERBOSE="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    BF16_RUN["proc"] = start(
        [sys.executable, "-m", "pampi_tpu_torch", "--device", "cpu", par],
        tmp, os.path.join(tmp, "cli.log"), env)


@phase(f"main path: python -m pampi_tpu_torch configs/dcavity.par at bf16, "
       f"te {BF16_TE}, card vs CPU")
def bf16_cli(np):
    import io

    from pampi_tpu_torch import cli
    from pampi_tpu_torch.kernels import build as kb
    from pampi_tpu_torch.models.ns2d import NS2DSolver
    from pampi_tpu_torch.utils.datio import read_pressure, read_velocity

    if "proc" not in BF16_RUN:
        raise AssertionError("the CPU half did not start")
    tmp = BF16_RUN["tmp"]
    card = os.path.join(tmp, "card")
    os.makedirs(card)
    par = bf16_dcavity_par(card)
    write, got = NS2DSolver.write_result, {}

    def record(self, *a, **kw):
        got.update(nt=self.nt, t=self.t)
        return write(self, *a, **kw)

    def run():
        cwd = os.getcwd()
        os.chdir(card)
        try:
            with contextlib.redirect_stdout(io.StringIO()), \
                    mock.patch.object(NS2DSolver, "write_result", record):
                rc = cli.main(["pampi_tpu_torch", "--device", "cuda", par])
        finally:
            os.chdir(cwd)
        if rc != 0:
            raise AssertionError(f"the card half exited {rc}")

    t0 = time.perf_counter()
    counts, _ = drive_path(kb, "dcavity.par bf16", (
        "rb_sor_quarters_bf16", "ns2d_pre_bf16", "ns2d_post_bf16"), run)
    log(f"cuda: {got['nt']} steps to t={got['t']:.6f} in "
        f"{time.perf_counter() - t0:.1f} s")
    proc = BF16_RUN["proc"]
    rc = proc.wait(timeout=600)
    out = open(os.path.join(tmp, "cli.log")).read()
    if rc != 0:
        log(out[-4000:])
        raise AssertionError(f"the CPU half exited {rc}")
    took = [ln for ln in out.splitlines() if ln.startswith("Solution took")]
    steps = sum(ln.startswith("TIME ") for ln in out.splitlines())
    gaps = []
    for name in ("pressure.dat", "velocity.dat"):
        reader = read_pressure if name == "pressure.dat" else read_velocity
        a = reader(os.path.join(card, name))
        b = reader(os.path.join(tmp, name))
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            gaps.append(float(np.abs(x - y).max())
                        / (BF16_ULP * max(1.0, float(np.abs(y).max()))))
    log(f"cpu: {took[-1] if took else 'no timing line'}, {steps} steps; "
        f"card {got['nt']} steps; max |card - cpu| over the .dat fields "
        f"{max(gaps):.3g} bf16 ulps of scale (limit 1)")
    if steps != got["nt"] or not max(gaps) <= 1.0:
        raise AssertionError(f"bf16 CLI: steps {got['nt']} vs {steps}, "
                             f"gaps {gaps}")
    return counts


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import pampi_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    build_kernels()
    rows = counts = None
    if not FAILED:
        check_kernels(torch, np)
        check_k1(torch, np)
        check_kernels_3d(torch, np)
        check_k6_onchip(torch, np)
        check_mg_kernels(torch, np)
        check_repeat_solves(torch)
        check_qdist_kernel(torch, np)
        halo_on_card(np)
        check_dist3d_kernels(torch, np)
        check_cadence_one(torch, np)
        check_dist2d_kernels(torch, np)
        check_obstacle3d_kernels(torch, np)
        check_ragged3d_kernels(torch, np)
        check_obstacle2d_kernels(torch, np)
        check_class_kernel(torch, np)
        check_sor_class_kernels(torch, np)
        check_class3d_kernels(torch, np)
        check_band_kernels(torch, np)
        check_bf16_kernels(torch, np)
    if CHECKS_ONLY:
        log(f"checks only; failed: {FAILED}")
        return 1 if FAILED else 0
    if not FAILED:
        rows = time_kernels(torch, np)
        rows3 = time_kernels_3d(torch, np)
        mg_rows = time_mg_kernels(torch, np)
        q_rows = time_qdist(torch, np)
        d3_rows = time_dist3d(torch, np)
        d2_rows = time_dist2d(torch, np)
        o3_rows = time_obstacle3d(torch, np)
        r3_rows = time_ragged3d(torch, np)
        o2_rows = time_obstacle2d(torch, np)
        cli_rows = time_obsdist_cli(torch, np)
        sor_cli_rows = time_sor_cli(torch, np)
        k18_rows = time_class_kernel(torch, np)
        sor_class_rows = time_sor_class_kernels(torch, np)
        class3d_rows = time_class3d_kernels(torch, np)
        band_rows = time_band_kernels(torch, np)
        bf16_rows = time_bf16_kernels(torch, np)
        sor_ns2d = {}
        counts = main_path(torch, sor_ns2d)
        counts3 = main_path_3d(torch)
        counts_mg = main_path_mg(torch, sor_ns2d.get("ns2d_flat0"))
        ns3d_vs_fixtures(np)
        mg_fft_card_vs_cpu(torch)
        counts_dist = main_path_dist(
            torch, None if q_rows is None else q_rows["rb_sor_qdist"])
        counts_cli = dist_cli(np)
        counts_d3 = main_path_dist3d(torch)
        ns3d_dist_vs_fixtures(np)
        counts_d3cli = dist3d_cli(np)
        counts_d2 = main_path_dist2d(torch)
        counts_d2cards = dist2d_several_cards(torch)
        counts_o3 = main_path_obstacle3d(torch)
        counts_r3 = main_path_ragged3d(torch)
        counts_o2 = main_path_obstacle2d(torch)
        counts_omg = main_path_obstacle_mg(torch)
        counts_fl = main_path_fleet(torch)
        counts_fs = main_path_fleet_sor(torch)
        counts_f3 = main_path_fleet_3d(torch)
        counts_ov = main_path_overlap(torch)
        counts_bf = main_path_bf16(torch)
        fleet_card_vs_cpu(np)
        # no times are taken from here on: the CPU half of dcavity_card
        # and the canal3d_obstacle.par mesh and CPU runs run beside the
        # card's runs
        obstacle3d_cli_start()
        obstacle2d_cli_start()
        obstacle_mg_cli_start()
        ragged3d_cli_start()
        bf16_cli_start()
        dist2d_card_start()
        dcavity_card(np)
        counts_d2cli = dist2d_cli(np)
        dcavity_card_vs_cpu(np)
        counts_o3cli = obstacle3d_cli(np)
        counts_o2cli = obstacle2d_cli(np)
        counts_omgcli = obstacle_mg_cli(np)
        counts_r3cli = ragged3d_cli(np)
        counts_bfcli = bf16_cli(np)
        if None not in (rows, rows3, mg_rows, q_rows, d3_rows, d2_rows,
                        o3_rows, r3_rows, o2_rows, cli_rows, sor_cli_rows,
                        k18_rows, sor_class_rows, class3d_rows, band_rows,
                        bf16_rows, counts_bf, counts_bfcli,
                        counts_fs, counts_f3, counts_ov, counts,
                        counts3,
                        counts_mg, counts_dist, counts_cli, counts_d3,
                        counts_d3cli, counts_d2, counts_d2cards,
                        counts_d2cli, counts_o3, counts_o3cli, counts_o2,
                        counts_o2cli, counts_fl, counts_omg,
                        counts_omgcli, counts_r3, counts_r3cli):
            rows = {**rows, **rows3, **mg_rows[0], **q_rows, **o3_rows,
                    **o2_rows, **k18_rows, **sor_class_rows, **class3d_rows,
                    **band_rows, **bf16_rows,
                    "rb_sor_odist": d3_rows["rb_sor_odist"],
                    "rb_sor_obsdist": {**d2_rows["rb_sor_obsdist"],
                                       **o2_rows["rb_sor_obsdist"],
                                       **cli_rows["rb_sor_obsdist"]}}
            rows["rb_sor_obsdist3d"] = {**rows["rb_sor_obsdist3d"],
                                        **cli_rows["rb_sor_obsdist3d"]}
            for name, extra in sor_cli_rows.items():
                rows[name] = {**rows[name], **extra}
            for name in ("ns3d_pre", "ns3d_post"):
                rows[name] = {**rows[name], **d3_rows[name]}
            for name, row in r3_rows.items():
                rows[name] = {**rows.get(name, {}), **row}
            for name in ("ns2d_pre", "ns2d_post"):
                rows[name] = {**rows[name], **d2_rows[name]}
            # each path ran with the counts at 0 before it: a kernel's
            # main-path launches are its sum over the paths
            paths = (counts + counts3 + counts_mg + counts_d3 + counts_d2
                     + counts_d2cli + counts_o3 + counts_o3cli + counts_o2
                     + counts_o2cli + counts_omg + counts_omgcli
                     + counts_r3 + counts_r3cli + counts_ov + counts_bf
                     + [counts_dist, counts_cli, counts_d3cli, counts_bfcli,
                        counts_d2cards, counts_fl, counts_fs, counts_f3])
            counts = {k: sum(c.get(k, 0) for c in paths)
                      for k in set().union(*paths)}
            print(json.dumps({"library": mg_rows[1]}))
        else:
            rows = counts = None
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        card = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        log(f"nvidia-smi: {exc}")
        FAILED.append("nvidia-smi")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if FAILED or rows is None or counts is None:
        log(f"chip_smoke FAILED: {FAILED}")
        return 1
    from pampi_tpu_torch.kernels import build as kb

    kernels = []
    for name, k in kb.KERNELS.items():
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=k.source, replaces=k.replaces,
            launches=counts.get(name, 0), library_ms=None,
            **{"shape": "x".join(map(str, MAIN)), **r}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-child"]:
        sys.exit(cli_child(*sys.argv[2:4]))
    if sys.argv[1:2] in (["--cli2-child"], ["--cli3-child"]):
        sys.exit(cli_ns_child(int(sys.argv[1][5]), *sys.argv[2:5]))
    if sys.argv[1:2] == ["--kernel-times"]:
        sys.exit(kernel_times(sys.argv[2] if len(sys.argv) > 2 else ROOT,
                              sys.argv[3:]))
    try:
        code = main()
    finally:
        stop_procs()
    sys.exit(code)
