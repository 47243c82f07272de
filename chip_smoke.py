#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls,
after building the hand-written CUDA kernels from ``ops/csrc`` and holding
each against its plain torch version on the card: the flagship scene, a
256×256 mass-spring cloth over the lit, textured globe, stepped 5
simulated seconds (2,400 substeps at 480 Hz) and rendered at 256×256
(``ClothScene.simulate``/``render`` and the CLI); batched datagen, 4,096
worlds of the 60×60 reference cloth stepped and rendered to 256×256
frames and compressed (``generate_trajectory_dataset`` and the CLI's
``datagen``/``decode``); and training through the simulator, the gravity
fit of ``examples/differentiable_cloth.py`` at 256² through
``models.cloth.multi_step_diff`` (K1 forward, the substep adjoint of
``ops/csrc/cloth_grad.cu`` backward); and the granular pile, 1M particles
with sorted-grid contact stepped 2 simulated seconds at 240 Hz through
the granular kernel of ``ops/csrc/granular_step.cu`` and rendered
(``GranularScene`` and the CLI's ``granular``); gradients through granular
contact at 1M (``granular.multi_step_diff``: the pair-force kernel K11
forward, K11 and its directional derivative K12 backward) and the
system-identification fit of ``examples/inverse_granular.py``; and cloth
self-collision at 256² (``ClothScene(self_collide=True)`` and the CLI's
``cloth --self-collide``: K11 on the cloth's thin candidate set and the
cloth substep with a force plane K1f), with its gradient; the
free-particle box, 10 textured spheres in a wireframe box drawn at
600×800 through the untiled sphere raster K4 of
``ops/csrc/sphere_raster_untiled.cu`` (``FreeParticleScene`` and the CLI's
``particles``); and the mesh scenes at 600×800 (``CubeScene``,
``TexturedCubeScene``, ``GlobeScene`` with and without the mesh, and the
CLI's ``cube``, ``textured`` and ``globe``); and the flagship cloth at
1024² (``ClothScene`` and ``cloth --grid 1024``), one world above 100,000
particles, which takes K6r of ``ops/csrc/cloth_tiled.cu`` (the whole call
in one cooperative launch on tiles resident in shared memory), with its
gradient, and at 2048² the temporal-blocking kernel K6; and the multi-device
paths on four shards of the one card (``parallel.mesh``: the 1024² cloth
cut into bands of rows with halo exchange on the row-window kernel K6w of
``ops/csrc/cloth_tiled.cu`` (each shard's window lies above 100,000
particles), a batch of row-sharded 256² worlds on K1w, worlds-sharded K5;
``parallel.granular_mesh``: the 1M pile cut into blocks of sorted slots
on the granular kernel with a base, K10b, and the worlds-sharded granular
gradient; ``examples/multichip_datagen.py``); and the same rows path
under autograd (``examples/multichip_training.py``, the stiffness fit
over 8 shards of the card, and value_and_grad of the two rows cells:
K1w or K6w forward, the window trace and the window adjoint of
``ops/csrc/cloth_grad.cu`` backward). Phases:

1. the card: CUDA present, ``nvidia-smi`` name and power limit;
2. the build of the six kernel libraries (one nvcc each, all started
   together, timed);
3. the cloth kernel vs its plain version at 256² with the top row pinned:
   1 substep <= 1e-6 abs, 240 substeps <= 1e-5 on pos, fast_math vs the
   exact path <= 1e-4 after 330 substeps, and the fast_math kernel within
   1e-6 of its fast plain version;
4. the sphere-raster kernel vs its plain version (the full sweep over
   every instance, which ignores the bins) on the 65,536 instances of
   phase 3's 240-substep state, at 256×256 and at a ragged 800×1200:
   ``hit`` identical on >= 99.99% of pixels, the same winner on >= 99.99%
   of hit pixels, ``tmin`` <= 1e-6 wherever both hit and ``oc`` <= 1e-6
   where the winner agrees, misses exactly (+inf, 0), and all three
   outputs equal bit for bit (as in phases 9 and 14 and on the K4
   comparison frames of phase 18);
5. the main path, with the kernel launch counters reset just before it and
   read just after: finite state resting on the globe (r_min within 1e-3
   of R + r), the ensemble contract against the plain version's run of the
   same scene (mean/min radius 1e-3 relative, mean height 2e-3 relative),
   and an image with both globe and particle pixels;
6. times on the card (CUDA events, best of 3 after a warm-up) of each
   kernel and its plain version, and of one whole frame; each kernel is
   timed a launch at each main-path site (K5 one substep on one chunk of
   worlds and on the datagen CLI's 64; K11 on the self-collision set and
   at 1M; the raster on the flagship frame, a datagen chunk, the datagen
   CLI's call, the granular, self-collision, free-particle CLI and
   large-grid frames and a multi-device shard; K6w on a rows shard's
   window, K1w on a composed shard's), and the script prints the kernels
   ranked
   by launches × (ms − bound) summed over their sites;
7. where the time goes (PERF.md section 5): the raster's candidates per
   tile, the spread of repeated timings, and one ``torch.profiler`` trace
   each of 240 substeps and of one frame, read for the kernel time per
   launch, the gaps between launches and the device's idle share;
8. the batched-worlds cloth kernels on the 60×60 reference cloth with
   per-world parameters, 24 substeps, free and with the top row pinned,
   first fresh (in free fall) and then settled 3 s on the globe (where the
   contact, friction and projection branches run: the shares of particles
   in contact and projected are reported and must be above zero): K5 on
   4096 worlds against its plain version and against the single-world
   kernel on worlds 0, 1 and 4095 (<= 1e-6, bitwise reported), finite, 24
   launches; K5r (a CTA a world, the datagen chunk's kernel) on the first
   1,024 against the plain version, K5 and K1 on worlds 0, 1 and 1023, bit
   for bit, one launch;
9. one batched raster launch on a chunk of 1,024 settled worlds (the
   datagen path's launch) at 256×256 against the plain sweep on worlds 0,
   511 and 1,023, under phase 4's contract;
10. the datagen path, with the launch counters reset just before it and
   read just after: ``generate_trajectory_dataset`` over 4096 settled
   worlds, 3 frames of 24 substeps at 256×256, randomized cameras, codec
   k = 16, then the CLI's ``datagen`` and ``decode`` (K5r a frame on every
   chunk of 1,024 and on the CLI's 64 worlds, K5 never; the epilogue
   kernel a raster launch, the rays kernel a raster launch and a cached
   globe's pass); the rays and epilogue kernels on the first chunk of
   1,024 worlds against their plain versions bit for bit, and the uint8
   entry ``draw_instanced_spheres_rgb8`` against its plain route, with
   misses, cloth pixels and cloth the globe hides, then each kernel timed
   beside its plain chain and its bound; cloth and globe
   pixels in >= 90% of worlds, the yielded frame 0 equal to the codec of
   the raw frame 0 (its decoded PSNR reported), the codec >= 28 dB mean
   PSNR on the worlds' cached globes; on 16 worlds, the kernel path's
   frames equal to the same path's with the plain stepper, sweep and
   rays and the uint8 entry's plain route, and within uint8 1 of ``use_kernel=False`` on >= 99.9% of the pixels.

Then phases 6 and 7 for the datagen path: K5 and K5r a call of 24
substeps, per substep, on a chunk of 1,024 worlds, the CLI's 64 and a
multi-device shard of 16, beside the plain version and the call's bound
(the bytes once, the operations of every substep), phase 9's raster launch
and one on a multi-device shard
(16 worlds at 64×64), one steady frame of
4,096 worlds with and without the codec, the copy into pinned memory, and
one ``torch.profiler`` trace of a frame split into K5r, raster, composite,
codec and copy with the device's idle share.

11. the substep adjoint vs its plain version at 256² with the top row
   pinned, on phase 5's draped state (the share of particles in contact is
   reported and must be above zero) and on a free-fall state: one substep
   (state, parameter and pin cotangents <= 1e-5 max-relative, the state
   and pin cotangents bit for bit) and a walk over the segment's trace
   (one launch a substep; state and pin cotangents bit for bit, the
   parameter cotangent <= 1e-5), ``multi_step_diff`` over a 48-substep
   segment (gradients of a
   fixed random linear loss <= 1e-4 max-relative against the same path
   with the plain stepper, trace and adjoint), the trace's last state equal
   to the forward's output bit for bit; and the same at 1024² over 4
   substeps;
12. the training path, with the launch counters reset just before it and
   read just after: the example's gravity fit at 256² (``--kernel``, 480
   substeps, segment 48, 8 iterations); the loss falls, all is finite, K1
   and the adjoint launched the expected number of times; then one Newton
   step from the kernel gradient (240 substeps) lands the COM height within
   1e-3 of its target.

Then phases 6 and 7 for the training path: the adjoint (one launch a
substep) per substep beside its plain version and bound at 256² and at
1024², value_and_grad of 480
substeps at 256² (particle-steps/s; the plain path on 48), K1 per substep
at 512² and 1024², and one ``torch.profiler`` trace of a 48-substep
value_and_grad with the kernel time per launch, the gaps and the device's
idle share.

13. the granular kernel (K10) vs its plain version at 1M particles over
   the rebuild's candidate set, for the default configuration and the
   bench's (thin CIV, slab 640, rebuild every 16), on the fresh lattice
   (there also the window formulation and an undersized slab, whose
   dropped count must be above zero) and on phase 14's pile: one substep
   pos and vel <= 1e-5, one rebuild block pos <= 1e-5 and vel <= 1e-4; the
   share of particles in contact (above zero on the pile) and the dropped
   count, exact and the fast indicator;
14. the granular main path, with the launch counters reset just before it
   and read just after: ``GranularScene`` at 1M, ``simulate(2.0)`` at 240
   Hz, a 256×256 frame and the ``granular`` CLI; K10 launched once a
   substep, all finite and inside the box, the pile fallen, the ensemble
   (mean and max height, kinetic energy) within 1e-2 relative of the plain
   version's run of the same scene, sand and wireframe pixels in the frame
   and the CLI's PNG; then the raster kernel against its plain version on
   that frame's own bins (1M instances), as in phase 4.

Then phases 6 and 7 for the granular path: K10 per substep at 1M beside
its plain version and its bound from the run's candidate slots (10
operations each) and touching pairs (11 more each) (both
configurations on the fresh lattice, the default one on the pile), the
rebuild, ``multi_step``'s particle-steps/s (bench configuration, 64
substeps, best of 3: the counterpart of ``bench.py``'s ``granular_1m``),
and one ``torch.profiler`` trace of a rebuild block split into rebuild,
K10 and idle.

15. the contact kernels against their plain versions: K11 and K12 at 1M
   on phase 13's fresh lattice in the default and the bench
   configurations, and on the self-collision candidate set (thin, block
   256, slab 640) of phase 5's draped cloth: the force and J·u within 1e-5
   relative to the largest component (bitwise reported), K12's force equal
   to K11's, ``<J u, v>`` against ``<u, J v>`` within 1e-4 relative where
   nothing is dropped, and K11 with the plain integrate equal to one K10
   substep bit for bit; K1f at 256² with the top row pinned and that set's
   forces equal to its plain version bit for bit, in grid order and as the
   self-collision block calls it (the forces in the set's sorted order
   through the inverse permutation, the next sorted positions written),
   the two entries equal, and with a zero force plane equal to K1 bit for
   bit;
16. the granular gradient path, with the launch counters reset just before
   it and read just after: ``granular.multi_step_diff`` at 1M, default
   configuration, 16 substeps at 240 Hz (two segments), on the fresh
   lattice lowered to the floor so that the restitution branch fires
   (nothing dropped); the primal against ``multi_step`` (pos 5e-7, vel
   5e-6), the gradients of a fixed linear loss w.r.t. pos, vel, dt, k,
   g and e finite, nonzero and within 1e-4 max-relative of the same path
   with the plain K11 and K12; K11 launched twice a substep (forward and
   the backward's re-run), K12 once; then the example's fit (150 Adam
   iterations), whose loss must fall 10×;
17. the self-collision path, with the launch counters reset just before
   it and read just after: ``ClothScene`` 256² ``self_collide=True``,
   ``simulate(2.0)``, a frame and the CLI's ``cloth --self-collide``; K11
   and K1f launched once a substep; finite, r_min >= R + r - 1e-3, nothing
   dropped over the scene's schedule, globe and particle pixels; one
   rebuild block on the scene's end state equal bit for bit to the same
   block with K1f's plain version; then
   ``multi_step_self_collide_diff`` over 16 substeps of the scene's end
   state: the gradients of pos, vel, dt and every ``ClothParams`` leaf
   within 1e-4 max-relative of its plain versions.

Then phases 6 and 7 for these paths: K11 and K12 a launch at 1M, K11 on
the self-collision set of phase 17's cloth (the scene's slab; its bound
from that set's candidate slots and touching pairs) and K1f at 256² beside
their plain versions and bounds (K12's operations from its own body; K1f's
device time a launch from the traced block, its bound from the 76 bytes a
particle of its sorted site), one rebuild block of 8 substeps by CUDA
events and host clock,
granular value_and_grad particle-steps/s at 1M (16 substeps),
the counterpart of ``bench.py``'s ``self_collide_256`` (256², 512
substeps, rebuild every 32, slab 640, skin 0.5·r), and one
``torch.profiler`` trace each of a granular gradient segment and of a
self-collision rebuild block split into rebuild, the kernels, the rest
and idle.

18. the free-particle box (sim 4), with the launch counters reset just
   before its main path and read just after: two ``FreeParticleScene``s
   (documented-correct and ``bug_compat``), ``simulate(3.0)`` and a
   600×800 frame each (a frame the untiled raster K4 draws: one launch
   each), the CLI's ``particles --size 600 800`` (K4 once, the tiled
   kernel never) and ``particles`` at 256×256 (the tiled kernel once, K4
   never); all finite, |pos| <= bounds - radius + 1e-5 in the correct
   mode, sphere and wireframe pixels, each frame within 1 in u8 of the CPU
   frame of the same state on >= 99.9% of pixels; then K4 against its
   plain version (also at 601×799, the kernel's scalar accesses) and
   against the tiled kernel, with its bound from 7 operations a (pixel,
   instance) pair and 4 more on the pairs with disc > 0, and the tiled
   kernel
   against the full sweep, bit for bit, on the scene's frame (10
   instances) and on 16,384 (K4's ceiling: radius 0.25,
   uniform in the box), with K4's, the plain version's and the tiled
   kernel's times, K4's bound, one scene frame's time and one
   ``torch.profiler`` trace of a frame (K4's device time a launch, the
   device's busy time and idle share);
19. the mesh scenes at 600×800: ``CubeScene``, ``TexturedCubeScene``,
   ``GlobeScene`` (analytic and ``use_mesh=True``), each within 1 in u8 of
   its CPU frame on >= 99.9% of pixels, showing geometry, with its ms a
   frame; ``draw_mesh`` tile-binned against brute on the 16,128-triangle
   globe (equal on >= 99.9% of pixels, nothing dropped) with both times;
   one trace each of a cube and a mesh-globe frame; the CLI's ``cube``,
   ``textured`` and ``globe``;
20. the large-grid path, one world above 100,000 particles: K6r (the
   whole call in one cooperative launch, tiles resident in shared memory)
   and K6 (``ops/csrc/cloth_tiled.cu``) against K6's plain version, K1 and
   each other, bit for bit, at 512², 1024² and a ragged 1000×1030, fresh
   and draped on the globe (the share of particles in contact is reported
   and must be above zero), top row pinned plus one pin on a tile corner,
   over 8 and 13 substeps, on the ragged shape K6 also with two deeper
   schedules (k = 2 and 4), and K6 alone at 2048² (8 substeps), above
   K6r's reach; then, with the launch counters reset just before it and
   read just after, ``ClothScene`` at 1024², ``simulate(2.0)``, one frame
   of its schedule (``update(1/60)``), a 256×256 render, the CLI's
   ``cloth --grid 1024`` and ``ClothScene`` at 2048² ``simulate(0.1)``:
   K6r launched once a 1024² call, K6 ⌈n/K⌉ times on the 2048² call and
   K1 never, finite, r_min >= R + r - 1e-3, globe and particle pixels, the
   1024² end state equal bit for bit to the same scene with the route held
   on K1; and ``multi_step_diff`` at 1024² over one 48-substep segment,
   whose trace's last state (K1) equals its forward (K6r) bit for bit.

Then phases 6 and 7 for the large-grid path: K6r, K6 and K1 a substep at
512², 1024² and 2048² (K6r where its tiles fit) beside the bound, K6's
plain version at 512² and 1024², K6's schedule sweep at the three sides,
the ptxas report, particle-steps/s of 3,000 substeps at 1024² through the
path's call (K6r), and one ``torch.profiler`` trace of 240 substeps at
1024² through the path's call (K6r's one launch, its time a substep, the
device's idle share; the profiler's schedule warms it up on the same call
first, and the launch is matched to the traced call by correlation id).

21. the multi-device paths, each shard a tensor on the one card: K1w and
   K6w on the four row windows of the 1024² cloth (fresh and draped, top
   row pinned; the top window's ``row0`` < 0, its leading rows dead) over
   k = 1, 2 and 4 substeps against their plain versions and each other on
   the whole windows and, on the centre rows, against K1 and K6 on the
   whole grid, bit for bit; then, with the launch counters reset
   just before it and read just after (the references run first),
   ``spatial_multi_step`` at 1024² on 4 row shards, 480 substeps at k = 1
   and k = 2, equal bit for bit to ``cloth_kernel.multi_step`` (K6r);
   ``batched_spatial_multi_step`` on a (2, 2) worlds × rows mesh, 8
   worlds of the 256² flagship, 480 substeps, k = 2, each world equal to
   K1 alone; ``batched_multi_step`` of 64 worlds on 4 shards (K5 on 16
   worlds a shard) equal to K5r on the whole batch; ``multi_step_sharded`` on the 1M pile over 4
   grain shards, 8 substeps equal to ``granular.multi_step`` (K10) bit
   for bit and 64 within pos 1e-4 / vel 1e-3 with the single-device
   path's dropped count; ``multi_step_diff_sharded`` of 2 worlds of the
   lowered 1M lattice on 2 shards, 16 substeps, its gradients within 1e-5
   of the per-world serial sum; ``batched_self_collide_multi_step`` of 4
   worlds of the 256² self-collision configuration (the scene's schedule)
   on 2 worlds shards, 240 substeps, each world equal bit for bit to
   ``multi_step_self_collide`` alone, and world 0 to the same run with
   K1f's plain version; ``examples/multichip_datagen.py`` at its
   defaults; every launch count as the path predicts (K6w on the rows
   path, K1w on the composed one, one launch a substep for its 16
   windows on the card, K5 on the worlds shards; K1, K6, K6r,
   K5r and K10 never). Then K10b on each of the 4 slices against its plain
   version and the same rows of K10, bit for bit.

Then phases 6 and 7 for the multi-device paths: K1w a substep on a 1024²
window beside K1 and K6; K6w on one rows shard's window (the raw kernel,
the routed call over 240 substeps and in the path's calls of 2) beside K1w
there, with its plain version and bound; K1w on a composed shard's window
(raw and routed) and on the path's launch, a batch of its 16 windows,
its plain version and bound, and K1w against its plain
version bit for bit on the whole of the composed path's 136×256 windows
(the timed one, and top and bottom of the fresh and the draped cloth,
pinned, at 1 and 2 substeps; the kernels line's ``max_abs_err`` for K1w);
K10b's device time a launch on each slice beside K10's (traced,
``trace_k10b.json``), its plain version and the bound of its slice;
particle-steps/s of the row-sharded 1024² cloth (k = 1, 2) beside K6 and
of the grain-sharded pile beside K10; and one ``torch.profiler`` trace of
8 row-sharded substeps at 1024² (``trace_rows_block.json``: K6w, the halo
copies, the rest, the device's idle share).

22. granular datagen, counted: ``generate_granular_dataset`` on 256
   worlds of the CLI's 20,000-particle pile in chunks of 64, 3 frames of
   12 substeps at 240 Hz, 256×256, randomized cameras, codec k = 16
   (K10 a world a substep, the batched raster, the rays kernel and the
   epilogue kernel a chunk a frame), then the
   CLI's ``datagen --family granular`` (through the native shard writer)
   and ``decode``: two worlds equal ``granular.multi_step`` with their
   materials bit for bit, every world's frame shows sand and box pixels,
   the decoded frames have the raw frames' shape; the rays and epilogue
   kernels and the uint8 entry on the first chunk in sand, as in phase
   10. Then K10 on a world of
   the run (its materials in the parameter vector) and the raster on the
   first chunk, each against its plain version on those inputs (K10 bit
   for bit over a rebuild block; the raster on the chunk's first, middle
   and last worlds under phase 4's contract) and timed beside its bound;
   the steady frame a world (CUDA events and the host clock), egress and
   peak memory; one traced frame of a chunk (its idle share, top ops).
23. the differentiable render: the gradients of
   ``tests/test_torch_cuda.py``'s instanced-sphere loss on the card at
   32×48 (K4) and 32×128 (K2/K3) against the CPU route within that
   file's ``DIFF_RENDER_TOL``; the loss frame, the flagship frame and a
   datagen frame equal bit for bit with and without a gradient; then,
   counted, the port's ``examples/inverse_rendering.py``: the light
   within 20° in 6 iterations and the gravity fit within 0.01 of −22.5
   (K4, K1 and the adjoint); and the example's sites (K4 at 48×64 with
   256 spheres, K1 and the adjoint's walk at 16²) against their plain
   versions on the inputs they are timed on, bit for bit.
24. ``cloth --live --seconds 1`` in a process without a terminal: exit
   code 0 and 20 ANSI frames.
25. the differentiable rows path: K1w, the window trace (K1w's body,
   ``cloth_kernel.trace_window``) and the window adjoint
   (``cloth_grad.cu``'s ``WINDOW`` instantiation), each one launch a
   substep for a batch of windows, against their batched plain versions
   on the batches the path gives them: the training example's 16 windows
   of 16×16 of one block (its start and half its rollout; top and bottom
   windows, 4 dead rows each, half the worlds pinned and half with a zero
   mask), the composed cell's 16 of 136×256 (draped and pinned, and fresh
   with seeded velocities) and the rows cell's 4 of 264×1024 (draped,
   pinned; K6w forward, a window at a time): the trace, the forward and
   the state, pin and parameter cotangents bit for bit (the plain version
   sums the parameter cotangent in the kernel's order), and each window
   equal bit for bit to its ``B = 1`` calls (a zero mask to no pins), the
   batch's parameter cotangent within 1e-5 of the windows' sum; then,
   counted, the port's
   ``examples/multichip_training.py`` at its defaults (8 shards of the
   card, 60 iterations: ``k_struct`` within 1% of the truth from 2× off)
   and one value_and_grad of each rows cell (8 worlds of 256² on a (2, 2)
   worlds × rows mesh; the 1024² cloth on 4 rows shards; 48 substeps at
   k = 2, a trajectory-matching loss, gradients in log k_struct and pos0),
   every count exact (one window call a block for all the card's
   windows: the example's K1w 976, trace 480, window adjoint 960); each
   cell's gradients against the whole-grid
   adjoint (``cloth_grad_kernel.multi_step``) within 1e-5 of max|g|;
   the value_and_grads by host clock and CUDA events, each traced once
   (``trace_rows_grad_*.json``), and phase 6 at each site on the batch
   of its launch (the window adjoint beside the whole-grid adjoint on one
   window's rows, in turns).

Any failed check raises, so the script exits non-zero; with no CUDA device
it exits non-zero before doing anything. The next-to-last line of stdout is
``{"kernels": [...]}`` (each kernel with its ``sites``: launches, ms a
launch, bound and ``lost_ms`` at each main-path site, None where this run
does not time that shape); the last is ``{"ok": true, "device": {...}}``.
The ``cloth_step`` launches are those of phases 5, 12 and 23 (K1 steps the
flagship and runs the training path's and the example's forward and
traces), ``cloth_substep_vjp`` those of phases 12 and 23,
``granular_step`` (K10) those of phases 14 and 22; the raster's
those of phases 5, 10, 14, 17, 18, 20, 21 and 22; ``cloth_step_batched`` (K5)
those of phase 21 (phase 10's datagen runs none), ``cloth_tiled_batched``
(K5r) phase 10's, one a frame of a chunk; ``granular_forces`` (K11) those of phases 16, 17 and
21, ``granular_force_jvp`` (K12) phases 16's and 21's,
``cloth_step_force`` (K1f) phases 17's and 21's, ``sphere_raster_untiled``
(K4) phases 18's and 23's, ``cloth_tiled_resident`` (K6r) phase 20's (the 1024²
scene, frame and CLI, and the gradient segment's forward, a launch a
call: its sites count time and bound a substep), ``cloth_tiled`` (K6)
phase 20's 2048² scene, and ``cloth_tiled_window`` (K6w),
``cloth_step_window`` (K1w) and ``granular_step_sharded`` (K10b) phase
21's, K1w and K6w also phase 25's; ``cloth_substep_vjp_window`` and
``cloth_trace_window`` phase 25's; ``pixel_rays`` and
``flat_composite_rgb8`` (the rays and epilogue kernels of
``pixel_chain.cu``, which replace no Pallas kernel: ``replaces`` is null)
phases 10's and 22's (the rays kernel also serves every other CUDA camera
without a gradient, in phases 5 and 14 to 23, not counted by site).
Images and the full results go to ``chiprun_out/``.

"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out")
HZ = 480.0
DT = 1.0 / HZ
# the flagship configuration: cloth grid side, main frame, ragged frame,
# and substeps timed in phase 6
GRID = 256
FRAME = (256, 256)
RAGGED = (800, 1200)
N_TIME = 3000
# the datagen slice (BASELINE.json configs[4]): worlds of the 60x60
# reference cloth, substeps a frame, frame size, codec coefficients, worlds
# per chunk (four chunks bound the eager composite's temporaries), seed,
# and the substeps (3 s) that drop the fresh worlds onto the globe before
# phase 9, so that the randomized views (aimed at the globe) see the cloth
DG_WORLDS = 4096
DG_STEPS = 24
DG_FB = (256, 256)
DG_K = 16
DG_CHUNK = 1024
DG_CLI_WORLDS = 64
DG_SEED = 0
DG_SETTLE = 1440
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s (no tensor
# cores)
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
# fp32 operations of the cloth function: per spring edge and substep 28
# for the edge force (difference 3, squared length 5, sqrt and reciprocal
# 2, unit vector 3, stretch 1, relative velocity along it 8, force 3,
# components 3) and 6 to add it to both ends; per particle and substep 82
# (gravity 2, globe distance 7, normal 3, penalty 2 + 6, normal force 5,
# tangent 6, its length 7, friction 3 + 9, 1/m 1, velocity 12, position 6,
# projection 7 + 6, counted once for every particle)
OPS_EDGE = 34
OPS_PARTICLE = 82
# per (pixel, candidate) of the sphere sweep: b 5, disc 2, t 3, tests 3
OPS_RAY_SPHERE = 13
# K4's work as any implementation must do it: b and the discriminant for
# every (pixel, instance) pair (b 5, disc 2), and the square root, t and
# the two compares only for the pairs with disc > 0
OPS_DISC, OPS_HIT = 7, 4
# fp32 operations of the substep adjoint (csrc/cloth_grad.cu): per spring
# edge 116, its forward force again (34, the linearization point) and its
# adjoint 82 (difference, length, unit vector, stretch, relative velocity
# and s again 25; Ē 3, s̄ 5, s̄c 1, ū 9, ū·d 5, L̄ 4, d̄ 9, Δv̄ 3, parameter
# terms 3; 12 to add x̄ and v̄ to both ends, 3 to sum k̄, c̄, rest̄); per
# particle 258, the forward integration again (82) and its adjoint 176
# (projection 25, Euler and damping 39, friction 61, contact 40, gravity 4,
# the seven parameter terms 7)
OPS_VJP_EDGE = 116
OPS_VJP_PARTICLE = 258
# bytes a particle and substep the adjoint must move: the trajectory state
# read (24), the incoming cotangent read (24), the outgoing one written (24)
VJP_BYTES = 72
# phase 11's segment (the training path's, examples/differentiable_cloth.py
# SEGMENT), and the grid and substeps of its large check (the size of JAX's
# streamed tier, K9)
FIT_SEG = 48
BIG = 1024
BIG_STEPS = 4
# the granular slice (BASELINE.json configs[2]): particles, substep, the
# main path's simulated seconds (scene) and the CLI's, its frame, the
# bench's configuration (bench.py:172) and its substeps (bench.py:153)
GR_N = 1_000_000
GR_DT = 1.0 / 240.0
GR_SECONDS = 2.0
GR_CLI_SECONDS = 1.0
GR_FRAME = (256, 256)
GR_BENCH = dict(rebuild_every=16, pallas_slab=640, thin=True)
GR_MS_STEPS = 64
SAND = (0.86, 0.65, 0.35)
# fp32 operations of K10 per candidate slot (difference 3, d2 5, the two
# tests 2), per touching pair on top (sqrt and divide 2, weight 3, sums 6)
# and per particle (gravity 1, velocity 6, position 6, per axis 4
# compares, a clamp of 2 and the reflection 1); bytes a particle (pos and
# vel read, the cid read, pos and vel written)
OPS_SLOT = 10
OPS_TOUCH = 11
OPS_GR_PARTICLE = 34
GR_BYTES = 52
# K11 and K12: bytes a particle (K11: pos and cid read, f written; K12: pos,
# the tangent and cid read, f and J.u written) and K12's fp32 operations per
# touching pair on top of K11's (tangent difference 3, d.du 5, g 5, w du -
# g d 9, sums 3)
K11_BYTES = 28
K12_BYTES = 52
OPS_TOUCH_JVP = 25
# the gradient path (phase 16): substeps at 240 Hz (two rebuild segments
# of the default configuration) and the example's Adam iterations
GR_DIFF_STEPS = 16
FIT_ITERS = 150
# cloth self-collision (phase 17, BASELINE.json configs[3]): the scene's
# schedule (rebuild every 8, block 256; its slab is the scene's
# SELF_COLLIDE_SLAB), the default slab (phase 15's candidate set and
# bench.py's self_collide_256), the scene's simulated seconds and the
# CLI's, the differentiable check's substeps, the substeps of
# self_collide_256 (bench.py:185), and the back-to-back launches a kernel
# timing averages over
SC_REBUILD = 8
SC_BLOCK = 256
SC_SLAB = 640
SC_SECONDS = 2.0
SC_CLI_SECONDS = 3.0
SC_DIFF_STEPS = 16
SC_BENCH_STEPS = 512
REPS = 10
# the free-particle box (phase 18): the scene's default frame (600x800, not
# a multiple of (16, 128), so the untiled raster K4 draws it), its
# simulated seconds, and K4's ceiling case: MAX_INSTANCES spheres of radius
# 0.25 uniform in the box (bounds 10), seen by the scene's camera
PT_FRAME = (600, 800)
PT_SECONDS = 3.0
PT_MAX_RADIUS = 0.25
PT_SEED = 0
# the mesh scenes (phase 19): the reference's 800x600 window
MESH_FRAME = (600, 800)
# the large-grid path (phase 20): the grid side (1024², the largest size
# the README gives for the banded kernel), the ragged shape and the
# substeps of the bit-for-bit checks, the substeps that drape a fresh
# cloth on the globe (3 s; it lands at ~2.5 s), the scene's and the CLI's
# simulated seconds and the frame, the sides timed, the substeps of a
# timing and of the rate, the schedules (k, tile_h, tile_w) with k > 1
# also checked on the ragged shape, and those swept beside the default
LG = 1024
LG_RAGGED = (1000, 1030)
LG_SHAPES = ((512, 512), (LG, LG), LG_RAGGED)
LG_STEPS = (8, 13)
LG_DRAPE = 1440
LG_SECONDS = 2.0
LG_CLI_SECONDS = 1.0
LG_FRAME = (256, 256)
LG_SIDES = (512, LG, 2048)
LG_TIME_STEPS = 240
LG_RATE_STEPS = 3000
LG_DEEP = ((2, 17, 54), (4, 9, 46))
LG_BIG = (2048, 2048)
LG_BIG_SECONDS = 0.1
LG_SWEEP = ((1, 12, 57), (1, 24, 57), (1, 47, 57), (1, 20, 115), (2, 8, 54),
            (2, 17, 54))
# the multi-device paths (phase 21), all on shards of one card: the shards
# of the rows, grains and worlds axes; the substeps of the row-sharded LG²
# cloth and of the composed run; the substeps per exchange checked on
# K1w's and K6w's windows; the composed run's worlds of the GRID² flagship (8 worlds
# on a (2, 2) worlds × rows mesh, k = 2; README's example runs 480
# substeps on a worlds × rows mesh); the 60×60
# worlds of the worlds-sharded K5 check; the substeps of the sharded pile's
# bitwise check (one rebuild block) and of its contract check; the
# gradient check's worlds and substeps; the substeps of the traced run
MC_SHARDS = 4
MC_STEPS = 480
MC_KS = (1, 2, 4)
MC_WORLDS = 8
MC_K5_WORLDS = 64
MC_GR_STEPS = (8, 64)
MC_DIFF_WORLDS = 2
MC_DIFF_STEPS = 16
MC_SC_WORLDS = 4
MC_SC_STEPS = 240
MC_TRACE_STEPS = 8
# the differentiable rows path (phase 25): value_and_grad of phase 21's two
# rows cells over RG_STEPS substeps at k = RG_K (136×256 and 264×1024
# windows), the loss at RG_K_OFF times the true k_struct against the
# trajectory from the truth
RG_STEPS = 48
RG_K = 2
RG_K_OFF = 0.8
# the granular datagen path (phase 22): the CLI's family (JAX __main__.py
# :149-159): piles of 20,000 particles (GranularConfig's defaults
# otherwise), 12 substeps a frame at 240 Hz; 256 worlds in chunks of 64
# (a raster call of 64 x 20,000 = 1.28M instances, a third of the cloth
# chunk's 1,024 x 3,600), 3 frames at DG_FB with the codec at DG_K; the
# CLI's worlds
GG_N = 20_000
GG_WORLDS = 256
GG_CHUNK = 64
GG_STEPS = 12
GG_FRAMES = 3
GG_SEED = 0
GG_CLI_WORLDS = 64
# the differentiable render (phase 23): the frames of the instanced-sphere
# loss (K4; K2/K3); the loss and the card's gradients' tolerance against
# the CPU route are tests/test_torch_cuda.py's (_render_loss,
# DIFF_RENDER_TOL)
DR_FRAMES = ((32, 48), (32, 128))
TRACE_TRIES = 3                 # profiled runs of a kept trace at most


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _maxdiff(a, b) -> float:
    return float((a - b).abs().max())


def _best_ms(fn, reps: int = 3) -> float:
    """Best of ``reps`` timed calls after one warm-up, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _best_s(fn, reps: int = 5) -> float:
    """Best of ``reps`` host-clock seconds of ``fn`` ending in a
    synchronize, after one warm-up."""
    import torch

    best = float("inf")
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:
            best = min(best, time.perf_counter() - t0)
    return best


def _union_us(spans) -> float:
    """Length of the union of ``(start, end)`` spans."""
    total, lo, hi = 0.0, None, None
    for a, b in sorted(spans):
        if hi is None or a > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return total + (hi - lo if hi is not None else 0.0)


def _queued_us(fn, reps: int = 3) -> float:
    """Device time of ``fn``'s launches in µs, best of ``reps`` after one
    warm-up: CUDA events around ``fn`` queued behind a ~2 ms sleep, so the
    device reaches the first event only once ``fn`` has issued all its
    work and the host's launch cost falls outside the span."""
    import torch

    fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e3)
    return best


def _trace(fn, path):
    """Run ``fn`` once under ``torch.profiler`` (host and device), write the
    Chrome trace to ``path`` and return its device spans ``(start, end,
    name)`` and host spans ``(start, end)``, in µs on one clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    host = [(e["ts"], e["ts"] + e["dur"]) for e in spans
            if e.get("cat") in ("cpu_op", "cuda_runtime", "user_annotation")]
    _check(bool(dev) and bool(host), f"trace {path}: no device or host spans")
    return dev, host


def _profile(scene, params, wins, card) -> dict:
    """The breakdown of PERF.md section 5, from this run alone: the raster's
    per-tile load, the spread of repeated timings, and one torch.profiler
    trace each of 240 substeps and of one frame (traces to chiprun_out/)."""
    import torch

    from wgpu_physics_engine_torch.core.state import init_cloth_state
    from wgpu_physics_engine_torch.ops import cloth_kernel

    fh, fw = FRAME
    res = {"card": card}
    w = wins.long()
    cand = sum(w[:, 2 * g + 1] - w[:, 2 * g] for g in range(4))
    res["tiles"] = {"n": int(w.shape[0]), "cand_mean": float(cand.float().mean()),
                    "cand_max": int(cand.max()), "global": int(w[0, 7] - w[0, 6])}
    print(f"phase 7 raster tiles @{fh}x{fw}: {res['tiles']['n']} tiles, "
          f"candidates per tile mean {res['tiles']['cand_mean']:.1f} max "
          f"{res['tiles']['cand_max']} (global range {res['tiles']['global']})")

    s_free = init_cloth_state(scene.config, device=scene.device)
    k1 = [_best_ms(lambda: cloth_kernel.multi_step_kernel(
        s_free, params, DT, N_TIME), reps=1) / N_TIME for _ in range(7)]
    host = {}
    for hw, reps in ((FRAME, 7), (RAGGED, 4)):
        scene.render(*hw)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            scene.render(*hw)            # ends in a copy to the host
            ts.append((time.perf_counter() - t0) * 1e3)
        host[f"{hw[0]}x{hw[1]}"] = ts
    res["spread"] = {"cloth_ms_per_substep": k1, "frame_host_ms": host}
    print(f"phase 7 spread [{card}]: cloth {N_TIME} substeps x 7 calls "
          f"{min(k1):.6f}-{max(k1):.6f} ms/substep (CUDA events); frame host "
          f"clock " + ", ".join(f"{k} {min(v):.3f}-{max(v):.3f} ms ({len(v)} "
                                f"runs)" for k, v in host.items()))

    dev, _ = _trace(lambda: cloth_kernel.multi_step_kernel(
        s_free, params, DT, 240), os.path.join(OUT, "trace_substeps.json"))
    sub = [(a, b) for a, b, name in dev if "substep_kernel" in name]
    _check(len(sub) == 240, f"trace shows {len(sub)} substep kernels, not 240")
    span = max(b for _, b in sub) - min(a for a, _ in sub)
    busy = _union_us(sub)
    res["substeps_240"] = {"kernel_us": busy / len(sub), "span_us": span,
                           "busy_share": busy / span,
                           "gap_us": (span - busy) / (len(sub) - 1)}
    print(f"phase 7 trace 240 substeps [{card}]: {busy / len(sub):.3f} us of "
          f"kernel time per launch, span {span:.1f} us, device busy "
          f"{busy / span:.4f} of it, mean gap {(span - busy) / 239:.3f} us")

    dev, host_spans = _trace(lambda: scene.render(fh, fw),
                             os.path.join(OUT, "trace_frame.json"))
    t0 = min([a for a, _ in host_spans] + [a for a, _, _ in dev])
    t1 = max([b for _, b in host_spans] + [b for _, b, _ in dev])
    busy = _union_us([(a, b) for a, b, _ in dev])
    raster = sum(b - a for a, b, name in dev if "sphere_raster" in name)
    res["frame"] = {"window_us": t1 - t0, "device_busy_us": busy,
                    "raster_us": raster, "device_ops": len(dev),
                    "idle_share": 1.0 - busy / (t1 - t0)}
    print(f"phase 7 trace one frame {fh}x{fw} [{card}]: window {t1 - t0:.1f} "
          f"us (host, profiled), device busy {busy:.1f} us in {len(dev)} "
          f"device ops, of which the raster kernel {raster:.1f} us; device "
          f"idle share {1.0 - busy / (t1 - t0):.4f}")
    return res


def _raster_vs_plain(wins, ocb, rect, dirs, znear, label: str,
                     min_hits: float):
    """The raster kernel against its plain version (the full sweep over
    every instance) on one world's bins: hit agreement and the winner on
    >= 0.9999 of the pixels and hits, tmin (where both hit) and the
    winner's centre (where the winners agree) <= 1e-6, a miss exactly
    (+inf, 0), more than ``min_hits`` hits, and all three outputs equal
    bit for bit."""
    import torch

    from wgpu_physics_engine_torch.ops import raster_kernel

    h, w = dirs.shape[-2:]
    kt, ki, ko = raster_kernel.sphere_raster_kernel(wins, ocb, rect, dirs,
                                                    znear)
    pt, pi, po = raster_kernel.sphere_raster_plain(ocb, dirs, znear)
    torch.cuda.synchronize()
    hit_k, hit_p = ki >= 0, pi >= 0
    agree = float((hit_k == hit_p).float().mean())
    both = hit_k & hit_p
    same = (ki == pi) & hit_k
    n_hit = int(hit_k.sum())
    n_same = int(same.sum())
    # tmin on every pixel both sides hit, whoever won; oc where the
    # winner agrees; misses must be exactly (+inf, 0) on both sides
    et = _maxdiff(kt[both], pt[both]) if bool(both.any()) else 0.0
    eo = _maxdiff(ko[:, same], po[:, same]) if n_same else 0.0
    miss = ~hit_k
    miss_ok = bool(torch.isinf(kt[miss]).all()
                   and (ko[:, miss] == 0).all())
    bitwise = bool(torch.equal(ki, pi) and torch.equal(kt, pt)
                   and torch.equal(ko, po))
    print(f"{label}: hit agree {agree:.6f} (>=0.9999), hits {n_hit}, "
          f"same winner {n_same} (>=0.9999 of hits), tmin {et:.3e} "
          f"oc {eo:.3e} (<=1e-6), bitwise {bitwise}")
    _check(n_hit > min_hits, f"raster {h}x{w}: only {n_hit} hits")
    _check(agree >= 0.9999, f"raster {h}x{w} hit agreement {agree}")
    _check(n_same >= 0.9999 * n_hit,
           f"raster {h}x{w}: winner agrees on {n_same} of {n_hit} hits")
    _check(et <= 1e-6 and eo <= 1e-6, f"raster {h}x{w} diff {et} {eo}")
    _check(miss_ok, f"raster {h}x{w}: a miss is not (+inf, 0)")
    _check(bitwise, f"raster {h}x{w}: not equal to the full sweep bit for "
           f"bit")
    return {"hit_agree": agree, "hits": n_hit, "same_winner": n_same,
            "err_tmin": et, "err_oc": eo, "bitwise": bitwise}


def _batched_raster_vs_plain(out, ocb, dirs, znear, label: str):
    """The batched raster kernel's outputs ``out`` (tmin, winner, centre
    of every world) against the plain sweep on the first, middle and last
    worlds of the batch, under phase 4's contract (:func:`_raster_vs_plain`
    on one world). Returns the results by world and the largest error."""
    import torch

    from wgpu_physics_engine_torch.ops import raster_kernel

    kt, ki, ko = out
    n, (h, w) = dirs.shape[0], dirs.shape[-2:]
    res, err = {}, 0.0
    for i in (0, n // 2 - 1, n - 1):
        pt, pi, po = raster_kernel.sphere_raster_plain(ocb[i], dirs[i],
                                                       znear[i])
        hit_k, hit_p = ki[i] >= 0, pi >= 0
        agree = float((hit_k == hit_p).float().mean())
        both = hit_k & hit_p
        same = (ki[i] == pi) & hit_k
        n_hit, n_same = int(hit_k.sum()), int(same.sum())
        et = _maxdiff(kt[i][both], pt[both]) if bool(both.any()) else 0.0
        eo = _maxdiff(ko[i][:, same], po[:, same]) if n_same else 0.0
        miss = ~hit_k
        miss_ok = bool(torch.isinf(kt[i][miss]).all()
                       and (ko[i][:, miss] == 0).all())
        bitwise = bool(torch.equal(ki[i], pi) and torch.equal(kt[i], pt)
                       and torch.equal(ko[i], po))
        print(f"{label} world {i} of {n} @{h}x{w}: hit agree {agree:.6f} "
              f"(>=0.9999), hits {n_hit}, same winner {n_same} (>=0.9999 of "
              f"hits), tmin {et:.3e} oc {eo:.3e} (<=1e-6), bitwise {bitwise}")
        _check(n_hit > 0, f"{label} world {i}: no particle hit")
        _check(agree >= 0.9999, f"{label} world {i} agreement {agree}")
        _check(n_same >= 0.9999 * n_hit,
               f"{label} world {i}: winner agrees on {n_same} of {n_hit}")
        _check(et <= 1e-6 and eo <= 1e-6, f"{label} world {i} diff {et} {eo}")
        _check(miss_ok, f"{label} world {i}: a miss is not (+inf, 0)")
        _check(bitwise, f"{label} world {i}: not equal to the full sweep bit "
               f"for bit")
        res[str(i)] = {"hit_agree": agree, "hits": n_hit,
                       "same_winner": n_same, "err_tmin": et, "err_oc": eo,
                       "bitwise": bitwise}
        err = max(err, et, eo)
    return res, err


def _bound(nbytes: float, ops: float):
    """The least time (ms) the card could take: the larger of the bytes over
    HBM bandwidth and the fp32 operations over the fp32 peak, and which."""
    tb, to = nbytes / HBM_BPS * 1e3, ops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _cloth_bound(h: int, w: int, n_worlds: int, n_steps: int,
                 extra_bytes: float = 0.0, extra_ops: float = 0.0):
    """Bound of one cloth call: pos and vel read once and written once
    (48 B a particle, plus ``extra_bytes``), and the operations of every
    substep (plus ``extra_ops`` a particle and substep: K1f reads a force
    plane, 12 B, and adds it, 3 operations)."""
    from wgpu_physics_engine_torch.ops.cloth_kernel import _FAMILIES

    edges = sum((h - dr) * (w - abs(dc)) for dr, dc, _ in _FAMILIES)
    ops = n_worlds * n_steps * (OPS_EDGE * edges
                                + (OPS_PARTICLE + extra_ops) * h * w)
    return _bound((48.0 + extra_bytes) * n_worlds * h * w, ops)


def _raster_bound(wins, rect, h: int, w: int):
    """Bound of one raster call over ``wins`` ([T, 8] or [B, T, 8]) and
    ``rect`` ([4, N] or [B, 4, N]): rays in (12 B a pixel), the sorted
    table and the rectangles in (32 B an instance), tmin, winner and
    centre out (20 B a pixel); the ray test of every (pixel, instance)
    pair whose pixel lies in the instance's conservative rectangle, the
    pairs no correct use of the prologue's screen bound can skip (the
    whole frame for an instance the binning does not take). Returns
    ``(ms, by, ring_ms)``, ``ring_ms`` the operations bound of the first
    port's work: every pixel of a tile against its four ranges."""
    import torch

    from wgpu_physics_engine_torch.ops.raster_kernel import TILE_H, TILE_W

    r = rect.reshape(-1, 4, rect.shape[-1]).long()
    b, n = r.shape[0], r.shape[-1]
    cols = (torch.clamp(r[:, 1], -1, w - 1) - torch.clamp(r[:, 0], 0, w)
            + 1).clamp_min(0)
    rows = (torch.clamp(r[:, 3], -1, h - 1) - torch.clamp(r[:, 2], 0, h)
            + 1).clamp_min(0)
    pairs = float((cols * rows).double().sum())
    w8 = wins.reshape(-1, wins.shape[-2], 8).long()
    ty, tx = -(-h // TILE_H), -(-w // TILE_W)
    px = torch.tensor([min(TILE_H, h - TILE_H * i)
                       * min(TILE_W, w - TILE_W * j)
                       for i in range(ty) for j in range(tx)],
                      dtype=torch.float64, device=w8.device)
    cand = sum(w8[..., 2 * g + 1] - w8[..., 2 * g] for g in range(4))
    ring = float((cand.double() * px).sum())
    ms, by = _bound(b * (32.0 * h * w + 32.0 * n), OPS_RAY_SPHERE * pairs)
    return ms, by, OPS_RAY_SPHERE * ring / F32_FLOPS * 1e3


def _raster_site(cam, centers, radius: float, h: int, w: int, label: str,
                 card) -> dict:
    """The raster kernel a call on one frame of a path (the prologue's bins
    of ``centers`` seen by ``cam``) with its bound: a main-path site of the
    ranking."""
    import torch

    from wgpu_physics_engine_torch.ops import raster_kernel
    from wgpu_physics_engine_torch.render import camera as cam_mod

    eye, dirs = cam_mod.pixel_rays(cam, h, w)
    wins, ocb, _, rect = raster_kernel.tiled_prologue(
        cam.view[:3, :3], eye, centers, radius, cam.znear,
        torch.tan(cam.fovy_rad / 2.0), cam.aspect, h, w)
    ms = _best_ms(lambda: raster_kernel.sphere_raster_kernel(
        wins, ocb, rect, dirs, cam.znear))
    b_ms, b_by, _ = _raster_bound(wins, rect, h, w)
    print(f"phase 6 sphere_raster @{h}x{w}, {centers.shape[0]} instances "
          f"({label}) [{card}]: {ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return {"ms": ms, "bound_ms": b_ms, "bound_by": b_by}


def _dg_setup(settled, seed: int, dev):
    """The set-up of a datagen run from ``worlds=settled`` and a generator
    seeded ``seed``, by the generator's own code: the globe texture and
    ``(batches, cameras, cached globes)`` per chunk."""
    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.parallel import datagen

    tex = datagen.globe_texture(dev)
    return tex, datagen.world_chunks(
        ClothConfig(), DG_WORLDS, tex, torch.Generator().manual_seed(seed),
        DG_FB, world_chunk=DG_CHUNK, randomize_cameras=True, worlds=settled,
        device=dev)


def _dg_frame(tex, chunks, codec_k):
    """One steady frame of every chunk (``datagen.frame_parts``, the
    generator's frame); the chunks advance in place."""
    from wgpu_physics_engine_torch.parallel import datagen

    return datagen.frame_parts(*chunks, DT, DG_STEPS, tex, DG_FB,
                               codec_k=codec_k)


def _pixel_chain(cams, base, centers, radius, flat_color, phase: int,
                 label: str, card) -> dict:
    """The rays and epilogue kernels on one chunk of a datagen path (its
    cameras, cached frame, sphere centres and colour), each against its
    plain version on the same inputs, bit for bit, one launch each; the
    uint8 entry against its plain route (``draw_instanced_spheres`` and
    the cast); the pixels that miss, that show the spheres' colour and that
    the cached frame hides; then each kernel a launch beside its plain
    chain and its bound (12 bytes a pixel written for the rays; 27 for the
    epilogue: tmin, inst, the cached depth and colour read, the uint8
    written; the fp32 work of either is a small share of it)."""
    import torch

    from wgpu_physics_engine_torch.ops import pixel_kernel as pk
    from wgpu_physics_engine_torch.render import camera as cam_mod, raster

    h, w = base.depth.shape[-2:]
    n = cams.view.shape[0]
    tan_half = torch.tan(cams.fovy_rad / 2.0)
    eye = cams.eye
    launched = (pk.LAUNCHES_RAYS, pk.LAUNCHES_EPILOGUE)
    dirs = pk.pixel_rays(cams.view, tan_half, cams.aspect, h, w)
    dirs_p = cam_mod.pixel_dirs_plain(cams.view, tan_half, cams.aspect, h, w)
    tmin, inst, _, _ = raster._nearest_hits(cams, eye, dirs_p, centers,
                                            radius)
    img = pk.flat_composite_rgb8(tmin, inst, base.color, base.depth,
                                 cams.view, eye, cams.proj, tan_half,
                                 cams.aspect, flat_color)
    img_p = raster.to_rgb8(raster._flat_composite(
        base, cams, eye, dirs_p, tmin, inst >= 0, flat_color).color)
    torch.cuda.synchronize()
    launched = (pk.LAUNCHES_RAYS - launched[0],
                pk.LAUNCHES_EPILOGUE - launched[1])
    rays_err = _maxdiff(dirs, dirs_p)
    epi_err = _maxdiff(img.int(), img_p.int())
    rays_eq = bool(torch.equal(dirs, dirs_p))
    epi_eq = bool(torch.equal(img, img_p))
    entry = raster.draw_instanced_spheres_rgb8(base, cams, centers, radius,
                                               flat_color)
    entry_eq = bool(torch.equal(entry, raster.draw_instanced_spheres_rgb8_plain(
        base, cams, centers, radius, flat_color)))
    hit = inst >= 0
    flat8 = raster.to_rgb8(torch.tensor(flat_color, device=img.device))
    won = (img == flat8).all(-1)
    px = {"miss": int((~hit).sum()), "flat": int((hit & won).sum()),
          "hidden": int((hit & ~won).sum())}
    print(f"phase {phase} pixel kernels vs plain on {label}, {n} worlds @{h}x{w}, "
          f"flat colour {tuple(flat_color)} [{card}]: launches (rays, "
          f"epilogue) {launched}; rays max abs {rays_err:.3e} bitwise "
          f"{rays_eq}; epilogue max |d| {epi_err:.0f} bitwise {epi_eq}; "
          f"draw_instanced_spheres_rgb8 == its plain route {entry_eq}; "
          f"pixels {px}")
    _check(launched == (1, 1), f"{label}: pixel kernels launched {launched}")
    _check(rays_eq and epi_eq and entry_eq,
           f"{label}: a pixel kernel differs from its plain version: rays "
           f"{rays_err}, epilogue {epi_err}, entry {entry_eq}")
    _check(px["miss"] > 0 and px["flat"] > 0,
           f"{label}: the chunk lacks misses or sphere pixels: {px}")

    res = {"worlds": n, "pixels": px, "entry_equal": entry_eq}
    for key, kernel, plain, nbytes in (
            ("rays",
             lambda: pk.pixel_rays(cams.view, tan_half, cams.aspect, h, w),
             lambda: cam_mod.pixel_dirs_plain(cams.view, tan_half,
                                              cams.aspect, h, w), 12),
            ("epilogue",
             lambda: pk.flat_composite_rgb8(
                 tmin, inst, base.color, base.depth, cams.view, eye,
                 cams.proj, tan_half, cams.aspect, flat_color),
             lambda: raster.to_rgb8(raster._flat_composite(
                 base, cams, eye, dirs_p, tmin, hit, flat_color).color), 27)):
        k_ms, p_ms = _best_ms(kernel), _best_ms(plain)
        b_ms, b_by = _bound(nbytes * n * h * w, 0.0)
        res[key] = {"err": rays_err if key == "rays" else epi_err,
                    "bitwise": rays_eq if key == "rays" else epi_eq,
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                    "bound_by": b_by}
        print(f"phase 6 {key} kernel on {label}, {n} worlds @{h}x{w} "
              f"[{card}]: {k_ms:.4f} ms, plain chain {p_ms:.4f} ms "
              f"({p_ms / k_ms:.1f}x), bound {b_ms:.4f} ms ({nbytes} B a "
              f"pixel), kernel at {b_ms / k_ms:.4f} of the bound")
    return res


@contextlib.contextmanager
def _plain_kernels():
    """Inside, the kernels' wrappers (the cloth stepper, its trace, its
    force-plane substep, the large-grid steppers K6 and K6r, the batched
    K5r, the substep adjoint's walk, both rasters, the granular substep,
    pair forces and their directional derivative, the rays kernel) run
    their plain versions on the card and count no launch, so a path runs
    its own code with the plain versions; the datagens' uint8 entry
    (``render.draw_instanced_spheres_rgb8``, whose epilogue kernel has no
    plain version with its arguments) runs its plain route."""
    from wgpu_physics_engine_torch import render
    from wgpu_physics_engine_torch.ops import (cloth_grad_kernel, cloth_kernel,
                                               cloth_tiled_kernel,
                                               granular_kernel, pixel_kernel,
                                               raster_kernel)
    from wgpu_physics_engine_torch.render import camera as cam_mod, raster

    saved = (cloth_kernel.multi_step_kernel_packed, cloth_kernel.trace_kernel,
             cloth_tiled_kernel.multi_step_kernel_packed,
             cloth_tiled_kernel.multi_step_resident_kernel_packed,
             cloth_tiled_kernel.multi_step_batched_kernel_packed,
             cloth_kernel.substep_with_force_kernel,
             cloth_kernel.substep_with_force_sorted_kernel,
             cloth_grad_kernel._walk_kernel,
             raster_kernel.sphere_raster_kernel,
             raster_kernel.sphere_raster_untiled_kernel,
             granular_kernel.substep_sorted_kernel,
             granular_kernel.contact_forces_sorted_kernel,
             granular_kernel.contact_force_jvp_sorted_kernel,
             pixel_kernel.pixel_rays, render.draw_instanced_spheres_rgb8)
    cloth_kernel.multi_step_kernel_packed = cloth_kernel.multi_step_plain_packed
    cloth_kernel.trace_kernel = cloth_kernel.trace_plain
    cloth_tiled_kernel.multi_step_kernel_packed = (
        cloth_tiled_kernel.multi_step_plain_packed)
    cloth_tiled_kernel.multi_step_resident_kernel_packed = (
        lambda state, prm, n_steps, tile=None:
        cloth_tiled_kernel.multi_step_plain_packed(state, prm, n_steps))
    cloth_tiled_kernel.multi_step_batched_kernel_packed = (
        cloth_kernel.multi_step_plain_packed)
    cloth_kernel.substep_with_force_kernel = (
        cloth_kernel.substep_with_force_plain)
    cloth_kernel.substep_with_force_sorted_kernel = (
        cloth_kernel.substep_with_force_sorted_plain)
    cloth_grad_kernel._walk_kernel = cloth_grad_kernel._walk_plain
    raster_kernel.sphere_raster_kernel = (
        lambda wins, ocb, rect, dirs, znear:
        raster_kernel.sphere_raster_plain(ocb, dirs, znear))
    raster_kernel.sphere_raster_untiled_kernel = (
        raster_kernel.sphere_raster_untiled_plain)
    granular_kernel.substep_sorted_kernel = granular_kernel.substep_sorted_plain
    granular_kernel.contact_forces_sorted_kernel = (
        granular_kernel.contact_forces_sorted_plain)
    granular_kernel.contact_force_jvp_sorted_kernel = (
        granular_kernel.contact_force_jvp_sorted_plain)
    pixel_kernel.pixel_rays = cam_mod.pixel_dirs_plain
    render.draw_instanced_spheres_rgb8 = (
        raster.draw_instanced_spheres_rgb8_plain)
    try:
        yield
    finally:
        (cloth_kernel.multi_step_kernel_packed, cloth_kernel.trace_kernel,
         cloth_tiled_kernel.multi_step_kernel_packed,
         cloth_tiled_kernel.multi_step_resident_kernel_packed,
         cloth_tiled_kernel.multi_step_batched_kernel_packed,
         cloth_kernel.substep_with_force_kernel,
         cloth_kernel.substep_with_force_sorted_kernel,
         cloth_grad_kernel._walk_kernel,
         raster_kernel.sphere_raster_kernel,
         raster_kernel.sphere_raster_untiled_kernel,
         granular_kernel.substep_sorted_kernel,
         granular_kernel.contact_forces_sorted_kernel,
         granular_kernel.contact_force_jvp_sorted_kernel,
         pixel_kernel.pixel_rays, render.draw_instanced_spheres_rgb8) = saved


@contextlib.contextmanager
def _k1f_sorted_plain():
    """Inside, K1f's sorted entry (``cloth_kernel.
    substep_with_force_sorted_kernel``, the self-collision block's) runs
    its plain version on the card; K11 and every other kernel stay."""
    from wgpu_physics_engine_torch.ops import cloth_kernel

    saved = cloth_kernel.substep_with_force_sorted_kernel
    cloth_kernel.substep_with_force_sorted_kernel = (
        cloth_kernel.substep_with_force_sorted_plain)
    try:
        yield
    finally:
        cloth_kernel.substep_with_force_sorted_kernel = saved


def _classify(img):
    """Per world of uint8 frames [B, H, W, 3]: (particle pixels, globe
    pixels) — particles are flat red, the background the clear colour."""
    import torch

    red = (img == torch.tensor([255, 0, 0], dtype=torch.uint8,
                               device=img.device)).all(-1)
    bg = (img == torch.tensor([13, 13, 20], dtype=torch.uint8,
                              device=img.device)).all(-1)
    return red.sum((1, 2)), (~red & ~bg).sum((1, 2))


def _phase8_k5(wb, label: str, dev, card, need_contact: bool):
    """K5 and K5r on the card, 24 substeps, free and with the top row
    pinned: K5 (a launch a substep) on the 4096 60x60 worlds ``wb`` with
    per-world params against its plain version and against K1 on worlds 0,
    1 and 4095; K5r (one launch, a CTA a world) on the first DG_CHUNK of
    them, the datagen path's chunk, against the plain version, K5 and K1 on
    worlds 0, 1 and DG_CHUNK - 1, bit for bit. Reports the share of
    particles that start a substep inside the globe's contact distance (the
    penalty and friction branches) and that end projected onto it (zero
    velocity); with ``need_contact`` both must be above zero. Returns the
    results and the largest errors of K5 and of K5r."""
    import torch

    from wgpu_physics_engine_torch.core.state import ClothParams, ClothState
    from wgpu_physics_engine_torch.ops import cloth_kernel, cloth_tiled_kernel

    res, err, err_r = {}, 0.0, 0.0
    prm = cloth_kernel._pack_params(wb.params, DT)
    min_dist = prm[:, 14, None, None]
    x, y, z = wb.state.pos.unbind(1)
    dist = torch.sqrt(x * x + y * y + z * z)
    contact = float((dist < min_dist).float().mean())
    pin = torch.zeros(wb.state.pos.shape[:1] + wb.state.pos.shape[2:],
                      dtype=torch.bool, device=dev)
    pin[:, 0] = True

    def world(state, i):
        return ClothState(
            pos=state.pos[i], vel=state.vel[i],
            pin_mask=None if state.pin_mask is None else state.pin_mask[i],
            pin_pos=None if state.pin_pos is None else state.pin_pos[i])

    for case, state in (("free", wb.state),
                        ("pinned", wb.state._replace(pin_mask=pin,
                                                     pin_pos=wb.state.pos))):
        before = cloth_kernel.LAUNCHES_BATCHED
        k5 = cloth_kernel.multi_step_launch_packed(state, prm, DG_STEPS)
        torch.cuda.synchronize()
        n_launch = cloth_kernel.LAUNCHES_BATCHED - before
        p5 = cloth_kernel.multi_step_plain(state, wb.params, DT, DG_STEPS)
        e = max(_maxdiff(k5.pos, p5.pos), _maxdiff(k5.vel, p5.vel))
        bitwise = bool(torch.equal(k5.pos, p5.pos)
                       and torch.equal(k5.vel, p5.vel))
        ek1, k1_bitwise = 0.0, True
        for i in (0, 1, DG_WORLDS - 1):
            k1 = cloth_kernel.multi_step_kernel(
                world(state, i), ClothParams(*(a[i] for a in wb.params)), DT,
                DG_STEPS)
            ek1 = max(ek1, _maxdiff(k5.pos[i], k1.pos),
                      _maxdiff(k5.vel[i], k1.vel))
            k1_bitwise &= bool(torch.equal(k5.pos[i], k1.pos)
                               and torch.equal(k5.vel[i], k1.vel))
        # K5r on the datagen chunk
        chunk = ClothState(*(None if a is None else a[:DG_CHUNK]
                             for a in state))
        before = cloth_tiled_kernel.LAUNCHES_BATCHED
        k5r = cloth_tiled_kernel.multi_step_batched_kernel_packed(
            chunk, prm[:DG_CHUNK], DG_STEPS)
        torch.cuda.synchronize()
        n_r = cloth_tiled_kernel.LAUNCHES_BATCHED - before
        pr = cloth_kernel.multi_step_plain(
            chunk, ClothParams(*(a[:DG_CHUNK] for a in wb.params)), DT,
            DG_STEPS)
        er = max(_maxdiff(k5r.pos, pr.pos), _maxdiff(k5r.vel, pr.vel))
        r_bitwise = {
            "plain": bool(torch.equal(k5r.pos, pr.pos)
                          and torch.equal(k5r.vel, pr.vel)),
            "k5": bool(torch.equal(k5r.pos, k5.pos[:DG_CHUNK])
                       and torch.equal(k5r.vel, k5.vel[:DG_CHUNK])),
            "k1": True}
        for i in (0, 1, DG_CHUNK - 1):
            k1 = cloth_kernel.multi_step_kernel(
                world(state, i), ClothParams(*(a[i] for a in wb.params)), DT,
                DG_STEPS)
            r_bitwise["k1"] &= bool(torch.equal(k5r.pos[i], k1.pos)
                                    and torch.equal(k5r.vel[i], k1.vel))
        finite = bool(torch.isfinite(k5.pos).all()
                      and torch.isfinite(k5.vel).all())
        free = torch.ones_like(pin) if state.pin_mask is None else ~pin
        projected = float(((k5.vel == 0).all(1) & free).float().mean())
        print(f"phase 8 cloth_step_batched (K5) {label} {case} @{DG_WORLDS} x "
              f"60x60 x {DG_STEPS} substeps [{card}]: vs plain {e:.3e} "
              f"(<=1e-6), bitwise {bitwise}; vs K1 on worlds 0, 1, "
              f"{DG_WORLDS - 1} {ek1:.3e} (<=1e-6), bitwise {k1_bitwise}; "
              f"launches {n_launch}; finite {finite}; particles in contact "
              f"at the start {contact:.4f}, projected in the last substep "
              f"{projected:.4f}")
        print(f"phase 8 cloth_tiled_batched (K5r) {label} {case} @{DG_CHUNK} "
              f"x 60x60 x {DG_STEPS} substeps [{card}]: vs plain {er:.3e}; "
              f"bitwise vs plain, K5 and K1 on worlds 0, 1, {DG_CHUNK - 1} "
              f"{r_bitwise}; launches {n_r}")
        _check(n_launch == DG_STEPS, f"K5 launched {n_launch} times")
        _check(e <= 1e-6, f"K5 {label} {case} vs plain diff {e}")
        _check(ek1 <= 1e-6, f"K5 {label} {case} vs K1 diff {ek1}")
        _check(n_r == 1, f"K5r launched {n_r} times for one call")
        _check(all(r_bitwise.values()),
               f"K5r {label} {case} not bit for bit: {r_bitwise} ({er})")
        _check(finite, f"K5 {label} {case} state not finite")
        if need_contact:
            _check(contact > 0 and projected > 0,
                   f"K5 {label} {case}: no contact ({contact}, {projected})")
        if state.pin_mask is not None:
            _check(torch.equal(k5.pos[:, :, 0], state.pos[:, :, 0]),
                   "K5 pinned row moved")
        res[case] = {"err_vs_plain": e, "bitwise": bitwise,
                     "err_vs_k1": ek1, "bitwise_vs_k1": k1_bitwise,
                     "launches": n_launch, "contact_share": contact,
                     "projected_share": projected,
                     "k5r": {"err_vs_plain": er, "bitwise": r_bitwise,
                             "launches": n_r}}
        err = max(err, e, ek1)
        err_r = max(err_r, er)
    return res, err, err_r


def _phase9_raster(settled, dev, card):
    """The batched raster at the datagen path's shape: one launch for a
    chunk of DG_CHUNK settled worlds at 256x256 against the plain sweep on
    its first, middle and last worlds (phase 4's contract). Returns the
    results, the largest error and the launch's inputs, which phase 6
    times."""
    import torch

    from wgpu_physics_engine_torch.ops import raster_kernel
    from wgpu_physics_engine_torch.parallel import datagen
    from wgpu_physics_engine_torch.render import camera as cam_mod

    n, (h, w) = DG_CHUNK, DG_FB
    cams = datagen.randomized_cameras(
        n, torch.Generator().manual_seed(DG_SEED + 2), device=dev)
    eye, dirs = cam_mod.pixel_rays(cams, h, w)
    centers = settled.state.pos[:n].reshape(n, 3, -1).transpose(1, 2)
    wins, ocb, _, rect = raster_kernel.tiled_prologue_batched(
        cams.view[:, :3, :3], eye, centers, settled.params.particle_radius[:n],
        cams.znear, torch.tan(cams.fovy_rad / 2.0), cams.aspect, h, w)
    raster_kernel.LAUNCHES = 0
    kt, ki, ko = raster_kernel.sphere_raster_kernel(wins, ocb, rect, dirs,
                                                    cams.znear)
    torch.cuda.synchronize()
    _check(raster_kernel.LAUNCHES == 1,
           f"batched raster launched {raster_kernel.LAUNCHES} times")
    res, err = _batched_raster_vs_plain((kt, ki, ko), ocb, dirs, cams.znear,
                                        "phase 9 batched sphere_raster")
    return res, err, (wins, ocb, rect, dirs, cams.znear)


def _phase10_datagen(settled, dev, card, cli_main):
    """The datagen path, counted: 4096 worlds x 3 frames at 256x256 with the
    codec, then the CLI's datagen and decode; and the checks on it."""
    import numpy as np
    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.ops import (cloth_kernel,
                                               cloth_tiled_kernel,
                                               pixel_kernel, raster_kernel)
    from wgpu_physics_engine_torch.parallel import codec, datagen
    from wgpu_physics_engine_torch.render import texture as tex_mod

    gen_kw = dict(n_worlds=DG_WORLDS, n_frames=3, steps_per_frame=DG_STEPS,
                  fb_size=DG_FB, randomize_cameras=True, world_chunk=DG_CHUNK,
                  device=dev)
    # the CLI's shards stay in the (ignored) build directory, not the
    # results brought back
    scratch = os.path.join(HERE, "build", "chip_smoke_datagen")
    dg_out, dg_dec = os.path.join(scratch, "enc"), os.path.join(scratch, "dec")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cloth_kernel.LAUNCHES = 0
    cloth_kernel.LAUNCHES_BATCHED = 0
    cloth_tiled_kernel.LAUNCHES_BATCHED = 0
    raster_kernel.LAUNCHES = 0
    pixel_kernel.LAUNCHES_RAYS = 0
    pixel_kernel.LAUNCHES_EPILOGUE = 0
    t0 = time.perf_counter()
    frames, yields = [], []
    for f, enc, batches in datagen.generate_trajectory_dataset(
            ClothConfig(), generator=torch.Generator().manual_seed(DG_SEED + 1),
            codec_k=DG_K, worlds=settled, **gen_kw):
        frames.append(enc)
        yields.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    gen_launches = {"cloth_step_batched": cloth_kernel.LAUNCHES_BATCHED,
                    "cloth_tiled_batched": cloth_tiled_kernel.LAUNCHES_BATCHED,
                    "sphere_raster": raster_kernel.LAUNCHES,
                    "pixel_rays": pixel_kernel.LAUNCHES_RAYS,
                    "flat_composite_rgb8": pixel_kernel.LAUNCHES_EPILOGUE}
    rc = cli_main(["datagen", "--worlds", str(DG_CLI_WORLDS), "--frames",
                   "2", "--codec-k",
                   str(DG_K), "--outdir", dg_out, "--device", "cuda"])
    torch.cuda.synchronize()
    launches = {"cloth_step": cloth_kernel.LAUNCHES,
                "cloth_step_batched": cloth_kernel.LAUNCHES_BATCHED,
                "cloth_tiled_batched": cloth_tiled_kernel.LAUNCHES_BATCHED,
                "sphere_raster": raster_kernel.LAUNCHES,
                "pixel_rays": pixel_kernel.LAUNCHES_RAYS,
                "flat_composite_rgb8": pixel_kernel.LAUNCHES_EPILOGUE}
    rc_dec = cli_main(["decode", "--indir", dg_out, "--outdir", dg_dec])
    n_chunks = -(-DG_WORLDS // DG_CHUNK)
    # the frames' rays and epilogue, one each a chunk and frame beside the
    # raster, and the cached globes' rays, a launch a GLOBE_CHUNK of worlds
    want_pixel = {"flat_composite_rgb8": 3 * n_chunks,
                  "pixel_rays": 3 * n_chunks + n_chunks * -(
                      -DG_CHUNK // datagen.GLOBE_CHUNK)}
    print(f"phase 10 datagen path [{card}]: generate_trajectory_dataset("
          f"ClothConfig(), n_worlds={DG_WORLDS}, n_frames=3, steps_per_frame="
          f"{DG_STEPS}, fb_size={DG_FB}, randomize_cameras=True, codec_k="
          f"{DG_K}, world_chunk={DG_CHUNK}) {gen_s:.3f} s host clock (frames "
          f"yielded at {', '.join(f'{t:.3f}' for t in yields)} s), peak "
          f"device memory {peak / 2**30:.3f} GiB; CLI datagen rc {rc}, decode "
          f"rc {rc_dec}; launches {launches} (generate alone {gen_launches}"
          f", the pixel kernels' expected {want_pixel})")
    _check(rc == 0 and rc_dec == 0, f"CLI datagen/decode rc {rc} {rc_dec}")
    cli_epi = (launches["flat_composite_rgb8"]
               - gen_launches["flat_composite_rgb8"])
    _check(all(gen_launches[k] == v for k, v in want_pixel.items())
           and gen_launches["sphere_raster"] == 3 * n_chunks
           and cli_epi > 0 and cli_epi == (launches["sphere_raster"]
                                           - gen_launches["sphere_raster"])
           and launches["pixel_rays"] - gen_launches["pixel_rays"] > cli_epi,
           f"the datagen path's pixel kernels launched {launches} (generate "
           f"alone {gen_launches}), expected {want_pixel} for generate and "
           f"an epilogue a raster launch in the CLI")
    # every chunk of 1,024 worlds and the CLI's 64 take K5r, one launch a
    # frame; K5 never
    _check(gen_launches["cloth_tiled_batched"] >= 3 * n_chunks
           and launches["cloth_tiled_batched"] > gen_launches[
               "cloth_tiled_batched"]
           and launches["cloth_step_batched"] == 0
           and launches["sphere_raster"] >= 3 * n_chunks,
           f"the datagen path's kernels launched {launches}")
    shape = (DG_WORLDS, DG_FB[0] // 8, DG_FB[1] // 8, 3, DG_K)
    _check(len(frames) == 3 and all(f.shape == shape and f.dtype == np.int8
                                    for f in frames),
           f"datagen frames {[(f.shape, f.dtype) for f in frames]}")
    _check(all(bool(torch.isfinite(b.state.pos).all()) for b in batches),
           "datagen state not finite")

    # frame 0 uncompressed, from the same worlds and cameras
    tex, chunks = _dg_setup(settled, DG_SEED + 1, dev)
    b0 = chunks[0][0]
    pixel = _pixel_chain(
        chunks[1][0], chunks[2][0],
        b0.state.pos.reshape(DG_CHUNK, 3, -1).transpose(1, 2),
        b0.params.particle_radius, (1.0, 0.0, 0.0), 10,
        "the datagen chunk", card)
    _check(pixel["pixels"]["hidden"] > 0,
           f"no cloth pixel behind a cached globe: {pixel['pixels']}")
    parts = _dg_frame(tex, chunks, None)
    raw = torch.cat(parts)
    red, globe = _classify(raw)
    share = float(((red > 0) & (globe > 0)).float().mean())
    # the yielded frame 0 is the device codec of exactly this frame
    enc_same = bool(np.array_equal(
        torch.cat([codec.encode(p, k=DG_K) for p in parts]).cpu().numpy(),
        frames[0]))
    sample = list(range(0, DG_WORLDS, 16))
    dec = codec.decode(frames[0][sample])     # NumPy: every 16th world
    raw_np = raw.cpu().numpy()
    psnrs = [codec.psnr(raw_np[i], dec[j]) for j, i in enumerate(sample)]
    mean_psnr = float(np.mean(psnrs))
    # the codec's quality floor on smooth content: the cached globes of the
    # same worlds, encoded on the card. (The cloth's 1.5-pixel particles are
    # detail that 16 of 64 coefficients cannot carry: the frames' PSNR at
    # k = 16 is a property of the codec, reported, not checked.)
    globes = torch.cat([(torch.clamp(fb.color, 0.0, 1.0) * 255.0 + 0.5)
                        .to(torch.uint8) for fb in chunks[2]])[sample]
    g_dec = codec.decode(codec.encode(globes, k=DG_K).cpu().numpy())
    globes = globes.cpu().numpy()
    g_psnr = float(np.mean([codec.psnr(globes[j], g_dec[j])
                            for j in range(len(sample))]))
    print(f"phase 10 frames: worlds with particle and globe pixels "
          f"{share:.4f} (>=0.9); particle px a world mean "
          f"{float(red.float().mean()):.1f}; yielded frame 0 == encode(raw "
          f"frame 0) {enc_same}; decode(frame 0) PSNR vs the raw frame over "
          f"{len(sample)} worlds mean {mean_psnr:.3f} dB, min "
          f"{min(psnrs):.3f} (the codec at k = {DG_K}, reported); the cached "
          f"globes alone {g_psnr:.3f} dB (>=28)")
    _check(share >= 0.9, f"only {share} of worlds show cloth and globe")
    _check(enc_same, "yielded frame 0 is not the codec of the raw frame 0")
    _check(g_psnr >= 28.0, f"codec PSNR on the globes {g_psnr}")

    # 16 of the worlds, 3 frames, uncompressed, three ways: the kernel
    # path; the same code with the kernels' plain versions (K5 and the
    # raster each equal theirs bit for bit, so the frames must be equal);
    # and use_kernel=False, the stencil twin. The twin adds the spring
    # forces in another order, and on the draped cloth the contact test
    # (dist < min_dist, right after the projection set dist = min_dist)
    # turns on rounding, so the two states part by more than rounding and
    # a particle's silhouette may cross a pixel centre: such a pixel flips
    # whole (|d| up to 255), hence a share of pixels, not every pixel.
    few = datagen.WorldBatch(
        state=settled.state._replace(pos=settled.state.pos[:16],
                                     vel=settled.state.vel[:16]),
        params=type(settled.params)(*(a[:16] for a in settled.params)))
    runs, ends = {}, {}
    for way in ("kernel", "plain", "twin"):
        with _plain_kernels() if way == "plain" else contextlib.nullcontext():
            runs[way] = []
            for _, im, bs in datagen.generate_trajectory_dataset(
                    ClothConfig(), generator=torch.Generator().manual_seed(
                        DG_SEED + 3), worlds=few, use_kernel=way != "twin",
                    **{**gen_kw, "n_worlds": 16, "world_chunk": None}):
                runs[way].append(im)
            ends[way] = bs[0].state.pos
    exact = (all(np.array_equal(a, b)
                 for a, b in zip(runs["kernel"], runs["plain"], strict=True))
             and bool(torch.equal(ends["kernel"], ends["plain"])))
    d = np.concatenate([np.abs(a.astype(np.int16) - b.astype(np.int16)).max(-1)
                        for a, b in zip(runs["kernel"], runs["twin"])])
    within = float((d <= 1).mean())
    e_pos = _maxdiff(ends["kernel"], ends["twin"])
    print(f"phase 10 on 16 worlds x 3 frames: kernel path == the same path "
          f"with the plain stepper and sweep {exact} (frames and end state); "
          f"vs use_kernel=False uint8 |d| <= 1 on {within:.6f} of pixels "
          f"(>=0.999), {int((d > 1).sum())} pixels over (a silhouette "
          f"crossing a pixel centre), max {int(d.max())}; end states apart "
          f"by {e_pos:.3e}")
    _check(exact, "kernel datagen frames differ from the plain versions'")
    _check(within >= 0.999, f"kernel vs stencil twin datagen frames: {within}")
    return {"launches": launches, "generate_launches": gen_launches,
            "generate_s": gen_s, "yields_s": yields,
            "peak_bytes": peak, "cli_rc": [rc, rc_dec],
            "cloth_and_globe_share": share, "psnr_mean": mean_psnr,
            "psnr_min": min(psnrs), "psnr_globes": g_psnr,
            "encode_equal": enc_same, "kernel_equals_plain": exact,
            "kernel_vs_twin_within_1": within,
            "kernel_vs_twin_end_pos": e_pos,
            "kernel_vs_twin_over_1": int((d > 1).sum()),
            "pixel_chain": pixel}


def _dg_times(settled, raster_in, dev, card) -> dict:
    """Phase 6 for the datagen path: K5 (a launch a substep) and K5r (one
    launch) a call of DG_STEPS substeps on DG_CHUNK worlds (the datagen
    path's chunk), DG_CLI_WORLDS (the datagen CLI's) and the multi-device
    path's shard of MC_K5_WORLDS / MC_SHARDS, each per substep beside the
    plain version and the call's bound (bytes once, operations every
    substep) per substep,
    the raster a call at its two sites (phase 9's launch on DG_CHUNK worlds
    at DG_FB, and a shard of the multi-device example: 16 of the worlds at
    64×64), one steady frame of all worlds with and without the codec, and
    the copy into pinned memory."""
    import torch

    from wgpu_physics_engine_torch.core.state import ClothParams, ClothState
    from wgpu_physics_engine_torch.ops import (cloth_kernel,
                                               cloth_tiled_kernel,
                                               raster_kernel)
    from wgpu_physics_engine_torch.parallel import datagen
    from wgpu_physics_engine_torch.render import camera as cam_mod

    res = {}
    for key, n_w in (("k5", DG_CHUNK), ("k5_cli", DG_CLI_WORLDS),
                     ("k5_shard", MC_K5_WORLDS // MC_SHARDS)):
        st = ClothState(*(None if a is None else a[:n_w]
                          for a in settled.state))
        prm = cloth_kernel._pack_params(
            ClothParams(*(a[:n_w] for a in settled.params)), DT)
        k_ms = _best_ms(lambda: cloth_kernel.multi_step_launch_packed(
            st, prm, DG_STEPS)) / DG_STEPS
        r_ms = _best_ms(lambda: cloth_tiled_kernel.
                        multi_step_batched_kernel_packed(
                            st, prm, DG_STEPS)) / DG_STEPS
        p_ms = _best_ms(lambda: cloth_kernel.multi_step_plain_packed(
            st, prm, DG_STEPS)) / DG_STEPS
        b_ms, b_by = _cloth_bound(60, 60, n_w, DG_STEPS)
        res[key] = {"ms": k_ms, "k5r_ms": r_ms, "plain_ms": p_ms,
                    "bound_ms": b_ms / DG_STEPS, "bound_by": b_by,
                    "worlds": n_w}
        print(f"phase 6 cloth_step_batched (K5) and cloth_tiled_batched "
              f"(K5r), {n_w} x 60x60, a call of {DG_STEPS} substeps, ms a "
              f"substep [{card}]: K5 {k_ms:.5f}, K5r {r_ms:.5f} "
              f"({k_ms / r_ms:.3f}x), plain {p_ms:.4f}, bound "
              f"{b_ms / DG_STEPS:.5f} "
              f"({b_by}; the call's bytes once), K5 at "
              f"{b_ms / DG_STEPS / k_ms:.4f} and K5r at "
              f"{b_ms / DG_STEPS / r_ms:.4f} of it")

    wins, ocb, rect, dirs, znear = raster_in
    n, (h, w) = dirs.shape[0], DG_FB
    r_ms = _best_ms(lambda: raster_kernel.sphere_raster_kernel(
        wins, ocb, rect, dirs, znear))
    rb_ms, rb_by, rb_ring = _raster_bound(wins, rect, h, w)
    res["raster_1024"] = {"ms": r_ms, "bound_ms": rb_ms, "bound_by": rb_by,
                          "ring_bound_ms": rb_ring, "worlds": n}
    print(f"phase 6 batched sphere_raster {n} worlds @{h}x{w} [{card}]: "
          f"{r_ms:.4f} ms/launch, bound {rb_ms:.4f} ms ({rb_by}; the first "
          f"port's ring sweep {rb_ring:.4f} ms), kernel at "
          f"{rb_ms / r_ms:.4f} of the bound")
    # the datagen CLI's call shape: its first DG_CLI_WORLDS worlds
    cli_in = [a[:DG_CLI_WORLDS].contiguous() for a in raster_in]
    rc_ms = _best_ms(lambda: raster_kernel.sphere_raster_kernel(*cli_in))
    rcb_ms, rcb_by, _ = _raster_bound(cli_in[0], cli_in[2], h, w)
    res["raster_cli"] = {"ms": rc_ms, "bound_ms": rcb_ms, "bound_by": rcb_by,
                         "worlds": DG_CLI_WORLDS}
    print(f"phase 6 batched sphere_raster {DG_CLI_WORLDS} worlds @{h}x{w} "
          f"(the datagen CLI's call shape) [{card}]: {rc_ms:.4f} ms/launch, "
          f"bound {rcb_ms:.5f} ms ({rcb_by})")
    del cli_in
    n_s, fb_s = MC_K5_WORLDS // MC_SHARDS, 64
    cams = datagen.randomized_cameras(
        n_s, torch.Generator().manual_seed(DG_SEED + 6), device=dev)
    _, sdirs = cam_mod.pixel_rays(cams, fb_s, fb_s)
    centers = settled.state.pos[:n_s].reshape(n_s, 3, -1).transpose(1, 2)
    sw, so, _, sr = raster_kernel.tiled_prologue_batched(
        cams.view[:, :3, :3], cams.eye, centers,
        settled.params.particle_radius[:n_s], cams.znear,
        torch.tan(cams.fovy_rad / 2.0), cams.aspect, fb_s, fb_s)
    s_ms = _best_ms(lambda: raster_kernel.sphere_raster_kernel(
        sw, so, sr, sdirs, cams.znear))
    sb_ms, sb_by, _ = _raster_bound(sw, sr, fb_s, fb_s)
    res["raster_shard"] = {"ms": s_ms, "bound_ms": sb_ms, "bound_by": sb_by,
                           "worlds": n_s}
    print(f"phase 6 batched sphere_raster {n_s} worlds @{fb_s}x{fb_s} (a "
          f"shard of the multi-device example) [{card}]: {s_ms:.4f} "
          f"ms/launch, bound {sb_ms:.5f} ms ({sb_by})")

    tex, chunks = _dg_setup(settled, DG_SEED + 4, dev)
    out = {}
    for codec_k in (None, DG_K):
        ms = _best_ms(lambda: _dg_frame(tex, chunks, codec_k))
        parts = _dg_frame(tex, chunks, codec_k)
        host = [torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                for p in parts]

        def copy():
            for hb, p in zip(host, parts):
                hb.copy_(p, non_blocking=True)

        c_ms = _best_ms(copy)
        nbytes = sum(p.numel() * p.element_size() for p in parts)
        key = "raw" if codec_k is None else f"codec_k{codec_k}"
        out[key] = {"frame_ms": ms, "ms_per_world": ms / DG_WORLDS,
                    "egress_bytes": nbytes, "egress_ms": c_ms,
                    "egress_MBps": nbytes / 1e6 / (c_ms / 1e3)}
        print(f"phase 6 datagen steady frame {key} [{card}]: {ms:.3f} ms for "
              f"{DG_WORLDS} worlds = {ms / DG_WORLDS:.5f} ms/world (CUDA "
              f"events, step + render{'' if codec_k is None else ' + codec'}); "
              f"egress {nbytes / 1e6:.1f} MB into pinned memory in "
              f"{c_ms:.3f} ms = {nbytes / 1e6 / (c_ms / 1e3):.1f} MB/s")
    res["frame"] = out
    res["chunks"] = chunks
    res["tex"] = tex
    return res


def _frame_trace(fn, path, classify, buckets) -> dict:
    """One torch.profiler trace of ``fn()``, exported to ``path``: each
    device op's time added to the bucket of ``buckets`` that
    ``classify(name, cat, owner)`` names (``owner`` the innermost
    ``datagen.*`` range around its launch, "" outside them), the device's
    busy time (the union of its spans), the window on the host's clock,
    the idle share over it and the top five device ops."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == "user_annotation"
              and e["name"].startswith("datagen.")]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    split = dict.fromkeys(buckets, 0.0)
    by_name = collections.Counter()
    for e in dev:
        t = launch.get(e.get("args", {}).get("correlation"))
        owner = [r for r in ranges if t is not None and r[0] <= t <= r[1]]
        owner = min(owner, key=lambda r: r[1] - r[0])[2] if owner else ""
        split[classify(e["name"], e.get("cat"), owner)] += e["dur"]
        by_name[e["name"][:60]] += e["dur"]
    host = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") in ("cpu_op", "cuda_runtime", "user_annotation")]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    _check(bool(spans) and bool(host), f"trace {path}: no device/host spans")
    t0 = min(a for a, _ in host + spans)
    t1 = max(b for _, b in host + spans)
    busy = _union_us(spans)
    return {"window_us": t1 - t0, "device_busy_us": busy,
            "device_ops": len(dev), "split_us": split,
            "idle_share": 1.0 - busy / (t1 - t0),
            "top_ops_us": by_name.most_common(5)}


def _dg_trace(tex, chunks, card) -> dict:
    """Phase 7 for the datagen path: one torch.profiler trace of one steady
    frame of all worlds with the codec and the copy to pinned memory, split
    into K5r (K5 where a chunk is too small for it), raster, composite
    (the rest of the render range: binning,
    rays, shading of the hits, the uint8 cast), codec and copy, with the
    device's idle share over the frame."""
    import torch

    from wgpu_physics_engine_torch.parallel import datagen

    def classify(name, cat, owner):
        if "substep_kernel_batched" in name:
            return "k5"
        if "tiled_kernel" in name:
            return "k5r"
        if "sphere_raster" in name:
            return "raster"
        if cat == "gpu_memcpy" or owner == "datagen.fetch":
            return "copy"
        return {"datagen.codec": "codec",
                "datagen.render": "composite"}.get(owner, "other")

    side = torch.cuda.Stream()
    tr = _frame_trace(
        lambda: datagen._Fetch(_dg_frame(tex, chunks, DG_K), side).wait(),
        os.path.join(OUT, "trace_datagen_frame.json"), classify,
        ("k5", "k5r", "raster", "composite", "codec", "copy", "other"))
    split = tr["split_us"]
    _check(split["k5r"] > 0 and split["raster"] > 0,
           f"datagen trace shows no K5r or raster time: {split}")
    print(f"phase 7 trace one datagen frame, {DG_WORLDS} worlds with codec "
          f"and copy [{card}]: window {tr['window_us']:.1f} us (host, "
          f"profiled), device busy {tr['device_busy_us']:.1f} us in "
          f"{tr['device_ops']} device ops; device time us: "
          + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
          + f"; device idle share {tr['idle_share']:.4f}")
    return tr


def _max_rel(a, b) -> float:
    """max |a - b| over max |b| (float64)."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _diff_grads(state, params, n, seg, wp, wv):
    """Gradients of sum(pos * wp) + sum(vel * wv) after ``multi_step_diff``
    with respect to pos, vel, pin_pos, every ClothParams leaf and dt, and
    the output state."""
    import torch

    from wgpu_physics_engine_torch.core.state import ClothParams
    from wgpu_physics_engine_torch.models import cloth

    leaves = [a.detach().clone().requires_grad_(True) for a in params]
    pos, vel, pin_pos = (a.detach().clone().requires_grad_(True)
                         for a in (state.pos, state.vel, state.pin_pos))
    dt = torch.tensor(DT, device=pos.device, requires_grad=True)
    out = cloth.multi_step_diff(
        state._replace(pos=pos, vel=vel, pin_pos=pin_pos),
        ClothParams(*leaves), dt, n, segment=seg)
    loss = (out.pos * wp).sum() + (out.vel * wv).sum()
    names = ["pos", "vel", "pin_pos", *ClothParams._fields, "dt"]
    grads = torch.autograd.grad(loss, [pos, vel, pin_pos, *leaves, dt])
    return dict(zip(names, grads)), out


def _adjoint_case(label, state, params, n_diff, card) -> dict:
    """Phase 11 on one pinned state: one substep of the adjoint kernel
    against its plain version, ``multi_step_diff`` over ``n_diff`` substeps
    (one segment) against the plain path, and the trace against the
    forward."""
    import torch

    from wgpu_physics_engine_torch.ops import cloth_grad_kernel, cloth_kernel

    dev = state.pos.device
    h, w = state.pos.shape[-2:]
    prm = cloth_kernel._pack_params(params, DT).to(dev)
    g = torch.Generator().manual_seed(h + 17)
    cp, cv, wp, wv = (torch.randn((3, h, w), generator=g).to(dev)
                      for _ in range(4))
    x = state.pos
    contact = float((torch.linalg.vector_norm(x, dim=0) < prm[14])
                    .float().mean())
    planes = torch.cat([state.pos, state.vel])
    pins = (state.pin_mask, state.pin_pos)
    before = cloth_grad_kernel.LAUNCHES
    k = cloth_grad_kernel.substep_vjp_kernel(planes, cp, cv, prm, pins)
    torch.cuda.synchronize()
    n_launch = cloth_grad_kernel.LAUNCHES - before
    pl = cloth_grad_kernel.substep_vjp_plain(planes, cp, cv, prm, pins)
    rel = {name: _max_rel(a, b) for name, a, b in
           zip(("ct_pos", "ct_vel", "ct_prm", "ct_pin"), k, pl)}
    err = max(_maxdiff(a, b) for a, b in zip(k, pl))
    bitwise = bool(torch.equal(k[0], pl[0]) and torch.equal(k[1], pl[1]))
    pin_bitwise = bool(torch.equal(k[3], pl[3]))
    # a walk of the segment's trace, the kernel against its plain version
    traj = cloth_kernel.trace(state, prm, n_diff)
    before = cloth_grad_kernel.LAUNCHES
    kw = cloth_grad_kernel.walk(traj, cp, cv, prm, pins)
    torch.cuda.synchronize()
    n_walk = cloth_grad_kernel.LAUNCHES - before
    pw = cloth_grad_kernel._walk_plain(traj, cp, cv, prm, pins)
    del traj
    walk_bitwise = bool(torch.equal(kw[0], pw[0]) and torch.equal(kw[1], pw[1])
                        and torch.equal(kw[3], pw[3]))
    walk_rel = _max_rel(kw[2], pw[2])
    print(f"phase 11 cloth_substep_vjp {label} @{h}x{w} pinned, 1 substep "
          f"[{card}]: max-relative {', '.join(f'{a} {b:.3e}' for a, b in rel.items())} "
          f"(<=1e-5); state cotangents bitwise {bitwise}, pin bitwise "
          f"{pin_bitwise}; max abs {err:.3e}; launches {n_launch}; particles "
          f"in contact {contact:.4f}; walk of {n_diff} substeps: state and "
          f"pin cotangents bitwise {walk_bitwise}, ct_prm max-relative "
          f"{walk_rel:.3e}, launches {n_walk}")
    _check(n_launch == 1, f"adjoint {label} launched {n_launch} times")
    _check(n_walk == n_diff, f"adjoint walk {label} launched {n_walk} times")
    _check(bitwise and pin_bitwise and walk_bitwise,
           f"adjoint {label}: state or pin cotangents differ from the plain "
           f"version (one substep {bitwise}, {pin_bitwise}; walk "
           f"{walk_bitwise})")
    _check(walk_rel <= 1e-5, f"adjoint walk {label}: ct_prm {walk_rel}")
    _check(all(v <= 1e-5 for v in rel.values()), f"adjoint {label}: {rel}")
    _check(float(k[3].abs().max()) > 0, f"adjoint {label}: no pin cotangent")

    # the trace's last state is the forward's output, bit for bit
    traj = cloth_kernel.trace(state, prm, n_diff + 1)
    fwd = cloth_kernel.multi_step_kernel(state, params, DT, n_diff)
    trace_ok = bool(torch.equal(traj[n_diff, :3], fwd.pos)
                    and torch.equal(traj[n_diff, 3:], fwd.vel))
    del traj
    # multi_step_diff, one segment, kernels against the plain versions
    gk, out_k = _diff_grads(state, params, n_diff, n_diff, wp, wv)
    with _plain_kernels():
        gp, out_p = _diff_grads(state, params, n_diff, n_diff, wp, wv)
    torch.cuda.synchronize()
    primal = bool(torch.equal(out_k.pos, out_p.pos)
                  and torch.equal(out_k.vel, out_p.vel))
    drel = {}
    for name in gk:
        a, b = gk[name], gp[name]
        if float(b.abs().max()) < 1e-6:
            drel[name] = float(a.abs().max())   # both ~0: the absolute value
            _check(drel[name] < 1e-6, f"multi_step_diff {label} {name}: "
                   f"{drel[name]} where the plain path gives ~0")
        else:
            drel[name] = _max_rel(a, b)
    worst = max(drel, key=drel.get)
    finite = all(bool(torch.isfinite(v).all()) for v in gk.values())
    print(f"phase 11 multi_step_diff {label} @{h}x{w}, {n_diff} substeps "
          f"(one segment) [{card}]: gradients vs the plain path max-relative "
          f"{drel[worst]:.3e} ({worst}) (<=1e-4), pos {drel['pos']:.3e}, vel "
          f"{drel['vel']:.3e}, pin_pos {drel['pin_pos']:.3e}, dt "
          f"{drel['dt']:.3e}; primal equal {primal}; finite {finite}; trace's "
          f"last state == forward {trace_ok}")
    _check(trace_ok, f"trace {label}: last state != forward")
    _check(primal, f"multi_step_diff {label}: primal differs from plain")
    _check(finite, f"multi_step_diff {label}: gradients not finite")
    _check(drel[worst] <= 1e-4, f"multi_step_diff {label}: {drel}")
    return {"contact_share": contact, "substep_rel": rel,
            "substep_bitwise": bitwise, "pin_bitwise": pin_bitwise,
            "walk_bitwise": walk_bitwise, "walk_prm_rel": walk_rel,
            "substep_max_abs": err, "diff_rel": drel, "trace_equal": trace_ok,
            "primal_equal": primal}, err


def _phase11_adjoint(draped, free, params, dev, card):
    """Phase 11: the adjoint kernel against its plain version at 256² (the
    draped state of phase 5 and a free-fall state, both with the top row
    pinned) and at 1024² over 4 substeps."""
    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      init_cloth_state)

    def pinned(s):
        pin = torch.zeros(s.pos.shape[-2:], dtype=torch.bool, device=dev)
        pin[0] = True
        return s._replace(pin_mask=pin, pin_pos=s.pos)

    res, err = {}, 0.0
    res["draped"], e = _adjoint_case("draped", pinned(draped), params,
                                     FIT_SEG, card)
    err = max(err, e)
    _check(res["draped"]["contact_share"] > 0, "draped state: no contact")
    res["free"], e = _adjoint_case("free fall", pinned(free), params, FIT_SEG,
                                   card)
    err = max(err, e)
    cfg_big = ClothConfig(height=BIG, width=BIG)
    big = init_cloth_state(cfg_big, device=dev)
    g = torch.Generator().manual_seed(BIG)
    big = big._replace(vel=torch.randn((3, BIG, BIG), generator=g).to(dev))
    res[f"{BIG}"], e = _adjoint_case(
        f"free fall, random velocities", pinned(big),
        ClothParams.from_config(cfg_big, device=dev), BIG_STEPS, card)
    err = max(err, e)
    return res, err


def _phase12_trainer(dev, card) -> dict:
    """Phase 12: the example's gravity fit at 256², counted, and the Newton
    check."""
    import math

    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.examples import differentiable_cloth
    from wgpu_physics_engine_torch.models import cloth
    from wgpu_physics_engine_torch.ops import (cloth_grad_kernel, cloth_kernel,
                                               raster_kernel)

    torch.cuda.synchronize()
    cloth_kernel.LAUNCHES = 0
    cloth_kernel.LAUNCHES_BATCHED = 0
    raster_kernel.LAUNCHES = 0
    cloth_grad_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    hist = differentiable_cloth.main(["--kernel", "--grid", str(GRID),
                                      "--device", str(dev)])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"cloth_step": cloth_kernel.LAUNCHES,
                "cloth_substep_vjp": cloth_grad_kernel.LAUNCHES,
                "cloth_step_batched": cloth_kernel.LAUNCHES_BATCHED,
                "sphere_raster": raster_kernel.LAUNCHES}
    n, seg, iters = (differentiable_cloth.N_SUBSTEPS,
                     differentiable_cloth.SEGMENT, differentiable_cloth.ITERS)
    # per iteration: the forward, then per segment a trace of seg - 1
    # substeps and an adjoint walk of seg
    want = {"cloth_step": iters * (n + n - -(-n // seg)),
            "cloth_substep_vjp": iters * n}
    finite = all(math.isfinite(a) and math.isfinite(b) for a, b in hist)
    print(f"phase 12 training path [{card}]: python -m wgpu_physics_engine_"
          f"torch.examples.differentiable_cloth --kernel --grid {GRID} "
          f"({iters} iterations x {n} substeps, segment {seg}) {fit_s:.3f} "
          f"s host clock; loss {hist[0][0]:.5f} -> "
          f"{hist[-1][0]:.5f}, gravity -> {hist[-1][1]:.4f}; launches "
          f"{launches}, expected {want}")
    _check(finite, f"trainer history not finite: {hist}")
    _check(hist[-1][0] < hist[0][0], f"trainer loss did not fall: {hist}")
    _check(all(launches[k] == v for k, v in want.items()),
           f"training path launches {launches}, expected {want}")

    # one Newton step: the COM height after free fall is linear in gravity
    c = ClothConfig(height=GRID, width=GRID)
    s0 = init_cloth_state(c, device=dev)
    base = ClothParams.from_config(c, device=dev)

    def rollout(g):
        out = cloth.multi_step_diff(s0, base._replace(gravity=g), DT, 240,
                                    segment=FIT_SEG)
        return out.pos[1].mean()

    g0 = torch.tensor(-9.81, device=dev, requires_grad=True)
    y0 = rollout(g0)
    (dy,) = torch.autograd.grad(y0, g0)
    y0 = float(y0.detach())
    g_star = g0.detach() - (y0 - 36.0) / dy
    y_star = float(rollout(g_star))
    print(f"phase 12 Newton step @{GRID}x{GRID}, 240 substeps: y0 {y0:.6f}, "
          f"dy/dg {float(dy):.6e}, g* {float(g_star):.6f}, y(g*) "
          f"{y_star:.6f} (|y - 36| {abs(y_star - 36.0):.3e} <= 1e-3)")
    _check(abs(y_star - 36.0) <= 1e-3, f"Newton step lands at {y_star}")
    return {"history": hist, "fit_s": fit_s, "launches": launches,
            "expected": want, "newton": {"y0": y0, "dy": float(dy),
                                         "g_star": float(g_star),
                                         "y_star": y_star}}


def _grad_times(params, dev, card) -> dict:
    """Phases 6 and 7 for the training path."""
    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.examples import differentiable_cloth as dc
    from wgpu_physics_engine_torch.ops import cloth_grad_kernel, cloth_kernel

    res = {}
    cfg = ClothConfig(height=GRID, width=GRID)
    s0 = init_cloth_state(cfg, device=dev)
    prm = cloth_kernel._pack_params(params, DT).to(dev)
    traj = cloth_kernel.trace(s0, prm, FIT_SEG)
    g = torch.Generator().manual_seed(5)
    cp, cv = (torch.randn((3, GRID, GRID), generator=g).to(dev)
              for _ in range(2))
    k_ms = _best_ms(lambda: cloth_grad_kernel._walk_kernel(
        traj, cp, cv, prm, None)) / FIT_SEG
    n_plain = 8
    p_ms = _best_ms(lambda: cloth_grad_kernel._walk_plain(
        traj[:n_plain], cp, cv, prm, None)) / n_plain
    from wgpu_physics_engine_torch.ops.cloth_kernel import _FAMILIES

    edges = sum((GRID - dr) * (GRID - abs(dc)) for dr, dc, _ in _FAMILIES)
    b_ms, b_by = _bound(VJP_BYTES * GRID * GRID,
                        OPS_VJP_EDGE * edges + OPS_VJP_PARTICLE * GRID * GRID)
    res["vjp"] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                  "bound_by": b_by}
    print(f"phase 6 cloth_substep_vjp @{GRID}x{GRID} [{card}]: kernel "
          f"{k_ms:.5f} ms/substep (walk of {FIT_SEG}), plain {p_ms:.5f} "
          f"ms/substep (walk of {n_plain}), bound {b_ms:.5f} ms ({b_by}), "
          f"kernel at {b_ms / k_ms:.4f} of the bound")
    del traj

    # the adjoint at 1024² (the size of JAX's streamed tier, K9)
    cfg_big = ClothConfig(height=BIG, width=BIG)
    s_big = init_cloth_state(cfg_big, device=dev)
    prm_big = cloth_kernel._pack_params(
        ClothParams.from_config(cfg_big, device=dev), DT).to(dev)
    n_big, n_big_plain = 8, 2
    traj = cloth_kernel.trace(s_big, prm_big, n_big)
    cp, cv = (torch.randn((3, BIG, BIG), generator=g).to(dev) for _ in range(2))
    kb_ms = _best_ms(lambda: cloth_grad_kernel._walk_kernel(
        traj, cp, cv, prm_big, None)) / n_big
    pb_ms = _best_ms(lambda: cloth_grad_kernel._walk_plain(
        traj[:n_big_plain], cp, cv, prm_big, None)) / n_big_plain
    edges_big = sum((BIG - dr) * (BIG - abs(dc)) for dr, dc, _ in _FAMILIES)
    bb_ms, bb_by = _bound(VJP_BYTES * BIG * BIG,
                          OPS_VJP_EDGE * edges_big + OPS_VJP_PARTICLE * BIG * BIG)
    res["vjp_1024"] = {"ms": kb_ms, "plain_ms": pb_ms, "bound_ms": bb_ms,
                       "bound_by": bb_by}
    print(f"phase 6 cloth_substep_vjp @{BIG}x{BIG} [{card}]: kernel "
          f"{kb_ms:.5f} ms/substep (walk of {n_big}), plain {pb_ms:.5f} "
          f"ms/substep (walk of {n_big_plain}), bound {bb_ms:.5f} ms "
          f"({bb_by}), kernel at {bb_ms / kb_ms:.4f} of the bound")
    del traj

    base = ClothParams.from_config(cfg, device=dev)
    dt = torch.tensor(DT, device=dev)

    def value_and_grad(n):
        gr = torch.tensor(-9.81, device=dev, requires_grad=True)
        y = dc.rollout(s0, base, gr, dt, True, n, dc.SEGMENT)
        return torch.autograd.grad((y - dc.TARGET_Y) ** 2, gr)

    vg = {}
    for label, n, ctx in (("kernel", dc.N_SUBSTEPS, contextlib.nullcontext),
                          ("plain", dc.SEGMENT, _plain_kernels)):
        with ctx():
            value_and_grad(n)
            ts = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                value_and_grad(n)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
        rate = GRID * GRID * n / min(ts)
        vg[label] = {"substeps": n, "s": ts, "psteps_per_s": rate}
        print(f"phase 6 value_and_grad {label} @{GRID}x{GRID}, {n} substeps, "
              f"segment {FIT_SEG} [{card}]: best {min(ts) * 1e3:.3f} ms of "
              f"{', '.join(f'{t * 1e3:.3f}' for t in ts)} (host clock) = "
              f"{rate:.4e} particle-steps/s")
    res["value_and_grad"] = vg

    k1 = {}
    for side in (512, BIG):
        c = ClothConfig(height=side, width=side)
        s = init_cloth_state(c, device=dev)
        pr = ClothParams.from_config(c, device=dev)
        ms = _best_ms(lambda: cloth_kernel.multi_step_kernel(
            s, pr, DT, 240)) / 240
        bm, bb = _cloth_bound(side, side, 1, 240)
        k1[str(side)] = {"ms": ms, "bound_ms": bm / 240, "bound_by": bb,
                         "psteps_per_s": side * side / (ms / 1e3)}
        print(f"phase 6 cloth_step (K1) @{side}x{side} [{card}]: {ms:.5f} "
              f"ms/substep = {side * side / (ms / 1e3):.4e} particle-steps/s, "
              f"bound {bm / 240:.5f} ms ({bb})")
    res["k1_large"] = k1

    # one traced value_and_grad of one segment
    dev_spans, host = _trace(lambda: value_and_grad(dc.SEGMENT),
                             os.path.join(OUT, "trace_value_and_grad.json"))
    kinds = {"K1 substep_kernel": "substep_kernel",
             "vjp_substep": "vjp_substep",
             "reduce_partials": "reduce_partials"}
    per = {}
    for label, key in kinds.items():
        ds = [b - a for a, b, name in dev_spans if key in name]
        per[label] = {"launches": len(ds),
                      "us_per_launch": sum(ds) / max(len(ds), 1)}
    t0 = min([a for a, _ in host] + [a for a, _, _ in dev_spans])
    t1 = max([b for _, b in host] + [b for _, b, _ in dev_spans])
    spans = sorted((a, b) for a, b, _ in dev_spans)
    busy = _union_us(spans)
    # gaps between consecutive device ops: the short ones separate the
    # launches of one C loop, the long ones are the host's work between
    # them (autograd, the small torch ops around each segment)
    gaps = sorted(max(0.0, spans[i + 1][0] - spans[i][1])
                  for i in range(len(spans) - 1))
    median = gaps[len(gaps) // 2] if gaps else 0.0
    long_gaps = [g for g in gaps if g > 20.0]
    res["trace"] = {"window_us": t1 - t0, "device_busy_us": busy,
                    "device_ops": len(dev_spans), "per_kernel": per,
                    "median_gap_us": median,
                    "gaps_over_20us": {"n": len(long_gaps),
                                       "us": sum(long_gaps),
                                       "max_us": max(gaps, default=0.0)},
                    "idle_share": 1.0 - busy / (t1 - t0)}
    print(f"phase 7 trace value_and_grad, {dc.SEGMENT} substeps @{GRID}x{GRID} "
          f"[{card}]: window {t1 - t0:.1f} us (host, profiled), device busy "
          f"{busy:.1f} us in {len(dev_spans)} device ops; median gap between "
          f"them {median:.3f} us, {len(long_gaps)} gaps over 20 us totalling "
          f"{sum(long_gaps):.1f} us (largest {max(gaps, default=0.0):.1f}); "
          + ", ".join(f"{k} {v['launches']} x {v['us_per_launch']:.3f} us"
                      for k, v in per.items())
          + f"; device idle share {1.0 - busy / (t1 - t0):.4f}")
    _check(per["vjp_substep"]["launches"] == dc.SEGMENT
           and per["reduce_partials"]["launches"] == 1,
           f"value_and_grad trace: adjoint launches {per}")
    return res


def _gr_configs() -> dict:
    """The granular pile at full width: the default configuration and the
    bench's (``bench.py:172``)."""
    from wgpu_physics_engine_torch.models.granular import GranularConfig

    return {"default": GranularConfig(num_particles=GR_N),
            "bench": GranularConfig(num_particles=GR_N, **GR_BENCH)}


def _k10_case(state, cfg, label, card, need_drop=False):
    """Phase 13 on one state and configuration: K10 against its plain
    version over the rebuild's candidate set, one substep (pos and vel
    <= 1e-5) and one rebuild block (pos <= 1e-5, vel <= 1e-4); the share of
    particles in contact and the dropped count (exact, and the fast
    indicator)."""
    import torch

    from wgpu_physics_engine_torch.models import granular
    from wgpu_physics_engine_torch.ops import granular_kernel as gk

    n = state.pos.shape[-1]
    grid, slabs, d_exact = granular.rebuild(state.pos, state.vel, cfg,
                                            stats=True)
    _, _, d_fast = granular.rebuild(state.pos, state.vel, cfg)
    prm = gk.kernel_params(cfg, GR_DT, state.pos.device)
    p0, v0 = grid.sorted_pos, grid.sorted_vel
    before = gk.LAUNCHES
    kp, kv = gk.substep_sorted_kernel(p0, v0, prm, slabs)
    torch.cuda.synchronize()
    launched = gk.LAUNCHES - before
    pp, pv = gk.substep_sorted_plain(p0, v0, prm, slabs)
    e1 = max(_maxdiff(kp, pp), _maxdiff(kv, pv))
    for _ in range(cfg.rebuild_every - 1):
        kp, kv = gk.substep_sorted_kernel(kp, kv, prm, slabs)
        pp, pv = gk.substep_sorted_plain(pp, pv, prm, slabs)
    torch.cuda.synchronize()
    eb_p, eb_v = _maxdiff(kp, pp), _maxdiff(kv, pv)
    (a_lo, a_hi), (b_lo, b_hi) = gk.slab_ranges(slabs, n)
    f = (gk._pass_sums(p0, a_lo, a_hi, prm[0], prm[1])
         + gk._pass_sums(p0, b_lo, b_hi, prm[0], prm[1]))
    contact = float((f != 0).any(0).float().mean())
    cand = gk.candidate_count(slabs, n)
    finite = bool(torch.isfinite(kp).all() and torch.isfinite(kv).all())
    print(f"phase 13 granular_step (K10) {label} @{n} [{card}]: 1 substep "
          f"{e1:.3e} (<=1e-5); {cfg.rebuild_every}-substep block pos "
          f"{eb_p:.3e} (<=1e-5) vel {eb_v:.3e} (<=1e-4); launches {launched}; "
          f"candidates {cand} ({cand / n:.2f} a particle); particles in "
          f"contact {contact:.4f}; dropped exact {int(d_exact)}, fast "
          f"indicator {int(d_fast)}; finite {finite}")
    _check(launched == 1, f"K10 {label} launched {launched} times")
    _check(e1 <= 1e-5, f"K10 {label} 1 substep diff {e1}")
    _check(eb_p <= 1e-5 and eb_v <= 1e-4,
           f"K10 {label} block diff {eb_p} {eb_v}")
    _check(finite, f"K10 {label} state not finite")
    if need_drop:
        _check(int(d_exact) > 0, f"K10 {label}: the slab is not undersized")
    return {"err_1": e1, "err_block_pos": eb_p, "err_block_vel": eb_v,
            "candidates": cand, "contact_share": contact,
            "dropped_exact": int(d_exact), "dropped_fast": int(d_fast)}, \
        max(e1, eb_p, eb_v)


def _phase13_k10(state, label, card, extra: bool):
    """Phase 13: K10 vs plain at 1M for the default and the bench
    configuration; with ``extra`` also the window formulation (civ=False)
    and an undersized slab (block 256, slab 128)."""
    import dataclasses

    res, err = {}, 0.0
    cases = dict(_gr_configs())
    if extra:
        d = cases["default"]
        cases["windows"] = dataclasses.replace(d, civ=False)
        cases["undersized"] = dataclasses.replace(d, pallas_block=256,
                                                  pallas_slab=128)
    for name, cfg in cases.items():
        res[name], e = _k10_case(state, cfg, f"{label} {name}", card,
                                 need_drop=name == "undersized")
        err = max(err, e)
    return res, err


def _pile_stats(state) -> dict:
    """The ensemble of a pile: mean and max height, kinetic energy a
    particle (unit mass)."""
    v2 = (state.vel.double() ** 2).sum(0)
    return {"y_mean": float(state.pos[1].double().mean()),
            "y_max": float(state.pos[1].max()),
            "ke": float(0.5 * v2.mean())}


def _gr_pixels(img):
    """(sand, blue) pixel counts of a float [H, W, 3] or uint8 frame."""
    import numpy as np

    img = np.asarray(img, np.float64)
    if img.max() > 1.5:
        img = img / 255.0
    sand = (np.abs(img - np.asarray(SAND)).max(-1) <= 0.5 / 255).sum()
    blue = (np.abs(img - np.asarray([0.0, 0.0, 1.0])).max(-1)
            <= 0.5 / 255).sum()
    return int(sand), int(blue)


def _phase14_granular(dev, card, cli_main):
    """Phase 14: the granular main path, counted: GranularScene at 1M,
    simulate 2 s at 240 Hz, a frame, and the CLI; the checks on it and the
    ensemble against the plain version's run of the same scene."""
    import numpy as np
    import torch
    from PIL import Image

    from wgpu_physics_engine_torch.models.scenes import GranularScene
    from wgpu_physics_engine_torch.ops import granular_kernel, raster_kernel
    from wgpu_physics_engine_torch.render import camera as cam_mod
    from wgpu_physics_engine_torch.utils import viewer

    cfg = _gr_configs()["default"]
    fh, fw = GR_FRAME
    png = os.path.join(OUT, "granular_cli.png")
    scene = GranularScene(cfg, device=dev)
    scene.resize(fw, fh)
    y_start = float(scene.state.pos[1].mean())
    torch.cuda.synchronize()
    granular_kernel.LAUNCHES = 0
    raster_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    scene.simulate(GR_SECONDS)
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    img = scene.render(fh, fw)
    rc = cli_main(["granular", "--particles", str(GR_N), "--size", str(fh),
                   str(fw), "--seconds", str(GR_CLI_SECONDS), "--out", png,
                   "--device", "cuda"])
    torch.cuda.synchronize()
    launches = {"granular_step": granular_kernel.LAUNCHES,
                "sphere_raster": raster_kernel.LAUNCHES}
    substeps = round(GR_SECONDS * 240) + round(GR_CLI_SECONDS * 240)
    print(f"phase 14 granular main path [{card}]: GranularScene("
          f"GranularConfig(num_particles={GR_N})) simulate({GR_SECONDS}) "
          f"{sim_s:.3f} s host clock ({round(GR_SECONDS * 240)} substeps, "
          f"dropped {scene.dropped}) + render{GR_FRAME} + CLI --seconds "
          f"{GR_CLI_SECONDS} (rc {rc}); launches {launches}, substeps "
          f"{substeps}")
    _check(rc == 0, f"granular CLI returned {rc}")
    _check(launches["granular_step"] == substeps,
           f"K10 launched {launches['granular_step']} times, not {substeps}")
    _check(launches["sphere_raster"] >= 2, f"raster launches {launches}")
    viewer.save_png(img, os.path.join(OUT, "granular.png"))

    # the raster kernel at this path's shapes (1M instances of radius 0.04),
    # held against its plain version on the frame's own bins (the counts
    # are already read)
    cam = scene.camera()
    eye, dirs = cam_mod.pixel_rays(cam, fh, fw)
    wins, ocb, _, rect = raster_kernel.tiled_prologue(
        cam.view[:3, :3], eye, scene.state.pos.T, float(cfg.radius),
        cam.znear, torch.tan(cam.fovy_rad / 2.0), cam.aspect, fh, fw)
    raster = _raster_vs_plain(
        wins, ocb, rect, dirs, cam.znear, f"phase 14 sphere_raster vs plain "
        f"@{fh}x{fw}, {GR_N} instances (the granular frame)", 100)
    raster["ms"] = _best_ms(lambda: raster_kernel.sphere_raster_kernel(
        wins, ocb, rect, dirs, cam.znear))
    raster["bound_ms"], raster["bound_by"], raster["ring_bound_ms"] = (
        _raster_bound(wins, rect, fh, fw))
    print(f"phase 6 sphere_raster @{fh}x{fw}, {GR_N} instances (the "
          f"granular frame) [{card}]: {raster['ms']:.4f} ms, bound "
          f"{raster['bound_ms']:.5f} ms ({raster['bound_by']}; the first "
          f"port's ring sweep {raster['ring_bound_ms']:.4f} ms)")
    del wins, ocb, rect, dirs

    pos = scene.state.pos
    limit = torch.tensor(cfg.bounds - cfg.radius, dtype=torch.float32)
    finite = bool(torch.isfinite(pos).all()
                  and torch.isfinite(scene.state.vel).all())
    inside = float(pos.abs().max()) <= float(limit)
    got = _pile_stats(scene.state)
    with _plain_kernels():
        ref_scene = GranularScene(cfg, device=dev)
        t0 = time.perf_counter()
        ref_scene.simulate(GR_SECONDS)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    ref = _pile_stats(ref_scene.state)
    rel = {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in got}
    sand, blue = _gr_pixels(img)
    cli_sand, cli_blue = _gr_pixels(np.asarray(Image.open(png).convert("RGB"))
                                    if os.path.exists(png) else
                                    np.zeros((1, 1, 3)))
    print(f"phase 14 pile: finite {finite}, |pos| <= bounds - radius "
          f"{inside}, mean height {y_start:.5f} -> {got['y_mean']:.5f}; "
          f"kernel vs plain run ({plain_s:.3f} s host clock) {got} vs {ref}, "
          f"relative {rel} (<=1e-2); frame {fh}x{fw} sand px {sand}, "
          f"wireframe px {blue}; CLI png sand px {cli_sand}, wireframe px "
          f"{cli_blue}")
    _check(finite, "granular state not finite")
    _check(inside, "a particle left the box")
    _check(got["y_mean"] < y_start, "the pile did not fall")
    _check(all(v <= 1e-2 for v in rel.values()),
           f"granular ensemble off: {rel}")
    _check(sand > 100 and blue > 100, f"frame lacks sand/wireframe: "
           f"{sand} {blue}")
    _check(cli_sand > 100 and cli_blue > 100,
           f"CLI png lacks sand/wireframe: {cli_sand} {cli_blue}")
    del ref_scene
    return {"launches": launches, "substeps": substeps, "simulate_s": sim_s,
            "plain_simulate_s": plain_s, "dropped": scene.dropped,
            "raster": raster,
            "y_start": y_start, "kernel": got, "plain": ref, "rel": rel,
            "sand_px": sand, "wire_px": blue, "cli_sand_px": cli_sand,
            "cli_wire_px": cli_blue}, scene.state


def _gr_times(fresh, settled, card) -> dict:
    """Phases 6 and 7 for the granular path: K10 a substep at 1M (both
    configurations on the fresh lattice, the default one on the settled
    pile) beside its plain version and its bound from this run's candidate
    slots and touching pairs, the rebuild, multi_step's particle-steps/s (64 substeps, bench
    configuration, best of 3, the counterpart of ``granular_1m``), and one
    torch.profiler trace of a rebuild block split into rebuild, K10 and
    idle."""
    import torch

    from wgpu_physics_engine_torch.models import granular
    from wgpu_physics_engine_torch.ops import granular_kernel as gk

    res = {}
    cases = [(f"{k} fresh", c, fresh) for k, c in _gr_configs().items()]
    cases.append(("default settled", _gr_configs()["default"], settled))
    for label, cfg, st in cases:
        n = st.pos.shape[-1]
        grid, slabs, _ = granular.rebuild(st.pos, st.vel, cfg)
        prm = gk.kernel_params(cfg, GR_DT, st.pos.device)
        p0, v0 = grid.sorted_pos, grid.sorted_vel
        k_ms = _best_ms(lambda: gk.substep_sorted_kernel(p0, v0, prm, slabs))
        p_ms = _best_ms(lambda: gk.substep_sorted_plain(p0, v0, prm, slabs))
        r_ms = _best_ms(lambda: granular.rebuild(st.pos, st.vel, cfg))
        cand = gk.candidate_count(slabs, n)
        touch = gk.touching_count(p0, prm, slabs)
        b_ms, b_by = _bound(GR_BYTES * n, OPS_SLOT * cand + OPS_TOUCH * touch
                            + OPS_GR_PARTICLE * n)
        res[label] = {"ms": k_ms, "plain_ms": p_ms, "rebuild_ms": r_ms,
                      "candidates": cand, "touching": touch,
                      "bound_ms": b_ms, "bound_by": b_by}
        print(f"phase 6 granular_step (K10) {label} @{n} [{card}]: kernel "
              f"{k_ms:.4f} ms/substep, plain {p_ms:.4f} ms/substep, bound "
              f"{b_ms:.5f} ms ({b_by}; {cand} candidate slots, {touch} "
              f"touching), kernel at {b_ms / k_ms:.4f} of the bound; rebuild "
              f"{r_ms:.4f} ms")

    cfg = _gr_configs()["bench"]
    ts = []
    for i in range(4):                         # a warm-up, then best of 3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        granular.multi_step(fresh, cfg, GR_DT, GR_MS_STEPS)
        torch.cuda.synchronize()
        if i:
            ts.append(time.perf_counter() - t0)
    n = fresh.pos.shape[-1]
    rate = n * GR_MS_STEPS / min(ts)
    res["multi_step_bench"] = {"substeps": GR_MS_STEPS, "s": ts,
                               "psteps_per_s": rate}
    print(f"phase 6 granular multi_step bench config (rebuild_every 16, "
          f"slab 640, thin) @{n}, {GR_MS_STEPS} substeps [{card}]: best "
          f"{min(ts) * 1e3:.3f} ms of {', '.join(f'{t * 1e3:.3f}' for t in ts)}"
          f" (host clock) = {rate:.4e} particle-steps/s")

    cfg = _gr_configs()["default"]
    dev_spans, host = _trace(
        lambda: granular._run_block_kernel(fresh.pos, fresh.vel, cfg, GR_DT,
                                           cfg.rebuild_every),
        os.path.join(OUT, "trace_granular_block.json"))
    k10 = [b - a for a, b, name in dev_spans if "granular_step" in name]
    other = [b - a for a, b, name in dev_spans if "granular_step" not in name]
    t0 = min([a for a, _ in host] + [a for a, _, _ in dev_spans])
    t1 = max([b for _, b in host] + [b for _, b, _ in dev_spans])
    busy = _union_us([(a, b) for a, b, _ in dev_spans])
    res["trace_block"] = {"window_us": t1 - t0, "device_busy_us": busy,
                          "k10_launches": len(k10), "k10_us": sum(k10),
                          "rebuild_us": sum(other),
                          "rebuild_ops": len(other),
                          "idle_share": 1.0 - busy / (t1 - t0)}
    print(f"phase 7 trace one rebuild block (default, {cfg.rebuild_every} "
          f"substeps) @{n} [{card}]: window {t1 - t0:.1f} us (host, "
          f"profiled), device busy {busy:.1f} us: K10 {len(k10)} x "
          f"{sum(k10) / max(len(k10), 1):.1f} us, rebuild {sum(other):.1f} us "
          f"in {len(other)} device ops; device idle share "
          f"{1.0 - busy / (t1 - t0):.4f}")
    _check(len(k10) == cfg.rebuild_every,
           f"granular trace shows {len(k10)} K10 launches")
    return res


# ---------------------------------------------------------------------------
# Contact gradients and cloth self-collision (phases 15-17)
# ---------------------------------------------------------------------------

def _sc_structs(state, params, slab, block=SC_BLOCK):
    """The self-collision candidate set of a cloth state (thin CIV, the
    scene's grid with a skin of 2·r): (sorted positions, slabs, md, kc,
    grid order, dropped exact)."""
    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.models import cloth

    h, w = state.pos.shape[-2:]
    c = ClothConfig(height=h, width=w)
    spec = cloth.default_self_collision_grid(c, skin=2.0 * c.particle_radius)
    flat = state.pos.reshape(3, h * w)
    grid, slabs, dropped = cloth._frozen_structs(
        flat, state.vel.reshape(3, h * w), spec, block, slab, stats=True)
    return (grid.sorted_pos, slabs, 2.0 * params.particle_radius,
            params.k_contact, grid.order, int(dropped))


def _contact_case(p, slabs, md, kc, label, card, dropped, vel=None,
                  prm=None):
    """K11 and K12 against their plain versions on one candidate set: the
    force and J·u within 1e-5 relative to the largest component (bitwise
    reported), K12's force equal to K11's, the symmetry <Ju, v> = <u, Jv>
    within 1e-4 relative where nothing is dropped, and with a granular
    state (``vel``, ``prm``) K11 with the plain integrate against one K10
    substep bit for bit."""
    import numpy as np
    import torch

    from wgpu_physics_engine_torch.ops import granular_kernel as gk

    n = p.shape[-1]
    rng = np.random.default_rng(15)
    u, v = (torch.tensor(rng.standard_normal((3, n)).astype(np.float32),
                         device=p.device) for _ in range(2))
    before = (gk.LAUNCHES_FORCES, gk.LAUNCHES_JVP)
    f = gk.contact_forces_sorted_kernel(p, md, kc, slabs)
    ft = gk.contact_force_jvp_sorted_kernel(p, u, md, kc, slabs)
    torch.cuda.synchronize()
    launched = (gk.LAUNCHES_FORCES - before[0], gk.LAUNCHES_JVP - before[1])
    f_p = gk.contact_forces_sorted_plain(p, md, kc, slabs)
    ft_p = gk.contact_force_jvp_sorted_plain(p, u, md, kc, slabs)
    ef = _maxdiff(f, f_p)
    ej = _maxdiff(ft[3:], ft_p[3:])
    rf = ef / max(float(f_p.abs().max()), 1e-30)
    rj = ej / max(float(ft_p[3:].abs().max()), 1e-30)
    bitwise = bool(torch.equal(f, f_p) and torch.equal(ft, ft_p))
    same_f = bool(torch.equal(ft[:3], f))
    res = {"err_f": ef, "err_ju": ej, "rel_f": rf, "rel_ju": rj,
           "bitwise": bitwise, "dropped": dropped,
           "f_max": float(f_p.abs().max()),
           "touching": gk.touching_count(p, torch.stack([
               torch.as_tensor(md, device=p.device),
               torch.as_tensor(kc, device=p.device)]), slabs)}
    sym = None
    if dropped == 0:
        jv = gk.contact_force_jvp_sorted_kernel(p, v, md, kc, slabs)[3:]
        a = float((ft[3:].double() * v.double()).sum())
        b = float((u.double() * jv.double()).sum())
        sym = abs(a - b) / max(abs(a), 1e-30)
        res["symmetry"] = sym
    k10 = None
    if prm is not None:
        kp, kv = gk.substep_sorted_kernel(p, vel, prm, slabs)
        ip, iv = gk._integrate(p, vel, f, prm)
        k10 = bool(torch.equal(kp, ip) and torch.equal(kv, iv))
        res["k11_integrate_equals_k10"] = k10
    print(f"phase 15 {label} @{n} [{card}]: K11 vs plain {ef:.3e} ({rf:.3e} "
          f"rel, <=1e-5), K12 J.u vs plain {ej:.3e} ({rj:.3e} rel, <=1e-5), "
          f"bitwise {bitwise}; K12 f == K11 f {same_f}; launches {launched}; "
          f"|f| max {res['f_max']:.4g}, touching {res['touching']}; dropped "
          f"{dropped}; symmetry <Ju,v>/<u,Jv> {sym} (<=1e-4); K11 + plain "
          f"integrate == K10 {k10}")
    _check(launched == (1, 1), f"{label}: launches {launched}")
    _check(rf <= 1e-5 and rj <= 1e-5, f"{label}: K11/K12 off {rf} {rj}")
    _check(same_f, f"{label}: K12's force differs from K11's")
    _check(res["touching"] > 0, f"{label}: no touching pair")
    _check(sym is None or sym <= 1e-4, f"{label}: J not symmetric ({sym})")
    _check(k10 is None or k10, f"{label}: K11 + integrate != K10")
    return res, max(ef, ej)


def _phase15(fresh, draped, params, card):
    """Phase 15: K11 and K12 against their plain versions at 1M (default
    and bench configurations, the fresh lattice) and on the self-collision
    candidate set of the draped flagship; K1f at 256² pinned against its
    plain version, and with a zero force plane against K1."""
    import torch

    from wgpu_physics_engine_torch.models import broadphase, granular
    from wgpu_physics_engine_torch.ops import cloth_kernel
    from wgpu_physics_engine_torch.ops import granular_kernel as gk

    res, err = {}, 0.0
    for name, cfg in _gr_configs().items():
        grid, slabs, d = granular.rebuild(fresh.pos, fresh.vel, cfg,
                                          stats=True)
        prm = gk.kernel_params(cfg, GR_DT, fresh.pos.device)
        res[name], e = _contact_case(
            grid.sorted_pos, slabs, prm[0], prm[1], f"granular {name} fresh",
            card, int(d), vel=grid.sorted_vel, prm=prm)
        err = max(err, e)
    p, slabs, md, kc, order, d = _sc_structs(draped, params, SC_SLAB)
    res["self_collide"], e = _contact_case(
        p, slabs, md, kc, f"self-collision set of the draped {GRID}x{GRID} "
        f"cloth (thin, block {SC_BLOCK}, slab {SC_SLAB})", card, d)
    err = max(err, e)

    # K1f at 256² with the top row pinned and that set's pair forces: the
    # grid-order entry and the sorted entry of the self-collision block
    h, w = draped.pos.shape[-2:]
    inv = broadphase._inverse(order)
    f_sorted = gk.contact_forces_sorted_kernel(p, md, kc, slabs)
    f_self = f_sorted[:, inv].reshape(3, h, w)
    pin = torch.zeros((h, w), dtype=torch.bool, device=draped.pos.device)
    pin[0] = True
    s = draped._replace(pin_mask=pin, pin_pos=draped.pos)
    blk, sb = cloth_kernel.force_block(s, params, DT, inv)
    before = cloth_kernel.LAUNCHES_FORCE
    k = cloth_kernel.substep_with_force_kernel(s, params, DT, f_self)
    ks, ksp = cloth_kernel.substep_with_force_sorted_kernel(sb, blk, f_sorted)
    torch.cuda.synchronize()
    launched = cloth_kernel.LAUNCHES_FORCE - before
    pl = cloth_kernel.substep_with_force_plain(s, params, DT, f_self)
    pls, plsp = cloth_kernel.substep_with_force_sorted_plain(sb, blk, f_sorted)
    ek = max(_maxdiff(k.pos, pl.pos), _maxdiff(k.vel, pl.vel),
             _maxdiff(ks.pos, pls.pos), _maxdiff(ks.vel, pls.vel),
             _maxdiff(ksp, plsp))
    bitwise = bool(torch.equal(k.pos, pl.pos) and torch.equal(k.vel, pl.vel))
    sorted_bitwise = bool(torch.equal(ks.pos, pls.pos)
                          and torch.equal(ks.vel, pls.vel)
                          and torch.equal(ksp, plsp))
    same = bool(torch.equal(ks.pos, k.pos) and torch.equal(ks.vel, k.vel)
                and torch.equal(ksp, k.pos.reshape(3, -1)[:, order.long()]))
    z = cloth_kernel.substep_with_force_kernel(s, params, DT,
                                               torch.zeros_like(f_self))
    k1 = cloth_kernel.multi_step_kernel(s, params, DT, 1)
    k1_same = bool(torch.equal(z.pos, k1.pos) and torch.equal(z.vel, k1.vel))
    moved = _maxdiff(k.vel, k1.vel)
    print(f"phase 15 cloth_step_force (K1f) @{h}x{w} pinned, draped, with the "
          f"self-collision forces [{card}]: grid-order entry vs plain bitwise "
          f"{bitwise}, the sorted entry (forces in the block's sorted order, "
          f"the next sorted positions written) vs its plain version bitwise "
          f"{sorted_bitwise} (largest difference of both {ek:.3e}), the two "
          f"entries and the gather equal {same}; fext = 0 equals K1 bit for "
          f"bit {k1_same}; the force plane moves vel by {moved:.3e}; "
          f"launches {launched}")
    _check(launched == 2, f"K1f launched {launched} times, not 2")
    _check(bitwise and sorted_bitwise, f"K1f differs from its plain version "
           f"({bitwise}, sorted {sorted_bitwise}, {ek})")
    _check(same, "K1f's sorted and grid-order entries differ")
    _check(k1_same, "K1f with fext = 0 differs from K1")
    _check(moved > 0, "the self-collision forces moved nothing")
    _check(torch.equal(k.pos[:, 0], s.pos[:, 0]), "K1f pinned row moved")
    res["cloth_step_force"] = {"err": ek, "bitwise": bitwise,
                               "sorted_bitwise": sorted_bitwise,
                               "k1_bitwise_at_zero": k1_same}
    return res, err, ek


def _lowered(fresh, cfg):
    """The fresh lattice lowered to just above the floor and falling at 1
    unit/s, so the floor's restitution branch fires inside 16 substeps
    (the lattice itself, and its dropped count of 0, are unchanged)."""
    import torch

    pos = fresh.pos.clone()
    lim = cfg.bounds - cfg.radius
    pos[1] += (0.02 - lim) - float(pos[1].min())
    vel = torch.zeros_like(fresh.vel)
    vel[1] = -1.0
    return fresh._replace(pos=pos, vel=vel)


def _gr_grads(state, cfg, n, wp, wv):
    """Gradients of sum(pos * wp) + sum(vel * wv) after
    ``granular.multi_step_diff`` with respect to pos, vel, dt, k_contact,
    gravity and restitution, and the output state."""
    import torch

    from wgpu_physics_engine_torch.core.state import ParticleState
    from wgpu_physics_engine_torch.models import granular

    dev = state.pos.device
    leaves = [state.pos.detach().clone(), state.vel.detach().clone()] + [
        torch.tensor(v, dtype=torch.float32, device=dev)
        for v in (GR_DT, cfg.k_contact, cfg.gravity, cfg.restitution)]
    for t in leaves:
        t.requires_grad_(True)
    out = granular.multi_step_diff(
        ParticleState(pos=leaves[0], vel=leaves[1]), cfg, leaves[2], n,
        k_contact=leaves[3], gravity=leaves[4], restitution=leaves[5])
    loss = (out.pos * wp).sum() + (out.vel * wv).sum()
    names = ("pos", "vel", "dt", "k_contact", "gravity", "restitution")
    grads = torch.autograd.grad(loss, leaves)
    return dict(zip(names, grads)), ParticleState(pos=out.pos.detach(),
                                                  vel=out.vel.detach())


def _phase16(fresh, dev, card):
    """Phase 16: the granular gradient path at 1M, counted, against the
    production path and against itself with the plain K11 and K12; then
    the example's fit on the card."""
    import numpy as np
    import torch

    from wgpu_physics_engine_torch.examples import inverse_granular as ig
    from wgpu_physics_engine_torch.models import granular
    from wgpu_physics_engine_torch.ops import granular_kernel as gk

    cfg = _gr_configs()["default"]
    st = _lowered(fresh, cfg)
    prod, d = granular.multi_step(st, cfg, GR_DT, GR_DIFF_STEPS,
                                  return_stats=True)
    rng = np.random.default_rng(16)
    wp, wv = (torch.tensor(rng.standard_normal((3, GR_N)).astype(np.float32),
                           device=dev) for _ in range(2))
    torch.cuda.synchronize()
    gk.LAUNCHES_FORCES = 0
    gk.LAUNCHES_JVP = 0
    t0 = time.perf_counter()
    grads, out = _gr_grads(st, cfg, GR_DIFF_STEPS, wp, wv)
    torch.cuda.synchronize()
    vg_s = time.perf_counter() - t0
    launches = {"granular_forces": gk.LAUNCHES_FORCES,
                "granular_force_jvp": gk.LAUNCHES_JVP}
    ep = _maxdiff(out.pos, prod.pos)
    ev = _maxdiff(out.vel, prod.vel)
    with _plain_kernels():
        ref, _ = _gr_grads(st, cfg, GR_DIFF_STEPS, wp, wv)
    rel = {k: _max_rel(grads[k], ref[k]) for k in grads}
    mags = {k: float(g.abs().max()) for k, g in grads.items()}
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    print(f"phase 16 granular multi_step_diff @{GR_N}, default configuration, "
          f"{GR_DIFF_STEPS} substeps at 240 Hz, the lattice lowered to the "
          f"floor [{card}]: dropped {int(d)}; value_and_grad {vg_s:.3f} s "
          f"host clock (first call); launches {launches}; primal vs "
          f"multi_step pos {ep:.3e} (<=5e-7) vel {ev:.3e} (<=5e-6); "
          f"gradients finite {finite}, max |g| {mags}; vs the plain K11/K12 "
          f"max-relative {rel} (<=1e-4)")
    _check(int(d) == 0, f"granular diff: dropped {int(d)}")
    _check(launches == {"granular_forces": 2 * GR_DIFF_STEPS,
                        "granular_force_jvp": GR_DIFF_STEPS},
           f"granular diff launches {launches}")
    _check(ep <= 5e-7 and ev <= 5e-6, f"granular diff primal {ep} {ev}")
    _check(finite and all(m > 0 for m in mags.values()),
           f"granular gradients not finite or zero: {mags}")
    _check(all(r <= 1e-4 for r in rel.values()),
           f"granular gradients vs plain: {rel}")
    res = {"dropped": int(d), "launches": launches, "err_primal_pos": ep,
           "err_primal_vel": ev, "grad_max": mags, "rel_vs_plain": rel,
           "value_and_grad_first_s": vg_s}

    config, state, target, true, n_steps = ig.make_problem(device=dev)
    losses = []
    t0 = time.perf_counter()
    fitted = ig.fit(config, state, target, true, n_steps, n_iters=FIT_ITERS,
                    verbose=False, losses=losses)
    fit_s = time.perf_counter() - t0
    rec = {k: (float(fitted[k]), float(true[k])) for k in fitted}
    print(f"phase 16 examples/inverse_granular.py on the card [{card}]: "
          f"{FIT_ITERS} Adam iterations in {fit_s:.2f} s, loss "
          f"{losses[0]:.4e} -> {losses[-1]:.4e} "
          f"({losses[0] / max(losses[-1], 1e-30):.1f}x, >=10x); recovered vs "
          f"true {rec}")
    _check(all(np.isfinite(losses)), "inverse_granular loss not finite")
    _check(losses[-1] * 10.0 <= losses[0],
           f"inverse_granular loss fell only {losses[0]} -> {losses[-1]}")
    res["fit"] = {"iters": FIT_ITERS, "s": fit_s, "loss_first": losses[0],
                  "loss_last": losses[-1], "recovered_vs_true": rec}
    return res


def _sc_grads(state, params, n, wp, wv):
    """Gradients of sum(pos * wp) + sum(vel * wv) after
    ``multi_step_self_collide_diff`` (rebuild every 8, block 256, slab
    640) with respect to pos, vel, dt and every ClothParams leaf."""
    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import ClothParams
    from wgpu_physics_engine_torch.models import cloth, scenes

    h, w = state.pos.shape[-2:]
    c = ClothConfig(height=h, width=w)
    spec = cloth.default_self_collision_grid(c, skin=2.0 * c.particle_radius)
    leaves = [a.detach().clone().requires_grad_(True) for a in params]
    pos, vel = (a.detach().clone().requires_grad_(True)
                for a in (state.pos, state.vel))
    dt = torch.tensor(DT, device=pos.device, requires_grad=True)
    out = cloth.multi_step_self_collide_diff(
        state._replace(pos=pos, vel=vel), ClothParams(*leaves), dt, n, spec,
        rebuild_every=SC_REBUILD, pallas_block=SC_BLOCK,
        pallas_slab=scenes.SELF_COLLIDE_SLAB)
    loss = (out.pos * wp).sum() + (out.vel * wv).sum()
    names = ["pos", "vel", "dt", *ClothParams._fields]
    return dict(zip(names, torch.autograd.grad(loss, [pos, vel, dt,
                                                      *leaves])))


def _phase17(dev, card, cli_main):
    """Phase 17: the self-collision path, counted: ClothScene 256² with
    self_collide, simulate 2 s, a frame and the CLI; the checks; then the
    differentiable path against its plain versions."""
    import numpy as np
    import torch
    from PIL import Image

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import init_cloth_state
    from wgpu_physics_engine_torch.models import cloth, scenes
    from wgpu_physics_engine_torch.ops import cloth_kernel, raster_kernel
    from wgpu_physics_engine_torch.ops import granular_kernel as gk
    from wgpu_physics_engine_torch.utils import viewer

    cfg = ClothConfig(height=GRID, width=GRID)
    fh, fw = FRAME
    png = os.path.join(OUT, "cloth_self_collide_cli.png")
    scene = scenes.ClothScene(cfg, self_collide=True, device=dev)
    scene.resize(fw, fh)
    torch.cuda.synchronize()
    gk.LAUNCHES_FORCES = 0
    cloth_kernel.LAUNCHES_FORCE = 0
    raster_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    scene.simulate(SC_SECONDS)
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    img = scene.render(fh, fw)
    rc = cli_main(["cloth", "--self-collide", "--grid", str(GRID), "--size",
                   str(fh), str(fw), "--seconds", str(SC_CLI_SECONDS),
                   "--out", png, "--device", "cuda"])
    torch.cuda.synchronize()
    launches = {"granular_forces": gk.LAUNCHES_FORCES,
                "cloth_step_force": cloth_kernel.LAUNCHES_FORCE,
                "sphere_raster": raster_kernel.LAUNCHES}
    substeps = round(SC_SECONDS * HZ) + round(SC_CLI_SECONDS * HZ)
    print(f"phase 17 self-collision main path [{card}]: ClothScene({GRID}x"
          f"{GRID}, self_collide=True) simulate({SC_SECONDS}) {sim_s:.3f} s "
          f"host clock ({round(SC_SECONDS * HZ)} substeps, rebuild every "
          f"{SC_REBUILD}) + render{FRAME} + CLI --self-collide --seconds "
          f"{SC_CLI_SECONDS} (rc {rc}); launches {launches}, substeps "
          f"{substeps}")
    _check(rc == 0, f"self-collide CLI returned {rc}")
    _check(launches["granular_forces"] == substeps
           and launches["cloth_step_force"] == substeps,
           f"self-collision launches {launches}, not {substeps} each")
    viewer.save_png(img, os.path.join(OUT, "cloth_self_collide.png"))

    again, d = cloth.multi_step_self_collide(
        init_cloth_state(cfg, device=dev), scene.params, DT,
        round(SC_SECONDS * HZ), scene._sc_grid, rebuild_every=SC_REBUILD,
        pallas_slab=scenes.SELF_COLLIDE_SLAB, return_stats=True)
    same = bool(torch.equal(again.pos, scene.state.pos))
    pos = scene.state.pos
    finite = bool(torch.isfinite(pos).all()
                  and torch.isfinite(scene.state.vel).all())
    r_min = float(torch.linalg.norm(pos, dim=0).min())
    r_lim = cfg.globe_radius + cfg.particle_radius - 1e-3
    t_img = torch.from_numpy(img)
    red = int((t_img == torch.tensor([1.0, 0.0, 0.0])).all(-1).sum())
    n_bg = int(((t_img - torch.tensor([0.05, 0.05, 0.08])).abs().amax(-1)
                < 1e-6).sum())
    globe = fh * fw - red - n_bg
    cli = np.asarray(Image.open(png).convert("RGB")) if os.path.exists(
        png) else np.zeros((1, 1, 3), np.uint8)
    cli_red = int((cli == [255, 0, 0]).all(-1).sum())
    print(f"phase 17 cloth: finite {finite}, r_min {r_min:.5f} (>= "
          f"{r_lim:.5f}), dropped over the scene's schedule {int(d)} (the "
          f"stats run equals the scene bit for bit: {same}); frame particle "
          f"px {red}, globe px {globe}; CLI png particle px {cli_red}")
    _check(finite, "self-colliding cloth not finite")
    _check(r_min >= r_lim, f"self-colliding cloth inside the globe: {r_min}")
    _check(int(d) == 0, f"self-collision dropped {int(d)} window entries")
    _check(same, "the stats run differs from the scene's run")
    _check(red > 100 and globe > 100, f"frame lacks globe/particles: {red} "
           f"{globe}")
    _check(cli_red > 100, f"self-collide CLI png lacks particles: {cli_red}")
    res = {"launches": launches, "substeps": substeps, "simulate_s": sim_s,
           "r_min": r_min, "dropped": int(d), "particle_px": red,
           "globe_px": globe, "cli_particle_px": cli_red}
    res["raster"] = _raster_site(
        scene.camera(), scene.state.pos.reshape(3, -1).T,
        float(scene.params.particle_radius), fh, fw, "the self-collision "
        "frame", card)

    # one rebuild block of the scene's schedule on its state: K1f's sorted
    # entry against its plain version inside the block, K11 the same
    blk_args = (scene.state, scene.params, DT, SC_REBUILD, scene._sc_grid,
                SC_BLOCK, scenes.SELF_COLLIDE_SLAB)
    f0 = cloth_kernel.LAUNCHES_FORCE
    kb, _ = cloth._self_collide_block(*blk_args)
    torch.cuda.synchronize()
    blk_launches = cloth_kernel.LAUNCHES_FORCE - f0
    with _k1f_sorted_plain():
        pb, _ = cloth._self_collide_block(*blk_args)
    blk_same = bool(torch.equal(kb.pos, pb.pos) and torch.equal(kb.vel,
                                                                pb.vel))
    print(f"phase 17 one rebuild block ({SC_REBUILD} substeps) on the "
          f"scene's state [{card}]: K1f's sorted entry vs its plain version "
          f"in the block bitwise {blk_same}; K1f launches {blk_launches}")
    _check(blk_same, "the block on K1f differs from its plain version")
    _check(blk_launches == SC_REBUILD,
           f"the block launched K1f {blk_launches} times")
    res["block_k1f_bitwise"] = blk_same

    rng = np.random.default_rng(17)
    wp, wv = (torch.tensor(rng.standard_normal((3, GRID, GRID)).astype(
        np.float32), device=dev) for _ in range(2))
    got = _sc_grads(scene.state, scene.params, SC_DIFF_STEPS, wp, wv)
    with _plain_kernels():
        ref = _sc_grads(scene.state, scene.params, SC_DIFF_STEPS, wp, wv)
    rel = {k: (_max_rel(got[k], ref[k]) if float(ref[k].abs().max()) > 0
               else float(got[k].abs().max())) for k in got}
    finite = all(bool(torch.isfinite(g).all()) for g in got.values())
    print(f"phase 17 multi_step_self_collide_diff @{GRID}x{GRID}, "
          f"{SC_DIFF_STEPS} substeps, rebuild every {SC_REBUILD} [{card}]: "
          f"finite {finite}; kernels vs plain versions max-relative {rel} "
          f"(<=1e-4; an exact zero on both sides reads 0)")
    _check(finite, "self-collision gradients not finite")
    _check(all(r <= 1e-4 for r in rel.values()),
           f"self-collision gradients vs plain: {rel}")
    _check(float(got["k_contact"].abs().max()) > 0
           and float(got["particle_radius"].abs().max()) > 0,
           "no gradient through the self-contact kernel")
    res["diff_rel_vs_plain"] = rel
    return res, scene.state, scene.params


def _is_k12(name: str) -> bool:
    """Whether a traced kernel is K12: ``granular_forces_kernel<JVP, L,
    STAGE>`` with JVP true (its first template argument)."""
    _, _, args = name.partition("granular_forces_kernel<")
    return args.startswith("true")


def _is_k11(name: str) -> bool:
    return "granular_forces_kernel<" in name and not _is_k12(name)


def _trace_split(fn, path, kernels: dict, range_name: str):
    """One torch.profiler trace of ``fn``: device time split into the
    named kernels (``kernels`` maps a name to a test of the device op's
    name), the device ops issued
    inside the user range ``range_name`` ("rebuild") and the rest
    ("other"), with the window and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation"
              and e["name"] == range_name]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    split = {k: 0.0 for k in kernels}
    counts = {k: 0 for k in kernels}
    split.update(rebuild=0.0, other=0.0)
    rebuild_ops = 0
    for e in dev:
        key = next((k for k, test in kernels.items() if test(e["name"])),
                   None)
        if key is not None:
            split[key] += e["dur"]
            counts[key] += 1
            continue
        t = launch.get(e.get("args", {}).get("correlation"))
        if t is not None and any(a <= t <= b for a, b in ranges):
            split["rebuild"] += e["dur"]
            rebuild_ops += 1
        else:
            split["other"] += e["dur"]
    host = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") in ("cpu_op", "cuda_runtime", "user_annotation")]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    _check(bool(spans) and bool(host), f"trace {path}: no device/host spans")
    t0 = min(a for a, _ in host + spans)
    t1 = max(b for _, b in host + spans)
    busy = _union_us(spans)
    return {"window_us": t1 - t0, "device_busy_us": busy,
            "device_ops": len(dev), "split_us": split, "launches": counts,
            "rebuild_ops": rebuild_ops, "rebuilds": len(ranges),
            "idle_share": 1.0 - busy / (t1 - t0)}


def _contact_times(fresh, sc_state, params, dev, card) -> dict:
    """Phases 6 and 7 for the contact-gradient and self-collision paths:
    K11, K12 (1M, default configuration, fresh lattice) and K1f (256², the
    self-colliding cloth of phase 17, with its pair forces) a launch
    beside their plain
    versions and bounds; granular value_and_grad particle-steps/s at 1M;
    the counterpart of bench.py's self_collide_256; one trace each of a
    granular gradient segment and of a self-collision rebuild block."""
    import numpy as np
    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import init_cloth_state
    from wgpu_physics_engine_torch.models import (broadphase, cloth, granular,
                                                  scenes)
    from wgpu_physics_engine_torch.ops import cloth_kernel
    from wgpu_physics_engine_torch.ops import granular_kernel as gk

    def per_launch(fn):
        """CUDA events over REPS back-to-back launches (the device stays
        busy when a launch outlasts its host issue), best of 3."""
        return _best_ms(lambda: [fn() for _ in range(REPS)]) / REPS

    res = {}
    cfg = _gr_configs()["default"]
    n = GR_N
    grid, slabs, _ = granular.rebuild(fresh.pos, fresh.vel, cfg)
    prm = gk.kernel_params(cfg, GR_DT, dev)
    p = grid.sorted_pos
    u = torch.tensor(np.random.default_rng(6).standard_normal(
        (3, n)).astype(np.float32), device=dev)
    cand = gk.candidate_count(slabs, n)
    touch = gk.touching_count(p, prm, slabs)
    for name, k_fn, p_fn, nbytes, ops_touch in (
            ("granular_forces",
             lambda: gk.contact_forces_sorted_kernel(p, prm[0], prm[1], slabs),
             lambda: gk.contact_forces_sorted_plain(p, prm[0], prm[1], slabs),
             K11_BYTES, OPS_TOUCH),
            ("granular_force_jvp",
             lambda: gk.contact_force_jvp_sorted_kernel(p, u, prm[0], prm[1],
                                                        slabs),
             lambda: gk.contact_force_jvp_sorted_plain(p, u, prm[0], prm[1],
                                                       slabs),
             K12_BYTES, OPS_TOUCH + OPS_TOUCH_JVP)):
        k_ms = per_launch(k_fn)
        p_ms = _best_ms(p_fn)
        b_ms, b_by = _bound(nbytes * n, OPS_SLOT * cand + ops_touch * touch)
        res[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "candidates": cand, "touching": touch}
        print(f"phase 6 {name} @{n}, default configuration, fresh lattice "
              f"[{card}]: kernel {k_ms:.4f} ms a launch ({REPS} back to back), "
              f"plain {p_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}; {cand} candidate slots, {touch} "
              f"touching), kernel at {b_ms / k_ms:.4f} of the bound")

    sp, sslabs, md, kc, order, _ = _sc_structs(sc_state, params,
                                               scenes.SELF_COLLIDE_SLAB)
    h, w = sc_state.pos.shape[-2:]
    f_sorted = gk.contact_forces_sorted_kernel(sp, md, kc, sslabs)
    blk, sb = cloth_kernel.force_block(sc_state, params, DT,
                                       broadphase._inverse(order))
    host_ms = per_launch(lambda: cloth_kernel.substep_with_force_sorted_kernel(
        sb, blk, f_sorted))
    p_ms = _best_ms(lambda: cloth_kernel.substep_with_force_sorted_plain(
        sb, blk, f_sorted))
    # the sorted site's bytes: the state (48), the force plane (12), inv (4)
    # and the next sorted positions (12) a particle
    b_ms, b_by = _cloth_bound(h, w, 1, 1, extra_bytes=28.0, extra_ops=3.0)
    res["cloth_step_force"] = {"host_bound_ms": host_ms, "plain_ms": p_ms,
                               "bound_ms": b_ms, "bound_by": b_by}
    print(f"phase 6 cloth_step_force (K1f) sorted entry @{h}x{w} [{card}]: "
          f"{host_ms:.5f} ms a launch over {REPS} back to back (host bound: "
          f"the device time is the trace's, below), plain {p_ms:.4f} ms, "
          f"bound {b_ms:.6f} ms ({b_by}; 76 B a particle)")
    n_sc = h * w
    sc_ms = per_launch(lambda: gk.contact_forces_sorted_kernel(sp, md, kc,
                                                               sslabs))
    sc_plain = _best_ms(lambda: gk.contact_forces_sorted_plain(sp, md, kc,
                                                               sslabs))
    sc_prm = torch.stack([torch.as_tensor(md, dtype=torch.float32),
                          torch.as_tensor(kc, dtype=torch.float32)]).to(dev)
    sc_cand = gk.candidate_count(sslabs, n_sc)
    sc_touch = gk.touching_count(sp, sc_prm, sslabs)
    sb_ms, sb_by = _bound(K11_BYTES * n_sc,
                          OPS_SLOT * sc_cand + OPS_TOUCH * sc_touch)
    n_lanes, cta, _ = gk.walk_geometry(sslabs, n_sc,
                                       gk.resident_threads(dev))
    res["granular_forces_self_collide"] = {
        "ms": sc_ms, "plain_ms": sc_plain, "bound_ms": sb_ms,
        "bound_by": sb_by, "candidates": sc_cand, "touching": sc_touch,
        "lanes": n_lanes, "cta": cta}
    print(f"phase 6 granular_forces (K11) on the self-collision set of phase "
          f"17's cloth (thin, block {SC_BLOCK}, slab "
          f"{scenes.SELF_COLLIDE_SLAB}) @{n_sc} [{card}]: kernel "
          f"{sc_ms:.5f} ms a launch ({REPS} back to back; {n_lanes} lanes "
          f"a slot, {cta} slots a CTA), plain {sc_plain:.4f} "
          f"ms, bound {sb_ms:.5f} ms ({sb_by}; {sc_cand} candidate slots, "
          f"{sc_touch} touching), kernel at {sb_ms / sc_ms:.4f} of the "
          f"bound")

    st = _lowered(fresh, cfg)
    rng = np.random.default_rng(16)
    wp, wv = (torch.tensor(rng.standard_normal((3, n)).astype(np.float32),
                           device=dev) for _ in range(2))
    ts = []
    for i in range(4):                         # a warm-up, then best of 3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _gr_grads(st, cfg, GR_DIFF_STEPS, wp, wv)
        torch.cuda.synchronize()
        if i:
            ts.append(time.perf_counter() - t0)
    rate = n * GR_DIFF_STEPS / min(ts)
    res["granular_value_and_grad"] = {"substeps": GR_DIFF_STEPS, "s": ts,
                                      "psteps_per_s": rate}
    print(f"phase 6 granular value_and_grad @{n}, {GR_DIFF_STEPS} substeps "
          f"(2 segments) [{card}]: best {min(ts) * 1e3:.3f} ms of "
          f"{', '.join(f'{t * 1e3:.3f}' for t in ts)} (host clock) = "
          f"{rate:.4e} particle-steps/s")

    c = ClothConfig(height=GRID, width=GRID)
    spec = cloth.default_self_collision_grid(c, skin=0.5 * c.particle_radius)
    s0 = init_cloth_state(c, device=dev)
    ts = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cloth.multi_step_self_collide(s0, params, DT, SC_BENCH_STEPS, spec,
                                      rebuild_every=32, pallas_slab=640)
        torch.cuda.synchronize()
        if i:
            ts.append(time.perf_counter() - t0)
    rate = GRID * GRID * SC_BENCH_STEPS / min(ts)
    res["self_collide_256"] = {"substeps": SC_BENCH_STEPS, "s": ts,
                               "psteps_per_s": rate}
    print(f"phase 6 self_collide_256 ({GRID}x{GRID}, {SC_BENCH_STEPS} "
          f"substeps, rebuild every 32, slab 640, skin 0.5 r) [{card}]: best "
          f"{min(ts) * 1e3:.3f} ms of {', '.join(f'{t * 1e3:.3f}' for t in ts)}"
          f" (host clock) = {rate:.4e} particle-steps/s")

    seg = cfg.rebuild_every
    tr = _trace_split(lambda: _gr_grads(st, cfg, seg, wp, wv),
                      os.path.join(OUT, "trace_granular_grad_segment.json"),
                      {"k11": _is_k11, "k12": _is_k12},
                      "granular.rebuild")
    res["trace_grad_segment"] = tr
    print(f"phase 7 trace one granular gradient segment (value_and_grad, "
          f"{seg} substeps) @{n} [{card}]: window {tr['window_us']:.1f} us "
          f"(host, profiled), device busy {tr['device_busy_us']:.1f} us in "
          f"{tr['device_ops']} device ops; device us "
          + ", ".join(f"{k} {v:.1f}" for k, v in tr["split_us"].items())
          + f" (launches {tr['launches']}, {tr['rebuilds']} rebuilds of "
          f"{tr['rebuild_ops']} device ops; 'other' is the integrate, its "
          f"autograd transpose and the gathers); device idle share "
          f"{tr['idle_share']:.4f}")
    _check(tr["launches"] == {"k11": 2 * seg, "k12": seg},
           f"gradient trace launches {tr['launches']}")

    sgrid = cloth.default_self_collision_grid(c, skin=2.0 * c.particle_radius)

    def block():
        return cloth._self_collide_block(sc_state, params, DT, SC_REBUILD,
                                         sgrid, SC_BLOCK,
                                         scenes.SELF_COLLIDE_SLAB)

    blk_ms = _best_ms(block)
    blk_host = _best_s(block) * 1e3
    tr = _trace_split(
        block, os.path.join(OUT, "trace_self_collide_block.json"),
        {"k11": _is_k11, "k1f": lambda name: "force_kernel" in name},
        "cloth.self_collide.rebuild")
    res["trace_self_collide_block"] = tr
    print(f"phase 7 trace one self-collision rebuild block ({SC_REBUILD} "
          f"substeps) @{GRID}x{GRID}, phase 17's cloth [{card}]: window "
          f"{tr['window_us']:.1f} us (host, profiled), device busy "
          f"{tr['device_busy_us']:.1f} us in {tr['device_ops']} device ops; "
          f"device us " + ", ".join(f"{k} {v:.1f}"
                                   for k, v in tr["split_us"].items())
          + f" (launches {tr['launches']}; 'other' is what the block issues "
          f"outside the rebuild, K11 and K1f: K11's parameter pair a "
          f"substep); device idle share {tr['idle_share']:.4f}")
    _check(tr["launches"] == {"k11": SC_REBUILD, "k1f": SC_REBUILD},
           f"self-collision trace launches {tr['launches']}")
    k1f = res["cloth_step_force"]
    k1f["ms"] = tr["split_us"]["k1f"] / SC_REBUILD / 1e3
    k1f["block_ms"], k1f["block_host_ms"] = blk_ms, blk_host
    print(f"phase 6 cloth_step_force (K1f) @{h}x{w} [{card}]: "
          f"{k1f['ms']:.6f} ms of device time a launch (the trace), bound "
          f"{k1f['bound_ms']:.6f} ms, kernel at "
          f"{k1f['bound_ms'] / k1f['ms']:.4f} of the bound; one rebuild "
          f"block of {SC_REBUILD} substeps {blk_ms:.4f} ms (CUDA events, "
          f"best of 3), {blk_host:.4f} ms host clock (best of 5)")
    return res


# ---------------------------------------------------------------------------
# The free-particle box and the mesh scenes (phases 18-19)
# ---------------------------------------------------------------------------

def _u8(img):
    import numpy as np

    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.int16)


def _trace_frame(fn, path, kernel: str = "") -> dict:
    """One ``torch.profiler`` trace of ``fn`` (a frame): the host window,
    the device's busy time and op count, its idle share, and the device
    time and count of the kernels whose name holds ``kernel``."""
    dev, host = _trace(fn, path)
    t0 = min([a for a, _ in host] + [a for a, _, _ in dev])
    t1 = max([b for _, b in host] + [b for _, b, _ in dev])
    busy = _union_us([(a, b) for a, b, _ in dev])
    ks = [b - a for a, b, name in dev if kernel and kernel in name]
    return {"window_us": t1 - t0, "device_busy_us": busy,
            "device_ops": len(dev), "idle_share": 1.0 - busy / (t1 - t0),
            "kernel_us": sum(ks), "kernel_launches": len(ks)}


def _k4_case(cam, centers, radius, label: str, card) -> dict:
    """K4 on one frame of ``PT_FRAME``: against its plain version and
    against the tiled kernel (winners mapped back to instance ids), both
    bit for bit with hits above zero; then the times (CUDA events, best of
    3) of K4 alone and with its prologue, of the plain version and of the
    tiled kernel alone and with its prologue, and K4's bound: the rays in,
    the two planes out and the table (bytes), or OPS_RAY_SPHERE operations
    on every (pixel, instance) pair (the sweep has no early exit)."""
    import torch

    from wgpu_physics_engine_torch.ops import raster_kernel as rk
    from wgpu_physics_engine_torch.render import camera as cam_mod

    h, w = PT_FRAME
    eye, dirs = cam_mod.pixel_rays(cam, h, w)
    n = centers.shape[0]
    zn = cam.znear
    rot, tan_half = cam.view[:3, :3], torch.tan(cam.fovy_rad / 2.0)
    ocb = rk.untiled_prologue(eye, centers, radius)
    kt, ki = rk.sphere_raster_untiled_kernel(ocb, dirs, zn)
    pt, pi = rk.sphere_raster_untiled_plain(ocb, dirs, zn)
    wins, tocb, order, rect = rk.tiled_prologue(rot, eye, centers, radius,
                                                zn, tan_half, cam.aspect, h, w)
    tt, ti, to = rk.sphere_raster_kernel(wins, tocb, rect, dirs, zn)
    sweep_eq = all(torch.equal(a, b) for a, b in zip(
        (tt, ti, to), rk.sphere_raster_plain(tocb, dirs, zn)))
    torch.cuda.synchronize()
    ids = torch.where(ti >= 0, order[ti.clamp_min(0).long()], -1)
    hits = int((ki >= 0).sum())
    both = (ki >= 0) & (pi >= 0)
    err = _maxdiff(kt[both], pt[both]) if bool(both.any()) else 0.0
    plain_eq = bool(torch.equal(ki, pi) and torch.equal(kt, pt))
    tiled_eq = bool(torch.equal(ids, ki) and torch.equal(tt, kt))
    print(f"{label}: hits {hits}, K4 vs plain bitwise {plain_eq} (tmin "
          f"{err:.3e}, winners differ on {int((ki != pi).sum())} px), K4 vs "
          f"the tiled kernel bitwise {tiled_eq} (winners differ on "
          f"{int((ids != ki).sum())} px), the tiled kernel vs the full "
          f"sweep bitwise {sweep_eq}")
    _check(hits > 0, f"{label}: no hit")
    _check(plain_eq, f"{label}: K4 differs from its plain version")
    _check(tiled_eq, f"{label}: K4 differs from the tiled kernel")
    _check(sweep_eq, f"{label}: the tiled kernel differs from the sweep")

    ms = _best_ms(lambda: rk.sphere_raster_untiled_kernel(ocb, dirs, zn))
    ms_pro = _best_ms(lambda: rk.sphere_raster_untiled(eye, dirs, centers,
                                                       radius, zn))
    plain_ms = _best_ms(lambda: rk.sphere_raster_untiled_plain(ocb, dirs, zn))
    tiled_ms = _best_ms(lambda: rk.sphere_raster_kernel(wins, tocb, rect,
                                                        dirs, zn))
    tiled_pro = _best_ms(lambda: rk.sphere_raster_tiled(
        rot, eye, dirs, centers, radius, zn, tan_half, cam.aspect))
    p = h * w
    disc_pairs = _disc_pairs(ocb, dirs)
    nbytes = 3 * p * 4 + 2 * p * 4 + 16 * n
    bound, by = _bound(nbytes, float(p) * n * OPS_DISC + OPS_HIT * disc_pairs)
    old_bound, old_by = _bound(nbytes, float(p) * n * OPS_RAY_SPHERE)
    print(f"phase 6 sphere_raster_untiled (K4) @{h}x{w}, {n} instances "
          f"[{card}]: kernel {ms:.5f} ms ({ms_pro:.5f} with its prologue), "
          f"plain {plain_ms:.5f} ms, bound {bound:.5f} ms ({by}; {OPS_DISC} "
          f"operations on each of {p * n} pairs and {OPS_HIT} more on the "
          f"{disc_pairs} with disc > 0; counted as {OPS_RAY_SPHERE} on every "
          f"pair before: {old_bound:.5f} ms, {old_by}), kernel at "
          f"{bound / ms:.4f} of the bound; the tiled kernel (K2/K3) on the "
          f"same frame {tiled_ms:.5f} ms ({tiled_pro:.5f} with its "
          f"prologue)")
    return {"n": n, "hits": hits, "bitwise_plain": plain_eq,
            "bitwise_tiled": tiled_eq, "bitwise_tiled_sweep": sweep_eq,
            "err_tmin": err, "ms": ms,
            "ms_with_prologue": ms_pro, "plain_ms": plain_ms,
            "tiled_ms": tiled_ms, "tiled_ms_with_prologue": tiled_pro,
            "bound_ms": bound, "bound_by": by, "disc_pairs": disc_pairs,
            "old_bound_ms": old_bound}


def _disc_pairs(ocb, dirs) -> int:
    """The (pixel, instance) pairs of K4's sweep with disc > 0, counted in
    torch on the card (the same b and disc expressions, in chunks)."""
    d = dirs.reshape(3, -1)
    cnt = 0
    for k0 in range(0, ocb.shape[1], 256):
        o = ocb[:, k0:k0 + 256]
        b = d[0][:, None] * o[0] + d[1][:, None] * o[1] + d[2][:, None] * o[2]
        cnt += int(((b * b - o[3]) > 0.0).sum())
    return cnt


def _k4_ragged(cam, centers, radius, label: str, card) -> bool:
    """K4 against its plain version bit for bit on a frame of 601x799,
    whose planes (h·w not a multiple of 4) take the kernel's scalar
    accesses."""
    import torch

    from wgpu_physics_engine_torch.ops import raster_kernel as rk
    from wgpu_physics_engine_torch.render import camera as cam_mod

    h, w = PT_FRAME[0] + 1, PT_FRAME[1] - 1
    eye, dirs = cam_mod.pixel_rays(cam, h, w)
    ocb = rk.untiled_prologue(eye, centers, radius)
    kt, ki = rk.sphere_raster_untiled_kernel(ocb, dirs, cam.znear)
    pt, pi = rk.sphere_raster_untiled_plain(ocb, dirs, cam.znear)
    eq = bool(torch.equal(kt, pt) and torch.equal(ki, pi))
    hits = int((ki >= 0).sum())
    print(f"{label} @{h}x{w}: hits {hits}, K4 vs plain bitwise {eq}")
    _check(eq and hits > 0, f"{label} @{h}x{w}: K4 differs from its plain "
           f"version ({eq}, hits {hits})")
    return eq


def _phase18_particles(dev, card, cli_main) -> dict:
    """Phase 18: the free-particle box. The main path, counted: two
    ``FreeParticleScene``s (documented-correct and ``bug_compat``),
    ``simulate(3.0)`` and a 600x800 frame each, the ``particles`` CLI at
    600x800 (K4) and at its default 256x256 (the tiled kernel); then K4
    against its plain version and the tiled kernel on the scene's frame
    and on MAX_INSTANCES spheres, the frames against the CPU's, and the
    times."""
    import numpy as np
    import torch
    from PIL import Image

    from wgpu_physics_engine_torch.core.config import FreeParticleConfig
    from wgpu_physics_engine_torch.core.state import ParticleState
    from wgpu_physics_engine_torch.models.scenes import FreeParticleScene
    from wgpu_physics_engine_torch.ops import raster_kernel as rk
    from wgpu_physics_engine_torch.utils import viewer

    fh, fw = PT_FRAME
    bg = np.asarray([0.05, 0.05, 0.08], np.float32)
    png = os.path.join(OUT, "particles_cli.png")
    png256 = os.path.join(OUT, "particles_cli_256.png")
    modes = {"correct": False, "bug_compat": True}
    sc = {k: FreeParticleScene(FreeParticleConfig(bug_compat=m), seed=PT_SEED,
                               device=dev) for k, m in modes.items()}
    torch.cuda.synchronize()
    rk.LAUNCHES = 0
    rk.LAUNCHES_UNTILED = 0
    imgs, per_frame = {}, {}
    for k, scene in sc.items():
        scene.simulate(PT_SECONDS)
        u0 = rk.LAUNCHES_UNTILED
        imgs[k] = scene.render(fh, fw)
        per_frame[k] = rk.LAUNCHES_UNTILED - u0
    u0, t0 = rk.LAUNCHES_UNTILED, rk.LAUNCHES
    rc = cli_main(["particles", "--size", str(fh), str(fw), "--out", png,
                   "--device", "cuda"])
    cli = (rk.LAUNCHES_UNTILED - u0, rk.LAUNCHES - t0)
    u0, t0 = rk.LAUNCHES_UNTILED, rk.LAUNCHES
    rc256 = cli_main(["particles", "--out", png256, "--device", "cuda"])
    cli256 = (rk.LAUNCHES_UNTILED - u0, rk.LAUNCHES - t0)
    torch.cuda.synchronize()
    launches = {"sphere_raster_untiled": rk.LAUNCHES_UNTILED,
                "sphere_raster": rk.LAUNCHES}
    print(f"phase 18 free-particle main path [{card}]: FreeParticleScene x 2 "
          f"(correct, bug_compat) simulate({PT_SECONDS}) + render{PT_FRAME} "
          f"(K4 launches a frame {per_frame}) + CLI particles --size {fh} "
          f"{fw} (rc {rc}; K4, tiled launches {cli}) + CLI particles at 256x256 "
          f"(rc {rc256}; K4, tiled launches {cli256}); launches {launches}")
    _check(rc == 0 and rc256 == 0, f"particles CLI returned {rc} {rc256}")
    _check(all(v == 1 for v in per_frame.values()),
           f"a {fh}x{fw} frame launched K4 {per_frame} times, not once")
    _check(cli == (1, 0), f"CLI at {fh}x{fw}: K4, tiled launches {cli}")
    _check(cli256 == (0, 1), f"CLI at 256x256: K4, tiled launches {cli256}")

    res = {"launches": launches, "per_frame": per_frame, "cli": cli,
           "cli256": cli256}
    for k, scene in sc.items():
        st = scene.state
        finite = bool(torch.isfinite(st.pos).all()
                      and torch.isfinite(st.vel).all())
        limit = float(scene.params.bounds - scene.params.radius)
        pmax = float(st.pos.abs().max())
        img = imgs[k]
        cpu = FreeParticleScene(FreeParticleConfig(bug_compat=modes[k]),
                                seed=PT_SEED, device="cpu")
        cpu.state = ParticleState(pos=st.pos.cpu(), vel=st.vel.cpu())
        ref = cpu.render(fh, fw)
        d = np.abs(_u8(img) - _u8(ref)).max(-1)
        within = float((d <= 1).mean())
        blue = int((img == [0.0, 0.0, 1.0]).all(-1).sum())
        sphere = int(((np.abs(img - bg).max(-1) > 1e-6)
                      & ~(img == [0.0, 0.0, 1.0]).all(-1)).sum())
        # within 1 in u8 but for rare pixels: at a sphere's pole u is
        # undefined and at a silhouette t is ill-conditioned, so an ulp of
        # CPU vs CUDA libm there moves the texture sample by texels
        print(f"phase 18 {k}: finite {finite}, max |pos| {pmax:.6f} (bounds "
              f"- radius {limit}), frame {fh}x{fw}: sphere px {sphere}, "
              f"wireframe px {blue}; vs the CPU frame from the same state: "
              f"u8 diff <= 1 on {within:.6f} of px (>= 0.999), max {d.max()}")
        _check(finite, f"{k}: particle state not finite")
        if not modes[k]:
            _check(pmax <= limit + 1e-5, f"{k}: a particle left the box")
        _check(sphere > 1e-3 * fh * fw and blue > 1e-3 * fh * fw,
               f"{k}: frame lacks spheres or wireframe: {sphere} {blue}")
        _check(within >= 0.999, f"{k}: frame vs CPU within 1 on {within}")
        viewer.save_png(img, os.path.join(OUT, f"particles_{k}.png"))
        res[k] = {"max_abs_pos": pmax, "sphere_px": sphere, "wire_px": blue,
                  "cpu_within_1": within, "cpu_max_diff": int(d.max())}
    cli_img = np.asarray(Image.open(png).convert("RGB"))
    _check(cli_img.shape == (fh, fw, 3)
           and int((cli_img == [0, 0, 255]).all(-1).sum()) > 1e-3 * fh * fw,
           "the CLI's PNG lacks the wireframe")

    scene = sc["correct"]
    cam = scene.camera()
    res["k4_scene"] = _k4_case(
        cam, scene.state.pos.T.contiguous(), float(scene.params.radius),
        f"phase 18 K4 @{fh}x{fw}, the scene's {scene.config.num_particles} "
        f"instances", card)
    lim = FreeParticleConfig().bounds - PT_MAX_RADIUS
    g = torch.Generator().manual_seed(PT_SEED)
    big = ((torch.rand((rk.MAX_INSTANCES, 3), generator=g) * 2.0 - 1.0)
           * lim).to(dev)
    res["k4_max"] = _k4_case(cam, big, PT_MAX_RADIUS,
                             f"phase 18 K4 @{fh}x{fw}, {rk.MAX_INSTANCES} "
                             f"instances of radius {PT_MAX_RADIUS}", card)
    res["k4_ragged"] = [
        _k4_ragged(cam, scene.state.pos.T.contiguous(),
                   float(scene.params.radius), "phase 18 K4, the scene's "
                   "instances", card),
        _k4_ragged(cam, big, PT_MAX_RADIUS, f"phase 18 K4, "
                   f"{rk.MAX_INSTANCES} instances", card)]
    res["frame_ms"] = _best_ms(lambda: scene.render(fh, fw))
    scene.resize(256, 256)                 # the CLI's default frame
    res["raster_cli"] = _raster_site(
        scene.camera(), scene.state.pos.T, float(scene.params.radius), 256,
        256, "the particles CLI's frame: the scene at 256x256", card)
    scene.resize(fw, fh)
    tr = _trace_frame(lambda: scene.render(fh, fw),
                      os.path.join(OUT, "trace_particles_frame.json"),
                      "sphere_raster_untiled")
    res["trace_frame"] = tr
    _check(tr["kernel_launches"] == 1,
           f"traced frame launched K4 {tr['kernel_launches']} times")
    # K4's device time a launch at the main path's shapes: CUDA events
    # around one call read the wrapper's host-side launch cost
    res["k4_scene"]["device_ms"] = tr["kernel_us"] / 1e3
    print(f"phase 6 FreeParticleScene frame {fh}x{fw} [{card}]: "
          f"{res['frame_ms']:.4f} ms (lines, K4 and its prologue, texture, "
          f"composite, copy to the host)")
    print(f"phase 7 trace one FreeParticleScene frame {fh}x{fw} [{card}]: "
          f"window {tr['window_us']:.1f} us (host, profiled), device busy "
          f"{tr['device_busy_us']:.1f} us in {tr['device_ops']} device ops, "
          f"K4 {tr['kernel_us']:.2f} us of device time (bound "
          f"{res['k4_scene']['bound_ms'] * 1e3:.2f} us); device idle share "
          f"{tr['idle_share']:.4f}")
    return res


def _phase19_meshes(dev, card, cli_main) -> dict:
    """Phase 19: the mesh scenes at 600x800 on the card: each against its
    CPU frame and showing geometry, its ms a frame; the tile-binned
    resolver against the brute one on the 16,128-triangle globe; the CLI's
    cube, textured and globe."""
    import numpy as np
    import torch
    from PIL import Image

    from wgpu_physics_engine_torch import render as R
    from wgpu_physics_engine_torch.models import scenes
    from wgpu_physics_engine_torch.utils import viewer

    fh, fw = MESH_FRAME
    bg = np.asarray([0.05, 0.05, 0.08], np.float32)
    makers = {
        "cube": lambda d: scenes.CubeScene(device=d),
        "textured": lambda d: scenes.TexturedCubeScene(device=d),
        "globe": lambda d: scenes.GlobeScene(device=d),
        "globe_mesh": lambda d: scenes.GlobeScene(use_mesh=True, device=d),
    }
    res = {}
    for name, make in makers.items():
        scene = make(dev)
        img = scene.render(fh, fw)
        ms = _best_ms(lambda: scene.render(fh, fw))
        t0 = time.perf_counter()
        ref = make("cpu").render(fh, fw)
        cpu_s = time.perf_counter() - t0
        d = np.abs(_u8(img) - _u8(ref)).max(-1)
        within = float((d <= 1).mean())
        geo = int((np.abs(img - bg).max(-1) > 1e-6).sum())
        print(f"phase 19 {name} @{fh}x{fw} [{card}]: {ms:.4f} ms a frame "
              f"(CUDA events, best of 3, with the copy to the host); "
              f"geometry px {geo}; vs the CPU frame ({cpu_s:.2f} s host "
              f"clock): u8 diff <= 1 on {within:.6f} of px (>= 0.999), max "
              f"{d.max()}")
        _check(np.isfinite(img).all(), f"{name}: frame not finite")
        _check(geo > 0.02 * fh * fw, f"{name}: only {geo} geometry pixels")
        _check(within >= 0.999, f"{name}: frame vs CPU within 1 on {within}")
        viewer.save_png(img, os.path.join(OUT, f"mesh_{name}.png"))
        res[name] = {"ms": ms, "geometry_px": geo, "cpu_within_1": within,
                     "cpu_max_diff": int(d.max())}

    scene = scenes.GlobeScene(use_mesh=True, device=dev)
    cam = scene.camera()
    n_tris = int(scene.mesh.tris.shape[0])

    def draw(binned):
        return R.draw_mesh(R.clear(fh, fw, device=dev), cam, scene.mesh,
                           texture=scene.texture, mode="phong",
                           light=scene.light, binned=binned,
                           return_stats=True)

    (brute, _), (tiled, dropped) = draw(False), draw(True)
    same = float(((tiled.color == brute.color).all(-1)
                  & (tiled.depth == brute.depth)).float().mean())
    brute_ms = _best_ms(lambda: draw(False))
    tiled_ms = _best_ms(lambda: draw(True))
    print(f"phase 19 draw_mesh binned vs brute, the globe mesh ({n_tris} "
          f"triangles) @{fh}x{fw} [{card}]: equal on {same:.6f} of px (>= "
          f"0.999), dropped {dropped}; brute {brute_ms:.4f} ms, binned "
          f"{tiled_ms:.4f} ms (CUDA events, best of 3)")
    _check(same >= 0.999, f"binned vs brute equal on {same}")
    _check(dropped == 0, f"binned globe dropped {dropped}")
    res["binned_vs_brute"] = {"tris": n_tris, "equal_share": same,
                              "dropped": dropped, "brute_ms": brute_ms,
                              "binned_ms": tiled_ms}

    for name in ("cube", "globe_mesh"):
        scene = makers[name](dev)
        tr = _trace_frame(lambda: scene.render(fh, fw),
                          os.path.join(OUT, f"trace_{name}_frame.json"))
        res[name]["trace"] = tr
        print(f"phase 7 trace one {name} frame {fh}x{fw} [{card}]: window "
              f"{tr['window_us']:.1f} us (host, profiled), device busy "
              f"{tr['device_busy_us']:.1f} us in {tr['device_ops']} device "
              f"ops; device idle share {tr['idle_share']:.4f}")

    for name in ("cube", "textured", "globe"):
        png = os.path.join(OUT, f"{name}_cli.png")
        rc = cli_main([name, "--size", str(fh), str(fw), "--out", png,
                       "--device", "cuda"])
        img = np.asarray(Image.open(png).convert("RGB")) / 255.0
        geo = int((np.abs(img - bg).max(-1) > 0.01).sum())
        print(f"phase 19 CLI {name} --size {fh} {fw} [{card}]: rc {rc}, "
              f"geometry px {geo}")
        _check(rc == 0 and geo > 0.02 * fh * fw,
               f"CLI {name}: rc {rc}, px {geo}")
        res[f"cli_{name}"] = {"rc": rc, "geometry_px": geo}
    torch.cuda.synchronize()
    return res


# ---------------------------------------------------------------------------
# Phase 20: the large-grid path (K6)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _route_on_k1():
    """Inside, ``cloth_kernel.multi_step`` sends every grid to K1 (the
    large-grid route is off), so a path runs as before K6."""
    from wgpu_physics_engine_torch.ops import cloth_kernel

    saved = cloth_kernel._TILED_PARTICLE_LIMIT
    cloth_kernel._TILED_PARTICLE_LIMIT = 1 << 62
    try:
        yield
    finally:
        cloth_kernel._TILED_PARTICLE_LIMIT = saved


def _contact_share(pos, params) -> float:
    """Share of particles within 1e-3 of the globe's contact distance."""
    import torch

    r = torch.linalg.vector_norm(pos, dim=0)
    md = float(params.globe_radius + params.particle_radius)
    return float((r < md + 1e-3).float().mean())


def _k6_states(h: int, w: int, dev):
    """The fresh state of an ``h × w`` cloth and the same cloth draped on
    the globe (LG_DRAPE substeps of K1), both with the top row pinned and
    one pin on the corner of the tile (1, 1) of the default schedule."""
    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.ops import cloth_kernel, cloth_tiled_kernel

    c = ClothConfig(height=h, width=w)
    params = ClothParams.from_config(c, device=dev)
    fresh = init_cloth_state(c, device=dev)
    draped = cloth_kernel.multi_step_kernel(fresh, params, DT, LG_DRAPE)

    tile = cloth_tiled_kernel.pick_schedule(h, w, LG_STEPS[0])[1:]

    def pinned(s):
        pin = torch.zeros((h, w), dtype=torch.bool, device=dev)
        pin[0] = True
        pin[min(h - 1, tile[0]), min(w - 1, tile[1])] = True
        return s._replace(pin_mask=pin, pin_pos=s.pos)

    return params, {"fresh": pinned(fresh), "draped": pinned(draped)}


def _k6_case(state, params, n: int, label: str, card,
             schedule=None) -> dict:
    """The large-grid kernels over ``n`` substeps against K6's plain
    version and against K1, bit for bit, with their launch counts: K6r
    (one launch, on ``resident_tile``'s tiles) where its tiles fit the
    card, and K6 (on ``schedule``, by default ``pick_schedule``'s, ⌈n / k⌉
    launches). Returns the results and the largest errors of K6 and K6r
    (None where K6r does not fit)."""
    import torch

    from wgpu_physics_engine_torch.ops import cloth_kernel, cloth_tiled_kernel

    ct = cloth_tiled_kernel
    h, w = state.pos.shape[-2:]
    sched = schedule or ct.pick_schedule(h, w, n)
    out, errs = {"schedule": list(sched)}, {}
    plain = ct.multi_step_plain(state, params, DT, n, schedule=schedule)
    k1 = cloth_kernel.multi_step_kernel(state, params, DT, n)
    runs = {"k6": (lambda: ct.multi_step_kernel(state, params, DT, n,
                                                schedule=schedule),
                   "LAUNCHES", -(-n // sched[0]))}
    if ct.resident_fits(h, w, state.pos.device):
        runs["k6r"] = (lambda: ct.multi_step_resident_kernel(state, params,
                                                             DT, n),
                       "LAUNCHES_RESIDENT", 1)
    got = {}
    for key, (fn, counter, expect) in runs.items():
        before = getattr(ct, counter)
        got[key] = fn()
        torch.cuda.synchronize()
        launches = getattr(ct, counter) - before
        err = max(_maxdiff(got[key].pos, plain.pos),
                  _maxdiff(got[key].vel, plain.vel))
        err_k1 = max(_maxdiff(got[key].pos, k1.pos),
                     _maxdiff(got[key].vel, k1.vel))
        eq_plain = bool(torch.equal(got[key].pos, plain.pos)
                        and torch.equal(got[key].vel, plain.vel))
        eq_k1 = bool(torch.equal(got[key].pos, k1.pos)
                     and torch.equal(got[key].vel, k1.vel))
        out[key] = {"launches": launches, "err_plain": err, "err_k1": err_k1,
                    "bitwise_plain": eq_plain, "bitwise_k1": eq_k1}
        errs[key] = err
        _check(launches == expect, f"{key} {label} {h}x{w}: {launches} "
               f"launches for {n} substeps, not {expect}")
        _check(eq_plain, f"{key} {label} {h}x{w} n={n}: differs from K6's "
               f"plain version by {err}")
        _check(eq_k1, f"{key} {label} {h}x{w} n={n}: differs from K1 by "
               f"{err_k1}")
        _check(bool(torch.isfinite(got[key].pos).all()),
               f"{key} {label}: not finite")
        _check(torch.equal(got[key].pos[:, 0], state.pos[:, 0]),
               f"{key} {label}: pinned row moved")
    if "k6r" in got:
        out["k6r"]["tile"] = list(ct.resident_tile(h, w, state.pos.device))
        out["k6r"]["bitwise_k6"] = bool(
            torch.equal(got["k6r"].pos, got["k6"].pos)
            and torch.equal(got["k6r"].vel, got["k6"].vel))
        _check(out["k6r"]["bitwise_k6"], f"K6r {label} {h}x{w}: not K6")
    contact = _contact_share(got["k6"].pos, params)
    out["contact_share"] = contact
    print(f"phase 20 cloth_tiled (K6) and cloth_tiled_resident (K6r) {label} "
          f"@{h}x{w}, {n} substeps, K6 schedule {sched} [{card}]: "
          + "; ".join(f"{k} launches {v['launches']}, bitwise vs plain "
                      f"{v['bitwise_plain']} and K1 {v['bitwise_k1']}"
                      for k, v in out.items() if k in runs)
          + (f", K6r tile {out['k6r']['tile']} == K6 "
             f"{out['k6r']['bitwise_k6']}" if "k6r" in out else
             ", K6r: no resident tiling fits")
          + f"; particles in contact {contact:.4f}")
    return out, errs.get("k6", 0.0), errs.get("k6r")


def _k6_checks(dev, card):
    """Phase 20, part 1: K6r and K6 against K6's plain version and K1 on
    each of LG_SHAPES (512², LG² and the ragged LG_RAGGED), fresh and
    draped, over each of LG_STEPS substeps; on the ragged shape K6 also
    with the schedules of LG_DEEP (k > 1); and K6 alone on LG_BIG, above
    K6r's reach. Returns the results and the largest errors of K6 and
    K6r."""
    res, err, err_r = {}, 0.0, 0.0
    for h, w in LG_SHAPES + (LG_BIG,):
        params, states = _k6_states(h, w, dev)
        for label, s in states.items():
            if (h, w) == LG_BIG and label == "draped":
                continue
            if label == "draped":
                share = _contact_share(s.pos, params)
                print(f"phase 20 draped state @{h}x{w}: particles in contact "
                      f"{share:.4f}")
                _check(share > 0, f"draped {h}x{w}: no particle in contact")
            for n in (LG_STEPS if (h, w) != LG_BIG else LG_STEPS[:1]):
                res[f"{h}x{w} {label} n={n}"], e, er = _k6_case(
                    s, params, n, label, card)
                err = max(err, e)
                if (h, w) == LG_BIG:
                    _check(er is None, f"K6r took {h}x{w}")
                else:
                    _check(er is not None, f"no K6r tiling of {h}x{w}")
                    err_r = max(err_r, er)
            if (h, w) == LG_RAGGED:
                # deeper temporal blocking than the default schedule's
                for sched in LG_DEEP:
                    res[f"{h}x{w} {label} n={LG_STEPS[-1]} {sched}"], e, _ = (
                        _k6_case(s, params, LG_STEPS[-1], label, card,
                                 sched))
                    err = max(err, e)
    return res, err, err_r


def _phase20(dev, card, cli_main) -> dict:
    """Phase 20, parts 2 and 3: the large-grid main path, counted:
    ``ClothScene`` at LG², ``simulate(LG_SECONDS)``, one frame of the
    scene's schedule (``update(1/60)``), a render, and the CLI's ``cloth
    --grid LG``; then ``multi_step_diff`` over one FIT_SEG segment, whose
    trace's last state (K1) must equal its forward (K6)."""
    import numpy as np
    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import ClothParams
    from wgpu_physics_engine_torch.models import cloth
    from wgpu_physics_engine_torch.models.scenes import ClothScene
    from wgpu_physics_engine_torch.ops import (cloth_grad_kernel, cloth_kernel,
                                               cloth_tiled_kernel,
                                               raster_kernel)
    from wgpu_physics_engine_torch.utils import viewer

    fh, fw = LG_FRAME
    cfg = ClothConfig(height=LG, width=LG)
    png = os.path.join(OUT, "cloth_1024_cli.png")
    n_sim = int(round(LG_SECONDS * cfg.hz))
    n_frame = cloth.frame_substeps(1.0 / 60.0, cfg.time_scale, cfg.hz,
                                   cfg.max_substeps)[0]
    n_cli = int(round(LG_CLI_SECONDS * cfg.hz))
    # simulate, the frame and the CLI: a call of K6r each
    expect = 3

    scene = ClothScene(cfg, device=dev)
    scene.resize(fw, fh)
    torch.cuda.synchronize()
    cloth_kernel.LAUNCHES = 0
    cloth_tiled_kernel.LAUNCHES = 0
    cloth_tiled_kernel.LAUNCHES_RESIDENT = 0
    raster_kernel.LAUNCHES = 0
    t0 = time.time()
    scene.simulate(LG_SECONDS)
    scene.update(1.0 / 60.0)
    torch.cuda.synchronize()
    sim_s = time.time() - t0
    img = scene.render(fh, fw)
    rc = cli_main(["cloth", "--grid", str(LG), "--size", str(fh), str(fw),
                   "--seconds", str(LG_CLI_SECONDS), "--out", png,
                   "--device", "cuda"])
    # a grid above K6r's reach takes K6
    big = ClothScene(ClothConfig(height=LG_BIG[0], width=LG_BIG[1]),
                     device=dev)
    big.simulate(LG_BIG_SECONDS)
    torch.cuda.synchronize()
    n_big = int(round(LG_BIG_SECONDS * cfg.hz))
    expect_k6 = -(-n_big // cloth_tiled_kernel.pick_schedule(*LG_BIG,
                                                             n_big)[0])
    big_finite = bool(torch.isfinite(big.state.pos).all())
    del big
    launches = {"cloth_tiled_resident": cloth_tiled_kernel.LAUNCHES_RESIDENT,
                "cloth_tiled": cloth_tiled_kernel.LAUNCHES,
                "cloth_step": cloth_kernel.LAUNCHES,
                "sphere_raster": raster_kernel.LAUNCHES}
    print(f"phase 20 main path: ClothScene {LG}x{LG} simulate({LG_SECONDS}) "
          f"+ update(1/60) ({n_sim} + {n_frame} substeps) {sim_s:.3f} s host "
          f"clock + render{LG_FRAME} + CLI cloth --grid {LG} --seconds "
          f"{LG_CLI_SECONDS} ({n_cli} substeps, rc {rc}) + ClothScene "
          f"{LG_BIG[0]}x{LG_BIG[1]} simulate({LG_BIG_SECONDS}) ({n_big} "
          f"substeps, finite {big_finite}); launches {launches}, K6r "
          f"expected {expect}, K6 {expect_k6}")
    _check(rc == 0, f"CLI cloth --grid {LG} returned {rc}")
    _check(launches["cloth_tiled_resident"] == expect,
           f"K6r launched {launches['cloth_tiled_resident']} times, not "
           f"{expect}")
    _check(launches["cloth_tiled"] == expect_k6,
           f"K6 launched {launches['cloth_tiled']} times, not {expect_k6} "
           f"(the {LG_BIG} scene)")
    _check(big_finite, f"the {LG_BIG} scene is not finite")
    _check(launches["cloth_step"] == 0,
           f"K1 launched {launches['cloth_step']} times on the large grid")
    _check(launches["sphere_raster"] > 0, "the raster never launched")
    _check(os.path.exists(png), "the CLI wrote no PNG")
    viewer.save_png(img, os.path.join(OUT, "cloth_1024.png"))

    pos = scene.state.pos
    finite = bool(torch.isfinite(pos).all())
    r_min = float(torch.linalg.vector_norm(pos, dim=0).min())
    md = cfg.globe_radius + cfg.particle_radius
    t_img = torch.from_numpy(img)
    red = int((t_img == torch.tensor([1.0, 0.0, 0.0])).all(-1).sum())
    bg = torch.tensor([0.05, 0.05, 0.08])
    n_bg = int(((t_img - bg).abs().amax(-1) < 1e-6).sum())
    globe = fh * fw - red - n_bg
    # the same scene with the route held on K1
    with _route_on_k1():
        ref = ClothScene(cfg, device=dev)
        ref.simulate(LG_SECONDS)
        ref.update(1.0 / 60.0)
    torch.cuda.synchronize()
    same = bool(torch.equal(scene.state.pos, ref.state.pos)
                and torch.equal(scene.state.vel, ref.state.vel))
    print(f"phase 20 state @{LG}x{LG}: finite {finite}, r_min {r_min:.5f} "
          f"(>= {md - 1e-3:.3f}), mean height {float(pos[1].mean()):.4f}; "
          f"image particle px {red}, globe px {globe}; end state == the "
          f"scene on K1 {same}")
    _check(finite, "large-grid state not finite")
    _check(r_min >= md - 1e-3, f"large-grid r_min {r_min} below {md - 1e-3}")
    _check(red > 100 and globe > 100,
           f"large-grid image lacks globe/particles: {red} {globe}")
    _check(same, "large-grid scene on K6r differs from the scene on K1")
    _check(bool(np.isfinite(img).all()), "large-grid image not finite")
    del ref
    raster = _raster_site(scene.camera(), pos.reshape(3, -1).T,
                          float(scene.params.particle_radius), fh, fw,
                          "the large-grid frame", card)

    # gradients: one segment at LG², the forward on K6r, the trace on K1
    params = ClothParams.from_config(cfg, device=dev)
    s0 = scene.state
    pin = torch.zeros((LG, LG), dtype=torch.bool, device=dev)
    pin[0] = True
    s0 = s0._replace(pin_mask=pin, pin_pos=s0.pos)
    g = torch.Generator().manual_seed(LG)
    wp, wv = (torch.randn((3, LG, LG), generator=g).to(dev) for _ in range(2))
    cloth_kernel.LAUNCHES = 0
    cloth_tiled_kernel.LAUNCHES = 0
    cloth_tiled_kernel.LAUNCHES_RESIDENT = 0
    cloth_grad_kernel.LAUNCHES = 0
    grads, out = _diff_grads(s0, params, FIT_SEG, FIT_SEG, wp, wv)
    torch.cuda.synchronize()
    g_launches = {"cloth_tiled_resident":
                  cloth_tiled_kernel.LAUNCHES_RESIDENT,
                  "cloth_tiled": cloth_tiled_kernel.LAUNCHES,
                  "cloth_step": cloth_kernel.LAUNCHES,
                  "cloth_substep_vjp": cloth_grad_kernel.LAUNCHES}
    prm = cloth_kernel._pack_params(params, DT).to(dev)
    traj = cloth_kernel.trace(s0, prm, FIT_SEG + 1)
    trace_ok = bool(torch.equal(traj[FIT_SEG, :3], out.pos)
                    and torch.equal(traj[FIT_SEG, 3:], out.vel))
    del traj
    finite_g = all(bool(torch.isfinite(v).all()) for v in grads.values())
    print(f"phase 20 multi_step_diff @{LG}x{LG}, {FIT_SEG} substeps (one "
          f"segment) [{card}]: launches {g_launches}; trace's last state "
          f"(K1) == forward (K6r) {trace_ok}; gradients finite {finite_g}, "
          f"|d/d gravity| {float(grads['gravity'].abs()):.6e}")
    _check(g_launches["cloth_tiled_resident"] == 1
           and g_launches["cloth_tiled"] == 0,
           f"multi_step_diff forward: K6r launched {g_launches}")
    _check(g_launches["cloth_step"] == FIT_SEG - 1,
           f"multi_step_diff trace: K1 launched {g_launches}")
    _check(g_launches["cloth_substep_vjp"] == FIT_SEG,
           f"multi_step_diff adjoint launched {g_launches}")
    _check(trace_ok, "large-grid trace's last state != the K6r forward")
    _check(finite_g, "large-grid gradients not finite")
    return {"launches": launches, "expected_k6r": expect,
            "expected_k6": expect_k6, "substeps_k6r": n_sim + n_frame + n_cli,
            "substeps_k6": n_big, "simulate_s": sim_s,
            "raster": raster,
            "finite": finite, "r_min": r_min, "particle_px": red,
            "globe_px": globe, "equal_k1_route": same,
            "grad_launches": g_launches, "grad_trace_equal": trace_ok}


def _k6_sweep(dev, card) -> dict:
    """K6's ms a substep over LG_TIME_STEPS substeps at each of LG_SIDES
    for the schedule ``pick_schedule`` gives it and each of LG_SWEEP (CUDA
    events, best of 3)."""
    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.ops import cloth_tiled_kernel

    res = {}
    n = LG_TIME_STEPS
    for side in LG_SIDES:
        c = ClothConfig(height=side, width=side)
        s = init_cloth_state(c, device=dev)
        p = ClothParams.from_config(c, device=dev)
        row = {}
        picked = cloth_tiled_kernel.pick_schedule(side, side, n)
        for sched in (picked,) + tuple(x for x in LG_SWEEP if x != picked):
            row[",".join(map(str, sched))] = _best_ms(
                lambda: cloth_tiled_kernel.multi_step_kernel(
                    s, p, DT, n, schedule=sched)) / n
        best = min(row, key=row.get)
        res[str(side)] = {"ms_per_substep": row, "best": best}
        print(f"phase 6 K6 sweep @{side}x{side}, {n} substeps [{card}] "
              f"(k, tile_h, tile_w: ms/substep): "
              + ", ".join(f"({k}) {v:.5f}" for k, v in row.items())
              + f"; best ({best})")
    return res


def _k6_trace(state, params, card) -> dict:
    """Phase 7 for the large-grid path: one torch.profiler trace of
    LG_TIME_STEPS substeps at LG² through ``cloth_kernel.multi_step``, the
    path's call (``trace_large_grid.json``): K6r's one launch, its time a
    substep, and the device's idle share over the call."""
    from wgpu_physics_engine_torch.ops import cloth_kernel

    # the K6r launch is the device record whose correlation id is that of a
    # launch issued inside the kept call's annotation
    n = LG_TIME_STEPS
    spans, (t0, t1), _ = _trace_kept(
        lambda: cloth_kernel.multi_step(state, params, DT, n),
        os.path.join(OUT, "trace_large_grid.json"), "k6r_traced")
    dev_spans = [(a, b, name) for a, b, name, _ in spans]
    ks = sorted((a, b) for a, b, name in dev_spans
                if "resident_kernel" in name)
    _check(len(ks) == 1, f"trace shows {len(ks)} K6r launches, not 1")
    busy = _union_us([(a, b) for a, b, _ in dev_spans])
    kb = _union_us(ks)
    res = {"launches": len(ks), "kernel_us": kb,
           "kernel_us_per_substep": kb / n, "window_us": t1 - t0,
           "device_busy_us": busy, "device_ops": len(dev_spans),
           "idle_share": 1.0 - busy / (t1 - t0)}
    print(f"phase 7 trace {n} substeps @{LG}x{LG} on K6r [{card}]: "
          f"{len(ks)} launch, {kb:.1f} us of kernel time = {kb / n:.3f} us a "
          f"substep; {len(dev_spans)} device ops; window {t1 - t0:.1f} us "
          f"(host, profiled), device busy {busy:.1f} us; device idle share "
          f"{res['idle_share']:.4f}")
    return res


def _k6_times(dev, card) -> dict:
    """Phases 6 and 7 for the large-grid path: K6r (where its tiles fit),
    K6 and K1 a substep at LG_SIDES beside the bound, K6's schedule sweep,
    K6's plain version (K6r's too), particle-steps/s of LG_RATE_STEPS
    substeps at LG² through the path's call (K6r), the ptxas report, and
    one traced run of LG_TIME_STEPS substeps at LG²."""
    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.ops import (_build, cloth_kernel,
                                               cloth_tiled_kernel)

    res = {"schedule": list(cloth_tiled_kernel.pick_schedule(
        LG, LG, LG_TIME_STEPS))}
    with open(os.path.join(_build.lib_dir("cloth_tiled"), "build.log")) as f:
        res["ptxas"] = [ln.strip() for ln in f
                        if "registers" in ln or "spill" in ln]
    print(f"phase 6 K6 schedule (k, tile_h, tile_w) {res['schedule']}, "
          f"shared memory a CTA at {LG}x{LG} "
          f"{cloth_tiled_kernel.smem_bytes(LG, LG, *res['schedule'])} B; "
          f"ptxas: {' | '.join(res['ptxas'])}")
    n = LG_TIME_STEPS
    states = {}
    for side in LG_SIDES:
        c = ClothConfig(height=side, width=side)
        s = init_cloth_state(c, device=dev)
        p = ClothParams.from_config(c, device=dev)
        states[side] = (s, p)
        k6 = _best_ms(lambda: cloth_tiled_kernel.multi_step_kernel(
            s, p, DT, n)) / n
        k1 = _best_ms(lambda: cloth_kernel.multi_step_kernel(
            s, p, DT, n)) / n
        bm, bb = _cloth_bound(side, side, 1, n)
        row = {"ms": k6, "k1_ms": k1, "bound_ms": bm / n, "bound_by": bb,
               "psteps_per_s": side * side / (k6 / 1e3)}
        if cloth_tiled_kernel.resident_fits(side, side, dev):
            row["k6r_ms"] = _best_ms(
                lambda: cloth_tiled_kernel.multi_step_resident_kernel(
                    s, p, DT, n)) / n
            row["k6r_tile"] = list(cloth_tiled_kernel.resident_tile(
                side, side, dev))
        if side <= LG:
            n_plain = 8
            row["plain_ms"] = _best_ms(lambda: cloth_tiled_kernel.
                                       multi_step_plain(s, p, DT, n_plain)
                                       ) / n_plain
        res[str(side)] = row
        print(f"phase 6 cloth_tiled (K6) @{side}x{side}, {n} substeps "
              f"[{card}]: {k6:.5f} ms/substep = "
              f"{side * side / (k6 / 1e3):.4e} particle-steps/s; K1 "
              f"{k1:.5f} ms/substep; bound {bm / n:.5f} ms ({bb}), K6 at "
              f"{bm / n / k6:.4f} of it"
              + (f"; cloth_tiled_resident (K6r, tile {row['k6r_tile']}) "
                 f"{row['k6r_ms']:.5f} ms/substep, at "
                 f"{bm / n / row['k6r_ms']:.4f} of the bound, "
                 f"{k6 / row['k6r_ms']:.3f}x K6" if "k6r_ms" in row else
                 "; K6r: no resident tiling fits")
              + (f"; plain {row['plain_ms']:.5f} ms/substep" if "plain_ms"
                 in row else ""))
    res["sweep"] = _k6_sweep(dev, card)

    s, p = states[LG]
    n3 = LG_RATE_STEPS
    ms = _best_ms(lambda: cloth_kernel.multi_step(s, p, DT, n3))
    res["rate"] = {"substeps": n3, "ms": ms,
                   "psteps_per_s": LG * LG * n3 / (ms / 1e3)}
    print(f"phase 6 cloth {LG}x{LG} x {n3} substeps through "
          f"cloth_kernel.multi_step (K6r) [{card}]: {ms:.3f} ms = "
          f"{LG * LG * n3 / (ms / 1e3):.4e} particle-steps/s")

    res["trace"] = _k6_trace(s, p, card)
    return res


# ---------------------------------------------------------------------------
# The multi-device paths (phase 21)
# ---------------------------------------------------------------------------

def _window_of(x, lo: int, hi: int, h: int):
    """Rows [lo, hi) of ``x`` [..., h, W], zero where they leave the grid
    (what a boundary shard's halo receives)."""
    import torch

    out = torch.zeros(x.shape[:-2] + (hi - lo, x.shape[-1]), dtype=x.dtype,
                      device=x.device)
    a, b = max(lo, 0), min(hi, h)
    out[..., a - lo:b - lo, :] = x[..., a:b, :]
    return out


def _k1w_checks(dev, card):
    """Phase 21, part 1: the row-window kernels on the MC_SHARDS row
    windows of the LG² grid (fresh and draped, top row pinned; the top
    window's row0 < 0, its leading rows dead) over k of MC_KS substeps:
    K1w (``cloth_kernel.multi_step_window_kernel``) and K6w
    (``cloth_tiled_kernel.multi_step_window_kernel``, which the route
    takes for these windows) against their plain versions and each other
    on the whole window, and on each window's centre rows against K1 and
    K6 on the whole grid, bit for bit. Returns the results and each
    kernel's largest difference from its plain version."""
    import torch

    from wgpu_physics_engine_torch.ops import cloth_kernel, cloth_tiled_kernel

    params, states = _k6_states(LG, LG, dev)
    h_local = LG // MC_SHARDS
    res, err = {}, {"k1w": 0.0, "k6w": 0.0}
    for label, s in states.items():
        for k in MC_KS:
            k1 = cloth_kernel.multi_step_kernel(s, params, DT, k)
            k6 = cloth_tiled_kernel.multi_step_kernel(s, params, DT, k)
            halo = 2 * k
            eq_plain = eq_k1 = True
            e = {"k1w": 0.0, "k6w": 0.0}
            for i in range(MC_SHARDS):
                lo, hi = i * h_local - halo, (i + 1) * h_local + halo
                args = [_window_of(a, lo, hi, LG) for a in
                        (s.pos, s.vel, s.pin_mask, s.pin_pos)]
                got = {"k1w": cloth_kernel.multi_step_window_kernel(
                           *args, params, DT, k, lo, LG),
                       "k6w": cloth_tiled_kernel.multi_step_window_kernel(
                           *args, params, DT, k, lo, LG)}
                pp, pv = cloth_kernel.multi_step_window_plain(
                    *args, params, DT, k, lo, LG)
                tp, tv = cloth_tiled_kernel.multi_step_window_plain(
                    *args, params, DT, k, lo, LG)
                torch.cuda.synchronize()
                eq_plain &= bool(torch.equal(tp, pp) and torch.equal(tv, pv))
                rows = slice(i * h_local, (i + 1) * h_local)
                for name, (kp, kv) in got.items():
                    e[name] = max(e[name], _maxdiff(kp, pp), _maxdiff(kv, pv))
                    eq_plain &= bool(torch.equal(kp, pp)
                                     and torch.equal(kv, pv))
                    for ref in (k1, k6):
                        eq_k1 &= bool(torch.equal(kp[:, halo:-halo],
                                                  ref.pos[:, rows])
                                      and torch.equal(kv[:, halo:-halo],
                                                      ref.vel[:, rows]))
            print(f"phase 21 cloth_step_window (K1w) and cloth_tiled_window "
                  f"(K6w) {label} @{LG}x{LG}, {MC_SHARDS} row windows, k = "
                  f"{k} [{card}]: vs their plain versions (K1w's and the "
                  f"tiled one) max abs K1w {e['k1w']:.3e}, K6w "
                  f"{e['k6w']:.3e}, all four equal bitwise on the whole "
                  f"windows {eq_plain}; centre rows vs K1 and K6 on the "
                  f"whole grid bitwise {eq_k1}")
            _check(eq_plain, f"K1w/K6w {label} k={k} differ from their plain "
                   f"versions or each other by {e}")
            _check(eq_k1, f"K1w/K6w {label} k={k}: centre rows differ from "
                   f"K1/K6")
            res[f"{label} k={k}"] = {"err_plain": e, "bitwise_plain": eq_plain,
                                     "bitwise_k1_k6": eq_k1}
            err = {n: max(err[n], e[n]) for n in err}
    return res, err


def _mc_counters(reset: bool = False) -> dict:
    """The launch counters of the kernels the multi-device paths run (set
    to 0 with ``reset``)."""
    from wgpu_physics_engine_torch.ops import (cloth_kernel,
                                               cloth_tiled_kernel,
                                               granular_kernel, raster_kernel)

    names = {"cloth_step_window": (cloth_kernel, "LAUNCHES_WINDOW"),
             "cloth_tiled_window": (cloth_tiled_kernel, "LAUNCHES_WINDOW"),
             "cloth_step": (cloth_kernel, "LAUNCHES"),
             "cloth_step_batched": (cloth_kernel, "LAUNCHES_BATCHED"),
             "cloth_step_force": (cloth_kernel, "LAUNCHES_FORCE"),
             "cloth_tiled": (cloth_tiled_kernel, "LAUNCHES"),
             "cloth_tiled_resident": (cloth_tiled_kernel,
                                      "LAUNCHES_RESIDENT"),
             "cloth_tiled_batched": (cloth_tiled_kernel, "LAUNCHES_BATCHED"),
             "granular_step_sharded": (granular_kernel, "LAUNCHES_SHARDED"),
             "granular_step": (granular_kernel, "LAUNCHES"),
             "granular_forces": (granular_kernel, "LAUNCHES_FORCES"),
             "granular_force_jvp": (granular_kernel, "LAUNCHES_JVP"),
             "sphere_raster": (raster_kernel, "LAUNCHES")}
    if reset:
        for mod, attr in names.values():
            setattr(mod, attr, 0)
    return {k: getattr(mod, attr) for k, (mod, attr) in names.items()}


def _mc_diff_grads(worlds, cfg, wp, wv, mesh):
    """The value and the scalar gradients (dt, k_contact, gravity,
    restitution) of sum(pos * wp) + sum(vel * wv) over ``worlds`` stepped
    MC_DIFF_STEPS substeps: through ``multi_step_diff_sharded`` on
    ``mesh``, or world by world (``mesh`` None), plus the state
    gradients."""
    import torch

    from wgpu_physics_engine_torch.core.state import ParticleState
    from wgpu_physics_engine_torch.models import granular
    from wgpu_physics_engine_torch.parallel import granular_mesh

    dev = worlds[0].pos.device
    pos = torch.stack([w.pos for w in worlds]).requires_grad_(True)
    vel = torch.stack([w.vel for w in worlds]).requires_grad_(True)
    sc = [torch.tensor(v, dtype=torch.float32, device=dev, requires_grad=True)
          for v in (GR_DT, cfg.k_contact, cfg.gravity, cfg.restitution)]
    if mesh is not None:
        out = granular_mesh.multi_step_diff_sharded(
            ParticleState(pos=pos, vel=vel), cfg, sc[0], MC_DIFF_STEPS, mesh,
            k_contact=sc[1], gravity=sc[2], restitution=sc[3])
        loss = (out.pos * wp).sum() + (out.vel * wv).sum()
    else:
        loss = 0.0
        for j in range(len(worlds)):
            out = granular.multi_step_diff(
                ParticleState(pos=pos[j], vel=vel[j]), cfg, sc[0],
                MC_DIFF_STEPS, k_contact=sc[1], gravity=sc[2],
                restitution=sc[3])
            loss = loss + (out.pos * wp[j]).sum() + (out.vel * wv[j]).sum()
    grads = torch.autograd.grad(loss, [pos, vel] + sc)
    return float(loss.detach()), grads


def _phase21(dev, card):
    """Phase 21: the multi-device paths on MC_SHARDS shards of one card.
    The references (K6/K1 on the whole grid, K1 per world, K5 on the
    whole batch, single-device K10, the serial gradients) run first; then,
    with the launch counters reset just before and read just after, the
    main path: ``spatial_multi_step`` at LG² (k = 1 and 2, MC_STEPS
    substeps), ``batched_spatial_multi_step`` (MC_WORLDS worlds of the
    GRID² flagship on a (2, 2) worlds × rows mesh, k = 2),
    ``batched_multi_step`` (MC_K5_WORLDS 60×60 worlds on 4 shards),
    ``multi_step_sharded`` on the 1M pile (8 and 64 substeps),
    ``multi_step_diff_sharded`` (2 worlds on 2 shards),
    ``batched_self_collide_multi_step`` (MC_SC_WORLDS worlds of the GRID²
    self-collision configuration on 2 shards) and
    ``examples/multichip_datagen.py`` at its defaults; then the checks."""
    import glob

    import numpy as np
    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import (ClothParams, ClothState,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.examples import multichip_datagen
    from wgpu_physics_engine_torch.models import cloth, granular, scenes
    from wgpu_physics_engine_torch.ops import cloth_kernel
    from wgpu_physics_engine_torch.ops import granular_kernel as gk
    from wgpu_physics_engine_torch.parallel import datagen, granular_mesh
    from wgpu_physics_engine_torch.parallel import mesh as pmesh

    rows4 = pmesh.make_mesh((MC_SHARDS,), ("rows",), [dev] * MC_SHARDS)
    grid22 = pmesh.make_mesh((2, 2), ("worlds", "rows"), [dev] * 4)
    worlds4 = pmesh.make_mesh((MC_SHARDS,), ("worlds",), [dev] * MC_SHARDS)
    worlds2 = pmesh.make_mesh((2,), ("worlds",), [dev] * 2)
    grains4 = pmesh.make_mesh((MC_SHARDS,), ("grains",), [dev] * MC_SHARDS)

    # ---- inputs and references, not counted ----
    c_lg = ClothConfig(height=LG, width=LG)
    p_lg = ClothParams.from_config(c_lg, device=dev)
    s_lg = init_cloth_state(c_lg, device=dev)
    pin = torch.zeros((LG, LG), dtype=torch.bool, device=dev)
    pin[0] = True
    s_lg = s_lg._replace(pin_mask=pin, pin_pos=s_lg.pos)
    ref_lg = cloth_kernel.multi_step(s_lg, p_lg, DT, MC_STEPS)       # K6r
    c_fl = ClothConfig(height=GRID, width=GRID)
    p_fl = ClothParams.from_config(c_fl, device=dev)
    fl = datagen.randomized_worlds(c_fl, MC_WORLDS,
                                   torch.Generator().manual_seed(21),
                                   device=dev)
    batch = ClothState(pos=fl.state.pos, vel=fl.state.vel)
    ref_worlds = [cloth_kernel.multi_step(
        ClothState(pos=batch.pos[i], vel=batch.vel[i]), p_fl, DT, MC_STEPS)
        for i in range(MC_WORLDS)]
    dg = datagen.randomized_worlds(ClothConfig(), MC_K5_WORLDS,
                                   torch.Generator().manual_seed(22),
                                   device=dev)
    ref_k5 = cloth_kernel.multi_step(dg.state, dg.params, DT, DG_STEPS)  # K5r
    gcfg = _gr_configs()["default"]
    pile = granular.init_state(gcfg, torch.Generator().manual_seed(0),
                               device=dev)
    ref_gr = {n: granular.multi_step(pile, gcfg, GR_DT, n, return_stats=True)
              for n in MC_GR_STEPS}
    diff_worlds = [_lowered(granular.init_state(
        gcfg, torch.Generator().manual_seed(s), device=dev), gcfg)
        for s in range(MC_DIFF_WORLDS)]
    rng = np.random.default_rng(21)
    wp, wv = (torch.tensor(rng.standard_normal((MC_DIFF_WORLDS, 3, GR_N))
                           .astype(np.float32), device=dev)
              for _ in range(2))
    v_serial, g_serial = _mc_diff_grads(diff_worlds, gcfg, wp, wv, None)
    # the self-collision configuration of phase 17's scene, MC_SC_WORLDS
    # worlds from its fresh sheet with seeded velocities
    sc_spec = cloth.default_self_collision_grid(
        c_fl, skin=2.0 * c_fl.particle_radius)
    sc_kw = dict(rebuild_every=SC_REBUILD, pallas_block=SC_BLOCK,
                 pallas_slab=scenes.SELF_COLLIDE_SLAB)
    s_fl = init_cloth_state(c_fl, device=dev)
    sc_vel = torch.tensor((0.5 * rng.standard_normal(
        (MC_SC_WORLDS, 3, GRID, GRID))).astype(np.float32), device=dev)
    sc_batch = ClothState(pos=s_fl.pos.expand(MC_SC_WORLDS, 3, GRID, GRID)
                          .contiguous(), vel=sc_vel)
    ref_sc = [cloth.multi_step_self_collide(
        ClothState(pos=s_fl.pos, vel=sc_vel[i]), p_fl, DT, MC_SC_STEPS,
        sc_spec, return_stats=True, **sc_kw) for i in range(MC_SC_WORLDS)]
    for f in glob.glob(os.path.join(multichip_datagen.DEFAULT_OUT, "*.npy")):
        os.unlink(f)
    torch.cuda.synchronize()

    # ---- the main path, counted ----
    _mc_counters(reset=True)
    host = {}
    t0 = time.perf_counter()
    rows = {k: pmesh.spatial_multi_step(s_lg, p_lg, DT, MC_STEPS, rows4,
                                        substeps_per_exchange=k)
            for k in (1, 2)}
    composed = pmesh.batched_spatial_multi_step(batch, p_fl, DT, MC_STEPS,
                                                grid22,
                                                substeps_per_exchange=2)
    k5 = pmesh.batched_multi_step(dg.state, dg.params, DT, DG_STEPS, worlds4)
    torch.cuda.synchronize()
    host["cloth_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gr = {n: granular_mesh.multi_step_sharded(pile, gcfg, GR_DT, n, grains4,
                                              return_stats=True)
          for n in MC_GR_STEPS}
    torch.cuda.synchronize()
    host["granular_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    v_sh, g_sh = _mc_diff_grads(diff_worlds, gcfg, wp, wv, worlds2)
    torch.cuda.synchronize()
    host["diff_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sc = pmesh.batched_self_collide_multi_step(sc_batch, p_fl, DT,
                                               MC_SC_STEPS, sc_spec, worlds2,
                                               **sc_kw)
    torch.cuda.synchronize()
    host["self_collide_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    frames = multichip_datagen.main([])
    host["example_s"] = time.perf_counter() - t0
    launches = _mc_counters()
    print(f"phase 21 multi-device main path on {MC_SHARDS} shards of one "
          f"card [{card}]: host clock {host}; launches {launches}")
    # the shards of 16 worlds stay on K5, a shard's window on K6w

    # ---- the checks ----
    n_rows = MC_STEPS * MC_SHARDS
    # K1w a substep for the batch of all MC_WORLDS x 2 windows on the card
    n_comp = MC_STEPS
    exp = {"cloth_tiled_window": 2 * n_rows, "cloth_step_window": n_comp,
           "granular_step_sharded": MC_SHARDS * sum(MC_GR_STEPS),
           "cloth_step_batched": DG_STEPS * MC_SHARDS * (1 + 4),
           "cloth_step": 0, "cloth_tiled": 0, "cloth_tiled_resident": 0,
           "cloth_tiled_batched": 0, "granular_step": 0,
           "cloth_step_force": MC_SC_WORLDS * MC_SC_STEPS,
           "granular_forces": (2 * MC_DIFF_WORLDS * MC_DIFF_STEPS
                               + MC_SC_WORLDS * MC_SC_STEPS),
           "granular_force_jvp": MC_DIFF_WORLDS * MC_DIFF_STEPS,
           "sphere_raster": MC_SHARDS * 4}
    _check(launches == exp, f"multi-device launches {launches}, expected "
           f"{exp}")
    res = {"launches": launches, "host_s": host}
    eq_rows = {k: bool(torch.equal(o.pos, ref_lg.pos)
                       and torch.equal(o.vel, ref_lg.vel))
               for k, o in rows.items()}
    eq_comp = all(bool(torch.equal(composed.pos[i], r.pos)
                       and torch.equal(composed.vel[i], r.vel))
                  for i, r in enumerate(ref_worlds))
    eq_k5 = bool(torch.equal(k5.pos, ref_k5.pos)
                 and torch.equal(k5.vel, ref_k5.vel))
    contact = _contact_share(ref_lg.pos, p_lg)
    print(f"phase 21 spatial_multi_step @{LG}x{LG}, {MC_STEPS} substeps, "
          f"{MC_SHARDS} row shards [{card}]: vs cloth_kernel.multi_step (K6r) "
          f"bitwise k=1 {eq_rows[1]}, k=2 {eq_rows[2]}; particles in contact "
          f"{contact:.4f}; batched_spatial_multi_step {MC_WORLDS} worlds "
          f"@{GRID}x{GRID} on (2, 2), k = 2: each world vs K1 alone bitwise "
          f"{eq_comp}; batched_multi_step {MC_K5_WORLDS} worlds on "
          f"{MC_SHARDS} shards (K5) vs the whole batch (K5r) bitwise {eq_k5}")
    _check(all(eq_rows.values()), f"rows path differs from K6r: {eq_rows}")
    _check(eq_comp, "composed worlds x rows path differs from K1")
    _check(eq_k5, "worlds-sharded K5 differs from K5r on the whole batch")
    _check(torch.equal(rows[1].pos[:, 0], s_lg.pos[:, 0]),
           "rows path: pinned row moved")
    res["cloth"] = {"bitwise_rows": eq_rows, "bitwise_composed": eq_comp,
                    "bitwise_k5": eq_k5, "contact_share": contact}

    n8, n64 = MC_GR_STEPS
    (o8, d8), (r8, rd8) = gr[n8], ref_gr[n8]
    (o64, d64), (r64, rd64) = gr[n64], ref_gr[n64]
    eq8 = bool(torch.equal(o8.pos, r8.pos) and torch.equal(o8.vel, r8.vel))
    ep, ev = _maxdiff(o64.pos, r64.pos), _maxdiff(o64.vel, r64.vel)
    finite = bool(torch.isfinite(o64.pos).all() and torch.isfinite(o64.vel)
                  .all())
    print(f"phase 21 multi_step_sharded @{GR_N}, default configuration, "
          f"{MC_SHARDS} grain shards [{card}]: {n8} substeps (one rebuild "
          f"block) vs granular.multi_step (K10) bitwise {eq8}; {n64} "
          f"substeps pos {ep:.3e} (<=1e-4) vel {ev:.3e} (<=1e-3), bitwise "
          f"{bool(ep == 0.0 and ev == 0.0)}; dropped {int(d8)} in the first "
          f"block, {int(d64)} over {n64} substeps (single {int(rd8)}, "
          f"{int(rd64)}), finite {finite}")
    _check(eq8, "sharded pile differs from K10 over one rebuild block")
    _check(ep <= 1e-4 and ev <= 1e-3, f"sharded pile off: {ep} {ev}")
    # the same candidate sets: the slab drops of the default configuration
    # on this pile (none in the first block) are the single-device path's
    _check(int(d8) == int(rd8) == 0 and int(d64) == int(rd64),
           f"sharded pile dropped {int(d8)}, {int(d64)}; single "
           f"{int(rd8)}, {int(rd64)}")
    _check(finite, "sharded pile not finite")
    res["granular"] = {"bitwise_8": eq8, "err_64_pos": ep, "err_64_vel": ev,
                       "dropped_8": int(d8), "dropped_64": int(d64),
                       "dropped_64_single": int(rd64)}

    names = ("pos", "vel", "dt", "k_contact", "gravity", "restitution")
    rel = {k: _max_rel(a, b) for k, a, b in zip(names, g_sh, g_serial)}
    mags = {k: float(g.abs().max()) for k, g in zip(names, g_sh)}
    print(f"phase 21 multi_step_diff_sharded {MC_DIFF_WORLDS} worlds @{GR_N} "
          f"on 2 shards, {MC_DIFF_STEPS} substeps [{card}]: value "
          f"{v_sh:.6e} vs serial {v_serial:.6e}; gradients vs the per-world "
          f"serial sum max-relative {rel} (<=1e-5); max |g| {mags}")
    _check(abs(v_sh - v_serial) <= 1e-6 * abs(v_serial),
           f"sharded diff value {v_sh} vs {v_serial}")
    _check(all(r <= 1e-5 for r in rel.values()),
           f"sharded diff gradients vs serial: {rel}")
    _check(all(m > 0 for m in mags.values()), f"zero gradients: {mags}")
    res["diff"] = {"value": v_sh, "value_serial": v_serial, "rel": rel}

    eq_sc = [bool(torch.equal(sc.pos[i], r.pos) and torch.equal(sc.vel[i],
                                                               r.vel))
             for i, (r, _) in enumerate(ref_sc)]
    sc_drop = max(int(d) for _, d in ref_sc)
    sc_finite = bool(torch.isfinite(sc.pos).all() and torch.isfinite(sc.vel)
                     .all())
    print(f"phase 21 batched_self_collide_multi_step {MC_SC_WORLDS} worlds "
          f"@{GRID}x{GRID} on 2 worlds shards, {MC_SC_STEPS} substeps, "
          f"rebuild every {SC_REBUILD} [{card}]: each world vs "
          f"multi_step_self_collide alone bitwise {eq_sc}; dropped (serial "
          f"runs) {sc_drop}; finite {sc_finite}")
    with _k1f_sorted_plain():
        r0, _ = cloth.multi_step_self_collide(
            ClothState(pos=s_fl.pos, vel=sc_vel[0]), p_fl, DT, MC_SC_STEPS,
            sc_spec, return_stats=True, **sc_kw)
    k1f_plain = bool(torch.equal(sc.pos[0], r0.pos)
                     and torch.equal(sc.vel[0], r0.vel))
    print(f"phase 21 world 0 of the worlds-sharded self-collision vs the "
          f"same world with K1f's plain version [{card}]: bitwise "
          f"{k1f_plain}")
    _check(all(eq_sc), f"worlds-sharded self-collision differs: {eq_sc}")
    _check(k1f_plain, "worlds-sharded self-collision differs from K1f's "
           "plain version")
    _check(sc_drop == 0, f"self-collision dropped {sc_drop} window entries")
    _check(sc_finite, "worlds-sharded self-collision not finite")
    res["self_collide"] = {"bitwise": eq_sc, "dropped": sc_drop,
                           "k1f_plain_bitwise": k1f_plain}

    arrs = [np.load(f) for f in frames]
    ok = (len(arrs) == 4 and all(a.shape == (64, 64, 64, 3)
                                 and a.dtype == np.uint8 for a in arrs))
    spread = [int(a.reshape(-1, 3).max(0).min()) -
              int(a.reshape(-1, 3).min(0).max()) for a in arrs]
    print(f"phase 21 examples/multichip_datagen.py (defaults: 64 worlds, "
          f"4 frames of 64x64, 4 shards) [{card}]: {len(arrs)} frames "
          f"{[a.shape for a in arrs[:1]]} uint8 {ok}; colour spread a frame "
          f"{spread}; {host['example_s']:.2f} s host clock")
    _check(ok and min(spread) > 0, "multichip datagen frames off")
    res["example"] = {"frames": len(arrs), "spread": spread}
    return res


def _slice_work(p0, prm, slabs, base: int, nl: int):
    """Candidate slots and touching pairs of the sorted slots [base, base +
    nl): the data-dependent work of one K10b launch."""
    import torch

    from wgpu_physics_engine_torch.ops import granular_kernel as gk

    (a_lo, a_hi), (b_lo, b_hi) = gk.slab_ranges(slabs, nl, base)
    cand = int(torch.clamp_min(a_hi - a_lo, 0).sum()
               + torch.clamp_min(b_hi - b_lo, 0).sum())
    touch = 0
    for lo, hi in ((a_lo, a_hi), (b_lo, b_hi)):
        for *_, t in gk._pass_pairs(p0, lo, hi, prm[0], base):
            touch += int(t.sum())
    return cand, touch


def _k10b_checks(dev, card):
    """Phase 21, part 2: K10b on each of the MC_SHARDS grain shards' slices
    of the 1M pile (default configuration, the sharded pad) against its
    plain version and against the same rows of one K10 launch; its time a
    launch beside K10's and K10's quarter, with its bound from the slice's
    candidate slots and touching pairs."""
    import torch

    from wgpu_physics_engine_torch.models import granular
    from wgpu_physics_engine_torch.ops import granular_kernel as gk

    cfg = _gr_configs()["default"]
    pile = granular.init_state(cfg, torch.Generator().manual_seed(0),
                               device=dev)
    n = GR_N
    n_pad = granular.pad_slots(n, cfg, unit=cfg.pallas_block * 8 * MC_SHARDS)
    nloc = n_pad // MC_SHARDS
    grid, slabs, _ = granular.rebuild(pile.pos, pile.vel, cfg, n_pad=n_pad)
    prm = gk.kernel_params(cfg, GR_DT, dev)
    p0, v0 = grid.sorted_pos, grid.sorted_vel
    fp, fv = gk.substep_sorted_kernel(p0, v0, prm, slabs)
    err, eq_k10 = 0.0, True
    for d in range(MC_SHARDS):
        lo, hi = min(d * nloc, n), min((d + 1) * nloc, n)
        kp, kv = gk.substep_sorted_kernel(p0, v0[:, lo:hi], prm, slabs,
                                          base=lo, n_local=hi - lo)
        pp, pv = gk.substep_sorted_plain(p0, v0[:, lo:hi], prm, slabs,
                                         base=lo, n_local=hi - lo)
        torch.cuda.synchronize()
        err = max(err, _maxdiff(kp, pp), _maxdiff(kv, pv))
        eq_k10 &= bool(torch.equal(kp, fp[:, lo:hi])
                       and torch.equal(kv, fv[:, lo:hi]))
    print(f"phase 21 granular_step_sharded (K10b) @{n}, {MC_SHARDS} slices "
          f"of {nloc} slots [{card}]: vs plain max abs {err:.3e} (bitwise "
          f"{err == 0.0}); vs the same rows of K10 bitwise {eq_k10}")
    _check(err == 0.0, f"K10b differs from its plain version by {err}")
    _check(eq_k10, "K10b differs from K10 on its rows")

    lo, hi = nloc, 2 * nloc                           # an interior shard
    vl = v0[:, lo:hi]
    k_ms = _best_ms(lambda: gk.substep_sorted_kernel(p0, vl, prm, slabs,
                                                     base=lo,
                                                     n_local=hi - lo))
    p_ms = _best_ms(lambda: gk.substep_sorted_plain(p0, vl, prm, slabs,
                                                    base=lo, n_local=hi - lo))
    k10_ms = _best_ms(lambda: gk.substep_sorted_kernel(p0, v0, prm, slabs))
    cand, touch = _slice_work(p0, prm, slabs, lo, hi - lo)
    b_ms, b_by = _bound(GR_BYTES * (hi - lo), OPS_SLOT * cand
                        + OPS_TOUCH * touch + OPS_GR_PARTICLE * (hi - lo))

    # device time a launch: one K10 launch and the MC_SHARDS K10b launches
    # of one sharded substep, three times over, traced (a call's CUDA
    # events above include the wrapper's host work, longer than a
    # quarter's launch), each call in a range of its own; the last
    # repetition in which every call's launch has its device record (by
    # correlation id) is read, or, where the tracer kept none, each launch
    # is timed by CUDA events queued behind a sleep
    cuts = [(0, n)] + [(min(d * nloc, n), min((d + 1) * nloc, n))
                       for d in range(MC_SHARDS)]
    blocks = [-(-(b - a) // cfg.pallas_block) for a, b in cuts]
    marks = [[f"k10b_r{r}_{i}" for i in range(len(cuts))] for r in range(3)]

    def substeps():
        for rep in marks:
            for i, ((a, b), m) in enumerate(zip(cuts, rep)):
                with torch.profiler.record_function(m):
                    if i == 0:
                        gk.substep_sorted_kernel(p0, v0, prm, slabs)
                    else:
                        gk.substep_sorted_kernel(p0, v0[:, a:b], prm, slabs,
                                                 base=a, n_local=b - a)

    _, _, by_mark = _trace_kept(substeps,
                                os.path.join(OUT, "trace_k10b.json"),
                                "k10b_traced", [m for r in marks for m in r])
    found = [[[sp for sp in by_mark[m] if "granular_step" in sp[2]]
              for m in rep] for rep in marks]
    whole = [r for r, f in enumerate(found) if all(len(x) == 1 for x in f)]
    if whole:
        ks = [x[0] for x in found[whole[-1]]]
        grids = [g[0] for *_, g in ks]
        _check(grids == blocks, f"trace: the K10 and K10b launches have "
               f"grids {grids}, not {blocks}")
        how = "traced"
        dev_us = [b - a for a, b, _, _ in ks]
    else:
        # the tracer kept no whole repetition in TRACE_TRIES runs: each
        # launch's device time by CUDA events queued behind a sleep
        print(f"trace k10b: no repetition holds a device record of each of "
              f"its K10 and K10b launches "
              f"{[[len(x) for x in f] for f in found]}; timed by queued "
              f"CUDA events instead", file=sys.stderr)
        how = "queued CUDA events"
        dev_us = [_queued_us(lambda: gk.substep_sorted_kernel(p0, v, prm,
                                                              slabs, **kw))
                  for v, kw in [(v0, {})] + [
                      (v0[:, a:b].contiguous(), {"base": a, "n_local": b - a})
                      for a, b in cuts[1:]]]
    k10_us, k10b_us = dev_us[0], dev_us[1:]
    print(f"phase 6 granular_step_sharded (K10b) @{n} [{card}]: device time "
          f"a launch ({how}) {', '.join(f'{t:.3f}' for t in k10b_us)} us "
          f"(shards 0-{MC_SHARDS - 1}; sum {sum(k10b_us):.3f}) beside K10 on "
          f"all {n} slots {k10_us:.3f} us (a quarter {k10_us / 4:.3f}); by "
          f"CUDA events a call: K10b on slots [{lo}, {hi}) {k_ms:.4f} ms, K10 "
          f"{k10_ms:.4f} ms; plain {p_ms:.4f} ms; bound of the interior "
          f"slice {b_ms:.5f} ms ({b_by}; {cand} candidate slots, {touch} "
          f"touching), its launch at {b_ms / (k10b_us[1] / 1e3):.4f} of it")
    return {"err_plain": err, "bitwise_k10": eq_k10,
            "ms": k10b_us[1] / 1e3, "device_us": k10b_us, "timed_by": how,
            "k10_device_us": k10_us, "call_ms": k_ms, "plain_ms": p_ms,
            "k10_call_ms": k10_ms, "bound_ms": b_ms, "bound_by": b_by,
            "candidates": cand, "touching": touch}, err


def _trace_kept(fn, path, label: str, marks=()):
    """Run ``fn`` twice under ``torch.profiler`` with a schedule that keeps
    only the second call (the first warms the tracer up), write the Chrome
    trace to ``path`` and return the kept call's device spans ``(start,
    end, name, grid)``, matched to it by correlation id, its window ``(t0,
    t1)`` in µs (the host annotation, extended to its last device span),
    and for each name in ``marks`` (a ``record_function`` range inside
    ``fn``) the device spans of the launches issued inside it. Each step
    first keeps the device busy ~2 ms and waits: the tracer dropped the
    first device records of a kept step (two of five granular launches in
    one run), and the records it drops are then the sleep's. A trace in
    which a kernel launched inside ``label`` has no device record (one run
    kept none of the fifteen of ``_k10b_checks``), or in which nothing was
    launched there, is taken again, up to TRACE_TRIES times; the last one
    is returned either way and the caller's checks judge it."""
    for attempt in range(1, TRACE_TRIES + 1):
        events = _kept_events(fn, path, label)
        ann = [e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == label]
        _check(len(ann) == 1, f"trace: {len(ann)} {label} annotations")
        t0, t1 = ann[0]["ts"], ann[0]["ts"] + ann[0]["dur"]
        missing, launched = _unrecorded(events, t0, t1)
        if launched and not missing:
            break
        print(f"trace {os.path.basename(path)}, attempt {attempt} of "
              f"{TRACE_TRIES}: {missing} of the {launched} kernel launches "
              f"inside {label} have no device record", file=sys.stderr)
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"
               and "correlation" in e.get("args", {})]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "correlation" in e.get("args", {})]

    def issued_in(a, b):
        corr = {e["args"]["correlation"] for e in runtime if a <= e["ts"] <= b}
        return [(e["ts"], e["ts"] + e["dur"], e["name"],
                 tuple(e["args"].get("grid", ()))) for e in device
                if e["args"]["correlation"] in corr]

    spans = issued_in(t0, t1)
    by_mark = {}
    for m in marks:
        ms = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"] == m]
        _check(len(ms) == 1, f"trace: {len(ms)} {m} annotations")
        by_mark[m] = issued_in(ms[0]["ts"], ms[0]["ts"] + ms[0]["dur"])
    return spans, (t0, max([t1] + [b for _, b, _, _ in spans])), by_mark


def _kept_events(fn, path, label: str) -> list:
    """One profiled run for :func:`_trace_kept`: the kept step's complete
    events (``"ph": "X"`` with a duration), its Chrome trace at ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda pr: pr.export_chrome_trace(path)
                 ) as prof:
        for _ in range(2):
            torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
            with torch.profiler.record_function(label):
                fn()
                torch.cuda.synchronize()
            prof.step()
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and "dur" in e]


def _unrecorded(events, t0: float, t1: float):
    """``(missing, launched)``: the kernel launches issued in ``[t0, t1]``
    and those of them whose device record (by correlation id) the trace
    lacks."""
    kernels = {e["args"]["correlation"] for e in events
               if e.get("cat") == "kernel"
               and "correlation" in e.get("args", {})}
    launches = [e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime" and "Launch" in e["name"]
                and t0 <= e["ts"] <= t1 and "correlation" in e.get("args", {})]
    return sum(c not in kernels for c in launches), len(launches)


def _mc_trace(state, params, mesh, card) -> dict:
    """One torch.profiler trace of MC_TRACE_STEPS row-sharded substeps at
    LG² (k = 2, so MC_TRACE_STEPS / 2 exchange blocks) on MC_SHARDS shards
    of one card (``trace_rows_block.json``): the window kernel's launches
    and time (K6w: each shard's window lies above the tiled limit), the
    halo copies and the other device ops, and the device's idle share."""
    from wgpu_physics_engine_torch.parallel import mesh as pmesh

    spans, (t0, t1), _ = _trace_kept(
        lambda: pmesh.spatial_multi_step(state, params, DT, MC_TRACE_STEPS,
                                         mesh, substeps_per_exchange=2),
        os.path.join(OUT, "trace_rows_block.json"), "rows_traced")
    k6w = [(a, b) for a, b, name, _ in spans if "tiled_kernel" in name]
    copies = [(a, b) for a, b, name, _ in spans
              if "tiled_kernel" not in name
              and ("Cat" in name or "opy" in name or "emcpy" in name)]
    exp = MC_TRACE_STEPS * MC_SHARDS
    _check(len(k6w) == exp, f"trace shows {len(k6w)} K6w launches, not {exp}")
    busy = _union_us([(a, b) for a, b, _, _ in spans])
    kb, cb = _union_us(k6w), _union_us(copies)
    res = {"k6w_launches": len(k6w), "k6w_us": kb / len(k6w),
           "copies": len(copies), "copy_us": cb,
           "other_ops": len(spans) - len(k6w) - len(copies),
           "other_us": busy - kb - cb, "window_us": t1 - t0,
           "device_busy_us": busy, "idle_share": 1.0 - busy / (t1 - t0)}
    print(f"phase 7 trace {MC_TRACE_STEPS} row-sharded substeps @{LG}x{LG}, "
          f"k = 2, {MC_SHARDS} shards of one card [{card}]: K6w "
          f"{len(k6w)} x {kb / len(k6w):.3f} us; halo copies and gathers "
          f"{len(copies)} ops, {cb:.1f} us; other device ops "
          f"{res['other_ops']}, {res['other_us']:.1f} us; window "
          f"{t1 - t0:.1f} us (host, profiled), device busy {busy:.1f} us; "
          f"device idle share {res['idle_share']:.4f}")
    return res


def _k1w_composed_check(c_win, params, k: int, row0: int, dev, card):
    """K1w on the composed path's windows against its plain version
    (``multi_step_window_plain``) on the same inputs, bit for bit on the
    whole window, halo and dead rows included: the timed window
    ``c_win`` (rows ``row0`` to ``row0 + 136`` of the fresh GRID² cloth),
    and the top and bottom windows of the fresh and the draped cloth with
    the top row pinned (``_k6_states``; the top window's row0 < 0, its
    leading rows dead), at 1 and ``k`` substeps. Returns the largest
    difference and whether all are equal."""
    import torch

    from wgpu_physics_engine_torch.ops import cloth_kernel

    half, halo = GRID // 2, 2 * k
    params_s, states = _k6_states(GRID, GRID, dev)
    cases = [("fresh, timed window", c_win + [None, None], params, row0)]
    for label, st in states.items():
        for lo in (-halo, half - halo):
            cases.append((f"{label}, rows from {lo}", [
                _window_of(a, lo, lo + half + 2 * halo, GRID)
                for a in (st.pos, st.vel, st.pin_mask, st.pin_pos)],
                params_s, lo))
    err, eq = 0.0, True
    for _, args, prm, r0 in cases:
        for n in sorted({1, k}):
            kp, kv = cloth_kernel.multi_step_window_kernel(
                *args, prm, DT, n, r0, GRID)
            pp, pv = cloth_kernel.multi_step_window_plain(
                *args, prm, DT, n, r0, GRID)
            torch.cuda.synchronize()
            err = max(err, _maxdiff(kp, pp), _maxdiff(kv, pv))
            eq &= bool(torch.equal(kp, pp) and torch.equal(kv, pv))
    print(f"phase 6 cloth_step_window (K1w) on the composed path's "
          f"{half + 2 * halo}x{GRID} windows ({len(cases)} windows, top and "
          f"bottom, fresh and draped, k = 1 and {k}) [{card}]: vs its plain "
          f"version on the whole window max abs {err:.3e}, bitwise {eq}")
    _check(eq, f"K1w differs from its plain version on the composed "
           f"windows by {err}")
    return err, eq


def _mc_times(dev, card) -> dict:
    """Phases 6 and 7 for the multi-device paths: K1w a launch on an LG²
    window (row0 0, the whole grid) beside K1 and K6; on one rows shard's
    window K6w (the raw kernel, the routed ``multi_step_window`` over many
    substeps and in the path's calls of 2) beside K1w, with its bound and
    its plain version; on a composed shard's window K1w (raw and routed)
    with its plain version and bound; particle-steps/s of the
    row-sharded LG² cloth (k = 1 and 2) beside the single-card path (K6),
    and of the grain-sharded 1M pile beside ``granular.multi_step`` (64
    substeps, default configuration, host clock, best of 3); one trace."""
    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.models import granular
    from wgpu_physics_engine_torch.ops import cloth_kernel, cloth_tiled_kernel
    from wgpu_physics_engine_torch.parallel import granular_mesh
    from wgpu_physics_engine_torch.parallel import mesh as pmesh

    c = ClothConfig(height=LG, width=LG)
    s = init_cloth_state(c, device=dev)
    p = ClothParams.from_config(c, device=dev)
    n = LG_TIME_STEPS
    res = {}
    w_ms = _best_ms(lambda: cloth_kernel.multi_step_window_kernel(
        s.pos, s.vel, None, None, p, DT, n, 0, LG)) / n
    k1_ms = _best_ms(lambda: cloth_kernel.multi_step_kernel(s, p, DT, n)) / n
    k6_ms = _best_ms(lambda: cloth_tiled_kernel.multi_step_kernel(
        s, p, DT, n)) / n
    n_plain = 8
    pl_ms = _best_ms(lambda: cloth_kernel.multi_step_window_plain(
        s.pos, s.vel, None, None, p, DT, n_plain, 0, LG)) / n_plain
    bm, bb = _cloth_bound(LG, LG, 1, n)
    h_win = LG // MC_SHARDS + 2 * 2
    win = [_window_of(a, LG // MC_SHARDS - 2, 2 * LG // MC_SHARDS + 2, LG)
           for a in (s.pos, s.vel)]
    row0 = LG // MC_SHARDS - 2
    sw_ms = _best_ms(lambda: cloth_kernel.multi_step_window_kernel(
        *win, None, None, p, DT, n, row0, LG)) / n
    spl_ms = _best_ms(lambda: cloth_kernel.multi_step_window_plain(
        *win, None, None, p, DT, n_plain, row0, LG)) / n_plain
    sbm, sbb = _cloth_bound(h_win, LG, 1, n)
    tw_ms = _best_ms(lambda: cloth_tiled_kernel.multi_step_window_kernel(
        *win, None, None, p, DT, n, row0, LG)) / n
    tr_ms = _best_ms(lambda: cloth_kernel.multi_step_window(
        *win, None, None, p, DT, n, row0, LG)) / n
    tr2_ms = _best_ms(lambda: cloth_kernel.multi_step_window(
        *win, None, None, p, DT, 2, row0, LG)) / 2
    tpl_ms = _best_ms(lambda: cloth_tiled_kernel.multi_step_window_plain(
        *win, None, None, p, DT, n_plain, row0, LG)) / n_plain
    # K1w on the rows window, beside K6w
    res["k1w"] = {"ms": sw_ms, "plain_ms": spl_ms, "bound_ms": sbm / n,
                  "bound_by": sbb, "rows": h_win,
                  "window_1024": {"ms": w_ms, "k1_ms": k1_ms, "k6_ms": k6_ms,
                                  "plain_ms": pl_ms, "bound_ms": bm / n,
                                  "bound_by": bb}}
    # the kernels line takes the main path's kernel and shape: K6w on one
    # rows shard's window
    res["k6w"] = {"ms": tw_ms, "routed_ms": tr_ms, "routed_2_ms": tr2_ms,
                  "plain_ms": tpl_ms, "bound_ms": sbm / n, "bound_by": sbb,
                  "rows": h_win, "k1w_ms": sw_ms,
                  "schedule": cloth_tiled_kernel.pick_schedule(h_win, LG, n)}
    print(f"phase 6 cloth_tiled_window (K6w) on a rows shard's window "
          f"{h_win}x{LG}, schedule {res['k6w']['schedule']} [{card}]: "
          f"{tw_ms:.5f} ms a launch (a substep, {n} back to back); the "
          f"routed multi_step_window {tr_ms:.5f} ms a substep over {n}, "
          f"{tr2_ms:.5f} in the path's calls of 2; K1w there {sw_ms:.5f} "
          f"(K6w {sw_ms / tw_ms:.3f}x it); plain {tpl_ms:.5f}; bound "
          f"{sbm / n:.5f} ms ({sbb}), K6w at {sbm / n / tw_ms:.4f} of it")
    # the composed run's shard: a (2, 2) worlds x rows mesh cuts each GRID²
    # world into 2 bands of rows, a window with the 2·k halo rows of k = 2
    # (the run calls K1w k substeps at a time; the kernel's time a launch is
    # timed over n back to back, as on the rows shard, since a call of 2 is
    # bound by the wrapper's host work)
    cg = ClothConfig(height=GRID, width=GRID)
    sg = init_cloth_state(cg, device=dev)
    pg = ClothParams.from_config(cg, device=dev)
    k_c, half = 2, GRID // 2
    c_row0 = half - 2 * k_c
    c_win = [_window_of(a, c_row0, GRID + 2 * k_c, GRID)
             for a in (sg.pos, sg.vel)]
    c_ms = _best_ms(lambda: cloth_kernel.multi_step_window_kernel(
        *c_win, None, None, pg, DT, n, c_row0, GRID)) / n
    cr2_ms = _best_ms(lambda: cloth_kernel.multi_step_window(
        *c_win, None, None, pg, DT, k_c, c_row0, GRID)) / k_c
    cpl_ms = _best_ms(lambda: cloth_kernel.multi_step_window_plain(
        *c_win, None, None, pg, DT, n_plain, c_row0, GRID)) / n_plain
    cbm, cbb = _cloth_bound(half + 4 * k_c, GRID, 1, k_c)
    cbm /= k_c
    c_err, c_eq = _k1w_composed_check(c_win, pg, k_c, c_row0, dev, card)
    # the path's launch: every window the card holds at once, the top and
    # bottom windows of MC_WORLDS worlds
    b_rows = [-2 * k_c, c_row0] * MC_WORLDS
    b_win = [torch.stack([_window_of(a, r, r + half + 4 * k_c, GRID)
                          for r in b_rows]) for a in (sg.pos, sg.vel)]
    b_ms = _best_ms(lambda: cloth_kernel.multi_step_window_kernel(
        *b_win, None, None, pg, DT, n, b_rows, GRID)) / n
    bpl_ms = _best_ms(lambda: cloth_kernel.multi_step_window_plain(
        *b_win, None, None, pg, DT, n_plain, b_rows, GRID)) / n_plain
    bbm, bbb = _cloth_bound(half + 4 * k_c, GRID, len(b_rows), k_c)
    bbm /= k_c
    res["k1w_composed"] = {"ms": c_ms, "routed_2_ms": cr2_ms,
                           "plain_ms": cpl_ms, "bound_ms": cbm,
                           "bound_by": cbb, "rows": half + 4 * k_c,
                           "max_abs_err": c_err, "bitwise_plain": c_eq,
                           "batch": {"windows": len(b_rows), "ms": b_ms,
                                     "plain_ms": bpl_ms, "bound_ms": bbm,
                                     "bound_by": bbb}}
    print(f"phase 6 cloth_step_window (K1w) on a composed shard's window "
          f"{half + 4 * k_c}x{GRID} (k = {k_c}), {n} substeps [{card}]: "
          f"{c_ms:.5f} ms a launch (a substep); the routed multi_step_window "
          f"in the path's calls of {k_c} {cr2_ms:.5f} ms a substep; plain "
          f"{cpl_ms:.5f}; bound {cbm:.5f} ms ({cbb}; the bytes once a call "
          f"of {k_c}); the path's launch, a batch of {len(b_rows)} such "
          f"windows: {b_ms:.5f} ms (plain {bpl_ms:.5f}), bound {bbm:.5f} ms "
          f"({bbb})")
    print(f"phase 6 cloth_step_window (K1w) @{LG}x{LG} window, {n} substeps "
          f"[{card}]: {w_ms:.5f} ms/substep; K1 {k1_ms:.5f}, K6 {k6_ms:.5f}; "
          f"plain {pl_ms:.5f}; bound {bm / n:.5f} ms ({bb}), K1w at "
          f"{bm / n / w_ms:.4f} of it; one shard's window {h_win}x{LG} "
          f"(k = 1): {sw_ms:.5f} ms/substep, plain {spl_ms:.5f}, bound "
          f"{sbm / n:.5f} ms ({sbb}), K1w at {sbm / n / sw_ms:.4f} of it")

    mesh = pmesh.make_mesh((MC_SHARDS,), ("rows",), [dev] * MC_SHARDS)
    rates = {}
    for k in (1, 2):
        ms = _best_ms(lambda: pmesh.spatial_multi_step(
            s, p, DT, MC_STEPS, mesh, substeps_per_exchange=k))
        rates[f"rows k={k}"] = LG * LG * MC_STEPS / (ms / 1e3)
    ms = _best_ms(lambda: cloth_kernel.multi_step(s, p, DT, MC_STEPS))
    rates["single K6"] = LG * LG * MC_STEPS / (ms / 1e3)
    cfg = _gr_configs()["default"]
    pile = granular.init_state(cfg, torch.Generator().manual_seed(0),
                               device=dev)
    grains = pmesh.make_mesh((MC_SHARDS,), ("grains",), [dev] * MC_SHARDS)
    for label, fn in (("grains", lambda: granular_mesh.multi_step_sharded(
            pile, cfg, GR_DT, GR_MS_STEPS, grains)),
                      ("single K10", lambda: granular.multi_step(
                          pile, cfg, GR_DT, GR_MS_STEPS))):
        ts = []
        for i in range(4):                     # a warm-up, then best of 3
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i:
                ts.append(time.perf_counter() - t0)
        rates[label] = GR_N * GR_MS_STEPS / min(ts)
    res["rates"] = rates
    print(f"phase 6 multi-device rates on {MC_SHARDS} shards of one card "
          f"[{card}] (particle-steps/s; cloth {LG}x{LG} x {MC_STEPS} "
          f"substeps, CUDA events; pile {GR_N} x {GR_MS_STEPS} substeps, "
          f"host clock; best of 3): "
          + ", ".join(f"{k} {v:.4e}" for k, v in rates.items()))
    res["trace"] = _mc_trace(s, p, mesh, card)
    return res


def _multi_device(dev, card):
    """Phase 21 and its phases 6 and 7: the checks of K1w, K6w and K10b,
    the counted main path, the timings and the trace. Returns the results
    and the three kernels' entries of the ``kernels`` line."""
    res = {}
    res["cloth_step_window"], win_err = _k1w_checks(dev, card)
    res["main"] = _phase21(dev, card)
    res["granular_step_sharded"], k10b_err = _k10b_checks(dev, card)
    res["times"] = t = _mc_times(dev, card)
    launches = res["main"]["launches"]
    k10b = res["granular_step_sharded"]
    tb = t["k1w_composed"]["batch"]
    kernels = [
        _kernel("cloth_step_window", "cloth_step.cu", "cloth_pallas.py:763",
                t["k1w_composed"]["max_abs_err"], tb["ms"], tb["plain_ms"],
                tb["bound_ms"], tb["bound_by"], [
                    _site(f"composed worlds x rows, {GRID}² worlds, "
                          f"{tb['windows']} windows a launch",
                          launches["cloth_step_window"], tb["ms"],
                          tb["bound_ms"])]),
        _kernel("cloth_tiled_window", "cloth_tiled.cu", "cloth_pallas.py:763",
                win_err["k6w"], t["k6w"]["ms"], t["k6w"]["plain_ms"],
                t["k6w"]["bound_ms"], t["k6w"]["bound_by"], [
                    _site(f"rows, a shard's window of {LG}²",
                          launches["cloth_tiled_window"], t["k6w"]["ms"],
                          t["k6w"]["bound_ms"])]),
        _kernel("granular_step_sharded", "granular_step.cu",
                "granular_pallas.py:707", k10b_err, k10b["ms"],
                k10b["plain_ms"], k10b["bound_ms"], k10b["bound_by"], [
                    _site(f"grains, a quarter of {GR_N}",
                          launches["granular_step_sharded"], k10b["ms"],
                          k10b["bound_ms"])]),
    ]
    return res, kernels


# ---------------------------------------------------------------------------
# Granular datagen, the differentiable render and the live view (22-24)
# ---------------------------------------------------------------------------

def _gg_config():
    from wgpu_physics_engine_torch.models import granular

    return granular.GranularConfig(num_particles=GG_N)


def _gg_frame(cfg, batches, cams, bases, codec_k):
    """One steady frame of every chunk of the granular datagen path
    (``datagen.encode_parts`` over ``granular_step_and_render``, the
    generator's own frame), from a copy of ``batches``, which is left as
    it is."""
    from wgpu_physics_engine_torch.parallel import datagen
    from wgpu_physics_engine_torch.parallel import datagen_granular as dgg

    return datagen.encode_parts(
        list(batches), lambda bi, b: dgg.granular_step_and_render(
            b, cfg, GR_DT, GG_STEPS, cams[bi], fb_size=DG_FB,
            base_fb=bases[bi]), codec_k)


def _gg_trace(cfg, batch, cams, base, card) -> dict:
    """Phase 7 for the granular datagen path: one torch.profiler trace of a
    steady frame of one chunk, with the codec, split into K10, the rest of
    the step (the rebuilds and the loop's glue), the raster, the rest of
    the render (binning, rays, the composite, the uint8 cast) and the
    codec; the device's idle share and its top ops. The trace itself
    (~50,000 events) stays under build/ only while it is read."""
    def classify(name, cat, owner):
        if "granular_step" in name:
            return "k10"
        if "sphere_raster" in name:
            return "raster"
        return {"datagen.step": "step_other", "datagen.render": "render_other",
                "datagen.codec": "codec"}.get(owner, "other")

    path = os.path.join(HERE, "build", "chip_smoke_granular",
                        "trace_granular_datagen_frame.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tr = _frame_trace(lambda: _gg_frame(cfg, [batch], [cams], [base], DG_K),
                      path, classify, ("k10", "step_other", "raster",
                                       "render_other", "codec", "other"))
    os.unlink(path)
    split = tr["split_us"]
    n_worlds = batch.state.pos.shape[0]
    print(f"phase 7 trace one granular datagen frame, a chunk of {n_worlds} "
          f"worlds with codec [{card}]: window {tr['window_us']:.1f} us "
          f"(host, profiled), device busy {tr['device_busy_us']:.1f} us in "
          f"{tr['device_ops']} device ops ({tr['device_ops'] / n_worlds:.1f} "
          f"a world); device time us: "
          + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
          + f"; device idle share {tr['idle_share']:.4f}; top device ops: "
          + "; ".join(f"{k} {v:.1f}" for k, v in tr["top_ops_us"]))
    _check(split["k10"] > 0 and split["raster"] > 0,
           f"granular datagen trace shows no K10 or raster time: {split}")
    return tr


def _phase22_granular_datagen(dev, card, cli_main) -> dict:
    """Phase 22: granular datagen at full size, counted: GG_WORLDS worlds
    of the CLI's 20,000-particle pile in chunks of GG_CHUNK, 3 frames of
    GG_STEPS substeps at 256x256 with randomized cameras and the codec;
    then the CLI's ``datagen --family granular`` (through the native
    writer) and ``decode``. Checks: two worlds equal ``granular.multi_step``
    with their materials bit for bit; every world's raw frame shows sand
    and box pixels; the decoded frames have the raw frames' shape. Then
    the times (a steady frame by CUDA events and by the host clock, ms per
    world, egress, peak memory; K10 and the raster a launch at this site
    with their bounds, each first held against its plain version on the
    inputs it is timed on: K10 on a world of the run with its materials,
    one substep and a rebuild block bit for bit; the raster on the first
    chunk's first, middle and last worlds under phase 4's contract) and a
    traced frame of one chunk."""
    import io

    import numpy as np
    import torch

    from wgpu_physics_engine_torch.core.state import ParticleState
    from wgpu_physics_engine_torch.models import granular
    from wgpu_physics_engine_torch.ops import granular_kernel as gk
    from wgpu_physics_engine_torch.ops import pixel_kernel, raster_kernel
    from wgpu_physics_engine_torch.parallel import codec
    from wgpu_physics_engine_torch.parallel import datagen_granular as dgg
    from wgpu_physics_engine_torch.render import camera as cam_mod

    cfg = _gg_config()
    worlds = dgg.randomized_granular_worlds(
        cfg, GG_WORLDS, torch.Generator().manual_seed(GG_SEED), device=dev)
    probes = [0, GG_WORLDS - 1]
    starts = [(ParticleState(worlds.state.pos[i].clone(),
                             worlds.state.vel[i].clone()),
               worlds.k_contact[i], worlds.gravity[i], worlds.restitution[i])
              for i in probes]
    gen_kw = dict(n_worlds=GG_WORLDS, n_frames=GG_FRAMES,
                  steps_per_frame=GG_STEPS, fb_size=DG_FB,
                  randomize_cameras=True, world_chunk=GG_CHUNK, codec_k=DG_K,
                  hz=1.0 / GR_DT, device=dev)
    scratch = os.path.join(HERE, "build", "chip_smoke_granular")
    dg_out, dg_dec = os.path.join(scratch, "enc"), os.path.join(scratch, "dec")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gk.LAUNCHES = 0
    raster_kernel.LAUNCHES = 0
    pixel_kernel.LAUNCHES_RAYS = 0
    pixel_kernel.LAUNCHES_EPILOGUE = 0
    t0 = time.perf_counter()
    frames, yields = [], []
    for _, enc, batches in dgg.generate_granular_dataset(
            cfg, generator=torch.Generator().manual_seed(GG_SEED + 1),
            worlds=worlds, **gen_kw):
        frames.append(enc)
        yields.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    gen_launches = {"granular_step": gk.LAUNCHES,
                    "sphere_raster": raster_kernel.LAUNCHES,
                    "pixel_rays": pixel_kernel.LAUNCHES_RAYS,
                    "flat_composite_rgb8": pixel_kernel.LAUNCHES_EPILOGUE}
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc = cli_main(["datagen", "--family", "granular", "--worlds",
                       str(GG_CLI_WORLDS), "--frames", "2", "--codec-k",
                       str(DG_K), "--random-cameras", "--outdir", dg_out,
                       "--device", "cuda"])
    torch.cuda.synchronize()
    launches = {"granular_step": gk.LAUNCHES,
                "sphere_raster": raster_kernel.LAUNCHES,
                "pixel_rays": pixel_kernel.LAUNCHES_RAYS,
                "flat_composite_rgb8": pixel_kernel.LAUNCHES_EPILOGUE}
    rc_dec = cli_main(["decode", "--indir", dg_out, "--outdir", dg_dec])
    n_chunks = -(-GG_WORLDS // GG_CHUNK)
    # the rays and the epilogue a launch each beside every raster launch
    # (the cached box frames take no rays)
    want_gen = {"granular_step": GG_WORLDS * GG_FRAMES * GG_STEPS,
                "sphere_raster": n_chunks * GG_FRAMES,
                "pixel_rays": n_chunks * GG_FRAMES,
                "flat_composite_rgb8": n_chunks * GG_FRAMES}
    want = {"granular_step": want_gen["granular_step"]
            + GG_CLI_WORLDS * 2 * GG_STEPS,
            "sphere_raster": want_gen["sphere_raster"] + 2,
            "pixel_rays": want_gen["pixel_rays"] + 2,
            "flat_composite_rgb8": want_gen["flat_composite_rgb8"] + 2}
    native_used = "shard writer native" in said.getvalue()
    print(f"phase 22 granular datagen path [{card}]: generate_granular_"
          f"dataset(GranularConfig(num_particles={GG_N}), n_worlds="
          f"{GG_WORLDS}, n_frames={GG_FRAMES}, steps_per_frame={GG_STEPS}, "
          f"fb_size={DG_FB}, randomize_cameras=True, codec_k={DG_K}, "
          f"world_chunk={GG_CHUNK}) {gen_s:.3f} s host clock (frames yielded "
          f"at {', '.join(f'{t:.3f}' for t in yields)} s), peak device "
          f"memory {peak / 2**30:.3f} GiB; launches {gen_launches}, expected "
          f"{want_gen}; CLI datagen --family granular rc {rc}, decode rc "
          f"{rc_dec}; launches with the CLI {launches}, expected {want}")
    for line in said.getvalue().splitlines():
        print(f"  cli: {line}")
    _check(rc == 0 and rc_dec == 0, f"granular CLI rc {rc} {rc_dec}")
    _check(native_used, "the granular CLI did not write through the native "
           "shard writer")
    _check(gen_launches == want_gen and launches == want,
           f"granular datagen launches {launches}, expected {want}")
    shape = (GG_WORLDS, DG_FB[0] // 8, DG_FB[1] // 8, 3, DG_K)
    _check(len(frames) == GG_FRAMES and all(
        f.shape == shape and f.dtype == np.int8 for f in frames),
        f"granular frames {[(f.shape, f.dtype) for f in frames]}")
    shards = sorted(os.listdir(dg_out))
    cli_shape = (GG_CLI_WORLDS,) + shape[1:]
    cli_ok = (shards == ["codec_meta.json", "frame_00000.npy",
                         "frame_00001.npy"]
              and all(np.load(os.path.join(dg_out, s)).shape == cli_shape
                      for s in shards[1:])
              and all(np.load(os.path.join(dg_dec, f"frame_0000{i}_rgb.npy"))
                      .shape == (GG_CLI_WORLDS,) + DG_FB + (3,)
                      for i in range(2)))
    _check(cli_ok, f"granular CLI shards {shards}")

    # check 1: two worlds against granular.multi_step, bit for bit
    end = torch.cat([b.state.pos for b in batches])
    end_v = torch.cat([b.state.vel for b in batches])
    exact = True
    for i, (s, kc, g, e) in zip(probes, starts):
        for _ in range(GG_FRAMES):
            s = granular.multi_step(s, cfg, GR_DT, GG_STEPS, k_contact=kc,
                                    gravity=g, restitution=e)
        exact &= bool(torch.equal(s.pos, end[i]) and torch.equal(s.vel,
                                                                 end_v[i]))
    finite = bool(torch.isfinite(end).all() and torch.isfinite(end_v).all())
    # checks 2 and 3: a raw frame of every world from the run's cameras
    _, cams, bases = dgg.granular_chunks(
        cfg, GG_WORLDS, torch.Generator().manual_seed(GG_SEED + 1), DG_FB,
        None, GG_CHUNK, True, worlds=worlds, device=dev)
    pixel = _pixel_chain(cams[0], bases[0],
                         batches[0].state.pos.transpose(1, 2),
                         float(cfg.radius), dgg.SAND, 22,
                         "the granular datagen chunk", card)
    raw = torch.cat(_gg_frame(cfg, batches, cams, bases, None))
    sand = (raw == torch.tensor([219, 166, 89], dtype=torch.uint8,
                                device=dev)).all(-1).sum((1, 2))
    box = (raw == torch.tensor([0, 0, 255], dtype=torch.uint8,
                               device=dev)).all(-1).sum((1, 2))
    dec = codec.decode(frames[-1])
    print(f"phase 22 checks: worlds {probes} == granular.multi_step with "
          f"their materials, {GG_FRAMES} x {GG_STEPS} substeps, bit for bit "
          f"{exact}; state finite {finite}; raw frame: sand px a world min "
          f"{int(sand.min())} mean {float(sand.float().mean()):.1f}, box px "
          f"a world min {int(box.min())} mean {float(box.float().mean()):.1f}"
          f"; decoded frame {dec.shape} {dec.dtype}, raw {tuple(raw.shape)} "
          f"{raw.dtype}")
    _check(exact, "a granular datagen world differs from granular.multi_step")
    _check(finite, "granular datagen state not finite")
    _check(int(sand.min()) > 0 and int(box.min()) > 0,
           f"a world's frame lacks sand or box pixels: {int(sand.min())} "
           f"{int(box.min())}")
    _check(tuple(dec.shape) == tuple(raw.shape) and dec.dtype == np.uint8,
           f"decoded {dec.shape} vs raw {tuple(raw.shape)}")

    # phase 6: the steady frame, ms per world, egress
    res = {"launches": launches, "generate_launches": gen_launches,
           "generate_s": gen_s, "yields_s": yields, "peak_bytes": peak,
           "cli_rc": [rc, rc_dec], "native_writer": native_used,
           "bitwise_multi_step": exact, "sand_px_min": int(sand.min()),
           "box_px_min": int(box.min()), "pixel_chain": pixel}
    out = {}
    for codec_k in (None, DG_K):
        ms = _best_ms(lambda: _gg_frame(cfg, batches, cams, bases, codec_k))
        host_s = _best_s(lambda: _gg_frame(cfg, batches, cams, bases,
                                           codec_k), reps=2)
        parts = _gg_frame(cfg, batches, cams, bases, codec_k)
        pinned = [torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                  for p in parts]

        def copy():
            for hb, p in zip(pinned, parts):
                hb.copy_(p, non_blocking=True)

        c_ms = _best_ms(copy)
        nbytes = sum(p.numel() * p.element_size() for p in parts)
        key = "raw" if codec_k is None else f"codec_k{codec_k}"
        out[key] = {"frame_ms": ms, "ms_per_world": ms / GG_WORLDS,
                    "host_s": host_s,
                    "host_ms_per_world": host_s * 1e3 / GG_WORLDS,
                    "egress_bytes": nbytes, "egress_ms": c_ms,
                    "egress_MBps": nbytes / 1e6 / (c_ms / 1e3),
                    "egress_MBps_of_frame": nbytes / 1e6 / host_s}
        print(f"phase 6 granular datagen steady frame {key} [{card}]: "
              f"{ms:.3f} ms for {GG_WORLDS} worlds = {ms / GG_WORLDS:.4f} "
              f"ms/world (CUDA events), host clock {host_s * 1e3:.3f} ms = "
              f"{host_s * 1e3 / GG_WORLDS:.4f} ms/world; egress "
              f"{nbytes / 1e6:.2f} MB into pinned memory in {c_ms:.3f} ms = "
              f"{nbytes / 1e6 / (c_ms / 1e3):.1f} MB/s, "
              f"{nbytes / 1e6 / host_s:.2f} MB/s at the frame rate")
    res["frame"] = out

    # K10 a launch on one world of the run (its last state), and the raster
    # a call on the first chunk's bins, each with its bound
    b0 = batches[0]
    st = ParticleState(b0.state.pos[0], b0.state.vel[0])
    grid, slabs, _ = granular.rebuild(st.pos, st.vel, cfg)
    prm = gk.kernel_params(cfg, GR_DT, dev, b0.k_contact[0], b0.gravity[0],
                           b0.restitution[0])
    p0, v0 = grid.sorted_pos, grid.sorted_vel
    # K10 against its plain version on these inputs (the world's own
    # materials in the parameter vector): one substep and a rebuild block,
    # bit for bit
    kp, kv = gk.substep_sorted_kernel(p0, v0, prm, slabs)
    pp, pv = gk.substep_sorted_plain(p0, v0, prm, slabs)
    k10_err = max(_maxdiff(kp, pp), _maxdiff(kv, pv))
    k10_eq = bool(torch.equal(kp, pp) and torch.equal(kv, pv))
    for _ in range(cfg.rebuild_every - 1):
        kp, kv = gk.substep_sorted_kernel(kp, kv, prm, slabs)
        pp, pv = gk.substep_sorted_plain(pp, pv, prm, slabs)
    torch.cuda.synchronize()
    k10_err = max(k10_err, _maxdiff(kp, pp), _maxdiff(kv, pv))
    k10_eq &= bool(torch.equal(kp, pp) and torch.equal(kv, pv))
    print(f"phase 22 granular_step (K10) vs plain on a datagen world @{GG_N} "
          f"with its materials [{card}]: 1 substep and a "
          f"{cfg.rebuild_every}-substep block, max abs {k10_err:.3e}, bitwise "
          f"{k10_eq}")
    _check(k10_eq, f"K10 on a granular datagen world differs from its plain "
           f"version: {k10_err}")
    # at 20,000 particles a launch is shorter than its wrapper's host work,
    # so its time is the device time queued behind a sleep; the call's
    # CUDA events, host work included, beside it
    k_ms = _queued_us(lambda: gk.substep_sorted_kernel(p0, v0, prm,
                                                       slabs)) / 1e3
    call_ms = _best_ms(lambda: gk.substep_sorted_kernel(p0, v0, prm, slabs))
    p_ms = _best_ms(lambda: gk.substep_sorted_plain(p0, v0, prm, slabs))
    r_ms = _best_ms(lambda: granular.rebuild(st.pos, st.vel, cfg))
    cand = gk.candidate_count(slabs, GG_N)
    touch = gk.touching_count(p0, prm, slabs)
    kb_ms, kb_by = _bound(GR_BYTES * GG_N, OPS_SLOT * cand + OPS_TOUCH * touch
                          + OPS_GR_PARTICLE * GG_N)
    w_ms = _best_ms(lambda: granular.multi_step(
        st, cfg, GR_DT, GG_STEPS, k_contact=b0.k_contact[0],
        gravity=b0.gravity[0], restitution=b0.restitution[0]))
    w_s = _best_s(lambda: granular.multi_step(
        st, cfg, GR_DT, GG_STEPS, k_contact=b0.k_contact[0],
        gravity=b0.gravity[0], restitution=b0.restitution[0]))
    res["k10"] = {"err": k10_err, "ms": k_ms, "call_ms": call_ms,
                  "plain_ms": p_ms,
                  "rebuild_ms": r_ms,
                  "candidates": cand, "touching": touch, "bound_ms": kb_ms,
                  "bound_by": kb_by, "world_step_ms": w_ms,
                  "world_step_host_ms": w_s * 1e3}
    print(f"phase 6 granular_step (K10) on a datagen world @{GG_N} [{card}]: "
          f"kernel {k_ms:.5f} ms/substep of device time (a call by CUDA "
          f"events, host work included, {call_ms:.5f}), plain {p_ms:.5f}, "
          f"bound "
          f"{kb_ms:.6f} ms ({kb_by}; {cand} candidate slots, {touch} "
          f"touching), kernel at {kb_ms / k_ms:.4f} of the bound; rebuild "
          f"{r_ms:.4f} ms; one world's frame step (multi_step, {GG_STEPS} "
          f"substeps) {w_ms:.4f} ms CUDA events, {w_s * 1e3:.4f} ms host "
          f"clock")
    cams0 = cams[0]
    eye, dirs = cam_mod.pixel_rays(cams0, *DG_FB)
    wins, ocb, _, rect = raster_kernel.tiled_prologue_batched(
        cams0.view[:, :3, :3], eye, b0.state.pos.transpose(1, 2),
        cfg.radius, cams0.znear, torch.tan(cams0.fovy_rad / 2.0),
        cams0.aspect, *DG_FB)
    r_cmp, r_err = _batched_raster_vs_plain(
        raster_kernel.sphere_raster_kernel(wins, ocb, rect, dirs,
                                           cams0.znear),
        ocb, dirs, cams0.znear, "phase 22 batched sphere_raster (granular "
        "datagen)")
    rs_ms = _best_ms(lambda: raster_kernel.sphere_raster_kernel(
        wins, ocb, rect, dirs, cams0.znear))
    rb_ms, rb_by, _ = _raster_bound(wins, rect, *DG_FB)
    res["raster"] = {"ms": rs_ms, "bound_ms": rb_ms, "bound_by": rb_by,
                     "vs_plain": r_cmp, "err": r_err}
    print(f"phase 6 batched sphere_raster {GG_CHUNK} worlds x {GG_N} "
          f"instances @{DG_FB[0]}x{DG_FB[1]} (granular datagen) [{card}]: "
          f"{rs_ms:.4f} ms, bound {rb_ms:.5f} ms ({rb_by})")
    res["trace"] = _gg_trace(cfg, batches[0], cams[0], bases[0], card)
    return res


def _card_tests():
    """``tests/test_torch_cuda.py`` (it imports no jax), loaded by path: the
    differentiable render's loss and tolerance come from there, so the card
    test and phase 23 hold the same contract."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_card_tests", os.path.join(HERE, "tests",
                                               "test_torch_cuda.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _phase23_diff_render(dev, card) -> dict:
    """Phase 23: the differentiable render on the card. The gradients of
    the instanced-sphere loss through K4 (32x48) and K2/K3 (32x128) against
    the CPU plain route on the same inputs; the frames keep the kernels'
    bits when a gradient is carried (that loss's frame, the flagship frame,
    a datagen frame); then ``examples/inverse_rendering.py``'s two stages,
    counted: the light under 20 degrees in 6 iterations and the gravity
    fit bracketing the truth through K4, K1 and the adjoint; and the
    example's sites held against their plain versions on the inputs they
    are timed on (K4 on its 48x64 frame, K1 over a segment at 16², the
    adjoint's walk back over the segment's trace: bit for bit, the
    parameter cotangent within phase 11's 1e-5) and timed with their
    bounds."""
    import numpy as np
    import torch

    from wgpu_physics_engine_torch.core.config import CameraConfig, ClothConfig
    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.examples import inverse_rendering as ir
    from wgpu_physics_engine_torch.models.scenes import ClothScene
    from wgpu_physics_engine_torch.ops import (cloth_grad_kernel, cloth_kernel,
                                               raster_kernel)
    from wgpu_physics_engine_torch.ops.cloth_kernel import _FAMILIES
    from wgpu_physics_engine_torch.parallel import datagen
    from wgpu_physics_engine_torch.render import camera as cam_mod
    from wgpu_physics_engine_torch import render as R

    tests = _card_tests()
    tol = tests.DIFF_RENDER_TOL
    res = {"grads": {}}
    centers = np.random.default_rng(0).uniform(-4.0, 4.0, (40, 3)).astype(
        np.float32)
    bits = True
    for h, w in DR_FRAMES:
        got = {}
        for key, d in (("cpu", "cpu"), ("cuda", dev)):
            cen = torch.tensor(centers, device=d, requires_grad=True)
            lp = torch.tensor([25.0, 18.0, 12.0], device=d,
                              requires_grad=True)
            fb, val = tests._render_loss(cen, lp, h, w, d)
            g_cen, g_lp = torch.autograd.grad(val, (cen, lp))
            got[key] = (float(val.detach()), g_cen.cpu().numpy(),
                        g_lp.cpu().numpy())
            if key == "cuda":
                with torch.no_grad():
                    ref, _ = tests._render_loss(cen, lp, h, w, d)
                bits &= bool(torch.equal(fb.color.detach(), ref.color)
                             and torch.equal(fb.depth.detach(), ref.depth))
        (lc, gc, gl), (lk, gk_, glk) = got["cpu"], got["cuda"]
        dev_c = float(np.abs(gk_ - gc).max() / np.abs(gc).max())
        dev_l = float(np.abs(glk - gl).max() / np.abs(gl).max())
        route = "K4" if h % 16 or w % 128 else "K2/K3"
        finite = bool(np.isfinite(gk_).all() and np.isfinite(glk).all())
        res["grads"][f"{h}x{w}"] = {"route": route, "loss_cpu": lc,
                                    "loss_cuda": lk, "dev_centers": dev_c,
                                    "dev_light": dev_l, "finite": finite}
        print(f"phase 23 diff render @{h}x{w} ({route}) [{card}]: loss card "
              f"{lk:.9f} cpu {lc:.9f}; centre gradients largest deviation "
              f"{dev_c:.3e} of the largest (tol {tol}), light {dev_l:.3e} "
              f"(tol {tol}); finite {finite}")
        _check(finite and abs(lk - lc) <= 1e-5 * abs(lc)
               and dev_c <= tol and dev_l <= tol,
               f"card gradients off the CPU route's at {h}x{w}: "
               f"{res['grads'][f'{h}x{w}']}")

    # the flagship frame and a cloth datagen frame keep their bits when the
    # centres carry a gradient (the recompute adds zero)
    scene = ClothScene(ClothConfig(height=GRID, width=GRID), device=dev)
    scene.simulate(3.0)
    fh, fw = FRAME
    scene.resize(fw, fh)
    img = torch.from_numpy(scene.render(fh, fw))
    cam = scene.camera()
    fb = R.draw_globe(R.clear(fh, fw, device=dev), cam,
                      float(scene.params.globe_radius), scene.globe_texture,
                      scene.light)
    fb = R.draw_instanced_spheres(
        fb, cam, scene.state.pos.reshape(3, -1).T.clone().requires_grad_(),
        float(scene.params.particle_radius), flat_color=scene.particle_color)
    flag_eq = bool(torch.equal(
        torch.clamp(fb.color.detach(), 0.0, 1.0).cpu(), img))
    wb = datagen.randomized_worlds(ClothConfig(), 16,
                                   torch.Generator().manual_seed(3),
                                   device=dev)
    cams = datagen.randomized_cameras(16, torch.Generator().manual_seed(4),
                                      device=dev)
    tex = datagen.globe_texture(dev)
    base = datagen.globe_base_fbs(cams, wb.params, tex, fb_size=DG_FB)
    cen = wb.state.pos.reshape(16, 3, -1).transpose(1, 2)
    plain = R.draw_instanced_spheres(base, cams, cen,
                                     wb.params.particle_radius)
    withg = R.draw_instanced_spheres(base, cams, cen.clone().requires_grad_(),
                                     wb.params.particle_radius)
    dg_eq = bool(torch.equal(plain.color, withg.color.detach())
                 and torch.equal(plain.depth, withg.depth.detach()))
    print(f"phase 23 frames with a gradient carried == without, bit for bit: "
          f"the loss frames {bits}, the flagship {GRID}² frame {flag_eq}, a "
          f"datagen frame of 16 worlds {dg_eq}")
    _check(bits and flag_eq and dg_eq, "a frame changed under autograd")
    res.update(frames_bitwise=bits, flagship_bitwise=flag_eq,
               datagen_bitwise=dg_eq)

    # the example, counted
    torch.cuda.synchronize()
    cloth_kernel.LAUNCHES = 0
    cloth_grad_kernel.LAUNCHES = 0
    raster_kernel.LAUNCHES = 0
    raster_kernel.LAUNCHES_UNTILED = 0
    t0 = time.perf_counter()
    err = ir.recover_light(n_iters=6, device=dev)
    light_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g, g_true = ir.recover_gravity(device=dev)
    torch.cuda.synchronize()
    grav_s = time.perf_counter() - t0
    launches = {"cloth_step": cloth_kernel.LAUNCHES,
                "cloth_substep_vjp": cloth_grad_kernel.LAUNCHES,
                "sphere_raster_untiled": raster_kernel.LAUNCHES_UNTILED,
                "sphere_raster": raster_kernel.LAUNCHES}
    print(f"phase 23 python -m wgpu_physics_engine_torch.examples."
          f"inverse_rendering stages [{card}]: recover_light(n_iters=6) "
          f"direction error {err:.3f} deg (< 20) in {light_s:.3f} s; "
          f"recover_gravity() {g:.5f} (true {g_true}, |error| "
          f"{abs(g - g_true):.5f} <= 0.01) in {grav_s:.3f} s host clock; "
          f"launches {launches}")
    _check(err < 20.0, f"light direction error {err}")
    _check(abs(g - g_true) <= 0.01, f"gravity {g} does not bracket {g_true}")
    _check(launches["cloth_step"] > 0 and launches["cloth_substep_vjp"] > 0
           and launches["sphere_raster_untiled"] > 0
           and launches["sphere_raster"] == 0,
           f"the example's kernels launched {launches}")
    res.update(light_err_deg=err, gravity=g, launches=launches,
               light_s=light_s, gravity_s=grav_s)

    # the example's sites: K4 on its 48x64 frame of 256 spheres, K1 and the
    # adjoint at 16²
    c = ClothConfig(height=16, width=16)
    params = ClothParams.from_config(c, device=dev)
    s0 = init_cloth_state(c, device=dev)
    st = cloth_kernel.multi_step(s0, params._replace(
        gravity=torch.tensor(g_true, device=dev)), DT, 240)
    h, w = 48, 64
    ecam = cam_mod.make_camera(CameraConfig(target=(0.0, 36.0, 0.0),
                                            radius=30.0), aspect=w / h,
                               device=dev)
    eye, dirs = cam_mod.pixel_rays(ecam, h, w)
    ocb = raster_kernel.untiled_prologue(eye, st.pos.reshape(3, -1).T, 0.6)
    # the example's launches are short: device time queued behind a sleep
    k4_ms = _queued_us(lambda: raster_kernel.sphere_raster_untiled_kernel(
        ocb, dirs, ecam.znear)) / 1e3
    k4_plain = _best_ms(lambda: raster_kernel.sphere_raster_untiled_plain(
        ocb, dirs, ecam.znear))
    # each site's kernel against its plain version on these inputs, bit
    # for bit: K4 on the frame, K1 over a segment, the adjoint's walk back
    # over the segment's trace
    kt, ki = raster_kernel.sphere_raster_untiled_kernel(ocb, dirs, ecam.znear)
    pt, pi = raster_kernel.sphere_raster_untiled_plain(ocb, dirs, ecam.znear)
    both = (ki >= 0) & (pi >= 0)
    k4_err = _maxdiff(kt[both], pt[both]) if bool(both.any()) else 0.0
    k4_eq = bool(torch.equal(ki, pi) and torch.equal(kt, pt))
    k1 = cloth_kernel.multi_step_kernel(s0, params, DT, FIT_SEG)
    p1 = cloth_kernel.multi_step_plain(s0, params, DT, FIT_SEG)
    k1_err = max(_maxdiff(k1.pos, p1.pos), _maxdiff(k1.vel, p1.vel))
    k1_eq = bool(torch.equal(k1.pos, p1.pos) and torch.equal(k1.vel, p1.vel))
    prm = cloth_kernel._pack_params(params, DT).to(dev)
    traj = cloth_kernel.trace(s0, prm, FIT_SEG)
    cp, cv = (torch.randn((3, 16, 16), generator=torch.Generator()
                          .manual_seed(6 + i)).to(dev) for i in range(2))
    kw = cloth_grad_kernel._walk_kernel(traj, cp, cv, prm, None)
    pw = cloth_grad_kernel._walk_plain(traj, cp, cv, prm, None)
    torch.cuda.synchronize()
    vjp_err = max(_maxdiff(a, b) for a, b in zip(kw[:3], pw[:3]))
    vjp_eq = bool(torch.equal(kw[0], pw[0]) and torch.equal(kw[1], pw[1]))
    vjp_rel = _max_rel(kw[2], pw[2])
    hits = int((ki >= 0).sum())
    print(f"phase 23 the example's sites vs their plain versions [{card}]: "
          f"K4 @{h}x{w}, {ocb.shape[1]} instances, {hits} hits, tmin "
          f"{k4_err:.3e}, bitwise {k4_eq}; K1 @16x16, {FIT_SEG} substeps, "
          f"{k1_err:.3e}, bitwise {k1_eq}; the adjoint's walk of {FIT_SEG} "
          f"substeps @16x16, max abs {vjp_err:.3e}, state cotangents bitwise "
          f"{vjp_eq}, ct_prm max-relative {vjp_rel:.3e} (<=1e-5, phase 11)")
    _check(hits > 0, "the example's K4 frame shows no hit")
    _check(k4_eq and k1_eq and vjp_eq and vjp_rel <= 1e-5,
           f"an example's site differs from its plain version: K4 {k4_eq}, "
           f"K1 {k1_eq}, the adjoint {vjp_eq} {vjp_rel}")
    n_inst = ocb.shape[1]
    k4_b, k4_by = _bound(3 * h * w * 4 + 2 * h * w * 4 + 16 * n_inst,
                         float(h * w) * n_inst * OPS_DISC
                         + OPS_HIT * _disc_pairs(ocb, dirs))
    k1_ms = _queued_us(lambda: cloth_kernel.multi_step_kernel(
        s0, params, DT, FIT_SEG)) / 1e3 / FIT_SEG
    k1_b, k1_by = _cloth_bound(16, 16, 1, 1)
    vjp_ms = _queued_us(lambda: cloth_grad_kernel._walk_kernel(
        traj, cp, cv, prm, None)) / 1e3 / FIT_SEG
    edges = sum((16 - dr) * (16 - abs(dc)) for dr, dc, _ in _FAMILIES)
    vjp_b, vjp_by = _bound(VJP_BYTES * 256, OPS_VJP_EDGE * edges
                           + OPS_VJP_PARTICLE * 256)
    res["sites"] = {
        "k4": {"err": k4_err, "ms": k4_ms, "plain_ms": k4_plain,
               "bound_ms": k4_b, "bound_by": k4_by},
        "k1": {"err": k1_err, "ms": k1_ms, "bound_ms": k1_b,
               "bound_by": k1_by},
        "vjp": {"err": vjp_err, "ms": vjp_ms, "bound_ms": vjp_b,
                "bound_by": vjp_by}}
    print(f"phase 6 inverse rendering sites, device time [{card}]: K4 "
          f"@{h}x{w}, {n_inst} "
          f"instances {k4_ms:.5f} ms (plain {k4_plain:.5f}), bound "
          f"{k4_b:.6f} ms ({k4_by}); K1 @16x16 {k1_ms:.6f} ms/substep, bound "
          f"{k1_b:.7f} ms ({k1_by}); the adjoint @16x16 {vjp_ms:.6f} "
          f"ms/substep, bound {vjp_b:.7f} ms ({vjp_by})")
    return res


def _phase24_live(card) -> dict:
    """Phase 24: ``cloth --live --seconds 1`` in a process with no terminal
    (stdin from /dev/null): ANSI frames on stdout and exit code 0."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "wgpu_physics_engine_torch", "cloth", "--live",
         "--seconds", "1", "--device", "cuda"], cwd=HERE,
        stdin=subprocess.DEVNULL, capture_output=True, text=True,
        timeout=300)
    s = time.perf_counter() - t0
    frames = proc.stdout.count("fps ")
    ansi = "\x1b[38;2;" in proc.stdout
    print(f"phase 24 cloth --live --seconds 1 without a terminal [{card}]: "
          f"rc {proc.returncode}, {frames} status lines, ANSI truecolor "
          f"{ansi}, {len(proc.stdout)} bytes in {s:.3f} s")
    _check(proc.returncode == 0 and ansi and frames == 20,
           f"live view: rc {proc.returncode}, frames {frames}, ansi {ansi}; "
           f"{proc.stderr[-2000:]}")
    return {"rc": proc.returncode, "frames": frames, "s": s}


# ---------------------------------------------------------------------------
# The differentiable rows path (phase 25)
# ---------------------------------------------------------------------------

def _rg_counters() -> dict:
    """The launch counters phase 25 reads: every cloth kernel of the
    multi-device paths, the window trace and both adjoint entries."""
    from wgpu_physics_engine_torch.ops import cloth_grad_kernel, cloth_kernel

    c = {k: v for k, v in _mc_counters().items()
         if k.startswith("cloth")}
    c["cloth_trace_window"] = cloth_kernel.LAUNCHES_WINDOW_TRACE
    c["cloth_substep_vjp"] = cloth_grad_kernel.LAUNCHES
    c["cloth_substep_vjp_window"] = cloth_grad_kernel.LAUNCHES_WINDOW
    return c


def _rg_reset() -> None:
    from wgpu_physics_engine_torch.ops import cloth_grad_kernel, cloth_kernel

    _mc_counters(reset=True)
    cloth_kernel.LAUNCHES_WINDOW_TRACE = 0
    cloth_grad_kernel.LAUNCHES = 0
    cloth_grad_kernel.LAUNCHES_WINDOW = 0


def _rg_cells(dev) -> dict:
    """Phase 21's two rows cells as (state, params, mesh, h_local): the
    composed one (MC_WORLDS worlds of the GRID² flagship, phase 21's
    seeded worlds, on a (2, 2) worlds × rows mesh: 136×256 windows at
    k = 2) and the rows one (the LG² cloth, top row pinned, on MC_SHARDS
    rows shards: 264×1024 windows, above the tiled limit). Both start
    with seeded velocities of 0.5·N(0, 1), which stretch the springs
    within the rollout: a cloth falling from rest keeps its springs at
    their rest length, and its loss does not depend on k."""
    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import (ClothParams, ClothState,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.parallel import datagen
    from wgpu_physics_engine_torch.parallel import mesh as pmesh

    c_fl = ClothConfig(height=GRID, width=GRID)
    fl = datagen.randomized_worlds(c_fl, MC_WORLDS,
                                   torch.Generator().manual_seed(21),
                                   device=dev)
    c_lg = ClothConfig(height=LG, width=LG)
    s_lg = init_cloth_state(c_lg, device=dev)
    pin = torch.zeros((LG, LG), dtype=torch.bool, device=dev)
    pin[0] = True
    g = torch.Generator().manual_seed(25)
    vel = [(0.5 * torch.randn(s.shape, generator=g)).to(dev)
           for s in (fl.state.vel, s_lg.vel)]
    s_lg = s_lg._replace(vel=vel[1])
    return {
        "composed": (ClothState(pos=fl.state.pos, vel=vel[0]),
                     ClothParams.from_config(c_fl, device=dev),
                     pmesh.make_mesh((2, 2), ("worlds", "rows"), [dev] * 4),
                     GRID // 2),
        "rows": (s_lg._replace(pin_mask=pin, pin_pos=s_lg.pos),
                 ClothParams.from_config(c_lg, device=dev),
                 pmesh.make_mesh((MC_SHARDS,), ("rows",), [dev] * MC_SHARDS),
                 LG // MC_SHARDS)}


def _rg_rollout(state, params, mesh, log_k, how: str = "sharded"):
    """RG_STEPS substeps with ``k_struct = exp(log_k)``: through the rows
    path on ``mesh`` (a batch on the composed mesh, one cloth on the rows
    one), or with ``how="whole"`` world by world on the whole grid
    (``cloth_grad_kernel.multi_step``: K1 or K6r forward, the whole-grid
    adjoint)."""
    import torch

    from wgpu_physics_engine_torch.core.state import ClothState
    from wgpu_physics_engine_torch.ops import cloth_grad_kernel
    from wgpu_physics_engine_torch.parallel import mesh as pmesh

    p = params._replace(k_struct=torch.exp(log_k))
    if how == "whole":
        if state.pos.ndim == 3:
            return cloth_grad_kernel.multi_step(state, p, DT, RG_STEPS).pos
        return torch.stack([cloth_grad_kernel.multi_step(
            ClothState(state.pos[b], state.vel[b]), p, DT, RG_STEPS).pos
            for b in range(state.pos.shape[0])])
    if state.pos.ndim == 3:
        return pmesh.spatial_multi_step(state, p, DT, RG_STEPS, mesh,
                                        substeps_per_exchange=RG_K).pos
    return pmesh.batched_spatial_multi_step(state, p, DT, RG_STEPS, mesh,
                                            substeps_per_exchange=RG_K).pos


def _rg_value_and_grad(state, params, mesh, target, how: str = "sharded"):
    """The trajectory-matching loss ``mean((pos − target)²)`` at
    ``k_struct = RG_K_OFF · k_true`` (a 0-d tensor, not synchronised) and
    its gradients in log k_struct and in pos0."""
    import torch

    log_k = torch.log(RG_K_OFF * params.k_struct).detach().requires_grad_(
        True)
    pos0 = state.pos.detach().clone().requires_grad_(True)
    out = _rg_rollout(state._replace(pos=pos0), params, mesh, log_k, how)
    loss = torch.mean((out - target) ** 2)
    g_k, g_pos = torch.autograd.grad(loss, (log_k, pos0))
    return loss.detach(), g_k, g_pos


def _rg_batches(dev) -> list:
    """The batches of windows phase 25 (c) holds the batched window kernels
    on, the rows path's at k = RG_K, as (label, h_global, params, windows
    ``(pos, vel, pin_mask, pin_pos)`` each ``[B, ...]``, first rows): the
    training example's 16 windows of one block (its 8 worlds' top and
    bottom windows, row0 -4 and 4, each spanning the whole 16² grid with 4
    dead rows) at its start and after half its rollout, worlds 0-3 with
    the top row pinned and worlds 4-7 with a zero mask; the composed
    cell's 16 windows of 136×256 (8 worlds × 2 rows shards: the draped
    GRID² cloth pinned (``_k6_states``) in the even worlds, the fresh one
    with seeded velocities and a zero mask in the odd); and the rows
    cell's 4 windows of 264×1024 of the draped LG² cloth, pinned."""
    import torch

    from wgpu_physics_engine_torch.examples import multichip_training as mt

    halo = 2 * RG_K

    def windows(worlds, row0, rows, hg):
        """[B, ...] windows of (state, pinned) worlds, the world outer."""
        out = []
        for a in ("pos", "vel", "pin_mask", "pin_pos"):
            parts = []
            for st, pinned in worlds:
                x = getattr(st, a)
                if a == "pin_mask" and not pinned:
                    x = torch.zeros_like(x)
                parts += [_window_of(x, r, r + rows, hg) for r in row0]
            out.append(torch.stack(parts))
        return out

    cases = []
    m, _, ex_params, ex = mt.make_problem(device=dev)
    mid = mt.rollout(ex, ex_params, m, mt.N_STEPS // 2)
    h_ex = ex.pos.shape[-2]
    row0 = [-halo, h_ex // 2 - halo]
    for label, s in (("start", ex), (f"substep {mt.N_STEPS // 2}", mid)):
        pin = torch.zeros(s.pos.shape[-2:], dtype=torch.bool, device=dev)
        pin[0] = True
        worlds = [(s._replace(pos=s.pos[j], vel=s.vel[j], pin_mask=pin,
                              pin_pos=s.pos[j]), j < 4)
                  for j in range(s.pos.shape[0])]
        cases.append((f"example {label}", h_ex, ex_params,
                      windows(worlds, row0, h_ex // 2 + 2 * halo, h_ex),
                      row0 * len(worlds)))
    g = torch.Generator().manual_seed(26)
    for cell, hg, h_local, n_worlds in (("composed", GRID, GRID // 2,
                                         MC_WORLDS),
                                        ("rows", LG, LG // MC_SHARDS, 1)):
        params, states = _k6_states(hg, hg, dev)
        worlds = []
        for j in range(n_worlds):
            if j % 2 == 0:
                worlds.append((states["draped"], True))
            else:
                f = states["fresh"]
                worlds.append((f._replace(vel=(0.5 * torch.randn(
                    f.vel.shape, generator=g)).to(dev)), False))
        row0 = [i * h_local - halo for i in range(hg // h_local)]
        cases.append((cell, hg, params,
                      windows(worlds, row0, h_local + 2 * halo, hg),
                      row0 * n_worlds))
    return cases


def _rg_window_checks(dev, card):
    """Phase 25 (c): on each batch of ``_rg_batches`` at k = RG_K, the
    batched kernels against their batched plain versions: ``trace_window``
    (K1w's body, one launch a substep) ≡ ``trace_window_plain`` and its
    state RG_K ≡ the routed ``multi_step_window`` (K1w, one launch a
    substep; K6w a window at a time on the LG² windows), bit for bit; the
    window adjoint over the RG_K substeps (one launch a substep) against
    ``_walk_plain`` on a random cotangent: state, pin and parameter
    cotangents bit for bit (the plain version sums the last in the
    kernel's order; held within 1e-5 relative and finite). Then each
    window alone (``B = 1`` calls, a zero mask as no pins, so the batch's
    PINS instantiation on a zero mask is held to PINS = false): its trace,
    forward and state and pin cotangents equal the batch's bit for bit,
    and the batch's parameter cotangent is within 1e-5 of max|g| of the
    windows' sum. Returns the results and the two kernels' largest
    differences from their plain versions."""
    import numpy as np
    import torch

    from wgpu_physics_engine_torch.ops import cloth_grad_kernel, cloth_kernel

    res, err = {}, {"trace": 0.0, "adjoint": 0.0}
    for label, hg, params, win, row0 in _rg_batches(dev):
        prm = cloth_kernel._pack_params(params, DT)
        n, rows = len(row0), win[0].shape[-2]
        traj = cloth_kernel.trace_window_kernel(*win, prm, RG_K + 1, row0,
                                                hg)
        fwd = cloth_kernel.multi_step_window(*win, params, DT, RG_K, row0,
                                             hg)
        plain = cloth_kernel.trace_window_plain(*win, prm, RG_K + 1, row0,
                                                hg)
        rng = np.random.default_rng(hg + n)
        cp, cv = (torch.tensor(rng.standard_normal((n, 3, rows, hg))
                               .astype(np.float32), device=dev)
                  for _ in range(2))
        pins = (win[2], win[3])
        got = cloth_grad_kernel._walk_kernel(traj[:RG_K], cp, cv, prm, pins,
                                             (row0, hg))
        ref = cloth_grad_kernel._walk_plain(traj[:RG_K], cp, cv, prm, pins,
                                            (row0, hg))
        torch.cuda.synchronize()
        eq_trace = bool(torch.equal(traj, plain)
                        and torch.equal(traj[RG_K, :, :3], fwd[0])
                        and torch.equal(traj[RG_K, :, 3:], fwd[1]))
        eq_state = all(bool(torch.equal(got[i], ref[i])) for i in (0, 1, 3))
        eq_param = bool(torch.equal(got[2], ref[2]))
        e_t = _maxdiff(traj, plain)
        e_s = max(_maxdiff(got[i], ref[i]) for i in (0, 1, 3))
        e_p = _maxdiff(got[2], ref[2])
        rel = e_p / float(ref[2].abs().max())
        finite = bool(torch.isfinite(got[2]).all())
        eq_one, g_sum, pinned = True, torch.zeros(16, dtype=torch.float64,
                                                  device=dev), 0
        for b, r in enumerate(row0):
            pins_b = (win[2][b], win[3][b]) if bool(win[2][b].any()) else None
            pinned += pins_b is not None
            one = (win[0][b], win[1][b], *(pins_b or (None, None)))
            t1 = cloth_kernel.trace_window_kernel(*one, prm, RG_K + 1, r, hg)
            f1 = cloth_kernel.multi_step_window(*one, params, DT, RG_K, r, hg)
            w1 = cloth_grad_kernel._walk_kernel(t1[:RG_K], cp[b], cv[b], prm,
                                                pins_b, (r, hg))
            eq_one &= bool(
                torch.equal(traj[:, b], t1) and torch.equal(fwd[0][b], f1[0])
                and torch.equal(fwd[1][b], f1[1])
                and torch.equal(got[0][b], w1[0])
                and torch.equal(got[1][b], w1[1])
                and (torch.equal(got[3][b], w1[3]) if pins_b is not None
                     else not bool(got[3][b].any())))
            g_sum += w1[2].double()
        rel_sum = _maxdiff(got[2], g_sum.float()) / float(g_sum.abs().max())
        key = f"{label}: {n} windows of {rows}x{hg}"
        res[key] = {"row0": row0, "windows_pinned": pinned,
                    "trace_err": e_t, "trace_bitwise": eq_trace,
                    "state_err": e_s, "state_bitwise": eq_state,
                    "param_err": e_p, "param_rel": rel,
                    "param_bitwise": eq_param, "each_window_bitwise": eq_one,
                    "param_rel_window_sum": rel_sum, "finite": finite}
        print(f"phase 25 batched window trace and window adjoint @{key} "
              f"(first rows {sorted(set(row0))}, {pinned} pinned, the rest "
              f"a zero mask, k = {RG_K}) [{card}]: trace vs plain and vs "
              f"multi_step_window bitwise {eq_trace}; the adjoint's state "
              f"and pin cotangents vs plain bitwise {eq_state}, its "
              f"parameter cotangent bitwise {eq_param} (max abs {e_p:.3e}, "
              f"relative {rel:.3e}), finite {finite}; each window's B = 1 "
              f"trace, forward and state and pin cotangents bitwise "
              f"{eq_one}, the batch's parameter cotangent within "
              f"{rel_sum:.3e} of max|g| of the windows' sum")
        _check(eq_trace, f"window trace {key} differs from its plain "
               f"version or the stepper")
        _check(eq_state, f"window adjoint {key}: state cotangents differ "
               f"from the plain version by {e_s}")
        _check(eq_param and rel <= 1e-5 and finite, f"window adjoint {key}: "
               f"parameter cotangent off its plain version by {rel} "
               f"(finite {finite})")
        _check(eq_one, f"window batch {key} differs from its windows' B = 1 "
               f"calls")
        _check(rel_sum <= 1e-5, f"window batch {key}: parameter cotangent "
               f"off the windows' sum by {rel_sum}")
        err["trace"] = max(err["trace"], e_t)
        err["adjoint"] = max(err["adjoint"], e_s, e_p)
    return res, err


def _rg_trace(fn, path, card, label: str) -> dict:
    """One traced value_and_grad (``_trace``): its window, the device's
    busy time and idle share, and the launches and µs of the window
    kernels (K1w, K6w, the window trace's K1w body, the window adjoint)."""
    dev_spans, host = _trace(fn, path)
    t0 = min([a for a, _ in host] + [a for a, _, _ in dev_spans])
    t1 = max([b for _, b in host] + [b for _, b, _ in dev_spans])
    busy = _union_us([(a, b) for a, b, _ in dev_spans])
    per = {}
    for name, key in (("K1w and its trace", "substep_kernel_window"),
                      ("K6w", "tiled_kernel"),
                      ("window adjoint", "vjp_substep"),
                      ("reduce_partials", "reduce_partials")):
        ds = [b - a for a, b, n in dev_spans if key in n]
        per[name] = {"launches": len(ds), "us": sum(ds)}
    res = {"window_us": t1 - t0, "device_busy_us": busy,
           "device_ops": len(dev_spans), "per_kernel": per,
           "idle_share": 1.0 - busy / (t1 - t0)}
    print(f"phase 7 trace value_and_grad, {label} [{card}]: window "
          f"{t1 - t0:.1f} us (host, profiled), device busy {busy:.1f} us in "
          f"{len(dev_spans)} device ops; "
          + ", ".join(f"{k} {v['launches']} launches {v['us']:.1f} us"
                      for k, v in per.items())
          + f"; device idle share {res['idle_share']:.4f}")
    return res


def _rg_kernel_times(dev, card) -> dict:
    """Phase 6 for phase 25's sites, each timed on the batch of windows the
    path gives one launch (the top and the bottom windows of the fresh
    cloth, repeated): the example's 16 of 16×16, the composed cell's 16 of
    136×256, the rows cell's 4 of 264×1024. At each, the window trace a
    launch (CUDA events over RG_STEPS launches) beside its plain version
    and bound, and the window adjoint a launch (a substep; a walk of
    RG_STEPS) beside the whole-grid adjoint on a grid of one window's
    rows, in turns within the call, its plain version and bound; K1w a
    launch on the example's and the composed cell's batch (the rows cell
    takes K6w, a window a launch: phase 21's time)."""
    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.ops import cloth_grad_kernel, cloth_kernel

    halo = 2 * RG_K
    res = {}
    g = torch.Generator().manual_seed(25)
    for name, hg, h_local, n_worlds in (("example", 16, 8, 8),
                                        ("composed", GRID, GRID // 2,
                                         MC_WORLDS),
                                        ("rows", LG, LG // MC_SHARDS, 1)):
        c = ClothConfig(height=hg, width=hg)
        s = init_cloth_state(c, device=dev)
        p = ClothParams.from_config(c, device=dev)
        prm = cloth_kernel._pack_params(p, DT)
        rows = h_local + 2 * halo
        row0 = [i * h_local - halo for _ in range(n_worlds)
                for i in range(hg // h_local)]
        nb = len(row0)
        win = [torch.stack([_window_of(a, r, r + rows, hg) for r in row0])
               for a in (s.pos, s.vel)]
        n = RG_STEPS
        tr_ms = _best_ms(lambda: cloth_kernel.trace_window_kernel(
            *win, None, None, prm, n + 1, row0, hg)) / n
        n_plain = 4
        trp_ms = _best_ms(lambda: cloth_kernel.trace_window_plain(
            *win, None, None, prm, n_plain + 1, row0, hg)) / n_plain
        masks = cloth_kernel._window_masks(rows, hg, row0, hg, dev)
        edges = sum(int(m.sum()) for m in masks)
        parts = nb * rows * hg
        # the trace's bytes: the start states read, a state written a
        # substep
        tb, tby = _bound(24.0 * parts * (n + 1),
                         n * (OPS_EDGE * edges + OPS_PARTICLE * parts))
        traj = cloth_kernel.trace_window_kernel(*win, None, None, prm, n,
                                                row0, hg)
        cp, cv = (torch.randn((nb, 3, rows, hg), generator=g).to(dev)
                  for _ in range(2))
        one = traj[:, 0].contiguous()
        ws, gs = [], []
        for _ in range(2):                       # in turns: W G G W
            ws.append(_best_ms(lambda: cloth_grad_kernel._walk_kernel(
                traj, cp, cv, prm, None, (row0, hg))) / n)
            gs.append(_best_ms(lambda: cloth_grad_kernel._walk_kernel(
                one, cp[0], cv[0], prm, None)) / n)
        w_ms, gw_ms = min(ws), min(gs)
        wp_ms = _best_ms(lambda: cloth_grad_kernel._walk_plain(
            traj[:n_plain], cp, cv, prm, None, (row0, hg))) / n_plain
        ab, aby = _bound(VJP_BYTES * parts,
                         OPS_VJP_EDGE * edges + OPS_VJP_PARTICLE * parts)
        res[name] = {"rows": rows, "w": hg, "windows": nb,
                     "trace": {"ms": tr_ms, "plain_ms": trp_ms,
                               "bound_ms": tb / n, "bound_by": tby},
                     "adjoint": {"ms": w_ms, "whole_grid_ms": gw_ms,
                                 "turns_ms": {"window": ws, "whole": gs},
                                 "plain_ms": wp_ms, "bound_ms": ab,
                                 "bound_by": aby}}
        k1w = ""
        if name != "rows":
            k_ms = _best_ms(lambda: cloth_kernel.multi_step_window_kernel(
                *win, None, None, p, DT, n, row0, hg)) / n
            kb, kby = _cloth_bound(rows, hg, nb, RG_K)
            res[name]["k1w"] = {"ms": k_ms, "bound_ms": kb / RG_K,
                                "bound_by": kby}
            k1w = (f"; K1w {k_ms:.5f} ms a launch, bound {kb / RG_K:.6f} ms "
                   f"({kby}; the bytes once a call of {RG_K})")
        del traj, one
        print(f"phase 6 window trace and window adjoint @{nb} windows of "
              f"{rows}x{hg} ({name}'s launch) [{card}]: trace {tr_ms:.5f} ms "
              f"a launch (plain {trp_ms:.5f}), bound {tb / n:.6f} ms "
              f"({tby}); window adjoint {w_ms:.5f} ms a launch, the "
              f"whole-grid adjoint on one window's {rows}x{hg} "
              f"{gw_ms:.5f} (in turns W G G W: "
              f"{', '.join(f'{a:.5f}/{b:.5f}' for a, b in zip(ws, gs))}), "
              f"plain {wp_ms:.5f}, bound {ab:.6f} ms ({aby}){k1w}")
    return res


def _phase25(dev, card, mc_times):
    """Phase 25: the differentiable rows path. (c) the batched K1w, window
    trace and window adjoint against their batched plain versions and
    against their windows' B = 1 calls on batches of the training
    example's and the two rows cells' windows (``_rg_window_checks``);
    then, with the counts set to
    0 just before and read just after, the main path: the port's
    ``examples/multichip_training.py`` at its defaults (8 shards of the
    card, 60 iterations; ``k_struct`` within 1% of the truth from 2× off)
    and one value_and_grad of each rows cell over RG_STEPS substeps (b),
    each count checked exactly (one window call a block for every window
    of the card); (d) each cell's gradients against the whole-grid adjoint
    within 1e-5 of max|g|; the value_and_grads timed by host clock and
    CUDA events, each traced once; phase 6 at each site. Returns the
    results, the two window kernels' entries, and the sites phase 25 adds
    to K1w's and K6w's (the rows window's K6w time from phase 21's
    ``mc_times``)."""
    import torch

    from wgpu_physics_engine_torch.examples import multichip_training as mt

    res = {}
    res["checks"], err = _rg_window_checks(dev, card)

    # ---- inputs and targets, not counted ----
    cells = _rg_cells(dev)
    targets = {}
    with torch.no_grad():
        for name, (s, p, m, _) in cells.items():
            targets[name] = _rg_rollout(s, p, m, torch.log(p.k_struct))
    torch.cuda.synchronize()

    # ---- the main path, counted ----
    _rg_reset()
    t0 = time.perf_counter()
    k, k_true = mt.main()
    torch.cuda.synchronize()
    ex_s = time.perf_counter() - t0
    after = {"example": _rg_counters()}
    vg = {}
    for name, (s, p, m, _) in cells.items():
        vg[name] = _rg_value_and_grad(s, p, m, targets[name])
        torch.cuda.synchronize()
        after[name] = _rg_counters()
    launches = after["rows"]
    site = {"example": after["example"]}
    site["composed"] = {n: after["composed"][n] - after["example"][n]
                        for n in launches}
    site["rows"] = {n: after["rows"][n] - after["composed"][n]
                    for n in launches}
    rel_k = abs(k - k_true) / k_true
    print(f"phase 25 examples/multichip_training.py (defaults: 8 shards of "
          f"the card, {mt.N_STEPS} substeps, 60 iterations) [{card}]: "
          f"recovered k_struct {k:.4f} (true {k_true:.1f}, started "
          f"{0.5 * k_true:.1f}; relative error {rel_k:.3e}), "
          f"{ex_s / 60 * 1e3:.3f} ms an iteration (host clock, the target "
          f"rollout included); launches K1w {site['example']['cloth_step_window']}, "
          f"window trace {site['example']['cloth_trace_window']}, window "
          f"adjoint {site['example']['cloth_substep_vjp_window']}")
    print(f"phase 25 launches, the counted run [{card}]: {site}")
    _check(rel_k < 0.01, f"the example recovered k_struct {k}, not within "
           f"1% of {k_true}")

    # what the path predicts: one window call a block for every window of
    # the card. The example: a rollout of 8 blocks of 2 substeps (its 8
    # worlds x 2 rows shards in each call) for the target and each of the
    # 60 forwards, a trace launch and 2 adjoint launches a call in each
    # backward; a cell's value_and_grad, its blocks' calls of RG_K
    # substeps, and on the rows cell K6w a window at a time (RG_K launches
    # a window and call at k_sub = 1), its trace and adjoint one call
    ex_calls = mt.N_STEPS // mt.SUBSTEPS_PER_EXCHANGE
    k_ex = mt.SUBSTEPS_PER_EXCHANGE
    blocks = RG_STEPS // RG_K
    c_calls = blocks
    r_calls = blocks
    zero = {n: 0 for n in launches}
    exp = {"example": {**zero, "cloth_step_window": 61 * ex_calls * k_ex,
                       "cloth_trace_window": 60 * ex_calls * (k_ex - 1),
                       "cloth_substep_vjp_window": 60 * ex_calls * k_ex},
           "composed": {**zero, "cloth_step_window": c_calls * RG_K,
                        "cloth_trace_window": c_calls * (RG_K - 1),
                        "cloth_substep_vjp_window": c_calls * RG_K},
           "rows": {**zero, "cloth_tiled_window": MC_SHARDS * r_calls * RG_K,
                    "cloth_trace_window": r_calls * (RG_K - 1),
                    "cloth_substep_vjp_window": r_calls * RG_K}}
    _check(site == exp, f"phase 25 launches {site}, expected {exp}")
    res["example"] = {"k": k, "k_true": k_true, "rel_err": rel_k,
                      "s": ex_s, "ms_per_iter": ex_s / 60 * 1e3}
    res["launches"] = site

    # ---- (d) the sharded gradient against the whole-grid adjoint ----
    for name, (s, p, m, _) in cells.items():
        l_sh, gk_sh, gp_sh = vg[name]
        l_wh, gk_wh, gp_wh = _rg_value_and_grad(s, p, m, targets[name],
                                                "whole")
        l_sh, l_wh = float(l_sh), float(l_wh)
        e_k = float((gk_sh - gk_wh).abs()) / float(gk_wh.abs())
        e_p = _maxdiff(gp_sh, gp_wh) / float(gp_wh.abs().max())
        finite = bool(torch.isfinite(gp_sh).all() and torch.isfinite(gk_sh))
        res[f"{name}_grad"] = {"loss": l_sh, "loss_whole": l_wh,
                               "g_log_k": float(gk_sh),
                               "g_log_k_whole": float(gk_wh),
                               "rel_log_k": e_k, "rel_pos0": e_p,
                               "finite": finite}
        print(f"phase 25 value_and_grad {name} ({RG_STEPS} substeps, "
              f"k = {RG_K}) vs the whole-grid adjoint [{card}]: loss "
              f"{l_sh:.9e} vs {l_wh:.9e}; d/d log k {float(gk_sh):.9e} vs "
              f"{float(gk_wh):.9e} (relative {e_k:.3e}); d/d pos0 within "
              f"{e_p:.3e} of max|g| ({float(gp_wh.abs().max()):.3e}); "
              f"finite {finite}")
        _check(l_sh == l_wh, f"{name}: the sharded forward's loss differs "
               f"from the whole grid's")
        _check(e_k <= 1e-5 and e_p <= 1e-5 and finite,
               f"{name}: the sharded gradient is off the whole-grid adjoint "
               f"by {e_k} (log k), {e_p} (pos0), finite {finite}")

    # ---- (b) times and traces ----
    times = {}
    for name, (s, p, m, h_local) in cells.items():
        fn = lambda: _rg_value_and_grad(s, p, m, targets[name])  # noqa: E731
        host_s = _best_s(fn, reps=3)
        ev_ms = _best_ms(fn)
        n_part = (s.pos.shape[0] if s.pos.ndim == 4 else 1) * s.pos.shape[-2] \
            * s.pos.shape[-1]
        times[name] = {"host_s": host_s, "events_ms": ev_ms,
                       "psteps_per_s": n_part * RG_STEPS / host_s,
                       "trace": _rg_trace(
                           fn, os.path.join(OUT, f"trace_rows_grad_{name}.json"),
                           card, f"{name} ({RG_STEPS} substeps)")}
        print(f"phase 6 value_and_grad {name}, {RG_STEPS} substeps at k = "
              f"{RG_K} [{card}]: host clock {host_s * 1e3:.3f} ms (best of "
              f"3), CUDA events {ev_ms:.3f} ms = "
              f"{times[name]['psteps_per_s']:.4e} particle-steps/s")
    res["times"] = times
    kt = res["kernel_times"] = _rg_kernel_times(dev, card)

    def sites(kernel, key):
        return [_site(f"{lab}, {kt[n]['windows']} windows of "
                      f"{kt[n]['rows']}x{kt[n]['w']} a launch",
                      site[n][key], kt[n][kernel]["ms"],
                      kt[n][kernel]["bound_ms"])
                for n, lab in (("example", "the training example"),
                               ("composed", f"composed value_and_grad, "
                                            f"{GRID}² worlds"),
                               ("rows", f"rows value_and_grad, {LG}²"))]

    kernels = [
        _kernel("cloth_substep_vjp_window", "cloth_grad.cu",
                "cloth_pallas.py:763", err["adjoint"],
                kt["composed"]["adjoint"]["ms"],
                kt["composed"]["adjoint"]["plain_ms"],
                kt["composed"]["adjoint"]["bound_ms"],
                kt["composed"]["adjoint"]["bound_by"],
                sites("adjoint", "cloth_substep_vjp_window")),
        _kernel("cloth_trace_window", "cloth_step.cu", "cloth_pallas.py:763",
                err["trace"], kt["composed"]["trace"]["ms"],
                kt["composed"]["trace"]["plain_ms"],
                kt["composed"]["trace"]["bound_ms"],
                kt["composed"]["trace"]["bound_by"],
                sites("trace", "cloth_trace_window")),
    ]
    extra = {"cloth_step_window": [
        _site(f"the training example, {kt['example']['windows']} windows of "
              f"{kt['example']['rows']}x16 a launch",
              site["example"]["cloth_step_window"],
              kt["example"]["k1w"]["ms"], kt["example"]["k1w"]["bound_ms"]),
        _site(f"composed value_and_grad forward, {GRID}² worlds, "
              f"{kt['composed']['windows']} windows a launch",
              site["composed"]["cloth_step_window"],
              kt["composed"]["k1w"]["ms"],
              kt["composed"]["k1w"]["bound_ms"])],
        "cloth_tiled_window": [
        _site(f"rows value_and_grad forward, {LG}²",
              site["rows"]["cloth_tiled_window"], mc_times["k6w"]["ms"],
              mc_times["k6w"]["bound_ms"])]}
    return res, kernels, extra


def _site(name: str, launches: int, ms=None, bound_ms=None,
          substeps: float = 1) -> dict:
    """One main-path site of a kernel: its launches in this run, its ms
    and bound there a launch, or a substep for a kernel that runs
    ``substeps`` substeps a launch (K6r, K5r; None where this run does not
    time the shape), and the time it loses, launches × substeps × (ms −
    bound)."""
    lost = (None if ms is None or bound_ms is None
            else launches * substeps * (ms - bound_ms))
    return {"site": name, "launches": launches, "substeps_per_launch": substeps,
            "ms": ms, "bound_ms": bound_ms, "lost_ms": lost}


def _kernel(name: str, source: str, replaces, err: float, ms: float,
            plain_ms: float, bound_ms: float, bound_by: str,
            sites: list) -> dict:
    """A kernel's entry of the ``kernels`` line: its launches over its
    sites, and its time, plain version's time and bound at its first;
    ``replaces`` is the Pallas kernel's file and line, None for a kernel
    that replaces none (a chain that XLA fused on the TPU)."""
    return {"name": name, "route": "cuda",
            "source": f"wgpu_physics_engine_torch/ops/csrc/{source}",
            "replaces": (None if replaces is None
                         else f"wgpu_physics_engine_tpu/ops/{replaces}"),
            "launches": sum(x["launches"] for x in sites),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "sites": sites}


def _ranking(kernels, card) -> None:
    """Prints the kernels by the time they lose on the main paths, the sum
    of launches × (ms − bound) over their timed sites."""
    lost = sorted(((sum(x["lost_ms"] for x in k["sites"]
                        if x["lost_ms"] is not None), k) for k in kernels),
                  key=lambda e: -e[0])
    print(f"phase 6 ranking by launches x (ms - bound) [{card}]:")
    for total, k in lost:
        parts = "; ".join(
            f"{x['site']}: {x['launches']} x "
            + ("" if x["substeps_per_launch"] == 1 else
               f"{x['substeps_per_launch']:g} substeps x ")
            + ("(not timed)" if x["ms"] is None else
               f"({x['ms']:.5f} - {x['bound_ms']:.5f}) = "
               f"{x['lost_ms']:.1f} ms") for x in k["sites"])
        print(f"  {k['name']}: {total:.1f} ms lost ({parts})")


def main() -> int:
    import torch

    # ---- phase 1: the card ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on "
              "the card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 1 card: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")

    sys.path.insert(0, HERE)
    from wgpu_physics_engine_torch.core.config import CameraConfig, ClothConfig
    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.models.scenes import ClothScene
    from wgpu_physics_engine_torch.ops import (_build, cloth_grad_kernel,
                                               cloth_kernel,
                                               cloth_tiled_kernel,
                                               granular_kernel, pixel_kernel,
                                               raster_kernel)
    from wgpu_physics_engine_torch.parallel import datagen
    from wgpu_physics_engine_torch.render import camera as cam_mod
    from wgpu_physics_engine_torch.utils import viewer
    from wgpu_physics_engine_torch.__main__ import main as cli_main

    os.makedirs(OUT, exist_ok=True)
    results = {"card": card}

    # ---- phase 2: build the kernel libraries, one nvcc each, together ----
    libs = {"cloth_step": cloth_kernel._SIGNATURES,
            "sphere_raster": raster_kernel._SIGNATURES,
            "sphere_raster_untiled": raster_kernel._SIGNATURES_UNTILED,
            "cloth_grad": cloth_grad_kernel._SIGNATURES,
            "granular_step": granular_kernel._SIGNATURES,
            "cloth_tiled": cloth_tiled_kernel._SIGNATURES,
            "pixel_chain": pixel_kernel._SIGNATURES}
    build_s = {}

    def build(name):
        t = time.time()
        _build.build(name)
        build_s[name] = time.time() - t

    t0 = time.time()
    threads = [threading.Thread(target=build, args=(n,)) for n in libs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for name, sig in libs.items():
        _build.load(name, sig)         # raises if a build failed
    results["build_s"] = {**build_s, "all": time.time() - t0}
    print(f"phase 2 build (in parallel): " + ", ".join(
        f"{k} {v:.2f} s" for k, v in build_s.items())
        + f"; all {time.time() - t0:.2f} s (nvcc {_build.nvcc_path()})")
    for name in libs:
        with open(os.path.join(_build.lib_dir(name), "build.log")) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")

    # ---- phase 3: the cloth kernel vs its plain version, 256² pinned ----
    cfg = ClothConfig(height=GRID, width=GRID)
    params = ClothParams.from_config(cfg, device=dev)
    s0 = init_cloth_state(cfg, device=dev)
    pin = torch.zeros((GRID, GRID), dtype=torch.bool, device=dev)
    pin[0] = True
    s0 = s0._replace(pin_mask=pin, pin_pos=s0.pos)
    k1 = cloth_kernel.multi_step_kernel(s0, params, DT, 1)
    p1 = cloth_kernel.multi_step_plain(s0, params, DT, 1)
    e1 = max(_maxdiff(k1.pos, p1.pos), _maxdiff(k1.vel, p1.vel))
    k240 = cloth_kernel.multi_step_kernel(s0, params, DT, 240)
    p240 = cloth_kernel.multi_step_plain(s0, params, DT, 240)
    e240 = _maxdiff(k240.pos, p240.pos)
    e240v = _maxdiff(k240.vel, p240.vel)
    fast = cloth_kernel.multi_step_kernel(s0, params, DT, 330, fast_math=True)
    exact = cloth_kernel.multi_step_plain(s0, params, DT, 330)
    fast_p = cloth_kernel.multi_step_plain(s0, params, DT, 330, fast_math=True)
    ef = _maxdiff(fast.pos, exact.pos)
    efp = _maxdiff(fast.pos, fast_p.pos)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(k240.pos, p240.pos)
                   and torch.equal(k240.vel, p240.vel))
    print(f"phase 3 cloth_step vs plain @{GRID}x{GRID} pinned: 1 substep "
          f"{e1:.3e} (<=1e-6), 240 substeps pos {e240:.3e} (<=1e-5) vel "
          f"{e240v:.3e}, bitwise {bitwise}; fast_math vs exact after 330 "
          f"{ef:.3e} (<=1e-4), fast kernel vs fast plain {efp:.3e}")
    _check(e1 <= 1e-6, f"cloth 1 substep diff {e1}")
    _check(e240 <= 1e-5, f"cloth 240 substeps diff {e240}")
    _check(ef <= 1e-4, f"cloth fast_math diff {ef}")
    _check(efp <= 1e-6, f"cloth fast_math kernel vs fast plain diff {efp}")
    _check(torch.equal(k240.pos[:, 0], s0.pos[:, 0]), "pinned row moved")
    _check(bool(torch.isfinite(k240.pos).all()), "cloth state not finite")
    results["cloth_step"] = {"err_1": e1, "err_240_pos": e240,
                             "err_240_vel": e240v, "bitwise_240": bitwise,
                             "err_fast_vs_exact_330": ef,
                             "err_fast_vs_fast_plain_330": efp}

    # ---- phase 4: the raster kernel vs its plain version, 65,536 inst ----
    centers = k240.pos.reshape(3, -1).T
    look = CameraConfig(target=(0.0, 38.0, 0.0), radius=45.0, phi=0.6)
    r_err, r_cases = 0.0, {}
    for h, w in (FRAME, RAGGED):
        cam = cam_mod.make_camera(look, aspect=w / h, device=dev)
        eye, dirs = cam_mod.pixel_rays(cam, h, w)
        wins, ocb, _, rect = raster_kernel.tiled_prologue(
            cam.view[:3, :3], eye, centers, cfg.particle_radius, cam.znear,
            torch.tan(cam.fovy_rad / 2.0), cam.aspect, h, w)
        r_cases[f"{h}x{w}"] = _raster_vs_plain(
            wins, ocb, rect, dirs, cam.znear,
            f"phase 4 sphere_raster vs plain @{h}x{w}, {GRID * GRID} "
            f"instances", 0.05 * h * w)
        r_err = max(r_err, r_cases[f"{h}x{w}"]["err_tmin"],
                    r_cases[f"{h}x{w}"]["err_oc"])
    results["sphere_raster"] = r_cases

    # ---- phase 5: the main path, counted ----
    fh, fw = FRAME
    scene = ClothScene(cfg, device=dev)
    scene.resize(fw, fh)
    cli_png = os.path.join(OUT, "cloth_cli.png")
    torch.cuda.synchronize()
    cloth_kernel.LAUNCHES = 0
    raster_kernel.LAUNCHES = 0
    t0 = time.time()
    scene.simulate(5.0)
    torch.cuda.synchronize()
    sim_s = time.time() - t0
    img = scene.render(fh, fw)
    rc = cli_main(["cloth", "--grid", str(GRID), "--size", str(fh), str(fw),
                   "--seconds", "5", "--out", cli_png, "--device", "cuda"])
    torch.cuda.synchronize()
    launches = {"cloth_step": cloth_kernel.LAUNCHES,
                "sphere_raster": raster_kernel.LAUNCHES}
    print(f"phase 5 main path: ClothScene {GRID}x{GRID} simulate(5.0) "
          f"{sim_s:.3f} s host clock + render{FRAME} + CLI (rc {rc}); launches "
          f"{launches}")
    _check(rc == 0, f"CLI returned {rc}")
    _check(launches["cloth_step"] > 0 and launches["sphere_raster"] > 0,
           f"a kernel of the main path never launched: {launches}")
    viewer.save_png(img, os.path.join(OUT, "cloth.png"))

    pos = scene.state.pos
    _check(bool(torch.isfinite(pos).all()), "main-path state not finite")
    r = torch.linalg.norm(pos, dim=0)
    r_min_exp = cfg.globe_radius + cfg.particle_radius
    _check(abs(float(r.min()) - r_min_exp) <= 1e-3,
           f"r_min {float(r.min())} not at {r_min_exp}")
    ref = cloth_kernel.multi_step_plain(
        init_cloth_state(cfg, device=dev), scene.params, DT, 2400)
    rr = torch.linalg.norm(ref.pos, dim=0)
    stats = {
        "r_mean": (float(r.mean()), float(rr.mean())),
        "r_min": (float(r.min()), float(rr.min())),
        "y_mean": (float(pos[1].mean()), float(ref.pos[1].mean())),
    }
    rel = {k: abs(a - b) / abs(b) for k, (a, b) in stats.items()}
    print(f"phase 5 drape: kernel vs plain run {stats}; relative {rel} "
          f"(r 1e-3, y 2e-3)")
    _check(rel["r_mean"] <= 1e-3 and rel["r_min"] <= 1e-3,
           f"radius statistics off: {rel}")
    _check(rel["y_mean"] <= 2e-3, f"mean height off: {rel}")
    bg = torch.tensor([0.05, 0.05, 0.08])
    t_img = torch.from_numpy(img)
    red = int((t_img == torch.tensor([1.0, 0.0, 0.0])).all(-1).sum())
    n_bg = int(((t_img - bg).abs().amax(-1) < 1e-6).sum())
    globe = fh * fw - red - n_bg
    print(f"phase 5 image {fh}x{fw}: particle px {red}, globe px {globe}, "
          f"background px {n_bg}")
    _check(bool(torch.isfinite(t_img).all()), "image not finite")
    _check(red > 100 and globe > 100, f"image lacks globe/particles: "
           f"{red} {globe}")
    results["main_path"] = {"launches": launches, "simulate_s": sim_s,
                            "stats": stats, "rel": rel, "particle_px": red,
                            "globe_px": globe}

    # ---- phase 6: times on the card ----
    n = N_TIME
    s_free = init_cloth_state(cfg, device=dev)
    k_ms = _best_ms(lambda: cloth_kernel.multi_step_kernel(s_free, params,
                                                           DT, n))
    p_ms = _best_ms(lambda: cloth_kernel.multi_step_plain(s_free, params,
                                                          DT, n))
    k_rate = GRID * GRID * n / (k_ms / 1e3)
    p_rate = GRID * GRID * n / (p_ms / 1e3)
    print(f"phase 6 cloth {GRID}x{GRID} x {n} substeps [{card}]: kernel "
          f"{k_ms / n:.5f} ms/substep = {k_rate:.4e} particle-steps/s; plain "
          f"{p_ms / n:.5f} ms/substep = {p_rate:.4e} particle-steps/s")

    cam = scene.camera()
    eye, dirs = cam_mod.pixel_rays(cam, fh, fw)
    c_main = scene.state.pos.reshape(3, -1).T
    wins, ocb, _, rect = raster_kernel.tiled_prologue(
        cam.view[:3, :3], eye, c_main, cfg.particle_radius, cam.znear,
        torch.tan(cam.fovy_rad / 2.0), cam.aspect, fh, fw)
    rk_ms = _best_ms(lambda: raster_kernel.sphere_raster_kernel(
        wins, ocb, rect, dirs, cam.znear))
    rp_ms = _best_ms(lambda: raster_kernel.sphere_raster_plain(
        ocb, dirs, cam.znear))
    frame_ms = _best_ms(lambda: scene.render(fh, fw))
    print(f"phase 6 render {fh}x{fw}, {GRID * GRID} instances [{card}]: raster kernel "
          f"{rk_ms:.4f} ms, raster plain {rp_ms:.4f} ms; whole frame "
          f"(kernel path, incl. prologue, globe, copy to host) "
          f"{frame_ms:.4f} ms")
    results["times"] = {"cloth_kernel_ms_per_substep": k_ms / n,
                        "cloth_plain_ms_per_substep": p_ms / n,
                        "cloth_kernel_psteps_per_s": k_rate,
                        "cloth_plain_psteps_per_s": p_rate,
                        "raster_kernel_ms": rk_ms, "raster_plain_ms": rp_ms,
                        "frame_ms": frame_ms}

    # ---- phase 7: where the time goes ----
    results["profile"] = _profile(scene, params, wins, card)
    k1_bound, k1_by = _cloth_bound(GRID, GRID, 1, n)
    r_bound, r_by, r_ring = _raster_bound(wins, rect, fh, fw)
    print(f"phase 6 sphere_raster bound @{fh}x{fw}, {GRID * GRID} instances "
          f"[{card}]: {r_bound:.5f} ms ({r_by}; the first port's ring sweep "
          f"{r_ring:.4f} ms), kernel at {r_bound / rk_ms:.4f} of the bound")

    # ---- phase 8: K5 on the card, on fresh and on settled worlds ----
    fresh = datagen.randomized_worlds(
        ClothConfig(), DG_WORLDS, torch.Generator().manual_seed(DG_SEED),
        device=dev)
    k5_res = {}
    k5_res["fresh"], k5_err, k5r_err = _phase8_k5(fresh, "fresh", dev, card,
                                                  False)
    # drop the fresh worlds onto the globe (3 s), where the contact and
    # friction branches run and the randomized views of phases 9 and 10
    # see the cloth
    settled = datagen.WorldBatch(
        state=cloth_kernel.multi_step_kernel(fresh.state, fresh.params, DT,
                                             DG_SETTLE),
        params=fresh.params)
    del fresh
    k5_res["settled"], e, er = _phase8_k5(settled, "settled", dev, card, True)
    k5_err, k5r_err = max(k5_err, e), max(k5r_err, er)
    results["cloth_step_batched"] = k5_res

    # ---- phase 9: the batched raster, one chunk of worlds ----
    results["sphere_raster_batched"], r9_err, raster_in = _phase9_raster(
        settled, dev, card)

    # ---- phase 10: the datagen path, counted ----
    results["datagen"] = _phase10_datagen(settled, dev, card, cli_main)
    dg_launches = results["datagen"]["launches"]

    # ---- phases 6 and 7 for the datagen path ----
    dg = _dg_times(settled, raster_in, dev, card)
    del raster_in
    chunks, tex = dg.pop("chunks"), dg.pop("tex")
    dg["trace"] = _dg_trace(tex, chunks, card)
    results["datagen_times"] = dg
    del chunks, tex, settled

    # ---- phase 11: the substep adjoint vs its plain version ----
    results["cloth_substep_vjp"], vjp_err = _phase11_adjoint(
        scene.state, k240, params, dev, card)

    # ---- phase 12: the training path, counted ----
    results["training"] = _phase12_trainer(dev, card)
    tr_launches = results["training"]["launches"]

    # ---- phases 6 and 7 for the training path ----
    gt = _grad_times(params, dev, card)
    results["training_times"] = gt

    # ---- phase 13: K10 vs its plain version at 1M, the fresh lattice ----
    from wgpu_physics_engine_torch.models import granular

    fresh = granular.init_state(_gr_configs()["default"],
                                torch.Generator().manual_seed(0), device=dev)
    k10 = {}
    k10["fresh"], k10_err = _phase13_k10(fresh, "fresh", card, extra=True)

    # ---- phase 14: the granular main path, counted ----
    results["granular"], pile = _phase14_granular(dev, card, cli_main)
    gr_launches = results["granular"]["launches"]

    # ---- phase 13 on the settled pile of phase 14 ----
    k10["settled"], e = _phase13_k10(pile, "settled", card, extra=False)
    k10_err = max(k10_err, e)
    _check(k10["settled"]["default"]["contact_share"] > 0,
           "settled pile: no particle in contact")
    results["granular_step"] = k10

    # ---- phases 6 and 7 for the granular path ----
    grt = _gr_times(fresh, pile, card)
    results["granular_times"] = grt
    del pile

    # ---- phase 15: K11, K12 and K1f vs their plain versions ----
    results["contact_kernels"], ct_err, k1f_err = _phase15(
        fresh, scene.state, params, card)

    # ---- phase 16: the granular gradient path, counted ----
    results["granular_grad"] = _phase16(fresh, dev, card)
    gg_launches = results["granular_grad"]["launches"]

    # ---- phase 17: the self-collision path, counted ----
    results["self_collide"], sc_state, sc_params = _phase17(dev, card,
                                                            cli_main)
    sc_launches = results["self_collide"]["launches"]

    # ---- phases 6 and 7 for the contact-gradient and self-collision paths
    ctt = _contact_times(fresh, sc_state, sc_params, dev, card)
    results["contact_times"] = ctt
    del fresh, sc_state

    # ---- phase 18: the free-particle box and K4, counted ----
    pt = _phase18_particles(dev, card, cli_main)
    results["particles"] = pt
    pt_launches = pt["launches"]

    # ---- phase 19: the mesh scenes ----
    results["meshes"] = _phase19_meshes(dev, card, cli_main)

    # ---- phase 20: the large-grid path (K6) ----
    results["cloth_tiled"], k6_err, k6r_err = _k6_checks(dev, card)
    results["large_grid"] = _phase20(dev, card, cli_main)
    lg_launches = results["large_grid"]["launches"]
    lg_grad_launches = results["large_grid"]["grad_launches"]

    # ---- phases 6 and 7 for the large-grid path ----
    lgt = _k6_times(dev, card)
    results["large_grid_times"] = lgt

    # ---- phase 21: the multi-device paths (K6w, K1w, K10b) ----
    mc, mc_kernels = _multi_device(dev, card)
    results["multi_device"] = mc
    mc_launches = mc["main"]["launches"]

    # ---- phase 22: granular datagen, counted (and its phases 6 and 7) ----
    gg = _phase22_granular_datagen(dev, card, cli_main)
    results["granular_datagen"] = gg
    gdg_launches = gg["launches"]

    # ---- phase 23: the differentiable render and the example, counted ----
    dr = _phase23_diff_render(dev, card)
    results["diff_render"] = dr
    ir_launches = dr["launches"]

    # ---- phase 24: the live view without a terminal ----
    results["live"] = _phase24_live(card)

    # ---- phase 25: the differentiable rows path, counted ----
    results["rows_grad"], rg_kernels, rg_sites = _phase25(dev, card,
                                                          mc["times"])
    for k in mc_kernels:
        for x in rg_sites.get(k["name"], []):
            k["sites"].append(x)
            k["launches"] += x["launches"]
    with open(os.path.join(OUT, "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)

    gen = results["datagen"]["generate_launches"]
    g_r = results["granular"]["raster"]
    ct_sc = ctt["granular_forces_self_collide"]
    ct_1m = ctt["granular_forces"]
    mc_sc = MC_SC_WORLDS * MC_SC_STEPS          # phase 21's split, checked
    mc_gr = 2 * MC_DIFF_WORLDS * MC_DIFF_STEPS
    fr = f"{fh}x{fw}"
    kernels = [
        _kernel("cloth_step", "cloth_step.cu", "cloth_pallas.py:195",
                max(e1, e240, efp, dr["sites"]["k1"]["err"]), k_ms / n,
                p_ms / n, k1_bound / n, k1_by, [
                    _site(f"flagship {GRID}²", launches["cloth_step"],
                          k_ms / n, k1_bound / n),
                    _site(f"training {GRID}²", tr_launches["cloth_step"],
                          k_ms / n, k1_bound / n),
                    _site("inverse rendering 16²", ir_launches["cloth_step"],
                          dr["sites"]["k1"]["ms"],
                          dr["sites"]["k1"]["bound_ms"])]),
        _kernel("cloth_step_batched", "cloth_step.cu", "cloth_pallas.py:345",
                k5_err, dg["k5_shard"]["ms"], dg["k5_shard"]["plain_ms"],
                dg["k5_shard"]["bound_ms"], dg["k5_shard"]["bound_by"], [
                    _site(f"multi-device, a substep on "
                          f"{MC_K5_WORLDS // MC_SHARDS} worlds",
                          mc_launches["cloth_step_batched"],
                          dg["k5_shard"]["ms"], dg["k5_shard"]["bound_ms"]),
                    _site(f"datagen, {DG_CHUNK} worlds (K5r takes it)",
                          gen["cloth_step_batched"], dg["k5"]["ms"],
                          dg["k5"]["bound_ms"]),
                    _site(f"datagen CLI, {DG_CLI_WORLDS} worlds (K5r takes "
                          f"it)", dg_launches["cloth_step_batched"]
                          - gen["cloth_step_batched"], dg["k5_cli"]["ms"],
                          dg["k5_cli"]["bound_ms"])]),
        _kernel("cloth_tiled_batched", "cloth_tiled.cu",
                "cloth_pallas.py:302", k5r_err, dg["k5"]["k5r_ms"],
                dg["k5"]["plain_ms"], dg["k5"]["bound_ms"],
                dg["k5"]["bound_by"], [
                    _site(f"datagen, a call on {DG_CHUNK} worlds",
                          gen["cloth_tiled_batched"], dg["k5"]["k5r_ms"],
                          dg["k5"]["bound_ms"], DG_STEPS),
                    _site(f"datagen CLI, a call on {DG_CLI_WORLDS} worlds",
                          dg_launches["cloth_tiled_batched"]
                          - gen["cloth_tiled_batched"],
                          dg["k5_cli"]["k5r_ms"], dg["k5_cli"]["bound_ms"],
                          DG_STEPS)]),
        _kernel("sphere_raster", "sphere_raster.cu", "raster_pallas.py:209",
                max(r_err, r9_err, g_r["err_tmin"], g_r["err_oc"],
                    gg["raster"]["err"]), rk_ms, rp_ms, r_bound, r_by, [
                    _site(f"flagship frame {fr}, {GRID * GRID} instances",
                          launches["sphere_raster"], rk_ms, r_bound),
                    _site(f"datagen, {DG_CHUNK} worlds at {DG_FB[0]}x"
                          f"{DG_FB[1]}", gen["sphere_raster"],
                          dg["raster_1024"]["ms"],
                          dg["raster_1024"]["bound_ms"]),
                    _site(f"datagen CLI, {DG_CLI_WORLDS} worlds",
                          dg_launches["sphere_raster"]
                          - gen["sphere_raster"], dg["raster_cli"]["ms"],
                          dg["raster_cli"]["bound_ms"]),
                    _site(f"granular frame, {GR_N} instances",
                          gr_launches["sphere_raster"], g_r["ms"],
                          g_r["bound_ms"]),
                    _site("self-collision frames",
                          sc_launches["sphere_raster"],
                          results["self_collide"]["raster"]["ms"],
                          results["self_collide"]["raster"]["bound_ms"]),
                    _site("free-particle CLI at 256x256",
                          pt_launches["sphere_raster"], pt["raster_cli"]["ms"],
                          pt["raster_cli"]["bound_ms"]),
                    _site(f"large-grid frames, {LG * LG} instances",
                          lg_launches["sphere_raster"],
                          results["large_grid"]["raster"]["ms"],
                          results["large_grid"]["raster"]["bound_ms"]),
                    _site(f"multi-device, {MC_K5_WORLDS // MC_SHARDS} worlds "
                          f"at 64x64", mc_launches["sphere_raster"],
                          dg["raster_shard"]["ms"],
                          dg["raster_shard"]["bound_ms"]),
                    _site(f"granular datagen, {GG_CHUNK} worlds x {GG_N} at "
                          f"{DG_FB[0]}x{DG_FB[1]}",
                          gdg_launches["sphere_raster"], gg["raster"]["ms"],
                          gg["raster"]["bound_ms"])]),
        _kernel("cloth_substep_vjp", "cloth_grad.cu",
                "cloth_pallas_grad.py:269",
                max(vjp_err, dr["sites"]["vjp"]["err"]), gt["vjp"]["ms"],
                gt["vjp"]["plain_ms"], gt["vjp"]["bound_ms"],
                gt["vjp"]["bound_by"], [
                    _site(f"training {GRID}²",
                          tr_launches["cloth_substep_vjp"], gt["vjp"]["ms"],
                          gt["vjp"]["bound_ms"]),
                    _site("inverse rendering 16²",
                          ir_launches["cloth_substep_vjp"],
                          dr["sites"]["vjp"]["ms"],
                          dr["sites"]["vjp"]["bound_ms"])]),
        _kernel("granular_step", "granular_step.cu", "granular_pallas.py:684",
                max(k10_err, gg["k10"]["err"]), grt["default fresh"]["ms"],
                grt["default fresh"]["plain_ms"],
                grt["default fresh"]["bound_ms"],
                grt["default fresh"]["bound_by"], [
                    _site(f"granular {GR_N}", gr_launches["granular_step"],
                          grt["default fresh"]["ms"],
                          grt["default fresh"]["bound_ms"]),
                    _site(f"granular datagen, a world of {GG_N}",
                          gdg_launches["granular_step"], gg["k10"]["ms"],
                          gg["k10"]["bound_ms"])]),
        _kernel("granular_forces", "granular_step.cu",
                "granular_pallas.py:750", ct_err, ct_sc["ms"],
                ct_sc["plain_ms"], ct_sc["bound_ms"], ct_sc["bound_by"], [
                    _site(f"self-collision {GRID}²",
                          sc_launches["granular_forces"], ct_sc["ms"],
                          ct_sc["bound_ms"]),
                    _site(f"multi-device self-collision {GRID}², a world",
                          mc_sc, ct_sc["ms"], ct_sc["bound_ms"]),
                    _site(f"gradients {GR_N}",
                          gg_launches["granular_forces"], ct_1m["ms"],
                          ct_1m["bound_ms"]),
                    _site(f"multi-device gradients {GR_N}, a world",
                          mc_launches["granular_forces"] - mc_sc,
                          ct_1m["ms"], ct_1m["bound_ms"])]),
        _kernel("granular_force_jvp", "granular_step.cu",
                "granular_pallas.py:1000", ct_err,
                ctt["granular_force_jvp"]["ms"],
                ctt["granular_force_jvp"]["plain_ms"],
                ctt["granular_force_jvp"]["bound_ms"],
                ctt["granular_force_jvp"]["bound_by"], [
                    _site(f"gradients {GR_N}",
                          gg_launches["granular_force_jvp"]
                          + mc_launches["granular_force_jvp"],
                          ctt["granular_force_jvp"]["ms"],
                          ctt["granular_force_jvp"]["bound_ms"])]),
        _kernel("cloth_step_force", "cloth_step.cu", "cloth_pallas.py:682",
                k1f_err, ctt["cloth_step_force"]["ms"],
                ctt["cloth_step_force"]["plain_ms"],
                ctt["cloth_step_force"]["bound_ms"],
                ctt["cloth_step_force"]["bound_by"], [
                    _site(f"self-collision {GRID}², single and multi-device",
                          sc_launches["cloth_step_force"]
                          + mc_launches["cloth_step_force"],
                          ctt["cloth_step_force"]["ms"],
                          ctt["cloth_step_force"]["bound_ms"])]),
        _kernel("sphere_raster_untiled", "sphere_raster_untiled.cu",
                "raster_pallas.py:35",
                max(pt["k4_scene"]["err_tmin"], pt["k4_max"]["err_tmin"],
                    dr["sites"]["k4"]["err"]),
                pt["k4_scene"]["device_ms"], pt["k4_scene"]["plain_ms"],
                pt["k4_scene"]["bound_ms"], pt["k4_scene"]["bound_by"], [
                    _site("free particles 600x800, 10 instances",
                          pt_launches["sphere_raster_untiled"],
                          pt["k4_scene"]["device_ms"],
                          pt["k4_scene"]["bound_ms"]),
                    _site("inverse rendering 48x64, 256 instances",
                          ir_launches["sphere_raster_untiled"],
                          dr["sites"]["k4"]["ms"],
                          dr["sites"]["k4"]["bound_ms"])]),
        _kernel("cloth_tiled", "cloth_tiled.cu", "cloth_pallas_tiled.py:40",
                k6_err, lgt[str(LG)]["ms"], lgt[str(LG)]["plain_ms"],
                lgt[str(LG)]["bound_ms"], lgt[str(LG)]["bound_by"], [
                    _site(f"large grid {LG_BIG[0]}² (above K6r's reach)",
                          lg_launches["cloth_tiled"]
                          + lg_grad_launches["cloth_tiled"],
                          lgt[str(LG_BIG[0])]["ms"],
                          lgt[str(LG_BIG[0])]["bound_ms"])]),
        _kernel("cloth_tiled_resident", "cloth_tiled.cu",
                "cloth_pallas_tiled.py:264", k6r_err,
                lgt[str(LG)]["k6r_ms"], lgt[str(LG)]["plain_ms"],
                lgt[str(LG)]["bound_ms"], lgt[str(LG)]["bound_by"], [
                    _site(f"large grid {LG}², a call (scene, frame, CLI, "
                          f"gradient forward)",
                          lg_launches["cloth_tiled_resident"]
                          + lg_grad_launches["cloth_tiled_resident"],
                          lgt[str(LG)]["k6r_ms"], lgt[str(LG)]["bound_ms"],
                          (results["large_grid"]["substeps_k6r"] + FIT_SEG)
                          / (lg_launches["cloth_tiled_resident"]
                             + lg_grad_launches["cloth_tiled_resident"]))]),
    ]
    dpc = results["datagen"]["pixel_chain"]
    gpc = gg["pixel_chain"]
    g_pix = gg["generate_launches"]
    globe_rays = gen["pixel_rays"] - gen["flat_composite_rgb8"]
    for name, key in (("pixel_rays", "rays"),
                      ("flat_composite_rgb8", "epilogue")):
        d, g = dpc[key], gpc[key]
        sites = [_site(f"datagen frames, {DG_CHUNK} worlds at {DG_FB[0]}x"
                       f"{DG_FB[1]}", gen["flat_composite_rgb8"], d["ms"],
                       d["bound_ms"])]
        if key == "rays":
            sites.append(_site(f"datagen cached globes, "
                               f"{datagen.GLOBE_CHUNK} worlds", globe_rays))
        sites += [
            _site(f"datagen CLI, {DG_CLI_WORLDS} worlds",
                  dg_launches[name] - gen[name]),
            _site(f"granular datagen, {GG_CHUNK} worlds x {GG_N} at "
                  f"{DG_FB[0]}x{DG_FB[1]}", g_pix[name], g["ms"],
                  g["bound_ms"]),
            _site(f"granular datagen CLI, {GG_CLI_WORLDS} worlds",
                  gdg_launches[name] - g_pix[name])]
        kernels.append(_kernel(name, "pixel_chain.cu", None,
                               max(d["err"], g["err"]), d["ms"],
                               d["plain_ms"], d["bound_ms"], d["bound_by"],
                               sites))
    kernels += mc_kernels + rg_kernels
    _ranking(kernels, card)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
