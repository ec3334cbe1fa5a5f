#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile   # device-time breakdown of the sessions
                                      # (synchronous and pipelined)
    python3 chip_smoke.py --kernel-times  # kernel times alone (also in an
                                          # older checkout)
    python3 chip_smoke.py --mesh-district  # the district's solve on the
                                           # (1, 2) gloo mesh, twice (also
                                           # in an older checkout)
    python3 chip_smoke.py --session-times  # unprofiled ms/scan, 3 runs of
                                           # configs 3 and 2 (also in an
                                           # older checkout)
    python3 chip_smoke.py --slam-times  # the fused step's steps/s and
                                        # poses hash, 3 runs on one NCCL
                                        # rank and one device, and K2's
                                        # rows hashed (also in an older
                                        # checkout)
    python3 chip_smoke.py --pf-times  # config 4's filter: the per-scan
                                      # launches' times, the planned
                                      # launch's host side, 3 sessions
                                      # with pf_step ms, the host parts of
                                      # a step and the particles' sha256
                                      # (also in an older checkout)
    python3 chip_smoke.py --pcg-lattice-times  # the district's PCG solve
                                               # (walls, CG steps, RMSE,
                                               # sha256), K4's PCG system
                                               # and K11's lattice against
                                               # their parent forms, the
                                               # box drive's decisions and
                                               # config 6 forced to PCG from
                                               # five starts (also in an
                                               # older checkout)
    python3 chip_smoke.py --config6-spread  # config 6 forced to PCG from
                                            # 16 starts a few ulps apart,
                                            # with the tree's inverse, the
                                            # parent's cuBLAS one and one
                                            # rounded from float64, then
                                            # dense (an older checkout:
                                            # its own inverse)
    python3 chip_smoke.py --field-bins-times DIR  # K11's field and K10's
                                                  # bins (graph ms, cuda_ms,
                                                  # host us, device ops,
                                                  # output sha256), the next
                                                  # rows' graph ms and the
                                                  # decisions, in DIR (an
                                                  # older git archive, this
                                                  # script copied in) and
                                                  # here: parent, change,
                                                  # change, parent
    python3 chip_smoke.py --spectra-finalize-times DIR  # K10's spectra,
                                  # K6's one-device search, K12's K6
                                  # finalize, the merge-shape fold, KB3's
                                  # reduction, K2's planned finalize, the
                                  # split search's glue, K11's lattice
                                  # (graph ms, cuda_ms, host us, device
                                  # ops, output sha256) and the decisions
                                  # of config 6, drift, the merge and
                                  # [4r]'s winners, in DIR (an older git
                                  # archive, this script copied in) and
                                  # here: parent, change, change, parent
    python3 chip_smoke.py --score-fold-times DIR  # K11's lattice alone
                                  # and with its point score, a matched
                                  # correlative scan through the matcher
                                  # (device ops, host us), KB2's stripe
                                  # scores and KB3's match at S = 2 and 1
                                  # (graph ms, cuda_ms, host us, device
                                  # ops, output sha256), the goals met or
                                  # missed, and the decisions of the
                                  # correlative box drive and [4r]'s
                                  # winners (with its matches' seconds),
                                  # in DIR (an older git archive, this
                                  # script copied in) and here: parent,
                                  # change, change, parent
    python3 chip_smoke.py --kb3-breakdown  # KB3's match at S = 2 and 1
                                           # beside variants built here
                                           # (partials only, + ticket,
                                           # float4 loads, the fold
                                           # alone, an empty launch),
                                           # rank_sum, K2's fold and
                                           # torch.sum: graph ms, host us
    python3 chip_smoke.py --optimize-times  # the mapper's optimize ms, 3
                                            # runs of the office recipe,
                                            # config 9 and drift, and LM
                                            # iteration walls (also in an
                                            # older checkout)

Phases (any failure exits non-zero):
 1. require CUDA; print the card (nvidia-smi name and power limit), the
    torch/CUDA versions and nvcc's;
 2. build the kernels of ``ndt_2d_tpu_torch/csrc`` with nvcc (one process
    per source, in parallel);
 3. hold each kernel bitwise against its plain-PyTorch twin on the same
    CUDA inputs, check it is bitwise reproducible, and time kernel and twin
    with CUDA events beside its bound (bytes over 3.35 TB/s or float32
    operations over 67 TFLOP/s, counted from the inputs, each distinct
    cell or patch row the beams reach once) and, where one PyTorch call
    computes the same function, that call: K1/K2/K3/K5 at the
    rolling-mapping shapes of config 2 (10-scan window of 512 points,
    192x192 cells, 80x21x21 candidates x 100 beams, the 200-scan export);
    the same window at config-8 shapes with a grid axis of 4 (overlapping
    grids): K1 (its grid 0 bitwise the G = 1 build), K2 with its scores,
    K3's two entries, and K7 on the match (10 iterations); K1/K2 over 64
    loop-closure confirmation rows of real office windows at config-3
    shapes (2-scan regions, 160x160 cells of 0.35 m, 40x30x30 candidates)
    and K7 on them (8 iterations; bitwise also at 20, 40, 90 and 200
    beams, 1-4 warps a grid and lanes over two strides), each row
    bitwise equal to its R = 1 launch and to itself at pad 4 and pad 16,
    without and with K7; K4 (normal_blocks; pcg_normal_system, the
    blocks, D, the block-Jacobi preconditioner and b in one launch, for
    the three losses, and its planned form, ``k4.PcgPlan``, and the
    standalone preconditioner, each bitwise, timed beside the parent's
    normal_blocks + eager preconditioner; pcg_matvec beside a torch
    sparse CSR product, fixed_dots beside ``torch.dot``, and pcg_solve,
    one LM step's whole CG loop, in x and the step count, the host loop
    over pcg_matvec and fixed_dots bitwise equal to it, timed a CG step
    beside that loop and the same loop on the CSR product; the planned CG
    loop, ``k4.CgPlan``, a mesh rank's with the identity combine, launch
    by launch over its first four phases against the same plan on the
    twins: pcg_matvec plain and with the direction loader, the dot
    variants (A) and (B), every buffer, scalar and the stop flag bitwise;
    whole loops reproducible, bitwise ``mesh_cg`` over the twins and equal
    to pcg_solve) on the 50,000-node district graph of config 5, and again
    at rank 0's shard of the (1, 2) mesh, where each planned form is timed
    for the kernels line; K6 over 32 coarse-stage rows of office
    windows (3-scan regions, 192x192 cells of 0.5 m, the coarse lattice of
    about 21x41x41 candidates): scores and rows bitwise against the twin, each row
    bitwise equal at pad 4, pad 32 and R = 1, equal argmin and scores
    within 1e-5 against K2 on a one-cell lattice, once with G = 4, and at
    the map merge's shape (126 angles, R = 1); 241 x 241 and 301 x 301
    lattices through the field path and coarse rows through the table
    path (offsets wider than the staged windows, and no window), rows,
    scores and partials bitwise, and a plan whose shared memory the card
    refuses (the wrapper raises, counts nothing);
    K10's bins at each block shape of its plan over 512 office slots with
    a scan of 512 points in one sector and an all-masked scan, bitwise the
    twin; K10's spectra (a warp a scan) at every block shape of its plan
    (1-8 scans a block, the DFT tables staged or not) over 300 office
    scans with an empty and a one-sector scan, the plan's at 1, 5, 512 and
    2048 scans, and at 62 / 128 / 256 sectors, 6 rings and 40 bins,
    bitwise the twin; K10 over a 2048 x 512 point
    table of the office bag: its bin tables, descriptors and all-pairs
    top-k bitwise against the twins, rows of ``search_all_pairs`` bitwise
    equal to ``search_dense``, scores against a matrix product, and the
    search again at an odd shape (37 queries x 1000 keys of 190 floats,
    exact ties, negative limits, k = 3, 8, 20, one-row launches); the
    coarse-to-fine chain ``match_scan_batch_multi_coarse_fine`` against
    the twins' chain bitwise, with no host synchronization inside it and
    one K1 + K6 + K1 + K2 + K7 launch a chunk; K3's single-pose launch (a
    block a pose) on config 3's and config 8's windows at their beams and
    at 1, 31, 32, 33, 100, 128, 129, 1000 and 1025, bitwise its twin and
    the batched launch's rows, and its composed entry (the pipelined
    step's start pose dead-reckoned in the same launch) bitwise its twin,
    also across the +-pi wrap; K13 (the window append: in-place shift, new
    scan, corrected pose) over a 200-step chain of the config-2 odometry
    on config 2's window, start poses, corrected poses and the whole
    window after every step bitwise against the twins' chain and the eager
    shift it replaced; K11 (the
    correlative matcher's field build, lattice search and point score)
    bitwise against its twins and reproducible, the field (one cluster
    launch, one device operation a build in a CUDA graph) bitwise the
    seven-step form and timed beside it in a CUDA graph, the lattice (one
    launch) bitwise the parent's two launches and timed beside them, the
    point score in the lattice's launch (the mapper's form: one device
    operation, the rows unchanged) bitwise the standalone point_scores
    and the twin, timed beside the lattice then point_scores, and
    64 lattice rows each bitwise equal to its R = 1 launch and to the
    parent's, their fused point scores to point_scores' at each row's
    pose, at config-2 shapes and at the shape of (o)'s box drive
    (160x160 cells, the widened 80x40x40 lattice); then the field at 128 x
    128, 200 x 150 (15 CTAs) and 202 x 150 (forced to 8), 512 x 512 (16
    CTAs of 156 kB), 1024 x 352 (16 CTAs of 229 kB), 1024 x 353 (the
    seven-step form by the plan), an empty window, a
    window without a live scan and poses at -0 and +0 with range_max 0,
    each bitwise its twin and the seven-step form (the last: the origin's
    bits against the seven-step form, printed beside the twin's); K12
    (the mesh's split search and rank-ordered sum): K2's partials over
    contiguous angle blocks and their finalize, split 2 and 4 ways, bitwise
    equal to the one-launch K2 and to the twins' split search, at config
    2's window (R = 1) and over the 64 config-3 rows, and K2's planned
    finalize (``SplitPlan``, reading the gathered stack in place) on
    stacks of 1-4 ranks' blocks built on the card with NaN in every slot
    it must not read, bitwise its twin and the one-launch K2, at both
    shapes; the fused step's ``finalize_append`` (the finalize with KB4's
    append in its launch) at config 2, 64 appends into a chain of slots,
    output rows and state bitwise its twin's; K6's split search as K2's
    over the 32 coarse rows, and its planned finalize (K2's launch at 7
    partials an angle) on stacks of 1, 2, 3, 4 and 8 ranks with NaN in the
    unread slots; K2's finalize launch over rows longer than a stage (the
    merge's 126 x 7 partials, 512, 513 and 300 x 7, one buffer and split
    stacks of 2 and 3), bitwise the twin, and with NaN lows the serial
    scan's winner; ``rank_sum`` at S = 2, 4 ranks of 3 x 50,000 and
    9 x 50,000 floats (the district's gradient and block diagonal) and at
    3 x 450,001 on a misaligned view against its twin, beside
    ``torch.sum(x, 0)``, with its launch path's host cost piece by piece
    (K10's search and ``rank_sum`` also timed on the device alone, in a
    CUDA graph, beside their library calls); K12·blocks on config 4's saved
    map: KB1 (the stripe build) on every stripe of 2 and of 4, bitwise its
    twin and the dense K1 rows, KB2 (the stripe scores: K3's particle
    launch reading KB1's stripe table, one record a beam) over the 5000
    particles on stripes 0 and 1 of 2, 20,000 on stripe 0 and the scan's
    world points (one block), each bitwise its twin, the SoA twin and the
    SoA launch (the parent design), KB3 (a localization scan's
    stripe field, also into a ``FieldPlan``'s send buffer; the match of two
    stripes' fields, one launch reading the plan's stack, bitwise its twin,
    the parent chain of K12's rank_sum, the partials and K2's fold, and
    itself 64 times back to back; at one stripe bitwise the dense K6 row;
    stacks of 3 and 13 stripes and lattices of 7x5x5 and 9x33x33 bitwise
    the twin) and KB4
    (the fused step's append into a 256-slot state; planned, 64 appends
    into a chain of slots), each bitwise against its twin; K1 at its
    sort's edges (every valid point of a 38,400-point
    window in one cell, 4277-point rows, a window without a valid point)
    and K2 at its range edges (512 angles x 32 x 32 offsets at R = 1 and
    64), bitwise; K1 and K2 at the main path's shapes, K7 at its three
    (64 config-3 rows, config 8's match, config 2's window), K9's resample
    at 5000 and 20,000 particles (plain and with recovery), K6 over 32
    coarse rows and at the merge's shape, K12's K6 partials, KB3's field
    and K3 (M = 1 on config 3's window, G = 4, 5000 poses), the filter's
    per-scan launches at 5000 and 20,000 particles (K9's motion, the SoA
    K3 batch, the two back to back, K3's particle launch with the motion
    folded in and with it off; ``pf_rows``) and the planned particle
    launch's host side piece by piece, K4's
    normal_blocks, dense_system, dense_normal_system (with its bound) and
    lm_step at N_pad 512 and 1024 (lm_step through its one-block launch
    and its cooperative grid, and a solve plan's two launches), K5 at
    config 2's export, K4's CG loop launches (``cg_times``: pcg_matvec at
    the district and at rank 0's shard of the (1, 2) mesh, public and
    planned, plain and forming the direction, the dot variants (A) and
    (B), fixed_dots beside ``torch.dot``, and a CG step of pcg_solve, the
    host loop and the planned loop), K12's K2 finalize from a 2-way
    split's gathered stack (planned; in a tree without plans its reordering
    copy and ``finalize_rows``) and ``finalize_rows`` on one [R, A, 12]
    buffer at config 2 and over 64 config-3 rows, the fused step's
    finalize with KB4 (one ``finalize_append`` launch; or the finalize then
    KB4) and KB4 alone, timed by CUDA events, alone on the
    device in a CUDA graph and by host time a call (``kernel_times``, the
    same lines as ``--kernel-times``, which also prints the wall of an LM
    iteration, kernels against twins);
 4. drive the main paths, each with the launch counts set to 0 before and
    read after: (a) the 200-scan, 600-beam config-2 corridor through
    ``Mapper`` and ``run_bag`` (no loop closure) with its export: every scan
    accepted, ATE below odometry's, K1 = K2 = K3 = K13 = accepted - 1, K5
    >= 1,
    and the first 20 scans on the GPU against the CPU twins; (b) the
    single-device PCG ``solve`` of the district, on the kernels (one
    pcg_normal_system and one pcg_solve launch an LM iteration, no
    normal_blocks) and on the twins: final RMSE below the initial, the
    two arms' poses bitwise equal; one LM iteration under torch.profiler,
    its device events from the system's launch to lm_step exactly
    pcg_normal_system, pcg and lm_step (no library inverse, no copy),
    printed beside the parent's iteration replayed from its pieces; each
    LM iteration's CG
    loop again as the planned mesh loop (identity combine) and as the host
    loop over the public pcg_matvec and fixed_dots, each equal to
    pcg_solve's in x and steps, the walls printed; (u) after (g), K4's
    dense LM step:
    dense_normal_system (hm with its -0 entries, and rhs, at lam 1e-12,
    1e-6 and 1e8) bitwise against its twin and against the three launches
    it replaces (normal_blocks, then dense_system), dense_system and
    lm_step (accepted, rejected, NaN and mesh-split steps: the step,
    cost and update modes, every state field, each through the one-block
    launch and through the cooperative grid) bitwise against their twins,
    on the office recipe's final graph, a synthetic 1024-node graph with
    duplicate, reversed and self-loop constraints and a hub graph whose
    hub lists span five staging chunks; a whole solve of each on the
    kernels (one plan a solve: an iteration's two launches packed once),
    on the kernels without the plan (the wrappers, as before it) and on
    the twins, poses bitwise and the same iterations, launches
    dense_normal_system = iterations, normal_blocks = dense_system = 0 and
    lm_step = iterations + 1; the office graph's solve (its poses moved
    off the optimum) profiled cut at 6 and at 2 iterations, whose
    difference shows an LM iteration's kernels (one of K4's before
    cuSOLVER's), no host->device copy and one read; the planned launches'
    host time a call beside the wrappers'; the kernels timed
    there and the wall of an LM iteration, kernels against twins;
    (f) BASELINE config 8 (run_benchmarks.py:139-162): the config-2
    corridor with four overlapping grids and 10 Newton iterations on both
    matchers: every scan accepted, ATE below odometry's, K1 = K2 = K3 = K7
    = accepted - 1, ms/scan and (aligned) ATE printed beside config 2's;
    its first three matches replayed through the twins (K1, K2, K3, K7
    bitwise);
    (c) the full 2000-scan config-3 office loop (radius loop closure +
    optimization) with its export: >= 1 accepted closure and >= 1
    optimization, final ATE <= 1.10 x online and below odometry's, K1/K2
    launches = accepted - 1 + confirmation chunks, K4 >= 1; its export's
    K5 call again on its own rays, bitwise the twin on the card (also in
    (g)); the first two
    confirmation dispatches and the first solve of that session are
    replayed through the twins on the card and must reach the same scores
    bitwise and poses within 1e-4; (g) the same bag with the CLI's
    ``office`` recipe as ``run --recipe office`` builds it from config 3's
    flags (gate 0.85, 3-scan regions, both search positions,
    Geman-McClure, global refine_iterations 8):
    >= 1 closure and >= 1 optimization, final ATE below odometry's, one K7
    launch a confirmation chunk (printed by rows), beside (c); its first
    dispatch
    replayed through the twins (K7's after K2's), scores bitwise;
    (d) BASELINE config 4 (benchmarks/run_benchmarks.py:378-426): the
    150-scan box (360 beams, seed 2), mapped and saved before [3], is
    loaded; the 150-scan box bag (seed 7) is localized with the particle
    filter (5000 particles, KLD min 500, odometry alphas 0.05, seed 3):
    mean position error <= 0.10 m and below odometry's, every step two
    launches, K3's particle launch with K9's motion folded in and K9's
    resample (no K9 motion launch, no other batched K3), the final
    particles' sha256 printed; the first three filter steps replayed
    through the twins with the same draws give the same n_active and
    particles bitwise; then the scan-match branch on the same map and bag:
    mean error <= 0.12 m.  Before it, [3] holds K3 over 5000 and over
    20,000 poses of the config-4 grid against its twin (bitwise, and 64
    rows bitwise equal to their M = 1 launch), K3's particle launch with
    the motion off (each cell one record of K1's table) bitwise the SoA
    batch, and with K9's motion folded in bitwise ``motion_twin`` +
    ``score_batch_twin`` and K9's motion then the SoA batch (the parent
    design's two launches) on the same draws, 64 rows bitwise their M = 1
    launch at the moved pose, reproducible; K9's motion, resample (plain
    and recovery), EWMAs and statistics (alone and after an injection)
    against their twins on the same scores and draws at both counts
    (bitwise: n_active, drawn indices, first-occurrence marks, particles,
    weights, w_slow/w_fast, mean and covariance), and at 20,000 the
    resample with plans the card refuses (co-residency, shared memory):
    the wrapper raises and counts nothing; at 40,000, 200,000 and
    1,000,000 particles (first plans the card cannot hold at once, so
    the plan takes more chunks a block, and at 1,000,000 keeps a block's
    items in device memory) the resample, EWMAs and statistics bitwise
    against their twins; (e) BASELINE config 7 (run_benchmarks.py:
    598-657): 20,000 particles seeded over the free space (K5), 40 scans;
    the scan it converged at, its final error and the final particles'
    sha256 are printed, not gated; K3's particle launch and K9's resample
    launched every step (no K9 motion launch) and no twin ran; the first
    two steps replayed
    through the twins give the same n_active and particles bitwise;
    (h) BASELINE config 6 (run_benchmarks.py:248-303): the 2000-scan office
    bag of (c) with descriptor loop search as ``run --recipe
    office-descriptor`` builds it from config 3's flags: >= 1 closure and
    >= 1 optimization, final ATE below odometry's, far rows pruned > 0,
    K10's three kernels once a pass with pending scans, K6 once a coarse
    chunk; its first coarse dispatch replayed through the twins' chain
    bitwise, its last descriptor pass through K10's twins bitwise; (i) the
    ``drift`` recipe on the 3x-drift office bag
    (benchmarks/loop_closure_pr.py:279-281, odom_scale 3.0): >= 1 accepted
    closure from a far row, final ATE below odometry's; (j) ``merge_maps``
    of two sessions of >= 100 keyframes in the symmetry-broken office
    whose frames differ by a rotation of pi: >= 2 pairs accepted,
    transform within 0.15 m and 0.05 rad of the truth, merged ATE < 0.2 m;
    the pipelined paths at max_inflight=8, each printed beside its
    synchronous arm: (k) config 2 with its dispatch loop under CUDA
    sync-debug "error" (no stream or device synchronization, no blocking
    copy; a drain waits on its step's event): every scan accepted, ATE
    below odometry's, a pipelined scan one composed K3 launch, no plain K3
    and one K13, the first 20
    poses within 0.03 of (a)'s and every pose within 0.03 m across the
    corridor and 0.01 rad in heading of (a)'s; (l) config 3: >= 1 closure and
    optimization, final ATE below odometry's; (m) config 4: the particle
    filter (mean error <= 0.10 m and below odometry's; its first three
    steps replayed through step() with the same seed and controls give the
    same particles and n_active bitwise), then scan matching (<= 0.12 m);
    (n) BASELINE config 9 (run_benchmarks.py:700-815): datasets/simlab.clf.gz
    through the port's CARMEN importer (range_max 10) with the settings of
    run_benchmarks.py:732-761 (max_inflight 8, gate 1.0, 3-scan regions,
    both positions, Geman-McClure, global refine 8): >= 1 closure and
    optimization, final ATE below the odometry ATE of the same run; (o)
    the correlative matcher on the box drive of tests/test_correlative.py
    (>= 12 of 14 accepted, ATE below odometry's and < 0.15 m, one K11
    field and lattice launch a matched scan, the point score inside the
    lattice's: no standalone score launch), then on the config-2
    corridor with the widened local lattice, printed and not gated;
    the mesh path (K12): (p) one rank over NCCL on cuda:0, BASELINE config
    10 (benchmarks/mesh_slam_bench.py:48-62, the 600-scan office bag with
    config 3's settings) through ``Mapper(mesh=make_mesh(1))`` beside the
    single-device run of the same bag: the same accepted count, >= 1
    closure and optimization, final ATE below odometry's and within 0.08 m
    of the single-device run's (JAX's office criterion), the export
    bitwise equal to single-device K5 on the same graph, K12's split K2
    and rank sum launched and the one-launch K2 not, K4's dense_system
    and lm_step twice an LM iteration (around the rank sum); then at
    max_inflight
    8 (>= 1 closure, final ATE below odometry's); config 4's particle
    filter on the mesh (a step K9's motion launch, the sharded measurement
    on K3's particle launch with the motion off, the resample), its final
    particles bitwise (sha256) the single-device session's; config 2's
    pipelined dispatch loop on the mesh with the one-rank group's collectives
    forced through NCCL (the mesh path skips them as the identity), under
    CUDA sync-debug "error", its graph and export bitwise the
    single-device pipelined run's; K2's split search with its all-gather
    forced through NCCL at config 2 and over 64 config-3 rows, under a
    dispatch mode: bitwise the one-launch search, no operation on a CUDA
    tensor but allocations, views and the collective (no kernel between
    the partials and the finalize); config 6 on the mesh beside the
    single-device run (>= 1 closure, final ATE below odometry's and within
    0.08 m of one device's, K6's split search and K10's search launched)
    and, as a witness, one device with the solve forced to PCG; the time
    of ``distributed.gather`` through NCCL at the solver's shape; (q) two
    ranks sharing the card over gloo (collectives staged through the
    host), meshes (2, 1) and (1, 2): config 10 synchronously (accepted
    count equal to the single-device run's, >= 1 closure and
    optimization, final ATE below odometry's and within 0.08 m of one
    device's), the district's PCG solve
    by ``solve_multichip`` (within 5e-3 of the single-device PCG solve,
    RMSE <= 0.05 m; the launch counts of its planned CG loop read around
    it: each of the dot variants (A) and (B) once a matvec, the direction
    formed in most, no public fixed_dots and no pcg_solve) and config 4's
    5000-particle
    measurement (bitwise equal to unsharded K3), final poses, export,
    solve and scores bitwise equal on both ranks; correctness and the cost of host-staged
    collectives, not scaling;
    K12·blocks, first on a one-rank NCCL mesh (the launch counts of KB1-KB4
    read around (r) and (s)), then on gloo ranks sharing the card: (2, 1)
    (r), (s), (t); (1, 2) (r), (s); (2, 2) (r), (t); every rank bitwise
    equal: (r) the stripe-sharded map of config 4 (its mapper-sized global
    NDT in y-stripes over 'space'): every stripe bitwise the dense K1 rows;
    the 5000-particle measurement and config 7's 20,000 on its office map
    within 1e-5 relative of the dense K3 batch; all 150 scans of config 4's
    localization bag (seed 7) matched against the stripes from the starts
    of a dense K6 chain, each winner the dense K6 one or printed with both
    scores within 1e-5 relative; at one stripe all bitwise the dense
    results; each match two launches (KB3's field and match), no rank sum
    and no K6 fold, its seconds printed; (s) the fused SLAM step (``parallel/slam_step.py``) over config
    2's 200-scan corridor, optimizing every 8 scans, capacity 256: ATE below
    odometry's, (2, 1) bitwise the one-rank run; on the one-rank NCCL
    mesh KB4 rides in the search's finalize (200 ``finalize_append``
    launches, no KB4 launch), on one device KB4 launches planned (200),
    the two runs' poses bitwise equal, their sha256 printed; (t) the port's
    ``dryrun_multichip`` on 1, 2 and 4 ranks;
    the runtime surface: (v) sessions: config 2 split at scan 100 by
    ``save_session`` / ``load_session``, synchronous and at max_inflight 8:
    every scan accepted, ATE below odometry's, within 0.03 m across the
    corridor and 0.01 rad of (a)'s and (k)'s poses, whether bitwise and
    where they part printed; config 4's filter split at scan 75 with its
    CUDA generator's state restored: final error <= 0.10 m, particles'
    sha256 beside (m)'s; config 3's graph saved and loaded, timed; (w) the
    control channel: ``run_bag(control=...)`` over config 2 with mapping
    off, a save, a load, mapping on and an initial pose sent between
    scans, the state checked after each; ``run --session-out`` and ``run
    --resume`` on config 2's halves beside one ``run``, three processes:
    the same accepted count, within (v)'s bounds; (z) the control channel
    on a mesh: ``run --mesh 1 --socket`` on config 2's bag takes a
    save-map from a client thread and exits 0; two gloo ranks sharing the
    card replay config 2's first 100 scans with mapping off after scan 3,
    on after 6 and a save after 9, applied directly and sent over the
    channel from rank 0's callback: the ranks' final graphs bitwise equal,
    the channel's equal to the direct runs', the map written once by rank
    0, ms a scan with and without the channel; (x) the live server:
    ``stream_bag`` windowed into a ScanServer on config 2 at max_inflight
    8, a pose for every deferred scan bitwise the graph's, K13 from the
    client's thread and K5 from the publisher's, state.json and map.npz
    written; a synchronous server answering every scan with the graph's
    pose; the client's ms a scan of both protocols; (y) ``run
    --trace-dir`` over 30 scans: the Chrome trace holds K1's, K2's, K3's
    and K13's kernels by symbol; ``export-rosbag2`` then
    ``import-rosbag2`` of config 3's map give back every array, ``info``
    prints; the PNG outputs where matplotlib is installed, else a line
    saying they were not run;
 5. print the kernels' JSON line and, last, the device JSON line.

``python3 chip_smoke.py --mesh-rank OUT SPACE BATCH MAP DEVICE`` is one
rank of (q), ``--blocks-rank OUT SPACE BATCH MAP4 MAP7 DEVICE PARTS``
one of (r)-(t), and ``--control-rank OUT DEVICE`` one of (z), started by
the script itself.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

KERNELS = {
    "ndt_build": ("ndt_2d_tpu_torch/csrc/ndt_build.cu",
                  "ndt_2d_tpu/ndt/grid.py:111"),
    "candidate_scores": ("ndt_2d_tpu_torch/csrc/candidate_scores.cu",
                         "ndt_2d_tpu/matching/matcher.py:218"),
    "score_points": ("ndt_2d_tpu_torch/csrc/score_points.cu",
                     "ndt_2d_tpu/ndt/grid.py:220"),
    "raymarch": ("ndt_2d_tpu_torch/csrc/raymarch.cu",
                 "ndt_2d_tpu/mapping/occupancy.py:51"),
    "normal_blocks": ("ndt_2d_tpu_torch/csrc/normal_blocks.cu",
                      "ndt_2d_tpu/graph/solver.py:140"),
    "pcg_normal_system": ("ndt_2d_tpu_torch/csrc/normal_blocks.cu",
                          "ndt_2d_tpu/graph/solver.py:140"),
    "preconditioner": ("ndt_2d_tpu_torch/csrc/normal_blocks.cu",
                       "ndt_2d_tpu/graph/solver.py:197"),
    "pcg_matvec": ("ndt_2d_tpu_torch/csrc/normal_blocks.cu",
                   "ndt_2d_tpu/graph/solver.py:203"),
    "pcg_solve": ("ndt_2d_tpu_torch/csrc/normal_blocks.cu",
                  "ndt_2d_tpu/graph/solver.py:193"),
    "fixed_dot": ("ndt_2d_tpu_torch/csrc/normal_blocks.cu",
                  "ndt_2d_tpu/graph/solver.py:227"),
    "pcg_matvec_direction": ("ndt_2d_tpu_torch/csrc/normal_blocks.cu",
                             "ndt_2d_tpu/parallel/solver.py:133"),
    "fixed_dot_damp": ("ndt_2d_tpu_torch/csrc/normal_blocks.cu",
                       "ndt_2d_tpu/parallel/solver.py:127"),
    "fixed_dot_update": ("ndt_2d_tpu_torch/csrc/normal_blocks.cu",
                         "ndt_2d_tpu/parallel/solver.py:131"),
    "dense_system": ("ndt_2d_tpu_torch/csrc/normal_blocks.cu",
                     "ndt_2d_tpu/graph/solver.py:171"),
    "dense_normal_system": ("ndt_2d_tpu_torch/csrc/normal_blocks.cu",
                            "ndt_2d_tpu/graph/solver.py:140"),
    "lm_step": ("ndt_2d_tpu_torch/csrc/normal_blocks.cu",
                "ndt_2d_tpu/graph/solver.py:122"),
    "score_points_batch": ("ndt_2d_tpu_torch/csrc/score_points.cu",
                           "ndt_2d_tpu/matching/matcher.py:424"),
    "pf_motion": ("ndt_2d_tpu_torch/csrc/particle_filter.cu",
                  "ndt_2d_tpu/filter/motion_model.py:21"),
    "pf_motion_score": ("ndt_2d_tpu_torch/csrc/score_points.cu",
                        "ndt_2d_tpu/filter/particle_filter.py:152"),
    "pf_resample": ("ndt_2d_tpu_torch/csrc/particle_filter.cu",
                    "ndt_2d_tpu/filter/particle_filter.py:81"),
    "pf_statistics": ("ndt_2d_tpu_torch/csrc/particle_filter.cu",
                      "ndt_2d_tpu/filter/particle_filter.py:55"),
    "ndt_build_g4": ("ndt_2d_tpu_torch/csrc/ndt_build.cu",
                     "ndt_2d_tpu/matching/matcher.py:95"),
    "candidate_scores_g4": ("ndt_2d_tpu_torch/csrc/candidate_scores.cu",
                            "ndt_2d_tpu/matching/matcher.py:194"),
    "score_points_g4": ("ndt_2d_tpu_torch/csrc/score_points.cu",
                        "ndt_2d_tpu/matching/matcher.py:411"),
    "newton": ("ndt_2d_tpu_torch/csrc/newton.cu",
               "ndt_2d_tpu/matching/newton.py:62"),
    "candidate_gather": ("ndt_2d_tpu_torch/csrc/candidate_gather.cu",
                         "ndt_2d_tpu/matching/matcher.py:272"),
    "candidate_gather_merge": ("ndt_2d_tpu_torch/csrc/candidate_gather.cu",
                               "ndt_2d_tpu/matching/matcher.py:272"),
    "descriptors": ("ndt_2d_tpu_torch/csrc/descriptors.cu",
                    "ndt_2d_tpu/parallel/loop_search.py:39"),
    "descriptor_spectra": ("ndt_2d_tpu_torch/csrc/descriptors.cu",
                           "ndt_2d_tpu/parallel/loop_search.py:92"),
    "descriptor_search": ("ndt_2d_tpu_torch/csrc/descriptor_search.cu",
                          "ndt_2d_tpu/parallel/loop_search.py:153"),
    "score_points_compose": ("ndt_2d_tpu_torch/csrc/score_points.cu",
                             "ndt_2d_tpu/matching/matcher.py:660"),
    "window_append": ("ndt_2d_tpu_torch/csrc/pose_chain.cu",
                      "ndt_2d_tpu/matching/matcher.py:485"),
    "correlative_field": ("ndt_2d_tpu_torch/csrc/correlative.cu",
                          "ndt_2d_tpu/matching/correlative.py:38"),
    "correlative_match": ("ndt_2d_tpu_torch/csrc/correlative.cu",
                          "ndt_2d_tpu/matching/correlative.py:76"),
    "correlative_score": ("ndt_2d_tpu_torch/csrc/correlative.cu",
                          "ndt_2d_tpu/matching/correlative.py:108"),
    "candidate_partials": ("ndt_2d_tpu_torch/csrc/candidate_scores.cu",
                           "ndt_2d_tpu/parallel/matcher.py:81"),
    "candidate_finalize": ("ndt_2d_tpu_torch/csrc/candidate_scores.cu",
                           "ndt_2d_tpu/parallel/matcher.py:89"),
    "candidate_gather_partials": ("ndt_2d_tpu_torch/csrc/candidate_gather.cu",
                                  "ndt_2d_tpu/parallel/runtime.py:127"),
    "candidate_gather_finalize": ("ndt_2d_tpu_torch/csrc/candidate_scores.cu",
                                  "ndt_2d_tpu/parallel/runtime.py:131"),
    "rank_sum": ("ndt_2d_tpu_torch/csrc/shard_combine.cu",
                 "ndt_2d_tpu/parallel/solver.py:92"),
    "ndt_build_stripe": ("ndt_2d_tpu_torch/csrc/ndt_build.cu",
                         "ndt_2d_tpu/parallel/ndt_blocks.py:46"),
    "stripe_score": ("ndt_2d_tpu_torch/csrc/score_points.cu",
                     "ndt_2d_tpu/parallel/ndt_blocks.py:116"),
    "stripe_field": ("ndt_2d_tpu_torch/csrc/candidate_gather.cu",
                     "ndt_2d_tpu/parallel/ndt_blocks.py:169"),
    "field_match": ("ndt_2d_tpu_torch/csrc/candidate_gather.cu",
                    "ndt_2d_tpu/parallel/ndt_blocks.py:212"),
    "slam_append": ("ndt_2d_tpu_torch/csrc/slam_step.cu",
                    "ndt_2d_tpu/parallel/slam_step.py:71"),
    "candidate_finalize_append": ("ndt_2d_tpu_torch/csrc/candidate_scores.cu",
                                  "ndt_2d_tpu/parallel/slam_step.py:100"),
}
ROOT = os.path.dirname(os.path.abspath(__file__))
# The bound of a kernel: the larger of the bytes it must move over the
# H100's memory rate and its operations over the float32 rate outside the
# tensor cores (NVIDIA's data sheet, SXM, 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
N_SCANS = 200
N_BEAMS = 600
OFFICE_SCANS = 2000
ROWS = 64
COARSE_ROWS = 32         # one far chunk of the mapper
DRIFT_SCANS = 1000
TABLE_SCANS = 2048       # the padded capacity of a 2000-keyframe graph
DISTRICT_NODES = 50_000
MESH_REPEATS = 64        # the one-block mesh update, again (check_lm_kernels)
PARTICLES = 5000         # config 4
GLOBAL_PARTICLES = 20_000  # config 7


class SmokeFailure(Exception):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def timed(max_abs_err, ms, plain_ms, moved, ops, library_ms=None,
          graph_ms=None) -> dict:
    """A kernel's timing entry: errors and times measured in this run, and
    its bound from ``moved`` bytes (each input read once, each output
    written once; gathered rows where the data picks them) and ``ops``
    float32 operations, both counted from this run's inputs.  ``graph_ms``
    (kernel, library call), where given: the device's time alone, from
    ``graph_ms()``."""
    t_bytes = moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return dict(max_abs_err=float(max_abs_err), ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms, graph_ms=graph_ms)


def max_abs_diff(pairs) -> float:
    """Largest |kernel - twin| over (kernel, twin) tensor pairs."""
    return max(float((a.double() - b.double()).abs().max()) for a, b in pairs)


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn()``: CUDA events around ``reps`` calls
    back to back after a warm-up, over the count.  Where a call's host
    side (argument checks, ctypes) outlasts its device work, the host
    side sets the figure."""
    import torch
    fn()  # warm-up
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn()`` on the device alone: ``reps``
    calls captured in one CUDA graph, the graph replayed once between CUDA
    events, over the count.  The launch path's host side is not in it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capturing stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def host_us(fn, reps: int, sync: bool = False) -> float:
    """Microseconds of host time per call of ``fn()`` (``perf_counter``
    around ``reps`` calls, no synchronization inside; with ``sync``, the
    median of ``reps`` calls each timed alone, the device synchronized
    between calls, outside the timed interval)."""
    import torch
    fn()
    if sync:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return sorted(times)[reps // 2] * 1e6
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def graph_nodes(fn) -> list:
    """The device operations one call of ``fn`` enqueues, read off a CUDA
    graph of the call (after a warm-up call off the capturing stream): each
    node's type ("kernel", "memset", "memcpy", ...) in the graph's order,
    through the driver's ``cuGraphGetNodes`` and ``cuGraphNodeGetType``."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    drv = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    require(drv.cuGraphGetNodes(raw, None, ctypes.byref(count)) == 0,
            "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    drv.cuGraphGetNodes(raw, nodes, ctypes.byref(count))
    names = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
             5: "empty", 6: "wait_event", 7: "event_record"}
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        drv.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        out.append(names.get(kind.value, str(kind.value)))
    return out


def phase_card():
    import torch

    from ndt_2d_tpu_torch import device as devmod
    from ndt_2d_tpu_torch.kernels import _build
    ident = devmod.card_identity()
    print(ident.splitlines()[0] if ident else "nvidia-smi: not found")
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; "
          f"{nvcc.stdout.strip().splitlines()[-1]}")
    return ident.splitlines()[0] if ident else ""


def phase_build():
    from ndt_2d_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info()
    print(f"[2] built {info['path']} in {time.perf_counter() - t0:.1f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("    " + line.strip())
    for name, (regs, st, ld) in kernel_resources(info["log"]).items():
        print(f"[3] registers {name}: {regs} registers, {st} bytes spill "
              f"stores, {ld} bytes spill loads")


# The kernels of K1, K2, K3, K4's dense and PCG systems, K11's lattice and
# K13 whose registers and spills [3] prints.
RESOURCE_KERNELS = ("bin_points", "bin_stripe", "sort_cells", "cell_records",
                    "score_angles", "score_points_kernel", "score_pose_kernel",
                    "particle_kernel", "dense_normal_system",
                    "pcg_normal_system", "precondition_nodes",
                    "lattice_tables", "window_append_kernel")


def kernel_resources(log: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)}
    from nvcc's -Xptxas -v report; a template's arguments (K2's thread
    tile) follow its name.  Empty when the library was already built."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((k for k in RESOURCE_KERNELS if k in m.group(1)),
                        None)
            if name is not None:
                args = re.findall(r"Li(\d+)E", m.group(1).split(name)[1])
                name += f"<{','.join(args[:2])}>" if args else ""
                out[name] = [0, 0, 0]
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def inputs(dev):
    """A config-2 window, query scan and the 200-scan ray batch."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.mapping import occupancy
    from ndt_2d_tpu_torch.config import MapperConfig, ScanMatcherConfig
    from ndt_2d_tpu_torch.io.bag import record_synthetic
    from ndt_2d_tpu_torch.mapping import laser
    bag = record_synthetic("corridor", N_SCANS, n_beams=N_BEAMS, seed=0)
    m = ScanMatcherConfig(grid_cells_x=192, grid_cells_y=192)
    cfg = MapperConfig(local_scan_matcher=m, global_scan_matcher=m,
                       max_points_per_scan=512, loop_closure_every=10**9)
    pts, msk = [], []
    for t in range(N_SCANS):
        p, k = laser.project_scan(bag[t][0], bag.range_max, np.zeros(3),
                                  False, None, cfg.max_points_per_scan)
        pts.append(p)
        msk.append(k)
    pts, msk = np.stack(pts), np.stack(msk)
    D = cfg.rolling_depth
    t = torch.from_numpy
    win = dict(poses=t(bag.odom[:D].astype(np.float32)).to(dev),
               points=t(pts[:D]).to(dev), point_mask=t(msk[:D]).to(dev),
               window_mask=torch.ones(D, dtype=torch.bool, device=dev))
    query = dict(points=t(pts[D]).to(dev), point_mask=t(msk[D]).to(dev),
                 num_points=int(msk[D].sum()),
                 pose=t((bag.odom[D] + [0.02, -0.01, 0.01]).astype(
                     np.float32)).to(dev))
    rays = occupancy.ray_batch(bag.odom, pts, msk, cfg.resolution)
    return bag, cfg, win, query, rays


def phase_kernels(cfg, win, query, rays, dev):
    """Each kernel bitwise against its twin on the same CUDA inputs,
    bitwise reproducibility of K1/K2/K5, and times."""
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.kernels import raymarch as k5
    from ndt_2d_tpu_torch.kernels import score_points as k3
    from ndt_2d_tpu_torch.mapping import occupancy
    mc = cfg.local_scan_matcher
    W, H = mc.grid_cells_x, mc.grid_cells_y
    rmax = 15.0
    out = {}

    # K1: bitwise.
    def k1_run():
        return k1.build_window(**win, range_max=rmax,
                               cell_size=mc.ndt_resolution, width=W,
                               height=H)

    def k1_twin():
        return k1.build_window_twin(**win, range_max=rmax,
                                    cell_size=mc.ndt_resolution, width=W,
                                    height=H)

    (g, tab), (gt, tabt) = k1_run(), k1_twin()
    torch.cuda.synchronize()
    check_build(g, tab, gt, tabt, "K1")
    g2, tab2 = k1_run()
    check_build(g, tab, g2, tab2, "K1 (reproducibility)")
    print(f"[3] K1 ndt_build: {int((g.count > 0).sum())} occupied cells, "
          f"bitwise equal to its twin and reproducible")
    S, P = win["points"].shape[0], win["points"].shape[1]
    out["ndt_build"] = timed(
        0.0, cuda_ms(k1_run, 20), cuda_ms(k1_twin, 5),
        nbytes(*win.values(), g.origin, g.mean, g.information, g.covariance,
               g.count, tab), ops_ndt_build(1, 1, S * P, W * H))

    # K2 on the kernel-built grid: scores and output row bitwise.
    from ndt_2d_tpu_torch.matching.matcher import _search_offsets
    dths, dls = _search_offsets(mc, dev)
    args = (mc, g, tab, query["points"], query["point_mask"],
            query["num_points"], query["pose"], dths, dls)
    o2, sc = k2.match(*args, with_scores=True)
    rest, sct = k2.match_twin(*args)
    torch.cuda.synchronize()
    check_match(o2, sc, one_row(rest), sct, "K2")
    check_match(o2, sc, *k2.match(*args, with_scores=True),
                "K2 (reproducibility)")
    print(f"[3] K2 candidate_scores: {sc.numel()} candidates, score "
          f"{float(o2[0, 0]):.5f} correction "
          f"{[round(float(x), 4) for x in o2[0, 1:4]]}, scores and output "
          f"row bitwise equal to the twin")
    nums = torch.tensor([query["num_points"]], dtype=torch.int32,
                        device=dev)
    tile_variants(mc, g.origin[None], tab[None],
                  (query["points"][None], query["point_mask"][None], nums,
                   query["pose"][None]), dths, dls, o2, "config 2 (R = 1)")
    out["candidate_scores"] = timed(
        0.0, cuda_ms(lambda: k2.match(*args), 20),
        cuda_ms(lambda: k2.match_twin(*args), 5),
        *cost_candidate_scores(mc, g.origin, g.cell_size, *args[3:]))

    # K3: bitwise.
    a3 = (g, W, H, mc.laser_max_beams, query["points"], query["point_mask"],
          query["num_points"], query["pose"])
    u, ut = k3.score_at_pose(*a3), k3.score_at_pose_twin(*a3)
    require(torch.equal(u, ut), f"K3 {float(u)} differs from twin {float(ut)}")
    print(f"[3] K3 score_points: {float(u):.6f}, bitwise equal to the twin")
    out["score_points"] = timed(
        0.0, cuda_ms(lambda: k3.score_at_pose(*a3), 20),
        cuda_ms(lambda: k3.score_at_pose_twin(*a3), 5),
        *cost_score_points(mc, g, *a3[4:7], query["pose"][None]))

    # K5: bitwise.
    a5 = occupancy.ray_tensors(rays, cfg.resolution, dev)
    hit, emp = k5.raymarch_counts(*a5)
    hitt, empt = k5.raymarch_counts_twin(*a5)
    require(torch.equal(hit, hitt) and torch.equal(emp, empt),
            "K5 counts differ from twin")
    hit2, emp2 = k5.raymarch_counts(*a5)
    require(torch.equal(hit, hit2) and torch.equal(emp, emp2),
            "K5 not bitwise reproducible")
    print(f"[3] K5 raymarch: {rays.starts.shape[0]} rays x "
          f"{rays.num_samples} samples on {rays.width}x{rays.height}, "
          f"{int(hit.sum())} hits, {int(emp.sum())} empty, bitwise equal")
    # K5: per ray and sample a cell index, a compare and a count (~12).
    out["raymarch"] = timed(
        0.0, cuda_ms(lambda: k5.raymarch_counts(*a5), 10),
        cuda_ms(lambda: k5.raymarch_counts_twin(*a5), 3),
        nbytes(*a5[:4], hit, emp), 12 * a5[0].shape[0] * a5[7])
    return out


def ops_ndt_build(rows: int, grids: int, points: int, cells: int) -> int:
    """K1: per point the transform, binning and six moment sums (~20
    operations), per cell the finalize (~40)."""
    return rows * grids * (20 * points + 40 * cells)


def used_beams(mc, points, point_mask, num_points: int):
    """A scan's subsampled beams: (points [B, 2], mask [B], used)."""
    from ndt_2d_tpu_torch.kernels.score_points import subsample
    return subsample(points, point_mask, num_points, mc.laser_max_beams)


def cells_read(mc, origin, cell_size, spts, smask, poses, patch_shift=None):
    """The distinct (grid, cell) keys, g * C + cell, that the beams spts
    [B, 2] (mask [B]) land in from poses [M, 3] on the grids of origin
    [(G,) 2]: each cell a kernel must read at least once.  With
    ``patch_shift`` (K2's first lattice offset) the 2x2 patch rows K2
    gathers instead: the clamped corner cell of the shifted beam."""
    import torch
    W, H = mc.grid_cells_x, mc.grid_cells_y
    origin = origin.reshape(-1, 2)
    c, s = torch.cos(poses[:, 2:3]), torch.sin(poses[:, 2:3])
    x = c * spts[:, 0] - s * spts[:, 1] + poses[:, 0:1]
    y = s * spts[:, 0] + c * spts[:, 1] + poses[:, 1:2]
    if patch_shift is not None:
        x, y = x + patch_shift, y + patch_shift
    ix = torch.floor((x[None] - origin[:, 0, None, None]) / cell_size).long()
    iy = torch.floor((y[None] - origin[:, 1, None, None]) / cell_size).long()
    ok = smask[None, None, :].expand_as(ix)
    if patch_shift is not None:
        ix, iy = ix.clamp(0, W - 2), iy.clamp(0, H - 2)
    else:
        ok = ok & (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    g = torch.arange(origin.shape[0], device=ix.device)[:, None, None]
    return torch.unique(((g * H + iy) * W + ix)[ok])


def cell_bytes(keys, count) -> int:
    """Bytes of the cells ``keys`` that a K3/K7 evaluation needs: each
    one's count (4 bytes) and, where it holds >= 5 points, its mean and
    information (20 bytes)."""
    return 4 * keys.numel() + 20 * int((count.reshape(-1)[keys] >= 5).sum())


def sum_costs(costs):
    """(bytes, operations) pairs of rows, added."""
    return tuple(map(sum, zip(*costs)))


def cost_candidate_scores(mc, origin, cell_size, points, point_mask,
                          num_points: int, pose, dths, dls):
    """K2's (bytes, operations) for one row: each distinct 2x2 patch row
    its used beams gather on its grids (128 bytes), the used beams (9
    bytes each), the start pose and the [13] output; ~16 operations (shift,
    compare, quadratic form, exp, sum) a (candidate, used beam) per grid."""
    import torch
    spts, smask, used = used_beams(mc, points, point_mask, num_points)
    grids = origin.reshape(-1, 2).shape[0]
    at = pose + torch.stack([torch.zeros_like(dths), torch.zeros_like(dths),
                             dths], -1)
    rows = cells_read(mc, origin, cell_size, spts, smask, at, dls[0])
    L = dls.numel()
    return (rows.numel() * 128 + used * 9 + 12 + 13 * 4,
            grids * dths.numel() * L * L * used * 16)


def cost_score_points(mc, grid, points, point_mask, num_points: int, poses):
    """K3's (bytes, operations) at poses [M, 3]: the cells its used beams
    land in (``cell_bytes``), the used beams, the poses and the M scores;
    ~20 operations a (pose, used beam, grid)."""
    spts, smask, used = used_beams(mc, points, point_mask, num_points)
    keys = cells_read(mc, grid.origin, grid.cell_size, spts, smask, poses)
    M, grids = poses.shape[0], grid.origin.reshape(-1, 2).shape[0]
    return (cell_bytes(keys, grid.count) + used * 9 + M * 16,
            M * grids * used * 20)


def cost_particles(mc, grid, points, point_mask, num_points: int, poses,
                   moved=None):
    """K3's particle launch's (bytes, operations) at poses [M, 3], or with
    the motion folded in at the ``moved`` poses: each distinct cell record
    the used beams land in (32 bytes), the used beams, the poses (and the
    noise read, the moved poses written) and the M scores; ~20 operations
    a (pose, used beam, grid) and, with the motion, ~40 a particle."""
    at = poses if moved is None else moved
    spts, smask, used = used_beams(mc, points, point_mask, num_points)
    keys = cells_read(mc, grid.origin, grid.cell_size, spts, smask, at)
    M, grids = at.shape[0], grid.origin.reshape(-1, 2).shape[0]
    motion = 0 if moved is None else M * (12 + 12)
    return (32 * keys.numel() + used * 9 + M * 16 + motion,
            M * grids * used * 20 + (0 if moved is None else 40 * M))


def cost_newton(mc, origin, cell_size, count, points, point_mask,
                num_points: int, start, final, iterations: int):
    """K7's (bytes, operations) for one row: the cells its used beams land
    in at the start and the refined pose (``cell_bytes``; every evaluation
    between reads cells near those), the used beams, the pose and the [13]
    row read and written; ~60 operations a (evaluation, used beam, grid)
    for the score, its gradient and Hessian terms, ~80 an iteration for
    the damped 3x3 solve."""
    import torch
    spts, smask, used = used_beams(mc, points, point_mask, num_points)
    keys = cells_read(mc, origin, cell_size, spts, smask,
                      torch.stack([start, final]))
    grids = origin.reshape(-1, 2).shape[0]
    return (cell_bytes(keys, count) + used * 9 + 12 + 2 * 13 * 4,
            (iterations + 1) * grids * used * 60 + iterations * 80)


def reset_counts():
    from ndt_2d_tpu_torch.kernels import (
        candidate_gather, candidate_scores, correlative, descriptor_search,
        descriptors, ndt_build, newton, normal_blocks, particle_filter,
        pose_chain, raymarch, score_points, shard_combine, slam_step)
    for m in (ndt_build, candidate_scores, score_points, raymarch, newton,
              candidate_gather, descriptors, descriptor_search,
              shard_combine, slam_step):
        m.launches = 0
    ndt_build.stripe_launches = score_points.stripe_launches = 0
    candidate_gather.field_launches = 0
    candidate_gather.field_match_launches = 0
    for m in (candidate_scores, candidate_gather):
        m.partial_launches = m.finalize_launches = 0
    candidate_scores.finalize_append_launches = 0
    candidate_scores.gather_finalize_launches = 0
    score_points.batch_launches = 0
    score_points.particle_launches = score_points.record_launches = 0
    descriptors.spectra_launches = 0
    pose_chain.launches = score_points.composed_launches = 0
    correlative.field_launches = correlative.match_launches = 0
    correlative.score_launches = 0
    for d in (normal_blocks.launches, particle_filter.launches):
        for k in d:
            d[k] = 0


def read_counts() -> dict:
    from ndt_2d_tpu_torch.kernels import (
        candidate_gather, candidate_scores, correlative, descriptor_search,
        descriptors, ndt_build, newton, normal_blocks, particle_filter,
        pose_chain, raymarch, score_points, shard_combine, slam_step)
    out = {"ndt_build": ndt_build.launches,
           "ndt_build_stripe": ndt_build.stripe_launches,
           "stripe_score": score_points.stripe_launches,
           "stripe_field": candidate_gather.field_launches,
           "field_match": candidate_gather.field_match_launches,
           "slam_append": slam_step.launches,
           "candidate_finalize_append":
               candidate_scores.finalize_append_launches,
           "candidate_partials": candidate_scores.partial_launches,
           "candidate_finalize": candidate_scores.finalize_launches,
           "candidate_gather_partials": candidate_gather.partial_launches,
           "candidate_gather_finalize":
               candidate_scores.gather_finalize_launches,
           "field_fold": candidate_gather.finalize_launches,
           "rank_sum": shard_combine.launches,
           "window_append": pose_chain.launches,
           "score_points_compose": score_points.composed_launches,
           "correlative_field": correlative.field_launches,
           "correlative_match": correlative.match_launches,
           "correlative_score": correlative.score_launches,
           "candidate_scores": candidate_scores.launches,
           "candidate_gather": candidate_gather.launches,
           "descriptors": descriptors.launches,
           "descriptor_spectra": descriptors.spectra_launches,
           "descriptor_search": descriptor_search.launches,
           "score_points": score_points.launches,
           "score_points_batch": score_points.record_launches,
           "score_points_batch_soa": score_points.batch_launches,
           "pf_motion_score": score_points.particle_launches,
           "raymarch": raymarch.launches, "newton": newton.launches}
    out.update(normal_blocks.launches)
    out.update(particle_filter.launches)
    return out


def run_session(cfg, bag, device, n=None, mapper=None):
    """Map ``bag`` (its first ``n`` scans) through the port (``mapper``,
    else a new one); returns (stats, grid, per-scan seconds, corrections,
    accepted flags, mapper)."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.mapping import runtime
    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    from ndt_2d_tpu_torch.io.bag import ScanBag
    if n is not None:
        bag = ScanBag(ranges=bag.ranges[:n], angle_min=bag.angle_min,
                      angle_increment=bag.angle_increment,
                      time_increment=bag.time_increment,
                      range_max=bag.range_max, odom=bag.odom[:n],
                      truth=bag.truth[:n])
    mapper = mapper or Mapper(cfg, device=device)
    stamps, corr, accepted = [time.perf_counter()], [], []

    def progress(t, res):
        stamps.append(time.perf_counter())
        corr.append(res.correction if res.correction is not None
                    else np.zeros(3))
        accepted.append(res.accepted)

    stats = runtime.run_bag(mapper, bag, progress=progress)
    grid = mapper.render_map()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return (stats, grid, np.diff(stamps), np.asarray(corr),
            np.asarray(accepted), mapper)


def session_numbers(stats, bag, dt) -> dict:
    """ms/scan (median over scans 4 on), ATE, aligned ATE, odometry's."""
    import numpy as np

    from ndt_2d_tpu_torch.utils import metrics
    return dict(ms=float(np.median(dt[4:]) * 1e3), ate=stats["ate_rmse_m"],
                aligned=metrics.ate_rmse_aligned(
                    stats["_est"], bag.truth[stats["_est_t"]]),
                odom=stats["odom_ate_rmse_m"])


def phase_session(cfg, bag, dev):
    import numpy as np
    reset_counts()
    stats, grid, dt, _, _, mapper = run_session(cfg, bag, dev)
    launches = read_counts()
    numbers = session_numbers(stats, bag, dt)
    acc = stats["scans_accepted"]
    require(acc == len(bag), f"accepted {acc} of {len(bag)} scans")
    # K13 appends every accepted scan but the first (which fills the
    # window from the graph) to the window: one launch each, no eager
    # shift.
    for k in ("ndt_build", "candidate_scores", "score_points",
              "window_append"):
        require(launches[k] == acc - 1,
                f"{k} launched {launches[k]} times, expected {acc - 1}")
    require(launches["raymarch"] >= 1, "raymarch never launched")
    ate, odom = stats["ate_rmse_m"], stats["odom_ate_rmse_m"]
    require(np.isfinite(ate) and ate < odom,
            f"ATE {ate} not below odometry's {odom}")
    occupied = int((grid.data == 100).sum())
    require(occupied > 0, "occupancy grid has no occupied cells")
    ms = float(np.median(dt[4:]) * 1e3)
    print(f"[4a] {acc}/{len(bag)} scans accepted, "
          f"{stats['graph_constraints']} constraints, ATE {ate:.4f} m "
          f"(odometry {odom:.4f} m), {ms:.3f} ms/scan median (scans 4+), "
          f"grid {grid.data.shape[0]}x{grid.data.shape[1]} with {occupied} "
          f"occupied cells; launches {launches}")

    # The same decisions as the plain twins on a small input.
    n = 20
    sg, gg, _, cg, _, _ = run_session(cfg, bag, dev, n)
    sc, gc, _, cc, _, _ = run_session(cfg, bag, "cpu", n)
    require(sg["scans_accepted"] == sc["scans_accepted"]
            and sg["graph_constraints"] == sc["graph_constraints"],
            "GPU and CPU-twin sessions differ in accepted scans")
    dc = np.abs(cg - cc)
    require(bool((dc <= [0.005, 0.005, 0.0025]).all()),
            "a correction differs from the twin session by > 1 lattice step")
    exact = float(np.mean(np.all(dc < 1e-6, axis=1)))
    require(exact >= 0.9, f"only {exact:.2f} of corrections equal the twins'")
    same = (float(np.mean(gg.data == gc.data))
            if gg.data.shape == gc.data.shape else 0.0)
    require(same >= 0.995, f"only {same:.4f} of occupancy cells agree")
    print(f"[4a] first {n} scans, GPU vs CPU twins: {exact:.2f} of "
          f"corrections equal, ATE {sg['ate_rmse_m']:.5f} vs "
          f"{sc['ate_rmse_m']:.5f}, {same:.4f} of grid cells equal")
    return launches, numbers, mapper.graph.poses.copy()


# BASELINE.json config 3, the synchronous arm of
# benchmarks/run_benchmarks.py:248-276, as flags of ``run``.
OFFICE_FLAGS = [
    "--local_scan_matcher.grid_cells", "192",
    "--global_scan_matcher.grid_cells", "160",
    "--global_scan_matcher.ndt_resolution", "0.35",
    "--global_scan_matcher.search_linear_size", "0.15",
    "--global_scan_matcher.search_linear_resolution", "0.01",
    "--global_scan_matcher.search_angular_size", "0.05",
    "--max-points-per-scan", "512", "--global-search-size", "4.0",
    "--optimization-node-limit", "10", "--loop-closure-every", "20",
    "--minimum-travel-distance", "0.3"]


def office_config(*extra):
    """Config 3 as ``run`` builds it from OFFICE_FLAGS and ``extra`` (the
    parser requires ``--bag``; building the config does not read it)."""
    from ndt_2d_tpu_torch import cli
    return cli._mapper_config(cli._build_parser().parse_args(
        ["run", "--bag", "office.npz", *OFFICE_FLAGS, *extra]))


def office_bag():
    from ndt_2d_tpu_torch.io.bag import record_synthetic
    return record_synthetic("office", OFFICE_SCANS, n_beams=N_BEAMS,
                            range_max=12.0, seed=1, odom_trans_noise=0.02,
                            odom_rot_noise=0.004)


def office_rows(cfg, bag, dev, rows=ROWS, region=(0, 10),
                shift=(0.0, 0.0, 0.0)):
    """``rows`` confirmation rows of real office windows: the region of
    scans k + ``region`` at its odometry poses, matched by scan k + 15 from
    its own odometry pose plus ``shift``, for k spread over the bag."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.mapping import laser
    P = cfg.max_points_per_scan
    cols = [[] for _ in range(8)]
    for r in range(rows):
        k = 20 + r * (OFFICE_SCANS - 60) // rows
        members = [k + d for d in region]
        win = [laser.project_scan(bag[t][0], bag.range_max, np.zeros(3),
                                  False, None, P) for t in members]
        qp, qm = laser.project_scan(bag[k + 15][0], bag.range_max,
                                    np.zeros(3), False, None, P)
        for c, v in zip(cols, (bag.odom[members],
                               np.stack([w[0] for w in win]),
                               np.stack([w[1] for w in win]),
                               np.ones(len(members), bool), qp, qm, qm.sum(),
                               bag.odom[k + 15] + np.asarray(shift))):
            c.append(v)
    dtypes = (torch.float32, torch.float32, torch.bool, torch.bool,
              torch.float32, torch.bool, torch.int32, torch.float32)
    return [torch.tensor(np.stack(c), dtype=d, device=dev)
            for c, d in zip(cols, dtypes)]


def padded_rows(rows, n, pad):
    """The first ``n`` rows zero-padded to ``pad`` (the mapper's padding)."""
    import torch
    out = []
    for t in rows:
        p = torch.zeros((pad,) + tuple(t.shape[1:]), dtype=t.dtype,
                        device=t.device)
        p[:n] = t[:n]
        out.append(p)
    return out


def check_build(g, tab, gt, tabt, what):
    """K1's grid and patch table bitwise against the twin's."""
    import torch
    for f in ("origin", "mean", "information", "covariance", "count"):
        require(torch.equal(getattr(g, f), getattr(gt, f)),
                f"{what}: {f} differs")
    require(torch.equal(tab, tabt), f"{what}: patch table differs")


def one_row(res):
    """A twin's MatchResult of one scan as the kernel's [1, 13] row."""
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    return k2.pack(k2.MatchResult(*[x[None] for x in res]))


def check_match(out, scores, twin_out, twin_scores, what):
    """K2's candidate scores and [R, 13] output rows (score, correction,
    covariance) bitwise against the twin's."""
    import torch
    require(torch.equal(scores, twin_scores), f"{what}: scores differ")
    require(torch.equal(out, twin_out), f"{what}: output rows differ")


def phase_rows(cfg, bag, dev):
    """K1/K2/K7 over ROWS confirmation rows at config-3 shapes."""
    import dataclasses

    import torch

    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.kernels import newton as k7
    from ndt_2d_tpu_torch.matching import matcher, newton
    gm = cfg.global_scan_matcher
    rmax = 12.0
    rows = office_rows(cfg, bag, dev)
    win, query = rows[:4], rows[4:]
    dths, dls = matcher._search_offsets(gm, dev)
    build = (rmax, gm.ndt_resolution, gm.grid_cells_x, gm.grid_cells_y)

    def k1_run():
        return k1.build_windows(*win, *build)

    def k1_twin():
        return k1.build_windows_twin(*win, *build)

    (g, tab), (gt, tabt) = k1_run(), k1_twin()
    torch.cuda.synchronize()
    check_build(g, tab, gt, tabt, "K1 rows")
    check_build(g, tab, *k1_run(), "K1 rows (reproducibility)")

    def k2_run(scores=False):
        return k2.match_rows(gm, g, tab, *query, dths, dls,
                             with_scores=scores)

    def k2_twin():
        return k2.match_rows_twin(gm, g, tab, *query, dths, dls)

    (k2_out, sc), (rest, sct) = k2_run(True), k2_twin()
    torch.cuda.synchronize()
    check_match(k2_out, sc, k2.pack(rest), sct, "K2 rows")
    check_match(k2_out, sc, *k2_run(True), "K2 rows (reproducibility)")

    # K7 over the rows: the office recipe's global polish (G = 1, 8
    # iterations) from K2's rows of the card, against its twin.
    rcfg = dataclasses.replace(gm, refine_iterations=8)

    def k7_run(c=rcfg):
        return k7.refine_rows(c, g, tab, *query, k2_out.clone(), 8)

    def k7_twin(c=rcfg):
        return k7.refine_rows_twin(c, newton.with_row_grid_axes(g, True),
                                   *query, k2_out.clone(), 8)
    o7, o7t = k7_run(), k7_twin()
    torch.cuda.synchronize()
    require(torch.equal(o7, o7t), "K7 rows differ from the twin")
    require(torch.equal(o7, k7_run()), "K7 rows not bitwise reproducible")
    # The other warp counts a grid (S = 1, 2, 3) and lanes over more
    # strides than S = 4 warps (200 beams), through the beams a row.
    for beams in (20, 40, 90, 200):
        c = dataclasses.replace(rcfg, laser_max_beams=beams)
        require(torch.equal(k7_run(c), k7_twin(c)),
                f"K7 rows differ from the twin at {beams} beams "
                f"({k7.plan(beams, 1).strides} warps a grid)")
    n_moved = int((o7[:, 1:4] != k2_out[:, 1:4]).any(dim=1).sum())

    # Row independence, without and with K7: the R = ROWS batch against
    # R = 1 launches and against the first rows at pad 4 and pad 16.
    for cfg in (gm, rcfg):
        full = matcher.match_scan_batch_multi(cfg, *win, rmax, *query)
        for r in range(ROWS):
            one = matcher.match_scan_batch_multi(
                cfg, *[t[r:r + 1] for t in win], rmax,
                *[t[r:r + 1] for t in query])
            require(all(torch.equal(a[r], b[0]) for a, b in zip(full, one)),
                    f"row {r} differs between R = {ROWS} and R = 1 "
                    f"(refine_iterations {cfg.refine_iterations})")
        for pad in (4, 16):
            p = padded_rows(rows, 3, pad)
            out = matcher.match_scan_batch_multi(cfg, *p[:4], rmax, *p[4:])
            require(all(torch.equal(a[:3], b[:3])
                        for a, b in zip(full, out)),
                    f"rows differ at pad {pad} (refine_iterations "
                    f"{cfg.refine_iterations})")
            require(bool((out[0][3:] == 0).all()),
                    f"padding rows at pad {pad} scored")
    n_live = int((k2_out[:, 0] < 0).sum())
    print(f"[3] K1/K2/K7 rows: {ROWS} office rows x {gm.grid_cells_x}^2 "
          f"cells x {dths.numel()}x{dls.numel()}x{dls.numel()} candidates, "
          f"{n_live} rows scored; K1, K2 (scores and rows) and K7 (8 "
          f"iterations; also at 20, 40, 90 and 200 beams) bitwise equal "
          f"to their twins, {n_moved} rows moved "
          f"off the lattice by K7; each row bitwise equal to its R = 1 "
          f"launch and at pad 4 and 16, without and with K7")
    S, P = win[1].shape[1], win[1].shape[2]
    C = gm.grid_cells_x * gm.grid_cells_y
    qp, qm, qn, qpose = query
    tile_variants(gm, g.origin, tab, query, dths, dls, k2_out,
                  f"{ROWS} config-3 rows")
    return {"ndt_build_rows": timed(
                0.0, cuda_ms(k1_run, 20), cuda_ms(k1_twin, 2),
                nbytes(*win, g.origin, g.mean, g.information, g.covariance,
                       g.count, tab), ops_ndt_build(ROWS, 1, S * P, C)),
            "candidate_scores_rows": timed(
                0.0, cuda_ms(k2_run, 20), cuda_ms(k2_twin, 2),
                *sum_costs(cost_candidate_scores(
                    gm, g.origin[r], g.cell_size, qp[r], qm[r], int(qn[r]),
                    qpose[r], dths, dls) for r in range(ROWS))),
            "newton_rows": timed(
                0.0, cuda_ms(lambda o=k2_out.clone(): k7.refine_rows(
                    rcfg, g, tab, *query, o, 8), 20), cuda_ms(k7_twin, 2),
                *sum_costs(cost_newton(
                    gm, g.origin[r], g.cell_size, g.count[r], qp[r], qm[r],
                    int(qn[r]), qpose[r] + k2_out[r, 1:4],
                    qpose[r] + o7[r, 1:4], 8) for r in range(ROWS)))}


def tile_variants(mc, origin, tables, query, dths, dls, ref, what):
    """K2 over the rows ``query`` (points, mask, counts, poses) with each
    thread tile the kernel is built for (``tile_plan`` with the tile
    forced): rows bitwise the planned launch's ``ref``, and each tile's
    time alone on the device.  These launches are comparisons and are not
    counted."""
    import torch

    from ndt_2d_tpu_torch.kernels import _build
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    qp, qm, qn, qpose = query
    A, L, R = dths.shape[0], dls.shape[0], qp.shape[0]
    sms = _build.sm_count(qp.device.index)
    chosen = k2.tile_plan(A, L, R, sms)
    parts = []
    for tile in k2.TILES:
        def run(plan=k2.tile_plan(A, L, R, sms, tile)):
            return k2.launch_rows("ndt2d_candidate_scores", A, mc, origin,
                                  mc.ndt_resolution, tables, qp, qm, qn, 0,
                                  qpose, dths, dls, False, plan)[0]
        out = run()
        torch.cuda.synchronize()
        require(torch.equal(out, ref), f"K2 {what} with the {tile} tile "
                "differs from the planned launch")
        parts.append(f"{tile[0]}x{tile[1]} {graph_ms(run, 10):.5f}")
    print(f"[3] K2 thread tiles, {what} (plan {chosen.kx}x{chosen.ky}, "
          f"{chosen.threads} threads): rows bitwise equal for every tile; in "
          f"a CUDA graph, ms: " + ", ".join(parts))


def phase_k1_stress(dev):
    """K1 (and KB1) at the edges of its sort, each bitwise against its twin
    and reproducible: every valid point of a 38,400-point window (75 x 512,
    a tenth masked) in one cell; three windows of 7 x 611 points (4277: no
    multiple of the 4096-point tile) at G = 1 and G = 4; a window with no
    valid point beside a full one, each row bitwise its R = 1 build."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    rng = np.random.default_rng(11)
    W = H = 192
    cell, rmax = 0.25, 15.0

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=dev)

    def check(what, run, twin):
        (g, tab), (gt, tabt) = run(), twin()
        torch.cuda.synchronize()
        check_build(g, tab, gt, tabt, what)
        check_build(g, tab, *run(), f"{what} (reproducibility)")
        return g

    def window(R, S, P, keep):
        poses = np.concatenate([rng.uniform(-2, 2, (R, S, 2)),
                                rng.uniform(-np.pi, np.pi, (R, S, 1))], -1)
        pts = rng.uniform(-9, 9, (R, S, P, 2))
        return (t(poses), t(pts), t(rng.random((R, S, P)) < keep,
                                    torch.bool),
                t(np.ones((R, S), bool), torch.bool))

    # Every valid point in one cell: all poses 0, all points (0.1, 0.1).
    S, P = 75, 512
    one = (t(np.zeros((1, S, 3))), t(np.full((1, S, P, 2), 0.1)),
           t(rng.random((1, S, P)) < 0.9, torch.bool),
           t(np.ones((1, S), bool), torch.bool))
    build = (rmax, cell, W, H)
    g = check("K1, one cell", lambda: k1.build_windows(*one, *build),
              lambda: k1.build_windows_twin(*one, *build))
    full = int(g.count.max())
    require(full == int(one[2].sum()), "K1, one cell: the cell holds "
            f"{full} of {int(one[2].sum())} valid points")
    ms = cuda_ms(lambda: k1.build_windows(*one, *build), 5)
    stripe = dict(poses=one[0][0], points=one[1][0], point_mask=one[2][0],
                  window_mask=one[3][0], origin=g.origin[0], cell_size=cell,
                  width=W, row0=0, rows=H // 2)
    check("KB1, one cell", lambda: k1.build_stripe(**stripe),
          lambda: k1.build_stripe_twin(**stripe))
    # N = 7 x 611 = 4277 points a row, three rows, one and four grids.
    ragged = window(3, 7, 611, 0.95)
    for grids in (1, 4):
        check(f"K1, 3 rows of 4277 points, G = {grids}",
              lambda: k1.build_windows(*ragged, *build, grids=grids),
              lambda: k1.build_windows_twin(*ragged, *build, grids=grids))
    # Row 0 without a valid point, row 1 full; each as its own launch.
    pair = list(window(2, 10, 512, 1.0))
    pair[2][0] = False
    g = check("K1, a window with no valid point",
              lambda: k1.build_windows(*pair, *build),
              lambda: k1.build_windows_twin(*pair, *build))
    require(int(g.count[0].sum()) == 0, "K1: a window without points "
            "counted some")
    for r in range(2):
        g1, tab1 = k1.build_windows(*[x[r:r + 1] for x in pair], *build)
        require(torch.equal(g1.count, g.count[r:r + 1]) and
                torch.equal(g1.mean, g.mean[r:r + 1]),
                f"K1: row {r} differs from its R = 1 build")
    print(f"[3] K1 stress: every valid point ({full}) of a 38,400-point "
          f"window in one cell ({ms:.4f} ms a build), 3 rows of 4277 "
          f"points at G = 1 and 4, a window with no valid point: K1 and "
          f"KB1 bitwise equal to their twins and reproducible")


def phase_k2_edges(cfg3, bag3, dev):
    """K2 at the edges of its range on the 64 config-3 windows: 32 x 32
    offsets and 512 angles, at R = 1 and R = 64: scores and rows bitwise
    against the twin, the R = 1 row bitwise row 0 of the 64."""
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.ndt import grid as ndt_grid
    gm = cfg3.global_scan_matcher
    rows = office_rows(cfg3, bag3, dev)
    g, tab = k1.build_windows(*rows[:4], 12.0, gm.ndt_resolution,
                              gm.grid_cells_x, gm.grid_cells_y)
    A, L = 512, 32
    f32 = torch.float32
    dths = -0.4 + torch.arange(A, dtype=f32, device=dev) * (0.8 / (A - 1))
    dls = -0.155 + torch.arange(L, dtype=f32, device=dev) * 0.01
    outs = {}
    for R in (1, ROWS):
        gr = ndt_grid.NDTGrid(origin=g.origin[:R], cell_size=g.cell_size,
                              mean=None, information=None, count=None,
                              covariance=None)
        q = [x[:R] for x in rows[4:]]
        out, sc = k2.match_rows(gm, gr, tab[:R], *q, dths, dls,
                                with_scores=True)
        rest, sct = k2.match_rows_twin(gm, gr, tab[:R], *q, dths, dls)
        torch.cuda.synchronize()
        check_match(out, sc, k2.pack(rest), sct,
                    f"K2 at {A} x {L} x {L}, R = {R}")
        outs[R] = out
    require(torch.equal(outs[1][0], outs[ROWS][0]),
            "K2 at the range edge: row 0 differs between R = 1 and R = 64")
    print(f"[3] K2 at the range edge ({A} angles x {L} x {L} offsets) at "
          f"R = 1 and R = {ROWS}: scores and rows bitwise equal to the "
          f"twin, row 0 equal across R")


def kernel_times(dev, ident: str, map4: str, bag4) -> dict:
    """Kernels at the main path's shapes, the one source of their
    comparison rows: CUDA events around back-to-back calls (``cuda_ms``,
    host launch included), alone on the device (``graph_ms``) and the
    host's time a call with the device idle (``host_us``, the median of
    101 calls, synchronized outside the timed call): K1 and K2 at config
    2's window, config 8's (G = 4), 64 config-3 rows, K12's partials over
    those rows (the first of two angle blocks), K12's K2 finalize at
    config 2 and over those rows and the fused step's finalize and KB4
    (``split_times``, ``fold_times``) and KB1 (stripe 0 of 2 of
    config 4's map ``map4``, mapped from ``bag4``); K9, K6, K12's K6
    partials, KB3 and K3 (``pr_times``); and K7 at its three
    shapes: 64 config-3 rows (G = 1, 8 iterations), config 8's match (G =
    4, 10 iterations) and config 2's window at R = 1 (G = 1, 10
    iterations), refining a copy of K2's rows in place call after call
    (the start moves within the trust region; the number of evaluations,
    and so the work, is fixed); K5 at config 2's export (102,400 rays x
    640 samples).  It calls only the wrappers' public
    entries (K7's as this tree or, before K7 read K1's table, as that tree
    calls it), so ``--kernel-times`` in an older checkout times that
    checkout's kernels."""
    import dataclasses

    import torch

    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.kernels import newton as k7
    from ndt_2d_tpu_torch.matching import matcher, newton
    from ndt_2d_tpu_torch.kernels import raymarch as k5
    from ndt_2d_tpu_torch.mapping import occupancy
    from ndt_2d_tpu_torch.parallel import matcher as pmatcher
    _, cfg, win, query, rays = inputs(dev)
    out = {}
    k7_cases = []
    table_k7 = hasattr(k7, "row_tables")  # K7 reads K1's table

    def both(name, fn, reps):
        out[name] = {"cuda_ms": cuda_ms(fn, reps),
                     "graph_ms": graph_ms(fn, reps),
                     "host_us": host_us(fn, 101, sync=True)}
    a5 = occupancy.ray_tensors(rays, cfg.resolution, dev)
    both(f"K5 config-2 export ({rays.starts.shape[0]} rays x "
         f"{rays.num_samples} samples)", lambda: k5.raymarch_counts(*a5), 20)
    for name, mc, grids in (("config 2", cfg.local_scan_matcher, 1),
                            ("config 8 (G = 4)",
                             config8(cfg).local_scan_matcher, 4)):
        b = dict(range_max=15.0, cell_size=mc.ndt_resolution,
                 width=mc.grid_cells_x, height=mc.grid_cells_y, grids=grids)
        g, tab = k1.build_window(**win, **b)
        dths, dls = matcher._search_offsets(mc, dev)
        a = (mc, g, tab, query["points"], query["point_mask"],
             query["num_points"], query["pose"], dths, dls)
        both(f"K1 {name}", lambda b=b: k1.build_window(**win, **b), 20)
        both(f"K2 {name}", lambda a=a: k2.match(*a), 20)
        nums = torch.tensor([query["num_points"]], dtype=torch.int32,
                            device=dev)
        k7_cases.append((
            f"{name} (R = 1, G = {grids}, 10 iterations)",
            dataclasses.replace(mc, refine_iterations=10),
            newton.with_row_grid_axes(g, rows_axis=False),
            k7.row_tables(tab, rows_axis=False) if table_k7 else None,
            (query["points"][None], query["point_mask"][None], nums,
             query["pose"][None]), k2.match(*a)))
    cfg3 = office_config()
    gm = cfg3.global_scan_matcher
    rows = office_rows(cfg3, office_bag(), dev)
    build = (12.0, gm.ndt_resolution, gm.grid_cells_x, gm.grid_cells_y)
    gr, tabs = k1.build_windows(*rows[:4], *build)
    dths, dls = matcher._search_offsets(gm, dev)
    a0, n = pmatcher.angle_block(dths.shape[0], 2, 0)
    both(f"K1 {ROWS} config-3 rows",
         lambda: k1.build_windows(*rows[:4], *build), 10)
    both(f"K2 {ROWS} config-3 rows",
         lambda: k2.match_rows(gm, gr, tabs, *rows[4:], dths, dls), 10)
    both(f"K12 K2 partials, {ROWS} rows, {n} of {dths.shape[0]} angles",
         lambda: k2.partial_rows(gm, gr, tabs, *rows[4:], dths, dls, a0, n),
         10)
    rows2 = k2_row(cfg.local_scan_matcher, win, query, dev)
    split_times(both, cfg.local_scan_matcher, rows2,
                "config 2 (R = 1, 80 angles, S = 2)", dev)
    split_times(both, gm, (gr, tabs, *rows[4:]),
                f"{ROWS} config-3 rows (40 angles, S = 2)", dev)
    fold_times(both, cfg.local_scan_matcher, rows2, query, dev)
    k7_cases.insert(0, (
        f"{ROWS} config-3 rows (G = 1, 8 iterations)",
        dataclasses.replace(gm, refine_iterations=8), gr, tabs,
        tuple(rows[4:]), k2.match_rows(gm, gr, tabs, *rows[4:], dths, dls)))
    for name, mc, g, tab, q, k2_out in k7_cases:
        a = (mc, g, tab, *q) if table_k7 else (mc, g, *q)
        both(f"K7 {name}", lambda a=a, o=k2_out.clone(),
             it=mc.refine_iterations: k7.refine_rows(*a, o, it), 20)
    m, kf = blocks_map(map4, config4_configs()[1], bag4.range_max, dev)
    mc = m.config
    sa = dict(**kf, origin=m.grid.origin, cell_size=mc.ndt_resolution,
              width=mc.grid_cells_x, row0=0, rows=mc.grid_cells_y // 2)
    both("KB1 stripe 0 of 2", lambda: k1.build_stripe(**sa), 20)
    pr_times(dev, ident, both, map4, bag4, m, kf, cfg, win, query)
    walls = lm_times(dev, ident, both)
    walls.update(cg_times(dev, ident))
    for name, t in out.items():
        print(f"[5] {name}: {t['cuda_ms']:.4f} ms, in a CUDA graph "
              f"{t['graph_ms']:.5f} ms, host {t['host_us']:.1f} us a call "
              f"({ident})")
    out.update(walls)
    return out


def k2_row(mc, win, query, dev):
    """Config 2's window and query scan as K2's one-row arguments (grid,
    tables, points, mask, counts, poses)."""
    import torch

    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.ndt import grid as ndt_grid
    g, tab = k1.build_window(**win, range_max=15.0,
                             cell_size=mc.ndt_resolution,
                             width=mc.grid_cells_x, height=mc.grid_cells_y)
    row = ndt_grid.NDTGrid(origin=g.origin[None], cell_size=g.cell_size,
                           mean=None, information=None, count=None,
                           covariance=None)
    return (row, tab[None], query["points"][None], query["point_mask"][None],
            torch.tensor([query["num_points"]], dtype=torch.int32,
                         device=dev), query["pose"][None])


def parent_stack(mc, rows, dths, dls, S: int):
    """The stack a search of ``rows`` split S ways gathered before the
    plan: each rank's partials padded to its block with (+inf, 0) slots,
    [S, R, blk, 12]."""
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.parallel import matcher as pmatcher
    A, R = dths.shape[0], rows[2].shape[0]
    blk = -(-A // S)
    mine = []
    for s in range(S):
        a0, n = pmatcher.angle_block(A, S, s)
        pad = torch.zeros(R, blk - n, 12, device=rows[2].device)
        pad[..., 0] = math.inf
        part = [k2.partial_rows(mc, *rows, dths, dls, a0, n)] if n else []
        mine.append(torch.cat(part + [pad], 1))
    return torch.stack(mine)


def split_times(both, mc, rows, name, dev):
    """K12's K2 finalize through ``both``: from the gathered stack of a
    2-way split (this tree: the plan's finalize reading it in place; a tree
    without plans: its reordering copy, then ``finalize_rows``), and the
    unplanned ``finalize_rows`` on one [R, A, 12] buffer (both trees)."""
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.matching import matcher
    dths, dls = matcher._search_offsets(mc, dev)
    A, R, nums = dths.shape[0], rows[2].shape[0], rows[4]
    stack = parent_stack(mc, rows, dths, dls, 2)
    full = stack.permute(1, 0, 2, 3).reshape(R, -1, 12)[:, :A].contiguous()
    if hasattr(k2, "split_plan"):
        plan = split_stack(mc, rows, dths, dls, 2, dev)

        def gathered():
            return plan.finalize(mc, plan.stack, nums, dths, dls)
    else:
        def gathered():
            every = stack.permute(1, 0, 2, 3).reshape(R, -1, 12)
            return k2.finalize_rows(mc, every[:, :A].contiguous(), nums,
                                    dths, dls)
    both(f"K12 K2 finalize from the stack, {name}", gathered, 50)
    both(f"K12 K2 finalize_rows on [R, A, 12], {name}",
         lambda: k2.finalize_rows(mc, full, nums, dths, dls), 50)


def fold_times(both, mc, rows, query, dev):
    """The fused step's finalize and KB4 at config 2 (R = 1, S = 2, the
    256-slot state of 512-point scans) through ``both``: this tree's one
    ``finalize_append`` launch, or a tree's finalize then KB4; and KB4
    alone (``kb4.append``: through the state's plan where the tree plans
    it); in a tree with plans, both launch paths piece by piece."""
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import slam_step as kb4
    from ndt_2d_tpu_torch.matching import matcher
    from ndt_2d_tpu_torch.parallel import slam_step
    dths, dls = matcher._search_offsets(mc, dev)
    A, nums = dths.shape[0], rows[4]
    P = query["points"].shape[0]
    st = slam_step.init_state(SLAM_CAPACITY, P, SLAM_CAPACITY, dev)
    st.prev_pose.copy_(torch.tensor([1.0, 2.0, 0.3], device=dev))
    est = torch.tensor([1.2, 2.05, 0.31], device=dev)
    scan = (query["points"], query["point_mask"])
    corr = torch.tensor([0.005, -0.01, 0.0025], device=dev)
    cov = torch.tensor([[2e-4, 1e-5, 2e-6], [1e-5, 3e-4, -1e-6],
                        [2e-6, -1e-6, 4e-5]], device=dev)
    a4 = (est, corr, cov, *scan, 7, 6, True)
    planned = hasattr(k2, "split_plan")
    if planned:
        plan = split_stack(mc, rows, dths, dls, 2, dev)
        fold = kb4.Append(kb4.plan_for(st), est, *scan, 7, 6, True)

        def step_end():
            return plan.finalize(mc, plan.stack, nums, dths, dls, fold)
    else:
        stack = parent_stack(mc, rows, dths, dls, 2)

        def step_end():
            every = stack.permute(1, 0, 2, 3).reshape(1, -1, 12)
            out = k2.finalize_rows(mc, every[:, :A].contiguous(), nums, dths,
                                   dls)
            kb4.append(st, est, out[0, 1:4], out[0, 4:13].view(3, 3), *scan,
                       7, 6, True)
    both("K12 K2 finalize + KB4 at config 2 (S = 2)", step_end, 50)
    both("KB4 (256 slots, 512 points)", lambda: kb4.append(st, *a4), 50)
    if planned:
        planned_launch_path(plan, mc, nums, dths, dls, kb4.plan_for(st), a4,
                            dev)


def planned_launch_path(plan, mc, nums, dths, dls, slam, a4, dev) -> dict:
    """The host side of a planned finalize (config 2, S = 2) and of KB4
    through the state's plan ``slam``, piece by piece (``host_us``, back to
    back)."""
    import torch

    from ndt_2d_tpu_torch.kernels import _build
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import slam_step as kb4
    plain, _ = k2._planned_functions()
    at = plan._at[plan.stack.data_ptr()]
    out = plan.send.new_empty(plan._out_shape)
    st = _build.stream_ptr(dev)
    kb4_fn = kb4._function()
    ptrs = [t.data_ptr() for t in a4[:5]]
    pieces = {
        "finalize": lambda: plan.finalize(mc, plan.stack, nums, dths, dls),
        "require_all (num_points)": lambda: _build.require_all(
            dev, (nums,), plan._nums_expect),
        "new_empty": lambda: plan.send.new_empty(plan._out_shape),
        "stream_ptr": lambda: _build.stream_ptr(dev),
        "finalize ctypes call": lambda: plain(at, nums.data_ptr(), 0,
                                              out.data_ptr(), st),
        "KB4 (kb4.append)": lambda: kb4.append(slam.state, *a4),
        "KB4 plan_for": lambda: kb4.plan_for(slam.state),
        "KB4 SlamPlan.append": lambda: slam.append(*a4),
        "KB4 check (5 tensors, slots)": lambda: slam.check(*a4[:7]),
        "KB4 ctypes call": lambda: kb4_fn(slam.address, 1, 7, 6, 6, *ptrs,
                                          st)}
    us = {k: host_us(f, 2000) for k, f in pieces.items()}
    torch.cuda.synchronize()
    print("[5] K12 planned finalize and KB4, launch path, host us a "
          "call: " + ", ".join(f"{k} {v:.3f}" for k, v in us.items()))
    return us


def pr_times(dev, ident, both, map4, bag4, m4, kf, cfg, win, query):
    """The rows the K9 / K6 redesign moves, and K3, through ``both``: K9's
    resample at config 4's 5000 and config 7's 20,000 particles, plain and
    with recovery, its statistics and EWMA entries (``pf_case``'s inputs),
    and the host time that making a resample's scratch would add to a
    call (printed, ``ident`` the card); K6 over config 6's 32 coarse
    rows and at the merge's shape (``phase_k6``'s inputs), K12's K6
    partials over those rows (the first of two angle blocks), KB3's field
    (a localization scan on stripe 0 of 2 of config 4's map ``m4``); K3 at
    M = 1 on config 3's local window (the office bag's first scans), at
    G = 4 on config 8's window (config 2's ``cfg``, ``win``, ``query``)
    and over config 4's 5000 poses."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.io.bag import record_synthetic
    from ndt_2d_tpu_torch.kernels import candidate_gather as k6
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.kernels import particle_filter as k9
    from ndt_2d_tpu_torch.kernels import score_points as k3
    from ndt_2d_tpu_torch.mapping import laser, merge
    from ndt_2d_tpu_torch.matching import matcher
    from ndt_2d_tpu_torch.parallel import matcher as pmatcher
    m, pcfg, scan, center = pf_setup(map4, bag4, dev)
    for M in (PARTICLES, GLOBAL_PARTICLES):
        # K9's calls are host-bound and short: 200 of them a reading.
        c = pf_case(m, pcfg, scan, center, M, dev)
        both(f"K9 resample {M}", lambda a=c.args: k9.resample(*a), 200)
        both(f"K9 resample {M}, recovery",
             lambda a=c.args, r=c.rec: k9.resample(*a, r), 200)
        both(f"K9 statistics {M}",
             lambda c=c: k9.statistics(c.pm, c.sc, c.n_in), 200)
        both(f"K9 ewma {M}",
             lambda c=c: k9.ewma(c.sc, c.n_in, c.w0, 0.001, 0.1), 200)
        if hasattr(k9, "_make_scratch"):  # a tree that keeps its scratch
            pl = k9.plan(M, k9.fits_on(dev))
            made = host_us(lambda: k9._make_scratch(M, dev, pl), 101,
                           sync=True)
            print(f"[5] K9 resample {M}: making its scratch (which the kept "
                  f"scratch saves), host {made:.1f} us a call ({ident})")
        if M == PARTICLES:
            both(f"K3 batch M = {M}", lambda a=c.sa: k3.score_batch(*a), 20)
    pf_rows(dev, both, m, pcfg, scan, center)
    if hasattr(k3, "ParticlePlan"):
        particle_launch_path(dev, m, pcfg, scan, center)

    cfg6, bag3 = config6(), office_bag()
    cm = cfg6.coarse_scan_matcher
    rmax = 12.0
    rows = coarse_rows(cfg6, bag3, dev)
    g, tab = k1.build_windows(*rows[:4], rmax, cm.ndt_resolution,
                              cm.grid_cells_x, cm.grid_cells_y)
    dths, dls = matcher._search_offsets(cm, dev)
    both(f"K6 {COARSE_ROWS} coarse rows",
         lambda: k6.match_rows(cm, g, tab, *rows[4:], dths, dls), 10)
    a0, n = pmatcher.angle_block(dths.shape[0], 2, 0)
    both(f"K12 K6 partials, {COARSE_ROWS} rows, {n} of {dths.shape[0]} "
         "angles",
         lambda: k6.partial_rows(cm, g, tab, *rows[4:], dths, dls, a0, n),
         10)
    mrows = office_rows(cfg6, bag3, dev, 1, region=tuple(range(7)),
                        shift=(0.4, -0.3, 2.5))
    span = float(np.ptp(mrows[0][0, :, :2].cpu().numpy(), axis=0).max())
    mm = merge._coarse_config(rmax, span)
    md, ml = matcher._search_offsets(mm, dev)
    mg, mtab = k1.build_windows(*mrows[:4], rmax, mm.ndt_resolution,
                                mm.grid_cells_x, mm.grid_cells_y)
    both(f"K6 merge shape ({md.numel()}x{ml.numel()}x{ml.numel()}, R = 1)",
         lambda: k6.match_rows(mm, mg, mtab, *mrows[4:], md, ml), 10)

    _, cfg4 = config4_configs()
    mc4 = m4.config
    (gs, tabs), h = stripe_of(m4, kf, 2, 0)
    loc_bag = record_synthetic("box", MAP4_SCANS, n_beams=360, seed=7,
                               odom_trans_noise=0.01)
    lq, lqm, ln, lcenter = map4_scan(loc_bag, 20, cfg4, dev)
    start = lcenter + torch.tensor([0.02, -0.01, 0.01], device=dev)
    d4, l4 = k2.search_offsets(mc4, dev)
    both(f"KB3 stripe field ({d4.numel()}x{l4.numel()}x{l4.numel()})",
         lambda: k6.stripe_field(mc4, gs, tabs, 0, h, lq, lqm, ln, start, d4,
                                 l4), 20)

    # K3 at M = 1: config 3's local window of the office bag's first scans,
    # matched by the next; and config 8's (G = 4).
    a3, (prev, delta) = config3_window(bag3, dev)
    both("K3 M = 1 (config 3's window)", lambda: k3.score_at_pose(*a3), 20)
    # The pipelined step's compose and score: one launch in a tree with
    # K3's composed entry, K13's compose then K3 in one without.
    if hasattr(k3, "score_composed"):
        both("K3 composed, M = 1 (config 3's window)",
             lambda: k3.score_composed(*a3[:7], prev, delta), 20)
    else:
        from ndt_2d_tpu_torch.kernels import pose_chain as k13
        both("K3 composed, M = 1 (config 3's window)",
             lambda: k3.score_at_pose(*a3[:7], k13.compose(prev, delta)), 20)
    k3_launch_path(dev, a3, ident)
    mc8 = config8(cfg).local_scan_matcher
    g8, _ = k1.build_window(**win, range_max=15.0,
                            cell_size=mc8.ndt_resolution,
                            width=mc8.grid_cells_x, height=mc8.grid_cells_y,
                            grids=4)
    a8 = (g8, mc8.grid_cells_x, mc8.grid_cells_y, mc8.laser_max_beams,
          query["points"], query["point_mask"], query["num_points"],
          query["pose"])
    both("K3 M = 1, G = 4 (config 8's window)",
         lambda: k3.score_at_pose(*a8), 20)
    window_append_times(dev, both, win, query)


def pf_rows(dev, both, m, pcfg, scan, center) -> None:
    """The filter's per-scan launches through ``both`` at config 4's 5000
    and config 7's 20,000 particles (``pf_case``'s inputs): K9's motion,
    the SoA K3 batch at the moved particles, the two back to back (the
    parent design's step), and, in a tree with K3's particle launch, that
    launch with the motion folded in and with it off."""
    from ndt_2d_tpu_torch.kernels import particle_filter as k9
    from ndt_2d_tpu_torch.kernels import score_points as k3
    W, H = m.config.grid_cells_x, m.config.grid_cells_y
    B = m.config.laser_max_beams
    q, qm, n = scan
    fused = hasattr(k3, "motion_score")
    for M in (PARTICLES, GLOBAL_PARTICLES):
        c = pf_case(m, pcfg, scan, center, M, dev)
        ma = (c.poses, c.draws.motion, c.scal)
        ba = (m.grid, W, H, B, q, qm, n)
        both(f"K9 motion {M}", lambda a=ma: k9.motion(*a), 100)
        both(f"K3 batch (SoA) {M}", lambda a=ba, p=c.pm: k3.score_batch(*a, p),
             100)
        both(f"K9 motion, then K3 batch (SoA) {M}",
             lambda a=ba, b=ma: k3.score_batch(*a, k9.motion(*b)), 100)
        if fused:
            ra = (m.grid, m.packed_table, W, H, B, q, qm, n)
            both(f"K3 particle launch, motion folded in {M}",
                 lambda a=ra, b=ma: k3.motion_score(*a, *b), 100)
            both(f"K3 particle launch, motion off {M}",
                 lambda a=ra, p=c.pm: k3.score_records(*a, p), 100)


def particle_launch_path(dev, m, pcfg, scan, center) -> dict:
    """The host side of the planned particle launch at config 4's 5000
    particles, piece by piece (``host_us``, back to back): the whole
    call, the plan's lookup, the step tensors' check, the two outputs'
    allocation, the writes of the step's pointers and scalars into the
    launch block, the stream read (the raw read the plan makes, and
    ``stream_ptr``'s), the ctypes call; and ``motion_scalars``."""
    import torch

    from ndt_2d_tpu_torch.filter import motion_model
    from ndt_2d_tpu_torch.kernels import _build
    from ndt_2d_tpu_torch.kernels import score_points as k3
    W, H = m.config.grid_cells_x, m.config.grid_cells_y
    B = m.config.laser_max_beams
    q, qm, n = scan
    c = pf_case(m, pcfg, scan, center, PARTICLES, dev)
    tab, noise = m.packed_table, c.draws.motion
    fa = (m.grid, tab, W, H, B, q, qm, n, c.poses, noise, c.scal)
    k3.motion_score(*fa)
    plan = k3.particle_plan(m.grid, tab, W, H, B, q, PARTICLES, True)
    moved, out = c.poses.new_empty(PARTICLES, 3), c.poses.new_empty(PARTICLES)
    step = (q, qm, c.poses, noise)
    L = plan.launch

    def block_writes():
        L.out, L.poses = out.data_ptr(), c.poses.data_ptr()
        L.points, L.pmask = q.data_ptr(), qm.data_ptr()
        L.num_points = n
        L.moved, L.noise = moved.data_ptr(), noise.data_ptr()
        L.rot1, L.trans, L.rot2, L.s_rot1, L.s_trans, L.s_rot2 = c.scal
    pieces = {
        "motion_score": lambda: k3.motion_score(*fa),
        "particle_plan": lambda: k3.particle_plan(m.grid, tab, W, H, B, q,
                                                  PARTICLES, True),
        "require_all (4 tensors)": lambda: _build.require_all(
            dev, step, plan.expect),
        "new_empty x 2": lambda: (c.poses.new_empty(PARTICLES),
                                  c.poses.new_empty(PARTICLES, 3)),
        "launch block writes": block_writes,
        "stream read (raw)": plan._stream,
        "stream_ptr": lambda: _build.stream_ptr(dev),
        "ctypes call": lambda: plan._fn(plan.address, plan._stream()),
        "motion_scalars": lambda: motion_model.motion_scalars(
            0.05, 0.002, 0.03, 0.05, 0.05, 0.05, 0.05)}
    us = {k: host_us(f, 2000) for k, f in pieces.items()}
    torch.cuda.synchronize()
    print("[5] K3 particle launch (5000), launch path, host us a call: "
          + ", ".join(f"{k} {v:.3f}" for k, v in us.items()))
    return us


class StepParts:
    """Host time of a filter step's parts (``time.perf_counter_ns`` around
    each): the draws, the scan uploads, ``motion_scalars``, the particle
    launch (or, in a tree without it, K9's motion and the K3 batch), the
    resample and the read of the statistics (``HostCopy.wait``, which
    waits for the step on the device), summed over the steps after the
    first two; ``step`` is ``ParticleFilter.step`` whole."""

    def __init__(self):
        from ndt_2d_tpu_torch import device
        from ndt_2d_tpu_torch.filter import motion_model
        from ndt_2d_tpu_torch.filter import particle_filter as pf_mod
        from ndt_2d_tpu_torch.kernels import particle_filter as k9
        from ndt_2d_tpu_torch.kernels import score_points as k3
        self.targets = [
            ("step", pf_mod.ParticleFilter, "step"),
            ("draws", pf_mod, "draw_step"), ("uploads", pf_mod, "upload"),
            ("motion_scalars", motion_model, "motion_scalars"),
            ("particle launch", k3, "motion_score"),
            ("K9 motion", k9, "motion"), ("K3 batch", k3, "score_batch"),
            ("resample", k9, "resample"), ("read", device.HostCopy, "wait")]
        self.ns = {name: 0 for name, _, _ in self.targets}
        self.calls = dict(self.ns)
        self.steps = 0
        self.saved = []

    def __enter__(self):
        for name, owner, attr in self.targets:
            real = getattr(owner, attr, None)
            if real is None:
                continue
            self.saved.append((owner, attr, real))

            def timed_part(*a, _real=real, _name=name, **kw):
                if _name == "step":
                    self.steps += 1
                t0 = time.perf_counter_ns()
                try:
                    return _real(*a, **kw)
                finally:
                    if self.steps > 2:
                        self.ns[_name] += time.perf_counter_ns() - t0
                        self.calls[_name] += 1
            setattr(owner, attr, timed_part)
        return self

    def __exit__(self, *exc):
        for owner, attr, real in self.saved:
            setattr(owner, attr, real)

    def per_step_us(self) -> dict:
        n = max(self.calls["step"], 1)
        out = {k: v / n / 1e3 for k, v in self.ns.items() if self.calls[k]}
        out["calls a step"] = {k: v / n for k, v in self.calls.items() if v}
        return out


def pf_times(dev, ident: str, runs: int = 3) -> dict:
    """Config 4's filter as ``--pf-times`` runs it (also in an older
    checkout): the config-4 map, the per-scan launches' rows (``pf_rows``,
    ``cuda_ms``, ``graph_ms``, host us), the planned launch's host side,
    then ``runs`` sessions of config 4 (``phase_config4``'s bag, seed and
    start), each with its ``pf_step`` section mean, ms/scan median, errors,
    final particles sha256, launches and the host parts of a step
    (``StepParts``)."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.io.bag import record_synthetic
    from ndt_2d_tpu_torch.kernels import score_points as k3
    from ndt_2d_tpu_torch.utils import metrics
    rows = {}

    def both(name, fn, reps):
        rows[name] = {"cuda_ms": cuda_ms(fn, reps),
                      "graph_ms": graph_ms(fn, reps),
                      "host_us": host_us(fn, 101, sync=True)}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        map4 = os.path.join(tmp, "box_map.npz")
        bag4 = record_synthetic("box", 150, n_beams=360, seed=2)
        map_and_save(config4_configs()[0], bag4, map4, dev)
        m, pcfg, scan, center = pf_setup(map4, bag4, dev)
        pf_rows(dev, both, m, pcfg, scan, center)
        for name, t in rows.items():
            print(f"[5] {name}: {t['cuda_ms']:.4f} ms, in a CUDA graph "
                  f"{t['graph_ms']:.5f} ms, host {t['host_us']:.1f} us a "
                  f"call ({ident})")
        out["rows"] = rows
        if hasattr(k3, "ParticlePlan"):
            out["launch_path"] = particle_launch_path(dev, m, pcfg, scan,
                                                      center)
        _, cfg = config4_configs()
        loc_bag = record_synthetic("box", 150, n_beams=360, seed=7,
                                   odom_trans_noise=0.01)
        rel = metrics.relative_to_first(loc_bag.truth)
        scans = [(t, msg, odom) for t, (msg, odom) in enumerate(loc_bag)
                 if t > 0]
        out["sessions"] = []
        for _ in range(runs):
            reset_counts()
            loc = localizer(cfg, map4, dev, 3)
            loc.set_initial_pose(rel[0], np.diag([0.04, 0.04, 0.01]),
                                 loc_bag.truth[0])
            with StepParts() as parts:
                errs, _, times = track(loc, scans, rel)
            torch.cuda.synchronize()
            timer = loc.stats.timer
            r = dict(pf_step_mean_ms=timer.total["pf_step"] * 1e3
                     / timer.count["pf_step"],
                     ms_scan_median=float(np.median(times[2:]) * 1e3),
                     mean_err=float(np.mean(errs)),
                     final_err=float(errs[-1]), steps=len(errs),
                     digest=poses_digest(loc.filter.particles.cpu().numpy()),
                     launches={k: v for k, v in read_counts().items() if v},
                     parts_us=parts.per_step_us())
            print(f"[4d] config 4 session: pf_step {r['pf_step_mean_ms']} ms "
                  f"mean, {r['ms_scan_median']} ms/scan median, error mean "
                  f"{r['mean_err']:.4f} final {r['final_err']:.4f} m, "
                  f"particles sha256 {r['digest']}; host us a step "
                  f"{r['parts_us']}; launches {r['launches']} ({ident})")
            out["sessions"].append(r)
    return out


def config3_window(bag3, dev):
    """Config 3's local window of the office bag's first scans and the
    next scan at its odometry pose, as K3's single-pose arguments (grid,
    W, H, beams, points, mask, count, pose), and the (previous pose,
    odometry delta) that compose to that pose's neighbourhood."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.mapping import laser
    cfg3 = office_config()
    mc3 = cfg3.local_scan_matcher
    D = cfg3.rolling_depth
    pts = [laser.project_scan(bag3[t][0], bag3.range_max, np.zeros(3),
                              False, None, cfg3.max_points_per_scan)
           for t in range(D + 1)]
    f32 = torch.float32
    g3, _ = k1.build_window(
        poses=torch.tensor(bag3.odom[:D], dtype=f32, device=dev),
        points=torch.tensor(np.stack([p[0] for p in pts[:D]]), device=dev),
        point_mask=torch.tensor(np.stack([p[1] for p in pts[:D]]),
                                device=dev),
        window_mask=torch.ones(D, dtype=torch.bool, device=dev),
        range_max=12.0, cell_size=mc3.ndt_resolution,
        width=mc3.grid_cells_x, height=mc3.grid_cells_y)
    a3 = (g3, mc3.grid_cells_x, mc3.grid_cells_y, mc3.laser_max_beams,
          torch.tensor(pts[D][0], device=dev),
          torch.tensor(pts[D][1], device=dev), int(pts[D][1].sum()),
          torch.tensor(bag3.odom[D], dtype=f32, device=dev))
    delta = odom_deltas(bag3.odom[D - 1:D + 1])[0]
    return a3, (torch.tensor(bag3.odom[D - 1], dtype=f32, device=dev),
                torch.tensor(delta, device=dev))


def eager_window_append(window, pose, correction, points, point_mask):
    """The eager torch operations that appended to the window before K13
    did (four shifts through a copy, two slot copies, a fill and the
    corrected pose into its slot): the window append's library arm."""
    for field in (window.poses, window.points, window.point_mask,
                  window.mask):
        field[:-1] = field[1:].clone()
    window.points[-1] = points
    window.point_mask[-1] = point_mask
    window.mask[-1:].fill_(True)
    new_pose = pose + correction
    window.poses[-1] = new_pose
    return new_pose


def window_append_times(dev, both, win, query):
    """K13's window append at config 2's window through ``both``: this
    tree's one launch (a tree without it: its eager shift and K13's
    apply), and the eager torch operations alone (``eager_window_append``,
    the same in every tree)."""
    import torch

    from ndt_2d_tpu_torch.kernels import pose_chain as k13
    from ndt_2d_tpu_torch.matching import matcher
    D, P = win["points"].shape[:2]
    w = matcher.make_window(D, P, dev)
    pose, corr = query["pose"], torch.full((3,), 0.01, device=dev)
    scan = (query["points"], query["point_mask"])
    if hasattr(k13, "window_append"):
        both("K13 window append (config 2's window)",
             lambda: k13.window_append(pose, corr, w, *scan), 50)
    else:
        def shift_apply():
            matcher.window_shift(w, *scan)
            return k13.apply(pose, corr, w.poses)
        both("K13 window append (config 2's window)", shift_apply, 50)
    both("K13 window append, eager torch (config 2's window)",
         lambda: eager_window_append(w, pose, corr, *scan), 50)


def k3_launch_path(dev, a3, ident) -> dict:
    """The host side of one K3 single-pose call at config 3's window,
    piece by piece (``host_us``): this tree's (a plan looked up, one
    checking pass, one ``new_empty``, the pointers, the stream, the
    call), or
    a tree's without plans (seven ``require`` checks, the allocation, the
    pose's reshape, the 19-argument call, the ``out[0]`` view)."""
    import ctypes

    import torch

    from ndt_2d_tpu_torch.kernels import _build
    from ndt_2d_tpu_torch.kernels import score_points as k3
    g, W, H, mb, pts, msk, n, pose = a3
    grid_t = (g.origin, g.mean, g.information, g.count)
    f32 = torch.float32
    pieces = {"score_at_pose": lambda: k3.score_at_pose(*a3),
              "stream_ptr": lambda: _build.stream_ptr(dev),
              "check": lambda: _build.check(0, "score_points")}
    if hasattr(k3, "_plan"):
        plan = k3._plan(g, W, 0, H, mb, pts, False)
        tensors = (pts, msk, *grid_t, pose)
        out = torch.empty((), dtype=f32, device=dev)
        fn = _build.function("ndt2d_score_points", k3._ARGS)
        ptr = [t.data_ptr() for t in tensors]
        stream = _build.stream_ptr(dev)
        pieces.update({
            "_plan": lambda: k3._plan(g, W, 0, H, mb, pts, False),
            "require_all": lambda: _build.require_all(dev, tensors,
                                                      plan.pose),
            "new_empty": lambda: pts.new_empty(()),
            "data_ptr x 8": lambda: [t.data_ptr() for t in (*tensors, out)],
            "ctypes call": lambda: fn(plan.address, ptr[0], ptr[1], n,
                                      ptr[6], 1, *ptr[2:6],
                                      out.data_ptr(), None, None, None,
                                      stream)})
    else:
        C = W * H
        poses = pose.reshape(1, 3)
        out = torch.empty(1, dtype=f32, device=dev)
        fn = _build.function("ndt2d_score_points", k3._ARGS)
        ptr = [t.data_ptr() for t in (pts, msk, poses, *grid_t)]
        stream = _build.stream_ptr(dev)
        expect = ((pts, f32, (pts.shape[0], 2)), (msk, torch.bool,
                                                   (pts.shape[0],)),
                  (poses, f32, (1, 3)), (g.origin, f32, (2,)),
                  (g.mean, f32, (C, 2)), (g.information, f32, (C, 3)),
                  (g.count, torch.int32, (C,)))
        pieces.update({
            "require x 7": lambda: [_build.require(t, "t", d, sh, dev)
                                    for t, d, sh in expect],
            "torch.empty": lambda: torch.empty(1, dtype=f32, device=dev),
            "reshape": lambda: pose.reshape(1, 3),
            "data_ptr x 8": lambda: [t.data_ptr() for t in (
                pts, msk, poses, *grid_t, out)],
            "ctypes call": lambda: fn(
                ptr[0], ptr[1], pts.shape[0], n, mb, ptr[2], 1, 1, ptr[3],
                float(g.cell_size), W, 0, H, ptr[4], ptr[5],
                ptr[6], 0, out.data_ptr(), stream),
            "out[0]": lambda: out[0]})
    us = {k: host_us(f, 2000) for k, f in pieces.items()}
    torch.cuda.synchronize()
    print("[5] K3 M = 1 launch path, host us a call (config 3's window): "
          + ", ".join(f"{k} {v:.3f}" for k, v in us.items())
          + f" ({ident})")
    return us


def session_times(dev, ident, runs: int = 3) -> dict:
    """Unprofiled ms/scan, ``runs`` runs of each session in turn: config 3
    synchronous (the 2000-scan office loop; median over accepted scans 4
    on), config 2 synchronous and at max_inflight 8 (the 200-scan
    corridor; scans 4 on).  Calls only ``run_session``, so
    ``--session-times`` in an older checkout times that checkout."""
    import numpy as np
    bag2, cfg2, _, _, _ = inputs(dev)
    cfg3, bag3 = office_config(), office_bag()
    sessions = {"config 3 synchronous": (cfg3, bag3, True),
                "config 2 synchronous": (cfg2, bag2, False),
                "config 2 pipelined": (pipelined(cfg2), bag2, False)}
    out = {k: [] for k in sessions}
    for _ in range(runs):
        for name, (cfg, bag, accepted_only) in sessions.items():
            _, _, dt, _, acc, _ = run_session(cfg, bag, dev)
            dt = dt[acc] if accepted_only else dt
            out[name].append(float(np.median(dt[4:]) * 1e3))
    for name, ms in out.items():
        print(f"[6] {name}: ms/scan medians of {runs} runs "
              f"{[round(m, 4) for m in ms]}, median "
              f"{float(np.median(ms)):.4f}, spread "
              f"{max(ms) - min(ms):.4f} ({ident})")
    return out


def config8(cfg):
    """BASELINE config 8, "rolling_mapping_corridor_high_accuracy"
    (benchmarks/run_benchmarks.py:139-162): config 2 with overlapping grids
    and 10 Newton iterations on both matchers, no loop closure."""
    import dataclasses
    m = dataclasses.replace(cfg.local_scan_matcher, overlapping_grids=True,
                            refine_iterations=10)
    return dataclasses.replace(cfg, local_scan_matcher=m,
                               global_scan_matcher=m)


def phase_k8(cfg, win, query, dev):
    """K1, K2 (with its scores) and K3 (both entries) at G = 4 bitwise
    against their twins at config-8 shapes, the G = 4 build's first grid
    against the G = 1 build bitwise, and K7 on one config-8 local match
    (G = 4, 10 iterations) bitwise against its twin; times."""
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.kernels import newton as k7
    from ndt_2d_tpu_torch.kernels import score_points as k3
    from ndt_2d_tpu_torch.matching import matcher, newton
    mc = config8(cfg).local_scan_matcher
    W, H = mc.grid_cells_x, mc.grid_cells_y
    build = dict(range_max=15.0, cell_size=mc.ndt_resolution, width=W,
                 height=H)

    def k1_run():
        return k1.build_window(**win, **build, grids=4)

    def k1_twin():
        return k1.build_window_twin(**win, **build, grids=4)
    (g, tab), (gt, tabt) = k1_run(), k1_twin()
    g1, tab1 = k1.build_window(**win, **build)
    torch.cuda.synchronize()
    fields = ("origin", "mean", "information", "covariance", "count")
    check_build(g, tab, gt, tabt, "K1 G = 4")
    require(all(torch.equal(getattr(g, f)[0], getattr(g1, f))
                for f in fields) and torch.equal(tab[0], tab1),
            "K1 G = 4: grid 0 differs from the G = 1 build")
    check_build(g, tab, *k1_run(), "K1 G = 4 (reproducibility)")

    dths, dls = matcher._search_offsets(mc, dev)
    args = (mc, g, tab, query["points"], query["point_mask"],
            query["num_points"], query["pose"], dths, dls)
    out2, sc = k2.match(*args, with_scores=True)
    rest, sct = k2.match_twin(*args)
    torch.cuda.synchronize()
    check_match(out2, sc, one_row(rest), sct, "K2 G = 4")

    a3 = (g, W, H, mc.laser_max_beams, query["points"], query["point_mask"],
          query["num_points"])
    gen = torch.Generator(device=dev).manual_seed(5)
    poses = (query["pose"] + torch.randn(64, 3, generator=gen, device=dev)
             * 0.05).contiguous()
    u, ut = k3.score_at_pose(*a3, query["pose"]), \
        k3.score_at_pose_twin(*a3, query["pose"])
    ub, ubt = k3.score_batch(*a3, poses), k3.score_batch_twin(*a3, poses)
    torch.cuda.synchronize()
    require(torch.equal(u, ut) and torch.equal(ub, ubt),
            "K3 G = 4 differs from its twin")
    require(torch.equal(k3.score_at_pose(*a3, poses[7]), ub[7]),
            "K3 G = 4: a pose differs between the two entries")

    k7_args = (mc, g, tab, query["points"], query["point_mask"],
               query["num_points"], query["pose"])

    def k7_run():
        return k7.refine(*k7_args, out2.clone(), mc.refine_iterations)

    nums = torch.tensor([query["num_points"]], dtype=torch.int32,
                        device=dev)

    def k7_twin():
        return k7.refine_rows_twin(
            mc, newton.with_row_grid_axes(g, False), query["points"][None],
            query["point_mask"][None], nums, query["pose"][None],
            out2.clone(), mc.refine_iterations)
    o7, o7t = k7_run(), k7_twin()
    torch.cuda.synchronize()
    require(torch.equal(o7, o7t), "K7 (G = 4) differs from its twin")
    require(torch.equal(o7, k7_run()), "K7 (G = 4) not reproducible")
    print(f"[3] K8 (G = 4) at config-8 shapes: K1 {int((g.count > 0).sum())} "
          f"occupied cells over 4 grids, bitwise equal to its twin, grid 0 "
          f"bitwise the G = 1 build; K2 scores and output row bitwise equal "
          f"to the twin, correction "
          f"{[round(float(x), 4) for x in out2[0, 1:4]]}; K3 both entries "
          f"bitwise equal to the twin; K7 ({mc.refine_iterations} "
          f"iterations) bitwise equal to its twin: score "
          f"{float(out2[0, 0]):.5f} -> {float(o7[0, 0]):.5f}, correction "
          f"{[round(float(x), 5) for x in o7[0, 1:4]]}")
    S, P = win["points"].shape[0], win["points"].shape[1]
    scan = args[3:6]
    return {"ndt_build_g4": timed(
                0.0, cuda_ms(k1_run, 20), cuda_ms(k1_twin, 3),
                nbytes(*win.values(), *[getattr(g, f) for f in fields], tab),
                ops_ndt_build(1, 4, S * P, W * H)),
            "candidate_scores_g4": timed(
                0.0, cuda_ms(lambda: k2.match(*args), 20),
                cuda_ms(lambda: k2.match_twin(*args), 3),
                *cost_candidate_scores(mc, g.origin, g.cell_size, *args[3:])),
            "score_points_g4": timed(
                0.0, cuda_ms(lambda: k3.score_at_pose(*a3, query["pose"]),
                             20),
                cuda_ms(lambda: k3.score_at_pose_twin(*a3, query["pose"]), 5),
                *cost_score_points(mc, g, *scan, query["pose"][None])),
            "newton": timed(
                0.0, cuda_ms(lambda o=out2.clone(): k7.refine(
                    *k7_args, o, mc.refine_iterations), 20),
                cuda_ms(k7_twin, 3),
                *cost_newton(mc, g.origin, g.cell_size, g.count, *scan,
                             query["pose"] + out2[0, 1:4],
                             query["pose"] + o7[0, 1:4],
                             mc.refine_iterations))}


class MatchRecorder:
    """Records the inputs and outputs of the first rolling matches of a
    session, for the twin replay."""

    def __init__(self, keep: int):
        from ndt_2d_tpu_torch.matching import matcher
        self.mod, self.real, self.keep = matcher, \
            matcher.match_scan_rolling, keep
        self.calls = []

    def match(self, config, window, range_max, *args, **kw):
        out = self.real(config, window, range_max, *args, **kw)
        if len(self.calls) < self.keep:
            win = tuple(getattr(window, f).clone()
                        for f in ("poses", "points", "point_mask", "mask"))
            self.calls.append((config, win, range_max,
                               [a.clone() if hasattr(a, "clone") else a
                                for a in args], [o.clone() for o in out]))
        return out

    def __enter__(self):
        self.mod.match_scan_rolling = self.match
        return self

    def __exit__(self, *exc):
        self.mod.match_scan_rolling = self.real


def phase_config8(cfg2, bag, dev, config2):
    """BASELINE config 8 on the card: the 200-scan corridor with four
    overlapping grids and 10 Newton iterations on both matchers; the first
    three matches replayed through the twins."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.kernels import newton as k7
    from ndt_2d_tpu_torch.kernels import score_points as k3
    from ndt_2d_tpu_torch.matching import matcher, newton
    cfg = config8(cfg2)
    with MatchRecorder(3) as rec:
        reset_counts()
        stats, grid, dt, _, _, _ = run_session(cfg, bag, dev)
        launches = read_counts()
    acc = stats["scans_accepted"]
    require(acc == len(bag), f"config 8 accepted {acc} of {len(bag)} scans")
    for k in ("ndt_build", "candidate_scores", "score_points", "newton"):
        require(launches[k] == acc - 1, f"config 8: {k} launched "
                f"{launches[k]} times, expected {acc - 1}")
    num = session_numbers(stats, bag, dt)
    require(np.isfinite(num["ate"]) and num["ate"] < num["odom"],
            f"config 8 ATE {num['ate']} not below odometry's {num['odom']}")
    require(int((grid.data == 100).sum()) > 0, "no occupied cells")
    print(f"[4f] config 8: {acc}/{len(bag)} scans accepted, "
          f"{num['ms']:.3f} ms/scan median (scans 4+), ATE {num['ate']:.4f} "
          f"m, aligned {num['aligned']:.4f} m (odometry {num['odom']:.4f}); "
          f"config 2 in this run: {config2['ms']:.3f} ms/scan, ATE "
          f"{config2['ate']:.4f} m, aligned {config2['aligned']:.4f} m; "
          f"launches {launches}")

    # Replay: K1's twin on the recorded window, K3's and K2's twins on the
    # kernel's grid, K7's twin from K2's kernel row; all bitwise.
    require(len(rec.calls) == 3, f"recorded {len(rec.calls)} matches")
    for mc, (poses, pts, pmask, wmask), rmax, args, out in rec.calls:
        qp, qm, n, pose = args
        W, H = mc.grid_cells_x, mc.grid_cells_y
        build = (rmax, mc.ndt_resolution, W, H, 4)
        g, tab = k1.build_window(poses, pts, pmask, wmask, *build)
        gt, tabt = k1.build_window_twin(poses, pts, pmask, wmask, *build)
        unc = k3.score_at_pose_twin(g, W, H, mc.laser_max_beams, qp, qm, n,
                                    pose)
        dths, dls = matcher._search_offsets(mc, dev)
        o2, sc = k2.match(mc, g, tab, qp, qm, n, pose, dths, dls,
                          with_scores=True)
        rest, sct = k2.match_twin(mc, g, tab, qp, qm, n, pose, dths, dls)
        o7 = k7.refine_rows_twin(
            mc, newton.with_row_grid_axes(g, False), qp[None], qm[None],
            torch.tensor([n], dtype=torch.int32, device=dev), pose[None],
            o2, mc.refine_iterations)
        torch.cuda.synchronize()
        check_build(g, tab, gt, tabt, "config-8 replay: K1")
        require(torch.equal(unc, out[0]), "config-8 replay: K3's twin")
        check_match(o2, sc, one_row(rest), sct, "config-8 replay: K2")
        require(torch.equal(o7[0, 0], out[1]) and torch.equal(o7[0, 1:4],
                                                               out[2]),
                "config-8 replay: K7's twin differs from the session")
    print("[4f] replay of the first 3 config-8 matches through the twins: "
          "K1, K2, K3 and K7 bitwise")
    return launches


def district_graph():
    """The config-5 district graph as benchmarks/run_benchmarks.py:522-554
    builds it: a serpentine survey with odometry and 10% of the column
    revisits as loop closures, noisy initial poses; exact truth."""
    import numpy as np
    n = DISTRICT_NODES
    rng = np.random.default_rng(0)
    side = int(np.sqrt(n))
    xs = np.arange(n) % side
    ys = np.arange(n) // side
    xs = np.where(ys % 2 == 0, xs, side - 1 - xs)
    truth = np.stack([xs.astype(np.float64) * 2.0, ys * 2.0,
                      rng.uniform(-0.3, 0.3, n)], -1)
    begin = np.arange(n - 1, dtype=np.int32)
    end = begin + 1
    lc_end = np.arange(n - side, dtype=np.int32)
    lc_begin = lc_end + side
    keep = rng.random(len(lc_begin)) < 0.1
    begin = np.concatenate([begin, lc_begin[keep]])
    end = np.concatenate([end, lc_end[keep]])
    d = truth[end, :2] - truth[begin, :2]
    c, s = np.cos(truth[begin, 2]), np.sin(truth[begin, 2])
    transform = np.stack([c * d[:, 0] + s * d[:, 1],
                          -s * d[:, 0] + c * d[:, 1],
                          truth[end, 2] - truth[begin, 2]], -1)
    info = np.tile(np.eye(3, dtype=np.float32) * 100.0, (len(begin), 1, 1))
    noisy = truth + rng.normal(0, [0.3, 0.3, 0.02], (n, 3))
    noisy[0] = truth[0]
    robust = np.arange(len(begin)) >= n - 1
    return truth, dict(poses=noisy, begin=begin, end=end,
                       transform=transform, information=info,
                       constraint_mask=np.ones(len(begin), bool),
                       node_mask=np.ones(n, bool), robust_mask=robust)


def phase_k4(district, dev, ident):
    """K4's entries against their twins on the district graph."""
    import torch

    from ndt_2d_tpu_torch import convert
    from ndt_2d_tpu_torch.graph import solver
    from ndt_2d_tpu_torch.kernels import normal_blocks as k4
    t = convert.solve_inputs_to_port(dev, **district)
    n = t["poses"].shape[0]
    inc = k4.incidence(t["begin"], t["end"], t["constraint_mask"], n)
    args = (t["poses"], t["begin"], t["end"], t["transform"],
            t["information"], t["constraint_mask"], t["robust_mask"])
    for loss in ("none", "huber", "geman_mcclure"):
        a = k4.normal_blocks(*args, loss, 1.0, inc)
        b = k4.normal_blocks_twin(*args, loss, 1.0, inc)
        torch.cuda.synchronize()
        names = ("Baa", "Bab", "Bbb", "ga", "gb", "g", "D")
        for name, x, y in zip(names, a, b):
            require(torch.equal(x, y),
                    f"K4 normal_blocks ({loss}): {name} differs from twin")
        again = k4.normal_blocks(*args, loss, 1.0, inc)
        require(all(torch.equal(x, y) for x, y in zip(a, again)),
                f"K4 normal_blocks ({loss}) not bitwise reproducible")
    baa, bab, bbb, _, _, _, d = a
    gen = torch.Generator(device=dev).manual_seed(0)
    v = torch.randn(n, 3, generator=gen, device=dev)
    fm = (torch.arange(n, device=dev) != 0).float()
    lam = torch.tensor(1e-3, device=dev)
    system = check_pcg_system(t, args, inc, lam, fm, ident)
    mv = (t["begin"], t["end"], baa, bab, bbb, d, lam, fm, v, inc)
    y, yt, y2 = k4.pcg_matvec(*mv), k4.pcg_matvec_twin(*mv), \
        k4.pcg_matvec(*mv)
    torch.cuda.synchronize()
    require(torch.equal(y, yt), "K4 pcg_matvec differs from twin")
    require(torch.equal(y, y2), "K4 pcg_matvec not bitwise reproducible")
    # The whole PCG loop of one LM step (config 5's 150 CG steps) on these
    # blocks, kernel against twin, and its fixed-order dot alone.
    pinv, rhs = solver._preconditioner(a[5], d, lam, fm.bool())
    ps = (t["begin"], t["end"], baa, bab, bbb, d, lam, fm, pinv, rhs, 150,
          1e-6, inc)
    (x, it), (xt, itt), (x2, it2) = (k4.pcg_solve(*ps),
                                     k4.pcg_solve_twin(*ps),
                                     k4.pcg_solve(*ps))
    dot, dott = k4.fixed_dots((v, y)), k4.fixed_dots_twin((v, y))
    dots2 = k4.fixed_dots((v, y), (y, y))
    torch.cuda.synchronize()
    require(torch.equal(x, xt) and int(it) == int(itt),
            f"K4 pcg_solve differs from twin ({int(it)} vs {int(itt)} steps)")
    require(torch.equal(x, x2) and int(it) == int(it2),
            "K4 pcg_solve not bitwise reproducible")
    require(torch.equal(dot[0], dott[0])
            and torch.equal(dot[0], k4.fixed_dots((v, y))[0]),
            "K4 fixed_dots differs from twin or is not reproducible")
    require(all(torch.equal(a2, b2) for a2, b2 in zip(
        dots2, k4.fixed_dots_twin((v, y), (y, y)))),
            "K4 fixed_dots of two pairs differs from twin")
    steps = int(it)

    def host_loop(mv, dots):
        return k4.pcg_loop(mv, dots, pinv, fm, rhs, 150, 1e-6)

    def k4_mv(u):
        return k4.pcg_matvec(t["begin"], t["end"], baa, bab, bbb, d, lam, fm,
                             u, inc)

    def csr_mv(u):
        return (csr @ u.reshape(-1, 1)).reshape(n, 3)

    def torch_dots(*pairs):
        return tuple(torch.sum(p * q) for p, q in pairs)
    xh, it_h = host_loop(k4_mv, k4.fixed_dots)
    require(torch.equal(xh, x) and it_h == steps,
            "the host loop over pcg_matvec and fixed_dots differs from "
            "pcg_solve")
    plan, _ = check_cg_plan(ps, x, steps)
    print(f"[3] K4 on the district ({n} nodes, {t['begin'].numel()} "
          "constraints): normal_blocks (none, huber, geman_mcclure), "
          "pcg_matvec, fixed_dots (one and two pairs) and pcg_solve (one "
          f"LM step, {steps} CG steps: x and the step count) bitwise equal "
          "to their twins and reproducible; the host loop over pcg_matvec "
          f"and fixed_dots bitwise pcg_solve; {plan}")
    nb = args + ("none", 1.0, inc)
    C = t["begin"].numel()
    # The library yardstick of the matvec: the same product as one sparse
    # CSR matrix (assembled here, outside the timing) times v.
    csr = block_csr(t["begin"], t["end"], baa, bab, bbb, d, lam, fm, n)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lib = (csr @ v.reshape(-1, 1)).reshape(n, 3)
    require(torch.allclose(lib, y, rtol=1e-4, atol=1e-4 * float(
        y.abs().max())), "the sparse product differs from K4's matvec")
    # A CG step of pcg_solve in its three arms: the kernel (one launch a
    # solve), the host loop over K4's matvec and dots, and the host loop
    # on one sparse CSR product (the library arm).  Its operations: the
    # matvec's ~70 a constraint and ~6 a node, the three dots' 18 a node,
    # the x / r / z / p updates and the preconditioner ~36 a node.  Its
    # bound: the contract's (each input read once a solve, the operations
    # of the steps run) and, per step, one re-read of the blocks, lists and
    # begin/end and 40 floats a node (pinv, diag, fm, five state vectors
    # read, four written), as a step that kept nothing on the chip.
    solve_ms = cuda_ms(lambda: k4.pcg_solve(*ps), 5)
    solve_graph = graph_ms(lambda: k4.pcg_solve(*ps), 3)
    loop_ms = cuda_ms(lambda: host_loop(k4_mv, k4.fixed_dots), 2)
    _, it_lib = host_loop(csr_mv, torch_dots)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lib_ms = cuda_ms(lambda: host_loop(csr_mv, torch_dots), 2)
    twin_ms = cuda_ms(lambda: k4.pcg_solve_twin(*ps), 1)
    lists = (inc.b_ptr, inc.b_idx, inc.e_ptr, inc.e_idx)
    step_ops = 70 * C + 60 * n
    reread = (nbytes(t["begin"], t["end"], baa, bab, bbb, *lists)
              + 40 * 4 * n) / PEAK_BYTES_PER_S * 1e3
    pcg = timed(0.0, solve_ms, twin_ms,
                nbytes(t["begin"], t["end"], baa, bab, bbb, d, lam, fm, pinv,
                       rhs, *lists, x, it),
                step_ops * (steps + 1), library_ms=lib_ms)
    print(f"[5] pcg_solve a CG step (district, {steps} steps a solve; the "
          f"library arm {it_lib}): kernel {solve_ms / steps:.5f} ms, in a "
          f"CUDA graph {solve_graph / steps:.5f} ms; host loop over "
          f"pcg_matvec and fixed_dots "
          f"{loop_ms / steps:.5f} ms; host loop on CSR x v "
          f"{lib_ms / it_lib:.5f} ms; twin {twin_ms / steps:.4f} ms; bound "
          f"{pcg['bound_ms'] / (steps + 1):.6f} ms ({pcg['bound_by']}, "
          f"inputs once a solve), {reread:.6f} ms re-reading a step's "
          f"inputs ({ident})")
    # The public fixed_dots (no path launches it since the mesh's loop is
    # planned): one pair beside torch.dot, in the kernels line; two pairs
    # (one launch) beside two torch.dot calls.
    vf, yf = v.reshape(-1), y.reshape(-1)
    dot = timed(0.0, cuda_ms(lambda: k4.fixed_dots((v, y)), 50),
                cuda_ms(lambda: k4.fixed_dots_twin((v, y)), 10),
                nbytes(v, y) + 4, 2 * v.numel(),
                library_ms=cuda_ms(lambda: torch.dot(vf, yf), 50))
    dot["graph_ms"] = (graph_ms(lambda: k4.fixed_dots((v, y)), 50),
                       graph_ms(lambda: torch.dot(vf, yf), 50))
    two_ms = cuda_ms(lambda: k4.fixed_dots((v, y), (y, y)), 50)
    two_lib = cuda_ms(lambda: (torch.dot(vf, yf), torch.dot(yf, yf)), 50)
    two_graph = (graph_ms(lambda: k4.fixed_dots((v, y), (y, y)), 50),
                 graph_ms(lambda: (torch.dot(vf, yf), torch.dot(yf, yf)), 50))
    print(f"[5] fixed_dots of two pairs (one launch; the CG step's r . z "
          f"and r . r) {two_ms:.4f} ms, in a CUDA graph {two_graph[0]:.5f} "
          f"ms; two torch.dot calls {two_lib:.4f} ms, in a CUDA graph "
          f"{two_graph[1]:.5f} ms ({ident})")
    print(f"[5] the public pcg_matvec (damped) on the district: "
          f"{cuda_ms(lambda: k4.pcg_matvec(*mv), 50):.4f} ms a call, in a "
          f"CUDA graph {graph_ms(lambda: k4.pcg_matvec(*mv), 50):.5f} ms; "
          f"CSR x v {cuda_ms(lambda: csr @ v.reshape(-1, 1), 50):.4f} ms "
          f"({ident})")
    # normal_blocks: per constraint the residual, its Jacobians, the robust
    # weight and three 3x3 blocks (~300 operations).
    out = {"pcg_solve": pcg,
           "fixed_dot": dot,
           "normal_blocks": timed(
               0.0, cuda_ms(lambda: k4.normal_blocks(*nb), 20),
               cuda_ms(lambda: k4.normal_blocks_twin(*nb), 5),
               nbytes(*args, *a), 300 * C,
               graph_ms=(graph_ms(lambda: k4.normal_blocks(*nb), 20),
                         None))}
    out.update(system)
    out.update(cg_forms(district, dev, ident))
    return out


def parent_preconditioner(g, diag, lam, free_mask, eps=None):
    """The parent tree's ``graph/solver.py::_preconditioner``, eager on the
    card: a host->device copy of 1e-8, ~8 elementwise kernels and a batched
    ``torch.linalg.inv`` (which reads its status back: a sync).  With
    ``eps`` (1e-8 already on the device) and ``torch.linalg.inv_ex``: the
    same kernels without the copy and the read, to capture in a CUDA
    graph."""
    import torch
    dt, dev = g.dtype, g.device
    eye = torch.eye(3, dtype=dt, device=dev)
    one = (torch.tensor(1e-8, dtype=dt, device=dev) if eps is None
           else eps)
    dd = diag + lam * (diag * eye) + one * eye
    fm = free_mask.to(dt)
    m = dd + (1.0 - fm)[:, None, None] * eye
    pinv = torch.linalg.inv(m) if eps is None else torch.linalg.inv_ex(m)[0]
    return pinv.contiguous(), -g * fm[:, None]


def check_pcg_system(t, args, inc, lam, fm, ident) -> dict:
    """K4's PCG normal system on the district: ``pcg_normal_system`` (the
    blocks, D, pinv and b in one launch) bitwise its twin for the three
    losses and reproducible, its planned form (``k4.PcgPlan``) bitwise the
    unplanned, and the mesh's standalone ``preconditioner`` bitwise its
    twin and the fused launch's pinv and b.  Times the fused launch
    (planned and not, host µs a call) beside its parent's arm, which ran
    ``normal_blocks`` and the eager preconditioner (with its copy and
    read; its kernels alone in a CUDA graph), and the preconditioner
    alone.  Returns the kernels line's entries."""
    import torch

    from ndt_2d_tpu_torch.kernels import normal_blocks as k4
    n, C = t["poses"].shape[0], t["begin"].numel()
    for loss in ("none", "huber", "geman_mcclure"):
        sys_args = args + (loss, 1.0, inc, lam, fm)
        a = k4.pcg_normal_system(*sys_args)
        b = k4.pcg_normal_system_twin(*sys_args)
        again = k4.pcg_normal_system(*sys_args)
        blocks = k4.normal_blocks(*args, loss, 1.0, inc)
        torch.cuda.synchronize()
        names = ("Baa", "Bab", "Bbb", "D", "pinv", "b")
        for name, x, y, z in zip(names, a, b, again):
            require(same_bits(x, y), f"K4 pcg_normal_system ({loss}): "
                    f"{name} differs from twin")
            require(same_bits(x, z), f"K4 pcg_normal_system ({loss}) not "
                    "bitwise reproducible")
        for x, y in zip(a[:4], blocks[:3] + blocks[6:]):
            require(same_bits(x, y), f"K4 pcg_normal_system ({loss}): the "
                    "blocks or D differ from normal_blocks'")
        g = blocks[5]
        pre = k4.preconditioner(g, a[3], lam, fm)
        pre_t = k4.preconditioner_twin(g, a[3], lam, fm)
        torch.cuda.synchronize()
        require(same_bits(pre[0], pre_t[0]) and same_bits(pre[1], pre_t[1]),
                f"K4 preconditioner ({loss}) differs from its twin")
        require(same_bits(pre[0], a[4]) and same_bits(pre[1], a[5]),
                f"K4 preconditioner ({loss}) differs from the fused launch")
        pre2 = k4.preconditioner(g, a[3], lam, fm)
        require(same_bits(pre[0], pre2[0]) and same_bits(pre[1], pre2[1]),
                f"K4 preconditioner ({loss}) not bitwise reproducible")
    terms = args[1:] + ("none", 1.0)
    state = k4.lm_state(t["poses"], 1e-3, torch.zeros((), device=lam.device),
                        C)
    state.lam.copy_(lam)
    plan = k4.PcgPlan(state, *terms, inc, fm)
    ps = (t["poses"],) + terms + (inc, lam, fm)
    planned = [x.clone() for x in plan.system()]
    torch.cuda.synchronize()
    require(all(same_bits(x, y) for x, y in zip(
        planned, k4.pcg_normal_system(*ps))),
            "K4 PcgPlan's launch differs from the unplanned one")
    # The parent's arm: normal_blocks, then the eager preconditioner.
    par = parent_preconditioner(g, a[3], lam, fm.bool())
    torch.cuda.synchronize()
    rel = float(((par[0] - a[4]).abs().amax(dim=(1, 2))
                 / a[4].abs().amax(dim=(1, 2))).max())
    require(same_bits(par[1], a[5]) and rel < 1e-3,
            f"the fused pinv is {rel} from the parent's cuBLAS inverse")
    nb = args + ("none", 1.0, inc)
    eps = torch.tensor(1e-8, device=lam.device)

    def parent():
        blocks = k4.normal_blocks(*nb)
        return parent_preconditioner(blocks[5], blocks[6], lam, fm.bool())

    def parent_graphable():
        blocks = k4.normal_blocks(*nb)
        return parent_preconditioner(blocks[5], blocks[6], lam, fm.bool(),
                                     eps)
    fused_ms = cuda_ms(plan.system, 50)
    # Five graph readings, their median kept: one replay of 20 calls can
    # read a stall twice the launch's time.
    fused_graphs = [graph_ms(plan.system, 20) for _ in range(5)]
    fused_graph = sorted(fused_graphs)[2]
    unplanned_ms = cuda_ms(lambda: k4.pcg_normal_system(*ps), 50)
    parent_ms = cuda_ms(parent, 20)
    parent_graph = graph_ms(parent_graphable, 10)
    nb_graph = graph_ms(lambda: k4.normal_blocks(*nb), 20)
    host_plan = host_us(plan.system, 50, sync=True)
    host_unplanned = host_us(lambda: k4.pcg_normal_system(*ps), 50, sync=True)
    host_parent = host_us(parent, 20, sync=True)
    pre_ms = cuda_ms(lambda: k4.preconditioner(g, a[3], lam, fm), 50)
    pre_graph = graph_ms(lambda: k4.preconditioner(g, a[3], lam, fm), 50)
    lists = (inc.b_ptr, inc.b_idx, inc.e_ptr, inc.e_idx)
    print(f"[3] K4 pcg_normal_system on the district ({n} nodes, {C} "
          "constraints): Baa, Bab, Bbb, D, pinv and b bitwise its twin for "
          "the three losses and reproducible, the blocks and D bitwise "
          "normal_blocks', PcgPlan bitwise the unplanned launch; the "
          "standalone preconditioner bitwise its twin and the fused pinv "
          f"and b, and reproducible; pinv within {rel:.2e} (relative to "
          "each block's largest entry) of the parent's cuBLAS inverse, b "
          "bitwise")
    print(f"[5] K4 pcg_normal_system (district): planned {fused_ms:.4f} ms, "
          f"in a CUDA graph {fused_graph:.5f} ms (median of "
          f"{', '.join(f'{x:.5f}' for x in fused_graphs)}), host "
          f"{host_plan:.1f} us; "
          f"unplanned {unplanned_ms:.4f} ms, host {host_unplanned:.1f} us; "
          f"[parent: normal_blocks + the eager preconditioner {parent_ms:.4f}"
          f" ms, host {host_parent:.1f} us; in a CUDA graph (inv_ex, the "
          f"1e-8 on the device) {parent_graph:.5f} ms, of it normal_blocks "
          f"{nb_graph:.5f} ms]; the preconditioner alone {pre_ms:.4f} ms, "
          f"in a CUDA graph {pre_graph:.5f} ms ({ident})")
    return {
        "pcg_normal_system": timed(
            0.0, fused_ms, cuda_ms(lambda: k4.pcg_normal_system_twin(*ps), 3),
            nbytes(*args, *lists, lam, fm, *planned),
            300 * C + 150 * n, graph_ms=(fused_graph, None)),
        "preconditioner": timed(
            0.0, pre_ms,
            cuda_ms(lambda: k4.preconditioner_twin(g, a[3], lam, fm), 5),
            nbytes(g, a[3], lam, fm, *pre), 150 * n,
            graph_ms=(pre_graph, None))}


def pcg_iteration_kernels(district, dev) -> list:
    """The device events (kernels and copies, in start order) of one
    device's PCG LM iteration on the district, from torch.profiler: from
    the iteration's ``pcg_normal_system`` launch to its ``lm_step``.
    Fails on a library inverse, a copy, or any kernel between the
    normal-system launch and ``pcg_solve``'s."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ndt_2d_tpu_torch import convert
    from ndt_2d_tpu_torch.config import SolverConfig
    from ndt_2d_tpu_torch.graph import solver
    cfg = SolverConfig(max_iterations=2, cg_max_iterations=150)
    t = convert.solve_inputs_to_port(dev, **district)
    t.pop("robust_mask")
    solver.solve(cfg, **t, use_dense=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        solver.solve(cfg, **t, use_dense=False)
        torch.cuda.synchronize()
    evs = sorted((ev for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda ev: ev.time_range.start)
    names = [ev.name for ev in evs]
    first = next((i for i, x in enumerate(names)
                  if "pcg_normal_system" in x), None)
    require(first is not None, f"no pcg_normal_system kernel in {names}")
    last = next((i for i in range(first, len(names))
                 if "lm_step" in names[i]), None)
    require(last is not None, f"no lm_step after the system: {names}")
    window = names[first:last + 1]
    require(not any("inv" in x.lower() or "getr" in x.lower()
                    for x in names), f"a library inverse in {names}")
    require(len(window) == 3 and "pcg" in window[1]
            and "Memcpy" not in window[1],
            f"one PCG LM iteration launched {window}")
    return window


def parent_iteration_kernels(district, dev) -> list:
    """The parent's PCG LM iteration on the same card, replayed from its
    pieces (``normal_blocks``, the eager preconditioner, ``pcg_solve``,
    ``lm_step``): its device events from the first to ``lm_step``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ndt_2d_tpu_torch import convert
    from ndt_2d_tpu_torch.kernels import normal_blocks as k4
    t = convert.solve_inputs_to_port(dev, **district)
    n, C = t["poses"].shape[0], t["begin"].numel()
    inc = k4.incidence(t["begin"], t["end"], t["constraint_mask"], n)
    free = t["node_mask"] & (torch.arange(n, device=dev) != 0)
    fm = free.float()
    terms = (t["begin"], t["end"], t["transform"], t["information"],
             t["constraint_mask"], t["robust_mask"], "none", 1.0)
    cost0 = k4.robust_cost(t["poses"], None, None, *terms)

    def iteration():
        state = k4.lm_state(t["poses"], 1e-4, cost0, C)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            baa, bab, bbb, _, _, g, diag = k4.normal_blocks(
                state.poses, *terms, inc)
            pinv, b = parent_preconditioner(g, diag, state.lam, free)
            x = k4.pcg_solve(t["begin"], t["end"], baa, bab, bbb, diag,
                             state.lam, fm, pinv, b, 150, 1e-6, inc)[0]
            k4.lm_step(state, x, None, *terms, 0.5, 10.0, 1e-9)
            torch.cuda.synchronize()
        return prof
    iteration()
    evs = sorted((ev for ev in iteration().events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda ev: ev.time_range.start)
    return [ev.name for ev in evs]


def short_names(names) -> list:
    """Kernel names without namespaces, template arguments and
    signatures (copies as the profiler names them)."""
    import re
    out = []
    for x in names:
        if not x.startswith(("Memcpy", "Memset")):
            x = re.sub(r"^void ", "", x.replace("(anonymous namespace)::", ""))
            x = re.split(r"[<(]", x, maxsplit=1)[0] or x
        out.append(x)
    return out


CG_PHASES = 4  # the start, the plain step and both direction parities
# The CG loop's launch counts by form (kernels/normal_blocks.py).
CG_FORMS = ("pcg_matvec", "pcg_matvec_direction", "fixed_dot",
            "fixed_dot_damp", "fixed_dot_update")
# The mesh's district solve's K4 launches rank 0 reports.
MESH_DISTRICT_KERNELS = CG_FORMS + ("pcg_solve", "normal_blocks",
                                    "preconditioner", "pcg_normal_system")


def check_cg_plan(ps, x, steps: int):
    """One LM step's planned CG loop (``k4.CgPlan``, a mesh rank's with the
    identity combine; ``ps`` pcg_solve's arguments) on the kernels against
    the same plan on the twins, launch by launch over the first
    ``CG_PHASES`` phases: after each ``pcg_matvec`` (plain, then with the
    direction loader), variant (A) and variant (B) launch every buffer,
    scalar and the stop flag bitwise.  Then whole loops: twice on the
    kernels (the same bits), bitwise ``mesh_cg`` over the twins, and equal
    to pcg_solve's x and ``steps``.  Returns a summary and each planned
    form's largest difference from its twin, by kernels-line name."""
    import torch

    from ndt_2d_tpu_torch.kernels import normal_blocks as k4
    (begin, end, baa, bab, bbb, d, lam, fm, pinv, rhs, max_iter, tol,
     inc) = ps
    args = (begin, end, baa, bab, bbb, d, lam, fm, pinv, rhs, inc, tol)
    kern, twin = k4.CgPlan(*args), k4.CgPlan(*args, twin=True)
    names = ("part", "ap", "x", "r", "p", "z", "sc", "stop")
    for plan in (kern, twin):  # the same start for buffers not yet written
        for nm in ("part", "ap", "r", "p", "z"):
            getattr(plan, nm).zero_()
    errs = dict.fromkeys(("pcg_matvec", "pcg_matvec_direction",
                          "fixed_dot_damp", "fixed_dot_update"), 0.0)
    for s in range(CG_PHASES):
        for step in ("matvec", "damp", "update"):
            for plan in (kern, twin):
                if step == "damp":
                    plan.damp(plan.part, s)
                else:
                    getattr(plan, step)(s)
            torch.cuda.synchronize()
            for nm in names:
                require(same_bits(getattr(kern, nm), getattr(twin, nm)),
                        f"K4 CG plan, phase {s}, {step}: {nm} differs from "
                        "the twins'")
            key = {"matvec": "pcg_matvec" if s < 2
                   else "pcg_matvec_direction", "damp": "fixed_dot_damp",
                   "update": "fixed_dot_update"}[step]
            errs[key] = max(errs[key], max_abs_diff(
                (getattr(kern, nm).float(), getattr(twin, nm).float())
                for nm in names))
    runs = [k4.CgPlan(*args).run(identity, max_iter) for _ in range(2)]
    oracle = k4.mesh_cg(*ps, combine=identity, twin=True)
    torch.cuda.synchronize()
    (x1, it1), (x2, it2) = runs
    require(same_bits(x1, x2) and it1 == it2,
            "K4 CG plan not bitwise reproducible")
    require(same_bits(x1, oracle[0]) and it1 == oracle[1],
            f"K4 CG plan: {it1} steps, mesh_cg over the twins {oracle[1]}, "
            "or x differs")
    require(torch.equal(x1, x) and it1 == steps,
            f"K4 CG plan: {it1} steps, pcg_solve {steps}, or x differs")
    return (f"the planned CG loop (a mesh rank's, identity combine) launch "
            f"by launch over {CG_PHASES} phases bitwise its twins, {it1} "
            "steps bitwise mesh_cg over the twins and equal to pcg_solve"
            ), errs


def identity(part):
    """The combine of a mesh of one rank."""
    return part


def cg_forms(district, dev, ident: str) -> dict:
    """The planned CG loop's launches at rank 0's shard of the (1, 2) mesh
    (half the district's constraints over all 50,000 nodes), the shape the
    mesh's solve gives them: the loop held to its twins launch by launch
    and to pcg_solve (``check_cg_plan``), then each form timed for the
    kernels line, after one step of the plan: the matvec with v as given
    (``pcg_matvec``, a solve's first two phases) beside the sparse CSR
    product at lam 0, the matvec forming the direction
    (``pcg_matvec_direction``), variant (A) (``fixed_dot_damp``) and
    variant (B) (``fixed_dot_update``), each beside the same plan on the
    twins.  Bounds: the bytes of each input read once and each output
    written once (of diag only the diagonal, which the launches read; the
    lists as the kernel reads them, ptr and pairs; (B) reads r, Ap, x, p,
    pinv and fm and writes x, r and z) and the operations of
    the launch's arithmetic: the matvec ~70 a constraint and ~6 a node (12
    with the direction formed), (A) 7 an element (the damping's five, the
    product and its add), (B) 14 an element (r, z and x updated, the two
    products and their adds)."""
    import torch

    from ndt_2d_tpu_torch.kernels import normal_blocks as k4
    ps = district_cg(district, dev, half=True)
    (begin, end, baa, bab, bbb, d, lam, fm, pinv, rhs, max_iter, tol,
     inc) = ps
    x, it = k4.pcg_solve(*ps)
    summary, errs = check_cg_plan(ps, x, int(it))
    n, C = rhs.shape[0], begin.numel()
    args = (begin, end, baa, bab, bbb, d, lam, fm, pinv, rhs, inc, tol)
    kern, twin = k4.CgPlan(*args), k4.CgPlan(*args, twin=True)
    for plan in (kern, twin):
        plan.run(identity, 1)
    csr = block_csr(begin, end, baa, bab, bbb, d, torch.zeros((), device=dev),
                    fm, n)
    v = kern.p[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lib = (csr @ v.reshape(-1, 1)).reshape(n, 3)
        lib_ms = cuda_ms(lambda: csr @ v.reshape(-1, 1), 50)
        lib_graph = graph_ms(lambda: csr @ v.reshape(-1, 1), 50)
    kern.matvec(1)
    torch.cuda.synchronize()
    require(torch.allclose(lib, kern.part, rtol=1e-4, atol=1e-4 * float(
        kern.part.abs().max())),
            "the sparse product differs from the planned matvec")
    vec = 4 * 3 * n  # one [N, 3] f32 vector
    walk = nbytes(inc.b_ptr, inc.e_ptr, inc.b_pair, inc.e_pair, baa, bab,
                  bbb, fm) + vec  # and diag's diagonal
    forms = {
        "pcg_matvec": (lambda p: p.matvec(1), walk + 2 * vec + 4,
                       70 * C + 6 * n, (lib_ms, lib_graph)),
        "pcg_matvec_direction": (lambda p: p.matvec(2), walk + 4 * vec + 8,
                                 70 * C + 12 * n, (None, None)),
        "fixed_dot_damp": (lambda p: p.damp(p.part, 1),
                           nbytes(fm) + 4 * vec + 16, 7 * 3 * n,
                           (None, None)),
        "fixed_dot_update": (lambda p: p.update(1),
                             nbytes(pinv, fm) + 7 * vec + 24, 14 * 3 * n,
                             (None, None))}
    out = {}
    for name, (fn, moved, ops, (lms, lgraph)) in forms.items():
        out[name] = timed(errs[name], cuda_ms(lambda: fn(kern), 50),
                          cuda_ms(lambda: fn(twin), 10), moved, ops,
                          library_ms=lms,
                          graph_ms=(graph_ms(lambda: fn(kern), 50), lgraph))
    print(f"[3] K4's planned CG loop at rank 0's shard of the (1, 2) mesh "
          f"({C} constraints, {n} nodes): {summary}; the planned matvec "
          f"within 1e-4 of the sparse CSR product ({ident})")
    return out


def district_cg(district, dev, half: bool = False):
    """``pcg_solve``'s arguments of the district's first LM step (lam
    1e-3, node 0 fixed, 150 steps, tol 1e-6); with ``half`` those of rank 0
    of the (1, 2) mesh: the first half of the constraints over all 50,000
    nodes (many empty lists), its blocks and incidence, the preconditioner
    of the whole graph."""
    import torch

    from ndt_2d_tpu_torch import convert
    from ndt_2d_tpu_torch.graph import solver
    from ndt_2d_tpu_torch.kernels import normal_blocks as k4
    t = convert.solve_inputs_to_port(dev, **district)
    n = t["poses"].shape[0]
    keys = ("begin", "end", "transform", "information", "constraint_mask",
            "robust_mask")
    args = [t["poses"], *(t[k] for k in keys)]
    inc = k4.incidence(t["begin"], t["end"], t["constraint_mask"], n)
    whole = k4.normal_blocks(*args, "none", 1.0, inc)
    if half:
        c = t["begin"].numel() // 2
        args = [t["poses"], *(t[k][:c].contiguous() for k in keys)]
        inc = k4.incidence(args[1], args[2], args[5], n)
    baa, bab, bbb = k4.normal_blocks(*args, "none", 1.0, inc)[:3]
    fm = (torch.arange(n, device=dev) != 0).float()
    lam = torch.tensor(1e-3, device=dev)
    pinv, rhs = solver._preconditioner(whole[5], whole[6], lam, fm.bool())
    return (args[1], args[2], baa, bab, bbb, whole[6], lam, fm, pinv, rhs,
            150, 1e-6, inc)


def cg_times(dev, ident: str) -> dict:
    """K4's CG loop launches at the district's shapes, each timed by
    ``cuda_ms`` (host included), ``graph_ms`` (the device alone) and
    ``host_us`` (the median call with the device idle): the public
    ``pcg_matvec`` at one device's district and at rank 0's shard of the
    (1, 2) mesh, the public ``fixed_dots`` of one and two pairs beside
    ``torch.dot``; where the tree has ``k4.CgPlan``, its planned launches
    (the matvec plain and with the direction loader, variants (A) and (B);
    host µs with the stream read once, as the loop reads it); and one LM
    step's whole CG loop a step: ``pcg_solve``, the host loop over the
    public wrappers and the planned loop (a mesh rank's with the identity
    combine); and the digest of one device's PCG solve of the district.
    Calls only what a tree has, so a copy run in an older checkout times
    that checkout."""
    import hashlib

    import torch

    from ndt_2d_tpu_torch import convert
    from ndt_2d_tpu_torch.config import SolverConfig
    from ndt_2d_tpu_torch.graph import solver
    from ndt_2d_tpu_torch.kernels import _build
    from ndt_2d_tpu_torch.kernels import normal_blocks as k4
    planned = hasattr(k4, "CgPlan")
    _, district = district_graph()
    out = {}

    def three(name, fn, pre=None, reps=50):
        out[name] = {"cuda_ms": cuda_ms(fn, reps),
                     "graph_ms": graph_ms(fn, reps),
                     "host_us": host_us(pre or fn, 101, sync=True)}
    for shape, half in (("district", False), ("(1, 2) shard", True)):
        ps = district_cg(district, dev, half)
        (begin, end, baa, bab, bbb, d, lam, fm, pinv, rhs, max_iter, tol,
         inc) = ps
        mv = (begin, end, baa, bab, bbb, d, lam, fm, rhs, inc)
        three(f"K4 pcg_matvec, {shape}", lambda mv=mv: k4.pcg_matvec(*mv))
        if not planned:
            continue
        plan = k4.CgPlan(begin, end, baa, bab, bbb, d, lam, fm, pinv, rhs,
                         inc, tol)
        plan.run(identity, 1)
        st = _build.stream_ptr(dev)
        for s, what in ((1, "planned"), (2, "planned, direction formed")):
            three(f"K4 pcg_matvec, {shape}, {what}",
                  lambda s=s, plan=plan: plan.matvec(s),
                  lambda s=s, plan=plan: plan.matvec(s, st))
        if half:
            continue
        for s in (1, 2):
            three(f"K4 fixed_dots variant (A), step parity {s % 2}",
                  lambda s=s: plan.damp(plan.part, s),
                  lambda s=s: plan.damp(plan.part, s, st))
            three(f"K4 fixed_dots variant (B), step parity {s % 2}",
                  lambda s=s: plan.update(s),
                  lambda s=s: plan.update(s, st))
    v, y = rhs, k4.pcg_matvec(*mv)
    vf, yf = v.reshape(-1), y.reshape(-1)
    three("K4 fixed_dots, one pair", lambda: k4.fixed_dots((v, y)))
    three("K4 fixed_dots, two pairs", lambda: k4.fixed_dots((v, y), (y, y)))
    three("torch.dot, one pair", lambda: torch.dot(vf, yf))
    three("torch.dot, two pairs",
          lambda: (torch.dot(vf, yf), torch.dot(yf, yf)))
    # One LM step's CG loop, a step.
    ps = district_cg(district, dev)
    (begin, end, baa, bab, bbb, d, lam, fm, pinv, rhs, max_iter, tol,
     inc) = ps
    steps = int(k4.pcg_solve(*ps)[1])

    def host_loop():
        return k4.pcg_loop(
            lambda u: k4.pcg_matvec(begin, end, baa, bab, bbb, d, lam, fm, u,
                                    inc), k4.fixed_dots, pinv, fm, rhs,
            max_iter, tol)
    loops = {"pcg_solve": lambda: k4.pcg_solve(*ps), "host loop": host_loop}
    if planned:
        loops["planned loop, identity combine"] = lambda: k4.mesh_cg(
            *ps, combine=identity)
    for name, fn in loops.items():
        out[f"K4 CG step ({name})"] = {"ms_a_step": cuda_ms(fn, 3) / steps,
                                       "steps": steps}
    # One device's PCG solve of the district (normal_blocks, pcg_solve,
    # lm_step): its poses' digest, which two trees' runs compare bitwise.
    t = convert.solve_inputs_to_port(dev, **district)
    t.pop("robust_mask")
    res = solver.solve(SolverConfig(max_iterations=30, cg_max_iterations=150),
                       **t, use_dense=False)
    digest = hashlib.sha256(res.poses.cpu().numpy().tobytes()).hexdigest()
    print(f"[5] district PCG solve on one device: {int(res.iterations)} LM "
          f"iterations, poses sha256 {digest[:16]} ({ident})")
    for name, t in out.items():
        if "ms_a_step" in t:
            print(f"[5] {name}: {t['ms_a_step']:.5f} ms a step over "
                  f"{t['steps']} steps ({ident})")
        else:
            print(f"[5] {name}: {t['cuda_ms']:.4f} ms, in a CUDA graph "
                  f"{t['graph_ms']:.5f} ms, host {t['host_us']:.1f} us a "
                  f"call ({ident})")
    return out


def block_csr(begin, end, baa, bab, bbb, diag, lam, fm, n):
    """The matrix of K4's matvec, F (sum_c blocks + lam diag(D)) F with F
    the free-node mask, as a torch sparse CSR matrix [3n, 3n]."""
    import torch
    b, e = begin.long(), end.long()
    i3 = torch.arange(3, device=b.device)
    rows, cols, vals = [], [], []
    for (r, c), blk in (((b, b), baa), ((b, e), bab),
                        ((e, b), bab.transpose(1, 2)), ((e, e), bbb)):
        rows.append((3 * r[:, None, None] + i3[None, :, None]).expand(
            -1, 3, 3).reshape(-1))
        cols.append((3 * c[:, None, None] + i3[None, None, :]).expand(
            -1, 3, 3).reshape(-1))
        vals.append(blk.reshape(-1))
    node = torch.arange(n, device=b.device)
    rows.append((3 * node[:, None] + i3).reshape(-1))
    cols.append((3 * node[:, None] + i3).reshape(-1))
    vals.append((lam * torch.diagonal(diag, dim1=-2, dim2=-1)).reshape(-1))
    rows, cols, vals = (torch.cat(x) for x in (rows, cols, vals))
    f3 = fm.repeat_interleave(3)
    vals = vals * f3[rows] * f3[cols]
    with warnings.catch_warnings():  # torch calls sparse CSR "beta"
        warnings.simplefilter("ignore")
        coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                      (3 * n, 3 * n)).coalesce()
        return coo.to_sparse_csr()


def phase_district_solve(truth, district, dev):
    """The single-device PCG solve of the district (config 5's
    SolverConfig), on the kernels (one ``pcg_solve`` launch an LM step)
    and on the twins, bitwise equal.  Then each LM step's CG loop, recorded
    from a third kernels' solve, again as the planned mesh loop
    (``k4.mesh_cg`` with the identity combine: three launches a step) and
    as the host loop over the public ``pcg_matvec`` and ``fixed_dots``
    (the loop's design before the plan), each equal to the kernel's in x
    and the step count, with the walls of the three loops.  Returns the
    kernels' run's launches and the solved poses."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch import convert
    from ndt_2d_tpu_torch.config import SolverConfig
    from ndt_2d_tpu_torch.graph import solver
    from ndt_2d_tpu_torch.kernels import normal_blocks as k4
    cfg = SolverConfig(max_iterations=30, cg_max_iterations=150)
    t = convert.solve_inputs_to_port(dev, **district)
    t.pop("robust_mask")
    out = {}
    for arm in ("kernel", "twin"):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve(cfg, **t, use_dense=False, twin=arm == "twin")
        torch.cuda.synchronize()
        out[arm] = (res, time.perf_counter() - t0, read_counts())
    res, wall, launches = out["kernel"]
    # Each LM step's pcg_solve inputs and result, from one more solve.
    real, steps = k4.pcg_solve, []

    def record(*args):
        x, it = real(*args)
        # lam is the LM state's, which lm_step updates in place.
        steps.append((tuple(a.clone() if isinstance(a, torch.Tensor) else a
                            for a in args), x.clone(), it.clone()))
        return x, it
    k4.pcg_solve = record
    try:
        again = solver.solve(cfg, **t, use_dense=False)
    finally:
        k4.pcg_solve = real
    require(torch.equal(again.poses, res.poses),
            "district solve not bitwise reproducible")
    walls = {"kernel": 0.0, "planned mesh loop": 0.0, "host loop": 0.0}
    cg_steps = 0
    for args, x, it in steps:
        (begin, end, baa, bab, bbb, diag, lam, fm, pinv, b, max_iter, tol,
         inc) = args

        def matvec(v):
            return k4.pcg_matvec(begin, end, baa, bab, bbb, diag, lam, fm, v,
                                 inc)
        for arm in walls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if arm == "kernel":
                xa, ita = real(*args)
                ita = int(ita)
            elif arm == "planned mesh loop":
                # A mesh rank's loop with the identity combine: the
                # undamped partial, damped by variant (A).
                xa, ita = k4.mesh_cg(*args, combine=identity)
            else:
                xa, ita = k4.pcg_loop(matvec, k4.fixed_dots, pinv, fm, b,
                                      max_iter, tol)
            torch.cuda.synchronize()
            walls[arm] += time.perf_counter() - t0
            require(torch.equal(xa, x) and ita == int(it),
                    f"district LM step {len(steps)}: the {arm}'s CG loop "
                    "differs from the solve's pcg_solve")
        cg_steps += int(it)
    poses = res.poses.cpu().numpy().astype(np.float64)

    def rmse(p):
        return float(np.sqrt(np.mean(np.sum((p[:, :2] - truth[:, :2]) ** 2,
                                            -1))))
    init, final = rmse(district["poses"]), rmse(poses)
    lm = int(res.iterations)
    require(bool(res.success), "district solve failed")
    require(final < init, f"district RMSE {final} not below initial {init}")
    require(torch.equal(res.poses, out["twin"][0].poses),
            "district solve: the twins' poses differ from the kernels'")
    require(launches["pcg_solve"] == lm == len(steps)
            and launches["pcg_normal_system"] == lm
            and launches["normal_blocks"] == 0
            and launches["preconditioner"] == 0,
            f"district solve: {lm} LM iterations, launches {launches}")
    print(f"[4b] district PCG solve ({truth.shape[0]} nodes): RMSE "
          f"{init:.4f} -> {final:.4f} m in {lm} LM iterations; wall "
          f"{wall:.3f} s on the kernels (one pcg_solve launch an LM "
          f"iteration), {out['twin'][1]:.3f} s on the twins, poses bitwise "
          f"equal; the {lm} CG loops ({cg_steps} steps) {walls['kernel']:.3f}"
          f" s on pcg_solve ({walls['kernel'] / cg_steps * 1e3:.4f} ms a "
          f"step), {walls['planned mesh loop']:.3f} s as the planned mesh "
          f"loop (identity combine; "
          f"{walls['planned mesh loop'] / cg_steps * 1e3:.4f} ms a step), "
          f"{walls['host loop']:.3f} s as the host loop over the public "
          f"pcg_matvec and fixed_dots "
          f"({walls['host loop'] / cg_steps * 1e3:.4f} ms a step), x and "
          f"steps bitwise equal; launches pcg_normal_system "
          f"{launches['pcg_normal_system']}, pcg_solve "
          f"{launches['pcg_solve']}, normal_blocks "
          f"{launches['normal_blocks']}")
    window = pcg_iteration_kernels(district, dev)
    parent = parent_iteration_kernels(district, dev)
    print(f"[4b] one PCG LM iteration's device events (torch.profiler, "
          f"from the system's launch to lm_step): {short_names(window)}; "
          f"the parent's iteration replayed from its pieces: "
          f"{short_names(parent)} ({len(parent)} events, "
          f"{sum('HtoD' in x for x in parent)} host->device and "
          f"{sum('DtoH' in x for x in parent)} device->host copies)")
    return launches, poses


class Recorder:
    """Records the inputs and outputs of the first calls of the
    confirmation and the solve during a session, for the twin replay."""

    def __init__(self, mapper):
        from ndt_2d_tpu_torch.graph import solver
        from ndt_2d_tpu_torch.matching import matcher
        self.matcher, self.solver = matcher, solver
        self.real_batch = matcher.match_scan_batch_multi
        self.real_solve = solver.solve
        self.mapper = mapper
        self.dispatches, self.solves, self.chunks = [], [], 0
        self.rows = []  # the (padded) rows of each confirmation chunk

    def batch(self, config, *args, **kw):
        out = self.real_batch(config, *args, **kw)
        self.chunks += 1
        self.rows.append(int(args[0].shape[0]))
        if len(self.dispatches) < 2:
            m = self.mapper
            gate = (m.typical_matcher_response
                    * m.config.loop_closure_gate_scale)
            self.dispatches.append(
                (config, [a.clone() if hasattr(a, "clone") else a
                          for a in args], [o.clone() for o in out], gate))
        return out

    def solve(self, config, **kw):
        res = self.real_solve(config, **kw)
        if not self.solves:
            self.solves.append(
                (config, {k: v.clone() if hasattr(v, "clone") else v
                          for k, v in kw.items()}, res.poses.clone()))
        return res

    def __enter__(self):
        self.matcher.match_scan_batch_multi = self.batch
        self.solver.solve = self.solve
        return self

    def __exit__(self, *exc):
        self.matcher.match_scan_batch_multi = self.real_batch
        self.solver.solve = self.real_solve


def config6():
    """BASELINE config 6 (run_benchmarks.py:248-303): config 3 with
    descriptor loop search, as ``run --recipe office-descriptor`` builds it
    (gate 0.85, 3-scan regions, best-accept, 1.5 m separation, far dedup
    2.5 m, reject-cache margin 0.10, 16 far rows a pass, Geman-McClure,
    global refine_iterations 8)."""
    return office_config("--recipe", "office-descriptor")


def office_recipe_config():
    """Config 3 with the ``office`` recipe, as ``run --recipe office``
    builds it (gate scale 0.85, 3-scan regions, both search positions,
    Geman-McClure, global refine_iterations 8)."""
    return office_config("--recipe", "office")


class ExportRecorder:
    """Keeps the arguments of every K5 call a session's export makes
    (``occupancy`` calls ``raymarch.raymarch_counts``)."""

    def __enter__(self):
        from ndt_2d_tpu_torch.kernels import raymarch
        self.calls, self.real = [], raymarch.raymarch_counts

        def record(*args):
            self.calls.append(args)
            return self.real(*args)
        raymarch.raymarch_counts = record
        return self

    def __exit__(self, *exc):
        from ndt_2d_tpu_torch.kernels import raymarch
        raymarch.raymarch_counts = self.real


def check_export(rec, tag, name) -> None:
    """Each recorded K5 call of a session's export again, the kernel
    bitwise against its twin on the card on the session's own rays."""
    import torch

    from ndt_2d_tpu_torch.kernels import raymarch as k5
    require(rec.calls, f"{tag} {name}: the export never called K5")
    for args in rec.calls:
        hit, emp = k5.raymarch_counts(*args)
        hitt, empt = k5.raymarch_counts_twin(*args)
        require(torch.equal(hit, hitt) and torch.equal(emp, empt),
                f"{tag} {name}: K5 on the export's rays differs from its "
                f"twin")
    R, K = rec.calls[-1][0].shape[0], rec.calls[-1][7]
    print(f"{tag} {name}: K5 on the export's {R} rays x {K} samples "
          f"({rec.calls[-1][5]} x {rec.calls[-1][6]} cells) bitwise its "
          f"twin on the card ({int(hit.sum())} hits, {int(emp.sum())} "
          f"empty)")


def phase_office(cfg, bag, dev, tag="[4c]", plain=None):
    """The config-3 office session on the card, then the twin replay.  With
    ``plain`` (the plain config-3 run's numbers) this is the ``office``
    recipe run: its gates are >= 1 closure, >= 1 optimization and a final
    ATE below odometry's, and one K7 launch a confirmation chunk."""
    import numpy as np

    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    from ndt_2d_tpu_torch.utils import metrics
    mapper = Mapper(cfg, device=dev)
    with Recorder(mapper) as rec, ExportRecorder() as export:
        reset_counts()
        t0 = time.perf_counter()
        stats, grid, dt, _, acc_flags, _ = run_session(cfg, bag, dev,
                                                       mapper=mapper)
        wall = time.perf_counter() - t0
        launches = read_counts()
    acc = stats["scans_accepted"]
    st = mapper.stats
    used = bag.truth[np.nonzero(acc_flags)[0]]
    online = stats["ate_rmse_m"]
    final = metrics.ate_rmse(mapper.graph.poses[:acc], used)
    odom = metrics.ate_rmse(bag.odom, bag.truth)
    require(st.loop_closures_accepted >= 1, "no loop closure accepted")
    require(st.optimizations >= 1, "no optimization ran")
    require(plain is not None or final <= online * 1.10 + 1e-6,
            f"final ATE {final} above 1.10 x online {online}")
    require(final < odom, f"final ATE {final} not below odometry's {odom}")
    require(launches["newton"] == (rec.chunks if plain else 0),
            f"newton launched {launches['newton']} times with "
            f"{rec.chunks} confirmation chunks")
    for k in ("ndt_build", "candidate_scores"):
        require(launches[k] == acc - 1 + rec.chunks,
                f"{k} launched {launches[k]} times, expected {acc - 1} "
                f"rolling + {rec.chunks} confirmation chunks")
    require(launches["score_points"] == acc - 1, "score_points count")
    require(launches["dense_normal_system"] >= 1
            and launches["normal_blocks"] == launches["dense_system"] == 0
            and launches["raymarch"] >= 1,
            f"K4's dense path in one launch or K5 never launched: "
            f"{launches}")
    require(int((grid.data == 100).sum()) > 0, "no occupied cells")
    timing = st.timer.summary()
    ms = float(np.median(dt[acc_flags][4:]) * 1e3)
    numbers = dict(closures=st.loop_closures_accepted,
                   rejected=st.loop_closures_rejected,
                   optimizations=st.optimizations, online=online,
                   final=final, ms=ms,
                   lc_ms=timing["loop_closure"]["mean_ms"],
                   graph=mapper.graph, solver=cfg.solver)
    name = "office recipe" if plain else "office config 3"
    check_export(export, tag, name)
    print(f"{tag} {name}: {acc}/{len(bag)} scans accepted, "
          f"{st.loop_closures_accepted} closures accepted, "
          f"{st.loop_closures_rejected} rejected, {st.optimizations} "
          f"optimizations, {rec.chunks} confirmation chunks, "
          f"{st.confirm_rows_reused} rows reused; ATE online {online:.4f} "
          f"final {final:.4f} m (odometry {odom:.4f}); {ms:.3f} ms per "
          f"accepted scan (median), loop_closure "
          f"{timing['loop_closure']['mean_ms']:.3f} ms x "
          f"{timing['loop_closure']['count']}, optimize "
          f"{timing['optimize']['mean_ms']:.3f} ms x "
          f"{timing['optimize']['count']}; session {wall:.2f} s; "
          f"launches {launches}")
    if plain:
        print(f"{tag} beside plain config 3 in this run: closures "
              f"{plain['closures']} -> {numbers['closures']}, rejected "
              f"{plain['rejected']} -> {numbers['rejected']}, optimizations "
              f"{plain['optimizations']} -> {numbers['optimizations']}, "
              f"final ATE {plain['final']:.4f} -> {numbers['final']:.4f} m, "
              f"loop_closure {plain['lc_ms']:.3f} -> {numbers['lc_ms']:.3f} "
              f"ms, {plain['ms']:.3f} -> {ms:.3f} ms per accepted scan")
    shapes = {r: rec.rows.count(r) for r in sorted(set(rec.rows))}
    print(f"{tag} K1 and K2 launches by shape: {acc - 1} at R = 1 (one a "
          f"scan), {rec.chunks} confirmation chunks by rows {shapes}")
    if plain:
        print(f"{tag} K7 launches by shape: {launches['newton']}, one a "
              f"confirmation chunk, by rows {shapes} (G = 1, "
              f"{cfg.global_scan_matcher.refine_iterations} iterations)")
    phase_replay(rec, tag, 1 if plain else 2, solve=not plain)
    return launches, numbers


def phase_replay(rec, tag, dispatches, solve=True):
    """The first recorded dispatches (and the first solve) again, through
    the twins on the same CUDA inputs; K7's twin follows K2's where the
    global matcher refines."""
    import torch

    from ndt_2d_tpu_torch.graph import solver
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.kernels import newton as k7
    from ndt_2d_tpu_torch.matching import matcher, newton
    require(len(rec.dispatches) >= dispatches and (rec.solves or not solve),
            f"recorded {len(rec.dispatches)} dispatches and "
            f"{len(rec.solves)} solves")
    rows = 0
    for config, args, out, gate in rec.dispatches[:dispatches]:
        poses, points, pmask, wmask, rmax, qp, qm, qn, st = args
        grid, tables = k1.build_windows_twin(
            poses, points, pmask, wmask, rmax, config.ndt_resolution,
            config.grid_cells_x, config.grid_cells_y)
        twin, _ = k2.match_rows_twin(
            config, grid, tables, qp, qm, qn, st,
            *matcher._search_offsets(config, qp.device))
        scores = twin.score
        if config.refine_iterations > 0:
            scores = k7.refine_rows_twin(
                config, newton.with_row_grid_axes(grid, True), qp, qm, qn,
                st, k2.pack(twin), config.refine_iterations)[:, 0]
        live = wmask.any(dim=1)
        k, t = out[0][live], scores[live]
        require(torch.equal(k, t), "replayed confirmation scores differ")
        require(torch.equal(k < gate, t < gate),
                "replayed gate decisions differ")
        rows += int(live.sum())
    if not solve:
        print(f"{tag} replay through the twins: {rows} rows of "
              f"{dispatches} dispatch(es), scores bitwise equal, same gate "
              f"decisions")
        return
    config, kw, poses = rec.solves[0]
    res = solver.solve(config, **kw, twin=True)
    diff = float((res.poses - poses).abs().max())
    require(diff <= 1e-4, f"replayed solve differs by {diff}")
    print(f"{tag} replay through the twins: {rows} rows of {dispatches} "
          f"dispatches, scores bitwise equal, same gate decisions; first "
          f"solve "
          f"({int(kw['node_mask'].sum())} nodes) poses within {diff:.3g}")


def lm_graph(nodes: int, n_pad: int, closures: int, seed: int,
             hub: int = 0) -> dict:
    """``solve()`` inputs (numpy) of a synthetic pose graph padded to
    ``n_pad`` nodes: a noisy chain of ``nodes`` odometry constraints and
    ``closures`` robust loop closures, a tenth of them twice (duplicate
    node pairs) and a tenth also reversed (both directions), a live
    self-loop every 97 nodes, ``hub`` robust spokes between the middle
    node and random nodes (every other one entering it), about 5% of the
    constraints masked, and the padded nodes and constraints masked
    (N_pad <= 1024 solves densely)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    k = np.arange(nodes)
    truth = np.stack([0.5 * k, 5.0 * np.sin(k / 20.0),
                      np.cumsum(rng.normal(0, 0.05, nodes))], -1)
    a = rng.integers(0, nodes - 30, closures)
    pairs = [(i, i + 1) for i in range(nodes - 1)]
    loops = list(zip(a, np.minimum(a + rng.integers(20, 200, closures),
                                   nodes - 1)))
    pairs += loops + loops[:closures // 10]
    pairs += [(j, i) for i, j in loops[closures // 10:closures // 5]]
    pairs += [(i, i) for i in range(0, nodes, 97)]
    if hub:
        h = nodes // 2
        pairs += [(h, int(j)) if q % 2 else (int(j), h)
                  for q, j in enumerate(rng.integers(0, nodes, hub))]
    b = np.array([p[0] for p in pairs])
    e = np.array([p[1] for p in pairs])
    c, s = np.cos(truth[b, 2]), np.sin(truth[b, 2])
    d = truth[e, :2] - truth[b, :2]
    rel = np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1],
                    truth[e, 2] - truth[b, 2]], -1)
    rel += rng.normal(0, 0.01, rel.shape)
    C = len(pairs)
    c_pad = max(64, 1 << (C - 1).bit_length())
    poses = np.zeros((n_pad, 3), np.float32)
    poses[:nodes] = truth + np.cumsum(rng.normal(0, 0.02, (nodes, 3)), 0)
    poses[0] = truth[0]
    out = dict(poses=poses, begin=np.zeros(c_pad, np.int32),
               end=np.zeros(c_pad, np.int32),
               transform=np.zeros((c_pad, 3), np.float32),
               information=np.zeros((c_pad, 3, 3), np.float32),
               constraint_mask=np.zeros(c_pad, bool),
               node_mask=np.arange(n_pad) < nodes,
               robust_mask=np.zeros(c_pad, bool))
    out["begin"][:C], out["end"][:C] = b, e
    out["transform"][:C] = rel
    out["information"][:C] = np.diag([100.0, 100.0, 400.0])
    out["constraint_mask"][:C] = rng.random(C) > 0.05
    out["robust_mask"][nodes - 1:C] = True
    return out


def graph_inputs(graph, scfg, dev) -> dict:
    """The tensors ``solve_graph`` hands ``solve()`` for a mapper's graph
    (captured from one solve; the graph's poses are put back)."""
    from ndt_2d_tpu_torch.graph import solver
    seen, real = [], solver.solve
    before = graph.poses.copy()

    def capture(config, **kw):
        seen.append({k: v.clone() if hasattr(v, "clone") else v
                     for k, v in kw.items()})
        return real(config, **kw)
    solver.solve = capture
    try:
        solver.solve_graph(graph, scfg, device=dev)
    finally:
        solver.solve = real
        graph.set_poses(before)
    kw = seen[0]
    return {k: kw[k] for k in ("poses", "begin", "end", "transform",
                               "information", "constraint_mask",
                               "node_mask", "robust_mask")}


def bits(t):
    """A float32 tensor's bits as int32 (NaN and -0 compare exactly)."""
    import torch
    return t.contiguous().view(torch.int32)


def same_bits(a, b) -> bool:
    import torch
    if a.dtype == torch.float32:
        return torch.equal(bits(a), bits(b))
    return torch.equal(a, b)


def lm_inputs(kw, scfg, lam: float):
    """K4's dense-path inputs of one LM step at ``kw``'s poses: the
    constraint terms, the pair table, Bab, g, D, lam, fm, and the step
    (delta, info) from the library's Cholesky."""
    import torch

    from ndt_2d_tpu_torch.kernels import normal_blocks as k4
    poses, begin, end = kw["poses"], kw["begin"], kw["end"]
    n, dev = poses.shape[0], poses.device
    cmask, rmask = kw["constraint_mask"], kw["robust_mask"]
    terms = (begin, end, kw["transform"], kw["information"], cmask, rmask,
             scfg.robust_loss, scfg.huber_delta)
    fm = (kw["node_mask"] & (torch.arange(n, device=dev) != 0)).float()
    inc = k4.incidence(begin, end, cmask, n)
    pairs = k4.pair_table(begin, end, cmask, n)
    _, bab, _, _, _, g, diag = k4.normal_blocks(
        poses, *terms[:6], scfg.robust_loss, scfg.huber_delta, inc)
    lam_t = torch.full((), lam, dtype=torch.float32, device=dev)
    hm, rhs = k4.dense_system(pairs, bab, g, diag, lam_t, fm)
    chol, info = torch.linalg.cholesky_ex(hm)
    delta = torch.cholesky_solve(rhs.reshape(-1, 1), chol).reshape(n, 3)
    return terms, (pairs, bab, g, diag, lam_t, fm), delta, info


def fused_inputs(poses, terms, sys_args) -> tuple:
    """``dense_normal_system``'s arguments at ``poses`` from
    ``lm_inputs``' terms and system arguments (the incidence lists made
    here)."""
    from ndt_2d_tpu_torch.kernels import normal_blocks as k4
    pairs, _, _, _, lam, fm = sys_args
    inc = k4.incidence(terms[0], terms[1], terms[4], fm.shape[0])
    return (poses, *terms, inc, pairs, lam, fm)


def fused_cost(fused) -> tuple:
    """(bytes, operations) of ``dense_normal_system`` on ``fused``: hm and
    rhs written once and every input read once; a constraint's terms
    (~300 operations) and its two pair-slot adds (18), and each diagonal
    block's damping and mask (~6 a float)."""
    poses, begin, end, transform, information, cmask, rmask = fused[:7]
    inc, pairs, lam, fm = fused[9:]
    N, C = fm.shape[0], begin.shape[0]
    moved = (9 * N * N + 3 * N) * 4 + nbytes(
        poses, begin, end, transform, information, cmask, rmask, inc.b_ptr,
        inc.b_idx, inc.e_ptr, inc.e_idx, pairs.keys, pairs.src,
        pairs.row_ptr, lam, fm)
    return moved, 318 * C + 54 * N


class LmVariant:
    """Forces the LM step's launch shape inside a ``with``: the one-block
    variant (``one_block``; its launch refuses more than 12287
    constraints) or the cooperative grid, through the choice ``lm_blocks``
    reads (``k4.lm_one_block``)."""

    def __init__(self, one_block: bool):
        self.one_block = one_block

    def __enter__(self):
        from ndt_2d_tpu_torch.kernels import normal_blocks as k4
        self.real = k4.lm_one_block
        k4.lm_one_block = lambda C: self.one_block
        return self

    def __exit__(self, *exc):
        from ndt_2d_tpu_torch.kernels import normal_blocks as k4
        k4.lm_one_block = self.real


def check_lm_kernels(name, kw, scfg) -> str:
    """``dense_normal_system`` bitwise against its twin and against the
    three launches it replaces (``normal_blocks``, then ``dense_system``)
    at ``kw``, and ``dense_system`` and ``lm_step`` (with its cost mode)
    bitwise against their twins: the systems at lam 1e-12, 1e-6 and 1e8
    (hm with its -0 entries, and rhs); the step accepted, rejected (a step
    100x too long), with a NaN step (info != 0) and through the mesh's
    two launches (cost mode, an identity combine, update mode), every
    state field, each through the one-block launch and the cooperative
    grid (``LmVariant``); the mesh's update launch through one block
    ``MESH_REPEATS`` times more, the same bits every time (its threads
    read the state before thread 0 writes it)."""
    import torch

    from ndt_2d_tpu_torch.kernels import normal_blocks as k4
    terms, sys_args, delta, info = lm_inputs(kw, scfg, 1e-6)
    negz = 0
    for lam in (1e-12, 1e-6, 1e8):
        a = list(sys_args)
        a[4] = torch.full((), lam, dtype=torch.float32,
                          device=delta.device)
        hm, rhs = k4.dense_system(*a)
        hmt, rhst = k4.dense_system_twin(*a)
        require(same_bits(hm, hmt) and same_bits(rhs, rhst),
                f"{name}: dense_system at lam {lam} differs from its twin "
                f"({int((bits(hm) != bits(hmt)).sum())} entries)")
        fused = fused_inputs(kw["poses"], terms, a)
        hf, rf = k4.dense_normal_system(*fused)
        hft, rft = k4.dense_normal_system_twin(*fused)
        require(same_bits(hf, hft) and same_bits(rf, rft),
                f"{name}: dense_normal_system at lam {lam} differs from its "
                f"twin ({int((bits(hf) != bits(hft)).sum())} entries)")
        require(same_bits(hf, hm) and same_bits(rf, rhs),
                f"{name}: dense_normal_system at lam {lam} differs from "
                f"normal_blocks + dense_system "
                f"({int((bits(hf) != bits(hm)).sum())} entries)")
        again = k4.dense_normal_system(*fused)
        require(same_bits(again[0], hf) and same_bits(again[1], rf),
                f"{name}: dense_normal_system not bitwise reproducible")
        negz = int((bits(hm) == -2 ** 31).sum())
    poses = kw["poses"]
    c0t = k4.robust_cost_twin(poses, None, None, *terms)
    variants = ("one block", "grid")
    for v in variants:
        with LmVariant(v == "one block"):
            c0 = k4.robust_cost(poses, None, None, *terms)
        require(same_bits(c0, c0t),
                f"{name}: the cost ({v}) differs from its twin")
    steps = {"accepted": (delta, info), "rejected": (delta * 100.0, info),
             "NaN step": (delta, torch.ones_like(info)),
             "mesh launches": (delta, info)}
    flags = {}
    for what, (d, inf) in steps.items():
        combine = (lambda x: x) if what == "mesh launches" else None
        st = k4.lm_state(poses, 1e-6, c0, terms[0].shape[0])
        k4.lm_step_twin(st, d, inf, *terms, 0.5, 10.0, 1e-9, combine)
        for v in variants:
            sk = k4.lm_state(poses, 1e-6, c0, terms[0].shape[0])
            with LmVariant(v == "one block"):
                k4.lm_step(sk, d, inf, *terms, 0.5, 10.0, 1e-9, combine)
            for f in ("poses", "lam", "cost", "stall", "flags"):
                require(same_bits(getattr(sk, f), getattr(st, f)),
                        f"{name}: lm_step ({what}, {v}) {f} differs from "
                        f"its twin")
        flags[what] = tuple(bool(x) for x in sk.flags)
    for _ in range(MESH_REPEATS):
        sk = k4.lm_state(poses, 1e-6, c0, terms[0].shape[0])
        with LmVariant(True):
            k4.lm_step(sk, delta, info, *terms, 0.5, 10.0, 1e-9,
                       lambda x: x)
        for f in ("poses", "lam", "cost", "stall", "flags"):
            require(same_bits(getattr(sk, f), getattr(st, f)),
                    f"{name}: lm_step (mesh launches, one block, repeated) "
                    f"{f} differs from its twin")
    require(flags["accepted"][0] and not flags["rejected"][0]
            and not flags["NaN step"][0],
            f"{name}: accept flags {flags}")
    C, N = terms[0].shape[0], poses.shape[0]
    fits = k4.lm_card(poses.device.index)
    shape = k4.lm_blocks(C, N, fits)
    return (f"dense_normal_system bitwise its twin and normal_blocks + "
            f"dense_system, dense_system bitwise its twin, at lam 1e-12 / "
            f"1e-6 / 1e8 ({negz} -0 entries at 1e8), lm_step bitwise on "
            f"every field (accept, reject, NaN step, mesh launches: cost, "
            f"update, the one-block update {MESH_REPEATS} times more) "
            f"through one block and through a cooperative grid of "
            f"{k4.lm_plan(C, N, fits)} blocks "
            f"(the solve's launch: "
            f"{'one block' if shape == 0 else f'{shape} blocks'}), cost "
            f"{float(c0):.6g}")


def unplanned_solve(kw, scfg):
    """One device's dense solve as the LM loop ran it before the plan: the
    public wrappers (``dense_normal_system``, the library's solve with no
    out buffers, ``lm_step``) called afresh every iteration, at ``solve``'s
    inputs.  Returns (poses, cost, success, iterations) as ``solve``
    would."""
    import torch

    from ndt_2d_tpu_torch.graph import solver
    from ndt_2d_tpu_torch.kernels import normal_blocks as k4
    poses = kw["poses"].contiguous()
    n, dev = poses.shape[0], poses.device
    terms = (torch.clamp(kw["begin"].to(torch.int32), 0, n - 1),
             torch.clamp(kw["end"].to(torch.int32), 0, n - 1),
             kw["transform"].contiguous(), kw["information"].contiguous(),
             kw["constraint_mask"].contiguous(),
             kw["robust_mask"].contiguous(), scfg.robust_loss,
             scfg.huber_delta)
    fm = (kw["node_mask"] & (torch.arange(n, device=dev) != 0)).to(
        poses.dtype)
    inc = k4.incidence(terms[0], terms[1], terms[4], n)
    pairs = k4.pair_table(terms[0], terms[1], terms[4], n)
    with solver._highest_precision():
        cost0 = k4.robust_cost(poses, None, None, *terms)
        state = k4.lm_state(poses, scfg.lm_lambda_init, cost0,
                            terms[0].shape[0])
        it = 0
        while it < scfg.max_iterations and int(state.stall) < 3:
            delta, info = solver._dense_solve(n, *k4.dense_normal_system(
                state.poses, *terms, inc, pairs, state.lam, fm))
            k4.lm_step(state, delta, info, *terms, scfg.lm_lambda_down,
                       scfg.lm_lambda_up, scfg.tolerance)
            it += 1
    ok = torch.isfinite(state.cost) & (state.cost <= cost0)
    return (torch.where(ok, state.poses, poses), state.cost, bool(ok), it)


def solve_both(kw, scfg):
    """One solve on the kernels (planned; launches counted), one on the
    kernels without the plan (``unplanned_solve``: the public wrappers, as
    before the plan) and one on the twins: (planned result, twin result,
    launches, planned wall s, twin wall s, unplanned (poses, cost,
    success, iterations))."""
    import torch

    from ndt_2d_tpu_torch.graph import solver
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = solver.solve(scfg, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    unplanned = unplanned_solve(kw, scfg)
    t0 = time.perf_counter()
    twin = solver.solve(scfg, **kw, twin=True)
    torch.cuda.synchronize()
    return res, twin, launches, wall, time.perf_counter() - t0, unplanned


def solve_profile(kw, scfg, profiles: int = 3) -> dict:
    """The CUDA kernels and copies of one kernel-path solve, from
    torch.profiler: kernel name -> count, and the host->device and
    device->host copies.  The profiler can drop device activity records
    and never adds one (on the H100 machine one solve's device->host
    copies read 11, 8 and 10 in successive profiles of one process), so
    the solve is profiled ``profiles`` times and the profile with the most
    device events is kept."""
    import torch

    from ndt_2d_tpu_torch.graph import solver
    from torch.profiler import ProfilerActivity, profile
    solver.solve(scfg, **kw)
    torch.cuda.synchronize()
    best = None
    for _ in range(profiles):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = solver.solve(scfg, **kw)
            torch.cuda.synchronize()
        kernels, htod, dtoh = {}, 0, 0
        htod_ops = sorted({ev.name for ev in prof.events()
                           if any("HtoD" in k.name for k in ev.kernels)})
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if "HtoD" in ev.name:
                htod += 1
            elif "DtoH" in ev.name:
                dtoh += 1
            elif "Memcpy" not in ev.name and "Memset" not in ev.name:
                kernels[ev.name] = kernels.get(ev.name, 0) + 1
        out = dict(iterations=int(res.iterations), kernels=kernels,
                   htod=htod, dtoh=dtoh, htod_ops=htod_ops)
        events = htod + dtoh + sum(kernels.values())
        if best is None or events > best[0]:
            best = (events, out)
    return best[1]


def phase_lm(dev, office, ident) -> dict:
    """K4's dense LM step on the card: ``dense_normal_system`` bitwise
    against its twin and the three launches it replaces, ``dense_system``
    and ``lm_step`` bitwise against their twins (``check_lm_kernels``), on
    the office recipe's final graph (N_pad 512; its poses moved off the
    optimum), a synthetic 1024-node graph with duplicate, reversed and
    self-loop constraints and a hub graph (600 spokes on one node); a
    whole solve of each on the kernels and on the twins (poses bitwise,
    the same iterations; launches: dense_normal_system = iterations,
    normal_blocks = dense_system = 0, lm_step = iterations + 1); profiled
    solves of the office graph, cut at 6 and at 2 iterations, whose
    difference is an LM iteration's kernels and copies (one K4 kernel
    before cuSOLVER's, none host->device, one read); the kernels' times at
    the office graph; the wall of an LM iteration, kernels against
    twins."""
    import dataclasses

    import torch

    from ndt_2d_tpu_torch.config import SolverConfig
    from ndt_2d_tpu_torch.graph import solver
    from ndt_2d_tpu_torch.kernels import normal_blocks as k4
    ocfg = office["solver"]
    okw = graph_inputs(office["graph"], ocfg, dev)
    # The final graph sits at its optimum, where a step is rejected: the
    # checks start from its poses moved off it (the free nodes by 5 cm /
    # 0.05 rad, seeded).
    n = okw["poses"].shape[0]
    free = okw["node_mask"].cpu() & (torch.arange(n) != 0)
    noise = torch.randn(n, 3, generator=torch.Generator().manual_seed(0))
    okw["poses"] = okw["poses"] + (0.05 * noise * free[:, None]).to(dev)
    skw = {k: torch.from_numpy(v).to(dev)
           for k, v in lm_graph(1000, 1024, 300, 0).items()}
    hkw = {k: torch.from_numpy(v).to(dev)
           for k, v in lm_graph(1000, 1024, 300, 2, hub=600).items()}
    cases = (("office recipe's final graph", okw, ocfg),
             ("synthetic 1024-node graph", skw,
              SolverConfig(robust_loss="geman_mcclure")),
             ("synthetic 1024-node graph, Huber", skw,
              SolverConfig(robust_loss="huber", huber_delta=1.0)),
             ("hub graph (600 spokes on node 500)", hkw,
              SolverConfig(robust_loss="huber", huber_delta=1.0)))
    for name, kw, scfg in cases:
        msg = check_lm_kernels(name, kw, scfg)
        res, twin, launches, wall, twin_wall, unplanned = solve_both(kw,
                                                                     scfg)
        it = int(res.iterations)
        twin = (twin.poses, twin.cost, bool(twin.success),
                int(twin.iterations))
        for other, what in ((twin, "twins'"), (unplanned, "unplanned")):
            require(it == other[3] and same_bits(res.poses, other[0])
                    and same_bits(res.cost, other[1])
                    and bool(res.success) == other[2],
                    f"{name}: the planned solve parts from the {what} "
                    f"({it} vs {other[3]} iterations)")
        require(launches["dense_normal_system"] == it
                and launches["normal_blocks"] == launches["dense_system"] == 0
                and launches["lm_step"] == it + 1,
                f"{name}: launches {launches} over {it} iterations")
        n_live = int(kw["node_mask"].sum())
        c_live = int(kw["constraint_mask"].sum())
        print(f"[4u] {name} ({n_live} nodes of "
              f"{kw['poses'].shape[0]}, {c_live} live constraints of "
              f"{kw['begin'].shape[0]}, {scfg.robust_loss}): {msg}; "
              f"the planned solve bitwise the unplanned kernels' and the "
              f"twins' ({it} iterations, "
              f"success {bool(res.success)}; {wall * 1e3:.3f} ms against "
              f"{twin_wall * 1e3:.3f} ms on the twins); launches "
              f"dense_normal_system {launches['dense_normal_system']}, "
              f"normal_blocks {launches['normal_blocks']}, dense_system "
              f"{launches['dense_system']}, lm_step {launches['lm_step']}")
    # An LM iteration's kernels and copies: the difference between solves
    # cut at 6 and at 2 iterations (each reads the stall count once an
    # iteration; one that stops on the stall count reads it once more).
    prof = solve_profile(okw, ocfg)
    cuts = [solve_profile(okw, dataclasses.replace(ocfg, max_iterations=k))
            for k in (2, 6)]
    it = prof["iterations"]
    require(it > 6, f"[4u] the office graph solved in {it} iterations")
    di = cuts[1]["iterations"] - cuts[0]["iterations"]
    require(di == 4 and cuts[1]["htod"] == cuts[0]["htod"]
            and cuts[1]["dtoh"] - cuts[0]["dtoh"] == di,
            f"[4u] copies: {cuts[1]['htod']} / {cuts[0]['htod']} "
            f"host->device, {cuts[1]['dtoh']} / {cuts[0]['dtoh']} "
            f"device->host over {cuts[1]['iterations']} / "
            f"{cuts[0]['iterations']} iterations")
    per_it = {k: (v - cuts[0]["kernels"].get(k, 0)) / di
              for k, v in cuts[1]["kernels"].items()
              if v != cuts[0]["kernels"].get(k, 0)}
    fused_it = sum(v for k, v in per_it.items()
                   if "dense_normal_system" in k)
    parts = [k for k in per_it if "constraint_blocks" in k
             or "node_sums" in k
             or ("dense_system" in k and "dense_normal_system" not in k)]
    require(fused_it == 1 and not parts,
            f"[4u] an LM iteration's kernels: {per_it}")
    print(f"[4u] profiled solves of the office graph, cut at 6 and at 2 "
          f"iterations: an LM iteration launches one K4 kernel before "
          f"cuSOLVER's (dense_normal_system), copies host->device 0 times "
          f"and device->host once; its CUDA kernels (launches an iteration) "
          f"{per_it}; a whole solve ({it} iterations) {prof['htod']} "
          f"host->device copies (by {prof['htod_ops']}), {prof['dtoh']} "
          f"device->host ({ident})")
    # Times at the office graph.
    terms, sys_args, delta, info = lm_inputs(okw, ocfg, 1e-6)
    pairs, bab, g, diag, lam_t, fm = sys_args
    N, C = fm.shape[0], terms[0].shape[0]
    c0 = k4.robust_cost(okw["poses"], None, None, *terms)
    sk = k4.lm_state(okw["poses"], 1e-6, c0, C)
    st = k4.lm_state(okw["poses"], 1e-6, c0, C)
    step = (delta, info, *terms, 0.5, 10.0, 1e-9)
    hm, rhs = k4.dense_system(*sys_args)
    hmt, rhst = k4.dense_system_twin(*sys_args)
    fused = fused_inputs(okw["poses"], terms, sys_args)
    hf, rf = k4.dense_normal_system(*fused)
    hft, rft = k4.dense_normal_system_twin(*fused)
    k4.lm_step(sk, *step)
    k4.lm_step_twin(st, *step)
    errs = {"dense_system": max_abs_diff([(hm, hmt), (rhs, rhst)]),
            "dense_normal_system": max_abs_diff([(hf, hft), (rf, rft)]),
            "lm_step": max_abs_diff([(sk.poses, st.poses), (sk.cost, st.cost),
                                     (sk.lam, st.lam)])}
    # Bytes: the system written once (hm and rhs) and its inputs read once;
    # the step's poses, delta and constraint terms read once and the poses
    # written once.
    fused_moved, fused_ops = fused_cost(fused)
    moved = {"dense_system": (9 * N * N + 3 * N) * 4 + nbytes(
                 bab, g, diag, fm, pairs.keys, pairs.src, pairs.row_ptr),
             "dense_normal_system": fused_moved,
             "lm_step": nbytes(okw["poses"], delta, *terms[:6]) + 12 * N}
    ops = {"dense_system": 2 * 9 * N * N, "dense_normal_system": fused_ops,
           "lm_step": 80 * C}
    calls = {"dense_system": (lambda: k4.dense_system(*sys_args),
                              lambda: k4.dense_system_twin(*sys_args)),
             "dense_normal_system": (
                 lambda: k4.dense_normal_system(*fused),
                 lambda: k4.dense_normal_system_twin(*fused)),
             "lm_step": (lambda: k4.lm_step(sk, *step),
                         lambda: k4.lm_step_twin(st, *step))}
    out = {}
    for k, (fn, twin_fn) in calls.items():
        out[k] = timed(errs[k], cuda_ms(fn, 50), cuda_ms(twin_fn, 5),
                       moved[k], ops[k])
        print(f"[5] {k} at the office graph (N_pad {N}, C_pad {C}): "
              f"cuda_ms {out[k]['ms']:.5f}, in a CUDA graph "
              f"{graph_ms(fn, 20):.5f} ms, host "
              f"{host_us(fn, 101, sync=True):.1f} us a call, twin "
              f"{out[k]['plain_ms']:.4f} ms, bound {out[k]['bound_ms']:.6f} "
              f"ms ({out[k]['bound_by']}) ({ident})")
    lm_variant_times(lambda: k4.lm_step(sk, *step), f"office graph (N_pad "
                     f"{N}, C_pad {C})", ident)
    planned_times(okw, ocfg, f"office graph (N_pad {N}, C_pad {C})", ident,
                  (lambda: k4.dense_normal_system(*fused),
                   lambda: k4.lm_step(sk, *step)))
    walls = {"kernels": [], "twins": []}
    for arm in ("kernels", "twins", "kernels", "twins"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver.solve(ocfg, **okw, twin=arm == "twins")
        torch.cuda.synchronize()
        walls[arm].append((time.perf_counter() - t0) * 1e3
                          / int(res.iterations))
    print(f"[5] LM iteration wall on the office graph (N_pad {N}, "
          f"{int(res.iterations)} iterations a solve): kernels "
          f"{[round(w, 4) for w in walls['kernels']]} ms, twins "
          f"{[round(w, 4) for w in walls['twins']]} ms ({ident})")
    return out


def lm_variant_times(step, what, ident, both=None) -> None:
    """``step`` (an ``lm_step`` call) through the one-block launch and the
    cooperative grid (``LmVariant``): CUDA events, in a CUDA graph and host
    time a call, through ``both`` where given (keyed by ``what``), else
    printed as [5] lines."""
    for v in ("one block", "grid"):
        with LmVariant(v == "one block"):
            if both is not None:
                both(f"K4 lm_step {what}, {v}", step, 50)
                continue
            print(f"[5] lm_step at the {what}, {v}: cuda_ms "
                  f"{cuda_ms(step, 50):.5f}, in a CUDA graph "
                  f"{graph_ms(step, 20):.5f} ms, host "
                  f"{host_us(step, 101, sync=True):.1f} us a call ({ident})")


def dense_plan(kw, scfg):
    """A ``k4.DensePlan`` at ``kw``'s poses as ``solve`` builds it (lam
    1e-6), its step solved once so ``delta`` holds a step."""
    import torch

    from ndt_2d_tpu_torch.graph import solver
    from ndt_2d_tpu_torch.kernels import normal_blocks as k4
    terms, sys_args, _, _ = lm_inputs(kw, scfg, 1e-6)
    pairs, _, _, _, _, fm = sys_args
    n = fm.shape[0]
    inc = k4.incidence(terms[0], terms[1], terms[4], n)
    c0 = k4.robust_cost(kw["poses"], None, None, *terms)
    state = k4.lm_state(kw["poses"], 1e-6, c0, terms[0].shape[0])
    plan = k4.DensePlan(state, *terms, inc, pairs, fm, 0.5, 10.0, 1e-9)
    solver._dense_solve(n, *plan.system(), plan.solve_out)
    torch.cuda.synchronize()
    return plan


def planned_times(kw, scfg, what, ident, unplanned=None, both=None):
    """The host time a call of a plan's two launches (``dense_plan``),
    beside the unplanned wrappers' (``unplanned``: their two calls) in the
    same process; through ``both`` where given, else printed."""
    plan = dense_plan(kw, scfg)
    if both is not None:
        both(f"K4 dense_normal_system planned, {what}", plan.system, 50)
        both(f"K4 lm_step planned, {what}", plan.step, 50)
        return
    us = [host_us(plan.system, 101, sync=True),
          host_us(plan.step, 101, sync=True)]
    old = [host_us(fn, 101, sync=True) for fn in unplanned]
    print(f"[4u] planned launches at the {what}: dense_normal_system host "
          f"{us[0]:.1f} us a call (unplanned {old[0]:.1f}), in a CUDA graph "
          f"{graph_ms(plan.system, 20):.5f} ms; lm_step host {us[1]:.1f} us "
          f"a call (unplanned {old[1]:.1f}), in a CUDA graph "
          f"{graph_ms(plan.step, 20):.5f} ms ({ident})")


def lm_times(dev, ident, both=None) -> dict:
    """K4's dense LM step on synthetic graphs at N_pad 512 and 1024
    (``lm_graph``, Geman-McClure): ``normal_blocks``, ``dense_system``,
    ``dense_normal_system`` (with its bound) and ``lm_step`` through
    ``both`` where this tree has them, and the wall of an LM iteration (a
    whole ``solve``'s wall over its iterations, kernels and twins in turn,
    twice each).  The walls call only ``solve``, so in an older checkout
    they time that checkout's LM loop."""
    import torch

    from ndt_2d_tpu_torch.config import SolverConfig
    from ndt_2d_tpu_torch.graph import solver
    from ndt_2d_tpu_torch.kernels import normal_blocks as k4
    scfg = SolverConfig(robust_loss="geman_mcclure")
    out = {}
    for nodes, n_pad, closures in ((287, 512, 150), (1000, 1024, 300)):
        kw = {k: torch.from_numpy(v).to(dev)
              for k, v in lm_graph(nodes, n_pad, closures, 1).items()}
        if both is not None and hasattr(k4, "dense_system"):
            terms, sys_args, delta, info = lm_inputs(kw, scfg, 1e-6)
            c0 = k4.robust_cost(kw["poses"], None, None, *terms)
            sk = k4.lm_state(kw["poses"], 1e-6, c0, terms[0].shape[0])
            inc = k4.incidence(terms[0], terms[1], terms[4], n_pad)
            both(f"K4 normal_blocks N_pad {n_pad}",
                 lambda a=(kw["poses"], *terms, inc): k4.normal_blocks(*a),
                 50)
            both(f"K4 dense_system N_pad {n_pad}",
                 lambda a=sys_args: k4.dense_system(*a), 50)
            if hasattr(k4, "dense_normal_system"):
                fused = fused_inputs(kw["poses"], terms, sys_args)
                both(f"K4 dense_normal_system N_pad {n_pad}",
                     lambda a=fused: k4.dense_normal_system(*a), 50)
                moved, ops = fused_cost(fused)
                bound = max(moved / PEAK_BYTES_PER_S,
                            ops / PEAK_F32_OPS_PER_S) * 1e3
                out[f"dense_normal_system bound N_pad {n_pad}"] = bound
                print(f"[5] K4 dense_normal_system N_pad {n_pad}: bound "
                      f"{bound:.6f} ms ({moved} bytes, {ops} operations) "
                      f"({ident})")
            both(f"K4 lm_step N_pad {n_pad}",
                 lambda s=sk, d=delta, i=info, t=terms: k4.lm_step(
                     s, d, i, *t, 0.5, 10.0, 1e-9), 50)
            if hasattr(k4, "lm_one_block"):  # two LM-step launches
                lm_variant_times(
                    lambda s=sk, d=delta, i=info, t=terms: k4.lm_step(
                        s, d, i, *t, 0.5, 10.0, 1e-9), f"N_pad {n_pad}",
                    ident, both)
            if hasattr(k4, "DensePlan"):  # a tree that plans a solve
                planned_times(kw, scfg, f"N_pad {n_pad}", ident, both=both)
            hm, rhs = k4.dense_system(*sys_args)

            def factor(hm=hm, rhs=rhs):
                chol, _ = torch.linalg.cholesky_ex(hm)
                return torch.cholesky_solve(rhs.reshape(-1, 1), chol)
            # The library's Cholesky of M = 3 N: M^3 / 3 float32 operations.
            m = 3 * n_pad
            ms = cuda_ms(factor, 20)
            out[f"cuSOLVER N_pad {n_pad}"] = ms
            print(f"[5] cuSOLVER cholesky_ex + cholesky_solve, N_pad {n_pad} "
                  f"({m} x {m}): {ms:.4f} ms a call, bound "
                  f"{m ** 3 / 3 / PEAK_F32_OPS_PER_S * 1e3:.4f} ms "
                  f"(operations) ({ident})")
        walls = {"kernels": [], "twins": []}
        solver.solve(scfg, **kw)
        for arm in ("kernels", "twins", "kernels", "twins"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solver.solve(scfg, **kw, twin=arm == "twins")
            torch.cuda.synchronize()
            walls[arm].append((time.perf_counter() - t0) * 1e3
                              / int(res.iterations))
        out[f"LM iteration wall N_pad {n_pad}"] = walls
        print(f"[5] LM iteration wall, synthetic graph N_pad {n_pad} "
              f"({int(res.iterations)} iterations a solve): kernels "
              f"{[round(w, 4) for w in walls['kernels']]} ms, twins "
              f"{[round(w, 4) for w in walls['twins']]} ms ({ident})")
    return out


def optimize_times(dev, ident, runs: int = 3) -> dict:
    """The mapper's ``optimize`` timer (mean ms a solve, solves) of the
    ``office`` recipe on config 3's bag, config 9 and the ``drift`` recipe,
    ``runs`` runs of each in turn in one process (the first run of the
    office recipe holds the process's first dense solve), then
    ``lm_times``' LM iteration walls.  Calls only ``run_session`` and
    ``solve``, so ``--optimize-times`` in an older checkout times that
    checkout."""
    import numpy as np

    from ndt_2d_tpu_torch.io import carmen
    bag9 = carmen.load_carmen(os.path.join(ROOT, "datasets",
                                           "simlab.clf.gz"), range_max=10.0)
    sessions = {"office recipe": (office_recipe_config(), office_bag()),
                "config 9": (config9(), bag9),
                "drift": (office_config("--recipe", "drift"), drift_bag())}
    out = {k: [] for k in sessions}
    for _ in range(runs):
        for name, (cfg, bag) in sessions.items():
            mapper = run_session(cfg, bag, dev)[-1]
            t = mapper.stats.timer.summary()["optimize"]
            out[name].append((t["mean_ms"], t["count"]))
    for name, runs_ in out.items():
        ms = [m for m, _ in runs_]
        print(f"[6] {name}: optimize mean ms of {len(ms)} runs "
              f"{[round(m, 4) for m in ms]} (solves "
              f"{[c for _, c in runs_]}), median {float(np.median(ms)):.4f}"
              f", spread {max(ms) - min(ms):.4f} ({ident})")
    out.update(lm_times(dev, ident))
    return out


def config4_configs():
    """BASELINE config 4 as benchmarks/run_benchmarks.py:378-426 sets it up:
    the mapping config and the particle-filter config."""
    import dataclasses

    from ndt_2d_tpu_torch.config import (
        MapperConfig, ParticleFilterConfig, ScanMatcherConfig)
    m = ScanMatcherConfig(grid_cells_x=192, grid_cells_y=192)
    base = MapperConfig(local_scan_matcher=m, global_scan_matcher=m,
                        max_points_per_scan=512)
    pf = dataclasses.replace(
        ParticleFilterConfig(), min_particles=max(100, PARTICLES // 10),
        max_particles=PARTICLES, odom_alpha1=0.05, odom_alpha2=0.05,
        odom_alpha3=0.05, odom_alpha4=0.05)
    return (dataclasses.replace(base, loop_closure_every=10**9),
            dataclasses.replace(base, use_particle_filter=True,
                                particle_filter=pf))


def map_and_save(cfg, scans, path, dev):
    """Map ``scans`` [(msg, odom pose)] with the port and save the graph;
    returns the number of keyframes."""
    from ndt_2d_tpu_torch.mapping.mapper import SAVE_TO_FILE, Mapper
    mapper = Mapper(cfg, device=dev)
    for msg, odom in scans:
        mapper.process_scan(msg, odom)
    mapper.configure(SAVE_TO_FILE, path)
    return mapper.graph.num_scans


def localizer(cfg, path, dev, seed):
    from ndt_2d_tpu_torch.mapping.mapper import LOAD_FROM_FILE, Mapper
    loc = Mapper(cfg, seed=seed, device=dev)
    loc.configure(LOAD_FROM_FILE, path)
    return loc


def pf_setup(path, bag4, dev):
    """Config 4's localizer on the saved map ``path`` (its global matcher
    and particle filter config) and bag4's scan 40 with its truth."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.mapping import laser
    from ndt_2d_tpu_torch.utils import metrics
    _, cfg = config4_configs()
    loc = localizer(cfg, path, dev, 3)
    loc._ensure_matchers(bag4.range_max)
    t = 40
    rel = metrics.relative_to_first(bag4.truth)
    pts, msk = laser.project_scan(bag4[t][0], bag4.range_max, np.zeros(3),
                                  False, None, cfg.max_points_per_scan)
    scan = (torch.tensor(pts, device=dev), torch.tensor(msk, device=dev),
            int(msk.sum()))
    center = torch.tensor(rel[t], dtype=torch.float32, device=dev)
    return loc.global_matcher, cfg.particle_filter, scan, center


def phase_pf_kernels(path, bag4, dev):
    """K3 over poses and K9 against their twins on the config-4 grid (the
    loaded box map's global NDT) with the same scores and draws, at the
    particle counts of config 4 and config 7; times at both."""
    m, pcfg, scan, center = pf_setup(path, bag4, dev)
    out = {}
    for M, suffix in ((PARTICLES, ""),
                      (GLOBAL_PARTICLES, f"_{GLOBAL_PARTICLES}")):
        times = pf_kernels_at(m, pcfg, scan, center, M, dev)
        out.update({k + suffix: v for k, v in times.items()})
    pf_fitted_plans(m, pcfg, scan, center, dev)
    return out


def pf_fitted_plans(m, pcfg, scan, center, dev):
    """K9 at particle counts past the filter's, where the chain's first
    plan may not fit on the card at once: 40,000 (its staged CDF leaves
    one block an SM), 200,000 (1024 blocks of one chunk) and 1,000,000
    (its items no longer fit in shared memory): the resample (plain and
    with recovery), the EWMAs and the statistics bitwise against their
    twins on ``pf_case``'s scores and draws."""
    import torch

    from ndt_2d_tpu_torch.kernels import particle_filter as k9
    said = []
    t0 = time.perf_counter()
    for M in (40_000, 200_000, 1_000_000):
        c = pf_case(m, pcfg, scan, center, M, dev)
        fits = k9.fits_on(dev)
        first, pl = k9.plan(M), k9.plan(M, fits)
        require(pl.blocks <= fits(pl.smem), f"K9 plan {tuple(pl)} for {M} "
                f"particles has more blocks than the card holds at once")
        for name, r in (("plain", None), ("recovery", c.rec)):
            a, b = k9.resample(*c.args, r), k9.resample_twin(*c.args, r)
            torch.cuda.synchronize()
            for f in a._fields:
                if getattr(a, f) is not None:
                    require(torch.equal(getattr(a, f), getattr(b, f)),
                            f"K9 resample ({name}, {M}): {f} differs from "
                            "its twin")
        ew = k9.ewma(c.sc, c.n_in, c.w0, 0.001, 0.1)
        require(torch.equal(ew, k9.ewma_twin(c.sc, c.n_in, c.w0, 0.001,
                                             0.1)),
                f"K9 ewma ({M}) differs from its twin")
        st = k9.statistics(c.pm, c.sc, c.n_in)
        stt = k9.statistics_twin(c.pm, c.sc, c.n_in)
        require(all(torch.equal(getattr(st, f), getattr(stt, f))
                    for f in ("particles", "weights", "normalized", "n",
                              "stats")),
                f"K9 statistics ({M}) differ from the twin")
        said.append(f"{M}: n_active {int(a.n[0])}, plan {tuple(pl)} (first "
                    f"{tuple(first)}, {first.blocks} blocks of the "
                    f"{fits(first.smem)} the card holds at once)")
        del c, a, b
    torch.cuda.synchronize()
    print("[3] K9 past the filter's counts: resample (plain, recovery), "
          "EWMAs and statistics bitwise equal to their twins at "
          + "; ".join(said) + f" ({time.perf_counter() - t0:.1f} s)")


def pf_case(m, pcfg, scan, center, M, dev):
    """K3's and K9's inputs at M particles around ``center`` (generator
    seed 11): K3's arguments ``sa`` and its scores ``sc`` (the kernel's),
    the motion draws and scalars, the moved particles ``pm`` (K9's
    motion), the resample's arguments ``args`` and its recovery ``rec``
    (the injection over 30,000 free cells, EWMAs from ``w0``)."""
    import types

    import torch

    from ndt_2d_tpu_torch.filter import motion_model
    from ndt_2d_tpu_torch.filter import particle_filter as pf_mod
    from ndt_2d_tpu_torch.kernels import particle_filter as k9
    from ndt_2d_tpu_torch.kernels import score_points as k3
    W, H = m.config.grid_cells_x, m.config.grid_cells_y
    B = m.config.laser_max_beams
    q, qm, n = scan
    gen = torch.Generator(device=dev).manual_seed(11)
    poses = (center + torch.randn(M, 3, generator=gen, device=dev)
             * torch.tensor([0.2, 0.2, 0.05], device=dev)).contiguous()
    sa = (m.grid, W, H, B, q, qm, n, poses)
    sc = k3.score_batch(*sa)
    free = torch.rand(30000, 2, generator=gen, device=dev) * 8.0
    draws = pf_mod.draw_step(gen, M, dev, free.shape[0])
    scal = motion_model.motion_scalars(0.05, 0.002, 0.03, 0.05, 0.05, 0.05,
                                       0.05)
    pm = k9.motion(poses, draws.motion, scal)
    bins = (pcfg.kld_bin_x, pcfg.kld_bin_y, pcfg.kld_bin_theta)
    n_in = torch.tensor([M], dtype=torch.int32, device=dev)
    inj = k9.Injection(free, 0.05, draws.inject_sel, draws.inject_idx,
                       draws.inject_jitter, draws.inject_theta)
    w0 = torch.tensor([0.9, 0.5], device=dev)
    return types.SimpleNamespace(
        poses=poses, sa=sa, sc=sc, free=free, draws=draws, scal=scal, pm=pm,
        n_in=n_in, w0=w0, rec=k9.Recovery(w0, 0.001, 0.1, True, inj),
        args=(sc, n_in, draws.resample, pm, bins, 0.01, 2.3,
              pcfg.min_particles))


def pf_kernels_at(m, pcfg, scan, center, M, dev):
    """K3 over M poses around ``center`` (the SoA batch and the particle
    launch with the motion off, reading K1's table), the particle launch
    with K9's motion folded in, and K9 on those scores: each bitwise equal
    to its twin and reproducible, the fused launch also to the parent
    design's two launches (K9's motion, then the SoA batch) on the same
    draws; returns the times."""
    import torch

    from ndt_2d_tpu_torch.kernels import particle_filter as k9
    from ndt_2d_tpu_torch.kernels import score_points as k3
    W, H = m.config.grid_cells_x, m.config.grid_cells_y
    B = m.config.laser_max_beams
    c = pf_case(m, pcfg, scan, center, M, dev)
    q, qm, n = scan
    sa, sc, poses = c.sa, c.sc, c.poses
    sct = k3.score_batch_twin(*sa)
    torch.cuda.synchronize()
    require(torch.equal(sc, sct), f"K3 batch ({M} poses) differs from its "
            "twin")
    for i in range(0, M, M // 64):
        one = k3.score_at_pose(m.grid, W, H, m.config.laser_max_beams, q,
                               qm, n, poses[i])
        require(torch.equal(one, sc[i]), f"K3 batch row {i} of {M} differs "
                "from its M = 1 launch")
    require(torch.equal(k3.score_batch(*sa), sc),
            f"K3 batch ({M} poses) not bitwise reproducible")
    # The particle launch with the motion off: each cell read as a record
    # of K1's table, the SoA batch's bits.
    ra = (m.grid, m.packed_table, W, H, B, q, qm, n, poses)
    rs, rst = k3.score_records(*ra), k3.records_twin(*ra)
    torch.cuda.synchronize()
    require(torch.equal(rs, sc) and torch.equal(rst, sct),
            f"K3's particle launch, motion off ({M} poses), differs from "
            "the SoA batch or its twin from the SoA twin")
    require(torch.equal(k3.score_records(*ra), rs),
            f"K3's particle launch, motion off ({M}), not reproducible")
    print(f"[3] K3 batch: {M} poses on the config-4 grid ({W}x{H}), "
          f"scores {float(sc.min()):.4f}..{float(sc.max()):.4f}, bitwise "
          f"equal to the twin, 64 rows bitwise equal to their M = 1 launch; "
          f"the particle launch with the motion off (one record a beam from "
          f"K1's table) bitwise the SoA batch, its twin the SoA twin")
    out = {"score_points_batch": timed(
        max_abs_diff([(rs, rst)]), cuda_ms(lambda: k3.score_records(*ra), 20),
        cuda_ms(lambda: k3.records_twin(*ra), 5),
        *cost_particles(m.config, m.grid, q, qm, n, poses))}

    # K9's motion folded into the particle launch, on the step's draws.
    draws, scal = c.draws, c.scal
    fa = (m.grid, m.packed_table, W, H, B, q, qm, n, poses, draws.motion,
          scal)
    fm, fs = k3.motion_score(*fa)
    tm = k9.motion_twin(poses, draws.motion, scal)
    ts = k3.score_batch_twin(m.grid, W, H, B, q, qm, n, tm)
    rtm, rts = k3.motion_score_twin(*fa)
    pm2 = k9.motion(poses, draws.motion, scal)
    ps2 = k3.score_batch(m.grid, W, H, B, q, qm, n, pm2)
    torch.cuda.synchronize()
    require(torch.equal(fm, tm) and torch.equal(fs, ts),
            f"the fused launch ({M}) differs from motion_twin + "
            "score_batch_twin")
    require(torch.equal(rtm, tm) and torch.equal(rts, ts),
            f"the fused twin ({M}) differs from motion_twin + "
            "score_batch_twin")
    require(torch.equal(fm, pm2) and torch.equal(fs, ps2),
            f"the fused launch ({M}) differs from K9's motion then the SoA "
            "batch (the parent design's two launches)")
    for i in range(0, M, M // 64):
        one = k3.score_at_pose(m.grid, W, H, B, q, qm, n, fm[i])
        require(torch.equal(one, fs[i]), f"fused row {i} of {M} differs "
                "from its M = 1 launch at the moved pose")
    fm2, fs2 = k3.motion_score(*fa)
    torch.cuda.synchronize()
    require(torch.equal(fm2, fm) and torch.equal(fs2, fs),
            f"the fused launch ({M}) not bitwise reproducible")
    stride = m.packed_table.shape[-1]
    print(f"[3] K3's particle launch with K9's motion folded in: {M} "
          f"particles moved and scored in one launch ({stride}-float "
          f"table rows), moved particles and scores bitwise equal to "
          f"motion_twin + score_batch_twin and to K9's motion then the SoA "
          f"batch, 64 rows bitwise their M = 1 launch at the moved pose, "
          f"reproducible")
    out["pf_motion_score"] = timed(
        max_abs_diff([(fm, tm), (fs, ts)]),
        cuda_ms(lambda: k3.motion_score(*fa), 20),
        cuda_ms(lambda: k3.motion_score_twin(*fa), 5),
        *cost_particles(m.config, m.grid, q, qm, n, poses, fm))

    # K9 on those scores, with one set of draws for kernel and twin.
    draws, scal, pm, n_in, w0 = c.draws, c.scal, c.pm, c.n_in, c.w0
    pmt = k9.motion_twin(poses, draws.motion, scal)
    torch.cuda.synchronize()
    require(torch.equal(pm, pmt), f"K9 motion ({M}) differs from its twin")
    args, rec, free = c.args, c.rec, c.free
    ns, errs = [], {}
    for name, r in (("plain", None), ("recovery", rec)):
        a, b = k9.resample(*args, r), k9.resample_twin(*args, r)
        torch.cuda.synchronize()
        fields = [f for f in a._fields if getattr(a, f) is not None]
        pairs = [(getattr(a, f), getattr(b, f)) for f in fields]
        for f, (x, y) in zip(fields, pairs):
            require(torch.equal(x, y), f"K9 resample ({name}, {M}): {f} "
                    "differs from its twin")
        errs[name] = max_abs_diff(pairs)
        again = k9.resample(*args, r)
        require(all(torch.equal(getattr(a, f), getattr(again, f))
                    for f in a._fields if getattr(a, f) is not None),
                f"K9 resample ({name}, {M}) not bitwise reproducible")
        ns.append(int(a.n[0]))
        if r is not None:
            moved = int((a.particles != pm[a.idx.long()]).any(1).sum())
            require(moved > 0, "recovery resample injected nothing")
            ew = k9.ewma(sc, n_in, w0, 0.001, 0.1)
            require(torch.equal(ew, k9.ewma_twin(sc, n_in, w0, 0.001, 0.1))
                    and torch.equal(ew, a.w_state),
                    f"K9 ewma ({M}) differs from its twin or the resample's")
    st, stt = k9.statistics(pm, sc, n_in), k9.statistics_twin(pm, sc, n_in)
    torch.cuda.synchronize()
    st_pairs = [(getattr(st, f), getattr(stt, f))
                for f in ("particles", "weights", "normalized", "n", "stats")]
    require(all(torch.equal(x, y) for x, y in st_pairs),
            f"K9 statistics ({M}) differ from the twin")
    # The statistics entry after an injection, over the first 3/4.
    n_part = torch.tensor([3 * M // 4], dtype=torch.int32, device=dev)
    p_inj = torch.tensor([0.3], device=dev)
    si = k9.statistics(pm, sc, n_part, rec.injection, p_inj)
    sit = k9.statistics_twin(pm, sc, n_part, rec.injection, p_inj)
    torch.cuda.synchronize()
    require(all(torch.equal(getattr(si, f), getattr(sit, f))
                for f in ("particles", "weights", "normalized", "n", "stats")),
            f"K9 statistics with injection ({M}) differ from the twin")
    require(bool((si.particles != pm).any()),
            "K9 statistics with injection injected nothing")
    refused = pf_refusals(args, M) if M == GLOBAL_PARTICLES else ""
    print(f"[3] K9: motion, resample (n_active {ns[0]} plain, {ns[1]} with "
          f"recovery), the EWMAs alone and statistics (alone and after an "
          f"injection into the first {3 * M // 4}) on {M} particles bitwise "
          f"equal to their twins (n_active, drawn indices, first-occurrence "
          f"marks, particles, weights, w_slow/w_fast, mean, covariance) and "
          f"reproducible; chain plan {tuple(k9.plan(M, k9.fits_on(dev)))}"
          f"{refused}")
    # K9: motion ~40 operations a particle (odometry model, normalize);
    # resample ~60 (weights, CDF, binary search, hash, marks, statistics);
    # statistics ~40 (normalize, weighted mean and covariance).  The
    # resample's library yardstick is torch.cumsum of the M weights, the
    # function of its CDF launch alone (no one call resamples).
    res_a = k9.resample(*args)
    res_moved = nbytes(sc, pm, draws.resample,
                       *[getattr(res_a, f) for f in res_a._fields
                         if getattr(res_a, f) is not None])
    cumsum_ms = cuda_ms(lambda: torch.cumsum(sc, 0), 20)
    out["pf_motion"] = timed(
        max_abs_diff([(pm, pmt)]),
        cuda_ms(lambda: k9.motion(poses, draws.motion, scal), 20),
        cuda_ms(lambda: k9.motion_twin(poses, draws.motion, scal), 5),
        nbytes(poses, draws.motion, pm), 40 * M)
    out["pf_resample"] = timed(
        errs["plain"], cuda_ms(lambda: k9.resample(*args), 20),
        cuda_ms(lambda: k9.resample_twin(*args), 3), res_moved, 60 * M,
        library_ms=cumsum_ms)
    out["pf_resample_recovery"] = timed(
        errs["recovery"], cuda_ms(lambda: k9.resample(*args, rec), 20),
        cuda_ms(lambda: k9.resample_twin(*args, rec), 3),
        res_moved + nbytes(free), 80 * M, library_ms=cumsum_ms)
    out["pf_statistics"] = timed(
        max_abs_diff(st_pairs),
        cuda_ms(lambda: k9.statistics(pm, sc, n_in), 20),
        cuda_ms(lambda: k9.statistics_twin(pm, sc, n_in), 3),
        nbytes(pm, sc, *[x for x, _ in st_pairs]), 40 * M)
    # The EWMAs alone: the masked sum of M weights and two updates (~3
    # operations a particle).  Its library yardstick is that masked sum
    # of the negated weights as PyTorch writes it, torch.sum(torch.where(
    # mask, -w, 0)); the two scalar updates are left out.
    ew = k9.ewma(sc, n_in, w0, 0.001, 0.1)
    mask = torch.arange(M, device=dev) < n_in
    zero = torch.zeros((), device=dev)
    out["pf_ewma"] = timed(
        0.0, cuda_ms(lambda: k9.ewma(sc, n_in, w0, 0.001, 0.1), 20),
        cuda_ms(lambda: k9.ewma_twin(sc, n_in, w0, 0.001, 0.1), 5),
        nbytes(sc, n_in, w0, ew), 3 * M,
        library_ms=cuda_ms(lambda: torch.sum(torch.where(mask, -sc, zero)),
                           20))
    return out


def pf_refusals(args, M: int) -> str:
    """The resample wrapper raises, and returns nothing, where the card
    refuses its launch: a plan of 1024 blocks (more than the card holds
    co-resident at the staged CDF's shared memory) and a plan of four
    blocks whose shared memory exceeds a block's 227 KB."""
    import torch

    from ndt_2d_tpu_torch.kernels import particle_filter as k9
    real = k9.plan
    pl = real(M)
    forged = {
        "co-residency": pl._replace(cpb=1, blocks=1024, items=pl.L),
        "shared memory": pl._replace(cpb=256, blocks=4, items=256 * pl.L)}
    said = []
    try:
        for what, bad in forged.items():
            k9.plan = lambda m, fits=None, bad=bad: bad
            before = k9.launches["pf_resample"]
            try:
                k9.resample(*args)
            except RuntimeError as e:
                said.append(f"{what}: {e}")
            else:
                raise SmokeFailure(f"K9 resample with a refused {what} plan "
                                   "returned")
            require(k9.launches["pf_resample"] == before,
                    f"K9 resample counted a refused {what} launch")
    finally:
        k9.plan = real
    torch.cuda.synchronize()
    return "; refused launches raise (" + "; ".join(said) + ")"


class StepRecorder:
    """Records the inputs and outputs of the first filter steps of a
    session, for the twin replay."""

    def __init__(self, keep: int):
        from ndt_2d_tpu_torch.filter import particle_filter
        self.mod, self.real, self.keep = particle_filter, \
            particle_filter.pf_step, keep
        self.steps = []

    def step(self, *args, **kw):
        out = self.real(*args, **kw)
        if len(self.steps) < self.keep:
            self.steps.append((args, out))
        return out

    def __enter__(self):
        self.mod.pf_step = self.step
        return self

    def __exit__(self, *exc):
        self.mod.pf_step = self.real


class TwinTrap:
    """Counts calls of the K3-batch and K9 twins while it is active."""

    NAMES = {"score_points": ("score_batch_twin", "score_at_pose_twin",
                              "score_composed_twin", "records_twin",
                              "motion_score_twin"),
             "particle_filter": ("motion_twin", "resample_twin",
                                 "statistics_twin")}

    def __init__(self):
        from ndt_2d_tpu_torch.kernels import particle_filter, score_points
        self.mods = {"score_points": score_points,
                     "particle_filter": particle_filter}
        self.calls = 0
        self.saved = []

    def __enter__(self):
        for key, names in self.NAMES.items():
            mod = self.mods[key]
            for name in names:
                real = getattr(mod, name)
                self.saved.append((mod, name, real))

                def counted(*a, _real=real, **kw):
                    self.calls += 1
                    return _real(*a, **kw)
                setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)


def track(loc, scans, rel):
    """Run (t, msg, odom) scans through ``loc``; returns the position
    errors of the accepted scans against ``rel``, their indices t, and the
    seconds of every process_scan."""
    import numpy as np
    errs, ts, times = [], [], []
    for t, msg, odom in scans:
        t0 = time.perf_counter()
        res = loc.process_scan(msg, odom)
        times.append(time.perf_counter() - t0)
        if res.accepted:
            errs.append(float(np.hypot(*(res.pose[:2] - rel[t][:2]))))
            ts.append(t)
    return np.asarray(errs), np.asarray(ts), np.asarray(times)


def phase_config4(path_map, keyframes, dev):
    """BASELINE config 4 on the card: load the saved box map of
    ``keyframes`` keyframes, localize with the particle filter, replay its
    first steps through the twins, then the scan-match branch on the same
    map and bag."""
    import dataclasses

    import numpy as np
    import torch

    from ndt_2d_tpu_torch.io.bag import record_synthetic
    from ndt_2d_tpu_torch.utils import metrics
    mapping, cfg = config4_configs()
    loc_bag = record_synthetic("box", 150, n_beams=360, seed=7,
                               odom_trans_noise=0.01)
    rel = metrics.relative_to_first(loc_bag.truth)
    odom_rel = metrics.relative_to_first(loc_bag.odom)
    scans = [(t, msg, odom) for t, (msg, odom) in enumerate(loc_bag)
             if t > 0]
    reset_counts()
    loc = localizer(cfg, path_map, dev, 3)
    loc.set_initial_pose(rel[0], np.diag([0.04, 0.04, 0.01]),
                         loc_bag.truth[0])
    with StepRecorder(3) as rec:
        errs, ts, times = track(loc, scans, rel)
    torch.cuda.synchronize()
    launches = read_counts()
    steps = len(errs)
    require(steps >= 50, f"PF accepted {steps} of {len(scans)} scans")
    # Odometry alone over the same scans, from the same initial pose.
    odom_err = float(np.mean(np.hypot(*(odom_rel[ts, :2] - rel[ts, :2]).T)))
    one_device_pf_launches(launches, steps, "config 4")
    require(launches["pf_statistics"] >= 1, "pf_statistics never launched")
    require(launches["ndt_build"] >= 1, "the global NDT was not built")
    mean_err, final_err = float(np.mean(errs)), float(errs[-1])
    require(np.isfinite(errs).all() and mean_err <= 0.10,
            f"PF mean position error {mean_err} > 0.10 m")
    require(mean_err < odom_err, f"PF mean error {mean_err} not below "
            f"odometry's {odom_err}")
    pf_t = loc.stats.timer.summary()["pf_step"]
    digest = poses_digest(loc.filter.particles.cpu().numpy())
    print(f"[4d] config 4: {keyframes}-keyframe box map saved and loaded; "
          f"PF {PARTICLES} particles over {steps} accepted of "
          f"{len(scans)} scans: mean position "
          f"error {mean_err:.4f} m, final {final_err:.4f} m (odometry "
          f"{odom_err:.4f} m), {np.median(times[2:]) * 1e3:.3f} ms/scan "
          f"median, pf_step {pf_t['mean_ms']:.3f} ms x {pf_t['count']}, "
          f"n_active at the end {loc.filter.n_active}, final particles "
          f"sha256 {digest}; launches {launches}")
    phase_pf_replay(rec, "[4d]", 3)

    # The scan-match branch on the same map and bag.
    sm_cfg = dataclasses.replace(mapping, enable_mapping=False)
    reset_counts()
    sm = localizer(sm_cfg, path_map, dev, 0)
    sm.set_initial_pose(rel[0], np.diag([0.04, 0.04, 0.01]),
                        loc_bag.truth[0])
    serrs, _, stimes = track(sm, scans, rel)
    sm_launches = read_counts()
    sm_mean = float(np.mean(serrs))
    require(len(serrs) == steps, f"scan-match accepted {len(serrs)} scans, "
            f"the PF {steps}")
    require(sm_mean <= 0.12, f"scan-match mean error {sm_mean} > 0.12 m")
    for k in ("candidate_scores", "score_points"):
        require(sm_launches[k] == len(serrs), f"scan-match {k} launched "
                f"{sm_launches[k]} times, expected {len(serrs)}")
    print(f"[4d] scan-match branch: mean position error {sm_mean:.4f} m, "
          f"final {float(serrs[-1]):.4f} m, "
          f"{np.median(stimes[2:]) * 1e3:.3f} ms/scan median; launches "
          f"{sm_launches}")
    return launches, dict(pf=float(np.median(times[2:]) * 1e3),
                          sm=float(np.median(stimes[2:]) * 1e3),
                          digest=digest)


def one_device_pf_launches(launches, steps: int, what: str) -> None:
    """A one-device filter step is two launches: K3's particle launch with
    K9's motion folded in and K9's resample chain; no K9 motion launch and
    no other batched scoring."""
    for k in ("pf_motion_score", "pf_resample"):
        require(launches[k] == steps, f"{what}: {k} launched {launches[k]} "
                f"times, expected {steps}")
    for k in ("pf_motion", "score_points_batch", "score_points_batch_soa"):
        require(launches[k] == 0, f"{what}: {k} launched {launches[k]} "
                "times on one device, expected 0")


def twin_step(draws, particles, n, control, mcfg, grid, points, point_mask,
              num_points, alphas, kld_err, kld_z, bins, min_particles):
    """A recorded ``pf_step``'s inputs through the twins: the motion sample,
    K3 over the moved particles, the KLD resample and statistics."""
    from ndt_2d_tpu_torch.filter import motion_model
    from ndt_2d_tpu_torch.kernels import particle_filter as k9
    from ndt_2d_tpu_torch.kernels import score_points as k3
    p = k9.motion_twin(particles, draws.motion,
                       motion_model.motion_scalars(*control, *alphas))
    scores = k3.score_batch_twin(grid, mcfg.grid_cells_x, mcfg.grid_cells_y,
                                 mcfg.laser_max_beams, points, point_mask,
                                 num_points, p)
    return k9.resample_twin(scores, n, draws.resample, p, bins, kld_err,
                            kld_z, min_particles)


def phase_pf_replay(rec, tag, steps):
    """The first ``steps`` recorded filter steps again, through the twins
    with the same draws: the same n_active and particles, bit for bit."""
    import torch
    require(len(rec.steps) == steps, f"recorded {len(rec.steps)} steps")
    for i, (args, out) in enumerate(rec.steps):
        twin = twin_step(*args)
        require(torch.equal(out.n, twin.n), f"replayed step {i}: n_active")
        require(torch.equal(out.particles, twin.particles),
                f"replayed step {i}: particles differ")
        require(torch.equal(out.stats, twin.stats),
                f"replayed step {i}: mean/covariance differ")
    print(f"{tag} replay of the first {steps} filter steps "
          f"({out.particles.shape[0]} particles) through the twins: "
          f"n_active {[int(o.n[0]) for _, o in rec.steps]}, particles, "
          f"mean and covariance bitwise equal")


def config7():
    """BASELINE config 7 (run_benchmarks.py:598-657): the symmetry-broken
    office, the 40-pose drive, the mapping and particle-filter configs and
    the drive's scan at pose t (noise seeded by ``seed``)."""
    import dataclasses

    import numpy as np

    from ndt_2d_tpu_torch.config import (
        MapperConfig, ParticleFilterConfig, ScanMatcherConfig)
    from ndt_2d_tpu_torch.utils import sim
    world = np.concatenate([sim.make_office_world(16.0),
                            np.asarray([[[1.0, 13.0], [3.0, 15.0]]])],
                           axis=0)
    n = 40
    truth = np.stack([np.linspace(2.0, 10.0, n), np.full(n, 2.0),
                      np.zeros(n)], axis=-1)
    m = ScanMatcherConfig(grid_cells_x=192, grid_cells_y=192)
    mapping = MapperConfig(local_scan_matcher=m, global_scan_matcher=m,
                           max_points_per_scan=512, loop_closure_every=10**9,
                           max_range=14.0)
    cfg = dataclasses.replace(
        mapping, use_particle_filter=True,
        particle_filter=dataclasses.replace(
            ParticleFilterConfig(), min_particles=200,
            max_particles=GLOBAL_PARTICLES, odom_alpha1=0.05,
            odom_alpha2=0.05, odom_alpha3=0.05, odom_alpha4=0.05))

    def scan(t, seed):
        return sim.scan_at_pose(world, truth[t], n_beams=240, range_max=14.0,
                                noise=0.01, rng=np.random.default_rng(seed))
    return truth, mapping, cfg, scan


def phase_config7(path_map, dev):
    """BASELINE config 7: global relocalization, 20,000 particles seeded
    over the free space of the symmetry-broken office."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.utils import metrics, sim
    truth, mapping, cfg, scan = config7()
    n = len(truth)
    rel = metrics.relative_to_first(truth)
    odom = sim.drift_odometry(truth, 0.01, 0.003, seed=31)
    scans = [(t, scan(t, 900 + t), odom[t]) for t in range(1, n)]
    with TwinTrap() as trap:
        reset_counts()
        map_and_save(mapping, [(scan(t, t), truth[t]) for t in range(n)],
                     path_map, dev)
        loc = localizer(cfg, path_map, dev, 7)
        require(loc.global_localize(truth[0]), "global_localize failed")
        spread = float(loc.filter.get_covariance()[0, 0])
        with StepRecorder(2) as rec:
            errs, ts, times = track(loc, scans, rel)
        torch.cuda.synchronize()
        launches = read_counts()
    require(trap.calls == 0, f"{trap.calls} twin calls on the CUDA path")
    steps = len(errs)
    one_device_pf_launches(launches, steps, "config 7")
    require(launches["raymarch"] >= 1, "config 7: the free space was not "
            "rendered on K5")
    conv = next((int(t) for t, e in zip(ts, errs) if e < 0.5), None)
    print(f"[4e] config 7: {GLOBAL_PARTICLES} particles over the free space "
          f"(initial x variance {spread:.3f} m^2), {steps} scans; converged "
          f"(< 0.5 m) at scan {conv}, final error {float(errs[-1]):.4f} m, "
          f"{np.median(times[2:]) * 1e3:.3f} ms/scan median, final particles "
          f"sha256 {poses_digest(loc.filter.particles.cpu().numpy())}; no "
          f"twin ran; launches {launches}")
    phase_pf_replay(rec, "[4e]", 2)
    return launches


def cost_candidate_gather(mc, origin, cell_size, points, point_mask,
                          num_points: int, pose, dths, dls,
                          record_bytes: int = 32, term_ops: int = 30):
    """K6's (bytes, operations) for one row: each distinct cell record (32
    bytes) that any (candidate, used beam) looks up on its grids, the used
    beams (9 bytes each), the start pose and the [13] output; ~30
    operations (shift, division, floor, quadratic form, exp, sum) a
    (candidate, used beam) per grid (``record_bytes``, ``term_ops``: another
    record and term)."""
    import torch
    W, H = mc.grid_cells_x, mc.grid_cells_y
    spts, smask, used = used_beams(mc, points, point_mask, num_points)
    spts = spts[smask]
    th = pose[2] + dths
    c, s = torch.cos(th)[:, None], torch.sin(th)[:, None]
    rx = c * spts[:, 0] - s * spts[:, 1] + pose[0]          # [A, B]
    ry = s * spts[:, 0] + c * spts[:, 1] + pose[1]
    cells = 0
    origins = origin.reshape(-1, 2)
    for o in origins:
        ix = torch.floor((rx[..., None] + dls - o[0]) / cell_size).long()
        iy = torch.floor((ry[..., None] + dls - o[1]) / cell_size).long()
        okx, oky = (ix >= 0) & (ix < W), (iy >= 0) & (iy < H)
        keys = iy[:, :, None, :] * W + ix[:, :, :, None]    # [A, B, L, L]
        ok = okx[:, :, :, None] & oky[:, :, None, :]
        cells += torch.unique(keys[ok]).numel()
    L = dls.numel()
    return (cells * record_bytes + used * 9 + 12 + 13 * 4,
            origins.shape[0] * dths.numel() * L * L * used * term_ops)


def cost_lattice_tables(mc, origin, points, point_mask, num_points: int,
                        pose, dths, dls):
    """K11's lattice's (bytes, operations) for one row: K6's bytes with a
    4-byte field value a cell; a (candidate, used beam) term an index add
    and a float add, since a beam's cell columns and row offsets depend on
    one offset each: ~10 operations (rotation share, shift, division,
    floor, bounds) for each of the 2 L entries of an (angle, used beam)."""
    moved, terms = cost_candidate_gather(mc, origin, mc.ndt_resolution,
                                         points, point_mask, num_points,
                                         pose, dths, dls, record_bytes=4,
                                         term_ops=2)
    used = used_beams(mc, points, point_mask, num_points)[2]
    return moved, terms + dths.numel() * used * 2 * dls.numel() * 10


def edge_candidates(mc, origin, cell_size, points, point_mask, num_points,
                    pose, dths, dls):
    """[A, L, L] bool: the candidates (angle, dx, dy) of one row that have
    a used beam whose cell coordinate ``(w - origin) / cell`` lies within
    4 ulp of an integer in x (for that dx) or in y (for that dy): the beams
    that an edge comparison and a floor of the quotient may place in
    different cells."""
    import torch
    spts, smask, _ = used_beams(mc, points, point_mask, int(num_points))
    th = pose[2] + dths
    c, s = torch.cos(th)[:, None], torch.sin(th)[:, None]
    rx = c * spts[:, 0] - s * spts[:, 1] + pose[0]          # [A, B]
    ry = s * spts[:, 0] + c * spts[:, 1] + pose[1]
    eps = torch.finfo(torch.float32).eps

    def near(w, o):
        q = (w[..., None] + dls - o) / cell_size            # [A, B, L]
        close = (q - torch.round(q)).abs() <= 4 * eps * q.abs().clamp(min=1)
        return (close & smask[None, :, None]).any(dim=1)    # [A, L]
    o = origin.reshape(-1, 2)[0]
    return near(rx, o[0])[:, :, None] | near(ry, o[1])[:, None, :]


def coarse_rows(cfg, bag, dev, rows=COARSE_ROWS):
    """Far confirmation rows at config-6 shapes: 3-scan office regions,
    the query started 1.1 m and 0.15 rad off, as a far candidate's start
    is off by the odometry drift."""
    return office_rows(cfg, bag, dev, rows, region=(0, 5, 10),
                       shift=(0.9, -0.6, 0.15))


def phase_k6(cfg, bag, dev):
    """K6 at the coarse stage's shapes and at the map merge's."""
    import dataclasses

    import numpy as np
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_gather as k6
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.mapping import merge
    from ndt_2d_tpu_torch.matching import matcher
    cm = cfg.coarse_scan_matcher
    require(matcher.search_kernel(cm) is k6
            and matcher.search_kernel(cfg.global_scan_matcher) is k2,
            "the coarse matcher is not on K6 or the global one not on K2")
    rmax = 12.0
    rows = coarse_rows(cfg, bag, dev)
    win, query = rows[:4], rows[4:]
    dths, dls = matcher._search_offsets(cm, dev)
    build = (rmax, cm.ndt_resolution, cm.grid_cells_x, cm.grid_cells_y)
    g, tab = k1.build_windows(*win, *build)

    def run(scores=False):
        return k6.match_rows(cm, g, tab, *query, dths, dls,
                             with_scores=scores)

    def twin():
        return k6.match_rows_twin(cm, g, tab, *query, dths, dls)

    (out, sc), (rest, sct) = run(True), twin()
    torch.cuda.synchronize()
    check_match(out, sc, k2.pack(rest), sct, "K6 rows")
    check_match(out, sc, *run(True), "K6 rows (reproducibility)")
    require(torch.equal(out, run()), "K6 rows differ without the scores")
    moved = float(out[:, 1:3].abs().max())
    require(moved > cm.ndt_resolution, "no K6 row left its start's cell")

    # Row independence: R = COARSE_ROWS against R = 1 and pad 4 / pad 32.
    full = matcher.match_scan_batch_multi(cm, *win, rmax, *query)
    require(torch.equal(full[0], out[:, 0]), "batch_multi is not K6's rows")
    for r in range(COARSE_ROWS):
        one = matcher.match_scan_batch_multi(
            cm, *[t[r:r + 1] for t in win], rmax,
            *[t[r:r + 1] for t in query])
        require(all(torch.equal(a[r], b[0]) for a, b in zip(full, one)),
                f"K6 row {r} differs between R = {COARSE_ROWS} and R = 1")
    for pad in (4, 32):
        p = padded_rows(rows, 3, pad)
        o = matcher.match_scan_batch_multi(cm, *p[:4], rmax, *p[4:])
        require(all(torch.equal(a[:3], b[:3]) for a, b in zip(full, o)),
                f"K6 rows differ at pad {pad}")
        require(bool((o[0][3:] == 0).all()) and bool((o[1][3:] == 0).all()),
                f"K6 padding rows at pad {pad} scored or moved")

    # One-cell lattice: K6 and K2 compute the same function, up to the
    # beams that sit within a few ulp of a cell edge: K2 places them by
    # ``w >= edge``, K6 by ``floor((w - origin) / cell)``, as the two
    # reference paths do, and a beam placed in the other cell changes its
    # candidate's score.  Every candidate whose scores differ by more than
    # 1e-5 must have such a beam, and two rows may pick different winners
    # only where one of the two winners has one.
    narrow = dataclasses.replace(cm, search_linear_size=0.25,
                                 search_linear_resolution=0.05)
    nd, nl = matcher._search_offsets(narrow, dev)
    a6, s6 = k6.match_rows(narrow, g, tab, *query, nd, nl, with_scores=True)
    a2, s2 = k2.match_rows(narrow, g, tab, *query, nd, nl, with_scores=True)
    torch.cuda.synchronize()
    apart = (s6 - s2).abs() > 1e-5
    on_edge = torch.stack([edge_candidates(
        narrow, g.origin[r], g.cell_size, *[t[r] for t in query], nd, nl)
        for r in range(COARSE_ROWS)])
    require(not bool((apart & ~on_edge).any()),
            f"{int((apart & ~on_edge).sum())} candidates differ between K6 "
            "and K2 on a one-cell lattice with no beam on a cell edge")
    win6 = s6.reshape(COARSE_ROWS, -1).argmin(dim=1)
    win2 = s2.reshape(COARSE_ROWS, -1).argmin(dim=1)
    flat_edge = on_edge.reshape(COARSE_ROWS, -1)
    rows_r = torch.arange(COARSE_ROWS, device=dev)
    excused = flat_edge[rows_r, win6] | flat_edge[rows_r, win2]
    same = (a6[:, 1:4] == a2[:, 1:4]).all(dim=1)
    same_winner = int(same.sum())
    require(bool((same | excused).all()),
            f"K6 and K2 pick different winners in rows "
            f"{torch.nonzero(~(same | excused)).flatten().tolist()} with no "
            "beam on a cell edge")
    quiet = same & ~apart.reshape(COARSE_ROWS, -1).any(dim=1)
    require(bool(quiet.any()) and float(
        (a6[quiet, :4] - a2[quiet, :4]).abs().max()) <= 1e-5,
        "K6 and K2 scores or corrections differ where every candidate "
        "agrees")

    # The grid axis once: four overlapping grids on the first 4 rows.
    g4, tab4 = k1.build_windows(*[t[:4] for t in win], *build, 4)
    q4 = [t[:4] for t in query]
    o4, s4 = k6.match_rows(cm, g4, tab4, *q4, dths, dls, with_scores=True)
    r4, s4t = k6.match_rows_twin(cm, g4, tab4, *q4, dths, dls)
    torch.cuda.synchronize()
    check_match(o4, s4, k2.pack(r4), s4t, "K6 G = 4")

    # The merge's shape: a 7-scan window, the full-heading lattice, R = 1,
    # the query turned by 2.5 rad.
    mrows = office_rows(cfg, bag, dev, 1, region=tuple(range(7)),
                        shift=(0.4, -0.3, 2.5))
    mwin, mquery = mrows[:4], mrows[4:]
    span = float(np.ptp(mwin[0][0, :, :2].cpu().numpy(), axis=0).max())
    mm = merge._coarse_config(rmax, span)
    md, ml = matcher._search_offsets(mm, dev)
    mg, mtab = k1.build_windows(*mwin, rmax, mm.ndt_resolution,
                                mm.grid_cells_x, mm.grid_cells_y)

    def mrun(scores=False):
        return k6.match_rows(mm, mg, mtab, *mquery, md, ml,
                             with_scores=scores)

    def mtwin():
        return k6.match_rows_twin(mm, mg, mtab, *mquery, md, ml)
    (mo, ms), (mr, mst) = mrun(True), mtwin()
    torch.cuda.synchronize()
    check_match(mo, ms, k2.pack(mr), mst, "K6 merge shape")
    wide = k6_wide_lattice(cm, g, tab, query, dths, dls, dev)
    print(f"[3] K6 candidate_gather: {COARSE_ROWS} office rows x "
          f"{cm.grid_cells_x}^2 cells of {cm.ndt_resolution} m x "
          f"{dths.numel()}x{dls.numel()}x{dls.numel()} candidates: scores "
          f"and rows bitwise equal to the twin and reproducible, largest "
          f"correction {moved:.2f} m; each row bitwise equal at R = 1, pad 4 "
          f"and pad 32; against K2 on a one-cell lattice "
          f"({nd.numel()}x{nl.numel()}x{nl.numel()}): {int(apart.sum())} of "
          f"{apart.numel()} candidates differ by more than 1e-5, each with "
          f"a beam within 4 ulp of a cell edge ({int(on_edge.sum())} "
          f"candidates have one); the same winner in {same_winner} rows, "
          f"the others' winners have such a beam; G = 4 "
          f"bitwise; merge shape "
          f"{md.numel()}x{ml.numel()}x{ml.numel()} on {mm.grid_cells_x}^2 "
          f"cells bitwise, correction "
          f"{[round(float(x), 3) for x in mo[0, 1:4]]}; plans "
          f"{tuple(k6.plan(dls.numel()))} (coarse), "
          f"{tuple(k6.plan(ml.numel()))} (merge); {wide}")
    qp, qm, qn, qpose = query
    mqp, mqm, mqn, mqpose = mquery
    return {"candidate_gather": timed(
                0.0, cuda_ms(run, 10), cuda_ms(twin, 1),
                *sum_costs(cost_candidate_gather(
                    cm, g.origin[r], g.cell_size, qp[r], qm[r], int(qn[r]),
                    qpose[r], dths, dls) for r in range(COARSE_ROWS))),
            "candidate_gather_merge": timed(
                0.0, cuda_ms(mrun, 10), cuda_ms(mtwin, 1),
                *cost_candidate_gather(mm, mg.origin[0], mg.cell_size,
                                       mqp[0], mqm[0], int(mqn[0]),
                                       mqpose[0], md, ml))}


def k6_wide_lattice(cm, g, tab, query, dths, dls, dev):
    """K6 off the coarse stage's staged windows, each case's rows, scores
    and split-search partials bitwise against the twins: 2 rows x 2
    angles x 241 x 241 offsets of 0.0125 m, where an angle's scores do not
    fit in shared memory, through the field and its reduction (the
    config's 0.1 m offsets would span 48 cells, these span 6: every beam
    stays in its window); 2 x 2 x 301 x 301 of 0.01 m, more offsets an
    axis than a block has threads (the widest tile, a block a pass); 4
    coarse rows at four times the config's offsets, a lattice wider than
    the plan's windows, so that every chunk gathers from the table; and 4
    coarse rows with a plan forced to stage no window (winx = winy = 0),
    the table path for every chunk.  Then the 241 lattice with a forged
    plan that stages 64 beams at a time (over 227 KB of shared memory a
    block): the wrapper raises, launches nothing and counts nothing."""
    import dataclasses

    import torch

    from ndt_2d_tpu_torch.kernels import candidate_gather as k6
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    t0 = time.perf_counter()
    wd = dths[:2].contiguous()
    w2 = [t[:2] for t in query]
    g2 = dataclasses.replace(g, origin=g.origin[:2])
    q4 = [t[:4] for t in query]
    g4 = dataclasses.replace(g, origin=g.origin[:4])

    def both(grid, tabs, q, angles, offsets, what, a0, n):
        (o, sc), (r, sct) = (k6.match_rows(cm, grid, tabs, *q, angles,
                                           offsets, with_scores=True),
                             k6.match_rows_twin(cm, grid, tabs, *q, angles,
                                                offsets))
        torch.cuda.synchronize()
        check_match(o, sc, k2.pack(r), sct, f"K6 {what}")
        part = k6.partial_rows(cm, grid, tabs, *q, angles, offsets, a0, n)
        partt = k2.partial_rows_twin(cm, grid, tabs, *q, angles, offsets,
                                     a0, n, k6.TILE,
                                     k6.candidate_scores_gather)
        require(torch.equal(part, partt), f"K6 partials ({what}) differ "
                "from the twin")

    plans = {}
    for L, span in ((241, 1.5), (301, 1.5)):
        wl = torch.linspace(-span, span, L, device=dev)
        pl = k6.plan(L, True, k6.span_cells(cm, g.cell_size, L))
        require(not pl.fused, f"K6 plan {tuple(pl)} folds a {L} x {L} "
                "lattice in shared memory")
        both(g2, tab[:2], w2, wd, wl, f"{L} x {L} (field path)", 1, 1)
        plans[L] = pl
    require(plans[301].passes > 1 and (plans[301].kx, plans[301].ky)
            == k6.TILES[-1], f"K6 plan {tuple(plans[301])} for 301 offsets "
            "is not the widest tile over passes")
    L = dls.numel()
    real = k6.plan
    pl = real(L, True, k6.span_cells(cm, g.cell_size, L))
    wide = (dls * 4.0).contiguous()
    require(pl.winx * pl.winy > 0 and float(wide[-1] - wide[0])
            > (pl.winy - 1) * g.cell_size, f"K6 coarse plan {tuple(pl)} "
            "stages no window, or one that holds four times its span")
    both(g4, tab[:4], q4, dths, wide, "4 rows at 4x the offsets (table "
         "path)", 3, 5)
    bare = pl._replace(winx=0, winy=0)
    k6.plan = lambda *a: bare
    try:
        both(g4, tab[:4], q4, dths, dls, "4 rows, no window (table path)",
             3, 5)
    finally:
        k6.plan = real
    forged = plans[241]._replace(chunk=64)
    before = k6.launches
    k6.plan = lambda *a: forged
    try:
        k6.match_rows(cm, g2, tab[:2], *w2, wd,
                      torch.linspace(-1.5, 1.5, 241, device=dev))
    except RuntimeError as e:
        said = str(e)
    else:
        raise SmokeFailure("K6 with a refused shared-memory plan returned")
    finally:
        k6.plan = real
    require(k6.launches == before, "K6 counted a refused launch")
    torch.cuda.synchronize()
    return (f"2 x 2 x 241 x 241 (plan {tuple(plans[241])}) and 2 x 2 x 301 "
            f"x 301 (plan {tuple(plans[301])}) through the field path, 4 "
            f"coarse rows at 4x the offsets and with no window (plan "
            f"{tuple(bare)}) through the table path, each bitwise with its "
            f"partials; a plan of {k6.plan_smem(forged, 241)} bytes of "
            f"shared memory raises ({said}; "
            f"{time.perf_counter() - t0:.1f} s)")


def office_table(cfg, bag, dev):
    """The office bag's scans as a graph's padded buffers hold them:
    points [TABLE_SCANS, P, 2] and masks, the rows past the bag empty."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.mapping import laser
    P = cfg.max_points_per_scan
    pts = np.zeros((TABLE_SCANS, P, 2), np.float32)
    msk = np.zeros((TABLE_SCANS, P), bool)
    for t in range(len(bag)):
        pts[t], msk[t] = laser.project_scan(bag[t][0], bag.range_max,
                                            np.zeros(3), False, None, P)
    return torch.from_numpy(pts).to(dev), torch.from_numpy(msk).to(dev)


DESCRIPTOR_KERNELS = ("descriptors", "descriptor_spectra",
                      "descriptor_search")


def check_descriptors(pts, msk, rmax, n_bins, n_valid, k, ex, what,
                      suffix="", tag="[3]"):
    """K10's three kernels over one point table [S, P, 2]: the bin tables,
    the descriptors and the all-pairs top-k (k, rolling exclusion ex, the
    first n_valid scans valid), each bitwise against its twin and
    reproducible; the entry points of ``parallel/loop_search.py`` give the
    same bits, row q of the all-pairs search is ``search_dense`` at q to
    the bit, and the scores agree with a float32 matrix product within
    1e-6.  Returns (timing entries named with ``suffix``, descriptor table,
    indices, scores)."""
    import math

    import torch

    from ndt_2d_tpu_torch.kernels import descriptor_search as ks
    from ndt_2d_tpu_torch.kernels import descriptors as k10
    from ndt_2d_tpu_torch.parallel import loop_search
    dev = pts.device
    S, P = msk.shape
    shape = (64, 4, n_bins)

    def bins():
        return k10.bin_points(pts, msk, rmax, *shape)

    def bins_twin():
        return k10.bin_twin(pts, msk, rmax, *shape)
    a, b = bins(), bins_twin()
    torch.cuda.synchronize()
    for f in a._fields:
        require(torch.equal(getattr(a, f), getattr(b, f)),
                f"{what}: K10 {f} differs from the twin")
    require(all(torch.equal(x, y) for x, y in zip(a, bins())),
            f"{what}: K10 bins not bitwise reproducible")
    require(float(a.total.sum()) == float(msk.sum())
            and float(a.hist.sum()) == float(msk.sum()),
            f"{what}: K10 lost points")

    def spectra():
        return k10.spectra(a, rmax, *shape)

    def spectra_twin():
        return k10.spectra_twin(a, rmax, *shape)
    table, table_t = spectra(), spectra_twin()
    torch.cuda.synchronize()
    require(torch.equal(table, table_t),
            f"{what}: K10 descriptors differ from the twin")
    require(torch.equal(table, spectra()) and torch.equal(
        table, loop_search.descriptors(pts, msk, rmax, n_bins)),
        f"{what}: K10 descriptors not reproducible, or not what "
        "loop_search.descriptors returns")
    full = a.total > 0
    norms = torch.linalg.norm(table[full], dim=1)
    require(bool(((norms - 1).abs() < 1e-5).all())
            and float(table[~full].abs().sum()) == 0.0,
            f"{what}: descriptors are not unit vectors, or empty rows are "
            "not zero")

    ar = torch.arange(S, device=dev)
    valid = ar < n_valid
    limit = (ar - ex).to(torch.int32)
    kk = min(k, S)

    def search():
        return ks.top_k(table, table, valid, limit, kk)

    def search_twin():
        return ks.top_k_twin(table, table, valid, limit, kk)
    (idx, sims), (idx_t, sims_t) = search(), search_twin()
    torch.cuda.synchronize()
    require(torch.equal(idx, idx_t) and torch.equal(sims, sims_t),
            f"{what}: K10 search differs from the twin in "
            f"{int((idx != idx_t).sum())} indices")
    again = search()
    entry = loop_search.search_all_pairs(table, valid, k=k,
                                         rolling_exclude=ex)
    require(all(torch.equal(x, y) for pair in (again, entry)
                for x, y in zip((idx, sims), pair)),
            f"{what}: K10 search not reproducible, or not what "
            "search_all_pairs returns")
    checked = 0
    for q in range(ex, n_valid, max(1, n_valid // 64)):
        qi, qs = loop_search.search_dense(table, valid, q, k=k,
                                          rolling_exclude=ex)
        require(torch.equal(qi, idx[q]) and torch.equal(qs, sims[q]),
                f"{what}: search_all_pairs row {q} is not search_dense's")
        live = torch.isfinite(qs)
        require(bool((qi[live] <= q - ex).all())
                and int(live.sum()) == min(kk, max(q - ex + 1, 0)),
                f"{what}: row {q} holds an ineligible or a missing index")
        checked += 1
    eligible = valid[None, :] & (ar[None, :] <= limit[:, None])

    def library():
        prod = torch.where(eligible, table @ table.T, -math.inf)
        return torch.topk(prod, kk, dim=1)
    lib_scores = library().values
    require(torch.allclose(lib_scores, sims, rtol=0, atol=1e-6),
            f"{what}: K10 search scores differ from a matrix product's")
    print(f"{tag} K10 descriptors, {what}: {S} x {P} points "
          f"({int(msk.sum())} valid, {n_valid} scans): bin tables, "
          f"descriptors [{S}, {table.shape[1]}] and the all-pairs top {kk} "
          f"(indices and scores) bitwise equal to the twins and "
          f"reproducible; {checked} rows bitwise equal to search_dense; "
          f"scores within 1e-6 of a float32 matrix product")
    # The library yardsticks: for the bins the counts alone, one
    # torch.bincount over sector ids computed outside the timing; for the
    # search one matrix product, the mask and torch.topk.
    _, sec, _, _ = k10.bin_indices(pts, rmax, *shape)
    seg = (ar[:, None] * 64 + sec.long())[msk]
    cos_t, sin_t = k10.dft_tables(64, dev)
    B = table.shape[1]
    pairs = int(eligible.sum())
    names = [n + suffix for n in DESCRIPTOR_KERNELS]
    # Bins: ~40 operations a point (the norm, atan2, three bin indices, the
    # counts).  Spectra, per scan with points: five profiles x 32
    # frequencies x 64 sectors x two multiply-adds, then the norm.  Search:
    # a multiply-add per eligible pair and descriptor element, a compare a
    # pair.
    return ({
        names[0]: timed(
            max_abs_diff(list(zip(a, b))), cuda_ms(bins, 20),
            cuda_ms(bins_twin, 1), nbytes(pts, msk, *a), 40 * S * P,
            library_ms=cuda_ms(
                lambda: torch.bincount(seg, minlength=S * 64), 20)),
        names[1]: timed(
            max_abs_diff([(table, table_t)]), cuda_ms(spectra, 20),
            cuda_ms(spectra_twin, 1), nbytes(*a, cos_t, sin_t, table),
            int(full.sum()) * (4 * 5 * 32 * 64 + 8 * B),
            graph_ms=(graph_ms(spectra, 20), None)),
        names[2]: timed(
            max_abs_diff([(torch.nan_to_num(sims, neginf=0.0),
                           torch.nan_to_num(sims_t, neginf=0.0))]),
            cuda_ms(search, 20), cuda_ms(search_twin, 1),
            nbytes(table, valid, limit, sims, idx),
            (2 * B + 1) * pairs, library_ms=cuda_ms(library, 20),
            graph_ms=(graph_ms(search, 20), graph_ms(library, 20)))},
        table, idx, sims)


def check_search_odd(dev):
    """K10's search at an odd shape: 37 queries x 1000 keys of 190 floats
    (4-byte copies, a partial last chunk, ragged tiles), exact ties (five
    equal keys, four queries equal to them), invalid keys, negative limits
    and limits past the table; k = 3, 8 and 20 (one, two and five rounds of
    the top-k's lists).  Bitwise against the twin, and six rows bitwise
    equal to one-row launches of them."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.kernels import descriptor_search as ks
    rng = np.random.default_rng(5)
    keys = rng.normal(size=(1000, 190)).astype(np.float32)
    keys[[7, 300, 301, 999]] = keys[123]
    valid = rng.random(1000) > 0.1
    valid[[7, 123, 300, 301, 999]] = True
    query = rng.normal(size=(37, 190)).astype(np.float32)
    query[:4] = keys[123]
    limit = rng.integers(-20, 1100, size=37).astype(np.int32)
    limit[:4] = [999, 301, 5, -3]
    q, kt, v, lim = (torch.from_numpy(a).to(dev)
                     for a in (query, keys, valid, limit))
    for k in (3, 8, 20):
        got, want = ks.top_k(q, kt, v, lim, k), ks.top_k_twin(q, kt, v, lim,
                                                              k)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"K10 search at 37 x 1000 x 190, k = {k}, differs from the "
                "twin")
        for r in (0, 1, 2, 3, 17, 36):
            one = ks.top_k(q[r:r + 1], kt, v, lim[r:r + 1], k)
            require(torch.equal(one[0][0], got[0][r])
                    and torch.equal(one[1][0], got[1][r]),
                    f"K10 search row {r} differs from its one-row launch")
    require(got[0][0, :5].tolist() == [7, 123, 300, 301, 999],
            "K10 search: exact ties not in ascending index")
    print("[3] K10 search at 37 queries x 1000 keys x 190 floats (ties, "
          "invalid keys, negative limits), k = 3, 8, 20: bitwise equal to "
          "the twin; rows 0-3, 17, 36 bitwise equal to one-row launches")


def check_bins_shapes(pts, msk, dev):
    """K10's bins at both block shapes of the plan (128 and 256 threads)
    and the plan's own, bitwise against ``bin_twin``: over the first 512
    slots of the office table with a scan whose every point lies in one
    sector (the longest chain) and an all-masked scan, then over 64 random
    scans of 7000 points and of the parent kernel's largest scan, past the
    default 48 KB of shared memory."""
    import torch

    from ndt_2d_tpu_torch.kernels import descriptors as k10
    P = msk.shape[1]
    pts, msk = pts[:512].clone(), msk[:512].clone()
    pts[0, :, 0] = torch.linspace(0.5, 11.5, P, device=dev)
    pts[0, :, 1] = 0.1 * pts[0, :, 0]
    msk[0] = True
    msk[1] = False
    want = k10.bin_twin(pts, msk, 12.0)
    require(float(want.sector_count[0].max()) == P
            and float(want.total[1]) == 0.0,
            "K10: the one-sector or the empty scan is not what it should be")
    for threads in k10.BIN_THREADS + (None,):
        got = (k10.bin_points(pts, msk, 12.0) if threads is None
               else bins_arm(pts, msk, threads)())
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"K10 bins with blocks of {threads} differ from the twin")
    print(f"[3] K10 bins at blocks of {k10.BIN_THREADS} threads and the "
          f"plan's ({k10.bins_plan(512, P).threads} at 512 slots), with a "
          f"scan of {P} points in one sector and an all-masked scan: the "
          f"five tables bitwise the twin")
    # Scans past the default 48 KB of shared memory: 7000 points and the
    # parent kernel's largest scan (6 P + 1412 bytes within 48 KB), random
    # points from a seed, one scan in one sector and one all masked.
    gen = torch.Generator(device=dev).manual_seed(21)
    parent_max = (48 * 1024 - 4 * (64 * 5 + 32 + 1)) // 6
    sizes = []
    for P in (7000, parent_max):
        S = 64
        r = 12.0 * torch.rand(S, P, generator=gen, device=dev)
        th = 2 * math.pi * torch.rand(S, P, generator=gen, device=dev)
        pts = torch.stack([r * torch.cos(th), r * torch.sin(th)], 2)
        msk = torch.rand(S, P, generator=gen, device=dev) > 0.1
        pts[0, :, 0] = torch.linspace(0.5, 11.5, P, device=dev)
        pts[0, :, 1] = 0.1 * pts[0, :, 0]
        msk[0] = True
        msk[1] = False
        want = k10.bin_twin(pts, msk, 12.0)
        for threads in k10.BIN_THREADS + (None,):
            got = (k10.bin_points(pts, msk, 12.0) if threads is None
                   else bins_arm(pts, msk, threads)())
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for a, b in zip(got, want)),
                    f"K10 bins of {P} points with blocks of {threads} "
                    "differ from the twin")
        plan = k10.bins_plan(S, P)
        sizes.append(f"{P} points ({plan.threads} threads, {plan.smem} "
                     "shared bytes)")
    print(f"[3] K10 bins past 48 KB of shared memory, {S} slots of "
          f"{' and '.join(sizes)}, a one-sector and an all-masked scan: "
          f"the five tables bitwise the twin at both block shapes and the "
          f"plan's")


def spectra_arm(bins, warps: int, staged: int, rmax: float = 12.0,
                shape=(64, 4, 32)):
    """K10's spectra launch at a given block shape (``warps`` scans a
    block, the tables ``staged`` in shared memory or not), the C entry
    bound here (a tree without the plan has no such entry); returns a
    callable that launches it into a new output."""
    import torch

    from ndt_2d_tpu_torch.kernels import _build
    from ndt_2d_tpu_torch.kernels import descriptors as k10
    dev = bins.total.device
    S = bins.total.shape[0]
    n_sectors, n_rings, n_bins = shape
    cos_t, sin_t = k10.dft_tables(n_sectors, dev)
    fn = _build.function("ndt2d_descriptor_spectra", k10._SPECTRA_ARGS)
    width = (1 + n_rings) * (n_sectors // 2) + n_bins

    def run():
        out = torch.empty(S, width, device=dev)
        p = _build.ptr
        _build.check(fn(*[p(t) for t in bins], p(cos_t), p(sin_t), S,
                        float(rmax), n_sectors, n_rings, n_bins, warps,
                        staged, p(out), _build.stream_ptr(dev)),
                     "descriptor_spectra")
        return out
    return run


SPECTRA_FORMS = ((1, 1), (2, 1), (4, 1), (8, 1), (8, 0))


def check_spectra_shapes(pts, msk, dev):
    """K10's spectra at every block shape the plan takes (1-8 scans a
    block, the tables staged or read from global memory) over the office
    table with an empty scan and a one-sector scan added, bitwise the
    twin; the plan's own form at 1, 5, 512 and 2048 scans; then shapes off
    the main path: 62 sectors (no 16-byte profile loads, a frequency past
    lane 30 idle), 6 rings (two passes of chains), 40 bins (past one a
    lane), 128 sectors (64 frequencies, two a lane; the tables unstaged
    at 8 warps) and 256 (unstaged by the plan)."""
    import torch

    from ndt_2d_tpu_torch.kernels import descriptors as k10
    P = pts.shape[1]
    one = torch.zeros(1, P, 2, device=dev)
    one[0, :, 0] = torch.linspace(0.5, 11.5, P, device=dev)
    one[0, :, 1] = 0.1 * one[0, :, 0]
    p_ = torch.cat([pts[:300], one, pts[:1]]).contiguous()
    m_ = torch.cat([msk[:300], torch.ones(1, P, dtype=torch.bool,
                                          device=dev),
                    torch.zeros(1, P, dtype=torch.bool, device=dev)])
    bins = k10.bin_points(p_, m_, 12.0)
    twin = k10.spectra_twin(bins, 12.0)
    for warps, staged in SPECTRA_FORMS:
        out = spectra_arm(bins, warps, staged)()
        torch.cuda.synchronize()
        require(torch.equal(out, twin), f"K10 spectra at {warps} warps a "
                f"block, tables staged {staged}: differs from the twin")
    require(float(twin[-1].abs().sum()) == 0.0, "K10 spectra: the empty "
            "scan's descriptor is not zero")
    for S in (1, 5, 512, TABLE_SCANS):
        b = k10.bin_points(pts[:S].contiguous(), msk[:S].contiguous(), 12.0)
        require(torch.equal(k10.spectra(b, 12.0), k10.spectra_twin(
            b, 12.0)), f"K10 spectra of {S} scans differ from the twin")
    shapes = ((62, 4, 32), (64, 6, 32), (64, 4, 40), (128, 4, 32),
              (256, 4, 32))
    for shape in shapes:
        b = k10.bin_points(p_, m_, 12.0, *shape)
        want = k10.spectra_twin(b, 12.0, *shape)
        require(torch.equal(k10.spectra(b, 12.0, *shape), want),
                f"K10 spectra at {shape} differ from the twin")
        if shape[0] <= 128:
            require(torch.equal(spectra_arm(b, 8, 0, 12.0, shape)(), want),
                    f"K10 spectra at {shape}, tables unstaged, differ from "
                    "the twin")
    plans = {S: tuple(k10.spectra_plan(S)[:2]) for S in (512, TABLE_SCANS)}
    print(f"[3] K10 spectra at block shapes (warps, staged) "
          f"{list(SPECTRA_FORMS)} over {p_.shape[0]} scans with an empty and "
          f"a one-sector scan, the plan's at 1, 5, 512 and {TABLE_SCANS} "
          f"scans ({plans}) and sectors x rings x bins {list(shapes)}: "
          f"bitwise the twin")


def phase_k10(cfg, bag, dev):
    """K10 over the office bag's point table at a 2000-keyframe graph's
    padded capacity, then the search at an odd shape."""
    check_search_odd(dev)
    pts, msk = office_table(cfg, bag, dev)
    check_bins_shapes(pts, msk, dev)
    check_spectra_shapes(pts, msk, dev)
    return check_descriptors(
        pts, msk, 12.0, cfg.descriptor_bins, len(bag),
        cfg.global_search_limit, cfg.rolling_depth + 1,
        f"a {TABLE_SCANS}-slot table of the office bag",
        f"_table{TABLE_SCANS}")[0]


def twin_chain(coarse, fine, poses, points, pmask, wmask, rmax, qp, qm, qn,
               st):
    """``match_scan_batch_multi_coarse_fine`` on the plain twins: (fine
    starts, scores, corrections, covariances)."""
    from ndt_2d_tpu_torch.kernels import candidate_gather as k6
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.kernels import newton as k7
    from ndt_2d_tpu_torch.matching import matcher, newton

    def stage(cfg, start):
        mod = matcher.search_kernel(cfg)
        grid, tables = k1.build_windows_twin(
            poses, points, pmask, wmask, rmax, cfg.ndt_resolution,
            cfg.grid_cells_x, cfg.grid_cells_y)
        res, _ = mod.match_rows_twin(
            cfg, grid, tables, qp, qm, qn, start,
            *matcher._search_offsets(cfg, qp.device))
        out = k2.pack(res)
        if cfg.refine_iterations > 0:
            out = k7.refine_rows_twin(
                cfg, newton.with_row_grid_axes(grid, True), qp, qm, qn,
                start, out, cfg.refine_iterations)
        return k2.unpack(out)
    st2 = st + stage(coarse, st).correction
    res = stage(fine, st2)
    return st2, res.score, res.correction, res.covariance


def check_chain(coarse, fine, args, out, what):
    """A coarse-to-fine dispatch's outputs bitwise against the twins' chain
    on the same CUDA inputs."""
    import torch
    twin = twin_chain(coarse, fine, *args)
    torch.cuda.synchronize()
    for name, a, b in zip(("fine starts", "scores", "corrections",
                           "covariances"), out, twin):
        require(torch.equal(a, b), f"{what}: {name} differ from the twins'")


def phase_chain(cfg, bag, dev):
    """The coarse-to-fine chain at config-6 shapes: bitwise against the
    twins' chain, launch counts, and no host synchronization inside."""
    import torch

    from ndt_2d_tpu_torch.matching import matcher
    cm, gm = cfg.coarse_scan_matcher, cfg.global_scan_matcher
    rows = coarse_rows(cfg, bag, dev)
    args = (*rows[:4], 12.0, *rows[4:])
    matcher.match_scan_batch_multi_coarse_fine(cm, gm, *args)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    # Any synchronizing call (a host read of a device value) raises here.
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = matcher.match_scan_batch_multi_coarse_fine(cm, gm, *args)
        flat = torch.cat([out[1][:, None], out[2], out[3].reshape(-1, 9),
                          out[0]], 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host = flat.cpu()              # the one device-to-host copy
    counts = read_counts()
    want = {"ndt_build": 2, "candidate_gather": 1, "candidate_scores": 1,
            "newton": 1 if gm.refine_iterations > 0 else 0}
    require(all(counts[k] == v for k, v in want.items()),
            f"the chain launched {counts}, expected {want}")
    check_chain(cm, gm, args, out, "coarse-to-fine chain")
    shift = float((out[0] - rows[7])[:, :2].abs().max())
    ms = cuda_ms(lambda: matcher.match_scan_batch_multi_coarse_fine(
        cm, gm, *args), 10)
    print(f"[3] coarse-to-fine chain: {COARSE_ROWS} rows, fine starts, "
          f"scores, corrections and covariances bitwise equal to the twins' "
          f"chain; one launch each of K1 (coarse), K6, K1 (fine), K2 and K7 "
          f"with no host synchronization, then one device-to-host copy of "
          f"{tuple(host.shape)}; the coarse stage moved a start by up to "
          f"{shift:.2f} m; {int((out[1] < -0.2).sum())} rows score below "
          f"-0.2; {ms:.3f} ms a chunk")


class ConfirmRecorder:
    """Counts the chunks of both confirmation entries during a session and
    keeps the first coarse-to-fine dispatch for the twin replay."""

    def __init__(self):
        from ndt_2d_tpu_torch.matching import matcher
        self.mod = matcher
        self.real = (matcher.match_scan_batch_multi,
                     matcher.match_scan_batch_multi_coarse_fine)
        self.near = self.far = self.far_rows = 0
        self.first = None

    def fine(self, *args, **kw):
        self.near += 1
        return self.real[0](*args, **kw)

    def coarse_fine(self, coarse, fine, *args, **kw):
        out = self.real[1](coarse, fine, *args, **kw)
        self.far += 1
        self.far_rows += int(args[3].any(dim=1).sum())
        if self.first is None:
            self.first = (coarse, fine,
                          [a.clone() if hasattr(a, "clone") else a
                           for a in args], [o.clone() for o in out])
        return out

    def __enter__(self):
        self.mod.match_scan_batch_multi = self.fine
        self.mod.match_scan_batch_multi_coarse_fine = self.coarse_fine
        return self

    def __exit__(self, *exc):
        (self.mod.match_scan_batch_multi,
         self.mod.match_scan_batch_multi_coarse_fine) = self.real


class DescriptorRecorder:
    """Counts a session's descriptor passes and keeps the last one's
    inputs and results (the pass over the most keyframes) for the replay
    at the session's own table shape."""

    def __init__(self):
        from ndt_2d_tpu_torch.parallel import loop_search
        self.mod = loop_search
        self.real = (loop_search.descriptors, loop_search.search_all_pairs)
        self.passes = 0
        self.last = None

    def descriptors(self, points, point_mask, range_max, n_bins):
        self.table = self.real[0](points, point_mask, range_max, n_bins)
        self.args = (points, point_mask, range_max, n_bins)
        return self.table

    def search_all_pairs(self, table, valid, k, rolling_exclude):
        out = self.real[1](table, valid, k=k, rolling_exclude=rolling_exclude)
        self.passes += 1
        self.last = (*self.args, int(valid.sum()), k, rolling_exclude,
                     self.table, *out)
        return out

    def __enter__(self):
        self.mod.descriptors = self.descriptors
        self.mod.search_all_pairs = self.search_all_pairs
        return self

    def __exit__(self, *exc):
        self.mod.descriptors, self.mod.search_all_pairs = self.real


def drift_bag(scans=DRIFT_SCANS):
    """The 3x-drift office bag of benchmarks/loop_closure_pr.py:279-281
    (odom_scale 3.0)."""
    from ndt_2d_tpu_torch.io.bag import record_synthetic
    return record_synthetic("office", scans, n_beams=N_BEAMS, range_max=12.0,
                            seed=1, odom_trans_noise=0.06,
                            odom_rot_noise=0.012)


def phase_descriptor_session(cfg, bag, dev, tag, name, need_far=False):
    """A descriptor-mode session on the card (config 6, or the drift
    recipe): gates, counts and the replay of its first coarse dispatch."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    from ndt_2d_tpu_torch.utils import metrics
    mapper = Mapper(cfg, device=dev)
    # Closures accepted from far rows: the drift class is the mapper's own
    # test at decision time, before the acceptance moves the pose.
    far_accepts = []
    gate = mapper._apply_gate

    def counting_gate(idx, i, *rest):
        far = mapper._is_far(idx, i)
        ok = gate(idx, i, *rest)
        if ok and far:
            far_accepts.append((idx, i))
        return ok
    mapper._apply_gate = counting_gate
    with ConfirmRecorder() as rec, DescriptorRecorder() as drec:
        reset_counts()
        t0 = time.perf_counter()
        stats, grid, dt, _, acc_flags, _ = run_session(cfg, bag, dev,
                                                       mapper=mapper)
        wall = time.perf_counter() - t0
        launches = read_counts()
    acc = stats["scans_accepted"]
    st = mapper.stats
    used = bag.truth[np.nonzero(acc_flags)[0]]
    online = stats["ate_rmse_m"]
    final = metrics.ate_rmse(mapper.graph.poses[:acc], used)
    aligned = metrics.ate_rmse_aligned(mapper.graph.poses[:acc], used)
    odom = metrics.ate_rmse(bag.odom, bag.truth)
    far_accepted = len(far_accepts)
    require(st.loop_closures_accepted >= 1, f"{name}: no closure accepted")
    require(st.optimizations >= 1, f"{name}: no optimization ran")
    require(np.isfinite(final) and final < odom,
            f"{name}: final ATE {final} not below odometry's {odom}")
    require(st.far_rows_pruned > 0, f"{name}: no far row was pruned")
    require(not need_far or far_accepted >= 1,
            f"{name}: no closure accepted from a far row")
    want = {"candidate_gather": rec.far, "newton": rec.near + rec.far,
            "candidate_scores": acc - 1 + rec.near + rec.far,
            "ndt_build": acc - 1 + rec.near + 2 * rec.far,
            "score_points": acc - 1}
    require(all(launches[k] == v for k, v in want.items()),
            f"{name}: launches {launches}, expected {want}")
    require(rec.far >= 1 and drec.passes >= 1
            and all(launches[k] == drec.passes for k in DESCRIPTOR_KERNELS)
            and launches["normal_blocks"] + launches["dense_normal_system"]
            + launches["pcg_normal_system"]
            >= 1 and launches["raymarch"] >= 1,
            f"{name}: K6, K4 or K5 never launched, or K10 not once a pass "
            f"({drec.passes}): {launches}")
    require(int((grid.data == 100).sum()) > 0, f"{name}: no occupied cells")
    timing = st.timer.summary()
    ms = float(np.median(dt[acc_flags][4:]) * 1e3)
    print(f"{tag} {name}: {acc}/{len(bag)} scans accepted, "
          f"{st.loop_closures_accepted} closures accepted "
          f"({far_accepted} from far rows), {st.loop_closures_rejected} "
          f"rejected, {st.optimizations} optimizations; far rows: "
          f"{rec.far_rows} dispatched in {rec.far} chunks, "
          f"{st.far_rows_pruned} pruned, {st.far_rows_cache_skipped} "
          f"cache-skipped; {rec.near} near chunks, "
          f"{st.confirm_rows_reused} rows reused, {drec.passes} "
          f"descriptor passes; ATE online {online:.4f} final {final:.4f} m "
          f"(aligned {aligned:.4f}, odometry {odom:.4f}); {ms:.3f} ms per "
          f"accepted scan (median), loop_closure "
          f"{timing['loop_closure']['mean_ms']:.3f} ms x "
          f"{timing['loop_closure']['count']}, optimize "
          f"{timing['optimize']['mean_ms']:.3f} ms x "
          f"{timing['optimize']['count']}; session {wall:.2f} s; launches "
          f"{launches}")
    coarse, fine, args, out = rec.first
    check_chain(coarse, fine, args, out, f"{name} replay")
    print(f"{tag} replay of the first coarse-to-fine dispatch "
          f"({int(args[3].any(dim=1).sum())} rows padded to "
          f"{args[0].shape[0]}) through the twins' chain: fine starts, "
          f"scores, corrections and covariances bitwise equal")
    # K10 at the session's own shape: the last descriptor pass replayed.
    pts, msk, rmax, n_bins, n_valid, k, ex, table, idx, sims = drec.last
    timing, t2, i2, s2 = check_descriptors(
        pts, msk, rmax, n_bins, n_valid, k, ex,
        f"its last descriptor pass", tag=tag)
    require(torch.equal(t2, table) and torch.equal(i2, idx)
            and torch.equal(s2, sims),
            f"{name}: the replayed descriptor pass differs from the "
            "session's")
    return launches, timing


def merge_sessions(dev):
    """Two sessions of the symmetry-broken office (the world and the
    drives of tests/test_merge.py, at 106 keyframes each, 6 cm apart)
    mapped on the card with clean odometry: A drives the bottom corridor
    from its left corner to the middle, B from the right to the middle the
    opposite way, so B's frame is A's turned by pi.  Both stay out of the
    right-hand corners, which the 4-fold symmetric ring aliases onto A's.
    Returns (truth A, truth B, graph A, graph B)."""
    import numpy as np

    from ndt_2d_tpu_torch.config import MapperConfig, ScanMatcherConfig
    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    from ndt_2d_tpu_torch.utils import sim
    world = np.concatenate([sim.make_office_world(16.0),
                            np.asarray([[[1.0, 13.0], [3.0, 15.0]]])],
                           axis=0)
    m = ScanMatcherConfig(grid_cells_x=160, grid_cells_y=160)
    cfg = MapperConfig(local_scan_matcher=m, global_scan_matcher=m,
                       max_points_per_scan=512, loop_closure_every=10**9,
                       minimum_travel_distance=0.05)
    n = 106
    truth_a = np.stack([np.linspace(2.0, 8.0, n), np.full(n, 2.0),
                        np.zeros(n)], axis=-1)
    truth_b = np.stack([np.linspace(12.0, 6.0, n), np.full(n, 2.2),
                        np.full(n, np.pi)], axis=-1)
    graphs = []
    for truth in (truth_a, truth_b):
        mapper = Mapper(cfg, device=dev)
        for t in range(n):
            msg = sim.scan_at_pose(world, truth[t], n_beams=300,
                                   range_max=14.0, noise=0.01,
                                   rng=np.random.default_rng(t))
            mapper.process_scan(msg, truth[t])
        graphs.append(mapper.graph)
    return truth_a, truth_b, graphs[0], graphs[1]


def phase_merge(dev):
    """``merge_maps`` of two >= 100-keyframe sessions on the card."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.core import pose as pose_ops
    from ndt_2d_tpu_torch.mapping import merge
    from ndt_2d_tpu_torch.utils import metrics
    truth_a, truth_b, ga, gb = merge_sessions(dev)
    require(ga.num_scans >= 100 and gb.num_scans >= 100,
            f"sessions of {ga.num_scans} and {gb.num_scans} keyframes")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = merge.merge_maps(ga, gb, range_max=14.0, score_threshold=-0.25,
                           device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()

    def f32(p):
        return torch.tensor(np.asarray(p), dtype=torch.float32)
    t_true = pose_ops.compose(pose_ops.inverse(f32(truth_a[0])),
                              f32(truth_b[0])).numpy()
    err_xy = float(np.hypot(*(res.transform[:2] - t_true[:2])))
    err_th = abs(float(pose_ops.normalize_angle(
        f32(res.transform[2] - t_true[2]))))
    rel_b = metrics.relative_to_first(truth_b)
    truth_b_in_a = pose_ops.compose(f32(t_true), f32(rel_b)).numpy()
    ate = metrics.ate_rmse(res.graph.poses[ga.num_scans:], truth_b_in_a)
    require(res.pairs_accepted >= 2, f"merge accepted {res.pairs_accepted} "
            f"of {res.pairs_checked} pairs")
    require(err_xy < 0.15 and err_th < 0.05,
            f"merge transform off by {err_xy} m, {err_th} rad")
    require(ate < 0.2, f"merged ATE {ate} m")
    require(res.graph.num_scans == ga.num_scans + gb.num_scans
            and res.optimized, "merged graph incomplete or not optimized")
    require(launches["candidate_gather"] == launches["candidate_scores"]
            >= res.pairs_accepted and launches["descriptors"] == 2
            and launches["descriptor_spectra"] == 2
            and launches["descriptor_search"] == 1
            and launches["normal_blocks"] + launches["dense_normal_system"]
            + launches["pcg_normal_system"]
            >= 1,
            f"merge launches {launches}")
    print(f"[4j] merge: sessions of {ga.num_scans} and {gb.num_scans} "
          f"keyframes, {res.pairs_checked} pairs checked, "
          f"{res.pairs_accepted} accepted; transform "
          f"{[round(float(v), 3) for v in res.transform]} (truth "
          f"{[round(float(v), 3) for v in t_true]}): off by {err_xy:.4f} m, "
          f"{err_th:.4f} rad; merged ATE {ate:.4f} m; {wall:.2f} s; launches "
          f"{launches}")
    return launches


def odom_deltas(odom):
    """Consecutive odometry motions in the previous robot frame, float32
    [T - 1, 3] (the mapper's ``_odom_delta``)."""
    import numpy as np
    d = odom[1:, :2] - odom[:-1, :2]
    c0, s0 = np.cos(odom[:-1, 2]), np.sin(odom[:-1, 2])
    dth = np.arctan2(np.sin(odom[1:, 2] - odom[:-1, 2]),
                     np.cos(odom[1:, 2] - odom[:-1, 2]))
    return np.stack([c0 * d[:, 0] + s0 * d[:, 1],
                     -s0 * d[:, 0] + c0 * d[:, 1], dth], 1).astype(np.float32)


def phase_k3_pose(cfg, win, query, bag3, dev):
    """K3's single-pose launch (a block a pose) and its composed entry on
    config 3's window and config 8's (G = 4): at the configs' beams and at
    1, 31, 32, 33, 100, 128, 129, 1000 and 1025, each score bitwise its
    twin and equal to the batched launch's row (a warp a pose) at the same
    pose; the composed entry's score and pose bitwise
    ``score_composed_twin`` (``compose_twin`` then the twin's score) and
    the plain entry's score at that pose, also across the +-pi wrap;
    times."""
    import torch

    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.kernels import score_points as k3
    mc8 = config8(cfg).local_scan_matcher
    g8, _ = k1.build_window(**win, range_max=15.0,
                            cell_size=mc8.ndt_resolution,
                            width=mc8.grid_cells_x, height=mc8.grid_cells_y,
                            grids=4)
    a8 = (g8, mc8.grid_cells_x, mc8.grid_cells_y, mc8.laser_max_beams,
          query["points"], query["point_mask"], query["num_points"],
          query["pose"])
    a3, (prev3, delta3) = config3_window(bag3, dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    beams = (1, 31, 32, 33, 100, 128, 129, 1000, 1025)
    n_checked = 0
    for name, a in (("config 3", a3), ("config 8 (G = 4)", a8)):
        g, W, H, mb, pts, msk, n, pose = a
        poses = (pose + torch.randn(8, 3, generator=gen, device=dev)
                 * 0.05).contiguous()
        for b in (mb, *beams):
            one = k3.score_at_pose(g, W, H, b, pts, msk, n, pose)
            twin = k3.score_at_pose_twin(g, W, H, b, pts, msk, n, pose)
            rows = torch.stack([k3.score_at_pose(g, W, H, b, pts, msk, n,
                                                 poses[i])
                                for i in range(poses.shape[0])])
            batch = k3.score_batch(g, W, H, b, pts, msk, n, poses)
            torch.cuda.synchronize()
            require(torch.equal(one, twin), f"K3 {name}, {b} beams: "
                    f"{float(one)} differs from the twin's {float(twin)}")
            require(torch.equal(rows, batch), f"K3 {name}, {b} beams: a "
                    "block-per-pose score differs from the warp-per-pose "
                    "row at the same pose")
            n_checked += 1
        cases = [(prev3, delta3)] if name == "config 3" else [
            (pose - torch.tensor([0.1, 0.02, 0.01], device=dev),
             torch.tensor([0.1, 0.02, 0.01], device=dev))]
        cases += [(torch.tensor([float(pose[0]), float(pose[1]), th],
                                device=dev),
                   torch.tensor([0.05, 0.01, dth], device=dev))
                  for th, dth in ((3.13, 0.03), (-3.13, -0.03))]
        for prev, delta in cases:
            sc, p = k3.score_composed(g, W, H, mb, pts, msk, n, prev, delta)
            sct, pt = k3.score_composed_twin(g, W, H, mb, pts, msk, n, prev,
                                             delta)
            plain = k3.score_at_pose(g, W, H, mb, pts, msk, n, p)
            torch.cuda.synchronize()
            require(torch.equal(p, pt) and torch.equal(sc, sct),
                    f"K3 composed {name}: ({float(sc)}, {p.tolist()}) "
                    f"differs from the twin's ({float(sct)}, {pt.tolist()})")
            require(torch.equal(sc, plain), f"K3 composed {name}: the "
                    "score differs from the plain entry's at its pose")
            require(abs(float(p[2])) <= 3.1416, f"K3 composed {name}: "
                    f"heading {float(p[2])} not wrapped")
    print(f"[3] K3 a block a pose: {n_checked} (window, beams) cases at G "
          f"= 1 and G = 4 bitwise equal to the twin and to the batched "
          f"launch's rows at 8 poses; the composed entry's score and pose "
          f"bitwise the twin's and the plain entry's at that pose, also "
          f"across +-pi")
    g, W, H, mb, pts, msk, n, pose = a3
    # compose: prev and delta read, the pose written (36 bytes), ~70
    # operations.
    moved, ops = cost_score_points(office_config().local_scan_matcher, g,
                                   pts, msk, n, pose[None])
    return {"score_points_compose": timed(
        0.0, cuda_ms(lambda: k3.score_composed(*a3[:7], prev3, delta3), 20),
        cuda_ms(lambda: k3.score_composed_twin(*a3[:7], prev3, delta3), 5),
        moved + 36, ops + 70)}


def phase_k13(cfg, win, query, bag, dev):
    """K13 over a 200-step chain of the config-2 corridor's odometry
    deltas on config 2's window (10 slots of 512 points), each step K3's
    composed entry at the window's grid (the start pose), then the window
    append with a lattice-sized correction and a new scan: every start
    pose, corrected pose and the whole window after every step bitwise
    against the twins' chain (``score_composed_twin``,
    ``window_append_twin``) and against the eager operations that
    appended before K13 did (``eager_window_append``); the pose-only
    append (localization) bitwise the twin's; times, the eager operations
    as the library arm."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.kernels import pose_chain as k13
    from ndt_2d_tpu_torch.kernels import score_points as k3
    from ndt_2d_tpu_torch.matching import matcher
    mc = cfg.local_scan_matcher
    g, _ = k1.build_window(**win, range_max=15.0,
                           cell_size=mc.ndt_resolution,
                           width=mc.grid_cells_x, height=mc.grid_cells_y)
    scan = (g, mc.grid_cells_x, mc.grid_cells_y, mc.laser_max_beams,
            query["points"], query["point_mask"], query["num_points"])
    deltas = odom_deltas(bag.odom)
    rng = np.random.default_rng(13)
    corrs = rng.uniform(-0.05, 0.05, deltas.shape).astype(np.float32)
    dt = torch.tensor(deltas, device=dev)
    ct = torch.tensor(corrs, device=dev)
    D, P = win["points"].shape[:2]
    new_pts = torch.tensor(rng.normal(0, 5, (len(deltas), P, 2)).astype(
        np.float32), device=dev)
    new_msk = torch.tensor(rng.random((len(deltas), P)) < 0.8, device=dev)
    start = torch.tensor(bag.odom[0], dtype=torch.float32, device=dev)

    def eager(pose, corr, w, pts, msk):
        return eager_window_append(w, pose, corr, pts, msk)
    arms = {"kernel": (k3.score_composed, k13.window_append),
            "twin": (k3.score_composed_twin, k13.window_append_twin),
            "eager": (k3.score_composed_twin, eager)}
    wins = {k: matcher.make_window(D, P, dev) for k in arms}
    prevs = {k: start for k in arms}
    fields = ("poses", "points", "point_mask", "mask")
    for i in range(len(deltas)):
        out = {}
        for k, (score, append) in arms.items():
            _, pose = score(*scan, prevs[k], dt[i])
            prevs[k] = append(pose, ct[i], wins[k], new_pts[i], new_msk[i])
            out[k] = pose
        for k in ("twin", "eager"):
            require(torch.equal(out["kernel"], out[k]), f"K13 chain step "
                    f"{i}: the start pose differs from the {k} arm's")
            require(torch.equal(prevs["kernel"], prevs[k]), f"K13 chain "
                    f"step {i}: the corrected pose differs from the {k} "
                    "arm's")
            require(all(torch.equal(getattr(wins["kernel"], f),
                                    getattr(wins[k], f)) for f in fields),
                    f"K13 chain step {i}: the window differs from the {k} "
                    "arm's")
    w = wins["kernel"]
    require(bool(w.mask.all()) and torch.equal(w.poses[-1], prevs["kernel"])
            and torch.equal(w.points[0], new_pts[-D]),
            "K13 chain: the window does not hold the last scans")
    a = k13.window_append(start, ct[0])
    require(torch.equal(a, k13.window_append_twin(start, ct[0])),
            "K13 pose-only append differs from the twin")
    print(f"[3] K13 window append: {len(deltas)} steps of the config-2 "
          f"odometry on a {D} x {P} window (K3's composed start pose, then "
          f"the append), start poses, corrected poses and the whole window "
          f"after every step bitwise equal to the twins' chain and to the "
          f"eager shift; the pose-only append bitwise; final pose "
          f"{[round(float(v), 4) for v in prevs['kernel']]}")
    wt = matcher.make_window(D, P, dev)
    args = (start, ct[0], wt, new_pts[0], new_msk[0])
    # Each input read once, each output written once: the window (D x (3
    # floats + P x 9 bytes + 1)) twice, the new scan, pose, correction and
    # the new pose; three additions.
    moved = 2 * nbytes(*(getattr(wt, f) for f in fields)) + nbytes(
        new_pts[0], new_msk[0]) + 36
    return {"window_append": timed(
        0.0, cuda_ms(lambda: k13.window_append(*args), 100),
        cuda_ms(lambda: k13.window_append_twin(*args), 50), moved, 3,
        library_ms=cuda_ms(lambda: eager(*args), 50))}


def corridor_scans(bag, cfg, ts):
    """The projected points and masks of scans ``ts`` of ``bag``."""
    import numpy as np

    from ndt_2d_tpu_torch.mapping import laser
    out = [laser.project_scan(bag[t][0], bag.range_max, np.zeros(3), False,
                              None, cfg.max_points_per_scan) for t in ts]
    return np.stack([p for p, _ in out]), np.stack([m for _, m in out])


# The parent's lattice entry (csrc/correlative.cu, kept beside the tables
# form as this script's comparison arm; no path of the package launches it).
PARENT_MATCH_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_float]
                     + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                     + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                     + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                     + [ctypes.c_int] + [ctypes.c_void_p] + [ctypes.c_int]
                     + [ctypes.c_void_p] * 4)


def parent_match_rows(mc, fields, origins, points, point_mask, nums, poses,
                      dths, dls, num: int = 0, with_scores: bool = False):
    """The parent's lattice search over R rows (``k11.match_rows``'
    arguments; ``nums`` None: ``num`` points every row): a block a tile,
    two divisions a term, then ``lattice::finalize`` as a second launch.
    Returns the [R, 13] rows, or (rows, scores [R, A, L, L])."""
    import torch

    from ndt_2d_tpu_torch.kernels import _build
    from ndt_2d_tpu_torch.kernels.candidate_gather import TILE
    dev = points.device
    R, P = points.shape[0], points.shape[1]
    A, L = dths.shape[0], dls.shape[0]
    partial = torch.empty(R, A * -(-L * L // TILE), 12, dtype=torch.float32,
                          device=dev)
    out = torch.empty(R, 13, dtype=torch.float32, device=dev)
    scores = (torch.empty(R, A, L, L, dtype=torch.float32, device=dev)
              if with_scores else None)
    p = _build.ptr
    err = _build.function("ndt2d_correlative_match", PARENT_MATCH_ARGS)(
        p(fields), p(origins), float(mc.ndt_resolution), mc.grid_cells_x,
        mc.grid_cells_y, p(points), p(point_mask), R, P,
        None if nums is None else p(nums), int(num),
        int(mc.laser_max_beams), p(poses), p(dths), A, p(dls), L,
        p(partial), p(out), None if scores is None else p(scores),
        _build.stream_ptr(dev))
    _build.check(err, "correlative_match (parent)")
    return (out, scores) if with_scores else out


def parent_match(mc, field, origin, points, point_mask, num_points: int,
                 pose, dths, dls, with_scores: bool = False):
    """The parent's lattice search of one scan (``k11.match``'s arguments):
    its [1, 13] row, or (row, scores [A, L, L])."""
    res = parent_match_rows(mc, field[None], origin[None], points[None],
                            point_mask[None], None, pose[None], dths, dls,
                            num_points, with_scores)
    return (res[0], res[1][0]) if with_scores else res


def field_arm(plan, args):
    """A K11 field build of ``args`` (``build_field``'s) in the form
    ``plan`` names, through a launcher of its own: a comparison or timing
    arm beside the plan the package takes."""
    from ndt_2d_tpu_torch.kernels import correlative as k11
    S, P = args[1].shape[:2]
    launcher = k11.FieldLauncher(plan, S, P, float(args[4]), float(args[5]),
                                 args[0].device)
    return lambda: launcher.run(*args[:4])


def seven_steps(W: int, H: int):
    """K11's seven-step form of a [H, W] field (a memset and six
    launches)."""
    from ndt_2d_tpu_torch.kernels import correlative as k11
    return k11.FieldPlan(W, H, 0, 0, 0, 0)


def bins_arm(pts, msk, threads: int, rmax: float = 12.0):
    """K10's bins of ``pts`` / ``msk`` at blocks of ``threads``, through
    the C entry (``bin_points`` takes ``bins_plan``'s): a comparison or
    timing arm.  Returns the call."""
    import torch

    from ndt_2d_tpu_torch.kernels import _build
    from ndt_2d_tpu_torch.kernels import descriptors as k10
    S, P = msk.shape
    fn = _build.function("ndt2d_descriptor_bins", k10._ARGS)

    def call():
        out = k10.Bins(*(torch.empty(*shape, device=pts.device)
                         for shape in ((S, 64), (S, 64), (S, 4 * 64),
                                       (S, 32), (S,))))
        p = _build.ptr
        _build.check(fn(p(pts), p(msk), S, P, rmax, 64, 4, 32, threads,
                        *[p(t) for t in out], _build.stream_ptr(pts.device)),
                     "descriptor_bins")
        return out
    return call


def k11_shape(mc, win, query, odom, pts, msk, ks, rmax, dev, what):
    """K11's three entries at one shape: the field of window ``win``, the
    lattice of ``mc`` and the point score of ``query``, bitwise against the
    twins and reproducible; ROWS lattice rows (window k .. k + D - 1 of
    ``odom``/``pts``/``msk``, query k + D from its odometry pose shifted
    by (0.02, -0.01, 0.01), k in ``ks``) bitwise equal to their R = 1
    launches.  Returns the timing entries."""
    import dataclasses

    import torch

    from ndt_2d_tpu_torch.kernels import correlative as k11
    from ndt_2d_tpu_torch.matching.matcher import _search_offsets
    W, H = mc.grid_cells_x, mc.grid_cells_y
    S, P = win["points"].shape[:2]
    fargs = (win["poses"], win["points"], win["point_mask"],
             win["window_mask"], rmax, mc.ndt_resolution, W, H)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = k11.field_plan(W, H, sms, S, S * P)
    seven = field_arm(seven_steps(W, H), fargs)
    f, o = k11.build_field(*fargs)
    ft, ot = k11.build_field_twin(*fargs)
    f2, o2 = k11.build_field(*fargs)
    f7, o7 = seven()
    torch.cuda.synchronize()
    require(plan.cluster, f"K11 field plan {plan} ({what})")
    require(torch.equal(f, ft) and torch.equal(o, ot),
            f"K11 field differs from its twin ({what})")
    require(torch.equal(f, f2) and torch.equal(o, o2),
            f"K11 field not bitwise reproducible ({what})")
    require(torch.equal(f, f7) and torch.equal(o, o7),
            f"K11 cluster field differs from the seven-step form ({what})")
    ops = graph_nodes(lambda: k11.build_field(*fargs))
    ops7 = graph_nodes(seven)
    require(ops == ["kernel"]
            and sorted(ops7) == ["kernel"] * 6 + ["memset"],
            f"K11 field ({what}): device operations {ops}, seven-step "
            f"{ops7}")
    ids = k11.cell_ids(win["poses"], win["points"], win["point_mask"],
                       win["window_mask"], o, mc.ndt_resolution, W, H)
    field_graph = graph_ms(lambda: k11.build_field(*fargs), 20)
    seven_graph = graph_ms(seven, 20)
    print(f"[3] K11 field, {what}: one cluster of {plan.n} CTAs x "
          f"{plan.threads} threads, stripes of {plan.h} rows ({plan.smem} "
          f"shared bytes a CTA), field and origin bitwise the twin, "
          f"reproducible and bitwise the seven-step form; one device "
          f"operation a build (graph nodes {ops}; seven-step: "
          f"{len(ops7)}); in a CUDA graph {field_graph:.5f} ms "
          f"[seven-step {seven_graph:.5f}]")
    out = {"correlative_field": timed(
        0.0, cuda_ms(lambda: k11.build_field(*fargs), 20),
        cuda_ms(lambda: k11.build_field_twin(*fargs), 5),
        nbytes(*win.values(), f, o) + 28,
        15 * S * P + 30 * W * H,
        cuda_ms(lambda: torch.bincount(ids, minlength=W * H), 20),
        graph_ms=(field_graph, None))}

    dths, dls = _search_offsets(mc, dev)
    margs = (mc, f, o, query["points"], query["point_mask"],
             query["num_points"], query["pose"], dths, dls)
    row, sc = k11.match(*margs, with_scores=True)
    rest, sct = k11.match_twin(*margs)
    prow, psc = parent_match(*margs, with_scores=True)
    torch.cuda.synchronize()
    check_match(row, sc, one_row(rest), sct, f"K11 lattice ({what})")
    check_match(row, sc, *k11.match(*margs, with_scores=True),
                f"K11 lattice reproducibility ({what})")
    check_match(row, sc, prow, psc, f"K11 lattice against the parent's "
                f"two launches ({what})")
    # Beams whose cells do not fit their window read the field as the
    # parent did: offsets in descending order (no beam takes a window) and
    # offsets 0.6 cell apart (beams past their window beside beams that
    # reach no cell); and a lattice whose tables fill the block's shared
    # memory beside its static part (40 x 57 x 57, offsets 0.05 cell
    # apart); each bitwise the twin and the parent.
    fine = dataclasses.replace(mc, search_linear_resolution=0.05
                               * mc.ndt_resolution)
    full = (fine,) + margs[1:7] + (
        dths[:40].contiguous(),
        (torch.arange(57, dtype=torch.float32, device=dev) - 28)
        * float(fine.search_linear_resolution))
    for name, m2 in (("descending offsets",
                      margs[:8] + (dls.flip(0).contiguous(),)),
                     ("offsets 0.6 cell apart", margs[:8] + (dls * float(
                         0.6 * mc.ndt_resolution
                         / mc.search_linear_resolution),)),
                     ("tables filling shared memory", full)):
        r2, s2 = k11.match(*m2, with_scores=True)
        t2, ts2 = k11.match_twin(*m2)
        p2, ps2 = parent_match(*m2, with_scores=True)
        torch.cuda.synchronize()
        check_match(r2, s2, one_row(t2), ts2, f"K11 lattice, {name} "
                    f"({what})")
        check_match(r2, s2, p2, ps2, f"K11 lattice, {name}, against the "
                    f"parent's launches ({what})")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tight = k11.lattice_plan(full[7].numel(), full[8].numel(), 1,
                             mc.laser_max_beams, sms, 0.05)
    print(f"[5] K11 lattice ({what}), tables filling shared memory: "
          f"{tight.smem} dynamic bytes beside the kernel's static "
          f"{4 * k11.static_words(tight.threads)} (blocks of "
          f"{tight.threads}, {tight.chunk} beams a chunk), bitwise the twin "
          f"and the parent")
    A, L = dths.numel(), dls.numel()
    plan = k11.lattice_plan(A, L, 1, mc.laser_max_beams, sms,
                            mc.search_linear_resolution / mc.ndt_resolution)
    new_ms = cuda_ms(lambda: k11.match(*margs), 20)
    new_graph = graph_ms(lambda: k11.match(*margs), 20)
    par_ms = cuda_ms(lambda: parent_match(*margs), 20)
    par_graph = graph_ms(lambda: parent_match(*margs), 20)
    new_host = host_us(lambda: k11.match(*margs), 20, sync=True)
    par_host = host_us(lambda: parent_match(*margs), 20,
                       sync=True)
    # One match is one kernel: the nodes of a CUDA graph of one call (a
    # profiler window lost its records in one run of 13, and all three
    # retakes in another).
    before = k11.match_launches
    kernels = graph_nodes(lambda: k11.match(*margs))
    require(k11.match_launches == before + 2 and kernels == ["kernel"],
            f"K11 lattice ({what}): one match enqueued {kernels}")
    print(f"[5] K11 lattice, {what} ({A}x{L}x{L} x "
          f"{mc.laser_max_beams} beams; blocks of {plan.threads}, "
          f"{plan.per} tiles a thread, {A * plan.groups} blocks, tables "
          f"{plan.nx}+{L} x {plan.chunk} beams, windows {plan.cx}x"
          f"{plan.cy}): one launch {new_ms:.4f} ms, in a CUDA graph "
          f"{new_graph:.5f} ms, host {new_host:.1f} us [parent, two "
          f"launches: {par_ms:.4f} ms, in a CUDA graph {par_graph:.5f} ms, "
          f"host {par_host:.1f} us] (graph nodes of a match: {kernels})")

    sargs = (mc, f, o, query["points"], query["point_mask"],
             query["num_points"], query["pose"][None])
    u, ut = k11.score_batch(*sargs), k11.score_batch_twin(*sargs)
    require(torch.equal(u, ut), f"K11 point score {float(u[0])} differs "
            f"from the twin's {float(ut[0])} ({what})")
    spts, smask, used = used_beams(mc, *sargs[3:6])
    keys = cells_read(mc, o, mc.ndt_resolution, spts, smask, sargs[6])
    score_cost = (4 * keys.numel() + used * 9 + 16, 12 * used)
    out["correlative_score"] = timed(
        0.0, cuda_ms(lambda: k11.score_batch(*sargs), 20),
        cuda_ms(lambda: k11.score_batch_twin(*sargs), 5), *score_cost,
        graph_ms=(graph_ms(lambda: k11.score_batch(*sargs), 20), None))
    # The point score in the lattice's launch (the mapper's match): the
    # rows unchanged, the score bitwise the standalone kernel's and the
    # twin's, reproducible; timed as the main path launches it.
    frow, fu = k11.match(*margs, with_unc=True)
    frow2, fu2 = k11.match(*margs, with_unc=True)
    torch.cuda.synchronize()
    require(torch.equal(frow, row) and torch.equal(frow2, row),
            f"K11 lattice with its point score: rows differ ({what})")
    require(torch.equal(fu, u) and torch.equal(fu, ut)
            and torch.equal(fu2, fu),
            f"K11 fused point score {float(fu[0])} differs from "
            f"point_scores' {float(u[0])} or the twin's ({what})")
    fused_ms = cuda_ms(lambda: k11.match(*margs, with_unc=True), 20)
    fused_graph = graph_ms(lambda: k11.match(*margs, with_unc=True), 20)
    fused_host = host_us(lambda: k11.match(*margs, with_unc=True), 20,
                         sync=True)
    two = (lambda: (k11.match(*margs), k11.score_batch(*sargs)))
    two_graph = graph_ms(two, 20)
    fused_ops = graph_nodes(lambda: k11.match(*margs, with_unc=True))
    require(fused_ops == ["kernel"], f"K11 lattice with its point score "
            f"({what}): one call enqueued {fused_ops}")
    lattice_cost = cost_lattice_tables(mc, o, *margs[3:])
    out["correlative_match"] = timed(
        0.0, fused_ms, cuda_ms(lambda: (k11.match_twin(*margs),
                                        k11.score_batch_twin(*sargs)), 3),
        *sum_costs([lattice_cost, score_cost]),
        graph_ms=(fused_graph, None))
    print(f"[3] K11 point score in the lattice's launch, {what}: "
          f"{float(fu[0]):.6f}, bitwise point_scores and the twin, "
          f"reproducible, rows bitwise the lattice alone; one device "
          f"operation ({fused_ops}); lattice + score {fused_ms:.4f} ms, in "
          f"a CUDA graph {fused_graph:.5f} ms, host {fused_host:.1f} us "
          f"[lattice alone {new_graph:.5f}, lattice then point_scores "
          f"{two_graph:.5f}]; point_scores alone "
          f"{out['correlative_score']['ms']:.4f} ms, graph "
          f"{out['correlative_score']['graph_ms'][0]:.5f}; bounds: score "
          f"{out['correlative_score']['bound_ms']:.8f} ms, lattice + score "
          f"{out['correlative_match']['bound_ms']:.6f} ms (by "
          f"{out['correlative_match']['bound_by']}); library: none (no "
          f"call scores a lattice or gathers a field's mean)")

    R, D = len(ks), win["points"].shape[0]
    fields, origins = [], []
    for k in ks:
        fr, orr = k11.build_field(
            torch.tensor(odom[k:k + D], dtype=torch.float32, device=dev),
            torch.tensor(pts[k:k + D], device=dev),
            torch.tensor(msk[k:k + D], device=dev),
            torch.ones(D, dtype=torch.bool, device=dev), rmax,
            mc.ndt_resolution, W, H)
        fields.append(fr)
        origins.append(orr)
    qi = [k + D for k in ks]
    rows = (torch.stack(fields), torch.stack(origins),
            torch.tensor(pts[qi], device=dev),
            torch.tensor(msk[qi], device=dev),
            torch.tensor(msk[qi].sum(1), dtype=torch.int32, device=dev),
            torch.tensor(odom[qi] + [0.02, -0.01, 0.01],
                         dtype=torch.float32, device=dev))
    many = k11.match_rows(mc, *rows, dths, dls)
    require(torch.equal(many, parent_match_rows(mc, *rows, dths, dls)),
            f"K11 lattice rows differ from the parent's launches ({what})")
    many_u, uncs = k11.match_rows(mc, *rows, dths, dls, with_unc=True)
    require(torch.equal(many_u, many), f"K11 lattice rows with their point "
            f"scores differ from the rows alone ({what})")
    for r in range(R):
        one = k11.match(mc, rows[0][r], rows[1][r], rows[2][r], rows[3][r],
                        int(rows[4][r]), rows[5][r], dths, dls)
        require(torch.equal(many[r:r + 1], one),
                f"K11 lattice row {r} differs from its R = 1 launch ({what})")
        ur = k11.score_batch(mc, rows[0][r], rows[1][r], rows[2][r],
                             rows[3][r], int(rows[4][r]), rows[5][r][None])
        require(torch.equal(uncs[r:r + 1], ur), f"K11 fused point score of "
                f"row {r} differs from point_scores' ({what})")
    print(f"[3] K11 correlative, {what}: field of {S} scans x {P} points on "
          f"{W}x{H} cells ({int((ids >= 0).sum())} hits, peak-normalized), "
          f"lattice of {sc.numel()} candidates (score {float(row[0, 0]):.5f}, "
          f"correction {[round(float(x), 4) for x in row[0, 1:4]]}) and "
          f"point score {float(u[0]):.5f} bitwise equal to their twins and "
          f"reproducible, the lattice bitwise the parent's two launches "
          f"(also with descending offsets and offsets 0.6 cell apart, "
          f"beams past their windows); "
          f"{R} lattice rows bitwise equal to their R = 1 launches and to "
          f"the parent's ({int((many[:, 0] < -0.3).sum())} score below "
          f"-0.3), their fused point scores bitwise point_scores' at each "
          f"row's pose")
    return out


def phase_k11(cfg, bag, win, query, dev):
    """K11 at two shapes.  Config 2's (the 10-scan window of 512 points,
    192x192 cells of 0.25 m, 80x21x21 candidates x 100 beams; rows from
    every other scan of the corridor), timed as ``correlative_*_config2``.
    Then the shape the correlative box drive of [4o] gives it, whose
    launches the kernels' line counts: its 160x160-cell local grid and
    widened lattice (+-0.15 m at 0.0075 m, 80x40x40 candidates x 100
    beams) over 10 box scans of 360 beams to 12 m, rows from consecutive
    scans of a box bag."""
    D = cfg.rolling_depth
    ks = [2 * r for r in range(ROWS)]
    pts, msk = corridor_scans(bag, cfg, range(max(ks) + D + 1))
    out = {f"{k}_config2": v for k, v in k11_shape(
        cfg.local_scan_matcher, win, query, bag.odom, pts, msk, ks,
        bag.range_max, dev, "config 2").items()}

    box_cfg, box, bpts, bmsk, bwin, bquery = box_window(D, dev)
    out.update(k11_shape(box_cfg.local_scan_matcher, bwin, bquery, box.odom,
                         bpts, bmsk, list(range(ROWS)), box.range_max, dev,
                         "box drive's shape"))
    return out


def edge_window(width: int, height: int, seed: int, dev, S: int = 3,
                P: int = 256):
    """A window for K11's field on a [height, width] grid of 0.25 m cells
    from range_max 4: scan 0 at the origin, heading 0, with one point
    exactly on each row's lower edge (rows -2 .. H + 1) and the rest off
    the grid on every side; the other scans turned, random points; a tenth
    of the points masked."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    poses = np.zeros((S, 3), np.float32)
    poses[1:] = rng.uniform(-1.0, 1.0, (S - 1, 3))
    pts = rng.uniform(-4.0, 4.0, (S, P, 2)).astype(np.float32)
    rows = np.arange(min(height + 4, P)) - 2
    pts[0, :len(rows), 1] = -4.0 + rows * 0.25
    pts[0, len(rows):] = rng.uniform(-5.0, -3.0 + max(width, height) * 0.25,
                                     (P - len(rows), 2))
    mask = rng.random((S, P)) > 0.1

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t(poses), t(pts), t(mask), torch.ones(S, dtype=torch.bool,
                                                  device=dev)


def phase_k11_fields(dev):
    """K11's field past the main path's two shapes, each field and origin
    bitwise its twin and the seven-step form: the global matcher's 128 x
    128, a non-square 200 x 150 (15 stripes of 10 rows) and 202 x 150
    (forced to 8 CTAs, H % 8 != 0; rows not a multiple of 4 cells), 512 x
    512 (16 CTAs of 155,712 bytes), 1024 x 352
    (16 stripes of 22 rows, 229,440 bytes) and 1024 x 353 (past 16
    stripes' shared memory: the seven-step form by the plan), the
    box window at 128 x 128 with cells of 0.25 m and 0.35 m (the exact
    reciprocal and the divisions), an empty window and a window without a
    live scan; and poses at +0 and -0 with range_max 0 (a zero minimum's sign:
    the origin bitwise the seven-step form, its bits printed beside the
    twin's)."""
    import torch

    from ndt_2d_tpu_torch.kernels import correlative as k11
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def bits(t):
        return t.view(torch.int32)

    def check(args, W, H, what, n=None, cluster=True, twin_origin=True):
        S, P = args[1].shape[:2]
        fargs = (*args, W, H)
        if n is None:  # the package's own plan
            plan = k11.field_plan(W, H, sms, S, S * P)
            f, o = k11.build_field(*fargs)
        else:
            plan = k11.field_stripes(W, H, n, S)
            f, o = field_arm(plan, fargs)()
        require(plan.cluster == cluster, f"K11 field {what}: plan {plan}")
        ft, ot = k11.build_field_twin(*fargs)
        f7, o7 = field_arm(seven_steps(W, H), fargs)()
        torch.cuda.synchronize()
        pairs = [(f, ft), (f, f7), (o, o7)] + ([(o, ot)] if twin_origin
                                               else [])
        require(all(torch.equal(bits(a), bits(b)) for a, b in pairs),
                f"K11 field {what} ({W} x {H}, {plan}) differs from its "
                "twin or the seven-step form")
        return plan, o, ot

    done = []
    for W, H, n in ((128, 128, None), (200, 150, None), (202, 150, 8),
                    (512, 512, None), (1024, 352, None), (1024, 353, None)):
        args = (*edge_window(W, H, W + H, dev), 4.0, 0.25)
        plan = check(args, W, H, "on stripe edges", n, H != 353)[0]
        done.append(f"{W}x{H}: n {plan.n}, h {plan.h}")
    D = 10
    _, _, _, _, bwin, _ = box_window(D, dev)
    box = (bwin["poses"], bwin["points"], bwin["point_mask"],
           bwin["window_mask"], 12.0, 0.25)
    check(box, 128, 128, "of the box window")
    check(box[:5] + (0.35,), 128, 128, "of the box window, 0.35 m cells")
    empty = (bwin["poses"], bwin["points"],
             torch.zeros_like(bwin["point_mask"]), bwin["window_mask"],
             12.0, 0.25)
    check(empty, 160, 160, "of an empty window")
    dead = (bwin["poses"], bwin["points"], bwin["point_mask"],
            torch.zeros_like(bwin["window_mask"]), 12.0, 0.25)
    check(dead, 160, 160, "without a live scan")
    # The kernels' fminf puts -0 below +0 in any order; the twin's
    # torch.amin keeps the sign the poses' order gives it, so with range_max
    # 0 the origins may part by the sign of 0 (the fields do not).
    signs = []
    for first in (True, False):
        poses, pts, mask, wmask = edge_window(96, 40, 5, dev)
        poses[:, :2] = 0.0
        poses[0 if first else -1, :2] = -0.0
        _, o, ot = check((poses, pts, mask, wmask, 0.0, 0.25), 96, 40,
                         "from poses at -0 and +0, range_max 0",
                         twin_origin=False)
        signs.append(f"-0 {'first' if first else 'last'}: kernels "
                     f"{bits(o).tolist()}, twin {bits(ot).tolist()}")
    print(f"[3] K11 field past the main path's shapes ({'; '.join(done)}; "
          f"the box window at 128 x 128 with cells of 0.25 and 0.35 m, an "
          f"empty window, no live scan): "
          f"field and origin bitwise the twin and the seven-step form; "
          f"poses at -0 and +0 with range_max 0: fields bitwise, origins "
          f"bitwise the seven-step form, origin bits "
          f"{'; '.join(signs)}")


def box_window(D: int, dev):
    """The correlative box drive's shape: its config, a box bag of ROWS +
    D scans of 360 beams to 12 m, their points and masks, the window of
    its first D scans and the query scan D from its odometry pose shifted
    by (0.02, -0.01, 0.01)."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.io.bag import record_synthetic
    box_cfg = correlative_box_config()
    box = record_synthetic("box", ROWS + D, n_beams=360, range_max=12.0,
                           seed=4)
    bpts, bmsk = corridor_scans(box, box_cfg, range(len(box)))
    odom = box.odom.astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    bwin = dict(poses=t(odom[:D]), points=t(bpts[:D]),
                point_mask=t(bmsk[:D]),
                window_mask=torch.ones(D, dtype=torch.bool, device=dev))
    bquery = dict(points=t(bpts[D]), point_mask=t(bmsk[D]),
                  num_points=int(bmsk[D].sum()),
                  pose=t((box.odom[D] + [0.02, -0.01, 0.01]).astype(
                      np.float32)))
    return box_cfg, box, bpts, bmsk, bwin, bquery


def pipelined(cfg, inflight=8):
    import dataclasses
    return dataclasses.replace(cfg, max_inflight=inflight)


def k13_launches(launches) -> int:
    return launches["window_append"]


def check_pipelined_step(launches, steps: int, what: str) -> None:
    """A pipelined step launches K3 once with the compose folded in (no
    plain K3, no separate compose) and K13's window append once."""
    require(launches["score_points_compose"] == steps
            and launches["score_points"] == 0,
            f"{what}: K3 launched {launches['score_points_compose']} times "
            f"composed and {launches['score_points']} plain, expected "
            f"{steps} and 0")
    require(k13_launches(launches) == steps,
            f"{what}: K13 launched {k13_launches(launches)} times, expected "
            f"{steps}")


def phase_pipelined_config2(cfg, bag, dev, sync_numbers, sync_poses):
    """Config 2 at max_inflight = 8: the dispatch loop (every
    process_scan, the drains of older steps included) under CUDA
    sync-debug "error", so no call in it synchronizes the stream or the
    device or copies to the host blocking; a drain waits on its step's
    event alone.  Every scan accepted, ATE below odometry's, one K1 + K2,
    one composed K3 (no plain K3) and one K13 launch a pipelined scan, the
    first 20 graph poses within 0.03 m of the synchronous run's."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.mapping import runtime
    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    from ndt_2d_tpu_torch.utils import metrics
    pcfg = pipelined(cfg)
    mapper = Mapper(pcfg, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    times, futures = [], []
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        for t, (msg, odom) in enumerate(bag):
            t1 = time.perf_counter()
            res = mapper.process_scan(msg, odom,
                                      runtime.sweep_end_odom(bag, t, msg))
            times.append(time.perf_counter() - t1)
            futures.append(res)
        dispatch = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    mapper.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    acc = sum(r.accepted for r in futures)
    require(acc == len(bag), f"pipelined config 2 accepted {acc} scans")
    est = np.stack([futures[0].pose] + [r.pose_future.result()
                                        for r in futures[1:]])
    ate = metrics.ate_rmse(est, bag.truth)
    odom = metrics.ate_rmse(bag.odom, bag.truth)
    require(np.isfinite(ate) and ate < odom,
            f"pipelined config 2 ATE {ate} not below odometry's {odom}")
    for k in ("ndt_build", "candidate_scores"):
        require(launches[k] == acc - 1, f"pipelined {k} launched "
                f"{launches[k]} times, expected {acc - 1}")
    check_pipelined_step(launches, acc - 1, "pipelined config 2")
    g = mapper.graph
    dev20 = float(np.abs(g.poses[:20] - sync_poses[:20]).max())
    require(dev20 <= 0.03, f"pipelined first 20 poses {dev20} from the "
            "synchronous run's")
    # Where the two chains part: the first scan more than 5 mm apart.  A
    # lattice edge argmin that flips along the featureless corridor moves
    # a pose along it (x) only: across it and in heading the arms stay
    # within test_mapper_e2e.py's 0.03 m and 0.01 rad.
    diff = g.poses - sync_poses[:acc]
    apart = np.hypot(diff[:, 0], diff[:, 1])
    split = int(np.argmax(apart > 0.005)) if (apart > 0.005).any() else acc
    dx, dy, dth = np.abs(diff).max(0)
    require(dy <= 0.03 and dth <= 0.01, f"pipelined config 2 parts from "
            f"the synchronous run across the corridor by {dy} m or in "
            f"heading by {dth} rad")
    require(g.num_constraints == acc - 1, "pipelined constraints")
    ms = float(np.median(times[4:]) * 1e3)
    print(f"[4k] config 2 at max_inflight=8: {acc}/{len(bag)} scans "
          f"accepted, the dispatch loop under sync-debug \"error\" (drains "
          f"wait on their step's event); ATE {ate:.4f} m (synchronous "
          f"{sync_numbers['ate']:.4f}, odometry {odom:.4f}); first 20 "
          f"poses within {dev20:.2e} of the synchronous run's, all within "
          f"5 mm up to scan {split}, at most {dx:.4f} m apart along the "
          f"corridor, {dy:.4f} m across it and {dth:.5f} rad in heading; "
          f"{ms:.3f} ms/scan median (synchronous {sync_numbers['ms']:.3f}); "
          f"dispatch loop {dispatch:.3f} s, session {wall:.3f} s; launches "
          f"{launches}")
    return launches, dict(ms=ms, ate=ate, poses=g.poses.copy())


def phase_pipelined_office(cfg, bag, dev, sync):
    """Config 3 at max_inflight = 8 (the office loop with radius loop
    closure): >= 1 closure, >= 1 optimization, final ATE below odometry's;
    printed beside the synchronous run's numbers."""
    import numpy as np

    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    from ndt_2d_tpu_torch.utils import metrics
    mapper = Mapper(pipelined(cfg), device=dev)
    reset_counts()
    t0 = time.perf_counter()
    stats, grid, dt, _, acc_flags, _ = run_session(cfg, bag, dev,
                                                   mapper=mapper)
    wall = time.perf_counter() - t0
    launches = read_counts()
    acc = stats["scans_accepted"]
    st = mapper.stats
    used = bag.truth[np.nonzero(acc_flags)[0]]
    final = metrics.ate_rmse(mapper.graph.poses[:acc], used)
    odom = metrics.ate_rmse(bag.odom, bag.truth)
    require(st.loop_closures_accepted >= 1, "pipelined config 3: no closure")
    require(st.optimizations >= 1, "pipelined config 3: no optimization")
    require(np.isfinite(final) and final < odom, f"pipelined config 3: "
            f"final ATE {final} not below odometry's {odom}")
    check_pipelined_step(launches, acc - 1, "pipelined config 3")
    ms = float(np.median(dt[acc_flags][4:]) * 1e3)
    print(f"[4l] config 3 at max_inflight=8: {acc}/{len(bag)} scans "
          f"accepted, {st.loop_closures_accepted} closures accepted "
          f"({sync['closures']} synchronous), {st.loop_closures_rejected} "
          f"rejected, {st.optimizations} optimizations "
          f"({sync['optimizations']}); ATE online "
          f"{stats['ate_rmse_m']:.4f} final {final:.4f} m (synchronous "
          f"{sync['final']:.4f}, odometry {odom:.4f}); {ms:.3f} ms per "
          f"accepted scan (synchronous {sync['ms']:.3f}); session "
          f"{wall:.2f} s; launches {launches}")
    return launches


class AsyncStepRecorder:
    """Keeps the arguments and resulting state of a filter's first
    ``keep`` ``step_async`` calls."""

    def __init__(self, flt, keep: int):
        self.flt, self.keep, self.steps = flt, keep, []
        self.real = flt.step_async

    def __call__(self, matcher, control, points, point_mask, num_points,
                 **kw):
        handle = self.real(matcher, control, points, point_mask, num_points,
                           **kw)
        if len(self.steps) < self.keep:
            self.steps.append(((control, points, point_mask, num_points),
                               self.flt.particles.clone(),
                               self.flt._n_dev.clone()))
        return handle

    def __enter__(self):
        self.flt.step_async = self
        return self

    def __exit__(self, *exc):
        del self.flt.step_async


def track_deferred(loc, scans, rel):
    """Run (t, msg, odom) scans through a pipelined ``loc``; after the
    flush, the position errors of the accepted scans against ``rel``, their
    indices and the seconds of every process_scan."""
    import numpy as np
    futs, times = [], []
    for t, msg, odom in scans:
        t0 = time.perf_counter()
        res = loc.process_scan(msg, odom)
        times.append(time.perf_counter() - t0)
        if res.accepted:
            futs.append((t, res.pose_future))
    loc.flush()
    errs = [float(np.hypot(*(f.result()[:2] - rel[t][:2]))) for t, f in futs]
    return (np.asarray(errs), np.asarray([t for t, _ in futs]),
            np.asarray(times))


def phase_pipelined_config4(path_map, dev, sync_ms):
    """Config 4 at max_inflight = 8: the particle filter (mean error <=
    0.10 m and below odometry's; its first three steps replayed through
    ``step`` by a filter of the same seed with the same controls give the
    same particles and n_active bitwise), then scan-match localization
    (mean error <= 0.12 m)."""
    import dataclasses

    import numpy as np
    import torch

    from ndt_2d_tpu_torch.io.bag import record_synthetic
    from ndt_2d_tpu_torch.utils import metrics
    mapping, cfg = config4_configs()
    loc_bag = record_synthetic("box", 150, n_beams=360, seed=7,
                               odom_trans_noise=0.01)
    rel = metrics.relative_to_first(loc_bag.truth)
    odom_rel = metrics.relative_to_first(loc_bag.odom)
    scans = [(t, msg, odom) for t, (msg, odom) in enumerate(loc_bag)
             if t > 0]
    init = (rel[0], np.diag([0.04, 0.04, 0.01]), loc_bag.truth[0])
    reset_counts()
    loc = localizer(pipelined(cfg), path_map, dev, 3)
    loc.set_initial_pose(*init)
    with AsyncStepRecorder(loc.filter, 3) as rec:
        errs, ts, times = track_deferred(loc, scans, rel)
    torch.cuda.synchronize()
    launches = read_counts()
    steps = len(errs)
    odom_err = float(np.mean(np.hypot(*(odom_rel[ts, :2] - rel[ts, :2]).T)))
    mean_err = float(np.mean(errs))
    require(steps >= 50, f"pipelined PF accepted {steps} of {len(scans)} "
            "scans")
    one_device_pf_launches(launches, steps, "pipelined PF")
    require(np.isfinite(errs).all() and mean_err <= 0.10,
            f"pipelined PF mean error {mean_err} > 0.10 m")
    require(mean_err < odom_err, f"pipelined PF mean error {mean_err} not "
            f"below odometry's {odom_err}")
    # The same seed and controls through the synchronous entry point.
    ref = localizer(cfg, path_map, dev, 3)
    ref.set_initial_pose(*init)
    ref._ensure_matchers(loc_bag.range_max)
    for i, (args, particles, n) in enumerate(rec.steps):
        ref.filter.step(ref.global_matcher, *args)
        require(torch.equal(ref.filter.particles, particles)
                and ref.filter.n_active == int(n[0]),
                f"pipelined PF step {i} differs from step() with the same "
                "seed and controls")
    ms = float(np.median(times[2:]) * 1e3)
    print(f"[4m] config 4 at max_inflight=8: PF {PARTICLES} particles over "
          f"{steps} accepted of {len(scans)} scans: mean position error "
          f"{mean_err:.4f} m, final "
          f"{float(errs[-1]):.4f} m (odometry {odom_err:.4f} m), {ms:.3f} "
          f"ms/scan median (synchronous {sync_ms['pf']:.3f}); its first "
          f"{len(rec.steps)} steps replayed through step() give the same "
          f"particles and n_active {[int(n[0]) for _, _, n in rec.steps]} "
          f"bitwise; launches {launches}")

    reset_counts()
    sm = localizer(pipelined(dataclasses.replace(mapping,
                                                 enable_mapping=False)),
                   path_map, dev, 0)
    sm.set_initial_pose(*init)
    serrs, _, stimes = track_deferred(sm, scans, rel)
    sm_launches = read_counts()
    sm_mean = float(np.mean(serrs))
    require(len(serrs) == steps and sm_mean <= 0.12,
            f"pipelined scan-match: {len(serrs)} scans, mean error "
            f"{sm_mean} m")
    check_pipelined_step(sm_launches, len(serrs), "pipelined scan-match")
    sms = float(np.median(stimes[2:]) * 1e3)
    print(f"[4m] scan-match at max_inflight=8: mean position error "
          f"{sm_mean:.4f} m, final {float(serrs[-1]):.4f} m, {sms:.3f} "
          f"ms/scan median (synchronous {sync_ms['sm']:.3f}); launches "
          f"{sm_launches}")


def config9():
    """BASELINE config 9 as benchmarks/run_benchmarks.py:732-761 sets it
    up: the simlab CARMEN log at range_max 10, max_inflight 8, gate 1.0,
    3-scan regions, both search positions, Geman-McClure, the global
    matcher at 0.35 m cells with 8 Newton iterations."""
    import dataclasses

    from ndt_2d_tpu_torch.config import (
        MapperConfig, ScanMatcherConfig, SolverConfig)
    m = ScanMatcherConfig(grid_cells_x=192, grid_cells_y=192)
    g = ScanMatcherConfig(ndt_resolution=0.35, search_linear_size=0.15,
                          search_linear_resolution=0.01,
                          search_angular_size=0.05, grid_cells_x=160,
                          grid_cells_y=160, refine_iterations=8)
    return MapperConfig(
        local_scan_matcher=m, global_scan_matcher=g, max_points_per_scan=512,
        global_search_size=4.0, optimization_node_limit=10,
        loop_closure_every=20, minimum_travel_distance=0.3, max_range=10.0,
        max_inflight=8, loop_closure_gate_scale=1.0,
        loop_closure_region_size=3, loop_search_positions="both",
        solver=dataclasses.replace(SolverConfig(),
                                   robust_loss="geman_mcclure"))


def phase_config9(dev):
    """BASELINE config 9 (run_benchmarks.py:700-815): the committed simlab
    log through the port's CARMEN importer, mapped pipelined as the
    reference runs it.  Gates: >= 1 closure, >= 1 optimization, final ATE
    below the odometry ATE of the same run."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.io import carmen
    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    from ndt_2d_tpu_torch.utils import metrics
    bag = carmen.load_carmen(os.path.join(ROOT, "datasets",
                                          "simlab.clf.gz"), range_max=10.0)
    truth = np.load(os.path.join(ROOT, "datasets",
                                 "simlab_truth.npz"))["truth"]
    n = len(bag)
    require(len(truth) == n, f"simlab truth {len(truth)} vs log {n}")
    mapper = Mapper(config9(), device=dev)
    reset_counts()
    torch.cuda.synchronize()
    est, used, times = [], [], []
    t0 = time.perf_counter()
    for t in range(n):
        msg, odom = bag[t]
        t1 = time.perf_counter()
        res = mapper.process_scan(msg, odom)
        if res.accepted:
            times.append(time.perf_counter() - t1)
            est.append(res.pose if res.pose is not None else res.pose_future)
            used.append(truth[t])
    mapper.flush()
    mapper.loop_closure()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    est = np.stack([e if isinstance(e, np.ndarray) else e.result()
                    for e in est])
    used = np.asarray(used)
    st = mapper.stats
    closures = int(mapper.graph.constraint_switchable.sum())
    online = metrics.ate_rmse(est, used)
    final_poses = mapper.graph.poses[:len(used)]
    final = metrics.ate_rmse(final_poses, used)
    aligned = metrics.ate_rmse_aligned(final_poses, used)
    odom = metrics.ate_rmse(bag.odom[:n], truth[:n])
    require(closures >= 1, "config 9: no loop closure")
    require(st.optimizations >= 1, "config 9: no optimization")
    require(np.isfinite(final) and final < odom,
            f"config 9: final ATE {final} not below odometry's {odom}")
    require(k13_launches(launches) >= len(used) - 1
            and launches["score_points_compose"] >= len(used) - 1,
            f"config 9: K13 / composed K3 launches {launches}")
    ms = float(np.median(times[3:]) * 1e3)
    timing = st.timer.summary()
    print(f"[4n] config 9 (simlab, {n} scans through the CARMEN importer, "
          f"max_inflight=8): {len(used)} accepted, {closures} closures, "
          f"{st.loop_closures_rejected} rejected, {st.optimizations} "
          f"optimizations; ATE online {online:.4f} final {final:.4f} m "
          f"(aligned {aligned:.4f}, odometry {odom:.4f}); {ms:.3f} ms per "
          f"accepted scan (median), loop_closure "
          f"{timing['loop_closure']['mean_ms']:.3f} ms x "
          f"{timing['loop_closure']['count']}, optimize "
          f"{timing['optimize']['mean_ms']:.3f} ms x "
          f"{timing['optimize']['count']}; session {wall:.2f} s; launches "
          f"{launches}")


def correlative_box_config():
    """The mapper configuration of tests/test_correlative.py:68-99's box
    drive: the correlative matcher with a wider local lattice (+-0.15 m at
    0.0075 m) on 160x160 cells."""
    import dataclasses

    from ndt_2d_tpu_torch.config import MapperConfig, ScanMatcherConfig
    g = ScanMatcherConfig(grid_cells_x=128, grid_cells_y=128)
    local = dataclasses.replace(g, grid_cells_x=160, grid_cells_y=160,
                                search_linear_size=0.15,
                                search_linear_resolution=0.0075)
    return MapperConfig(scan_matcher_type="correlative",
                        local_scan_matcher=local, global_scan_matcher=g,
                        max_points_per_scan=512, loop_closure_every=10**9)


def correlative_box(dev, scores: bool = False):
    """The box drive of tests/test_correlative.py:68-99 with the
    correlative matcher: (accepted, scans, ATE, odometry ATE, the accepted
    poses' sha256), with ``scores`` also the sha256 of every scan's
    uncorrected and matched scores."""
    import numpy as np

    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    from ndt_2d_tpu_torch.utils import metrics, sim
    world = sim.make_box_world(10.0, 8.0)
    n = 14
    truth = np.stack([np.linspace(3.0, 6.5, n), np.full(n, 4.0),
                      np.zeros(n)], -1)
    odom = sim.drift_odometry(truth, 0.04, 0.012, seed=3)
    mapper = Mapper(correlative_box_config(), device=dev)
    est, tru, both = [], [], []
    for t in range(n):
        msg = sim.scan_at_pose(world, truth[t], n_beams=360, range_max=12.0,
                               noise=0.01, rng=np.random.default_rng(t))
        res = mapper.process_scan(msg, odom[t])
        both.append((res.uncorrected_score, res.matched_score))
        if res.accepted:
            est.append(res.pose)
            tru.append(truth[t])
    out = (len(est), n, metrics.ate_rmse(np.asarray(est), np.asarray(tru)),
           metrics.ate_rmse(odom, truth), poses_digest(np.asarray(est)))
    return out + (poses_digest(np.asarray(both)),) if scores else out


def phase_correlative(cfg, bag, dev):
    """The correlative matcher in the mapper: the box drive of the JAX
    test (>= 12 of 14 accepted, ATE below odometry's and < 0.15 m, one
    field build, lattice search and point score a matched scan), then the
    config-2 corridor with scan_matcher_type="correlative" and the widened
    local lattice, printed and not gated."""
    import dataclasses

    import numpy as np
    reset_counts()
    acc, n, ate, odom, digest, sdigest = correlative_box(dev, scores=True)
    launches = read_counts()
    require(acc >= 12, f"correlative box: {acc} of {n} accepted")
    require(ate < odom and ate < 0.15,
            f"correlative box ATE {ate} (odometry {odom})")
    # The point score rides in the lattice's launch: no standalone score
    # launch.
    for k in ("correlative_field", "correlative_match"):
        require(launches[k] == acc - 1, f"correlative box: {k} launched "
                f"{launches[k]} times, expected {acc - 1}")
    require(launches["correlative_score"] == 0, f"correlative box: "
            f"correlative_score launched {launches['correlative_score']} "
            "times, expected 0 (the score is the lattice launch's)")
    require(launches["ndt_build"] == 0 and launches["candidate_scores"] == 0,
            f"correlative box ran an NDT kernel: {launches}")
    print(f"[4o] correlative matcher, box drive: {acc}/{n} accepted, ATE "
          f"{ate:.4f} m (odometry {odom:.4f}), poses sha256 {digest}, "
          f"scores sha256 {sdigest}; launches {launches}")
    local = dataclasses.replace(cfg.local_scan_matcher,
                                search_linear_size=0.15,
                                search_linear_resolution=0.0075)
    ccfg = dataclasses.replace(cfg, scan_matcher_type="correlative",
                               local_scan_matcher=local)
    reset_counts()
    stats, _, dt, _, _, _ = run_session(ccfg, bag, dev)
    corridor = read_counts()
    print(f"[4o] correlative matcher, config-2 corridor (local lattice "
          f"+-0.15 m at 0.0075 m, not gated): {stats['scans_accepted']}/"
          f"{len(bag)} accepted, ATE {stats['ate_rmse_m']:.4f} m "
          f"(odometry {stats['odom_ate_rmse_m']:.4f}), "
          f"{float(np.median(dt[4:]) * 1e3):.3f} ms/scan median; launches "
          f"{corridor}")
    return launches


def profile_sessions(dev, warmup: int = 20) -> None:
    """``--profile``: the mapping sessions of [4a], [4f], [4c], [4g] and
    [4h], the pipelined ones of [4k], [4l] and [4n], and config 4's filter
    synchronous and pipelined ([4d], [4m]), each with ``torch.profiler``
    over every scan after the first ``warmup`` and the final flush; one
    JSON line each: wall and device-busy ms per accepted scan (busy = the
    union of the kernel and copy intervals), the device's idle share, and
    the kernels by device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ndt_2d_tpu_torch.io import carmen
    from ndt_2d_tpu_torch.io.bag import record_synthetic
    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    from ndt_2d_tpu_torch.utils import metrics
    bag, cfg2, _, _, _ = inputs(dev)
    bag3 = office_bag()
    bag9 = carmen.load_carmen(os.path.join(ROOT, "datasets",
                                           "simlab.clf.gz"), range_max=10.0)
    loc_bag = record_synthetic("box", 150, n_beams=360, seed=7,
                               odom_trans_noise=0.01)
    tmp = tempfile.mkdtemp()
    map4 = os.path.join(tmp, "box_map.npz")
    map_and_save(config4_configs()[0],
                 record_synthetic("box", 150, n_beams=360, seed=2), map4, dev)
    _, pf4 = config4_configs()
    init = (metrics.relative_to_first(loc_bag.truth)[0],
            np.diag([0.04, 0.04, 0.01]), loc_bag.truth[0])

    def mapping(cfg):
        return lambda: Mapper(cfg, device=dev)

    def filtering(cfg):
        def make():
            loc = localizer(cfg, map4, dev, 3)
            loc.set_initial_pose(*init)
            return loc
        return make
    sessions = (
        ("config 2", mapping(cfg2), bag),
        ("config 2 pipelined", mapping(pipelined(cfg2)), bag),
        ("config 8", mapping(config8(cfg2)), bag),
        ("config 3", mapping(office_config()), bag3),
        ("config 3 pipelined", mapping(pipelined(office_config())), bag3),
        ("office recipe", mapping(office_recipe_config()), bag3),
        ("config 6", mapping(config6()), bag3),
        ("config 9 (pipelined)", mapping(config9()), bag9),
        ("config 4 filter", filtering(pf4), loc_bag),
        ("config 4 filter pipelined", filtering(pipelined(pf4)), loc_bag))
    for name, make, b in sessions:
        mapper = make()
        scans = list(b)
        for msg, odom in scans[:warmup]:
            mapper.process_scan(msg, odom)
        mapper.flush()
        torch.cuda.synchronize()
        accepted = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for msg, odom in scans[warmup:]:
                accepted += mapper.process_scan(msg, odom).accepted
            mapper.flush()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans, kernels = [], {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            spans.append((e.time_range.start, e.time_range.end))
            k = kernels.setdefault(e.name[:60], [0.0, 0])
            k[0] += (e.time_range.end - e.time_range.start) / 1e3
            k[1] += 1
        busy, end = 0.0, float("-inf")
        for s, e in sorted(spans):
            busy += max(0.0, e - max(s, end))
            end = max(end, e)
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:14]
        print(json.dumps({
            "session": name, "scans": len(scans) - warmup,
            "accepted": accepted,
            "wall_ms_per_accepted": wall * 1e3 / max(accepted, 1),
            "device_ms_per_accepted": busy / 1e3 / max(accepted, 1),
            "idle_share": 1.0 - busy / 1e6 / wall,
            "kernels_ms": {k: [round(v[0], 3), v[1]] for k, v in top}}))
    import shutil
    shutil.rmtree(tmp)


# --- K12: the multi-device mesh path ---------------------------------------
K12_KERNELS = ("candidate_partials", "candidate_finalize",
               "candidate_gather_partials", "candidate_gather_finalize",
               "rank_sum")
MESH_SCANS = 600          # config 10's bag (benchmarks/mesh_slam_bench.py:48)
# A mesh session's final ATE against one device's: JAX's office criterion
# (tests/test_mesh_mapper.py:100).
MESH_ATE_GAP = 0.08


def config10():
    """BASELINE config 10 (benchmarks/mesh_slam_bench.py:48-62): the
    600-scan office bag (600 beams at 12 m, seed 1, odometry noise
    0.02/0.004) and config 3's settings (local 192^2, global 160^2 of
    0.35 m with +-0.15 m / +-0.05 rad, 512 points, global_search_size 4.0,
    optimization_node_limit 10, loop_closure_every 20,
    minimum_travel_distance 0.3)."""
    from ndt_2d_tpu_torch.io.bag import record_synthetic
    bag = record_synthetic("office", MESH_SCANS, n_beams=N_BEAMS,
                           range_max=12.0, seed=1, odom_trans_noise=0.02,
                           odom_rot_noise=0.004)
    return office_config(), bag


def split_search(kern, mc, rows, dths, dls, shards, twin=False):
    """The lattice search of ``rows`` (grid, tables, points, mask, counts,
    poses) as a (shards, 1) mesh computes it, in one process: each rank's
    block of angles through K12's partials (or their twin), concatenated in
    rank order, then the finalize."""
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_gather as k6
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.parallel import matcher as pmatcher
    extra = () if kern is k2 else (k6.TILE, k6.candidate_scores_gather)
    parts = []
    for s in range(shards):
        a0, n = pmatcher.angle_block(dths.shape[0], shards, s)
        if not n:
            continue
        if twin:
            parts.append(k2.partial_rows_twin(mc, *rows, dths, dls, a0, n,
                                              *extra))
        else:
            parts.append(kern.partial_rows(mc, *rows, dths, dls, a0, n))
    p = torch.cat(parts, 1)
    if twin:
        return k2.finalize_rows_twin(mc, p, rows[4], dths, dls)
    return kern.finalize_rows(mc, p, rows[4], dths, dls)


def check_split(kern, mc, rows, what, dev):
    """K12's split search of ``kern`` (K2 or K6) over ``rows``: split 2 and
    4 ways, bitwise equal to the one-launch search and to the twins' split
    search; the partials of a block and the finalize bitwise against their
    twins.  Returns the partials' and the finalize's timing entries (a
    2-way split's first block; the finalize of all angles)."""
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_gather as k6
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.matching import matcher
    from ndt_2d_tpu_torch.parallel import matcher as pmatcher
    dths, dls = matcher._search_offsets(mc, dev)
    ref = kern.match_rows(mc, *rows, dths, dls)
    for shards in (2, 4):
        out = split_search(kern, mc, rows, dths, dls, shards)
        twin = split_search(kern, mc, rows, dths, dls, shards, twin=True)
        torch.cuda.synchronize()
        require(torch.equal(out, ref), f"{what}: the {shards}-way split "
                "search differs from the one-launch search")
        require(torch.equal(twin, ref), f"{what}: the twins' {shards}-way "
                "split search differs from the one-launch search")
    A, L = dths.shape[0], dls.shape[0]
    a0, n = pmatcher.angle_block(A, 2, 0)
    extra = () if kern is k2 else (k6.TILE, k6.candidate_scores_gather)

    def part():
        return kern.partial_rows(mc, *rows, dths, dls, a0, n)

    def part_twin():
        return k2.partial_rows_twin(mc, *rows, dths, dls, a0, n, *extra)

    p, pt = part(), part_twin()
    full = torch.cat([p, kern.partial_rows(mc, *rows, dths, dls, n, A - n)],
                     1)

    def fin():
        return kern.finalize_rows(mc, full, rows[4], dths, dls)

    def fin_twin():
        return k2.finalize_rows_twin(mc, full, rows[4], dths, dls)
    f, ft = fin(), fin_twin()
    torch.cuda.synchronize()
    require(torch.equal(p, pt), f"{what}: partials differ from the twin")
    require(torch.equal(f, ft) and torch.equal(f, ref),
            f"{what}: the finalize differs from its twin or the search")
    R = rows[2].shape[0]
    g, qp, qm, qn, st = rows[0], rows[2], rows[3], rows[4], rows[5]
    nums = ([int(v) for v in qn.tolist()] if isinstance(qn, torch.Tensor)
            else [int(qn)] * R)
    cost = cost_candidate_scores if kern is k2 else cost_candidate_gather
    moved, ops = sum_costs(cost(mc, g.origin[r], g.cell_size, qp[r], qm[r],
                                nums[r], st[r], dths[a0:a0 + n], dls)
                           for r in range(R))
    per = kern.blocks_per_angle(dls)
    # The partials replace the [13] output row: R x n x per x 12 floats.
    moved += R * (n * per * 12 - 13) * 4
    reps = 20
    print(f"[3] K12 split search, {what}: {R} rows x {A}x{L}x{L} "
          f"candidates split 2 and 4 ways, bitwise equal to the one-launch "
          f"search and to the twins; partials ({n} angles) and finalize "
          f"bitwise against their twins")
    return (timed(0.0, cuda_ms(part, reps), cuda_ms(part_twin, 2), moved,
                  ops),
            timed(0.0, cuda_ms(fin, reps), cuda_ms(fin_twin, 2),
                  nbytes(full, f) + (A + L) * 4 + R * 4,
                  R * A * per * 12))


def split_stack(mc, rows, dths, dls, S: int, dev, kern=None):
    """K12's plan of ``rows`` (grid, tables, points, mask, counts, poses)
    on a ``space`` line of S ranks for ``kern`` (K2 by default, or K6), its
    stack built on one card as the all-gather leaves it: rank s's partials
    launched into the send buffer's head (NaN everywhere else), the buffer
    copied into stack row s."""
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.parallel import matcher as pmatcher
    A = dths.shape[0]
    extra = () if kern is None or kern is k2 else (
        kern.blocks_per_angle(dls),)
    kern = k2 if kern is None else kern
    plan = k2.split_plan(dev, S, rows[2].shape[0], A, dls.shape[0],
                         isinstance(rows[4], torch.Tensor), *extra)
    plan.stack.fill_(math.nan)
    for s in range(S):
        a0, n = pmatcher.angle_block(A, S, s)
        plan.send.fill_(math.nan)
        if n:
            kern.partial_rows(mc, *rows, dths, dls, a0, n, out=plan.head(n))
        plan.stack[s].copy_(plan.send)
    return plan


def check_split_plan(mc, rows, what, ref, dev, kern=None,
                     shards=(1, 2, 3, 4)):
    """K12's planned finalize of ``kern`` (K2 by default, or K6 at its
    partials an angle) over ``rows``: stacks of S ranks' blocks (each of
    ``shards``) built on the card with NaN in every slot the in-place rule
    must not read, each finalized bitwise equal to its twin
    (``finalize_gathered_twin``) and to the one-launch search ``ref``; at
    S = 1 also read from the send buffer (a group of one); a block's
    partials launched into the send buffer bitwise the allocating launch's.
    Returns the timing entry of S = 2's planned finalize."""
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.matching import matcher
    from ndt_2d_tpu_torch.parallel import matcher as pmatcher
    kern = k2 if kern is None else kern
    dths, dls = matcher._search_offsets(mc, dev)
    A, R, nums = dths.shape[0], rows[2].shape[0], rows[4]
    per = kern.blocks_per_angle(dls)
    for S in shards:
        plan = split_stack(mc, rows, dths, dls, S, dev, kern)
        g = plan.stack.view(S, R, plan.blk * per, 12)
        out = plan.finalize(mc, plan.stack, nums, dths, dls)
        twin = k2.finalize_gathered_twin(mc, g, nums, dths, dls)
        torch.cuda.synchronize()
        require(torch.equal(out, twin) and torch.equal(out, ref),
                f"{what}: the planned finalize of {S} ranks differs from "
                "its twin or the one-launch search")
        if S == 1:
            require(torch.equal(plan.finalize(mc, plan.send[None], nums,
                                              dths, dls), ref),
                    f"{what}: the finalize of the send buffer differs")
        a0, n = pmatcher.angle_block(A, S, S - 1)
        if n:
            require(torch.equal(plan.head(n), kern.partial_rows(
                mc, *rows, dths, dls, a0, n)), f"{what}: partials into the "
                "send buffer differ from the allocating launch's")
    plan = split_stack(mc, rows, dths, dls, 2, dev, kern)
    g = plan.stack.view(2, R, plan.blk * per, 12)

    def fin():
        return plan.finalize(mc, plan.stack, nums, dths, dls)

    def fin_twin():
        return k2.finalize_gathered_twin(mc, g, nums, dths, dls)
    print(f"[3] K12 planned finalize, {what}: stacks of {shards} ranks "
          f"({per} partials an angle) with NaN in the unread slots, bitwise "
          f"equal to the twin and to the one-launch search")
    return timed(0.0, cuda_ms(fin, 50), cuda_ms(fin_twin, 2),
                 R * A * per * 12 * 4 + R * 13 * 4 + (A + dls.shape[0]) * 4
                 + R * 4, R * A * per * 12, graph_ms=(graph_ms(fin, 50), None))


def check_fold(mc, rows, query, dev):
    """The fused step's finalize with KB4's append in its launch
    (``finalize_append``) at config 2's shapes (R = 1, 80 angles, S = 2;
    the 256-slot state of 512-point scans), 64 times into a chain of
    slots, each output row bitwise its twin's (``finalize_append_twin``)
    and every state field after the chain.  Returns its timing entry."""
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import slam_step as kb4
    from ndt_2d_tpu_torch.matching import matcher
    from ndt_2d_tpu_torch.parallel import slam_step
    dths, dls = matcher._search_offsets(mc, dev)
    plan = split_stack(mc, rows, dths, dls, 2, dev)
    g = plan.stack.view(2, 1, plan.blk, 12)
    nums = rows[4]
    P = query["points"].shape[0]

    def state():
        st = slam_step.init_state(SLAM_CAPACITY, P, SLAM_CAPACITY, dev)
        st.prev_pose.copy_(torch.tensor([1.0, 2.0, 0.3], device=dev))
        return st
    scan = (query["points"], query["point_mask"])
    st, tw = state(), state()
    for k in range(MESH_REPEATS):
        est = torch.tensor([1.0 + 0.01 * k, 2.0 - 0.005 * k, 0.3 + 0.001 * k],
                           device=dev)
        args = (est, *scan, k, max(k - 1, 0), k > 0)
        out = plan.finalize(mc, plan.stack, nums, dths, dls,
                            kb4.Append(kb4.plan_for(st), *args))
        want = k2.finalize_append_twin(mc, g, nums, dths, dls,
                                       kb4.Append(kb4.plan_for(tw), *args))
        require(torch.equal(out, want), f"finalize_append {k}: the output "
                "row differs from its twin")
    torch.cuda.synchronize()
    for f in ("poses", "points", "point_mask", "c_begin", "c_end",
              "c_transform", "c_information", "prev_pose"):
        require(torch.equal(getattr(st, f), getattr(tw, f)),
                f"finalize_append: {f} differs from its twin")
    est = torch.tensor([1.2, 2.05, 0.31], device=dev)
    fold = kb4.Append(kb4.plan_for(st), est, *scan, 7, 6, True)
    tw_fold = kb4.Append(kb4.plan_for(tw), est, *scan, 7, 6, True)

    def run():
        return plan.finalize(mc, plan.stack, nums, dths, dls, fold)

    def twin():
        return k2.finalize_append_twin(mc, g, nums, dths, dls, tw_fold)
    A, L = dths.shape[0], dls.shape[0]
    print(f"[3] K12 finalize_append at config 2 (S = 2): {MESH_REPEATS} "
          f"appends into a chain of slots of a {SLAM_CAPACITY}-slot state, "
          f"output rows and every state field bitwise equal to the twin")
    return timed(0.0, cuda_ms(run, 50), cuda_ms(twin, 5),
                 A * 12 * 4 + 13 * 4 + (A + L) * 4 + 4 + nbytes(est, *scan)
                 * 2 + 4 * (3 + 3 + 9 + 2), A * 12 + 150,
                 graph_ms=(graph_ms(run, 50), None))


def launch_path(dev) -> dict:
    """The host side of one ``rank_sum`` launch at 2 x 450,000, piece by
    piece (``host_us``), beside ``torch.sum(x, 0)``'s; the current stream
    read by three public calls and, for scale, PyTorch's private one."""
    import torch

    from ndt_2d_tpu_torch.kernels import _build
    from ndt_2d_tpu_torch.kernels import shard_combine as sc
    x = torch.randn(2, 9 * DISTRICT_NODES, device=dev)
    n = x.shape[1]
    out = torch.empty(n, device=dev)
    fn = _build.function("ndt2d_rank_sum", sc._ARGS)
    xp, op = x.data_ptr(), out.data_ptr()
    width, _, blocks = sc.geometry(n, xp, op, _build.sm_count(dev.index))
    stream = _build.stream_ptr(dev)
    reps = 5000
    pieces = {
        "rank_sum": lambda: sc.rank_sum(x),
        "torch.sum": lambda: torch.sum(x, 0),
        "require": lambda: _build.require(x, "x", torch.float32, x.shape,
                                          dev),
        "x.device": lambda: x.device,
        "x.shape": lambda: x.shape,
        "x.numel": lambda: x.numel(),
        "torch.empty": lambda: torch.empty(n, dtype=torch.float32,
                                           device=dev),
        "function": lambda: _build.function("ndt2d_rank_sum", sc._ARGS),
        "data_ptr": lambda: x.data_ptr(),
        "geometry": lambda: sc.geometry(n, xp, op,
                                        _build.sm_count(dev.index)),
        "stream_ptr": lambda: _build.stream_ptr(dev),
        "current_stream(device)": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "current_stream()": lambda: torch.cuda.current_stream().cuda_stream,
        # PyTorch's private raw read, for scale only: the port does not
        # call it.
        "_cuda_getCurrentRawStream": lambda: (
            torch._C._cuda_getCurrentRawStream(dev.index)),
        "ctypes call": lambda: fn(xp, 2, n, width, blocks, op, stream),
        "check": lambda: _build.check(0, "rank_sum"),
    }
    us = {k: host_us(f, reps) for k, f in pieces.items()}
    torch.cuda.synchronize()
    print("[3] K12 rank_sum launch path, host us a call (2 x "
          f"{n}): " + ", ".join(f"{k} {v:.3f}" for k, v in us.items()))
    return us


def check_rank_sum(dev) -> dict:
    """``rank_sum`` against its twin at the district's shapes and at odd
    ones; its times (host-inclusive and in a CUDA graph) beside
    ``torch.sum(x, 0)``'s, and its launch path piece by piece."""
    import torch

    from ndt_2d_tpu_torch.kernels import shard_combine
    out = {}
    gen = torch.Generator(device=dev).manual_seed(7)
    # The district's shapes, then an odd one: three ranks of 450,001
    # floats through a view one float into its buffer (one float a load).
    cases = [(S, width * DISTRICT_NODES, 0) for S in (2, 4)
             for width in (3, 9)] + [(3, 9 * DISTRICT_NODES + 1, 1)]
    for S, n, offset in cases:
        buf = torch.randn(S * n + offset, generator=gen, device=dev)
        x = buf[offset:].view(S, n)
        x[1] *= 1e6
        y, yt = shard_combine.rank_sum(x), shard_combine.rank_sum_twin(x)
        torch.cuda.synchronize()
        require(torch.equal(y, yt), f"rank_sum ({S} x {n}, offset "
                f"{offset}) differs from its twin")
        require(torch.equal(y, shard_combine.rank_sum(x)),
                "rank_sum not bitwise reproducible")

        def run():
            return shard_combine.rank_sum(x)

        def library():
            return torch.sum(x, 0)
        entry = timed(0.0, cuda_ms(run, 200),
                      cuda_ms(lambda: shard_combine.rank_sum_twin(x), 20),
                      nbytes(x, y), S * n, cuda_ms(library, 200),
                      (graph_ms(run, 200), graph_ms(library, 200)))
        key = {(2, 9 * DISTRICT_NODES): "rank_sum"}.get(
            (S, n), f"rank_sum_{S}x{n}" if offset else
            f"rank_sum_{S}x{n // DISTRICT_NODES}n")
        out[key] = entry
    # A misaligned view whose n is a multiple of 4 takes one float a load.
    buf = torch.randn(2 * 9 * DISTRICT_NODES + 1, generator=gen, device=dev)
    x = buf[1:].view(2, -1)
    require(torch.equal(shard_combine.rank_sum(x),
                        shard_combine.rank_sum_twin(x)),
            "rank_sum on a misaligned view differs from its twin")
    print(f"[3] K12 rank_sum: S = 2, 4 ranks x {3 * DISTRICT_NODES} and "
          f"{9 * DISTRICT_NODES} floats (the district's gradient and block "
          "diagonal), 3 x 450,001 and 2 x 450,000 on views one float into "
          "their buffers, bitwise equal to the twin's rank-order adds and "
          "reproducible")
    launch_path(dev)
    return out


def phase_k12(cfg, win, query, cfg3, bag3, cfg6, dev):
    """K12's kernels against their twins: the split K2 at config 2's
    window (R = 1) and over 64 config-3 confirmation rows, the split K6
    over config 6's 32 coarse rows, and the rank-ordered sum at the
    district's shapes."""
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_gather as k6
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.matching import matcher
    from ndt_2d_tpu_torch.ndt import grid as ndt_grid
    out = {}
    mc = cfg.local_scan_matcher
    g, tab = k1.build_window(**win, range_max=15.0,
                             cell_size=mc.ndt_resolution,
                             width=mc.grid_cells_x, height=mc.grid_cells_y)
    row = ndt_grid.NDTGrid(origin=g.origin[None], cell_size=g.cell_size,
                           mean=None, information=None, count=None,
                           covariance=None)
    rows2 = (row, tab[None], query["points"][None],
             query["point_mask"][None],
             torch.tensor([query["num_points"]], dtype=torch.int32,
                          device=dev), query["pose"][None])
    p2, f2 = check_split(k2, mc, rows2, "K2 at config 2's window", dev)
    out["candidate_partials_config2"] = p2
    out["candidate_finalize_unplanned_config2"] = f2
    dths, dls = matcher._search_offsets(mc, dev)
    out["candidate_finalize_config2"] = check_split_plan(
        mc, rows2, "K2 at config 2's window",
        k2.match_rows(mc, *rows2, dths, dls), dev)
    out["candidate_finalize_append"] = check_fold(mc, rows2, query, dev)
    gm = cfg3.global_scan_matcher
    rows = office_rows(cfg3, bag3, dev)
    gr, tabs = k1.build_windows(*rows[:4], 12.0, gm.ndt_resolution,
                                gm.grid_cells_x, gm.grid_cells_y)
    rows3 = (gr, tabs, *rows[4:])
    what = f"K2 over {ROWS} config-3 rows"
    out["candidate_partials"], out["candidate_finalize_unplanned"] = \
        check_split(k2, gm, rows3, what, dev)
    dths, dls = matcher._search_offsets(gm, dev)
    out["candidate_finalize"] = check_split_plan(
        gm, rows3, what, k2.match_rows(gm, *rows3, dths, dls), dev)
    cm = cfg6.coarse_scan_matcher
    rows = coarse_rows(cfg6, bag3, dev)
    gr, tabs = k1.build_windows(*rows[:4], 12.0, cm.ndt_resolution,
                                cm.grid_cells_x, cm.grid_cells_y)
    rows6 = (gr, tabs, *rows[4:])
    what = f"K6 over {COARSE_ROWS} config-6 coarse rows"
    out["candidate_gather_partials"], _ = check_split(k6, cm, rows6, what,
                                                      dev)
    # K6's planned finalize: S = 2 (a short last block), 3, 4 and 8 (an
    # empty one) at config 6's 21 angles of 7 tiles.
    dths, dls = matcher._search_offsets(cm, dev)
    out["candidate_gather_finalize"] = check_split_plan(
        cm, rows6, what, k6.match_rows(cm, *rows6, dths, dls), dev, k6,
        (1, 2, 3, 4, 8))
    check_long_folds(dev)
    out.update(check_rank_sum(dev))
    return out


def fold_partials_rows(R: int, A: int, per: int, L: int, seed: int,
                       nan_first: bool = False, nan_later: bool = False):
    """Synthetic [R, A * per, 12] partials of an A x L x L lattice in
    (angle, tile) order: lows with ties, -0, +0 and +-inf, each partial's
    flat index inside its tile, Olson sums with s < 0; NaN lows at the
    first partial and / or later ones where asked."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    N = A * per
    best = rng.choice([-3.0, -2.5, -1.0, -0.0, 0.0, 2.0],
                      (R, N)).astype(np.float32)
    best[:, rng.integers(0, N, 3)] = -np.inf
    best[:, rng.integers(0, N, 3)] = np.inf
    if nan_first:
        best[:, 0] = np.nan
    if nan_later:
        best[:, rng.integers(1, N, 5)] = np.nan
    i = np.arange(N)
    tile = (i // per) * L * L + (i % per) * 256
    span = np.minimum(256, L * L - (i % per) * 256)
    index = (tile[None] + rng.integers(0, 1 << 20, (R, N)) % span[None]
             ).astype(np.int32)
    sums = rng.normal(0.0, 1.0, (R, N, 10)).astype(np.float32)
    sums[..., 0] = -np.abs(sums[..., 0])
    out = np.concatenate([best[..., None], index.view(np.float32)[..., None],
                          sums], -1)
    return torch.from_numpy(out)


def serial_fold(p):
    """The serial scan's (min, first index) of one row's partials [N, 12]
    (numpy): the first opens the pair; a later one replaces it where
    strictly less."""
    best, bi = p[0, 0], int(p[0, 1:2].view("int32")[0])
    for j in range(1, p.shape[0]):
        if p[j, 0] < best:
            best, bi = p[j, 0], int(p[j, 1:2].view("int32")[0])
    return best, bi


def check_long_folds(dev):
    """K2's finalize launch over rows longer than one stage: the merge's
    126 angles x 7 tiles (882 partials, four rounds), 512 x 1 (one round at
    the stage's size), 513 x 1 and 300 x 7 (2100), R = 1 and 5, from one
    [R, N, 12] buffer (``finalize_rows``) and from split stacks of 2 and 3
    ranks with NaN in the unread slots (``SplitPlan``), each row bitwise
    ``finalize_rows_twin``; rows with a NaN low, first or later: the
    covariance bitwise the twin, the score and correction the serial
    scan's."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.config import ScanMatcherConfig
    from ndt_2d_tpu_torch.kernels import candidate_gather as k6
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.parallel import matcher as pmatcher
    mc = ScanMatcherConfig(laser_max_beams=100)
    cases = ((126, 7, 40), (512, 1, 5), (513, 1, 5), (300, 7, 40))
    done = []
    for k, (A, per, L) in enumerate(cases):
        dths = torch.linspace(-3.1, 3.1, A, device=dev)
        dls = torch.linspace(-1.0, 1.0, L, device=dev)
        for R in (1, 5):
            nums = torch.arange(60, 60 + 20 * R, 20, dtype=torch.int32,
                                device=dev)
            for nan_first, nan_later in ((False, False), (True, False),
                                         (False, True)):
                rows = fold_partials_rows(R, A, per, L, 100 * k + R,
                                          nan_first, nan_later).to(dev)
                twin = k2.finalize_rows_twin(mc, rows, nums, dths, dls)
                outs = [k6.finalize_rows(mc, rows, nums, dths, dls)]
                for S in (2, 3):
                    plan = k2.SplitPlan(dev, S, R, A, L, True, per)
                    plan.stack.fill_(math.nan)
                    st = plan.stack.view(S, R, plan.blk * per, 12)
                    for s in range(S):
                        a0, n = pmatcher.angle_block(A, S, s)
                        st[s].view(-1)[:R * n * per * 12].copy_(
                            rows[:, a0 * per:(a0 + n) * per].reshape(-1))
                    outs.append(plan.finalize(mc, plan.stack, nums, dths,
                                              dls))
                torch.cuda.synchronize()
                for out in outs:
                    if not (nan_first or nan_later):
                        require(torch.equal(out, twin),
                                f"finalize of {R} x {A} x {per} partials "
                                "differs from its twin")
                        continue
                    require(torch.equal(out[:, 4:], twin[:, 4:]),
                            f"finalize of {R} x {A} x {per} partials with "
                            "NaN lows: covariance differs from the twin")
                    host = rows.cpu().numpy()
                    for r in range(R):
                        best, bi = serial_fold(host[r])
                        ai, xi, yi = bi // (L * L), (bi // L) % L, bi % L
                        used = max(min(100, int(nums[r])), 1)
                        want = np.float32(best) / np.float32(used)
                        got = out[r].cpu().numpy()
                        corr = ([dls[xi], dls[yi], dths[ai]] if best < 0
                                else [0.0, 0.0, 0.0])
                        same = (bool(np.isnan(got[0])) if np.isnan(want)
                                else np.array_equal(
                                    got[:1].view(np.int32), np.asarray(
                                        [want], np.float32).view(np.int32)))
                        require(same and np.array_equal(
                            got[1:4], np.asarray([float(c) for c in corr],
                                                 np.float32)),
                            f"finalize of {R} x {A} x {per} partials with "
                            f"NaN lows: row {r} is not the serial scan's")
        done.append(f"{A}x{per}")
    print(f"[3] K2/K6 finalize over long rows ({', '.join(done)} partials, "
          f"R = 1 and 5, one buffer and split stacks of 2 and 3 ranks): "
          f"bitwise the twin; with NaN lows first or later, the serial "
          f"scan's winner")


def mesh_launches(launches) -> dict:
    """The K12 launches of a run."""
    return {k: launches[k] for k in K12_KERNELS}


def final_ate(mapper, stats, bag) -> float:
    """ATE of the graph after the session's last solve."""
    from ndt_2d_tpu_torch.utils import metrics
    return metrics.ate_rmse(mapper.graph.poses[:len(stats["_est"])],
                            bag.truth[stats["_est_t"]])


class ForcedCollectives:
    """Inside, a group of one rank runs its collectives where the mesh path
    skips them as the identity, so the NCCL branches of
    ``distributed.gather`` and ``sum_int`` run on one card; ``calls``
    counts the all-gathers and all-reduces made."""

    def __enter__(self):
        import torch.distributed as dist

        from ndt_2d_tpu_torch.parallel import distributed
        self.saved = (distributed._alone, dist.all_gather_into_tensor,
                      dist.all_reduce)
        self.calls = {"all_gather": 0, "all_reduce": 0}

        def counted(name, fn):
            def call(*args, **kwargs):
                self.calls[name] += 1
                return fn(*args, **kwargs)
            return call
        distributed._alone = lambda group: group is None
        dist.all_gather_into_tensor = counted("all_gather", self.saved[1])
        dist.all_reduce = counted("all_reduce", self.saved[2])
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        from ndt_2d_tpu_torch.parallel import distributed
        (distributed._alone, dist.all_gather_into_tensor,
         dist.all_reduce) = self.saved
        return False


# Tensor operations that launch nothing: allocations and views.
QUIET_OPS = {"empty", "empty_strided", "new_empty", "view", "slice",
             "unsqueeze", "alias", "as_strided", "select", "detach",
             "reshape", "_unsafe_view"}


def split_glue(dev, mesh, bag3):
    """K2's split search (``parallel/matcher.py::search_rows``) on the
    one-rank NCCL ``mesh`` with its all-gather forced through NCCL, at
    config 2's window and over 64 config-3 rows, under a dispatch mode:
    the operations it issues on CUDA tensors (its partials and finalize are
    hand launches) are allocations, views and the collective only, and its
    rows are bitwise the one-launch search's.  Returns the operations
    seen."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.matching import matcher
    from ndt_2d_tpu_torch.ndt import grid as ndt_grid
    from ndt_2d_tpu_torch.parallel import matcher as pmatcher

    class Ops(TorchDispatchMode):
        """The operations that touch a CUDA tensor (the device mesh's own
        bookkeeping runs on small CPU tensors)."""

        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(x, torch.Tensor) and x.is_cuda
                   for x in tree_flatten((args, kwargs, out))[0]):
                self.seen.add((func.namespace, func.overloadpacket.__name__))
            return out
    _, cfg, win, query, _ = inputs(dev)
    mc = cfg.local_scan_matcher
    g, tab = k1.build_window(**win, range_max=15.0,
                             cell_size=mc.ndt_resolution,
                             width=mc.grid_cells_x, height=mc.grid_cells_y)
    row = ndt_grid.NDTGrid(origin=g.origin[None], cell_size=g.cell_size,
                           mean=None, information=None, count=None,
                           covariance=None)
    cases = [(mc, (row, tab[None], query["points"][None],
                   query["point_mask"][None],
                   torch.tensor([query["num_points"]], dtype=torch.int32,
                                device=dev), query["pose"][None]))]
    cfg3 = office_config()
    gm = cfg3.global_scan_matcher
    rows = office_rows(cfg3, bag3, dev)
    gr, tabs = k1.build_windows(*rows[:4], 12.0, gm.ndt_resolution,
                                gm.grid_cells_x, gm.grid_cells_y)
    cases.append((gm, (gr, tabs, *rows[4:])))
    seen = set()
    with ForcedCollectives() as forced:
        for c, r in cases:
            dths, dls = matcher._search_offsets(c, dev)
            ref = k2.match_rows(c, *r, dths, dls)
            mode = Ops()
            with mode:
                out = pmatcher.search_rows(k2, c, mesh, *r[:4], r[4], r[5],
                                           dths, dls)
            torch.cuda.synchronize()
            require(torch.equal(out, ref), "K12's planned split search "
                    "over NCCL differs from the one-launch search")
            seen |= mode.seen
    loud = {op for op in seen if op[0] != "c10d" and op[1] not in QUIET_OPS}
    require(not loud and forced.calls["all_gather"] == 2,
            f"K12's split search issued tensor operations {sorted(loud)} "
            f"({forced.calls})")
    print(f"[4p] K12 split search on the one-rank mesh, its all-gather "
          f"through NCCL, at config 2 and over {ROWS} config-3 rows: bitwise "
          f"the one-launch search; operations on CUDA tensors "
          f"{sorted(seen)} (no kernel between the partials and the "
          f"finalize)")
    return seen


def pf_mesh_session(path_map, dev, mesh):
    """Config 4's particle filter (``phase_config4``'s bag, seed and start)
    through ``Mapper(mesh=mesh)``: a step is K9's motion launch, the
    sharded measurement (K3's particle launch with the motion off) and the
    resample.  Returns (launches, steps, mean error, final particles
    sha256)."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.io.bag import record_synthetic
    from ndt_2d_tpu_torch.mapping.mapper import LOAD_FROM_FILE, Mapper
    from ndt_2d_tpu_torch.utils import metrics
    _, cfg = config4_configs()
    loc_bag = record_synthetic("box", 150, n_beams=360, seed=7,
                               odom_trans_noise=0.01)
    rel = metrics.relative_to_first(loc_bag.truth)
    scans = [(t, msg, odom) for t, (msg, odom) in enumerate(loc_bag)
             if t > 0]
    reset_counts()
    loc = Mapper(cfg, seed=3, device=dev, mesh=mesh)
    loc.configure(LOAD_FROM_FILE, path_map)
    loc.set_initial_pose(rel[0], np.diag([0.04, 0.04, 0.01]),
                         loc_bag.truth[0])
    errs, _, _ = track(loc, scans, rel)
    torch.cuda.synchronize()
    return (read_counts(), len(errs), float(np.mean(errs)),
            poses_digest(loc.filter.particles.cpu().numpy()))


def phase_mesh_nccl(cfg, bag, cfg6, bag3, dev, tmp, pf_digest):
    """The mesh path on one rank over NCCL (cuda:0): config 10 through
    ``Mapper(mesh=make_mesh(1))`` synchronously and at max_inflight 8,
    beside the single-device run of the same bag; config 4's particle
    filter on the mesh (K9's motion launch and the sharded measurement a
    step), its final particles bitwise the single-device session's
    (``pf_digest``); config 2's pipelined
    dispatch loop and export on the mesh with the one-rank collectives
    forced through NCCL, the loop under CUDA sync-debug "error"; config 6
    (descriptor search, far rows on K6) on the mesh beside the
    single-device run and, as the witness of the solver's share, the
    single-device run with the solve forced to PCG; the time of
    ``distributed.gather`` through NCCL at the solver's shape.  Returns
    (config 10's launches, config 6's, the gather ms, the single-device
    config-10 run, the mesh filter's launches)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from ndt_2d_tpu_torch.mapping import occupancy
    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    from ndt_2d_tpu_torch.parallel import distributed, mesh as mesh_mod
    distributed.initialize(dev, init_method="file://" + os.path.join(
        tmp, "nccl_rendezvous"), world_size=1, rank=0)
    try:
        require(dist.get_backend() == "nccl", "the one-rank group is not "
                "NCCL")
        mesh = mesh_mod.make_mesh(1)
        numbers = {}
        for name, m in (("single", None), ("mesh", mesh)):
            reset_counts()
            t0 = time.perf_counter()
            stats, grid, dt, _, acc, mapper = run_session(
                cfg, bag, dev, mapper=Mapper(cfg, device=dev, mesh=m))
            wall = time.perf_counter() - t0
            numbers[name] = dict(
                stats=stats, grid=grid, mapper=mapper, wall=wall,
                launches=read_counts(), final=final_ate(mapper, stats, bag),
                ms=float(np.median(dt[acc][4:]) * 1e3))
        s, m = numbers["single"], numbers["mesh"]
        st, launches, final = m["stats"], m["launches"], m["final"]
        require(st["scans_accepted"] == s["stats"]["scans_accepted"],
                f"config 10 on the mesh accepted {st['scans_accepted']}, "
                f"single-device {s['stats']['scans_accepted']}")
        require(st["loop_closures"] >= 1 and st["session"]["optimizations"]
                >= 1, f"config 10 on the mesh: {st['loop_closures']} "
                f"closures, {st['session']['optimizations']} optimizations")
        require(final < st["odom_ate_rmse_m"]
                and abs(final - s["final"]) < MESH_ATE_GAP,
                f"config 10 mesh final ATE {final} (single-device "
                f"{s['final']}, odometry {st['odom_ate_rmse_m']})")
        g = m["mapper"].graph
        plain = occupancy.render_occupancy(
            g.poses, g.points, g.point_mask, cfg.resolution,
            cfg.occupancy_threshold, device=dev)
        require(np.array_equal(plain.data, m["grid"].data),
                "config 10: the mesh export differs from single-device K5")
        for k in ("candidate_partials", "candidate_finalize", "rank_sum"):
            require(launches[k] >= 1, f"config 10 on the mesh never "
                    f"launched {k}: {launches}")
        require(launches["candidate_scores"] == 0, "config 10 on the mesh "
                "launched the one-launch K2 search")
        # The mesh's dense LM step: dense_system and lm_step each a launch
        # before the rank sum and one after (lm_step also one a solve for
        # the start's cost).
        lm_it = launches["normal_blocks"]
        require(lm_it >= 1 and launches["dense_system"] == 2 * lm_it
                and launches["lm_step"] > 2 * lm_it,
                f"config 10 on the mesh: dense LM step launches {launches}")
        print(f"[4p] config 10 on the mesh, the dense LM step split around "
              f"the rank sum: {lm_it} LM iterations, dense_system "
              f"{launches['dense_system']}, lm_step {launches['lm_step']}")
        print(f"[4p] config 10 ({len(bag)} office scans) on a one-rank NCCL "
              f"mesh: {st['scans_accepted']} accepted (single-device "
              f"{s['stats']['scans_accepted']}), {st['loop_closures']} "
              f"closures / {st['session']['optimizations']} optimizations "
              f"(single {s['stats']['loop_closures']} / "
              f"{s['stats']['session']['optimizations']}), ATE online "
              f"{st['ate_rmse_m']:.4f} final {final:.4f} m (single "
              f"{s['stats']['ate_rmse_m']:.4f} / {s['final']:.4f}, odometry "
              f"{st['odom_ate_rmse_m']:.4f}); {m['ms']:.3f} ms per accepted "
              f"scan (single {s['ms']:.3f}), session {m['wall']:.3f} s "
              f"(single {s['wall']:.3f}); export bitwise equal to "
              f"single-device K5; K12 launches {mesh_launches(launches)}")
        # Pipelined, max_inflight 8.
        reset_counts()
        t0 = time.perf_counter()
        pst, _, pdt, _, pacc, pm = run_session(
            pipelined(cfg), bag, dev,
            mapper=Mapper(pipelined(cfg), device=dev, mesh=mesh))
        pwall = time.perf_counter() - t0
        plaunch = read_counts()
        pfinal = final_ate(pm, pst, bag)
        require(pst["loop_closures"] >= 1 and pfinal < pst["odom_ate_rmse_m"],
                f"pipelined config 10 on the mesh: {pst['loop_closures']} "
                f"closures, final ATE {pfinal}")
        require(k13_launches(plaunch) >= 1
                and plaunch["score_points_compose"] >= 1
                and plaunch["candidate_partials"] >= 1,
                f"pipelined config 10 launches {plaunch}")
        print(f"[4p] config 10 at max_inflight=8 on the mesh: "
              f"{pst['scans_accepted']} accepted, {pst['loop_closures']} "
              f"closures, final ATE {pfinal:.4f} m, "
              f"{float(np.median(pdt[pacc][4:]) * 1e3):.3f} ms per accepted "
              f"scan, session {pwall:.3f} s")
        pf_launches, steps, pf_err, digest = pf_mesh_session(
            os.path.join(tmp, "box_map.npz"), dev, mesh)
        for k in ("pf_motion", "score_points_batch", "pf_resample"):
            require(pf_launches[k] == steps, f"config 4's filter on the "
                    f"mesh: {k} launched {pf_launches[k]} times, expected "
                    f"{steps}")
        require(pf_launches["pf_motion_score"] == 0, "config 4's filter on "
                "the mesh launched the one-device fused step")
        require(digest == pf_digest, f"config 4's filter on the mesh: final "
                f"particles sha256 {digest}, one device's {pf_digest}")
        print(f"[4p] config 4's particle filter on the mesh: {steps} steps, "
              f"mean position error {pf_err:.4f} m, final particles sha256 "
              f"{digest}, bitwise the single-device session's; a step K9's "
              f"motion, the sharded measurement and the resample "
              f"(pf_motion {pf_launches['pf_motion']}, score_points_batch "
              f"{pf_launches['score_points_batch']}, pf_motion_score "
              f"{pf_launches['pf_motion_score']})")
        mesh_sync_debug(dev, mesh)
        split_glue(dev, mesh, bag3)
        # Config 6: descriptor search (query rows over 'batch') and far rows
        # coarse-to-fine on K6's split search, beside one device; then one
        # device with the solver forced to PCG, the mesh's solve before
        # the mesh took one device's dense rule.
        pcg6 = dataclasses.replace(cfg6, solver=dataclasses.replace(
            cfg6.solver, dense_size_limit=0))
        runs6 = {}
        for name, c6, m6 in (("mesh", cfg6, mesh), ("single", cfg6, None),
                             ("single_pcg", pcg6, None)):
            reset_counts()
            t0 = time.perf_counter()
            st6, _, _, _, _, mp6 = run_session(
                c6, bag3, dev, mapper=Mapper(c6, device=dev, mesh=m6))
            runs6[name] = dict(stats=st6, wall=time.perf_counter() - t0,
                               launches=read_counts(), mapper=mp6,
                               final=final_ate(mp6, st6, bag3))
        d, d1, dp = runs6["mesh"], runs6["single"], runs6["single_pcg"]
        dst, dlaunch = d["stats"], d["launches"]
        require(dst["loop_closures"] >= 1
                and d["final"] < dst["odom_ate_rmse_m"]
                and abs(d["final"] - d1["final"]) < MESH_ATE_GAP,
                f"config 6 on the mesh: {dst['loop_closures']} closures, "
                f"final ATE {d['final']} (single-device {d1['final']})")
        for k in ("candidate_gather_partials", "candidate_gather_finalize",
                  "descriptor_search"):
            require(dlaunch[k] >= 1, f"config 6 on the mesh never launched "
                    f"{k}")
        print(f"[4p] config 6 on the mesh: {dst['loop_closures']} closures "
              f"({d['mapper'].stats.far_rows_pruned} far rows pruned), final "
              f"ATE {d['final']:.4f} m (single-device "
              f"{d1['stats']['loop_closures']} closures, {d1['final']:.4f}; "
              f"odometry {dst['odom_ate_rmse_m']:.4f}), session "
              f"{d['wall']:.3f} s (single {d1['wall']:.3f}); K12 launches "
              f"{mesh_launches(dlaunch)}")
        print(f"[4p] witness: config 6 on one device with the solve forced "
              f"to PCG (dense_size_limit 0): "
              f"{dp['stats']['loop_closures']} closures, "
              f"{dp['stats']['session']['optimizations']} optimizations, "
              f"final ATE {dp['final']:.4f} m (dense "
              f"{d1['final']:.4f}), {dp['launches']['pcg_solve']} PCG "
              f"solves (one launch an LM step) after "
              f"{dp['launches']['pcg_normal_system']} pcg_normal_system "
              f"launches, session {dp['wall']:.3f} s")
        # distributed.gather through NCCL at the solver's shape (the
        # block diagonal of the district's 50,000 nodes).
        x = torch.randn(9 * DISTRICT_NODES, device=dev)
        with ForcedCollectives():
            def gather():
                return distributed.gather(x, dist.group.WORLD)
            y = gather()
            torch.cuda.synchronize()
            require(y.shape == (1, x.numel()) and torch.equal(y[0], x),
                    "the NCCL gather differs from its input")
            gather_ms = cuda_ms(gather, 50)
        print(f"[5] distributed.gather through NCCL over the one-rank group "
              f"of {x.numel()} floats (the district's block diagonal): "
              f"{gather_ms:.4f} ms")
    finally:
        dist.destroy_process_group()
    return launches, dlaunch, gather_ms, s, pf_launches


def mesh_sync_debug(dev, mesh):
    """Config 2's pipelined dispatch loop (max_inflight 8, no loop closure)
    on the one-rank mesh with its collectives forced through NCCL: the
    loop under CUDA sync-debug "error" (no call in it synchronizes or
    copies to the host blocking, the NCCL gathers of the search's partials
    included), the graph bitwise the single-device pipelined run's; then
    the export, its ray counts summed by an NCCL all-reduce, bitwise the
    single-device export."""
    import contextlib

    import numpy as np
    import torch

    from ndt_2d_tpu_torch.mapping import runtime
    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    bag, cfg, _, _, _ = inputs(dev)
    pcfg = pipelined(cfg)
    graphs, grids = [], []
    forced = ForcedCollectives()
    for m in (None, mesh):
        mapper = Mapper(pcfg, device=dev, mesh=m)
        torch.cuda.synchronize()
        with forced if m is not None else contextlib.nullcontext():
            if m is not None:
                torch.cuda.set_sync_debug_mode("error")
            try:
                for t, (msg, odom) in enumerate(bag):
                    mapper.process_scan(msg, odom,
                                        runtime.sweep_end_odom(bag, t, msg))
            finally:
                torch.cuda.set_sync_debug_mode("default")
            mapper.flush()
            grids.append(mapper.render_map().data)
        graphs.append(mapper.graph.poses[:mapper.graph.num_scans].copy())
    calls = forced.calls
    require(len(graphs[1]) == len(bag) and np.array_equal(*graphs),
            "config 2 pipelined on the mesh differs from single-device")
    require(np.array_equal(*grids), "config 2's export on the mesh differs "
            "from single-device")
    require(calls["all_gather"] >= len(bag) - 1 and calls["all_reduce"] >= 1,
            f"the forced NCCL collectives did not run: {calls}")
    print(f"[4p] config 2 at max_inflight=8 on the mesh, every one-rank "
          f"collective through NCCL ({calls['all_gather']} all-gathers, "
          f"{calls['all_reduce']} integer all-reduces): the dispatch loop "
          f"under sync-debug \"error\", {len(bag)} scans, graph and export "
          f"bitwise equal to the single-device pipelined run's")


def mesh_rank(out_dir, space: int, batch: int, map4: str,
              device: str) -> int:
    """One rank of ``phase_mesh_shared``: a (space, batch) gloo mesh whose
    ranks share ``device`` (the card).  Runs config 10 synchronously, the
    district's PCG solve by ``solve_multichip`` (with the launch counts
    read around it) and the 5000-particle measurement on the config-4 map,
    and saves the results to ``out_dir``."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.kernels import score_points as k3
    from ndt_2d_tpu_torch.mapping import laser
    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    from ndt_2d_tpu_torch.parallel import distributed, mesh as mesh_mod
    from ndt_2d_tpu_torch.parallel import filter as pfilter
    from ndt_2d_tpu_torch.io.bag import record_synthetic
    from ndt_2d_tpu_torch.utils import metrics
    dev = distributed.initialize(device, backend="gloo")
    mesh = mesh_mod.make_mesh(shape=(space, batch))
    out = {}
    cfg, bag = config10()
    t0 = time.perf_counter()
    stats, grid, dt, _, acc, mapper = run_session(
        cfg, bag, dev, mapper=Mapper(cfg, device=dev, mesh=mesh))
    out["wall"] = time.perf_counter() - t0
    g = mapper.graph
    out.update(accepted=stats["scans_accepted"],
               closures=stats["loop_closures"],
               optimizations=stats["session"]["optimizations"],
               ate=stats["ate_rmse_m"], odom=stats["odom_ate_rmse_m"],
               final=metrics.ate_rmse(g.poses[:len(stats["_est"])],
                                      bag.truth[stats["_est_t"]]),
               ms=float(np.median(dt[acc][4:]) * 1e3), poses=g.poses,
               grid=grid.data)
    out.update(district_on_mesh(mesh, dev))
    x = torch.zeros(9 * DISTRICT_NODES, device=dev)
    out["gather_ms"] = cuda_ms(
        lambda: distributed.gather(x, torch.distributed.group.WORLD), 20)
    # Config 4's measurement of 5000 particles, sharded over 'batch'.
    _, cfg4 = config4_configs()
    bag4 = record_synthetic("box", 150, n_beams=360, seed=2)
    loc = localizer(cfg4, map4, dev, 3)
    loc._ensure_matchers(bag4.range_max)
    m = loc.global_matcher
    pts, msk = laser.project_scan(bag4[40][0], bag4.range_max, np.zeros(3),
                                  False, None, cfg4.max_points_per_scan)
    q, qm = torch.tensor(pts, device=dev), torch.tensor(msk, device=dev)
    center = torch.tensor(metrics.relative_to_first(bag4.truth)[40],
                          dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    poses = (center + torch.randn(PARTICLES, 3, generator=gen, device=dev)
             * torch.tensor([0.2, 0.2, 0.05], device=dev)).contiguous()
    sc = pfilter.measure_multichip(m.config, mesh, m.grid, q, qm,
                                   int(msk.sum()), poses, m.packed_table)
    one = k3.score_batch(m.grid, m.config.grid_cells_x, m.config.grid_cells_y,
                         m.config.laser_max_beams, q, qm, int(msk.sum()),
                         poses)
    out["measure_equal"] = bool(torch.equal(sc, one))
    out["measure"] = sc.cpu().numpy()
    out["jax"] = "jax" in sys.modules
    np.savez(os.path.join(out_dir, f"rank{distributed.rank()}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def district_on_mesh(mesh, dev) -> dict:
    """The district's PCG solve by ``solve_multichip`` on ``mesh``, the
    constraints over 'batch' (config 5's SolverConfig), with the launch
    counts read around it: its wall, counts, LM iterations, success and
    poses, under ``district_*`` keys."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch import convert
    from ndt_2d_tpu_torch.config import SolverConfig
    from ndt_2d_tpu_torch.parallel import mesh as mesh_mod
    from ndt_2d_tpu_torch.parallel import solver as psolver
    _, district = district_graph()
    nb = mesh_mod.axis_size(mesh, mesh_mod.BATCH_AXIS)
    d = dict(district)
    d.pop("robust_mask")
    (d["begin"], d["end"], d["transform"], d["information"],
     d["constraint_mask"]) = psolver.pad_constraints(
        d["begin"], d["end"], d["transform"], d["information"],
        d["constraint_mask"], nb)
    t = convert.solve_inputs_to_port(dev, **d)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = psolver.solve_multichip(
        SolverConfig(max_iterations=30, cg_max_iterations=150), mesh, **t)
    torch.cuda.synchronize()
    out = {"district_wall": time.perf_counter() - t0}
    counts = read_counts()
    for k in MESH_DISTRICT_KERNELS:  # an older tree counts fewer forms
        out[f"district_{k}"] = counts.get(k, 0)
    out["district_lm"] = int(res.iterations)
    out["district_ok"] = bool(res.success)
    out["district"] = res.poses.cpu().numpy().astype(np.float64)
    return out


def mesh_district_rank(device: str, ident: str) -> int:
    """One rank of ``--mesh-district``: the district's solve on the (1, 2)
    gloo mesh of two ranks sharing ``device``; rank 0 prints its wall."""
    import torch

    from ndt_2d_tpu_torch.parallel import distributed, mesh as mesh_mod
    dev = distributed.initialize(device, backend="gloo")
    r = district_on_mesh(mesh_mod.make_mesh(shape=(1, 2)), dev)
    print(f"[4q] district PCG solve on the (1, 2) gloo mesh alone, rank 0: "
          f"wall {r['district_wall']:.3f} s, {r['district_lm']} LM "
          f"iterations, launches "
          f"{ {k: int(r[f'district_{k}']) for k in CG_FORMS} } ({ident})",
          flush=True)
    distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def mesh_district_times(dev, ident: str, runs: int = 2) -> None:
    """``--mesh-district``: the district's solve on the (1, 2) gloo mesh
    ``runs`` times, two ranks sharing the card (also in an older
    checkout: ``solve_multichip`` is the mesh's public entry)."""
    from ndt_2d_tpu_torch.parallel import distributed
    for _ in range(runs):
        distributed.launch([sys.executable, os.path.abspath(__file__),
                            "--mesh-district-rank", str(dev), ident], 2,
                           timeout=900)


def phase_mesh_shared(cfg, bag, single10, district_poses, district_truth,
                      map4, tmp, dev):
    """Two ranks sharing the one card over gloo (their collectives staged
    through the host), on meshes (2, 1) and (1, 2): config 10
    synchronously, the district's PCG solve and config 4's 5000-particle
    measurement.  Correctness and the cost of host-staged collectives, not
    scaling.  Returns, per mesh shape, rank 0's launches of the district
    solve's CG loop by form (``CG_FORMS``) and of ``pcg_solve``."""
    import numpy as np

    from ndt_2d_tpu_torch.parallel import distributed
    smi = shutil.which("nvidia-smi")
    mode = subprocess.run(
        [smi, "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
        check=False).stdout.strip() if smi else "nvidia-smi: not found"
    print(f"[4q] compute mode: {mode}")

    def rmse(p):
        return float(np.sqrt(np.mean(np.sum(
            (p[:, :2] - district_truth[:, :2]) ** 2, -1))))
    rows = {}
    for shape in ((2, 1), (1, 2)):
        out = os.path.join(tmp, f"mesh{shape[0]}x{shape[1]}")
        os.makedirs(out)
        t0 = time.perf_counter()
        distributed.launch([sys.executable, os.path.abspath(__file__),
                            "--mesh-rank", out, str(shape[0]), str(shape[1]),
                            map4, str(dev)], 2, timeout=900)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with np.load(os.path.join(out, f"rank{r}.npz")) as z:
                ranks.append({k: z[k] for k in z.files})
        a, b = ranks
        tag = f"({shape[0]}, {shape[1]})"
        for k in ("poses", "grid", "district", "measure"):
            require(np.array_equal(a[k], b[k]), f"mesh {tag}: {k} differs "
                    "between the ranks")
        require(not a["jax"] and not b["jax"], "a rank imported jax")
        require(int(a["accepted"]) == single10["stats"]["scans_accepted"],
                f"mesh {tag}: config 10 accepted {int(a['accepted'])}")
        require(int(a["closures"]) >= 1 and int(a["optimizations"]) >= 1
                and float(a["final"]) < float(a["odom"])
                and abs(float(a["final"]) - single10["final"]) < MESH_ATE_GAP,
                f"mesh {tag}: config 10 {int(a['closures'])} closures, final "
                f"ATE {float(a['final'])} (single-device "
                f"{single10['final']})")
        dd = float(np.abs(a["district"] - district_poses).max())
        require(bool(a["district_ok"]) and dd <= 5e-3
                and rmse(a["district"]) <= 0.05,
                f"mesh {tag}: district solve {dd} from single-device, RMSE "
                f"{rmse(a['district'])}")
        require(bool(a["measure_equal"]) and bool(b["measure_equal"]),
                f"mesh {tag}: the sharded measurement differs from K3")
        lm = int(a["district_lm"])
        counts = {k: int(a[f"district_{k}"])
                  for k in MESH_DISTRICT_KERNELS}
        # The planned loop: a phase is one matvec and the two dot
        # variants; a solve's first two matvecs take v as given, the
        # others form the direction; nothing launches the public dots or
        # pcg_solve.
        phases = counts["pcg_matvec"] + counts["pcg_matvec_direction"]
        require(counts["pcg_solve"] == 0 and counts["fixed_dot"] == 0
                and counts["normal_blocks"] == lm
                and counts["preconditioner"] == lm
                and counts["pcg_normal_system"] == 0
                and counts["pcg_matvec"] >= lm
                and counts["pcg_matvec_direction"] >= 1
                and counts["fixed_dot_damp"] == phases
                and counts["fixed_dot_update"] == phases,
                f"mesh {tag}: the district solve's {lm} LM iterations "
                f"launched {counts}")
        rows[shape] = counts
        print(f"[4q] two ranks on cuda:0, mesh {tag} over gloo: config 10 "
              f"{int(a['accepted'])} accepted, {int(a['closures'])} closures "
              f"/ {int(a['optimizations'])} optimizations, ATE online "
              f"{float(a['ate']):.4f} final {float(a['final']):.4f} m "
              f"(odometry {float(a['odom']):.4f}), {float(a['ms']):.3f} ms "
              f"per accepted scan, session {float(a['wall']):.3f} s; "
              f"district PCG solve {float(a['district_wall']):.3f} s, RMSE "
              f"{rmse(a['district']):.4f} m, {dd:.2e} from the single-device "
              f"solve, {lm} LM iterations, planned CG loop launches "
              f"pcg_matvec {counts['pcg_matvec']} plain and "
              f"{counts['pcg_matvec_direction']} forming the direction, "
              f"fixed_dot variant (A) {counts['fixed_dot_damp']} and (B) "
              f"{counts['fixed_dot_update']}, public {counts['fixed_dot']}, "
              f"normal_blocks {counts['normal_blocks']} and the standalone "
              f"preconditioner {counts['preconditioner']} (after the "
              f"combine); "
              f"{PARTICLES}-particle measurement bitwise equal to "
              f"unsharded K3; host-staged all_gather of "
              f"{9 * DISTRICT_NODES} floats {float(a['gather_ms']):.4f} ms; "
              f"final poses, export, solve and scores bitwise equal on both "
              f"ranks; launch + both ranks {wall:.1f} s")
    return rows


# --- K12·blocks: the stripe-sharded map (KB1-KB3), the fused SLAM step (KB4)
# and the dry run of the multi-device pipeline.
KB_KERNELS = ("ndt_build_stripe", "stripe_score", "stripe_field",
              "field_match", "candidate_finalize_append")
BLOCK_SHAPES = ((2, 1), (1, 2), (2, 2))
SLAM_CAPACITY = 256       # scans and constraints of the fused step's state
SLAM_OPTIMIZE_EVERY = 8
MAP4_SCANS = 150          # config 4's localization bag (seed 7)


def blocks_map(path, cfg, range_max, dev):
    """The loaded map's global matcher (K1's dense grid, auto-sized by the
    mapper) and the map's keyframes as device tensors."""
    import torch
    loc = localizer(cfg, path, dev, 3)
    loc._ensure_matchers(range_max)
    g = loc.graph
    n = g.num_scans
    keyframes = dict(
        poses=torch.tensor(g.poses[:n], dtype=torch.float32, device=dev),
        points=torch.tensor(g.points[:n], device=dev),
        point_mask=torch.tensor(g.point_mask[:n], device=dev),
        window_mask=torch.ones(n, dtype=torch.bool, device=dev))
    return loc.global_matcher, keyframes


def stripe_of(m, keyframes, S: int, s: int):
    """Stripe s of S of the map (KB1), as ndt_blocks holds it."""
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    mc = m.config
    h = mc.grid_cells_y // S
    return k1.build_stripe(**keyframes, origin=m.grid.origin,
                           cell_size=mc.ndt_resolution,
                           width=mc.grid_cells_x, row0=s * h, rows=h), h


def stripe_keys(mc, origin, cell, x, y, ok, row0: int, rows: int):
    """Distinct stripe cells (iy - row0) * W + ix of world points (x, y)
    binned against the map's origin, where ``ok``."""
    import torch
    W = mc.grid_cells_x
    ix = torch.floor((x - origin[0]) / cell).long()
    iy = torch.floor((y - origin[1]) / cell).long()
    ok = ok & (ix >= 0) & (ix < W) & (iy >= row0) & (iy < row0 + rows)
    return torch.unique(((iy - row0) * W + ix)[ok])


def particle_poses(center, M: int, dev):
    """M poses around ``center`` [3] (sd 0.2 m, 0.2 m, 0.05 rad), seed 11:
    the particles of config 4's measurement checks."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(11)
    return (center + torch.randn(M, 3, generator=gen, device=dev)
            * torch.tensor([0.2, 0.2, 0.05], device=dev)).contiguous()


def map4_scan(bag4, t: int, cfg, dev):
    """Config 4's scan t (projected) and the particles around its truth."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.mapping import laser
    from ndt_2d_tpu_torch.utils import metrics
    pts, msk = laser.project_scan(bag4[t][0], bag4.range_max, np.zeros(3),
                                  False, None, cfg.max_points_per_scan)
    center = torch.tensor(metrics.relative_to_first(bag4.truth)[t],
                          dtype=torch.float32, device=dev)
    return (torch.tensor(pts, device=dev), torch.tensor(msk, device=dev),
            int(msk.sum()), center)


def phase_kb(path4, bag4, dev):
    """KB1-KB4 against their twins on the card at the main path's shapes:
    KB1 on stripe 0 of 2 of config 4's map (and every stripe of 2 and 4
    bitwise the dense K1 rows), KB2 over the 5000 particles and the scan's
    world points on that stripe, KB3's field of one localization scan on
    it and its reduction on the summed field, KB4 on the fused step's
    256-slot state; bitwise, with times and bounds."""
    import torch

    from ndt_2d_tpu_torch.core import pose as pose_ops
    from ndt_2d_tpu_torch.io.bag import record_synthetic
    from ndt_2d_tpu_torch.kernels import candidate_gather as k6
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.kernels import score_points as k3
    from ndt_2d_tpu_torch.kernels import slam_step as kb4
    from ndt_2d_tpu_torch.parallel import slam_step
    _, cfg = config4_configs()
    m, kf = blocks_map(path4, cfg, bag4.range_max, dev)
    mc, grid = m.config, m.grid
    W, H, cell = mc.grid_cells_x, mc.grid_cells_y, mc.ndt_resolution
    out = {}
    # KB1: every stripe of 2 and 4 bitwise the dense rows and its twin.
    for S in (2, 4):
        for s in range(S):
            (g, tab), h = stripe_of(m, kf, S, s)
            gt, tabt = k1.build_stripe_twin(**kf, origin=grid.origin,
                                            cell_size=cell, width=W,
                                            row0=s * h, rows=h)
            rows = slice(s * h * W, (s + 1) * h * W)
            for f in ("mean", "information", "count", "covariance"):
                require(torch.equal(getattr(g, f), getattr(gt, f)),
                        f"KB1 stripe {s} of {S}: {f} differs from its twin")
                require(torch.equal(getattr(g, f), getattr(grid, f)[rows]),
                        f"KB1 stripe {s} of {S}: {f} differs from the dense "
                        "K1 rows")
            require(torch.equal(tab, tabt), f"KB1 stripe {s} of {S}: table "
                    "differs from its twin")
    (g, tab), h = stripe_of(m, kf, 2, 0)
    n_pts = kf["points"].shape[0] * kf["points"].shape[1]
    print(f"[3] KB1 ndt_build_stripe: config 4's {W}x{H} map of "
          f"{kf['poses'].shape[0]} keyframes in 2 and 4 stripes, every "
          f"stripe bitwise its twin and the dense K1 rows")
    stripe_args = dict(**kf, origin=grid.origin, cell_size=cell, width=W,
                       row0=0, rows=h)
    out["ndt_build_stripe"] = timed(
        0.0, cuda_ms(lambda: k1.build_stripe(**stripe_args), 20),
        cuda_ms(lambda: k1.build_stripe_twin(**stripe_args), 3),
        nbytes(*kf.values(), grid.origin, g.mean, g.information,
               g.covariance, g.count, tab),
        ops_ndt_build(1, 1, n_pts, h * W))

    # KB2 over config 4's 5000 particles, and over the scan's world points:
    # the particle launch's record read against its twin, the SoA twin and
    # the SoA launch (the parent design), on stripe 0 and on stripe 1 (row0
    # = h), and at config 7's 20,000 particles.
    q, qm, n, center = map4_scan(bag4, 40, cfg, dev)
    poses = particle_poses(center, PARTICLES, dev)
    B = mc.laser_max_beams
    (g1, tab1), _ = stripe_of(m, kf, 2, 1)
    for sg, stab, row0, M in ((g, tab, 0, PARTICLES), (g1, tab1, h, PARTICLES),
                              (g, tab, 0, GLOBAL_PARTICLES)):
        ps = poses if M == PARTICLES else particle_poses(center, M, dev)
        soa_args = (sg, W, row0, h, B, q, qm, n, ps)
        sc = k3.stripe_poses(sg, stab, W, row0, h, B, q, qm, n, ps)
        sct = k3.records_twin(sg, stab, W, h, B, q, qm, n, ps, row0, True)
        require(torch.equal(sc, sct), f"KB2 (poses, row0 {row0}, {M}) "
                "differs from its twin")
        require(torch.equal(sc, k3.stripe_poses_twin(*soa_args))
                and torch.equal(sc, k3.stripe_poses_soa(*soa_args)),
                f"KB2 (poses, row0 {row0}, {M}) differs from the SoA twin "
                "or launch")
        require(torch.equal(sc, k3.stripe_poses(sg, stab, W, row0, h, B, q,
                                                qm, n, ps)),
                "KB2 not bitwise reproducible")
    a2 = (g, tab, W, 0, h, B, q, qm, n, poses)
    soa2 = (g, W, 0, h, B, q, qm, n, poses)
    world = pose_ops.transform_points(center, q).contiguous()
    P = world.shape[0]
    identity = torch.zeros(1, 3, device=dev)
    wp, wpt = (k3.stripe_points(g, tab, W, 0, h, world, qm),
               k3.stripe_points_twin(g, W, 0, h, world, qm))
    wsoa = -k3.stripe_poses_soa(g, W, 0, h, P, world, qm, P, identity)
    require(torch.equal(wp, wpt) and torch.equal(wp, wsoa),
            "KB2 (points) differs from its twin or the SoA launch")
    spts, smask, used = used_beams(mc, q, qm, n)
    c, s_ = torch.cos(poses[:, 2:3]), torch.sin(poses[:, 2:3])
    x = c * spts[:, 0] - s_ * spts[:, 1] + poses[:, 0:1]
    y = s_ * spts[:, 0] + c * spts[:, 1] + poses[:, 1:2]
    keys = stripe_keys(mc, grid.origin, cell, x, y,
                       smask[None].expand_as(x), 0, h)
    new_graph = graph_ms(lambda: k3.stripe_poses(*a2), 20)
    soa_graph = graph_ms(lambda: k3.stripe_poses_soa(*soa2), 20)
    out["stripe_score"] = timed(
        0.0, cuda_ms(lambda: k3.stripe_poses(*a2), 20),
        cuda_ms(lambda: k3.records_twin(g, tab, W, h, B, q, qm, n, poses, 0,
                                        True), 3),
        cell_bytes(keys, g.count) + used * 9 + PARTICLES * 16,
        PARTICLES * used * 20, graph_ms=(new_graph, None))
    wkeys = stripe_keys(mc, grid.origin, cell, world[:, 0], world[:, 1], qm,
                        0, h)
    pts_ms = cuda_ms(lambda: k3.stripe_points(g, tab, W, 0, h, world, qm), 20)
    pts_graph = graph_ms(lambda: k3.stripe_points(g, tab, W, 0, h, world,
                                                  qm), 20)
    pts_soa = graph_ms(lambda: k3.stripe_poses_soa(g, W, 0, h, P, world, qm,
                                                   P, identity), 20)
    # The one-pose forms of the record read, each launch alone: a block
    # (the entry's form at M = 1) and warps (the particle launch at M = 2,
    # the same identity twice: a warp a pose).
    twice = torch.zeros(2, 3, device=dev)
    wblock = k3.stripe_poses(g, tab, W, 0, h, P, world, qm, P, identity)
    wwarps = k3.stripe_poses(g, tab, W, 0, h, P, world, qm, P, twice)
    require(torch.equal(-wblock, wp) and torch.equal(wwarps, wblock.expand(2)),
            "KB2 (points): the record read's block and warp forms differ")
    pts_block = graph_ms(lambda: k3.stripe_poses(g, tab, W, 0, h, P, world,
                                                 qm, P, identity), 20)
    pts_warps = graph_ms(lambda: k3.stripe_poses(g, tab, W, 0, h, P, world,
                                                 qm, P, twice), 20)
    pts_bound = timed(0.0, pts_ms, 0.0,
                      cell_bytes(wkeys, g.count) + P * 9 + 16, P * 20)
    print(f"[3] KB2 stripe_score: {PARTICLES} particles on stripe 0 and on "
          f"stripe 1 of 2, {GLOBAL_PARTICLES} on stripe 0, and the scan's "
          f"{int(qm.sum())} world points ({float(wp):.4f}): the particle "
          f"launch reading KB1's stripe table (one record a beam) bitwise "
          f"its twin (records_twin at row0), the SoA twin and the SoA "
          f"launch, reproducible; {PARTICLES} particles "
          f"{out['stripe_score']['ms']:.4f} ms, in a CUDA graph "
          f"{new_graph:.5f} ms [SoA launch {soa_graph:.5f}], bound "
          f"{out['stripe_score']['bound_ms']:.6f} ms "
          f"({out['stripe_score']['bound_by']}); world points (one block) "
          f"{pts_ms:.4f} ms, graph {pts_graph:.5f} with its sign flip, the "
          f"launch alone {pts_block:.5f} [a warp a pose, M = 2: "
          f"{pts_warps:.5f}; SoA launch {pts_soa:.5f}], bound "
          f"{pts_bound['bound_ms']:.8f} ({pts_bound['bound_by']}); library: "
          f"none (gather + exp + sum: no one call)")

    # KB3: one localization scan's field on stripe 0 of 2, into a plan's
    # send buffer; the match of both stripes' fields in one launch reading
    # the plan's stack in place, against its twin, the parent chain (K12's
    # rank_sum, the reduction's partials, K2's fold) and, at one stripe,
    # the dense K6 row.
    from ndt_2d_tpu_torch.kernels import shard_combine
    loc_bag = record_synthetic("box", MAP4_SCANS, n_beams=360, seed=7,
                               odom_trans_noise=0.01)
    lq, lqm, ln, lcenter = map4_scan(loc_bag, 20, cfg, dev)
    start = (lcenter + torch.tensor([0.02, -0.01, 0.01], device=dev))
    dths, dls = k2.search_offsets(mc, dev)
    A, L = dths.numel(), dls.numel()
    a3 = (mc, g, tab, 0, h, lq, lqm, ln, start, dths, dls)
    f0, f0t = k6.stripe_field(*a3), k6.stripe_field_twin(*a3)
    require(torch.equal(f0, f0t), "KB3 field differs from its twin")
    require(torch.equal(f0, k6.stripe_field(*a3)),
            "KB3 field not bitwise reproducible")
    plan = k6.field_plan(dev, 2, A, L)
    stack = plan.stack.view(2, A, L, L)
    require(k6.stripe_field(*a3, out=plan.send) is plan.send
            and torch.equal(plan.send, f0),
            "KB3 field into the plan's send buffer differs")
    stack[0].copy_(plan.send)  # rank 0's part of the gather
    k6.stripe_field(mc, g1, tab1, h, h, lq, lqm, ln, start, dths, dls,
                    out=stack[1])

    def match():
        return k6.field_match(mc, plan, plan.stack, ln, dths, dls)
    row = match()
    row_t = k6.field_match_twin(mc, plan.stack, ln, dths, dls)
    chain = k6.finalize_rows(mc, k2.block_partials(
        shard_combine.rank_sum(stack), dths, dls, 0, k6.TILE)[None], ln,
        dths, dls)[0]
    # Back to back on the stream: each launch's last block resets the
    # ticket for the next.
    again = torch.stack([match() for _ in range(MESH_REPEATS)])
    torch.cuda.synchronize()
    require(torch.equal(row, row_t), "KB3 match differs from its twin")
    require(torch.equal(row, chain), "KB3 match differs from the parent "
            "chain (rank_sum, the partials, K2's fold)")
    require(torch.equal(again, row.expand_as(again)),
            "KB3 match not bitwise reproducible back to back")
    # One stripe: the whole map's field, whose match is the dense K6 row.
    plan1 = k6.field_plan(dev, 1, A, L)
    k6.stripe_field(mc, grid, m.packed_table, 0, H, lq, lqm, ln, start,
                    dths, dls, out=plan1.send)

    def match1():
        return k6.field_match(mc, plan1, plan1.send[None], ln, dths, dls)
    one = match1()
    dense = k6.match(mc, grid, m.packed_table, lq, lqm, ln, start, dths, dls)
    require(torch.equal(one, dense[0]), "KB3 match at one stripe differs "
            "from the dense K6 row")
    # Odd and many stripes (3, 13) and odd lattices (7x5x5, 9x33x33: tiles
    # that start at any address), random fields: bitwise the twin.
    gen = torch.Generator(device=dev).manual_seed(11)
    shapes = ((3, A, L), (13, A, L), (2, 7, 5), (2, 9, 33))
    for S, a_, l_ in shapes:
        d_ = dths[:a_].contiguous()
        l2 = torch.linspace(-0.2, 0.2, l_, device=dev)
        pl = k6.field_plan(dev, S, a_, l_)
        pl.stack.copy_(torch.randn(S, a_ * l_ * l_, generator=gen,
                                   device=dev))
        r_ = k6.field_match(mc, pl, pl.stack, ln, d_, l2)
        require(torch.equal(r_, k6.field_match_twin(mc, pl.stack, ln, d_,
                                                     l2)),
                f"KB3 match of {S} stripes of {a_}x{l_}x{l_} differs from "
                "its twin")
    launched = k6.field_match_launches
    graph2, graph1 = graph_ms(match, 20), graph_ms(match1, 20)
    lib2 = graph_ms(lambda: torch.sum(stack, 0), 20)
    lib1 = graph_ms(lambda: torch.sum(plan1.send[None], 0), 20)
    # The parent chain's pieces the package still has: the fold of the
    # same partials as a launch of its own (K2's finalize), and rank_sum.
    parts = k2.block_partials(shard_combine.rank_sum(stack), dths, dls, 0,
                              k6.TILE)[None]
    fold_alone = graph_ms(lambda: k6.finalize_rows(mc, parts, ln, dths,
                                                   dls), 20)
    sum_alone = graph_ms(lambda: shard_combine.rank_sum(stack), 20)
    host2, host1 = host_us(match, 30, sync=True), host_us(match1, 30,
                                                          sync=True)
    ops = [graph_nodes(match), graph_nodes(match1)]
    require(ops == [["kernel"], ["kernel"]],
            f"KB3 match: device operations {ops}, expected one kernel")
    print(f"[3] KB3 stripe_field + field_match: {A}x{L}x{L} candidates x "
          f"{B} beams on stripe 0 of 2, the field bitwise its twin (also "
          f"into the plan's send buffer); the match of 2 stripes' fields "
          f"(one launch, one device operation, reading the plan's stack) "
          f"bitwise its twin, the parent chain and itself "
          f"{MESH_REPEATS} times back to back; at one stripe bitwise the "
          f"dense K6 row; {len(shapes)} more stacks (3 and 13 stripes, "
          f"7x5x5, 9x33x33) bitwise the twin; two stripes' score "
          f"{float(row[0]):.6f}, dense K6 {float(dense[0, 0]):.6f}, "
          f"corrections equal: {torch.equal(row[1:4], dense[0, 1:4])}; "
          f"graph S = 2 {graph2:.5f} ms [torch.sum(stack, 0) {lib2:.5f}], "
          f"S = 1 {graph1:.5f} [{lib1:.5f}]; the fold of the same partials "
          f"as a launch of its own (K2's finalize) {fold_alone:.5f}, "
          f"rank_sum of the stack {sum_alone:.5f}; host {host2:.1f} / "
          f"{host1:.1f} us a match ({launched} launches here)")
    th = start[2] + dths
    c, s_ = torch.cos(th)[:, None], torch.sin(th)[:, None]
    lsp, lsm, lused = used_beams(mc, lq, lqm, ln)
    lsp = lsp[lsm]
    rx = c * lsp[:, 0] - s_ * lsp[:, 1] + start[0]
    ry = s_ * lsp[:, 0] + c * lsp[:, 1] + start[1]
    xs = rx[:, :, None, None] + dls[None, None, :, None]
    ys = ry[:, :, None, None] + dls[None, None, None, :]
    xs, ys = torch.broadcast_tensors(xs, ys)
    fkeys = stripe_keys(mc, grid.origin, cell, xs, ys,
                        torch.ones_like(xs, dtype=torch.bool), 0, h)
    out["stripe_field"] = timed(
        0.0, cuda_ms(lambda: k6.stripe_field(*a3), 20),
        cuda_ms(lambda: k6.stripe_field_twin(*a3), 3),
        fkeys.numel() * 32 + lused * 9 + 12 + f0.numel() * 4,
        A * L * L * lused * 30)
    # The match's bound: each stripe's field read once, the lattice, the
    # row written; the rank-ordered adds and reduce_tile's 22 operations
    # a candidate.  The kernels line's row is [4r]'s shape (one rank: S =
    # 1); S = 2 beside it.
    for key, fn, st, lib, graph in (
            ("field_match", match1, plan1.send[None], lib1, graph1),
            ("field_match_s2", match, stack, lib2, graph2)):
        out[key] = timed(
            0.0, cuda_ms(fn, 20),
            cuda_ms(lambda st=st: k6.field_match_twin(mc, st, ln, dths,
                                                      dls), 3),
            nbytes(st, dths, dls) + 13 * 4,
            (st.shape[0] - 1) * A * L * L + A * L * L * 22,
            library_ms=cuda_ms(lambda st=st: torch.sum(st, 0), 20),
            graph_ms=(graph, lib))

    # KB4 on the fused step's 256-slot state, config 2's 512-point scans.
    P = 512
    gen = torch.Generator(device=dev).manual_seed(5)

    def state():
        st = slam_step.init_state(SLAM_CAPACITY, P, SLAM_CAPACITY, dev)
        st.prev_pose.copy_(torch.tensor([1.0, 2.0, 0.3], device=dev))
        return st
    scan = torch.randn(P, 2, generator=gen, device=dev)
    smsk = torch.rand(P, generator=gen, device=dev) > 0.2
    est = torch.tensor([1.2, 2.05, 0.31], device=dev)
    corr = torch.tensor([0.005, -0.01, 0.0025], device=dev)
    cov = torch.tensor([[2e-4, 1e-5, 2e-6], [1e-5, 3e-4, -1e-6],
                        [2e-6, -1e-6, 4e-5]], device=dev)
    a4 = (est, corr, cov, scan, smsk, 7, 6, True)
    st, stt = state(), state()
    kb4.append(st, *a4)
    kb4.append_twin(stt, *a4)
    for f in ("poses", "points", "point_mask", "c_begin", "c_end",
              "c_transform", "c_information", "prev_pose"):
        require(torch.equal(getattr(st, f), getattr(stt, f)),
                f"KB4: {f} differs from its twin")
    # 64 more into a chain of slots (est and the correction moving a
    # step), every field bitwise the twin's.
    st, stt = state(), state()
    for k in range(MESH_REPEATS):
        ak = (est + 0.01 * k, corr * (1.0 + 0.1 * k), cov, scan, smsk, k,
              max(k - 1, 0), k > 0)
        kb4.append(st, *ak)
        kb4.append_twin(stt, *ak)
    torch.cuda.synchronize()
    for f in ("poses", "points", "point_mask", "c_begin", "c_end",
              "c_transform", "c_information", "prev_pose"):
        require(torch.equal(getattr(st, f), getattr(stt, f)),
                f"KB4 chain: {f} differs from its twin")
    st = state()
    out["slam_append"] = timed(
        0.0, cuda_ms(lambda: kb4.append(st, *a4), 50),
        cuda_ms(lambda: kb4.append_twin(st, *a4), 10),
        nbytes(est, corr, cov, scan, smsk) * 2 + 4 * (3 + 3 + 9 + 2), 150,
        graph_ms=(graph_ms(lambda: kb4.append(st, *a4), 50), None))
    print(f"[3] KB4 slam_append (through the state's plan): slot 7 of "
          f"{SLAM_CAPACITY} scans x {P} points, constraint slot 6: poses, "
          f"points, mask, constraint and previous pose bitwise equal to the "
          f"twin; {MESH_REPEATS} appends into a chain of slots bitwise the "
          f"twin's")
    return out


def blocks_map_run(mesh, dev, map4, map7) -> dict:
    """[4r] on ``mesh``: config 4's map in stripes over 'space' (KB1, each
    stripe bitwise the dense K1 rows), its 5000-particle measurement over
    both axes (KB2) against the dense K3 batch, all 150 localization scans
    matched against the stripes (KB3) from the dense chain's start poses
    against the dense K6 match, and config 7's 20,000 particles on its
    office map."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.core import pose as pose_ops
    from ndt_2d_tpu_torch.io.bag import record_synthetic
    from ndt_2d_tpu_torch.kernels import candidate_gather as k6
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import score_points as k3
    from ndt_2d_tpu_torch.kernels import shard_combine
    from ndt_2d_tpu_torch.mapping import laser
    from ndt_2d_tpu_torch.parallel import ndt_blocks
    from ndt_2d_tpu_torch.parallel import mesh as mesh_mod
    from ndt_2d_tpu_torch.utils import metrics
    out = {}
    space = mesh_mod.axis_size(mesh, mesh_mod.SPACE_AXIS)
    _, cfg = config4_configs()
    bag4 = record_synthetic("box", 150, n_beams=360, seed=2)
    m, kf = blocks_map(map4, cfg, bag4.range_max, dev)
    mc, grid = m.config, m.grid
    W, H = mc.grid_cells_x, mc.grid_cells_y
    t0 = time.perf_counter()
    sg = ndt_blocks.build_ndt_sharded(mesh, *kf.values(), grid.origin,
                                      mc.ndt_resolution, W, H)
    rows = slice(sg.row0 * W, (sg.row0 + sg.rows) * W)
    out["stripes_equal"] = all(
        torch.equal(getattr(sg, f), getattr(grid, f)[rows])
        for f in ("mean", "information", "count", "covariance"))
    full = ndt_blocks.gather_grid(mesh, sg)
    out["gathered_equal"] = all(
        torch.equal(getattr(full, f), getattr(grid, f))
        for f in ("mean", "information", "count", "covariance"))
    # 5000 particles.
    q, qm, n, center = map4_scan(bag4, 40, cfg, dev)
    poses = particle_poses(center, PARTICLES, dev)
    w = ndt_blocks.score_particles_sharded_map(mc, mesh, sg, q, qm, n, poses)
    wd = k3.score_batch(grid, W, H, mc.laser_max_beams, q, qm, n, poses)
    out["weights"] = w.cpu().numpy()
    out["weights_rel"] = float(((w - wd).abs() / wd.abs().clamp(
        min=1e-30)).max())
    out["weights_equal_dense"] = bool(torch.equal(w, wd))
    # The 150 localization scans: a dense K6 chain gives every start.
    loc_bag = record_synthetic("box", MAP4_SCANS, n_beams=360, seed=7,
                               odom_trans_noise=0.01)
    dths, dls = k2.search_offsets(mc, dev)
    rel = metrics.relative_to_first(loc_bag.truth)
    start = np.asarray(rel[0], np.float64)
    rows_d, rows_s, parted = [], [], []
    match_s, sums, folds = 0.0, shard_combine.launches, k6.finalize_launches
    for t in range(MAP4_SCANS):
        pts, msk = laser.project_scan(loc_bag[t][0], loc_bag.range_max,
                                      np.zeros(3), False, None,
                                      cfg.max_points_per_scan)
        q, qm = torch.tensor(pts, device=dev), torch.tensor(msk, device=dev)
        nt = int(msk.sum())
        pose = torch.tensor(start, dtype=torch.float32, device=dev)
        dense = k6.match(mc, grid, m.packed_table, q, qm, nt, pose, dths,
                         dls)[0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = ndt_blocks.match_scan_sharded_map(mc, mesh, sg, q, qm, nt,
                                                pose)
        sharded = torch.cat([res.score.reshape(1), res.correction,
                             res.covariance.reshape(9)])
        torch.cuda.synchronize()
        match_s += time.perf_counter() - t1
        rows_d.append(dense.cpu().numpy())
        rows_s.append(sharded.cpu().numpy())
        if not torch.equal(sharded[1:4], dense[1:4]):
            parted.append(t)
        corrected = torch.tensor(start + rows_d[-1][1:4])
        if t + 1 < MAP4_SCANS:
            start = pose_ops.compose(corrected, pose_ops.relative(
                *torch.tensor(loc_bag.odom[t:t + 2]))).numpy()
    out["match_dense"], out["match"] = np.stack(rows_d), np.stack(rows_s)
    out["match_parted"] = np.asarray(parted, np.int64)
    # The sharded matches' own seconds, and the rank sums and K6 folds
    # they launched (none: the stack is summed inside KB3's match).
    out["match_seconds"] = match_s
    out["match_rank_sums"] = shard_combine.launches - sums
    out["match_folds"] = k6.finalize_launches - folds
    # Config 7's 20,000 particles on the office map.
    truth7, _, cfg7, scan7 = config7()
    m7, kf7 = blocks_map(map7, cfg7, 14.0, dev)
    mc7 = m7.config
    sg7 = ndt_blocks.build_ndt_sharded(mesh, *kf7.values(), m7.grid.origin,
                                       mc7.ndt_resolution, mc7.grid_cells_x,
                                       mc7.grid_cells_y)
    pts, msk = laser.project_scan(scan7(10, 10), 14.0, np.zeros(3), False,
                                  None, cfg7.max_points_per_scan)
    q, qm = torch.tensor(pts, device=dev), torch.tensor(msk, device=dev)
    poses7 = particle_poses(kf7["poses"][10], GLOBAL_PARTICLES, dev)
    w7 = ndt_blocks.score_particles_sharded_map(mc7, mesh, sg7, q, qm,
                                                int(msk.sum()), poses7)
    wd7 = k3.score_batch(m7.grid, mc7.grid_cells_x, mc7.grid_cells_y,
                         mc7.laser_max_beams, q, qm, int(msk.sum()), poses7)
    out["weights7"] = w7.cpu().numpy()
    out["weights7_rel"] = float(((w7 - wd7).abs() / wd7.abs().clamp(
        min=1e-30)).max())
    out["weights7_equal_dense"] = bool(torch.equal(w7, wd7))
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    out["space"] = space
    out["grid"] = f"{W}x{H}"
    return out


def slam_run(mesh, dev) -> dict:
    """[4s] on ``mesh``: config 2's corridor (200 scans, 600 beams, 512
    points, 192^2 grids, 80x21x21 x 100 beams) through the fused step,
    optimizing every 8 scans, capacity 256 scans / 256 constraints; the
    odometry deltas added in the map frame, as the JAX dry run adds
    them."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.io.bag import record_synthetic
    from ndt_2d_tpu_torch.mapping import laser
    from ndt_2d_tpu_torch.parallel import slam_step
    from ndt_2d_tpu_torch.device import upload
    from ndt_2d_tpu_torch.utils import metrics
    from ndt_2d_tpu_torch.config import MapperConfig, ScanMatcherConfig
    bag = record_synthetic("corridor", N_SCANS, n_beams=N_BEAMS, seed=0)
    mcfg = ScanMatcherConfig(grid_cells_x=192, grid_cells_y=192)
    cfg = MapperConfig(local_scan_matcher=mcfg, global_scan_matcher=mcfg,
                       max_points_per_scan=512, loop_closure_every=10**9)
    odom = metrics.relative_to_first(bag.odom)
    scans = []
    for t in range(N_SCANS):
        p, k = laser.project_scan(bag[t][0], bag.range_max, np.zeros(3),
                                  False, None, cfg.max_points_per_scan)
        d = odom[t] - odom[t - 1] if t else np.zeros(3)
        d[2] = (d[2] + np.pi) % (2 * np.pi) - np.pi
        scans.append((upload(p, dev), upload(k, dev),
                      upload(d.astype(np.float32), dev), int(k.sum())))
    step = slam_step.make_slam_step(mesh, cfg, bag.range_max,
                                    SLAM_OPTIMIZE_EVERY)
    state = slam_step.init_state(SLAM_CAPACITY, cfg.max_points_per_scan,
                                 SLAM_CAPACITY, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p, k, d, n in scans:
        state, _ = step(state, p, k, d, num_points=n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    poses = state.poses[:state.num_scans].cpu().numpy().astype(np.float64)
    return dict(slam_poses=poses, slam_steps_per_s=N_SCANS / wall,
                slam_ate=metrics.ate_rmse(poses, bag.truth),
                slam_odom_ate=metrics.ate_rmse(bag.odom, bag.truth),
                slam_scans=state.num_scans, slam_constraints=state.c_num)


def poses_digest(poses) -> str:
    """The first 16 hex digits of the sha256 of [4s]'s final poses (float32
    bytes, as the state held them)."""
    import hashlib

    import numpy as np
    return hashlib.sha256(np.asarray(poses, np.float32).tobytes()
                          ).hexdigest()[:16]


def slam_times(dev, ident: str, runs: int = 3) -> dict:
    """``--slam-times``: [4s]'s fused step (``slam_run``) ``runs`` times on
    a one-rank NCCL mesh and on one device, each run's steps/s, the final
    poses' sha256 and KB4's launches by form; then the sha256 of K2's
    one-launch rows at config 2's window and over 64 config-3 rows.  It
    calls only public entries, so a copy run inside an older checkout
    times and hashes that tree."""
    import hashlib

    import torch
    import torch.distributed as dist

    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.kernels import slam_step as kb4
    from ndt_2d_tpu_torch.matching import matcher
    from ndt_2d_tpu_torch.parallel import distributed, mesh as mesh_mod

    def counts():
        return (kb4.launches, getattr(k2, "finalize_append_launches", 0))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        distributed.initialize(dev, init_method="file://" + os.path.join(
            tmp, "slam_rendezvous"), world_size=1, rank=0)
        try:
            mesh = mesh_mod.make_mesh(1)
            for name, m in (("one NCCL rank", mesh), ("one device", None)):
                rates, digests = [], []
                for _ in range(runs):
                    before = counts()
                    r = slam_run(m, dev)
                    launched = [b - a for a, b in zip(before, counts())]
                    rates.append(r["slam_steps_per_s"])
                    digests.append(poses_digest(r["slam_poses"]))
                out[name] = dict(steps_per_s=rates, sha256=digests,
                                 ate=r["slam_ate"], kb4=launched)
                print(f"[6] [4s] on {name}: steps/s {rates}, poses sha256 "
                      f"{digests}, ATE {r['slam_ate']:.6f} m, KB4 launches "
                      f"(its own, folded into the finalize) {launched} "
                      f"({ident})")
        finally:
            dist.destroy_process_group()

    def digest(t):
        torch.cuda.synchronize()
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
    _, cfg, win, query, _ = inputs(dev)
    mc = cfg.local_scan_matcher
    dths, dls = matcher._search_offsets(mc, dev)
    out["k2_config2"] = digest(k2.match_rows(
        mc, *k2_row(mc, win, query, dev), dths, dls))
    cfg3 = office_config()
    gm = cfg3.global_scan_matcher
    rows = office_rows(cfg3, office_bag(), dev)
    gr, tabs = k1.build_windows(*rows[:4], 12.0, gm.ndt_resolution,
                                gm.grid_cells_x, gm.grid_cells_y)
    dths, dls = matcher._search_offsets(gm, dev)
    out["k2_rows"] = digest(k2.match_rows(gm, gr, tabs, *rows[4:], dths,
                                          dls))
    print(f"[6] K2 one-launch rows sha256: config 2 {out['k2_config2']}, "
          f"{ROWS} config-3 rows {out['k2_rows']} ({ident})")
    return out


def blocks_rank(out_dir, space: int, batch: int, map4: str, map7: str,
                device: str, parts: str) -> int:
    """One gloo rank of ``phase_blocks`` on a (space, batch) mesh whose
    ranks share ``device``: the parts of "r" ([4r]), "s" ([4s]) and "t"
    ([4t], the dry run on the default mesh of the world)."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.entry import dryrun_multichip
    from ndt_2d_tpu_torch.parallel import distributed, mesh as mesh_mod
    dev = distributed.initialize(device, backend="gloo")
    mesh = mesh_mod.make_mesh(shape=(space, batch))
    out = {}
    if "r" in parts:
        out.update(blocks_map_run(mesh, dev, map4, map7))
    if "s" in parts:
        out.update(slam_run(mesh, dev))
    if "t" in parts:
        t0 = time.perf_counter()
        dry = dryrun_multichip(space * batch, dev)
        out["dryrun_seconds"] = time.perf_counter() - t0
        out.update({f"dryrun_{k}": v for k, v in dry.items()})
    out["jax"] = "jax" in sys.modules
    np.savez(os.path.join(out_dir, f"rank{distributed.rank()}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def check_blocks_map(r, tag):
    """[4r]'s gates on one rank's results."""
    import numpy as np
    require(int(r["match_rank_sums"]) == 0 and int(r["match_folds"]) == 0,
            f"{tag}: the sharded matches launched {int(r['match_rank_sums'])}"
            f" rank sums and {int(r['match_folds'])} K6 folds")
    require(bool(r["stripes_equal"]) and bool(r["gathered_equal"]),
            f"{tag}: the stripes differ from the dense K1 rows")
    require(float(r["weights_rel"]) <= 1e-5 and float(r["weights7_rel"])
            <= 1e-5, f"{tag}: the sharded measurement is "
            f"{float(r['weights_rel'])} / {float(r['weights7_rel'])} from "
            "the dense K3 batch (relative)")
    d, s = r["match_dense"], r["match"]
    for t in np.asarray(r["match_parted"]).reshape(-1):
        print(f"{tag} scan {int(t)}: the stripes' winner {s[t, 1:4]} "
              f"(score {s[t, 0]:.7f}) differs from dense K6's {d[t, 1:4]} "
              f"(score {d[t, 0]:.7f})")
        require(abs(s[t, 0] - d[t, 0]) <= 1e-5 * abs(d[t, 0]),
                f"{tag} scan {int(t)}: the scores differ by more than "
                "1e-5 relative")
    if int(r["space"]) == 1:
        require(bool(r["weights_equal_dense"])
                and bool(r["weights7_equal_dense"])
                and np.array_equal(d, s), f"{tag}: at one stripe the "
                "results are not the dense K3 / K6 ones bitwise")


def phase_blocks(map4, map7, dev, tmp):
    """K12·blocks on the card: [4r] the stripe-sharded config-4 map, [4s]
    the fused SLAM step on config 2's corridor and [4t] the port's
    ``dryrun_multichip``, first on a one-rank NCCL mesh (the main path,
    launch counts read around it), then on gloo ranks sharing the card:
    (2, 1) all three, (1, 2) [4r] and [4s], (2, 2) [4r] and the dry run of
    four ranks.  Returns the one-rank run's launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ndt_2d_tpu_torch.entry import dryrun_multichip
    from ndt_2d_tpu_torch.parallel import distributed, mesh as mesh_mod
    distributed.initialize(dev, init_method="file://" + os.path.join(
        tmp, "blocks_rendezvous"), world_size=1, rank=0)
    try:
        mesh = mesh_mod.make_mesh(1)
        reset_counts()
        one = blocks_map_run(mesh, dev, map4, map7)
        one.update(slam_run(mesh, dev))
        torch.cuda.synchronize()
        launches = read_counts()
        reset_counts()
        single = slam_run(None, dev)
        torch.cuda.synchronize()
        single_launches = read_counts()
        t0 = time.perf_counter()
        dryrun_multichip(1, dev)
        dry_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    for k in KB_KERNELS:
        require(launches[k] >= 1, f"[4r]/[4s] never launched {k}: "
                f"{launches}")
    # KB4 folded into the search's finalize on the mesh (K2, no polish),
    # planned on one device; the two runs' poses bitwise equal.
    require(launches["candidate_finalize_append"] == N_SCANS
            and launches["slam_append"] == 0
            and single_launches["slam_append"] == N_SCANS
            and single_launches["candidate_finalize_append"] == 0,
            f"[4s] KB4's launches: mesh {launches}, one device "
            f"{single_launches}")
    require(np.array_equal(one["slam_poses"], single["slam_poses"]),
            "[4s] the folded mesh run's poses differ from one device's "
            "planned run")
    launches["slam_append"] = single_launches["slam_append"]
    digest = poses_digest(one["slam_poses"])
    check_blocks_map(one, "[4r] one rank")
    require(one["slam_ate"] < one["slam_odom_ate"]
            and one["slam_scans"] == N_SCANS
            and one["slam_constraints"] == N_SCANS - 1,
            f"[4s] one rank: ATE {one['slam_ate']} (odometry "
            f"{one['slam_odom_ate']}), {one['slam_scans']} scans, "
            f"{one['slam_constraints']} constraints")
    require(launches["field_match"] == MAP4_SCANS
            and launches["field_fold"] == 0,
            f"[4r] KB3's launches: {launches['field_match']} field_match, "
            f"{launches['field_fold']} K6 folds; expected {MAP4_SCANS}, 0")
    print(f"[4r] config 4's {one['grid']} map on a one-rank NCCL mesh: "
          f"stripe bitwise the dense K1 grid; {PARTICLES} and "
          f"{GLOBAL_PARTICLES} (config 7) particle measurements and all "
          f"{MAP4_SCANS} matches bitwise the dense K3 / K6 results; "
          f"{one['seconds']:.3f} s, the sharded matches "
          f"{float(one['match_seconds']):.4f} s (two launches a match, 0 "
          f"rank sums, 0 K6 folds); launches "
          f"{ {k: launches[k] for k in KB_KERNELS} }")
    print(f"[4s] fused step, config 2 ({N_SCANS} scans) on one NCCL rank: "
          f"{one['slam_steps_per_s']:.1f} steps/s, ATE "
          f"{one['slam_ate']:.4f} m (odometry {one['slam_odom_ate']:.4f}); "
          f"KB4 folded into {launches['candidate_finalize_append']} "
          f"finalize_append launches, 0 of its own; on one device "
          f"{single['slam_steps_per_s']:.1f} steps/s, KB4 through the "
          f"state's plan "
          f"{single_launches['slam_append']} times, poses bitwise "
          f"equal; poses sha256 {digest}")
    print(f"[4t] dryrun_multichip on one NCCL rank: passed in {dry_s:.1f} s")
    runs = {}
    for shape, parts in (((2, 1), "rst"), ((1, 2), "rs"), ((2, 2), "rt")):
        n = shape[0] * shape[1]
        out = os.path.join(tmp, f"blocks{shape[0]}x{shape[1]}")
        os.makedirs(out)
        t0 = time.perf_counter()
        distributed.launch([sys.executable, os.path.abspath(__file__),
                            "--blocks-rank", out, str(shape[0]),
                            str(shape[1]), map4, map7, str(dev), parts], n,
                           timeout=600)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(n):
            with np.load(os.path.join(out, f"rank{r}.npz")) as z:
                ranks.append({k: z[k] for k in z.files})
        runs[shape] = ranks
        tag = f"({shape[0]}, {shape[1]})"
        a = ranks[0]
        for b in ranks:
            require(not bool(b["jax"]), f"{tag}: a rank imported jax")
            for k in a:
                if k.startswith(("weights", "match", "slam_poses",
                                 "dryrun_")) and not k.endswith(
                                     ("seconds", "_rel")):
                    require(np.array_equal(a[k], b[k]), f"{tag}: {k} "
                            "differs between the ranks")
        msg = [f"launch + {n} ranks {wall:.1f} s"]
        if "r" in parts:
            check_blocks_map(a, f"[4r] {tag}")
            rel = max(float(a["weights_rel"]), float(a["weights7_rel"]))
            msg.append(f"[4r] stripes bitwise the dense rows, measurements "
                       f"within {rel:.2e} of dense K3, "
                       f"{len(a['match_parted'])} of {MAP4_SCANS} winners "
                       f"parted, {float(a['seconds']):.3f} s (matches "
                       f"{float(a['match_seconds']):.3f} s)")
        if "s" in parts:
            require(float(a["slam_ate"]) < float(a["slam_odom_ate"]),
                    f"[4s] {tag}: ATE {float(a['slam_ate'])}")
            dp = float(np.abs(a["slam_poses"] - one["slam_poses"]).max())
            if shape == (2, 1):
                require(dp == 0.0, f"[4s] (2, 1): {dp} m from one rank")
            msg.append(f"[4s] {float(a['slam_steps_per_s']):.1f} steps/s, "
                       f"ATE {float(a['slam_ate']):.4f} m, {dp:.2e} m from "
                       "one rank")
        if "t" in parts:
            msg.append(f"[4t] dryrun_multichip({n}) passed in "
                       f"{float(a['dryrun_seconds']):.1f} s")
        print(f"[4r-t] {n} ranks on cuda:0 over gloo, mesh {tag}, ranks "
              f"bitwise equal: " + "; ".join(msg))
    return launches


def pcg_lattice_times(dev, ident: str) -> dict:
    """``--pcg-lattice-times``: the district's PCG solve on one device
    (walls of three solves, LM iterations, CG steps, RMSE, poses sha256),
    K4's PCG system against its parent's arm (``normal_blocks`` and the
    eager preconditioner) in a CUDA graph and by CUDA events, parent,
    change, change, parent, K11's lattice at the box drive's and config
    2's shapes against the parent form likewise, and the box drive's
    decisions (accepted, ATE, poses sha256), and config 6 forced to PCG
    from perturbed starts (``config6_pcg_spread``).  In an older tree (this
    script copied into it) the arms it lacks are left out and its own
    forms are timed as "tree"."""
    import hashlib

    import numpy as np
    import torch

    from ndt_2d_tpu_torch import convert
    from ndt_2d_tpu_torch.config import SolverConfig
    from ndt_2d_tpu_torch.graph import solver
    from ndt_2d_tpu_torch.kernels import correlative as k11
    from ndt_2d_tpu_torch.kernels import normal_blocks as k4
    from ndt_2d_tpu_torch.matching.matcher import _search_offsets
    out = {"card": ident}
    truth, district = district_graph()
    t = convert.solve_inputs_to_port(dev, **district)
    t.pop("robust_mask")
    cfg = SolverConfig(max_iterations=30, cg_max_iterations=150)
    solver.solve(cfg, **t, use_dense=False)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve(cfg, **t, use_dense=False)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    real, steps = k4.pcg_solve, []

    def counted(*args):
        x, it = real(*args)
        steps.append(it)
        return x, it
    k4.pcg_solve = counted
    try:
        res = solver.solve(cfg, **t, use_dense=False)
    finally:
        k4.pcg_solve = real
    poses = res.poses.cpu().numpy().astype(np.float64)
    out["district"] = dict(
        walls=walls, lm=int(res.iterations),
        cg_steps=[int(i) for i in steps],
        rmse=float(np.sqrt(np.mean(np.sum(
            (poses[:, :2] - truth[:, :2]) ** 2, -1)))),
        sha=hashlib.sha256(res.poses.cpu().numpy().tobytes()).hexdigest()[:16])
    print(f"[6] district PCG solve: walls {[round(w, 4) for w in walls]} s, "
          f"{out['district']['lm']} LM iterations, "
          f"{sum(out['district']['cg_steps'])} CG steps "
          f"{out['district']['cg_steps']}, RMSE {out['district']['rmse']:.4f}"
          f" m, poses sha256 {out['district']['sha']} ({ident})")
    # K4: the system an LM iteration hands pcg_solve, at the district.
    n, C = t["poses"].shape[0], t["begin"].numel()
    robust = torch.zeros(C, dtype=torch.bool, device=dev)
    terms = (t["begin"], t["end"], t["transform"], t["information"],
             t["constraint_mask"], robust, "none", 1.0)
    inc = k4.incidence(t["begin"], t["end"], t["constraint_mask"], n)
    free = t["node_mask"] & (torch.arange(n, device=dev) != 0)
    fm = free.float()
    lam = torch.tensor(1e-3, device=dev)
    eps = torch.tensor(1e-8, device=dev)

    def parent():
        b = k4.normal_blocks(t["poses"], *terms, inc)
        return parent_preconditioner(b[5], b[6], lam, free)

    def parent_graphable():
        b = k4.normal_blocks(t["poses"], *terms, inc)
        return parent_preconditioner(b[5], b[6], lam, free, eps)
    arms = {"parent": (parent, parent_graphable)}
    if hasattr(k4, "PcgPlan"):
        state = k4.lm_state(t["poses"], 1e-3,
                            torch.zeros((), device=dev), C)
        state.lam.copy_(lam)
        plan = k4.PcgPlan(state, *terms, inc, fm)
        arms["change"] = (plan.system, plan.system)
    order = (["parent", "change", "change", "parent"] if "change" in arms
             else ["parent", "parent"])
    k4_rows = []
    for arm in order:
        eager, graphable = arms[arm]
        k4_rows.append(dict(arm=arm, ms=cuda_ms(eager, 50),
                            graph_ms=graph_ms(graphable, 20),
                            host_us=host_us(eager, 30, sync=True)))
        print(f"[6] K4 PCG system (district), {arm}: {k4_rows[-1]['ms']:.4f}"
              f" ms, in a CUDA graph {k4_rows[-1]['graph_ms']:.5f} ms, host "
              f"{k4_rows[-1]['host_us']:.1f} us ({ident})")
    out["k4"] = k4_rows
    # K11's lattice at both shapes.
    bag, cfg2, win, query, _ = inputs(dev)
    D = cfg2.rolling_depth
    box_cfg, _, _, _, bwin, bquery = box_window(D, dev)
    # A tree with the tables form times the parent's entry beside it; an
    # older tree's own lattice is the parent's.
    has_parent = hasattr(k11, "lattice_plan")
    k11_rows = []
    for what, mc, w, q in (("box", box_cfg.local_scan_matcher, bwin, bquery),
                           ("config 2", cfg2.local_scan_matcher, win,
                            query)):
        W, H = mc.grid_cells_x, mc.grid_cells_y
        f, o = k11.build_field(w["poses"], w["points"], w["point_mask"],
                               w["window_mask"], 12.0 if what == "box"
                               else bag.range_max, mc.ndt_resolution, W, H)
        dths, dls = _search_offsets(mc, dev)
        margs = (mc, f, o, q["points"], q["point_mask"], q["num_points"],
                 q["pose"], dths, dls)
        forms = ({"parent": lambda: parent_match(*margs),
                  "change": lambda: k11.match(*margs)} if has_parent
                 else {"tree": lambda: k11.match(*margs)})
        for arm in (["parent", "change", "change", "parent"] if has_parent
                    else ["tree", "tree"]):
            fn = forms[arm]
            row = dict(shape=what, arm=arm, ms=cuda_ms(fn, 50),
                       graph_ms=graph_ms(fn, 50),
                       host_us=host_us(fn, 30, sync=True))
            k11_rows.append(row)
            print(f"[6] K11 lattice ({what}, {dths.numel()}x{dls.numel()}x"
                  f"{dls.numel()}), {arm}: {row['ms']:.4f} ms, in a CUDA "
                  f"graph {row['graph_ms']:.5f} ms, host {row['host_us']:.1f}"
                  f" us ({ident})")
        out[f"k11_{what}_row"] = k11.match(*margs).cpu().numpy().tolist()
    out["k11"] = k11_rows
    acc, nscans, ate, odom, digest = correlative_box(dev)
    out["box"] = dict(accepted=acc, scans=nscans, ate=ate, odom=odom,
                      sha=digest)
    print(f"[6] correlative box drive: {acc}/{nscans} accepted, ATE "
          f"{ate:.4f} m (odometry {odom:.4f}), poses sha256 {digest}")
    out["config6_pcg"] = config6_pcg_spread(dev)
    return out


def digest(*tensors) -> str:
    """The first 16 hex digits of the sha256 of ``tensors``' bytes."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def arm_times(fn, reps: int = 20) -> dict:
    """One call's device time alone (``graph_ms``), its time by CUDA
    events (``cuda_ms``), its host microseconds (the median of calls each
    timed alone) and its device operations (a CUDA graph's nodes)."""
    ops = graph_nodes(fn)
    return dict(graph_ms=graph_ms(fn, reps), cuda_ms=cuda_ms(fn, 50),
                host_us=host_us(fn, 30, sync=True), ops=len(ops),
                op_names=ops)


def descriptor_decisions(cfg, bag, dev) -> dict:
    """A descriptor-mode session's decisions: accepted scans, closures,
    optimizations, final ATE and the sha256 of its last descriptor pass's
    bin tables and descriptors."""
    from ndt_2d_tpu_torch.kernels import descriptors as k10
    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    with DescriptorRecorder() as drec:
        st, _, _, _, _, mp = run_session(cfg, bag, dev,
                                         mapper=Mapper(cfg, device=dev))
    pts, msk, rmax, n_bins = drec.args
    bins = k10.bin_points(pts, msk, rmax, 64, 4, n_bins)
    return dict(accepted=st["scans_accepted"], closures=st["loop_closures"],
                optimizations=st["session"]["optimizations"],
                final_ate=final_ate(mp, st, bag), slots=int(msk.shape[0]),
                scans=int(msk.any(dim=1).sum()), bins_sha=digest(*bins),
                table_sha=digest(drec.table))


def field_bins_times(dev, ident: str, decisions: bool) -> dict:
    """``--field-bins-arm``: in this process's tree, K11's field at the box
    drive's window (160 x 160, 10 scans of 512 points) and config 2's (192
    x 192, 10 x 512), K10's bins over the office table's first 512 slots
    and its 2048 (``arm_times`` each, and the outputs' sha256), the graph
    ms of the next rows of the queue (K10's spectra at both tables, K11's
    point score at both windows, K12's K6 finalize at config 6's 32 coarse
    rows split 2 ways); with ``decisions``, the box drive (accepted, ATE,
    poses sha256), config 6 and the drift recipe (``descriptor_decisions``).
    Calls only public entries, so it runs in an older tree too."""
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_gather as k6
    from ndt_2d_tpu_torch.kernels import correlative as k11
    from ndt_2d_tpu_torch.kernels import descriptors as k10
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.matching import matcher
    from ndt_2d_tpu_torch.parallel import matcher as pmatcher
    out = {"card": ident, "k11": {}, "k10": {}, "next": {}}
    bag, cfg2, win, query, _ = inputs(dev)
    box_cfg, _, _, _, bwin, bquery = box_window(cfg2.rolling_depth, dev)
    for what, mc, w, q, rmax in (
            ("box", box_cfg.local_scan_matcher, bwin, bquery, 12.0),
            ("config 2", cfg2.local_scan_matcher, win, query,
             bag.range_max)):
        fargs = (w["poses"], w["points"], w["point_mask"], w["window_mask"],
                 rmax, mc.ndt_resolution, mc.grid_cells_x, mc.grid_cells_y)
        row = arm_times(lambda: k11.build_field(*fargs))
        f, o = k11.build_field(*fargs)
        row["sha"] = digest(f, o)
        if hasattr(k11, "FieldLauncher"):
            # The cluster sizes and the seven-step form, graph ms.
            W, H, S = mc.grid_cells_x, mc.grid_cells_y, w["points"].shape[0]
            row["sweep"] = {}
            for n in (2, 4, 8, 12, 16, 0):
                plan = (k11.field_stripes(W, H, n, S) if n
                        else seven_steps(W, H))
                row["sweep"][f"n {plan.n}" if plan.cluster
                             else "seven-step"] = graph_ms(
                    field_arm(plan, fargs), 20)
        out["k11"][what] = row
        sargs = (mc, f, o, q["points"], q["point_mask"], q["num_points"],
                 q["pose"][None])
        out["next"][f"K11 score, {what}"] = graph_ms(
            lambda: k11.score_batch(*sargs), 50)
        print(f"[6] K11 field, {what} ({mc.grid_cells_x}x{mc.grid_cells_y}, "
              f"{tuple(w['points'].shape[:2])} points): in a CUDA graph "
              f"{row['graph_ms']:.5f} ms, cuda_ms {row['cuda_ms']:.4f}, host "
              f"{row['host_us']:.1f} us, {row['ops']} device operations "
              f"{row['op_names']}, sha256 {row['sha']} ({ident})")
    cfg6, bag3 = config6(), office_bag()
    pts, msk = office_table(cfg6, bag3, dev)
    for S in (512, TABLE_SCANS):
        p_, m_ = pts[:S].contiguous(), msk[:S].contiguous()
        row = arm_times(lambda: k10.bin_points(p_, m_, 12.0))
        bins = k10.bin_points(p_, m_, 12.0)
        row["sha"] = digest(*bins)
        if hasattr(k10, "bins_plan"):
            # Each block shape, graph ms.
            row["sweep"] = {}
            for threads in k10.BIN_THREADS:
                row["sweep"][f"{threads} threads"] = graph_ms(
                    bins_arm(p_, m_, threads), 20)
        out["k10"][f"{S} slots"] = row
        out["next"][f"K10 spectra, {S} slots"] = graph_ms(
            lambda: k10.spectra(bins, 12.0), 50)
        print(f"[6] K10 bins, {S} slots: in a CUDA graph "
              f"{row['graph_ms']:.5f} ms, cuda_ms {row['cuda_ms']:.4f}, host "
              f"{row['host_us']:.1f} us, {row['ops']} device operations "
              f"{row['op_names']}, sha256 {row['sha']} ({ident})")
    cm = cfg6.coarse_scan_matcher
    rows = coarse_rows(cfg6, bag3, dev)
    gr, tabs = k1.build_windows(*rows[:4], 12.0, cm.ndt_resolution,
                                cm.grid_cells_x, cm.grid_cells_y)
    rows = (gr, tabs, *rows[4:])
    dths, dls = matcher._search_offsets(cm, dev)
    A = dths.shape[0]
    _, n = pmatcher.angle_block(A, 2, 0)
    full = torch.cat([k6.partial_rows(cm, *rows, dths, dls, 0, n),
                      k6.partial_rows(cm, *rows, dths, dls, n, A - n)], 1)
    out["next"]["K12 K6 finalize, 32 coarse rows"] = graph_ms(
        lambda: k6.finalize_rows(cm, full, rows[4], dths, dls), 50)
    for k, v in out["next"].items():
        print(f"[6] {k}: in a CUDA graph {v:.5f} ms ({ident})")
    if decisions:
        acc, nscans, ate, odom, sha = correlative_box(dev)
        out["box"] = dict(accepted=acc, scans=nscans, ate=ate, odom=odom,
                          sha=sha)
        out["config6"] = descriptor_decisions(cfg6, bag3, dev)
        out["drift"] = descriptor_decisions(
            office_config("--recipe", "drift"), drift_bag(), dev)
        print(f"[6] box drive {acc}/{nscans} accepted, ATE {ate:.4f} m, "
              f"poses sha256 {sha}; config 6 {out['config6']}; drift "
              f"{out['drift']}")
    return out


def field_bins_arms(parent: str) -> int:
    """``--field-bins-times PARENT``: this script copied into PARENT (a
    ``git archive`` of an older tree) as smoke_new.py, then
    ``--field-bins-arm`` in four processes: parent (with its decisions),
    change (with its decisions), change, parent.  Each arm's lines are
    printed; then, for each kernel and shape, the arms' graph ms, cuda_ms,
    host us and device operations, and whether the outputs' sha256 and
    the decisions agree across the trees.  Exits 1 where they differ."""
    import shutil
    import subprocess
    script, parent = os.path.abspath(__file__), os.path.abspath(parent)
    shutil.copy(script, os.path.join(parent, "smoke_new.py"))
    trees = {"parent": (parent, os.path.join(parent, "smoke_new.py")),
             "change": (ROOT, script)}
    arms = []
    for i, name in enumerate(("parent", "change", "change", "parent")):
        cwd, path = trees[name]
        cmd = [sys.executable, path, "--field-bins-arm"]
        cmd += ["--decisions"] if i < 2 else []
        run = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
        print(run.stdout[-6000:], end="")
        if run.returncode != 0:
            print(f"FAIL: the {name} arm exited {run.returncode}: "
                  f"{run.stderr[-3000:]}")
            return 1
        arms.append((name, json.loads(run.stdout.strip().splitlines()[-1])[
            "field_bins_times"]))
    ok = True
    for kernel, shapes in (("k11", ("box", "config 2")),
                           ("k10", ("512 slots", f"{TABLE_SCANS} slots"))):
        for shape in shapes:
            rows = [(n, a[kernel][shape]) for n, a in arms]
            same = len({r["sha"] for _, r in rows}) == 1
            ok &= same
            print(f"[6] {kernel.upper()} {shape}: " + "; ".join(
                f"{n} graph {r['graph_ms']:.5f} ms, cuda_ms "
                f"{r['cuda_ms']:.4f}, host {r['host_us']:.1f} us, "
                f"{r['ops']} ops" for n, r in rows)
                + f"; outputs bitwise equal across the trees: {same}")
            for n, r in rows:
                if "sweep" in r:
                    print(f"[6] {kernel.upper()} {shape}, {n}, graph ms by "
                          "form: " + ", ".join(
                              f"{k} {v:.5f}" for k, v in r["sweep"].items()))
    for key in arms[0][1]["next"]:
        print(f"[6] {key}: graph ms " + ", ".join(
            f"{n} {a['next'][key]:.5f}" for n, a in arms))
    p, c = arms[0][1], arms[1][1]
    for key in ("box", "config6", "drift"):
        same = p[key] == c[key]
        ok &= same
        print(f"[6] decisions, {key}: parent {p[key]}, change {c[key]}; "
              f"equal: {same}")
    print(json.dumps({"field_bins_times": dict(arms=arms, equal=ok)}))
    return 0 if ok else 1


def merge_decisions(dev) -> dict:
    """The merge of ``merge_sessions``' two sessions: pairs checked and
    accepted, the transform's errors and the merged ATE."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.core import pose as pose_ops
    from ndt_2d_tpu_torch.mapping import merge
    from ndt_2d_tpu_torch.utils import metrics
    truth_a, truth_b, ga, gb = merge_sessions(dev)
    res = merge.merge_maps(ga, gb, range_max=14.0, score_threshold=-0.25,
                           device=dev)

    def f32(p):
        return torch.tensor(np.asarray(p), dtype=torch.float32)
    t_true = pose_ops.compose(pose_ops.inverse(f32(truth_a[0])),
                              f32(truth_b[0])).numpy()
    rel_b = metrics.relative_to_first(truth_b)
    truth_b_in_a = pose_ops.compose(f32(t_true), f32(rel_b)).numpy()
    return dict(
        checked=int(res.pairs_checked), accepted=int(res.pairs_accepted),
        err_xy=float(np.hypot(*(res.transform[:2] - t_true[:2]))),
        err_th=abs(float(pose_ops.normalize_angle(
            f32(res.transform[2] - t_true[2])))),
        ate=float(metrics.ate_rmse(res.graph.poses[ga.num_scans:],
                                   truth_b_in_a)),
        transform_sha=digest(torch.tensor(np.asarray(res.transform))))


def kb3_form(mc, fields, num_points: int, dths, dls):
    """This tree's KB3 match of the stripes' ``fields`` ([A, L, L] each,
    rank order) as a function of no arguments returning the [13] row: one
    launch reading a ``FieldPlan``'s stack, filled here as the gather
    fills it, where the tree has ``field_match``; else the parent chain
    (K12's ``rank_sum`` of the stacked fields, ``field_partials``, K2's
    fold)."""
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_gather as k6
    from ndt_2d_tpu_torch.kernels import shard_combine
    S, A, L = len(fields), dths.numel(), dls.numel()
    if hasattr(k6, "field_match"):
        plan = k6.field_plan(fields[0].device, S, A, L)
        for s, f in enumerate(fields):
            plan.stack[s].copy_(f.reshape(-1))
        return lambda: k6.field_match(mc, plan, plan.stack, num_points,
                                      dths, dls)
    stack = torch.stack(fields)
    return lambda: k6.finalize_rows(mc, k6.field_partials(
        shard_combine.rank_sum(stack), dths, dls)[None], num_points, dths,
        dls)[0]


# Variants of KB3's match (``csrc/candidate_gather.cu::field_match``) that
# ``--kb3-breakdown`` times beside the shipped launch: which part of its
# time is the loads, the ticket and the fold.  kMode 0: the match as
# shipped (one float a load); 1: the partials only; 2: the partials, the
# fence and the ticket, no fold; 3: the match with each stripe's tile
# loaded as float4s staged through shared memory where aligned (the form
# before one load path).  fold_only: the last block's fold alone.
KB3_VARIANTS_CU = r"""
#include "lattice.cuh"

namespace {
using lattice::kTile;

struct FieldMatch {
  const float* stack;
  const float* dths;
  const float* dls;
  float* partial;
  unsigned* ticket;
  int S, A, L, max_beams;
};
constexpr int kGroup = (lattice::kStage + 1) * lattice::kPartial / kTile;

template <int kMode>
__global__ void __launch_bounds__(kTile) match(const FieldMatch m,
                                               int num_points, float* out) {
  __shared__ __align__(16) float sp[(lattice::kStage + 1) *
                                    lattice::kPartial];
  __shared__ bool last;
  const int tile = blockIdx.x, tiles = gridDim.x, a = blockIdx.y;
  const int L = m.L, LL = L * L, t = threadIdx.x;
  const int f = tile * kTile + t;
  const bool live = f < LL;
  const int n = min(kTile, LL - tile * kTile);
  const size_t stride = (size_t)m.A * LL;
  const float* first = m.stack + (size_t)a * LL + (size_t)tile * kTile;
  const bool vec = kMode == 3 &&
                   reinterpret_cast<uintptr_t>(m.stack) % 16 == 0 &&
                   stride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(first) % 16 == 0;
  float cand = 0.f;
  if (vec) {
    for (int s0 = 0; s0 < m.S; s0 += kGroup) {
      const int g = min(kGroup, m.S - s0);
      constexpr int kVecs = kTile / 4;
      for (int q = t; q < g * kVecs; q += kTile) {
        const int s = q / kVecs, v = q - s * kVecs;
        if (4 * v + 4 <= n)
          reinterpret_cast<float4*>(sp + s * kTile)[v] =
              reinterpret_cast<const float4*>(first + (s0 + s) * stride)[v];
      }
      if (live && t >= (n & ~3))
        for (int s = 0; s < g; ++s)
          sp[s * kTile + t] = first[(s0 + s) * stride + t];
      __syncthreads();
      if (live)
        for (int s = 0; s < g; ++s)
          cand = s0 + s == 0 ? sp[t] : cand + sp[s * kTile + t];
      __syncthreads();
    }
  } else if (live) {
    cand = first[t];
    for (int s = 1; s < m.S; ++s) cand += first[s * stride + t];
  }
  const int lx = live ? f / L : 0, ly = live ? f % L : 0;
  lattice::reduce_tile(cand, live, a * LL + f, m.dls[lx], m.dls[ly],
                       m.dths[a],
                       m.partial + ((size_t)a * tiles + tile) *
                                       lattice::kPartial);
  if (kMode == 1) return;
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(m.ticket, 1u) == (unsigned)(m.A * tiles - 1);
  __syncthreads();
  if (!last) return;
  if (kMode != 2) {
    __threadfence();
    lattice::finalize_row<true, true>(m.partial, m.A * tiles, L, num_points,
                                      m.max_beams, m.dths, m.dls, out, sp);
  }
  if (t == 0) *m.ticket = 0u;
}

__global__ void __launch_bounds__(kTile) fold_only(const FieldMatch m,
                                                   int num_points,
                                                   float* out) {
  __shared__ __align__(16) float sp[(lattice::kStage + 1) *
                                    lattice::kPartial];
  const int tiles = (m.L * m.L + kTile - 1) / kTile;
  lattice::finalize_row<true, true>(m.partial, m.A * tiles, m.L, num_points,
                                    m.max_beams, m.dths, m.dls, out, sp);
}

__global__ void empty_kernel() {}
}  // namespace

NDT2D_API int kb3_variant(int mode, const void* plan, int num, void* out,
                          void* stream) {
  const FieldMatch& m = *static_cast<const FieldMatch*>(plan);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const dim3 grid((m.L * m.L + kTile - 1) / kTile, m.A);
  switch (mode) {
    case 0: match<0><<<grid, kTile, 0, st>>>(m, num, o); break;
    case 1: match<1><<<grid, kTile, 0, st>>>(m, num, o); break;
    case 2: match<2><<<grid, kTile, 0, st>>>(m, num, o); break;
    case 3: match<3><<<grid, kTile, 0, st>>>(m, num, o); break;
    case 4: fold_only<<<1, kTile, 0, st>>>(m, num, o); break;
    case 5: empty_kernel<<<1, 32, 0, st>>>(); break;
    default: return 1;
  }
  return (int)cudaGetLastError();
}
"""

KB3_VARIANTS = {0: "variant: the match as shipped", 1: "variant: partials "
                "only", 2: "variant: partials + ticket", 3: "variant: the "
                "match, float4 loads staged where aligned", 4: "variant: the "
                "fold alone (one block)", 5: "an empty launch"}


def kb3_breakdown() -> int:
    """``--kb3-breakdown``: KB3's match at 80x21x21 (config 4's lattice)
    over a random stack of S = 2 and 1 stripes, in one process: the
    package's ``field_match``, the variants of ``KB3_VARIANTS_CU`` (built
    here with nvcc beside the package's library; the full variants checked
    bitwise against ``field_match``), ``rank_sum`` alone, K2's finalize
    launch of the same partials (``k6.finalize_rows``) and
    ``torch.sum(stack, 0)``; graph ms and host us (synchronized a call)
    of each, the rows in turn, twice.  Prints one line a row and rep, then
    the medians."""
    import statistics

    import torch

    from ndt_2d_tpu_torch.config import ScanMatcherConfig
    from ndt_2d_tpu_torch.kernels import _build
    from ndt_2d_tpu_torch.kernels import candidate_gather as k6
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import shard_combine
    ident = phase_card()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        src, so = os.path.join(tmp, "kb3.cu"), os.path.join(tmp, "kb3.so")
        with open(src, "w") as f:
            f.write(KB3_VARIANTS_CU)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                        "-I", _build.CSRC, src, "-o", so], check=True,
                       capture_output=True)
        variant = ctypes.CDLL(so).kb3_variant
    variant.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    mc = ScanMatcherConfig(grid_cells_x=192, grid_cells_y=192)
    dths, dls = k2.search_offsets(mc, dev)
    A, L = dths.numel(), dls.numel()
    gen = torch.Generator(device=dev).manual_seed(3)
    medians = {}
    for S in (2, 1):
        plan = k6.FieldPlan(dev, S, A, L)
        plan.stack.copy_(-torch.rand(S, A * L * L, generator=gen,
                                     device=dev) * 40)
        want = k6.field_match(mc, plan, plan.stack, 300, dths, dls)
        stack = plan.stack.view(S, A, L, L)
        parts = k2.block_partials(shard_combine.rank_sum(stack), dths, dls,
                                  0, k6.TILE)

        def run(mode, plan=plan):
            out = torch.empty(13, device=dev)
            _build.check(variant(mode, plan.address, 300, out.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream),
                         f"KB3 variant {mode}")
            return out
        for mode in (0, 3):
            require(torch.equal(run(mode), want),
                    f"KB3 {KB3_VARIANTS[mode]} differs from field_match")
        rows = {"field_match (package)": lambda plan=plan: k6.field_match(
            mc, plan, plan.stack, 300, dths, dls)}
        for mode, name in KB3_VARIANTS.items():
            rows[name] = lambda mode=mode: run(mode)
        rows["rank_sum alone"] = lambda stack=stack: shard_combine.rank_sum(
            stack)
        rows["K2's finalize launch of the partials"] = (
            lambda parts=parts: k6.finalize_rows(mc, parts[None], 300, dths,
                                                 dls))
        rows["torch.sum(stack, 0)"] = lambda stack=stack: torch.sum(stack, 0)
        times = {name: [] for name in rows}
        for rep in range(2):
            for name, fn in rows.items():
                g, h = graph_ms(fn, 20), host_us(fn, 30, sync=True)
                times[name].append((g, h))
                print(f"[6] KB3 breakdown, S = {S}, rep {rep}, {name}: "
                      f"graph {g:.5f} ms, host {h:.1f} us ({ident})",
                      flush=True)
        for name, got in times.items():
            medians[f"S = {S}, {name}"] = (
                statistics.median(g for g, _ in got),
                statistics.median(h for _, h in got))
    for key, (g, h) in medians.items():
        print(f"[6] KB3 breakdown, {key}: graph {g:.5f} ms, host {h:.1f} us "
              f"(medians of 2; {ident})")
    print(json.dumps({"kb3_breakdown": {k: list(v) for k, v in
                                        medians.items()}, "card": ident}))
    return 0


def kb3_winners(dev) -> dict:
    """``[4r]``'s matches on one card: config 4's saved map in two stripes
    (KB1), each of the 150 localization scans matched against both
    stripes (KB3: the fields, then this tree's match of them,
    ``kb3_form``) from the dense K6 chain's start poses; the sha256 of the
    150 winner rows and of the dense ones, and the seconds of the 150
    matches of the stripes' fields (``match_s``, the device synchronized
    around each)."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.core import pose as pose_ops
    from ndt_2d_tpu_torch.io.bag import record_synthetic
    from ndt_2d_tpu_torch.kernels import candidate_gather as k6
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.mapping import laser
    from ndt_2d_tpu_torch.utils import metrics
    bag4 = record_synthetic("box", 150, n_beams=360, seed=2)
    with tempfile.TemporaryDirectory() as tmp:
        map4 = os.path.join(tmp, "box_map.npz")
        map_and_save(config4_configs()[0], bag4, map4, dev)
        _, cfg = config4_configs()
        m, kf = blocks_map(map4, cfg, bag4.range_max, dev)
    mc = m.config
    stripes = [stripe_of(m, kf, 2, s) for s in range(2)]
    loc_bag = record_synthetic("box", MAP4_SCANS, n_beams=360, seed=7,
                               odom_trans_noise=0.01)
    dths, dls = k2.search_offsets(mc, dev)
    start = np.asarray(metrics.relative_to_first(loc_bag.truth)[0],
                       np.float64)
    dense_rows, rows, match_s = [], [], 0.0
    for t in range(MAP4_SCANS):
        pts, msk = laser.project_scan(loc_bag[t][0], loc_bag.range_max,
                                      np.zeros(3), False, None,
                                      cfg.max_points_per_scan)
        q, qm = torch.tensor(pts, device=dev), torch.tensor(msk, device=dev)
        nt = int(msk.sum())
        pose = torch.tensor(start, dtype=torch.float32, device=dev)
        dense = k6.match(mc, m.grid, m.packed_table, q, qm, nt, pose, dths,
                         dls)[0]
        fields = [k6.stripe_field(mc, g, tab, s * h, h, q, qm, nt, pose,
                                  dths, dls)
                  for s, ((g, tab), h) in enumerate(stripes)]
        match = kb3_form(mc, fields, nt, dths, dls)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows.append(match())
        torch.cuda.synchronize()
        match_s += time.perf_counter() - t0
        dense_rows.append(dense)
        corrected = torch.tensor(start + dense.cpu().numpy()[1:4])
        if t + 1 < MAP4_SCANS:
            start = pose_ops.compose(corrected, pose_ops.relative(
                *torch.tensor(loc_bag.odom[t:t + 2]))).numpy()
    rows, dense_rows = torch.stack(rows), torch.stack(dense_rows)
    return dict(winners_sha=digest(rows), dense_sha=digest(dense_rows),
                corrections_equal=bool(torch.equal(rows[:, 1:4],
                                                   dense_rows[:, 1:4])),
                match_s=match_s)


def glue_search(kern, mc, rows, dths, dls, dev):
    """Rank 1 of a 2-rank ``space`` line's split search of ``rows`` by
    ``parallel/matcher.py::search_rows`` on one card, the line's gather
    stubbed by a stack filled beforehand (no device operation): a tree's
    plan (the stack it gathers into) or, in a tree without K6's plan, the
    padded blocks its reordering path gathers.  Returns (the search as a
    callable, a function undoing the stubs)."""
    import inspect

    import torch

    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.parallel import matcher as pmatcher
    A, R = dths.shape[0], rows[2].shape[0]
    per = kern.blocks_per_angle(dls)
    planned = (kern is k2
               or "per" in inspect.signature(k2.split_plan).parameters)
    if planned:
        stack = split_stack(mc, rows, dths, dls, 2, dev, kern).stack
    else:
        blk = -(-A // 2)
        parts = []
        for s in range(2):
            a0, n = pmatcher.angle_block(A, 2, s)
            mine = kern.partial_rows(mc, *rows, dths, dls, a0, n)
            pad = torch.zeros(R, (blk - n) * per, 12, device=dev)
            pad[..., 0].fill_(math.inf)
            parts.append(torch.cat([mine, pad], 1))
        stack = torch.stack(parts)
    saved = {k: getattr(pmatcher, k) for k in ("axis_size", "axis_rank",
                                               "axis_group")}
    saved_gather = pmatcher.distributed.gather
    pmatcher.axis_size = lambda mesh, axis: 2
    pmatcher.axis_rank = lambda mesh, axis: 1
    pmatcher.axis_group = lambda mesh, axis: "line"
    pmatcher.distributed.gather = (
        lambda t, group, out=None: stack if out is None else out)

    def undo():
        for k, v in saved.items():
            setattr(pmatcher, k, v)
        pmatcher.distributed.gather = saved_gather
    return (lambda: pmatcher.search_rows(kern, mc, "line", *rows, dths,
                                         dls)), undo


def spectra_finalize_times(dev, ident: str, decisions: bool) -> dict:
    """``--spectra-finalize-arm``: in this process's tree, K10's spectra
    over the office table's first 512 slots and its 2048; K6's one-device
    search at config 6's 32 coarse rows and at the merge's shape; K12's
    K6 finalize of those rows split 2 ways (the tree's split finalize:
    planned, or ``finalize_rows`` on the reordered copy) and K6's fold of
    one [R, A * tiles, 12] buffer there and at the merge's shape (R = 1,
    126 x 7 partials); KB3's reduction of an 80 x 21 x 21 field (its
    partials and the fold); K2's planned finalize at config 2 and over 64
    config-3 rows (S = 2); the split K6 search's glue on rank 1 of 2
    (``glue_search``: its device operations, host us); K11's lattice at
    the box drive's and config 2's shapes (``arm_times`` each, and the
    outputs' sha256).  With ``decisions``: config 6 and drift
    (``descriptor_decisions``), the merge (``merge_decisions``) and [4r]'s
    winners (``kb3_winners``).  Calls only public entries, so it runs in
    an older tree too."""
    import inspect

    import numpy as np
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_gather as k6
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    from ndt_2d_tpu_torch.kernels import correlative as k11
    from ndt_2d_tpu_torch.kernels import descriptors as k10
    from ndt_2d_tpu_torch.kernels import ndt_build as k1
    from ndt_2d_tpu_torch.mapping import merge
    from ndt_2d_tpu_torch.matching import matcher
    out = {"card": ident, "rows": {}, "sweep": {}}

    def arm(name, fn, *keep):
        row = arm_times(fn)
        row["sha"] = digest(*(keep or (fn(),)))
        out["rows"][name] = row
        print(f"[6] {name}: in a CUDA graph {row['graph_ms']:.5f} ms, "
              f"cuda_ms {row['cuda_ms']:.4f}, host {row['host_us']:.1f} us, "
              f"{row['ops']} device operations {row['op_names']}, sha256 "
              f"{row['sha']} ({ident})")
    cfg6, bag3 = config6(), office_bag()
    pts, msk = office_table(cfg6, bag3, dev)
    for S in (512, TABLE_SCANS):
        bins = k10.bin_points(pts[:S].contiguous(), msk[:S].contiguous(),
                              12.0)
        arm(f"K10 spectra, {S} slots", lambda: k10.spectra(bins, 12.0))
        if hasattr(k10, "spectra_plan"):
            out["sweep"][f"K10 spectra, {S} slots"] = {
                f"{w} warps, staged {st}": graph_ms(spectra_arm(bins, w, st),
                                                    20)
                for w, st in SPECTRA_FORMS}
    cm = cfg6.coarse_scan_matcher
    rows = coarse_rows(cfg6, bag3, dev)
    gr, tabs = k1.build_windows(*rows[:4], 12.0, cm.ndt_resolution,
                                cm.grid_cells_x, cm.grid_cells_y)
    rows6 = (gr, tabs, *rows[4:])
    dths, dls = matcher._search_offsets(cm, dev)
    A, nums = dths.shape[0], rows6[4]
    arm(f"K6 search, {COARSE_ROWS} coarse rows",
        lambda: k6.match_rows(cm, *rows6, dths, dls))
    mrows = office_rows(cfg6, bag3, dev, 1, region=tuple(range(7)),
                        shift=(0.4, -0.3, 2.5))
    span = float(np.ptp(mrows[0][0, :, :2].cpu().numpy(), axis=0).max())
    mm = merge._coarse_config(12.0, span)
    md, ml = matcher._search_offsets(mm, dev)
    mg, mtab = k1.build_windows(*mrows[:4], 12.0, mm.ndt_resolution,
                                mm.grid_cells_x, mm.grid_cells_y)
    mrows = (mg, mtab, *mrows[4:])
    arm(f"K6 search, merge shape ({md.numel()}x{ml.numel()}x{ml.numel()})",
        lambda: k6.match_rows(mm, *mrows, md, ml))
    full = k6.partial_rows(cm, *rows6, dths, dls, 0, A)
    mfull = k6.partial_rows(mm, *mrows, md, ml, 0, md.numel())
    search, undo = glue_search(k6, cm, rows6, dths, dls, dev)
    try:
        split = search()
        arm(f"K12 K6 split search, rank 1 of 2, {COARSE_ROWS} coarse rows",
            search, split)
    finally:
        undo()
    planned = "per" in inspect.signature(k2.split_plan).parameters
    if planned:
        plan = split_stack(cm, rows6, dths, dls, 2, dev, k6)
        arm(f"K12 K6 finalize, {COARSE_ROWS} coarse rows split 2",
            lambda: plan.finalize(cm, plan.stack, nums, dths, dls))
    else:
        arm(f"K12 K6 finalize, {COARSE_ROWS} coarse rows split 2",
            lambda: k6.finalize_rows(cm, full, nums, dths, dls))
    arm(f"K6 fold of one buffer, {COARSE_ROWS} coarse rows",
        lambda: k6.finalize_rows(cm, full, nums, dths, dls))
    arm(f"K6 fold of one buffer, merge shape ({mfull.shape[1]} partials)",
        lambda: k6.finalize_rows(mm, mfull, mrows[4], md, ml))
    _, cfg4 = config4_configs()
    mc4 = cfg4.global_scan_matcher
    d4, l4 = k2.search_offsets(mc4, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    field = -torch.rand(d4.numel(), l4.numel(), l4.numel(), generator=gen,
                        device=dev).mul_(40.0).floor_()

    arm(f"KB3 reduction ({d4.numel()}x{l4.numel()}x{l4.numel()} field)",
        kb3_form(mc4, [field], 300, d4, l4))
    bag, cfg2, win, query, _ = inputs(dev)
    mc2 = cfg2.local_scan_matcher
    g, tab = k1.build_window(**win, range_max=15.0,
                             cell_size=mc2.ndt_resolution,
                             width=mc2.grid_cells_x,
                             height=mc2.grid_cells_y)
    from ndt_2d_tpu_torch.ndt import grid as ndt_grid
    row = ndt_grid.NDTGrid(origin=g.origin[None], cell_size=g.cell_size,
                           mean=None, information=None, count=None,
                           covariance=None)
    rows2 = (row, tab[None], query["points"][None],
             query["point_mask"][None],
             torch.tensor([query["num_points"]], dtype=torch.int32,
                          device=dev), query["pose"][None])
    cfg3 = office_config()
    gm = cfg3.global_scan_matcher
    r3 = office_rows(cfg3, bag3, dev)
    gr3, tabs3 = k1.build_windows(*r3[:4], 12.0, gm.ndt_resolution,
                                  gm.grid_cells_x, gm.grid_cells_y)
    rows3 = (gr3, tabs3, *r3[4:])
    for what, mc, rr in (("config 2", mc2, rows2),
                         (f"{ROWS} config-3 rows", gm, rows3)):
        d_, l_ = matcher._search_offsets(mc, dev)
        kplan = split_stack(mc, rr, d_, l_, 2, dev)
        arm(f"K12 K2 planned finalize, {what} split 2",
            lambda kplan=kplan, mc=mc, rr=rr, d_=d_, l_=l_: kplan.finalize(
                mc, kplan.stack, rr[4], d_, l_))
    box_cfg, _, _, _, bwin, bquery = box_window(cfg2.rolling_depth, dev)
    for what, mc, w, q, rmax in (
            ("box", box_cfg.local_scan_matcher, bwin, bquery, 12.0),
            ("config 2", mc2, win, query, bag.range_max)):
        f, o = k11.build_field(w["poses"], w["points"], w["point_mask"],
                               w["window_mask"], rmax, mc.ndt_resolution,
                               mc.grid_cells_x, mc.grid_cells_y)
        d_, l_ = matcher._search_offsets(mc, dev)
        margs = (mc, f, o, q["points"], q["point_mask"], q["num_points"],
                 q["pose"], d_, l_)
        arm(f"K11 lattice, {what}", lambda margs=margs: k11.match(*margs))
    for key, sweep in out["sweep"].items():
        print(f"[6] {key}, graph ms by block shape: " + ", ".join(
            f"{k} {v:.5f}" for k, v in sweep.items()) + f" ({ident})")
    if decisions:
        out["config6"] = descriptor_decisions(cfg6, bag3, dev)
        out["drift"] = descriptor_decisions(
            office_config("--recipe", "drift"), drift_bag(), dev)
        out["merge"] = merge_decisions(dev)
        out["kb3"] = kb3_winners(dev)
        out["kb3_match_s"] = out["kb3"].pop("match_s")
        print(f"[6] decisions: config 6 {out['config6']}; drift "
              f"{out['drift']}; merge {out['merge']}; [4r]'s winners "
              f"{out['kb3']}")
    return out


def spectra_finalize_arms(parent: str) -> int:
    """``--spectra-finalize-times PARENT``: this script copied into PARENT
    (a ``git archive`` of an older tree) as smoke_new.py, then
    ``--spectra-finalize-arm`` in four processes: parent (with its
    decisions), change (with its decisions), change, parent.  Each arm's
    lines are printed; then, for each row, the arms' graph ms, cuda_ms,
    host us and device operations, and whether the outputs' sha256 and the
    decisions agree across the trees.  Exits 1 where they differ."""
    import shutil
    import subprocess
    script, parent = os.path.abspath(__file__), os.path.abspath(parent)
    shutil.copy(script, os.path.join(parent, "smoke_new.py"))
    trees = {"parent": (parent, os.path.join(parent, "smoke_new.py")),
             "change": (ROOT, script)}
    arms = []
    for i, name in enumerate(("parent", "change", "change", "parent")):
        cwd, path = trees[name]
        cmd = [sys.executable, path, "--spectra-finalize-arm"]
        cmd += ["--decisions"] if i < 2 else []
        run = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
        print(run.stdout[-8000:], end="")
        if run.returncode != 0:
            print(f"FAIL: the {name} arm exited {run.returncode}: "
                  f"{run.stderr[-3000:]}")
            return 1
        arms.append((name, json.loads(run.stdout.strip().splitlines()[-1])[
            "spectra_finalize_times"]))
    ok = True
    for key in arms[0][1]["rows"]:
        rows = [(n, a["rows"][key]) for n, a in arms]
        same = len({r["sha"] for _, r in rows}) == 1
        ok &= same
        print(f"[6] {key}: " + "; ".join(
            f"{n} graph {r['graph_ms']:.5f} ms, cuda_ms {r['cuda_ms']:.4f}, "
            f"host {r['host_us']:.1f} us, {r['ops']} ops" for n, r in rows)
            + f"; outputs bitwise equal across the trees: {same}")
    p, c = arms[0][1], arms[1][1]
    for key in ("config6", "drift", "merge", "kb3"):
        same = p[key] == c[key]
        ok &= same
        print(f"[6] decisions, {key}: parent {p[key]}, change {c[key]}; "
              f"equal: {same}")
    print(json.dumps({"spectra_finalize_times": dict(arms=arms, equal=ok)}))
    return 0 if ok else 1


def score_fold_times(dev, ident: str, decisions: bool) -> dict:
    """``--score-fold-arm``: in this process's tree, K11's lattice alone
    and with the point score (the tree's form: one launch with
    ``with_unc``, or the lattice then ``score_batch``) at the box drive's
    and config 2's shapes; a matched correlative scan through the matcher
    (the field, then the score and the match: the tree's fused call, or
    ``score_points`` then ``match_scan``) and its score and match alone,
    beside ``match_scan`` alone; KB2's stripe scores over 5000 and 20,000
    particles on stripe 0 of 2 of config 4's map and over the scan's world
    points; KB3's match (``kb3_form``: the tree's one launch, or the
    parent's rank sum, reduction and fold) of a localization scan's two
    stripe fields and of the whole map's one (``arm_times`` each, and the
    outputs' sha256).  With ``decisions``: the correlative box drive
    (accepts, ATE, poses' and scores' sha256, K11's launches), the
    config-2 corridor with the correlative matcher (ms/scan, not gated)
    and [4r]'s winners (``kb3_winners``, with the seconds of its 150
    matches).  Calls only public entries, so it runs in an older tree
    too."""
    import dataclasses
    import inspect

    import numpy as np

    from ndt_2d_tpu_torch.core import pose as pose_ops
    from ndt_2d_tpu_torch.io.bag import record_synthetic
    from ndt_2d_tpu_torch.kernels import correlative as k11
    from ndt_2d_tpu_torch.kernels import score_points as k3
    from ndt_2d_tpu_torch.matching import correlative
    from ndt_2d_tpu_torch.matching import matcher
    import torch

    from ndt_2d_tpu_torch.kernels import candidate_gather as k6
    from ndt_2d_tpu_torch.kernels import candidate_scores as k2
    fused = "with_unc" in inspect.signature(k11.match).parameters
    records = "table" in inspect.signature(k3.stripe_poses).parameters
    out = {"card": ident, "fused": fused, "records": records,
           "kb3_one_launch": hasattr(k6, "field_match"), "rows": {}}

    def arm(name, fn, *keep):
        row = arm_times(fn)
        row["sha"] = digest(*(keep or fn()))
        out["rows"][name] = row
        print(f"[6] {name}: in a CUDA graph {row['graph_ms']:.5f} ms, "
              f"cuda_ms {row['cuda_ms']:.4f}, host {row['host_us']:.1f} us, "
              f"{row['ops']} device operations {row['op_names']}, sha256 "
              f"{row['sha']} ({ident})")
    bag, cfg2, win, query, _ = inputs(dev)
    box_cfg, _, _, _, bwin, bquery = box_window(cfg2.rolling_depth, dev)
    for what, mc, w, q, rmax in (
            ("box", box_cfg.local_scan_matcher, bwin, bquery, 12.0),
            ("config 2", cfg2.local_scan_matcher, win, query,
             bag.range_max)):
        f, o = k11.build_field(w["poses"], w["points"], w["point_mask"],
                               w["window_mask"], rmax, mc.ndt_resolution,
                               mc.grid_cells_x, mc.grid_cells_y)
        d_, l_ = matcher._search_offsets(mc, dev)
        margs = (mc, f, o, q["points"], q["point_mask"], q["num_points"],
                 q["pose"], d_, l_)
        sargs = margs[:6] + (q["pose"][None],)

        def both(margs=margs, sargs=sargs):
            if fused:
                return k11.match(*margs, with_unc=True)
            return k11.match(*margs), k11.score_batch(*sargs)
        arm(f"K11 lattice alone, {what}",
            lambda margs=margs: (k11.match(*margs),))
        arm(f"K11 lattice + point score, {what}", both)
        m = correlative.CorrelativeScanMatcher(mc, rmax, device=dev)
        wargs = (w["poses"], w["points"], w["point_mask"], w["window_mask"])
        qargs = (q["points"], q["point_mask"], q["num_points"], q["pose"])

        def score_match(m=m, qargs=qargs):
            if fused:
                unc, res = m.match_scan_with_score(*qargs)
            else:
                unc = m.score_points(*qargs)
                res = m.match_scan(*qargs)
            return (unc.reshape(1), res.score.reshape(1), res.correction,
                    res.covariance.reshape(9))

        def scan(m=m, wargs=wargs, score_match=score_match):
            m.add_scans(*wargs)
            return score_match()
        arm(f"a matched correlative scan (field, score, match), {what}",
            scan)
        arm(f"matcher score and match, {what}", score_match)
        arm(f"matcher match_scan alone, {what}",
            lambda m=m, qargs=qargs: (m.match_scan(*qargs).score.reshape(1),))

    # KB2 on stripe 0 of 2 of config 4's map.
    bag4 = record_synthetic("box", 150, n_beams=360, seed=2)
    _, cfg4 = config4_configs()
    with tempfile.TemporaryDirectory() as tmp:
        map4 = os.path.join(tmp, "box_map.npz")
        map_and_save(config4_configs()[0], bag4, map4, dev)
        m4, kf = blocks_map(map4, cfg4, bag4.range_max, dev)
    mc4 = m4.config
    (g, tab), h = stripe_of(m4, kf, 2, 0)
    W, B = mc4.grid_cells_x, mc4.laser_max_beams
    q4, qm4, n4, center = map4_scan(bag4, 40, cfg4, dev)
    lead = (g, tab) if records else (g,)
    for M in (PARTICLES, GLOBAL_PARTICLES):
        ps = particle_poses(center, M, dev)
        arm(f"KB2 stripe scores, {M} particles, stripe 0 of 2",
            lambda ps=ps: (k3.stripe_poses(*lead, W, 0, h, B, q4, qm4, n4,
                                           ps),))
    world = pose_ops.transform_points(center, q4).contiguous()
    arm("KB2 stripe scores, the scan's world points, stripe 0 of 2",
        lambda: (k3.stripe_points(*lead, W, 0, h, world, qm4),))
    # KB3's match of a localization scan's stripe fields (config 4's map,
    # 80x21x21 x 100 beams), in this tree's form (``kb3_form``): two
    # stripes' fields, and one stripe's (the whole map: [4r]'s one rank).
    loc_bag = record_synthetic("box", MAP4_SCANS, n_beams=360, seed=7,
                               odom_trans_noise=0.01)
    lq, lqm, ln, lc = map4_scan(loc_bag, 20, cfg4, dev)
    start = lc + torch.tensor([0.02, -0.01, 0.01], device=dev)
    d4, l4 = k2.search_offsets(mc4, dev)
    (g1, tab1), _ = stripe_of(m4, kf, 2, 1)
    two = [k6.stripe_field(mc4, sg, st, s * h, h, lq, lqm, ln, start, d4,
                           l4)
           for s, (sg, st) in enumerate(((g, tab), (g1, tab1)))]
    whole = [k6.stripe_field(mc4, m4.grid, m4.packed_table, 0,
                             mc4.grid_cells_y, lq, lqm, ln, start, d4, l4)]
    kb3_shape = f"{d4.numel()}x{l4.numel()}x{l4.numel()}"
    for S, fields in ((2, two), (1, whole)):
        match = kb3_form(mc4, fields, ln, d4, l4)
        arm(f"KB3 match of {S} stripes' fields ({kb3_shape})",
            lambda match=match: (match(),))
    if decisions:
        reset_counts()
        acc, n, ate, odom, psha, ssha = correlative_box(dev, scores=True)
        launches = read_counts()
        out["box"] = dict(accepted=acc, scans=n, ate=ate, odom=odom,
                          poses_sha=psha, scores_sha=ssha,
                          launches={k: launches[k] for k in (
                              "correlative_field", "correlative_match",
                              "correlative_score")})
        local = dataclasses.replace(cfg2.local_scan_matcher,
                                    search_linear_size=0.15,
                                    search_linear_resolution=0.0075)
        ccfg = dataclasses.replace(cfg2, scan_matcher_type="correlative",
                                   local_scan_matcher=local)
        stats, _, dt, _, _, _ = run_session(ccfg, bag, dev)
        out["corridor_ms"] = float(np.median(dt[4:]) * 1e3)
        out["corridor"] = dict(accepted=stats["scans_accepted"],
                               ate=stats["ate_rmse_m"])
        out["kb3"] = kb3_winners(dev)
        out["kb3_match_s"] = out["kb3"].pop("match_s")
        print(f"[6] decisions: correlative box {out['box']}; config-2 "
              f"corridor, correlative (not gated) {out['corridor_ms']:.3f} "
              f"ms/scan median, {out['corridor']}; [4r]'s winners "
              f"{out['kb3']} ({ident})")
    return out


def score_fold_arms(parent: str) -> int:
    """``--score-fold-times PARENT``: this script copied into PARENT (a
    ``git archive`` of an older tree) as smoke_new.py, then
    ``--score-fold-arm`` in four processes: parent (with its decisions),
    change (with its decisions), change, parent.  Each arm's lines are
    printed; then, for each row, the arms' graph ms, cuda_ms, host us and
    device operations and whether the outputs' sha256 agree across the
    trees; each goal met or missed; and whether the
    decisions agree.  Exits 1 where hashes or decisions differ."""
    import statistics
    script, parent = os.path.abspath(__file__), os.path.abspath(parent)
    shutil.copy(script, os.path.join(parent, "smoke_new.py"))
    trees = {"parent": (parent, os.path.join(parent, "smoke_new.py")),
             "change": (ROOT, script)}
    arms = []
    for i, name in enumerate(("parent", "change", "change", "parent")):
        cwd, path = trees[name]
        cmd = [sys.executable, path, "--score-fold-arm"]
        cmd += ["--decisions"] if i < 2 else []
        run = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
        print(run.stdout[-8000:], end="")
        if run.returncode != 0:
            print(f"FAIL: the {name} arm exited {run.returncode}: "
                  f"{run.stderr[-3000:]}")
            return 1
        arms.append((name, json.loads(run.stdout.strip().splitlines()[-1])[
            "score_fold_times"]))
    ok = True
    for key in arms[0][1]["rows"]:
        rows = [(n, a["rows"][key]) for n, a in arms]
        same = len({r["sha"] for _, r in rows}) == 1
        ok &= same
        print(f"[6] {key}: " + "; ".join(
            f"{n} graph {r['graph_ms']:.5f} ms, cuda_ms {r['cuda_ms']:.4f}, "
            f"host {r['host_us']:.1f} us, {r['ops']} ops" for n, r in rows)
            + f"; outputs bitwise equal across the trees: {same}")

    def med(tree, key, field="graph_ms"):
        return statistics.median(a["rows"][key][field] for n, a in arms
                                 if n == tree)
    goals = []
    for what in ("box", "config 2"):
        scan = f"a matched correlative scan (field, score, match), {what}"
        ops = [a["rows"][scan]["ops"] for n, a in arms if n == "change"]
        goals.append((f"device operations a matched scan, {what}",
                      f"{ops} [{med('parent', scan, 'ops')}]",
                      all(o == 2 for o in ops)))
        key = f"K11 lattice + point score, {what}"
        both, pboth = med("change", key), med("parent", key)
        alone = med("parent", f"K11 lattice alone, {what}")
        goals.append((f"lattice + score graph ms, {what}",
                      f"{both:.5f} [parent lattice alone {alone:.5f}, "
                      f"lattice + score {pboth:.5f}]",
                      both <= alone + 0.0008))
        key = f"matcher score and match, {what}"
        host, phost = med("change", key, "host_us"), med("parent", key,
                                                         "host_us")
        palone = med("parent", f"matcher match_scan alone, {what}",
                     "host_us")
        goals.append((f"host us of the score and match, {what}",
                      f"{host:.1f} [parent match_scan alone {palone:.1f}, "
                      f"both {phost:.1f}]", host <= palone))
    for M in (PARTICLES, GLOBAL_PARTICLES):
        key = f"KB2 stripe scores, {M} particles, stripe 0 of 2"
        c, p = med("change", key), med("parent", key)
        goals.append((f"KB2 graph ms, {M} particles", f"{c:.5f} [{p:.5f}], "
                      f"{c / p:.3f}x", c <= 0.85 * p))
    key = "KB2 stripe scores, the scan's world points, stripe 0 of 2"
    c, p = med("change", key), med("parent", key)
    goals.append(("KB2 graph ms, world points", f"{c:.5f} [{p:.5f}]",
                  c <= p))
    key = f"KB2 stripe scores, {PARTICLES} particles, stripe 0 of 2"
    c, p = med("change", key, "host_us"), med("parent", key, "host_us")
    goals.append(("KB2 host us a stripe_poses call", f"{c:.1f} [{p:.1f}]",
                  c <= p))
    for S in (2, 1):
        key = next(k for k in arms[0][1]["rows"]
                   if k.startswith(f"KB3 match of {S} stripes'"))
        c, p = med("change", key), med("parent", key)
        goals.append((f"KB3 match graph ms, S = {S}",
                      f"{c:.5f} [{p:.5f}], {c / p:.3f}x", c <= 0.6 * p))
        ops = [a["rows"][key]["ops"] for n, a in arms if n == "change"]
        goals.append((f"KB3 device operations a match, S = {S}",
                      f"{ops} [{med('parent', key, 'ops')}]",
                      all(o == 1 for o in ops)))
        c, p = med("change", key, "host_us"), med("parent", key, "host_us")
        goals.append((f"KB3 host us a match, S = {S}", f"{c:.1f} [{p:.1f}]",
                      c <= p))
    for name, figures, met in goals:
        print(f"[6] goal, {name}: {figures}: "
              f"{'met' if met else 'MISSED'}")
    p, c = arms[0][1], arms[1][1]
    for key in ("box", "kb3", "corridor"):
        same = (p[key] == c[key] if key != "box" else all(
            p[key][k] == c[key][k] for k in ("accepted", "ate", "poses_sha",
                                             "scores_sha")))
        ok &= same
        print(f"[6] decisions, {key}: parent {p[key]}, change {c[key]}; "
              f"equal: {same}")
    print(f"[6] config-2 corridor, correlative (not gated): parent "
          f"{p['corridor_ms']:.3f} ms/scan, change {c['corridor_ms']:.3f}")
    print(f"[6] [4r]'s 150 matches of two stripes' fields on one card (the "
          f"device synchronized around each): parent "
          f"{p['kb3_match_s']:.4f} s, change {c['kb3_match_s']:.4f} s")
    print(json.dumps({"score_fold_times": dict(
        arms=arms, goals=[dict(name=n, figures=f, met=m)
                          for n, f, m in goals], equal=ok)}))
    return 0 if ok else 1


class ReplacedInverse:
    """Within the block, one device's PCG system (``k4.PcgPlan.system``)
    hands ``pcg_solve`` another block-Jacobi inverse of the same damped
    blocks: "cublas", the parent's eager ``torch.linalg.inv``; "float64",
    the inverse in float64 rounded to float32.  Isolates the inverse's
    bits from the rest of the iteration."""

    def __init__(self, kind: str):
        self.kind = kind

    def __enter__(self):
        import torch

        from ndt_2d_tpu_torch.kernels import normal_blocks as k4
        self.real = real = k4.PcgPlan.system
        kind = self.kind

        def system(plan):
            out = real(plan)
            diag, pinv = out[3], out[4]
            eye = torch.eye(3, dtype=diag.dtype, device=diag.device)
            eps = torch.tensor(1e-8, dtype=diag.dtype, device=diag.device)
            m = (diag + plan.state.lam * (diag * eye) + eps * eye
                 + (1.0 - plan.fm)[:, None, None] * eye)
            pinv.copy_(torch.linalg.inv(m) if kind == "cublas"
                       else torch.linalg.inv(m.double()).to(pinv.dtype))
            return out
        k4.PcgPlan.system = system
        return self

    def __exit__(self, *exc):
        from ndt_2d_tpu_torch.kernels import normal_blocks as k4
        k4.PcgPlan.system = self.real
        return False


class SolveResiduals:
    """Within the block, each of one device's PCG solves (``k4.pcg_solve``)
    is followed by its relative residual |A x - b| / |b| of the damped
    system, in float64 through the matvec's twin, and its step count."""

    def __init__(self):
        self.rows = []

    def __enter__(self):
        import torch

        from ndt_2d_tpu_torch.kernels import normal_blocks as k4
        self.real = real = k4.pcg_solve
        rows = self.rows

        def solve(begin, end, baa, bab, bbb, diag, lam, fm, pinv, b,
                  max_iter, tol, inc):
            x, it = real(begin, end, baa, bab, bbb, diag, lam, fm, pinv, b,
                         max_iter, tol, inc)
            d = [t.double() for t in (baa, bab, bbb, diag, lam, fm, x, b)]
            ax = k4.pcg_matvec_twin(begin, end, *d[:6], d[6], inc)
            rows.append((float(torch.linalg.norm(ax - d[7])
                               / torch.linalg.norm(d[7])), int(it)))
            return x, it
        k4.pcg_solve = solve
        return self

    def __exit__(self, *exc):
        from ndt_2d_tpu_torch.kernels import normal_blocks as k4
        k4.pcg_solve = self.real
        return False


def config6_pcg_spread(dev, starts: int = 5, inverses=("tree",)) -> list:
    """Config 6 on one device with the solve forced to PCG (the smoke's
    ungated witness), from the solver's start damping and from
    ``starts`` - 1 starts perturbed in its last bits (``lm_lambda_init``
    x (1 + j 2^-20), j = 1, 2, ...: 8 j float32 ulps), for each of
    ``inverses`` ("tree": the tree's own block-Jacobi inverse, else a
    ``ReplacedInverse``), then dense from the first start: each session's
    closures, optimizations and final ATE, the spread the witness's move
    is read against."""
    import contextlib
    import dataclasses

    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    cfg6, bag3 = config6(), office_bag()
    lam0 = cfg6.solver.lm_lambda_init
    rows = []
    runs = [(kind, j, 0) for kind in inverses for j in range(starts)]
    for kind, j, limit in runs + [("tree", 0, cfg6.solver.dense_size_limit)]:
        c6 = dataclasses.replace(cfg6, solver=dataclasses.replace(
            cfg6.solver, dense_size_limit=limit,
            lm_lambda_init=lam0 * (1 + j * 2.0 ** -20)))
        # The first start's solves also record their residuals: its first
        # solve is the same system under every inverse.
        probe = SolveResiduals() if j == 0 and limit == 0 else None
        with (contextlib.nullcontext() if kind == "tree"
              else ReplacedInverse(kind)), (
                probe or contextlib.nullcontext()):
            st6, _, _, _, _, mp6 = run_session(
                c6, bag3, dev, mapper=Mapper(c6, device=dev))
        rows.append(dict(solve="pcg" if limit == 0 else "dense",
                         inverse=kind, j=j, closures=st6["loop_closures"],
                         optimizations=st6["session"]["optimizations"],
                         final_ate=final_ate(mp6, st6, bag3)))
        print(f"[6] config 6, {rows[-1]['solve']} ({kind} inverse), "
              f"lm_lambda_init x (1 + {j} 2^-20): {rows[-1]['closures']} "
              f"closures, {rows[-1]['optimizations']} optimizations, final "
              f"ATE {rows[-1]['final_ate']:.4f} m")
        if probe is not None and probe.rows:
            res = sorted(r for r, _ in probe.rows)
            capped = sum(it >= c6.solver.cg_max_iterations
                         for _, it in probe.rows)
            rows[-1]["residuals"] = probe.rows
            print(f"[6] config 6, pcg ({kind} inverse), its {len(res)} "
                  f"solves: the first's relative residual "
                  f"{probe.rows[0][0]:.4e} in {probe.rows[0][1]} steps, "
                  f"median {res[len(res) // 2]:.4e}, largest {res[-1]:.4e}, "
                  f"{capped} at the step cap")
    return rows


# ---------------------------------------------------------------------------
# The runtime surface: sessions, the control channel, the live server, the
# trace and the remaining verbs ([4v]-[4y]).
def first_parting(a, b) -> str:
    """"bitwise" when the pose arrays ``a`` and ``b`` are equal, else the
    first row where they differ and the largest difference."""
    import numpy as np
    if a.shape == b.shape and np.array_equal(a, b):
        return "bitwise equal"
    n = min(len(a), len(b))
    diff = np.abs(a[:n] - b[:n])
    rows = np.nonzero(diff.max(1) > 0)[0]
    first = int(rows[0]) if len(rows) else n
    return (f"not bitwise: first parts at scan {first}, at most "
            f"{diff.max(0).tolist()} (x, y, theta)")


def split_session(cfg, bag, dev, at: int, path: str, closure: bool):
    """Map ``bag`` to scan ``at``, save the session to ``path``, load it
    and map the rest (each scan's sweep end from the whole bag, as
    ``run_bag`` gives it); flush, and with ``closure`` the final loop
    closure pass of ``run_bag``.  Returns (resumed mapper, accepted,
    save s, load s)."""
    from ndt_2d_tpu_torch.io import serialization
    from ndt_2d_tpu_torch.mapping import runtime
    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    mapper, accepted = Mapper(cfg, device=dev), 0
    for t in range(len(bag)):
        if t == at:
            t0 = time.perf_counter()
            serialization.save_session(mapper, path)
            t1 = time.perf_counter()
            mapper = serialization.load_session(path, cfg, device=dev)
            t2 = time.perf_counter()
        msg, odom = bag[t]
        res = mapper.process_scan(msg, odom,
                                  runtime.sweep_end_odom(bag, t, msg))
        accepted += int(res.accepted)
    mapper.flush()
    if closure:
        mapper.loop_closure()
    return mapper, accepted, t1 - t0, t2 - t1


def phase_resume(cfg, bag, dev, sync_poses, pipelined_poses, map4, digest4,
                 graph3, tmp):
    """[4v] Sessions on the card.  Config 2's corridor split at scan 100
    (save, load, go on), synchronous and at max_inflight = 8: every scan
    accepted as in the continuous runs, ATE below odometry's, within
    0.03 m across the corridor and 0.01 rad in heading of the continuous
    run's poses ([4a], [4k]); printed whether bitwise and where they part.
    Config 4's filter split at its 75th scan with the CUDA generator's
    state restored: final error <= 0.10 m, particles' sha256 beside [4d]'s.
    The save and load of config 3's final graph, timed."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.io import serialization
    from ndt_2d_tpu_torch.io.bag import record_synthetic
    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    from ndt_2d_tpu_torch.utils import metrics
    odom_ate = metrics.ate_rmse(bag.odom, bag.truth)
    for name, c, cont, closure in (
            ("synchronous", cfg, sync_poses, True),
            ("max_inflight=8", pipelined(cfg), pipelined_poses, False)):
        path = os.path.join(tmp, "config2_session.npz")
        m, acc, save_s, load_s = split_session(c, bag, dev, 100, path,
                                               closure)
        g = m.graph
        require(acc == len(bag) and g.num_scans == len(cont),
                f"[4v] {name}: split session accepted {acc} scans, graph "
                f"{g.num_scans}, continuous {len(cont)}")
        ate = metrics.ate_rmse(g.poses, bag.truth)
        require(np.isfinite(ate) and ate < odom_ate, f"[4v] {name}: split "
                f"session ATE {ate} not below odometry's {odom_ate}")
        dx, dy, dth = np.abs(g.poses - cont).max(0)
        require(dy <= 0.03 and dth <= 0.01, f"[4v] {name}: split session "
                f"parts from the continuous run across the corridor by "
                f"{dy} m or in heading by {dth} rad")
        print(f"[4v] config 2 {name} split at scan 100 (save "
              f"{save_s:.3f} s, load {load_s:.3f} s): {acc}/{len(bag)} "
              f"accepted, ATE {ate:.4f} m (odometry {odom_ate:.4f}); "
              f"against the continuous run: {first_parting(g.poses, cont)}")

    # Config 4's particle filter, split mid-run.
    _, pcfg = config4_configs()
    loc_bag = record_synthetic("box", 150, n_beams=360, seed=7,
                               odom_trans_noise=0.01)
    rel = metrics.relative_to_first(loc_bag.truth)
    loc = localizer(pcfg, map4, dev, 3)
    loc.set_initial_pose(rel[0], np.diag([0.04, 0.04, 0.01]),
                         loc_bag.truth[0])
    path = os.path.join(tmp, "config4_session.npz")
    errs = []
    for t in range(1, len(loc_bag)):
        if t == 75:
            serialization.save_session(loc, path)
            state = loc.filter.gen.get_state()
            loc = serialization.load_session(path, pcfg, seed=0, device=dev)
            require(loc.filter.gen.device.type == "cuda"
                    and torch.equal(loc.filter.gen.get_state(), state),
                    "[4v] the filter's CUDA generator state was not "
                    "restored")
        msg, odom = loc_bag[t]
        res = loc.process_scan(msg, odom)
        if res.accepted:
            errs.append(float(np.hypot(*(res.pose[:2] - rel[t][:2]))))
    final = errs[-1]
    require(np.isfinite(errs).all() and final <= 0.10,
            f"[4v] config 4 split filter: final error {final} > 0.10 m")
    digest = poses_digest(loc.filter.particles.cpu().numpy())
    print(f"[4v] config 4 filter split at scan 75 (CUDA generator state "
          f"restored, {state.numel()} bytes): {len(errs)} accepted, mean "
          f"error {float(np.mean(errs)):.4f} m, final {final:.4f} m; "
          f"particles sha256 {digest}, [4d]'s continuous {digest4}: "
          f"{'equal' if digest == digest4 else 'DIFFERENT'}")

    # Save and load of config 3's final graph.
    m3 = Mapper(office_config(), graph=graph3, device=dev)
    path = os.path.join(tmp, "config3_session.npz")
    t0 = time.perf_counter()
    serialization.save_session(m3, path)
    t1 = time.perf_counter()
    back = serialization.load_session(path, office_config(), device=dev)
    t2 = time.perf_counter()
    require(np.array_equal(back.graph.poses, graph3.poses)
            and np.array_equal(back.graph.points, graph3.points),
            "[4v] config 3's graph did not load back equal")
    print(f"[4v] config 3's final graph ({graph3.num_scans} scans, "
          f"{graph3.num_constraints} constraints, "
          f"{os.path.getsize(path) / 2**20:.2f} MiB): save_session "
          f"{t1 - t0:.3f} s, load_session {t2 - t1:.3f} s wall")


def cli_run(argv, what: str) -> dict:
    """``python3 -m ndt_2d_tpu_torch.cli`` ``argv`` in a process of its
    own; its stats line."""
    out = subprocess.run(
        [sys.executable, "-m", "ndt_2d_tpu_torch.cli", *argv],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    require(out.returncode == 0, f"{what} exited {out.returncode}: "
            f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


CONFIG2_FLAGS = ["--local_scan_matcher.grid_cells", "192",
                 "--global_scan_matcher.grid_cells", "192",
                 "--max-points-per-scan", "512",
                 "--loop-closure-every", "1000000000"]


def phase_control(cfg, bag, dev, tmp):
    """[4w] The control channel on the card: ``run_bag(control=...)`` over
    config 2's bag with actions sent from the progress callback (mapping
    off after scan 59; after scan 69 a save, a load of that map, mapping
    on and an initial pose 1.8 m on, within the reference's squared 10 m²
    radius of the graph), the mapper's state checked after each; then
    ``run --session-out`` and ``run --resume`` on the bag's two halves
    beside one ``run`` of the whole, each a process of its own."""
    import numpy as np

    from ndt_2d_tpu_torch.io import serialization
    from ndt_2d_tpu_torch.io.bag import ScanBag, save_bag
    from ndt_2d_tpu_torch.mapping import runtime
    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    from ndt_2d_tpu_torch.utils import metrics
    rel = metrics.relative_to_first(bag.truth)
    mapper = Mapper(cfg, device=dev)
    map_path = os.path.join(tmp, "mid_map.npz")
    sock = "ctl.sock"
    seen = {}

    def progress(t, res):
        if t == 59:
            require(runtime.send_configure(sock, 2)["ok"]
                    and not mapper.enable_mapping
                    and not mapper.prev_odom_pose_is_initialized,
                    "[4w] DISABLE_MAPPING did not take")
            seen["off"] = mapper.graph.num_scans
        elif t == 69:
            require(mapper.graph.num_scans == seen["off"],
                    "[4w] the graph grew while mapping was off")
            require(runtime.send_configure(sock, 8, map_path)["ok"]
                    and serialization.load_graph(map_path, 512).num_scans
                    == seen["off"], "[4w] SAVE_TO_FILE")
            require(runtime.send_configure(sock, 4, map_path)["ok"]
                    and mapper.graph.num_scans == seen["off"]
                    and mapper._window_synced == -1, "[4w] LOAD_FROM_FILE")
            require(runtime.send_configure(sock, 1)["ok"]
                    and mapper.enable_mapping, "[4w] ENABLE_MAPPING")
            require(mapper.set_initial_pose(
                rel[t], np.diag([0.04, 0.04, 0.01]), bag.odom[t]),
                "[4w] the initial pose after the load was refused")
    # In tmp, UNIX sockets are bound by a short relative name (a socket's
    # path is limited to 108 bytes).
    with contextlib.chdir(tmp):
        control = runtime.ControlServer(mapper, sock)
        try:
            reset_counts()
            stats = runtime.run_bag(mapper, bag, progress=progress,
                                    control=control)
            launches = read_counts()
        finally:
            control.close()
    on = len(bag) - 70
    require(stats["scans_accepted"] == seen["off"] + on
            and mapper.graph.num_scans == seen["off"] + 1 + on,
            f"[4w] {stats['scans_accepted']} accepted, graph "
            f"{mapper.graph.num_scans}: expected {seen['off']} + {on}")
    err = float(np.hypot(*(mapper.graph.poses[-1, :2] - rel[-1, :2])))
    require(err <= 0.25, f"[4w] final pose {err} m from the truth")
    require(launches["window_append"] >= on - 1,
            f"[4w] K13 launched {launches['window_append']} times")
    print(f"[4w] run_bag with the control channel over config 2: mapping "
          f"off after scan 59 ({seen['off']} scans), a save, a load and "
          f"mapping on after scan 69, then {on} more scans mapped; final "
          f"pose {err:.4f} m from the truth; launches {launches}")

    # The CLI in processes of its own: two halves through a session
    # checkpoint beside one run.
    half = len(bag) // 2
    paths = {}
    for name, sl in (("whole", slice(None)), ("a", slice(0, half)),
                     ("b", slice(half, None))):
        paths[name] = os.path.join(tmp, f"config2_{name}.npz")
        save_bag(ScanBag(ranges=bag.ranges[sl], angle_min=bag.angle_min,
                         angle_increment=bag.angle_increment,
                         time_increment=bag.time_increment,
                         range_max=bag.range_max, odom=bag.odom[sl],
                         truth=bag.truth[sl]), paths[name])
    session = os.path.join(tmp, "cli_session.npz")
    one_map, split_map = (os.path.join(tmp, "one_map.npz"),
                          os.path.join(tmp, "split_map.npz"))
    t0 = time.perf_counter()
    one = cli_run(["run", "--bag", paths["whole"], "--map-out", one_map,
                   *CONFIG2_FLAGS], "[4w] run")
    a = cli_run(["run", "--bag", paths["a"], "--session-out", session,
                 *CONFIG2_FLAGS], "[4w] run --session-out")
    b = cli_run(["run", "--bag", paths["b"], "--resume", session,
                 "--map-out", split_map, *CONFIG2_FLAGS], "[4w] run --resume")
    wall = time.perf_counter() - t0
    require(a["scans_accepted"] + b["scans_accepted"]
            == one["scans_accepted"] == len(bag)
            and b["graph_scans"] == one["graph_scans"],
            f"[4w] CLI halves accepted {a['scans_accepted']} + "
            f"{b['scans_accepted']}, one run {one['scans_accepted']}")
    p_one = serialization.load_graph(one_map, 512).poses
    p_split = serialization.load_graph(split_map, 512).poses
    _, dy, dth = np.abs(p_split - p_one).max(0)
    require(dy <= 0.03 and dth <= 0.01, f"[4w] CLI split run parts from one "
            f"run by {dy} m across the corridor or {dth} rad")
    print(f"[4w] CLI run --session-out / run --resume on config 2's halves "
          f"(bags with time_increment {bag.time_increment}: no de-skew, so "
          f"the first half's last scan loses nothing) beside one run: "
          f"{a['scans_accepted']} + {b['scans_accepted']} accepted, ATE "
          f"{b.get('ate_rmse_m', float('nan')):.4f} (second half) / "
          f"{one['ate_rmse_m']:.4f} m (one run); maps "
          f"{first_parting(p_split, p_one)}; three processes {wall:.1f} s")


# [4z]: the actions two gloo ranks take after scan t (at the boundary
# before scan t + 1), as the CPU test of the mesh's control channel sends
# them; every rank sets its pose again after scan 6 (mapping off forgot
# it).  The ranks replay config 2's first Z_SCANS scans.
Z_ACTIONS = {3: (2, ""), 6: (1, ""), 9: (8, "z_map.npz")}
Z_SCANS = 100


def control_session(cfg, bag, dev, mesh, channel: bool) -> dict:
    """One [4z] session on a rank of ``mesh``: ``bag`` through ``run_bag``
    with Z_ACTIONS sent over the control channel from rank 0's progress
    callback (``channel``; each request queued before the callback
    returns, the reply awaited by a client thread), or applied straight
    through ``Mapper.configure`` by every rank's callback (a save by rank 0
    alone).  Returns the final poses' digest, each scan's wall (ms, from
    one callback to the next), the replies and the files this rank
    wrote."""
    import threading

    import numpy as np

    from ndt_2d_tpu_torch.io import serialization
    from ndt_2d_tpu_torch.mapping import runtime
    from ndt_2d_tpu_torch.mapping.mapper import SAVE_TO_FILE, Mapper
    from ndt_2d_tpu_torch.parallel import distributed
    from ndt_2d_tpu_torch.utils import metrics
    rank = distributed.rank()
    mapper = Mapper(cfg, device=dev, mesh=mesh)
    rel = metrics.relative_to_first(bag.truth)
    saves, stamps, replies, clients = [], [], [], []
    real_save = serialization.save_graph

    def save_graph(graph, path):
        saves.append(path)
        real_save(graph, path)
    control = (runtime.ControlServer(mapper, "z.sock", mesh=mesh)
               if channel else None)

    def progress(t, res):
        stamps.append(time.perf_counter())
        if t == 6:
            mapper.set_initial_pose(rel[t], np.diag([0.04, 0.04, 0.01]),
                                    bag.odom[t])
        if t not in Z_ACTIONS:
            return
        action, filename = Z_ACTIONS[t]
        if not channel:
            mapper.configure(action if rank == 0
                             else action & ~SAVE_TO_FILE, filename)
        elif rank == 0:
            c = threading.Thread(target=lambda: replies.append(
                runtime.send_configure("z.sock", action, filename)))
            c.start()
            clients.append(c)
            while control.pending() == 0 and c.is_alive():
                c.join(0.0005)
    serialization.save_graph = save_graph
    try:
        runtime.run_bag(mapper, bag, progress=progress, control=control)
    finally:
        for c in clients:
            c.join()
        if control is not None:
            control.close()
        serialization.save_graph = real_save
    g = mapper.graph
    return dict(digest=poses_digest(g.poses[:g.num_scans]),
                walls=np.diff(np.asarray(stamps)) * 1e3, replies=replies,
                saves=saves, scans=g.num_scans)


def control_rank(out_dir: str, device: str) -> int:
    """One gloo rank of ``phase_mesh_control``: a (2, 1) mesh whose ranks
    share ``device``; config 2's first Z_SCANS scans four times, without
    and with the control channel (without, with, with, without), the
    results saved to ``out_dir``."""
    import numpy as np
    import torch

    from ndt_2d_tpu_torch.parallel import distributed, mesh as mesh_mod
    from ndt_2d_tpu_torch.config import MapperConfig, ScanMatcherConfig
    from ndt_2d_tpu_torch.io.bag import record_synthetic
    dev = distributed.initialize(device, backend="gloo")
    mesh = mesh_mod.make_mesh(shape=(2, 1))
    bag = bag_prefix(record_synthetic("corridor", N_SCANS, n_beams=N_BEAMS,
                                      seed=0), Z_SCANS)
    m = ScanMatcherConfig(grid_cells_x=192, grid_cells_y=192)
    cfg = MapperConfig(local_scan_matcher=m, global_scan_matcher=m,
                       max_points_per_scan=512, loop_closure_every=10**9)
    os.chdir(out_dir)  # a socket's path is limited to 108 bytes
    out = {}
    for i, channel in enumerate((False, True, True, False)):
        r = control_session(cfg, bag, dev, mesh, channel)
        out[f"run{i}_digest"] = r["digest"]
        out[f"run{i}_walls"] = r["walls"]
        out[f"run{i}_scans"] = r["scans"]
        out[f"local_run{i}_saves"] = np.asarray(r["saves"])
        out[f"local_run{i}_replies"] = np.asarray(
            [json.dumps(x) for x in r["replies"]])
    out["jax"] = "jax" in sys.modules
    np.savez(os.path.join(out_dir, f"rank{distributed.rank()}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def bag_prefix(bag, n: int):
    """The first ``n`` scans of ``bag``."""
    from ndt_2d_tpu_torch.io.bag import ScanBag
    return ScanBag(ranges=bag.ranges[:n], angle_min=bag.angle_min,
                   angle_increment=bag.angle_increment,
                   time_increment=bag.time_increment,
                   range_max=bag.range_max, odom=bag.odom[:n],
                   truth=bag.truth[:n])


def phase_mesh_control(bag, tmp):
    """[4z] The control channel on a mesh.  ``run --mesh 1 --socket`` on
    config 2's bag (one NCCL rank, a process of its own) takes a save-map
    from a client thread and exits 0; then two gloo ranks sharing the
    card replay config 2's first Z_SCANS scans with Z_ACTIONS, applied
    directly and sent over the channel (``control_rank``): the two ranks'
    final graphs hash equal, the channel's equal the direct runs', the map
    written once, by rank 0; ms a scan with and without the channel (the
    broadcast's cost)."""
    import threading

    import numpy as np

    from ndt_2d_tpu_torch.io import serialization
    from ndt_2d_tpu_torch.io.bag import save_bag
    from ndt_2d_tpu_torch.mapping import runtime
    from ndt_2d_tpu_torch.parallel import distributed
    path = os.path.join(tmp, "z_config2.npz")
    save_bag(bag, path)
    out_map = os.path.join(tmp, "z_cli_map.npz")
    box = {}

    def client():
        t0 = time.monotonic()
        while time.monotonic() - t0 < 300 and "reply" not in box:
            try:
                box["reply"] = runtime.send_configure("z_cli.sock", 8,
                                                      out_map)
            except (FileNotFoundError, ConnectionRefusedError):
                time.sleep(0.001)
    # In tmp, the socket is bound and reached by a short relative name.
    with contextlib.chdir(tmp):
        c = threading.Thread(target=client)
        c.start()
        t0 = time.perf_counter()
        try:
            run = subprocess.run(
                [sys.executable, "-m", "ndt_2d_tpu_torch.cli", "run",
                 "--bag", path, "--mesh", "1", "--socket", "z_cli.sock",
                 *CONFIG2_FLAGS], capture_output=True, text=True, cwd=tmp,
                timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
        finally:
            box.setdefault("reply", {"ok": False, "error": "no reply"})
            c.join()
        wall = time.perf_counter() - t0
    require(run.returncode == 0, f"[4z] run --mesh 1 --socket exited "
            f"{run.returncode}: {run.stderr[-2000:]}")
    require(box["reply"] == {"ok": True}, f"[4z] save-map over the channel "
            f"of run --mesh 1: {box['reply']}")
    stats = json.loads(run.stdout.strip().splitlines()[-1])
    saved = serialization.load_graph(out_map, 512).num_scans
    require(1 <= saved <= stats["graph_scans"], f"[4z] the saved map holds "
            f"{saved} scans")
    print(f"[4z] run --mesh 1 --socket on config 2's bag (one NCCL rank): "
          f"save-map answered ok, a map of {saved} scans, "
          f"{stats['scans_accepted']} of {stats['scans_in']} accepted; "
          f"process {wall:.1f} s")

    out = os.path.join(tmp, "z_ranks")
    os.makedirs(out)
    t0 = time.perf_counter()
    distributed.launch([sys.executable, os.path.abspath(__file__),
                        "--control-rank", out, "cuda:0"], 2, timeout=600)
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with np.load(os.path.join(out, f"rank{r}.npz")) as z:
            ranks.append({k: z[k] for k in z.files})
    a, b = ranks
    require(not a["jax"] and not b["jax"], "[4z] a rank imported jax")
    digests = {str(a[f"run{i}_digest"]) for i in range(4)}
    for i in range(4):
        require(str(a[f"run{i}_digest"]) == str(b[f"run{i}_digest"]),
                f"[4z] run {i}: the ranks' final graphs differ")
    require(len(digests) == 1, f"[4z] the runs' graphs differ: {digests}")
    for i in (1, 2):
        replies = [json.loads(x) for x in a[f"local_run{i}_replies"]]
        require(replies == [{"ok": True}] * len(Z_ACTIONS),
                f"[4z] run {i}: replies {replies}")
    for i in range(4):
        require(list(a[f"local_run{i}_saves"]) == ["z_map.npz"]
                and b[f"local_run{i}_saves"].size == 0,
                f"[4z] run {i}: saves {a[f'local_run{i}_saves']}, "
                f"{b[f'local_run{i}_saves']}")

    def ms(i):  # scans 12 on, after the actions
        return [float(np.median(r[f"run{i}_walls"][12:])) for r in ranks]
    plain, chan = ms(0) + ms(3), ms(1) + ms(2)
    print(f"[4z] 2 gloo ranks on cuda:0, config 2's first {Z_SCANS} scans, "
          f"mapping off after scan 3 and on after 6, a save after 9: over "
          f"the channel from rank 0's callback and straight through "
          f"configure, final graphs bitwise equal on both ranks and across "
          f"the runs (sha256 {digests.pop()}), the map written once by rank "
          f"0; ms a scan (median, scans 12 on; rank 0, rank 1 of each run) "
          f"without the channel {[round(x, 4) for x in plain]}, with "
          f"{[round(x, 4) for x in chan]}: the broadcast "
          f"{float(np.median(chan)) - float(np.median(plain)):+.4f} ms a "
          f"scan; launch + 2 ranks {wall:.1f} s")


def sync_stream(path, sock) -> tuple:
    """The synchronous protocol scan by scan: every reply, and each
    scan's request-to-reply seconds."""
    import socket

    from ndt_2d_tpu_torch.io.bag import load_bag
    bag = load_bag(path)
    replies, times = [], []
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(sock)
        f = s.makefile("rwb")
        for t, (msg, odom) in enumerate(bag):
            req = {"id": t, "ranges": msg.ranges.astype(float).tolist(),
                   "angle_min": msg.angle_min,
                   "angle_increment": msg.angle_increment,
                   "time_increment": msg.time_increment,
                   "range_max": msg.range_max, "odom": odom.tolist()}
            t0 = time.perf_counter()
            f.write(json.dumps(req).encode() + b"\n")
            f.flush()
            replies.append(json.loads(f.readline()))
            times.append(time.perf_counter() - t0)
    return replies, times


def phase_live(cfg, bag, dev, tmp):
    """[4x] The live server on the card.  A ScanServer on the pipelined
    mapper (max_inflight = 8) with its publisher: ``stream_bag(...,
    windowed=True)`` of config 2's bag returns a pose for every deferred
    scan, each bitwise the graph's; the publisher writes state.json and
    map.npz from its thread (K5 launched there).  A synchronous server,
    publishing alike, answers every scan with the graph's pose.  The
    client's median ms a scan of both protocols, printed."""
    import numpy as np

    from ndt_2d_tpu_torch.io.bag import save_bag
    from ndt_2d_tpu_torch.mapping import server as server_mod
    from ndt_2d_tpu_torch.mapping.mapper import Mapper
    path = os.path.join(tmp, "config2_live.npz")
    save_bag(bag, path)
    pub = os.path.join(tmp, "pub")
    # In tmp, UNIX sockets are bound by a short relative name (a socket's
    # path is limited to 108 bytes).
    with contextlib.chdir(tmp):
        mapper = Mapper(pipelined(cfg), device=dev)
        srv = server_mod.ScanServer(mapper, "scan.sock", publish_dir=pub)
        try:
            reset_counts()
            last = server_mod.stream_bag(path, "scan.sock", windowed=True)
            deadline = time.time() + 30.0
            while (srv.publisher.publish_count < 1
                   or mapper.map_update_available) and \
                    time.time() < deadline:
                time.sleep(0.05)
            launches = read_counts()
        finally:
            srv.close()
        require(last["ok"], f"[4x] windowed stream: {last}")
        results = last["results"]
        g = mapper.graph
        require(g.num_scans == len(bag) and len(results) == len(bag) - 1,
                f"[4x] windowed: graph {g.num_scans}, {len(results)} "
                "results")
        got = np.asarray([results[t]["pose"] for t in range(1, len(bag))])
        require(np.array_equal(got, g.poses[1:]),
                "[4x] a windowed result is not bitwise the graph's pose")
        require(srv.publisher.publish_count >= 1
                and os.path.exists(os.path.join(pub, "map.npz"))
                and os.path.exists(os.path.join(pub, "state.json")),
                "[4x] the publisher wrote no map.npz or state.json")
        require(launches["raymarch"] >= 1, "[4x] K5 never launched from "
                "the publisher's thread")
        require(launches["window_append"] == len(bag) - 1,
                f"[4x] K13 launched {launches['window_append']} times from "
                "the client thread")
        with open(os.path.join(pub, "state.json")) as f:
            state = json.load(f)
        w_ms = float(np.median(last["scan_times_s"][3:]) * 1e3)

        # The synchronous server publishes too, so that the two protocols'
        # client times are taken under the same publisher.
        smapper = Mapper(cfg, device=dev)
        ssrv = server_mod.ScanServer(smapper, "sync.sock",
                                     publish_dir=os.path.join(tmp, "pub_s"))
        try:
            replies, times = sync_stream(path, "sync.sock")
        finally:
            ssrv.close()
        require(all(r["ok"] and r["accepted"] and len(r["pose"]) == 3
                    for r in replies) and len(replies) == len(bag),
                "[4x] the synchronous server left a scan without a pose")
        sposes = np.asarray([r["pose"] for r in replies])
        require(np.array_equal(sposes, smapper.graph.poses),
                "[4x] a synchronous reply is not the graph's pose")
        s_ms = float(np.median(times[3:]) * 1e3)
    print(f"[4x] live server, config 2 over a UNIX socket: windowed "
          f"protocol on max_inflight=8, {len(results)} deferred poses "
          f"bitwise the graph's, {w_ms:.3f} ms a scan (client median, scans "
          f"3+); synchronous protocol, {len(replies)} replies each with a "
          f"pose, {s_ms:.3f} ms a scan; windowed / synchronous "
          f"{w_ms / s_ms:.3f}; publisher (4 Hz, both servers): "
          f"{srv.publisher.publish_count} and "
          f"{ssrv.publisher.publish_count} map.npz, state.json at "
          f"{state['nodes']} nodes; launches {launches}")


TRACE_KERNELS = {"K1": ("bin_points", "sort_cells", "cell_records"),
                 "K2": ("score_angles",),
                 "K3": ("score_pose_kernel", "score_points_kernel"),
                 "K13": ("window_append_kernel",)}


def phase_trace_verbs(bag, graph3, dev, tmp):
    """[4y] ``run --trace-dir`` over config 2's first 30 scans leaves a
    Chrome trace holding CUDA kernel events of K1, K2, K3 and K13 by their
    symbols; ``export-rosbag2`` then ``import-rosbag2`` of config 3's map
    give back equal arrays, and ``info`` prints.  The PNG outputs need
    matplotlib, which the card's machine may lack: the phase says which."""
    import importlib.util

    import numpy as np

    from ndt_2d_tpu_torch import cli
    from ndt_2d_tpu_torch.io import serialization
    from ndt_2d_tpu_torch.io.bag import ScanBag, save_bag
    from ndt_2d_tpu_torch.utils.profiling import TRACE_FILE
    path = os.path.join(tmp, "config2_30.npz")
    save_bag(ScanBag(ranges=bag.ranges[:30], angle_min=bag.angle_min,
                     angle_increment=bag.angle_increment,
                     time_increment=bag.time_increment,
                     range_max=bag.range_max, odom=bag.odom[:30],
                     truth=bag.truth[:30]), path)
    trace_dir = os.path.join(tmp, "trace")
    require(cli.main(["run", "--bag", path, "--trace-dir", trace_dir,
                      *CONFIG2_FLAGS]) == 0, "[4y] run --trace-dir")
    with open(os.path.join(trace_dir, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {}
    for k, symbols in TRACE_KERNELS.items():
        found[k] = sum(any(s in n for s in symbols) for n in kernels)
        require(found[k] >= 1, f"[4y] the trace holds no kernel of {k} "
                f"({symbols}); kernels: {sorted(set(kernels))[:20]}")
    print(f"[4y] run --trace-dir over 30 scans: "
          f"{os.path.getsize(os.path.join(trace_dir, TRACE_FILE)) / 2**20:.1f}"
          f" MiB trace, {len(kernels)} kernel events, by kernel {found}")

    native = os.path.join(tmp, "config3_map.npz")
    serialization.save_graph(graph3, native)
    bag_dir = os.path.join(tmp, "config3_rosbag2")
    back = os.path.join(tmp, "config3_back.npz")
    require(cli.main(["export-rosbag2", "--map", native, "--out",
                      bag_dir]) == 0
            and cli.main(["import-rosbag2", "--bag", bag_dir, "--out",
                          back]) == 0, "[4y] rosbag2 verbs")
    a, b = (serialization.load_graph(native, 512),
            serialization.load_graph(back, 512))
    for name in ("poses", "points", "point_mask", "constraint_begin",
                 "constraint_end", "constraint_transform",
                 "constraint_information", "constraint_switchable"):
        require(np.array_equal(getattr(a, name), getattr(b, name)),
                f"[4y] {name} differs after the rosbag2 round trip")
    require(cli.main(["info", "--map", back]) == 0, "[4y] info")
    print(f"[4y] export-rosbag2 / import-rosbag2 of config 3's map "
          f"({a.num_scans} scans, {a.num_constraints} constraints): every "
          f"array equal")
    if importlib.util.find_spec("matplotlib") is None:
        print("[4y] viz, run --viz-out and serve --publish-png not run: "
              "matplotlib is not installed on this machine")
    else:
        png = os.path.join(tmp, "config3.png")
        require(cli.main(["viz", "--map", native, "--render-grid",
                          "--out", png]) == 0, "[4y] viz")
        with open(png, "rb") as f:
            require(f.read(8) == b"\x89PNG\r\n\x1a\n", "[4y] viz PNG")
        print(f"[4y] viz of config 3's map with the grid rendered on the "
              f"card: {os.path.getsize(png)} bytes of PNG")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed")
        return 2
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False")
        return 2
    if sys.argv[1:2] == ["--mesh-rank"]:
        out, space, batch, map4, device = sys.argv[2:7]
        return mesh_rank(out, int(space), int(batch), map4, device)
    if sys.argv[1:2] == ["--mesh-district-rank"]:
        return mesh_district_rank(*sys.argv[2:4])
    if sys.argv[1:2] == ["--control-rank"]:
        return control_rank(*sys.argv[2:4])
    if sys.argv[1:2] == ["--blocks-rank"]:
        out, space, batch, map4, map7, device, parts = sys.argv[2:9]
        return blocks_rank(out, int(space), int(batch), map4, map7, device,
                           parts)
    if "--profile" in sys.argv[1:]:
        from ndt_2d_tpu_torch.device import get_device
        profile_sessions(get_device("cuda:0"))
        return 0
    if "--session-times" in sys.argv[1:]:
        from ndt_2d_tpu_torch.device import get_device
        dev = get_device("cuda:0")
        ident = phase_card()
        phase_build()
        print(json.dumps({"session_times": session_times(dev, ident),
                          "card": ident}))
        return 0
    if "--optimize-times" in sys.argv[1:]:
        from ndt_2d_tpu_torch.device import get_device
        dev = get_device("cuda:0")
        ident = phase_card()
        phase_build()
        print(json.dumps({"optimize_times": optimize_times(dev, ident),
                          "card": ident}))
        return 0
    if "--slam-times" in sys.argv[1:]:
        from ndt_2d_tpu_torch.device import get_device
        dev = get_device("cuda:0")
        ident = phase_card()
        phase_build()
        print(json.dumps({"slam_times": slam_times(dev, ident),
                          "card": ident}))
        return 0
    if "--mesh-district" in sys.argv[1:]:
        from ndt_2d_tpu_torch.device import get_device
        dev = get_device("cuda:0")
        ident = phase_card()
        phase_build()
        mesh_district_times(dev, ident)
        return 0
    if "--pf-times" in sys.argv[1:]:
        from ndt_2d_tpu_torch.device import get_device
        dev = get_device("cuda:0")
        ident = phase_card()
        phase_build()
        print(json.dumps({"pf_times": pf_times(dev, ident), "card": ident}))
        return 0
    if "--config6-spread" in sys.argv[1:]:
        from ndt_2d_tpu_torch.device import get_device
        dev = get_device("cuda:0")
        ident = phase_card()
        phase_build()
        from ndt_2d_tpu_torch.kernels import normal_blocks as k4
        kinds = (("tree", "cublas", "float64") if hasattr(k4, "PcgPlan")
                 else ("tree",))
        print(json.dumps({"config6_pcg": config6_pcg_spread(dev, 16, kinds),
                          "card": ident}))
        return 0
    if "--pcg-lattice-times" in sys.argv[1:]:
        from ndt_2d_tpu_torch.device import get_device
        dev = get_device("cuda:0")
        ident = phase_card()
        phase_build()
        print(json.dumps({"pcg_lattice_times": pcg_lattice_times(dev,
                                                                 ident)}))
        return 0
    if "--field-bins-arm" in sys.argv[1:]:
        from ndt_2d_tpu_torch.device import get_device
        dev = get_device("cuda:0")
        ident = phase_card()
        phase_build()
        print(json.dumps({"field_bins_times": field_bins_times(
            dev, ident, "--decisions" in sys.argv[1:])}))
        return 0
    if sys.argv[1:2] == ["--field-bins-times"]:
        return field_bins_arms(sys.argv[2])
    if "--spectra-finalize-arm" in sys.argv[1:]:
        from ndt_2d_tpu_torch.device import get_device
        dev = get_device("cuda:0")
        ident = phase_card()
        phase_build()
        print(json.dumps({"spectra_finalize_times": spectra_finalize_times(
            dev, ident, "--decisions" in sys.argv[1:])}))
        return 0
    if sys.argv[1:2] == ["--spectra-finalize-times"]:
        return spectra_finalize_arms(sys.argv[2])
    if "--score-fold-arm" in sys.argv[1:]:
        from ndt_2d_tpu_torch.device import get_device
        dev = get_device("cuda:0")
        ident = phase_card()
        phase_build()
        print(json.dumps({"score_fold_times": score_fold_times(
            dev, ident, "--decisions" in sys.argv[1:])}))
        return 0
    if sys.argv[1:2] == ["--score-fold-times"]:
        return score_fold_arms(sys.argv[2])
    if "--kb3-breakdown" in sys.argv[1:]:
        return kb3_breakdown()
    if "--kernel-times" in sys.argv[1:]:
        from ndt_2d_tpu_torch.device import get_device
        from ndt_2d_tpu_torch.io.bag import record_synthetic
        dev = get_device("cuda:0")
        ident = phase_card()
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            map4 = os.path.join(tmp, "box_map.npz")
            bag4 = record_synthetic("box", 150, n_beams=360, seed=2)
            map_and_save(config4_configs()[0], bag4, map4, dev)
            out = kernel_times(dev, ident, map4, bag4)
        print(json.dumps({"kernel_times": out, "card": ident}))
        return 0
    try:
        from ndt_2d_tpu_torch.device import get_device
        from ndt_2d_tpu_torch.io.bag import record_synthetic
        dev = get_device("cuda:0")
        ident = phase_card()
        phase_build()
        bag, cfg, win, query, rays = inputs(dev)
        timing = phase_kernels(cfg, win, query, rays, dev)
        timing.update(phase_k8(cfg, win, query, dev))
        cfg3, bag3 = office_config(), office_bag()
        timing.update(phase_rows(cfg3, bag3, dev))
        phase_k1_stress(dev)
        phase_k2_edges(cfg3, bag3, dev)
        truth, district = district_graph()
        timing.update(phase_k4(district, dev, ident))
        cfg6 = config6()
        timing.update(phase_k6(cfg6, bag3, dev))
        timing.update(phase_k10(cfg6, bag3, dev))
        phase_chain(cfg6, bag3, dev)
        timing.update(phase_k12(cfg, win, query, cfg3, bag3, cfg6, dev))
        timing.update(phase_k3_pose(cfg, win, query, bag3, dev))
        timing.update(phase_k13(cfg, win, query, bag, dev))
        timing.update(phase_k11(cfg, bag, win, query, dev))
        phase_k11_fields(dev)
        bag4 = record_synthetic("box", 150, n_beams=360, seed=2)
        with tempfile.TemporaryDirectory() as tmp:
            map4 = os.path.join(tmp, "box_map.npz")
            keyframes = map_and_save(config4_configs()[0], bag4, map4, dev)
            timing.update(phase_pf_kernels(map4, bag4, dev))
            timing.update(phase_kb(map4, bag4, dev))
            kernel_times(dev, ident, map4, bag4)
            _, config2, sync_poses = phase_session(cfg, bag, dev)
            c2p_launches, c2p = phase_pipelined_config2(cfg, bag, dev,
                                                        config2, sync_poses)
            c8_launches = phase_config8(cfg, bag, dev, config2)
            district_launches, district_poses = phase_district_solve(
                truth, district, dev)
            launches, plain3 = phase_office(cfg3, bag3, dev)
            phase_pipelined_office(cfg3, bag3, dev, plain3)
            _, office = phase_office(office_recipe_config(), bag3, dev,
                                     "[4g]", plain3)
            timing.update(phase_lm(dev, office, ident))
            pf_launches, sync4 = phase_config4(map4, keyframes, dev)
            phase_pipelined_config4(map4, dev, sync4)
            phase_config7(os.path.join(tmp, "office_map.npz"), dev)
            cfg10, bag10 = config10()
            (k12_launches, k12_desc_launches, gather_ms, single10,
             pf_mesh_launches) = phase_mesh_nccl(cfg10, bag10, cfg6, bag3,
                                                 dev, tmp, sync4["digest"])
            mesh_district = phase_mesh_shared(cfg10, bag10, single10,
                                              district_poses, truth, map4,
                                              tmp, dev)
            kb_launches = phase_blocks(
                map4, os.path.join(tmp, "office_map.npz"), dev, tmp)
        c6_launches, c6_timing = phase_descriptor_session(
            cfg6, bag3, dev, "[4h]", "config 6")
        timing.update(c6_timing)
        phase_descriptor_session(office_config("--recipe", "drift"),
                                 drift_bag(), dev, "[4i]",
                                 f"drift recipe ({DRIFT_SCANS} scans)",
                                 need_far=True)
        merge_launches = phase_merge(dev)
        phase_config9(dev)
        corr_launches = phase_correlative(cfg, bag, dev)
        # The runtime surface: config 4's box map again (the one above
        # went with its directory).
        with tempfile.TemporaryDirectory() as tmp:
            map4 = os.path.join(tmp, "box_map.npz")
            map_and_save(config4_configs()[0], bag4, map4, dev)
            phase_resume(cfg, bag, dev, sync_poses, c2p["poses"], map4,
                         sync4["digest"], plain3["graph"], tmp)
            phase_control(cfg, bag, dev, tmp)
            phase_mesh_control(bag, tmp)
            phase_live(cfg, bag, dev, tmp)
            phase_trace_verbs(bag, plain3["graph"], dev, tmp)
        require("jax" not in sys.modules, "jax was imported")
    except SmokeFailure as e:
        print(f"FAIL: {e}")
        return 1
    # Launch counts from the config-3 session, which runs every kernel but
    # K4's PCG entries and the mesh's dense system (one device's dense
    # path launches dense_normal_system instead of normal_blocks and
    # dense_system), K3's particle launch and K9; the PCG solve's and the
    # fused PCG system's from the district solve, normal_blocks', the
    # standalone preconditioner's and the CG loop's forms from the
    # district solve by solve_multichip on the (1, 2) gloo mesh (rank 0;
    # the mesh's planned CG loop: the matvec plain and forming the
    # direction, the dot variants (A) and (B); the public fixed_dots,
    # which no path launches, 0), dense_system's from config 10 on the
    # one-rank NCCL mesh, the others' from the config-4 particle filter.
    for k in ("pcg_solve", "pcg_normal_system"):
        launches[k] = district_launches[k]
    for k in ("normal_blocks", "preconditioner"):
        launches[k] = mesh_district[(1, 2)][k]
    launches["dense_system"] = k12_launches["dense_system"]
    for k in CG_FORMS:
        launches[k] = mesh_district[(1, 2)][k]
    for k in ("pf_motion_score", "pf_resample", "pf_statistics"):
        launches[k] = pf_launches[k]
    # K9's own motion launch and K3's particle launch with the motion off
    # (0 on one device's step): config 4's filter on the one-rank mesh.
    for k in ("pf_motion", "score_points_batch"):
        launches[k] = pf_mesh_launches[k]
    # K7 and the G = 4 launches of K1/K2/K3 from the config-8 session.
    launches["newton"] = c8_launches["newton"]
    for k in ("ndt_build", "candidate_scores", "score_points"):
        launches[f"{k}_g4"] = c8_launches[k]
    # K6 and K10 from the config-6 session (K10's times and bounds at the
    # shape of that session's last descriptor pass; those at the
    # 2048-slot table are printed beside them); K6 at the merge's shape
    # from the merge.
    launches["candidate_gather"] = c6_launches["candidate_gather"]
    for k in DESCRIPTOR_KERNELS:
        launches[k] = c6_launches[k]
    launches["candidate_gather_merge"] = merge_launches["candidate_gather"]
    # K13's window append and K3's composed entry from the pipelined
    # config-2 session, K11 from the correlative box drive.
    for k in ("window_append", "score_points_compose"):
        launches[k] = c2p_launches[k]
    for k in ("correlative_field", "correlative_match", "correlative_score"):
        launches[k] = corr_launches[k]
    # K12 from the mesh sessions on the one-rank NCCL mesh: K2's split
    # search and the rank sum from config 10, K6's from config 6.
    for k in ("candidate_partials", "candidate_finalize", "rank_sum"):
        launches[k] = k12_launches[k]
    for k in ("candidate_gather_partials", "candidate_gather_finalize"):
        launches[k] = k12_desc_launches[k]
    # K12·blocks from [4r] and [4s] on the one-rank NCCL mesh (KB4 folded
    # into finalize_append); KB4's own launches from [4s] on one device.
    for k in KB_KERNELS + ("slam_append",):
        launches[k] = kb_launches[k]
    # K1/K2 times and errors at config-3 confirmation shapes (64 rows);
    # the config-2 single-window ones are printed at [3].
    for k in ("ndt_build", "candidate_scores"):
        timing[f"{k}_config2"] = timing[k]
        timing[k] = timing.pop(f"{k}_rows")
    rows = []
    for name, (src, replaces) in KERNELS.items():
        t = timing[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     **{k: v for k, v in t.items() if k != "graph_ms"}})
    for name, t in timing.items():
        lib = ("" if t["library_ms"] is None
               else f", library {t['library_ms']:.4f} ms")
        graph = ("" if t["graph_ms"] is None else
                 f", in a CUDA graph kernel {t['graph_ms'][0]:.5f} ms"
                 + ("" if t["graph_ms"][1] is None else
                    f", library {t['graph_ms'][1]:.5f} ms"))
        print(f"[5] {name}: kernel {t['ms']:.4f} ms, twin "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}){lib}{graph} ({ident})")
    print(ident)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
