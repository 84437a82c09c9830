"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases (each prints one line; any failure raises, so the script exits
non-zero and prints no result line):
  1. device  — requires CUDA; prints nvidia-smi's name and power limit
  2. build   — compiles come_tpu_torch/csrc/*.cu for sm_90a (nvcc); prints
               nvcc's release and whether the group loops launch under
               programmatic dependent launch (PDL: CUDA 12.3 or later)
  3. K1      — one BlogCatalog-shaped O1 macro step through the walk kernel
               and through its plain PyTorch version on clones
 3b. K1b     — the same inputs with mxu_bf16 (bf16 product operands)
  4. K2      — the same for one star O2 macro step (65536 slots)
 4b. K2b     — the same inputs with mxu_bf16
 4c. K4      — one BlogCatalog macro step of 256 walks generated in the
               kernel from starts, 32-bit draws and the CSR (L 80, W 10,
               KP 512); the walks must be the plain version's bit for bit
               and every hop an edge
 4d. K5      — one paired O2 macro step at blogcatalog shapes (512 rows of
               64 edges, 64 groups), f32
 4k. wide 256 — phases 3, 4 and 4d's K1, K2 and K5 steps (the main
               path's shapes at --dim 256: 256 walks in 32 groups, 65536
               star slots in 64 groups, 512 edge rows in 64 groups, KP 512)
               on tables 256 wide (past 192 the band and star passes hold
               whole rows where they fit), and K1 with the whole walk in
               its window (W 79);
               after phase 4e its K1b and K4 (bf16) bench steps (256
               groups, R 8) and its K2b step (344 groups, R 8); after phase
               4f K3 at its synthetic-10m step shape (128 groups, KP 2048,
               SR); after phase 7 K6 and K7 at phases 6 and 7's pairs (32
               tiles): each against its plain version under its mode's
               check, with ms from an idle card, ms a step in a run of 10,
               the plain version's ms and the bound (step_check)
 4e. bench shapes — K1b, K4 (bf16) and K2b at the shapes phases 12-13 give
               them: one 2048-walk O1 step (256 groups, R 8, unigram pools
               [32, 512]) and the one star O2 step of batch_edges 524288
               (the whole layout, 344 groups, R 8)
 4h. edges   — the walk kernel against its plain version at EDGE_SHAPES
               (W >= L - 1, L = 1, odd L with W past a strip, d 192 and 2,
               a heavily repeated row, KP 100 and 2048 with R 3; L = 1,
               odd L, the repeated row and KP 2048 again at d 256 and 300,
               the wide passes), in f32, bf16 products and on bf16 tables,
               each under its mode's check
 4i. star/f32 edges — the star kernel against its plain version, in f32 and
               bf16, at STAR_EDGES (a hub of degree 300 split at fan-out 32,
               a single fat hub filling a row, segments dropped to pads
               mid-row, d 192 and 2, KP 100 with R 3, a ragged last group;
               the hubs, pads, ragged group and KP 2048 with R 3 again at
               d 256 and 300, and the fat hub at 256, the wide passes),
               and K6 and K7 at FUSED_EDGES (KP 100 and 2048, d 192 and 2,
               tiles of 64 and 777 pairs, KP 2048 at d 300 and tiles of 64
               at d 520, each with one all-masked tile)
 4j. wide    — K1 (W 10 and a whole-walk window W 127), K5 and K2 on V
               2000 at the ragged and odd widths of WIDE_WIDTHS (129, 193,
               257, 300, 512; at 256 the whole-walk window only), and K1b,
               K3 (SR, V 20000), K4 in bf16 and in f32, K2b, K6 and K7 at
               193 (K3 194), 256, 257 (K3 258), 300 and 512 (wide_inputs;
               256 and 257 the negative passes' widest whole width and
               narrowest slabs), each under its mode's check, and timed as
               in 4k but for the whole walk and 257; then K1 at d 256 on
               walks of 128 at the band pass's route boundary: the last W
               whose f32 rows fit (whole), the next (slab) and the whole
               walk W 127 (slab); and the bf16 rows in column slabs
               (BF16_SLAB: K1b, K4 and K3 with the whole walk of 128 at d
               512 and 514, K2b at 884).  Here and in 4k, 5b, 5c, 15 (P3
               at 256) and 15b every walk and star step must take the band
               or star route (rows up to d 192, whole rows, column slabs)
               that the phase names, or else the one the kernel library's
               rule gives (come_walk_pos_route, come_star_pos_route), as
               the wrappers' routes counters read it from what each step's
               recording launched; the lines print the routes
 4l. passes 256 — the device µs a group by pass of tools/pass_times.py's
               K1, K1b bench, K2b bench, K6 (a tile) and K3 steps at d 256,
               beside the negative pass as three PyTorch products (the
               yardstick library3_ms)
  4f. K3     — the walk kernel on bf16 tables at the large-V path's shapes
               (synthetic-10m: V 500000, d 128, 1024 walks of 80, W 10, KP
               2048, R 1, 128 groups), with stochastic rounding and in
               truncation mode, through walk_sgns_step and walk_sgns_gen_step;
               K3 and K1 (f32 tables, same inputs) timed, and the device
               busy share of one K3 step (its kernels' device time over its
               CUDA-event time)
 4m. pool passes — the pool stage (stage_pool_kernel<float> at K1's shape,
               KP 512 d 128; <bf16> at K3's, KP 2048 d 128; ragged 130 and
               f32 256), the bf16 passes' stage past d 192
               (stage_pool_bf16_kernel: WIDE_STAGES, d 256 and 264, f32
               and bf16 tables, KP 512, 2048 and 2000, f32 at 300), K3's
               pool chains (pool_chains_kernel: a K3 step's 128 pools of
               2048, and one of 100), K3's pool write
               (apply_pool_bf16_kernel, KP 2048 at d 128, 256 and 130, SR
               and truncation), K3's slot chains (slot_chains_kernel:
               phase 4f's 128 groups) and K3's slot scatter
               (walk_scatter_bf16_kernel: one group at d 128, 256 and 130,
               SR and truncation, run twice), each alone through its C
               entry (ops/pool_pass.py, ops/scatter_pass.py) on a unigram
               pool over synthetic-10m and phase 4f's walks, and on a
               hub-heavy pool (16 rows drawn 2048 times: chains of about
               128) and hub-heavy groups (16 rows fill each: chains of
               about 40); and the f32 slot writes (F32_KINDS:
               walk_scatter_kernel alone and block_end_scatter_kernel with
               the block's pool write folded in, at d 128, 256 and 300, on
               phase 4f's first group with a unigram pool of 512, on a
               hub-heavy group whose pool of 2048 draws its hubs, and on
               phase 4h's hot row with a pool of 100 that draws it; each
               run twice and held against the plain version on a CPU
               copy; the fold chains, fold_chains_kernel, of each case's
               group and pool); and the star writes ("star writes", run
               after phase 4i: STAR_WRITE_KINDS, star_scatter_kernel alone
               and star_block_end_scatter_kernel with its pool write, at d
               128, 256 and 130, on phase 4's blogcatalog group with its
               pool of 512 and on a split-hub layout with pools of 100 and
               2048 that draw the hub over and over, each run twice
               against the plain version on a CPU copy; the star chains
               of each layout; the fold chains of phase 4's step at R 1
               and of the hub layout's at R 3; the hub layout's K2 step at
               R 3 under the f32 check), each held bit for bit against its
               plain version
               (ops/walk_sgns.py: pool_stage_reference,
               pool_apply_bf16_reference, walk_scatter_bf16_reference;
               ops/pool_pass.py: pool_chains_reference,
               pool_stage_wide_bf16_reference; ops/scatter_pass.py:
               slot_chains_reference); each case prints its device µs a
               call beside its bound, the plain version's and one PyTorch
               call's (index_select with the cast to the stage's dtype, a
               stable sort, index_add_)
 4g. P1      — the row-gather floor probe: gather and scatter-add of N =
               2048 and 262144 rows of a [500000, 128] f32 and bf16 table,
               beside index_select / index_add_
               (the K1, K1b bench and K3 lines also give the device
               microseconds per group of each pass of the walk group loop,
               by torch.profiler: band (walk_pos_kernel), negative
               (negative_f32_kernel or negative_bf16_kernel), scatter, stage
               (pool staging), pool apply (K3's), the f32 block-end
               scatter (its pool write folded in) and the once-a-step
               chains, and the K1 and K3 lines the
               device busy share of one step; the K2 and K2b bench lines
               those of the star group loop, star (star_pos_kernel) in the
               band's place, and the K6 and K7 lines those of a tile:
               positive, negative, scatter, stage and pool apply;
               come_tpu_torch/tools/pass_times.py)
  5. main    — come_tpu_torch.main on --dataset blogcatalog (pretrain 1,
               outer 1) on cuda, with the kernels' launch counters reset
               just before and read just after; the launch plans' graph
               counters too (ops/launch_plan.py: every plan, fresh at the
               phase's start, records once and then only replays:
               recordings = instantiations = plans used, no update)
 5b. main 256, paired 256 — the same CLI at --dim 256 (K1 and K2 with
               their wide passes, G1 with its matrices in device memory),
               then with --o2-mode paired (K1 and K5),
               each with its counters reset just before and read just
               after: finite losses and embeddings [V, 256], every edge
               trained twice in O2 (K2), NMI >= 0.8; prints G1's launches
               and the peak device memory
 5c. tiers 256 — the trainer at --dim 256 through every tier besides
               5b's, each at the cut and floor of its d-128 phase, its
               tiers named by ComETrainer.tier_kernels and its counters
               reset just before and read just after: the bench
               configuration with the walker (K1b, K2b) and with in-kernel
               walks (K4, K2b; phases 12-13's), the micro-batched path
               (--down-sample 1e-3 --o2-mode xla: K6, K7; phase 10's),
               karate with shared negatives (K6, K7 at V 34; phase 9's)
               and the blogcatalog preset on bf16 O1 tables (K3, K2;
               trainer/come.py's 48 MiB line set to 0, pretrain 1 + outer
               1, NMI >= 0.8); each launches its kernels and no other
  6. K6      — one BlogCatalog-width O1 micro-step (32768 window pairs of
               256 real walks, down_sample 1e-3 masks, KP 512, 32 tiles)
               through the fused SGNS kernel and its plain version; first
               six micro-steps at that shape through one fresh launch plan
               (fused_steps: lr, the pairs, the mask and the pool new at
               every step, the second tile all masked, the tables moved
               once), each held against its plain version, with two
               recordings (the instantiation, and one update when the
               tables moved) for six replays, and 40 micro-steps at that
               shape, 40 at karate's and 40 at that shape with tables 256
               wide (fused_stress: new pairs, mask and pool each call)
               enqueued back to back with no host wait, each held against
               its plain version (each run's worst step printed with the
               |upd| where it fell); a macro batch of 40 micro-steps as one
               scan (fused_scan_check: one WHILE-graph launch, the port of
               the JAX trainer's lax.scan) at the same three shapes, its
               final tables and summed (loss, n_pairs) against the loop of
               plain micro-steps under the same check; then, on tables it
               updates
               in place, ms from an idle card and ms a step in a run of 6,
               the host's ms to enqueue a step in a run of 6, the device µs
               a tile of each pass (positive, negative, scatter; stage and
               pool apply per tile too) and tools/pass_times.py's timeline:
               the gaps between the step's kernels and the covered share of
               its span (the micro-step is one replayed graph)
  7. K7      — the same on one tied table with 32768 arcs
  8. karate  — the CLI's default karate preset (per-pair negatives): no
               SGNS kernel may launch (G1 does, in the GMM fits)
  9. shared  — karate with shared negatives: O1 through K6, O2 through K7
 10. micro   — the micro-batched main path through the CLI: blogcatalog
               with --down-sample 1e-3 --o2-mode xla (walks per node 2,
               pretrain 0, outer 1): O1 through K6, O2 per arc through K7
               (phases 9 and 10 print the path: on one device every macro
               batch is one scan, and no K6/K7 micro-step is launched
               alone; and the graph counters: one recording a plan)
 11. paired  — the CLI on --dataset blogcatalog --o2-mode paired (pretrain
               1, outer 1): O1 through K1, O2 through K5, no K2
 11b. host   — ComETrainer on the blogcatalog preset with corpus="host"
               (pretrain 1, outer 1): walks from the C++ host walker on
               host threads, pinned and copied to the card batch by batch,
               O1 through K1, O2 through K2; the first host-fed K1 step and
               the first of the outer iteration held against the plain
               version, every batch the card trained held against the
               walker's sequence bit for bit; prints the O1 epoch beside
               phase 5's (the device walker), the feeder's queue wait and
               the batches trained
 11c. persist — the blogcatalog preset (pretrain 1, outer 2) with
               train(checkpoint_dir=...): a fresh trainer loads
               state_iter0.npz and runs iteration 1 beside the uninterrupted
               run's (prints each table's max |difference| and whether all
               are 0); the trained table through the word2vec writer and
               loader; node-classification F1 fitted on the card
 12. bench   — ComETrainer with the reference bench's kernel configuration
               (bench.py:174-191: walk_kernel_bf16, walk_pool_refresh 8,
               batch_walks 2048, batch_edges 524288; pretrain 1, outer 1)
               and the walker: K1b and K2b, nothing else (12, 13 and 5c's
               bench runs print the graph counters: one recording a plan)
 13. bench gen — the same with walk_gen "kernel" (bench.py:207-216): K4 in
               its bf16 mode and K2b, nothing else
 14. large-v — the CLI on --dataset synthetic-10m at full width, depth cut
               to walks per node 5, pretrain 1, outer 1 (bench.py:124-129's
               cut, walks per node 1, ended at NMI 0.001 on an H100 80GB
               HBM3 at 700 W both with bf16 and f32 tables: the communities
               emerge between 4 and 6 walk passes per node): O1 through
               K3, O2 through K2, nothing
               else; prints the peak device memory and the O1 epoch beside
               the full-depth reading in PERF.md section 5
After phase 14:
 15. probes  — P2 (tools/probe_smem.py: the shared-memory capacity search,
               which must stop at cudaDevAttrMaxSharedMemoryPerBlockOptin
               and be refused above it with cudaErrorInvalidValue), P3
               (tools/probe_star.py: the star kernel's sections at the
               BlogCatalog layout, µs per group by variant and unroll
               beside K2b's, the full variant held against K2b's plain
               version under the bf16 check and every variant against its
               plain version; then again with the table 256 wide, its MATH
               section through K2b's wide passes) and P4
               (tools/probe_star_floor.py: the seven per-group floors, each
               value exactly its plain version's)
 15b. graph  — the macro step as one replayed graph: six consecutive K1, K3
               and K2 steps through one plan each (graph_steps: lr, the SR
               seed, walks or star rows, window draws and pools new at
               every step, the tables moved to new addresses at every other
               step), each held against its plain version from the same
               tables under its mode's check, with one instantiation and
               a recording again (an update) only where the tables moved;
               prints
               the graph counters of each kernel, the K1, K2 and K3 steps
               of tools/pass_times.py (ms from an idle card, ms a step over
               10 in a row, the kernels' device time over the ms, the share
               of the step's span some kernel covers, the median gap
               between kernels, the host's ms to enqueue a step in a row,
               which for K3 must stay under 0.7 of the card's: no step
               waits for the card) and P4's bare and gather floors with their
               G launches recorded as one graph and replayed, beside the
               stream launches (tools/probe_star_floor.py::graph_floor);
               and eight steps of every walk and star mode (B2B_MODES: K1,
               K1b, K2, K2b, K3, K4 with its walk generation, K5) at d 128
               and again at d 256, enqueued back to back through
               one plan with no host wait, inputs new at every step, each
               held against its plain version from the tables the step
               before it left, under its mode's check, each mode's fresh
               plan recorded once, every step on its route (graph_stress)
 16. parity  — the parity CLI (evaluation/parity.py) on karate, 3
               iterations, on cuda: K1, K5, K2 and K7 rows against the
               numpy oracle; it must return 0
 17. profile — the karate CLI with shared negatives (K6/K7) under
               --profile-dir into a temporary directory: the trace must
               exist and name a K6 kernel
After phase 17:
 18. dp      — the data-parallel path (come_tpu_torch/parallel/): each run
               launches come_tpu_torch.tools.dp_check on N ranks through
               python -m torch.distributed.run (--standalone), and every
               rank trains the blogcatalog preset through --mesh N,1
               (pretrain 1 + outer 1) with its launch counters reset just
               before and read just after, times one more O1 epoch with
               CUDA events around each all-reduce, and prints one JSON line.
               Runs: (a) NCCL, world 1; (b) gloo, world 2, both ranks on
               cuda:0 (NCCL refuses two ranks on one card; gloo stages the
               card's tensors through the host, so (b)'s times measure
               correctness, not speed); (c) NCCL, world 2 on two cards, only
               where torch.cuda.device_count() >= 2.  Each run also holds
               one dp step of K1 (BlogCatalog shapes), K2 and K5 against
               before + sum_r (plain_r(before) - before) under the f32 check
               (tools/hot_row.py's float64 rule where it fails) and one K3
               step at the synthetic-10m shapes under ops/tolerance.py's K3
               check.  Every rank must reach NMI >= 0.8, launch K1 and K2
               and no other kernel, and hash its six parameter tensors to
               the same sha256 as every other rank, after the run and after
               the extra epoch.  The line gives the dp O1 epoch beside
               phase 5's, the all-reduce ms and bytes per step, the world
               size and the backend, the warm distributed and one-device
               GMM fits, and in (a) four O1 epochs each of the one-device
               and the dp trainer in turns on one table.  (a) and (b) run
               again at --dim 256 (every held step at that width), at
               WALKS_CUT (4) walks a node, a depth cut.
 19. rs      — the row-sharded path (model axis > 1: parallel/exchange.py,
               parallel/walk_exchange.py): each run launches
               come_tpu_torch.tools.rs_check on D x M ranks through python
               -m torch.distributed.run (--standalone), and every rank
               trains the blogcatalog preset at full width through --mesh
               D,M (pretrain 1 + outer 1; (a) and (b) at WALKS_CUT (4)
               walks a node, a depth cut) with its launch counters reset
               just before and read just after, then times one more O1 and
               O2 epoch with CUDA events around each all-to-all and
               all-reduce.  Runs: (a) gloo, world 2, mesh (1, 2) and (b)
               gloo, world 4, mesh (2, 2), every rank on cuda:0 (NCCL
               refuses two ranks on one card; gloo has no CUDA all-to-all,
               so the exchange stages the card's buffers through pinned
               host memory, named "gloo-host": (a)'s and (b)'s times
               measure correctness, not speed); (c) NCCL at (1, 2) where
               torch.cuda.device_count() >= 2 and at (2, 2) where >= 4.
               Every rank must name the O1 and O2 tiers
               walk-kernel-rowsharded and walk-kernel-paired-rowsharded,
               launch K1 and K5 and no other kernel, serve >= 0.999 of its
               rows in O1 and O2, reach NMI >= 0.8, use the transport its
               backend names, and hash its model shard (and the replicated
               tensors) to the same sha256 as every rank of its model
               index, and (as every rank of 18) instantiate the walk
               kernel's graph at most once per shape it stepped.  Each rank holds one row-sharded K1 step and one K5
               step (the rows planned and gathered through the exchange,
               the kernel on the compact tables, its plain version on
               clones of the same compact rows) under the f32 check below,
               tools/hot_row.py's float64 rule where it fails, and both
               again on rows 256 wide (the wide passes); (a) also one
               K1 step at the synthetic-10m shapes (V 500000 over M 2, 1024
               walks, KP 2048: 172032 compact rows a worker) with its
               compact-table and exchange bytes.  The line gives per step
               the all-to-all bytes and ms and the all-reduce bytes and
               ms, the O1 epoch beside phase 5's, the served fractions, the
               NMI and the transport.  (a), without its synthetic-10m step,
               and (b) run again at --dim 256.
After phase 19:
 20. eval    — the quality sweep (come_tpu_torch/tools/eval_sweep.py):
               run_one for karate and heavy-tail-dcsbm at their full presets
               with the F1 train-ratio sweep, each with the launch counters
               reset just before and read just after: karate (per-pair) may
               launch no kernel, heavy-tail K1 and K2 and nothing else, and
               the row's own kernels field must agree.  Floors: the JAX
               artifact's (tests/test_eval_regression.py:24-33: karate NMI
               0.60 and macro-F1 0.85, heavy-tail 0.90 and 0.95), karate's
               NMI by the port's bar of 0.5 (PERF.md §2) where it misses
               0.60 inside the seed band; the line says which bar held.
               Then exact t-SNE (evaluation/tsne.py) of the heavy-tail
               embeddings on the card: every KL reading finite, the KL at
               1000 iterations below the first reading after exaggeration
               ends (300) at the last (1000 unless a stage stopped early on
               sklearn's rules), and the 10-neighbour trustworthiness of the map
               at least that of the PCA map of the same embeddings.  The
               line gives each row's seconds, the t-SNE seconds and the
               card's name and power limit.
 21. first iter — tools/first_iter.py on blogcatalog (pretrain 2 + outer 2)
               in a fresh process: each outer iteration's GMM fit by part
               (k-means, the EM loop and its iterations, the loop's
               recording, the eager factor calls, the final E-step, the
               inverse), O1, O2 (the star layout's build, the first K2
               step, the others), O3 and NMI; NMI >= 0.8.  Then G1
               (csrc/gmm_factor.cu) against its plain version
               (torch.linalg.cholesky_ex, torch.cholesky_inverse) at
               blogcatalog's moments (phase 5's table, n_init 2, K 39, d
               128) and on a near-singular batch (78 covariances of 64
               points in 128 dimensions): the largest relative Frobenius
               error of L and of inv_cov within 1e-4, or no farther from
               the float64 plain version than the f32 plain version is,
               and equal info flags; the same at synthetic-10m's [1, 64,
               128, 128] and flickr's [1, 195, 128, 128] shapes, at
               blogcatalog's dim 256 ([2, 39, 256, 256] on g1_moments and
               on phase 5b's table) and at d in G1_WIDTHS (panels of 16
               whole and ragged; past 128 the matrices in device memory)
               on g1_moments; a
               non-positive pivot placed at the first, middle and last
               column of every panel (g1_pivot_batch) flagged exactly as
               torch.linalg.cholesky_ex flags it; the device time per call
               of G1 and of its plain versions and library calls (20 calls
               back to back behind a sleep, tools/g1_times.py) at the four
               shapes, beside one call's time from an idle card (which
               includes the host's enqueue); the EM as one WHILE-graph launch
               against the eager EM, both with G1, from the same k-means
               responsibilities: the same iterations per restart and the
               same bits, through a fresh plan and again on a moved table
               (one instantiation); the EM with G1 against the EM with
               torch.linalg's factor and inverse: log-likelihood within
               1e-4 relative, NMI of the two partitions >= 0.99.
The pool passes inside the walk and star steps count on
ops/walk_sgns.py's POOL_LAUNCHES (the step wrappers add, at every
replay, the launches that the C group loop counted as it recorded the
step: come_step_graph_pool; each step wrapper also keeps its own in
.pools): phase 5 must launch the f32 stage, and its walk steps the pool,
slot and fold chains and block_end_scatter_kernel and no apply_pool_kernel
(the star steps' pool write), as must 5b's; the bench runs of 12-13 and
5c the chains, walk_scatter_kernel and block_end_scatter_kernel (R 8),
and none of them apply_pool_kernel from a walk step; every star step of
phases 4, 4b, 4e, 4i, 5, 5b and 12-13 its pool, star and fold chains once a
step, star_block_end_scatter_kernel once a block (at R 8 star_scatter_kernel
for the other groups) and no apply_pool_kernel; phase 14 K3's stage,
pool write, pool chains, slot chains and slot scatter, 5c's K3 run its
pool write, slot chains, slot scatter and the bf16 stage past d 192, 5c's
bench runs that stage (and 12-13's at d 128 none of it).
Phases 5, 5b, 5c, 8-14 (11b and 11c too), 15-17, 20 and every rank of 18 and 19 each reset
every launch counter just before they run and read them just after; each wrapper counts only its own launches, by
mode; every phase that fits a GMM on the card must launch G1's two
kernels (gmm_factor, gmm_inverse), the probes and parity neither (inside
the EM's WHILE graph a launch is counted by its plan: the factor calls
its body recorded, times the iterations the device ran).  Every
phase line ends with its seconds.  Then a JSON line of the
kernels (K1's launches from phases 5 and 11b; the bf16 modes with their
bench-shape checks and their launches in phases 12-13; K3's launches from phase 14; the pool stage's
from phase 5 (f32) and 14 (bf16) and the pool write's from 14 (d 256:
5c), the chains' from 14, K3's slot chains' and slot scatter's from 14
(the scatter at d 256: 5c), the bf16 stage past d 192's from 5c, the f32
block-end scatter's from 5 (d 256: 5b) and the f32 scatter's from 12 (d
256: 5c), their
errors and times from phase 4m (device time a call); P1's from its own phase, as it
is a probe and on no path; G1's ms, plain_ms and library_ms the device
time per call of phase 21, the others one call from an idle card; the
entries ending "_d256" the kernels at dim 256: launches from phases 5b
and 5c (P3's from its d-256 run in phase 15), errors and times from phase
4k (ms in place, from an idle card; P3's from phase 15) and phase 21),
each
with its bound: the larger of the bytes
it must move (each touched row and each input read once, each output
written once) over 3.35 TB/s and the operations its inputs need over 67
TFLOP/s (f32 products) or 989 TFLOP/s (bf16 products; the H100 SXM's
published peaks); and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Tolerance of the kernel checks, on each table element's update (table after
the step minus before): |upd_kernel - upd_plain| <= 1e-6 + 1e-4 |upd_plain|
(f32; atomic merges, whose order varies from run to run, move an update by
~1e-7; a TF32 or bf16 negative pass moves it by 1e-5 to 1e-4 and fails),
loss within rtol 1e-4, pair counts exact; phase 4h's hot-row shape takes
the same check against its plain step in float64 (EDGE_SHAPES' note).  K4 and K5 in f32 take this tolerance.  The bf16 modes take their
own (come_tpu_torch/ops/tolerance.py, where its readings are): a product of
two bf16 values is exact in f32, so the kernel and its plain version differ
only in the order of their f32 sums; where two orders straddle a rounding
boundary a rounded g flips by one bf16 ulp, and flips compound over a
step's groups.  So the relative L2 error of the updates must be <= 4e-4,
every element within 2^-8 of the largest plain update, and the f32 plain
step must lie at least 5x farther from the bf16 plain step than the kernel
does and 2x past the bound, so the check tells a bf16 pass from an f32 one.
Each bf16 line prints the error, the bound and that distance.  Phase 5 must
give finite losses and embeddings, train every edge twice in O2, and reach
NMI >= 0.8; phase 8 NMI >= 0.5 and phase 9 NMI >= 0.3 (the JAX package's
own karate floors); phase 10 finite losses and embeddings and exactly S * B
O2 pairs (S = ceil(2E / batch_edges) batches of B arcs); phase 11 finite
losses, exactly 2 * S * B_r * 64 O2 pairs and NMI >= 0.8; phase 11b one K1
launch per host batch, 2 * ceil(V * 10 / 256) of them, every batch the
walker's, its two held K1 steps under the f32 check and NMI >= 0.8; phase
11c one checkpoint per outer iteration, words_seen and both generators
equal to the saving trainer's right after the load, words_seen equal after
the resumed iteration, NMI >= 0.8, every value of the word2vec text within
5e-7 of the table (six decimals, correctly rounded; the f32 values read
back add up to half an f32 ulp, which is printed) and read back exactly,
and macro-F1 >= 0.99 at train ratio 0.5 (the JAX reference 0.9998,
EVAL_r05.json); phases 12-13 finite losses and NMI >= 0.8.  K3 takes ops/tolerance.py's K3 check (99%
of touched elements bit-identical, relative L2 error of the updates within
its bound, the f32-table step 5x farther away), loss within rtol 1e-4 and
pair counts exact; P1 the plain version's rows and tables bit for bit and
its checksum to 1e-12.  Phase 14 must give finite losses, one K3 launch
per O1 macro step with a pair count inside what those steps can train,
and NMI >= 0.8.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

RTOL, ATOL = 1e-4, 1e-6  # on the update of each table element
SEED = 0
# the H100 SXM's published peaks (at its 700 W limit): device memory,
# f32 outside the tensor cores, dense bf16
HBM_BPS, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
# NMI after pretrain 1 + outer 1 on the blogcatalog stand-in: 0.9422 on an
# H100 at SEED; the full preset reaches 0.96 (the JAX reference 0.954)
NMI_FLOOR = 0.8
# node-classification macro-F1 at train ratio 0.5 on the blogcatalog
# stand-in: the JAX reference read 0.9998 (EVAL_r05.json)
F1_FLOOR = 0.99
# a decimal with six places parsed to float64 is off by up to half an ulp
# of |x| < 2^4: 1e-15; the check allows 1e-12 over 5e-7
TEXT_SLACK = 1e-12
# karate floors of the JAX package's tests (tests/test_trainer_e2e.py:37,
# tests/test_pallas_trainer.py:27)
KARATE_NMI_FLOOR, KARATE_SHARED_NMI_FLOOR = 0.5, 0.3
# walks a node of phase 19's runs and phase 18's past d 128 (the preset's
# 10): a depth cut that keeps the script in its time, checks unchanged (at
# 4 their NMI read 0.85-0.97 on an H100 80GB HBM3 at 700 W; at 3 a run
# read 0.78, under the floor)
WALKS_CUT = 4


# Phase 4h's shapes (V, d, B, L, W, KP, R, hot): the whole walk in the band
# (W >= L - 1), one slot per walk, an odd L with W wider than a strip, d at
# its bound 192 and at 2, walks that repeat one row heavily, ragged and
# large pools (KP 100 and 2048, R 3); the last four again past MAX_DIM
# (192), where the band pass holds whole rows (a ragged 16-byte piece at
# 300) and the negative pass slabs past 256, at 256 and at 300, and
# beside the negative passes' route edge (256) at even widths that take
# their 4-byte copies: 254 (held whole; KP 100, R 3) and
# 258 (in slabs; the hot row, KP 2048 with R 3).  On bf16 tables V is at least 20000:
# K3's check was set on steps whose walks repeat few rows (ops/tolerance.py),
# and the hot row's shape, which the emulation of K3's former any-order
# writes failed (0.52 of touched elements identical), runs in f32 and bf16
# only; K3's slot writes now take a row's repeats in slot order, held bit
# for bit on hub-heavy groups in phase 4m.
# In f32 the hot row's step is held against the plain version run in
# float64 (acc): the plain f32 step's own rounding there reaches 0.91 of
# the f32 bound (worst of 5 runs on an H100), so two f32 steps that round
# in different orders fail it in a share of runs; the kernel, whose scatter
# sums a row's slots in f64, reads 0.18 of it against the float64 step.
EDGE_SHAPES = [
    (3000, 128, 16, 128, 127, 64, 1, False),
    (500, 64, 16, 1, 3, 16, 1, False),
    (2000, 128, 24, 37, 13, 100, 3, False),
    (2000, 192, 16, 80, 10, 128, 1, False),
    (2000, 2, 16, 20, 3, 64, 1, False),
    (2000, 128, 16, 80, 10, 512, 1, True),
    (20000, 128, 24, 80, 10, 2048, 3, False),
    (500, 256, 16, 1, 3, 16, 1, False),
    (2000, 300, 24, 37, 13, 100, 3, False),
    (2000, 300, 16, 80, 10, 512, 1, True),
    (20000, 256, 24, 80, 10, 2048, 3, False),
    (2000, 254, 24, 37, 13, 100, 3, False),
    (2000, 258, 16, 80, 10, 512, 1, True),
    (20000, 258, 24, 80, 10, 2048, 3, False),
]

# Phase 4i's star layouts (V, d, E, KP, R, layout): see star_edge_layout;
# d at its bound 192 and at 2, a ragged and a small pool (KP 100, R 3);
# past MAX_DIM (the wide star pass) the hub, the fat hub (at 300 and at
# 256: strip 0 owns a whole row, the pass's widest CTA), pads mid-row, a
# ragged last group and KP 2048 with R 3; at the negative passes' route
# edges pads mid-row (slots with nt = 0) at 257 and KP 100 with R 3 at 255.
STAR_EDGES = [
    (3000, 128, 20000, 512, 1, "hub"),
    (400, 128, 150, 64, 1, "fat"),
    (3000, 128, 20000, 512, 1, "pads"),
    (2000, 192, 12000, 128, 1, "random"),
    (2000, 2, 12000, 64, 1, "random"),
    (2000, 128, 12000, 100, 3, "random"),
    (2000, 128, 9000, 512, 2, "ragged"),
    (3000, 256, 20000, 512, 1, "hub"),
    (400, 300, 150, 64, 1, "fat"),
    (400, 256, 150, 64, 1, "fat"),
    (3000, 300, 20000, 512, 1, "pads"),
    (2000, 300, 9000, 512, 2, "ragged"),
    (2000, 256, 12000, 2048, 3, "random"),
    (3000, 257, 20000, 512, 1, "pads"),
    (2000, 255, 12000, 100, 3, "random"),
]



# Phase 4i's K6/K7 shapes (V, d, P, TP, KP): pools of 100 and 2048 rows, d
# 192 and 2, tiles of 64 and 777 pairs; past MAX_DIM (the wide negative
# pass) KP 2048 at 300 (a ragged slab, 16 pool splits) and tiles of 64 at
# 520 (past 256 the positive pass loops over a lane's columns), and at the
# negative pass's route edges tiles of 64 with KP 100 at 255 and KP 2048 at
# 257; the second tile is all masked.
FUSED_EDGES = [
    (2000, 128, 3000, 64, 100),
    (2000, 128, 3000, 777, 2048),
    (2000, 192, 3000, 777, 512),
    (2000, 2, 3000, 64, 100),
    (2000, 300, 3000, 777, 2048),
    (2000, 520, 3000, 64, 100),
    (2000, 255, 3000, 64, 100),
    (2000, 257, 3000, 777, 2048),
]


# Phase 4m's cases (pool_phase): the pool stage at K1's shape (f32, KP 512,
# d 128), K3's (bf16, KP 2048, d 128) and ragged widths (130: one element a
# piece; f32 at 256: two pieces a lane), and K3's pool write at d 128 and
# 256 and a ragged 130 (a bf16 pair a piece), with SR and in truncation
# mode; each on a unigram pool over synthetic-10m and on a hub-heavy one
# (POOL_HUBS rows drawn KP times: chains of about KP / 16).
POOL_STAGES = ((torch.float32, 512, 128), (torch.bfloat16, 2048, 128),
               (torch.float32, 512, 130), (torch.bfloat16, 2048, 130),
               (torch.float32, 512, 256))
POOL_APPLIES = ((2048, 128), (2048, 256), (2048, 130))
# (pools, KP) of the chains: a K3 step's, and one small pool
POOL_CHAINS = ((128, 2048), (1, 100))
POOL_SEEDS = (12345, None)  # SR, truncation
POOL_KINDS = ("unigram", "hub")
POOL_HUBS = 16
# Phase 4m's K3 slot cases and the wide bf16 stage (pool_phase): K3's slot
# scatter at d 128, 256 and a ragged 130 (a bf16 pair a piece), with each
# of POOL_SEEDS, on one group of phase 4f's synthetic-10m walks (L 80; the
# "unigram" line) and on a hub-heavy group (every slot one of POOL_HUBS
# rows: chains of about 40; the "hub" line); the slot chains of phase 4f's
# step (128 groups) and of hub-heavy groups; the bf16 passes' stage past d
# 192 at d 256 and 264 (two slabs) on f32 tables at KP 512 (K1b's and
# K2b's bench steps) and bf16 ones at 2048 (K3's), at a KP that is not a
# whole number of NEG_KC chunks (2000) and at a ragged f32 width (300: one
# element at a time).
SCATTER_WIDTHS = (128, 256, 130)
WIDE_STAGES = ((torch.float32, 512, 256), (torch.bfloat16, 2048, 256),
               (torch.float32, 512, 264), (torch.bfloat16, 2048, 264),
               (torch.bfloat16, 2000, 256), (torch.float32, 100, 300))


# Phase 4m's f32 slot cases (f32_phase): the f32 scatter alone and the
# block end's with its pool write folded in, at d 128, 256 and 300 (a
# float4 a lane, two, and 75 over a warp), on one group of phase 4f's
# walks with a unigram pool of K1's KP 512 ("unigram"), on a hub-heavy
# group whose pool of 2048 draws its hubs and a few other rows over and
# over ("hub": rows in both the slots and the pool; chains of about 40
# slots and 100 draws), and on phase 4h's hot row (every other slot row
# 7, V 2000) with a ragged pool of 100 that draws row 7 and nine others
# ("hot").
F32_SCATTER_WIDTHS = (128, 256, 300)
F32_KINDS = (("unigram", 512), ("hub", 2048), ("hot", 100))


# Phase 4m's star cases (star_phase): the star chains over a whole layout,
# the star scatter alone and the star block end with its pool write folded
# in, at d 128, 256 and 130 (a float4 a lane, two, and one element a lane:
# d not a multiple of 4), on the first group of phase 4's blogcatalog star
# step with its uniform pool of K2's KP 512 ("blog"), and on the first
# group of a "hub" layout (star_edge_layout: node 0 of degree 300 split
# into segments over several rows of a group) with pools of KP 100 and
# 2048 that draw the hub and a few of the group's rows over and over
# ("hub"); the fold chains of the hub layout's step with those pools at R
# 3 (a last block of fewer groups), and that whole step, K2 at R 3, against
# its plain step under the f32 check where the plain step meets that check
# against its float64 run, else against the float64 step within twice the
# plain f32 steps' own distance from it (conditioned_compare).
STAR_WRITE_WIDTHS = (128, 256, 130)
STAR_WRITE_KINDS = (("blog", 512), ("hub", 100), ("hub", 2048))
STAR_WRITE_R = 3


def pool_draws(kind, KP, V, alias, gen, dev):
    """An int32 [KP] pool over V rows: unigram draws from the alias tables
    ``alias`` (accept, alias), or "hub": POOL_HUBS distinct rows drawn KP
    times."""
    from come_tpu_torch.sampling import sample_alias

    if kind == "hub":
        rows = torch.randperm(V, generator=gen, device=dev)[:POOL_HUBS]
        pick = torch.randint(0, POOL_HUBS, (KP,), generator=gen, device=dev)
        return rows[pick].to(torch.int32)
    return sample_alias(*alias, gen, (KP,))


def _held(name, views, run, plain_run, lib, nbytes, chain, rows, timed):
    """One phase 4m case: raises unless every element of each (kernel,
    plain) pair in ``views`` is identical; returns the longest chain, the
    distinct rows and, when ``timed``, the kernel's device µs a call
    (tools/g1_times.py's device_ms: 50 calls back to back behind a sleep
    that outlasts their enqueue, between CUDA events), the plain version's
    (CUDA events), one PyTorch call's (``lib``, timed as the kernel) and
    the bound of ``nbytes``."""
    from come_tpu_torch.tools.g1_times import Sleeper, device_ms
    from come_tpu_torch.tools.pass_times import cuda_ms

    torch.cuda.synchronize()
    same = [float((a == b).float().mean()) for a, b in views]
    if min(same) != 1.0:
        raise AssertionError(f"{name}: {min(same):.6f} of the elements "
                             f"equal the plain version's")
    out = dict(name=name, identical=min(same), err=0.0, chain=int(chain),
               rows=int(rows))
    if timed:
        sleep = Sleeper()
        out["us"] = device_ms(lambda: run(0), sleep)["ms"] * 1e3
        out["plain_us"] = cuda_ms(plain_run) * 1e3
        out["lib_us"] = device_ms(lambda: lib(0), sleep)["ms"] * 1e3
        out["bound"] = bound(0.0, float(nbytes), False)
    return out


def pool_check(dev, which, dtype, KP, d, pool, V, gen, sr_seed=None,
               timed=True) -> dict:
    """The pool stage ("stage", a [V, d] table of ``dtype``), the bf16
    passes' stage past d 192 ("wide", the same table), K3's pool chains
    ("chains": ``pool`` [n, KP], d unused) or K3's pool write ("apply",
    bf16, lr 0.025, dneg ~ N(0, 1), block end group 5, SR from ``sr_seed``
    or truncation) on ``pool`` through its C entry (ops/pool_pass.py)
    against its plain version on the same inputs, bit for bit (_held).
    The PyTorch call beside it: the stage, index_select of the pool rows,
    cast to the dtype the stage writes (f32, or bf16 for "wide"); the
    chains, a stable sort of each pool; the write, index_add_ of dneg * -lr
    rounded to bf16.  The bound: each input read once (the ids, the
    distinct rows, dneg), each output written once."""
    from come_tpu_torch.ops.pool_pass import (
        pool_apply_bf16,
        pool_chains,
        pool_chains_reference,
        pool_stage,
        pool_stage_wide_bf16,
        pool_stage_wide_bf16_reference,
        wide_row,
    )
    from come_tpu_torch.ops.walk_sgns import (
        pool_apply_bf16_reference,
        pool_sr_bits,
        pool_stage_reference,
    )

    table = (torch.randn((V, d), generator=gen, device=dev) * 0.1).to(dtype) \
        if which != "chains" else None
    p64 = pool.long()
    uniq, reps = torch.unique(p64, return_counts=True)
    if which == "chains":
        kern = pool_chains(pool)
        plain = pool_chains_reference(pool)
        views = list(zip(kern, plain))
        run = lambda i: pool_chains(pool)  # noqa: E731
        plain_run = lambda: pool_chains_reference(pool)  # noqa: E731
        lib = lambda i: torch.sort(p64, dim=1, stable=True)  # noqa: E731
        nbytes = 4 * pool.numel() + 12 * pool.numel()
        reps = torch.stack([torch.unique(q, return_counts=True)[1].max()
                            for q in p64])
    elif which in ("stage", "wide"):
        es = table.element_size()
        fn, ref = (pool_stage, pool_stage_reference) if which == "stage" \
            else (pool_stage_wide_bf16, pool_stage_wide_bf16_reference)
        kern = fn(table, pool)
        plain = ref(table, p64)
        views = [(a.view(torch.int16 if a.dtype == torch.bfloat16 else
                         torch.int32),
                  b.view(torch.int16 if b.dtype == torch.bfloat16 else
                         torch.int32)) for a, b in zip(kern, plain)]
        run = lambda i: fn(table, pool)  # noqa: E731
        plain_run = lambda: ref(table, p64)  # noqa: E731
        cast = torch.float32 if which == "stage" else torch.bfloat16
        lib = (lambda i: table.index_select(0, p64)) if dtype == cast else \
            (lambda i: table.index_select(0, p64).to(cast))
        out_b = KP * d * 4 if which == "stage" else KP * wide_row(d) * 2
        nbytes = KP * 4 + uniq.numel() * d * es + out_b + KP * d * 4
    else:
        lr, g = 0.025, 5
        dneg = torch.randn((KP, d), generator=gen, device=dev)
        rnd = pool_sr_bits(sr_seed, g, KP, d, dev)
        kern = pool_apply_bf16(table.clone(), pool, dneg, lr, group=g,
                               sr_seed=sr_seed)
        plain = pool_apply_bf16_reference(table.clone(), p64, dneg, lr, rnd)
        views = [(kern.view(torch.int16), plain.view(torch.int16))]
        chains = pool_chains(pool)
        run = lambda i: pool_apply_bf16(  # noqa: E731
            table, pool, dneg, lr, group=g, sr_seed=sr_seed, chains=chains)
        tab_p = table.clone()
        plain_run = lambda: pool_apply_bf16_reference(  # noqa: E731
            tab_p, p64, dneg, lr, rnd)
        upd = (dneg * -lr).to(torch.bfloat16)
        lib = lambda i: table.index_add_(0, p64, upd)  # noqa: E731
        nbytes = KP * 4 + KP * d * 4 + 2 * uniq.numel() * d * 2
    name = (f"pool chains {pool.shape[0]} x KP {KP}" if which == "chains"
            else f"pool {which} {str(dtype)[6:]} KP {KP} d {d}"
            + ("" if which in ("stage", "wide") else
               f" {'SR' if sr_seed is not None else 'truncation'}"))
    return _held(name, views, run, plain_run, lib, nbytes, reps.max(),
                 uniq.numel(), timed)


def slot_check(dev, which, d, slots, L, V, gen, sr_seed=None,
               timed=True) -> dict:
    """K3's slot chains ("chains": ``slots`` int32 [G * 1024], d unused) or
    K3's slot scatter of one group ("scatter": ``slots`` [1024], bf16
    [V, d] tables, dphi, dphin, dctx ~ N(0, 1), lr 0.025, group 5, SR from
    ``sr_seed`` or truncation; the kernel run twice on fresh copies, which
    must give the same bits) through its C entry (ops/scatter_pass.py)
    against its plain version on the same inputs, bit for bit (_held).  The
    PyTorch call beside it: the chains, a stable sort of each group's
    slots (padding last); the scatter, index_add_ of the real slots'
    updates rounded to bf16 into each table.  The bound: each input read
    once (the slots, the chains, the real slots' updates, the distinct
    rows), each output written once."""
    from come_tpu_torch.ops.scatter_pass import (
        slot_chains,
        slot_chains_reference,
        walk_scatter_bf16,
    )
    from come_tpu_torch.ops.walk_sgns import (
        LP,
        NWL,
        walk_scatter_bf16_reference,
    )

    real = (torch.arange(slots.numel(), device=dev) % LP) < L
    ids = slots.long()[real]
    uniq, reps = torch.unique(ids, return_counts=True)
    if which == "chains":
        G = slots.numel() // NWL
        kern = slot_chains(slots, L)
        plain = slot_chains_reference(slots, L)
        views = list(zip(kern, plain))
        run = lambda i: slot_chains(slots, L)  # noqa: E731
        plain_run = lambda: slot_chains_reference(slots, L)  # noqa: E731
        keys = torch.where(real, slots.long(), 1 << 40).view(G, NWL)
        lib = lambda i: torch.sort(keys, dim=1, stable=True)  # noqa: E731
        nbytes = 4 * slots.numel() + 12 * slots.numel()
        reps = torch.stack([torch.unique(q[q < (1 << 40)],
                                         return_counts=True)[1].max()
                            for q in keys])
        name = f"slot chains {G} groups L {L}"
    else:
        lr, g = 0.025, 5
        tabs = [(torch.randn((V, d), generator=gen, device=dev) * 0.1).to(
            torch.bfloat16) for _ in range(2)]
        dphi, dphin, dctx = (torch.randn((NWL, d), generator=gen, device=dev)
                             for _ in range(3))
        args = (slots, dphi, dphin, dctx, lr)
        kw = dict(L=L, group=g, sr_seed=sr_seed)
        kern = walk_scatter_bf16(*[t.clone() for t in tabs], *args, **kw)
        again = walk_scatter_bf16(*[t.clone() for t in tabs], *args, **kw)
        plain = walk_scatter_bf16_reference(
            *[t.clone() for t in tabs], slots, dphi, dctx, lr, L, g, sr_seed,
            dphin=dphin)
        views = [(a.view(torch.int16), b.view(torch.int16))
                 for a, b in zip(kern + kern, plain + again)]
        chains = slot_chains(slots, L)
        run = lambda i: walk_scatter_bf16(  # noqa: E731
            *tabs, *args, chains=chains, **kw)
        tab_p = [t.clone() for t in tabs]
        plain_run = lambda: walk_scatter_bf16_reference(  # noqa: E731
            *tab_p, slots, dphi, dctx, lr, L, g, sr_seed, dphin=dphin)
        ups = [((dphi + dphin)[real] * -lr).to(torch.bfloat16),
               (dctx[real] * -lr).to(torch.bfloat16)]

        def lib(i):
            for t, u in zip(tabs, ups):
                t.index_add_(0, ids, u)

        n = int(real.sum())
        nbytes = NWL * 4 + 12 * n + 3 * n * d * 4 + 2 * 2 * uniq.numel() * \
            d * 2
        name = (f"slot scatter bf16 L {L} d {d} "
                f"{'SR' if sr_seed is not None else 'truncation'}")
    return _held(name, views, run, plain_run, lib, nbytes, reps.max(),
                 uniq.numel(), timed)


def f32_scatter_check(dev, d, slots, L, V, gen, pool=None,
                      timed=True) -> dict:
    """The f32 slot writes of one group (walk_scatter_kernel; with ``pool``
    int32 [KP], the block end's with the pool write folded in,
    block_end_scatter_kernel) through their C entry (ops/scatter_pass.py)
    on ``slots`` int32 [1024], f32 [V, d] tables, dphi, dphin, dctx (and
    dneg) ~ N(0, 1), lr 0.025; run twice on fresh copies of the tables,
    and both runs held bit for bit against the plain version run on a CPU
    copy of the same inputs (_held).  The PyTorch calls beside it:
    index_add_ of the real slots' updates into each table, and of the
    pool's into the ctx table.  The bound: each input read once (the
    slots, the chains, the real slots' updates, dneg, the pool's ids and
    the fold chains, the distinct rows), each output written once."""
    from come_tpu_torch.ops.pool_pass import pool_chains
    from come_tpu_torch.ops.scatter_pass import (
        fold_chains,
        slot_chains,
        walk_scatter_f32,
    )
    from come_tpu_torch.ops.walk_sgns import (
        LP,
        NWL,
        walk_scatter_f32_reference,
    )

    lr = 0.025
    real = (torch.arange(NWL, device=dev) % LP) < L
    ids = slots.long()[real]
    tabs = [torch.randn((V, d), generator=gen, device=dev) * 0.1
            for _ in range(2)]
    dphi, dphin, dctx = (torch.randn((NWL, d), generator=gen, device=dev)
                         for _ in range(3))
    KP = 0 if pool is None else pool.numel()
    dneg = None if pool is None else torch.randn((KP, d), generator=gen,
                                                 device=dev)
    kw = dict(L=L, pool=pool, dneg=dneg)
    args = (slots, dphi, dphin, dctx, lr)
    kern = walk_scatter_f32(*[t.clone() for t in tabs], *args, **kw)
    again = walk_scatter_f32(*[t.clone() for t in tabs], *args, **kw)
    cpu = [x.cpu() if x is not None else None
           for x in (*tabs, slots, dphi, dphin, dctx, pool, dneg)]
    plain = walk_scatter_f32_reference(
        cpu[0], cpu[1], cpu[2], cpu[3], cpu[5], lr, L, dphin=cpu[4],
        pool=cpu[6], dneg=cpu[7])
    views = [(a.cpu().view(torch.int32), b.view(torch.int32))
             for a, b in zip(kern + again, plain + plain)]
    chains = slot_chains(slots, L)
    pch = None if pool is None else pool_chains(pool)
    fold = None if pool is None else fold_chains(
        slots, L, pool, chains=chains, pool_chains_of=pch)
    run = lambda i: walk_scatter_f32(  # noqa: E731
        *tabs, *args, chains=chains, pool_chains_of=pch, fold=fold, **kw)
    tab_p = [t.clone() for t in tabs]
    plain_run = lambda: walk_scatter_f32_reference(  # noqa: E731
        *tab_p, slots, dphi, dctx, lr, L, dphin=dphin, pool=pool, dneg=dneg)
    ups = [(dphi + dphin)[real] * -lr, dctx[real] * -lr]
    p64 = None if pool is None else pool.long()
    up_p = None if pool is None else dneg * -lr

    def lib(i):
        for t, u in zip(tabs, ups):
            t.index_add_(0, ids, u)
        if pool is not None:
            tabs[1].index_add_(0, p64, up_p)

    n = int(real.sum())
    uniq, reps = torch.unique(ids, return_counts=True)
    rows_out = uniq if pool is None else torch.unique(torch.cat([ids, p64]))
    nbytes = NWL * 4 + 12 * n + 3 * n * d * 4 + 2 * uniq.numel() * d * 4 + \
        2 * rows_out.numel() * d * 4
    if pool is not None:  # the pool's ids, chains and dneg, the fold chains
        nbytes += 4 * KP + 12 * KP + KP * d * 4 + 4 * (NWL + KP)
        reps = reps.max() + torch.unique(p64, return_counts=True)[1].max()
    both = 0 if pool is None else int(torch.isin(uniq, p64).sum())
    name = (f"f32 {'block-end scatter KP ' + str(KP) if KP else 'scatter'} "
            f"L {L} d {d}" + (f" ({both} rows in both)" if KP else ""))
    return _held(name, views, run, plain_run, lib, nbytes, reps.max(),
                 rows_out.numel(), timed)


def fold_check(dev, slots, L, pool, timed=True) -> dict:
    """The fold chains of one group that ends a block (fold_chains_kernel,
    through its C entry: ops/scatter_pass.py) on ``slots`` int32 [1024]
    and ``pool`` int32 [KP], held bit for bit against the plain version on
    a CPU copy (_held).  The PyTorch calls beside it: a sort of the pool,
    searchsorted of the slots in it and isin of the pool in the slots.  The
    bound: the slots, their chains, the pool and its chains read once, the
    two outputs written once."""
    from come_tpu_torch.ops.pool_pass import pool_chains
    from come_tpu_torch.ops.scatter_pass import (
        fold_chains,
        fold_chains_reference,
        slot_chains,
    )

    KP = pool.numel()
    chains, pch = slot_chains(slots, L), pool_chains(pool)
    kern = fold_chains(slots, L, pool, chains=chains, pool_chains_of=pch)
    plain = fold_chains_reference(slots.cpu(), L, pool.cpu())
    views = [(a.cpu(), b) for a, b in zip(kern, plain)]
    run = lambda i: fold_chains(  # noqa: E731
        slots, L, pool, chains=chains, pool_chains_of=pch)
    plain_run = lambda: fold_chains_reference(slots, L, pool)  # noqa: E731
    s64, p64 = slots.long(), pool.long()

    def lib(i):
        ids = torch.sort(p64).values
        return torch.searchsorted(ids, s64), torch.isin(p64, s64)

    nbytes = 4 * (4 * slots.numel() + 4 * KP) + 4 * (slots.numel() + KP)
    name = f"fold chains L {L} KP {KP}"
    both = pool.long()[kern[1].bool()]  # the draws of rows in both
    return _held(name, views, run, plain_run, lib, nbytes, both.numel(),
                 torch.unique(both).numel(), timed)


def pool_text(r: dict) -> str:
    """A phase 4m case: kernel µs beside its bound, plain, library."""
    head = (f"{r['name']} ({r['rows']} rows, chains to {r['chain']}): bit "
            f"for bit")
    if "us" not in r:
        return head
    return (head + f", {r['us']:.2f} us (bound {r['bound'][0] * 1e3:.2f} us "
            f"by {r['bound'][1]}; plain {r['plain_us']:.1f} us, library "
            f"{r['lib_us']:.2f} us)")


def hub_slots(G, V, gen, dev):
    """G hub-heavy groups of slots (int32 [G * 1024]): every slot one of
    POOL_HUBS rows."""
    from come_tpu_torch.ops.walk_sgns import NWL

    rows = torch.randperm(V, generator=gen, device=dev)[:POOL_HUBS]
    pick = torch.randint(0, POOL_HUBS, (G * NWL,), generator=gen, device=dev)
    return rows[pick].to(torch.int32)


def pool_phase(dev, smi, V, alias, gen, slots, L) -> dict:
    """Phase 4m: every POOL_STAGES, WIDE_STAGES, POOL_CHAINS and
    POOL_APPLIES case (the write with each of POOL_SEEDS) on each of
    POOL_KINDS' pools over V rows (alias: synthetic-10m's unigram tables),
    through pool_check, and K3's slot chains and slot scatter (each of
    SCATTER_WIDTHS and POOL_SEEDS) through slot_check: on ``slots`` (phase
    4f's step, int32 [G * 1024], walks of L; the scatter on its first
    group) with the unigram pools, on hub-heavy groups (hub_slots) with
    the hub pools; timed on the unigram pools and the real walks (the main
    path's kinds), the slot passes on the hub-heavy groups too.  Prints
    one line a kind; returns the cases by (which,
    dtype, KP or L, d or the chains' pools or groups, seed, kind)."""
    from come_tpu_torch.ops.walk_sgns import NWL

    res = {}
    G = slots.numel() // NWL
    for kind in POOL_KINDS:
        lines, timed = [], kind == "unigram"
        for which, cases in (("stage", POOL_STAGES), ("wide", WIDE_STAGES)):
            for dtype, KP, d in cases:
                pool = pool_draws(kind, KP, V, alias, gen, dev)
                r = res[(which, dtype, KP, d, None, kind)] = pool_check(
                    dev, which, dtype, KP, d, pool, V, gen, timed=timed)
                lines.append(pool_text(r))
        for n, KP in POOL_CHAINS:
            pools = torch.stack([pool_draws(kind, KP, V, alias, gen, dev)
                                 for _ in range(n)])
            r = res[("chains", None, KP, n, None, kind)] = pool_check(
                dev, "chains", None, KP, 0, pools, V, gen, timed=timed)
            lines.append(pool_text(r))
        for KP, d in POOL_APPLIES:
            pool = pool_draws(kind, KP, V, alias, gen, dev)
            for seed in POOL_SEEDS:
                r = res[("apply", torch.bfloat16, KP, d, seed, kind)] = \
                    pool_check(dev, "apply", torch.bfloat16, KP, d, pool, V,
                               gen, seed, timed=timed)
                lines.append(pool_text(r))
        # the slot passes are timed on the hub-heavy groups too: a hub's
        # long chain is the scatter's worst case
        sl = slots if kind == "unigram" else hub_slots(G, V, gen, dev)
        r = res[("slot chains", None, L, G, None, kind)] = slot_check(
            dev, "chains", 0, sl, L, V, gen)
        lines.append(pool_text(r))
        for d in SCATTER_WIDTHS:
            for seed in POOL_SEEDS:
                r = res[("scatter", torch.bfloat16, L, d, seed, kind)] = \
                    slot_check(dev, "scatter", d, sl[:NWL], L, V, gen, seed)
                lines.append(pool_text(r))
        torch.cuda.empty_cache()
        phase("pool passes", f"{kind} pools over V {V}"
                             + (", phase 4f's walks" if timed else
                                ", hub-heavy groups")
                             + ", each kernel against its plain version bit "
                             "for bit, device us a call"
                             + ("" if timed else " (the slot passes)")
                             + ": " + "; ".join(lines) + f" | {smi}")
    return res


def f32_phase(dev, smi, V, alias, gen, slots, L) -> dict:
    """Phase 4m's f32 slot writes: every F32_KINDS case at each of
    F32_SCATTER_WIDTHS, the scatter alone and with the block end's pool,
    through f32_scatter_check (timed); ``slots`` phase 4f's walks over V
    rows (the first group), ``alias`` synthetic-10m's unigram tables.
    Prints one line; returns the cases by (kind, d, KP or 0)."""
    from come_tpu_torch.ops.walk_sgns import NW, NWL, pad_walks

    res, lines = {}, []
    for kind, KP in F32_KINDS:
        if kind == "unigram":
            Vk, sl = V, slots[:NWL]
            pool = pool_draws("unigram", KP, V, alias, gen, dev)
        elif kind == "hub":
            Vk, sl = V, hub_slots(1, V, gen, dev)
            rows = torch.cat([torch.unique(sl), torch.randint(
                0, V, (4,), generator=gen, device=dev)])
        else:  # phase 4h's hot row
            Vk = 2000
            w = torch.randint(0, Vk, (NW, L), generator=gen, device=dev,
                              dtype=torch.int32)
            w[:, ::2] = 7
            sl = pad_walks(w)
            rows = torch.cat([torch.tensor([7], device=dev), torch.randint(
                0, Vk, (9,), generator=gen, device=dev)])
        if kind != "unigram":
            pool = rows[torch.randint(0, rows.numel(), (KP,), generator=gen,
                                      device=dev)].to(torch.int32)
        r = res[(kind, "fold", KP)] = fold_check(dev, sl, L, pool)
        lines.append(f"{kind}: " + pool_text(r))
        for d in F32_SCATTER_WIDTHS:
            for p in (None, pool):
                r = res[(kind, d, 0 if p is None else KP)] = \
                    f32_scatter_check(dev, d, sl, L, Vk, gen, p)
                lines.append(f"{kind}: " + pool_text(r))
        torch.cuda.empty_cache()
    phase("f32 slot writes", "walk_scatter_kernel alone and "
                             "block_end_scatter_kernel (its pool write "
                             "folded in), twice each against the plain "
                             "version on a CPU copy, bit for bit, device "
                             "us a call: " + "; ".join(lines) + f" | {smi}")
    return res


def star_scatter_check(dev, d, slots, meta, V, gen, pool=None,
                       timed=True) -> dict:
    """The star slot writes of one group (star_scatter_kernel; with
    ``pool`` int32 [KP], the block end's with the pool write folded in,
    star_block_end_scatter_kernel) through their C entry
    (ops/scatter_pass.py) on ``slots`` and ``meta`` int32 [1024], an f32
    [V, d] table, dphi, dphin (and dneg) ~ N(0, 1), lr 0.025; run twice on
    fresh copies of the table, and both runs held bit for bit against the
    plain version run on a CPU copy of the same inputs (_held).  The
    PyTorch calls beside it: index_add_ of the real slots' dphi and of
    their dphin with alpha -lr (and of the pool's dneg: index_add_ x 3).
    The bound: each input read once (the slots, the real slots' chains and
    updates, dneg, the pool's ids and chains and the fold chains, the
    distinct rows), each output written once."""
    from come_tpu_torch.ops.pool_pass import pool_chains
    from come_tpu_torch.ops.scatter_pass import (
        star_chains,
        star_fold_chains,
        star_scatter,
        star_scatter_reference,
    )
    from come_tpu_torch.ops.walk_sgns import NWL
    from come_tpu_torch.sampling.stars import PAD_META

    lr = 0.025
    real = meta != PAD_META
    ids = slots.long()[real]
    emb = torch.randn((V, d), generator=gen, device=dev) * 0.1
    dphi, dphin = (torch.randn((NWL, d), generator=gen, device=dev)
                   for _ in range(2))
    KP = 0 if pool is None else pool.numel()
    dneg = None if pool is None else torch.randn((KP, d), generator=gen,
                                                 device=dev)
    kw = dict(pool=pool, dneg=dneg)
    args = (slots, meta, dphi, dphin, lr)
    kern = star_scatter(emb.clone(), *args, **kw)
    again = star_scatter(emb.clone(), *args, **kw)
    cpu = [x.cpu() if x is not None else None
           for x in (emb, slots, meta, dphi, dphin, pool, dneg)]
    plain = star_scatter_reference(*cpu[:5], lr, pool=cpu[5], dneg=cpu[6])
    views = [(a.cpu().view(torch.int32), plain.view(torch.int32))
             for a in (kern, again)]
    chains = star_chains(slots, meta)
    pch = None if pool is None else pool_chains(pool)
    fold = None if pool is None else star_fold_chains(
        slots, meta, pool, chains=chains, pool_chains_of=pch)
    run = lambda i: star_scatter(  # noqa: E731
        emb, *args, chains=chains, pool_chains_of=pch, fold=fold, **kw)
    emb_p = emb.clone()
    plain_run = lambda: star_scatter_reference(  # noqa: E731
        emb_p, *args, pool=pool, dneg=dneg)
    p64 = None if pool is None else pool.long()
    dr, dnr = dphi[real], dphin[real]

    def lib(i):
        emb.index_add_(0, ids, dr, alpha=-lr)
        emb.index_add_(0, ids, dnr, alpha=-lr)
        if pool is not None:
            emb.index_add_(0, p64, dneg, alpha=-lr)

    n = int(real.sum())
    uniq, reps = torch.unique(ids, return_counts=True)
    rows = uniq if pool is None else torch.unique(torch.cat([ids, p64]))
    nbytes = NWL * 4 + 12 * n + 2 * n * d * 4 + 2 * rows.numel() * d * 4
    if pool is not None:  # the pool's ids, chains and dneg, the fold chains
        nbytes += 4 * KP + 12 * KP + KP * d * 4 + 4 * (NWL + KP)
        reps = reps.max() + torch.unique(p64, return_counts=True)[1].max()
    both = 0 if pool is None else int(torch.isin(uniq, p64).sum())
    name = (f"star {'block-end scatter KP ' + str(KP) if KP else 'scatter'} "
            f"d {d}" + (f" ({both} rows in both)" if KP else ""))
    return _held(name, views, run, plain_run, lib, nbytes, reps.max(),
                 rows.numel(), timed)


def star_chains_check(dev, slots, meta, timed=True) -> dict:
    """The star chains of a whole layout (slot_chains_kernel on the meta,
    through its C entry: ops/scatter_pass.py) on ``slots`` and ``meta``
    int32 [G * 1024], held bit for bit against the plain version on a CPU
    copy (_held).  The PyTorch call beside it: a stable sort of each
    group's keys (pads last).  The bound: the slots and meta read once, the
    chains (3 int32 a slot) written once."""
    from come_tpu_torch.ops.scatter_pass import (
        star_chains,
        star_chains_reference,
    )
    from come_tpu_torch.ops.walk_sgns import NWL
    from come_tpu_torch.sampling.stars import PAD_META

    G = slots.numel() // NWL
    kern = star_chains(slots, meta)
    plain = star_chains_reference(slots.cpu(), meta.cpu())
    views = [(a.cpu(), b) for a, b in zip(kern, plain)]
    run = lambda i: star_chains(slots, meta)  # noqa: E731
    plain_run = lambda: star_chains_reference(slots, meta)  # noqa: E731
    keys = torch.where(meta != PAD_META, slots.long(), 1 << 40).view(G, NWL)
    lib = lambda i: torch.sort(keys, dim=1, stable=True)  # noqa: E731
    reps = max(int(torch.unique(q[q < (1 << 40)], return_counts=True)[1]
                   .max()) for q in keys)
    real = meta != PAD_META
    rows = sum(int(torch.unique(slots[g * NWL:(g + 1) * NWL][
        real[g * NWL:(g + 1) * NWL]]).numel()) for g in range(G))
    return _held(f"star chains {G} groups", views, run, plain_run, lib,
                 8 * slots.numel() + 12 * slots.numel(), reps, rows, timed)


def star_fold_check(dev, slots, meta, pools, R, timed=True) -> dict:
    """The fold chains of a star step's blocks (fold_chains_kernel on the
    meta, through its C entry: ops/scatter_pass.py) on ``slots``, ``meta``
    int32 [G * 1024] and ``pools`` int32 [ceil(G / R), KP], R groups a
    block, held bit for bit against the plain version on a CPU copy
    (_held).  The PyTorch calls beside it: a sort of each pool,
    searchsorted of its block's last group's slots in it and isin of the
    pool in them.  The bound: the slots, meta, their chains, the pools and
    their chains read once, the two outputs written once."""
    from come_tpu_torch.ops.pool_pass import pool_chains
    from come_tpu_torch.ops.scatter_pass import (
        star_chains,
        star_fold_chains,
        star_fold_chains_reference,
    )
    from come_tpu_torch.ops.walk_sgns import NWL

    G = slots.numel() // NWL
    nb, KP = pools.shape
    chains, pch = star_chains(slots, meta), pool_chains(pools)
    kern = star_fold_chains(slots, meta, pools, R=R, chains=chains,
                            pool_chains_of=pch)
    plain = star_fold_chains_reference(slots.cpu(), meta.cpu(), pools.cpu(),
                                       R)
    views = [(a.cpu(), b) for a, b in zip(kern, plain)]
    run = lambda i: star_fold_chains(  # noqa: E731
        slots, meta, pools, R=R, chains=chains, pool_chains_of=pch)
    plain_run = lambda: star_fold_chains_reference(  # noqa: E731
        slots, meta, pools, R)
    ends = [min(b * R + R - 1, G - 1) for b in range(nb)]
    s64 = slots.long().view(G, NWL)[ends]
    p64 = pools.long()

    def lib(i):
        ids = torch.sort(p64, dim=1).values
        return torch.searchsorted(ids, s64), torch.isin(p64, s64)

    nbytes = 4 * (4 * slots.numel() + 4 * pools.numel()) + \
        4 * (nb * NWL + pools.numel())
    both = p64[kern[1].bool()]  # the draws of rows in both
    return _held(f"star fold chains {G} groups R {R} KP {KP}", views, run,
                 plain_run, lib, nbytes, both.numel(),
                 torch.unique(both).numel(), timed)


def star_hub_pool(KP, slots, meta, V, gen, dev):
    """A pool of KP draws of node 0 (the hub layouts' hub), three of the
    group's real rows and two others, over and over (int32 [KP])."""
    from come_tpu_torch.sampling.stars import PAD_META

    real = torch.unique(slots[meta != PAD_META])
    pick = real[torch.randperm(real.numel(), generator=gen, device=dev)[:3]]
    rows = torch.cat([torch.zeros(1, dtype=real.dtype, device=dev), pick,
                      torch.randint(1, V, (2,), generator=gen, device=dev,
                                    dtype=real.dtype)])
    return rows[torch.randint(0, rows.numel(), (KP,), generator=gen,
                              device=dev)].to(torch.int32)


def star_phase(dev, smi, sl, mt, pools, V, gen) -> dict:
    """Phase 4m's star writes: every STAR_WRITE_KINDS case at each of
    STAR_WRITE_WIDTHS, the scatter alone and with the block end's pool,
    through star_scatter_check (timed), the star chains of each layout
    (star_chains_check) and the fold chains of each hub pool's step at
    STAR_WRITE_R (star_fold_check); ``sl``, ``mt`` phase 4's blogcatalog
    star step over V rows, ``pools`` its pools (the first, KP 512).  Then
    the hub layout's K2 step at STAR_WRITE_R with each hub pool, held
    against its plain step by conditioned_compare.  Prints one line; returns
    the cases by (kind, d, KP or 0), (kind, "chains") and (kind, "fold",
    KP): phase 4's step's fold chains at R 1, the hub layout's at
    STAR_WRITE_R."""
    from come_tpu_torch.ops.star_sgns import (
        star_sgns_step,
        star_sgns_step_reference,
    )
    from come_tpu_torch.ops.walk_sgns import NWL
    from come_tpu_torch.sampling.stars import PAD_META

    res, lines = {}, []
    Vh = 3000
    hs, hm = star_edge_layout(Vh, 20000, "hub", Vh + 24)
    Gh = -(-hs.size // NWL)
    hs = torch.as_tensor(np.pad(hs, (0, Gh * NWL - hs.size)), device=dev)
    hm = torch.as_tensor(np.pad(hm, (0, Gh * NWL - hm.size),
                                constant_values=PAD_META), device=dev)
    for kind, KP in STAR_WRITE_KINDS:
        if kind == "blog":
            Vk, s, m, pool = V, sl, mt, pools[0]
        else:
            Vk, s, m = Vh, hs, hm
            pool = star_hub_pool(KP, s[:NWL], m[:NWL], Vk, gen, dev)
        if (kind, "chains") not in res:
            r = res[(kind, "chains")] = star_chains_check(dev, s, m)
            lines.append(f"{kind}: " + pool_text(r))
        if kind == "hub":
            nb = -(-Gh // STAR_WRITE_R)
            hp = torch.stack([pool] + [star_hub_pool(
                KP, s[:NWL], m[:NWL], Vk, gen, dev) for _ in range(nb - 1)])
            r = res[(kind, "fold", KP)] = star_fold_check(
                dev, s, m, hp, STAR_WRITE_R)
        else:  # phase 4's step: a pool a group (R 1)
            r = res[(kind, "fold", KP)] = star_fold_check(dev, s, m, pools, 1)
        lines.append(f"{kind}: " + pool_text(r))
        for d in STAR_WRITE_WIDTHS:
            for p in (None, pool):
                key = (kind, d, 0 if p is None else KP)
                if key in res:  # the scatter alone: once a layout
                    continue
                r = res[key] = star_scatter_check(dev, d, s[:NWL], m[:NWL],
                                                  Vk, gen, p)
                lines.append(f"{kind}: " + pool_text(r))
        if kind == "hub":  # the whole step at R 3 on these pools
            ge = torch.Generator(device=dev).manual_seed(KP)
            init = torch.randn((Vh, 128), generator=ge, device=dev) * 0.1

            def step(fn, t=init, on=(hs, hm, hp)):
                return fn(t.clone(), *on, 0.025, 5.0 / KP,
                          pool_refresh=STAR_WRITE_R)

            on_cpu = (hs.cpu(), hm.cpu(), hp.cpu())
            text = conditioned_compare(
                f"K2 hub R {STAR_WRITE_R} KP {KP}", init,
                step(star_sgns_step), step(star_sgns_step_reference),
                step(star_sgns_step_reference, init.cpu(), on_cpu),
                step(star_sgns_step_reference, init.cpu().double(), on_cpu))
            lines.append(f"K2 step on the hub layout, {Gh} groups, R "
                         f"{STAR_WRITE_R}, KP {KP}: {text}")
        torch.cuda.empty_cache()
    phase("star writes", "star_scatter_kernel alone and "
                         "star_block_end_scatter_kernel (its pool write "
                         "folded in), twice each against the plain version "
                         "on a CPU copy, bit for bit, the star chains and "
                         "fold chains likewise, device us a call: "
          + "; ".join(lines) + f" | {smi}")
    return res


def star_edge_layout(V, E, layout, seed, max_fanout=32):
    """(slots, meta) of a star layout on E random edges of V nodes, its
    segments split at ``max_fanout``: "random" as they come; "hub" with
    node 0 joined to 300 more nodes; "fat" only node 0 and 150 neighbours
    at max_fanout 127 (one segment fills a row); "pads" with every third
    segment dropped to pads (pads mid-row); "ragged" cut to 8k + 5 rows (a
    ragged last group).  The tests build their star layouts here too."""
    from come_tpu_torch.sampling import build_star_layout
    from come_tpu_torch.sampling.stars import PAD_META

    rng = np.random.default_rng(seed)
    u = rng.integers(0, V, E)
    v = (u + 1 + rng.integers(0, V - 1, E)) % V
    fanout = max_fanout
    if layout == "hub":
        u = np.concatenate([u, np.zeros(300, np.int64)])
        v = np.concatenate([v, 1 + rng.choice(V - 1, 300, replace=False)])
    elif layout == "fat":
        u, v, fanout = np.zeros(150, np.int64), np.arange(1, 151), 127
    slots, meta = build_star_layout(u, v, V, max_fanout=fanout)
    if layout == "pads":
        seg = np.where(meta >= 0, np.arange(meta.size) // 128 * 128
                       + (meta >> 1), -1)
        drop = np.isin(seg, seg[(meta >= 0) & (meta & 1 == 1)][1::3])
        slots = np.where(drop, 0, slots).astype(np.int32)
        meta = np.where(drop, PAD_META, meta).astype(np.int32)
    elif layout == "ragged":
        rows = meta.size // 128
        keep = 128 * (rows - (rows - 5) % 8)
        slots, meta = slots[:keep], meta[:keep]
    return slots, meta


_LAST = [time.perf_counter()]


def phase(name: str, msg: str) -> None:
    now = time.perf_counter()
    print(f"[{name}] {msg} ({now - _LAST[0]:.1f} s)", flush=True)
    _LAST[0] = now


def bound(flops: float, nbytes: float, bf16: bool):
    """(bound ms, "bytes" or "operations"): the least time the card could
    take for ``flops`` operations on bf16 (or f32) products and ``nbytes``
    bytes moved."""
    t_b = nbytes / HBM_BPS
    t_f = flops / (PEAK_BF16 if bf16 else PEAK_F32)
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def n_unique(*ids) -> int:
    return int(torch.unique(torch.cat([i.reshape(-1).long() for i in ids]))
               .numel())


def walk_bound(walks, pools, n_pairs, d, es, bf16, extra_bytes=0):
    """Bound of one walk-kernel step (K1, K1b, K3, K4, K5): every real slot
    scores the pool (3 * KP * d multiply-adds) and each trained pair costs
    3 * d; the node rows and the ctx and pool rows are read and written
    once at ``es`` bytes an element; walks, window draws and pools read
    once as int32."""
    B, L = walks.shape
    G = -(-B // 8)
    real = walks[torch.arange(G * 8, device=walks.device) % B]
    KP = pools.shape[-1]
    flops = 2.0 * (3 * d * float(n_pairs) + 3 * KP * d * real.numel())
    rows = n_unique(real) + n_unique(real, pools)
    nbytes = 2.0 * rows * d * es + 4.0 * (2 * G * 1024 + pools.numel())
    return bound(flops, nbytes + extra_bytes, bf16)


def star_bound(slots, meta, pools, n_pairs, d, bf16, pad_meta):
    """Bound of one star step (K2, K2b): every non-pad slot scores the
    pool, each trained pair costs 3 * d; the tied table's slot and pool
    rows are read and written once; slots, meta and pools read once."""
    real = slots[meta != pad_meta]
    KP = pools.shape[-1]
    flops = 2.0 * (3 * d * float(n_pairs) + 3 * KP * d * real.numel())
    nbytes = (2.0 * n_unique(real, pools) * d * 4
              + 4.0 * (slots.numel() + meta.numel() + pools.numel()))
    return bound(flops, nbytes, bf16)


def pairs_bound(c, x, m, pool, d, tied):
    """Bound of one micro-batched step (K6, K7): every unmasked pair scores
    the pool and its context (3 * (KP + 1) * d multiply-adds); the centre,
    context and pool rows are read and written once; c, x, m and the pool
    read once."""
    keep = m > 0
    n = int(keep.sum())
    flops = 2.0 * 3 * (pool.numel() + 1) * d * n
    if tied:
        rows = n_unique(c[keep], x[keep], pool)
    else:
        rows = n_unique(c[keep]) + n_unique(x[keep], pool)
    nbytes = 2.0 * rows * d * 4 + 4.0 * (3 * c.numel() + pool.numel())
    return bound(flops, nbytes, False)


def compare(name, init, kern, plain):
    """Max abs / rel errors of the kernel's table updates (tables after the
    step minus ``init``) against the plain version's, the loss's relative
    error, the plain update's |upd| where the abs error is largest and the
    largest |upd|; raises past the stated tolerance.  A plain step in
    float64 (``acc``) is compared in float64."""
    *k_tabs, k_loss, k_pairs = kern
    *p_tabs, p_loss, p_pairs = plain
    max_abs = max_rel = upd_at = max_upd = 0.0
    for t0, a, b in zip(init, k_tabs, p_tabs):
        t0, a = t0.to(b.dtype), a.to(b.dtype)
        du = b - t0
        err = ((a - t0) - du).abs()
        worst = int(err.argmax())
        if float(err.reshape(-1)[worst]) >= max_abs:
            max_abs = float(err.reshape(-1)[worst])
            upd_at = float(du.reshape(-1)[worst].abs())
        max_upd = max(max_upd, float(du.abs().max()))
        max_rel = max(max_rel, float((err / du.abs().clamp_min(1e-30)).max()))
        bad = int((err > ATOL + RTOL * du.abs()).sum())
        if bad:
            raise AssertionError(f"{name}: {bad} table updates past "
                                 f"{ATOL} + {RTOL}*|plain update|")
    loss_rel = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
    if loss_rel > 1e-4 or float(k_pairs) != float(p_pairs):
        raise AssertionError(
            f"{name}: loss {float(k_loss)} vs {float(p_loss)}, pairs "
            f"{float(k_pairs)} vs {float(p_pairs)}")
    if not all(torch.isfinite(t).all() for t in k_tabs):
        raise AssertionError(f"{name}: non-finite table")
    return max_abs, max_rel, loss_rel, upd_at, max_upd


def conditioned_compare(name, init, kern, plain, plain_cpu, exact):
    """A whole step's check on a layout where the order of the f32 adds can
    carry into later groups' gradients (a row drawn hundreds of times a
    pool): ``kern`` the kernel step, ``plain`` the plain step on the card
    (index_add_, atomic order), ``plain_cpu`` the plain step on a CPU copy
    (every add in slot and draw order) and ``exact`` the same in float64,
    each (table, loss, pairs).  Where ``plain_cpu`` meets the f32 check
    against ``exact`` (the layout is well conditioned for f32), compare()'s
    f32 check of ``kern`` against ``plain``; otherwise the kernel's table
    may lie no further from ``exact`` (max abs) than twice the farther of
    the two plain f32 steps, with the same pairs and a finite loss.
    Returns the line's text; raises past either bound."""
    i64, x = init.cpu().double(), exact[0]
    upd = (x - i64).abs()
    dist = [float((t[0].cpu().double() - x).abs().max())
            for t in (kern, plain, plain_cpu)]
    well = bool(((plain_cpu[0].double() - x).abs()
                 <= ATOL + RTOL * upd).all())
    spread = (f"from the float64 step: kernel {dist[0]:.3e}, plain on the "
              f"card {dist[1]:.3e}, plain on a CPU copy {dist[2]:.3e}")
    if well:
        return f"max_abs {compare(name, (init,), kern, plain)[0]:.3e}; " \
            + spread
    if dist[0] > 2 * max(dist[1], dist[2]) or float(kern[2]) != float(
            exact[2]) or not torch.isfinite(kern[0]).all() or not bool(
            torch.isfinite(kern[1])):
        raise AssertionError(f"{name}: {spread} (bound: twice the farther "
                             f"plain step), pairs {float(kern[2])} vs "
                             f"{float(exact[2])}")
    return (f"f32-conditioned: no (the plain step on a CPU copy is past the "
            f"f32 check against float64); {spread}, within twice the "
            f"farther plain step")


def compare_bf16(name, init, kern, plain, f32):
    """The bf16 check (module docstring) of the kernel's step against the
    plain version's, with the plain f32 step's tables ``f32``: returns
    (max abs update error, relative L2 error, f32-vs-bf16 distance, worst
    element error over 2^-8 max|plain update|)."""
    from come_tpu_torch.ops.tolerance import check_bf16

    *k_tabs, k_loss, k_pairs = kern
    *p_tabs, p_loss, p_pairs = plain
    err = check_bf16(name, init, k_tabs, p_tabs, f32)
    loss_rel = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
    if loss_rel > 1e-4 or float(k_pairs) != float(p_pairs):
        raise AssertionError(
            f"{name}: loss {float(k_loss)} vs {float(p_loss)}, pairs "
            f"{float(k_pairs)} vs {float(p_pairs)}")
    if not all(torch.isfinite(t).all() for t in k_tabs):
        raise AssertionError(f"{name}: non-finite table")
    return err


def bf16_line(err, ms, plain_ms):
    from come_tpu_torch.ops.tolerance import BF16_L2

    return (f"max_abs {err[0]:.3e} rel_l2 {err[1]:.3e} (bound {BF16_L2}; "
            f"f32-vs-bf16 distance {err[2]:.3e}, "
            f"{err[2] / max(err[1], 1e-30):.3g}x the error, "
            f"{err[2] / BF16_L2:.2f}x the bound; worst element "
            f"{err[3]:.3f} of 2^-8 max|plain update|) | kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms")


def _graph_step_inputs(mode, dev, g, step, V, W, KP, csr=None):
    """One step's inputs of graph_steps: walks (or star rows), window draws
    and pools drawn anew from ``g``."""
    from come_tpu_torch.ops.walk_sgns import NWL, walks_from_bits

    if mode == "K2":
        slots, meta = star_edge_layout(V, 12000, "random", V)
        rows = np.random.default_rng(step).permutation(slots.size // 128)[:24]
        sl, mt = (torch.as_tensor(a.reshape(-1, 128)[rows], device=dev)
                  .reshape(-1) for a in (slots, meta))
        pools = torch.randint(0, V, (3, KP), generator=g, device=dev,
                              dtype=torch.int32)
        return sl, mt, pools
    B, L = 40, 80
    G = B // 8
    wrow = torch.randint(1, W + 1, (G * NWL,), generator=g, device=dev,
                         dtype=torch.int32)
    pools = torch.randint(0, V, (-(-G // 2), KP), generator=g, device=dev,
                          dtype=torch.int32)
    if mode == "K1":
        walks = torch.randint(0, V, (B, L), generator=g, device=dev,
                              dtype=torch.int32)
        return walks, wrow, pools
    # K3: walks on the large-V path's kind of graph, which revisit few rows
    starts = torch.randint(0, V, (B,), generator=g, device=dev,
                           dtype=torch.int32)
    bits = torch.randint(-2**31, 2**31, (G * NWL,), generator=g, device=dev,
                         dtype=torch.int32)
    return walks_from_bits(starts, bits, csr.indptr, csr.indices, L), wrow, \
        pools


def graph_steps(mode: str, dev, n: int = 6) -> list:
    """Phase 15b's sequence (and tests/test_torch_cuda.py's): ``n``
    consecutive steps of K1, K3 or K2 through one launch plan, with lr, the
    SR seed, the walks (star rows), window draws and pools new at every
    step and the tables moved to new addresses at every other step; each
    step is held against its plain version from the same tables under its
    mode's check (no value of an earlier step may be replayed).  Returns
    each step's (max_abs, f32 relative error or K3 identical share);
    raises at the first step past its check."""
    from come_tpu_torch.graphs import sbm_graph
    from come_tpu_torch.ops.star_sgns import (
        star_sgns_step,
        star_sgns_step_reference,
    )
    from come_tpu_torch.ops.tolerance import check_k3
    from come_tpu_torch.ops.walk_sgns import (
        walk_sgns_step,
        walk_sgns_step_reference,
    )

    V, d, W, KP = (20000 if mode == "K3" else 2000), 128, 10, 512
    csr = None
    if mode == "K3":
        graph, _ = sbm_graph(V, 16, p_in=0.1, p_out=0.002, seed=V,
                             avg_degree=40)
        csr = graph.to_device(dev)
    g = torch.Generator(device=dev).manual_seed(7)
    tabs = [torch.randn((V, d), generator=g, device=dev) * 0.1
            for _ in range(1 if mode == "K2" else 2)]
    if mode == "K3":
        tabs = [t.to(torch.bfloat16) for t in tabs]
    errs = []
    for step in range(n):
        lr, seed, name = 0.025 * (1.0 + 0.2 * step), 1000 + step, \
            f"graph {mode} step {step}"
        if step % 2:
            moved = [t.clone() for t in tabs]
            if any(a.data_ptr() == b.data_ptr() for a, b in zip(moved, tabs)):
                raise AssertionError(f"{name}: the tables did not move")
            tabs = moved
        before = [t.clone() for t in tabs]
        x, y, pools = _graph_step_inputs(mode, dev, g, step, V, W, KP, csr)
        if mode == "K2":
            kern = star_sgns_step(tabs[0], x, y, pools, lr, 5.0 / KP,
                                  pool_refresh=1)
            plain = star_sgns_step_reference(before[0].clone(), x, y, pools,
                                             lr, 5.0 / KP, pool_refresh=1)
            torch.cuda.synchronize()
            errs.append(compare(name, before, kern, plain)[:2])
            continue
        kw = dict(window=W, pool_refresh=2)
        if mode == "K3":
            kw["sr_seed"] = seed
        kern = walk_sgns_step(*tabs, x, y, pools, lr, 5.0 / KP, **kw)
        plain = walk_sgns_step_reference(
            *[t.clone() for t in before], x, y, pools, lr, 5.0 / KP, **kw)
        torch.cuda.synchronize()
        if mode == "K1":
            errs.append(compare(name, before, kern, plain)[:2])
            continue
        kw.pop("sr_seed")
        f32 = walk_sgns_step_reference(
            *[t.float() for t in before], x, y, pools, lr, 5.0 / KP,
            mxu_bf16=True, **kw)
        if float(kern[3]) != float(plain[3]) or abs(
                float(kern[2]) - float(plain[2])) > 1e-4 * abs(float(plain[2])):
            raise AssertionError(f"{name}: loss {float(kern[2])} vs "
                                 f"{float(plain[2])}, pairs {float(kern[3])} "
                                 f"vs {float(plain[3])}")
        err = check_k3(name, before, kern[:2], plain[:2], f32[:2])
        errs.append((err[0], err[3]))
    return errs


def fused_steps(tied: bool, dev, V: int, d: int, P: int, TP: int, KP: int,
                n: int = 6) -> list:
    """Phases 6-7's sequence (and tests/test_torch_cuda.py's): ``n``
    consecutive K6 (K7 if ``tied``) micro-steps of P pairs in tiles of TP
    through one launch plan, with lr, the pairs, the mask (0.6 valid; the
    second tile all masked) and the pool of KP rows new at every step and
    the tables moved to new addresses once, before step n // 2; each step
    is held against its plain version from the same tables under the f32
    check.  Returns each step's (max_abs, max_rel); raises at the first step
    past the check."""
    from come_tpu_torch.ops.sgns import (
        fused_sgns_step,
        fused_sgns_step_reference,
        fused_sgns_step_tied,
        fused_sgns_step_tied_reference,
    )

    g = torch.Generator(device=dev).manual_seed(V + P + TP)
    tabs = [torch.randn((V, d), generator=g, device=dev) * 0.1
            for _ in range(1 if tied else 2)]
    kern_fn, plain_fn = ((fused_sgns_step_tied, fused_sgns_step_tied_reference)
                         if tied else
                         (fused_sgns_step, fused_sgns_step_reference))
    errs = []
    for step in range(n):
        lr, name = 0.025 * (1.0 + 0.2 * step), \
            f"{'K7' if tied else 'K6'} plan step {step}"
        if step == n // 2:
            moved = [t.clone() for t in tabs]
            if any(a.data_ptr() == b.data_ptr() for a, b in zip(moved, tabs)):
                raise AssertionError(f"{name}: the tables did not move")
            tabs = moved
        before = [t.clone() for t in tabs]
        c, x, pool = (torch.randint(0, V, (k,), generator=g, device=dev,
                                    dtype=torch.int32) for k in (P, P, KP))
        m = (torch.rand(P, generator=g, device=dev) < 0.6).float()
        m[TP:2 * TP] = 0.0
        args = (c, x, pool, m, lr, 5.0 / KP)
        kern = kern_fn(*tabs, *args, tile_pairs=TP)
        plain = plain_fn(*[t.clone() for t in before], *args, tile_pairs=TP)
        torch.cuda.synchronize()
        errs.append(compare(name, before, kern, plain)[:2])
    return errs


def fused_stress(tied: bool, dev, V: int, d: int, P: int, TP: int, KP: int,
                 n: int = 40) -> list:
    """``n`` K6 (K7 if ``tied``) micro-steps of P pairs in tiles of TP
    enqueued back to back through one launch plan, with no host wait
    between them: the pairs, the mask (every fifth step's first tile all
    masked) and the pool new at every step, so a kernel that read a
    packed id or pool row of the call before would update other rows.  The
    tables after each step are snapshot on the card; the plain versions
    then run from each snapshot, and each step is held against its own
    under the f32 check.  Returns each step's (max_abs, max_rel, the plain
    update's |upd| where the abs error is largest, the step's largest
    |upd|); raises at the first step past the check."""
    from come_tpu_torch.ops.sgns import (
        fused_sgns_step,
        fused_sgns_step_reference,
        fused_sgns_step_tied,
        fused_sgns_step_tied_reference,
    )

    g = torch.Generator(device=dev).manual_seed(V + P + TP + 1)
    tabs = [torch.randn((V, d), generator=g, device=dev) * 0.1
            for _ in range(1 if tied else 2)]
    kern_fn, plain_fn = ((fused_sgns_step_tied, fused_sgns_step_tied_reference)
                         if tied else
                         (fused_sgns_step, fused_sgns_step_reference))
    states, calls, results = [[t.clone() for t in tabs]], [], []
    for step in range(n):
        c, x, pool = (torch.randint(0, V, (k,), generator=g, device=dev,
                                    dtype=torch.int32) for k in (P, P, KP))
        m = (torch.rand(P, generator=g, device=dev) < 0.6).float()
        if step % 5 == 0:
            m[:TP] = 0.0
        calls.append((c, x, pool, m, 0.025 * (1.0 + 0.02 * step), 5.0 / KP))
        *_, loss, pairs = kern_fn(*tabs, *calls[-1], tile_pairs=TP)
        results.append((loss, pairs))
        states.append([t.clone() for t in tabs])
    name = f"{'K7' if tied else 'K6'} back-to-back step"
    errs = []
    for step, args in enumerate(calls):
        plain = plain_fn(*[t.clone() for t in states[step]], *args,
                         tile_pairs=TP)
        e = compare(f"{name} {step}", states[step],
                    (*states[step + 1], *results[step]), plain)
        errs.append((e[0], e[1], e[3], e[4]))
    return errs


def fused_scan_check(tied: bool, dev, V: int, d: int, mb: int, TP: int,
                     KP: int, n: int = 40) -> tuple:
    """One macro batch of ``n`` K6 (K7 if ``tied``) micro-steps of mb pairs
    in tiles of TP as one scan (``fused_sgns_scan``: one WHILE-graph
    launch, the port of the JAX trainer's ``lax.scan``), the pairs, the
    mask (every fifth micro-step's first tile all masked) and the pools new
    at every micro-step, against the loop of plain micro-steps from the same
    tables: the final tables under the f32 check and the summed (loss,
    n_pairs).  Raises unless the batch was one replay of the scan plan and
    ``n`` micro-steps on the wrapper's launch count.  Returns compare()'s
    (max_abs, max_rel, loss_rel, |upd| at the worst, largest |upd|)."""
    from come_tpu_torch.ops import launch_plan
    from come_tpu_torch.ops.sgns import (
        fused_sgns_scan,
        fused_sgns_scan_tied,
        fused_sgns_step,
        fused_sgns_step_reference,
        fused_sgns_step_tied,
        fused_sgns_step_tied_reference,
    )

    g = torch.Generator(device=dev).manual_seed(V + mb + TP + 2)
    tabs = [torch.randn((V, d), generator=g, device=dev) * 0.1
            for _ in range(1 if tied else 2)]
    c, x = (torch.randint(0, V, (n, mb), generator=g, device=dev,
                          dtype=torch.int32) for _ in range(2))
    pools = torch.randint(0, V, (n, KP), generator=g, device=dev,
                          dtype=torch.int32)
    m = (torch.rand((n, mb), generator=g, device=dev) < 0.6).float()
    m[::5, :TP] = 0.0
    lr, negw = 0.025, 5.0 / KP
    scan, step, plain_fn, entry = (
        (fused_sgns_scan_tied, fused_sgns_step_tied,
         fused_sgns_step_tied_reference, "fused_scan_tied") if tied else
        (fused_sgns_scan, fused_sgns_step, fused_sgns_step_reference,
         "fused_scan"))
    before = [t.clone() for t in tabs]
    replays, launches = launch_plan.graph_counts()[entry]["replays"], \
        step.launches
    *_, loss, pairs = scan(*tabs, c, x, pools, m, lr, negw, tile_pairs=TP)
    torch.cuda.synchronize()
    name = f"{'K7' if tied else 'K6'} scan of {n} (V {V}, d {d}, mb {mb})"
    if (launch_plan.graph_counts()[entry]["replays"] != replays + 1
            or step.launches != launches + n):
        raise AssertionError(f"{name}: not one launch of {n} micro-steps")
    work = [t.clone() for t in before]
    p_loss = p_pairs = 0.0
    for i in range(n):
        *_, lo, pa = plain_fn(*work, c[i], x[i], pools[i], m[i], lr, negw,
                              tile_pairs=TP)
        p_loss += float(lo)
        p_pairs += float(pa)
    return compare(name, before, (*tabs, loss, pairs),
                   (*work, torch.tensor(p_loss), torch.tensor(p_pairs)))


def scan_text(runs: dict) -> str:
    return "; ".join(f"{k} max_abs {e[0]:.3e} at |upd| {e[3]:.3e} (largest "
                     f"|upd| {e[4]:.3e}), loss_rel {e[2]:.3e}"
                     for k, e in runs.items())


def stress_worst(errs) -> str:
    """fused_stress's worst step: its index, max_abs and the |upd| where
    it fell, beside the step's and the run's largest |upd|."""
    i = max(range(len(errs)), key=lambda k: errs[k][0])
    e = errs[i]
    return (f"worst step {i}: max_abs {e[0]:.3e} at |upd| {e[2]:.3e} (the "
            f"step's largest |upd| {e[3]:.3e}, the run's "
            f"{max(x[3] for x in errs):.3e})")


def fused_counts(where: str, entry: str) -> str:
    """The graph counters of :func:`fused_steps`' six steps on a fresh plan,
    checked: six replays of one plan, recorded twice: its instantiation and
    one update, when the tables moved."""
    from come_tpu_torch.ops import launch_plan

    c = launch_plan.graph_counts()[entry]
    if (c["recordings"], c["replays"], c["instantiations"], c["updates"],
            c["shapes"]) != (2, 6, 1, 1, 1):
        raise AssertionError(f"{where}: graph counters {c}")
    return graph_line(where, {entry: c})


def fused_times(step, tiles: int = 32) -> dict:
    """A K6/K7 micro-step's times on tables it updates in place
    (tools/pass_times.py): ms from an idle card, ms a step in a run of 6,
    host ms a step enqueued in a run of 6, device µs a tile by pass, the
    gaps between the step's kernels and the covered share of its span."""
    from come_tpu_torch.tools import pass_times as pt

    t = dict(ms=pt.cuda_ms(step), run_ms=pt.chained_ms(step, n=6),
             host_ms=pt.enqueue_ms(step, n=6))
    t["split"], _ = pt.pass_split(step, tiles, pt.FUSED_PASSES)
    tl = pt.timeline(step, pt.FUSED_PASSES)
    return dict(t, gap=tl["gap_us"], covered=min(tl["covered"]),
                span=min(tl["span_us"]), kernels=tl["kernels_per_step"])


def fused_text(t: dict) -> str:
    from come_tpu_torch.tools.pass_times import split_text

    g = t["gap"]
    return (f"kernel {t['ms']:.3f} ms from idle, {t['run_ms']:.3f} ms a step "
            f"in a run of 6, host {t['host_ms']:.3f} ms a step enqueued | "
            f"device us per tile: {split_text(t['split'])} | gaps median "
            f"{g['median']:.3f} us (p10 {g['p10']:.3f}, p90 {g['p90']:.3f}),"
            f" covered {t['covered']:.1%} of a {t['span']:.1f} us span "
            f"({t['kernels'][0]} kernels a step)")


def graph_line(where: str, counts: dict, once: bool = False) -> str:
    """The launch plans' graph counters (ops/launch_plan.py) of a run,
    checked: every recording instantiated or updated an instance, and at
    most one instantiation per plan (shape) that stepped; with ``once`` (a
    single-device run), every plan recorded once: recordings =
    instantiations = plans used, no update.  K6/K7's scans ("fused_scan")
    are one replay a macro batch."""
    from come_tpu_torch.ops import launch_plan

    launch_plan.check_counts(where, counts, once)
    return "; ".join(
        f"{e} {c['recordings']} recordings, {c['instantiations']} "
        f"instantiations, {c['updates']} updates, {c['replays']} replays "
        f"over {c['shapes']} plans"
        for e, c in counts.items() if c["replays"]) or "no graph"


def micro_path(counts: dict) -> str:
    """Which path a run's K6/K7 micro-steps took: one scan (a WHILE-graph
    launch) a macro batch, or a launch a micro-step."""
    scans = sum(counts[e]["replays"] for e in ("fused_scan",
                                                 "fused_scan_tied"))
    steps = sum(counts[e]["replays"] for e in ("fused_sgns",
                                                 "fused_sgns_tied"))
    return (f"path: {scans} scans (one WHILE-graph launch a macro batch), "
            f"{steps} single micro-step launches")


def graph_phase(dev, smi: str) -> dict:
    """Phase 15b (module docstring); raises if a step or a check fails.
    Returns what the PERF tables read."""
    from come_tpu_torch.ops import build, launch_plan
    from come_tpu_torch.tools import pass_times, probe_star_floor

    seq = {}
    for mode in ("K1", "K3", "K2"):
        launch_plan.release_plans(build.library())
        launch_plan.reset_counts()
        errs = graph_steps(mode, dev)
        counts = launch_plan.graph_counts()
        entry = "star_sgns" if mode == "K2" else "walk_sgns"
        c = counts[entry]
        # the tables move before every other step: each move records again
        if (c["recordings"], c["replays"], c["instantiations"],
                c["updates"], c["shapes"]) != (4, 6, 1, 3, 1):
            raise AssertionError(f"graph {mode}: counters {c}")
        seq[mode] = (errs, graph_line(f"graph {mode}", counts))
    # every walk and star mode enqueued back to back, at d 128 and 256
    stress = {(m, 128): graph_stress(m, dev) for m in B2B_MODES}
    stress.update({(m, 256): graph_stress(m, dev, 256) for m in B2B_WIDE})
    steps = {}
    for name, step, groups, passes, _, _ in pass_times.steps(dev):
        if name not in ("K1", "K2", "K3"):
            continue
        ms = pass_times.cuda_ms(step)
        chained = pass_times.chained_ms(step)
        host = pass_times.enqueue_ms(step)
        _, total = pass_times.pass_split(step, groups, passes)
        tl = pass_times.timeline(step, passes)
        steps[name] = dict(ms=ms, chained_ms=chained, busy=total / (ms * 1e3),
                           covered=min(tl["covered"]),
                           gap_us=tl["gap_us"]["median"],
                           span_us=min(tl["span_us"]), host_ms=host)
    # no step waits for the card: the host enqueues ten K3 steps (record,
    # update, launch) in well under the card's time for them (a wait for
    # the previous replay would make the two equal)
    k3 = steps["K3"]
    if k3["host_ms"] > 0.7 * k3["chained_ms"]:
        raise AssertionError(f"graph: the host took {k3['host_ms']:.3f} ms "
                             f"to enqueue a K3 step the card ran in "
                             f"{k3['chained_ms']:.3f} ms")
    floors = probe_star_floor.graph_floor(dev, log=lambda m: None)
    phase("graph", (
        f"{smi} | 6 steps each through one plan, held step by step: " +
        "; ".join(f"{m} worst " + (
            f"max_abs {max(e[0] for e in errs):.3e}, identical "
            f"{min(e[1] for e in errs):.5f}" if m == "K3" else
            f"max_abs {max(e[0] for e in errs):.3e}, max_rel "
            f"{max(e[1] for e in errs):.3e}") + f" ({line})"
            for m, (errs, line) in seq.items()) + " | 8 steps each enqueued "
        "back to back, held step by step: " + stress_text(stress) +
        " | steps (pass_times): " +
        "; ".join(f"{k} {v['ms']:.3f} ms from idle, {v['chained_ms']:.3f} ms "
                  f"a step in a row, busy {v['busy']:.1%}, covered "
                  f"{v['covered']:.1%} of a {v['span_us']:.1f} us span, "
                  f"median gap {v['gap_us']:.3f} us, host {v['host_ms']:.3f} "
                  "ms a step enqueued in a row"
                  for k, v in steps.items()) + " | P4 us/group, stream vs "
        "graph replay: " + "; ".join(
            f"{k} stream " + ", ".join(f"{t:.2f}" for t in v["stream"]) +
            " graph " + ", ".join(f"{t:.2f}" for t in v["graph"])
            for k, v in floors.items())))
    return {"steps": steps, "floors": floors}


# Phase 15b's back-to-back runs (graph_stress): every walk and star mode at
# d 128 and again at d 256, past MAX_DIM (192), through the wide passes.
B2B_MODES = ("K1", "K1b", "K2", "K2b", "K3", "K4", "K5")
B2B_WIDE = B2B_MODES


def _b2b_inputs(mode, dev, g, step, V, W, KP, R, B, csr):
    """One back-to-back step's inputs, drawn anew from ``g``: K1, K1b and
    K3 walks, window draws and pools (_graph_step_inputs), K2 and K2b star
    rows; K5 rows of random edges; K4 starts, 32-bit draws, window draws
    and pools (its walks are made in the step).  B walks (rows) of 80, a
    pool every R groups; K1b's walks are walked on ``csr``."""
    from come_tpu_torch.ops.walk_sgns import NWL
    from come_tpu_torch.sampling import random_walks

    base = {"K1b": "K1", "K2b": "K2"}.get(mode, mode)
    if base in ("K2", "K3"):
        return _graph_step_inputs(base, dev, g, step, V, W, KP, csr)
    L = 80
    G = B // 8
    pools = torch.randint(0, V, (-(-G // R), KP), generator=g, device=dev,
                          dtype=torch.int32)
    if base == "K1":
        walks = (random_walks(csr, torch.randint(0, V, (B,), generator=g,
                                                 device=dev), L, g)
                 if mode == "K1b" else
                 torch.randint(0, V, (B, L), generator=g, device=dev,
                               dtype=torch.int32))
        wrow = torch.randint(1, W + 1, (G * NWL,), generator=g, device=dev,
                             dtype=torch.int32)
        return walks, wrow, pools
    if mode == "K5":
        return edge_rows(g, V, B, dev), pools
    starts = torch.randint(0, V, (B,), generator=g, device=dev,
                           dtype=torch.int32)
    bits = torch.randint(-2**31, 2**31, (G * NWL,), generator=g, device=dev,
                         dtype=torch.int32)
    wrow = torch.randint(1, W + 1, (G * NWL,), generator=g, device=dev,
                         dtype=torch.int32)
    return starts, bits, wrow, pools


def graph_stress(mode: str, dev, d: int = 128, n: int = 8) -> list:
    """``n`` steps of ``mode`` (B2B_MODES) through one launch plan enqueued
    back to back, with no host wait between them: lr, the SR seed, the
    walks (edge rows, star rows; K4's starts and draws), window draws and
    pools new at every step, all drawn on the card before the first step,
    so a pass that read an input of the step before would update other
    rows.  The tables after each step are snapshot on the card; the plain
    versions then run from each snapshot, and each step is held against
    its own under its mode's check (f32, bf16 or K3's; K4's walks bit for
    bit); every step must take the band or star route that
    :func:`expected_route` names.  Returns each step's (max_abs, f32
    relative error, bf16 relative L2 error or K3 identical share, bf16
    f32-vs-bf16 distance; nan where the mode has none; the route); raises
    at the first step past its check."""
    from come_tpu_torch.graphs import get_dataset, sbm_graph
    from come_tpu_torch.ops.star_sgns import (
        star_sgns_step,
        star_sgns_step_reference,
    )
    from come_tpu_torch.ops.tolerance import check_k3
    from come_tpu_torch.ops.walk_sgns import (
        walk_sgns_gen_step,
        walk_sgns_gen_step_reference,
        walk_sgns_step,
        walk_sgns_step_reference,
    )

    # K1b and K4 walk the blogcatalog graph at phase 3's shape (KP 512, R
    # 1; 64 walks): on random walks of a V 2000 graph their f32 step lay
    # 6.4e-4 to 7.6e-4 from the bf16 step (H100), under the 2 x BF16_L2
    # the bf16 check needs to tell the two apart (phase 3b reads 1.3e-3)
    V, W, L = (20000 if mode == "K3" else 2000), 10, 80
    B, KP, R = (64, 512, 1) if mode in ("K1b", "K4") else (40, 100, 2)
    csr = None
    if mode == "K3":
        graph, _ = sbm_graph(V, 16, p_in=0.1, p_out=0.002, seed=V,
                             avg_degree=40)
        csr = graph.to_device(dev)
    elif mode in ("K1b", "K4"):
        graph = get_dataset("blogcatalog").graph
        V, csr = graph.num_nodes, graph.to_device(dev)
    g = torch.Generator(device=dev).manual_seed(11 + d)
    tabs = [torch.randn((V, d), generator=g, device=dev) * 0.1
            for _ in range(1 if mode in ("K2", "K2b") else 2)]
    if mode == "K3":
        tabs = [t.to(torch.bfloat16) for t in tabs]
    bf16 = mode in ("K1b", "K2b", "K4")
    inputs = [_b2b_inputs(mode, dev, g, step, V, W, KP, R, B, csr)
              for step in range(n)]

    def run(fn, tables, x, step, plain=False, mxu=bf16, seed=True):
        lr, negw = 0.025 * (1.0 + 0.05 * step), 5.0 / KP
        if mode in ("K2", "K2b"):
            return fn(*tables, *x, lr, negw, mxu_bf16=mxu, pool_refresh=1)
        kw = dict(pool_refresh=R)
        kw.update(window=1 if mode == "K5" else W, mxu_bf16=mxu)
        if mode == "K3" and seed:
            kw["sr_seed"] = 1000 + step
        if mode == "K5":
            return fn(*tables, x[0], None, x[1], lr, negw, paired=True, **kw)
        if mode == "K4":
            return fn(*tables, x[0], x[1], csr.indptr, csr.indices, x[2],
                      x[3], lr, negw, walk_length=L, return_walks=True,
                      **kw)
        return fn(*tables, *x, lr, negw, **kw)

    kern_fn, plain_fn = {
        "K2": (star_sgns_step, star_sgns_step_reference),
        "K2b": (star_sgns_step, star_sgns_step_reference),
        "K4": (walk_sgns_gen_step, walk_sgns_gen_step_reference),
    }.get(mode, (walk_sgns_step, walk_sgns_step_reference))
    from come_tpu_torch.ops import build, launch_plan
    from come_tpu_torch.tools.pass_times import routes_since

    entry = {"K2": "star_sgns", "K2b": "star_sgns",
             "K4": "walk_sgns_gen"}.get(mode, "walk_sgns")
    launch_plan.release_plans(build.library(), entry)
    c0 = launch_plan.graph_counts()[entry]
    torch.cuda.synchronize()  # every input on the card before the first step
    states, results = [[t.clone() for t in tabs]], []
    before = routes_since()
    for step, x in enumerate(inputs):
        results.append(run(kern_fn, tabs, x, step))
        states.append([t.clone() for t in tabs])
    torch.cuda.synchronize()
    routes = routes_since(before)
    want = expected_route(mode, d, dict(window=1 if mode == "K5" else W,
                                        paired=mode == "K5"), L)
    if routes != [want] * n:
        raise AssertionError(f"back-to-back {mode} d {d}: routes {routes}, "
                             f"expected {want}")
    c1 = launch_plan.graph_counts()[entry]
    # one fresh plan, recorded once (its tables stay put), replayed n times
    if tuple(c1[k] - c0[k] for k in ("replays", "recordings",
                                     "instantiations")) != (n, 1, 1):
        raise AssertionError(f"back-to-back {mode} d {d}: graph counters "
                             f"{c0} -> {c1}")
    errs = []
    for step, x in enumerate(inputs):
        name = f"back-to-back {mode} d {d} step {step}"
        before, after = states[step], states[step + 1]
        res = results[step]
        if mode == "K4":
            *res, walks = res
            plain = run(plain_fn, [t.clone() for t in before], x, step)
            if not torch.equal(walks.cpu(), plain[-1].cpu()):
                raise AssertionError(f"{name}: generated walks differ")
            plain = plain[:-1]
        else:
            plain = run(plain_fn, [t.clone() for t in before], x, step)
        kern = (*after, *res[-2:])
        if mode == "K3":
            f32 = run(plain_fn, [t.float() for t in before], x, step,
                      mxu=True, seed=False)
            if float(kern[3]) != float(plain[3]) or abs(
                    float(kern[2]) - float(plain[2])) > 1e-4 * abs(
                        float(plain[2])):
                raise AssertionError(f"{name}: loss {float(kern[2])} vs "
                                     f"{float(plain[2])}, pairs "
                                     f"{float(kern[3])} vs {float(plain[3])}")
            err = check_k3(name, before, kern[:2], plain[:2], f32[:2])
            errs.append((err[0], float("nan"), err[3], float("nan"), want))
        elif bf16:
            f32 = run(plain_fn, [t.clone() for t in before], x, step,
                      mxu=False)
            if mode == "K4":
                f32 = f32[:-1]
            err = compare_bf16(name, before, kern, plain, f32[:-2])
            errs.append((err[0], float("nan"), err[1], err[2], want))
        else:
            err = compare(name, before, kern, plain)
            errs.append((err[0], err[1], float("nan"), float("nan"), want))
    return errs


def stress_text(runs: dict) -> str:
    """The back-to-back runs' worst errors by mode and width."""
    out = []
    for (mode, d), errs in runs.items():
        worst = max(e[0] for e in errs)
        if mode == "K3":
            tail = f"identical >= {min(e[2] for e in errs):.5f}"
        elif mode in ("K1b", "K2b", "K4"):
            tail = (f"rel_l2 {max(e[2] for e in errs):.3e}, f32-vs-bf16 "
                    f"distance >= {min(e[3] for e in errs):.3e}")
        else:
            tail = f"max_rel {max(e[1] for e in errs):.3e}"
        out.append(f"{mode} d {d}: {len(errs)} steps, {errs[0][4]} route, "
                   f"max_abs {worst:.3e}, {tail}")
    return "; ".join(out)


# Phase 4j's widths past 128 (phase 4k holds the main path's steps at 256
# at their own shapes): past MAX_DIM (192) the band and star passes hold
# whole rows where they fit (at W 10 every mode to 512 but K2 past d 440)
# and stage column slabs of 128 (csrc/sgns_common.cuh: SLAB) where they do
# not (the whole walk W 127 in f32 at 256 and past), so 193 leaves a
# ragged 16-byte piece or slab, 300 a ragged last slab of 44 and 512 four
# whole ones; the negative passes hold rows whole up to NEG_WHOLE (256)
# and take slabs of 256 past it, so 256 is their widest whole width, 257 (K3: 258)
# the narrowest in slabs and 300 a ragged last slab; 129 runs the whole-row
# passes at a ragged width.  K1 (W 10 and a whole-walk window), K5 and K2
# run at every width of WIDE_WIDTHS (the whole walk alone at 256), the
# other modes at WIDE_MODE_WIDTHS.
WIDE_WIDTHS = (129, 193, 256, 257, 300, 512)
WIDE_CASES = (("K1", False), ("K1", True), ("K5", False), ("K2", False))
WIDE_MODES = ("K1b", "K3", "K4", "K4 f32", "K2b", "K6", "K7")
WIDE_MODE_WIDTHS = (193, 256, 257, 300, 512)
ROUTE_EDGE = (257,)  # checked, not timed: 256 and 300 time both routes
# The bf16 rows past what a CTA holds whole, which take column slabs
# (walk_pos_slab_kernel<true, ...>, star_pos_slab_kernel<true>): the band
# with the whole walk of 128 in the window at d 512 (K3: 514; bf16 rows fit
# whole there up to W 47), the star pass past d 880; (mode, d).
BF16_SLAB = (("K1b", 512), ("K4", 512), ("K3", 514), ("K2b", 884))
# Phase 4l's steps (tools/pass_times.py) whose passes it times at d 256:
# the f32 negative pass in K1 and K6, the bf16 one in K1b, K2b and K3
PASS_STEPS_256 = ("K1", "K1b bench", "K2b bench", "K6", "K3")


def mode_width(mode, d):
    """d, or the even width above it for K3's bf16 tables."""
    return d + d % 2 if mode == "K3" else d


def edge_rows(g, V, n, dev):
    """[n, 128] int32 K5 rows: 64 random edges (u, v != u) of V nodes a
    row, drawn from ``g``."""
    u = torch.randint(0, V, (n * 64,), generator=g, device=dev)
    v = (u + 1 + torch.randint(0, V - 1, u.shape, generator=g,
                               device=dev)) % V
    return torch.stack([u, v], 1).reshape(n, 128).to(torch.int32)


def wide_inputs(mode, dev, d, seed, whole=False, csr=None, window=None):
    """(tables, inputs, kwargs) of one step of ``mode`` at width d, drawn
    from ``seed``, pools of 512 rows: K1 over 64 walks of 80 on V 2000 at
    W 10 (8 groups), or with ``whole`` 16 walks of 128 with the whole walk
    in the window (W 127); K1b, K4 and "K4 f32" over 64 walks of 80 (with
    ``whole`` 64 of 128) on the blogcatalog graph ``csr`` (K4 generates
    them from starts and 32-bit draws), as graph_stress draws them: on
    random walks of V 2000 their f32 step lies too near the bf16 one for
    the bf16 check; K3 over 64 walks of 80 drawn uniformly over V 20000
    (rows that repeat rarely, as its check needs) on bf16 tables, with
    stochastic rounding; K5 over 16
    edge rows (2 groups, R 2); K2 and K2b over the star layout of 12000
    random edges on V 2000; K6 and K7 3000 pairs on V 2000 in tiles of 777
    (the second tile all masked).  ``window`` sets W of ``whole``'s walks
    of 128 (the band pass's route boundary)."""
    V = 20000 if mode == "K3" else 2000
    if mode in ("K1b", "K4", "K4 f32"):
        V = int(csr.indptr.numel()) - 1
    g = torch.Generator(device=dev).manual_seed(seed)
    tabs = [torch.randn((V, d), generator=g, device=dev) * 0.1
            for _ in range(1 if mode in ("K2", "K2b", "K7") else 2)]
    if mode == "K3":
        tabs = [t.to(torch.bfloat16) for t in tabs]
    KP = 512

    def ids(*shape):
        return torch.randint(0, V, shape, generator=g, device=dev,
                             dtype=torch.int32)

    if mode in ("K2", "K2b"):
        slots, meta = star_edge_layout(V, 12000, "random", seed)
        sl, mt = (torch.as_tensor(a, device=dev) for a in (slots, meta))
        return tabs, (sl, mt, ids(-(-sl.numel() // 1024), KP)), dict(
            pool_refresh=1, mxu_bf16=mode == "K2b")
    if mode == "K5":
        return tabs, (edge_rows(g, V, 16, dev), None, ids(1, KP)), dict(
            window=1, pool_refresh=2, paired=True)
    if mode in ("K6", "K7"):
        P, TP = 3000, 777
        m = (torch.rand(P, generator=g, device=dev) < 0.6).float()
        m[TP:2 * TP] = 0.0
        return tabs, (ids(P), ids(P), ids(KP), m), dict(tile_pairs=TP)
    B, L, W = (16, 128, window or 127) if whole else (64, 80, 10)
    if whole and mode in ("K1b", "K4", "K4 f32"):
        B = 64
    wrow = torch.randint(1, W + 1, (B // 8 * 1024,), generator=g, device=dev,
                         dtype=torch.int32)
    kw = dict(window=W, pool_refresh=1)
    if mode in ("K4", "K4 f32"):
        bits = torch.randint(-2**31, 2**31, (B // 8 * 1024,), generator=g,
                             device=dev, dtype=torch.int32)
        return tabs, (ids(B), bits, csr.indptr, csr.indices, wrow,
                      ids(B // 8, KP)), dict(kw, walk_length=L,
                                             mxu_bf16=mode == "K4")
    if mode == "K1b":
        from come_tpu_torch.sampling import random_walks

        walks = random_walks(csr, ids(B), L, g)
        return tabs, (walks, wrow, ids(B // 8, KP)), dict(kw, mxu_bf16=True)
    if mode == "K3":
        kw["sr_seed"] = seed
    return tabs, (ids(B, L), wrow, ids(B // 8, KP)), kw


def _mode_fns(mode):
    """(kernel, plain version) of a step_check mode."""
    from come_tpu_torch.ops.sgns import (
        fused_sgns_step,
        fused_sgns_step_reference,
        fused_sgns_step_tied,
        fused_sgns_step_tied_reference,
    )
    from come_tpu_torch.ops.star_sgns import (
        star_sgns_step,
        star_sgns_step_reference,
    )
    from come_tpu_torch.ops.walk_sgns import (
        walk_sgns_gen_step,
        walk_sgns_gen_step_reference,
        walk_sgns_step,
        walk_sgns_step_reference,
    )

    if mode in ("K2", "K2b"):
        return star_sgns_step, star_sgns_step_reference
    if mode in ("K4", "K4 f32"):
        return walk_sgns_gen_step, walk_sgns_gen_step_reference
    if mode == "K6":
        return fused_sgns_step, fused_sgns_step_reference
    if mode == "K7":
        return fused_sgns_step_tied, fused_sgns_step_tied_reference
    return walk_sgns_step, walk_sgns_step_reference


def expected_route(mode, d, kw, L=None) -> str | None:
    """The band or star route a step of ``mode`` at width d with the
    wrapper's keywords ``kw`` takes by the kernel library's rule
    (``come_walk_pos_route``, ``come_star_pos_route``: rows up to d 192,
    whole rows where they fit, column slabs past); None for K6 and K7,
    which have neither pass.  L is the walk length (the walks' width, or
    K4's walk_length)."""
    from come_tpu_torch.ops import build
    from come_tpu_torch.ops.walk_sgns import POS_ROUTES

    if mode in ("K6", "K7"):
        return None
    lib = build.library()
    if mode in ("K2", "K2b"):
        return POS_ROUTES[lib.come_star_pos_route(d, int(mode == "K2b"))]
    paired = kw.get("paired", False)
    return POS_ROUTES[lib.come_walk_pos_route(
        d, kw.get("walk_length", L), 1 if paired else kw["window"],
        int(mode in ("K1b", "K4")), int(paired), int(mode == "K3"))]


def path_routes(where: str, want: str | None = None) -> dict:
    """The walk and star steps since the wrappers' ``routes`` counters
    were last reset, by band or star route (over every mode); raises if a
    step took another route than ``want``."""
    from come_tpu_torch.ops.walk_sgns import new_routes
    from come_tpu_torch.tools.pass_times import routes_since

    tot = new_routes()
    for r in routes_since([new_routes()] * 3):
        tot[r] += 1
    if want is not None and any(n for r, n in tot.items() if r != want):
        raise AssertionError(f"{where}: steps by route {tot}, expected "
                             f"every one {want}")
    return tot


def step_check(mode, name, tabs, x, kw, timed=True, route=None) -> dict:
    """One step of ``mode`` (K1, K1b, K3, K4 with bf16 products, "K4 f32",
    K5, K2, K2b, K6, K7) on tables ``tabs`` and inputs ``x`` (as the
    wrapper takes them after the tables: walks, edge rows, star slots, K4's
    starts and draws or K6/K7's pairs, ...; the pools last, K6/K7's pool
    third) through the kernel and its plain version from the same tables,
    under its mode's check: the f32 check, the bf16 check (K1b, K2b, K4:
    the plain f32 step at least 5x farther) or K3's (ops/tolerance.py), K4's
    walks bit for bit; the band or star route the kernel's step took must
    be ``route`` (default :func:`expected_route`'s); with ``timed`` also ms
    from an idle card, ms a step in a run of 10 and the plain version's ms
    (each on tables it updates in place) and the step's bound.  Returns the
    numbers: "err" is the check's tuple, its first element the max abs
    update error; "route" the route taken."""
    from come_tpu_torch.ops.tolerance import check_k3
    from come_tpu_torch.sampling.stars import PAD_META
    from come_tpu_torch.tools.pass_times import (
        chained_ms,
        cuda_ms,
        routes_since,
    )

    kern_fn, plain_fn = _mode_fns(mode)
    fused, gen = mode in ("K6", "K7"), mode in ("K4", "K4 f32")
    bf16 = mode in ("K1b", "K2b", "K4")
    KP = x[2].numel() if fused else x[-1].shape[-1]
    lr, negw = 0.025, 5.0 / KP
    if gen:
        kw = dict(kw, return_walks=True)
    if route is None:
        route = expected_route(mode, tabs[0].shape[1], kw,
                               None if fused or gen else x[0].shape[-1])
    before = routes_since()
    kern = kern_fn(*[t.clone() for t in tabs], *x, lr, negw, **kw)
    took = routes_since(before)
    took = took[0] if len(took) == 1 else None
    if took != route:
        raise AssertionError(f"{name}: took the {took} route, expected "
                             f"{route}")
    plain = plain_fn(*[t.clone() for t in tabs], *x, lr, negw, **kw)
    torch.cuda.synchronize()
    walks = x[0]
    if gen:
        *kern, walks = kern
        *plain, pw = plain
        if not torch.equal(walks, pw):
            raise AssertionError(f"{name}: generated walks differ")
    if mode == "K3":
        if float(kern[3]) != float(plain[3]) or abs(
                float(kern[2]) - float(plain[2])) > 1e-4 * abs(float(plain[2])):
            raise AssertionError(f"{name}: loss {float(kern[2])} vs "
                                 f"{float(plain[2])}, pairs {float(kern[3])} "
                                 f"vs {float(plain[3])}")
        f32kw = {k: v for k, v in kw.items() if k != "sr_seed"}
        f32 = plain_fn(*[t.float() for t in tabs], *x, lr, negw,
                       mxu_bf16=True, **f32kw)
        err = check_k3(name, tabs, kern[:2], plain[:2], f32[:2])
    elif bf16:
        f32 = plain_fn(*[t.clone() for t in tabs], *x, lr, negw,
                       **dict(kw, mxu_bf16=False))
        err = compare_bf16(name, tabs, kern, plain, f32[:len(tabs)])
    else:
        err = compare(name, tabs, kern, plain)
    out = {"err": err, "pairs": float(kern[-1]), "route": took}
    del kern, plain
    if timed:
        d = tabs[0].shape[1]
        work, pwork = [t.clone() for t in tabs], [t.clone() for t in tabs]

        def step():
            kern_fn(*work, *x, lr, negw, **kw)

        out["ms"], out["run_ms"] = cuda_ms(step), chained_ms(step)
        out["plain_ms"] = cuda_ms(lambda: plain_fn(*pwork, *x, lr, negw,
                                                   **kw))
        if mode in ("K2", "K2b"):
            out["bound"] = star_bound(x[0], x[1], x[2], out["pairs"], d, bf16,
                                      PAD_META)
        elif fused:
            out["bound"] = pairs_bound(x[0], x[1], x[3], x[2], d,
                                       mode == "K7")
        elif gen:  # K4 also reads starts, and per hop two offsets and one
            B, L = walks.shape  # neighbour
            out["bound"] = walk_bound(walks, x[-1], out["pairs"], d, 4, bf16,
                                      4.0 * B + 12.0 * B * (L - 1))
        else:
            out["bound"] = walk_bound(walks, x[2], out["pairs"], d,
                                      2 if mode == "K3" else 4,
                                      bf16 or mode == "K3")
    return out


def step_times(res: dict) -> str:
    """The times of step_check results ``res`` by label."""
    return "; ".join(
        f"{k}: {r['ms']:.3f} ms from idle, {r['run_ms']:.3f} ms a step in a "
        f"run, plain {r['plain_ms']:.3f} ms, bound {r['bound'][0]:.4f} ms by "
        f"{r['bound'][1]}" for k, r in res.items() if "ms" in r)


def err_text(mode, err) -> str:
    """A step_check error tuple as its mode's check reads it."""
    if mode == "K3":
        return (f"max_abs {err[0]:.3e} rel_l2 {err[1]:.3e} identical "
                f"{err[3]:.5f}")
    if mode in ("K1b", "K2b", "K4"):
        return (f"max_abs {err[0]:.3e} rel_l2 {err[1]:.3e} f32-vs-bf16 "
                f"distance {err[2]:.3e}")
    return f"max_abs {err[0]:.3e} max_rel {err[1]:.3e}"


def bf16_slab_check(mode, d, dev, csr) -> dict:
    """One BF16_SLAB step (the band's with the whole walk of 128 in the
    window, K2b's on wide_inputs' star layout) through step_check, which
    fails it unless it took the slab route."""
    walk = mode != "K2b"
    return step_check(mode, f"{mode} d {d}" + (" whole walk" if walk else ""),
                      *wide_inputs(mode, dev, d, 5 * d + len(mode), whole=walk,
                                   csr=csr), timed=False, route="slab")


def wide_phase(smi: str, dev) -> dict:
    """Phase 4j (module docstring); raises if a step fails its check.
    Returns the checks by (mode, whole, d)."""
    from come_tpu_torch.graphs import get_dataset

    csr = get_dataset("blogcatalog").graph.to_device(dev)
    res = {}
    for d in WIDE_WIDTHS:
        for mode, whole in WIDE_CASES:
            if d == 256 and not whole:
                continue  # phase 4k's, at the main path's shapes
            name = f"{mode} d {d}" + (" whole walk" if whole else "")
            res[(mode, whole, d)] = step_check(
                mode, name, *wide_inputs(mode, dev, d, 3 * d + 2 * whole
                                         + (mode == "K5"), whole),
                timed=not whole and d not in ROUTE_EDGE)
    for d in WIDE_MODE_WIDTHS:
        for mode in WIDE_MODES:
            dm = mode_width(mode, d)
            res[(mode, False, dm)] = step_check(
                mode, f"{mode} d {dm}", *wide_inputs(
                    mode, dev, dm, 3 * dm + len(mode), csr=csr),
                timed=d not in ROUTE_EDGE)
    # the band pass's route boundary at d 256 on walks of 128: the last W
    # whose f32 rows fit in shared memory holds them whole, the next takes
    # column slabs, and so does the whole walk (W 127)
    fit = route_boundary(256)
    edge = {}
    for W, route in ((fit, "whole"), (fit + 1, "slab"), (127, "slab")):
        edge[f"K1 d 256 W {W}"] = step_check(
            "K1", f"K1 d 256 W {W} of 128", *wide_inputs(
                "K1", dev, 256, 7 * W, whole=True, window=W),
            timed=False, route=route)
    slab = {f"{m} d {d}": bf16_slab_check(m, d, dev, csr)
            for m, d in BF16_SLAB}
    routes = {}
    for (m, w, d), r in res.items():
        routes.setdefault(r["route"], []).append(
            f"{m}{' whole walk' if w else ''} d {d}")
    for k, r in {**edge, **slab}.items():
        routes.setdefault(r["route"], []).append(k)
    worst = "; ".join(
        f"{m}{' whole walk' if w else ''} worst "
        + err_text(m, max((r["err"] for k, r in res.items() if k[:2] == (m, w)),
                          key=lambda e: e[0]))
        for m, w in WIDE_CASES + tuple((m, False) for m in WIDE_MODES))
    phase("wide", f"K1 (W 10 and a whole-walk window), K5 and K2 on V 2000 "
                  f"at d in {list(WIDE_WIDTHS)} (256: the whole walk only), "
                  f"{', '.join(WIDE_MODES)} at d in {list(WIDE_MODE_WIDTHS)} "
                  f"(K3 at the even width) vs plain under each mode's check "
                  f"(f32: tol {ATOL} + {RTOL}*|plain update|): {worst} | "
                  f"route boundary at d 256, walks of 128 (K1, f32): "
                  + "; ".join(f"{k} {err_text('K1', r['err'])} {r['route']}"
                              for k, r in edge.items())
                  + " | bf16 rows in slabs (the band with the whole walk of "
                  "128): " + "; ".join(
                      f"{k} {err_text(k.split()[0], r['err'])} {r['route']}"
                      for k, r in slab.items())
                  + " | routes: " + "; ".join(
                      f"{k}: {', '.join(v)}" for k, v in routes.items())
                  + " | " + step_times({f"{m} d {d}": r for (m, w, d), r in
                                        res.items()}) + f" | {smi}")
    return res


def route_boundary(d: int, L: int = 128) -> int:
    """The largest window W whose f32 band rows fit whole at width d on
    walks of L, by the kernel library's rule (come_walk_pos_route); W + 1
    takes slabs."""
    from come_tpu_torch.ops import build

    lib = build.library()
    fits = [W for W in range(1, L)
            if lib.come_walk_pos_route(d, L, W, 0, 0, 0) == 1]
    if not fits or fits[-1] == L - 1:
        raise AssertionError(f"no route boundary at d {d}, L {L}: {fits}")
    return fits[-1]


def passes_phase(smi: str, dev, d: int = 256) -> dict:
    """Phase 4l: the device µs a group (a tile for K6) of each pass of
    tools/pass_times.py's PASS_STEPS_256 at width d, beside one group's
    negative pass as three PyTorch products (``library3_ms``, a yardstick
    the port never calls).  Returns {step: (split, library3 ms)}."""
    from come_tpu_torch.tools import pass_times as pt

    res = {}
    for name, step, groups, passes, _, KP in pt.steps(dev, d):
        if name not in PASS_STEPS_256:
            continue
        split, _ = pt.pass_split(step, groups, passes)
        res[name] = (split, pt.library3_ms(dev, pt.pass_slots(name), KP, d,
                                           name in pt.BF16_PASS))
    torch.cuda.empty_cache()
    phase("passes 256", f"device us a group (K6: a tile) by pass at d {d} "
                        "(tools/pass_times.py), and the negative pass as "
                        "three PyTorch products: " + "; ".join(
                            f"{k}: {pt.split_text(v[0])}; three calls "
                            f"{v[1] * 1e3:.2f}" for k, v in res.items())
          + f" | {smi}")
    return res


def blog_wide_checks(dev, steps: dict, V: int, d: int = 256) -> dict:
    """Phase 4k: each step of ``steps`` ({label: (mode, inputs, kwargs)},
    the main path's inputs) on [V, d] tables drawn from SEED (bf16 for
    K3), through step_check (its mode's check, times and bound).  Returns
    the checks by label."""
    g = torch.Generator(device=dev).manual_seed(SEED + d)
    res = {}
    for label, (mode, x, kw) in steps.items():
        tabs = [torch.randn((V, d), generator=g, device=dev) * 0.1
                for _ in range(1 if mode in ("K2", "K2b", "K7") else 2)]
        if mode == "K3":
            tabs = [t.to(torch.bfloat16) for t in tabs]
        res[label] = step_check(mode, f"{label} d {d}", tabs, x, kw)
        del tabs
    return res


def wide_text(res: dict) -> str:
    """Phase 4k's line: each check's error, pairs and band or star route,
    then the times."""
    return ("; ".join(f"{k} {err_text(k.split()[0], r['err'])} pairs "
                      f"{r['pairs']:.0f} route {r['route']}"
                      for k, r in res.items())
            + " | " + step_times(res))


def _torchrun(tag, n, module, args, timeout):
    """``python -m torch.distributed.run --standalone`` of ``module`` on
    ``n`` ranks, each writing ``rank<r>.json`` to a temporary directory, in
    a session of its own, so a run past its time is stopped with every
    rank the launcher started.  Returns the ranks' records; raises if the
    run fails."""
    import tempfile

    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--standalone", "--nproc-per-node", str(n), "-m", module,
               "--out", tmp] + args
        env = dict(os.environ, PYTHONPATH=str(root))
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, cwd=root,
                                env=env, start_new_session=True)
        try:
            out, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.communicate()
            raise
        if proc.returncode != 0:
            raise AssertionError(f"{tag} exited {proc.returncode}:\n"
                                 f"{out[-3000:]}\n{err[-6000:]}")
        return [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                for r in range(n)]


def dp_phase(main_o1_ms: float, V: int, d: int) -> None:
    """Phase 18 (module docstring): runs (a), (b) and, on two or more
    cards at d 128, (c) of tools/dp_check.py with the tables d wide
    (``main_o1_ms``: the one-card O1 epoch at d, phase 5 or 5b); raises if
    a rank fails or a check does not hold."""
    w = "" if d == 128 else f" {d}"
    runs = [("a" + w, 1, "nccl", None), ("b" + w, 2, "gloo", "cuda:0")]
    if torch.cuda.device_count() >= 2 and d == 128:
        runs.append(("c", 2, "nccl", None))
    # past d 128 at WALKS_CUT walks a node: the depth cut that keeps the
    # script in its time (the gloo run's O1 epochs took most of its 85 s at
    # the preset's 10)
    cut = [] if d == 128 else ["--walks-per-node", str(WALKS_CUT)]
    allowed = {"walk_sgns", "star_sgns"}
    for tag, n, backend, device in runs:
        args = ["--backend", backend, "--dim", str(d)] + cut + (
            ["--device", device] if device else [])
        ranks = _torchrun(f"dp run ({tag})", n,
                          "come_tpu_torch.tools.dp_check", args, 600)
        for r in ranks:
            if r["nmi"] < NMI_FLOOR:
                raise AssertionError(f"dp ({tag}) rank {r['rank']}: NMI "
                                     f"{r['nmi']:.4f} < {NMI_FLOOR}")
            for k, v in r["launches"].items():
                if (v == 0) == (k in allowed):
                    raise AssertionError(f"dp ({tag}) rank {r['rank']} "
                                         f"launched {k} {v} times")
            if (r["o1_tier"], r["o2_tier"]) != ("walk-kernel-dp",
                                                "star-o2-dp"):
                raise AssertionError(f"dp ({tag}): tiers {r['o1_tier']}, "
                                     f"{r['o2_tier']}")
            graph_line(f"dp ({tag}) rank {r['rank']}", r["graphs"])
        hashes = {(r["hash"], r["hash_after"]) for r in ranks}
        if len(hashes) != 1:
            raise AssertionError(f"dp ({tag}): replicas differ: {hashes}")
        r0 = ranks[0]
        steps = r0["o1_steps"]
        h = [x["held"] for x in ranks]
        held = (" | held dp steps (worst over ranks): K1 f32 ratio "
                f"{max(x['K1']['f32_ratio'] for x in h):.3f}, K2 "
                f"{max(x['K2']['f32_ratio'] for x in h):.3f}, K5 "
                f"{max(x['K5']['f32_ratio'] for x in h):.3f} (<= 1); K3 "
                f"identical {min(x['K3']['identical'] for x in h):.5f}, "
                f"rel_l2 {max(x['K3']['rel_l2'] for x in h):.3e}, its "
                f"snapshot and reduction of the two 500000 x {d} tables "
                f"{h[0]['K3']['rule_ms']:.3f} ms (rank 0)")
        if any("f64_ratio" in x["K1"] for x in h):
            held += " (K1 by the float64 rule)"
        if "o1_ab_ms" in r0:
            ab = r0["o1_ab_ms"]
            held += (" | O1 epochs in turns, same process and table: "
                     "one-device " + ", ".join(f"{x:.1f}" for x in
                                               ab["single"])
                     + " ms; dp " + ", ".join(f"{x:.1f}" for x in ab["dp"])
                     + " ms")
        note = (" [gloo stages the card's tensors through the host: "
                "correctness, not speed]" if backend == "gloo" else "")
        phase(f"dp {tag}", (
            f"world {n} {backend} on {sorted({r['device'] for r in ranks})}: "
            f"NMI {min(r['nmi'] for r in ranks):.4f} | o1 epoch in the run "
            f"{max(r['o1_ms'] for r in ranks):.1f} ms at "
            f"{WALKS_CUT if cut else 10} walks a node (one card without "
            f"dp at d {d}, 10 walks: {main_o1_ms:.1f} ms), extra epoch "
            f"{max(r['epoch_ms'] for r in ranks):.1f} ms, all-reduce "
            f"{r0['allreduce_ms'] / steps:.4f} ms per step (CUDA events, "
            f"rank 0, {steps} steps) and {r0['allreduce_bytes'] / steps:.0f}"
            f" B per step (2 x V x d x 4 = {2 * V * d * 4}) | gmm "
            f"{r0['gmm_ms']:.1f} ms (warm, rank 0: distributed EM "
            f"{r0['gmm_ab_ms']['sharded']:.1f} ms, one-device EM "
            f"{r0['gmm_ab_ms']['single']:.1f}), o2 {r0['o2_ms']:.1f} ms | "
            f"replicas "
            f"bit-identical (sha256 {r0['hash']}, {r0['hash_after']}) | "
            f"launches per rank {[r['launches'] for r in ranks]} | graphs, "
            f"rank 0: {graph_line('dp', r0['graphs'])}" + held + note))


def rs_phase(main_o1_ms: float, d: int = 128) -> None:
    """Phase 19 (module docstring): runs (a), (b) and, on two or four
    cards at d 128, (c) of tools/rs_check.py with the tables d wide
    (``main_o1_ms``: the one-card O1 epoch at d; (a) and (b) at WALKS_CUT
    walks a node, and the synthetic-10m step of (a) at d 128 only); raises
    if a rank fails or a check does not hold."""
    w = "" if d == 128 else f" {d}"
    # three O1 epochs over gloo-host took most of the script's time: at
    # WALKS_CUT walks a node (the preset's 10) a run reads 61-104 s (113-122
    # s at 10, and at d 256 119 s with 5), and past d 128, where the
    # staged rows double, no synthetic-10m step
    cut = ["--walks-per-node", str(WALKS_CUT)]
    runs = [("a" + w, (1, 2), "gloo", "cuda:0",
             cut + (["--synthetic"] if d == 128 else [])),
            ("b" + w, (2, 2), "gloo", "cuda:0", cut)]
    cards = torch.cuda.device_count()
    for mesh in ((1, 2), (2, 2)):
        if cards >= mesh[0] * mesh[1] and d == 128:
            runs.append((f"c {mesh}", mesh, "nccl", None, []))
    allowed = {"walk_sgns", "walk_sgns_paired"}
    for tag, (D, M), backend, device, extra in runs:
        t0 = time.perf_counter()
        args = ["--mesh", f"{D},{M}", "--backend", backend, "--dim",
                str(d)] + extra
        if device:
            args += ["--device", device]
        ranks = _torchrun(f"rs run ({tag})", D * M,
                          "come_tpu_torch.tools.rs_check", args, 600)
        secs = time.perf_counter() - t0
        way = "gloo-host" if backend == "gloo" else "nccl"
        for r in ranks:
            who = f"rs ({tag}) rank {r['rank']}"
            if r["nmi"] < NMI_FLOOR:
                raise AssertionError(f"{who}: NMI {r['nmi']:.4f}")
            for k, v in r["launches"].items():
                if (v == 0) == (k in allowed):
                    raise AssertionError(f"{who} launched {k} {v} times")
            if (r["o1_tier"], r["o2_tier"]) != (
                    "walk-kernel-rowsharded",
                    "walk-kernel-paired-rowsharded"):
                raise AssertionError(f"{who}: tiers {r['o1_tier']}, "
                                     f"{r['o2_tier']}")
            if min(r["o1_served"], r["o2_served"]) < 0.999:
                raise AssertionError(f"{who}: served {r['o1_served']}, "
                                     f"{r['o2_served']}")
            graph_line(who, r["graphs"])
            for ep in ("o1", "o2"):
                if r[ep]["transport"] != way:
                    raise AssertionError(f"{who}: {ep} exchange over "
                                         f"{r[ep]['transport']}, not {way}")
        for m in range(M):
            hs = {(r["hash"], r["hash_after"]) for r in ranks
                  if r["model_index"] == m}
            if len(hs) != 1:
                raise AssertionError(f"rs ({tag}): model shard {m} differs "
                                     f"across 'data': {hs}")
        r0 = ranks[0]

        def per_step(ep):
            e, n = r0[ep], r0[ep]["steps"]
            return (f"{ep} {n} steps: all-to-all {e['a2a_bytes'] / n:.0f} B "
                    f"and {e['a2a_ms'] / n:.3f} ms a step "
                    f"({e['a2a_calls']} calls), all-reduce "
                    f"{e['allreduce_bytes'] / n:.0f} B and "
                    f"{e['allreduce_ms'] / n:.3f} ms a step, epoch "
                    f"{max(r[ep]['ms'] for r in ranks):.1f} ms")

        h = [r["held"] for r in ranks]
        held = (" | held row-sharded steps (worst over ranks): K1 f32 ratio "
                f"{max(x['K1']['f32_ratio'] for x in h):.3f} on "
                f"{h[0]['K1']['U']} compact rows, K5 "
                f"{max(x['K5']['f32_ratio'] for x in h):.3f} on "
                f"{h[0]['K5']['U']} (<= 1); kernel {h[0]['K1']['ms']:.3f} "
                f"ms / plain {h[0]['K1']['plain_ms']:.3f} (K1), "
                f"{h[0]['K5']['ms']:.3f} / {h[0]['K5']['plain_ms']:.3f} (K5)"
                f"; at d 256 on the same rows (wide passes): K1 f32 ratio "
                f"{max(x['K1_d256']['f32_ratio'] for x in h):.3f}, K5 "
                f"{max(x['K5_d256']['f32_ratio'] for x in h):.3f}, kernel "
                f"{h[0]['K1_d256']['ms']:.3f} ms / plain "
                f"{h[0]['K1_d256']['plain_ms']:.3f} (K1), "
                f"{h[0]['K5_d256']['ms']:.3f} / "
                f"{h[0]['K5_d256']['plain_ms']:.3f} (K5)")
        if any("f64_ratio" in x[k] for x in h
               for k in ("K1", "K5", "K1_d256", "K5_d256")):
            held += " (by the float64 rule)"
        if "synthetic" in r0:
            sy = [r["synthetic"] for r in ranks]
            held += (f" | synthetic-10m K1 step: {sy[0]['U']} compact rows "
                     f"a worker ({sy[0]['compact_bytes']} B of compact "
                     f"tables, {sy[0]['exchange_bytes']} B exchanged by "
                     f"rank 0 for its plan and gathers), f32 ratio "
                     f"{max(x['f32_ratio'] for x in sy):.3f}"
                     + (" (float64 rule)" if any("f64_ratio" in x for x in sy)
                        else "")
                     + f", kernel {sy[0]['ms']:.3f} ms, plain "
                     f"{sy[0]['plain_ms']:.3f} ms")
        note = (" [gloo-host: the exchange stages the card's buffers "
                "through the host; correctness, not speed]"
                if backend == "gloo" else "")
        phase(f"rs {tag}", (
            f"mesh ({D},{M}) {backend} on "
            f"{sorted({r['device'] for r in ranks})}, transport {way}: NMI "
            f"{min(r['nmi'] for r in ranks):.4f}, served o1 "
            f"{min(r['o1_served'] for r in ranks):.4f} o2 "
            f"{min(r['o2_served'] for r in ranks):.4f} | o1 epoch in the "
            f"run {max(r['o1_ms'] for r in ranks):.1f} ms at "
            f"{WALKS_CUT if '--walks-per-node' in extra else 10} walks a "
            f"node (one card at d {d}, 10 walks: {main_o1_ms:.1f} ms), o2 "
            f"{max(r['o2_ms'] for r in ranks):.1f} ms, gmm "
            f"{r0['gmm_ms']:.1f} ms | rank 0, extra epochs: "
            f"{per_step('o1')}; {per_step('o2')} | model shards "
            "bit-identical across 'data' | launches per rank "
            f"{[{k: v for k, v in r['launches'].items() if v} for r in ranks]}"
            f" | graphs, rank 0: {graph_line('rs', r0['graphs'])}"
            + held + f" | {secs:.1f} s of run" + note))


# the JAX artifact's floors (tests/test_eval_regression.py:24-33) of the
# rows phase 20 runs
EVAL_FLOORS = {"karate": {"nmi": 0.60, "macro_f1": 0.85},
               "heavy-tail-dcsbm": {"nmi": 0.90, "macro_f1": 0.95}}


def eval_phase(smi, reset_counts, counts, check_launches, names) -> None:
    """Phase 20 (module docstring); raises if a row or the t-SNE check
    fails."""
    from come_tpu_torch.evaluation.plots import project_2d
    from come_tpu_torch.evaluation.tsne import trustworthiness, tsne
    from come_tpu_torch.tools.eval_sweep import run_one

    rows, held = {}, []
    for name, ran, short in (("karate", (), set()),
                             ("heavy-tail-dcsbm", ("walk_sgns", "star_sgns"),
                              {"K1", "K2"})):
        reset_counts()
        row, emb = run_one(name, False, None, ratios=True, device="cuda",
                           return_embeddings=True)
        torch.cuda.synchronize()
        check_launches(f"eval {name}", counts(), ran,
                       tuple(k for k in names if k not in ran))
        if set(row["kernels"]) != short:
            raise AssertionError(f"eval {name}: row kernels "
                                 f"{row['kernels']}, expected {short}")
        if not all(math.isfinite(row[k]) for k in ("nmi", "macro_f1")):
            raise AssertionError(f"eval {name}: {row}")
        floors = EVAL_FLOORS[name]
        if row["macro_f1"] < floors["macro_f1"]:
            raise AssertionError(f"eval {name}: macro-F1 {row['macro_f1']}")
        if row["nmi"] >= floors["nmi"]:
            held.append(f"{name} the JAX floor {floors['nmi']}")
        elif name == "karate" and row["nmi"] >= KARATE_NMI_FLOOR:
            held.append(f"karate the port's bar {KARATE_NMI_FLOOR} (JAX "
                        f"floor {floors['nmi']} missed)")
        else:
            raise AssertionError(f"eval {name}: NMI {row['nmi']:.4f}")
        rows[name] = row
    # emb: the heavy-tail embeddings, the loop's last row
    t0 = time.perf_counter()
    y, kls = tsne(emb, device="cuda", return_kl=True)
    torch.cuda.synchronize()
    tsne_s = time.perf_counter() - t0
    kl = dict(kls)
    last, kl_end = kls[-1]
    if not all(math.isfinite(v) for v in kl.values()):
        raise AssertionError(f"eval t-SNE: KL readings {kls}")
    if not kl_end < kl[300]:
        raise AssertionError(f"eval t-SNE: KL {kl[300]} at 300 -> "
                             f"{kl_end} at {last}")
    pca, _ = project_2d(emb)
    tw = trustworthiness(emb, y, 10, device="cuda")
    tw_pca = trustworthiness(emb, pca, 10, device="cuda")
    if tw < tw_pca:
        raise AssertionError(f"eval t-SNE: trustworthiness {tw:.4f} < PCA's "
                             f"{tw_pca:.4f}")
    k, h = rows["karate"], rows["heavy-tail-dcsbm"]
    phase("eval", (
        f"{smi} | karate NMI {k['nmi']:.4f} macro-F1 {k['macro_f1']:.4f} "
        f"in {k['seconds']} s ({k['o1_tier']}, no kernel) | heavy-tail-dcsbm "
        f"NMI {h['nmi']:.4f} macro-F1 {h['macro_f1']:.4f} in {h['seconds']} "
        f"s, peak {h['peak_mib']} MiB ({h['held_mib']} of it held before the "
        f"row), kernels {h['kernels']} | floors held: "
        + "; ".join(held) + f" | t-SNE of the {len(y)} heavy-tail "
        f"embeddings in {tsne_s:.2f} s: KL {kl[250]:.4f} at 250 "
        f"(exaggerated), {kl[300]:.4f} at 300, {kl_end:.4f} at {last}; "
        f"10-neighbour trustworthiness {tw:.4f} (PCA {tw_pca:.4f})"))


# G1's kernels (csrc/gmm_factor.cu), launched in every GMM fit on the card
GMM_KERNELS = ("gmm_factor", "gmm_inverse")
# G1 against its plain version: the largest relative Frobenius error of L
# and of inv_cov over the matrices of a batch.  Two f32 factorisations of a
# matrix of condition number c differ by up to ~c * 6e-8 in its inverse, so
# where the f32 plain version is farther than the bound the kernel must sit
# at least as close to the plain version run in float64 as the f32 plain
# version does (tools/hot_row.py's float64 rule).
G1_RTOL = 1e-4
# G1 at the presets' shapes [n_init, K, d] (config/presets.py: blogcatalog,
# synthetic-10m, flickr; blogcatalog at --dim 256) and at ragged widths: a
# panel is 16 columns, and d is padded to a multiple of 16.  Up to 128 a
# CTA holds its matrix in shared memory, past it in device memory.
G1_SHAPES = ((2, 39, 128), (1, 64, 128), (1, 195, 128), (2, 39, 256))
G1_WIDTHS = (1, 15, 16, 17, 31, 33, 100, 127, 128, 129, 160, 193, 256, 300)


def g1_moments(n, K, d, seed, pts=None):
    """M-step-like moments from numpy: (cov f32 [n, K, d, d], the scatter of
    ``pts`` (2 d + 5) points about their mean, not yet divided by nk; nk f32
    [n, K]).  The card tests and tests/test_torch_g1.py share them."""
    pts = pts or 2 * d + 5
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, K, pts, d), dtype=np.float32)
    x = x * rng.uniform(0.2, 2.0, (n, K, 1, d)).astype(np.float32)
    x = x - x.mean(-2, keepdims=True)
    return (np.swapaxes(x, -1, -2) @ x).astype(np.float32), np.full(
        (n, K), float(pts), np.float32)


def g1_pivot_cols(d):
    """Columns that get a non-positive pivot: the first, the middle and the
    last column of every panel of 16, the ragged last one included."""
    cols = set()
    for start in range(0, d, 16):
        end = min(start + 16, d)
        cols |= {start, start + (end - start - 1) // 2, end - 1}
    return sorted(cols)


def g1_pivot_batch(d, seed):
    """(cov [1, B, d, d], nk [1, B], info [1, B]): matrix b < B - 1 has
    A[k][k] = -1 + reg for the b-th of :func:`g1_pivot_cols` k, so its
    first non-positive pivot is column k (info k + 1); the last is left
    positive definite (info 0)."""
    cols = g1_pivot_cols(d)
    cov, nk = g1_moments(1, len(cols) + 1, d, seed)
    for b, k in enumerate(cols):
        cov[0, b, k, k] = -nk[0, b]
    return cov, nk, np.array([[k + 1 for k in cols] + [0]], np.int32)


def _moments(X, K, n_init, seed):
    """The first M-step's moments of a GMM fit on ``X``: (cov [n_init, K,
    d, d] not yet divided by nk, nk [n_init, K]) from the k-means inits."""
    from come_tpu_torch.losses import gmm

    g = torch.Generator().manual_seed(seed)
    resp = torch.stack([gmm._kmeans_init(X, K, g) for _ in range(n_init)])
    nk = resp.sum(-2) + 10.0 * torch.finfo(torch.float32).eps
    means = (resp.transpose(-1, -2) @ X) / nk[..., None]
    return gmm._scatter(X, resp, means), nk, resp


def g1_check(where, cov, nk, reg) -> dict:
    """G1 against its plain version on one batch (G1_RTOL's rule); the
    info flags must agree.  Returns the errors."""
    from come_tpu_torch.ops.gmm_factor import (
        gmm_factor,
        gmm_factor_reference,
        gmm_inverse,
        gmm_inverse_reference,
    )

    L, info = gmm_factor(cov, nk, reg)
    Lp, infop = gmm_factor_reference(cov, nk, reg)
    L64, _ = gmm_factor_reference(cov.double(), nk.double(), reg)
    inv, invp = gmm_inverse(L), gmm_inverse_reference(Lp)
    inv64 = gmm_inverse_reference(L64)
    torch.cuda.synchronize()

    def rel(a, b):
        a, b = a.double(), b.double()
        return float(((a - b).norm(dim=(-2, -1))
                      / b.norm(dim=(-2, -1))).max())

    if not torch.equal(info, infop.to(info.dtype)):
        raise AssertionError(f"G1 {where}: info flags differ from the plain "
                             f"version's")
    err = {}
    for k, a, p, r in (("L", L, Lp, L64), ("inv", inv, invp, inv64)):
        err[k], err[f"{k}_f64"], err[f"{k}_plain_f64"] = (
            rel(a, p), rel(a, r), rel(p, r))
        err[f"{k}_abs"] = float((a - p).abs().max())
        if not (err[k] <= G1_RTOL or err[f"{k}_f64"] <= err[f"{k}_plain_f64"]):
            raise AssertionError(f"G1 {where}: {k} {err}")
    err["by_f64"] = max(err["L"], err["inv"]) > G1_RTOL
    return err


def g1_wider_checks(dev) -> str:
    """G1 against its plain version (G1_RTOL's rule) at the other presets'
    shapes and at the ragged widths, on g1_moments; the info flags of
    g1_pivot_batch equal to cholesky_ex's and to the placed pivots' at every
    width.  Returns the phase line's part."""
    from come_tpu_torch.ops.gmm_factor import gmm_factor, gmm_factor_reference

    def on_card(*arrays):
        return (torch.from_numpy(a).to(dev) for a in arrays)

    worst = {"L": 0.0, "inv": 0.0}
    cases = [(n, K, d, SEED) for n, K, d in G1_SHAPES[1:]]
    cases += [(2, 3, d, d) for d in G1_WIDTHS]
    for n, K, d, seed in cases:
        err = g1_check(f"[{n}, {K}, {d}, {d}]", *on_card(
            *g1_moments(n, K, d, seed)), 1e-5)
        worst = {k: max(v, err[k]) for k, v in worst.items()}
    pivots = 0
    for d in G1_WIDTHS:
        cov, nk, want = g1_pivot_batch(d, 100 + d)
        cov, nk = on_card(cov, nk)
        _, info = gmm_factor(cov, nk, 1e-5)
        _, ref = gmm_factor_reference(cov, nk, 1e-5)
        if not info.tolist() == ref.tolist() == want.tolist():
            raise AssertionError(f"G1 pivots at d {d}: {info.tolist()}, "
                                 f"cholesky_ex {ref.tolist()}, placed "
                                 f"{want.tolist()}")
        pivots += want.size - 1
    return (f"synthetic-10m's, flickr's and blogcatalog's (dim 256) shapes "
            f"and d in {list(G1_WIDTHS)}:"
            f" worst rel Frobenius L {worst['L']:.3e}, inv {worst['inv']:.3e}"
            f" (each within {G1_RTOL:g} or by the float64 rule); {pivots} "
            f"placed pivots (first, middle, last column of each panel) flagged"
            f" as cholesky_ex flags them")


def em_graph_check(X, resp0, reg, max_iter, tol) -> list:
    """The graph-replayed EM against the eager EM, both with G1, from the
    same responsibilities: the same iterations per restart and the same
    bits, through a fresh plan and again through it on a moved table.
    Returns the iterations per restart of each fit."""
    from come_tpu_torch.losses.gmm import gmm_em_from_resp
    from come_tpu_torch.ops import launch_plan

    iters = []
    for x in (X, X * 1.01 + 0.003):
        eager = gmm_em_from_resp(x, resp0, reg, max_iter, tol, graph=False)
        graph = gmm_em_from_resp(x, resp0, reg, max_iter, tol, graph=True)
        torch.cuda.synchronize()
        for k, v in eager.items():
            if not torch.equal(v, graph[k]):
                raise AssertionError(f"graph EM: {k} differs from the eager "
                                     f"EM's")
        iters.append(eager["n_iter"].tolist())
    shape = (*resp0.shape, X.shape[1])
    plans = [p for p in launch_plan.plans("gmm_em") if p.key[4][:4] == shape]
    if len(plans) != 1 or plans[0].instantiations != 1:
        raise AssertionError(f"graph EM: {len(plans)} plans, "
                             f"{[p.instantiations for p in plans]} "
                             f"instantiations")
    return iters


def em_linalg_check(X, resp0, reg, max_iter, tol) -> dict:
    """The eager EM with G1 against the same EM with torch.linalg's
    factor and inverse (the plain versions): log-likelihood within 1e-4
    relative, NMI of the two partitions >= 0.99."""
    from come_tpu_torch.evaluation import nmi_score
    from come_tpu_torch.losses import gmm
    from come_tpu_torch.ops.gmm_factor import (
        gmm_factor_reference,
        gmm_inverse_reference,
    )

    g1 = gmm.gmm_em_from_resp(X, resp0, reg, max_iter, tol, graph=False)
    chol, inverse = gmm._chol, gmm._inverse
    gmm._chol, gmm._inverse = gmm_factor_reference, gmm_inverse_reference
    try:
        ref = gmm.gmm_em_from_resp(X, resp0, reg, max_iter, tol, graph=False)
    finally:
        gmm._chol, gmm._inverse = chol, inverse
    ll, ll_ref = (o["log_likelihood"].double() for o in (g1, ref))
    rel = float(((ll - ll_ref).abs() / ll_ref.abs()).max())
    nmi = min(nmi_score(a.argmax(-1).cpu().numpy(), b.argmax(-1).cpu().numpy())
              for a, b in zip(g1["resp"], ref["resp"]))
    if rel > 1e-4 or nmi < 0.99:
        raise AssertionError(f"G1 EM vs torch.linalg EM: ll rel {rel:.3e}, "
                             f"NMI {nmi:.4f}")
    return {"ll_rel": rel, "nmi": nmi, "iters": g1["n_iter"].tolist(),
            "iters_linalg": ref["n_iter"].tolist()}


def first_iter_phase(dev, smi: str, X, K: int, X256) -> dict:
    """Phase 21 (module docstring).  ``X``: phase 5's trained table,
    ``X256`` phase 5b's (dim 256).  Returns G1's kernel-line numbers, at
    d 128 and (keys ending "_256") at d 256."""
    from come_tpu_torch.tools import g1_times

    root = Path(__file__).resolve().parent
    res = subprocess.run(
        [sys.executable, str(root / "come_tpu_torch/tools/first_iter.py"),
         "--runs", "blogcatalog", "--label", "smoke"],
        capture_output=True, text=True, timeout=600, cwd=root)
    if res.returncode != 0:
        raise AssertionError(f"first_iter failed ({res.returncode}):\n"
                             f"{res.stderr[-3000:]}")
    run = json.loads(res.stdout.strip().splitlines()[-1])
    for it in run["iters"]:
        if it["nmi"] < NMI_FLOOR:
            raise AssertionError(f"first_iter: NMI {it['nmi']:.4f}")
        g = it["gmm_parts"]
        phase("first iter", (
            f"blogcatalog in a fresh process, outer iteration {it['iter']}: "
            f"{it['s']:.3f} s = gmm {it['gmm_ms']:.1f} ms (k-means "
            f"{g.get('kmeans', 0):.1f}, EM {g.get('em', 0):.1f} of which "
            f"capture {g.get('em_capture', 0):.1f}, eager factor calls "
            f"{g.get('factor', 0):.1f}, final E-step "
            f"{g.get('final_estep', 0):.1f}, inverse {g.get('inverse', 0):.1f}"
            f"; {g.get('em_iters', 0)} EM iterations, G1 factor launches "
            f"{g.get('g1_launches', 0)}) + o1 "
            f"{it['o1_ms']:.1f} + o2 {it['o2_ms']:.1f} (star layout "
            f"{it['star_layout_ms'] or 0:.1f}, first step "
            f"{it['o2_first_step_ms']:.3f}, others "
            f"{it['o2_other_steps_ms']:.3f}) + o3 {it['o3_ms']:.1f}; NMI "
            f"{it['nmi']:.4f} in {it['nmi_ms']:.1f} ms"))
    # G1 at blogcatalog's moments (phase 5's table, n_init 2) and on a
    # near-singular batch: 78 components of 64 points in 128 dimensions
    cov, nk, resp0 = _moments(X, K, 2, SEED)
    err = g1_check("blogcatalog", cov, nk, 1e-5)
    err256 = g1_check("blogcatalog dim 256", *_moments(X256, K, 2, SEED)[:2],
                      1e-5)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pts = torch.randn((2, K, 64, X.shape[1]), generator=gen, device=dev) * 0.1
    cov_s = pts.transpose(-1, -2) @ pts
    nk_s = torch.full((2, K), 64.0, device=dev)
    err_s = g1_check("near-singular", cov_s, nk_s, 1e-5)
    cond = torch.linalg.cond(cov_s.double() / 64 + 1e-5 * torch.eye(
        X.shape[1], device=dev, dtype=torch.float64)).max()
    iters = em_graph_check(X, resp0, 1e-5, 60, 1e-3)
    lin = em_linalg_check(X, resp0, 1e-5, 60, 1e-3)
    wide = g1_wider_checks(dev)
    nmat, d = nk.numel(), X.shape[1]
    # device ms a call (g1_times: 20 calls back to back behind a sleep) at
    # the presets' shapes, blogcatalog's first: the kernel line's
    sleep = g1_times.Sleeper()
    shapes = {(n, k, w): g1_times.time_shape(dev, n, k, w, 20, sleep, runs=3)
              for n, k, w in G1_SHAPES}
    t = {k: v["ms"] for k, v in shapes[G1_SHAPES[0]].items()}
    idle = {k: v["idle_ms"] for k, v in shapes[G1_SHAPES[0]].items()}
    t256 = {k: v["ms"] for k, v in shapes[(2, K, 256)].items()}
    # factor: cov read, L written (f32), nk read, info written, d^3 / 3
    # multiply-adds a matrix; inverse: L read, inv written, L^-1 and the
    # symmetric W^T W, d^3 / 6 multiply-adds each
    g1 = {
        "factor_err": max(err["L_abs"], err_s["L_abs"]),
        "factor_ms": t["factor"], "factor_plain_ms": t["factor_plain"],
        "factor_lib_ms": t["factor_lib"],
        # cov read, L written (f32), nk read, info written; d^3 / 3
        # multiply-adds a matrix
        "factor_bound": bound(nmat * 2.0 * d ** 3 / 3,
                              nmat * (8.0 * d * d + 8.0), False),
        "inverse_err": max(err["inv_abs"], err_s["inv_abs"]),
        "inverse_ms": t["inverse"], "inverse_plain_ms": t["inverse_plain"],
        "inverse_lib_ms": t["inverse_lib"],
        # L read, inv written; L^-1 and the symmetric W^T W, d^3 / 6
        # multiply-adds each
        "inverse_bound": bound(nmat * 2.0 * d ** 3 / 3,
                               nmat * 8.0 * d * d, False),
        "factor_err_256": err256["L_abs"], "inverse_err_256": err256["inv_abs"],
        "factor_bound_256": bound(nmat * 2.0 * 256 ** 3 / 3,
                                  nmat * (8.0 * 256 ** 2 + 8.0), False),
        "inverse_bound_256": bound(nmat * 2.0 * 256 ** 3 / 3,
                                   nmat * 8.0 * 256 ** 2, False),
    }
    for k in ("factor", "inverse"):
        for part in ("", "_plain", "_lib"):
            g1[f"{k}{part}_ms_256"] = t256[k + part]
    by_shape = "; ".join(
        f"[{n}, {k}, {w}, {w}] factor {r['factor']['ms']:.4f} (idle "
        f"{r['factor']['idle_ms']:.4f}, cholesky_ex {r['factor_lib']['ms']:.4f}"
        f"), inverse {r['inverse']['ms']:.4f} (idle "
        f"{r['inverse']['idle_ms']:.4f}, cholesky_inverse "
        f"{r['inverse_lib']['ms']:.4f}, profiler "
        f"{r['inverse_lib']['prof_ms'] or float('nan'):.4f})"
        for (n, k, w), r in shapes.items())
    phase("G1", (
        f"gmm_factor vs plain at blogcatalog's moments [{nmat} x {d} x {d}]: "
        f"rel Frobenius L {err['L']:.3e}, inv {err['inv']:.3e} (bound "
        f"{G1_RTOL:g}; vs float64: kernel {err['L_f64']:.3e} / "
        f"{err['inv_f64']:.3e}, plain {err['L_plain_f64']:.3e} / "
        f"{err['inv_plain_f64']:.3e}) | near-singular batch (cond <= "
        f"{float(cond):.3g}): L {err_s['L']:.3e}, inv {err_s['inv']:.3e} "
        f"(vs float64: kernel {err_s['L_f64']:.3e} / {err_s['inv_f64']:.3e},"
        f" plain {err_s['L_plain_f64']:.3e} / {err_s['inv_plain_f64']:.3e}"
        f"{'; by the float64 rule' if err_s['by_f64'] or err['by_f64'] else ''}"
        f") | at blogcatalog's dim-256 moments (phase 5b's table, [{nmat} x "
        f"256 x 256], the matrices in device memory): L {err256['L']:.3e}, "
        f"inv {err256['inv']:.3e} (vs float64: kernel {err256['L_f64']:.3e} "
        f"/ {err256['inv_f64']:.3e}, plain {err256['L_plain_f64']:.3e} / "
        f"{err256['inv_plain_f64']:.3e}) | {wide} | device ms a call: factor {g1['factor_ms']:.4f} (idle "
        f"card {idle['factor']:.4f}; plain {g1['factor_plain_ms']:.4f}, "
        f"torch.linalg.cholesky_ex {g1['factor_lib_ms']:.4f}, bound "
        f"{g1['factor_bound'][0]:.4f} by {g1['factor_bound'][1]}), inverse "
        f"{g1['inverse_ms']:.4f} (idle card {idle['inverse']:.4f}; "
        f"torch.cholesky_inverse {g1['inverse_lib_ms']:.4f}, bound "
        f"{g1['inverse_bound'][0]:.4f}) | by preset shape: {by_shape} | "
        f"graph EM = eager EM bit for bit, "
        f"iterations per restart {iters} | G1 EM vs torch.linalg EM: ll rel "
        f"{lin['ll_rel']:.3e}, NMI {lin['nmi']:.4f}, iterations "
        f"{lin['iters']} vs {lin['iters_linalg']} | {smi}"))
    return g1


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{smi} | torch {torch.__version__} cuda "
                    f"{torch.version.cuda} | {kind}")
    dev = torch.device("cuda", 0)

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from come_tpu_torch.config import get_config
    from come_tpu_torch.graphs import get_dataset
    from come_tpu_torch.ops import build
    from come_tpu_torch.ops.sgns import (
        fused_sgns_step,
        fused_sgns_step_reference,
        fused_sgns_step_tied,
        fused_sgns_step_tied_reference,
    )
    from come_tpu_torch.ops.star_sgns import (
        star_sgns_step,
        star_sgns_step_reference,
    )
    from come_tpu_torch.ops.row_probe import (
        row_gather_probe,
        row_gather_probe_reference,
        row_scatter_probe,
        row_scatter_probe_reference,
    )
    from come_tpu_torch.ops.floor_probe import floor_probe
    from come_tpu_torch.ops.gmm_factor import gmm_factor, gmm_inverse
    from come_tpu_torch.ops.smem_probe import (
        smem_optin_bytes,
        smem_probe,
        smem_probe_reference,
    )
    from come_tpu_torch.ops.star_probe import star_probe_step
    from come_tpu_torch.ops.walk_sgns import (
        NW,
        NWL,
        POOL_LAUNCHES,
        new_pools,
        new_routes,
        pad_walks,
        walk_sgns_gen_step,
        walk_sgns_gen_step_reference,
        walk_sgns_step,
        walk_sgns_step_reference,
        walks_from_bits,
    )
    from come_tpu_torch.sampling import (
        build_alias_table,
        build_star_layout,
        random_walks,
        sample_alias,
        unigram_weights,
    )
    from come_tpu_torch.sampling.stars import PAD_META
    from come_tpu_torch.sampling.windows import (
        skipgram_pairs,
        subsample_keep_probs,
    )
    from come_tpu_torch.tools.pass_times import (
        STAR_PASSES,
        cuda_ms,
        device_us,
        pass_split,
        split_text,
    )
    from come_tpu_torch.trainer import ComETrainer

    # each kernel (mode) and the wrapper attribute that counts its launches
    kernels = {
        "walk_sgns": (walk_sgns_step, "launches"),
        "star_sgns": (star_sgns_step, "launches"),
        "fused_sgns": (fused_sgns_step, "launches"),
        "fused_sgns_tied": (fused_sgns_step_tied, "launches"),
        "walk_sgns_bf16": (walk_sgns_step, "launches_bf16"),
        "star_sgns_bf16": (star_sgns_step, "launches_bf16"),
        "walk_sgns_gen": (walk_sgns_gen_step, "launches"),
        "walk_sgns_gen_bf16": (walk_sgns_gen_step, "launches_bf16"),
        "walk_sgns_paired": (walk_sgns_step, "launches_paired"),
        "walk_sgns_bf16_tables": (walk_sgns_step, "launches_bf16_tables"),
        "walk_sgns_gen_bf16_tables": (walk_sgns_gen_step,
                                      "launches_bf16_tables"),
        "row_gather_probe": (row_gather_probe, "launches"),
        "row_scatter_probe": (row_scatter_probe, "launches"),
        "smem_probe": (smem_probe, "launches"),
        "star_probe": (star_probe_step, "launches"),
        "floor_probe": (floor_probe, "launches"),
        "gmm_factor": (gmm_factor, "launches"),
        "gmm_inverse": (gmm_inverse, "launches"),
    }

    from come_tpu_torch.ops import launch_plan

    def reset_counts():
        for fn, attr in kernels.values():
            setattr(fn, attr, 0)
        for k in POOL_LAUNCHES:  # the pool passes inside the walk and
            POOL_LAUNCHES[k] = 0  # star steps (ops/walk_sgns.py)
        for fn in (walk_sgns_step, walk_sgns_gen_step, star_sgns_step,
                   star_probe_step):
            fn.routes = new_routes()  # steps by band or star route
        for fn in (walk_sgns_step, walk_sgns_gen_step, star_sgns_step):
            fn.pools = new_pools()  # the pool passes by step wrapper
        # a phase's plans start fresh, so a single-device phase reads one
        # recording a plan: recordings = instantiations = plans used
        launch_plan.release_plans(build.library())
        launch_plan.reset_counts()

    def counts():
        return {**{name: getattr(fn, attr)
                   for name, (fn, attr) in kernels.items()}, **POOL_LAUNCHES}

    def check_walk_pools(where, launched, every_group_ends=False):
        """The f32 walk steps' slot and pool writes in a run: its walk
        steps sorted their chains and wrote through block_end_scatter_kernel
        (and, where a block holds more than one group, walk_scatter_kernel),
        and none launched apply_pool_kernel, the star steps' pool write."""
        walk = {k: walk_sgns_step.pools[k] + walk_sgns_gen_step.pools[k]
                for k in walk_sgns_step.pools}
        if walk["apply_pool"]:
            raise AssertionError(f"{where}: the walk steps launched "
                                 f"apply_pool_kernel {walk['apply_pool']} "
                                 f"times")
        need = ("pool_chains", "slot_chains", "fold_chains",
                "block_end_scatter") + (
            () if every_group_ends else ("walk_scatter",))
        for k in need:
            if walk[k] == 0 or launched[k] < walk[k]:
                raise AssertionError(f"{where}: the walk steps launched no "
                                     f"{k} ({walk})")
        return walk

    def check_star_pools(where, launched, every_group_ends=False):
        """The star steps' slot and pool writes in a run: each star step
        sorted its pool, star and fold chains once and wrote through
        star_block_end_scatter_kernel (and, where a block holds more than
        one group, star_scatter_kernel; with R 1 never), and none
        launched apply_pool_kernel."""
        star = dict(star_sgns_step.pools)
        steps = star_sgns_step.launches + star_sgns_step.launches_bf16
        if star["apply_pool"]:
            raise AssertionError(f"{where}: the star steps launched "
                                 f"apply_pool_kernel {star['apply_pool']} "
                                 f"times")
        for k in ("pool_chains", "star_chains", "fold_chains"):
            if star[k] != steps:
                raise AssertionError(f"{where}: {steps} star steps launched "
                                     f"{k} {star[k]} times ({star})")
        need = ("star_block_end_scatter",) + (
            () if every_group_ends else ("star_scatter",))
        for k in need:
            if star[k] == 0 or launched[k] < star[k]:
                raise AssertionError(f"{where}: the star steps launched no "
                                     f"{k} ({star})")
        if every_group_ends and star["star_scatter"]:
            raise AssertionError(f"{where}: R 1, yet the star steps "
                                 f"launched star_scatter ({star})")
        return star

    def star_snap():
        """The star steps' pool passes and steps so far (star_writes)."""
        return (dict(star_sgns_step.pools),
                star_sgns_step.launches + star_sgns_step.launches_bf16)

    def star_writes(where, snap, G, R):
        """What the star steps since ``snap`` (star_snap), each of G groups
        with R a block, launched beside their star and negative passes:
        exactly the chains once a step, the block-end scatter once a block
        and the scatter once a group that ends none, and no
        apply_pool_kernel nor a walk step's pass."""
        before, steps0 = snap
        now, steps1 = star_snap()
        got = {k: now[k] - before[k] for k in now}
        steps, blocks = steps1 - steps0, -(-G // R)
        want = dict.fromkeys(got, 0)
        want.update(pool_chains=steps, star_chains=steps, fold_chains=steps,
                    star_block_end_scatter=steps * blocks,
                    star_scatter=steps * (G - blocks))
        for k in ("stage_pool", "stage_pool_bf16"):
            want[k] = got[k]  # the stages: by width and mode
        if got != want or steps == 0:
            raise AssertionError(f"{where}: {steps} star steps of {G} "
                                 f"groups, R {R}, launched {got}, expected "
                                 f"{want}")
        return f"{steps} star steps: chains, block ends {blocks} a step"

    def check_launches(where, launched, ran, idle, gmm=True):
        # G1's two kernels launch in every GMM fit on the card: a phase
        # that fits (gmm) must launch both, any other neither
        ran = tuple(ran) + (GMM_KERNELS if gmm else ())
        idle = tuple(k for k in idle if k not in GMM_KERNELS) + (
            () if gmm else GMM_KERNELS)
        for name in ran:
            if launched[name] == 0:
                raise AssertionError(f"{where} launched no {name} kernel")
        for name in idle:
            if launched[name] != 0:
                raise AssertionError(f"{where} launched {name} "
                                     f"{launched[name]} times, expected 0")

    # 2. build
    path, secs = build.build(verbose=True)
    lib = build.library()
    phase("build", f"{path.name} built in {secs:.2f} s (nvcc release "
                   f"{build.nvcc_release()}, runtime "
                   f"{lib.come_cudart_version()}, sm_90a) | group loops "
                   "recorded as graphs, PDL between passes " + (
                       "on" if lib.come_pdl_enabled() else
                       "off (the toolkit is older than 12.3)"))

    # 3. K1 at the BlogCatalog preset's shapes
    ds = get_dataset("blogcatalog")
    V, d, B, L, W, KP = ds.graph.num_nodes, 128, 256, 80, 10, 512
    gen = torch.Generator(device=dev).manual_seed(SEED)
    emb_in = torch.randn((V, d), generator=gen, device=dev) * 0.1
    emb_out = torch.randn((V, d), generator=gen, device=dev) * 0.1
    csr = ds.graph.to_device(dev)
    starts = torch.randint(0, V, (B,), generator=gen, device=dev)
    walks = random_walks(csr, starts, L, gen)
    G = B // 8
    wrow = torch.randint(1, W + 1, (G * NWL,), generator=gen, device=dev,
                         dtype=torch.int32)
    pools = torch.randint(0, V, (G, KP), generator=gen, device=dev,
                          dtype=torch.int32)
    lr, negw = 0.025, 5.0 / KP

    def k1(fn):
        return fn(emb_in.clone(), emb_out.clone(), walks, wrow, pools, lr,
                  negw, window=W, pool_refresh=1)

    kern = k1(walk_sgns_step)
    plain = k1(walk_sgns_step_reference)
    torch.cuda.synchronize()
    k1_err = compare("K1", (emb_in, emb_out), kern, plain)
    k1_ms = cuda_ms(lambda: k1(walk_sgns_step))
    k1_plain_ms = cuda_ms(lambda: k1(walk_sgns_step_reference))
    k1_bound = walk_bound(walks, pools, float(kern[3]), d, 4, False)
    # the passes of a K1 step and the card's busy share of one: the device
    # time of every kernel the step launches over its CUDA-event time (on
    # tables it updates in place, no clones), as K3's below
    tabs = [emb_in.clone(), emb_out.clone()]

    def k1_step():
        walk_sgns_step(*tabs, walks, wrow, pools, lr, negw, window=W,
                       pool_refresh=1)

    step_ms = cuda_ms(k1_step)
    k1_split, k1_dev_us = pass_split(k1_step, G)
    del tabs
    phase("K1", f"walk_sgns V={V} d={d} B={B} L={L} W={W} KP={KP} R=1 "
                f"G={G}: max_abs {k1_err[0]:.3e} max_rel {k1_err[1]:.3e} "
                f"loss_rel {k1_err[2]:.3e} pairs {float(kern[3]):.0f} | "
                f"kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms "
                f"(tol {ATOL} + {RTOL}*|plain update|) | device us per "
                f"group: {split_text(k1_split)} | one K1 step {step_ms:.3f} "
                f"ms, device busy {k1_dev_us / (step_ms * 1e3):.1%}")

    # 3b. K1b: the same inputs in the bf16 mode
    def k1b(fn):
        return fn(emb_in.clone(), emb_out.clone(), walks, wrow, pools, lr,
                  negw, window=W, pool_refresh=1, mxu_bf16=True)

    kern1b = k1b(walk_sgns_step)
    plain1b = k1b(walk_sgns_step_reference)
    torch.cuda.synchronize()
    k1b_err = compare_bf16("K1b", (emb_in, emb_out), kern1b, plain1b,
                           plain[:2])
    phase("K1b", "walk_sgns bf16, K1's inputs: " + bf16_line(
        k1b_err, cuda_ms(lambda: k1b(walk_sgns_step)),
        cuda_ms(lambda: k1b(walk_sgns_step_reference))))
    del kern1b, plain1b

    # 4. K2 on the stand-in's star layout: one 65536-slot macro step
    u, v = ds.graph.edges_undirected()
    slots, meta = build_star_layout(u, v, V)
    rows = slots.shape[0] // 128
    perm = np.random.default_rng(SEED).permutation(rows)[:512]  # of ~2.7k
    sl = torch.as_tensor(slots.reshape(-1, 128)[perm], device=dev).reshape(-1)
    mt = torch.as_tensor(meta.reshape(-1, 128)[perm], device=dev).reshape(-1)
    G2 = sl.shape[0] // NWL
    pools2 = torch.randint(0, V, (G2, KP), generator=gen, device=dev,
                           dtype=torch.int32)

    def k2(fn):
        return fn(emb_in.clone(), sl, mt, pools2, lr, negw, pool_refresh=1)

    snap = star_snap()
    kern2 = k2(star_sgns_step)
    plain2 = k2(star_sgns_step_reference)
    torch.cuda.synchronize()
    k2_err = compare("K2", (emb_in,), kern2, plain2)
    k2_ms = cuda_ms(lambda: k2(star_sgns_step))
    k2_plain_ms = cuda_ms(lambda: k2(star_sgns_step_reference))
    k2_bound = star_bound(sl, mt, pools2, float(kern2[2]), d, False, PAD_META)
    k2_split = split_text(pass_split(lambda: k2(star_sgns_step), G2,
                                     STAR_PASSES)[0])
    phase("K2", f"star_sgns V={V} d={d} T={sl.shape[0]} KP={KP} R=1 "
                f"G={G2}: max_abs {k2_err[0]:.3e} max_rel {k2_err[1]:.3e} "
                f"loss_rel {k2_err[2]:.3e} pairs {float(kern2[2]):.0f} | "
                f"kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms "
                f"(tol {ATOL} + {RTOL}*|plain update|) | device us per "
                f"group: {k2_split} | "
                + star_writes("K2", snap, G2, 1))

    # 4b. K2b: the same inputs in the bf16 mode
    def k2b(fn):
        return fn(emb_in.clone(), sl, mt, pools2, lr, negw, pool_refresh=1,
                  mxu_bf16=True)

    snap = star_snap()
    kern2b = k2b(star_sgns_step)
    plain2b = k2b(star_sgns_step_reference)
    torch.cuda.synchronize()
    k2b_err = compare_bf16("K2b", (emb_in,), kern2b, plain2b, plain2[:1])
    phase("K2b", "star_sgns bf16, K2's inputs: " + bf16_line(
        k2b_err, cuda_ms(lambda: k2b(star_sgns_step)),
        cuda_ms(lambda: k2b(star_sgns_step_reference)))
        + " | " + star_writes("K2b", snap, G2, 1))
    del kern, plain, kern2, plain2, kern2b, plain2b

    # 4c. K4: a macro step of B walks generated in the kernel
    bits = torch.randint(-2**31, 2**31, (G * NWL,), generator=gen,
                         device=dev, dtype=torch.int32)

    def k4(fn):
        return fn(emb_in.clone(), emb_out.clone(), starts, bits, csr.indptr,
                  csr.indices, wrow, pools, lr, negw, walk_length=L,
                  window=W, pool_refresh=1, return_walks=True)

    src = torch.repeat_interleave(torch.arange(V, device=dev),
                                  csr.degrees.long())
    arc_keys = torch.sort(src * V + csr.indices.long()).values

    def check_walks(name, kw, pw):
        """K4's walks: the plain version's bit for bit, every hop an edge
        (or a stay at a node of degree 0)."""
        if not torch.equal(kw, pw):
            raise AssertionError(f"{name}: {int((kw != pw).sum())} generated "
                                 f"walk slots differ from the plain version's")
        here, nxt = kw[:, :-1].long(), kw[:, 1:].long()
        hop = here * V + nxt
        found = arc_keys[torch.searchsorted(arc_keys, hop).clamp_max(
            arc_keys.numel() - 1)]
        stay = (here == nxt) & (csr.degrees.long()[here] == 0)
        if not bool(((found == hop) | stay).all()):
            raise AssertionError(f"{name}: a generated hop is not an edge")

    *kern4, kw4 = k4(walk_sgns_gen_step)
    *plain4, pw4 = k4(walk_sgns_gen_step_reference)
    torch.cuda.synchronize()
    check_walks("K4", kw4, pw4)
    k4_err = compare("K4", (emb_in, emb_out), kern4, plain4)
    k4_ms = cuda_ms(lambda: k4(walk_sgns_gen_step))
    k4_plain_ms = cuda_ms(lambda: k4(walk_sgns_gen_step_reference))
    phase("K4", f"walk_sgns_gen V={V} d={d} B={B} L={L} W={W} KP={KP} "
                f"G={G}: walks bit-identical ({kw4.numel()} slots, every hop "
                f"an edge), max_abs {k4_err[0]:.3e} max_rel {k4_err[1]:.3e} "
                f"loss_rel {k4_err[2]:.3e} pairs {float(kern4[3]):.0f} | "
                f"kernel {k4_ms:.3f} ms, plain {k4_plain_ms:.3f} ms "
                f"(tol {ATOL} + {RTOL}*|plain update|)")
    del kern4, plain4

    # 4d. K5: one paired macro step, 512 rows of 64 shuffled edges
    eperm = torch.as_tensor(np.random.default_rng(SEED).permutation(
        u.shape[0])[:512 * 64], device=dev)
    uu, vv = (torch.as_tensor(a, device=dev)[eperm] for a in (u, v))
    rows = torch.stack([uu, vv], 1).reshape(512, 128)
    pools5 = torch.randint(0, V, (64, KP), generator=gen, device=dev,
                           dtype=torch.int32)

    def k5(fn):
        return fn(emb_in.clone(), emb_out.clone(), rows, None, pools5, lr,
                  negw, window=1, pool_refresh=1, paired=True)

    kern5 = k5(walk_sgns_step)
    plain5 = k5(walk_sgns_step_reference)
    torch.cuda.synchronize()
    k5_err = compare("K5", (emb_in, emb_out), kern5, plain5)
    k5_ms = cuda_ms(lambda: k5(walk_sgns_step))
    k5_plain_ms = cuda_ms(lambda: k5(walk_sgns_step_reference))
    k5_bound = walk_bound(rows, pools5, float(kern5[3]), d, 4, False)
    phase("K5", f"walk_sgns paired V={V} d={d} rows=512 KP={KP} R=1 G=64: "
                f"max_abs {k5_err[0]:.3e} max_rel {k5_err[1]:.3e} loss_rel "
                f"{k5_err[2]:.3e} pairs {float(kern5[3]):.0f} | kernel "
                f"{k5_ms:.3f} ms, plain {k5_plain_ms:.3f} ms (tol {ATOL} + "
                f"{RTOL}*|plain update|)")
    del kern5, plain5

    # 4k. K1, K2 and K5 at d 256 on the inputs of phases 3, 4 and 4d (the
    # main path's shapes at --dim 256), and K1 with the whole walk in its
    # window (W 79, its own window draws)
    wrow79 = torch.randint(1, L, (G * NWL,), device=dev, dtype=torch.int32,
                           generator=torch.Generator(device=dev).manual_seed(
                               SEED + L - 1))
    blog256 = blog_wide_checks(dev, {
        "K1": ("K1", (walks, wrow, pools), dict(window=W, pool_refresh=1)),
        "K1 whole walk": ("K1", (walks, wrow79, pools),
                          dict(window=L - 1, pool_refresh=1)),
        "K2": ("K2", (sl, mt, pools2), dict(pool_refresh=1)),
        "K5": ("K5", (rows, None, pools5), dict(window=1, pool_refresh=1,
                                                  paired=True)),
    }, V)
    phase("wide 256", f"phases 3, 4 and 4d's steps at d 256 (V {V}, K1 "
                      f"{B} walks and {G} groups, K2 {sl.numel()} slots, K5 "
                      f"{rows.shape[0]} rows) vs plain (tol {ATOL} + "
                      f"{RTOL}*|plain update|): " + wide_text(blog256)
                      + f" | {smi}")
    torch.cuda.empty_cache()

    # 4e. K1b, K4 (bf16) and K2b at the shapes the bench path (phases 12
    # and 13) gives them: one 2048-walk O1 step (256 groups, R 8, unigram
    # pools [32, 512]) and the one star O2 step of batch_edges 524288 (the
    # whole layout in rps = ceil(NR / 8) * 8 rows, R 8)
    BB, RB = 2048, 8
    GB = BB // NW
    accept, alias = (torch.as_tensor(a, device=dev) for a in
                     build_alias_table(unigram_weights(ds.graph.degrees)))
    starts_b = torch.randint(0, V, (BB,), generator=gen, device=dev)
    walks_b = random_walks(csr, starts_b, L, gen)
    bits_b = torch.randint(-2**31, 2**31, (GB * NWL,), generator=gen,
                           device=dev, dtype=torch.int32)
    wrow_b = torch.randint(1, W + 1, (GB * NWL,), generator=gen, device=dev,
                           dtype=torch.int32)
    pools_b = sample_alias(accept, alias, gen, (-(-GB // RB), KP))

    def k1b_bench(fn, bf16=True):
        return fn(emb_in.clone(), emb_out.clone(), walks_b, wrow_b, pools_b,
                  lr, negw, window=W, pool_refresh=RB, mxu_bf16=bf16)

    kern, plain, f32 = (k1b_bench(walk_sgns_step),
                        k1b_bench(walk_sgns_step_reference),
                        k1b_bench(walk_sgns_step_reference, False))
    torch.cuda.synchronize()
    k1bb_err = compare_bf16("K1b (bench)", (emb_in, emb_out), kern, plain,
                            f32[:2])
    k1bb_bound = walk_bound(walks_b, pools_b, float(kern[3]), d, 4, True)
    k1bb_ms = cuda_ms(lambda: k1b_bench(walk_sgns_step))
    k1bb_plain_ms = cuda_ms(lambda: k1b_bench(walk_sgns_step_reference))
    phase("K1b bench", f"walk_sgns bf16 B={BB} R={RB} G={GB} pools "
                       f"{tuple(pools_b.shape)}: "
                       + bf16_line(k1bb_err, k1bb_ms, k1bb_plain_ms)
                       + " | device us per group: "
                       + split_text(pass_split(
                           lambda: k1b_bench(walk_sgns_step), GB)[0]))

    def k4_bench(fn, bf16=True):
        return fn(emb_in.clone(), emb_out.clone(), starts_b, bits_b,
                  csr.indptr, csr.indices, wrow_b, pools_b, lr, negw,
                  walk_length=L, window=W, pool_refresh=RB, mxu_bf16=bf16,
                  return_walks=True)

    *kern, kw = k4_bench(walk_sgns_gen_step)
    *plain, pw = k4_bench(walk_sgns_gen_step_reference)
    *f32, _ = k4_bench(walk_sgns_gen_step_reference, False)
    torch.cuda.synchronize()
    check_walks("K4 (bench)", kw, pw)
    k4b_err = compare_bf16("K4 (bench)", (emb_in, emb_out), kern, plain,
                           f32[:2])
    # K4 also reads starts, and per hop two offsets and one neighbour
    k4b_bound = walk_bound(kw, pools_b, float(kern[3]), d, 4, True,
                           4.0 * BB + 12.0 * BB * (L - 1))
    k4b_ms = cuda_ms(lambda: k4_bench(walk_sgns_gen_step))
    k4b_plain_ms = cuda_ms(lambda: k4_bench(walk_sgns_gen_step_reference))
    phase("K4 bench", f"walk_sgns_gen bf16 B={BB} R={RB} G={GB}: walks "
                      f"bit-identical ({kw.numel()} slots, every hop an "
                      f"edge), " + bf16_line(k4b_err, k4b_ms, k4b_plain_ms))

    lay_s, lay_m = slots.reshape(-1, 128), meta.reshape(-1, 128)
    NR = lay_s.shape[0]
    rps = -(-max(8, min(-(-524288 // 128), NR)) // 8) * 8
    if rps < NR:
        raise AssertionError(f"bench O2: {NR} layout rows need more than "
                             f"one step of {rps}")
    rperm = np.random.default_rng(SEED).permutation(NR)
    sl_b = torch.as_tensor(np.pad(lay_s[rperm], ((0, rps - NR), (0, 0))),
                           device=dev).reshape(-1)
    mt_b = torch.as_tensor(np.pad(lay_m[rperm], ((0, rps - NR), (0, 0)),
                                  constant_values=PAD_META),
                           device=dev).reshape(-1)
    G2B = rps * 128 // NWL
    pools2_b = sample_alias(accept, alias, gen, (-(-G2B // RB), KP))

    def k2b_bench(fn, bf16=True):
        return fn(emb_in.clone(), sl_b, mt_b, pools2_b, lr, negw,
                  pool_refresh=RB, mxu_bf16=bf16)

    snap = star_snap()
    kern, plain, f32 = (k2b_bench(star_sgns_step),
                        k2b_bench(star_sgns_step_reference),
                        k2b_bench(star_sgns_step_reference, False))
    torch.cuda.synchronize()
    k2bb_err = compare_bf16("K2b (bench)", (emb_in,), kern, plain, f32[:1])
    k2bb_bound = star_bound(sl_b, mt_b, pools2_b, float(kern[2]), d, True,
                            PAD_META)
    k2bb_ms = cuda_ms(lambda: k2b_bench(star_sgns_step))
    k2bb_plain_ms = cuda_ms(lambda: k2b_bench(star_sgns_step_reference))
    phase("K2b bench", f"star_sgns bf16 T={sl_b.numel()} R={RB} G={G2B} "
                       f"pools {tuple(pools2_b.shape)} (one step): "
                       + bf16_line(k2bb_err, k2bb_ms, k2bb_plain_ms)
                       + " | device us per group: "
                       + split_text(pass_split(
                           lambda: k2b_bench(star_sgns_step), G2B,
                           STAR_PASSES)[0])
                       + " | " + star_writes("K2b bench", snap, G2B, RB))
    del emb_in, emb_out, kern, plain, f32
    torch.cuda.empty_cache()

    # 4k (bench). K1b, K4 and K2b at d 256 on the bench path's inputs of
    # phase 4e, each under its mode's check
    blog256.update(blog_wide_checks(dev, {
        "K1b bench": ("K1b", (walks_b, wrow_b, pools_b),
                      dict(window=W, pool_refresh=RB, mxu_bf16=True)),
        "K4 bench": ("K4", (starts_b, bits_b, csr.indptr, csr.indices,
                            wrow_b, pools_b),
                     dict(walk_length=L, window=W, pool_refresh=RB,
                          mxu_bf16=True)),
        "K2b bench": ("K2b", (sl_b, mt_b, pools2_b),
                      dict(pool_refresh=RB, mxu_bf16=True)),
    }, V))
    phase("wide 256 bench", f"phase 4e's steps at d 256 (K1b and K4 {BB} "
                            f"walks, {GB} groups, R {RB}; K2b {G2B} groups, "
                            f"R {RB}) vs plain under the bf16 check: "
                            + wide_text({k: blog256[k] for k in (
                                "K1b bench", "K4 bench", "K2b bench")})
                            + f" | {smi}")
    torch.cuda.empty_cache()

    # 4h. the walk kernel at the shapes that stress its band strips (8
    # centres) and its bf16 negative tiles (64 slots x 32 pool rows), in
    # f32, in bf16 products and on bf16 tables (K3, SR), each held to its
    # mode's check
    from come_tpu_torch.ops.tolerance import check_k3

    edge_lines = []
    for (Ve, de, Be, Le, We, KPe, Re, hot) in EDGE_SHAPES:
        for mode in ("f32", "bf16", "bf16_tables"):
            if hot and mode == "bf16_tables":
                continue  # outside K3's check (EDGE_SHAPES' note)
            Vm = max(Ve, 20000) if mode == "bf16_tables" else Ve
            ge = torch.Generator(device=dev).manual_seed(Vm + de + Le)
            init = [torch.randn((Vm, de), generator=ge, device=dev) * 0.1
                    for _ in range(2)]
            if mode == "bf16_tables":
                init = [t.to(torch.bfloat16) for t in init]
            we = torch.randint(0, Vm, (Be, Le), generator=ge, device=dev,
                               dtype=torch.int32)
            if hot:
                we[:, ::2] = 7
            Ge = -(-Be // NW)
            wre = torch.randint(1, We + 1, (Ge * NWL,), generator=ge,
                                device=dev, dtype=torch.int32)
            pe = torch.randint(0, Vm, (-(-Ge // Re), KPe), generator=ge,
                               device=dev, dtype=torch.int32)

            def edge(fn, tables, **kw):
                return fn(*[t.clone() for t in tables], we, wre, pe, lr,
                          5.0 / KPe, window=We, pool_refresh=Re, **kw)

            bf = mode == "bf16"
            seed = 77 if mode == "bf16_tables" else None
            kern = edge(walk_sgns_step, init, mxu_bf16=bf, sr_seed=seed)
            if hot and mode == "f32":  # float64 (EDGE_SHAPES' note)
                plain = edge(walk_sgns_step_reference,
                             [t.double() for t in init], acc=torch.float64)
            else:
                plain = edge(walk_sgns_step_reference, init, mxu_bf16=bf,
                             sr_seed=seed)
            torch.cuda.synchronize()
            name = f"edge {mode} V={Vm} d={de} L={Le} W={We} KP={KPe} R={Re}"
            if Le == 1:  # no pairs: nothing may move
                if float(kern[3]) != 0.0 or not all(
                        torch.equal(a, b) for a, b in zip(kern[:2], init)):
                    raise AssertionError(f"{name}: tables moved without pairs")
                err = 0.0
            elif mode == "f32":
                err = compare(name, init, kern, plain)[0]
            elif mode == "bf16":
                err = compare_bf16(name, init, kern, plain, edge(
                    walk_sgns_step_reference, init)[:2])[1]
            else:
                if float(kern[3]) != float(plain[3]) or abs(
                        float(kern[2]) - float(plain[2])) > 1e-4 * abs(
                        float(plain[2])):
                    raise AssertionError(f"{name}: loss or pairs differ")
                err = check_k3(name, init, kern[:2], plain[:2], edge(
                    walk_sgns_step_reference, [t.float() for t in init],
                    mxu_bf16=True)[:2])[3]
            tag = " hot" if hot else ""
            edge_lines.append(f"L{Le} W{We} d{de} KP{KPe}{tag} {mode} "
                              f"{err:.3g}")
            del kern, plain, init
    phase("edges", "walk kernel vs plain (f32 max_abs, bf16 rel_l2, "
                   "bf16_tables identical share): " + "; ".join(edge_lines))
    torch.cuda.empty_cache()

    # 4i. the star kernel at layouts that stress its strips (fat and split
    # hubs, pads mid-row, a ragged last group) and the f32 negative pass's
    # tiles (d 192 and 2, KP 100 and 2048, ragged and all-masked tiles), in
    # f32 and bf16 products, each held to its mode's check
    edge_lines = []
    for (Ve, de, Ee, KPe, Re, layout) in STAR_EDGES:
        se, me = (torch.as_tensor(a, device=dev) for a in
                  star_edge_layout(Ve, Ee, layout, Ve + de))
        ge = torch.Generator(device=dev).manual_seed(Ve + de)
        init = torch.randn((Ve, de), generator=ge, device=dev) * 0.1
        Ge = -(-se.numel() // NWL)
        pe = torch.randint(0, Ve, (-(-Ge // Re), KPe), generator=ge,
                           device=dev, dtype=torch.int32)

        def star_edge(fn, bf):
            return fn(init.clone(), se, me, pe, lr, 5.0 / KPe,
                      pool_refresh=Re, mxu_bf16=bf)

        name = f"star edge {layout} V={Ve} d={de} KP={KPe} R={Re} G={Ge}"
        snap = star_snap()
        plain = star_edge(star_sgns_step_reference, False)
        err = compare(name, (init,), star_edge(star_sgns_step, False), plain)
        text = f"f32 {err[0]:.3g}"
        err_b = compare_bf16(name + " bf16", (init,),
                             star_edge(star_sgns_step, True),
                             star_edge(star_sgns_step_reference, True),
                             plain[:1])
        text += f", bf16 {err_b[1]:.3g}"
        star_writes(name, snap, Ge, Re)
        edge_lines.append(f"{layout} d{de} KP{KPe} R{Re} G{Ge} pairs "
                          f"{float(plain[2]):.0f}: {text}")
    for (Ve, de, Pe, TPe, KPe) in FUSED_EDGES:
        ge = torch.Generator(device=dev).manual_seed(Ve + Pe + de)
        init = [torch.randn((Ve, de), generator=ge, device=dev) * 0.1
                for _ in range(2)]
        ce, xe, pe = (torch.randint(0, Ve, (n,), generator=ge, device=dev,
                                    dtype=torch.int32) for n in (Pe, Pe, KPe))
        me = (torch.rand(Pe, generator=ge, device=dev) < 0.6).float()
        me[TPe:2 * TPe] = 0.0
        kw = dict(tile_pairs=TPe)
        name = f"fused edge d={de} P={Pe} TP={TPe} KP={KPe}"
        err6 = compare("K6 " + name, init, fused_sgns_step(
            *[t.clone() for t in init], ce, xe, pe, me, lr, 5.0 / KPe, **kw),
            fused_sgns_step_reference(*[t.clone() for t in init], ce, xe, pe,
                                      me, lr, 5.0 / KPe, **kw))
        err7 = compare("K7 " + name, init[:1], fused_sgns_step_tied(
            init[0].clone(), ce, xe, pe, me, lr, 5.0 / KPe, **kw),
            fused_sgns_step_tied_reference(init[0].clone(), ce, xe, pe, me,
                                           lr, 5.0 / KPe, **kw))
        edge_lines.append(f"K6/K7 d{de} TP{TPe} KP{KPe}: {err6[0]:.3g}, "
                          f"{err7[0]:.3g}")
    phase("star/f32 edges", "vs plain (f32 max_abs, bf16 rel_l2): "
                            + "; ".join(edge_lines) + " | every star step: "
                            "its chains once, its block ends' scatter, no "
                            "apply_pool_kernel")
    torch.cuda.empty_cache()

    # 4m (star). the star writes alone: the star chains, the star scatter
    # and the star block end with its pool write, bit for bit against their
    # plain versions, on phase 4's blogcatalog group and a hub layout with
    # pools that draw the hub over and over (and its K2 step at R 3)
    star4m = star_phase(dev, smi, sl, mt, pools2, V, gen)

    # 4j. every mode past 128: past 192 its band or star pass holds whole
    # rows or stages column slabs, and its negative pass is the wide kernel
    wide_phase(smi, dev)
    torch.cuda.empty_cache()

    # 4l. the passes' device µs at d 256
    passes_phase(smi, dev)

    def large_v_kernels():
        """Phases 4f-4g in their own scope (the BlogCatalog phases' names
        stay as they were); returns what the kernels line reads."""
        t_ds = time.perf_counter()
        # 4f. K3 at the large-V path's shapes: one synthetic-10m macro step
        from come_tpu_torch.ops.tolerance import K3_L2, check_k3

        big = get_dataset("synthetic-10m")
        t_ds = time.perf_counter() - t_ds
        csr10 = big.graph.to_device(dev)
        V, d, B, L, W, KP, R = big.graph.num_nodes, 128, 1024, 80, 10, 2048, 1
        G = B // NW
        acc10, ali10 = (torch.as_tensor(a, device=dev) for a in
                        build_alias_table(unigram_weights(big.graph.degrees)))
        init = [(torch.randn((V, d), generator=gen, device=dev) * 0.1).to(
            torch.bfloat16) for _ in range(2)]
        starts10 = torch.randint(0, V, (B,), generator=gen, device=dev)
        bits10 = torch.randint(-2**31, 2**31, (G * NWL,), generator=gen,
                               device=dev, dtype=torch.int32)
        walks10 = walks_from_bits(starts10, bits10, csr10.indptr, csr10.indices,
                                  L)
        wrow10 = torch.randint(1, W + 1, (G * NWL,), generator=gen, device=dev,
                               dtype=torch.int32)
        pools10 = sample_alias(acc10, ali10, gen, (G, KP))
        negw10 = 5.0 / KP

        def k3(fn, tables, **kw):
            return fn(*[t.clone() for t in tables], walks10, wrow10, pools10, lr,
                      negw10, window=W, pool_refresh=R, **kw)

        def k3_gen(fn, tables, **kw):
            return fn(*[t.clone() for t in tables], starts10, bits10,
                      csr10.indptr, csr10.indices, wrow10, pools10, lr, negw10,
                      walk_length=L, window=W, pool_refresh=R, **kw)

        def k3_check(name, kern, plain, f32):
            if float(kern[3]) != float(plain[3]) or abs(
                    float(kern[2]) - float(plain[2])) > 1e-4 * abs(float(plain[2])):
                raise AssertionError(
                    f"{name}: loss {float(kern[2])} vs {float(plain[2])}, pairs "
                    f"{float(kern[3])} vs {float(plain[3])}")
            if kern[0].dtype != torch.bfloat16 or not all(
                    torch.isfinite(t).all() for t in kern[:2]):
                raise AssertionError(f"{name}: tables not finite bf16")
            return check_k3(name, init, kern[:2], plain[:2], f32[:2])

        f32_10 = k3(walk_sgns_step_reference, [t.float() for t in init],
                    mxu_bf16=True)
        k3_lines = []
        for entry, fn, plain_fn, step_fn in (
                ("step", walk_sgns_step, walk_sgns_step_reference, k3),
                ("gen", walk_sgns_gen_step, walk_sgns_gen_step_reference, k3_gen)):
            for mode, seed in (("SR", 12345), ("truncation", None)):
                kern = step_fn(fn, init, sr_seed=seed)
                plain = step_fn(plain_fn, init, sr_seed=seed)
                torch.cuda.synchronize()
                err = k3_check(f"K3 {entry} {mode}", kern, plain, f32_10)
                if entry == "step" and mode == "SR":
                    k3_err = err
                    k3_bound = walk_bound(walks10, pools10, float(kern[3]), d, 2,
                                          True)
                k3_lines.append(
                    f"{entry} {mode}: identical {err[3]:.5f} rel_l2 {err[1]:.3e} "
                    f"(bound {K3_L2}) f32-table distance {err[2]:.3e} "
                    f"({err[2] / max(err[1], 1e-30):.1f}x) max_abs {err[0]:.3e}")
                del kern, plain
        k3_ms = cuda_ms(lambda: k3(walk_sgns_step, init, sr_seed=7))
        k3_plain_ms = cuda_ms(lambda: k3(walk_sgns_step_reference, init,
                                         sr_seed=7))
        init32 = [t.float() for t in init]
        k1_10_ms = cuda_ms(lambda: k3(walk_sgns_step, init32))
        k1_10_bound = walk_bound(walks10, pools10, float(f32_10[3]), d, 4, False)
        # the passes of a K3 step, and the card's busy share of one: the
        # device time of every kernel the step launches over the step's
        # CUDA-event time (on tables it updates in place, no clones)
        tabs = [t.clone() for t in init]

        def k3_step():
            walk_sgns_step(*tabs, walks10, wrow10, pools10, lr, negw10,
                           window=W, pool_refresh=R, sr_seed=7)

        step_ms = cuda_ms(k3_step)
        k3_split, k3_dev_us = pass_split(k3_step, G)
        k3_split = split_text(k3_split)
        busy = k3_dev_us / (step_ms * 1e3)
        del tabs
        phase("K3", f"walk_sgns bf16 tables V={V} d={d} B={B} L={L} W={W} "
                    f"KP={KP} R={R} G={G} (graph built in {t_ds:.1f} s): "
                    + "; ".join(k3_lines)
                    + f" | K3 {k3_ms:.3f} ms (plain {k3_plain_ms:.3f}, bound "
                    f"{k3_bound[0]:.4f} by {k3_bound[1]}), K1 on f32 tables "
                    f"{k1_10_ms:.3f} ms (bound {k1_10_bound[0]:.4f} by "
                    f"{k1_10_bound[1]}) | K3 device us per group: {k3_split} "
                    f"| one K3 step {step_ms:.3f} ms, device busy "
                    f"{busy:.1%}")
        del init32, f32_10
        torch.cuda.empty_cache()

        # 4m. the pool stages, K3's pool write and K3's slot passes alone,
        # at K1's, K3's and the bench's shapes, on unigram pools over
        # synthetic-10m and this step's walks, and on hub-heavy pools and
        # groups
        pools4m = pool_phase(dev, smi, V, (acc10, ali10), gen,
                             pad_walks(walks10), L)
        f32_4m = f32_phase(dev, smi, V, (acc10, ali10), gen,
                           pad_walks(walks10), L)

        # 4k (K3). K3 at d 256 on this step's inputs (synthetic-10m's step
        # shape, SR), under K3's check
        k3_256 = blog_wide_checks(dev, {"K3": (
            "K3", (walks10, wrow10, pools10),
            dict(window=W, pool_refresh=R, sr_seed=12345))}, V)
        phase("wide 256 K3", f"phase 4f's step at d 256 (V {V}, {G} groups, "
                             f"KP {KP}, SR) vs plain under K3's check: "
                             + wide_text(k3_256) + f" | {smi}")
        torch.cuda.empty_cache()

        # 4g. P1: gather and scatter-add of N rows of a [500000, 128] table
        reset_counts()
        p1 = {}
        for dtype, es in ((torch.float32, 4), (torch.bfloat16, 2)):
            table = torch.randn((V, d), generator=gen, device=dev).to(dtype)
            for N, reps in ((2048, 16), (262144, 4)):
                # each timed call takes a fresh set of rows, so a set cached in
                # L2 by the call before does not stand in for device memory
                sets = [torch.randperm(V, generator=gen, device=dev)[:N].to(
                    torch.int32) for _ in range(reps)]
                idx = sets[0]
                upd = torch.randn((N, d), generator=gen, device=dev).to(dtype)
                rows_k, cs_k = row_gather_probe(table, idx)
                rows_p, cs_p = row_gather_probe_reference(table, idx)
                tk = row_scatter_probe(table.clone(), idx, upd)
                tp = row_scatter_probe_reference(table.clone(), idx, upd)
                torch.cuda.synchronize()
                if not (torch.equal(rows_k, rows_p) and torch.equal(tk, tp)) or \
                        abs(float(cs_k) - float(cs_p)) > 1e-12 * abs(float(cs_p)):
                    raise AssertionError(f"P1 {dtype} N={N}: rows, checksum "
                                         f"{float(cs_k)} vs {float(cs_p)} or "
                                         f"scatter-add differ")
                del tk, tp
                sets64 = [i.long() for i in sets]

                def per_call(fn, ids):
                    return cuda_ms(lambda: [fn(i) for i in ids]) / len(ids)

                g_ms = per_call(lambda i: row_gather_probe(table, i), sets)
                g_plain = per_call(
                    lambda i: row_gather_probe_reference(table, i), sets)
                g_lib = per_call(lambda i: torch.index_select(table, 0, i),
                                 sets64)
                s_ms = per_call(lambda i: row_scatter_probe(table, i, upd), sets)
                s_lib = per_call(lambda i: table.index_add_(0, i, upd), sets64)
                # the device readings only inform: the check is above and
                # the kernels line takes the CUDA-event times
                dev_us = [
                    device_us(lambda i: row_gather_probe(table, i), sets,
                              "row_gather", required=False),
                    device_us(lambda i: torch.index_select(table, 0, i),
                              sets64, required=False),
                    device_us(lambda i: row_scatter_probe(table, i, upd),
                              sets, "row_scatter", required=False),
                    device_us(lambda i: table.index_add_(0, i, upd),
                              sets64, required=False),
                ]
                gb = 2.0 * N * d * es + 4.0 * N
                sb = 3.0 * N * d * es + 4.0 * N
                p1[(es, N)] = dict(
                    g_ms=g_ms, g_plain=g_plain, g_lib=g_lib, s_ms=s_ms,
                    s_lib=s_lib, dev_us=dev_us, g_bound=bound(0.0, gb, False),
                    s_bound=bound(float(N * d), sb, False),
                    cs_err=abs(float(cs_k) - float(cs_p)))
                def us(t, nbytes=None):
                    """A device reading; a rate past the card's peak means
                    the profiler lost some of the session's records."""
                    if t is None:
                        return "not measured"
                    if nbytes is None:
                        return f"{t:.2f} us"
                    if nbytes / (t * 1e-6) > HBM_BPS:
                        return f"not measured ({t:.2f} us is past the peak)"
                    return (f"{t:.2f} us ({nbytes / t / 1e3:.1f} GB/s, "
                            f"{nbytes / (t * 1e-6) / HBM_BPS:.1%} of 3.35 "
                            f"TB/s)")

                du = dev_us
                phase("P1", f"{str(dtype)[6:]} rows of {d * es} B, N={N}: "
                            f"checksum {float(cs_k):.6f} (plain "
                            f"{float(cs_p):.6f}) | per call (CUDA events): "
                            f"gather {g_ms * 1e3:.2f} us, index_select "
                            f"{g_lib * 1e3:.2f} us, plain {g_plain * 1e3:.2f}"
                            f" us, scatter-add {s_ms * 1e3:.2f} us, "
                            f"index_add_ {s_lib * 1e3:.2f} us | device "
                            f"(profiler): gather {us(du[0], gb)}, "
                            f"index_select {us(du[1])}, scatter-add "
                            f"{us(du[2], sb)}, index_add_ {us(du[3])}")
            del table
        p1_launches = counts()
        torch.cuda.empty_cache()

        return dict(k3_err=k3_err, k3_ms=k3_ms, k3_plain_ms=k3_plain_ms,
                    k3_bound=k3_bound, p1=p1, p1_launches=p1_launches,
                    k3_256=k3_256["K3"], pools=pools4m, f32=f32_4m)

    lv = large_v_kernels()
    lv["star"] = star4m  # phase 4m's star cases, read as its other cases
    torch.cuda.empty_cache()

    # 5. the main path, through the CLI's own entry
    from come_tpu_torch.main import build_argparser, run

    def check_run(where, hist, nmi_floor):
        for rec in hist:
            for k in ("gmm_ll", "o1_loss", "o2_loss", "o3_loss", "nmi"):
                if not math.isfinite(rec[k]):
                    raise AssertionError(f"{where}: {k} = {rec[k]}")
        if hist[-1]["nmi"] < nmi_floor:
            raise AssertionError(f"{where}: NMI {hist[-1]['nmi']:.4f} < "
                                 f"{nmi_floor}")


    reset_counts()
    t0 = time.perf_counter()
    trainer, hist = run(build_argparser().parse_args([
        "--dataset", "blogcatalog", "--device", "cuda",
        "--pretrain-epochs", "1", "--outer-iters", "1", "--seed", str(SEED),
    ]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    main_graphs = graph_line("main path", launch_plan.graph_counts(), True)
    rec = hist[-1]
    check_launches("main path", launches, ("walk_sgns", "star_sgns"),
                   ("fused_sgns", "fused_sgns_tied", "walk_sgns_bf16",
                    "star_sgns_bf16", "walk_sgns_gen", "walk_sgns_gen_bf16",
                    "walk_sgns_paired"))
    for k in ("gmm_ll", "o1_loss", "o2_loss", "o3_loss", "nmi"):
        if not math.isfinite(rec[k]):
            raise AssertionError(f"main path: {k} = {rec[k]}")
    emb = trainer.embeddings()
    if emb.shape != (V, d) or not np.isfinite(emb).all():
        raise AssertionError("main path: embeddings not finite [V, d]")
    if rec["o2_pairs"] != 2 * ds.graph.num_edges:
        raise AssertionError("main path: O2 did not train every edge twice")
    if rec["nmi"] < NMI_FLOOR:
        raise AssertionError(f"main path: NMI {rec['nmi']:.4f} < {NMI_FLOOR}")
    if launches["stage_pool"] == 0:
        raise AssertionError("main path launched no pool stage")
    # R 1: every group ends its block, so every f32 scatter holds its pool
    main_walk_pools = check_walk_pools("main path", launches, True)
    main_star_pools = check_star_pools("main path", launches, True)
    main_o1_ms = rec["o1_ms"]
    main_emb = torch.as_tensor(emb, device=dev)  # phase 21's table
    phase("main", f"blogcatalog pretrain 1 + outer 1 in {wall:.1f} s: "
                  f"gmm {rec['gmm_ms']:.1f} ms, o1 {rec['o1_ms']:.1f} ms, "
                  f"o2 {rec['o2_ms']:.1f} ms, o3 {rec['o3_ms']:.1f} ms | "
                  f"o1_pairs {rec['o1_pairs']:.0f} o2_pairs "
                  f"{rec['o2_pairs']:.0f} | NMI {rec['nmi']:.4f} | "
                  f"launches {launches} | the walk steps' pool passes "
                  f"{main_walk_pools}, the star steps' {main_star_pools} | "
                  f"graphs: {main_graphs}")
    del trainer
    torch.cuda.empty_cache()

    # 5b. the main path at dim 256, through the CLI: K1 and K2 with their
    # f32 wide passes, G1 with its matrices in device memory;
    # then the paired CLI at dim 256 (K1 and K5)
    wide_runs = {}
    for tag, extra, ran in (
            ("main 256", [], ("walk_sgns", "star_sgns")),
            ("paired 256", ["--o2-mode", "paired"],
             ("walk_sgns", "walk_sgns_paired"))):
        reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        trainer, hist = run(build_argparser().parse_args([
            "--dataset", "blogcatalog", "--device", "cuda", "--dim", "256",
            "--pretrain-epochs", "1", "--outer-iters", "1", "--seed",
            str(SEED), *extra]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        got = counts()
        check_launches(tag, got, ran,
                       tuple(k for k in kernels if k not in ran))
        check_walk_pools(tag, got, True)
        if not extra:  # K2 at R 1: every group ends its block
            check_star_pools(tag, got, True)
        check_run(tag, hist, NMI_FLOOR)
        rec = hist[-1]
        emb = trainer.embeddings()
        if emb.shape != (ds.graph.num_nodes, 256) or not np.isfinite(
                emb).all():
            raise AssertionError(f"{tag}: embeddings not finite [V, 256]")
        if not extra and rec["o2_pairs"] != 2 * ds.graph.num_edges:
            raise AssertionError(f"{tag}: O2 did not train every edge twice")
        wide_runs[tag] = dict(launches=got, emb=emb, o1_ms=rec["o1_ms"])
        routes = path_routes(tag, "whole")
        phase(tag, f"blogcatalog --dim 256{''.join(' ' + e for e in extra)},"
                   f" pretrain 1 + outer 1 in {wall:.1f} s: gmm {rec['gmm_ms']:.1f} ms, o1 "
                   f"{rec['o1_ms']:.1f} ms, o2 {rec['o2_ms']:.1f} ms, o3 "
                   f"{rec['o3_ms']:.1f} ms | NMI {rec['nmi']:.4f} | G1 "
                   f"launches: factor {got['gmm_factor']}, inverse "
                   f"{got['gmm_inverse']} | peak device memory {peak:.2f} GiB"
                   f" | launches {got} | steps by band/star route {routes} "
                   f"| {smi}")
        del trainer
        torch.cuda.empty_cache()
    main256_emb = torch.as_tensor(wide_runs["main 256"]["emb"], device=dev)
    wide_launches = wide_runs["main 256"]["launches"]
    paired256_launches = wide_runs["paired 256"]["launches"]

    # the tiers' kernel names (ComETrainer.tier_kernels) by launch counter
    counter = {"K1": "walk_sgns", "K1b": "walk_sgns_bf16",
               "K3": "walk_sgns_bf16_tables", "K4": "walk_sgns_gen_bf16",
               "K5": "walk_sgns_paired", "K2": "star_sgns",
               "K2b": "star_sgns_bf16", "K6": "fused_sgns",
               "K7": "fused_sgns_tied"}

    def tier_check(where, trainer, named):
        """The counters of the kernels the trainer's tiers name, which must
        be ``named``."""
        if trainer.tier_kernels() != named:
            raise AssertionError(f"{where}: tiers {trainer.tier_kernels()}, "
                                 f"expected {named}")
        return tuple(counter[k] for k in named)

    def bench_run(where, walk_gen, named, dim=128):
        """The reference bench's kernel configuration (bench.py:174-216)
        through ComETrainer at ``dim``: its tiers name ``named`` and
        launch those kernels and no other, NMI >= NMI_FLOOR."""
        cfg = get_config("blogcatalog").replace(
            num_communities=ds.num_communities, walk_kernel_bf16=True,
            walk_pool_refresh=8, batch_walks=2048, batch_edges=524288,
            walk_gen=walk_gen, pretrain_epochs=1, outer_iters=1, seed=SEED,
            dim=dim,
        )
        reset_counts()
        t0 = time.perf_counter()
        trainer = ComETrainer(ds.graph, cfg, dev)
        ran = tier_check(where, trainer, named)
        hist = trainer.train(ds.single_labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        graphs = graph_line(where, launch_plan.graph_counts(), True)
        check_launches(where, launched, ran,
                       tuple(k for k in kernels if k not in ran))
        check_walk_pools(where, launched)  # R 8: 7 groups in 8 end no block
        check_star_pools(where, launched)
        # past d 192 the bf16 passes stage their pools as bf16 rows
        if (launched["stage_pool_bf16"] == 0) == (dim > 192):
            raise AssertionError(f"{where}: {launched['stage_pool_bf16']} "
                                 f"bf16 stages at dim {dim}")
        check_run(where, hist, NMI_FLOOR)
        routes = path_routes(where, "rows" if dim <= 192 else "whole")
        rec = hist[-1]
        phase(where, f"blogcatalog + bf16, R 8, batch_walks 2048, "
                     f"batch_edges 524288, walk_gen {walk_gen}, dim {dim}, "
                     f"pretrain 1 + outer 1 in {wall:.1f} s: gmm "
                     f"{rec['gmm_ms']:.1f} ms, "
                     f"o1 {rec['o1_ms']:.1f} ms, o2 {rec['o2_ms']:.1f} ms, o3 "
                     f"{rec['o3_ms']:.1f} ms | o1_pairs {rec['o1_pairs']:.0f} "
                     f"o2_pairs {rec['o2_pairs']:.0f} | NMI "
                     f"{rec['nmi']:.4f} | launches {launched} | steps by "
                     f"band/star route {routes} | graphs: {graphs}")
        return launched

    # 5c. the trainer at dim 256 through every other tier: past 192 each
    # of their kernels runs its wide passes (bench_run and phases
    # 9, 10 and 14's configurations at the same cuts and floors; K3 on the
    # blogcatalog preset with the 48 MiB line at 0, as
    # tests/test_torch_wide.py's TIERS test sets it)
    from come_tpu_torch.trainer import come as trainer_come

    tiers256 = {
        "bench 256": bench_run("bench 256", "scan", ("K1b", "K2b"), 256),
        "bench gen 256": bench_run("bench gen 256", "kernel", ("K4", "K2b"),
                                   256),
    }
    # the micro-batched path through the CLI (phase 10's cut and checks)
    reset_counts()
    t0 = time.perf_counter()
    trainer, hist = run(build_argparser().parse_args([
        "--dataset", "blogcatalog", "--device", "cuda", "--down-sample",
        "1e-3", "--o2-mode", "xla", "--pretrain-epochs", "0",
        "--outer-iters", "1", "--walks-per-node", "2", "--seed", str(SEED),
        "--dim", "256",
    ]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = tiers256["micro 256"] = counts()
    ran = tier_check("micro 256", trainer, ("K6", "K7"))
    check_launches("micro 256", got, ran,
                   tuple(k for k in kernels if k not in ran))
    check_run("micro 256", hist, 0.0)
    rec = hist[-1]
    emb = trainer.embeddings()
    if emb.shape != (ds.graph.num_nodes, 256) or not np.isfinite(emb).all():
        raise AssertionError("micro 256: embeddings not finite [V, 256]")
    B5, S5 = trainer.o2_arc_plan()
    if rec["o2_pairs"] != S5 * B5:
        raise AssertionError(f"micro 256: o2_pairs {rec['o2_pairs']} != "
                             f"S*B = {S5}*{B5}")
    counts5c = launch_plan.graph_counts()
    graphs5c = graph_line("micro 256", counts5c, True)
    phase("micro 256", f"blogcatalog --dim 256 --down-sample 1e-3 --o2-mode "
                       f"xla, walks per node 2, outer 1 in {wall:.1f} s: o1 "
                       f"{rec['o1_ms']:.1f} ms, o2 {rec['o2_ms']:.1f} ms | "
                       f"NMI {rec['nmi']:.4f} | launches {got} | "
                       f"{micro_path(counts5c)} | graphs: {graphs5c}")
    del trainer
    # karate with shared negatives (phase 9's configuration and floor)
    karate = get_dataset("karate")
    cfg = get_config("karate").replace(
        negative_mode="shared", shared_negatives=32, pallas_tile_pairs=64,
        outer_iters=1, pretrain_epochs=2, walks_per_node=4, seed=SEED,
        dim=256,
    )
    reset_counts()
    trainer = ComETrainer(karate.graph, cfg, dev)
    ran = tier_check("shared 256", trainer, ("K6", "K7"))
    hist = trainer.train(karate.labels)
    torch.cuda.synchronize()
    got = tiers256["shared 256"] = counts()
    check_launches("shared 256", got, ran,
                   tuple(k for k in kernels if k not in ran))
    check_run("shared 256", hist, KARATE_SHARED_NMI_FLOOR)
    counts5c = launch_plan.graph_counts()
    graphs5c = graph_line("shared 256", counts5c, True)
    phase("shared 256", f"karate shared negatives at dim 256: NMI "
                        f"{hist[-1]['nmi']:.4f} | launches {got} | "
                        f"{micro_path(counts5c)} | graphs: {graphs5c}")
    del trainer
    # K3: the blogcatalog preset on bf16 O1 tables (the 48 MiB line at 0),
    # pretrain 1 + outer 1 as phase 5
    line = trainer_come.WALK_F32_TABLE_BYTES
    trainer_come.WALK_F32_TABLE_BYTES = 0
    try:
        reset_counts()
        t0 = time.perf_counter()
        trainer = ComETrainer(ds.graph, get_config("blogcatalog").replace(
            num_communities=ds.num_communities, dim=256, pretrain_epochs=1,
            outer_iters=1, seed=SEED), dev)
        ran = tier_check("K3 256", trainer, ("K3", "K2"))
        hist = trainer.train(ds.single_labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        trainer_come.WALK_F32_TABLE_BYTES = line
    got = tiers256["K3 256"] = counts()
    for k in ("apply_pool_bf16", "stage_pool_bf16", "slot_chains",
              "walk_scatter_bf16"):
        if got[k] == 0:
            raise AssertionError(f"K3 256 launched no {k} kernel")
    check_launches("K3 256", got, ran,
                   tuple(k for k in kernels if k not in ran))
    check_run("K3 256", hist, NMI_FLOOR)
    routes = path_routes("K3 256", "whole")
    rec = hist[-1]
    phase("K3 256", f"blogcatalog --dim 256 on bf16 O1 tables, pretrain 1 + "
                    f"outer 1 in {wall:.1f} s: o1 {rec['o1_ms']:.1f} ms, o2 "
                    f"{rec['o2_ms']:.1f} ms | NMI {rec['nmi']:.4f} | "
                    f"launches {got} | steps by band/star route {routes} | "
                    f"{smi}")
    del trainer
    torch.cuda.empty_cache()

    # 6. K6 at the BlogCatalog width: the first micro-step of one macro step
    V, d, TP = ds.graph.num_nodes, 128, 1024
    keep = torch.as_tensor(subsample_keep_probs(ds.graph.degrees, 1e-3),
                           device=dev)
    emb_in = torch.randn((V, d), generator=gen, device=dev) * 0.1
    emb_out = torch.randn((V, d), generator=gen, device=dev) * 0.1
    c, x, m = (a.reshape(-1)[:32768] for a in
               skipgram_pairs(walks, W, gen, keep))
    pool = sample_alias(accept, alias, gen, (KP,))

    def k6(fn):
        return fn(emb_in.clone(), emb_out.clone(), c, x, pool, m, lr, negw,
                  tile_pairs=TP)

    # six micro-steps through one fresh plan, each held against its plain
    # version (fused_steps), then the phase's own pairs
    launch_plan.release_plans(lib, "fused_sgns")
    launch_plan.reset_counts()
    seq6 = fused_steps(False, dev, V, d, 32768, TP, KP)
    seq6_line = fused_counts("K6 plan", "fused_sgns")
    # 40 micro-steps enqueued back to back, at this shape, karate's and
    # this shape at d 256 (the wide negative pass)
    stress6 = {"this shape": fused_stress(False, dev, V, d, 32768, TP, KP),
               "karate's": fused_stress(False, dev, 34, 16, 128, 64, 32),
               "d 256": fused_stress(False, dev, V, 256, 32768, TP, KP)}
    for errs in stress6.values():
        seq6 += errs
    # a macro batch of 40 micro-steps as one scan, at the same shapes
    scan6 = {"this shape": fused_scan_check(False, dev, V, d, 32768, TP, KP),
             "karate's": fused_scan_check(False, dev, 34, 16, 128, 64, 32),
             "d 256": fused_scan_check(False, dev, V, 256, 32768, TP, KP)}
    kern6 = k6(fused_sgns_step)
    plain6 = k6(fused_sgns_step_reference)
    torch.cuda.synchronize()
    k6_err = compare("K6", (emb_in, emb_out), kern6, plain6)
    k6_err = max(k6_err[0], max(e[0] for e in seq6)), *k6_err[1:]
    k6_bound = pairs_bound(c, x, m, pool, d, False)
    k6_plain_ms = cuda_ms(lambda: k6(fused_sgns_step_reference))
    work = [emb_in.clone(), emb_out.clone()]  # updated in place, no clones
    k6_t = fused_times(lambda: fused_sgns_step(
        *work, c, x, pool, m, lr, negw, tile_pairs=TP))
    k6_ms = k6_t["ms"]
    phase("K6", f"fused_sgns V={V} d={d} P={c.numel()} TP={TP} KP={KP} "
                f"(32 tiles): max_abs {k6_err[0]:.3e} max_rel "
                f"{k6_err[1]:.3e} loss_rel {k6_err[2]:.3e} pairs "
                f"{float(kern6[3]):.0f}; 6 steps through one plan (new lr, "
                f"pairs, pool; tables moved once; tile 2 all masked) and "
                f"3 x 40 enqueued back to back (this shape, karate's, this "
                f"shape at d 256) worst "
                f"max_abs {max(e[0] for e in seq6):.3e} max_rel "
                f"{max(e[1] for e in seq6):.3e} ({seq6_line}); back to back "
                + "; ".join(f"{k} {stress_worst(v)}"
                            for k, v in stress6.items()) + " | one scan of "
                f"40 micro-steps (one launch) against the plain loop, final "
                f"tables: {scan_text(scan6)} | "
                f"{fused_text(k6_t)}, plain {k6_plain_ms:.3f} ms (tol "
                f"{ATOL} + {RTOL}*|plain update|)")

    # 7. K7 on the tied table: 32768 shuffled arcs
    src, dst = (torch.as_tensor(a, device=dev) for a in ds.graph.arcs())
    arcs = torch.randperm(src.numel(), generator=gen, device=dev)[:32768]
    ones = torch.ones(arcs.numel(), device=dev)

    def k7(fn):
        return fn(emb_in.clone(), src[arcs], dst[arcs], pool, ones, lr, negw,
                  tile_pairs=TP)

    launch_plan.release_plans(lib, "fused_sgns_tied")
    launch_plan.reset_counts()
    seq7 = fused_steps(True, dev, V, d, 32768, TP, KP)
    seq7_line = fused_counts("K7 plan", "fused_sgns_tied")
    stress7 = {"this shape": fused_stress(True, dev, V, d, 32768, TP, KP),
               "karate's": fused_stress(True, dev, 34, 16, 128, 64, 32),
               "d 256": fused_stress(True, dev, V, 256, 32768, TP, KP)}
    for errs in stress7.values():
        seq7 += errs
    scan7 = {"this shape": fused_scan_check(True, dev, V, d, 32768, TP, KP),
             "karate's": fused_scan_check(True, dev, 34, 16, 128, 64, 32),
             "d 256": fused_scan_check(True, dev, V, 256, 32768, TP, KP)}
    kern7 = k7(fused_sgns_step_tied)
    plain7 = k7(fused_sgns_step_tied_reference)
    torch.cuda.synchronize()
    k7_err = compare("K7", (emb_in,), kern7, plain7)
    k7_err = max(k7_err[0], max(e[0] for e in seq7)), *k7_err[1:]
    k7_bound = pairs_bound(src[arcs], dst[arcs], ones, pool, d, True)
    k7_plain_ms = cuda_ms(lambda: k7(fused_sgns_step_tied_reference))
    work7 = emb_in.clone()
    c7, x7 = src[arcs], dst[arcs]
    k7_t = fused_times(lambda: fused_sgns_step_tied(
        work7, c7, x7, pool, ones, lr, negw, tile_pairs=TP))
    k7_ms = k7_t["ms"]
    phase("K7", f"fused_sgns_tied V={V} d={d} P={arcs.numel()} TP={TP} "
                f"KP={KP} (32 tiles): max_abs {k7_err[0]:.3e} max_rel "
                f"{k7_err[1]:.3e} loss_rel {k7_err[2]:.3e} pairs "
                f"{float(kern7[2]):.0f}; 6 steps through one plan and 3 x "
                f"40 back to back worst max_abs {max(e[0] for e in seq7):.3e} max_rel "
                f"{max(e[1] for e in seq7):.3e} ({seq7_line}); back to back "
                + "; ".join(f"{k} {stress_worst(v)}"
                            for k, v in stress7.items()) + " | one scan of "
                f"40 micro-steps (one launch) against the plain loop, final "
                f"tables: {scan_text(scan7)} | "
                f"{fused_text(k7_t)}, plain {k7_plain_ms:.3f} ms (tol "
                f"{ATOL} + {RTOL}*|plain update|)")
    del work, work7
    del emb_in, emb_out, kern6, plain6, kern7, plain7
    torch.cuda.empty_cache()

    # 4k (micro). K6 and K7 at d 256 on phases 6 and 7's pairs (32 tiles;
    # the wide negative pass)
    blog256.update(blog_wide_checks(dev, {
        "K6": ("K6", (c, x, pool, m), dict(tile_pairs=TP)),
        "K7": ("K7", (c7, x7, pool, ones), dict(tile_pairs=TP)),
    }, V))
    phase("wide 256 micro", f"phases 6 and 7's steps at d 256 ({c.numel()} "
                            f"and {c7.numel()} pairs in tiles of {TP}, KP "
                            f"{KP}) vs plain (tol {ATOL} + {RTOL}*|plain "
                            f"update|): " + wide_text(
                                {k: blog256[k] for k in ("K6", "K7")})
                            + f" | {smi}")
    torch.cuda.empty_cache()

    # 8. karate, the CLI's default preset: per-pair negatives, no kernel
    karate = get_dataset("karate")
    reset_counts()
    trainer, hist = run(build_argparser().parse_args([
        "--dataset", "karate", "--device", "cuda", "--seed", str(SEED),
    ]))
    torch.cuda.synchronize()
    launches8 = counts()
    check_launches("karate per-pair", launches8, (), tuple(kernels))
    check_run("karate per-pair", hist, KARATE_NMI_FLOOR)
    phase("karate", f"per-pair preset: NMI {hist[-1]['nmi']:.4f}, o1 "
                    f"{hist[-1]['o1_ms']:.1f} ms, o2 {hist[-1]['o2_ms']:.1f} "
                    f"ms | launches {launches8}")

    # 9. karate with shared negatives (tests/test_pallas_trainer.py:14-22)
    cfg = get_config("karate").replace(
        negative_mode="shared", shared_negatives=32, pallas_tile_pairs=64,
        outer_iters=1, pretrain_epochs=2, walks_per_node=4, seed=SEED,
    )
    reset_counts()
    hist = ComETrainer(karate.graph, cfg, dev).train(karate.labels)
    torch.cuda.synchronize()
    launches9 = counts()
    check_launches("karate shared", launches9,
                   ("fused_sgns", "fused_sgns_tied"),
                   tuple(k for k in kernels if not k.startswith("fused")))
    check_run("karate shared", hist, KARATE_SHARED_NMI_FLOOR)
    counts9 = launch_plan.graph_counts()
    graphs9 = graph_line("karate shared", counts9, True)
    if not counts9["fused_scan"]["replays"] or counts9["fused_sgns"][
            "replays"]:
        raise AssertionError(f"karate shared: K6 ran outside its scans "
                             f"({micro_path(counts9)})")
    phase("shared", f"karate shared negatives: NMI {hist[-1]['nmi']:.4f} | "
                    f"launches {launches9} | {micro_path(counts9)} | "
                    f"graphs: {graphs9}")

    # 10. the micro-batched main path through the CLI
    reset_counts()
    t0 = time.perf_counter()
    trainer, hist = run(build_argparser().parse_args([
        "--dataset", "blogcatalog", "--device", "cuda", "--down-sample",
        "1e-3", "--o2-mode", "xla", "--pretrain-epochs", "0",
        "--outer-iters", "1", "--walks-per-node", "2", "--seed", str(SEED),
    ]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    micro_launches = counts()
    counts10 = launch_plan.graph_counts()
    micro_graphs = graph_line("micro-batched path", counts10, True)
    if not counts10["fused_scan"]["replays"] or counts10["fused_sgns"][
            "replays"]:
        raise AssertionError(f"micro-batched path: K6 ran outside its scans "
                             f"({micro_path(counts10)})")
    check_launches("micro-batched path", micro_launches,
                   ("fused_sgns", "fused_sgns_tied"),
                   tuple(k for k in kernels if not k.startswith("fused")))
    check_run("micro-batched path", hist, 0.0)
    rec = hist[-1]
    emb = trainer.embeddings()
    if emb.shape != (V, d) or not np.isfinite(emb).all():
        raise AssertionError("micro-batched path: embeddings not finite")
    B, S = trainer.o2_arc_plan()
    if S != math.ceil(ds.graph.num_arcs / trainer.cfg.batch_edges) or (
            rec["o2_pairs"] != S * B):
        raise AssertionError(f"micro-batched path: o2_pairs "
                             f"{rec['o2_pairs']} != S*B = {S}*{B}")
    phase("micro", f"blogcatalog --down-sample 1e-3 --o2-mode xla, walks "
                   f"per node 2, outer 1 in {wall:.1f} s: gmm "
                   f"{rec['gmm_ms']:.1f} ms, o1 {rec['o1_ms']:.1f} ms, o2 "
                   f"{rec['o2_ms']:.1f} ms, o3 {rec['o3_ms']:.1f} ms | "
                   f"o1_pairs {rec['o1_pairs']:.0f} o2_pairs "
                   f"{rec['o2_pairs']:.0f} (S={S}, B={B}) | NMI "
                   f"{rec['nmi']:.4f} | launches {micro_launches} | "
                   f"{micro_path(counts10)} | graphs: {micro_graphs}")
    del trainer
    torch.cuda.empty_cache()

    # 11. the paired O2 entry point through the CLI
    reset_counts()
    t0 = time.perf_counter()
    trainer, hist = run(build_argparser().parse_args([
        "--dataset", "blogcatalog", "--device", "cuda", "--o2-mode",
        "paired", "--pretrain-epochs", "1", "--outer-iters", "1", "--seed",
        str(SEED),
    ]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paired_launches = counts()
    check_launches("paired path", paired_launches,
                   ("walk_sgns", "walk_sgns_paired"),
                   tuple(k for k in kernels
                         if k not in ("walk_sgns", "walk_sgns_paired")))
    check_run("paired path", hist, NMI_FLOOR)
    rec = hist[-1]
    B_r, S = trainer.o2_paired_plan()
    if rec["o2_pairs"] != 2 * S * B_r * 64:
        raise AssertionError(f"paired path: o2_pairs {rec['o2_pairs']} != "
                             f"2*S*B_r*64 = 2*{S}*{B_r}*64")
    phase("paired", f"blogcatalog --o2-mode paired, pretrain 1 + outer 1 in "
                    f"{wall:.1f} s: gmm {rec['gmm_ms']:.1f} ms, o1 "
                    f"{rec['o1_ms']:.1f} ms, o2 {rec['o2_ms']:.1f} ms, o3 "
                    f"{rec['o3_ms']:.1f} ms | o1_pairs {rec['o1_pairs']:.0f} "
                    f"o2_pairs {rec['o2_pairs']:.0f} (S={S}, B_r={B_r}) | "
                    f"NMI {rec['nmi']:.4f} | launches {paired_launches}")
    del trainer
    torch.cuda.empty_cache()

    # 11b. the host corpus: the blogcatalog preset with corpus="host", its
    # walks made by the C++ walker on host threads into pinned memory and
    # copied to the card batch by batch, trained through K1
    from come_tpu_torch.native import HostWalkFeeder

    cfg = get_config("blogcatalog").replace(
        num_communities=ds.num_communities, corpus="host",
        pretrain_epochs=1, outer_iters=1, seed=SEED,
    )
    trainer = ComETrainer(ds.graph, cfg, dev)
    if not trainer.o1_walk_kernel or trainer.o1_gen or (
            trainer.o1_table_dtype != torch.float32):
        raise AssertionError("host corpus: O1 does not take K1")
    B = min(cfg.batch_walks, len(trainer.walk_starts))
    n_per_epoch = math.ceil(len(trainer.walk_starts) * cfg.walks_per_node / B)
    # every batch as the card got it, copied into one buffer allocated
    # before the run (keeping each batch's own tensor would make the
    # allocator take new device memory every few steps, inside the timed
    # epoch); and two K1 steps' inputs and tables
    trained = torch.empty((2 * n_per_epoch, B, cfg.walk_length),
                          dtype=torch.int32, device=dev)
    held = {}
    n_trained = [0]
    o1_step = trainer.o1_step

    def spy(walks, wrow, pools):
        i = n_trained[0]
        n_trained[0] += 1
        trained[i].copy_(walks)
        if i not in (0, n_per_epoch):
            return o1_step(walks, wrow, pools)
        p = trainer.params
        init = (p.node_emb.clone(), p.ctx_emb.clone())
        lr = trainer.lr()
        out = o1_step(walks, wrow, pools)
        held[i] = (init, (p.node_emb.clone(), p.ctx_emb.clone(), *out),
                   (walks, wrow, pools, lr))
        return out

    trainer.o1_step = spy
    reset_counts()
    t0 = time.perf_counter()
    try:
        hist = trainer.train(ds.single_labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        host_launches = counts()
        feeder = trainer.host_feeder()
        fed, wait_ms = feeder.batches, feeder.wait_s * 1e3
        produce_ms = feeder.produce_s * 1e3
    finally:
        trainer.close()
    ran = ("walk_sgns", "star_sgns")
    check_launches("host corpus", host_launches, ran,
                   tuple(k for k in kernels if k not in ran))
    check_run("host corpus", hist, NMI_FLOOR)
    if n_trained[0] != 2 * n_per_epoch or host_launches["walk_sgns"] != (
            2 * n_per_epoch):
        raise AssertionError(f"host corpus: {n_trained[0]} batches, "
                             f"{host_launches['walk_sgns']} K1 launches, "
                             f"expected {2 * n_per_epoch}")
    # the batches the card trained are the walker's sequence bit for bit
    # (no pinned buffer was overwritten while its copy was in flight)
    got = trained.cpu().numpy()
    with HostWalkFeeder(ds.graph, batch=B, length=cfg.walk_length,
                        seed=SEED, restart_prob=cfg.restart_prob,
                        nodes=trainer.walk_starts) as ref:
        want = np.stack([next(ref).numpy() for _ in range(len(trained))])
    if not np.array_equal(got, want):
        bad = np.flatnonzero((got != want).any((1, 2)))
        raise AssertionError(f"host corpus: batches {bad[:8].tolist()} on "
                             f"the card differ from the walker's")
    host_errs = []
    for i, (init, kern, (w, wr, pl, lr)) in sorted(held.items()):
        plain = walk_sgns_step_reference(
            init[0].clone(), init[1].clone(), w, wr, pl, lr, trainer.negw,
            window=cfg.window, pool_refresh=cfg.walk_pool_refresh,
        )
        torch.cuda.synchronize()
        host_errs.append(compare(f"K1 host step {i}", init, kern, plain))
    rec = hist[-1]
    del trained, held, got, want
    phase("host", f"blogcatalog corpus=host, pretrain 1 + outer 1 in "
                  f"{wall:.1f} s: o1 {rec['o1_ms']:.1f} ms (device walker, "
                  f"main: {main_o1_ms:.1f} ms), gmm {rec['gmm_ms']:.1f} ms, "
                  f"o2 {rec['o2_ms']:.1f} ms, o3 {rec['o3_ms']:.1f} ms | "
                  f"{fed} batches of {B} walks trained, queue wait "
                  f"{wait_ms:.1f} ms in all, walker {produce_ms:.1f} ms on "
                  f"its thread; every batch the walker's bit for bit | K1 "
                  f"steps 0 and {n_per_epoch} vs plain: max_abs "
                  f"{max(e[0] for e in host_errs):.3e} max_rel "
                  f"{max(e[1] for e in host_errs):.3e} (tol {ATOL} + "
                  f"{RTOL}*|plain update|) | NMI {rec['nmi']:.4f} | launches "
                  f"{host_launches}")
    del trainer
    torch.cuda.empty_cache()

    # 11c. persistence: a checkpoint per outer iteration, a fresh trainer
    # resumed from the first and run one iteration beside the uninterrupted
    # run's second, the word2vec text of the trained table, and
    # node-classification F1 fitted on the card
    import tempfile

    from come_tpu_torch.evaluation import node_classification_f1
    from come_tpu_torch.iohelpers import (
        load_embedding_word2vec,
        save_embedding_word2vec,
    )

    cfg = get_config("blogcatalog").replace(
        num_communities=ds.num_communities, pretrain_epochs=1, outer_iters=2,
        seed=SEED,
    )
    with tempfile.TemporaryDirectory() as tmp:
        ck = Path(tmp) / "ck"
        reset_counts()
        t1 = ComETrainer(ds.graph, cfg, dev)
        saved = []  # words_seen and both generators at each save
        save = t1.save_checkpoint

        def spy_save(path):
            saved.append((t1.words_seen, t1.gen.get_state(),
                          t1.host_gen.get_state()))
            save(path)

        t1.save_checkpoint = spy_save
        hist1 = t1.train(ds.single_labels, checkpoint_dir=ck)
        names = sorted(f.name for f in ck.iterdir())
        if names != ["state_iter0.npz", "state_iter1.npz"]:
            raise AssertionError(f"persist: checkpoint files {names}")
        t2 = ComETrainer(ds.graph, cfg, dev)
        restored = t2.load_checkpoint(ck / "state_iter0.npz")
        words0, gen0, host0 = saved[0]
        if restored != {"gen": True, "host_gen": True} or not (
                torch.equal(t2.gen.get_state(), gen0)
                and torch.equal(t2.host_gen.get_state(), host0)):
            raise AssertionError(f"persist: generators not restored "
                                 f"({restored})")
        if t2.words_seen != words0:
            raise AssertionError(f"persist: words_seen {t2.words_seen} "
                                 f"after the load, {words0} saved")
        rec2 = t2.outer_iteration(1, ds.single_labels)
        torch.cuda.synchronize()
        persist_launches = counts()
        if t2.words_seen != t1.words_seen:
            raise AssertionError(f"persist: words_seen {t2.words_seen} "
                                 f"resumed, {t1.words_seen} uninterrupted")
        check_run("persist", hist1 + [rec2], NMI_FLOOR)
        resume_err = {
            k: float((getattr(t1.params, k) - getattr(t2.params, k))
                     .abs().max())
            for k in ("node_emb", "ctx_emb", "centroid", "chol_cov",
                      "inv_cov", "pi")
        }
        # word2vec text of the trained table: every written value within
        # 5e-7 of the table (six decimals, correctly rounded; TEXT_SLACK
        # covers the float64 parse of the decimals, not the text), the
        # loader exact to the text
        emb = t1.embeddings()
        txt = Path(tmp) / "emb.txt"
        t0 = time.perf_counter()
        save_embedding_word2vec(txt, emb, ds.graph.node_names)
        save_s = time.perf_counter() - t0
        back, w2v_names = load_embedding_word2vec(txt)
        text = np.loadtxt(txt, skiprows=1,
                          usecols=range(1, emb.shape[1] + 1),
                          dtype=np.float64)
        text_err = float(np.abs(text - emb.astype(np.float64)).max())
        f32_err = float(np.abs(back.astype(np.float64)
                               - emb.astype(np.float64)).max())
        if (back.shape != emb.shape or len(w2v_names) != emb.shape[0]
                or text_err > 5e-7 + TEXT_SLACK
                or not np.array_equal(back, text.astype(np.float32))):
            raise AssertionError(f"persist: word2vec round trip, text "
                                 f"{text_err:.3e}, f32 {f32_err:.3e}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f1 = node_classification_f1(t1.params.node_emb, ds.labels, 0.5)
        f1_s = time.perf_counter() - t0
        if f1["macro_f1"] < F1_FLOOR:
            raise AssertionError(f"persist: macro-F1 {f1['macro_f1']:.4f} "
                                 f"< {F1_FLOOR}")
    check_launches("persist", persist_launches, ran,
                   tuple(k for k in kernels if k not in ran))
    exact = all(v == 0.0 for v in resume_err.values())
    phase("persist", f"blogcatalog pretrain 1 + outer 2 with "
                     f"checkpoint_dir: {names}; resumed from state_iter0 "
                     f"(words_seen {words0:.0f} exact, both generators "
                     f"restored), iteration 1 beside the uninterrupted run's:"
                     f" max|d| " + ", ".join(
                         f"{k} {v:.3e}" for k, v in resume_err.items())
                     + f" (bit-exact: {exact}), NMI {rec2['nmi']:.4f} vs "
                     f"{hist1[-1]['nmi']:.4f} | word2vec {emb.shape[0]}x"
                     f"{emb.shape[1]} written in "
                     f"{save_s:.2f} s: text max|d| {text_err:.3e} (<= 5e-7),"
                     f" f32 round trip {f32_err:.3e} | F1 at ratio 0.5 on "
                     f"cuda: macro {f1['macro_f1']:.4f} micro "
                     f"{f1['micro_f1']:.4f} in {f1_s:.2f} s | launches "
                     f"{persist_launches}")
    del t1, t2
    torch.cuda.empty_cache()

    # 12-13. the reference bench's kernel configuration through
    # ComETrainer, with the walker and with walk_gen="kernel" (bench_run:
    # phase 5c)
    bench_launches = bench_run("bench", "scan", ("K1b", "K2b"))
    gen_launches = bench_run("bench gen", "kernel", ("K4", "K2b"))

    # 14. the large-V path through the CLI: synthetic-10m at full width,
    # walks per node 5, pretrain 1, outer 1 (see the module docstring)
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    trainer, hist = run(build_argparser().parse_args([
        "--dataset", "synthetic-10m", "--device", "cuda", "--walks-per-node",
        "5", "--pretrain-epochs", "1", "--outer-iters", "1", "--seed",
        str(SEED),
    ]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    large_launches = counts()
    ran = ("walk_sgns_bf16_tables", "star_sgns")
    check_launches("large-v path", large_launches, ran,
                   tuple(k for k in kernels if k not in ran))
    check_run("large-v path", hist, NMI_FLOOR)
    rec = hist[-1]
    cfg10 = trainer.cfg
    n_starts = len(trainer.walk_starts) * cfg10.walks_per_node
    S10 = math.ceil(n_starts / min(cfg10.batch_walks, n_starts))
    epochs = cfg10.pretrain_epochs + cfg10.outer_iters
    # a walk trains at most sum_t min(W, t) + min(W, L-1-t) pairs (the full
    # window); each step wraps its B walks up to 8 * ceil(B / 8)
    L10 = cfg10.walk_length
    per_walk = sum(min(cfg10.window, t) + min(cfg10.window, L10 - 1 - t)
                   for t in range(L10))
    most = S10 * 8 * -(-cfg10.batch_walks // 8) * per_walk
    if large_launches["walk_sgns_bf16_tables"] != epochs * S10 or not (
            0 < rec["o1_pairs"] <= most):
        raise AssertionError(
            f"large-v path: {large_launches['walk_sgns_bf16_tables']} K3 "
            f"launches for {epochs} epochs of {S10} steps, o1_pairs "
            f"{rec['o1_pairs']} outside (0, {most}]")
    for k in ("stage_pool_bf16_tables", "apply_pool_bf16", "pool_chains",
              "stage_pool", "slot_chains", "walk_scatter_bf16"):
        if large_launches[k] == 0:
            raise AssertionError(f"large-v path launched no {k} kernel")
    if trainer.params.node_emb.dtype != torch.float32:
        raise AssertionError("large-v path: params not f32 after O1")
    emb = trainer.embeddings()
    g10 = trainer.graph
    if emb.shape != (g10.num_nodes, cfg10.dim) or not np.isfinite(emb).all():
        raise AssertionError("large-v path: embeddings not finite [V, d]")
    phase("large-v", f"synthetic-10m V={g10.num_nodes} E={g10.num_edges} K="
                     f"{cfg10.num_communities} KP={cfg10.shared_negatives}, "
                     f"walks per node 5, pretrain 1 + outer 1 in {wall:.1f} "
                     f"s: gmm {rec['gmm_ms']:.1f} ms, o1 {rec['o1_ms']:.1f} "
                     f"ms ({S10} steps), o2 {rec['o2_ms']:.1f} ms, o3 "
                     f"{rec['o3_ms']:.1f} ms | o1_pairs {rec['o1_pairs']:.0f} "
                     f"({rec['o1_pairs'] / rec['o1_ms'] / 1e3:.2f} M/s) "
                     f"o2_pairs {rec['o2_pairs']:.0f} | NMI {rec['nmi']:.4f} "
                     f"| peak device memory {peak_gb:.2f} GiB | o1 epoch "
                     f"{rec['o1_ms'] / 1e3:.2f} s at walks per node "
                     f"5 (PERF.md section 5 reads 30.5-33 s at full depth)"
                     f" | launches {large_launches}")
    del trainer
    torch.cuda.empty_cache()

    # 15. the probes P2-P4, each through its tools/ entry point
    from come_tpu_torch.tools import probe_smem, probe_star, probe_star_floor

    reset_counts()
    p2 = probe_smem.capacity_search(dev, log=lambda m: phase("P2", m))
    x8 = torch.ones((8, 128), device=dev)
    optin = smem_optin_bytes()
    p2_sum = smem_probe(x8, optin)
    p2_err = abs(float(p2_sum) - float(smem_probe_reference(x8, optin)))
    p2_ms = cuda_ms(lambda: smem_probe(x8, optin))
    p2_plain_ms = cuda_ms(lambda: smem_probe_reference(x8, optin))
    p2_lib_ms = cuda_ms(lambda: torch.sum(x8[0]))
    p3 = probe_star.run(dev, log=lambda m: phase("P3", m))
    p4 = probe_star_floor.run(dev, log=lambda m: phase("P4", m))
    probe_launches = counts()
    check_launches("probes", probe_launches,
                   ("smem_probe", "star_probe", "floor_probe"),
                   tuple(k for k in kernels if k not in (
                       "smem_probe", "star_probe", "floor_probe",
                       "star_sgns_bf16")), gmm=False)
    s3, m3, sneg3 = p3.pop("inputs")
    p3_bound = star_bound(s3, m3, sneg3, p3["pairs"], 128, True, PAD_META)
    G4, V4, d4 = p4["G"], p4["V"], p4["d"]
    # slots read once, the table read once and copied once, the gathered
    # [1024, d] buffer and the value written once
    p4_bound = bound(0.0, 4.0 * (G4 * 1024 + 2 * V4 * d4 + 1024 * d4 + 1),
                     False)
    phase("probes", f"P2 {p2['largest']} B of shared memory per block "
                    f"({p2['refused'][0]} B refused: {p2['refused'][1]}), "
                    f"{p2_ms:.4f} ms a launch | P3 full {p3['ms']:.3f} ms a "
                    f"step ({p3['rows']['full']:.2f} us/group; K2b "
                    f"{p3['k2b_us']:.2f}), max_abs {p3['max_abs_err']:.3e} "
                    f"vs K2b's plain version, bound {p3_bound[0]:.4f} ms | "
                    f"P4 floors (us/group) " + ", ".join(
                        f"{k} {v[0]:.2f}" for k, v in p4["variants"].items())
          + f" | launches {probe_launches}")

    # 15 (256). P3 with the table 256 wide: its MATH section runs K2b's
    # wide star pass (whole bf16 rows) and the wide negative pass
    reset_counts()
    p3w = probe_star.run(dev, log=lambda m: phase("P3 256", m), d=256)
    p3w_launches = counts()
    check_launches("P3 256", p3w_launches, ("star_probe",),
                   tuple(k for k in kernels
                         if k not in ("star_probe", "star_sgns_bf16")),
                   gmm=False)
    s3, m3, sneg3 = p3w.pop("inputs")
    p3w_bound = star_bound(s3, m3, sneg3, p3w["pairs"], 256, True, PAD_META)
    # the star pass its MATH section launched (star_pos.cuh's
    # StarPosPass<true>), as the wrapper counted it
    p3w_routes = dict(star_probe_step.routes)
    if not p3w_routes["whole"] or sum(p3w_routes.values()) != \
            p3w_routes["whole"]:
        raise AssertionError(f"P3 256: star pass steps by route "
                             f"{p3w_routes}, expected every one whole")
    p3w_route = f"whole ({p3w_routes['whole']} steps)"
    phase("probes 256", f"P3 at d 256: full {p3w['ms']:.3f} ms a step "
                        f"({p3w['rows']['full']:.2f} us/group; K2b "
                        f"{p3w['k2b_us']:.2f}), max_abs "
                        f"{p3w['max_abs_err']:.3e} vs K2b's plain version, "
                        f"bound {p3w_bound[0]:.4f} ms, star pass route "
                        f"{p3w_route} | launches "
                        f"{p3w_launches['star_probe']} | {smi}")

    # 15b. the macro step as one replayed graph
    graph_phase(dev, smi)

    # 16. the parity harness's CLI on the card
    from come_tpu_torch.evaluation import parity

    reset_counts()
    if parity.main(["--dataset", "karate", "--iters", "3", "--device",
                    "cuda"]) != 0:
        raise AssertionError("parity: the CLI returned non-zero")
    parity_launches = counts()
    ran = ("walk_sgns", "walk_sgns_paired", "star_sgns", "fused_sgns_tied")
    check_launches("parity", parity_launches, ran,
                   tuple(k for k in kernels if k not in ran), gmm=False)
    phase("parity", f"karate, 3 iterations on cuda: PASS | launches "
                    f"{parity_launches}")

    # 17. --profile-dir: the karate CLI with shared negatives under the
    # profiler (the CLI has no flag for the negative mode, as the JAX CLI
    # has none; run() takes config fields from the parsed namespace)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        args = build_argparser().parse_args([
            "--dataset", "karate", "--device", "cuda", "--seed", str(SEED),
            "--outer-iters", "1", "--pretrain-epochs", "1",
            "--profile-dir", tmp,
        ])
        args.negative_mode, args.shared_negatives = "shared", 32
        args.pallas_tile_pairs = 64
        reset_counts()
        trainer, hist = run(args)
        torch.cuda.synchronize()
        prof_launches = counts()
        traces = list(Path(tmp).glob("*.pt.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"profile: {len(traces)} trace files")
        text = traces[0].read_text()
        if "fused_pos_kernel" not in text:
            raise AssertionError("profile: the trace names no K6 kernel")
        size = traces[0].stat().st_size
    ran = ("fused_sgns", "fused_sgns_tied")
    check_launches("profile", prof_launches, ran,
                   tuple(k for k in kernels if k not in ran))
    check_run("profile", hist, KARATE_SHARED_NMI_FLOOR)
    phase("profile", f"karate shared negatives under --profile-dir: "
                     f"{traces[0].name} {size} bytes, names fused_pos_kernel "
                     f"(K6) | NMI {hist[-1]['nmi']:.4f} | launches "
                     f"{prof_launches}")
    del trainer
    torch.cuda.empty_cache()

    # 18. the data-parallel path: torchrun runs of tools/dp_check.py
    dp_phase(main_o1_ms, V=ds.graph.num_nodes, d=128)
    dp_phase(wide_runs["main 256"]["o1_ms"], V=ds.graph.num_nodes, d=256)

    # 19. the row-sharded path: torchrun runs of tools/rs_check.py
    rs_phase(main_o1_ms)
    rs_phase(wide_runs["main 256"]["o1_ms"], d=256)

    # 20. the quality sweep's rows and t-SNE
    eval_phase(smi, reset_counts, counts, check_launches, tuple(kernels))

    # 21. the first outer iteration, G1 and the EM as a device program
    g1 = first_iter_phase(dev, smi, main_emb, ds.num_communities,
                          main256_emb)

    def entry(name, src, replaces, launches, err, ms, plain_ms, bnd,
              library_ms=None):
        return {"name": name, "route": "cuda",
                "source": f"come_tpu_torch/csrc/{src}", "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms}

    def wide_entry(name, src, replaces, launches, r):
        return entry(name, src, replaces, launches, r["err"][0], r["ms"],
                     r["plain_ms"], r["bound"])

    def pool_entry(name, replaces, n, key, src="sgns_common.cuh",
                   cases="pools"):
        r = lv[cases][key]
        return entry(name, src, replaces, n, r["err"],
                     r["us"] / 1e3, r["plain_us"] / 1e3, r["bound"],
                     r["lib_us"] / 1e3)

    bf = torch.bfloat16
    p1, p1_launches = lv["p1"], lv["p1_launches"]
    pg = p1[(2, 262144)]  # the path's bf16 rows, one macro step's worth
    print(json.dumps({"kernels": [
        entry("walk_sgns", "walk_sgns.cu",
              "come_tpu/ops/pallas_walk_sgns.py:91",
              launches["walk_sgns"] + host_launches["walk_sgns"],
              k1_err[0], k1_ms, k1_plain_ms, k1_bound),
        entry("star_sgns", "star_sgns.cu",
              "come_tpu/ops/pallas_star_sgns.py:56", launches["star_sgns"],
              k2_err[0], k2_ms, k2_plain_ms, k2_bound),
        entry("fused_sgns", "sgns_fused.cu", "come_tpu/ops/pallas_sgns.py:100",
              micro_launches["fused_sgns"], k6_err[0], k6_ms, k6_plain_ms,
              k6_bound),
        entry("fused_sgns_tied", "sgns_fused.cu",
              "come_tpu/ops/pallas_sgns.py:185",
              micro_launches["fused_sgns_tied"], k7_err[0], k7_ms,
              k7_plain_ms, k7_bound),
        entry("walk_sgns_bf16", "walk_sgns.cu",
              "come_tpu/ops/pallas_walk_sgns.py:129",
              bench_launches["walk_sgns_bf16"], k1bb_err[0], k1bb_ms,
              k1bb_plain_ms, k1bb_bound),
        entry("star_sgns_bf16", "star_sgns.cu",
              "come_tpu/ops/pallas_star_sgns.py:78",
              bench_launches["star_sgns_bf16"], k2bb_err[0], k2bb_ms,
              k2bb_plain_ms, k2bb_bound),
        entry("walk_sgns_gen_bf16", "walk_sgns.cu",
              "come_tpu/ops/pallas_walk_sgns.py:695",
              gen_launches["walk_sgns_gen_bf16"], k4b_err[0], k4b_ms,
              k4b_plain_ms, k4b_bound),
        entry("walk_sgns_paired", "walk_sgns.cu",
              "come_tpu/ops/pallas_walk_sgns.py:290",
              paired_launches["walk_sgns_paired"], k5_err[0], k5_ms,
              k5_plain_ms, k5_bound),
        entry("walk_sgns_bf16_tables", "walk_sgns.cu",
              "come_tpu/ops/pallas_walk_sgns.py:377",
              large_launches["walk_sgns_bf16_tables"], lv["k3_err"][0],
              lv["k3_ms"], lv["k3_plain_ms"], lv["k3_bound"]),
        # the pool passes (phase 4m, unigram pools over synthetic-10m);
        # launches from the main path's steps: K1's stage from phase 5,
        # K3's stage and pool write from phase 14, the write at d 256 from
        # phase 5c
        pool_entry("pool_stage", "come_tpu/ops/pallas_walk_sgns.py:216",
                   launches["stage_pool"],
                   ("stage", torch.float32, 512, 128, None, "unigram")),
        pool_entry("pool_stage_bf16_tables",
                   "come_tpu/ops/pallas_walk_sgns.py:216",
                   large_launches["stage_pool_bf16_tables"],
                   ("stage", bf, 2048, 128, None, "unigram")),
        pool_entry("pool_chains", "come_tpu/ops/pallas_walk_sgns.py:405",
                   large_launches["pool_chains"],
                   ("chains", None, 2048, 128, None, "unigram")),
        pool_entry("pool_apply_bf16_tables",
                   "come_tpu/ops/pallas_walk_sgns.py:405",
                   large_launches["apply_pool_bf16"],
                   ("apply", bf, 2048, 128, 12345, "unigram")),
        pool_entry("pool_apply_bf16_tables_d256",
                   "come_tpu/ops/pallas_walk_sgns.py:405",
                   tiers256["K3 256"]["apply_pool_bf16"],
                   ("apply", bf, 2048, 256, 12345, "unigram")),
        # K3's slot passes (phase 4m, phase 4f's walks): launches from phase
        # 14, the scatter at d 256 from phase 5c; the bf16 passes' stage
        # past d 192 (phase 4m, unigram pools): launches from phase 5c (K3
        # on bf16 tables; K1b and K2b on f32 tables in its bench run)
        pool_entry("slot_chains", "come_tpu/ops/pallas_walk_sgns.py:369",
                   large_launches["slot_chains"],
                   ("slot chains", None, 80, 128, None, "unigram"),
                   "walk_sgns.cu"),
        pool_entry("walk_scatter_bf16", "come_tpu/ops/pallas_walk_sgns.py:377",
                   large_launches["walk_scatter_bf16"],
                   ("scatter", bf, 80, 128, 12345, "unigram"),
                   "walk_sgns.cu"),
        pool_entry("walk_scatter_bf16_d256",
                   "come_tpu/ops/pallas_walk_sgns.py:377",
                   tiers256["K3 256"]["walk_scatter_bf16"],
                   ("scatter", bf, 80, 256, 12345, "unigram"),
                   "walk_sgns.cu"),
        # the f32 slot writes (phase 4m, phase 4f's walks, K1's unigram
        # pool of 512): the block-end scatter's launches from phase 5 (R 1:
        # every group), the scatter's from the bench run (R 8), at d 256
        # from phase 5b and the bench run at 256
        pool_entry("walk_scatter", "come_tpu/ops/pallas_walk_sgns.py:395",
                   bench_launches["walk_scatter"], ("unigram", 128, 0),
                   "walk_sgns.cu", "f32"),
        pool_entry("block_end_scatter",
                   "come_tpu/ops/pallas_walk_sgns.py:405",
                   launches["block_end_scatter"], ("unigram", 128, 512),
                   "walk_sgns.cu", "f32"),
        pool_entry("fold_chains", "come_tpu/ops/pallas_walk_sgns.py:405",
                   launches["fold_chains"], ("unigram", "fold", 512),
                   "walk_sgns.cu", "f32"),
        pool_entry("walk_scatter_d256",
                   "come_tpu/ops/pallas_walk_sgns.py:395",
                   tiers256["bench 256"]["walk_scatter"], ("unigram", 256, 0),
                   "walk_sgns.cu", "f32"),
        pool_entry("block_end_scatter_d256",
                   "come_tpu/ops/pallas_walk_sgns.py:405",
                   wide_launches["block_end_scatter"], ("unigram", 256, 512),
                   "walk_sgns.cu", "f32"),
        # the star writes (phase 4m, phase 4's blogcatalog group and its
        # pools of 512): the chains', fold chains' and block-end scatter's
        # launches from phase 5 (R 1: every group), the scatter's from the
        # bench run (R 8), at d 256 from phase 5b and the bench run at 256
        pool_entry("star_chains", "come_tpu/ops/pallas_star_sgns.py:186",
                   main_star_pools["star_chains"], ("blog", "chains"),
                   "owned_writes.cuh", "star"),
        pool_entry("star_fold_chains", "come_tpu/ops/pallas_star_sgns.py:197",
                   main_star_pools["fold_chains"], ("blog", "fold", 512),
                   "owned_writes.cuh", "star"),
        pool_entry("star_scatter", "come_tpu/ops/pallas_star_sgns.py:186",
                   bench_launches["star_scatter"], ("blog", 128, 0),
                   "star_sgns.cu", "star"),
        pool_entry("star_block_end_scatter",
                   "come_tpu/ops/pallas_star_sgns.py:197",
                   main_star_pools["star_block_end_scatter"],
                   ("blog", 128, 512), "star_sgns.cu", "star"),
        pool_entry("star_scatter_d256", "come_tpu/ops/pallas_star_sgns.py:186",
                   tiers256["bench 256"]["star_scatter"], ("blog", 256, 0),
                   "star_sgns.cu", "star"),
        pool_entry("star_block_end_scatter_d256",
                   "come_tpu/ops/pallas_star_sgns.py:197",
                   wide_launches["star_block_end_scatter"],
                   ("blog", 256, 512), "star_sgns.cu", "star"),
        pool_entry("pool_stage_bf16_d256",
                   "come_tpu/ops/pallas_walk_sgns.py:216",
                   tiers256["K3 256"]["stage_pool_bf16"],
                   ("wide", bf, 2048, 256, None, "unigram")),
        pool_entry("pool_stage_bf16_f32_tables_d256",
                   "come_tpu/ops/pallas_walk_sgns.py:216",
                   tiers256["bench 256"]["stage_pool_bf16"],
                   ("wide", torch.float32, 512, 256, None, "unigram")),
        entry("row_gather_probe", "row_probe.cu", "scripts/probe_dma.py:47",
              p1_launches["row_gather_probe"], pg["cs_err"], pg["g_ms"],
              pg["g_plain"], pg["g_bound"], pg["g_lib"]),
        entry("row_scatter_probe", "row_probe.cu", "scripts/probe_dma.py:47",
              p1_launches["row_scatter_probe"], 0.0, pg["s_ms"],
              pg["s_lib"], pg["s_bound"], pg["s_lib"]),
        entry("smem_probe", "smem_probe.cu", "scripts/probe_vmem.py:12",
              probe_launches["smem_probe"], p2_err, p2_ms, p2_plain_ms,
              bound(0.0, 4.0 * 128 + 4.0, False), p2_lib_ms),
        entry("star_probe", "star_probe.cu", "scripts/probe_star.py:33",
              probe_launches["star_probe"], p3["max_abs_err"], p3["ms"],
              p3["plain_ms"], p3_bound),
        entry("floor_probe", "floor_probe.cu",
              "scripts/probe_star_floor.py:207",
              probe_launches["floor_probe"], 0.0, p4["ms"], p4["plain_ms"],
              p4_bound),
        entry("gmm_factor", "gmm_factor.cu",
              "come_tpu/losses/gmm.py:52 (XLA cholesky)",
              launches["gmm_factor"], g1["factor_err"], g1["factor_ms"],
              g1["factor_plain_ms"], g1["factor_bound"],
              g1["factor_lib_ms"]),
        entry("gmm_inverse", "gmm_factor.cu",
              "come_tpu/losses/gmm.py:163 (XLA cho_solve)",
              launches["gmm_inverse"], g1["inverse_err"], g1["inverse_ms"],
              g1["inverse_plain_ms"], g1["inverse_bound"],
              g1["inverse_lib_ms"]),
        # dim 256: the f32 wide passes, G1's matrices in device
        # memory; launches from phase 5b, the rest from phases 4k and 21
        entry("walk_sgns_d256", "walk_sgns.cu",
              "come_tpu/ops/pallas_walk_sgns.py:91",
              wide_launches["walk_sgns"], blog256["K1"]["err"][0],
              blog256["K1"]["ms"], blog256["K1"]["plain_ms"], blog256["K1"]["bound"]),
        entry("walk_sgns_paired_d256", "walk_sgns.cu",
              "come_tpu/ops/pallas_walk_sgns.py:290",
              paired256_launches["walk_sgns_paired"], blog256["K5"]["err"][0],
              blog256["K5"]["ms"], blog256["K5"]["plain_ms"], blog256["K5"]["bound"]),
        entry("star_sgns_d256", "star_sgns.cu",
              "come_tpu/ops/pallas_star_sgns.py:56",
              wide_launches["star_sgns"], blog256["K2"]["err"][0],
              blog256["K2"]["ms"], blog256["K2"]["plain_ms"], blog256["K2"]["bound"]),
        entry("gmm_factor_d256", "gmm_factor.cu",
              "come_tpu/losses/gmm.py:52 (XLA cholesky)",
              wide_launches["gmm_factor"], g1["factor_err_256"],
              g1["factor_ms_256"], g1["factor_plain_ms_256"],
              g1["factor_bound_256"], g1["factor_lib_ms_256"]),
        entry("gmm_inverse_d256", "gmm_factor.cu",
              "come_tpu/losses/gmm.py:163 (XLA cho_solve)",
              wide_launches["gmm_inverse"], g1["inverse_err_256"],
              g1["inverse_ms_256"], g1["inverse_plain_ms_256"],
              g1["inverse_bound_256"], g1["inverse_lib_ms_256"]),
        # the other modes at dim 256, through their wide passes:
        # launches from phase 5c (P3's from its d-256 run in phase 15),
        # the rest from phase 4k (P3's from phase 15)
        wide_entry("walk_sgns_bf16_d256", "walk_sgns.cu",
                   "come_tpu/ops/pallas_walk_sgns.py:129",
                   tiers256["bench 256"]["walk_sgns_bf16"],
                   blog256["K1b bench"]),
        wide_entry("walk_sgns_gen_bf16_d256", "walk_sgns.cu",
                   "come_tpu/ops/pallas_walk_sgns.py:695",
                   tiers256["bench gen 256"]["walk_sgns_gen_bf16"],
                   blog256["K4 bench"]),
        wide_entry("walk_sgns_bf16_tables_d256", "walk_sgns.cu",
                   "come_tpu/ops/pallas_walk_sgns.py:377",
                   tiers256["K3 256"]["walk_sgns_bf16_tables"], lv["k3_256"]),
        wide_entry("star_sgns_bf16_d256", "star_sgns.cu",
                   "come_tpu/ops/pallas_star_sgns.py:78",
                   tiers256["bench 256"]["star_sgns_bf16"],
                   blog256["K2b bench"]),
        wide_entry("fused_sgns_d256", "sgns_fused.cu",
                   "come_tpu/ops/pallas_sgns.py:100",
                   tiers256["micro 256"]["fused_sgns"], blog256["K6"]),
        wide_entry("fused_sgns_tied_d256", "sgns_fused.cu",
                   "come_tpu/ops/pallas_sgns.py:185",
                   tiers256["micro 256"]["fused_sgns_tied"], blog256["K7"]),
        entry("star_probe_d256", "star_probe.cu", "scripts/probe_star.py:33",
              p3w_launches["star_probe"], p3w["max_abs_err"], p3w["ms"],
              p3w["plain_ms"], p3w_bound),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
