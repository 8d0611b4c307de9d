"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. Phases, in order; any failure exits nonzero
and prints no result:

1. build the seven CUDA kernels from ``distributed_active_learning_tpu_torch/
   csrc`` (one nvcc per source, started together) and print the card's name
   and power limit;
2. the leaf kernel K1 (csrc/forest_leaves.cu, a heap walk over the forest
   staged in shared memory) against both plain PyTorch versions, the
   path-matrix form and the walk over the heap operands, at full width
   (284,807 x 30 pool, 100-tree depth-8 device-fit forest, 32 bins), on the
   85,443-row test draw, on one 50-tree model shard of the 4 x 2 mesh
   (71,202 rows), at one ragged shape (13 trees, 1,700 rows) and over a
   depth sweep 1-8 on rows that hold NaN, infinities and features on node
   thresholds: bit-equal; a path matrix that is not a heap is refused;
2b. the vote kernel K3 (csrc/fused_votes.cu, a heap walk over the forest
   held in shared memory, csrc/heap_votes.cuh) against both plain versions,
   the path-matrix form and the walk over the heap operands with packed vote
   bits, at full width, at one 50-tree model shard of the 4 x 2 mesh (71,202
   rows), at the ragged shape, over phase 2's depth sweep on edge rows and at
   one streamed shape (256 trees of depth 8 over the pool, too many to stay
   resident): bit-equal, each with its launch configuration and mode;
2c. the layout variants K5 (csrc/forest_leaves_transposed.cu) and K6
   (csrc/forest_leaves_segmented.cu), heap walks on csrc/heap_tiles.cuh,
   against their plain versions at full width: K5 for both leaf payloads
   (hi + lo, exact f32), tree_outer on and off, at (bn, bt) = (512, 16) and
   (2048, 8), and each ablation stage; K6 at (2048, 8) and (1024, 8); all
   bit-equal, and K5 with the f32 payload equal to K1's leaves. Both also
   bit-equal to the walks of their own arithmetic at full width, and to
   their plain versions over phase 2's depth sweep 1-8 on edge rows, at the
   ragged 13-tree shape, and on a forest with -inf and NaN thresholds against
   rows that are -inf there (where K6, which gives such nodes no slot, must
   differ from K5); a path matrix that is not a heap is refused by both with
   no launch;
2d. K1 on a host-fit-shaped forest: 100 trees of max_depth 8 made with numpy
   in the shapes a scikit-learn fit packs into (leaves at depths 1-8,
   single-leaf trees; the card's machine has no scikit-learn), written with
   ``save_forest`` and loaded onto the card with ``load_forest``, then
   ``for_kernel(..., "pallas")`` (its trees packed into complete heaps): K1
   at the pool plus 4,099 edge rows bit-equal to ``predict_leaves_plain`` on
   the depth-first path matrix and to the walk of the heaps, and on the
   bf16-exact pool equal to the gather form; its launch is printed;
3. the round megakernel K2 (csrc/round_megakernel.cu, the same walk as K3)
   against both plain versions for uncertainty, entropy, full_entropy and
   margin at full width (5,000-row labeled mask, k = 100), then for
   uncertainty at phase 2b's other shapes: per-tile candidates and merged
   picks bit-equal; a path matrix that is not a heap is refused by K2 and K3
   before any launch;
3c. K1, K2 and K3 on quantized payloads: for int8 and bf16 storage
   (``quantize_forest`` of fits on bf16-snapped bin edges) at full width,
   the test draw, a mesh shard, depths 1, 2, 3 and 8 on edge rows and the
   streamed 256-tree shape, each kernel bit-equal to its plain version and
   its walk; printed: the rows whose votes move against f32 storage of the
   same fit, and the leaves at exactly 0.5 of the f32 forest;
3b. the ring copy K4 (csrc/ring_hop.cu): a 4-shard ring of k = 100 windows
   on the card (four shards on cuda:0), each hop and one ring step of all
   four windows (one launch) bit-equal to the plain copies and the merge
   equal to the global stable top-k; the same across two cards (peer
   stores) when two are visible, else a line saying it did not run;
4. the main path: ``run_experiment`` at the benchmark width (pool 284,807 x
   30, test draw 85,443 rows, 100 trees, depth 8, 32 bins, device fit,
   kernel "pallas", uncertainty, window 100, n_start 5,000, 3 rounds), once
   with ``fused_round`` and once without, the launch counts set to 0 just
   before each run and read just after it: the fused run must launch K2 and
   K1 once a round each, the unfused run K1 twice a round. The two runs'
   records and final labeled masks must be identical. Then a small
   checkerboard run on the card must equal the same run on the CPU (plain
   versions);
4b. the mesh path: the phase-4 configuration with ``MeshConfig(data=4,
   model=2)`` on ``devices=[cuda:0] * 8`` (284,807 rows padded to 284,808;
   100 trees as 2 x 50), fused and unfused, counted from 0 per run: fused
   K3 8, K4 3 (one a ring step) and K1 8 launches a round and no K2;
   unfused K1 16 a round
   and no K3 or K4. Records and final masks must equal phase 4's. With two
   or more visible cards the same mesh runs again spread over them (shard
   (s, m) on card (s + m) mod n), else a line says it did not run. Then a
   small checkerboard mesh run on the card must equal the same mesh on the
   CPU;
4q. the mesh, whole (it runs after phase 4m: it reuses phases 4b-4l's
   single-device runs as its references), every run on the 4 x 2 mesh on
   ``devices=[cuda:0] * 8`` at the bench width: (a) the chunk (K = 4, 6
   rounds, 4c's shape), fused and unfused, whose records and final masks
   must equal 4c's chunked runs (and a 3-round chunk, fitting 4b's window,
   must equal 4b's per-round mesh runs),
   counted from 0 (fused K3 8, K4 3 and K1 8 a round, unfused K1 16, no K2),
   one CUDA graph of a round (mode, captures, replays, launches a replay,
   capture seconds and graph pool printed), then its steady s/round beside
   4c's; (b) RoundMetrics: 4f's metrics chunk (unfused: the fused round
   computes none) equal to 4f's, ``pool_entropy`` to
   ``POOL_ENTROPY_RTOL``; (c) per round, 3 rounds: the gemm form (against
   its single-device run made here), depth 12 (4d), density (4e; only the
   watched tie may differ, and a line reports it), LAL (4i), and 8 rounds
   of the noisy oracle (4l's run of that family, RoundMetrics too),
   per-phase seconds printed; the host fit prints a
   line saying it did not run (no scikit-learn on the card's machine); (d)
   the E = 8 sweep (4j) and the 12-cell grid (4k), each experiment and cell
   equal (density's score fields to ``MASS_RTOL``), experiment- and
   cell-round seconds printed; (e) with two or more cards the chunk spread
   over them, printing the mode that ran (else a line says it did not
   run); (f) a small checkerboard chunked mesh run: card == CPU;
4r. (after phase 4p) the rest of the single-process mesh:
   (a) the neural mesh: phase 4n's CNN entropy run (the CIFAR-10 stand-in,
   50,000 images, ``SmallCNN(10)``, 200 steps, 8 MC samples, 4 rounds) on
   ``MeshConfig(data=8)`` over ``devices=[cuda:0] * 8``, per round and
   chunked at K = 2 (one CUDA graph of a round of the whole mesh): records
   and final mask equal to phase 4n's single-device run, accuracy within
   1e-5; K7 only; seconds a round, capture seconds and graph pool against
   4n's;
   (b) ring attention: the AG-News encoder (d_model 128, 4 heads, 2
   layers, 64 tokens) with ``attention_fn=ring_attention`` over an 8-shard
   ring on the card and the same parameters as with ``full_attention``:
   the logits of the 24,000 test sequences within 2e-4; one MC pass timed
   with each;
   (c) the pod at the serving headline width: phase 4o (b)'s 291,840 x 30
   slab pool (284,807 rows filled) over 8 shards of 36,480 rows; 100
   routed 64-row ingest blocks (``route_to_shard``), one
   ``grow_sharded_slab`` (a slab a shard: the room shard 0 is skewed
   into), 16 direct appends to shard 0, then rebalance epochs of <= 256
   rows under ``RebalanceHysteresis`` (enter 1.02, exit 1.005: the skew of
   a nearly full pool) and until the plan is empty, then one more epoch,
   which must be a no-op. Gates: every row bit for bit where the host map
   says (content, label, mask, codes), the fills after each epoch equal to
   ``rebalance_plan``'s arithmetic and the index map as long as the plan,
   ``fused_score_select`` over the pod (phase 2's forest, uncertainty,
   window 100; K3 8 launches, K4 7) equal to K2 over the same contents on
   one device, and its picks mapped by ``remap_indices`` to their rows
   before the last moving epoch. Ingest points/s, epoch ms and the select's
   ms against K2's are printed; the pod runs eagerly: the CUDA graphs
   captured during (c) (``runtime.loop.graph_captures``, set to 0 at its
   start) must be 0.
4s. (after phase 4r) the mesh over processes (``parallel/multihost.py``):
   this script's ranks (``--rank-job``) spawned under the port's launcher
   contract (the env trio; ``LOCAL_RANK=0``, so every rank on ``cuda:0``),
   each printing its numbers as one JSON line, each group under its own
   timeout that kills every rank. (a) the forest main path at full width:
   phase 4b's fused run on ``MeshConfig(4, 2)`` over 4 processes (one data
   row of 2 model shards each), checkpointing every round, then chunked at
   K = 2. Gates: every rank's records and final mask equal phases 4 and 4b;
   rank 0 alone writes exactly 3 checkpoints, whose payload equals a
   single-device run's (records without their wall times); each rank
   launches K3 twice a round, K4 once a ring step and K1 twice a round
   (its test-set shards); K4's windows through CUDA IPC equal the plain
   gloo hop's, bit for bit, over one round's whole ring (replayed from the
   run's first round); the chunk runs "eager". Per-round fit / round / eval
   seconds and the ring step's time (IPC and gloo) are printed. (b) the
   neural leg: phase 4n's CNN entropy run on ``MeshConfig(data=2)`` over 2
   processes for 2 rounds: records and final mask equal 4n's first two
   records and a single-process run of the same two rounds, bit for bit;
   K7 counted a rank. (c) the model axis across the processes, by the
   same 4 ranks after (a), one cell a rank: ``MeshConfig(2, 2)`` fused
   (checkpointing every round), unfused and chunked at K = 2, and
   ``MeshConfig(1, 4)`` fused. Gates: every rank's records and final mask
   equal phases 4 and 4b; rank 0 alone writes the (2, 2) run's 3
   checkpoints, equal to the single-device run's; each rank's launches a
   round step as ``multi_process_phase`` states them (fused: K3 1, K1 1 and
   K4 ``data - 1``, one a step of its column ring; unfused: K1 2); the chunks
   run "eager"; K4 through the IPC windows of the first column ring equal the
   gloo hop, bit for bit. Per-rank fit / round / eval seconds and a column
   ring's step time are printed. (d) the pod over the processes: 4r (c)'s
   pod sequence (``pod_sequence``) on ``MeshConfig(8, 1)``, 2 rows a rank,
   phase 2's forest handed over in a file: its fills and index maps after
   every epoch, its final rows and the select's values and picks equal 4r
   (c)'s single-process pod on every rank; the select launches K3 2 and K4 7
   a rank. (e) cells that cross a data row partway, by the same 4 ranks
   after (c): ``MeshConfig(6, 2)`` (3 cells a rank: a whole row and half of
   the next, or the other half and a whole row) and ``MeshConfig(3, 4)`` (3
   cells a rank, no rank holding a whole row), each fused, unfused and
   chunked at K = 2. Gates: every rank's records and final mask equal phases
   4 and 4b; each rank's launches a round step: K3 3 (one a cell), the test
   set's K1 3 (unfused K1 6), K4 ``data - 1`` (one a step of its rings,
   whose members repeat a rank); the chunks run "eager"; K4 through the IPC
   windows of each layout's first fused round's rings equals the gloo hop,
   bit for bit. Per-rank fit / round / eval seconds, launches a round step
   and a ring step by IPC and by gloo are printed. Four processes
   time-slice one card: the seconds show the launch structure, not
   scaling;
4t. (after phase 4s) the pre-flight (``analysis/``; ``preflight_phase``):
   (a) the headline fused
   round step (phase 4's width, K1 on the test draw, K2 on the pool) counted
   on the card, its FLOPs, bytes and kernel rows equal to the count on the
   meta device and K1's and K2's rows equal to their declared costs at
   PERF.md section 6's shapes, timed as a graph replay and attributed (no
   share of a peak above 1.0); the chunk (K = 4, 6 rounds, RoundMetrics on,
   unfused) through ``run_experiment`` with ``roofline``: its one
   ``roofline`` event carries no error and no share above 1.0; (b) the
   forest chunk's round step, phase 4n's CNN chunk step, phase 4o (b)'s
   serving capacity (291,840 rows, depth 8), and the programs ``--audit``
   prices for the other runs (4j's sweep of 8 seeds, 4k's 12-cell grid, a
   noisy-oracle chunk, 4q's chunk on ``MeshConfig(4, 2)`` over ``[cuda:0] *
   8``, 4i's LAL round, 4n's CNN neural sweep at 2 lanes) priced on the
   meta device against ``max_memory_allocated`` over an eager step and the
   private pool of its ``GraphedChunk`` capture: a prediction below a
   measurement fails, each ratio is printed; (c) ``run.py --audit`` with a
   64 MiB budget table refuses with ``hbm-over-budget`` and launches no
   kernel, the K = 4 chunk with a budget between its eager peak and its
   resident inputs + captured pool refuses too (the graph's footprint), so
   does ``--sweep-seeds 8`` with a budget between the one-experiment
   chunk's graph and the sweep's (naming ``sweep/uncertainty/seeds8``), and
   with the card's budget the run prints the records of the same run
   without ``--audit``;
   (d) the Python mirrors of K1's, K2's and K3's launch configuration equal
   the C answer at the headline pool, the mesh shard, 256 streamed trees and
   the serving endpoint ``[64, 30]`` (depths 4 and 8), each payload;
   (e) the program auditor (``analysis/auditor.py``) on the card: (b)'s
   forest chunk and mesh chunk traced on the card audit clean, their traced
   kernel launches equal to their capture's tally; every program (c)'s
   ``--audit`` runs examined, traced on the card, audits clean; ``run.py
   --audit`` refuses a ``.item()`` in the chunk body, an f64 op and a
   pool-sized gather on the mesh by rule id, launching nothing; the lint
   (``analysis/lint.py``) finds nothing in the port;
4c. the chunked driver at the benchmark width: ``rounds_per_launch = 4``,
   ``max_rounds = 6`` (a stop inside the second chunk), fused and unfused,
   ``pipeline_depth`` 1 and 2. Records and the final mask must equal the
   per-round run of the same configuration; each run must capture one CUDA
   graph and replay it twice (kernel launches: one eager warm-up round plus 4
   rounds per replay). The chunk body runs once eagerly under
   ``torch.cuda.set_sync_debug_mode("error")``: it must not sync with the
   host (also the bodies of phases 4d, 4e and 4f). Then seconds per round of the
   per-round driver and of the chunked driver at depth 1 and 2 over 12 rounds
   (rounds 5-12: the first chunk holds the capture);
4d. the deep gather path: phase 4's configuration at ``max_depth=12`` with
   ``kernel="gather"`` (the device fit emits the gather form; no kernel of
   the port runs on it, so every launch count stays 0), unfused, 3 rounds,
   per round and chunked (K = 4): records and final mask equal, one graph
   capture and one replay; small checkerboard runs at depth 12, per round
   and chunked, equal on the card and on the CPU;
4e. density: phase 4's configuration with ``strategy="density"``, unfused,
   3 rounds, per round and chunked (K = 4), K1 counted from 0 (twice a
   round): records and final mask equal; small checkerboard runs equal on
   the card and on the CPU (picks, records, mask), and the similarity mass
   of the card within ``similarity.MASS_RTOL`` of the largest |mass| of the
   CPU's, on the small pool and the bench pool;
4f. telemetry and checkpoints: phase 4's configuration, unfused, chunked
   (K = 4, depth 2), its fit window pinned to the 12-round label cap. A
   12-round run with RoundMetrics, a ``MetricsWriter`` to a temporary
   JSONL, the flight recorder, an ``OpsServer`` on an ephemeral port
   (``/metrics`` must hold ``dal_launches_total`` and
   ``dal_recompiles_after_warmup_total 0``, ``/healthz`` answer 200) and a
   checkpoint every 4 rounds: its records and final mask equal the same run
   without metrics; every metric is finite, ``picked_hist`` sums to the
   window, ``labeled_frac`` times the pool is ``n_labeled``; its metrics
   equal the per-round driver's; the JSONL holds one ``round`` event a round
   and one ``launch`` event a chunk; K1 launches twice a round. The same
   run with ``stream_round_events``: the same records, mask and launches,
   one ``round_stream`` event a round equal to the touchdown's record, every
   event of a chunk written before its touchdown's first ``round`` event and
   the chunk's first at least one measured chunked round-time before it
   (``stream_leads``). A run
   stopped at 4 rounds and resumed to 8, chunked and per round from the
   chunk's checkpoint, equals the uninterrupted run (records, and the mask of
   its round-8 checkpoint). Printed: seconds per round with and without
   metrics (rounds 5-12), K1 launches per round, the metrics epilogue's and
   the pool entropy's device time at the pool (graph-replayed), the
   dispatch snapshot's device time, ``checkpoint.save``'s host time and
   ``device_memory_gauges``;
4g. quantized storage: phase 4's configuration at ``quantize`` int8
   (fused, unfused, chunked fused, the 4 x 2 mesh fused on the one card) and
   bf16 (fused, unfused, chunked unfused, the mesh fused), launches counted
   as phase 4's: all runs of a payload equal in records and final mask;
   small checkerboard runs (fused, unfused, chunked, mesh) card == CPU;
4h. multiclass: the pool's labels as four classes by quartile of x0 +
   0.3 x1, unfused, uncertainty (the top-2 margin) with RoundMetrics and
   entropy, per round and chunked (K = 4), and uncertainty on the 4 x 2 mesh:
   chunked == per round (records, masks, metrics), mesh == single device;
   K1 launches 2 x 4 a round (8 x 2 x 4 on the mesh); the fit's time at
   C = 4 beside phase 4's C = 2;
4i. LAL: phase 4's configuration with ``strategy="lal"``, its regressor
   200 trees of depth 10 (numpy trees in a scikit-learn fit's shapes,
   thresholds inside each feature's range) through a forest file with the
   meta ``load_or_train_lal_regressor`` expects, per round and chunked:
   chunked == per round, K1 twice a round (the regressor is the gather
   form); small checkerboard LAL runs card == CPU; printed: the regressor's
   time over the pool's features and the chunk graph's private pool;
4j. the sweep: phase 4's configuration (unfused, RoundMetrics on) as
   ``runtime.sweep.run_sweep`` of 8 seeds, K = 4, 8 rounds, one CUDA graph a
   chunk: K1 launches 2 x (1 + 8) times over the run (once on the pool and
   once on the test set a round step, for all 8 forests: 2 x K a replay),
   one capture and two replays; each seed's records, RoundMetrics and final
   mask equal its serial chunked ``run_experiment``; printed: experiments x
   rounds per second of the sweep and of the 8 serial runs (capture
   included), ``sweep_speedup``, the steady seconds an experiment-round
   against a serial chunked round, the device time of one round step's 8
   fits (graph-replayed) and its share of the experiment-round, the
   capture's seconds and the graph's
   private pool; a small checkerboard sweep (windows 15, 10, 15) card ==
   CPU;
4k. the grid: ``run_grid`` of uncertainty, margin and density x 4 seeds at
   the same width (K = 4, 8 rounds), every cell equal to its serial chunked
   run (records, RoundMetrics, final mask), ``recompiles_after_warmup`` 0,
   K1 2 x K a replay; then a grid of two datasets of unequal widths (the
   pool and a 142,403-row draw: the fill watermark), K1 4 x K a replay, each
   cell's records and mask equal to its serial run's and its RoundMetrics
   too, but for ``labeled_frac`` and ``pool_entropy``, which the watermark
   divides by its count (JAX's spelling) and which agree to one f32 ulp;
   printed: ``grid_cells_rounds_per_second`` beside the serial cells';
4l. scenarios: phase 4's configuration, unfused, entropy, RoundMetrics on,
   8 rounds, for each family (``noisy_oracle`` flip 0.1 abstain 0.25,
   ``cost_budget`` 250 with spread 4, ``rare_event`` class 1, ``drift``
   ``mean_shift`` and ``rotation`` at 0.2, and none) a per-round run and a
   chunked run (K = 4, depth 2): records, every RoundMetrics field
   (``rare_recall``, ``cost_spent``) and final mask equal, one capture and
   two replays, K1 twice a round (16 per round, 18 chunked); the chunk
   bodies of the noisy oracle, the cost budget and both drifts eagerly
   under ``set_sync_debug_mode("error")``; the scenario grid (none,
   noisy_oracle, cost_budget, rare_event, drift x entropy x 2 seeds, one
   stream at pipeline depth 1, so a chunk's wall is its own), each
   seed-``--seed`` cell equal to its serial chunked run, K1
   4 a round step (pool, steady test sets, the 2 drift cells' own),
   ``recompiles_after_warmup`` 0; at the CPU tests' size every family
   chunked and the scenario grid card == CPU, and the scenario draws
   (flips, costs, the drift direction through ``erfinv_f32``, a normal draw
   of the pool's size, ``drift_apply`` of both kinds) and the knapsack over
   the pool (at budget 250, and at 60, where the budget runs out) card ==
   CPU; printed: seconds a chunked round per family beside
   phase 4c's, the knapsack's device ms at k = 100 over the pool (graph
   replayed), K1 launches a round;
4m. data from files: a credit-card CSV in the Kaggle file's layout written
   from ``--seed`` (284,807 rows, ``Time``, ``V1..V28`` as float64 reprs,
   ``Amount``, 492 quoted positives), parsed by the native loader (built
   from ``cpp/loader.cpp`` with the host C++ compiler) and by the numpy
   route (both timed; the tokens they round differently counted, each at
   most one ulp apart), then ``get_dataset(credit_card_fraud)``: a
   standardized 199,364 x 30 pool and 85,443 x 30 test set; K1 and K2 at
   those shapes against their plain versions (bit-equal) and timed; phase
   4's configuration on that pool (the reference's 100 trees, depth 8)
   fused, unfused and chunked (K = 4, fused), records and final masks
   equal, launches counted under ``files``, ``files_unfused`` and
   ``files_chunked``; ``striatum_like`` at its scale-run configuration
   (10,000 x 50, 20 trees of depth 8, window 10, fused, seed 3), ``blobs4``
   (four classes, unfused: K1 2 x C a round) and ``checkerboard2x2_file``
   on the committed fixtures, each card == CPU; ``generate_lal_dataset`` at
   the JAX package's defaults (60 experiments x 8 candidates) timed on the
   card, and card == CPU on its rows at 4 experiments;
4n. the neural path (``runtime/neural_loop.py``, ``neural_phase``): K7
   (csrc/threefry.cu) bit-equal to ``prng`` at the main path's shapes (a
   dropout site over a 4,096-row chunk, the minibatch draw over the pool,
   BatchBALD's configuration and class draws) and timed beside the plain
   versions; config 4, ``SmallCNN`` (dropout 0.25) on the CIFAR-10 stand-in
   (``get_dataset(cifar10, n_samples=50000)`` drawn on the card, equal to
   the CPU's draw at 600 rows), entropy and density, window 100, n_start
   100, 200 steps of batch 64, 8 MC samples, 4 rounds per round (phases
   timed) and 4 chunked at K = 2 (one capture, two replays): records and
   final masks equal; config 5, the encoder (vocab 4,096, max_len 64,
   d_model 128, 4 heads, 2 layers, d_ff 256, dropout 0.1) on the AG-News
   stand-in (120,000 x 64) with BatchBALD (window 50, max_configs 4,096,
   candidate pool 512, 256 MC configurations), the same two drivers; the
   last per-round fit of each split into the draw, forward + backward and
   adam (CUDA events), every K7 call of the per-round runs timed again at
   its shape beside the plain ``prng`` draw (the seconds a round of both
   forms), an MC pass timed against its FLOPs, BatchBALD's 50 picks timed;
   one chunk (K = 2) of the CNN entropy run with ``stream_round_events``:
   the flag-off records, its first ``round_stream`` event at least 0.5 s
   before the chunk's touchdown;
   a 4-seed sweep of the CNN at 10,000 rows (2 rounds, K = 2, 50 steps a
   fit: the gate compares bits, which the step count leaves as they are),
   every lane equal to its serial run; a checkpoint written at round 2 by
   the chunked driver and resumed to 4 (the same learner), equal to the
   uninterrupted run; a small MLP and CNN card == CPU
   (picks equal, probabilities within ``NEURAL_TRAIN_RTOL``); every deep
   strategy's chunk body once under ``set_sync_debug_mode("error")``; the
   phase's seconds split by the gate or measurement they pay for. No path
   of the phase launches K1-K6; each launches K7;
4o. the streaming service (``serving/``, ``serving_phase``): (a) the JAX
   bench's serve leg at its sizes (``bench.run_serve``: 8,192 x 30 cold
   start, 100 trees of depth 4, K1, uncertainty, window 20, slabs of 1,024,
   2,000 queries of 64, an ingest block of 64 every 4th query, the second
   half shifted by 2.5), its re-fits, growths, fill and labels those of the
   JAX bench at the same sizes (staleness re-fits only: the entropy trigger
   does not fire there), no recapture, at most 2 chunk graphs live; the
   same leg at the JAX bench's smoke sizes, its counts those of the JAX
   bench's committed baseline (``benches/baselines/cpu_smoke_serve.json``,
   ``entropy_shift`` among its re-fit reasons); one query is one K1 launch
   and a re-fit 2 a round (the graph's count); K1 at [64, 30] and at the
   slab bit-equal to ``predict_leaves_plain`` and timed with its bound; a
   checkpoint written at the end resumes with bit-equal scores; the JAX
   serving test's small service card == CPU (scores, summary, mask,
   records); (b) the same service cold-started on the headline pool
   (284,807 x 30, depth 8, 400 queries) with the same gates and K1 at its
   slab; (c) ``bench_serve_multi`` (4 gemm tenants of 8,192 rows through
   the frontend: no recapture, no growth-compile event after warmup, a
   growth precompiled, no score fallback), grouped scores == single scores
   and the batched re-fit's masks and keys == independent services' (3
   tenants), and a pallas tenant pair's named fallback and K1 launches;
4p. the serve fleet (``serving/fleet.py``, ``fleet_phase``): (a)
   ``bench_serve_fleet`` at the JAX bench's TPU sizes (8 gemm tenants of
   256 x 30, 24 trees of depth 6, score width 128, 2,000 queries a leg on 1
   then 4 spawned worker processes on the card, a concurrency-1 client
   through the router): every query served in each leg, each worker's
   scraped ``dal_recompiles_after_warmup_total`` 0, no shared-signature
   fallback, nothing unroutable or rerouted, the router's ``/metrics``
   carrying every worker and its ``/healthz`` 200; printed: qps by workers,
   the ratio, p50/p99, warmup by leg, each worker's peak reserved MiB;
   (b) a 4-worker fleet's scores (3 blocks of 128 a tenant) bit-equal to
   each worker's manager built in process on the card, its score groups
   the ring's placement; (c) a 2-worker fleet of 4 pallas tenants: each
   worker launches K1 once a query a tenant (as the in-process manager on
   the card counts), its fallback reasons those of the same managers on
   the CPU, its scores the in-process ones; (d) one worker of a 2-worker
   fleet terminated: the router's ``/healthz`` stays 200, the dead worker's
   tenants get a 404 from the failover walk within the health timeout, the
   other's are served;
5. per-kernel median times at the phase-2/2b/2c/3/3b shapes beside the plain
   versions' and the bound (one call between CUDA events; for K1, K2, K3,
   K5 and K6 also the device time of the call captured in a CUDA graph and
   replayed back to back): K1 at the pool, the test draw and one mesh
   shard; K2 at the pool and K3 at a mesh shard and the pool, each also at
   other thread-group counts a block than its own choice, and both at the
   streamed shape; a K4 ring step of four k = 100 windows beside four
   ``Tensor.copy_`` pairs into preallocated buffers; K5 and K6 at (bn, bt) =
   (2048, 8) on the pool; ``merge_tile_topk`` at
   the fused round's shape; ``forest_eval.votes`` of a depth-12 gather form
   and ``similarity_mass`` at the pool beside their byte bounds, and the
   host milliseconds of packing phase 2d's forest into heaps; K1, K2 and K3
   at the int8 and bf16 payloads at the same shapes (bounds count the payload
   at its width), K1 on a 2,000-tree depth-8 regressor over the pool's
   [284,807, 5] LAL features, and K1 over a sweep's stacked forest (8 fits of
   100 trees as one of 800, bit-equal to the 8 single calls) beside the 8
   single calls and its bound; then one fused
   and one unfused main-path round and one mesh fused round under
   torch.profiler (device time by kernel, device busy share);
6. the port's bench at the benchmark width: ``--mode score``, ``--mode
   round``, ``--mode variants`` (K1, two K5 tilings, one K6) and ``--mode
   lal`` (``--lal-model``: a 2,000-tree depth-8 regressor file; K1 twice a
   query; the host-fit leg reported skipped without scikit-learn), ``--mode
   sweep`` and ``--mode grid`` (``--no-baseline``: the batched arm alone,
   since phases 4j and 4k hold it against its serial runs and time both;
   the grid's ``recompiles_after_warmup`` must be 0) and ``--mode neural``
   (one eager round of each stretch config at a 200-row pool, 25 steps:
   phase 4n times both at full width), each JSON line printed on a line of
   its own; the round mode's line must carry the pod legs' keys and
   ``recompiles_after_warmup`` 0, and its ``roofline`` section every phase
   (fit, round, score_select, chunk, fused_round) with no share above 1.0;
   then ``--mode all --deadline 1`` (its line names ``modes_skipped``) and
   ``--mode score --profile-dir`` (``device_seconds_by_phase`` under
   ``bench/score``). K5's and K6's launch counts are
   read over the variants run, counted from 0.

The last three lines are a JSON object of per-kernel numbers (``launches``
is the count of the kernel's main path, single-device fused for K1 and K2,
mesh fused for K3 and K4, the bench's variants mode for K5 and K6;
``launches_by_path`` every path's, phases 4d, 4e and 4f included;
``launch_config`` for K1, K2 and K3; K1's ``metrics_path_launches`` from
phase 4f; ``telemetry`` phase 4f's numbers; ``new_paths`` phase 5's new
times and the fit / round / eval split of each round of phases 4d and 4e;
``by_payload`` for K1, K2 and K3 the int8 and bf16 times, bounds, launch
configurations and largest differences; ``multiclass`` and ``lal`` phases
4h and 4i's numbers; K1's ``sweep_launches`` and ``grid_launches`` and its
stacked call under ``by_shape``; ``sweep`` and ``grid`` phases 4j and 4k's
numbers; K1's ``scenario_launches`` and ``scenarios`` phase 4l's numbers;
``files`` phase 4m's numbers; K1's ``serving_by_shape`` and ``serving``
phase 4o's numbers (the paths ``serve``, ``serve_headline`` and
``serve_multi`` in every ``launches_by_path``); ``fleet`` phase 4p's
numbers (its pallas workers' launches under the path ``serve_fleet_pallas``);
``mesh_pod`` phase 4r's numbers (its paths ``neural_mesh``,
``neural_mesh_chunked`` and ``pod_select`` in every ``launches_by_path``);
``preflight`` phase 4t's numbers (its passing ``--audit`` run's launches
under the path ``preflight_audit``);
``multi_process`` phase 4s's numbers (its paths ``procs4_fused``,
``procs4_chunked``, ``procs4_model_fused``, ``procs4_model_unfused``,
``procs4_row_fused``, ``procs4_model_chunked``, (e)'s
``procs4_cross62_*`` and ``procs4_cross34_*``, ``procs4_pod_select`` and
``procs2_neural``, summed over the ranks, in every ``launches_by_path``;
K4's ``ipc_step_ms``, ``column_ring_ipc_step_ms`` and (e)'s ring steps);
``neural`` phase 4n's numbers (K7 ``threefry``
is the seventh entry, its ``launches`` the neural main path's: the CNN
entropy run per round; every kernel's ``launches_by_path`` has the neural
paths);
``bench_batched`` phase 6's sweep and grid lines, the grid's with its
scenario leg, whose ``scenario_recompiles_after_warmup`` must be 0),
the card's name
and power limit, and ``{"ok": true, "device": {...}}``.

It exits nonzero without a CUDA device, and when the port's package is not
beside it.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import gc
import hashlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): device memory and
# float32 operations outside the tensor cores (the compares of a tree walk).
# The bounds below are stated against these.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

N_POOL, N_TEST, N_FEAT = 284_807, 85_443, 30
TREES, DEPTH, BINS = 100, 8, 32
DEEP = 12  # the deep device fit's depth (the gather form), phase 4d
WINDOW, N_START, ROUNDS = 100, 5_000, 3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int = 5, inner: int = 1) -> float:
    """Median device time of ``fn`` over ``reps`` timings of ``inner``
    back-to-back calls each (CUDA events), per call, after one warm-up
    call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn, reps: int = 9, inner: int = 20) -> float:
    """Median device time of ``fn`` captured once in a CUDA graph and
    replayed ``inner`` times back to back: the kernel's own time, without
    the host work of its wrapper between launches (which ``cuda_ms`` of one
    call includes when the kernel is shorter than that work)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return cuda_ms(g.replay, reps=reps, inner=inner)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float):
    """The least time (ms) the card could take, and what bounds it: the
    larger of the bytes at the memory rate and the operations at the f32
    rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def labels(x: np.ndarray) -> np.ndarray:
    return (x[:, 0] + 0.3 * x[:, 1] > 0).astype(np.int32)


def edge_rows(gf, rng, n: int) -> torch.Tensor:
    """Normal rows of N_FEAT features in which every eighth row is all NaN,
    +inf or -inf (or one feature of it is), and others hold a node's
    threshold exactly or the bf16 tie above its rounding."""
    x = rng.normal(size=(n, N_FEAT)).astype(np.float32)
    feat, thr = gf.feat_ids.cpu().numpy(), gf.thresholds.float().cpu().numpy()
    for r in range(n):
        kind = r % 8
        if kind < 3:
            x[r, rng.integers(N_FEAT) if r % 16 >= 8 else slice(None)] = (np.nan, np.inf, -np.inf)[kind]
        elif kind < 5:
            t, i = rng.integers(feat.shape[0]), rng.integers(feat.shape[1])
            v = thr[t, i:i + 1]
            if kind == 4:
                v = (((v.view(np.uint32) + 0x7FFF) & 0xFFFF0000) | 0x8000).view(np.float32)
            x[r, feat[t, i]] = v[0]
    return torch.from_numpy(x)


def profile_round(loop, cfg, bundle, dev, label: str, devices=None) -> None:
    """One main-path round under torch.profiler: device time by kernel and
    the device's busy share of the round's wall time."""
    from torch.profiler import ProfilerActivity, profile

    one = dataclasses.replace(cfg, max_rounds=1)
    loop.run_experiment(one, bundle=bundle, device=dev, devices=devices)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.run_experiment(one, bundle=bundle, device=dev, devices=devices)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        # Device-side events only (kernels, copies): host ops and the
        # al_phase/* spans (which the profiler also mirrors onto the device
        # timeline as annotations) carry the time of the kernels under them.
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(evt, "is_user_annotation", False) or evt.key.startswith("al_phase/"):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, evt.key, evt.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"# profile {label} round (run_experiment incl. set-up): wall {wall:.4f}s, "
          f"device busy {busy:.4f}s ({100 * busy / wall:.1f}%)")
    for us, key, count in rows[:12]:
        print(f"#   {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


# The neural path's sizes (phase 4n): the registry's CIFAR-10 and AG-News
# stand-ins at those datasets' train sizes.
NEURAL_CIFAR, NEURAL_AGNEWS, NEURAL_SMALL = 50_000, 120_000, 10_000
NEURAL_ROUNDS, NEURAL_K = 4, 2
NEURAL_SMALL_STEPS = 50  # 4n-c's fits: its gates compare bits at any step count
# Forward FLOPs per example, from the shapes: SmallCNN on 32 x 32 x 3 (four
# 3x3 convs, Dense 4096 -> 128 -> 10) and the encoder on 64 tokens (d 128,
# 2 layers, 4 heads, d_ff 256).
CNN_FLOP = 2 * (32 * 32 * 32 * 27 + 16 * 16 * 32 * 288 + 16 * 16 * 64 * 288 + 8 * 8 * 64 * 576
                + 4096 * 128 + 128 * 10)
ENC_FLOP = 2 * 2 * (64 * 128 * 384 + 2 * 64 * 64 * 128 + 64 * 128 * 128 + 2 * 64 * 128 * 256)
# 32-bit operations K7 spends on one element: the threefry2x32 hash (20
# rounds of add, rotate and xor, 5 key injections) and the float conversion;
# the Gumbel adds two float32 logs (Cephes: 10 FMAs and ~15 other operations
# each) and the compare.
K7_OPS_UNIFORM, K7_OPS_GUMBEL = 123, 123 + 60


def neural_phase(seed: int, dev, kind: str, smi: str, counts, zero_counts) -> dict:
    """Phase 4n: the neural path at CIFAR-10 and AG-News width (see the
    module docstring). Returns its numbers; fails on any gate."""
    from distributed_active_learning_tpu_torch import prng
    from distributed_active_learning_tpu_torch.config import DataConfig
    from distributed_active_learning_tpu_torch.data.datasets import get_dataset
    from distributed_active_learning_tpu_torch.models.neural import (
        MLP, NEURAL_TRAIN_RTOL, NeuralLearner, SmallCNN,
    )
    from distributed_active_learning_tpu_torch.models.transformer import TransformerClassifier
    from distributed_active_learning_tpu_torch.ops import threefry
    from distributed_active_learning_tpu_torch.runtime import neural_loop as nl
    from distributed_active_learning_tpu_torch.runtime.debugger import Debugger
    from distributed_active_learning_tpu_torch.strategies import deep

    t_phase = time.perf_counter()
    out = {"launches": {}, "k7": {}, "split_seconds": {}}
    t_mark = [t_phase]

    def mark(label):
        """Charge the seconds since the previous mark to ``label``."""
        now = time.perf_counter()
        out["split_seconds"][label] = now - t_mark[0]
        t_mark[0] = now

    # -- K7 against its plain version, at the main path's shapes --------------
    ks = prng.split(prng.key(seed + 7, dev), 4)
    shape = (4096, 16, 16, 32)  # the CNN's first dropout site over one predict chunk
    got, want = threefry.uniform(ks[0], shape), prng.uniform(ks[0], shape, dev)
    torch.cuda.synchronize()
    k7_err = float((got - want).abs().max())
    if not torch.equal(got, want):
        fail(f"K7 uniform != prng.uniform at {shape}: {(got != want).sum().item()} differ")
    labeled = torch.zeros(NEURAL_CIFAR, dtype=torch.bool, device=dev)
    labeled[torch.randperm(NEURAL_CIFAR, device=dev)[:500]] = True
    logits = torch.where(labeled, 0.0, float("-inf"))
    cat_cases = {
        "minibatch": (ks[1], logits, 64),  # the training draw: 64 rows over the pool
        "batchbald_configs": (ks[2], torch.randn(4096, device=dev), 256),
        "batchbald_classes": (ks[3], torch.randn(256, 4, device=dev), 256),
    }
    for name, (k, lg, rows) in cat_cases.items():
        g = threefry.categorical(k, lg, rows)
        w = prng.categorical(k, lg, (rows,) if lg.dim() == 1 else lg.shape[:-1])
        torch.cuda.synchronize()
        k7_err = max(k7_err, float((g - w).abs().max()))
        if not torch.equal(g, w):
            fail(f"K7 categorical != prng.categorical ({name}): {(g != w).sum().item()} differ")
    n_u = int(np.prod(shape))
    k7 = {}
    k7["uniform"] = dict(
        ms=cuda_ms(lambda: threefry.uniform(ks[0], shape)),
        plain_ms=cuda_ms(lambda: prng.uniform(ks[0], shape, dev), reps=3),
        bound=bound(4 * n_u, K7_OPS_UNIFORM * n_u), elements=n_u)
    n_c = 64 * NEURAL_CIFAR
    k7["categorical"] = dict(
        ms=cuda_ms(lambda: threefry.categorical(ks[1], logits, 64)),
        plain_ms=cuda_ms(lambda: prng.categorical(ks[1], logits, (64,)), reps=3),
        bound=bound(4 * NEURAL_CIFAR + 4 * 64, K7_OPS_GUMBEL * n_c), elements=n_c)
    for name, r in k7.items():
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        print(f"# time K7 {name} ({r['elements']} draws): {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
              f"({kind}, {smi})")
    out["k7"] = k7
    out["k7_max_abs_err"] = k7_err
    print(f"# K7 (csrc/threefry.cu) == prng bit for bit: uniform {shape}, categorical "
          f"{list(cat_cases)}")
    mark("k7_check_and_times")

    def records(res):
        return [(r.round, r.n_labeled, r.n_unlabeled, r.accuracy) for r in res.records]

    class DrawLog:
        """Counts K7's calls by shape while it is entered (eager runs only)."""

        def __enter__(self):
            self.calls = collections.Counter()
            self._u, self._c = threefry._launch_uniform, threefry._launch_categorical

            def u(key, shp):
                self.calls[("uniform", tuple(shp), 0)] += 1
                return self._u(key, shp)

            def c(key, logits, rows):
                self.calls[("categorical", tuple(logits.shape), rows)] += 1
                return self._c(key, logits, rows)

            threefry._launch_uniform, threefry._launch_categorical = u, c
            return self

        def __exit__(self, *exc):
            threefry._launch_uniform, threefry._launch_categorical = self._u, self._c

    def run(path, cfg, learner, b, chunked, **kw):
        """One run; the per-round driver's also records its K7 calls and
        its last fit's split (CUDA events around each part of each step)."""
        zero_counts()
        threefry.launches = 0
        dbg = Debugger(enabled=False, phase_detail=not chunked)
        log = contextlib.nullcontext() if chunked else DrawLog()
        if not chunked:
            learner.phase_events = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
                                    for _ in range(learner.train_steps)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with log:
                res = nl.run_neural_experiment(
                    dataclasses.replace(cfg, rounds_per_launch=NEURAL_K if chunked else 1),
                    learner, b.train_x, b.train_y, b.test_x, b.test_y, debugger=dbg, **kw)
            torch.cuda.synchronize()
        finally:
            ev, learner.phase_events = learner.phase_events, None
        wall = time.perf_counter() - t0
        split = None
        if not chunked:
            split = dict(draw=0.0, forward_backward=0.0, adam=0.0)
            for e in ev:
                split["draw"] += e[0].elapsed_time(e[1]) / 1e3
                split["forward_backward"] += e[1].elapsed_time(e[2]) / 1e3
                split["adam"] += e[2].elapsed_time(e[3]) / 1e3
        c = counts()
        if any(c.values()):
            fail(f"neural path {path} launched forest kernels: {c}")
        out["launches"][path] = dict(c, threefry=threefry.launches)
        if threefry.launches == 0:
            fail(f"neural path {path} never launched K7")
        return res, wall, (split, None if chunked else log.calls)

    def pair(tag, cfg, learner, b):
        """Per round then chunked at K = 2: records and masks equal."""
        per, w_per, (split, calls) = run(f"neural_{tag}", cfg, learner, b, chunked=False)
        chk, w_chk, _ = run(f"neural_{tag}_chunked", cfg, learner, b, chunked=True)
        if records(per) != records(chk) or not torch.equal(per.final_labeled_mask,
                                                           chk.final_labeled_mask):
            fail(f"neural {tag}: chunked != per-round:\n{records(per)}\n{records(chk)}")
        g = chk.graph_stats
        if g["captures"] != 1 or g["replays"] != NEURAL_ROUNDS // NEURAL_K:
            fail(f"neural {tag}: graph stats {g}")
        phases = [dict(train=r.train_time, acquire=r.score_time, eval=r.eval_time)
                  for r in per.records]
        row = dict(per_round_wall=w_per, chunked_wall=w_chk, phases=phases,
                   fit_split=split, draw_calls=calls,
                   chunked_seconds_per_round=statistics.median(
                       r.total_time for r in chk.records[NEURAL_K:]),
                   capture_seconds=g["capture_seconds"], graph_pool_bytes=g["pool_bytes"],
                   launches_per_replay=g["launches_per_replay"],
                   final_accuracy=per.final_accuracy, records=records(per))
        NEURAL_MASKS[tag] = per.final_labeled_mask
        print(f"# neural {tag}: chunked == per-round ({NEURAL_ROUNDS} rounds, K = {NEURAL_K}); "
              f"per-round wall {w_per:.2f}s, chunked wall {w_chk:.2f}s "
              f"({row['chunked_seconds_per_round']:.4f} s/round replayed), capture "
              f"{g['capture_seconds']:.2f}s, graph pool {g['pool_bytes'] / 2**20:.0f} MiB; "
              f"final accuracy {per.final_accuracy:.4f} ({kind}, {smi})")
        for i, p in enumerate(phases):
            print(f"#   round {i + 1}: train {p['train']:.4f}s acquire {p['acquire']:.4f}s "
                  f"eval {p['eval']:.4f}s")
        sp = row["fit_split"]
        print(f"#   round {NEURAL_ROUNDS}'s fit ({learner.train_steps} steps): draw "
              f"{sp['draw']:.4f}s, forward+backward {sp['forward_backward']:.4f}s, adam "
              f"{sp['adam']:.4f}s ({kind}, {smi})")
        mark(tag)
        return row

    def draw_seconds(calls, rounds):
        """Device seconds a round of a run's K7 calls, timed again at their
        shapes, and of the plain ``prng`` draws at the same shapes."""
        k = prng.key(seed + 9, dev)
        k7_s = plain_s = 0.0
        for (what, shp, rows), n in calls.items():
            if what == "uniform":
                f7 = lambda shp=shp: threefry.uniform(k, shp)  # noqa: E731
                fp = lambda shp=shp: prng.uniform(k, shp, dev)  # noqa: E731
            else:
                lg = torch.zeros(shp, device=dev)
                f7 = lambda lg=lg, rows=rows: threefry.categorical(k, lg, rows)  # noqa: E731
                fp = lambda lg=lg, rows=rows: prng.categorical(  # noqa: E731
                    k, lg, (rows,) if lg.dim() == 1 else lg.shape[:-1])
            k7_s += n * cuda_ms(f7, reps=3) / 1e3
            plain_s += n * cuda_ms(fp, reps=2) / 1e3
        dr = dict(calls_per_round=sum(calls.values()) / rounds, k7_seconds=k7_s / rounds,
                  plain_seconds=plain_s / rounds,
                  shapes={f"{w} {list(shp)} x{r}": n for (w, shp, r), n in calls.items()})
        print(f"#   K7's draws a round: {dr['calls_per_round']:.0f} calls, {dr['k7_seconds']:.4f}s; "
              f"the plain prng draws at the same shapes {dr['plain_seconds']:.4f}s ({kind}, {smi})")
        return dr

    def mc_pass(learner, b):
        """An MC pass over the pool on fresh weights (its time does not
        depend on their values): the samples and their device seconds."""
        x = torch.as_tensor(b.train_x).to(dev)
        net = learner.init(prng.key(seed + 2))
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        probs = learner.predict_proba_samples(net, x, prng.key(3, dev))
        end.record()
        end.synchronize()
        return probs, start.elapsed_time(end) / 1e3

    # -- 4n-a: config 4, SmallCNN on the CIFAR-10 stand-in ------------------
    t0 = time.perf_counter()
    bc = get_dataset(DataConfig(name="cifar10", n_samples=NEURAL_CIFAR, seed=seed), device=dev)
    gen_c = time.perf_counter() - t0
    if bc.train_x.shape != (NEURAL_CIFAR, 32, 32, 3) or bc.test_x.shape[1:] != (32, 32, 3):
        fail(f"cifar10 stand-in shapes {bc.train_x.shape} {bc.test_x.shape}")
    small = get_dataset(DataConfig(name="cifar10", n_samples=600, seed=seed))
    small_dev = get_dataset(DataConfig(name="cifar10", n_samples=600, seed=seed), device=dev)
    if not all(np.array_equal(a, b_) for a, b_ in zip(small[:4], small_dev[:4])):
        fail("the cifar10 stand-in drawn on the card != the CPU's")
    cnn = NeuralLearner(SmallCNN(n_classes=10, dropout_rate=0.25), (32, 32, 3), train_steps=200,
                        batch_size=64, mc_samples=8, device=dev)
    cfg_c = nl.NeuralExperimentConfig(window_size=100, n_start=100, max_rounds=NEURAL_ROUNDS,
                                      seed=seed)
    out["cnn"] = {"data_seconds": gen_c}
    for strat in ("entropy", "density"):
        out["cnn"][strat] = pair(f"cnn_{strat}", dataclasses.replace(cfg_c, strategy=strat),
                                 cnn, bc)
    # round_stream as each round finishes: one chunk of the CNN entropy run
    # with the flag on writes its first event at least 0.5 s before its
    # touchdown, with the records of the flag-off runs.
    stream_dir = tempfile.mkdtemp(prefix="chip_smoke_4n_stream_")
    sw = timed_writer(os.path.join(stream_dir, "stream.jsonl"))
    streamed = nl.run_neural_experiment(
        dataclasses.replace(cfg_c, strategy="entropy", max_rounds=NEURAL_K,
                            rounds_per_launch=NEURAL_K, stream_round_events=True),
        cnn, bc.train_x, bc.train_y, bc.test_x, bc.test_y, metrics=sw)
    sw.close()
    shutil.rmtree(stream_dir)
    if records(streamed) != out["cnn"]["entropy"]["records"][:NEURAL_K]:
        fail(f"neural round_stream run: records {records(streamed)} != the flag-off runs'")
    out["cnn"]["round_stream_lead_seconds"] = stream_leads("4n", sw, streamed, NEURAL_K, 0.5)
    print(f"# neural cnn round_stream (K = {NEURAL_K}): the first event "
          f"{out['cnn']['round_stream_lead_seconds'][0]:.3f}s before the chunk's touchdown, "
          f"records == the flag-off runs' ({kind}, {smi})")
    mark("cnn_round_stream")
    # The density runs draw at the entropy runs' shapes: time those once.
    out["cnn"]["draws"] = draw_seconds(out["cnn"]["entropy"].pop("draw_calls"), NEURAL_ROUNDS)
    del out["cnn"]["density"]["draw_calls"]
    mark("cnn_draws_plain_vs_k7")
    out["launches"]["neural"] = dict(out["launches"]["neural_cnn_entropy"])
    probs, mc_s = mc_pass(cnn, bc)
    del probs
    flop = NEURAL_CIFAR * 8 * CNN_FLOP
    out["cnn"].update(mc_pass_seconds=mc_s, mc_pass_tflop=flop / 1e12,
                      mc_tflops=flop / mc_s / 1e12)
    print(f"# neural cnn: data on the card {gen_c:.2f}s; MC pass {mc_s:.4f}s = "
          f"{flop / 1e12:.2f} TFLOP at {flop / mc_s / 1e12:.2f} TFLOP/s of the 67 TFLOP/s f32 "
          f"peak ({kind}, {smi})")
    mark("cnn_mc_pass")

    # -- 4n-b: config 5, the encoder + BatchBALD on the AG-News stand-in ----
    t0 = time.perf_counter()
    ba = get_dataset(DataConfig(name="agnews", n_samples=NEURAL_AGNEWS, seed=seed), device=dev)
    gen_a = time.perf_counter() - t0
    if ba.train_x.shape != (NEURAL_AGNEWS, 64) or ba.test_x.shape[1:] != (64,):
        fail(f"agnews stand-in shapes {ba.train_x.shape} {ba.test_x.shape}")
    enc = NeuralLearner(TransformerClassifier(vocab_size=4096, max_len=64, d_model=128, n_heads=4,
                                              n_layers=2, d_ff=256, n_classes=4,
                                              dropout_rate=0.1),
                        (64,), train_steps=200, batch_size=64, mc_samples=8, device=dev)
    cfg_a = nl.NeuralExperimentConfig(strategy="batchbald", window_size=50, n_start=100,
                                      max_rounds=NEURAL_ROUNDS, batchbald_max_configs=4096,
                                      batchbald_candidate_pool=512, batchbald_mc_samples=256,
                                      seed=seed)
    out["encoder"] = {"data_seconds": gen_a, "batchbald": pair("encoder_batchbald", cfg_a, enc,
                                                              ba)}
    out["encoder"]["draws"] = draw_seconds(out["encoder"]["batchbald"].pop("draw_calls"),
                                           NEURAL_ROUNDS)
    mark("encoder_draws_plain_vs_k7")
    probs, mc_s = mc_pass(enc, ba)
    flop = NEURAL_AGNEWS * 8 * ENC_FLOP
    unlabeled = torch.arange(NEURAL_AGNEWS, device=dev) >= 500
    sel_ms = cuda_ms(lambda: deep.batchbald_select(probs, unlabeled, 50, 4096, 512, 256,
                                                   key=prng.key(4, dev)), reps=1)
    out["encoder"].update(mc_pass_seconds=mc_s, mc_pass_tflop=flop / 1e12,
                          mc_tflops=flop / mc_s / 1e12, batchbald_select_ms=sel_ms)
    print(f"# neural encoder: data on the card {gen_a:.2f}s; MC pass {mc_s:.4f}s = "
          f"{flop / 1e12:.2f} TFLOP at {flop / mc_s / 1e12:.2f} TFLOP/s; BatchBALD select (50 "
          f"picks, exact to 4^6 configs, then 256 sampled) {sel_ms:.1f} ms ({kind}, {smi})")
    del probs, unlabeled, bc, ba
    mark("encoder_mc_pass_and_select")

    # -- 4n-c: a seed sweep, a checkpoint resume, card == CPU ---------------
    bs = get_dataset(DataConfig(name="cifar10", n_samples=NEURAL_SMALL, seed=seed), device=dev)
    cnn = NeuralLearner(SmallCNN(n_classes=10, dropout_rate=0.25), (32, 32, 3),
                        train_steps=NEURAL_SMALL_STEPS, batch_size=64, mc_samples=8, device=dev)
    cfg_s = dataclasses.replace(cfg_c, strategy="entropy", max_rounds=2,
                                rounds_per_launch=NEURAL_K)
    seeds = [seed + i for i in range(4)]
    zero_counts()
    threefry.launches = 0
    t0 = time.perf_counter()
    lanes = nl.run_neural_sweep(cfg_s, cnn, bs.train_x, bs.train_y, bs.test_x, bs.test_y, seeds)
    torch.cuda.synchronize()
    sweep_wall = time.perf_counter() - t0
    out["launches"]["neural_sweep"] = dict(counts(), threefry=threefry.launches)
    if any(counts().values()) or threefry.launches == 0:
        fail(f"neural sweep launches: {out['launches']['neural_sweep']}")
    for s, lane in zip(seeds, lanes):
        serial = nl.run_neural_experiment(dataclasses.replace(cfg_s, seed=s, rounds_per_launch=1),
                                          cnn, bs.train_x, bs.train_y, bs.test_x, bs.test_y)
        if records(lane) != records(serial) or not torch.equal(lane.final_labeled_mask,
                                                               serial.final_labeled_mask):
            fail(f"neural sweep lane seed {s} != its serial run")
    print(f"# neural sweep: {len(seeds)} seeds x 2 rounds (K = {NEURAL_K}, {NEURAL_SMALL_STEPS} "
          f"steps a fit) on {NEURAL_SMALL} rows, every lane == its serial run; {sweep_wall:.2f}s "
          f"wall, graph "
          f"{lanes[0].graph_stats['pool_bytes'] / 2**20:.0f} MiB")
    mark("sweep_and_serial_lanes")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_4n_")
    cfg_k = dataclasses.replace(cfg_s, max_rounds=4)
    full = nl.run_neural_experiment(cfg_k, cnn, bs.train_x, bs.train_y, bs.test_x, bs.test_y)
    half = dataclasses.replace(cfg_k, max_rounds=2, checkpoint_dir=ckpt, checkpoint_every=2)
    nl.run_neural_experiment(half, cnn, bs.train_x, bs.train_y, bs.test_x, bs.test_y)
    resumed = nl.run_neural_experiment(half, cnn, bs.train_x, bs.train_y, bs.test_x, bs.test_y)
    shutil.rmtree(ckpt)
    if records(resumed) != records(full) or not torch.equal(resumed.final_labeled_mask,
                                                            full.final_labeled_mask):
        fail(f"neural resume at round 2 != uninterrupted:\n{records(resumed)}\n{records(full)}")
    print("# neural checkpoint: written at round 2 (chunked), resumed to 4 == uninterrupted")
    mark("checkpoint_resume")
    del bs

    rs = np.random.RandomState(seed)
    small_cases = {
        "mlp": (MLP(hidden=(16,)), (4,), rs.randn(200, 4).astype(np.float32)),
        "cnn": (SmallCNN(n_classes=2, dropout_rate=0.1), (8, 8, 3),
                rs.randn(200, 8, 8, 3).astype(np.float32)),
    }
    card_cpu = {}
    for name, (module, in_shape, xs) in small_cases.items():
        flat = xs.reshape(len(xs), -1)
        ys = (flat[:, 0] + 0.5 * flat[:, 1] > 0).astype(np.int32)
        probs = {}
        runs_ = {}
        for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
            lr = NeuralLearner(module, in_shape, train_steps=10, mc_samples=2, device=d)
            st = lr.init(prng.key(seed + 2))
            msk = torch.zeros(200, dtype=torch.bool, device=d)
            msk[:20] = True
            fitted = lr.fit_on_mask(st, torch.as_tensor(xs).to(d), torch.as_tensor(ys).to(d), msk,
                                    prng.key(seed + 3, d))
            probs[side] = lr.predict_proba(fitted, torch.as_tensor(xs).to(d)).cpu()
            runs_[side] = nl.run_neural_experiment(
                nl.NeuralExperimentConfig(strategy="entropy", window_size=5, n_start=10,
                                          max_rounds=3, seed=seed), lr, xs, ys, xs[:60], ys[:60])
        err = float(((probs["card"] - probs["cpu"]).abs() / probs["cpu"].abs()).max())
        if err > NEURAL_TRAIN_RTOL:
            fail(f"neural {name} probabilities card vs CPU: {err} > {NEURAL_TRAIN_RTOL}")
        same = torch.equal(runs_["card"].final_labeled_mask.cpu(), runs_["cpu"].final_labeled_mask)
        if not same or [r.n_labeled for r in runs_["card"].records] != [
                r.n_labeled for r in runs_["cpu"].records]:
            fail(f"neural {name}: the card's picks != the CPU's")
        card_cpu[name] = err
    out["card_vs_cpu_rel_err"] = card_cpu
    print(f"# neural small runs card == CPU (picks equal; probabilities within "
          f"{NEURAL_TRAIN_RTOL}: {card_cpu})")

    mark("card_vs_cpu")
    # Every strategy's chunk body once, eagerly, under sync-error mode: nothing
    # reads back to the host, so the graph capture holds.
    xs = small_cases["mlp"][2]
    ys = (xs[:, 0] + 0.5 * xs[:, 1] > 0).astype(np.int32)
    lr = NeuralLearner(MLP(hidden=(16,)), (4,), train_steps=4, mc_samples=2, device=dev)
    pool_x = torch.as_tensor(xs).to(dev)
    oracle = torch.as_tensor(ys).to(dev)
    init = lr.init(prng.key(1))
    for strat in ("entropy", "bald", "batchbald", "coreset", "badge", "density", "random"):
        body = nl.make_neural_chunk_fn(lr, strat, 5, 2, 200, batchbald_params=(8, 50, 16))
        carry = nl.NeuralCarry(labeled_mask=(torch.arange(200, device=dev) < 10),
                               key=prng.key(2, dev), round=torch.zeros((), dtype=torch.int32,
                                                                       device=dev), net=init)
        args_ = (pool_x, carry, oracle, init, pool_x[:60], oracle[:60],
                 torch.as_tensor(99, dtype=torch.int32).to(dev))
        body(*args_)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, extras, _ = body(*args_)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if int(extras.n_active) != 2:
            fail(f"the neural {strat} chunk body did not run two active rounds")
    print("# neural chunk bodies, eager, set_sync_debug_mode('error'): no host sync for every "
          "deep strategy")
    mark("chunk_bodies_sync_free")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"# phase 4n: {out['seconds']:.1f}s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in out["split_seconds"].items()) + ")")
    return out


def timed_writer(path: str):
    """A ``MetricsWriter`` that also keeps ``(kind, fields, perf_counter)``
    of every event it writes."""
    from distributed_active_learning_tpu_torch.runtime import telemetry

    class TimedWriter(telemetry.MetricsWriter):
        def __init__(self, p):
            super().__init__(p)
            self.log = []

        def event(self, kind, **fields):
            self.log.append((kind, fields, time.perf_counter()))
            super().event(kind, **fields)

    return TimedWriter(path)


def stream_leads(label: str, writer, res, k: int, min_lead: float) -> list:
    """The ``round_stream`` gate of a chunked run written through
    :func:`timed_writer`: one event an active round in round order, equal
    to the touchdown's records; every event of a chunk written before the
    chunk's first ``round`` event (its touchdown), the chunk's first event
    at least ``min_lead`` seconds before it. Returns each chunk's lead."""
    stream = [(f["round"], f["n_labeled"], f["accuracy"], t) for kd, f, t in writer.log
              if kd == "round_stream"]
    t_round = {f["round"]: t for kd, f, t in writer.log if kd == "round"}
    want = [(r.round, r.n_labeled, r.accuracy) for r in res.records]
    if [e[:3] for e in stream] != want:
        fail(f"{label}: round_stream events {[e[:3] for e in stream]} != the records {want}")
    t_stream = {e[0]: e[3] for e in stream}
    first, last = want[0][0], want[-1][0]
    leads = []
    for c0 in range(first, last + 1, k):
        members = range(c0, min(c0 + k - 1, last) + 1)
        if max(t_stream[r] for r in members) > t_round[c0]:
            fail(f"{label}: a round_stream event of the chunk from round {c0} was written after "
                 "its touchdown")
        leads.append(t_round[c0] - t_stream[c0])
        if leads[-1] < min_lead:
            fail(f"{label}: the chunk from round {c0} wrote its first round_stream event "
                 f"{leads[-1]:.4f}s before its touchdown, want >= {min_lead:.4f}s")
    return leads


def fleet_phase(seed: int, dev, kind: str, smi: str) -> dict:
    """Phase 4p: the serve fleet (see the module docstring). Returns its
    numbers and the launches its workers counted; fails on any gate."""
    import types
    import urllib.error

    from distributed_active_learning_tpu_torch import bench
    from distributed_active_learning_tpu_torch.ops import trees_pallas
    from distributed_active_learning_tpu_torch.serving import fleet as fleet_lib

    t_phase = time.perf_counter()
    out = {"launches": {}}
    seconds = {}

    # -- (a) bench --mode serve-fleet at the JAX bench's TPU sizes -------------
    t0 = time.perf_counter()
    a = bench.bench_serve_fleet(types.SimpleNamespace(
        features=N_FEAT, serve_pool=8192, serve_queries=2000, kernel="gemm", fleet_workers=4,
        fleet_linger=0.0, ops_port=None, metrics_out=None), dev)
    seconds["a"] = time.perf_counter() - t0
    legs = a["serve_fleet_by_workers"]
    bad = []
    if a["serve_fleet_worker_counts"] != [1, 4] or a["serve_fleet_queries"] != 2000:
        bad.append("legs or queries")
    for n, leg in legs.items():
        r = leg["router"]
        if leg["served"] != 2000:
            bad.append(f"{leg['served']} served at {n} workers")
        if len(leg["worker_recompile_metric"]) != int(n) or any(
                v != 0 for v in leg["worker_recompile_metric"].values()):
            bad.append(f"scraped recompiles at {n} workers: {leg['worker_recompile_metric']}")
        if r is None or r["unroutable"] != 0 or r["rerouted"] != 0:
            bad.append(f"router at {n} workers: {r}")
    if a["serve_fleet_recompiles_after_warmup"] != 0 or a["serve_fleet_shared_sig_fallbacks"]:
        bad.append("recompiles or shared-signature fallbacks")
    if not (a["serve_fleet_router_metrics_aggregated"] and a["serve_fleet_router_healthy"]):
        bad.append("router /metrics or /healthz")
    if bad:
        fail(f"4p (a) serve-fleet gates: {bad}: {a}")
    out["serve_fleet"] = a
    print(f"# phase 4p (a) serve-fleet (8 tenants, {N_FEAT} features, 256-row pools, 24 trees of "
          f"depth 6, gemm, width 128; 2,000 queries a leg, concurrency 1): qps by workers "
          f"{a['serve_fleet_qps_by_workers']}, ratio {a['fleet_qps_scaling_ratio']}, p50 "
          f"{a['serve_fleet_p50_ms']} ms, p99 {a['serve_fleet_p99_ms']} ms (4 workers), warmup s "
          f"{a['serve_fleet_warmup_seconds_by_workers']}, groups {a['serve_fleet_groups']}; "
          f"scraped recompiles 0, fallbacks 0, unroutable 0, rerouted 0 ({kind}, {smi})")
    for n, leg in legs.items():
        print(f"#   {n} worker(s): client p50 {leg['p50_ms']} ms; each worker's own p50/p99 ms, "
              f"peak reserved MiB, spawn-to-ready s (context, build s): " + ", ".join(
                  f"{wid} {w['p50_ms']}/{w['p99_ms']}, {w['peak_reserved_mib']}, "
                  f"{w['ready_seconds']} ({w['boot_seconds']['cuda_context']}, "
                  f"{w['boot_seconds']['build_manager']})"
                  for wid, w in leg["workers"].items()))

    def specs_of(n, kernel, features=N_FEAT, pool=256, trees=24, depth=6, width=128):
        return [fleet_lib.TenantSpec(f"u{i}", features=features, pool_rows=pool, shift=0.4 * i,
                                     seed=10 + i, n_trees=trees, max_depth=depth, kernel=kernel,
                                     slab_rows=pool, score_width=width) for i in range(n)]

    def queries_for(spec, n=3):
        r = np.random.default_rng(seed + 700 + int(spec.tenant_id[1:]))
        return [(r.normal(size=(spec.score_width, spec.features)) + spec.shift).astype(np.float32)
                for _ in range(n)]

    def in_process(fleet, device):
        """Each worker's manager built here as the worker builds it, on
        ``device``: ``{worker: manager}``."""
        return {wid: fleet_lib.build_manager(fleet.specs_for(wid), device=device)
                for wid in fleet.worker_ids}

    # (b)-(d) boot together: a worker's boot is its own interpreter's work
    # (torch, a CUDA context, its fits and captures), so the three fleets'
    # boots overlap; each is then checked, and stopped, in turn.
    t0 = time.perf_counter()
    fleets = {"b": fleet_lib.Fleet(specs_of(8, "gemm"), n_workers=4, device=str(dev)),
              "c": fleet_lib.Fleet(specs_of(4, "pallas"), n_workers=2, device=str(dev)),
              "d": fleet_lib.Fleet(specs_of(4, "gemm", features=4, pool=64, trees=6, depth=3,
                                            width=16), n_workers=2, device=str(dev))}
    finals = {}
    try:
        with concurrent.futures.ThreadPoolExecutor(len(fleets)) as ex:
            for fut in [ex.submit(f.start) for f in fleets.values()]:
                fut.result()
        seconds["boot (b)-(d)"] = time.perf_counter() - t0

        # -- (b) 4 workers == the in-process managers on the card --------------
        t0 = time.perf_counter()
        fleet = fleets["b"]
        got = {s.tenant_id: [fleet.score(s.tenant_id, q) for q in queries_for(s)]
               for s in fleet.specs}
        finals["b"] = final = fleet.stop()
        for wid, mgr in in_process(fleet, dev).items():
            placed = [s.tenant_id for s in fleet.specs_for(wid)]
            if final["workers"][wid]["score_groups"] != [placed]:
                fail(f"4p (b): {wid}'s score groups {final['workers'][wid]['score_groups']} != "
                     f"the ring's placement {placed}")
            for s in fleet.specs_for(wid):
                for q, g in zip(queries_for(s), got[s.tenant_id]):
                    if not np.array_equal(mgr.score_many({s.tenant_id: q})[s.tenant_id], g):
                        fail(f"4p (b): {s.tenant_id}'s fleet scores != the in-process manager's")
            mgr.close()
        seconds["b"] = time.perf_counter() - t0
        print(f"# phase 4p (b) 4 workers: every tenant's fleet scores (3 blocks of 128) bit-equal "
              f"to the in-process managers on the card; score groups == the ring's placement "
              f"{fleet.assignment}")

        # -- (c) 2 workers of 4 pallas tenants: K1 in every worker -------------
        t0 = time.perf_counter()
        fleet = fleets["c"]
        got = {s.tenant_id: [fleet.score(s.tenant_id, q) for q in queries_for(s)]
               for s in fleet.specs}
        finals["c"] = final = fleet.stop()
        k1_by_worker = {}
        for device in (dev, "cpu"):
            for wid, mgr in in_process(fleet, device).items():
                f, mine = final["workers"][wid], fleet.specs_for(wid)
                k1_0 = trees_pallas.launches
                for s in mine:
                    for q, g in zip(queries_for(s), got[s.tenant_id]):
                        sc = mgr.score_many({s.tenant_id: q})[s.tenant_id]
                        if device == dev and not np.array_equal(sc, g):
                            fail(f"4p (c): {s.tenant_id}'s fleet scores != the in-process "
                                 "manager's")
                if device == dev:
                    want_k1 = trees_pallas.launches - k1_0
                    k1_by_worker[wid] = f["kernel_launches"]["forest_leaves"]
                    if not (k1_by_worker[wid] == want_k1 == 3 * len(mine) > 0):
                        fail(f"4p (c): {wid} launched K1 {k1_by_worker[wid]} times, the "
                             f"in-process manager {want_k1}, want one a query a tenant "
                             f"({3 * len(mine)})")
                elif f["score_fallback_reasons"] != dict(mgr.score_fallback_reasons) or set(
                        f["score_fallback_reasons"]) != {"kernel"}:
                    fail(f"4p (c): {wid}'s fallback reasons {f['score_fallback_reasons']} != the "
                         f"CPU run's {dict(mgr.score_fallback_reasons)}")
                mgr.close()
        out["launches"]["serve_fleet_pallas"] = {
            name: sum(f["kernel_launches"][name] for f in final["workers"].values())
            for name in next(iter(final["workers"].values()))["kernel_launches"]}
        out["pallas_fleet"] = dict(k1_by_worker=k1_by_worker, fallback_reasons={
            wid: f["score_fallback_reasons"] for wid, f in final["workers"].items()})
        seconds["c"] = time.perf_counter() - t0
        print(f"# phase 4p (c) 2 workers of 4 pallas tenants: K1 launches by worker "
              f"{k1_by_worker} (one a query a tenant, as in process), fallback reasons "
              f"{out['pallas_fleet']['fallback_reasons']} == the CPU run's, scores == in process")

        # -- (d) one worker of two terminated: the failover walk answers -------
        t0 = time.perf_counter()
        fleet = fleets["d"]
        for s in fleet.specs:
            fleet.score(s.tenant_id, queries_for(s, 1)[0])
        dead = fleet.assignment[fleet.specs[0].tenant_id]
        fleet._procs[dead].terminate()
        fleet._procs[dead].join(timeout=30)
        answers = {}
        for s in fleet.specs:
            t1 = time.perf_counter()
            try:
                fleet.score(s.tenant_id, queries_for(s, 1)[0])
                answers[s.tenant_id] = 200
            except urllib.error.HTTPError as e:
                answers[s.tenant_id] = e.code
            wait = time.perf_counter() - t1
            if wait > fleet_lib._HEALTH_TIMEOUT:
                fail(f"4p (d): {s.tenant_id} took {wait:.2f}s after the kill")
        with urllib.request.urlopen(f"http://127.0.0.1:{fleet.router_port}/healthz",
                                    timeout=10) as r:
            health = (r.status, json.loads(r.read()))
        finals["d"] = final = fleet.stop()
    finally:
        for k, f in fleets.items():
            if k not in finals:
                f.stop()
    want = {s.tenant_id: 404 if fleet.assignment[s.tenant_id] == dead else 200
            for s in fleet.specs}
    if answers != want or health[0] != 200 or health[1]["workers"][dead]:
        fail(f"4p (d): answers {answers} (want {want}), /healthz {health}")
    out["failover"] = dict(dead=dead, answers=answers, healthz=health[1],
                           router=final["router"])
    seconds["d"] = time.perf_counter() - t0
    print(f"# phase 4p (d) {dead} of 2 terminated: answers {answers} (its tenants 404 from the "
          f"failover walk, each within {fleet_lib._HEALTH_TIMEOUT:.0f}s), router /healthz "
          f"{health[0]} {health[1]['workers']}")
    out["seconds"] = time.perf_counter() - t_phase
    out["split_seconds"] = seconds
    print(f"# phase 4p: {out['seconds']:.1f}s ({', '.join(f'({k}) {v:.1f}' for k, v in seconds.items())})")
    return out


# Phase 4r's sizes: the serving headline pool (phase 4o (b): 291,840 rows of
# 30 features, 284,807 of them filled) over 8 shards, 64-row ingest blocks.
POD_SHARDS, POD_SLAB, POD_BLOCK, POD_INGEST_BLOCKS, POD_EPOCH_ROWS = 8, 1024, 64, 100, 256
POD_CAPACITY = 291_840
# 4r (b): ring attention against full attention, the JAX test's bound.
RING_VS_FULL_ATOL = 2e-4
# 4r (a): the mesh run's accuracy against the single-device run's, the JAX
# package's bound (tests/test_neural_runtime.py).
MESH_ACC_ATOL = 1e-5
# The single-device runs of phase 4n that 4r (a) is held against: final
# labeled masks by path.
NEURAL_MASKS: dict = {}


def pod_sequence(mesh, dev, pool_np, seed: int, gf, tag: str, counts, zero_counts) -> dict:
    """Phase 4r (c)'s pod on ``mesh`` (8 shards of one process, or this
    rank's 2 of a mesh over 4 processes, phase 4s (d)): the 291,840 x 30
    slab pool from ``pool_np`` and draws from ``seed``, 100 routed 64-row
    ingest blocks, one growth, 16 direct appends to shard 0, rebalance
    epochs of <= 256 rows under ``RebalanceHysteresis`` and until the plan
    is empty, one more epoch (a no-op), then the fused select over the pod
    (``gf``'s trees, uncertainty, window 100; launches counted from 0 and
    gated: K3 one a held shard, K4 one a ring step). Every rank makes the
    same calls. Returns the pod, the host map, the epochs' times and the
    ``trace`` that the runs on either mesh must share: the fills after
    each epoch, each epoch's index maps, the final leaves' digests and the
    select's values and picks."""
    from distributed_active_learning_tpu_torch.ops import round_fused, trees_train
    from distributed_active_learning_tpu_torch.ops.trees_pallas import PallasForest, attach_mesh
    from distributed_active_learning_tpu_torch.parallel import mesh as mesh_lib
    from distributed_active_learning_tpu_torch.serving import slab

    rng = np.random.default_rng(seed + 17)
    pool = torch.from_numpy(pool_np).to(dev)
    edges = trees_train.make_bins(pool, BINS).edges
    del pool
    y_np = labels(pool_np)
    mask_np = np.zeros(N_POOL, dtype=bool)
    mask_np[rng.choice(N_POOL, size=N_START, replace=False)] = True
    skew_blocks = POD_SLAB // POD_BLOCK  # shard 0 filled to the top of its grown block
    n_new = (POD_INGEST_BLOCKS + skew_blocks) * POD_BLOCK
    new_x = rng.normal(size=(n_new, N_FEAT)).astype(np.float32)
    all_x = np.concatenate([pool_np, new_x])
    all_y = np.concatenate([y_np, labels(new_x)])
    all_mask = np.concatenate([mask_np, np.zeros(n_new, dtype=bool)])
    base = slab.init_slab_pool(pool_np, y_np, mask_np, edges, POD_SLAB)
    base = slab.grow_slab(base, n_slabs=POD_CAPACITY // POD_SLAB - base.n_slabs)
    pod = slab.shard_slab_pool(base, mesh)
    del base
    cap = pod.capacity
    arrival = np.full(cap, -1, dtype=np.int64)
    arrival[:N_POOL] = np.arange(N_POOL)
    fills0 = pod.n_filled.cpu().clone().numpy()
    ingest = slab.make_sharded_ingest_fn(mesh)
    nxt = N_POOL

    def append(shard=None):
        nonlocal pod, nxt
        fills = pod.n_filled.cpu().clone().numpy()
        s = slab.route_to_shard(fills) if shard is None else shard
        rows = cap // POD_SHARDS
        bx = torch.from_numpy(all_x[nxt:nxt + POD_BLOCK]).to(dev)
        by = torch.from_numpy(all_y[nxt:nxt + POD_BLOCK]).to(dev)
        pod, _ = ingest(pod, edges, bx, by, POD_BLOCK, s)
        g0 = s * rows + int(fills[s])
        arrival[g0:g0 + POD_BLOCK] = np.arange(nxt, nxt + POD_BLOCK)
        nxt += POD_BLOCK

    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(POD_INGEST_BLOCKS):
        append()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t1
    # One growth: every shard's block gains a slab, so global indices
    # renumber; the host map is re-anchored shard by shard.
    old_rows = cap // POD_SHARDS
    pod = slab.grow_sharded_slab(pod, mesh)
    cap = pod.capacity
    rows = cap // POD_SHARDS
    grown = np.full(cap, -1, dtype=np.int64)
    for s in range(POD_SHARDS):
        grown[s * rows:s * rows + old_rows] = arrival[s * old_rows:(s + 1) * old_rows]
    arrival = grown
    for _ in range(skew_blocks):  # skew shard 0 with direct appends
        append(0)
    fills_skewed = pod.n_filled.cpu().clone().numpy()
    hyst = slab.RebalanceHysteresis(enter_ratio=1.02, exit_ratio=1.005, min_interval=1)
    rebalance = slab.make_rebalance_fn(mesh, POD_EPOCH_ROWS)
    epoch_ms, epochs, last_map = [], 0, None
    trace = {"fills": [], "maps": []}

    def epoch():
        nonlocal pod, arrival, last_map
        before = pod.n_filled.cpu().clone()
        plan = slab.rebalance_plan(before, POD_EPOCH_ROWS)
        want = (before - plan.sum(1) + plan.sum(0)).to(torch.int32)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pod, msrc, mdst = rebalance(pod)
        torch.cuda.synchronize()
        epoch_ms.append((time.perf_counter() - t2) * 1e3)
        after = pod.n_filled.cpu().clone()
        if not torch.equal(after, want):
            fail(f"{tag} rebalance: fills {after.tolist()} != the plan's arithmetic "
                 f"{want.tolist()}")
        trace["fills"].append(after.tolist())
        trace["maps"].append([sha(msrc), sha(mdst)])
        src, dst = msrc.cpu().numpy().reshape(-1), mdst.cpu().numpy().reshape(-1)
        ok = src >= 0
        if not np.array_equal(ok, dst >= 0) or int(ok.sum()) != int(plan.sum()):
            fail(f"{tag} rebalance: the map holds {int(ok.sum())} moves, the plan "
                 f"{int(plan.sum())}")
        if ok.any():
            prev = arrival.copy()
            moved = arrival[src[ok]]
            if (moved < 0).any():
                fail(f"{tag} rebalance shipped an unfilled row")
            arrival[src[ok]] = -1
            arrival[dst[ok]] = moved
            last_map = (prev, msrc, mdst)
        return bool(ok.any())

    while hyst.update(pod.n_filled.cpu().clone()) and epochs < 32:
        epoch()
        epochs += 1
    fired = hyst.fired
    while slab.rebalance_plan(pod.n_filled.cpu().clone(), POD_EPOCH_ROWS).any() and epochs < 64:
        epoch()
        epochs += 1
    snap = [mesh_lib.gather(getattr(pod, f)).clone() for f in ("x", "labeled_mask", "codes")]
    if epoch():
        fail(f"{tag}: an epoch of a balanced pod moved rows")
    if not all(torch.equal(s_, mesh_lib.gather(getattr(pod, f)))
               for s_, f in zip(snap, ("x", "labeled_mask", "codes"))):
        fail(f"{tag}: an epoch of a balanced pod changed the pool")
    del snap
    fills_final = pod.n_filled.cpu().clone().numpy()
    trace["leaves"] = [sha(mesh_lib.gather(getattr(pod, f)))
                       for f in ("x", "oracle_y", "labeled_mask", "codes")]
    mine = pod.labeled_mask.local_ids
    sel = pod.labeled_mask.with_blocks(
        (~pod.labeled_mask.block(s) & (torch.arange(rows, device=dev) < int(fills_final[s])),)
        for s in mine)
    pod_forest = attach_mesh(PallasForest(gf=gf), mesh)
    zero_counts()
    pv, pi = round_fused.fused_score_select(pod_forest, pod.x, sel, "uncertainty", WINDOW)
    torch.cuda.synchronize()
    c_sel = {k: counts()[k] for k in ("forest_leaves", "round_megakernel", "fused_votes",
                                       "ring_hop")}
    ring_steps = len(mesh.rings[0]) - 1
    if c_sel != {"forest_leaves": 0, "round_megakernel": 0, "fused_votes": len(mine),
                 "ring_hop": ring_steps}:
        fail(f"{tag} pod select launches {c_sel}: want K3 {len(mine)}, K4 {ring_steps}")
    trace["vals"] = pv.cpu().view(torch.int32).tolist()
    trace["picks"] = pi.cpu().tolist()
    return dict(pod=pod, capacity=cap, shard_rows=rows, arrival=arrival, all_x=all_x,
                all_y=all_y, all_mask=all_mask, edges=edges, fills_start=fills0.tolist(),
                fills_skewed=fills_skewed.tolist(), epochs=epochs, hysteresis_fired=fired,
                epoch_ms=epoch_ms, ingest_points_per_second=POD_INGEST_BLOCKS * POD_BLOCK / ingest_s,
                last_map=last_map, sel=sel, forest=pod_forest, vals=pv, picks=pi,
                select_launches=c_sel, trace=trace)


def mesh_pod_phase(seed: int, dev, kind: str, smi: str, counts, zero_counts, neural_numbers,
                   gf, pool_np) -> dict:
    """Phase 4r: the neural path under a data mesh, ring attention for the
    encoder, and the pod slab pool (see the module docstring). Returns its
    numbers; fails on any gate."""
    import functools

    from distributed_active_learning_tpu_torch import prng
    from distributed_active_learning_tpu_torch.config import DataConfig, MeshConfig
    from distributed_active_learning_tpu_torch.data.datasets import get_dataset
    from distributed_active_learning_tpu_torch.models.neural import NeuralLearner, SmallCNN
    from distributed_active_learning_tpu_torch.models.transformer import TransformerClassifier
    from distributed_active_learning_tpu_torch.ops import ring_topk, round_fused, threefry, trees_train
    from distributed_active_learning_tpu_torch.ops.ring_attention import ring_attention
    from distributed_active_learning_tpu_torch.ops.trees_pallas import PallasForest, attach_mesh
    from distributed_active_learning_tpu_torch.parallel import mesh as mesh_lib
    from distributed_active_learning_tpu_torch.runtime import loop as loop_lib
    from distributed_active_learning_tpu_torch.runtime import neural_loop as nl
    from distributed_active_learning_tpu_torch.serving import slab

    t_phase = time.perf_counter()
    out = {"launches": {}, "seconds": {}}
    ring8 = [dev] * POD_SHARDS

    # -- (a) the neural mesh: phase 4n's CNN entropy run on MeshConfig(data=8)
    t0 = time.perf_counter()
    bc = get_dataset(DataConfig(name="cifar10", n_samples=NEURAL_CIFAR, seed=seed), device=dev)
    cnn = NeuralLearner(SmallCNN(n_classes=10, dropout_rate=0.25), (32, 32, 3), train_steps=200,
                        batch_size=64, mc_samples=8, device=dev)
    cfg = nl.NeuralExperimentConfig(strategy="entropy", window_size=100, n_start=100,
                                    max_rounds=NEURAL_ROUNDS, seed=seed,
                                    mesh=MeshConfig(data=POD_SHARDS))
    ref = neural_numbers["cnn"]["entropy"]
    ref_mask = NEURAL_MASKS["cnn_entropy"]
    a = {}
    for path, K in (("neural_mesh", 1), ("neural_mesh_chunked", NEURAL_K)):
        zero_counts()
        threefry.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = nl.run_neural_experiment(dataclasses.replace(cfg, rounds_per_launch=K), cnn,
                                       bc.train_x, bc.train_y, bc.test_x, bc.test_y,
                                       devices=ring8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        c = dict(counts(), threefry=threefry.launches)
        out["launches"][path] = c
        if any(v for k_, v in c.items() if k_ != "threefry") or c["threefry"] == 0:
            fail(f"4r {path} launches {c}: K7 only, and at least once")
        recs = [(r.round, r.n_labeled, r.n_unlabeled, r.accuracy) for r in res.records]
        same_picks = [r[:3] for r in recs] == [r[:3] for r in ref["records"]]
        acc_gap = max(abs(x[3] - y[3]) for x, y in zip(recs, ref["records"]))
        if not same_picks or not torch.equal(res.final_labeled_mask, ref_mask) or \
                acc_gap > MESH_ACC_ATOL:
            moved = int((res.final_labeled_mask != ref_mask).sum())
            fail(f"4r {path} != phase 4n's single-device run: {recs} vs {ref['records']} "
                 f"({moved} mask rows differ, accuracy gap {acc_gap})")
        row = dict(wall=wall, launches=c, accuracy_gap=acc_gap,
                   seconds_per_round=[r.total_time for r in res.records])
        if K > 1:
            g = res.graph_stats
            if g["mode"] != "graph" or g["captures"] != 1 or \
                    g["replays"] != NEURAL_ROUNDS // NEURAL_K:
                fail(f"4r {path}: graph stats {g}")
            row.update(chunked_seconds_per_round=statistics.median(
                r.total_time for r in res.records[NEURAL_K:]),
                capture_seconds=g["capture_seconds"], graph_pool_bytes=g["pool_bytes"])
            print(f"# phase 4r (a) {path}: == phase 4n (records, final mask; accuracy gap "
                  f"{acc_gap:.2e}); {row['chunked_seconds_per_round']:.4f} s/round replayed "
                  f"(4n {ref['chunked_seconds_per_round']:.4f}), capture "
                  f"{g['capture_seconds']:.2f}s (4n {ref['capture_seconds']:.2f}), graph pool "
                  f"{g['pool_bytes'] / 2**20:.0f} MiB (4n {ref['graph_pool_bytes'] / 2**20:.0f}); "
                  f"launches {c} ({kind}, {smi})")
        else:
            per = [p["train"] + p["acquire"] + p["eval"] for p in ref["phases"]]
            print(f"# phase 4r (a) {path}: == phase 4n (records, final mask; accuracy gap "
                  f"{acc_gap:.2e}); {wall:.2f}s wall, s/round "
                  f"{[round(s, 4) for s in row['seconds_per_round']]} (4n "
                  f"{[round(s, 4) for s in per]}); launches {c} ({kind}, {smi})")
        a[path] = row
    out["neural_mesh"] = a
    del bc
    out["seconds"]["a"] = time.perf_counter() - t0

    # -- (b) ring attention for the encoder at AG-News width ----------------
    t0 = time.perf_counter()
    ids = torch.as_tensor(get_dataset(DataConfig(name="agnews", n_samples=NEURAL_AGNEWS,
                                                 seed=seed), device=dev).test_x).to(dev)
    mesh8 = mesh_lib.make_mesh(POD_SHARDS, 1, devices=ring8)
    kw = dict(vocab_size=4096, max_len=64, d_model=128, n_heads=4, n_layers=2, d_ff=256,
              n_classes=4, dropout_rate=0.1)
    learners = {
        "full": NeuralLearner(TransformerClassifier(**kw), (64,), mc_samples=8, device=dev),
        "ring": NeuralLearner(TransformerClassifier(
            **kw, attention_fn=functools.partial(ring_attention, mesh=mesh8)), (64,),
            mc_samples=8, device=dev),
    }
    net = learners["full"].init(prng.key(seed + 2))
    with torch.no_grad():
        logits = {name: lr._chunked(lambda xc, r, lo, lr=lr: lr._forward(net.params, xc, None, r),
                                    ids) for name, lr in learners.items()}
    torch.cuda.synchronize()
    ring_err = float((logits["ring"] - logits["full"]).abs().max())
    if not (ring_err <= RING_VS_FULL_ATOL) or not torch.isfinite(logits["ring"]).all():
        fail(f"4r ring attention logits differ from full attention's by {ring_err} > "
             f"{RING_VS_FULL_ATOL}")
    mc = {}
    for name, lr in learners.items():
        lr.predict_proba_samples(net, ids[:512], prng.key(3, dev))  # warm-up
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        lr.predict_proba_samples(net, ids, prng.key(3, dev))
        end.record()
        end.synchronize()
        mc[name] = start.elapsed_time(end) / 1e3
    out["ring_attention"] = dict(max_abs_err=ring_err, mc_pass_seconds=mc, rows=ids.shape[0])
    print(f"# phase 4r (b) ring attention over {POD_SHARDS} shards (8 tokens a shard): the "
          f"encoder's logits of {ids.shape[0]} test sequences within {ring_err:.2e} of full "
          f"attention's (<= {RING_VS_FULL_ATOL}); one MC pass (8 samples) {mc['ring']:.4f}s "
          f"ring, {mc['full']:.4f}s full ({kind}, {smi})")
    del ids, logits, learners
    out["seconds"]["b"] = time.perf_counter() - t0

    # -- (c) the pod at the serving headline width --------------------------
    t0 = time.perf_counter()
    loop_lib.graph_captures = 0  # the pod runs eagerly: (c) must capture no graph
    mesh = mesh_lib.make_mesh(POD_SHARDS, 1, devices=ring8)
    run = pod_sequence(mesh, dev, pool_np, seed, gf, "4r", counts, zero_counts)
    pod, cap, rows, arrival = run["pod"], run["capacity"], run["shard_rows"], run["arrival"]
    all_x, all_y, all_mask = run["all_x"], run["all_y"], run["all_mask"]
    fills_final = np.asarray(run["trace"]["fills"][-1])
    # Every ingested (and start) row, bit for bit, where the host map says.
    xg = mesh_lib.gather(pod.x).cpu().numpy()
    yg = mesh_lib.gather(pod.oracle_y).cpu().numpy()
    mg = mesh_lib.gather(pod.labeled_mask).cpu().numpy()
    cg = mesh_lib.gather(pod.codes)
    local = np.arange(cap) % rows
    filled = local < np.repeat(fills_final, rows)
    if not np.array_equal(filled, arrival >= 0) or mg[~filled].any():
        fail("4r pod: the host map and the per-shard fills disagree, or a tail row is labeled")
    src_rows = arrival[filled]
    want_codes = trees_train.code_features(torch.from_numpy(all_x[src_rows]).to(dev),
                                           run["edges"])
    if not (np.array_equal(xg[filled], all_x[src_rows]) and np.array_equal(yg[filled],
                                                                          all_y[src_rows])
            and np.array_equal(mg[filled], all_mask[src_rows])
            and torch.equal(cg[torch.from_numpy(filled).to(dev)], want_codes)):
        fail("4r pod: a row's content, label, mask bit or codes moved or changed")
    del xg, cg, want_codes
    # The fused select over the pod (K3 a shard, K4 on the ring) == K2 over
    # the same contents on one device; the picks map back to the rows they
    # were before the last moving epoch.
    sel, pod_forest, pv, pi = run["sel"], run["forest"], run["vals"], run["picks"]
    sel_g = mesh_lib.gather(sel)
    x_g = mesh_lib.gather(pod.x)
    out["launches"]["pod_select"] = run["select_launches"]
    rv, ri = round_fused.fused_score_select(PallasForest(gf=gf), x_g, sel_g, "uncertainty",
                                            WINDOW)
    if not (torch.equal(pv, rv) and torch.equal(pi, ri)):
        fail(f"4r pod select != K2 over the same contents: {(pi != ri).sum().item()} picks differ")
    prev, msrc, mdst = run["last_map"]
    back = ring_topk.remap_indices(pi, msrc, mdst).cpu().numpy()
    if not np.array_equal(prev[back], arrival[pi.cpu().numpy()]):
        fail("4r pod: remap_indices did not name the picks' rows before the last epoch")
    pod_ms = cuda_ms(lambda: round_fused.fused_score_select(pod_forest, pod.x, sel,
                                                           "uncertainty", WINDOW))
    k2_ms = cuda_ms(lambda: round_fused.fused_score_select(PallasForest(gf=gf), x_g, sel_g,
                                                          "uncertainty", WINDOW))
    captures = loop_lib.graph_captures
    if captures:
        fail(f"4r pod: {captures} CUDA graphs captured after warmup, want 0")
    epoch_ms, epochs, fired = run["epoch_ms"], run["epochs"], run["hysteresis_fired"]
    fills_skewed = run["fills_skewed"]
    ingest_pps = run["ingest_points_per_second"]
    out["pod"] = dict(capacity=cap, shard_rows=rows, fills_start=run["fills_start"],
                      fills_skewed=fills_skewed, fills_final=fills_final.tolist(),
                      ingest_points_per_second=ingest_pps, ingest_blocks=POD_INGEST_BLOCKS,
                      epochs=epochs, hysteresis_fired=fired, epoch_ms=epoch_ms,
                      epoch_ms_median=statistics.median(epoch_ms), select_ms=pod_ms,
                      k2_ms=k2_ms, captures=captures, trace=run["trace"])
    print(f"# phase 4r (c) pod: {POD_INGEST_BLOCKS} routed {POD_BLOCK}-row blocks at "
          f"{ingest_pps:.1f} points/s (host clock, a fills read a block); one growth to {cap} "
          f"rows; shard 0 skewed {fills_skewed}; {epochs} epochs of <= {POD_EPOCH_ROWS} "
          f"rows ({fired} fired by the hysteresis), median {out['pod']['epoch_ms_median']:.3f} "
          f"ms, each == the plan's arithmetic, fills {fills_final.tolist()}, then a no-op epoch; "
          f"every row bit for bit; select (K3 x {POD_SHARDS}, K4 x {POD_SHARDS - 1}) == K2 over "
          f"the same contents and remaps to the pre-epoch rows: {pod_ms:.4f} ms vs K2 "
          f"{k2_ms:.4f} ms; {captures} graphs captured ({kind}, {smi})")
    del pod, x_g, sel, sel_g, run
    out["seconds"]["c"] = time.perf_counter() - t0
    out["seconds"]["total"] = time.perf_counter() - t_phase
    print(f"# phase 4r: {out['seconds']['total']:.1f}s ((a) {out['seconds']['a']:.1f}, (b) "
          f"{out['seconds']['b']:.1f}, (c) {out['seconds']['c']:.1f})")
    return out


def serving_phase(seed: int, dev, kind: str, smi: str, counts, zero_counts) -> dict:
    """Phase 4o: the streaming service (see the module docstring). Returns
    its numbers; fails on any gate."""
    import types

    from distributed_active_learning_tpu_torch import bench, config
    from distributed_active_learning_tpu_torch.ops import trees_pallas
    from distributed_active_learning_tpu_torch.serving.service import ALService
    from distributed_active_learning_tpu_torch.serving.tenants import (
        TenantManager,
        make_batched_score_fn,
    )

    t_phase = time.perf_counter()
    out = {"launches": {}, "k1": {}}

    def bench_args(**kw):
        base = dict(features=N_FEAT, trees=TREES, window=20, kernel="pallas", serve_pool=8192,
                    serve_queries=2000, serve_tenants=4, ops_port=None)
        return types.SimpleNamespace(**{**base, **kw})

    def k1_at(label, forest, x):
        """K1 at a serving shape: bit-equal to predict_leaves_plain, timed
        beside it, with its bound."""
        gf = forest.gf
        got = trees_pallas.predict_leaves_pallas(forest, x)
        want = trees_pallas.predict_leaves_plain(gf, x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"serving K1 at {label} {tuple(x.shape)}: {(got != want).sum().item()} leaves "
                 "differ from predict_leaves_plain")
        h = trees_pallas.heap_operands(gf)
        depth = gf.value.shape[1].bit_length() - 1
        lim, by = bound(nbytes(x, h.nodes, h.val) + gf.n_trees * x.shape[0] * 4,
                        x.shape[0] * gf.n_trees * depth)
        row = dict(shape=list(x.shape), trees=gf.n_trees, depth=depth,
                   ms=cuda_ms(lambda: trees_pallas._launch_leaves(h, x), reps=9),
                   device_ms=graph_ms(lambda: trees_pallas._launch_leaves(h, x)),
                   plain_ms=cuda_ms(lambda: trees_pallas.predict_leaves_plain(gf, x), reps=3),
                   bound_ms=lim, bound_by=by, max_abs_err=float((got - want).abs().max()))
        out["k1"][label] = row
        print(f"# phase 4o K1 at {label} {tuple(x.shape)} x {gf.n_trees} trees depth {depth}: "
              f"{row['ms']:.4f} ms ({row['device_ms']:.4f} device), plain {row['plain_ms']:.4f}, "
              f"bound {lim:.4f} ms by {by}, bit-equal ({kind}, {smi})")

    def serve_gates(label, line, svc, graphs_cap=2):
        if line["recompiles_after_warmup"] != 0:
            fail(f"{label}: recompiles_after_warmup {line['recompiles_after_warmup']}")
        if line["serve_max_live_graphs"] > graphs_cap or svc.manager.live_graphs()["default"] > 2:
            fail(f"{label}: {line['serve_max_live_graphs']} live chunk graphs")
        if any(not np.isfinite(v) for v in (line["serve_p50_ms"], line["serve_p99_ms"])):
            fail(f"{label}: latency not finite: {line}")
        g = svc._tenant.program_stats()
        per_refit = [st["launches_per_replay"]["trees_pallas.launches"] for st in g]
        if not per_refit or set(per_refit) != {2 * svc.serve.refit_rounds}:
            fail(f"{label}: K1 launches a re-fit {per_refit}, want {2 * svc.serve.refit_rounds}")
        print(f"# phase 4o {label}: {line['serve_qps']} qps, p50 {line['serve_p50_ms']} ms, p99 "
              f"{line['serve_p99_ms']} ms (in flight {line['serve_p99_ms_refit_inflight']}, "
              f"{line['serve_queries_refit_inflight']} queries; without "
              f"{line['serve_p99_ms_no_refit']}), {line['serve_scores_per_sec']} scores/s, "
              f"ingest {line['ingest_points_per_sec']} points/s, refits "
              f"{line['refit_reasons']}, growths {line['slab_growths']} (precompiled "
              f"{line['serve_growths_precompiled']}, causes {line['serve_latency_causes']}), "
              f"chunk {line.get('refit_chunk_seconds_per_round')} s a round, capacity "
              f"{line['slab_capacity']}, fill {line['pool_fill']}, labeled {line['pool_labeled']}, "
              f"K1 {line['serve_k1_launches']} launches in the window, {per_refit[0]} a re-fit; "
              f"graphs: capture s {line.get('serve_capture_seconds')}, pool MiB "
              f"{line.get('serve_graph_pool_mib')}; peak reserved {line.get('peak_reserved_mib')} "
              f"MiB; most live graphs {line['serve_max_live_graphs']} ({kind}, {smi})")
        return dict(line, k1_launches_per_refit=per_refit[0], graphs=g)

    # -- (a) the JAX bench's serve leg at its full sizes ----------------------
    # Its outcome must be the JAX package's: `JAX_PLATFORMS=cpu python
    # bench.py --mode serve --serve-queries 2000 --serve-pool 8192 --trees 100
    # --kernel gemm` gives these counts (the drift monitor's entropy trigger
    # does not fire at these sizes there either; it does at the JAX bench's
    # smoke sizes, the leg after this one).
    jax_full = {"refits": 12, "refit_rounds": 48, "refit_reasons": {"warmup": 1, "staleness": 11},
                "slab_growths": 32, "slab_capacity": 40960, "pool_fill": 40256,
                "pool_labeled": 980}
    torch.cuda.empty_cache()  # each leg's peak reserve is its own
    zero_counts()
    t0 = time.perf_counter()
    line_a, svc_a, data_a = bench.run_serve(bench_args(), dev)
    out["launches"]["serve"] = counts()
    if {k: line_a[k] for k in jax_full} != jax_full:
        fail(f"(a): {({k: line_a[k] for k in jax_full})} != the JAX bench's {jax_full}")
    out["serve"] = serve_gates("(a) serve, 8,192 rows, depth 4", line_a, svc_a)
    out["serve"]["seconds"] = time.perf_counter() - t0
    x0, y0, tx, ty = data_a
    # K1's timings capture CUDA graphs in the global mode: the precompile
    # worker must be idle first.
    if not svc_a.manager.wait_precompiles(timeout=600):
        fail("(a): the precompile worker did not finish")
    q = torch.from_numpy(tx[:64]).to(dev)
    zero_counts()
    svc_a.score(tx[:64])
    out["k1_launches_per_query"] = counts()["forest_leaves"]
    if out["k1_launches_per_query"] != 1:
        fail(f"a query launched K1 {out['k1_launches_per_query']} times, want 1")
    k1_at("serve score [64, 30]", svc_a._tenant._forest, q)
    k1_at("serve slab", svc_a._tenant._forest, svc_a._slab.x)
    # A checkpoint written at the end resumes with bit-equal scores.
    ck = tempfile.mkdtemp(prefix="serve_ckpt_")
    svc_a._tenant.checkpoint_dir = ck
    svc_a.save_checkpoint()
    resumed = ALService(svc_a.cfg, svc_a.serve, x0, y0, tx, ty, checkpoint_dir=ck, device=dev)
    qs = np.random.default_rng(seed + 14).normal(size=(128, N_FEAT)).astype(np.float32)
    if not np.array_equal(resumed.score(qs), svc_a.score(qs)) or (
            resumed._fill, resumed._labeled) != (svc_a._fill, svc_a._labeled):
        fail("(a): the resumed service scores differently")
    resumed.manager.close()
    svc_a.manager.close()
    shutil.rmtree(ck, ignore_errors=True)
    del svc_a, resumed

    # -- (a') the same leg at the JAX bench's smoke sizes: its committed
    # baseline (benches/baselines/cpu_smoke_serve.json) fires entropy_shift,
    # and the card must reproduce its counts.
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "benches", "baselines",
                           "cpu_smoke_serve.json")) as f:
        baseline = json.load(f)
    keys = ("refits", "refit_rounds", "refit_reasons", "slab_growths", "slab_capacity",
            "pool_fill", "pool_labeled", "recompiles_after_warmup")
    line_s, svc_s, _ = bench.run_serve(bench_args(trees=10, serve_pool=256, serve_queries=220),
                                       dev)
    svc_s.manager.close()
    if "entropy_shift" not in line_s["refit_reasons"] or any(
            line_s[k] != baseline[k] for k in keys):
        fail(f"(a') the smoke-size leg {({k: line_s[k] for k in keys})} != the JAX bench's "
             f"baseline {({k: baseline[k] for k in keys})}")
    out["serve_smoke_sizes"] = {k: line_s[k] for k in keys}
    print(f"# phase 4o (a') the JAX bench's smoke sizes (256 rows, 220 queries, 10 trees): "
          f"re-fit reasons {line_s['refit_reasons']}, growths {line_s['slab_growths']}, fill "
          f"{line_s['pool_fill']}, labeled {line_s['pool_labeled']} == its committed baseline")

    # -- the JAX test's small service: card == CPU ----------------------------
    def points(n, s, shift=0.0):
        r = np.random.default_rng(s)
        x = r.normal(size=(n, 4)).astype(np.float32) + shift
        return x, (x[:, 0] + 0.3 * x[:, 1] > shift).astype(np.int32)

    small = []
    for d in (dev, "cpu"):
        cfg = config.ExperimentConfig(
            forest=config.ForestConfig(n_trees=6, max_depth=3, max_bins=8, fit="device",
                                       fit_budget=64, kernel="pallas"),
            strategy=config.StrategyConfig(window_size=4), n_start=6, log_every=0)
        serve = config.ServeConfig(slab_rows=64, ingest_block=16, score_width=16, refit_rounds=2,
                                   drift_entropy_shift=0.2, drift_min_fresh=8, max_staleness=5,
                                   refit_poll_events=1)
        sx0, sy0 = points(48, 0)
        stx, sty = points(32, 1)
        svc = ALService(cfg, serve, sx0, sy0, stx, sty, device=d)
        r = np.random.default_rng(2)
        sx, sy = points(192, 3, 2.0)
        sc = []
        for i in range(20):
            if i % 3 == 0:
                svc.submit(sx[16 * (i // 3): 16 * (i // 3 + 1)], sy[16 * (i // 3): 16 * (i // 3 + 1)])
            sc.append(svc.score(stx[r.integers(0, 32, size=8)]))
        svc.flush()
        small.append((svc, sc))
    (g, g_sc), (c, c_sc) = small
    if not (all(np.array_equal(a, b) for a, b in zip(g_sc, c_sc))
            and g.summary() == c.summary()
            and torch.equal(g._slab.labeled_mask.cpu(), c._slab.labeled_mask)
            and g.result.to_reference_log() == c.result.to_reference_log()):
        fail(f"the small service differs between the card and the CPU: {g.summary()} vs "
             f"{c.summary()}")
    print(f"# phase 4o: the small service card == CPU (scores, summary, mask, records; "
          f"{g.summary()['slab_growths']} growths, {g.summary()['refits']} re-fits)")
    for svc, _ in small:
        svc.manager.close()

    # -- (b) the headline pool: 284,807 rows, depth 8 --------------------------
    torch.cuda.empty_cache()
    zero_counts()
    t0 = time.perf_counter()
    line_b, svc_b, _ = bench.run_serve(bench_args(serve_pool=N_POOL, serve_queries=400), dev,
                                       depth=DEPTH)
    out["launches"]["serve_headline"] = counts()
    out["serve_headline"] = serve_gates("(b) serve, 284,807 rows, depth 8", line_b, svc_b)
    out["serve_headline"]["seconds"] = time.perf_counter() - t0
    if not svc_b.manager.wait_precompiles(timeout=600):
        fail("(b): the precompile worker did not finish")
    k1_at("headline slab", svc_b._tenant._forest, svc_b._slab.x)
    k1_at("headline score [64, 30]", svc_b._tenant._forest, q)
    svc_b.manager.close()
    del svc_b

    # -- (c) serve-multi: 4 gemm tenants through the frontend ------------------
    torch.cuda.empty_cache()
    zero_counts()
    t0 = time.perf_counter()
    line_c = bench.bench_serve_multi(bench_args(kernel="gemm"), dev)
    out["launches"]["serve_multi"] = counts()
    out["serve_multi"] = dict(line_c, seconds=time.perf_counter() - t0)
    if (line_c["serve_multi_recompiles_after_warmup"] != 0
            or line_c["serve_multi_growth_compile_events"] != 0
            or line_c["serve_multi_growths_precompiled"] < 1
            or line_c["serve_multi_score_fallback_reasons"] != {}
            or any(n > 2 for t, n in line_c["serve_multi_live_graphs"].items() if t != "_batched")):
        fail(f"(c) serve-multi gates: {line_c}")
    print(f"# phase 4o (c) serve-multi: {line_c['serve_multi_qps']} qps over 4 tenants, p50 "
          f"{line_c['serve_multi_p50_ms']} ms, p99 {line_c['serve_multi_p99_ms']} ms, growths "
          f"{line_c['serve_multi_slab_growths']} (precompiled "
          f"{line_c['serve_multi_growths_precompiled']}, growth-compile events "
          f"{line_c['serve_multi_growth_compile_events']}), batched score launches "
          f"{line_c['serve_multi_batched_score_launches']}, batched re-fits "
          f"{line_c['serve_multi_batched_refit_launches']}, precompiles "
          f"{line_c['serve_multi_precompiles']}, recompiles "
          f"{line_c['serve_multi_recompiles_after_warmup']}, capture s "
          f"{line_c.get('serve_capture_seconds')}, pool MiB {line_c.get('serve_graph_pool_mib')}, "
          f"peak reserved {line_c.get('peak_reserved_mib')} MiB ({kind}, {smi})")

    # Grouped scores == single scores, the batched re-fit's masks == those of
    # independent services (3 gemm tenants of the bench's configuration at
    # 2,048 rows).
    def tenant_cfg(i, kernel="gemm"):
        cfg = config.ExperimentConfig(
            forest=config.ForestConfig(n_trees=TREES, max_depth=4, kernel=kernel, fit="device",
                                       fit_budget=1024),
            strategy=config.StrategyConfig(window_size=20), n_start=20, log_every=0, seed=i)
        return cfg, config.ServeConfig(slab_rows=1024, ingest_block=64, score_width=64,
                                       refit_rounds=4, max_staleness=0, drift_entropy_shift=99.0)

    def tenant_data(i, n=2048):
        r = np.random.default_rng(seed + 40 + i)
        x = r.normal(size=(n + 512, N_FEAT)).astype(np.float32) + 0.4 * i
        y = labels(x - 0.4 * i)
        return x[:n], y[:n], x[n:], y[n:]

    mgr = TenantManager(device=dev)
    svcs = []
    for i in range(3):
        cfg, serve = tenant_cfg(i)
        mgr.add_tenant(f"t{i}", cfg, serve, *tenant_data(i))
        svcs.append(ALService(cfg, serve, *tenant_data(i), device=dev))
    qq = {f"t{i}": np.random.default_rng(seed + 90 + i).normal(size=(80, N_FEAT)).astype(
        np.float32) for i in range(3)}
    batched = mgr.score_many(qq)
    # On the card a grouped score replays each member's graphed endpoint;
    # the grouped program itself (the CPU's path) is held here too, on this
    # thread's stream, behind the members' fits (no device-wide sync: the
    # precompile worker may be capturing).
    grouped, _ = make_batched_score_fn()(
        [mgr.tenant(f"t{i}")._forest for i in range(3)],
        torch.stack([torch.from_numpy(qq[f"t{i}"][:64]) for i in range(3)]).to(dev))
    grouped = grouped.cpu().numpy()
    for i in range(3):
        single = svcs[i].score(qq[f"t{i}"])
        if not np.array_equal(batched[f"t{i}"], single):
            fail(f"grouped scores of t{i} != its single scores")
        if not np.array_equal(grouped[i], single[:64]):
            fail(f"make_batched_score_fn's scores of t{i} != its single scores")
        sx = tenant_data(i, 2048 + 128)[0][2048:2112]
        mgr.submit(f"t{i}", sx, labels(sx))
        svcs[i].submit(sx, labels(sx))
    if mgr.refit_now("check") != 3 or mgr.batched_refit_launches != 1:
        fail("the batched re-fit did not launch once for 3 tenants")
    for s_ in svcs:
        s_.refit_now("check")
    mgr.flush()
    for i, s_ in enumerate(svcs):
        s_.flush()
        t = mgr.tenant(f"t{i}")
        if not (torch.equal(t._slab.labeled_mask, s_._slab.labeled_mask)
                and torch.equal(t._key, s_._tenant._key)):
            fail(f"the batched re-fit's mask or key of t{i} != an independent service's")
        s_.manager.close()
    mgr.close()
    print("# phase 4o: grouped scores (replayed endpoints and make_batched_score_fn) == single "
          "scores, batched re-fit masks and keys == 3 independent services (3 gemm tenants, "
          "2,048 rows)")

    # A pallas-kernel tenant pair: the named per-tenant fallback, and its K1
    # launches.
    pair = TenantManager(device=dev)
    for i in range(2):
        cfg, serve = tenant_cfg(i, kernel="pallas")
        pair.add_tenant(f"p{i}", cfg, serve, *tenant_data(i, 8192))
    # Steady state: the endpoints' graphs captured (a first call's eager
    # warm-up launches K1 too) and the worker idle.
    pair.score_many({f"p{i}": qq[f"t{i}"][:64] for i in range(2)})
    if not pair.wait_precompiles(timeout=600):
        fail("the pallas pair's precompile worker did not finish")
    zero_counts()
    pair.score_many({f"p{i}": qq[f"t{i}"][:64] for i in range(2)})
    pair_k1 = counts()["forest_leaves"]
    reasons = dict(pair.score_fallback_reasons)
    pair.close()
    if reasons != {"kernel": 4} or pair_k1 != 2:
        fail(f"the pallas pair: fallback {reasons}, K1 {pair_k1}")
    out["pallas_pair"] = dict(fallback_reasons=reasons, k1_launches=pair_k1)
    print(f"# phase 4o: a pallas tenant pair scores per tenant, reason {reasons}, K1 {pair_k1} "
          "launches (one a tenant)")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"# phase 4o: {out['seconds']:.1f}s ((a) {out['serve']['seconds']:.1f}, (b) "
          f"{out['serve_headline']['seconds']:.1f}, (c) {out['serve_multi']['seconds']:.1f})")
    return out


# Phase 4s: the ranks of each spawned group, its rounds, and each group's
# time limit (a missed collective must not hold the script).
MP_FOREST_RANKS, MP_NEURAL_RANKS, MP_NEURAL_ROUNDS = 4, 2, 2
#: The rings 4s replays through IPC and gloo, in the order its runs keep
#: them: (a)'s ring over the 4 ranks, (c)'s column rings of MeshConfig(2, 2),
#: (e)'s rings of MeshConfig(6, 2) and (3, 4) (members repeated).
RING_TAGS = ("ring", "column_ring", "cross62_ring", "cross34_ring")
#: (e)'s meshes: each path's (data, model), 3 cells a rank.
MP_CROSSING = {"cross62": (6, 2), "cross34": (3, 4)}
MP_TIMEOUT_S = 420


def spawn_ranks(job: str, n: int, job_dir: str, seed: int) -> list:
    """``n`` ranks of this script's ``--rank-job job``, joined by the env
    trio over a TCP rendezvous on localhost, every rank on ``cuda:0``;
    returns each rank's JSON record in rank order. Fails (killing every
    rank) on a rank's error or at ``MP_TIMEOUT_S``."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs, logs = [], []
    for r in range(n):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(r), LOCAL_RANK="0")
        log = open(os.path.join(job_dir, f"rank{r}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--seed", str(seed), "--rank-job", job,
             "--job-dir", job_dir], env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.perf_counter() + MP_TIMEOUT_S
    while any(p.poll() is None for p in procs):
        failed = any(p.poll() not in (None, 0) for p in procs)
        if failed or time.perf_counter() > deadline:
            for p in procs:  # a rank that failed leaves the others in a collective
                p.kill()
                p.wait()
            if not failed:
                fail(f"4s {job}: a rank of {n} ran past {MP_TIMEOUT_S}s (a missed collective?)")
            break
        time.sleep(0.2)
    got = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        lines = [ln for ln in text.splitlines() if ln.startswith("RANK_RESULT ")]
        if p.returncode != 0 or not lines:
            fail(f"4s {job}: rank {r} exited {p.returncode}:\n{text[-6000:]}")
        got.append(json.loads(lines[-1].split(" ", 1)[1]))
    return got


def sha(t) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        t.cpu().numpy() if torch.is_tensor(t) else t).tobytes()).hexdigest()


def rank_job(args) -> int:
    """One rank of phase 4s (``--rank-job forest|neural``): joins the gloo
    group through the env trio, runs its leg on the rank's card and prints
    ``RANK_RESULT {json}``."""
    from distributed_active_learning_tpu_torch.config import DataConfig, MeshConfig
    from distributed_active_learning_tpu_torch.device import resolve_device
    from distributed_active_learning_tpu_torch.ops import ring_topk, round_fused, threefry
    from distributed_active_learning_tpu_torch.ops import trees_pallas
    from distributed_active_learning_tpu_torch.parallel import multihost

    if not multihost.maybe_initialize():
        fail("a rank job needs the multi-process env (JAX_NUM_PROCESSES above 1)")
    dev = resolve_device(None)
    rank, n = multihost.process_index(), multihost.process_count()
    out = {"rank": rank, "device": str(dev), "processes": n}

    def zero():
        trees_pallas.launches = round_fused.launches = 0
        round_fused.votes_launches = ring_topk.launches = threefry.launches = 0

    def counted():
        return {"forest_leaves": trees_pallas.launches, "round_megakernel": round_fused.launches,
                "fused_votes": round_fused.votes_launches, "ring_hop": ring_topk.launches,
                "threefry": threefry.launches}

    if args.rank_job == "forest":
        from distributed_active_learning_tpu_torch.config import (
            ExperimentConfig, ForestConfig, StrategyConfig,
        )
        from distributed_active_learning_tpu_torch.data.datasets import DataBundle
        from distributed_active_learning_tpu_torch.runtime import loop
        from distributed_active_learning_tpu_torch.runtime.debugger import Debugger

        rng = np.random.default_rng(args.seed)  # phase 2's draws, in its order
        pool_np = rng.normal(size=(N_POOL, N_FEAT)).astype(np.float32)
        rng.normal(size=(N_START, N_FEAT))
        test_np = rng.normal(size=(N_TEST, N_FEAT)).astype(np.float32)
        bundle = DataBundle(train_x=pool_np, train_y=labels(pool_np), test_x=test_np,
                            test_y=labels(test_np), name="bench_pool")
        cfg = ExperimentConfig(
            forest=ForestConfig(n_trees=TREES, max_depth=DEPTH, max_bins=BINS, fit="device",
                                kernel="pallas"),
            strategy=StrategyConfig(name="uncertainty", window_size=WINDOW),
            mesh=MeshConfig(4, 2), n_start=N_START, max_rounds=ROUNDS, fused_round=True,
            seed=args.seed)
        seen = []
        ring_processes = ring_topk._ring_topk_processes

        keep = [True]  # keep the next ring's windows (each run's first ring)

        def first_ring(windows, k, rings, plain, received):
            if keep[0]:
                seen.append(([(v.clone(), i.clone()) for v, i in windows], k, rings))
                keep[0] = False
            return ring_processes(windows, k, rings, plain, received)

        ring_topk._ring_topk_processes = first_ring
        for path, kw in (("procs4_fused", dict(checkpoint_dir=os.path.join(args.job_dir, "ckpt"),
                                               checkpoint_every=1)),
                         ("procs4_chunked", dict(rounds_per_launch=2)),
                         # (c) the model axis across the processes, one cell a rank
                         ("procs4_model_fused", dict(
                             mesh=MeshConfig(2, 2), checkpoint_every=1,
                             checkpoint_dir=os.path.join(args.job_dir, "ckpt_model"))),
                         ("procs4_model_unfused", dict(mesh=MeshConfig(2, 2),
                                                       fused_round=False)),
                         ("procs4_row_fused", dict(mesh=MeshConfig(1, 4))),
                         ("procs4_model_chunked", dict(mesh=MeshConfig(2, 2),
                                                       rounds_per_launch=2)),
                         # (e) cells that cross a row boundary partway: 3
                         # cells a rank, whole rows and a half, or no
                         # whole row
                         ("procs4_cross62_fused", dict(mesh=MeshConfig(6, 2))),
                         ("procs4_cross62_unfused", dict(mesh=MeshConfig(6, 2),
                                                         fused_round=False)),
                         ("procs4_cross62_chunked", dict(mesh=MeshConfig(6, 2),
                                                         rounds_per_launch=2)),
                         ("procs4_cross34_fused", dict(mesh=MeshConfig(3, 4))),
                         ("procs4_cross34_unfused", dict(mesh=MeshConfig(3, 4),
                                                         fused_round=False)),
                         ("procs4_cross34_chunked", dict(mesh=MeshConfig(3, 4),
                                                         rounds_per_launch=2))):
            keep[0] = keep[0] or path in ("procs4_model_fused", "procs4_cross62_fused",
                                          "procs4_cross34_fused")
            zero()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            res = loop.run_experiment(dataclasses.replace(cfg, **kw), bundle=bundle,
                                      debugger=Debugger(enabled=False), device=dev)
            torch.cuda.synchronize(dev)
            out[path] = dict(
                wall=time.perf_counter() - t0, launches=counted(),
                records=[[r.round, r.n_labeled, r.accuracy] for r in res.records],
                split=[[r.train_time, r.score_time, r.eval_time] for r in res.records],
                mask_sha=sha(res.final_labeled_mask),
                mask_count=int(res.final_labeled_mask.sum()),
                graph=(None if res.graph_stats is None else
                       {k: res.graph_stats[k] for k in ("mode", "mode_reason")}))
        ring_topk._ring_topk_processes = ring_processes
        # Each kept ring again (the whole-row run's over the 4 ranks, the
        # model-axis run's column rings, (e)'s rings with repeated members):
        # through CUDA IPC (K4) and through the plain gloo hop, every
        # received window and the merges compared; then each route timed a
        # step.
        for tag, (windows, k, rings) in zip(RING_TAGS, seen):
            got_ipc, got_gloo = [], []
            m_ipc = ring_topk.ring_topk(windows, k, members=rings, received=got_ipc)
            m_gloo = ring_topk.ring_topk(windows, k, members=rings, plain=True,
                                         received=got_gloo)
            pairs = list(zip(got_ipc + m_ipc, got_gloo + m_gloo))
            out[f"{tag}_equal"] = len(got_ipc) == len(got_gloo) and all(
                torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in pairs)
            out[f"{tag}_max_abs_err"] = max(float((a[0] - b[0]).abs().max()) for a, b in pairs)
            out[f"{tag}_windows"] = len(got_ipc)
            out[f"{tag}_members"] = [list(r) for r in rings]
            steps = len(rings[0]) - 1
            for route, plain in (("ipc", False), ("gloo", True)):
                times = []
                for _ in range(7):
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    ring_topk.ring_topk(windows, k, members=rings, plain=plain)
                    torch.cuda.synchronize(dev)
                    times.append((time.perf_counter() - t0) / steps * 1e3)
                out[f"{tag}_{route}_step_ms"] = statistics.median(times)
        # (d) the pod over the processes: 4r (c)'s sequence on MeshConfig(8,
        # 1), 2 rows a rank, phase 2's forest from the parent's file.
        from distributed_active_learning_tpu_torch.ops.trees_gemm import GemmForest
        from distributed_active_learning_tpu_torch.parallel import mesh as mesh_lib

        gf = GemmForest(**{k_: v.to(dev) for k_, v in torch.load(
            os.path.join(args.job_dir, "pod_forest.pt")).items()})
        t0 = time.perf_counter()
        run = pod_sequence(mesh_lib.make_mesh(POD_SHARDS, 1, device=dev), dev, pool_np,
                           args.seed, gf, "4s (d)", counted, zero)
        out["pod"] = dict(trace=run["trace"], epoch_ms=run["epoch_ms"], epochs=run["epochs"],
                          ingest_points_per_second=run["ingest_points_per_second"],
                          select_launches=run["select_launches"],
                          seconds=time.perf_counter() - t0)
        zero()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(5):
            round_fused.fused_score_select(run["forest"], run["pod"].x, run["sel"],
                                           "uncertainty", WINDOW)
        torch.cuda.synchronize(dev)
        out["pod"]["select_ms"] = (time.perf_counter() - t0) / 5 * 1e3
        del run
    else:
        from distributed_active_learning_tpu_torch.data.datasets import get_dataset
        from distributed_active_learning_tpu_torch.models.neural import NeuralLearner, SmallCNN
        from distributed_active_learning_tpu_torch.runtime import neural_loop as nl

        bc = get_dataset(DataConfig(name="cifar10", n_samples=NEURAL_CIFAR, seed=args.seed),
                         device=dev)
        cnn = NeuralLearner(SmallCNN(n_classes=10, dropout_rate=0.25), (32, 32, 3),
                            train_steps=200, batch_size=64, mc_samples=8, device=dev)
        cfg = nl.NeuralExperimentConfig(strategy="entropy", window_size=100, n_start=100,
                                        max_rounds=MP_NEURAL_ROUNDS, seed=args.seed,
                                        mesh=MeshConfig(data=n))
        zero()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = nl.run_neural_experiment(cfg, cnn, bc.train_x, bc.train_y, bc.test_x, bc.test_y)
        torch.cuda.synchronize(dev)
        out["procs2_neural"] = dict(
            wall=time.perf_counter() - t0, launches=counted(),
            records=[[r.round, r.n_labeled, r.n_unlabeled, r.accuracy] for r in res.records],
            seconds_per_round=[r.total_time for r in res.records],
            mask_sha=sha(res.final_labeled_mask))
    print("RANK_RESULT " + json.dumps(out), flush=True)
    return 0


def preflight_phase(seed: int, dev, kind: str, smi: str, counts, zero_counts) -> dict:
    """Phase 4t: the pre-flight (``analysis/``) on the card. (a) roofline:
    the headline fused round step counted on the card, equal to its count on
    the meta device, timed as a graph replay and attributed (no share above
    1.0; K1's and K2's rows at their declared bytes); the chunk (K = 4,
    RoundMetrics on, so unfused) through ``run_experiment`` with
    ``cfg.roofline``, whose ``roofline`` event must carry no error and no
    share above 1.0. (b) memory: the forest chunk's round step, 4n's CNN
    chunk step and 4o (b)'s serving capacity (291,840 rows, depth 8), each
    priced on the meta device, then run eagerly (``max_memory_allocated``
    after ``reset_peak_memory_stats``) and captured (``GraphedChunk``'s
    private pool): a prediction below a measurement fails. (c) ``run.py
    --audit`` with a 64 MiB budget table refuses with ``hbm-over-budget``
    and launches nothing, and so does the K = 4 chunk with a budget between
    its eager peak and its resident inputs + captured pool; with the card's
    budget the run prints the records of the same run without ``--audit``.
    (d) the shared-memory mirrors of K1,
    K2 and K3 equal the C configuration at the headline pool, the mesh
    shard, 256 streamed trees and the serving endpoint, for each payload.
    (e) the program auditor on the card: (b)'s forest chunk and 4 x 2 mesh
    chunk, traced on the card (``analysis/auditor.py``, not on the meta
    device), audit clean and their traced kernel launches equal their
    capture's tally; every program (c)'s ``--audit``
    runs examined is traced on the card and audits clean; ``run.py
    --audit`` refuses three planted defects by rule id (a ``.item()`` in
    the chunk body, an f64 op, the pool's mask gathered whole on every
    shard of the mesh), launching nothing; the lint over the port's
    ``runtime/``, ``serving/`` and ``strategies/`` finds nothing."""
    import ctypes
    import dataclasses

    from distributed_active_learning_tpu_torch import analysis, kernels
    from distributed_active_learning_tpu_torch import run as run_cli
    from distributed_active_learning_tpu_torch.analysis import (
        auditor, costs, lint, memory, programs, roofline,
    )
    from distributed_active_learning_tpu_torch.device import deterministic_cuda
    from distributed_active_learning_tpu_torch.runtime import loop, neural_loop

    t_phase = time.perf_counter()
    out = {"roofline": {}, "memory": {}, "audit_on_card": {}}

    def check_shares(name, attr):
        if "error" in attr:
            fail(f"4t roofline {name}: {attr['error']}")
        over = {k: v for k, v in roofline.shares(attr).items() if v > 1.0}
        if over:
            fail(f"4t roofline {name}: a share above 1.0 ({over}): the count is wrong")

    def graphed(unit, carry_fields=loop.CARRY_FIELDS, carry_arg=1, input_args=(6,)):
        return loop.GraphedChunk(loop.chunk_of(unit.fn, lambda rows, *a: (None, rows), 1,
                                               carry_arg=carry_arg),
                                 input_args=input_args, carry_fields=carry_fields)

    # (a) the headline fused round step, counted on the card and on meta.
    head = programs.forest_program("chunk", programs.BENCH_CONFIG, programs.BENCH_SHAPES,
                                   seed=seed)
    # Counted on a warm call: a device's constants (bin edges' Poisson CDF,
    # the heap path matrices) are uploaded once, at its first call.
    unit, meta_unit = head(dev), head(torch.device("meta"))
    unit.fn(*unit.args)
    meta_unit.fn(*meta_unit.args)
    card_cost = roofline.program_cost(unit.fn, *unit.args)
    meta_cost = roofline.program_cost(meta_unit.fn, *meta_unit.args)
    del meta_unit
    for key in ("flops", "bytes_accessed", "kernels"):
        if card_cost[key] != meta_cost[key]:
            fail(f"4t: the round step's {key} on the card {card_cost[key]} != on the meta "
                 f"device {meta_cost[key]}")
    step = graphed(unit)
    step(*unit.args)  # capture and a first replay
    reps = []
    for _ in range(7):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(*unit.args)
        end.record()
        end.synchronize()
        reps.append(start.elapsed_time(end) / 1e3)
    attr = roofline.attribute_card(card_cost, statistics.median(reps))
    check_shares("round", attr)
    want = {"forest_leaves": costs.forest_leaves(N_TEST, N_FEAT, TREES, DEPTH),
            "round_megakernel": costs.round_megakernel(N_POOL, N_FEAT, TREES, DEPTH, WINDOW)}
    for name, (flops, nbytes) in want.items():
        row = card_cost["kernels"].get(name)
        if row is None or row["calls"] != 1 or row["bytes"] != nbytes or row["flops"] != flops:
            fail(f"4t: {name}'s row {row} != its declared cost at PERF.md section 6's shape "
                 f"({flops} FLOPs, {nbytes} bytes)")
        lim, by = bound(nbytes, flops)
        print(f"# 4t roofline {name}: {row['bytes']:.0f} bytes, {row['flops']:.0f} FLOPs, bound "
              f"{lim:.4f} ms by {by}")
    out["roofline"]["round"] = attr
    print(f"# 4t roofline round (fused, headline): {attr['flops']:.4g} FLOPs, "
          f"{attr['bytes_accessed']:.4g} bytes, {attr['seconds']:.6f} s (graph replay), mfu "
          f"{attr['mfu']} (bf16), mfu_f32 {attr['mfu_f32']}, bandwidth_util "
          f"{attr['bandwidth_util']}, {attr['bound']}; card == meta count ({kind}, {smi})")
    del step, unit
    # The chunk (K = 4) with --roofline semantics: the loop's own event.
    cfg = dataclasses.replace(programs.BENCH_CONFIG, fused_round=False, roofline=True)
    rng = np.random.default_rng(seed)
    pool_np = rng.normal(size=(N_POOL, N_FEAT)).astype(np.float32)
    test_np = rng.normal(size=(N_TEST, N_FEAT)).astype(np.float32)
    from distributed_active_learning_tpu_torch.data.datasets import DataBundle
    from distributed_active_learning_tpu_torch.runtime.debugger import Debugger
    from distributed_active_learning_tpu_torch.runtime.telemetry import MetricsWriter

    bundle = DataBundle(pool_np, labels(pool_np), test_np, labels(test_np), "bench")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "m.jsonl")
        writer = MetricsWriter(path)
        loop.run_experiment(cfg, bundle=bundle, debugger=Debugger(enabled=False),
                            metrics=writer, device=dev)
        writer.close()
        with open(path) as f:
            events = [e for e in map(json.loads, f) if e["kind"] == "roofline"]
    if len(events) != 1:
        fail(f"4t: the chunked run emitted {len(events)} roofline events, want 1")
    event = events[0]
    check_shares("chunk", event)
    out["roofline"]["chunk"] = {k: event[k] for k in (
        "program", "calls", "flops", "bytes_accessed", "seconds", "mfu", "mfu_f32",
        "bandwidth_util", "bound", "peak_tables")}
    print(f"# 4t roofline chunk (K = 4, unfused, metrics on; the loop's event): "
          f"{event['flops']:.4g} FLOPs, {event['bytes_accessed']:.4g} bytes, "
          f"{event['seconds']} s a launch over {event['calls']} launches, mfu {event['mfu']}, "
          f"mfu_f32 {event['mfu_f32']}, bandwidth_util {event['bandwidth_util']}, "
          f"{event['bound']} ({kind}, {smi})")

    # (b) memory: predicted on meta, measured eagerly and at capture.
    deterministic_cuda()
    under = []
    cases = (
        ("forest chunk step", head, loop.CARRY_FIELDS),
        ("CNN chunk step (4n)", programs.neural_chunk_program(programs.CNN_SHAPES, seed=seed),
         neural_loop.NEURAL_CARRY_FIELDS),
        ("serving capacity 291,840 (4o b)", programs.serve_program(
            "serve_chunk", programs.serve_config(DEPTH), programs.SERVE_CONFIG, 291_840,
            N_FEAT, N_TEST, seed=seed), loop.CARRY_FIELDS),
    )
    # The programs --audit prices for the other kinds of run: 4j's sweep (E
    # = 8) and 4k's grid (3 strategies x 4 seeds), K = 4, RoundMetrics on;
    # a noisy-oracle chunk; 4q's chunk on MeshConfig(4, 2) over [cuda:0] *
    # 8; 4i's LAL round (a 200 x depth-10 regressor); 4n's CNN neural sweep
    # at 2 lanes. Each as its driver launches it (a round step; the round
    # itself for LAL, captured here as a graph of one round to read its
    # pool).
    from distributed_active_learning_tpu_torch.config import (
        MeshConfig, ScenarioConfig, StrategyConfig,
    )

    unfused = dataclasses.replace(programs.BENCH_CONFIG, fused_round=False)
    grid_in = (10, 11, 13, 14)

    def round_step(make):
        def make_step(device):
            unit = make(device)
            return programs.ProgramUnit(
                lambda *a: (lambda r: (r[0], r[1:]))(unit.fn(*a)), unit.args)
        return make_step

    cases += (
        ("sweep E = 8 (4j)", programs.grid_program(
            unfused, [programs.BENCH_SHAPES], ["uncertainty"], 8, with_metrics=True, seed=seed),
         loop.CARRY_FIELDS, 3, grid_in),
        ("grid 12 cells (4k)", programs.grid_program(
            unfused, [programs.BENCH_SHAPES], ["uncertainty", "margin", "density"], 4,
            with_metrics=True, seed=seed), loop.CARRY_FIELDS, 3, grid_in),
        ("noisy-oracle chunk", programs.forest_program(
            "chunk", dataclasses.replace(unfused, scenario=ScenarioConfig(
                kind="noisy_oracle", flip_prob=0.1, abstain_prob=0.25)),
            programs.BENCH_SHAPES, seed=seed), loop.CARRY_FIELDS),
        ("mesh chunk MeshConfig(4, 2) (4q)", programs.forest_program(
            "chunk", dataclasses.replace(programs.BENCH_CONFIG, mesh=MeshConfig(4, 2)),
            programs.BENCH_SHAPES, seed=seed), loop.CARRY_FIELDS),
        ("LAL round (4i)", round_step(programs.forest_program(
            "round", dataclasses.replace(unfused, rounds_per_launch=1, strategy=StrategyConfig(
                name="lal", window_size=WINDOW)), programs.BENCH_SHAPES, seed=seed)),
         loop.CARRY_FIELDS, 1, ()),
        ("CNN neural sweep, 2 lanes (4n)", programs.neural_chunk_program(
            programs.CNN_SHAPES, seed=seed, lanes=2), neural_loop.NEURAL_CARRY_FIELDS),
    )
    for name, make, fields, *where in cases:
        t0 = time.perf_counter()
        pred = memory.program_memory(*(lambda u: (u.fn, *u.args))(make(torch.device("meta"))))
        t_pred = time.perf_counter() - t0
        unit = make(dev)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            unit.fn(*unit.args)  # warm-up: kernels, library state
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        inputs = sum(memory.block_bytes(n) for n in {
            t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in memory.tensor_leaves(unit.args) if t.is_cuda}.values())
        torch.cuda.reset_peak_memory_stats()
        with torch.cuda.stream(side):
            res = unit.fn(*unit.args)
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated() - base + inputs
        del res
        traced = name in ("forest chunk step", "mesh chunk MeshConfig(4, 2) (4q)")
        if traced:  # (e) the same program traced on the card, after the measurement
            t0 = time.perf_counter()
            stats = {}
            found = auditor.audit_unit(auditor.AuditUnit.of(name, unit), stats=stats)
            t_trace = time.perf_counter() - t0
        g = graphed(unit, fields, *where)
        g.capture(*unit.args)
        pool_measured = g.pool_bytes
        captured = auditor.kernel_launches(g.launches_per_replay)
        del g, unit
        if traced:
            out["audit_on_card"][name] = {"findings": [str(f) for f in found],
                                          "traced_launches": stats["launches"],
                                          "captured_launches": captured,
                                          "trace_seconds": t_trace}
            print(f"# 4t (e) {name}: traced on the card in {t_trace:.1f} s, {len(found)} "
                  f"findings; launches traced {stats['launches']}, captured {captured}")
            if found:
                fail(f"4t (e): {name} traced on the card has findings: "
                     f"{[str(f) for f in found]}")
            if stats["launches"] != captured or not captured:
                fail(f"4t (e): {name}'s traced launches {stats['launches']} != its capture's "
                     f"{captured}")
        gc.collect()
        torch.cuda.empty_cache()
        row = {"predicted_peak_bytes": pred["peak_hbm_bytes"], "measured_peak_bytes": measured,
               "predicted_pool_bytes": pred["pool_bytes"], "measured_pool_bytes": pool_measured,
               "peak_ratio": pred["peak_hbm_bytes"] / measured,
               "pool_ratio": pred["pool_bytes"] / pool_measured if pool_measured else None,
               "predicted": pred, "pricing_seconds": t_pred}
        out["memory"][name] = row
        print(f"# 4t memory {name}: predicted peak {pred['peak_hbm_bytes'] / 2**20:.1f} MiB "
              f"(inputs {pred['argument_bytes'] / 2**20:.1f}, transient "
              f"{pred['temp_bytes'] / 2**20:.1f}, slack {pred['slack_bytes'] / 2**20:.1f}) against "
              f"max_memory_allocated {measured / 2**20:.1f} MiB (ratio {row['peak_ratio']:.3f}); "
              f"graph pool predicted {pred['pool_bytes'] / 2**20:.1f} MiB against "
              f"{pool_measured / 2**20:.1f} MiB at capture (ratio {row['pool_ratio']:.3f}); "
              f"priced in {t_pred:.1f} s ({kind}, {smi})")
        if pred["peak_hbm_bytes"] < measured or pred["pool_bytes"] < pool_measured:
            under.append(name)
        for key in ("peak_ratio", "pool_ratio"):
            if row[key] > 1.5:
                print(f"# 4t memory {name}: {key} {row[key]:.3f} above 1.5 (ROADMAP queue 3)")

    if under:
        fail(f"4t memory: the prediction is below the measurement for {under}")

    # (c) the --audit gate through the CLI.
    argv = ["--dataset", "checkerboard2x2", "--n-samples", "200000", "--fit", "device",
            "--kernel", "pallas", "--fused-round", "--trees", str(TREES), "--depth", str(DEPTH),
            "--window", str(WINDOW), "--n-start", str(N_START), "--rounds", "2", "--seed",
            str(seed)]

    def cli(extra):
        o, e = io.StringIO(), io.StringIO()
        rc = 0
        with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
            try:
                rc = run_cli.main(argv + extra)
            except SystemExit as exc:
                rc = exc.code if isinstance(exc.code, int) else 1
                print(exc.code, file=e)
        return rc, o.getvalue(), e.getvalue()

    audited = {}  # every program (c)'s --audit runs examined, for (e)

    def cli_audited(extra):
        preflight = analysis.preflight

        def recorded(specs, *a, **kw):
            audited.update((spec.name, spec) for spec in specs)
            return preflight(specs, *a, **kw)

        analysis.preflight = recorded
        try:
            return cli(extra)
        finally:
            analysis.preflight = preflight

    with tempfile.TemporaryDirectory() as tmp:
        table = os.path.join(tmp, "budget.json")
        with open(table, "w") as f:
            json.dump({"hbm_bytes": 64 * 2**20, "source": "64 MiB table"}, f)
        zero_counts()
        rc, so, se = cli_audited(["--audit", "--budget-table", table])
        refused_counts = counts()
    if rc == 0 or "hbm-over-budget" not in se or so.strip():
        fail(f"4t: --audit with a 64 MiB table did not refuse (rc {rc}): {se[-600:]}")
    if any(refused_counts.values()):
        fail(f"4t: the refused --audit run launched kernels {refused_counts}")
    over = [ln for ln in se.splitlines() if "hbm-over-budget" in ln][0]
    # The graphed chunk (K = 4): a budget above its eager peak but below its
    # resident inputs + captured pool refuses too, naming the graph's
    # footprint (both read off the 64 MiB table's finding).
    with tempfile.TemporaryDirectory() as tmp:
        table = os.path.join(tmp, "budget.json")
        with open(table, "w") as f:
            json.dump({"hbm_bytes": 64 * 2**20, "source": "64 MiB table"}, f)
        zero_counts()
        rc, _, se = cli_audited(["--rounds-per-launch", "4", "--audit", "--budget-table", table])
        found = re.search(r"eager peak ([\d.]+) MiB.*as a CUDA graph ([\d.]+) MiB", se)
        if rc == 0 or found is None:
            fail(f"4t: --audit of the K = 4 chunk with a 64 MiB table (rc {rc}) named no eager "
                 f"peak and graph footprint: {se[-600:]}")
        eager, graph = (float(v) for v in found.groups())
        if graph <= eager:
            fail(f"4t: the chunk's graph footprint {graph} MiB is not above its eager peak "
                 f"{eager} MiB: the between-budget check needs a gap")
        mid = (eager + graph) / 2
        with open(table, "w") as f:
            json.dump({"hbm_bytes": mid * 2**20, "source": "between table"}, f)
        rc, so, se = cli(["--rounds-per-launch", "4", "--audit", "--budget-table", table])
        chunk_counts = counts()
    if rc == 0 or so.strip() or "the graph's footprint" not in se:
        fail(f"4t: --audit of the K = 4 chunk with {mid:.1f} MiB (above its eager peak {eager} "
             f"MiB, below its graph {graph} MiB) did not refuse (rc {rc}): {se[-600:]}")
    if any(chunk_counts.values()):
        fail(f"4t: the refused --audit runs of the chunk launched kernels {chunk_counts}")
    print(f"# 4t audit: the K = 4 chunk with {mid:.1f} MiB (eager peak {eager} MiB, as a graph "
          f"{graph} MiB) refused, 0 launches")
    # The seed sweep (E = 8) is priced as its own batched program (8 carries,
    # 800 stacked trees, one graph pool): a budget between the one-experiment
    # chunk's graph and the sweep's refuses it, launching nothing.
    sweep_argv = ["--sweep-seeds", "8", "--rounds-per-launch", "4", "--audit", "--budget-table"]
    with tempfile.TemporaryDirectory() as tmp:
        table = os.path.join(tmp, "budget.json")
        with open(table, "w") as f:
            json.dump({"hbm_bytes": 64 * 2**20, "source": "64 MiB table"}, f)
        zero_counts()
        rc, _, se = cli_audited(sweep_argv + [table])
        found = re.search(r"as a CUDA graph ([\d.]+) MiB", se)
        if rc == 0 or found is None or "sweep/uncertainty/seeds8" not in se:
            fail(f"4t: --audit --sweep-seeds 8 with a 64 MiB table (rc {rc}) did not price the "
                 f"sweep: {se[-600:]}")
        sweep_graph = float(found.group(1))
        if sweep_graph <= graph:
            fail(f"4t: the sweep's graph footprint {sweep_graph} MiB is not above one "
                 f"experiment's {graph} MiB")
        sweep_mid = (graph + sweep_graph) / 2
        with open(table, "w") as f:
            json.dump({"hbm_bytes": sweep_mid * 2**20, "source": "between table"}, f)
        rc, so, se = cli(sweep_argv + [table])
        sweep_counts = counts()
    if rc == 0 or so.strip() or "sweep/uncertainty/seeds8" not in se or any(
            sweep_counts.values()):
        fail(f"4t: --audit --sweep-seeds 8 with {sweep_mid:.1f} MiB (above one experiment's "
             f"{graph} MiB, below the sweep's {sweep_graph} MiB) did not refuse or launched "
             f"{sweep_counts} (rc {rc}): {se[-600:]}")
    print(f"# 4t audit: --sweep-seeds 8 with {sweep_mid:.1f} MiB (one experiment's chunk {graph} "
          f"MiB as a graph, the sweep's {sweep_graph} MiB) refused, 0 launches")
    zero_counts()
    rc_a, so_a, se_a = cli_audited(["--audit"])
    audit_counts = counts()
    rc_b, so_b, _ = cli([])
    if rc_a != 0 or rc_b != 0 or so_a != so_b or "# audit clean:" not in se_a:
        fail(f"4t: --audit with the card's budget (rc {rc_a}) must print the records of the run "
             f"without it (rc {rc_b}): {se_a[-400:]}")
    out["audit"] = {"refused": over.strip(), "refused_launches": refused_counts,
                    "graph_refused": {"eager_mib": eager, "graph_mib": graph, "budget_mib": mid},
                    "sweep_refused": {"one_mib": graph, "sweep_mib": sweep_graph,
                                      "budget_mib": sweep_mid},
                    "clean": [ln for ln in se_a.splitlines() if "# audit clean" in ln][0],
                    "launches": audit_counts}
    print(f"# 4t audit: 64 MiB table refused, 0 launches: {over.strip()[:200]}")
    print(f"# 4t audit: the card's budget: {out['audit']['clean']}; records == without "
          f"--audit; launches {audit_counts}")

    # (e) every program the --audit runs examined, traced on the card.
    t_e = t0 = time.perf_counter()
    report = auditor.run_audit(list(audited.values()), device=dev)
    t_trace = time.perf_counter() - t0
    out["audit_on_card"]["cli_programs"] = {"programs": report.programs,
                                            "findings": [str(f) for f in report.findings],
                                            "launches": {k: v["launches"] for k, v in
                                                         report.stats.items()},
                                            "seconds": t_trace}
    if report.findings or len(report.programs) < 5:
        fail(f"4t (e): the --audit runs' programs traced on the card: {report.programs}, "
             f"findings {[str(f) for f in report.findings]}")
    print(f"# 4t (e) the --audit runs' {len(report.programs)} programs "
          f"({', '.join(report.programs)}) traced on the card in {t_trace:.1f} s: clean")
    # Three planted defects, each refused by its rule id before any launch.
    from distributed_active_learning_tpu_torch.parallel import collectives
    from distributed_active_learning_tpu_torch.parallel.mesh import Sharded, Spread
    from distributed_active_learning_tpu_torch.runtime import state as state_lib

    count, accuracy = state_lib.labeled_count, loop._accuracy

    def read_back(state):
        n = count(state)
        n.item()
        return n

    def pool_gather(state):
        m = state.labeled_mask
        if isinstance(m, Sharded):
            collectives.owner_gather([r[0] for r in m.blocks], Spread(1, len(m.blocks), 1))
        return count(state)

    chunk = ["--rounds-per-launch", "4"]
    planted = (("host-callback-in-fast-path", state_lib, "labeled_count", read_back, chunk),
               ("f64-aval", loop, "_accuracy",
                lambda f, x, y: accuracy(f, x, y).double().float(), chunk),
               ("collective-in-shard-map", state_lib, "labeled_count", pool_gather,
                ["--mesh-data", "4", "--mesh-model", "2"] + chunk))
    out["audit_on_card"]["planted"] = {}
    for rule, module, attr, fn, extra in planted:
        original = getattr(module, attr)
        setattr(module, attr, fn)
        try:
            zero_counts()
            rc, so, se = cli(["--audit"] + extra)
            launched = counts()
        finally:
            setattr(module, attr, original)
        rules_fired = {ln.split()[1] for ln in se.splitlines() if ln.startswith("error ")}
        if rc == 0 or so.strip() or rule not in rules_fired or any(launched.values()):
            fail(f"4t (e): --audit with a planted {rule} (rc {rc}, rules {rules_fired}, launches "
                 f"{launched}) was not refused by it: {se[-600:]}")
        out["audit_on_card"]["planted"][rule] = sorted(rules_fired)
        print(f"# 4t (e) --audit refused the planted {rule} (rules {sorted(rules_fired)}), "
              f"0 launches")
    findings = lint.lint_paths(lint.default_lint_targets())
    if findings:
        fail(f"4t (e): the lint over the port has findings: {[str(f) for f in findings]}")
    out["audit_on_card"]["lint_findings"] = 0
    print(f"# 4t (e) lint over {len(lint.default_lint_targets())} files of runtime/, serving/ "
          "and strategies/: no findings")
    out["audit_on_card"]["seconds"] = time.perf_counter() - t_e
    print(f"# 4t (e) traces, refusals and lint: {out['audit_on_card']['seconds']:.1f} s")

    # (d) shared memory: the Python mirrors against the C configuration.
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    checked = 0
    for n, d, T, depth in ((N_POOL, N_FEAT, TREES, DEPTH), (71_202, N_FEAT, TREES // 2, DEPTH),
                           (N_POOL, N_FEAT, 256, DEPTH), (64, N_FEAT, TREES, 4),
                           (64, N_FEAT, TREES, DEPTH)):
        for item, code in ((4, 0), (2, 1), (1, 2)):
            L = 1 << depth
            N, Lp = max(L, 2), -(-L // (16 // item)) * (16 // item)
            got = (ctypes.c_int * 6)()
            kernels.check("forest_leaves_config", kernels.load("forest_leaves").forest_leaves_config(
                n, d, code, T, depth, N, Lp, got))
            mine = memory.smem_for_launch("forest_leaves", n, d, T, depth, item, optin)
            if [mine["rows"], mine["trees_per_chunk"], mine["smem_bytes"]] != list(got)[:3]:
                fail(f"4t smem: K1's mirror {mine} != the C {list(got)[:3]} at {(n, d, T, depth)}")
            for name in ("round_megakernel", "fused_votes"):
                err = getattr(kernels.load(name), f"{name}_config")(n, d, code, T, depth, N, Lp,
                                                                    got)
                kernels.check(f"{name}_config", err)
                mine = memory.smem_for_launch(name, n, d, T, depth, item, optin)
                c_cfg = [("resident", "streamed")[got[0]], got[1], got[2], got[3]]
                if [mine["mode"], mine["groups"], mine["trees_per_chunk"],
                        mine["smem_bytes"]] != c_cfg:
                    fail(f"4t smem: {name}'s mirror {mine} != the C {c_cfg} at "
                         f"{(n, d, T, depth, item)}")
            checked += 3
    out["smem_checked"] = checked
    out["seconds"] = time.perf_counter() - t_phase
    print(f"# 4t shared memory: {checked} mirrors == the C configuration (opt-in {optin} bytes a "
          f"block); phase 4t {out['seconds']:.1f} s ({kind}, {smi})")
    return out



def multi_process_phase(seed: int, dev, kind: str, smi: str, run_single, want_records,
                        want_mask, neural_numbers, gf, pod_trace) -> dict:
    """Phase 4s (see the module docstring): spawns the ranks, holds their
    records against the single-process runs, returns the numbers. Fails on
    any gate. ``run_single(**cfg_changes)`` runs phase 4's fused
    configuration on one device; ``want_records`` and ``want_mask`` are
    phase 4's, which phase 4b's mesh runs equal; ``gf`` is phase 2's forest
    and ``pod_trace`` 4r (c)'s single-process pod, which (d) must equal.

    Launches a rank, gated (``steps`` round steps: 3, or 4 chunked at K = 2,
    whose last chunk runs an inactive step too). (a) ``MeshConfig(4, 2)``,
    one row of 2 cells a rank: K3 2 a step, K1 2 a step (the test set's 2
    cells), K4 3 a step (a ring of 4 members, one window a rank). (c)
    ``MeshConfig(2, 2)``, one cell a rank: fused K3 1 a step, K1 1 a step,
    K4 1 a step (``data - 1``: a column ring of 2 members); unfused K1 2 a
    step (the pool's and the test set's cell), no K3 or K4; ``MeshConfig(1,
    4)`` fused K3 1, K1 1 and no K4 a step (a column ring of one member). (d)
    the pod select: K3 2 (a rank's 2 shards), K4 7 (8 shards' windows on a
    ring of 4 members). (e) ``MeshConfig(6, 2)`` and ``(3, 4)``, 3 cells a
    rank: fused K3 3, K1 3 and K4 ``data - 1`` a step (one ring of 6 with
    repeated members, or two rings of 3); unfused K1 6."""
    from distributed_active_learning_tpu_torch.config import DataConfig
    from distributed_active_learning_tpu_torch.data.datasets import get_dataset
    from distributed_active_learning_tpu_torch.models.neural import NeuralLearner, SmallCNN
    from distributed_active_learning_tpu_torch.ops import ring_topk
    from distributed_active_learning_tpu_torch.parallel.mesh import Spread
    from distributed_active_learning_tpu_torch.runtime import neural_loop as nl

    t_phase = time.perf_counter()
    out = {"launches": {}, "seconds": {}}
    torch.cuda.empty_cache()  # the ranks share this card
    work = tempfile.mkdtemp(prefix="chip_smoke_4s_")
    try:
        # -- (a) the forest main path over 4 processes --------------------------
        ck_single = os.path.join(work, "single_ckpt")
        single = run_single(checkpoint_dir=ck_single, checkpoint_every=1)
        if [(r.round, r.n_labeled, r.accuracy) for r in single.records] != want_records:
            fail("4s: the checkpointing single-device run differs from phase 4's")
        job = os.path.join(work, "forest")
        os.makedirs(job)
        torch.save({f.name: getattr(gf, f.name).cpu() for f in dataclasses.fields(gf)},
                   os.path.join(job, "pod_forest.pt"))
        t0 = time.perf_counter()
        ranks = spawn_ranks("forest", MP_FOREST_RANKS, job, seed)
        out["seconds"]["ranks"] = time.perf_counter() - t0
        chunk_steps = 2 * -(-ROUNDS // 2)

        def per_step(k1, k3, k4):
            return {"forest_leaves": k1, "round_megakernel": 0, "fused_votes": k3,
                    "ring_hop": k4, "threefry": 0}

        steps = {"procs4_fused": (ROUNDS, per_step(2, 2, 3)),
                 "procs4_chunked": (chunk_steps, per_step(2, 2, 3)),
                 "procs4_model_fused": (ROUNDS, per_step(1, 1, 1)),
                 "procs4_model_unfused": (ROUNDS, per_step(2, 0, 0)),
                 "procs4_row_fused": (ROUNDS, per_step(1, 1, 0)),
                 "procs4_model_chunked": (chunk_steps, per_step(1, 1, 1))}
        # (e): 3 cells a rank, so K3 3 and the test set's K1 3 a step
        # (unfused K1 6), and K4 one a step of its rings (length data).
        for tag, (d_, m_) in MP_CROSSING.items():
            steps[f"procs4_{tag}_fused"] = (ROUNDS, per_step(3, 3, d_ - 1))
            steps[f"procs4_{tag}_unfused"] = (ROUNDS, per_step(6, 0, 0))
            steps[f"procs4_{tag}_chunked"] = (chunk_steps, per_step(3, 3, d_ - 1))
        ring_shapes = {"ring": (MP_FOREST_RANKS, 2), "column_ring": (2, 2),
                       **{f"{t}_ring": dm for t, dm in MP_CROSSING.items()}}
        for r, g in enumerate(ranks):
            if g["device"] != "cuda:0":
                fail(f"4s rank {r} ran on {g['device']}, not cuda:0")
            for path, (n_steps, each) in steps.items():
                p = g[path]
                if [tuple(x) for x in p["records"]] != want_records:
                    fail(f"4s {path} rank {r} records {p['records']} != phases 4/4b's "
                         f"{want_records}")
                if p["mask_sha"] != sha(want_mask) or p["mask_count"] != int(want_mask.sum()):
                    fail(f"4s {path} rank {r}: final mask != phases 4/4b's")
                want_l = {k_: v * n_steps for k_, v in each.items()}
                if p["launches"] != want_l:
                    fail(f"4s {path} rank {r} launched {p['launches']}, want {want_l}")
            for path in ("procs4_chunked", "procs4_model_chunked", "procs4_cross62_chunked",
                         "procs4_cross34_chunked"):
                if g[path]["graph"]["mode"] != "eager":
                    fail(f"4s rank {r}: the chunk over processes ran {g[path]['graph']}")
            for tag in RING_TAGS:
                rings = Spread(MP_FOREST_RANKS, *ring_shapes[tag], r).rings
                received = (len(rings[0]) - 1) * len(ring_topk.remote_slots(rings, r))
                if (not g[f"{tag}_equal"] or g[f"{tag}_members"] != [list(x) for x in rings]
                        or g[f"{tag}_windows"] != received):
                    fail(f"4s rank {r}: K4's IPC windows != the gloo hop's on the {tag} "
                         f"{g[f'{tag}_members']} ({g[f'{tag}_windows']} windows, max abs err "
                         f"{g[f'{tag}_max_abs_err']})")
            if g["pod"]["trace"] != pod_trace:
                diff = [k_ for k_ in pod_trace if g["pod"]["trace"].get(k_) != pod_trace[k_]]
                fail(f"4s (d) rank {r}: the pod over processes != 4r (c)'s single-process pod "
                     f"({diff} differ)")
        want_files = [f"alstate_{i}.npz" for i in range(1, ROUNDS + 1)]
        for ck in ("ckpt", "ckpt_model"):
            files = sorted(os.listdir(os.path.join(job, ck)))
            if files != want_files or sorted(os.listdir(ck_single)) != want_files:
                fail(f"4s {ck} {files}, single-device {sorted(os.listdir(ck_single))}; "
                     f"want {want_files} from rank 0 alone")
            for f in files:
                za, zb = np.load(os.path.join(job, ck, f)), np.load(os.path.join(ck_single, f))
                if sorted(za.files) != sorted(zb.files):
                    fail(f"4s {ck} {f} fields {za.files} != {zb.files}")
                for key in za.files:
                    if key == "records_json":
                        ra, rb = (json.loads(bytes(z[key]).decode()) for z in (za, zb))
                        ra, rb = ([{k_: v for k_, v in x.items() if not k_.endswith("_time")}
                                   for x in rs] for rs in (ra, rb))
                        same = ra == rb
                    else:
                        same = np.array_equal(za[key], zb[key])
                    if not same:
                        fail(f"4s {ck} {f}: {key} != the single-device run's")
        out["launches"]["procs4_pod_select"] = {
            k_: sum(g["pod"]["select_launches"][k_] for g in ranks)
            for k_ in ranks[0]["pod"]["select_launches"]}
        for path in steps:
            out["launches"][path] = {k_: sum(g[path]["launches"][k_] for g in ranks)
                                     for k_ in ranks[0][path]["launches"]}
        r0 = ranks[0]
        out["forest"] = {
            "per_rank_launches": {p: [g[p]["launches"] for g in ranks] for p in steps},
            "split_seconds": {p: [g[p]["split"] for g in ranks] for p in steps},
            "wall": {p: [g[p]["wall"] for g in ranks] for p in steps},
            "ring_ipc_step_ms": [g["ring_ipc_step_ms"] for g in ranks],
            "ring_gloo_step_ms": [g["ring_gloo_step_ms"] for g in ranks],
            "ring_max_abs_err": max(g["ring_max_abs_err"] for g in ranks),
            "column_ring_ipc_step_ms": [g["column_ring_ipc_step_ms"] for g in ranks],
            "column_ring_gloo_step_ms": [g["column_ring_gloo_step_ms"] for g in ranks],
            "column_ring_max_abs_err": max(g["column_ring_max_abs_err"] for g in ranks),
            **{f"{t}_ring_{k_}": [g[f"{t}_ring_{k_}"] for g in ranks]
               for t in MP_CROSSING for k_ in ("ipc_step_ms", "gloo_step_ms", "max_abs_err")},
            "chunk_mode": r0["procs4_chunked"]["graph"]}
        out["pod"] = {k_: [g["pod"][k_] for g in ranks]
                      for k_ in ("epoch_ms", "epochs", "ingest_points_per_second", "select_ms",
                                 "seconds")}
        for i, (fit_s, round_s, eval_s) in enumerate(r0["procs4_fused"]["split"]):
            print(f"#   4s (a) round {i + 1} on rank 0: fit {fit_s:.4f}s round {round_s:.4f}s "
                  f"eval {eval_s:.4f}s (single device: fit {single.records[i].train_time:.4f}s "
                  f"round {single.records[i].score_time:.4f}s eval "
                  f"{single.records[i].eval_time:.4f}s)")
        print(f"# phase 4s (a) {MP_FOREST_RANKS} processes on cuda:0, MeshConfig(4, 2), fused: "
              f"every rank == phases 4 and 4b (records, final {N_POOL}-row mask), {ROUNDS} "
              f"checkpoints from rank 0 == the single-device run's, per rank K3 "
              f"{2 * ROUNDS} K4 {3 * ROUNDS} K1 {2 * ROUNDS}; chunked K = 2 eager == too; "
              f"K4 through CUDA IPC == the gloo hop ({MP_FOREST_RANKS - 1} windows a rank, max "
              f"abs err {out['forest']['ring_max_abs_err']}); a ring step "
              f"{statistics.median(out['forest']['ring_ipc_step_ms']):.4f} ms by IPC, "
              f"{statistics.median(out['forest']['ring_gloo_step_ms']):.4f} ms by gloo (median "
              f"of the ranks); walls {[round(w, 2) for w in out['forest']['wall']['procs4_fused']]}"
              f" s ({kind}, {smi})")
        for path in ("procs4_model_fused", "procs4_model_unfused", "procs4_row_fused"):
            for r, g in enumerate(ranks):
                print(f"#   4s (c) {path} rank {r}: fit / round / eval s a round "
                      + ", ".join(f"{a:.4f} / {b:.4f} / {c:.4f}" for a, b, c in g[path]["split"]))
        print(f"# phase 4s (c) {MP_FOREST_RANKS} processes on cuda:0, one cell a rank: "
              f"MeshConfig(2, 2) fused, unfused and chunked (K = 2, eager) and MeshConfig(1, 4) "
              f"fused == phases 4 and 4b on every rank, {ROUNDS} checkpoints from rank 0 == the "
              f"single-device run's; per rank a round K3 1, K4 1 (2, 2) / 0 (1, 4), K1 1 fused, "
              f"2 unfused; K4 in each column ring through CUDA IPC == the gloo hop (max abs err "
              f"{out['forest']['column_ring_max_abs_err']}); a column-ring step "
              f"{statistics.median(out['forest']['column_ring_ipc_step_ms']):.4f} ms by IPC, "
              f"{statistics.median(out['forest']['column_ring_gloo_step_ms']):.4f} ms by gloo; "
              f"walls (2, 2) fused {[round(w, 2) for w in out['forest']['wall']['procs4_model_fused']]}"
              f" s ({kind}, {smi})")
        for tag, (d_, m_) in MP_CROSSING.items():
            for r, g in enumerate(ranks):
                for mode in ("fused", "unfused", "chunked"):
                    p = g[f"procs4_{tag}_{mode}"]
                    each = {k_: v // steps[f"procs4_{tag}_{mode}"][0]
                            for k_, v in p["launches"].items()
                            if k_ in ("forest_leaves", "fused_votes", "ring_hop")}
                    split = ("not split" if mode == "chunked" else "fit / round / eval s a "
                             "round " + ", ".join(f"{a:.4f} / {b:.4f} / {c:.4f}"
                                                  for a, b, c in p["split"]))
                    print(f"#   4s (e) MeshConfig({d_}, {m_}) {mode} rank {r}: {split}; a "
                          f"round step K1 {each['forest_leaves']} K3 {each['fused_votes']} "
                          f"K4 {each['ring_hop']}; wall {p['wall']:.2f} s")
                print(f"#   4s (e) MeshConfig({d_}, {m_}) rank {r}: a ring step "
                      f"{g[f'{tag}_ring_ipc_step_ms']:.4f} ms by IPC, "
                      f"{g[f'{tag}_ring_gloo_step_ms']:.4f} ms by gloo "
                      f"(rings {g[f'{tag}_ring_members']}, {g[f'{tag}_ring_windows']} windows "
                      f"received)")
        print(f"# phase 4s (e) {MP_FOREST_RANKS} processes on cuda:0, cells crossing a row: "
              f"MeshConfig(6, 2) and (3, 4), 3 cells a rank, fused, unfused and chunked (K = 2, "
              f"eager) == phases 4 and 4b on every rank (records, final mask); K4 through CUDA "
              f"IPC on rings with repeated members == the gloo hop (max abs err "
              f"{max(max(out['forest'][f'{t}_ring_max_abs_err']) for t in MP_CROSSING)}) "
              f"({kind}, {smi})")
        print(f"# phase 4s (d) the pod over {MP_FOREST_RANKS} processes, MeshConfig({POD_SHARDS}, "
              f"1), 2 rows a rank: fills, maps, rows and picks == 4r (c)'s on every rank; "
              f"ingest {[round(v, 1) for v in out['pod']['ingest_points_per_second']]} points/s, "
              f"epoch median {[round(statistics.median(v), 3) for v in out['pod']['epoch_ms']]} "
              f"ms ({out['pod']['epochs'][0]} epochs), select "
              f"{[round(v, 3) for v in out['pod']['select_ms']]} ms (K3 2, K4 7 a rank) "
              f"({kind}, {smi})")

        # -- (b) the neural leg over 2 processes ---------------------------------
        t0 = time.perf_counter()
        bc = get_dataset(DataConfig(name="cifar10", n_samples=NEURAL_CIFAR, seed=seed), device=dev)
        cnn = NeuralLearner(SmallCNN(n_classes=10, dropout_rate=0.25), (32, 32, 3),
                            train_steps=200, batch_size=64, mc_samples=8, device=dev)
        cfg = nl.NeuralExperimentConfig(strategy="entropy", window_size=100, n_start=100,
                                        max_rounds=MP_NEURAL_ROUNDS, seed=seed)
        ref = nl.run_neural_experiment(cfg, cnn, bc.train_x, bc.train_y, bc.test_x, bc.test_y)
        ref_recs = [[r.round, r.n_labeled, r.n_unlabeled, r.accuracy] for r in ref.records]
        four_n = [list(x) for x in neural_numbers["cnn"]["entropy"]["records"][:MP_NEURAL_ROUNDS]]
        if ref_recs != four_n:
            fail(f"4s (b): the single-process {MP_NEURAL_ROUNDS}-round run {ref_recs} != 4n's "
                 f"first records {four_n}")
        del bc, cnn
        torch.cuda.empty_cache()
        job = os.path.join(work, "neural")
        os.makedirs(job)
        ranks_n = spawn_ranks("neural", MP_NEURAL_RANKS, job, seed)
        out["seconds"]["b"] = time.perf_counter() - t0
        for r, g in enumerate(ranks_n):
            p = g["procs2_neural"]
            if p["records"] != ref_recs or p["mask_sha"] != sha(ref.final_labeled_mask):
                fail(f"4s (b) rank {r}: records {p['records']} or mask != the single-process "
                     f"run's {ref_recs}")
            if p["launches"]["threefry"] == 0 or any(
                    v for k_, v in p["launches"].items() if k_ != "threefry"):
                fail(f"4s (b) rank {r} launches {p['launches']}: K7 only, and at least once")
        out["launches"]["procs2_neural"] = {
            k_: sum(g["procs2_neural"]["launches"][k_] for g in ranks_n)
            for k_ in ranks_n[0]["procs2_neural"]["launches"]}
        out["neural"] = {
            "per_rank_threefry": [g["procs2_neural"]["launches"]["threefry"] for g in ranks_n],
            "seconds_per_round": [g["procs2_neural"]["seconds_per_round"] for g in ranks_n],
            "single_seconds_per_round": [r.total_time for r in ref.records],
            "wall": [g["procs2_neural"]["wall"] for g in ranks_n]}
        print(f"# phase 4s (b) {MP_NEURAL_RANKS} processes on cuda:0, CNN entropy "
              f"MeshConfig(data=2), {MP_NEURAL_ROUNDS} rounds: every rank == 4n's first records "
              f"== the single-process run (records, final mask); K7 a rank "
              f"{out['neural']['per_rank_threefry']}; s/round {out['neural']['seconds_per_round']}"
              f" (single process {out['neural']['single_seconds_per_round']}) ({kind}, {smi})")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["seconds"]["total"] = time.perf_counter() - t_phase
    print(f"# phase 4s: {out['seconds']['total']:.1f}s ((a), (c), (d) "
          f"{out['seconds']['ranks']:.1f}, (b) {out['seconds']['b']:.1f})")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank-job", choices=("forest", "neural"), default=None,
                    help="run one rank of phase 4s (spawned by phase 4s itself)")
    ap.add_argument("--job-dir", default=None, help="the rank job's working directory")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card", file=sys.stderr)
        return 2
    # Phase 4n's gates compare bits: cuBLAS's fixed per-stream workspace must
    # be set before the process's first product (device.deterministic_cuda).
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.rank_job:
        return rank_job(args)
    from distributed_active_learning_tpu_torch import bench, kernels, prng
    from distributed_active_learning_tpu_torch.analysis import roofline as roofline_lib
    from distributed_active_learning_tpu_torch.benches import pallas_variants as lv
    from distributed_active_learning_tpu_torch.config import (
        DataConfig, ExperimentConfig, ForestConfig, MeshConfig, StrategyConfig,
    )
    from distributed_active_learning_tpu_torch.data.datasets import DataBundle, get_dataset
    from distributed_active_learning_tpu_torch.device import resolve_device
    from distributed_active_learning_tpu_torch.models import forest as forest_lib
    from distributed_active_learning_tpu_torch.models import forest_io
    from distributed_active_learning_tpu_torch.ops import (
        forest_eval, ring_topk, round_fused, similarity, trees_pallas, trees_train,
    )
    from distributed_active_learning_tpu_torch.ops import trees as trees_lib
    from distributed_active_learning_tpu_torch.ops.topk import merge_tile_topk, stable_top_k
    from distributed_active_learning_tpu_torch.parallel import mesh as mesh_lib
    from distributed_active_learning_tpu_torch.runtime import loop
    from distributed_active_learning_tpu_torch.runtime import state as state_lib
    from distributed_active_learning_tpu_torch.strategies import StrategyAux, get_strategy
    from distributed_active_learning_tpu_torch.runtime.debugger import Debugger

    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    t_all = time.perf_counter()

    # -- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    kernels.build_all(verbose=True)
    print(f"# build: {time.perf_counter() - t0:.1f}s (nvcc, sm_90a)")
    for name, log in kernels.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"# ptxas {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"# card: {kind} | nvidia-smi: {smi}")

    def counts():
        return {"forest_leaves": trees_pallas.launches, "round_megakernel": round_fused.launches,
                "fused_votes": round_fused.votes_launches, "ring_hop": ring_topk.launches}

    def zero_counts():
        trees_pallas.launches = round_fused.launches = 0
        round_fused.votes_launches = ring_topk.launches = 0

    # -- phase 2: the leaf kernel against its plain version ----------------
    rng = np.random.default_rng(args.seed)
    pool_np = rng.normal(size=(N_POOL, N_FEAT)).astype(np.float32)
    train_np = rng.normal(size=(N_START, N_FEAT)).astype(np.float32)
    test_np = rng.normal(size=(N_TEST, N_FEAT)).astype(np.float32)
    pool = torch.from_numpy(pool_np).to(dev)
    train_x = torch.from_numpy(train_np).to(dev)
    train_y = torch.from_numpy(labels(train_np)).to(dev)

    def fit(n_trees: int):
        binned = trees_train.make_bins(train_x, BINS)
        f, th, v = trees_train.fit_forest_device(
            binned.codes, train_y, torch.ones(N_START, device=dev), binned.edges,
            prng.key(args.seed + 1), n_trees=n_trees, max_depth=DEPTH, n_bins=BINS,
        )
        return trees_train.heap_gemm_forest(f, th, v, DEPTH)

    gf = fit(TREES)
    gf13 = fit(13)
    test_x = torch.from_numpy(test_np).to(dev)
    n_shard = -(-N_POOL // 4)  # one data shard of the 4 x 2 mesh (284,808 / 4)
    gf_shard = mesh_lib.shard_forest(gf, mesh_lib.make_mesh(1, 2, devices=[dev, dev]))[0][0]
    k1_err = 0.0

    def check_k1(g, x, label):
        nonlocal k1_err
        got = trees_pallas.predict_leaves_pallas(g, x)
        ref = trees_pallas.predict_leaves_plain(g, x)
        walked = trees_pallas.walk_leaves_plain(trees_pallas.heap_operands(g), x)
        torch.cuda.synchronize()
        for name, want_ in (("plain", ref), ("walk_leaves_plain", walked)):
            if got.shape != want_.shape or not torch.equal(got, want_):
                bad = (got != want_).sum().item() if got.shape == want_.shape else "shape"
                fail(f"forest_leaves != {name} at {label} {tuple(x.shape)}: {bad} entries differ")
        k1_err = max(k1_err, float((got - ref).abs().max()))

    for label, (g, x) in {"full": (gf, pool), "test": (gf, test_x),
                          "mesh shard": (gf_shard, pool[:n_shard]),
                          "ragged": (gf13, pool[:1700])}.items():
        check_k1(g, x, label)
        print(f"# forest_leaves {label} n={x.shape[0]} T={g.n_trees}: bit-equal to plain and to "
              "walk_leaves_plain")
    sweep = {}  # depth -> (16-tree forest, edge rows), for K1, K2 and K3
    for depth_ in range(1, DEPTH + 1):
        binned = trees_train.make_bins(train_x, BINS)
        f, th, v = trees_train.fit_forest_device(
            binned.codes, train_y, torch.ones(N_START, device=dev), binned.edges,
            prng.key(args.seed + depth_), n_trees=16, max_depth=depth_, n_bins=BINS)
        g = trees_train.heap_gemm_forest(f, th, v, depth_)
        sweep[depth_] = (g, edge_rows(g, rng, 4099).to(dev))
        check_k1(*sweep[depth_], f"depth {depth_}")
    print(f"# forest_leaves depths 1-{DEPTH} (16 trees, 4,099 rows with NaN, +-inf and features "
          "on node thresholds): bit-equal to plain and to walk_leaves_plain")
    swapped = dataclasses.replace(gf13, path=gf13.path[:, :, [1, 0, *range(2, 2 ** DEPTH)]])
    before = trees_pallas.launches
    try:
        trees_pallas.predict_leaves_pallas(swapped, pool[:10])
        fail("forest_leaves took a path matrix that is not a heap")
    except ValueError as e:
        if "host fit" not in str(e) or trees_pallas.launches != before:
            fail(f"a non-heap path matrix was not refused by name: {e}")
    print("# forest_leaves: a non-heap path matrix is refused (ValueError), no launch")
    k1_cfg = trees_pallas.leaves_launch_config(trees_pallas.heap_operands(gf), N_POOL, N_FEAT, dev)
    print(f"# forest_leaves launch at full width: {k1_cfg}")

    # -- phase 2b: K3 against both plain versions ---------------------------
    gf256 = fit(256)  # 270,336 bytes of packed heap form: the streamed mode
    # 60,000 depth-1 trees, drawn at random: more trees than a [T + 1] score
    # table beside the tile would leave room for, so K2 must read it where
    # it lies.
    gen = torch.Generator(device=dev).manual_seed(args.seed + 60_000)
    gf60k = trees_train.heap_gemm_forest(
        torch.randint(0, N_FEAT, (60_000, 1), generator=gen, device=dev, dtype=torch.int32),
        torch.randn(60_000, 1, generator=gen, device=dev),
        torch.rand(60_000, 3, generator=gen, device=dev), 1)
    vote_shapes = {"full": (gf, pool), "shard": (gf_shard, pool[:n_shard]),
                   "ragged": (gf13, pool[:1700]),
                   **{f"depth {d_} edge rows": sweep[d_] for d_ in sweep},
                   "streamed 256 trees": (gf256, pool),
                   "streamed 60,000 depth-1 trees": (gf60k, pool[:1025])}
    walked_votes = {}
    for label, (g, x) in vote_shapes.items():
        h = trees_pallas.heap_operands(g)
        got = round_fused.fused_votes(g, x)
        walked_votes[label] = round_fused.walk_votes_plain(h, x)
        ref = round_fused.fused_votes_plain(g, x)
        torch.cuda.synchronize()
        for name, want_ in (("plain", ref), ("walk_votes_plain", walked_votes[label])):
            if got.dtype != torch.int32 or not torch.equal(got, want_):
                fail(f"fused_votes != {name} at {label} n={x.shape[0]} T={g.n_trees}")
        cfg_ = round_fused.launch_config("fused_votes", h, *x.shape, dev)
        if (cfg_["mode"] == "streamed") != label.startswith("streamed"):
            fail(f"fused_votes at {label} launches in {cfg_['mode']} mode")
        print(f"# fused_votes {label} n={x.shape[0]} T={g.n_trees}: bit-equal to plain and to "
              f"walk_votes_plain; launch {cfg_}")
    k3_err = 0.0  # integer votes, compared for equality above

    # -- phase 2c: K5 and K6 against their plain versions -------------------
    k1_leaves = trees_pallas.predict_leaves_pallas(gf, pool)
    k5_err = 0.0
    for leaf_f32 in (False, True):
        want = lv.predict_leaves_transposed_plain(gf, pool, leaf_f32=leaf_f32)
        for tree_outer in (False, True):
            for bn, bt in ((512, 16), (2048, 8)):
                got = lv.predict_leaves_transposed(
                    gf, pool, bn=bn, bt=bt, tree_outer=tree_outer, leaf_f32=leaf_f32)
                torch.cuda.synchronize()
                if got.shape != want.shape or not torch.equal(got, want):
                    fail(f"forest_leaves_transposed != plain (leaf_f32={leaf_f32}, "
                         f"tree_outer={tree_outer}, bn={bn}, bt={bt})")
                k5_err = max(k5_err, float((got - want).abs().max()))
                if leaf_f32 and not torch.equal(got, k1_leaves):
                    fail("forest_leaves_transposed with the f32 payload != forest_leaves")
        del want
    for stage in lv.ABLATE[1:]:
        got = lv.predict_leaves_transposed(gf, pool, bn=4096, bt=8, ablate=stage)
        want = lv.predict_leaves_transposed_plain(gf, pool, ablate=stage)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"forest_leaves_transposed != plain at ablation stage {stage}")
    print("# forest_leaves_transposed full width: bit-equal to plain for hi + lo and f32 "
          "payloads, tree_outer on and off, (bn, bt) = (512, 16) and (2048, 8), and the "
          "stages sel, cmp, main, eq; the f32 payload == forest_leaves")
    k6_err = 0.0
    for bn, bt in ((2048, 8), (1024, 8)):
        got = lv.predict_leaves_segmented(gf, pool, bn=bn, bt=bt)
        want = lv.predict_leaves_segmented_plain(gf, pool, bn=bn, bt=bt)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"forest_leaves_segmented != plain (bn={bn}, bt={bt})")
        k6_err = max(k6_err, float((got - want).abs().max()))
    seg_S = lv._segmented_operands(gf, pool, 2048, 8).S
    print(f"# forest_leaves_segmented full width (S = {seg_S} slots a feature): bit-equal to "
          "plain at (bn, bt) = (2048, 8) and (1024, 8)")
    del got, want, k1_leaves

    def bits_equal(a, b):
        return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))

    def check_k5_k6(g, x, label, k5_tilings, k6_tilings):
        for bn, bt, tree_outer in k5_tilings:
            for leaf_f32 in (False, True):
                got = lv.predict_leaves_transposed(g, x, bn=bn, bt=bt, tree_outer=tree_outer,
                                                   leaf_f32=leaf_f32)
                if not bits_equal(got, lv.predict_leaves_transposed_plain(g, x, leaf_f32)):
                    fail(f"forest_leaves_transposed != plain at {label} (bn={bn}, bt={bt}, "
                         f"tree_outer={tree_outer}, leaf_f32={leaf_f32})")
            for stage in lv.ABLATE[1:]:
                got = lv.predict_leaves_transposed(g, x, bn=bn, bt=bt, ablate=stage)
                if not bits_equal(got, lv.predict_leaves_transposed_plain(g, x, ablate=stage)):
                    fail(f"forest_leaves_transposed != plain at {label}, stage {stage}")
        for bn, bt in k6_tilings:
            got = lv.predict_leaves_segmented(g, x, bn=bn, bt=bt)
            if not bits_equal(got, lv.predict_leaves_segmented_plain(g, x, bn=bn, bt=bt)):
                fail(f"forest_leaves_segmented != plain at {label} (bn={bn}, bt={bt})")
        torch.cuda.synchronize()

    # The walks of the kernels' own arithmetic at full width, then depths
    # 1-8 on edge rows (16 trees, 4,099 rows: ragged against every tile), the
    # ragged 13-tree shape, and -inf/NaN thresholds against -inf rows.
    p5 = lv._prep_transposed(gf, pool, 2048, 8)
    if not bits_equal(lv._launch_transposed(p5, 2048, 8), lv.walk_transposed_plain(p5).T):
        fail("forest_leaves_transposed != walk_transposed_plain at full width")
    p6 = lv._segmented_operands(gf, pool, 2048, 8)
    if not bits_equal(lv._launch_segmented(p6, 2048, 8), lv.walk_segmented_plain(p6).T):
        fail("forest_leaves_segmented != walk_segmented_plain at full width")
    del p5, p6
    for depth_, (g, x) in sweep.items():
        check_k5_k6(g, x, f"depth {depth_} edge rows", [(2048, 8, False), (512, 16, True)],
                    [(2048, 8)])
    check_k5_k6(gf13, pool[:1700], "13 trees x 1,700 rows", [(512, 8, False)], [(1024, 8)])
    g8, x8 = sweep[DEPTH]
    thr_odd = g8.thresholds.clone()
    thr_odd[:, 1::5], thr_odd[:, 3::7] = float("-inf"), float("nan")
    g_odd = dataclasses.replace(g8, thresholds=thr_odd)
    x_odd = x8.clone()
    rows = torch.arange(3, x_odd.shape[0], 2, device=dev)
    x_odd[rows, g8.feat_ids[rows % g8.n_trees, 1 + 5 * (rows % 50)].long()] = float("-inf")
    check_k5_k6(g_odd, x_odd, "-inf/NaN thresholds, -inf rows", [(2048, 8, False)], [(2048, 8)])
    if torch.equal(lv.predict_leaves_segmented(g_odd, x_odd),
                   lv.predict_leaves_transposed(g_odd, x_odd)):
        fail("K6 sent -inf rows left at -inf thresholds (no node was dropped)")
    before = (lv.transposed_launches, lv.segmented_launches)
    for fn in (lv.predict_leaves_transposed, lv.predict_leaves_segmented):
        try:
            fn(swapped, pool[:10])
            fail(f"{fn.__name__} took a path matrix that is not a heap")
        except ValueError as e:
            if "host fit" not in str(e):
                fail(f"{fn.__name__}: a non-heap path matrix was not refused by name: {e}")
    if (lv.transposed_launches, lv.segmented_launches) != before:
        fail("a non-heap forest launched K5 or K6")
    print(f"# forest_leaves_transposed / _segmented: bit-equal to walk_*_plain at full width; "
          f"to plain at depths 1-{DEPTH} on edge rows ((2048, 8) and (512, 16) tree_outer for "
          "K5, both payloads, every stage; (2048, 8) for K6), at 13 trees x 1,700 rows, and "
          "with -inf/NaN thresholds against -inf rows (K6 != K5 there, as its slots drop "
          "those nodes); a non-heap path matrix is refused by both, no launch")

    # -- phase 2d: host-fit-shaped forests through K1 -----------------------
    t_phase = time.perf_counter()
    # The card's machine has no scikit-learn: the forest is made with numpy
    # in the shapes a host fit packs into (depth-first node ids, leaves at
    # depths 1-8, single-leaf trees) and reaches the card as a forest file.
    host_packed = forest_lib.synthetic_forest(
        np.random.default_rng(args.seed + 2), TREES, DEPTH, N_FEAT, single_leaf_every=9)
    forest_file = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                               "chip_smoke_host_forest.npz")
    forest_io.save_forest(forest_file, host_packed, meta=f"synthetic, seed {args.seed + 2}")
    host_loaded, meta = forest_io.load_forest(forest_file, device=dev)
    if meta != f"synthetic, seed {args.seed + 2}" or not all(
            torch.equal(getattr(host_loaded, f).cpu(), getattr(host_packed, f))
            for f in ("feature", "threshold", "left", "right", "value")):
        fail("the forest file did not round-trip")
    host_pf = forest_eval.for_kernel(host_loaded, "pallas")
    if host_pf.prepacked is None or host_pf.heap.depth != DEPTH:
        fail("for_kernel(..., 'pallas') did not pack the host-fit forest into heaps")
    leaf = host_packed.feature == -1
    reached = set()
    for t in range(TREES):  # the depth of every reachable leaf
        todo = [(0, 0)]
        while todo:
            v, dd = todo.pop()
            if leaf[t, v]:
                reached.add(dd)
            else:
                todo += [(int(host_packed.left[t, v]), dd + 1), (int(host_packed.right[t, v]), dd + 1)]
    x_2d = torch.cat([pool, edge_rows(host_pf.gf, rng, 4099).to(dev)])
    before = trees_pallas.launches
    got = trees_pallas.predict_leaves_pallas(host_pf, x_2d)
    if trees_pallas.launches != before + 1:
        fail("K1 did not launch on the host-fit forest")
    for name, want_ in (("predict_leaves_plain (depth-first path matrix)",
                         trees_pallas.predict_leaves_plain(host_pf.gf, x_2d)),
                        ("walk_leaves_plain", trees_pallas.walk_leaves_plain(host_pf.heap, x_2d))):
        torch.cuda.synchronize()
        if not torch.equal(got, want_):
            fail(f"forest_leaves on the host-fit heaps != {name}: "
                 f"{(got != want_).sum().item()} entries differ")
        k1_err = max(k1_err, float((got - want_).abs().max()))
    x_bf16 = pool.to(torch.bfloat16).float()
    if not torch.equal(trees_pallas.predict_leaves_pallas(host_pf, x_bf16),
                       trees_lib.predict_leaves(host_loaded, x_bf16)):
        fail("forest_leaves on the host-fit heaps != the gather form on bf16-exact rows")
    host_cfg = trees_pallas.leaves_launch_config(host_pf.heap, *x_2d.shape, dev)
    print(f"# forest_leaves on a host-fit-shaped forest ({TREES} trees, max_depth {DEPTH}, leaves "
          f"at depths {sorted(reached)}, {int(leaf[:, 0].sum())} single-leaf trees; through "
          f"save_forest/load_forest and for_kernel(..., 'pallas')) at {x_2d.shape[0]} rows "
          "(the pool and 4,099 edge rows): bit-equal to predict_leaves_plain on the depth-first "
          "path matrix and to walk_leaves_plain on the packed heaps; on the bf16-exact pool "
          f"equal to the gather form; launch {host_cfg}")
    del got, want_, x_2d, x_bf16
    print(f"# phase 2d: {time.perf_counter() - t_phase:.1f}s")

    # -- phase 3: the megakernel against its plain version -----------------
    labeled = torch.zeros(N_POOL, dtype=torch.bool)
    labeled[torch.from_numpy(rng.choice(N_POOL, size=N_START, replace=False))] = True
    selectable = (~labeled).to(dev)
    heap = trees_pallas.heap_operands(gf)
    k2_err = 0.0

    def check_k2(g, x, sel, strategy, label):
        nonlocal k2_err
        h = trees_pallas.heap_operands(g)
        table = round_fused.score_table(g.n_trees, strategy, dev)
        tv, ti = round_fused._launch_megakernel(h, x, sel, table, WINDOW)
        pv, pi = round_fused.megakernel_plain(g, x, sel, table, WINDOW)
        wv, wi = round_fused.tile_topk_plain(walked_votes[label], sel, table, WINDOW)
        torch.cuda.synchronize()
        for name, (rv, ri) in (("plain", (pv, pi)), ("walk_votes_plain", (wv, wi))):
            if not (torch.equal(tv, rv) and torch.equal(ti, ri)):
                fail(f"round_megakernel != {name} per-tile candidates for {strategy} at {label}")
        mv, mi = merge_tile_topk(tv, ti, WINDOW)
        rv, ri = merge_tile_topk(pv, pi, WINDOW)
        if not (torch.equal(mv, rv) and torch.equal(mi, ri)) or not torch.isfinite(mv).all():
            fail(f"round_megakernel merged picks differ or are not finite for {strategy} at {label}")
        finite = torch.isfinite(pv)
        k2_err = max(k2_err, float(torch.where(finite, tv - pv, 0.0).abs().max()))

    for strategy in ("uncertainty", "entropy", "full_entropy", "margin"):
        check_k2(gf, pool, selectable, strategy, "full")
        print(f"# round_megakernel full {strategy}: per-tile (vals, idx) bit-equal to plain and "
              "to walk_votes_plain")
    for label, (g, x) in vote_shapes.items():
        if label == "full":
            continue
        check_k2(g, x, selectable[:x.shape[0]], "uncertainty", label)
        cfg_ = round_fused.launch_config("round_megakernel", trees_pallas.heap_operands(g),
                                         *x.shape, dev)
        if (cfg_["mode"] == "streamed") != label.startswith("streamed"):
            fail(f"round_megakernel at {label} launches in {cfg_['mode']} mode")
        print(f"# round_megakernel {label} n={x.shape[0]} T={g.n_trees} uncertainty: bit-equal "
              f"to plain and to walk_votes_plain; launch {cfg_}")
    k2_cfg = round_fused.launch_config("round_megakernel", heap, N_POOL, N_FEAT, dev)
    k3_cfg = round_fused.launch_config("fused_votes", trees_pallas.heap_operands(gf_shard),
                                       n_shard, N_FEAT, dev)
    print(f"# round_megakernel launch at full width: {k2_cfg}; fused_votes at a mesh shard: "
          f"{k3_cfg}")
    before = (round_fused.launches, round_fused.votes_launches)
    for name, call in (
            ("round_megakernel", lambda: round_fused.fused_score_select(
                trees_pallas.PallasForest(gf=swapped), pool[:10], selectable[:10], "uncertainty",
                5)),
            ("fused_votes", lambda: round_fused.fused_votes(
                trees_pallas.PallasForest(gf=swapped), pool[:10]))):
        try:
            call()
            fail(f"{name} took a path matrix that is not a heap")
        except ValueError as e:
            if "host fit" not in str(e) or (round_fused.launches,
                                             round_fused.votes_launches) != before:
                fail(f"a non-heap path matrix was not refused by name by {name}: {e}")
    print("# round_megakernel, fused_votes: a non-heap path matrix is refused (ValueError), "
          "no launch")
    del walked_votes, gf60k, vote_shapes

    # -- phase 3c: K1, K2 and K3 on quantized payloads ------------------------
    t_phase = time.perf_counter()
    PAYLOADS = ("int8", "bf16")

    def fit_q(n_trees: int, mode: str, depth_: int = DEPTH, seed_off: int = 1):
        """A device fit on bf16-snapped bin edges: the forest with f32 storage
        and with ``mode``'s storage (bf16 thresholds, narrow leaves)."""
        binned = trees_train.make_bins(train_x, BINS, quantize=mode)
        f, th, v = trees_train.fit_forest_device(
            binned.codes, train_y, torch.ones(N_START, device=dev), binned.edges,
            prng.key(args.seed + seed_off), n_trees=n_trees, max_depth=depth_, n_bins=BINS)
        wide = trees_train.heap_gemm_forest(f, th, v, depth_)
        return wide, trees_train.quantize_forest(wide, mode)

    qf = {}  # payload -> its forests: the pool's, a mesh shard's, the streamed one
    payload_err = {m: dict(forest_leaves=0.0, round_megakernel=0.0, fused_votes=0.0)
                   for m in PAYLOADS}
    half_leaves = int((gf.value == 0.5).sum())
    for mode in PAYLOADS:
        wide, g = fit_q(TREES, mode)
        g_shard = mesh_lib.shard_forest(g, mesh_lib.make_mesh(1, 2, devices=[dev, dev]))[0][0]
        g256 = fit_q(256, mode)[1]
        qf[mode] = {"pool": g, "shard": g_shard, "streamed": g256, "wide": wide}
        h = trees_pallas.heap_operands(g)
        if h.val.dtype != {"int8": torch.int8, "bf16": torch.bfloat16}[mode]:
            fail(f"{mode} heap payload is {h.val.dtype}")
        shapes = {"full": (g, pool), "test": (g, test_x), "mesh shard": (g_shard, pool[:n_shard])}
        for d_ in (1, 2, 3, 8):
            g_d = fit_q(16, mode, d_, d_)[1]
            shapes[f"depth {d_} edge rows"] = (g_d, edge_rows(g_d, rng, 4099).to(dev))
        shapes["streamed 256 trees"] = (g256, pool)
        for label, (g_, x) in shapes.items():
            h_ = trees_pallas.heap_operands(g_)
            if label != "streamed 256 trees":
                got = trees_pallas.predict_leaves_pallas(g_, x)
                ref = trees_pallas.predict_leaves_plain(g_, x)
                walked = trees_pallas.walk_leaves_plain(h_, x)
                torch.cuda.synchronize()
                if not (torch.equal(got, ref) and torch.equal(got, walked)):
                    fail(f"forest_leaves on the {mode} payload != plain at {label}")
                payload_err[mode]["forest_leaves"] = max(
                    payload_err[mode]["forest_leaves"], float((got - ref).abs().max()))
                del got, ref, walked
            if label == "test":
                continue
            votes = round_fused.fused_votes(g_, x)
            walked_v = round_fused.walk_votes_plain(h_, x)
            if not (torch.equal(votes, round_fused.fused_votes_plain(g_, x))
                    and torch.equal(votes, walked_v)):
                fail(f"fused_votes on the {mode} payload != plain at {label}")
            sel = selectable[:x.shape[0]]
            table = round_fused.score_table(g_.n_trees, "uncertainty", dev)
            tv, ti = round_fused._launch_megakernel(h_, x, sel, table, WINDOW)
            pv, pi = round_fused.megakernel_plain(g_, x, sel, table, WINDOW)
            wv, wi = round_fused.tile_topk_plain(walked_v, sel, table, WINDOW)
            torch.cuda.synchronize()
            if not (torch.equal(tv, pv) and torch.equal(ti, pi) and torch.equal(tv, wv)
                    and torch.equal(ti, wi)):
                fail(f"round_megakernel on the {mode} payload != plain at {label}")
            finite = torch.isfinite(pv)
            payload_err[mode]["round_megakernel"] = max(
                payload_err[mode]["round_megakernel"],
                float(torch.where(finite, tv - pv, 0.0).abs().max()))
            modes = {name: round_fused.launch_config(name, h_, *x.shape, dev)["mode"]
                     for name in ("fused_votes", "round_megakernel")}
            if any((m_ == "streamed") != label.startswith("streamed") for m_ in modes.values()):
                fail(f"{mode} payload at {label}: launch modes {modes}")
        # The payload changes votes only where a leaf's stored value falls on
        # the other side of 0.5: int8 stores 0.5 as 64, and 64 / 127 > 0.5.
        moved = int((round_fused.fused_votes(g, pool) != round_fused.fused_votes(wide, pool)).sum())
        print(f"# {mode} payload (thresholds bf16, leaves {h.val.dtype}, {h.val.shape[1]} a tree): "
              "K1 (full, test, mesh shard, depths 1/2/3/8 on edge rows), K3 and K2 (full, shard, "
              "depths, streamed 256 trees) bit-equal to their plain versions and walks; rows "
              f"whose votes move against f32 storage of the same fit: {moved} of {N_POOL}")
    print(f"# leaves at exactly 0.5 in the f32 bench forest: {half_leaves} "
          f"(int8 stores them as 64 / 127 > 0.5)")
    print(f"# phase 3c: {time.perf_counter() - t_phase:.1f}s")

    # -- phase 3b: K4 and the ring -----------------------------------------
    def ring_windows(devs, scores, sel):
        n_local = scores.shape[0] // len(devs)
        out = []
        for s_, d_ in enumerate(devs):
            blk = slice(s_ * n_local, (s_ + 1) * n_local)
            work = torch.where(sel[blk], scores[blk], float("-inf"))
            v, i = stable_top_k(work, min(WINDOW, n_local))
            out.append(ring_topk.pad_window(v.to(d_), (i + s_ * n_local).to(torch.int32).to(d_),
                                            WINDOW))
        return out

    def check_ring(devs, label):
        # Hard-vote scores tie everywhere: 101 levels over 4 x 71,202 rows.
        g = torch.Generator().manual_seed(args.seed)
        scores = torch.randint(0, TREES + 1, (4 * n_shard,), generator=g).float() / TREES
        sel = torch.rand(4 * n_shard, generator=g) < 0.9
        windows = ring_windows(devs, scores, sel)
        for s_, (v, i) in enumerate(windows):
            right = devs[(s_ + 1) % len(devs)]
            hv, hi = ring_topk.hop(v, i, right)
            pv, pi = ring_topk.hop_plain(v, i, right)
            torch.cuda.synchronize()
            if not (torch.equal(hv, pv) and torch.equal(hi, pi)):
                fail(f"ring_hop != plain copy ({label}, shard {s_})")
        # One ring step: each shard's window into a buffer on its right
        # neighbour, one launch per sending card.
        def buffers():
            return [(torch.full((WINDOW,), float("nan"), device=devs[(s_ + 1) % len(devs)]),
                     torch.full((WINDOW,), -1, dtype=torch.int32,
                                device=devs[(s_ + 1) % len(devs)])) for s_ in range(len(devs))]
        got_, ref_ = buffers(), buffers()
        before = ring_topk.launches
        for d_ in dict.fromkeys(devs):
            shards = [s_ for s_ in range(len(devs)) if devs[s_] == d_]
            ring_topk.ring_step([windows[s_] for s_ in shards], [got_[s_] for s_ in shards])
        step_launches = ring_topk.launches - before
        ring_topk.ring_step_plain(windows, ref_)
        torch.cuda.synchronize()
        if step_launches != len(set(devs)):
            fail(f"a ring step launched {step_launches} times over {len(set(devs))} sending cards")
        for s_, ((gv, gi), (rv, ri)) in enumerate(zip(got_, ref_)):
            if not (torch.equal(gv, rv) and torch.equal(gi, ri)):
                fail(f"ring_step != plain copy ({label}, shard {s_})")
        want_v, want_i = stable_top_k(torch.where(sel, scores, float("-inf")), WINDOW)
        for s_, (v, i) in enumerate(ring_topk.ring_topk(windows, WINDOW)):
            if not (torch.equal(v.cpu(), want_v) and torch.equal(i.cpu().long(), want_i)):
                fail(f"ring_topk != global stable top-k ({label}, shard {s_})")
        print(f"# ring_hop {label}: every hop and a ring step ({step_launches} launch(es)) "
              f"bit-equal to the plain copies; ring_topk (k={WINDOW}) == global stable top-k on "
              "every shard")
        return windows

    ring_dev = [dev] * 4
    hop_windows = check_ring(ring_dev, "4 shards on one card")
    k4_err = 0.0  # copies, compared for equality above
    if torch.cuda.device_count() >= 2:
        two = [torch.device("cuda", 0), torch.device("cuda", 1)] * 2
        mesh_lib.make_mesh(4, 1, devices=two)  # enables peer access on the ring
        check_ring(two, "4 shards on two cards (peer stores)")
        peer_run = True
    else:
        print("# ring_hop across two cards: NOT RUN (one card visible); the peer path "
              "is unverified here")
        peer_run = False

    # -- phase 4: the main path ------------------------------------------
    bundle = DataBundle(
        train_x=pool_np, train_y=labels(pool_np), test_x=test_np, test_y=labels(test_np),
        name="bench_pool",
    )

    def cfg(fused: bool, mesh=(1, 1), **kw) -> ExperimentConfig:
        return dataclasses.replace(_cfg(fused, mesh), **kw)

    def _cfg(fused: bool, mesh=(1, 1)) -> ExperimentConfig:
        return ExperimentConfig(
            forest=ForestConfig(n_trees=TREES, max_depth=DEPTH, max_bins=BINS,
                                fit="device", kernel="pallas"),
            strategy=StrategyConfig(name="uncertainty", window_size=WINDOW),
            mesh=MeshConfig(*mesh),
            n_start=N_START, max_rounds=ROUNDS, fused_round=fused, seed=args.seed,
        )

    # Each path's launches are counted from 0 over its own run. Single
    # device: the fused round launches K2 to score and K1 for test accuracy,
    # the unfused round K1 for both. Mesh 4 x 2: the fused round launches K3
    # on each of the 8 shards, one K4 per ring step (3 steps, every sender
    # on the one card) and K1 per shard for accuracy;
    # the unfused round K1 per shard to score and again for accuracy.
    want_launches = {
        "fused": {"forest_leaves": ROUNDS, "round_megakernel": ROUNDS,
                  "fused_votes": 0, "ring_hop": 0},
        "unfused": {"forest_leaves": 2 * ROUNDS, "round_megakernel": 0,
                    "fused_votes": 0, "ring_hop": 0},
        "mesh_fused": {"forest_leaves": 8 * ROUNDS, "round_megakernel": 0,
                       "fused_votes": 8 * ROUNDS, "ring_hop": 3 * ROUNDS},
        "mesh_unfused": {"forest_leaves": 16 * ROUNDS, "round_megakernel": 0,
                         "fused_votes": 0, "ring_hop": 0},
    }
    launches = {}
    runs = {}

    def drive(path: str, fused: bool, mesh=(1, 1), devices=None, data=None, **kw):
        dbg = Debugger(enabled=False)
        zero_counts()
        t0 = time.perf_counter()
        res = loop.run_experiment(cfg(fused, mesh, **kw), bundle=data or bundle, debugger=dbg,
                                  device=dev, devices=devices)
        wall = time.perf_counter() - t0
        launches[path] = counts()
        runs[path] = res
        print(f"# main path {path}: {wall:.2f}s wall, launches {launches[path]}")
        if launches[path] != want_launches[path]:
            fail(f"main path {path} launched {launches[path]}, want {want_launches[path]}")
        for r in res.records:
            print(f"#   round {r.round}: n_labeled={r.n_labeled} accuracy={r.accuracy:.6f} "
                  f"fit={r.train_time:.4f}s round={r.score_time:.4f}s eval={r.eval_time:.4f}s")

    for fused in (True, False):
        drive("fused" if fused else "unfused", fused)
    recs = {f: [(r.round, r.n_labeled, r.accuracy) for r in runs["fused" if f else "unfused"].records]
            for f in (True, False)}
    if recs[True] != recs[False]:
        fail(f"fused and unfused records differ: {recs[True]} vs {recs[False]}")
    want = [N_START + i * WINDOW for i in range(ROUNDS)]
    if [r[1] for r in recs[True]] != want:
        fail(f"n_labeled {[r[1] for r in recs[True]]} != {want}")
    if not all(np.isfinite(r[2]) and 0.0 <= r[2] <= 1.0 for r in recs[True]):
        fail("accuracy records are not finite fractions")
    masks = {f: runs["fused" if f else "unfused"].final_labeled_mask for f in (True, False)}
    n_final = N_START + ROUNDS * WINDOW
    if not torch.equal(masks[True], masks[False]) or int(masks[True].sum()) != n_final:
        fail(f"fused and unfused final labeled masks differ or do not hold {n_final} rows")
    print(f"# main path: fused == unfused (records and final mask, "
          f"{int(masks[True].sum())} labeled)")

    small = ExperimentConfig(
        data=DataConfig(name="checkerboard2x2", n_samples=300, seed=1),
        forest=ForestConfig(n_trees=8, max_depth=4, fit="device", kernel="pallas"),
        strategy=StrategyConfig(name="uncertainty", window_size=15),
        n_start=10, max_rounds=3, fused_round=True,
    )
    on_card = loop.run_experiment(small, device=dev).to_reference_log()
    on_cpu = loop.run_experiment(small, device="cpu").to_reference_log()
    if on_card != on_cpu:
        fail(f"small run on the card != plain CPU run:\n{on_card}\n{on_cpu}")
    print("# small checkerboard run: card == CPU plain versions")

    # -- phase 4b: the mesh path -------------------------------------------
    one_card = [dev] * 8
    for fused in (True, False):
        path = "mesh_fused" if fused else "mesh_unfused"
        drive(path, fused, mesh=(4, 2), devices=one_card)
        got = [(r.round, r.n_labeled, r.accuracy) for r in runs[path].records]
        if got != recs[True]:
            fail(f"{path} records differ from the single-device run: {got} vs {recs[True]}")
        if not torch.equal(runs[path].final_labeled_mask, masks[True]):
            fail(f"{path} final labeled mask differs from the single-device run")
    print("# mesh 4 x 2 on one card: fused and unfused == single device (records and final "
          f"{N_POOL}-row mask)")
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        # The same mesh spread over the visible cards, shard (s, m) on card
        # (s + m) mod n: ring hops and model-shard sums cross cards.
        spread = [torch.device("cuda", (s_ + m) % n_cards) for s_ in range(4) for m in range(2)]
        for fused in (True, False):
            path = "mesh_cards_fused" if fused else "mesh_cards_unfused"
            want_launches[path] = dict(want_launches["mesh_fused" if fused else "mesh_unfused"])
            if fused:  # one K4 per sending card and ring step (model column 0 sends)
                want_launches[path]["ring_hop"] = 3 * len({spread[2 * s_] for s_ in range(4)}) * ROUNDS
            drive(path, fused, mesh=(4, 2), devices=spread)
            got = [(r.round, r.n_labeled, r.accuracy) for r in runs[path].records]
            if got != recs[True] or not torch.equal(
                    runs[path].final_labeled_mask.to(dev), masks[True]):
                fail(f"{path} differs from the single-device run")
        print(f"# mesh 4 x 2 across {n_cards} cards: fused and unfused == single device")
    else:
        print("# mesh 4 x 2 across cards: NOT RUN (one card visible)")
    small_mesh = dataclasses.replace(small, mesh=MeshConfig(4, 2), fused_round=True)
    for fused in (True, False):
        c = dataclasses.replace(small_mesh, fused_round=fused)
        on_card = loop.run_experiment(c, device=dev, devices=one_card).to_reference_log()
        on_cpu = loop.run_experiment(c, device="cpu").to_reference_log()
        if on_card != on_cpu:
            fail(f"small mesh run (fused={fused}) on the card != CPU mesh:\n{on_card}\n{on_cpu}")
    print("# small checkerboard mesh run 4 x 2: card == CPU plain versions, fused and unfused")

    # -- phase 4c: the chunked driver ---------------------------------------
    K, CHUNK_ROUNDS = 4, 6
    n_chunks = -(-CHUNK_ROUNDS // K)
    for fused in (True, False):
        name = "fused" if fused else "unfused"
        per_kernel = 1 if fused else 2  # K1 launches a round; K2 launches once when fused
        ref_path = f"per_round_{name}_{CHUNK_ROUNDS}"
        want_launches[ref_path] = {
            "forest_leaves": per_kernel * CHUNK_ROUNDS,
            "round_megakernel": CHUNK_ROUNDS if fused else 0, "fused_votes": 0, "ring_hop": 0}
        drive(ref_path, fused, max_rounds=CHUNK_ROUNDS)
        ref = runs[ref_path]
        ref_recs = [(r.round, r.n_labeled, r.accuracy) for r in ref.records]
        for depth in (1, 2):
            path = f"chunked_{name}_depth{depth}"
            # One eager warm-up round, then K rounds per replay (a replay is
            # counted as the launches its capture recorded).
            rounds_run = 1 + n_chunks * K
            want_launches[path] = {
                "forest_leaves": per_kernel * rounds_run,
                "round_megakernel": rounds_run if fused else 0, "fused_votes": 0, "ring_hop": 0}
            drive(path, fused, max_rounds=CHUNK_ROUNDS, rounds_per_launch=K, pipeline_depth=depth)
            res = runs[path]
            got = [(r.round, r.n_labeled, r.accuracy) for r in res.records]
            if got != ref_recs:
                fail(f"{path} records differ from the per-round run: {got} vs {ref_recs}")
            if not torch.equal(res.final_labeled_mask, ref.final_labeled_mask):
                fail(f"{path} final labeled mask differs from the per-round run")
            g = res.graph_stats
            if g is None or g["captures"] != 1 or g["replays"] != n_chunks:
                fail(f"{path}: graph captures/replays {g}, want 1 capture and {n_chunks} replays")
            st = res.pipeline_stats
            print(f"#   {path}: graph captures {g['captures']}, replays {g['replays']}, private "
                  f"pool {g['pool_bytes'] / 2**20:.0f} MiB, launches per replay "
                  f"{g['launches_per_replay']}; chunks {st.chunks}, vetoed {st.vetoed}, "
                  f"touchdown hidden {st.touchdown_hidden_fraction:.3f}")
    print(f"# chunked driver (K = {K}, max_rounds = {CHUNK_ROUNDS}): fused and unfused, depth 1 "
          f"and 2 == per-round (records and final {N_POOL}-row mask); each chunk a graph replay")

    # The chunk body, eagerly, with host syncs turned into errors.
    st0 = state_lib.set_start_state(
        state_lib.init_pool_state(bundle.train_x, bundle.train_y, prng.key(args.seed), dev),
        N_START)
    binned0 = trees_train.make_bins(st0.x, BINS)
    tx_dev = torch.from_numpy(test_np).to(dev)
    ty_dev = torch.from_numpy(labels(test_np)).to(dev)
    deep_forest = ForestConfig(n_trees=TREES, max_depth=DEEP, max_bins=BINS, fit="device",
                               kernel="gather")
    density = StrategyConfig(name="density", window_size=WINDOW)
    for c in (cfg(True), cfg(False), cfg(False, forest=deep_forest),
              cfg(False, strategy=density), cfg(False, collect_metrics=True)):
        fused = c.fused_round
        body = loop.make_chunk_fn(
            get_strategy(c.strategy), WINDOW, 2,
            loop.make_device_fit(c, binned0.edges, N_START + 4 * WINDOW), N_POOL, fused_round=fused,
            with_metrics=c.collect_metrics)
        body_args = (binned0.codes, state_lib.as_carry(st0),
                     StrategyAux(seed_mask=st0.labeled_mask.clone()), prng.key(7, dev),
                     tx_dev, ty_dev, torch.as_tensor(99, dtype=torch.int32).to(dev))
        body(*body_args)  # constants cached, kernels loaded
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, extras, _ = body(*body_args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if int(extras.n_active) != 2:
            fail("the eager chunk body did not run two active rounds")
    del st0, binned0, tx_dev, ty_dev, body_args
    print("# chunk body, eager, torch.cuda.set_sync_debug_mode('error'): no host sync, fused, "
          f"unfused, the depth-{DEEP} gather form, density and unfused with RoundMetrics")

    # Seconds per round, steady state: rounds 5-12 of a 12-round run (chunks 2
    # and 3 of 3; the first chunk holds the warm-up round and the capture).
    TIMED = 12
    chunk_times = {}
    for fused in (True, False):
        name = "fused" if fused else "unfused"
        for label, kw in (("per_round", {}),
                          ("chunked_depth1", dict(rounds_per_launch=K, pipeline_depth=1)),
                          ("chunked_depth2", dict(rounds_per_launch=K, pipeline_depth=2))):
            t0 = time.perf_counter()
            res = loop.run_experiment(cfg(fused, max_rounds=TIMED, **kw), bundle=bundle, device=dev)
            wall = time.perf_counter() - t0
            steady = [r.total_time for r in res.records[K:]]
            chunk_times[f"{name}_{label}"] = sum(steady) / len(steady)
            print(f"# seconds per round, {name} {label}: {chunk_times[f'{name}_{label}']:.5f} "
                  f"(rounds {K + 1}-{TIMED}; whole run {wall:.2f}s incl. set-up; {kind}, {smi})")

    # -- phase 4d: the deep gather path --------------------------------------
    t_phase = time.perf_counter()
    # Depth 12 is past the path-matrix limit (10): the device fit emits the
    # gather form and no kernel of the port runs on this path. The fit window
    # is the label cap, N_START + ROUNDS * WINDOW rows, in both drivers.
    zero = {"forest_leaves": 0, "round_megakernel": 0, "fused_votes": 0, "ring_hop": 0}
    want_launches["gather_deep"] = dict(zero)
    drive("gather_deep", False, forest=deep_forest)
    # One eager warm-up round, then one replay of a K-round chunk.
    want_launches["gather_deep_chunked"] = dict(zero)
    drive("gather_deep_chunked", False, forest=deep_forest, rounds_per_launch=K)

    def check_chunked(path, ref_path):
        got = [(r.round, r.n_labeled, r.accuracy) for r in runs[path].records]
        want_ = [(r.round, r.n_labeled, r.accuracy) for r in runs[ref_path].records]
        if got != want_ or [r[1] for r in got] != [N_START + i * WINDOW for i in range(ROUNDS)]:
            fail(f"{path} records differ from the per-round run: {got} vs {want_}")
        if not torch.equal(runs[path].final_labeled_mask, runs[ref_path].final_labeled_mask):
            fail(f"{path} final labeled mask differs from the per-round run")
        g = runs[path].graph_stats
        if g is None or g["captures"] != 1 or g["replays"] != 1:
            fail(f"{path}: graph captures/replays {g}, want 1 and 1")
        print(f"#   {path}: == per-round (records and final mask); graph private pool "
              f"{g['pool_bytes'] / 2**20:.0f} MiB, launches per replay {g['launches_per_replay']}")

    check_chunked("gather_deep_chunked", "gather_deep")
    window_rows = loop._resolve_fit_budget(cfg(False, forest=deep_forest), N_POOL, N_START)
    small_deep = dataclasses.replace(
        small, fused_round=False,
        forest=dataclasses.replace(small.forest, kernel="gather", max_depth=DEEP))
    for c in (small_deep, dataclasses.replace(small_deep, rounds_per_launch=2)):
        on_card = loop.run_experiment(c, device=dev)
        on_cpu = loop.run_experiment(c, device="cpu")
        if on_card.to_reference_log() != on_cpu.to_reference_log() or not torch.equal(
                on_card.final_labeled_mask.cpu(), on_cpu.final_labeled_mask):
            fail(f"small depth-{DEEP} gather run (rounds_per_launch "
                 f"{c.rounds_per_launch}) on the card != CPU")
    print(f"# deep gather path (depth {DEEP}, kernel 'gather', fit window {window_rows} rows): "
          f"chunked (K = {K}) == per-round; small checkerboard runs, per round and chunked: "
          "card == CPU")
    print(f"# phase 4d: {time.perf_counter() - t_phase:.1f}s")

    # -- phase 4e: density ----------------------------------------------------
    t_phase = time.perf_counter()
    # K1 scores (votes) and evaluates: twice a round; chunked, one eager
    # warm-up round and one replay of K rounds.
    want_launches["density"] = dict(zero, forest_leaves=2 * ROUNDS)
    drive("density", False, strategy=density)
    want_launches["density_chunked"] = dict(zero, forest_leaves=2 * (1 + K))
    drive("density_chunked", False, strategy=density, rounds_per_launch=K)
    check_chunked("density_chunked", "density")
    small_dens = dataclasses.replace(small, fused_round=False,
                                     strategy=StrategyConfig(name="density", window_size=15))
    for c in (small_dens, dataclasses.replace(small_dens, rounds_per_launch=2)):
        on_card = loop.run_experiment(c, device=dev)
        on_cpu = loop.run_experiment(c, device="cpu")
        if on_card.to_reference_log() != on_cpu.to_reference_log() or not torch.equal(
                on_card.final_labeled_mask.cpu(), on_cpu.final_labeled_mask):
            fail(f"small density run (rounds_per_launch {c.rounds_per_launch}) on the card != CPU")
    small_x = torch.from_numpy(np.ascontiguousarray(
        get_dataset(small.data).train_x, dtype=np.float32))
    mass_err = {}
    for label, (x_, mask_) in {"small pool": (small_x, torch.arange(small_x.shape[0]) % 3 > 0),
                               "bench pool": (pool, selectable)}.items():
        on_card = similarity.similarity_mass(x_.to(dev), mask_.to(dev)).cpu()
        on_cpu = similarity.similarity_mass(x_.cpu(), mask_.cpu())
        scale = float(on_cpu.abs().max())
        mass_err[label] = float((on_card - on_cpu).abs().max()) / scale
        if not mass_err[label] <= similarity.MASS_RTOL:
            fail(f"similarity_mass at the {label}: card - CPU reaches {mass_err[label]:.3g} of "
                 f"the largest |mass|, over MASS_RTOL = {similarity.MASS_RTOL}")
    print(f"# density: chunked (K = {K}) == per-round at the bench width; small checkerboard runs, "
          "per round and chunked: card == CPU (picks, records, final mask); similarity_mass card "
          f"vs CPU, largest difference over the largest |mass|: {mass_err} (MASS_RTOL "
          f"{similarity.MASS_RTOL})")
    print(f"# phase 4e: {time.perf_counter() - t_phase:.1f}s")

    # -- phase 4f: telemetry and checkpoints ----------------------------------
    t_phase = time.perf_counter()
    from distributed_active_learning_tpu_torch.runtime import checkpoint as ckpt_lib
    from distributed_active_learning_tpu_torch.runtime import obs, telemetry

    work = tempfile.mkdtemp(prefix="chip_smoke_4f_")
    # Every run of this phase fits the same window (the 12-round label cap),
    # so that a run stopped and resumed fits what the uninterrupted run fits.
    budget = N_START + TIMED * WINDOW
    tel_forest = dataclasses.replace(cfg(False).forest, fit_budget=budget)

    def tel_cfg(**kw):
        return cfg(False, forest=tel_forest, rounds_per_launch=K, pipeline_depth=2, **kw)

    def run_4f(path, c, metrics=None):
        zero_counts()
        t0 = time.perf_counter()
        res = loop.run_experiment(c, bundle=bundle, device=dev, metrics=metrics)
        wall = time.perf_counter() - t0
        launches[path] = counts()
        runs[path] = res
        print(f"# telemetry {path}: {wall:.2f}s wall, launches {launches[path]}")
        return res

    def rec4(res):
        return [(r.round, r.n_labeled, r.n_unlabeled, r.accuracy) for r in res.records]

    def ckpt_mask(d, step):
        with np.load(os.path.join(d, f"alstate_{step}.npz")) as z:
            return torch.from_numpy(z["labeled_mask"].copy()), z["key"].copy(), int(z["round"])

    # The metrics-on run: a MetricsWriter, the flight recorder, the ops
    # plane on an ephemeral port, a checkpoint every 4 rounds (at each chunk
    # boundary), 12 rounds of K = 4 at depth 2.
    jsonl = os.path.join(work, "metrics.jsonl")
    recorder = telemetry.install_flight_recorder(os.path.join(work, "flight.json"), signals=False)
    ops = obs.OpsServer(port=0).start()
    ck_full = os.path.join(work, "ck_full")
    writer = telemetry.MetricsWriter(jsonl)
    on = run_4f("metrics_chunked", tel_cfg(max_rounds=TIMED, checkpoint_dir=ck_full,
                                           checkpoint_every=K), metrics=writer)
    writer.close()
    # The eager warm-up round, then K rounds a replay: K1 scores and
    # evaluates the pool once a round (metrics reuse the scoring pass's
    # leaves) and evaluates the test draw once.
    n_replays = TIMED // K
    k1_per_round = launches["metrics_chunked"]["forest_leaves"] / (1 + n_replays * K)
    want_launches["metrics_chunked"] = dict(zero, forest_leaves=2 * (1 + n_replays * K))
    if launches["metrics_chunked"] != want_launches["metrics_chunked"]:
        fail(f"the metrics-on chunked run launched {launches['metrics_chunked']}, want "
             f"{want_launches['metrics_chunked']}")
    g = on.graph_stats
    if g is None or g["captures"] != 1 or g["replays"] != n_replays:
        fail(f"metrics-on chunked run: graph {g}, want 1 capture and {n_replays} replays")
    scrape = {}
    for route in ("metrics", "healthz"):
        with urllib.request.urlopen(f"http://127.0.0.1:{ops.port}/{route}", timeout=10) as r:
            scrape[route] = (r.status, r.read().decode())
    ops.stop()
    prom = scrape["metrics"][1]
    if scrape["metrics"][0] != 200 or "dal_launches_total" not in prom or \
            "dal_recompiles_after_warmup_total 0" not in prom.splitlines():
        fail(f"/metrics: {scrape['metrics'][0]}, launches or zero recompiles missing")
    if scrape["healthz"][0] != 200 or not json.loads(scrape["healthz"][1])["ok"]:
        fail(f"/healthz: {scrape['healthz']}")
    flight = json.load(open(recorder.dump("chip_smoke")))
    telemetry.uninstall_flight_recorder()
    if not {"dispatch", "touchdown", "launch"} <= {e["kind"] for e in flight["events"]}:
        fail("the flight recorder holds no dispatch/touchdown/launch events")
    events = [json.loads(line) for line in open(jsonl)]
    kinds = [e["kind"] for e in events]
    if kinds.count("round") != TIMED or kinds.count("launch") != n_replays or kinds[0] != "meta":
        fail(f"metrics JSONL: {kinds.count('round')} round and {kinds.count('launch')} launch "
             f"events, first {kinds[0]!r}; want {TIMED}, {n_replays} and 'meta'")
    for r in on.records:
        m = r.metrics
        floats = [v for k, v in m.items() if k != "picked_hist"]
        if not all(np.isfinite(floats)) or sum(m["picked_hist"]) != WINDOW:
            fail(f"round {r.round} metrics not finite or picked_hist does not sum to {WINDOW}: {m}")
        if round(m["labeled_frac"] * N_POOL) != r.n_labeled:
            fail(f"round {r.round}: labeled_frac {m['labeled_frac']} x {N_POOL} != {r.n_labeled}")
    # The same run without metrics picks exactly the same.
    off = run_4f("metrics_off_chunked", tel_cfg(max_rounds=TIMED))
    if rec4(off) != rec4(on) or not torch.equal(off.final_labeled_mask, on.final_labeled_mask):
        fail("metrics changed a pick: the metrics-on run's records or final mask differ")
    # The per-round driver with metrics: the same metrics, K1 twice a round.
    per_round_m = run_4f("metrics_per_round", cfg(False, forest=tel_forest, max_rounds=K,
                                                  collect_metrics=True))
    if launches["metrics_per_round"]["forest_leaves"] != 2 * K:
        fail(f"the per-round metrics run launched K1 {launches['metrics_per_round']} times")
    if [r.metrics for r in per_round_m.records] != [r.metrics for r in on.records[:K]]:
        fail("the graphed chunk's RoundMetrics differ from the per-round driver's")
    # Stop at 4 rounds, resume to 8: chunked, and per round from the chunk's
    # checkpoint. Both equal the uninterrupted run (records, and the mask of
    # its round-8 checkpoint).
    ck_stop = os.path.join(work, "ck_stop")
    run_4f("stopped_at_4", tel_cfg(max_rounds=K, checkpoint_dir=ck_stop, checkpoint_every=K))
    m4, key4, r4 = ckpt_mask(ck_stop, K)
    fm4, fkey4, fr4 = ckpt_mask(ck_full, K)
    if not (torch.equal(m4, fm4) and np.array_equal(key4, fkey4) and r4 == fr4 == K):
        fail("the stopped run's round-4 checkpoint differs from the uninterrupted run's")
    ck_round = os.path.join(work, "ck_per_round")
    os.makedirs(ck_round)
    shutil.copy(os.path.join(ck_stop, f"alstate_{K}.npz"), ck_round)
    mask8 = ckpt_mask(ck_full, 2 * K)[0]
    for path, c in (("resumed_chunked", tel_cfg(max_rounds=K, checkpoint_dir=ck_stop,
                                                checkpoint_every=K)),
                    ("resumed_per_round", cfg(False, forest=tel_forest, max_rounds=K,
                                              checkpoint_dir=ck_round, checkpoint_every=K))):
        res = run_4f(path, c)
        if rec4(res) != rec4(on)[:2 * K]:
            fail(f"{path}: records differ from the uninterrupted run: {rec4(res)}")
        if not torch.equal(res.final_labeled_mask.cpu(), mask8):
            fail(f"{path}: final mask differs from the uninterrupted run's round-{2 * K} mask")
    # Seconds per round, rounds 5-12 (as phase 4c): metrics on against off.
    tel_times = {name: sum(r.total_time for r in res.records[K:]) / (TIMED - K)
                 for name, res in (("metrics_on", on), ("metrics_off", off))}
    # round_stream as each round finishes: the metrics-on run again with the
    # flag on picks the same and launches the same; every chunk's events are
    # written before its touchdown, the first one a measured round-time or
    # more before it.
    sw = timed_writer(os.path.join(work, "stream.jsonl"))
    streamed = run_4f("metrics_streamed", tel_cfg(max_rounds=TIMED, stream_round_events=True),
                      metrics=sw)
    sw.close()
    if rec4(streamed) != rec4(on) or not torch.equal(streamed.final_labeled_mask,
                                                     on.final_labeled_mask):
        fail("round_stream changed a pick: the streamed run's records or final mask differ")
    if launches["metrics_streamed"] != launches["metrics_chunked"]:
        fail(f"the streamed run launched {launches['metrics_streamed']}, the same run without "
             f"the flag {launches['metrics_chunked']}")
    stream_lead = stream_leads("4f", sw, streamed, K, tel_times["metrics_on"])
    tel_times["metrics_streamed"] = sum(r.total_time for r in streamed.records[K:]) / (TIMED - K)
    print(f"# round_stream (K = {K}, depth 2, {TIMED} rounds): every event before its chunk's "
          f"touchdown, the first of each chunk {', '.join(f'{v:.4f}' for v in stream_lead)}s "
          f"before it (a round: {tel_times['metrics_on']:.5f}s); launches and records == the "
          f"flag-off run; s/round streamed {tel_times['metrics_streamed']:.5f} vs off "
          f"{tel_times['metrics_on']:.5f} ({kind}, {smi})")
    # The dispatch-time snapshot (device time, CUDA events) and a save (host).
    st0_4f = state_lib.set_start_state(
        state_lib.init_pool_state(bundle.train_x, bundle.train_y, prng.key(args.seed), dev),
        N_START)
    st_bench = state_lib.as_carry(st0_4f)
    snap_ms = cuda_ms(lambda: loop.ckpt_snapshot(st_bench.labeled_mask, st_bench.key,
                                                 st_bench.round), reps=9)
    save_times = []
    for i in range(5):
        t0 = time.perf_counter()
        ckpt_lib.save(os.path.join(work, "ck_time"), st0_4f.replace(round=100 + i), on,
                      fingerprint=ckpt_lib.config_fingerprint(tel_cfg()),
                      kernel=ckpt_lib.kernel_ident(tel_cfg()))
        save_times.append(1e3 * (time.perf_counter() - t0))
    save_ms = statistics.median(save_times)
    # The metrics epilogue alone at the pool, graph-replayed (device time),
    # on leaves already computed (as in the round): all of it, the pool
    # entropy's share (the tree mean, the entropy and the sum, native), and
    # for comparison what the epilogue used before: forest_eval.proba (the
    # trees added in XLA's order) through the XLA-spelled
    # scoring.full_entropy, without the sum.
    from distributed_active_learning_tpu_torch.ops import scoring
    from distributed_active_learning_tpu_torch.ops.topk import select_bottom_k

    ev = forest_eval.evaluated(trees_pallas.PallasForest(gf=gf), st0_4f.x)
    ev_scores = scoring.uncertainty_score(
        scoring.VoteFraction(forest_eval.votes(ev, st0_4f.x).to(torch.float32), TREES))
    ev_vals, ev_picked = select_bottom_k(ev_scores, st0_4f.unlabeled_mask, WINDOW)
    epilogue_ms = graph_ms(lambda: telemetry.compute_round_metrics(
        ev, st0_4f, ev_picked, ev_vals, ev_scores, higher_is_better=False, n_classes=2))
    entropy_ms = graph_ms(lambda: telemetry._entropy_sum(forest_eval.leaves(ev, st0_4f.x),
                                                         st0_4f.valid_mask))
    xla_entropy_ms = graph_ms(lambda: scoring.full_entropy(forest_eval.proba(ev, st0_4f.x)))
    del ev, ev_scores, ev_vals, ev_picked
    mem = telemetry.device_memory_gauges()
    telemetry_numbers = dict(
        seconds_per_round=tel_times, k1_launches_per_round=k1_per_round,
        epilogue_device_ms=epilogue_ms, entropy_device_ms=entropy_ms,
        xla_spelled_entropy_device_ms=xla_entropy_ms,
        snapshot_ms=snap_ms, save_ms=save_ms,
        save_bytes=os.path.getsize(os.path.join(work, "ck_time", "alstate_104.npz")),
        device_memory=mem, graph=g, round_stream_lead_seconds=stream_lead)
    del st_bench, st0_4f
    shutil.rmtree(work)
    print(f"# telemetry and checkpoints (K = {K}, depth 2, {TIMED} rounds, fit window {budget}): "
          "metrics on == off (records, final mask); every RoundMetrics field finite, "
          f"picked_hist sums to {WINDOW}, labeled_frac x {N_POOL} == n_labeled; graphed chunk "
          "metrics == per-round driver's; stopped at 4 and resumed to 8 == uninterrupted, "
          "chunked and per round; JSONL one round event a round and one launch event a chunk; "
          "/metrics and /healthz answer; flight recorder holds the drive")
    print(f"# seconds per round, metrics on {tel_times['metrics_on']:.5f} vs off "
          f"{tel_times['metrics_off']:.5f} (rounds {K + 1}-{TIMED}, chunked K = {K}, depth 2; "
          f"{kind}, {smi})")
    print(f"# K1 launches per round on the metrics path: {k1_per_round:g} (chunked: "
          f"{launches['metrics_chunked']['forest_leaves']} over {1 + n_replays * K} rounds incl. "
          f"the warm-up; per round: {launches['metrics_per_round']['forest_leaves']} over {K})")
    print(f"# metrics epilogue at the pool: {epilogue_ms:.4f} ms device, graph-replayed, of which "
          f"the pool entropy (tree mean, entropy and sum, native) {entropy_ms:.4f} ms; the "
          f"spelling it replaced (XLA-spelled proba and scoring.full_entropy) "
          f"{xla_entropy_ms:.4f} ms ({kind}, {smi})")
    print(f"# dispatch snapshot {snap_ms:.4f} ms device; checkpoint.save {save_ms:.3f} ms host "
          f"({telemetry_numbers['save_bytes']} bytes, median of 5); device_memory_gauges {mem} "
          f"({kind}, {smi})")
    print(f"# phase 4f: {time.perf_counter() - t_phase:.1f}s")

    # -- phase 4g: quantized storage on the main path -------------------------
    t_phase = time.perf_counter()
    quant_runs = {"int8": ("fused", "unfused", "chunked_fused", "mesh_fused"),
                  "bf16": ("fused", "unfused", "chunked_unfused", "mesh_fused")}
    for mode, paths in quant_runs.items():
        qforest = dataclasses.replace(cfg(False).forest, quantize=mode)
        for kind_ in paths:
            path = f"{mode}_{kind_}"
            fused = kind_.endswith("_fused") or kind_ == "fused"
            if kind_.startswith("chunked"):
                # One eager warm-up round, then one replay of K rounds.
                want_launches[path] = dict(zero, forest_leaves=(1 + K) * (1 if fused else 2),
                                           round_megakernel=(1 + K) if fused else 0)
                drive(path, fused, forest=qforest, rounds_per_launch=K)
                check_chunked(path, f"{mode}_{'fused' if fused else 'unfused'}")
            elif kind_.startswith("mesh"):
                want_launches[path] = dict(want_launches["mesh_fused"])
                drive(path, True, mesh=(4, 2), devices=one_card, forest=qforest)
            else:
                want_launches[path] = dict(want_launches[kind_])
                drive(path, fused, forest=qforest)
        ref = runs[f"{mode}_fused"]
        ref_recs = [(r.round, r.n_labeled, r.accuracy) for r in ref.records]
        for other in (f"{mode}_unfused", f"{mode}_mesh_fused"):
            got = [(r.round, r.n_labeled, r.accuracy) for r in runs[other].records]
            if got != ref_recs or not torch.equal(runs[other].final_labeled_mask,
                                                  ref.final_labeled_mask):
                fail(f"{other} differs from {mode}_fused: {got} vs {ref_recs}")
        small_q = dataclasses.replace(small, forest=dataclasses.replace(small.forest,
                                                                        quantize=mode))
        for c in (small_q, dataclasses.replace(small_q, fused_round=False),
                  dataclasses.replace(small_q, rounds_per_launch=2),
                  dataclasses.replace(small_q, mesh=MeshConfig(4, 2))):
            on_card = loop.run_experiment(c, device=dev, devices=one_card if c.mesh.data > 1
                                          else None)
            on_cpu = loop.run_experiment(c, device="cpu")
            if on_card.to_reference_log() != on_cpu.to_reference_log() or not torch.equal(
                    on_card.final_labeled_mask.cpu(), on_cpu.final_labeled_mask):
                fail(f"small {mode} run ({c.fused_round=}, {c.rounds_per_launch=}, "
                     f"{c.mesh=}) on the card != CPU")
        same = ref_recs == recs[True] and torch.equal(ref.final_labeled_mask, masks[True])
        print(f"# quantized storage {mode}: fused == unfused == 4 x 2 mesh fused (K3 and K4 on the "
              f"{mode} payload) == chunked (K = {K}), records and final mask; small checkerboard "
              f"runs, fused, unfused, chunked and on the mesh: card == CPU. Picks against f32 "
              f"storage: {'equal' if same else 'differ'} (bf16-snapped edges, and {half_leaves} "
              f"leaves at 0.5 in the f32 forest of phase 3c)")
    print(f"# phase 4g: {time.perf_counter() - t_phase:.1f}s")

    # -- phase 4h: multiclass ----------------------------------------------
    t_phase = time.perf_counter()
    C = 4
    s_pool, s_test = (a[:, 0] + 0.3 * a[:, 1] for a in (pool_np, test_np))
    quart = np.quantile(s_pool, [0.25, 0.5, 0.75])
    four = DataBundle(train_x=pool_np, train_y=np.digitize(s_pool, quart).astype(np.int32),
                      test_x=test_np, test_y=np.digitize(s_test, quart).astype(np.int32),
                      name="bench_pool_4_classes")
    # K1 once a plane to score (read again by the pool entropy) and once a
    # plane for test accuracy; chunked, one eager warm-up round and one
    # replay of K rounds; on the mesh once a plane a shard for each.
    mc_paths = {"mc_uncertainty": (dict(collect_metrics=True), 2 * C * ROUNDS),
                "mc_uncertainty_chunked": (dict(collect_metrics=True, rounds_per_launch=K),
                                           2 * C * (1 + K)),
                "mc_entropy": (dict(strategy=StrategyConfig(name="entropy", window_size=WINDOW)),
                               2 * C * ROUNDS),
                "mc_entropy_chunked": (dict(strategy=StrategyConfig(name="entropy",
                                                                    window_size=WINDOW),
                                            rounds_per_launch=K), 2 * C * (1 + K)),
                "mc_mesh": (dict(mesh=(4, 2), devices=one_card), 2 * C * 8 * ROUNDS)}
    for path, (kw, k1_want) in mc_paths.items():
        want_launches[path] = dict(zero, forest_leaves=k1_want)
        drive(path, False, data=four, **kw)
    for path, ref_path in (("mc_uncertainty_chunked", "mc_uncertainty"),
                           ("mc_entropy_chunked", "mc_entropy")):
        check_chunked(path, ref_path)
    mc_metrics = [r.metrics for r in runs["mc_uncertainty"].records]
    if [r.metrics for r in runs["mc_uncertainty_chunked"].records] != mc_metrics:
        fail("4-class RoundMetrics: chunked != per round")
    if any(len(m_["picked_hist"]) != C or sum(m_["picked_hist"]) != WINDOW for m_ in mc_metrics):
        fail(f"4-class picked_hist: {[m_['picked_hist'] for m_ in mc_metrics]}")
    mesh_recs = [(r.round, r.n_labeled, r.accuracy) for r in runs["mc_mesh"].records]
    if mesh_recs != [(r.round, r.n_labeled, r.accuracy) for r in
                     runs["mc_uncertainty"].records] or not torch.equal(
                         runs["mc_mesh"].final_labeled_mask,
                         runs["mc_uncertainty"].final_labeled_mask):
        fail("4-class 4 x 2 mesh run != single device")
    fit_c4 = statistics.median(r.train_time for r in runs["mc_entropy"].records)
    fit_c2 = statistics.median(r.train_time for r in runs["unfused"].records)
    mc_numbers = dict(
        k1_launches_per_round={p: launches[p]["forest_leaves"] / (
            ROUNDS if "chunked" not in p else 1 + K) for p in mc_paths},
        fit_seconds_c4=fit_c4, fit_seconds_c2=fit_c2,
        rounds={p: [dict(fit=r.train_time, round=r.score_time, eval=r.eval_time)
                    for r in runs[p].records] for p in ("mc_uncertainty", "mc_entropy")},
        graph_pool_bytes=runs["mc_uncertainty_chunked"].graph_stats["pool_bytes"])
    print(f"# multiclass (C = {C}, quartiles of x0 + 0.3 x1): uncertainty (top-2 margin, "
          f"RoundMetrics on) and entropy, chunked (K = {K}) == per round, records, masks and "
          f"metrics; 4 x 2 mesh unfused == single device. K1 launches a round "
          f"{mc_numbers['k1_launches_per_round']}; fit median {fit_c4:.4f}s at C = 4 against "
          f"{fit_c2:.4f}s at C = 2 ({kind}, {smi})")
    print(f"# phase 4h: {time.perf_counter() - t_phase:.1f}s")

    # -- phase 4i: LAL -------------------------------------------------------
    t_phase = time.perf_counter()
    from distributed_active_learning_tpu_torch.models import lal_training
    from distributed_active_learning_tpu_torch.strategies.lal import lal_features

    # The five features' ranges on this pool: vote fraction, vote SD, the
    # positive share, the mean SD, the labeled count over the run.
    lal_ranges = ((0.0, 1.0), (0.0, 0.5), (0.0, 1.0), (0.0, 0.5),
                  (float(N_START), float(N_START + ROUNDS * WINDOW)))

    def regressor(n_trees: int, depth_: int, seed: int, ranges=lal_ranges):
        """A regressor in a scikit-learn fit's shapes (the card's machine has
        no scikit-learn), its thresholds drawn inside each feature's range."""
        g_rng = np.random.default_rng(seed)
        packed = forest_lib.synthetic_forest(g_rng, n_trees, depth_, 5)
        feat = packed.feature.numpy()
        lo, hi = (np.array([r[i] for r in ranges], dtype=np.float32) for i in (0, 1))
        f_ = np.clip(feat, 0, 4)
        thr = (lo[f_] + g_rng.random(feat.shape) * (hi[f_] - lo[f_])).astype(np.float32)
        return dataclasses.replace(packed, threshold=torch.from_numpy(
            np.where(feat >= 0, thr, packed.threshold.numpy())))

    def lal_file(name, n_trees, depth_, seed, ranges=lal_ranges):
        path = os.path.join(work, name)
        forest_io.save_forest(path, regressor(n_trees, depth_, seed, ranges),
                              meta=lal_training.lal_meta({"lal_model_path": path}))
        return path

    # JAX's load_or_train_lal_regressor defaults: 200 trees of depth 10.
    lal_path = lal_file("lal_200x10.npz", 200, 10, args.seed + 200)
    lal_cfg = StrategyConfig(name="lal", window_size=WINDOW, options={"lal_model_path": lal_path})
    # K1: the base forest's votes and the test accuracy; the regressor is
    # the gather form (plain PyTorch, no kernel), as in the JAX loop.
    want_launches["lal"] = dict(zero, forest_leaves=2 * ROUNDS)
    drive("lal", False, strategy=lal_cfg)
    want_launches["lal_chunked"] = dict(zero, forest_leaves=2 * (1 + K))
    drive("lal_chunked", False, strategy=lal_cfg, rounds_per_launch=K)
    check_chunked("lal_chunked", "lal")
    small_path = lal_file("lal_small.npz", 12, 6, args.seed + 12,
                          ((0, 1), (0, 0.5), (0, 1), (0, 0.5), (10, 60)))
    small_lal = dataclasses.replace(small, fused_round=False, strategy=StrategyConfig(
        name="lal", window_size=15, options={"lal_model_path": small_path}))
    for c in (small_lal, dataclasses.replace(small_lal, rounds_per_launch=2)):
        on_card = loop.run_experiment(c, device=dev)
        on_cpu = loop.run_experiment(c, device="cpu")
        if on_card.to_reference_log() != on_cpu.to_reference_log() or not torch.equal(
                on_card.final_labeled_mask.cpu(), on_cpu.final_labeled_mask):
            fail(f"small lal run (rounds_per_launch {c.rounds_per_launch}) on the card != CPU")
    # The regressor's gather form at the pool: 200 trees x 10 steps of
    # [284,807, 200] gathers.
    reg_dev = forest_io.load_forest(lal_path, dev)[0]
    st_lal = state_lib.set_start_state(
        state_lib.init_pool_state(bundle.train_x, bundle.train_y, prng.key(args.seed), dev),
        N_START)
    feats = lal_features(trees_pallas.PallasForest(gf=gf), st_lal)
    reg_ms = cuda_ms(lambda: forest_eval.value(reg_dev, feats), reps=3)
    feat_ms = cuda_ms(lambda: lal_features(trees_pallas.PallasForest(gf=gf), st_lal), reps=5)
    lal_numbers = dict(
        regressor_gather_ms=reg_ms, features_ms=feat_ms,
        graph_pool_bytes=runs["lal_chunked"].graph_stats["pool_bytes"],
        rounds=[dict(fit=r.train_time, round=r.score_time, eval=r.eval_time)
                for r in runs["lal"].records])
    print(f"# lal (regressor 200 trees of depth 10 from a forest file, gather form): chunked "
          f"(K = {K}) == per round; small checkerboard runs, per round and chunked: card == CPU. "
          f"Regressor over the pool's [{N_POOL}, 5] features {reg_ms:.3f} ms, the features "
          f"{feat_ms:.3f} ms (K1 votes included); chunk graph private pool "
          f"{lal_numbers['graph_pool_bytes'] / 2**20:.0f} MiB ({kind}, {smi})")
    print(f"# phase 4i: {time.perf_counter() - t_phase:.1f}s")

    # -- phase 4j: the sweep ----------------------------------------------------
    t_phase = time.perf_counter()
    from distributed_active_learning_tpu_torch.runtime import sweep as sweep_lib

    E_SWEEP, SWEEP_ROUNDS = 8, 8
    n_sweep_chunks = SWEEP_ROUNDS // K
    sweep_cfg = cfg(False, collect_metrics=True, rounds_per_launch=K, max_rounds=SWEEP_ROUNDS)
    sweep_seeds = [args.seed + i for i in range(E_SWEEP)]

    def full_records(res):
        return [(r.round, r.n_labeled, r.accuracy, r.metrics) for r in res.records]

    def steady(res):  # seconds per (experiment-)round after the capturing chunk
        return statistics.mean(r.total_time for r in res.records[K:])

    zero_counts()
    t0 = time.perf_counter()
    swept = sweep_lib.run_sweep(sweep_cfg, sweep_seeds, bundle=bundle, device=dev)
    torch.cuda.synchronize()
    sweep_wall = time.perf_counter() - t0
    launches["sweep"] = counts()
    # One eager warm-up round step (K1 on the pool and on the test set for
    # all 8 forests), then K round steps a replay: 2 launches a step.
    want_launches["sweep"] = dict(zero, forest_leaves=2 * (1 + n_sweep_chunks * K))
    g_sweep = swept[0].graph_stats
    print(f"# sweep (E = {E_SWEEP}, K = {K}, {SWEEP_ROUNDS} rounds, metrics on): {sweep_wall:.2f}s "
          f"wall, launches {launches['sweep']}, graph {g_sweep}")
    if launches["sweep"] != want_launches["sweep"]:
        fail(f"sweep launched {launches['sweep']}, want {want_launches['sweep']}")
    if (g_sweep["captures"] != 1 or g_sweep["replays"] != n_sweep_chunks
            or g_sweep["launches_per_replay"]["trees_pallas.launches"] != 2 * K):
        fail(f"sweep graph {g_sweep}: want 1 capture, {n_sweep_chunks} replays, K1 {2 * K} a "
             "replay")
    serial_walls, serial_steady = [], []
    launches["sweep_serial"] = dict(zero)
    for s_, res in zip(sweep_seeds, swept):
        zero_counts()
        t0 = time.perf_counter()
        ser = loop.run_experiment(dataclasses.replace(sweep_cfg, seed=s_), bundle=bundle,
                                  device=dev)
        torch.cuda.synchronize()
        serial_walls.append(time.perf_counter() - t0)
        serial_steady.append(steady(ser))
        for name_, n_ in counts().items():
            launches["sweep_serial"][name_] += n_
        if full_records(res) != full_records(ser) or not torch.equal(
                res.final_labeled_mask, ser.final_labeled_mask):
            fail(f"sweep seed {s_} differs from its serial chunked run")
        if [r.n_labeled for r in res.records] != [N_START + i * WINDOW for i in range(SWEEP_ROUNDS)]:
            fail(f"sweep seed {s_}: n_labeled {[r.n_labeled for r in res.records]}")
    er = E_SWEEP * SWEEP_ROUNDS
    sweep_numbers = dict(
        experiments=E_SWEEP, rounds=SWEEP_ROUNDS, rounds_per_launch=K, wall_seconds=sweep_wall,
        serial_wall_seconds=sum(serial_walls),
        sweep_experiments_rounds_per_second=er / sweep_wall,
        serial_experiments_rounds_per_second=er / sum(serial_walls),
        sweep_speedup=sum(serial_walls) / sweep_wall,
        steady_seconds_per_experiment_round=steady(swept[0]),
        serial_steady_seconds_per_round=statistics.mean(serial_steady),
        k1_launches=launches["sweep"]["forest_leaves"],
        k1_launches_serial=launches["sweep_serial"]["forest_leaves"],
        k1_launches_per_replay=g_sweep["launches_per_replay"]["trees_pallas.launches"],
        capture_seconds=g_sweep["capture_seconds"], pool_bytes=g_sweep["pool_bytes"])
    sweep_numbers["steady_speedup"] = (sweep_numbers["serial_steady_seconds_per_round"]
                                       / sweep_numbers["steady_seconds_per_experiment_round"])
    # The fit's share of a sweep round: one round step's 8 device fits alone
    # (the sweep's fit window, each seed's start mask), captured in a CUDA
    # graph and replayed, against the steady experiment-round.
    st_fit = state_lib.init_pool_state(bundle.train_x, bundle.train_y, prng.key(args.seed), dev)
    binned_fit = trees_train.make_bins(st_fit.x, BINS)
    sweep_fit = loop.make_device_fit(sweep_cfg, binned_fit.edges, sweep_lib._resolve_sweep_fit_budget(
        sweep_cfg, N_POOL, N_START, WINDOW))
    fit_states = [state_lib.set_start_state(st_fit.replace(key=prng.key(s_)), N_START)
                  for s_ in sweep_seeds]
    fit_key = prng.key(args.seed + 0x5EED, dev)
    fits_ms = graph_ms(lambda: [sweep_fit(binned_fit.codes, st_, fit_key) for st_ in fit_states],
                       reps=5, inner=3)
    sweep_numbers["fit_device_ms_per_experiment"] = fits_ms / E_SWEEP
    sweep_numbers["fit_share_of_experiment_round"] = (
        fits_ms / E_SWEEP / 1e3 / sweep_numbers["steady_seconds_per_experiment_round"])
    del st_fit, binned_fit, fit_states
    small_sweep = dataclasses.replace(small, fused_round=False, collect_metrics=True,
                                      rounds_per_launch=2, forest=dataclasses.replace(
                                          small.forest, fit_budget=128))
    on_card = sweep_lib.run_sweep(small_sweep, [0, 1, 2], windows=[15, 10, 15], device=dev)
    on_cpu = sweep_lib.run_sweep(small_sweep, [0, 1, 2], windows=[15, 10, 15], device="cpu")
    for a, b in zip(on_card, on_cpu):
        if a.to_reference_log() != b.to_reference_log() or not torch.equal(
                a.final_labeled_mask.cpu(), b.final_labeled_mask):
            fail("small sweep (windows 15, 10, 15) on the card != CPU")
    print(f"# sweep == {E_SWEEP} serial chunked runs (records, RoundMetrics, final masks); K1 "
          f"{sweep_numbers['k1_launches']} launches against {sweep_numbers['k1_launches_serial']} "
          f"serial ({sweep_numbers['k1_launches_per_replay']} a replay of {K} rounds); "
          f"experiments x rounds per second {sweep_numbers['sweep_experiments_rounds_per_second']:.2f}"
          f" against {sweep_numbers['serial_experiments_rounds_per_second']:.2f} serial "
          f"(sweep_speedup {sweep_numbers['sweep_speedup']:.3f}, capture included); steady "
          f"{sweep_numbers['steady_seconds_per_experiment_round']:.5f} s an experiment-round "
          f"against {sweep_numbers['serial_steady_seconds_per_round']:.5f} s a serial chunked "
          f"round ({sweep_numbers['steady_speedup']:.3f}x), of which the fit "
          f"{sweep_numbers['fit_device_ms_per_experiment']:.3f} ms device "
          f"({100 * sweep_numbers['fit_share_of_experiment_round']:.1f}%); graph capture "
          f"{sweep_numbers['capture_seconds']:.2f}s, private pool "
          f"{sweep_numbers['pool_bytes'] / 2**20:.0f} MiB; small sweep card == CPU ({kind}, {smi})")
    print(f"# phase 4j: {time.perf_counter() - t_phase:.1f}s")

    # -- phase 4k: the grid -----------------------------------------------------
    t_phase = time.perf_counter()
    GRID_STRATEGIES, GRID_ROUNDS = ["uncertainty", "margin", "density"], 8
    grid_seeds = sweep_seeds[:4]
    n_grid_chunks = GRID_ROUNDS // K
    grid_cfg = cfg(False, collect_metrics=True, rounds_per_launch=K, max_rounds=GRID_ROUNDS,
                   data=DataConfig(name="bench_pool"))

    def watermark_close(a, b):
        """Records equal, and RoundMetrics equal but for the two fields a
        fill watermark divides by its count of valid rows (a true division,
        as the JAX package's grid does, where a run without one multiplies
        by the f32 reciprocal of a constant): within one f32 ulp."""
        if [(r.round, r.n_labeled, r.accuracy) for r in a.records] != [
                (r.round, r.n_labeled, r.accuracy) for r in b.records]:
            return False
        for ra, rb in zip(a.records, b.records):
            for field, v in rb.metrics.items():
                if field in ("labeled_frac", "pool_entropy"):
                    if abs(ra.metrics[field] - v) > float(np.spacing(np.float32(v))):
                        return False
                elif ra.metrics[field] != v:
                    return False
        return True

    def drive_grid(path, strategies_, seeds_, datasets_, bundles_, n_chunks_, rounds_):
        zero_counts()
        t0 = time.perf_counter()
        grid = sweep_lib.run_grid(dataclasses.replace(grid_cfg, max_rounds=rounds_), strategies_,
                                  seeds_, datasets=datasets_, bundles=bundles_, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[path] = counts()
        want_launches[path] = dict(zero, forest_leaves=2 * len(datasets_) * (1 + n_chunks_ * K))
        g = grid.graph_stats
        print(f"# {path}: {len(grid.cells)} cells, {wall:.2f}s wall, launches {launches[path]}, "
              f"graph {g}")
        if launches[path] != want_launches[path] or grid.recompiles_after_warmup != 0 or (
                g["captures"], g["replays"]) != (1, n_chunks_):
            fail(f"{path}: launches {launches[path]} (want {want_launches[path]}), graph {g}, "
                 f"recompiles_after_warmup {grid.recompiles_after_warmup}")
        serial_sec = 0.0
        for cell in grid.cells:
            t0 = time.perf_counter()
            ser = loop.run_experiment(dataclasses.replace(
                grid_cfg, seed=cell.seed, max_rounds=rounds_,
                data=DataConfig(name=cell.dataset),
                strategy=dataclasses.replace(grid_cfg.strategy, name=cell.strategy)),
                bundle=bundles_[cell.dataset], device=dev)
            torch.cuda.synchronize()
            serial_sec += time.perf_counter() - t0
            same = (watermark_close(cell.result, ser) if len(datasets_) > 1
                    else full_records(cell.result) == full_records(ser))
            if not same or not torch.equal(cell.result.final_labeled_mask, ser.final_labeled_mask):
                fail(f"{path} cell {cell.strategy}/{cell.dataset}/seed {cell.seed} differs from "
                     f"its serial chunked run: {full_records(cell.result)} vs {full_records(ser)}")
        cr = len(grid.cells) * rounds_
        if not grid_cells_4k:
            grid_cells_4k.extend(grid.cells)
        return dict(cells=len(grid.cells), rounds=rounds_, wall_seconds=wall,
                    serial_wall_seconds=serial_sec,
                    grid_cells_rounds_per_second=cr / wall,
                    serial_cells_rounds_per_second=cr / serial_sec,
                    grid_speedup=serial_sec / wall,
                    steady_seconds_per_cell_round=(statistics.mean(
                        steady(c.result) for c in grid.cells) if n_chunks_ > 1 else None),
                    recompiles_after_warmup=grid.recompiles_after_warmup,
                    k1_launches=launches[path]["forest_leaves"],
                    k1_launches_per_replay=g["launches_per_replay"]["trees_pallas.launches"],
                    capture_seconds=g["capture_seconds"], pool_bytes=g["pool_bytes"])

    grid_cells_4k = []
    grid_numbers = drive_grid("grid", GRID_STRATEGIES, grid_seeds, ["bench_pool"],
                              {"bench_pool": bundle}, n_grid_chunks, GRID_ROUNDS)
    # Two pools of unequal widths: padded to one slab, the real rows marked by
    # the fill watermark. The test sets share one width, so the accuracy is
    # the serial run's (a masked accuracy divides by its count, as the JAX
    # package's does; tests/test_torch_cuda.py holds that one card == CPU).
    half_rng = np.random.default_rng(args.seed + 142_403)
    half_x = half_rng.normal(size=(142_403, N_FEAT)).astype(np.float32)
    half_tx = half_rng.normal(size=(N_TEST, N_FEAT)).astype(np.float32)
    half = DataBundle(train_x=half_x, train_y=labels(half_x), test_x=half_tx,
                      test_y=labels(half_tx), name="half_pool")
    grid_numbers["two_datasets"] = drive_grid(
        "grid_two_datasets", ["uncertainty"], grid_seeds[:2], ["bench_pool", "half_pool"],
        {"bench_pool": bundle, "half_pool": half}, 1, K)
    print(f"# grid ({len(GRID_STRATEGIES)} strategies x {len(grid_seeds)} seeds, K = {K}, "
          f"{GRID_ROUNDS} rounds, metrics on) == its serial chunked cells (records, RoundMetrics, "
          f"final masks); grid_cells_rounds_per_second "
          f"{grid_numbers['grid_cells_rounds_per_second']:.2f} against "
          f"{grid_numbers['serial_cells_rounds_per_second']:.2f} serial (grid_speedup "
          f"{grid_numbers['grid_speedup']:.3f}); steady "
          f"{grid_numbers['steady_seconds_per_cell_round']:.5f} s a cell-round; "
          f"recompiles_after_warmup {grid_numbers['recompiles_after_warmup']}; K1 "
          f"{grid_numbers['k1_launches_per_replay']} a replay; capture "
          f"{grid_numbers['capture_seconds']:.2f}s, private pool "
          f"{grid_numbers['pool_bytes'] / 2**20:.0f} MiB. Two datasets ({N_POOL} and 142,403 "
          f"rows, the fill watermark) == their serial cells (records, masks; labeled_frac and "
          f"pool_entropy, divided by the watermark's count, within one f32 ulp), K1 "
          f"{grid_numbers['two_datasets']['k1_launches_per_replay']} a replay ({kind}, {smi})")
    print(f"# phase 4k: {time.perf_counter() - t_phase:.1f}s")

    # -- phase 4l: scenarios ---------------------------------------------------
    t_phase = time.perf_counter()
    from distributed_active_learning_tpu_torch.config import ScenarioConfig
    from distributed_active_learning_tpu_torch.ops.topk import knapsack_top_k
    from distributed_active_learning_tpu_torch.scenarios import engine as scn_engine

    SCN_ROUNDS = 8
    n_scn_chunks = SCN_ROUNDS // K
    families = {
        "noisy_oracle": ScenarioConfig(kind="noisy_oracle", flip_prob=0.1, abstain_prob=0.25),
        "cost_budget": ScenarioConfig(kind="cost_budget", cost_budget=2.5 * WINDOW,
                                      cost_spread=4.0),
        "rare_event": ScenarioConfig(kind="rare_event", rare_class=1),
        "drift": ScenarioConfig(kind="drift", drift_rate=0.2),
        "drift_rotation": ScenarioConfig(kind="drift", drift_rate=0.2, drift_kind="rotation"),
        "none": ScenarioConfig(),
    }
    scn_cfg = cfg(False, collect_metrics=True, max_rounds=SCN_ROUNDS,
                  strategy=StrategyConfig(name="entropy", window_size=WINDOW),
                  data=DataConfig(name="bench_pool"))

    def scn_drive(path, scn, **kw):
        zero_counts()
        t0 = time.perf_counter()
        res = loop.run_experiment(dataclasses.replace(scn_cfg, scenario=scn, **kw), bundle=bundle,
                                  device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[path] = counts()
        return res, wall

    # (a) One run a family, per round and chunked (K = 4, depth 2).
    scn_runs, scenario_numbers = {}, {}
    for name, scn in families.items():
        pr_path, ch_path = f"scenario_{name}_per_round", f"scenario_{name}_chunked"
        per_round, pr_wall = scn_drive(pr_path, scn)
        chunked, ch_wall = scn_drive(ch_path, scn, rounds_per_launch=K, pipeline_depth=2)
        scn_runs[name] = chunked
        want_launches[pr_path] = dict(zero, forest_leaves=2 * SCN_ROUNDS)
        want_launches[ch_path] = dict(zero, forest_leaves=2 * (1 + n_scn_chunks * K))
        g = chunked.graph_stats
        for path in (pr_path, ch_path):
            if launches[path] != want_launches[path]:
                fail(f"{path} launched {launches[path]}, want {want_launches[path]}")
        if g is None or (g["captures"], g["replays"]) != (1, n_scn_chunks):
            fail(f"{ch_path}: graph {g}, want 1 capture and {n_scn_chunks} replays")
        if full_records(chunked) != full_records(per_round) or not torch.equal(
                chunked.final_labeled_mask, per_round.final_labeled_mask):
            fail(f"{ch_path} differs from its per-round run: {full_records(chunked)} vs "
                 f"{full_records(per_round)}")
        if len(chunked.records) != SCN_ROUNDS or not all(
                np.isfinite(v) for r in chunked.records for k_, v in r.metrics.items()
                if k_ != "picked_hist"):
            fail(f"{ch_path}: {len(chunked.records)} records, or a metric is not finite")
        keys = set(chunked.records[0].metrics)
        if ("rare_recall" in keys) != (scn.kind == "rare_event") or (
                "cost_spent" in keys) != (scn.kind == "cost_budget"):
            fail(f"{ch_path}: metric keys {sorted(keys)}")
        labeled = [r.n_labeled for r in chunked.records]
        scenario_numbers[name] = dict(
            chunked_steady_seconds_per_round=steady(chunked),
            per_round_seconds_per_round=statistics.mean(r.total_time for r in per_round.records[1:]),
            chunked_wall_seconds=ch_wall, per_round_wall_seconds=pr_wall,
            k1_launches_chunked=launches[ch_path]["forest_leaves"],
            k1_launches_per_round_driver=launches[pr_path]["forest_leaves"],
            k1_launches_per_replay=g["launches_per_replay"]["trees_pallas.launches"],
            labels_per_round=[b - a for a, b in zip(labeled, labeled[1:])],
            final_accuracy=chunked.records[-1].accuracy,
            capture_seconds=g["capture_seconds"], pool_bytes=g["pool_bytes"])
        if scn.kind == "rare_event":
            scenario_numbers[name]["rare_recall"] = [r.metrics["rare_recall"]
                                                     for r in chunked.records]
        if scn.kind == "cost_budget":
            scenario_numbers[name]["cost_spent"] = [r.metrics["cost_spent"]
                                                    for r in chunked.records]
        print(f"#   scenario {name}: chunked == per round (records, RoundMetrics, final mask); "
              f"steady {scenario_numbers[name]['chunked_steady_seconds_per_round']:.5f} s a "
              f"chunked round (per round "
              f"{scenario_numbers[name]['per_round_seconds_per_round']:.5f} s); K1 "
              f"{launches[ch_path]['forest_leaves']} chunked, "
              f"{launches[pr_path]['forest_leaves']} per round; labels a round "
              f"{scenario_numbers[name]['labels_per_round']}")

    # The scenario chunk bodies, eagerly, with host syncs turned into errors:
    # the knapsack, the abstaining reveal and the drifted eval stay on the card.
    st0 = state_lib.set_start_state(
        state_lib.init_pool_state(bundle.train_x, bundle.train_y, prng.key(args.seed), dev),
        N_START)
    binned0 = trees_train.make_bins(st0.x, BINS)
    tx_dev = torch.from_numpy(test_np).to(dev)
    ty_dev = torch.from_numpy(labels(test_np)).to(dev)
    costs_dev = scn_engine.make_costs(families["cost_budget"], N_POOL, "bench_pool", dev)
    for name in ("noisy_oracle", "cost_budget", "drift", "drift_rotation"):
        scn = families[name]
        direction = (scn_engine.drift_direction(scn, N_FEAT, dev)
                     if scn.kind == "drift" and scn.drift_kind == "mean_shift" else None)
        body = loop.make_chunk_fn(
            get_strategy(scn_cfg.strategy), WINDOW, 2,
            loop.make_device_fit(scn_cfg, binned0.edges, N_START + 4 * WINDOW), N_POOL,
            with_metrics=True, scenario=scn, drift_direction=direction)
        body_args = (binned0.codes, state_lib.as_carry(st0),
                     StrategyAux(seed_mask=st0.labeled_mask.clone()), prng.key(7, dev),
                     tx_dev, ty_dev, torch.as_tensor(99, dtype=torch.int32).to(dev),
                     costs_dev if scn.kind == "cost_budget" else None)
        body(*body_args)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, extras, _ = body(*body_args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if int(extras.n_active) != 2:
            fail(f"the eager {name} chunk body did not run two active rounds")
    print("# scenario chunk bodies (noisy_oracle, cost_budget, drift mean_shift and rotation), "
          "eager, torch.cuda.set_sync_debug_mode('error'): no host sync")

    # (b) The scenario grid: JAX's bench axis (the axis refuses two drift
    # kinds, so rotation ran above only) x entropy x 2 seeds in one stream.
    scn_axis = [families[k_] for k_ in ("none", "noisy_oracle", "cost_budget", "rare_event",
                                        "drift")]
    scn_seeds = [args.seed, args.seed + 1]
    zero_counts()
    t0 = time.perf_counter()
    # Pipeline depth 1: each chunk's wall is its own dispatch -> touchdown,
    # so the second chunk's rounds time a steady cell-round.
    scn_grid = sweep_lib.run_grid(dataclasses.replace(scn_cfg, rounds_per_launch=K,
                                                      pipeline_depth=1), ["entropy"],
                                  scn_seeds, scenarios=scn_axis, bundles={"bench_pool": bundle},
                                  device=dev)
    torch.cuda.synchronize()
    scn_grid_wall = time.perf_counter() - t0
    launches["scenario_grid"] = counts()
    # A round step: one K1 over the 10 cells' forests on the pool, one over
    # the 8 steady cells' on the test set, one each for the 2 drift cells on
    # their drifted test sets.
    want_launches["scenario_grid"] = dict(zero, forest_leaves=4 * (1 + n_scn_chunks * K))
    g = scn_grid.graph_stats
    if launches["scenario_grid"] != want_launches["scenario_grid"] or (
            scn_grid.recompiles_after_warmup != 0 or (g["captures"], g["replays"])
            != (1, n_scn_chunks)):
        fail(f"scenario grid: launches {launches['scenario_grid']} (want "
             f"{want_launches['scenario_grid']}), graph {g}, recompiles_after_warmup "
             f"{scn_grid.recompiles_after_warmup}")
    for cell in scn_grid.cells:
        if cell.seed != args.seed:
            continue
        ser = scn_runs[cell.scenario]
        if full_records(cell.result) != full_records(ser) or not torch.equal(
                cell.result.final_labeled_mask, ser.final_labeled_mask):
            fail(f"scenario grid cell {cell.scenario}/seed {cell.seed} differs from its serial "
                 f"chunked run: {full_records(cell.result)} vs {full_records(ser)}")
    scenario_numbers["grid"] = dict(
        cells=len(scn_grid.cells), rounds=SCN_ROUNDS, wall_seconds=scn_grid_wall,
        cells_rounds_per_second=len(scn_grid.cells) * SCN_ROUNDS / scn_grid_wall,
        steady_seconds_per_cell_round=statistics.mean(steady(c.result) for c in scn_grid.cells),
        recompiles_after_warmup=scn_grid.recompiles_after_warmup,
        k1_launches=launches["scenario_grid"]["forest_leaves"],
        k1_launches_per_replay=g["launches_per_replay"]["trees_pallas.launches"],
        capture_seconds=g["capture_seconds"], pool_bytes=g["pool_bytes"],
        seconds_per_cell_round_by_round=[r.total_time for r in scn_grid.cells[0].result.records],
        launch_seconds=scn_grid.pipeline_stats.launch_seconds,
        chunks=scn_grid.pipeline_stats.chunks)
    print(f"# scenario grid: a cell's seconds a cell-round by round "
          f"{scenario_numbers['grid']['seconds_per_cell_round_by_round']}, launch seconds "
          f"{scn_grid.pipeline_stats.launch_seconds:.3f} over {scn_grid.pipeline_stats.chunks} "
          f"chunks, capture {g['capture_seconds']:.2f}s; phase 4k's grid, a cell's "
          f"{[r.total_time for r in grid_cells_4k[0].result.records]}")
    print(f"# scenario grid ({len(scn_axis)} scenarios x entropy x {len(scn_seeds)} seeds, K = {K},"
          f" {SCN_ROUNDS} rounds, metrics on): the seed-{args.seed} cells == their serial chunked "
          f"runs; {scn_grid_wall:.2f}s wall, "
          f"{scenario_numbers['grid']['cells_rounds_per_second']:.2f} cell-rounds/s, steady "
          f"{scenario_numbers['grid']['steady_seconds_per_cell_round']:.5f} s a cell-round; K1 "
          f"{scenario_numbers['grid']['k1_launches_per_replay']} a replay; recompiles_after_warmup "
          f"{scn_grid.recompiles_after_warmup}")

    # (c) The card against the CPU at the CPU tests' size, every family
    # chunked (K = 2), and the scenario grid; then the scenario draws. The
    # pool entropy is native float32 (telemetry.POOL_ENTROPY_RTOL between
    # the devices); every other field is bit-equal.
    from distributed_active_learning_tpu_torch.runtime.telemetry import POOL_ENTROPY_RTOL

    def card_is_cpu(a, b):
        if [(r.round, r.n_labeled, r.accuracy) for r in a.records] != [
                (r.round, r.n_labeled, r.accuracy) for r in b.records]:
            return False
        for ra, rb in zip(a.records, b.records):
            for field, v in rb.metrics.items():
                if field == "pool_entropy":
                    if abs(ra.metrics[field] - v) > POOL_ENTROPY_RTOL * abs(v):
                        return False
                elif ra.metrics[field] != v:
                    return False
        return torch.equal(a.final_labeled_mask.cpu(), b.final_labeled_mask)

    small_scn = ExperimentConfig(
        data=DataConfig(name="checkerboard2x2", n_samples=96, seed=2),
        forest=ForestConfig(n_trees=4, max_depth=3, fit="device", kernel="pallas", fit_budget=96),
        strategy=StrategyConfig(name="entropy", window_size=8), n_start=8, max_rounds=3,
        rounds_per_launch=2, collect_metrics=True, log_every=0)
    small_families = {
        "noisy_oracle": ScenarioConfig(kind="noisy_oracle", flip_prob=0.2, abstain_prob=0.3),
        "rare_event": ScenarioConfig(kind="rare_event", rare_class=1),
        "drift": ScenarioConfig(kind="drift", drift_rate=0.3),
        "drift_rotation": ScenarioConfig(kind="drift", drift_rate=0.3, drift_kind="rotation"),
        "cost_budget": ScenarioConfig(kind="cost_budget", cost_budget=6.0),
    }
    for name, scn in small_families.items():
        c = dataclasses.replace(small_scn, scenario=scn)
        on_card = loop.run_experiment(c, device=dev)
        on_cpu = loop.run_experiment(c, device="cpu")
        if not card_is_cpu(on_card, on_cpu):
            fail(f"small {name} run on the card != CPU: {full_records(on_card)} vs "
                 f"{full_records(on_cpu)}")
    small_axis = [ScenarioConfig()] + [small_families[k_] for k_ in
                                       ("noisy_oracle", "rare_event", "drift", "cost_budget")]
    grid_card = sweep_lib.run_grid(small_scn, ["entropy"], [0, 1], scenarios=small_axis,
                                   device=dev)
    grid_cpu = sweep_lib.run_grid(small_scn, ["entropy"], [0, 1], scenarios=small_axis,
                                  device="cpu")
    for a, b in zip(grid_card.cells, grid_cpu.cells):
        if not card_is_cpu(a.result, b.result):
            fail(f"small scenario grid cell {a.scenario}/seed {a.seed}: card != CPU")
    draws = dict(
        flips=lambda d_: scn_engine.flip_mask(families["noisy_oracle"], args.seed, N_POOL, d_),
        costs=lambda d_: scn_engine.make_costs(families["cost_budget"], N_POOL, "bench_pool", d_),
        direction=lambda d_: scn_engine.drift_direction(families["drift"], N_FEAT, d_),
        normal=lambda d_: prng.normal(prng.key(args.seed), (N_POOL,), d_))
    for name, draw in draws.items():
        if not torch.equal(draw(dev).cpu(), draw("cpu")):
            fail(f"the scenario draw {name} on the card != CPU")
    test_cpu = torch.from_numpy(test_np)
    for name in ("drift", "drift_rotation"):
        scn = families[name]
        for r_ in range(6):
            a = scn_engine.drift_apply(scn, tx_dev, torch.tensor(r_, dtype=torch.int32, device=dev))
            b = scn_engine.drift_apply(scn, test_cpu, torch.tensor(r_, dtype=torch.int32))
            if not torch.equal(a.cpu(), b):
                fail(f"drift_apply {name} round {r_}: card != CPU")
    print("# scenarios at the CPU tests' size (checkerboard 96 rows, 4 trees of depth 3, window 8),"
          " every family chunked and the scenario grid: card == CPU plain versions; the flips, "
          "costs, drift direction (erfinv_f32), a pool-size normal draw and drift_apply of both "
          "kinds at rounds 0-5: card == CPU")

    # (d) The knapsack over the pool at k = 100, captured in a graph.
    ent = torch.rand(N_POOL, generator=torch.Generator(device=dev).manual_seed(args.seed),
                     device=dev)
    unl = ~st0.labeled_mask
    knap = knapsack_top_k(ent, costs_dev, unl, WINDOW, 2.5 * WINDOW)
    for budget in (2.5 * WINDOW, 0.6 * WINDOW):  # 0.6: the budget runs out, sentinels follow
        got_ = knapsack_top_k(ent, costs_dev, unl, WINDOW, budget)
        want_ = knapsack_top_k(ent.cpu(), costs_dev.cpu(), unl.cpu(), WINDOW, budget)
        if not all(torch.equal(a.cpu(), b) for a, b in zip(got_, want_)):
            fail(f"knapsack_top_k over the pool at budget {budget}: card != CPU")
        scenario_numbers[f"knapsack_kept_at_{budget:g}"] = int(got_[2].sum())
    knap_ms = graph_ms(lambda: knapsack_top_k(ent, costs_dev, unl, WINDOW, 2.5 * WINDOW),
                       reps=5, inner=5)
    scenario_numbers["knapsack_device_ms"] = knap_ms
    scenario_numbers["knapsack_kept"] = int(knap[2].sum())
    if scenario_numbers[f"knapsack_kept_at_{0.6 * WINDOW:g}"] >= WINDOW:
        fail("the knapsack at budget 0.6 x window kept the whole window: no sentinel was checked")
    scenario_numbers["clean_chunked_seconds_per_round"] = chunk_times["unfused_chunked_depth2"]
    del st0, binned0, tx_dev, ty_dev, costs_dev, ent, unl
    per_family = ", ".join(
        f"{k_} {v['chunked_steady_seconds_per_round']:.5f}" for k_, v in scenario_numbers.items()
        if isinstance(v, dict) and "chunked_steady_seconds_per_round" in v)
    print(f"# scenarios, seconds a chunked round (entropy, metrics on, rounds {K + 1}-{SCN_ROUNDS}):"
          f" {per_family}; phase 4c's clean unfused chunked round "
          f"{chunk_times['unfused_chunked_depth2']:.5f}. Knapsack over the pool at k = {WINDOW} "
          f"(budget {2.5 * WINDOW}): {knap_ms:.3f} ms device, {scenario_numbers['knapsack_kept']} "
          f"picks kept. K1 launches a round (per-round driver): " + ", ".join(
              f"{name} {launches[f'scenario_{name}_per_round']['forest_leaves'] / SCN_ROUNDS:g}"
              for name in families) + f" ({kind}, {smi})")
    print(f"# phase 4l: {time.perf_counter() - t_phase:.1f}s")

    # -- phase 4m: data from files ---------------------------------------------
    t_phase = time.perf_counter()
    from distributed_active_learning_tpu_torch.data import _native, formats
    from distributed_active_learning_tpu_torch.models import lal_training

    files_numbers = {}
    data_dir = tempfile.mkdtemp(prefix="chip_smoke_4m_")
    csv = os.path.join(data_dir, "creditcard.csv")
    t0 = time.perf_counter()
    formats.write_credit_card_csv(csv, seed=args.seed)
    files_numbers["csv_write_seconds"] = time.perf_counter() - t0
    files_numbers["csv_bytes"] = os.path.getsize(csv)
    t0 = time.perf_counter()
    _native.load()  # built from cpp/loader.cpp into build/kernels/ (host C++ compiler)
    files_numbers["loader_build_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat_x, nat_y = formats.load_credit_card_csv(csv)
    files_numbers["native_parse_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pl_x, pl_y = formats.load_credit_card_csv(csv, native=False)
    files_numbers["plain_parse_seconds"] = time.perf_counter() - t0
    if nat_x.shape != (N_POOL, N_FEAT) or pl_x.shape != nat_x.shape:
        fail(f"credit-card CSV parsed to {nat_x.shape} (native) and {pl_x.shape} (plain)")
    if not np.array_equal(nat_y, pl_y) or int(nat_y.sum()) != formats.CREDIT_CARD_FRAUD:
        fail(f"credit-card labels: native {int(nat_y.sum())} positives, routes equal "
             f"{np.array_equal(nat_y, pl_y)}")
    # The routes round a token differently only where the numpy route's
    # double lands next to a float32 midpoint: at most one ulp, same sign.
    ulps = np.abs(nat_x.view(np.int32).astype(np.int64) - pl_x.view(np.int32).astype(np.int64))
    files_numbers["tokens_differing"] = int((ulps != 0).sum())
    files_numbers["max_ulps"] = int(ulps.max())
    if ulps.max() > 1 or not np.array_equal(np.sign(nat_x), np.sign(pl_x)):
        fail(f"native and plain parses differ by up to {int(ulps.max())} ulps")
    del pl_x, pl_y
    t0 = time.perf_counter()
    cc = get_dataset(DataConfig(name="credit_card_fraud", path=csv, seed=args.seed))
    files_numbers["get_dataset_seconds"] = time.perf_counter() - t0
    n_tr, n_te = int(0.7 * N_POOL), N_POOL - int(0.7 * N_POOL)
    if cc.train_x.shape != (n_tr, N_FEAT) or cc.test_x.shape != (n_te, N_FEAT):
        fail(f"credit_card_fraud bundle {cc.train_x.shape} / {cc.test_x.shape}")
    if not (np.isfinite(cc.train_x).all() and np.isfinite(cc.test_x).all()) or \
            np.abs(cc.train_x.mean(0)).max() > 1e-3 or np.abs(cc.train_x.std(0) - 1).max() > 1e-3:
        fail("the credit_card_fraud pool is not finite and standardized")
    if int(cc.train_y.sum()) + int(cc.test_y.sum()) != formats.CREDIT_CARD_FRAUD:
        fail("the 70/30 split lost positives")
    print(f"# credit-card file ({files_numbers['csv_bytes'] / 1e6:.1f} MB, {N_POOL} rows): "
          f"written {files_numbers['csv_write_seconds']:.2f}s; native loader built "
          f"{files_numbers['loader_build_seconds']:.2f}s; parse native "
          f"{files_numbers['native_parse_seconds']:.3f}s, plain "
          f"{files_numbers['plain_parse_seconds']:.3f}s; {files_numbers['tokens_differing']} "
          f"tokens differ (at most {files_numbers['max_ulps']} ulp); get_dataset "
          f"{files_numbers['get_dataset_seconds']:.3f}s -> pool {cc.train_x.shape}, test "
          f"{cc.test_x.shape}, {int(cc.train_y.sum())} positives in the pool")

    # K1 and K2 at the file pool's shapes against their plain versions.
    pool_f = torch.from_numpy(cc.train_x).to(dev)
    test_f = torch.from_numpy(cc.test_x).to(dev)
    lab_f = torch.zeros(n_tr, dtype=torch.bool, device=dev)
    lab_f[torch.from_numpy(np.random.default_rng(args.seed).choice(n_tr, N_START,
                                                                    replace=False)).to(dev)] = True
    binned_f = trees_train.make_bins(pool_f, BINS)
    ff, fth, fv = trees_train.fit_forest_device(
        binned_f.codes, torch.from_numpy(cc.train_y).to(dev), lab_f.to(torch.float32),
        binned_f.edges, prng.key(args.seed + 12), n_trees=TREES, max_depth=DEPTH, n_bins=BINS)
    gf_file = trees_train.heap_gemm_forest(ff, fth, fv, DEPTH)
    for label, x in (("file pool", pool_f), ("file test", test_f)):
        check_k1(gf_file, x, label)
    heap_f = trees_pallas.heap_operands(gf_file)
    table_f = round_fused.score_table(TREES, "uncertainty", dev)
    sel_f = ~lab_f
    tv, ti = round_fused._launch_megakernel(heap_f, pool_f, sel_f, table_f, WINDOW)
    pv, pi = round_fused.megakernel_plain(gf_file, pool_f, sel_f, table_f, WINDOW)
    torch.cuda.synchronize()
    if not (torch.equal(tv, pv) and torch.equal(ti, pi)):
        fail("round_megakernel != plain per-tile candidates at the file pool")
    finite = torch.isfinite(pv)
    k2_err = max(k2_err, float(torch.where(finite, tv - pv, 0.0).abs().max()))
    # Times at these shapes; bounds as phase 5 states them (the heap forest,
    # the rows and the outputs moved once; a compare a level, K2 one more).
    k1_file = {}
    for label, x in (("pool", pool_f), ("test", test_f)):
        lim, by = bound(nbytes(x, heap_f.nodes, heap_f.val) + TREES * x.shape[0] * 4,
                        x.shape[0] * TREES * DEPTH)
        k1_file[label] = dict(
            ms=cuda_ms(lambda: trees_pallas._launch_leaves(heap_f, x), reps=9),
            device_ms=graph_ms(lambda: trees_pallas._launch_leaves(heap_f, x)),
            plain_ms=cuda_ms(lambda: trees_pallas.predict_leaves_plain(gf_file, x), reps=3),
            bound_ms=lim, bound_by=by)
    kk_f = tv.shape[1]
    lim, by = bound(nbytes(pool_f, heap_f.nodes, heap_f.val, sel_f, table_f)
                    + -(-n_tr // round_fused.TILE_ROWS) * kk_f * 8, n_tr * TREES * (DEPTH + 1))
    k2_file = dict(
        ms=cuda_ms(lambda: round_fused._launch_megakernel(heap_f, pool_f, sel_f, table_f, WINDOW),
                   reps=9),
        device_ms=graph_ms(lambda: round_fused._launch_megakernel(heap_f, pool_f, sel_f, table_f,
                                                                  WINDOW)),
        plain_ms=cuda_ms(lambda: round_fused.megakernel_plain(gf_file, pool_f, sel_f, table_f,
                                                              WINDOW), reps=3),
        bound_ms=lim, bound_by=by)
    files_numbers["k1_ms"], files_numbers["k2_ms"] = k1_file, k2_file
    print(f"# forest_leaves and round_megakernel at the file pool ({n_tr} x {N_FEAT}) and test "
          f"set ({n_te}): bit-equal to plain; K1 pool {k1_file['pool']['device_ms']:.4f} ms "
          f"device (plain {k1_file['pool']['plain_ms']:.4f}, bound "
          f"{k1_file['pool']['bound_ms']:.4f} by {k1_file['pool']['bound_by']}), test "
          f"{k1_file['test']['device_ms']:.4f} (bound {k1_file['test']['bound_ms']:.4f}); K2 pool "
          f"{k2_file['device_ms']:.4f} ms device (plain {k2_file['plain_ms']:.4f}, bound "
          f"{k2_file['bound_ms']:.4f} by {k2_file['bound_by']}) ({kind}, {smi})")
    del pool_f, test_f, binned_f, gf_file, heap_f, tv, ti, pv, pi

    # The reference's forest on the file pool: fused (K2, K1 for eval),
    # unfused (K1 twice a round) and chunked (K = 4, fused; one eager warm-up
    # round, then K rounds a replay).
    n_file_chunks = -(-ROUNDS // K)
    want_launches["files"] = dict(want_launches["fused"])
    want_launches["files_unfused"] = dict(want_launches["unfused"])
    rounds_run = 1 + n_file_chunks * K
    want_launches["files_chunked"] = {"forest_leaves": rounds_run, "round_megakernel": rounds_run,
                                      "fused_votes": 0, "ring_hop": 0}
    drive("files", True, data=cc)
    drive("files_unfused", False, data=cc)
    drive("files_chunked", True, data=cc, rounds_per_launch=K, pipeline_depth=1)
    file_recs = {p: [(r.round, r.n_labeled, r.accuracy) for r in runs[p].records]
                 for p in ("files", "files_unfused", "files_chunked")}
    if len({tuple(v) for v in file_recs.values()}) != 1:
        fail(f"file-pool records differ across fused, unfused and chunked: {file_recs}")
    if [r[1] for r in file_recs["files"]] != want:
        fail(f"file-pool n_labeled {[r[1] for r in file_recs['files']]} != {want}")
    if not all(np.isfinite(r[2]) and 0.0 <= r[2] <= 1.0 for r in file_recs["files"]):
        fail("file-pool accuracy records are not finite fractions")
    file_mask = runs["files"].final_labeled_mask
    for p in ("files_unfused", "files_chunked"):
        if not torch.equal(runs[p].final_labeled_mask, file_mask):
            fail(f"{p} final labeled mask differs from the fused run's")
    if int(file_mask.sum()) != n_final:
        fail(f"the file-pool final mask holds {int(file_mask.sum())} rows, want {n_final}")
    files_numbers["rounds"] = {p: [dict(fit=r.train_time, round=r.score_time, eval=r.eval_time,
                                        total=r.total_time) for r in runs[p].records]
                               for p in ("files", "files_unfused", "files_chunked")}
    files_numbers["accuracy"] = [r[2] for r in file_recs["files"]]
    print(f"# file pool ({n_tr} x {N_FEAT}, {TREES} trees, depth {DEPTH}): fused == unfused == "
          f"chunked (records and final {n_tr}-row mask); launches {launches['files']} fused, "
          f"{launches['files_unfused']} unfused, {launches['files_chunked']} chunked")

    # Small runs of the other registry entries: the card equals the CPU.
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                            "reference_data")
    small_runs = {
        # The committed striatum_like scale runs' configuration (seed 3).
        "striatum_like": (ExperimentConfig(
            data=DataConfig(name="striatum_like", seed=3),
            forest=ForestConfig(n_trees=20, max_depth=8, fit="device", kernel="pallas"),
            strategy=StrategyConfig(name="uncertainty", window_size=10),
            n_start=10, max_rounds=3, fused_round=True, seed=3), {"forest_leaves": 3,
                                                                   "round_megakernel": 3}),
        # Four classes: the fused round refuses them (as in JAX); K1 2 x C a round.
        "blobs4": (ExperimentConfig(
            data=DataConfig(name="blobs4", seed=1),
            forest=ForestConfig(n_trees=8, max_depth=4, fit="device", kernel="pallas"),
            strategy=StrategyConfig(name="uncertainty", window_size=15),
            n_start=10, max_rounds=3, seed=1), {"forest_leaves": 24, "round_megakernel": 0}),
        "checkerboard2x2_file": (ExperimentConfig(
            data=DataConfig(name="checkerboard2x2_file", path=fixtures),
            forest=ForestConfig(n_trees=8, max_depth=4, fit="device", kernel="pallas"),
            strategy=StrategyConfig(name="uncertainty", window_size=15),
            n_start=10, max_rounds=3, fused_round=True), {"forest_leaves": 3,
                                                          "round_megakernel": 3}),
    }
    for name, (c, want_k) in small_runs.items():
        path = f"files_{name}"
        zero_counts()
        on_card = loop.run_experiment(c, device=dev)
        launches[path] = counts()
        if {k_: launches[path][k_] for k_ in want_k} != want_k:
            fail(f"{path} launched {launches[path]}, want {want_k}")
        on_cpu = loop.run_experiment(c, device="cpu")
        if on_card.to_reference_log() != on_cpu.to_reference_log() or not torch.equal(
                on_card.final_labeled_mask.cpu(), on_cpu.final_labeled_mask):
            fail(f"{name} on the card != the CPU run:\n{on_card.to_reference_log()}\n"
                 f"{on_cpu.to_reference_log()}")
        print(f"# {name}: card == CPU (records and final mask), launches {launches[path]}, "
              f"final accuracy {on_card.final_accuracy:.4f}")

    # The LAL regressor's training rows: JAX's defaults on the card, timed;
    # card == CPU at 4 experiments.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lal_x, lal_t = lal_training.generate_lal_dataset(device=dev)
    files_numbers["lal_generate_seconds"] = time.perf_counter() - t0
    files_numbers["lal_rows"] = int(lal_x.shape[0])
    if lal_x.shape[1] != 5 or not (np.isfinite(lal_x).all() and np.isfinite(lal_t).all()):
        fail(f"generate_lal_dataset gave {lal_x.shape} rows, or non-finite values")
    few = dict(seed=args.seed, n_experiments=4)
    card_rows = lal_training.generate_lal_dataset(**few, device=dev)
    cpu_rows = lal_training.generate_lal_dataset(**few, device="cpu")
    for a_, b_ in zip(card_rows, cpu_rows):
        if a_.shape != b_.shape or not np.array_equal(a_.view(np.int32), b_.view(np.int32)):
            fail("generate_lal_dataset rows on the card != the CPU's")
    print(f"# generate_lal_dataset (60 experiments x 8 candidates, pool 200, 10 trees of depth "
          f"6): {files_numbers['lal_rows']} rows in {files_numbers['lal_generate_seconds']:.2f}s "
          f"on the card; 4 experiments card == CPU ({kind}, {smi})")
    shutil.rmtree(data_dir)
    print(f"# phase 4m: {time.perf_counter() - t_phase:.1f}s")

    # -- phase 4q: the mesh, whole -----------------------------------------------
    # Every path of this slice on the 4 x 2 mesh placed on the one card, each
    # held against the single-device run an earlier phase made (4b, 4c, 4d,
    # 4e, 4f, 4i, 4j, 4k, 4l).
    t_phase = time.perf_counter()
    M42 = MeshConfig(4, 2)
    mesh_numbers = {"seconds": {}}
    q_sec = mesh_numbers["seconds"]

    def recs3(res):
        return [(r.round, r.n_labeled, r.accuracy) for r in res.records]

    def metrics_close(a, b, mass=False):
        """RoundMetrics equal field by field, pool_entropy to
        POOL_ENTROPY_RTOL (a float sum over the pool, padded by one row on
        the mesh), and with ``mass`` the four score fields to twice
        MASS_RTOL of the largest |score| (the sharded mass sums its pooled
        vector in shard order)."""
        for ra, rb in zip(a, b, strict=True):
            scale = max(abs(rb.metrics[f]) for f in ("score_min", "score_max")) or 1.0
            for field, v in rb.metrics.items():
                got_ = ra.metrics[field]
                if field == "pool_entropy":
                    ok_ = abs(got_ - v) <= telemetry.POOL_ENTROPY_RTOL * abs(v)
                elif mass and field in ("score_min", "score_mean", "score_max", "score_margin"):
                    ok_ = abs(got_ - v) <= 2 * similarity.MASS_RTOL * scale
                else:
                    ok_ = got_ == v
                if not ok_:
                    return False
        return True

    def mesh_drive(path, c, want, data=None):
        zero_counts()
        t0 = time.perf_counter()
        res = loop.run_experiment(c, bundle=data or bundle, device=dev, devices=one_card)
        torch.cuda.synchronize()
        q_sec[path] = time.perf_counter() - t0
        launches[path] = counts()
        runs[path] = res
        want_launches[path] = want
        if launches[path] != want:
            fail(f"{path} launched {launches[path]}, want {want}")
        return res

    # (a) The chunk under the mesh, fused and unfused: 4c's shape (K = 4, 6
    # rounds: one eager warm-up round, then 2 replays of 4 rounds).
    rounds_run = 1 + n_chunks * K
    for fused in (True, False):
        name = "fused" if fused else "unfused"
        path = f"mesh_chunked_{name}"
        want = dict(zero, forest_leaves=(8 if fused else 16) * rounds_run,
                    fused_votes=8 * rounds_run if fused else 0,
                    ring_hop=3 * rounds_run if fused else 0)
        res = mesh_drive(path, cfg(fused, mesh=(4, 2), max_rounds=CHUNK_ROUNDS,
                                   rounds_per_launch=K), want)
        ref = runs[f"chunked_{name}_depth1"]
        if recs3(res) != recs3(ref) or not torch.equal(res.final_labeled_mask,
                                                       ref.final_labeled_mask):
            fail(f"{path} differs from phase 4c's single-device chunked run: {recs3(res)} vs "
                 f"{recs3(ref)}")
        # 4b's runs fit a 3-round window (the fit's bootstrap draw depends on
        # its size): a 3-round chunk (one replay, 3 rounds active) fits it.
        three = loop.run_experiment(cfg(fused, mesh=(4, 2), rounds_per_launch=K), bundle=bundle,
                                    device=dev, devices=one_card)
        if recs3(three) != recs3(runs[f"mesh_{name}"]) or not torch.equal(
                three.final_labeled_mask, runs[f"mesh_{name}"].final_labeled_mask):
            fail(f"the {ROUNDS}-round {path} differs from phase 4b's per-round mesh run")
        g = res.graph_stats
        if g is None or g["mode"] != "graph" or (g["captures"], g["replays"]) != (1, n_chunks):
            fail(f"{path}: graph {g}, want mode 'graph', 1 capture and {n_chunks} replays")
        per_round = {k_: v / rounds_run for k_, v in launches[path].items()}
        mesh_numbers[path] = dict(
            mode=g["mode"], captures=g["captures"], replays=g["replays"],
            launches_per_replay=g["launches_per_replay"], launches_per_round=per_round,
            capture_seconds=g["capture_seconds"], pool_mib=g["pool_bytes"] / 2**20)
        print(f"#   {path}: == phase 4c (records, final {N_POOL}-row mask), and its {ROUNDS}-round "
              f"twin == phase 4b's per-round mesh run; graph mode {g['mode']}, captures {g['captures']}, replays "
              f"{g['replays']}, launches a replay {g['launches_per_replay']}, a round "
              f"{per_round}; capture {g['capture_seconds']:.3f}s, graph pool "
              f"{g['pool_bytes'] / 2**20:.0f} MiB")
    # Steady seconds a chunked round, rounds 5-12 of 12, depth 1 (as 4c).
    for fused in (True, False):
        name = "fused" if fused else "unfused"
        res = loop.run_experiment(cfg(fused, mesh=(4, 2), max_rounds=TIMED, rounds_per_launch=K,
                                      pipeline_depth=1), bundle=bundle, device=dev,
                                  devices=one_card)
        s_round = statistics.mean(r.total_time for r in res.records[K:])
        mesh_numbers[f"chunked_{name}_steady_seconds_per_round"] = s_round
        print(f"#   mesh chunked {name} steady {s_round:.5f} s a round (rounds {K + 1}-{TIMED}), "
              f"single device (4c) {chunk_times[f'{name}_chunked_depth1']:.5f} s ({kind}, {smi})")

    # (b) RoundMetrics under the mesh: phase 4f's metrics chunk (unfused, as
    # the fused round computes no metrics), 12 rounds of K = 4.
    res = mesh_drive("mesh_metrics_chunked", tel_cfg(max_rounds=TIMED, mesh=(4, 2),
                                                     collect_metrics=True),
                     dict(zero, forest_leaves=16 * (1 + n_replays * K)))
    ref = runs["metrics_chunked"]
    if recs3(res) != recs3(ref) or not metrics_close(res.records, ref.records) or not torch.equal(
            res.final_labeled_mask, ref.final_labeled_mask):
        fail("the mesh metrics chunk differs from phase 4f's (records, RoundMetrics, mask)")
    pe = max(abs(a.metrics["pool_entropy"] - b.metrics["pool_entropy"])
             / abs(b.metrics["pool_entropy"]) for a, b in zip(res.records, ref.records))
    mesh_numbers["metrics_pool_entropy_max_rel"] = pe
    print(f"#   mesh metrics chunk == phase 4f's (records, mask, RoundMetrics; pool_entropy "
          f"within {pe:.2e} relative, POOL_ENTROPY_RTOL {telemetry.POOL_ENTROPY_RTOL})")

    # (c) Per round, each against its single-device run: 3 rounds of the
    # gemm form (its reference run here), depth 12 (4d), density (4e) and
    # LAL (4i); the noisy oracle's 8 (4l's family).
    gemm_forest = dataclasses.replace(cfg(False).forest, kernel="gemm")
    zero_counts()
    gemm_ref = loop.run_experiment(cfg(False, forest=gemm_forest), bundle=bundle, device=dev)
    per_round_cases = (
        ("mesh_gemm", cfg(False, mesh=(4, 2), forest=gemm_forest), gemm_ref, dict(zero)),
        ("mesh_gather_deep", cfg(False, mesh=(4, 2), forest=deep_forest), runs["gather_deep"],
         dict(zero)),
        ("mesh_density", cfg(False, mesh=(4, 2), strategy=density), runs["density"],
         dict(zero, forest_leaves=16 * ROUNDS)),
        ("mesh_lal", cfg(False, mesh=(4, 2), strategy=lal_cfg), runs["lal"],
         dict(zero, forest_leaves=16 * ROUNDS)),
        # 4l's run: 8 rounds (the fit window is the 8-round run's).
        ("mesh_noisy_oracle", dataclasses.replace(scn_cfg, mesh=M42,
                                                  scenario=families["noisy_oracle"]),
         scn_runs["noisy_oracle"], dict(zero, forest_leaves=16 * SCN_ROUNDS)),
    )
    for path, c, ref, want in per_round_cases:
        res = mesh_drive(path, c, want)
        ref_recs = recs3(ref)
        same_mask = torch.equal(res.final_labeled_mask, ref.final_labeled_mask)
        if recs3(res) != ref_recs or not same_mask:
            if path == "mesh_density":  # the watched boundary tie (ROADMAP queue 3)
                print(f"#   {path}: DIFFERS from phase 4e's run (the density tie): "
                      f"{recs3(res)} vs {ref_recs}")
                mesh_numbers["density_differs"] = True
            else:
                fail(f"{path} differs from its single-device run: {recs3(res)} vs {ref_recs}")
        if path == "mesh_noisy_oracle" and not metrics_close(res.records, ref.records):
            fail(f"{path}: RoundMetrics differ from phase 4l's")
        mesh_numbers[path] = [dict(fit=r.train_time, round=r.score_time, eval=r.eval_time)
                              for r in res.records]
        print(f"#   {path}: == its single-device run ({len(res.records)} rounds); launches "
              f"{launches[path]}; per round (fit, round, eval) s: "
              + ", ".join(f"({r.train_time:.4f}, {r.score_time:.4f}, {r.eval_time:.4f})"
                          for r in res.records))
    import importlib.util

    if importlib.util.find_spec("sklearn") is None:
        print("#   mesh host fit: NOT RUN (this machine has no scikit-learn; the CPU tests hold "
              "it against the JAX package)")

    # (d) The sweep (4j: E = 8) and the grid (4k: 12 cells) under the mesh:
    # 16 K1 launches a round step (8 shards, pool and test set).
    zero_counts()
    t0 = time.perf_counter()
    m_swept = sweep_lib.run_sweep(dataclasses.replace(sweep_cfg, mesh=M42), sweep_seeds,
                                  bundle=bundle, device=dev, devices=one_card)
    torch.cuda.synchronize()
    q_sec["mesh_sweep"] = time.perf_counter() - t0
    launches["mesh_sweep"] = counts()
    want_launches["mesh_sweep"] = dict(zero, forest_leaves=16 * (1 + n_sweep_chunks * K))
    if launches["mesh_sweep"] != want_launches["mesh_sweep"]:
        fail(f"mesh sweep launched {launches['mesh_sweep']}, want {want_launches['mesh_sweep']}")
    for s_, a, b in zip(sweep_seeds, m_swept, swept, strict=True):
        if recs3(a) != recs3(b) or not metrics_close(a.records, b.records) or not torch.equal(
                a.final_labeled_mask, b.final_labeled_mask):
            fail(f"mesh sweep seed {s_} differs from phase 4j's sweep")
    g = m_swept[0].graph_stats
    mesh_numbers["sweep"] = dict(
        steady_seconds_per_experiment_round=steady(m_swept[0]), mode=g["mode"],
        capture_seconds=g["capture_seconds"], pool_mib=g["pool_bytes"] / 2**20,
        k1_launches_per_replay=g["launches_per_replay"]["trees_pallas.launches"])
    print(f"#   mesh sweep (E = {E_SWEEP}) == phase 4j (records, RoundMetrics, masks); steady "
          f"{mesh_numbers['sweep']['steady_seconds_per_experiment_round']:.5f} s an "
          f"experiment-round (4j: {sweep_numbers['steady_seconds_per_experiment_round']:.5f}); "
          f"graph {g['mode']}, K1 {mesh_numbers['sweep']['k1_launches_per_replay']} a replay")
    zero_counts()
    t0 = time.perf_counter()
    m_grid = sweep_lib.run_grid(dataclasses.replace(grid_cfg, mesh=M42), GRID_STRATEGIES,
                                grid_seeds, datasets=["bench_pool"], bundles={"bench_pool": bundle},
                                device=dev, devices=one_card)
    torch.cuda.synchronize()
    q_sec["mesh_grid"] = time.perf_counter() - t0
    launches["mesh_grid"] = counts()
    want_launches["mesh_grid"] = dict(zero, forest_leaves=16 * (1 + n_grid_chunks * K))
    if launches["mesh_grid"] != want_launches["mesh_grid"]:
        fail(f"mesh grid launched {launches['mesh_grid']}, want {want_launches['mesh_grid']}")
    for a, b in zip(m_grid.cells, grid_cells_4k, strict=True):
        dens = a.strategy == "density"
        same = recs3(a.result) == recs3(b.result) and torch.equal(
            a.result.final_labeled_mask, b.result.final_labeled_mask)
        if same and not metrics_close(a.result.records, b.result.records, mass=dens):
            fail(f"mesh grid cell {a.strategy}/seed {a.seed}: RoundMetrics differ from 4k's")
        if not same:
            if not dens:
                fail(f"mesh grid cell {a.strategy}/seed {a.seed} differs from phase 4k's")
            print(f"#   mesh grid cell density/seed {a.seed}: DIFFERS from phase 4k's (the "
                  f"density tie): {recs3(a.result)} vs {recs3(b.result)}")
            mesh_numbers["density_differs"] = True
    g = m_grid.graph_stats
    mesh_numbers["grid"] = dict(
        steady_seconds_per_cell_round=statistics.mean(steady(c.result) for c in m_grid.cells),
        mode=g["mode"], capture_seconds=g["capture_seconds"], pool_mib=g["pool_bytes"] / 2**20,
        recompiles_after_warmup=m_grid.recompiles_after_warmup)
    print(f"#   mesh grid ({len(m_grid.cells)} cells) == phase 4k (records, masks, RoundMetrics; "
          f"density's score fields to MASS_RTOL); steady "
          f"{mesh_numbers['grid']['steady_seconds_per_cell_round']:.5f} s a cell-round (4k: "
          f"{grid_numbers['steady_seconds_per_cell_round']:.5f}); graph {g['mode']}")

    # (e) The chunk spread over the visible cards (shard (s, m) on card
    # (s + m) mod n): the mode that ran.
    if n_cards >= 2:
        spread = [torch.device("cuda", (s_ + m) % n_cards) for s_ in range(4) for m in range(2)]
        for fused in (True, False):
            res = loop.run_experiment(cfg(fused, mesh=(4, 2), max_rounds=CHUNK_ROUNDS,
                                          rounds_per_launch=K), bundle=bundle, device=dev,
                                      devices=spread)
            ref = runs[f"chunked_{'fused' if fused else 'unfused'}_depth1"]
            if recs3(res) != recs3(ref) or not torch.equal(res.final_labeled_mask.to(dev),
                                                           ref.final_labeled_mask):
                fail(f"the chunk spread over {n_cards} cards (fused={fused}) differs")
            mesh_numbers[f"cards_{'fused' if fused else 'unfused'}_mode"] = (
                res.graph_stats["mode"], res.graph_stats["mode_reason"])
            print(f"#   mesh chunk across {n_cards} cards (fused={fused}) == 4c; mode "
                  f"{res.graph_stats['mode']}: {res.graph_stats['mode_reason']}")
    else:
        print("#   mesh chunk across cards: NOT RUN (one card visible)")

    # (f) A small checkerboard chunked mesh run: card == CPU (plain versions).
    for fused in (True, False):
        c = dataclasses.replace(small_mesh, fused_round=fused, rounds_per_launch=2)
        on_card = loop.run_experiment(c, device=dev, devices=one_card)
        on_cpu = loop.run_experiment(c, device="cpu")
        if on_card.to_reference_log() != on_cpu.to_reference_log() or not torch.equal(
                on_card.final_labeled_mask.cpu(), on_cpu.final_labeled_mask):
            fail(f"small chunked mesh run (fused={fused}) on the card != CPU")
    print("#   small checkerboard chunked mesh run 4 x 2 (K = 2): card == CPU, fused and unfused")
    q_sec["total"] = time.perf_counter() - t_phase
    print(f"# phase 4q: {q_sec['total']:.1f}s ({', '.join(f'{k_} {v:.1f}' for k_, v in q_sec.items() if k_ != 'total')})")

    # -- phase 4n: the neural path -------------------------------------------
    lv.transposed_launches = lv.segmented_launches = 0
    neural_numbers = neural_phase(args.seed, dev, kind, smi, counts, zero_counts)
    neural_k56 = {"forest_leaves_transposed": lv.transposed_launches,
                  "forest_leaves_segmented": lv.segmented_launches}
    if any(neural_k56.values()):
        fail(f"the neural path launched K5 or K6: {neural_k56}")
    for path, c in neural_numbers["launches"].items():
        launches[path] = {k: c[k] for k in counts()}

    # -- phase 4o: the streaming service -------------------------------------
    serving_numbers = serving_phase(args.seed, dev, kind, smi, counts, zero_counts)
    launches.update(serving_numbers["launches"])

    # -- phase 4p: the serve fleet -------------------------------------------
    fleet_numbers = fleet_phase(args.seed, dev, kind, smi)
    for path, c in fleet_numbers["launches"].items():
        launches[path] = {k: c[k] for k in counts()}

    # -- phase 4r: the neural mesh, ring attention, the pod --------------------
    pod_numbers = mesh_pod_phase(args.seed, dev, kind, smi, counts, zero_counts, neural_numbers,
                                 gf, pool_np)
    for path, c in pod_numbers["launches"].items():
        launches[path] = {k: c[k] for k in counts()}
        if "threefry" in c:
            neural_numbers["launches"][path] = c

    # -- phase 4s: the mesh over processes --------------------------------------
    mp_numbers = multi_process_phase(
        args.seed, dev, kind, smi,
        lambda **kw: loop.run_experiment(cfg(True, **kw), bundle=bundle,
                                         debugger=Debugger(enabled=False), device=dev),
        recs[True], masks[True], neural_numbers, gf, pod_numbers["pod"]["trace"])
    for path, c in mp_numbers["launches"].items():
        launches[path] = {k: c[k] for k in counts()}
        if path == "procs2_neural":
            neural_numbers["launches"][path] = c

    # -- phase 4t: the pre-flight ------------------------------------------------
    preflight_numbers = preflight_phase(args.seed, dev, kind, smi, counts, zero_counts)
    launches["preflight_audit"] = preflight_numbers["audit"]["launches"]

    # -- phase 5: times ----------------------------------------------------
    x_full = pool.contiguous()
    out_bytes = TREES * N_POOL * 4
    T = gf.n_trees
    depth = gf.value.shape[1].bit_length() - 1  # a heap forest: L = 2 ** depth
    # The least work of the leaf function: a row reaches its leaf in a tree
    # by one compare per level of its root-to-leaf path; the bytes count the
    # forest in its heap form.
    k1_ops = N_POOL * T * depth
    k1 = {}
    for label, (g, x) in (("pool", (gf, x_full)), ("test", (gf, test_x.contiguous())),
                          ("mesh shard", (gf_shard, pool[:n_shard].contiguous()))):
        h = trees_pallas.heap_operands(g)
        ms = cuda_ms(lambda: trees_pallas._launch_leaves(h, x), reps=9)
        dev_ms = graph_ms(lambda: trees_pallas._launch_leaves(h, x))
        plain = cuda_ms(lambda: trees_pallas.predict_leaves_plain(g, x), reps=3)
        walk_plain = cuda_ms(lambda: trees_pallas.walk_leaves_plain(h, x), reps=3)
        lim, by = bound(nbytes(x, h.nodes, h.val) + g.n_trees * x.shape[0] * 4,
                        x.shape[0] * g.n_trees * depth)
        k1[label] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain, walk_plain_ms=walk_plain,
                         bound_ms=lim, bound_by=by)
        print(f"# time forest_leaves {label} (n={x.shape[0]}, T={g.n_trees}): {ms:.4f} ms kernel "
              f"({dev_ms:.4f} ms device, graph-replayed), "
              f"{plain:.4f} ms plain, {walk_plain:.4f} ms walk_leaves_plain, bound {lim:.4f} ms "
              f"by {by} ({100 * lim / dev_ms:.3f}% of it in device time; launch "
              f"{trees_pallas.leaves_launch_config(h, *x.shape, dev)}; {kind}, {smi})")
    # K1 on phase 2d's host-fit heaps: the same kernel and shapes as the
    # device-fit forest at the pool, other trees.
    hh = host_pf.heap
    h_ms = cuda_ms(lambda: trees_pallas._launch_leaves(hh, x_full), reps=9)
    h_dev = graph_ms(lambda: trees_pallas._launch_leaves(hh, x_full))
    h_plain = cuda_ms(lambda: trees_pallas.predict_leaves_plain(host_pf.gf, x_full), reps=3)
    k1["host-fit heaps"] = dict(ms=h_ms, device_ms=h_dev, plain_ms=h_plain,
                                bound_ms=k1["pool"]["bound_ms"], bound_by=k1["pool"]["bound_by"])
    print(f"# time forest_leaves on the host-fit heaps (n={N_POOL}, T={TREES}, depth {DEPTH}): "
          f"{h_ms:.4f} ms kernel ({h_dev:.4f} ms device, graph-replayed; the device-fit forest "
          f"{k1['pool']['device_ms']:.4f}), {h_plain:.4f} ms plain ({kind}, {smi})")
    # K1 over the stacked forest of a sweep's round step: 8 forests of 100
    # trees as one of 800 (one launch) against 8 single calls; the stacked
    # leaves must equal each single call's bit for bit.
    binned_s = trees_train.make_bins(train_x, BINS)
    heaps8 = []
    for i in range(8):
        f, th, v = trees_train.fit_forest_device(
            binned_s.codes, train_y, torch.ones(N_START, device=dev), binned_s.edges,
            prng.key(args.seed + 100 + i), n_trees=TREES, max_depth=DEPTH, n_bins=BINS)
        heaps8.append(trees_pallas.heap_operands(trees_train.heap_gemm_forest(f, th, v, DEPTH)))
    stacked = trees_pallas.stack_heaps(heaps8)
    got_stacked = trees_pallas._launch_leaves(stacked, x_full)
    for i, h in enumerate(heaps8):
        if not torch.equal(got_stacked[i * TREES:(i + 1) * TREES],
                           trees_pallas._launch_leaves(h, x_full)):
            fail(f"stacked forest_leaves != the single call of forest {i}")
    if not torch.equal(got_stacked.T, trees_pallas.walk_leaves_plain(stacked, x_full)):
        fail("stacked forest_leaves != walk_leaves_plain of the stacked heaps")
    del got_stacked
    s_ms = cuda_ms(lambda: trees_pallas._launch_leaves(stacked, x_full), reps=9)
    s_dev = graph_ms(lambda: trees_pallas._launch_leaves(stacked, x_full))
    sep_ms = cuda_ms(lambda: [trees_pallas._launch_leaves(h, x_full) for h in heaps8], reps=9)
    sep_dev = graph_ms(lambda: [trees_pallas._launch_leaves(h, x_full) for h in heaps8], inner=5)
    s_plain = cuda_ms(lambda: trees_pallas.walk_leaves_plain(stacked, x_full), reps=3)
    s_lim, s_by = bound(nbytes(x_full, stacked.nodes, stacked.val) + 8 * TREES * N_POOL * 4,
                        N_POOL * 8 * TREES * depth)
    k1["stacked 8 x 100"] = dict(ms=s_ms, device_ms=s_dev, eight_single_ms=sep_ms,
                                 eight_single_device_ms=sep_dev, plain_ms=s_plain,
                                 bound_ms=s_lim, bound_by=s_by,
                                 launch_config=trees_pallas.leaves_launch_config(
                                     stacked, N_POOL, N_FEAT, dev))
    print(f"# time forest_leaves stacked (8 forests of {TREES} trees as {8 * TREES}, n={N_POOL}): "
          f"{s_ms:.4f} ms kernel ({s_dev:.4f} ms device, graph-replayed) against 8 single calls "
          f"{sep_ms:.4f} ms ({sep_dev:.4f} ms device); {s_plain:.4f} ms walk_leaves_plain; bound "
          f"{s_lim:.4f} ms by {s_by}; bit-equal to the single calls ({kind}, {smi})")
    del heaps8, stacked
    k1_ms, k1_plain = k1["pool"]["ms"], k1["pool"]["plain_ms"]
    k1_bound, k1_by = k1["pool"]["bound_ms"], k1["pool"]["bound_by"]
    # K2 and K3: bytes are x once, the forest's heap form once (nodes, and
    # the leaf values the vote bits come from), the mask and the table (K2)
    # and what is written (K2's per-tile candidates, K3's [n] int32 votes);
    # the least work is the walk and the vote per (row, tree). Each is also
    # timed at the streamed shape.
    table = round_fused.score_table(TREES, "uncertainty", dev)
    kk = min(WINDOW, round_fused.TILE_ROWS)

    def time_votes(name, g, x, with_plain=True):
        h = trees_pallas.heap_operands(g)
        sel = selectable[:x.shape[0]]
        tab = round_fused.score_table(g.n_trees, "uncertainty", dev)
        plain = walk_plain = float("nan")
        if name == "round_megakernel":
            def launch():
                return round_fused._launch_megakernel(h, x, sel, tab, WINDOW)
            if with_plain:
                plain = cuda_ms(lambda: round_fused.megakernel_plain(g, x, sel, tab, WINDOW),
                                reps=3)
                walk_plain = cuda_ms(lambda: round_fused.tile_topk_plain(
                    round_fused.walk_votes_plain(h, x), sel, tab, WINDOW), reps=3)
            io = nbytes(sel, tab) + -(-x.shape[0] // round_fused.TILE_ROWS) * kk * 8
        else:
            def launch():
                return round_fused._launch_votes(h, x)
            if with_plain:
                plain = cuda_ms(lambda: round_fused.fused_votes_plain(g, x), reps=3)
                walk_plain = cuda_ms(lambda: round_fused.walk_votes_plain(h, x), reps=3)
            io = 4 * x.shape[0]
        lim, by = bound(nbytes(x, h.nodes, h.val) + io, x.shape[0] * g.n_trees * (depth + 1))
        ms = cuda_ms(launch, reps=9)
        dev_ms = graph_ms(launch)
        cfg0 = round_fused.launch_config(name, h, *x.shape, dev)
        print(f"# time {name} (n={x.shape[0]}, T={g.n_trees}): {ms:.4f} ms kernel ({dev_ms:.4f} "
              f"ms device, graph-replayed), {plain:.4f} ms plain, {walk_plain:.4f} ms walk plain, "
              f"bound {lim:.4f} ms by {by} ({100 * lim / dev_ms:.3f}% of it in device time); "
              f"launch {cfg0} ({kind}, {smi})")
        return dict(ms=ms, device_ms=dev_ms, plain_ms=plain, walk_plain_ms=walk_plain,
                    bound_ms=lim, bound_by=by, launch_config=cfg0)

    k2 = {"pool": time_votes("round_megakernel", gf, x_full),
          "streamed 256 trees": time_votes("round_megakernel", gf256, x_full)}
    k2_ms, k2_plain = k2["pool"]["ms"], k2["pool"]["plain_ms"]
    k2_bound, k2_by = k2["pool"]["bound_ms"], k2["pool"]["bound_by"]
    # The fused round's tile merge: a stable sort of n_tiles x k candidates.
    tv, ti = round_fused._launch_megakernel(heap, x_full, selectable, table, WINDOW)
    merge_ms = cuda_ms(lambda: merge_tile_topk(tv, ti, WINDOW), reps=9)
    merge_dev = graph_ms(lambda: merge_tile_topk(tv, ti, WINDOW))
    k2_dev = k2["pool"]["device_ms"]
    print(f"# time merge_tile_topk ({tv.shape[0]} tiles x {tv.shape[1]} candidates, k={WINDOW}): "
          f"{merge_ms:.4f} ms ({merge_dev:.4f} ms device, graph-replayed: "
          f"{100 * merge_dev / (merge_dev + k2_dev):.1f}% of K2 + merge in device time) "
          f"({kind}, {smi})")
    # K3 at the mesh's per-shard shape (its main path: 71,202 rows x 50
    # trees), at the full width and at the streamed shape.
    k3 = {"shard": time_votes("fused_votes", gf_shard, pool[:n_shard].contiguous()),
          "full": time_votes("fused_votes", gf, x_full),
          "streamed 256 trees": time_votes("fused_votes", gf256, x_full)}
    # K1, K2 and K3 on the quantized payloads at the same shapes, in this
    # run beside the f32 times above; the bound counts the payload at its
    # width (the nodes stay 8-byte words).
    by_payload = {"forest_leaves": {}, "round_megakernel": {}, "fused_votes": {}}
    for mode in PAYLOADS:
        g, g_shard, g256 = qf[mode]["pool"], qf[mode]["shard"], qf[mode]["streamed"]
        k1q = {}
        for label, (g_, x) in (("pool", (g, x_full)), ("test", (g, test_x.contiguous())),
                               ("mesh shard", (g_shard, pool[:n_shard].contiguous()))):
            h = trees_pallas.heap_operands(g_)
            ms = cuda_ms(lambda: trees_pallas._launch_leaves(h, x), reps=9)
            dev_ms = graph_ms(lambda: trees_pallas._launch_leaves(h, x))
            lim, by = bound(nbytes(x, h.nodes, h.val) + g_.n_trees * x.shape[0] * 4,
                            x.shape[0] * g_.n_trees * depth)
            k1q[label] = dict(ms=ms, device_ms=dev_ms, bound_ms=lim, bound_by=by,
                              launch_config=trees_pallas.leaves_launch_config(h, *x.shape, dev))
            if label == "pool":
                k1q[label]["plain_ms"] = cuda_ms(
                    lambda: trees_pallas.predict_leaves_plain(g_, x), reps=3)
            print(f"# time forest_leaves {mode} payload {label} (n={x.shape[0]}, T={g_.n_trees}): "
                  f"{ms:.4f} ms kernel ({dev_ms:.4f} ms device; f32 {k1[label]['device_ms']:.4f}), "
                  f"bound {lim:.4f} ms by {by}; launch {k1q[label]['launch_config']} ({kind}, "
                  f"{smi})")
        by_payload["forest_leaves"][mode] = dict(
            k1q, max_abs_err=payload_err[mode]["forest_leaves"])
        by_payload["round_megakernel"][mode] = dict(
            pool=time_votes("round_megakernel", g, x_full),
            streamed=time_votes("round_megakernel", g256, x_full, with_plain=False),
            max_abs_err=payload_err[mode]["round_megakernel"])
        by_payload["fused_votes"][mode] = dict(
            shard=time_votes("fused_votes", g_shard, pool[:n_shard].contiguous()),
            full=time_votes("fused_votes", g, x_full, with_plain=False),
            streamed=time_votes("fused_votes", g256, x_full, with_plain=False),
            max_abs_err=payload_err[mode]["fused_votes"])
    # K1 on the bench's LAL regressor shape: 2,000 trees of depth 8 over the
    # pool's [284,807, 5] features (the JAX bench converts its regressor for
    # the Pallas kernel; a host fit's trees, packed into heaps).
    h2k = trees_pallas.heap_from_packed(regressor(2000, 8, args.seed + 2000).to(dev))
    feats_c = feats.contiguous()
    got2k = trees_pallas._launch_leaves(h2k, feats_c)
    rows_chk = slice(0, 20_000)
    if not torch.equal(got2k.T[rows_chk], trees_pallas.walk_leaves_plain(h2k, feats_c[rows_chk])):
        fail("forest_leaves on the 2000-tree regressor != walk_leaves_plain")
    del got2k
    r2k_ms = cuda_ms(lambda: trees_pallas._launch_leaves(h2k, feats_c), reps=5)
    r2k_dev = graph_ms(lambda: trees_pallas._launch_leaves(h2k, feats_c), reps=5, inner=5)
    r2k_plain = cuda_ms(lambda: trees_pallas.walk_leaves_plain(h2k, feats_c), reps=1)
    r2k_bound, r2k_by = bound(nbytes(feats_c, h2k.nodes, h2k.val) + 2000 * N_POOL * 4,
                              N_POOL * 2000 * 8)
    k1["lal regressor 2000 x 8"] = dict(
        ms=r2k_ms, device_ms=r2k_dev, plain_ms=r2k_plain, bound_ms=r2k_bound, bound_by=r2k_by,
        launch_config=trees_pallas.leaves_launch_config(h2k, *feats_c.shape, dev))
    print(f"# time forest_leaves, LAL regressor (2000 trees of depth 8 over [{N_POOL}, 5] "
          f"features): {r2k_ms:.4f} ms kernel ({r2k_dev:.4f} ms device), {r2k_plain:.1f} ms "
          f"walk_leaves_plain, bound {r2k_bound:.4f} ms by {r2k_by}; launch "
          f"{k1['lal regressor 2000 x 8']['launch_config']} ({kind}, {smi})")
    del h2k
    # K4: one ring step of the mesh on the card, four k = 100 windows (800
    # bytes read and 800 written each) into preallocated buffers, timed over
    # 100 back-to-back steps; the library yardstick is four Tensor.copy_
    # pairs into the same buffers. A hop is a quarter of a step.
    step_dst = [(torch.empty_like(v), torch.empty_like(i)) for v, i in hop_windows]
    step_ms = cuda_ms(lambda: ring_topk.ring_step(hop_windows, step_dst), reps=9, inner=100)
    step_plain = cuda_ms(lambda: ring_topk.ring_step_plain(hop_windows, step_dst), reps=9,
                         inner=100)
    lib_step_ms = cuda_ms(lambda: [(dv.copy_(v), di.copy_(i))
                                   for (v, i), (dv, di) in zip(hop_windows, step_dst)],
                          reps=9, inner=100)
    hv, hi = hop_windows[0]
    hop_ms = cuda_ms(lambda: ring_topk.hop(hv, hi, dev), reps=9, inner=100)
    n_win = len(hop_windows)
    k4_ms, k4_plain, k4_lib = step_ms / n_win, step_plain / n_win, lib_step_ms / n_win
    k4_bound, k4_by = bound(2 * nbytes(hv, hi), 0)
    print(f"# time ring_step ({n_win} windows, k={WINDOW}, one launch): step_ms {step_ms:.4f}, "
          f"ms a hop {k4_ms:.4f}; plain copies {step_plain:.4f} ms a step; {n_win} Tensor.copy_ "
          f"pairs {lib_step_ms:.4f} ms; a lone hop (fresh buffers) {hop_ms:.4f} ms; bound "
          f"{k4_bound:.7f} ms a hop by {k4_by} ({kind}, {smi})")
    if step_ms > lib_step_ms:
        print(f"# NOTE ring_step ({step_ms:.4f} ms) is slower than {n_win} Tensor.copy_ pairs "
              f"({lib_step_ms:.4f} ms) in this run")
    # K5 and K6 on packed operands at (bn, bt) = (2048, 8), the hi + lo
    # payload. The bound is the function's, as K1's: x^T read once, the
    # forest once in its heap form, the [T, n] f32 output written once; the
    # least work is K1's walk. The bound of the earlier ancestor-count kernels
    # counted the path-matrix operands they read (node slots padded to 32,
    # plus and minus masks, targets, the two payload planes; K6's over 32 S
    # slots), printed beside.
    heap_bytes = nbytes(heap.nodes, heap.val)
    t_pad, L = -(-T // 8) * 8, 2 ** depth
    p5 = lv._prep_transposed(gf, x_full, 2048, 8)
    k5_ms = cuda_ms(lambda: lv._launch_transposed(p5, 2048, 8))
    k5_dev = graph_ms(lambda: lv._launch_transposed(p5, 2048, 8))
    k5_outer_ms = cuda_ms(lambda: lv._launch_transposed(p5, 2048, 8, tree_outer=True))
    k5_outer_dev = graph_ms(lambda: lv._launch_transposed(p5, 2048, 8, tree_outer=True))
    k5_call_ms = cuda_ms(lambda: lv.predict_leaves_transposed(gf, x_full, bn=2048, bt=8))
    k5_plain = cuda_ms(lambda: lv.predict_leaves_transposed_plain(gf, x_full), reps=3)
    k5_walk_plain = cuda_ms(lambda: lv.walk_transposed_plain(p5), reps=3)
    k5_bound, k5_by = bound(nbytes(p5.xT) + heap_bytes + out_bytes, k1_ops)
    i_pad = -(-(L - 1) // 32) * 32
    k5_count_bound, _ = bound(nbytes(p5.xT) + out_bytes + t_pad * (
        8 * i_pad + 8 * L * i_pad // 32 + 4 * L + 4 * L), k1_ops)
    p6 = lv._segmented_operands(gf, pool, 2048, 8)
    k6_ms = cuda_ms(lambda: lv._launch_segmented(p6, 2048, 8))
    k6_dev = graph_ms(lambda: lv._launch_segmented(p6, 2048, 8))
    k6_plain = cuda_ms(lambda: lv._segmented_plain(p6), reps=3)
    k6_walk_plain = cuda_ms(lambda: lv.walk_segmented_plain(p6), reps=3)
    k6_bound, k6_by = bound(nbytes(p6.xT) + heap_bytes + out_bytes, k1_ops)
    k6_count_bound, _ = bound(nbytes(p6.xT) + out_bytes + t_pad * (
        4 * 32 * p6.S + 8 * L * p6.S + 4 * L + 4 * L), k1_ops)
    print(f"# time forest_leaves_transposed (bn 2048, bt 8): {k5_ms:.4f} ms kernel ({k5_dev:.4f} "
          f"ms device, graph-replayed), tree_outer {k5_outer_ms:.4f} ({k5_outer_dev:.4f} device); "
          f"{k5_call_ms:.4f} ms a predict_leaves_transposed call (x^T relayout included); "
          f"{k5_plain:.4f} ms plain, {k5_walk_plain:.4f} ms walk_transposed_plain; bound "
          f"{k5_bound:.4f} ms by {k5_by} ({100 * k5_bound / k5_dev:.3f}% of it in device time; "
          f"ancestor-count operand bound {k5_count_bound:.4f} ms; {kind}, {smi})")
    print(f"# time forest_leaves_segmented (bn 2048, bt 8, S = {p6.S}): {k6_ms:.4f} ms kernel "
          f"({k6_dev:.4f} ms device, graph-replayed), {k6_plain:.4f} ms plain, "
          f"{k6_walk_plain:.4f} ms walk_segmented_plain; bound {k6_bound:.4f} ms by {k6_by} "
          f"({100 * k6_bound / k6_dev:.3f}% of it in device time; ancestor-count operand bound "
          f"{k6_count_bound:.4f} ms; {kind}, {smi})")
    del p5, p6
    t_phase = time.perf_counter()
    # The new paths' evaluation: votes of the depth-12 gather form at the
    # pool (plain PyTorch, no kernel: bytes are x, the five node arrays and
    # the [n] votes; the least work one compare a level per (row, tree)),
    # the similarity mass (x, the mask and the [n] mass), and the host's
    # packing of a host-fit forest into heaps (from the card and back).
    binned_d = trees_train.make_bins(train_x, BINS)
    deep_f = trees_train.heap_packed_forest(*trees_train.fit_forest_device(
        binned_d.codes, train_y, torch.ones(N_START, device=dev), binned_d.edges,
        prng.key(args.seed + DEEP), n_trees=TREES, max_depth=DEEP, n_bins=BINS), DEEP)
    gather_ms = cuda_ms(lambda: forest_eval.votes(deep_f, x_full), reps=5)
    gather_dev = graph_ms(lambda: forest_eval.votes(deep_f, x_full), reps=5, inner=5)
    node_bytes = sum(nbytes(getattr(deep_f, f).contiguous())
                     for f in ("feature", "threshold", "left", "right", "value"))
    gather_bound, gather_by = bound(nbytes(x_full) + node_bytes + 4 * N_POOL, N_POOL * TREES * DEEP)
    print(f"# time forest_eval.votes, gather form (n={N_POOL}, T={TREES}, depth {DEEP}, plain "
          f"PyTorch): {gather_ms:.4f} ms ({gather_dev:.4f} ms device, graph-replayed), bound "
          f"{gather_bound:.4f} ms by {gather_by} ({100 * gather_bound / gather_dev:.3f}% of it in "
          f"device time; {kind}, {smi})")
    mass_ms = cuda_ms(lambda: similarity.similarity_mass(x_full, selectable), reps=9)
    mass_dev = graph_ms(lambda: similarity.similarity_mass(x_full, selectable))
    mass_bound, mass_by = bound(nbytes(x_full, selectable) + 4 * N_POOL, 7 * N_POOL * N_FEAT)
    print(f"# time similarity_mass (n={N_POOL}, d={N_FEAT}): {mass_ms:.4f} ms ({mass_dev:.4f} ms "
          f"device, graph-replayed), bound {mass_bound:.4f} ms by {mass_by} "
          f"({100 * mass_bound / mass_dev:.3f}% of it in device time; {kind}, {smi})")
    pack_times = []
    for _ in range(7):
        t0 = time.perf_counter()
        trees_pallas.heap_from_packed(host_loaded)
        torch.cuda.synchronize()
        pack_times.append(1e3 * (time.perf_counter() - t0))
    pack_ms = statistics.median(pack_times)
    print(f"# time heap_from_packed ({TREES} host-fit-shaped trees, max_depth {DEPTH}, from the "
          f"card to numpy and back): {pack_ms:.3f} ms host, median of 7 ({kind}, {smi})")
    new_paths = {
        "gather_votes": dict(ms=gather_ms, device_ms=gather_dev, bound_ms=gather_bound,
                             bound_by=gather_by, depth=DEEP),
        "similarity_mass": dict(ms=mass_ms, device_ms=mass_dev, bound_ms=mass_bound,
                                bound_by=mass_by, card_vs_cpu_over_max=mass_err),
        "heap_pack_host_ms": pack_ms,
        "rounds": {p: [dict(fit=r.train_time, round=r.score_time, eval=r.eval_time)
                       for r in runs[p].records] for p in ("gather_deep", "density")},
    }
    del deep_f, binned_d
    print(f"# phase 5, the new paths' times: {time.perf_counter() - t_phase:.1f}s")
    for fused in (True, False):
        profile_round(loop, cfg(fused), bundle, dev, "fused" if fused else "unfused")
    profile_round(loop, cfg(True, (4, 2)), bundle, dev, "mesh 4 x 2 fused", devices=one_card)

    # -- phase 6: the port's bench ------------------------------------------
    # The lal mode's regressor at the JAX bench's shape (2,000 trees of depth
    # 8) as a forest file: the card's machine has no scikit-learn to fit it.
    bench_lal_path = lal_file("lal_bench_2000x8.npz", 2000, 8, args.seed + 2008,
                              ((0, 1), (0, 0.5), (0, 1), (0, 0.5), (50, 150)))
    lal_bench_launches = None
    bench_batched = {}
    for mode, extra in (("score", []), ("round", []), ("variants", ["--variants", "v0,v1,v8,r1"]),
                        ("lal", ["--lal-model", bench_lal_path]), ("sweep", ["--no-baseline"]),
                        ("grid", ["--no-baseline"]),
                        ("neural", ["--neural-pool", "200", "--train-steps", "25"])):
        if mode == "variants":
            lv.transposed_launches = lv.segmented_launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = bench.main(["--mode", mode, *extra])
        lines = out.getvalue().splitlines()
        if rc != 0 or len(lines) != 1:
            fail(f"bench --mode {mode} exited {rc} and printed {len(lines)} lines: {lines[-1:]}")
        print(lines[0])
        payload = json.loads(lines[0])
        if "error" in payload or not payload.get("value", 0) > 0 or payload.get("card") != smi:
            fail(f"bench --mode {mode}: bad line")
        print(f"# bench --mode {mode}: {time.perf_counter() - t0:.1f}s, {payload['metric']} = "
              f"{payload['value']}")
        if mode == "lal":
            lal_bench_launches = payload["lal_k1_launches_per_query"]
            skipped = payload.get("lal_host_fit_skipped")
            if payload["lal_trees"] != 2000 or lal_bench_launches != 2 or (
                    payload["lal_query_seconds_host_fit"] is None and not skipped):
                fail(f"bench --mode lal: {payload}")
            print(f"# bench --mode lal: K1 {lal_bench_launches} launches a query; host-fit leg: "
                  f"{skipped or payload['lal_query_seconds_host_fit']}")
        if mode == "round":
            roof = payload.get("roofline")
            phases = ("fit", "round", "score_select", "chunk", "fused_round")
            if not isinstance(roof, dict) or any(p not in roof for p in phases):
                fail(f"bench --mode round: the roofline section lacks a phase: {roof}")
            for p in phases:
                over = {k: v for k, v in roofline_lib.shares(roof[p]).items() if v > 1.0}
                if "error" in roof[p] or over:
                    fail(f"bench --mode round: roofline {p}: {roof[p].get('error') or over}")
            bench_batched["round_roofline"] = roof
            print("# bench --mode round roofline: " + "; ".join(
                f"{p} bandwidth_util {roof[p]['bandwidth_util']}, mfu_f32 {roof[p]['mfu_f32']}, "
                f"{roof[p]['bound']}" for p in phases))
            pod_keys = ("pod_select_seconds_by_shards", "pod_select_points_per_second",
                        "pod_recompiles_after_warmup", "pod_ingest_seconds_by_shards",
                        "pod_ingest_points_per_second", "pod_ingest_recompiles_after_warmup",
                        "pod_rebalance_seconds")
            if any(k_ not in payload for k_ in pod_keys) or payload["recompiles_after_warmup"]:
                fail(f"bench --mode round: the pod keys or recompiles_after_warmup: {payload}")
            bench_batched["round_pod"] = {k_: payload[k_] for k_ in pod_keys}
            print(f"# bench --mode round pod legs: select s by shards "
                  f"{payload['pod_select_seconds_by_shards']}, ingest s by shards "
                  f"{payload['pod_ingest_seconds_by_shards']}, rebalance "
                  f"{payload['pod_rebalance_seconds']} s")
        if mode in ("sweep", "grid"):
            bench_batched[mode] = payload
            if payload.get("baseline_skipped") != {"reason": "no_baseline_flag"} or (
                    mode == "grid" and (payload["recompiles_after_warmup"] != 0
                                        or payload["scenario_recompiles_after_warmup"] != 0)):
                fail(f"bench --mode {mode}: {payload}")
    # Scoring through the mesh (the JAX bench's --mesh-data/--mesh-model): the
    # pool padded to the data axis, every shard on the one card.
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--mode", "score", "--mesh-data", "4", "--mesh-model", "2",
                         "--mesh-devices", ",".join(["cuda:0"] * 8)])
    lines = out.getvalue().splitlines()
    if rc != 0 or len(lines) != 1:
        fail(f"bench --mode score through the mesh exited {rc}: {lines[-1:]}")
    print(lines[0])
    payload = json.loads(lines[0])
    if payload.get("kernel") != "pallas+mesh4x2" or payload.get("mesh_devices") != 8 or not (
            payload.get("value", 0) > 0):
        fail(f"bench --mode score through the mesh: {payload}")
    bench_batched["score_mesh4x2"] = payload
    # --mode all under a deadline it cannot meet: the line lands for what
    # completed, naming what was skipped; then one --profile-dir call.
    for extra in (["--mode", "all", "--deadline", "1", "--pool", "50000", "--iters", "2"],
                  ["--mode", "score", "--profile-dir", os.path.join(tempfile.mkdtemp(), "prof")]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = bench.main(extra)
        lines = out.getvalue().splitlines()
        if rc != 0 or len(lines) != 1:
            fail(f"bench {' '.join(extra)} exited {rc} and printed {len(lines)} lines: {lines[-1:]}")
        payload = json.loads(lines[0])
        if "--deadline" in extra:
            if not payload.get("modes_skipped") or payload.get("error"):
                fail(f"bench --mode all --deadline 1: no modes_skipped: {payload}")
            bench_batched["all_deadline"] = {k: payload[k] for k in ("modes", "modes_skipped")}
            print(f"# bench --mode all --deadline 1: ran {list(payload['modes'])}, skipped "
                  f"{[m['mode'] for m in payload['modes_skipped']]}")
        else:
            phase_s = payload.get("device_seconds_by_phase", {})
            if not phase_s.get("bench/score", 0) > 0:
                fail(f"bench --profile-dir: no device seconds under bench/score: {payload}")
            bench_batched["profile_dir"] = {k: payload[k] for k in (
                "device_seconds_by_phase", "device_seconds_total")}
            print(f"# bench --mode score --profile-dir: device_seconds_by_phase {phase_s}")
    variant_launches = {"forest_leaves_transposed": lv.transposed_launches,
                        "forest_leaves_segmented": lv.segmented_launches}
    print(f"# bench --mode variants launches, counted from 0: {variant_launches}")
    if not (lv.transposed_launches > 0 and lv.segmented_launches > 0):
        fail(f"the variants bench launched K5 {lv.transposed_launches} and K6 "
             f"{lv.segmented_launches} times")
    print(f"# total {time.perf_counter() - t_all:.1f}s")

    pkg = "distributed_active_learning_tpu_torch/csrc"
    print(json.dumps({"kernels": [
        {"name": "forest_leaves", "route": "cuda", "source": f"{pkg}/forest_leaves.cu",
         "replaces": "distributed_active_learning_tpu/ops/trees_pallas.py:204",
         "launches": launches["fused"]["forest_leaves"],
         "launches_by_path": {p: launches[p]["forest_leaves"] for p in launches},
         "metrics_path_launches": launches["metrics_chunked"]["forest_leaves"],
         "metrics_path_launches_per_round": k1_per_round,
         "sweep_launches": launches["sweep"]["forest_leaves"],
         "sweep_launches_per_replay": sweep_numbers["k1_launches_per_replay"],
         "sweep_serial_launches": launches["sweep_serial"]["forest_leaves"],
         "grid_launches": launches["grid"]["forest_leaves"],
         "grid_launches_per_replay": grid_numbers["k1_launches_per_replay"],
         "grid_two_datasets_launches": launches["grid_two_datasets"]["forest_leaves"],
         "scenario_launches": {p[len("scenario_"):]: launches[p]["forest_leaves"]
                               for p in launches if p.startswith("scenario_")},
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
         "by_shape": k1, "launch_config": k1_cfg, "by_payload": by_payload["forest_leaves"],
         "serving_by_shape": serving_numbers["k1"],
         "serving_launches_per_query": serving_numbers["k1_launches_per_query"],
         "serving_launches_per_refit": serving_numbers["serve"]["k1_launches_per_refit"]},
        {"name": "round_megakernel", "route": "cuda", "source": f"{pkg}/round_megakernel.cu",
         "replaces": "distributed_active_learning_tpu/ops/round_fused.py:166",
         "launches": launches["fused"]["round_megakernel"],
         "launches_by_path": {p: launches[p]["round_megakernel"] for p in launches},
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
         "by_shape": k2, "launch_config": k2["pool"]["launch_config"],
         "by_payload": by_payload["round_megakernel"]},
        {"name": "fused_votes", "route": "cuda", "source": f"{pkg}/fused_votes.cu",
         "replaces": "distributed_active_learning_tpu/ops/round_fused.py:286",
         "launches": launches["mesh_fused"]["fused_votes"],
         "launches_by_path": {p: launches[p]["fused_votes"] for p in launches},
         "max_abs_err": k3_err, "ms": k3["shard"]["ms"], "plain_ms": k3["shard"]["plain_ms"],
         "bound_ms": k3["shard"]["bound_ms"], "bound_by": k3["shard"]["bound_by"],
         "library_ms": None, "by_shape": k3, "launch_config": k3["shard"]["launch_config"],
         "full_width": {key: k3["full"][key] for key in ("ms", "plain_ms", "bound_ms",
                                                        "bound_by")},
         "by_payload": by_payload["fused_votes"]},
        {"name": "ring_hop", "route": "cuda", "source": f"{pkg}/ring_hop.cu",
         "replaces": "distributed_active_learning_tpu/ops/ring_topk.py:109",
         "launches": launches["mesh_fused"]["ring_hop"],
         "launches_by_path": {p: launches[p]["ring_hop"] for p in launches},
         "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain,
         "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": k4_lib,
         "step_ms": step_ms, "library_step_ms": lib_step_ms, "hop_ms": hop_ms,
         "peer_path_run": peer_run,
         "ipc_step_ms": statistics.median(mp_numbers["forest"]["ring_ipc_step_ms"]),
         "gloo_step_ms": statistics.median(mp_numbers["forest"]["ring_gloo_step_ms"]),
         "column_ring_ipc_step_ms": statistics.median(
             mp_numbers["forest"]["column_ring_ipc_step_ms"]),
         "column_ring_gloo_step_ms": statistics.median(
             mp_numbers["forest"]["column_ring_gloo_step_ms"])},
        {"name": "forest_leaves_transposed", "route": "cuda",
         "source": f"{pkg}/forest_leaves_transposed.cu",
         "replaces": "benches/pallas_variants.py:116",
         "launches": variant_launches["forest_leaves_transposed"],
         "max_abs_err": k5_err, "ms": k5_ms, "device_ms": k5_dev, "plain_ms": k5_plain,
         "bound_ms": k5_bound, "bound_by": k5_by, "library_ms": None,
         "tree_outer_ms": k5_outer_ms, "tree_outer_device_ms": k5_outer_dev,
         "call_ms": k5_call_ms, "walk_plain_ms": k5_walk_plain,
         "launches_by_path": {"bench_variants": variant_launches["forest_leaves_transposed"],
                              "neural": neural_k56["forest_leaves_transposed"]}},
        {"name": "forest_leaves_segmented", "route": "cuda",
         "source": f"{pkg}/forest_leaves_segmented.cu",
         "replaces": "benches/pallas_variants.py:359",
         "launches": variant_launches["forest_leaves_segmented"],
         "max_abs_err": k6_err, "ms": k6_ms, "device_ms": k6_dev, "plain_ms": k6_plain,
         "bound_ms": k6_bound, "bound_by": k6_by, "library_ms": None,
         "segment_slots": seg_S, "walk_plain_ms": k6_walk_plain,
         "launches_by_path": {"bench_variants": variant_launches["forest_leaves_segmented"],
                              "neural": neural_k56["forest_leaves_segmented"]}},
        {"name": "threefry", "route": "cuda", "source": f"{pkg}/threefry.cu",
         "replaces": "distributed_active_learning_tpu/models/neural.py:144 (jax.random's "
                     "threefry under XLA, no Pallas kernel)",
         "launches": neural_numbers["launches"]["neural"]["threefry"],
         "launches_by_path": {p: c["threefry"] for p, c in neural_numbers["launches"].items()},
         "max_abs_err": neural_numbers["k7_max_abs_err"],
         "ms": neural_numbers["k7"]["categorical"]["ms"],
         "plain_ms": neural_numbers["k7"]["categorical"]["plain_ms"],
         "bound_ms": neural_numbers["k7"]["categorical"]["bound_ms"],
         "bound_by": neural_numbers["k7"]["categorical"]["bound_by"], "library_ms": None,
         "by_entry": neural_numbers["k7"]},
    ], "seconds_per_round": chunk_times, "neural": neural_numbers, "telemetry": telemetry_numbers,
        "multiclass": mc_numbers, "lal": lal_numbers, "lal_bench_k1_launches": lal_bench_launches,
        "sweep": sweep_numbers, "grid": grid_numbers, "scenarios": scenario_numbers,
        "mesh": mesh_numbers,
        "files": files_numbers,
        "serving": {k: v for k, v in serving_numbers.items() if k not in ("launches", "k1")},
        "fleet": {k: v for k, v in fleet_numbers.items() if k != "launches"},
        "mesh_pod": {k: v for k, v in pod_numbers.items() if k != "launches"},
        "multi_process": {k: v for k, v in mp_numbers.items() if k != "launches"},
        "preflight": preflight_numbers,
        "bench_batched": bench_batched,
        "half_leaves_f32": half_leaves,
        "new_paths": new_paths, "merge_tile_topk_ms": merge_ms,
        "merge_tile_topk_device_ms": merge_dev}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
