#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile every CUDA kernel from ``csrc/`` (nvcc, sm_90a), one
     nvcc per source, all at once;
  3. kernels: hold each kernel against its plain PyTorch version on the card
     at three shapes, check that two runs are bitwise equal, and time
     kernel, whole call and plain version.  K1 (``egnn_message``): atol =
     rtol = 1e-4 (f32 sums in another order) at a small random case, the
     serving bucket (E 1408), the star train bucket (E 1400), an N 10k / E
     129k random case and the unsorted 10k-atom box, and at D 16, 64, 128
     and 256 (clusters of 1, 1, 2 and 8 blocks) with 10% of the edges
     masked, int32 and int64 ids, E 0 and E below one tile; two runs of
     every case bitwise equal; the edge kernel's plan in C
     (``gmp_egnn_resident_plan``) equal to ``edge.resident_plan`` at every
     width.  K2 (``egnn_message_bwd``):
     the same for dh and dpos, and dW within 1e-5 of its largest entry, at
     the small and train-bucket shapes and at two random full-width cases
     where ``edge.egnn_tile`` changes the tile on 132 SMs (E 2097: 16-row
     tiles; E 4193: 32), with the tile taken and K2's time by CUDA kernel
     (``torch.profiler``) printed; at N 10k / E 129k, where a few of
     the 50M ReLU pre-activations lie within f32 rounding of zero and flip
     (the plain f32 version differs from a float64 run just as much), at
     most 1% of node rows beyond 1e-4, no entry beyond 0.1, and dW within
     1e-3 of its largest entry;
     K3 (``sorted_segment_sum``) at random unsorted ids (E 3000, N 700,
     D 64, 10% masked), with every edge masked (empty segments), and on the
     receiver-sorted 100k-atom box with its receiver plan (identity) at
     D 128, D 4 and D 177 (GVP-GNN's merged sum) and its sender plan at
     D 128, D 3 and D 176 (GVP-GNN's sender gather backward); K4
     (``segment_sum``) at E 3000 / N 700 / D 64, on the box's edges in
     shuffled order at D 128 and as a sum pool of the box's nodes into its
     graph at D 176 (one long segment: the kernel's block path): atol = rtol
     = 1e-5 of the f32 sum (the JAX test's; for the pool, whose 1e5-row f32
     sums lie ~1e-2 from the exact one in any order, no farther from a
     float64 sum than twice the plain version), two runs bitwise equal, and
     beside kernel, whole call and
     plain version the library calls (one ``index_add_`` on the masked
     data, one ``torch.segment_reduce`` on the sorted rows);
  3b. K5 (``gvp_message``, forward and backward) against its plain versions
     at five shapes: a small random case (N 40, E 150, 16/4 nodes, 8/1
     edges), the star train bucket at full width (N 800, E 1400; 128/16
     nodes, 32/1 edges, layer 0's weights of the phase-4b model), the
     unsorted 10k-atom box at full width (129,224 edges) and two random
     full-width cases where ``gvp_message.gvp_tile`` changes the edge tile
     on 132 SMs (E 2097: 16; E 4193: 32 forward).  Forward: atol =
     rtol = 1e-4.  Backward (``check_gvp_bwd``): the edges with a ReLU
     pre-activation within 1e-5 of zero (a float64 run finds them; their
     mask may flip between two f32 runs) masked off and counted, then the
     feature cotangents within 1e-4 and each weight's gradient within 1e-5
     of that weight's largest entry (at least 1), 1e-3 at the box (f32 sums
     of 129k edges in another order), with both f32 versions' distances from
     float64 printed at full width.  Two runs bitwise equal; kernels, whole
     call and plain version timed beside the bound, with the edge tiles
     taken and the backward's time by kernel (``torch.profiler``);
  3c. K6 (``egnn_stack``, forward and backward: all 4 EGNN layers, update
     MLP included, one launch per direction) against its plain versions at
     five shapes: a small random case (N 30, E 110, D 16, 3 layers), the
     star train bucket at full width (N 800, E 1400, 4 x 128, the phase-4
     model's weights), the unsorted 10k-atom box (129,224 edges, 4 x 128,
     the same weights) and two random full-width cases where
     ``edge.egnn_tile`` changes the tile (E 2097: 16; E 4193: 32; one layer
     of width 128 with the random case's weights, LayerNorm scales 1, so a
     ReLU flip cannot spread through the layers below; the train bucket
     takes 8, the box 32); the tile rule's shared-memory mirror
     (``edge.tile_smem_bytes``) equal to the kernels' own count
     (``gmp_egnn_tile_smem``).  Forward: atol = rtol = 1e-4.  Backward
     (``check_stack_bwd``): dh0 and dpos0 atol = rtol = 1e-4 and each
     layer's dW within 1e-5 of its largest entry (at least 1).  On the box
     some of the 10^8 ReLU pre-activations lie within f32 rounding of zero
     and flip, in the kernel and in the plain f32 version at different
     entries, and each flip's cotangent spreads through the layers below it
     (at 4 layers some 2% of node rows; the plain f32 version lies as far
     from float64 as the kernel).  So both are held to a float64 run of the
     plain version: the kernel's node rows beyond atol = rtol = 1e-4 of it
     at most 2x the plain f32 version's plus 0.5% of N, no entry beyond 0.1
     of that output's largest float64 entry, and each layer's dW no further
     from it than 2x the plain f32 version's distance plus 1e-3 of that
     layer's largest entry.  Two runs bitwise equal; kernel, whole call and
     plain version timed beside the bound (``stack_bound_ms``), with the
     tile taken and the device time by CUDA kernel;
  3d. K7's one-group entry (``edge_weighted_contract``, forward and
     backward: the one-group kernels, a block per edge) against its plain
     versions at the JAX test's three shapes (``tests/test_pallas.py``:
     bf16 W in the third), at the five groups of TFN's layer 0 and of a
     hidden layer at the TFN train bucket (E 1400), f32 W, each in a launch
     of its own, and at one hidden group with bf16 W (then that group
     alone through the grouped kernel, bf16 and f32 W): within 2e-5 (bf16 W:
     3e-2) of max(|ref|, 1), the JAX test's tolerances and scaling; dW in
     W's type; two runs bitwise equal; per group kernel, whole call, plain
     version and ``torch.bmm`` beside the bound (``k7_bound_ms``).  Then the
     main path's call, ``edge_weighted_contract_grouped`` (``check_k7_layer``,
     the grouped kernel): layer 0, a hidden layer and a hidden layer with
     bf16 W, all five groups in one launch per direction, held to the same
     tolerances group by group, timed against the groups' plain versions
     and ``torch.bmm`` calls summed and against the five one-group launches
     back to back.  Then MACE's group sets (``bench.MACE_STAR``: ungated, so
     the TP output is exactly the hidden irreps 64x0e+64x1o+64x2e+64x3o) at
     its train bucket (E 1400), f32 W: layer 0 (64x0e in) and the hidden
     layer, four groups each in one grouped launch per direction, held the
     same way (``check_k7_layer``), with the per-edge weight tensor's size;
  4. serve: star graphs (1400, fold 5/6/7, seed 0) through
     ``Predictor(EGNNFusedModel(4 layers, 128 wide, pool "first"))``, with
     the launch counters set to 0 just before and read just after; the
     result must be finite, of shape (1400, 1), and match the same weights
     run on the CPU through the plain path (atol 1e-4);
  4b. GVP serving: ``Predictor(GVPGNNModel(4 layers, 128/16,
     use_pallas=True))`` over the same graphs, counters set to 0 just before
     and read just after: 14 x 4 K5 forward launches, 14 K4 (the sum pool)
     and nothing else; finite (1400, 1), within 1e-4 of the CPU plain path;
     median of 7 calls;
  4c. whole-stack serving: ``Predictor(EGNNFusedModel(4, 128, pool "first",
     fuse_stack=True))`` on phase 4's weights over the same graphs, counters
     set to 0 just before and read just after: 14 K6 forward launches and
     nothing else; finite (1400, 1), within 1e-4 of the CPU plain path and of
     phase 4's per-layer result; median of 7 calls beside phase 4's;
  4d. TFN serving: ``Predictor(TFNModel)`` at the star configuration
     (``bench.TFN_STAR``: 4 layers, max_ell 3, emb_dim 64, mlp_dim 256, gate,
     residual, pool "first") over 1400 star graphs with seven spokes (fold
     [7], seed 0), counters set to 0 just before and read just after: K7
     4 x 14 = 56 forward launches (one per layer: all its groups), K4 4 x
     14 = 56, no K7 backward, nothing else; finite (1400, 1), within 1e-4 of the same weights on the
     CPU plain path; median of 7 calls;
  5. train, against the CPU: the bench configuration (split 50/20/30,
     batch 100, lr 5e-4) from the same weights and the same shuffle, run on
     the card, on the CPU plain path in float32 and on the CPU in float64,
     and on the card twice more: with the plain message pass in place of
     K1/K2 (a witness of the card's rounding outside the kernels) and with a
     planted fault, the message weights cut off from the gradient (the
     card's message pass before it had a backward).  First one
     ``train_step``: every parameter's gradient on the card must lie within
     1e-2 of that parameter's largest float64 entry.  Then one epoch
     through ``fit_regression``: float32 rounding grows through the Adam
     steps, so that tolerance is measured: every step loss and MAE of the
     card must lie within 10x the CPU float32 run's largest relative
     distance from the float64 run (at least 1e-5) of the float64 value.
     The planted fault must fail both checks;
  5b. GVP one ``train_step`` against the CPU (dropout rate 0 on these
     copies: the card's and the CPU's generators draw different masks): on
     the card, on the CPU in float32 and in float64; every gradient on the
     card within 1e-2 of that parameter's largest float64 entry.  Printed
     beside it: the card run again (run to run) and on the plain route
     (``use_pallas=False``, a witness of the card's rounding outside K5).
     A planted fault, the edge features cut off from K5's gradient (``W_e``
     and ``W_e_norm`` learn nothing), must fail that check;
  5c. whole-stack one ``train_step`` against the CPU: phase 5's first step
     with ``fuse_stack=True`` on the card (one K6 launch each way), on the
     CPU in float32 and in float64; every gradient on the card within 1e-2
     of that parameter's largest float64 entry.  Printed beside it: the card
     on the plain stack (a witness of the card's rounding outside K6).  A
     planted fault, the update-MLP rows of the stacked weights cut off from
     K6's gradient (no ``upd_*`` parameter learns), must fail that check;
  5d. TFN one ``train_step`` (its split 50/20/30, batch 100, lr 5e-4): at
     full width the card through K7/K4 (exactly 4 K7 launches each way, one
     per layer, and 5 K4: 4 message sums and the embedding's gradient)
     against the card
     through their plain twins (both f32: gradients
     within 1e-3 of each parameter's largest entry); at emb_dim 16 with 2
     layers (a float64 CPU step at full width is ~1 TFLOP) the card against
     the CPU in float32 and float64, gradients within 1e-2 of each
     parameter's largest float64 entry; a planted fault, K7's dT dropped
     (``without_contract_dT``), must fail that check;
  6. train, the main path: one 100-epoch ``fit_regression`` (``EPOCHS``;
     bench.py's configuration at half its 200 epochs) on the card with
     the launch counters set to 0 just before and read just after: K2 must
     have launched 4 x (train steps) times, K1 4 x (train steps + validation
     batches + test batches of the epochs whose best-val rule fired), K4
     once per train step (the embedding's gradient, ``nn.basic.Embedding``);
     the test MAE must be finite and below 0.2;
  6f. whole-stack training, the main path: phase 6's run at 50 epochs
     (``STACK_EPOCHS``) with ``fuse_stack=True``, counters set to 0 just before and read just after
     (K4 once per train step, the embedding's gradient):
     K6 forward (train steps + validation batches + test batches of the
     fired epochs) times, K6 backward (train steps) times, nothing else;
     test MAE finite and below 0.2; train_time and test MAE beside phase 6's;
  6g. TFN training, the main path: one 100-epoch ``fit_regression`` of the
     phase-4d model (lr 5e-4, shuffle seed 1), counters set to 0 just before
     and read just after: K7 forward 4 x (train steps + validation batches
     + test batches of the fired epochs), backward 4 x train steps, K4 4 x
     the forward calls + 1 x train steps (the embedding's gradient), nothing
     else; test MAE finite and below 0.09 (the JAX number's 200 epochs cut
     to 100 for time; three 100-epoch repeats on the H100 0.07556-0.08148,
     ``seed_spread.py``), printed beside the JAX package's 0.0637 +- 0.0010 and the reference's
     0.0667;
  6d. GVP training, the main path: a 50-epoch ``fit_regression`` of the
     phase-4b model with dropout on, counters set to 0 just before and read
     just after: K5 forward 4 x (train steps + validation batches + test
     batches of the fired epochs), backward 4 x train steps, K4 once per
     forward (the sum pool) and once per train step (the embedding's
     gradient), nothing else;
     losses finite, the last epoch's mean train loss below the first's; the
     test MAE printed beside a constant predictor's (the train-target mean);
  6b. box training, against the CPU: one bench_scale step (L1-sum loss,
     Adam 1e-4) of ``schnet_sorted`` and ``egnn_sorted`` (4 layers x 128)
     on a receiver-sorted box of 2000 atoms, from the same weights, on the
     card, on the CPU in float32 and in float64: every parameter's gradient
     on the card within 1e-2 of that parameter's largest float64 entry.  A
     planted fault, the receiver plan given for the sender gather's
     backward, must fail that check;
  6c. box training, the main path: ``schnet_sorted`` then ``egnn_sorted``
     at full width (4 layers x 128) on the receiver-sorted 100k-atom box
     (1,350,872 edges), a few bench_scale steps each, with the launch
     counters set to 0 just before and read just after: K3 must have
     launched exactly ``bench_scale.sorted_launches_per_step`` times per
     step (8 for SchNet, 22 for EGNN), K4 twice (the sum pool and the
     embedding's gradient), the others never; every loss finite;
     prints ms per step, edges/s and peak device memory;
  6e. ``gvp_sorted`` (4 layers, 128/16; its chain on the plain route, as in
     the JAX script): one step on the 2000-atom sorted box against the CPU
     float64 run with phase 6b's planted fault rejected (dropout rate 0 on
     those copies), then a few steps on the 100k-atom box with remat and
     dropout on: K3 exactly ``sorted_launches_per_step("gvp_sorted", 4,
     remat=True)`` (12) times per step, K4 twice, no K5; ms per step,
     edges/s, peak device memory;
  6h. repair: every ``ops.scatter.segment_sum`` of a CUDA tensor is K4, so
     two runs of one plain-route ``egnn`` step (4 x 128) on the unsorted
     10k-atom box give bitwise-equal gradients, with exactly 14 K4 launches
     per step (per layer the message sum and the position mean's two sums,
     the pool and the embedding's gradient: ``nn.basic.Embedding``);
  3e. K3 on the triplet fold (``sorted_segsum.sorted_fold`` over
     ``ascending_plan``, the identity plan of the ascending ``idx_ji`` built
     on the card: no sort, no host read; the kernel skips the masked rows
     itself and adds an optional accumulator) against the plain sum at the
     DimeNet++ star train bucket (fold 7, batch 100: 4224 triplet rows into
     1408 edges), on the unsorted 10k-atom box's 1.7M triplets (129,280
     edges) and at a case with edges that own no triplet, 5% of the rows
     masked and a masked tail, all at width 64: within 1e-5, two runs
     bitwise equal, one K3 launch a call, and with an accumulator bitwise
     equal to the previous formula ``acc + fold`` (K3 over the
     masked-zeroed rows, then an add); kernel, whole call, the call with an
     accumulator, the previous formula, plan, plain version, K4 over the
     same ids, the CSR-sort route, ``index_add_`` and
     ``torch.segment_reduce`` timed beside the bound;
  3f. K4 and the fold at every shape the star models launch: one train
     step and one predict batch of each of egnn (per layer), egnn_stack,
     gvp, tfn, mace, dimenet and spherenet at their main paths'
     configurations, of the expressivity arms' models on their batches
     (``bench_kernels.EXPRESSIVITY_MODELS``: MPNN and EGNN on the k = 4
     chains, SchNet on the two-body pair, MACE correlation 3 on the
     three-body pair; integer labels, cross-entropy), and of the CLI's
     paired-star configurations (``bench_kernels.CLI_MODELS``, built by
     ``experiments.cli``: EGNN on the two-centre and the one-centre stars,
     4 atom types; MACE with the mean pool), all
     run under ``bench_kernels.capture_star_shapes``, which records every
     ``segment_sum`` (K4) and ``sorted_fold`` call; each distinct shape
     held to the plain version (SEG_TOL of max(|ref|, 1)), two runs bitwise
     equal, K4 on its scan route and nothing but the segment-sum kernel on
     the device (no sort: the profiler's split, launches a call printed);
     the
     kernel by the profiler, the whole call, the host microseconds a call,
     the CSR-sort route the previous design took, ``index_add_``,
     ``segment_reduce`` and the bound printed.  Then the force fields'
     shapes (``capture_ff_shapes``): one bench_scale step of ``mace_ff`` and
     ``tfn_ff`` at ``bench_scale.config(name, 10_000)`` on the unsorted
     10k-atom box, every K4 call recorded; each layer's chunk sum (16384
     rows; D ``tp.irreps_out.dim``: 1024 and 6336 for MACE-FF, 576 and 2240
     for TFN-FF) at a full chunk and at the padded tail chunk held the same
     way (one scan-route kernel a call), the pools and TFN-FF's embedding
     gradient (few long segments: the CSR route) by ``check_segsum``
     against float64, all timed (kernel, whole call, ``index_add_``, bound);
  4e / 4f. DimeNet++ (4 layers) and SphereNet (2 layers) serving at their
     full default widths: ``Predictor(needs_triplets=True)`` over the 1000
     fold-7 star graphs and ``Predictor(with_quads=True)`` over 1500 fold
     5/6/7 star graphs (their star data, seed 0), the heads that
     start at 0 drawn, counters set to 0 just before and read just after:
     per batch K3 once a layer and K4 L + 2 times, nothing else; finite
     (n, 1), within atol = rtol = 1e-4 of the CPU plain path; median of
     5 calls;
  5e / 5f. one train step's gradients of each (heads drawn) on a star train
     batch on the card against the CPU's plain f32 step: within 2e-4 of
     each parameter's max(|ref|, 1) (the CPU tests' tolerance), the float64
     distances printed beside; planted faults that must fail that check:
     DimeNet++ with the fold's plan shifted by one row, SphereNet with the
     fold's backward dropped;
  6i. DimeNet++ star run, the main path: ``fit_regression`` of the JAX
     CLI's configuration (fold 7, 4 layers, 1000 graphs, batch 100, lr
     1e-4; weights and shuffle from seed 0, ``run_experiment_reg``'s first
     repeat), 200 epochs (the JAX number's 600, cut for time), counters
     set to 0 just before and read just after: K3 4 per forward, K4 6 per
     forward and 1 per train step (the embedding's gradient), nothing else;
     test MAE below 0.116 (three 200-epoch repeats on the H100
     0.10495-0.10758; the JAX package at 600 epochs 0.0831 +- 0.0007);
  6j. SphereNet star run: folds 5-7, 2 layers, 100 epochs (the JAX
     number's 200, cut for time) under the protocol of the JAX package's
     number (1500 graphs, lr 5e-4, cosine schedule): K3 2 per forward, K4 4
     per forward and 1 per train step; test MAE below 0.115 (three
     100-epoch repeats on the H100 0.08836-0.10590; the JAX package at 200
     epochs 0.0798 +- 0.0049);
  6k. ``bench_scale``'s dimenet step: one step on a 1000-atom box
     (triplet_chunk a third of its triplets, heads drawn) on the card
     against the CPU float64 run, each gradient within 1e-2 of its largest
     entry, with the fold's plan shifted by one row as a planted fault;
     then, from the same weights against the same float64 run, the 100k
     rule's schedule (``remat_blocks``, ``rbf_in_chunk``, edge and triplet
     chunks of about a third that do not divide the rows,
     ``dimenet_chunk_checks``; a planted fault: the output blocks' chunk sum
     without its shorter tail chunk), then with ``remat_full_blocks``, then
     with ``chunk_output_blocks=False``, each step's K3 and K4 launches
     exactly ``bench_scale.dimenet_launches_per_step``; then the 10k-atom
     box at ``bench_scale.config('dimenet', 10_000)`` (4 layers,
     triplet_chunk 262144: 7 chunks, their rows kept): a warm step and 4
     timed (``box_run``), K3 4 x 7 and K4 7 per step
     (``dimenet_launches_per_step``), ms per step and peak device memory;
  6o. DimeNet++ at ``bench_scale.config('dimenet', 100_000)`` (edge chunks
     65536, ``remat_blocks``, ``rbf_in_chunk``) on the unsorted 100k-atom
     box (1,350,872 edges, its triplets built on the host and timed apart):
     first K3 and K4 at the row's shapes against their plain versions
     (SEG_TOL, bitwise repeatable; random rows): the first and the last
     triplet chunk's fold (262144 rows into the [1,350,872, 64]
     accumulator) and the first and last output chunk's sum (65536 rows
     into 100k nodes, [.., 128]); then a warm step, then two with the
     counters set to 0 just before and read just after: K3 and K4 exactly
     ``dimenet_launches_per_step``, nothing else; every loss finite; ms per
     step, triplets/s, peak device memory;
  6p. SphereNet (``bench_scale.config('spherenet')``, 4 layers) one step on
     a 500-atom box, triplet and quad chunks of about a third, on the card
     against the CPU float64 run (1e-2 of each largest entry; a planted
     fault: the triplet fold without its last chunk), K3 and K4 exactly
     ``spherenet_launches_per_step``; then the 10k-atom box with its quads
     (built on the host and timed apart): a warm step and two counted, as
     6o;
  6q. ``egnn_fused`` (4 x 128) one step on the unsorted 2000-atom box on the
     card against the CPU float64 run (a planted fault: K1's packed weights
     cut off from the gradient), K1 4, K2 4, K4 2
     (``fused_launches_per_step``); then the unsorted 100k-atom box: K1 and
     K2 at 1,350,872 edges on the inputs layer 0 gets in a step there (its
     h, positions and packed weights, and the cotangents its backward gets)
     against their plain versions at phase 3's tolerances (K2 as at N 10k:
     ``check_bwd_case(large=True)``), then a warm step and 4 counted, as
     6o;
  4g. MACE serving: ``Predictor(MACEModel)`` at ``bench.MACE_STAR`` (2
     layers, max_ell 3, correlation 3, emb_dim 64, mlp_dim 256, batch norm,
     residual, pool "first") over its 1500 star graphs (fold [7], seed 0),
     counters set to 0 just before and read just after: per batch K7 and K4
     once a layer and nothing else; finite (1500, 1), within atol = rtol =
     1e-4 of the CPU plain path; median of 5 calls;
  5g. MACE one ``train_step``: at full width the card (exactly 2 K7
     launches each way and 3 K4) against the CPU's plain f32 step, gradients
     within 1e-3 of each parameter's largest entry (phase 5d's rule for two
     f32 runs), peak device memory printed; at emb_dim 16 the card against
     the CPU in float64, within 1e-2; a planted fault, the symmetric
     contraction's nu = 3 weights detached (``weights_nu3_detached``), must
     fail that check;
  6l. MACE training, the main path: ``fit_regression`` of the phase-4g
     model under the protocol of the JAX package's number (1500 graphs, lr
     5e-4, cosine; weights and shuffle from seed 0) cut from 200 epochs to
     100, counters set to 0 just before and read just
     after: K7 2 per forward and 2 per train step backward, K4 2 per
     forward and 1 per train step, nothing else; test MAE finite and below
     0.09 (three 100-epoch repeats on the H100 0.08127-0.08216; the JAX
     package at 200 epochs 0.0766 +- 0.0013);
  4h. MACE-FF serving: ``Predictor(MACEForceField(in_dim=1))`` at full
     width (2 layers, emb 64, max_ell 3, correlation 3, pool "sum") over
     MACE's 1500 star graphs (E 1400 a batch: the combined 'uvu' form),
     counters set to 0 just before and read just after: per batch K4 4
     times (each layer's message sum and readout pool) and nothing else;
     finite (1500, 1), within atol = rtol = 1e-4 of the CPU plain path;
     median of 5 calls;
  5h. one bench_scale step (L1-sum loss, Adam 1e-4) of ``mace_ff`` (edge
     chunks of 5000: the bcast form and a padded tail; node blocks of 300;
     the post-conv linear folded into the chunks, ``FOLD_ACC_ELEMS`` 0 on
     the model's interaction blocks) and ``tfn_ff`` (edge chunks of 5000) at
     full width on a 1000-atom box: every gradient on the card within 1e-2
     of that parameter's largest entry of the CPU float64 run.  A planted
     fault, ``node_feats`` detached in every chunk
     (``chunk_node_feats_detached``: no gradient through the convolution to
     ``linear_up`` and below), must fail that check.  Printed beside it: the
     card with the chunk sums' masks dropped (``segment_sum_without_mask``):
     the padded tail's messages are exact zeros, so it is no fault;
  6n. the force-field box, the main path: ``mace_ff`` and ``tfn_ff`` at
     ``bench_scale.config(name, 10_000)`` on the unsorted 10k-atom box
     (edge chunks of 16384): two steps from one state give bitwise-equal
     gradients; then after that warm step 4 timed steps, counters set to 0
     just before and read just after: K4 exactly
     ``bench_scale.ff_k4_launches_per_step`` per step (18 and 34 at 8
     chunks), nothing else; every loss finite; ms per step, edges/s and
     peak device memory printed;
  6m. the expressivity table on the card (``EXPRESSIVITY``):
     ``fit_classification`` at the JAX tests' settings (lr 1e-3; k-chains
     400 epochs, rotsym 150, the environment pairs 200), weights from
     ``seed_everything(seed)``: k = 4 chains, EGNN (3 layers) 100% at some
     seed of 0-4 with a mean above 50%, MPNN at most 50% at seeds 0-2;
     rotsym fold 3, EGNN at most 50%, TFN (max_ell 3, gate off) 100%, MACE
     (max_ell 3) printed; two-body SchNet at most 50%, EGNN 100%;
     three-body MACE correlation 1 at most 50%, correlation 3 100%; each
     arm's K4 launches at least one per train step;
  7a. the regression CLI end to end (``experiments.cli.main``): EGNN
     (4 layers, pool first) on 1500 two-centre paired stars (fold 7, 2
     pairs) with the loss mask, 30 epochs x 2 repeats, the warmup resolved
     to 50 epochs; then EGNN on 1500 paired stars with ``--grad_clip 1.0``,
     10 epochs; counters set to 0 just before each run and read just
     after: K4 launched; every loss and test MAE finite, the mean train
     loss lower in the last epoch than in the first; the ledger file holds
     two records with the JAX CLI's keys.  The mask: one train step with
     the masked half of the targets replaced by noise gives bitwise the
     same gradients; a planted fault, the same step unmasked, must not.
     The clip: one step on 100 paired stars (global norm above 1.0) held
     to the per-tensor formula (``clip_per_tensor_``, within 1e-5 of each
     tensor's largest entry), then the grad_clip run's configuration
     trained 5 epochs without the clip, with it and with the per-tensor
     formula, twice each, train_time per epoch printed;
  7b. kill and resume on 1500 paired stars (EGNN, pool first; GVP-GNN, 4
     layers, dropout on): two 6-epoch ``fit_regression`` runs without
     checkpoints bitwise equal; 4 epochs checkpointed every 2 (GVP-GNN: 3,
     every 3), then resumed to 6, bitwise the uninterrupted run (per-epoch
     rows, every step's loss, the final state dict).  A planted fault, the
     resume with its shuffle generator left at its seed
     (``restore_shuffle`` a no-op), must differ;
  7c. NaN recovery (EGNN, checkpoints every 2 epochs): every parameter
     NaN at the start of epoch 4, rolled back: bitwise the clean 7b run;
     NaN at every epoch from 2 on: ``FloatingPointError`` after 3
     recoveries.  A planted fault, the same poison with ``nan_recovery``
     off, must fail the finite-loss check;
  7d. the accuracy anchor through the CLI: MACE on 1500 paired stars
     (fold 7, 2 pairs), 2 layers, max_ell 3, pool mean, lr 5e-4, cosine
     (the protocol of the JAX package's 0.0275 +- 0.0013 at 200 epochs),
     cut to ``MACE_PAIRED_EPOCHS`` (100) epochs: test MAE at most
     ``MACE_PAIRED_MAE_MAX`` (from three 100-epoch repeats on the H100,
     ``experiments/seed_spread.py --model mace_paired``); time and K7 / K4
     launches printed;
  8. the teaching path (``examples/gnn101.py``, the 101 notebook's models
     at its width: 4 layers x 64, in_dim 5, edge_dim 4; ``models/gnn101.py``
     and ``models/egnn.MPNNModel``):
  8a. one complete-graph batch of 32 molecules (``GraphLoader``, N 392, E
     4224): for MPNN, CoordMPNN, InvariantMPNN and FinalMPNN, and for
     ``MLP(norm='batch')`` on the batch's edge rows, one train-mode forward
     and backward of the notebook's loss, the updated BatchNorm running
     statistics and an eval-mode forward on the card, each tensor within
     1e-4 of max(its largest CPU entry, 1) of the same weights on the CPU
     plain path (a tensor beyond it passes only if it lies no farther from
     the CPU float64 run than twice the CPU float32 one plus that
     tolerance: a ReLU mask flip, ROADMAP §3); counters set to 0 just
     before the step and read just after: K4 exactly ``TEACH_K4_PER_STEP``
     (MPNN 6, CoordMPNN 6, InvariantMPNN 6, FinalMPNN 14, the MLP 0) and
     nothing else.  Then FinalMPNN's train step (with Adam) through
     ``utils.time_fn`` (ms a step), ``utils.profile_trace`` (the Chrome
     trace must name K4's ``segsum_block`` kernel) and
     ``utils.cost_report`` (FLOPs > 0, bytes, aten ops);
  8b. ``examples.gnn101.train_model`` of FinalMPNN at the notebook's
     settings (400 molecules, 40 epochs, lr 5e-3, batch 32; weights and
     shuffle from seed 0): test MAE finite and at most ``TEACH_MAE_MAX``
     (PERF.md: from the JAX notebook's spread); K4 exactly 14 per forward
     (train steps, validation and test batches) and nothing else (the
     other three models' runs: ``examples/gnn101.py``'s main);
  8c. the QM9 pipeline at its defaults (``examples.qm9_pipeline.main``:
     EGNN 3 x 64, 30 epochs, lr 1e-3): its last line's de-normalised test
     MAE finite, K4 launched;
  9a-9e. the data-parallel path at the bench configuration
     (``experiments.dp_check``): NCCL asked for two ranks on the one card
     raises before any process starts (the error printed); two gloo ranks
     sharing ``cuda:0`` (``parallel.launch.spawn``; the kernels built here,
     loaded by each rank from ``.gmp_torch_build/``): 9a two
     ``dp_train_step`` steps on halves of batch 100 against two plain
     steps on the concatenated batch in this process (the summed
     gradient within 1e-5 of each tensor's largest entry, the weights
     within 1e-5), K1 / K2 / K4 4 / 4 / 1 a step on each rank; 9b the same
     with ``zero_dp_train_step``, each rank's Adam state ceil(P / 2)
     elements; 9c ``fit_dp`` 5 epochs against one NCCL rank: the initial
     weights' sharded validation MAE and the first step's summed loss
     within 1e-5, both runs' test MAE below half the untrained model's,
     K1 / K2 / K4 per rank by the protocol (the per-epoch rows printed:
     a rounding-sized difference carries at this width, PERF.md); 9d
     ``run_experiment_reg(mesh=)``, 10 epochs, its ledger record and a
     test MAE below the untrained model's; 9e ``Predictor(mesh=)`` over
     1300 graphs (13 batches, a ragged group) bitwise one ``Predictor``,
     K1 28 a rank; a dp step's ms at world 2 and world 1; a rank that
     fails, dies or hangs fails the phase;
  10. summary: one JSON line of kernels (each with its launches in the CLI
     runs; K1-K4 with their launches a step on the box rows of 6k and
     6o-6q; K4 with its launches on the teaching path; K1, K2 and K4 with
     their launches per rank on the data-parallel path), then the device
     line last.

Phases run in the order 1, 2, 3, 3b, 3c, 3d, 3e, 3f, 4, 4b, 4c, 4d, 4e, 4f,
4g, 4h, 5, 5b, 5c, 5d, 5e, 5f, 5g, 5h, 6, 6f, 6g, 6d, 6b, 6c, 6e, 6h, 6i, 6j,
6k, 6o, 6p, 6q, 6l, 6n, 6m, 7a, 7b, 7c, 7d, 8a, 8b, 8c, 9a-9e, 10.
It imports nothing of JAX.  Peak rates for the bounds are the H100 SXM data
sheet's: 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s HBM.  The bound
of K3 and K4 counts the rows their segments hold (each read once), the
permutation, row pointers or ids and mask, and the output written once; K5's
is ``gvp_bound_ms``, K6's ``stack_bound_ms``, K7's ``k7_bound_ms``.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import dataclasses
import json
import re
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from geometric_message_passing_tpu_torch.experiments import (bench_kernels,
                                                             bench_scale)
from geometric_message_passing_tpu_torch.experiments.bench_kernels import (
    cuda_time_ms, segsum_bound_ms as seg_bound_ms)
from geometric_message_passing_tpu_torch.experiments import (cli,
                                                             dp_check,
                                                             seed_spread,
                                                             train)
from geometric_message_passing_tpu_torch.examples import gnn101, qm9_pipeline
from geometric_message_passing_tpu_torch import utils
from geometric_message_passing_tpu_torch.utils import roofline
from geometric_message_passing_tpu_torch.nn.basic import MLP
from geometric_message_passing_tpu_torch.experiments.bench import (
    DIMENET_STAR, LR, MACE_LR, MACE_STAR,
    SPHERENET_STAR, TFN_STAR, bench_data, card_line, mace_data,
    mace_model as _mace_model, tfn_data, tfn_model as _tfn_model,
    triplet_star_data)
from geometric_message_passing_tpu_torch.experiments.infer import Predictor
from geometric_message_passing_tpu_torch.experiments.train import (
    fit_classification, fit_regression, make_tx, seed_everything, train_step)
from geometric_message_passing_tpu_torch.graph import (
    Graph, GraphLoader, assemble_batch, build_slot_data, pad_sizes)
from geometric_message_passing_tpu_torch import datasets
from geometric_message_passing_tpu_torch.triplets import attach_triplets
from geometric_message_passing_tpu_torch.models import (
    DimeNetPPModel, EGNNFusedModel, GVPGNNModel, MACEForceField,
    SphereNetModel, TFNModel, egnn_fused, gvpgnn, model_registry)
from geometric_message_passing_tpu_torch.models import dimenet as dimenet_mod
from geometric_message_passing_tpu_torch.nn import conv as tfn_conv
from geometric_message_passing_tpu_torch.nn import mace_blocks
from geometric_message_passing_tpu_torch.nn import symmetric_contraction
from geometric_message_passing_tpu_torch.nn import tensor_product
from geometric_message_passing_tpu_torch.nn.gvp import GVPDropout
from geometric_message_passing_tpu_torch.ops import _build
from geometric_message_passing_tpu_torch.ops import edge
from geometric_message_passing_tpu_torch.ops import edge_contract as ec
from geometric_message_passing_tpu_torch.ops import scatter
from geometric_message_passing_tpu_torch.ops import egnn_stack as es
from geometric_message_passing_tpu_torch.ops import gvp_message as gm
from geometric_message_passing_tpu_torch.ops import sorted_segsum as sss
from geometric_message_passing_tpu_torch.ops.edge import (
    egnn_message, egnn_message_bwd, egnn_message_bwd_plain, egnn_message_plain,
    msg_rows)

# phases 6 and 6f: the bench configuration at fewer epochs than bench.py's
# 200, to keep the script well inside its time limit (test MAE below 0.2 at
# either depth: 0.1149 at 100 epochs, 0.1234 at 50 on the CPU plain path)
EPOCHS, STACK_EPOCHS = 100, 50
F32_FLOPS = 67e12          # H100 SXM, f32 on CUDA cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
ATOL = RTOL = 1e-4
GRAD_TOL = 1e-2   # one step's gradients, of each parameter's largest entry

N_GRAPHS, BATCH, LAYERS, WIDTH = 1400, 100, 4, 128


def log(*args) -> None:
    print(*args, flush=True)


T0 = time.perf_counter()
PHASE_START = {}      # phase -> seconds since the import (the summary's)


def mark(phase: str) -> None:
    """Note and log when ``phase`` starts, in seconds since the import."""
    PHASE_START[phase] = time.perf_counter() - T0
    log(f"[time] phase {phase} at {PHASE_START[phase]:.2f} s")


def kernels_only_ms(args, iters: int = 50) -> float:
    """Device time of egnn_message's two hand-written kernels alone: the
    CSR and the buffers are made once, outside the timed loop."""
    send, recv, emask, h, pos, _ = args
    (n, d), e = h.shape, send.shape[0]
    order, rowptr = edge.receiver_csr(recv, emask, n)
    bufs = [torch.empty(shape, dtype=torch.float32, device=h.device)
            for shape in ((e, d), (e, 3), (n, d), (n, 3), (n, 1))]
    return cuda_time_ms(
        lambda: edge._launch_kernels(*args, order, rowptr, *bufs), iters)


def bound_ms(args) -> tuple:
    """Least time for egnn_message on these inputs: bytes (each input read
    once, each output written once) over HBM rate vs operations that the
    masked-in edges need over the f32 rate."""
    send, recv, emask, h, pos, w = args
    n, d = h.shape
    e = send.shape[0]
    n_bytes = (2 * e * send.element_size() + e + 4 * h.numel() + 4 * pos.numel()
               + 4 * w.numel() + 4 * (n * d + n * 3 + n))
    e_live = int(emask.sum())
    # matrix products (2 ops per FMA), scale dot, three LayerNorm+ReLU
    # (~9 ops per element) and the receiver sum (d + 3 adds)
    per_edge = 2 * d * (2 * d + 1) + 4 * d * d + 2 * d + 27 * d + d + 3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = e_live * per_edge / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def random_case(n: int, e: int, d: int, seed: int, masked: float, dev,
                index_dtype=np.int32):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, d)).astype(np.float32)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    send = rng.integers(0, n, e).astype(index_dtype)
    recv = rng.integers(0, n, e).astype(index_dtype)
    emask = rng.random(e) >= masked
    w = (rng.normal(size=(msg_rows(d), d)) * 0.1).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (send, recv, emask, h, pos, w))


def star_case(graphs, model: EGNNFusedModel, seed: int, dev):
    """The first serving batch's edges and positions, random node features
    and layer 0's packed weights."""
    batch = next(iter(GraphLoader(graphs, BATCH, pad=pad_sizes(graphs, BATCH))))
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(
        rng.normal(size=(batch.num_nodes, model.emb_dim)).astype(np.float32))
    with torch.no_grad():
        w = model.convs[0].packed().detach().contiguous()
    return (batch.senders.to(dev), batch.receivers.to(dev),
            batch.edge_mask.to(dev), h.to(dev), batch.pos.to(dev), w.to(dev))


def box_case(model: EGNNFusedModel, seed: int, dev):
    """The unsorted 10k-atom box's edges and positions, random node
    features and layer 0's packed weights."""
    b = bench_scale.box_batch(GVP_BOX_ATOMS, sort=False).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((b.num_nodes, model.emb_dim), generator=gen, device=dev)
    with torch.no_grad():
        w = model.convs[0].packed().detach().contiguous().to(dev)
    return (b.senders, b.receivers, b.edge_mask, h, b.pos, w)


def check_resident_plans() -> None:
    """K1's plan in C (gmp_egnn_resident_plan) against edge.resident_plan
    at every width the wrapper takes and a range of edge and cluster
    counts."""
    lib = _build.load("egnn_message")
    out = (ctypes.c_int * 11)()
    for d in range(16, 257, 16):
        for e in (0, 5, 1400, 1408, 4193, 129_280):
            for clusters in (16, 66, 132):
                want = tuple(edge.resident_plan(d, e, clusters))
                _build.check(lib, lib.gmp_egnn_resident_plan(
                    d, e, clusters, ctypes.addressof(out)), "resident plan")
                got = (out[0], tuple(out[3:3 + out[0]]), out[1], out[2])
                if got != want:
                    raise AssertionError(f"K1's plan at D {d}, E {e}, {clusters} "
                                         f"clusters: C {got}, Python {want}")


def check_kernel_case(name: str, args) -> float:
    with torch.no_grad():
        got = egnn_message(*args)
        again = egnn_message(*args)
        want = egnn_message_plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: two runs of egnn_message differ bitwise")
    err = 0.0
    for g, w_, part in zip(got, want, ("msg", "pos", "cnt")):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: kernel {part} has non-finite values")
        err = max(err, (g - w_).abs().max().item())
        if not torch.allclose(g, w_, atol=ATOL, rtol=RTOL):
            raise AssertionError(
                f"{name}: kernel {part} differs from plain version by "
                f"{(g - w_).abs().max().item():.3e}")
    n, d = args[3].shape
    e = args[0].shape[0]
    plan, clusters = edge.kernel_resident_plan(
        e, d, args[3].device, args[0].dtype == torch.int64)
    log(f"  {name}: N={n} E={e} D={d} {args[0].dtype} "
        f"live={int(args[2].sum())} max_abs_err={err:.3e}, bitwise equal "
        f"twice; cluster {plan.cluster} (shares {list(plan.shares)}), tile "
        f"{plan.tile}, {plan.smem_bytes} B shared a block, up to {clusters} "
        "clusters")
    return err


def with_cotangents(args, seed: int):
    """``args`` of egnn_message plus random cotangents gmsg [N, D], gpos [N, 3]."""
    h = args[3]
    gen = torch.Generator(device=h.device).manual_seed(seed)
    return args + (torch.randn(h.shape, generator=gen, device=h.device),
                   torch.randn((h.shape[0], 3), generator=gen, device=h.device))


def train_bucket_case(loaders, model: EGNNFusedModel, seed: int, dev):
    """The first train batch of the bench split, assembled on the card from
    its slot data (N 800, E 1400), with random node features and
    cotangents and layer 0's packed weights."""
    slot = build_slot_data(loaders[0].graphs, device=dev)
    b = assemble_batch(slot, torch.arange(BATCH, device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((b.num_nodes, model.emb_dim), generator=gen, device=dev)
    with torch.no_grad():
        w = model.convs[0].packed().detach().contiguous().to(dev)
    return with_cotangents((b.senders, b.receivers, b.edge_mask, h, b.pos, w),
                           seed + 1)


def check_bwd_case(name: str, args, large: bool = False) -> float:
    """K2 against its plain version (tolerances in the module docstring);
    returns the largest absolute difference."""
    got = egnn_message_bwd(*args)
    want = egnn_message_bwd_plain(*args)
    torch.cuda.synchronize()
    n = args[3].shape[0]
    worst = 0.0
    for g, w_, part in zip(got, want, ("dh", "dpos", "dW")):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: K2 {part} has non-finite values")
        err = (g - w_).abs()
        top = err.max().item() if err.numel() else 0.0
        worst = max(worst, top)
        if part == "dW":
            tol = (1e-3 if large else 1e-5) * w_.abs().max().item()
            ok, detail = top <= tol, f"tol {tol:.3e}"
        elif not large:
            ok = torch.allclose(g, w_, atol=ATOL, rtol=RTOL)
            detail = f"atol=rtol={ATOL}"
        else:
            bad = int((err > ATOL + RTOL * w_.abs()).any(dim=1).sum())
            ok = bad <= 0.01 * n and top <= 0.1
            detail = f"{bad} of {n} rows beyond 1e-4"
        log(f"  {name}: K2 {part} max_abs_err={top:.3e} ({detail})")
        if large and part == "dW":
            # how far each f32 version lies from a float64 run of the plain
            # version: the flips hit both, at different entries
            exact = egnn_message_bwd_plain(*(
                t.double() if t.is_floating_point() else t for t in args))
            for g64, w64, e64, p64 in zip(got, want, exact, ("dh", "dpos", "dW")):
                log(f"  {name}: {p64} vs float64: K2 "
                    f"{(g64.double() - e64).abs().max().item():.3e}, plain f32 "
                    f"{(w64.double() - e64).abs().max().item():.3e}")
        if not ok:
            raise AssertionError(f"{name}: K2 {part} differs from its plain "
                                 f"version by {top:.3e} ({detail})")
    return worst


def bwd_kernels_only_ms(args, iters: int = 50) -> float:
    """Device time of K2's kernels alone: the CSRs and the scratch are made
    once, outside the timed loop."""
    send, recv, emask, h, pos, w, gmsg, gpos = args
    (n, d), e = h.shape, send.shape[0]
    csrs = (edge.receiver_csr(recv, emask, n), edge.sender_csr(send, emask, n))
    scratch = edge.bwd_scratch(n, e, d, h.device)
    return cuda_time_ms(lambda: edge._launch_bwd_kernels(*args, *csrs, scratch),
                        iters)


def bwd_bound_ms(args) -> tuple:
    """Least time for egnn_message_bwd on these inputs: bytes (each input
    read once, each output written once) over HBM rate vs the operations
    that the masked-in edges need over the f32 rate."""
    send, recv, emask, h, pos, w, gmsg, gpos = args
    n, d = h.shape
    e = send.shape[0]
    n_bytes = (2 * e * send.element_size() + e
               + 4 * (h.numel() + pos.numel() + w.numel() + gmsg.numel()
                      + gpos.numel())
               + 4 * (n * d + n * 3 + w.numel()))
    e_live = int(emask.sum())
    products = 2 * d * (2 * d + 1) + 4 * d * d   # one pass of the 3 stages
    # the forward recomputed once (products, scale dot, 3 LayerNorm+ReLU),
    # the input cotangents dz W^T and the weight gradients x^T dz (twice the
    # products), 3 LayerNorm backward (~12 ops per element with the gamma
    # and beta terms), the scale head's 4D, the node sums of dh_i and dh_j
    # (2D + 6) and the 11 vector rows of dW (11D)
    per_edge = 3 * products + 2 * d + 27 * d + 36 * d + 4 * d + 2 * d + 6 + 11 * d
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = e_live * per_edge / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


@contextlib.contextmanager
def patched(module, name: str, fn):
    """Run ``module``'s calls of ``name`` through ``fn`` (phase 5's witness
    and the planted faults of phases 5 and 5b)."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def without_weight_grad(send, recv, emask, h, pos, packed_w):
    """The planted fault: ``egnn_message`` with the packed weights cut off
    from the gradient, so that no msg_*/pos_* parameter learns."""
    return egnn_message(send, recv, emask, h, pos, packed_w.detach())


def first_step(model, device, dtype, graphs, row, cast_data: bool = False):
    """One ``train_step`` of a copy of ``model`` on the graphs ``row``:
    each parameter's gradient (zero where it got none) and its value after
    the Adam step, in float64 on the CPU.  ``cast_data``: positions and
    targets in ``dtype`` too (GVP-GNN's LayerNorms take one type)."""
    work = copy.deepcopy(model).to(device=device, dtype=dtype)
    slot = build_slot_data(graphs, device=device)
    if cast_data:
        slot.pos, slot.y = slot.pos.to(dtype), slot.y.to(dtype)
    train_step(work, make_tx(work.parameters(), LR), slot, row.to(device))
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in work.named_parameters()}
    return ({n: g.double().cpu() for n, g in grads.items()},
            {n: p.detach().double().cpu() for n, p in work.named_parameters()})


def step_reading(got, want) -> tuple:
    """How far one ``first_step`` lies from another: the largest gradient
    error relative to that parameter's largest reference entry, the count
    of gradient entries whose sign differs from a nonzero reference entry,
    the largest parameter distance after the step in units of lr, and the
    parameter of the largest gradient error."""
    err, flips, moved, worst = 0.0, 0, 0.0, ""
    for name, g in got[0].items():
        ref = want[0][name]
        top = ref.abs().max().item()
        diff = (g - ref).abs().max().item()
        if (diff / top if top > 0 else diff) > err:
            err, worst = (diff / top if top > 0 else diff), name
        flips += int(((torch.sign(g) != torch.sign(ref)) & (ref != 0)).sum())
        moved = max(moved, (got[1][name] - want[1][name]).abs().max().item() / LR)
    return err, flips, moved, worst


def fired_epochs(per_epoch: np.ndarray) -> int:
    """Epochs whose best-val rule fired (validation <= best so far, f32),
    each of which evaluated the test set."""
    best, fired = np.float32(np.inf), 0
    for val in per_epoch[:, 1].astype(np.float32):
        if val <= best:
            best, fired = val, fired + 1
    return fired


SEG_TOL = 1e-5    # K3 and K4 against their plain versions, atol = rtol
BOX_ATOMS, BOX_CHECK_ATOMS, BOX_STEPS = 100_000, 2_000, 4


def check_segsum(label: str, data, seg, mask, n: int, plan=None,
                 timed: bool = True, iters: int = 50,
                 long_rows: bool = False) -> dict:
    """K3 (through ``plan``) or, without a plan, K4 on these inputs against
    the plain version: within SEG_TOL, finite, two runs bitwise equal; then,
    when ``timed``, the times.  ``long_rows`` (segments of ~1e5 rows, whose
    f32 sums in any order lie ~1e-2 from the exact one): both held to a
    float64 sum instead, the kernel no farther than twice the plain
    version plus SEG_TOL of the largest sum.  Returns the reading."""
    if plan is not None:
        def call():
            return sss.sorted_segment_sum(data, plan, seg, mask)
        order, rowptr = plan.perm, plan.rowptr
        perm = None if plan.identity_perm else plan.perm
        index_bytes = (8 * (n + 1) + (0 if perm is None
                                      else 8 * int(rowptr[-1])))
    else:
        def call():
            return sss.segment_sum(data, seg, n, mask)
        order, rowptr = edge.receiver_csr(seg, mask, n)
        perm = order
        index_bytes = seg.shape[0] * (seg.element_size() + 1)
    with torch.no_grad():
        got, again = call(), call()
        want = sss.sorted_segment_sum_plain(data, seg, n, mask)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite values")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if long_rows:
        exact = sss.sorted_segment_sum_plain(data.double(), seg, n, mask)
        d_k = (got.double() - exact).abs().max().item()
        d_p = (want.double() - exact).abs().max().item()
        log(f"  {label}: vs float64, kernel {d_k:.3e}, plain {d_p:.3e}")
        if d_k > 2 * d_p + SEG_TOL * exact.abs().max().item():
            raise AssertionError(f"{label}: {d_k:.3e} from the float64 sum, "
                                 f"the plain version {d_p:.3e}")
    elif not torch.allclose(got, want, atol=SEG_TOL, rtol=SEG_TOL):
        raise AssertionError(f"{label}: differs from the plain version by "
                             f"{err:.3e}")
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two runs differ bitwise")
    live, d = int(rowptr[-1]), data.shape[1]
    reading = {"shape": label, "E": data.shape[0], "live": live, "N": n,
               "D": d, "max_abs_err": err}
    if not timed:
        log(f"  {label}: E={data.shape[0]} live={live} N={n} D={d} "
            f"max_abs_err={err:.3e}, bitwise repeatable")
        return reading
    out = torch.empty_like(got)
    scan = plan is None and sss.segsum_route(data.shape[0], n)[0] == "scan"
    with torch.no_grad():
        if scan:     # K4's one launch: the ids and the mask read in place
            k_ms = cuda_time_ms(lambda: sss.launch_scan_segsum(
                data, seg, mask, out), iters)
        else:
            k_ms = cuda_time_ms(lambda: sss.launch_csr_segsum(
                data, perm, rowptr, out), iters)
        call_ms = cuda_time_ms(call, iters)
        plain_ms = cuda_time_ms(
            lambda: sss.sorted_segment_sum_plain(data, seg, n, mask), iters)
        lib_ms, reduce_ms = bench_kernels.segsum_library_ms(data, seg, mask, n,
                                                            iters)
    b_ms, b_by = seg_bound_ms(live, d, n, index_bytes)
    log(f"  {label}: E={data.shape[0]} live={live} N={n} D={d} "
        f"max_abs_err={err:.3e}; kernel {k_ms:.4f} ms, whole call "
        f"{call_ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ {lib_ms:.4f} "
        f"ms, segment_reduce {reduce_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return dict(reading, ms=k_ms, call_ms=call_ms, plain_ms=plain_ms,
                library_ms=lib_ms, segment_reduce_ms=reduce_ms, bound_ms=b_ms,
                bound_by=b_by)


def random_seg_case(e: int, n: int, d: int, seed: int, masked: float, dev):
    rng = np.random.default_rng(seed)
    seg = torch.from_numpy(rng.integers(0, n, e)).to(dev)
    data = torch.from_numpy(rng.standard_normal((e, d)).astype(np.float32))
    mask = torch.from_numpy(rng.random(e) >= masked).to(dev)
    return data.to(dev), seg, mask


def box_rows(box, d: int, seed: int):
    """Random f32 rows [E, d] for the edges of ``box`` (on the card)."""
    gen = torch.Generator(device=box.pos.device).manual_seed(seed)
    return torch.randn((box.num_edges, d), generator=gen,
                       device=box.pos.device)


def box_grads(model, batch, plans, device, dtype) -> dict:
    """One bench_scale step of a copy of ``model`` on ``batch`` with the
    segment plans ``plans(batch on device)``: each parameter's gradient
    (zero where it got none), float64 on the CPU."""
    work = copy.deepcopy(model).to(device=device, dtype=dtype)
    b = batch.to(device)
    b.pos, b.y = b.pos.to(dtype), b.y.to(dtype)
    bench_scale.make_step(work, b, plans(b))()
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)
                ).double().cpu() for n, p in work.named_parameters()}


def grad_error(got: dict, want: dict) -> float:
    """Largest gradient error relative to that parameter's largest entry."""
    err = 0.0
    for name, g in got.items():
        top = want[name].abs().max().item()
        diff = (g - want[name]).abs().max().item()
        err = max(err, diff / top if top > 0 else diff)
    return err


def sender_backward_on_receiver_plan(b):
    """The planted fault of phase 6b: the receiver plan given for the
    sender gather's backward."""
    plans = sss.batch_seg_plans(b)
    return {"rcv": plans["rcv"], "snd": plans["rcv"]}


# ---------------------------------------------------------------------------
# GVP-GNN and its message kernels (K5)
# ---------------------------------------------------------------------------

GVP_LAYERS, GVP_EPOCHS = 4, 50
GVP_BOX_ATOMS = 10_000      # K5's large shape: the unsorted 10k box
FLIP_MARGIN = 1e-5          # ReLU pre-activations closer to 0 may flip
W_TOL, W_TOL_BOX = 1e-5, 1e-3   # K5's dW against its plain version


def gvp_model(device, use_pallas: bool = True, **kw) -> GVPGNNModel:
    """The slice's model: GVP-GNN at its defaults (128/16 nodes, 32/1
    edges), 4 layers, star-graph input and output widths, seed 0."""
    return GVPGNNModel(num_layers=GVP_LAYERS, in_dim=1, out_dim=1,
                       use_pallas=use_pallas, device=device,
                       generator=torch.Generator().manual_seed(0), **kw)


def without_dropout(model):
    """A copy of ``model`` with every dropout rate 0 (the card's and the
    CPU's generators draw different masks)."""
    work = copy.deepcopy(model)
    for m in work.modules():
        if isinstance(m, GVPDropout):
            m.rate = 0.0
    return work


def gvp_random_case(n, e, seed, masked, dev, node=(16, 4), edge_dims=(8, 1),
                    layers=3):
    """K5's inputs drawn at random as the JAX test draws them, with random
    cotangents: (indices, node planes, edge planes, weights, cotangents)."""
    rng = np.random.default_rng(seed)
    (S, V), (SE, VE) = node, edge_dims
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(dev)
    dims = [(2 * S + SE, 2 * V + VE)] + [node] * layers
    ws = []
    for k in range(layers):
        (si, vi), (so, vo) = dims[k], dims[k + 1]
        h = max(vi, vo)
        ws += [f(vi, h) * 0.2, f(h, vo) * 0.2, f(si + h, so) * 0.1,
               f(so) * 0.1, f(so, vo) * 0.1, f(vo) * 0.1]
    idx = tuple(torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, n, e).astype(np.int32),
        rng.integers(0, n, e).astype(np.int32), rng.random(e) >= masked))
    return (idx, [f(n, S)] + [f(n, V) for _ in range(3)],
            [f(e, SE)] + [f(e, VE) for _ in range(3)], ws,
            [f(n, S)] + [f(n, V) for _ in range(3)])


def check_gvp_fwd(label: str, case) -> float:
    """K5 forward against its plain version (atol = rtol = 1e-4), finite,
    two runs bitwise equal; returns the largest difference."""
    idx, nodes, edges, ws, _ = case
    with torch.no_grad():
        got = gm.gvp_message(*idx, *nodes, *edges, *ws)
        again = gm.gvp_message(*idx, *nodes, *edges, *ws)
        want = gm.gvp_message_plain(*idx, *nodes, *edges, ws, len(ws) // gm.N_W)
    torch.cuda.synchronize()
    err = 0.0
    for g, a, w_, part in zip(got, again, want, ("s", "vx", "vy", "vz", "cnt")):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label}: K5 {part} has non-finite values")
        if not torch.equal(g, a):
            raise AssertionError(f"{label}: K5 {part}: two runs differ bitwise")
        top = (g - w_).abs().max().item() if g.numel() else 0.0
        err = max(err, top)
        if not torch.allclose(g, w_, atol=ATOL, rtol=RTOL):
            raise AssertionError(f"{label}: K5 {part} differs from the plain "
                                 f"version by {top:.3e}")
    log(f"  {label}: N={nodes[0].shape[0]} E={idx[0].shape[0]} "
        f"live={int(idx[2].sum())} widths {gm.chain_dims(ws)[0]} "
        f"max_abs_err={err:.3e}, bitwise repeatable")
    return err


def check_gvp_bwd(label: str, case, w_tol: float = W_TOL) -> float:
    """K5 backward against its plain version, two runs bitwise equal.  An
    edge with a ReLU pre-activation within FLIP_MARGIN of zero (float64 run,
    ``gm.relu_margins``) may take that mask one way in the kernel and the
    other in the plain version, and its cotangents then differ by O(1):
    such edges are masked off, and their count printed.  Then the 8 feature
    cotangents must lie within atol = rtol = 1e-4 and each weight's
    gradient within ``w_tol`` of that weight's largest entry (at least 1).
    At full width both f32 versions' distances from a float64 run are
    printed."""
    idx, nodes, edges, ws, cots = case
    margins = gm.relu_margins(*idx, nodes, edges, ws)
    near = margins <= FLIP_MARGIN
    live = int(idx[2].sum())
    idx = (idx[0], idx[1], idx[2] & ~near)
    got = gm.gvp_message_bwd(*idx, *nodes, *edges, ws, *cots)
    again = gm.gvp_message_bwd(*idx, *nodes, *edges, ws, *cots)
    want = gm.gvp_message_bwd_plain(*idx, *nodes, *edges, ws, *cots)
    torch.cuda.synchronize()
    names = [f"gvp{k}.{w}" for k in range(len(ws) // gm.N_W)
             for w in ("Wh", "Wv", "Ws", "bs", "Wsv", "bsv")]
    parts = ["ds", "dvx", "dvy", "dvz", "des", "devx", "devy", "devz"] + names
    got_all, again_all = list(got[:8]) + got[8], list(again[:8]) + again[8]
    want_all = list(want[:8]) + want[8]
    worst, report, w_worst = 0.0, [], (0.0, "")
    for i, (g, a, w_, part) in enumerate(zip(got_all, again_all, want_all,
                                             parts)):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label}: K5 backward {part} is not finite")
        if not torch.equal(g, a):
            raise AssertionError(f"{label}: K5 backward {part}: two runs "
                                 "differ bitwise")
        top = (g - w_).abs().max().item() if g.numel() else 0.0
        worst = max(worst, top)
        if i < 8:
            ok = torch.allclose(g, w_, atol=ATOL, rtol=RTOL)
            report.append(f"{part} {top:.2e}")
        else:
            scale = max(w_.abs().max().item(), 1.0)
            ok = top <= w_tol * scale
            w_worst = max(w_worst, (top / scale, part))
        if not ok:
            raise AssertionError(f"{label}: K5 backward {part} differs from its "
                                 f"plain version by {top:.3e}")
    log(f"  {label}: K5 backward max_abs_err " + ", ".join(report)
        + f"; dW worst {w_worst[0]:.2e} of its largest entry ({w_worst[1]}, "
        f"tol {w_tol:g}); {int(near.sum())} of {live} live edges within "
        f"{FLIP_MARGIN:g} of a ReLU flip masked off (smallest margin "
        f"{margins.min().item() if margins.numel() else float('inf'):.2e}); "
        "bitwise repeatable")
    if nodes[0].shape[1] >= 128:
        f64 = lambda ts: [t.double() for t in ts]  # noqa: E731
        exact = gm.gvp_message_bwd_plain(*idx, *f64(nodes), *f64(edges),
                                         f64(ws), *f64(cots))
        exact_all = list(exact[:8]) + [torch.cat([d.reshape(-1) for d in exact[8]])]
        flat = lambda ts: list(ts[:8]) + [torch.cat(  # noqa: E731
            [d.reshape(-1) for d in ts[8:]])]
        log(f"  {label}: vs float64, kernel / plain f32: " + ", ".join(
            f"{p} {(g.double() - x).abs().max().item():.2e} / "
            f"{(w_.double() - x).abs().max().item():.2e}"
            for g, w_, x, p in zip(flat(got_all), flat(want_all), exact_all,
                                   parts[:8] + ["dW"]) if x.numel()))
    return worst


def gvp_kernels_ms(case, iters: int, backward: bool) -> float:
    """Device time of K5's kernels alone (forward or backward): the CSRs,
    the flat weights and the buffers are made once, outside the loop."""
    (send, recv, emask), nodes, edges, ws, cots = case
    n = nodes[0].shape[0]
    dims, w = gm.chain_dims(ws), gm._flat(ws)
    rcsr = edge.receiver_csr(recv, emask, n)
    if not backward:
        so, vo = dims[-1][3], dims[-1][4]
        outs = [torch.empty((n, width), device=w.device)
                for width in (so, vo, vo, vo, 1)]
        return cuda_time_ms(lambda: gm.launch_fwd(
            send, recv, emask, nodes, edges, w, dims, rcsr, outs), iters)
    scsr = edge.sender_csr(send, emask, n)
    bufs = gm.bwd_buffers(send, nodes, edges, ws, dims)
    return cuda_time_ms(lambda: gm.launch_bwd(
        send, recv, emask, nodes, edges, w, dims, cots, rcsr, scsr, bufs), iters)


def gvp_bound_ms(case, backward: bool) -> tuple:
    """Least time for K5 on these inputs: bytes (each input read once, each
    output written once) over the HBM rate against the operations the live
    edges need over the f32 rate.  Per live edge: the chain's products
    2 sum(3 vi h + (si+h) so + 3 h vo + so vo), about 12 ops per activation
    element (norm, bias, ReLU, two sigmoids, the gate) and the receiver sum;
    backward: the forward recomputed, the products twice more (input
    cotangents and weight gradients), the elementwise work twice more and the
    two node sums."""
    (send, recv, emask), nodes, edges, ws, cots = case
    dims = gm.chain_dims(ws)
    n, e = nodes[0].shape[0], send.shape[0]
    products = sum(2 * (3 * vi * h + (si + h) * so + 3 * h * vo + so * vo)
                   for si, vi, h, so, vo in dims)
    elementwise = sum(12 * (h + so + 3 * vo) for si, vi, h, so, vo in dims)
    so, vo = dims[-1][3], dims[-1][4]
    feats = sum(t.numel() for t in nodes + edges)
    weights = sum(w.numel() for w in ws)
    n_bytes = 2 * e * send.element_size() + e + 4 * (feats + weights)
    if backward:
        n_bytes += 4 * (sum(c.numel() for c in cots) + feats + weights)
        per_edge = 3 * products + 3 * elementwise + 2 * (
            nodes[0].shape[1] + 3 * nodes[1].shape[1])
    else:
        n_bytes += 4 * n * (so + 3 * vo + 1)
        per_edge = products + elementwise + so + 3 * vo + 1
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = int(emask.sum()) * per_edge / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def without_edge_grad(send, recv, emask, s, vx, vy, vz, es, evx, evy, evz,
                      *ws):
    """The planted fault of phase 5b: ``gvp_message`` with the edge
    features cut off from the gradient (K5's edge cotangents dropped), so
    ``W_e`` and ``W_e_norm`` learn nothing."""
    return gm.gvp_message(send, recv, emask, s, vx, vy, vz, es.detach(),
                          evx.detach(), evy.detach(), evz.detach(), *ws)


# ---------------------------------------------------------------------------
# The whole EGNN stack (K6)
# ---------------------------------------------------------------------------

def model_wall(model: EGNNFusedModel, dev) -> torch.Tensor:
    """The stacked rows ``[L, 7D+18, D]`` of ``model``'s layers, on ``dev``."""
    with torch.no_grad():
        return torch.stack([c.stack_packed() for c in model.convs]).to(dev)


def stack_random_case(n: int, e: int, d: int, layers: int, seed: int, dev):
    """K6's inputs drawn at random as the JAX test draws them (LayerNorm
    scale rows at 1), with random cotangents: (args, cotangents)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(layers, es.stack_rows(d), d)) * 0.1).astype(np.float32)
    for row in (2 * d + 2, 3 * d + 5, 4 * d + 8, 6 * d + 13, 7 * d + 16):
        w[:, row, :] = 1.0
    arrays = (rng.integers(0, n, e).astype(np.int32),
              rng.integers(0, n, e).astype(np.int32), rng.random(e) >= 0.15,
              rng.normal(size=(n, d)).astype(np.float32),
              rng.normal(size=(n, 3)).astype(np.float32), w,
              rng.normal(size=(n, d)).astype(np.float32),
              rng.normal(size=(n, 3)).astype(np.float32))
    t = tuple(torch.from_numpy(a).to(dev) for a in arrays)
    return t[:6], t[6:]


def stack_case(batch, wall: torch.Tensor, seed: int):
    """K6's inputs on ``batch`` (on the card): random node features and
    cotangents, the given stacked rows: (args, cotangents)."""
    dev = batch.pos.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, d = batch.num_nodes, wall.shape[2]
    draw = lambda w: torch.randn((n, w), generator=gen, device=dev)  # noqa: E731
    return ((batch.senders, batch.receivers, batch.edge_mask, draw(d),
             batch.pos, wall), (draw(d), draw(3)))


def check_stack_fwd(label: str, case) -> float:
    """K6 forward against its plain version (atol = rtol = 1e-4), finite,
    two runs bitwise equal; returns the largest difference."""
    args, _ = case
    layers = args[5].shape[0]
    with torch.no_grad():
        got, again = (es.egnn_stack(*args, layers) for _ in range(2))
        want = es.egnn_stack_plain(*args, layers)
    torch.cuda.synchronize()
    err = 0.0
    for g, a, w_, part in zip(got, again, want, ("h", "pos")):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label}: K6 {part} has non-finite values")
        if not torch.equal(g, a):
            raise AssertionError(f"{label}: K6 {part}: two runs differ bitwise")
        err = max(err, (g - w_).abs().max().item())
        if not torch.allclose(g, w_, atol=ATOL, rtol=RTOL):
            raise AssertionError(f"{label}: K6 {part} differs from the plain "
                                 f"version by {(g - w_).abs().max().item():.3e}")
    log(f"  {label}: N={args[3].shape[0]} E={args[0].shape[0]} "
        f"live={int(args[2].sum())} D={args[3].shape[1]} L={layers} "
        f"max_abs_err={err:.3e}, bitwise repeatable")
    return err


def check_stack_bwd(label: str, case, large: bool = False) -> float:
    """K6 backward against its plain version (tolerances in the module
    docstring; ``large``: the float64 rule), two runs bitwise equal; returns
    the largest difference from the plain version."""
    args, cot = case
    layers = args[5].shape[0]
    got, again = (es.egnn_stack_bwd(*args, layers, *cot) for _ in range(2))
    want = es.egnn_stack_bwd_plain(*args, layers, *cot)
    exact = (es.egnn_stack_bwd_plain(
        *(t.double() if t.is_floating_point() else t for t in args), layers,
        *(c.double() for c in cot)) if large else None)
    torch.cuda.synchronize()
    n = args[3].shape[0]
    worst, report = 0.0, []
    for i, (g, a, w_, part) in enumerate(zip(got, again, want,
                                             ("dh0", "dpos0", "dW"))):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label}: K6 backward {part} is not finite")
        if not torch.equal(g, a):
            raise AssertionError(f"{label}: K6 backward {part}: two runs "
                                 "differ bitwise")
        top = (g - w_).abs().max().item() if g.numel() else 0.0
        worst = max(worst, top)
        if not large:
            if part == "dW":
                rel = max((g[l] - w_[l]).abs().max().item()
                          / max(w_[l].abs().max().item(), 1.0)
                          for l in range(layers))
                ok = rel <= 1e-5
                report.append(f"dW {top:.2e} (worst layer {rel:.2e} of its "
                              "largest entry)")
            else:
                ok = torch.allclose(g, w_, atol=ATOL, rtol=RTOL)
                report.append(f"{part} {top:.2e}")
        else:
            x = exact[i]
            dk, dp = (g.double() - x).abs(), (w_.double() - x).abs()
            if part == "dW":
                rel = [(dk[l].max() / x[l].abs().max()).item()
                       for l in range(layers)]
                rel_p = [(dp[l].max() / x[l].abs().max()).item()
                         for l in range(layers)]
                ok = all(r <= 2 * q + 1e-3 for r, q in zip(rel, rel_p))
                report.append(f"dW vs plain {top:.2e}; worst layer vs float64 "
                              f"kernel {max(rel):.2e} / plain f32 "
                              f"{max(rel_p):.2e} of its largest entry")
            else:
                tol = ATOL + RTOL * x.abs()
                rows_k = int((dk > tol).any(dim=1).sum())
                rows_p = int((dp > tol).any(dim=1).sum())
                ok = (rows_k <= 2 * rows_p + 0.005 * n
                      and dk.max().item() <= 0.1 * x.abs().max().item())
                report.append(f"{part} vs plain {top:.2e}; vs float64 kernel "
                              f"{dk.max().item():.2e} ({rows_k} rows beyond "
                              f"1e-4) / plain f32 {dp.max().item():.2e} "
                              f"({rows_p} rows) of {n}")
        if not ok:
            raise AssertionError(f"{label}: K6 backward {part} differs from "
                                 f"its plain version: {report[-1]}")
    log(f"  {label}: K6 backward max_abs_err " + ", ".join(report)
        + "; bitwise repeatable")
    return worst


def stack_kernel_ms(case, iters: int, backward: bool) -> float:
    """Device time of K6 alone (forward or backward): the CSRs and the
    buffers are made once, outside the loop."""
    args, cot = case
    send, recv, emask, h = args[:4]
    n, d = h.shape
    rcsr = edge.receiver_csr(recv, emask, n)
    if not backward:
        bufs = es.fwd_buffers(n, send.shape[0], d, h.device)
        return cuda_time_ms(lambda: es._launch_fwd(*args, *rcsr, bufs), iters)
    scsr = edge.sender_csr(send, emask, n)
    bufs = es.bwd_buffers(n, send.shape[0], d, args[5].shape[0], h.device)
    return cuda_time_ms(lambda: es._launch_bwd(*args, *cot, rcsr, scsr, bufs),
                        iters)


def stack_bound_ms(case, backward: bool) -> tuple:
    """Least time for K6 on these inputs: bytes (each input read once, each
    output written once) over the HBM rate against the operations the live
    edges and the nodes need over the f32 rate.  Per layer and live edge:
    the message MLP's products 2D(2D+1) + 4D^2, the scale dot 2D, three
    LayerNorm+ReLU (~9 ops per element) and the receiver sum D + 3; per
    node: the update MLP's products 6D^2, two LayerNorm+ReLU, the residual
    and the position update D + 6.  Backward: that forward once, the
    products twice more (input cotangents, weight gradients), LayerNorm
    backward (~12 ops per element), the scale head's 4D, the node sums of
    the edge cotangents 2D + 6 and the vector rows of dW (11D per edge, 6D
    per node)."""
    (send, recv, emask, h, pos, w), (gh, gpos) = case
    (n, d), e, layers = h.shape, send.shape[0], w.shape[0]
    edge_prod, node_prod = 2 * d * (2 * d + 1) + 4 * d * d, 6 * d * d
    edge_elem, node_elem = 2 * d + 27 * d + d + 3, 18 * d + d + 6
    n_bytes = 2 * e * send.element_size() + e + 4 * (h.numel() + pos.numel()
                                                     + w.numel())
    if backward:
        n_bytes += 4 * (gh.numel() + gpos.numel()) + 4 * (
            h.numel() + pos.numel() + w.numel())
        per_edge = 3 * edge_prod + edge_elem + 36 * d + 4 * d + 2 * d + 6 + 11 * d
        per_node = 3 * node_prod + node_elem + 24 * d + 6 * d
    else:
        n_bytes += 4 * (h.numel() + pos.numel())
        per_edge, per_node = edge_prod + edge_elem, node_prod + node_elem
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = layers * (int(emask.sum()) * per_edge + n * per_node) / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def without_update_grad(send, recv, emask, h0, pos0, wall, n_layers):
    """The planted fault of phase 5c: ``egnn_stack`` with the update-MLP
    rows of the stacked weights cut off from the gradient (their dW rows
    dropped), so no ``upd_*`` parameter learns."""
    mr = msg_rows(h0.shape[1])
    return es.egnn_stack(send, recv, emask, h0, pos0,
                         torch.cat([wall[:, :mr], wall[:, mr:].detach()], dim=1),
                         n_layers)


# ---------------------------------------------------------------------------
# TFN and the per-edge CG contraction (K7)
# ---------------------------------------------------------------------------

TFN_NARROW = dict(num_layers=2, emb_dim=16)   # a step held to float64


def tfn_model(device, **kw):
    """TFN at its star configuration (``kw`` overrides), weights from seed 0."""
    return _tfn_model(torch.Generator().manual_seed(0), device, **kw)
# 6g: the JAX number's 200 epochs cut to 100 for time; three 100-epoch
# repeats on the H100 0.07897 +- 0.00250 (experiments/seed_spread.py)
TFN_EPOCHS, TFN_MAE_MAX = 100, 0.09
TFN_JAX_MAE, TFN_JAX_SD, TFN_REF_MAE = 0.0637, 0.0010, 0.0667
K7_TOL, K7_TOL_BF16 = 2e-5, 3e-2   # the JAX test's, x max(|ref|, 1)
K7_PLAIN_TOL = 1e-3   # full-width step, K7/K4 vs the plain twins, both f32


def k7_case(e: int, k: int, w: int, m: int, wdtype, seed: int, dev):
    """K7's inputs drawn at random (standard normal, as the JAX test):
    T [E, K, m], W [E, K, w] in ``wdtype``, a cotangent dO [E, w, m]."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((e, k, m), generator=gen, device=dev),
            torch.randn((e, k, w), generator=gen, device=dev).to(wdtype),
            torch.randn((e, w, m), generator=gen, device=dev))


def k7_bound_ms(T, W, backward: bool) -> tuple:
    """Least time for K7 on these inputs: bytes (forward: T and W read, out
    written; backward: T, W and dO read, dT and dW written) over the HBM
    rate against 2 E K w m operations forward (4 E K w m backward) over the
    f32 rate."""
    e, k, m = T.shape
    w = W.shape[2]
    t_bytes, w_bytes, o_bytes = 4 * T.numel(), W.element_size() * W.numel(), \
        4 * e * w * m
    n_bytes = (2 * t_bytes + 2 * w_bytes + o_bytes if backward
               else t_bytes + w_bytes + o_bytes)
    ops = (4 if backward else 2) * e * k * w * m
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b > t_o else (t_o, "operations")


def check_k7(label: str, case, timed: bool = True, iters: int = 20) -> dict:
    """K7 forward and backward against the plain versions: within K7_TOL
    (K7_TOL_BF16 for bf16 W) of max(|ref|, 1), finite, dW in W's type, two
    runs bitwise equal; then, when ``timed``, kernel, whole call, plain
    version and ``torch.bmm`` (the library: one call forward, two backward,
    on an f32 copy of W made outside the loop) beside the bound."""
    T, W, dO = case
    tol = K7_TOL if W.dtype == torch.float32 else K7_TOL_BF16
    with torch.no_grad():
        got, again = (ec.edge_weighted_contract(T, W) for _ in range(2))
        want = ec.edge_weighted_contract_plain(T, W)
        (dT, dW), (dT2, dW2) = (ec.edge_weighted_contract_bwd(T, W, dO)
                                for _ in range(2))
        wdT, wdW = ec.edge_weighted_contract_bwd_plain(T, W, dO)
    torch.cuda.synchronize()
    if dW.dtype != W.dtype or dT.dtype != torch.float32:
        raise AssertionError(f"{label}: K7 backward types {dT.dtype}, {dW.dtype}")
    errs = {}
    for part, g, a, r in (("out", got, again, want), ("dT", dT, dT2, wdT),
                          ("dW", dW.float(), dW2.float(), wdW.float())):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{label}: K7 {part} has non-finite values")
        if not torch.equal(g, a):
            raise AssertionError(f"{label}: K7 {part}: two runs differ bitwise")
        err = (g - r).abs().max().item()
        scale = max(r.abs().max().item(), 1.0)
        if err > tol * scale:
            raise AssertionError(f"{label}: K7 {part} differs from the plain "
                                 f"version by {err:.3e} (tol {tol * scale:.3e})")
        errs[part] = err
    e, k, m = T.shape
    w = W.shape[2]
    reading = {"shape": label, "E": e, "K": k, "m": m, "w": w,
               "W": str(W.dtype).replace("torch.", ""),
               "max_abs_err": max(errs.values()), "errors": errs}
    head = (f"  {label}: E={e} K={k} m={m} w={w} W {reading['W']} errors "
            + ", ".join(f"{p} {v:.2e}" for p, v in errs.items()))
    if not timed:
        log(head + " (tol " f"{tol:g} of max(|ref|, 1)), bitwise repeatable")
        return reading
    out, dTb, dWb = torch.empty_like(got), torch.empty_like(T), torch.empty_like(W)
    Wf = W if W.dtype == torch.float32 else W.float()
    with torch.no_grad():
        fwd = dict(
            ms=cuda_time_ms(lambda: ec.launch_fwd(T, W, out), iters),
            call_ms=cuda_time_ms(lambda: ec.edge_weighted_contract(T, W), iters),
            plain_ms=cuda_time_ms(lambda: ec.edge_weighted_contract_plain(T, W),
                                  iters),
            library_ms=cuda_time_ms(lambda: torch.bmm(Wf.transpose(1, 2), T),
                                    iters))
        bwd = dict(
            ms=cuda_time_ms(lambda: ec.launch_bwd(T, W, dO, dTb, dWb), iters),
            call_ms=cuda_time_ms(lambda: ec.edge_weighted_contract_bwd(T, W, dO),
                                 iters),
            plain_ms=cuda_time_ms(
                lambda: ec.edge_weighted_contract_bwd_plain(T, W, dO), iters),
            library_ms=cuda_time_ms(lambda: (torch.bmm(Wf, dO), torch.bmm(
                T, dO.transpose(1, 2))), iters))
    for d, back in ((fwd, False), (bwd, True)):
        d["bound_ms"], d["bound_by"] = k7_bound_ms(T, W, back)
    log(head + "; " + "; ".join(
        f"{name} kernel {d['ms']:.4f} ms, whole call {d['call_ms']:.4f}, plain "
        f"{d['plain_ms']:.4f}, bmm {d['library_ms']:.4f}, bound "
        f"{d['bound_ms']:.5f} ({d['bound_by']})"
        for name, d in (("forward", fwd), ("backward", bwd))))
    return dict(reading, fwd=fwd, bwd=bwd)


def k7_layer_sum(readings) -> dict:
    """A layer's K7 times group by group (one launch per group): its
    groups' readings summed, per direction."""
    out = {}
    for direction in ("fwd", "bwd"):
        keys = ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms")
        out[direction] = {k: sum(r[direction][k] for r in readings) for k in keys}
        bys = {r[direction]["bound_by"] for r in readings}
        out[direction]["bound_by"] = bys.pop() if len(bys) == 1 else "mixed"
    return out


def check_k7_layer(label: str, cases, iters: int = 20) -> dict:
    """A layer's groups in one grouped K7 launch per direction
    (``edge_weighted_contract_grouped``) against the plain versions group
    by group (``check_k7``'s tolerances, dW in W's type), two runs bitwise
    equal, exactly one launch each way; then kernel, whole call, the groups'
    plain versions and their ``torch.bmm`` calls (one per group forward, two
    backward, f32 copies of W made outside the loop), all summed over the
    groups, beside the summed bound; and the layer as one one-group kernel
    launch per group back to back (``one_group_ms``)."""
    Ts, Ws, dOs = (list(x) for x in zip(*cases))
    tol = K7_TOL if Ws[0].dtype == torch.float32 else K7_TOL_BF16
    before = (ec.edge_weighted_contract_grouped.launches,
              ec.edge_weighted_contract_grouped.bwd_launches)
    with torch.no_grad():
        got, again = (ec.edge_weighted_contract_grouped(Ts, Ws)
                      for _ in range(2))
        grads, grads2 = (ec.edge_weighted_contract_grouped_bwd(Ts, Ws, dOs)
                         for _ in range(2))
    torch.cuda.synchronize()
    launched = (ec.edge_weighted_contract_grouped.launches - before[0],
                ec.edge_weighted_contract_grouped.bwd_launches - before[1])
    if launched != (2, 2):
        raise AssertionError(f"{label}: grouped K7 launched {launched}, not "
                             "one kernel per call and direction")
    err = 0.0
    for g, (T, W, dO) in enumerate(cases):
        want = ec.edge_weighted_contract_plain(T, W)
        wdT, wdW = ec.edge_weighted_contract_bwd_plain(T, W, dO)
        dT, dW = grads[0][g], grads[1][g]
        if dW.dtype != W.dtype:
            raise AssertionError(f"{label} group {g}: dW is {dW.dtype}")
        for part, a, b, r in (("out", got[g], again[g], want),
                              ("dT", dT, grads2[0][g], wdT),
                              ("dW", dW.float(), grads2[1][g].float(),
                               wdW.float())):
            if not torch.isfinite(a).all() or not torch.equal(a, b):
                raise AssertionError(f"{label} group {g}: K7 {part} is not "
                                     "finite or not bitwise repeatable")
            e = (a - r).abs().max().item()
            if e > tol * max(r.abs().max().item(), 1.0):
                raise AssertionError(f"{label} group {g}: grouped K7 {part} "
                                     f"differs from the plain version by {e:.3e}")
            err = max(err, e)
    outs = [torch.empty_like(o) for o in got]
    dTb = [torch.empty_like(T) for T in Ts]
    dWb = [torch.empty_like(W) for W in Ws]
    Wf = [W if W.dtype == torch.float32 else W.float() for W in Ws]
    with torch.no_grad():
        fwd = dict(
            ms=cuda_time_ms(lambda: ec.launch_grouped_fwd(Ts, Ws, outs), iters),
            one_group_ms=cuda_time_ms(lambda: [ec.launch_fwd(T, W, o) for T, W, o
                                               in zip(Ts, Ws, outs)], iters),
            call_ms=cuda_time_ms(lambda: ec.edge_weighted_contract_grouped(
                Ts, Ws), iters),
            plain_ms=cuda_time_ms(lambda: [ec.edge_weighted_contract_plain(
                T, W) for T, W in zip(Ts, Ws)], iters),
            library_ms=cuda_time_ms(lambda: [torch.bmm(W.transpose(1, 2), T)
                                             for T, W in zip(Ts, Wf)], iters))
        bwd = dict(
            ms=cuda_time_ms(lambda: ec.launch_grouped_bwd(Ts, Ws, dOs, dTb, dWb),
                            iters),
            one_group_ms=cuda_time_ms(lambda: [
                ec.launch_bwd(T, W, dO, a, b)
                for T, W, dO, a, b in zip(Ts, Ws, dOs, dTb, dWb)], iters),
            call_ms=cuda_time_ms(lambda: ec.edge_weighted_contract_grouped_bwd(
                Ts, Ws, dOs), iters),
            plain_ms=cuda_time_ms(lambda: [ec.edge_weighted_contract_bwd_plain(
                T, W, dO) for T, W, dO in zip(Ts, Ws, dOs)], iters),
            library_ms=cuda_time_ms(lambda: [
                (torch.bmm(W, dO), torch.bmm(T, dO.transpose(1, 2)))
                for T, W, dO in zip(Ts, Wf, dOs)], iters))
    for d, back in ((fwd, False), (bwd, True)):
        bounds = [k7_bound_ms(T, W, back) for T, W in zip(Ts, Ws)]
        d["bound_ms"] = sum(b for b, _ in bounds)
        bys = {by for _, by in bounds}
        d["bound_by"] = bys.pop() if len(bys) == 1 else "mixed"
    log(f"  {label}, {len(cases)} groups in one launch each way: errors "
        f"{err:.2e} (tol {tol:g} of max(|ref|, 1)), bitwise repeatable; "
        + "; ".join(
            f"{name} kernel {d['ms']:.4f} ms, whole call {d['call_ms']:.4f}, "
            f"plain {d['plain_ms']:.4f}, bmm {d['library_ms']:.4f}, bound "
            f"{d['bound_ms']:.5f} ({d['bound_by']}, "
            f"{d['bound_ms'] / d['ms']:.0%} of it)"
            for name, d in (("forward", fwd), ("backward", bwd))))
    return {"max_abs_err": err, "fwd": fwd, "bwd": bwd}


def without_contract_dT(Ts, Ws):
    """The planted fault of phase 5d: K7 with its ``dT`` dropped (the CG
    intermediate cut off from the gradient), so nothing below a contraction
    learns through it: the embedding, and each layer's input."""
    return ec.edge_weighted_contract_grouped([T.detach() for T in Ts], Ws)


def contract_grouped_plain(Ts, Ws):
    """The plain twin of the grouped K7 call, group by group."""
    return [ec.edge_weighted_contract_plain(T, W) for T, W in zip(Ts, Ws)]


@contextlib.contextmanager
def plain_tfn_twins():
    """The TFN path through the plain twins of K7 and K4 on the card."""
    with patched(tensor_product, "edge_weighted_contract_grouped",
                 contract_grouped_plain), \
            patched(tfn_conv, "segment_sum", scatter.segment_sum_plain):
        yield


# ---------------------------------------------------------------------------
# The triplet models: DimeNet++ and SphereNet (the fold on K3, sums on K4)
# ---------------------------------------------------------------------------

TRIPLET_STEP_TOL = 2e-4     # the CPU tests': of each parameter's max(|ref|, 1)
# 6j (and 6g, 6l) are cut to half the JAX numbers' epochs, 6i to a third,
# to keep the script inside its time limit on the slower hosts; each bound
# is set from three repeats at the cut depth on the H100
# (experiments/seed_spread.py, PERF.md)
DIMENET_EPOCHS, DIMENET_MAE_MAX = 200, 0.116  # 0.10613 +- 0.00109; JAX, 600:
DIMENET_JAX_MAE, DIMENET_JAX_SD = 0.0831, 0.0007   # RESULTS.md
SPHERENET_EPOCHS, SPHERENET_MAE_MAX = 100, 0.115  # 0.09788 +- 0.00724
SPHERENET_JAX_MAE, SPHERENET_JAX_SD = 0.0798, 0.0049  # folds 5-7, 2 layers
DIMENET_BOX_ATOMS, DIMENET_CHECK_ATOMS = 10_000, 1_000
TRIPLET_MODELS = {"dimenet": (DimeNetPPModel, DIMENET_STAR),
                  "spherenet": (SphereNetModel, SPHERENET_STAR)}


def triplet_model(name: str, device, heads: bool = False):
    """The star configuration's model ``name`` at its default widths,
    weights from seed 0 (``run_experiment_reg``'s first repeat).  ``heads``:
    the Linears that start at 0 (DimeNet++'s output heads) drawn by
    GlorotOrthogonal from seed 1, so that every gradient is exercised."""
    cls, cfg = TRIPLET_MODELS[name]
    model = cls(num_layers=cfg["num_layers"], in_dim=1, out_dim=1,
                generator=seed_everything(0), device="cpu")
    if heads:
        gen = torch.Generator().manual_seed(1)
        for m in model.modules():
            if isinstance(m, torch.nn.Linear) and not m.weight.any():
                dimenet_mod.glorot_orthogonal_(m.weight, gen)
    return model.to(device)


def triplet_launches(name: str, forwards: int, train_steps: int) -> dict:
    """K3 and K4 launches of ``forwards`` forward passes of which
    ``train_steps`` had a backward: K3 once per layer (the fold), K4 per
    forward L + 2 (DimeNet++: L + 1 output blocks and the pool; SphereNet:
    init_v, L update_v and the pool) and one per backward (the embedding's
    gradient)."""
    layers = TRIPLET_MODELS[name][1]["num_layers"]
    return {"sorted_segment_sum": layers * forwards,
            "segment_sum": (layers + 2) * forwards + train_steps}


def check_triplet_fold(label: str, y, ids, mask, n: int,
                       iters: int = 50) -> dict:
    """K3 over the identity plan of the ascending ``ids`` (built on the
    card), the mask read in the kernel, against the plain sum: within
    SEG_TOL, finite, two runs bitwise equal, one launch each; with an
    accumulator bitwise equal to the previous formula ``acc + fold`` (K3
    over the masked-zeroed rows, then an add).  Times: the kernel, the whole
    call, the call with an accumulator, the previous formula (masking pass,
    kernel, add), the plain version, ``index_add_`` and
    ``torch.segment_reduce`` on the masked rows, K4 over the same ids (its
    route) and the CSR-sort route (a device sort, then the kernel)."""
    plan = sss.ascending_plan(ids, n)
    acc = torch.randn((n, y.shape[1]), device=y.device,
                      generator=torch.Generator(device=y.device).manual_seed(n))
    masked = torch.where(mask[:, None], y, torch.zeros_like(y))
    before = sss.sorted_segment_sum.launches
    with torch.no_grad():
        got = sss.sorted_fold(y, ids, plan, mask)
        again = sss.sorted_fold(y, ids, plan, mask)
        got_acc = sss.sorted_fold(y, ids, plan, mask, acc=acc)
        want = sss.sorted_segment_sum_plain(y, ids, n, mask)
        k4 = sss.segment_sum(y, ids, n, mask)
        with bench_kernels.forced_k4_route("csr"):
            csr = sss.segment_sum(y, ids, n, mask)
        previous = torch.empty_like(got)
        sss.launch_csr_segsum(masked, None, plan.rowptr, previous)
    torch.cuda.synchronize()
    if sss.sorted_segment_sum.launches - before != 3:
        raise AssertionError(f"{label}: the fold did not launch K3 once a call")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite values")
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if not torch.allclose(got, want, atol=SEG_TOL, rtol=SEG_TOL):
        raise AssertionError(f"{label}: differs from the plain sum by {err:.3e}")
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two runs differ bitwise")
    if not (torch.equal(got, previous) and torch.equal(got_acc, acc + previous)):
        raise AssertionError(f"{label}: the in-kernel mask or accumulator "
                             "differs bitwise from acc + the masked fold")
    for route, r in (("K4", k4), ("CSR-sort route", csr)):
        if not torch.allclose(r, want, atol=SEG_TOL, rtol=SEG_TOL):
            raise AssertionError(f"{label}: the {route} differs")
    t, d = y.shape
    live = int(mask.sum())
    out = torch.empty_like(got)
    buf = torch.zeros_like(got)
    lengths = plan.rowptr.diff()

    def previous_formula():
        z = torch.where(mask[:, None], y, torch.zeros_like(y))
        sss.launch_csr_segsum(z, None, plan.rowptr, out)
        return acc + out

    with torch.no_grad():
        k_ms = cuda_time_ms(lambda: sss.launch_csr_segsum(
            y, None, plan.rowptr, out, mask=mask), iters)
        call_ms = cuda_time_ms(lambda: sss.sorted_fold(y, ids, plan, mask),
                               iters)
        acc_ms = cuda_time_ms(lambda: sss.sorted_fold(y, ids, plan, mask,
                                                      acc=acc), iters)
        prev_ms = cuda_time_ms(previous_formula, iters)
        plain_ms = cuda_time_ms(
            lambda: sss.sorted_segment_sum_plain(y, ids, n, mask), iters)
        k4_ms = cuda_time_ms(lambda: sss.segment_sum(y, ids, n, mask), iters)
        with bench_kernels.forced_k4_route("csr"):
            csr_ms = cuda_time_ms(lambda: sss.segment_sum(y, ids, n, mask),
                                  iters)
        lib_ms = cuda_time_ms(lambda: buf.index_add_(0, ids, masked), iters)
        reduce_ms = cuda_time_ms(lambda: torch.segment_reduce(
            masked, "sum", lengths=lengths), iters)
        plan_ms = cuda_time_ms(lambda: sss.ascending_plan(ids, n), iters)
    b_ms, b_by = seg_bound_ms(live, d, n, t * (ids.element_size() + 1))
    route = sss.segsum_route(t, n)[0]
    log(f"  {label}: T={t} live={live} E={n} D={d} max_abs_err={err:.3e}, "
        f"bitwise repeatable, with acc bitwise equal to acc + the masked "
        f"fold; kernel {k_ms:.4f} ms, whole call {call_ms:.4f} ms, with acc "
        f"{acc_ms:.4f} ms (previous formula: masking pass, kernel, add "
        f"{prev_ms:.4f} ms), plan {plan_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"K4 ({route} route) {k4_ms:.4f} ms, CSR-sort route {csr_ms:.4f} ms, "
        f"index_add_ {lib_ms:.4f} ms, segment_reduce {reduce_ms:.4f} ms, "
        f"bound {b_ms:.5f} ms ({b_by})")
    return {"shape": label, "T": t, "live": live, "E": n, "D": d,
            "max_abs_err": err, "ms": k_ms, "call_ms": call_ms,
            "acc_call_ms": acc_ms, "previous_formula_ms": prev_ms,
            "plan_ms": plan_ms, "plain_ms": plain_ms, "k4_ms": k4_ms,
            "k4_route": route, "csr_sort_ms": csr_ms, "library_ms": lib_ms,
            "segment_reduce_ms": reduce_ms, "bound_ms": b_ms, "bound_by": b_by}


def segsum_block_route(kernel: str):
    """"scan" or "csr" for a profiler name of ``segsum_block<V, Id, kScan,
    kPerm, kMask>``, None for any other kernel."""
    m = re.match(r"segsum_block<[^,<>]+,[^,<>]+, (true|false),", kernel)
    return None if m is None else ("scan" if m.group(1) == "true" else "csr")


def star_call_kernels(fn, label: str, iters: int) -> dict:
    """The device kernels of ``fn``'s calls by the profiler
    (``bench_kernels.kernel_launches``), profiled again over 4x and 16x the
    calls while it sees no segment-sum kernel (it can drop every device
    event of a short run); raises if it never sees one."""
    for n in (iters, 4 * iters, 16 * iters):
        split = bench_kernels.kernel_launches(fn, n)
        if any(segsum_block_route(k) for k in split):
            return split
    raise AssertionError(f"{label}: the profiler saw no segment-sum kernel "
                         f"in {16 * iters} calls: {list(split)}")


def check_star_segsum(cap, iters: int = 10) -> list:
    """Phase 3f: every K4 and fold shape captured from the star models'
    train steps and predict batches (``bench_kernels.capture_star_shapes``),
    held to the plain version (SEG_TOL of max(|ref|, 1)), two runs bitwise
    equal, and on the device (profiler) at most one segment-sum kernel a
    call and nothing else (no sort), K4's of its scan route and the fold's
    of the CSR route (``star_call_kernels``); then the readings of
    ``bench_kernels.segsum_reading``."""
    out = []
    for key, (shape, (data, ids, n, mask)) in cap.shapes.items():
        calls = {phase: c for (phase, k), c in cap.calls.items() if k == key}
        label = (f"{shape['kind']} E {shape['E']} N {n} D {shape['D']}"
                 f"{' masked' if mask is not None else ''}")
        with torch.no_grad():
            if shape["kind"] == "k4":
                def call():
                    return sss.segment_sum(data, ids, n, mask)
            else:
                plan = sss.ascending_plan(ids, n)

                def call():
                    return sss.sorted_fold(data, ids, plan, mask)
            got, again = call(), call()
            want = sss.sorted_segment_sum_plain(data, ids, n, mask)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item() if got.numel() else 0.0
        scale = max(1.0, want.abs().max().item()) if want.numel() else 1.0
        if not torch.isfinite(got).all() or err > SEG_TOL * scale:
            raise AssertionError(f"{label}: differs from the plain version by "
                                 f"{err:.3e}")
        if not torch.equal(got, again):
            raise AssertionError(f"{label}: two runs differ bitwise")
        r = bench_kernels.segsum_reading(shape["kind"], (data, ids, n, mask),
                                         iters, split_all=False)
        call_r = r["call"]
        with torch.no_grad():
            split = star_call_kernels(call, label, iters)
        on_card = {k: segsum_block_route(k) for k in split}
        want_route = "scan" if shape["kind"] == "k4" else "csr"
        per_call = sum(v["launches"] for v in split.values())
        if set(on_card.values()) != {want_route} or per_call > 1.0 + 1e-9:
            raise AssertionError(f"{label}: {per_call:.2f} device kernels a "
                                 f"call, want one {want_route}-route "
                                 f"segment-sum kernel and nothing else: "
                                 f"{list(split)}")
        parent, parent_name = ((r["csr_route"], "CSR-sort route")
                               if shape["kind"] == "k4"
                               else (r["k4"], "K4 over the same ids"))
        log(f"  {label} (longest {shape['longest']}, live {shape['live']}; "
            f"{calls}): max_abs_err={err:.3e} of {scale:.3g}, bitwise "
            f"repeatable; kernel {call_r['segsum_ms']:.4f} ms (profiler, "
            f"{per_call:.2f} {want_route}-route kernels a call, nothing "
            f"else), "
            f"whole call {call_r['call_ms']:.4f} ms, host "
            f"{call_r['host_us']:.1f} us; {parent_name} "
            f"{parent['call_ms']:.4f} ms (host {parent['host_us']:.1f} us); "
            f"index_add_ "
            f"{r['index_add_ms']:.4f} ms, segment_reduce "
            f"{r['segment_reduce_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
        for v in (r["call"], parent, r.get("with_acc", {})):
            v.pop("split", None)
        out.append(dict(shape, shape_label=label, calls=calls,
                        **dict(r, max_abs_err=err,
                               device_kernels_a_call=per_call)))
    return out


def tail_masked_case(dev, e: int = 500, d: int = 64, seed: int = 51):
    """Ascending ids over ``e`` edges with edges that own no triplet (edge
    7 among them), 5% of the rows masked and 37 masked pad rows on the last
    edge."""
    rng = np.random.default_rng(seed)
    per_edge = rng.integers(0, 7, e)
    per_edge[7] = 0
    ids = np.concatenate([np.repeat(np.arange(e), per_edge),
                          np.full(37, e - 1)])
    mask = rng.random(len(ids)) >= 0.05
    mask[-37:] = False
    y = rng.standard_normal((len(ids), d)).astype(np.float32)
    return (torch.from_numpy(y).to(dev),
            torch.from_numpy(ids.astype(np.int32)).to(dev),
            torch.from_numpy(mask).to(dev))


def serve_triplet(name: str, graphs, dev, card: str) -> dict:
    """``Predictor`` over ``graphs`` at the model's full default widths
    (heads drawn), counters set to 0 just before and read just after;
    finite (n, 1), within ATOL/RTOL of the same weights on the CPU plain
    path; the median of 5 calls."""
    cls, cfg = TRIPLET_MODELS[name]
    cpu_model = triplet_model(name, "cpu", heads=True)
    model = copy.deepcopy(cpu_model).to(dev)
    kw = dict(batch_size=BATCH, needs_triplets=True,
              with_quads=cfg["with_quads"])
    pred = Predictor(model, **kw)
    reset_counts()
    y = pred.predict(graphs)
    got = counts()
    batches = -(-len(graphs) // BATCH)
    want = dict({k: 0 for k in got}, **triplet_launches(name, batches, 0))
    log(f"[serve] {name} {cfg} predict({len(graphs)} star graphs): launches "
        f"{got} (want K3 {want['sorted_segment_sum']}, K4 "
        f"{want['segment_sum']}, nothing else)")
    if y.shape != (len(graphs), 1) or not np.isfinite(y).all():
        raise AssertionError(f"{name} predict gave shape {y.shape}, "
                             f"finite={np.isfinite(y).all()}")
    if got != want:
        raise AssertionError(f"{name} predict launched {got}")
    y_cpu = Predictor(cpu_model, device="cpu", **kw).predict(graphs)
    err = float(np.abs(y - y_cpu).max())
    log(f"  vs the CPU plain path: max_abs_err={err:.3e} (atol {ATOL}, rtol "
        f"{RTOL}; outputs up to {np.abs(y_cpu).max():.3f})")
    if not np.allclose(y, y_cpu, atol=ATOL, rtol=RTOL):
        raise AssertionError(f"{name} predict differs from the CPU by {err}")
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred.predict(graphs)
        times.append(time.perf_counter() - t)
    ms = statistics.median(times) * 1e3
    log(f"[serve] {name} predict: median {ms:.2f} ms per call of 5 "
        f"({len(graphs) / ms * 1e3:.0f} graphs/s) [{card}]")
    return {"launches": got, "max_abs_err": err, "predict_ms": ms}


def shifted_fold_plan(ids, n):
    """The planted fault of phase 5e: the fold's plan with its row pointers
    shifted by one row."""
    plan = sss.ascending_plan(ids, n)
    return plan._replace(rowptr=torch.clamp_max(plan.rowptr + 1, ids.shape[0]))


def fold_without_backward(data, ids, plan, mask=None, acc=None):
    """The planted fault of phase 5f: the fold cut off from the gradient."""
    return sss.sorted_fold(data.detach(), ids, plan, mask, acc=acc)


def triplet_grads(model, batch, device, dtype) -> dict:
    """Each parameter's gradient (zero where it got none) after one L1-sum
    loss backward of a copy of ``model`` on ``batch``, float64 on the CPU."""
    work = copy.deepcopy(model).to(device=device, dtype=dtype)
    b = batch.to(device)
    b.pos, b.y = b.pos.to(dtype), b.y.to(dtype)
    train.l1_sum_loss(work(b), b).backward()
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)
                ).double().cpu() for n, p in work.named_parameters()}


def scaled_error(got: dict, want: dict) -> tuple:
    """Largest gradient error relative to max(|ref|, 1) per parameter (the
    CPU tests' scaling), and the parameter."""
    err, worst = 0.0, ""
    for name, g in got.items():
        e = ((g - want[name]).abs().max().item()
             / max(want[name].abs().max().item(), 1.0))
        if e > err:
            err, worst = e, name
    return err, worst


def step_triplet(name: str, batch, card: str) -> dict:
    """One step's gradients of ``name`` (heads drawn) on the card against
    the CPU's plain f32 step at the same weights, within TRIPLET_STEP_TOL
    of max(|ref|, 1); the CPU float64 step printed beside; a planted fault
    (5e: the fold's plan shifted by one row; 5f: the fold's backward
    dropped) must fail that check."""
    model = triplet_model(name, "cpu", heads=True)
    layers = TRIPLET_MODELS[name][1]["num_layers"]
    reset_counts()
    grads = {"card": triplet_grads(model, batch, "cuda", torch.float32)}
    launched = counts()
    if launched["sorted_segment_sum"] != layers:
        raise AssertionError(f"{name} step launched {launched}")
    fault = ((dimenet_mod, "ascending_plan", shifted_fold_plan)
             if name == "dimenet"
             else (dimenet_mod, "sorted_fold", fold_without_backward))
    with patched(*fault):
        grads["card, planted fault"] = triplet_grads(model, batch, "cuda",
                                                     torch.float32)
    grads["cpu f32"] = triplet_grads(model, batch, "cpu", torch.float32)
    exact = triplet_grads(model, batch, "cpu", torch.float64)
    reading = {run: scaled_error(g, grads["cpu f32"])
               for run, g in grads.items() if run != "cpu f32"}
    vs64 = {run: scaled_error(g, exact) for run, g in grads.items()}
    log(f"[train] {name} one step on a train batch ({batch.num_edges} edges, "
        f"{batch.triplets.num_triplets} triplets): launches {launched}; "
        f"gradients against the CPU f32 step (tol {TRIPLET_STEP_TOL:g} of "
        "max(|ref|, 1)): " + ", ".join(f"{r} {e:.3e} at {w}"
                                        for r, (e, w) in reading.items())
        + "; against float64: " + ", ".join(f"{r} {e:.3e}"
                                            for r, (e, _) in vs64.items()))
    if reading["card"][0] > TRIPLET_STEP_TOL:
        raise AssertionError(f"{name}: the step on the card does not match "
                             "the CPU")
    if reading["card, planted fault"][0] <= TRIPLET_STEP_TOL:
        raise AssertionError(f"{name}: the step check passed the planted fault")
    return {"launches": launched,
            **{f"grad_err {r}": e for r, (e, _) in reading.items()},
            **{f"vs_f64 {r}": e for r, (e, _) in vs64.items()}}


def train_triplet(name: str, loaders, epochs: int, mae_max: float,
                  jax_mae: float, jax_sd: float, card: str):
    """``fit_regression`` of the star configuration (``run_experiment_reg``'s
    first repeat: weights and shuffle from seed 0; the configuration's lr
    and schedule) on the card, counters set to 0 just before and read just
    after; test MAE finite and below ``mae_max``."""
    cfg = TRIPLET_MODELS[name][1]
    steps, val_b, test_b = (len(ld) for ld in loaders)
    model = triplet_model(name, "cuda")
    reset_counts()
    res = fit_regression(model, None, *loaders, n_epochs=epochs,
                         lr=cfg["lr"], cosine=cfg["cosine"], seed=0,
                         device="cuda")
    got = counts()
    fired = fired_epochs(res.perf_per_epoch)
    forwards = epochs * (steps + val_b) + fired * test_b
    want = dict({k: 0 for k in got},
                **triplet_launches(name, forwards, epochs * steps))
    log(f"[train] {name} fit_regression {epochs} epochs "
        f"{TRIPLET_MODELS[name][1]}: train_time {res.train_time:.3f} s, test "
        f"MAE {res.test:.5f} (the JAX package {jax_mae} +- {jax_sd}), best "
        f"val MAE {res.best_val:.5f}; launches {got} (want K3 "
        f"{want['sorted_segment_sum']}, K4 {want['segment_sum']}; {fired} "
        f"test passes) [{card}]")
    if got != want:
        raise AssertionError(f"{name} training launched {got}, expected {want}")
    if not (np.isfinite(res.test) and res.test < mae_max):
        raise AssertionError(f"{name} test MAE {res.test} is not finite and "
                             f"below {mae_max}")
    return res, got


# ---------------------------------------------------------------------------
# MACE (K7 and K4 in its convolutions, the symmetric contraction in PyTorch
# products) and the expressivity path (classification on K4)
# ---------------------------------------------------------------------------

MACE_NARROW = dict(emb_dim=16)      # a step held to float64 (2 layers)
MACE_STAR_EPOCHS, MACE_MAE_MAX = 100, 0.09    # 0.08160 +- 0.00040
MACE_JAX_MAE, MACE_JAX_SD = 0.0766, 0.0013    # RESULTS.md:189
MACE_SERVE_CALLS = 5


# ---------------------------------------------------------------------------
# The box-scale rows of DimeNet++, SphereNet and the fused EGNN (6k, 6o-6q)
# ---------------------------------------------------------------------------

SPHERENET_CHECK_ATOMS, SPHERENET_BOX_ATOMS = 500, 10_000
KERNEL_COUNTERS = {"k1": "egnn_message", "k2": "egnn_message_bwd",
                   "k3": "sorted_segment_sum", "k4": "segment_sum"}
_chunk_slices = dimenet_mod.chunk_slices


def gate_sum_without_tail(self, x, rbf, receivers, num_nodes, edge_mask):
    """The planted fault of phase 6k: the output blocks' chunk sum stops
    before the last, shorter chunk (``E // chunk`` chunks, not
    ``ceil(E / chunk)``)."""
    c, acc = self.edge_chunk, None
    for k in range(x.shape[0] // c):
        s = slice(k * c, (k + 1) * c)
        part = scatter.segment_sum(self.gate(x[s], rbf[s]), receivers[s],
                                   num_nodes, mask=edge_mask[s])
        acc = part if acc is None else acc + part
    return acc


def slices_without_tail(n, chunk):
    """The planted fault of phase 6p: the triplet fold's chunks stop before
    the last, shorter one."""
    return _chunk_slices(n, chunk)[:-1]


def kernel_want(per_step: dict, steps: int) -> dict:
    """Every counter of ``counts()``: ``steps`` times ``per_step``'s K1-K4
    (keys k1..k4), 0 for the rest."""
    want = {name: 0 for name in counts()}
    for key, n in per_step.items():
        want[KERNEL_COUNTERS[key]] = steps * n
    return want


def box_run(label: str, model, batch, per_step: dict, steps: int,
            card: str, warm: int = 1) -> dict:
    """``warm`` bench_scale steps of ``model`` on ``batch`` (on the card),
    then ``steps`` more with the counters set to 0 just before and read just
    after: exactly ``per_step`` launches a step and nothing else, every
    loss finite; ms a step (median), peak device memory over those steps."""
    step_fn = bench_scale.make_step(model, batch)
    for _ in range(warm):
        step_fn().item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, losses = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(step_fn().item())       # host read: synchronous
        times.append(time.perf_counter() - t)
    got, want = counts(), kernel_want(per_step, steps)
    run = {"launches": got, "step_ms": statistics.median(times) * 1e3,
           "step_times_ms": [x * 1e3 for x in times],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "edges": int(batch.edge_mask.sum())}
    log(f"[box] {label}: {steps} steps after {warm} warm, median "
        f"{run['step_ms']:.2f} ms per step, peak {run['peak_mem_gb']:.3f} "
        f"GB; losses {losses}; launches {got} (want per step {per_step}) "
        f"[{card}]")
    if got != want:
        raise AssertionError(f"{label} launched {got}, expected {want}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: a loss is not finite")
    return run


def check_box_step(label: str, make_model, batch, faults: dict,
                   exact: dict, per_step: dict) -> dict:
    """One step's gradients of ``make_model()`` (a CPU model) on ``batch``
    on the card against ``exact`` (the CPU float64 run of the same
    function): within GRAD_TOL of each parameter's largest entry, with
    exactly ``per_step`` launches; each planted fault of ``faults``
    (``{name: (owner, attribute, replacement)}``) must fail that check."""
    model = make_model()
    reset_counts()
    grads = {"card": triplet_grads(model, batch, "cuda", torch.float32)}
    launched, want = counts(), kernel_want(per_step, 1)
    for name, fault in faults.items():
        with patched(*fault):
            grads[f"card, planted fault: {name}"] = triplet_grads(
                model, batch, "cuda", torch.float32)
    errs = {run: grad_error(g, exact) for run, g in grads.items()}
    log(f"[box] {label}: launches {launched} (want {per_step}); gradients "
        f"against the CPU float64 run (tol {GRAD_TOL:g} of each parameter's "
        "largest entry): " + ", ".join(f"{r} {e:.3e}"
                                        for r, e in errs.items()))
    if launched != want:
        raise AssertionError(f"{label} launched {launched}, expected {want}")
    if errs["card"] > GRAD_TOL:
        raise AssertionError(f"{label}: the step on the card does not match "
                             "the CPU")
    for run, e in errs.items():
        if run != "card" and e <= GRAD_TOL:
            raise AssertionError(f"{label}: the check passed the {run}")
    return {"launches": launched, **errs}


def check_fold_chunk(label: str, y, ids, mask, n: int, acc) -> dict:
    """One chunk of the triplet fold at a box row's shapes: ``check_segsum``
    of K3 over the ascending ``ids``' plan, then ``sorted_fold`` with the
    accumulator ``acc`` (read in the kernel) against ``acc`` plus the
    plain sum, within SEG_TOL, finite and bitwise repeatable."""
    plan = sss.ascending_plan(ids, n)
    reading = check_segsum(label, y, ids, mask, n, plan, timed=False)
    with torch.no_grad():
        got = sss.sorted_fold(y, ids, plan, mask, acc=acc)
        again = sss.sorted_fold(y, ids, plan, mask, acc=acc)
        want = acc + sss.sorted_segment_sum_plain(y, ids, n, mask)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    log(f"  {label}, into the accumulator [{n}, {y.shape[1]}]: "
        f"max_abs_err={err:.3e}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: the fold into acc is not finite")
    if not torch.allclose(got, want, atol=SEG_TOL, rtol=SEG_TOL):
        raise AssertionError(f"{label}: the fold into acc differs from acc + "
                             f"the plain sum by {err:.3e}")
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two folds into acc differ bitwise")
    return dict(reading, acc_max_abs_err=err)


def dimenet_100k_kernels(tri100, cfg: dict) -> list:
    """Phase 6o's kernel checks: K3 on the first and the last triplet
    chunk's fold into the ``[E, int_emb]`` accumulator, K4 on the first and
    the last output chunk's sum into the nodes, at ``cfg``'s chunks on
    ``tri100`` (on the card), random rows; each against its plain
    version."""
    tri, e, n = tri100.triplets, tri100.num_edges, tri100.num_nodes
    gen = torch.Generator(device=tri100.pos.device).manual_seed(15)
    dev = tri100.pos.device
    acc = torch.randn((e, 64), generator=gen, device=dev)
    readings = []
    t_slices = _chunk_slices(tri.num_triplets, cfg["triplet_chunk"])
    for where, s in (("first", t_slices[0]), ("last", t_slices[-1])):
        ids = tri.idx_ji[s]
        y = torch.randn((ids.shape[0], 64), generator=gen, device=dev)
        readings.append(check_fold_chunk(
            f"K3 100k box, {where} of {len(t_slices)} triplet chunks",
            y, ids, tri.t_mask[s], e, acc))
    e_slices = _chunk_slices(e, cfg["edge_chunk"])
    for where, s in (("first", e_slices[0]), ("last", e_slices[-1])):
        seg = tri100.receivers[s]
        route = sss.segsum_route(seg.shape[0], n)[0]
        data = torch.randn((seg.shape[0], 128), generator=gen, device=dev)
        readings.append(check_segsum(
            f"K4 100k box, {where} of {len(e_slices)} output chunks "
            f"({route} route)", data, seg, tri100.edge_mask[s], n,
            timed=False))
    return readings


def third(n: int) -> int:
    """A chunk of about a third of ``n`` rows that does not divide them."""
    c = n // 3 + 1
    while n % c == 0:
        c += 1
    return c


def dimenet_chunk_checks(small, small_model, exact: dict) -> dict:
    """Phase 6k's schedules on the small box, each from ``small_model``'s
    weights: the 100k rule with chunks of about a third of the edges and
    triplets (a planted fault: the output blocks' chunk sum without the
    shorter tail chunk), then with ``remat_full_blocks``, then with
    ``chunk_output_blocks=False``."""
    rule = dict(bench_scale.config("dimenet", BOX_ATOMS),
                edge_chunk=third(small.num_edges),
                triplet_chunk=third(small.triplets.num_triplets))
    schedules = {"100k rule": rule,
                 "remat_full_blocks": dict(rule, remat_full_blocks=True),
                 "chunk_output_blocks=False": dict(rule,
                                                   chunk_output_blocks=False)}
    out = {}
    for label, cfg in schedules.items():
        def make_model(cfg=cfg):
            m = DimeNetPPModel(**cfg, in_dim=8, out_dim=1, device="cpu")
            m.load_state_dict(small_model.state_dict())
            return m
        faults = ({"the output chunk sum without its tail": (
            dimenet_mod.OutputPPBlock, "gate_sum", gate_sum_without_tail)}
            if label == "100k rule" else {})
        out[label] = dict(check_box_step(
            f"dimenet {cfg} on the {DIMENET_CHECK_ATOMS}-atom box", make_model,
            small, faults, exact,
            bench_scale.dimenet_launches_per_step(cfg, small)), cfg=cfg)
    return out


def dimenet_box_100k(plain100, dev, card: str) -> dict:
    """Phase 6o: DimeNet++ at ``bench_scale.config('dimenet', 100_000)`` on
    the unsorted 100k-atom box with its triplets (built on the host, timed
    apart): K3 and K4 at its chunks' shapes against their plain versions
    (``dimenet_100k_kernels``), then one warm step and two timed with exact
    launch counts."""
    t = time.perf_counter()
    tri100 = attach_triplets(plain100)
    tri_s = time.perf_counter() - t
    tri100 = tri100.to(dev)
    cfg = bench_scale.config("dimenet", BOX_ATOMS)
    kernels = dimenet_100k_kernels(tri100, cfg)
    torch.cuda.empty_cache()
    per_step = bench_scale.dimenet_launches_per_step(cfg, tri100)
    model = bench_scale.build("dimenet", cfg, torch.Generator().manual_seed(0),
                              dev)
    triplets = int(tri100.triplets.t_mask.sum())
    run = box_run(f"dimenet {cfg} on the {BOX_ATOMS}-atom box "
                  f"({triplets} triplets; built on the host in {tri_s:.2f} s)",
                  model, tri100, per_step, 2, card)
    run.update(cfg=cfg, per_step=per_step, triplets=triplets,
               triplet_build_s=tri_s, kernel_checks=kernels,
               triplets_per_s=triplets / run["step_ms"] * 1e3)
    log(f"[box] dimenet at {BOX_ATOMS} atoms: {run['triplets_per_s']:.4g} "
        f"triplets/s [{card}]")
    return run


def spherenet_box_phases(dev, card: str) -> dict:
    """Phase 6p: one SphereNet step (``bench_scale.config('spherenet')``,
    triplet and quad chunks of about a third) on a small box on the card
    against the CPU float64 run, a planted fault (the triplet fold without
    its last chunk) rejected; then ``bench_scale.config('spherenet',
    10_000)`` on the 10k-atom box with its quads (built on the host, timed
    apart), one warm step and two timed with exact launch counts."""
    small = bench_scale.box_batch(SPHERENET_CHECK_ATOMS, sort=False,
                                  quads=True)
    cfg = dict(bench_scale.config("spherenet", SPHERENET_BOX_ATOMS),
               triplet_chunk=third(small.triplets.num_triplets),
               quad_chunk=third(small.triplets.q_trip.shape[0]))

    def make_model():
        return SphereNetModel(**cfg, in_dim=8, out_dim=1,
                              generator=torch.Generator().manual_seed(0),
                              device="cpu")

    exact = triplet_grads(make_model(), small, "cpu", torch.float64)
    check = check_box_step(
        f"spherenet {cfg} on the {SPHERENET_CHECK_ATOMS}-atom box "
        f"({int(small.triplets.t_mask.sum())} triplets, "
        f"{int(small.triplets.q_mask.sum())} quads)", make_model, small,
        {"the triplet fold without its last chunk": (
            dimenet_mod, "chunk_slices", slices_without_tail)}, exact,
        bench_scale.spherenet_launches_per_step(cfg, small))
    plain = bench_scale.box_batch(SPHERENET_BOX_ATOMS, sort=False)
    t = time.perf_counter()
    quad_box = attach_triplets(plain, with_quads=True)
    quad_s = time.perf_counter() - t
    quad_box = quad_box.to(dev)
    cfg = bench_scale.config("spherenet", SPHERENET_BOX_ATOMS)
    per_step = bench_scale.spherenet_launches_per_step(cfg, quad_box)
    model = bench_scale.build("spherenet", cfg,
                              torch.Generator().manual_seed(0), dev)
    quads = int(quad_box.triplets.q_mask.sum())
    run = box_run(f"spherenet {cfg} on the {SPHERENET_BOX_ATOMS}-atom box "
                  f"({int(quad_box.triplets.t_mask.sum())} triplets, {quads} "
                  f"quads; built on the host in {quad_s:.2f} s)", model,
                  quad_box, per_step, 2, card)
    run.update(cfg=cfg, per_step=per_step, quads=quads, quad_build_s=quad_s)
    return {"check": check, "box_10k": run}


def fused_box_phases(plain100, dev, card: str) -> dict:
    """Phase 6q: one ``egnn_fused`` step (4 x 128) on the unsorted
    2000-atom box on the card against the CPU float64 run, a planted fault
    (K1's packed weights cut off from the gradient) rejected; then the
    unsorted 100k-atom box, K1 and K2 at 1.35M edges, one warm step and
    BOX_STEPS timed with exact launch counts."""
    cfg = bench_scale.config("egnn_fused", BOX_ATOMS)
    small = bench_scale.box_batch(BOX_CHECK_ATOMS, sort=False)

    def make_model():
        return bench_scale.build("egnn_fused", cfg,
                                 torch.Generator().manual_seed(0), "cpu")

    exact = triplet_grads(make_model(), small, "cpu", torch.float64)
    check = check_box_step(
        f"egnn_fused {cfg} on the unsorted {BOX_CHECK_ATOMS}-atom box",
        make_model, small,
        {"K1's weights cut off": (egnn_fused, "egnn_message",
                                  without_weight_grad)}, exact,
        bench_scale.fused_launches_per_step(cfg["num_layers"]))
    box100 = plain100.to(dev)
    model = bench_scale.build("egnn_fused", cfg,
                              torch.Generator().manual_seed(0), dev)
    kernels = fused_100k_kernels(model, box100)
    torch.cuda.empty_cache()
    per_step = bench_scale.fused_launches_per_step(cfg["num_layers"])
    run = box_run(f"egnn_fused {cfg} on the unsorted {BOX_ATOMS}-atom box",
                  model, box100, per_step, BOX_STEPS, card)
    run.update(cfg=cfg, per_step=per_step, kernel_checks=kernels,
               edges_per_s=run["edges"] / run["step_ms"] * 1e3)
    return {"check": check, "box_100k": run}


def fused_100k_kernels(model, box100) -> dict:
    """K1 and K2 on the inputs that layer 0 of ``model`` gets in one
    bench_scale step on ``box100`` (its h, positions and packed weights;
    the cotangents of its message and position sums in that step's
    backward), against their plain versions: K1 by ``check_kernel_case``,
    K2 by ``check_bwd_case(large=True)`` (phase 3's N 10k rule)."""
    seen = {}

    def layer0(send, recv, emask, h, pos, packed_w):
        out = egnn_message(send, recv, emask, h, pos, packed_w)
        if not seen:
            seen["args"] = tuple(t.detach().clone()
                                 for t in (send, recv, emask, h, pos, packed_w))
            for key, t in (("gmsg", out[0]), ("gpos", out[1])):
                t.register_hook(lambda g, key=key: seen.__setitem__(
                    key, g.detach().clone()))
        return out

    with patched(egnn_fused, "egnn_message", layer0):
        bench_scale.make_step(model, box100)().item()
    args = seen["args"]
    e = args[0].shape[0]
    label = f"egnn_fused 100k box layer 0 (E {e})"
    fwd = check_kernel_case(label, args)
    bwd = check_bwd_case(label, args + (seen["gmsg"], seen["gpos"]),
                         large=True)
    return {"E": e, "live": int(args[2].sum()), "k1_max_abs_err": fwd,
            "k2_max_abs_err": bwd}


def mace_model(device, **kw):
    """MACE at its star configuration (``kw`` overrides), weights from
    seed 0 (``run_experiment_reg``'s first repeat)."""
    return _mace_model(seed_everything(0), device, **kw)


def mace_launches(layers: int, forwards: int, train_steps: int) -> dict:
    """MACE's launches (pool "first"): per forward K7 and K4 (the message
    sum onto the senders) once a layer; per train step K7's backward once a
    layer and K4 once more (the embedding's gradient)."""
    return {"edge_contract": layers * forwards,
            "edge_contract_bwd": layers * train_steps,
            "segment_sum": layers * forwards + train_steps}


_SC_WEIGHTS = symmetric_contraction.SymmetricContraction.weights


def weights_nu3_detached(self):
    """The planted fault of phase 5g: the symmetric contraction's nu = 3
    weights cut off from the gradient (no ``contraction_*_w3`` learns)."""
    w = _SC_WEIGHTS(self)
    w[3] = w[3].detach()
    return w


def expressivity_arm(name: str, kw: dict, graphs, seed: int, epochs: int,
                     dev) -> dict:
    """One arm of the expressivity table: ``fit_classification`` of the
    port's ``name`` model (weights from ``seed_everything(seed)``) on the
    two graphs (train = validation = test, one batch of 2, lr 1e-3, the
    JAX tests' settings) on ``dev``, counters set to 0 just before and read
    just after.  One train step an epoch; each step launches K4 at least
    once (the embedding's gradient)."""
    loader = GraphLoader(graphs, batch_size=2, y_dtype=np.int32)
    model = model_registry[name](**kw, generator=seed_everything(seed),
                                 device=dev)
    reset_counts()
    t = time.perf_counter()
    res = fit_classification(model, None, loader, loader, loader,
                             n_epochs=epochs, lr=1e-3, seed=seed, device=dev)
    got = counts()
    if dev.type == "cuda" and got["segment_sum"] < epochs:
        raise AssertionError(f"{name}: {got['segment_sum']} K4 launches in "
                             f"{epochs} train steps")
    return {"test": res.test, "best_val": res.best_val,
            "seconds": time.perf_counter() - t,
            "launches": {k: v for k, v in got.items() if v}}


# the JAX package's behavioral tests (tests/test_training.py:42-103,
# tests/test_incompleteness.py:38-75): arm -> (model, config, data, seeds,
# epochs, outcome); outcome "solves": 100% at some seed (and a mean above
# 50% over several), "fails": never above 50%, None: printed only
KCHAIN_KW = dict(num_layers=3, emb_dim=32, in_dim=1, out_dim=2)
ROTSYM_SPH = dict(num_layers=1, emb_dim=8, max_ell=3, mlp_dim=32, in_dim=1,
                  out_dim=2, equivariant_pred=True, pool="first")
EXPRESSIVITY = {
    "kchains k=4 egnn": ("egnn", KCHAIN_KW, ("kchains", 4), range(5), 400,
                         "solves"),
    "kchains k=4 mpnn": ("mpnn", KCHAIN_KW, ("kchains", 4), range(3), 400,
                         "fails"),
    "rotsym fold 3 egnn": ("egnn", dict(num_layers=1, emb_dim=32, in_dim=1,
                                        out_dim=2, equivariant_pred=True,
                                        pool="sum"),
                           ("rotsym", 3), [0], 150, "fails"),
    "rotsym fold 3 tfn": ("tfn", dict(ROTSYM_SPH, gate=False), ("rotsym", 3),
                          [0], 150, "solves"),
    "rotsym fold 3 mace": ("mace", dict(ROTSYM_SPH, correlation=2),
                           ("rotsym", 3), [0], 150, None),
    "two_body schnet": ("schnet", dict(num_layers=1, hidden_channels=32,
                                       in_dim=1, out_dim=2),
                        ("two_body",), [0], 200, "fails"),
    "two_body egnn": ("egnn", dict(num_layers=1, emb_dim=32, in_dim=1,
                                   out_dim=2, equivariant_pred=True,
                                   pool="sum"),
                      ("two_body",), [0], 200, "solves"),
    "three_body mace correlation 1": (
        "mace", dict(num_layers=1, emb_dim=8, max_ell=2, correlation=1,
                     mlp_dim=32, in_dim=1, out_dim=2, pool="sum"),
        ("three_body",), [0], 200, "fails"),
    "three_body mace correlation 3": (
        "mace", dict(num_layers=1, emb_dim=8, max_ell=3, correlation=3,
                     mlp_dim=32, in_dim=1, out_dim=2, pool="sum"),
        ("three_body",), [0], 200, "solves"),
}


def expressivity_graphs(spec):
    kind, *args = spec
    if kind == "kchains":
        return datasets.create_kchains(*args)
    if kind == "rotsym":
        return datasets.create_rotsym_envs(fold=args[0])
    return getattr(datasets, f"create_{kind}_envs")()


def expressivity_table(dev, card: str) -> dict:
    """Phase 6m: every arm of ``EXPRESSIVITY`` on ``dev``; raises where an
    outcome differs from the JAX tests'."""
    table = {}
    for arm, (name, kw, spec, seeds, epochs, outcome) in EXPRESSIVITY.items():
        graphs = expressivity_graphs(spec)
        runs = [expressivity_arm(name, kw, graphs, seed, epochs, dev)
                for seed in seeds]
        accs = [r["test"] for r in runs]
        table[arm] = {"model": name, "seeds": list(seeds), "epochs": epochs,
                      "test_acc": accs, "expected": outcome,
                      "seconds": sum(r["seconds"] for r in runs),
                      "launches_first_seed": runs[0]["launches"]}
        log(f"[expressivity] {arm}: test accuracy {accs} over seeds "
            f"{list(seeds)}, {epochs} epochs (expected: {outcome or 'printed'}); "
            f"{table[arm]['seconds']:.1f} s; launches (seed {seeds[0]}) "
            f"{runs[0]['launches']} [{card}]")
        if outcome == "solves" and (max(accs) != 100.0 or (
                len(accs) > 1 and not np.mean(accs) > 50.0)):
            raise AssertionError(f"{arm}: {accs}, expected 100% at some seed")
        if outcome == "fails" and max(accs) > 50.0:
            raise AssertionError(f"{arm}: {accs}, expected at most 50%")
    return table


# ---------------------------------------------------------------------------
# MACE's force-field family (MACE-FF, TFN-FF): the 'uvu' product, the weight
# MLP, the self-connection and the symmetric contraction are PyTorch
# products; every sum is K4
# ---------------------------------------------------------------------------

FF_BOX_ATOMS = 10_000        # the main path's box (6n) and 3f's box shapes
FF_CHECK_ATOMS = 1_000       # 5h's box, held to float64 on the CPU
# 5h: edge chunks of 5000 (above COMBINED_MAX_EDGES: the bcast form; not a
# divisor of E), MACE-FF's symmetric contraction in node blocks of 300
FF_CHECK = {"mace_ff": dict(edge_chunk=5000, node_chunk=300),
            "tfn_ff": dict(edge_chunk=5000)}
FF_SERVE_CALLS = 5


def ff_model(name: str, cfg: dict, box, device):
    """``bench_scale``'s force field ``name`` at ``cfg``, weights from seed
    0, ``avg_num_neighbors`` the mean degree of ``box``."""
    return bench_scale.build(name, cfg, torch.Generator().manual_seed(0),
                             device, avg_deg=bench_scale.mean_degree(box))


def capture_ff_shapes(box, dev):
    """Phase 3f's force-field shapes: one bench_scale step of each force
    field at ``bench_scale.config(name, FF_BOX_ATOMS)`` on ``box`` with
    every K4 call recorded, the first of each (model, D, E, N, padded tail)
    kept with its inputs: each layer's chunk sum at a full chunk and at the
    padded tail chunk, the pools and TFN-FF's embedding gradient.  Returns
    the scan-route shapes as a ``bench_kernels.SegsumCapture`` (for
    ``check_star_segsum``), the others (few long segments: the CSR route)
    as {label: inputs}, and each model's K4 widths by layer."""
    cap, csr, widths = bench_kernels.SegsumCapture(), {}, {}
    real = sss.segment_sum
    for name in bench_scale.FORCE_FIELDS:
        cfg = bench_scale.config(name, FF_BOX_ATOMS)
        model = ff_model(name, cfg, box, dev)
        widths[name] = [blk.tp.irreps_out.dim for blk in model.interactions]
        kept = {}

        def k4(data, ids, n, mask=None, _name=name, _kept=kept):
            tail = mask is not None and not bool(mask.all())
            key = (data.shape[1], data.shape[0], n, tail)
            if key not in _kept:
                shape = bench_kernels.segsum_shape("k4", data, ids, n, mask)
                inputs = (data.detach().clone(), ids.clone(), n,
                          None if mask is None else mask.clone())
                label = (f"{_name} E {data.shape[0]} N {n} D {data.shape[1]}"
                         f"{' tail' if tail else ''}")
                _kept[key] = (shape, inputs, label)
            shape, inputs, label = _kept[key]
            if sss.segsum_route(data.shape[0], n)[0] == "scan":
                skey = tuple(shape.values())
                cap.shapes[skey] = (shape, inputs)
                cap.calls[(f"{_name} box step", skey)] += 1
            else:
                csr[label] = inputs
            return real(data, ids, n, mask)

        k4.launches = real.launches
        with patched(sss, "segment_sum", k4):
            bench_scale.make_step(model, box)()
        torch.cuda.synchronize()
        del model
    return cap, csr, widths


_FF_CHUNK = mace_blocks._InteractionBase._chunk


def chunk_node_feats_detached(self, node_feats, *args):
    """The planted fault of phase 5h: every edge chunk gathers
    ``node_feats`` detached, so no gradient crosses a chunk back to the
    layer's ``linear_up``, the embedding or the layers below."""
    return _FF_CHUNK(self, node_feats.detach(), *args)


def segment_sum_without_mask(data, ids, n, mask=None):
    """Phase 5h's witness: the convolutions' sums without their masks.  The
    padded tail of the last chunk has zero spherical harmonics and radial
    features, so its messages are exact zeros; the batch's own pad edges
    join the pad node to itself, outside every graph's sum.  So the step's
    gradients move by rounding at most: no fault."""
    return scatter.segment_sum(data, ids, n)


def no_plans(batch):
    return None


def check_ff_segsum(dev, card: str):
    """Phase 3f's force-field part: K4 at every shape a ``mace_ff`` and a
    ``tfn_ff`` bench_scale step launch on the unsorted 10k box
    (``capture_ff_shapes``).  Each layer's chunk sum at a full chunk and at
    the padded tail chunk (the scan route) through ``check_star_segsum``;
    the pools and TFN-FF's embedding gradient (few long segments: the CSR
    route) through ``check_segsum`` against float64.  Returns the box (on
    ``dev``) and the readings."""
    t = time.perf_counter()
    ff_box = bench_scale.box_batch(FF_BOX_ATOMS, sort=False).to(dev)
    ff_cap, ff_csr, ff_widths = capture_ff_shapes(ff_box, dev)
    log(f"[kernels] segment sums at the force fields' shapes on the "
        f"{FF_BOX_ATOMS}-atom box ({int(ff_box.edge_mask.sum())} edges, bucket "
        f"E {ff_box.num_edges}, configs "
        f"{ {n: bench_scale.config(n, FF_BOX_ATOMS) for n in bench_scale.FORCE_FIELDS} }): "
        f"K4 chunk widths by layer (tp.irreps_out.dim) {ff_widths}; "
        f"{len(ff_cap.shapes)} scan-route and {len(ff_csr)} CSR-route shapes "
        f"captured in {time.perf_counter() - t:.2f} s; vs plain (SEG_TOL "
        f"{SEG_TOL} of max(|ref|, 1); the CSR-route shapes against float64) "
        f"[{card}]")
    ff_segsum = check_star_segsum(ff_cap)
    ff_segsum += [check_segsum(label, data, ids, mask, n, long_rows=True)
                  for label, (data, ids, n, mask) in ff_csr.items()]
    del ff_cap, ff_csr
    torch.cuda.empty_cache()
    return ff_box, ff_segsum


def serve_mace_ff(graphs, dev, card: str) -> dict:
    """Phase 4h: ``Predictor(MACEForceField(in_dim=1))`` at full width (2
    layers, emb 64, max_ell 3, correlation 3, pool "sum") over ``graphs``
    (MACE's star graphs: E 1400 a batch, the combined 'uvu' form), counters
    set to 0 just before and read just after: K4 twice a layer and batch
    (the message sum and the readout's pool), nothing else; finite, within
    atol = rtol = 1e-4 of the CPU plain path; median of ``FF_SERVE_CALLS``
    calls."""
    mace_n = len(graphs)
    mace_batches = -(-mace_n // BATCH)
    mff_cpu = MACEForceField(in_dim=1, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    mff_cuda = MACEForceField(in_dim=1,
                              generator=torch.Generator().manual_seed(0),
                              device=dev)
    for key, value in mff_cuda.state_dict().items():
        if not torch.equal(value.cpu(), mff_cpu.state_dict()[key]):
            raise AssertionError(f"CPU and CUDA MACE-FF models differ at {key}")
    mff_pred = Predictor(mff_cuda, batch_size=BATCH)
    reset_counts()
    y_mff = mff_pred.predict(graphs)
    mff_serve = counts()
    mff_layers = len(mff_cuda.interactions)
    mff_serve_want = dict({k: 0 for k in mff_serve},
                          segment_sum=2 * mff_layers * mace_batches)
    log(f"[serve] MACE-FF (in_dim 1, full width) predict({mace_n} star graphs, "
        f"fold [7]): launches {mff_serve} (want {mff_serve_want}: per batch K4 "
        f"twice a layer, the message sum and the readout's pool)")
    if y_mff.shape != (mace_n, 1) or not np.isfinite(y_mff).all():
        raise AssertionError(f"MACE-FF predict gave shape {y_mff.shape}, "
                             f"finite={np.isfinite(y_mff).all()}")
    if mff_serve != mff_serve_want:
        raise AssertionError(f"MACE-FF predict launched {mff_serve}")
    t = time.perf_counter()
    y_mff_cpu = Predictor(mff_cpu, batch_size=BATCH,
                          device="cpu").predict(graphs)
    mff_cpu_s = time.perf_counter() - t
    mff_serve_err = float(np.abs(y_mff - y_mff_cpu).max())
    log(f"  vs the CPU plain path ({mff_cpu_s:.1f} s on the host): "
        f"max_abs_err={mff_serve_err:.3e} of {np.abs(y_mff_cpu).max():.3g} "
        "(atol = rtol = 1e-4)")
    if not np.allclose(y_mff, y_mff_cpu, atol=1e-4, rtol=1e-4):
        raise AssertionError(f"MACE-FF predict differs from the CPU run by "
                             f"{mff_serve_err}")
    times = []
    for _ in range(FF_SERVE_CALLS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        mff_pred.predict(graphs)
        times.append(time.perf_counter() - t)
    mff_ms = statistics.median(times) * 1e3
    log(f"[serve] MACE-FF predict: median {mff_ms:.2f} ms per call of "
        f"{FF_SERVE_CALLS} ({mace_n / mff_ms * 1e3:.0f} graphs/s) [{card}]")
    del mff_pred, mff_cuda, mff_cpu
    torch.cuda.empty_cache()
    return {"launches": mff_serve, "ms": mff_ms, "err": mff_serve_err,
            "cpu_s": mff_cpu_s}


def step_ff_vs_cpu(card: str) -> dict:
    """Phase 5h: one bench_scale step (L1-sum loss, Adam 1e-4) of each force
    field at full width on a ``FF_CHECK_ATOMS``-atom box (``FF_CHECK``: edge
    chunks of 5000, the bcast form and a padded tail; MACE-FF in node
    blocks of 300 with the post-conv linear folded into the chunks,
    ``FOLD_ACC_ELEMS`` 0 on its interaction blocks) on the card against the
    CPU in float64: every gradient within ``GRAD_TOL`` of that parameter's
    largest entry.  The planted fault (``chunk_node_feats_detached``) must
    fail that check; the card with the sums' masks dropped
    (``segment_sum_without_mask``) is printed beside it."""
    ff_small = bench_scale.box_batch(FF_CHECK_ATOMS, sort=False)
    f32, f64 = torch.float32, torch.float64
    ff_check = {}
    for name, over in FF_CHECK.items():
        cfg = dict(bench_scale.config(name, FF_CHECK_ATOMS), **over)
        cpu_model = ff_model(name, cfg, ff_small, "cpu")
        if name == "mace_ff":
            for blk in cpu_model.interactions:
                blk.FOLD_ACC_ELEMS = 0          # the fold, forced
        grads = {"card": box_grads(cpu_model, ff_small, no_plans, "cuda", f32)}
        with patched(mace_blocks._InteractionBase, "_chunk",
                     chunk_node_feats_detached):
            grads["card, planted fault"] = box_grads(cpu_model, ff_small,
                                                     no_plans, "cuda", f32)
        with patched(mace_blocks, "segment_sum", segment_sum_without_mask):
            grads["card, chunk masks dropped"] = box_grads(
                cpu_model, ff_small, no_plans, "cuda", f32)
        t = time.perf_counter()
        exact = box_grads(cpu_model, ff_small, no_plans, "cpu", f64)
        cpu_s = time.perf_counter() - t
        errs = {run: grad_error(g, exact) for run, g in grads.items()}
        same = all(torch.equal(g, grads["card"][n]) for n, g in
                   grads["card, chunk masks dropped"].items())
        ff_check[name] = dict(errs, masks_dropped_bitwise_equal=same,
                              cpu_f64_s=cpu_s, cfg=cfg,
                              chunks=bench_scale.edge_chunks(cfg, ff_small),
                              edges=int(ff_small.edge_mask.sum()))
        log(f"[box] {name} {cfg} one step on a {FF_CHECK_ATOMS}-atom box "
            f"({ff_check[name]['edges']} edges, bucket E {ff_small.num_edges}, "
            f"{ff_check[name]['chunks']} chunks"
            f"{', the linear folded' if name == 'mace_ff' else ''}), gradients "
            f"against the CPU float64 run ({cpu_s:.1f} s on the host; tol "
            f"{GRAD_TOL:g} of each parameter's largest entry): " + ", ".join(
                f"{run} {e:.3e}" for run, e in errs.items())
            + f"; with the chunk masks dropped bitwise equal to the card's: "
              f"{same}")
        if errs["card"] > GRAD_TOL:
            raise AssertionError(f"{name}: the box step on the card does not "
                                 "match the CPU")
        if errs["card, planted fault"] <= GRAD_TOL:
            raise AssertionError(f"{name}: phase 5h's check passed the "
                                 "planted fault")
    return ff_check


def train_ff_box(ff_box, dev, card: str) -> dict:
    """Phase 6n, the main path: ``mace_ff`` and ``tfn_ff`` at
    ``bench_scale.config(name, FF_BOX_ATOMS)`` on ``ff_box``: a warm step
    and its twin from the same state (bitwise-equal gradients), then
    ``BOX_STEPS`` timed steps with the counters set to 0 just before and
    read just after: K4 exactly ``bench_scale.ff_k4_launches_per_step`` a
    step and nothing else; every loss finite."""
    ff_runs = {}
    for name in bench_scale.FORCE_FIELDS:
        cfg = bench_scale.config(name, FF_BOX_ATOMS)
        model = ff_model(name, cfg, ff_box, dev)
        twin = copy.deepcopy(model)
        first = []
        for m in (model, twin):          # the warm step, and its twin
            bench_scale.make_step(m, ff_box)()
            first.append({n: p.grad.clone() for n, p in m.named_parameters()
                          if p.grad is not None})
        differ = [n for n, g in first[0].items()
                  if not torch.equal(g, first[1][n])]
        n_params = len(first[0])
        del twin, first
        step_fn = bench_scale.make_step(model, ff_box)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        times, losses = [], []
        for _ in range(BOX_STEPS):
            t = time.perf_counter()
            losses.append(step_fn().item())
            times.append(time.perf_counter() - t)
        got = counts()
        chunks = bench_scale.edge_chunks(cfg, ff_box)
        per_step = bench_scale.ff_k4_launches_per_step(name, cfg["num_layers"],
                                                       chunks)
        want = dict({k: 0 for k in got}, segment_sum=BOX_STEPS * per_step)
        edges = int(ff_box.edge_mask.sum())
        step_ms = statistics.median(times) * 1e3
        ff_runs[name] = {"cfg": cfg, "launches": got, "chunks": chunks,
                         "step_ms": step_ms,
                         "step_times_ms": [x * 1e3 for x in times],
                         "edges_per_s": edges / step_ms * 1e3,
                         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                         "losses": losses, "edges": edges,
                         "grads_bitwise_equal": not differ}
        log(f"[box] {name} {cfg} on the {FF_BOX_ATOMS}-atom box ({edges} edges, "
            f"{chunks} chunks of {cfg['edge_chunk']}): two steps from one state "
            f"give bitwise-equal gradients at {n_params - len(differ)} of "
            f"{n_params} parameters; {BOX_STEPS} steps after a warm one, median "
            f"{step_ms:.2f} ms per step ({ff_runs[name]['edges_per_s']:.0f} "
            f"edges/s), peak {ff_runs[name]['peak_mem_gb']:.3f} GB; losses "
            f"{losses}; launches {got} (want K4 {per_step} per step: "
            f"bench_scale.ff_k4_launches_per_step) [{card}]")
        if differ:
            raise AssertionError(f"{name}: two box steps differ at {differ}")
        if got != want:
            raise AssertionError(f"{name} box steps launched {got}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"{name} box: a loss is not finite")
        del model, step_fn
        torch.cuda.empty_cache()
    return ff_runs



# ---------------------------------------------------------------------------
# The regression CLI and its training options: loss mask, gradient
# clipping, LR warmup, checkpoint/resume, the NaN watchdog, the ledger
# ---------------------------------------------------------------------------

PAIRED = ["--n_pairs", "2", "--fold", "7", "--n_data", "1500", "--lr", "5e-4"]
CLI_RUNS = {   # 7a: the warmup resolves to 50 epochs for egnn on paired_star*
    "paired_star2 loss_mask": ["--model", "egnn", "--dataset", "paired_star2",
                               "--loss_mask", "--n_layers", "4", "--pool",
                               "first", "--n_epochs", "30", "--n_times", "2"]
    + PAIRED,
    "paired_star grad_clip": ["--model", "egnn", "--dataset", "paired_star",
                              "--grad_clip", "1.0", "--n_layers", "4",
                              "--pool", "first", "--n_epochs", "10"] + PAIRED,
}
# 7d: the protocol of the JAX package's MACE paired_star number
# (scripts/validate_accuracy.py:17-25, RESULTS.md:193), cut from 200 epochs
MACE_PAIRED_EPOCHS = 100
CLI_MACE = seed_spread.MACE_PAIRED + ["--n_epochs", str(MACE_PAIRED_EPOCHS),
                                      "--n_times", "1"]
# about 0.008 above the largest of three 100-epoch repeats on the H100
# (seed_spread.py --model mace_paired: 0.02965, 0.03386, 0.03559; PERF.md)
MACE_PAIRED_MAE_MAX = 0.044
MACE_PAIRED_JAX = "0.0275 +- 0.0013 (all-exact 0.0284 +- 0.0020)"
RESUME_EPOCHS, NAN_EPOCH, MAX_RECOVERIES = 6, 4, 3
CLIP_EPOCHS = 5         # the clip's cost: half the grad_clip run's length
CLIP_TOL = 1e-5         # of each tensor's largest entry: the norm's sum order


class FitLog:
    """``train.fit_regression`` with every result kept (patched in while a
    CLI run is driven: the CLI returns only the metrics)."""

    def __init__(self):
        self.results = []
        self._fit = train.fit_regression

    def __call__(self, *args, **kw):
        res = self._fit(*args, **kw)
        self.results.append(res)
        return res


def run_cli(argv, results_file: str):
    """``cli.main(argv)`` on the card, counters set to 0 just before and
    read just after: (mean test MAE, the runs' FitResults, launches,
    seconds)."""
    fits = FitLog()
    reset_counts()
    t = time.perf_counter()
    with patched(train, "fit_regression", fits):
        mean = cli.main(argv + ["--results_file", results_file])
    seconds = time.perf_counter() - t
    return mean, fits.results, counts(), seconds


def fit_differences(got, want) -> list:
    """Where two FitResults differ bitwise: per-epoch rows, step losses,
    best-val rule, each tensor of the final state dict."""
    diff = [k for k in ("perf_per_epoch", "train_losses")
            if not np.array_equal(getattr(got, k), getattr(want, k),
                                  equal_nan=True)]
    if (got.best_val, got.test) != (want.best_val, want.test):
        diff.append("best_val/test")
    diff += [k for k, v in want.variables.items()
             if not torch.equal(got.variables[k], v)]
    return diff


def losses_finite(res) -> bool:
    """The check 7c's planted fault must fail: every step's loss finite."""
    return bool(np.isfinite(res.train_losses).all())


def poison_(model) -> None:
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float("nan"))


def step_gradients(model, slot, row, **kw):
    """Each parameter's gradient after one ``train_step`` of a copy of
    ``model`` (``kw``: the loss mask ``mask_cols``, the clip
    ``grad_clip``)."""
    work = copy.deepcopy(model)
    train_step(work, make_tx(work.parameters(), LR), slot, row, **kw)
    return {n: p.grad.clone() for n, p in work.named_parameters()
            if p.grad is not None}


def clip_per_tensor_(params, max_norm: float) -> None:
    """The clip as a loop over the gradients (two reductions and a
    ``torch.where`` each): ``clip_grad_global_norm_``'s previous formula,
    the reference its multi-tensor version is held to and timed against."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def cli_phases(dev, card: str, tmp: str) -> dict:
    """Phases 7a-7d; raises where a check fails."""
    out = {}
    # 7a. the CLI end to end: two ledger records with the JAX CLI's keys
    # (the port's parser is held to the JAX one's by tests/test_torch_cli.py)
    ledger_file = f"{tmp}/exp_history.json"
    runs = out["7a"] = {}
    for label, argv in CLI_RUNS.items():
        mean, fits, got, seconds = run_cli(argv, ledger_file)
        epoch_loss = [r.train_losses.mean(axis=1) for r in fits]
        runs[label] = {
            "mean_test_mae": mean, "seconds": seconds,
            "test_maes": [r.test for r in fits],
            "epoch_loss_first_last": [[float(e[0]), float(e[-1])]
                                      for e in epoch_loss],
            "launches": {k: v for k, v in got.items() if v}}
        log(f"[cli] {label}: {' '.join(argv)}: test MAE {mean:.5f} "
            f"(repeats {[round(r.test, 5) for r in fits]}), mean train loss "
            f"first / last epoch {runs[label]['epoch_loss_first_last']}; "
            f"{seconds:.1f} s; launches {runs[label]['launches']} [{card}]")
        if not all(np.isfinite(r.test) and np.isfinite(r.train_losses).all()
                   for r in fits):
            raise AssertionError(f"{label}: a loss or test MAE is not finite")
        if not all(e[-1] < e[0] for e in epoch_loss):
            raise AssertionError(f"{label}: the train loss did not fall")
        if got["segment_sum"] == 0:
            raise AssertionError(f"{label}: K4 was not launched")
    with open(ledger_file) as f:
        records = json.load(f)
    keys = set(vars(cli.build_parser().parse_args(CLI_MACE))) | {
        "best_val_acc", "test_acc", "train_time", "mean", "std"}
    if len(records) != 2 or any(set(r) != keys for r in records):
        raise AssertionError(f"the ledger holds {len(records)} records with "
                             f"keys {[sorted(r) for r in records]}")
    if [r["lr_warmup"] for r in records] != [50, 50] or not all(
            np.isfinite(r["mean"]) for r in records):
        raise AssertionError(f"ledger records: {records}")
    # the loss mask: targets 2-3 (the second centre's angles) replaced by
    # noise leave one step's gradients bitwise as they were; the planted
    # fault, the same step unmasked, must change them
    args = cli.build_parser().parse_args(CLI_RUNS["paired_star2 loss_mask"])
    data, model_args = cli.make_dataset(args)
    batch = data[:100]
    noise = np.random.default_rng(0).uniform(-9, 9, (len(batch), 2))
    noisy = [Graph(g.atoms, g.edge_index, g.pos,
                   np.concatenate([g.y[:2], noise[i]]).astype(np.float32))
             for i, g in enumerate(batch)]
    row = torch.arange(len(batch), device=dev)
    model = cli.make_model_func(args)(**model_args,
                                      generator=seed_everything(0), device=dev)
    grads = {name: step_gradients(model, build_slot_data(graphs, device=dev),
                                  row, mask_cols=cols)
             for name, graphs, cols in (("masked", batch, 2),
                                        ("masked, noisy tail", noisy, 2),
                                        ("planted: unmasked, noisy tail",
                                         noisy, None))}
    differ = {name: [k for k, g in grads["masked"].items()
                     if not torch.equal(g, gr[k])]
              for name, gr in grads.items() if name != "masked"}
    log(f"[cli] loss mask: one train step of the 7a model on 100 two-centre "
        f"stars, tensors whose gradient differs from the masked step's: "
        + ", ".join(f"{n} {len(d)} of {len(grads['masked'])}"
                    for n, d in differ.items()))
    if differ["masked, noisy tail"]:
        raise AssertionError("the masked targets reach the gradients")
    if not differ["planted: unmasked, noisy tail"]:
        raise AssertionError("the mask check passed the planted fault")
    out["7a_mask_check"] = {n: len(d) for n, d in differ.items()}
    del model, grads

    # the clip: one step's clipped gradients against the per-tensor
    # formula, then its cost, the grad_clip run's configuration trained
    # without the clip, with it and with the per-tensor formula, twice
    args = cli.build_parser().parse_args(CLI_RUNS["paired_star grad_clip"])
    data, model_args = cli.make_dataset(args)
    loaders = cli.make_loaders(args, data)
    cli.resolve_lr_warmup(args)
    model = cli.make_model_func(args)(**model_args,
                                      generator=seed_everything(0), device=dev)
    slot = build_slot_data(data[:100], device=dev)
    raw = step_gradients(model, slot, row)
    raw_norm = torch.sqrt(sum(g.square().sum() for g in raw.values())).item()
    got = step_gradients(model, slot, row, grad_clip=args.grad_clip)
    with patched(train, "clip_grad_global_norm_", clip_per_tensor_):
        want = step_gradients(model, slot, row, grad_clip=args.grad_clip)
    clip_err = max(((got[k] - w).abs().max() / max(w.abs().max(), 1e-30)).item()
                   for k, w in want.items())
    cost = {}
    for _ in range(2):
        for label, clip, fn in (("none", None, train.clip_grad_global_norm_),
                                ("multi-tensor", args.grad_clip,
                                 train.clip_grad_global_norm_),
                                ("per-tensor", args.grad_clip,
                                 clip_per_tensor_)):
            work = copy.deepcopy(model)
            with patched(train, "clip_grad_global_norm_", fn):
                res = fit_regression(work, None, *loaders,
                                     n_epochs=CLIP_EPOCHS, lr=LR, seed=0,
                                     device=dev, grad_clip=clip,
                                     lr_warmup=args.lr_warmup)
            cost.setdefault(label, []).append(res.train_time / CLIP_EPOCHS)
    out["7a_clip"] = {"unclipped_norm": raw_norm, "max_rel_err": clip_err,
                      "s_per_epoch": cost}
    log(f"[cli] grad_clip {args.grad_clip}: one step on 100 paired stars, "
        f"global norm {raw_norm:.4g} before the clip; multi-tensor clip vs "
        f"the per-tensor formula: max err {clip_err:.3e} of each tensor's "
        f"largest entry (tol {CLIP_TOL}); train_time per epoch over "
        f"{CLIP_EPOCHS} epochs, two runs each: "
        + ", ".join(f"{k} {[round(v, 4) for v in vs]} s"
                    for k, vs in cost.items()) + f" [{card}]")
    if not raw_norm > args.grad_clip:
        raise AssertionError("the clip check's step does not clip")
    if clip_err > CLIP_TOL:
        raise AssertionError(f"the clip differs from the per-tensor formula "
                             f"by {clip_err:.3e}")
    del model, raw, got, want

    # 7b. kill and resume: EGNN (pool first) and GVP-GNN (dropout on)
    t = time.perf_counter()
    resume = {}
    for name, model, first, every in (
            ("egnn", cli.make_model_func(args)(
                **model_args, generator=seed_everything(0), device=dev), 4, 2),
            ("gvp", GVPGNNModel(**model_args, pool="first",
                                generator=seed_everything(0), device=dev),
             3, 3)):
        def fit(n_epochs, **kw):
            return fit_regression(model, None, *loaders, n_epochs=n_epochs,
                                  lr=LR, seed=0, device=dev, **kw)

        full = fit(RESUME_EPOCHS)
        again = fit(RESUME_EPOCHS)
        ckdir = f"{tmp}/{name}"
        fit(first, checkpoint_dir=ckdir, checkpoint_every=every)
        shutil.copytree(ckdir, f"{ckdir}-copy")
        resumed = fit(RESUME_EPOCHS, checkpoint_dir=ckdir,
                      checkpoint_every=every)
        with patched(train, "restore_shuffle", lambda gen, state: None):
            reseeded = fit(RESUME_EPOCHS, checkpoint_dir=f"{ckdir}-copy",
                           checkpoint_every=every)
        resume[name] = {"repeat": fit_differences(again, full),
                        "resumed": fit_differences(resumed, full),
                        "planted: shuffle reseeded": fit_differences(reseeded,
                                                                     full)}
        if name == "egnn":
            clean = full
        log(f"[resume] {name} {first}+{RESUME_EPOCHS - first} epochs on "
            f"{len(data)} paired stars, bitwise against the uninterrupted "
            f"run, differing: " + "; ".join(
                f"{k} {len(v)} {v[:3]}" for k, v in resume[name].items())
            + f" [{card}]")
        if resume[name]["repeat"]:
            raise AssertionError(f"{name}: two runs without checkpoints differ")
        if resume[name]["resumed"]:
            raise AssertionError(f"{name}: the resumed run differs")
        if not resume[name]["planted: shuffle reseeded"]:
            raise AssertionError(f"{name}: the resume check passed the "
                                 "planted fault")
        del model
    out["7b"] = {name: {k: len(v) for k, v in r.items()}
                 for name, r in resume.items()}      # tensors differing
    out["7b"]["seconds"] = time.perf_counter() - t

    # 7c. NaN recovery: every parameter NaN at the start of epoch 4
    t = time.perf_counter()
    egnn = cli.make_model_func(args)(**model_args,
                                     generator=seed_everything(0), device=dev)
    fired = []

    def once(epoch, work):
        if epoch == NAN_EPOCH and not fired:
            fired.append(epoch)
            poison_(work)

    def always(epoch, work):
        if epoch >= 2:
            fired.append(epoch)
            poison_(work)

    kw = dict(n_epochs=RESUME_EPOCHS, lr=LR, seed=0, device=dev,
              checkpoint_every=2)
    recovered = fit_regression(egnn, None, *loaders, **kw,
                               checkpoint_dir=f"{tmp}/nan-once",
                               nan_recovery=True, inject_fault=once)
    recovered_diff = fit_differences(recovered, clean)
    fired.clear()
    try:
        fit_regression(egnn, None, *loaders, **kw,
                       checkpoint_dir=f"{tmp}/nan-always", nan_recovery=True,
                       max_recoveries=MAX_RECOVERIES, inject_fault=always)
        raised = None
    except FloatingPointError as exc:
        raised = str(exc)
    poisoned_epochs = list(fired)
    fired.clear()
    unguarded = fit_regression(egnn, None, *loaders, **kw,
                               checkpoint_dir=f"{tmp}/nan-unguarded",
                               inject_fault=once)
    out["7c"] = {"recovered_differs": recovered_diff, "raised": raised,
                 "poisoned_epochs": poisoned_epochs,
                 "planted_losses_finite": losses_finite(unguarded),
                 "seconds": time.perf_counter() - t}
    log(f"[nan] poisoned at epoch {NAN_EPOCH}, rolled back: differs from the "
        f"clean run in {recovered_diff}; poisoned from epoch 2 on: "
        f"{raised!r} (epochs poisoned {poisoned_epochs}); planted fault "
        f"(nan_recovery off): losses finite {losses_finite(unguarded)}; "
        f"{out['7c']['seconds']:.1f} s [{card}]")
    if recovered_diff or not losses_finite(recovered):
        raise AssertionError("the recovered run differs from the clean run")
    if raised is None or f"recoveries={MAX_RECOVERIES}" not in raised:
        raise AssertionError("a fault at every epoch did not raise after "
                             f"{MAX_RECOVERIES} recoveries")
    if losses_finite(unguarded):
        raise AssertionError("the finite-loss check passed the planted fault")
    del egnn

    # 7d. the accuracy anchor: MACE on paired_star through the CLI
    mean, fits, got, seconds = run_cli(CLI_MACE, f"{tmp}/mace.json")
    out["7d"] = {"test_mae": mean, "seconds": seconds,
                 "train_time": fits[0].train_time,
                 "best_val": fits[0].best_val,
                 "launches": {k: v for k, v in got.items() if v}}
    log(f"[cli] MACE anchor: {' '.join(CLI_MACE)}: test MAE {mean:.5f} "
        f"(bound {MACE_PAIRED_MAE_MAX}; the JAX package {MACE_PAIRED_JAX}), "
        f"best val {fits[0].best_val:.5f}; train_time "
        f"{fits[0].train_time:.1f} s, {seconds:.1f} s in all; launches K7 "
        f"{got['edge_contract']} forward / {got['edge_contract_bwd']} "
        f"backward, K4 {got['segment_sum']} ({out['7d']['launches']}) [{card}]")
    if not (np.isfinite(mean) and mean <= MACE_PAIRED_MAE_MAX):
        raise AssertionError(f"MACE paired_star test MAE {mean} is not finite "
                             f"and at most {MACE_PAIRED_MAE_MAX}")
    if not (got["edge_contract"] and got["edge_contract_bwd"]
            and got["segment_sum"]):
        raise AssertionError(f"the MACE run did not launch K7 and K4: {got}")
    return out


TEACH_TOL = 1e-4        # of max(the CPU tensor's largest entry, 1)
TEACH_BATCH = 32
TEACH_SHAPE = (392, 4224)      # the notebook's bucket: N, E
TEACH_K4_PER_STEP = {"MPNN": 6, "CoordMPNN": 6, "InvariantMPNN": 6,
                     "FinalMPNN": 14, "MLP(norm='batch')": 0}
TEACH_K4_PER_FORWARD_FINAL = 14   # 4 layers x (sum + mean's two) + the pool's 2
# set before the first card run (PERF.md §2): the JAX notebook's
# train_model for FinalMPNN on the CPU, repeats 0-9 (tests/
# test_torch_teaching.py run as a script): 1.7067 +- 0.5873, largest
# 2.9223; 1.5 spreads above the mean is 2.588, and a seed's margin over it
# takes every JAX repeat in (repeats 0-2 alone: 1.6937 +- 0.3597)
TEACH_MAE_MAX = 3.0


class _BatchMLP(torch.nn.Module):
    """``MLP(norm='batch')`` (momentum 0.9) at the notebook's width on a
    batch's edge rows (the end points' one-hot types and the length), each
    graph's mean over its real edges by a one-hot product: no segment sum,
    so its K4 count is 0."""

    def __init__(self, generator):
        super().__init__()
        self.mlp = MLP(11, (64, 64, 1), norm="batch", norm_final=False,
                       act_final=False, generator=generator)

    def forward(self, b):
        feats = torch.nn.functional.one_hot(b.atoms.long(), 5).to(b.pos.dtype)
        d = (b.pos[b.receivers] - b.pos[b.senders]).norm(dim=-1, keepdim=True)
        out = self.mlp(torch.cat([feats[b.receivers], feats[b.senders], d], -1))
        g = torch.nn.functional.one_hot(b.graph_id[b.senders].long(),
                                        b.num_graphs).to(out.dtype)
        g = g * b.edge_mask[:, None].to(out.dtype)
        return (g.T @ out) / torch.clamp_min(g.sum(0), 1.0)[:, None]


def teach_model(name: str):
    """The 8a model ``name`` on the CPU, weights from seed 0."""
    if name == "MLP(norm='batch')":
        return _BatchMLP(seed_everything(0))
    return gnn101.build(name, seed=0, device="cpu")


def teach_step(model, b, mean: float, std: float, count: bool = False):
    """One train-mode forward and backward of the notebook's loss, then an
    eval-mode forward: {tensor name: value} (the output, each gradient,
    each updated running statistic, the eval output) and, with ``count``,
    the launches of the train step alone (counters set to 0 just before,
    read just after the backward)."""
    model.train()
    model.zero_grad(set_to_none=True)
    if count:
        reset_counts()
    out = model(b)
    gnn101.notebook_loss(out, b, mean, std).backward()
    launched = counts() if count else None
    got = {"train out": out.detach()}
    got.update({f"grad {n}": p.grad.detach().clone()
                for n, p in model.named_parameters() if p.grad is not None})
    got.update({f"stat {n}": t.detach().clone()
                for n, t in model.named_buffers() if "running" in n})
    with torch.no_grad():
        got["eval out"] = model.eval()(b)
    return got, launched


def teach_compare(label: str, got: dict, want: dict, want64: dict) -> tuple:
    """Each tensor of the card (``got``) within ``TEACH_TOL`` of max(the
    CPU f32 tensor's largest entry, 1); one beyond it passes only if it
    lies no farther from the CPU float64 run than twice the CPU f32 one
    plus that tolerance.  Returns (largest scaled error, names passed by
    the float64 rule)."""
    worst, by64 = 0.0, []
    if set(got) != set(want):
        raise AssertionError(f"{label}: tensors differ: {set(got) ^ set(want)}")
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1.0)
        g = got[k].detach().cpu().double()
        err = float((g - w.double()).abs().max()) / scale
        worst = max(worst, err)
        if err > TEACH_TOL:
            e64 = float((g - want64[k]).abs().max()) / scale
            c64 = float((w.double() - want64[k]).abs().max()) / scale
            if e64 > 2 * c64 + TEACH_TOL:
                raise AssertionError(
                    f"{label}: {k} is {err:.3e} from the CPU (tol "
                    f"{TEACH_TOL}) and {e64:.3e} from float64 (CPU f32 "
                    f"{c64:.3e})")
            by64.append(f"{k}: {err:.3e} from the CPU, {e64:.3e} from "
                        f"float64 (CPU f32 {c64:.3e})")
    return worst, by64


def teaching_phases(dev, card: str, tmp: str) -> dict:
    """Phases 8a-8c; raises where a check fails."""
    out = {}
    mark("8a")
    # 8a. the notebook's four models and MLP(norm='batch') on one batch
    splits = gnn101.notebook_splits()
    mean, std = splits.mean, splits.std
    batch = next(iter(GraphLoader(splits.train, batch_size=TEACH_BATCH,
                                  shuffle=True, seed=0)))
    if (batch.num_nodes, batch.num_edges) != TEACH_SHAPE:
        raise AssertionError(f"the notebook's batch is N {batch.num_nodes}, "
                             f"E {batch.num_edges}, not {TEACH_SHAPE}")
    b64 = dataclasses.replace(batch, pos=batch.pos.double(),
                              y=batch.y.double())
    bd = batch.to(dev)
    steps = out["8a"] = {}
    for name, want_k4 in TEACH_K4_PER_STEP.items():
        cpu = teach_model(name)
        card_model = copy.deepcopy(cpu).to(dev)
        f64 = copy.deepcopy(cpu).double()
        want, _ = teach_step(cpu, batch, mean, std)
        want64, _ = teach_step(f64, b64, mean, std)
        got, launched = teach_step(card_model, bd, mean, std, count=True)
        err, by64 = teach_compare(name, got, want, want64)
        want_counts = dict({k: 0 for k in launched}, segment_sum=want_k4)
        steps[name] = {"max_err": err, "float64_rule": by64,
                       "tensors": len(want), "launches": launched}
        log(f"[teach] {name} (4 x 64, N {batch.num_nodes}, E "
            f"{batch.num_edges}): train output, {len(want) - 2} gradients "
            f"and running statistics, eval output vs the CPU: max "
            f"{err:.3e} of max(|ref|, 1) (tol {TEACH_TOL}); by the float64 "
            f"rule: {by64 or 'none'}; K4 a train step "
            f"{launched['segment_sum']} (want {want_k4}) [{card}]")
        if launched != want_counts:
            raise AssertionError(f"{name}: a train step launched {launched}, "
                                 f"expected {want_counts}")
    # the utilities on FinalMPNN's train step (with Adam)
    final = gnn101.build("FinalMPNN", seed=0, device=dev)
    opt = make_tx(final.parameters(), lr=5e-3)

    def step():
        final.train()
        loss = gnn101.notebook_loss(final(bd), bd, mean, std)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss.detach()

    step_s = utils.time_fn(step, warmup=3, iters=20)
    with utils.profile_trace(f"{tmp}/trace") as logdir:
        step()
    with open(f"{logdir}/trace.json") as f:
        k4_in_trace = f.read().count("segsum_block")
    cost = utils.profiler.cost_report(step)
    roof = roofline.roofline(step, step_time_s=step_s).row()
    out["8a utils"] = {"step_ms": step_s * 1e3, "k4_trace_events": k4_in_trace,
                       "cost_report": cost, "roofline": roof}
    log(f"[teach] FinalMPNN train step: time_fn {step_s * 1e3:.3f} ms; "
        f"profile_trace: {k4_in_trace} segsum_block events; cost_report "
        f"{cost}; roofline {roof} [{card}]")
    if not k4_in_trace:
        raise AssertionError("profile_trace's trace names no K4 kernel")
    if not cost["flops"] > 0:
        raise AssertionError(f"cost_report counted no FLOPs: {cost}")

    mark("8b")
    # 8b. the notebook's train_model, FinalMPNN asserted, the others printed
    n_steps = -(-len(splits.train) // TEACH_BATCH)
    n_val, n_test = (-(-len(x) // TEACH_BATCH) for x in (splits.val,
                                                          splits.test))
    model = gnn101.build("FinalMPNN", seed=0, device=dev)
    t = time.perf_counter()
    reset_counts()
    res = gnn101.train_model(model, "FinalMPNN", splits=splits, seed=0)
    launched = counts()
    out["8b"] = {"test_mae": res["test_mae"],
                 "best_val_mae": min(res["val_curve"]),
                 "seconds": time.perf_counter() - t,
                 "k4_launches": launched["segment_sum"]}
    forwards = 40 * (n_steps + n_val) + n_test
    want_counts = dict({k: 0 for k in launched},
                       segment_sum=TEACH_K4_PER_FORWARD_FINAL * forwards)
    log(f"[teach] FinalMPNN train_model (40 epochs, 400 molecules, lr 5e-3): "
        f"test MAE {res['test_mae']:.4f} (bound {TEACH_MAE_MAX}), best val "
        f"MAE {min(res['val_curve']):.4f}; {out['8b']['seconds']:.1f} s; K4 "
        f"{launched['segment_sum']} (want {want_counts['segment_sum']}: "
        f"{TEACH_K4_PER_FORWARD_FINAL} x {forwards} forwards) [{card}]")
    if launched != want_counts:
        raise AssertionError(f"FinalMPNN's run launched {launched}, "
                             f"expected {want_counts}")
    if not (np.isfinite(res["test_mae"]) and res["test_mae"] <= TEACH_MAE_MAX):
        raise AssertionError(f"FinalMPNN test MAE {res['test_mae']} is not "
                             f"finite and at most {TEACH_MAE_MAX}")

    mark("8c")
    # 8c. the QM9 pipeline at its defaults
    t = time.perf_counter()
    reset_counts()
    rows = qm9_pipeline.main(["--device", str(dev)])
    launched = counts()
    out["8c"] = {"rows": rows, "seconds": time.perf_counter() - t,
                 "k4_launches": launched["segment_sum"]}
    log(f"[teach] qm9_pipeline (egnn, 30 epochs): last test MAE(denorm) "
        f"{rows[-1][2]:.4f}; {out['8c']['seconds']:.1f} s; launches "
        f"{ {k: v for k, v in launched.items() if v} } [{card}]")
    # EGNN 3 layers: a forward's K4 is 3 x (sum + mean's two) + the sum
    # pool, a train step's one more (the embedding's gradient); the test
    # set (2 batches) is evaluated at each printed row
    want_counts = dict({k: 0 for k in launched}, segment_sum=11 * 30 * n_steps
                       + 10 * len(rows) * n_test)
    if not (np.isfinite(rows[-1][2]) and launched == want_counts):
        raise AssertionError(f"qm9_pipeline: {rows[-1]}, launched {launched}"
                             f", expected {want_counts}")
    return out


DP_KERNELS = {"egnn_message": "k1", "egnn_message_bwd": "k2",
              "segment_sum": "k4"}


def dp_phases(card: str) -> dict:
    """9a-9e (``experiments.dp_check``): raises on any failed check; returns
    the launches per rank by part and the readings."""
    torch.cuda.empty_cache()      # room for the ranks' own contexts
    read, fails = dp_check.run()
    log(f"[dp] NCCL, two ranks on one card: {read['nccl_world2']}")
    log("[dp] collectives through the host by the port's hand: none (gloo "
        "takes CUDA tensors in every collective used: "
        "experiments/probe_backends.py)")
    a, b, c, d, e = (read[p] for p in "abcde")
    log(f"[dp] ranks {read['backends']} (gloo world 2, NCCL world 1); "
        f"launch {read['gloo_launch_s']:.1f} s / {read['world1_launch_s']:.1f}"
        f" s; in the ranks: " + ", ".join(
            f"{p} {v:.1f} s" for p, v in read["rank_seconds"].items()))
    log(f"  9a dp_train_step x{dp_check.STEPS}: summed gradient "
        f"{a['grad_err']:.3e} of each tensor's largest entry, weights "
        f"{a['param_err']:.3e} from two plain steps; launches per rank "
        f"{a['launches_per_rank']}; a step {a['ms_per_step_world2']:.2f} ms "
        f"at world 2 (gloo, one card), {a['ms_per_step_world1']:.2f} ms at "
        f"world 1 (NCCL) [{card}]")
    log(f"  9b zero_dp_train_step: weights {b['param_err']:.3e}; Adam state "
        f"{b['adam_state_elems']} a rank (P {b['params']}, chunk "
        f"{b['chunk']}); launches per rank {b['launches_per_rank']}")
    log(f"  9c fit_dp {dp_check.FIT_EPOCHS} epochs, world 2 vs world 1: "
        f"initial val MAE {c['val0']}, first step's loss "
        f"{c['first_loss_rel']:.3e} apart, step losses within "
        f"{dp_check.STEP_TOL} for {c['steps_within_step_tol']} steps, "
        f"per-epoch rows {c['max_diff']:.3e} apart (not held); world 2 "
        f"{c['perf_world2'][-1]}, world 1 {c['perf_world1_nccl'][-1]}; "
        f"train_time {c['train_time_world2']:.2f} s / "
        f"{c['train_time_world1']:.2f} s; launches per rank "
        f"{c['launches_per_rank']}, world 1 {c['launches_world1']} [{card}]")
    log(f"  9d run_experiment_reg(mesh=) {dp_check.REG_EPOCHS} epochs: test "
        f"MAE {d['test_mae']:.5f} (untrained {d['untrained_test_mae']:.5f}), "
        f"record {d['record']}; launches rank 0 {d['launches']}")
    log(f"  9e Predictor(mesh=) {e['graphs']} graphs, {e['batches']} batches:"
        f" bitwise {e['bitwise']}; launches per rank {e['launches_per_rank']}"
        f"; phase {read['seconds']:.1f} s")
    if fails:
        raise AssertionError("data-parallel path: " + "; ".join(fails))
    return {"9a": a["launches_per_rank"], "9b": b["launches_per_rank"],
            "9c": c["launches_per_rank"], "9d": d["launches"],
            "9e": e["launches_per_rank"], "readings": read}


def reset_counts() -> None:
    egnn_message.launches = egnn_message.bwd_launches = 0
    sss.sorted_segment_sum.launches = sss.segment_sum.launches = 0
    gm.gvp_message.launches = gm.gvp_message.bwd_launches = 0
    es.egnn_stack.launches = es.egnn_stack.bwd_launches = 0
    ec.edge_weighted_contract_grouped.launches = 0
    ec.edge_weighted_contract_grouped.bwd_launches = 0
    ec.edge_weighted_contract.launches = ec.edge_weighted_contract.bwd_launches = 0


def counts() -> dict:
    return {"egnn_message": egnn_message.launches,
            "egnn_message_bwd": egnn_message.bwd_launches,
            "sorted_segment_sum": sss.sorted_segment_sum.launches,
            "segment_sum": sss.segment_sum.launches,
            "gvp_message": gm.gvp_message.launches,
            "gvp_message_bwd": gm.gvp_message.bwd_launches,
            "egnn_stack": es.egnn_stack.launches,
            "egnn_stack_bwd": es.egnn_stack.bwd_launches,
            "edge_contract": ec.edge_weighted_contract_grouped.launches,
            "edge_contract_bwd": ec.edge_weighted_contract_grouped.bwd_launches,
            "edge_contract_one": ec.edge_weighted_contract.launches,
            "edge_contract_one_bwd": ec.edge_weighted_contract.bwd_launches}


def main() -> int:
    mark("1")
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "needs one CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card)                       # name, power limit as nvidia-smi gives them

    mark("2")
    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SIGNATURES:
        _build.load(name)
    log(f"[build] {len(_build.SIGNATURES)} kernel sources in "
        f"{time.perf_counter() - t0:.2f} s")

    mark("3")
    # 3. kernels against their plain versions
    graphs, loaders = bench_data()      # 1400 star graphs, fold 5/6/7, seed 0
    cpu_model = EGNNFusedModel(LAYERS, WIDTH, 1, 1, pool="first",
                               generator=torch.Generator().manual_seed(0),
                               device="cpu")
    log("[kernels] egnn_message vs egnn_message_plain "
        f"(atol={ATOL}, rtol={RTOL})")
    small = random_case(40, 150, 32, seed=1, masked=0.1, dev=dev)
    serve = star_case(graphs, cpu_model, seed=2, dev=dev)
    large = random_case(10_000, 129_000, WIDTH, seed=3, masked=0.0, dev=dev)
    k1_cases = {
        "small": small, "serve bucket": serve,
        "train bucket": train_bucket_case(loaders, cpu_model, seed=5, dev=dev)[:6],
        "N=10k": large, "10k box": box_case(cpu_model, seed=6, dev=dev),
        "empty": random_case(6, 0, WIDTH, seed=7, masked=0.0, dev=dev),
        "below one tile": random_case(20, 5, WIDTH, seed=8, masked=0.1, dev=dev,
                                      index_dtype=np.int64)}
    for d, e, idx in ((16, 700, np.int32), (64, 1400, np.int64),
                      (128, 4193, np.int32), (256, 4000, np.int64)):
        k1_cases[f"D={d}"] = random_case(300, e, d, seed=d, masked=0.1, dev=dev,
                                         index_dtype=idx)
    err = max(check_kernel_case(label, args) for label, args in k1_cases.items())
    check_resident_plans()
    log("  the edge kernel's plan in C equals edge.resident_plan at every "
        "width")

    with torch.no_grad():
        k_ms = kernels_only_ms(serve)
        call_ms = cuda_time_ms(lambda: egnn_message(*serve))
        p_ms = cuda_time_ms(lambda: egnn_message_plain(*serve))
        k_ms_large = kernels_only_ms(large, iters=10)
        call_ms_large = cuda_time_ms(lambda: egnn_message(*large), iters=10)
        p_ms_large = cuda_time_ms(lambda: egnn_message_plain(*large), iters=10)
    b_ms, b_by = bound_ms(serve)
    b_ms_large, b_by_large = bound_ms(large)
    for label, k, c, p, b, by in (
            ("serve bucket", k_ms, call_ms, p_ms, b_ms, b_by),
            ("N=10k", k_ms_large, call_ms_large, p_ms_large, b_ms_large,
             b_by_large)):
        log(f"  {label}: kernels {k:.4f} ms, whole call {c:.4f} ms, plain "
            f"{p:.4f} ms, bound {b:.5f} ms ({by}) [{card}]")

    log("[kernels] egnn_message_bwd vs egnn_message_bwd_plain")
    small_b = with_cotangents(small, seed=4)
    train_b = train_bucket_case(loaders, cpu_model, seed=5, dev=dev)
    large_b = with_cotangents(large, seed=6)
    # full width where egnn_tile changes its tile on 132 SMs: 16-row tiles
    # from 2097 edges, 32-row tiles from 4193
    k2_tiles = {f"tile edge E {e}": with_cotangents(random_case(
        n, e, WIDTH, seed=s_, masked=0.1, dev=dev), s_ + 1)
        for n, e, s_ in ((900, 16 * 131 + 1, 7), (1500, 32 * 131 + 1, 9))}
    bwd_err = max(check_bwd_case("small", small_b),
                  check_bwd_case("train bucket", train_b),
                  *(check_bwd_case(k, c) for k, c in k2_tiles.items()))
    bwd_err_large = check_bwd_case("N=10k", large_b, large=True)
    for label, case in (("train bucket", train_b), ("N=10k", large_b)):
        first, second = egnn_message_bwd(*case), egnn_message_bwd(*case)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"egnn_message_bwd: two runs at {label} "
                                 "differ bitwise")
    log("  two runs at the train bucket and at N=10k are bitwise equal")
    bk_ms = bwd_kernels_only_ms(train_b)
    bcall_ms = cuda_time_ms(lambda: egnn_message_bwd(*train_b))
    bp_ms = cuda_time_ms(lambda: egnn_message_bwd_plain(*train_b))
    bk_ms_large = bwd_kernels_only_ms(large_b, iters=10)
    bcall_ms_large = cuda_time_ms(lambda: egnn_message_bwd(*large_b), iters=10)
    bp_ms_large = cuda_time_ms(lambda: egnn_message_bwd_plain(*large_b),
                               iters=10)
    bb_ms, bb_by = bwd_bound_ms(train_b)
    bb_ms_large, bb_by_large = bwd_bound_ms(large_b)
    k2_split = {}
    for label, case, k, c, p, b, by in (
            ("train bucket", train_b, bk_ms, bcall_ms, bp_ms, bb_ms, bb_by),
            ("N=10k", large_b, bk_ms_large, bcall_ms_large, bp_ms_large,
             bb_ms_large, bb_by_large)):
        split = bench_kernels.kernel_split(lambda: egnn_message_bwd(*case), 10)
        k2_split[label] = {n: v for n, v in split.items()
                           if n.startswith("egnn_bwd_")}
        log(f"  {label} (tile {edge.kernel_tile(case[0].shape[0], WIDTH, dev)})"
            f": K2 kernels {k:.4f} ms, whole call {c:.4f} ms, plain {p:.4f} ms, "
            f"bound {b:.5f} ms ({by}); by kernel "
            + ", ".join(f"{n} {v:.4f}" for n, v in k2_split[label].items())
            + f" ms [{card}]")
    del k2_tiles

    log("[kernels] sorted_segment_sum (K3) and segment_sum (K4) vs "
        f"sorted_segment_sum_plain (atol=rtol={SEG_TOL}) [{card}]")
    t = time.perf_counter()
    box = bench_scale.box_batch(BOX_ATOMS, sort=True).to(dev)
    box_plans = sss.batch_seg_plans(box)
    box_edges = int(box.edge_mask.sum())
    log(f"  receiver-sorted box of {BOX_ATOMS} atoms, {box_edges} edges (bucket "
        f"N {box.num_nodes}, E {box.num_edges}): built, planned and copied in "
        f"{time.perf_counter() - t:.2f} s; receiver plan identity "
        f"{box_plans['rcv'].identity_perm}, sender plan identity "
        f"{box_plans['snd'].identity_perm}")
    if not box_plans["rcv"].identity_perm or box_plans["snd"].identity_perm:
        raise AssertionError("the sorted box's receiver plan must be the "
                             "identity and its sender plan not")
    k3 = []
    data, seg, mask = random_seg_case(3000, 700, 64, seed=21, masked=0.1, dev=dev)
    k3.append(check_segsum("random ids, 10% masked", data, seg, mask, 700,
                           sss.build_segment_plan(seg, 700, mask, device=dev)))
    data, seg, mask = random_seg_case(1500, 40, 32, seed=22, masked=1.0, dev=dev)
    plan = sss.build_segment_plan(seg, 300, mask, device=dev)
    k3.append(check_segsum("all masked, N 300", data, seg, mask, 300, plan,
                           timed=False))
    if sss.sorted_segment_sum(data, plan, seg, mask).abs().max().item() != 0:
        raise AssertionError("all masked: the sum is not zero")
    # D 177: gvp_sorted's merged receiver sum (128 + 3 x 16 + the count);
    # D 176: its sender gather's backward
    for key, d, seed in (("rcv", 128, 23), ("rcv", 4, 24), ("snd", 128, 25),
                         ("snd", 3, 26), ("rcv", 177, 41), ("snd", 176, 42)):
        idx = box.receivers if key == "rcv" else box.senders
        k3.append(check_segsum(f"box {key} plan D{d}", box_rows(box, d, seed),
                               idx, box.edge_mask, box.num_nodes,
                               box_plans[key]))
    data, seg, mask = random_seg_case(3000, 700, 64, seed=27, masked=0.1, dev=dev)
    k4 = [check_segsum("K4 random ids, 10% masked", data, seg, mask, 700)]
    shuffle = torch.from_numpy(np.random.default_rng(28).permutation(
        box.num_edges)).to(dev)
    k4.append(check_segsum("K4 shuffled box D128", box_rows(box, 128, 29),
                           box.receivers[shuffle], box.edge_mask[shuffle],
                           box.num_nodes))
    # a sum pool of the box's nodes into its one graph: one long segment
    gen = torch.Generator(device=dev).manual_seed(30)
    k4.append(check_segsum("K4 box pool D176", torch.randn(
        (box.num_nodes, 176), generator=gen, device=dev), box.graph_id,
        box.node_mask, box.num_graphs, long_rows=True))
    del data, seg, mask, shuffle
    torch.cuda.empty_cache()

    mark("3b")
    # 3b. K5 against its plain version
    log("[kernels] gvp_message (K5) vs gvp_message_plain: forward atol = rtol "
        f"= {ATOL}; backward as chip_smoke.check_gvp_bwd states [{card}]")
    gvp_cuda = gvp_model(dev)
    k5_small = gvp_random_case(40, 150, seed=21, masked=0.1, dev=dev)
    slot = build_slot_data(loaders[0].graphs, device=dev)
    k5_train = bench_kernels.gvp_layer_case(
        assemble_batch(slot, torch.arange(BATCH, device=dev)), gvp_cuda,
        seed=31)
    t = time.perf_counter()
    gvp_box = bench_scale.box_batch(GVP_BOX_ATOMS, sort=False).to(dev)
    k5_box = bench_kernels.gvp_layer_case(gvp_box, gvp_cuda, seed=32)
    log(f"  unsorted box of {GVP_BOX_ATOMS} atoms: {int(gvp_box.edge_mask.sum())} "
        f"edges (bucket N {gvp_box.num_nodes}, E {gvp_box.num_edges}), built "
        f"in {time.perf_counter() - t:.2f} s")
    # full width where gvp_tile changes its tile on 132 SMs: 16-edge tiles
    # from 2097 edges, 32-edge forward tiles from 4193
    k5_edges = {f"tile edge E {e}": gvp_random_case(
        n, e, seed=s_, masked=0.1, dev=dev, node=(128, 16), edge_dims=(32, 1))
        for n, e, s_ in ((900, 16 * 131 + 1, 24), (1500, 32 * 131 + 1, 25))}
    k5_err = max(check_gvp_fwd("small", k5_small),
                 check_gvp_fwd("train bucket", k5_train),
                 check_gvp_fwd("10k box", k5_box),
                 *(check_gvp_fwd(k, c) for k, c in k5_edges.items()))
    k5_bwd_err = max(check_gvp_bwd("small", k5_small),
                     check_gvp_bwd("train bucket", k5_train),
                     *(check_gvp_bwd(k, c) for k, c in k5_edges.items()))
    k5_bwd_err_box = check_gvp_bwd("10k box", k5_box, w_tol=W_TOL_BOX)
    k5_times = {}
    for label, case, iters in (("train bucket", k5_train, 50),
                               ("10k box", k5_box, 5),
                               *((k, c, 20) for k, c in k5_edges.items())):
        idx, nodes, edges, ws, cots = case
        chain = len(ws) // gm.N_W
        with torch.no_grad():
            fk = gvp_kernels_ms(case, iters, backward=False)
            fc = cuda_time_ms(lambda: gm.gvp_message(*idx, *nodes, *edges, *ws),
                              iters)
            fp = cuda_time_ms(lambda: gm.gvp_message_plain(
                *idx, *nodes, *edges, ws, chain), iters)
            bk = gvp_kernels_ms(case, iters, backward=True)
            bc = cuda_time_ms(lambda: gm.gvp_message_bwd(
                *idx, *nodes, *edges, ws, *cots), iters)
            bp = cuda_time_ms(lambda: gm.gvp_message_bwd_plain(
                *idx, *nodes, *edges, ws, *cots), iters)
        (fb, fby), (bb, bby) = gvp_bound_ms(case, False), gvp_bound_ms(case, True)
        tiles = gm.kernel_tiles(ws, idx[0].shape[0], dev)
        with torch.no_grad():
            split = bench_kernels.kernel_split(lambda: gm.gvp_message_bwd(
                *idx, *nodes, *edges, ws, *cots), max(2, iters // 5))
        split = {k: v for k, v in split.items() if k.startswith("gvp_")}
        k5_times[label] = {"E": idx[0].shape[0], "live": int(idx[2].sum()),
                           "N": nodes[0].shape[0], "tiles": tiles,
                           "fwd": dict(ms=fk, call_ms=fc, plain_ms=fp,
                                       bound_ms=fb, bound_by=fby),
                           "bwd": dict(ms=bk, call_ms=bc, plain_ms=bp,
                                       bound_ms=bb, bound_by=bby,
                                       split_ms=split)}
        log(f"  {label} (edge tiles {tiles[0]} forward, {tiles[1]} backward): "
            f"forward kernels {fk:.4f} ms, whole call {fc:.4f} ms, "
            f"plain {fp:.4f} ms, bound {fb:.5f} ms ({fby}); backward kernels "
            f"{bk:.4f} ms, whole call {bc:.4f} ms, plain {bp:.4f} ms, bound "
            f"{bb:.5f} ms ({bby}); backward by kernel "
            + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
            + f" ms [{card}]")
    del k5_box, k5_edges

    mark("3c")
    # 3c. K6 against its plain versions
    log("[kernels] egnn_stack (K6) vs egnn_stack_plain: forward atol = rtol = "
        f"{ATOL}; backward as chip_smoke.check_stack_bwd states [{card}]")
    # the tile rule sizes shared memory by a Python mirror of the kernels'
    # layout: it must match the kernels' own count
    smem_lib = _build.load("egnn_message_bwd")
    for tile in edge.TILES:
        for d in (16, 128, 256):
            if smem_lib.gmp_egnn_tile_smem(tile, d) != edge.tile_smem_bytes(tile, d):
                raise AssertionError(f"tile {tile}, D {d}: shared memory "
                                     f"{smem_lib.gmp_egnn_tile_smem(tile, d)} in "
                                     "the kernels, "
                                     f"{edge.tile_smem_bytes(tile, d)} mirrored")
    log(f"  shared memory of a tile: the mirror matches the kernels' at tiles "
        f"{edge.TILES}, D 16/128/256")
    wall = model_wall(cpu_model, dev)
    k6_small = stack_random_case(30, 110, 16, 3, seed=41, dev=dev)
    k6_train = stack_case(assemble_batch(slot, torch.arange(BATCH, device=dev)),
                          wall, seed=42)
    k6_box = stack_case(gvp_box, wall, seed=43)
    # full width where egnn_tile changes its tile on 132 SMs (as phase 3),
    # one layer: a tile runs the same code at any depth, and one layer keeps
    # a ReLU flip from spreading through the layers below (held strictly)
    k6_tiles = {f"tile edge E {e}": stack_random_case(n, e, WIDTH, 1,
                                                      seed=s_, dev=dev)
                for n, e, s_ in ((900, 16 * 131 + 1, 44), (1500, 32 * 131 + 1, 45))}
    k6_err = max(check_stack_fwd("small", k6_small),
                 check_stack_fwd("train bucket", k6_train),
                 check_stack_fwd("10k box", k6_box),
                 *(check_stack_fwd(k, c) for k, c in k6_tiles.items()))
    k6_bwd_err = max(check_stack_bwd("small", k6_small),
                     check_stack_bwd("train bucket", k6_train),
                     *(check_stack_bwd(k, c) for k, c in k6_tiles.items()))
    k6_bwd_err_box = check_stack_bwd("10k box", k6_box, large=True)
    k6_times = {}
    for label, case, iters in (("train bucket", k6_train, 50),
                               ("10k box", k6_box, 5),
                               *((k, c, 20) for k, c in k6_tiles.items())):
        args, cot = case
        layers = args[5].shape[0]
        with torch.no_grad():
            fk = stack_kernel_ms(case, iters, backward=False)
            fc = cuda_time_ms(lambda: es.egnn_stack(*args, layers), iters)
            fp = cuda_time_ms(lambda: es.egnn_stack_plain(*args, layers), iters)
            bk = stack_kernel_ms(case, iters, backward=True)
            bc = cuda_time_ms(lambda: es.egnn_stack_bwd(*args, layers, *cot),
                              iters)
            bp = cuda_time_ms(lambda: es.egnn_stack_bwd_plain(*args, layers,
                                                              *cot), iters)
        (fb, fby), (bb, bby) = (stack_bound_ms(case, False),
                                stack_bound_ms(case, True))
        tile = edge.kernel_tile(args[0].shape[0], args[3].shape[1], dev)
        with torch.no_grad():
            split = {d_: {n: v for n, v in bench_kernels.kernel_split(
                fn, max(2, iters // 5)).items() if n.startswith("egnn_stack_")}
                for d_, fn in (
                    ("fwd", lambda: es.egnn_stack(*args, layers)),
                    ("bwd", lambda: es.egnn_stack_bwd(*args, layers, *cot)))}
        k6_times[label] = {"E": args[0].shape[0], "live": int(args[2].sum()),
                           "N": args[3].shape[0], "L": layers, "tile": tile,
                           "fwd": dict(ms=fk, call_ms=fc, plain_ms=fp,
                                       bound_ms=fb, bound_by=fby,
                                       split_ms=split["fwd"]),
                           "bwd": dict(ms=bk, call_ms=bc, plain_ms=bp,
                                       bound_ms=bb, bound_by=bby,
                                       split_ms=split["bwd"])}
        log(f"  {label} (tile {tile}): forward kernel {fk:.4f} ms, whole call "
            f"{fc:.4f} ms, plain {fp:.4f} ms, bound {fb:.5f} ms ({fby}); "
            f"backward kernel {bk:.4f} ms, whole call {bc:.4f} ms, plain "
            f"{bp:.4f} ms, bound {bb:.5f} ms ({bby}); by CUDA kernel "
            + ", ".join(f"{d_} {n} {v:.4f}" for d_, sp in split.items()
                        for n, v in sp.items()) + f" ms [{card}]")
    del k6_box, gvp_box, slot, k6_tiles
    torch.cuda.empty_cache()

    mark("3d")
    # 3d. K7 against its plain versions: the JAX test's shapes, then every
    # group of TFN's layer 0 and hidden layers at its train bucket
    log(f"[kernels] edge_weighted_contract (K7) vs its plain versions, "
        f"forward and backward: tol {K7_TOL:g} (f32 W) / {K7_TOL_BF16:g} (bf16 "
        f"W) of max(|ref|, 1) [{card}]")
    tfn_graphs, tfn_loaders = tfn_data()
    tfn_cpu = tfn_model("cpu")
    tfn_slot = build_slot_data(tfn_loaders[0].graphs, device=dev)
    tfn_e = assemble_batch(tfn_slot, torch.arange(BATCH, device=dev)).num_edges
    k7_small = [check_k7(f"JAX test {e}x{k}x{w}x{m}", k7_case(
        e, k, w, m, dt, seed=50 + i, dev=dev), timed=False)
        for i, (e, k, w, m, dt) in enumerate((
            (70, 96, 16, 7, torch.float32), (64, 32, 8, 1, torch.float32),
            (33, 64, 16, 5, torch.bfloat16)))]
    k7_groups = {}
    for layer, conv in (("layer 0", tfn_cpu.convs[0]),
                        ("hidden", tfn_cpu.convs[1])):
        k7_groups[layer] = [
            check_k7(f"{layer} group {g} (K {k}, m {m}, w {w})",
                     k7_case(tfn_e, k, w, m, torch.float32, seed=60 + g, dev=dev))
            for g, (k, m, w) in enumerate(conv.tp.group_shapes)]
    k, m, w = tfn_cpu.convs[1].tp.group_shapes[3]
    k7_bf16 = check_k7(f"hidden group 3 bf16 W (K {k}, m {m}, w {w})",
                       k7_case(tfn_e, k, w, m, torch.bfloat16, seed=70, dev=dev))
    k7_layer = {layer: k7_layer_sum(r) for layer, r in k7_groups.items()}
    for layer, t in k7_layer.items():
        log(f"  {layer} at E {tfn_e}, 5 groups one launch each: forward kernels "
            f"{t['fwd']['ms']:.4f} ms, whole calls {t['fwd']['call_ms']:.4f}, "
            f"plain {t['fwd']['plain_ms']:.4f}, bmm {t['fwd']['library_ms']:.4f}, "
            f"bound {t['fwd']['bound_ms']:.5f}; backward kernels "
            f"{t['bwd']['ms']:.4f} ms, whole calls {t['bwd']['call_ms']:.4f}, "
            f"plain {t['bwd']['plain_ms']:.4f}, bmm {t['bwd']['library_ms']:.4f}, "
            f"bound {t['bwd']['bound_ms']:.5f} [{card}]")
    log(f"  hidden group 3 with bf16 W: forward {k7_bf16['fwd']['ms']:.4f} ms, "
        f"backward {k7_bf16['bwd']['ms']:.4f} ms; with f32 W "
        f"{k7_groups['hidden'][3]['fwd']['ms']:.4f} / "
        f"{k7_groups['hidden'][3]['bwd']['ms']:.4f} ms [{card}]")
    # the same group alone through the grouped kernel, TFN's path
    k7_g3 = {name: check_k7_layer(
        f"hidden group 3 grouped, {name} W, at E {tfn_e}",
        [k7_case(tfn_e, k, w, m, dt, seed=70, dev=dev)])
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    log(f"  hidden group 3 through the grouped kernel: bf16 W forward "
        f"{k7_g3['bf16']['fwd']['ms']:.4f} ms, backward "
        f"{k7_g3['bf16']['bwd']['ms']:.4f} ms; f32 W "
        f"{k7_g3['f32']['fwd']['ms']:.4f} / {k7_g3['f32']['bwd']['ms']:.4f} ms "
        f"[{card}]")
    # the main path's call: a layer's groups in one launch per direction
    k7_grouped = {}
    for layer, conv in (("layer 0", tfn_cpu.convs[0]),
                        ("hidden", tfn_cpu.convs[1])):
        k7_grouped[layer] = check_k7_layer(
            f"{layer} grouped at E {tfn_e}", [
                k7_case(tfn_e, k, w, m, torch.float32, seed=60 + g, dev=dev)
                for g, (k, m, w) in enumerate(conv.tp.group_shapes)])
        torch.cuda.empty_cache()
    k7_grouped["hidden bf16 W"] = check_k7_layer(
        f"hidden grouped, bf16 W, at E {tfn_e}", [
            k7_case(tfn_e, k, w, m, torch.bfloat16, seed=70 + g, dev=dev)
            for g, (k, m, w) in enumerate(tfn_cpu.convs[1].tp.group_shapes)])
    torch.cuda.empty_cache()
    for layer, g in k7_grouped.items():
        log(f"  {layer}: grouped launch against the five one-group launches "
            f"back to back: forward {g['fwd']['ms']:.4f} / "
            f"{g['fwd']['one_group_ms']:.4f} ms, backward {g['bwd']['ms']:.4f} / "
            f"{g['bwd']['one_group_ms']:.4f} ms [{card}]")
    # MACE's group sets (ungated: the hidden irreps exactly) at its train
    # bucket, f32 W: layer 0 (64x0e in) and the hidden layer, one grouped
    # launch per direction each
    mace_graphs, mace_loaders = mace_data()
    mace_cpu = mace_model("cpu")
    mace_slot = build_slot_data(mace_loaders[0].graphs, device=dev)
    mace_e = assemble_batch(mace_slot, torch.arange(BATCH, device=dev)).num_edges
    del mace_slot
    k7_mace = {}
    for layer, conv in (("MACE layer 0", mace_cpu.convs[0]),
                        ("MACE hidden", mace_cpu.convs[1])):
        k7_mace[layer] = check_k7_layer(
            f"{layer} grouped at E {mace_e} (groups (K, m, w) "
            f"{conv.tp.group_shapes})", [
                k7_case(mace_e, k, w, m, torch.float32, seed=80 + g, dev=dev)
                for g, (k, m, w) in enumerate(conv.tp.group_shapes)])
        torch.cuda.empty_cache()
    mace_w_bytes = {layer: 4 * mace_e * sum(conv.tp.group_weight_numels)
                    for layer, conv in (("layer 0", mace_cpu.convs[0]),
                                        ("hidden", mace_cpu.convs[1]))}
    log(f"  MACE per-edge weights at E {mace_e}: layer 0 "
        f"{mace_w_bytes['layer 0'] / 1e6:.1f} MB, hidden "
        f"{mace_w_bytes['hidden'] / 1e6:.1f} MB "
        f"({sum(mace_cpu.convs[1].tp.group_weight_numels)} weights an edge)")
    k7_err = max(r["max_abs_err"] for r in k7_small + [k7_bf16] + [
        x for rs in k7_groups.values() for x in rs] + list(k7_grouped.values())
        + list(k7_g3.values()) + list(k7_mace.values()))
    del tfn_slot
    torch.cuda.empty_cache()

    mark("3e")
    # 3e. K3 on the triplet fold: the identity plan of the ascending idx_ji
    log(f"[kernels] sorted_segment_sum (K3) on the triplet fold: "
        f"sorted_fold over ascending_plan vs the plain sum (atol=rtol="
        f"{SEG_TOL}) [{card}]")
    dn_data, dn_loaders = triplet_star_data(**DIMENET_STAR)
    sn_data, sn_loaders = triplet_star_data(**SPHERENET_STAR)
    dn_batch = next(iter(dn_loaders[0]))
    t = time.perf_counter()
    tri_box = bench_scale.box_batch(DIMENET_BOX_ATOMS, sort=False,
                                    triplets=True).to(dev)
    log(f"  the unsorted {DIMENET_BOX_ATOMS}-atom box with its "
        f"{int(tri_box.triplets.t_mask.sum())} triplets: built and copied in "
        f"{time.perf_counter() - t:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(50)
    fold_cases = {"star train bucket": dn_batch.to(dev),
                  f"{DIMENET_BOX_ATOMS // 1000}k box": tri_box}
    k3_fold = []
    for label, b in fold_cases.items():
        tri = b.triplets
        y = torch.randn((tri.num_triplets, 64), generator=gen, device=dev)
        k3_fold.append(check_triplet_fold(f"fold {label} D64", y, tri.idx_ji,
                                          tri.t_mask, b.num_edges))
    k3_fold.append(check_triplet_fold("fold masked tail, empty edge D64",
                                      *tail_masked_case(dev), 500))
    del y
    torch.cuda.empty_cache()

    mark("3f")
    # 3f. K4 and the fold at every shape the star models launch
    log(f"[kernels] segment sums at the star models' shapes (a train step "
        f"and a predict batch of egnn, egnn_stack, gvp, tfn, mace, dimenet "
        f"and spherenet, of the expressivity arms "
        f"{list(bench_kernels.EXPRESSIVITY_MODELS)} and of the CLI's "
        f"{list(bench_kernels.CLI_MODELS)}): K4 and the fold vs "
        f"plain (SEG_TOL {SEG_TOL} of max(|ref|, 1)) [{card}]")
    t = time.perf_counter()
    star_cap = bench_kernels.capture_star_shapes(dev)
    log(f"  {len(star_cap.shapes)} shapes captured in "
        f"{time.perf_counter() - t:.2f} s")
    star_segsum = check_star_segsum(star_cap)
    del star_cap
    torch.cuda.empty_cache()

    mark("3f force fields")
    # 3f, the force fields: K4 at every shape a mace_ff and a tfn_ff step
    # launch on the unsorted 10k box
    ff_box, ff_segsum = check_ff_segsum(dev, card)

    mark("4")
    # 4. serve
    model = EGNNFusedModel(LAYERS, WIDTH, 1, 1, pool="first",
                           generator=torch.Generator().manual_seed(0),
                           device="cuda")
    for key, value in model.state_dict().items():
        if not torch.equal(value.cpu(), cpu_model.state_dict()[key]):
            raise AssertionError(f"CPU and CUDA models differ at {key}")
    pred = Predictor(model, batch_size=BATCH)
    reset_counts()
    y = pred.predict(graphs)
    serve_counts = counts()
    launches = serve_counts["egnn_message"]
    if any(serve_counts[k] for k in serve_counts if k != "egnn_message"):
        raise AssertionError(f"predict launched other kernels: {serve_counts}")
    want = -(-N_GRAPHS // BATCH) * LAYERS
    log(f"[serve] predict({N_GRAPHS} graphs): egnn_message launches "
        f"{launches} (want {want}), bucket {pred.pad}")
    if y.shape != (N_GRAPHS, 1) or not np.isfinite(y).all():
        raise AssertionError(f"predict gave shape {y.shape}, "
                             f"finite={np.isfinite(y).all()}")
    if launches != want:
        raise AssertionError(f"egnn_message launched {launches} times, "
                             f"expected {want}")
    y_cpu = Predictor(cpu_model, batch_size=BATCH, device="cpu").predict(graphs)
    serve_err = float(np.abs(y - y_cpu).max())
    log(f"  vs the CPU plain path: max_abs_err={serve_err:.3e} (atol 1e-4)")
    if not np.allclose(y, y_cpu, atol=1e-4, rtol=0):
        raise AssertionError(f"predict differs from the CPU run by {serve_err}")

    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred.predict(graphs)      # ends in a copy to the host: synchronous
        times.append(time.perf_counter() - t)
    ms = statistics.median(times) * 1e3
    t = time.perf_counter()
    for _ in range(3):
        for batch in GraphLoader(graphs, BATCH, pad=pred.pad):
            batch.to(dev)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) / 3 * 1e3
    log(f"[serve] predict: median {ms:.2f} ms per call of 7 "
        f"({N_GRAPHS / ms * 1e3:.0f} graphs/s); batch build + copy alone "
        f"{host_ms:.2f} ms; {want} calls x {call_ms:.4f} ms = "
        f"{want * call_ms:.2f} ms [{card}]")

    mark("4b")
    # 4b. GVP serving
    gvp_cpu = gvp_model("cpu")
    for key, value in gvp_cuda.state_dict().items():
        if not torch.equal(value.cpu(), gvp_cpu.state_dict()[key]):
            raise AssertionError(f"CPU and CUDA GVP models differ at {key}")
    gvp_pred = Predictor(gvp_cuda, batch_size=BATCH)
    reset_counts()
    y_gvp = gvp_pred.predict(graphs)
    gvp_serve = counts()
    gvp_want = -(-N_GRAPHS // BATCH) * GVP_LAYERS
    gvp_batches = -(-N_GRAPHS // BATCH)
    log(f"[serve] GVP-GNN ({GVP_LAYERS} layers, 128/16, use_pallas=True) "
        f"predict({N_GRAPHS} graphs): launches {gvp_serve} (want K5 forward "
        f"{gvp_want}, K4 {gvp_batches} (the sum pool), nothing else)")
    if y_gvp.shape != (N_GRAPHS, 1) or not np.isfinite(y_gvp).all():
        raise AssertionError(f"GVP predict gave shape {y_gvp.shape}, "
                             f"finite={np.isfinite(y_gvp).all()}")
    if gvp_serve != dict({k: 0 for k in gvp_serve}, gvp_message=gvp_want,
                         segment_sum=gvp_batches):
        raise AssertionError(f"GVP predict launched {gvp_serve}")
    y_gvp_cpu = Predictor(gvp_cpu, batch_size=BATCH, device="cpu").predict(graphs)
    gvp_serve_err = float(np.abs(y_gvp - y_gvp_cpu).max())
    log(f"  vs the CPU plain path: max_abs_err={gvp_serve_err:.3e} (atol 1e-4)")
    if not np.allclose(y_gvp, y_gvp_cpu, atol=1e-4, rtol=0):
        raise AssertionError(f"GVP predict differs from the CPU run by "
                             f"{gvp_serve_err}")
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        gvp_pred.predict(graphs)
        times.append(time.perf_counter() - t)
    gvp_ms = statistics.median(times) * 1e3
    log(f"[serve] GVP predict: median {gvp_ms:.2f} ms per call of 7 "
        f"({N_GRAPHS / gvp_ms * 1e3:.0f} graphs/s) [{card}]")

    mark("4c")
    # 4c. whole-stack serving, phase 4's weights
    stack_model = EGNNFusedModel(LAYERS, WIDTH, 1, 1, pool="first",
                                 fuse_stack=True, device="cuda",
                                 generator=torch.Generator().manual_seed(0))
    stack_cpu = EGNNFusedModel(LAYERS, WIDTH, 1, 1, pool="first",
                               fuse_stack=True, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    for key, value in stack_model.state_dict().items():
        if not torch.equal(value.cpu(), cpu_model.state_dict()[key]):
            raise AssertionError(f"the stack and per-layer models differ at {key}")
    stack_pred = Predictor(stack_model, batch_size=BATCH)
    reset_counts()
    y_stack = stack_pred.predict(graphs)
    stack_serve = counts()
    stack_want = -(-N_GRAPHS // BATCH)
    log(f"[serve] EGNN whole stack (fuse_stack=True) predict({N_GRAPHS} "
        f"graphs): launches {stack_serve} (want K6 forward {stack_want}, "
        "nothing else)")
    if y_stack.shape != (N_GRAPHS, 1) or not np.isfinite(y_stack).all():
        raise AssertionError(f"stack predict gave shape {y_stack.shape}, "
                             f"finite={np.isfinite(y_stack).all()}")
    if stack_serve != dict({k: 0 for k in stack_serve}, egnn_stack=stack_want):
        raise AssertionError(f"stack predict launched {stack_serve}")
    y_stack_cpu = Predictor(stack_cpu, batch_size=BATCH,
                            device="cpu").predict(graphs)
    stack_serve_err = (float(np.abs(y_stack - y_stack_cpu).max()),
                       float(np.abs(y_stack - y).max()))
    log(f"  vs the CPU plain path: max_abs_err={stack_serve_err[0]:.3e}; vs "
        f"phase 4's per-layer result: {stack_serve_err[1]:.3e} (atol 1e-4)")
    if not (np.allclose(y_stack, y_stack_cpu, atol=1e-4, rtol=0)
            and np.allclose(y_stack, y, atol=1e-4, rtol=0)):
        raise AssertionError(f"stack predict differs by {stack_serve_err}")
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        stack_pred.predict(graphs)
        times.append(time.perf_counter() - t)
    stack_ms = statistics.median(times) * 1e3
    log(f"[serve] stack predict: median {stack_ms:.2f} ms per call of 7 "
        f"({N_GRAPHS / stack_ms * 1e3:.0f} graphs/s); per layer (phase 4) "
        f"{ms:.2f} ms [{card}]")

    mark("4d")
    # 4d. TFN serving at the star configuration's full width
    tfn_cuda = tfn_model(dev)
    for key, value in tfn_cuda.state_dict().items():
        if not torch.equal(value.cpu(), tfn_cpu.state_dict()[key]):
            raise AssertionError(f"CPU and CUDA TFN models differ at {key}")
    tfn_pred = Predictor(tfn_cuda, batch_size=BATCH)
    reset_counts()
    y_tfn = tfn_pred.predict(tfn_graphs)
    tfn_serve = counts()
    tfn_batches = -(-N_GRAPHS // BATCH)
    tfn_layers = TFN_STAR["num_layers"]
    tfn_serve_want = dict({k: 0 for k in tfn_serve},
                          edge_contract=tfn_layers * tfn_batches,
                          segment_sum=tfn_layers * tfn_batches)
    log(f"[serve] TFN {TFN_STAR} predict({N_GRAPHS} star graphs, fold [7]): "
        f"launches {tfn_serve} (want K7 {tfn_serve_want['edge_contract']} "
        f"forward, K4 {tfn_serve_want['segment_sum']}, nothing else)")
    if y_tfn.shape != (N_GRAPHS, 1) or not np.isfinite(y_tfn).all():
        raise AssertionError(f"TFN predict gave shape {y_tfn.shape}, "
                             f"finite={np.isfinite(y_tfn).all()}")
    if tfn_serve != tfn_serve_want:
        raise AssertionError(f"TFN predict launched {tfn_serve}")
    t = time.perf_counter()
    y_tfn_cpu = Predictor(tfn_cpu, batch_size=BATCH,
                          device="cpu").predict(tfn_graphs)
    tfn_cpu_s = time.perf_counter() - t
    tfn_serve_err = float(np.abs(y_tfn - y_tfn_cpu).max())
    log(f"  vs the CPU plain path ({tfn_cpu_s:.1f} s on the host): "
        f"max_abs_err={tfn_serve_err:.3e} (atol 1e-4)")
    if not np.allclose(y_tfn, y_tfn_cpu, atol=1e-4, rtol=0):
        raise AssertionError(f"TFN predict differs from the CPU run by "
                             f"{tfn_serve_err}")
    times = []
    for _ in range(7):
        torch.cuda.synchronize()
        t = time.perf_counter()
        tfn_pred.predict(tfn_graphs)
        times.append(time.perf_counter() - t)
    tfn_ms = statistics.median(times) * 1e3
    log(f"[serve] TFN predict: median {tfn_ms:.2f} ms per call of 7 "
        f"({N_GRAPHS / tfn_ms * 1e3:.0f} graphs/s) [{card}]")

    mark("4e / 4f")
    # 4e / 4f. DimeNet++ and SphereNet serving over their star data
    triplet_serve = {"dimenet": serve_triplet("dimenet", dn_data, dev, card),
                     "spherenet": serve_triplet("spherenet", sn_data, dev,
                                                card)}

    mark("4g")
    # 4g. MACE serving at the star configuration's full width
    mace_cuda = mace_model(dev)
    for key, value in mace_cuda.state_dict().items():
        if not torch.equal(value.cpu(), mace_cpu.state_dict()[key]):
            raise AssertionError(f"CPU and CUDA MACE models differ at {key}")
    mace_pred = Predictor(mace_cuda, batch_size=BATCH)
    reset_counts()
    y_mace = mace_pred.predict(mace_graphs)
    mace_serve = counts()
    mace_n = len(mace_graphs)
    mace_batches = -(-mace_n // BATCH)
    mace_layers = MACE_STAR["num_layers"]
    mace_serve_want = dict({k: 0 for k in mace_serve}, **{
        k: v for k, v in mace_launches(mace_layers, mace_batches, 0).items()
        if v})
    log(f"[serve] MACE {MACE_STAR} predict({mace_n} star graphs, fold [7]): "
        f"launches {mace_serve} (want {mace_serve_want}: per batch K7 and K4 "
        f"once a layer)")
    if y_mace.shape != (mace_n, 1) or not np.isfinite(y_mace).all():
        raise AssertionError(f"MACE predict gave shape {y_mace.shape}, "
                             f"finite={np.isfinite(y_mace).all()}")
    if mace_serve != mace_serve_want:
        raise AssertionError(f"MACE predict launched {mace_serve}")
    t = time.perf_counter()
    y_mace_cpu = Predictor(mace_cpu, batch_size=BATCH,
                           device="cpu").predict(mace_graphs)
    mace_cpu_s = time.perf_counter() - t
    mace_serve_err = float(np.abs(y_mace - y_mace_cpu).max())
    log(f"  vs the CPU plain path ({mace_cpu_s:.1f} s on the host): "
        f"max_abs_err={mace_serve_err:.3e} (atol = rtol = 1e-4)")
    if not np.allclose(y_mace, y_mace_cpu, atol=1e-4, rtol=1e-4):
        raise AssertionError(f"MACE predict differs from the CPU run by "
                             f"{mace_serve_err}")
    times = []
    for _ in range(MACE_SERVE_CALLS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        mace_pred.predict(mace_graphs)
        times.append(time.perf_counter() - t)
    mace_ms = statistics.median(times) * 1e3
    log(f"[serve] MACE predict: median {mace_ms:.2f} ms per call of "
        f"{MACE_SERVE_CALLS} ({mace_n / mace_ms * 1e3:.0f} graphs/s) [{card}]")
    del mace_pred
    torch.cuda.empty_cache()

    mark("4h")
    # 4h. MACE-FF serving at full width over MACE's star graphs
    mff_serve = serve_mace_ff(mace_graphs, dev, card)

    mark("5")
    # 5. train, against the CPU: one step's gradients, then one epoch
    steps, val_b, test_b = (len(ld) for ld in loaders)
    order = torch.from_numpy(np.random.default_rng(7).permutation(
        loaders[0].num_examples))
    runs = (("card", "cuda", torch.float32, egnn_message),
            ("card, plain message pass", "cuda", torch.float32,
             egnn_message_plain),
            ("card, planted fault", "cuda", torch.float32, without_weight_grad),
            ("cpu f32", "cpu", torch.float32, egnn_message),
            ("cpu f64", "cpu", torch.float64, egnn_message))
    step, epoch = {}, {}
    for run, d_, dtype, fn in runs:
        with patched(egnn_fused, "egnn_message", fn):
            step[run] = first_step(cpu_model, d_, dtype, loaders[0].graphs,
                                   order[:BATCH])
            egnn_message.launches = egnn_message.bwd_launches = 0
            res = fit_regression(copy.deepcopy(cpu_model).to(dtype=dtype), None,
                                 *loaders, n_epochs=1, lr=LR, seed=0,
                                 device=d_, epoch_order=lambda e: order)
        epoch[run] = np.concatenate([res.train_losses.ravel(),
                                     res.perf_per_epoch.ravel()]).astype(np.float64)
        if run == "card":
            one_epoch = (egnn_message.launches, egnn_message.bwd_launches)
    want_one = (LAYERS * (steps + val_b + test_b), LAYERS * steps)
    exact = epoch["cpu f64"]
    spread = float(np.max(np.abs(epoch["cpu f32"] - exact) / np.abs(exact)))
    tol = max(1e-5, 10 * spread)
    log(f"[train] one step (graphs order[:{BATCH}]) and one epoch ({steps} "
        "step losses, test and val MAE) against the CPU float64 run: "
        f"gradients tol {GRAD_TOL:g} of each parameter's largest entry, "
        f"epoch tol {tol:.3e} relative (10x the CPU float32 run's); launches "
        f"K1 {one_epoch[0]}, K2 {one_epoch[1]} (want {want_one})")
    check = {}
    for run, *_ in runs[:-1]:
        g_err, flips, moved, _ = step_reading(step[run], step["cpu f64"])
        rel = np.abs(epoch[run] - exact) / np.abs(exact)
        e_err = float(rel.max())
        check[run] = {"grad_err": g_err, "sign_flips": flips,
                      "step_lr": moved, "epoch_err": e_err}
        log(f"  {run}: gradients within {g_err:.3e}, {flips} signs differ, "
            f"parameters within {moved:.3f} lr after the step; epoch within "
            f"{e_err:.3e} (by step loss, then test, val: "
            f"{' '.join(f'{r:.1e}' for r in rel)})")
    if check["card"]["grad_err"] > GRAD_TOL:
        raise AssertionError("the gradients on the card do not match the CPU")
    fault = check["card, planted fault"]
    if fault["grad_err"] <= GRAD_TOL or fault["epoch_err"] <= tol:
        raise AssertionError("a check of phase 5 passed the planted fault")
    if check["card"]["epoch_err"] > tol or one_epoch != want_one:
        raise AssertionError("the epoch on the card does not match the CPU")

    mark("5b")
    # 5b. GVP one step against the CPU, dropout rate 0 on the copies; the
    # card once more on the plain route (use_pallas=False), a witness of the
    # card's rounding outside K5, and once more through K5 (run to run)
    quiet = without_dropout(gvp_cpu)
    quiet_plain = copy.deepcopy(quiet)
    for m in quiet_plain.modules():
        if isinstance(m, gvpgnn.GVPConv):
            m.use_pallas = False
    gvp_step = {}
    for run, net, d_, dtype, fn in (
            ("card", quiet, "cuda", torch.float32, gm.gvp_message),
            ("card again", quiet, "cuda", torch.float32, gm.gvp_message),
            ("card, plain route", quiet_plain, "cuda", torch.float32,
             gm.gvp_message),
            ("card, planted fault", quiet, "cuda", torch.float32,
             without_edge_grad),
            ("cpu f32", quiet, "cpu", torch.float32, gm.gvp_message),
            ("cpu f64", quiet, "cpu", torch.float64, gm.gvp_message)):
        with patched(gvpgnn, "gvp_message", fn):
            gvp_step[run] = first_step(net, d_, dtype, loaders[0].graphs,
                                       order[:BATCH], cast_data=True)
    gvp_check = {}
    for run in ("card", "card again", "card, plain route",
                "card, planted fault", "cpu f32"):
        g_err, flips, moved, worst = step_reading(gvp_step[run],
                                                  gvp_step["cpu f64"])
        gvp_check[run] = {"grad_err": g_err, "sign_flips": flips,
                          "step_lr": moved, "worst": worst}
    rerun = step_reading(gvp_step["card again"], gvp_step["card"])
    log(f"[train] GVP-GNN one train_step (graphs order[:{BATCH}], dropout "
        "rate 0 on these copies: the card's and the CPU's generators differ) "
        f"against the CPU float64 run, tol {GRAD_TOL:g} of each parameter's "
        "largest entry: " + ", ".join(
            f"{run} {c['grad_err']:.3e} ({c['worst']}; {c['sign_flips']} signs "
            "differ)" for run, c in gvp_check.items())
        + f"; card run to run {rerun[0]:.3e} ({rerun[3]})")
    if gvp_check["card"]["grad_err"] > GRAD_TOL:
        raise AssertionError("the GVP gradients on the card do not match the CPU")
    if gvp_check["card, planted fault"]["grad_err"] <= GRAD_TOL:
        raise AssertionError("phase 5b's check passed the planted fault")

    mark("5c")
    # 5c. whole-stack one step against the CPU; the card once more on the
    # plain stack, a witness of the card's rounding outside K6
    stack_step, stack_launches = {}, {}
    for run, d_, dtype, fn in (
            ("card", "cuda", torch.float32, es.egnn_stack),
            ("card, plain stack", "cuda", torch.float32, es.egnn_stack_plain),
            ("card, planted fault", "cuda", torch.float32, without_update_grad),
            ("cpu f32", "cpu", torch.float32, es.egnn_stack),
            ("cpu f64", "cpu", torch.float64, es.egnn_stack)):
        with patched(egnn_fused, "egnn_stack", fn):
            reset_counts()
            stack_step[run] = first_step(stack_cpu, d_, dtype,
                                         loaders[0].graphs, order[:BATCH])
            stack_launches[run] = counts()
    stack_check = {}
    for run in ("card", "card, plain stack", "card, planted fault", "cpu f32"):
        g_err, flips, moved, worst = step_reading(stack_step[run],
                                                  stack_step["cpu f64"])
        stack_check[run] = {"grad_err": g_err, "sign_flips": flips,
                            "step_lr": moved, "worst": worst}
    log("[train] EGNN whole stack one train_step (graphs order[:"
        f"{BATCH}]) against the CPU float64 run, tol {GRAD_TOL:g} of each "
        "parameter's largest entry: " + ", ".join(
            f"{run} {c['grad_err']:.3e} ({c['worst']}; {c['sign_flips']} signs "
            "differ)" for run, c in stack_check.items())
        + f"; K6 launches on the card {stack_launches['card']}")
    if stack_launches["card"] != dict({k: 0 for k in stack_launches["card"]},
                                      egnn_stack=1, egnn_stack_bwd=1,
                                      segment_sum=1):   # the embedding
        raise AssertionError(f"the stack step launched {stack_launches['card']}")
    if stack_check["card"]["grad_err"] > GRAD_TOL:
        raise AssertionError("the stack gradients on the card do not match "
                             "the CPU")
    if stack_check["card, planted fault"]["grad_err"] <= GRAD_TOL:
        raise AssertionError("phase 5c's check passed the planted fault")

    mark("5d")
    # 5d. TFN one step: at full width the card through K7/K4 against the
    # card through their plain twins; at a narrow width (a float64 CPU step
    # at full width is ~1 TFLOP) the card against the CPU in float64, with
    # a planted fault (K7's dT dropped)
    tfn_order = torch.from_numpy(np.random.default_rng(8).permutation(
        tfn_loaders[0].num_examples))
    tfn_row, tfn_train_graphs = tfn_order[:BATCH], tfn_loaders[0].graphs
    tfn_step, tfn_step_launches = {}, {}
    for run, twins in (("card", contextlib.nullcontext),
                       ("card, plain twins", plain_tfn_twins)):
        with twins():
            reset_counts()
            tfn_step[run] = first_step(tfn_cpu, "cuda", torch.float32,
                                       tfn_train_graphs, tfn_row)
            tfn_step_launches[run] = counts()
    full = step_reading(tfn_step["card"], tfn_step["card, plain twins"])
    step_want = dict({k: 0 for k in tfn_step_launches["card"]},
                     edge_contract=tfn_layers,
                     edge_contract_bwd=tfn_layers,
                     segment_sum=tfn_layers + 1)   # and the embedding's
    log(f"[train] TFN one train_step at full width (graphs order[:{BATCH}]): "
        f"K7/K4 against the plain twins on the card, gradients within "
        f"{full[0]:.3e} of each parameter's largest entry ({full[3]}; "
        f"{full[1]} signs differ; tol {K7_PLAIN_TOL:g}); launches "
        f"{tfn_step_launches['card']} (want {step_want}); plain twins launched "
        f"{tfn_step_launches['card, plain twins']}")
    if tfn_step_launches["card"] != step_want:
        raise AssertionError(f"the TFN step launched {tfn_step_launches['card']}")
    if tfn_step_launches["card, plain twins"] != dict(
            {k: 0 for k in step_want}, segment_sum=1):   # the embedding's
        raise AssertionError("the plain twins launched K7 or K4 in the convs")
    if full[0] > K7_PLAIN_TOL:
        raise AssertionError("the TFN step through K7/K4 does not match the "
                             "plain twins on the card")
    narrow_cpu = tfn_model("cpu", **TFN_NARROW)
    narrow = {}
    for run, d_, dtype, fn in (
            ("card", "cuda", torch.float32, ec.edge_weighted_contract_grouped),
            ("card, planted fault", "cuda", torch.float32, without_contract_dT),
            ("cpu f32", "cpu", torch.float32, ec.edge_weighted_contract_grouped),
            ("cpu f64", "cpu", torch.float64,
             ec.edge_weighted_contract_grouped)):
        with patched(tensor_product, "edge_weighted_contract_grouped", fn):
            narrow[run] = first_step(narrow_cpu, d_, dtype, tfn_train_graphs,
                                     tfn_row, cast_data=True)
    tfn_check = {"full_width_vs_plain_twins": full[0]}
    for run in ("card", "card, planted fault", "cpu f32"):
        g_err, flips, moved, worst = step_reading(narrow[run], narrow["cpu f64"])
        tfn_check[run] = {"grad_err": g_err, "sign_flips": flips,
                          "step_lr": moved, "worst": worst}
    log(f"[train] TFN one train_step at emb_dim {TFN_NARROW['emb_dim']}, "
        f"{TFN_NARROW['num_layers']} layers, max_ell {TFN_STAR['max_ell']} "
        f"against the CPU float64 run, tol {GRAD_TOL:g} of each parameter's "
        "largest entry: " + ", ".join(
            f"{run} {c['grad_err']:.3e} ({c['worst']}; {c['sign_flips']} signs "
            "differ)" for run, c in tfn_check.items()
            if isinstance(c, dict)))
    if tfn_check["card"]["grad_err"] > GRAD_TOL:
        raise AssertionError("the TFN gradients on the card do not match the CPU")
    if tfn_check["card, planted fault"]["grad_err"] <= GRAD_TOL:
        raise AssertionError("phase 5d's check passed the planted fault")
    del narrow, tfn_step

    mark("5e / 5f")
    # 5e / 5f. one DimeNet++ and one SphereNet step against the CPU
    triplet_check = {
        "dimenet": step_triplet("dimenet", dn_batch, card),
        "spherenet": step_triplet("spherenet", next(iter(sn_loaders[0])),
                                  card)}

    mark("5g")
    # 5g. MACE one step: at full width the card (K7/K4) against the CPU's
    # plain f32 step; at emb_dim 16 the card against the CPU in float64,
    # with a planted fault (the nu = 3 weights of the symmetric contraction
    # detached)
    mace_order = torch.from_numpy(np.random.default_rng(9).permutation(
        mace_loaders[0].num_examples))
    mace_row, mace_train_graphs = mace_order[:BATCH], mace_loaders[0].graphs
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    mace_step = {"card": first_step(mace_cpu, "cuda", torch.float32,
                                    mace_train_graphs, mace_row)}
    mace_step_launches = counts()
    mace_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t = time.perf_counter()
    mace_step["cpu f32"] = first_step(mace_cpu, "cpu", torch.float32,
                                      mace_train_graphs, mace_row)
    mace_cpu_step_s = time.perf_counter() - t
    full = step_reading(mace_step["card"], mace_step["cpu f32"])
    step_want = dict({k: 0 for k in mace_step_launches},
                     **mace_launches(mace_layers, 1, 1))
    log(f"[train] MACE one train_step at full width (graphs order[:{BATCH}]): "
        f"the card against the CPU's plain f32 step ({mace_cpu_step_s:.1f} s "
        f"on the host), gradients within {full[0]:.3e} of each parameter's "
        f"largest entry ({full[3]}; {full[1]} signs differ; tol "
        f"{K7_PLAIN_TOL:g}); launches {mace_step_launches} (want {step_want}); "
        f"peak device memory {mace_peak_gb:.2f} GB [{card}]")
    if mace_step_launches != step_want:
        raise AssertionError(f"the MACE step launched {mace_step_launches}")
    if full[0] > K7_PLAIN_TOL:
        raise AssertionError("the MACE step on the card does not match the "
                             "CPU's plain f32 step")
    narrow_cpu = mace_model("cpu", **MACE_NARROW)
    narrow = {}
    for run, d_, dtype, fn in (
            ("card", "cuda", torch.float32, _SC_WEIGHTS),
            ("card, planted fault", "cuda", torch.float32,
             weights_nu3_detached),
            ("cpu f32", "cpu", torch.float32, _SC_WEIGHTS),
            ("cpu f64", "cpu", torch.float64, _SC_WEIGHTS)):
        with patched(symmetric_contraction.SymmetricContraction, "weights",
                     fn):
            narrow[run] = first_step(narrow_cpu, d_, dtype, mace_train_graphs,
                                     mace_row, cast_data=True)
    mace_check = {"full_width_vs_cpu_f32": full[0]}
    for run in ("card", "card, planted fault", "cpu f32"):
        g_err, flips, moved, worst = step_reading(narrow[run], narrow["cpu f64"])
        mace_check[run] = {"grad_err": g_err, "sign_flips": flips,
                           "step_lr": moved, "worst": worst}
    log(f"[train] MACE one train_step at emb_dim {MACE_NARROW['emb_dim']}, "
        f"{mace_layers} layers, max_ell {MACE_STAR['max_ell']}, correlation "
        f"{MACE_STAR['correlation']} against the CPU float64 run, tol "
        f"{GRAD_TOL:g} of each parameter's largest entry: " + ", ".join(
            f"{run} {c['grad_err']:.3e} ({c['worst']}; {c['sign_flips']} signs "
            "differ)" for run, c in mace_check.items() if isinstance(c, dict)))
    if mace_check["card"]["grad_err"] > GRAD_TOL:
        raise AssertionError("the MACE gradients on the card do not match the "
                             "CPU")
    if mace_check["card, planted fault"]["grad_err"] <= GRAD_TOL:
        raise AssertionError("phase 5g's check passed the planted fault")
    del narrow, mace_step

    mark("5h")
    # 5h. one bench_scale step of each force field on a 1000-atom box
    # against the CPU in float64, with a planted fault
    ff_check = step_ff_vs_cpu(card)

    mark("6")
    # 6. train, the main path
    reset_counts()
    res = fit_regression(model, None, *loaders, n_epochs=EPOCHS, lr=LR,
                         seed=1, device="cuda")
    train_counts = counts()
    train_launches = (train_counts["egnn_message"],
                      train_counts["egnn_message_bwd"])
    if (train_counts["sorted_segment_sum"]
            or train_counts["segment_sum"] != EPOCHS * steps):
        raise AssertionError(f"star training launched K3, or K4 other than "
                             f"the embedding's gradient: {train_counts}")
    fired = fired_epochs(res.perf_per_epoch)
    want_train = (LAYERS * (EPOCHS * (steps + val_b) + fired * test_b),
                  LAYERS * EPOCHS * steps)
    graphs_per_s = EPOCHS * loaders[0].num_examples / res.train_time
    log(f"[train] fit_regression {EPOCHS} epochs: train_time "
        f"{res.train_time:.3f} s ({graphs_per_s:.0f} train graphs/s), test "
        f"MAE {res.test:.5f}, best val MAE {res.best_val:.5f}; launches K1 "
        f"{train_launches[0]}, K2 {train_launches[1]} (want {want_train}, "
        f"{fired} test passes) [{card}]")
    if train_launches != want_train:
        raise AssertionError(f"training launched {train_launches}, "
                             f"expected {want_train}")
    if not (np.isfinite(res.test) and res.test < 0.2):
        raise AssertionError(f"test MAE {res.test} is not finite and below 0.2")

    mark("6f")
    # 6f. whole-stack training, the main path
    reset_counts()
    sres = fit_regression(stack_model, None, *loaders, n_epochs=STACK_EPOCHS,
                          lr=LR, seed=1, device="cuda")
    stack_train = counts()
    sfired = fired_epochs(sres.perf_per_epoch)
    stack_train_want = dict({k: 0 for k in stack_train},
                            egnn_stack=STACK_EPOCHS * (steps + val_b)
                            + sfired * test_b,
                            egnn_stack_bwd=STACK_EPOCHS * steps,
                            segment_sum=STACK_EPOCHS * steps)   # embedding grad
    log(f"[train] EGNN whole stack fit_regression {STACK_EPOCHS} epochs: "
        f"train_time {sres.train_time:.3f} s (per layer, phase 6, {EPOCHS} "
        f"epochs: {res.train_time:.3f} s), "
        f"test MAE {sres.test:.5f} (per layer {res.test:.5f}), best val MAE "
        f"{sres.best_val:.5f}; launches {stack_train} (want K6 "
        f"{stack_train_want['egnn_stack']} forward, "
        f"{stack_train_want['egnn_stack_bwd']} backward, {sfired} test passes) "
        f"[{card}]")
    if stack_train != stack_train_want:
        raise AssertionError(f"stack training launched {stack_train}, "
                             f"expected {stack_train_want}")
    if not (np.isfinite(sres.test) and sres.test < 0.2):
        raise AssertionError(f"stack test MAE {sres.test} is not finite and "
                             "below 0.2")

    mark("6g")
    # 6g. TFN training, the star configuration's main path
    tsteps, tval_b, ttest_b = (len(ld) for ld in tfn_loaders)
    reset_counts()
    tres = fit_regression(tfn_cuda, None, *tfn_loaders, n_epochs=TFN_EPOCHS,
                          lr=LR, seed=1, device="cuda")
    tfn_train = counts()
    tfired = fired_epochs(tres.perf_per_epoch)
    tfn_calls = TFN_EPOCHS * (tsteps + tval_b) + tfired * ttest_b
    tfn_train_want = dict({k: 0 for k in tfn_train},
                          edge_contract=tfn_layers * tfn_calls,
                          edge_contract_bwd=tfn_layers * TFN_EPOCHS * tsteps,
                          segment_sum=tfn_layers * tfn_calls
                          + TFN_EPOCHS * tsteps)  # and the embedding's
    log(f"[train] TFN fit_regression {TFN_EPOCHS} epochs (fold [7], lr {LR}): "
        f"train_time {tres.train_time:.3f} s, test MAE {tres.test:.5f} (the "
        f"JAX package {TFN_JAX_MAE} +- {TFN_JAX_SD}, the reference "
        f"{TFN_REF_MAE}), best val MAE {tres.best_val:.5f}; launches "
        f"{tfn_train} (want K7 {tfn_train_want['edge_contract']} forward, "
        f"{tfn_train_want['edge_contract_bwd']} backward, K4 "
        f"{tfn_train_want['segment_sum']}; {tfired} test passes) [{card}]")
    if tfn_train != tfn_train_want:
        raise AssertionError(f"TFN training launched {tfn_train}, expected "
                             f"{tfn_train_want}")
    if not (np.isfinite(tres.test) and tres.test < TFN_MAE_MAX):
        raise AssertionError(f"TFN test MAE {tres.test} is not finite and "
                             f"below {TFN_MAE_MAX}")
    del tfn_cuda, tfn_pred
    torch.cuda.empty_cache()

    mark("6d")
    # 6d. GVP training, the main path (dropout on)
    reset_counts()
    gres = fit_regression(gvp_cuda, None, *loaders, n_epochs=GVP_EPOCHS, lr=LR,
                          seed=1, device="cuda")
    gvp_train = counts()
    gfired = fired_epochs(gres.perf_per_epoch)
    gvp_calls = GVP_EPOCHS * (steps + val_b) + gfired * test_b
    gvp_train_want = dict({k: 0 for k in gvp_train},
                          gvp_message=GVP_LAYERS * gvp_calls,
                          gvp_message_bwd=GVP_LAYERS * GVP_EPOCHS * steps,
                          # the sum pool, the embedding's gradient
                          segment_sum=gvp_calls + GVP_EPOCHS * steps)
    epoch_loss = gres.train_losses.mean(axis=1)
    y_train = np.array([np.atleast_1d(g.y)[0] for g in loaders[0].graphs])
    y_test = np.array([np.atleast_1d(g.y)[0] for g in loaders[2].graphs])
    const_mae = float(np.abs(y_test - y_train.mean()).mean())
    log(f"[train] GVP-GNN fit_regression {GVP_EPOCHS} epochs: train_time "
        f"{gres.train_time:.3f} s, test MAE {gres.test:.5f} (a constant "
        f"predictor, the train-target mean: {const_mae:.5f}), best val MAE "
        f"{gres.best_val:.5f}; mean train loss first / last epoch "
        f"{epoch_loss[0]:.4f} / {epoch_loss[-1]:.4f}; launches {gvp_train} "
        f"(want K5 {gvp_train_want['gvp_message']} forward, "
        f"{gvp_train_want['gvp_message_bwd']} backward, K4 "
        f"{gvp_train_want['segment_sum']}, "
        f"{gfired} test passes) "
        f"[{card}]")
    if gvp_train != gvp_train_want:
        raise AssertionError(f"GVP training launched {gvp_train}, expected "
                             f"{gvp_train_want}")
    if not (np.isfinite(gres.train_losses).all() and np.isfinite(gres.test)):
        raise AssertionError("a GVP training loss or the test MAE is not finite")
    if not epoch_loss[-1] < epoch_loss[0]:
        raise AssertionError("GVP training did not lower the train loss")

    mark("6b")
    # 6b. box training, against the CPU
    check_box = bench_scale.box_batch(BOX_CHECK_ATOMS, sort=True)
    f32, f64 = torch.float32, torch.float64
    box_check = {}
    for name in ("schnet_sorted", "egnn_sorted"):
        box_model = bench_scale.build(name, bench_scale.MODELS[name],
                                      torch.Generator().manual_seed(0), "cpu")
        grads = {run: box_grads(box_model, check_box, plans, d_, dtype)
                 for run, d_, dtype, plans in (
                     ("card", "cuda", f32, sss.batch_seg_plans),
                     ("card, planted fault", "cuda", f32,
                      sender_backward_on_receiver_plan),
                     ("cpu f32", "cpu", f32, sss.batch_seg_plans),
                     ("cpu f64", "cpu", f64, sss.batch_seg_plans))}
        box_check[name] = {run: grad_error(g, grads["cpu f64"])
                           for run, g in grads.items() if run != "cpu f64"}
        log(f"[box] {name} one step on a {BOX_CHECK_ATOMS}-atom sorted box "
            f"({int(check_box.edge_mask.sum())} edges), gradients against "
            f"the CPU float64 run (tol {GRAD_TOL:g} of each parameter's "
            "largest entry): " + ", ".join(
                f"{run} {e:.3e}" for run, e in box_check[name].items()))
        if box_check[name]["card"] > GRAD_TOL:
            raise AssertionError(f"{name}: the gradients on the card do not "
                                 "match the CPU")
        if box_check[name]["card, planted fault"] <= GRAD_TOL:
            raise AssertionError(f"{name}: the check of phase 6b passed the "
                                 "planted fault")

    mark("6c")
    # 6c. box training, the main path
    box_runs = {}
    for name in ("schnet_sorted", "egnn_sorted"):
        cfg = bench_scale.MODELS[name]
        box_model = bench_scale.build(name, cfg,
                                      torch.Generator().manual_seed(0), dev)
        step_fn = bench_scale.make_step(box_model, box, box_plans)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        times, losses = [], []
        for _ in range(BOX_STEPS):
            t = time.perf_counter()
            losses.append(step_fn().item())      # host read: synchronous
            times.append(time.perf_counter() - t)
        got = counts()
        per_step = bench_scale.sorted_launches_per_step(name, cfg["num_layers"])
        want = {k: 0 for k in got}
        want["sorted_segment_sum"] = BOX_STEPS * per_step
        want["segment_sum"] = 2 * BOX_STEPS   # the pool, the embedding's grad
        step_ms = statistics.median(times[1:]) * 1e3
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        box_runs[name] = {"launches": got, "step_ms": step_ms,
                          "step_times_ms": [x * 1e3 for x in times],
                          "edges_per_s": box_edges / step_ms * 1e3,
                          "peak_mem_gb": peak_gb, "losses": losses}
        log(f"[box] {name} {cfg} on the {BOX_ATOMS}-atom box: {BOX_STEPS} "
            f"steps, median {step_ms:.2f} ms per step after the first "
            f"({box_edges / step_ms * 1e3:.4g} edges/s), peak "
            f"{peak_gb:.3f} GB; losses {losses}; launches {got} (want K3 "
            f"{per_step} and K4 2 per step) [{card}]")
        if got != want:
            raise AssertionError(f"{name} launched {got}, expected {want}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"{name}: a loss is not finite")
        del box_model, step_fn
        torch.cuda.empty_cache()

    mark("6e")
    # 6e. gvp_sorted: one step against the CPU, then the main path at 100k
    cfg = bench_scale.config("gvp_sorted", BOX_CHECK_ATOMS)
    box_model = without_dropout(bench_scale.build(
        "gvp_sorted", cfg, torch.Generator().manual_seed(0), "cpu"))
    grads = {run: box_grads(box_model, check_box, plans, d_, dtype)
             for run, d_, dtype, plans in (
                 ("card", "cuda", f32, sss.batch_seg_plans),
                 ("card, planted fault", "cuda", f32,
                  sender_backward_on_receiver_plan),
                 ("cpu f32", "cpu", f32, sss.batch_seg_plans),
                 ("cpu f64", "cpu", f64, sss.batch_seg_plans))}
    box_check["gvp_sorted"] = {run: grad_error(g, grads["cpu f64"])
                               for run, g in grads.items() if run != "cpu f64"}
    log(f"[box] gvp_sorted {cfg} one step on the {BOX_CHECK_ATOMS}-atom sorted "
        "box (dropout rate 0 on these copies), gradients against the CPU "
        f"float64 run (tol {GRAD_TOL:g}): " + ", ".join(
            f"{run} {e:.3e}" for run, e in box_check["gvp_sorted"].items()))
    if box_check["gvp_sorted"]["card"] > GRAD_TOL:
        raise AssertionError("gvp_sorted: the gradients on the card do not "
                             "match the CPU")
    if box_check["gvp_sorted"]["card, planted fault"] <= GRAD_TOL:
        raise AssertionError("gvp_sorted: phase 6e's check passed the planted "
                             "fault")
    del box_model, grads
    cfg = bench_scale.config("gvp_sorted", BOX_ATOMS)
    box_model = bench_scale.build("gvp_sorted", cfg,
                                  torch.Generator().manual_seed(0), dev)
    step_fn = bench_scale.make_step(box_model, box, box_plans)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, losses = [], []
    for _ in range(BOX_STEPS):
        t = time.perf_counter()
        losses.append(step_fn().item())
        times.append(time.perf_counter() - t)
    got = counts()
    per_step = bench_scale.sorted_launches_per_step(
        "gvp_sorted", cfg["num_layers"], cfg.get("remat", False))
    want = dict({k: 0 for k in got}, sorted_segment_sum=BOX_STEPS * per_step,
                segment_sum=2 * BOX_STEPS)
    step_ms = statistics.median(times[1:]) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    box_runs["gvp_sorted"] = {"cfg": cfg, "launches": got, "step_ms": step_ms,
                              "step_times_ms": [x * 1e3 for x in times],
                              "edges_per_s": box_edges / step_ms * 1e3,
                              "peak_mem_gb": peak_gb, "losses": losses}
    log(f"[box] gvp_sorted {cfg} on the {BOX_ATOMS}-atom box: {BOX_STEPS} "
        f"steps, median {step_ms:.2f} ms per step after the first "
        f"({box_edges / step_ms * 1e3:.4g} edges/s), peak {peak_gb:.3f} GB; "
        f"losses {losses}; launches {got} (want K3 {per_step} and K4 2 per "
        f"step, no K5) [{card}]")
    if got != want:
        raise AssertionError(f"gvp_sorted launched {got}, expected {want}")
    if not np.isfinite(losses).all():
        raise AssertionError("gvp_sorted: a loss is not finite")
    del box_model, step_fn
    torch.cuda.empty_cache()

    mark("6h")
    # 6h. the plain route's segment sums are K4: two runs of one plain-route
    # egnn step on the unsorted 10k-atom box give bitwise-equal gradients
    det_box = bench_scale.box_batch(GVP_BOX_ATOMS, sort=False).to(dev)
    det_grads = []
    reset_counts()
    for _ in range(2):
        det_model = bench_scale.build("egnn", bench_scale.MODELS["egnn"],
                                      torch.Generator().manual_seed(0), dev)
        bench_scale.make_step(det_model, det_box)()
        det_grads.append({n: p.grad.clone()
                          for n, p in det_model.named_parameters()
                          if p.grad is not None})
    det_counts = counts()
    det_layers = bench_scale.MODELS["egnn"]["num_layers"]
    det_want = dict({k: 0 for k in det_counts},
                    segment_sum=2 * (3 * det_layers + 2))
    differ = [n for n, g in det_grads[0].items()
              if not torch.equal(g, det_grads[1][n])]
    log(f"[repair] plain-route egnn step on the unsorted {GVP_BOX_ATOMS}-atom "
        f"box, twice: {len(det_grads[0]) - len(differ)} of {len(det_grads[0])} "
        f"parameter gradients bitwise equal; launches {det_counts} (want K4 "
        f"{det_want['segment_sum']}: per step 3 per layer, the pool and the "
        "embedding's gradient)")
    if differ:
        raise AssertionError(f"two plain-route box steps differ at {differ}")
    if det_counts != det_want:
        raise AssertionError(f"the plain-route box steps launched {det_counts}")
    del det_box, det_model, det_grads
    torch.cuda.empty_cache()

    mark("6i / 6j")
    # 6i / 6j. DimeNet++ and SphereNet star runs, the main path
    dres, dn_train = train_triplet("dimenet", dn_loaders, DIMENET_EPOCHS,
                                   DIMENET_MAE_MAX, DIMENET_JAX_MAE,
                                   DIMENET_JAX_SD, card)
    spres, sn_train = train_triplet("spherenet", sn_loaders, SPHERENET_EPOCHS,
                                   SPHERENET_MAE_MAX, SPHERENET_JAX_MAE,
                                   SPHERENET_JAX_SD, card)

    mark("6k")
    # 6k. bench_scale's dimenet step on the 10k box; one step on a small box
    # against the CPU float64 run, chunked, with a planted fault
    small = bench_scale.box_batch(DIMENET_CHECK_ATOMS, sort=False,
                                  triplets=True)
    chunk = small.triplets.num_triplets // 3
    small_model = dimenet_mod.DimeNetPPModel(
        **dict(bench_scale.config("dimenet", DIMENET_CHECK_ATOMS),
               triplet_chunk=chunk), in_dim=8, out_dim=1,
        generator=torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    for out_block in small_model.outputs:
        dimenet_mod.glorot_orthogonal_(out_block.lin.weight, gen)
    f32, f64 = torch.float32, torch.float64
    small_grads = {"card": triplet_grads(small_model, small, "cuda", f32)}
    with patched(dimenet_mod, "ascending_plan", shifted_fold_plan):
        small_grads["card, planted fault"] = triplet_grads(small_model, small,
                                                           "cuda", f32)
    small_grads["cpu f32"] = triplet_grads(small_model, small, "cpu", f32)
    exact = triplet_grads(small_model, small, "cpu", f64)
    dimenet_box_check = {run: grad_error(g, exact)
                         for run, g in small_grads.items()}
    log(f"[box] dimenet one step on a {DIMENET_CHECK_ATOMS}-atom box "
        f"({int(small.edge_mask.sum())} edges, "
        f"{int(small.triplets.t_mask.sum())} triplets, triplet_chunk {chunk}), "
        f"gradients against the CPU float64 run (tol {GRAD_TOL:g} of each "
        "parameter's largest entry): " + ", ".join(
            f"{run} {e:.3e}" for run, e in dimenet_box_check.items()))
    if dimenet_box_check["card"] > GRAD_TOL:
        raise AssertionError("dimenet: the box step on the card does not "
                             "match the CPU")
    if dimenet_box_check["card, planted fault"] <= GRAD_TOL:
        raise AssertionError("dimenet: the box check passed the planted fault")
    dimenet_chunks = dimenet_chunk_checks(small, small_model, exact)
    del small, small_model, exact
    cfg = bench_scale.config("dimenet", DIMENET_BOX_ATOMS)
    box_model = bench_scale.build("dimenet", cfg,
                                  torch.Generator().manual_seed(0), dev)
    n_chunks = len(_chunk_slices(tri_box.triplets.num_triplets,
                                 cfg["triplet_chunk"]))
    dn_box = box_run(
        f"dimenet {cfg} on the {DIMENET_BOX_ATOMS}-atom box "
        f"({int(tri_box.triplets.t_mask.sum())} triplets, {n_chunks} chunks)",
        box_model, tri_box,
        bench_scale.dimenet_launches_per_step(cfg, tri_box), BOX_STEPS, card)
    dn_box.update(chunks=n_chunks,
                  triplets=int(tri_box.triplets.t_mask.sum()))
    del box_model, tri_box
    torch.cuda.empty_cache()

    mark("6o")
    # 6o. DimeNet++ at 100k atoms under the 100k rule
    plain100 = bench_scale.box_batch(BOX_ATOMS, sort=False)
    dn_100k = dimenet_box_100k(plain100, dev, card)
    torch.cuda.empty_cache()

    mark("6p")
    # 6p. SphereNet: a small box against float64, then the 10k box's quads
    sn_box = spherenet_box_phases(dev, card)
    torch.cuda.empty_cache()

    mark("6q")
    # 6q. egnn_fused at box scale: K1 and K2 at 1.35M edges
    fused_box = fused_box_phases(plain100, dev, card)
    del plain100
    torch.cuda.empty_cache()

    mark("6l")
    # 6l. MACE star run, the main path: the protocol of the JAX package's
    # number (run_experiment_reg's first repeat: weights and shuffle from
    # seed 0; lr 5e-4, cosine; 100 epochs, the JAX number's 200 cut)
    msteps, mval_b, mtest_b = (len(ld) for ld in mace_loaders)
    reset_counts()
    mres = fit_regression(mace_cuda, None, *mace_loaders,
                          n_epochs=MACE_STAR_EPOCHS, lr=MACE_LR, cosine=True,
                          seed=0, device="cuda")
    mace_train = counts()
    mfired = fired_epochs(mres.perf_per_epoch)
    mace_train_want = dict({k: 0 for k in mace_train}, **mace_launches(
        mace_layers,
        MACE_STAR_EPOCHS * (msteps + mval_b) + mfired * mtest_b,
        MACE_STAR_EPOCHS * msteps))
    log(f"[train] MACE fit_regression {MACE_STAR_EPOCHS} epochs (fold [7], "
        f"{mace_n} graphs, lr {MACE_LR}, cosine): train_time "
        f"{mres.train_time:.3f} s, test MAE {mres.test:.5f} (the JAX package "
        f"{MACE_JAX_MAE} +- {MACE_JAX_SD}), best val MAE {mres.best_val:.5f}; "
        f"launches {mace_train} (want {mace_train_want}; {mfired} test "
        f"passes) [{card}]")
    if mace_train != mace_train_want:
        raise AssertionError(f"MACE training launched {mace_train}, expected "
                             f"{mace_train_want}")
    if not (np.isfinite(mres.test) and mres.test < MACE_MAE_MAX):
        raise AssertionError(f"MACE test MAE {mres.test} is not finite and "
                             f"below {MACE_MAE_MAX}")
    del mace_cuda
    torch.cuda.empty_cache()

    mark("6n")
    # 6n. the force-field box, the main path
    ff_runs = train_ff_box(ff_box, dev, card)
    del ff_box

    mark("6m")
    # 6m. the expressivity table on the card
    t = time.perf_counter()
    expressivity = expressivity_table(dev, card)
    expressivity_s = time.perf_counter() - t

    mark("7a-7d")
    # 7a-7d. the regression CLI and its training options
    with tempfile.TemporaryDirectory() as tmp:
        cli_runs = cli_phases(dev, card, tmp)

    # 8a-8c. the teaching path
    with tempfile.TemporaryDirectory() as tmp:
        teach = teaching_phases(dev, card, tmp)

    mark("9a-9e")
    # 9a-9e. the data-parallel path: two gloo ranks sharing the card
    dp = dp_phases(card)

    mark("10")
    # 10. summary
    kernels = [{
        "name": "egnn_message", "ok": True, "route": "cuda",
        "source": "geometric_message_passing_tpu_torch/csrc/egnn_message.cu",
        "replaces": "geometric_message_passing_tpu/ops/pallas_edge.py:134",
        "launches": train_launches[0], "serve_launches": launches,
        "box_launches": {"egnn_fused 100k box, per step":
                         fused_box["box_100k"]["launches"]["egnn_message"]
                         // BOX_STEPS},
        "max_abs_err": err, "max_err": err,
        "ms": k_ms, "call_ms": call_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
    }, {
        "name": "egnn_message_bwd", "ok": True, "route": "cuda",
        "source": "geometric_message_passing_tpu_torch/csrc/egnn_message_bwd.cu",
        "replaces": "geometric_message_passing_tpu/ops/pallas_edge.py:246",
        "launches": train_launches[1], "max_abs_err": bwd_err,
        "box_launches": {"egnn_fused 100k box, per step":
                         fused_box["box_100k"]["launches"]["egnn_message_bwd"]
                         // BOX_STEPS},
        "max_abs_err_n10k": bwd_err_large, "ms": bk_ms, "call_ms": bcall_ms,
        "plain_ms": bp_ms, "bound_ms": bb_ms, "bound_by": bb_by,
        "library_ms": None, "split_ms": k2_split["train bucket"],
        "n10k": dict(ms=bk_ms_large, call_ms=bcall_ms_large,
                     plain_ms=bp_ms_large, bound_ms=bb_ms_large,
                     split_ms=k2_split["N=10k"]),
    }]
    k5 = k5_times["train bucket"]
    for name, direction, replaces, launched, errs in (
            ("gvp_message", "fwd", "geometric_message_passing_tpu/ops/pallas_gvp.py:115",
             gvp_train["gvp_message"], dict(max_abs_err=k5_err)),
            ("gvp_message_bwd", "bwd",
             "geometric_message_passing_tpu/ops/pallas_gvp.py:144",
             gvp_train["gvp_message_bwd"],
             dict(max_abs_err=k5_bwd_err, max_abs_err_10k_box=k5_bwd_err_box))):
        kernels.append({
            "name": name, "ok": True, "route": "cuda",
            "source": "geometric_message_passing_tpu_torch/csrc/"
                      f"{name}.cu",
            "replaces": replaces, "launches": launched,
            "serve_launches": gvp_serve[name], **errs,
            **k5[direction], "library_ms": None,
            "box_10k": k5_times["10k box"][direction]})
    k6 = k6_times["train bucket"]
    for name, direction, replaces, errs in (
            ("egnn_stack", "fwd",
             "geometric_message_passing_tpu/ops/pallas_egnn_stack.py:105",
             dict(max_abs_err=k6_err)),
            ("egnn_stack_bwd", "bwd",
             "geometric_message_passing_tpu/ops/pallas_egnn_stack.py:132",
             dict(max_abs_err=k6_bwd_err, max_abs_err_10k_box=k6_bwd_err_box))):
        kernels.append({
            "name": name, "ok": True, "route": "cuda",
            "source": f"geometric_message_passing_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": stack_train[name],
            "serve_launches": stack_serve[name], **errs, **k6[direction],
            "library_ms": None, "tile": k6["tile"],
            "box_10k": dict(k6_times["10k box"][direction],
                            tile=k6_times["10k box"]["tile"]),
            "tile_cases": {label: dict(r[direction], tile=r["tile"])
                           for label, r in k6_times.items()
                           if label.startswith("tile")}})
    # K3 at the box's receiver plan, D 128 (messages, h gathers); K4 at the
    # shuffled box, D 128; its launches are the TFN run's (phase 6g)
    for name, readings, main_shape, replaces, launched in (
            ("sorted_segment_sum", k3, "box rcv plan D128",
             "geometric_message_passing_tpu/ops/pallas_sorted_segsum.py:114",
             sum(r["launches"]["sorted_segment_sum"] for r in box_runs.values())),
            ("segment_sum", k4, "K4 shuffled box D128",
             "geometric_message_passing_tpu/ops/pallas_edge.py:50",
             tfn_train["segment_sum"])):
        top = next(r for r in readings if r["shape"] == main_shape)
        kernels.append({
            "name": name, "ok": True, "route": "cuda",
            "source": "geometric_message_passing_tpu_torch/csrc/sorted_segsum.cu",
            "replaces": replaces, "launches": launched, "on_main_path": True,
            "max_abs_err": max(r["max_abs_err"] for r in readings),
            **{k: top[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms",
                                   "segment_reduce_ms")},
            "shapes": readings,
            # the triplet models' main paths (phases 6i, 6j): K3 is their
            # fold, K4 their edge -> node sums and pools
            "triplet_launches": {"dimenet": dn_train[name],
                                 "spherenet": sn_train[name]},
            # the box rows (6k, 6o, 6p), per step
            "triplet_box_launches": {
                "dimenet 10k": dn_box["launches"][name] // BOX_STEPS,
                "dimenet 100k": dn_100k["launches"][name] // 2,
                "spherenet 10k": sn_box["box_10k"]["launches"][name] // 2,
                **({"egnn_fused 100k": fused_box["box_100k"]["launches"][name]
                    // BOX_STEPS} if name == "segment_sum" else {})},
            **({"teaching_launches": {
                "per train step": {k: r["launches"]["segment_sum"]
                                   for k, r in teach["8a"].items()},
                "8b FinalMPNN 40 epochs": teach["8b"]["k4_launches"],
                "8c qm9_pipeline": teach["8c"]["k4_launches"]}}
               if name == "segment_sum" else {}),
            "mace_launches": {"serve": mace_serve[name],
                              "train_step": mace_step_launches[name],
                              "train": mace_train[name]},
            "star_shapes": [r for r in star_segsum
                            if (r["kind"] == "fold") == (name == "sorted_segment_sum")],
            **({"triplet_fold": k3_fold} if name == "sorted_segment_sum"
               else {"force_field": {
                   "mace_ff_serve_launches": mff_serve["launches"][name],
                   "box_step_launches": {
                       n: r["launches"][name] // BOX_STEPS
                       for n, r in ff_runs.items()},
                   "shapes": ff_segsum}})})
    # K7: one hidden layer's five groups in one launch at the TFN train
    # bucket; beside it layer 0, bf16 W and each group in a launch of its own
    for name, direction, replaces in (
            ("edge_contract", "fwd",
             "geometric_message_passing_tpu/ops/pallas_tp.py:62"),
            ("edge_contract_bwd", "bwd",
             "geometric_message_passing_tpu/ops/pallas_tp.py:77")):
        kernels.append({
            "name": name, "ok": True, "route": "cuda",
            "source": "geometric_message_passing_tpu_torch/csrc/edge_contract.cu",
            "replaces": replaces, "launches": tfn_train[name],
            "serve_launches": tfn_serve[name], "max_abs_err": k7_err,
            "shape": f"hidden layer, 5 groups in one launch, E {tfn_e}",
            **k7_grouped["hidden"][direction],
            "layer_0": k7_grouped["layer 0"][direction],
            "hidden_bf16_W": k7_grouped["hidden bf16 W"][direction],
            "per_group_launches": {"hidden": k7_layer["hidden"][direction],
                                   "layer_0": k7_layer["layer 0"][direction]},
            "groups": [dict(r[direction], K=r["K"], m=r["m"], w=r["w"])
                       for r in k7_groups["hidden"]],
            "bf16_group": k7_bf16[direction],
            "group_3_grouped": {name: r[direction] for name, r in k7_g3.items()},
            "mace": {"launches": mace_train[name],
                     "serve_launches": mace_serve[name],
                     "train_step_launches": mace_step_launches[name],
                     "layer_0": k7_mace["MACE layer 0"][direction],
                     "hidden": k7_mace["MACE hidden"][direction]}})
    for k in kernels:      # the data-parallel runs, counters read per rank
        key = DP_KERNELS.get(k["name"])
        if key is not None:
            k["dp_launches"] = {part: [r[key] for r in dp[part]]
                                for part in ("9a", "9b", "9c", "9e")}
            k["dp_launches"]["9d rank 0"] = dp["9d"][key]
    for k in kernels:      # the CLI's runs, counters read per run
        k["cli_launches"] = {
            **{f"7a {label}": r["launches"].get(k["name"], 0)
               for label, r in cli_runs["7a"].items()},
            "7d": cli_runs["7d"]["launches"].get(k["name"], 0)}
    log(json.dumps({"kernels": kernels, "card": card,
                    "predict_ms": ms, "predict_graphs_per_s": N_GRAPHS / ms * 1e3,
                    "host_batch_ms": host_ms, "train_time_s": res.train_time,
                    "train_epochs": EPOCHS, "test_mae": res.test,
                    "best_val_mae": res.best_val, "train_check": check,
                    "train_check_epoch_tol": tol, "box_check": box_check,
                    "box_train": box_runs, "gvp_predict_ms": gvp_ms,
                    "gvp_train_time_s": gres.train_time,
                    "gvp_train_epochs": GVP_EPOCHS, "gvp_test_mae": gres.test,
                    "gvp_constant_test_mae": const_mae,
                    "gvp_epoch_loss_first_last": [float(epoch_loss[0]),
                                                  float(epoch_loss[-1])],
                    "gvp_train_check": gvp_check,
                    "stack_predict_ms": stack_ms,
                    "stack_train_time_s": sres.train_time,
                    "stack_train_epochs": STACK_EPOCHS,
                    "stack_test_mae": sres.test,
                    "stack_best_val_mae": sres.best_val,
                    "stack_train_check": stack_check,
                    "tfn_predict_ms": tfn_ms, "tfn_serve_err": tfn_serve_err,
                    "tfn_train_time_s": tres.train_time,
                    "tfn_train_epochs": TFN_EPOCHS, "tfn_test_mae": tres.test,
                    "tfn_best_val_mae": tres.best_val,
                    "tfn_train_check": tfn_check,
                    "triplet_serve": triplet_serve,
                    "triplet_train_check": triplet_check,
                    "dimenet_train_time_s": dres.train_time,
                    "dimenet_train_epochs": DIMENET_EPOCHS,
                    "dimenet_test_mae": dres.test,
                    "dimenet_best_val_mae": dres.best_val,
                    "spherenet_train_time_s": spres.train_time,
                    "spherenet_train_epochs": SPHERENET_EPOCHS,
                    "spherenet_test_mae": spres.test,
                    "spherenet_best_val_mae": spres.best_val,
                    "dimenet_box_check": dimenet_box_check,
                    "dimenet_box": dn_box,
                    "dimenet_chunk_checks": dimenet_chunks,
                    "dimenet_100k": dn_100k, "spherenet_box": sn_box,
                    "fused_box": fused_box,
                    "mace_edge_weight_bytes": mace_w_bytes,
                    "mace_predict_ms": mace_ms,
                    "mace_serve_err": mace_serve_err,
                    "mace_step_peak_gb": mace_peak_gb,
                    "mace_train_check": mace_check,
                    "mace_train_time_s": mres.train_time,
                    "mace_train_epochs": MACE_STAR_EPOCHS,
                    "mace_test_mae": mres.test,
                    "mace_best_val_mae": mres.best_val,
                    "mace_ff_serve": mff_serve,
                    "ff_train_check": ff_check, "ff_box": ff_runs,
                    "expressivity": expressivity,
                    "expressivity_s": expressivity_s, "cli": cli_runs,
                    "teaching": teach, "data_parallel": dp["readings"],
                    "phase_start_s": PHASE_START}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
