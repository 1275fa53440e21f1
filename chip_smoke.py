#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``sgp_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

It drives five paths of the port on 5,016 synthetic nodes (data and random
weights from a seed): SGP serving on the exact 100-nn graph,
``OnlineForecaster`` with the BSR propagation operator at the widths of
``configs/largescale_100nn/sgp_pv.yaml``; GatedGN training on the 100-nn
graph, ``Predictor`` fed by ``WindowedLoader`` at the widths of
``configs/largescale_100nn/gatedgn_pv.yaml``; GatedGN training on the
full similarity graph at the PV-US full-graph density (14.75%) through the
dense all-pairs aggregation, at the widths of
``configs/largescale/gatedgn_pv.yaml``; and block-sparse graph attention
(``bsr_multi_head_attention``) on both graphs, beside the dense
``TransformerModel`` trained through ``Predictor``; and the SGP main path,
the large-scale runner's streaming encode, packed IID training and fused
evaluation at the ``sgp_pv.yaml`` widths, and the runner itself; and the
baseline runners (``exp/run_traffic_baselines.py``,
``exp/run_largescale_baselines.py``) from their command lines, reaching K4
and K3; and the diffusion baselines, DCRNN and GraphWaveNet trained through
K1 under DiffConv's hops, and the runners on them and on the LSTM; and
the traffic SGP runner (``exp/run_traffic_sgp.py``) at the widths of
``configs/traffic/sgp_la.yaml`` on 207 nodes, with its loader-side
supports through K1 on the 100-nn graph; and the large-scale runner's
stratified trainer on half of PV-US's year (4,434 steps) with K1 under its
in-step supports, and its trial search; and DynGESN, the graph echo-state
encoder with K1 under its recurrence, the closed-form runner
(``exp/run_closed_form.py``) and its online forecaster, beside the
wavefront reservoir scan and ``Predictor``'s bf16 steps and restartable
state; and the forecaster export (``torch.export`` with K1 as the custom
op ``sgp::bsr_spmm`` inside the loaded programs) and the imputation runner
(GRIN with K1 under its diffusion hops, the RNN imputers); and the rest of
the model zoo, STCN and RNN-enc/GCN-dec with K1 under their GraphConvs and
the graph recurrent cells, beside the residual-whiteness monitor; and the
dataset loaders' host parsers (no pandas, no h5py), the correntropy and
Pearson similarities at PV-US's and CER-En's widths on the card, and
CER-En's 100-nn graph into K1 under the sgp_cer.yaml encode; and the host
graph core (``sgp_tpu_torch/native``), the runner under the supervisor, the
trial search, the timers and traces and the roofline's floors; and
node-sharded SGP over ``torch.distributed`` (the halo K-hop with K1 on each
rank's blocks, the sharded encode, IID step and eval, the runner's
``--data-sharding nodes``) on 1, 2 and 4 ranks; and data-parallel training
for the other runners (the sharded stratified step and its eval with K1
under the supports, the window step, ``Predictor(mesh=)`` with K4 under
GatedGN) on 1 and 2 ranks; and the rest of the multi-device port (the
two-level (host, chip) halo exchange with K1 on each rank's tiles, the
scaling model's measured routes, the multi-rank dry run with tensor
parallelism, checkpoint and resume over ranks) on 2 and 4 ranks. In
phases; any failure raises and the exit code
is not 0:

0. the card: ``nvidia-smi`` name and power limit, versions, TF32 off;
1. build the four kernels, one ``nvcc`` each, in parallel
   (``sgp_tpu_torch/csrc/bsr_spmm.cu``, ``gn_ell.cu``, ``gn_allpairs.cu``,
   ``sddmm.cu``), then start one process for each width of the library
   yardstick (torch's Triton BSR product, ``LIBRARY_WIDTHS``) compiling it
   into ``build/triton_cache`` at the lowest CPU priority beside phases
   2-10 (phase 2's library call comes after phase 10);
2. the BSR kernel against its plain PyTorch version on the card, after
   ``ptxas``'s registers and spills of each instantiation (a spill fails),
   at the slice's shapes (F 16, 64, 128, 512) and on ragged /
   empty-block-row graphs (F 200, 1), f32 and bf16, with the mean error
   beside the max, a second call held to the first one's bits, and
   CUDA-event times of both; then its backward (``BSROperator @ x`` with x
   and the tiles needing gradients: K1 on the transposed structure, K2 for
   the tiles) against the plain versions, launches counted;
3. the serving slice: warm-up, single-stream and 4-stream steps through the
   BSR kernel, checked for shape, finiteness and launch counts, and held
   against a dense-operator forecaster with the same weights and against
   the port on the CPU (2 steps after the last 64 of the history, served
   anew on both devices);
4. the GatedGN ELL kernel, forward and backward, against its plain version
   at the training slice's shapes and on a ragged case, f32 and bf16, after
   ``ptxas``'s registers and spills of each instantiation (a spill fails),
   with the forward's mean error beside the max (the f32 slice's must stay
   within 1e-7 of the largest output) and CUDA-event times of both;
5. the training slice: train steps and ``evaluate`` through the ELL kernel,
   checked for launch counts and finite losses, held against the same
   steps with the plain ELL math on the card and one step of the port on
   the CPU; then step times (median and quartiles) and peak memory of the
   K4 and plain steps in alternating rounds, and the device's idle share
   of each;
6. the GatedGN all-pairs kernel, forward and backward, against its plain
   version on the full graph in natural order (a full sweep), RCM-ordered
   with per-block band windows, and on a ragged case with an asymmetric
   mask, f32 and bf16, with CUDA-event times of both, after ``ptxas``'s
   registers and spills of each backward instantiation;
7. the full-graph training slice: train steps and ``evaluate`` through the
   all-pairs kernel, checked for launch counts and finite losses, held
   against the same steps with the blocked plain all-pairs math on the card
   and a first step of the port on the CPU (on fewer nodes at the same
   density); then step times, peak memory and idle share of the K3 and
   plain steps;
8. the SDDMM kernel (K2) against its plain version on the 100-nn graph in
   natural and RCM order (D 64 and 16) and on a ragged 1,001-node graph
   with an empty block row (D 40), f32 and bf16, after ``ptxas``'s
   registers and spills of each instantiation (phase 1; a spill fails),
   with the mean error (the f32 rows' within 1e-7 of the largest output),
   two calls held to the same bits, CUDA-event times, the bound, one cuBLAS
   ``torch.bmm`` on pre-gathered tiles beside it, and at the main shape the
   library call ``torch.sparse.sampled_addmm``;
9. the attention path: ``bsr_multi_head_attention`` (K2, masked softmax,
   K1) at H 1 x D 64 and H 4 x D 16 on the 100-nn graph (natural and RCM)
   and the full graph, held against the edge-list
   ``sparse_multi_head_attention`` on the card and, on the ragged graph,
   the port on the CPU, forward and backward (the SDDMM's through K1);
   times and peak memory of both forms;
10. ``TransformerModel`` at the runner's defaults (hidden 64, ff 128, one
   layer and head over time) trained through ``Predictor`` on phase 5's
   data: train steps and ``evaluate`` with finite losses, the first step
   against the port on the CPU, step times and peak memory;
11. the SGP main path on T 640: ``streaming_encode`` through the BSR
   kernel (chunks of 64 steps, so each hop is one K1 call at F 8,192; its
   launches counted) emitting the packed IID rows, held against the same
   encode through the dense operator, against the port on the CPU (16
   steps in chunks of 8) and its target and mask lanes against a numpy
   reference bit for bit; K1 at that width against its plain version,
   cuSPARSE's BSR product and the dense operator's matmul, with the bound;
   ``make_fused_iid_multi_step`` (4 calls of 32 steps at batch 4,096, the
   last under torch.profiler; the first step on fixed draws against the
   CPU port), ``make_fused_eval`` on the test split (4 batches against the
   CPU port); then ``run_experiment`` on ``--config
   largescale_100nn/sgp_pv.yaml --dataset-name synthetic`` for 4 epochs,
   as parsed (``auto``: the dense operator at this size), with
   ``operator_mode = "bsr"`` set on the parsed namespace, untrained
   (``--epochs 0``) and with 1e-5 of the dense encoding's bf16 features one
   ulp off, at seed 0 (seed 1 cut for the time limit): finite metrics
   below the untrained model's, K1's launches on the BSR route only, and
   the routes' test-MAE gap printed beside the one-ulp witness's;
12. the baseline runners through ``Experiment(...).run(argv)`` at the
   configs' widths, only epochs and batches cut (``RUNNER_CASES``): (a) the
   traffic runner on ``largescale_100nn/gatedgn_pv.yaml`` with the ELL
   table (K4 forward and backward), f32 and ``--compute-dtype bfloat16``;
   (b) the large-scale runner on that config (subgraph batches of 627
   roots, k 2, padded to 2,508 nodes and 501,600 edges, trained on their
   edge lists; K4's forward in evaluation); (c) the large-scale runner on
   ``largescale/gatedgn_pv.yaml`` with the whole similarity graph
   (25,155,240 edges; subgraphs capped at 2,500,000 edges; K3's forward in
   evaluation). Each run: its kernels' launches (counters set to 0 just
   before it), finite test metrics below the same run's untrained ones
   (``--epochs 0``), the first step held against the port on the CPU
   (run (a)'s, f32 and bf16, on a 1,001-node set of the same command), the
   train loader's host ms a batch, step times, peak memory and a
   profile's idle share; then K3's forward at run (c)'s evaluation shape
   (25.2 M pairs) against its plain version, with its bound;
13. the diffusion baselines on phase 5's data: ``DCRNNModel`` at
   ``largescale_100nn/dcrnn_pv.yaml``'s widths and ``GraphWaveNetModel`` at
   ``gwnet_pv.yaml``'s, trained through ``Predictor`` with the runner's
   call, once on BSR supports (``diff_conv_support(operator_mode="bsr")``:
   K1 forward and backward) and once on dense ones from the same weights,
   batches and dropout draws: K1's launches a train step and an evaluate
   batch held to the count from the code (0 on the dense route), the
   routes held to each other (forward with its mean signed error, first
   gradients, losses, evaluation, final weights), the first step against
   the port on the CPU (a ragged 1,001-node set at k 100, dropout 0; a
   gradient beyond its tolerance only where at most 4 of the decoder's
   relu units, each within rounding of 0, turn the other way, and the
   masked MAE's signs that the two runs take the other way are counted
   beside them), step
   times, peak memory and idle share of both routes; K1 at F 256 and 2,304
   against its plain version with the bound, cuSPARSE and the dense
   matmul; then the runners from their command lines
   (``DIFF_RUNNER_CASES``: DCRNN on full-graph windows, DCRNN and
   GraphWaveNet on subgraph batches, the LSTM of ``traffic/rnn.yaml``),
   each below its untrained run, its first step against the CPU port on a
   1,001-node set;
14. the traffic SGP runner from its command line (``--config
   traffic/sgp_la.yaml --dataset-name synthetic``; every cut is in the
   ``LA_*`` and ``SUPPORT_*`` constants): (a) on 207 nodes (METR-LA's
   width) and 8,640 steps (30 days; METR-LA has 34,272), 3 of the yaml's
   200 epochs: the first step against the port on the CPU (40 nodes, 400
   steps, dropout off, the card's window starts), the encode's wall and
   the encoding's bytes (kept on the card), batch/s of the fused training
   calls at batch 64, synchronized step times, device busy and idle share
   (torch.profiler), peak memory and the test MAE beside the same command
   untrained; then ``online_sgp``, ``esn``, ``--sgp-preprocessing true``,
   ``--iid-sampling true`` and ``--fused false`` on 14 days, each below
   its untrained run; (b) ``build_support_operators(...,
   operator_mode="bsr")`` on phase 5's data and 100-nn graph (receptive
   field 2, bidirectional, the global mean: 5 supports of 1,600 tiles)
   through ``SGPLoader`` batches, 3 ``make_fused_window_step`` steps and
   the fused evaluation, held against the dense supports (the same
   weights, window starts and dropout draws): K1's launches equal to the
   count from the code (0 on the dense route), the batches within 1e-4 of
   the largest value with a mean signed error within 1e-7, the losses and
   metrics within 1e-4; each support against float64; then K1 at that F
   (64 x 768 = 49,152) against its plain version, the bound, cuSPARSE and
   the dense matmul;
15. the large-scale runner's stratified trainer and trial search
   (``--config largescale_100nn/sgp_pv.yaml --dataset-name synthetic``;
   every cut is in the ``STRAT_*`` and ``SEARCH_*`` constants): first the
   stratified route's first step against the port on the CPU (300 nodes,
   400 steps, dropout off, the card's draws); (a) ``--iid-stratified
   true`` on 5,016 nodes x 4,434 steps (half of PV-US's year of 8,868,
   for the script's time limit; the synthetic set is
   made once and kept for the phase), 8 of the yaml's 12,897 epochs, the
   dense supports (``auto``): the reservoir encode's wall and the
   resident bf16 embedding's bytes, batch/s of the training calls at
   batch 4,096 (32 times x 128 nodes), synchronized step times, device
   busy and idle share (torch.profiler), peak memory beside the precompute
   path's estimate, the test MAE beside the same command untrained; (b)
   the run's embedding, weights and draws through the supports built with
   ``operator_mode="bsr"`` against the dense ones (the f32 hops within
   1e-5 with the mean signed error, the bf16 features within one ulp, the
   first loss within 1e-4, K1's launches counted), K1 at the step's F
   4,096 and the evaluation's F 2,048 against its plain version, the
   bound, cuSPARSE and the dense matmul, then the runner with
   ``operator_mode = "bsr"`` on the namespace for 2 epochs (K1's launches
   equal to the count from the code, 0 on the dense route, the test MAE
   below the untrained run's); (c) ``--search-lr 0.001,0.0001
   --search-seeds 0,1`` at phase 11's size (T 640), 4 epochs: the best
   trial below the same search untrained, trial-batch/s beside the
   single-trial batch/s of the same command, and calls of the single and
   the trial steps in f32 and with ``compute_dtype=torch.bfloat16``, in
   turns;
16. DynGESN and the rest of A7 (every cut is in the ``GESN_*`` and
   ``PRED_STEPS`` constants): (a) ``GESNEncoder`` at
   ``configs/traffic/gesn_la.yaml``'s widths (3 layers x 320 units) on
   phase 5's series and the closed-form runner's graph (similarity
   threshold 0.1: 3,332,132 edges, every block stored), f32: through K1
   (``operator_mode="bsr"``; one launch a layer-step, T x L = 1,920)
   against the dense operator, both against the same scan in float64,
   the first 16 steps against the port on the CPU, two calls held to the
   same bits; K1 at F 320 against its plain version, the bound, cuSPARSE
   and the dense matmul; (b) ``exp/run_closed_form.py`` through
   ``Experiment(...).run(argv)`` on that config: the host route on 207
   nodes x 1,152 steps on the card and on the CPU port, each also with
   every ridge solve in float64 (the card's test MAE held to the CPU's
   within max(1e-4 relative, 3 x the larger f32-vs-float64 gap)), then
   ``--device-resident true`` on 5,016 nodes x 640 steps, dense and with
   ``operator_mode = "bsr"`` on the namespace (K1's launches T x L):
   encode, Gram and solve, evaluation, peak memory, finite metrics; (c)
   ``OnlineGESNForecaster`` on that graph over BSR, 1 and 4 streams: the
   warm-up and 8 steps held to the offline encode and the stacked
   readouts (and the 4 streams to 4 forecasters), K1's launches a step,
   step latency quartiles; (d) ``reservoir_scan(mode="wavefront")``
   against the sequential scan on phase 11's input at sgp_pv.yaml's
   reservoir (8 x 16), both walls and each scan's device activities a
   step; (e) ``Predictor(compute_dtype="bfloat16")`` against f32 on phase
   5's GatedGN slice (K4): step ms, peak memory, the first loss against
   the CPU port (2e-2), then ``save_state``, a new ``Predictor``,
   ``load_state`` and two steps against the uninterrupted run;
17. the forecaster export and the imputation slice (every cut is in the
   ``EXPORT_*``, ``GRIN_*`` and ``IMP_*`` constants): (a)
   ``export_forecaster`` / ``load_forecaster`` of ``OnlineForecaster`` at
   sgp_pv.yaml's widths on the 100-nn graph (BSR) and of
   ``OnlineGESNForecaster`` at gesn_la.yaml's widths on the runner's graph
   (BSR; readouts drawn from the seed), 1 and 4 streams each: 50 steps of
   the loaded program against the live forecaster (1e-5 of the largest
   forecast), both step latencies, K1's launches inside the loaded program
   (more than 0 a step), the artifact's bytes; (b) GRIN at its published
   widths (hidden 64, ff 64, window 24; batch 32 unless the reckoned peak
   forces a cut, printed) on phase 5's series: one train step on BSR
   supports (K1 under every hop, forward and backward) against the dense
   supports from the same weights and whitening mask (the loss within
   1e-5, every gradient within 1e-4 of its parameter's largest), K1's
   launches (2 x 24 x 10 forward), steps in turns with peak memory, a
   profiled step's device busy and idle share, K1 at the cell's and the
   other hops' widths against its plain version, the bound, cuSPARSE and
   the dense matmul; (c) ``exp/run_imputation.py`` through
   ``Experiment(...).run(argv)`` for ``grin``, ``rnni`` and ``birnni`` on
   5,016 nodes x 640 steps, one epoch of 2 batches: test metrics, ms a
   batch, peak memory.
18. the rest of the model zoo on phase 5's data and graph (every cut is in
   the ``ZOO_*`` and ``MON_*`` constants), at the traffic runner's default
   widths (hidden 64, ff 128, one layer, temporal kernel 2, dropout 0) and
   ``configs/traffic/dcrnn.yaml``'s data flags (window 12, horizon 12,
   batch 64): the repo has no STCN config. (a) ``STCNModel`` and (b)
   ``RNNEncGCNDecModel``: one ``Predictor`` step on the row-normalized
   100-nn operator as ``BSROperator`` (K1 forward and, transposed,
   backward under each GraphConv: F 49,152 and 4,096) against the dense
   operator from the same weights and batch (the loss within 1e-5, every
   gradient within 1e-4 of its parameter's largest), K1's launches
   counted, steps in turns with peak memory, a profiled step's device busy
   and idle share; (c) ``GraphConvRNN`` with GRU and LSTM cells over the
   12 steps on BSR against dense, forward only (T x gates launches); (d)
   K1 at F 49,152 and 4,096 against its plain version, the bound,
   cuSPARSE and the dense matmul; (e) ``exp/run_traffic_baselines.py``
   through ``Experiment(...).run(argv)`` for ``stcn`` and ``rnn2gcn``
   (``auto``: the dense operator), one epoch of 2 batches: test metrics,
   ms a batch, peak memory; (f) ``ResidualWhitenessMonitor`` (window 64)
   fed phase 3's ``OnlineForecaster``'s one-step residuals over 64 steps:
   ``update``'s ms beside the forecaster's step, the last window's
   statistic against the CPU port's (1e-9 relative);
19. the datasets, on seeded inputs (no raw file of the datasets is in the
   repository; every cut is in the ``PV_*``, ``CER_*``, ``LA_*``,
   ``SIM_CUT_*`` constants): (a) ``build_distance_matrix`` on METR-LA's
   207 sensors, ``read_cer_archives`` (``build_cer_en``'s parse, up to
   the arrays) on six zip archives (cut to 40 meters x 14 days each; a
   meter in two archives, a duplicated row, slot codes 0/49/50, a code
   one archive lacks), and
   ``ExchangeBenchmark`` on a full-size table, then neither pandas nor
   h5py in ``sys.modules`` (the ``.h5`` routes need h5py, which the card's
   machine lacks: the CPU tests hold them); (b) PV-US's distance
   similarity on the host against the same float64 formula on the card,
   the correntropy at PV-US's 5,016 x 105,120 (period 2,016) and CER-En's
   6,435 x 25,728 (period 336, ~1% missing, masked), CUDA-event times,
   each against float64 on the card and the CPU port at 512 nodes x 8
   windows (1e-5), CER-En's float64 Pearson against the CPU port and
   numpy at the cut; (c) ``CEREn.get_connectivity(method="correntropy",
   knn=100)`` on (b)'s arrays, the sgp_cer.yaml encode over it (128
   steps) on K1's route against the dense route with K1's launches
   counted, then K1 at N 6,435 (2,601 tiles), F 128 and 6,144, f32 and
   bf16, against its plain version (max and mean error, two calls' bits,
   times, the bound, the torch sparse BSR product, the dense matmul); (d)
   ``power_iteration_spectral_radius`` on a 1,024-unit reservoir matrix
   against LAPACK, ``masked_pinball`` and ``MinMaxScaler`` on card tensors
   against the CPU port;
20. the host graph core and the tooling (the ``phase 20`` constants; at
   most ~90 s, its wall printed): (a) ``add_self_loops`` and
   ``to_undirected`` of the 100-nn graph, whose ``coalesce`` takes the
   native route, against the numpy branch (same edges, weights within
   f32's summation bound), and ``k_hop_subgraph`` as runner (c)'s
   subgraph loader calls it on its 25,155,240-edge similarity graph
   against a plain numpy BFS, the host ms of each; (b) ``supervise`` over
   a worker running the large-scale runner at sgp_pv.yaml's widths on
   5,016 nodes x 320 steps (T cut from 640, 4 epochs) on
   ``operator_mode="bsr"``, a checkpoint every epoch, killed by
   ``SGP_TPU_FAULT`` at epoch 2 and resumed, K1's launches counted in the
   child; (c) ``run_search`` over two learning rates, at 1 worker in this
   process and at 2 with a process a trial, whose trials at the yaml's lr
   are uninterrupted runs of (b)'s command: (b)'s recovered test MAE must
   equal them bit for bit; (d) ``time_fn`` and ``StepTimer`` beside
   CUDA-event times of K1 at F 128 and 8,192, and ``profile_trace`` of
   one two-hop encode chunk naming K1 as often as it launched; (e) the
   random 1 KiB-row gather beside the roofline's ``ROW_GATHER_LAT_S``, K1
   per stored block at F 128 on ``bench.py::section_bsr``'s N 40,960
   banded graph, and K1's bound (``roofline.bsr_spmm_bound``, never above
   K1's time) at that shape and the 100-nn graph's F 128 and 8,192;
21. node-sharded SGP (``sgp_tpu_torch/parallel``; the ``SHARD_*`` and
   ``BAND_*`` constants; at most 150 s, its wall printed), each world
   started by ``parallel/launch.py::run_ranks``: (a)-(d) on 2 gloo ranks
   sharing the card (NCCL refuses two ranks on one GPU; gloo's collectives
   on CUDA tensors are probed first, and one it refuses fails): (a) the
   halo K-hop (k 2) in ``mode="bsr"`` on the 100-nn graph, K1 under each
   rank's block, at depths 1 and 2 and the f32, bf16 and int8 wire
   formats, against the single-device dense operator's hops (f32 within
   1e-5 of the largest value, the wire formats within 2e-2 and 8e-2), K1's
   launches in each rank's run, the exchange's ms a hop and bytes, then
   K1 on shard 0's tiles against its plain version with the bound and the
   dense matmul of the block; (c) ``encode_series_sharded`` at
   sgp_pv.yaml's widths on 128 steps against ``streaming_encode``; (d) one
   sharded IID step (batch 4,096, each rank its own draws) against the
   single-device step on the union of the draws, the replicas' weights
   bit for bit, timed steps, and the sharded eval against the fused one;
   (b) the N 40,960 band graph on 4 gloo ranks, where ``auto`` picks
   ``bsr``; (e) ``run_largescale_sgp --data-sharding nodes`` on one NCCL
   rank against the unsharded runner from the same seed. Each rank's peak
   memory is printed.
22. data-parallel training (the ``DP_*`` constants; at most 90 s, its wall
   printed): in one spawn of 2 gloo ranks sharing the card, (a) the
   sharded stratified step at sgp_pv.yaml's widths (batch 4,096 = 32
   shared starts x 64 nodes a rank; the reservoir's 128-wide embedding of
   phase 11's data, T cut to 160) on BSR supports (K1 under them) and on
   dense ones, each against the single-device step on the union of the
   draws (the loss, the weights beyond the gradient floor, the replicas'
   bits, K1's launches), steps timed; (b) the sharded eval with the
   supports and the global mean against ``make_fused_eval``; (d) the window
   step at sgp_la.yaml's widths (batch 64, 32 a rank; 9 BSR supports on a
   207-node set) against the single-device step; (e) ``run_traffic_baselines
   --data-sharding batch`` at ``traffic/gatedgn_la.yaml`` on the ELL table
   (K4 at 8 windows a rank) against the same command on one process, and
   GraphWaveNet (2 layers) through ``Predictor(mesh=)`` with its batch
   statistics summed over the ranks against one process; then K1 at the
   step's F 4,096 and the evaluation's F 2,048 and K4 at the runner's
   per-rank shape against their plain versions, with the bound and the
   library call; (c) ``run_largescale_sgp --iid-stratified true
   --data-sharding nodes`` and (d) ``run_traffic_sgp --data-sharding
   batch`` (``--sgp-preprocessing true`` on K1's route) on one NCCL rank,
   each bit for bit the unsharded runner.
23. the rest of the multi-device port (the ``HIER_*`` and ``RESUME_*``
   constants; at most 90 s, its wall printed): in one spawn of 4 gloo
   ranks sharing the card as (host 2, chip 2), (1) the two-level halo
   K-hop (k 2) in ``mode="bsr"`` on the 100-nn graph at F 1,024, K1
   under each rank's block, at depths 1 and 2 and the f32, bf16 and int8
   wire formats, against the single-device dense operator's hops (f32
   within 1e-5 of the largest value, the wire formats within 2e-2 and
   8e-2) and against the flat exchange of the same plan on the same ranks
   (the recv buffers at every slot a halo entry reads: the same bits; the
   K-hops within 1e-5, since the halo blocks' ``index_add_`` sums in the
   order of the card's atomics: the flat K-hop run twice differs as much),
   K1's launches in each rank's two-level run, then K1 on
   shard 0's tiles against its plain version with the bound, torch's BSR
   product and the dense matmul of the block; (2) the flat and two-level
   exchanges' ms a hop and bytes (``b_intra``, ``b_cross``,
   ``dcn_bytes_per_hop``): gloo's on one card, not NVLink's; (3)
   ``obs/scaling.py::propagation_scaling`` on 2 and 4 ranks (``bsr``, F
   128); (4) the dry run (``exp/dryrun.py``: the deep halo, a DP + TP
   decoder step, the node-sharded IID step packed and unpacked, the
   stratified step, the eval, the window step, the two-level K-hop bit
   for bit the flat one); then (5) ``run_largescale_sgp --data-sharding
   nodes --checkpoint-every 1`` on 2 gloo ranks killed at epoch 2 by its
   fault hook, resumed, against the uninterrupted run: test metrics and
   weights bit for bit on both ranks.

Each kernel's bound is the largest of three times (NVIDIA's data sheet,
SXM part, the rates read from ``sgp_tpu_torch/obs/roofline.py``, K1's
count too): its bytes (each input read once, each output written once) over
the H100's 3.35 TB/s; its f32-accurate products by the cheaper route, FFMA
at 67 TFLOP/s or 3xTF32 at 495 / 3 TFLOP/s; its transcendentals over 16 a
clock per SM at the SM clock ``nvidia-smi`` reports.

The line before the last is a JSON object of the kernels (K4's launches
from run (a), K3 forward's from run (c), each slice's own count beside
them; K1's ``diffconv`` sub-entry from phase 13, its ``support``
sub-entry from phase 14, its ``stratified`` sub-entry, with the
evaluation's width under ``eval``, from phase 15; its ``gesn``
sub-entry, F 320, from phase 16; its ``export`` sub-entry, launches
inside the loaded artifacts, and ``grin`` sub-entry, GRIN's hop widths,
from phase 17; its ``stcn`` sub-entry, F 49,152, with the GCN decoder's F
4,096 under ``rnn2gcn``, from phase 18; its ``cer`` sub-entry, N 6,435,
F 6,144, from phase 19; its ``halo`` sub-entry, K1 on a shard's tiles
at F 1,024, from phase 21; its ``stratified_dp`` sub-entry, F 4,096 a
rank, with the sharded evaluation's F 2,048 under ``eval``, from phase 22;
its ``halo_hier`` sub-entry, K1 on a shard's tiles under the two-level
exchange at F 1,024, from phase 23;
K4's ``dp`` sub-entries, 8 windows a rank, from phase 22); the last is
``{"ok":
true, "device": {...}}``. Without a CUDA
device it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# the card's rates (H100 SXM: 3.35 TB/s, FFMA 67 TFLOP/s, TF32 495 TFLOP/s
# dense) from the port's one source of them
from sgp_tpu_torch.obs import roofline
from sgp_tpu_torch.obs.roofline import (FFMA_FLOPS, HBM_BYTES_PER_S,
                                        TF32_FLOPS)

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "largescale_100nn" / "sgp_pv.yaml"
N_NODES = 5016
KNN = 100
N_STEPS = 640           # synthetic series length
WARMUP = 576            # history replayed through the scan
STEPS = 16              # single-stream serving steps
STREAMS = 4
STREAM_STEPS = 4
STREAM_OFFSET = 8       # stream s sees the series shifted by s * 8 steps
CPU_STEPS = 2           # steps also run by the port on the CPU,
CPU_WARMUP = 64         # after this many steps of history on both devices
SEED = 0

# stated tolerances (relative to the reference's max |value|)
TOL_F32 = 1e-5          # kernel vs plain, f32 tiles: order of summation
TOL_BF16 = 1e-2         # kernel vs plain, bf16 tiles: one bf16 ulp (2^-8)
                        # after a different f32 summation order
TOL_K1_BIAS = 1e-7      # K1's, K2's and K4 forward's mean f32 error at the
                        # slice, of the largest output
TOL_SLICE = 1e-4        # BSR-kernel forecaster vs dense / CPU forecaster

GN_CONFIG = ROOT / "configs" / "largescale_100nn" / "gatedgn_pv.yaml"
FULL_CONFIG = ROOT / "configs" / "largescale" / "gatedgn_pv.yaml"
FULL_DENSITY = 0.1475   # PV-US full graph (paper Table 3)
BAND_BLOCK = 256        # dst rows per window (the runners' auto_band)
MUFU_PER_CLOCK_SM = 16      # transcendentals (ex2, rcp) a clock per SM
GRAD_CLIP = 5.0         # the runners' default (exp/common.py)
TRAIN_STEPS = 8         # train steps of each training run
EVAL_BATCHES = 2        # test batches of evaluate
PROFILE_STEPS = 2       # train steps under torch.profiler
KERNEL_ROUNDS = 5       # K4 timing rounds (plain, kernel, kernel, plain)
TIME_ORDER = ("plain", "k4", "k4", "plain", "plain", "k4")  # step timing
TIME_STEPS = 12         # train steps of each timing round
TIME_DROP = 2           # first steps of a round left out of the times
# stated tolerances of the ELL kernel, relative to the plain version's
# largest value: f32 2e-5 (the same f32 products summed in another order,
# over up to 2.5 M pairs for the weight gradients); bf16 inputs 2e-2 (both
# round t and dmt to bf16, so a value rounded the other way moves a result
# by one bf16 ulp, 2^-8)
TOL_GN_F32 = 2e-5
TOL_GN_BF16 = 2e-2
TOL_LOSS = 1e-4         # K4 run vs plain-ELL run and vs the CPU port
TOL_GRAD = 1e-4         # first step's clipped gradients, card vs CPU,
                        # relative to each tensor's largest value
TOL_ZERO_GRAD = 1e-5    # a gradient that is 0 in exact arithmetic, on the
                        # card and the CPU, relative to the model's largest
                        # gradient: rounding noise of sums over ~1e6 terms
# K4 run vs plain-ELL run, final parameters, max abs difference on the
# elements whose first-step gradient exceeds GRAD_FLOOR in magnitude. An
# Adam step moves an element by about lr = 1e-3 whatever its gradient's
# size, so an element whose first gradient is near zero may step the other
# way when the sums run in another order; the rest differ only by the
# gradients' rounding. 1e-4 is a tenth of one step: one step taken the
# other way, or a gradient off by a tenth, breaks it.
TOL_PARAM = 1e-4
GRAD_FLOOR = 1e-6
# the all-pairs kernel against its plain version, relative to the plain
# version's largest value: f32 2e-5 (the same f32 products summed in another
# order, over up to 5,016 pairs a row and 3.7 M pairs for the weight
# gradients); bf16 inputs 2e-2 (both round t, ghat and dmt at the same
# places, so a value rounded the other way moves a result by one bf16 ulp)
TOL_AP_F32 = 2e-5
TOL_AP_BF16 = 2e-2
AP_ROUNDS = 3           # K3 timing rounds at the slice's f32 shapes
AP_PLAIN_ITERS = 2      # plain launches a timing sample (~0.1 s each)
CPU_NODES = 1500        # phase 7's CPU step: fewer nodes, same density
RAGGED_NODES = 1001     # phase 6's ragged case: N no multiple of anything
FULL_TIME_ORDER = ("plain", "k3", "k3", "plain")  # phase 7 step timing
FULL_TIME_STEPS = 5
# K2 against its plain version, relative to the plain version's largest
# value: f32 TOL_F32 (the same f32 products summed over D in another
# order); bf16 inputs 2e-2 (both multiply the bf16 values exactly in f32;
# the bound leaves room for one bf16 ulp, 2^-8)
TOL_SDDMM_BF16 = 2e-2
# block-sparse attention against the edge-list form on the card, max abs
# difference: the JAX package's own test tolerance (tests/test_sddmm.py)
TOL_ATT = 1e-4
ATT_HEADS = ((1, 64), (4, 16))   # H x D of the attention path
ATT_ITERS = 5                    # launches a timing sample of either form
# phase 11, the SGP main path at the sgp_pv.yaml widths
SGP_CHUNK = 64          # the runner's streaming-encode chunk (F 8,192)
SGP_CPU_STEPS = 16      # encode steps also run by the port on the CPU
SGP_CPU_CHUNK = 8       # ... in chunks of 8 (F 1,024)
SGP_CALLS = 4           # multi-step calls of the fused IID trainer
SGP_STEPS_PER_CALL = 32  # the yaml's batches_epoch
SGP_EVAL_BATCHES = 4    # test batches of 16 also run on the CPU
SGP_RUNNER_EPOCHS = 4
# one seed: the script's time limit (seed 1 cut when phase 18 took the
# whole script past ~950 s; seeds 0-2 ran before, see PERF.md)
SGP_RUNNER_SEEDS = (0,)
# the share of bf16 features that the dense and BSR routes round the other
# way (16,539 of 1.64e9: this script on an NVIDIA H100 80GB HBM3, seed 0);
# the runner's test MAE turns on it, so the routes' MAE gap is printed
# beside that of the dense route with this share moved by one ulp, and no
# limit holds it (the encode checks hold the BSR route)
SGP_FLIP_SHARE = 1e-5
TOL_EVAL = 1e-4         # fused eval, card vs CPU port, relative
# phase 12, the baseline runners through their entry points at the configs'
# widths; only epochs and batches cut
RUNNER_ARGS = ["--model-name", "gatedgn", "--dataset-name", "synthetic",
               "--synthetic-nodes", str(N_NODES), "--synthetic-steps",
               str(N_STEPS), "--seed", str(SEED)]
ELL_RUN = ["--gn-aggregation", "ell", "--epochs", "2", "--batches-epoch",
           "8"]
# (tag, runner, config, flags, the kernels its run must launch)
RUNNER_CASES = (
    ("a", "traffic", GN_CONFIG, ["--adj-knn", "100"] + ELL_RUN,
     ("gn_ell_fwd", "gn_ell_bwd")),
    ("a bf16", "traffic", GN_CONFIG,
     ["--adj-knn", "100", "--compute-dtype", "bfloat16"] + ELL_RUN,
     ("gn_ell_fwd", "gn_ell_bwd")),
    ("b", "largescale", GN_CONFIG, ELL_RUN, ("gn_ell_fwd",)),
    ("c", "largescale", FULL_CONFIG,
     ["--gn-aggregation", "dense", "--epochs", "2", "--batches-epoch", "2"],
     ("gn_allpairs_fwd",)))
RUNNER_TIME_DROP = 2    # first steps of a run left out of its step times
# runs whose first step the CPU port takes on a smaller set (the same
# command at this many nodes): the full-graph ELL step at 5,016 nodes took
# the host 9-12 s, f32 and bf16, a fifth of phase 12
RUNNER_CPU_NODES = {"a": 1001, "a bf16": 1001}
# a run's first step, card vs CPU port: the loss within TOL_LOSS (bf16:
# 2e-2, one bf16 ulp is 2^-8), each clipped gradient within TOL_GRAD (bf16:
# 2e-2) of its largest value, or else no further from a reference step
# than RUNNER_SLACK times the CPU port's distance from it, plus TOL_GRAD.
# The reference: for a bf16 run the f32 run's first step on the card (the
# same weights and batch; bf16 moves the gradients 1-7% of a tensor's
# largest from it on either device: 600 nodes on the CPU), for a run that
# trains on edge lists the same step in float64 on the CPU
TOL_RUNNER_BF16 = 2e-2
RUNNER_SLACK = 2.0
# phase 13, the diffusion baselines at the configs' widths; only epochs and
# batches cut
DCRNN_CONFIG = ROOT / "configs" / "largescale_100nn" / "dcrnn_pv.yaml"
GWNET_CONFIG = ROOT / "configs" / "largescale_100nn" / "gwnet_pv.yaml"
RNN_CONFIG = ROOT / "configs" / "traffic" / "rnn.yaml"
DIFF_STEPS = 4          # train steps of each support route's run
DIFF_TIME_ORDER = ("dense", "bsr", "bsr", "dense")   # step timing rounds
DIFF_TIME_STEPS = 4     # steps a round (the first TIME_DROP left out)
DIFF_CPU_NODES = 1001   # the CPU first step's ragged set, at k = KNN
DIFF_WIDTHS = (256, 2304)   # K1's F under DCRNN's and GraphWaveNet's hops
# BSR route (K1, 3xTF32 products) vs dense route (an f32 matmul) from the
# same weights, batches and dropout draws, relative to the largest value:
# the forward, the first step's gradients, the losses and the evaluation.
# f32 sums in another order through 36 recurrent steps (DCRNN) or 8 layers
# and a batch norm (GraphWaveNet), then 4 Adam steps: 1e-4, and the
# forward's mean signed error within 1e-6 (a bias the max would hide). A
# gradient under ZERO_GRAD of the model's largest is 0 in exact arithmetic
# and is held relative to the model's largest gradient instead.
TOL_ROUTE = 1e-4
TOL_ROUTE_BIAS = 1e-6
ZERO_GRAD = 1e-6
# the decoder's relu units, each within the runs' rounding of 0, that a
# first step on the card may turn the other way from the CPU's (phase 13:
# GraphWaveNet's first step at 1,001 nodes had one at 2.2e-7, which moved
# emb_src's gradient 1.5e-2 of its largest value, on an NVIDIA H100)
KINK_UNITS = 4
DIFF_RUN = ["--epochs", "2", "--batches-epoch", "4"]
# (tag, runner, config, flags): the diffusion runners on phase 5's
# synthetic set; the RNN's traffic config has no graph of its own, so the
# run builds the 100-nn one (the model reads none)
DIFF_RUNNER_CASES = (
    ("dcrnn traffic", "traffic", DCRNN_CONFIG,
     ["--model-name", "dcrnn", "--adj-knn", str(KNN)] + DIFF_RUN),
    ("dcrnn large", "largescale", DCRNN_CONFIG,
     ["--model-name", "dcrnn"] + DIFF_RUN),
    ("gwnet large", "largescale", GWNET_CONFIG,
     ["--model-name", "gwnet"] + DIFF_RUN),
    ("rnn", "traffic", RNN_CONFIG,
     ["--model-name", "rnn", "--adj-knn", str(KNN)] + DIFF_RUN))


# phase 14, the traffic SGP runner at configs/traffic/sgp_la.yaml's widths
# (reservoir 64 x 2, receptive field 4, bidirectional, global_attr: 1,280
# features a node; decoder hidden 960, MLP 256 x 2, resnet, dropout 0.3;
# batch 64, 300 batches an epoch) on a synthetic set at METR-LA's width
LA_CONFIG = ROOT / "configs" / "traffic" / "sgp_la.yaml"
LA_NODES = 207          # METR-LA's sensors
LA_STEPS = 8640         # 30 days of 5-minute readings (METR-LA: 34,272)
LA_EPOCHS = 3           # of the yaml's 200
LA_TIME_STEPS = 24      # synchronized steps timed after the run
LA_ROUTE_STEPS = 4032   # the other routes' series: 14 days
LA_ROUTE_RUN = ["--epochs", "2", "--batches-epoch", "100"]
LA_ROUTES = (("online_sgp", ["--model-name", "online_sgp"]),
             ("esn", ["--model-name", "esn"]),
             ("sgp_preprocessing", ["--sgp-preprocessing", "true"]),
             ("iid_sampling", ["--iid-sampling", "true"]),
             ("fused_false", ["--fused", "false"]))
LA_CPU_NODES = 40       # the first step against the CPU port: 40 nodes,
LA_CPU_STEPS = 400      # 400 steps, dropout off on both devices
# (b): the loader-side supports through K1 on phase 5's 100-nn graph. The
# receptive field is cut from 4 to 2 (A, A^2, A', A'^2 and the 1/N graph):
# the 100-nn graph already fills all 1,600 block positions, so a higher
# power costs K1 no more, and A^3, A^4 would cost the host minutes of
# scipy products. F = batch 64 x window 1 x 768 features (6 x 128)
SUPPORT_K = 2
SUPPORT_STEPS = 3       # fused window steps of each support route
SUPPORT_EVAL_BATCHES = 2
SUPPORT_CHUNK = 4096    # columns a call of K1's plain version (its
                        # [nnzb, 128, F] temporaries: 3.4 GB a chunk)
# phase 15, the large-scale runner's stratified trainer and trial search at
# sgp_pv.yaml's widths (reservoir 16 x 8 layers: Ht 128; receptive field 2
# and the global mean: 512 features a row; decoder hidden 960, MLP 256 x 2,
# resnet, embedding 32; batch 4,096 as 32 times x 128 nodes, 32 batches a
# call) on 5,016 synthetic nodes and the 100-nn graph
STRAT_STEPS = 4434      # half of PV-US's year of 8,868 (its raw files are
                        # not in the repo): the script's time limit
STRAT_EPOCHS = 8        # of the yaml's 12,897: 256 steps
STRAT_BSR_EPOCHS = 2    # the BSR route's run from the command line
STRAT_TIME_STEPS = 12   # synchronized steps timed after the run
STRAT_CPU_NODES = 300   # the first step against the CPU port: 300 nodes,
STRAT_CPU_STEPS = 400   # 400 steps, dropout off
STRAT_FLIP_SHARE = 1e-3  # bf16 features the routes may round the other way
SEARCH_LRS = "0.001,0.0001"  # (c): 2 lr x 2 seeds at phase 11's T 640
SEARCH_SEEDS = "0,1"
SEARCH_EPOCHS = 4
SEARCH_ROUNDS = 2       # (f32, bf16, bf16, f32) rounds of timed calls
GESN_CONFIG = ROOT / "configs" / "traffic" / "gesn_la.yaml"
GESN_CPU_STEPS = 16     # (a) encode steps also run by the port on the CPU
GESN_LA_STEPS = 1152    # (b) the host route's series at 207 nodes: 4 days
TOL_CF = 1e-4           # (b) card vs CPU port test MAE, relative floor
GESN_FIT_STEPS = 64     # (c) offline steps the serving readouts fit on
GESN_SERVE_WARM = 56    # (c) history replayed before the held steps
GESN_SERVE_STEPS = 8    # (c) steps held to the offline encode
GESN_SERVE_TIMED = 24   # (c) further steps timed
PRED_STEPS = 6          # (e) steps a round of each Predictor


def read_flat_yaml(path: Path) -> dict:
    """A config through the port's flat reader (the card's machine has no
    PyYAML)."""
    from sgp_tpu_torch.exp.common import load_config
    return load_config(str(path))


def rel_err(got: torch.Tensor, ref: torch.Tensor):
    got, ref = got.float(), ref.float()
    abs_err = (got - ref).abs().max().item()
    return abs_err, abs_err / max(ref.abs().max().item(), 1e-30)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def quartiles(v) -> dict:
    v = np.asarray(v, dtype=float)
    return {"median": float(np.median(v)), "q1": float(np.quantile(v, .25)),
            "q3": float(np.quantile(v, .75)), "n": int(v.size)}


def interleaved_ms(kernel, plain, rounds: int, iters: int,
                   plain_iters: int = None):
    """CUDA-event ms of ``kernel`` and ``plain``, sampled in the order
    plain, kernel, kernel, plain ``rounds`` times: their quartiles."""
    samples = {kernel: [], plain: []}
    n_iters = {kernel: iters, plain: plain_iters or iters}
    for _ in range(rounds):
        for fn in (plain, kernel, kernel, plain):
            samples[fn].append(cuda_ms(fn, n_iters[fn], warmup=2))
    return quartiles(samples[kernel]), quartiles(samples[plain])


MUFU_RATE = None   # transcendentals a second: set by phase 0 from the card


def bound(nbytes: float, products: float, ffma: float = 0.0,
          mufu: float = 0.0) -> dict:
    """The least time the card could take, the largest of its pipes' times:
    bytes over the memory rate; the f32-accurate matrix products by the
    cheaper route, FFMA at 67 TFLOP/s or 3xTF32 at 495 / 3 TFLOP/s on the
    tensor cores (with the elementwise ``ffma`` work on the FMA pipe
    beside them); the transcendentals over 16 a clock per SM at the card's
    SM clock. ``bound_by`` is bytes or operations; ``bound_pipe`` names the
    pipe."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_tensor = max(products * 3 / TF32_FLOPS, ffma / FFMA_FLOPS)
    t_ffma = (products + ffma) / FFMA_FLOPS
    t_mufu = mufu / MUFU_RATE
    times = {"bytes": t_bytes,
             "tensor" if t_tensor < t_ffma else "fma": min(t_tensor, t_ffma),
             "mufu": t_mufu}
    pipe = max(times, key=times.get)
    return {"bound_ms": times[pipe] * 1e3,
            "bound_by": "bytes" if pipe == "bytes" else "operations",
            "bound_pipe": pipe, "bytes": nbytes, "flops": products + ffma,
            "mufu_ops": mufu}


def k1_bound(op, x) -> dict:
    """K1's bound as ``bound`` gives it, from the port's one count of K1's
    work (``roofline.bsr_spmm_bound``): the tiles, their indices and x read
    once, the f32 output written once, 2 FLOP per stored nonzero and column
    of x."""
    b = roofline.bsr_spmm_bound(
        op.blocks.shape[0], op.row_ptr.numel() - 1, x.shape[1],
        block=op.blocks.shape[-1], blk_itemsize=op.blocks.element_size(),
        x_itemsize=x.element_size(), n=x.shape[0],
        nonzeros=int((op.blocks != 0).sum()))
    return bound(b.bytes, b.flops)


def gated_chain_work(pairs: int, h2: int, h: int) -> dict:
    """The gated chain's work per direction, as ``bound``'s arguments: the
    w2 product a pair forward, and the recompute, dt and dw2 backward (the
    matrix products); the gate's sums on the FMA pipe (one forward, three
    backward: the gate, dgz, dwg); a sigmoid (an ex2 and a reciprocal) per
    channel of s and of mt and for the gate, in each direction."""
    prod, gate, mufu = 2 * h2 * h, 2 * h, 2 * (h2 + h + 1)
    return {"fwd": (pairs * prod, pairs * gate, pairs * mufu),
            "bwd": (3 * pairs * prod, 3 * pairs * gate, pairs * mufu)}


def phase0_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this test runs only on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip()
    print(f"[phase 0] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    global MUFU_RATE
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    MUFU_RATE = MUFU_PER_CLOCK_SM * sms * clock_mhz * 1e6
    print(f"[phase 0] {sms} SMs at a maximum SM clock of {clock_mhz:.0f} MHz: "
          f"{MUFU_RATE:.4g} transcendentals a second")
    import sgp_tpu_torch  # noqa: F401  (sets the TF32 flags)
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on"
    assert not torch.backends.cudnn.allow_tf32, "TF32 cuDNN is on"
    print("[phase 0] TF32 off in matmul and cuDNN")
    return smi


BUILD_LOGS = {}   # nvcc's output of each source built by phase 1
# torch's BSR product, the library yardstick beside K1 (``library_bsr``,
# ``k1_at_support_width``, ``k1_cer_row``), JIT-compiles a Triton kernel
# for each F it meets: ~20 s of host time each on the card's machine, the
# number of block rows aside. Once nvcc is done, phase 1 starts one
# process a width at the lowest CPU priority, each compiling into
# TRITON_CACHE, where this process's calls find them, beside phases 2-10
# (phase 2's library call waits until after phase 10); each call waits
# for its width's process (``library_ready``). They run on 4 block rows
# of zero tiles (16 tiles: the kernel takes the index lengths'
# divisibility by 16 from the 100-nn graph's 1,600; 3 rows, 9 tiles, for
# CER-En's 2,601), so the card barely sees them
LIBRARY_WIDTHS = (
    (128, 4),           # phase 2's slice row
    (8192, 4),          # phase 11's encode hop
    (256, 4), (2304, 4),    # phase 13's DiffConv hops
    (49152, 4),         # phase 14's supports, phase 18's STCN hop
    (4096, 4), (2048, 4),   # phase 15's stratified step and evaluation
    (320, 4),           # phase 16's GESN hop
    (1056, 4), (1024, 4),   # phase 17's GRIN hops
    (6144, 3))          # phase 19's hop on CER-En's graph
TRITON_CACHE = ROOT / "build" / "triton_cache"
LIBRARY_WARM = """
import sys, torch
f, nb = int(sys.argv[1]), int(sys.argv[2])
n = nb * 128
a = torch.sparse_bsr_tensor(
    torch.arange(0, nb * nb + 1, nb, dtype=torch.int32, device="cuda"),
    torch.arange(nb, dtype=torch.int32, device="cuda").repeat(nb),
    torch.zeros((nb * nb, 128, 128), device="cuda"), size=(n, n))
a @ torch.zeros((n, f), device="cuda")
torch.cuda.synchronize()
"""
LIBRARY_PROCS = {}   # F -> the process compiling torch's BSR product at F


def start_library_warm():
    """One process a width of LIBRARY_WIDTHS at the lowest CPU priority,
    compiling torch's Triton BSR product into TRITON_CACHE, which this
    process reads too."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(TRITON_CACHE))
    for f, nb in LIBRARY_WIDTHS:
        LIBRARY_PROCS[f] = subprocess.Popen(
            ["nice", "-n", "19", sys.executable, "-c", LIBRARY_WARM, str(f),
             str(nb)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def library_ready(f: int):
    """Wait for the process compiling torch's BSR product at width ``f``
    (none: nothing to wait for); one that failed raises with its error
    output."""
    proc = LIBRARY_PROCS.pop(f, None)
    if proc is None:
        return
    t0 = time.perf_counter()
    err = proc.communicate()[1]
    assert proc.returncode == 0, \
        f"torch's BSR product did not compile at F {f}: {err[-2000:]}"
    print(f"[library] torch's BSR product compiled at F {f} by its "
          f"process (waited {time.perf_counter() - t0:.1f} s)")


def stop_library_warm():
    """End every warm-up process still running (the script failed first,
    or a width went unused)."""
    while LIBRARY_PROCS:
        proc = LIBRARY_PROCS.popitem()[1]
        proc.kill()
        proc.communicate()


def ptxas_report(source: str, kernel: str):
    """``(kernel <template arguments>, registers, spill line)`` of each
    instantiation of ``kernel`` in ``source``'s build log: ``<activation,
    dtype>`` for K3 and K4, ``<dtype, BN>`` for K1, ``<dtype>`` for K2."""
    acts = ("silu", "tanh", "relu", "elu")
    dt = {"f": "f32", "13__nv_bfloat16": "bf16"}
    out, name, spill = [], None, ""
    for ln in BUILD_LOGS.get(source, "").splitlines():
        m = re.search(kernel + r"ILi(\d)E(f|13__nv_bfloat16)", ln)
        k1 = re.search(kernel + r"I(f|13__nv_bfloat16)Li(\d+)E", ln)
        k2 = re.search(kernel + r"I(f|13__nv_bfloat16)E", ln)
        if "Compiling entry function" in ln:
            name = (f"{kernel}<{acts[int(m.group(1))]}, {dt[m.group(2)]}>"
                    if m else f"{kernel}<{dt[k1.group(1)]}, {k1.group(2)}>"
                    if k1 else f"{kernel}<{dt[k2.group(1)]}>" if k2
                    else None)
        elif name and "spill" in ln:
            spill = ln.strip()
        elif name and "registers" in ln:
            out.append((name, ln.split("Used")[1].split(",")[0].strip(),
                        spill))
            name = None
    return out


def spilling(tag: str, source: str, *kernels) -> list:
    """Print ptxas's registers and spills of each instantiation of
    ``kernels`` in ``source``'s build log; return those that spill."""
    spills = []
    for kernel in kernels:
        for name, regs, spill in ptxas_report(source, kernel):
            print(f"[{tag}] ptxas {name}: {regs}; {spill}")
            if not spill.startswith("0 bytes stack frame, 0 bytes spill"):
                spills.append(name)
    print(f"[{tag}] {source} instantiations that spill: {spills or 'none'}"
          + ("" if BUILD_LOGS.get(source) else " (not rebuilt here)"))
    return spills


# The kernels' medians at the main path's f32 shapes as PERF.md's kernel
# table records them from this script's run after K1's redesign and before
# K4's forward moved onto the tensor-core tile (NVIDIA H100 80GB HBM3,
# 700.00 W). Printed beside this run's; compare within one run only.
RECORDED_MS = {"bsr_spmm": {"": 0.1904}, "bsr_sddmm": {"": 0.1382},
               "gn_ell": {"fwd": 0.8391, "bwd": 1.1736},
               "gn_allpairs": {"fwd": 0.7232, "bwd": 3.0078},
               # K1 at the SGP encode's F 8,192 (phase 11's first run)
               "bsr_spmm_encode": {"": 10.2367}}


def beside_recorded(tag: str, source: str, row: dict):
    for half, ms in RECORDED_MS[source].items():
        key = f"{half}_ms" if half else "ms"
        print(f"[{tag}] {source} {half or 'kernel'}: {row[key]:.4f} ms in "
              f"this run, {ms:.4f} ms recorded (PERF.md)")


def phase1_build():
    from sgp_tpu_torch.ops import _build, bsr_kernel, gn_allpairs, gn_ell, \
        sddmm
    t0 = time.perf_counter()
    built = _build.compile_all(["bsr_spmm", "gn_ell", "gn_allpairs",
                                "sddmm"])
    print(f"[phase 1] built {sorted(built) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.2f} s, one nvcc each in parallel")
    start_library_warm()
    print(f"[phase 1] started {len(LIBRARY_WIDTHS)} processes compiling "
          f"torch's BSR product, one a width")
    for name, (seconds, log) in built.items():
        BUILD_LOGS[name] = log
        print(f"[phase 1] nvcc {name}.cu: {seconds:.2f} s")
        kernel = ""
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                kernel = ln.split("'")[1]
            elif "registers" in ln or "spill" in ln:
                print(f"[phase 1]   {kernel}: {ln.strip()}")
    bsr_kernel.build()
    gn_ell.build()
    gn_allpairs.build()
    sddmm.build()
    spills = spilling("phase 1", "sddmm", "sddmm_kernel")
    assert not spills, f"K2 spills registers: {spills}"


def slice_setup(n_nodes: int, n_steps: int, device):
    """Dataset, graph and scaler of the slice."""
    from sgp_tpu_torch.data import RobustScaler
    from sgp_tpu_torch.data.datasets import SyntheticDiffusion
    t0 = time.perf_counter()
    ds = SyntheticDiffusion(num_nodes=n_nodes, num_steps=n_steps, seed=SEED)
    graph = ds.get_connectivity(knn=min(KNN, n_nodes - 1), threshold=None,
                                include_self=False)
    scaler = RobustScaler(axis=(0, 1), quantile_range=(10., 90.)).fit(
        ds.target[:WARMUP], mask=ds.mask[:WARMUP])
    print(f"[setup] SyntheticDiffusion({n_nodes}, {n_steps}) and its "
          f"{KNN}-nn graph ({graph.num_edges} edges) in "
          f"{time.perf_counter() - t0:.1f} s")
    return ds, graph, scaler


def library_bsr(op, x):
    """One BSR product of PyTorch's (``torch.sparse_bsr_tensor @ x``, which
    this build runs as a Triton kernel, compiled by phase 1) on the same
    tiles (a yardstick; the port never calls it): ``(ms, out)``, or
    ``(None, why)`` where this build refuses it."""
    npad = (op.row_ptr.numel() - 1) * op.blocks.shape[-1]
    xp = torch.zeros((npad, x.shape[1]), dtype=x.dtype, device=x.device)
    xp[:x.shape[0]] = x
    library_ready(x.shape[1])
    try:
        a = torch.sparse_bsr_tensor(op.row_ptr, op.block_cols, op.blocks,
                                    size=(npad, npad))
        out = (a @ xp)[:x.shape[0]]
        return cuda_ms(lambda: a @ xp), out
    except (RuntimeError, NotImplementedError, TypeError) as err:
        return None, f"{type(err).__name__}: {err}"[:300]


def phase2_kernel(graph, device) -> dict:
    """Kernel vs plain version on the card; returns the slice-shape row
    with its bound and the library call's time."""
    from sgp_tpu_torch.encode import prepare_propagation_graphs
    from sgp_tpu_torch.graph import Graph, coalesce, normalize_adj
    from sgp_tpu_torch.ops import bsr_spmm, bsr_spmm_plain, build_operator
    rng = np.random.default_rng(SEED)
    slice_g = prepare_propagation_graphs(graph)[0]
    # edges only among the first 300 of 1,000 nodes: block rows 3..7 are
    # empty, and N = 1,000 is not a multiple of 128
    m = 300
    ragged_g = normalize_adj(coalesce(Graph(
        rng.integers(0, m, 20 * m), rng.integers(0, m, 20 * m),
        rng.random(20 * m).astype(np.float32), 1000)))
    cases = [("slice", slice_g, 128), ("slice", slice_g, STREAMS * 128),
             ("slice", slice_g, 16), ("slice", slice_g, 64),
             ("ragged+empty rows", ragged_g, 200),
             ("ragged+empty rows", ragged_g, 1)]
    spills = spilling("phase 2", "bsr_spmm", "bsr_spmm_kernel",
                      "bsr_spmm_join")
    assert not spills, f"K1 spills registers: {spills}"
    rows = []
    for name, g, f in cases:
        x = torch.as_tensor(rng.standard_normal(
            (g.num_nodes, f)).astype(np.float32), device=device)
        for precision, tol in (("highest", TOL_F32), ("default", TOL_BF16)):
            op = build_operator(g, "bsr", precision=precision, device=device)
            args = (op.blocks, op.block_cols, op.row_ptr, op.block_rows)
            n_br = op.row_ptr.numel() - 1
            got = bsr_spmm(*args, x)
            ref = bsr_spmm_plain(op.blocks, op.block_cols, op.block_rows,
                                 n_br, x)
            again = bsr_spmm(*args, x)
            torch.cuda.synchronize()
            abs_err, rel = rel_err(got, ref)
            # a coherent bias (the tensor cores truncate their sums) shows
            # in the mean error and hides under the max
            bias = ((got.float() - ref.float()).mean()
                    / ref.float().abs().max()).item()
            main = name == "slice" and f == 128 and precision == "highest"
            k_ms, p_ms = interleaved_ms(
                lambda: bsr_spmm(*args, x), lambda: bsr_spmm_plain(
                    op.blocks, op.block_cols, op.block_rows, n_br, x),
                KERNEL_ROUNDS if main else 1, 20)
            row = dict(case=name, n=g.num_nodes, f=f, nnzb=op.blocks.shape[0],
                       dtype=str(op.blocks.dtype).replace("torch.", ""),
                       max_abs_err=abs_err, rel_err=rel, tol=tol,
                       out_mean_err=bias, bitwise_repeat=torch.equal(got, again),
                       ms=k_ms["median"], q1_q3=[k_ms["q1"], k_ms["q3"]],
                       plain_ms=p_ms["median"],
                       plain_q1_q3=[p_ms["q1"], p_ms["q3"]])
            if main:
                row.update(k1_bound(op, x))
                PHASE2_LIBRARY.update(op=op, x=x, ref=ref, row=row)
            print(f"[phase 2] {json.dumps(row)}")
            assert got.shape == ref.shape and torch.isfinite(got).all()
            assert rel <= tol, f"kernel disagrees with plain: {row}"
            assert row["bitwise_repeat"], f"two calls differ: {row}"
            if main:
                assert abs(bias) <= TOL_K1_BIAS, f"K1 output is biased: {row}"
                beside_recorded("phase 2", "bsr_spmm", row)
            rows.append(row)
    for name, g, f in (cases[0], cases[4]):
        for precision, tol in (("highest", TOL_F32), ("default", TOL_BF16)):
            bsr_gradient_check(g, f, precision, tol, rng, device)
    return next(r for r in rows if r["case"] == "slice" and r["f"] == 128
                and r["dtype"] == "float32")


PHASE2_LIBRARY = {}  # phase 2's slice row and its inputs, for the library


def phase2_library():
    """The library call beside phase 2's slice row (F 128), once the
    warm-up processes have compiled it, on the row's inputs."""
    lib = PHASE2_LIBRARY
    row = lib["row"]
    row["library_ms"], lib_out = library_bsr(lib["op"], lib["x"])
    if row["library_ms"] is None:
        row["library_note"] = lib_out
    else:
        row["library_max_abs_err"] = rel_err(lib_out, lib["ref"])[0]
    print(f"[phase 2] the slice row's library call: library_ms "
          f"{row['library_ms']}, max abs err "
          f"{row.get('library_max_abs_err', row.get('library_note'))}")
    lib.clear()


def bsr_gradient_check(g, f: int, precision: str, tol: float, rng, device):
    """C1: ``BSROperator @ x`` with x and the tiles needing gradients on
    the card. Its backward launches K1 on the transposed structure (dx) and
    K2 (the tiles' gradient); both are held against the plain versions on
    the same inputs, and timed beside them."""
    from sgp_tpu_torch.ops import BSROperator, bsr_spmm, build_operator, sddmm
    from sgp_tpu_torch.ops.bsr_kernel import bsr_spmm_plain, kept_transpose
    op = build_operator(g, "bsr", precision=precision, device=device)
    tiles = op.blocks.clone().requires_grad_()
    trainable = BSROperator(tiles, op.block_cols, op.row_ptr, op.block_rows,
                            g.num_nodes)
    x = torch.tensor(rng.standard_normal((g.num_nodes, f)).astype(
        np.float32), device=device, requires_grad=True)
    w = torch.as_tensor(rng.standard_normal((g.num_nodes, f)).astype(
        np.float32), device=device)
    y = trainable @ x
    k1, k2 = bsr_spmm.launches, sddmm.bsr_sddmm_kernel.launches
    d_tiles, dx = torch.autograd.grad(y, (tiles, x), w, retain_graph=True)
    torch.cuda.synchronize()
    launches = {"bsr_spmm": bsr_spmm.launches - k1,
                "bsr_sddmm": sddmm.bsr_sddmm_kernel.launches - k2}
    assert launches == {"bsr_spmm": 1, "bsr_sddmm": 1}, launches
    # the plain versions on the same inputs: A^T w over the transposed
    # tiles, and the SDDMM of w with x as the forward read it
    nbr = op.row_ptr.numel() - 1
    perm, t_cols, _, t_rows = kept_transpose(op.block_cols).index(
        op.block_cols, op.block_rows, nbr)

    def plain():
        t_tiles = tiles.detach()[perm].transpose(1, 2).float().contiguous()
        xr = x.detach().to(tiles.dtype).float()
        return (bsr_spmm_plain(t_tiles, t_cols, t_rows, nbr, w),
                sddmm.bsr_sddmm_plain(w, xr, op.block_rows, op.block_cols,
                                      nbr).to(tiles.dtype))
    dx_ref, dt_ref = plain()
    errs = {"dx": rel_err(dx, dx_ref), "d_tiles": rel_err(d_tiles, dt_ref)}
    row = dict(case="gradient", n=g.num_nodes, f=f,
               dtype=str(tiles.dtype).replace("torch.", ""), tol=tol,
               launches=launches, rel_err={k: v[1] for k, v in errs.items()},
               max_abs_err={k: v[0] for k, v in errs.items()},
               bwd_ms=cuda_ms(lambda: torch.autograd.grad(
                   y, (tiles, x), w, retain_graph=True)),
               bwd_plain_ms=cuda_ms(plain))
    print(f"[phase 2] {json.dumps(row)}")
    assert torch.isfinite(dx).all() and torch.isfinite(d_tiles).all()
    assert d_tiles.dtype == tiles.dtype and dx.dtype == x.dtype
    assert all(v[1] <= tol for v in errs.values()), row


def build_slice(graph, scaler, mode: str, device, n_nodes: int):
    """The sgp_pv.yaml encoder and decoder widths; same seeds, so every
    call gives the same reservoir and decoder weights."""
    from sgp_tpu_torch.data import Windowing
    from sgp_tpu_torch.encode import SGPEncoder
    from sgp_tpu_torch.models import SGPModel
    cfg = read_flat_yaml(CONFIG)
    # The serving path scales one raw observation [N, C] and has no
    # node-level exogenous input, so the yaml's datetime lanes
    # (preprocess_exogenous, keep_raw) cannot pass: input_size=1,
    # exog_size=0.
    enc = SGPEncoder(
        input_size=1, reservoir_size=cfg["reservoir_size"],
        reservoir_layers=cfg["reservoir_layers"],
        leaking_rate=cfg["leaking_rate"],
        spectral_radius=cfg["spectral_radius"], density=cfg["density"],
        receptive_field=cfg["receptive_field"],
        bidirectional=cfg["bidirectional"], alpha_decay=cfg["alpha_decay"],
        global_attr=cfg["global_attr"], add_self_loops=cfg["add_self_loops"],
        undirected=cfg["undirected"], seed=SEED, operator_mode=mode,
        device=device)
    order = enc.output_size // enc.reservoir.hidden_size
    horizon = Windowing(window=cfg["window"], horizon=cfg["horizon"],
                        horizon_lag=cfg["horizon_lag"]).horizon_steps
    model = SGPModel(
        input_size=enc.output_size, order=order, n_nodes=n_nodes,
        hidden_size=cfg["hidden_size"], mlp_size=cfg["mlp_size"],
        output_size=1, n_layers=cfg["n_layers"], horizon=horizon,
        positional_encoding=cfg["positional_encoding"],
        emb_size=cfg["emb_size"], exog_size=0, resnet=cfg["resnet"],
        fully_connected=cfg["fully_connected"], dropout=cfg["dropout"],
        generator=torch.Generator().manual_seed(SEED)).to(device)
    return enc, model, scaler.params(device=device)


def serve(fc, history, obs, device):
    """warm_up then one step per observation; returns forecasts and the
    per-step latencies (host clock, synchronized)."""
    from sgp_tpu_torch.ops import bsr_spmm
    fc.warm_up(history)
    outs, lat, launches = [], [], []
    for x in obs:
        x = torch.as_tensor(x, device=device)
        before = bsr_spmm.launches
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fc.step(x)
        if device.type == "cuda":
            torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        launches.append(bsr_spmm.launches - before)
        outs.append(y)
    return outs, lat, launches


def phase3_slice(ds, graph, scaler, device, n_nodes: int) -> dict:
    from sgp_tpu_torch.ops import bsr_spmm
    from sgp_tpu_torch.serve import OnlineForecaster
    target = ds.target                                     # [T, N, 1]
    hist1, obs1 = target[:WARMUP], target[WARMUP:WARMUP + STEPS]
    hist4 = np.stack([target[s * STREAM_OFFSET:s * STREAM_OFFSET + WARMUP
                             - STREAMS * STREAM_OFFSET]
                      for s in range(STREAMS)], axis=1)    # [T, S, N, 1]
    t4 = hist4.shape[0]
    obs4 = np.stack([target[s * STREAM_OFFSET + t4:
                            s * STREAM_OFFSET + t4 + STREAM_STEPS]
                     for s in range(STREAMS)], axis=1)     # [K, S, N, 1]

    fcs = {}
    for mode in ("bsr", "dense"):
        enc, model, sp = build_slice(graph, scaler, mode, device, n_nodes)
        fcs[mode] = (OnlineForecaster(enc, graph, model, sp, device=device),
                     OnlineForecaster(enc, graph, model, sp,
                                      n_streams=STREAMS, device=device))
    k_hops = fcs["bsr"][0]._k * len(fcs["bsr"][0]._ops)

    bsr_spmm.launches = 0                                  # main path
    y1, lat1, l1 = serve(fcs["bsr"][0], hist1, obs1, device)
    y4, lat4, l4 = serve(fcs["bsr"][1], hist4, obs4, device)
    launches = bsr_spmm.launches
    print(f"[phase 3] bsr_spmm launches on the main path: {launches} "
          f"(per step: single {sorted(set(l1))}, {STREAMS} streams "
          f"{sorted(set(l4))}; {k_hops} hops per step)")
    if device.type == "cuda":
        assert min(l1 + l4) >= k_hops, "a step did not launch the kernel"

    yd1, latd1, _ = serve(fcs["dense"][0], hist1, obs1, device)
    yd4, latd4, _ = serve(fcs["dense"][1], hist4, obs4, device)
    horizon = fcs["bsr"][0].model.horizon
    worst = 0.0
    for a, b, shape in [(y1, yd1, (horizon, n_nodes, 1)),
                        (y4, yd4, (STREAMS, horizon, n_nodes, 1))]:
        for ya, yb in zip(a, b):
            assert tuple(ya.shape) == shape, (tuple(ya.shape), shape)
            assert torch.isfinite(ya).all(), "non-finite forecast"
            worst = max(worst, rel_err(ya, yb)[1])
    print(f"[phase 3] BSR-kernel vs dense forecaster: max rel err {worst:.3e}"
          f" (tol {TOL_SLICE})")
    assert worst <= TOL_SLICE

    if device.type == "cuda":   # the same slice run by the port on the CPU
        # from the last CPU_WARMUP steps of the history, on both devices
        # (the CPU replays 576 steps at 5,016 nodes in ~30 s)
        hist_c, ys = hist1[-CPU_WARMUP:], {}
        for dev in (device, torch.device("cpu")):
            enc, model, sp = build_slice(graph, scaler, "bsr", dev, n_nodes)
            ys[dev.type], _, _ = serve(
                OnlineForecaster(enc, graph, model, sp, device=dev), hist_c,
                obs1[:CPU_STEPS], dev)
        cpu_err = max(rel_err(ya.cpu(), yb)[1]
                      for ya, yb in zip(ys["cuda"], ys["cpu"]))
        print(f"[phase 3] card vs CPU port, {CPU_STEPS} steps after "
              f"{CPU_WARMUP} of history: max rel err {cpu_err:.3e} (tol "
              f"{TOL_SLICE})")
        assert cpu_err <= TOL_SLICE

    med = {name: float(np.median(v) * 1e3) for name, v in (
        ("bsr_step_ms", lat1), ("dense_step_ms", latd1),
        (f"bsr_{STREAMS}streams_step_ms", lat4),
        (f"dense_{STREAMS}streams_step_ms", latd4))}
    print(f"[phase 3] median step latency: {json.dumps(med)}")
    return dict(launches=launches, **med)


def ell_inputs(rng, b, n, d, h2, h, dtype, device, empty_row=None):
    """Random K4 inputs at the scales of a GatedGN layer's: unit-variance
    projections, message weights of std 0.3 (so t @ w2 is about unit
    variance at h2 = 32)."""
    def mk(*shape, scale=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * scale).astype(
            np.float32), device=device)
    nmask = torch.as_tensor(rng.random((n, d)) < 0.9, device=device)
    if empty_row is not None:
        nmask[empty_row] = False
    return (mk(b, n, h2).to(dtype), mk(b, n, d, h2).to(dtype), nmask,
            mk(h2, h, scale=0.3), mk(h, scale=0.1), mk(h, 1, scale=0.3),
            mk(1, scale=0.1)), mk(b, n, h)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ell_bounds(args, ghat, out, grads) -> dict:
    """K4's bounds: every input read once and every output written once;
    the chain's FFMA work on the valid (node, slot) pairs."""
    p_i, pjn, nmask, w2 = args[:4]
    pairs = int(nmask.sum()) * p_i.shape[0]
    work = gated_chain_work(pairs, w2.shape[0], w2.shape[1])
    return {f"{half}_{k}": v for half, nb in (
        ("fwd", nbytes(*args, out)), ("bwd", nbytes(*args, ghat, *grads)))
        for k, v in bound(nb, *work[half]).items()}


def last_batch_cost(args, rounds: int):
    """The forward's cost of a row's partial last batch: the slice with all
    D slots valid (at D 100, 7 batches of 16 pairs a row, the last holding
    4) against its first 16 * (D // 16) valid (6 full batches), alternated.
    Work by the pair alone would give 0.96 of the time, work by the batch
    6/7."""
    from sgp_tpu_torch.ops import gn_ell
    d = args[2].shape[1]
    kept = d // 16 * 16
    cut_mask = args[2].clone()
    cut_mask[:, kept:] = False
    cut_args = (*args[:2], cut_mask, *args[3:])
    full, cut = interleaved_ms(lambda: gn_ell.gn_ell_fwd(*args),
                               lambda: gn_ell.gn_ell_fwd(*cut_args),
                               rounds, 10)
    row = dict(case="last batch", d=d, valid=kept,
               fwd_all_valid_ms=full["median"], fwd_cut_ms=cut["median"],
               ratio=cut["median"] / full["median"], by_pair=kept / d,
               by_batch=(kept // 16) / -(-d // 16))
    print(f"[phase 4] {json.dumps(row)}")


def phase4_gn_ell(device, n_nodes: int, batch: int, hidden: int):
    """K4 forward and backward vs their plain versions on the card; returns
    the slice-shape f32 rows of both."""
    from sgp_tpu_torch.ops import gn_ell
    rng = np.random.default_rng(SEED)
    h, h2 = hidden, hidden // 2
    spills = spilling("phase 4", "gn_ell", "gn_ell_fwd_kernel",
                      "gn_ell_bwd_kernel")
    assert not spills, f"K4 instantiations spill: {spills}"
    # the slice (every slot valid, as in the exact 100-nn graph); then B*N
    # rows not a multiple of the block's 4, D = 7, 10% padding and one
    # node with no valid neighbour
    cases = [("slice", batch, n_nodes, KNN, None),
             ("ragged", 3, 1001, 7, 500)]
    rows = {}
    for name, b, n, d, empty in cases:
        for dtype, tol in ((torch.float32, TOL_GN_F32),
                           (torch.bfloat16, TOL_GN_BF16)):
            args, ghat = ell_inputs(rng, b, n, d, h2, h, dtype, device, empty)
            if name == "slice":
                args[2].fill_(True)
            out = gn_ell.gn_ell_fwd(*args)
            grads = gn_ell.gn_ell_bwd(*args, ghat)
            ref = gn_ell.gn_ell_fwd_plain(*args)
            refg = gn_ell.gn_ell_bwd_plain(*args, ghat)
            torch.cuda.synchronize()
            assert out.shape == ref.shape and out.dtype == torch.float32
            errs = {"out": rel_err(out, ref)}
            # a coherent bias, which a training run sums over every node,
            # shows in the mean error and hides under the max
            bias = ((out - ref).mean() / ref.abs().max()).item()
            for gname, g, r in zip(("d_pi", "d_pjn", "dw2", "db2", "dwg",
                                    "dbg"), grads, refg):
                assert g.shape == r.shape and g.dtype == r.dtype, gname
                assert torch.isfinite(g).all(), gname
                errs[gname] = rel_err(g, r)
            if empty is not None:
                assert not out[:, empty].any(), "an empty row got messages"
            rounds = KERNEL_ROUNDS if name == "slice" else 1
            times = {}
            for half, kernel, plain in (
                    ("fwd", lambda: gn_ell.gn_ell_fwd(*args),
                     lambda: gn_ell.gn_ell_fwd_plain(*args)),
                    ("bwd", lambda: gn_ell.gn_ell_bwd(*args, ghat),
                     lambda: gn_ell.gn_ell_bwd_plain(*args, ghat))):
                k, p = interleaved_ms(kernel, plain, rounds, 10)
                times.update({f"{half}_ms": k["median"],
                              f"{half}_plain_ms": p["median"],
                              f"{half}_q1_q3": [k["q1"], k["q3"]],
                              f"{half}_plain_q1_q3": [p["q1"], p["q3"]]})
            row = dict(case=name, b=b, n=n, d=d, h2=h2, h=h,
                       dtype=str(dtype).replace("torch.", ""), tol=tol,
                       rel_err={k: v[1] for k, v in errs.items()},
                       max_abs_err={k: v[0] for k, v in errs.items()},
                       out_mean_err=bias, **times,
                       **ell_bounds(args, ghat, out, grads))
            print(f"[phase 4] {json.dumps(row)}")
            bad = {k: v[1] for k, v in errs.items() if not v[1] <= tol}
            assert not bad, f"K4 disagrees with plain ({name}, {dtype}): {bad}"
            if name == "slice" and dtype == torch.float32:
                assert abs(bias) <= TOL_K1_BIAS, f"K4 output is biased: {row}"
                last_batch_cost(args, rounds)
            rows[(name, row["dtype"])] = row
    beside_recorded("phase 4", "gn_ell", rows[("slice", "float32")])
    return rows[("slice", "float32")]


def gn_to_call(batch, training: bool):
    """The GatedGN runner's call with the ELL neighbour table
    (``exp/run_traffic_baselines.py``, ``--gn-aggregation ell``)."""
    return (batch["x"],), {"u": batch.get("u"),
                           "node_index": batch.get("node_index"),
                           "training": training, "neigh": batch["gn_neigh"]}


def gn_data(raw, graph, config: Path = GN_CONFIG):
    """The runner's data path at the gatedgn_pv.yaml windows: day encoding
    as the exogenous input, temporal split, standard scaler fitted on the
    train windows' start steps."""
    from sgp_tpu_torch.data import (SpatioTemporalDataset, StandardScaler,
                                    TemporalSplitter, Windowing)
    cfg = read_flat_yaml(config)
    ds = SpatioTemporalDataset(
        raw.target, index=raw.index, mask=raw.mask, graph=graph,
        covariates={"u": raw.datetime_encoded("day")},
        windowing=Windowing(window=cfg["window"], horizon=cfg["horizon"],
                            horizon_lag=cfg["horizon_lag"]))
    split = TemporalSplitter(0.1, 0.2).split(ds)
    ds.fit_scaler(StandardScaler(axis=(0, 1)),
                  step_index=ds.indices()[split.train])
    return cfg, ds, split


def gn_predictor(cfg, ds, static, device, init_state=None,
                 to_call=gn_to_call, compute_dtype=None):
    """The gatedgn_pv.yaml model and trainer, initialized from ``SEED`` (or
    from ``init_state``); ``static`` holds the graph's layout, ``to_call``
    hands it to the model; ``compute_dtype`` is the trainer's."""
    from sgp_tpu_torch.models import GatedGraphNetworkMLPModel
    from sgp_tpu_torch.train import Predictor
    u_size = ds.covariates["u"].value.shape[-1]
    model = GatedGraphNetworkMLPModel(
        input_size=ds.n_channels + u_size, input_window_size=cfg["window"],
        hidden_size=cfg["hidden_size"], output_size=ds.n_channels,
        horizon=ds.windowing.horizon_steps, n_nodes=ds.n_nodes,
        enc_layers=cfg["enc_layers"], gnn_layers=cfg["gnn_layers"],
        positional_encoding=cfg["positional_encoding"],
        activation=cfg["activation"])
    pred = Predictor(model, loss="mae", lr=cfg["lr"], grad_clip=GRAD_CLIP,
                     scale_target=cfg.get("scale_target", False),
                     batch_to_call=to_call, seed=SEED,
                     static_batch=static, compute_dtype=compute_dtype,
                     device=device)
    pred.init(None, ds.scaler_params())
    if init_state is not None:
        pred.model.load_state_dict(init_state)
    return pred


def train_steps(pred, loader, device):
    """``train_epoch`` over ``loader``, recording each step's loss and host
    time (synchronized) and the clipped gradients after the first step."""
    losses, times, first_grads = [], [], {}
    inner = pred.train_step

    def step(batch):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = inner(batch)
        losses.append(float(loss))      # synchronizes
        times.append(time.perf_counter() - t0)
        if not first_grads:
            first_grads.update({k: p.grad.detach().cpu().clone() for k, p in
                                pred.model.named_parameters()})
        return loss

    pred.train_step = step
    try:
        pred.train_epoch(loader)
    finally:
        del pred.train_step
    return losses, times, first_grads


def device_busy(prof, calls: int) -> dict:
    """The union of a torch.profiler window's device activities' intervals
    (kernels, copies; not the user annotations) per call, and the device
    time by name. Read from the profiler's raw events, with the filters
    and names of ``prof.events()``, whose tree of the host's operators
    took seconds to build for every profile of a step."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name
    spans, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation() \
                or _filter_name(e.name()) \
                or getattr(e, "is_hidden_event", lambda: False)():
            continue
        spans.append((e.start_ns(), e.end_ns()))
        name = _rewrite_name(name=e.name(), with_wildcard=True)
        by_name[name] = by_name.get(name, 0) + e.end_ns() - e.start_ns()
    if not spans:
        return {}
    busy, end = 0, -np.inf
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_busy_ms": busy / 1e6 / calls,
            "device_activities": len(spans) / calls,
            "device_ms_by_name": {k[:70]: v / 1e6 / calls for k, v in top}}


def idle_share(pred, loader, step_ms: float) -> dict:
    """Device time over ``PROFILE_STEPS`` train steps under torch.profiler
    (:func:`device_busy`, per step) and the idle share ``1 - busy /
    step_ms`` against the unprofiled median step."""
    from torch.profiler import ProfilerActivity, profile
    batches = list(loader)
    pred.train_step(batches[0])          # warm, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches[1:PROFILE_STEPS + 1]:
            float(pred.train_step(b))
        torch.cuda.synchronize()
    busy = device_busy(prof, PROFILE_STEPS)
    if not busy:
        return {"idle_share": "not measured (no device activity traced)"}
    return {"idle_share": 1.0 - busy["device_busy_ms"] / step_ms,
            "device_busy_ms_per_step": busy["device_busy_ms"],
            "device_activities_per_step": busy["device_activities"],
            "device_ms_per_step_by_name": busy["device_ms_by_name"]}


@contextlib.contextmanager
def plain_ell():
    """The GatedGN layer's ELL aggregation through the unfused plain math
    (``gn_ell_reference``, differentiated by autograd) in place of K4: the
    reference the K4 training run is held against."""
    from sgp_tpu_torch.models import graph_layers
    from sgp_tpu_torch.ops import gn_ell
    kernel = graph_layers.gn_ell_aggregate
    graph_layers.gn_ell_aggregate = gn_ell.gn_ell_reference
    try:
        yield
    finally:
        graph_layers.gn_ell_aggregate = kernel


class _PlainAllPairs(torch.autograd.Function):
    """The blocked plain all-pairs forward and backward as one autograd
    Function: at 5,016 nodes the unfused oracle would need tens of GB."""

    @staticmethod
    def forward(ctx, p_i, p_j, mask, w2, b2, wg, bg, activation, band):
        from sgp_tpu_torch.ops import gn_allpairs
        ctx.save_for_backward(p_i, p_j, mask, w2, b2, wg, bg)
        ctx.activation, ctx.band = activation, band
        return gn_allpairs.gn_allpairs_fwd_plain(p_i, p_j, mask, w2, b2, wg,
                                                 bg, activation, band)

    @staticmethod
    def backward(ctx, ghat):
        from sgp_tpu_torch.ops import gn_allpairs
        dpi, dpj, dw2, db2, dwg, dbg = gn_allpairs.gn_allpairs_bwd_plain(
            *ctx.saved_tensors, ghat, ctx.activation, ctx.band)
        return dpi, dpj, None, dw2, db2, dwg, dbg, None, None


@contextlib.contextmanager
def plain_allpairs():
    """The GatedGN layer's all-pairs aggregation through the blocked plain
    math in place of K3: the reference the K3 training run is held
    against."""
    from sgp_tpu_torch.models import graph_layers
    kernel = graph_layers.gn_allpairs_aggregate
    graph_layers.gn_allpairs_aggregate = _PlainAllPairs.apply
    try:
        yield
    finally:
        graph_layers.gn_allpairs_aggregate = kernel


def loaders(cfg, ds, split, steps=TRAIN_STEPS):
    """The runner's train loader (``steps`` batches) and test loader."""
    from sgp_tpu_torch.data import WindowedLoader
    return (WindowedLoader(ds, split.train, batch_size=cfg["batch_size"],
                           shuffle=True, limit_batches=steps, seed=SEED),
            WindowedLoader(ds, split.test, batch_size=cfg["batch_inference"],
                           limit_batches=EVAL_BATCHES))


def train_and_hold(tag, label, cfg, ds, split, static, to_call, counters,
                   plain_ctx, device) -> dict:
    """The main path (``Predictor.init``, ``train_epoch``, ``evaluate``)
    with the kernels' launch counters set to 0 just before it and read just
    after; then the same steps with ``plain_ctx`` on the card, held to it."""
    for fn in counters:
        fn.launches = 0
    pred = gn_predictor(cfg, ds, static, device, to_call=to_call)
    init_state = {k: v.detach().clone()
                  for k, v in pred.model.state_dict().items()}
    train_loader, test_loader = loaders(cfg, ds, split)
    losses, _, grads0 = train_steps(pred, train_loader, device)
    metrics = pred.evaluate(test_loader, prefix="test_")
    launches = {fn.__name__: fn.launches for fn in counters}
    need = cfg["gnn_layers"] * TRAIN_STEPS
    print(f"[{tag}] {label} launches on the main path: "
          f"{json.dumps(launches)} ({cfg['gnn_layers']} layers x "
          f"{TRAIN_STEPS} steps = {need}, + {EVAL_BATCHES} evaluate batches)")
    assert min(launches.values()) >= need, launches
    assert all(np.isfinite(losses)), f"non-finite loss: {losses}"
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    print(f"[{tag}] {label} losses {losses}; {json.dumps(metrics)}")

    with plain_ctx():
        plain = gn_predictor(cfg, ds, static, device, init_state, to_call)
        train_loader, test_loader = loaders(cfg, ds, split)
        p_losses, _, _ = train_steps(plain, train_loader, device)
        p_metrics = plain.evaluate(test_loader, prefix="test_")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, p_losses))
    met_err = max(abs(metrics[k] - p_metrics[k]) / abs(p_metrics[k])
                  for k in metrics)
    p_params = dict(plain.model.named_parameters())
    diffs, held = [], []
    for k, v in pred.model.named_parameters():
        d = (v - p_params[k]).detach().abs().cpu()
        diffs.append(d.flatten())
        held.append(d[grads0[k].abs() > GRAD_FLOOR])
    diffs, held = torch.cat(diffs), torch.cat(held)
    param_err = held.max().item()
    print(f"[{tag}] {label} vs plain on the card: losses max rel err "
          f"{loss_err:.3e}, evaluate max rel err {met_err:.3e} (tol "
          f"{TOL_LOSS}); final parameters max abs diff {param_err:.3e} on "
          f"the {held.numel()} of {diffs.numel()} elements whose first "
          f"gradient exceeds {GRAD_FLOOR} (tol {TOL_PARAM}), "
          f"{diffs.max().item():.3e} over all")
    assert loss_err <= TOL_LOSS and met_err <= TOL_LOSS
    assert param_err <= TOL_PARAM
    return dict(pred=pred, plain=plain, init_state=init_state,
                losses=losses, grads0=grads0, launches=launches)


def cpu_step(tag, make, loader, init_state, losses, grads0, what: str,
             exact_zero=()):
    """One step of the port on the CPU from the same weights and batch as
    the card's first step (``losses[0]``, ``grads0``), held to it;
    ``make(device, init_state)`` builds the trainer, ``loader`` gives the
    batch. The gradients named in ``exact_zero`` are 0 in exact arithmetic
    and hold only rounding noise on both sides: they are held to
    ``TOL_ZERO_GRAD`` of the model's largest gradient instead."""
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    on_cpu = make(cpu, {k: v.cpu() for k, v in init_state.items()})
    c_losses, _, c_grads = train_steps(on_cpu, loader, cpu)
    cpu_s = time.perf_counter() - t0
    c_err = abs(c_losses[0] - losses[0]) / abs(c_losses[0])
    errs = {k: rel_err(grads0[k], c_grads[k])[1] for k in grads0
            if k not in exact_zero}
    g_err = max(errs.values())
    worst = sorted(errs, key=errs.get)[-3:]
    top = max(g.abs().max().item() for g in grads0.values())
    zero = max((max(grads0[k].abs().max().item(),
                    c_grads[k].abs().max().item()) / top
                for k in exact_zero), default=0.0)
    print(f"[{tag}] card vs CPU port, first step {what} ({cpu_s:.1f} s on "
          f"the CPU): loss rel err {c_err:.3e} (tol {TOL_LOSS}), clipped "
          f"gradients max rel err {g_err:.3e} (tol {TOL_GRAD}; the worst "
          f"{[(k, f'{errs[k]:.3e}') for k in worst]})" + (
              f"; {list(exact_zero)} (0 in exact arithmetic) at most "
              f"{zero:.3e} of the largest gradient (tol {TOL_ZERO_GRAD})"
              if exact_zero else ""))
    assert c_err <= TOL_LOSS and g_err <= TOL_GRAD and zero <= TOL_ZERO_GRAD
    return cpu_s


def time_steps(tag, preds, cfg, ds, split, order, steps, device):
    """Step times and peak memory of the kernel and plain trainers in
    alternating rounds, then a profile of each: the idle share."""
    times, peak_mib = {k: [] for k in preds}, {}
    for name in order:
        model, ctx = preds[name]
        with ctx():
            torch.cuda.reset_peak_memory_stats()
            _, t, _ = train_steps(model, loaders(cfg, ds, split, steps)[0],
                                  device)
            peak = torch.cuda.max_memory_allocated() / 2**20
        times[name] += [x * 1e3 for x in t[TIME_DROP:]]
        peak_mib[name] = max(peak_mib.get(name, 0.0), peak)
    stats = {k: quartiles(v) for k, v in times.items()}
    print(f"[{tag}] train-step ms (host clock, synchronized; {len(order)} "
          f"rounds of {steps} steps in the order {'/'.join(order)}, the "
          f"first {TIME_DROP} of each left out): {json.dumps(stats)}; peak "
          f"device memory MiB (max_memory_allocated): {json.dumps(peak_mib)}")
    for name, (model, ctx) in preds.items():
        with ctx():
            prof = idle_share(model, loaders(cfg, ds, split,
                                             PROFILE_STEPS + 1)[0],
                              stats[name]["median"])
        print(f"[{tag}] profile of {PROFILE_STEPS} {name} steps: "
              f"{json.dumps(prof)}")


def phase5_train(raw, graph, device) -> dict:
    """The GatedGN training slice through K4, held against the plain ELL
    math on the card and the port on the CPU; then timed against it."""
    from sgp_tpu_torch.graph import padded_incoming
    from sgp_tpu_torch.ops import gn_ell
    cfg, ds, split = gn_data(raw, graph)
    src_idx, nmask = padded_incoming(graph)
    static = {"gn_neigh": (src_idx, nmask)}
    print(f"[phase 5] {ds.n_nodes} nodes, ELL width D={src_idx.shape[1]} "
          f"({nmask.mean():.4f} of slots valid), windows {len(ds)}, "
          f"{split}, horizon steps {ds.windowing.horizon_steps}")
    assert src_idx.shape[1] == KNN and nmask.all(), "not an exact k-nn graph"
    run = train_and_hold("phase 5", "K4", cfg, ds, split, static, gn_to_call,
                         (gn_ell.gn_ell_fwd, gn_ell.gn_ell_bwd), plain_ell,
                         device)
    cpu_step("phase 5", lambda dev, init: gn_predictor(
                 cfg, ds, static, dev, init, gn_to_call),
             loaders(cfg, ds, split, 1)[0], run["init_state"], run["losses"],
             run["grads0"], f"at the full size, {ds.n_nodes} nodes")
    time_steps("phase 5", {"k4": (run["pred"], contextlib.nullcontext),
                           "plain": (run["plain"], plain_ell)},
               cfg, ds, split, TIME_ORDER, TIME_STEPS, device)
    return dict(launches=run["launches"])


def full_graph(raw):
    """The dataset's similarity thresholded at the PV-US full-graph
    density: ``thr`` is its ``1 - 0.1475`` quantile, edges ``sim >= thr``
    without self-loops (``bench.py``'s full graph)."""
    thr = float(np.quantile(raw.get_similarity(), 1.0 - FULL_DENSITY))
    return raw.get_connectivity(threshold=thr, include_self=False)


def allpairs_inputs(rng, b, n, h2, h, dtype, mask, device):
    """Random K3 inputs at a GatedGN layer's scales (see ell_inputs) on the
    given ``[N, N]`` mask."""
    def mk(*shape, scale=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * scale).astype(
            np.float32), device=device)
    return (mk(b, n, h2).to(dtype), mk(b, n, h2).to(dtype), mask,
            mk(h2, h, scale=0.3), mk(h, scale=0.1), mk(h, 1, scale=0.3),
            mk(1, scale=0.1)), mk(b, n, h)


def allpairs_bounds(args, ghat, out, grads, band) -> dict:
    """K3's bounds: every input read once (the mask one byte an entry) and
    every output written once; the chain's FFMA work on the masked pairs
    inside the windows, not on all N^2."""
    from sgp_tpu_torch.ops.gn_allpairs import row_blocks
    p_i, _, mask, w2 = args[:4]
    n = p_i.shape[1]
    pairs = p_i.shape[0] * sum(
        int(mask[r0:r1, c0:c1].count_nonzero())
        for r0, r1, c0, c1 in row_blocks(n, w2.shape[1], 4, band))
    work = gated_chain_work(pairs, w2.shape[0], w2.shape[1])
    mask_bytes = n * n
    rest = [t for t in args if t is not mask]
    return {"pairs": pairs, **{f"{half}_{k}": v for half, nb in (
        ("fwd", nbytes(*rest, out) + mask_bytes),
        ("bwd", nbytes(*rest, ghat, *grads) + mask_bytes))
        for k, v in bound(nb, *work[half]).items()}}


def phase6_gn_allpairs(graph, device, batch: int, hidden: int):
    """K3 forward and backward vs their plain versions on the card: the
    full graph in natural order (a full sweep, the main path's shapes),
    RCM-ordered with per-block windows, and a ragged case (B 3, N 1,001,
    an asymmetric mask, one empty row); f32 and bf16. Returns the main
    path's f32 row."""
    from sgp_tpu_torch.graph import band_windows, permute_nodes, rcm_order
    from sgp_tpu_torch.ops import dense_adj_mask, gn_allpairs
    rng = np.random.default_rng(SEED)
    h, h2 = hidden, hidden // 2
    t0 = time.perf_counter()
    rcm = permute_nodes(graph, rcm_order(graph))
    rcm_mask = dense_adj_mask(rcm, device=device)
    band = band_windows(rcm_mask.cpu().numpy(), BAND_BLOCK, uniform=False)
    n_r = RAGGED_NODES
    ragged = torch.as_tensor(rng.random((n_r, n_r)) < FULL_DENSITY,
                             device=device)
    ragged[n_r // 2] = False
    assert not torch.equal(ragged, ragged.T)
    print(f"[phase 6] RCM order and windows in "
          f"{time.perf_counter() - t0:.1f} s: block {band[0]}, widths "
          f"{list(band[1])}; windowed pairs "
          f"{sum(band[1]) * band[0] / graph.num_nodes ** 2:.3f} of N^2")
    spills = spilling("phase 6", "gn_allpairs", "gn_allpairs_fwd_kernel",
                      "gn_allpairs_bwd_rows_kernel",
                      "gn_allpairs_bwd_cols_kernel")
    assert not spills, f"K3 instantiations spill: {spills}"
    cases = [("slice", batch, dense_adj_mask(graph, device=device), None),
             ("rcm band", batch, rcm_mask, band),
             ("ragged", 3, ragged, None)]
    rows = {}
    for name, b, mask, bnd in cases:
        n = mask.shape[0]
        for dtype, tol in ((torch.float32, TOL_AP_F32),
                           (torch.bfloat16, TOL_AP_BF16)):
            args, ghat = allpairs_inputs(rng, b, n, h2, h, dtype, mask,
                                         device)
            out = gn_allpairs.gn_allpairs_fwd(*args, band=bnd)
            grads = gn_allpairs.gn_allpairs_bwd(*args, ghat, band=bnd)
            ref = gn_allpairs.gn_allpairs_fwd_plain(*args, band=bnd)
            refg = gn_allpairs.gn_allpairs_bwd_plain(*args, ghat, band=bnd)
            torch.cuda.synchronize()
            assert out.shape == ref.shape and out.dtype == torch.float32
            errs = {"out": rel_err(out, ref)}
            # a coherent bias, which a training run sums over every node,
            # shows in the mean error and hides under the max
            bias = ((out - ref).mean() / ref.abs().max()).item()
            for gname, g, r in zip(("d_pi", "d_pj", "dw2", "db2", "dwg",
                                    "dbg"), grads, refg):
                assert g.shape == r.shape and g.dtype == r.dtype, gname
                assert torch.isfinite(g).all(), gname
                errs[gname] = rel_err(g, r)
            if name == "ragged":
                assert not out[:, n_r // 2].any(), "an empty row got messages"
            main = name == "slice" and dtype == torch.float32
            rounds = AP_ROUNDS if main else 1
            times = {}
            for half, kernel, plain in (
                    ("fwd", lambda: gn_allpairs.gn_allpairs_fwd(
                        *args, band=bnd),
                     lambda: gn_allpairs.gn_allpairs_fwd_plain(
                         *args, band=bnd)),
                    ("bwd", lambda: gn_allpairs.gn_allpairs_bwd(
                        *args, ghat, band=bnd),
                     lambda: gn_allpairs.gn_allpairs_bwd_plain(
                         *args, ghat, band=bnd))):
                k, p = interleaved_ms(kernel, plain, rounds, 10,
                                      AP_PLAIN_ITERS)
                times.update({f"{half}_ms": k["median"],
                              f"{half}_plain_ms": p["median"],
                              f"{half}_q1_q3": [k["q1"], k["q3"]],
                              f"{half}_plain_q1_q3": [p["q1"], p["q3"]]})
            row = dict(case=name, b=b, n=n, h2=h2, h=h,
                       dtype=str(dtype).replace("torch.", ""), tol=tol,
                       rel_err={k: v[1] for k, v in errs.items()},
                       max_abs_err={k: v[0] for k, v in errs.items()},
                       out_mean_err=bias, **times,
                       **allpairs_bounds(args, ghat, out, grads, bnd))
            print(f"[phase 6] {json.dumps(row)}")
            bad = {k: v[1] for k, v in errs.items() if not v[1] <= tol}
            assert not bad, f"K3 disagrees with plain ({name}, {dtype}): {bad}"
            rows[(name, row["dtype"])] = row
            del args, ghat, out, grads, ref, refg
    beside_recorded("phase 6", "gn_allpairs", rows[("slice", "float32")])
    return rows[("slice", "float32")]


def full_setup(raw, graph, device):
    """The full-graph slice's data, dense mask and window table, and the
    runners' call (``--gn-aggregation dense``)."""
    from sgp_tpu_torch.graph import auto_band
    from sgp_tpu_torch.ops import dense_adj_mask
    cfg, ds, split = gn_data(raw, graph, FULL_CONFIG)
    band = auto_band(graph)

    def to_call(batch, training):
        return (batch["x"],), {"u": batch.get("u"),
                               "node_index": batch.get("node_index"),
                               "training": training, "adj": batch["gn_adj"],
                               "adj_band": band}
    return cfg, ds, split, dense_adj_mask(graph, device=device), band, to_call


def phase7_full(raw, graph, device) -> dict:
    """The full-graph GatedGN slice through K3, held against the blocked
    plain all-pairs math on the card and, on CPU_NODES nodes at the same
    density, the port on the CPU; then timed against it."""
    from sgp_tpu_torch.data.datasets import SyntheticDiffusion
    from sgp_tpu_torch.ops import gn_allpairs
    cfg, ds, split, mask, band, to_call = full_setup(raw, graph, device)
    print(f"[phase 7] {ds.n_nodes} nodes, {graph.num_edges} edges "
          f"({graph.num_edges / ds.n_nodes ** 2:.4f} of N^2), auto_band: "
          f"{'none, a full sweep' if band is None else band}; windows "
          f"{len(ds)}, {split}, batch {cfg['batch_size']}, horizon steps "
          f"{ds.windowing.horizon_steps}")
    static = {"gn_adj": mask}
    run = train_and_hold("phase 7", "K3", cfg, ds, split, static, to_call,
                         (gn_allpairs.gn_allpairs_fwd,
                          gn_allpairs.gn_allpairs_bwd), plain_allpairs,
                         device)

    # the first step on fewer nodes at the same density: K3 on the card,
    # then the port on the CPU from the same weights
    small = SyntheticDiffusion(num_nodes=CPU_NODES, num_steps=N_STEPS,
                               seed=SEED)
    s_graph = full_graph(small)
    s_cfg, s_ds, s_split, s_mask, _, s_call = full_setup(small, s_graph,
                                                         device)
    s_pred = gn_predictor(s_cfg, s_ds, {"gn_adj": s_mask}, device,
                          to_call=s_call)
    s_init = {k: v.detach().clone()
              for k, v in s_pred.model.state_dict().items()}
    s_losses, _, s_grads = train_steps(
        s_pred, loaders(s_cfg, s_ds, s_split, 1)[0], device)
    cpu_s = cpu_step("phase 7", lambda dev, init: gn_predictor(
                         s_cfg, s_ds, {"gn_adj": s_mask.cpu()}, dev, init,
                         s_call),
                     loaders(s_cfg, s_ds, s_split, 1)[0], s_init, s_losses,
                     s_grads, f"on {CPU_NODES} nodes at density "
                     f"{s_graph.num_edges / CPU_NODES ** 2:.4f}")
    print(f"[phase 7] the CPU step at {ds.n_nodes} nodes would take about "
          f"{cpu_s * (ds.n_nodes / CPU_NODES) ** 2:.0f} s (the pairs grow "
          f"as N^2)")

    time_steps("phase 7", {"k3": (run["pred"], contextlib.nullcontext),
                           "plain": (run["plain"], plain_allpairs)},
               cfg, ds, split, FULL_TIME_ORDER, FULL_TIME_STEPS, device)
    return dict(launches=run["launches"])


def ragged_attention_graph(rng):
    """N 1,001 (no multiple of 128) with no edge ending in nodes 128..255:
    block row 1 stores no block."""
    from sgp_tpu_torch.graph import Graph, coalesce
    n, e = RAGGED_NODES, 30 * RAGGED_NODES
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    dst = np.where((dst >= 128) & (dst < 256), dst % 128, dst)
    return coalesce(Graph(src, dst, None, n))


def sddmm_bound(q, k, nnzb: int) -> dict:
    """K2's bound: q and k read once, the ``[nnzb, 128, 128]`` f32 scores
    written once; ``2 * 128^2 * D`` flop of products a stored block."""
    return bound(nbytes(q, k) + nnzb * 128 * 128 * 4,
                 2 * nnzb * 128 * 128 * q.shape[1])


def library_sddmm(q, k, st):
    """K2's function in one PyTorch call (a yardstick; the port never calls
    it): ``torch.sparse.sampled_addmm`` with beta 0 on a CSR that holds
    every position of the stored blocks inside ``[N, N]``. Returns ``(ms,
    rel_err against the plain version's tiles at those positions)``, or
    ``(None, why)`` where this build refuses it."""
    from sgp_tpu_torch.ops import sddmm
    n, dev = q.shape[0], q.device
    nnzb = st.block_rows.numel()
    r = torch.arange(128, device=dev)
    rows = (st.block_rows.long()[:, None, None] * 128 + r[:, None]).expand(
        nnzb, 128, 128)
    cols = (st.block_cols.long()[:, None, None] * 128 + r).expand(
        nnzb, 128, 128)
    keep = (rows < n) & (cols < n)
    slot = torch.arange(nnzb * 128 * 128, device=dev).view(nnzb, 128, 128)
    order = torch.argsort(rows[keep] * n + cols[keep])
    rows, cols, slot = rows[keep][order], cols[keep][order], slot[keep][order]
    crow = torch.zeros(n + 1, dtype=torch.long, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    qf, kt = q.float(), k.float().T.contiguous()
    try:
        pattern = torch.sparse_csr_tensor(
            crow, cols, torch.ones(cols.numel(), device=dev), size=(n, n))
        call = lambda: torch.sparse.sampled_addmm(pattern, qf, kt, beta=0.0)
        got = call().values()
        ms = cuda_ms(call)
    except (RuntimeError, NotImplementedError, TypeError) as err:
        return None, f"{type(err).__name__}: {err}"[:300]
    ref = sddmm.bsr_sddmm_plain(q, k, st.block_rows, st.block_cols,
                                st.n_block_rows).view(-1)[slot]
    return ms, rel_err(got, ref)[1]


def phase8_sddmm(graph, rcm, ragged, device) -> dict:
    """K2 against its plain version on the card: the 100-nn graph in
    natural and RCM order at D 64 and 16, and the ragged graph at D 40, f32
    and bf16, with CUDA-event times of both (plain, kernel, kernel, plain),
    the bound and the library yardstick, one ``torch.bmm`` of tiles gathered
    beforehand. Returns the main path's row (natural order, D 64, f32)."""
    from sgp_tpu_torch.ops import sddmm
    rng = np.random.default_rng(SEED)
    cases = [("slice", graph, 64), ("slice", graph, 16), ("rcm", rcm, 64),
             ("rcm", rcm, 16), ("ragged", ragged, 40)]
    rows = {}
    for name, g, d in cases:
        st = sddmm.bsr_attention_structure(g, device=device)
        idx = (st.block_rows, st.block_cols, st.n_block_rows)
        nnzb, n = st.block_rows.numel(), g.num_nodes
        for dtype, tol in ((torch.float32, TOL_F32),
                           (torch.bfloat16, TOL_SDDMM_BF16)):
            q, k = (torch.as_tensor(rng.standard_normal((n, d)).astype(
                np.float32), device=device).to(dtype) for _ in range(2))
            got = sddmm.bsr_sddmm_kernel(q, k, *idx)
            again = sddmm.bsr_sddmm_kernel(q, k, *idx)
            ref = sddmm.bsr_sddmm_plain(q, k, *idx)
            torch.cuda.synchronize()
            abs_err, rel = rel_err(got, ref)
            # a coherent bias (the tensor cores truncate their sums) shows
            # in the mean error and hides under the max
            bias = ((got - ref).mean() / ref.abs().max()).item()
            assert got.shape == ref.shape and torch.isfinite(got).all()
            pad = n % 128
            if pad:
                last = st.n_block_rows - 1
                assert not got[st.block_rows == last, pad:].any()
                assert not got[st.block_cols == last][:, :, pad:].any()
            main = (name, d, dtype) == ("slice", 64, torch.float32)
            k_ms, p_ms = interleaved_ms(
                lambda: sddmm.bsr_sddmm_kernel(q, k, *idx),
                lambda: sddmm.bsr_sddmm_plain(q, k, *idx),
                KERNEL_ROUNDS if main else 1, 20)
            # beside it, cuBLAS on the gathered f32 tiles: the gather, which
            # K2 does inside, is left out of this time (TF32 is off)
            qt = sddmm._pad_tiles(q, st.n_block_rows)[
                st.block_rows.long()].float()
            kt = sddmm._pad_tiles(k, st.n_block_rows)[
                st.block_cols.long()].float()
            bmm_ms = cuda_ms(lambda: torch.bmm(qt, kt.mT))
            bmm_err = rel_err(torch.bmm(qt, kt.mT), ref)[1]
            row = dict(case=name, n=n, d=d, nnzb=nnzb,
                       dtype=str(dtype).replace("torch.", ""),
                       max_abs_err=abs_err, rel_err=rel, tol=tol,
                       out_mean_err=bias,
                       bitwise_repeat=torch.equal(got, again),
                       ms=k_ms["median"], q1_q3=[k_ms["q1"], k_ms["q3"]],
                       plain_ms=p_ms["median"],
                       plain_q1_q3=[p_ms["q1"], p_ms["q3"]],
                       bmm_pregathered_ms=bmm_ms, bmm_rel_err=bmm_err,
                       **sddmm_bound(q, k, nnzb))
            if main:
                row["library_ms"], lib = library_sddmm(q, k, st)
                row["library_call"] = "torch.sparse.sampled_addmm"
                row["library_rel_err" if row["library_ms"] is not None
                    else "library_note"] = lib
            print(f"[phase 8] {json.dumps(row)}")
            assert rel <= tol, f"K2 disagrees with plain: {row}"
            assert row["bitwise_repeat"], f"two calls differ: {row}"
            if dtype == torch.float32:
                assert abs(bias) <= TOL_K1_BIAS, f"K2 output is biased: {row}"
            if main:
                beside_recorded("phase 8", "bsr_sddmm", row)
            rows[(name, d, row["dtype"])] = row
            del qt, kt, got, again, ref
    return rows[("slice", 64, "float32")]


def attention_inputs(rng, n, h, d, device):
    return [torch.as_tensor(rng.standard_normal((n, h, d)).astype(
        np.float32), device=device) for _ in range(3)]


def phase9_attention(graphs, ragged, device) -> dict:
    """The attention path: ``bsr_multi_head_attention`` at N 5,016 on the
    100-nn graph (natural and RCM order) and the full graph, H 1 x D 64 and
    H 4 x D 16, f32, with the K2 and K1 counters set to 0 just before and
    read just after; each result held against the edge-list
    ``sparse_multi_head_attention`` on the card, and the 1,001-node case
    and its backward against the port on the CPU; then the times and peak
    memory of both forms."""
    from sgp_tpu_torch.ops import (bsr_attention_structure,
                                   bsr_multi_head_attention, bsr_spmm,
                                   sddmm, sparse_multi_head_attention)
    rng = np.random.default_rng(SEED)
    runs = []
    for name, g in graphs:
        st = bsr_attention_structure(g, device=device)
        for h, d in ATT_HEADS:
            runs.append((name, g, st, attention_inputs(rng, g.num_nodes, h,
                                                       d, device)))
    sddmm.bsr_sddmm_kernel.launches = bsr_spmm.launches = 0   # main path
    outs = [bsr_multi_head_attention(*qkv, st) for _, _, st, qkv in runs]
    torch.cuda.synchronize()
    launches = {"bsr_sddmm": sddmm.bsr_sddmm_kernel.launches,
                "bsr_spmm": bsr_spmm.launches}
    need = sum(qkv[0].shape[1] for _, _, _, qkv in runs)
    print(f"[phase 9] launches on the attention path: {json.dumps(launches)}"
          f" ({len(runs)} calls, {need} heads in all)")
    # a head: one K2 for its scores, one K1 for att @ v
    assert launches == {"bsr_sddmm": need, "bsr_spmm": need}, launches

    for (name, g, st, qkv), out in zip(runs, outs):
        n, h, d = qkv[0].shape
        src = torch.as_tensor(g.src, device=device)
        dst = torch.as_tensor(g.dst, device=device)
        assert out.shape == (n, h, d) and torch.isfinite(out).all()
        edge = sparse_multi_head_attention(*qkv, src, dst, n)
        err = (out - edge).abs().max().item()
        times, peaks = {}, {}
        for form, fn in (
                ("block", lambda: bsr_multi_head_attention(*qkv, st)),
                ("edge_list", lambda: sparse_multi_head_attention(
                    *qkv, src, dst, n))):
            times[form] = cuda_ms(fn, ATT_ITERS, warmup=1)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peaks[form] = (torch.cuda.max_memory_allocated() - base) / 2**20
        row = dict(graph=name, n=n, edges=g.num_edges,
                   nnzb=st.block_rows.numel(), heads=h, d=d,
                   max_abs_err_vs_edge_list=err, tol=TOL_ATT,
                   block_ms=times["block"], edge_list_ms=times["edge_list"],
                   block_peak_extra_mib=peaks["block"],
                   edge_list_peak_extra_mib=peaks["edge_list"],
                   scored_pairs_block=st.block_rows.numel() * 128 * 128,
                   scored_pairs_edge_list=g.num_edges)
        print(f"[phase 9] {json.dumps(row)}")
        assert err <= TOL_ATT, row
        del edge

    # the ragged case and its backward on the card and on the CPU port,
    # same inputs; the backward launches, a head, K2 once (d_att) and K1
    # three times (dv, and the SDDMM's dq and dk)
    arrays = [rng.standard_normal((ragged.num_nodes, 2, 40)).astype(
        np.float32) for _ in range(4)]
    res = []
    for dev in (device, torch.device("cpu")):
        q, k, v = (torch.tensor(a, device=dev, requires_grad=True)
                   for a in arrays[:3])
        out = bsr_multi_head_attention(
            q, k, v, bsr_attention_structure(ragged, device=dev))
        k2, k1 = sddmm.bsr_sddmm_kernel.launches, bsr_spmm.launches
        (out * torch.as_tensor(arrays[3], device=dev)).sum().backward()
        if dev == device:
            torch.cuda.synchronize()
            bwd = {"bsr_sddmm": sddmm.bsr_sddmm_kernel.launches - k2,
                   "bsr_spmm": bsr_spmm.launches - k1}
            assert bwd == {"bsr_sddmm": 2, "bsr_spmm": 6}, bwd
        res.append([t.detach().cpu() for t in (out, q.grad, k.grad, v.grad)])
    errs = {name: rel_err(a, b)[1] for name, a, b in zip(
        ("out", "dq", "dk", "dv"), *res)}
    print(f"[phase 9] card vs CPU port, N {ragged.num_nodes}, H 2 x D 40, "
          f"forward and backward (launches {json.dumps(bwd)}): max rel err "
          + " ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {TOL_F32})")
    assert all(v <= TOL_F32 for v in errs.values()), errs
    return launches


def transformer_predictor(ds, device, init_state=None):
    """``--model-name transformer`` at the runner's defaults (hidden 64, ff
    128, 1 layer, 1 head, axis time, elu, dropout 0, lr 1e-3, clip 5.0)."""
    from sgp_tpu_torch.models import TransformerModel
    from sgp_tpu_torch.train import Predictor
    u_size = ds.covariates["u"].value.shape[-1]
    model = TransformerModel(
        input_size=ds.n_channels + u_size, hidden_size=64, ff_size=128,
        output_size=ds.n_channels, horizon=ds.windowing.horizon_steps,
        n_layers=1, n_heads=1, axis="time", activation="elu", dropout=0.0)
    pred = Predictor(model, loss="mae", lr=1e-3, grad_clip=GRAD_CLIP,
                     seed=SEED, device=device)
    pred.init(None, ds.scaler_params())
    if init_state is not None:
        pred.model.load_state_dict(init_state)
    return pred


def phase10_transformer(raw, graph, device):
    """``TransformerModel`` through ``Predictor`` on phase 5's data and
    loaders: train steps and ``evaluate``, checked for finite losses; the
    first step against the port on the CPU; step times and peak memory."""
    cfg, ds, split = gn_data(raw, graph)
    pred = transformer_predictor(ds, device)
    init_state = {k: v.detach().clone()
                  for k, v in pred.model.state_dict().items()}
    train_loader, test_loader = loaders(cfg, ds, split)
    losses, _, grads0 = train_steps(pred, train_loader, device)
    metrics = pred.evaluate(test_loader, prefix="test_")
    n_params = sum(p.numel() for p in pred.model.parameters())
    print(f"[phase 10] TransformerModel ({n_params} parameters), window "
          f"{cfg['window']}, batch {cfg['batch_size']}, {ds.n_nodes} nodes: "
          f"losses {losses}; {json.dumps(metrics)}")
    assert all(np.isfinite(losses)), f"non-finite loss: {losses}"
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    # a softmax does not see a shift of all its logits: the key
    # projection's bias gets no gradient in exact arithmetic
    key_bias = tuple(k for k in grads0 if k.endswith("attention.k.bias"))
    cpu_step("phase 10", lambda dev, init: transformer_predictor(
                 ds, dev, init), loaders(cfg, ds, split, 1)[0], init_state,
             losses, grads0, f"at the full size, {ds.n_nodes} nodes",
             exact_zero=key_bias)
    time_steps("phase 10", {"transformer": (pred, contextlib.nullcontext)},
               cfg, ds, split, ("transformer",) * 2, TRAIN_STEPS, device)


def sgp_setup(raw, graph):
    """The large-scale runner's data path at the sgp_pv.yaml windows: day
    encoding as the exogenous input, temporal split, RobustScaler(10, 90)
    fitted on the train windows' start steps."""
    from sgp_tpu_torch.data import (RobustScaler, SpatioTemporalDataset,
                                    TemporalSplitter, Windowing)
    cfg = read_flat_yaml(CONFIG)
    ds = SpatioTemporalDataset(
        raw.target, index=raw.index, mask=raw.mask, graph=graph,
        covariates={"u": raw.datetime_encoded("day")},
        windowing=Windowing(window=cfg["window"], horizon=cfg["horizon"],
                            horizon_lag=cfg["horizon_lag"]))
    split = TemporalSplitter(0.1, 0.2).split(ds)
    ds.fit_scaler(RobustScaler(axis=(0, 1), quantile_range=(10., 90.)),
                  step_index=ds.indices()[split.train])
    return cfg, ds, split


def sgp_encoder(cfg, input_size: int, mode: str, device):
    """The yaml's encoder, routed as the runner routes its flags."""
    from sgp_tpu_torch.encode import SGPEncoder
    from sgp_tpu_torch.exp.common import filter_kwargs
    return SGPEncoder(**filter_kwargs(SGPEncoder.__init__, {
        **cfg, "input_size": input_size, "seed": SEED, "operator_mode": mode,
        "device": device}))


def sgp_model(cfg, ds, width: int, u_size: int, device, init_state=None):
    """The yaml's decoder, as the runner builds it."""
    import argparse
    from sgp_tpu_torch.exp.run_traffic_sgp import derive_order
    from sgp_tpu_torch.models import SGPModel
    model = SGPModel(
        input_size=width, order=derive_order(argparse.Namespace(**cfg)),
        n_nodes=ds.n_nodes, hidden_size=cfg["hidden_size"],
        mlp_size=cfg["mlp_size"], output_size=ds.n_channels,
        n_layers=cfg["n_layers"], horizon=ds.windowing.horizon_steps,
        positional_encoding=cfg["positional_encoding"],
        emb_size=cfg["emb_size"], exog_size=u_size, resnet=cfg["resnet"],
        fully_connected=cfg["fully_connected"], dropout=cfg["dropout"],
        generator=torch.Generator().manual_seed(SEED))
    if init_state is not None:
        model.load_state_dict(init_state)
    return model.to(device)


def numpy_lanes(target, mask, h_off) -> np.ndarray:
    """The packed target and mask lanes from their definition, as uint16:
    each horizon's f32 target split into its high and low halves, the mask
    as bf16 1.0 (0x3F80) or 0."""
    t, n = target.shape[:2]
    ys = np.stack([np.roll(target, -int(h), 0) for h in h_off], 2)
    ms = np.stack([np.roll(mask, -int(h), 0) for h in h_off], 2)
    v = np.ascontiguousarray(ys, np.float32).view(np.uint32).reshape(t, n, -1)
    return np.concatenate([(v >> 16).astype(np.uint16),
                           (v & 0xFFFF).astype(np.uint16),
                           np.where(ms.reshape(t, n, -1), 0x3F80, 0
                                    ).astype(np.uint16)], -1)


def within_bf16_ulp(a: torch.Tensor, b: torch.Tensor, atol: float) -> bool:
    """Every value of ``a`` within one bf16 ulp of the larger of it and
    ``b``'s, or within ``atol`` of ``b`` (values near 0, whose ulp is below
    the f32 routes' own difference)."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((a - b).abs() <= torch.clamp(ulp, min=atol)).all())


def by_chunks(t_steps: int, fn):
    """``fn(s, e)`` over SGP_CHUNK-step slices (bounds the temporaries of
    comparisons over the whole series)."""
    return [fn(s, min(s + SGP_CHUNK, t_steps))
            for s in range(0, t_steps, SGP_CHUNK)]


def k1_at_encode_width(enc, dense, x, graph, device) -> dict:
    """K1 at the encode's shape (a hop of the first chunk's states, folded
    to F = 64 x 128) against its plain version, interleaved CUDA-event
    times, the bound, cuSPARSE's BSR product and the dense operator's hop
    (one torch.matmul) on the same states."""
    from sgp_tpu_torch.encode import build_streaming_ops, reservoir_scan
    from sgp_tpu_torch.ops import bsr_spmm, bsr_spmm_plain
    op = build_streaming_ops(enc, graph, device=device)[0]
    dense_op = build_streaming_ops(dense, graph, device=device)[0]
    hc = reservoir_scan(enc.reservoir.layers, enc.reservoir.activation,
                        x[:SGP_CHUNK])                   # [64, N, 128]
    n = hc.shape[1]
    folded = hc.transpose(0, 1).reshape(n, -1).contiguous()   # as the op
    args = (op.blocks, op.block_cols, op.row_ptr, op.block_rows)
    n_br = op.row_ptr.numel() - 1

    def plain():
        return bsr_spmm_plain(op.blocks, op.block_cols, op.block_rows, n_br,
                              folded)
    got, again, ref = bsr_spmm(*args, folded), bsr_spmm(*args, folded), \
        plain()
    torch.cuda.synchronize()
    abs_err, rel = rel_err(got, ref)
    bias = ((got - ref).mean() / ref.abs().max()).item()
    k_ms, p_ms = interleaved_ms(lambda: bsr_spmm(*args, folded), plain,
                                3, 10, plain_iters=2)
    f = folded.shape[1]
    row = dict(case="encode hop", n=n, f=f, nnzb=op.blocks.shape[0],
               dtype="float32", max_abs_err=abs_err, rel_err=rel,
               tol=TOL_F32, out_mean_err=bias,
               bitwise_repeat=torch.equal(got, again), ms=k_ms["median"],
               q1_q3=[k_ms["q1"], k_ms["q3"]], plain_ms=p_ms["median"],
               plain_q1_q3=[p_ms["q1"], p_ms["q3"]],
               dense_tile_gflop=2 * op.blocks.numel() * f / 1e9)
    row.update(k1_bound(op, folded))
    row["library_ms"], lib_out = library_bsr(op, folded)
    if row["library_ms"] is None:
        row["library_note"] = lib_out
    else:
        row["library_max_abs_err"] = rel_err(lib_out, ref)[0]
    del lib_out
    row["dense_operator_ms"] = cuda_ms(lambda: dense_op @ hc, 10)
    row["bsr_operator_ms"] = cuda_ms(lambda: op @ hc, 10)
    row["dense_operator_rel_err"] = rel_err(
        (dense_op @ hc).transpose(0, 1).reshape(n, -1), ref)[1]
    print(f"[phase 11] {json.dumps(row)}")
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert rel <= TOL_F32, f"K1 disagrees with plain at F {f}: {row}"
    assert row["bitwise_repeat"], f"two calls differ: {row}"
    assert abs(bias) <= TOL_K1_BIAS, f"K1 output is biased: {row}"
    assert row["dense_operator_rel_err"] <= TOL_F32, row
    return row


def sgp_train_call_profile(multi, gen, call_ms: float):
    """A multi-step call under torch.profiler: ``(device busy per call and
    the idle share against the unprofiled median call, its mean loss)``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss = float(multi(gen))
        torch.cuda.synchronize()
    busy = device_busy(prof, 1)
    if not busy:
        return {"idle_share": "not measured (no device activity traced)"}, \
            loss
    return {"idle_share": 1.0 - busy["device_busy_ms"] / call_ms,
            **busy}, loss


def phase11_sgp(raw, graph, device) -> dict:
    """The SGP main path at the sgp_pv.yaml widths: the streaming packed
    encode through K1, packed IID training, the fused evaluation, then the
    runner end to end on both operator routes."""
    from sgp_tpu_torch.encode import (encoder_input_array, reservoir_scan,
                                      rewire_exog_keys, streaming_encode)
    from sgp_tpu_torch.ops import bsr_spmm
    from sgp_tpu_torch.train import MaskedMetrics
    from sgp_tpu_torch.train.fused_window import make_fused_eval
    from sgp_tpu_torch.train.iid import (make_fused_iid_multi_step,
                                         make_fused_iid_step, pack_iid_data)
    from sgp_tpu_torch.train.predictor import clip_by_global_norm_
    cpu = torch.device("cpu")
    cfg, ds, split = sgp_setup(raw, graph)
    x = torch.as_tensor(encoder_input_array(ds, cfg["preprocess_exogenous"]),
                        device=device)
    tgt = torch.as_tensor(ds.target, device=device)
    mask = torch.as_tensor(ds.mask, device=device)
    h_off = ds.windowing.horizon_offsets()
    lanes = pack_iid_data(torch.zeros(tgt.shape[:2] + (0,),
                                      dtype=torch.bfloat16, device=device),
                          tgt, mask, h_off)
    enc = sgp_encoder(cfg, x.shape[-1], "bsr", device)
    d, t_steps = enc.output_size, ds.n_steps
    n_chunks = -(-t_steps // SGP_CHUNK)

    # 1. the encode, K1's launches counted (the main path)
    torch.cuda.synchronize()
    bsr_spmm.launches = 0
    t0 = time.perf_counter()
    packed = streaming_encode(enc, x, graph, time_chunk=SGP_CHUNK,
                              extra_lanes=lanes)
    torch.cuda.synchronize()
    encode_ms = [(time.perf_counter() - t0) * 1e3]
    launches = bsr_spmm.launches
    hops = cfg["receptive_field"] * (2 if cfg["bidirectional"] else 1)
    print(f"[phase 11] streaming packed encode: {tuple(packed.shape)} "
          f"{packed.dtype} ({packed.numel() * 2 / 1e9:.3f} GB), "
          f"bsr_spmm launches {launches} ({n_chunks} chunks of "
          f"{SGP_CHUNK} steps x {hops} hops)")
    assert launches == n_chunks * hops, launches
    t0 = time.perf_counter()
    again = streaming_encode(enc, x, graph, time_chunk=SGP_CHUNK,
                             extra_lanes=lanes)
    torch.cuda.synchronize()
    encode_ms.append((time.perf_counter() - t0) * 1e3)
    same_bits = torch.equal(again.view(torch.int16), packed.view(torch.int16))
    del again, lanes
    t0 = time.perf_counter()
    reservoir_scan(enc.reservoir.layers, enc.reservoir.activation, x)
    torch.cuda.synchronize()
    scan_ms = (time.perf_counter() - t0) * 1e3

    # the same encode in f32 through K1 and through the dense operator
    dense = sgp_encoder(cfg, x.shape[-1], "dense", device)
    f32 = {}
    for name, e in (("bsr", enc), ("dense", dense)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f32[name] = streaming_encode(e, x, graph, time_chunk=SGP_CHUNK,
                                     out_dtype=torch.float32)
        torch.cuda.synchronize()
        f32[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
    top = max(by_chunks(t_steps, lambda s, e: f32["dense"][s:e].abs().max()
                        .item()))
    route_err = max(by_chunks(t_steps, lambda s, e: (
        f32["bsr"][s:e] - f32["dense"][s:e]).abs().max().item())) / top
    rounded = all(by_chunks(t_steps, lambda s, e: torch.equal(
        packed[s:e, :, :d], f32["bsr"][s:e].to(torch.bfloat16))))
    ulp_ok = all(by_chunks(t_steps, lambda s, e: within_bf16_ulp(
        packed[s:e, :, :d], f32["dense"][s:e], TOL_F32 * top)))
    flipped = sum(by_chunks(t_steps, lambda s, e: int((
        packed[s:e, :, :d] != f32["dense"][s:e].to(torch.bfloat16)).sum())))
    enc_cpu = sgp_encoder(cfg, x.shape[-1], "bsr", cpu)
    t0 = time.perf_counter()
    on_cpu = streaming_encode(enc_cpu, x[:SGP_CPU_STEPS].cpu(), graph,
                              time_chunk=SGP_CPU_CHUNK,
                              out_dtype=torch.float32)
    cpu_s = time.perf_counter() - t0
    cpu_err = rel_err(f32["bsr"][:SGP_CPU_STEPS].cpu(), on_cpu)[1]
    lanes_exact = np.array_equal(
        packed[..., d:].contiguous().view(torch.int16).cpu().numpy().view(
            np.uint16), numpy_lanes(ds.target, ds.mask, h_off))
    print(f"[phase 11] encode wall ms (host clock, synchronized): first "
          f"{encode_ms[0]:.1f}, second {encode_ms[1]:.1f} (same bits: "
          f"{same_bits}); the reservoir scan alone {scan_ms:.1f} ms; f32 "
          f"encodes: BSR {f32['bsr_ms']:.1f} ms, dense {f32['dense_ms']:.1f}"
          f" ms; BSR vs dense route, f32: max rel err {route_err:.3e} (tol "
          f"{TOL_F32}); packed features = bf16 of the f32 BSR encode bit for"
          f" bit: {rounded}; within one bf16 ulp of the dense route (or "
          f"{TOL_F32} of its largest value): {ulp_ok}, {flipped} of "
          f"{t_steps * ds.n_nodes * d} bf16 features rounded the other way;"
          f" card vs CPU port, first {SGP_CPU_STEPS} steps in "
          f"chunks of {SGP_CPU_CHUNK} ({cpu_s:.1f} s on the CPU): max rel "
          f"err {cpu_err:.3e} (tol {TOL_F32}); target and mask lanes equal "
          f"the numpy reference bit for bit: {lanes_exact}")
    assert torch.isfinite(f32["bsr"]).all(), "non-finite encoding"
    assert route_err <= TOL_F32 and rounded and ulp_ok
    assert cpu_err <= TOL_F32 and lanes_exact
    k1 = k1_at_encode_width(enc, dense, x, graph, device)
    del f32, on_cpu, dense
    k1.update(launches=launches, encode_ms=encode_ms, scan_ms=scan_ms,
              k1_share=launches * k1["ms"] / encode_ms[1],
              scan_share=scan_ms / encode_ms[1])
    print(f"[phase 11] of the second encode's {encode_ms[1]:.1f} ms: K1 "
          f"{launches} x {k1['ms']:.4f} ms = {k1['k1_share']:.1%}, the "
          f"reservoir scan {k1['scan_share']:.1%} (the host launches the "
          f"scan while the card runs K1, so the shares overlap)")
    beside_recorded("phase 11", "bsr_spmm_encode", k1)

    # 2. packed IID training
    rewire_exog_keys(ds, cfg["preprocess_exogenous"], cfg["keep_raw"])
    u = torch.as_tensor(np.ascontiguousarray(ds.exog_array()),
                        dtype=torch.float32, device=device)
    model = sgp_model(cfg, ds, d, u.shape[-1], device)
    init_state = {k: v.detach().clone() for k, v in
                  model.state_dict().items()}
    opt = torch.optim.Adam(model.parameters(), lr=cfg["lr"], eps=1e-8)
    valid = ds.indices()[split.train]
    common = dict(batch_size=cfg["batch_size"], grad_clip=GRAD_CLIP)
    multi = make_fused_iid_multi_step(
        model, opt, None, tgt, mask, valid, h_off,
        ds.scaler_params(device=device), u=u, packed=packed,
        steps_per_call=SGP_STEPS_PER_CALL, **common)
    draws = multi.single.sample_and_loss.sample(
        torch.Generator(device=device).manual_seed(SEED + 1))
    packed_cpu = packed.cpu()
    firsts = {}
    for where, dev, m in (
            ("card", device, model),
            ("cpu", cpu, sgp_model(cfg, ds, d, u.shape[-1], cpu,
                                   {k: v.cpu() for k, v in
                                    init_state.items()}))):
        step = multi.single if where == "card" else make_fused_iid_step(
            m, torch.optim.Adam(m.parameters()), None, tgt.cpu(),
            mask.cpu(), valid, h_off, ds.scaler_params(), u=u.cpu(),
            packed=packed_cpu, **common)
        loss = step.sample_and_loss.loss(*(t.to(dev) for t in draws))
        loss.backward()
        clip_by_global_norm_([p.grad for p in m.parameters()], GRAD_CLIP)
        firsts[where] = (float(loss), {k: p.grad.detach().cpu().clone()
                                       for k, p in m.named_parameters()})
        m.zero_grad(set_to_none=True)
    (l_card, g_card), (l_cpu, g_cpu) = firsts["card"], firsts["cpu"]
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    grad_err = max(rel_err(g_card[k], g_cpu[k])[1] for k in g_card)
    print(f"[phase 11] card vs CPU port, first step on the same "
          f"{cfg['batch_size']} draws: loss {l_card:.6f}, rel err "
          f"{loss_err:.3e} (tol {TOL_LOSS}); clipped gradients max rel err "
          f"{grad_err:.3e} (tol {TOL_GRAD})")
    assert loss_err <= TOL_LOSS and grad_err <= TOL_GRAD
    gen = torch.Generator(device=device).manual_seed(SEED)
    losses, call_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(SGP_CALLS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(multi(gen)))
        call_ms.append((time.perf_counter() - t0) * 1e3)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    median_ms = float(np.median(call_ms[1:]))
    prof, last = sgp_train_call_profile(multi, gen, median_ms)
    losses.append(last)
    train = dict(losses=losses, call_ms=call_ms,
                 batch_per_s=SGP_STEPS_PER_CALL / median_ms * 1e3,
                 peak_mib=peak_mib, **prof)
    print(f"[phase 11] fused IID training, {SGP_CALLS} calls of "
          f"{SGP_STEPS_PER_CALL} steps (the last under torch.profiler), "
          f"batch {cfg['batch_size']}: {json.dumps(train)}")
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], f"the loss did not fall: {losses}"

    # 3. the fused evaluation on the test split, from the packed rows
    test_items = ds.indices()[split.test]
    eval_args = (tgt, mask, test_items, ds.windowing.window_offsets(),
                 h_off)
    metrics = make_fused_eval(
        model, packed, *eval_args, ds.scaler_params(device=device),
        MaskedMetrics.forecasting(), u=u, batch_size=cfg["batch_inference"],
        x_slice=d)()
    few = test_items[:SGP_EVAL_BATCHES * cfg["batch_inference"]]
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    few_metrics = {}
    for where, dev, m, arrays in (
            ("card", device, model, (packed, tgt, mask, u)),
            ("cpu", cpu, sgp_model(cfg, ds, d, u.shape[-1], cpu, state),
             (packed_cpu, tgt.cpu(), mask.cpu(), u.cpu()))):
        few_metrics[where] = make_fused_eval(
            m, arrays[0], arrays[1], arrays[2], few, *eval_args[3:],
            ds.scaler_params(device=dev), MaskedMetrics.forecasting(),
            u=arrays[3], batch_size=cfg["batch_inference"], x_slice=d)()
    eval_err = max(abs(few_metrics["card"][k] - v) / abs(v)
                   for k, v in few_metrics["cpu"].items())
    print(f"[phase 11] fused eval on the {len(test_items)} test windows: "
          f"{json.dumps(metrics)}; card vs CPU port on the first "
          f"{len(few)} ({SGP_EVAL_BATCHES} batches): max rel err "
          f"{eval_err:.3e} (tol {TOL_EVAL})")
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert eval_err <= TOL_EVAL, few_metrics
    del packed, packed_cpu, multi, model, opt, x, tgt, mask, u
    torch.cuda.empty_cache()

    # 4. the runner end to end, as parsed (auto: dense at this size), with
    # operator_mode = "bsr" set on the parsed namespace, and two witnesses
    # of the routes' gap: the untrained model (--epochs 0) and the dense
    # route with a share of its bf16 features moved by one ulp
    print(f"[phase 11] the runner at seeds {SGP_RUNNER_SEEDS} only (seed 1 "
          f"cut: the script's time limit)")
    with cached_datasets("phase 11"):
        runs = {seed: sgp_runner_runs(seed, device)
                for seed in SGP_RUNNER_SEEDS}
    for seed, res in runs.items():
        print(f"[phase 11] run_experiment seed {seed}: {json.dumps(res)}")
    gaps = {seed: {k: abs(res[k]["test_mae"] - res["auto"]["test_mae"])
                   / res["auto"]["test_mae"] for k in ("bsr", "flipped")}
            for seed, res in runs.items()}
    by_seed = {k: ", ".join(f"{g[k]:.3e}" for g in gaps.values())
               for k in ("bsr", "flipped")}
    print(f"[phase 11] test MAE gap to the dense route at seeds "
          f"{SGP_RUNNER_SEEDS}: the BSR route {by_seed['bsr']}; the dense "
          f"route with {SGP_FLIP_SHARE:g} of its bf16 features one ulp off "
          f"{by_seed['flipped']} (printed, held to no limit)")
    for res in runs.values():
        for route, r in res.items():
            assert all(np.isfinite(r[f"test_{k}"])
                       for k in ("mae", "mse", "mape")), (route, r)
            if route != "untrained":
                assert r["test_mae"] < res["untrained"]["test_mae"], res
            assert r["launches"] == (n_chunks * hops if route == "bsr"
                                     else 0), (route, r)
    k1["train"], k1["runner_gaps"] = train, gaps
    return k1


def sgp_runner_runs(seed: int, device) -> dict:
    """``run_experiment`` on the sgp_pv.yaml namespace at one seed:
    ``untrained`` (--epochs 0), ``auto`` (as parsed: dense at this size),
    ``bsr`` (``operator_mode = "bsr"`` set on the namespace) and
    ``flipped`` (as ``auto``, its packed encoding with ``SGP_FLIP_SHARE``
    of the bf16 feature values moved by one ulp, the share of them that
    the two routes round differently). Each run's test metrics, K1
    launches and wall time."""
    import sgp_tpu_torch.exp.run_largescale_sgp as runner
    from sgp_tpu_torch.exp.common import Experiment
    from sgp_tpu_torch.ops import bsr_spmm
    encode = runner.streaming_encode

    def flipped_encode(encoder, *args, **kwargs):
        packed = encode(encoder, *args, **kwargs)
        d = encoder.output_size
        rows = packed.view(torch.int16).view(-1, packed.shape[-1])
        n_flip = round(SGP_FLIP_SHARE * rows.shape[0] * d)
        gen = torch.Generator(device=packed.device).manual_seed(seed)
        at = torch.randint(0, rows.shape[0] * d, (n_flip,), generator=gen,
                           device=packed.device)
        rows[at // d, at % d] ^= 1   # the lowest mantissa bit: one ulp
        return packed

    def bsr_route(args):
        args.operator_mode = "bsr"
        return runner.run_experiment(args)

    argv = ["--config", str(CONFIG), "--dataset-name", "synthetic",
            "--synthetic-nodes", str(N_NODES), "--synthetic-steps",
            str(N_STEPS), "--seed", str(seed), "--device", str(device)]
    trained = ["--epochs", str(SGP_RUNNER_EPOCHS)]
    out = {}
    for route, fn, flags in (
            ("untrained", runner.run_experiment, ["--epochs", "0"]),
            ("auto", runner.run_experiment, trained),
            ("bsr", bsr_route, trained),
            ("flipped", runner.run_experiment, trained)):
        bsr_spmm.launches = 0
        t0 = time.perf_counter()
        if route == "flipped":
            runner.streaming_encode = flipped_encode
        try:
            res = Experiment(
                fn, runner.configure_parser_largescale()).run(argv + flags)
        finally:
            runner.streaming_encode = encode
        out[route] = dict(res, launches=bsr_spmm.launches,
                          wall_s=time.perf_counter() - t0)
    return out


class RunRecorder:
    """Instruments one runner run from outside: each ``train_step``'s
    synchronized host time and loss; the first step's trainer, host batch,
    weights before it and clipped gradients after it; the first
    ``PROFILE_STEPS + 1`` host batches; each loader's host ms a batch
    (``next`` of its iterator: sampling and gather); and the subgraph
    sampler's ms a call."""

    def __init__(self, device):
        self.device = device
        self.steps, self.batches, self.first = [], [], None
        self.loader_ms, self.sample_ms = {}, []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def patch(self):
        from sgp_tpu_torch.data import SubgraphLoader, WindowedLoader
        from sgp_tpu_torch.train import Predictor
        rec = self
        step, sample = Predictor.train_step, SubgraphLoader._sample_subgraph

        def train_step(pred, batch):
            init = None if rec.first else {
                k: v.detach().cpu().clone()
                for k, v in pred.model.state_dict().items()}
            rec._sync()
            t0 = time.perf_counter()
            loss = float(step(pred, batch))        # synchronizes
            rec.steps.append(((time.perf_counter() - t0) * 1e3, loss))
            if init is not None:
                rec.first = dict(pred=pred, batch=batch, init=init,
                                 loss=loss, grads={
                                     k: p.grad.detach().cpu().clone()
                                     for k, p in
                                     pred.model.named_parameters()})
            if len(rec.batches) <= PROFILE_STEPS:
                rec.batches.append(batch)
            return torch.tensor(loss)

        def timed_iter(orig):
            def it(loader):
                times = rec.loader_ms.setdefault(loader, [])
                gen = orig(loader)
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(gen)
                    except StopIteration:
                        return
                    times.append((time.perf_counter() - t0) * 1e3)
                    yield batch
            return it

        def sample_subgraph(loader):
            t0 = time.perf_counter()
            out = sample(loader)
            rec.sample_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        saved = [(Predictor, "train_step", step),
                 (SubgraphLoader, "_sample_subgraph", sample),
                 (SubgraphLoader, "__iter__", SubgraphLoader.__iter__),
                 (WindowedLoader, "__iter__", WindowedLoader.__iter__)]
        Predictor.train_step = train_step
        SubgraphLoader._sample_subgraph = sample_subgraph
        SubgraphLoader.__iter__ = timed_iter(SubgraphLoader.__iter__)
        WindowedLoader.__iter__ = timed_iter(WindowedLoader.__iter__)
        try:
            yield self
        finally:
            for cls, name, fn in saved:
                setattr(cls, name, fn)

    def train_loader_ms(self) -> list:
        """Host ms a batch of the train loader (the shuffled one)."""
        return [t for ld, ts in self.loader_ms.items()
                if getattr(ld, "shuffle", False) for t in ts]


def operator_on_cpu(op):
    """A diffusion support as the same matrix, dense on the CPU: the COO
    supports of a subgraph batch gather and scatter every edge row by row
    there, slower than one matrix product at the CPU steps' node counts."""
    from sgp_tpu_torch.ops import COOOperator, DenseOperator
    if isinstance(op, DenseOperator):
        return DenseOperator(op.mat.cpu(), op.precision)
    assert isinstance(op, COOOperator), type(op)
    n = op.num_nodes
    mat = torch.zeros((n, n), dtype=op.weight.dtype)
    mat.index_put_((op.dst.long().cpu(), op.src.long().cpu()),
                   op.weight.cpu(), accumulate=True)
    return DenseOperator(mat)


def supports_on_cpu(call):
    """``call`` with the supports it hands the model (a list after x) made
    dense on the CPU by :func:`operator_on_cpu`."""
    def on_cpu(batch, training):
        args, kwargs = call(batch, training)
        if len(args) > 1 and isinstance(args[1], list):
            args = (args[0], [operator_on_cpu(op) for op in args[1]])
        return args, kwargs
    return on_cpu


def no_dropout(model):
    """``model`` with every dropout off (the card's and the CPU's dropout
    draws differ); returns it."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def has_dropout(model) -> bool:
    return any(isinstance(m, torch.nn.Dropout) and m.p > 0
               for m in model.modules())


def _cpu_trainer(pred, init: dict, dtype=torch.float32, device="cpu",
                 dropout: bool = True):
    """A copy of the card's trainer ``pred`` on ``device`` (default the
    CPU): its settings, call and graph state (diffusion supports by
    :func:`operator_on_cpu`), the weights ``init``, its model and scaler in
    ``dtype``; without dropout unless ``dropout``."""
    import copy
    from sgp_tpu_torch.data.scalers import ScalerParams
    from sgp_tpu_torch.train import Predictor
    static, call = dict(pred.static_batch), pred.batch_to_call
    if "supports" in static and torch.device(device).type == "cpu":
        static["supports"] = [operator_on_cpu(op)
                              for op in static["supports"]]
        call = supports_on_cpu(call)
    model = copy.deepcopy(pred.model).to(device, dtype)
    cpu = Predictor(model if dropout else no_dropout(model),
                    loss=pred.loss_kind, lr=pred.lr,
                    weight_decay=pred.weight_decay, grad_clip=pred.grad_clip,
                    scale_target=pred.scale_target, metrics=pred.metrics,
                    batch_to_call=call, seed=pred.seed,
                    static_batch=static, device=device)
    cpu.init(None, ScalerParams(pred.scaler.bias.to(dtype),
                                pred.scaler.scale.to(dtype)))
    cpu.model.load_state_dict(init)
    return cpu


def runner_cpu_step(first: dict, tol: float, reference=None,
                    phase: str = "phase 12") -> dict:
    """The run's first train step again by the port on the CPU (the card's
    trainer settings, call, graph state, weights and host batch): the loss
    held to the card's within ``tol`` relative, and each clipped gradient
    within ``tol`` of its largest value or, failing that, no further from
    the ``reference`` gradients than ``RUNNER_SLACK`` times the CPU port's
    distance from them, plus ``TOL_GRAD``. Without a given reference, the
    step is taken in float64 on the CPU when a gradient is beyond ``tol``
    (sums over millions of edges or recurrent steps in another order; an
    edge-list GatedGN's and the LSTM's cuDNN bias sums showed such
    gaps). A model with dropout takes the step
    without it on both devices (their draws differ), the card's again from
    the same weights and batch. Gradients are held by :func:`grad_errors`;
    for a model with an MLPDecoder (the diffusion and recurrent baselines)
    both steps record the decoder's pre-activations, and a gap that
    :func:`kink_flips` explains passes; they record the masked MAE's signs
    too (:func:`loss_hook`), and a readout bias passes when its gap lies
    within ``tol`` of its largest value plus 2 x scale / M for each sign
    the two runs take the other way (:func:`mae_sign_flips`)."""
    card_loss, card_grads = first["loss"], first["grads"]
    dropout = has_dropout(first["pred"].model)
    pre = {"card": [], "cpu": []}
    signs = {"card": [], "cpu": []}
    if dropout or hasattr(first["pred"].model, "decoder"):
        card = _cpu_trainer(first["pred"], first["init"],
                            device=first["pred"].device, dropout=False)
        decoder_hook(card.model, pre["card"])
        loss_hook(card, signs["card"])
        card_loss = float(card.train_step(first["batch"]))
        card_grads = {k: p.grad.detach().cpu() for k, p in
                      card.model.named_parameters()}
    cpu = _cpu_trainer(first["pred"], first["init"], dropout=False)
    decoder_hook(cpu.model, pre["cpu"])
    loss_hook(cpu, signs["cpu"])
    t0 = time.perf_counter()
    loss = float(cpu.train_step(first["batch"]))
    cpu_s = time.perf_counter() - t0
    grads = {k: p.grad for k, p in cpu.model.named_parameters()}
    loss_err = abs(loss - card_loss) / abs(loss)
    errs = grad_errors(card_grads, grads)
    out = {"cpu_s": cpu_s, "loss_rel_err": loss_err, "tol": tol,
           "grad_max_rel_err": max(errs.values()),
           "worst": sorted(errs.items(), key=lambda kv: -kv[1])[:3],
           "dropout": "off on both devices" if dropout else "none"}
    bad = [k for k, e in errs.items() if not e <= tol]
    if pre["card"]:
        out["kinks"] = kink_flips(pre["card"][0], pre["cpu"][0])
        assert out["kinks"]["pre_activation_rel_err"] <= tol, out
        # the loss's own kinks: a readout bias may move by 2 x scale / M a
        # flipped MAE sign, beyond its gate
        out["kinks"].update(mae_sign_flips(signs["card"][0],
                                           signs["cpu"][0]))
        excuse = out["kinks"]["readout_bias_excuse"]
        excused = [k for k in bad if k.endswith("readout.bias")
                   and (card_grads[k].double() - grads[k].double().cpu()
                        ).abs().max().item()
                   <= tol * grads[k].abs().max().item() + excuse]
        if excused:
            out["kinks"]["excused_by_mae_signs"] = excused
            bad = [k for k in bad if k not in excused]
        if bad and out["kinks"]["explained"]:
            bad = []
    if bad and reference is None:
        f64 = _cpu_trainer(first["pred"], first["init"], torch.float64,
                           dropout=False)
        f64.train_step({k: v.astype(np.float64) if isinstance(
            v, np.ndarray) and v.dtype == np.float32 else v
            for k, v in first["batch"].items()})
        reference = {k: p.grad for k, p in f64.model.named_parameters()}
        out["reference"] = "float64 on the CPU"
    if reference is not None:
        dist = {k: (rel_err(card_grads[k].double(),
                            reference[k].double())[1],
                    rel_err(grads[k].double(), reference[k].double())[1])
                for k in bad}
        out["beyond_tol_from_reference_card_cpu"] = dist
        bad = [k for k, (d_card, d_cpu) in dist.items()
               if not d_card <= RUNNER_SLACK * d_cpu + TOL_GRAD]
    print(f"[{phase}] first step, card vs CPU port: {json.dumps(out)}")
    assert loss_err <= tol and not bad, (loss_err, bad)
    return out


def runner_run(tag, runner, config, flags, kernels, device,
               f32_grads=None, phase: str = "phase 12",
               cpu_nodes: int = None) -> dict:
    """One runner through ``Experiment(...).run(argv)``, its kernels'
    launch counters set to 0 just before and read just after; then the same
    run untrained (``--epochs 0``), the first step on the CPU (a bf16 run's
    held by its f32 twin's first-step gradients ``f32_grads``), and a
    profile of ``PROFILE_STEPS`` steps on its trainer. With ``cpu_nodes``
    the CPU step is that of the same command on a ``cpu_nodes``-node set
    (one batch on the card, then on the CPU): the full set's step is too
    slow there."""
    bf16 = "bfloat16" in flags
    assert not bf16 or f32_grads is not None, "a bf16 run needs its f32 twin"
    from sgp_tpu_torch.exp import (run_largescale_baselines,
                                   run_traffic_baselines)
    from sgp_tpu_torch.exp.common import Experiment
    from sgp_tpu_torch.ops import bsr_spmm, gn_allpairs, gn_ell
    mod = run_traffic_baselines if runner == "traffic" \
        else run_largescale_baselines
    counters = {f.__name__: f for f in (
        gn_ell.gn_ell_fwd, gn_ell.gn_ell_bwd, gn_allpairs.gn_allpairs_fwd,
        gn_allpairs.gn_allpairs_bwd, bsr_spmm)}
    argv = ["--config", str(config)] + RUNNER_ARGS + flags + [
        "--device", str(device)]
    rec = RunRecorder(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with rec.patch():
        res = Experiment(mod.run_experiment,
                         run_traffic_baselines.configure_parser()).run(argv)
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 20 \
        if device.type == "cuda" else "not measured"
    untrained = Experiment(mod.run_experiment,
                           run_traffic_baselines.configure_parser()).run(
        argv + ["--epochs", "0"])
    first = rec.first
    if cpu_nodes:
        small_argv = list(argv)
        small_argv[small_argv.index("--synthetic-nodes") + 1] = str(cpu_nodes)
        small = RunRecorder(device)
        with small.patch():
            Experiment(mod.run_experiment,
                       run_traffic_baselines.configure_parser()).run(
                small_argv + ["--epochs", "1", "--batches-epoch", "1"])
        first = small.first
    cpu = runner_cpu_step(first, TOL_RUNNER_BF16 if bf16 else TOL_LOSS,
                          f32_grads if bf16 else None, phase)
    if cpu_nodes:
        cpu["nodes"] = cpu_nodes
    step_ms = [ms for ms, _ in rec.steps[RUNNER_TIME_DROP:]]
    stats = quartiles(step_ms)
    prof = idle_share(rec.first["pred"], rec.batches, stats["median"]) \
        if device.type == "cuda" else {"idle_share": "not measured"}
    pred = rec.first["pred"]
    row = dict(
        run=tag, argv=" ".join(argv), launches=launches,
        steps=len(rec.steps), losses=[loss for _, loss in rec.steps],
        test={k: v for k, v in res.items()},
        untrained_test_mae=untrained["test_mae"], wall_s=wall,
        step_ms=stats, loader_host_ms=quartiles(rec.train_loader_ms()),
        sample_subgraph_ms=quartiles(rec.sample_ms) if rec.sample_ms
        else None, peak_mib=peak,
        first_step_vs_cpu=cpu,
        batch_nodes=int(rec.first["batch"]["x"].shape[2]),
        batch_edges=int((rec.first["batch"]["sub_weight"] != 0).sum())
        if "sub_weight" in rec.first["batch"] else None, **prof)
    print(f"[{phase}] run {tag}: {json.dumps(row, default=str)}")
    missing = [k for k in kernels if not launches[k] > 0]
    assert not missing, f"run {tag} launched no {missing}: {launches}"
    assert all(np.isfinite(v) for v in res.values()), res
    assert all(np.isfinite(v) for v in untrained.values()), untrained
    assert res["test_mae"] < untrained["test_mae"], \
        (res["test_mae"], untrained["test_mae"])
    row["pred"], row["first_grads"] = pred, first["grads"]
    return row


def k3_at_runner_shape(mask, device, hidden: int) -> dict:
    """K3's forward at run (c)'s evaluation shape (B 1, N 5,016, the full
    similarity graph's mask, a full sweep) against its plain version:
    error, CUDA-event medians and the bound."""
    from sgp_tpu_torch.ops import gn_allpairs
    rng = np.random.default_rng(SEED)
    h, h2 = hidden, hidden // 2
    args, ghat = allpairs_inputs(rng, 1, mask.shape[0], h2, h,
                                 torch.float32, mask, device)
    out = gn_allpairs.gn_allpairs_fwd(*args)
    grads = gn_allpairs.gn_allpairs_bwd(*args, ghat)
    ref = gn_allpairs.gn_allpairs_fwd_plain(*args)
    abs_err, err = rel_err(out, ref)
    bias = ((out - ref).mean() / ref.abs().max()).item()
    k, p = interleaved_ms(lambda: gn_allpairs.gn_allpairs_fwd(*args),
                          lambda: gn_allpairs.gn_allpairs_fwd_plain(*args),
                          2, 10, 1)
    row = dict(case="runner evaluation", b=1, n=mask.shape[0], h2=h2, h=h,
               max_abs_err={"out": abs_err}, rel_err={"out": err},
               out_mean_err=bias, fwd_ms=k["median"],
               fwd_q1_q3=[k["q1"], k["q3"]], fwd_plain_ms=p["median"],
               **allpairs_bounds(args, ghat, out, grads, None))
    print(f"[phase 12] K3 forward at the runner's shape: {json.dumps(row)}")
    assert err <= TOL_AP_F32, f"K3 disagrees with plain at 25 M pairs: {err}"
    return row


def phase12_runners(device) -> dict:
    """The baseline runners through their entry points (``RUNNER_CASES``):
    launches, metrics against the untrained run, the first step against
    the CPU port, host and step times, idle share, peak memory; then K3's
    forward at run (c)'s evaluation shape."""
    runs = {}
    with cached_datasets("phase 12"):
        for tag, runner, config, flags, kernels in RUNNER_CASES:
            t0 = time.perf_counter()
            # a bf16 run starts from its f32 twin's weights and batch
            twin = runs.get(tag.replace(" bf16", ""), {})
            runs[tag] = runner_run(tag, runner, config, flags, kernels,
                                   device, twin.get("first_grads"),
                                   cpu_nodes=RUNNER_CPU_NODES.get(tag))
            print(f"[time] phase 12 run {tag}: "
                  f"{time.perf_counter() - t0:.1f} s")
    pred = runs["c"]["pred"]
    k3 = k3_at_runner_shape(pred.static_batch["gn_adj"], device,
                            read_flat_yaml(FULL_CONFIG)["hidden_size"])
    for row in runs.values():
        del row["pred"], row["first_grads"]
    return dict(runs=runs, k3=k3)


def diffusion_args(name: str, config: Path):
    """The traffic runner's namespace for ``--model-name name`` with the
    config's values, as ``Experiment`` merges them."""
    from sgp_tpu_torch.exp.run_traffic_baselines import configure_parser
    args = configure_parser().parse_args(["--model-name", name])
    for key, value in read_flat_yaml(config).items():
        setattr(args, key, value)
    return args


def diffusion_predictor(args, ds, static, device, init_state=None):
    """The runner's model and call (``build_model_and_forward``) for
    ``args``, trained through ``Predictor`` on the graph state ``static``
    (``{"supports": ...}``, or ``{"op": ...}`` for the GraphConv models);
    weights from ``SEED`` (or ``init_state``)."""
    from sgp_tpu_torch.exp.run_traffic_baselines import \
        build_model_and_forward
    from sgp_tpu_torch.train import Predictor
    u_size = ds.covariates["u"].value.shape[-1]
    model, to_call, _ = build_model_and_forward(args, ds, u_size, device)
    pred = Predictor(model, loss="mae", lr=args.lr, grad_clip=GRAD_CLIP,
                     scale_target=args.scale_target, batch_to_call=to_call,
                     seed=SEED, static_batch=static, device=device)
    pred.init(None, ds.scaler_params())
    if init_state is not None:
        pred.model.load_state_dict(init_state)
    return pred


def k1_launches(name: str, args) -> tuple:
    """K1 launches of one forward and of its backward on BSR supports,
    counted from the code. DCRNN's cell runs ``2 * k`` products a support
    (the ``[x, h]`` hops and the ``r * h`` hops) at every step of the window
    in every layer, each once more backward. GraphWaveNet's DiffConv runs
    ``k`` a support in every layer; the last layer's diffusion output is
    not read (only the skip sum goes on), so the backward skips it."""
    n_sup = 2
    if name == "dcrnn":
        fwd = args.window * args.n_layers * 2 * n_sup * args.kernel_size
        return fwd, fwd
    per_layer = n_sup * args.spatial_kernel_size
    return args.n_layers * per_layer, (args.n_layers - 1) * per_layer


def route_run(tag, name, args, cfg, ds, split, supports, device,
              init_state=None) -> dict:
    """One route's main path: ``Predictor.init``, the model's forward on
    the first test batch (weights as initialized), ``DIFF_STEPS`` train
    steps and ``evaluate``, with K1's launches counted over the steps and
    over the evaluation (set to 0 just before each, read just after)."""
    from sgp_tpu_torch.ops import bsr_spmm
    torch.manual_seed(SEED)     # both routes draw the same dropout masks
    pred = diffusion_predictor(args, ds, {"supports": supports}, device,
                               init_state)
    init = {k: v.detach().clone() for k, v in pred.model.state_dict().items()}
    train_loader, test_loader = loaders(cfg, ds, split, DIFF_STEPS)
    with torch.no_grad():
        first = pred._place(next(iter(test_loader)))
        out0 = pred._forward(first, False).float()
    bsr_spmm.launches = 0
    losses, times, grads0 = train_steps(pred, train_loader, device)
    step_launches = bsr_spmm.launches
    bsr_spmm.launches = 0
    metrics = pred.evaluate(test_loader, prefix="test_")
    eval_launches = bsr_spmm.launches
    print(f"[{tag}] {name} route {supports[0].__class__.__name__}: losses "
          f"{losses}; {json.dumps(metrics)}; K1 launches {step_launches} in "
          f"{DIFF_STEPS} train steps, {eval_launches} in {EVAL_BATCHES} "
          f"evaluate batches")
    assert all(np.isfinite(losses)), f"non-finite loss: {losses}"
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    return dict(pred=pred, init=init, losses=losses, grads0=grads0,
                metrics=metrics, out0=out0, launches=step_launches +
                eval_launches,
                launches_per_step=step_launches / DIFF_STEPS,
                launches_per_eval_batch=eval_launches / EVAL_BATCHES)


def hold_routes(tag, name, bsr: dict, dense: dict) -> dict:
    """The BSR route against the dense one from the same weights, batches
    and dropout draws: the forward on a test batch, the first step's
    gradients, the losses, the evaluation and the final weights."""
    fwd_abs, fwd_rel = rel_err(bsr["out0"], dense["out0"])
    fwd_mean = ((bsr["out0"] - dense["out0"]).mean()
                / dense["out0"].abs().max()).item()
    top = max(g.abs().max().item() for g in dense["grads0"].values())
    grads = {}
    for k, g in dense["grads0"].items():
        scale = g.abs().max().item()
        scale = scale if scale >= ZERO_GRAD * top else top
        d = (bsr["grads0"][k] - g).double()
        grads[k] = (d.abs().max().item() / scale, d.mean().item() / scale)
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(bsr["losses"], dense["losses"]))
    met_err = max(abs(bsr["metrics"][k] - v) / abs(v)
                  for k, v in dense["metrics"].items())
    params = dict(dense["pred"].model.named_parameters())
    held = torch.cat([
        (v - params[k]).detach().abs().cpu()[
            dense["grads0"][k].abs() > GRAD_FLOOR]
        for k, v in bsr["pred"].model.named_parameters()])
    worst = max(grads, key=lambda k: grads[k][0])
    row = dict(forward_max_abs_err=fwd_abs, forward_rel_err=fwd_rel,
               forward_mean_err=fwd_mean, grad_max_rel_err=grads[worst][0],
               grad_worst=worst, grad_mean_err_worst=max(
                   (v[1] for v in grads.values()), key=abs),
               losses_max_rel_err=loss_err, evaluate_max_rel_err=met_err,
               param_max_abs_diff=held.max().item(), tol=TOL_ROUTE,
               tol_param=TOL_PARAM)
    print(f"[{tag}] {name} BSR route vs dense route: {json.dumps(row)}")
    assert fwd_rel <= TOL_ROUTE and grads[worst][0] <= TOL_ROUTE, row
    assert abs(fwd_mean) <= TOL_ROUTE_BIAS, row
    assert loss_err <= TOL_ROUTE and met_err <= TOL_ROUTE, row
    assert row["param_max_abs_diff"] <= TOL_PARAM, row
    return row


def decoder_hook(model, store: list):
    """Record the hidden pre-activations (the input of the relu) of
    ``model.decoder``, an MLPDecoder, into ``store``; the hook's handle, or
    None for a model without one."""
    from sgp_tpu_torch.models import MLPDecoder
    dec = getattr(model, "decoder", None)
    if not isinstance(dec, MLPDecoder):
        return None

    def keep(module, args, out):
        store.append(out.detach().cpu())
    return dec.mlp.layers[0].linear.register_forward_hook(keep)


def loss_hook(pred, store: list):
    """Record, at each loss ``pred`` computes, the masked MAE's residual
    ``(sign, mask, scale)``: the sign of each prediction's error in the
    loss's units, the loss mask, and the scaler's largest scale (one flip
    moves a readout bias's gradient by 2 x scale / M, M the masked
    count)."""
    orig = pred._slice_targets

    def keep(batch, y_hat):
        y_hat, y, mask = orig(batch, y_hat)
        sc = batch.get("scaler", pred.scaler)
        res = (y_hat - sc.transform(y)) if pred.scale_target \
            else (sc.inverse_transform(y_hat) - y)
        m = torch.ones_like(y, dtype=torch.bool) if mask is None \
            else mask.bool()
        store.append((torch.sign(res.detach()).cpu(), m.cpu(),
                      float(sc.scale.abs().max())))
        return y_hat, y, mask
    pred._slice_targets = keep


def mae_sign_flips(card, cpu) -> dict:
    """The masked MAE's signs that two runs of one step (``loss_hook``
    records) take the other way, and what they may move a readout bias's
    gradient by: 2 x scale / M each."""
    (s_card, m, scale), (s_cpu, _, _) = card, cpu
    flips = int(((s_card != s_cpu) & m).sum())
    count = max(int(m.sum()), 1)
    return {"mae_sign_flips": flips, "mae_count": count,
            "readout_bias_excuse": flips * 2.0 * scale / count}


def kink_flips(pre: torch.Tensor, ref: torch.Tensor) -> dict:
    """The decoder pre-activations of two runs of one step: their largest
    difference, the units whose sign differs, and whether those explain a
    gradient gap (``explained``): the pre-activations agree within
    TOL_LOSS of their largest value and at most KINK_UNITS units turn the
    other way, each within the runs' largest difference of 0."""
    flips = (pre > 0) != (ref > 0)
    spread = (pre - ref).abs().max().item()
    out = {"pre_activation_rel_err": spread / ref.abs().max().item(),
           "pre_activation_sign_flips": int(flips.sum()),
           "flipped_pre_activations": pre[flips].tolist()[:KINK_UNITS + 1],
           "pre_activation_max_diff": spread}
    out["explained"] = bool(
        out["pre_activation_rel_err"] <= TOL_LOSS
        and 0 < out["pre_activation_sign_flips"] <= KINK_UNITS
        and all(abs(z) <= spread for z in out["flipped_pre_activations"]))
    return out


def first_step(make, dev, init, loader):
    """One train step of ``make(dev, init)`` on ``loader``'s batch: its loss,
    clipped gradients (on the host) and the decoder's hidden
    pre-activations (the input of its relu)."""
    pred = make(dev, init)
    pre = []
    hook = decoder_hook(pred.model, pre)
    try:
        losses, _, grads = train_steps(pred, loader, dev)
    finally:
        hook.remove()
    return losses[0], grads, pre[0], pred


def grad_errors(got: dict, ref: dict) -> dict:
    """Each gradient's max error relative to its largest value, or, for one
    under ZERO_GRAD of the model's largest (0 in exact arithmetic), to the
    model's largest."""
    top = max(g.abs().max().item() for g in ref.values())
    out = {}
    for k, g in ref.items():
        scale = g.abs().max().item()
        scale = scale if scale >= ZERO_GRAD * top else top
        out[k] = (got[k].double() - g.double()).abs().max().item() / \
            max(scale, 1e-30)
    return out


def diffusion_cpu_step(tag, make, loader, device, what: str):
    """The first step on the card (K1) against the port on the CPU from the
    same weights and batch: the loss within TOL_LOSS, each gradient within
    TOL_GRAD (:func:`grad_errors`). A relu turns at a kink: where the
    decoder's hidden pre-activation lies within the two runs' rounding of
    0, a unit passes on one device and not on the other, and the gradients
    then differ by that unit's share; so a gradient beyond TOL_GRAD passes
    only when :func:`kink_flips` explains it."""
    cpu = torch.device("cpu")
    init = {k: v.detach().clone() for k, v in make(
        device).model.state_dict().items()}
    loss, grads, pre, _ = first_step(make, device, init, loader())
    t0 = time.perf_counter()
    c_loss, c_grads, c_pre, _ = first_step(
        make, cpu, {k: v.cpu() for k, v in init.items()}, loader())
    cpu_s = time.perf_counter() - t0
    errs = grad_errors(grads, c_grads)
    worst = sorted(errs, key=errs.get)[-3:]
    row = {"what": what, "cpu_s": cpu_s,
           "loss_rel_err": abs(loss - c_loss) / abs(c_loss),
           "grad_max_rel_err": max(errs.values()),
           "worst": [(k, errs[k]) for k in worst], "tol_loss": TOL_LOSS,
           "tol_grad": TOL_GRAD, **kink_flips(pre, c_pre)}
    print(f"[{tag}] first step, card (K1) vs CPU port: {json.dumps(row)}")
    assert row["loss_rel_err"] <= TOL_LOSS, row
    assert row["pre_activation_rel_err"] <= TOL_LOSS, row
    assert row["grad_max_rel_err"] <= TOL_GRAD or row["explained"], row
    return row


def diffusion_main_path(tag, name, config, raw, graph, device) -> dict:
    """``name`` at ``config``'s widths on phase 5's data through
    ``Predictor`` and the runner's call, on BSR supports (K1) and on dense
    ones from the same weights, held to each other; K1's launches held to
    the count from the code; the first step against the port on the CPU
    (a ragged ``DIFF_CPU_NODES``-node set at the same k, dropout off);
    step times, peak memory and idle share of both routes."""
    from sgp_tpu_torch.data.datasets import SyntheticDiffusion
    from sgp_tpu_torch.models import diff_conv_support
    cfg, ds, split = gn_data(raw, graph, config)
    args = diffusion_args(name, config)
    routes = {mode: diff_conv_support(graph, operator_mode=mode,
                                      device=device)
              for mode in ("bsr", "dense")}
    print(f"[{tag}] {name}: {ds.n_nodes} nodes, {routes['bsr'][0].blocks.shape[0]}"
          f" tiles a support, window {args.window}, batch "
          f"{args.batch_size} (evaluate {args.batch_inference}), hidden "
          f"{args.hidden_size}, ff {args.ff_size}, {args.n_layers} layers, "
          f"dropout {args.dropout} (the same draws on both routes)")
    bsr = route_run(tag, name, args, cfg, ds, split, routes["bsr"], device)
    dense = route_run(tag, name, args, cfg, ds, split, routes["dense"],
                      device, bsr["init"])
    fwd, bwd = k1_launches(name, args)
    want = {"launches_per_step": fwd + bwd, "launches_per_eval_batch": fwd}
    for key, n in want.items():
        print(f"[{tag}] {name} K1 {key}: {bsr[key]} (counted from the code: "
              f"{n}); dense route {dense[key]}")
        assert bsr[key] == n and dense[key] == 0, (key, bsr[key], dense[key])
    held = hold_routes(tag, name, bsr, dense)

    small = SyntheticDiffusion(num_nodes=DIFF_CPU_NODES, num_steps=N_STEPS,
                               seed=SEED)
    s_graph = small.get_connectivity(knn=KNN, threshold=None,
                                     include_self=False)
    s_cfg, s_ds, s_split = gn_data(small, s_graph, config)
    s_args = diffusion_args(name, config)
    s_args.dropout = 0.0

    def make(dev, init=None):
        sup = diff_conv_support(s_graph, operator_mode="bsr", device=dev)
        return diffusion_predictor(s_args, s_ds, {"supports": sup}, dev,
                                   init)
    diffusion_cpu_step(tag, make, lambda: loaders(s_cfg, s_ds, s_split,
                                                  1)[0], device,
                       f"{name} on {DIFF_CPU_NODES} nodes, "
                       f"{s_graph.num_edges} edges, BSR supports, dropout 0")
    time_steps(tag, {"bsr": (bsr["pred"], contextlib.nullcontext),
                     "dense": (dense["pred"], contextlib.nullcontext)},
               cfg, ds, split, DIFF_TIME_ORDER, DIFF_TIME_STEPS, device)
    return dict(launches=bsr["launches"], per_step=bsr["launches_per_step"],
                per_eval_batch=bsr["launches_per_eval_batch"], held=held)


def k1_at_diffconv_widths(graph, device) -> dict:
    """K1 at DiffConv's hop widths (``DIFF_WIDTHS``) on the 100-nn graph's
    forward support against its plain version: the max and mean signed
    error, interleaved CUDA-event times, the bound, and the two library
    yardsticks on the same inputs (cuSPARSE's BSR product, the dense
    operator's matmul)."""
    from sgp_tpu_torch.models import diff_conv_support
    from sgp_tpu_torch.ops import bsr_spmm, bsr_spmm_plain
    op = diff_conv_support(graph, False, "bsr", device=device)[0]
    dense = diff_conv_support(graph, False, "dense", device=device)[0]
    args = (op.blocks, op.block_cols, op.row_ptr, op.block_rows)
    n, n_br = graph.num_nodes, op.row_ptr.numel() - 1
    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = {}
    for f in DIFF_WIDTHS:
        x = torch.randn((n, f), generator=gen, device=device)

        def plain():
            return bsr_spmm_plain(op.blocks, op.block_cols, op.block_rows,
                                  n_br, x)
        got, again, ref = bsr_spmm(*args, x), bsr_spmm(*args, x), plain()
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got, ref)
        bias = ((got - ref).mean() / ref.abs().max()).item()
        k_ms, p_ms = interleaved_ms(lambda: bsr_spmm(*args, x), plain, 3,
                                    10, plain_iters=3)
        row = dict(case=f"diffconv hop F {f}", n=n, f=f,
                   nnzb=op.blocks.shape[0], dtype="float32",
                   max_abs_err=abs_err, rel_err=rel, tol=TOL_F32,
                   out_mean_err=bias, bitwise_repeat=torch.equal(got, again),
                   ms=k_ms["median"], q1_q3=[k_ms["q1"], k_ms["q3"]],
                   plain_ms=p_ms["median"],
                   plain_q1_q3=[p_ms["q1"], p_ms["q3"]])
        row.update(k1_bound(op, x))
        row["library_ms"], lib_out = library_bsr(op, x)
        if row["library_ms"] is None:
            row["library_note"] = lib_out
        else:
            row["library_max_abs_err"] = rel_err(lib_out, ref)[0]
        row["dense_operator_ms"] = cuda_ms(lambda: dense.mat @ x, 10)
        print(f"[phase 13] K1: {json.dumps(row)}")
        assert got.shape == ref.shape and torch.isfinite(got).all()
        assert rel <= TOL_F32, f"K1 disagrees with plain at F {f}: {row}"
        assert row["bitwise_repeat"], f"two calls differ: {row}"
        assert abs(bias) <= TOL_K1_BIAS, f"K1 output is biased: {row}"
        rows[f] = row
    return rows


def phase13_diffusion(raw, graph, device) -> dict:
    """The diffusion baselines: DCRNN and GraphWaveNet at their configs'
    widths on both support routes (K1 on BSR), K1 at their hop widths,
    then the runners from their command lines (``DIFF_RUNNER_CASES``)."""
    out = {}
    for name, config in (("dcrnn", DCRNN_CONFIG), ("gwnet", GWNET_CONFIG)):
        t0 = time.perf_counter()
        out[name] = diffusion_main_path(f"phase 13 {name}", name, config,
                                        raw, graph, device)
        print(f"[time] phase 13 {name}: {time.perf_counter() - t0:.1f} s")
    out["k1"] = k1_at_diffconv_widths(graph, device)
    out["runs"] = {}
    with cached_datasets("phase 13"):
        for tag, runner, config, flags in DIFF_RUNNER_CASES:
            t0 = time.perf_counter()
            # the LSTM's cuDNN backward at batch 64 x 5,016 series asks for
            # one 40 GiB workspace: hand the cache's free blocks back first
            torch.cuda.empty_cache()
            row = runner_run(tag, runner, config, flags, (), device,
                             phase="phase 13", cpu_nodes=DIFF_CPU_NODES)
            del row["pred"], row["first_grads"]
            out["runs"][tag] = row
            print(f"[time] phase 13 run {tag}: "
                  f"{time.perf_counter() - t0:.1f} s")
    return out


def la_argv(nodes: int, steps: int, device, *flags) -> list:
    """The traffic runner's command line at sgp_la.yaml on a synthetic set
    of ``nodes`` x ``steps``."""
    return ["--config", str(LA_CONFIG), "--dataset-name", "synthetic",
            "--synthetic-nodes", str(nodes), "--synthetic-steps", str(steps),
            "--seed", str(SEED), "--device", str(device), *flags]


def run_traffic(argv, fn=None) -> dict:
    """``run_traffic_sgp`` through ``Experiment(...).run(argv)``, as its
    command line runs it (``fn`` in place of ``run_experiment``)."""
    import sgp_tpu_torch.exp.run_traffic_sgp as runner
    from sgp_tpu_torch.exp.common import Experiment
    return Experiment(fn or runner.run_experiment,
                      runner.configure_parser()).run(argv)


class TrafficRecorder:
    """Instruments one traffic runner run from outside: the encode's
    synchronized wall and the encoding's bytes; each fused training call's
    synchronized host ms; the fused step and its model; the first step's
    window starts, the weights before it, its loss and its clipped
    gradients. With ``first_items`` the first step takes those window
    starts (the card's, replayed on the CPU)."""

    def __init__(self, device, first_items=None):
        self.device, self.first_items = device, first_items
        self.encode, self.call_ms = [], []
        self.step = self.model = self.first = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def patch(self):
        import sgp_tpu_torch.exp.run_traffic_sgp as runner
        encode, make = runner.encode_dataset, runner.make_fused_window_step
        rec = self

        def timed_encode(ds, *args, **kwargs):
            rec._sync()
            t0 = time.perf_counter()
            out = encode(ds, *args, **kwargs)
            rec._sync()
            enc = ds.covariates["encoded_x"].value
            rec.encode.append(dict(
                ms=(time.perf_counter() - t0) * 1e3, shape=list(enc.shape),
                dtype=str(enc.dtype), device=str(enc.device),
                bytes=enc.numel() * enc.element_size()))
            return out

        def make_step(model, *args, **kwargs):
            step = make(model, *args, **kwargs)
            rec.step, rec.model = step, model

            def first_step(generator):
                items = step.sample(generator) if rec.first_items is None \
                    else rec.first_items.to(rec.device)
                init = {k: v.detach().cpu().clone()
                        for k, v in model.state_dict().items()}
                loss = step.train_on(items)
                rec.first = dict(
                    items=items.cpu(), init=init, loss=float(loss),
                    grads={k: p.grad.detach().cpu().clone()
                           for k, p in model.named_parameters()})
                return loss

            def run(generator):
                rec._sync()
                t0 = time.perf_counter()
                if rec.first is None:
                    loss = torch.stack([first_step(generator)] + [
                        step.train_on(step.sample(generator))
                        for _ in range(kwargs["steps_per_call"] - 1)]).mean()
                else:
                    loss = step(generator)
                loss = float(loss)                       # synchronizes
                rec.call_ms.append((time.perf_counter() - t0) * 1e3)
                return torch.tensor(loss)
            return run

        runner.encode_dataset, runner.make_fused_window_step = \
            timed_encode, make_step
        try:
            yield self
        finally:
            runner.encode_dataset, runner.make_fused_window_step = \
                encode, make


def traffic_cpu_step(device) -> dict:
    """The fused route's first step on the card and again by the port on
    the CPU, the same command at ``LA_CPU_NODES`` nodes and
    ``LA_CPU_STEPS`` steps, dropout off: the same initial weights (drawn
    from the seed on the CPU), the card's window starts, each device's own
    encode. The loss within TOL_LOSS relative, each clipped gradient
    within TOL_GRAD of its largest value (:func:`grad_errors`)."""
    flags = ("--epochs", "1", "--batches-epoch", "1", "--dropout", "0")
    card = TrafficRecorder(device)
    with card.patch():
        run_traffic(la_argv(LA_CPU_NODES, LA_CPU_STEPS, device, *flags))
    cpu = TrafficRecorder(torch.device("cpu"), card.first["items"])
    t0 = time.perf_counter()
    with cpu.patch():
        run_traffic(la_argv(LA_CPU_NODES, LA_CPU_STEPS, "cpu", *flags))
    same_init = all(torch.equal(v, cpu.first["init"][k])
                    for k, v in card.first["init"].items())
    loss_err = abs(card.first["loss"] - cpu.first["loss"]) / \
        abs(cpu.first["loss"])
    errs = grad_errors(card.first["grads"], cpu.first["grads"])
    out = {"nodes": LA_CPU_NODES, "steps": LA_CPU_STEPS,
           "cpu_run_s": time.perf_counter() - t0, "same_init": same_init,
           "loss": card.first["loss"], "loss_rel_err": loss_err,
           "grad_max_rel_err": max(errs.values()),
           "worst": sorted(errs.items(), key=lambda kv: -kv[1])[:3],
           "tol": [TOL_LOSS, TOL_GRAD]}
    print(f"[phase 14] first step, card vs CPU port: {json.dumps(out)}")
    assert same_init and loss_err <= TOL_LOSS, out
    assert max(errs.values()) <= TOL_GRAD, out
    return out


def traffic_main_run(device) -> dict:
    """(a) The runner at sgp_la.yaml's widths on LA_NODES x LA_STEPS for
    LA_EPOCHS epochs (the fused route): the encode's wall and bytes, the
    training calls' batch/s, then synchronized step times, a profile's
    device busy and idle share, peak memory, and the test MAE beside the
    same command untrained (``--epochs 0``). K1's launches are counted
    (``auto`` picks the dense operator at this size: 0)."""
    from sgp_tpu_torch.ops import bsr_spmm
    cfg = la_config()
    argv = la_argv(LA_NODES, LA_STEPS, device)
    rec = TrafficRecorder(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    bsr_spmm.launches = 0
    t0 = time.perf_counter()
    with rec.patch():
        res = run_traffic(argv + ["--epochs", str(LA_EPOCHS)])
    wall = time.perf_counter() - t0
    launches = bsr_spmm.launches
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 20
    steps_per_call = cfg["batches_epoch"]
    call_ms = quartiles(rec.call_ms[1:])
    # synchronized steps on the trained model (dropout on, as trained)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    step_ms = []
    for _ in range(LA_TIME_STEPS):
        items = rec.step.sample(gen)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        float(rec.step.train_on(items))
        step_ms.append((time.perf_counter() - t1) * 1e3)
    steps = quartiles(step_ms[TIME_DROP:])
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            float(rec.step.train_on(rec.step.sample(gen)))
        torch.cuda.synchronize(device)
    busy = device_busy(prof, PROFILE_STEPS)
    idle = 1.0 - busy["device_busy_ms"] / steps["median"] if busy \
        else "not measured (no device activity traced)"
    untrained = run_traffic(argv + ["--epochs", "0"])
    gemm = traffic_step_gemm_flop(rec.model, cfg["batch_size"] * LA_NODES)
    row = dict(argv=" ".join(argv), epochs=LA_EPOCHS, wall_s=wall,
               encode=rec.encode[0], calls=len(rec.call_ms),
               call_ms=call_ms,
               batch_per_s=steps_per_call / call_ms["median"] * 1e3,
               step_ms=steps, idle_share=idle, peak_mib=peak,
               k1_launches=launches, step_gemm_gflop=gemm / 1e9,
               step_gemm_tflop_per_s=gemm / steps["median"] / 1e9,
               test=res, untrained_test_mae=untrained["test_mae"], **busy)
    print(f"[phase 14] (a) run: {json.dumps(row, default=str)}")
    assert torch.device(rec.encode[0]["device"]).type == device.type, \
        rec.encode   # the encoding stays where the run goes
    assert all(np.isfinite(v) for v in res.values()), res
    assert res["test_mae"] < untrained["test_mae"], \
        (res["test_mae"], untrained["test_mae"])
    assert launches == 0, launches
    return row


def traffic_step_gemm_flop(model, rows: int) -> float:
    """The matrix products of one training step of ``model`` (an
    ``SGPModel``) on ``rows`` = batch x nodes rows, forward and backward
    (3x the forward): the grouped encoder (each block of the features to
    its block of the hidden width), every ``nn.Linear`` of the trunk and
    the readout; the node embedding's projection (once a batch, not a
    row) is left out."""
    from sgp_tpu_torch.models.blocks import GroupedLinear
    fwd = 0
    for name, mod in model.named_modules():
        if isinstance(mod, GroupedLinear):
            g, i, o = mod.weight.shape
            fwd += g * i * o
        elif isinstance(mod, torch.nn.Linear) and "emb" not in name:
            fwd += mod.in_features * mod.out_features
    return 2.0 * rows * fwd * 3


def la_config(**over) -> dict:
    """sgp_la.yaml over the traffic runner's defaults (the flags the yaml
    leaves out, e.g. ``emb_size``), as the runner parses them."""
    from sgp_tpu_torch.exp.run_traffic_sgp import configure_parser
    return {**vars(configure_parser().parse_args([])),
            **read_flat_yaml(LA_CONFIG), **over}


def traffic_routes(device) -> dict:
    """The other routes of the runner, short (LA_ROUTE_STEPS steps, 2
    epochs of at most 100 batches): each one's test MAE below its
    untrained run."""
    out = {}
    for tag, flags in LA_ROUTES:
        t0 = time.perf_counter()
        argv = la_argv(LA_NODES, LA_ROUTE_STEPS, device, *flags)
        res = run_traffic(argv + LA_ROUTE_RUN)
        untrained = run_traffic(argv + ["--epochs", "0"])
        out[tag] = dict(test_mae=res["test_mae"],
                        untrained_test_mae=untrained["test_mae"],
                        wall_s=time.perf_counter() - t0)
        print(f"[phase 14] (a) route {tag}: {json.dumps(out[tag])}")
        assert all(np.isfinite(v) for v in res.values()), (tag, res)
        assert res["test_mae"] < untrained["test_mae"], (tag, out[tag])
    return out


def support_setup(raw, graph, device):
    """Phase 5's data at sgp_la.yaml's windows and scaler, encoded on the
    card by the yaml's encoder at receptive field SUPPORT_K (768 features
    a node) and kept there: ``(cfg, ds, split)``."""
    from sgp_tpu_torch.data import (SpatioTemporalDataset, StandardScaler,
                                    TemporalSplitter, Windowing)
    from sgp_tpu_torch.encode import SGPEncoder, encode_dataset
    from sgp_tpu_torch.exp.common import filter_kwargs
    cfg = la_config(receptive_field=SUPPORT_K)
    exog = raw.datetime_encoded("day")
    ds = SpatioTemporalDataset(
        raw.target, index=raw.index, mask=raw.mask, graph=graph,
        covariates={"u": exog},
        windowing=Windowing(window=cfg["window"], horizon=cfg["horizon"]))
    split = TemporalSplitter(0.1, 0.2).split(ds)
    ds.fit_scaler(StandardScaler(axis=(0, 1)),
                  step_index=ds.indices()[split.train])
    enc = SGPEncoder(**filter_kwargs(SGPEncoder.__init__, {
        **cfg, "input_size": ds.n_channels + exog.shape[-1], "seed": SEED,
        "device": device}))
    encode_dataset(ds, enc, encode_exogenous=cfg["preprocess_exogenous"],
                   keep_raw=cfg["keep_raw"], device_resident=True,
                   device=device)
    return cfg, ds, split


def support_route(mode, cfg, ds, split, dev, items, device) -> dict:
    """One support route (``operator_mode`` ``mode``) through the path
    the runner's ``--sgp-preprocessing`` takes: ``SGPLoader`` batches,
    SUPPORT_STEPS fused window steps on the given window starts (the same
    weights and dropout draws on either route) and the fused evaluation
    of SUPPORT_EVAL_BATCHES test batches; K1's launches counted from 0
    just before."""
    from sgp_tpu_torch.data.sgp_loader import (SGPLoader,
                                               build_support_operators)
    from sgp_tpu_torch.ops import bsr_spmm
    from sgp_tpu_torch.train import MaskedMetrics
    from sgp_tpu_torch.train.fused_window import (make_fused_eval,
                                                  make_fused_window_step)
    t0 = time.perf_counter()
    ops = build_support_operators(
        ds.graph, k=cfg["receptive_field"], undirected=cfg["undirected"],
        add_loops=cfg["add_self_loops"], bidirectional=cfg["bidirectional"],
        global_attr=cfg["global_attr"], operator_mode=mode, device=device)
    build_s = time.perf_counter() - t0
    bs = cfg["batch_size"]
    width = int(dev["x"].shape[-1]) * (1 + len(ops))
    model = sgp_model(cfg, ds, width, int(dev["u"].shape[-1]), device)
    opt = torch.optim.Adam(model.parameters(), lr=cfg["lr"], eps=1e-8)
    step = make_fused_window_step(
        model, opt, dev["x"], dev["y"], dev["m"], ds.indices()[split.train],
        ds.windowing.window_offsets(), ds.windowing.horizon_offsets(),
        ds.scaler_params(device=device), u=dev["u"], support_ops=ops,
        batch_size=bs, grad_clip=GRAD_CLIP)
    evaluate = make_fused_eval(
        model, dev["x"], dev["y"], dev["m"],
        ds.indices()[split.test][:SUPPORT_EVAL_BATCHES * bs],
        ds.windowing.window_offsets(), ds.windowing.horizon_offsets(),
        ds.scaler_params(device=device), MaskedMetrics.forecasting(),
        u=dev["u"], support_ops=ops, batch_size=bs)
    torch.cuda.synchronize(device)
    bsr_spmm.launches = 0
    t0 = time.perf_counter()
    batches = [b["x"] for b in SGPLoader(ds, ops, items=split.train[:2 * bs],
                                         batch_size=bs)]
    torch.manual_seed(SEED)                 # the same dropout draws
    losses = [float(step.train_on(it)) for it in items]
    metrics = evaluate()
    torch.cuda.synchronize(device)
    return dict(ops=ops, batches=batches, losses=losses, metrics=metrics,
                launches=bsr_spmm.launches, build_s=build_s,
                path_s=time.perf_counter() - t0, state={
                    k: v.detach().clone()
                    for k, v in model.state_dict().items()})


def k1_at_support_width(op, dense_op, x, tag: str = "phase 14",
                        case: str = "support hop") -> dict:
    """K1 at the supports' shape (phase 14: a loader batch ``[64, 1, N,
    768]`` folded to ``[N, F]``, F = 49,152, as ``BSROperator`` folds it;
    phase 15: the stratified step's ``[32, N, 128]`` and its evaluation's
    ``[16, 1, N, 128]``) on the 100-nn support A: against its plain version
    (in SUPPORT_CHUNK-column calls: its ``[nnzb, 128, F]`` temporaries
    would take 80 GB at once at F 49,152), interleaved CUDA-event times,
    the bound, cuSPARSE's BSR product and the dense operator's matmul on
    the same input."""
    from sgp_tpu_torch.ops import bsr_spmm, bsr_spmm_plain
    n = x.shape[-2]
    folded = x.reshape(-1, n, x.shape[-1]).transpose(0, 1).reshape(
        n, -1).contiguous()
    args = (op.blocks, op.block_cols, op.row_ptr, op.block_rows)
    n_br = op.row_ptr.numel() - 1
    f = folded.shape[1]

    def plain():
        return torch.cat([bsr_spmm_plain(
            op.blocks, op.block_cols, op.block_rows, n_br,
            folded[:, s:s + SUPPORT_CHUNK])
            for s in range(0, f, SUPPORT_CHUNK)], dim=1)
    got, again, ref = bsr_spmm(*args, folded), bsr_spmm(*args, folded), \
        plain()
    torch.cuda.synchronize()
    abs_err, rel = rel_err(got, ref)
    bias = ((got - ref).mean() / ref.abs().max()).item()
    k_ms, p_ms = interleaved_ms(lambda: bsr_spmm(*args, folded), plain,
                                2, 3, plain_iters=1)
    row = dict(case=case, n=n, f=f, nnzb=op.blocks.shape[0],
               dtype="float32", x_dtype=str(x.dtype).split(".")[-1],
               max_abs_err=abs_err, rel_err=rel,
               tol=TOL_F32, out_mean_err=bias,
               bitwise_repeat=torch.equal(got, again), ms=k_ms["median"],
               q1_q3=[k_ms["q1"], k_ms["q3"]], plain_ms=p_ms["median"],
               plain_q1_q3=[p_ms["q1"], p_ms["q3"]],
               dense_tile_gflop=2 * op.blocks.numel() * f / 1e9)
    row.update(k1_bound(op, folded))
    npad = n_br * op.blocks.shape[-1]
    xp = torch.zeros((npad, f), dtype=folded.dtype, device=folded.device)
    xp[:n] = folded
    library_ready(f)
    try:
        a = torch.sparse_bsr_tensor(op.row_ptr, op.block_cols, op.blocks,
                                    size=(npad, npad))
        lib = (a @ xp)[:n]
        row["library_ms"] = cuda_ms(lambda: a @ xp, 2, warmup=1)
        row["library_max_abs_err"] = rel_err(lib, ref)[0]
        del lib
    except (RuntimeError, NotImplementedError, TypeError) as err:
        row["library_ms"] = None
        row["library_note"] = f"{type(err).__name__}: {err}"[:300]
    del xp, again
    row["dense_operator_ms"] = cuda_ms(lambda: dense_op @ x, 3, warmup=1)
    row["dense_operator_rel_err"] = rel_err(
        (dense_op @ x).reshape(-1, n, x.shape[-1]).transpose(0, 1).reshape(
            n, -1), ref)[1]
    print(f"[{tag}] K1: {json.dumps(row)}")
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert rel <= TOL_F32, f"K1 disagrees with plain at F {f}: {row}"
    assert row["bitwise_repeat"], f"two calls differ: {row}"
    assert abs(bias) <= TOL_K1_BIAS, f"K1 output is biased: {row}"
    assert row["dense_operator_rel_err"] <= TOL_F32, row
    return row


def support_vs_float64(bsr: dict, dense: dict, c: int) -> dict:
    """Each support's lanes of the first loader batch, on either route,
    against the dense support applied in float64 on the card: the max
    error and the mean signed error, relative to the largest value (which
    route the gap between them comes from)."""
    x = dense["batches"][0][..., :c].double()
    out = {}
    for i, op in enumerate(dense["ops"]):
        ref = op.mat.double() @ x
        top = ref.abs().max().item()
        lanes = slice(c * (i + 1), c * (i + 2))
        out[i] = {route: [
            (r["batches"][0][..., lanes].double() - ref).abs().max().item()
            / top, (r["batches"][0][..., lanes].double() - ref).mean().item()
            / top] for route, r in (("bsr", bsr), ("dense", dense))}
        del ref
    return out


def phase14_traffic(raw, graph, device) -> dict:
    """The traffic SGP runner: (a) from its command line at sgp_la.yaml's
    widths (the first step against the CPU port, the main run, the other
    routes); (b) the loader-side supports with ``operator_mode="bsr"`` on
    phase 5's 100-nn graph (K1) against the dense supports, and K1 at
    their width."""
    from sgp_tpu_torch.exp.run_traffic_sgp import device_arrays
    out = {}
    for tag, fn in (("cpu_step", traffic_cpu_step),
                    ("main", traffic_main_run), ("routes", traffic_routes)):
        t0 = time.perf_counter()
        out[tag] = fn(device)
        print(f"[time] phase 14 {tag}: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg, ds, split = support_setup(raw, graph, device)
    dev = device_arrays(ds, device)
    enc = ds.covariates["encoded_x"].value
    print(f"[phase 14] (b) {ds.n_nodes} nodes, {graph.num_edges} edges: "
          f"encoding {tuple(enc.shape)} {enc.dtype} on {enc.device} in "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    starts = torch.as_tensor(ds.indices()[split.train], device=device)
    items = [starts[torch.randint(len(starts), (cfg["batch_size"],),
                                  generator=gen, device=device)]
             for _ in range(SUPPORT_STEPS)]
    routes = {mode: support_route(mode, cfg, ds, split, dev, items, device)
              for mode in ("bsr", "dense")}
    bsr, dense = routes["bsr"], routes["dense"]
    c = int(dev["x"].shape[-1])
    x_err = max(rel_err(a[..., c:], b[..., c:])[1]
                for a, b in zip(bsr["batches"], dense["batches"]))
    x_bias = max(abs(((a[..., c:] - b[..., c:]).mean()
                      / b[..., c:].abs().max()).item())
                 for a, b in zip(bsr["batches"], dense["batches"]))
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(bsr["losses"], dense["losses"]))
    eval_err = max(abs(bsr["metrics"][k] - v) / abs(v)
                   for k, v in dense["metrics"].items())
    weight_err = max(rel_err(bsr["state"][k], v)[1]
                     for k, v in dense["state"].items())
    n_ops = len(bsr["ops"])
    eval_batches = -(-min(len(split.test), SUPPORT_EVAL_BATCHES
                          * cfg["batch_size"]) // cfg["batch_size"])
    expect = n_ops * (len(bsr["batches"]) + SUPPORT_STEPS + eval_batches)
    row = dict(supports=n_ops, k=cfg["receptive_field"],
               f=cfg["batch_size"] * c, launches=bsr["launches"],
               launches_expected=expect,
               dense_launches=dense["launches"], loader_x_rel_err=x_err,
               loader_x_mean_err=x_bias, loss_rel_err=loss_err,
               eval_rel_err=eval_err, weights_rel_err=weight_err,
               losses={k: r["losses"] for k, r in routes.items()},
               metrics={k: r["metrics"] for k, r in routes.items()},
               build_s={k: r["build_s"] for k, r in routes.items()},
               path_s={k: r["path_s"] for k, r in routes.items()},
               tol=[TOL_SLICE, TOL_K1_BIAS])
    print(f"[phase 14] (b) BSR supports vs dense: {json.dumps(row)}")
    assert bsr["launches"] == expect and dense["launches"] == 0, row
    assert x_err <= TOL_SLICE and x_bias <= TOL_K1_BIAS, row
    assert loss_err <= TOL_SLICE and eval_err <= TOL_SLICE, row
    assert all(np.isfinite(bsr["losses"])), row
    row["vs_float64"] = support_vs_float64(bsr, dense, c)
    print(f"[phase 14] (b) each support's first batch against float64: "
          f"{json.dumps(row['vs_float64'])}")
    k1 = k1_at_support_width(bsr["ops"][0], dense["ops"][0],
                             bsr["batches"][0][..., :c])
    out["support"], out["k1"] = row, k1
    print(f"[time] phase 14 (b): {time.perf_counter() - t0:.1f} s")
    return out


def run_largescale(argv, fn=None) -> dict:
    """``run_largescale_sgp`` through ``Experiment(...).run(argv)``, as its
    command line runs it (``fn`` in place of ``run_experiment``)."""
    import sgp_tpu_torch.exp.run_largescale_sgp as runner
    from sgp_tpu_torch.exp.common import Experiment
    return Experiment(fn or runner.run_experiment,
                      runner.configure_parser_largescale()).run(argv)


def strat_argv(nodes: int, steps: int, device, *flags) -> list:
    """The large-scale runner's stratified command line at sgp_pv.yaml on a
    synthetic set of ``nodes`` x ``steps``."""
    return ["--config", str(CONFIG), "--dataset-name", "synthetic",
            "--synthetic-nodes", str(nodes), "--synthetic-steps", str(steps),
            "--iid-stratified", "true", "--seed", str(SEED), "--device",
            str(device), *flags]


def bsr_supports(args):
    """``run_experiment`` with ``operator_mode = "bsr"`` on the namespace:
    the supports on K1's route."""
    import sgp_tpu_torch.exp.run_largescale_sgp as runner
    args.operator_mode = "bsr"
    return runner.run_experiment(args)


@contextlib.contextmanager
def cached_datasets(tag: str = "phase 15"):
    """The runners' ``get_dataset`` made once for each set of arguments
    inside the block (the runners read the dataset's arrays and never
    write them): the synthetic set costs the host a pass of the dense
    diffusion operator a step, ~5 s at 5,016 x 640."""
    from sgp_tpu_torch.exp import (run_largescale_baselines,
                                   run_largescale_sgp,
                                   run_traffic_baselines)
    runners = (run_largescale_sgp, run_largescale_baselines,
               run_traffic_baselines)
    get, cache = run_largescale_sgp.get_dataset, {}

    def cached(name, **kwargs):
        key = (name, tuple(sorted(kwargs.items())))
        if key not in cache:
            t0 = time.perf_counter()
            cache[key] = get(name, **kwargs)
            print(f"[{tag}] dataset {key}: "
                  f"{time.perf_counter() - t0:.1f} s on the host")
        return cache[key]
    for mod in runners:
        mod.get_dataset = cached
    try:
        yield
    finally:
        for mod in runners:
            mod.get_dataset = get


class StratRecorder:
    """Instruments one run of the large-scale runner from outside: the
    reservoir encode's synchronized wall and the embedding's bytes; the
    graph and options of ``build_support_operators``; the stratified step
    (or the trial step, or the single-trial multi-step), its arguments
    and model; each training call's synchronized host ms; the first step's
    draws, the weights before it, its loss and its clipped gradients.
    With ``first_draws`` the first step takes those draws (the card's,
    replayed on the CPU)."""

    def __init__(self, device, first_draws=None):
        self.device, self.first_draws = device, first_draws
        self.encode, self.call_ms = [], []
        self.step = self.model = self.first = self.args = None
        self.graph, self.eval_items = None, 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def timed_call(self, fn, *args):
        self._sync()
        t0 = time.perf_counter()
        out = fn(*args)
        self._sync()
        self.call_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    @contextlib.contextmanager
    def patch(self):
        import sgp_tpu_torch.exp.run_largescale_sgp as runner
        saved = {k: getattr(runner, k) for k in (
            "Reservoir", "build_support_operators",
            "make_fused_iid_stratified_step", "make_fused_iid_multi_step",
            "make_fused_iid_multi_trial_step", "make_fused_eval")}
        rec = self

        class TimedReservoir(saved["Reservoir"]):
            def __call__(self, x, *args, **kwargs):
                rec._sync()
                t0 = time.perf_counter()
                out = super().__call__(x, *args, **kwargs)
                rec._sync()
                rec.encode.append(dict(
                    ms=(time.perf_counter() - t0) * 1e3,
                    shape=list(out.shape), dtype=str(out.dtype),
                    device=str(out.device),
                    bytes=out.numel() * out.element_size()))
                return out

        def supports(g, **kwargs):
            rec.graph, rec.support_kwargs = g, kwargs
            return saved["build_support_operators"](g, **kwargs)

        def make_stratified(model, optimizer, *args, **kwargs):
            step = saved["make_fused_iid_stratified_step"](
                model, optimizer, *args, **kwargs)
            rec.step, rec.model, rec.args, rec.kwargs = step, model, args, \
                kwargs

            def first_step(generator):
                draws = step.sample(generator) if rec.first_draws is None \
                    else tuple(d.to(rec.device) for d in rec.first_draws)
                init = {k: v.detach().cpu().clone()
                        for k, v in model.state_dict().items()}
                loss = step.train_on(*draws)
                rec.first = dict(
                    draws=tuple(d.cpu() for d in draws), init=init,
                    loss=float(loss), grads={
                        k: p.grad.detach().cpu().clone()
                        for k, p in model.named_parameters()})
                return loss

            def call(generator):
                if rec.first is None:
                    return torch.stack([first_step(generator)] + [
                        step.train_on(*step.sample(generator))
                        for _ in range(kwargs["steps_per_call"] - 1)]).mean()
                return step(generator)

            return lambda generator: rec.timed_call(call, generator)

        def make_multi(model, optimizer, *args, **kwargs):
            step = saved["make_fused_iid_multi_step"](model, optimizer,
                                                      *args, **kwargs)
            rec.step, rec.model, rec.args, rec.kwargs = step, model, args, \
                kwargs
            return lambda generator: rec.timed_call(step, generator)

        def make_trials(model, *args, **kwargs):
            step = saved["make_fused_iid_multi_trial_step"](model, *args,
                                                            **kwargs)
            rec.step, rec.model, rec.args, rec.kwargs = step, model, args, \
                kwargs

            def run(params, opt_state, generator):
                return rec.timed_call(step, params, opt_state, generator)
            run.init_opt = step.init_opt
            return run

        def make_eval(model, x_full, target, mask, items, *args, **kwargs):
            rec.eval_items = len(items)
            return saved["make_fused_eval"](model, x_full, target, mask,
                                            items, *args, **kwargs)

        runner.make_fused_eval = make_eval
        runner.Reservoir = TimedReservoir
        runner.build_support_operators = supports
        runner.make_fused_iid_stratified_step = make_stratified
        runner.make_fused_iid_multi_step = make_multi
        runner.make_fused_iid_multi_trial_step = make_trials
        try:
            yield self
        finally:
            for k, v in saved.items():
                setattr(runner, k, v)


def strat_cpu_step(device) -> dict:
    """The stratified route's first step on the card and again by the port
    on the CPU, the same command at ``STRAT_CPU_NODES`` nodes and
    ``STRAT_CPU_STEPS`` steps, dropout off: the same initial weights (drawn
    from the seed on the CPU), the card's draws, each device's own encode.
    The loss within TOL_LOSS relative, each clipped gradient within
    TOL_GRAD of its largest value (:func:`grad_errors`)."""
    flags = ("--epochs", "1", "--batches-epoch", "1", "--dropout", "0")
    card = StratRecorder(device)
    with card.patch():
        run_largescale(strat_argv(STRAT_CPU_NODES, STRAT_CPU_STEPS, device,
                                  *flags))
    cpu = StratRecorder(torch.device("cpu"), card.first["draws"])
    t0 = time.perf_counter()
    with cpu.patch():
        run_largescale(strat_argv(STRAT_CPU_NODES, STRAT_CPU_STEPS, "cpu",
                                  *flags))
    same_init = all(torch.equal(v, cpu.first["init"][k])
                    for k, v in card.first["init"].items())
    loss_err = abs(card.first["loss"] - cpu.first["loss"]) / \
        abs(cpu.first["loss"])
    errs = grad_errors(card.first["grads"], cpu.first["grads"])
    out = {"nodes": STRAT_CPU_NODES, "steps": STRAT_CPU_STEPS,
           "cpu_run_s": time.perf_counter() - t0, "same_init": same_init,
           "loss": card.first["loss"], "loss_rel_err": loss_err,
           "grad_max_rel_err": max(errs.values()),
           "worst": sorted(errs.items(), key=lambda kv: -kv[1])[:3],
           "tol": [TOL_LOSS, TOL_GRAD]}
    print(f"[phase 15] first step, card vs CPU port: {json.dumps(out)}")
    assert same_init and loss_err <= TOL_LOSS, out
    assert max(errs.values()) <= TOL_GRAD, out
    return out


def strat_step_work(rec) -> dict:
    """What one stratified step moves and computes at the run's shapes, from
    the shapes alone: the embedding rows it gathers (``h_sel``), the dense
    supports' rows it gathers (``gather_rows``), the batched hop products
    and the decoder's products (forward and backward)."""
    h = rec.args[0]
    tb, p = rec.kwargs["times_per_batch"], rec.kwargs["nodes_per_time"]
    n, ht = h.shape[1], h.shape[2]
    ops = rec.args[6]
    return {"h_sel_bytes": tb * n * ht * h.element_size(),
            "support_rows_bytes": len(ops) * tb * p * n * 4,
            "hop_gflop": len(ops) * 2.0 * tb * p * n * ht / 1e9,
            "decoder_gflop": traffic_step_gemm_flop(rec.model, tb * p) / 1e9}


def strat_main_run(device) -> dict:
    """(a) The stratified runner from its command line at sgp_pv.yaml's
    widths on 5,016 nodes x STRAT_STEPS for STRAT_EPOCHS epochs, dense
    supports (``auto`` at this size): the encode's wall and the resident
    embedding's bytes, the training calls' batch/s, synchronized step
    times, a profile's device busy and idle share, peak memory beside the
    precompute path's estimate, and the test MAE beside the same command
    untrained (``--epochs 0``); K1's launches counted (0)."""
    from sgp_tpu_torch.ops import bsr_spmm
    argv = strat_argv(N_NODES, STRAT_STEPS, device)
    rec = StratRecorder(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    bsr_spmm.launches = 0
    t0 = time.perf_counter()
    with rec.patch():
        res = run_largescale(argv + ["--epochs", str(STRAT_EPOCHS)])
    wall = time.perf_counter() - t0
    launches = bsr_spmm.launches
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 20
    cfg = read_flat_yaml(CONFIG)
    steps_per_call = cfg["batches_epoch"]
    call_ms = quartiles(rec.call_ms[1:])
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    step_ms = []
    for _ in range(STRAT_TIME_STEPS):
        draws = rec.step.sample(gen)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        float(rec.step.train_on(*draws))
        step_ms.append((time.perf_counter() - t1) * 1e3)
    steps = quartiles(step_ms[TIME_DROP:])
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            float(rec.step.train_on(*rec.step.sample(gen)))
        torch.cuda.synchronize(device)
    busy = device_busy(prof, PROFILE_STEPS)
    idle = 1.0 - busy["device_busy_ms"] / steps["median"] if busy \
        else "not measured (no device activity traced)"
    import argparse
    from sgp_tpu_torch.exp.run_traffic_sgp import derive_order
    order = derive_order(argparse.Namespace(**cfg))
    precompute_gib = (STRAT_STEPS * N_NODES * order * cfg["reservoir_size"]
                      * 4 / 2 ** 30)
    work = strat_step_work(rec)
    row = dict(argv=" ".join(argv), epochs=STRAT_EPOCHS, wall_s=wall,
               encode=rec.encode[0], calls=len(rec.call_ms),
               call_ms=call_ms,
               batch_per_s=steps_per_call / call_ms["median"] * 1e3,
               batch=cfg["batch_size"], step_ms=steps, idle_share=idle,
               peak_mib=peak, precompute_estimate_gib_f32=precompute_gib,
               k1_launches=launches, work=work,
               step_decoder_tflop_per_s=work["decoder_gflop"]
               / steps["median"], test=res, **busy)
    print(f"[phase 15] (a) run: {json.dumps(row, default=str)}")
    assert torch.device(rec.encode[0]["device"]).type == device.type
    assert all(np.isfinite(v) for v in res.values()), res
    assert launches == 0, launches
    return row, rec


def strat_untrained(device) -> dict:
    """(a)'s command with ``--epochs 0``: the untrained test metrics."""
    res = run_largescale(strat_argv(N_NODES, STRAT_STEPS, device,
                                    "--epochs", "0"))
    print(f"[phase 15] (a) untrained: {json.dumps(res)}")
    return res


def strat_routes(rec, device) -> dict:
    """(b) The dense run's embedding through the same step with the
    supports built on K1's route (``operator_mode="bsr"``) from the same
    initial weights and draws: the f32 hops within TOL_F32 of the largest
    value with the mean signed error (TOL_K1_BIAS), the bf16 features each
    within one bf16 ulp of the dense route's, or within TOL_F32 of the
    largest value (values near 0, whose ulp is below the f32 routes' own
    difference), at most STRAT_FLIP_SHARE of them rounded the other way;
    the first loss within TOL_SLICE; K1's launches counted (one a support
    a step's assembly)."""
    from sgp_tpu_torch.data.sgp_loader import build_support_operators
    from sgp_tpu_torch.ops import bsr_spmm
    from sgp_tpu_torch.train.iid import make_fused_iid_stratified_step
    t0 = time.perf_counter()
    kw = dict(rec.support_kwargs, operator_mode="bsr")
    bsr_ops = build_support_operators(rec.graph, **kw)
    build_s = time.perf_counter() - t0
    dense_ops = rec.args[6]
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    steps = {}
    for route, ops in (("dense", dense_ops), ("bsr", bsr_ops)):
        model = copy.deepcopy(rec.model)
        model.load_state_dict(rec.first["init"])
        opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8)
        args = rec.args[:6] + (ops,) + rec.args[7:]
        steps[route] = make_fused_iid_stratified_step(
            model, opt, *args, **dict(rec.kwargs, steps_per_call=1))
    t, n = steps["dense"].sample(gen)
    h_sel = rec.args[0][t].float()
    hop_err, hop_bias = [], []
    for d_op, b_op in zip(dense_ops, bsr_ops):
        ref, got = d_op @ h_sel, b_op @ h_sel
        top = ref.abs().max()
        hop_err.append(((got - ref).abs().max() / top).item())
        hop_bias.append(((got - ref).mean() / top).item())
        del ref, got
    bsr_spmm.launches = 0
    feats = {r: s.features(t, n) for r, s in steps.items()}
    losses = {r: float(s.train_on(t, n)) for r, s in steps.items()}
    torch.cuda.synchronize(device)
    launches = bsr_spmm.launches
    a, b = feats["bsr"].float(), feats["dense"].float()
    flipped = int((feats["bsr"] != feats["dense"]).sum())
    row = dict(supports=len(bsr_ops), build_s=build_s,
               f_step=int(h_sel.shape[0] * h_sel.shape[-1]),
               hop_rel_err=hop_err, hop_mean_err=hop_bias,
               features_dtype=str(feats["bsr"].dtype),
               features_rel_err=((a - b).abs().max() / b.abs().max()).item(),
               features_mean_err=((a - b).mean() / b.abs().max()).item(),
               features_within_bf16_ulp=within_bf16_ulp(
                   a, b, TOL_F32 * b.abs().max().item()),
               flipped=flipped, flipped_share=flipped / b.numel(),
               losses=losses,
               loss_rel_err=abs(losses["bsr"] - losses["dense"])
               / abs(losses["dense"]), launches=launches,
               launches_expected=2 * len(bsr_ops),
               tol=[TOL_F32, TOL_K1_BIAS, STRAT_FLIP_SHARE, TOL_SLICE])
    print(f"[phase 15] (b) BSR supports vs dense, same embedding, weights "
          f"and draws: {json.dumps(row)}")
    assert max(hop_err) <= TOL_F32 and \
        max(abs(v) for v in hop_bias) <= TOL_K1_BIAS, row
    assert feats["bsr"].dtype == feats["dense"].dtype == rec.args[0].dtype
    assert row["features_within_bf16_ulp"], row
    assert row["flipped_share"] <= STRAT_FLIP_SHARE, row
    assert row["loss_rel_err"] <= TOL_SLICE, row
    assert launches == row["launches_expected"], row
    k1 = {}
    x_eval = rec.args[0][:16, None].float()     # [16, 1, N, 128]: F 2,048
    for f, x in ((4096, h_sel), (2048, x_eval)):
        k1[f] = k1_at_support_width(
            bsr_ops[0], dense_ops[0], x, tag="phase 15",
            case=f"stratified {'step' if f == 4096 else 'evaluation'} hop "
                 f"(x widened to f32, as the wrapper does)")
    del steps, feats, h_sel, x_eval
    return row, k1


def strat_bsr_run(device, untrained_mae: float) -> dict:
    """(b) The runner with ``operator_mode = "bsr"`` on the namespace, from
    its command line, STRAT_BSR_EPOCHS epochs: K1 in every step's
    assembly and in the test evaluation, its launches equal to the count
    from the code, finite metrics below the untrained run's."""
    from sgp_tpu_torch.ops import bsr_spmm
    cfg = read_flat_yaml(CONFIG)
    rec = StratRecorder(device)
    bsr_spmm.launches = 0
    t0 = time.perf_counter()
    with rec.patch():
        res = run_largescale(strat_argv(
            N_NODES, STRAT_STEPS, device, "--epochs",
            str(STRAT_BSR_EPOCHS)), bsr_supports)
    wall = time.perf_counter() - t0
    launches = bsr_spmm.launches
    n_ops = len(rec.args[6])
    steps = STRAT_BSR_EPOCHS * cfg["batches_epoch"]
    eval_batches = -(-rec.eval_items // cfg["batch_inference"])
    expect = n_ops * (steps + eval_batches)
    row = dict(epochs=STRAT_BSR_EPOCHS, wall_s=wall, launches=launches,
               launches_expected=expect, eval_batches=eval_batches,
               call_ms=quartiles(rec.call_ms[1:] or rec.call_ms), test=res,
               untrained_test_mae=untrained_mae)
    print(f"[phase 15] (b) run with operator_mode=bsr: {json.dumps(row)}")
    assert all(np.isfinite(v) for v in res.values()), res
    assert res["test_mae"] < untrained_mae, row
    assert launches == expect, row
    return row


def alternating_calls(fns: dict, order, rounds: int) -> dict:
    """Synchronized host ms of each ``fns[name]()`` call, called in
    ``order`` ``rounds`` times (the first call of each left out): their
    quartiles and the last loss each returned."""
    ms = {k: [] for k in fns}
    last = {}
    for _ in range(rounds):
        for name in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last[name] = fns[name]()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    return {k: dict(quartiles(v[1:]), last_loss=last[k]) for k, v in
            ms.items()}


def strat_search(device) -> dict:
    """(c) The trial search from its command line at phase 11's size (5,016
    nodes x N_STEPS, the streaming packed input; ``auto``: the dense
    encode), 2 lr x 2 seeds for SEARCH_EPOCHS epochs: finite metrics, the
    best trial's test MAE below the same search untrained, its calls'
    trial-batch/s beside the single-trial batch/s of the same command
    without the search; then calls of both steps in f32 and with
    ``compute_dtype=torch.bfloat16`` on the run's packed rows, in turns."""
    from sgp_tpu_torch.train.iid import make_fused_iid_multi_step
    from sgp_tpu_torch.train.multi_trial import (
        make_fused_iid_multi_trial_step, stack_trials)
    cfg = read_flat_yaml(CONFIG)
    argv = ["--config", str(CONFIG), "--dataset-name", "synthetic",
            "--synthetic-nodes", str(N_NODES), "--synthetic-steps",
            str(N_STEPS), "--seed", str(SEED), "--device", str(device),
            "--epochs", str(SEARCH_EPOCHS)]
    search = ["--search-lr", SEARCH_LRS, "--search-seeds", SEARCH_SEEDS]
    trials = StratRecorder(device)
    with trials.patch():
        res = run_largescale(argv + search)
    untrained = run_largescale(argv + search + ["--epochs", "0"])
    single = StratRecorder(device)
    with single.patch():
        one = run_largescale(argv)
    k = len(res["trials"])
    spc = cfg["batches_epoch"]
    t_ms, s_ms = quartiles(trials.call_ms[1:]), quartiles(single.call_ms[1:])

    # f32 and bf16 calls of both steps on the single run's packed rows
    def single_call(dtype):
        m = copy.deepcopy(single.model)
        opt = torch.optim.Adam(m.parameters(), lr=cfg["lr"], eps=1e-8)
        step = make_fused_iid_multi_step(
            m, opt, *single.args, **dict(single.kwargs,
                                         compute_dtype=dtype))
        gen = torch.Generator(device=device).manual_seed(SEED + 3)
        return lambda: float(step(gen))

    def trial_call(dtype):
        stack = stack_trials([copy.deepcopy(trials.model)
                              for _ in range(k)])
        kwargs = dict(trials.kwargs, compute_dtype=dtype)
        step = make_fused_iid_multi_trial_step(trials.model, *trials.args,
                                               **kwargs)
        state = [stack, step.init_opt(stack)]
        gen = torch.Generator(device=device).manual_seed(SEED + 3)

        def call():
            state[0], state[1], losses = step(state[0], state[1], gen)
            return losses.cpu().tolist()
        return call
    fns = {"single_f32": single_call(None),
           "single_bf16": single_call(torch.bfloat16),
           "trials_f32": trial_call(None),
           "trials_bf16": trial_call(torch.bfloat16)}
    order = ("single_f32", "single_bf16", "single_bf16", "single_f32",
             "trials_f32", "trials_bf16", "trials_bf16", "trials_f32")
    timed_calls = alternating_calls(fns, order, SEARCH_ROUNDS)
    row = dict(argv=" ".join(argv + search), trials=k,
               trial_call_ms=t_ms,
               trial_batch_per_s=spc * k / t_ms["median"] * 1e3,
               single_call_ms=s_ms,
               single_batch_per_s=spc / s_ms["median"] * 1e3,
               calls=timed_calls, steps_per_call=spc,
               best=(res["best_lr"], res["best_seed"]),
               val_mae_per_trial=res["val_mae_per_trial"],
               test_mae=res["test_mae"],
               untrained_test_mae=untrained["test_mae"],
               single_test_mae=one["test_mae"])
    for name in ("single", "trials"):
        row[f"{name}_bf16_over_f32"] = (timed_calls[f"{name}_bf16"]["median"]
                                        / timed_calls[f"{name}_f32"]["median"])
    print(f"[phase 15] (c) trial search: {json.dumps(row)}")
    assert all(np.isfinite(v) for v in res["val_mae_per_trial"]), res
    assert np.isfinite(res["test_mae"]) and \
        res["test_mae"] < untrained["test_mae"], row
    assert {"lr": res["best_lr"], "seed": res["best_seed"]} in res["trials"]
    assert all(np.all(np.isfinite(v["last_loss"]))
               for v in timed_calls.values()), timed_calls
    return row


def phase15_stratified(device) -> dict:
    """The large-scale runner's stratified trainer and trial search: (a) the
    stratified route from its command line at sgp_pv.yaml's widths on
    5,016 nodes x STRAT_STEPS (first its first step against the CPU port
    at STRAT_CPU_NODES); (b) the same embedding through the supports on
    K1's route against the dense ones, K1 at F 4,096 and 2,048, and the
    runner on K1's route; (c) the trial search at phase 11's size."""
    out = {}
    t0 = time.perf_counter()
    out["cpu_step"] = strat_cpu_step(device)
    print(f"[time] phase 15 cpu_step: {time.perf_counter() - t0:.1f} s")
    with cached_datasets():
        t0 = time.perf_counter()
        out["main"], rec = strat_main_run(device)
        print(f"[time] phase 15 (a) run: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["routes"], out["k1"] = strat_routes(rec, device)
        print(f"[time] phase 15 (b) routes: {time.perf_counter() - t0:.1f} s")
        del rec
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        untrained = strat_untrained(device)
        out["main"]["untrained_test_mae"] = untrained["test_mae"]
        assert out["main"]["test"]["test_mae"] < untrained["test_mae"], \
            (out["main"]["test"], untrained)
        out["bsr_run"] = strat_bsr_run(device, untrained["test_mae"])
        print(f"[time] phase 15 untrained and BSR runs: "
              f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with cached_datasets():
        out["search"] = strat_search(device)
    print(f"[time] phase 15 (c) search: {time.perf_counter() - t0:.1f} s")
    out["launches"] = out["bsr_run"]["launches"]
    return out


def gesn_setup(raw, n_steps: int = None):
    """The closed-form runner's data path at gesn_la.yaml's windows (its
    graph: the similarity graph thresholded at the default 0.1, no k-nn;
    the day encoding as exogenous input; temporal split; StandardScaler
    fitted on the train windows' start steps) and the encoder's input
    ``[T, N, 3]``."""
    from sgp_tpu_torch.data import (SpatioTemporalDataset, StandardScaler,
                                    TemporalSplitter, Windowing)
    from sgp_tpu_torch.encode import encoder_input_array
    cfg = read_flat_yaml(GESN_CONFIG)
    graph = raw.get_connectivity(threshold=0.1, knn=None,
                                 include_self=False)
    t = n_steps or raw.target.shape[0]
    ds = SpatioTemporalDataset(
        raw.target[:t], index=raw.index[:t], mask=raw.mask[:t], graph=graph,
        covariates={"u": raw.datetime_encoded("day")[:t]},
        windowing=Windowing(window=cfg["window"], horizon=cfg["horizon"]))
    split = TemporalSplitter(0.1, 0.2).split(ds)
    ds.fit_scaler(StandardScaler(axis=(0, 1)),
                  step_index=ds.indices()[split.train])
    return cfg, ds, graph, encoder_input_array(ds, True)


def gesn_encoder(cfg, input_size: int, mode: str, device):
    """The yaml's GESN encoder, routed as the runner routes its flags."""
    from sgp_tpu_torch.encode import GESNEncoder
    from sgp_tpu_torch.exp.common import filter_kwargs
    return GESNEncoder(**filter_kwargs(GESNEncoder.__init__, {
        **cfg, "input_size": input_size, "seed": SEED, "operator_mode": mode,
        "device": device}))


def phase16_encode(raw, device) -> dict:
    """(a) The GESN encode of phase 5's series (5,016 nodes x 640 steps,
    the runner's graph) at gesn_la.yaml's widths, f32: through K1
    (``operator_mode="bsr"``, one launch a layer-step) against the dense
    operator and the CPU port, two calls' bits; then K1 at F 320 on a
    layer's recurrent input."""
    from sgp_tpu_torch.ops import bsr_spmm
    cfg, ds, graph, x_np = gesn_setup(raw)
    x = torch.as_tensor(x_np, device=device)
    t_steps, layers = x.shape[0], cfg["reservoir_layers"]
    enc = gesn_encoder(cfg, x.shape[-1], "bsr", device)
    dense = gesn_encoder(cfg, x.shape[-1], "dense", device)
    ops, out, walls, launches = {}, {}, {}, {}
    for name, e in (("bsr", enc), ("dense", dense)):
        t0 = time.perf_counter()
        ops[name] = e.operator(graph)
        torch.cuda.synchronize()
        walls[f"{name}_operator_build"] = (time.perf_counter() - t0) * 1e3
    for name in ("bsr", "dense", "bsr_again"):
        e, op = (dense, ops["dense"]) if name == "dense" else \
            (enc, ops["bsr"])
        torch.cuda.synchronize()
        bsr_spmm.launches = 0
        t0 = time.perf_counter()
        out[name] = e.gesn(x, op)
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3
        launches[name] = bsr_spmm.launches
    same_bits = torch.equal(out.pop("bsr_again"), out["bsr"])
    top = max(by_chunks(t_steps, lambda s, e: out["dense"][s:e].abs().max()
                        .item()))
    route_err = max(by_chunks(t_steps, lambda s, e: (
        out["bsr"][s:e] - out["dense"][s:e]).abs().max().item())) / top
    route_bias = sum(by_chunks(t_steps, lambda s, e: (
        out["bsr"][s:e] - out["dense"][s:e]).double().sum().item())) / (
        out["bsr"].numel() * top)
    f64 = gesn_vs_float64(dense, ops["dense"], x, out)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    cpu_enc = gesn_encoder(cfg, x.shape[-1], "bsr", cpu)
    cpu_out = cpu_enc(torch.as_tensor(x_np[:GESN_CPU_STEPS]), graph)
    cpu_s = time.perf_counter() - t0
    cpu_err = rel_err(out["bsr"][:GESN_CPU_STEPS].cpu(), cpu_out)[1]
    # the f32 routes differ by their rounding, which the recurrence carries
    # on: each is held within the larger of TOL_F32 and twice the dense
    # route's distance to float64
    tol = max(TOL_F32, 2 * f64["dense"])
    row = dict(shape=list(out["bsr"].shape), edges=graph.num_edges,
               encode_ms=walls, k1_launches=launches,
               expected_launches=t_steps * layers,
               bsr_vs_dense_rel_err=route_err,
               bsr_vs_dense_mean_err=route_bias, vs_float64_rel_err=f64,
               tol=tol, bitwise_repeat=same_bits, cpu_steps=GESN_CPU_STEPS,
               cpu_rel_err=cpu_err, cpu_s=cpu_s)
    print(f"[phase 16] (a) GESN encode: {json.dumps(row)}")
    assert launches["bsr"] == launches["bsr_again"] == t_steps * layers, row
    assert launches["dense"] == 0, row
    assert all(bool(torch.isfinite(v).all()) for v in out.values()), row
    assert route_err <= tol and cpu_err <= tol, row
    assert f64["bsr"] <= tol, row
    assert same_bits, row
    # K1 on a layer's recurrent input, h W_hh^T [N, 320], at the last step
    h = enc.gesn.hidden_size
    hop_in = (out["bsr"][-1, :, h:2 * h] @ enc.gesn.layers[1].w_hh.T
              ).contiguous()
    del out
    k1 = k1_at_support_width(ops["bsr"], ops["dense"], hop_in,
                             tag="phase 16", case="gesn hop")
    k1["launches"] = launches["bsr"]
    return k1


def gesn_vs_float64(enc, op, x, outs: dict) -> dict:
    """Each f32 encoding of ``outs`` against the same scan in float64 (the
    dense operator and the layers in float64, run in SGP_CHUNK-step chunks
    with the state carried): the max error over the largest value."""
    from sgp_tpu_torch.encode import GraphESN
    g64 = GraphESN.from_arrays([dict(
        w_ih=p.w_ih.cpu().numpy(), w_hh=p.w_hh.cpu().numpy(),
        b_ih=None if p.b_ih is None else p.b_ih.cpu().numpy(),
        alpha=p.alpha) for p in enc.gesn.layers], enc.gesn.activation,
        device=x.device)
    g64.layers = [type(p)(p.w_ih.double(), p.w_hh.double(),
                          None if p.b_ih is None else p.b_ih.double(),
                          p.alpha) for p in g64.layers]
    op64 = type(op)(op.mat.double())
    h, err, top = None, dict.fromkeys(outs, 0.0), 0.0
    for s in range(0, x.shape[0], SGP_CHUNK):
        e = min(s + SGP_CHUNK, x.shape[0])
        ref, h = g64(x[s:e].double(), op64, h0=h, with_state=True)
        top = max(top, ref.abs().max().item())
        for k, v in outs.items():
            err[k] = max(err[k], (v[s:e].double() - ref).abs().max().item())
        del ref
    return {k: v / top for k, v in err.items()}


class ClosedFormRecorder:
    """Instruments ``run_closed_form`` runs from outside: the encode's wall
    (``encode_dataset``), the Gram and solve (``closed_form_readout`` or
    its streaming form; every solve optionally in float64 on the host), the
    evaluation (from the readout's return to the run's), K1's launches, the
    solves whose Cholesky failed (then solved by the SVD) and peak device
    memory. ``reuse`` keeps each device's first encoding and
    hands it to that device's later runs (the float64 rerun)."""

    def __init__(self, reuse: bool = False):
        import sgp_tpu_torch.exp.run_closed_form as runner
        self.runner = runner
        self.reuse = reuse
        self.cache = {}

    def run(self, argv, device, bsr: bool = False, f64: bool = False):
        from sgp_tpu_torch.encode import rewire_exog_keys
        from sgp_tpu_torch.exp.common import Experiment
        from sgp_tpu_torch.ops import bsr_spmm
        import sgp_tpu_torch.train.ridge as ridge
        runner, rec = self.runner, {}
        cuda = device.type == "cuda"
        orig = {k: getattr(runner, k) for k in (
            "encode_dataset", "closed_form_readout",
            "closed_form_readout_streaming")}
        solve = ridge.solve_ridge_normal

        def sync():
            if cuda:
                torch.cuda.synchronize()

        def encode(ds, encoder, **kw):
            sync()
            t0 = time.perf_counter()
            key = str(device)
            if self.reuse and key in self.cache:
                ds.add_covariate("encoded_x", self.cache[key],
                                 pattern="t n c")
                ds.set_input_keys(["encoded_x"])
                rewire_exog_keys(ds, kw["encode_exogenous"],
                                 kw["keep_raw"])
            else:
                orig["encode_dataset"](ds, encoder, **kw)
                if self.reuse:
                    self.cache[key] = ds.covariates["encoded_x"].value
            sync()
            rec["encode_ms"] = (time.perf_counter() - t0) * 1e3
            return ds

        def timed_readout(name):
            def fn(*args, **kw):
                sync()
                t0 = time.perf_counter()
                out = orig[name](*args, **kw)
                sync()
                rec["readout_end"] = time.perf_counter()
                rec["gram_solve_ms"] = (rec["readout_end"] - t0) * 1e3
                return out
            return fn

        def solve64(gram, moment, alpha):
            g = gram.double().cpu().numpy()
            w = np.linalg.solve(g + alpha * np.eye(g.shape[0]),
                                moment.double().cpu().numpy())
            return torch.as_tensor(w, dtype=torch.float32,
                                   device=gram.device)

        def route(args):
            if bsr:
                args.operator_mode = "bsr"
            return runner.run_experiment(args)

        runner.encode_dataset = encode
        for name in ("closed_form_readout", "closed_form_readout_streaming"):
            setattr(runner, name, timed_readout(name))
        if f64:
            ridge.solve_ridge_normal = solve64
        cholesky = torch.linalg.cholesky_ex
        infos = []

        def cholesky_ex(a):         # which solves fell back to the SVD
            chol, info = cholesky(a)
            infos.append(int(info))
            return chol, info

        torch.linalg.cholesky_ex = cholesky_ex
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        bsr_spmm.launches = 0
        t0 = time.perf_counter()
        try:
            res = Experiment(route, runner.configure_parser()).run(
                argv + ["--device", str(device)])
        finally:
            for k, v in orig.items():
                setattr(runner, k, v)
            ridge.solve_ridge_normal = solve
            torch.linalg.cholesky_ex = cholesky
        end = time.perf_counter()
        out = dict(res, launches=bsr_spmm.launches,
                   cholesky_failed=sum(i != 0 for i in infos),
                   wall_s=end - t0, encode_ms=rec["encode_ms"],
                   gram_solve_ms=rec["gram_solve_ms"],
                   eval_ms=(end - rec["readout_end"]) * 1e3)
        if cuda:
            out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        return out


def phase16_runner(device) -> dict:
    """(b) ``run_closed_form`` through ``Experiment(...).run(argv)`` on
    gesn_la.yaml: the host route on 207 nodes (card and CPU port, each
    also with every ridge solve in float64 on the host), then
    ``--device-resident true`` on 5,016 nodes x 640 steps, dense and with
    ``operator_mode = "bsr"`` on the namespace."""
    cpu = torch.device("cpu")
    rec = ClosedFormRecorder(reuse=True)
    argv = ["--config", str(GESN_CONFIG), "--dataset-name", "synthetic",
            "--seed", str(SEED)]
    host = argv + ["--synthetic-nodes", str(LA_NODES), "--synthetic-steps",
                   str(GESN_LA_STEPS)]
    runs = {}
    for name, dev, f64 in (("card", device, False), ("card_f64", device, True),
                           ("cpu", cpu, False), ("cpu_f64", cpu, True)):
        runs[name] = rec.run(host, dev, f64=f64)
        print(f"[phase 16] (b) host route, {LA_NODES} nodes x "
              f"{GESN_LA_STEPS} steps, {name}: {json.dumps(runs[name])}")
        assert all(np.isfinite(v) for v in runs[name].values()), runs[name]
        assert runs[name]["launches"] == 0, runs[name]
    gaps = {d: abs(runs[d]["test_mae"] - runs[f"{d}_f64"]["test_mae"])
            for d in ("card", "cpu")}
    tol = max(TOL_CF * abs(runs["cpu"]["test_mae"]), 3 * max(gaps.values()))
    diff = abs(runs["card"]["test_mae"] - runs["cpu"]["test_mae"])
    held = dict(card_vs_cpu=diff, tol=tol, f32_vs_f64_solve_gap=gaps,
                f64_card_vs_cpu=abs(runs["card_f64"]["test_mae"]
                                    - runs["cpu_f64"]["test_mae"]))
    print(f"[phase 16] (b) host route test MAE, card vs CPU port: "
          f"{json.dumps(held)}")
    assert diff <= tol, held
    rec = ClosedFormRecorder()
    resident = argv + ["--synthetic-nodes", str(N_NODES),
                       "--synthetic-steps", str(N_STEPS),
                       "--device-resident", "true"]
    layers = read_flat_yaml(GESN_CONFIG)["reservoir_layers"]
    for name, bsr in (("dense", False), ("bsr", True)):
        runs[f"resident_{name}"] = r = rec.run(resident, device, bsr=bsr)
        print(f"[phase 16] (b) --device-resident true, {N_NODES} nodes x "
              f"{N_STEPS} steps, {name} operator: {json.dumps(r)}")
        assert all(np.isfinite(v) for v in r.values()), r
        assert r["launches"] == (N_STEPS * layers if bsr else 0), r
    gap = abs(runs["resident_bsr"]["test_mae"]
              - runs["resident_dense"]["test_mae"])
    print(f"[phase 16] (b) device-resident test MAE, BSR vs dense route: "
          f"{gap:.3e}")
    return runs


def phase16_serve(raw, device) -> dict:
    """(c) ``OnlineGESNForecaster`` on the runner's 5,016-node graph over
    BSR at gesn_la.yaml's widths (input: the target alone), readouts
    fitted by ``closed_form_readout`` on an offline encode of the first
    GESN_FIT_STEPS steps: warm-up plus GESN_SERVE_STEPS steps held to the
    offline encode and the stacked readouts, 1 stream and 4 (each held to
    a forecaster of its own); K1's launches a step and step latencies."""
    from sgp_tpu_torch.data import StandardScaler
    from sgp_tpu_torch.ops import bsr_spmm
    from sgp_tpu_torch.serve import OnlineGESNForecaster
    from sgp_tpu_torch.train.ridge import closed_form_readout
    cfg = read_flat_yaml(GESN_CONFIG)
    graph = raw.get_connectivity(threshold=0.1, knn=None,
                                 include_self=False)
    enc = gesn_encoder(cfg, 1, "bsr", device)
    layers, lags = cfg["reservoir_layers"], cfg["horizon"]
    fit, warm, steps = GESN_FIT_STEPS, GESN_SERVE_WARM, GESN_SERVE_STEPS
    span = warm + steps + GESN_SERVE_TIMED
    sc = StandardScaler(axis=(0, 1)).fit(raw.target[:fit], raw.mask[:fit])
    scaler = sc.params(device=device)
    x_raw = torch.as_tensor(raw.target, device=device)   # [T, N, 1]
    xs = scaler.transform(x_raw)
    offline = enc(xs[:fit], graph)                        # [fit, N, D]
    tr = fit - lags
    readouts = closed_form_readout(
        offline[:tr].reshape(-1, offline.shape[-1]),
        [xs[1 + lag:tr + 1 + lag].reshape(-1, 1) for lag in range(lags)],
        alpha=cfg["l2_reg"])
    w = torch.stack([a for a, _ in readouts])
    b = torch.stack([c for _, c in readouts])

    def expect(h):          # [.., N, D] -> [.., L, N, 1] raw
        return scaler.inverse_transform(
            torch.einsum("...nd,ldc->...lnc", h, w) + b[:, None])

    streams = torch.stack([x_raw[s * STREAM_OFFSET:s * STREAM_OFFSET + span]
                           for s in range(STREAMS)], 1)  # [span, S, N, 1]
    ref = enc(scaler.transform(streams[:warm + steps]), graph)
    out = {}
    for name, lead in (("1_stream", None), (f"{STREAMS}_streams", STREAMS)):
        fc = OnlineGESNForecaster(enc, graph, readouts, scaler,
                                  n_streams=lead, device=device)
        fc.warm_up(streams[:warm, 0] if lead is None else streams[:warm])
        singles = [OnlineGESNForecaster(enc, graph, readouts, scaler,
                                        device=device)
                   for _ in range(STREAMS if lead else 0)]
        for i, f in enumerate(singles):
            f.warm_up(streams[:warm, i])
        errs, lat, launches = [], [], []
        for t in range(warm, span):
            obs = streams[t, 0] if lead is None else streams[t]
            torch.cuda.synchronize()
            before = bsr_spmm.launches
            t0 = time.perf_counter()
            y = fc.step(obs)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            launches.append(bsr_spmm.launches - before)
            if t < warm + steps:
                errs.append(rel_err(y, expect(ref[t, 0] if lead is None
                                              else ref[t]))[1])
                errs += [rel_err(y[i], f.step(obs[i]))[1]
                         for i, f in enumerate(singles)]
        out[name] = dict(shape=list(y.shape), max_rel_err=max(errs),
                         k1_launches_per_step=sorted(set(launches)),
                         step_ms=quartiles(lat[steps:]))
        print(f"[phase 16] (c) OnlineGESNForecaster {name}: "
              f"{json.dumps(out[name])}")
        assert max(errs) <= TOL_F32, out[name]
        assert set(launches) == {layers}, out[name]
        assert bool(torch.isfinite(y).all())
    return out


def phase16_wavefront(raw, graph, device) -> dict:
    """(d) ``reservoir_scan(mode="wavefront")`` against the sequential scan
    on phase 11's input at sgp_pv.yaml's reservoir (8 x 16), T 640, N
    5,016: the states within max(1e-5, twice the sequential scan's
    distance to float64), both walls in turns, and each scan's device
    activities a step (torch.profiler over 32 steps)."""
    from torch.profiler import ProfilerActivity, profile
    from sgp_tpu_torch.encode import encoder_input_array, reservoir_scan
    cfg, ds, _ = sgp_setup(raw, graph)
    x = torch.as_tensor(encoder_input_array(ds, cfg["preprocess_exogenous"]),
                        device=device)
    res = sgp_encoder(cfg, x.shape[-1], "dense", device).reservoir
    walls, outs = {"sequential": [], "wavefront": []}, {}
    for mode in ("sequential", "wavefront", "wavefront", "sequential"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[mode] = reservoir_scan(res.layers, res.activation, x,
                                    mode=mode)
        torch.cuda.synchronize()
        walls[mode].append((time.perf_counter() - t0) * 1e3)
    err = max(by_chunks(x.shape[0], lambda s, e: (
        outs["wavefront"][s:e] - outs["sequential"][s:e]).abs().max()
        .item()))
    # the two orders of summation differ by rounding that the recurrence
    # (spectral radius 0.99, leak 1.0) carries on: each scan is held within
    # the larger of TOL_F32 and twice the sequential scan's distance to the
    # same scan in float64
    layers64 = [type(p)(p.w_ih.double(), p.w_hh.double(),
                        None if p.b_ih is None else p.b_ih.double(), p.alpha)
                for p in res.layers]
    ref = reservoir_scan(layers64, res.activation, x.double())
    f64 = {k: max(by_chunks(x.shape[0], lambda s, e: (
        v[s:e].double() - ref[s:e]).abs().max().item()))
        for k, v in outs.items()}
    del outs, ref
    tol = max(TOL_F32, 2 * f64["sequential"])
    per_step = {}
    for mode in walls:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            reservoir_scan(res.layers, res.activation, x[:32], mode=mode)
            torch.cuda.synchronize()
        busy = device_busy(prof, 32)
        per_step[mode] = {k: busy.get(k) for k in (
            "device_activities", "device_busy_ms")} if busy else \
            "not measured (no device activity traced)"
    row = dict(t=x.shape[0], n=x.shape[1], layers=len(res.layers),
               hidden=res.hidden_size, max_abs_err=err,
               vs_float64_max_abs_err=f64, tol=tol, wall_ms=walls,
               per_step=per_step)
    print(f"[phase 16] (d) wavefront vs sequential scan: {json.dumps(row)}")
    assert err <= tol and f64["wavefront"] <= tol, row
    return row


def phase16_predictor(raw, graph, device) -> dict:
    """(e) ``Predictor(compute_dtype="bfloat16")`` against f32 on phase 5's
    GatedGN slice (K4): step ms in turns and peak memory, K4's launches,
    the first bf16 loss against the CPU port's; then ``save_state``, a new
    ``Predictor``, ``load_state`` and two more steps against the
    uninterrupted run."""
    import tempfile
    from sgp_tpu_torch.graph import padded_incoming
    from sgp_tpu_torch.ops import gn_ell
    cfg, ds, split = gn_data(raw, graph)
    src_idx, nmask = padded_incoming(graph)
    static = {"gn_neigh": (src_idx, nmask)}
    f32 = gn_predictor(cfg, ds, static, device)
    init = {k: v.detach().clone() for k, v in f32.model.state_dict().items()}
    bf16 = gn_predictor(cfg, ds, static, device, init,
                        compute_dtype="bfloat16")
    batches = list(loaders(cfg, ds, split, PRED_STEPS)[0])
    for fn in (gn_ell.gn_ell_fwd, gn_ell.gn_ell_bwd):
        fn.launches = 0
    first = float(bf16.train_step(batches[0]))
    launches = {fn.__name__: fn.launches
                for fn in (gn_ell.gn_ell_fwd, gn_ell.gn_ell_bwd)}
    t0 = time.perf_counter()
    on_cpu = gn_predictor(cfg, ds, static, torch.device("cpu"),
                          {k: v.cpu() for k, v in init.items()},
                          compute_dtype="bfloat16")
    cpu_first = float(on_cpu.train_step(batches[0]))
    cpu_s = time.perf_counter() - t0
    times, peak = {"f32": [], "bf16": []}, {}
    for name in ("f32", "bf16", "bf16", "f32"):
        pred = f32 if name == "f32" else bf16
        torch.cuda.reset_peak_memory_stats()
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(pred.train_step(batch))
            if i >= TIME_DROP:
                times[name].append((time.perf_counter() - t0) * 1e3)
            assert np.isfinite(loss), (name, loss)
        peak[name] = max(peak.get(name, 0.0),
                         torch.cuda.max_memory_allocated() / 2**20)
    # resume: save after two steps, two more steps, against a new trainer
    run = gn_predictor(cfg, ds, static, device, init,
                       compute_dtype="bfloat16")
    for batch in batches[:2]:
        run.train_step(batch)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/state.pt"
        run.save_state(path, epoch=1, best_metric=first)
        want = [float(run.train_step(b)) for b in batches[2:4]]
        resumed = gn_predictor(cfg, ds, static, device,
                               compute_dtype="bfloat16")
        extra = resumed.load_state(path)
        got = [float(resumed.train_step(b)) for b in batches[2:4]]
    resume_err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    row = dict(first_loss_bf16=first, first_loss_cpu_bf16=cpu_first,
               cpu_rel_err=abs(first - cpu_first) / abs(cpu_first),
               cpu_s=cpu_s, k4_launches_first_step=launches,
               step_ms={k: quartiles(v) for k, v in times.items()},
               peak_mib=peak, resume_losses=got, uninterrupted_losses=want,
               resume_rel_err=resume_err, extra_epoch=extra["epoch"])
    print(f"[phase 16] (e) Predictor compute_dtype: {json.dumps(row)}")
    assert row["cpu_rel_err"] <= 2e-2, row
    assert min(launches.values()) >= cfg["gnn_layers"], row
    assert resume_err <= 1e-6 and extra["epoch"] == 1, row
    return row


def phase16_gesn(raw, graph, device) -> dict:
    """DynGESN and the rest of A7: (a) the encode through K1, (b) the
    closed-form runner, (c) GESN serving, (d) the wavefront scan, (e)
    ``Predictor``'s compute_dtype and save_state."""
    k1 = phase16_encode(raw, device)
    torch.cuda.empty_cache()
    runs = phase16_runner(device)
    torch.cuda.empty_cache()
    serve_rows = phase16_serve(raw, device)
    torch.cuda.empty_cache()
    wave = phase16_wavefront(raw, graph, device)
    torch.cuda.empty_cache()
    pred = phase16_predictor(raw, graph, device)
    return dict(k1=k1, launches=runs["resident_bsr"]["launches"],
                runs=runs, serve=serve_rows, wavefront=wave,
                predictor=pred)


# phase 17, the forecaster export and the imputation runner (every cut is
# in these constants)
EXPORT_STEPS = 50       # (a) steps of each loaded artifact held to the live
TOL_EXPORT = 1e-5       # (a) loaded vs live forecast, of the largest value
GRIN_WINDOW = 24        # (b) GRIN's published widths: window 24, batch 32,
GRIN_BATCH = 32         # hidden 64, ff 64, 1 layer, kernel_size 2,
GRIN_HIDDEN = 64        # decoder_order 1
GRIN_FF = 64
# (b) autograd's saved bytes a (window x node) of one GRIN train step at
# hidden 64, window 24 (counted on the CPU, 500 nodes x 4 windows, through
# saved_tensors_hooks): the BSR route also keeps each hop's folded input
GRIN_SAVED_BYTES = {"dense": 386146, "bsr": 511808}
MEM_SHARE = 0.85        # (b) the share of the card a reckoned peak may take
GRIN_TIME_ORDER = ("bsr", "dense", "dense", "bsr")   # (b) timed steps
TOL_GRIN_LOSS = 1e-5    # (b) BSR vs dense supports: the loss, relative
TOL_GRIN_GRAD = 1e-4    # (b) each gradient, of its parameter's largest
IMP_STEPS = 640         # (c) the runner's series: T cut from PV-US's 8,868
                        # (at 320 the temporal split leaves no validation
                        # window of 24 steps)
IMP_RUN = ["--epochs", "1", "--batches-epoch", "2"]


def phase17_export_round(name, fc, device, obs) -> dict:
    """Export ``fc``, load it, and step both ``EXPORT_STEPS`` times on the
    raw observations ``obs``: the loaded forecasts against the live ones,
    both step latencies (synchronized), K1's launches inside the loaded
    program, the artifact's bytes and the export's wall."""
    import tempfile
    from sgp_tpu_torch.ops import bsr_spmm
    from sgp_tpu_torch.serve import export_forecaster, load_forecaster
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        size = export_forecaster(fc, f"{tmp}/fc.pt2")
        export_s = time.perf_counter() - t0
        loaded = load_forecaster(f"{tmp}/fc.pt2")
    errs, lat, launches = [], {"live": [], "loaded": []}, []
    for t in range(EXPORT_STEPS):
        x = torch.as_tensor(obs[t], device=device)
        ys = {}
        for which, f in (("live", fc), ("loaded", loaded)):
            torch.cuda.synchronize()
            before = bsr_spmm.launches
            t0 = time.perf_counter()
            ys[which] = f.step(x)
            torch.cuda.synchronize()
            lat[which].append((time.perf_counter() - t0) * 1e3)
            if which == "loaded":
                launches.append(bsr_spmm.launches - before)
        errs.append(rel_err(ys["loaded"], ys["live"])[1])
        assert bool(torch.isfinite(ys["loaded"]).all()), (name, t)
    row = dict(case=name, shape=list(ys["loaded"].shape),
               artifact_bytes=size, export_s=export_s,
               max_rel_err=max(errs), tol=TOL_EXPORT,
               k1_launches_per_loaded_step=sorted(set(launches)),
               k1_launches=sum(launches),
               step_ms={k: quartiles(v[2:]) for k, v in lat.items()})
    print(f"[phase 17] (a) exported {name}: {json.dumps(row)}")
    assert max(errs) <= TOL_EXPORT, row
    assert min(launches) > 0, row
    return row


def phase17_export(ds, graph, scaler, device) -> dict:
    """(a) ``export_forecaster`` / ``load_forecaster``: ``OnlineForecaster``
    at sgp_pv.yaml's widths on the 100-nn graph (``operator_mode="bsr"``),
    1 and 4 streams, and ``OnlineGESNForecaster`` at gesn_la.yaml's widths
    on the runner's similarity graph (BSR; readouts drawn from the seed),
    1 and 4 streams."""
    from sgp_tpu_torch.ops import bsr_spmm
    from sgp_tpu_torch.serve import OnlineForecaster, OnlineGESNForecaster
    target = ds.target                                     # [T, N, 1]
    streams = np.stack([target[s * STREAM_OFFSET:s * STREAM_OFFSET
                               + EXPORT_STEPS] for s in range(STREAMS)], 1)
    enc, model, sp = build_slice(graph, scaler, "bsr", device, N_NODES)
    cfg = read_flat_yaml(GESN_CONFIG)
    g_graph = ds.get_connectivity(threshold=0.1, knn=None,
                                  include_self=False)
    g_enc = gesn_encoder(cfg, 1, "bsr", device)
    gen = torch.Generator().manual_seed(SEED)
    width = g_enc.output_size
    readouts = [(torch.randn(width, 1, generator=gen) / width ** 0.5,
                 torch.zeros(1)) for _ in range(cfg["horizon"])]
    cases = {}
    for lead in (None, STREAMS):
        cases[f"OnlineForecaster {lead or 1} stream(s)"] = OnlineForecaster(
            enc, graph, model, sp, n_streams=lead, device=device)
        cases[f"OnlineGESNForecaster {lead or 1} stream(s)"] = \
            OnlineGESNForecaster(g_enc, g_graph, readouts, sp,
                                 n_streams=lead, device=device)
    overhead = op_dispatch_us(enc, graph, device)
    bsr_spmm.launches = 0                 # the main path: the loaded steps
    rows = {name: phase17_export_round(
        name, fc, device, streams[:, 0] if fc.n_streams is None else streams)
        for name, fc in cases.items()}
    return dict(rows=rows, op_dispatch=overhead,
                launches=sum(r["k1_launches"] for r in rows.values()))


def op_dispatch_us(enc, graph, device, calls: int = 100,
                   rounds: int = 5) -> dict:
    """The host's cost of a K1 call through the custom op ``sgp::bsr_spmm``
    (``bsr_spmm``: the dispatcher, the autograd layer, the fake-free CUDA
    kernel) against the same launcher called directly (``_launch``), at
    the serving hop's shape: host us a call to enqueue ``calls`` calls
    (no synchronize inside), in turns op, direct, direct, op."""
    from sgp_tpu_torch.ops import build_operator, bsr_kernel
    op = build_operator(graph, "bsr", device=device)
    args = (op.blocks, op.block_cols, op.row_ptr, op.block_rows)
    x = torch.randn(graph.num_nodes, enc.reservoir.output_size,
                    device=device)
    fns = {"op": lambda: bsr_kernel.bsr_spmm(*args, x),
           "direct": lambda: bsr_kernel._launch(*args, x)}
    us = {k: [] for k in fns}
    with torch.no_grad():
        for _ in range(rounds):
            for name in ("op", "direct", "direct", "op"):
                fns[name]()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fns[name]()
                us[name].append((time.perf_counter() - t0) * 1e6 / calls)
                torch.cuda.synchronize()
    row = {k: quartiles(v) for k, v in us.items()}
    row["f"] = x.shape[1]
    print(f"[phase 17] (a) host us a K1 call, op vs direct: "
          f"{json.dumps(row)}")
    return row


def phase17_data(ds, graph, device, batch: int):
    """The imputation runner's batch at GRIN's window on phase 5's series:
    ``ImputationDataset`` with ``add_missing_values`` at the runner's
    defaults, ``StandardScaler`` on the training mask, the first ``batch``
    windows scaled, on the card."""
    from sgp_tpu_torch.data import StandardScaler, Windowing
    from sgp_tpu_torch.data.imputation import (ImputationDataset,
                                               add_missing_values)
    imp = ImputationDataset(ds.target, mask=ds.mask, graph=graph,
                            windowing=Windowing(window=GRIN_WINDOW,
                                                horizon=1))
    add_missing_values(imp)
    ev = imp.covariates["eval_mask"].value.astype(bool)
    sc = StandardScaler(axis=(0, 1)).fit(imp.target, mask=imp.mask & ~ev)
    sp = sc.params(device=device)
    b = imp.gather_batch(np.arange(batch))

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(a).to(device=device, dtype=dtype)
    return {"x": sp.transform(dev(b["x"])), "y": sp.transform(dev(b["y"])),
            "mask": dev(b["mask"], torch.bool),
            "eval_mask": dev(b["eval_mask"], torch.bool)}


def grin_batch(route: str, n_nodes: int, device) -> dict:
    """The largest batch of 32, 16, 8, .. whose reckoned peak (autograd's
    saved bytes of a step, ``GRIN_SAVED_BYTES``, the two dense supports
    and what the earlier phases hold) fits ``MEM_SHARE`` of the card."""
    total = torch.cuda.get_device_properties(device).total_memory
    held = torch.cuda.memory_allocated(device)
    supports = 2 * n_nodes * n_nodes * 4
    batch = GRIN_BATCH
    while True:
        peak = GRIN_SAVED_BYTES[route] * batch * n_nodes * GRIN_WINDOW / 24 \
            + supports + held
        if peak <= MEM_SHARE * total or batch == 1:
            break
        batch //= 2
    row = dict(route=route, batch=batch, reckoned_peak_gib=peak / 2**30,
               held_gib=held / 2**30, card_gib=total / 2**30,
               cut=batch != GRIN_BATCH)
    print(f"[phase 17] GRIN's reckoned peak: {json.dumps(row)}"
          + (f" (batch cut from {GRIN_BATCH}: the reckoned peak at "
             f"{GRIN_BATCH} passes {MEM_SHARE:.0%} of the card)"
             if row["cut"] else ""))
    return row


def grin_model(device):
    from sgp_tpu_torch.models import GRINModel
    return GRINModel(1, GRIN_HIDDEN, n_nodes=N_NODES, kernel_size=2,
                     decoder_order=1, ff_size=GRIN_FF,
                     generator=torch.Generator().manual_seed(SEED)).to(device)


def phase17_grin(ds, graph, device) -> dict:
    """(b) One GRIN train step (``train/imputer.py``; the whitening mask
    drawn once and handed to both) on ``diff_conv_support(g,
    operator_mode="bsr")`` (K1 under every hop, forward and backward)
    against the same step on the dense supports, from the same weights:
    the loss and every gradient; K1's launches; then steps in turns (ms,
    peak memory), a profiled BSR step (device busy, idle share), and K1 at
    the cell's and the decoder's hop widths against its plain version, the
    bound, cuSPARSE and the dense matmul."""
    from torch.profiler import ProfilerActivity, profile
    from sgp_tpu_torch.models import diff_conv_support
    from sgp_tpu_torch.ops import bsr_spmm
    from sgp_tpu_torch.train.imputer import (draw_keep, imputer_loss,
                                             make_imputer_train_step)
    from sgp_tpu_torch.train.predictor import make_optimizer
    mem = grin_batch("bsr", N_NODES, device)
    batch = phase17_data(ds, graph, device, mem["batch"])
    keep = draw_keep(batch["mask"], 0.05,
                     torch.Generator(device=device).manual_seed(SEED))
    sup = {m: diff_conv_support(graph, operator_mode=m, device=device)
           for m in ("bsr", "dense")}
    base = grin_model(device)
    first = {}
    for route in ("bsr", "dense"):
        model = copy.deepcopy(base)

        def call(b, training, s=sup[route]):
            return (b["x"], s), {"mask": b["mask"], "training": training}
        torch.cuda.synchronize()
        bsr_spmm.launches = 0             # the main path: the BSR step
        loss = imputer_loss(model, batch, call, keep)
        torch.cuda.synchronize()
        fwd = bsr_spmm.launches
        loss.backward()
        torch.cuda.synchronize()
        first[route] = dict(loss=float(loss.detach()), k1_fwd=fwd,
                            k1_step=bsr_spmm.launches,
                            grads={k: p.grad.detach().clone() for k, p in
                                   model.named_parameters()})
        del loss, model
        torch.cuda.empty_cache()
    hops = 2 * GRIN_WINDOW * 10
    grad_err = max(
        (first["bsr"]["grads"][k] - g).abs().max().item()
        / max(g.abs().max().item(), 1e-6)
        for k, g in first["dense"]["grads"].items())
    loss_err = abs(first["bsr"]["loss"] - first["dense"]["loss"]) \
        / abs(first["dense"]["loss"])
    row = dict(batch=mem["batch"], window=GRIN_WINDOW, hidden=GRIN_HIDDEN,
               loss={r: first[r]["loss"] for r in first},
               loss_rel_err=loss_err, grad_rel_err=grad_err,
               tol_loss=TOL_GRIN_LOSS, tol_grad=TOL_GRIN_GRAD,
               k1_launches_fwd=first["bsr"]["k1_fwd"],
               k1_launches_step=first["bsr"]["k1_step"],
               k1_launches_dense_route=first["dense"]["k1_step"],
               hops_fwd=hops)
    # the gate: the routes sum every hop in another order (K1's tiles, the
    # SGEMM's k-split) and carry it through 24 recurrent steps, forward and
    # back; the CPU port against the JAX package, the same kind of gap,
    # measured 1.1e-5 of a parameter's largest gradient: 1e-4 leaves 9x
    print(f"[phase 17] (b) GRIN step, BSR vs dense supports: "
          f"{json.dumps(row)}")
    assert loss_err <= TOL_GRIN_LOSS and grad_err <= TOL_GRIN_GRAD, row
    assert first["bsr"]["k1_fwd"] == hops, row
    assert first["bsr"]["k1_step"] == 2 * hops - 2 * 8, row
    assert first["dense"]["k1_step"] == 0, row
    del first
    steps, times, peak = {}, {"bsr": [], "dense": []}, {}
    for route in ("bsr", "dense"):
        model = copy.deepcopy(base)
        opt, sched = make_optimizer(list(model.parameters()), 1e-3)
        steps[route] = make_imputer_train_step(
            model, opt, lambda b, tr, s=sup[route]: (
                (b["x"], s), {"mask": b["mask"], "training": tr}),
            grad_clip=GRAD_CLIP, scheduler=sched,
            generator=torch.Generator(device=device).manual_seed(SEED))
    for route in GRIN_TIME_ORDER:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(steps[route](batch))
        times[route].append((time.perf_counter() - t0) * 1e3)
        peak[route] = max(peak.get(route, 0.0),
                          torch.cuda.max_memory_allocated() / 2**20)
        assert np.isfinite(loss), (route, loss)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps["bsr"](batch)
        torch.cuda.synchronize()
    busy = device_busy(prof, 1)
    step_ms = {k: quartiles(v) for k, v in times.items()}
    row.update(step_ms=step_ms, peak_mib=peak)
    if busy:
        row.update(device_busy_ms=busy["device_busy_ms"],
                   device_activities=busy["device_activities"],
                   idle_share=1.0 - busy["device_busy_ms"]
                   / step_ms["bsr"]["median"],
                   device_ms_by_name=busy["device_ms_by_name"])
    else:
        row["idle_share"] = "not measured (no device activity traced)"
    print(f"[phase 17] (b) GRIN step times: {json.dumps(row)}")
    del steps, prof
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED)
    k1 = {}
    # a time step and direction: the cell's 4 hops of [x, m, h], its 4 of
    # r * h and the decoder's 2, each once forward and once backward (dx),
    # but for the last step's cell, whose state reaches no loss
    w = GRIN_WINDOW
    for width, launches, case in (
            (2 + GRIN_HIDDEN, 2 * 4 * (2 * w - 1),
             "GRIN cell hop of [x, m, h]"),
            (GRIN_HIDDEN, 2 * (4 * (2 * w - 1) + 2 * 2 * w),
             "GRIN hops of r * h and the decoder's")):
        x = torch.as_tensor(rng.standard_normal(
            (mem["batch"], N_NODES, width)).astype(np.float32), device=device)
        k1[width] = k1_at_support_width(sup["bsr"][0], sup["dense"][0], x,
                                        "phase 17", case)
        k1[width]["launches_per_step"] = launches
        del x
    return dict(step=row, k1=k1, launches=row["k1_launches_step"])


class ImputationRecorder:
    """Times each train step of ``run_imputation`` (synchronized) through
    a wrapper of its ``make_imputer_train_step``, and K1's launches."""

    def __init__(self):
        self.ms = []

    @contextlib.contextmanager
    def active(self):
        from sgp_tpu_torch.exp import run_imputation
        make = run_imputation.make_imputer_train_step

        def wrapped(*a, **k):
            step = make(*a, **k)

            def timed_step(batch, keep=None):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = step(batch, keep)
                torch.cuda.synchronize()
                self.ms.append((time.perf_counter() - t0) * 1e3)
                return loss
            return timed_step
        run_imputation.make_imputer_train_step = wrapped
        try:
            yield self
        finally:
            run_imputation.make_imputer_train_step = make


def phase17_runners(device) -> dict:
    """(c) ``exp/run_imputation.py`` through ``Experiment(...).run(argv)``
    for ``grin``, ``rnni`` and ``birnni`` at GRIN's widths on
    ``SyntheticDiffusion(5016, IMP_STEPS)`` (the runner's graph: the
    similarity graph at threshold 0.1, dense supports by ``auto``), one
    epoch of 2 batches: test MAE and MRE, ms a batch, the run's wall."""
    from sgp_tpu_torch.exp import run_imputation
    from sgp_tpu_torch.exp.common import Experiment
    batch = grin_batch("dense", N_NODES, device)["batch"]
    out = {}
    for name in ("grin", "rnni", "birnni"):
        argv = ["--model-name", name, "--dataset-name", "synthetic",
                "--synthetic-nodes", str(N_NODES), "--synthetic-steps",
                str(IMP_STEPS), "--window", str(GRIN_WINDOW),
                "--batch-size", str(batch), "--hidden-size",
                str(GRIN_HIDDEN), "--ff-size", str(GRIN_FF), "--seed",
                str(SEED), "--device", str(device), *IMP_RUN]
        rec = ImputationRecorder()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with rec.active():
            res = Experiment(run_imputation.run_experiment,
                             run_imputation.configure_parser()).run(argv)
        out[name] = dict(batch=batch, wall_s=time.perf_counter() - t0,
                         step_ms=rec.ms,
                         peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                         **res)
        print(f"[phase 17] (c) run_imputation {name}: "
              f"{json.dumps(out[name])}")
        assert all(np.isfinite(res[k]) for k in (
            "test_mae", "test_mse", "test_mre", "val_mae")), out[name]
        assert res["val_mae"] > 0, out[name]     # validation scored points
        assert len(rec.ms) == 2, out[name]
        torch.cuda.empty_cache()
    return out


def phase17_export_and_imputation(ds, graph, scaler, device) -> dict:
    """The forecaster export (a) and the imputation slice: GRIN's step on
    BSR against dense supports (b) and the runner (c)."""
    export = phase17_export(ds, graph, scaler, device)
    torch.cuda.empty_cache()
    grin = phase17_grin(ds, graph, device)
    torch.cuda.empty_cache()
    runs = phase17_runners(device)
    return dict(export=export, grin=grin, runs=runs)


# phase 18, the rest of the model zoo on phase 5's data (5,016 nodes x 640
# steps, the 100-nn graph): STCN and RNN-enc/GCN-dec at the traffic
# runner's default widths (hidden 64, ff 128, n_layers 1, rec_layers 1,
# temporal kernel 2, dropout 0) with configs/traffic/dcrnn.yaml's data
# flags (window 12, horizon 12, batch 64): the repo has no STCN yaml
ZOO_CONFIG = ROOT / "configs" / "traffic" / "dcrnn.yaml"
ZOO_TIME_ORDER = ("bsr", "dense", "dense", "bsr")   # (a), (b) step timing
ZOO_TIME_STEPS = 2      # steps a round
# (a), (b) one step on the BSR operator against the dense one from the same
# weights and batch: the loss relative, each gradient of its parameter's
# largest (K1's tiles against the SGEMM's k-split, summed in other orders)
TOL_ZOO_LOSS = 1e-5
TOL_ZOO_GRAD = 1e-4
ZOO_RUN = ["--epochs", "1", "--batches-epoch", "2"]   # (e) the runner
MON_WINDOW = 64         # (f) the monitor's window and the residuals fed
MON_STEPS = 64
TOL_MON = 1e-9          # (f) card vs CPU port: float64 on both


def zoo_data(ds, graph, device):
    """The traffic runner's dataset on phase 5's series: the datetime
    encoding as ``u``, dcrnn.yaml's windowing and temporal split, the
    standard scaler on the train windows; one train batch of 64."""
    from sgp_tpu_torch.data import (SpatioTemporalDataset, StandardScaler,
                                    TemporalSplitter, WindowedLoader,
                                    Windowing)
    cfg = read_flat_yaml(ZOO_CONFIG)
    sds = SpatioTemporalDataset(
        ds.target, index=ds.index, mask=ds.mask, graph=graph,
        covariates={"u": ds.datetime_encoded("day")},
        windowing=Windowing(window=cfg["window"], horizon=cfg["horizon"]))
    split = TemporalSplitter(cfg["val_len"], cfg["test_len"]).split(sds)
    sds.fit_scaler(StandardScaler(axis=(0, 1)),
                   step_index=sds.indices()[split.train])
    loader = WindowedLoader(sds, split.train, batch_size=cfg["batch_size"],
                            shuffle=True, seed=SEED)
    return sds, next(iter(loader))


def zoo_step(name, sds, batch, ops, device) -> dict:
    """(a) / (b): one train step's loss and gradients on the BSR operator
    (K1 forward, and transposed backward, under each GraphConv; its
    launches set to 0 just before and read just after: the main path)
    against the dense operator's from the same weights; then steps in
    turns (ms, peak memory) and a profiled BSR step (device busy, idle
    share)."""
    from torch.profiler import ProfilerActivity, profile
    from sgp_tpu_torch.ops import bsr_spmm
    args = diffusion_args(name, ZOO_CONFIG)
    preds = {m: diffusion_predictor(args, sds, {"op": ops[m]}, device)
             for m in ops}
    first = {}
    for route, pred in preds.items():
        placed = pred._place(batch)
        torch.cuda.synchronize()
        bsr_spmm.launches = 0
        loss = pred.compute_loss(placed)
        torch.cuda.synchronize()
        fwd = bsr_spmm.launches
        loss.backward()
        torch.cuda.synchronize()
        first[route] = dict(loss=float(loss.detach()), k1_fwd=fwd,
                            k1_step=bsr_spmm.launches,
                            grads={k: p.grad.detach().clone() for k, p in
                                   pred.model.named_parameters()})
        pred.model.zero_grad(set_to_none=True)
        del loss, placed
    grad_err = {k: (first["bsr"]["grads"][k] - g).abs().max().item()
                / max(g.abs().max().item(), 1e-6)
                for k, g in first["dense"]["grads"].items()}
    worst = max(grad_err, key=grad_err.get)
    loss_err = abs(first["bsr"]["loss"] - first["dense"]["loss"]) \
        / abs(first["dense"]["loss"])
    # the runner's --n-layers: STCN's blocks, RNN-enc/GCN-dec's GraphConvs
    layers = args.n_layers
    row = dict(model=name, batch=int(batch["x"].shape[0]),
               loss={r: first[r]["loss"] for r in first},
               loss_rel_err=loss_err, grad_rel_err=grad_err[worst],
               grad_worst=worst, tol_loss=TOL_ZOO_LOSS,
               tol_grad=TOL_ZOO_GRAD, graph_convs=layers,
               k1_launches_fwd=first["bsr"]["k1_fwd"],
               k1_launches_step=first["bsr"]["k1_step"],
               k1_launches_dense_route=first["dense"]["k1_step"])
    print(f"[phase 18] ({'a' if name == 'stcn' else 'b'}) {name} step, BSR "
          f"vs dense operator: {json.dumps(row)}")
    assert loss_err <= TOL_ZOO_LOSS and grad_err[worst] <= TOL_ZOO_GRAD, row
    assert first["bsr"]["k1_fwd"] == layers, row
    assert first["bsr"]["k1_step"] == 2 * layers, row
    assert first["dense"]["k1_step"] == 0, row
    del first
    times, peak = {m: [] for m in ops}, {}
    for route in ZOO_TIME_ORDER:
        torch.cuda.reset_peak_memory_stats()
        for _ in range(ZOO_TIME_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(preds[route].train_step(batch))
            times[route].append((time.perf_counter() - t0) * 1e3)
            assert np.isfinite(loss), (name, route, loss)
        peak[route] = max(peak.get(route, 0.0),
                          torch.cuda.max_memory_allocated() / 2**20)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        float(preds["bsr"].train_step(batch))
        torch.cuda.synchronize()
    busy = device_busy(prof, 1)
    step_ms = {k: quartiles(v) for k, v in times.items()}
    row.update(step_ms=step_ms, peak_mib=peak)
    if busy:
        row.update(device_busy_ms=busy["device_busy_ms"],
                   device_activities=busy["device_activities"],
                   idle_share=1.0 - busy["device_busy_ms"]
                   / step_ms["bsr"]["median"],
                   device_ms_by_name=busy["device_ms_by_name"])
    else:
        row["idle_share"] = "not measured (no device activity traced)"
    print(f"[phase 18] {name} step times: {json.dumps(row)}")
    del preds, prof
    torch.cuda.empty_cache()
    return row


def zoo_cells(x, ops, device) -> dict:
    """(c) ``GraphConvRNN`` with GRU and LSTM cells at hidden 64 over the
    window (12 steps, forward only) on the BSR operator (K1 once a gate a
    step: T x layers x gates launches, counted) against the dense one."""
    from sgp_tpu_torch.models import GraphConvRNN
    from sgp_tpu_torch.ops import bsr_spmm
    out = {}
    for cell, gates in (("gru", 3), ("lstm", 4)):
        rnn = GraphConvRNN(x.shape[-1], 64, 1, cell)
        rnn.reset_parameters(torch.Generator().manual_seed(SEED))
        rnn.to(device)
        res, ms = {}, {}
        with torch.no_grad():
            for route in ("bsr", "dense", "dense", "bsr"):
                torch.cuda.synchronize()
                bsr_spmm.launches = 0
                t0 = time.perf_counter()
                res[route] = rnn(x, ops[route])
                torch.cuda.synchronize()
                ms.setdefault(route, []).append(
                    (time.perf_counter() - t0) * 1e3)
                if route == "bsr":
                    launches = bsr_spmm.launches
        abs_err, rel = rel_err(res["bsr"], res["dense"])
        steps = x.shape[1]
        row = dict(cell=cell, steps=steps, f=x.shape[0] * 64,
                   k1_launches=launches, expected=steps * gates,
                   max_abs_err=abs_err, rel_err=rel, tol=TOL_ROUTE,
                   ms={k: v for k, v in ms.items()})
        print(f"[phase 18] (c) GraphConvRNN {cell}, BSR vs dense: "
              f"{json.dumps(row)}")
        assert bool(torch.isfinite(res["bsr"]).all()), row
        assert launches == steps * gates and rel <= TOL_ROUTE, row
        out[cell] = row
        del res, rnn
    return out


def zoo_runs(device) -> dict:
    """(e) ``exp/run_traffic_baselines.py`` through
    ``Experiment(...).run(argv)`` for ``stcn`` and ``rnn2gcn`` on
    ``SyntheticDiffusion(5016, 640)`` with the 100-nn graph (the dense
    operator by ``auto``, as in the JAX runner), one epoch of 2 batches:
    test metrics, ms a batch, peak memory."""
    from sgp_tpu_torch.exp import run_traffic_baselines
    from sgp_tpu_torch.exp.common import Experiment
    out = {}
    for name in ("stcn", "rnn2gcn"):
        argv = ["--config", str(ZOO_CONFIG)] + RUNNER_ARGS + [
            "--model-name", name, "--adj-knn", str(KNN)] + ZOO_RUN + [
            "--device", str(device)]
        rec = RunRecorder(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        with rec.patch():
            res = Experiment(run_traffic_baselines.run_experiment,
                             run_traffic_baselines.configure_parser()
                             ).run(argv)
        out[name] = dict(argv=" ".join(argv),
                         wall_s=time.perf_counter() - t0,
                         step_ms=[ms for ms, _ in rec.steps],
                         losses=[loss for _, loss in rec.steps],
                         loader_host_ms=quartiles(rec.train_loader_ms()),
                         peak_mib=torch.cuda.max_memory_allocated(device)
                         / 2**20, **res)
        print(f"[phase 18] (e) run_traffic_baselines {name}: "
              f"{json.dumps(out[name])}")
        assert all(np.isfinite(v) for v in res.values()), out[name]
        assert len(rec.steps) == 2, out[name]
        torch.cuda.empty_cache()
    return out


def zoo_monitor(ds, graph, scaler, device) -> dict:
    """(f) ``ResidualWhitenessMonitor`` (window 64, the 100-nn graph and
    its weights) fed the one-step residuals of phase 3's
    ``OnlineForecaster`` (BSR) over the series' last 64 steps: the ms of
    ``update`` beside the forecaster's step, and the last window's result
    against the CPU port's test on the same residuals."""
    from sgp_tpu_torch.analysis import az_whiteness_test
    from sgp_tpu_torch.obs import ResidualWhitenessMonitor
    from sgp_tpu_torch.serve import OnlineForecaster
    target = ds.target                                     # [T, N, 1]
    start = target.shape[0] - MON_STEPS - 1
    enc, model, sp = build_slice(graph, scaler, "bsr", device, N_NODES)
    fc = OnlineForecaster(enc, graph, model, sp, device=device)
    fc.warm_up(target[:start])
    mon = ResidualWhitenessMonitor(graph, window=MON_WINDOW)
    ms = {"step": [], "update": []}
    prev, residuals, res = None, [], None
    for t in range(start, target.shape[0]):
        x = torch.as_tensor(target[t], device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fc.step(x)
        torch.cuda.synchronize()
        ms["step"].append((time.perf_counter() - t0) * 1e3)
        if prev is not None:
            r = x - prev
            residuals.append(r)
            t0 = time.perf_counter()
            res = mon.update(r)
            if res is not None:
                torch.cuda.synchronize()
                ms["update"].append((time.perf_counter() - t0) * 1e3)
        prev = y[0]
    window = torch.stack(residuals[-MON_WINDOW:]).cpu().numpy()
    cpu = az_whiteness_test(window, mon.edge_index,
                            edge_weight=mon.edge_weight)
    rel = abs(res.statistic - cpu.statistic) / max(abs(cpu.statistic),
                                                   1e-300)
    row = dict(window=MON_WINDOW, residuals=len(residuals),
               edges=int(mon.edges(device).index.shape[1]),
               statistic=res.statistic, pvalue=res.pvalue,
               flagged=bool(res.flagged), cpu_statistic=cpu.statistic,
               cpu_pvalue=cpu.pvalue, statistic_rel_err=rel, tol=TOL_MON,
               forecaster_step_ms=quartiles(ms["step"][2:]),
               update_ms=quartiles(ms["update"][2:]),
               updates_tested=len(ms["update"]))
    print(f"[phase 18] (f) residual monitor: {json.dumps(row)}")
    assert np.isfinite(res.statistic) and rel <= TOL_MON, row
    assert abs(res.pvalue - cpu.pvalue) <= TOL_MON, row
    return row


def phase18_zoo(ds, graph, scaler, device) -> dict:
    """The rest of the zoo (every cut is in the ``ZOO_*`` and ``MON_*``
    constants): (a) ``STCNModel`` and (b) ``RNNEncGCNDecModel`` steps on
    the BSR operator against the dense one; (c) the graph recurrent cells;
    (d) K1 at STCN's hop (F 49,152) and the decoder's (F 4,096); (e) the
    runner; (f) the residual-whiteness monitor beside the forecaster."""
    from sgp_tpu_torch.graph import normalize_adj
    from sgp_tpu_torch.ops import build_operator
    sds, batch = zoo_data(ds, graph, device)
    g = normalize_adj(graph, "row")
    ops = {m: build_operator(g, m, device=device) for m in ("bsr", "dense")}
    steps = {name: timed(f"phase 18 {name}", zoo_step, name, sds, batch,
                         ops, device) for name in ("stcn", "rnn2gcn")}
    x = torch.as_tensor(np.concatenate([
        batch["x"], np.broadcast_to(batch["u"][:, :, None], batch["x"].shape[
            :3] + batch["u"].shape[-1:])], -1), device=device)
    cells = timed("phase 18 (c)", zoo_cells, x, ops, device)
    del x
    rng = np.random.default_rng(SEED)
    b, w = batch["x"].shape[:2]
    k1 = {}
    t0 = time.perf_counter()
    for case, shape in (("STCN's GraphConv hop", (b, w, N_NODES, 64)),
                        ("the GCN decoder's hop", (b, N_NODES, 64))):
        h = torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                            device=device)
        row = k1_at_support_width(ops["bsr"], ops["dense"], h, "phase 18",
                                  case)
        k1[row["f"]] = row
        del h
        torch.cuda.empty_cache()
    print(f"[time] phase 18 (d): {time.perf_counter() - t0:.1f} s")
    runs = timed("phase 18 (e)", zoo_runs, device)
    monitor = timed("phase 18 (f)", zoo_monitor, ds, graph, scaler, device)
    return dict(steps=steps, cells=cells, k1=k1, runs=runs, monitor=monitor)


# phase 19, the dataset loaders and the graph builds at the datasets'
# widths; no raw file of the datasets is in the repository, so every input
# is drawn from SEED (every cut is in these constants)
LA_SENSORS = 207        # (a) METR-LA's sensors, the first ids of the CSV
LA_CSV_IDS = 400        # (a) the distance CSV's ids, a quarter of the pairs
CER_ARCHIVES = 6        # (a) the six File<i>.txt.zip archives, cut from
CER_ARCHIVE_METERS = 40  # 6,435 meters over 536 days to 40 meters each
CER_DAYS = 14           # over 14 days
EXCHANGE_SHAPE = (7588, 8)   # (a) exchange_rate.txt.gz at its full size
PV_PLANTS, PV_STEPS = 5016, 105120   # (b) PV-US: a year of 5-minute steps
PV_NOISE = 0.04         # (b) per-plant noise over the shared daylight curve
CER_METERS, CER_STEPS = 6435, 25728  # (b) CER-En: 536 days of half-hours
CER_NOISE = 0.2
CER_MISSING = 0.01      # (b) share of missing readings, in runs per meter
SIM_CUT_NODES, SIM_CUT_WINDOWS = 512, 8   # (b) the CPU port's cut
TOL_SIM_CARD = 1e-5     # (b) card f32 vs float64 on the card, and vs CPU
TOL_PEARSON = 1e-10     # (b) float64 Pearson, card vs CPU port and numpy
CER_CONFIG = ROOT / "configs" / "largescale_100nn" / "sgp_cer.yaml"
CER_ENCODE_STEPS = 128  # (c) the encode through K1: two chunks of 64 steps
CER_WIDTHS = (128, 6144)    # (c) K1's F: phase 2's, and the encode's hop
RESERVOIR_UNITS = 1024  # (d) the reservoir matrix of the power iteration
TOL_POWER = 1e-3        # (d) 1,500 power steps against LAPACK, relative


def la_csv(tmp: Path, rng) -> dict:
    """(a) METR-LA's ids file and distance CSV (ids written as floats, as
    the published CSV holds them) through ``build_distance_matrix``,
    against a vectorized fill of the same pairs."""
    from sgp_tpu_torch.data.datasets.build import (build_distance_matrix,
                                                   read_sensor_ids)
    ids = rng.choice(np.arange(700000, 800000), LA_CSV_IDS, replace=False)
    (tmp / "sensor_ids_la.txt").write_text(
        ",".join(str(i) for i in ids[:LA_SENSORS]))
    src, dst = np.nonzero(rng.random((LA_CSV_IDS, LA_CSV_IDS)) < 0.25)
    cost = np.round(rng.random(len(src)) * 1e4, 1)
    (tmp / "distances_la.csv").write_text("from,to,cost\n" + "".join(
        f"{ids[a]}.0,{ids[b]}.0,{c}\n" for a, b, c in zip(src, dst, cost)))
    t0 = time.perf_counter()
    dist = build_distance_matrix(str(tmp / "distances_la.csv"),
                                 read_sensor_ids(str(tmp /
                                                     "sensor_ids_la.txt")))
    host_ms = (time.perf_counter() - t0) * 1e3
    ref = np.full((LA_SENSORS, LA_SENSORS), np.inf, np.float32)
    keep = (src < LA_SENSORS) & (dst < LA_SENSORS)
    ref[src[keep], dst[keep]] = cost[keep]
    assert np.array_equal(dist, ref), "the distance matrix differs"
    return {"csv_rows": len(src), "sensors": LA_SENSORS,
            "finite": int(np.isfinite(dist).sum()), "host_ms": host_ms}


def cer_zips(tmp: Path, rng) -> dict:
    """(a) ``build_cer_en``'s parsing of six seeded archives, up to the
    arrays (``read_cer_archives``; the write needs h5py): a meter in two
    archives, a duplicated row, the DST slot codes 49/50, slot 0, a code
    one archive lacks."""
    from zipfile import ZipFile

    from sgp_tpu_torch.data.datasets.build import (CER_START,
                                                   read_cer_archives)
    days = np.arange(300, 300 + CER_DAYS)
    codes = (days[:, None] * 100 + np.arange(51)[None, :]).reshape(-1)
    dropped = int(days[3] * 100 + 17)
    for k in range(CER_ARCHIVES):
        meters = 1000 + k * CER_ARCHIVE_METERS + np.arange(CER_ARCHIVE_METERS)
        if k == 1:
            meters = np.append(meters, 1000)     # -> 1000_x and 1000_y
        mc = codes[codes != dropped] if k == 3 else codes
        m, c = np.repeat(meters, len(mc)), np.tile(mc, len(meters))
        load = np.round(rng.random(len(m)) * 3, 3)
        rows = [f"{a} {b} {v}" for a, b, v in zip(m, c, load)]
        if k == 0:   # meter 1000's slot 5 of its first day, twice
            rows[5:6] = [f"{m[5]} {c[5]} 0.5", f"{m[5]} {c[5]} 0.7"]
        order = rng.permutation(len(rows))
        with ZipFile(tmp / f"File{k + 1}.txt.zip", "w") as zf:
            zf.writestr(f"File{k + 1}.txt", "\n".join(
                rows[i] for i in order))
    t0 = time.perf_counter()
    values, index, columns = read_cer_archives(str(tmp))
    host_ms = (time.perf_counter() - t0) * 1e3
    cols = list(columns)
    assert values.shape == (CER_DAYS * 48 - 1, CER_ARCHIVES
                            * CER_ARCHIVE_METERS + 1), values.shape
    assert values.dtype == np.float32 and "1000_x" in cols \
        and "1000_y" in cols
    assert index[0] == np.datetime64(CER_START, "ns") + np.timedelta64(
        300, "D") + np.timedelta64(30, "m")
    assert (np.diff(index) > np.timedelta64(0)).all()
    dup = values[np.searchsorted(index, index[0] + np.timedelta64(
        120, "m")), cols.index("1000_x")]
    assert dup == np.float32((0.5 + 0.7) / 2), dup
    return {"archives": CER_ARCHIVES, "shape": list(values.shape),
            "host_ms": host_ms}


def exchange_gz(tmp: Path, rng, device) -> dict:
    """(a) ``ExchangeBenchmark`` on a full-size seeded table, its absolute
    Pearson on the card (f32) against the same formula in float64 numpy:
    f32 sums of 7,588 terms, 1e-5."""
    import gzip

    from sgp_tpu_torch.data.datasets import ExchangeBenchmark
    x = 1 + 0.01 * np.cumsum(rng.standard_normal(EXCHANGE_SHAPE), 0)
    with gzip.open(tmp / "exchange_rate.txt.gz", "wt") as fp:
        np.savetxt(fp, x, delimiter=",", fmt="%.6f")
    t0 = time.perf_counter()
    ds = ExchangeBenchmark(root=str(tmp))
    host_ms = (time.perf_counter() - t0) * 1e3
    sim = ds.compute_similarity("pearson", device=device)
    v = ds.target[..., 0].T.astype(np.float64)
    vc = v - v.mean(1, keepdims=True)
    norms = np.linalg.norm(vc, axis=1)
    ref = np.abs((vc @ vc.T) / (norms[:, None] * norms[None, :] + 1e-8))
    np.fill_diagonal(ref, 0.0)
    err = float(np.abs(sim - ref).max())
    assert ds.target.shape == EXCHANGE_SHAPE + (1,) and err <= 1e-5, err
    return {"shape": list(ds.target.shape), "host_ms": host_ms,
            "pearson_max_abs_err": err}


def phase19_parsers(device) -> dict:
    """(a) The host parsers on this machine, then neither pandas nor h5py
    imported."""
    import tempfile
    rng = np.random.default_rng(SEED)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        out = {"la": la_csv(Path(tmp), rng), "cer": cer_zips(Path(tmp), rng),
               "exchange": exchange_gz(Path(tmp), rng, device)}
    for name, row in out.items():
        print(f"[phase 19] (a) {name}: {json.dumps(row)}")
    loaded = sorted(m for m in ("pandas", "h5py") if m in sys.modules)
    assert not loaded, f"the loaders imported {loaded}"
    print("[phase 19] (a) neither pandas nor h5py is imported; the .h5 "
          "routes (MetrLA, PemsBay, PvUS, CEREn files, save_frame_h5) need "
          "h5py, which this machine lacks: the CPU tests hold them "
          "(tests/test_torch_port_datasets.py)")
    return out


def seeded_series(n_steps, n_nodes, day_steps, noise, gen, device):
    """A shared daily curve scaled per node (0.95-1.05) plus gaussian
    noise, drawn on the card: the nights of PV-US (the curve clipped at 0)
    and the daily load of CER-En keep the windows' RBF off f32 underflow,
    which white noise over 2,016 steps is not."""
    t = torch.arange(n_steps, device=device, dtype=torch.float32)
    curve = torch.sin(2 * np.pi * t / day_steps)
    amp = 0.95 + 0.1 * torch.rand(n_nodes, generator=gen, device=device)
    x = curve[:, None] * amp[None, :]
    x += noise * torch.randn(n_steps, n_nodes, generator=gen, device=device)
    return x


def sim_row(name, x, period, mask, device, host_fn=None) -> dict:
    """One correntropy on the card: CUDA-event ms, against float64 on the
    card and against the CPU port at the cut, the share of exact zeros."""
    from sgp_tpu_torch.graph.similarities import correntropy
    got = correntropy(x, period, mask=mask, device=device)
    ms = cuda_ms(lambda: correntropy(x, period, mask=mask, device=device),
                 iters=2, warmup=0)
    t0 = time.perf_counter()
    exact = correntropy(x.double(), period, mask=mask, device=device)
    f64_ms = (time.perf_counter() - t0) * 1e3
    cut = slice(0, SIM_CUT_WINDOWS * period + 1)
    xc = x[cut, :SIM_CUT_NODES]
    mc = None if mask is None else mask[cut, :SIM_CUT_NODES]
    card_cut = correntropy(xc, period, mask=mc, device=device)
    t0 = time.perf_counter()
    cpu_cut = correntropy(xc.cpu(), period, mask=None if mc is None
                          else mc.cpu(), device="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    n, t = x.shape[1], x.shape[0]
    n_win = (t - 1) // period
    row = {"similarity": name, "n": n, "t": t, "period": period,
           "windows": n_win, "ms": ms, "float64_ms": f64_ms,
           "gflop_f32": 2 * n * n * period * n_win / 1e9,
           "max_abs_err_vs_float64": float(np.abs(got - exact).max()),
           "cpu_cut": [SIM_CUT_NODES, SIM_CUT_WINDOWS], "cpu_cut_ms": cpu_ms,
           "max_abs_err_vs_cpu_cut": float(np.abs(card_cut - cpu_cut).max()),
           "zero_share": float((got == 0).mean()),
           "mean": float(got.mean()), "min": float(got.min())}
    if host_fn is not None:
        t0 = time.perf_counter()
        host_fn()
        row["through_dataset_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"[phase 19] (b) {json.dumps(row)}")
    assert np.isfinite(got).all() and got.shape == (n, n)
    assert row["max_abs_err_vs_float64"] <= TOL_SIM_CARD, row
    assert row["max_abs_err_vs_cpu_cut"] <= TOL_SIM_CARD, row
    return row


def pv_distance_row(rng, device) -> dict:
    """(b) PV-US's distance similarity, on the host by design (haversine
    in float64, gaussian at theta 150 km), against the same float64
    formula on the card."""
    from sgp_tpu_torch.graph.similarities import (gaussian_kernel,
                                                  geographical_distance)
    coords = np.stack([rng.uniform(25, 49, PV_PLANTS),
                       rng.uniform(-125, -67, PV_PLANTS)], axis=1)
    t0 = time.perf_counter()
    sim = gaussian_kernel(geographical_distance(coords, to_rad=True),
                          theta=150)
    host_ms = (time.perf_counter() - t0) * 1e3
    x = torch.as_tensor(np.radians(coords), device=device)

    def card():
        lat, lon = x[:, 0], x[:, 1]
        a = (torch.sin((lat[:, None] - lat[None, :]) / 2) ** 2
             + torch.cos(lat)[:, None] * torch.cos(lat)[None, :]
             * torch.sin((lon[:, None] - lon[None, :]) / 2) ** 2)
        d = 2 * 6371.0088 * torch.arcsin(torch.sqrt(a.clamp(0, 1)))
        return torch.exp(-(d / 150) ** 2)
    err = float(np.abs(card().cpu().numpy() - sim).max())
    row = {"similarity": "pv distance", "n": PV_PLANTS, "host_ms": host_ms,
           "card_float64_ms": cuda_ms(card, iters=3, warmup=1),
           "max_abs_err_vs_card_float64": err}
    print(f"[phase 19] (b) {json.dumps(row)}")
    assert err <= 1e-9, row
    return row


def cer_arrays(gen, device):
    """(b) CER-En's series with ~1% missing readings in runs (a quarter of
    the meters lose one run each), as the NaNs of the built frame."""
    x = seeded_series(CER_STEPS, CER_METERS, 48, CER_NOISE, gen, device)
    x = x + 1.0
    run = int(CER_MISSING * 4 * CER_STEPS)
    meters = torch.nonzero(torch.rand(CER_METERS, generator=gen,
                                      device=device) < 0.25)[:, 0]
    starts = torch.randint(0, CER_STEPS - run, (len(meters),),
                           generator=gen, device=device)
    steps = starts[:, None] + torch.arange(run, device=device)[None, :]
    x[steps.reshape(-1), meters.repeat_interleave(run)] = float("nan")
    index = np.datetime64("2009-07-14T00:30", "ns") + np.arange(
        CER_STEPS) * np.timedelta64(30, "m")
    return x.cpu().numpy(), index


def phase19_similarities(device) -> tuple:
    """(b) The similarities at the datasets' widths on the card."""
    from sgp_tpu_torch.data.datasets import CEREn
    from sgp_tpu_torch.data.datasets.pv_us import standardize
    from sgp_tpu_torch.graph.similarities import corrcoef
    gen = torch.Generator(device=device).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    rows = {"pv_distance": pv_distance_row(rng, device)}
    x = seeded_series(PV_STEPS, PV_PLANTS, 288, PV_NOISE, gen,
                      device).clamp_(min=0)
    xs = standardize(x, device)
    del x
    rows["pv_correntropy"] = sim_row("pv correntropy", xs, 2016, None,
                                     device)
    del xs
    torch.cuda.empty_cache()
    values, index = cer_arrays(gen, device)
    ds = CEREn.from_arrays(values, index)
    missing = float(1 - ds.mask.mean())
    xm = torch.as_tensor(ds.target[..., 0] * ds.mask[..., 0], device=device)
    mask = torch.as_tensor(ds.mask[..., 0], device=device)
    rows["cer_correntropy"] = sim_row(
        "cer correntropy", standardize(xm, device), 336, mask, device,
        host_fn=lambda: ds.get_similarity("correntropy", device=device))
    rows["cer_correntropy"]["missing_share"] = missing
    got = ds.get_similarity("pearson", device=device)
    ms = cuda_ms(lambda: corrcoef(xm, device=device), iters=2, warmup=0)
    cut = xm[:, :SIM_CUT_NODES]
    cpu = corrcoef(cut.cpu(), device="cpu")
    row = {"similarity": "cer pearson (float64)", "n": CER_METERS,
           "t": CER_STEPS, "ms": ms,
           "gflop_f64": 2 * CER_METERS ** 2 * CER_STEPS / 1e9,
           "max_abs_err_vs_cpu_cut": float(np.abs(
               corrcoef(cut, device=device) - cpu).max()),
           "max_abs_err_vs_numpy_cut": float(np.abs(
               np.corrcoef(cut.cpu().numpy(), rowvar=False) - cpu).max())}
    print(f"[phase 19] (b) {json.dumps(row)}")
    assert np.isfinite(got).all() and got.shape == (CER_METERS,) * 2
    assert row["max_abs_err_vs_cpu_cut"] <= TOL_PEARSON, row
    assert row["max_abs_err_vs_numpy_cut"] <= TOL_PEARSON, row
    rows["cer_pearson"] = row
    return rows, ds


def k1_cer_row(op, dense_op, f: int, tol: float, rng, device) -> dict:
    """K1 on the CER graph at width ``f`` against its plain version (in
    SUPPORT_CHUNK-column calls), as phase 2's rows: max and mean error, two
    calls' bits, interleaved CUDA-event times; for f32 tiles the bound and
    the dense operator's matmul, and at the encode's width the torch
    sparse BSR product."""
    from sgp_tpu_torch.ops import bsr_spmm, bsr_spmm_plain
    args = (op.blocks, op.block_cols, op.row_ptr, op.block_rows)
    n_br = op.row_ptr.numel() - 1
    n = dense_op.num_nodes
    x = torch.as_tensor(rng.standard_normal((n, f)).astype(np.float32),
                        device=device)

    def plain():
        return torch.cat([bsr_spmm_plain(
            op.blocks, op.block_cols, op.block_rows, n_br,
            x[:, s:s + SUPPORT_CHUNK]) for s in range(0, f, SUPPORT_CHUNK)],
            dim=1)
    got, again, ref = bsr_spmm(*args, x), bsr_spmm(*args, x), plain()
    torch.cuda.synchronize()
    abs_err, rel = rel_err(got, ref)
    bias = ((got.float() - ref.float()).mean()
            / ref.float().abs().max()).item()
    k_ms, p_ms = interleaved_ms(lambda: bsr_spmm(*args, x), plain, 2,
                                5 if f > 1024 else 20, plain_iters=2)
    f32 = op.blocks.dtype == torch.float32
    row = dict(case="cer graph", n=n, f=f, nnzb=op.blocks.shape[0],
               dtype=str(op.blocks.dtype).replace("torch.", ""),
               max_abs_err=abs_err, rel_err=rel, tol=tol, out_mean_err=bias,
               bitwise_repeat=torch.equal(got, again), ms=k_ms["median"],
               q1_q3=[k_ms["q1"], k_ms["q3"]], plain_ms=p_ms["median"],
               plain_q1_q3=[p_ms["q1"], p_ms["q3"]],
               dense_tile_gflop=2 * op.blocks.numel() * f / 1e9)
    if f32:
        row.update(k1_bound(op, x))
        row["dense_operator_ms"] = cuda_ms(lambda: dense_op @ x, 5,
                                           warmup=1)
        row["dense_operator_rel_err"] = rel_err(dense_op @ x, ref)[1]
    if f32 and f == CER_WIDTHS[-1]:
        npad = n_br * op.blocks.shape[-1]
        xp = torch.zeros((npad, f), dtype=x.dtype, device=device)
        xp[:n] = x
        library_ready(f)
        try:
            a = torch.sparse_bsr_tensor(op.row_ptr, op.block_cols,
                                        op.blocks, size=(npad, npad))
            row["library_max_abs_err"] = rel_err((a @ xp)[:n], ref)[0]
            row["library_ms"] = cuda_ms(lambda: a @ xp, 2, warmup=1)
        except (RuntimeError, NotImplementedError, TypeError) as err:
            row["library_ms"] = None
            row["library_note"] = f"{type(err).__name__}: {err}"[:300]
    print(f"[phase 19] (c) K1: {json.dumps(row)}")
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert rel <= tol, f"K1 disagrees with plain on the CER graph: {row}"
    assert row["bitwise_repeat"], f"two calls differ: {row}"
    if f32:
        assert abs(bias) <= TOL_K1_BIAS, f"K1 output is biased: {row}"
        assert row["dense_operator_rel_err"] <= TOL_F32, row
    return row


def phase19_cer_graph(ds, device) -> dict:
    """(c) The 100-nn CER-En graph from its correntropy (through
    ``CEREn.get_connectivity``), the sgp_cer.yaml encode over it on K1's
    route (launches counted) against the dense route, then K1 at F 128 and
    6,144 in f32 and bf16."""
    from sgp_tpu_torch.encode import prepare_propagation_graphs
    from sgp_tpu_torch.encode import streaming_encode
    from sgp_tpu_torch.ops import bsr_spmm, build_operator
    t0 = time.perf_counter()
    graph = ds.get_connectivity(method="correntropy", knn=KNN,
                                include_self=False, device=device)
    g = prepare_propagation_graphs(graph)[0]
    print(f"[phase 19] (c) CER-En's {KNN}-nn correntropy graph: "
          f"{graph.num_nodes} nodes, {graph.num_edges} edges in "
          f"{time.perf_counter() - t0:.1f} s (similarity cached from (b))")
    cfg = read_flat_yaml(CER_CONFIG)
    tgt = torch.as_tensor(ds.target[:CER_ENCODE_STEPS], device=device)
    u = torch.as_tensor(ds.datetime_encoded("day")[:CER_ENCODE_STEPS],
                        dtype=torch.float32, device=device)
    x = torch.cat([tgt, u[:, None, :].expand(-1, tgt.shape[1], -1)], -1)
    outs = {}
    for mode in ("dense", "bsr"):
        enc = sgp_encoder(cfg, x.shape[-1], mode, device)
        torch.cuda.synchronize()
        bsr_spmm.launches = 0
        t0 = time.perf_counter()
        outs[mode] = streaming_encode(enc, x, graph, time_chunk=SGP_CHUNK,
                                      out_dtype=torch.float32)
        torch.cuda.synchronize()
        outs[mode + "_ms"] = (time.perf_counter() - t0) * 1e3
        outs[mode + "_launches"] = bsr_spmm.launches
    launches = outs["bsr_launches"]
    hops = cfg["receptive_field"] * (2 if cfg["bidirectional"] else 1)
    enc_err = rel_err(outs["bsr"], outs["dense"])[1]
    t0 = time.perf_counter()
    streaming_encode(enc, x, graph, time_chunk=SGP_CHUNK,
                     out_dtype=torch.float32)
    torch.cuda.synchronize()
    again_ms = (time.perf_counter() - t0) * 1e3
    print(f"[phase 19] (c) sgp_cer.yaml encode, {CER_ENCODE_STEPS} steps: "
          f"{tuple(outs['bsr'].shape)}, K1 launches {launches} "
          f"({CER_ENCODE_STEPS // SGP_CHUNK} chunks x {hops} hops), BSR vs "
          f"dense route {enc_err:.3g} of the largest value; wall ms "
          f"{outs['bsr_ms']:.1f} (BSR, first), {again_ms:.1f} (BSR, "
          f"second) / {outs['dense_ms']:.1f} (dense)")
    assert launches == (CER_ENCODE_STEPS // SGP_CHUNK) * hops, launches
    assert outs["dense_launches"] == 0
    assert torch.isfinite(outs["bsr"]).all() and enc_err <= TOL_SLICE
    del outs, x
    torch.cuda.empty_cache()
    dense_op = build_operator(g, "dense", device=device)
    rng = np.random.default_rng(SEED)
    rows = {}
    for precision, tol in (("highest", TOL_F32), ("default", TOL_BF16)):
        op = build_operator(g, "bsr", precision=precision, device=device)
        for f in CER_WIDTHS:
            row = k1_cer_row(op, dense_op, f, tol, rng, device)
            rows[(f, row["dtype"])] = row
            torch.cuda.empty_cache()
    return {"edges": graph.num_edges, "launches": launches, "k1": rows}


def phase19_helpers(device) -> dict:
    """(d) A13 on the card: the power iteration on a reservoir matrix
    against LAPACK; ``masked_pinball`` and ``MinMaxScaler`` on card tensors
    against the CPU port."""
    from sgp_tpu_torch.data import MinMaxScaler
    from sgp_tpu_torch.ops import (power_iteration_spectral_radius,
                                   spectral_radius_exact)
    from sgp_tpu_torch.train.metrics import masked_pinball
    rng = np.random.default_rng(SEED)
    n = RESERVOIR_UNITS
    w = rng.uniform(-1, 1, (n, n)) * (rng.random((n, n)) < 0.7)
    w = (w * (0.99 / spectral_radius_exact(w))).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    radius = float(power_iteration_spectral_radius(w, device=device))
    power_ms = (time.perf_counter() - t0) * 1e3
    exact = spectral_radius_exact(w)
    y_hat = rng.standard_normal((16, 12, 300, 1)).astype(np.float32)
    y = rng.standard_normal(y_hat.shape).astype(np.float32)
    mask = rng.random(y.shape) > 0.2
    card = [torch.as_tensor(a, device=device) for a in (y_hat, y, mask)]
    pin = float(masked_pinball(*card, q=0.9))
    pin_cpu = float(masked_pinball(*(torch.as_tensor(a) for a in
                                     (y_hat, y, mask)), q=0.9))
    scaler = MinMaxScaler(axis=(0, 1), out_range=(-1.0, 1.0)).fit(y, mask)
    scaled = scaler.params(device=device).transform(card[1]).cpu().numpy()
    row = {"power_iteration": radius, "lapack": exact,
           "rel_err": abs(radius - exact) / exact, "power_ms": power_ms,
           "masked_pinball_rel_err": abs(pin - pin_cpu) / abs(pin_cpu),
           "min_max_max_abs_err": float(np.abs(
               scaled - scaler.transform(y)).max())}
    print(f"[phase 19] (d) {json.dumps(row)}")
    assert row["rel_err"] <= TOL_POWER, row
    assert row["masked_pinball_rel_err"] <= 1e-6, row
    assert row["min_max_max_abs_err"] <= 1e-6, row
    return row


def phase19_datasets(device) -> dict:
    """The dataset loaders (every cut is in the phase-19 constants): (a)
    the host parsers on this machine; (b) the similarities at PV-US's and
    CER-En's widths on the card; (c) CER-En's 100-nn graph into K1; (d)
    the A13 helpers on the card."""
    parsers = timed("phase 19 (a)", phase19_parsers, device)
    sims, ds = timed("phase 19 (b)", phase19_similarities, device)
    cer = timed("phase 19 (c)", phase19_cer_graph, ds, device)
    helpers = timed("phase 19 (d)", phase19_helpers, device)
    return dict(parsers=parsers, similarities=sims, **cer, helpers=helpers)


# phase 20, the host graph core and the tooling (A12, A11), at most ~90 s
HOST_REPEATS = 3        # (a) host timings of each route, the median kept
KHOP_ROOTS = 512        # (a) the subgraph loader's roots and hops
KHOP_K = 2
SUP_STEPS = 320         # (b), (c) the runner's series: T cut from 640
SUP_EPOCHS = 4          # (b), (c) of the yaml's 12,897 epochs
SUP_FAULT_EPOCH = 2     # (b) SGP_TPU_FAULT kills the child at this epoch
SUP_LRS = (1e-3, 1e-4)  # (c) the yaml's lr and a tenth of it
TIMING_ITERS = 20       # (d) calls of each K1 timing
GATHER_ROWS = 1 << 20   # (e) the gather's table: 1 GiB of 1 KiB rows,
GATHER_DRAWS = 1 << 20  # 20x the L2; as many random draws
BAND_NODES, BAND_WIDTH = 40960, 10   # (e) bench.py::section_bsr's graph
# one run of the large-scale runner on K1's route in a process of its own:
# argv[1] is its logs directory, the rest the runner's command line
SUP_WORKER = """
import json, sys
sys.path.insert(0, {root!r})
import sgp_tpu_torch.exp.run_largescale_sgp as runner
from sgp_tpu_torch.exp.common import Experiment, global_config
from sgp_tpu_torch.ops import bsr_spmm


def bsr_route(args):
    args.operator_mode = "bsr"
    return runner.run_experiment(args)


global_config["logs_dir"] = sys.argv[1]
res = Experiment(bsr_route,
                 runner.configure_parser_largescale()).run(sys.argv[2:])
print("RESULT " + json.dumps({{"test_mae": res["test_mae"],
                              "k1_launches": bsr_spmm.launches}}))
"""


@contextlib.contextmanager
def numpy_route():
    """``coalesce`` on its numpy branch at any size: the host core's
    threshold moved out of reach."""
    from sgp_tpu_torch.graph import sparse
    at = sparse.NATIVE_MIN_EDGES
    sparse.NATIVE_MIN_EDGES = float("inf")
    try:
        yield
    finally:
        sparse.NATIVE_MIN_EDGES = at


def host_ms(fn, *args, repeats: int = 1):
    """``fn(*args)`` and the median host ms of ``repeats`` calls."""
    ms = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args)
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, float(np.median(ms))


def plain_khop_mask(rows, roots, k: int) -> np.ndarray:
    """The plain k-hop BFS the host core is held against: numpy over the
    rows of the CSR that ``k_hop_subgraph`` walks."""
    mask = np.zeros(rows.shape[0], bool)
    mask[roots] = True
    frontier = roots
    for _ in range(k):
        reach = np.zeros(rows.shape[0], bool)
        reach[rows[frontier].indices] = True
        reach &= ~mask
        frontier = np.flatnonzero(reach)
        if len(frontier) == 0:
            break
        mask |= reach
    return mask


def phase20_native(raw, graph) -> dict:
    """(a) The host core where the runners meet it. ``coalesce`` through
    ``add_self_loops`` (DynGESN's operator, ``encode/encoders.py``; the
    supports' ``add_self_loops`` option) and ``to_undirected`` (the
    supports' ``undirected`` option, ``encode/spatial.py``) on the 100-nn
    graph at 5,016 nodes, on the native route and the numpy branch; and
    ``k_hop_subgraph`` as runner (c)'s subgraph loader calls it on its
    25,155,240-edge similarity graph (512 roots, 2 hops, the by-target CSR
    built once), its BFS alone beside a plain numpy BFS; the host ms of
    each."""
    from sgp_tpu_torch.graph import (adjacency_rows, add_self_loops,
                                     k_hop_subgraph, to_undirected)
    from sgp_tpu_torch.native import khop_mask
    out = {"graph_edges": graph.num_edges}
    for name, fn in (("add_self_loops", add_self_loops),
                     ("to_undirected", to_undirected)):
        native, native_ms = host_ms(fn, graph, repeats=HOST_REPEATS)
        with numpy_route():
            plain, numpy_ms = host_ms(fn, graph, repeats=HOST_REPEATS)
        # each merged weight sums m_i inputs in another order: within
        # (m_i - 1) ulps of f32 of the sum of the inputs' magnitudes, and
        # sum(m_i - 1) = edges in - edges out
        merged = (2 if name == "to_undirected" else 1) * graph.num_edges \
            - native.num_edges
        dw = np.abs(native.weight - plain.weight)
        row = {"edges_out": native.num_edges, "native_ms": native_ms,
               "numpy_ms": numpy_ms, "max_abs_dw": float(dw.max()),
               "bitwise": bool(np.array_equal(native.weight, plain.weight))}
        out[name] = row
        assert np.array_equal(native.src, plain.src) and \
            np.array_equal(native.dst, plain.dst), f"{name}: edges differ"
        assert (dw <= max(merged, 0) * 2.0 ** -24
                * np.abs(plain.weight)).all(), row
    g = raw.get_connectivity(threshold=None, include_self=False)
    assert g.num_edges == N_NODES * (N_NODES - 1), g.num_edges
    rows, out["rows_ms"] = host_ms(adjacency_rows, g)
    roots = np.random.default_rng(SEED).permutation(g.num_nodes)[:KHOP_ROOTS]
    (nodes, sub, pos), out["khop_native_ms"] = host_ms(
        lambda: k_hop_subgraph(g, roots, KHOP_K, rows=rows))
    core, out["khop_core_bfs_ms"] = host_ms(
        khop_mask, rows.indptr, rows.indices, g.num_nodes, roots,
        KHOP_K)
    mask, out["khop_plain_bfs_ms"] = host_ms(plain_khop_mask, rows, roots,
                                             KHOP_K)
    out.update(khop_edges=g.num_edges, khop_nodes=len(nodes),
               khop_sub_edges=sub.num_edges)
    print(f"[phase 20] (a) native core: {json.dumps(out)}")
    assert np.array_equal(core, mask), "the BFS masks differ"
    assert np.array_equal(nodes, np.flatnonzero(mask)), "k-hop nodes differ"
    assert np.array_equal(nodes[pos], roots)
    assert sub.num_edges == int((mask[g.src] & mask[g.dst]).sum())
    return out


def sup_argv(device) -> list:
    """The large-scale runner at sgp_pv.yaml's widths on 5,016 synthetic
    nodes, T and epochs cut (``SUP_STEPS``, ``SUP_EPOCHS``)."""
    return ["--config", str(CONFIG), "--dataset-name", "synthetic",
            "--synthetic-nodes", str(N_NODES), "--synthetic-steps",
            str(SUP_STEPS), "--epochs", str(SUP_EPOCHS), "--seed",
            str(SEED), "--device", str(device)]


def worker_run(worker: Path, logs: Path, argv: list) -> dict:
    """One uninterrupted run of ``SUP_WORKER`` in a process of its own:
    its ``RESULT`` (test MAE, K1 launches)."""
    env = {k: v for k, v in os.environ.items() if k != "SGP_TPU_FAULT"}
    proc = subprocess.run([sys.executable, str(worker), str(logs), *argv],
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    res = [line for line in proc.stdout.splitlines()
           if line.startswith("RESULT ")]
    assert len(res) == 1, proc.stdout[-3000:]
    return json.loads(res[0].split("RESULT ", 1)[1])


def phase20_supervised(device) -> dict:
    """(b) ``supervise`` over a worker that runs the runner on
    ``operator_mode="bsr"`` with a checkpoint every epoch, killed by
    ``SGP_TPU_FAULT`` at epoch 2 and resumed; (c) ``run_search`` over two
    learning rates at 2 workers, each trial a worker process of its own
    (its own generators, logs and K1 count: ``Experiment.run`` seeds the
    process's global generators, which threads of one process would
    share), run beside (b) from a thread, then at 1 worker in this
    process. The card's runs are deterministic, so (b)'s recovered test
    MAE must equal, bit for bit, the uninterrupted runs of its command in
    both searches."""
    import io
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from sgp_tpu_torch.exp.common import global_config
    from sgp_tpu_torch.exp.hyperopt import run_search
    from sgp_tpu_torch.exp.supervise import supervise
    from sgp_tpu_torch.ops import bsr_spmm
    torch.cuda.empty_cache()   # the children need the card's memory too
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        worker, marker = tmp / "worker.py", tmp / "fault_fired"
        worker.write_text(SUP_WORKER.format(root=str(ROOT)))

        def in_process(cfg):
            global_config["logs_dir"] = str(tmp / f"logs_1_{cfg['lr']}")
            bsr_spmm.launches = 0
            res = run_largescale(sup_argv(device) + ["--lr", str(cfg["lr"])],
                                 bsr_supports)
            return {**res, "k1_launches": bsr_spmm.launches}

        def own_process(cfg):
            return worker_run(worker, tmp / f"logs_2_{cfg['lr']}",
                              sup_argv(device) + ["--lr", str(cfg["lr"])])

        def search(workers, run_fn):
            path = tmp / f"search_{workers}.json"
            t0 = time.perf_counter()
            res = run_search(run_fn, {}, {"lr": list(SUP_LRS)}, mode="grid",
                             n_workers=workers, out_path=str(path))
            out[f"search_{workers}_wall_s"] = time.perf_counter() - t0
            assert json.loads(path.read_text())["best_config"] == \
                res["best_config"]
            assert all("metrics" in t for t in res["trials"]), res
            return res

        cmd = [sys.executable, str(worker), str(tmp / "logs_supervised"),
               *sup_argv(device), "--checkpoint-every", "1",
               "--checkpoint-path", str(tmp / "state.ckpt")]
        buf = io.StringIO()
        searches, logs_at = {}, global_config["logs_dir"]
        with ThreadPoolExecutor(1) as pool:
            beside = pool.submit(search, 2, own_process)
            os.environ["SGP_TPU_FAULT"] = \
                f"epoch:{SUP_FAULT_EPOCH},marker:{marker}"
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    rc = supervise(cmd, max_restarts=2, hang_timeout=300,
                                   restart_delay=0)
            finally:
                del os.environ["SGP_TPU_FAULT"]
            out["supervised_wall_s"] = time.perf_counter() - t0
            searches[2] = beside.result()
        text = buf.getvalue()
        for line in text.splitlines():
            if any(w in line for w in ("FAULT", "resumed", "RESULT")):
                print(f"[phase 20] (b) child: {line[:200]}")
        results = [json.loads(line.split("RESULT ", 1)[1])
                   for line in text.splitlines()
                   if line.startswith("RESULT ")]
        assert rc == 0, text[-3000:]
        assert marker.read_text() == str(SUP_FAULT_EPOCH), "no fault"
        assert "resumed from" in text and len(results) == 1, text[-3000:]
        out.update(recovered_mae=results[0]["test_mae"],
                   child_k1_launches=results[0]["k1_launches"])
        try:
            with cached_datasets("phase 20"):
                searches[1] = search(1, in_process)
        finally:
            global_config["logs_dir"] = logs_at
    trials = {w: {t["config"]["lr"]: t["metrics"] for t in r["trials"]}
              for w, r in searches.items()}
    maes = {w: {lr: m["test_mae"] for lr, m in t.items()}
            for w, t in trials.items()}
    runs = [out["recovered_mae"]] + [maes[w][SUP_LRS[0]] for w in (1, 2)]
    out.update(search_maes=maes, spread=max(runs) - min(runs),
               search_k1_launches={w: {lr: m["k1_launches"]
                                       for lr, m in t.items()}
                                   for w, t in trials.items()},
               best_config={w: r["best_config"] for w, r in searches.items()})
    print(f"[phase 20] (b), (c) supervise and the search: {json.dumps(out)}")
    assert runs[1] == runs[0] == runs[2], out
    assert maes[1] == maes[2], out
    assert searches[1]["best_config"] == searches[2]["best_config"], out
    per_run = out["child_k1_launches"]
    assert per_run > 0, out
    for t in out["search_k1_launches"].values():
        assert set(t.values()) == {per_run}, out
    return out


def phase20_timing(raw, graph, device) -> dict:
    """(d) ``time_fn`` and ``StepTimer`` beside CUDA-event times of K1 at
    F 128 and 8,192 on the 100-nn graph's operator; ``profile_trace`` of
    one two-hop encode chunk at sgp_pv.yaml's widths, whose Chrome trace
    must name K1's kernel as often as the wrapper counted launches."""
    import tempfile
    from sgp_tpu_torch.encode import (encoder_input_array,
                                      prepare_propagation_graphs,
                                      streaming_encode)
    from sgp_tpu_torch.obs import StepTimer, profile_trace, time_fn
    from sgp_tpu_torch.ops import bsr_spmm, build_operator
    gen = torch.Generator(device=device).manual_seed(SEED)
    op = build_operator(prepare_propagation_graphs(graph)[0], "bsr",
                        device=device)
    out = {}
    for f in (128, 8192):
        x = torch.randn((graph.num_nodes, f), generator=gen, device=device)
        timer = StepTimer()
        for _ in range(TIMING_ITERS):
            with timer.time("k1", sync=True, result=x):
                op @ x
        out[f] = {"event_ms": cuda_ms(lambda: op @ x, TIMING_ITERS),
                  "time_fn_ms": time_fn(lambda: op @ x, iters=TIMING_ITERS,
                                        warmup=3) * 1e3,
                  "step_timer_ms": timer.summary()["k1"]["mean_s"] * 1e3}
    cfg, sds, _ = sgp_setup(raw, graph)
    x = torch.as_tensor(encoder_input_array(
        sds, cfg["preprocess_exogenous"])[:SGP_CHUNK], device=device)
    enc = sgp_encoder(cfg, x.shape[-1], "bsr", device)
    streaming_encode(enc, x, graph, time_chunk=SGP_CHUNK)   # warm
    with tempfile.TemporaryDirectory() as tmp:
        bsr_spmm.launches = 0
        with profile_trace(tmp):
            streaming_encode(enc, x, graph, time_chunk=SGP_CHUNK)
        launches = bsr_spmm.launches
        events = json.loads((Path(tmp) / "trace.json").read_text())[
            "traceEvents"]
    named = [e for e in events if e.get("cat") == "kernel"
             and "bsr_spmm_kernel" in e.get("name", "")]
    out["trace"] = {"k1_launches": launches, "k1_kernels_traced": len(named),
                    "device_kernels_traced": sum(
                        e.get("cat") == "kernel" for e in events)}
    print(f"[phase 20] (d) timing and traces: {json.dumps(out)}")
    hops = cfg["receptive_field"] * (2 if cfg["bidirectional"] else 1)
    assert launches == hops and len(named) == launches, out["trace"]
    return out


def band_graph_big():
    """``bench.py::section_bsr``'s graph: N 40,960, each node's 10
    neighbours on either side (wrapping), row-normalized."""
    from sgp_tpu_torch.graph import Graph, coalesce, normalize_adj
    idx = np.arange(BAND_NODES, dtype=np.int64)
    offsets = list(range(1, BAND_WIDTH + 1)) + list(range(-BAND_WIDTH, 0))
    src = np.concatenate([idx] * len(offsets))
    dst = np.concatenate([(idx + d) % BAND_NODES for d in offsets])
    return normalize_adj(coalesce(Graph(
        src, dst, np.ones(len(src), np.float32), BAND_NODES)), "row")


def phase20_roofline(graph, device) -> dict:
    """(e) The card's random-row gather, measured as the JAX module's
    comment describes (1 KiB rows, rows a second: ``ROW_GATHER_LAT_S``);
    K1's time per stored block at F 128 on the N 40,960 banded graph; and
    ``bsr_spmm_bound`` (``k1_bound``) beside K1's time at that shape and
    the 100-nn graph's F 128 and 8,192: a floor, so never above it."""
    from sgp_tpu_torch.encode import prepare_propagation_graphs
    from sgp_tpu_torch.ops import bsr_spmm_plain, build_operator
    gen = torch.Generator(device=device).manual_seed(SEED)
    table = torch.randn((GATHER_ROWS, 256), generator=gen, device=device)
    idx = torch.randint(0, GATHER_ROWS, (GATHER_DRAWS,), generator=gen,
                        device=device)
    gather_ms = cuda_ms(lambda: table.index_select(0, idx), TIMING_ITERS)
    del table
    row_s = gather_ms / 1e3 / GATHER_DRAWS
    out = {"gather_ms": gather_ms, "gather_rows_per_s": 1.0 / row_s,
           "row_gather_s": row_s,
           "row_bytes_s": 2 * 1024 / roofline.HBM_BYTES_PER_S,
           "module_row_gather_s": roofline.ROW_GATHER_LAT_S}
    g_big = band_graph_big()
    band_op = build_operator(g_big, "bsr", precision="highest",
                             device=device)
    slice_op = build_operator(prepare_propagation_graphs(graph)[0], "bsr",
                              device=device)
    out["bounds"] = {}
    for name, op, f in (("band", band_op, 128), ("100-nn", slice_op, 128),
                        ("100-nn", slice_op, 8192)):
        n_br = op.row_ptr.numel() - 1
        x = torch.randn((op.num_nodes, f), generator=gen, device=device)
        rel = rel_err(op @ x, bsr_spmm_plain(
            op.blocks, op.block_cols, op.block_rows, n_br, x))[1]
        ms = cuda_ms(lambda: op @ x, TIMING_ITERS)
        b = k1_bound(op, x)
        row = {"ms": ms, "nnzb": op.blocks.shape[0], "block_s":
               ms / 1e3 / op.blocks.shape[0], "rel_err": rel,
               "bound_ms": b["bound_ms"], "bound_pipe": b["bound_pipe"],
               "share": b["bound_ms"] / ms}
        out["bounds"][f"{name} F {f}"] = row
        assert rel <= TOL_F32 and row["share"] <= 1.0, (name, f, row)
    out["band_edges"] = g_big.num_edges
    print(f"[phase 20] (e) roofline: {json.dumps(out)}")
    assert 0 < row_s < 1e-6, out
    return out


def phase20_tooling(raw, graph, device) -> dict:
    """The host graph core and the tooling (every cut is in the phase-20
    constants): (a) the native core on the runners' graphs; (b) the
    supervised runner and (c) the search; (d) the timers and a trace; (e)
    the roofline's floors. Prints its wall."""
    t0 = time.perf_counter()
    out = {"native": timed("phase 20 (a)", phase20_native, raw, graph),
           "supervised": timed("phase 20 (b), (c)", phase20_supervised,
                               device),
           "timing": timed("phase 20 (d)", phase20_timing, raw, graph,
                           device),
           "roofline": timed("phase 20 (e)", phase20_roofline, graph,
                             device)}
    print(f"[phase 20] wall {time.perf_counter() - t0:.1f} s (budget 90 s)")
    return out


# phase 21, node-sharded SGP (parallel/) at sgp_pv.yaml's widths on phase
# 11's data: (a), (c), (d) on 2 gloo ranks sharing the card, (b) on 4, (e)
# the runner on one NCCL rank (NCCL refuses two ranks on one GPU)
SHARD_WORLD = 2
SHARD_HALO_LEAD = 8     # (a) steps of the reservoir's width the hops carry:
SHARD_HALO_F = 128      # K1 at F 8 x 128 = 1,024 on each shard's tiles
SHARD_HALO_CASES = tuple((depth, payload) for depth in (1, 2)
                         for payload in ("float32", "bfloat16", "int8"))
SHARD_STEPS = 128       # (c), (d) the encoded series: T cut from 640
SHARD_EVAL_ITEMS = 48   # (d) eval windows (3 batches of 16)
SHARD_TIME_STEPS = 4    # (d) sharded steps timed after the checked one
SHARD_ITERS = 10        # CUDA-event launches of each timing
SHARD_GRAD_FLOOR = 1e-5  # (d) weights held where |grad| beyond this share
BAND_WORLD = 4          # (b) N 40,960 over 4 ranks: 10,240 rows a shard
BAND_F = 128
SHARD_RUN_STEPS = 320   # (e) the runner's series and epochs
SHARD_RUN_EPOCHS = 2
TOL_SHARD = 1e-5        # f32 results against the single-device port,
# relative to the largest value (sums in another order); the wire formats
# absolute, at tests/test_halo.py's tolerances
TOL_PAYLOAD = {"float32": TOL_SHARD, "bfloat16": 2e-2, "int8": 8e-2}


def shard_inputs(raw, graph, tmp: Path) -> tuple:
    """(a), (c), (d)'s inputs in ``tmp/pair.npz`` and their config: the
    100-nn graph normalized for the hops, seeded x at the reservoir's
    width, the sgp_pv.yaml encoder's input series, targets, mask, the
    scaled raw series as the decoder's node-level exogenous input."""
    from sgp_tpu_torch.encode import (SGPEncoder, encoder_input_array,
                                      prepare_propagation_graphs)
    from sgp_tpu_torch.exp.common import filter_kwargs
    from sgp_tpu_torch.exp.run_traffic_sgp import derive_order
    import argparse
    cfg, ds, _ = sgp_setup(raw, graph)
    g_fwd = prepare_propagation_graphs(graph)[0]
    rng = np.random.default_rng(SEED)
    t = SHARD_STEPS
    x_series = encoder_input_array(ds, cfg["preprocess_exogenous"])[:t]
    h_off = ds.windowing.horizon_offsets()
    valid = np.arange(t - int(h_off.max()))
    sc = ds.scaler_params(device="cpu")
    path = tmp / "pair.npz"
    np.savez(path, src=g_fwd.src, dst=g_fwd.dst, weight=g_fwd.weight,
             num_nodes=g_fwd.num_nodes, g_src=graph.src, g_dst=graph.dst,
             g_weight=graph.weight, g_num_nodes=graph.num_nodes,
             x=rng.standard_normal((SHARD_HALO_LEAD, graph.num_nodes,
                                    SHARD_HALO_F)).astype(np.float32),
             x_series=x_series,
             target=np.ascontiguousarray(ds.target[:t], np.float32),
             mask=np.ascontiguousarray(ds.mask[:t]),
             u=np.ascontiguousarray(x_series[..., :1]), h_off=h_off,
             valid=valid, items=valid[:SHARD_EVAL_ITEMS],
             bias=sc.bias.numpy(), scale=sc.scale.numpy())
    enc_kw = filter_kwargs(SGPEncoder.__init__, {
        **cfg, "input_size": x_series.shape[-1], "seed": SEED,
        "operator_mode": "auto"})
    width = SGPEncoder(**enc_kw, device="cpu").output_size
    model_kw = dict(
        input_size=width, order=derive_order(argparse.Namespace(**cfg)),
        n_nodes=ds.n_nodes, hidden_size=cfg["hidden_size"],
        mlp_size=cfg["mlp_size"], output_size=ds.n_channels,
        n_layers=cfg["n_layers"], horizon=ds.windowing.horizon_steps,
        positional_encoding=cfg["positional_encoding"],
        emb_size=cfg["emb_size"], exog_size=1, resnet=cfg["resnet"],
        fully_connected=cfg["fully_connected"], dropout=cfg["dropout"])
    config = {"k": cfg["receptive_field"], "halo_cases": SHARD_HALO_CASES,
              "iters": SHARD_ITERS, "encoder": enc_kw, "model": model_kw,
              "seed": SEED, "lr": cfg["lr"], "batch": cfg["batch_size"],
              "grad_clip": GRAD_CLIP, "grad_floor": SHARD_GRAD_FLOOR,
              "time_steps": SHARD_TIME_STEPS,
              "eval_batch": cfg["batch_inference"]}
    return path, config


def shard_k1_row(k1: dict, launches: int) -> dict:
    """K1 on one shard's tiles (rank 0's, timed alone on the card): the
    kernel's row for the kernels line, its bound from the port's count of
    K1's work (``roofline.bsr_spmm_bound``)."""
    b = roofline.bsr_spmm_bound(
        k1["nnzb"], k1["n_block_rows"], k1["f"], blk_itemsize=k1[
            "blk_itemsize"], x_itemsize=k1["x_itemsize"], n=k1["n"],
        nonzeros=k1["nonzeros"])
    return {**k1, **bound(b.bytes, b.flops), "launches": launches}


def phase21_pair(raw, graph, device) -> dict:
    """(a) the halo K-hop in ``mode="bsr"`` (K1 under each rank's block) at
    depths 1 and 2 and the three wire formats against the single-device
    dense operator's hops; K1 on a shard's tiles against its plain
    version; (c) ``encode_series_sharded`` against ``streaming_encode``;
    (d) the sharded IID step on each rank's own draws against the
    single-device step on their union, the replicas' bits, steps timed,
    and the sharded eval against the fused one: 2 gloo ranks on the
    card."""
    from sgp_tpu_torch.parallel import run_ranks
    from sgp_tpu_torch.parallel.card_checks import pair_worker
    tmp = ROOT / "build" / "phase21"
    tmp.mkdir(parents=True, exist_ok=True)
    path, config = shard_inputs(raw, graph, tmp)
    config["device"] = str(device)
    ranks = run_ranks(pair_worker, SHARD_WORLD, "gloo", device, str(path),
                      config)
    r0 = ranks[0]
    refused = sorted(k for k, v in r0["probe"].items() if v != "ok")
    # the ranks share the card under gloo, whose collectives must take CUDA
    # tensors (parallel/collectives.py stages nothing through the host)
    print(f"[phase 21] gloo on CUDA tensors: {json.dumps(r0['probe'])}")
    for row in r0["halo"]["cases"]:
        row["launches_by_rank"] = [
            next(c["launches"] for c in r["halo"]["cases"]
                 if (c["depth"], c["payload"]) == (row["depth"],
                                                   row["payload"]))
            for r in ranks]
        print(f"[phase 21] (a) halo k {config['k']} bsr: {json.dumps(row)}")
    main = r0["halo"]["cases"][0]
    # the boundary under a cut-minimizing order, from the host plan alone
    from sgp_tpu_torch.encode import prepare_propagation_graphs
    from sgp_tpu_torch.parallel import build_halo_spec
    rcm = build_halo_spec(prepare_propagation_graphs(graph)[0],
                          SHARD_WORLD, mode="bsr", order="rcm")
    feat = SHARD_HALO_LEAD * SHARD_HALO_F
    print(f"[phase 21] (a) the same plan under RCM: b_max {rcm.b_max} "
          f"(natural {main['b_max']}), bytes_per_hop "
          f"{rcm.bytes_per_hop(feat)} (natural {main['bytes_per_hop']})")
    k1 = shard_k1_row(r0["halo"]["k1"], main["launches"])
    print(f"[phase 21] (a) K1 on shard 0's tiles: {json.dumps(k1)}")
    print(f"[phase 21] (c) encode_series_sharded vs streaming_encode: "
          f"{json.dumps(r0['encode'])}")
    print(f"[phase 21] (d) step and eval: {json.dumps(r0['step'])}; "
          f"rank 1: loss {ranks[1]['step']['loss']}, step_ms "
          f"{ranks[1]['step']['step_ms']}")
    print(f"[phase 21] peak MiB by rank: {[r['peak_mib'] for r in ranks]}; "
          f"walls (halo, encode, step) s: "
          f"{[(r['halo_s'], r['encode_s'], r['step_s']) for r in ranks]}")
    assert not refused, r0["probe"]
    for row in r0["halo"]["cases"]:
        # f32 relative to the largest value, the wire formats absolute
        err = row["rel_err"] if row["payload"] == "float32" \
            else row["max_abs_err"]
        assert err <= TOL_PAYLOAD[row["payload"]], row
        # (K1 counts its launches on the card only)
        assert device.type != "cuda" or min(row["launches_by_rank"]) > 0, row
    assert k1["rel_err"] <= TOL_F32 and k1["bound_ms"] <= k1["ms"], k1
    assert r0["encode"]["rel_err"] <= TOL_SHARD, r0["encode"]
    st = r0["step"]
    assert all(r["step"]["replicas_equal"] for r in ranks), st
    assert st["loss_rel_err"] <= TOL_SHARD, st
    assert st["param_err_beyond_floor"] <= TOL_SHARD, st
    assert st["param_err_max"] <= st["two_lr"] * (1 + TOL_SHARD), st
    assert st["eval_rel_err"] <= TOL_SHARD, st
    assert all(r["step"]["eval"] == st["eval"] for r in ranks), st
    return {"k1": k1, "ranks": ranks}


def phase21_band(device) -> dict:
    """(b) the N 40,960 band graph (phase 20's) over 4 gloo ranks, where
    ``auto`` picks ``bsr`` (10,240 rows a shard): the hops against the
    single-device BSR operator's, K1's launches on every rank."""
    from sgp_tpu_torch.parallel import run_ranks
    from sgp_tpu_torch.parallel.card_checks import band_worker
    g = band_graph_big()
    path = ROOT / "build" / "phase21" / "band.npz"
    np.savez(path, src=g.src, dst=g.dst, weight=g.weight,
             num_nodes=g.num_nodes, x=np.random.default_rng(SEED)
             .standard_normal((g.num_nodes, BAND_F)).astype(np.float32))
    ranks = run_ranks(band_worker, BAND_WORLD, "gloo", device, str(path),
                      {"device": str(device), "k": 2, "iters": SHARD_ITERS})
    row = {**ranks[0], "launches_by_rank": [r["launches"] for r in ranks],
           "exchange_ms_by_rank": [r["exchange_ms"] for r in ranks],
           "peak_mib_by_rank": [r["peak_mib"] for r in ranks]}
    print(f"[phase 21] (b) band N {g.num_nodes} over {BAND_WORLD} ranks: "
          f"{json.dumps(row)}")
    assert row["mode"] == "bsr" and row["rel_err"] <= TOL_SHARD, row
    assert device.type != "cuda" or min(row["launches_by_rank"]) > 0, row
    return row


def phase21_runner(device) -> dict:
    """(e) ``run_largescale_sgp --data-sharding nodes`` on one NCCL rank (a
    group of this process alone) against the unsharded runner from the
    same seed and command, both on one synthetic set."""
    import tempfile
    import torch.distributed as dist
    argv = ["--config", str(CONFIG), "--dataset-name", "synthetic",
            "--synthetic-nodes", str(N_NODES), "--synthetic-steps",
            str(SHARD_RUN_STEPS), "--epochs", str(SHARD_RUN_EPOCHS),
            "--seed", str(SEED), "--device", str(device)]
    backend = "nccl" if device.type == "cuda" else "gloo"
    with cached_datasets("phase 21"), \
            tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        base = run_largescale(argv)
        base_s = time.perf_counter() - t0
        dist.init_process_group(
            backend, store=dist.FileStore(f"{tmp}/store", 1), rank=0,
            world_size=1, device_id=device if backend == "nccl" else None)
        try:
            t0 = time.perf_counter()
            res = run_largescale(argv + ["--data-sharding", "nodes"])
            sharded_s = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    row = {"backend": backend, "sharded": res, "unsharded": base,
           "unsharded_s": base_s, "sharded_s": sharded_s,
           "bitwise": all(res[k] == base[k] for k in base
                          if k.startswith("test_")),
           "rel_err": max(abs(res[k] - base[k]) / abs(base[k])
                          for k in base if k.startswith("test_"))}
    print(f"[phase 21] (e) runner, one {backend} rank vs unsharded: "
          f"{json.dumps(row)}")
    assert res["data_sharding"] == "nodes" and row["rel_err"] <= TOL_SHARD, \
        row
    return row


def phase21_sharded(raw, graph, device) -> dict:
    """Node-sharded SGP (``sgp_tpu_torch/parallel``): (a), (c), (d) on 2
    ranks, (b) on 4, (e) the runner on NCCL; prints its wall (budget
    150 s)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"pair": timed("phase 21 (a), (c), (d)", phase21_pair, raw, graph,
                         device),
           "band": timed("phase 21 (b)", phase21_band, device),
           "runner": timed("phase 21 (e)", phase21_runner, device)}
    print(f"[phase 21] wall {time.perf_counter() - t0:.1f} s (budget 150 s)")
    return out


# phase 22, data-parallel training (parallel/sharding.py, Predictor(mesh=))
# at sgp_pv.yaml's, sgp_la.yaml's and gatedgn_la.yaml's widths: (a), (b),
# (d), (e) on 2 gloo ranks sharing the card (one spawn), (c) and (d)'s
# runner on one NCCL rank against the unsharded runners
DP_WORLD = 2
DP_STRAT_STEPS = 160    # (a), (b) the embedding's series: T cut from 640
DP_EVAL_ITEMS = 32      # (b) eval windows (2 batches of 16)
DP_TIME_STEPS = 8       # (a), (d) steps timed after the checked one
DP_RUN_STEPS = 320      # (c) the stratified runner's series and epochs
DP_RUN_EPOCHS = 2
DP_LA_STEPS = 576       # (d), (e) the traffic series: 2 days at 207 nodes
DP_LA_RUN = ["--epochs", "1", "--batches-epoch", "8"]    # (d)'s runner
DP_GN_RUN = ["--epochs", "1", "--batches-epoch", "4"]    # (e)'s runner
DP_GWNET = {"model": "gwnet", "windowing": {"window": 12, "horizon": 12},
            "batch_size": 16, "lr": 1e-3, "epochs": 1, "seed": SEED,
            "kw": {"hidden_size": 32, "ff_size": 64, "n_layers": 2,
                   "emb_size": 10}}   # (e): traffic/gwnet.yaml, 2 layers
DP_GWNET_ITEMS = 41     # (e) windows: batches of 16, 16 and a ragged 9


def dp_inputs(raw, graph, tmp: Path) -> tuple:
    """Phase 22's inputs in ``tmp``: (a), (b) the sgp_pv.yaml encoder's
    input series on phase 11's data (cut to DP_STRAT_STEPS), targets, mask,
    the scaled raw series as node-level u, the 100-nn graph; (d) the
    sgp_la.yaml reservoir's states on a 207-node synthetic set, its
    similarity graph; (e) that set's series for GraphWaveNet. Returns
    ``(path, config, la)``, ``la`` the 207-node set's arrays for the main
    process's K4 row."""
    import argparse
    from sgp_tpu_torch.data import (SpatioTemporalDataset, StandardScaler,
                                    TemporalSplitter, Windowing)
    from sgp_tpu_torch.data.datasets import SyntheticDiffusion
    from sgp_tpu_torch.encode import Reservoir, encoder_input_array
    from sgp_tpu_torch.exp.run_traffic_sgp import derive_order
    cfg, ds, _ = sgp_setup(raw, graph)
    t = DP_STRAT_STEPS
    x_series = encoder_input_array(ds, cfg["preprocess_exogenous"])[:t]
    h_off = ds.windowing.horizon_offsets()
    valid = np.arange(t - int(h_off.max()))
    sc = ds.scaler_params(device="cpu")
    res_kw = dict(input_size=x_series.shape[-1],
                  hidden_size=cfg["reservoir_size"],
                  num_layers=cfg["reservoir_layers"],
                  leaking_rate=cfg["leaking_rate"],
                  spectral_radius=cfg["spectral_radius"],
                  density=cfg["density"], alpha_decay=cfg["alpha_decay"],
                  seed=SEED)
    ht = cfg["reservoir_size"] * cfg["reservoir_layers"]
    n_sup = cfg["receptive_field"]          # A, A^2: one direction
    strat = {"reservoir": res_kw, "k": cfg["receptive_field"],
             "modes": ("bsr", "dense"), "times_per_batch": 32,
             "nodes_per_time": cfg["batch_size"] // 32,
             "eval_batch": cfg["batch_inference"],
             "model": dict(
                 input_size=ht * (1 + n_sup + 1),
                 order=derive_order(argparse.Namespace(**cfg)),
                 n_nodes=ds.n_nodes, hidden_size=cfg["hidden_size"],
                 mlp_size=cfg["mlp_size"], output_size=ds.n_channels,
                 n_layers=cfg["n_layers"],
                 horizon=ds.windowing.horizon_steps,
                 positional_encoding=cfg["positional_encoding"],
                 emb_size=cfg["emb_size"], exog_size=1,
                 resnet=cfg["resnet"],
                 fully_connected=cfg["fully_connected"], dropout=0.0)}
    # (d): sgp_la.yaml's reservoir states, supports and decoder
    la = la_config()
    la_raw = SyntheticDiffusion(num_nodes=LA_NODES, num_steps=DP_LA_STEPS,
                                seed=SEED)
    g_la = la_raw.get_connectivity(threshold=0.1, knn=None,
                                   include_self=False)
    la_ds = SpatioTemporalDataset(
        la_raw.target, index=la_raw.index, mask=la_raw.mask, graph=g_la,
        covariates={"u": la_raw.datetime_encoded("day")},
        windowing=Windowing(window=la["window"], horizon=la["horizon"]))
    la_split = TemporalSplitter(0.1, 0.2).split(la_ds)
    la_ds.fit_scaler(StandardScaler(axis=(0, 1)),
                     step_index=la_ds.indices()[la_split.train])
    la_in = encoder_input_array(la_ds, la["preprocess_exogenous"])
    la_states = Reservoir(
        input_size=la_in.shape[-1], hidden_size=la["reservoir_size"],
        num_layers=la["reservoir_layers"], leaking_rate=la["leaking_rate"],
        spectral_radius=la["spectral_radius"], density=la["density"],
        alpha_decay=la["alpha_decay"], seed=SEED, device="cpu")(
            torch.as_tensor(la_in)).numpy()
    la_sc = la_ds.scaler_params(device="cpu")
    sup = dict(k=la["receptive_field"], bidirectional=la["bidirectional"],
               global_attr=la["global_attr"])
    n_la_sup = la["receptive_field"] * (2 if la["bidirectional"] else 1) \
        + int(la["global_attr"])
    width = la_states.shape[-1] * (1 + n_la_sup)
    window = {"supports": sup, "batch": la["batch_size"], "model": dict(
        input_size=width, order=1 + n_la_sup, n_nodes=LA_NODES,
        hidden_size=la["hidden_size"], mlp_size=la["mlp_size"],
        output_size=1, n_layers=la["n_layers"], horizon=la["horizon"],
        positional_encoding=la["positional_encoding"],
        emb_size=la["emb_size"], exog_size=1, resnet=la["resnet"],
        fully_connected=la["fully_connected"], dropout=0.0)}
    path = tmp / "dp.npz"
    np.savez(path, g_src=graph.src, g_dst=graph.dst, g_weight=graph.weight,
             g_num_nodes=graph.num_nodes, x_series=x_series,
             target=np.ascontiguousarray(ds.target[:t], np.float32),
             mask=np.ascontiguousarray(ds.mask[:t]),
             u=np.ascontiguousarray(x_series[..., :1]), h_off=h_off,
             valid=valid, items=valid[:DP_EVAL_ITEMS],
             bias=sc.bias.numpy(), scale=sc.scale.numpy(),
             la_src=g_la.src, la_dst=g_la.dst, la_weight=g_la.weight,
             la_num_nodes=g_la.num_nodes, la_x=la_states,
             la_target=np.ascontiguousarray(la_ds.target, np.float32),
             la_mask=np.ascontiguousarray(la_ds.mask),
             la_u=np.ascontiguousarray(la_in[..., :1]),
             la_starts=la_ds.indices()[la_split.train],
             la_h_off=la_ds.windowing.horizon_offsets(),
             la_bias=la_sc.bias.numpy(), la_scale=la_sc.scale.numpy())
    gw_path = tmp / "gwnet.npz"
    np.savez(gw_path, series=np.ascontiguousarray(la_raw.target,
                                                  np.float32),
             items=np.arange(DP_GWNET_ITEMS), src=g_la.src, dst=g_la.dst,
             weight=g_la.weight, num_nodes=g_la.num_nodes)
    config = {"seed": SEED, "lr": cfg["lr"], "grad_clip": GRAD_CLIP,
              "grad_floor": SHARD_GRAD_FLOOR, "time_steps": DP_TIME_STEPS,
              "strat": strat, "window": window,
              "runner_argv": dp_gn_argv(),
              "gwnet": {"path": str(gw_path), "cases": [DP_GWNET]}}
    return path, config, {"graph": g_la, "x": la_states}


def dp_gn_argv() -> list:
    """(e)'s command: the GatedGN traffic runner at gatedgn_la.yaml on the
    207-node synthetic set, the ELL table (K4)."""
    return ["--config", str(ROOT / "configs" / "traffic" / "gatedgn_la.yaml"),
            "--model-name", "gatedgn", "--dataset-name", "synthetic",
            "--synthetic-nodes", str(LA_NODES), "--synthetic-steps",
            str(DP_LA_STEPS), "--gn-aggregation", "ell", "--seed", str(SEED),
            *DP_GN_RUN]


def k4_at(b: int, n: int, d: int, h: int, device, tag: str) -> dict:
    """K4 forward and backward at a layer's shape (f32) against their plain
    versions: errors, interleaved CUDA-event times, the bound."""
    from sgp_tpu_torch.ops import gn_ell
    args, ghat = ell_inputs(np.random.default_rng(SEED), b, n, d, h // 2, h,
                            torch.float32, device)
    out, grads = gn_ell.gn_ell_fwd(*args), gn_ell.gn_ell_bwd(*args, ghat)
    ref = gn_ell.gn_ell_fwd_plain(*args)
    refg = gn_ell.gn_ell_bwd_plain(*args, ghat)
    torch.cuda.synchronize()
    errs = {"out": rel_err(out, ref)}
    for name, g, r in zip(("d_pi", "d_pjn", "dw2", "db2", "dwg", "dbg"),
                          grads, refg):
        errs[name] = rel_err(g, r)
    times = {}
    for half, kernel, plain in (
            ("fwd", lambda: gn_ell.gn_ell_fwd(*args),
             lambda: gn_ell.gn_ell_fwd_plain(*args)),
            ("bwd", lambda: gn_ell.gn_ell_bwd(*args, ghat),
             lambda: gn_ell.gn_ell_bwd_plain(*args, ghat))):
        k, p = interleaved_ms(kernel, plain, 2, 10)
        times.update({f"{half}_ms": k["median"], f"{half}_plain_ms":
                      p["median"], f"{half}_q1_q3": [k["q1"], k["q3"]]})
    row = dict(case=tag, b=b, n=n, d=d, h2=h // 2, h=h, dtype="float32",
               tol=TOL_GN_F32, rel_err={k: v[1] for k, v in errs.items()},
               max_abs_err={k: v[0] for k, v in errs.items()}, **times,
               **ell_bounds(args, ghat, out, grads))
    print(f"[phase 22] K4: {json.dumps(row)}")
    bad = {k: v[1] for k, v in errs.items() if not v[1] <= TOL_GN_F32}
    assert not bad, f"K4 disagrees with plain at {tag}: {bad}"
    return row


def phase22_pair(raw, graph, device) -> dict:
    """(a), (b), (d), (e) on 2 gloo ranks (``card_checks.dp_worker``): the
    checks, then K1 at the step's and the evaluation's widths and K4 at
    the runner's per-rank shape in this process, alone on the card."""
    from sgp_tpu_torch.data.sgp_loader import build_support_operators
    from sgp_tpu_torch.encode import Reservoir
    from sgp_tpu_torch.graph import padded_incoming
    from sgp_tpu_torch.parallel import run_ranks
    from sgp_tpu_torch.parallel.card_checks import dp_worker
    tmp = ROOT / "build" / "phase22"
    tmp.mkdir(parents=True, exist_ok=True)
    path, config, la = dp_inputs(raw, graph, tmp)
    config.update(device=str(device), logs_dir=str(tmp / "logs"))
    config["runner_argv"] += ["--device", str(device)]
    config["gwnet"]["device"] = str(device)
    ranks = run_ranks(dp_worker, DP_WORLD, "gloo", device, str(path), config)
    r0 = ranks[0]
    for mode, row in r0["strat"].items():
        if mode == "encode_s":
            continue
        row["k1_launches_by_rank"] = [
            (r["strat"][mode]["k1_launches_step"],
             r["strat"][mode]["k1_launches_eval"]) for r in ranks]
        row["step_ms_by_rank"] = [r["strat"][mode]["step_ms"]["median"]
                                  for r in ranks]
        print(f"[phase 22] (a), (b) stratified {mode}: {json.dumps(row)}")
    win = r0["window"]
    win["step_ms_by_rank"] = [r["window"]["step_ms"]["median"]
                              for r in ranks]
    print(f"[phase 22] (d) window step, BSR supports: {json.dumps(win)}")
    run = r0["runner"]
    run["launches_by_rank"] = [r["runner"]["launches"] for r in ranks]
    print(f"[phase 22] (e) run_traffic_baselines --data-sharding batch: "
          f"{json.dumps(run)}")
    gw = {"sharded": r0["gwnet"][0], "single": r0["gwnet_single"][0],
          "replicas_equal": all(
              r["gwnet"][0] == r0["gwnet"][0] and all(
                  np.array_equal(v, r0["gwnet"][1][k])
                  for k, v in r["gwnet"][1].items()) for r in ranks)}
    # (a metric over a zero target, MAPE, is infinite on both)
    gw["rel_err"] = max(abs(gw["sharded"][k] - v) / abs(v)
                        for k, v in gw["single"].items() if np.isfinite(v))
    gw["nonfinite_equal"] = all(gw["sharded"][k] == v for k, v in
                                gw["single"].items() if not np.isfinite(v))
    print(f"[phase 22] (e) GraphWaveNet Predictor(mesh=), synced batch "
          f"statistics: {json.dumps(gw)}")
    walls = [tuple(r[f"{k}_s"] for k in ("strat", "window", "runner",
                                          "gwnet")) for r in ranks]
    print(f"[phase 22] peak MiB by rank: {[r['peak_mib'] for r in ranks]} "
          f"(stratified {[r['strat_peak_mib'] for r in ranks]}); walls "
          f"(strat, window, runner, gwnet) s: {walls}")
    # K1 at the sharded step's and evaluation's widths, K4 at the runner's
    # per-rank batch, each alone on the card
    x = Reservoir(**config["strat"]["reservoir"], device=device)(
        torch.as_tensor(np.load(path)["x_series"], device=device),
        out_dtype=torch.bfloat16)
    ops = {mode: build_support_operators(graph, k=config["strat"]["k"],
                                         operator_mode=mode, device=device)
           for mode in ("bsr", "dense")}
    k1 = {}
    for tb, lead, case in ((32, (), "sharded stratified hop"),
                           (config["strat"]["eval_batch"], (1,),
                            "sharded evaluation hop")):
        # x widened to f32, as the wrapper does
        xs = x[:tb].reshape((tb,) + lead + x.shape[1:]).float()
        row = k1_at_support_width(ops["bsr"][0], ops["dense"][0], xs,
                                  "phase 22", case)
        k1[row["f"]] = row
    del x, ops
    gn_h = 64      # the traffic runner's --hidden-size default
    d = padded_incoming(la["graph"])[0].shape[1]
    b = read_flat_yaml(ROOT / "configs" / "traffic" / "gatedgn_la.yaml")[
        "batch_size"] // DP_WORLD
    k4 = k4_at(b, LA_NODES, d, gn_h, device, "runner per rank")
    for mode, row in r0["strat"].items():
        if mode == "encode_s":
            continue
        assert all(r["strat"][mode]["replicas_equal"] for r in ranks), row
        assert row["loss_rel_err"] <= TOL_SHARD, row
        assert row["param_err_beyond_floor"] <= TOL_SHARD, row
        assert row["param_err_max"] <= row["two_lr"] * (1 + TOL_SHARD), row
        assert row["eval_rel_err"] <= TOL_SHARD, row
        assert all(r["strat"][mode]["eval"] == row["eval"] for r in ranks)
        # K1 under the BSR supports on every rank, none on the dense ones
        assert device.type != "cuda" or (min(min(v) for v in row[
            "k1_launches_by_rank"]) > 0) == (mode == "bsr"), row
    assert all(r["window"]["replicas_equal"] for r in ranks), win
    assert win["loss_rel_err"] <= TOL_SHARD, win
    assert win["param_err_beyond_floor"] <= TOL_SHARD, win
    assert win["param_err_max"] <= win["two_lr"] * (1 + TOL_SHARD), win
    assert device.type != "cuda" or min(
        r["window"]["k1_launches_step"] for r in ranks) > 0, win
    assert all(r["runner"]["sharded"] == run["sharded"] for r in ranks), run
    assert all(np.isfinite(v) for v in run["sharded"].values()), run
    assert run["rel_err"] <= TOL_LOSS, run
    assert device.type != "cuda" or min(
        min(v.values()) for v in run["launches_by_rank"]) > 0, run
    assert gw["replicas_equal"] and gw["nonfinite_equal"], gw
    assert gw["rel_err"] <= TOL_SHARD, gw
    return {"ranks": ranks, "k1": k1, "k4": k4,
            "k1_launches_step": r0["strat"]["bsr"]["k1_launches_step"],
            "k1_launches_eval": r0["strat"]["bsr"]["k1_launches_eval"],
            "k4_launches": run["launches"]}


def phase22_runners(device) -> dict:
    """(c) ``run_largescale_sgp --iid-stratified true --data-sharding
    nodes`` and (d) ``run_traffic_sgp --data-sharding batch`` (its
    supports on K1: ``--sgp-preprocessing true``, ``operator_mode="bsr"``
    on the namespace) on one NCCL rank (a group of this process alone),
    each against the unsharded runner from the same seed and command."""
    import tempfile
    import torch.distributed as dist
    import sgp_tpu_torch.exp.run_traffic_sgp as traffic
    from sgp_tpu_torch.ops import bsr_spmm

    def traffic_bsr(args):
        args.operator_mode = "bsr"
        return traffic.run_experiment(args)

    strat = strat_argv(N_NODES, DP_RUN_STEPS, device, "--epochs",
                       str(DP_RUN_EPOCHS))
    la = la_argv(LA_NODES, DP_LA_STEPS, device, "--sgp-preprocessing",
                 "true", *DP_LA_RUN)
    runs = {"c": (lambda a: run_largescale(a), strat, "nodes"),
            "d": (lambda a: run_traffic(a, traffic_bsr), la, "batch")}
    backend = "nccl" if device.type == "cuda" else "gloo"
    out = {}
    with cached_datasets("phase 22"), \
            tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        base = {}
        for key, (run, argv, _) in runs.items():
            t0 = time.perf_counter()
            base[key] = (run(argv), time.perf_counter() - t0)
        dist.init_process_group(
            backend, store=dist.FileStore(f"{tmp}/store", 1), rank=0,
            world_size=1, device_id=device if backend == "nccl" else None)
        try:
            for key, (run, argv, flag) in runs.items():
                bsr_spmm.launches = 0
                t0 = time.perf_counter()
                res = run(argv + ["--data-sharding", flag])
                row = {"backend": backend, "sharded": res,
                       "unsharded": base[key][0],
                       "unsharded_s": base[key][1],
                       "sharded_s": time.perf_counter() - t0,
                       "k1_launches": bsr_spmm.launches,
                       "bitwise": all(res[k] == v for k, v in
                                      base[key][0].items()
                                      if k.startswith("test_"))}
                print(f"[phase 22] ({key}) runner --data-sharding {flag}, "
                      f"one {backend} rank vs unsharded: {json.dumps(row)}")
                out[key] = row
        finally:
            dist.destroy_process_group()
    for key, row in out.items():
        assert row["bitwise"], row
        assert all(np.isfinite(v) for k, v in row["sharded"].items()
                   if k.startswith("test_")), row
    assert device.type != "cuda" or out["d"]["k1_launches"] > 0, out["d"]
    return out


def phase22_data_parallel(raw, graph, device) -> dict:
    """Data-parallel training (``parallel/sharding.py``'s stratified and
    window steps, the eval's supports, ``Predictor(mesh=)``): (a), (b),
    (d), (e) on 2 gloo ranks, (c) and (d)'s runner on NCCL; prints its
    wall (budget 90 s)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"pair": timed("phase 22 (a), (b), (d), (e)", phase22_pair, raw,
                         graph, device),
           "runners": timed("phase 22 (c), (d) runners", phase22_runners,
                            device)}
    print(f"[phase 22] wall {time.perf_counter() - t0:.1f} s (budget 90 s)")
    return out


# phase 23, the rest of the multi-device port: the two-level halo exchange
# on the 100-nn graph (4 gloo ranks sharing the card as (host 2, chip 2)),
# the scaling model's routes, the dry run, then checkpoint/resume over 2
# ranks at sgp_pv.yaml's widths
HIER_WORLD = 4
HIER_HOSTS = 2
HIER_SCALING_RANKS = (2, 4)   # (3) propagation_scaling's shard counts
HIER_SCALING_F = 128
HIER_ITERS = 5          # CUDA-event launches of each timing
RESUME_WORLD = 2
RESUME_NODES = 512      # (5) the runner's set: nodes and steps cut from
RESUME_STEPS = 160      # PV-US's 5,016 x 8,868
RESUME_RUN = ["--epochs", "3", "--batches-epoch", "4"]
RESUME_FAULT_EPOCH = 2


def phase23_two_level(graph, device) -> dict:
    """(1)-(4) in one spawn of 4 gloo ranks on the card."""
    from sgp_tpu_torch.encode import prepare_propagation_graphs
    from sgp_tpu_torch.parallel import run_ranks
    from sgp_tpu_torch.parallel.card_checks import multi_device_worker
    tmp = ROOT / "build" / "phase23"
    tmp.mkdir(parents=True, exist_ok=True)
    g = prepare_propagation_graphs(graph)[0]
    path = tmp / "hier.npz"
    np.savez(path, src=g.src, dst=g.dst, weight=g.weight,
             num_nodes=g.num_nodes, x=np.random.default_rng(SEED)
             .standard_normal((SHARD_HALO_LEAD, g.num_nodes, SHARD_HALO_F))
             .astype(np.float32))
    config = {"device": str(device), "hosts": HIER_HOSTS, "k": 2,
              "halo_cases": SHARD_HALO_CASES, "iters": HIER_ITERS,
              "scaling_feat": HIER_SCALING_F,
              "scaling_ranks": HIER_SCALING_RANKS}
    ranks = run_ranks(multi_device_worker, HIER_WORLD, "gloo", device,
                      str(path), config)
    r0 = ranks[0]
    for i, row in enumerate(r0["halo"]["cases"]):
        row["launches_by_rank"] = [r["halo"]["cases"][i]["launches"]
                                   for r in ranks]
        row["exchange_bitwise_by_rank"] = [
            r["halo"]["cases"][i]["exchange_bitwise"] for r in ranks]
        print(f"[phase 23] (1), (2) two-level halo k 2 bsr: "
              f"{json.dumps(row)}")
    main = r0["halo"]["cases"][0]
    k1 = shard_k1_row(r0["halo"]["k1"], main["launches"])
    print(f"[phase 23] (1) K1 on shard 0's tiles: {json.dumps(k1)}")
    for row in r0["scaling"]:
        print(f"[phase 23] (3) propagation_scaling: {json.dumps(row)}")
    print(f"[phase 23] (4) {r0['dryrun']}")
    print(f"[phase 23] peak MiB by rank: {[r['peak_mib'] for r in ranks]}; "
          f"walls (halo, scaling, dryrun) s: "
          f"{[(r['halo_s'], r['scaling_s'], r['dryrun_s']) for r in ranks]}; "
          f"rank 0's halo cases s: {r0['halo']['case_s']}, its K1 row s: "
          f"{r0['halo']['k1_s']}")
    for row in r0["halo"]["cases"]:
        err = row["rel_err"] if row["payload"] == "float32" \
            else row["max_abs_err"]
        assert err <= TOL_PAYLOAD[row["payload"]], row
        assert all(row["exchange_bitwise_by_rank"]), row
        assert row["flat_rel_diff"] <= TOL_SHARD, row
        assert device.type != "cuda" or min(row["launches_by_rank"]) > 0, row
    assert k1["rel_err"] <= TOL_F32 and k1["bound_ms"] <= k1["ms"], k1
    for r in ranks:
        assert r["scaling"] == r0["scaling"], (r["scaling"], r0["scaling"])
    for row in r0["scaling"]:
        assert all(np.isfinite(row[k]) and row[k] > 0 for k in (
            "edges_per_s_single", "edges_per_s_halo",
            "edges_per_s_allgather")), row
    assert r0["dryrun"].endswith("hier_halo_ok=True OK"), r0["dryrun"]
    return {"k1": k1, "ranks": ranks}


def phase23_resume(device) -> dict:
    """(5) ``run_largescale_sgp --data-sharding nodes`` on 2 gloo ranks on
    the card, killed by ``SGP_TPU_FAULT`` at the start of epoch 2 after a
    checkpoint an epoch, resumed from the file; then, in one world, the
    uninterrupted run and the resumed run: test metrics and weights bit
    for bit on both ranks."""
    import tempfile
    from sgp_tpu_torch.parallel import run_ranks
    from sgp_tpu_torch.parallel.workers import jobs_worker, runner_worker
    argv = ["--config", str(CONFIG), "--dataset-name", "synthetic",
            "--synthetic-nodes", str(RESUME_NODES), "--synthetic-steps",
            str(RESUME_STEPS), *RESUME_RUN, "--seed", str(SEED),
            "--device", str(device), "--data-sharding", "nodes"]
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        marker = f"{tmp}/fault"
        cfg = {"logs_dir": f"{tmp}/logs", "env": {
            "SGP_TPU_FAULT": f"epoch:{RESUME_FAULT_EPOCH},marker:{marker}"}}

        def flags(name):
            return ["--checkpoint-every", "1", "--checkpoint-path",
                    f"{tmp}/{name}.ckpt"]
        t0 = time.perf_counter()
        try:
            run_ranks(runner_worker, RESUME_WORLD, "gloo", device,
                      argv + flags("run"), cfg)
            died = "ran to its end"
        except RuntimeError as e:
            died = str(e).splitlines()[0]
        fault_s = time.perf_counter() - t0
        fired = Path(marker).exists() and Path(marker).read_text()
        t0 = time.perf_counter()
        pairs = run_ranks(jobs_worker, RESUME_WORLD, "gloo", device, [
            ("runner_worker", argv + flags("full"), cfg),
            ("runner_worker", argv + flags("run") + ["--resume", "true"],
             cfg)])
        pair_s = time.perf_counter() - t0
    rows = []
    for (full, w_full), (res, w_res) in pairs:
        rows.append({
            "metrics": {k: (res[k], full[k]) for k in full
                        if k.startswith("test_")},
            "metrics_bitwise": all(res[k] == full[k] for k in full
                                   if k.startswith("test_")),
            "weights_bitwise": all(np.array_equal(w_res[k], w_full[k])
                                   for k in w_full)})
    row = {"fault": died, "fault_epoch": fired, "fault_run_s": fault_s,
           "full_and_resumed_s": pair_s, "ranks": rows}
    print(f"[phase 23] (5) resume over {RESUME_WORLD} ranks: "
          f"{json.dumps(row)}")
    assert "exit codes [13, 13]" in died and fired == str(
        RESUME_FAULT_EPOCH), row
    assert all(r["metrics_bitwise"] and r["weights_bitwise"] for r in rows), \
        row
    return row


def phase23_multi_device(graph, device) -> dict:
    """The rest of the multi-device port: (1)-(4) on 4 gloo ranks, (5) the
    resume on 2; prints its wall (budget 90 s)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = {"two_level": timed("phase 23 (1)-(4)", phase23_two_level, graph,
                              device),
           "resume": timed("phase 23 (5)", phase23_resume, device)}
    print(f"[phase 23] wall {time.perf_counter() - t0:.1f} s (budget 90 s)")
    return out


def kernel_entry(name, source, replaces, launches, row, half=""):
    """One kernel's line of the kernels JSON from its main-path row."""
    pre = f"{half}_" if half else ""
    errs = row["max_abs_err"]
    if isinstance(errs, dict):
        errs = errs["out"] if half == "fwd" else max(
            v for k, v in errs.items() if k != "out")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": errs,
            "ms": row[f"{pre}ms"], "plain_ms": row[f"{pre}plain_ms"],
            "bound_ms": row[f"{pre}bound_ms"],
            "bound_by": row[f"{pre}bound_by"],
            "library_ms": row.get("library_ms")}


def timed(label: str, fn, *args):
    """``fn(*args)``, printing its wall time (the script's time budget)."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {label}: {time.perf_counter() - t0:.1f} s")
    return out


def run_phases():
    smi = phase0_card()
    device = torch.device("cuda", 0)
    timed("phase 1", phase1_build)
    ds, graph, scaler = slice_setup(N_NODES, N_STEPS, device)
    k1 = timed("phase 2", phase2_kernel, graph, device)
    res = timed("phase 3", phase3_slice, ds, graph, scaler, device, N_NODES)
    cfg = read_flat_yaml(GN_CONFIG)
    k4 = timed("phase 4", phase4_gn_ell, device, N_NODES, cfg["batch_size"],
               cfg["hidden_size"])
    train = timed("phase 5", phase5_train, ds, graph, device)
    t0 = time.perf_counter()
    full = full_graph(ds)
    print(f"[setup] the full graph at density {FULL_DENSITY}: "
          f"{full.num_edges} edges in {time.perf_counter() - t0:.1f} s")
    full_cfg = read_flat_yaml(FULL_CONFIG)
    k3 = timed("phase 6", phase6_gn_allpairs, full, device,
               full_cfg["batch_size"], full_cfg["hidden_size"])
    full_train = timed("phase 7", phase7_full, ds, full, device)
    from sgp_tpu_torch.graph import permute_nodes, rcm_order
    rcm = permute_nodes(graph, rcm_order(graph))
    ragged = ragged_attention_graph(np.random.default_rng(SEED))
    k2 = timed("phase 8", phase8_sddmm, graph, rcm, ragged, device)
    attention = timed("phase 9", phase9_attention, [
        ("100-nn", graph), ("100-nn rcm", rcm), ("full", full)], ragged,
        device)
    timed("phase 10", phase10_transformer, ds, graph, device)
    phase2_library()
    sgp = timed("phase 11", phase11_sgp, ds, graph, device)
    runners = timed("phase 12", phase12_runners, device)
    diffusion = timed("phase 13", phase13_diffusion, ds, graph, device)
    traffic = timed("phase 14", phase14_traffic, ds, graph, device)
    strat = timed("phase 15", phase15_stratified, device)
    gesn = timed("phase 16", phase16_gesn, ds, graph, device)
    p17 = timed("phase 17", phase17_export_and_imputation, ds, graph, scaler,
                device)
    p18 = timed("phase 18", phase18_zoo, ds, graph, scaler, device)
    p19 = timed("phase 19", phase19_datasets, device)
    timed("phase 20", phase20_tooling, ds, graph, device)
    p21 = timed("phase 21", phase21_sharded, ds, graph, device)
    p22 = timed("phase 22", phase22_data_parallel, ds, graph, device)
    p23 = timed("phase 23", phase23_multi_device, graph, device)
    kernels = [kernel_entry("bsr_spmm", "sgp_tpu_torch/csrc/bsr_spmm.cu",
                            "sgp_tpu/ops/bsr_kernel.py:39", res["launches"],
                            k1)]
    # the SGP main path's shape: a hop of the streaming encode, F 8,192
    kernels[0]["encode"] = kernel_entry(
        "bsr_spmm", "sgp_tpu_torch/csrc/bsr_spmm.cu",
        "sgp_tpu/ops/bsr_kernel.py:39", sgp["launches"], sgp)
    # DiffConv's hops in GraphWaveNet's main path, F 2,304 (phase 13)
    kernels[0]["diffconv"] = kernel_entry(
        "bsr_spmm", "sgp_tpu_torch/csrc/bsr_spmm.cu",
        "sgp_tpu/ops/bsr_kernel.py:39", diffusion["gwnet"]["launches"],
        diffusion["k1"][DIFF_WIDTHS[-1]])
    kernels[0]["diffconv"]["dcrnn_launches"] = diffusion["dcrnn"]["launches"]
    # the loader-side supports of the traffic runner, F 49,152 (phase 14)
    kernels[0]["support"] = kernel_entry(
        "bsr_spmm", "sgp_tpu_torch/csrc/bsr_spmm.cu",
        "sgp_tpu/ops/bsr_kernel.py:39", traffic["support"]["launches"],
        traffic["k1"])
    # the stratified step's assembly on BSR supports, F 4,096, and its
    # evaluation's hops, F 2,048 (phase 15); launches from (b)'s runner run
    kernels[0]["stratified"] = kernel_entry(
        "bsr_spmm", "sgp_tpu_torch/csrc/bsr_spmm.cu",
        "sgp_tpu/ops/bsr_kernel.py:39", strat["launches"], strat["k1"][4096])
    kernels[0]["stratified"]["eval"] = kernel_entry(
        "bsr_spmm", "sgp_tpu_torch/csrc/bsr_spmm.cu",
        "sgp_tpu/ops/bsr_kernel.py:39", strat["launches"], strat["k1"][2048])
    # the GESN recurrence's hops, F 320 (phase 16); launches from (b)'s
    # device-resident runner run on BSR (T x L)
    kernels[0]["gesn"] = kernel_entry(
        "bsr_spmm", "sgp_tpu_torch/csrc/bsr_spmm.cu",
        "sgp_tpu/ops/bsr_kernel.py:39", gesn["launches"], gesn["k1"])
    # the exported forecasters' loaded programs (phase 17 (a)): K1 at the
    # serving hop's width, phase 2's row; GRIN's step on BSR supports
    # (phase 17 (b)): the cell's hop width, and the other hops' under
    # ``decoder``
    kernels[0]["export"] = kernel_entry(
        "bsr_spmm", "sgp_tpu_torch/csrc/bsr_spmm.cu",
        "sgp_tpu/ops/bsr_kernel.py:39", p17["export"]["launches"], k1)
    w_cell, w_hid = 2 + GRIN_HIDDEN, GRIN_HIDDEN
    kernels[0]["grin"] = kernel_entry(
        "bsr_spmm", "sgp_tpu_torch/csrc/bsr_spmm.cu",
        "sgp_tpu/ops/bsr_kernel.py:39", p17["grin"]["launches"],
        p17["grin"]["k1"][w_cell])
    kernels[0]["grin"]["decoder"] = kernel_entry(
        "bsr_spmm", "sgp_tpu_torch/csrc/bsr_spmm.cu",
        "sgp_tpu/ops/bsr_kernel.py:39", p17["grin"]["launches"],
        p17["grin"]["k1"][w_hid])
    # STCN's GraphConv hop on the BSR operator, F 49,152, and the GCN
    # decoder's of RNN-enc/GCN-dec under ``rnn2gcn``, F 4,096 (phase 18
    # (a), (b)); launches of each model's BSR train step
    f_stcn, f_dec = sorted(p18["k1"], reverse=True)
    kernels[0]["stcn"] = kernel_entry(
        "bsr_spmm", "sgp_tpu_torch/csrc/bsr_spmm.cu",
        "sgp_tpu/ops/bsr_kernel.py:39",
        p18["steps"]["stcn"]["k1_launches_step"], p18["k1"][f_stcn])
    kernels[0]["stcn"]["f"] = f_stcn
    kernels[0]["stcn"]["rnn2gcn"] = kernel_entry(
        "bsr_spmm", "sgp_tpu_torch/csrc/bsr_spmm.cu",
        "sgp_tpu/ops/bsr_kernel.py:39",
        p18["steps"]["rnn2gcn"]["k1_launches_step"], p18["k1"][f_dec])
    kernels[0]["stcn"]["rnn2gcn"]["f"] = f_dec
    # the sgp_cer.yaml encode's hop on CER-En's 100-nn graph, N 6,435, F
    # 6,144 (phase 19 (c)); launches of its two-chunk encode
    kernels[0]["cer"] = kernel_entry(
        "bsr_spmm", "sgp_tpu_torch/csrc/bsr_spmm.cu",
        "sgp_tpu/ops/bsr_kernel.py:39", p19["launches"],
        p19["k1"][(CER_WIDTHS[-1], "float32")])
    kernels[0]["cer"]["f"] = CER_WIDTHS[-1]
    kernels[0]["cer"]["n"] = p19["k1"][(CER_WIDTHS[-1], "float32")]["n"]
    # the halo K-hop's local blocks on the node-sharded path (phase 21
    # (a)): K1 on shard 0's tiles at F 1,024; launches of rank 0's run
    kernels[0]["halo"] = kernel_entry(
        "bsr_spmm", "sgp_tpu_torch/csrc/bsr_spmm.cu",
        "sgp_tpu/ops/bsr_kernel.py:39", p21["pair"]["k1"]["launches"],
        p21["pair"]["k1"])
    kernels[0]["halo"]["f"] = p21["pair"]["k1"]["f"]
    kernels[0]["halo"]["nnzb"] = p21["pair"]["k1"]["nnzb"]
    # the halo K-hop's local blocks under the two-level (host, chip)
    # exchange (phase 23 (1)): K1 on shard 0's tiles at F 1,024; launches
    # of rank 0's two-level run
    hier_k1 = p23["two_level"]["k1"]
    kernels[0]["halo_hier"] = kernel_entry(
        "bsr_spmm", "sgp_tpu_torch/csrc/bsr_spmm.cu",
        "sgp_tpu/ops/bsr_kernel.py:39", hier_k1["launches"], hier_k1)
    kernels[0]["halo_hier"]["f"] = hier_k1["f"]
    kernels[0]["halo_hier"]["nnzb"] = hier_k1["nnzb"]
    # the sharded stratified step's hops on BSR supports, F 4,096 a rank,
    # and the sharded evaluation's, F 2,048, under ``eval`` (phase 22 (a),
    # (b)); launches of rank 0's step and evaluation
    dp = p22["pair"]
    kernels[0]["stratified_dp"] = kernel_entry(
        "bsr_spmm", "sgp_tpu_torch/csrc/bsr_spmm.cu",
        "sgp_tpu/ops/bsr_kernel.py:39", dp["k1_launches_step"],
        dp["k1"][4096])
    kernels[0]["stratified_dp"]["eval"] = kernel_entry(
        "bsr_spmm", "sgp_tpu_torch/csrc/bsr_spmm.cu",
        "sgp_tpu/ops/bsr_kernel.py:39", dp["k1_launches_eval"],
        dp["k1"][2048])
    # K4's launches from the traffic runner's run (a), K3 forward's from
    # the large-scale runner's run (c); the slices' own counts beside them
    run_a, run_c = runners["runs"]["a"], runners["runs"]["c"]
    for name, line, half in (("gn_ell_fwd", 104, "fwd"),
                             ("gn_ell_bwd", 114, "bwd")):
        kernels.append(kernel_entry(
            name, "sgp_tpu_torch/csrc/gn_ell.cu",
            f"sgp_tpu/ops/gn_ell.py:{line}", run_a["launches"][name], k4,
            half))
        kernels[-1]["slice_launches"] = train["launches"][name]
        # under Predictor(mesh=), 8 windows a rank (phase 22 (e)); rank 0's
        # launches in the runner's run
        kernels[-1]["dp"] = kernel_entry(
            name, "sgp_tpu_torch/csrc/gn_ell.cu",
            f"sgp_tpu/ops/gn_ell.py:{line}", dp["k4_launches"][name],
            dp["k4"], half)
    # (run (c) trains on its subgraphs' edge lists: K3's backward runs on
    # phase 7's path only)
    for name, line, half, launches in (
            ("gn_allpairs_fwd", 130, "fwd",
             run_c["launches"]["gn_allpairs_fwd"]),
            ("gn_allpairs_bwd", 162, "bwd",
             full_train["launches"]["gn_allpairs_bwd"])):
        kernels.append(kernel_entry(
            name, "sgp_tpu_torch/csrc/gn_allpairs.cu",
            f"sgp_tpu/ops/gn_allpairs.py:{line}", launches, k3, half))
        kernels[-1]["slice_launches"] = full_train["launches"][name]
    # K3's forward at run (c)'s evaluation shape, 25.2 M pairs
    kernels[-2]["runner"] = kernel_entry(
        "gn_allpairs_fwd", "sgp_tpu_torch/csrc/gn_allpairs.cu",
        "sgp_tpu/ops/gn_allpairs.py:130", run_c["launches"]["gn_allpairs_fwd"],
        runners["k3"], "fwd")
    kernels.append(kernel_entry("bsr_sddmm", "sgp_tpu_torch/csrc/sddmm.cu",
                                "sgp_tpu/ops/sddmm.py:103",
                                attention["bsr_sddmm"], k2))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main():
    try:
        run_phases()
    finally:
        stop_library_warm()


if __name__ == "__main__":
    main()
