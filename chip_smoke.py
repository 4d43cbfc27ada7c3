#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pagraph_tpu_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card
    python3 chip_smoke.py --dp-gpus 4   # the dp and halo phases' ranks across 4 cards (nccl),
                                        # then cli.train --partition 4
    python3 chip_smoke.py --gat-attention   # device, build and gat_attention only
    python3 chip_smoke.py --dropout-block   # device, build, gat_attention, dropout_block
                                            # and dropout_bits
    python3 chip_smoke.py --dropout-bits    # device, build and dropout_bits

Phases, each printed as one JSON line:

* ``device``: ``torch.cuda.get_device_name()`` and nvidia-smi's name and
  power limit (the raw nvidia-smi line is printed too);
* ``build``: nvcc builds the kernels from ``pagraph_tpu_torch/csrc``;
* ``gat_attention``: GAT's attention pair on prefix-layout blocks
  (``gat_attention_fwd``, ``gat_attention_bwd``) at the gat-products.device
  cell's three blocks against the plain versions (the forward's output and
  stats, the three gradients, the masked slots' gradient rows exactly 0,
  the backward bit-equal on a second run), with kernel, plain, autograd
  chain and bound ms; the branches (head widths 8 to 512, 1 to 8 heads,
  fan-outs 1 to 70, spare rows); and the cell's model through a small
  on-device Trainer, 2 epochs, 7 launches a step (the assembly, an
  attention forward and backward a block);
* ``dropout_block``: the fused dropout and prefix-layout block pair
  (``dropout_block_fwd``, ``dropout_block_bwd``).  The int16 dropout draw
  against the int32 one from equal generator states at the benchmark
  cells' blocks, eagerly and captured in CUDA graphs with the generators
  registered (two replays): equal less 32768, generator states equal.  Each
  kernel at those blocks (sage-ogbn-products blocks 0, 1 and 2, gcn-
  pagraph-reddit block 0), f32 and bf16, against its plain version from the same
  packed keep-mask: the self half and the zeros exact, the mean within the
  sum order's tolerance (bf16's), the backward within it too (reported
  bit-equal or not); kernel, plain, draw and bound ms.  The branches (scalar and
  2-element units, an offset table, fan-outs 70 and 0, source rows past
  the block's, no dropout, both kinds, no self half) against the plain
  versions; and one device step's launches at each cell's model (small
  Trainers, 2 epochs): the assembly, a keep-mask and a fused forward a
  block, a backward for each block after the first;
* ``dropout_bits``: the keep-mask kernel (``dropout_bits``) against
  ``torch.randint``'s decisions (``dropout_bits_plain``) bit for bit at the
  sources of the cells' blocks (sage-ogbn-products 0, 1 and 2,
  gcn-pagraph-reddit 0 and 1), eagerly from three generator offsets and in
  a ``CapturedGraph`` replayed three times, the generators' offsets equal
  after each; a graph that draws through both refused at its replay; the
  kernel's, the plain version's and ``torch.randint``'s ms beside the bound
  (Philox's multiplies at the card's integer rate, or the mask's bytes);
  and two small on-device Trainers, 2 epochs replayed against 2 eager ones,
  bit-equal with equal generator offsets: the sage-ogbn-products model (a
  keep-mask launch a block, the units it drew) and a preprocess GraphSAGE
  (no keep-mask launch: its blocks draw through ``torch.randint``);
* ``train``: the main path — cache-backed GraphSAGE at the ``bench.py``
  width (2 layers, hidden 16, 100-dim features, 47 classes, batch 6000,
  fan-out 2, Adam lr 1e-2) on an RMAT scale-20 graph (1,048,576 vertices,
  ~16.08M edges) with the cache at 40% capacity, 2 epochs through
  ``Trainer.from_dataset`` at the JAX package's defaults (the native
  sampler, ``backend="auto"``; ``steps_per_dispatch=8``: epoch 0 eager,
  epoch 1 replayed from the host-step CUDA graphs), with each kernel's
  launches run (those counted eagerly plus each graph's captured launches
  times its replays); then one epoch with the ``gcn`` aggregator, the path
  of the ``sum`` kind;
* ``tiers``: one epoch of the same configuration at each cache tier
  (``cache.dtype`` float32, bfloat16, int8), each a fresh ``Trainer``
  (seed 0) at 40% capacity: epoch time, edges/s, miss rate (equal to the
  f32 run's epoch 0: the same batches), bytes shipped host -> device, the
  cache's device bytes and each kernel's launches (4 a step);
* ``bf16_train``: the host path at bf16 compute (``train.dtype="bfloat16"``)
  with the bf16 cache tier at 40% capacity, 2 epochs (epoch 1 replayed; the
  loss must fall,
  the miss rate equal the f32 run's), then one ``gcn`` epoch over the f32
  tier: epoch time, edges/s, miss rate, bytes shipped, and 5 launches a
  step, all bf16 (``assemble_<tier>_to_bf16``, two
  ``block_gather_fwd_<kind>_bf16``, one ``block_gather_bwd_<kind>_bf16``
  and the ``grad_to_bf16`` that rounds its f32 table, in the same C call);
* ``store_int8``: ``quantize_store`` of the f32 store, then a ``Trainer``
  over it at the int8 tier (one epoch at bf16 compute): its setup (no scale
  pass) beside the f32 store's int8 setup in ``tiers``, its miss rate and
  bytes shipped (equal to that run's), its scale and cache rows (equal),
  and the loader alone over both stores, in turns;
* ``host_dispatch``: the host path at the JAX package's defaults.  The
  loader alone (sampling, plan, miss gather, pack, groups stacked in pinned
  memory) for an epoch with the numpy and with the native sampler, in
  turns, and the OpenMP setting; then fresh Trainers (seed 0) of the chip
  configuration: ``steps_per_dispatch`` 8 replayed from CUDA graphs (3
  epochs, epoch 0 eager), twice the eager form of K=8 (the eager spread),
  the eager and the graph form of K=1, at bf16 compute over the bf16
  tier K=8 replayed and twice eager, and with ``cache.rank_by=
  "access_freq"`` (the cache refilled after epoch 0) K=8 replayed and
  eager.  For each: epoch time, edges/s, host enqueue ms a step, device ms
  a step (one more group behind a device sleep) and the busy share,
  capture seconds, graphs and their ``(k, bucket)`` keys, miss rate and
  bytes shipped, peak device bytes and launches; and the first and the
  last (partial) group of a further epoch, each dispatched three times
  from the same state (replayed, then twice eager).  It fails unless every
  sampler is native, every run launches 4 kernels a step (5 at bf16
  compute) and a replay those 4 (5), the runs' batches, edges and miss
  rates equal their graph run's (and bytes shipped at the same K), the
  access-frequency graphs read the refilled cache (and the refill freed
  the first fill's rows: the script holds them weakly, so the run's peak
  is the Trainer's own), each replayed group's
  loss is within 1e-6 relative of the eager form's (or the eager spread,
  if larger) and every parameter within 1e-5 of its norm (or the spread),
  the bf16 replayed run's losses and parameters equal the eager run's to
  the bit, and the loss falls.  At f32 the whole runs' losses and
  parameters are reported, not held: their eager epoch 0 may already
  differ (the block backward's atomics add in their own order);
* ``device_epoch``: the whole-epoch on-device path (``train.on_device_sampling``)
  of the same configuration with the full cache and the CSR on the card,
  each run a fresh ``Trainer`` (seed 0) for 2 epochs, the first eager and
  the second replayed from the CUDA graphs of its ``epoch_dispatch``: f32
  with generic draws (``scan``), f32 with paired draws (``steps``), bf16
  (``pipelined``) and int8 (``steps``) with paired draws, and bf16 with
  paired draws at bf16 compute (``pipelined``); the loss must fall.  Setup,
  capture and epoch time, edges/s (every valid slot of the undeduplicated
  layers: not the host path's count), batches, loss, cache and CSR bytes,
  peak device memory, and the launches run (those counted eagerly plus
  each graph's captured launches times its replays): one
  ``assemble_<tier>`` (at bf16 compute ``assemble_<tier>_to_bf16``), two
  ``dropout_bits``, two ``dropout_block_fwd_mean`` and one
  ``dropout_block_bwd_mean`` (``_bf16`` at bf16 compute) a step, and no
  other gather kernel;
* ``dispatch``: every ``epoch_dispatch`` mode (``scan``, ``steps``,
  ``pipelined``) on six runs (f32 generic, f32 paired, the bf16 and int8
  tiers paired, bf16 compute on the bf16 tier, and f32 with the cosine
  schedule over 150 of its 228 updates), each 2 epochs through the
  ``Trainer`` (epoch 1 replayed) against a fresh Trainer's 2 epochs through
  the same function's eager form from the same seed, and a second eager run
  for the eager spread: capture time, epoch time and host enqueue replayed
  (the first replay, which also uploads the graphs, and a third epoch) and
  eager, device time a step (CUDA events behind a device sleep: a fourth,
  replayed, epoch; the eager step's alone), the device's busy share (that
  device time over the third epoch's, or the eager epoch's, wall time),
  replayed gather launches a step, peak device bytes, and the loss and
  parameter differences replay against eager and eager against eager.  It
  fails unless steps, edges and vertices are equal, each epoch's loss is
  within 1e-4 relative (or the eager spread, if larger), every parameter
  within 1e-3 of its norm, one ``assemble_<tier>`` replays a step, and the
  loss falls;
* ``sage_aggregators``: the ``pool`` and ``lstm`` aggregators, trained on
  the 2-hop teacher labels (``synthetic.neighborhood_labels``) of the same
  graph and features: each on the host path for 2 epochs (epoch 1
  replayed) and on the on-device path for 1, pool and lstm also 1 host
  epoch at bf16 compute; epoch times, miss rates, losses (falling) and the
  launches a step, which must be exactly 4 on the host path (pool: the
  assembly, two ``block_gather_fwd_max``, one ``block_gather_bwd_max``;
  lstm: the assembly, two ``gather_rows`` of a block's self and neighbor
  rows, one ``scatter_add_rows``), at bf16 compute 5 for pool (the
  backward's ``grad_to_bf16``) and 4 for lstm (``scatter_add_rows_bf16``
  rounds its table in its one launch), 1 on the device (the assembly: the
  fused dropout block takes mean and sum only);
* ``preprocess``: GraphSAGE preprocess (``model.preprocess=True``, one hop
  sampled): store build time of the f32 store (``FeatureStore.build``, the
  host library's SpMM) and of the pre-quantized one
  (``build_prequantized``), each trained on the host path (40% cache, the
  ``features`` and ``neigh`` fields side by side) and on the device path;
  miss rate (the two stores' equal), bytes shipped, 3 launches a host step;
* ``inference``: ``full_graph_logits`` at ``backend="device"`` (the window
  tables' build, one ``gather_reduce`` launch a bucket) against
  ``"host"`` on the trained parameters, mean (the main path's Trainer) and
  pool on RMAT-20 (its hubs and level2 tables), lstm on an RMAT-16 graph
  with the same teacher: seconds
  of each, logits within 1e-4 of each row's largest, ``evaluate``'s
  validation accuracy, the launches of each backend;
* ``checkpoint``: save after each epoch, ``resume`` from epoch 0 into a
  fresh Trainer and run epoch 1: at bf16 compute equal to the
  uninterrupted run to the bit on the host path and on the device path,
  and so is a resume into the Trainer whose graphs replayed epoch 1, which
  replays it again (its tensors restored in place); at f32 the difference
  is reported beside the spread of two resumed runs;
* ``model_families``: GCN, GIN and GAT through ``Trainer.from_dataset`` at
  the JAX package's OGB-leaderboard width (2 hidden layers, 3 blocks,
  hidden 256, GAT 4 heads of 64; batch 1024, fan-outs (15, 10, 5), dropout
  0.5, Adam 1e-2) on the same graph and features with the 2-hop teacher
  labels, the train set cut to its first 65,536 vertices (64 steps an
  epoch). For each: the host path (cache at 40%, K = 8) 2 epochs at f32
  (epoch 1 replayed) and 1 at bf16 compute, with exactly 6 launches a step
  for GCN (the assembly, three ``gather_reduce_mean``, two
  ``gather_reduce_bwd_mean``) and GIN (``block_gather_fwd_sum``,
  ``block_gather_bwd_sum``), 8 at bf16 compute (two ``grad_to_bf16``), and
  7 for GAT at either dtype (three ``gather_rows`` of the table ``[z |
  att_s | att_n]``, three ``scatter_add_rows``); the on-device path
  (``steps`` mode) 2 epochs, epoch 1 replayed, bit-equal to a fresh
  Trainer's eager form, one assembly, three ``dropout_bits``, three
  ``dropout_block_fwd_<kind>`` and two ``dropout_block_bwd_<kind>`` a step
  (GCN mean, GIN sum; GAT its attention pair a block); device inference and
  ``evaluate`` on RMAT-20 (validation accuracy); device logits within 1e-4
  of each row's largest host logit on RMAT-16 (GAT: RMAT-14); the loss
  finite and falling; then ``mlp_val_acc`` on the same labels, and the
  phase's seconds;
* ``cv_gcn``: CV-GCN (``arch="gcn_cv"``, preprocess, 2 layers of 256,
  fan-outs (15, 10), batch 1024, dropout 0.5, Adam 1e-2) on the same graph,
  features, teacher labels and cut train set: the host path 2 epochs at
  f32 and 1 at bf16 compute, exactly 5 launches a step (the assembly, two
  ``gather_reduce_mean``, two ``gather_reduce_bwd_mean``), 7 at bf16
  compute, and the ``cv-refresh`` seconds (the loss is reported, not held
  to fall: at Adam 1e-2 CV-GCN's loss rises at epoch 1 in the JAX package
  too, ``tests/test_torch_cv_gcn.py::test_cv_loss_rises_at_the_chip_shape_as_in_jax``);
  the on-device path (``scan``)
  2 epochs, epoch 1 replayed, bit-equal to a fresh Trainer's two eager
  epochs in losses, parameters, histories and aggregates, with one
  assembly a step and one ``gather_reduce_sum`` a window table a history
  an epoch (the refresh), and the refresh's device time (a CUDA graph of
  it, timed as the kernels are); a resume from epoch 0's checkpoint and
  its ``.aux`` sidecar equal to the uninterrupted run to the bit (RMAT-16);
  device logits within 1e-4 of each row's largest host logit on RMAT-16,
  device inference and ``evaluate`` on RMAT-20;
* ``partition``: the train set into 4 parts at 2 hops by ``dg_partition``
  (native) and ``hash_partition``: seconds, vertices a part, replication
  factor, train vertices a part (the first 65,536 train vertices when the
  native dg stream, timed on 8,192 spread over the set, would take over 20
  s for all of them); the native ``dg_assign`` equal to the numpy one on
  RMAT-14; a ``save_partition``/``load_partition`` round trip of part 0
  (the files the JAX package reads); part 0 through
  ``Trainer.from_partition`` over the full store at the main path's shape,
  the host path (cache at 40% of the part's vertices) 2 epochs at 4
  launches a step and the on-device path 2 epochs, epoch 1 replayed and
  bit-equal to the eager form;
* ``dp``: data-parallel training through ``pagraph_tpu_torch.parallel``,
  its ranks spawned from this script (``spawn_local``, the ``spawn``
  method; a rank that fails fails the run) at the main path's shape,
  dropout 0 for (a) and (b): (a) world size 1 on ``nccl``, the host path
  over the whole graph for 2 epochs (epoch 1 replayed from the host-step
  graphs with the all-reduces inside) against the single-device
  ``Trainer``'s eager form from the same seed: bit-equal at bf16 compute,
  and at f32 within 1e-4 of the loss and 1e-2 of each parameter's max|p|
  (two single runs differ by up to 2.6e-6 and 6.1e-4 there: the block
  backward's atomics add in their own order), the spread reported; (b)
  world size 1 on ``nccl``, the on-device path for 3 epochs, epochs 1-2
  replayed from one CUDA graph with the NCCL all-reduces inside,
  bit-equal to their eager form from epoch 0's checkpoint; each with
  exactly 4 gather launches a host step (5 at bf16 compute) or 4 a device
  step (the assembly and the dropout block kernels) and one gradient
  all-reduce a step; (c) 2 gloo ranks sharing the
  card over RMAT-20's train set hash-partitioned at 2 hops (saved here,
  each rank loading its own part), the cache at 40% of the larger part,
  dropout 0.2, 2 host and 2 on-device epochs: the ranks' parameters
  bit-equal after every epoch, one lockstep step count (the largest of
  their own), the host loss falling, and per rank epoch seconds, edges/s,
  its own miss rate and peak device bytes;
* ``halo``: the halo feature sources (``DataParallelTrainer(feature_source=
  "ici" | "edge")``, ``parallel/halo.py``: the features sharded across the
  ranks, each step's layer-0 rows fetched from their owners over two
  ``all_to_all_single``) at the main path's shape, dropout 0 for (a),
  over the dataset and the 2-way hash parts the ``dp`` phase saved: (a)
  world size 1 on ``nccl``: ``ici`` on the host path, 2 epochs (epoch 1
  replayed from the host-step graphs, the all_to_alls and the all-reduce
  inside) at bf16 and f32 compute, against the ``cache`` source's run from
  the same seed: bit-equal at bf16, at f32 within ``dp``'s bounds; the
  ``edge`` device epoch at bf16 compute for 3 epochs (epochs 1-2 replayed
  from one CUDA graph with every collective inside) bit-equal to its eager
  form from epoch 0's checkpoint, to the same run with
  ``train.halo_pipeline`` (the fetches on a stream of their own inside the
  graph) and to the ``cache`` source's device epoch; each with exactly the
  gather launches of its path a step (the exchange's one assembly plus the
  block kernels on the host, the exchange's assembly and the dropout
  block kernels on the device),
  1 all-reduce and 2 all_to_all a step and no halo request dropped; (b) 2
  gloo ranks sharing the card: ``ici`` on the host path over the hash
  parts, ``ici`` on the device over the whole graph and ``edge`` on the
  device over the hash parts, at dropout 0.2, 2 host epochs and 3 device
  epochs (the third the first replay with every rank in step): the ranks'
  parameters bit-equal after every epoch, one lockstep step count, the
  same launches and collectives a step, the host loss falling, and per
  rank the epoch times, halo width, drops, bytes exchanged a step, the
  shard's bytes and the wall ms of one eager exchange alone at that width;
* ``dp_cv``: data-parallel CV-GCN (``DataParallelTrainer`` with
  ``model.arch="gcn_cv"`` on the device, a ``CVDeviceState`` a rank over
  its partition) at ``cv_gcn``'s shape on RMAT-20's cut train set, the
  features the store's ``gcn`` aggregate: (a) world size 1 on ``nccl``,
  dropout 0, the single-device Trainer's random integers: the ``cache``
  epochs at bf16 compute (epoch 0 eager, epochs 1-2 replayed from one CUDA
  graph with the all-reduces and the refresh inside) bit-equal to their
  eager form and to the single-device CV device epochs (losses,
  parameters, histories, aggregates), ``edge`` bit-equal to ``cache``,
  f32 within ``dp``'s bounds of the single-device run; one assembly a step
  and one window reduction a table a history an epoch, one all-reduce a
  step; a run on RMAT-16 resumed from epoch 0's checkpoint (its
  ``.aux.p<rank>`` shard) bit-equal to the uninterrupted run; (b) 2 gloo
  ranks on the card over 2-way hash parts of the cut train set, ``cache``
  2 epochs and ``edge`` 1 at dropout 0.5: replicas bit-equal after every
  epoch, one lockstep count, the same launches, and on RMAT-16 every rank's
  shard written and its resume bit-equal;
* ``service``: isolation-mode sampling (``train.remote_sampling``, 2
  worker processes over the graph in shared memory; ``/dev/shm``'s size
  printed) at ``bench.py``'s shape on RMAT-20 with the cache at 40%: (a) a
  ``Trainer`` (K = 8) for 3 epochs, epoch 0 eager and then replayed: 4
  launches a step, the loss falling, every epoch's seeds the train set
  once, the first 3 batches equal to the native sampler's in-process
  batches of the same seeds and batch seeds, the loader alone through the
  service and in process (in turns), ``close()`` leaving no worker and no
  shared-memory segment; (b) 2 gloo ranks, one2one over the 2-way hash
  parts and one2all over the whole graph, 2 epochs each: replicas
  bit-equal, one lockstep count (one2all's the round robin's share),
  one2all's ranks sharing only make-up seeds, every service closed clean;
* ``kernels``: every kernel on a batch of that run at its main-path shapes,
  against its plain PyTorch version on the card (gathered rows exact,
  reductions within 1e-6 of the output's scale, the atomic backwards within
  1e-5), timed with CUDA events (L2 flushed between launches) beside its
  plain version, one PyTorch library call where one computes the same
  function, and its device-memory bound.  The fused block forward
  (``block_gather_fwd``, both outputs) and its single-half uses
  (``gather_rows``, ``gather_reduce``) are one kernel, as are the fused
  block backward (``block_gather_bwd``) and its single-half uses
  (``scatter_add_rows``, ``gather_reduce_bwd``).  The assembly
  (``assemble``) is one kernel for the three cache tiers, each timed on
  that tier's cache and plan of the batch; ``assemble_full[tier]`` is the
  on-device path's layer-0 fetch (``ops.gather.take_rows``: the assembly
  with no miss rows) from the full cache at a device-sampled batch's 54,000
  rows, its ``library_ms`` ``index_select`` at f32; ``assemble_halo[f32]``
  and ``assemble_halo[f32->bf16]`` are the halo exchange's last step (the
  received rows in batch order, a zero row for each dropped request) at
  world size 1 over that batch (``H`` = 54,000 rows received), its
  launches those of the ``halo`` phase's (a) runs, its ``library_same_fn_ms``
  ``index_select`` then ``where``.  No one PyTorch call
  computes a fused case: its ``library_ms`` times the calls that compute
  each output from pre-flattened inputs (for the forward ``index_select`` +
  ``embedding_bag``; for the backwards the ``index_add_`` calls into a
  buffer that is never zeroed, with the division and expansion done outside
  the timed call).  The fused cases, the single-half backwards and the
  assembly (``library_ms`` null) also get ``library_same_fn_ms``: the same
  function in PyTorch calls from the kernel's own inputs.  A bound counts
  each index and each output once and each distinct source row a launch
  reads once (a row that repeats, or is both a self and a neighbor row, is
  one read), at the rows' own width.  The bf16 entries
  (``block_gather_fwd_<kind>_bf16[block0|1]``,
  ``block_gather_bwd_<kind>_bf16[block1]``, ``assemble[<tier>->bf16]``,
  ``assemble_full[bf16->bf16]``) run the same batch at bf16 compute: the
  forward's neighbor half and the backward within 1e-2 of each element
  plus 1e-2 of max|plain|, rows and the assembly exact.  The max kind
  (``block_gather_fwd_max[_bf16][block0|1]``,
  ``block_gather_bwd_max[_bf16][block1]``; block 1's rows concat(x,
  relu(x)), tied at 0) is exact forward at f32 and bf16 and within 1e-6 of
  max|plain| backward at f32; the backward's ``library_same_fn_ms`` is
  autograd of ``index_select`` and the masked ``amax`` (which splits ties
  evenly, as the kernel does), its forward recorded outside the timed call,
  and no one PyTorch call computes it (``library_ms`` null); ``window_reduce[sum|max, <table>]``
  (``gather_reduce``) runs device inference's RMAT-20 window tables over the
  features: F = 8 (the block forward's unrolled instantiation), F = 64
  (the window kernel, a warp a row), F = 512 and 4096 (a CTA a row), the hub
  table (``hubs F=4096``) and F = 4096 at the hidden width (``F=4096,
  D=16``), the max exact and the sum within max(1e-6, F x 2^-24) of
  max|plain| (F terms in another order);
  ``scatter_add_rows[_bf16][block1 self bwd | lstm step ids]`` (one
  cooperative launch) at block 1's self rows and at the lstm step's ids
  (self rows, then every neighbor slot), f32 within 1e-5, bf16 as the
  other bf16 tables; and at the model families' shapes (one host batch of
  the GCN run: 1024 seeds, fan-outs 15/10/5): ``gather_reduce_mean[gcn
  block0|1|2]`` and ``gather_reduce_bwd_mean[gcn block1|2]`` (its
  ``library_ms`` ``index_add_``), ``block_gather_fwd_sum[gin block0|1|2]``
  and ``block_gather_bwd_sum[gin block1|2]``, ``gather_rows`` and
  ``scatter_add_rows[gat block0 table]`` (the 264-column table, against
  ``index_select`` and ``index_add_``), with the families' launches; and
  at CV-GCN's shapes (one host batch of the ``cv_gcn`` run)
  ``gather_reduce_mean[cv block0|1]`` and ``gather_reduce_bwd_mean[cv
  block0|1]``, and the refresh's ``window_reduce[sum, cv refresh <table>,
  D=256|512]`` over the on-device run's histories (F = 8, 64, 512, 4096
  and the hub table), their launches that run's refreshes of the table;
  and on rank 0's part of ``dp_cv``'s (b) run (launches that run's):
  ``assemble_full[dp cv cache f32]`` (the dp ``cache`` source's
  ``take_rows`` at a device-sampled CV batch, 180,224 ids),
  ``assemble_halo[dp cv edge f32, P=2]`` (the ``edge`` CV exchange's
  assembly over two owners' rows) and ``window_reduce[sum, cv_refresh_dp
  rank0 <table>, D=256|512]`` (the rank's refresh over its part's tables);
* ``fwd_branches``: the block forward and backward on the card, on f32 and
  on bf16 rows, at the branches the main path does not take -- D = 30
  (scalar rows), a table one element off its unit's alignment, fan-out 7
  (no unrolled instantiation: the neighbor half alone is the window
  kernel), each half absent -- against their plain versions;
* ``assemble_branches``: the assembly at each tier, to f32 and to bf16,
  where the main path does not go -- D = 30 (scalar units), a table one
  element off its unit's alignment, D = 600 (several units a lane), no
  miss rows, every row a miss, every row a hit -- exact against its plain
  version;
* ``window_branches``: ``gather_reduce`` through the window kernel where
  inference's tables do not go -- D = 30 (scalar units), D = 16, a table one
  element off its alignment, fan-outs 9, 32, 40, 48, 1001, 4096, 4100 and
  8192 (indices staged by bulk copy, by the CTA's threads, or both; one
  tile or several), random masks with all-masked rows, tables of 1 and 0
  rows -- every kind, f32 and bf16, against its plain version;
* ``scatter_branches``: ``scatter_add_rows`` at D = 30, every id one row,
  one table row, no ids and a [1,048,576, 16] table (64 MB), f32 and bf16,
  against its plain version; and one call at the lstm step's shape is
  exactly one CUDA operation (``torch.profiler``), the scatter kernel, at
  f32 and at bf16: no memset, no rounding launch;
* ``graph_block_kernels``: the host path's block forward and backward
  (``ops.aggregate.block_gather``, the backward launched from autograd's
  thread) captured in a CUDA graph and replayed, against the eager call;
* ``timing_floor``: the same timing around no work, around the block
  backward's memset alone, and around a contiguous device copy that moves
  the block-0 forward's bound bytes (half read, half written): what the
  card streams for those bytes with no gather;
* ``step_parity``: one train step from the same parameters and batch at
  each cache tier, through the kernels and through the plain versions:
  loss and every gradient within 1e-5 relative (atomic summation order),
  4 kernel launches (the assembly, two fused block forwards, one fused
  block backward);
* ``bf16_step_parity``: one bf16-compute step at each cache tier through
  the kernels and through the plain versions: loss within 1e-2 relative,
  each gradient within ``||g - g_plain|| <= 2e-2 ||g_plain||``, 5 bf16
  launches, the assembly to bf16 bit-equal;
* ``breakdown``: where the epoch's time goes — an epoch of the loader alone
  (host sampling, miss gather, pinned H2D), and one train step alone on a
  shipped batch (host enqueue time, wall time, device time), at f32 and at
  bf16 compute;
* ``device_sampler_parity``: one batch sampled on the card and the same
  draws through the same function on CPU copies, generic and paired: equal
  ids, masks, labels and blocks;
* ``device_step_parity``: one device-sampled step at each tier through the
  kernel and under ``gather_kernels.plain_versions()`` from the same
  parameters: loss and every gradient within 1e-5 relative, one assembly,
  two keep-masks, two dropout block forwards and one backward through the
  kernels and none under the plain versions;
* ``device_breakdown``: one on-device step alone and its parts (sample,
  fetch, train), and one replay of the ``steps`` mode's step graph:
  host enqueue, wall and device time (CUDA events), CUDA kernels and memory
  operations counted with ``torch.profiler``, and that a step never
  synchronizes with the host (``torch.cuda.set_sync_debug_mode``).
* ``cli`` (after every phase that reads a trace: after its traces, a
  later ``torch.profiler`` trace's ``events()`` held no CUDA activity on
  the card): the training
  CLI (``pagraph_tpu_torch.cli.train.main``) over the same graph, saved in
  the CLIs' layout (``data.formats.save_dataset``), at
  the bench width (GraphSAGE mean, 2 layers, hidden 16, batch 6000, fan-out
  2, lr 0.01, 2 epochs, the cache auto-sized) with ``--json --profile-dir``,
  on the host path (with ``--ckpt-dir --ckpt-every 2``: one checkpoint,
  epoch 1) and with ``--on-device``: each fails unless its summary
  and its JSON line carry the JAX package's summary keys, the loss is
  finite, the launches run are exactly 4 a step on the host path (the
  assembly, two ``block_gather_fwd_mean``, one ``block_gather_bwd_mean``)
  and 6 on the device (the assembly, two ``dropout_bits``, two
  ``dropout_block_fwd_mean``, one ``dropout_block_bwd_mean``), its one
  ``torch.profiler`` trace names the
  kernels (``block_gather_fwd_kernel`` and ``assemble_kernel`` on the host
  path, ``assemble_kernel``, ``dropout_block_fwd_kernel`` and
  ``dropout_block_bwd_kernel`` on the device), and, on the host path, the cache's
  capacity is what ``utils.platform.free_hbm_bytes`` gave it, which equals
  the JAX package's arithmetic on ``device_memory_stats`` and the free bytes
  ``mem_get_info`` reports, less the reserve;
* ``cli_tools``: the offline and serving CLIs, each through its
  ``main(argv)``, with each command's seconds and the kernels' launches
  counted from 0 around it.  Over the ``cli`` phase's dataset and
  checkpoint: ``eval`` at its default ``--backend auto`` (RMAT-20's edges
  take the device: it must launch ``gather_reduce_sum``), one accuracy in
  [0, 1]; ``infer --save-logits`` with ``--backend device`` and ``host``:
  the device logits within 1e-4 of each row's largest host logit, the
  device run launching ``gather_reduce_sum`` and the host run no window
  reduction, the predictions the logits' argmax and their test accuracy
  ``eval``'s within 1e-4; ``analyze count-vnum`` and ``cache-oracle``
  (batch 6000, fan-out 2) and ``load-break`` on the card at
  ``--cache-capacity`` 0 (miss rate 1.0, ``h2d_ms`` > 0) and 419,430 (40%):
  its miss rate equal to a numpy replay of its batches against the 40%
  highest out-degree vertices, printed beside the ``train`` phase's epoch-0
  miss rate (not equal: that Trainer probes its caps first, drawing 8 batch
  seeds from the same generator, so its epoch is another permutation); then on an RMAT-16 dataset of its own ``preprocess --gen
  rmat --scale 16``, a ``convert --from-npz`` round trip (every array
  equal), ``partition`` (dg, 2 parts, 2 hops, the native assign) and
  ``verify_partition`` (coverage and every part ``ok``);
* ``bench``: ``bench_torch.run`` (the port of ``bench.py``) for its
  ``full`` phase, with the hit-path probe (one group's step graph replayed
  17 times), and its ``device`` phase on the teacher-labelled graph, 2
  epochs each, then ``build_result``: 4 launches a host step (the probe's
  replays included) and 4 a device step, the line's keys ``bench.py``'s
  schema plus the card's name and power limit, finite edges/s.

Any failed check exits non-zero without the final line.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types
import weakref

HERE = os.path.dirname(os.path.abspath(__file__))
START = time.perf_counter()

# bytes per second of device memory, by card
HBM_BYTES_PER_S = {"sxm": 3.35e12, "pcie": 2.0e12}
PALLAS = "pagraph_tpu/ops/pallas_gather.py"
SOURCE = "pagraph_tpu_torch/csrc/gather_kernels.cu"
# the cache tiers (cache.dtype) and their tags in the kernel names and counters
TIERS = {"float32": "f32", "bfloat16": "bf16", "int8": "int8"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(key: str, value) -> None:
    """One phase's JSON line; a dict gains ``script_s``, the seconds since
    the script started (where the run's time goes)."""
    if isinstance(value, dict):
        value = {**value, "script_s": time.perf_counter() - START}
    print(json.dumps({key: value}), flush=True)


def time_ms(torch, fn, flush_buf, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` per call: CUDA events around each call,
    the L2 cache flushed (a write of > 50 MB) before each one.  A ~0.5 ms
    device sleep ahead of each start event keeps the stream busy while the
    host enqueues the call, so the wrapper's host overhead is not timed."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush_buf.zero_()
        torch.cuda._sleep(1_000_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


TOLERANCES = {"exact": 0.0, "reduce": 1e-6, "atomic": 1e-5, "bf16": 1e-2}


def compare(torch, out_k, out_p, tol):
    """(max abs error, within tolerance, text) of a kernel's output(s)
    against the plain version's; ``tol`` names a TOLERANCES entry (or is a
    number, a relative tolerance of its own), or one per output when the
    outputs are a tuple.  Each output is held to its tolerance times its
    own scale, max|plain|; ``bf16`` (a reduction or a gradient table in
    bf16) element by element to 1e-2 of the element plus 1e-2 of that
    scale."""
    torch.cuda.synchronize()
    if not isinstance(out_k, tuple):
        out_k, out_p, tol = (out_k,), (out_p,), (tol,)
    err, ok, text = 0.0, True, []
    for k, p, t in zip(out_k, out_p, tol):
        if k.dtype != p.dtype:
            return float("inf"), False, f"dtype {k.dtype} != plain {p.dtype}"
        diff = (k.float() - p.float()).abs()
        e = diff.max().item() if p.numel() else 0.0
        scale = max(p.float().abs().max().item() if p.numel() else 0.0, 1e-30)
        r = TOLERANCES.get(t, t)
        if t == "bf16":
            good = bool((diff <= r * p.float().abs() + r * scale).all()) if p.numel() else True
            text.append(f"bf16: |err| <= {r} * |plain| + {r} * max|plain| ({scale:.6g})")
        else:
            good = e <= r * scale
            name = t if isinstance(t, str) else "sum order"
            text.append(f"{name}: |err| <= {r:.3g} * max|plain| ({scale:.6g})")
        err, ok = max(err, e), ok and good
    return err, ok, "; ".join(text)


def fwd_branches(torch, gk, dev):
    """The block forward and backward against their plain versions where the
    main path does not go, on f32 and on bf16 rows: D = 30 (scalar rows), a
    source table and incoming gradients one element off their unit's
    alignment (scalar rows at D = 32), fan-out 7 (the runtime-fan-out
    instantiation; the neighbor half alone there is the window kernel), each
    with both halves, the self half alone and the neighbor half alone, every
    kind (mean, sum, max; the max backward reads the source table).  Positions repeat and overlap; 10 rows have no valid
    slot."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n_src, n = 3000, 2000
    out = []
    for (label, d, f, off), dtype in ((c, t) for t in (torch.float32, torch.bfloat16)
                                      for c in (("D=30", 30, 2, 0), ("offset table", 32, 2, 1),
                                                ("fan-out 7", 32, 7, 0),
                                                ("D=30 fan-out 7", 30, 7, 0))):
        tag = "" if dtype == torch.float32 else " bf16"
        red_tol, bwd_tol = ("reduce", "atomic") if dtype == torch.float32 else ("bf16", "bf16")

        def table(rows):
            flat = torch.randn(rows * d + off, generator=gen, device=dev).to(dtype)
            return flat[off:].view(rows, d)
        src, g_self, g_neigh = table(n_src), table(n), table(n)
        self_pos = torch.randint(0, n_src, (n,), generator=gen, device=dev,
                                 dtype=torch.int32)
        pos = torch.randint(0, n_src, (n, f), generator=gen, device=dev,
                            dtype=torch.int32)
        pos[::2, 0] = self_pos[::2]
        mask = torch.rand(n, f, generator=gen, device=dev) > 0.3
        mask[:10] = False
        for kind in gk.KINDS:
            for halves in ("both", "self", "neigh"):
                sp = self_pos if halves != "neigh" else None
                p, m = (pos, mask) if halves != "self" else (None, None)
                gs = g_self if sp is not None else None
                gn = g_neigh if p is not None else None
                fwd_k = gk.block_gather_fwd(src, sp, p, m, kind)
                fwd_p = gk.block_gather_fwd_plain(src, sp, p, m, kind)
                tols = tuple(t for t, h in zip(("exact", red_tol), fwd_k) if h is not None)
                fwd_k = tuple(h for h in fwd_k if h is not None)
                fwd_p = tuple(h for h in fwd_p if h is not None)
                for what, got, want, tol in (
                        ("fwd", fwd_k, fwd_p, tols),
                        ("bwd", gk.block_gather_bwd(gs, sp, gn, p, m, n_src, kind, src),
                         gk.block_gather_bwd_plain(gs, sp, gn, p, m, n_src, kind, src),
                         bwd_tol)):
                    err, ok, text = compare(torch, got, want, tol)
                    out.append({"case": f"{what} {kind} {label} {halves}{tag}",
                                "max_abs_err": err, "ok": ok, "tolerance": text})
    return out


def assemble_branches(torch, gk, dev):
    """The assembly against its plain version, exact, at each tier and with
    an f32 and a bf16 output, where the main path does not go: D = 30
    (scalar units), tables one element off their unit's alignment (scalar
    units at D = 100), D = 600 (several units a lane), no miss rows, every
    row a miss, every row a hit."""
    gen = torch.Generator(device=dev).manual_seed(6)
    n, cap = 2000, 3000
    out = []
    for label, d, off, n_miss in (("D=30", 30, 0, 1024), ("offset tables", 100, 1, 1024),
                                  ("D=600", 600, 0, 1024), ("no miss rows", 100, 0, 0),
                                  ("all misses", 100, 0, 2048), ("all hits", 100, 0, 1024)):
        for dtype, tag in TIERS.items():
            row_dtype = getattr(torch, dtype)

            def table(rows):
                if row_dtype == torch.int8:
                    flat = torch.randint(-127, 128, (rows * d + off,), generator=gen,
                                         device=dev, dtype=torch.int32).to(torch.int8)
                else:
                    flat = torch.randn(rows * d + off, generator=gen, device=dev).to(row_dtype)
                return flat[off:].view(rows, d)
            cv, mf = table(cap), table(n_miss)
            hit = torch.rand(n, generator=gen, device=dev) < 0.6
            if label == "all misses":
                hit[:] = False
            elif label in ("all hits", "no miss rows"):
                hit[:] = True
            src_row = torch.where(
                hit, torch.randint(0, cap, (n,), generator=gen, device=dev),
                -1 - torch.randint(0, max(n_miss, 1), (n,), generator=gen, device=dev)
            ).to(torch.int32)
            scale = (torch.rand(d, generator=gen, device=dev) / 127 + 1e-3
                     if row_dtype == torch.int8 else None)
            for out_dtype, out_tag in ((torch.float32, ""), (torch.bfloat16, "->bf16")):
                err, ok, text = compare(
                    torch, gk.assemble(cv, src_row, mf, scale, out_dtype=out_dtype),
                    gk.assemble_plain(cv, src_row, mf, scale, out_dtype=out_dtype), "exact")
                out.append({"case": f"assemble[{tag}{out_tag}] {label}", "max_abs_err": err,
                            "ok": ok, "tolerance": text})
    return out


def window_branches(torch, gk, dev):
    """``gather_reduce`` at fan-outs with no unrolled instantiation (the
    window kernel) against its plain version where device inference's
    RMAT-20 tables do not go, every kind, f32 and bf16 rows: D = 30 (scalar
    units), D = 16, D = 100 on a table one element off its alignment,
    fan-outs 32 and 48 (a warp a row), 9 (positions and masks staged by the
    CTA's threads), 40 (positions by bulk copy, masks by the threads), 1001
    (a CTA a row, neither aligned), 4096, 4100 (a second tile of 4 slots) and
    8192 (two tiles), random masks with all-masked rows, and tables of 1 and 0
    rows.  Sums and means within max(1e-6, F x 2^-24) of max|plain| at f32
    (F terms in another order), bf16 as the other bf16 reductions, max exact."""
    gen = torch.Generator(device=dev).manual_seed(8)
    n_src = 5000
    out = []
    for label, rows, f, d, off in (("D=30 F=32", 300, 32, 30, 0), ("D=16 F=48", 300, 48, 16, 0),
                                   ("D=100 offset table F=64", 200, 64, 100, 1),
                                   ("F=9", 300, 9, 32, 0), ("F=40", 300, 40, 100, 0),
                                   ("F=1001", 40, 1001, 100, 0), ("F=4096", 20, 4096, 100, 0),
                                   ("F=4100", 9, 4100, 30, 0), ("F=8192", 9, 8192, 16, 0),
                                   ("1 row F=4096", 1, 4096, 100, 0), ("0 rows F=64", 0, 64, 100, 0),
                                   ("0 rows F=4096", 0, 4096, 16, 0)):
        pos = torch.randint(0, n_src, (rows, f), generator=gen, device=dev, dtype=torch.int32)
        mask = torch.rand(rows, f, generator=gen, device=dev) > 0.3
        mask[: min(3, rows // 3)] = False
        for dtype in (torch.float32, torch.bfloat16):
            flat = torch.rand(n_src * d + off, generator=gen, device=dev).to(dtype)
            src = flat[off:].view(n_src, d)
            plan = gk.window_plan(rows, f, d, d % 4 == 0 and off == 0)
            for kind in gk.KINDS:
                tol = ("exact" if kind == "max" else "bf16" if dtype == torch.bfloat16
                       else max(1e-6, f * 2.0 ** -24))
                err, ok, text = compare(torch, gk.gather_reduce(src, pos, mask, kind),
                                        gk.gather_reduce_plain(src, pos, mask, kind), tol)
                out.append({"case": f"window {kind} {label}"
                                    f"{'' if dtype == torch.float32 else ' bf16'}",
                            "plan": None if plan is None else list(plan),
                            "max_abs_err": err, "ok": ok, "tolerance": text})
    return out


def cuda_kernels_of(torch, fn):
    """Names of the CUDA kernels and memory operations one call of ``fn``
    runs, from a torch.profiler trace (the second of two traced calls)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def scatter_branches(torch, gk, dev):
    """``scatter_add_rows`` against its plain version where the main path
    does not go, f32 (1e-5 of max|plain|: atomics in another order) and bf16:
    D = 30 (scalar units), every id one row, one table row, no ids, and a
    [1,048,576, 16] table (64 MB: each thread zeroes many units) with
    200,000 ids (each thread adds items past its first kCoopItems); and the
    CUDA operations of one call at the lstm step's shape: one kernel, no
    memset, no second launch at bf16."""
    gen = torch.Generator(device=dev).manual_seed(9)
    out = []
    for label, n, num_src, d in (("D=30", 6000, 12544, 30), ("one id repeated", 6000, 12544, 32),
                                 ("num_src=1", 3000, 1, 32), ("no ids", 0, 12544, 32),
                                 ("64 MB table", 200_000, 1 << 20, 16)):
        ids = torch.randint(0, num_src, (n,), generator=gen, device=dev, dtype=torch.int32)
        if label == "one id repeated":
            ids[:] = 77
        g = torch.randn(n, d, generator=gen, device=dev)
        for dtype, tol in ((torch.float32, "atomic"), (torch.bfloat16, "bf16")):
            g_t = g.to(dtype)
            err, ok, text = compare(torch, gk.scatter_add_rows(g_t, ids, num_src),
                                    gk.scatter_add_rows_plain(g_t, ids, num_src), tol)
            out.append({"case": f"scatter {label}{'' if dtype == torch.float32 else ' bf16'}",
                        "grid": gk.scatter_grid(n, num_src, d, d % 4 == 0, gk._sm_count(dev)),
                        "max_abs_err": err, "ok": ok, "tolerance": text})
    ids = torch.randint(0, 12544, (18000,), generator=gen, device=dev, dtype=torch.int32)
    g = torch.randn(18000, 32, generator=gen, device=dev)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        names = cuda_kernels_of(torch, lambda g_=g.to(dtype): gk.scatter_add_rows(g_, ids, 12544))
        good = len(names) == 1 and "scatter_add_rows_kernel" in names[0]
        out.append({"case": f"scatter one call {tag}: CUDA operations", "names": names,
                    "ok": good, "max_abs_err": 0.0,
                    "tolerance": "exactly one CUDA operation, the scatter kernel"})
    return out


# the fused dropout block at the benchmark cells' blocks: (label, n, fan-out,
# D, self half, rate): gnnbench's sage-ogbn-products blocks 0, 1 and 2 and
# gcn-pagraph-reddit's block 0
DROPOUT_BLOCK_SHAPES = (("sage block0", 180_224, 5, 100, True, 0.5),
                        ("sage block1", 16_384, 10, 256, True, 0.5),
                        ("sage block2", 1_024, 15, 256, True, 0.5),
                        ("gcn block0", 18_000, 2, 602, False, 0.2))
# (D, fan-out, element offset of the tables, source rows past the block's):
# scalar units, 2-element units, an offset table, a fan-out past the mask
# word, no slot at all
DROPOUT_BLOCK_BRANCHES = ((31, 3, 0, 7), (30, 2, 1, 0), (32, 70, 0, 5), (100, 5, 0, 0),
                          (16, 0, 0, 3))


def dropout_draws_agree(torch, dev, rows: int, d: int) -> dict:
    """The int16 draw in [-32768, 32768) against the int32 draw in [0,
    65536) from equal generator states: eagerly, and each captured in a CUDA
    graph with its generator registered and replayed twice.  Equal values
    less 32768 and equal generator states after each."""
    def gens():
        return [torch.Generator(device=dev).manual_seed(7) for _ in range(2)]

    def draw(g, wide):
        return (torch.randint(0, 1 << 16, (rows, d), generator=g, device=dev,
                              dtype=torch.int32) if wide else
                torch.randint(-(1 << 15), 1 << 15, (rows, d), generator=g, device=dev,
                              dtype=torch.int16))

    g32, g16 = gens()
    eager = bool(torch.equal(draw(g32, True) - (1 << 15), draw(g16, False).int()))
    eager_state = bool(torch.equal(g32.get_state(), g16.get_state()))
    g32, g16 = gens()
    replays = {}
    for g, wide in ((g32, True), (g16, False)):
        graph, buf = torch.cuda.CUDAGraph(), {}
        graph.register_generator_state(g)
        with torch.cuda.graph(graph):
            buf["b"] = draw(g, wide)
        reps = []
        for _ in range(2):
            graph.replay()
            reps.append(buf["b"].clone())
        replays[wide] = reps
        del graph, buf
    torch.cuda.synchronize()
    captured = all(torch.equal(a - (1 << 15), b.int())
                   for a, b in zip(replays[True], replays[False]))
    advanced = not torch.equal(replays[False][0], replays[False][1])
    out = {"eager_equal": eager, "eager_generator_states_equal": eager_state,
           "captured_replays_equal": bool(captured), "replays_differ": bool(advanced),
           "captured_generator_states_equal": bool(torch.equal(g32.get_state(),
                                                               g16.get_state()))}
    out["ok"] = all(out.values())
    return out


def dropout_block_cases(torch, gk, agg, dev, bw, flush) -> list:
    """``dropout_block_fwd`` and ``dropout_block_bwd`` at
    :data:`DROPOUT_BLOCK_SHAPES`, f32 and bf16, kind mean, against their
    plain versions from the same bits (the self half and the zeros exact,
    the neighbor mean within the sum order's tolerance, the backward within
    the reduce tolerance and reported bit-equal or not), timed beside the
    plain versions and the two draws, with each launch's bound: the least
    bytes (the rows a valid slot or a self row reads, their keep bits, the
    mask, the outputs; backward: the incoming gradients, the keep bits of
    the rows that get a nonzero gradient's chance, the mask, the gradient
    table) at the card's bandwidth."""
    gen = torch.Generator(device=dev).manual_seed(23)
    rows_out = []
    for label, n, f, d, with_self, rate in DROPOUT_BLOCK_SHAPES:
        rows = n * (1 + f)
        thresh, inv_keep = agg.dropout_threshold(rate)
        mask = torch.rand(n, f, generator=gen, device=dev) > 0.1
        mask[:64] = False
        valid = int(mask.sum())
        keep = gk.dropout_bits_plain((rows, d), thresh, gen, dev)
        x32 = torch.randn(rows, d, generator=gen, device=dev)
        g32 = [torch.randn(n, d, generator=gen, device=dev) for _ in range(2)]
        for dtype in (torch.float32, torch.bfloat16):
            tag = "" if dtype == torch.float32 else " bf16"
            es = torch.tensor([], dtype=dtype).element_size()
            x = x32.to(dtype)
            g_self = g32[0].to(dtype) if with_self else None
            g_neigh = g32[1].to(dtype)

            def fwd():
                return gk.dropout_block_fwd(x, keep, inv_keep, mask, with_self, "mean")

            def bwd():
                return gk.dropout_block_bwd(g_self, g_neigh, keep, inv_keep, mask, rows, "mean")

            def plain(fn):
                def run():
                    with gk.plain_versions():
                        return fn()
                return run

            fk, fp = fwd(), plain(fwd)()
            bk, bp = bwd(), plain(bwd)()
            outs_k = tuple(t for t in fk if t is not None)
            outs_p = tuple(t for t in fp if t is not None)
            red = "reduce" if dtype == torch.float32 else "bf16"
            tols = (("exact", red) if with_self else (red,))
            f_err, f_ok, f_text = compare(torch, outs_k, outs_p, tols)
            zeros = all(torch.equal(a == 0, b == 0) for a, b in zip(outs_k, outs_p))
            b_err, b_ok, b_text = compare(torch, bk, bp, red)
            fwd_bytes = ((n if with_self else 0) + valid) * d * (es + 1 / 8) + n * f \
                + n * d * es * (2 if with_self else 1)
            bwd_bytes = (2 if with_self else 1) * n * d * es \
                + ((n if with_self else 0) + valid) * d / 8 + n * f + rows * d * es
            ms = {"fwd": time_ms(torch, fwd, flush, iters=20),
                  "fwd_plain": time_ms(torch, plain(fwd), flush, iters=10),
                  "bwd": time_ms(torch, bwd, flush, iters=20),
                  "bwd_plain": time_ms(torch, plain(bwd), flush, iters=10)}
            row = {"case": f"{label}{tag}", "n": n, "fanout": f, "d": d,
                   "self_half": with_self, "rate": rate, "valid_slots": valid,
                   "fwd_max_abs_err": f_err, "fwd_ok": f_ok, "fwd_tolerance": f_text,
                   "zeros_equal": zeros, "bwd_max_abs_err": b_err, "bwd_ok": b_ok,
                   "bwd_bit_equal": bool(torch.equal(bk, bp)), "bwd_tolerance": b_text,
                   "kernel_ms": ms["fwd"], "plain_ms": ms["fwd_plain"],
                   "bwd_kernel_ms": ms["bwd"], "bwd_plain_ms": ms["bwd_plain"],
                   "bound_ms": fwd_bytes / bw * 1e3, "bwd_bound_ms": bwd_bytes / bw * 1e3}
            row["bound_share"] = row["bound_ms"] / ms["fwd"]
            row["bwd_bound_share"] = row["bwd_bound_ms"] / ms["bwd"]
            if dtype == torch.float32:
                row["draw_int16_ms"] = time_ms(torch, lambda: torch.randint(
                    -(1 << 15), 1 << 15, (rows, d), generator=gen, device=dev,
                    dtype=torch.int16), flush, iters=10)
                row["draw_int32_ms"] = time_ms(torch, lambda: torch.randint(
                    0, 1 << 16, (rows, d), generator=gen, device=dev, dtype=torch.int32),
                    flush, iters=10)
            rows_out.append(row)
            del fk, fp, bk, bp, x, g_self, g_neigh
        del keep, x32, g32, mask
        torch.cuda.empty_cache()
    return rows_out


def dropout_block_branches(torch, gk, dev) -> list:
    """The pair against their plain versions where the cells' blocks do not
    go (:data:`DROPOUT_BLOCK_BRANCHES`), each with and without dropout, both
    kinds, with and without the self half, f32 and bf16."""
    gen = torch.Generator(device=dev).manual_seed(29)
    out = []
    for (d, f, off, extra), dtype in ((c, t) for t in (torch.float32, torch.bfloat16)
                                      for c in DROPOUT_BLOCK_BRANCHES):
        n = 500
        rows = n * (1 + f) + extra
        red = "reduce" if dtype == torch.float32 else "bf16"

        def table(r):
            flat = torch.randn(r * d + off, generator=gen, device=dev).to(dtype)
            return flat[off:].view(r, d)
        x, g_self, g_neigh = table(rows), table(n), table(n)
        mask = torch.rand(n, f, generator=gen, device=dev) > 0.3
        mask[:10] = False
        keep = gk.dropout_bits_plain((rows, d), 1 << 15, gen, dev)
        for kind in ("mean", "sum"):
            for with_self in (True, False):
                for b, inv in ((keep, 2.0), (None, 1.0)):
                    args = (b, inv, mask)
                    fk = gk.dropout_block_fwd(x, *args, with_self, kind)
                    gs = g_self if with_self else None
                    bk = gk.dropout_block_bwd(gs, g_neigh, *args, rows, kind)
                    with gk.plain_versions():
                        fp = gk.dropout_block_fwd(x, *args, with_self, kind)
                        bp = gk.dropout_block_bwd(gs, g_neigh, *args, rows, kind)
                    tols = ("exact", red) if with_self else (red,)
                    f_err, f_ok, _ = compare(torch, tuple(t for t in fk if t is not None),
                                             tuple(t for t in fp if t is not None), tols)
                    b_err, b_ok, _ = compare(torch, bk, bp, red)
                    out.append({"case": f"D={d} F={f} offset={off} extra={extra} {kind} "
                                        f"{'self' if with_self else 'no self'} "
                                        f"{'dropout' if b is not None else 'no dropout'} "
                                        f"{dtype}".replace("torch.", ""),
                                "fwd_max_abs_err": f_err, "bwd_max_abs_err": b_err,
                                "ok": f_ok and b_ok})
    return out


def dropout_block_step_launches(env) -> dict:
    """One device step's launches of a small on-device Trainer at each
    benchmark configuration's model (GraphSAGE mean, 3 blocks, fan-outs 5,
    10, 15; GCN, 2 blocks, fan-out 2), 2 epochs (epoch 1 replayed): the
    assembly, a fused dropout block forward a block and a backward for
    every block but the first."""
    torch, gk, pt = env.torch, env.gk, env.pt
    ds = env.synthetic.synthetic_dataset(40_000, 400_000, feat_dim=100, num_classes=47,
                                         seed=3, learnable=True)
    gcn_ds = env.synthetic.synthetic_dataset(40_000, 400_000, feat_dim=602, num_classes=41,
                                             seed=3, learnable=True)
    out = {}
    for arch, data, model, sampler, per_step in (
            ("graphsage", ds,
             dict(n_layers=2, hidden=256, feat_dim=100, n_classes=47, aggregator="mean",
                  dropout=0.5, skip_connection=False),
             dict(batch_size=1024, fanouts=(5, 10, 15), num_hops=3),
             device_step_launches("assemble_f32", "mean", 3)),
            ("gcn", gcn_ds, dict(n_layers=1, hidden=32, feat_dim=602, n_classes=41,
                                 dropout=0.2),
             dict(batch_size=6000, fanout=2, num_hops=2),
             device_step_launches("assemble_f32", "mean", 2))):
        cfg = pt.Config(model=pt.ModelConfig(arch=arch, **model),
                        sampler=pt.SamplerConfig(seed=0, **sampler),
                        cache=pt.CacheConfig(capacity=None),
                        train=pt.TrainConfig(lr=3e-3, on_device_sampling=True))
        _, row = run_trainer(torch, gk, f"{arch} device step",
                             lambda: env.Trainer.from_dataset(cfg, data, seed=0), 2, per_step,
                             must_fall=False)
        out[arch] = {"launches_per_step": {k: v / sum(e["batches"] for e in row["epochs"])
                                           for k, v in row["launches"].items()},
                     "epochs": row["epochs"]}
    return out


def dropout_block_phase(env, bw: float) -> None:
    """The ``dropout_block`` line: the draws, the kernels at the cells'
    blocks and their branches, and one device step's launches; fails on a
    draw that disagrees or a case outside its tolerance."""
    torch, gk, dev = env.torch, env.gk, env.dev
    from pagraph_tpu_torch.ops import aggregate as agg
    t0 = time.perf_counter()
    out = {"draws": {label: dropout_draws_agree(torch, dev, n * (1 + f), d)
                     for label, n, f, d, _, _ in DROPOUT_BLOCK_SHAPES}}
    out["kernels"] = dropout_block_cases(torch, gk, agg, dev, bw, env.flush)
    out["branches"] = dropout_block_branches(torch, gk, dev)
    out["device_step"] = dropout_block_step_launches(env)
    out["seconds"] = time.perf_counter() - t0
    emit("dropout_block", out)
    bad = [f"draws at {k}: {v}" for k, v in out["draws"].items() if not v["ok"]]
    bad += [f"{r['case']}: {r}" for r in out["kernels"]
            if not (r["fwd_ok"] and r["bwd_ok"] and r["zeros_equal"])]
    bad += [r["case"] for r in out["branches"] if not r["ok"]]
    if bad:
        fail("dropout_block: " + "; ".join(bad))


# -- dropout_bits: the keep-mask kernel against torch.randint ----------------
# the sources of the blocks whose dropout the kernel draws in the benchmark
# cells: (label, rows, D, rate): sage-ogbn-products blocks 0, 1 and 2 and
# gcn-pagraph-reddit blocks 0 and 1 (its skip concat doubles hidden 32)
DROPOUT_BITS_SHAPES = (("sage block0", 1_081_344, 100, 0.5), ("sage block1", 180_224, 256, 0.5),
                       ("sage block2", 16_384, 256, 0.5), ("gcn block0", 54_000, 602, 0.2),
                       ("gcn block1", 18_000, 64, 0.2))
# the generator's Philox offsets each shape is drawn from (multiples of 4)
DROPOUT_BITS_OFFSETS = (0, 4 * 12_345, (1 << 36) + 4 * 7)
# a draw's replays in a captured graph
DROPOUT_BITS_REPLAYS = 3
# the H100 SXM's boost clock and int32 multiplies a SM and clock, for the
# Philox bound: 40 multiplies (20 low and 20 high halves) a counter of 4 units
SM_CLOCK_HZ, IMUL_PER_SM_CLOCK = 1.98e9, 64


def dropout_bits_agree(torch, gk, CapturedGraph, dev, rows: int, d: int, rate: float) -> dict:
    """``gk.dropout_bits`` against ``torch.randint``'s decisions, bit for
    bit, at ``[rows, d]``: eagerly from each of :data:`DROPOUT_BITS_OFFSETS`,
    and in one ``CapturedGraph`` replayed :data:`DROPOUT_BITS_REPLAYS` times
    from the second; the generators' offsets equal after each draw."""
    from pagraph_tpu_torch.ops.aggregate import dropout_threshold
    thresh, _ = dropout_threshold(rate)
    shape = (rows, d)

    def gens(seed):
        return [torch.Generator(device=dev).manual_seed(seed) for _ in range(2)]

    def same(a, b, g_k, g_t):
        return bool(torch.equal(a, b)) and g_k.get_offset() == g_t.get_offset()

    g_k, g_t = gens(31)
    eager = []
    for off in DROPOUT_BITS_OFFSETS:
        g_k.set_offset(off)
        g_t.set_offset(off)
        eager.append(same(gk.dropout_bits(shape, thresh, g_k, dev),
                          gk.dropout_bits_plain(shape, thresh, g_t, dev), g_k, g_t))
    g_k, g_t = gens(37)
    graph = CapturedGraph(lambda: gk.dropout_bits(shape, thresh, g_k, dev), generator=g_k)
    captured_offset = g_k.get_offset()
    for g in (g_k, g_t):
        g.set_offset(DROPOUT_BITS_OFFSETS[1])
    replays = []
    for _ in range(DROPOUT_BITS_REPLAYS):
        out = graph()
        replays.append(same(out, gk.dropout_bits_plain(shape, thresh, g_t, dev), g_k, g_t))
    kept = float(gk.unpack_bits(graph.out, shape).float().mean())
    row = {"rows": rows, "d": d, "rate": rate, "thresh": thresh, "eager_equal": eager,
           "replays_equal": replays, "capture_left_offset": captured_offset == 0,
           "graph_units": graph.units, "graph_launches": graph.launches,
           "increment": g_t.get_offset() - DROPOUT_BITS_OFFSETS[1], "kept_share": kept}
    row["ok"] = all(eager) and all(replays) and row["capture_left_offset"]
    del graph
    return row


def dropout_bits_mixed_refused(torch, gk, CapturedGraph, dev) -> bool:
    """A graph that draws from one generator through torch and through the
    kernel: its replay raises ``RuntimeError`` (their offsets would
    overlap)."""
    g = torch.Generator(device=dev).manual_seed(41)

    def mixed():
        torch.randint(0, 1 << 16, (1000,), generator=g, device=dev, dtype=torch.int32)
        return gk.dropout_bits((1000,), 32768, g, dev)

    graph = CapturedGraph(mixed, generator=g)
    try:
        graph()
    except RuntimeError:
        return True
    return False


def dropout_bits_cases(torch, gk, dev, bw, flush) -> list:
    """The kernel at :data:`DROPOUT_BITS_SHAPES` timed beside the plain
    version (``torch.randint``, the compare, the packing), ``torch.randint``
    alone (``library_ms``, the draw the kernel replaces) and the bound: the
    larger of the Philox multiplies at the card's integer rate and the
    mask's bytes written once."""
    from pagraph_tpu_torch.ops.aggregate import dropout_threshold
    gen = torch.Generator(device=dev).manual_seed(43)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []
    for label, rows, d, rate in DROPOUT_BITS_SHAPES:
        thresh, _ = dropout_threshold(rate)
        n = rows * d
        ms = {"kernel_ms": time_ms(torch, lambda: gk.dropout_bits((rows, d), thresh, gen, dev),
                                   flush, iters=20),
              "plain_ms": time_ms(torch, lambda: gk.dropout_bits_plain((rows, d), thresh, gen,
                                                                       dev), flush, iters=10),
              "library_ms": time_ms(torch, lambda: torch.randint(
                  -(1 << 15), 1 << 15, (rows, d), generator=gen, device=dev,
                  dtype=torch.int16), flush, iters=10)}
        philox_ms = n / 4 * 40 / (sms * IMUL_PER_SM_CLOCK * SM_CLOCK_HZ) * 1e3
        bytes_ms = 4 * -(-n // 32) / bw * 1e3
        row = {"case": label, "units": n, "grid": gk.draw_grid(n, *gk._draw_props(dev)), **ms,
               "philox_bound_ms": philox_ms, "bytes_bound_ms": bytes_ms,
               "bound_ms": max(philox_ms, bytes_ms)}
        row["bound_share"] = row["bound_ms"] / ms["kernel_ms"]
        out.append(row)
        torch.cuda.empty_cache()
    return out


def dropout_bits_trainers(env) -> dict:
    """Small on-device Trainers (2 epochs, epoch 1 replayed) against a fresh
    Trainer's 2 eager epochs, bit-equal losses, parameters and generator
    offsets: the sage-ogbn-products model (3 blocks, a keep-mask launch a
    block) and a preprocess GraphSAGE (its layer-0 dropout is torch's, so
    its blocks draw through ``torch.randint`` too: no keep-mask launch)."""
    torch, pt = env.torch, env.pt
    from pagraph_tpu_torch.train.device_epoch import DeviceEpochRunner
    ds = env.synthetic.synthetic_dataset(40_000, 400_000, feat_dim=100, num_classes=47,
                                         seed=3, learnable=True)
    out = {}
    for label, preprocess, sampler, per_step in (
            ("sage", False, dict(batch_size=1024, fanouts=(5, 10, 15), num_hops=3),
             device_step_launches("assemble_f32", "mean", 3)),
            ("sage preprocess", True, dict(batch_size=1024, fanouts=(10, 15), num_hops=2),
             device_step_launches("assemble_f32", "mean", 2, grads=2, kernel_draws=False))):
        cfg = pt.Config(model=pt.ModelConfig(arch="graphsage", n_layers=2, hidden=256,
                                             feat_dim=100, n_classes=47, aggregator="mean",
                                             dropout=0.5, skip_connection=False,
                                             preprocess=preprocess),
                        sampler=pt.SamplerConfig(seed=0, **sampler),
                        cache=pt.CacheConfig(capacity=None),
                        train=pt.TrainConfig(lr=3e-3, on_device_sampling=True))
        cfg.validate()
        t_, row = run_trainer(torch, env.gk, f"{label} device", lambda: env.Trainer.from_dataset(
            cfg, ds, seed=0), 2, per_step, must_fall=False)
        replayed = [m["mean_loss"] for m in row["epochs"]]
        params = {k: p.detach().clone() for k, p in t_.state.model.named_parameters()}
        offset = t_.state.generator.get_offset()
        units = executed_units(env.gk.DRAWN_UNITS["dropout_bits"], t_.epoch_runner)
        del t_
        gc.collect()
        torch.cuda.empty_cache()
        t_e = env.Trainer.from_dataset(cfg, ds, seed=0)
        runner = DeviceEpochRunner(cfg, t_e.state, t_e.epoch_inputs, t_e.device_data())
        eager = []
        for e in range(2):
            t_e.epoch_inputs.load(*t_e.epoch_randomness(e, out=t_e.epoch_inputs))
            v = runner().values()
            eager.append(v["loss_sum"] / max(v["steps"], 1))
        equal = replayed == eager and all(torch.equal(params[k], p) for k, p in
                                          t_e.state.model.named_parameters())
        out[label] = {"launches_per_step": per_step, "epochs": row["epochs"],
                      "units_drawn_by_kernel": units, "eager_losses": eager,
                      "replay_bit_equal_to_eager": equal,
                      "generator_offsets": [offset, t_e.state.generator.get_offset()]}
        out[label]["ok"] = equal and offset == t_e.state.generator.get_offset() and (
            (units > 0) != preprocess)
        del t_e, runner
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dropout_bits_phase(env, bw: float) -> None:
    """The ``dropout_bits`` line: the keep-mask against ``torch.randint`` at
    the cells' blocks, eagerly and replayed, a mixed graph refused, the
    kernel's times, and the Trainers' launches and replays; fails on any
    mask, offset or replay that disagrees."""
    torch, gk, dev = env.torch, env.gk, env.dev
    from pagraph_tpu_torch.train.state import CapturedGraph
    t0 = time.perf_counter()
    out = {"sms": gk._draw_props(dev)[0], "max_threads_per_sm": gk._draw_props(dev)[1],
           "draws": {label: dropout_bits_agree(torch, gk, CapturedGraph, dev, rows, d, rate)
                     for label, rows, d, rate in DROPOUT_BITS_SHAPES}}
    torch.cuda.empty_cache()
    print(json.dumps({"dropout_bits_draws": out["draws"]}), flush=True)
    out["mixed_graph_refused"] = dropout_bits_mixed_refused(torch, gk, CapturedGraph, dev)
    out["kernels"] = dropout_bits_cases(torch, gk, dev, bw, env.flush)
    out["trainers"] = dropout_bits_trainers(env)
    out["seconds"] = time.perf_counter() - t0
    emit("dropout_bits", out)
    bad = [f"draws at {k}: {v}" for k, v in out["draws"].items() if not v["ok"]]
    bad += [f"{k}: {v}" for k, v in out["trainers"].items() if not v["ok"]]
    if not out["mixed_graph_refused"]:
        bad.append("a graph mixing torch's draws with the kernel's replayed without an error")
    if bad:
        fail("dropout_bits: " + "; ".join(bad))


# -- gat_attention: GAT's attention kernels at the gat-products.device cell --
# the cell's blocks (batch 512, fan-outs 10/10/10, 4 heads of 128, 47
# classes): (label, n, fan-out, heads, head width)
GAT_BLOCKS = (("block 0", 61_952, 10, 4, 128), ("block 1", 5_632, 10, 4, 128),
              ("block 2", 512, 10, 4, 47))
# where the cell's blocks do not go: (n, fan-out, heads, head width, rows past
# n x (1 + fan-out)): units of 1 and 4 floats, 1-4 units a lane, fan-outs
# of one chunk, several and more than a mask word
GAT_BRANCHES = ((300, 3, 2, 8, 0), (300, 7, 1, 64, 5), (200, 15, 3, 47, 0),
                (100, 70, 2, 100, 3), (64, 1, 8, 256, 0), (50, 9, 4, 126, 2),
                (40, 2, 1, 512, 0))
# tolerances against the plain versions, relative to each output's largest
# value: the scores' and sums' order differs (warp shuffles against einsum),
# the softmax is online; the attention vectors' gradients sum n x (1 + F)
# terms in another order
GAT_TOL_FWD = (1e-5, 1e-5)
GAT_TOL_BWD = (1e-5, 1e-4, 1e-4)


def gat_attention_inputs(torch, dev, gen, n, f, heads, hd, extra=0):
    """``(z, a_s, a_n, mask, g)`` of a prefix-layout block: ``z`` normal at
    0.5, the attention vectors at GAT's init bound, 90% of the slots valid
    and the first 16 rows with none."""
    rows = n * (1 + f) + extra
    bound = math.sqrt(6.0 / (hd + 1))
    z = torch.randn(rows, heads * hd, generator=gen, device=dev) * 0.5
    a_s, a_n = ((torch.rand(heads, hd, generator=gen, device=dev) * 2 - 1) * bound
                for _ in range(2))
    mask = torch.rand(n, f, generator=gen, device=dev) > 0.1
    mask[:16] = False
    g = torch.randn(n, heads, hd, generator=gen, device=dev)
    return z, a_s, a_n, mask, g


def gat_attention_case(torch, gk, args, timed=None) -> dict:
    """The kernels against their plain versions on ``args``
    (:func:`gat_attention_inputs`): the forward's output and stats, the
    backward's three gradients (within :data:`GAT_TOL_FWD` and
    :data:`GAT_TOL_BWD`), the masked slots' and the spare rows' gradient
    exactly 0, the backward bit-equal on a second run; with ``timed`` (the
    card's bandwidth and the flush buffer) the times of both and of the
    plain chain under autograd, beside the least bytes' bound."""
    z, a_s, a_n, mask, g = args
    rows, (n, f), (heads, hd) = z.shape[0], mask.shape, a_s.shape

    def fwd():
        return gk.gat_attention_fwd(z, a_s, a_n, mask)

    fk = fwd()
    with gk.plain_versions():
        fp = fwd()

    def bwd(fo):
        return gk.gat_attention_bwd(g, z, a_s, a_n, mask, fo[0], fo[1], rows)

    bk, bk2 = bwd(fk), bwd(fk)
    with gk.plain_versions():
        bp = bwd(fp)
    f_err, f_ok, _ = compare(torch, fk, fp, GAT_TOL_FWD)
    b_err, b_ok, _ = compare(torch, bk, bp, GAT_TOL_BWD)
    dz = bk[0]
    slots = dz[n:n * (1 + f)].view(n, f, -1)
    zeros = bool((slots[~mask] == 0).all()) and bool((dz[n * (1 + f):] == 0).all())
    row = {"n": n, "fanout": f, "heads": heads, "head_dim": hd, "rows": rows,
           "valid_slots": int(mask.sum()), "fwd_max_abs_err": f_err, "fwd_ok": f_ok,
           "bwd_max_abs_err": b_err, "bwd_ok": b_ok, "zeros_ok": zeros,
           "bwd_deterministic": all(torch.equal(a, b) for a, b in zip(bk, bk2))}
    row["ok"] = f_ok and b_ok and zeros and row["bwd_deterministic"]
    if timed is not None:
        bw, flush = timed
        valid, kh = row["valid_slots"], heads * hd
        read_z = (n + valid) * kh * 4
        fwd_bytes = read_z + n * f + n * kh * 4 + 2 * n * heads * 4
        bwd_bytes = read_z + 2 * n * kh * 4 + 2 * n * heads * 4 + n * f + rows * kh * 4

        def plain(fn):
            def run():
                with gk.plain_versions():
                    return fn()
            return run

        def chain():
            zz, s_, n_ = (t.detach().requires_grad_(True) for t in (z, a_s, a_n))
            out = gk.gat_attention_fwd_plain(zz, s_, n_, mask)[0]
            torch.autograd.grad(out, (zz, s_, n_), g)

        row.update(kernel_ms=time_ms(torch, fwd, flush, iters=20),
                   plain_ms=time_ms(torch, plain(fwd), flush, iters=5),
                   bwd_kernel_ms=time_ms(torch, lambda: bwd(fk), flush, iters=20),
                   bwd_plain_ms=time_ms(torch, plain(lambda: bwd(fp)), flush, iters=5),
                   chain_autograd_ms=time_ms(torch, chain, flush, iters=5),
                   bound_ms=fwd_bytes / bw * 1e3, bwd_bound_ms=bwd_bytes / bw * 1e3)
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        row["bwd_bound_share"] = row["bwd_bound_ms"] / row["bwd_kernel_ms"]
    return row


def gat_cell_config(pt, *, compute: str = "float32", dispatch: str = "scan"):
    """The gat-products.device cell's model and sampler (PyG's
    ogbn_products_gat.py) on the on-device path."""
    return pt.Config(
        model=pt.ModelConfig(arch="gat", n_layers=2, hidden=128, num_heads=4, feat_dim=100,
                             n_classes=47, dropout=0.5, residual=True, feature_dropout=False),
        sampler=pt.SamplerConfig(batch_size=512, fanouts=(10, 10, 10), num_hops=3, seed=0),
        cache=pt.CacheConfig(capacity=None),
        train=pt.TrainConfig(lr=1e-3, on_device_sampling=True, dtype=compute,
                             epoch_dispatch=dispatch))


def gat_attention_phase(env, bw: float) -> None:
    """The ``gat_attention`` line: the kernels at the cell's three blocks
    (timed) and at :data:`GAT_BRANCHES`, and the cell's model through a
    small on-device Trainer, 2 epochs (epoch 1 replayed), with exact
    launches a step: the assembly and one attention forward and one
    backward a block.  Fails on a case outside its tolerance or another
    launch count."""
    torch, gk, dev = env.torch, env.gk, env.dev
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(31)
    out = {"blocks": [], "branches": []}
    for label, n, f, heads, hd in GAT_BLOCKS:
        args = gat_attention_inputs(torch, dev, gen, n, f, heads, hd)
        out["blocks"].append({"case": label, **gat_attention_case(torch, gk, args,
                                                                  (bw, env.flush))})
        del args
        torch.cuda.empty_cache()
    for n, f, heads, hd, extra in GAT_BRANCHES:
        args = gat_attention_inputs(torch, dev, gen, n, f, heads, hd, extra)
        out["branches"].append({"case": f"n={n} F={f} K={heads} H={hd} extra={extra}",
                                **gat_attention_case(torch, gk, args)})
    for key in ("kernel_ms", "bwd_kernel_ms", "chain_autograd_ms"):
        out[f"cell_{key}"] = sum(r[key] for r in out["blocks"])
    ds = env.synthetic.synthetic_dataset(40_000, 400_000, feat_dim=100, num_classes=47,
                                         seed=3, learnable=True)
    cfg = gat_cell_config(env.pt)
    per_step = device_step_launches("assemble_f32", blocks=3, gat=True)
    t_, row = run_trainer(torch, gk, "gat device step",
                          lambda: env.Trainer.from_dataset(cfg, ds, seed=0), 2, per_step,
                          must_fall=False)
    out["device_step"] = {"launches_per_step": per_step, "epochs": row["epochs"],
                          "peak_device_bytes": row["peak_device_bytes"]}
    del t_
    out["seconds"] = time.perf_counter() - t0
    emit("gat_attention", out)
    bad = [f"{r['case']}: {r}" for r in out["blocks"] + out["branches"] if not r["ok"]]
    if bad:
        fail("gat_attention: " + "; ".join(bad))


def executed_units(counted: int, runner) -> int:
    """The units the keep-mask kernel drew since the counters' reset:
    ``counted`` (``gk.DRAWN_UNITS["dropout_bits"]``, a captured draw once)
    with each of ``runner``'s graphs' units times its replays in place of
    that once."""
    return counted + sum(g.units * (g.replays - 1)
                         for g in (runner.graphs if runner is not None else ()))


def executed_launches(counted, runner):
    """The launches run since the counters' reset: ``counted`` (which counts
    a launch captured into a graph once, at capture) with each of
    ``runner``'s graphs' captured launches times its replays in place of that
    once (its graphs captured since the reset).  ``runner``: a
    ``DeviceEpochRunner``, a host Trainer's ``group_graphs``, or None."""
    out = dict(counted)
    for g in (runner.graphs if runner is not None else ()):
        for k, v in g.launches.items():
            out[k] += v * (g.replays - 1)
    return out


def epoch_rows(ms):
    return [{"epoch": m.epoch, "time_s": m.time_s, "batches": m.num_batches,
             "edges": m.edges, "edges_per_s": m.edges / m.time_s,
             "mean_loss": m.mean_loss, "mean_acc": m.mean_acc,
             "miss_rate": m.miss_rate, "h2d_bytes": m.h2d_bytes} for m in ms]


def run_trainer(torch, gk, what, make, n_epochs, per_step, per_epoch=None,
                must_fall=True):
    """A fresh Trainer from ``make()`` for ``n_epochs``: setup, epochs,
    launches run (eager ones plus each graph's replays), peak device bytes;
    fails unless ``per_step`` (key -> launches a step) plus ``per_epoch``
    (key -> launches an epoch, such as CV-GCN's refresh) is exactly what
    ran, every loss is finite and, over 2 epochs, the loss falls (reported
    as ``loss_falls``, and not held when ``must_fall`` is false)."""
    gc.collect()
    torch.cuda.empty_cache()
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t_ = make()
    t_._maybe_fill_cache()
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    gk.reset_launch_counts()
    ms = [t_.run_epoch(e) for e in range(n_epochs)]
    torch.cuda.synchronize()
    runner = t_.epoch_runner if t_._device_mode else t_.group_graphs
    counts = {k: v for k, v in executed_launches(gk.launch_counts(), runner).items() if v}
    steps = sum(m.num_batches for m in ms)
    out = {"setup_s": setup, "capture_s": t_.timers.total["capture"],
           "epochs": epoch_rows(ms), "launches": counts,
           "launches_per_step": sum(counts.values()) / steps,
           "peak_device_bytes": torch.cuda.max_memory_allocated() - start_bytes}
    losses = [m.mean_loss for m in ms]
    if not all(math.isfinite(v) for v in losses):
        fail(f"{what}: non-finite loss {losses}")
    want = {k: v * steps for k, v in per_step.items()}
    for k, v in (per_epoch or {}).items():
        want[k] = want.get(k, 0) + v * n_epochs
    if counts != want:
        fail(f"{what}: launches {counts} over {steps} steps, expected {per_step} a step"
             + (f" and {per_epoch} an epoch" if per_epoch else ""))
    out["loss_falls"] = losses[-1] < losses[0]
    if must_fall and n_epochs > 1 and not out["loss_falls"]:
        fail(f"{what}: loss did not fall: {losses}")
    return t_, out


# -- model_families: GCN, GIN and GAT at the leaderboard width ----------------
FAMILY_TRAIN_VERTICES = 65_536         # the one cut: 64 steps an epoch at batch 1024
FAMILIES = ("gcn", "gin", "gat")
# the RMAT scale of the graph where device logits are held against the host's:
# a host pass stays within seconds (GAT's host edge softmax is np.add.at)
FAMILY_HOST_SCALES = {"gcn": 16, "gin": 16, "gat": 14}


def family_config(pt, arch: str, num_nodes: int, *, on_device: bool = False,
                  compute: str = "float32", dispatch: str = "scan"):
    """The JAX package's OGB-leaderboard shape (BENCH_NOTES.md): 2 hidden
    layers (3 blocks) of width 256 (GAT: 4 heads of 64), 100-dim features,
    47 classes, dropout 0.5, batch 1024, fan-outs (15, 10, 5), Adam 1e-2;
    the host path's cache at 40% of the vertices, the device path's full."""
    return pt.Config(
        model=pt.ModelConfig(arch=arch, n_layers=2, hidden=64 if arch == "gat" else 256,
                             num_heads=4, feat_dim=100, n_classes=47, dropout=0.5),
        sampler=pt.SamplerConfig(batch_size=1024, fanouts=(15, 10, 5), num_hops=3, seed=0,
                                 prefetch=3),
        cache=pt.CacheConfig(enabled=True,
                             capacity=None if on_device else int(num_nodes * 0.4)),
        train=pt.TrainConfig(lr=1e-2, warmup_epochs=1, on_device_sampling=on_device,
                             dtype=compute, epoch_dispatch=dispatch))


def family_step_launches(arch: str, compute: str) -> dict:
    """The gather-kernel launches one host step makes (3 blocks): the
    assembly; GCN a gather_reduce (mean) a block and a gather_reduce_bwd for
    blocks 1 and 2; GIN the fused block forward (sum) a block and the fused
    backward for blocks 1 and 2; GAT a gather_rows a block and a
    scatter_add_rows a block (block 0's too: z depends on w).  At bf16
    compute every key has its _bf16 twin and each block backward a
    grad_to_bf16; scatter_add_rows rounds inside its one launch.  (GAT's
    on-device step launches its attention pair instead:
    :func:`device_step_launches` with ``gat``.)"""
    sfx = "_bf16" if compute == "bfloat16" else ""
    fwd, bwd, n_bwd = {"gcn": ("gather_reduce_mean", "gather_reduce_bwd_mean", 2),
                       "gin": ("block_gather_fwd_sum", "block_gather_bwd_sum", 2),
                       "gat": ("gather_rows", "scatter_add_rows", 3)}[arch]
    out = {"assemble_f32" + ("_to_bf16" if sfx else ""): 1, fwd + sfx: 3, bwd + sfx: n_bwd}
    if sfx and arch != "gat":
        out["grad_to_bf16"] = n_bwd
    return out


def device_step_launches(assemble_key: str, kind=None, blocks: int = 0,
                         grads=None, bf16: bool = False, gat: bool = False,
                         kernel_draws: bool = True) -> dict:
    """The gather-kernel launches one on-device step makes: the layer-0
    fetch (``assemble_key``) and, where the blocks reduce with ``kind``
    (``mean`` or ``sum``: GraphSAGE mean or gcn, GCN, GIN), one fused dropout
    block forward a block and one backward a block whose source needs a
    gradient (``grads``, by default every block but the first: the
    features take none), ``_bf16`` at bf16 compute, and one keep-mask
    (``dropout_bits``) a block where the model drops out (``kernel_draws``:
    false at dropout 0, and under preprocess, whose blocks draw through
    ``torch.randint``).  GAT at f32 (``gat``) one attention forward and one
    backward a block (block 0's too: ``z`` depends on ``w``); at bf16, pool,
    lstm and CV-GCN (``kind`` None) no block kernel runs on the device."""
    out = {assemble_key: 1}
    if gat and not bf16:
        out.update(gat_attention_fwd=blocks, gat_attention_bwd=blocks)
    if kind is not None:
        sfx = "_bf16" if bf16 else ""
        grads = blocks - 1 if grads is None else grads
        if kernel_draws:
            out["dropout_bits"] = blocks
        out[f"dropout_block_fwd_{kind}{sfx}"] = blocks
        if grads:
            out[f"dropout_block_bwd_{kind}{sfx}"] = grads
    return out


# the main path's on-device step (GraphSAGE mean, 2 blocks), and at dropout 0
DEVICE_STEP = device_step_launches("assemble_f32", "mean", 2)
DEVICE_STEP_NO_DROPOUT = device_step_launches("assemble_f32", "mean", 2, kernel_draws=False)


def model_families(env):
    """GCN, GIN and GAT through ``Trainer.from_dataset`` at the leaderboard
    width on the RMAT-20 graph with the 2-hop teacher labels, the train set
    cut to its first :data:`FAMILY_TRAIN_VERTICES` vertices.  For each: the
    host path 2 epochs at f32 (epoch 1 replayed from the host-step graphs)
    and 1 at bf16 compute, exact launches a step (:func:`family_step_launches`);
    the on-device path, ``steps`` mode, 2 epochs (epoch 1 replayed) against
    a fresh Trainer's 2 epochs through the eager form, bit-equal; device
    inference and ``evaluate`` on RMAT-20; device against host logits on a
    smaller graph (RMAT-16, GAT RMAT-14) within 1e-4 of each row's largest.
    Then ``mlp_val_acc`` on the same labels.  Returns the phase's line and
    the kernel cases at the families' shapes for the ``kernels`` line."""
    torch, np, gk, pt = env.torch, env.np, env.gk, env.pt
    t_phase = time.perf_counter()
    ds = env.ds_nb
    train_ids = np.nonzero(ds.train_mask)[0][:FAMILY_TRAIN_VERTICES]
    cut = np.zeros_like(ds.train_mask)
    cut[train_ids] = True
    data = env.Dataset(ds.graph, ds.features, ds.labels, cut, ds.val_mask, ds.test_mask)
    small = {}
    for scale in set(FAMILY_HOST_SCALES.values()):
        g = env.CSRGraph.from_coo(env.synthetic.rmat_coo(scale, 16, seed=42))
        small[scale] = (g, np.random.default_rng(7).random((g.num_nodes, 100),
                                                           dtype=np.float32))
    out, bad, trainers = {"train_vertices": len(train_ids)}, [], {}
    n = ds.num_nodes
    for arch in FAMILIES:
        t_arch = time.perf_counter()
        entry = {}
        t_host, entry["host_f32"] = run_trainer(
            torch, gk, f"{arch} host", lambda: env.Trainer.from_dataset(
                family_config(pt, arch, n), data, seed=0), 2,
            family_step_launches(arch, "float32"))
        entry["host_f32"]["graphs"] = len(t_host.group_graphs.graphs) if t_host.group_graphs \
            else 0
        entry["host_f32"]["caps"] = list(t_host.sampler.caps)
        _, entry["host_bf16"] = run_trainer(
            torch, gk, f"{arch} host bf16", lambda: env.Trainer.from_dataset(
                family_config(pt, arch, n, compute="bfloat16"), data, seed=0), 1,
            family_step_launches(arch, "bfloat16"))
        # the on-device path: the replayed epoch against the eager form
        cfg_d = family_config(pt, arch, n, on_device=True, dispatch="steps")
        t_dev, entry["device_steps"] = run_trainer(
            torch, gk, f"{arch} on-device", lambda: env.Trainer.from_dataset(
                cfg_d, data, seed=0), 2,
            device_step_launches("assemble_f32", {"gcn": "mean", "gin": "sum"}.get(arch), 3,
                                 gat=arch == "gat"))
        replayed = [m["mean_loss"] for m in entry["device_steps"]["epochs"]]
        p_r = {k: p.detach().clone() for k, p in t_dev.state.model.named_parameters()}
        del t_dev
        gc.collect()
        torch.cuda.empty_cache()
        t_e = env.Trainer.from_dataset(cfg_d, data, seed=0)
        runner = env.DeviceEpochRunner(cfg_d, t_e.state, t_e.epoch_inputs, t_e.device_data())
        eager = []
        for e in range(2):
            t_e.epoch_inputs.load(*t_e.epoch_randomness(e, out=t_e.epoch_inputs))
            v = runner().values()
            eager.append(v["loss_sum"] / max(v["steps"], 1))
        equal = replayed == eager and all(torch.equal(p_r[k], p) for k, p in
                                          t_e.state.model.named_parameters())
        entry["device_steps"]["eager_losses"] = eager
        entry["device_steps"]["replay_bit_equal_to_eager"] = equal
        if not equal:
            worst = max(float((p_r[k] - p).abs().max()) for k, p in
                        t_e.state.model.named_parameters())
            bad.append(f"{arch}: the on-device replay is not bit-equal to the eager form "
                       f"(losses {replayed} vs {eager}, parameters {worst} apart)")
        del t_e, runner, p_r
        # inference: the device backend and evaluate on RMAT-20
        model, mcfg = t_host.state.model, t_host.cfg.model
        inf = {}
        gk.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = env.full_graph_logits(model, mcfg, ds.graph, ds.features, backend="device")
        torch.cuda.synchronize()
        inf["rmat20_device_s"] = time.perf_counter() - t0
        inf["rmat20_device_launches"] = {k: v for k, v in gk.launch_counts().items() if v}
        if not (logits.shape == (n, 47) and np.isfinite(logits).all()):
            bad.append(f"{arch}: device logits of shape {logits.shape}, finite "
                       f"{bool(np.isfinite(logits).all())}")
        inf["val_acc"] = env.evaluate(model, mcfg, ds.graph, ds.features, ds.labels,
                                      ds.val_mask, backend="device")
        scale_s = FAMILY_HOST_SCALES[arch]
        g, x = small[scale_s]
        both = {}
        for backend in ("host", "device"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            both[backend] = env.full_graph_logits(model, mcfg, g, x, backend=backend)
            inf[f"rmat{scale_s}_{backend}_s"] = time.perf_counter() - t0
        scale = 1.0 + np.abs(both["host"]).max(axis=1, keepdims=True)
        inf["device_vs_host_max_row_rel_diff"] = float(
            (np.abs(both["device"] - both["host"]) / scale).max())
        if not inf["device_vs_host_max_row_rel_diff"] <= 1e-4:
            bad.append(f"{arch}: device logits {inf['device_vs_host_max_row_rel_diff']} "
                       "from the host's")
        want = {"gcn": "gather_reduce_sum", "gin": "gather_reduce_sum"}.get(arch)
        if want and inf["rmat20_device_launches"].get(want, 0) <= 0:
            bad.append(f"{arch}: device inference launched no {want}")
        entry["inference"] = inf
        entry["seconds"] = time.perf_counter() - t_arch
        out[arch] = entry
        trainers[arch] = t_host
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["mlp_probe"] = {"val_acc": env.mlp_val_acc(ds.features, ds.labels, ds.train_mask,
                                                   ds.val_mask, seed=0),
                        "seconds": time.perf_counter() - t0}
    out["val_acc"] = {arch: out[arch]["inference"]["val_acc"] for arch in FAMILIES}
    out["note"] = (f"trained on neighborhood_labels(graph, features, 47, seed=1), the first "
                   f"{FAMILY_TRAIN_VERTICES} train vertices; host f32 2 epochs (epoch 1 "
                   "replayed), host bf16 1 eager epoch, on-device steps mode 2 epochs "
                   "(epoch 1 replayed) against the eager form; mlp_probe on every train "
                   "vertex (max_train 200000)")
    out["seconds"] = time.perf_counter() - t_phase
    cases = family_kernel_cases(env, trainers, out)
    return out, cases, bad


def family_kernel_cases(env, trainers, out):
    """The kernel cases at the families' shapes, on one host batch of the
    GCN trainer (the three share the sampler's configuration): the
    ``gather_reduce`` (mean) forward at each GCN block and its backward at
    blocks 1 and 2, the fused ``sum`` forward and backward at GIN's blocks,
    and ``gather_rows`` and ``scatter_add_rows`` at GAT's block-0 table
    ``[z | att_s | att_n]`` (264 columns).  Source rows: block 0 the
    assembled features, deeper blocks random at the model's widths (256,
    then 512 after the skip); gradients random.  Launches: the family's
    host f32 run's."""
    torch, gk, dev = env.torch, env.gk, env.dev
    t_ = trainers["gcn"]
    mb_h = t_.sampler.sample(t_.sampler.train_nids[:t_.cfg.sampler.batch_size])
    mb = mb_h.to(dev)
    plan = t_.cache.fetch_plan(mb_h.input_nids, mb_h.input_mask, track=False)
    feats = gk.assemble(t_.cache.cache_values, torch.from_numpy(plan.src_row).to(dev),
                        plan.miss_feats.to(dev))
    gen = torch.Generator(device=dev).manual_seed(3)
    widths = (100, 256, 512)
    srcs = [feats] + [torch.randn(mb.layer_nids[i].shape[0], w, generator=gen, device=dev)
                      for i, w in enumerate(widths[1:], 1)]
    cases = []

    def distinct(*idx):
        return int(torch.unique(torch.cat([i.reshape(-1) for i in idx])).numel())

    def flat_of(b):
        counts = b.neigh_mask.sum(1)
        offsets = torch.zeros_like(counts)
        offsets[1:] = torch.cumsum(counts, 0)[:-1]
        return b.neigh_pos[b.neigh_mask].long(), offsets.long()

    def launches_of(arch, key):
        return out[arch]["host_f32"]["launches"].get(key, 0)

    for bi, (b, src) in enumerate(zip(mb.blocks, srcs)):
        n, f = b.neigh_pos.shape
        s, d = src.shape
        flat, offs = flat_of(b)
        rows = distinct(b.neigh_pos[b.neigh_mask])
        cases.append(dict(
            name=f"gather_reduce_mean[gcn block{bi}]", key="gather_reduce_mean",
            launches=launches_of("gcn", "gather_reduce_mean"),
            replaces=f"{PALLAS}:132 gather_mean_pallas",
            shape=f"src {list(src.shape)} pos/mask [{n}, {f}]", tol="reduce",
            kernel=lambda s_=src, b_=b: gk.gather_reduce(s_, b_.neigh_pos, b_.neigh_mask,
                                                          "mean"),
            plain=lambda s_=src, b_=b: gk.gather_reduce_plain(s_, b_.neigh_pos,
                                                               b_.neigh_mask, "mean"),
            library=lambda s_=src, fl=flat, of=offs: torch.nn.functional.embedding_bag(
                fl, s_, of, mode="mean"),
            nbytes=5 * n * f + 4 * rows * d + 4 * n * d))
        self_rows = distinct(b.self_pos, b.neigh_pos[b.neigh_mask])
        cases.append(dict(
            name=f"block_gather_fwd_sum[gin block{bi}]", key="block_gather_fwd_sum",
            launches=launches_of("gin", "block_gather_fwd_sum"),
            replaces=f"{PALLAS}:58 gather_rows_pallas + {PALLAS}:132 gather_mean_pallas",
            shape=f"src {list(src.shape)} self_pos [{n}] pos/mask [{n}, {f}]",
            tol=("exact", "reduce"),
            kernel=lambda s_=src, b_=b: gk.block_gather_fwd(s_, b_.self_pos, b_.neigh_pos,
                                                             b_.neigh_mask, "sum"),
            plain=lambda s_=src, b_=b: gk.block_gather_fwd_plain(
                s_, b_.self_pos, b_.neigh_pos, b_.neigh_mask, "sum"),
            library=lambda s_=src, ids=b.self_pos.long(), fl=flat, of=offs: (
                torch.index_select(s_, 0, ids),
                torch.nn.functional.embedding_bag(fl, s_, of, mode="sum")),
            nbytes=4 * n + 5 * n * f + 4 * self_rows * d + 8 * n * d))
        if bi == 0:
            continue
        g_n = torch.randn(n, d, generator=gen, device=dev)
        g_s = torch.randn(n, d, generator=gen, device=dev)
        rows_b = b.neigh_mask.nonzero(as_tuple=True)[0]
        cnt = b.neigh_mask.sum(1, keepdim=True).clamp(min=1).float()
        ex_mean = (g_n / cnt)[rows_b].contiguous()
        ex_sum = g_n[rows_b].contiguous()
        buf, buf_s, buf_n = (torch.zeros(s, d, device=dev) for _ in range(3))
        cases.append(dict(
            name=f"gather_reduce_bwd_mean[gcn block{bi}]", key="gather_reduce_bwd_mean",
            launches=launches_of("gcn", "gather_reduce_bwd_mean"),
            replaces=f"{PALLAS}:132 gather_mean_pallas (backward; JAX: autodiff of jnp.take)",
            shape=f"grad_out [{n}, {d}] pos/mask [{n}, {f}] -> [{s}, {d}]", tol="atomic",
            kernel=lambda g_=g_n, b_=b, s_=s: gk.gather_reduce_bwd(
                g_, b_.neigh_pos, b_.neigh_mask, s_, "mean"),
            plain=lambda g_=g_n, b_=b, s_=s: gk.gather_reduce_bwd_plain(
                g_, b_.neigh_pos, b_.neigh_mask, s_, "mean"),
            library=lambda bb=buf, fl=flat, ex=ex_mean: bb.index_add_(0, fl, ex),
            nbytes=5 * n * f + 4 * n * d + 4 * s * d))
        cases.append(dict(
            name=f"block_gather_bwd_sum[gin block{bi}]", key="block_gather_bwd_sum",
            launches=launches_of("gin", "block_gather_bwd_sum"),
            replaces=f"{PALLAS}:58 gather_rows_pallas + {PALLAS}:132 gather_mean_pallas "
                     "(backward of both; JAX: autodiff of jnp.take)",
            shape=f"g_self [{n}, {d}] self_pos [{n}], g_neigh [{n}, {d}] pos/mask "
                  f"[{n}, {f}] -> [{s}, {d}]",
            tol="atomic",
            kernel=lambda gs=g_s, g_=g_n, b_=b, s_=s: gk.block_gather_bwd(
                gs, b_.self_pos, g_, b_.neigh_pos, b_.neigh_mask, s_, "sum"),
            plain=lambda gs=g_s, g_=g_n, b_=b, s_=s: gk.block_gather_bwd_plain(
                gs, b_.self_pos, g_, b_.neigh_pos, b_.neigh_mask, s_, "sum"),
            library=lambda bs=buf_s, bn=buf_n, gs=g_s, ids=b.self_pos.long(), fl=flat,
            ex=ex_sum: (bs.index_add_(0, ids, gs), bn.index_add_(0, fl, ex)),
            nbytes=4 * n + 5 * n * f + 8 * n * d + 4 * s * d))
    # GAT block 0: one gather of [z | att_s | att_n] at the self rows and every
    # neighbor slot, and its cooperative scatter backward
    b0 = mb.blocks[0]
    width = 4 * 64 + 2 * 4
    table = torch.randn(srcs[0].shape[0], width, generator=gen, device=dev)
    ids = torch.cat([b0.self_pos, b0.neigh_pos.reshape(-1)])
    ids_l = ids.long()
    n_ids, s0 = ids.shape[0], table.shape[0]
    g_rows = torch.randn(n_ids, width, generator=gen, device=dev)
    sbuf = torch.zeros(s0, width, device=dev)
    cases.append(dict(
        name="gather_rows[gat block0 table]", key="gather_rows",
        launches=launches_of("gat", "gather_rows"),
        replaces=f"{PALLAS}:58 gather_rows_pallas",
        shape=f"src [{s0}, {width}] ids [{n_ids}]", tol="exact",
        kernel=lambda: gk.gather_rows(table, ids),
        plain=lambda: gk.gather_rows_plain(table, ids),
        library=lambda: torch.index_select(table, 0, ids_l),
        nbytes=4 * n_ids + 4 * distinct(ids) * width + 4 * n_ids * width))
    cases.append(dict(
        name="scatter_add_rows[gat block0 table]", key="scatter_add_rows",
        launches=launches_of("gat", "scatter_add_rows"),
        replaces=f"{PALLAS}:58 gather_rows_pallas (backward; JAX: autodiff of jnp.take)",
        shape=f"grad_out [{n_ids}, {width}] -> [{s0}, {width}]", tol="atomic",
        kernel=lambda: gk.scatter_add_rows(g_rows, ids, s0),
        plain=lambda: gk.scatter_add_rows_plain(g_rows, ids, s0),
        library=lambda: sbuf.index_add_(0, ids_l, g_rows),
        nbytes=4 * n_ids + 4 * n_ids * width + 4 * s0 * width))
    return cases


# -- cv_gcn: CV-GCN on both single-device paths ---------------------------------
CV_HOST_SCALE = 16                     # the graph where device logits meet the host's
CV_WINDOW_FANOUTS = (8, 64, 512, 4096)  # the refresh's window tables given kernel rows


def cv_config(pt, num_nodes: int, *, on_device: bool = False, compute: str = "float32"):
    """CV-GCN at the model families' shape: 2 layers (the second's input the
    skip's 512 columns), hidden 256, preprocess (layer 0 the store's ``gcn``
    aggregate of the 100-dim features), 2 sampled hops at fan-outs (15,
    10), batch 1024, dropout 0.5, Adam 1e-2, 47 classes; the host path's
    cache at 40% of the vertices, the device path's full (``scan``)."""
    return pt.Config(
        model=pt.ModelConfig(arch="gcn_cv", n_layers=2, hidden=256, feat_dim=100,
                             n_classes=47, dropout=0.5, preprocess=True),
        sampler=pt.SamplerConfig(batch_size=1024, fanouts=(15, 10), num_hops=2, seed=0,
                                 prefetch=3),
        cache=pt.CacheConfig(enabled=True,
                             capacity=None if on_device else int(num_nodes * 0.4)),
        train=pt.TrainConfig(lr=1e-2, warmup_epochs=1, on_device_sampling=on_device,
                             dtype=compute, epoch_dispatch="scan"))


def cv_host_launches(compute: str) -> dict:
    """A CV host step (2 blocks): the assembly, a ``gather_reduce`` (mean) a
    block and a ``gather_reduce_bwd`` a block (block 0's source depends on
    ``dense``), and at bf16 compute a ``grad_to_bf16`` a backward."""
    if compute == "bfloat16":
        return {"assemble_f32_to_bf16": 1, "gather_reduce_mean_bf16": 2,
                "gather_reduce_bwd_mean_bf16": 2, "grad_to_bf16": 2}
    return {"assemble_f32": 1, "gather_reduce_mean": 2, "gather_reduce_bwd_mean": 2}


def cv_state_equal(torch, a, b) -> bool:
    """Two on-device CV trainers' parameters, histories and aggregates
    equal to the bit."""
    return (all(torch.equal(p, q) for p, q in zip(a.state.model.parameters(),
                                                  b.state.model.parameters()))
            and all(torch.equal(x, y) for x, y in zip(
                a.cv_state.hist_views() + list(a.cv_state.aggs),
                b.cv_state.hist_views() + list(b.cv_state.aggs))))


def cv_eager_epochs(env, cfg, t_, n_epochs, save_after=None):
    """``n_epochs`` of ``t_`` (a fresh on-device CV Trainer) through the
    eager form of its epoch function; their mean losses.  ``save_after``:
    ``(ckpt_dir, epoch)``, a checkpoint with its ``.aux`` after that
    epoch."""
    runner = env.DeviceEpochRunner(cfg, t_.state, t_.epoch_inputs, t_.device_data(),
                                   cv=t_.cv_state)
    losses = []
    for e in range(n_epochs):
        t_.epoch_inputs.load(*t_.epoch_randomness(e, out=t_.epoch_inputs))
        v = runner().values()
        losses.append(v["loss_sum"] / max(v["steps"], 1))
        if save_after is not None and save_after[1] == e:
            env.save_checkpoint(save_after[0], "gcn_cv", e, t_.state, aux=t_._cv_aux())
    return losses


def cv_gcn(env):
    """CV-GCN through ``Trainer.from_dataset`` on the RMAT-20 graph with the
    2-hop teacher labels, the train set cut to its first
    :data:`FAMILY_TRAIN_VERTICES` vertices.  The host path 2 epochs at f32
    and 1 at bf16 compute, exact launches a step (:func:`cv_host_launches`),
    the ``"cv-refresh"`` seconds, the loss finite (whether it falls is
    reported: at this learning rate it rises in the JAX package too); the
    on-device path (``scan``) 2 epochs,
    epoch 0 eager and epoch 1 replayed, against a fresh Trainer's two eager
    epochs (losses, parameters, histories and aggregates bit-equal), one
    assembly a step and one ``gather_reduce`` (sum) a window table a history
    an epoch (the refresh), the refresh's device time; a resume with the
    ``.aux`` sidecar against the uninterrupted run, bit-equal (on RMAT-16,
    whose checkpoint holds 0.4 GB of histories, not RMAT-20's 6.4 GB);
    device against host logits on RMAT-16 within 1e-4 of each row's
    largest, and ``evaluate`` on RMAT-20.  Returns the phase's line, the
    kernel cases at CV's shapes and the failures."""
    torch, np, gk, pt = env.torch, env.np, env.gk, env.pt
    t_phase = time.perf_counter()
    ds = env.ds_nb
    train_ids = np.nonzero(ds.train_mask)[0][:FAMILY_TRAIN_VERTICES]
    cut = np.zeros_like(ds.train_mask)
    cut[train_ids] = True
    data = env.Dataset(ds.graph, ds.features, ds.labels, cut, ds.val_mask, ds.test_mask)
    n, out, bad = ds.num_nodes, {"train_vertices": len(train_ids)}, []
    t_host, out["host_f32"] = run_trainer(
        torch, gk, "cv host", lambda: env.Trainer.from_dataset(cv_config(pt, n), data, seed=0),
        2, cv_host_launches("float32"), must_fall=False)
    out["host_f32"]["cv_refresh_s"] = t_host.timers.total["cv-refresh"]
    out["host_f32"]["step_s"] = t_host.timers.total["step"]
    out["host_f32"]["caps"] = list(t_host.sampler.caps)
    t_bf, out["host_bf16"] = run_trainer(
        torch, gk, "cv host bf16", lambda: env.Trainer.from_dataset(
            cv_config(pt, n, compute="bfloat16"), data, seed=0), 1,
        cv_host_launches("bfloat16"))
    out["host_bf16"]["cv_refresh_s"] = t_bf.timers.total["cv-refresh"]
    del t_bf
    # the on-device path: epoch 1 replayed against a fresh Trainer's eager form
    cfg_d = cv_config(pt, n, on_device=True)
    probe = env.Trainer.from_dataset(cfg_d, data, seed=0)
    tables = len(probe.cv_state.windows.tables())
    del probe
    t_dev, out["device_scan"] = run_trainer(
        torch, gk, "cv on-device", lambda: env.Trainer.from_dataset(cfg_d, data, seed=0), 2,
        {"assemble_f32": 1}, {"gather_reduce_sum": 2 * tables}, must_fall=False)
    dev_counts = out["device_scan"]["launches"]
    out["device_scan"]["window_tables"] = [[lv, list(p.shape)] for lv, p, _ in
                                           t_dev.cv_state.windows.tables()]
    replayed = [m["mean_loss"] for m in out["device_scan"]["epochs"]]
    t_e = env.Trainer.from_dataset(cfg_d, data, seed=0)
    eager = cv_eager_epochs(env, cfg_d, t_e, 2)
    equal = replayed == eager and cv_state_equal(torch, t_dev, t_e)
    out["device_scan"]["eager_losses"] = eager
    out["device_scan"]["replay_bit_equal_to_eager"] = equal
    if not equal:
        bad.append(f"the on-device CV replay is not bit-equal to the eager form (losses "
                   f"{replayed} vs {eager})")
    del t_e
    gc.collect()
    torch.cuda.empty_cache()
    refresh = env.CapturedGraph(t_dev.cv_state.refresh)
    out["device_scan"]["refresh_device_ms"] = time_ms(torch, refresh, env.flush, iters=10,
                                                      warmup=2)
    del refresh
    # RMAT-16: the resume, and device against host logits
    g16 = env.CSRGraph.from_coo(env.synthetic.rmat_coo(CV_HOST_SCALE, 16, seed=42))
    x16 = np.random.default_rng(7).random((g16.num_nodes, 100), dtype=np.float32)
    ds16 = env.Dataset(g16, x16, env.synthetic.neighborhood_labels(g16, x16, 47, seed=1),
                       *env.synthetic.random_split_masks(g16.num_nodes, seed=11))
    cfg16 = cv_config(pt, g16.num_nodes, on_device=True)
    with tempfile.TemporaryDirectory() as ckpt:
        t_full = env.Trainer.from_dataset(cfg16, ds16, seed=0)
        full = cv_eager_epochs(env, cfg16, t_full, 2, save_after=(ckpt, 0))
        cfg_r = copy.deepcopy(cfg16)
        cfg_r.train.ckpt_dir = ckpt
        t_r = env.Trainer.from_dataset(cfg_r, ds16, seed=0)
        t0 = time.perf_counter()
        start = t_r.resume()
        resume_s = time.perf_counter() - t0
        aux_bytes = os.path.getsize(os.path.join(ckpt, "gcn_cv_0.aux"))
    m1 = t_r.run_epoch(start)
    resumed_equal = start == 1 and m1.mean_loss == full[1] and cv_state_equal(torch, t_r,
                                                                              t_full)
    out["resume"] = {"graph_vertices": g16.num_nodes, "aux_bytes": aux_bytes,
                     "resume_s": resume_s, "uninterrupted_losses": full,
                     "resumed_epoch1_loss": m1.mean_loss, "bit_equal": resumed_equal}
    if not resumed_equal:
        bad.append(f"the CV resume from epoch 0 is not the uninterrupted run (start {start}, "
                   f"loss {m1.mean_loss} vs {full[1]})")
    del t_full, t_r
    inf = {}
    model, mcfg = t_host.state.model, t_host.cfg.model
    gk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = env.full_graph_logits(model, mcfg, ds.graph, ds.features, backend="device")
    torch.cuda.synchronize()
    inf["rmat20_device_s"] = time.perf_counter() - t0
    inf["rmat20_device_launches"] = {k: v for k, v in gk.launch_counts().items() if v}
    if not (logits.shape == (n, 47) and np.isfinite(logits).all()):
        bad.append(f"cv device logits of shape {logits.shape}")
    if inf["rmat20_device_launches"].get("gather_reduce_sum", 0) <= 0:
        bad.append("cv device inference launched no gather_reduce_sum")
    inf["val_acc"] = env.evaluate(model, mcfg, ds.graph, ds.features, ds.labels, ds.val_mask,
                                  backend="device")
    both = {}
    for backend in ("host", "device"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        both[backend] = env.full_graph_logits(model, mcfg, g16, x16, backend=backend)
        inf[f"rmat{CV_HOST_SCALE}_{backend}_s"] = time.perf_counter() - t0
    scale = 1.0 + np.abs(both["host"]).max(axis=1, keepdims=True)
    inf["device_vs_host_max_row_rel_diff"] = float(
        (np.abs(both["device"] - both["host"]) / scale).max())
    if not inf["device_vs_host_max_row_rel_diff"] <= 1e-4:
        bad.append(f"cv device logits {inf['device_vs_host_max_row_rel_diff']} from the host's")
    out["inference"] = inf
    out["note"] = (f"trained on neighborhood_labels(graph, features, 47, seed=1), the first "
                   f"{FAMILY_TRAIN_VERTICES} train vertices; host f32 2 eager epochs (one "
                   "step a batch, no graphs), host bf16 1 epoch, on-device scan 2 epochs "
                   "(epoch 1 replayed) against the eager form; the resume on RMAT-16")
    out["seconds"] = time.perf_counter() - t_phase
    cases = cv_kernel_cases(env, t_host, t_dev, out, dev_counts, tables)
    return out, cases, bad


def cv_kernel_cases(env, t_host, t_dev, out, dev_counts, tables):
    """The kernel cases at CV's shapes: on one host batch of the f32 host
    trainer, ``gather_reduce`` (mean) and ``gather_reduce_bwd`` (mean) at
    each block (sources random at the widths 256 and 512, gradients
    random); and the refresh's window reductions, the on-device trainer's
    window tables at F in :data:`CV_WINDOW_FANOUTS` and the hub table, over
    its histories (widths 256 and 512).  Launches: the host f32 run's, and
    for a refresh table the on-device run's refreshes of it."""
    torch, gk, dev = env.torch, env.gk, env.dev
    mb = t_host.sampler.sample(t_host.sampler.train_nids[:1024]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    widths = (256, 512)
    srcs = [torch.randn(mb.layer_nids[i].shape[0], w, generator=gen, device=dev)
            for i, w in enumerate(widths)]
    host_launch = out["host_f32"]["launches"]
    cases = []

    def distinct(*idx):
        return int(torch.unique(torch.cat([i.reshape(-1) for i in idx])).numel())

    def flat_of(pos, mask):
        counts = mask.sum(1)
        offsets = torch.zeros_like(counts)
        offsets[1:] = torch.cumsum(counts, 0)[:-1]
        return pos[mask].long(), offsets.long()

    for bi, (b, src) in enumerate(zip(mb.blocks, srcs)):
        nr, f = b.neigh_pos.shape
        s, d = src.shape
        flat, offs = flat_of(b.neigh_pos, b.neigh_mask)
        cases.append(dict(
            name=f"gather_reduce_mean[cv block{bi}]", key="gather_reduce_mean",
            launches=host_launch["gather_reduce_mean"],
            replaces=f"{PALLAS}:132 gather_mean_pallas",
            shape=f"src {list(src.shape)} pos/mask [{nr}, {f}]", tol="reduce",
            kernel=lambda s_=src, b_=b: gk.gather_reduce(s_, b_.neigh_pos, b_.neigh_mask,
                                                          "mean"),
            plain=lambda s_=src, b_=b: gk.gather_reduce_plain(s_, b_.neigh_pos,
                                                               b_.neigh_mask, "mean"),
            library=lambda s_=src, fl=flat, of=offs: torch.nn.functional.embedding_bag(
                fl, s_, of, mode="mean"),
            nbytes=5 * nr * f + 4 * distinct(b.neigh_pos[b.neigh_mask]) * d + 4 * nr * d))
        g_n = torch.randn(nr, d, generator=gen, device=dev)
        rows_b = b.neigh_mask.nonzero(as_tuple=True)[0]
        cnt = b.neigh_mask.sum(1, keepdim=True).clamp(min=1).float()
        ex = (g_n / cnt)[rows_b].contiguous()
        buf = torch.zeros(s, d, device=dev)
        cases.append(dict(
            name=f"gather_reduce_bwd_mean[cv block{bi}]", key="gather_reduce_bwd_mean",
            launches=host_launch["gather_reduce_bwd_mean"],
            replaces=f"{PALLAS}:132 gather_mean_pallas (backward; JAX: autodiff of jnp.take)",
            shape=f"grad_out [{nr}, {d}] pos/mask [{nr}, {f}] -> [{s}, {d}]", tol="atomic",
            kernel=lambda g_=g_n, b_=b, s_=s: gk.gather_reduce_bwd(
                g_, b_.neigh_pos, b_.neigh_mask, s_, "mean"),
            plain=lambda g_=g_n, b_=b, s_=s: gk.gather_reduce_bwd_plain(
                g_, b_.neigh_pos, b_.neigh_mask, s_, "mean"),
            library=lambda bb=buf, fl=flat, e_=ex: bb.index_add_(0, fl, e_),
            nbytes=5 * nr * f + 4 * nr * d + 4 * s * d))
    # the refresh: each table is reduced once a history an epoch
    per_table = dev_counts["gather_reduce_sum"] // (2 * tables)
    win = {p.shape[1]: (p, m) for lv, p, m in t_dev.cv_state.windows.tables()
           if lv == "bucket"}
    hubs = [(p, m) for lv, p, m in t_dev.cv_state.windows.tables() if lv == "hubs"]
    picked = [(f"F={wf}", win[wf]) for wf in CV_WINDOW_FANOUTS if wf in win]
    picked += [("hubs F=4096", hubs[0])] if hubs else []
    for h in t_dev.cv_state.hist_views():
        for label, (pos, mask) in picked:
            rows_w, wf, dw = pos.shape[0], pos.shape[1], h.shape[1]
            flat, offs = flat_of(pos, mask)
            cases.append(dict(
                name=f"window_reduce[sum, cv refresh {label}, D={dw}]",
                key="gather_reduce_sum", launches=per_table,
                replaces=f"{PALLAS}:132 gather_mean_pallas (the CV refresh's window "
                         "reduction, pagraph_tpu/train/device_epoch.py:1236 "
                         "bucketed_aggregate)",
                shape=f"src {list(h.shape)} pos/mask [{rows_w}, {wf}] "
                      f"({int(mask.sum())} valid slots), plan "
                      f"{gk.window_plan(rows_w, wf, dw, True)}",
                tol=max(TOLERANCES["reduce"], wf * 2.0 ** -24),
                kernel=lambda x_=h, p_=pos, m_=mask: gk.gather_reduce(x_, p_, m_, "sum"),
                plain=lambda x_=h, p_=pos, m_=mask: gk.gather_reduce_plain(x_, p_, m_, "sum"),
                library=lambda x_=h, fl=flat, of=offs: torch.nn.functional.embedding_bag(
                    fl, x_, of, mode="sum"),
                nbytes=5 * rows_w * wf + 4 * distinct(pos[mask]) * dw + 4 * rows_w * dw))
    return cases


# -- partition: PaGraph's partition pipeline and Trainer.from_partition ---------
PARTITION_PARTS, PARTITION_HOPS = 4, 2
PARTITION_CUT = FAMILY_TRAIN_VERTICES   # the train vertices when the whole set is too slow
DG_WHOLE_LIMIT_S = 20.0                 # the native dg stream's budget for the whole set
DG_PROBE = 8192                         # train vertices the estimate is timed on


def partition_phase(env):
    """RMAT-20's train set into 4 parts at 2 hops with ``dg_partition``
    (native) and ``hash_partition``: seconds and ``partition_stats`` of
    each (vertices a part, the replication factor, train vertices a part).
    The native dg stream is timed on :data:`DG_PROBE` train vertices
    spread evenly over the set first; if the whole set would take over
    :data:`DG_WHOLE_LIMIT_S` seconds at that rate, both partitioners take
    the first :data:`PARTITION_CUT` train vertices (the line says which).
    Then the native ``dg_assign`` against the numpy one on RMAT-14 (equal),
    a ``save_partition``/``load_partition`` round trip of dg's part 0, and
    part 0 through ``Trainer.from_partition`` at the ``bench.py`` GraphSAGE
    shape over the full store: the host path (cache at 40% of the part's
    vertices) 2 epochs, 4 launches a step; the on-device path 2 epochs,
    epoch 1 replayed, bit-equal to a fresh Trainer's eager form."""
    torch, np, gk, pt = env.torch, env.np, env.gk, env.pt
    part_mod, fmt = env.partition, env.formats
    t_phase = time.perf_counter()
    ds, bad = env.ds, []
    graph = ds.graph
    train = ds.train_nids
    # the probe: train vertices spread over the stream (its first ones are
    # RMAT's hubs and their neighbors, the costliest to expand)
    t0 = time.perf_counter()
    part_mod.dg_assign(graph, train[::max(1, len(train) // DG_PROBE)][:DG_PROBE],
                       PARTITION_PARTS, PARTITION_HOPS, backend="native")
    probe_s = time.perf_counter() - t0
    predicted = probe_s * len(train) / DG_PROBE
    out = {"graph": {"vertices": graph.num_nodes, "edges": graph.num_edges},
           "train_vertices_all": len(train), "dg_probe_s": probe_s,
           "dg_probe_vertices": DG_PROBE, "dg_whole_predicted_s": predicted}
    if predicted > DG_WHOLE_LIMIT_S:
        train = train[:PARTITION_CUT]
        out["cut"] = (f"the first {min(PARTITION_CUT, len(train))} train vertices: the native "
                      "dg stream over "
                      f"all {len(ds.train_nids)} was predicted at {predicted:.1f} s "
                      f"(> {DG_WHOLE_LIMIT_S} s)")
    out["train_vertices"] = len(train)
    parts = {}
    for method, fn in (("dg", lambda: part_mod.dg_partition(
            graph, train, ds.labels, PARTITION_PARTS, PARTITION_HOPS, backend="native")),
                       ("hash", lambda: part_mod.hash_partition(
                           graph, train, ds.labels, PARTITION_PARTS, PARTITION_HOPS))):
        t0 = time.perf_counter()
        parts[method] = fn()
        stats = part_mod.partition_stats(parts[method], graph.num_nodes)
        tpp = stats["train_per_part"]
        stats["train_balance_max_over_mean"] = max(tpp) / (sum(tpp) / len(tpp))
        out[method] = {"seconds": time.perf_counter() - t0, **stats}
        covered = np.sort(np.concatenate([p.local2full[p.train_nids]
                                          for p in parts[method]]))
        if not np.array_equal(covered, np.sort(train)):
            bad.append(f"{method}: the parts' train vertices are not the train set")
    g14 = env.CSRGraph.from_coo(env.synthetic.rmat_coo(14, 16, seed=42))
    t14 = np.nonzero(env.synthetic.random_split_masks(g14.num_nodes, seed=11)[0])[0]
    t0 = time.perf_counter()
    a14 = part_mod.dg_assign(g14, t14, PARTITION_PARTS, PARTITION_HOPS, backend="numpy")
    numpy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b14 = part_mod.dg_assign(g14, t14, PARTITION_PARTS, PARTITION_HOPS, backend="native")
    out["rmat14_dg"] = {"train_vertices": len(t14), "numpy_s": numpy_s,
                        "native_s": time.perf_counter() - t0,
                        "native_equals_numpy": bool(np.array_equal(a14, b14))}
    if not out["rmat14_dg"]["native_equals_numpy"]:
        bad.append("RMAT-14: the native dg_assign differs from the numpy one")
    with tempfile.TemporaryDirectory() as root:
        d = fmt.partition_dir(root, PARTITION_PARTS, "dg")
        t0 = time.perf_counter()
        fmt.save_partition(d, 0, parts["dg"][0])
        back = [fmt.load_partition(d, 0)]
        fields = [("graph", k) for k in ("indptr", "indices", "out_degrees")] + [
            (None, k) for k in ("train_nids", "local2full", "labels")]
        same = all(np.array_equal(getattr(getattr(a, o) if o else a, k),
                                  getattr(getattr(b, o) if o else b, k))
                   for a, b in zip(back, parts["dg"]) for o, k in fields)
        out["round_trip"] = {"seconds": time.perf_counter() - t0, "equal": same}
    if not same:
        bad.append("save_partition/load_partition changed a dg part")
    # part 0 through Trainer.from_partition over the full store
    part = parts["dg"][0]
    store = env.FeatureStore.build(graph, ds.features)
    cfg_h = env.config("mean")
    cfg_h.cache.capacity = int(part.num_nodes * 0.4)
    t_h, out["part0_host"] = run_trainer(
        torch, gk, "partition host", lambda: env.Trainer.from_partition(cfg_h, part, store,
                                                                        seed=0), 2,
        {"assemble_f32": 1, "block_gather_fwd_mean": 2, "block_gather_bwd_mean": 1})
    out["part0_host"]["part_vertices"] = part.num_nodes
    out["part0_host"]["cache_capacity"] = t_h.cache.capacity
    del t_h
    cfg_d = env.config("mean", on_device=True)
    t_d, out["part0_device"] = run_trainer(
        torch, gk, "partition on-device", lambda: env.Trainer.from_partition(
            cfg_d, part, store, seed=0), 2, DEVICE_STEP)
    replayed = [m["mean_loss"] for m in out["part0_device"]["epochs"]]
    t_e = env.Trainer.from_partition(cfg_d, part, store, seed=0)
    runner = env.DeviceEpochRunner(cfg_d, t_e.state, t_e.epoch_inputs, t_e.device_data())
    eager = []
    for e in range(2):
        t_e.epoch_inputs.load(*t_e.epoch_randomness(e, out=t_e.epoch_inputs))
        v = runner().values()
        eager.append(v["loss_sum"] / max(v["steps"], 1))
    equal = replayed == eager and all(torch.equal(p, q) for p, q in zip(
        t_d.state.model.parameters(), t_e.state.model.parameters()))
    out["part0_device"]["eager_losses"] = eager
    out["part0_device"]["replay_bit_equal_to_eager"] = equal
    if not equal:
        bad.append(f"partition: the on-device replay is not bit-equal to the eager form "
                   f"({replayed} vs {eager})")
    out["seconds"] = time.perf_counter() - t_phase
    return out, bad


# -- dp: data-parallel training, one process a rank -----------------------------
DP_DEVICE_EPOCHS = 3                    # (b): epoch 0 eager, then two replays
DP_RANKS = 2                            # (c): gloo ranks sharing the one card
DP_CACHE_SHARE = 0.4
# (a) at f32: two single-device eager runs of 2 epochs differ by up to 2.6e-6
# of the loss and 6.1e-4 of a parameter's max|p| on an H100 (the block
# backward's atomics add in their own order, and Adam carries it on), so the
# dp run is held well above that and well below what a wrong batch or a
# wrong gradient moves (the loss by 1e-2 and more)
DP_F32_LOSS_TOL = 1e-4
DP_F32_PARAM_TOL = 1e-2


def dp_config(pt, num_nodes: int, *, on_device: bool = False, compute: str = "float32",
              dropout: float = 0.0, capacity=None):
    """The main path's shape (``bench.py``'s GraphSAGE mean) for the dp
    phase: the cache at 40% of ``num_nodes`` unless ``capacity`` is given,
    full on the device path."""
    return pt.Config(
        model=pt.ModelConfig(arch="graphsage", n_layers=1, hidden=16, feat_dim=100,
                             n_classes=47, aggregator="mean", dropout=dropout),
        sampler=pt.SamplerConfig(batch_size=6000, fanout=2, num_hops=2, seed=0, prefetch=3),
        cache=pt.CacheConfig(capacity=None if on_device else (
            capacity if capacity is not None else int(num_nodes * DP_CACHE_SHARE))),
        train=pt.TrainConfig(lr=1e-2, warmup_epochs=1, on_device_sampling=on_device,
                             dtype=compute))


DP_ARRAYS = ("indptr", "indices", "out_degrees", "features", "labels", "train_mask",
             "val_mask", "test_mask")


def dp_save_dataset(np, ds, root: str) -> None:
    """The dataset's arrays, for the ranks to load (``dp_load_dataset``)."""
    g = ds.graph
    for name, arr in (("indptr", g.indptr), ("indices", g.indices),
                      ("out_degrees", g.out_degrees), ("features", ds.features),
                      ("labels", ds.labels), ("train_mask", ds.train_mask),
                      ("val_mask", ds.val_mask), ("test_mask", ds.test_mask)):
        np.save(os.path.join(root, name + ".npy"), arr)


def dp_load_dataset(root: str):
    import numpy as np

    from pagraph_tpu_torch.data.formats import Dataset
    from pagraph_tpu_torch.graph import CSRGraph

    a = {k: np.load(os.path.join(root, k + ".npy")) for k in DP_ARRAYS}
    return Dataset(CSRGraph(a["indptr"], a["indices"], a["out_degrees"]), a["features"],
                   a["labels"], a["train_mask"], a["val_mask"], a["test_mask"])


def dp_syncs_run(tr, steps_of, calls=None) -> int:
    """Gradient all-reduces run (or, given ``calls``, the Python calls of
    another collective made once a step, such as the halo exchange): the
    eager calls, with each graph's steps times its replays in place of its
    capture's (``executed_launches``)."""
    calls = tr.grad_sync.calls if calls is None else calls
    runner = tr.epoch_runner if tr._device_mode else tr.group_graphs
    if runner is not None:
        for k, g in zip(steps_of(runner), runner.graphs):
            calls += k * (g.replays - 1)
    return calls


def dp_run(torch, gk, tr, epochs, start=0):
    """``epochs`` epochs of a dp trainer from ``start``: the epoch rows, the
    gather launches and gradient all-reduces run a step, peak device bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gk.reset_launch_counts()
    calls0 = tr.grad_sync.calls
    ex = tr.exchange
    ex0 = ex.calls if ex is not None else 0
    ms = [tr.run_epoch(e) for e in range(start, start + epochs)]
    torch.cuda.synchronize()
    runner = tr.epoch_runner if tr._device_mode else tr.group_graphs
    counts = {k: v for k, v in executed_launches(gk.launch_counts(), runner).items() if v}
    steps = sum(m.num_batches for m in ms)
    steps_of = ((lambda r: [tr.epoch_inputs.num_batches] * len(r.graphs)) if tr._device_mode
                else (lambda r: [k for k, _ in r.keys]))
    syncs = dp_syncs_run(tr, steps_of) - calls0
    out = {"epochs": epoch_rows(ms), "launches": counts,
           "launches_per_step": sum(counts.values()) / steps,
           "all_reduces_per_step": syncs / steps,
           "capture_s": tr.timers.total["capture"],
           "peak_device_bytes": torch.cuda.max_memory_allocated() - base}
    if ex is not None:
        # two all_to_all_single an exchange; the halo drops of every rank
        out.update(all_to_alls_per_step=2 * (dp_syncs_run(tr, steps_of, ex.calls) - ex0) / steps,
                   halo_drops=[m.halo_drops for m in ms], halo_width=tr.halo_width,
                   halo_bytes_per_step=ex.bytes_per_step, shard_bytes=tr.shard.nbytes)
    return ms, out


def dp_params(tr):
    return {k: v.detach().clone() for k, v in tr.state.model.state_dict().items()}


def dp_max_diff(a, b) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def dp_rel_diffs(losses, params, ref_losses, ref_params):
    """The largest loss difference relative to the reference loss, and the
    largest parameter difference relative to that parameter's max|ref|."""
    return (max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, ref_losses)),
            max(float((params[k].float() - v.float()).abs().max())
                / max(float(v.float().abs().max()), 1e-30) for k, v in ref_params.items()))


def dp_rank_world1(rank, world, root, out_path) -> None:
    """A world-size-1 ``nccl`` rank: (a) the host path at the main path's
    shape (epoch 1 replayed from the host-step graphs, the all-reduces
    inside) against the single-device Trainer's eager form from the same
    seed (bf16 and f32 compute; at f32 beside the spread of two single
    runs);
    (b) the on-device path, epoch 0 eager and then replayed from the CUDA
    graph with the NCCL all-reduce inside, against its eager form from
    epoch 0's checkpoint.  Writes the results as JSON to ``out_path``."""
    import gc

    import numpy as np
    import torch

    import pagraph_tpu_torch as pt
    from pagraph_tpu_torch.data.formats import PartitionArtifact
    from pagraph_tpu_torch.ops import gather_kernels as gk
    from pagraph_tpu_torch.parallel import DataParallelTrainer
    from pagraph_tpu_torch.storage.feature_store import FeatureStore
    from pagraph_tpu_torch.train.loop import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    ds = dp_load_dataset(root)
    n = ds.num_nodes
    store = FeatureStore.build(ds.graph, ds.features)
    whole = PartitionArtifact(ds.graph, ds.train_nids, np.arange(n, dtype=np.int64),
                              ds.labels)
    out = {"backend": torch.distributed.get_backend(), "world_size": world}

    def single(cfg):
        t_ = Trainer(cfg, store, ds.graph, ds.train_nids, ds.labels, seed=0)
        t_.host_graphs = False
        ms = [t_.run_epoch(e) for e in range(2)]
        return [m.mean_loss for m in ms], dp_params(t_)

    for compute in ("bfloat16", "float32"):
        cfg = dp_config(pt, n, compute=compute)
        t0 = time.perf_counter()
        dp = DataParallelTrainer(cfg, store, whole, seed=0)
        dp._maybe_fill_cache()
        setup = time.perf_counter() - t0
        ms, row = dp_run(torch, gk, dp, 2)
        row["setup_s"] = setup
        row["graphs"] = len(dp.group_graphs.graphs) if dp.group_graphs else 0
        losses, params = [m.mean_loss for m in ms], dp_params(dp)
        del dp
        gc.collect()
        torch.cuda.empty_cache()
        s_losses, s_params = single(cfg)
        row["losses"], row["single_losses"] = losses, s_losses
        row["bit_equal_to_single"] = losses == s_losses and all(
            torch.equal(params[k], s_params[k]) for k in params)
        row["max_param_diff_to_single"] = dp_max_diff(params, s_params)
        if compute == "float32":
            # two single-device eager runs differ at f32 (the block
            # backward's atomics add in their own order): their spread
            s2_losses, s2_params = single(cfg)
            row["rel_diff_to_single"] = dp_rel_diffs(losses, params, s_losses, s_params)
            row["single_rel_spread"] = dp_rel_diffs(s2_losses, s2_params, s_losses, s_params)
        out[f"host_{compute}"] = row
        gc.collect()
        torch.cuda.empty_cache()

    cfg = dp_config(pt, n, on_device=True)
    with tempfile.TemporaryDirectory() as ck:
        cfg.train.ckpt_dir = ck
        t0 = time.perf_counter()
        dp = DataParallelTrainer(cfg, store, whole, seed=0)
        dp._maybe_fill_cache()
        setup = time.perf_counter() - t0
        ms0, _ = dp_run(torch, gk, dp, 1)
        dp._checkpoint(0)
        ms, row = dp_run(torch, gk, dp, DP_DEVICE_EPOCHS - 1, start=1)
        runner = dp.epoch_runner
        row.update(setup_s=setup, eager_epoch=epoch_rows(ms0)[0],
                   graph_replays=[g.replays for g in runner.graphs] if runner.graph else [])
        losses, params = [m.mean_loss for m in ms], dp_params(dp)
        del dp, runner
        gc.collect()
        torch.cuda.empty_cache()
        eager = DataParallelTrainer(cfg, store, whole, seed=0)
        eager.device_graphs = False
        start = eager.resume(0)
        e_ms = [eager.run_epoch(e) for e in range(start, DP_DEVICE_EPOCHS)]
        row["losses"], row["eager_losses"] = losses, [m.mean_loss for m in e_ms]
        row["replay_bit_equal_to_eager"] = row["losses"] == row["eager_losses"] and all(
            torch.equal(params[k], v) for k, v in dp_params(eager).items())
        row["max_param_diff_to_eager"] = dp_max_diff(params, dp_params(eager))
    out["device"] = row
    with open(out_path, "w") as f:
        json.dump(out, f)


def dp_rank_shared(rank, world, root, part_dir, capacity, out_dir) -> None:
    """A gloo rank of several on one card: its partition from ``part_dir``,
    the host path (the cache at ``capacity``) and then the on-device path,
    each 2 epochs at dropout 0.2; the parameters after each epoch to
    ``out_dir``, and this rank's numbers as JSON."""
    import gc

    import torch

    import pagraph_tpu_torch as pt
    from pagraph_tpu_torch.ops import gather_kernels as gk
    from pagraph_tpu_torch.parallel import DataParallelTrainer
    from pagraph_tpu_torch.storage.feature_store import FeatureStore

    torch.backends.cuda.matmul.allow_tf32 = False
    ds = dp_load_dataset(root)
    store = FeatureStore.build(ds.graph, ds.features)
    out = {"rank": rank, "backend": torch.distributed.get_backend(), "world_size": world}
    for path, cfg in (("host", dp_config(pt, 0, dropout=0.2, capacity=capacity)),
                      ("device", dp_config(pt, 0, on_device=True, dropout=0.2))):
        t0 = time.perf_counter()
        tr = DataParallelTrainer.from_partition_dir(cfg, part_dir, store, seed=0)
        tr._maybe_fill_cache()
        setup = time.perf_counter() - t0
        rows = []
        for e in range(2):
            m, row = dp_run(torch, gk, tr, 1, start=e)
            row.update(row.pop("epochs")[0])
            if path == "host":
                row["own_miss_rate"] = tr.cache.miss_rate()
                row["own_edges_per_s"] = tr.loader.epoch_edges / m[0].time_s
            rows.append(row)
            torch.save(dp_params(tr), os.path.join(out_dir, f"{path}_e{e}_rank{rank}.pt"))
        own = -(-len(tr.part.train_nids) // cfg.sampler.batch_size)
        out[path] = {"setup_s": setup, "epochs": rows, "lockstep_steps": tr.steps,
                     "own_batches": own, "part_vertices": tr.part.num_nodes,
                     "part_train_vertices": len(tr.part.train_nids),
                     "cache_capacity": tr.cache.capacity,
                     "graphs": bool(tr.epoch_runner.graph if tr._device_mode
                                    else tr.group_graphs)}
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def dp_parts(env, root: str, world: int):
    """RMAT-20's train set hash-partitioned ``world`` ways at 2 hops, saved
    under ``root`` for the ranks (once: a second call reuses them):
    ``(directory, parts)``."""
    ds = env.ds
    part_dir = os.path.join(root, f"parts{world}")
    if getattr(env, "parts", {}).get(world) is None:
        parts = env.partition.hash_partition(ds.graph, ds.train_nids, ds.labels, world, 2)
        for r, p in enumerate(parts):
            env.formats.save_partition(part_dir, r, p)
        env.parts = {**getattr(env, "parts", {}), world: parts}
    return part_dir, env.parts[world]


def dp_ranks(env, root: str, world: int, backend: str, label: str):
    """``world`` ranks on ``backend`` over RMAT-20's train set
    hash-partitioned at 2 hops (saved under ``root``, beside the dataset
    ``dp_save_dataset`` wrote there; each rank loads its own part), through
    :func:`dp_rank_shared`: the rows and the failed checks (each prefixed
    ``label``): one lockstep step count, the largest of the ranks' own;
    exactly 4 gather launches a host step and 4 a device step and one
    all-reduce a step on every rank; CUDA graphs under ``nccl`` and none
    under gloo; the ranks' parameters bit-equal after every epoch; the host
    loss falling."""
    torch, bad = env.torch, []
    from pagraph_tpu_torch.parallel import spawn_local

    t0 = time.perf_counter()
    part_dir, parts = dp_parts(env, root, world)
    capacity = int(DP_CACHE_SHARE * max(p.num_nodes for p in parts))
    out = {"world_size": world, "backend": backend, "capacity": capacity,
           "partition_and_save_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    spawn_local(dp_rank_shared, world, root, part_dir, capacity, root, backend=backend,
                timeout=600)
    out["ranks_s"] = time.perf_counter() - t0
    ranks = []
    for r in range(world):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    out["ranks"] = ranks
    for path, per_step in (("host", {"assemble_f32": 1, "block_gather_fwd_mean": 2,
                                     "block_gather_bwd_mean": 1}),
                           ("device", DEVICE_STEP)):
        rows = [rk[path] for rk in ranks]
        lock = {rk["lockstep_steps"] for rk in rows}
        if lock != {max(rk["own_batches"] for rk in rows)}:
            bad.append(f"{label} {path}: lockstep steps {lock}, own batches "
                       f"{[rk['own_batches'] for rk in rows]}")
        if any(rk["graphs"] != (backend == "nccl") for rk in rows):
            bad.append(f"{label} {path}: graphs {[rk['graphs'] for rk in rows]} on {backend}")
        for rk in rows:
            for e in rk["epochs"]:
                want = {k: v * e["batches"] for k, v in per_step.items()}
                if e["launches"] != want or e["all_reduces_per_step"] != 1:
                    bad.append(f"{label} {path}: launches {e['launches']}, "
                               f"{e['all_reduces_per_step']} all-reduces a step")
        equal = []
        for e in range(2):
            ps = [torch.load(os.path.join(root, f"{path}_e{e}_rank{r}.pt"), map_location="cpu")
                  for r in range(world)]
            equal.append(all(torch.equal(ps[0][k], q[k]) for q in ps[1:] for k in ps[0]))
        out[f"{path}_replicas_bit_equal"] = equal
        if not all(equal):
            bad.append(f"{label} {path}: the ranks' parameters differ after an epoch: {equal}")
    host_losses = [e["mean_loss"] for e in ranks[0]["host"]["epochs"]]
    out["host_loss_falls"] = host_losses[1] < host_losses[0]
    if not out["host_loss_falls"]:
        bad.append(f"{label} the host loss did not fall: {host_losses}")
    return out, bad


def dp_phase(env, root: str):
    """Data-parallel training through ``pagraph_tpu_torch.parallel``, the
    ranks spawned from here (``spawn_local``, the ``spawn`` method), the
    dataset and the partitions saved under ``root``: (a) and
    (b) in one ``nccl`` rank (:func:`dp_rank_world1`); (c) :data:`DP_RANKS`
    gloo ranks on the one card over RMAT-20's train set hash-partitioned
    at 2 hops and saved here (:func:`dp_rank_shared`).  Fails unless (a)
    at bf16 compute is bit-equal to the single-device eager run (at f32,
    where two single runs differ by the block backward's atomics, within
    :data:`DP_F32_LOSS_TOL` of the loss and :data:`DP_F32_PARAM_TOL` of
    each parameter's max|p|), (b)'s replay is
    bit-equal to its eager form, every rank ran 4 gather launches and one
    all-reduce a host step (5 at bf16 compute) and 1 and one a device step,
    (c)'s ranks ran one lockstep step count, the largest of their own, with
    bit-equal parameters after every epoch, and the host loss falls."""
    np = env.np
    from pagraph_tpu_torch.parallel import spawn_local

    t_phase = time.perf_counter()
    ds, bad, out = env.ds, [], {}
    t0 = time.perf_counter()
    dp_save_dataset(np, ds, root)
    out["save_dataset_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spawn_local(dp_rank_world1, 1, root, os.path.join(root, "w1.json"),
                backend="nccl", timeout=600)
    out["world1_s"] = time.perf_counter() - t0
    with open(os.path.join(root, "w1.json")) as f:
        w1 = json.load(f)
    out["world1"] = w1
    for compute, per_step in (("bfloat16", {"assemble_f32_to_bf16": 1,
                                            "block_gather_fwd_mean_bf16": 2,
                                            "block_gather_bwd_mean_bf16": 1,
                                            "grad_to_bf16": 1}),
                              ("float32", {"assemble_f32": 1, "block_gather_fwd_mean": 2,
                                           "block_gather_bwd_mean": 1})):
        row = w1[f"host_{compute}"]
        steps = sum(e["batches"] for e in row["epochs"])
        if row["launches"] != {k: v * steps for k, v in per_step.items()}:
            bad.append(f"(a) {compute}: launches {row['launches']} over {steps} steps, "
                       f"expected {per_step} a step")
        if row["all_reduces_per_step"] != 1:
            bad.append(f"(a) {compute}: {row['all_reduces_per_step']} all-reduces a step")
    if not w1["host_bfloat16"]["bit_equal_to_single"]:
        bad.append("(a) bf16: the dp run is not bit-equal to the single-device eager run")
    d_loss, d_par = w1["host_float32"]["rel_diff_to_single"]
    if not (d_loss <= DP_F32_LOSS_TOL and d_par <= DP_F32_PARAM_TOL):
        bad.append(f"(a) f32: the dp run differs from the single-device run by {d_loss} "
                   f"(loss, relative) and {d_par} (parameters, of max|p|), over "
                   f"{DP_F32_LOSS_TOL} and {DP_F32_PARAM_TOL}")
    dev = w1["device"]
    steps = sum(e["batches"] for e in dev["epochs"])
    if (dev["launches"] != {k: v * steps for k, v in DEVICE_STEP_NO_DROPOUT.items()}
            or dev["all_reduces_per_step"] != 1):
        bad.append(f"(b) launches {dev['launches']} and {dev['all_reduces_per_step']} "
                   f"all-reduces a step over {steps} steps")
    if dev["graph_replays"] != [DP_DEVICE_EPOCHS - 1]:
        bad.append(f"(b) the epoch graph replayed {dev['graph_replays']} times")
    if not dev["replay_bit_equal_to_eager"]:
        bad.append("(b) the replayed epochs are not bit-equal to their eager form")

    # (c): two gloo ranks on the one card
    out["shared"], more = dp_ranks(env, root, DP_RANKS, "gloo", "(c)")
    bad.extend(more)
    out["seconds"] = time.perf_counter() - t_phase
    return out, bad


# -- halo: the halo feature sources, features sharded across the ranks ---------
HALO_DEVICE_EPOCHS = 3                  # (a): epoch 0 eager, then two replays
HALO_RANKS = 2                          # (b): gloo ranks sharing the one card
# (b), (c): host epochs (0 eager, 1 replayed where graphs are), device
# epochs (0 eager, 1 the first replay, which waits for every rank's
# capture, 2 a replay with every rank in step: the one whose time is clean)
HALO_SHARED_EPOCHS = {"ici_host": 2, "ici_device": 3, "edge_device": 3}
HALO_HOST_STEP = {"float32": {"assemble_f32": 1, "block_gather_fwd_mean": 2,
                              "block_gather_bwd_mean": 1},
                  "bfloat16": {"assemble_f32_to_bf16": 1, "block_gather_fwd_mean_bf16": 2,
                               "block_gather_bwd_mean_bf16": 1, "grad_to_bf16": 1}}


def halo_check_collectives(row, label, per_step, bad) -> None:
    """Exactly ``per_step`` gather launches, 1 all-reduce and 2 all_to_all
    a step, and no halo request dropped."""
    steps = sum(e["batches"] for e in row["epochs"])
    if row["launches"] != {k: v * steps for k, v in per_step.items()}:
        bad.append(f"{label}: launches {row['launches']} over {steps} steps, expected "
                   f"{per_step} a step")
    if row["all_reduces_per_step"] != 1 or row["all_to_alls_per_step"] != 2:
        bad.append(f"{label}: {row['all_reduces_per_step']} all-reduces and "
                   f"{row['all_to_alls_per_step']} all_to_all a step, expected 1 and 2")
    if any(row["halo_drops"]):
        bad.append(f"{label}: halo drops {row['halo_drops']}")


def halo_rank_world1(rank, world, root, out_path) -> None:
    """A world-size-1 ``nccl`` rank of the halo phase, its features one
    shard: (a) ``ici`` on the host path (epoch 1 replayed from the host-step
    graphs, the all_to_alls and the all-reduce inside) against the
    ``cache`` source's run from the same seed, at bf16 and f32 compute;
    the ``edge`` device epoch at bf16 compute (epoch 0 eager, then replayed
    from one CUDA graph) against its eager form from epoch 0's checkpoint,
    against the ``cache`` source's device epoch and against itself with
    ``train.halo_pipeline``.  Writes the results as JSON to ``out_path``."""
    import gc

    import numpy as np
    import torch

    import pagraph_tpu_torch as pt
    from pagraph_tpu_torch.data.formats import PartitionArtifact
    from pagraph_tpu_torch.ops import gather_kernels as gk
    from pagraph_tpu_torch.parallel import DataParallelTrainer
    from pagraph_tpu_torch.storage.feature_store import FeatureStore

    torch.backends.cuda.matmul.allow_tf32 = False
    ds = dp_load_dataset(root)
    n = ds.num_nodes
    store = FeatureStore.build(ds.graph, ds.features)
    whole = PartitionArtifact(ds.graph, ds.train_nids, np.arange(n, dtype=np.int64),
                              ds.labels)
    out = {"backend": torch.distributed.get_backend(), "world_size": world}

    def run(cfg, source, epochs, start=0, tr=None):
        t0 = time.perf_counter()
        if tr is None:
            tr = DataParallelTrainer(cfg, store, whole, seed=0, feature_source=source)
            tr._maybe_fill_cache()
        setup = time.perf_counter() - t0
        ms, row = dp_run(torch, gk, tr, epochs, start=start)
        row["setup_s"] = setup
        return tr, [m.mean_loss for m in ms], row

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    for compute in ("bfloat16", "float32"):
        cfg = dp_config(pt, n, compute=compute)
        tr, losses, row = run(cfg, "ici", 2)
        row["graphs"] = len(tr.group_graphs.graphs) if tr.group_graphs else 0
        params = dp_params(tr)
        del tr
        release()
        tr, c_losses, c_row = run(cfg, "cache", 2)
        c_params = dp_params(tr)
        del tr
        release()
        row.update(losses=losses, cache_losses=c_losses,
                   cache_epochs=c_row["epochs"],
                   bit_equal_to_cache=losses == c_losses and all(
                       torch.equal(params[k], c_params[k]) for k in params),
                   rel_diff_to_cache=dp_rel_diffs(losses, params, c_losses, c_params))
        out[f"ici_host_{compute}"] = row

    cfg = dp_config(pt, n, on_device=True, compute="bfloat16")
    with tempfile.TemporaryDirectory() as ck:
        cfg.train.ckpt_dir = ck
        tr, l0, _ = run(cfg, "edge", 1)
        tr._checkpoint(0)
        tr, losses, row = run(cfg, "edge", HALO_DEVICE_EPOCHS - 1, start=1, tr=tr)
        runner = tr.epoch_runner
        row["graph_replays"] = [g.replays for g in runner.graphs] if runner.graph else []
        losses, params = l0 + losses, dp_params(tr)
        del runner, tr
        release()
        eager = DataParallelTrainer(cfg, store, whole, seed=0, feature_source="edge")
        eager.device_graphs = False
        start = eager.resume(0)
        e_losses = [eager.run_epoch(e).mean_loss for e in range(start, HALO_DEVICE_EPOCHS)]
        e_params = dp_params(eager)
        del eager
        release()
    row.update(losses=losses, eager_losses=e_losses,
               replay_bit_equal_to_eager=losses[1:] == e_losses and all(
                   torch.equal(params[k], e_params[k]) for k in params))
    pipe_cfg = copy.deepcopy(cfg)
    pipe_cfg.train.halo_pipeline = True
    for label, c_, source in (("pipelined", pipe_cfg, "edge"), ("cache", cfg, "cache")):
        tr, o_losses, o_row = run(c_, source, HALO_DEVICE_EPOCHS)
        o_params = dp_params(tr)
        del tr
        release()
        o_row.update(losses=o_losses, bit_equal_to_edge=o_losses == losses and all(
            torch.equal(params[k], o_params[k]) for k in params))
        row[label] = o_row
    out["edge_device_bfloat16"] = row
    with open(out_path, "w") as f:
        json.dump(out, f)


def halo_exchange_ms(torch, tr, iters: int = 20) -> float:
    """Wall ms of one eager exchange at ``tr``'s width (every rank at once,
    after a barrier; each request reads row 0 of its owner's shard): the
    exchange's own share of a halo step, apart from sampling and training."""
    ex = tr.exchange
    req = torch.zeros((ex.world_size, ex.halo_width), dtype=torch.int32,
                      device=ex.shard.device)
    src = torch.arange(ex.world_size * ex.halo_width, dtype=torch.int32,
                       device=ex.shard.device)
    ex(req, src)
    torch.distributed.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        ex(req, src)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def halo_rank_shared(rank, world, root, part_dir, out_dir) -> None:
    """A rank of several (gloo ranks on one card, or one ``nccl`` rank a
    card): ``ici`` on the host path over its partition from ``part_dir``,
    ``ici`` on the device over the whole graph, and ``edge`` on the device
    over its partition, :data:`HALO_SHARED_EPOCHS` epochs each at dropout
    0.2; the parameters after each epoch to ``out_dir``, and this rank's
    numbers as JSON."""
    import gc

    import numpy as np
    import torch

    import pagraph_tpu_torch as pt
    from pagraph_tpu_torch.data.formats import PartitionArtifact, load_partition
    from pagraph_tpu_torch.ops import gather_kernels as gk
    from pagraph_tpu_torch.parallel import DataParallelTrainer
    from pagraph_tpu_torch.storage.feature_store import FeatureStore

    torch.backends.cuda.matmul.allow_tf32 = False
    ds = dp_load_dataset(root)
    store = FeatureStore.build(ds.graph, ds.features)
    whole = PartitionArtifact(ds.graph, ds.train_nids,
                              np.arange(ds.num_nodes, dtype=np.int64), ds.labels)
    mine = load_partition(part_dir, rank)
    out = {"rank": rank, "backend": torch.distributed.get_backend(), "world_size": world}
    for run, source, cfg, part in (
            ("ici_host", "ici", dp_config(pt, 0, dropout=0.2, capacity=0), mine),
            ("ici_device", "ici", dp_config(pt, 0, on_device=True, dropout=0.2), whole),
            ("edge_device", "edge", dp_config(pt, 0, on_device=True, dropout=0.2), mine)):
        t0 = time.perf_counter()
        tr = DataParallelTrainer(cfg, store, part, seed=0, feature_source=source)
        setup = time.perf_counter() - t0
        rows = []
        for e in range(HALO_SHARED_EPOCHS[run]):
            m, row = dp_run(torch, gk, tr, 1, start=e)
            row.update(row.pop("epochs")[0])
            rows.append(row)
            torch.save(dp_params(tr), os.path.join(out_dir, f"halo_{run}_e{e}_rank{rank}.pt"))
        out[run] = {"setup_s": setup, "epochs": rows, "lockstep_steps": tr.steps,
                    "batch_size": cfg.sampler.batch_size, "train_vertices": len(part.train_nids),
                    "own_batches": -(-len(tr.part.train_nids) // cfg.sampler.batch_size),
                    "part_vertices": tr.part.num_nodes, "cache_filled": tr._cache_filled,
                    "graphs": bool(tr.epoch_runner.graph if tr._device_mode
                                   else tr.group_graphs),
                    "exchange_ms": halo_exchange_ms(torch, tr)}
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"halo_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def halo_ranks(env, root: str, world: int, backend: str, label: str):
    """``world`` ranks on ``backend`` through :func:`halo_rank_shared`, over
    the ``world``-way hash partition :func:`dp_parts` saved: the rows and
    the failed checks (each prefixed ``label``): one lockstep step count on
    every rank (the largest of the ranks' own batches over the partitions,
    ``ceil(n_train / (P * B))`` over the whole graph); exactly 4 gather
    launches, 1 all-reduce and 2 all_to_all a host step, 1 launch and the
    same collectives a device step; CUDA graphs under ``nccl`` and none
    under gloo; the ranks' parameters bit-equal after every epoch; the host
    loss falling."""
    torch, bad = env.torch, []
    from pagraph_tpu_torch.parallel import spawn_local

    part_dir, _ = dp_parts(env, root, world)
    out = {"world_size": world, "backend": backend}
    t0 = time.perf_counter()
    spawn_local(halo_rank_shared, world, root, part_dir, root, backend=backend, timeout=600)
    out["ranks_s"] = time.perf_counter() - t0
    ranks = []
    for r in range(world):
        with open(os.path.join(root, f"halo_rank{r}.json")) as f:
            ranks.append(json.load(f))
    out["ranks"] = ranks
    for run, per_step in (("ici_host", HALO_HOST_STEP["float32"]),
                          ("ici_device", DEVICE_STEP),
                          ("edge_device", DEVICE_STEP)):
        rows = [rk[run] for rk in ranks]
        want = (-(-rows[0]["train_vertices"] // (world * rows[0]["batch_size"]))
                if run == "ici_device" else max(rk["own_batches"] for rk in rows))
        lock = {rk["lockstep_steps"] for rk in rows}
        if lock != {want}:
            bad.append(f"{label} {run}: lockstep steps {lock}, expected {want}")
        if any(rk["graphs"] != (backend == "nccl") or rk["cache_filled"] for rk in rows):
            bad.append(f"{label} {run}: graphs {[rk['graphs'] for rk in rows]} on {backend}, "
                       f"caches filled {[rk['cache_filled'] for rk in rows]}")
        for r, rk in enumerate(rows):
            for e in rk["epochs"]:
                halo_check_collectives(dict(e, epochs=[e]),
                                       f"{label} {run} rank {r}", per_step, bad)
        equal = []
        for e in range(HALO_SHARED_EPOCHS[run]):
            ps = [torch.load(os.path.join(root, f"halo_{run}_e{e}_rank{r}.pt"),
                             map_location="cpu") for r in range(world)]
            equal.append(all(torch.equal(ps[0][k], q[k]) for q in ps[1:] for k in ps[0]))
        out[f"{run}_replicas_bit_equal"] = equal
        if not all(equal):
            bad.append(f"{label} {run}: the ranks' parameters differ after an epoch: {equal}")
    host_losses = [e["mean_loss"] for e in ranks[0]["ici_host"]["epochs"]]
    out["host_loss_falls"] = host_losses[1] < host_losses[0]
    if not out["host_loss_falls"]:
        bad.append(f"{label} the ici host loss did not fall: {host_losses}")
    return out, bad


def halo_phase(env, root: str):
    """The halo feature sources through ``DataParallelTrainer(feature_source=
    "ici" | "edge")``, the ranks spawned from here over the dataset and the
    partitions the ``dp`` phase saved under ``root``: (a) one ``nccl`` rank
    (:func:`halo_rank_world1`), (b) :data:`HALO_RANKS` gloo ranks on the one
    card (:func:`halo_ranks`).  Fails unless (a)'s ``ici`` host run replays
    from graphs and is bit-equal to the ``cache`` source at bf16 compute
    (at f32 within :data:`DP_F32_LOSS_TOL` of the loss and
    :data:`DP_F32_PARAM_TOL` of each parameter's max|p|), its ``edge``
    device epoch replays from one graph bit-equal to its eager form, to the
    ``cache`` source's device epoch and to its pipelined form, every run
    makes exactly the gather launches of its path, 1 all-reduce and 2
    all_to_all a step and drops no halo request, and (b) holds as
    :func:`halo_ranks` says."""
    from pagraph_tpu_torch.parallel import spawn_local

    t_phase = time.perf_counter()
    bad, out = [], {}
    t0 = time.perf_counter()
    spawn_local(halo_rank_world1, 1, root, os.path.join(root, "halo_w1.json"),
                backend="nccl", timeout=600)
    out["world1_s"] = time.perf_counter() - t0
    with open(os.path.join(root, "halo_w1.json")) as f:
        w1 = json.load(f)
    out["world1"] = w1
    for compute in ("bfloat16", "float32"):
        row = w1[f"ici_host_{compute}"]
        halo_check_collectives(row, f"(a) ici host {compute}", HALO_HOST_STEP[compute], bad)
        if not row["graphs"]:
            bad.append(f"(a) ici host {compute}: no host-step graph replayed")
    if not w1["ici_host_bfloat16"]["bit_equal_to_cache"]:
        bad.append("(a) ici host bf16: not bit-equal to the cache source's run")
    d_loss, d_par = w1["ici_host_float32"]["rel_diff_to_cache"]
    if not (d_loss <= DP_F32_LOSS_TOL and d_par <= DP_F32_PARAM_TOL):
        bad.append(f"(a) ici host f32: {d_loss} (loss, relative) and {d_par} (parameters, of "
                   f"max|p|) from the cache source's run, over {DP_F32_LOSS_TOL} and "
                   f"{DP_F32_PARAM_TOL}")
    dev = w1["edge_device_bfloat16"]
    per_step = device_step_launches("assemble_f32_to_bf16", "mean", 2, bf16=True,
                                    kernel_draws=False)
    halo_check_collectives(dev, "(a) edge device", per_step, bad)
    halo_check_collectives(dev["pipelined"], "(a) edge device pipelined", per_step, bad)
    if dev["graph_replays"] != [HALO_DEVICE_EPOCHS - 1]:
        bad.append(f"(a) edge device: the epoch graph replayed {dev['graph_replays']} times")
    for what, ok in (("replayed epochs against their eager form",
                      dev["replay_bit_equal_to_eager"]),
                     ("pipelined epochs against the unpipelined",
                      dev["pipelined"]["bit_equal_to_edge"]),
                     ("the cache source's device epochs against edge's",
                      dev["cache"]["bit_equal_to_edge"])):
        if not ok:
            bad.append(f"(a) edge device: {what} are not bit-equal")
    out["shared"], more = halo_ranks(env, root, HALO_RANKS, "gloo", "(b)")
    bad.extend(more)
    out["seconds"] = time.perf_counter() - t_phase
    return out, bad


# -- dp_cv: data-parallel CV-GCN, per-rank histories and their shards ---------
DP_CV_EPOCHS = 3                        # (a): epoch 0 eager, then two replays
DP_CV_RANKS = 2                         # (b): gloo ranks sharing the one card
DP_CV_SHARED_EPOCHS = {"cache": 2, "edge": 1}   # (b): gloo moves edge's 144 MB a step


def dp_cv_save(env, root: str) -> str:
    """CV-GCN's dataset for the ranks, under ``root/cv``: RMAT-20 with the
    store's ``gcn`` aggregate as its features (``FeatureStore.build`` of it
    is the ``preprocess="gcn"`` store, without a full-graph SpMM in every
    rank), the 2-hop teacher labels and the train set cut to its first
    :data:`FAMILY_TRAIN_VERTICES`; and its 2-way hash parts at 2 hops."""
    np, ds = env.np, env.ds_nb
    cv_root = os.path.join(root, "cv")
    os.makedirs(cv_root, exist_ok=True)
    train_ids = np.nonzero(ds.train_mask)[0][:FAMILY_TRAIN_VERTICES]
    cut = np.zeros_like(ds.train_mask)
    cut[train_ids] = True
    agg = env.FeatureStore.build(ds.graph, ds.features, preprocess="gcn").fields["features"]
    cv_ds = env.Dataset(ds.graph, agg, ds.labels, cut, ds.val_mask, ds.test_mask)
    dp_save_dataset(np, cv_ds, cv_root)
    parts = env.partition.hash_partition(ds.graph, train_ids, ds.labels, DP_CV_RANKS, 2)
    for r, p in enumerate(parts):
        env.formats.save_partition(os.path.join(cv_root, f"parts{DP_CV_RANKS}"), r, p)
    return cv_root


def dp_cv_rmat16(np, synthetic, Dataset, CSRGraph):
    """The RMAT-16 graph of ``cv_gcn``'s resume (its checkpoint holds 0.4 GB
    of histories, RMAT-20's 6.4 GB)."""
    g16 = CSRGraph.from_coo(synthetic.rmat_coo(CV_HOST_SCALE, 16, seed=42))
    x16 = np.random.default_rng(7).random((g16.num_nodes, 100), dtype=np.float32)
    return Dataset(g16, x16, synthetic.neighborhood_labels(g16, x16, 47, seed=1),
                   *synthetic.random_split_masks(g16.num_nodes, seed=11))


def dp_cv_resume(torch, pt, DataParallelTrainer, ds16, ckpt_dir):
    """CV-GCN on RMAT-16 through ``DataParallelTrainer.from_dataset`` (each
    rank partitions it) at dropout 0.5: epoch 0, the checkpoint (every
    rank's shard), epoch 1; then a fresh trainer resumed from the shards
    runs epoch 1.  The row: shard bytes, resume seconds, whether the
    resumed epoch equals the uninterrupted one to the bit (loss,
    parameters, histories, aggregates)."""
    cfg = cv_config(pt, ds16.num_nodes, on_device=True)
    cfg.partition = pt.PartitionConfig(method="hash", num_hops=2)
    cfg.train.ckpt_dir = ckpt_dir
    full = DataParallelTrainer.from_dataset(cfg, ds16, seed=0)
    full.run_epoch(0)
    full._checkpoint(0)
    m1 = full.run_epoch(1)
    shard = os.path.join(ckpt_dir, f"gcn_cv_0.aux.p{full.rank}")
    again = DataParallelTrainer.from_dataset(cfg, ds16, seed=0)
    t0 = time.perf_counter()
    start = again.resume(0)
    resume_s = time.perf_counter() - t0
    r1 = again.run_epoch(start)
    equal = (start == 1 and r1.mean_loss == m1.mean_loss
             and all(torch.equal(p, q) for p, q in zip(full.state.model.parameters(),
                                                       again.state.model.parameters()))
             and all(torch.equal(x, y) for x, y in zip(
                 full.cv_state.hist_views() + list(full.cv_state.aggs),
                 again.cv_state.hist_views() + list(again.cv_state.aggs))))
    return {"graph_vertices": ds16.num_nodes, "part_vertices": full.part.num_nodes,
            "shard_bytes": os.path.getsize(shard), "resume_s": resume_s,
            "losses": [full.epoch_metrics[0].mean_loss, m1.mean_loss],
            "resumed_loss": r1.mean_loss, "bit_equal": equal}


def dp_cv_snapshot(tr):
    """Losses, parameters, histories and aggregates of a CV trainer (on
    its device)."""
    return ([m.mean_loss for m in tr.epoch_metrics], dp_params(tr),
            [t.clone() for t in tr.cv_state.hist_views() + list(tr.cv_state.aggs)])


def dp_cv_equal(torch, a, b) -> bool:
    return a[0] == b[0] and all(torch.equal(a[1][k], b[1][k]) for k in a[1]) and all(
        torch.equal(x, y) for x, y in zip(a[2], b[2], strict=True))


def dp_cv_rank_world1(rank, world, root, out_path) -> None:
    """A world-size-1 ``nccl`` rank of the ``dp_cv`` phase over the whole
    RMAT-20 graph (the cut train set, dropout 0): the ``cache`` CV epoch at
    bf16 compute replayed from one CUDA graph against its eager form and
    against the single-device Trainer's CV device epoch from the same
    random integers; ``edge`` at bf16 against ``cache``; ``cache`` at f32
    against the single-device run; the RMAT-16 resume from the shards.
    Writes the results as JSON to ``out_path``."""
    import gc

    import numpy as np
    import torch

    import pagraph_tpu_torch as pt
    from pagraph_tpu_torch.data import synthetic
    from pagraph_tpu_torch.data.formats import Dataset, PartitionArtifact
    from pagraph_tpu_torch.graph import CSRGraph
    from pagraph_tpu_torch.ops import gather_kernels as gk
    from pagraph_tpu_torch.parallel import DataParallelTrainer
    from pagraph_tpu_torch.storage.feature_store import FeatureStore
    from pagraph_tpu_torch.train.device_epoch import epoch_seed
    from pagraph_tpu_torch.train.loop import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    ds = dp_load_dataset(os.path.join(root, "cv"))
    n = ds.num_nodes
    store = FeatureStore.build(ds.graph, ds.features)      # the features: the gcn aggregate
    whole = PartitionArtifact(ds.graph, ds.train_nids, np.arange(n, dtype=np.int64),
                              ds.labels)
    out = {"backend": torch.distributed.get_backend(), "world_size": world}

    def cfg_of(compute):
        cfg = cv_config(pt, n, on_device=True, compute=compute)
        cfg.model.dropout = 0.0
        return cfg

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def dp(compute, source, epochs, graphs=True):
        t0 = time.perf_counter()
        tr = DataParallelTrainer(cfg_of(compute), store, whole, seed=0, feature_source=source)
        tr._epoch_seed = lambda e: epoch_seed(0, e)     # the single-device Trainer's draws
        tr.device_graphs = tr.device_graphs and graphs
        tr.device_data()
        setup = time.perf_counter() - t0
        _, row = dp_run(torch, gk, tr, epochs)
        row.update(setup_s=setup, window_tables=len(tr.cv_state.windows.tables()),
                   graph_replays=([g.replays for g in tr.epoch_runner.graphs]
                                  if tr.epoch_runner.graph else []))
        snap = dp_cv_snapshot(tr)
        del tr
        release()
        return snap, row

    def single(compute, epochs):
        t_ = Trainer(cfg_of(compute), store, ds.graph, ds.train_nids, ds.labels, seed=0)
        for e in range(epochs):
            t_.run_epoch(e)
        snap = dp_cv_snapshot(t_)
        del t_
        release()
        return snap

    runs = {}
    runs["cache_bf16"], row = dp("bfloat16", "cache", DP_CV_EPOCHS)
    runs["cache_bf16_eager"], eager_row = dp("bfloat16", "cache", DP_CV_EPOCHS, graphs=False)
    row["eager_epochs"] = eager_row["epochs"]
    row["replay_bit_equal_to_eager"] = dp_cv_equal(torch, runs["cache_bf16"],
                                                    runs["cache_bf16_eager"])
    del runs["cache_bf16_eager"]
    single_bf16 = single("bfloat16", DP_CV_EPOCHS)
    row["single_losses"] = single_bf16[0]
    row["bit_equal_to_single"] = dp_cv_equal(torch, runs["cache_bf16"], single_bf16)
    del single_bf16
    out["cache_bfloat16"] = row
    edge, row = dp("bfloat16", "edge", DP_CV_EPOCHS)
    row["bit_equal_to_cache"] = dp_cv_equal(torch, edge, runs["cache_bf16"])
    out["edge_bfloat16"] = row
    del edge, runs
    release()
    f32, row = dp("float32", "cache", 2)
    s32 = single("float32", 2)
    row["single_losses"] = s32[0]
    row["bit_equal_to_single"] = dp_cv_equal(torch, f32, s32)
    row["rel_diff_to_single"] = dp_rel_diffs(f32[0], f32[1], s32[0], s32[1])
    row["max_cv_diff_to_single"] = max(float((x - y).abs().max())
                                       for x, y in zip(f32[2], s32[2]))
    out["cache_float32"] = row
    del f32, s32
    release()
    with tempfile.TemporaryDirectory() as ck:
        out["resume_rmat16"] = dp_cv_resume(
            torch, pt, DataParallelTrainer, dp_cv_rmat16(np, synthetic, Dataset, CSRGraph), ck)
    with open(out_path, "w") as f:
        json.dump(out, f)


def dp_cv_rank_shared(rank, world, root, out_dir) -> None:
    """A gloo rank of several on one card: its part of the cut RMAT-20
    train set (``root/cv/parts<world>``), the ``cache`` and the ``edge`` CV
    epochs (:data:`DP_CV_SHARED_EPOCHS`) at dropout 0.5; the parameters
    after each epoch to ``out_dir``; then the RMAT-16 resume from every
    rank's shard (a checkpoint directory shared by the ranks).  This
    rank's numbers as JSON."""
    import gc

    import numpy as np
    import torch

    import pagraph_tpu_torch as pt
    from pagraph_tpu_torch.data import synthetic
    from pagraph_tpu_torch.data.formats import Dataset, load_partition
    from pagraph_tpu_torch.graph import CSRGraph
    from pagraph_tpu_torch.ops import gather_kernels as gk
    from pagraph_tpu_torch.parallel import DataParallelTrainer
    from pagraph_tpu_torch.storage.feature_store import FeatureStore

    torch.backends.cuda.matmul.allow_tf32 = False
    cv_root = os.path.join(root, "cv")
    ds = dp_load_dataset(cv_root)
    store = FeatureStore.build(ds.graph, ds.features)
    part = load_partition(os.path.join(cv_root, f"parts{world}"), rank)
    out = {"rank": rank, "backend": torch.distributed.get_backend(), "world_size": world}
    for source in ("cache", "edge"):
        t0 = time.perf_counter()
        tr = DataParallelTrainer(cv_config(pt, ds.num_nodes, on_device=True), store, part,
                                 seed=0, feature_source=source)
        tr.device_data()
        setup = time.perf_counter() - t0
        rows = []
        for e in range(DP_CV_SHARED_EPOCHS[source]):
            _, row = dp_run(torch, gk, tr, 1, start=e)
            row.update(row.pop("epochs")[0])
            rows.append(row)
            torch.save(dp_params(tr), os.path.join(out_dir, f"cv_{source}_e{e}_rank{rank}.pt"))
        out[source] = {"setup_s": setup, "epochs": rows, "lockstep_steps": tr.steps,
                       "own_batches": -(-len(part.train_nids) // tr.cfg.sampler.batch_size),
                       "part_vertices": part.num_nodes,
                       "window_tables": len(tr.cv_state.windows.tables()),
                       "history_bytes": sum(t.nbytes for t in tr.cv_state.hists
                                            + tr.cv_state.aggs),
                       "graphs": bool(tr.epoch_runner.graph)}
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    out["resume_rmat16"] = dp_cv_resume(torch, pt, DataParallelTrainer,
                                        dp_cv_rmat16(np, synthetic, Dataset, CSRGraph),
                                        os.path.join(out_dir, "cv_ck"))
    with open(os.path.join(out_dir, f"cv_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def dp_cv_phase(env, root: str):
    """Data-parallel CV-GCN (``DataParallelTrainer``, ``model.arch="gcn_cv"``
    on the device, the ``cache`` and ``edge`` sources) at ``cv_config``'s
    shape on RMAT-20's cut train set: (a) one ``nccl`` rank
    (:func:`dp_cv_rank_world1`), (b) :data:`DP_CV_RANKS` gloo ranks on the
    one card over 2-way hash parts (:func:`dp_cv_rank_shared`).  Fails
    unless (a)'s replayed ``cache`` epochs (one graph, the all-reduces and
    the refresh inside) are bit-equal to their eager form and, at bf16
    compute, to the single-device CV epoch, ``edge`` is bit-equal to
    ``cache``, f32 is within ``dp``'s bounds of the single-device run,
    every run launches one assembly a step and one window reduction a
    table a history an epoch with one all-reduce a step, (b)'s replicas
    are bit-equal after every epoch with one lockstep count, and every
    rank's RMAT-16 resume from its shard is bit-equal.  Returns the line,
    the rows a kernel case needs and the failures."""
    from pagraph_tpu_torch.parallel import spawn_local

    t_phase = time.perf_counter()
    bad, out = [], {}
    t0 = time.perf_counter()
    cv_root = dp_cv_save(env, root)
    out["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spawn_local(dp_cv_rank_world1, 1, root, os.path.join(root, "cv_w1.json"),
                backend="nccl", timeout=600)
    out["world1_s"] = time.perf_counter() - t0
    with open(os.path.join(root, "cv_w1.json")) as f:
        w1 = json.load(f)
    out["world1"] = w1

    def check(row, label, per_step, epochs):
        steps = sum(e["batches"] for e in row["epochs"])
        tables = row["window_tables"]
        want = {k: v * steps for k, v in per_step.items()}
        want["gather_reduce_sum"] = 2 * tables * epochs
        if row["launches"] != want or row["all_reduces_per_step"] != 1:
            bad.append(f"{label}: launches {row['launches']} and {row['all_reduces_per_step']} "
                       f"all-reduces a step, expected {want} and 1")

    for key, per_step, epochs in (("cache_bfloat16", {"assemble_f32_to_bf16": 1}, DP_CV_EPOCHS),
                                  ("edge_bfloat16", {"assemble_f32_to_bf16": 1}, DP_CV_EPOCHS),
                                  ("cache_float32", {"assemble_f32": 1}, 2)):
        check(w1[key], f"(a) {key}", per_step, epochs)
        if w1[key]["graph_replays"] != [epochs - 1]:
            bad.append(f"(a) {key}: the epoch graph replayed {w1[key]['graph_replays']} times")
    for what, ok in (("the replayed cache epochs against their eager form",
                      w1["cache_bfloat16"]["replay_bit_equal_to_eager"]),
                     ("the cache epochs against the single-device CV epochs (bf16)",
                      w1["cache_bfloat16"]["bit_equal_to_single"]),
                     ("edge against cache (bf16)", w1["edge_bfloat16"]["bit_equal_to_cache"]),
                     ("the RMAT-16 resume from the shard",
                      w1["resume_rmat16"]["bit_equal"])):
        if not ok:
            bad.append(f"(a) {what}: not bit-equal")
    d_loss, d_par = w1["cache_float32"]["rel_diff_to_single"]
    if not (d_loss <= DP_F32_LOSS_TOL and d_par <= DP_F32_PARAM_TOL):
        bad.append(f"(a) f32: {d_loss} (loss, relative) and {d_par} (parameters, of max|p|) "
                   f"from the single-device run, over {DP_F32_LOSS_TOL} and {DP_F32_PARAM_TOL}")

    # (b): gloo ranks on the one card
    world = DP_CV_RANKS
    t0 = time.perf_counter()
    spawn_local(dp_cv_rank_shared, world, root, root, backend="gloo", timeout=600)
    out["shared_s"] = time.perf_counter() - t0
    ranks = []
    for r in range(world):
        with open(os.path.join(root, f"cv_rank{r}.json")) as f:
            ranks.append(json.load(f))
    out["shared"] = ranks
    for source in ("cache", "edge"):
        rows = [rk[source] for rk in ranks]
        if {rk["lockstep_steps"] for rk in rows} != {max(rk["own_batches"] for rk in rows)}:
            bad.append(f"(b) {source}: lockstep steps {[rk['lockstep_steps'] for rk in rows]}, "
                       f"own batches {[rk['own_batches'] for rk in rows]}")
        if any(rk["graphs"] for rk in rows):
            bad.append(f"(b) {source}: a CUDA graph under gloo")
        for r, rk in enumerate(rows):
            check(dict(rk, epochs=rk["epochs"], launches=sum_launches(rk["epochs"]),
                       all_reduces_per_step=max(e["all_reduces_per_step"]
                                                for e in rk["epochs"])),
                  f"(b) {source} rank {r}", {"assemble_f32": 1}, DP_CV_SHARED_EPOCHS[source])
        equal = []
        for e in range(DP_CV_SHARED_EPOCHS[source]):
            ps = [env.torch.load(os.path.join(root, f"cv_{source}_e{e}_rank{r}.pt"),
                                 map_location="cpu") for r in range(world)]
            equal.append(all(env.torch.equal(ps[0][k], q[k]) for q in ps[1:] for k in ps[0]))
        out[f"{source}_replicas_bit_equal"] = equal
        if not all(equal):
            bad.append(f"(b) {source}: the ranks' parameters differ after an epoch: {equal}")
    for r, rk in enumerate(ranks):
        if not rk["resume_rmat16"]["bit_equal"]:
            bad.append(f"(b) rank {r}: the RMAT-16 resume from its shard is not bit-equal")
    out["cv_root"] = cv_root
    out["seconds"] = time.perf_counter() - t_phase
    return out, bad


def sum_launches(epochs) -> dict:
    """The launches of several epoch rows, summed by key."""
    out: dict = {}
    for e in epochs:
        for k, v in e["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def dp_cv_kernel_cases(env, cv_root, dp_cv_out):
    """The kernel cases of the ``dp_cv`` phase's paths, on rank 0's part of
    its (b) run (the 2-way hash part of the cut train set, the ``gcn``
    aggregate): the ``cache`` source's layer-0 fetch (``take_rows``) at a
    device-sampled CV batch of the part; the ``edge`` source's exchange
    assembly at that batch over 2 shards (the received rows of the two
    owners in plan order, one zero row); the rank's refresh, the window
    reduction over the part's window tables at F in
    :data:`CV_WINDOW_FANOUTS` and the hub table, over a history of each
    width the rank refreshes (``hist[b]``, b over the layers).  Launches:
    rank 0's runs in (b); each table is reduced once a history an epoch,
    so a table's count is the rank's ``gather_reduce_sum`` launches over
    ``2 * len(tables)``."""
    torch, np, gk, dev = env.torch, env.np, env.gk, env.dev
    from pagraph_tpu_torch.data.formats import load_partition
    from pagraph_tpu_torch.models.gcn_cv import layer_widths
    from pagraph_tpu_torch.models.inference import _BucketedNeighborhoods
    from pagraph_tpu_torch.ops.gather import take_rows
    from pagraph_tpu_torch.parallel.halo import device_halo_plan, halo_width_for, src_rows
    from pagraph_tpu_torch.sampling.device_sampler import DeviceCSR, sample_minibatch_device
    from pagraph_tpu_torch.train.device_epoch import epoch_draws

    part = load_partition(os.path.join(cv_root, f"parts{DP_CV_RANKS}"), 0)
    full = torch.from_numpy(np.load(os.path.join(cv_root, "features.npy"))).to(dev)
    l2f = torch.from_numpy(part.local2full.astype(np.int64)).to(dev)
    cache = full.index_select(0, l2f)
    cv_cfg = cv_config(env.pt, 0, on_device=True)
    s = cv_cfg.sampler
    gen = torch.Generator(device=dev).manual_seed(3)
    draws = [d[0] for d in epoch_draws(gen, 1, s.batch_size, s.hop_fanouts(), s.paired_draws,
                                       dev)]
    seeds = torch.from_numpy(part.train_nids[:s.batch_size].astype(np.int32)).to(dev)
    mb = sample_minibatch_device(DeviceCSR.from_graph(part.graph, dev), seeds,
                                 torch.ones_like(seeds, dtype=torch.bool), s.num_hops,
                                 s.hop_fanouts(), draws)
    ids, d = mb.input_nids, cache.shape[1]
    nd = ids.shape[0]
    n_ids = int(torch.unique(ids).numel())
    rank0 = dp_cv_out["shared"][0]
    cache_launch = sum_launches(rank0["cache"]["epochs"])
    edge_launch = sum_launches(rank0["edge"]["epochs"])
    cases = [dict(
        name="assemble_full[dp cv cache f32]", key="assemble_f32",
        launches=cache_launch.get("assemble_f32", 0),
        replaces=f"{PALLAS}:58 gather_rows_pallas (the dp CV layer-0 fetch: "
                 "pagraph_tpu/train/device_epoch.py:869 chunked_take + dequantize_fused)",
        shape=f"cache {list(cache.shape)} f32 ids [{nd}] ({n_ids} distinct), no miss rows",
        tol="exact",
        kernel=lambda: take_rows(cache, ids),
        plain=lambda: gk.assemble_plain(cache, ids, cache[:0]),
        library=lambda: torch.index_select(cache, 0, ids),
        same_fn=lambda: torch.index_select(cache, 0, ids),
        nbytes=4 * nd + 4 * n_ids * d + 4 * nd * d)]
    # the edge exchange at 2 shards: owner p's request j is its shard row
    # req[p, j], the full row req * P + p
    world = DP_CV_RANKS
    hw = halo_width_for(nd, world)
    plan = device_halo_plan(l2f.int().index_select(0, ids), mb.input_mask, world, hw)
    owner = torch.arange(world, device=dev)[:, None]
    recv = full.index_select(0, (plan.req.long() * world + owner).view(-1))
    zero = torch.zeros((1, d), device=dev)
    src = src_rows(plan)
    h_distinct = int(torch.unique(src[src >= 0]).numel())
    cases.append(dict(
        name=f"assemble_halo[dp cv edge f32, P={world}]", key="assemble_f32",
        launches=edge_launch.get("assemble_f32", 0),
        replaces=f"{PALLAS}:58 gather_rows_pallas (the edge CV exchange's batch order: "
                 "pagraph_tpu/parallel/halo.py:152 jnp.take + :155 where)",
        shape=f"received {list(recv.shape)} f32 src_row [{nd}] (P = {world}, H = {hw}), "
              "one zero row",
        tol="exact",
        kernel=lambda: gk.assemble(recv, src, zero),
        plain=lambda: gk.assemble_plain(recv, src, zero),
        library=None,
        same_fn=lambda: torch.where((src >= 0)[:, None],
                                    torch.index_select(recv, 0, src.clamp(min=0)), 0.0),
        nbytes=4 * nd + 4 * h_distinct * d + 4 * d + 4 * nd * d))
    # the rank's refresh: each table reduced once a history an epoch
    windows = _BucketedNeighborhoods(part.graph, dev)
    tables = windows.tables()
    per_table = cache_launch.get("gather_reduce_sum", 0) // (2 * len(tables))
    win = {p.shape[1]: (p, m) for lv, p, m in tables if lv == "bucket"}
    hubs = [(p, m) for lv, p, m in tables if lv == "hubs"]
    picked = [(f"F={wf}", win[wf]) for wf in CV_WINDOW_FANOUTS if wf in win]
    picked += [("hubs F=4096", hubs[0])] if hubs else []
    for dw in layer_widths(cv_cfg.model):
        hist = torch.randn(part.num_nodes, dw, generator=gen, device=dev)
        for label, (pos, mask) in picked:
            rows_w, wf = pos.shape
            counts = mask.sum(1)
            offs = torch.zeros_like(counts)
            offs[1:] = torch.cumsum(counts, 0)[:-1]
            flat = pos[mask].long()
            cases.append(dict(
                name=f"window_reduce[sum, cv_refresh_dp rank0 {label}, D={dw}]",
                key="gather_reduce_sum", launches=per_table,
                replaces=f"{PALLAS}:132 gather_mean_pallas (a dp rank's CV refresh: "
                         "pagraph_tpu/train/device_epoch.py:923 refresh)",
                shape=f"src {list(hist.shape)} pos/mask [{rows_w}, {wf}] "
                      f"({int(mask.sum())} valid slots), plan "
                      f"{gk.window_plan(rows_w, wf, dw, True)}",
                tol=max(TOLERANCES["reduce"], wf * 2.0 ** -24),
                kernel=lambda x_=hist, p_=pos, m_=mask: gk.gather_reduce(x_, p_, m_, "sum"),
                plain=lambda x_=hist, p_=pos, m_=mask: gk.gather_reduce_plain(
                    x_, p_, m_, "sum"),
                library=lambda x_=hist, fl=flat, of=offs.long():
                    torch.nn.functional.embedding_bag(fl, x_, of, mode="sum"),
                nbytes=5 * rows_w * wf + 4 * int(torch.unique(pos[mask]).numel()) * dw
                + 4 * rows_w * dw))
    return cases


# -- service: isolation-mode sampling, worker processes and shared memory ------
SERVICE_EPOCHS = 3
SERVICE_RESAMPLED = 3                   # batches re-sampled in-process and compared
SERVICE_RANKS = 2


def service_recorder(tr, keep: int = SERVICE_RESAMPLED):
    """Wrap a service-backed trainer's sampler: each epoch's batch seeds,
    and the first ``keep`` batches of epoch 0 (copied)."""
    epochs, kept, epoch = [], [], tr.sampler.epoch

    def recorded():
        seen = []
        epochs.append(seen)
        for mb in epoch():
            seen.append(mb.layer_nids[-1][:int(mb.seed_mask.sum())].copy())
            if len(epochs) == 1 and len(kept) < keep:
                kept.append(mb)
            yield mb

    tr.sampler.epoch = recorded
    return epochs, kept


def service_closed(tr) -> dict:
    """Close the trainer's service: whether a worker outlived it, and the
    shared-memory segments left."""
    workers, names = list(tr.sampler.workers), [m.name for m in tr.sampler._registry]
    tr.close()
    return {"workers": len(workers), "segments": len(names),
            "alive_after_close": any(w.is_alive() for w in workers),
            "segments_left": [n for n in names if os.path.exists(os.path.join("/dev/shm", n))]}


def service_rank_shared(rank, world, root, part_dir, capacity, out_dir) -> None:
    """A gloo rank of the ``service`` phase: the host path at ``bench.py``'s
    shape with ``train.remote_sampling``, one2one over its part from
    ``part_dir`` (cache at ``capacity``) and one2all over the whole graph
    (cache at 40%), 2 epochs each at dropout 0.2; the parameters after each
    epoch and the batch seeds to ``out_dir``, and this rank's numbers as
    JSON."""
    import gc

    import numpy as np
    import torch

    import pagraph_tpu_torch as pt
    from pagraph_tpu_torch.data.formats import PartitionArtifact, load_partition
    from pagraph_tpu_torch.ops import gather_kernels as gk
    from pagraph_tpu_torch.parallel import DataParallelTrainer
    from pagraph_tpu_torch.storage.feature_store import FeatureStore

    torch.backends.cuda.matmul.allow_tf32 = False
    ds = dp_load_dataset(root)
    store = FeatureStore.build(ds.graph, ds.features)
    whole = PartitionArtifact(ds.graph, ds.train_nids, np.arange(ds.num_nodes, dtype=np.int64),
                              ds.labels)
    out = {"rank": rank, "backend": torch.distributed.get_backend(), "world_size": world}
    for dispatch, part, cap in (("one2one", load_partition(part_dir, rank), capacity),
                                ("one2all", whole, int(ds.num_nodes * DP_CACHE_SHARE))):
        cfg = dp_config(pt, 0, dropout=0.2, capacity=cap)
        cfg.train.remote_sampling = True
        t0 = time.perf_counter()
        tr = DataParallelTrainer(cfg, store, part, seed=0, dispatch=dispatch)
        tr._maybe_fill_cache()
        setup = time.perf_counter() - t0
        seeds, _ = service_recorder(tr, keep=0)
        rows = []
        for e in range(2):
            _, row = dp_run(torch, gk, tr, 1, start=e)
            row.update(row.pop("epochs")[0])
            rows.append(row)
            torch.save(dp_params(tr), os.path.join(out_dir, f"svc_{dispatch}_e{e}_rank{rank}.pt"))
        np.save(os.path.join(out_dir, f"svc_{dispatch}_seeds_rank{rank}.npy"),
                np.array([np.concatenate(s) for s in seeds], dtype=object), allow_pickle=True)
        out[dispatch] = {"setup_s": setup, "epochs": rows, "lockstep_steps": tr.steps,
                         "service_batches": tr.sampler.num_batches,
                         "train_vertices": len(part.train_nids),
                         "closed": service_closed(tr)}
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"svc_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def service_phase(env, root: str):
    """Isolation-mode sampling (``train.remote_sampling``:
    ``sampling/service.py`` ``SampleService``, 2 worker processes over the
    graph in shared memory) at ``bench.py``'s shape on RMAT-20, the cache
    at 40%: (a) a ``Trainer`` (K = 8, epoch 0 eager, then the host-step
    graphs) for :data:`SERVICE_EPOCHS` epochs: 4 launches a step, the loss
    falling, every epoch's seeds the train set once, the first batches
    equal to the native sampler's in-process batches of the same seeds and
    batch seeds, the loader alone through the service beside the
    in-process native loader (in turns), and ``close()`` leaving no worker
    and no segment; (b) :data:`SERVICE_RANKS` gloo ranks through
    :func:`service_rank_shared`, one2one and one2all: replicas bit-equal,
    one lockstep count (one2all's the round robin's share), one2all's
    ranks' seeds covering the train set and shared only through make-up
    chunks, every service closed clean."""
    torch, np, gk, pt = env.torch, env.np, env.gk, env.pt
    import shutil

    from pagraph_tpu_torch.parallel import spawn_local
    from pagraph_tpu_torch.sampling.loader import PrefetchLoader
    from pagraph_tpu_torch.sampling.native import NativeSampler
    from pagraph_tpu_torch.sampling.sampler import NeighborSampler

    t_phase = time.perf_counter()
    ds, bad = env.ds, []
    shm = shutil.disk_usage("/dev/shm")
    out = {"dev_shm": {"total_bytes": shm.total, "free_bytes": shm.free},
           "graph_share_bytes": ds.graph.indptr.nbytes + ds.graph.indices.nbytes
           + 4 * ds.num_nodes}
    if shm.free < 2 * out["graph_share_bytes"]:
        bad.append(f"/dev/shm has {shm.free} bytes free: too small for the service's "
                   f"{out['graph_share_bytes']} bytes of graph")
        return out, bad
    cfg = dp_config(pt, ds.num_nodes, dropout=0.2)
    cfg.train.remote_sampling = True
    rec = {}

    def make():
        t_ = env.Trainer.from_dataset(cfg, ds, seed=0)
        rec["seeds"], rec["kept"] = service_recorder(t_)
        return t_

    tr, out["trainer"] = run_trainer(
        torch, gk, "service trainer", make, SERVICE_EPOCHS,
        {"assemble_f32": 1, "block_gather_fwd_mean": 2, "block_gather_bwd_mean": 1})
    out["trainer"].update(caps=list(tr.sampler.caps),
                          graphs=len(tr.group_graphs.graphs) if tr.group_graphs else 0,
                          workers=len(tr.sampler.workers))
    train = np.sort(ds.train_nids)
    covers = [bool(np.array_equal(np.sort(np.concatenate(s)), train)) for s in rec["seeds"]]
    out["trainer"]["epochs_cover_train_set"] = covers
    if not all(covers) or len(covers) != SERVICE_EPOCHS:
        bad.append(f"(a) the service's seeds do not cover the train set each epoch: {covers}")
    # the first batches again, in this process: epoch 0's chunks and the
    # batch seeds drawn in chunk order (SampleService._epoch_chunks, _epoch)
    svc = tr.sampler
    b = cfg.sampler.batch_size
    order = np.random.default_rng(np.random.SeedSequence((0, 0))).permutation(len(ds.train_nids))
    chunks = [ds.train_nids[order][i:i + b] for i in range(0, len(order), b)]
    rng = np.random.default_rng(np.random.SeedSequence((0, 0, 0, 7)))
    batch_seeds = [int(rng.integers(0, 2**31 - 1)) for _ in chunks]
    first = {int(c[0]): i for i, c in enumerate(chunks)}
    native = NativeSampler(ds.graph, cfg.sampler, svc.caps)
    same = []
    for mb in rec["kept"]:
        i = first[int(mb.layer_nids[-1][0])]
        again = native.sample(chunks[i], ds.labels, batch_seeds[i])
        same.append(all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(
            [*mb.layer_nids, *mb.layer_mask, mb.labels,
             *(a for blk in mb.blocks for a in (blk.neigh_pos, blk.neigh_mask, blk.self_pos))],
            [*again.layer_nids, *again.layer_mask, again.labels,
             *(a for blk in again.blocks for a in (blk.neigh_pos, blk.neigh_mask, blk.self_pos))],
            strict=True)))
    out["trainer"]["resampled_in_process_equal"] = same
    if len(same) != SERVICE_RESAMPLED or not all(same):
        bad.append(f"(a) the service's batches differ from the native sampler's: {same}")
    # the loader alone: through the service and in process, in turns
    in_proc = NeighborSampler(ds.graph, ds.train_nids, cfg.sampler, labels=ds.labels, seed=0,
                              caps=svc.caps)
    loaders = {"service": tr.loader,
               "in_process": PrefetchLoader(in_proc, tr.cache, prefetch=cfg.sampler.prefetch)}
    times = {k: [] for k in loaders}
    for name in ("service", "in_process", "service", "in_process"):
        t0 = time.perf_counter()
        for _ in loaders[name].groups(tr.steps_per_dispatch):
            pass
        times[name].append(time.perf_counter() - t0)
    out["loader_only_s"] = times
    out["trainer"]["closed"] = closed = service_closed(tr)
    if closed["alive_after_close"] or closed["segments_left"]:
        bad.append(f"(a) close(): {closed}")
    del tr, loaders
    gc.collect()
    torch.cuda.empty_cache()

    # (b): gloo ranks, one2one over the 2-way hash parts and one2all
    world = SERVICE_RANKS
    part_dir, parts = dp_parts(env, root, world)
    capacity = int(DP_CACHE_SHARE * max(p.num_nodes for p in parts))
    t0 = time.perf_counter()
    spawn_local(service_rank_shared, world, root, part_dir, capacity, root, backend="gloo",
                timeout=600)
    out["shared_s"] = time.perf_counter() - t0
    ranks = []
    for r in range(world):
        with open(os.path.join(root, f"svc_rank{r}.json")) as f:
            ranks.append(json.load(f))
    out["shared"] = ranks
    per_step = {"assemble_f32": 1, "block_gather_fwd_mean": 2, "block_gather_bwd_mean": 1}
    n_train = len(ds.train_nids)
    for dispatch in ("one2one", "one2all"):
        rows = [rk[dispatch] for rk in ranks]
        lock = {rk["lockstep_steps"] for rk in rows}
        total = -(-n_train // cfg.sampler.batch_size)
        want = (-(-total // world) if dispatch == "one2all"
                else max(-(-rk["train_vertices"] // cfg.sampler.batch_size) for rk in rows))
        if lock != {want}:
            bad.append(f"(b) {dispatch}: lockstep steps {lock}, expected {want}")
        for r, rk in enumerate(rows):
            for e in rk["epochs"]:
                if e["launches"] != {k: v * e["batches"] for k, v in per_step.items()} or \
                        e["all_reduces_per_step"] != 1:
                    bad.append(f"(b) {dispatch} rank {r}: launches {e['launches']}, "
                               f"{e['all_reduces_per_step']} all-reduces a step")
            if rk["closed"]["alive_after_close"] or rk["closed"]["segments_left"]:
                bad.append(f"(b) {dispatch} rank {r}: close(): {rk['closed']}")
        equal = []
        for e in range(2):
            ps = [torch.load(os.path.join(root, f"svc_{dispatch}_e{e}_rank{r}.pt"),
                             map_location="cpu") for r in range(world)]
            equal.append(all(torch.equal(ps[0][k], q[k]) for q in ps[1:] for k in ps[0]))
        out[f"{dispatch}_replicas_bit_equal"] = equal
        if not all(equal):
            bad.append(f"(b) {dispatch}: the ranks' parameters differ after an epoch: {equal}")
    seeds = [np.load(os.path.join(root, f"svc_one2all_seeds_rank{r}.npy"), allow_pickle=True)
             for r in range(world)]
    makeup = (world * ranks[0]["one2all"]["lockstep_steps"]
              - -(-n_train // cfg.sampler.batch_size)) * cfg.sampler.batch_size
    shared_seeds = []
    for e in range(2):
        mine = [s[e] for s in seeds]
        shared_seeds.append(len(np.intersect1d(mine[0], mine[1])))
        if not (np.array_equal(np.unique(np.concatenate(mine)), train)
                and shared_seeds[-1] <= makeup):
            bad.append(f"(b) one2all epoch {e}: the ranks' seeds do not split the train set "
                       f"({shared_seeds[-1]} shared, make-up {makeup})")
    out["one2all_shared_seeds"] = shared_seeds
    out["one2all_makeup_seeds"] = makeup
    out["seconds"] = time.perf_counter() - t_phase
    return out, bad


# -- cli and bench: the training CLI and the port of bench.py ------------------
# the summary keys of the JAX package's Trainer.summary() (pagraph_tpu/train/loop.py:657)
# and the ones its DataParallelTrainer adds
CLI_SUMMARY_KEYS = ("epochs", "mean_epoch_time_s", "final_loss", "final_acc", "miss_rate",
                    "val_acc", "phase_timers")
CLI_DP_KEYS = ("num_devices", "num_processes", "edges_per_epoch", "first_loss", "halo_drops")
# the main path at bench.py's width through the training CLI (the cache auto-sized)
CLI_ARGV = ["--arch", "graphsage", "--agg", "mean", "--n-layers", "1", "--n-hidden", "16",
            "--batch-size", "6000", "--num-neighbors", "2", "--lr", "0.01", "--epochs", "2",
            "--json"]
CLI_EPOCHS = 2
# where the cli phase saves the dataset and its host run's one checkpoint
# (epoch 1), which the cli_tools phase reads
CLI_DATASET, CLI_CKPT = "cli_dataset", "ck"
# the checkpoint's model flags, for eval and infer
CLI_MODEL_ARGV = ["--arch", "graphsage", "--agg", "mean", "--n-layers", "1", "--n-hidden", "16"]
# bench.py's build_result schema (bench.py:262-296) with both paths run, plus the card
BENCH_LINE_KEYS = ("metric", "value", "unit", "vs_baseline", "detail")
BENCH_DETAIL_KEYS = ("workload", "epoch_time_s", "epochs_per_hr", "cache_hit_rate",
                     "host_pipeline_edges_per_s", "on_device_edges_per_s", "device",
                     "power_limit_w")
HOST_STEP = {"assemble_f32": 1, "block_gather_fwd_mean": 2, "block_gather_bwd_mean": 1}


@contextlib.contextmanager
def trainers_trained(Trainer):
    """Every Trainer whose ``train`` runs inside the block, in order (the CLI
    and the bench build their own)."""
    made, train = [], Trainer.train

    def recording(self, *a, **kw):
        made.append(self)
        return train(self, *a, **kw)

    Trainer.train = recording
    try:
        yield made
    finally:
        Trainer.train = train


@contextlib.contextmanager
def budget_calls(torch, cache_mod, platform):
    """Each ``free_hbm_bytes`` call the cache makes inside the block: what it
    returned, the JAX package's arithmetic on ``device_memory_stats``, and
    the free bytes ``mem_get_info`` reports, each less the reserve."""
    calls, real = [], cache_mod.free_hbm_bytes

    def recording(device=None, reserve=1 << 30):
        s = platform.device_memory_stats(device)
        free = torch.cuda.mem_get_info(device)[0]
        got = real(device, reserve=reserve)
        calls.append({"free_hbm_bytes": got, "reserve": reserve,
                      "jax_arithmetic": max(0, s["bytes_limit"] - s["bytes_in_use"] - reserve),
                      "mem_get_info_less_reserve": max(0, free - reserve)})
        return got

    cache_mod.free_hbm_bytes = recording
    try:
        yield calls
    finally:
        cache_mod.free_hbm_bytes = real


def cli_save_dataset(ds, root: str) -> str:
    """The dataset in the CLIs' directory layout (``data.formats``)."""
    from pagraph_tpu_torch.data.formats import save_dataset

    path = os.path.join(root, CLI_DATASET)
    save_dataset(path, ds)
    return path


def trained_launches(gk, tr, per_step: dict, steps: int):
    """The launches a trainer's run made since the counters' reset (eager ones
    plus its graphs' replays) and what ``per_step`` over ``steps`` asks."""
    runner = tr.epoch_runner if tr._device_mode else tr.group_graphs
    counts = {k: v for k, v in executed_launches(gk.launch_counts(), runner).items() if v}
    return counts, {k: v * steps for k, v in per_step.items()}


def cli_phase(env, root: str):
    """The ``cli`` phase: the dataset saved in the CLIs' layout, then
    ``cli.train.main`` at the bench width with ``--profile-dir``, on the host
    path (with one checkpoint, epoch 1, for ``cli_tools``) and with
    ``--on-device``."""
    import io

    from pagraph_tpu_torch.cli import train as cli_train
    from pagraph_tpu_torch.storage import cache as cache_mod
    from pagraph_tpu_torch.utils import platform

    torch, gk, ds = env.torch, env.gk, env.ds
    t_phase = time.perf_counter()
    out, bad = {}, []
    t0 = time.perf_counter()
    ds_dir = cli_save_dataset(ds, root)
    out["save_dataset_s"] = time.perf_counter() - t0
    for label, extra, per_step, kernels in (
            ("host", ["--ckpt-dir", os.path.join(root, CLI_CKPT), "--ckpt-every",
                      str(CLI_EPOCHS)],
             HOST_STEP, ("block_gather_fwd_kernel", "assemble_kernel")),
            ("on_device", ["--on-device"], DEVICE_STEP,
             ("assemble_kernel", "dropout_block_fwd_kernel", "dropout_block_bwd_kernel"))):
        prof = os.path.join(root, f"profile_{label}")
        gc.collect()
        torch.cuda.empty_cache()
        buf = io.StringIO()
        gk.reset_launch_counts()
        t0 = time.perf_counter()
        with trainers_trained(env.Trainer) as made, \
                budget_calls(torch, cache_mod, platform) as budgets, \
                contextlib.redirect_stdout(buf):
            summary = cli_train.main(CLI_ARGV + ["--dataset", ds_dir, "--profile-dir", prof]
                                     + extra)
        wall = time.perf_counter() - t0
        tr = made[0]
        steps = sum(m.num_batches for m in tr.epoch_metrics)
        counts, want = trained_launches(gk, tr, per_step, steps)
        lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
        line = json.loads(lines[-1]) if lines else {}
        traces = sorted(os.listdir(prof)) if os.path.isdir(prof) else []
        text = ""
        if traces:
            with open(os.path.join(prof, traces[0])) as f:
                text = f.read()
        named = [k for k in ("block_gather_fwd_kernel", "block_gather_bwd_kernel",
                             "assemble_kernel", "dropout_block_fwd_kernel",
                             "dropout_block_bwd_kernel") if k in text]
        row_bytes = tr.cache.total_dim * tr.cache.row_dtype.itemsize
        row = {"seconds": wall, "summary": summary, "line_keys": sorted(line),
               "steps": steps, "launches": counts, "launches_per_step": sum(counts.values())
               / max(steps, 1), "trace_files": traces, "trace_bytes": len(text),
               "trace_names_kernels": named, "cache_capacity": tr.cache.capacity,
               "budget_calls": budgets,
               "epochs": epoch_rows(tr.epoch_metrics)}
        out[label] = row
        where = f"cli {label}"
        if set(summary) != set(CLI_SUMMARY_KEYS) or set(line) != set(CLI_SUMMARY_KEYS) - {
                "phase_timers"}:
            bad.append(f"{where}: summary keys {sorted(summary)}, line keys {sorted(line)}")
        if summary["epochs"] != CLI_EPOCHS or not math.isfinite(summary["final_loss"]):
            bad.append(f"{where}: {summary['epochs']} epochs, final loss "
                       f"{summary['final_loss']}")
        if counts != want:
            bad.append(f"{where}: launches {counts} over {steps} steps, expected "
                       f"{per_step} a step")
        if len(traces) != 1 or any(k not in named for k in kernels):
            bad.append(f"{where}: trace files {traces} name {named}, not all of {kernels}")
        if label == "host":
            b = budgets[0] if len(budgets) == 1 else {}
            sized = min(ds.num_nodes, b.get("free_hbm_bytes", -1) // row_bytes)
            if not (b and b["free_hbm_bytes"] == b["jax_arithmetic"]
                    == b["mem_get_info_less_reserve"] and tr.cache.capacity == sized):
                bad.append(f"{where}: the cache (capacity {tr.cache.capacity}) did not size "
                           f"itself from free_hbm_bytes: {budgets}")
        del tr, made
    out["seconds"] = time.perf_counter() - t_phase
    return out, bad


def run_cli(torch, gk, main, argv):
    """``main(argv)`` with its standard output captured and the kernels'
    launches counted from 0: ``{"ret", "line" (its last JSON line), "code"
    (a ``SystemExit``'s, else 0), "seconds", "launches"}``."""
    import io

    gc.collect()
    torch.cuda.empty_cache()
    gk.reset_launch_counts()
    buf, ret, code = io.StringIO(), None, 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        try:
            ret = main(argv)
        except SystemExit as e:
            code = e.code
    torch.cuda.synchronize()
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return {"ret": ret, "line": lines[-1] if lines else None, "code": code,
            "seconds": time.perf_counter() - t0,
            "launches": {k: v for k, v in gk.launch_counts().items() if v}}


def replay_miss_rate(np, ds, sampler_cfg, capacity: int) -> float:
    """The miss rate of one epoch of a ``NeighborSampler`` over ``ds`` against
    the ``capacity`` vertices of highest out-degree (the cache's ranking),
    counted here in numpy."""
    from pagraph_tpu_torch.sampling.sampler import NeighborSampler

    s = NeighborSampler(ds.graph, ds.train_nids, sampler_cfg, labels=ds.labels)
    cached = np.zeros(ds.num_nodes, dtype=bool)
    cached[np.argsort(-ds.graph.out_degrees, kind="stable")[:capacity]] = True
    tries = misses = 0
    for mb in s.epoch():
        ids = np.asarray(mb.input_nids)[np.asarray(mb.input_mask)]
        tries += len(ids)
        misses += int((~cached[ids]).sum())
    return misses / tries


def cli_tools_phase(env, root: str):
    """The ``cli_tools`` phase: ``eval``, ``infer`` and ``analyze`` over the
    ``cli`` phase's dataset and checkpoint in ``root`` (RMAT-20, the bench
    width), then ``preprocess``, ``convert``, ``partition`` and
    ``verify_partition`` on an RMAT-16 dataset of their own."""
    from pagraph_tpu_torch import SamplerConfig
    from pagraph_tpu_torch.cli import analyze, convert, infer, partition, preprocess
    from pagraph_tpu_torch.cli import eval as cli_eval
    from pagraph_tpu_torch.cli import verify_partition
    from pagraph_tpu_torch.data.formats import load_dataset

    np, torch, gk, ds = env.np, env.torch, env.gk, env.ds
    t_phase = time.perf_counter()
    bad, runs = [], {}
    ds_dir = os.path.join(root, CLI_DATASET)
    base = CLI_MODEL_ARGV + ["--dataset", ds_dir, "--ckpt-dir", os.path.join(root, CLI_CKPT)]

    def run(label, main, argv):
        r = runs[label] = run_cli(torch, gk, main, argv)
        if r["code"]:
            bad.append(f"{label}: exit code {r['code']}")
        return r

    # eval at its default --backend auto: RMAT-20's edges take the device
    ev = run("eval", cli_eval.main, base)
    results = ev["ret"] or {}
    if list(results) != [CLI_EPOCHS - 1] or not 0.0 <= results[CLI_EPOCHS - 1] <= 1.0:
        bad.append(f"eval: results {results}")
    if ev["launches"].get("gather_reduce_sum", 0) <= 0:
        bad.append(f"eval --backend auto ran no window reduction: {ev['launches']}")

    # infer on each backend, the logits saved
    logits, preds = {}, {}
    for backend in ("device", "host"):
        path = os.path.join(root, f"preds_{backend}.npy")
        r = run(f"infer_{backend}", infer.main,
                base + ["--backend", backend, "--out", path, "--save-logits"])
        logits[backend] = np.load(path + ".logits.npy")
        preds[backend] = np.load(path)
        # the CLIs read the class count from the labels, as JAX's do
        want = (ds.num_nodes, ds.num_classes)
        if not (logits[backend].shape == want and np.isfinite(logits[backend]).all()):
            bad.append(f"infer {backend}: logits {logits[backend].shape}, not finite or "
                       f"not {list(want)}")
        if not np.array_equal(preds[backend], logits[backend].argmax(axis=1)):
            bad.append(f"infer {backend}: preds are not the logits' argmax")
    scale = 1.0 + np.abs(logits["host"]).max(axis=1, keepdims=True)
    row_diff = float((np.abs(logits["device"] - logits["host"]) / scale).max())
    if not row_diff <= 1e-4:
        bad.append(f"infer: device logits {row_diff} from the host's (row-max scaled)")
    dev_launches, host_launches = runs["infer_device"]["launches"], runs["infer_host"]["launches"]
    if dev_launches.get("gather_reduce_sum", 0) <= 0:
        bad.append(f"infer --backend device launched no gather_reduce_sum: {dev_launches}")
    if any(k.startswith("gather_reduce") for k in host_launches):
        bad.append(f"infer --backend host launched a window reduction: {host_launches}")
    summary = runs["infer_device"]["ret"] or {}
    test = np.asarray(ds.test_mask, dtype=bool)
    test_acc = float((preds["device"][test] == ds.labels[test]).mean())
    eval_acc = results.get(CLI_EPOCHS - 1, -1.0)
    if not (summary.get("epoch") == CLI_EPOCHS - 1 and summary.get("test_acc") == test_acc
            and abs(eval_acc - test_acc) <= 1e-4):
        bad.append(f"infer device summary {summary}, its preds' test accuracy {test_acc}, "
                   f"eval's {eval_acc}")

    # analyze: the host commands, then load-break on the card at an empty cache and at 40%
    capacity = int(ds.num_nodes * 0.4)
    cv = run("count_vnum", analyze.main, ["count-vnum", "--dataset", ds_dir])["line"] or {}
    co = run("cache_oracle", analyze.main, ["cache-oracle", "--dataset", ds_dir])["line"] or {}
    lb = {str(c): run(f"load_break_{c}", analyze.main,
                      ["load-break", "--dataset", ds_dir, "--cache-capacity", str(c)])["line"]
          or {} for c in (0, capacity)}
    batches = -(-len(ds.train_nids) // 6000)
    if not (cv.get("batches") == batches and cv.get("vertices_per_epoch", 0) > 0
            and cv.get("edges_per_epoch", 0) > 0):
        bad.append(f"count-vnum: {cv}")
    if not 0.0 <= co.get("degree_ranked_hit_rate", -1) <= co.get("oracle_hit_rate", -1) <= 1.0:
        bad.append(f"cache-oracle: {co}")
    empty, at40 = lb["0"], lb[str(capacity)]
    if not (empty.get("miss_rate") == 1.0 and empty.get("h2d_ms", 0) > 0
            and empty.get("batches") == at40.get("batches") == batches):
        bad.append(f"load-break at capacity 0: {empty}")
    # load-break at 40% is held to a numpy replay of its own batches; the
    # train phase's epoch 0 is printed beside it but is another permutation
    # (its Trainer probed its caps first, drawing 8 batch seeds from the
    # sampler's generator)
    replay = replay_miss_rate(
        np, ds, SamplerConfig(batch_size=6000, fanout=2, num_hops=2, seed=0), capacity)
    if at40.get("miss_rate") != replay:
        bad.append(f"load-break at {capacity}: miss rate {at40.get('miss_rate')}, its "
                   f"batches' replay {replay}")

    # the offline tools on RMAT-16
    r16, conv = os.path.join(root, "rmat16"), os.path.join(root, "rmat16_npz")
    run("preprocess", preprocess.main, ["--out", r16, "--gen", "rmat", "--scale", "16",
                                        "--feat-size", "100", "--num-classes", "47"])
    run("convert", convert.main, ["--out", conv, "--from-npz", os.path.join(r16, "adj.npz")])
    a, b = load_dataset(r16), load_dataset(conv)
    unequal = [name for name, x, y in (
        ("indptr", a.graph.indptr, b.graph.indptr), ("indices", a.graph.indices, b.graph.indices),
        ("features", a.features, b.features), ("labels", a.labels, b.labels),
        ("train", a.train_mask, b.train_mask), ("val", a.val_mask, b.val_mask),
        ("test", a.test_mask, b.test_mask)) if not np.array_equal(x, y)]
    if unequal or a.num_nodes != 1 << 16:
        bad.append(f"convert --from-npz round trip: {a.num_nodes} vertices, unequal {unequal}")
    part_argv = ["--dataset", r16, "--method", "dg", "--partition", "2", "--num-hops", "2"]
    stats = run("partition", partition.main, part_argv + ["--assign-backend", "native"])["line"]
    verify = run("verify_partition", verify_partition.main, part_argv)["line"] or {}
    if not (stats or {}).get("num_parts") == 2:
        bad.append(f"partition: {stats}")
    if not (verify.get("coverage_ok") and len(verify.get("partitions", [])) == 2
            and all(p["ok"] for p in verify["partitions"])):
        bad.append(f"verify_partition: {verify}")

    out = {
        "seconds": {k: r["seconds"] for k, r in runs.items()},
        "eval": {"results": results, "launches": ev["launches"]},
        "infer": {"device_s": runs["infer_device"]["seconds"],
                  "host_s": runs["infer_host"]["seconds"],
                  "max_row_rel_diff": row_diff, "device_launches": dev_launches,
                  "host_launches": host_launches, "device_summary": summary},
        "analyze": {"count_vnum": cv, "cache_oracle": co, "load_break": lb,
                    "load_break_replay_miss_rate": replay,
                    "train_epoch0_miss_rate": env.train_miss_rate},
        "partition": stats, "verify_partition": verify,
        "convert_round_trip_equal": not unequal,
        "phase_seconds": time.perf_counter() - t_phase,
    }
    return out, bad


def bench_phase(env):
    """The ``bench`` phase: ``bench_torch.run`` for ``full`` (with the
    hit-path probe) and ``device`` on the teacher-labelled graph at 2 epochs
    each, then ``build_result``."""
    import importlib.util

    torch, gk = env.torch, env.gk
    spec = importlib.util.spec_from_file_location("bench_torch",
                                                  os.path.join(HERE, "bench_torch.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    t_phase = time.perf_counter()
    out, bad, runs = {}, [], {}
    for label, kw, per_step in (("full", dict(hit_probe=True), HOST_STEP),
                                ("device", dict(on_device=True), DEVICE_STEP)):
        gc.collect()
        torch.cuda.empty_cache()
        gk.reset_launch_counts()
        t0 = time.perf_counter()
        with trainers_trained(env.Trainer) as made:
            runs[label] = bench.run(env.ds_nb, cache_enabled=True, epochs=2, **kw)
        tr = made[0]
        # the host run's steps include the probe's replays: the train state counts both
        steps = (sum(m.num_batches for m in tr.epoch_metrics) if tr._device_mode
                 else tr.state.step)
        counts, want = trained_launches(gk, tr, per_step, steps)
        out[label] = {**runs[label], "seconds": time.perf_counter() - t0, "steps": steps,
                      "launches": counts}
        if counts != want:
            bad.append(f"bench {label}: launches {counts} over {steps} steps, expected "
                       f"{per_step} a step")
        del tr, made
    line = bench.build_result(env.ds_nb, None, None, runs["full"], runs["device"],
                              bench.card_identity())
    out["line"] = line
    probe = runs["full"].get("probe", {})
    if (set(line) != set(BENCH_LINE_KEYS) or set(line["detail"]) != set(BENCH_DETAIL_KEYS)
            or not (math.isfinite(line["value"]) and line["value"] > 0)):
        bad.append(f"bench: line keys {sorted(line)} / {sorted(line['detail'])}, value "
                   f"{line['value']}")
    for label, r in runs.items():
        if not (math.isfinite(r["edges_per_s"]) and r["edges_per_s"] > 0):
            bad.append(f"bench {label}: edges_per_s {r['edges_per_s']}")
    if not (probe.get("hit_step_ms") or 0) > 0:
        bad.append(f"bench full: hit-path probe {probe}")
    out["seconds"] = time.perf_counter() - t_phase
    return out, bad


def cli_partition_ranks(env, root: str, world: int):
    """``cli.train --partition <world>`` on ``nccl``, one rank a card: rank
    0's summary, its data-parallel keys, the world size and a finite loss."""
    import io

    from pagraph_tpu_torch.cli import train as cli_train

    ds_dir = cli_save_dataset(env.ds, root)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        summary = cli_train.main(CLI_ARGV + ["--dataset", ds_dir, "--partition", str(world),
                                             "--partition-method", "hash"])
    out = {"seconds": time.perf_counter() - t0, "summary": summary}
    bad = []
    if (set(summary) != set(CLI_SUMMARY_KEYS) | set(CLI_DP_KEYS)
            or summary["num_devices"] != world or not math.isfinite(summary["final_loss"])):
        bad.append(f"cli --partition {world}: {summary}")
    return out, bad


def dp_gpus_main(world: int) -> None:
    """``python3 chip_smoke.py --dp-gpus N``: the dp phase's ranks across N
    cards on ``nccl``, one rank a card (a measurement of its own; the run
    with no arguments needs one card): the build, RMAT-20, and
    :func:`dp_ranks` over an N-way hash partition (host and on-device
    epochs, epoch 1 replayed from CUDA graphs with the NCCL all-reduces
    inside), then :func:`halo_ranks` (the ``ici`` host, ``ici`` device and
    ``edge`` device runs, their all_to_alls inside the graphs too), then the
    training CLI with ``--partition N`` (:func:`cli_partition_ranks`); its
    ``dp_gpus`` line, then the last line as :func:`main`'s."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        fail(f"--dp-gpus {world} needs {world} CUDA cards")
    try:
        import numpy as np

        from pagraph_tpu_torch import partition
        from pagraph_tpu_torch.data import formats, synthetic
        from pagraph_tpu_torch.data.formats import Dataset
        from pagraph_tpu_torch.graph import CSRGraph
        from pagraph_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the repository root")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    print("\n".join(smi), flush=True)
    t0 = time.perf_counter()
    _build.load("gather_kernels")
    build_s = time.perf_counter() - t0
    ds = build_dataset(np, synthetic, Dataset, CSRGraph)
    env = types.SimpleNamespace(torch=torch, ds=ds, partition=partition, formats=formats)
    with tempfile.TemporaryDirectory() as root:
        dp_save_dataset(np, ds, root)
        out, bad = dp_ranks(env, root, world, "nccl", f"({world} cards)")
        halo, more = halo_ranks(env, root, world, "nccl", f"(halo, {world} cards)")
        bad.extend(more)
        cli, more = cli_partition_ranks(env, root, world)
    out.update(nvidia_smi=smi, build_s=build_s, halo=halo, cli=cli)
    bad.extend(more)
    emit("dp_gpus", out)
    if bad:
        fail("dp_gpus: " + "; ".join(bad))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


def build_dataset(np, synthetic, Dataset, CSRGraph):
    """The bench.py graph: RMAT scale 20, edge factor 16, seed 42; 100-dim
    uniform features and 47-class labels argmax(feats @ proj) (seed 7);
    random 65/10/25 split (seed 11)."""
    graph = CSRGraph.from_coo(synthetic.rmat_coo(20, 16, seed=42))
    rng = np.random.default_rng(7)
    feats = rng.random((graph.num_nodes, 100), dtype=np.float32)
    proj = rng.normal(size=(100, 47)).astype(np.float32)
    labels = np.argmax(feats @ proj, axis=1).astype(np.int64)
    train, val, test = synthetic.random_split_masks(graph.num_nodes, seed=11)
    return Dataset(graph, feats, labels, train, val, test)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    try:
        import numpy as np

        import pagraph_tpu_torch as pt
        from pagraph_tpu_torch.data import synthetic
        from pagraph_tpu_torch.data.formats import Dataset
        from pagraph_tpu_torch.graph import CSRGraph
        from pagraph_tpu_torch.ops import _build
        from pagraph_tpu_torch.ops import gather_kernels as gk
        from pagraph_tpu_torch.ops.gather import take_rows
        from pagraph_tpu_torch.sampling.device_sampler import (DeviceCSR, hop_draws,
                                                               hop_sizes,
                                                               sample_minibatch_device)
        from pagraph_tpu_torch.models.inference import (_BucketedNeighborhoods, evaluate,
                                                        full_graph_logits)
        from pagraph_tpu_torch.models.mlp_probe import mlp_val_acc
        from pagraph_tpu_torch.storage.feature_store import (FeatureStore, build_prequantized,
                                                             quantize_store)
        from pagraph_tpu_torch import partition
        from pagraph_tpu_torch.data import formats
        from pagraph_tpu_torch.train.checkpoint import list_checkpoints, save_checkpoint
        from pagraph_tpu_torch.ops.aggregate import block_gather
        from pagraph_tpu_torch.sampling.block import Block
        from pagraph_tpu_torch.sampling.pack import PackedGroup
        from pagraph_tpu_torch.train.device_epoch import (DeviceEpochRunner,
                                                          EpochAccumulator,
                                                          device_batch_step,
                                                          epoch_schedule, fetch_batch,
                                                          make_device_step_fns,
                                                          train_batch)
        from pagraph_tpu_torch.train.loop import Trainer
        from pagraph_tpu_torch.train.state import (CapturedGraph, TrainState,
                                                   make_multistep_train_step,
                                                   make_optimizer, train_step)
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the repository root")
    if os.path.dirname(os.path.abspath(pt.__file__)) != os.path.join(HERE, "pagraph_tpu_torch"):
        fail(f"imported {pt.__file__}, not the package beside this script")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- device -------------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    smi_name, smi_power = (s.strip() for s in smi.split(",", 1))
    bw = HBM_BYTES_PER_S["pcie" if "pcie" in kind.lower() else "sxm"]
    emit("device", {"torch_name": kind, "nvidia_smi_name": smi_name,
                    "power_limit": smi_power, "count": torch.cuda.device_count(),
                    "hbm_bytes_per_s_for_bound": bw})

    # -- build --------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load("gather_kernels")
    emit("build", {"seconds": time.perf_counter() - t0,
                   "flags": " ".join(_build.NVCC_FLAGS)})

    kernel_env = types.SimpleNamespace(
        torch=torch, gk=gk, pt=pt, dev=dev, synthetic=synthetic, Trainer=Trainer,
        flush=torch.empty(64 << 20, dtype=torch.uint8, device=dev))
    # -- gat_attention: GAT's attention kernels, the cell's model's launches --
    if sys.argv[1:2] != ["--dropout-bits"]:
        gat_attention_phase(kernel_env, bw)
    if sys.argv[1:2] == ["--gat-attention"]:
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}),
              flush=True)
        return

    # -- dropout_block: the fused dropout block's draws, kernels, launches ----
    if sys.argv[1:2] != ["--dropout-bits"]:
        dropout_block_phase(kernel_env, bw)
    # -- dropout_bits: the keep-mask kernel against torch.randint --------------
    dropout_bits_phase(kernel_env, bw)
    if sys.argv[1:2] in (["--dropout-block"], ["--dropout-bits"]):
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}),
              flush=True)
        return

    # -- train: the main path -----------------------------------------------
    t0 = time.perf_counter()
    ds = build_dataset(np, synthetic, Dataset, CSRGraph)
    data_s = time.perf_counter() - t0

    def config(aggregator: str, cache_dtype: str = "float32", *, on_device: bool = False,
               paired: bool = False, compute: str = "float32", dispatch: str = "scan",
               cosine_steps: int = 0):
        """The main path's configuration; ``on_device`` is the whole-epoch
        device path (full cache, ``paired`` draws, ``dispatch`` its
        ``train.epoch_dispatch``); ``compute`` is ``train.dtype``;
        ``cosine_steps`` > 0 the cosine schedule over that many updates."""
        return pt.Config(
            model=pt.ModelConfig(arch="graphsage", n_layers=1, hidden=16,
                                 feat_dim=100, n_classes=47,
                                 aggregator=aggregator, dropout=0.2),
            sampler=pt.SamplerConfig(batch_size=6000, fanout=2, num_hops=2,
                                     seed=0, prefetch=3, paired_draws=paired),
            cache=pt.CacheConfig(enabled=True,
                                 capacity=None if on_device else int(ds.num_nodes * 0.4),
                                 dtype=cache_dtype),
            train=pt.TrainConfig(lr=1e-2, warmup_epochs=1, on_device_sampling=on_device,
                                 dtype=compute, epoch_dispatch=dispatch,
                                 lr_schedule="cosine" if cosine_steps else "none",
                                 lr_decay_steps=cosine_steps),
        )

    def free_memory():
        gc.collect()
        torch.cuda.empty_cache()

    def host_step_ms(t_, runs):
        """Host enqueue ms a step of a host Trainer (its ``"step"`` timer
        over the steps of ``runs``: the dispatch of a group, its H2D copy
        included; a capture is timed apart)."""
        return t_.timers.total["step"] * 1e3 / sum(m.num_batches for m in runs)

    cfg = config("mean")
    t0 = time.perf_counter()
    tr = Trainer.from_dataset(cfg, ds, seed=0)
    tr._maybe_fill_cache()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    gk.reset_launch_counts()
    epochs = [tr.run_epoch(e) for e in range(2)]
    torch.cuda.synchronize()
    launches = executed_launches(gk.launch_counts(), tr.group_graphs)
    main_keys = ("assemble_f32", "block_gather_fwd_mean", "block_gather_bwd_mean")
    train_out = {
        "graph": {"vertices": ds.num_nodes, "edges": ds.graph.num_edges},
        "caps": list(tr.sampler.caps), "cache_capacity": tr.cache.capacity,
        "sampler_backend": tr.sampler.backend_name,
        "steps_per_dispatch": tr.steps_per_dispatch,
        "graphs": len(tr.group_graphs.graphs), "capture_s": tr.timers.total["capture"],
        "dataset_s": data_s, "setup_s": setup_s,
        "epochs": [{"epoch": m.epoch, "time_s": m.time_s,
                    "edges": m.edges, "edges_per_s": m.edges / m.time_s,
                    "miss_rate": m.miss_rate, "mean_loss": m.mean_loss,
                    "mean_acc": m.mean_acc, "batches": m.num_batches,
                    "h2d_bytes": m.h2d_bytes} for m in epochs],
        "step_host_ms": host_step_ms(tr, epochs),
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
    }
    gk.reset_launch_counts()
    tr_gcn = Trainer.from_dataset(config("gcn"), ds, seed=0)
    gcn_epoch = tr_gcn.run_epoch(0)
    torch.cuda.synchronize()
    gcn_launches = gk.launch_counts()
    del tr_gcn
    train_out["gcn_epoch"] = {"time_s": gcn_epoch.time_s,
                              "mean_loss": gcn_epoch.mean_loss,
                              "miss_rate": gcn_epoch.miss_rate,
                              "launches": gcn_launches}
    emit("train", train_out)
    for k in main_keys:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the main path")
    for k in ("block_gather_fwd_sum", "block_gather_bwd_sum"):
        if gcn_launches[k] <= 0:
            fail(f"kernel {k} was not launched by the gcn-aggregator run")
    losses = [m.mean_loss for m in epochs] + [gcn_epoch.mean_loss]
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite loss {losses}")
    if not epochs[1].mean_loss < epochs[0].mean_loss:
        fail(f"loss did not fall: {epochs[0].mean_loss} -> {epochs[1].mean_loss}")

    # -- tiers: one epoch at each cache tier, each a fresh Trainer -------------
    tier_tr, tier_launches, tiers_out = {}, {}, {}
    for dtype, tag in TIERS.items():
        t0 = time.perf_counter()
        t_tr = Trainer.from_dataset(config("mean", dtype), ds, seed=0)
        t_tr._maybe_fill_cache()
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        gk.reset_launch_counts()
        m = t_tr.run_epoch(0)
        torch.cuda.synchronize()
        counts = gk.launch_counts()
        cv_t = t_tr.cache.cache_values
        tier_tr[dtype], tier_launches[dtype] = t_tr, counts
        tiers_out[dtype] = {
            "setup_s": t_setup, "time_s": m.time_s, "edges": m.edges,
            "edges_per_s": m.edges / m.time_s,
            "miss_rate": m.miss_rate, "mean_loss": m.mean_loss, "batches": m.num_batches,
            "h2d_bytes": m.h2d_bytes, "cache_dtype": str(cv_t.dtype),
            "cache_bytes": cv_t.numel() * cv_t.element_size(),
            "launches": {k: v for k, v in counts.items() if v},
            "launches_per_step": sum(counts.values()) / max(m.num_batches, 1)}
    emit("tiers", tiers_out)
    for dtype, tag in TIERS.items():
        t, counts = tiers_out[dtype], tier_launches[dtype]
        if t["miss_rate"] != epochs[0].miss_rate:
            fail(f"{dtype} tier: miss rate {t['miss_rate']} != the f32 run's "
                 f"{epochs[0].miss_rate} on the same batches")
        if not math.isfinite(t["mean_loss"]):
            fail(f"{dtype} tier: non-finite loss {t['mean_loss']}")
        if sum(counts.values()) != 4 * t["batches"] or counts[f"assemble_{tag}"] != t["batches"]:
            fail(f"{dtype} tier: launches {t['launches']} over {t['batches']} steps, "
                 "expected 4 a step with one assemble_" + tag)

    # -- bf16_train: the host path at bf16 compute -------------------------------
    # train.dtype="bfloat16" with the bf16 cache tier at 40%: 2 epochs of the
    # mean aggregator, then one epoch of gcn (the sum kind) over the f32 tier
    # (the assembly from f32 rows to bf16); 5 launches a step, all bf16 (the
    # backward's C call adds in an f32 table and rounds it: grad_to_bf16)
    bf_cfg = config("mean", "bfloat16", compute="bfloat16")
    t0 = time.perf_counter()
    bf_tr = Trainer.from_dataset(bf_cfg, ds, seed=0)
    bf_tr._maybe_fill_cache()
    torch.cuda.synchronize()
    bf_setup = time.perf_counter() - t0
    gk.reset_launch_counts()
    bf_epochs = [bf_tr.run_epoch(e) for e in range(2)]
    torch.cuda.synchronize()
    bf_launches = executed_launches(gk.launch_counts(), bf_tr.group_graphs)
    gk.reset_launch_counts()
    bf_gcn_tr = Trainer.from_dataset(config("gcn", "float32", compute="bfloat16"), ds, seed=0)
    bf_gcn_epoch = bf_gcn_tr.run_epoch(0)
    torch.cuda.synchronize()
    bf_gcn_launches = gk.launch_counts()
    del bf_gcn_tr
    bf_out = {
        "compute": "bfloat16", "cache_dtype": "bfloat16", "setup_s": bf_setup,
        "epochs": [{"epoch": m.epoch, "time_s": m.time_s, "edges": m.edges,
                    "edges_per_s": m.edges / m.time_s, "miss_rate": m.miss_rate,
                    "mean_loss": m.mean_loss, "mean_acc": m.mean_acc,
                    "batches": m.num_batches, "h2d_bytes": m.h2d_bytes} for m in bf_epochs],
        "step_host_ms": host_step_ms(bf_tr, bf_epochs),
        "launches": {k: v for k, v in bf_launches.items() if v},
        "launches_per_step": sum(bf_launches.values()) / sum(m.num_batches for m in bf_epochs),
        "gcn_epoch_f32_cache": {"time_s": bf_gcn_epoch.time_s,
                                "mean_loss": bf_gcn_epoch.mean_loss,
                                "miss_rate": bf_gcn_epoch.miss_rate,
                                "launches": {k: v for k, v in bf_gcn_launches.items() if v}},
        "nvidia_smi": smi}
    emit("bf16_train", bf_out)
    for label, counts, runs, want in (
            ("mean, bf16 cache", bf_launches, bf_epochs,
             {"assemble_bf16_to_bf16": 1, "block_gather_fwd_mean_bf16": 2,
              "block_gather_bwd_mean_bf16": 1, "grad_to_bf16": 1}),
            ("gcn, f32 cache", bf_gcn_launches, [bf_gcn_epoch],
             {"assemble_f32_to_bf16": 1, "block_gather_fwd_sum_bf16": 2,
              "block_gather_bwd_sum_bf16": 1, "grad_to_bf16": 1})):
        steps = sum(m.num_batches for m in runs)
        if {k: v for k, v in counts.items() if v} != {k: v * steps for k, v in want.items()}:
            fail(f"bf16 compute ({label}): launches {counts} over {steps} steps, expected "
                 f"{want} a step")
    bf_losses = [m.mean_loss for m in bf_epochs] + [bf_gcn_epoch.mean_loss]
    if not all(math.isfinite(v) for v in bf_losses):
        fail(f"bf16 compute: non-finite loss {bf_losses}")
    if not bf_epochs[1].mean_loss < bf_epochs[0].mean_loss:
        fail(f"bf16 compute: loss did not fall: {bf_epochs[0].mean_loss} -> "
             f"{bf_epochs[1].mean_loss}")
    if bf_epochs[0].miss_rate != epochs[0].miss_rate:
        fail(f"bf16 compute: miss rate {bf_epochs[0].miss_rate} != the f32 run's "
             f"{epochs[0].miss_rate} on the same batches")

    # -- store_int8: the pre-quantized store tier ----------------------------------
    # quantize_store(store) once (what a user's preprocessing does), then a
    # Trainer over it at the int8 cache tier: no scale pass at setup, miss
    # rows gathered as stored.  One epoch at bf16 compute (the assembly from
    # int8 rows to bf16); the loader alone, in turns with the f32 store's
    # int8 trainer from `tiers`
    t0 = time.perf_counter()
    qstore = quantize_store(FeatureStore.build(ds.graph, ds.features))
    quantize_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q_tr = Trainer(config("mean", "int8", compute="bfloat16"), qstore, ds.graph,
                   ds.train_nids, ds.labels, seed=0)
    q_tr._maybe_fill_cache()
    torch.cuda.synchronize()
    q_setup = time.perf_counter() - t0
    gk.reset_launch_counts()
    q_epoch = q_tr.run_epoch(0)
    torch.cuda.synchronize()
    q_launches = gk.launch_counts()
    q_loader_s = {"f32_store": [], "int8_store": []}
    for label, t_ in (("f32_store", tier_tr["int8"]), ("int8_store", q_tr),
                      ("int8_store", q_tr), ("f32_store", tier_tr["int8"])):
        t0 = time.perf_counter()
        sum(1 for _ in t_.loader.epoch())
        torch.cuda.synchronize()
        q_loader_s[label].append(time.perf_counter() - t0)
    q_out = {
        "quantize_store_s": quantize_s, "setup_s": q_setup,
        "f32_store_int8_setup_s": tiers_out["int8"]["setup_s"],
        "epoch": {"compute": "bfloat16", "time_s": q_epoch.time_s, "edges": q_epoch.edges,
                  "edges_per_s": q_epoch.edges / q_epoch.time_s,
                  "miss_rate": q_epoch.miss_rate, "h2d_bytes": q_epoch.h2d_bytes,
                  "mean_loss": q_epoch.mean_loss, "batches": q_epoch.num_batches},
        "f32_store_int8_epoch": {k: tiers_out["int8"][k]
                                 for k in ("time_s", "miss_rate", "h2d_bytes", "mean_loss")},
        "loader_only_epoch_s": q_loader_s,
        "scale_equal": bool((q_tr.cache.dequant_scale
                             == tier_tr["int8"].cache.dequant_scale).all()),
        "cache_rows_equal": torch.equal(q_tr.cache.cache_values,
                                        tier_tr["int8"].cache.cache_values),
        "launches": {k: v for k, v in q_launches.items() if v},
        "nvidia_smi": smi}
    emit("store_int8", q_out)
    if (q_epoch.miss_rate, q_epoch.h2d_bytes) != (tiers_out["int8"]["miss_rate"],
                                                  tiers_out["int8"]["h2d_bytes"]):
        fail(f"int8 store: miss rate {q_epoch.miss_rate} and h2d bytes {q_epoch.h2d_bytes} "
             f"differ from the f32 store's int8 tier {tiers_out['int8']}")
    if not (q_out["scale_equal"] and q_out["cache_rows_equal"]):
        fail("int8 store: its scale or cache rows differ from the f32 store's int8 tier")
    if not math.isfinite(q_epoch.mean_loss):
        fail(f"int8 store: non-finite loss {q_epoch.mean_loss}")
    steps = q_epoch.num_batches
    if {k: v for k, v in q_launches.items() if v} != {
            "assemble_int8_to_bf16": steps, "block_gather_fwd_mean_bf16": 2 * steps,
            "block_gather_bwd_mean_bf16": steps, "grad_to_bf16": steps}:
        fail(f"int8 store: launches {q_out['launches']} over {steps} steps, expected one "
             "assemble_int8_to_bf16, two bf16 block forwards, one bf16 block backward "
             "and one grad_to_bf16")

    # -- host_dispatch: the host path at the JAX package's defaults -------------------
    # backend "auto" (the native sampler) and steps_per_dispatch: the loader
    # alone with each sampler; then fresh Trainers (seed 0) of the chip
    # configuration: K=8 replayed from CUDA graphs (epoch 0 eager), twice the
    # eager form of K=8 (the eager spread), the eager and the graph form of
    # K=1; bf16 compute over the bf16 tier, K=8 replayed and twice eager;
    # cache.rank_by="access_freq" (refilled after epoch 0), K=8 replayed
    # and eager
    omp = {"OMP_NUM_THREADS": os.environ.get("OMP_NUM_THREADS"), "cpu_count": os.cpu_count(),
           "torch_threads": torch.get_num_threads()}

    def host_cfg(k: int, compute: str = "float32", cache_dtype: str = "float32",
                 backend: str = "auto", rank_by: str = "out_degree"):
        c = config("mean", cache_dtype, compute=compute)
        c.train.steps_per_dispatch = k
        c.sampler.backend = backend
        c.cache.rank_by = rank_by
        return c

    def params_of(t_):
        return {n: p.detach().clone() for n, p in t_.state.model.named_parameters()}

    def loader_epoch(t_):
        """One epoch of the host pipeline alone, as the Trainer consumes it
        (sampling, plan, miss gather, pack, the groups stacked in pinned
        memory; nothing crosses to the card): seconds, batches, the bytes
        the groups would ship, the miss rate."""
        t_.cache.reset_stats()
        t0 = time.perf_counter()
        nb = h2d = 0
        for grp in t_.loader.groups(t_.steps_per_dispatch):
            nb, h2d = nb + grp.k, h2d + grp.nbytes
        return {"s": time.perf_counter() - t0, "batches": nb, "h2d_bytes": h2d,
                "miss_rate": t_.cache.miss_rate()}

    def group_device_ms(t_):
        """Device ms a step of one group's dispatch in the form the Trainer
        runs now (its H2D copy included), behind a device sleep that
        outlasts its enqueue: the first group of a further loader epoch,
        one replay; in the eager form its first two batches (eight eager
        steps, some 1,100 launches, would fill the launch queue and block
        the host)."""
        gen = t_.loader.groups(t_.steps_per_dispatch)
        grp = next(gen)
        gen.close()
        graphs = t_.group_graphs if t_.host_graphs else None
        if graphs is not None and graphs.needs_capture(grp):
            graphs.capture(grp, t_._acc)
        if graphs is None:
            grp = PackedGroup(grp.layout, grp.i32[:2], grp.u8[:2], grp.miss[:2])
        eager = make_multistep_train_step(t_.state, t_.cache.cache_values,
                                          t_.cache.dequant_scale_dev)

        def run():
            if graphs is not None:
                graphs(grp, t_._acc)
            else:
                eager(grp, t_._acc)
        run()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(400_000_000)
        ev[1].record()
        t0 = time.perf_counter()
        run()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        return {"device_ms_per_step": ev[1].elapsed_time(ev[2]) / grp.k, "timed_group_k": grp.k,
                "device_time_is_pure": enqueue_ms < ev[0].elapsed_time(ev[1])}

    def group_parity(t_):
        """The first and the last (partial) group of a further loader epoch,
        each dispatched three times from the same state (parameters, Adam's
        state, the dropout generator, the step counts, the accumulator,
        restored in place between): replayed from the Trainer's graph of its
        key, then twice through the eager form.  For each, the relative
        difference of the group's loss sum and the largest
        ||p - p_eager|| / ||p_eager||, replay against eager and eager
        against eager."""
        gen = t_.loader.groups(t_.steps_per_dispatch)
        first = last = next(gen)
        for last in gen:
            pass
        grps = (first, last)
        st, acc = t_.state, t_._acc
        params = list(st.model.parameters())
        graphs = t_.group_graphs
        eager = make_multistep_train_step(st, t_.cache.cache_values,
                                          t_.cache.dequant_scale_dev)
        for grp in (grps[0], grps[-1]):
            if graphs.needs_capture(grp):
                graphs.capture(grp, acc)
        torch.cuda.synchronize()
        snap = ([p.detach().clone() for p in params],
                [{k: v.clone() for k, v in st.optimizer.state[p].items()} for p in params],
                st.generator.get_state(), st.step_t.clone(), st.step, acc.clone())

        def restore():
            with torch.no_grad():
                for p, v, o in zip(params, snap[0], snap[1]):
                    p.copy_(v)
                    for k, t in o.items():
                        st.optimizer.state[p][k].copy_(t)
                st.step_t.copy_(snap[3])
                acc.copy_(snap[5])
            st.generator.set_state(snap[2])
            st.step = snap[4]

        out = {}
        for which, grp in (("first", grps[0]), ("last", grps[-1])):
            results = []
            for form in ("replayed", "eager", "eager_again"):
                restore()
                if form == "replayed":
                    graphs(grp, acc)
                else:
                    eager(grp, acc)
                torch.cuda.synchronize()
                results.append(((acc[0] - snap[5][0]).item(),
                                {n: p.detach().clone()
                                 for n, p in st.model.named_parameters()}))
            (l_r, p_r), (l_e, p_e), (l_e2, p_e2) = results
            out[which] = {"group_key": [grp.k, grp.layout.bucket],
                          "group_loss_sum": [l_r, l_e, l_e2],
                          "loss_rel_diff": {"replay_vs_eager": rel(l_r, l_e),
                                            "eager_vs_eager": rel(l_e2, l_e)},
                          "param_rel_diff": {"replay_vs_eager": param_rel(p_r, p_e),
                                             "eager_vs_eager": param_rel(p_e2, p_e)}}
        restore()
        return out

    def host_run(cfg_h, n_epochs: int, graphs: bool):
        """A fresh Trainer's ``n_epochs`` (the first eager, then the form
        ``graphs`` picks): each epoch's metrics and host enqueue ms a step,
        setup, capture seconds, graphs, the launches run (counted from 0 just
        before), peak device bytes from the run's start, the parameters
        after epoch 1, and the device time a step of one more group; whether
        the cache was refilled (``access_freq``) and the graphs read the
        rows it holds now."""
        free_memory()
        start_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        t_ = Trainer.from_dataset(cfg_h, ds, seed=0)
        t_.host_graphs = graphs
        t_._maybe_fill_cache()
        # held weakly: a reference here would keep a refilled cache's old
        # rows alive and charge them to the run's peak
        first_fill = weakref.ref(t_.cache.cache_values)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        gk.reset_launch_counts()
        ms, eps, params = [], [], None
        for e in range(n_epochs):
            step_s = t_.timers.total["step"]
            ms.append(t_.run_epoch(e))
            m = ms[-1]
            eps.append({"epoch": e, "form": "graphs" if graphs and e else "eager",
                        "time_s": m.time_s, "edges": m.edges,
                        "edges_per_s": m.edges / m.time_s, "batches": m.num_batches,
                        "miss_rate": m.miss_rate, "h2d_bytes": m.h2d_bytes,
                        "mean_loss": m.mean_loss, "mean_acc": m.mean_acc,
                        "enqueue_ms_per_step": (t_.timers.total["step"] - step_s) * 1e3
                        / m.num_batches})
            if e == 1:
                params = params_of(t_)
        torch.cuda.synchronize()
        counts = executed_launches(gk.launch_counts(), t_.group_graphs)
        peak = torch.cuda.max_memory_allocated() - start_bytes
        out = {"k": t_.steps_per_dispatch, "form": "graphs" if graphs else "eager",
               "sampler_backend": t_.sampler.backend_name, "caps": list(t_.sampler.caps),
               "setup_s": setup, "epochs": eps,
               "capture_s": t_.timers.total["capture"],
               "graphs": len(t_.group_graphs.graphs) if t_.group_graphs else 0,
               "graph_keys": ([[k, lay.bucket] for k, lay in t_.group_graphs.keys]
                              if t_.group_graphs else []),
               "launches": {k: v for k, v in counts.items() if v},
               "run_peak_device_bytes": peak,
               "cache_refilled": t_.cache.cache_values is not first_fill(),
               "first_fill_released": first_fill() is None,
               "graphs_read_current_cache": (t_.group_graphs.cache_values
                                             is t_.cache.cache_values
                                             if t_.group_graphs else None),
               "replayed_launches_per_step": (
                   {k: v / sum(m.num_batches for m in ms[1:])
                    for k, v in t_.group_graphs.replayed_launches().items()}
                   if t_.group_graphs else {})}
        out.update(group_device_ms(t_))
        out["device_busy_share"] = (out["device_ms_per_step"] * ms[-1].num_batches / 1e3
                                    / ms[-1].time_s)
        return t_, ms, params, out

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    def param_rel(pa, pb):
        """The largest ||pa - pb|| / ||pb|| over the parameters."""
        return max(((pa[n] - pb[n]).norm() / pb[n].norm().clamp(min=1e-30)).item() for n in pb)

    hd_out, hd_bad = {"omp": omp, "nvidia_smi": smi}, []
    # the loader alone, numpy and native sampler, in turns
    loader_tr = {b: Trainer.from_dataset(host_cfg(8, backend=b), ds, seed=0)
                 for b in ("numpy", "auto")}
    for t_ in loader_tr.values():
        t_._maybe_fill_cache()
    lo = {"numpy": [], "native": []}
    for b in ("numpy", "auto", "auto", "numpy"):
        lo["numpy" if b == "numpy" else "native"].append(loader_epoch(loader_tr[b]))
    hd_out["loader_only"] = {
        "epoch_s": {k: [r["s"] for r in v] for k, v in lo.items()},
        "first_epoch": {k: {f: v[0][f] for f in ("batches", "miss_rate", "h2d_bytes")}
                        for k, v in lo.items()},
        "caps": {k: list(loader_tr[b].sampler.caps) for k, b in (("numpy", "numpy"),
                                                                 ("native", "auto"))},
        "backend": {k: loader_tr[b].sampler.backend_name for k, b in (("numpy", "numpy"),
                                                                      ("native", "auto"))}}
    del loader_tr, t_
    if hd_out["loader_only"]["backend"] != {"numpy": "numpy", "native": "native"}:
        hd_bad.append(f"sampler backends {hd_out['loader_only']['backend']}")

    runs = {}
    for label, cfg_h, n_epochs, graphs in (
            ("f32_k8_graphs", host_cfg(8), 3, True),
            ("f32_k8_eager", host_cfg(8), 2, False),
            ("f32_k8_eager_again", host_cfg(8), 2, False),
            ("f32_k1_eager", host_cfg(1), 2, False),
            ("f32_k1_graphs", host_cfg(1), 2, True),
            ("bf16_k8_graphs", host_cfg(8, "bfloat16", "bfloat16"), 3, True),
            ("bf16_k8_eager", host_cfg(8, "bfloat16", "bfloat16"), 2, False),
            ("bf16_k8_eager_again", host_cfg(8, "bfloat16", "bfloat16"), 2, False),
            ("access_freq_k8_graphs", host_cfg(8, rank_by="access_freq"), 2, True),
            ("access_freq_k8_eager", host_cfg(8, rank_by="access_freq"), 2, False)):
        t_, ms, params, out = host_run(cfg_h, n_epochs, graphs)
        runs[label] = (ms, params)
        hd_out[label] = out
        if graphs and t_.steps_per_dispatch == 8:
            hd_out[label.replace("_graphs", "_group_parity")] = group_parity(t_)
        del t_
    f32_step = {"assemble_f32": 1, "block_gather_fwd_mean": 2, "block_gather_bwd_mean": 1}
    for pre, per_step in (("f32", f32_step),
                          ("bf16", {"assemble_bf16_to_bf16": 1,
                                    "block_gather_fwd_mean_bf16": 2,
                                    "block_gather_bwd_mean_bf16": 1, "grad_to_bf16": 1}),
                          ("access_freq", f32_step)):
        graph_k8, eager_k8 = f"{pre}_k8_graphs", f"{pre}_k8_eager"
        ms_g, p_g = runs[graph_k8]
        ms_e, p_e = runs[eager_k8]
        # the whole runs: their epoch 0 is eager in both.  At f32 the
        # atomics' order in the block backward parts them (reported); at
        # bf16 compute the backward's f32 table is rounded once to bf16,
        # and the replayed run must equal the eager one to the bit
        whole = {"loss_rel_diff": {"replay_vs_eager": [rel(a.mean_loss, b.mean_loss)
                                                       for a, b in zip(ms_g, ms_e)]},
                 "param_rel_diff_after_epoch_1": {"replay_vs_eager": param_rel(p_g, p_e)},
                 "bit_equal": {"losses": [a.mean_loss for a in ms_g[:len(ms_e)]]
                               == [b.mean_loss for b in ms_e],
                               "params": all(torch.equal(p_g[n], p_e[n]) for n in p_e)}}
        if f"{pre}_k8_eager_again" in runs:
            ms_e2, p_e2 = runs[f"{pre}_k8_eager_again"]
            whole["loss_rel_diff"]["eager_vs_eager"] = [rel(a.mean_loss, b.mean_loss)
                                                        for a, b in zip(ms_e2, ms_e)]
            whole["param_rel_diff_after_epoch_1"]["eager_vs_eager"] = param_rel(p_e2, p_e)
        hd_out[f"{pre}_epochs_replay_vs_eager"] = whole
        if pre == "bf16" and whole["bit_equal"] != {"losses": True, "params": True}:
            hd_bad.append(f"bf16: the replayed run is not bit-equal to the eager run: {whole}")
        # one group from the same state: the first (8, bucket) and the
        # last, partial (2, bucket) group of an epoch, each against its graph
        for which, par in hd_out[f"{pre}_k8_group_parity"].items():
            par["bound"] = ("the group's loss within max(1e-6, eager spread) relative, "
                            "every parameter within max(1e-5, eager spread) of its norm")
            for what, tol in (("loss_rel_diff", 1e-6), ("param_rel_diff", 1e-5)):
                got, spread = par[what]["replay_vs_eager"], par[what]["eager_vs_eager"]
                if not got <= max(tol, spread):
                    hd_bad.append(f"{pre}: the {which} group {par['group_key']} replayed "
                                  f"against the eager form from the same state: {what} "
                                  f"{got}, over {tol} and the eager spread {spread}")
        if not ms_g[1].mean_loss < ms_g[0].mean_loss:
            hd_bad.append(f"{pre}: loss did not fall: {ms_g[0].mean_loss} -> "
                          f"{ms_g[1].mean_loss}")
        labels_pre = [k for k in runs if k.startswith(pre + "_")]
        for label in labels_pre:
            out, (ms, _) = hd_out[label], runs[label]
            steps = sum(m.num_batches for m in ms)
            if out["sampler_backend"] != "native":
                hd_bad.append(f"{label}: sampler backend {out['sampler_backend']}")
            if out["launches"] != {k: v * steps for k, v in per_step.items()}:
                hd_bad.append(f"{label}: launches {out['launches']} over {steps} steps, "
                              f"expected {per_step} a step")
            if out["form"] == "graphs" and (out["replayed_launches_per_step"]
                                            != {k: float(v) for k, v in per_step.items()}
                                            or not out["graphs"]):
                hd_bad.append(f"{label}: replayed launches a step "
                              f"{out['replayed_launches_per_step']}, expected {per_step}")
            if out["form"] == "graphs" and not out["graphs_read_current_cache"]:
                hd_bad.append(f"{label}: the graphs do not read the cache's current rows")
            if out["cache_refilled"] != (pre == "access_freq"):
                hd_bad.append(f"{label}: cache refilled: {out['cache_refilled']}")
            if out["cache_refilled"] and not out["first_fill_released"]:
                hd_bad.append(f"{label}: the refill kept the first fill's rows alive")
            if not all(math.isfinite(m.mean_loss) for m in ms):
                hd_bad.append(f"{label}: non-finite loss")
            for m, r in zip(ms, runs[graph_k8][0]):
                if (m.num_batches, m.edges, m.miss_rate) != (r.num_batches, r.edges,
                                                             r.miss_rate):
                    hd_bad.append(f"{label}: epoch {m.epoch} batches/edges/miss rate "
                                  f"{(m.num_batches, m.edges, m.miss_rate)} != the graph "
                                  f"run's {(r.num_batches, r.edges, r.miss_rate)}")
                if "_k8" in label and m.h2d_bytes != r.h2d_bytes:
                    hd_bad.append(f"{label}: epoch {m.epoch} h2d bytes {m.h2d_bytes} != the "
                                  f"graph run's {r.h2d_bytes}")
    # the refill by access frequency moved the miss rate of epoch 1
    af, od = runs["access_freq_k8_graphs"][0], runs["f32_k8_graphs"][0]
    hd_out["access_freq_miss_rate"] = {"access_freq": [m.miss_rate for m in af],
                                       "out_degree": [m.miss_rate for m in od[:2]]}
    if af[0].miss_rate != od[0].miss_rate:
        hd_bad.append("access_freq: epoch 0 (the out-degree fill) missed "
                      f"{af[0].miss_rate}, the out-degree run {od[0].miss_rate}")
    k1 = [runs["f32_k1_eager"][0], runs["f32_k1_graphs"][0]]
    if [m.h2d_bytes for m in k1[0]] != [m.h2d_bytes for m in k1[1]]:
        hd_bad.append("K=1: the eager and the graph run shipped different bytes")
    emit("host_dispatch", hd_out)
    if hd_bad:
        fail("host_dispatch: " + "; ".join(hd_bad))
    del runs

    def host_and_device(fn, reps: int = 20, dev_reps: int = 2):
        """Host enqueue and wall time a call (``reps`` back to back), and
        device time a call behind a ~0.1 s device sleep that outlasts the
        enqueue of ``dev_reps`` calls (few, to stay under the launch queue)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(200_000_000)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(dev_reps):
            fn()
        ev[2].record()
        dev_enqueue = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return {"host_enqueue_ms": enqueue, "wall_ms": wall,
                "device_ms": ev[1].elapsed_time(ev[2]) / dev_reps,
                "device_time_is_pure": dev_enqueue < ev[0].elapsed_time(ev[1]),
                "sleep_ms": ev[0].elapsed_time(ev[1])}

    # -- device_epoch: the whole-epoch on-device path ------------------------
    # each run a fresh Trainer (seed 0) with the full cache and the CSR on the
    # card, 2 epochs: epoch 0 eager, epoch 1 replayed from the CUDA graphs of
    # its epoch_dispatch (every mode driven); launches counted from 0 over its
    # epochs: those counted eagerly plus each graph's captured launches times
    # its replays (the counter counts a captured launch once, at capture)
    def device_run(dispatch: str, dtype: str = "float32", paired: bool = False,
                   compute: str = "float32"):
        key = f"assemble_{TIERS[dtype]}" + ("_to_bf16" if compute == "bfloat16" else "")
        t0 = time.perf_counter()
        d_tr = Trainer.from_dataset(config("mean", dtype, on_device=True, paired=paired,
                                           compute=compute, dispatch=dispatch), ds, seed=0)
        d_tr._maybe_fill_cache()
        torch.cuda.synchronize()
        d_setup = time.perf_counter() - t0
        start_bytes = torch.cuda.memory_allocated()   # earlier phases' tensors included
        torch.cuda.reset_peak_memory_stats()
        gk.reset_launch_counts()
        ms = [d_tr.run_epoch(e) for e in range(2)]
        torch.cuda.synchronize()
        counted = gk.launch_counts()
        counts = executed_launches(counted, d_tr.epoch_runner)
        cv_d = d_tr.cache.cache_values
        timers = d_tr.timers.summary()
        out = {"cache_dtype": dtype, "compute": compute, "paired_draws": paired,
               "epoch_dispatch": dispatch, "setup_s": d_setup,
               "capture_s": timers["capture"]["total_s"],
               "epochs": [{"epoch": m.epoch, "form": "eager" if m.epoch == 0 else "replayed",
                           "time_s": m.time_s, "batches": m.num_batches,
                           "edges": m.edges, "edges_per_s": m.edges / m.time_s,
                           "vertices": m.vertices, "mean_loss": m.mean_loss,
                           "mean_acc": m.mean_acc, "miss_rate": m.miss_rate,
                           "h2d_bytes": m.h2d_bytes} for m in ms],
               "cache_bytes": cv_d.numel() * cv_d.element_size(),
               "csr_bytes": d_tr._dev_csr.nbytes(),
               "peak_device_bytes": torch.cuda.max_memory_allocated(),
               "run_peak_device_bytes": torch.cuda.max_memory_allocated() - start_bytes
               + cv_d.numel() * cv_d.element_size() + d_tr._dev_csr.nbytes(),
               "launches": {k: v for k, v in counts.items() if v},
               "launches_counted": {k: v for k, v in counted.items() if v},
               "graphs": len(d_tr.epoch_runner.graphs)}
        steps = sum(m.num_batches for m in ms)
        losses = [m.mean_loss for m in ms]
        what = f"device epoch ({dtype}, paired={paired}, {compute}, {dispatch})"
        if not all(math.isfinite(v) for v in losses):
            fail(f"{what}: non-finite loss {losses}")
        want = {k: v * steps for k, v in device_step_launches(
            key, "mean", 2, bf16=compute == "bfloat16").items()}
        if out["launches"] != want:
            fail(f"{what}: launches {out['launches']} over {steps} steps, expected {want}")
        if not (d_tr.epoch_runner.graph and d_tr.epoch_runner.graphs):
            fail(f"{what}: epoch 1 did not replay CUDA graphs")
        return d_tr, out

    dev_tr, dev_out = {}, {}
    for label, dispatch, kw in (
            ("f32", "scan", {}), ("f32_paired", "steps", {"paired": True}),
            ("bf16_paired", "pipelined", {"dtype": "bfloat16", "paired": True}),
            ("int8_paired", "steps", {"dtype": "int8", "paired": True}),
            ("bf16_compute", "pipelined", {"dtype": "bfloat16", "paired": True,
                                           "compute": "bfloat16"})):
        dev_tr[label], dev_out[label] = device_run(dispatch, **kw)
        if label in ("f32_paired", "bf16_compute"):
            del dev_tr[label]                # keep the card's memory for what follows
        free_memory()
    emit("device_epoch", dev_out)
    for label in dev_out:
        e0, e1 = (m["mean_loss"] for m in dev_out[label]["epochs"])
        if not e1 < e0:
            fail(f"device epoch ({label}): loss did not fall: {e0} -> {e1}")
    dev_launches = {TIERS[dev_tr[k].cfg.cache.dtype]: dev_out[k]["launches"]
                    for k in ("f32", "bf16_paired", "int8_paired")}

    # -- dispatch: each epoch_dispatch mode replayed against its eager form ---
    # for each run and mode: a Trainer (epoch 0 eager, the capture, epoch 1
    # replayed) against a fresh Trainer's epochs through the eager form of the
    # same function (DeviceEpochRunner(graph=False), main stream) from the same
    # seed; the eager spread from a second eager run of the scan form
    MODES = ("scan", "steps", "pipelined")

    def eager_form(cfg_d, n_epochs: int):
        """A fresh Trainer's ``n_epochs`` through the eager form: each
        epoch's wall time, host enqueue and metrics; the Trainer."""
        t_ = Trainer.from_dataset(cfg_d, ds, seed=0)
        runner = DeviceEpochRunner(cfg_d, t_.state, t_.epoch_inputs, t_.device_data())
        out = []
        for e in range(n_epochs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t_.epoch_inputs.load(*t_.epoch_randomness(e, out=t_.epoch_inputs))
            acc = runner()
            enqueue = time.perf_counter() - t0
            v = acc.values()
            out.append({"time_s": time.perf_counter() - t0, "enqueue_ms": enqueue * 1e3,
                        "steps": int(v["steps"]), "edges": int(v["edges"]),
                        "vertices": int(v["vertices"]),
                        "mean_loss": v["loss_sum"] / max(v["steps"], 1)})
        return t_, out

    def replay_run(cfg_d, n_epochs: int):
        """A Trainer's ``n_epochs`` (the first eager, then replays), its
        peak bytes and launches run and its parameters after them; then one
        more replayed epoch (a graph's first replay also uploads it) and
        one behind a device sleep that outlasts its enqueue: the replay's
        device time."""
        free_memory()
        start_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gk.reset_launch_counts()
        t_ = Trainer.from_dataset(cfg_d, ds, seed=0)
        ms, enqueue_ms = [], []
        for e in range(n_epochs):
            before = t_.timers.total["enqueue"]
            ms.append(t_.run_epoch(e))
            enqueue_ms.append((t_.timers.total["enqueue"] - before) * 1e3)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - start_bytes
        counts = executed_launches(gk.launch_counts(), t_.epoch_runner)
        params = {n: p.detach().clone() for n, p in t_.state.model.named_parameters()}
        before = t_.timers.total["enqueue"]
        again = t_.run_epoch(n_epochs)
        enqueue_ms.append((t_.timers.total["enqueue"] - before) * 1e3)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(200_000_000)
        ev[1].record()
        t0 = time.perf_counter()
        t_.enqueue_device_epoch(n_epochs + 1)
        dev_enqueue_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        return t_, ms, params, {"run_peak_device_bytes": peak, "launches": counts,
                                "enqueue_ms": enqueue_ms, "again_s": again.time_s,
                                "device_epoch_ms": ev[1].elapsed_time(ev[2]),
                                "device_time_is_pure": dev_enqueue_ms
                                < ev[0].elapsed_time(ev[1])}

    def dispatch_config(kw, mode: str):
        return config("mean", kw.get("dtype", "float32"), on_device=True,
                      paired=kw.get("paired", False), compute=kw.get("compute", "float32"),
                      dispatch=mode, cosine_steps=kw.get("cosine_steps", 0))

    dispatch_out, bad = {}, []
    for label, kw in (("f32", {}), ("f32_paired", {"paired": True}),
                      ("bf16_tier", {"dtype": "bfloat16", "paired": True}),
                      ("int8_tier", {"dtype": "int8", "paired": True}),
                      ("bf16_compute", {"dtype": "bfloat16", "paired": True,
                                        "compute": "bfloat16"}),
                      ("f32_cosine", {"cosine_steps": 150})):
        dtype, compute = kw.get("dtype", "float32"), kw.get("compute", "float32")
        key = f"assemble_{TIERS[dtype]}" + ("_to_bf16" if compute == "bfloat16" else "")
        free_memory()
        t_e2, eager2 = eager_form(dispatch_config(kw, "scan"), 2)
        p_e2 = {n: p.detach().clone() for n, p in t_e2.state.model.named_parameters()}
        # the eager step's device time (the steps mode's eager step_fn)
        _, step_fn = make_device_step_fns(t_e2.cfg, t_e2.state, t_e2.epoch_inputs,
                                          t_e2.device_data())
        eager_step = host_and_device(step_fn, reps=2, dev_reps=2)
        nb = t_e2.epoch_inputs.num_batches
        del t_e2, step_fn
        run_out = {"cache_dtype": dtype, "compute": compute,
                   "paired_draws": kw.get("paired", False),
                   "lr_schedule": (f"cosine, lr_decay_steps {kw['cosine_steps']} of "
                                   f"{2 * nb} updates") if "cosine_steps" in kw else "none",
                   "eager_step_device_ms": eager_step["device_ms"],
                   "eager_step_device_time_is_pure": eager_step["device_time_is_pure"]}
        for mode in MODES:
            cfg_m = dispatch_config(kw, mode)
            t_r, ms, p_r, meas = replay_run(cfg_m, 2)
            timers = t_r.timers.summary()
            runner = t_r.epoch_runner
            replayed = runner.replayed_launches()
            replayed_steps = nb * (len(ms) + 1)     # epochs 1.., again, the timing epoch
            del t_r, runner
            free_memory()
            start_bytes = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t_e, eager = eager_form(cfg_m, 2)
            eager_peak = torch.cuda.max_memory_allocated() - start_bytes
            p_e = {n: p.detach().clone() for n, p in t_e.state.model.named_parameters()}
            del t_e
            m1, e1 = ms[1], eager[1]
            dev_step_ms = meas["device_epoch_ms"] / nb
            entry = {
                "capture_s": timers["capture"]["total_s"],
                "epoch_s": {"replayed": m1.time_s, "replayed_again": meas["again_s"],
                            "eager": e1["time_s"]},
                "enqueue_ms": {"replayed": meas["enqueue_ms"][1],
                               "replayed_again": meas["enqueue_ms"][2],
                               "eager": e1["enqueue_ms"],
                               "eager_first_epoch_of_the_trainer": meas["enqueue_ms"][0]},
                "device_ms_per_step": {"replayed": dev_step_ms,
                                       "eager": eager_step["device_ms"]},
                "device_time_is_pure": meas["device_time_is_pure"],
                "device_busy_share": {"replayed_again": meas["device_epoch_ms"] / 1e3
                                      / meas["again_s"],
                                      "eager": nb * eager_step["device_ms"] / 1e3
                                      / e1["time_s"]},
                "replayed_gather_launches_per_step": {k: v / replayed_steps
                                                      for k, v in replayed.items()},
                "launches": {k: v for k, v in meas["launches"].items() if v},
                "run_peak_device_bytes": {"replayed": meas["run_peak_device_bytes"],
                                          "eager": eager_peak},
                "epochs": [{"replayed": [m.num_batches, m.edges, m.vertices, m.mean_loss],
                            "eager": [e["steps"], e["edges"], e["vertices"], e["mean_loss"]],
                            "eager2": [e2["steps"], e2["edges"], e2["vertices"],
                                       e2["mean_loss"]]}
                           for m, e, e2 in zip(ms, eager, eager2)],
                "loss_rel_diff": {"replay_vs_eager": [rel(m.mean_loss, e["mean_loss"])
                                                      for m, e in zip(ms, eager)],
                                  "eager_vs_eager": [rel(e2["mean_loss"], e["mean_loss"])
                                                     for e, e2 in zip(eager, eager2)]},
                "param_rel_diff": {"replay_vs_eager": param_rel(p_r, p_e),
                                   "eager_vs_eager": param_rel(p_e2, p_e)},
            }
            run_out[mode] = entry
            what = f"dispatch ({label}, {mode})"
            for m, e in zip(ms, eager):
                if (m.num_batches, m.edges, m.vertices) != (e["steps"], e["edges"],
                                                            e["vertices"]):
                    bad.append(f"{what}: epoch {m.epoch} steps/edges/vertices "
                               f"{(m.num_batches, m.edges, m.vertices)} != eager "
                               f"{(e['steps'], e['edges'], e['vertices'])}")
            for r_, s_ in zip(*entry["loss_rel_diff"].values()):
                if not r_ <= max(1e-4, s_):
                    bad.append(f"{what}: loss {r_} from the eager form's, over 1e-4 and "
                               f"the eager spread {s_}")
            worst = entry["param_rel_diff"]["replay_vs_eager"]
            if not worst <= 1e-3:
                bad.append(f"{what}: parameters {worst} of their norm from the eager form's")
            want = {k: float(v) for k, v in device_step_launches(
                key, "mean", 2, bf16=compute == "bfloat16").items()}
            if entry["replayed_gather_launches_per_step"] != want:
                bad.append(f"{what}: replayed gather launches a step "
                           f"{entry['replayed_gather_launches_per_step']}, expected {want}")
            if not ms[1].mean_loss < ms[0].mean_loss:
                bad.append(f"{what}: loss did not fall: {ms[0].mean_loss} -> {ms[1].mean_loss}")
            if not all(math.isfinite(m.mean_loss) for m in ms):
                bad.append(f"{what}: non-finite loss")
        dispatch_out[label] = run_out
    dispatch_out["nvidia_smi"] = smi
    emit("dispatch", dispatch_out)
    if bad:
        fail("graph replays disagree with the eager form: " + "; ".join(bad))

    # -- sage_aggregators: pool and lstm, host path and on-device path --------
    # the 2-hop teacher labels (synthetic.neighborhood_labels) over the same
    # graph and features, on which pool and lstm train: the accuracy anchor
    # that needs the neighbor aggregation.  Host runs: 2 epochs (epoch 1
    # replayed from the host-step graphs), pool also 1 epoch at bf16
    # compute; on-device runs: 1 epoch (eager).  Launches a step: host 4
    # (pool: the assembly, two block_gather_fwd_max, one block_gather_bwd_max;
    # lstm: the assembly, two gather_rows of each block's self and neighbor
    # rows, one scatter_add_rows), 5 at bf16 compute; on-device 1.
    t0 = time.perf_counter()
    nb_labels = synthetic.neighborhood_labels(ds.graph, ds.features, 47, seed=1)
    ds_nb = Dataset(ds.graph, ds.features, nb_labels, ds.train_mask, ds.val_mask,
                    ds.test_mask)
    nb_labels_s = time.perf_counter() - t0

    agg_tr, agg_out = {}, {"neighborhood_labels_s": nb_labels_s}
    host_keys = {"pool": ("block_gather_fwd_max", "block_gather_bwd_max"),
                 "lstm": ("gather_rows", "scatter_add_rows")}
    for agg in ("pool", "lstm"):
        fwd_key, bwd_key = host_keys[agg]
        agg_tr[agg], agg_out[f"{agg}_host"] = run_trainer(
            torch, gk, f"{agg} host",
            lambda a=agg: Trainer.from_dataset(config(a), ds_nb, seed=0), 2,
            {"assemble_f32": 1, fwd_key: 2, bwd_key: 1})
        free_memory()
        _, agg_out[f"{agg}_device"] = run_trainer(
            torch, gk, f"{agg} on-device", lambda a=agg: Trainer.from_dataset(
                config(a, on_device=True, paired=True), ds_nb, seed=0), 1, {"assemble_f32": 1})
        free_memory()
    _, agg_out["pool_host_bf16"] = run_trainer(
        torch, gk, "pool host bf16",
        lambda: Trainer.from_dataset(config("pool", compute="bfloat16"), ds_nb, seed=0), 1,
        {"assemble_f32_to_bf16": 1, "block_gather_fwd_max_bf16": 2,
         "block_gather_bwd_max_bf16": 1, "grad_to_bf16": 1})
    free_memory()
    # the lstm step at bf16 compute: scatter_add_rows writes the bf16 table
    # itself (no grad_to_bf16), so 4 launches a step
    _, agg_out["lstm_host_bf16"] = run_trainer(
        torch, gk, "lstm host bf16",
        lambda: Trainer.from_dataset(config("lstm", compute="bfloat16"), ds_nb, seed=0), 1,
        {"assemble_f32_to_bf16": 1, "gather_rows_bf16": 2, "scatter_add_rows_bf16": 1})
    free_memory()
    pool_launches = agg_out["pool_host"]["launches"]
    pool_bf16_launches = agg_out["pool_host_bf16"]["launches"]
    lstm_launches = agg_out["lstm_host"]["launches"]
    lstm_bf16_launches = agg_out["lstm_host_bf16"]["launches"]
    agg_out["note"] = ("trained on neighborhood_labels(graph, features, 47, seed=1); host "
                       "runs 2 epochs (epoch 1 replayed), on-device runs 1 eager epoch, "
                       "pool_host_bf16 and lstm_host_bf16 1 eager epoch at bf16 compute")
    emit("sage_aggregators", agg_out)

    # -- preprocess: GraphSAGE preprocess (the store's neigh field) -----------
    # the f32 store (full_graph_mean_aggregate, the host library's SpMM) and
    # the pre-quantized store (build_prequantized: the int8 SpMM, the field
    # re-quantized), each on the host path (cache at 40% of the vertices, at
    # twice the row width) and the on-device path (full cache); n_layers 1:
    # the pre update, then one sampled hop, one block.  Launches a step: host
    # 3 (the assembly of both fields, one block forward, one block backward),
    # on-device 1
    def pre_config(cache_dtype, on_device):
        c = config("mean", cache_dtype, on_device=on_device)
        c.model.preprocess = True
        c.sync_hops().validate()
        return c

    pre_out = {}
    t0 = time.perf_counter()
    store_pre = FeatureStore.build(ds.graph, ds.features, preprocess="graphsage")
    pre_out["build_f32_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    store_pre_i8 = build_prequantized(ds.graph, qstore.fields["features"],
                                      qstore.scales["features"], preprocess="graphsage")
    pre_out["build_prequantized_s"] = time.perf_counter() - t0
    for label, store_, dtype, on_device, n_ep, per_step in (
            ("f32_host", store_pre, "float32", False, 2,
             {"assemble_f32": 1, "block_gather_fwd_mean": 1, "block_gather_bwd_mean": 1}),
            ("int8_host", store_pre_i8, "int8", False, 1,
             {"assemble_int8": 1, "block_gather_fwd_mean": 1, "block_gather_bwd_mean": 1}),
            ("f32_device", store_pre, "float32", True, 1,
             device_step_launches("assemble_f32", "mean", 1, grads=1, kernel_draws=False)),
            ("int8_device", store_pre_i8, "int8", True, 1,
             device_step_launches("assemble_int8", "mean", 1, grads=1, kernel_draws=False))):
        t_, pre_out[label] = run_trainer(
            torch, gk, f"preprocess {label}", lambda s_=store_, d_=dtype, o_=on_device: Trainer(
                pre_config(d_, o_), s_, ds.graph, ds.train_nids, ds.labels, seed=0),
            n_ep, per_step)
        pre_out[label]["cache_row_bytes"] = t_.cache.total_dim * t_.cache.cache_values.element_size()
        pre_out[label]["cache_capacity"] = t_.cache.capacity
        del t_
        free_memory()
    host_miss = [pre_out[k]["epochs"][0]["miss_rate"] for k in ("f32_host", "int8_host")]
    if host_miss[0] != host_miss[1]:
        fail(f"preprocess: the int8 store's miss rate {host_miss[1]} != the f32 store's "
             f"{host_miss[0]} (the same batches and cache)")
    del store_pre, store_pre_i8
    emit("preprocess", pre_out)

    # -- inference: full-graph logits on the card against the host backend ----
    # the trained parameters of the main path (mean, the dataset's labels),
    # and of the pool and lstm runs (the teacher labels): both backends'
    # logits within 1e-4 of each row's largest, seconds, evaluate's accuracy
    # on the validation vertices.  lstm runs on an RMAT scale-16 graph with
    # the same 100-dim features and teacher (its full-neighborhood LSTM takes
    # a step an in-neighbor: RMAT-20's hubs would take minutes).  pool runs
    # on RMAT-20, whose window tables must hold a hubs table and its level2
    # reductions (the max over the hub windows' partials)
    t0 = time.perf_counter()
    bn = _BucketedNeighborhoods(ds.graph, dev)
    torch.cuda.synchronize()
    inf_out = {"bucketed_build_s": time.perf_counter() - t0,
               "window_tables": [[lv, list(p.shape)] for lv, p, _ in bn.tables()]}
    g16 = CSRGraph.from_coo(synthetic.rmat_coo(16, 16, seed=42))
    x16 = np.random.default_rng(7).random((g16.num_nodes, 100), dtype=np.float32)
    ds16 = Dataset(g16, x16, synthetic.neighborhood_labels(g16, x16, 47, seed=1),
                   *synthetic.random_split_masks(g16.num_nodes, seed=11))
    inf_launches = {}
    bad = []
    levels = {lv for lv, _, _ in bn.tables()}
    if ds_nb.graph is not ds.graph or not {"hubs", "level2"} <= levels:
        bad.append(f"pool: RMAT-20's window tables {sorted(levels)} hold no hubs and level2 "
                   "tables, or pool runs on another graph")
    for agg, t_, data in (("mean", tr, ds), ("pool", agg_tr["pool"], ds_nb),
                          ("lstm", agg_tr["lstm"], ds16)):
        model, mcfg = t_.state.model, t_.cfg.model
        entry, logits = {"graph_vertices": data.num_nodes}, {}
        for backend in ("host", "device"):
            gk.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits[backend] = full_graph_logits(model, mcfg, data.graph, data.features,
                                                backend=backend)
            torch.cuda.synchronize()
            entry[f"{backend}_s"] = time.perf_counter() - t0
            entry[f"{backend}_launches"] = {k: v for k, v in gk.launch_counts().items() if v}
        inf_launches[agg] = entry["device_launches"]
        scale = 1.0 + np.abs(logits["host"]).max(axis=1, keepdims=True)
        entry["max_row_rel_diff"] = float((np.abs(logits["device"] - logits["host"])
                                           / scale).max())
        entry["val_acc"] = evaluate(model, mcfg, data.graph, data.features, data.labels,
                                    data.val_mask, backend="device")
        entry["labels"] = "dataset (linear)" if agg == "mean" else "neighborhood teacher"
        inf_out[agg] = entry
        if not entry["max_row_rel_diff"] <= 1e-4:
            bad.append(f"{agg}: device logits {entry['max_row_rel_diff']} from the host's")
        want = {"mean": "gather_reduce_sum", "pool": "gather_reduce_max",
                "lstm": "gather_rows"}[agg]
        if entry["device_launches"].get(want, 0) <= 0:
            bad.append(f"{agg}: the device backend launched no {want}")
        if any(k.startswith("gather_reduce") for k in entry["host_launches"]):
            bad.append(f"{agg}: the host backend launched a window reduction")
    inf_out["nvidia_smi"] = smi
    emit("inference", inf_out)
    if bad:
        fail("inference: " + "; ".join(bad))

    # -- checkpoint: save after epoch 0, resume into a fresh Trainer, epoch 1 --
    # host path (the main configuration; dropout 0.2, so the generator's
    # state matters): at bf16 compute the resumed run's epoch 1 (eager)
    # equals the uninterrupted run's (replayed) to the bit, as must a resume
    # into the first Trainer after its graphs were captured, its epoch 1
    # replayed again; at f32 the difference is reported beside the spread
    # of two resumed runs.  On-device (scan, bf16 compute): bit-equal too.
    import tempfile

    def param_copy(t_):
        return {n: p.detach().clone() for n, p in t_.state.model.named_parameters()}

    def max_rel(pa, pb):
        return max(float((pa[n] - pb[n]).norm() / pb[n].norm().clamp(min=1e-30)) for n in pa)

    ck_out = {}
    with tempfile.TemporaryDirectory() as ck_root:
        for label, kw in (("host_bf16", {"compute": "bfloat16"}), ("host_f32", {}),
                          ("device_bf16", {"compute": "bfloat16", "on_device": True,
                                           "paired": True})):
            c = config("mean", **kw)
            c.train.ckpt_dir = os.path.join(ck_root, label)
            c.train.ckpt_every = 1
            a = Trainer.from_dataset(c, ds, seed=0)
            t0 = time.perf_counter()
            a.train(2)
            torch.cuda.synchronize()
            pa, la = param_copy(a), [m.mean_loss for m in a.epoch_metrics]
            entry = {"checkpoints": list_checkpoints(c.train.ckpt_dir, "graphsage"),
                     "uninterrupted_s": time.perf_counter() - t0}
            resumed = []
            for _ in range(1 if label != "host_f32" else 2):
                b = Trainer.from_dataset(c, ds, seed=0)
                t0 = time.perf_counter()
                start = b.resume(epoch=0)
                entry["resume_s"] = time.perf_counter() - t0
                b.train(2, start_epoch=start)
                torch.cuda.synchronize()
                resumed.append((param_copy(b), b.epoch_metrics[-1].mean_loss))
                del b
                free_memory()
            entry["resumed_vs_uninterrupted"] = max_rel(resumed[0][0], pa)
            entry["loss"] = {"uninterrupted": la[1], "resumed": resumed[0][1]}
            if label == "host_f32":
                entry["resumed_vs_resumed"] = max_rel(resumed[1][0], resumed[0][0])
            elif entry["resumed_vs_uninterrupted"] != 0.0:
                bad.append(f"checkpoint {label}: the resumed run's parameters are "
                           f"{entry['resumed_vs_uninterrupted']} from the uninterrupted run's")
            if label != "device_bf16":
                # resume into the Trainer whose graphs replayed epoch 1: in place
                ptrs = {n: p.data_ptr() for n, p in a.state.model.named_parameters()}
                a.resume(epoch=0)
                a.run_epoch(1)
                torch.cuda.synchronize()
                entry["graphs_held"] = len(a.group_graphs.graphs) if a.group_graphs else 0
                entry["after_capture_vs_uninterrupted"] = max_rel(param_copy(a), pa)
                moved = [n for n, p in a.state.model.named_parameters()
                         if p.data_ptr() != ptrs[n]]
                if moved:
                    bad.append(f"checkpoint {label}: resume moved {moved}")
                if label == "host_bf16" and entry["after_capture_vs_uninterrupted"] != 0.0:
                    bad.append(f"checkpoint {label}: the replay after a resume is "
                               f"{entry['after_capture_vs_uninterrupted']} from the first")
            if entry["checkpoints"] != [0, 1]:
                bad.append(f"checkpoint {label}: saved {entry['checkpoints']}")
            ck_out[label] = entry
            del a
            free_memory()
    emit("checkpoint", ck_out)
    if bad:
        fail("checkpoint: " + "; ".join(bad))

    # -- model_families: GCN, GIN and GAT at the leaderboard width ------------
    fam_out, family_cases, bad = model_families(types.SimpleNamespace(
        torch=torch, np=np, gk=gk, pt=pt, dev=dev, ds_nb=ds_nb, Dataset=Dataset, CSRGraph=CSRGraph,
        synthetic=synthetic, Trainer=Trainer, DeviceEpochRunner=DeviceEpochRunner,
        full_graph_logits=full_graph_logits, evaluate=evaluate, mlp_val_acc=mlp_val_acc))
    fam_out["nvidia_smi"] = smi
    emit("model_families", fam_out)
    if bad:
        fail("model_families: " + "; ".join(bad))
    free_memory()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)   # time_ms's L2 flush

    # -- cv_gcn: CV-GCN on both single-device paths ----------------------------
    cv_out, cv_cases, bad = cv_gcn(types.SimpleNamespace(
        torch=torch, np=np, gk=gk, pt=pt, dev=dev, ds_nb=ds_nb, Dataset=Dataset,
        CSRGraph=CSRGraph, synthetic=synthetic, Trainer=Trainer,
        DeviceEpochRunner=DeviceEpochRunner, CapturedGraph=CapturedGraph,
        save_checkpoint=save_checkpoint, full_graph_logits=full_graph_logits,
        evaluate=evaluate, flush=flush))
    cv_out["nvidia_smi"] = smi
    emit("cv_gcn", cv_out)
    if bad:
        fail("cv_gcn: " + "; ".join(bad))
    free_memory()

    # -- partition: the partition pipeline and Trainer.from_partition -----------
    part_out, bad = partition_phase(types.SimpleNamespace(
        torch=torch, np=np, gk=gk, pt=pt, ds=ds, CSRGraph=CSRGraph, synthetic=synthetic,
        partition=partition, formats=formats, FeatureStore=FeatureStore, config=config,
        Trainer=Trainer, DeviceEpochRunner=DeviceEpochRunner))
    part_out["nvidia_smi"] = smi
    emit("partition", part_out)
    if bad:
        fail("partition: " + "; ".join(bad))
    free_memory()

    # -- dp: data-parallel training, one process a rank -------------------------
    # -- halo: the halo feature sources, features sharded across the ranks ------
    # -- dp_cv: data-parallel CV-GCN, per-rank histories and shards -----------
    # -- service: isolation-mode sampling, one2one and one2all -----------------
    dp_env = types.SimpleNamespace(torch=torch, np=np, ds=ds, partition=partition,
                                   formats=formats, ds_nb=ds_nb, FeatureStore=FeatureStore,
                                   Dataset=Dataset, gk=gk, pt=pt, dev=dev, Trainer=Trainer)
    with tempfile.TemporaryDirectory() as dp_root:
        dp_out, bad = dp_phase(dp_env, dp_root)
        dp_out["nvidia_smi"] = smi
        emit("dp", dp_out)
        if bad:
            fail("dp: " + "; ".join(bad))
        halo_out, bad = halo_phase(dp_env, dp_root)
        halo_out["nvidia_smi"] = smi
        emit("halo", halo_out)
        if bad:
            fail("halo: " + "; ".join(bad))
        dp_cv_out, bad = dp_cv_phase(dp_env, dp_root)
        dp_cv_out["nvidia_smi"] = smi
        emit("dp_cv", dp_cv_out)
        if bad:
            fail("dp_cv: " + "; ".join(bad))
        dp_cv_cases = dp_cv_kernel_cases(dp_env, dp_cv_out["cv_root"], dp_cv_out)
        svc_out, bad = service_phase(dp_env, dp_root)
        svc_out["nvidia_smi"] = smi
        emit("service", svc_out)
        if bad:
            fail("service: " + "; ".join(bad))
    del dp_env
    free_memory()

    # one device-sampled batch of the f32 run's epoch 0: the on-device path's shapes
    dtr = dev_tr["f32"]
    dcfg = dtr.cfg
    d_perm, d_draws = dtr.epoch_randomness(0)
    d_seeds, d_masks = epoch_schedule(d_perm, dtr._dev_train_nids, dcfg.sampler.batch_size)
    d_step = (d_seeds[0], d_masks[0], [d[0] for d in d_draws])
    d_mb = sample_minibatch_device(dtr._dev_csr, d_step[0], d_step[1], dcfg.sampler.num_hops,
                                   dcfg.sampler.hop_fanouts(), d_step[2],
                                   labels=dtr._dev_labels)
    d_ids = d_mb.input_nids
    d_full = {TIERS[t.cfg.cache.dtype]: (t.cache.cache_values, t.cache.dequant_scale_dev)
              for t in (dev_tr["f32"], dev_tr["bf16_paired"], dev_tr["int8_paired"])}

    # -- kernels: one batch of the run, at its shapes ------------------------
    seeds = tr.sampler.train_nids[:cfg.sampler.batch_size]
    mb_h = tr.sampler.sample(seeds)
    mb = mb_h.to(dev)

    def tier_inputs(cache):
        """The assembly's inputs for this batch at a cache's tier: cache
        rows, the plan's index a row and miss rows, the int8 scale."""
        plan = cache.fetch_plan(mb_h.input_nids, mb_h.input_mask, track=False)
        return (cache.cache_values, torch.from_numpy(plan.src_row).to(dev),
                plan.miss_feats.to(dev), cache.dequant_scale_dev)

    # f32: the main path's own cache; the others from the tiers phase
    tier_in = {dtype: tier_inputs(tr.cache if dtype == "float32" else tier_tr[dtype].cache)
               for dtype in TIERS}
    cv, src_row, miss_feats, _ = tier_in["float32"]
    b0, b1 = mb.blocks
    gen = torch.Generator(device=dev).manual_seed(1)
    feats = gk.assemble(cv, src_row, miss_feats)
    h1 = torch.randn(b0.cap_dst, 2 * cfg.model.hidden, generator=gen, device=dev)
    g1 = torch.randn(b1.cap_dst, 2 * cfg.model.hidden, generator=gen, device=dev)

    def rows_bytes(n, d, size=4):
        return size * n * d

    def distinct(*idx):
        """Distinct source rows that one launch reads through these
        indices: each is read from memory once."""
        return int(torch.unique(torch.cat([i.reshape(-1) for i in idx])).numel())

    def reduce_inputs(pos, mask):
        """embedding_bag's flat valid positions and bag offsets."""
        counts = mask.sum(1)
        offsets = torch.zeros_like(counts)
        offsets[1:] = torch.cumsum(counts, 0)[:-1]
        return pos[mask].long(), offsets.long(), int(counts.sum())

    cases = []

    def gather_case(label, src, ids):
        n, d = ids.shape[0], src.shape[1]
        ids_l = ids.long()
        cases.append(dict(
            name=f"gather_rows[{label}]", key="gather_rows",
            replaces=f"{PALLAS}:58 gather_rows_pallas",
            shape=f"src {list(src.shape)} ids [{n}]", tol="exact",
            kernel=lambda: gk.gather_rows(src, ids),
            plain=lambda: gk.gather_rows_plain(src, ids),
            library=lambda: torch.index_select(src, 0, ids_l),
            nbytes=4 * n + rows_bytes(distinct(ids), d) + rows_bytes(n, d)))

    def assemble_same_fn(cv_t, sr_t, mf_t, sc_t):
        """The assembly in PyTorch calls from the kernel's own inputs: a row
        gather from each table, the selection, the cast (and the scale)."""
        rows = torch.where((sr_t >= 0)[:, None],
                           torch.index_select(cv_t, 0, sr_t.clamp(min=0)),
                           torch.index_select(mf_t, 0, (-1 - sr_t).clamp(min=0))).float()
        return rows if sc_t is None else rows * sc_t

    gather_case("block0 self", feats, b0.self_pos)
    gather_case("block1 self", h1, b1.self_pos)
    n0, d0 = src_row.shape[0], cv.shape[1]
    for dtype, tag in TIERS.items():
        # the bound: 4 index bytes a row, each distinct source row read once
        # at the tier's width, the f32 rows written, the int8 scale read
        cv_t, sr_t, mf_t, sc_t = tier_in[dtype]
        cases.append(dict(
            name=f"assemble[{tag}]", key=f"assemble_{tag}",
            launches=(launches if dtype == "float32" else tier_launches[dtype])[f"assemble_{tag}"],
            replaces=f"{PALLAS}:58 gather_rows_pallas (+ storage/cache.py:103 "
                     "assemble_features, :69 dequantize_fused)",
            shape=f"cache {list(cv_t.shape)} {cv_t.dtype} miss {list(mf_t.shape)} "
                  f"src_row [{n0}]",
            tol="exact",
            kernel=lambda a=tier_in[dtype]: gk.assemble(*a),
            plain=lambda a=tier_in[dtype]: gk.assemble_plain(*a),
            library=None, same_fn=lambda a=tier_in[dtype]: assemble_same_fn(*a),
            nbytes=4 * n0 + distinct(sr_t) * d0 * cv_t.element_size() + rows_bytes(n0, d0)
            + (0 if sc_t is None else 4 * d0)))
    # the on-device path's layer-0 fetch (take_rows): the assembly with no
    # miss rows, from the full cache, at a device-sampled batch's layer 0;
    # the bound as above, with no miss rows
    nd, dd = d_ids.shape[0], d_full["f32"][0].shape[1]
    nd_distinct = distinct(d_ids)

    def full_same_fn(cv_t, sc_t):
        """take_rows in PyTorch calls: index_select, .float(), the scale."""
        rows = torch.index_select(cv_t, 0, d_ids).float()
        return rows if sc_t is None else rows * sc_t

    for dtype, tag in TIERS.items():
        cv_f, sc_f = d_full[tag]
        cases.append(dict(
            name=f"assemble_full[{tag}]", key=f"assemble_{tag}",
            launches=dev_launches[tag][f"assemble_{tag}"],
            replaces=f"{PALLAS}:58 gather_rows_pallas (on-device layer-0 fetch: "
                     "ops/gather.py:21 chunked_take + storage/cache.py:69 dequantize_fused)",
            shape=f"cache {list(cv_f.shape)} {cv_f.dtype} ids [{nd}], no miss rows",
            tol="exact",
            kernel=lambda c=cv_f, s=sc_f: take_rows(c, d_ids, s),
            plain=lambda c=cv_f, s=sc_f: gk.assemble_plain(c, d_ids, c[:0], s),
            library=(lambda c=cv_f: torch.index_select(c, 0, d_ids)) if sc_f is None
            and cv_f.dtype == torch.float32 else None,
            same_fn=lambda c=cv_f, s=sc_f: full_same_fn(c, s),
            nbytes=4 * nd + nd_distinct * dd * cv_f.element_size() + rows_bytes(nd, dd)
            + (0 if sc_f is None else 4 * dd)))
    # the halo exchange's assembly (parallel/halo.py step 5) at its world-1
    # shape: the received rows are the one shard's rows of the plan's
    # requests (an all_to_all over one rank is a copy), H = cap0; its
    # launches are the halo phase's (a) runs'
    from pagraph_tpu_torch.parallel.halo import device_halo_plan, halo_width_for, src_rows
    hw = halo_width_for(nd, 1)
    h_plan = device_halo_plan(d_ids, d_mb.input_mask, 1, hw)
    h_recv = d_full["f32"][0].index_select(0, h_plan.req.view(-1))
    h_zero = torch.zeros((1, dd), device=dev)
    h_src = src_rows(h_plan)
    h_distinct = distinct(h_src[h_src >= 0])
    w1h = halo_out["world1"]

    def halo_same_fn(out_dtype):
        """Step 5 in PyTorch calls: index_select of the received rows (no
        scale at f32), then the dropped rows' zeros, then the cast."""
        rows = torch.index_select(h_recv, 0, h_src.clamp(min=0))
        return torch.where((h_src >= 0)[:, None], rows, 0.0).to(out_dtype)

    for out_dtype, tag, hlaunch in (
            (torch.float32, "f32", w1h["ici_host_float32"]["launches"]["assemble_f32"]),
            (torch.bfloat16, "f32->bf16",
             w1h["edge_device_bfloat16"]["launches"]["assemble_f32_to_bf16"])):
        cases.append(dict(
            name=f"assemble_halo[{tag}]", key="assemble_f32" + gk.ASSEMBLE_OUT[out_dtype],
            launches=hlaunch,
            replaces=f"{PALLAS}:58 gather_rows_pallas (the halo exchange's batch order: "
                     "parallel/halo.py:152 jnp.take + :155 where + storage/cache.py:69 "
                     "dequantize_fused)",
            shape=f"received {list(h_recv.shape)} f32 src_row [{nd}] (H = {hw}), one zero "
                  f"row -> {tag.split('->')[-1]}",
            tol="exact",
            kernel=lambda o=out_dtype: gk.assemble(h_recv, h_src, h_zero, None, o),
            plain=lambda o=out_dtype: gk.assemble_plain(h_recv, h_src, h_zero, None, o),
            library=None, same_fn=lambda o=out_dtype: halo_same_fn(o),
            nbytes=4 * nd + h_distinct * dd * 4 + 4 * dd
            + rows_bytes(nd, dd, 4 if out_dtype == torch.float32 else 2)))
    # -- the backwards: the fused block backward and its single-half uses ----
    s1, d1 = h1.shape
    n1, f1 = b1.neigh_pos.shape
    g1n = torch.randn(n1, d1, generator=gen, device=dev)
    ids1_l = b1.self_pos.long()
    flat1, _, _ = reduce_inputs(b1.neigh_pos, b1.neigh_mask)
    rows1 = b1.neigh_mask.nonzero(as_tuple=True)[0]
    cnt1 = b1.neigh_mask.sum(1, keepdim=True).clamp(min=1).float()

    def expanded(g, kind):
        """The index_add_ yardstick's input: the per-row division and the
        expansion over valid slots, done outside the timed call."""
        return (g / cnt1.to(g.dtype) if kind == "mean" else g)[rows1].contiguous()

    def same_fn(g_self, g_neigh, kind):
        """The backward from the kernel's own inputs in PyTorch calls: a
        zeroed table, the division and expansion, the index_add_ calls."""
        out = torch.zeros(s1, d1, device=dev,
                          dtype=(g_self if g_self is not None else g_neigh).dtype)
        if g_self is not None:
            out.index_add_(0, b1.self_pos, g_self)
        if g_neigh is not None:
            m = b1.neigh_mask
            g = g_neigh / m.sum(1, keepdim=True).clamp(min=1) if kind == "mean" else g_neigh
            out.index_add_(0, b1.neigh_pos.view(-1),
                           (g[:, None, :] * m[..., None]).view(-1, d1))
        return out

    def fwd_same_fn(src, blk, kind):
        """The block forward from the kernel's own inputs in PyTorch calls:
        a row gather, and a mask-weighted embedding_bag sum (divided by
        the count for mean)."""
        w = blk.neigh_mask.to(src.dtype)
        agg = torch.nn.functional.embedding_bag(blk.neigh_pos, src,
                                                per_sample_weights=w, mode="sum")
        if kind == "mean":
            agg = agg / w.sum(1, keepdim=True).clamp(min=1)
        return torch.index_select(src, 0, blk.self_pos), agg

    # scatter_add_rows (its own kernel, one launch): at block 1's self rows,
    # and at the lstm step's ids (block_gather_msgs: the self positions, then
    # every neighbor slot), at f32 and bf16; launches: the lstm host runs
    lstm_ids = torch.cat([b1.self_pos, b1.neigh_pos.reshape(-1)])
    g_lstm = torch.randn(lstm_ids.shape[0], d1, generator=gen, device=dev)
    for label, ids_s, g_s in (("block1 self bwd", b1.self_pos, g1),
                              ("lstm step ids", lstm_ids, g_lstm)):
        for dt, sfx, size, tol in ((torch.float32, "", 4, "atomic"),
                                   (torch.bfloat16, "_bf16", 2, "bf16")):
            g_t, ids_l, n_ids = g_s.to(dt), ids_s.long(), ids_s.shape[0]
            sbuf = torch.zeros(s1, d1, dtype=dt, device=dev)
            run = lstm_launches if sfx == "" else lstm_bf16_launches
            cases.append(dict(
                name=f"scatter_add_rows{sfx}[{label}]", key=f"scatter_add_rows{sfx}",
                launches=run.get(f"scatter_add_rows{sfx}", 0) if label == "lstm step ids"
                else launches.get(f"scatter_add_rows{sfx}", 0),
                replaces=f"{PALLAS}:58 gather_rows_pallas (backward; JAX: autodiff of jnp.take)",
                shape=f"grad_out [{n_ids}, {d1}] {dt} -> [{s1}, {d1}]", tol=tol,
                kernel=lambda g_=g_t, i_=ids_s: gk.scatter_add_rows(g_, i_, s1),
                plain=lambda g_=g_t, i_=ids_s: gk.scatter_add_rows_plain(g_, i_, s1),
                library=lambda b_=sbuf, i_=ids_l, g_=g_t: b_.index_add_(0, i_, g_),
                same_fn=lambda g_=g_t, i_=ids_s: torch.zeros(
                    s1, d1, dtype=g_.dtype, device=dev).index_add_(0, i_, g_),
                nbytes=4 * n_ids + rows_bytes(n_ids, d1, size) + rows_bytes(s1, d1, size)))
    for rk in ("mean", "sum"):
        for label, src, blk in (("block0", feats, b0), ("block1", h1, b1)):
            flat, offs, _ = reduce_inputs(blk.neigh_pos, blk.neigh_mask)
            n, f = blk.neigh_pos.shape
            d = src.shape[1]
            neigh_rows = blk.neigh_pos[blk.neigh_mask]
            cases.append(dict(
                name=f"gather_reduce_{rk}[{label}]", key=f"gather_reduce_{rk}",
                replaces=f"{PALLAS}:132 gather_mean_pallas",
                shape=f"src {list(src.shape)} pos/mask [{n}, {f}]", tol="reduce",
                kernel=lambda s=src, b=blk, k=rk: gk.gather_reduce(s, b.neigh_pos, b.neigh_mask, k),
                plain=lambda s=src, b=blk, k=rk: gk.gather_reduce_plain(s, b.neigh_pos, b.neigh_mask, k),
                library=lambda s=src, fl=flat, of=offs, k=rk: torch.nn.functional.embedding_bag(
                    fl, s, of, mode=k),
                nbytes=5 * n * f + rows_bytes(distinct(neigh_rows), d) + rows_bytes(n, d)))
            n_s = blk.self_pos.shape[0]
            cases.append(dict(
                name=f"block_gather_fwd_{rk}[{label}]", key=f"block_gather_fwd_{rk}",
                replaces=f"{PALLAS}:58 gather_rows_pallas + {PALLAS}:132 gather_mean_pallas",
                shape=f"src {list(src.shape)} self_pos [{n_s}] pos/mask [{n}, {f}]",
                tol=("exact", "reduce"),
                kernel=lambda s=src, b=blk, k=rk: gk.block_gather_fwd(
                    s, b.self_pos, b.neigh_pos, b.neigh_mask, k),
                plain=lambda s=src, b=blk, k=rk: gk.block_gather_fwd_plain(
                    s, b.self_pos, b.neigh_pos, b.neigh_mask, k),
                library=lambda s=src, ids=blk.self_pos.long(), fl=flat, of=offs, k=rk: (
                    torch.index_select(s, 0, ids),
                    torch.nn.functional.embedding_bag(fl, s, of, mode=k)),
                same_fn=lambda s=src, b=blk, k=rk: fwd_same_fn(s, b, k),
                nbytes=4 * n_s + 5 * n * f + rows_bytes(distinct(blk.self_pos, neigh_rows), d)
                + rows_bytes(n_s, d) + rows_bytes(n, d)))
        bbuf = torch.zeros_like(h1)
        cases.append(dict(
            name=f"gather_reduce_bwd_{rk}[block1]", key=f"gather_reduce_bwd_{rk}",
            replaces=f"{PALLAS}:132 gather_mean_pallas (backward; JAX: autodiff of jnp.take)",
            shape=f"grad_out {list(g1.shape)} pos/mask [{n1}, {f1}] -> {list(h1.shape)}",
            tol="atomic",
            kernel=lambda k=rk: gk.gather_reduce_bwd(g1, b1.neigh_pos, b1.neigh_mask, s1, k),
            plain=lambda k=rk: gk.gather_reduce_bwd_plain(g1, b1.neigh_pos, b1.neigh_mask, s1, k),
            library=lambda ex=expanded(g1, rk), bb=bbuf: bb.index_add_(0, flat1, ex),
            same_fn=lambda k=rk: same_fn(None, g1, k),
            nbytes=5 * n1 * f1 + rows_bytes(n1, d1) + rows_bytes(s1, d1)))
        fbuf_s, fbuf_n = torch.zeros_like(h1), torch.zeros_like(h1)
        cases.append(dict(
            name=f"block_gather_bwd_{rk}[block1]", key=f"block_gather_bwd_{rk}",
            replaces=f"{PALLAS}:58 gather_rows_pallas + {PALLAS}:132 gather_mean_pallas "
                     "(backward of both; JAX: autodiff of jnp.take)",
            shape=f"g_self {list(g1.shape)} self_pos [{n1}], g_neigh {list(g1n.shape)} "
                  f"pos/mask [{n1}, {f1}] -> {list(h1.shape)}",
            tol="atomic",
            kernel=lambda k=rk: gk.block_gather_bwd(g1, b1.self_pos, g1n, b1.neigh_pos,
                                                    b1.neigh_mask, s1, k),
            plain=lambda k=rk: gk.block_gather_bwd_plain(g1, b1.self_pos, g1n, b1.neigh_pos,
                                                         b1.neigh_mask, s1, k),
            library=lambda ex=expanded(g1n, rk), bs=fbuf_s, bn=fbuf_n: (
                bs.index_add_(0, ids1_l, g1), bn.index_add_(0, flat1, ex)),
            same_fn=lambda k=rk: same_fn(g1, g1n, k),
            nbytes=4 * n1 + 5 * n1 * f1 + 2 * rows_bytes(n1, d1) + rows_bytes(s1, d1)))

    # -- the max kind (the pool aggregator's): block forward and backward -----
    # block 1's rows are concat(x, relu(x)) as the model's skip makes them, so
    # the relu half ties at 0; the launches are the pool host run's
    # (sage_aggregators).  library: index_select and embedding_bag(mode="max")
    # from pre-flattened inputs (as for mean and sum); same fn: index_select,
    # then the masked amax over the slots
    h1m = torch.cat([h1[:, :cfg.model.hidden], torch.relu(h1[:, :cfg.model.hidden])], 1)

    def max_same_fn(src, blk):
        msgs = torch.index_select(src, 0, blk.neigh_pos.view(-1)).view(
            *blk.neigh_pos.shape, src.shape[1])
        m = torch.where(blk.neigh_mask[..., None], msgs, -1e30).amax(1)
        return (torch.index_select(src, 0, blk.self_pos),
                torch.where(blk.neigh_mask.any(1, keepdim=True), m, 0.0))

    def max_bwd_same_fn(src, g_s, g_n):
        """The max backward in PyTorch calls from the kernel's inputs:
        autograd of ``max_same_fn`` (``index_select`` and the masked
        ``amax``, which splits ties evenly, as the kernel does), its forward
        recorded once outside the timed call."""
        x = src.detach().requires_grad_(True)
        outs = max_same_fn(x, b1)
        return lambda: torch.autograd.grad(outs, x, (g_s, g_n), retain_graph=True)[0]

    def max_cases(tag, feats_t, h1_t, g_s, g_n, size, launches_, tol_bwd):
        sfx = "" if tag == "f32" else "_bf16"
        for label, src, blk in (("block0", feats_t, b0), ("block1", h1_t, b1)):
            flat, offs, _ = reduce_inputs(blk.neigh_pos, blk.neigh_mask)
            n, f = blk.neigh_pos.shape
            d = src.shape[1]
            n_s = blk.self_pos.shape[0]
            neigh_rows = blk.neigh_pos[blk.neigh_mask]
            cases.append(dict(
                name=f"block_gather_fwd_max{sfx}[{label}]", key=f"block_gather_fwd_max{sfx}",
                launches=launches_[f"block_gather_fwd_max{sfx}"],
                replaces=f"{PALLAS}:58 gather_rows_pallas + {PALLAS}:132 gather_mean_pallas "
                         "with the max kind (pagraph_tpu/ops/aggregate.py:62 XLA's max)",
                shape=f"src {list(src.shape)} {src.dtype} self_pos [{n_s}] pos/mask [{n}, {f}]",
                tol=("exact", "exact"),
                kernel=lambda s=src, b=blk: gk.block_gather_fwd(
                    s, b.self_pos, b.neigh_pos, b.neigh_mask, "max"),
                plain=lambda s=src, b=blk: gk.block_gather_fwd_plain(
                    s, b.self_pos, b.neigh_pos, b.neigh_mask, "max"),
                library=lambda s=src, ids=blk.self_pos.long(), fl=flat, of=offs: (
                    torch.index_select(s, 0, ids),
                    torch.nn.functional.embedding_bag(fl, s, of, mode="max")),
                same_fn=lambda s=src, b=blk: max_same_fn(s, b),
                nbytes=4 * n_s + 5 * n * f
                + rows_bytes(distinct(blk.self_pos, neigh_rows), d, size)
                + rows_bytes(n_s, d, size) + rows_bytes(n, d, size)))
        neigh1 = b1.neigh_pos[b1.neigh_mask]
        cases.append(dict(
            name=f"block_gather_bwd_max{sfx}[block1]", key=f"block_gather_bwd_max{sfx}",
            launches=launches_[f"block_gather_bwd_max{sfx}"],
            replaces=f"{PALLAS}:58 gather_rows_pallas + {PALLAS}:132 gather_mean_pallas "
                     "(backward of both, max kind: g / ties at the tied maxima, re-reading "
                     "the source rows; JAX: autodiff of jnp.take and jnp.max)",
            shape=f"src {list(h1_t.shape)} {h1_t.dtype}, g_self/g_neigh [{n1}, {d1}], "
                  f"pos/mask [{n1}, {f1}] -> [{s1}, {d1}]",
            tol=tol_bwd,
            kernel=lambda: gk.block_gather_bwd(g_s, b1.self_pos, g_n, b1.neigh_pos,
                                               b1.neigh_mask, s1, "max", h1_t),
            plain=lambda: gk.block_gather_bwd_plain(g_s, b1.self_pos, g_n, b1.neigh_pos,
                                                    b1.neigh_mask, s1, "max", h1_t),
            library=None,
            same_fn=max_bwd_same_fn(h1_t, g_s, g_n),
            nbytes=4 * n1 + 5 * n1 * f1 + 2 * rows_bytes(n1, d1, size)
            + rows_bytes(distinct(neigh1), d1, size) + rows_bytes(s1, d1, size)))

    max_cases("f32", feats, h1m, g1, g1n, 4, pool_launches, "reduce")

    # -- window_reduce: device inference's degree-bucketed window reduction ---
    # the neighbor half alone (gather_reduce), sum and max kinds, on the
    # RMAT-20 window tables of the inference phase's bn over the 100-dim
    # features: the buckets F = 8 (the block forward's unrolled instantiation),
    # 64 (the window kernel, a warp a row), 512 and 4096 (a CTA a row) and the
    # hub table (the hubs' windows of 4096), and F = 4096 at the layer-1
    # input width (hidden); the launches are the inference phase's (mean:
    # sum, pool: max).  library: embedding_bag over the pre-flattened valid
    # positions (mode sum or max); same fn: index_select, then the masked sum
    # or amax over the slots.  bound_ms counts each distinct row once
    x_dev = torch.from_numpy(ds.features).to(dev)
    x_hid = torch.rand(ds.num_nodes, cfg.model.hidden, generator=gen, device=dev)
    win = {p.shape[1]: (p, m) for lv, p, m in bn.tables() if lv == "bucket"}
    hub_tables = [(p, m) for lv, p, m in bn.tables() if lv == "hubs"]
    for wf in (8, 64, 512, 4096):
        if wf not in win:
            fail(f"no window table of fan-out {wf}: {sorted(win)}")
    if not hub_tables:
        fail("the RMAT-20 graph has no hub table")

    def window_same_fn(src, pos, mask, kind):
        msgs = torch.index_select(src, 0, pos.view(-1)).view(*pos.shape, src.shape[1])
        if kind == "sum":
            return torch.where(mask[..., None], msgs, 0.0).sum(1)
        m = torch.where(mask[..., None], msgs, -1e30).amax(1)
        return torch.where(mask.any(1, keepdim=True), m, 0.0)

    for label, (pos_w, mask_w), x_w in (
            *((f"F={wf}", win[wf], x_dev) for wf in (8, 64, 512, 4096)),
            ("hubs F=4096", hub_tables[0], x_dev),
            (f"F=4096, D={x_hid.shape[1]}", win[4096], x_hid)):
        wf, rows_w, dw = pos_w.shape[1], pos_w.shape[0], x_w.shape[1]
        flat_w, offs_w, n_valid = reduce_inputs(pos_w, mask_w)
        valid_w = pos_w[mask_w]
        for wk in ("sum", "max"):
            cases.append(dict(
                name=f"window_reduce[{wk}, {label}]", key=f"gather_reduce_{wk}",
                launches=inf_launches["mean" if wk == "sum" else "pool"][f"gather_reduce_{wk}"],
                replaces=f"{PALLAS}:132 gather_mean_pallas (device inference's window "
                         "reduction, pagraph_tpu/models/inference.py:152 _window_reduce)",
                shape=f"src {list(x_w.shape)} pos/mask [{rows_w}, {wf}] "
                      f"({n_valid} valid slots), plan "
                      f"{gk.window_plan(rows_w, wf, dw, True)}",
                # a sum of F terms in another order: within F ulps of the sum
                # (the recursive-summation bound), at least the other
                # reductions' 1e-6; the max exact
                tol=max(TOLERANCES["reduce"], wf * 2.0 ** -24) if wk == "sum" else "exact",
                kernel=lambda x_=x_w, p_=pos_w, m_=mask_w, k=wk: gk.gather_reduce(x_, p_, m_, k),
                plain=lambda x_=x_w, p_=pos_w, m_=mask_w, k=wk: gk.gather_reduce_plain(
                    x_, p_, m_, k),
                library=lambda x_=x_w, fl=flat_w, of=offs_w, k=wk:
                torch.nn.functional.embedding_bag(fl, x_, of, mode=k),
                same_fn=lambda x_=x_w, p_=pos_w, m_=mask_w, k=wk: window_same_fn(x_, p_, m_, k),
                nbytes=5 * rows_w * wf + rows_bytes(distinct(valid_w), dw)
                + rows_bytes(rows_w, dw)))

    # -- bf16 compute: the block kernels on bf16 rows, the assembly to bf16 --
    # the same batch and blocks; block 0's rows are the f32 tier's assembly
    # to bf16, block 1's and the gradients the f32 tensors above rounded.
    # The bound counts bf16 rows (2 bytes a value).  launches: the bf16_train
    # runs (mean over the bf16 tier; sum over the f32 tier), the store_int8
    # run (int8 tier) and the device_epoch bf16 compute run
    bf = torch.bfloat16
    feats_bf = gk.assemble(cv, src_row, miss_feats, out_dtype=bf)
    h1_bf, g1_bf, g1n_bf = h1.to(bf), g1.to(bf), g1n.to(bf)
    bf_runs = {"mean": bf_launches, "sum": bf_gcn_launches}
    for rk in ("mean", "sum"):
        for label, src, blk in (("block0", feats_bf, b0), ("block1", h1_bf, b1)):
            flat, offs, _ = reduce_inputs(blk.neigh_pos, blk.neigh_mask)
            n, f = blk.neigh_pos.shape
            d = src.shape[1]
            n_s = blk.self_pos.shape[0]
            neigh_rows = blk.neigh_pos[blk.neigh_mask]
            cases.append(dict(
                name=f"block_gather_fwd_{rk}_bf16[{label}]", key=f"block_gather_fwd_{rk}_bf16",
                launches=bf_runs[rk][f"block_gather_fwd_{rk}_bf16"],
                replaces=f"{PALLAS}:58 gather_rows_pallas + {PALLAS}:132 gather_mean_pallas "
                         "(bf16 source rows)",
                shape=f"src {list(src.shape)} bf16 self_pos [{n_s}] pos/mask [{n}, {f}]",
                tol=("exact", "bf16"),
                kernel=lambda s=src, b=blk, k=rk: gk.block_gather_fwd(
                    s, b.self_pos, b.neigh_pos, b.neigh_mask, k),
                plain=lambda s=src, b=blk, k=rk: gk.block_gather_fwd_plain(
                    s, b.self_pos, b.neigh_pos, b.neigh_mask, k),
                library=lambda s=src, ids=blk.self_pos.long(), fl=flat, of=offs, k=rk: (
                    torch.index_select(s, 0, ids),
                    torch.nn.functional.embedding_bag(fl, s, of, mode=k)),
                same_fn=lambda s=src, b=blk, k=rk: fwd_same_fn(s, b, k),
                nbytes=4 * n_s + 5 * n * f + rows_bytes(distinct(blk.self_pos, neigh_rows), d, 2)
                + rows_bytes(n_s, d, 2) + rows_bytes(n, d, 2)))
        bs_bf, bn_bf = torch.zeros_like(h1_bf), torch.zeros_like(h1_bf)
        cases.append(dict(
            name=f"block_gather_bwd_{rk}_bf16[block1]", key=f"block_gather_bwd_{rk}_bf16",
            launches=bf_runs[rk][f"block_gather_bwd_{rk}_bf16"],
            replaces=f"{PALLAS}:58 gather_rows_pallas + {PALLAS}:132 gather_mean_pallas "
                     "(backward of both on bf16 gradients; JAX: autodiff of jnp.take)",
            shape=f"g_self {list(g1.shape)} bf16 self_pos [{n1}], g_neigh {list(g1n.shape)} "
                  f"bf16 pos/mask [{n1}, {f1}] -> {list(h1.shape)} bf16 (memset, the "
                  "reductions into an f32 table, grad_to_bf16: one C call)",
            tol="bf16",
            kernel=lambda k=rk: gk.block_gather_bwd(g1_bf, b1.self_pos, g1n_bf, b1.neigh_pos,
                                                    b1.neigh_mask, s1, k),
            plain=lambda k=rk: gk.block_gather_bwd_plain(g1_bf, b1.self_pos, g1n_bf,
                                                         b1.neigh_pos, b1.neigh_mask, s1, k),
            library=lambda ex=expanded(g1n_bf, rk), bs=bs_bf, bn=bn_bf: (
                bs.index_add_(0, ids1_l, g1_bf), bn.index_add_(0, flat1, ex)),
            same_fn=lambda k=rk: same_fn(g1_bf, g1n_bf, k),
            nbytes=4 * n1 + 5 * n1 * f1 + 2 * rows_bytes(n1, d1, 2) + rows_bytes(s1, d1, 2)))
    bf_assemble_runs = {"float32": bf_gcn_launches, "bfloat16": bf_launches,
                        "int8": q_launches}
    for dtype, tag in TIERS.items():
        cv_t, sr_t, mf_t, sc_t = tier_in[dtype]
        cases.append(dict(
            name=f"assemble[{tag}->bf16]", key=f"assemble_{tag}_to_bf16",
            launches=bf_assemble_runs[dtype][f"assemble_{tag}_to_bf16"],
            replaces=f"{PALLAS}:58 gather_rows_pallas (+ storage/cache.py:103 "
                     "assemble_features, :69 dequantize_fused, train/state.py:50 the bf16 cast)",
            shape=f"cache {list(cv_t.shape)} {cv_t.dtype} miss {list(mf_t.shape)} "
                  f"src_row [{n0}] -> bf16",
            tol="exact",
            kernel=lambda a=tier_in[dtype]: gk.assemble(*a, out_dtype=bf),
            plain=lambda a=tier_in[dtype]: gk.assemble_plain(*a, out_dtype=bf),
            library=None, same_fn=lambda a=tier_in[dtype]: assemble_same_fn(*a).to(bf),
            nbytes=4 * n0 + distinct(sr_t) * d0 * cv_t.element_size() + rows_bytes(n0, d0, 2)
            + (0 if sc_t is None else 4 * d0)))
    cv_f = d_full["bf16"][0]
    cases.append(dict(
        name="assemble_full[bf16->bf16]", key="assemble_bf16_to_bf16",
        launches=dev_out["bf16_compute"]["launches"]["assemble_bf16_to_bf16"],
        replaces=f"{PALLAS}:58 gather_rows_pallas (on-device layer-0 fetch at bf16 compute: "
                 "ops/gather.py:21 chunked_take + storage/cache.py:69 dequantize_fused "
                 "+ train/state.py:50 the bf16 cast)",
        shape=f"cache {list(cv_f.shape)} {cv_f.dtype} ids [{nd}], no miss rows -> bf16",
        tol="exact",
        kernel=lambda: take_rows(cv_f, d_ids, out_dtype=bf),
        plain=lambda: gk.assemble_plain(cv_f, d_ids, cv_f[:0], out_dtype=bf),
        library=lambda: torch.index_select(cv_f, 0, d_ids),
        same_fn=lambda: torch.index_select(cv_f, 0, d_ids),
        nbytes=4 * nd + nd_distinct * dd * 2 + rows_bytes(nd, dd, 2)))

    h1m_bf = h1m.to(bf)
    max_cases("bf16", feats_bf, h1m_bf, g1_bf, g1n_bf, 2, pool_bf16_launches, "bf16")

    cases.extend(family_cases)
    cases.extend(cv_cases)
    cases.extend(dp_cv_cases)
    entries, bad = [], []
    for c in cases:
        err, ok, tol_text = compare(torch, c["kernel"](), c["plain"](), c["tol"])
        entry = {
            "name": c["name"], "route": "cuda", "source": SOURCE,
            "replaces": c["replaces"],
            "launches": c.get("launches", (gcn_launches if c["key"].endswith("_sum")
                                           else launches)[c["key"]]),
            "max_abs_err": err, "tolerance": tol_text,
            "ms": time_ms(torch, c["kernel"], flush),
            "plain_ms": time_ms(torch, c["plain"], flush),
            "bound_ms": c["nbytes"] / bw * 1e3, "bound_by": "bytes",
            "bound_bytes": c["nbytes"],
            "library_ms": time_ms(torch, c["library"], flush) if c["library"] else None,
            "shape": c["shape"],
        }
        if "same_fn" in c:
            entry["library_same_fn_ms"] = time_ms(torch, c["same_fn"], flush)
            entry["library_same_fn_max_abs_err"] = compare(
                torch, c["same_fn"](), c["plain"](), c["tol"])[0]
        entry["bound_share"] = entry["bound_ms"] / entry["ms"]
        entries.append(entry)
        if not ok:
            bad.append(f"{c['name']}: max_abs_err {err} ({tol_text})")
    print(json.dumps({"kernels": entries}), flush=True)
    if bad:
        fail("kernels disagree with their plain versions: " + "; ".join(bad))

    # -- the block forward's other branches, and the backward's ----------------
    branches = fwd_branches(torch, gk, dev)
    emit("fwd_branches", branches)
    bad = [f"{b['case']}: {b['max_abs_err']} ({b['tolerance']})"
           for b in branches if not b["ok"]]
    if bad:
        fail("block gather branches disagree with their plain versions: " + "; ".join(bad))
    branches = assemble_branches(torch, gk, dev)
    emit("assemble_branches", branches)
    bad = [f"{b['case']}: {b['max_abs_err']}" for b in branches if not b["ok"]]
    if bad:
        fail("assembly branches disagree with their plain versions: " + "; ".join(bad))
    for phase, fn in (("window_branches", window_branches),
                      ("scatter_branches", scatter_branches)):
        branches = fn(torch, gk, dev)
        emit(phase, branches)
        bad = [f"{b['case']}: {b['max_abs_err']} ({b['tolerance']})"
               for b in branches if not b["ok"]]
        if bad:
            fail(f"{phase}: " + "; ".join(bad))

    # -- graph_block_kernels: the block kernels' forward and backward wrappers
    # captured in a CUDA graph (the backward launches from autograd's thread,
    # on the stream autograd runs it on) and replayed, against the eager call
    gen_g = torch.Generator(device=dev).manual_seed(9)
    g_src = torch.randn(b0.cap_dst, 2 * cfg.model.hidden, generator=gen_g, device=dev,
                        requires_grad=True)
    g_w = torch.randn(b1.cap_dst, 2 * cfg.model.hidden, generator=gen_g, device=dev)
    g_blk = Block(neigh_pos=b1.neigh_pos, neigh_mask=b1.neigh_mask, self_pos=b1.self_pos)

    def block_fwd_bwd():
        h_self, h_neigh = block_gather(g_src, g_blk, "mean")
        ((h_self * g_w).sum() + (h_neigh * g_w * 2).sum()).backward()
        return g_src.grad

    want_g = block_fwd_bwd().clone()
    g_src.grad = None
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        block_fwd_bwd()
    torch.cuda.current_stream(dev).wait_stream(side)
    g_src.grad = None
    gk.reset_launch_counts()
    block_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(block_graph):
        got_g = block_fwd_bwd()
    captured = {k: v for k, v in gk.launch_counts().items() if v}
    got_g.zero_()
    block_graph.replay()
    err, ok, text = compare(torch, got_g, want_g, "atomic")
    emit("graph_block_kernels", {"captured_launches": captured, "max_abs_err": err,
                                 "tolerance": text})
    if not ok or captured != {"block_gather_fwd_mean": 1, "block_gather_bwd_mean": 1}:
        fail(f"the block kernels replayed from a CUDA graph: error {err} ({text}), "
             f"captured launches {captured}")
    del block_graph, got_g

    # what the times above cannot go below: the event pair around no work,
    # the block backward's memset of its table alone (its C entry point with
    # both halves absent), and a streamed copy of the block-0 forward's bytes
    table = torch.empty_like(h1)
    fwd0_bytes = next(c["nbytes"] for c in cases if c["name"] == "block_gather_fwd_mean[block0]")
    copy_src = torch.empty(fwd0_bytes // 2, dtype=torch.uint8, device=dev)
    copy_dst = torch.empty_like(copy_src)
    emit("timing_floor", {
        "empty_event_pair_ms": time_ms(torch, lambda: None, flush),
        "block_bwd_memset_ms": time_ms(torch, lambda: gk._lib().pg_block_gather_bwd(
            None, None, None, 0, None, None, None, 0, 0, table.data_ptr(), None, s1, d1, 0, 1, 0,
            torch.cuda.current_stream(dev).cuda_stream), flush),
        "memset_shape": [s1, d1],
        "copy_block0_fwd_bytes_ms": time_ms(torch, lambda: copy_dst.copy_(copy_src), flush),
        "copy_bytes_moved": 2 * copy_src.numel()})

    # -- step parity ------------------------------------------------------------
    def clone_state(src, c):
        """A train state with a copy of ``src``'s model and dropout
        generator and a fresh optimizer for config ``c``."""
        model = copy.deepcopy(src.model)
        g = torch.Generator(device=dev)
        g.set_state(src.generator.get_state())
        return TrainState(model=model, optimizer=make_optimizer(c, model.parameters()),
                          generator=g, dtype=src.dtype)

    parities = {}
    for dtype, tag in TIERS.items():
        cv_t, sr_t, mf_t, sc_t = tier_in[dtype]
        s_kernel, s_plain = clone_state(tr.state, cfg), clone_state(tr.state, cfg)
        gk.reset_launch_counts()
        m_kernel = train_step(s_kernel, mb, mf_t, sr_t, cv_t, sc_t)
        with gk.plain_versions():
            m_plain = train_step(s_plain, mb, mf_t, sr_t, cv_t, sc_t)
        torch.cuda.synchronize()
        counts = gk.launch_counts()
        l_k, l_p = m_kernel["loss"].item(), m_plain["loss"].item()
        parity = {"loss_kernel": l_k, "loss_plain": l_p,
                  "loss_rel_err": abs(l_k - l_p) / max(abs(l_p), 1e-30),
                  "kernel_launches": sum(counts.values()),
                  "assemble_launches": counts[f"assemble_{tag}"], "grads": {}}
        for (name, pk), (_, pp) in zip(s_kernel.model.named_parameters(),
                                       s_plain.model.named_parameters()):
            err = (pk.grad - pp.grad).abs().max().item()
            parity["grads"][name] = err / max(pp.grad.abs().max().item(), 1e-30)
        parities[dtype] = parity
    emit("step_parity", parities)
    for dtype, parity in parities.items():
        worst = max([parity["loss_rel_err"], *parity["grads"].values()])
        if not worst <= 1e-5:
            fail(f"step parity ({dtype} cache): worst relative error {worst} > 1e-5")
        if parity["kernel_launches"] != 4 or parity["assemble_launches"] != 1:
            fail(f"the kernel step ({dtype} cache) launched {parity['kernel_launches']} "
                 "kernels, expected 4 with one assembly of its tier")

    # -- bf16_step_parity: one bf16-compute step a tier, kernel and plain -----
    # from the bf16_train model; the loss within 1e-2 relative and each
    # gradient within ||g - g_plain|| <= 2e-2 ||g_plain|| (bf16 reductions
    # round in another order); 5 launches, all bf16; the assembly to bf16
    # bit-equal to its plain version
    bf_parities = {}
    for dtype, tag in TIERS.items():
        cv_t, sr_t, mf_t, sc_t = tier_in[dtype]
        s_kernel, s_plain = clone_state(bf_tr.state, bf_cfg), clone_state(bf_tr.state, bf_cfg)
        gk.reset_launch_counts()
        m_kernel = train_step(s_kernel, mb, mf_t, sr_t, cv_t, sc_t)
        with gk.plain_versions():
            m_plain = train_step(s_plain, mb, mf_t, sr_t, cv_t, sc_t)
        torch.cuda.synchronize()
        counts = {k: v for k, v in gk.launch_counts().items() if v}
        l_k, l_p = m_kernel["loss"].item(), m_plain["loss"].item()
        parity = {"loss_kernel": l_k, "loss_plain": l_p,
                  "loss_rel_err": abs(l_k - l_p) / max(abs(l_p), 1e-30),
                  "launches": counts,
                  "assemble_bit_equal": torch.equal(gk.assemble(*tier_in[dtype], out_dtype=bf),
                                                    gk.assemble_plain(*tier_in[dtype],
                                                                      out_dtype=bf)),
                  "grads_rel_norm_err": {}}
        for (name, pk), (_, pp) in zip(s_kernel.model.named_parameters(),
                                       s_plain.model.named_parameters()):
            parity["grads_rel_norm_err"][name] = (
                (pk.grad - pp.grad).norm().item() / max(pp.grad.norm().item(), 1e-30))
        bf_parities[dtype] = parity
    emit("bf16_step_parity", bf_parities)
    for dtype, parity in bf_parities.items():
        tag = TIERS[dtype]
        if not (parity["loss_rel_err"] <= 1e-2
                and max(parity["grads_rel_norm_err"].values()) <= 2e-2):
            fail(f"bf16 step parity ({dtype} cache): {parity}")
        if parity["launches"] != {f"assemble_{tag}_to_bf16": 1, "block_gather_fwd_mean_bf16": 2,
                                  "block_gather_bwd_mean_bf16": 1, "grad_to_bf16": 1}:
            fail(f"bf16 step parity ({dtype} cache): launches {parity['launches']}, expected "
                 f"one assemble_{tag}_to_bf16, two bf16 block forwards, one bf16 backward "
                 "and one grad_to_bf16")
        if not parity["assemble_bit_equal"]:
            fail(f"bf16 step parity ({dtype} cache): the assembly to bf16 is not bit-equal")

    # -- breakdown: host pipeline alone vs device step alone -----------------
    t0 = time.perf_counter()
    n_items = sum(1 for _ in tr.loader.epoch())
    torch.cuda.synchronize()
    loader_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sum(1 for _ in bf_tr.loader.epoch())
    torch.cuda.synchronize()
    loader_bf_s = time.perf_counter() - t0

    s_bench = clone_state(tr.state, cfg)
    t_step = host_and_device(lambda: train_step(s_bench, mb, miss_feats, src_row, cv),
                             dev_reps=4)
    cv_b, sr_b, mf_b, _ = tier_in["bfloat16"]
    s_bench_bf = clone_state(bf_tr.state, bf_cfg)
    t_step_bf = host_and_device(lambda: train_step(s_bench_bf, mb, mf_b, sr_b, cv_b),
                                dev_reps=4)
    emit("breakdown", {
        "loader_only_epoch_s": loader_s, "loader_batches": n_items,
        "train_epoch_s": epochs[1].time_s,
        "step_host_enqueue_ms": t_step["host_enqueue_ms"], "step_wall_ms": t_step["wall_ms"],
        "step_device_ms": t_step["device_ms"],
        "device_time_is_pure": t_step["device_time_is_pure"],
        "sleep_ms": t_step["sleep_ms"],
        "bf16_step": {"cache": "bfloat16", "compute": "bfloat16", **t_step_bf,
                      "loader_only_epoch_s": loader_bf_s,
                      "train_epoch_s": bf_epochs[1].time_s},
        "note": "steps on one pre-shipped batch, no loader threads running",
    })

    # -- device_sampler_parity: the sampler on the card and on the CPU ---------
    # one batch of the f32 run's epoch 0, fresh draws for each kind; the same
    # function on CPU copies of the same tensors must give equal batches
    nh, fanouts, bsz = dcfg.sampler.num_hops, dcfg.sampler.hop_fanouts(), dcfg.sampler.batch_size
    csr_cpu = DeviceCSR.from_graph(ds.graph, "cpu")
    gen_d = torch.Generator(device=dev).manual_seed(8)

    def fresh_draws(paired: bool):
        return [hop_draws(gen_d, n, f, paired, dev)
                for n, f in zip(hop_sizes(bsz, fanouts), fanouts)]

    def batch_tensors(m):
        return (list(m.layer_nids) + list(m.layer_mask) + [m.labels]
                + [t for b in m.blocks for t in (b.neigh_pos, b.neigh_mask, b.self_pos)])

    sampler_parity = {}
    for paired in (False, True):
        draws_p = fresh_draws(paired)
        mb_g = sample_minibatch_device(dtr._dev_csr, d_step[0], d_step[1], nh, fanouts, draws_p,
                                       labels=dtr._dev_labels, paired=paired)
        mb_c = sample_minibatch_device(csr_cpu, d_step[0].cpu(), d_step[1].cpu(), nh, fanouts,
                                       [x.cpu() for x in draws_p],
                                       labels=dtr._dev_labels.cpu(), paired=paired)
        pairs = list(zip(batch_tensors(mb_g), batch_tensors(mb_c)))
        sampler_parity["paired" if paired else "generic"] = {
            "equal": all(torch.equal(g.cpu(), c) for g, c in pairs), "tensors": len(pairs),
            "layer_rows": [x.shape[0] for x in mb_g.layer_nids],
            "valid_edges": int(sum(b.neigh_mask.sum() for b in mb_g.blocks)),
            "prefix_layout": all(b.prefix_layout for b in mb_g.blocks)}
    del csr_cpu
    emit("device_sampler_parity", sampler_parity)
    for kind_, r in sampler_parity.items():
        if not (r["equal"] and r["prefix_layout"]):
            fail(f"device sampler ({kind_}): the card's batch differs from the CPU's: {r}")

    # -- device_step_parity: one device-sampled step, kernel and plain --------
    dev_parities = {}
    for label in ("f32", "bf16_paired", "int8_paired"):
        t_d = dev_tr[label]
        tag = TIERS[t_d.cfg.cache.dtype]
        step_in = (d_step[0], d_step[1], fresh_draws(t_d.cfg.sampler.paired_draws),
                   t_d._dev_labels, t_d._dev_csr, t_d.cache.cache_values,
                   t_d.cache.dequant_scale_dev)
        res = {}
        for mode in ("kernel", "plain"):
            s_m, acc_m = clone_state(t_d.state, t_d.cfg), EpochAccumulator.zeros(dev)
            gk.reset_launch_counts()
            with (gk.plain_versions() if mode == "plain" else contextlib.nullcontext()):
                device_batch_step(t_d.cfg, s_m, acc_m, *step_in)
            torch.cuda.synchronize()
            res[mode] = (s_m, acc_m.values(), gk.launch_counts())
        (s_k, v_k, c_k), (s_p, v_p, c_p) = res["kernel"], res["plain"]
        parity = {"loss_kernel": v_k["loss_sum"], "loss_plain": v_p["loss_sum"],
                  "loss_rel_err": abs(v_k["loss_sum"] - v_p["loss_sum"])
                  / max(abs(v_p["loss_sum"]), 1e-30),
                  "edges": [v_k["edges"], v_p["edges"]],
                  "kernel_launches": sum(c_k.values()),
                  "assemble_launches": c_k[f"assemble_{tag}"],
                  "plain_launches": sum(c_p.values()), "grads": {}}
        for (name, pk), (_, pp) in zip(s_k.model.named_parameters(),
                                       s_p.model.named_parameters()):
            err = (pk.grad - pp.grad).abs().max().item()
            parity["grads"][name] = err / max(pp.grad.abs().max().item(), 1e-30)
        dev_parities[label] = parity
    emit("device_step_parity", dev_parities)
    for label, parity in dev_parities.items():
        worst = max([parity["loss_rel_err"], *parity["grads"].values()])
        if not worst <= 1e-5:
            fail(f"device step parity ({label}): worst relative error {worst} > 1e-5")
        if parity["edges"][0] != parity["edges"][1]:
            fail(f"device step parity ({label}): edges {parity['edges']} differ")
        if (parity["kernel_launches"], parity["assemble_launches"],
                parity["plain_launches"]) != (sum(DEVICE_STEP.values()), 1, 0):
            fail(f"device step parity ({label}): launches {parity}, expected {DEVICE_STEP} "
                 "through the kernels and none under the plain versions")

    # -- device_breakdown: one on-device step alone (f32, generic draws) ------
    s_b, acc_b = clone_state(dtr.state, dcfg), EpochAccumulator.zeros(dev)
    d_cv = d_full["f32"][0]
    fetched = fetch_batch(dcfg, d_step[0], d_step[1], d_step[2], dtr._dev_labels,
                          dtr._dev_csr, d_cv)
    parts = {
        "step": lambda: device_batch_step(dcfg, s_b, acc_b, *d_step, dtr._dev_labels,
                                          dtr._dev_csr, d_cv),
        "sample": lambda: sample_minibatch_device(dtr._dev_csr, *d_step[:2], nh, fanouts,
                                                  d_step[2], labels=dtr._dev_labels),
        "fetch": lambda: take_rows(d_cv, d_ids),
        "train": lambda: train_batch(s_b, acc_b, *fetched),
    }

    def profiled(fn):
        """CUDA kernels, memory operations and their summed device time in
        one call, from a torch.profiler trace (the second of two calls, each
        traced), and the host operations with the most time of their own."""
        from torch.profiler import ProfilerActivity, profile
        for _ in range(2):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        host_ops = sorted((a for a in prof.key_averages() if a.self_cpu_time_total > 0),
                          key=lambda a: -a.self_cpu_time_total)[:10]
        evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        mem = [e for e in evs if "memcpy" in e.name.lower() or "memset" in e.name.lower()]
        names: dict = {}
        for e in evs:
            names[e.name[:60]] = names.get(e.name[:60], 0) + 1
        return {"cuda_kernels": len(evs) - len(mem), "cuda_memory_ops": len(mem),
                "profiler_device_ms": sum(e.time_range.elapsed_us() for e in evs) / 1e3,
                "most_launched": sorted(names.items(), key=lambda kv: -kv[1])[:12],
                "host_self_ms_top": [[a.key[:60], a.count, a.self_cpu_time_total / 1e3]
                                     for a in host_ops]}

    # no host sync inside a step: the sync debug mode raises on one
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        parts["step"]()
        sync_free = True
    except RuntimeError as e:
        sync_free = f"{type(e).__name__}: {e}"
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # one replayed step: the steps mode's step graph on the same state,
    # reading the f32 run's last epoch schedule
    _, parts["replayed_step"] = make_device_step_fns(dcfg, s_b, dtr.epoch_inputs,
                                                     dtr.device_data(), graph=True)
    breakdown_d = {name: {**host_and_device(fn), **profiled(fn)} for name, fn in parts.items()}
    breakdown_d["step_is_sync_free"] = sync_free
    breakdown_d["epoch_s"] = {"eager": dev_out["f32"]["epochs"][0]["time_s"],
                              "replayed": dev_out["f32"]["epochs"][1]["time_s"]}
    breakdown_d["epoch_batches"] = dev_out["f32"]["epochs"][1]["batches"]
    breakdown_d["note"] = ("device_batch_step on one device-sampled batch of the f32 run "
                           "(generic draws): sample, fetch (take_rows) and train "
                           "(forward, loss, backward, Adam) are its parts; replayed_step "
                           "replays the steps mode's CUDA graph of one step")
    emit("device_breakdown", breakdown_d)
    if sync_free is not True:
        fail(f"a device step synchronized with the host: {sync_free}")
    free_memory()

    # -- cli: the training CLI at the bench width, traced ------------------------
    # last: after its traces, a torch.profiler trace's events() held no CUDA
    # activity on the card (scatter_branches' and device_breakdown's counts read them)
    with tempfile.TemporaryDirectory() as cli_root:
        cli_out, bad = cli_phase(types.SimpleNamespace(torch=torch, gk=gk, ds=ds,
                                                       Trainer=Trainer), cli_root)
        cli_out["nvidia_smi"] = smi
        emit("cli", cli_out)
        if bad:
            fail("cli: " + "; ".join(bad))
        free_memory()

        # -- cli_tools: eval, infer and analyze over the cli phase's files, and
        # the offline tools on RMAT-16 -------------------------------------------
        tools_out, bad = cli_tools_phase(
            types.SimpleNamespace(np=np, torch=torch, gk=gk, ds=ds,
                                  train_miss_rate=train_out["epochs"][0]["miss_rate"]),
            cli_root)
    tools_out["nvidia_smi"] = smi
    emit("cli_tools", tools_out)
    if bad:
        fail("cli_tools: " + "; ".join(bad))
    free_memory()

    # -- bench: bench_torch.run's full and device phases and its line -----------
    bench_out, bad = bench_phase(types.SimpleNamespace(torch=torch, gk=gk, ds_nb=ds_nb,
                                                       Trainer=Trainer))
    bench_out["nvidia_smi"] = smi
    emit("bench", bench_out)
    if bad:
        fail("bench: " + "; ".join(bad))

    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-gpus"]:
        dp_gpus_main(int(sys.argv[2]))
    else:
        main()
