#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one NVIDIA GPU (H100) and check it.

    python3 chip_smoke.py

Needs one CUDA device, ``g++`` (and zlib) and ``nvcc``; builds the host
library, the SSD tier's library (which holds the PS service too) and the
three CUDA kernel libraries from the checkout at first use, in parallel
(into ``paddle_tpu_torch/_build/``). Phase 13 starts PS servers on
127.0.0.1 (ephemeral ports) and closes them; phase 14 starts the job's
server and trainer processes (ports on 127.0.0.1 it checks are free)
and waits for them, or ends them; phase 15 starts its three legs' processes
one at a time and waits for each (a leg past its time limit is killed);
phase 16 starts its in-process clusters on 127.0.0.1 and four server
processes, and kills and reaps every one of them; phase 17 starts and
stops in-process clusters on 127.0.0.1; phase 20 starts serving member
processes (``python -m paddle_tpu_torch.serving.member_host``), kills one
and stops the others; phase 22 starts one serving child (this script in
``--serve-export DIR`` mode) and waits for it; phase 24 starts three PS
servers on 127.0.0.1 and closes them, and one child (``--heter-head
PORT``, the heter pipeline's CPU head) and waits for it; phase 25 starts
one child (``--fleet-source CONFIG.json``, the fleet executor's
source) and waits for it, and ``elastic_launch_local`` starts and reaps
its trainers (``--elastic-trainer CONFIG.json``). Exits non-zero, with no
result line, when there is no CUDA device, when the package is missing,
or when any phase fails. Phases:

1. device: the card's name and power limit, build seconds;
2. kernels vs plain at the main paths' shapes (n = 4096·26 = 106,496,
   dim 8), bitwise, with kernel and plain times (CUDA events, L2 flushed
   before each launch) beside the HBM byte bound:
   ``ctr_sparse_rows`` over the rule matrix in both forms (in place by
   index, with padding and negative rows, int32 and int64 rows; rows in
   and out, the same kernel on copies of the rows), each with a short last
   tile, and the in-place form's time on a pass-path push, checked there
   too, beside the layout's sector floor; ``hot_probe_gather`` and
   ``hot_probe`` over a 2^19-row tier with banks 1, 4 and 8, resident and
   absent keys (``hot_probe`` also at one shard's n = 26,624);
   ``hot_scatter_apply`` over the rule matrix × ``create_applies_grad``
   with duplicates, sentinels and negative rows (its plain version runs
   on the CPU copy of the inputs); the pass cache's merge on the card
   against the merge on the CPU; the radix sort in front of both against
   ``torch.sort(stable=True)``, bitwise in both modes, at the hot path's
   batch, one shard's owner push and the heavy-hitter batch, timed beside
   it; B4's, the merge's and the sort's device kernels per call (torch
   profiler), and the pass push's (a CUDA graph's nodes: the merge's
   kernels and one more); B4 on the heavy-hitter batch at several block
   thresholds;
3. pass path at full width: DeepFM (26 slots, 13 dense, dim 8, DNN
   400³) GPUPS pass training over a 16-shard host table and a 2^21-row
   device cache, batch 4096, slab 8, 6 slabs (1 warm-up), in f32 and then
   with ``amp=True`` (bench.py's default: the tower's products in bf16),
   each from fresh dense weights on the same slabs: losses finite and
   falling, one ``ctr_sparse_rows`` launch (its in-place form) and one
   merge launch per step, samples/s of both legs; then a predict batch
   through ``serving_pull`` and the flush back to the host table;
4. hot path at full width: the same DeepFM trained by
   ``CtrStreamTrainer(hot_tier=HotTierConfig(capacity=2^19))`` over a
   16-shard host table, two epochs of an ``InMemoryDataset`` of 32,768
   MultiSlot lines (10,000 ids per slot; cut from 65,536 for the script's
   time limit): one ``hot_probe_gather`` and
   one ``hot_scatter_apply`` launch per step, a warm second epoch with no
   cold fetch and no miss and a lower loss, warm samples/s and the host
   ms per step in ``ensure()`` + ``device_state()`` against the step's
   own; then the flush back to the host table; then the same two epochs
   with the tier row-sharded over a mesh of 4 shards on the card
   (``HotTierConfig(mesh=make_mesh({"ps": 4}))``, one bank per shard,
   alltoall routing): four ``hot_probe`` and four ``hot_scatter_apply``
   launches per step, routing overflow 0;
5. card vs CPU: the small pass run on ``cuda`` and ``cpu`` from the same
   weights, and the key hash bit-equal on both; the small hot-tier
   harness (eviction churn) on the card: tier ≡ no tier and
   ``"auto"`` ≡ ``"unfused"`` bitwise, and card vs CPU within tolerance;
   the same for the 4-shard tier, which also stays within atol 1e-6 of
   the single-card tier; the sharded pass step from keys, routed ≡
   gathered bitwise;
6. the flash-attention kernels (B5 forward, B6 dQ, B7 dK/dV) against
   their plain versions at ERNIE's shape [8, 512, 16, 64] f32, both
   precisions, causal or not, a ring-style call (q_offset 256, half-length
   K/V) and an unaligned length (500, also against ``local_attention``);
   out, lse and the gradients of a numpy-seeded dO and dlse; B5, B6 and
   B7 run twice at ERNIE's call and give the same bits; kernel, plain and
   ``scaled_dot_product_attention`` (bf16) times beside the bound, B5
   against SDPA's forward and B6 + B7 against its backward, each with its
   share of its bound;
7. ERNIE path at full width: ``Trainer(Ernie(cfg), Adam(1e-4), lm_loss)``
   (vocab 32,768, hidden 1024, 16 heads, ffn 4096, 8 layers, batch 8 ×
   seq 512) on one numpy-seeded batch, 2 warm-up and 10 timed steps: loss
   finite and falling, 8 launches of each flash kernel per step,
   tokens/s, ms/step and peak memory;
8. ERNIE card vs CPU: a small ERNIE (2 layers, hidden 64, 4 heads, seq
   64, batch 2), causal and not, 3 steps from the same weights with the
   kernels on the card and their plain versions on the CPU;
9. ResNet-50 at full width (25.6 M parameters, 1000 classes):
   ``Trainer(resnet50(), Momentum(0.1, 0.9, weight_decay=1e-4),
   CrossEntropyLoss(), amp=...)`` on a numpy-seeded batch of 128 × 3 ×
   224 × 224, amp False, "O1" and "O2", 2 warm-up and 10 timed steps
   each: losses finite, every BatchNorm buffer moved, O2's bf16 params
   equal to their f32 masters cast down; ms/step, images/s, peak memory
   (and, at the end, device kernels per step);
10. LeNet through ``hapi.Model`` on the synthetic MNIST (2048 train and
   2048 test images), batch 64, 2 epochs, ``amp_configs`` O0 and O1: fit
   time, loss falling, test accuracy at least 0.8 of what the data allows
   (its classes share three patch positions: at most ~0.32);
11. vision card vs CPU: a ResNet of one bottleneck a stage (64×64, batch
   8) and LeNet, 3 ``Trainer`` steps in f32 and O1 from the same weights
   (in O1 the CPU side rounds each conv output to bf16 as cuDNN does on
   the card: ``amp.card_conv_rounding``);
12. Wide&Deep daily at full width (BASELINE.md config 4, as
   ``tools/widedeep_daily.py`` runs it): ``WideDeep`` (8 slots, 4 dense,
   dim 8, DNN 128²) trained by ``CtrPassTrainer`` over a 16-shard
   ``SsdSparseTable`` holding 1,000,000 cold rows (the tool's 5,000,000 cut
   for the script's time limit), three days of 50,000
   records, batch 512, the next day's pass built in the background; one
   ``ctr_sparse_rows`` launch and one merge a step, the merge (card vs
   CPU) and B1 (against its plain version) bitwise on one real push of
   the path, losses falling, each
   day's final-model AUC against the bar 0.80, base save, shrink and
   spill (hot + cold = size). Leg B, the cold tier at scale: the table
   streamed to one raw file (``save_file``), loaded back into a fresh fp32
   table (digest equal) and into an fp16, block-compressed, admission-gated
   (threshold 2), background-compacted (64 MB/s budget) table built by
   ``load_ps_config``; one day of 50,000 records in 2 passes over it, a
   long tail of new ids offered to admission: one B1 and one merge a step,
   both bitwise on one real push (``ctr_sparse_rows@ssd_scale``), rejects
   and admissions counted, index bytes a row ≤ 16, a forced compaction
   drained with the digest unchanged, the ``ssd_*`` series and the
   cold-tier SLO rules over them; then card vs CPU at a small size and a
   trainer save/load round trip on the card (a Wide&Deep step's device
   kernels are counted at the end, with the other profiler windows);
13. the the_one_ps rung (BASELINE.md config 3, as
   ``tools/sparse_hot_bench.py`` runs it): phase 4's DeepFM and data
   trained by ``CtrStreamTrainer(communicator=HalfAsyncCommunicator(
   RpcPsClient(...)), table_id=0)`` against two in-process
   ``NativePsServer``s on 127.0.0.1 (a 16-shard table), two epochs,
   RPC-only (no table kernel; wire pull/push and step ms a step, client ops
   a step) and over ``HotTierConfig(capacity=2^19)`` on fresh servers (one
   B2 and one B4 a step; a warm epoch with no miss, no cold fetch and no
   table RPC); losses falling; after the flush the servers hold the data's
   distinct keys; B2 and B4 bitwise against their plain versions on one
   real batch of the tier leg and timed there; then, small (3 slots, 400
   ids, capacity 224, ``SyncCommunicator``), tier over RPC ≡ RPC-only over
   RPC bitwise on the card, and card vs CPU;
14. the PaddleRec job (BASELINE.md config 3 as a PaddleRec job runs it):
   65,536 of phase 4's MultiSlot lines in 8 part files; the job's
   processes are this script in ``--ps-job CONFIG.json`` mode, started by
   ``distributed.launch.launch_local`` (2 server processes; the role env
   wires them through ``fleet``; the config dict goes through
   ``ps.config.load_ps_config``: DeepFM at phase 4's width, Adam).
   Leg A, ``sync_mode: async``, 2 trainers: each loads its
   ``fleet.util.get_file_shard`` through the native feed (4 threads),
   ``global_shuffle(util=fleet.util)``, trains ``CtrStreamTrainer`` over
   ``fleet.communicator`` for 2 epochs at batch 4096, ``stop_worker``,
   the closing barrier; trainer 0 saves the tables and stops the servers.
   Checks: exit codes 0, records conserved by the shuffle (counts, each
   within 2 % of half, an order-free digest of the files), losses falling,
   no table kernel, the saved rows = the data's distinct keys, also loaded
   into a fresh local ``Fleet``. Leg B, ``sync_mode: gpubox``, 1 trainer:
   one ``CtrPassTrainer`` pass over ``RemoteSparseTable`` (16 steps, 16
   B1 launches, B1 bitwise on its first real push inside the trainer
   process, losses falling, the servers' rows = the data's keys). Leg C:
   ``Trainer.train_from_dataset`` over a ``QueueDataset`` of the files (a
   2-layer MLP over the dense slots, 1 epoch on the card);
15. the job restarts (a the_one_ps stream job's checkpoint, as a
   preempted job meets it): three processes of this script in
   ``--ckpt-job CONFIG.json`` mode, one after another, each with two
   in-process ``NativePsServer``s on 127.0.0.1 (phase 13's 16-shard table,
   ``initial_range=0``), a ``SyncCommunicator`` and
   ``CtrStreamTrainer(hot_tier=HotTierConfig(capacity=2^19))`` at phase
   4's width on phase 4's data (8 batches of 4096), checkpointing
   every 2 batches through ``JobCheckpointManager`` under
   ``CheckpointGate(servers=...)``: the oracle (the epoch, into its own
   root); the victim (``ckpt.manifest=kill-job:after=3``: must exit -9 and
   leave ``ckpt_0`` and ``ckpt_1`` published, ``ckpt_2.tmp`` not); one
   byte of ``ckpt_1``'s sparse artifact flipped; the resume (a fresh
   process: ``load_latest`` falls back to ``ckpt_0``, cursor batch 2, one
   fallback; the servers' rows and the dense tier restored; the other 6
   batches). Checks: one B2 and one B4 a step in every leg, the loss
   falling, and the resumed run's rows pulled for the data's keys, dense
   params, Adam state, per-step losses and table digest bitwise equal to
   the oracle's. Logs the tier flush, gate pause, capture and write ms a
   checkpoint, its bytes, and the resume's ``load_latest``,
   ``restore_sparse`` and ``restore_train_state`` seconds;
16. the PS loses a primary (PS high availability and the compressed
   sparse wires): phase 4's width, model and data (32,768 lines: one
   cold epoch of 8 batches a run, cut from 16 for the script's time
   limit) on phase 13's 16-shard table (``initial_range=0``),
   every run on a fresh ``ha.HACluster(num_shards=2, replication=2,
   sync=True)`` of in-process servers. Leg A, the wire ladder: RPC-only
   over a ``HalfAsyncCommunicator`` with push wires fp32, fp16 and int8
   (error feedback, block 128): the push-byte counter equals 56 / 38 /
   33 B a merged row (+ 56 B a residual row the closing drain pushes), no
   residual after the closing quiesce, primary ≡ backup digests, losses
   falling, and once the data's keys pulled over the fp16 wire equal the
   fp32 pull rounded to half bitwise. Leg B, failover through a
   ``SyncCommunicator`` with ``cluster.drain()`` after every call that
   changes the servers, an oracle and a chaos run per arm: RPC-only
   (``kill-shard`` on shard 0's primary at its 6th push; afterwards the
   dead replica restarts and rejoins, every replica's digest equal) and
   over ``HotTierConfig(capacity=2^19)`` (``kill-shard`` on shard 1's
   primary at its 7th export, a miss fill; a checkpoint every 4 batches
   under ``cluster.checkpoint_gate()``, each manifest's digest equal to
   every live replica's at the cut; one B2 and one B4 a step, both
   bitwise against their plain versions on the first batch after the
   promotion). Checks: a promotion, the victim stopped, the chaos run's
   rows pulled for the data's keys, dense params, Adam state and per-step
   losses bitwise equal to its oracle's. Leg C: four processes of this
   script in ``--ha-server STORE JOB SHARD`` mode (2 shards x 2 replicas
   over a ``FileStore``, started together), the parent's
   ``FailoverCoordinator`` and leg B's RPC-only run through ``HARouter``
   with ``drain_remote`` after every change, shard 0's primary process
   SIGKILLed after batch 5: bitwise equal to leg B's RPC-only oracle, the
   routing names the backup, every process reaped. Logs samples/s per leg
   and arm, the recovery ms, the chaos step beside the median, push bytes,
   the loss curves, the tier's gate pause and capture ms;
17. the PS reshards under load (live resharding): phase 16's cell,
   every run on a fresh 2 x 2 sync ``HACluster`` through a
   ``SyncCommunicator`` with ``cluster.drain()`` after every change. Leg
   A, RPC-only, 3 epochs: an oracle, and a chaos run that arms
   ``kill-shard`` on shard 0's primary for its first kSaveAll (the grow's
   snapshot read) and starts ``ReshardController.grow(2)`` on a thread
   before epoch 2, joins it (4 shards, no error) and starts ``shrink(2)``
   before epoch 3, and joins that after it. Checks: no error reaches the
   trainer, the events are grow then shrink, a promotion, 2 shards and
   every live replica's digest equal at the end, and the table's size and
   digest sum, the rows pulled for the data's keys, dense params, Adam
   state and per-step losses bitwise equal to the oracle's. Leg B, over
   ``HotTierConfig(capacity=2^19)``, 2 epochs: an oracle, and a run that
   grows after the cold epoch and calls ``tr.on_reshard()`` (occupancy
   unchanged, one reshard, 4 servers), trains the warm epoch across the
   flip with 0 client ops and one B2 and one B4 a step (both bitwise
   against their plain versions on its first batch), flushes, and shrinks
   back; bitwise equal to its oracle as leg A. Logs samples/s per epoch,
   each operation's bootstrap s, cutover pause ms and rows moved, the
   promotion's call and the steps the cutovers land in beside the median;
18. tenants share a PS, and replicas serve (``ps.tenancy``, the serve QoS
   class, ``serving``): one 2 × 2 sync ``HACluster`` with a
   ``TenantDirectory``: ``ctr`` (tid 1) and ``abuse`` (tid 9, batch class,
   a 500/s bucket of 500, 500 rows a shard). Leg A: the ``ctr`` tenant
   trains phase 17 leg B's cell through ``d.client("ctr")`` on
   ``tenant_table_id(1, 0)`` (tier, ``SyncCommunicator``, 2 epochs) while
   the abuser floods from a thread (512-key pulls that create rows,
   probes of the ``ctr`` table); the abuser met ``ThrottledError``,
   ``QuotaExceededError`` and ``WrongTenantError``, its rows stay within
   the cap plus one frame a shard, and the tenant's table size, digest
   sum, rows, dense params, Adam state and per-step losses are bitwise
   equal to phase 17 leg B's oracle (the same computation without tenants
   or abuser); B2 and B4 bitwise on the first warm batch. Leg B: the
   trained dense tower goes out through ``DenseTowerPublisher`` on
   ``tenant_table_id(1, 7)``; one read-only ``ServingReplica`` a shard,
   ``make_serve_client``, ``CachedLookup`` over a read-only tier of 2^19
   rows on the card and a ``ServingFrontend`` (max batch 64) whose infer is
   the DeepFM forward on the card on the params ``DenseTowerSync``
   delivers; 2,000 warm requests (one record each) from 8 closed-loop
   submitters: the first 512 predictions against the forward on the
   trained params and the primaries' rows (rtol 1e-5, atol 1e-6), 0 client
   ops on the training clients and the serve client, then 25 freshness
   probes beside the flood with no failure. Logs samples/s alone and
   beside the abuser, the abuser's sheds, warm p50/p99, freshness p95;
19. the PS seen from the server, measured placement and a serving fleet
   (see that section's comment);
20. the recsys serve path (``models.{gru4rec,dssm,tdm}``,
   ``serving.{pipeline,member_host}``; ``tools/recsys_replay.py``'s
   configuration: 20,000 item keys, dim 8, GRU4Rec hidden 16 / out 16,
   history 6, fanout 2 × 8, top-K 8, ranking batches of up to 32 in a 4
   ms window, 2 member processes). Leg A: GRU4Rec (T 6, lengths 2-6),
   DSSM (6 query slots, 1 doc slot) and TDM (a branch-2 tree over the
   20,000 items, one negative a layer) each train 16 steps at batch 128
   on the card and on the CPU from the same numpy seed, for seeds 0-2:
   losses, params and cache columns card vs CPU within ``RS_TOL`` (set
   from those three seeds on the H100, per family), one B1
   and one merge a step, B1 bitwise on each family's first push (timed on
   GRU4Rec's), the trained TDM's beam (k 8) on the card equal to the CPU
   walk over the same state. Leg B: a 1-shard HACluster over a FileStore,
   a stream trainer in the background, a parent-side replica and cached
   lookup on the card, 2 ``spawn_member`` processes on the card behind a
   router and a lease-watched fleet, and a ``PipelineFrontend`` ranking
   with leg A's GRU4Rec; open loop with Zipf users and candidates: a 10 s
   ramp 15 → 60/s with one member SIGKILLed mid-way, a 6 s tail at 60/s,
   and a canary/promote/rollback over 400 requests. Checks: 0 errors,
   answers best first, coalesce factor > 1, stragglers counted, the crash
   removed by the lease watch, v1 restored crc32c-identical on every live
   member, the sampled ranking batches and the DSSM ranker within 1e-5 of
   the CPU's on the same rows, a TDM walk through ``ServingBeamSource``
   on the card equal to the CPU's; logs stage p50/p99, requests/s,
   freshness p95 and a ranking batch's host↔card copy time;
21. ERNIE over a dp×pp×cp×mp mesh of logical ranks on the card
   (``parallel.HybridParallelTrainer``: a thread a rank, collectives by
   axis name). Leg A: phase 7's width (vocab 32,768, hidden 1024, 16
   heads, ffn 4096, 8 layers, batch 8 × seq 512), causal, on ``{"dp": 1,
   "pp": 2, "cp": 2, "mp": 2}``, ``Adam(1e-4)``, 2 micro-batches, 2
   warm-up and 6 timed steps: loss finite and falling, the first loss
   within rtol 1e-4 of the serial ``Ernie`` on the trainer's params, every
   attention call a ring of cp hops through the flash kernels, launches a
   step equal to the formula (B5 8 ranks × 3 ticks × 4 blocks × 2 hops =
   192, B6 and B7 the 2 valid ticks: 128); tokens/s, ms/step and peak
   memory beside phase 7's step (at the end, with the other profiler
   windows, one step's host ranges, device kernels and busy share). Leg B: a small ERNIE on the same mesh, 3
   steps card (the kernels) vs CPU (their plain versions) from the same
   weights, causal and not, seeds 0–2, within ``HYB_TOL``; then B5–B7 at
   leg A's hop shape [4, 256, 8, 64], causal, at the hop of past keys
   (q_offset 256) and the fully masked hop (k_offset 256) with a
   numpy-seeded dO and dlse: within ``FA_TOL`` of their plain versions,
   twice the same bits, the masked hop's out, dQ, dK, dV exactly 0 and
   lse exactly NEG; timed at the first for the kernels line. Leg C: 8
   experts (gshard) at full width on ``{"dp": 2, "pp": 2, "cp": 1, "mp":
   2}``, ep riding dp, 2 warm-up and 4 timed steps: loss finite and
   falling, the aux loss logged, tokens/s. Leg A's first ``HYB_REPEAT``
   steps run again on a second trainer of the same seed: the losses
   bitwise equal;
22. ROADMAP item 5 (``models.ctr.DCN``/``XDeepFM``, ``io.inference``, the
   other dense optimizers, the vision zoo). Leg A: ``CtrPassTrainer`` with
   ``DCN`` (``Adagrad``) and then ``XDeepFM`` (``Lamb``) at the pass
   path's width (26 slots, 13 dense, dim 8, DNN 400³, a 2^21-row cache,
   batch 4096), one pass over 16,384 MultiSlot lines each (4 steps):
   losses finite and falling, one B1 and one merge a step, B1 bitwise on
   each family's first push; DeepFM through the same pass for the step
   comparison; then ``save_inference_model(fused=True)`` over the pass's
   keys (the pass stays active) and ``fused=False``; a child process of
   this script (``--serve-export DIR``) loads the four artifacts on the
   card and serves batch 1 and 4096 (5 % of the keys outside the pass,
   pulling zeros) within ``EXPORT_TOL`` of the trainer's own forward,
   launching no kernel; export, load and serving p50 logged. Leg B:
   ``vgg16``, ``alexnet``, ``squeezenet1_1``, ``mobilenet_v2``,
   ``shufflenet_v2_x1_0``, ``googlenet`` and ``densenet121`` at 224², 1000
   classes, batch 32, f32, through ``Trainer`` with ``Momentum``,
   ``RMSProp``, ``Adadelta``, ``Adamax`` and ``Lars``: 3 steps each,
   losses finite, ms a step and peak memory; card vs CPU from the same
   weights (64², batch 4; AlexNet and VGG 224², batch 2): the eval forward
   and one step's update within ``ZOO_FWD_TOL``/``ZOO_UPDATE_TOL``;
   ``hapi.Model.save``/``load`` on the card, the next step bitwise;
23. ROADMAP items 9 and 4's rest (``models.din``, ``models.multitask``,
   the core runtime, the axis collectives). Leg A: DIN at PaddleRec's
   ``models/rank/din/config.yaml`` widths (embedx dim 64, 63,001 items and
   801 categories, attention 80, DNN 80 -> 40; 2 target columns and 50
   behaviour columns, lengths 1-50, the rest padding) and ESMM and MMoE at
   the pass path's width (26 slots, 13 dense, dim 8, DNN 400³), each on an
   ``HbmEmbeddingCache`` pass over a 16-shard host table: ``begin_pass``,
   8 steps at batch 4096 (``make_ctr_attention_train_step``,
   ``make_multitask_train_step``, Adam), ``end_pass``: losses finite
   and falling, one B1 and one merge a step, B1 bitwise on each family's
   first push and timed there (DIN's at dim 64: the run-time-width
   instantiation), ms a step. Leg B: DIN exported ``with_real`` (its last
   two behaviour keys of every row outside the pass) and ESMM through its
   ``predict``, loaded in this process and served at batch 1 and 4096
   within ``EXPORT_TOL`` of the model's own forward, launching no kernel.
   Leg C: a DeepFM ``CtrPassTrainer`` pass on 2 batches with ``Adam(nan)``
   under ``check_nan_inf``: it raises, the pass is discarded, the host
   table's digest is the one from before, ``ctr_train_step`` counted 2;
   a ``Trainer`` dump of 3 steps × 3 fields on the card; ``CUDAPlace(0)``;
   ``reduce``/``split_axis``/``barrier`` over ``run_ranks`` on ``{"dp": 2,
   "mp": 2}``, card bitwise equal to the CPU;
24. ROADMAP item 8's first half (``parallel.PipelineTrainer`` with
   ``pipeline_1f1b``, ``distributed.meta_optimizers``, the device graph and
   DeepWalk, ``parallel.heter_{pipeline,channel}``). Leg A: ERNIE at phase
   7's width, ``attn_impl="flash"``, through ``PipelineTrainer`` on
   ``{"dp": 1, "pp": 4}`` with 4 micro-batches: ``f_then_b`` and ``1f1b``
   (2 blocks a stage; 1f1b's optimizer is ``fleet.distributed_optimizer``'s
   GradientMerge chain, k 2, over Adam) and ``interleave`` (2 chunks of 1
   block a rank), 1 warm-up and 3 timed steps each: flash launches equal
   to each schedule's formula, the chain's held step leaving every
   parameter as it was, the three first losses within
   ``PIPE_FIRST_LOSS_TOL``, losses falling; one SGD step of f_then_b and of
   1f1b at 8 micro-batches: 1f1b's peak memory below f_then_b's; a small
   pipeline (HYB_SMALL's widths, 4 layers, ``{"dp": 1, "pp": 2}``) card vs
   CPU for each schedule and the chain within ``HYB_TOL``; B5–B7 at a
   micro-batch's shape [2, 512, 16, 64] against their plain versions,
   twice the same bits, timed. Leg B: DeepWalk at d 128, walk 40, window
   10, 5 negatives, 1024 walks a step over a 262,144-node planted-community
   graph (``DeviceGraph.from_arrays``), one pass of 524,288 tagged keys, 8
   steps: B1 and the merge once a step, B1 bitwise on the first push at dim
   128, the loss falling, every step of the first batch's walks an edge or
   a frozen dead end; two 10-cliques (``from_graph_table``) to a link AUC
   above 0.8; a ``DistGraphClient`` over 3 servers answering the 2-hop
   loop in the local table's shapes. Leg C: 16 micro-batches (26 slots,
   dim 8, batch 4096) from the child over ``ChannelClient`` through
   ``HeterPipelineTrainer([host pull, a 400³ tower's step on the card,
   host push])``: in order, the child's exit 0, the card's spans
   overlapping the host sections', the table, the tower and the losses
   bitwise equal to a serial replay of the run's order of table
   operations;
25. ROADMAP item 8's second half (``distributed.auto_parallel``,
   ``completion``, ``fleet_executor``, ``elastic`` and
   ``launch.elastic_launch_local``). Leg A: ERNIE at phase 7's width
   traced on meta tensors (no launch), the two-hint Megatron layout
   completed for every block, ``choose_strategy`` over 4 devices under
   the parameter bytes × 4 / 2 × 1.01, the chosen plan run through
   ``hybrid_trainer_from_plan`` (batch 8 × 512, 4 micro-batches; first
   loss within ``PIPE_FIRST_LOSS_TOL`` of the serial model on the
   trainer's weights, flash launches equal to the hybrid formula, 1 warm
   and 2 timed steps), then ``Engine(plan="auto")`` fitting 3 batches
   bitwise equal to a ``Trainer`` on the same weights and batches,
   evaluate, predict, save, load, ``completion()``, flash launches as
   ERNIE's formula. Leg B: 16 micro-batches of phase 24 leg C's shape
   made and packed in a child (``--fleet-source``), over an HMAC-signed
   ``RemoteMessageBus`` into the pass path's DeepFM step and a sink here,
   credits 2: one B1 a step, no edge beyond its credits, losses, dense
   params and cache rows bitwise equal to the same 16 steps run serially.
   Leg C: ``elastic_launch_local`` over 2 trainers (``--elastic-trainer``),
   rank 1 crashing once: rc 0, one restart, 4 items done exactly once at
   the rewritten world size, each loss bitwise equal to the same step
   here;
27. the mesh over processes (``core.mesh.make_process_mesh`` over
   ``torch.distributed``; this script's ``--mp-rank`` children started by
   ``launch_local`` after the kernels are built, rendezvous through a
   ``file://`` store). Leg C: NCCL at world size 1 in a child of its own,
   every axis-form mapping equal to its definition, one fused step of a
   small ERNIE against the GSPMD step; a two-card NCCL run of leg B's fp32
   rung only where a second card exists (NCCL refuses two ranks of one
   communicator on one card, so legs A and B run gloo, every CUDA tensor
   staged through pinned host memory). Leg A over 4 processes, each
   holding its row block: ``make_sharded_hot_train_step`` from phase 4's
   sharded tier (16 steps over its 8 batches) and
   ``make_sharded_ctr_train_step_from_keys`` at the pass path's shape
   (2^21 rows, 8 steps) against the same steps over the thread mesh here:
   overflow 0, the first step's rows bitwise, losses and dense params
   within ``MP_LOSS_TOL``, one B3 + one B4 and one B1 a step a process,
   each process's first B3/B4/B1 bitwise against the plain versions. Leg
   B: ERNIE at phase 7's width over 4 processes, fused fp32, int8 with
   error feedback and ZeRO-2 on the stage-2 path, 2 + 2 Adam steps each,
   against the thread mesh (first losses within ``MP_LOSS_TOL``, updates
   within ``HYB_TOL``, 8 launches of B5-B7 a step a process, the stage-2
   rung's save equal array for array within ``HYB_TOL``);
28. the ``kernels`` JSON line (B1 ten times: ``ctr_sparse_rows`` on the
   pass path, ``ctr_sparse_rows@widedeep`` on phase 12's,
   ``ctr_sparse_rows@gpubox_rpc`` on phase 14's leg B,
   ``ctr_sparse_rows@recsys`` on phase 20's leg A,
   ``ctr_sparse_rows@dcn`` and ``@xdeepfm`` on phase 22's leg A,
   ``ctr_sparse_rows@din``, ``@esmm`` and ``@mmoe`` on phase 23's leg A,
   ``ctr_sparse_rows@deepwalk`` on phase 24's leg B; B2 and B4 five
   times: ``hot_probe_gather``/``hot_scatter_apply`` on the hot path,
   ``...@rpc`` on phase 13's, ``...@ha`` on phase 16's tier arm,
   ``...@reshard`` on phase 17's leg B, ``...@tenancy`` on phase 18's leg
   A; B5–B7 three times: on the ERNIE path, ``...@ring`` on phase 21's leg
   A and ``...@pipeline`` on phase 24's leg A; the ``@mp`` entries of
   phase 27: B3, B4, B1 and B5-B7 with launches summed over its
   processes), then the card line, then the result line.

``--profile DIR`` also runs two more pass-path slabs, two more warm
batches of each hot path and two more ERNIE steps under torch.profiler (after the
launch counts are read) and prints where each step's time goes; chrome
traces go to DIR.
"""

import concurrent.futures
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12          # H100 SXM non-tensor f32, NVIDIA data sheet
RULE_PAIRS = [("naive", "naive"), ("adagrad", "adagrad"),
              ("std_adagrad", "std_adagrad"), ("adam", "adam"),
              ("adagrad", "adam"), ("naive", "std_adagrad")]
HYPER = dict(lr=0.05, initial_g2sum=3.0, weight_bounds=(-10.0, 10.0), beta1=0.9,
             beta2=0.999, eps=1e-8, nonclk_coeff=0.1, click_coeff=1.0,
             embedx_threshold=1.5)
BATCH, SLOTS, DENSE, DIM, SLAB = 4096, 26, 13, 8, 8
PASS_KEYS, CAPACITY, N_SLABS = 1 << 20, 1 << 21, 6  # 1 warm-up slab


def log(msg):
    print(msg, flush=True)


def card_line():
    """`name, power.limit` as nvidia-smi prints them (or a note why not)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    out = subprocess.run([smi, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def build_all():
    """Build the host library, the SSD tier's library (g++ with zlib) and
    the three kernel libraries, in parallel (one compiler process each);
    seconds each."""
    from paddle_tpu_torch.ops.flash_attention import load_flash_kernels
    from paddle_tpu_torch.ops.hot_kernels import load_hot_kernels
    from paddle_tpu_torch.ops.sparse_optimizer import load_kernel
    from paddle_tpu_torch.ps.native import load_native, load_ssd

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    loaders = (load_native, load_ssd, load_kernel, load_hot_kernels, load_flash_kernels)
    with concurrent.futures.ThreadPoolExecutor(len(loaders)) as ex:
        futs = [ex.submit(timed, f) for f in loaders]
        return [f.result() for f in futs]


def _wrappers():
    """Every kernel wrapper that counts its launches, by name."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import hot_kernels as hk
    from paddle_tpu_torch.ops.sparse_optimizer import ctr_sparse_rows

    return {"ctr_sparse_rows": ctr_sparse_rows,
            "merge_sparse_grads": hk.merge_sparse_grads,
            "hot_probe": hk.hot_probe,
            "hot_probe_gather": hk.hot_probe_gather,
            "hot_scatter_apply": hk.hot_scatter_apply,
            "sort_rows": hk._sort_rows,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}


def reset_launches():
    """Every kernel wrapper's launch count to 0."""
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in _wrappers().items()}


# -- phase 2: the kernel against its plain version ---------------------------

def rows_inputs(rng, n, dim, embed_rule, embedx_rule, dev):
    from paddle_tpu_torch.ops.sparse_optimizer import rule_state_dim

    es, xs = rule_state_dim(embed_rule, 1), rule_state_dim(embedx_rule, dim)
    f = np.float32
    st = [rng.uniform(0, 4, n).astype(f), rng.uniform(0, 1, n).astype(f),
          rng.normal(size=(n, 1)).astype(f), rng.uniform(0, 1, (n, es)).astype(f),
          rng.normal(size=(n, dim)).astype(f), rng.uniform(0, 1, (n, xs)).astype(f),
          (rng.random(n) < 0.5).astype(f)]
    if embed_rule == "adam":
        st[3][:, -2:] = 0.9
    if embedx_rule == "adam":
        st[5][:, -2:] = rng.uniform(0.5, 0.99, (n, 2)).astype(f)
    deltas = [rng.integers(0, 3, n).astype(f), (rng.random(n) < 0.4).astype(f),
              rng.normal(size=(n, 1)).astype(f), rng.normal(size=(n, dim)).astype(f)]
    to = lambda a: torch.from_numpy(a).to(dev)
    return tuple(to(a) for a in st), [to(a) for a in deltas]


def plain(cols, deltas, embed_rule, embedx_rule, create_applies_grad):
    from paddle_tpu_torch.ops.sparse_optimizer import fused_row_update

    h = HYPER
    return fused_row_update(
        *cols, *deltas, embed_rule=embed_rule, embedx_rule=embedx_rule,
        dim=cols[4].shape[1], lr=h["lr"], initial_g2sum=h["initial_g2sum"],
        wmin=h["weight_bounds"][0], wmax=h["weight_bounds"][1], beta1=h["beta1"],
        beta2=h["beta2"], eps=h["eps"], nonclk_coeff=h["nonclk_coeff"],
        click_coeff=h["click_coeff"], embedx_threshold=h["embedx_threshold"],
        create_applies_grad=create_applies_grad)


def ulp_diff(a, b):
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max()) if a.numel() else 0


def time_cuda(fn, reps=25):
    """(device ms, call ms): medians over ``reps`` calls of ``fn``, each
    after a write of 256 MB that evicts the 50 MB L2 (the main path's
    rows arrive cold).

    Device ms: a ~10 ms spin kernel runs before the start event, so the
    host has enqueued all of ``fn``'s launches before the card reaches
    them and the events bracket device work only. Call ms: the same
    events with the card idle at the call, so the host's time to issue
    the launches shows too (the cost a step pays when the host is the
    bottleneck)."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def one(hide_host):
        flush.fill_(1.0)
        if hide_host:
            torch.cuda._sleep(20_000_000)  # cycles: ~10 ms at 1.98 GHz
        else:
            torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    dev = [one(True) for _ in range(reps + 3)][3:]
    call = [one(False) for _ in range(reps + 3)][3:]
    return float(np.median(dev)), float(np.median(call))


def host_issue_ms(fn, calls=32, reps=5):
    """Host ms to issue one call of ``fn`` while the card is busy (a ~40
    ms spin runs ahead of the calls, so no launch waits for the card):
    what a call costs a step whose host sets the pace. Median of ``reps``
    rounds of ``calls`` calls."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(80_000_000)  # cycles: ~40 ms at 1.98 GHz
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e3)
        torch.cuda.synchronize()
    return float(np.median(out))


def kernel_bytes(n, dim, es, xs):
    """Bytes the function must move: each input read once (7 state
    columns + 4 delta columns), each output written once (7 columns)."""
    row_in = (1 + 1 + 1 + es + dim + xs + 1) + (1 + 1 + 1 + dim)
    row_out = 1 + 1 + 1 + es + dim + xs + 1
    return 4 * n * (row_in + row_out)


def kernel_ops(n, dim, embed_rule, embedx_rule):
    """f32 operations of the formulas per row (m32 counts 3: the product
    and its `t + 0*t` seal), for the rules this run uses."""
    per_rule = {"naive": lambda d: 6 * d,
                "adagrad": lambda d: 5 + 14 * d,
                "std_adagrad": lambda d: 13 * d,
                "adam": lambda d: 6 + 24 * d}
    return n * (14 + per_rule[embed_rule](1) + per_rule[embedx_rule](dim))


def at_inputs(rng, C, n, dim, embed_rule, embedx_rule, dev, uniq_dtype=torch.int64):
    """The in-place form's inputs, harder than the merge's: a cache of C
    rows (``rows_inputs``) and n entries, distinct rows in random order
    with the merge's padding (C) on n // 10 of them and 3 negative rows,
    every entry with nonzero deltas (a sentinel that were applied would
    show). (state, uniq, show_sum, click_sum, g [n, 1+dim])."""
    n_pad, n_neg = n // 10, 3
    live = rng.choice(C, n - n_pad - n_neg, replace=False)
    uniq = np.concatenate([live, np.full(n_pad, C), -rng.integers(1, 9, n_neg)])
    rng.shuffle(uniq)
    state, _ = rows_inputs(rng, C, dim, embed_rule, embedx_rule, dev)
    _, (ds, dc, ge, gx) = rows_inputs(rng, n, dim, embed_rule, embedx_rule, dev)
    return (state, torch.from_numpy(uniq).to(uniq_dtype).to(dev), ds + 1.0, dc,
            torch.cat([ge, gx], 1))


def pass_push(rng, dev):
    """One pass-path step's push (phase 3's shapes): for each of the 26
    slots 4096 ids drawn from the slot's 40,330, each id on its own row of
    the 2^21-row cache; shows 1, clicks ~30 %. (rows int64, grads, shows,
    clicks)."""
    per_slot = PASS_KEYS // SLOTS + 1
    ids = rng.integers(0, per_slot, (BATCH, SLOTS)) + np.arange(SLOTS) * per_slot
    n = BATCH * SLOTS
    f = np.float32
    arrays = (ids.reshape(-1).astype(np.int64), rng.normal(size=(n, 1 + DIM)).astype(f),
              np.ones(n, f), (rng.random(n) < 0.3).astype(f))
    return [torch.from_numpy(a).to(dev) for a in arrays]


def at_bytes(n, u, dim, es, xs, uniq_bytes):
    """Bytes the in-place form must move: the n entries' row ids read once,
    the deltas (show, click, 1 + dim grads) of the u entries that hold a
    row read once (a sentinel's are never needed), the u touched rows'
    seven columns read once and written once."""
    row = 1 + 1 + 1 + es + dim + xs + 1
    return n * uniq_bytes + u * 4 * (3 + dim) + u * row * 4 * 2


def at_sectors(n, u, dim, es, xs, uniq_bytes):
    """The layout's floor in bytes: the entries' streams as above, but
    each touched row's columns as the 32-byte sectors they occupy (a
    column array each), read and written."""
    sectors = sum(-(-w * 4 // 32) for w in (1, 1, 1, es, dim, xs, 1) if w)
    return n * uniq_bytes + u * 4 * (3 + dim) + u * sectors * 32 * 2


def bitwise_cols(got, want):
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want) if g.numel())


def phase_kernel(dev):
    """B1 in both forms. Rows in, rows out (``ctr_sparse_rows``: the
    kernel on copies of the rows) bitwise against ``fused_row_update``
    over the rule matrix × ``create_applies_grad`` at n = 106,496 + 37 (a
    short last tile); in place by index (``ctr_sparse_rows_at``) bitwise
    against its plain version (gather, rule, scatter) over the same
    matrix, n = 106,496 + 37 entries into a 2^19-row cache with padding
    and negative rows, int64 and int32 rows. Then at the main path's
    configuration (adagrad/adagrad, dim 8): the out-of-place form at n =
    106,496 (the call, and the kernel alone on rows 0 .. n-1), and the
    in-place form on a pass-path step's merged push into the 2^21-row
    cache, checked bitwise on those inputs before it is timed. Returns
    the kernels-line numbers of the in-place form (the main path's
    launch) and the out-of-place numbers."""
    from paddle_tpu_torch.ops import hot_kernels as hk
    from paddle_tpu_torch.ops import sparse_optimizer as so

    n = BATCH * SLOTS
    rng = np.random.default_rng(0)
    worst = 0.0
    for i, (embed_rule, embedx_rule) in enumerate(RULE_PAIRS):
        for cag in (True, False):
            kw = dict(embed_rule=embed_rule, embedx_rule=embedx_rule, create_applies_grad=cag,
                      **HYPER)
            cols, deltas = rows_inputs(rng, n + 37, DIM, embed_rule, embedx_rule, dev)
            got = so.ctr_sparse_rows(cols, *deltas, **kw)
            torch.cuda.synchronize()
            want = plain(cols, deltas, embed_rule, embedx_rule, cag)
            created = int(((want[6] > 0) & (cols[6] == 0)).sum())
            diffs = [(float((g - w).abs().nan_to_num(0.0).max()) if g.numel() else 0.0,
                      ulp_diff(g, w)) for g, w in zip(got, want)]
            ok = bitwise_cols(got, want)
            mabs = max(d[0] for d in diffs)
            worst = max(worst, mabs)
            log(f"kernel ctr_sparse_rows {embed_rule}/{embedx_rule} "
                f"create_applies_grad={cag}: n={n + 37} created={created} "
                f"bitwise={ok} max_abs={mabs} max_ulp={max(d[1] for d in diffs)} "
                f"(stated bound: bitwise, 0 ulp)")
            if not ok:
                raise AssertionError(f"kernel disagrees with plain for "
                                     f"{embed_rule}/{embedx_rule} cag={cag}")

            uniq_dtype = (torch.int64, torch.int32)[(2 * i + cag) % 2]
            state, uniq, ds, dc, g = at_inputs(rng, HOT_CAP, n + 37, DIM, embed_rule,
                                               embedx_rule, dev, uniq_dtype)
            got = tuple(c.clone() for c in state)
            so.ctr_sparse_rows_at(got, uniq, ds, dc, g, capacity=HOT_CAP, **kw)
            torch.cuda.synchronize()
            want = so.ctr_sparse_rows_at_plain(tuple(c.clone() for c in state), uniq, ds, dc, g,
                                               capacity=HOT_CAP, **kw)
            ok = bitwise_cols(got, want)
            mabs = max(max_abs(a, b) for a, b in zip(got, want))
            worst = max(worst, mabs)
            live = int(((uniq >= 0) & (uniq < HOT_CAP)).sum())
            created = int(((want[6] > 0) & (state[6] == 0)).sum())
            log(f"kernel ctr_sparse_rows_at {embed_rule}/{embedx_rule} "
                f"create_applies_grad={cag}: n={n + 37} {uniq.dtype} entries ({live} live, "
                f"{n + 37 - live} padding or negative) into {HOT_CAP} rows, created={created} "
                f"bitwise={ok} max_abs={mabs} (stated bound: bitwise, plain on the card)")
            if not ok:
                raise AssertionError(f"in-place kernel disagrees with plain for "
                                     f"{embed_rule}/{embedx_rule} cag={cag}")

    # times at the main path's configuration (adagrad/adagrad, dim 8)
    es, xs = so.rule_state_dim("adagrad", 1), so.rule_state_dim("adagrad", DIM)
    kw = dict(embed_rule="adagrad", embedx_rule="adagrad", **HYPER)
    cols, deltas = rows_inputs(np.random.default_rng(1), n, DIM, "adagrad", "adagrad", dev)
    ms, call_ms = time_cuda(lambda: so.ctr_sparse_rows(cols, *deltas, **kw))
    # the kernel alone, as the call launches it: rows 0 .. n-1 of copies
    seq = tuple(c.clone() for c in cols)
    seq_args = (torch.arange(n, dtype=torch.int32, device=dev), deltas[0], deltas[1],
                torch.cat(deltas[2:], 1))
    kernel_ms, _ = time_cuda(lambda: so.ctr_sparse_rows_at(seq, *seq_args, capacity=n, **kw))
    plain_ms, plain_call_ms = time_cuda(lambda: plain(cols, deltas, "adagrad", "adagrad", True))
    nbytes = kernel_bytes(n, DIM, es, xs)
    nops = kernel_ops(n, DIM, "adagrad", "adagrad")
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / FP32_OPS_PER_S * 1e3
    out_of_place = {"max_abs_err": worst, "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                    "call_ms": call_ms, "plain_call_ms": plain_call_ms, "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                    "bytes": nbytes, "ops": nops}

    # the in-place form on one pass-path step's merged push (2^21-row cache)
    rng = np.random.default_rng(2)
    state, _ = rows_inputs(rng, CAPACITY, DIM, "adagrad", "adagrad", dev)
    rows, grads, shows, clicks = pass_push(rng, dev)
    uniq, ds, dc, g = hk.merge_sparse_grads(rows, grads, shows, clicks, CAPACITY)
    u = int((uniq < CAPACITY).sum())
    got = tuple(c.clone() for c in state)
    so.ctr_sparse_rows_at(got, uniq, ds, dc, g, capacity=CAPACITY, **kw)
    torch.cuda.synchronize()
    want = so.ctr_sparse_rows_at_plain(tuple(c.clone() for c in state), uniq, ds, dc, g,
                                       capacity=CAPACITY, **kw)
    push_ok = bitwise_cols(got, want)
    push_abs = max(max_abs(a, b) for a, b in zip(got, want))
    worst = max(worst, push_abs)
    del got, want
    if not push_ok:
        raise AssertionError(f"in-place kernel disagrees with plain on the pass-path push "
                             f"(max_abs {push_abs})")
    at = lambda: so.ctr_sparse_rows_at(state, uniq, ds, dc, g, capacity=CAPACITY, **kw)
    at_ms, at_call_ms = time_cuda(at)
    at_plain_ms, at_plain_call_ms = time_cuda(lambda: so.ctr_sparse_rows_at_plain(
        state, uniq, ds, dc, g, capacity=CAPACITY, **kw))
    host_at = host_issue_ms(at)
    ub = uniq.element_size()
    at_nbytes = at_bytes(n, u, DIM, es, xs, ub)
    sector_bytes = at_sectors(n, u, DIM, es, xs, ub)
    at_ops = kernel_ops(u, DIM, "adagrad", "adagrad")
    at_bytes_ms = at_nbytes / HBM_BYTES_PER_S * 1e3
    at_ops_ms = at_ops / FP32_OPS_PER_S * 1e3
    sector_ms = sector_bytes / HBM_BYTES_PER_S * 1e3
    log(f"kernel ctr_sparse_rows_at adagrad/adagrad, pass-path push: n={n} entries, u={u} "
        f"touched rows of {CAPACITY}, {uniq.dtype}: bitwise={push_ok} max_abs={push_abs}; "
        f"device {at_ms} ms; plain {at_plain_ms} ms; bound {max(at_bytes_ms, at_ops_ms)} ms "
        f"({at_nbytes} B, {at_ops} f32 ops), the layout's sector floor {sector_ms} ms "
        f"({sector_bytes} B: 7 columns a row as 32-byte sectors, read and written); per call "
        f"from an idle card {at_call_ms} ms, plain {at_plain_call_ms} ms; host issue per call "
        f"with the card busy: {host_at} ms")
    # the pass push launches the merge's kernels and B1, nothing else: no
    # gather, copy or scatter between the merge and the end of the push
    from paddle_tpu_torch.ps.embedding_cache import cache_push_sparse

    pstate = dict(zip(COLUMNS, state))
    pcfg = hot_cfg("adagrad", "adagrad", True)
    kp = graph_kernels(lambda: cache_push_sparse(pstate, rows, grads, shows, clicks, pcfg))
    km = graph_kernels(lambda: hk.merge_sparse_grads(rows, grads, shows, clicks, CAPACITY))
    ka = graph_kernels(at)
    log(f"pass push (cache_push_sparse), pass-path batch: (kernels, memsets, copies) per "
        f"call {kp}; its merge alone {km}; ctr_sparse_rows_at alone {ka} (CUDA graph nodes)")
    if kp != (km[0] + 1, km[1], km[2]) or ka != (1, 0, 0):
        raise AssertionError(f"the pass push launches more than the merge and B1: {kp}")
    in_place = {"max_abs_err": worst, "ms": at_ms, "plain_ms": at_plain_ms,
                "bound_ms": max(at_bytes_ms, at_ops_ms),
                "bound_by": "bytes" if at_bytes_ms >= at_ops_ms else "operations",
                "sector_ms": sector_ms}
    return in_place, out_of_place


# -- phase 2b: the hot-tier kernels against their plain versions ------------

HOT_CAP = 1 << 19       # tier rows of the hot path
SHARDS = 4              # mesh shards of the sharded hot path (banks = shards)
SHARD_N = BATCH * SLOTS // SHARDS  # keys one shard probes per step
COLUMNS = ("show", "click", "embed_w", "embed_state", "embedx_w", "embedx_state",
           "has_embedx")


def banked_map(C, banks, keys, dev):
    """A dynamic map holding ``keys`` with the tier's placement contract
    (a key's row lies in its bank's contiguous row block)."""
    from paddle_tpu_torch.ps.device_hash import DynamicDeviceKeyMap

    m = DynamicDeviceKeyMap(C, device=dev, banks=banks)
    bk = m.bank_of(keys).astype(np.int64)
    counts = np.bincount(bk, minlength=banks)
    order = np.argsort(bk, kind="stable")
    rank = np.empty(len(keys), np.int64)
    rank[order] = np.arange(len(keys)) - np.repeat(np.cumsum(counts) - counts, counts)
    rows = (bk * (C // banks) + rank).astype(np.int32)
    m.insert(keys, rows)
    return m, rows


def tier_columns(rng, embed_rule, embedx_rule, dev):
    cols, _ = rows_inputs(rng, HOT_CAP, DIM, embed_rule, embedx_rule, dev)
    return dict(zip(COLUMNS, cols))


def bitwise_equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def max_abs(a, b):
    return float((a.float() - b.float()).abs().nan_to_num(0.0).max()) if a.numel() else 0.0


def probe_batch(dev):
    """Phase 2's probe inputs: 100,000 resident keys; one batch's 106,496
    probe keys (~80 % resident with repeats, ~20 % absent), on the card as
    int32 hi/lo bit patterns; a 2^19-row tier. (resident, probe, hi, lo,
    tier)."""
    from paddle_tpu_torch.ps.device_hash import split_keys

    n = BATCH * SLOTS
    rng = np.random.default_rng(10)
    n_res = min(100_000, HOT_CAP // 5)
    resident = np.unique(rng.integers(1, 2**63, n_res + n_res // 5, dtype=np.uint64))[:n_res]
    absent = rng.integers(1, 2**63, n // 5, dtype=np.uint64)
    probe = np.concatenate([resident[rng.integers(0, len(resident), n - len(absent))],
                            absent])
    rng.shuffle(probe)
    hi, lo = split_keys(probe)
    th = torch.from_numpy(hi.view(np.int32)).to(dev)
    tl = torch.from_numpy(lo.view(np.int32)).to(dev)
    return resident, probe, th, tl, tier_columns(rng, "adagrad", "adagrad", dev)


def probe_gather_bytes(ms, th, tl, found, banks):
    """(bytes B2 must move on these keys, buckets probed): the key; each
    probed bucket's hi/lo/row sector (32 B each; a resident key usually
    stops at its first bucket); the matched row (embed_w 4 B + embedx_w
    32 B); the outputs."""
    from paddle_tpu_torch.ps.device_hash import dynamic_map_lookup

    n = int(th.numel())
    first = dynamic_map_lookup(ms, th, tl, 1, banks) >= 0
    buckets = n + int((~first).sum())
    return n * 8 + buckets * 3 * 32 + found * 4 * (1 + DIM) + n * 4 * (2 + DIM), buckets


def phase_hot_probe(dev):
    """``hot_probe_gather`` (B2) and ``hot_probe`` (B3) at the hot paths'
    shapes: 106,496 probes (one batch's keys: ~80 % resident with
    repeats, ~20 % absent) into a 2^19-row tier holding 100,000 keys,
    banks 1, 4 and 8; B3 also on the first 26,624 (one shard's slice of
    the batch at K = 4). Bitwise against the plain versions on the card
    and the host mirror. Returns (B2 at banks 1, the single-card
    trainer's layout; B3 at banks 4 and n = 26,624, the sharded
    trainer's) for the kernels line."""
    from paddle_tpu_torch.ops.hot_kernels import (hot_probe, hot_probe_gather,
                                                  hot_probe_gather_plain)
    from paddle_tpu_torch.ps.device_hash import dynamic_map_lookup

    n = BATCH * SLOTS
    resident, probe, th, tl, tier = probe_batch(dev)
    out, b3 = {}, None
    for banks in (1, 4, 8):
        t0 = time.perf_counter()
        m, _ = banked_map(HOT_CAP, banks, resident, dev)
        ms = m.device_state()
        build_s = time.perf_counter() - t0
        kw = dict(probe_buckets=m.probe_buckets, banks=banks)
        got = hot_probe_gather(ms, th, tl, tier, **kw)
        torch.cuda.synchronize()
        rows_b2 = got[0]
        want = hot_probe_gather_plain(ms, th, tl, tier, **kw)
        bitwise = all(bitwise_equal(g, w) for g, w in zip(got, want))
        host_ok = np.array_equal(got[0].cpu().numpy(), m.lookup_host(probe))
        found = int((got[0] >= 0).sum())
        err = max_abs(got[1], want[1])
        log(f"kernel hot_probe_gather banks={banks}: n={n} found={found} "
            f"absent={n - found} bitwise={bitwise} host_mirror_equal={host_ok} "
            f"max_abs={err} (stated bound: bitwise) map build {build_s:.2f} s (host)")
        if not (bitwise and host_ok):
            raise AssertionError(f"hot_probe_gather disagrees (banks={banks})")
        first = dynamic_map_lookup(ms, th, tl, 1, banks) >= 0
        nbytes, buckets = probe_gather_bytes(ms, th, tl, found, banks)
        ms_k, call_k = time_cuda(lambda: hot_probe_gather(ms, th, tl, tier, **kw))
        ms_p, call_p = time_cuda(lambda: hot_probe_gather_plain(ms, th, tl, tier, **kw))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"kernel hot_probe_gather banks={banks}: device {ms_k} ms, plain {ms_p} ms, "
            f"bound {bound} ms (bytes: {nbytes} B, {buckets} buckets probed); per call "
            f"from an idle card {call_k} ms, plain {call_p} ms")
        out[banks] = {"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound,
                      "bound_by": "bytes", "bytes": nbytes}

        # B3, the probe alone, on the whole batch and on one shard's slice
        for n3 in (n, SHARD_N):
            h3, l3 = th[:n3], tl[:n3]
            got = hot_probe(ms, h3, l3, **kw)
            torch.cuda.synchronize()
            want = dynamic_map_lookup(ms, h3, l3, m.probe_buckets, banks)
            ok = bitwise_equal(got, want) and bitwise_equal(got, rows_b2[:n3]) and \
                np.array_equal(got.cpu().numpy(), m.lookup_host(probe[:n3]))
            found3 = int((got >= 0).sum())
            # the key, each probed bucket's hi/lo/row sector, the row out
            buckets3 = n3 + int((~first[:n3]).sum())
            nbytes3 = n3 * 8 + buckets3 * 3 * 32 + n3 * 4
            ms_k, call_k = time_cuda(lambda: hot_probe(ms, h3, l3, **kw))
            ms_p, call_p = time_cuda(lambda: dynamic_map_lookup(ms, h3, l3, m.probe_buckets,
                                                                banks))
            bound = nbytes3 / HBM_BYTES_PER_S * 1e3
            log(f"kernel hot_probe banks={banks}: n={n3} found={found3} absent={n3 - found3} "
                f"bitwise vs plain, host mirror and hot_probe_gather={ok} (stated bound: "
                f"bitwise); device {ms_k} ms, plain {ms_p} ms, bound {bound} ms (bytes: "
                f"{nbytes3} B, {buckets3} buckets probed); per call from an idle card {call_k} "
                f"ms, plain {call_p} ms")
            if not ok:
                raise AssertionError(f"hot_probe disagrees (banks={banks}, n={n3})")
            if banks == SHARDS and n3 == SHARD_N:
                b3 = {"max_abs_err": 0.0, "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound,
                      "bound_by": "bytes", "bytes": nbytes3}
    return out[1], b3


def hot_push_inputs(rng, n, C, dev):
    """One batch's push as the hot step sees it: most rows spread over
    the tier, 10 % on 32 heavy rows and 2 % on one (a slot with few
    ids), plus sentinel rows C and negative rows (both dropped)."""
    rows = rng.integers(0, C, n)
    u = rng.random(n)
    rows[u < 0.10] = rng.integers(0, 32, int((u < 0.10).sum()))
    rows[u < 0.02] = 7
    rows[(u > 0.99) & (u <= 0.995)] = C
    neg = u > 0.995
    rows[neg] = -1 - rng.integers(0, 4, int(neg.sum()))
    f = np.float32
    arrays = (rows.astype(np.int32), rng.normal(size=(n, 1 + DIM)).astype(f),
              rng.integers(1, 3, n).astype(f), (rng.random(n) < 0.3).astype(f))
    return [torch.from_numpy(a).to(dev) for a in arrays]


def hot_cfg(embed_rule, embedx_rule, cag):
    from paddle_tpu_torch.ps.embedding_cache import CacheConfig
    from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig

    h = HYPER
    sgd = SGDRuleConfig(learning_rate=h["lr"], initial_g2sum=h["initial_g2sum"],
                        weight_bounds=h["weight_bounds"], beta1=h["beta1"],
                        beta2=h["beta2"], ada_epsilon=h["eps"])
    return CacheConfig(capacity=HOT_CAP, embedx_dim=DIM, sgd=sgd, embed_rule=embed_rule,
                       embedx_rule=embedx_rule, nonclk_coeff=h["nonclk_coeff"],
                       click_coeff=h["click_coeff"], embedx_threshold=h["embedx_threshold"],
                       create_applies_grad=cag)


def phase_hot_scatter(dev):
    """``hot_scatter_apply`` at the hot path's shape (n = 106,496 pushes
    into a 2^19-row tier) over the rule matrix × ``create_applies_grad``,
    bitwise against its plain version run on the CPU copy of the same
    inputs (the plain merge on the card would sum with atomics); then the
    pass cache's merge, card against CPU, bitwise; then the radix sort
    against ``torch.sort`` at three shapes; then times on the hot path's
    own batch (returned for the kernels line: B4 and its sort), on one
    shard's owner push and on the heavy-hitter batch."""
    from paddle_tpu_torch.ops import hot_kernels as hk

    n = BATCH * SLOTS
    rng = np.random.default_rng(11)
    args = hot_push_inputs(rng, n, HOT_CAP, dev)
    cpu_args = [a.cpu() for a in args]
    seg, counts = torch.unique_consecutive(torch.sort(args[0].to(torch.int64))[0],
                                           return_counts=True)
    valid = (seg >= 0) & (seg < HOT_CAP)
    u, longest = int(valid.sum()), int(counts[valid].max())
    max_err = 0.0
    for embed_rule, embedx_rule in RULE_PAIRS:
        for cag in (True, False):
            cfg = hot_cfg(embed_rule, embedx_rule, cag)
            tier = tier_columns(rng, embed_rule, embedx_rule, dev)
            want = hk.hot_scatter_apply({k: v.cpu() for k, v in tier.items()}, *cpu_args, cfg)
            got = hk.hot_scatter_apply(tier, *args, cfg)
            torch.cuda.synchronize()
            bitwise = all(bitwise_equal(got[k].cpu(), want[k]) for k in COLUMNS)
            err = max(max_abs(got[k].cpu(), want[k]) for k in COLUMNS)
            max_err = max(max_err, err)
            log(f"kernel hot_scatter_apply {embed_rule}/{embedx_rule} "
                f"create_applies_grad={cag}: n={n} u={u} longest_segment={longest} "
                f"bitwise={bitwise} max_abs={err} (stated bound: bitwise, plain on the CPU)")
            if not bitwise:
                raise AssertionError(f"hot_scatter_apply disagrees for "
                                     f"{embed_rule}/{embedx_rule} cag={cag}")

    # the pass cache's merge: card (sort + merge kernel) vs CPU (unique +
    # index_add_), bitwise, and reproducible on the card
    rows64 = args[0].to(torch.int64)
    merged = hk.merge_sparse_grads(rows64, *args[1:], HOT_CAP)
    again = hk.merge_sparse_grads(rows64, *args[1:], HOT_CAP)
    torch.cuda.synchronize()
    want = hk.merge_sparse_grads(rows64.cpu(), *cpu_args[1:], HOT_CAP)
    same = all(bitwise_equal(g.cpu(), w) for g, w in zip(merged, want))
    repro = all(bitwise_equal(g, h) for g, h in zip(merged, again))
    log(f"merge_sparse_grads: n={n} segments={int(seg.numel())} card == CPU bitwise: "
        f"{same}; card run twice bitwise: {repro}")
    if not (same and repro):
        raise AssertionError("merge_sparse_grads on the card differs from the CPU")

    # the radix sort against torch.sort, and the times, on the hot path's
    # own batch (26 slots x 4096 draws from 10,000 ids per slot: short
    # segments), one shard's owner push and the heavy-hitter batch above
    hot = hot_path_push(rng, dev)
    owner = owner_push_rows(rng, dev)
    sort_err = {what: check_sort(rows, bound, what)
                for what, rows, bound in (("hot-path batch", hot[0], HOT_CAP),
                                          ("owner push", owner, SHARD_CAP),
                                          ("heavy-hitter batch", args[0], HOT_CAP))}
    out = time_scatter(hot, "hot-path batch")
    sort_line = time_sort(hot[0], HOT_CAP, "hot-path batch")
    sort_line["max_abs_err"] = sort_err["hot-path batch"]
    time_sort(owner, SHARD_CAP, "owner push")
    time_scatter(args, "heavy-hitter batch")
    time_sort(args[0], HOT_CAP, "heavy-hitter batch")
    out["max_abs_err"] = max_err
    return out, sort_line


SHARD_CAP = HOT_CAP // SHARDS   # rows of one shard of the sharded tier


def owner_push_rows(rng, dev):
    """What one owner's B4 gets on the sharded hot path at K = 4: the K
    routed buckets of cap = 13,312 slots (route_bucket_capacity(26,624,
    4, 2.0)), each holding a sending rank's deduped rows of this shard
    (~6,300 of a batch slice's ~25,300 distinct keys: sorted, shard-local)
    padded with the dropped sentinel, int64 as the routed push passes
    them."""
    cap = 2 * SHARD_N // SHARDS
    held = cap * 6300 // 13312
    rows = np.full((SHARDS, cap), SHARD_CAP, np.int64)
    for b in range(SHARDS):
        rows[b, :held] = np.sort(rng.choice(SHARD_CAP, held, replace=False))
    return torch.from_numpy(rows.reshape(-1)).to(dev)


def sort_passes(bound):
    """Digit passes of the radix sort: bounded mode below ``bound``, full
    mode for None."""
    from paddle_tpu_torch.ops import hot_kernels as hk

    return hk.load_hot_kernels().radix_sort_passes(int(bound is None), bound or 0)


def check_sort(rows, bound, what):
    """The radix sort bitwise against ``torch.sort(stable=True)``: full
    mode on the rows, bounded mode on the rows mapped to ``bound``, int32
    and int64 outputs. Returns the largest |difference| of a sorted row or
    a permutation entry over all four."""
    from paddle_tpu_torch.ops import hot_kernels as hk

    worst = 0
    for mode in ("full", "bounded"):
        b = None if mode == "full" else bound
        keys = rows if b is None else torch.where((rows >= 0) & (rows < b), rows, b)
        want_rows, want_perm = torch.sort(keys, stable=True)
        ok, err = True, 0
        for index_dtype in (torch.int32, torch.int64):
            srows, perm = hk._sort_rows(rows, b, index_dtype)
            ok &= torch.equal(srows.to(torch.int64), want_rows.to(torch.int64)) and \
                torch.equal(perm.to(torch.int64), want_perm)
            err = max(err, int((srows.to(torch.int64) - want_rows.to(torch.int64)).abs().max()),
                      int((perm.to(torch.int64) - want_perm).abs().max()))
        worst = max(worst, err)
        log(f"kernel sort_rows {mode} mode ({sort_passes(b)} passes), {what}: "
            f"n={rows.numel()} {rows.dtype} rows, equal to torch.sort(stable=True) bitwise "
            f"(sorted rows and permutation): {ok}, max_abs={err}")
        if not ok:
            raise AssertionError(f"the radix sort differs from torch.sort ({mode}, {what})")
    return float(worst)


def device_kernels(fn):
    """(device kernels, memsets) one call of ``fn`` issues, and the
    kernels' names: torch.profiler over one call after a warm-up call.
    A profiler window leaves every later launch of the process slower, so
    only :func:`phase_kernel_counts`, after the timed phases, calls it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)]
    memsets = [x for x in names if x.startswith("Memset")]
    kernels = [x for x in names if not x.startswith(("Memset", "Memcpy"))]
    short = {x.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
             .split("<")[0] for x in kernels}
    return len(kernels), len(memsets), sorted(short)


def graph_kernels(fn):
    """(kernel, memset, memcpy) nodes of one call of ``fn`` captured in a
    CUDA graph, after a warm-up call: every launch the call issues,
    counted by the driver (a profiler capture can lose device events).
    Capture only records, so the call changes nothing."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)):
            raise RuntimeError("cuGraphNodeGetType failed")
        types.append(t.value)
    del graph
    # CUgraphNodeType: 0 kernel, 1 memcpy, 2 memset
    return types.count(0), types.count(2), types.count(1)


def phase_kernel_counts(dev):
    """Device kernels per call of B4, the merge and the radix sort (beside
    ``torch.sort``), on the hot path's batch and one shard's owner push:
    phase 2's counts, taken last because they open profiler windows."""
    from paddle_tpu_torch.ops import hot_kernels as hk

    rng = np.random.default_rng(11)
    rows, grads, shows, clicks = hot_path_push(rng, dev)
    cfg = hot_cfg("adagrad", "adagrad", True)
    tier = tier_columns(np.random.default_rng(12), "adagrad", "adagrad", dev)
    k4, m4, names4 = device_kernels(lambda: hk.hot_scatter_apply(tier, rows, grads, shows,
                                                                 clicks, cfg))
    rows64 = rows.to(torch.int64)
    km, mm, namesm = device_kernels(lambda: hk.merge_sparse_grads(rows64, grads, shows,
                                                                  clicks, HOT_CAP))
    log(f"kernel hot_scatter_apply adagrad/adagrad, hot-path batch: device kernels per call "
        f"{k4} (+{m4} memsets) {names4}; merge_sparse_grads {km} (+{mm}) {namesm}")
    for what, r, bound in (("hot-path batch", rows, HOT_CAP),
                           ("owner push", owner_push_rows(rng, dev), SHARD_CAP)):
        kb, mb, names = device_kernels(lambda: hk._sort_rows(r, bound))
        kf, mf, _ = device_kernels(lambda: hk._sort_rows(r))
        kl, ml, _ = device_kernels(lambda: torch.sort(r, stable=True))
        log(f"kernel sort_rows, {what}: n={r.numel()} {r.dtype}: device kernels per call: "
            f"bounded {kb} (+{mb} memsets) {names}, full {kf} (+{mf}), torch.sort {kl} "
            f"(+{ml})")


def time_sort(rows, bound, what):
    """Device times of the radix sort (bounded, as B4 runs it, and full,
    as the merge does) beside ``torch.sort(stable=True)`` on the same rows
    and its plain version (mapping + torch.sort). Returns
    the kernels-line numbers of the bounded sort (its error from
    :func:`check_sort`)."""
    from paddle_tpu_torch.ops import hot_kernels as hk

    n = rows.numel()
    ms_b, call_b = time_cuda(lambda: hk._sort_rows(rows, bound))
    ms_f, _ = time_cuda(lambda: hk._sort_rows(rows))
    ms_lib, call_lib = time_cuda(lambda: torch.sort(rows, stable=True))
    ms_lib64, _ = time_cuda(lambda: torch.sort(rows.to(torch.int64), stable=True))
    ms_plain, _ = time_cuda(lambda: hk._sort_rows_plain(rows, bound))
    nbytes = n * (rows.element_size() + 4 + 4)  # rows in; sorted rows and positions out
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"kernel sort_rows, {what}: n={n} {rows.dtype}: bounded ({sort_passes(bound)} "
        f"passes) device {ms_b} ms, full (4 passes) {ms_f} ms; torch.sort(stable=True) on "
        f"the same rows {ms_lib} ms ({ms_lib / ms_b:.2f}x the bounded sort, "
        f"{ms_lib / ms_f:.2f}x the full one), on the rows as int64 (cast included) "
        f"{ms_lib64} ms; plain (mapping + torch.sort) {ms_plain} ms; bound {bound_ms} ms "
        f"({nbytes} B); per call from an idle card {call_b} ms, torch.sort {call_lib} ms")
    return {"ms": ms_b, "plain_ms": ms_plain, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": ms_lib}


def hot_path_push(rng, dev):
    """The push of one hot-path step: for each of the 26 slots, 4096 ids
    drawn from the slot's 10,000, each id on its own tier row."""
    ids = rng.integers(0, HOT_IDS, (BATCH, SLOTS)) + np.arange(SLOTS) * HOT_IDS
    n = BATCH * SLOTS
    f = np.float32
    arrays = (ids.reshape(-1).astype(np.int32), rng.normal(size=(n, 1 + DIM)).astype(f),
              np.ones(n, f), (rng.random(n) < 0.5).astype(f))
    return [torch.from_numpy(a).to(dev) for a in arrays]


def scatter_bound(n, u, cfg):
    """(bytes, f32 ops, bytes ms, ops ms) of B4 on n entries touching u
    rows under ``cfg``'s rules: each entry's row, perm, show, click and
    gradient and the sort's 8 B; each touched row's seven columns read and
    written."""
    from paddle_tpu_torch.ops.sparse_optimizer import rule_state_dim

    es, xs = rule_state_dim(cfg.embed_rule, 1), rule_state_dim(cfg.embedx_rule, DIM)
    row_floats = 4 + es + DIM + xs  # show, click, embed_w, has_embedx + the rest
    nbytes = n * (4 + 4 + 4 + 4 * (1 + DIM) + 8) + u * row_floats * 4 * 2
    nops = kernel_ops(u, DIM, cfg.embed_rule, cfg.embedx_rule) + n * (3 + DIM)
    return nbytes, nops, nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3


def time_scatter(args, what):
    """Device times of ``hot_scatter_apply`` (and the merge) on ``args``
    beside the byte bound of what these rows need; host issue per call."""
    from paddle_tpu_torch.ops import hot_kernels as hk

    n = args[0].shape[0]
    rows64 = args[0].to(torch.int64)
    seg, counts = torch.unique_consecutive(torch.sort(rows64)[0], return_counts=True)
    valid = (seg >= 0) & (seg < HOT_CAP)
    u, longest = int(valid.sum()), int(counts[valid].max())
    cfg = hot_cfg("adagrad", "adagrad", True)
    tier = tier_columns(np.random.default_rng(12), "adagrad", "adagrad", args[0].device)
    ms_k, call_k = time_cuda(lambda: hk.hot_scatter_apply(tier, *args, cfg))
    ms_p, call_p = time_cuda(lambda: hk.hot_scatter_apply_plain(tier, *args, cfg))
    sort_ms, _ = time_cuda(lambda: hk._sort_rows(args[0], HOT_CAP))
    merge_ms, _ = time_cuda(lambda: hk.merge_sparse_grads(rows64, *args[1:], HOT_CAP))
    merge_plain_ms, _ = time_cuda(lambda: hk.merge_sparse_grads_plain(
        rows64, *args[1:], HOT_CAP))
    host_k = host_issue_ms(lambda: hk.hot_scatter_apply(tier, *args, cfg))
    host_m = host_issue_ms(lambda: hk.merge_sparse_grads(rows64, *args[1:], HOT_CAP))
    nbytes, nops, bytes_ms, ops_ms = scatter_bound(n, u, cfg)
    log(f"kernel hot_scatter_apply adagrad/adagrad, {what}: n={n} u={u} "
        f"longest_segment={longest}: device {ms_k} ms (the radix sort inside it: "
        f"{sort_ms} ms), plain {ms_p} ms, bound {max(bytes_ms, ops_ms)} ms ({nbytes} B, "
        f"{nops} f32 ops); per call from an idle card {call_k} ms, plain {call_p} ms; "
        f"merge_sparse_grads {merge_ms} ms, plain (unique + index_add_) {merge_plain_ms} ms; "
        f"host issue per call with the card busy: "
        f"hot_scatter_apply {host_k} ms, merge_sparse_grads {host_m} ms")
    return {"ms": ms_k, "plain_ms": ms_p, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# -- phase 3: the pass path at full width -------------------------------------

def phase_main_path(dev, card, profile_dir=None):
    from paddle_tpu_torch.models.ctr import (CtrConfig, DeepFM, make_ctr_train_step_slab,
                                             make_random_packs, serving_pull)
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.embedding_cache import CacheConfig, HbmEmbeddingCache
    from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

    rng = np.random.default_rng(0)
    cfg = CtrConfig(SLOTS, DENSE, DIM, (400, 400, 400))
    table = MemorySparseTable(TableConfig(
        shard_num=16, accessor_config=AccessorConfig(embedx_dim=DIM)))
    try:
        cache = HbmEmbeddingCache(table, CacheConfig(capacity=CAPACITY, embedx_dim=DIM,
                                                     embedx_threshold=0.0),
                                  device=dev, device_map=True)
        pool = rng.integers(0, PASS_KEYS // SLOTS + 1, size=(PASS_KEYS, SLOTS)).astype(np.uint64)
        pool += np.arange(SLOTS, dtype=np.uint64) << np.uint64(32)
        t0 = time.perf_counter()
        n_uniq = cache.begin_pass(pool.reshape(-1))
        log(f"pass path: begin_pass {pool.size} keys -> {n_uniq} uniques in "
            f"{time.perf_counter() - t0:.2f} s (host)")

        n_slabs, warm = N_SLABS, 1
        slabs = [torch.from_numpy(np.stack(make_random_packs(rng, pool, BATCH, DENSE, SLAB))).to(dev)
                 for _ in range(n_slabs)]
        first_pack = slabs[0][0].cpu().numpy()
        touched = (first_pack[:BATCH * SLOTS * 4].view(np.uint32).astype(np.uint64)
                   .reshape(BATCH, SLOTS) + (np.arange(SLOTS, dtype=np.uint64) << np.uint64(32)))
        sample = np.unique(touched.reshape(-1))[:512]
        before, _ = table.export_full(sample)
        state, map_state = cache.state, cache.device_map.state

        def leg(amp):
            """The f32 (bench.py's BENCH_AMP=0) or the amp leg (its default):
            fresh dense weights, the same slabs, on the pass's cache."""
            nonlocal state
            model = DeepFM(cfg, generator=torch.Generator().manual_seed(0))
            opt = Adam(learning_rate=1e-3)
            params = {k: v.detach().to(dev) for k, v in model.named_parameters()}
            opt_state = opt.init(params)
            step = make_ctr_train_step_slab(model, opt, cache.config, np.arange(SLOTS),
                                            BATCH, DENSE, SLAB, device=dev, amp=amp)
            torch.cuda.synchronize()
            reset_launches()
            losses = []
            for i, packed in enumerate(slabs):
                if i == warm:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                params, opt_state, state, slab_losses = step(params, opt_state, state,
                                                             map_state, packed)
                losses.append(slab_losses)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = read_launches()
            steps = n_slabs * SLAB
            losses = torch.stack(losses).cpu().numpy()
            sps = BATCH * SLAB * (n_slabs - warm) / dt
            name = "amp (bf16 tower)" if amp else "f32"
            log(f"pass path {name}: {steps} steps, launches {counts}, "
                f"slab mean losses={[round(float(x), 5) for x in losses.mean(axis=1)]}")
            log(f"pass path {name}: {sps:.1f} samples/s (batch {BATCH}, slab {SLAB}, "
                f"{n_slabs - warm} timed slabs, {dt:.4f} s) on {card}")
            assert np.isfinite(losses).all(), f"{name}: non-finite loss"
            assert losses[-1].mean() < losses[0].mean(), f"{name}: loss did not fall"
            assert counts["ctr_sparse_rows"] == steps, \
                f"{name}: kernel launches {counts['ctr_sparse_rows']} != steps {steps}"
            assert counts["merge_sparse_grads"] == steps, f"{name}: merge launches {counts}"
            return model, step, params, opt_state, counts, sps

        model, step, params, opt_state, counts, sps32 = leg(False)
        _, amp_step, amp_params, amp_opt_state, _, sps_amp = leg(True)
        log(f"pass path: amp {sps_amp:.1f} vs f32 {sps32:.1f} samples/s in one process "
            f"({sps_amp / sps32:.3f}x) on {card}")
        if profile_dir is not None:
            def run():
                nonlocal params, opt_state, state
                for packed in slabs[1:3]:
                    params, opt_state, state, _ = step(params, opt_state, state,
                                                       map_state, packed)
            profile_window(run, 2 * SLAB, profile_dir, "pass")

            def run_amp():
                nonlocal amp_params, amp_opt_state, state
                for packed in slabs[1:3]:
                    amp_params, amp_opt_state, state, _ = amp_step(
                        amp_params, amp_opt_state, state, map_state, packed)
            profile_window(run_amp, 2 * SLAB, profile_dir, "pass_amp")

        # predict: serving_pull + forward -> sigmoid, one batch
        pk = slabs[-1][0]
        lo32 = pk[:BATCH * SLOTS * 4].view(torch.int32).reshape(BATCH, SLOTS)
        dense_x = pk[BATCH * SLOTS * 4:BATCH * SLOTS * 4 + BATCH * DENSE * 2] \
            .view(torch.float16).reshape(BATCH, DENSE).float()
        with torch.no_grad():
            emb = serving_pull(state, map_state, torch.arange(SLOTS, device=dev), lo32)
            pred = torch.sigmoid(torch.func.functional_call(model, params, (emb, dense_x)))
        assert pred.shape == (BATCH,) and bool(torch.isfinite(pred).all()), "bad predictions"
        log(f"pass predict: {BATCH} sigmoid outputs, finite, mean {float(pred.mean()):.5f}")

        cache.end_pass()
        after, found = table.export_full(sample)
        changed = (after != before).any(axis=1)
        assert found.all() and changed.all(), \
            f"flush-back: {int((~changed).sum())} of {len(sample)} touched rows unchanged"
        log(f"pass end_pass: {len(sample)} touched keys read back from the table, all changed "
            f"(show {before[:, 3].mean():.3f} -> {after[:, 3].mean():.3f})")
        return counts
    finally:
        table.close()


def profile_window(run, n_steps, out_dir, name):
    """``--profile DIR``: ``run()`` (``n_steps`` steps) under
    torch.profiler; print device time by kernel, host time by op and the
    card's busy share of the window, and write a chrome trace to DIR."""
    import os

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}_trace.json"))
    evs = prof.key_averages()
    # kernel events carry the device time once; an op's self device time
    # is the time of the kernels it launched (the same time again)
    # (a record_function range also has a device span: not a kernel)
    kernels = [e for e in evs if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels) / n_steps
    log(f"profile {name}: {n_steps} steps, wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% busy, "
        f"{100 - 100 * busy_ms / wall_ms:.1f}% idle), {n_kernels:g} device kernels/step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"profile {name} kernel: {e.self_device_time_total / 1e3 / n_steps:.4f} "
            f"ms/step x{e.count / n_steps:g}/step {e.key[:80]}")
    # the port's own kernels, wherever they rank (the flash kernels are
    # "<fwd|bwd_dq|bwd_dkv>_mma_kernel<T, NT>"; hot_kernels.cu's probes,
    # radix sort and segment walk; B1's "ctr_rows_at_kernel")
    for e in kernels:
        if any(m in e.key for m in ("_mma_kernel", "hot_probe", "radix_", "segment_walk",
                                    "ctr_rows")):
            log(f"profile {name} port kernel: {e.self_device_time_total / 1e3 / n_steps:.4f} "
                f"ms/step x{e.count / n_steps:g}/step {e.key[:80]}")
    ops = sorted((e for e in evs if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
    sorts = [e for e in ops if e.key == "aten::sort"]
    log(f"profile {name}: aten::sort {sum(e.count for e in sorts) / n_steps:g}/step, "
        f"{sum(e.self_device_time_total for e in sorts) / 1e3 / n_steps:.4f} ms/step")
    for e in ops[:12]:
        log(f"profile {name} device by op: {e.self_device_time_total / 1e3 / n_steps:.4f} "
            f"ms/step x{e.count / n_steps:g}/step {e.key[:80]}")
    host = sorted((e for e in evs if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)
    for e in host[:12]:
        log(f"profile {name} host: {e.self_cpu_time_total / 1e3 / n_steps:.4f} ms/step "
            f"x{e.count / n_steps:g}/step {e.key[:80]}")


# -- phase 4: the hot path at full width --------------------------------------

# 32,768 lines: 8 batches of 4096 an epoch (cut from 65,536 for the script's
# time limit; phases 13, 15 and 16-19 read the same data)
HOT_LINES, HOT_IDS, HOT_EPOCHS = 32_768, 10_000, 2


def ctr_lines(rng, n, n_ids, n_slots, n_dense):
    """``n`` MultiSlot lines: one id per sparse slot from ``n_ids`` per
    slot, ``n_dense`` normal features and a learnable label (ids ≡ 0
    mod 5 and the first dense feature push it up; ~half positive)."""
    ids = rng.integers(0, n_ids, (n, n_slots))
    dense = rng.normal(size=(n, n_dense))
    labels = ((ids % 5 == 0).sum(axis=1) + 2.0 * dense[:, 0] > 0.2 * n_slots).astype(int)
    id_s = np.char.add("1 ", ids.astype(str))
    dense_s = np.char.add("1 ", np.char.mod("%.4f", dense))
    lab_s = np.char.add("1 ", labels.astype(str))
    return [" ".join(row) for row in np.concatenate(
        [id_s, dense_s, lab_s[:, None]], axis=1).tolist()]


def ctr_dataset(lines, n_slots, n_dense):
    from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc

    slots = ([SlotDesc(f"s{i}") for i in range(n_slots)]
             + [SlotDesc(f"d{i}", is_float=True) for i in range(n_dense)]
             + [SlotDesc("label", is_float=True)])
    ds = InMemoryDataset(slots, seed=0)
    ds.load_from_lines(lines)
    return ds


def slot_names(n_slots, n_dense):
    return dict(sparse_slots=[f"s{i}" for i in range(n_slots)],
                dense_slots=[f"d{i}" for i in range(n_dense)], label_slot="label")


def hot_dataset():
    """The hot paths' data: ``HOT_LINES`` MultiSlot lines, ``HOT_IDS`` ids
    per slot, made from a seed and parsed once for both hot paths."""
    rng = np.random.default_rng(20)
    t0 = time.perf_counter()
    lines = ctr_lines(rng, HOT_LINES, HOT_IDS, SLOTS, DENSE)
    ds = ctr_dataset(lines, SLOTS, DENSE)
    log(f"hot path: {ds.num_records} MultiSlot lines made and parsed in "
        f"{time.perf_counter() - t0:.2f} s (host); {SLOTS} x {HOT_IDS} ids")
    return ds


def phase_hot_path(dev, card, ds, profile_dir=None, shards=1):
    """DeepFM at the Criteo width trained by ``CtrStreamTrainer`` over the
    persistent hot tier: two epochs of 8 batches of 4096. ``shards`` > 1
    row-shards the tier over a mesh of that many shards on the card (one
    bank per shard; "auto" routing, alltoall from 4 shards): the batch
    splits into ``shards`` slices, each probed by ``hot_probe`` and pushed
    by ``hot_scatter_apply`` on its owner's block, so both launch
    ``shards`` times per step. Returns (launch counts, warm samples/s, and
    for ``shards`` > 1 the tier's snapshot phase 27 starts from)."""
    from paddle_tpu_torch.core.mesh import make_mesh
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.hot_tier import HotTierConfig
    from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer
    from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

    name = "hot path" if shards == 1 else f"sharded hot path ({shards} shards)"
    table = MemorySparseTable(TableConfig(
        shard_num=16, accessor_config=AccessorConfig(embedx_dim=DIM, embedx_threshold=0.0)))
    try:
        model = DeepFM(CtrConfig(SLOTS, DENSE, DIM, (400, 400, 400)),
                       generator=torch.Generator().manual_seed(0))
        mesh = make_mesh({"ps": shards}, device=dev) if shards > 1 else None
        trainer = CtrStreamTrainer(model, Adam(learning_rate=1e-3), table,
                                   hot_tier=HotTierConfig(capacity=HOT_CAP, mesh=mesh),
                                   device=dev, **slot_names(SLOTS, DENSE))
        tier = trainer.hot_tier
        host_s = {"ensure": 0.0, "device_state": 0.0, "step": 0.0}
        overflow = []

        def timed(key, fn):
            def wrapped(*a, **k):
                t = time.perf_counter()
                out = fn(*a, **k)
                host_s[key] += time.perf_counter() - t
                return out
            return wrapped

        def step_with_overflow(*a):
            out = hot_step(*a)
            overflow.extend(out[4:])  # device scalars; read after the run
            return out

        hot_step = trainer._hot_step
        tier.ensure = timed("ensure", tier.ensure)
        tier.device_map.device_state = timed("device_state", tier.device_map.device_state)
        trainer._hot_step = timed("step", step_with_overflow)

        torch.cuda.synchronize()
        reset_launches()
        results = []
        for epoch in range(HOT_EPOCHS):
            before = dict(tier.stats())
            for k in host_s:
                host_s[k] = 0.0
            r = trainer.train_from_dataset(ds, batch_size=BATCH)
            st = r["hot_tier"]
            delta = {k: st[k] - before[k] for k in ("hits", "misses", "cold_fetches",
                                                     "evictions", "writebacks")}
            steps = int(r["steps"])
            log(f"{name} epoch {epoch}: {steps} steps, mean loss {r['loss']:.6f}, "
                f"{r['samples_per_sec']:.1f} samples/s "
                f"({1e3 * BATCH / r['samples_per_sec']:.3f} ms/step), tier {delta}, occupancy "
                f"{st['occupancy']}, shards {st['shards']}, banks {st['banks']}, map rebuilds "
                f"{st['map_rebuilds']}; host ms/step: ensure "
                f"{1e3 * host_s['ensure'] / steps:.3f}, device_state "
                f"{1e3 * host_s['device_state'] / steps:.3f}, step issue "
                f"{1e3 * host_s['step'] / steps:.3f} on {card}")
            results.append((r, delta))
        counts = read_launches()
        steps = sum(int(r["steps"]) for r, _ in results)
        n_overflow = int(sum(int(o) for o in overflow))
        log(f"{name}: {steps} steps, launches {counts}"
            + (f", routing overflow {n_overflow}" if shards > 1 else ""))
        (first, _), (warm, warm_delta) = results
        assert all(np.isfinite(r["loss"]) for r, _ in results), "non-finite loss"
        assert warm["loss"] < first["loss"], "warm epoch loss did not fall"
        probe = "hot_probe_gather" if shards == 1 else "hot_probe"
        assert counts[probe] == shards * steps and \
            counts["hot_scatter_apply"] == shards * steps, \
            f"hot kernel launches {counts} != {shards} x {steps} steps"
        # B4 sorts its rows; sharded, each rank also sorts for its dedup and
        # its pre-merge
        sorts = steps if shards == 1 else 3 * shards * steps
        assert counts["sort_rows"] == sorts, f"sort launches {counts} != {sorts}"
        log(f"{name}: {counts['sort_rows'] / steps:g} radix sorts per step")
        assert n_overflow == 0, f"routing overflow {n_overflow}"
        assert warm_delta["cold_fetches"] == 0 and warm_delta["misses"] == 0, \
            f"warm epoch left the tier: {warm_delta}"
        log(f"{name}: warm epoch {warm['samples_per_sec']:.1f} samples/s, "
            f"{1e3 * BATCH / warm['samples_per_sec']:.3f} ms/step (batch {BATCH}, "
            f"{int(warm['steps'])} steps) on {card}")

        if profile_dir is not None:
            n_batches = HOT_LINES // BATCH
            profile_window(lambda: trainer.train_from_dataset(
                ds, batch_size=BATCH, start_batch=n_batches - 2), 2, profile_dir,
                "hot" if shards == 1 else "sharded_hot")
        snap = mp_hot_snapshot(trainer, ds) if shards > 1 else None

        # flush: the touched rows read back changed from the cold table
        # (no eviction happened, so the table holds the at-admit rows)
        first_batch = next(ds.batch_iter(BATCH))
        keys = np.stack([first_batch[f"s{i}"][0][:, 0] + (np.uint64(i) << np.uint64(32))
                         for i in range(SLOTS)], axis=1).reshape(-1)
        sample = np.unique(keys)[:512]
        before, _ = table.export_full(sample)
        n_flushed = tier.flush()
        after, found = table.export_full(sample)
        changed = (after != before).any(axis=1)
        assert found.all() and changed.all(), \
            f"flush: {int((~changed).sum())} of {len(sample)} touched rows unchanged"
        log(f"{name} flush: {n_flushed} dirty rows written back; {len(sample)} touched keys "
            f"read back changed (show {before[:, 3].mean():.3f} -> {after[:, 3].mean():.3f})")
        return counts, float(warm["samples_per_sec"]), snap
    finally:
        table.close()


# -- phase 5: the same small runs on the card and on the CPU ------------------

def small_hot_run(device, weights, lines, hot, kernels="auto", capacity=224, shards=1,
                  batch=64):
    """The hot-tier harness (3 slots, 2 dense, dim 8, DNN (8,), batch 64,
    256 records, ids from 400 per slot: eviction churn at capacity 224)
    with the tier (``hot``; row-sharded over ``shards`` when > 1) or
    without: (loss, params, opt state, sorted table rows, tier stats)."""
    from paddle_tpu_torch.core.mesh import make_mesh
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.hot_tier import HotTierConfig
    from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer
    from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

    table = MemorySparseTable(TableConfig(shard_num=4))
    try:
        opt = Adam(1e-2)
        mesh = make_mesh({"ps": shards}, device=device) if shards > 1 else None
        tr = CtrStreamTrainer(DeepFM(CtrConfig(3, 2, 8, (8,))), opt, table,
                              hot_tier=HotTierConfig(capacity=capacity, kernels=kernels,
                                                     mesh=mesh)
                              if hot else None, device=device, **slot_names(3, 2))
        tr.params = {k: v.to(device) for k, v in weights.items()}
        tr.opt_state = opt.init(tr.params)
        r = tr.train_from_dataset(ctr_dataset(lines, 3, 2), batch_size=batch)
        if hot:
            tr.hot_tier.flush()
        keys, rows = table.snapshot_items()
        cpu = lambda d: {k: v.cpu() for k, v in d.items()}
        opt_state = {"step": tr.opt_state["step"].cpu(), "m": cpu(tr.opt_state["m"]),
                     "v": cpu(tr.opt_state["v"])}
        return r["loss"], cpu(tr.params), opt_state, rows[np.argsort(keys)], r.get("hot_tier")
    finally:
        table.close()


def assert_hot_runs_bitwise(a, b, what):
    """loss, dense params, Adam state and table rows mod delta_score (save
    column 2, which folds per flush instead of per push)."""
    la, pa, oa, ra, _ = a
    lb, pb, ob, rb, _ = b
    keep = [c for c in range(ra.shape[1]) if c != 2]
    ok = (la == lb and all(torch.equal(pa[k], pb[k]) for k in pa)
          and torch.equal(oa["step"], ob["step"])
          and all(torch.equal(oa[s][k], ob[s][k]) for s in ("m", "v") for k in oa[s])
          and np.array_equal(ra[:, keep], rb[:, keep]))
    log(f"hot parity: {what}: bitwise={ok} (loss {la!r} vs {lb!r})")
    if not ok:
        raise AssertionError(f"hot parity: {what} differ")


def phase_hot_parity(dev):
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM

    rng = np.random.default_rng(0)
    lines = ctr_lines(rng, 256, 400, 3, 2)
    weights = {k: v.detach() for k, v in
               DeepFM(CtrConfig(3, 2, 8, (8,)),
                      generator=torch.Generator().manual_seed(2)).named_parameters()}
    reset_launches()
    tier = small_hot_run(dev, weights, lines, hot=True)
    counts = read_launches()
    assert counts["hot_probe_gather"] == 4 and counts["hot_scatter_apply"] == 4, counts
    assert tier[4]["evictions"] > 0, "no eviction churn"
    plain = small_hot_run(dev, weights, lines, hot=False)
    assert_hot_runs_bitwise(tier, plain, "card, tier (capacity 224) vs no tier")
    reset_launches()
    unfused = small_hot_run(dev, weights, lines, hot=True, kernels="unfused")
    counts = read_launches()
    assert counts["hot_probe_gather"] == 0 and counts["ctr_sparse_rows"] == 4 \
        and counts["merge_sparse_grads"] == 4, counts
    assert_hot_runs_bitwise(tier, unfused, 'card, kernels "auto" vs "unfused"')
    cpu = small_hot_run(torch.device("cpu"), weights, lines, hot=True)
    assert_card_close_to_cpu(tier, cpu, "hot parity")


def assert_card_close_to_cpu(card, cpu, what):
    """Tolerances: cuBLAS vs CPU BLAS matmul order in the dense tower and
    its gradients (the pushed embedding gradients); the sparse rule math
    is bitwise on both."""
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5)
    for k in cpu[1]:
        np.testing.assert_allclose(card[1][k].numpy(), cpu[1][k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(card[3], cpu[3], rtol=1e-4, atol=1e-5)
    log(f"{what}: card vs CPU, loss {card[0]!r} vs {cpu[0]!r} (rtol 1e-5), params "
        f"within rtol 1e-4 atol 1e-6, table rows within rtol 1e-4 atol 1e-5")


# -- phase 5c: the sharded paths at small size ---------------------------------

def small_sharded_pass_run(dev, weights, routing):
    """3 steps of the sharded pass step from keys (5 slots, 3 dense, dim
    4, DNN (8,), batch 32, ``SHARDS`` shards, ``pre_dedup=False``) over a
    200-key pool: (losses, params, cache state) on the CPU."""
    from paddle_tpu_torch.core.mesh import make_mesh
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.embedding_cache import CacheConfig, HbmEmbeddingCache
    from paddle_tpu_torch.ps.sharded_cache import (check_route_overflow,
                                                   make_sharded_ctr_train_step_from_keys)
    from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

    S, B = 5, 32
    rng = np.random.default_rng(60)
    pool = rng.integers(0, 1 << 20, size=(200, S)).astype(np.uint64)
    pool += np.arange(S, dtype=np.uint64) << np.uint64(32)
    table = MemorySparseTable(TableConfig(shard_num=4,
                                          accessor_config=AccessorConfig(embedx_dim=4)))
    try:
        mesh = make_mesh({"ps": SHARDS}, device=dev)
        cfg = CacheConfig(capacity=1 << 12, embedx_dim=4, embedx_threshold=0.0)
        cache = HbmEmbeddingCache(table, cfg, device=dev, device_map=True, mesh=mesh)
        cache.begin_pass(pool.reshape(-1))
        opt = Adam(1e-3)
        step = make_sharded_ctr_train_step_from_keys(
            DeepFM(CtrConfig(S, 3, 4, (8,))), opt, cfg, mesh, np.arange(S), routing=routing,
            pre_dedup=False)
        params = {k: v.to(dev) for k, v in weights.items()}
        opt_state = opt.init(params)
        losses = []
        for _ in range(3):
            keys = pool[rng.integers(0, 200, B)]
            lo = torch.from_numpy((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32))
            params, opt_state, state, loss, ov = step(
                params, opt_state, cache.state, cache.device_map.state, lo.to(dev),
                torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32)).to(dev),
                torch.from_numpy((rng.random(B) < 0.4).astype(np.int32)).to(dev))
            check_route_overflow(ov)
            losses.append(float(loss))
        return (losses, {k: v.cpu() for k, v in params.items()},
                {k: v.cpu() for k, v in cache.state.items()})
    finally:
        table.close()


def phase_sharded_parity(dev):
    """The sharded paths at small size on the card: the sharded tier
    (``SHARDS`` shards, capacity 512: eviction churn) ``"auto"`` ≡
    ``"unfused"`` bitwise and card vs CPU within phase 5's tolerances;
    the sharded tier against the single-card tier within atol 1e-6 (the
    bound the JAX package holds its own to: the rank-averaged dense
    grads associate the batch mean differently); the sharded pass step
    from keys, routed ≡ gathered bitwise at ``pre_dedup=False``."""
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM

    rng = np.random.default_rng(0)
    lines = ctr_lines(rng, 256, 400, 3, 2)
    weights = {k: v.detach() for k, v in
               DeepFM(CtrConfig(3, 2, 8, (8,)),
                      generator=torch.Generator().manual_seed(2)).named_parameters()}
    kw = dict(capacity=512, shards=SHARDS)
    reset_launches()
    auto = small_hot_run(dev, weights, lines, hot=True, **kw)
    counts = read_launches()
    assert counts["hot_probe"] == 4 * SHARDS and counts["hot_scatter_apply"] == 4 * SHARDS, \
        counts
    assert auto[4]["evictions"] > 0 and auto[4]["shards"] == SHARDS, auto[4]
    reset_launches()
    unfused = small_hot_run(dev, weights, lines, hot=True, kernels="unfused", **kw)
    counts = read_launches()
    assert counts["hot_probe"] == 0 and counts["ctr_sparse_rows"] == 4 * SHARDS, counts
    assert_hot_runs_bitwise(auto, unfused, f'card, {SHARDS} shards, kernels "auto" vs "unfused"')
    cpu = small_hot_run(torch.device("cpu"), weights, lines, hot=True, **kw)
    assert_card_close_to_cpu(auto, cpu, f"sharded parity ({SHARDS} shards)")

    lines = ctr_lines(rng, 512, 60, 3, 2)
    single = small_hot_run(dev, weights, lines, hot=True, capacity=512, batch=128)
    sharded = small_hot_run(dev, weights, lines, hot=True, batch=128, **kw)
    diffs = [abs(single[0] - sharded[0]),
             max(float((single[1][k] - sharded[1][k]).abs().max()) for k in single[1]),
             float(np.abs(single[3] - sharded[3]).max())]
    log(f"sharded parity: card, {SHARDS} shards vs one card: |loss| {diffs[0]}, params max "
        f"abs {diffs[1]}, table rows max abs {diffs[2]} (stated bound: atol 1e-6)")
    assert max(diffs) <= 1e-6, diffs

    pw = {k: v.detach() for k, v in
          DeepFM(CtrConfig(5, 3, 4, (8,)),
                 generator=torch.Generator().manual_seed(3)).named_parameters()}
    routed = small_sharded_pass_run(dev, pw, "alltoall")
    gathered = small_sharded_pass_run(dev, pw, "allgather")
    same = routed[0] == gathered[0] and all(
        torch.equal(a[k], b[k]) for a, b in zip(routed[1:], gathered[1:]) for k in a)
    log(f"sharded parity: card, pass step from keys, {SHARDS} shards, routed vs gathered "
        f"(pre_dedup=False): bitwise={same}, losses {routed[0]}")
    assert same, "sharded pass step: routed and gathered differ"


# -- phase 5b: the pass path's small run on the card and on the CPU --------------------

def small_run(device, weights):
    from paddle_tpu_torch.models.ctr import (CtrConfig, DeepFM, make_ctr_train_step_packed,
                                             make_random_packs)
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.embedding_cache import CacheConfig, HbmEmbeddingCache
    from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

    S, D, B = 2, 4, 64
    table = MemorySparseTable(TableConfig(shard_num=2,
                                          accessor_config=AccessorConfig(embedx_dim=4)))
    try:
        cache = HbmEmbeddingCache(table, CacheConfig(capacity=4096, embedx_dim=4,
                                                     embedx_threshold=0.0),
                                  device=device, device_map=True)
        rng = np.random.default_rng(3)
        pool = rng.integers(1, 1 << 18, size=(200, S)).astype(np.uint64)
        pool += np.arange(S, dtype=np.uint64) << np.uint64(32)
        cache.begin_pass(pool.reshape(-1))
        model = DeepFM(CtrConfig(S, D, 4, (16, 16)))
        opt = Adam(1e-2)
        params = {k: v.to(device) for k, v in weights.items()}
        opt_state = opt.init(params)
        step = make_ctr_train_step_packed(model, opt, cache.config, np.arange(S), B, D,
                                          device=device)
        losses = []
        state = cache.state
        for pk in make_random_packs(rng, pool, B, D, 4, p_click=0.4):
            params, opt_state, state, loss = step(params, opt_state, state,
                                                  cache.device_map.state,
                                                  torch.from_numpy(pk).to(device))
            losses.append(float(loss))
        return np.asarray(losses), {k: v.cpu().numpy() for k, v in state.items()}, \
            {k: v.cpu().numpy() for k, v in params.items()}
    finally:
        table.close()


def phase_parity(dev):
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
    from paddle_tpu_torch.ps.device_hash import _mix32

    # the int64 hash emulation on the card: low-bit keys, all-ones halves
    rng = np.random.default_rng(4)
    keys = np.concatenate([rng.integers(1, 1 << 30, 4096, dtype=np.uint64),
                           rng.integers(0, 1 << 64, 4096, dtype=np.uint64),
                           np.asarray([0xFFFFFFFFFFFFFFFF, 0xFFFFFFFF, 0], np.uint64)])
    hi = torch.from_numpy((keys >> np.uint64(32)).astype(np.int64))
    lo = torch.from_numpy((keys & np.uint64(0xFFFFFFFF)).astype(np.int64))
    for seed in (0x1234ABCD, 0xFFFFFFFF):
        c, g = _mix32(hi, lo, seed), _mix32(hi.to(dev), lo.to(dev), seed).cpu()
        assert torch.equal(c, g), "key hash differs between card and CPU"
    log(f"parity: key hash bit-equal on card and CPU over {len(keys)} keys")

    weights = {k: v.detach() for k, v in
               DeepFM(CtrConfig(2, 4, 4, (16, 16)),
                      generator=torch.Generator().manual_seed(1)).named_parameters()}
    gl, gs, gp = small_run(dev, weights)
    cl, cs, cp = small_run(torch.device("cpu"), weights)
    # tolerances: cuBLAS vs CPU BLAS matmul order in the dense tower and
    # its gradients (the merge of duplicate rows is deterministic and
    # bit-equal on both: phase 2)
    np.testing.assert_allclose(gl, cl, rtol=1e-5)
    for k in cs:
        np.testing.assert_allclose(gs[k], cs[k], rtol=1e-4, atol=1e-6, err_msg=k)
    for k in cp:
        np.testing.assert_allclose(gp[k], cp[k], rtol=1e-4, atol=1e-6, err_msg=k)
    log(f"parity: card vs CPU, 4 steps, losses {gl.tolist()} vs {cl.tolist()} "
        f"(rtol 1e-5), cache and params within rtol 1e-4 atol 1e-6")


# -- phase 6: the flash-attention kernels against their plain versions --------

BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor cores, NVIDIA data sheet
FA_SHAPE = (8, 512, 16, 64)     # ERNIE's attention: batch, seq, heads, head dim
# Absolute tolerances, with their reasons. "highest": f32 operands on both
# sides; the kernel sums in its own order and runs an online softmax over
# 32-key tiles. "default": both sides round Q, K, V, dO, P and dS to bf16
# and sum exact products in f32, but the forward kernel rounds P against
# its running maximum over 64-key steps (two 32-row ring tiles; O and l
# take the f32 correction when the maximum grows) where the plain version
# uses the row's maximum, so past the first step the two round different
# values of each P to bf16, each within 2^-9 of itself, and the errors of
# a row's terms add up like a random walk; and where the two f32 sums put
# a value of P or dS on either side of a bf16 rounding boundary its term
# moves by one bf16 step (2^-8 of itself or more): a handful of such flips
# per output, largest in the gradients, whose dS terms are large. lse is
# never rounded: it differs by the f32 sums' order and exp2 of an FMA for
# exp.
FA_TOL = {"highest": {"out": 1e-5, "lse": 1e-5, "grad": 1e-5},
          "default": {"out": 5e-3, "lse": 1e-4, "grad": 1e-2}}
FA_EXACT_TOL = {"highest": 1e-5, "default": 2e-2}  # against local_attention (f32)


def fa_cases():
    """(B, Lq, Lk, H, D, causal, q_offset, k_offset), each under both
    precisions: ERNIE's call, its causal form, a ring step (queries of
    the second half against the first half's keys), a ring step whose
    leading rows see no key, and an unaligned length."""
    B, L, H, D = FA_SHAPE
    return [(B, L, L, H, D, False, 0, 0), (B, L, L, H, D, True, 0, 0),
            (B, L, L // 2, H, D, True, L // 2, 0), (B, L, L // 2, H, D, True, 0, L // 4),
            (B, 500, 500, H, D, False, 0, 0)]


def fa_bounds(B, L, H, D, itemsize=4):
    """{kernel: (bytes, bf16 ops)} of a non-causal call: each input read
    once, each output written once (f32 [B, L, H, D] tensors, f32 lse and
    delta); 2·D operations per (query, key) pair and product (B5: S, PV;
    B6: S, dP, dQ; B7: S, dP, dV, dK)."""
    x, row, pairs = B * L * H * D * itemsize, B * L * H * 4, B * H * L * L
    return {"fwd": (4 * x + row, pairs * 2 * D * 2),
            "dq": (5 * x + 2 * row, pairs * 2 * D * 3),
            "dkv": (6 * x + 2 * row, pairs * 2 * D * 4)}


def phase_flash_kernels(dev):
    """B5–B7 against their plain versions on the card, on the same inputs;
    the times of ERNIE's call (non-causal, "default", f32) for the
    kernels line."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel.ring_attention import local_attention

    rng = np.random.default_rng(40)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for case in fa_cases():
        B, Lq, Lk, H, D, causal, qo, ko = case
        f = np.float32
        q, k, v, do = (torch.from_numpy(rng.normal(size=(B, n, H, D)).astype(f)).to(dev)
                       for n in (Lq, Lk, Lk, Lq))
        dlse = torch.from_numpy(rng.normal(size=(B, Lq, H)).astype(f)).to(dev)
        for prec in ("default", "highest"):
            kw = dict(causal=causal, q_offset=qo, k_offset=ko, precision=prec)
            out, lse = fa.flash_attention_fwd(q, k, v, **kw)
            # the lse cotangent folds into delta, as the autograd Function does
            delta = ((do * out).sum(-1) - dlse).contiguous()
            dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
            torch.cuda.synchronize()
            w_out, w_lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
            w_dq = fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
            w_dk, w_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
            errs = {"out": max_abs(out, w_out), "lse": max_abs(lse, w_lse),
                    "dq": max_abs(dq, w_dq), "dk": max_abs(dk, w_dk), "dv": max_abs(dv, w_dv)}
            tol = FA_TOL[prec]
            finite = all(bool(torch.isfinite(t).all()) for t in (out, lse, dq, dk, dv))
            ok = finite and all(e <= tol.get(n, tol["grad"]) for n, e in errs.items())
            line = (f"kernel flash_attention {prec} B={B} Lq={Lq} Lk={Lk} H={H} D={D} "
                    f"causal={causal} q_offset={qo} k_offset={ko}: max_abs {errs} "
                    f"(stated bounds {tol})")
            if not causal:
                exact = max_abs(out, local_attention(q, k, v))
                ok = ok and exact <= FA_EXACT_TOL[prec]
                line += f"; vs local_attention {exact} (stated bound {FA_EXACT_TOL[prec]})"
            log(line)
            if not ok:
                raise AssertionError(f"flash attention kernels disagree: {case} {prec}")
            for name, keys in (("fwd", ("out", "lse")), ("dq", ("dq",)), ("dkv", ("dk", "dv"))):
                worst[name] = max(worst[name], *(errs[n] for n in keys))
            del out, lse, dq, dk, dv, w_out, w_lse, w_dq, w_dk, w_dv

    # times at ERNIE's call: f32 [8, 512, 16, 64], non-causal, "default"
    B, L, H, D = FA_SHAPE
    q, k, v, do = (torch.from_numpy(rng.normal(size=FA_SHAPE).astype(np.float32)).to(dev)
                   for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v)
    delta = (do * out).sum(-1).contiguous()
    bw = (q, k, v, do, lse, delta)
    # each output row of B5, B6 and B7 is written by one block, without
    # atomics: two runs give the same bits
    first = (*fa.flash_attention_fwd(q, k, v), fa.flash_attention_bwd_dq(*bw),
             *fa.flash_attention_bwd_dkv(*bw))
    second = (*fa.flash_attention_fwd(q, k, v), fa.flash_attention_bwd_dq(*bw),
              *fa.flash_attention_bwd_dkv(*bw))
    torch.cuda.synchronize()
    same = [bitwise_equal(a, b) for a, b in zip(first, second)]
    log(f"kernel flash_attention_fwd/bwd_dq/bwd_dkv at {list(FA_SHAPE)}: two runs bitwise "
        f"equal (out, lse, dQ, dK, dV) {same}")
    assert all(same), "flash attention kernels are not deterministic"
    del first, second
    runs = {"fwd": (lambda: fa.flash_attention_fwd(q, k, v),
                    lambda: fa.flash_attention_fwd_plain(q, k, v)),
            "dq": (lambda: fa.flash_attention_bwd_dq(*bw),
                   lambda: fa.flash_attention_bwd_dq_plain(*bw)),
            "dkv": (lambda: fa.flash_attention_bwd_dkv(*bw),
                    lambda: fa.flash_attention_bwd_dkv_plain(*bw))}
    # the yardstick: PyTorch's fused attention on the same q, k, v in bf16
    # ([B, H, L, D]); forward for B5, its backward (dQ, dK, dV at once) for
    # B6 and B7
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (t.permute(0, 2, 1, 3).to(torch.bfloat16).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    gs = do.permute(0, 2, 1, 3).to(torch.bfloat16).contiguous()
    so = sdpa(qs, ks, vs)

    def sdpa_fwd():
        with torch.no_grad():
            sdpa(qs, ks, vs)

    lib_fwd, _ = time_cuda(sdpa_fwd)
    lib_bwd, _ = time_cuda(lambda: torch.autograd.grad(so, (qs, ks, vs), gs, retain_graph=True))
    bounds = fa_bounds(B, L, H, D)
    result = {}
    for name, (kern, plain_fn) in runs.items():
        ms_k, call_k = time_cuda(kern)
        ms_p, _ = time_cuda(plain_fn)
        nbytes, nops = bounds[name]
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / BF16_OPS_PER_S * 1e3
        lib = lib_fwd if name == "fwd" else lib_bwd
        log(f"kernel flash_attention_{name} at {list(FA_SHAPE)} f32 default: device {ms_k} ms, "
            f"plain {ms_p} ms, bound {max(bytes_ms, ops_ms)} ms ({nbytes} B, {nops} bf16 ops), "
            f"scaled_dot_product_attention bf16 {'forward' if name == 'fwd' else 'backward'} "
            f"{lib} ms; per call from an idle card {call_k} ms")
        result[name] = {"max_abs_err": worst[name], "ms": ms_k, "plain_ms": ms_p,
                        "bound_ms": max(bytes_ms, ops_ms),
                        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                        "library_ms": lib}
    fwd = result["fwd"]
    log(f"kernel flash_attention forward at {list(FA_SHAPE)}: B5 {fwd['ms']} ms against "
        f"scaled_dot_product_attention's bf16 forward {lib_fwd} ms (ratio {fwd['ms'] / lib_fwd}); "
        f"share of bound {fwd['bound_ms'] / fwd['ms']}")
    pair = result["dq"]["ms"] + result["dkv"]["ms"]
    log(f"kernel flash_attention backward pair at {list(FA_SHAPE)}: B6 + B7 {pair} ms against "
        f"scaled_dot_product_attention's bf16 backward {lib_bwd} ms (ratio {pair / lib_bwd}); "
        f"share of bound B6 {result['dq']['bound_ms'] / result['dq']['ms']}, "
        f"B7 {result['dkv']['bound_ms'] / result['dkv']['ms']}")
    return result


# -- phase 7: ERNIE training at full width -------------------------------------

ERNIE_CFG = dict(vocab_size=32768, hidden_size=1024, num_heads=16, ffn_size=4096,
                 num_layers=8, max_seq_len=512)
ERNIE_BATCH, ERNIE_SEQ, ERNIE_WARM, ERNIE_STEPS = 8, 512, 2, 10


def lm_loss(out, labels):
    """Mean token cross entropy over the vocabulary (the JAX smoke's)."""
    from paddle_tpu_torch.nn import functional as F

    return F.cross_entropy(out.reshape(-1, out.shape[-1]), labels.reshape(-1))


def phase_ernie(dev, card, profile_dir=None):
    """``Trainer(Ernie(cfg), Adam(1e-4), lm_loss)`` on one numpy-seeded
    batch, repeated: 2 warm-up and 10 timed steps."""
    from paddle_tpu_torch.executor import Trainer
    from paddle_tpu_torch.models.ernie import Ernie, ErnieConfig
    from paddle_tpu_torch.optimizer import Adam

    cfg = ErnieConfig(**ERNIE_CFG)
    t0 = time.perf_counter()
    model = Ernie(cfg, generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    trainer = Trainer(model, Adam(1e-4), lm_loss, seed=0, device=dev)
    rng = np.random.default_rng(30)
    shape = (ERNIE_BATCH, ERNIE_SEQ)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)
    torch.cuda.synchronize()
    log(f"ernie: {n_params} parameters, built and moved to the card in "
        f"{time.perf_counter() - t0:.2f} s (host)")

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = []
    for i in range(ERNIE_WARM + ERNIE_STEPS):
        if i == ERNIE_WARM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(trainer.train_step(ids, labels))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_launches()
    steps = ERNIE_WARM + ERNIE_STEPS
    losses = torch.stack(losses).cpu().numpy()
    tokens = ERNIE_BATCH * ERNIE_SEQ
    stats = {"ms_per_step": 1e3 * dt / ERNIE_STEPS, "tokens_per_s": tokens * ERNIE_STEPS / dt,
             "peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"ernie: {steps} steps, launches {counts}, losses {losses.tolist()}")
    log(f"ernie: {stats['tokens_per_s']:.1f} tokens/s, {stats['ms_per_step']:.3f} ms/step "
        f"(batch {ERNIE_BATCH} x seq {ERNIE_SEQ}, {ERNIE_STEPS} timed steps, {dt:.4f} s), peak "
        f"memory {stats['peak_bytes']} B on {card}")
    assert np.isfinite(losses).all(), "non-finite loss"
    assert losses[-1] < losses[0], "loss did not fall"
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert counts[name] == steps * cfg.num_layers, \
            f"{name}: {counts[name]} launches in {steps} steps of {cfg.num_layers} layers"
    if profile_dir is not None:
        def run():
            for _ in range(2):
                trainer.train_step(ids, labels)
        profile_window(run, 2, profile_dir, "ernie")
    return counts, stats


# -- phase 8: a small ERNIE on the card and on the CPU ---------------------------

def small_ernie_run(device, weights, causal, impl, batches):
    """3 Trainer steps of a small ERNIE: (losses, final params on the CPU)."""
    from paddle_tpu_torch.executor import Trainer
    from paddle_tpu_torch.models.ernie import Ernie, ErnieConfig
    from paddle_tpu_torch.optimizer import Adam

    cfg = ErnieConfig(vocab_size=1024, hidden_size=64, num_heads=4, ffn_size=128,
                      num_layers=2, max_seq_len=64, causal=causal, attn_impl=impl)
    model = Ernie(cfg)
    model.load_state_dict(weights)
    tr = Trainer(model, Adam(1e-3), lm_loss, device=device)
    losses = [tr.train_step(ids, labels) for ids, labels in batches]
    return (np.asarray([float(x) for x in losses]),
            {k: v.cpu() for k, v in tr.state["params"].items()})


def phase_ernie_parity(dev):
    """The same 3 steps from the same weights: ``attn_impl="auto"`` on the
    card (the kernels) against ``"flash"`` on the CPU (their plain
    versions). Tolerances: losses rtol 1e-4 (cuBLAS vs CPU matmul order,
    the kernels' summation order, a bf16 rounding flip of P or dS).
    Adam divides by sqrt(v), so an element whose gradient is near zero
    moves by up to lr whatever the sign of its rounding noise: parameters
    are compared by the update they received, ||Δcard − Δcpu|| / ||Δcpu||
    ≤ 5e-2 per tensor, leaving out the key bias (a constant added to
    every key of a row leaves its softmax unchanged, so that bias has a
    true gradient of 0 and moves on rounding noise alone)."""
    from paddle_tpu_torch.models.ernie import Ernie, ErnieConfig

    rng = np.random.default_rng(50)
    batches = [tuple(torch.from_numpy(rng.integers(0, 1024, (2, 64))) for _ in range(2))
               for _ in range(3)]
    for causal in (False, True):
        weights = Ernie(ErnieConfig(vocab_size=1024, hidden_size=64, num_heads=4, ffn_size=128,
                                    num_layers=2, max_seq_len=64),
                        generator=torch.Generator().manual_seed(5)).state_dict()
        reset_launches()
        gl, gp = small_ernie_run(dev, weights, causal, "auto",
                                 [(i.to(dev), y.to(dev)) for i, y in batches])
        counts = read_launches()
        assert all(counts[f"flash_attention_{n}"] == 6 for n in ("fwd", "bwd_dq", "bwd_dkv")), \
            f"card run: flash launches {counts} != 3 steps x 2 layers"
        cl, cp = small_ernie_run(torch.device("cpu"), weights, causal, "flash", batches)
        np.testing.assert_allclose(gl, cl, rtol=1e-4)
        worst = 0.0
        for k, w0 in weights.items():
            dg, dc = gp[k] - w0, cp[k] - w0
            if k.endswith("attn.qkv_b"):  # head-major [H, 3, D]: drop the key bias
                dg, dc = dg.reshape(4, 3, 16)[:, [0, 2]], dc.reshape(4, 3, 16)[:, [0, 2]]
            rel = float((dg - dc).norm() / dc.norm())
            worst = max(worst, rel)
            assert rel <= 5e-2, f"ernie parity causal={causal}: {k} update differs by {rel}"
        log(f"ernie parity causal={causal}: card (kernels) vs CPU (plain), 3 steps, losses "
            f"{gl.tolist()} vs {cl.tolist()} (rtol 1e-4); worst relative update difference "
            f"{worst} (stated bound 5e-2)")


# -- phase 9: ResNet-50 at full width, f32, O1 and O2 ---------------------------

RESNET_BATCH, RESNET_WARM, RESNET_STEPS = 128, 2, 10


def phase_resnet(dev, card):
    """``Trainer(resnet50(), Momentum(0.1, 0.9, weight_decay=1e-4),
    CrossEntropyLoss(), amp=...)`` on one numpy-seeded batch of 128
    [3, 224, 224] images, repeated, for amp False, "O1" and "O2": 2
    warm-up and 10 timed steps each. Returns the trainers and the batch
    for the kernel counts, which come last."""
    from paddle_tpu_torch.executor import Trainer
    from paddle_tpu_torch.models.resnet import resnet50
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum

    rng = np.random.default_rng(90)
    x = torch.from_numpy(rng.normal(size=(RESNET_BATCH, 3, 224, 224)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 1000, RESNET_BATCH)).to(dev)
    weights = resnet50(generator=torch.Generator().manual_seed(9)).state_dict()
    trainers, stats = {}, {}
    for amp in (False, "O1", "O2"):
        model = resnet50()
        model.load_state_dict(weights)
        tr = Trainer(model, Momentum(0.1, 0.9, weight_decay=1e-4), CrossEntropyLoss(),
                     amp=amp, device=dev)
        buf0 = {k: v.clone() for k, v in tr.state["buffers"].items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = []
        for i in range(RESNET_WARM + RESNET_STEPS):
            if i == RESNET_WARM:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            losses.append(tr.train_step(x, y))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses = torch.stack(losses).float().cpu().numpy()
        name = "f32" if amp is False else amp
        st = {"ms_per_step": 1e3 * dt / RESNET_STEPS,
              "images_per_s": RESNET_BATCH * RESNET_STEPS / dt,
              "peak_bytes": torch.cuda.max_memory_allocated()}
        log(f"resnet50 {name}: losses {[round(float(v), 4) for v in losses]}")
        log(f"resnet50 {name}: {st['images_per_s']:.1f} images/s, {st['ms_per_step']:.3f} "
            f"ms/step (batch {RESNET_BATCH} x 3x224x224, {RESNET_STEPS} timed steps, "
            f"{dt:.4f} s), peak memory {st['peak_bytes']} B on {card}")
        assert np.isfinite(losses).all(), f"resnet50 {name}: non-finite loss"
        moved = sum(not torch.equal(v, buf0[k]) for k, v in tr.state["buffers"].items())
        assert moved == len(buf0), f"resnet50 {name}: {len(buf0) - moved} BN buffers unmoved"
        if amp == "O2":
            for k, p in tr.state["params"].items():
                assert p.dtype == torch.bfloat16 and torch.equal(
                    p, tr.opt_state["master"][k].to(torch.bfloat16)), \
                    f"resnet50 O2: {k} is not its master cast to bf16"
        trainers[name], stats[name] = tr, st
    log(f"resnet50: images/s f32 {stats['f32']['images_per_s']:.1f}, O1 "
        f"{stats['O1']['images_per_s']:.1f} ({stats['O1']['images_per_s'] / stats['f32']['images_per_s']:.2f}x), "
        f"O2 {stats['O2']['images_per_s']:.1f} "
        f"({stats['O2']['images_per_s'] / stats['f32']['images_per_s']:.2f}x) on {card}")
    return trainers, (x, y)


def phase_resnet_kernel_counts(trainers, batch, profile_dir=None):
    """Device kernels one ResNet-50 Trainer step issues in each mode
    (torch.profiler over one step, after the timed phases); with
    ``--profile``, a breakdown of 2 steps of each mode."""
    for name, tr in trainers.items():
        k, m, _ = device_kernels(lambda: tr.train_step(*batch))
        log(f"resnet50 {name}: {k} device kernels (+{m} memsets) per Trainer step")
        if profile_dir is not None:
            profile_window(lambda: [tr.train_step(*batch) for _ in range(2)], 2, profile_dir,
                           f"resnet50_{name}")


# -- phase 10: LeNet through hapi.Model on the synthetic MNIST -------------------

def mnist_ceiling(labels):
    """The best accuracy any model can reach on the synthetic MNIST: its
    classes light a patch at (7k mod 21, 7k mod 21), so k, k+3, k+6 and
    k+9 share a patch, and only the commonest label of each group can be
    told. (JAX package's ``data/vision.py``, which the port keeps.)"""
    groups = {}
    for k in range(10):
        groups.setdefault((7 * k) % 21, []).append(k)
    return sum(max(int((labels == k).sum()) for k in ks) for ks in groups.values()) / len(labels)


def phase_lenet(dev, card):
    """``hapi.Model(LeNet()).prepare(Adam(1e-3), CrossEntropyLoss(),
    [Accuracy()], amp_configs=...)`` on ``MNIST(mode="train")`` (2048
    synthetic images), batch 64, 2 epochs, then ``evaluate`` on
    ``mode="test"``, for O0 and O1."""
    from paddle_tpu_torch.data.loader import DataLoader
    from paddle_tpu_torch.data.vision import MNIST
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.metrics import Accuracy
    from paddle_tpu_torch.models.lenet import LeNet
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Adam

    train, test = MNIST(mode="train"), MNIST(mode="test")
    ceiling = mnist_ceiling(test.labels)
    for level in ("O0", "O1"):
        m = Model(LeNet(generator=torch.Generator().manual_seed(0)), device=dev)
        m.prepare(Adam(1e-3), CrossEntropyLoss(), [Accuracy()], amp_configs=level)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = m.fit(DataLoader(train, 64, shuffle=True, seed=0), epochs=2, verbose=0)
        fit_s = time.perf_counter() - t0
        ev = m.evaluate(DataLoader(test, 64))
        log(f"lenet {level}: fit {len(train)} images x 2 epochs (batch 64) in {fit_s:.3f} s "
            f"({2 * len(train) / fit_s:.1f} images/s, a host sync per batch), epoch losses "
            f"{[round(v, 4) for v in hist['loss']]}, test accuracy {ev['accuracy']:.4f} "
            f"(the data allows at most {ceiling:.4f}; chance 0.1), eval loss "
            f"{ev['eval_loss']:.4f} on {card}")
        assert np.isfinite(hist["loss"]).all() and hist["loss"][-1] < hist["loss"][0], \
            f"lenet {level}: loss did not fall"
        assert ev["accuracy"] >= 0.8 * ceiling, \
            f"lenet {level}: accuracy {ev['accuracy']} below 0.8 of the data's {ceiling}"


# -- phase 11: a small ResNet and LeNet on the card and on the CPU ---------------

def small_vision_run(device, kind, weights, amp, batches):
    """``Trainer`` steps, one a batch: after each step, (the losses so far,
    params and buffers on the CPU)."""
    from paddle_tpu_torch.executor import Trainer
    from paddle_tpu_torch.models.lenet import LeNet
    from paddle_tpu_torch.models.resnet import BottleneckBlock, ResNet
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum

    model = LeNet() if kind == "lenet" else ResNet(BottleneckBlock, [1, 1, 1, 1], 10)
    model.load_state_dict(weights)
    tr = Trainer(model, Momentum(0.01, 0.9, weight_decay=1e-4), F.cross_entropy, amp=amp,
                 device=device)
    losses, snaps = [], []
    for x, y in batches:
        losses.append(float(tr.train_step(x.to(device), y.to(device))))
        snaps.append((np.asarray(losses), {k: v.float().cpu() for k, v in
                                           {**tr.state["params"], **tr.state["buffers"]}.items()}))
    return snaps


# (loss, update, running-stat) bounds by model, amp level and steps. The
# update bound holds ||Δcard − Δcpu|| / ||Δcpu|| over all parameters
# together (the worst tensor's is logged); the stat bound each running
# stat's largest difference over its largest value. In O1 the CPU side
# rounds each conv output to bf16 as cuDNN does on the card
# (``cpu_oracle``). Readings on an H100 80GB HBM3 (700 W) by
# `vision_parity_probe.py`, seeds 70-72 at batch 8 (70 is this phase's;
# the card's runs repeat bit for bit), after 1 / 3 steps. LeNet has no
# BatchNorm: f32 differs by summation order (1e-7 in the losses, up to
# 5.2e-6 in the updates); O1 against the oracle reads 1.0e-7 in the
# losses and 1.0e-5-1.2e-4 / 1.0e-5-8.3e-5 in the updates, where O1 and
# f32 differ by 1.9e-2-2.5e-2 (and card vs the plain CPU by 5.8e-3-
# 2.3e-2): the bounds see an amp conv fault. The small ResNet's training
# gradient is ill-conditioned at its initialization (BatchNorm on batch
# statistics: f32 and f64 gradients differ by 2.7e-4 in train mode,
# 2.2e-7 in eval mode), so every rounding difference grows: f32 card vs
# CPU reads up to 1.1e-3 / 5.1e-2 in the updates, two CPU conv algorithms
# (oneDNN on and off) up to 1.2e-3 / 4.6e-2; batch 32 does not help. In
# O1 card vs oracle reads losses 4.4e-4-5.6e-4 / 1.8e-3-8.3e-3, updates
# 0.159-0.193 / 0.336-0.357 and running stats 2.5e-3-4.2e-3 / 2.2e-2-
# 2.9e-2, where O1 and f32 on the CPU differ by 0.263 / 0.40-0.41 in the
# updates and 6.5e-3-6.9e-3 / 2.7e-2 in the stats: after one step the
# bounds lie between the two, after three they catch gross faults only,
# and the eval-mode gradient below holds the ResNet's amp convs. Bounds
# are about 1.3-2x the largest reading of the three seeds.
VISION_PARITY = {
    ("resnet", False, 1): (1e-6, 5e-3, 1e-5), ("resnet", False, 3): (2e-3, 2e-1, 5e-3),
    ("resnet", "O1", 1): (1e-3, 0.25, 6e-3), ("resnet", "O1", 3): (1e-2, 0.45, 5e-2),
    ("lenet", False, 1): (1e-6, 1e-4, 0.0), ("lenet", False, 3): (1e-6, 1e-4, 0.0),
    ("lenet", "O1", 1): (1e-6, 5e-4, 0.0), ("lenet", "O1", 3): (1e-6, 5e-4, 0.0)}
# ||g_card − g_cpu|| / ||g_cpu|| of the small ResNet's gradient with
# BatchNorm in eval mode (one loss, no step), by amp level: well
# conditioned, so f32 is held tightly (readings 3.6e-7-4.8e-7; two CPU
# conv algorithms 2.5e-7-3.7e-7; TF32 rounds operands to 10 bits, 2^-11
# relative); O1 against the oracle reads 5.8e-3-7.0e-3, where O1 and f32
# on the CPU differ by 2.5e-2-3.3e-2 (and the card and the plain CPU by
# 2.0e-2-3.7e-2).
VISION_EVAL_GRAD = {False: 5e-6, "O1": 1.5e-2}


def eval_mode_grad(device, weights, batch, amp):
    """The small ResNet's loss gradient over all parameters, BatchNorm on
    its running stats (eval mode), flattened on the CPU."""
    from paddle_tpu_torch.amp import step_ctx
    from paddle_tpu_torch.models.resnet import BottleneckBlock, ResNet
    from paddle_tpu_torch.nn import functional as F

    model = ResNet(BottleneckBlock, [1, 1, 1, 1], 10)
    model.load_state_dict(weights)
    model.to(device).eval()
    x, y = batch
    with step_ctx(amp == "O1"):
        loss = F.cross_entropy(model(x.to(device)), y.to(device))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return torch.cat([g.flatten().double().cpu() for g in grads])


def parity_metrics(weights, gl, gs, cl, cs):
    """(largest relative loss difference, ||Δcard − Δcpu|| / ||Δcpu|| over
    all parameters, the same for the worst tensor, the largest running-
    stat difference over that stat's largest value)."""
    worst_tensor, worst_stat, num, den = 0.0, 0.0, 0.0, 0.0
    for k, w0 in weights.items():
        if k.endswith(("_mean", "_variance")):
            worst_stat = max(worst_stat, float((gs[k] - cs[k]).abs().max() / cs[k].abs().max()))
            continue
        dg, dc = gs[k] - w0, cs[k] - w0
        worst_tensor = max(worst_tensor, float((dg - dc).norm() / dc.norm()))
        num, den = num + float((dg - dc).norm()) ** 2, den + float(dc.norm()) ** 2
    return float(np.abs(gl / cl - 1).max()), (num / den) ** 0.5, worst_tensor, worst_stat


def vision_parity_inputs(kind, batch, seed=70, weight_seed=7):
    """(weights, 3 batches) from numpy and torch seeds: the ResNet of one
    bottleneck a stage at 64x64, LeNet at 28x28."""
    from paddle_tpu_torch.models.lenet import LeNet
    from paddle_tpu_torch.models.resnet import BottleneckBlock, ResNet

    shape = (batch, 3, 64, 64) if kind == "resnet" else (batch, 1, 28, 28)
    rng = np.random.default_rng(seed)
    batches = [(torch.from_numpy(rng.normal(size=shape).astype(np.float32)),
                torch.from_numpy(rng.integers(0, 10, batch))) for _ in range(3)]
    g = torch.Generator().manual_seed(weight_seed)
    model = LeNet(generator=g) if kind == "lenet" else \
        ResNet(BottleneckBlock, [1, 1, 1, 1], 10, generator=g)
    return model.state_dict(), batches


def cpu_oracle(amp):
    """The CPU side of a card-vs-CPU amp comparison: O1 convs rounded to
    bf16 as cuDNN rounds them on the card (``amp.card_conv_rounding``)."""
    import contextlib

    from paddle_tpu_torch.amp import card_conv_rounding

    return card_conv_rounding() if amp else contextlib.nullcontext()


def phase_vision_parity(dev):
    """The same 3 steps from the same weights on the card and on the CPU
    (in O1 the CPU rounds each conv output to bf16, ``cpu_oracle``),
    read after 1 step and after 3, in f32 and O1 (bounds:
    ``VISION_PARITY``): the ResNet of one bottleneck a stage at 64x64 and
    LeNet at 28x28, batch 8 each; and the ResNet's eval-mode gradient
    (``VISION_EVAL_GRAD``)."""
    for kind in ("resnet", "lenet"):
        weights, batches = vision_parity_inputs(kind, 8)
        for amp in (False, "O1"):
            card = small_vision_run(dev, kind, weights, amp, batches)
            with cpu_oracle(amp):
                cpu = small_vision_run(torch.device("cpu"), kind, weights, amp, batches)
            for steps in (1, 3):
                (gl, gs), (cl, cs) = card[steps - 1], cpu[steps - 1]
                got = parity_metrics(weights, gl, gs, cl, cs)
                bounds = VISION_PARITY[(kind, amp, steps)]
                log(f"vision parity {kind} amp={amp} {steps} step(s): card vs CPU, losses "
                    f"{gl.tolist()} vs {cl.tolist()}; loss {got[0]} (bound {bounds[0]}), "
                    f"updates {got[1]} over all params (bound {bounds[1]}), {got[2]} in the "
                    f"worst tensor, running stats {got[3]} (bound {bounds[2]})")
                for what, v, b in zip(("losses", "updates", "running stats"),
                                      (got[0], got[1], got[3]), bounds):
                    assert v <= b, f"{kind} {amp} {steps} step(s): {what} differ by {v}"
            if kind == "resnet":
                gc = eval_mode_grad(dev, weights, batches[0], amp)
                with cpu_oracle(amp):
                    gh = eval_mode_grad(torch.device("cpu"), weights, batches[0], amp)
                rel = float((gc - gh).norm() / gh.norm())
                log(f"vision parity resnet amp={amp}: eval-mode gradient, card vs CPU, "
                    f"{rel} of its norm (bound {VISION_EVAL_GRAD[amp]})")
                assert rel <= VISION_EVAL_GRAD[amp], \
                    f"resnet {amp}: eval-mode gradients differ by {rel}"


# -- phase 12: the Wide&Deep daily loop at full width ---------------------------

# tools/widedeep_daily.py's configuration (BASELINE.md config 4): 8 sparse
# slots, 4 dense, dim 8, DNN 128^2, batch 512, a 2^18-row cache, a 16-shard
# SSD table, Adam(1e-3); 1,000,000 cold rows loaded in one chunk (show 10;
# the tool's 5,000,000 cut for the script's time limit: the base save, the
# shrink and leg B's streamed save, loads and digests scan every row), 3 days of
# 50,000 records with ids from a pool of 20,000, a 500,000-row spill budget.
WD_SLOTS, WD_DENSE, WD_DIM, WD_HIDDEN = 8, 4, 8, (128, 128)
WD_BATCH, WD_CAP, WD_SHARDS = 512, 1 << 18, 16
WD_POP, WD_CHUNK, WD_DAYS, WD_RECORDS, WD_POOL, WD_HOT = \
    1_000_000, 1_000_000, 3, 50_000, 20_000, 500_000
WD_AUC_BAR = 0.80   # the JAX package read 0.821, 0.825, 0.839 on the CPU (WIDEDEEP.json)
# card vs CPU, the small leg: a population of 20,000, 2 days of 2,048
# records (ids from a pool of 2,000), batch 256, the same weights. cuBLAS
# and the CPU BLAS sum the tower's products in other orders; the sparse
# and Adam math is the same on both. Bounds set from the readings of two
# runs on an H100 80GB HBM3 (700 W), tests/test_torch_ctr.py's f32
# tolerances (losses rtol 1e-5, state rtol 1e-4 / atol 1e-6) the start:
# per-day losses 8.2e-8 apart (bound 1e-6); every param and every pass
# key's row within atol 1e-6 alone (rtol needed: 0; bound rtol 1e-5).
WD_SMALL = dict(pop=20_000, days=2, records=2_048, pool=2_000, batch=256)
WD_PARITY = dict(loss_rtol=1e-6, rtol=1e-5, atol=1e-6)
# Leg B, the cold tier at scale: the SSD tier's scale knobs at
# tools/ssd_endurance_demo.py's values (fp16 values, block-compressed logs,
# admission after 2 observations with a 256 KB sketch a shard, the background
# compactor under a 64 MB/s disk budget), read by load_ps_config, on phase
# 12's 16 shards and accessor. The main leg's table, after its shrink and
# spill, streams to one raw file (save_file); that file loads into a fresh
# fp32 table (digest equal to the source's) and into leg B's table. Then one
# day of WD_RECORDS records in WD_B_PASSES passes: a slot's id comes from the
# pool with probability WD_B_POOL_P, else from WD_B_TAIL ids above the
# population, so most tail ids come once (singletons the sketch turns away)
# and some in both passes (admitted at the second pass's flush).
WD_B_KNOBS = {"ssd_value_dtype": "fp16", "ssd_block_compress": True,
              "ssd_admission_threshold": 2, "ssd_admission_sketch_kb": 256,
              "ssd_bg_compact": True, "ssd_io_budget_mbps": 64}
WD_B_PASSES, WD_B_POOL_P, WD_B_TAIL = 2, 0.5, 2_000_000
WD_B_DRAIN_S = 120     # seconds the forced compaction may take to drain


def wd_day_lines(rng, n, pool, tail=0):
    """``tools/widedeep_daily.py``'s ``_day_lines``: ids drawn from ``pool``
    (repeats), a label from ids divisible by 7, the first dense feature
    and noise. With ``tail``, a slot's id is replaced, with probability
    1 - WD_B_POOL_P, by one of ``tail`` ids above the population."""
    ids = rng.choice(pool, size=(n, WD_SLOTS))
    if tail:
        far = (WD_POP + 1 + rng.integers(0, tail, size=(n, WD_SLOTS))).astype(ids.dtype)
        ids = np.where(rng.random((n, WD_SLOTS)) < WD_B_POOL_P, ids, far)
    dense = rng.normal(size=(n, WD_DENSE))
    label = ((ids % 7 == 0).sum(axis=1) + dense[:, 0]
             + rng.normal(scale=0.5, size=n) > 1.0).astype(int)
    id_s = np.char.add("1 ", ids.astype(str))
    dense_s = np.char.add("1 ", np.char.mod("%.4f", dense))
    lab_s = np.char.add("1 ", label.astype(str))
    return [" ".join(row) for row in np.concatenate(
        [id_s, dense_s, lab_s[:, None]], axis=1).tolist()]


def wd_days(n_days, records, pool_size, tail=0, seed=1000):
    """The days' datasets: seeds ``seed`` + day for the lines, ``day`` for
    the shuffle, as the JAX tool makes them (``tail``: ``wd_day_lines``)."""
    from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc

    slots = ([SlotDesc(f"s{i}") for i in range(WD_SLOTS)]
             + [SlotDesc(f"d{i}", is_float=True) for i in range(WD_DENSE)]
             + [SlotDesc("label", is_float=True)])
    pool = np.arange(1, pool_size, dtype=np.uint64)
    days = []
    for day in range(n_days):
        ds = InMemoryDataset(slots, seed=day)
        ds.load_from_lines(wd_day_lines(np.random.default_rng(seed + day), records, pool, tail))
        ds.local_shuffle()
        days.append(ds)
    return days


def wd_table(path, pop):
    """A 16-shard SSD table with ``pop`` cold rows (show 10, so the daily
    shrink's decay does not delete them); seconds to load them."""
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.table import SsdSparseTable, TableConfig

    table = SsdSparseTable(path, TableConfig(shard_num=WD_SHARDS, accessor_config=AccessorConfig(
        embedx_dim=WD_DIM, embedx_threshold=0.0)))
    t0 = time.perf_counter()
    for lo in range(0, pop, WD_CHUNK):
        n = min(WD_CHUNK, pop - lo)
        vals = np.zeros((n, table.full_dim), np.float32)
        vals[:, 3] = 10.0
        table.load_cold(np.arange(lo + 1, lo + 1 + n, dtype=np.uint64), vals)
    return table, time.perf_counter() - t0


def wd_trainer(device, table, weights):
    from paddle_tpu_torch.models.ctr import CtrConfig, WideDeep
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.embedding_cache import CacheConfig
    from paddle_tpu_torch.ps.ps_trainer import CtrPassTrainer

    tr = CtrPassTrainer(WideDeep(CtrConfig(WD_SLOTS, WD_DENSE, WD_DIM, WD_HIDDEN)),
                        Adam(1e-3), table,
                        CacheConfig(capacity=WD_CAP, embedx_dim=WD_DIM, embedx_threshold=0.0),
                        device=device, **slot_names(WD_SLOTS, WD_DENSE))
    tr.params = {k: v.to(device) for k, v in weights.items()}
    tr.opt_state = tr.optimizer.init(tr.params)
    return tr


def wd_weights():
    from paddle_tpu_torch.models.ctr import CtrConfig, WideDeep

    model = WideDeep(CtrConfig(WD_SLOTS, WD_DENSE, WD_DIM, WD_HIDDEN),
                     generator=torch.Generator().manual_seed(0))
    return {k: v.detach() for k, v in model.named_parameters()}


def timed_cache(cache):
    """Wrap the pass cache's prepare/activate/end_pass to log seconds per
    call (prepare runs on the trainer's background thread)."""
    spans = {"prepare": [], "activate": [], "flush": []}

    def wrap(fn, name):
        def run(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            spans[name].append(time.perf_counter() - t0)
            return out
        return run

    cache.prepare_pass = wrap(cache.prepare_pass, "prepare")
    cache.activate_pass = wrap(cache.activate_pass, "activate")
    cache.end_pass = wrap(cache.end_pass, "flush")
    return spans


def capture_first_push():
    """Wrap ``merge_sparse_grads`` and ``ctr_sparse_rows_at`` as the pass
    cache calls them to keep a copy of the inputs of the first call of each
    (one real push: the merge's n entries, then B1 on its merged rows);
    returns the dict that fills ("merge", and "state"/"args"/"kw" for B1),
    and the function that restores both."""
    from paddle_tpu_torch.ps import embedding_cache as ec

    orig, orig_merge, got = ec.ctr_sparse_rows_at, ec.merge_sparse_grads, {}

    def capture(state, uniq, show_sum, click_sum, g, **kw):
        if "state" not in got:
            got.update(state=tuple(c.clone() for c in state), args=(
                uniq.clone(), show_sum.clone(), click_sum.clone(), g.clone()), kw=kw)
        return orig(state, uniq, show_sum, click_sum, g, **kw)

    def capture_merge(rows, grads, shows, clicks, capacity):
        if "merge" not in got:
            got["merge"] = (rows.clone(), grads.clone(), shows.clone(), clicks.clone(),
                            capacity)
        return orig_merge(rows, grads, shows, clicks, capacity)

    ec.ctr_sparse_rows_at = capture
    ec.merge_sparse_grads = capture_merge

    def restore():
        ec.ctr_sparse_rows_at = orig
        ec.merge_sparse_grads = orig_merge
    return got, restore


def wd_merge_check(push):
    """The merge (radix sort + segment walk) on one real Wide&Deep push:
    card == CPU (``merge_sparse_grads_plain``) bitwise, and reproducible on
    the card."""
    from paddle_tpu_torch.ops import hot_kernels as hk

    rows, grads, shows, clicks, C = push["merge"]
    got = hk.merge_sparse_grads(rows, grads, shows, clicks, C)
    again = hk.merge_sparse_grads(rows, grads, shows, clicks, C)
    torch.cuda.synchronize()
    want = hk.merge_sparse_grads_plain(rows.cpu(), grads.cpu(), shows.cpu(), clicks.cpu(), C)
    same = all(bitwise_equal(g.cpu(), w) for g, w in zip(got, want))
    repro = all(bitwise_equal(g, h) for g, h in zip(got, again))
    u = int((want[0] < C).sum())
    log(f"merge_sparse_grads, Wide&Deep push: n={int(rows.numel())} entries, width "
        f"{int(grads.shape[1])}, u={u} distinct rows of {C}: card == CPU bitwise {same}, "
        f"card run twice bitwise {repro}")
    if not (same and repro):
        raise AssertionError("merge_sparse_grads differs from the CPU on the Wide&Deep push")


def wd_b1_check(push, dim=WD_DIM, what="Wide&Deep push", plain_reps=25):
    """B1 in place on one real push (``dim`` wide) of a pass path, bitwise
    against its plain version, then timed beside it and its byte bound."""
    from paddle_tpu_torch.ops import sparse_optimizer as so

    state, (uniq, ds, dc, g), kw = push["state"], push["args"], push["kw"]
    C, n = kw["capacity"], int(uniq.numel())
    got = tuple(c.clone() for c in state)
    so.ctr_sparse_rows_at(got, uniq, ds, dc, g, **kw)
    torch.cuda.synchronize()
    want = so.ctr_sparse_rows_at_plain(tuple(c.clone() for c in state), uniq, ds, dc, g, **kw)
    ok = bitwise_cols(got, want)
    err = max(max_abs(a, b) for a, b in zip(got, want))
    if not ok:
        raise AssertionError(f"B1 disagrees with plain on the {what} (max_abs {err})")
    work = tuple(c.clone() for c in state)
    ms, _ = time_cuda(lambda: so.ctr_sparse_rows_at(work, uniq, ds, dc, g, **kw))
    plain_ms, _ = time_cuda(lambda: so.ctr_sparse_rows_at_plain(work, uniq, ds, dc, g, **kw),
                            reps=plain_reps)
    u = int(((uniq >= 0) & (uniq < C)).sum())
    es, xs = so.rule_state_dim(kw["embed_rule"], 1), so.rule_state_dim(kw["embedx_rule"], dim)
    nbytes = at_bytes(n, u, dim, es, xs, uniq.element_size())
    nops = kernel_ops(u, dim, kw["embed_rule"], kw["embedx_rule"])
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3
    log(f"kernel ctr_sparse_rows_at {kw['embed_rule']}/{kw['embedx_rule']}, {what}: "
        f"n={n} entries, u={u} touched rows of {C}, {uniq.dtype}: bitwise={ok} max_abs={err}; "
        f"device {ms} ms, plain {plain_ms} ms, bound {max(bytes_ms, ops_ms)} ms ({nbytes} B, "
        f"{nops} f32 ops)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_widedeep(dev, card):
    """BASELINE.md config 4 as ``tools/widedeep_daily.py`` runs it, through
    the port: a 1,000,000-row cold population on the SSD tier, three days
    of pass training (``CtrPassTrainer.train_passes``, the next day's build
    overlapped), each day's final-model AUC, a base save, shrink, spill.
    Checks: losses finite and falling; one B1 launch and one merge a step;
    the merge and B1 bitwise on one real push; hot + cold rows =
    ``size()``. Then the small card-vs-CPU leg and a save/load round trip
    on the card."""
    import shutil
    import tempfile

    base = tempfile.mkdtemp(prefix="wd_daily_")
    try:
        table, load_s = wd_table(os.path.join(base, "tbl"), WD_POP)
        try:
            log(f"widedeep: {WD_POP} cold rows loaded in {load_s:.2f} s "
                f"({WD_POP // WD_CHUNK} chunks of {WD_CHUNK}; host)")
            t0 = time.perf_counter()
            days = wd_days(WD_DAYS, WD_RECORDS, WD_POOL)
            log(f"widedeep: {WD_DAYS} days of {WD_RECORDS} records made and parsed in "
                f"{time.perf_counter() - t0:.2f} s (host)")
            tr = wd_trainer(dev, table, wd_weights())
            spans = timed_cache(tr.cache)
            push, restore = capture_first_push()
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            try:
                results = tr.train_passes(days, batch_size=WD_BATCH, drop_last=False)
            finally:
                restore()
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            counts = read_launches()
            steps = sum(int(r["steps"]) for r in results)
            want_steps = WD_DAYS * -(-WD_RECORDS // WD_BATCH)
            losses = [r["loss"] for r in results]
            for d, r in enumerate(results):
                log(f"widedeep day {d + 1}: loss {r['loss']!r}, {int(r['steps'])} steps, "
                    f"{r['samples_per_sec']:.1f} samples/s; prepare "
                    f"{spans['prepare'][d]:.3f} s (host, {'background' if d else 'in line'}), "
                    f"activate {spans['activate'][d]:.3f} s, flush {spans['flush'][d]:.3f} s "
                    f"on {card}")
            log(f"widedeep: {steps} steps in {train_s:.3f} s, launches {counts}")
            assert np.isfinite(losses).all(), f"widedeep: non-finite loss {losses}"
            assert losses[-1] < losses[0], f"widedeep: loss did not fall {losses}"
            assert steps == want_steps, f"widedeep: {steps} steps, want {want_steps}"
            assert counts["ctr_sparse_rows"] == steps, \
                f"widedeep: B1 launches {counts['ctr_sparse_rows']} != steps {steps}"
            assert counts["merge_sparse_grads"] == steps, f"widedeep: merge launches {counts}"
            wd_merge_check(push)
            b1 = wd_b1_check(push)
            del push
            # the host's share of a step: one day's batches sliced and
            # packed as the trainer's prefetcher thread does, no step
            t0 = time.perf_counter()
            n_b = sum(1 for _ in days[0].batch_iter(WD_BATCH, drop_last=False))
            t1 = time.perf_counter()
            for b in days[0].batch_iter(WD_BATCH, drop_last=False):
                tr._pack(b)
            t2 = time.perf_counter()
            step_ms = [1e3 * WD_RECORDS / r["samples_per_sec"] / r["steps"] for r in results]
            log(f"widedeep host: dataset batch slicing {1e3 * (t1 - t0) / n_b:.3f} ms a batch "
                f"of {WD_BATCH}, slicing + packing {1e3 * (t2 - t1) / n_b:.3f} ms (one thread, "
                f"no step); a training step {[round(x, 3) for x in step_ms]} ms by day")

            for d, ds in enumerate(days):
                auc = tr.evaluate(ds, batch_size=WD_BATCH)["auc"]
                log(f"widedeep day {d + 1}: final-model AUC {auc!r} (bar {WD_AUC_BAR}: "
                    f"{'met' if auc >= WD_AUC_BAR else 'MISSED'})")
            t0 = time.perf_counter()
            n_base = table.save(os.path.join(base, "ckpt_base"), mode=2)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            erased = table.shrink()
            shrink_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            spilled = table.spill(WD_HOT)
            spill_s = time.perf_counter() - t0
            st = table.stats()
            log(f"widedeep: base save {n_base} rows ({save_s:.2f} s), shrink erased {erased} "
                f"({shrink_s:.2f} s), spill moved {spilled} ({spill_s:.2f} s); tiers hot "
                f"{st['hot_rows']} + cold {st['cold_rows']} = size {table.size()}, disk "
                f"{st['disk_bytes']} B")
            assert st["hot_rows"] + st["cold_rows"] == table.size(), f"widedeep: tiers {st}"
            assert st["hot_rows"] <= WD_HOT, f"widedeep: spill left {st['hot_rows']} hot rows"
            cold = wd_cold_tier_leg(dev, card, table, base, save_s)
        finally:
            table.close()
        wd_parity(dev, base)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return counts, b1, cold


def wd_cold_table(path):
    """Leg B's table: the scale knobs (``WD_B_KNOBS``) through
    ``load_ps_config``, phase 12's shards and accessor, storage "ssd" (the
    pair a server launcher sets)."""
    import dataclasses

    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.config import load_ps_config
    from paddle_tpu_torch.ps.table import make_sparse_table

    job = load_ps_config({"hyper_parameters": {"sparse_feature_dim": WD_DIM + 1},
                          "runner": {"sync_mode": "gpubox", "thread_num": WD_SHARDS},
                          "table_parameters": {"storage": "ssd", **WD_B_KNOBS}})
    cfg = dataclasses.replace(job.table, storage="ssd", ssd_path=path,
                              accessor_config=AccessorConfig(embedx_dim=WD_DIM,
                                                             embedx_threshold=0.0))
    for knob, value in WD_B_KNOBS.items():
        assert getattr(cfg, knob) == value, f"leg B: {knob} read as {getattr(cfg, knob)!r}"
    return make_sparse_table(cfg)


def wd_cold_tier_leg(dev, card, src, base, save_s):
    """Phase 12 leg B: the main leg's table ``src`` streamed to a raw file
    and loaded into a fresh fp32 table (digest equal) and into leg B's
    table; one day through ``CtrPassTrainer`` over leg B's table with a
    tail of new ids offered to admission. Checks: one B1 launch a step; the
    merge and B1 bitwise on one real push; rejects > 0 and 0 < admitted <
    the day's offered new keys, every new key of both passes with a row
    after the second flush, the table grown by exactly the admitted;
    0 < index bytes a row <= 16; a forced compaction drains with the digest
    unchanged and bg_compactions > 0; the probe fills the ssd_* families
    and the cold-tier rules evaluate over them. Returns the launches and
    B1's numbers for the kernels line."""
    from paddle_tpu_torch.obs import registry as obs_registry
    from paddle_tpu_torch.obs.slo import SloWatchdog, cold_tier_rules
    from paddle_tpu_torch.obs.timeseries import MetricRing, Sampler
    from paddle_tpu_torch.ps.ps_trainer import _slot_tagged_keys

    t_leg = time.perf_counter()
    raw = os.path.join(base, "wd.raw")
    t0 = time.perf_counter()
    n_rows = src.save_file(raw, fmt="raw")
    save_file_s = time.perf_counter() - t0
    assert n_rows == src.size(), f"leg B: save_file wrote {n_rows} of {src.size()} rows"
    t0 = time.perf_counter()
    want = src.digest()
    digest_s = [time.perf_counter() - t0]
    fresh, _ = wd_table(os.path.join(base, "fp32"), 0)
    tb = wd_cold_table(os.path.join(base, "cold"))
    try:
        t0 = time.perf_counter()
        n32 = fresh.load_file(raw, fmt="raw")
        load32_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = fresh.digest()
        digest_s.append(time.perf_counter() - t0)
        fresh.flush()
        disk32 = fresh.stats()["disk_bytes"]
        assert n32 == n_rows and got == want, \
            f"leg B: the fp32 reload holds {n32} rows, digest {got} != {want}"
        t0 = time.perf_counter()
        n16 = tb.load_file(raw, fmt="raw")
        load16_s = time.perf_counter() - t0
        tb.flush()
        disk16 = tb.stats()["disk_bytes"]
        assert n16 == n_rows == tb.size(), f"leg B: loaded {n16} of {n_rows} rows"
        log(f"widedeep leg B: {n_rows} rows: save_file raw {save_file_s:.2f} s "
            f"({os.path.getsize(raw)} B; the main leg's snapshot save of mode 2 {save_s:.2f} s), "
            f"load_file into fp32 {load32_s:.2f} s (disk {disk32} B, digest equal), into fp16 "
            f"+ block-compressed {load16_s:.2f} s (disk {disk16} B, "
            f"{disk16 / max(disk32, 1):.3f} of fp32); digests of the source and the fp32 "
            f"reload {digest_s[0]:.2f} s, {digest_s[1]:.2f} s (host)")
        t0 = time.perf_counter()

        passes = wd_days(WD_B_PASSES, WD_RECORDS // WD_B_PASSES, WD_POOL, tail=WD_B_TAIL,
                         seed=2000)
        tr = wd_trainer(dev, tb, wd_weights())
        per_pass = [np.unique(np.concatenate([
            _slot_tagged_keys(b, tr.sparse_slots).reshape(-1)
            for b in ds.batch_iter(1 << 16, drop_last=False)])) for ds in passes]
        keys = np.unique(np.concatenate(per_pass))
        new = keys[~tb.export_full(keys)[1]]  # the day's keys the table lacks
        offered = len(new)
        # the new keys of every pass: the second pass's observation admits
        # each of them, whatever the sketch's salt (it never counts low)
        every = new[np.all([np.isin(new, k) for k in per_pass], axis=0)]
        size0, st0 = tb.size(), tb.stats()
        day_s = time.perf_counter() - t0
        push, restore = capture_first_push()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        try:
            results = tr.train_passes(passes, batch_size=WD_BATCH, drop_last=False)
        finally:
            restore()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = read_launches()
        steps = sum(int(r["steps"]) for r in results)
        losses = [r["loss"] for r in results]
        assert np.isfinite(losses).all(), f"leg B: losses {losses}"
        assert steps == WD_B_PASSES * -(-(WD_RECORDS // WD_B_PASSES) // WD_BATCH), steps
        assert counts["ctr_sparse_rows"] == steps == counts["merge_sparse_grads"], \
            f"leg B: launches {counts} != {steps} steps"
        wd_merge_check(push)
        b1 = wd_b1_check(push, what="cold-tier push")
        del push
        st = tb.stats()
        admitted = st["admit_admitted"] - st0["admit_admitted"]
        rejects = st["admit_rejects"] - st0["admit_rejects"]
        log(f"widedeep leg B: {len(passes)} passes, {steps} steps in {train_s:.3f} s, losses "
            f"{losses}, launches {counts}; {len(keys)} keys in the day, {offered} new: "
            f"admission checks {st['admit_checks'] - st0['admit_checks']}, rejects {rejects}, "
            f"admitted {admitted} (offered / admitted {offered / max(admitted, 1):.2f}); "
            f"size {size0} -> {tb.size()}; the day's data and its new keys {day_s:.2f} s (host) "
            f"on {card}")
        held = int(tb.export_full(every)[1].sum())
        log(f"widedeep leg B: {len(every)} new keys in both passes, {held} of them with a row")
        assert rejects > 0 and 0 < admitted < offered, f"leg B: admission {st}"
        assert len(every) > 0 and held == len(every), \
            f"leg B: {held} of the {len(every)} new keys of both passes admitted"
        assert tb.size() == size0 + admitted, f"leg B: grew {tb.size() - size0}, admitted {admitted}"

        tb.spill(0)  # the day's trained rows back to disk: the old copies become garbage
        t0 = time.perf_counter()
        before = tb.digest()
        digest_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        tb.compact_async()
        while True:
            st = tb.stats()
            if st["bg_backlog"] == 0 and st["bg_compactions"] > 0:
                break
            assert time.perf_counter() - t0 < WD_B_DRAIN_S, f"leg B: no drain {st}"
            time.sleep(0.05)
        drain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        after = tb.digest()
        digest_s.append(time.perf_counter() - t0)
        per_row = st["index_bytes_per_row"]
        log(f"widedeep leg B: compact_async drained in {drain_s:.2f} s: bg_compactions "
            f"{st['bg_compactions']}, io_bg_bytes {st['io_bg_bytes']}, io_bg_wait_ms "
            f"{st['io_bg_wait_ms']}, disk {st['disk_bytes']} B, digest unchanged "
            f"{after == before} (digests {digest_s[2]:.2f} s, {digest_s[3]:.2f} s); index "
            f"{per_row:.3f} B a row ({st['cold_rows']} cold rows), sketch {st['sketch_bytes']} B "
            f"(host)")
        assert after == before, "leg B: the forced compaction moved the digest"
        assert 0 < per_row <= 16.0, f"leg B: index bytes a row {per_row}"

        ring, t_obs = MetricRing(), time.time()
        sampler = Sampler(ring=ring).add_probe(tb.obs_probe)
        for i in range(4):
            sampler.tick(t=t_obs + i)
        dog = SloWatchdog(ring, cold_tier_rules())
        alerts = dog.evaluate(now=t_obs + 3)
        fams = obs_registry.REGISTRY.snapshot()["metrics"]
        missing = [f"ssd_{n}" for n in tb._OBS_COUNTERS + tb._OBS_GAUGES
                   if f"ssd_{n}" not in fams]
        assert sampler.errors == 0 and not missing, (sampler.last_error, missing)
        log(f"widedeep leg B: obs_probe filled {len(tb._OBS_COUNTERS + tb._OBS_GAUGES)} ssd_* "
            f"families; cold_tier_rules over 4 ticks: alerts {[a.rule for a in alerts]}; leg "
            f"{time.perf_counter() - t_leg:.1f} s on {card}")
    finally:
        fresh.close()
        tb.close()
    return {"launches": counts["ctr_sparse_rows"], "b1": b1}


def wd_small_run(device, weights, path):
    """The small leg on ``device``: (per-day losses, params on the CPU, the
    pass keys' exported rows, the trainer)."""
    from paddle_tpu_torch.ps.ps_trainer import _slot_tagged_keys

    small = WD_SMALL
    table, _ = wd_table(path, small["pop"])
    tr = wd_trainer(device, table, weights)
    days = wd_days(small["days"], small["records"], small["pool"])
    res = tr.train_passes(days, batch_size=small["batch"], drop_last=False)
    keys = np.unique(np.concatenate([
        _slot_tagged_keys(b, tr.sparse_slots).reshape(-1)
        for ds in days for b in ds.batch_iter(8192, drop_last=False)]))
    rows, found = table.export_full(keys)
    assert found.all()
    return np.asarray([r["loss"] for r in res]), \
        {k: v.cpu().numpy() for k, v in tr.params.items()}, rows, tr


def wd_parity(dev, base):
    """Card vs CPU at the small size (bounds ``WD_PARITY``), then ``save`` →
    a fresh trainer on a fresh table → ``load`` on the card: the dense
    params bit for bit, and the table digest of the saved rows as the text
    format renders them."""
    from paddle_tpu_torch.ps.table import row_digest

    weights = wd_weights()
    gl, gp, grows, gtr = wd_small_run(dev, weights, os.path.join(base, "card"))
    try:
        cl, cp, crows, ctr = wd_small_run(torch.device("cpu"), weights, os.path.join(base, "cpu"))
        ctr.table.close()
        def need_rtol(got, want):  # the least rtol that passes at the bound's atol
            with np.errstate(divide="ignore", invalid="ignore"):
                return max(0.0, float(np.nanmax((np.abs(got - want) - WD_PARITY["atol"])
                                                / np.abs(want))))

        loss_gap = float(np.abs(gl / cl - 1).max())
        param_gap = max(need_rtol(gp[k], cp[k]) for k in cp)
        row_gap = need_rtol(grows, crows)
        log(f"widedeep parity: card vs CPU, {WD_SMALL}: losses {gl.tolist()} vs {cl.tolist()} "
            f"(largest relative gap {loss_gap}); at atol {WD_PARITY['atol']} params need rtol "
            f"{param_gap}, the pass keys' rows ({len(crows)}) rtol {row_gap} (bounds "
            f"{WD_PARITY})")
        np.testing.assert_allclose(gl, cl, rtol=WD_PARITY["loss_rtol"])
        for k in cp:
            np.testing.assert_allclose(gp[k], cp[k], rtol=WD_PARITY["rtol"],
                                       atol=WD_PARITY["atol"], err_msg=k)
        np.testing.assert_allclose(grows, crows, rtol=WD_PARITY["rtol"], atol=WD_PARITY["atol"])

        gtr.save(os.path.join(base, "saved"))
        keys, rows = gtr.table.snapshot_items(0)
        acc = gtr.table.accessor
        text = np.stack([acc.parse_row(acc.format_row(k, r).split(), rows.shape[1])[1]
                         for k, r in zip(keys, rows)])
        fresh_table, _ = wd_table(os.path.join(base, "fresh"), 0)
        try:
            fresh = wd_trainer(dev, fresh_table, wd_weights())
            fresh.load(os.path.join(base, "saved"))
            same = all(torch.equal(fresh.params[k], gtr.params[k]) for k in gtr.params)
            same_opt = all(torch.equal(fresh.opt_state[s][k], gtr.opt_state[s][k])
                           for s in ("m", "v") for k in gtr.params)
            want, got = row_digest(keys, text), fresh_table.digest()
            log(f"widedeep save/load on the card: dense params bit for bit {same}, Adam state "
                f"{same_opt}, step {int(fresh.opt_state['step'])}; table digest {got} == "
                f"{want} (the {len(keys)} saved rows as text renders them): {got == want}")
            assert same and same_opt and got == want, "widedeep: save/load round trip differs"
            assert int(fresh.opt_state["step"]) == int(gtr.opt_state["step"])
        finally:
            fresh_table.close()
    finally:
        gtr.table.close()


def wd_kernel_counts(dev):
    """Device kernels of one Wide&Deep training step (the packed step the
    trainer runs, at phase 12's widths and batch, on a one-batch pass over
    a RAM table), counted by torch.profiler: taken last, with the other
    profiler windows."""
    from paddle_tpu_torch.models.ctr import pack_ctr_batch
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.ps_trainer import _pad_tail
    from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

    table = MemorySparseTable(TableConfig(shard_num=WD_SHARDS, accessor_config=AccessorConfig(
        embedx_dim=WD_DIM, embedx_threshold=0.0)))
    try:
        tr = wd_trainer(dev, table, wd_weights())
        ds = wd_days(1, WD_BATCH, WD_POOL)[0]
        tr.cache.begin_pass(tr._tagged_pass_keys(ds))
        lo32, dense, labels, weights = _pad_tail(*tr._pack(next(ds.batch_iter(WD_BATCH))),
                                                 WD_BATCH)
        packed = torch.from_numpy(pack_ctr_batch(lo32, dense, labels, weights=weights)).to(dev)
        step = tr._packed_step(WD_BATCH)

        def run():
            tr.params, tr.opt_state, tr.cache.state, _ = step(
                tr.params, tr.opt_state, tr.cache.state, tr.cache.device_map.state, packed)

        k, m, names = device_kernels(run)
        log(f"widedeep step: {k} device kernels (+{m} memsets) a step (batch {WD_BATCH}); "
            f"the port's: {[x for x in names if 'ctr_rows' in x or 'radix' in x or 'segment' in x]}")
    finally:
        table.close()


# -- phase 13: the the_one_ps rung ---------------------------------------------

# BASELINE.md config 3 in the_one_ps mode, as tools/sparse_hot_bench.py runs
# it: two in-process NativePsServers on 127.0.0.1 behind an RpcPsClient, a
# HalfAsyncCommunicator (pull-ahead 1) and CtrStreamTrainer, RPC-only and
# over the hot tier, at the hot path's width and on its data (phase 4): a
# 16-shard CTR table, DeepFM 26 slots x dim 8, DNN 400^3, batch 4096, two
# epochs of 8 batches.
RPC_SERVERS, RPC_TABLE_SHARDS = 2, 16


def rpc_cluster(shard_num=RPC_TABLE_SHARDS, acc=None):
    """Fresh servers and a client with sparse table 0 on them: (servers,
    client). ``acc`` defaults to the hot path's accessor."""
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.rpc import NativePsServer, RpcPsClient
    from paddle_tpu_torch.ps.table import TableConfig

    servers = [NativePsServer(n_trainers=1) for _ in range(RPC_SERVERS)]
    client = None
    try:
        client = RpcPsClient([f"127.0.0.1:{s.port}" for s in servers])
        client.create_sparse_table(0, TableConfig(
            table_id=0, shard_num=shard_num,
            accessor_config=acc or AccessorConfig(embedx_dim=DIM, embedx_threshold=0.0)))
    except BaseException:
        close_cluster(servers, client)
        raise
    return servers, client


def close_cluster(servers, client):
    """The client first: a connection to a stopped server waits out its
    deadline."""
    if client is not None:
        client.close()
    for s in servers:
        s.close()


def capture_hot_step():
    """Wrap ``hot_probe_gather`` and ``hot_scatter_apply`` as the hot step
    calls them: once armed (``got["armed"] = True``), the next call of each
    keeps a copy of its inputs (the tier state before the push). Returns
    the dict that fills ("b2", "b4") and the function that restores both."""
    from paddle_tpu_torch.ps import hot_tier as ht

    b2, b4, got = ht.hot_probe_gather, ht.hot_scatter_apply, {"armed": False}
    clone = lambda d: {k: v.clone() for k, v in d.items()}

    def probe(map_state, hi, lo, tier_state, **kw):
        if got["armed"] and "b2" not in got:
            got["b2"] = (clone(map_state), hi.clone(), lo.clone(), clone(tier_state), kw)
        return b2(map_state, hi, lo, tier_state, **kw)

    def push(state, rows, grads, shows, clicks, cfg):
        if got["armed"] and "b4" not in got:
            got["b4"] = (clone(state), rows.clone(), grads.clone(), shows.clone(),
                         clicks.clone(), cfg)
        return b4(state, rows, grads, shows, clicks, cfg)

    ht.hot_probe_gather, ht.hot_scatter_apply = probe, push

    def restore():
        ht.hot_probe_gather, ht.hot_scatter_apply = b2, b4
    return got, restore


def dataset_keys(ds):
    """Every distinct slot-tagged feasign of ``ds``."""
    from paddle_tpu_torch.ps.ps_trainer import _slot_tagged_keys

    names = slot_names(SLOTS, DENSE)["sparse_slots"]
    return np.unique(np.concatenate([_slot_tagged_keys(b, names).reshape(-1)
                                     for b in ds.batch_iter(8192, drop_last=False)]))


def phase_rpc_leg(dev, card, ds, hot):
    """One leg of the rung on fresh servers: ``CtrStreamTrainer(
    communicator=HalfAsyncCommunicator(client), table_id=0)``, RPC-only
    (every batch pulls and pushes its 106,496 keys over the wire) or over
    ``HotTierConfig(capacity=2^19)`` (the cold epoch fills the tier through
    ``RemoteSparseTable.export_full(create=True)`` on the pull workers; one
    B2 and one B4 a step). Checks losses finite and falling, the launches,
    and after the flush the servers' rows = the data's distinct keys (and,
    over the tier, its occupancy); over the tier, a warm epoch with no miss,
    no cold fetch and no table RPC. Returns (launch counts, warm samples/s,
    the captured batch or None)."""
    import threading

    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.communicator import HalfAsyncCommunicator
    from paddle_tpu_torch.ps.hot_tier import HotTierConfig
    from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer

    name = "the_one_ps, hot tier" if hot else "the_one_ps, RPC-only"
    servers, client = rpc_cluster()
    comm = HalfAsyncCommunicator(client)
    got, restore = capture_hot_step() if hot else ({}, lambda: None)
    try:
        comm.start()
        model = DeepFM(CtrConfig(SLOTS, DENSE, DIM, (400, 400, 400)),
                       generator=torch.Generator().manual_seed(0))
        trainer = CtrStreamTrainer(model, Adam(learning_rate=1e-3), None, communicator=comm,
                                   table_id=0, embedx_dim=DIM,
                                   hot_tier=HotTierConfig(capacity=HOT_CAP) if hot else None,
                                   device=dev, **slot_names(SLOTS, DENSE))
        assert trainer.pull_ahead == 1, trainer.pull_ahead
        keys = ("ensure", "device_state", "step") if hot else ("wire pull", "wire push",
                                                                "step")
        host_s, mu = dict.fromkeys(keys, 0.0), threading.Lock()

        def timed(key, fn):
            def wrapped(*a, **k):
                t = time.perf_counter()
                out = fn(*a, **k)
                with mu:  # the wire calls run on the pull workers and the push thread
                    host_s[key] += time.perf_counter() - t
                return out
            return wrapped

        tier = trainer.hot_tier
        if hot:
            tier.ensure = timed("ensure", tier.ensure)
            tier.device_map.device_state = timed("device_state", tier.device_map.device_state)
            trainer._hot_step = timed("step", trainer._hot_step)
        else:
            client.pull_sparse = timed("wire pull", client.pull_sparse)
            client.push_sparse = timed("wire push", client.push_sparse)
            trainer._step = timed("step", trainer._step)

        torch.cuda.synchronize()
        reset_launches()
        results = []
        for epoch in range(HOT_EPOCHS):
            before = dict(tier.stats()) if hot else {}
            for k in host_s:
                host_s[k] = 0.0
            client.reset_op_counts()
            got["armed"] = epoch == HOT_EPOCHS - 1  # one batch of the warm epoch
            t0 = time.perf_counter()
            r = trainer.train_from_dataset(ds, batch_size=BATCH)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ops = client.reset_op_counts()
            steps = int(r["steps"])
            delta = {k: r["hot_tier"][k] - before[k] for k in (
                "hits", "misses", "cold_fetches", "evictions", "writebacks")} if hot else {}
            log(f"{name} epoch {epoch}: {steps} steps, mean loss {r['loss']:.6f}, "
                f"{steps * BATCH / wall:.1f} samples/s ({1e3 * wall / steps:.3f} ms/step, "
                f"the closing barrier included); host ms/step: "
                + ", ".join(f"{k} {1e3 * v / steps:.3f}" for k, v in host_s.items())
                + f"; client ops/step {({k: v / steps for k, v in sorted(ops.items())})}"
                + (f"; tier {delta}, occupancy {r['hot_tier']['occupancy']}" if hot else "")
                + f" on {card}")
            results.append((r, delta, ops, wall))
        counts = read_launches()
        steps = sum(int(r["steps"]) for r, *_ in results)
        log(f"{name}: {steps} steps, launches {counts}")
        (first, _, ops0, _), (warm, warm_delta, warm_ops, warm_wall) = results
        assert all(np.isfinite(r["loss"]) for r, *_ in results), f"{name}: non-finite loss"
        assert warm["loss"] < first["loss"], f"{name}: warm epoch loss did not fall"
        if hot:
            assert counts["hot_probe_gather"] == steps and counts["hot_scatter_apply"] == steps, \
                f"{name}: B2/B4 launches {counts} != {steps} steps"
            assert warm_delta["misses"] == 0 and warm_delta["cold_fetches"] == 0, \
                f"{name}: warm epoch left the tier: {warm_delta}"
            assert warm_ops == {}, f"{name}: warm epoch made table RPCs: {warm_ops}"
            assert ops0.get("export_full", 0) > 0, f"{name}: cold epoch fetched nothing {ops0}"
        else:
            assert sum(counts.values()) == 0, f"{name}: a table kernel launched: {counts}"
            n_b = int(first["steps"])
            assert ops0["pull_sparse"] == n_b and 1 <= ops0["push_sparse"] <= n_b, ops0
        warm_sps = float(warm["samples"]) / warm_wall

        want = len(dataset_keys(ds))
        n_flushed = tier.flush() if hot else 0
        comm.barrier()
        size = client.size(0)
        occupancy = tier.stats()["occupancy"] if hot else want
        log(f"{name}: flush wrote {n_flushed} rows back; the servers hold {size} rows, the "
            f"data has {want} distinct keys" + (f", the tier {occupancy}" if hot else ""))
        assert size == want == occupancy, f"{name}: rows {size}, keys {want}, tier {occupancy}"
        log(f"{name}: warm epoch {warm_sps:.1f} samples/s on {card}")
        comm.stop()
        return counts, warm_sps, (got if hot else None)
    finally:
        restore()
        close_cluster(servers, client)


def rpc_b2_check(b2, what="the_one_ps batch"):
    """B2 on the captured batch, bitwise against its plain version, then
    timed beside it and its byte bound."""
    from paddle_tpu_torch.ops.hot_kernels import hot_probe_gather, hot_probe_gather_plain

    ms, th, tl, tier, kw = b2
    got = hot_probe_gather(ms, th, tl, tier, **kw)
    torch.cuda.synchronize()
    want = hot_probe_gather_plain(ms, th, tl, tier, **kw)
    ok = all(bitwise_equal(g, w) for g, w in zip(got, want))
    err = max_abs(got[1], want[1])
    n, found = int(th.numel()), int((got[0] >= 0).sum())
    if not ok:
        raise AssertionError(f"B2 disagrees with plain on the {what} (max_abs {err})")
    nbytes, buckets = probe_gather_bytes(ms, th, tl, found, kw["banks"])
    ms_k, call_k = time_cuda(lambda: hot_probe_gather(ms, th, tl, tier, **kw))
    ms_p, call_p = time_cuda(lambda: hot_probe_gather_plain(ms, th, tl, tier, **kw))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"kernel hot_probe_gather, {what}: n={n} found={found} bitwise={ok} "
        f"max_abs={err}; device {ms_k} ms, plain {ms_p} ms, bound {bound} ms (bytes: {nbytes} "
        f"B, {buckets} buckets probed); per call from an idle card {call_k} ms, plain "
        f"{call_p} ms")
    return {"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound,
            "bound_by": "bytes"}


def rpc_b4_check(b4, what="the_one_ps batch"):
    """B4 on the captured batch, bitwise against its plain version on the
    CPU copy, then timed beside the plain version on the card and the
    bound."""
    from paddle_tpu_torch.ops import hot_kernels as hk

    state, rows, grads, shows, clicks, cfg = b4
    got = hk.hot_scatter_apply({k: v.clone() for k, v in state.items()}, rows, grads, shows,
                               clicks, cfg)
    torch.cuda.synchronize()
    want = hk.hot_scatter_apply({k: v.cpu() for k, v in state.items()}, rows.cpu(),
                                grads.cpu(), shows.cpu(), clicks.cpu(), cfg)
    ok = all(bitwise_equal(got[k].cpu(), want[k]) for k in COLUMNS)
    err = max(max_abs(got[k].cpu(), want[k]) for k in COLUMNS)
    if not ok:
        raise AssertionError(f"B4 disagrees with plain on the {what} (max_abs {err})")
    n, C = int(rows.numel()), int(state["embed_w"].shape[0])
    u = int(torch.unique(rows[(rows >= 0) & (rows < C)]).numel())
    nbytes, nops, bytes_ms, ops_ms = scatter_bound(n, u, cfg)
    work = {k: v.clone() for k, v in state.items()}
    ms_k, call_k = time_cuda(lambda: hk.hot_scatter_apply(work, rows, grads, shows, clicks,
                                                           cfg))
    ms_p, call_p = time_cuda(lambda: hk.hot_scatter_apply_plain(work, rows, grads, shows,
                                                                clicks, cfg))
    log(f"kernel hot_scatter_apply {cfg.embed_rule}/{cfg.embedx_rule}, {what}: n={n} "
        f"u={u}: bitwise={ok} max_abs={err}; device {ms_k} ms, plain {ms_p} ms, bound "
        f"{max(bytes_ms, ops_ms)} ms ({nbytes} B, {nops} f32 ops); per call from an idle card "
        f"{call_k} ms, plain {call_p} ms")
    return {"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def small_rpc_run(device, weights, lines, hot):
    """The small hot-tier harness (phase 5's: 3 slots, 400 ids a slot,
    capacity 224 for eviction churn, batch 64) through a SyncCommunicator
    over fresh servers (a 4-shard table, rows created with
    ``initial_range=0``), with the tier (``hot``) or RPC-only: (loss,
    params, opt state, sorted server rows, tier stats)."""
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.communicator import SyncCommunicator
    from paddle_tpu_torch.ps.hot_tier import HotTierConfig
    from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer
    from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig

    servers, client = rpc_cluster(4, AccessorConfig(sgd=SGDRuleConfig(initial_range=0.0)))
    try:
        comm = SyncCommunicator(client)
        comm.start()
        opt = Adam(1e-2)
        tr = CtrStreamTrainer(DeepFM(CtrConfig(3, 2, 8, (8,))), opt, None, communicator=comm,
                              table_id=0, embedx_dim=8,
                              hot_tier=HotTierConfig(capacity=224) if hot else None,
                              device=device, **slot_names(3, 2))
        tr.params = {k: v.to(device) for k, v in weights.items()}
        tr.opt_state = opt.init(tr.params)
        r = tr.train_from_dataset(ctr_dataset(lines, 3, 2), batch_size=64)
        if hot:
            tr.hot_tier.flush()
        comm.stop()
        keys, rows = client.snapshot_items(0)
        cpu = lambda d: {k: v.cpu() for k, v in d.items()}
        opt_state = {"step": tr.opt_state["step"].cpu(), "m": cpu(tr.opt_state["m"]),
                     "v": cpu(tr.opt_state["v"])}
        return r["loss"], cpu(tr.params), opt_state, rows[np.argsort(keys)], r.get("hot_tier")
    finally:
        close_cluster(servers, client)


def phase_rpc_parity(dev):
    """Tier over RPC ≡ RPC-only over RPC, bitwise on the card (JAX's
    contract, tests/test_hot_tier.py), and card vs CPU within phase 5's
    bounds."""
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM

    lines = ctr_lines(np.random.default_rng(0), 256, 400, 3, 2)
    weights = {k: v.detach() for k, v in
               DeepFM(CtrConfig(3, 2, 8, (8,)),
                      generator=torch.Generator().manual_seed(2)).named_parameters()}
    reset_launches()
    tier = small_rpc_run(dev, weights, lines, hot=True)
    counts = read_launches()
    assert counts["hot_probe_gather"] == 4 and counts["hot_scatter_apply"] == 4, counts
    assert tier[4]["evictions"] > 0 and tier[4]["writebacks"] > 0, "no eviction churn"
    assert_hot_runs_bitwise(tier, small_rpc_run(dev, weights, lines, hot=False),
                            "card, tier over RPC (capacity 224) vs RPC-only over RPC")
    assert_card_close_to_cpu(tier, small_rpc_run(torch.device("cpu"), weights, lines, True),
                             "the_one_ps parity")


def phase_rpc(dev, card, ds):
    """Phase 13: the RPC-only leg, the tier leg (B2 and B4 on one of its
    real batches), the small card parity. Returns (the tier leg's launch
    counts, B2's numbers, B4's numbers)."""
    t0 = time.perf_counter()
    phase_rpc_leg(dev, card, ds, hot=False)
    counts, _, got = phase_rpc_leg(dev, card, ds, hot=True)
    b2, b4 = rpc_b2_check(got["b2"]), rpc_b4_check(got["b4"])
    del got
    phase_rpc_parity(dev)
    log(f"the_one_ps rung (phase 13): {time.perf_counter() - t0:.1f} s")
    return counts, b2, b4


# -- phase 14: the PaddleRec job ------------------------------------------------

# BASELINE.md config 3 as a PaddleRec job runs it: `distributed.launch`
# starts PS server and trainer processes of this very script
# (``--ps-job CONFIG.json``), ``fleet`` wires them from the role env,
# ``ps/config.py`` turns the job's config dict into the model, optimizer,
# table and strategy, and the data comes from MultiSlot part files through
# the native feed. Phase 4's generator and width (26 slots of 10,000 ids,
# 13 dense, DeepFM dim 8, DNN 400^3, batch 4096); 65,536 lines in 8 files
# (cut from 131,072 for the script's time limit). The async leg trains one
# epoch (8 steps a trainer): its losses are checked step by step.
PSJOB_LINES, PSJOB_FILES, PSJOB_SERVERS, PSJOB_EPOCHS = 65_536, 8, 2, 1
PSJOB_BATCH = BATCH
PSJOB_TIMEOUT = 300          # seconds a leg's processes may take
PSJOB_BALANCE = 0.02         # a trainer's share after the shuffle: half, within 2 %
PSJOB_SCRIPT = os.path.abspath(__file__)  # what the job's processes run
_READING = "PS_JOB_READING "


def ps_job_config(mode, seed=14):
    """The job's config in PaddleRec's ``hyper_parameters``/``runner``
    schema, with ``mode`` its ``runner.sync_mode`` and the model's weight
    seed drawn from a numpy generator."""
    return {"hyper_parameters": {"optimizer": {"class": "Adam", "learning_rate": 1e-3},
                                 "sparse_inputs_slots": SLOTS + 1,
                                 "sparse_feature_number": HOT_IDS,
                                 "sparse_feature_dim": DIM + 1, "dense_input_dim": DENSE,
                                 "fc_sizes": [400, 400, 400]},
            "runner": {"sync_mode": mode, "thread_num": 16},
            "seed": int(np.random.default_rng(seed).integers(1 << 31))}


def ps_job_dataset(seed=0):
    from paddle_tpu_torch.data.dataset import InMemoryDataset, SlotDesc

    return InMemoryDataset([SlotDesc(f"s{i}") for i in range(SLOTS)]
                           + [SlotDesc(f"d{i}", is_float=True) for i in range(DENSE)]
                           + [SlotDesc("label", is_float=True)], seed=seed)


def record_digest(ds):
    """Order-free digest of every record of ``ds`` (one value a slot): the
    sum mod 2^64 of a per-record hash, so the digests of a partition add
    up to the whole's."""
    total = 0
    for batch in ds.batch_iter(1 << 16, drop_last=False):
        h = None
        for name in sorted(batch):
            v, lens = batch[name]
            col = v[:, 0].view(np.uint32).astype(np.uint64) if v.dtype == np.float32 else v[:, 0]
            h = np.zeros(len(lens), np.uint64) if h is None else h
            h = (h ^ col) * np.uint64(0x9E3779B97F4A7C15) + lens.astype(np.uint64)
            h ^= h >> np.uint64(29)
        total = (total + int(h.sum(dtype=np.uint64))) % (1 << 64)
    return total


def write_part_files(base):
    """Phase 4's MultiSlot lines, ``PSJOB_LINES`` of them, in
    ``PSJOB_FILES`` part files under ``base``; returns the paths."""
    lines = ctr_lines(np.random.default_rng(21), PSJOB_LINES, HOT_IDS, SLOTS, DENSE)
    per = PSJOB_LINES // PSJOB_FILES
    paths = []
    for f in range(PSJOB_FILES):
        path = os.path.join(base, f"part-{f:05d}")
        with open(path, "w") as fh:
            fh.write("\n".join(lines[f * per:(f + 1) * per]) + "\n")
        paths.append(path)
    return paths


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def ps_job_async(fleet, job, spec, dev):
    """Leg A's trainer: its file shard through the native feed (4 reader
    threads), the global shuffle through ``fleet.util``, ``CtrStreamTrainer``
    over ``fleet.communicator`` (RPC-only), then ``stop_worker`` and the
    closing barrier; trainer 0 then saves the tables and stops the servers."""
    from paddle_tpu_torch.models.ctr import DeepFM
    from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer

    rank = fleet.worker_index()
    ds = ps_job_dataset(seed=rank)
    ds.set_filelist(fleet.util.get_file_shard(spec["files"]))
    t0 = time.perf_counter()
    loaded = ds.load_into_memory(num_threads=4)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds.global_shuffle(util=fleet.util)
    shuffle_s = time.perf_counter() - t0
    model = DeepFM(job.make_model_config(), generator=torch.Generator().manual_seed(spec["seed"]))
    trainer = CtrStreamTrainer(model, job.make_optimizer(), None,
                               communicator=fleet.communicator, table_id=0,
                               embedx_dim=job.table.accessor_config.embedx_dim, device=dev,
                               **slot_names(SLOTS, DENSE))
    step_losses = []
    real_step = trainer._step

    def step(*a):
        out = real_step(*a)
        step_losses.append(out[2])
        return out

    trainer._step = step
    _sync(dev)
    reset_launches()
    epochs = []
    for _ in range(spec["epochs"]):
        fleet.client.reset_op_counts()
        t0 = time.perf_counter()
        # every record, the short tail batch too: the saved tables must
        # hold every key of the data
        r = trainer.train_from_dataset(ds, batch_size=spec["batch"], drop_last=False)
        _sync(dev)
        wall = time.perf_counter() - t0
        ops = fleet.client.reset_op_counts()
        steps = int(r["steps"])
        epochs.append({"loss": r["loss"], "steps": steps, "s": wall,
                       "samples_per_s": r["samples"] / wall,
                       "ops_per_step": {k: v / steps for k, v in sorted(ops.items())}})
    launches = read_launches()
    fleet.stop_worker()
    fleet.client.barrier()  # the closing barrier: every trainer's pushes have landed
    saved, save_s = None, None
    if rank == 0:
        t0 = time.perf_counter()
        saved = fleet.save_persistables(spec["save_dir"])
        save_s = time.perf_counter() - t0
        fleet.client.stop_servers()
    fleet.client.close()
    return {"rank": rank, "loaded": loaded, "records": ds.num_records,
            "digest": str(record_digest(ds)), "load_s": load_s, "shuffle_s": shuffle_s,
            "epochs": epochs, "launches": launches, "saved": saved, "save_s": save_s,
            "step_losses": [float(x) for x in step_losses]}


def ps_job_gpubox(fleet, job, spec, dev):
    """Leg B's trainer: every file through the native feed, one pass of
    ``CtrPassTrainer`` over ``RemoteSparseTable(fleet.client, 0, ...)``
    (the pass build's ``export_full`` and the flush's ``import_full`` cross
    the wire), per-step losses, B1 bitwise on the pass's first real push;
    then the servers' size and the stop."""
    from paddle_tpu_torch.models.ctr import DeepFM
    from paddle_tpu_torch.ps.embedding_cache import CacheConfig
    from paddle_tpu_torch.ps.ps_trainer import CtrPassTrainer
    from paddle_tpu_torch.ps.rpc import RemoteSparseTable

    ds = ps_job_dataset()
    ds.set_filelist(spec["files"])
    t0 = time.perf_counter()
    loaded = ds.load_into_memory(num_threads=4)
    load_s = time.perf_counter() - t0
    acc = job.table.accessor_config
    model = DeepFM(job.make_model_config(), generator=torch.Generator().manual_seed(spec["seed"]))
    tr = CtrPassTrainer(model, job.make_optimizer(), RemoteSparseTable(fleet.client, 0, job.table),
                        CacheConfig(capacity=spec["cache_capacity"], embedx_dim=acc.embedx_dim,
                                    embedx_threshold=acc.embedx_threshold),
                        device=dev, **slot_names(SLOTS, DENSE))
    spans = timed_cache(tr.cache)
    step, losses = tr._packed_step(spec["batch"]), []

    def recorded(*a):
        out = step(*a)
        losses.append(out[3])
        return out

    tr._packed_steps[(spec["batch"], 1)] = recorded
    push, restore = capture_first_push()
    _sync(dev)
    reset_launches()
    t0 = time.perf_counter()
    try:
        r = tr.train_from_dataset(ds, batch_size=spec["batch"])
    finally:
        restore()
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = read_launches()
    b1 = wd_b1_check(push, acc.embedx_dim, "gpubox push over RPC") if dev.type == "cuda" else None
    del push
    # the host's share of a step: 4 batches sliced and packed as the
    # prefetcher thread does, no step
    t0, n_b = time.perf_counter(), 0
    for batch in ds.batch_iter(spec["batch"]):
        tr._pack(batch)
        n_b += 1
        if n_b == 4:
            break
    slice_ms = 1e3 * (time.perf_counter() - t0) / n_b
    size = fleet.client.size(0)
    fleet.stop_worker()
    fleet.client.barrier()
    fleet.client.stop_servers()
    fleet.client.close()
    return {"rank": 0, "loaded": loaded, "load_s": load_s, "steps": int(r["steps"]),
            "loss": r["loss"], "losses": [float(x) for x in losses], "s": wall,
            "samples_per_s": r["samples"] / wall, "build_s": spans["activate"][0],
            "prepare_s": spans["prepare"][0], "flush_s": spans["flush"][0],
            "launches": launches, "size": size, "keys": len(dataset_keys(ds)), "b1": b1,
            "slice_ms": slice_ms}


def ps_job_child(path):
    """``--ps-job CONFIG.json``: one process of the job. A PSERVER serves
    until a trainer stops it; a TRAINER runs its leg and prints one
    ``PS_JOB_READING {json}`` line."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ps.config import load_ps_config

    with open(path) as f:
        spec = json.load(f)
    job = load_ps_config(spec["ps"])
    fleet.init(strategy=job.strategy)
    if fleet.is_server():
        fleet.init_server()
        fleet.run_server()
        fleet.stop_server()
        return 0
    dev = torch.device(spec["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    fleet.init_worker()
    fleet.register_sparse_table(0, job.table)
    leg = {"async": ps_job_async, "gpubox": ps_job_gpubox}[job.sync_mode]
    print(_READING + json.dumps(leg(fleet, job, spec, dev)), flush=True)
    return 0


def _port_free(port):
    import socket

    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", port))
            return True
        except OSError:
            return False


def ps_job_ports(nproc, servers):
    """(launcher base port P, store port): P+1..P+nproc (the trainers'
    names) and P+100..P+100+servers-1 (the servers) free, and a free store
    port outside both."""
    rng = np.random.default_rng()
    for _ in range(500):
        p = int(rng.integers(20000, 50000))
        ports = [p + 1 + i for i in range(nproc)] + [p + 100 + i for i in range(servers)]
        if all(_port_free(q) for q in ports + [p + 200]):
            return p, p + 200
    raise RuntimeError("no free port range for the job")


def ps_job_launch(base, mode, files, nproc, dev):
    """Launch one leg's 2 servers and ``nproc`` trainers through
    ``launch_local``; returns (the trainers' readings, seconds, spec).
    A non-zero exit, a timeout or a missing reading fails the leg with
    every process's log tail."""
    import subprocess

    from paddle_tpu_torch.distributed.launch import JobSpec, launch_local

    spec = {"ps": ps_job_config(mode), "files": files, "device": dev.type,
            "batch": PSJOB_BATCH, "epochs": PSJOB_EPOCHS, "cache_capacity": CAPACITY,
            "save_dir": os.path.join(base, f"saved_{mode}")}
    spec["seed"] = spec["ps"]["seed"]
    path = os.path.join(base, f"job_{mode}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    log_dir = os.path.join(base, f"logs_{mode}")
    port, store_port = ps_job_ports(nproc, PSJOB_SERVERS)
    t0 = time.perf_counter()
    try:
        rc = launch_local(JobSpec([PSJOB_SCRIPT, "--ps-job", path], nproc=nproc,
                                  servers=PSJOB_SERVERS, coordinator_port=port, log_dir=log_dir,
                                  env={"PADDLE_UTIL_STORE_PORT": str(store_port)}),
                          timeout=PSJOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        rc = f"timeout after {PSJOB_TIMEOUT} s"
    wall = time.perf_counter() - t0
    readings = []
    for r in range(nproc):
        log_path = os.path.join(log_dir, f"trainer_{r}.log")
        lines = open(log_path).read().splitlines() if os.path.exists(log_path) else []
        got = [json.loads(l[len(_READING):]) for l in lines if l.startswith(_READING)]
        readings += got[-1:]
    if rc != 0 or len(readings) != nproc:
        for name in sorted(os.listdir(log_dir)) if os.path.isdir(log_dir) else []:
            with open(os.path.join(log_dir, name)) as f:
                log(f"--- {name} (tail) ---\n{f.read()[-4000:]}")
        raise AssertionError(f"PaddleRec job, {mode}: launcher rc {rc}, {len(readings)} of "
                             f"{nproc} readings")
    return readings, wall, spec


def ps_job_leg_async(dev, card, base, files, whole):
    """Leg A: 2 servers + 2 trainers, ``sync_mode: async``. Checks the
    shuffle conserved the records (counts, each within 2 % of half, the
    order-free digest), the losses, no table kernel, and that the saved
    tables hold the data's distinct keys, also once loaded into a fresh
    local-transport ``Fleet``."""
    from paddle_tpu_torch.distributed import DistributedStrategy, Fleet, UserDefinedRoleMaker
    from paddle_tpu_torch.ps.config import load_ps_config

    readings, wall, spec = ps_job_launch(base, "async", files, 2, dev)
    for r in readings:
        e = r["epochs"]
        log(f"PaddleRec job, async, trainer {r['rank']}: {r['loaded']} records loaded in "
            f"{r['load_s']:.3f} s (4 reader threads), global shuffle {r['shuffle_s']:.3f} s "
            f"(-> {r['records']} records), epochs "
            + "; ".join(f"{x['steps']} steps {x['s']:.3f} s, loss {x['loss']:.6f}, "
                        f"{x['samples_per_s']:.1f} samples/s, client ops/step {x['ops_per_step']}"
                        for x in e)
            + f"; launches {r['launches']}" + (f"; save {r['save_s']:.3f} s" if r["saved"] else "")
            + f" on {card}")
    n, keys = whole.num_records, dataset_keys(whole)
    counts = [r["records"] for r in readings]
    assert sum(counts) == n and sum(r["loaded"] for r in readings) == n, (counts, n)
    assert all(abs(c - n / 2) <= PSJOB_BALANCE * n / 2 for c in counts), \
        f"unbalanced shuffle {counts}"
    digest = sum(int(r["digest"]) for r in readings) % (1 << 64)
    assert digest == record_digest(whole), "the shuffled records differ from the files'"
    for r in readings:
        ha_check_losses(np.asarray(r["step_losses"]), f"PaddleRec job, trainer {r['rank']}")
        assert sum(r["launches"].values()) == 0, f"a table kernel launched: {r['launches']}"
    saved = readings[0]["saved"]
    assert saved == {"0": len(keys)}, f"saved {saved}, the data has {len(keys)} distinct keys"
    job = load_ps_config(spec["ps"])
    local = Fleet().init(UserDefinedRoleMaker(), strategy=DistributedStrategy(ps_transport="local"))
    local.register_sparse_table(0, job.table)
    t0 = time.perf_counter()
    loaded = local.load_model(os.path.join(spec["save_dir"]))
    _, found = local.client._sparse(0).export_full(keys)
    size = local.client._sparse(0).size()
    local.client.server.close()
    assert loaded == {0: len(keys)} and size == len(keys) and found.all(), (loaded, size)
    log(f"PaddleRec job, async: {n} records over 2 trainers {counts}, digest equal; saved "
        f"{saved['0']} rows = the data's distinct keys; a local Fleet loads them in "
        f"{time.perf_counter() - t0:.3f} s; leg {wall:.1f} s (4 processes)")


def ps_job_leg_gpubox(dev, card, base, files, whole):
    """Leg B: 2 servers + 1 trainer, ``sync_mode: gpubox``: one B1 launch a
    step, B1 bitwise on a real push, losses falling over the pass, the
    servers' rows = the data's distinct keys. Returns the trainer's reading."""
    (r,), wall, _ = ps_job_launch(base, "gpubox", files, 1, dev)
    steps, b1 = r["steps"], r["b1"]
    log(f"PaddleRec job, gpubox: {r['loaded']} records loaded in {r['load_s']:.3f} s, one pass "
        f"of {steps} steps in {r['s']:.3f} s ({r['samples_per_s']:.1f} samples/s, the build and "
        f"flush included), mean loss {r['loss']:.6f}; pass prepare {r['prepare_s']:.3f} s "
        f"(host), build {r['build_s']:.3f} s (remote export_full), flush {r['flush_s']:.3f} s "
        f"(remote import_full); a batch sliced and packed on the host {r['slice_ms']:.3f} ms "
        f"(one thread, no step); launches {r['launches']}; servers hold {r['size']} rows, the data "
        f"{r['keys']} keys; leg {wall:.1f} s (3 processes) on {card}")
    if b1 is not None:
        log(f"kernel ctr_sparse_rows_at, gpubox push over RPC (in the trainer process): "
            f"bitwise, max_abs {b1['max_abs_err']}; device {b1['ms']} ms, plain "
            f"{b1['plain_ms']} ms, bound {b1['bound_ms']} ms ({b1['bound_by']}) on {card}")
    want = whole.num_records // PSJOB_BATCH
    assert steps == want, f"{steps} steps, want {want}"
    losses = r["losses"]
    assert len(losses) == steps and np.isfinite(losses).all(), losses
    assert np.mean(losses[-8:]) < np.mean(losses[:8]), f"losses did not fall {losses}"
    if dev.type == "cuda":
        assert r["launches"]["ctr_sparse_rows"] == steps, \
            f"B1 launches {r['launches']['ctr_sparse_rows']} != {steps} steps"
        assert b1 is not None
    assert r["size"] == r["keys"] == len(dataset_keys(whole)), (r["size"], r["keys"])
    return r


def ps_job_leg_dense(dev, card, files):
    """Leg C: ``Trainer.train_from_dataset`` over a ``QueueDataset`` of the
    files, the reference test's 2-layer MLP over the 13 dense slots, 1
    epoch on ``dev``."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.data.dataset import QueueDataset, SlotDesc
    from paddle_tpu_torch.executor import Trainer
    from paddle_tpu_torch.optimizer import Adam

    class MLP(torch.nn.Module):
        def __init__(self):
            super().__init__()
            g = torch.Generator().manual_seed(3)
            self.l1 = nn.Linear(DENSE, 16, generator=g)
            self.l2 = nn.Linear(16, 1, generator=g)

        def forward(self, x):
            return self.l2(nn.functional.relu(self.l1(x)))[..., 0]

    def feed(batch):
        dense = np.concatenate([batch[f"d{i}"][0] for i in range(DENSE)], axis=1)
        return dense.astype(np.float32), batch["label"][0][:, 0].astype(np.float32)

    ds = QueueDataset([SlotDesc(f"s{i}") for i in range(SLOTS)]
                      + [SlotDesc(f"d{i}", is_float=True) for i in range(DENSE)]
                      + [SlotDesc("label", is_float=True)])
    ds.set_filelist(files)
    tr = Trainer(MLP(), Adam(1e-2), nn.functional.binary_cross_entropy_with_logits, device=dev)
    seen = []
    train_step = tr.train_step

    def step(inputs, labels):
        loss = train_step(inputs, labels)
        seen[:] = [loss]
        return loss

    tr.train_step = step
    t0 = time.perf_counter()
    (loss,) = tr.train_from_dataset(ds, feed, batch_size=PSJOB_BATCH, epochs=1)
    _sync(dev)
    wall = time.perf_counter() - t0
    log(f"PaddleRec job, dense executor: {tr.global_step} steps over a QueueDataset, epoch "
        f"loss {loss:.6f}, {tr.global_step * PSJOB_BATCH / wall:.1f} samples/s ({wall:.3f} s, "
        f"parsing included) on {card}")
    assert np.isfinite(loss) and seen[0].device.type == dev.type, (loss, seen[0].device)
    assert tr.global_step == sum(1 for _ in open(files[0])) * len(files) // PSJOB_BATCH


def phase_ps_job(dev, card):
    """Phase 14: the part files, then leg A (async), leg B (gpubox) and
    leg C (the dense executor). Returns leg B's reading."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    base = tempfile.mkdtemp(prefix="ps_job_")
    try:
        t0 = time.perf_counter()
        files = write_part_files(base)
        whole = ps_job_dataset()
        whole.set_filelist(files)
        whole.load_into_memory(num_threads=4)
        log(f"PaddleRec job: {whole.num_records} MultiSlot lines in {len(files)} part files, "
            f"written and read back in {time.perf_counter() - t0:.2f} s (host)")
        if dev.type == "cuda":
            torch.cuda.empty_cache()  # the job's processes share the card
        ps_job_leg_async(dev, card, base, files, whole)
        gpubox = ps_job_leg_gpubox(dev, card, base, files, whole)
        ps_job_leg_dense(dev, card, files)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    log(f"PaddleRec job (phase 14): {time.perf_counter() - t_phase:.1f} s")
    return gpubox


# -- phase 15: the job restarts --------------------------------------------------

# A the_one_ps stream job, SIGKILLed mid-save, restarts from its newest
# verified checkpoint and ends bit-identical to a run that never stopped.
# Each leg is this script in ``--ckpt-job CONFIG.json`` mode, one process:
# two in-process NativePsServers on 127.0.0.1 (phase 13's 16-shard table,
# rows created with initial_range=0), a SyncCommunicator (pull-ahead 0: the
# bitwise contract), CtrStreamTrainer over HotTierConfig(capacity=2^19) at
# phase 4's width and data (32,768 lines, 10,000 ids a slot, batch 4096: 8
# batches; cut from 16 for the script's time limit),
# checkpoint_every=2 under CheckpointGate(servers=...): 4 checkpoints an
# epoch, the victim's third at batch 6, the resume from ckpt_0 at batch 2.
# Both the oracle and the resumed run checkpoint at the same batches, so
# the tier flushes at the same points.
JOBCKPT_LINES, JOBCKPT_IDS, JOBCKPT_BATCH, JOBCKPT_CAP = HOT_LINES, HOT_IDS, BATCH, HOT_CAP
JOBCKPT_EVERY = 2            # batches between checkpoints
JOBCKPT_KILL_AT = 3          # the victim dies in its third checkpoint's manifest write
JOBCKPT_TIMEOUT = 240        # seconds a leg's process may take
_CKPT_READING, _CKPT_SAVE = "CKPT_JOB_READING ", "CKPT_JOB_SAVE "


def ckpt_job_child(path):
    """``--ckpt-job CONFIG.json``: one leg of phase 15 in this process.
    ``leg`` "oracle" trains the epoch; "victim" arms ``ckpt.manifest=
    kill-job:after=3`` and dies by SIGKILL in its third save; "resume"
    loads the newest verified checkpoint, restores the servers' rows and the
    dense tier and trains the rest. Each save prints one ``CKPT_JOB_SAVE``
    line (its timings and the launch counts so far); a leg that ends writes
    its rows, dense tier and per-step losses to ``out`` and prints one
    ``CKPT_JOB_READING`` line."""
    from paddle_tpu_torch.io import checkpoint as ckpt
    from paddle_tpu_torch.io.job_checkpoint import JobCheckpointManager, combined_digest
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.communicator import SyncCommunicator
    from paddle_tpu_torch.ps.faultpoints import arm_faultpoint
    from paddle_tpu_torch.ps.ha import CheckpointGate
    from paddle_tpu_torch.ps.hot_tier import HotTierConfig
    from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer
    from paddle_tpu_torch.ps.rpc import RemoteSparseTable
    from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig

    with open(path) as f:
        spec = json.load(f)
    dev = torch.device(spec["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    ds = ctr_dataset(ctr_lines(np.random.default_rng(20), spec["lines"], spec["ids"], SLOTS,
                               DENSE), SLOTS, DENSE)
    data_s = time.perf_counter() - t0
    servers, client = rpc_cluster(acc=AccessorConfig(
        embedx_dim=DIM, embedx_threshold=0.0, sgd=SGDRuleConfig(initial_range=0.0)))
    comm = SyncCommunicator(client)
    try:
        comm.start()
        model = DeepFM(CtrConfig(SLOTS, DENSE, DIM, (400, 400, 400)),
                       generator=torch.Generator().manual_seed(0))
        trainer = CtrStreamTrainer(model, Adam(learning_rate=1e-3), None, communicator=comm,
                                   table_id=0, embedx_dim=DIM,
                                   hot_tier=HotTierConfig(capacity=spec["capacity"]),
                                   device=dev, **slot_names(SLOTS, DENSE))
        table = RemoteSparseTable(client, 0, client.sparse_config(0))
        mgr = JobCheckpointManager(spec["root"], gate=CheckpointGate(servers=servers),
                                   max_keep=8)
        mgr.register_sparse("ctr", table)

        # timers around the manager's and the tier's calls, and the step's
        # losses (device scalars, read after the run)
        losses, writes, flush_ms, saves = [], [], [], []
        hot_step, real_flush, real_write = trainer._hot_step, trainer.hot_tier.flush, mgr._write
        real_save, real_state = mgr.save, trainer.train_state
        dense_ms = []

        def step(*a):
            out = hot_step(*a)
            losses.append(out[3])
            return out

        def flush():
            t = time.perf_counter()
            n = real_flush()
            flush_ms.append(1e3 * (time.perf_counter() - t))
            return n

        def write(snap):  # the writer thread
            t = time.perf_counter()
            real_write(snap)
            writes.append([snap.ckpt_id, 1e3 * (time.perf_counter() - t)])

        def train_state():
            t = time.perf_counter()
            out = real_state()
            dense_ms.append(1e3 * (time.perf_counter() - t))
            return out

        def save(step, cursor=None, dense=None, blocking=False):
            t = time.perf_counter()
            no = real_save(step, cursor, dense, blocking)
            rec = {"ckpt": no, "batch": step, "capture_ms": 1e3 * (time.perf_counter() - t),
                   "pause_ms": mgr.pause_ms[-1], "flush_ms": flush_ms[-1],
                   "dense_ms": dense_ms[-1], "launches": read_launches(),
                   "writes_done": list(writes)}
            saves.append(rec)
            print(_CKPT_SAVE + json.dumps(rec), flush=True)
            return no

        trainer._hot_step, trainer.hot_tier.flush, mgr._write = step, flush, write
        mgr.save, trainer.train_state = save, train_state

        start, restored = 0, {}
        if spec["leg"] == "victim":
            arm_faultpoint("ckpt.manifest", "kill-job", after=JOBCKPT_KILL_AT)
        if spec["leg"] == "resume":
            t = time.perf_counter()
            r = mgr.load_latest()
            restored["load_latest_s"] = time.perf_counter() - t
            t = time.perf_counter()
            restored["rows"] = r.restore_sparse("ctr", table)
            restored["restore_sparse_s"] = time.perf_counter() - t
            t = time.perf_counter()
            trainer.restore_train_state(r.dense)
            _sync(dev)
            restored["restore_train_state_s"] = time.perf_counter() - t
            restored.update(ckpt_id=r.ckpt_id, cursor=r.cursor,
                            fallbacks=[[no, why] for no, why in mgr.fallbacks],
                            occupancy=trainer.hot_tier.stats()["occupancy"])
            start = r.cursor
        _sync(dev)
        reset_launches()
        t0 = time.perf_counter()
        r = trainer.train_from_dataset(ds, batch_size=spec["batch"], start_batch=start,
                                       checkpoint=mgr, checkpoint_every=JOBCKPT_EVERY)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = read_launches()
        mgr.stop()  # drains the writer: the victim's armed kill fires by here
        if spec["leg"] == "victim":
            print("SURVIVED", flush=True)
            return 3
        trainer.hot_tier.flush = real_flush
        trainer.hot_tier.flush()
        comm.barrier()
        keys = dataset_keys(ds)
        ckpt.save({"keys": keys, "pulled": client.pull_sparse(0, keys, create=False),
                   "dense": real_state(), "losses": np.asarray([float(x) for x in losses])},
                  spec["out"])
        print(_CKPT_READING + json.dumps({
            "leg": spec["leg"], "steps": int(r["steps"]), "loss": r["loss"], "s": wall,
            "samples_per_s": r["samples"] / wall, "data_s": data_s, "launches": launches,
            "digest": str(combined_digest(table)), "rows": client.size(0), "saves": saves,
            "writes": writes, "restored": restored}), flush=True)
        return 0
    finally:
        comm.stop()
        close_cluster(servers, client)


def ckpt_job_leg(base, leg, dev):
    """Run one leg's process; returns (CompletedProcess, reading or None,
    the save records it printed, seconds)."""
    spec = {"leg": leg, "device": dev.type, "root": os.path.join(base, "ckpt"),
            "out": os.path.join(base, f"out_{leg}"), "lines": JOBCKPT_LINES,
            "ids": JOBCKPT_IDS, "batch": JOBCKPT_BATCH, "capacity": JOBCKPT_CAP}
    if leg == "oracle":
        spec["root"] = os.path.join(base, "ckpt_oracle")  # its own checkpoints, same cadence
    path = os.path.join(base, f"{leg}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, PSJOB_SCRIPT, "--ckpt-job", path], capture_output=True,
                       text=True, timeout=JOBCKPT_TIMEOUT)
    wall = time.perf_counter() - t0
    lines = p.stdout.splitlines()
    saves = [json.loads(l[len(_CKPT_SAVE):]) for l in lines if l.startswith(_CKPT_SAVE)]
    got = [json.loads(l[len(_CKPT_READING):]) for l in lines if l.startswith(_CKPT_READING)]
    for rec in saves:
        log(f"job restarts, {leg}: checkpoint {rec['ckpt']} at batch {rec['batch']}: tier "
            f"flush {rec['flush_ms']:.1f} ms, dense host copy {rec['dense_ms']:.1f} ms, gate "
            f"pause {rec['pause_ms']:.1f} ms, capture (save() call) {rec['capture_ms']:.1f} ms; "
            f"writes done so far (id, ms) {rec['writes_done']}")
    return p, (got[-1] if got else None), saves, wall


def _ckpt_bytes(root):
    """Published checkpoint id → the bytes of its artifacts (manifest's)."""
    from paddle_tpu_torch.io.job_checkpoint import verify_checkpoint

    out = {}
    for name in sorted(os.listdir(root)):
        if name.startswith("ckpt_") and not name.endswith(".tmp"):
            man = verify_checkpoint(os.path.join(root, name))
            out[man["ckpt_id"]] = sum(a["bytes"] for a in man["artifacts"].values())
    return out


def phase_job_checkpoint(dev, card):
    """Phase 15: the oracle, the victim (SIGKILL in its third save), one
    flipped byte in the newest published checkpoint, the resume. Checks the
    kill, the fallback to ckpt_0 (cursor batch 2), one B2 and one B4 a step
    in every leg, the loss falling, and the resumed run's rows, dense
    params, Adam state, losses and table digest bitwise against the
    oracle's."""
    import tempfile

    from paddle_tpu_torch.io import checkpoint as ckpt

    t_phase = time.perf_counter()
    base = tempfile.mkdtemp(prefix="job_ckpt_")
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the legs' processes share the card
    try:
        def checked(leg):
            p, reading, saves, wall = ckpt_job_leg(base, leg, dev)
            if p.returncode != 0 or reading is None:
                log(f"--- {leg} stdout (tail) ---\n{p.stdout[-4000:]}\n--- {leg} stderr "
                    f"(tail) ---\n{p.stderr[-4000:]}")
                raise AssertionError(f"job restarts, {leg}: rc {p.returncode}")
            log(f"job restarts, {leg}: {reading['steps']} steps in {reading['s']:.3f} s, "
                f"{reading['samples_per_s']:.1f} samples/s (4 checkpoints' flush and capture "
                f"included), mean loss {reading['loss']:.6f}; data made and parsed in "
                f"{reading['data_s']:.2f} s; launches {reading['launches']}; writes (id, ms) "
                f"{reading['writes']}; process {wall:.1f} s on {card}")
            if dev.type == "cuda":
                n = reading["steps"]
                assert reading["launches"]["hot_probe_gather"] == n and \
                    reading["launches"]["hot_scatter_apply"] == n, \
                    f"{leg}: B2/B4 launches {reading['launches']} != {n} steps"
            return reading

        oracle = checked("oracle")
        n_batches = JOBCKPT_LINES // JOBCKPT_BATCH
        assert oracle["steps"] == n_batches, oracle["steps"]

        p, _, saves, wall = ckpt_job_leg(base, "victim", dev)
        root = os.path.join(base, "ckpt")
        names = sorted(os.listdir(root))
        log(f"job restarts, victim: exit {p.returncode} after {wall:.1f} s, {len(saves)} saves "
            f"begun; the checkpoint root holds {names}")
        if p.returncode != -9 or "SURVIVED" in p.stdout:
            log(f"--- victim stdout (tail) ---\n{p.stdout[-4000:]}\n--- victim stderr (tail) "
                f"---\n{p.stderr[-4000:]}")
            raise AssertionError(f"job restarts: the victim exited {p.returncode}, not -9")
        assert [x for x in names if not x.endswith(".tmp")] == ["ckpt_0", "ckpt_1"] and \
            "ckpt_2.tmp" in names, f"victim left {names}: want ckpt_0, ckpt_1, ckpt_2.tmp"
        last = saves[-1]
        if dev.type == "cuda":
            assert last["launches"]["hot_probe_gather"] == last["batch"] == \
                last["launches"]["hot_scatter_apply"], f"victim launches {last}"
        flipped = os.path.join(root, "ckpt_1", "sparse_ctr.npz")
        size = os.path.getsize(flipped)
        with open(flipped, "r+b") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0xFF]))
        log(f"job restarts: flipped byte {size // 2} of ckpt_1/sparse_ctr.npz ({size} bytes)")

        resume = checked("resume")
        got = resume["restored"]
        log(f"job restarts, resume: load_latest {got['load_latest_s']:.3f} s (ckpt "
            f"{got['ckpt_id']}, cursor {got['cursor']}, fallbacks {got['fallbacks']}), "
            f"restore_sparse {got['restore_sparse_s']:.3f} s ({got['rows']} rows into fresh "
            f"servers, digest checked), restore_train_state {got['restore_train_state_s']:.3f} s "
            f"(tier occupancy after {got['occupancy']}) on {card}")
        assert got["ckpt_id"] == 0 and got["cursor"] == {"batch": JOBCKPT_EVERY,
                                                         "batch_size": JOBCKPT_BATCH}, got
        assert len(got["fallbacks"]) == 1 and got["fallbacks"][0][0] == 1 and \
            "CRC32C" in got["fallbacks"][0][1], got["fallbacks"]
        assert got["occupancy"] == 0 and resume["steps"] == n_batches - JOBCKPT_EVERY

        want = ckpt.load(os.path.join(base, "out_oracle"))
        have = ckpt.load(os.path.join(base, "out_resume"))
        leaves = lambda t: ([x for k in sorted(t) for x in leaves(t[k])]  # noqa: E731
                            if isinstance(t, dict) else [np.asarray(t)])
        checks = {
            "rows pulled for the data's keys": np.array_equal(have["keys"], want["keys"])
            and np.array_equal(have["pulled"], want["pulled"]),
            "dense params": all(np.array_equal(a, b) for a, b in
                                zip(leaves(have["dense"]["state"]),
                                    leaves(want["dense"]["state"]))),
            "Adam state": all(np.array_equal(a, b) for a, b in
                              zip(leaves(have["dense"]["opt"]), leaves(want["dense"]["opt"]))),
            "table digest": resume["digest"] == oracle["digest"],
            "per-step losses": np.array_equal(have["losses"],
                                              want["losses"][JOBCKPT_EVERY:]),
        }
        log(f"job restarts: resume vs oracle, bitwise: {checks}; {len(want['keys'])} keys, "
            f"{oracle['rows']} rows on the servers")
        assert all(checks.values()), f"the resumed run differs from the oracle: {checks}"
        ls = want["losses"]
        assert np.isfinite(ls).all() and ls[-4:].mean() < ls[:4].mean(), f"losses {ls}"
        sizes = _ckpt_bytes(os.path.join(base, "ckpt_oracle"))
        log(f"job restarts: loss {ls[:4].mean():.6f} (batches 1-4) -> {ls[-4:].mean():.6f} "
            f"({len(ls) - 3}-{len(ls)}); checkpoint bytes (id: bytes) {sizes}")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    log(f"job restarts (phase 15): {time.perf_counter() - t_phase:.1f} s")


# -- phase 16: the PS loses a primary -----------------------------------------------

# PS high availability and the compressed sparse wires at phase 4's width on
# its data (DeepFM 26 slots x dim 8, 13 dense, DNN 400^3, batch 4096,
# 32,768 lines of 10,000 ids a slot: one cold epoch of 8 batches a run; cut
# from 16 for the script's time limit, phases 17-19 share it) on phase 13's
# 16-shard table (rows created with initial_range=0), each run on a fresh
# ha.HACluster(num_shards=2, replication=2, sync=True) of in-process servers.
# Leg A: the wire ladder (fp32, fp16, int8 push wires) through a
# HalfAsyncCommunicator. Leg B: failover, an oracle and a chaos run per arm
# through a SyncCommunicator, cluster.drain() after every call that changes
# the servers; RPC-only (kill-shard on shard 0's primary at its 6th push) and
# over HotTierConfig(capacity=2^19) (kill-shard on shard 1's primary at its
# 7th export, a miss fill; a checkpoint every 4 batches under
# cluster.checkpoint_gate()). Leg C: leg B's RPC arm against four server
# processes of this script (--ha-server) over a FileStore, shard 0's primary
# SIGKILLed after batch 5.
HA_LINES, HA_IDS, HA_BATCH, HA_CAP = HOT_LINES, HOT_IDS, BATCH, HOT_CAP
HA_SHARDS, HA_REPLICAS = 2, 2
HA_EVERY = 4             # batches between the tier arm's checkpoints
HA_KILL_PUSH = 6         # RPC arm: shard 0's primary dies on its 6th push (5 landed)
HA_KILL_EXPORT = 7       # tier arm: shard 1's primary dies on its 7th export (6 answered)
HA_KILL_AFTER_BATCH = 5  # leg C: the SIGKILL lands after batch 5
HA_TIMEOUT = 240         # seconds a leg C server process may live
_HA_READY = "HA_SERVER_READY "
_U64 = 0xFFFFFFFFFFFFFFFF


def ha_dataset():
    return ctr_dataset(ctr_lines(np.random.default_rng(20), HA_LINES, HA_IDS, SLOTS, DENSE),
                       SLOTS, DENSE)


def ha_table_config(**wire):
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
    from paddle_tpu_torch.ps.table import TableConfig

    return TableConfig(table_id=0, shard_num=RPC_TABLE_SHARDS, accessor_config=AccessorConfig(
        embedx_dim=DIM, embedx_threshold=0.0, sgd=SGDRuleConfig(initial_range=0.0)), **wire)


def ha_cluster():
    from paddle_tpu_torch.ps.ha import HACluster

    return HACluster(num_shards=HA_SHARDS, replication=HA_REPLICAS, sync=True)


def ha_trainer(dev, comm, hot, table=0, placement=None):
    """Phase 4's DeepFM from seed 0 over ``comm`` (on ``table``), RPC-only
    (with ``placement``, a ``PlacementManager``) or over the hot tier; its
    per-step losses and step-end times are kept."""
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.hot_tier import HotTierConfig
    from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer

    model = DeepFM(CtrConfig(SLOTS, DENSE, DIM, (400, 400, 400)),
                   generator=torch.Generator().manual_seed(0))
    tr = CtrStreamTrainer(model, Adam(learning_rate=1e-3), None, communicator=comm, table_id=table,
                          embedx_dim=DIM, hot_tier=HotTierConfig(capacity=HA_CAP) if hot else None,
                          placement=placement, device=dev, **slot_names(SLOTS, DENSE))
    tr.ha_losses, tr.ha_step_ends = [], []
    name, at = ("_hot_step", 3) if hot else ("_step", 2)
    real = getattr(tr, name)

    def step(*a):
        out = real(*a)
        tr.ha_losses.append(out[at])
        tr.ha_step_ends.append(time.perf_counter())
        return out

    setattr(tr, name, step)
    return tr


def ha_losses(tr):
    return np.asarray([float(x) for x in tr.ha_losses])


def ha_check_losses(ls, what):
    assert np.isfinite(ls).all() and ls[-4:].mean() < ls[:4].mean(), f"{what}: losses {ls}"


def ha_wire_counter(what):
    """The summed ``ps_client_wire_<what>`` push series of table 0."""
    from paddle_tpu_torch.obs import registry

    fam = registry.REGISTRY.snapshot()["metrics"].get(f"ps_client_wire_{what}",
                                                      {"series": []})
    return sum(s["value"] for s in fam["series"]
               if s["labels"].get("dir") == "push" and s["labels"].get("table") == "0")


def ha_replicas_equal(cluster, what):
    """After a drain: per shard, the digests of its live replicas."""
    digs = [cluster.digests(0, s) for s in range(HA_SHARDS)]
    for s, d in enumerate(digs):
        assert len(set(d.values())) == 1, f"{what}: shard {s} replicas differ: {d}"
    return digs


def ha_wire_run(dev, card, ds, wire):
    """Leg A, one rung: a cold epoch RPC-only over a HalfAsyncCommunicator
    with the given push wire (int8: error feedback, block 128). Checks the
    push-byte counter against the encoded row's formula, no residual left
    after the closing quiesce, primary ≡ backup digests, losses."""
    from paddle_tpu_torch.ps.communicator import HalfAsyncCommunicator

    cluster = ha_cluster()
    try:
        client = cluster.client()
        client.create_sparse_table(0, ha_table_config(push_wire_dtype=wire))
        drained, real_drain = [], client.drain_push_residuals

        def drain(table_id=None):
            n = real_drain(table_id)
            drained.append(n)
            return n

        client.drain_push_residuals = drain
        comm = HalfAsyncCommunicator(client)
        comm.start()
        tr = ha_trainer(dev, comm, hot=False)
        b0, r0 = ha_wire_counter("bytes"), ha_wire_counter("rows")
        t0 = time.perf_counter()
        r = tr.train_from_dataset(ds, batch_size=HA_BATCH)
        _sync(dev)
        wall = time.perf_counter() - t0
        comm.stop()  # the closing quiesce: queued pushes and residuals drain
        resid = client.push_residual_rows()
        nbytes, nrows = ha_wire_counter("bytes") - b0, ha_wire_counter("rows") - r0
        n_drained = sum(drained)
        gd = client._dims(0)[1] - 3
        per_row = 8 + 12 + gd * {"fp32": 4, "fp16": 2, "int8": 1}[wire] + \
            (4 * -(-gd // 128) if wire == "int8" else 0)
        want = per_row * (nrows - n_drained) + (8 + 4 * (3 + gd)) * n_drained
        ls = ha_losses(tr)
        log(f"PS HA leg A, push wire {wire}: {int(r['steps'])} steps, "
            f"{r['samples'] / wall:.1f} samples/s ({1e3 * wall / r['steps']:.3f} ms/step); "
            f"push bytes {nbytes} = {per_row} B x {nrows - n_drained} merged rows + 56 B x "
            f"{n_drained} drained residual rows (counter rows {nrows}); residual rows after "
            f"the quiesce {resid}; loss {ls[:4].mean():.6f} (batches 1-4) -> "
            f"{ls[-4:].mean():.6f} (last 4) on {card}")
        assert nbytes == want, f"{wire}: push bytes {nbytes} != {want}"
        assert resid == 0, f"{wire}: {resid} residual rows after the quiesce"
        assert (n_drained > 0) == (wire == "int8"), f"{wire}: drained {n_drained}"
        ha_check_losses(ls, f"PS HA leg A {wire}")
        cluster.drain()
        digs = ha_replicas_equal(cluster, f"PS HA leg A {wire}")
        if wire == "fp32":
            ha_fp16_pull_check(cluster, ds)
        return {"samples_per_s": r["samples"] / wall, "bytes": nbytes, "rows": nrows,
                "drained": n_drained, "per_row": per_row, "losses": ls, "digests": digs}
    finally:
        cluster.stop()


def ha_fp16_pull_check(cluster, ds):
    """The data's keys pulled over the fp16 wire equal the fp32 pull
    rounded to half and widened, bitwise (the server rounds to nearest
    even)."""
    keys = dataset_keys(ds)
    c32, c16 = cluster.client(), cluster.client()
    c32.create_sparse_table(0, ha_table_config())  # the table exists: dims only
    c16.create_sparse_table(0, ha_table_config(pull_wire_dtype="fp16"))
    fp32, half = c32.pull_sparse(0, keys, create=False), c16.pull_sparse(0, keys, create=False)
    ok = half.tobytes() == torch.from_numpy(fp32).half().float().numpy().tobytes()
    log(f"PS HA leg A: fp16 pull of {len(keys)} keys: equal to the fp32 pull rounded to half "
        f"bitwise {ok}; max |fp16 - fp32| {float(np.abs(half - fp32).max())}")
    assert ok, "the fp16 pull differs from the fp32 pull rounded to half"


class _CutDigests:
    """``cluster.checkpoint_gate()`` that also reads every live replica's
    digest at the cut (inside the gate, after its drain)."""

    def __init__(self, cluster):
        self.cluster, self.gate, self.cuts = cluster, cluster.checkpoint_gate(), []

    def __enter__(self):
        self.gate.__enter__()
        try:
            self.cuts.append([self.cluster.digests(0, s) for s in range(HA_SHARDS)])
        except BaseException:
            self.gate.__exit__(None, None, None)
            raise
        return self

    def __exit__(self, *exc):
        self.gate.__exit__(*exc)


def ha_arm_run(dev, ds, hot, chaos, root=None):
    """Leg B, one run on a fresh cluster through a SyncCommunicator,
    ``cluster.drain()`` after every call that changes the servers. With
    ``chaos`` the armed kill-shard fires mid-epoch; the RPC arm then
    restarts the dead replica, waits for its rejoin and holds every
    replica's digest equal. The tier arm checkpoints every ``HA_EVERY``
    batches into ``root`` and captures B2/B4's inputs on the first batch
    after the promotion. Returns the run's record."""
    from paddle_tpu_torch.io.job_checkpoint import JobCheckpointManager, verify_checkpoint
    from paddle_tpu_torch.ps.communicator import SyncCommunicator
    from paddle_tpu_torch.ps.rpc import _EXPORT, _PUSH_SPARSE, RemoteSparseTable

    cluster = ha_cluster()
    got, restore = capture_hot_step() if hot and chaos else ({}, lambda: None)
    mgr = None
    try:
        client = cluster.client()
        client.create_sparse_table(0, ha_table_config())
        coord = cluster.coordinator
        calls = []  # (end time, ms, promotions before, after) of each call that may fail

        def timed_drained(fn, drain_if=lambda *a, **k: True):
            def run(*a, **k):
                before, t = coord.promotions, time.perf_counter()
                out = fn(*a, **k)
                end = time.perf_counter()
                calls.append((end, 1e3 * (end - t), before, coord.promotions))
                if drain_if(*a, **k):
                    cluster.drain()
                return out
            return run

        comm = SyncCommunicator(client)
        comm.start()
        base_send = comm.send_sparse

        def send(table_id, keys, values):
            base_send(table_id, keys, values)
            cluster.drain()

        comm.send_sparse = send
        tr = ha_trainer(dev, comm, hot)
        if hot:
            tier = tr.hot_tier
            tier.table.export_full = timed_drained(
                tier.table.export_full, lambda keys, create=False, slots=None: create)
            tier.table.import_full = timed_drained(tier.table.import_full)
            gate = _CutDigests(cluster)
            mgr = JobCheckpointManager(root, gate=gate, max_keep=8)
            mgr.register_sparse("ctr", RemoteSparseTable(client, 0, client.sparse_config(0)))
            real_save = mgr.save
            save_ms = []

            def save(*a, **k):
                t = time.perf_counter()
                no = real_save(*a, **k)
                save_ms.append(1e3 * (time.perf_counter() - t))
                return no

            mgr.save = save
            hot_step = tr._hot_step

            def arm_then_step(*a):  # the first batch after the promotion
                if chaos and not got["armed"] and coord.promotions:
                    got["armed"] = True
                return hot_step(*a)

            tr._hot_step = arm_then_step
        else:
            client.pull_sparse = timed_drained(client.pull_sparse)
            client.push_sparse = timed_drained(client.push_sparse)
        victim = None
        if chaos:
            shard, cmd, after = (1, _EXPORT, HA_KILL_EXPORT) if hot else \
                (0, _PUSH_SPARSE, HA_KILL_PUSH)
            victim = cluster.primary(shard)
            victim.server.arm_fault("kill-shard", cmd=cmd, after=after)
        _sync(dev)
        reset_launches()
        t0 = time.perf_counter()
        r = tr.train_from_dataset(ds, batch_size=HA_BATCH, checkpoint=mgr,
                                  checkpoint_every=HA_EVERY if hot else 0)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = read_launches()
        rec = {"steps": int(r["steps"]), "wall": wall, "samples_per_s": r["samples"] / wall,
               "launches": launches, "losses": ha_losses(tr),
               "step_ms": np.diff([t0] + tr.ha_step_ends) * 1e3, "step_ends": tr.ha_step_ends,
               "promotions": coord.promotions, "calls": calls}
        if hot:
            mgr.wait()
            tr.hot_tier.flush()
            rec["pause_ms"], rec["save_ms"] = list(mgr.pause_ms), save_ms
            rec["cuts"] = []
            for no, cut in enumerate(gate.cuts):
                man = verify_checkpoint(os.path.join(root, f"ckpt_{no}"))
                prim = [set(d.values()) for d in cut]
                assert all(len(p) == 1 for p in prim), f"replicas differ at cut {no}: {cut}"
                total = sum(next(iter(p)) for p in prim) & _U64
                assert man["tables"]["ctr"]["digest"] == total, \
                    f"checkpoint {no}: manifest digest != the replicas' at the cut"
                rec["cuts"].append({no: [len(d) for d in cut]})
            mgr.stop()
            mgr = None
        comm.stop()
        if chaos:
            assert victim.server.stopped, "the armed primary did not die"
            assert coord.promotions >= 1, "no promotion"
            if not hot:
                dead = victim.endpoint
                t = time.perf_counter()
                cluster.restart_replica(0, dead)
                deadline = time.monotonic() + 30
                while dead not in cluster.routing.read()[1][0].get("backups", []):
                    assert time.monotonic() < deadline, "the restarted replica never rejoined"
                    time.sleep(0.02)
                cluster.drain()
                rec["rejoin_s"] = time.perf_counter() - t
                rec["rejoin_digests"] = ha_replicas_equal(cluster, "PS HA leg B after rejoin")
                assert all(len(d) == HA_REPLICAS for d in rec["rejoin_digests"])
        cluster.drain()
        rec["digests"] = ha_replicas_equal(cluster, "PS HA leg B")
        keys = dataset_keys(ds)
        rec["pulled"] = client.pull_sparse(0, keys, create=False)
        rec["dense"] = tr.train_state()
        rec["captured"] = {k: got[k] for k in ("b2", "b4") if k in got}
        return rec
    finally:
        restore()
        if mgr is not None:
            mgr.stop()
        cluster.stop()


def ha_leaves(t):
    return ([x for k in sorted(t) for x in ha_leaves(t[k])] if isinstance(t, dict)
            else [np.asarray(t)])


def ha_bitwise(a, b):
    """The run's rows pulled for the data's keys, dense params, Adam state
    and per-step losses, each bitwise."""
    return {"rows pulled for the data's keys": np.array_equal(a["pulled"], b["pulled"]),
            "dense params": all(np.array_equal(x, y) for x, y in
                                zip(ha_leaves(a["dense"]["state"]),
                                    ha_leaves(b["dense"]["state"]))),
            "Adam state": all(np.array_equal(x, y) for x, y in
                              zip(ha_leaves(a["dense"]["opt"]), ha_leaves(b["dense"]["opt"]))),
            "per-step losses": np.array_equal(a["losses"], b["losses"])}


def ha_recovery(rec, step_ends):
    """(ms of the call the promotion happened in, median ms of the other
    calls, the index of the step that call belongs to)."""
    hit = [(end, ms) for end, ms, before, after in rec["calls"] if after > before]
    rest = [ms for _, ms, before, after in rec["calls"] if after == before]
    step = int(np.searchsorted(step_ends, hit[0][0])) if hit else -1
    return (hit[0][1] if hit else float("nan")), float(np.median(rest)), step


def ha_arm(dev, card, ds, hot):
    """Leg B, one arm: the oracle, then the chaos run, each bitwise checked
    against the other. Returns (oracle, chaos)."""
    import tempfile

    name = "tier" if hot else "RPC-only"
    base = tempfile.mkdtemp(prefix="ps_ha_") if hot else None
    try:
        oracle = ha_arm_run(dev, ds, hot, chaos=False,
                            root=os.path.join(base, "oracle") if hot else None)
        chaos = ha_arm_run(dev, ds, hot, chaos=True,
                           root=os.path.join(base, "chaos") if hot else None)
    finally:
        if base is not None:
            shutil.rmtree(base, ignore_errors=True)
    rec_ms, call_ms, hit = ha_recovery(chaos, chaos["step_ends"])
    step = chaos["step_ms"]
    log(f"PS HA leg B, {name} arm: oracle {oracle['samples_per_s']:.1f} samples/s, chaos "
        f"{chaos['samples_per_s']:.1f} samples/s ({chaos['steps']} steps each); promotions "
        f"{chaos['promotions']}; recovery (the call the promotion landed in) {rec_ms:.1f} ms "
        f"against a median call of {call_ms:.1f} ms; the chaos step (step {hit + 1}) "
        f"{step[hit]:.1f} ms against the median step {float(np.median(step)):.1f} ms (the "
        f"oracle's step {hit + 1}: {oracle['step_ms'][hit]:.1f} ms) on {card}")
    if hot:
        log(f"PS HA leg B, tier arm: gate pause ms {[round(x, 1) for x in chaos['pause_ms']]}, "
            f"save() ms {[round(x, 1) for x in chaos['save_ms']]}; manifest digests equal to "
            f"every live replica's at each cut {chaos['cuts']}; launches {chaos['launches']}")
    else:
        log(f"PS HA leg B, RPC-only arm: the dead replica restarted and rejoined (catalog "
            f"replay, snapshot, tail) in {chaos['rejoin_s']:.2f} s; every replica's digest "
            f"equal: {chaos['rejoin_digests']}")
    for r in (oracle, chaos):
        assert r["steps"] == HA_LINES // HA_BATCH, f"{name}: {r['steps']} steps"
        ha_check_losses(r["losses"], f"PS HA leg B {name}")
        if hot and dev.type == "cuda":
            n = r["steps"]
            assert r["launches"]["hot_probe_gather"] == n == r["launches"]["hot_scatter_apply"], \
                f"{name}: B2/B4 launches {r['launches']} != {n} steps"
    checks = ha_bitwise(chaos, oracle)
    log(f"PS HA leg B, {name} arm: chaos vs oracle, bitwise: {checks}")
    assert all(checks.values()), f"the {name} chaos run differs from its oracle: {checks}"
    return oracle, chaos


def ha_server_child(store_dir, job, shard):
    """``--ha-server STORE JOB SHARD``: one replica of leg C (an
    ``HAServer`` over a ``FileStore`` on 127.0.0.1) until it is killed, its
    server stops, its parent goes or ``HA_TIMEOUT`` passes."""
    from paddle_tpu_torch.distributed.elastic import FileStore
    from paddle_tpu_torch.ps.ha import HAServer

    parent = os.getppid()
    s = HAServer(FileStore(store_dir), job, int(shard), n_trainers=1, sync=True,
                 hb_interval=0.1, hb_ttl=0.6)
    s.start()
    print(_HA_READY + s.endpoint, flush=True)
    deadline = time.monotonic() + HA_TIMEOUT
    while not s.server.stopped and os.getppid() == parent and time.monotonic() < deadline:
        time.sleep(0.1)
    s.close()
    return 0


def ha_process_leg(dev, card, ds, want):
    """Leg C: four ``--ha-server`` processes (2 shards x 2 replicas, started
    together), the parent's ``FailoverCoordinator`` and leg B's RPC-only run
    through ``HARouter(store, job)`` with ``drain_remote`` after every call
    that changes the servers; shard 0's primary process SIGKILLed after batch
    ``HA_KILL_AFTER_BATCH``. Checks: bitwise equal to leg B's RPC-only
    oracle, the routing names the backup, every process reaped."""
    import tempfile

    from paddle_tpu_torch.distributed.elastic import FileStore
    from paddle_tpu_torch.ps import ha
    from paddle_tpu_torch.ps.communicator import SyncCommunicator
    from paddle_tpu_torch.ps.rpc import RpcPsClient

    job = "phase16"
    base = tempfile.mkdtemp(prefix="ps_ha_procs_")
    store_dir = os.path.join(base, "store")
    os.makedirs(store_dir)
    procs, coord, client = {}, None, None
    t_phase = time.perf_counter()
    try:
        for shard in range(HA_SHARDS):
            for rep in range(HA_REPLICAS):
                err = open(os.path.join(base, f"server_{shard}_{rep}.err"), "w")
                procs[(shard, rep)] = subprocess.Popen(
                    [sys.executable, PSJOB_SCRIPT, "--ha-server", store_dir, job, str(shard)],
                    stdout=subprocess.PIPE, stderr=err, text=True)
                err.close()
        eps = {}
        for key, p in procs.items():
            line = p.stdout.readline().strip()
            assert line.startswith(_HA_READY), f"server {key} did not start: {line!r}"
            eps[key] = line[len(_HA_READY):]
        up_s = time.perf_counter() - t_phase
        store = FileStore(store_dir)
        routing = ha.RoutingTable(store, job)
        routing.publish(0, [{"primary": eps[(s, 0)],
                             "backups": [eps[(s, r)] for r in range(1, HA_REPLICAS)],
                             "replicas": [eps[(s, r)] for r in range(HA_REPLICAS)]}
                            for s in range(HA_SHARDS)])
        coord = ha.FailoverCoordinator(store, job, grace_s=0.2, poll_s=0.05).start()
        client = RpcPsClient(routing.primaries(), router=ha.HARouter(store, job))
        client.create_sparse_table(0, ha_table_config())

        def drain_all():
            for sh in routing.read()[1]:
                ha.drain_remote(sh["primary"], sh.get("backups", []))

        sends, kill_at, first_after = [0], [None], []
        base_pull = client.pull_sparse

        def pull(*a, **k):
            out = base_pull(*a, **k)
            if kill_at[0] is not None and not first_after:
                first_after.append(time.perf_counter() - kill_at[0])
            drain_all()
            return out

        client.pull_sparse = pull
        comm = SyncCommunicator(client)
        comm.start()
        base_send = comm.send_sparse

        def send(table_id, keys, values):
            base_send(table_id, keys, values)
            drain_all()
            sends[0] += 1
            if sends[0] == HA_KILL_AFTER_BATCH:
                procs[(0, 0)].kill()  # SIGKILL: nothing graceful; the lease expires by TTL
                kill_at[0] = time.perf_counter()

        comm.send_sparse = send
        tr = ha_trainer(dev, comm, hot=False)
        _sync(dev)
        t0 = time.perf_counter()
        r = tr.train_from_dataset(ds, batch_size=HA_BATCH)
        _sync(dev)
        wall = time.perf_counter() - t0
        comm.stop()
        procs[(0, 0)].wait(timeout=30)
        got = {"pulled": client.pull_sparse(0, dataset_keys(ds), create=False),
               "dense": tr.train_state(), "losses": ha_losses(tr)}
        step = np.diff([t0] + tr.ha_step_ends) * 1e3
        new_primary = routing.read()[1][0]["primary"]
        log(f"PS HA leg C: 4 server processes up in {up_s:.2f} s; {int(r['steps'])} steps, "
            f"{r['samples'] / wall:.1f} samples/s; SIGKILL after batch {HA_KILL_AFTER_BATCH} "
            f"(exit {procs[(0, 0)].returncode}); the first call after it answered "
            f"{1e3 * first_after[0]:.1f} ms after the kill; promotions {coord.promotions}; "
            f"step {HA_KILL_AFTER_BATCH + 1} {step[HA_KILL_AFTER_BATCH]:.1f} ms against the "
            f"median {float(np.median(step)):.1f} ms on {card}")
        assert procs[(0, 0)].returncode == -9, procs[(0, 0)].returncode
        assert new_primary == eps[(0, 1)], f"shard 0 routes to {new_primary}, not its backup"
        assert coord.promotions >= 1 and int(r["steps"]) == HA_LINES // HA_BATCH
        checks = ha_bitwise(got, want)
        log(f"PS HA leg C: SIGKILLed process run vs leg B's RPC-only oracle, bitwise: {checks}")
        assert all(checks.values()), f"leg C differs from leg B's oracle: {checks}"
        return {"samples_per_s": r["samples"] / wall, "recovery_ms": 1e3 * first_after[0]}
    finally:
        if client is not None:
            client.close()
        if coord is not None:
            coord.stop()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
            p.stdout.close()
        assert all(p.returncode is not None for p in procs.values()), "a server was not reaped"
        shutil.rmtree(base, ignore_errors=True)


def phase_ha(dev, card):
    """Phase 16: leg A (the wire ladder), leg B (failover, RPC-only and
    tier arms; B2 and B4 bitwise on the first batch after the tier arm's
    promotion), leg C (SIGKILLed server processes). Returns (the tier chaos
    run's launch counts, B2's numbers, B4's numbers)."""
    t_phase = time.perf_counter()
    ds = ha_dataset()
    wires = {w: ha_wire_run(dev, card, ds, w) for w in ("fp32", "fp16", "int8")}
    curves = {w: [round(float(x), 6) for x in wires[w]["losses"]] for w in wires}
    log(f"PS HA leg A: push bytes {({w: wires[w]['bytes'] for w in wires})}, fp32/int8 "
        f"{wires['fp32']['bytes'] / wires['int8']['bytes']:.3f}x, fp32/fp16 "
        f"{wires['fp32']['bytes'] / wires['fp16']['bytes']:.3f}x; residual rows drained "
        f"{({w: wires[w]['drained'] for w in wires})}; loss curves {curves}")
    rpc_oracle, _ = ha_arm(dev, card, ds, hot=False)
    _, tier = ha_arm(dev, card, ds, hot=True)
    b2, b4 = ({}, {})
    if dev.type == "cuda":
        cap = tier["captured"]
        assert "b2" in cap and "b4" in cap, "nothing captured after the promotion"
        b2 = rpc_b2_check(cap["b2"], "first batch after the promotion")
        b4 = rpc_b4_check(cap["b4"], "first batch after the promotion")
    ha_process_leg(dev, card, ds, rpc_oracle)
    log(f"PS loses a primary (phase 16): {time.perf_counter() - t_phase:.1f} s")
    return tier["launches"], b2, b4


# -- phase 17: the PS reshards under load ------------------------------------
# Phase 16's cell (DeepFM 26 slots, 13 dense, dim 8, DNN 400^3, Adam 1e-3;
# 32,768 lines at 10,000 ids a slot, batch 4096: 8 batches an epoch) on fresh 2 shards x 2 replicas sync HAClusters, a SyncCommunicator
# and cluster.drain() after every change. Leg A, RPC-only, 3 epochs: an
# oracle, and a chaos run that grows 2 -> 4 on a thread during epoch 2
# (shard 0's primary killed on its first kSaveAll, the migration's snapshot
# read) and shrinks back during epoch 3. Leg B, over HotTierConfig(2^19), 2
# epochs: an oracle, and a run that grows after the cold epoch (then
# tr.on_reshard()), trains the warm epoch across the flip, and shrinks back.
RESHARD_EPOCHS = 3


def reshard_drained(cluster, fn, calls):
    """``fn`` then ``cluster.drain()``, timed together (the kill lands on
    the reshard's thread, so the trainer may meet it in either): (end
    time, ms, promotions before, after) of each call lands in ``calls``."""
    coord = cluster.coordinator

    def run(*a, **k):
        before, t = coord.promotions, time.perf_counter()
        out = fn(*a, **k)
        cluster.drain()
        end = time.perf_counter()
        calls.append((end, 1e3 * (end - t), before, coord.promotions))
        return out
    return run


def reshard_on_thread(op, errs):
    """Run the reshard ``op`` on a thread; its exception lands in ``errs``."""
    import threading

    def run():
        try:
            op()
        except BaseException as e:  # noqa: BLE001 — raised by the caller
            errs.append(e)
    th = threading.Thread(target=run, name="reshard")
    th.start()
    return th


def reshard_table_state(client, ds, table=0):
    """Rows pulled for the data's keys (the pull re-resolves a stale
    client), then the table's size and digest sum."""
    pulled = client.pull_sparse(table, dataset_keys(ds), create=False)
    return {"pulled": pulled, "size": client.size(table),
            "digest_sum": sum(client.digest(table)) & _U64}


def reshard_leg_a_run(dev, ds, chaos):
    """Leg A, one run of ``RESHARD_EPOCHS`` epochs RPC-only (see the
    section's comment). Returns the run's record."""
    from paddle_tpu_torch.ps.communicator import SyncCommunicator
    from paddle_tpu_torch.ps.reshard import ReshardController
    from paddle_tpu_torch.ps.rpc import _SAVE_ALL

    cluster = ha_cluster()
    try:
        client = cluster.client()
        client.create_sparse_table(0, ha_table_config())
        calls = []
        client.pull_sparse = reshard_drained(cluster, client.pull_sparse, calls)
        client.push_sparse = reshard_drained(cluster, client.push_sparse, calls)
        comm = SyncCommunicator(client)
        comm.start()
        base_send = comm.send_sparse

        def send(table_id, keys, values):
            base_send(table_id, keys, values)
            cluster.drain()

        comm.send_sparse = send
        tr = ha_trainer(dev, comm, hot=False)
        ctrl = ReshardController(cluster)
        cut_at, errs, th, eps = [], [], None, []
        ctrl.on_pre_cutover(lambda plan: cut_at.append(time.perf_counter()))
        _sync(dev)
        t0 = time.perf_counter()
        for e in range(RESHARD_EPOCHS):
            if chaos and e == 1:
                # die on the first kSaveAll: the grow's snapshot read of shard 0
                cluster.primary(0).server.arm_fault("kill-shard", cmd=_SAVE_ALL, after=1)
                th = reshard_on_thread(lambda: ctrl.grow(2), errs)
            if chaos and e == 2:
                th.join()
                assert not errs, f"the grow failed: {errs}"
                assert cluster.num_shards == 4, cluster.num_shards
                th = reshard_on_thread(lambda: ctrl.shrink(2), errs)
            te = time.perf_counter()
            r = tr.train_from_dataset(ds, batch_size=HA_BATCH)
            _sync(dev)
            eps.append(r["samples"] / (time.perf_counter() - te))
        if th is not None:
            th.join()
            assert not errs, f"the shrink failed: {errs}"
        comm.stop()
        cluster.drain()
        rec = {"epoch_sps": eps, "losses": ha_losses(tr), "events": list(ctrl.events),
               "promotions": cluster.coordinator.promotions, "calls": calls,
               "step_ends": tr.ha_step_ends, "step_ms": np.diff([t0] + tr.ha_step_ends) * 1e3,
               "cut_at": cut_at, "num_shards": cluster.num_shards}
        rec.update(reshard_table_state(client, ds))
        rec["digests"] = ha_replicas_equal(cluster, "PS reshard leg A")
        rec["dense"] = tr.train_state()
        return rec
    finally:
        cluster.stop()


def reshard_leg_b_run(dev, ds, flip):
    """Leg B, one run over the tier: a cold epoch, then (with ``flip``) a
    grow and ``tr.on_reshard()`` from the training thread, the warm epoch
    (B2 and B4 captured on its first batch), flush and barrier, then (with
    ``flip``) a shrink. Returns the run's record."""
    from paddle_tpu_torch.ps.communicator import SyncCommunicator
    from paddle_tpu_torch.ps.reshard import ReshardController

    cluster = ha_cluster()
    got, restore = capture_hot_step() if flip else ({"armed": False}, lambda: None)
    try:
        client = cluster.client()
        client.create_sparse_table(0, ha_table_config())
        comm = SyncCommunicator(client)
        comm.start()
        tr = ha_trainer(dev, comm, hot=True)
        ctrl = ReshardController(cluster)
        tier, rec = tr.hot_tier, {}
        _sync(dev)
        t0 = time.perf_counter()
        cold = tr.train_from_dataset(ds, batch_size=HA_BATCH)
        _sync(dev)
        rec["cold_sps"] = cold["samples"] / (time.perf_counter() - t0)
        if flip:
            occ = tier.stats()["occupancy"]
            rec["grow"] = ctrl.grow(2)
            t = time.perf_counter()
            tr.on_reshard()
            rec["on_reshard_ms"] = 1e3 * (time.perf_counter() - t)
            st = tier.stats()
            assert st["occupancy"] == occ and st["reshards"] == 1, \
                f"leg B: the tier changed across the grow: {occ} -> {st}"
            assert client.num_servers == 4, client.num_servers
        client.reset_op_counts()
        reset_launches()
        got["armed"] = flip
        t = time.perf_counter()
        warm = tr.train_from_dataset(ds, batch_size=HA_BATCH)
        _sync(dev)
        rec["warm_sps"] = warm["samples"] / (time.perf_counter() - t)
        rec["warm_ops"] = client.reset_op_counts()
        rec["launches"] = read_launches()
        rec["warm_steps"] = int(warm["steps"])
        tier.flush()
        comm.barrier()
        if flip:
            rec["shrink"] = ctrl.shrink(2)
        comm.stop()
        cluster.drain()
        rec.update(reshard_table_state(client, ds))
        rec["num_shards"] = cluster.num_shards
        rec["losses"], rec["dense"] = ha_losses(tr), tr.train_state()
        rec["captured"] = {k: got[k] for k in ("b2", "b4") if k in got}
        return rec
    finally:
        restore()
        cluster.stop()


def reshard_bitwise(a, b):
    """``ha_bitwise`` and the table's size and digest sum."""
    return dict(ha_bitwise(a, b), **{"table size": a["size"] == b["size"],
                                     "digest sum": a["digest_sum"] == b["digest_sum"]})


def reshard_leg_a(dev, card, ds):
    oracle = reshard_leg_a_run(dev, ds, chaos=False)
    chaos = reshard_leg_a_run(dev, ds, chaos=True)
    step = chaos["step_ms"]
    med = float(np.median(step))
    rec_ms, call_ms, hit = ha_recovery(chaos, chaos["step_ends"])
    cuts = [int(np.searchsorted(chaos["step_ends"], t)) for t in chaos["cut_at"]]
    log(f"PS reshard leg A: samples/s per epoch, oracle "
        f"{[round(x, 1) for x in oracle['epoch_sps']]}, chaos "
        f"{[round(x, 1) for x in chaos['epoch_sps']]} on {card}")
    for ev in chaos["events"]:
        log(f"PS reshard leg A: {ev['direction']} {ev['from_shards']} -> {ev['to_shards']}: "
            f"bootstrap {ev['bootstrap_s']} s, cutover pause {ev['cutover_pause_ms']} ms, rows "
            f"moved {ev.get('rows_moved', 'n/a')}")
    log(f"PS reshard leg A: promotions {chaos['promotions']}; the promotion's call (with its "
        f"drain) {rec_ms:.1f} ms against a median call of {call_ms:.1f} ms (step {hit + 1}); the "
        f"cutovers land in steps {[c + 1 for c in cuts]}, "
        f"{[round(float(step[c]), 1) for c in cuts if c < len(step)]} ms against the median "
        f"step {med:.1f} ms on {card}")
    for r in (oracle, chaos):
        assert r["num_shards"] == HA_SHARDS, r["num_shards"]
        assert len(r["losses"]) == RESHARD_EPOCHS * (HA_LINES // HA_BATCH), len(r["losses"])
        ha_check_losses(r["losses"], "PS reshard leg A")
    assert [e["direction"] for e in chaos["events"]] == ["grow", "shrink"], chaos["events"]
    assert chaos["promotions"] >= 1, "no promotion: the kill did not fire mid-migration"
    checks = reshard_bitwise(chaos, oracle)
    log(f"PS reshard leg A: chaos vs oracle, bitwise: {checks}")
    assert all(checks.values()), f"leg A's chaos run differs from its oracle: {checks}"
    return oracle


def reshard_leg_b(dev, card, ds):
    oracle = reshard_leg_b_run(dev, ds, flip=False)
    run = reshard_leg_b_run(dev, ds, flip=True)
    n = run["warm_steps"]
    log(f"PS reshard leg B: cold {run['cold_sps']:.1f} samples/s (oracle "
        f"{oracle['cold_sps']:.1f}); grow: bootstrap {run['grow']['bootstrap_s']} s, cutover "
        f"pause {run['grow']['cutover_pause_ms']} ms, rows moved {run['grow']['rows_moved']}; "
        f"on_reshard (flush, re-route) {run['on_reshard_ms']:.1f} ms; warm epoch across the "
        f"flip {run['warm_sps']:.1f} samples/s (oracle {oracle['warm_sps']:.1f}), client ops "
        f"{run['warm_ops']}, launches {run['launches']}; shrink: bootstrap "
        f"{run['shrink']['bootstrap_s']} s, cutover pause {run['shrink']['cutover_pause_ms']} ms "
        f"on {card}")
    assert run["num_shards"] == oracle["num_shards"] == HA_SHARDS
    assert sum(run["warm_ops"].values()) == 0, f"leg B: the warm epoch's client ops {run['warm_ops']}"
    if dev.type == "cuda":
        for r in (oracle, run):
            assert r["launches"]["hot_probe_gather"] == n == r["launches"]["hot_scatter_apply"], \
                f"leg B: B2/B4 launches {r['launches']} != {n} warm steps"
    for r in (oracle, run):
        ha_check_losses(r["losses"], "PS reshard leg B")
    checks = reshard_bitwise(run, oracle)
    log(f"PS reshard leg B: the run across the flip vs its oracle, bitwise: {checks}")
    assert all(checks.values()), f"leg B differs from its oracle: {checks}"
    return run, oracle


def phase_reshard(dev, card, keep=None):
    """Phase 17: leg A (RPC-only, a grow and a shrink under load with a
    kill mid-migration) and leg B (the tier across a grow; B2 and B4
    bitwise on the first batch after the flip). Returns (leg B's launch
    counts in the warm epoch across the flip, B2's numbers, B4's numbers);
    leg B's oracle record lands in ``keep["leg_b_oracle"]`` (phase 18's),
    leg A's in ``keep["leg_a_oracle"]`` (phase 19's)."""
    t_phase = time.perf_counter()
    ds = ha_dataset()
    oracle_a = reshard_leg_a(dev, card, ds)
    run, oracle = reshard_leg_b(dev, card, ds)
    if keep is not None:
        keep["leg_b_oracle"], keep["leg_a_oracle"] = oracle, oracle_a
    b2, b4 = ({}, {})
    if dev.type == "cuda":
        cap = run["captured"]
        assert "b2" in cap and "b4" in cap, "nothing captured after the flip"
        b2 = rpc_b2_check(cap["b2"], "first batch after the flip")
        b4 = rpc_b4_check(cap["b4"], "first batch after the flip")
    log(f"PS reshards under load (phase 17): {time.perf_counter() - t_phase:.1f} s")
    return run["launches"], b2, b4


# -- phase 18: tenants share a PS, and replicas serve ----------------------------------
# One 2 x 2 sync HACluster shared by the two tenants of a TenantDirectory.
# "ctr" trains phase 17 leg B's cell through its tenant-bound client on
# tenant_table_id(1, 0) (the tier of 2^19 rows, a SyncCommunicator, 2
# epochs): its oracle is that leg's, the same computation on an untenanted
# cluster (the table id changes no row: rows start at zero with
# initial_range=0, and the digest hashes keys and values only). "abuse"
# floods beside it with the envelope of the JAX package's interference test
# (tests/test_tenancy.py: batch class, 500 units/s, a burst of 500, 500 rows
# a shard). Then read-only replicas serve the trained model's predictions.
TENANT_CTR, TENANT_ABUSE = 1, 9
ABUSE_ENVELOPE = dict(pclass=1, rate=500.0, burst=500.0, max_rows=500)
ABUSE_KEYS = 512          # keys of one flood pull
ABUSE_OUTCOMES = ("ThrottledError", "QuotaExceededError", "WrongTenantError")
DENSE_LOCAL_ID = 7        # the dense tower's table inside the ctr namespace
SERVE_REQUESTS, SERVE_SUBMITTERS, SERVE_BATCH = 2000, 8, 64  # tools/serving_bench.py's defaults
SERVE_PRIME = 128         # requests served before the measured ones
SERVE_CHECKED = 512       # predictions held against the forward on the primaries' rows
SERVE_PROBES = 25
SERVE_TOL = dict(rtol=1e-5, atol=1e-6)  # cuBLAS may pick another GEMM at another batch


class TenantAbuser:
    """The abusive tenant's flood on a thread of its own, as the JAX
    interference test drives it: pulls of ``ABUSE_KEYS`` random keys that
    create rows, each followed by a probe of another tenant's table. Counts
    each outcome; another error stops the flood and is raised by ``stop``.
    A quota refusal needs a third admitted frame on a shard, ~0.5 s of
    refill at 500 units/s: ``stop(until_seen=...)`` lets the flood run on
    until it has met each named outcome (or ``timeout`` s pass), so a short
    run still shows all three."""

    def __init__(self, client, table, probe_table):
        from collections import Counter

        self.client, self.table, self.probe_table = client, table, probe_table
        self.seen = Counter()
        self._rng = np.random.default_rng(7)
        self._thread, self._stop, self._error = None, None, None

    def start(self):
        import threading

        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="tenant-abuse", daemon=True)
        self._thread.start()

    def stop(self, until_seen=(), timeout=30.0):
        deadline = time.monotonic() + timeout
        while (any(self.seen[k] == 0 for k in until_seen) and self._thread.is_alive()
               and time.monotonic() < deadline):
            time.sleep(0.01)
        self._stop.set()
        self._thread.join(60)
        assert not self._thread.is_alive(), "the abuser's flood did not stop"
        if self._error is not None:
            raise self._error

    def _run(self):
        from paddle_tpu_torch.core.enforce import (QuotaExceededError, ThrottledError,
                                                   WrongTenantError)

        try:
            while not self._stop.is_set():
                keys = self._rng.integers(1, 1 << 40, ABUSE_KEYS).astype(np.uint64)
                for call in (lambda: self.client.pull_sparse(self.table, keys, create=True),
                             lambda: self.client.size(self.probe_table)):
                    try:
                        call()
                        self.seen["ok"] += 1
                    except (ThrottledError, QuotaExceededError, WrongTenantError) as e:
                        self.seen[type(e).__name__] += 1
        except BaseException as e:  # noqa: BLE001 — raised by stop()
            self._error = e


def tenancy_cluster():
    """The shared cluster, its directory with the two tenants, the abuser's
    client and its table."""
    from paddle_tpu_torch.ps.tenancy import Tenant, TenantDirectory, tenant_table_id

    cluster = ha_cluster()
    d = TenantDirectory(cluster)
    d.register(Tenant(name="ctr", tid=TENANT_CTR, token=b"ctr"))
    d.register(Tenant(name="abuse", tid=TENANT_ABUSE, token=b"abuse", **ABUSE_ENVELOPE))
    abuse = d.client("abuse")
    abuse.create_sparse_table(tenant_table_id(TENANT_ABUSE, 0), ha_table_config())
    return cluster, d, abuse


def tenancy_train(dev, ds, cluster, d, abuser):
    """Leg A: the ctr tenant's two epochs over the tier beside the flood
    (started here, left running), B2 and B4 captured on the first warm
    batch. Returns (the run's record, the trainer, the tenant's client)."""
    from paddle_tpu_torch.ps.communicator import SyncCommunicator
    from paddle_tpu_torch.ps.tenancy import tenant_table_id

    table = tenant_table_id(TENANT_CTR, 0)
    client = d.client("ctr")
    client.create_sparse_table(table, ha_table_config())
    comm = SyncCommunicator(client)
    # a tenant has no barrier (kBarrier is the operator plane's and a tenant
    # connection is refused it, in both packages): the tenant's one trainer
    # quiesces its own traffic instead, which the inline sends already have
    comm.barrier = comm.quiesce
    comm.start()
    tr = ha_trainer(dev, comm, hot=True, table=table)
    got, restore = capture_hot_step()
    rec = {}
    try:
        abuser.start()
        _sync(dev)
        t0 = time.perf_counter()
        cold = tr.train_from_dataset(ds, batch_size=HA_BATCH)
        _sync(dev)
        rec["cold_sps"] = cold["samples"] / (time.perf_counter() - t0)
        client.reset_op_counts()
        reset_launches()
        got["armed"] = True
        t = time.perf_counter()
        warm = tr.train_from_dataset(ds, batch_size=HA_BATCH)
        _sync(dev)
        rec["warm_sps"] = warm["samples"] / (time.perf_counter() - t)
        rec["warm_ops"] = client.reset_op_counts()
        rec["launches"] = read_launches()
        rec["warm_steps"] = int(warm["steps"])
    finally:
        restore()
    tr.hot_tier.flush()
    comm.barrier()
    comm.stop()
    cluster.drain()
    rec.update(reshard_table_state(client, ds, table))
    rec["losses"], rec["dense"] = ha_losses(tr), tr.train_state()
    rec["captured"] = {k: got[k] for k in ("b2", "b4") if k in got}
    return rec, tr, client


def tenancy_rows_per_shard(cluster, tid):
    from paddle_tpu_torch.ps.rpc import make_conn

    rows = []
    for s in range(cluster.num_shards):
        conn = make_conn(cluster.primary(s).endpoint)
        try:
            rows.append(int(conn.tenant_usage(tid)["rows"]))
        finally:
            conn.close()
    return rows


def tenancy_wait(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"phase 18: {what}"
        time.sleep(0.01)


def serve_requests(ds, n):
    """[n, 26] slot-tagged keys and [n, 13] dense features: one dataset
    record a request."""
    from paddle_tpu_torch.ps.ps_trainer import _dense_and_labels, _slot_tagged_keys

    names = slot_names(SLOTS, DENSE)
    b = next(iter(ds.batch_iter(n, drop_last=False)))
    keys = _slot_tagged_keys(b, names["sparse_slots"])
    dense, _ = _dense_and_labels(b, names["dense_slots"], names["label_slot"], len(keys))
    return keys, dense


def serve_drive(frontend, keys, dense, lo, hi, preds):
    """Requests lo..hi-1 from ``SERVE_SUBMITTERS`` closed-loop submitters;
    each prediction lands in ``preds``. Returns the wall seconds."""
    import threading

    nxt, mu, errs = [lo], threading.Lock(), []

    def submitter():
        try:
            while True:
                with mu:
                    i = nxt[0]
                    if i >= hi:
                        return
                    nxt[0] += 1
                preds[i] = frontend.submit(keys[i], dense=dense[i]).result(60)
        except BaseException as e:  # noqa: BLE001 — raised below
            errs.append(e)

    threads = [threading.Thread(target=submitter, name=f"serve-submit-{t}")
               for t in range(SERVE_SUBMITTERS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errs, f"phase 18: a serve request failed: {errs[0]!r}"
    return time.perf_counter() - t0


def tenancy_serve(dev, card, cluster, d, tr, client, abuser, abuse, ds):
    """Leg B (the flood stopped): publish the trained dense tower, one
    read-only replica a shard, the cached lookup and the frontend; warm
    requests checked against the forward on the primaries' rows with no
    client op; then the freshness probes beside the restarted flood.
    Returns the serving record."""
    from torch.func import functional_call

    from paddle_tpu_torch.convert import ctr_params_from_jax, ctr_params_to_jax
    from paddle_tpu_torch.ps.hot_tier import HotEmbeddingTier, HotTierConfig
    from paddle_tpu_torch.ps.rpc import RpcPsClient
    from paddle_tpu_torch.ps.tenancy import tenant_table_id
    from paddle_tpu_torch.serving import (CachedLookup, DenseTowerPublisher, DenseTowerSync,
                                          FreshnessProbe, FrontendConfig, ReplicaLookup,
                                          ServingFrontend, ServingReplica, make_serve_client)

    table = tenant_table_id(TENANT_CTR, 0)
    dense_table = tenant_table_id(TENANT_CTR, DENSE_LOCAL_ID)
    ctr = d.get("ctr")
    rec = {}
    t0 = time.perf_counter()
    # the dense tower lives whole on shard 0 (DenseTowerSync reads one
    # replica): the tenant's client of that shard publishes it
    pub_client = RpcPsClient([cluster.primary(0).endpoint], tenant=(ctr.tid, ctr.token))
    replicas, serve, frontend = [], None, None
    try:
        tree = ctr_params_to_jax(tr.params)["params"]
        pub = DenseTowerPublisher(pub_client, dense_table, tree)
        pub.publish(tree)
        cluster.drain()
        replicas = [ServingReplica(cluster.store, cluster.job_id, shard=s)
                    for s in range(cluster.num_shards)]
        serve = make_serve_client(replicas)
        view = replicas[0].serve_view(table, ha_table_config(), client=serve)
        live = {}
        sync = DenseTowerSync(replicas[0], dense_table, pub.dim, pub.unravel,
                              sink=lambda t: live.__setitem__("params",
                                                              ctr_params_from_jax(t, dev)))
        tenancy_wait(lambda: all(
            cluster.digests(table, s)[cluster.primary(s).endpoint] == serve.digest(table)[s]
            for s in range(cluster.num_shards)), "a replica never caught up with its primary")
        tenancy_wait(lambda: "params" in live and all(
            torch.equal(live["params"][k], v) for k, v in tr.params.items()),
            "the dense tower never reached the serving side")
        rec["catch_up_s"] = time.perf_counter() - t0
        rec["dense_syncs"] = sync.syncs
        tier = HotEmbeddingTier(view, HotTierConfig(capacity=HA_CAP, create_on_miss=False),
                                device=dev)
        lookup = CachedLookup(tier, replica=replicas[0], freshness_budget_s=0.05)

        def infer(emb, dense):
            with torch.no_grad():
                out = functional_call(tr.model, live["params"],
                                      (torch.from_numpy(emb).to(dev),
                                       torch.from_numpy(dense).to(dev)))
                return torch.sigmoid(out).cpu().numpy()

        frontend = ServingFrontend(lookup, infer=infer, config=FrontendConfig(
            max_batch=SERVE_BATCH, max_delay_us=200, queue_cap=4096,
            default_deadline_ms=1000.0))
        n = SERVE_PRIME + SERVE_REQUESTS
        keys, dense = serve_requests(ds, n)
        preds = np.zeros(n, np.float32)
        lookup.lookup(np.unique(keys))  # admit the working set
        serve_drive(frontend, keys, dense, 0, SERVE_PRIME, preds)
        frontend.reset_stats()
        for c in (client, abuse, serve):
            c.reset_op_counts()
        wall = serve_drive(frontend, keys, dense, SERVE_PRIME, n, preds)
        rec["ops"] = {"ctr": client.reset_op_counts(), "abuse": abuse.reset_op_counts(),
                      "serve": serve.reset_op_counts()}
        st = frontend.stats()
        rec["warm"], rec["qps"] = st, st["served"] / wall
        # the reference: the forward on the trained params and the
        # primaries' rows, at one batch
        ck = keys[SERVE_PRIME:SERVE_PRIME + SERVE_CHECKED]
        rows = client.pull_sparse(table, ck.reshape(-1), create=False)[:, 2:]
        with torch.no_grad():
            want = torch.sigmoid(functional_call(tr.model, tr.params, (
                torch.from_numpy(rows.reshape(len(ck), SLOTS, -1)).to(dev),
                torch.from_numpy(dense[SERVE_PRIME:SERVE_PRIME + SERVE_CHECKED]).to(dev)))
                ).cpu().numpy()
        got = preds[SERVE_PRIME:SERVE_PRIME + SERVE_CHECKED]
        rec["checked_preds"] = got.copy()
        rec["pred_max_abs"] = float(np.max(np.abs(got - want)))
        rec["pred_ok"] = bool(np.allclose(got, want, **SERVE_TOL))
        rec["preds_finite"] = bool(np.isfinite(preds).all())

        # freshness beside the flood: a marker the ctr client pushes must
        # become visible through the serving path
        marker_key = np.asarray([np.uint64(1) << np.uint64(41)], np.uint64)
        client.pull_sparse(table, marker_key)
        cluster.drain()
        width = client._dims(table)[1]
        direct = ReplicaLookup(serve, table)
        probe = FreshnessProbe(timeout_s=5.0)
        marker = [0.0]

        def write():
            marker[0] += 1.0
            mp = np.zeros((1, width), np.float32)
            mp[0, 2] = marker[0]  # the click stat: additive, pull column 1
            client.push_sparse(table, marker_key, mp)

        abuser.start()
        try:
            for _ in range(SERVE_PROBES):
                probe.measure(write, lambda: direct.lookup(marker_key)[0, 1],
                              lambda v, m=marker: v >= m[0])
        finally:
            abuser.stop()
        rec["fresh"] = probe.stats()
        return rec
    finally:
        if frontend is not None:
            frontend.stop()
        if serve is not None:
            serve.close()
        pub_client.close()
        for r in replicas:
            r.close()


def phase_tenancy(dev, card, oracle=None, keep=None):
    """Phase 18 (see the section's comment). ``oracle`` is phase 17 leg B's
    oracle record (None: run it here). Returns (the warm epoch's launch
    counts, B2's numbers, B4's numbers); the legs' records land in
    ``keep["train"]`` and ``keep["serve"]``."""
    from paddle_tpu_torch.ps.tenancy import tenant_table_id

    t_phase = time.perf_counter()
    ds = ha_dataset()
    if oracle is None:
        oracle = reshard_leg_b_run(dev, ds, flip=False)
    cluster, d, abuse = tenancy_cluster()
    try:
        abuser = TenantAbuser(abuse, tenant_table_id(TENANT_ABUSE, 0),
                              tenant_table_id(TENANT_CTR, 0))
        try:
            run, tr, client = tenancy_train(dev, ds, cluster, d, abuser)
        finally:
            abuser.stop(until_seen=ABUSE_OUTCOMES)
        leg_a = dict(abuser.seen)
        usage = d.usage("abuse")
        per_shard = tenancy_rows_per_shard(cluster, TENANT_ABUSE)
        n = run["warm_steps"]
        log(f"tenancy leg A: the ctr tenant beside the abuser: cold {run['cold_sps']:.1f} "
            f"samples/s (alone, phase 17 leg B's oracle: {oracle['cold_sps']:.1f}), warm "
            f"{run['warm_sps']:.1f} (alone {oracle['warm_sps']:.1f}), warm client ops "
            f"{run['warm_ops']}, launches {run['launches']}; the abuser's calls {leg_a}, its "
            f"meter {usage}, rows a shard {per_shard} on {card}")
        assert sum(run["warm_ops"].values()) == 0, f"phase 18: warm client ops {run['warm_ops']}"
        for kind in ABUSE_OUTCOMES:
            assert leg_a.get(kind, 0) >= 1, f"phase 18: the abuser never met {kind}: {leg_a}"
        # the quota refuses at batch granularity: the last admitted frame may
        # overshoot the cap by its keys on that shard
        cap = ABUSE_ENVELOPE["max_rows"] + ABUSE_KEYS
        assert all(r <= cap for r in per_shard), f"phase 18: abuser rows {per_shard} > {cap}"
        if dev.type == "cuda":
            assert run["launches"]["hot_probe_gather"] == n == \
                run["launches"]["hot_scatter_apply"], \
                f"phase 18: B2/B4 launches {run['launches']} != {n} warm steps"
        ha_check_losses(run["losses"], "tenancy leg A")
        checks = reshard_bitwise(run, oracle)
        log(f"tenancy leg A: the ctr tenant vs its oracle without tenants or abuser, bitwise: "
            f"{checks}")
        assert all(checks.values()), f"phase 18: the tenant differs from its oracle: {checks}"

        srv = tenancy_serve(dev, card, cluster, d, tr, client, abuser, abuse, ds)
        req, fresh = srv["warm"]["request"], srv["fresh"]
        leg_b = {k: v - leg_a.get(k, 0) for k, v in abuser.seen.items()}
        log(f"tenancy leg B: replicas caught up and the dense tower synced in "
            f"{srv['catch_up_s']:.2f} s ({srv['dense_syncs']} syncs); {srv['warm']['served']} "
            f"warm requests at {srv['qps']:.1f}/s, avg batch {srv['warm'].get('avg_batch')}, "
            f"p50 {req['p50_ms']} ms, p99 {req['p99_ms']} ms, serve batch p50 "
            f"{srv['warm']['serve_batch']['p50_ms']} ms; client ops {srv['ops']}; first "
            f"{SERVE_CHECKED} predictions vs the forward on the primaries' rows: max_abs "
            f"{srv['pred_max_abs']}; freshness beside the flood: {fresh['probes']} probes, "
            f"failures {fresh['failures']}, p50 {fresh['p50_ms']} ms, p95 {fresh['p95_ms']} ms "
            f"(the abuser's calls meanwhile {leg_b}) on {card}")
        assert srv["preds_finite"] and srv["pred_ok"], \
            f"phase 18: predictions off the forward by {srv['pred_max_abs']}"
        assert srv["warm"]["served"] == SERVE_REQUESTS and srv["warm"]["errors"] == 0, srv["warm"]
        assert all(not ops for ops in srv["ops"].values()), \
            f"phase 18: warm requests made client ops {srv['ops']}"
        assert fresh["failures"] == 0 and fresh["probes"] == SERVE_PROBES, fresh
        usage = d.usage("abuse")
        log(f"tenancy: the abuser's meter at the end {usage}")
        if keep is not None:
            keep.update(train=run, serve=srv)
    finally:
        cluster.stop()
    b2, b4 = ({}, {})
    if dev.type == "cuda":
        cap = run["captured"]
        assert "b2" in cap and "b4" in cap, "phase 18: nothing captured on the first warm batch"
        b2 = rpc_b2_check(cap["b2"], "tenant's first warm batch")
        b4 = rpc_b4_check(cap["b4"], "tenant's first warm batch")
    log(f"tenants and serving (phase 18): {time.perf_counter() - t_phase:.1f} s")
    return run["launches"], b2, b4


# -- phase 19: the PS seen from the server, measured placement, a serving fleet --------
# Leg A is phase 17 leg A's cell (config 3 as tools/sparse_hot_bench.py runs
# it: DeepFM on the Criteo shape, 26 slots, dim 8, DNN 400^3, batch 4096; the
# 32,768 lines of phase 16's cell at 10,000 ids a slot; one 2 x 2 sync HACluster,
# RPC-only, a SyncCommunicator with a drain after every send; 3 epochs), and its
# oracle is that leg's run without a reshard. Epoch 1 runs traced (every root
# sampled): the servers' spans and wire counters come back over kObsSnap. A
# PlacementManager arms the densify from the measured push density (as
# tests/test_placement.py's acceptance does); a grow before epoch 2 fires its
# fence, epoch 2 trains on the collective plane (the servers' engine, in the
# trainer's process), and an arm and a fence before epoch 3 move the table
# back. Leg B is tools/serving_fleet_bench.py's topology at a smoke's counts
# (its saturation arm, a capacity number, is left out): a 1-shard HACluster
# holding leg A's trained rows, 3 members (a read-only replica, a tier of 2^19
# rows on the card, a CachedLookup and a frontend each) behind a ServingRouter,
# a lease-watched ServingFleet and a RolloutManager; a request is one record of
# the data (26 keys), its prediction the DeepFM forward on the card with leg A's
# trained dense tower as v1 (v2 = v1 + 0.01, the bench's flat_v2).
PLACE_DENSIFY, PLACE_MIN_SAMPLES = 0.5, 4
FLEET_MEMBERS, FLEET_CAP, FLEET_BATCH, FLEET_DELAY_US = 3, 1 << 19, 64, 4000
FLEET_RATE = 1000.0           # open-loop arrivals a second (the bench's steady floor)
FLEET_REF, FLEET_STEADY, FLEET_CHAOS, FLEET_CHUNK = 1000, 2000, 1000, 500
FLEET_CHECKED = 512           # steady predictions held against the forward on v1
FLEET_CANARY = 0.2            # the bench's canary band
FLEET_BLOCK_SHIFT = 6


def phase_wait(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"phase 19: {what}"
        time.sleep(0.01)


def obs_wire_rows(snap, role):
    """Table 0's rows a direction in a merged job snapshot: the client's
    ``ps_client_wire_rows`` (role "client") or the servers' summed
    ``ps_server_wire_rows``."""
    fam = "ps_client_wire_rows" if role == "client" else "ps_server_wire_rows"
    out = {}
    for s in snap["metrics"].get(fam, {"series": []})["series"]:
        if s["labels"].get("table") == "0":
            d = s["labels"]["dir"]
            out[d] = out.get(d, 0) + s["value"]
    return out


def obs_traced_epoch(dev, ds, client, tr):
    """Epoch 1 with every root sampled. Returns the epoch's samples/s and
    the obs record: the client's spans, each primary's drained server spans
    and kObsSnap bytes, the wire rows a direction on both sides (deltas over
    the epoch), and the stitched chrome trace's flows."""
    from paddle_tpu_torch.obs import aggregate, trace
    from paddle_tpu_torch.obs.trace import SERVER_SPAN_STRUCT, SERVER_WIRE_STRUCT

    for s in range(client.num_servers):
        aggregate.fetch_server_obs(client, s, drain=True)
    base = aggregate.job_snapshot(client)
    trace.start_tracing(sample=1.0)
    try:
        _sync(dev)
        t = time.perf_counter()
        r = tr.train_from_dataset(ds, batch_size=HA_BATCH)
        _sync(dev)
        sps = r["samples"] / (time.perf_counter() - t)
    finally:
        trace.stop_tracing()
    spans = trace.drain_spans()
    rec = {"client_spans": len(spans), "spans_dropped": trace.dropped_spans(), "shards": []}
    events = trace.spans_to_chrome(spans, pid=0, process_name="trainer",
                                   epoch_offset_us=trace.EPOCH_ANCHOR_US)
    by_id = {s.span_id: s for s in spans}
    offsets = []
    for s in range(client.num_servers):
        snap, sspans = aggregate.fetch_server_obs(client, s, drain=True)
        ids = [x["span_id"] for x in sspans]
        n_tables = len(snap["metrics"]["ps_server_requests"]["series"])
        rec["shards"].append({
            "spans": len(sspans), "dropped": snap["process"]["spans_dropped"],
            "linked": all(i in by_id for i in ids), "unique": len(set(ids)) == len(ids),
            "same_trace": all(x["trace_id"] == by_id[x["span_id"]].trace_id
                              for x in sspans if x["span_id"] in by_id),
            "snap_bytes": 16 + SERVER_WIRE_STRUCT.size * n_tables
            + SERVER_SPAN_STRUCT.size * len(sspans)})
        # where each server span starts inside its client span, on the wall
        # clock: the server's C++ stamp against the client's anchored one
        offsets += [x["ts_us"] - (trace.EPOCH_ANCHOR_US + by_id[x["span_id"]].t0 * 1e6)
                    for x in sspans if x["span_id"] in by_id]
        events += aggregate.server_spans_to_chrome(sspans, pid=1 + s, process_name=f"ps_shard_{s}")
    after = aggregate.job_snapshot(client)
    rec["client_rows"] = {d: v - obs_wire_rows(base, "client").get(d, 0)
                          for d, v in obs_wire_rows(after, "client").items()}
    rec["server_rows"] = {d: v - obs_wire_rows(base, "server").get(d, 0)
                          for d, v in obs_wire_rows(after, "server").items()}
    blob = json.loads(json.dumps({"traceEvents": events, "displayTimeUnit": "ms"}))
    evs = blob["traceEvents"]
    starts = {e["id"] for e in evs if e.get("ph") == "s"}
    finishes = [e for e in evs if e.get("ph") == "f"]
    rec["flows"] = len(finishes)
    rec["flows_closed"] = bool(finishes) and all(e["id"] in starts and e["pid"] >= 1
                                                 for e in finishes)
    rec["offset_us_p50"] = float(np.median(offsets)) if offsets else float("nan")
    return sps, rec


def placement_leg_a_run(dev, ds):
    """Leg A, the traced and placed run (see the section's comment). Returns
    its record: phase 17's table state and dense tree, the obs record, the
    placement's timings and events, and the trained rows (leg B's table)."""
    from paddle_tpu_torch.convert import ctr_params_to_jax
    from paddle_tpu_torch.distributed.placement import PlacementConfig, PlacementManager
    from paddle_tpu_torch.ps.communicator import SyncCommunicator
    from paddle_tpu_torch.ps.reshard import ReshardController

    cluster = ha_cluster()
    try:
        client = cluster.client()
        client.create_sparse_table(0, ha_table_config())
        comm = SyncCommunicator(client)
        comm.start()
        base_send = comm.send_sparse

        def send(table_id, keys, values):
            base_send(table_id, keys, values)
            cluster.drain()

        comm.send_sparse = send
        ctrl = ReshardController(cluster)
        mgr = PlacementManager(client, 0, PlacementConfig(densify_threshold=PLACE_DENSIFY,
                                                          min_samples=PLACE_MIN_SAMPLES),
                               controller=ctrl)
        decided, base_arm = [], mgr.arm

        def arm(target):  # the auto policy's first arm: its series at the decision
            if not decided:
                s = mgr.series()
                decided.append({"target": target, "ewma": s.ewma, "wmin": s.wmin, "n": s.n,
                                "batch": tr.batches_done})
            base_arm(target)

        mgr.arm = arm
        tr = ha_trainer(dev, comm, hot=False, placement=mgr)
        rec = {"epoch_sps": [], "decided": decided}
        sps, rec["obs"] = obs_traced_epoch(dev, ds, client, tr)
        rec["epoch_sps"].append(sps)
        rec["after_1"] = (mgr.placement, mgr.armed())
        t = time.perf_counter()
        rec["grow"] = ctrl.grow(2)
        rec["grow_s"] = time.perf_counter() - t
        t = time.perf_counter()
        tr.on_reshard()  # the batch boundary after the fence: the swap applies
        rec["to_collective_s"] = time.perf_counter() - t
        rec["after_grow"] = (mgr.placement, client.num_servers)
        client.reset_op_counts()
        _sync(dev)
        t = time.perf_counter()
        r = tr.train_from_dataset(ds, batch_size=HA_BATCH)
        _sync(dev)
        rec["epoch_sps"].append(r["samples"] / (time.perf_counter() - t))
        rec["collective_ops"] = client.reset_op_counts()
        mgr.arm("ps")
        mgr.fence()
        t = time.perf_counter()
        mgr.poll(tr)  # a batch boundary after the fence: the swap back
        rec["to_ps_s"] = time.perf_counter() - t
        rec["after_back"] = mgr.placement
        _sync(dev)
        t = time.perf_counter()
        r = tr.train_from_dataset(ds, batch_size=HA_BATCH)
        _sync(dev)
        rec["epoch_sps"].append(r["samples"] / (time.perf_counter() - t))
        comm.stop()
        cluster.drain()
        rec["events"] = list(mgr.events)
        rec.update(reshard_table_state(client, ds))
        rec["num_shards"] = cluster.num_shards
        rec["replicas_equal"] = all(len(set(cluster.digests(0, s).values())) == 1
                                    for s in range(cluster.num_shards))
        rec["losses"], rec["dense"] = ha_losses(tr), tr.train_state()
        rec["rows"] = client.snapshot_items(0)
        rec["tree"] = ctr_params_to_jax(tr.params)["params"]
        return rec
    finally:
        cluster.stop()


def placement_leg_a(dev, card, ds, oracle):
    run = placement_leg_a_run(dev, ds)
    obs, dec = run["obs"], run["decided"]
    to_c, to_p = run["events"][0]["rows"], run["events"][-1]["rows"]
    log(f"obs wire leg A: traced epoch 1 {run['epoch_sps'][0]:.1f} samples/s against the "
        f"untraced oracle's {oracle['epoch_sps'][0]:.1f} (tracing's cost "
        f"{100 * (1 - run['epoch_sps'][0] / oracle['epoch_sps'][0]):.1f} %); client spans "
        f"{obs['client_spans']} (dropped {obs['spans_dropped']}); per shard: "
        + "; ".join(f"{x['spans']} server spans, kObsSnap {x['snap_bytes']} B"
                    for x in obs["shards"])
        + f"; wire rows client {obs['client_rows']} server {obs['server_rows']}; "
        f"{obs['flows']} flows, all finishing on a server lane: {obs['flows_closed']}; "
        f"server span start - client span start, median {obs['offset_us_p50']:.1f} us on {card}")
    log(f"placement leg A: armed {dec[0]['target'] if dec else None} from the measured push "
        f"density at batch {dec[0]['batch'] if dec else '-'} (EWMA "
        f"{dec[0]['ewma'] if dec else float('nan'):.4f}, window min "
        f"{dec[0]['wmin'] if dec else float('nan'):.4f}, {dec[0]['n'] if dec else 0} samples); "
        f"grow 2 -> 4 {run['grow_s']:.2f} s (bootstrap {run['grow']['bootstrap_s']} s, rows "
        f"moved {run['grow'].get('rows_moved', 'n/a')}); swap to the collective plane "
        f"{to_c} rows {run['to_collective_s']:.3f} s, back to the PS {to_p} rows "
        f"{run['to_ps_s']:.3f} s; samples/s per epoch (PS, collective, PS) "
        f"{[round(x, 1) for x in run['epoch_sps']]} against the oracle's "
        f"{[round(x, 1) for x in oracle['epoch_sps']]}; client ops on the collective plane "
        f"{run['collective_ops']} on {card}")
    for x in obs["shards"]:
        assert x["spans"] > 0 and x["linked"] and x["unique"] and x["same_trace"], \
            f"phase 19: server spans not linked to the client's: {obs['shards']}"
        assert x["dropped"] == 0, f"phase 19: a server dropped spans: {obs['shards']}"
    assert obs["spans_dropped"] == 0, obs
    assert obs["client_rows"] == {"pull": obs["server_rows"]["out"],
                                  "push": obs["server_rows"]["in"]}, \
        f"phase 19: wire rows client {obs['client_rows']} != server {obs['server_rows']}"
    assert obs["flows_closed"], "phase 19: a flow of the chrome trace does not finish on a server"
    assert dec and dec[0]["target"] == "collective", f"phase 19: no densify decision {dec}"
    assert run["after_1"] == ("ps", "collective"), run["after_1"]
    assert run["after_grow"] == ("collective", 4), run["after_grow"]
    assert not {k: v for k, v in run["collective_ops"].items() if "sparse" in k}, \
        f"phase 19: client sparse ops on the collective plane {run['collective_ops']}"
    assert run["after_back"] == "ps" and [e["to"] for e in run["events"]] == ["collective", "ps"]
    assert run["num_shards"] == 4 and run["replicas_equal"], run["num_shards"]
    assert len(run["losses"]) == RESHARD_EPOCHS * (HA_LINES // HA_BATCH), len(run["losses"])
    ha_check_losses(run["losses"], "placement leg A")
    checks = reshard_bitwise(run, oracle)
    log(f"placement leg A: traced, swapped to the collective plane and back, vs phase 17 leg "
        f"A's oracle, bitwise: {checks}")
    assert all(checks.values()), f"phase 19: leg A differs from its oracle: {checks}"
    return run


def fleet_member_factory(dev, cluster, flat_v1, unravel):
    """One ready member: a replica (the bench's fast lease) caught up with
    the primary, a read-only tier of ``FLEET_CAP`` rows on ``dev``, the
    cached lookup, v1 on the card and the DeepFM forward as its infer. Each
    member has a module of its own: ``functional_call`` swaps a module's
    parameters while it runs, and the members' frontends run concurrently."""
    from torch.func import functional_call

    from paddle_tpu_torch.convert import ctr_params_from_jax
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
    from paddle_tpu_torch.ps.hot_tier import HotEmbeddingTier, HotTierConfig
    from paddle_tpu_torch.serving import (CachedLookup, DenseModel, FleetMember,
                                          FrontendConfig, ServingFrontend, ServingReplica)

    def build():
        rep = ServingReplica(cluster.store, cluster.job_id, shard=0, hb_interval=0.05,
                             hb_ttl=0.4)
        serve = rep.client()
        view = rep.serve_view(0, ha_table_config(), client=serve)
        prim = cluster.primary(0).endpoint
        phase_wait(lambda: cluster.digests(0, 0).get(prim) == serve.digest(0)[0],
                   "a member's replica never caught up")
        tier = HotEmbeddingTier(view, HotTierConfig(capacity=FLEET_CAP, create_on_miss=False),
                                device=dev)
        lookup = CachedLookup(tier, replica=rep, freshness_budget_s=30.0)
        model = DeepFM(CtrConfig(SLOTS, DENSE, DIM, (400, 400, 400)))
        live = {}
        dm = DenseModel(unravel, flat_v1,
                        sink=lambda t: live.__setitem__("params", ctr_params_from_jax(t, dev)))

        def infer(emb, dense):
            with torch.no_grad():
                out = functional_call(model, live["params"], (torch.from_numpy(emb).to(dev),
                                                              torch.from_numpy(dense).to(dev)))
                return torch.sigmoid(out).cpu().numpy()

        fe = ServingFrontend(lookup, infer=infer, config=FrontendConfig(
            max_batch=FLEET_BATCH, max_delay_us=FLEET_DELAY_US, queue_cap=4096,
            default_deadline_ms=2000.0), replica_label=rep.endpoint)
        member = FleetMember(rep, lookup, fe, model=dm)
        member.live = live
        return member
    return build


def fleet_replay(router, keys, dense, idx, preds=None, mid_hook=None, deadline_ms=2000.0):
    """Open loop, the bench's driver: request ``idx[j]`` is submitted at
    ``j / FLEET_RATE`` s whether or not earlier ones finished (``mid_hook``
    runs a third of the way in), 8 threads collect. Returns wall seconds,
    errors (a shed at the router included), late arrivals (> 50 ms) and the
    first error."""
    import queue
    import threading

    q, errors = queue.Queue(), []

    def collect():
        while True:
            item = q.get()
            if item is None:
                return
            i, rr = item
            try:
                v = rr.result(30)
                if preds is not None:
                    preds[i] = v
            except Exception as e:  # noqa: BLE001 — counted
                errors.append(e)

    threads = [threading.Thread(target=collect, name=f"fleet-collect-{c}") for c in range(8)]
    for th in threads:
        th.start()
    late, start = 0, time.perf_counter()
    try:
        for j, i in enumerate(idx):
            target = start + j / FLEET_RATE
            now = time.perf_counter()
            if target > now:
                time.sleep(target - now)
            elif now - target > 0.05:
                late += 1
            if mid_hook is not None and j == len(idx) // 3:
                mid_hook()
            try:
                q.put((i, router.submit(keys[i], dense=dense[i], deadline_ms=deadline_ms)))
            except Exception as e:  # noqa: BLE001 — a shed at the router, counted
                errors.append(e)
    finally:
        for _ in threads:
            q.put(None)
        for th in threads:
            th.join()
    return {"wall_s": time.perf_counter() - start, "errors": len(errors), "late": late,
            "first_error": repr(errors[0]) if errors else None}


def fleet_arm(router, fleet, keys, dense, idx, **kw):
    """One arm of open-loop traffic: the router's request latency and the
    members' frontends reset first; p50/p99, requests/s, hedge rate."""
    for m in fleet.members():
        m.frontend.reset_stats()
    router.latency.reset()
    st0 = router.stats()
    rep = fleet_replay(router, keys, dense, idx, **kw)
    st = router.stats()
    lat = st["request"]
    routed = st["routed"] - st0["routed"]
    batches = [m.frontend.stats().get("avg_batch") for m in fleet.members()]
    rep.update(requests=len(idx), p50_ms=lat["p50_ms"], p99_ms=lat["p99_ms"], avg_batch=batches,
               rps=(len(idx) - rep["errors"]) / rep["wall_s"],
               hedges=st["hedges"] - st0["hedges"], reroutes=st["reroutes"] - st0["reroutes"],
               hedge_rate=(st["hedges"] - st0["hedges"]) / max(routed, 1))
    return rep


def fleet_join_curve(member, keys, dense, idx):
    """``idx`` through one member's frontend in 4 parts; its tier's misses
    after each (cumulative)."""
    miss0, curve = member.lookup.tier.counters["misses"], []
    for part in np.array_split(np.asarray(idx), 4):
        pend = [member.frontend.submit(keys[i], dense=dense[i], deadline_ms=10000.0)
                for i in part]
        for p in pend:
            p.result(30)
        curve.append(int(member.lookup.tier.counters["misses"] - miss0))
    return curve


def fleet_leg_b(dev, card, ds, leg_a):
    """Leg B (see the section's comment). Returns its record."""
    import random

    from torch.func import functional_call

    from paddle_tpu_torch.convert import ctr_params_from_jax, ravel_tree
    from paddle_tpu_torch.io.fs import crc32c
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
    from paddle_tpu_torch.ps.ha import HACluster
    from paddle_tpu_torch.serving import (FleetConfig, RolloutManager, RouterConfig,
                                          ServingFleet, ServingRouter)

    rec = {}
    cluster = HACluster(num_shards=1, replication=1, sync=False)
    fleet = router = None
    try:
        train = cluster.client()
        train.create_sparse_table(0, ha_table_config())
        rows_k, rows_v = leg_a["rows"]
        for lo in range(0, len(rows_k), 1 << 16):
            train.import_full(0, rows_k[lo:lo + (1 << 16)], rows_v[lo:lo + (1 << 16)])
        model = DeepFM(CtrConfig(SLOTS, DENSE, DIM, (400, 400, 400)))
        flat_v1, unravel = ravel_tree(leg_a["tree"])
        flat_v2 = flat_v1 + np.float32(0.01)
        dg_v1 = crc32c(np.ascontiguousarray(flat_v1).tobytes())
        router = ServingRouter(RouterConfig(block_shift=FLEET_BLOCK_SHIFT, hedge_default_ms=25.0,
                                            hedge_floor_ms=10.0), rng=random.Random(0))
        fleet = ServingFleet(cluster.store, cluster.job_id,
                             fleet_member_factory(dev, cluster, flat_v1, unravel), router,
                             config=FleetConfig(poll_s=0.05, warm_chunk=4096,
                                                max_replicas=16)).start()
        rollout = RolloutManager(lambda: fleet.members(), router)
        fleet.rollout = rollout
        v1 = rollout.register_baseline(flat_v1)
        n = FLEET_REF + FLEET_STEADY + 2 * FLEET_CHAOS + 2 * FLEET_CHUNK
        keys, dense = serve_requests(ds, n)
        cuts = np.cumsum([0, FLEET_REF, FLEET_STEADY, FLEET_CHAOS, FLEET_CHAOS, FLEET_CHUNK,
                          FLEET_CHUNK])
        ref_i, steady_i, crash_i, drain_i, join_i, canary_i = (
            np.arange(cuts[k], cuts[k + 1]) for k in range(6))
        # arm 0: one member, its tier primed with the requests' keys (the
        # working set a cover pass would leave resident)
        t = time.perf_counter()
        (first,) = fleet.add(1, warm=False)
        rec["join_s"] = time.perf_counter() - t
        work = np.unique(keys)
        rec["working_set"] = int(len(work))
        t = time.perf_counter()
        for lo in range(0, len(work), 1 << 16):
            first.lookup.lookup(work[lo:lo + (1 << 16)])
        rec["prime_s"] = time.perf_counter() - t
        rec["ref"] = fleet_arm(router, fleet, keys, dense, ref_i)
        # the fleet: 2 warm joins
        t = time.perf_counter()
        fleet.add(FLEET_MEMBERS - 1, warm=True)
        rec["grow_s"] = time.perf_counter() - t
        rec["handoffs"] = [e["handoff"] for e in list(fleet.events)[-(FLEET_MEMBERS - 1):]]
        preds = np.full(n, np.nan, np.float32)
        rec["steady"] = fleet_arm(router, fleet, keys, dense, steady_i, preds=preds)
        ck = steady_i[:FLEET_CHECKED]
        rows = train.pull_sparse(0, keys[ck].reshape(-1), create=False)[:, 2:]
        p1 = ctr_params_from_jax(unravel(flat_v1), dev)
        with torch.no_grad():
            want = torch.sigmoid(functional_call(model, p1, (
                torch.from_numpy(rows.reshape(len(ck), SLOTS, -1)).to(dev),
                torch.from_numpy(dense[ck]).to(dev)))).cpu().numpy()
        rec["pred_max_abs"] = float(np.max(np.abs(preds[ck] - want)))
        rec["pred_ok"] = bool(np.allclose(preds[ck], want, **SERVE_TOL))
        rec["preds_finite"] = bool(np.isfinite(preds[steady_i]).all())
        # a member crashed mid-replay: its lease lapses and the watch removes it
        victim = fleet.members()[-1]
        rec["crash"] = fleet_arm(router, fleet, keys, dense, crash_i, mid_hook=victim.crash)
        phase_wait(lambda: all(m.endpoint != victim.endpoint
                               for m in fleet.members(live_only=False)),
                   "the crashed member was never removed", timeout=10.0)
        rec["crash"]["removed"] = fleet.counters["crashes_removed"]
        # a member drained and a fresh one joined warm mid-replay
        # (on a thread of its own, so the arrivals stay open-loop meanwhile)
        import threading

        oldest, clean, hook = fleet.members()[0], [], []

        def drain_restart():
            clean.append(fleet.drain(oldest.endpoint))
            fleet.add(1, warm=True)

        def start_drain_restart():
            hook.append(threading.Thread(target=drain_restart, name="fleet-drain-restart"))
            hook[0].start()

        rec["drain"] = fleet_arm(router, fleet, keys, dense, drain_i,
                                 mid_hook=start_drain_restart)
        hook[0].join(120)
        assert not hook[0].is_alive(), "phase 19: the drain and warm join did not end"
        rec["drain"]["clean"] = bool(clean and clean[0])
        rec["members"] = fleet.size()
        # a warm and a cold join, each serving the same chunk
        (warm_m,) = fleet.add(1, warm=True)
        rec["warm_handoff"] = fleet.events[-1]["handoff"]
        rec["warm_curve"] = fleet_join_curve(warm_m, keys, dense, join_i)
        (cold_m,) = fleet.add(1, warm=False)
        rec["cold_curve"] = fleet_join_curve(cold_m, keys, dense, join_i)
        # canary, promote, rollback
        v2 = rollout.begin_canary(flat_v2, fraction=FLEET_CANARY)
        expect = sum(router.in_canary_band(int(keys[i][0]) >> FLEET_BLOCK_SHIFT, FLEET_CANARY)
                     for i in canary_i)
        rec["canary"] = fleet_arm(router, fleet, keys, dense, canary_i)
        rec["version_counts"] = dict(router.stats()["version_counts"])
        rec["expected_split"] = {str(v2): int(expect), str(v1): int(len(canary_i) - expect)}
        t = time.perf_counter()
        rollout.promote()
        rec["promote_s"] = time.perf_counter() - t
        rec["promoted"] = set(rollout.fleet_versions().values()) == {
            (v2, rollout.version_digest(v2))}
        t = time.perf_counter()
        rollout.rollback(reason="phase 19")
        rec["rollback_s"] = time.perf_counter() - t
        back = rollout.fleet_versions()
        rec["rollback_ok"] = set(back.values()) == {(v1, dg_v1)}
        rec["rollback_members"] = len(back)
        rec["live_v1"] = all(all(torch.equal(m.live["params"][k], p1[k]) for k in p1)
                             for m in fleet.members())
        rec["fleet_events"] = dict(fleet.counters)
        rec["hedge_rate"] = router.stats().get("hedge_rate")
        return rec
    finally:
        if fleet is not None:
            fleet.stop()
        if router is not None:
            router.stop()
        cluster.stop()


def phase_obs_fleet(dev, card, oracle=None):
    """Phase 19 (see the section's comment). ``oracle`` is phase 17 leg A's
    oracle record (None: run it here)."""
    t_phase = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ds = ha_dataset()
    if oracle is None:
        oracle = reshard_leg_a_run(dev, ds, chaos=False)
    t = time.perf_counter()
    leg_a = placement_leg_a(dev, card, ds, oracle)
    leg_a_s = time.perf_counter() - t
    t = time.perf_counter()
    b = fleet_leg_b(dev, card, ds, leg_a)
    leg_b_s = time.perf_counter() - t
    for name in ("ref", "steady", "crash", "drain", "canary"):
        a = b[name]
        log(f"fleet leg B, {name}: {a['requests']} requests open-loop at {FLEET_RATE:.0f}/s: "
            f"{a['rps']:.1f} requests/s, p50 {a['p50_ms']} ms, p99 {a['p99_ms']} ms, hedge rate "
            f"{a['hedge_rate']:.4f} ({a['hedges']} hedges, {a['reroutes']} reroutes), errors "
            f"{a['errors']} (first {a['first_error']}), late arrivals {a['late']}, requests a "
            f"micro-batch per member {a['avg_batch']} on {card}")
    log(f"fleet leg B: first member joined in {b['join_s']:.2f} s, its tier primed with the "
        f"requests' {b['working_set']} keys in {b['prime_s']:.2f} s; 2 warm joins in "
        f"{b['grow_s']:.2f} s (handoffs "
        f"{b['handoffs']}); first {FLEET_CHECKED} steady predictions vs the forward on v1 and "
        f"the primary's rows: max_abs {b['pred_max_abs']}; crash removed by the lease watch "
        f"({b['crash']['removed']}); drain clean {b['drain']['clean']}; warm join (handoff "
        f"{b['warm_handoff']}) misses {b['warm_curve']} against a cold join's "
        f"{b['cold_curve']} over the same {FLEET_CHUNK} requests; canary split "
        f"{b['version_counts']} (the band predicate: {b['expected_split']}); promote "
        f"{b['promote_s']:.3f} s, rollback {b['rollback_s']:.3f} s over {b['rollback_members']} "
        f"members; fleet events {b['fleet_events']} on {card}")
    assert b["preds_finite"] and b["pred_ok"], \
        f"phase 19: predictions off the forward by {b['pred_max_abs']}"
    for name in ("ref", "steady", "crash", "drain", "canary"):
        assert b[name]["errors"] == 0, f"phase 19: {name} arm errors {b[name]}"
    assert b["crash"]["removed"] == 1 and b["drain"]["clean"], (b["crash"], b["drain"])
    assert b["warm_curve"][-1] < b["cold_curve"][-1], (b["warm_curve"], b["cold_curve"])
    assert b["version_counts"] == b["expected_split"], \
        f"phase 19: canary split {b['version_counts']} != {b['expected_split']}"
    assert b["promoted"] and b["rollback_ok"] and b["live_v1"], \
        "phase 19: v1 was not restored identically on every member"
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30) if dev.type == "cuda" else float("nan")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"obs wire, placement and the serving fleet (phase 19): "
        f"{time.perf_counter() - t_phase:.1f} s (leg A {leg_a_s:.1f} s, leg B {leg_b_s:.1f} s), "
        f"peak device memory {peak:.2f} GiB on {card}")
    return leg_a, b


# -- phase 20: the recsys serve path -----------------------------------------
#
# Leg A: GRU4Rec, DSSM and TDM train RS_STEPS steps at batch RS_BATCH on the
# card and the same steps on the CPU, from one numpy seed each (the cache over
# the items' keys, or the tree's node codes, and the model's weights carried
# across), for each seed of RS_SEEDS; the card runs of the first seed are the
# path's run (B1 launches counted there, its first push of each family checked
# bitwise). Leg B: tools/recsys_replay.py's configuration, through the port:
# a 1-shard HACluster over a FileStore with the RS_KEYS keys preloaded, a
# stream trainer in the background, a parent-side replica and cached lookup on
# the card, RS_MEMBERS member processes on the card behind a router and a
# fleet, and a PipelineFrontend whose ranker is leg A's trained GRU4Rec; after
# the warm pass the control plane starts (a MetricRing fed by a Sampler, an
# SloWatchdog with recsys_rules, an Autoscaler on the fleet's controller); an
# open-loop replay: a ramp with a member SIGKILLed mid-way (a fleet of one),
# the flash crowd (RS_SPIKE_XS × RS_PEAK_QPS, RS_SPIKE_S a step, which must fire
# recsys_e2e_p99 and make the autoscaler grow the fleet), a tail on the grown
# fleet (the exporter scraped once in it), a canary/promote/rollback; then the
# DSSM ranker and a TDM walk on the card against their CPU runs over the
# parent's lookup.
RS_KEYS, RS_DIM, RS_HIDDEN, RS_OUT = 20_000, 8, 16, 16
RS_HIST, RS_FANOUT, RS_FAN_WIDTH, RS_TOPK = 6, 2, 8, 8
RS_RANK_BATCH, RS_DELAY_US, RS_MEMBERS = 32, 4000, 2
RS_STEPS, RS_BATCH, RS_SEEDS = 16, 128, (0, 1, 2)
RS_DSSM_SQ = 6                 # DSSM query slots (the ranker's history length)
RS_TREE_ITEMS = 8192           # leg B's serving tree: node codes 0..16,382, all preloaded
RS_USERS, RS_DEADLINE_MS = 1_000_000, 4000.0
RS_BASE_QPS, RS_PEAK_QPS, RS_RAMP_S, RS_TAIL_S = 15.0, 60.0, 10.0, 6.0
RS_WARM, RS_CANARY, RS_SCORED = 100, 400, 64
RS_TRAIN_BATCH, RS_DENSE_LEN = 128, 64
# the flash crowd: RS_SPIKE_XS[0] × RS_PEAK_QPS open loop (recsys_replay's
# default, x3) for RS_SPIKE_S against the post-kill fleet, the e2e p99
# objective RS_SLO_MS over 6 s / 2 s windows; the grow is awaited up to
# RS_SCALE_WAIT_S. While the rule has not fired in the crowd, the crowd goes on
# at the next multiple for up to RS_SPIKE_S more, and a step after the first
# ends at the alert: H100 hosts served x3 at e2e p99 64-283 ms and one served
# x6 at 85 ms, so a fixed crowd drove the alert, and the grow, on some hosts
# only. Each step is at most 1.5x the last one, which stayed under the
# objective, so its backlog stays far inside the deadline
RS_SPIKE_S, RS_SLO_MS = 6.0, 120.0
RS_SPIKE_XS = (3.0, 4.5, 6.0, 9.0, 12.0, 18.0, 24.0)
RS_SLO_LONG_S, RS_SLO_SHORT_S, RS_SCALE_WAIT_S = 6.0, 2.0, 45.0
# Where leg B departs from the replay's deployment, each forced by a reading on
# the H100 (PERF.md §4):
# - one member's proxy keeps up to RS_PROXY_WORKERS sub-requests in flight (a
#   socket each), so its frontend can batch them (max_batch 64). At the replay's
#   4 (spawn_member's default), one member answered 49-169 requests/s of the
#   crowd, the crowd queued in the proxy and its deadlines ran out there;
# - the process registry is reset when leg B starts: the script's earlier
#   phases left their series in it, and sampling them all took 4.95 ms a tick
#   (569 ms at worst); the replay's process holds only its own;
# - the ring takes a baseline tick before the sampler starts (below).
RS_PROXY_WORKERS = 32
# card vs CPU after RS_STEPS steps, from seeds 0-2 on the H100 (PERF.md §6):
# losses relative; params and cache columns as a share of each tensor's
# largest magnitude. GRU4Rec's and DSSM's worst: 2.4e-6 / 3.5e-6 params, 1.3e-6
# cache. TDM starts at its loss's saddle (BCE at ln 2): its gradients are sums
# that cancel, and Adam scales the rounding left in them up to a step, so
# from about step 8 of seed 2 card and CPU part (params 2.6e-3; the adagrad
# state column, values ~1e-9, 5.4e-2), while its losses stay within 3.5e-7
RS_TOL = {"gru4rec": {"loss": 1e-6, "params": 1e-5, "cache": 1e-5},
          "dssm": {"loss": 1e-6, "params": 1e-5, "cache": 1e-5},
          "tdm": {"loss": 1e-6, "params": 1e-2, "cache": 2e-1}}
RS_SCORE_TOL = 1e-5            # ranker scores, card vs CPU on the same rows


def rs_family_inputs(family, seed):
    """One family's pass keys, numpy batches and the model's constructor, all
    from ``seed``."""
    from paddle_tpu_torch.data.index_dataset import LayerWiseSampler, TreeIndex
    from paddle_tpu_torch.models.tdm import node_keys, tdm_sample_batch

    rng = np.random.default_rng(1000 * seed + {"gru4rec": 1, "dssm": 2, "tdm": 3}[family])
    B, T = RS_BATCH, RS_HIST
    out = {"batches": []}
    if family == "gru4rec":
        out["keys"] = np.arange(RS_KEYS, dtype=np.uint64)
        for _ in range(RS_STEPS):
            lengths = rng.integers(2, T + 1, B)
            out["batches"].append((rng.integers(0, RS_KEYS, (B, T)), lengths,
                                   rng.integers(0, RS_KEYS, B)))
    elif family == "dssm":
        out["keys"] = np.arange(RS_KEYS, dtype=np.uint64)
        for _ in range(RS_STEPS):
            out["batches"].append((rng.integers(0, RS_KEYS, (B, RS_DSSM_SQ + 1)),))
    else:
        tree = TreeIndex(list(range(RS_KEYS)), branch=2)
        sampler = LayerWiseSampler(tree, [1] * tree.height, seed=seed)
        leaf = np.array([int(tree.get_travel_codes(i)[0]) for i in range(RS_KEYS)])
        out["keys"] = node_keys(np.arange(tree.total_node_num()))
        out["tree"] = tree
        for _ in range(RS_STEPS):
            behav = leaf[rng.integers(0, RS_KEYS, (B, 3))]
            codes, labels = tdm_sample_batch(sampler, rng.integers(0, RS_KEYS, B))
            out["batches"].append((behav, codes, labels))
    out["embedx"] = rng.normal(scale=0.1, size=(len(out["keys"]), RS_DIM)).astype(np.float32)
    return out


def rs_model(family, seed):
    from paddle_tpu_torch.models.dssm import DSSM
    from paddle_tpu_torch.models.gru4rec import GRU4Rec
    from paddle_tpu_torch.models.tdm import TDM

    g = torch.Generator().manual_seed(seed)
    if family == "gru4rec":
        return GRU4Rec(embedx_dim=RS_DIM, hidden=RS_HIDDEN, out_dim=RS_OUT, generator=g)
    if family == "dssm":
        return DSSM(RS_DSSM_SQ, 1, RS_DIM, hidden=(64, 32), out_dim=RS_OUT, generator=g)
    return TDM(embedx_dim=RS_DIM, hidden=(64, 32), generator=g)


def rs_caches(inp, devs, backend="python", shard_num=4):
    """One host table and one cache per device over it (the rows the pass
    creates are the table's, so both caches start equal), embedx set from the
    input's numpy draw. Phase 20 runs the Python shards: RS_TOL was read on
    their rows. The native default engine seeds a new row from ``key ^ (seed
    + key % shard_num)``, so at seed 0 every aligned block of 4 keys starts
    from one embed_w (ROADMAP C12), and there card and CPU parted by 2.4e-4
    of DSSM's params' largest magnitude after RS_STEPS steps on an H100 80GB
    HBM3 at 700 W (PERF.md §6; ``recsys_parity_probe.py`` reads all three
    tables)."""
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.embedding_cache import CacheConfig, HbmEmbeddingCache
    from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
    from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

    sgd = SGDRuleConfig(learning_rate=0.05)
    table = MemorySparseTable(TableConfig(shard_num=shard_num, backend=backend,
                                          accessor_config=AccessorConfig(
                                              embedx_dim=RS_DIM, embedx_threshold=0.0, sgd=sgd)))
    cap = 1 << int(np.ceil(np.log2(len(inp["keys"]) + 1)))
    cfg = CacheConfig(capacity=cap, embedx_dim=RS_DIM, embedx_threshold=0.0, sgd=sgd)
    caches = []
    for d in devs:
        c = HbmEmbeddingCache(table, cfg, device=d)
        c.begin_pass(inp["keys"])
        rows = torch.from_numpy(c.lookup(inp["keys"])).to(d)
        c.state["embedx_w"][rows] = torch.from_numpy(inp["embedx"]).to(d)
        caches.append(c)
    return table, cfg, caches


def rs_run_family(family, inp, model, cfg, cache, dev, after_first_step=None):
    """RS_STEPS steps of one family on ``dev``. Returns (losses, params,
    cache) with params and cache columns on the host."""
    from paddle_tpu_torch.models.dssm import make_dssm_train_step
    from paddle_tpu_torch.models.gru4rec import item_keys, make_gru4rec_train_step
    from paddle_tpu_torch.models.tdm import make_tdm_train_step, node_keys
    from paddle_tpu_torch.optimizer import Adam

    opt = Adam(3e-3)
    params = {k: v.detach().clone().to(dev) for k, v in model.named_parameters()}
    opt_state = opt.init(params)
    C = cfg.capacity
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if family == "gru4rec":
        step = make_gru4rec_train_step(model, opt, cfg, device=dev)
    elif family == "dssm":
        step = make_dssm_train_step(model, opt, cfg, temperature=0.2, device=dev)
    else:
        step = make_tdm_train_step(model, opt, cfg, device=dev)
    losses = []
    for i, batch in enumerate(inp["batches"]):
        if family == "gru4rec":
            seq, lengths, target = batch
            rs = cache.lookup(item_keys(seq.reshape(-1))).reshape(seq.shape)
            rs = np.where(np.arange(RS_HIST)[None, :] >= lengths[:, None], C, rs)
            args = (to(rs), to(cache.lookup(item_keys(target))), to(lengths))
        elif family == "dssm":
            (k,) = batch
            args = (to(cache.lookup(k.reshape(-1).astype(np.uint64)).reshape(k.shape)),
                    torch.zeros((RS_BATCH, 1), device=dev),
                    torch.ones(RS_BATCH, dtype=torch.int32, device=dev))
        else:
            behav, codes, labels = batch
            args = (to(cache.lookup(node_keys(behav.reshape(-1))).reshape(behav.shape)),
                    to(cache.lookup(node_keys(codes.reshape(-1))).reshape(codes.shape)),
                    to(labels))
        params, opt_state, cache.state, loss = step(params, opt_state, cache.state, *args)
        losses.append(float(loss))
        if after_first_step is not None and i == 0:
            after_first_step()
    return (losses, {k: v.detach().cpu() for k, v in params.items()},
            {k: v.cpu() for k, v in cache.state.items()})


def rs_share(got, want):
    """max |got - want| as a share of want's largest magnitude."""
    if not want.numel():
        return 0.0
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def rs_leg_a(dev, card):
    """Leg A. Returns its record: per family and seed the card-vs-CPU
    readings, the path's B1 launches, the first push of each family, and the
    trained card models of the first seed (for leg B)."""
    from paddle_tpu_torch.models.tdm import beam_search_retrieve

    rec = {"diff": {}, "launches": {}, "b1": {}, "beam": {}, "losses": {}}
    cpu = torch.device("cpu")
    for seed in RS_SEEDS:
        for family in ("gru4rec", "dssm", "tdm"):
            inp = rs_family_inputs(family, seed)
            table, cfg, (c_dev, c_cpu) = rs_caches(inp, (dev, cpu))
            model = rs_model(family, seed)
            first = seed == RS_SEEDS[0]
            got = restore = None
            if first and dev.type == "cuda":
                got, restore = capture_first_push()
            if first:
                reset_launches()
            t0 = time.perf_counter()
            run_dev = rs_run_family(family, inp, model, cfg, c_dev, dev,
                                    after_first_step=restore)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            dev_s = time.perf_counter() - t0
            if first:
                rec["launches"][family] = read_launches()
                rec["push_" + family] = got
                rec["losses"][family] = run_dev[0]
            run_cpu = rs_run_family(family, inp, model, cfg, c_cpu, cpu)
            p_share = {k: rs_share(run_dev[1][k], run_cpu[1][k]) for k in run_cpu[1]}
            c_share = {k: rs_share(run_dev[2][k], run_cpu[2][k]) for k in run_cpu[2]}
            d = {"loss": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(run_dev[0],
                                                                            run_cpu[0])),
                 "params": max(p_share.values()), "cache": max(c_share.values()),
                 "worst": (max(p_share, key=p_share.get), max(c_share, key=c_share.get)),
                 "steps_s": dev_s}
            rec["diff"][(family, seed)] = d
            if family == "tdm":
                # the walk over the card's state against the same walk on a CPU
                # copy of it (exact), and against the CPU-trained run's (logged)
                tree = inp["tree"]
                params_dev = {k: v.to(dev) for k, v in run_dev[1].items()}
                same = types.SimpleNamespace(state={k: v for k, v in run_dev[2].items()},
                                             lookup=c_dev.lookup)
                trained = types.SimpleNamespace(state=run_cpu[2], lookup=c_cpu.lookup)
                users = [[u % RS_KEYS for u in us] for us in (
                    [0, 17, 4242], [19_999, 5, 77], [1234], [8000, 8001, 8002])]
                walks = [(beam_search_retrieve(tree, model, params_dev, c_dev, u, k=8),
                          beam_search_retrieve(tree, model, run_dev[1], same, u, k=8),
                          beam_search_retrieve(tree, model, run_cpu[1], trained, u, k=8))
                         for u in users]
                rec["beam"][seed] = {"same_state": all(a == b for a, b, _ in walks),
                                     "cpu_trained": all(a == c for a, _, c in walks),
                                     "items": [len(a) for a, _, _ in walks]}
            if first:
                rec.setdefault("trained", {})[family] = (model, {
                    k: v.to(dev) for k, v in run_dev[1].items()})
            table.close()
    return rec


def rs_check_leg_a(rec, dev, card):
    for (family, seed), d in sorted(rec["diff"].items()):
        log(f"recsys leg A, {family} seed {seed}: {RS_STEPS} steps at batch {RS_BATCH} on the "
            f"card in {d['steps_s']:.2f} s; card vs CPU: loss {d['loss']:.3e} (relative), "
            f"params {d['params']:.3e}, cache columns {d['cache']:.3e} (of each tensor's "
            f"largest magnitude; worst {d['worst'][0]}, {d['worst'][1]}) on {card}")
        for key in ("loss", "params", "cache"):
            tol = RS_TOL[family][key]
            assert d[key] <= tol, \
                f"phase 20: {family} seed {seed} {key} card vs CPU {d[key]} > {tol}"
    for seed, b in sorted(rec["beam"].items()):
        log(f"recsys leg A, TDM seed {seed}: beam (k=8) on the card == the CPU walk over the "
            f"same state {b['same_state']}; == the CPU-trained run's {b['cpu_trained']}; "
            f"items {b['items']}")
        assert b["same_state"] and all(b["items"]), f"phase 20: beam differs {b}"
    for family, ls in rec["losses"].items():
        assert np.isfinite(ls).all(), f"phase 20: {family} losses {ls}"
        log(f"recsys leg A, {family}: losses {ls[0]:.4f} -> {ls[-1]:.4f}")
    for family, n in rec["launches"].items():
        log(f"recsys leg A, {family}: launches {n} over {RS_STEPS} steps")
        if dev.type == "cuda":
            assert n["ctr_sparse_rows"] == RS_STEPS, f"phase 20: {family} B1 launches {n}"
            assert n["merge_sparse_grads"] == RS_STEPS, f"phase 20: {family} merges {n}"


# -- leg B -------------------------------------------------------------------------

def rs_gen_phase(duration, rate_fn, seed):
    """recsys_replay.gen_phase: arrival times (deterministic spacing at the
    rate), Zipf users and candidates, the user's history keys and a user
    vector."""
    g = np.random.default_rng(seed)
    ts, t = [], 0.0
    while t < duration:
        t += 1.0 / max(rate_fn(t), 1.0)
        ts.append(t)
    n = len(ts)
    users = ((g.zipf(1.2, n) - 1) % RS_USERS).astype(np.uint64)
    cand = ((g.zipf(1.3, (n, RS_FANOUT * RS_FAN_WIDTH)) - 1) % RS_KEYS).astype(np.uint64)
    mix1, mix2 = np.uint64(2654435761), np.uint64(0x9E3779B9)
    hist = ((users[:, None] * mix1 + np.arange(RS_HIST, dtype=np.uint64)[None, :] * mix2)
            % np.uint64(RS_KEYS)).astype(np.uint64)
    uv = g.standard_normal((n, RS_DIM)).astype(np.float32)
    return np.asarray(ts), hist, cand, uv


def rs_replay(pipe, phase, mid_hook=None, answers=None, stop=None):
    """Open loop: request i is submitted at ts[i] whatever the earlier ones
    did, until `stop()` (if given) is true; 8 threads collect. Returns the
    requests submitted, errors, late arrivals, wall s, and whether every
    answer was best-first."""
    import queue
    import threading

    ts, hist, cand, uv = phase
    q, errors, order_ok = queue.Queue(), [], [True]

    def collect():
        while True:
            item = q.get()
            if item is None:
                return
            i, pr = item
            try:
                keys, scores = pr.result(RS_DEADLINE_MS / 1e3 + 10)
                if not (np.diff(scores) <= 0).all():
                    order_ok[0] = False
                if answers is not None:
                    answers[i] = (keys, scores)
            except Exception as e:  # noqa: BLE001 — counted
                errors.append(e)

    threads = [threading.Thread(target=collect, name=f"rs-collect-{c}") for c in range(8)]
    for th in threads:
        th.start()
    late, start, sent = 0, time.perf_counter(), 0
    try:
        for i in range(len(ts)):
            if stop is not None and stop():
                break
            sent = i + 1
            target = start + ts[i]
            now = time.perf_counter()
            if target > now:
                time.sleep(target - now)
            elif now - target > 0.05:
                late += 1
            if mid_hook is not None and i == len(ts) // 2:
                mid_hook()
            try:
                q.put((i, pipe.submit(uv[i], hist[i], cand[i])))
            except Exception as e:  # noqa: BLE001 — a shed at admission, counted
                errors.append(e)
    finally:
        for _ in threads:
            q.put(None)
        for th in threads:
            th.join()
    return {"requests": sent, "errors": len(errors), "late": late,
            "wall_s": time.perf_counter() - start, "best_first": order_ok[0],
            "first_error": repr(errors[0]) if errors else None}


def rs_arm(pipe, router, phase, **kw):
    """One arm: the replay's client-side record, the pipeline's counters as
    deltas, its latency windows reset."""
    keys = ("served", "errors", "early_cuts", "stragglers_abandoned", "stragglers_late",
            "fan_failures", "rank_batches", "coalesced", "rank_deadline_dropped",
            "deadline_misses", "shed")
    s0, h0, r0 = pipe.stats(), router.counters["hedges"], router.counters["reroutes"]
    for r in (pipe.e2e_latency, pipe.stage_retrieval, pipe.stage_ranking):
        r.reset()
    out = rs_replay(pipe, phase, **kw)
    s1 = pipe.stats()
    # "errors" stays the requests that failed at the client (a deadline run
    # out in the ranking queue among them); the pipeline's own counter of
    # that name is "pipe_errors"
    out.update({("pipe_errors" if k == "errors" else k): int(s1[k] - s0[k]) for k in keys})
    out.update(e2e=s1["e2e_ms"], retrieval=s1["stage_retrieval_ms"],
               ranking=s1["stage_ranking_ms"], rps=(out["requests"] - out["errors"])
               / out["wall_s"], hedges=int(router.counters["hedges"] - h0),
               reroutes=int(router.counters["reroutes"] - r0))
    out["coalesce_factor"] = out["coalesced"] / max(out["rank_batches"], 1)
    return out


def rs_copy_ms(dev, B):
    """Median ms of one ranking batch's copies at B requests: the gathered rows
    [B*(H+K), 1+dim] card→host (the cached lookup's result), the ranker's
    [B, H, d] and [B, K, d] host→card, and its [B, K] scores card→host."""
    d = 1 + RS_DIM
    rows = torch.randn(B * (RS_HIST + RS_TOPK), d, device=dev)
    hist = np.zeros((B, RS_HIST, d), np.float32)
    cand = np.zeros((B, RS_TOPK, d), np.float32)
    scores = torch.randn(B, RS_TOPK, device=dev)

    def once():
        rows.cpu().numpy()
        torch.from_numpy(hist).to(dev)
        torch.from_numpy(cand).to(dev)
        scores.cpu().numpy()

    out = []
    for _ in range(23):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        once()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out[3:]))


def rs_leg_b(dev, card, leg_a):
    """Leg B (see the section's comment). Returns its record."""
    import random
    import tempfile
    import threading
    import urllib.request

    from paddle_tpu_torch.convert import ravel_tree
    from paddle_tpu_torch.data.dataset import QueueDataset, SlotDesc
    from paddle_tpu_torch.data.index_dataset import TreeIndex
    from paddle_tpu_torch.distributed.elastic import FileStore
    from paddle_tpu_torch.io.fs import crc32c
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
    from paddle_tpu_torch.models.dssm import make_dssm_ranker
    from paddle_tpu_torch.models.gru4rec import make_gru4rec_ranker
    from paddle_tpu_torch.models.tdm import ServingBeamSource, beam_search_retrieve
    from paddle_tpu_torch.obs import registry as obs_registry
    from paddle_tpu_torch.obs import slo, timeseries
    from paddle_tpu_torch.obs.exporter import ObsExporter, parse_openmetrics
    from paddle_tpu_torch.obs.trace import wall_s
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.autoscale import AutoscaleConfig, Autoscaler
    from paddle_tpu_torch.ps.communicator import HalfAsyncCommunicator
    from paddle_tpu_torch.ps.ha import HACluster
    from paddle_tpu_torch.ps.hot_tier import HotEmbeddingTier, HotTierConfig
    from paddle_tpu_torch.ps.ps_trainer import CtrStreamTrainer
    from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
    from paddle_tpu_torch.ps.table import TableConfig
    from paddle_tpu_torch.serving import (CachedLookup, FleetConfig, FreshnessProbe,
                                          PipelineConfig, PipelineFrontend, RolloutManager,
                                          RouterConfig, ServingFleet, ServingReplica,
                                          ServingRouter, spawn_member)

    rec = {}
    # leg B's series alone in the registry, as in the replay's own process
    obs_registry.REGISTRY.reset()
    xd, S, D = RS_DIM, 8, 4
    cfg = TableConfig(shard_num=4, accessor_config=AccessorConfig(
        embedx_dim=xd, embedx_threshold=0.0, sgd=SGDRuleConfig(initial_range=0.01)))
    cap = 1 << int(np.ceil(np.log2(max(RS_KEYS * 1.8, 1 << 12))))
    base = tempfile.mkdtemp(prefix="chip_smoke_recsys_")
    store_dir = os.path.join(base, "store")
    os.makedirs(store_dir)
    rng = np.random.default_rng(0)
    cluster = HACluster(num_shards=1, replication=1, store=FileStore(store_dir), sync=False)
    fleet = router = pipe = rep = comm = sampler = scaler = exporter = None
    stop_train, stop_probe = threading.Event(), threading.Event()
    threads = []
    try:
        train_cli = cluster.client()
        train_cli.create_sparse_table(0, cfg)
        keys = np.arange(RS_KEYS, dtype=np.uint64)
        t = time.perf_counter()
        width = None
        for lo in range(0, RS_KEYS, 1 << 15):
            kc = keys[lo:lo + (1 << 15)]
            train_cli.pull_sparse(0, kc)
            width = width or train_cli._dims(0)[1]
            push = np.zeros((len(kc), width), np.float32)
            push[:, 1] = 1.0
            push[:, 3:] = 0.01 * rng.standard_normal((len(kc), width - 3)).astype(np.float32)
            train_cli.push_sparse(0, kc, push)
        rec["preload_s"] = time.perf_counter() - t
        # the parent-side ranking stack: its own read replica and a tier on the card
        rep = ServingReplica(cluster.store, cluster.job_id, shard=0, hb_interval=0.05,
                             hb_ttl=10.0)
        serve = rep.client()
        view = rep.serve_view(0, cfg, client=serve)

        def caught_up():
            return cluster.digests(0, 0).get(cluster.primary(0).endpoint) == serve.digest(0)[0]

        phase_wait(caught_up, "phase 20: the parent's replica never caught up")
        tier = HotEmbeddingTier(view, HotTierConfig(capacity=cap, create_on_miss=False),
                                device=dev)
        lookup = CachedLookup(tier, replica=rep, freshness_budget_s=30.0)
        gru, gru_params = leg_a["trained"]["gru4rec"]
        gru_rank = make_gru4rec_ranker(gru, gru_params, device=dev)
        scored, rank_ms, gather_ms = [], [], []

        def ranker(hist, lengths, cand):
            t0 = time.perf_counter()
            out = gru_rank(hist, lengths, cand)       # copies in, GRU, scores back
            rank_ms.append((time.perf_counter() - t0) * 1e3)
            if len(scored) < RS_SCORED:
                scored.append((hist.copy(), lengths.copy(), cand.copy(), out.copy()))
            return out

        class TimedLookup:
            """The ranking stage's gather, timed (the pipeline's only call)."""

            def lookup(self, keys):
                t0 = time.perf_counter()
                out = lookup.lookup(keys)
                gather_ms.append((time.perf_counter() - t0) * 1e3)
                return out

        # the fleet: member processes on the card, a router, the rollout plane
        t = time.perf_counter()

        def make_member():
            return spawn_member(f"file:{store_dir}", cluster.job_id, embedx_dim=xd,
                                shard_num=4, capacity=cap, dense_len=RS_DENSE_LEN,
                                max_batch=64, max_delay_us=1000, freshness_budget_s=2.0,
                                default_deadline_ms=RS_DEADLINE_MS, prime_pow2_max=RS_FAN_WIDTH,
                                hb_ttl=10.0, proxy_workers=RS_PROXY_WORKERS, device=dev.type)

        router = ServingRouter(RouterConfig(block_shift=6, hedge_default_ms=25.0,
                                            hedge_floor_ms=10.0), rng=random.Random(0))
        fleet = ServingFleet(cluster.store, cluster.job_id, make_member, router,
                             config=FleetConfig(poll_s=0.25, warm_handoff=False,
                                                min_replicas=1, max_replicas=6)).start()
        rollout = RolloutManager(lambda: fleet.members(), router)
        fleet.rollout = rollout
        rngp = np.random.default_rng(7)
        flat_v1 = 0.1 * rngp.standard_normal(RS_DENSE_LEN).astype(np.float32)
        flat_v2 = flat_v1 + np.float32(0.01)
        dg_v1 = crc32c(np.ascontiguousarray(flat_v1).tobytes())
        rollout.register_baseline(flat_v1)

        def serving(members):
            """Each member answers one request through its own frontend: the
            event that proves it serves before traffic relies on it."""
            for m in members:
                out = m.frontend.submit(np.arange(RS_FAN_WIDTH, dtype=np.uint64),
                                        deadline_ms=RS_DEADLINE_MS).result(30.0)
                assert out.shape == (RS_FAN_WIDTH, 1 + xd), (m.endpoint, out.shape)
            return wall_s()

        serving(fleet.add(RS_MEMBERS))
        rec["spawn_s"] = time.perf_counter() - t
        pipe = PipelineFrontend(router, TimedLookup(), ranker=ranker, config=PipelineConfig(
            default_deadline_ms=RS_DEADLINE_MS, retrieval_frac=0.5, fanout=RS_FANOUT,
            fan_width=RS_FAN_WIDTH, early_cut_frac=0.5, topk=RS_TOPK,
            rank_max_batch=RS_RANK_BATCH, rank_max_delay_us=RS_DELAY_US, queue_cap=8192),
            idle_pop_s=0.005, name="recsys")
        # the stream trainer (the load beside the serving: fresh rows on the feed)
        slots = ([SlotDesc(f"s{i}", is_float=False, max_len=1) for i in range(S)]
                 + [SlotDesc(f"d{i}", is_float=True, max_len=1) for i in range(D)]
                 + [SlotDesc("label", is_float=True, max_len=1)])
        comm_cli = cluster.client()
        comm_cli.create_sparse_table(0, cfg)
        comm = HalfAsyncCommunicator(comm_cli)
        comm.start()
        trainer = CtrStreamTrainer(
            DeepFM(CtrConfig(num_sparse_slots=S, num_dense=D, embedx_dim=xd,
                             dnn_hidden=(32, 32)), generator=torch.Generator().manual_seed(0)),
            Adam(1e-3), None, embedx_dim=xd, sparse_slots=[f"s{i}" for i in range(S)],
            dense_slots=[f"d{i}" for i in range(D)], label_slot="label", communicator=comm,
            table_id=0, device=dev)
        hot_ids = rng.choice(RS_KEYS, 2000, replace=False)
        trng = np.random.default_rng(11)
        rounds = [0]

        def train_round():
            lines = []
            for _ in range(RS_TRAIN_BATCH):
                ids = trng.choice(hot_ids, S)
                dense = trng.normal(size=D)
                label = int((ids % 5 == 0).sum() + dense[0] > 1.0)
                lines.append(" ".join([f"1 {v}" for v in ids] + [f"1 {v:.4f}" for v in dense]
                                      + [f"1 {label}"]))
            path = os.path.join(base, f"stream_{rounds[0] % 2}.txt")
            with open(path, "w") as f:
                f.write("\n".join(lines))
            ds = QueueDataset(slots)
            ds.set_filelist([path])
            trainer.train_from_dataset(ds, batch_size=RS_TRAIN_BATCH, drop_last=False)
            rounds[0] += 1

        def train_loop():
            while not stop_train.is_set():
                train_round()
                stop_train.wait(0.25)

        train_round()
        # the fleet-wide freshness prober (recsys_replay's): a marker key's embed_w
        # rises on every write; a member is fresh once it serves the primary's value
        probe_cli = cluster.client()
        probe_cli.create_sparse_table(0, cfg)
        marker = np.asarray([np.uint64(1) << np.uint64(41)], np.uint64)
        probe_cli.pull_sparse(0, marker)
        truth, fresh, fresh_fail, probe_skips, probes = [0.0], [], [0], [0], {}

        def write_marker():
            mp = np.zeros((1, width), np.float32)
            mp[0, 1], mp[0, 3] = 1.0, -1.0
            probe_cli.push_sparse(0, marker, mp)
            truth[0] = float(probe_cli.pull_sparse(0, marker)[0, 2])

        def probe_loop():
            idx = 0
            while not stop_probe.is_set():
                members = fleet.members()
                if not members:
                    stop_probe.wait(0.2)
                    continue
                m = members[idx % len(members)]
                idx += 1
                pr = probes.setdefault(m.endpoint, FreshnessProbe(
                    timeout_s=5.0, poll_s=0.002, replica=m.endpoint))
                pk = np.full(RS_FAN_WIDTH, marker[0], np.uint64)

                def read(m=m, pk=pk):
                    return float(m.frontend.submit(pk, deadline_ms=1500.0).result(3.0)[0, 0])

                try:
                    dt = pr.measure(write_marker, read, lambda v: v >= truth[0] - 1e-7)
                    (fresh.append(dt) if dt is not None else fresh_fail.__setitem__(
                        0, fresh_fail[0] + 1))
                except Exception:  # noqa: BLE001 — a member died mid-probe
                    probe_skips[0] += 1
                stop_probe.wait(0.3)

        # warm pass (off the record), then the measured arms
        rs_replay(pipe, rs_gen_phase(RS_WARM / RS_PEAK_QPS, lambda t: RS_PEAK_QPS, seed=1))
        pipe.reset_stats()
        router.latency.reset()
        del rank_ms[:], gather_ms[:]
        # the control plane starts after the warm pass (its stragglers would sit
        # in the SLO windows): ring <- sampler -> watchdog -> autoscaler
        ring = timeseries.MetricRing(8192)
        # the baseline tick: a ring diffs each tick against the one before, and
        # its first sight of a series takes the whole count as that tick's
        # delta, so without a baseline the warm pass's observations would land
        # in the first tick, inside both windows (they fired the rule before
        # the kill on the H100). The baseline sits one long window and a second
        # in the past, outside them
        ring.append(obs_registry.snapshot(), t=wall_s() - RS_SLO_LONG_S - 1.0)
        sampler = timeseries.Sampler(period_s=0.25, ring=ring)
        wd = slo.SloWatchdog(ring, slo.recsys_rules(
            e2e_p99_s=RS_SLO_MS / 1e3, freshness_training_p95_s=5.0, long_s=RS_SLO_LONG_S,
            short_s=RS_SLO_SHORT_S))
        wd.attach(sampler)
        scaler = Autoscaler(fleet.controller(), watchdog=wd, ring=ring, config=AutoscaleConfig(
            min_shards=1, max_shards=6, factor=2, up_rules=("recsys_e2e_p99",),
            cooldown_up_s=30.0, cooldown_down_s=3600.0, clear_hold_s=3600.0), poll_s=0.25)
        # the autoscaler's thread starts at the flash crowd (below)
        sampler.start()
        threads = [threading.Thread(target=train_loop, name="rs-trainer"),
                   threading.Thread(target=probe_loop, name="rs-freshness")]
        for th in threads:
            th.start()
        victim = fleet.members()[-1]
        after_kill = []

        def kill():
            victim.crash()
            after_kill.append(fleet.size())

        rec["ramp"] = rs_arm(pipe, router, rs_gen_phase(
            RS_RAMP_S, lambda t: RS_BASE_QPS + (RS_PEAK_QPS - RS_BASE_QPS)
            * float(np.sin(0.5 * np.pi * min(t / RS_RAMP_S, 1.0))), seed=2), mid_hook=kill)
        rec["killed"] = victim.endpoint
        rec["size_after_kill"] = after_kill[0]

        def grown():
            return [e for e in scaler.events if e.get("kind") == "scale"
                    and e.get("direction") == "up"]

        # the flash crowd. On a slow host the ramp after the kill can breach
        # the objective by itself (an H100 host read e2e p99 753 ms there):
        # so the crowd starts once the rule is clear, and the autoscaler's
        # thread with it, and the grow it makes answers the crowd's alert.
        # Then the rule over windows that end with the crowd (the long one
        # as long as the crowd): whether the crowd alone burns the
        # objective. t1 is taken after the tick that evaluates its last window
        rule = next(r for r in wd.rules if r.name == "recsys_e2e_p99")
        rec["ramp_alerts"] = [a for a in wd.alerts() if a["rule"] == rule.name]
        phase_wait(lambda: rule.name not in wd.active(),
                   "recsys_e2e_p99 never cleared after the ramp", timeout=30.0)
        before = {m.endpoint for m in fleet.members()}
        scaler.start()
        t0 = wall_s()
        # the crowd's steps (RS_SPIKE_XS): the next runs only while the rule
        # has not fired since the crowd began (it was clear at t0), and ends
        # at the alert; the first runs whole, as the replay's crowd
        rec["spike_steps"] = []
        for i, x in enumerate(RS_SPIKE_XS):
            step = rs_arm(pipe, router, rs_gen_phase(
                RS_SPIKE_S, lambda t, x=x: RS_PEAK_QPS * x, seed=3 + 100 * i),
                stop=(lambda: rule.name in wd.active()) if i else None)
            sampler.tick()
            step["x"] = x
            rec["spike_steps"].append(step)
            if any(a["rule"] == rule.name and a["t"] >= t0 for a in wd.alerts()):
                break
        rec["spike"] = dict(step, t0=t0, t1=wall_s(), burn=rule.evaluate(ring, wall_s()))
        # the grow decision may land while the spike still drains: wait for the
        # journal (a member spawn is a process bring-up), with the replay's back-off
        deadline, delay = time.perf_counter() + RS_SCALE_WAIT_S, 0.1
        while not grown() and time.perf_counter() < deadline:
            time.sleep(delay)
            delay = min(delay * 1.5, 1.0)
        new = [m for m in fleet.members() if m.endpoint not in before]
        rec["alerts"] = wd.alerts()
        rec["scale_events"] = [dict(e) for e in scaler.events
                               if e.get("kind", "").startswith("scale")]
        rec["new_members"] = [m.endpoint for m in new]
        rec["t_serving"] = serving(new) if new else None
        rec["size_after_spike"] = fleet.size()
        # the tail on the grown fleet, the exporter scraped once in its middle
        exporter = ObsExporter(obs_registry.snapshot, ring=ring, alerts_fn=wd.alerts).start()
        scrape = {}

        def scrape_once():
            with urllib.request.urlopen(exporter.url + "/metrics", timeout=10) as resp:
                scrape["families"] = parse_openmetrics(resp.read().decode())
            with urllib.request.urlopen(exporter.url + "/alerts.json", timeout=10) as resp:
                scrape["alerts"] = json.load(resp)["alerts"]

        scraper = threading.Thread(target=scrape_once, name="rs-scrape")
        rec["tail"] = rs_arm(pipe, router, rs_gen_phase(RS_TAIL_S, lambda t: RS_PEAK_QPS,
                                                       seed=4), mid_hook=scraper.start)
        scraper.join(30)
        rec["scrape"] = {"families": len(scrape.get("families", {})),
                         "e2e_series": sum(
                             1 for _, lbl, _ in scrape.get("families", {}).get(
                                 "serving_latency_s", {"samples": []})["samples"]
                             if lbl.get("recorder") == "recsys_e2e"),
                         "alerts": [a["rule"] for a in scrape.get("alerts", [])]}
        scaler.stop()
        sampler.stop()
        # the control plane's own costs: a sampler tick (snapshot + ring append,
        # its obs_sample_duration_s gauge), one watchdog evaluation of the three
        # rules over the ring, one autoscaler decision (in its cooldown: no
        # actuation), host ms each
        ticks = [v * 1e3 for _, v in ring.series("obs_sample_duration_s", "value",
                                                 labels={"sampler": "obs-sampler"})]
        costs = {"eval": [], "decide": []}
        for _ in range(20):
            t0 = time.perf_counter()
            wd.evaluate(now=wall_s())
            costs["eval"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            scaler.step()
            costs["decide"].append((time.perf_counter() - t0) * 1e3)
        rec["sampler"] = {"ticks": sampler.ticks, "errors": sampler.errors,
                          "evaluations": wd.evaluations, "ring": len(ring),
                          "tick_ms": (float(np.median(ticks)), float(np.max(ticks)))
                          if ticks else None,
                          "eval_ms": float(np.median(costs["eval"])),
                          "decide_ms": float(np.median(costs["decide"]))}
        stop_probe.set()
        stop_train.set()
        for th in threads:
            th.join(120)
        assert not any(th.is_alive() for th in threads), "phase 20: trainer or prober hung"
        fresh.sort()
        rec["freshness"] = {
            "probes": len(fresh) + fresh_fail[0], "failures": fresh_fail[0],
            "skipped": probe_skips[0], "rounds": rounds[0],
            "p50_s": fresh[len(fresh) // 2] if fresh else None,
            "p95_s": fresh[min(int(len(fresh) * 0.95), len(fresh) - 1)] if fresh else None}
        # the crash: the dead member's lease lapses and the watch removes it
        phase_wait(lambda: fleet.counters["crashes_removed"] >= 1,
                   "the crashed member was never removed", timeout=30.0)
        rec["crashes_removed"] = fleet.counters["crashes_removed"]
        # canary, promote, rollback over the wire: a canary needs a stable member
        # beside the band. The grow left two; only if the flash crowd never grew
        # the fleet does an operator top it up first, as the replay does
        rec["topup"] = None
        if fleet.size() < 2:
            t = time.perf_counter()
            log(f"recsys leg B: the flash crowd left {fleet.size()} member(s); topping the "
                f"fleet up to 2 for the canary")
            serving(fleet.add(2 - fleet.size()))
            rec["topup"] = time.perf_counter() - t
        v1 = rollout.current
        v2 = rollout.begin_canary(flat_v2, fraction=0.2)
        c0 = dict(router.stats()["version_counts"])
        rec["canary"] = rs_arm(pipe, router, rs_gen_phase(RS_CANARY / RS_PEAK_QPS,
                                                         lambda t: RS_PEAK_QPS, seed=5))
        rec["version_counts"] = {k: v - c0.get(k, 0)
                                 for k, v in router.stats()["version_counts"].items()}
        rollout.promote()
        rec["promoted"] = set(rollout.fleet_versions().values()) == {
            (v2, rollout.version_digest(v2))}
        rollout.rollback(reason="phase 20")
        back = rollout.fleet_versions()
        rec["rollback_ok"] = set(back.values()) == {(v1, dg_v1)} and len(back) == fleet.size()
        rec["rollback_members"] = len(back)
        rec["pipeline"] = pipe.stats()
        pipe.stop()
        rec["rank_ms"] = (float(np.median(rank_ms)), float(np.percentile(rank_ms, 99)))
        rec["gather_ms"] = (float(np.median(gather_ms)), float(np.percentile(gather_ms, 99)))
        # the sampled ranking batches against the CPU ranker on the same rows
        cpu_rank = make_gru4rec_ranker(gru, {k: v.cpu() for k, v in gru_params.items()},
                                       device="cpu")
        rec["scored"] = len(scored)
        rec["score_err"] = max(float(np.abs(cpu_rank(h, l, c) - s).max())
                               for h, l, c, s in scored)
        # the DSSM ranker and a TDM walk through ServingBeamSource, on the card and
        # the CPU, over the parent's lookup (the feed idle and caught up)
        phase_wait(caught_up, "phase 20: the parent's replica never caught up after training")
        dssm, dssm_params = leg_a["trained"]["dssm"]
        g = np.random.default_rng(9)
        hk = g.integers(0, RS_KEYS, (RS_RANK_BATCH, RS_DSSM_SQ)).astype(np.uint64)
        ck = g.integers(0, RS_KEYS, (RS_RANK_BATCH, RS_TOPK)).astype(np.uint64)
        hist = lookup.lookup(hk.reshape(-1)).reshape(RS_RANK_BATCH, RS_DSSM_SQ, -1)
        cand = lookup.lookup(ck.reshape(-1)).reshape(RS_RANK_BATCH, RS_TOPK, -1)
        lens = np.full(RS_RANK_BATCH, RS_DSSM_SQ, np.int32)
        on_dev = make_dssm_ranker(dssm, dssm_params, device=dev)(hist, lens, cand)
        on_cpu = make_dssm_ranker(dssm, {k: v.cpu() for k, v in dssm_params.items()},
                                  device="cpu")(hist, lens, cand)
        rec["dssm_err"] = float(np.abs(on_dev - on_cpu).max())
        tdm, tdm_params = leg_a["trained"]["tdm"]
        tree = TreeIndex(list(range(RS_TREE_ITEMS)), branch=2)
        users = [list(g.integers(0, RS_TREE_ITEMS, 3)) for _ in range(4)]
        src_dev = ServingBeamSource(lookup, device=dev)
        src_cpu = ServingBeamSource(lookup, device="cpu")
        cpu_params = {k: v.cpu() for k, v in tdm_params.items()}
        walks = [(beam_search_retrieve(tree, tdm, tdm_params, src_dev, u, k=8),
                  beam_search_retrieve(tree, tdm, cpu_params, src_cpu, u, k=8)) for u in users]
        rec["tdm_same"] = all(a == b for a, b in walks)
        rec["tdm_items"] = [len(a) for a, _ in walks]
        rec["tdm_flushes"] = (src_dev.flushes, src_cpu.flushes)
        rec["members"] = fleet.size()
        return rec
    finally:
        stop_probe.set()
        stop_train.set()
        for th in threads:
            if th.is_alive():
                th.join(60)
        for part in (exporter, scaler, sampler):
            if part is not None:
                part.stop()
        if pipe is not None:
            pipe.stop()
        if comm is not None:
            comm.stop()
        if fleet is not None:
            fleet.stop()
        if router is not None:
            router.stop()
        if rep is not None:
            rep.close()
        cluster.stop()
        shutil.rmtree(base, ignore_errors=True)


def phase_recsys(dev, card):
    """Phase 20 (see the section's comment). Returns (the path's launches, B1's
    numbers on GRU4Rec's first push)."""
    t_phase = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    a = rs_leg_a(dev, card)
    leg_a_s = time.perf_counter() - t
    rs_check_leg_a(a, dev, card)
    b1 = None
    if dev.type == "cuda":
        for family in ("gru4rec", "dssm", "tdm"):
            r = wd_b1_check(a["push_" + family], dim=RS_DIM, what=f"{family} push")
            if family == "gru4rec":
                b1 = r
    launches = sum(n["ctr_sparse_rows"] for n in a["launches"].values())
    t = time.perf_counter()
    b = rs_leg_b(dev, card, a)
    leg_b_s = time.perf_counter() - t
    arms = [("ramp", b["ramp"]), *((f"spike x{r['x']:g}", r) for r in b["spike_steps"]),
            ("tail", b["tail"]), ("canary", b["canary"])]
    for name, r in arms:
        log(f"recsys leg B, {name}: {r['requests']} requests open-loop, {r['rps']:.1f} "
            f"requests/s, errors {r['errors']} (first {r['first_error']}), e2e p50 "
            f"{r['e2e']['p50_ms']} ms p99 {r['e2e']['p99_ms']} ms, retrieval p50 "
            f"{r['retrieval']['p50_ms']} ms p99 {r['retrieval']['p99_ms']} ms, ranking p50 "
            f"{r['ranking']['p50_ms']} ms p99 {r['ranking']['p99_ms']} ms, {r['rank_batches']} "
            f"ranking batches (coalesce factor {r['coalesce_factor']:.3f}), stragglers "
            f"abandoned {r['stragglers_abandoned']} late {r['stragglers_late']}, fan failures "
            f"{r['fan_failures']}, hedges {r['hedges']}, reroutes {r['reroutes']}, late "
            f"arrivals {r['late']}, best first {r['best_first']} on {card}")
    spike = b["spike"]
    fired = [a for a in b["alerts"] if a["rule"] == "recsys_e2e_p99"]
    # the alerts that fired in the crowd (the first of them is what the
    # autoscaler, started with the crowd, answered); from its start to that one
    crowd = [a for a in fired if spike["t0"] <= a["t"] <= spike["t1"]]
    ups = [e for e in b["scale_events"] if e["kind"] == "scale" and e["direction"] == "up"]
    to_alert = crowd[0]["t"] - spike["t0"] if crowd else None
    # the grow's journal entry is written once fleet.add returned: the member
    # printed MEMBER_READY (its socket serves) and the router routes to it
    to_serving = (ups[0]["wall_s"] - crowd[0]["t"]) if crowd and ups else None
    steps = " then ".join(f"{r['x']:g}" for r in b["spike_steps"])
    log(f"recsys leg B, flash crowd: {steps} x RS_PEAK_QPS, "
        f"{RS_SPIKE_S:g} s a step; its last step {spike['x'] * RS_PEAK_QPS:.0f} requests/s "
        f"offered ({spike['rps']:.1f} served/s), e2e p50 {spike['e2e']['p50_ms']} ms p99 "
        f"{spike['e2e']['p99_ms']} ms against the {RS_SLO_MS:g} ms objective, errors "
        f"{spike['errors']} (the pipeline's {spike['pipe_errors']}); recsys_e2e_p99 fired "
        f"{len(b['ramp_alerts'])} time(s) in the ramp (e2e p99 {b['ramp']['e2e']['p99_ms']} "
        f"ms) and {len(crowd)} in the crowd, "
        f"{to_alert if to_alert is None else round(to_alert, 3)} s after its start (windows "
        f"{crowd[0]['windows'] if crowd else None}); the rule over "
        f"the crowd's own windows at its end: {spike['burn']}; scale events "
        f"{[(e['kind'], e['direction'], e['from_shards'], e['to_shards'], e.get('bootstrap_s')) for e in b['scale_events']]}; "
        f"new member(s) {b['new_members']} routed "
        f"{to_serving if to_serving is None else round(to_serving, 3)} s after the alert "
        f"(and answering a request of its own at +"
        f"{None if not (crowd and b['t_serving']) else round(b['t_serving'] - crowd[0]['t'], 3)}"
        f" s, after the spike); "
        f"fleet {RS_MEMBERS} -> {b['size_after_kill']} after the kill -> "
        f"{b['size_after_spike']} after the spike; top-up {b['topup']}; control plane "
        f"{b['sampler']}; exporter scrape in the tail: {b['scrape']} on {card}")
    p = b["pipeline"]
    copy = {B: rs_copy_ms(dev, B) for B in (1, RS_RANK_BATCH)}
    log(f"recsys leg B: preload {b['preload_s']:.2f} s, {RS_MEMBERS} member processes up in "
        f"{b['spawn_s']:.2f} s, member {b['killed']} SIGKILLed mid-ramp and removed by the "
        f"lease watch ({b['crashes_removed']}); freshness under "
        f"training {b['freshness']}; canary split {b['version_counts']}, promoted "
        f"{b['promoted']}, v1 restored on {b['rollback_members']} members {b['rollback_ok']}; "
        f"coalesce factor over the leg {p.get('coalesce_factor')}; {b['scored']} ranking "
        f"batches vs the CPU ranker max_abs {b['score_err']:.3e}; DSSM ranker card vs CPU "
        f"max_abs {b['dssm_err']:.3e}; TDM walk card == CPU {b['tdm_same']} (items "
        f"{b['tdm_items']}, flushes {b['tdm_flushes']}); a ranking batch's gather p50/p99 "
        f"{b['gather_ms'][0]:.3f}/{b['gather_ms'][1]:.3f} ms and ranker call "
        f"{b['rank_ms'][0]:.3f}/{b['rank_ms'][1]:.3f} ms; its host<->card copies "
        f"{copy[1]:.4f} ms at 1 request, {copy[RS_RANK_BATCH]:.4f} ms at {RS_RANK_BATCH} "
        f"on {card}")
    for name, r in arms:
        assert r["errors"] == 0, f"phase 20: {name} errors {r}"
        assert r["best_first"], f"phase 20: {name} answers not best first"
    # the alert behind the grow fired in the crowd
    assert crowd, f"phase 20: recsys_e2e_p99 did not fire in the crowd " \
        f"({spike['t0']}-{spike['t1']}): {b['alerts']}"
    assert all(e["wall_s"] >= crowd[0]["t"] for e in ups), (crowd, ups)
    assert spike["burn"][0], f"phase 20: the flash crowd alone does not burn {spike['burn']}"
    assert len(ups) == 1, f"phase 20: scale-up events {b['scale_events']}"
    assert b["size_after_spike"] > b["size_after_kill"], \
        f"phase 20: fleet {b['size_after_kill']} -> {b['size_after_spike']}"
    assert b["new_members"] and b["t_serving"] is not None, "phase 20: no grown member served"
    assert b["scrape"]["families"] > 0 and b["scrape"]["e2e_series"] > 0, b["scrape"]
    assert "recsys_e2e_p99" in b["scrape"]["alerts"], b["scrape"]
    assert p["coalesced"] > p["rank_batches"], f"phase 20: coalesce factor {p}"
    assert p["stragglers_abandoned"] > 0, f"phase 20: no straggler counted {p}"
    assert b["crashes_removed"] == 1
    assert b["promoted"] and b["rollback_ok"], "phase 20: v1 was not restored on every member"
    assert b["freshness"]["p95_s"] is not None, f"phase 20: freshness {b['freshness']}"
    assert b["score_err"] <= RS_SCORE_TOL and b["dssm_err"] <= RS_SCORE_TOL, \
        (b["score_err"], b["dssm_err"])
    assert b["tdm_same"] and all(b["tdm_items"]) and b["tdm_flushes"] == (0, 0), b["tdm_items"]
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30) if dev.type == "cuda" else float("nan")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"recsys serve path (phase 20): {time.perf_counter() - t_phase:.1f} s (leg A "
        f"{leg_a_s:.1f} s, leg B {leg_b_s:.1f} s), ctr_sparse_rows launches on the path "
        f"{launches}, peak device memory {peak:.2f} GiB on {card}")
    return launches, b1


# -- phase 21: ERNIE over a dp×pp×cp×mp mesh of logical ranks ------------------

HYB_MESH = {"dp": 1, "pp": 2, "cp": 2, "mp": 2}       # leg A (and B)
HYB_MOE_MESH = {"dp": 2, "pp": 2, "cp": 1, "mp": 2}   # leg C: ep rides dp
HYB_MICRO, HYB_WARM, HYB_STEPS, HYB_MOE_STEPS = 2, 2, 6, 4
HYB_SMALL = dict(vocab_size=1024, hidden_size=64, num_heads=4, ffn_size=128, num_layers=2,
                 max_seq_len=64)
HYB_SMALL_BATCH, HYB_SMALL_STEPS = 4, 3
# leg B, card (the kernels) vs CPU (their plain versions) after 3 steps:
# the first loss (relative) and each tensor's update ||Δcard − Δcpu|| /
# ||Δcpu|| (the key bias left out, as phase 8 does)
HYB_TOL = {"loss": 1e-4, "update": 5e-2}
HYB_REPEAT = 3                # leg A's steps run again by a second trainer of the same seed
RING_HOP = (4, 256, 8, 64)    # leg A's hop: [B/(dp·M), L/cp, H/mp, D]


def hybrid_launches_per_step(cfg, shape, micro):
    """Flash launches a step of the hybrid trainer: every rank runs every
    tick (M + pp − 1) through its stage's blocks, each attention a ring of
    cp hops (B5 once a hop); the backward runs B6 and B7 once for each
    forward call that reaches the loss, the M valid ticks of each rank."""
    ranks = int(np.prod(list(shape.values())))
    bps, hops, ticks = cfg.num_layers // shape["pp"], shape["cp"], micro + shape["pp"] - 1
    bwd = ranks * micro * bps * hops
    return {"flash_attention_fwd": ranks * ticks * bps * hops,
            "flash_attention_bwd_dq": bwd, "flash_attention_bwd_dkv": bwd}


def hybrid_batch(rng, vocab, batch, seq, dev):
    return tuple(torch.from_numpy(rng.integers(0, vocab, (batch, seq))).to(dev)
                 for _ in range(2))


def hybrid_leg_a(dev, card, serial):
    """Full width, causal, ``{"dp": 1, "pp": 2, "cp": 2, "mp": 2}``: 2 warm-up
    and 6 timed steps; the first loss against the serial port model on the
    trainer's params; the flash launches against the formula."""
    from paddle_tpu_torch.core.mesh import make_mesh
    from paddle_tpu_torch.models.ernie import Ernie, ErnieConfig
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel.hybrid import HybridParallelTrainer

    cfg = ErnieConfig(**ERNIE_CFG, causal=True)
    t0 = time.perf_counter()
    tr = HybridParallelTrainer(cfg, make_mesh(HYB_MESH), Adam(1e-4), num_micro=HYB_MICRO,
                               seed=0)
    ids, labels = hybrid_batch(np.random.default_rng(30), cfg.vocab_size, ERNIE_BATCH,
                               ERNIE_SEQ, dev)
    with torch.device("meta"):
        model = Ernie(cfg)
    model.load_state_dict(tr.serial_state_dict(), assign=True)
    with torch.no_grad():
        serial_loss = float(model.loss(ids, labels))
    del model
    torch.cuda.synchronize()
    log(f"hybrid leg A: built on {HYB_MESH} in {time.perf_counter() - t0:.2f} s (host); "
        f"the serial model's loss on the same params {serial_loss}")

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses = []
    for i in range(HYB_WARM + HYB_STEPS):
        if i == HYB_WARM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(tr.train_step(ids, labels))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_launches()
    steps = HYB_WARM + HYB_STEPS
    losses = torch.stack(losses).cpu().numpy()
    want = {k: steps * n for k, n in hybrid_launches_per_step(cfg, HYB_MESH, HYB_MICRO).items()}
    tokens = ERNIE_BATCH * ERNIE_SEQ
    stats = {"ms_per_step": 1e3 * dt / HYB_STEPS, "tokens_per_s": tokens * HYB_STEPS / dt,
             "peak_bytes": torch.cuda.max_memory_allocated()}
    rel = abs(float(losses[0]) - serial_loss) / abs(serial_loss)
    log(f"hybrid leg A: {steps} steps, flash launches {counts} (formula {want}: 8 ranks x "
        f"{HYB_MICRO + HYB_MESH['pp'] - 1} ticks x {cfg.num_layers // HYB_MESH['pp']} blocks x "
        f"{HYB_MESH['cp']} hops a step for B5, x {HYB_MICRO} valid ticks for B6/B7), losses "
        f"{losses.tolist()}; first loss vs serial {rel} (stated bound 1e-4)")
    log(f"hybrid leg A: {stats['tokens_per_s']:.1f} tokens/s, {stats['ms_per_step']:.3f} ms/step "
        f"({HYB_STEPS} timed steps, {dt:.4f} s), peak memory {stats['peak_bytes']} B, against "
        f"phase 7's serial step {serial['ms_per_step']:.3f} ms, {serial['tokens_per_s']:.1f} "
        f"tokens/s on {card}")
    # the same steps again from a trainer of the same seed: bitwise the same?
    again = HybridParallelTrainer(cfg, make_mesh(HYB_MESH), Adam(1e-4), num_micro=HYB_MICRO,
                                  seed=0)
    rerun = torch.stack([again.train_step(ids, labels)
                         for _ in range(HYB_REPEAT)]).cpu().numpy()
    del again
    repeat = bool(np.array_equal(rerun, losses[:HYB_REPEAT]))
    log(f"hybrid leg A: a second trainer of the same seed, {HYB_REPEAT} steps: losses "
        f"{rerun.tolist()}, bitwise equal to the first run's: {repeat}")
    assert repeat, "hybrid leg A: the same steps did not repeat bit for bit on the card"
    assert np.isfinite(losses).all(), "hybrid leg A: non-finite loss"
    assert losses[-1] < losses[0], "hybrid leg A: loss did not fall"
    assert rel <= 1e-4, f"hybrid leg A: first loss {losses[0]} vs serial {serial_loss}"
    for name, n in want.items():
        assert counts[name] == n, f"hybrid leg A: {name} {counts[name]} launches, formula {n}"
    return tr, (ids, labels), counts, stats


def hybrid_small_run(device, causal, impl, seed, batches):
    """3 hybrid steps of a small ERNIE on ``HYB_MESH``: (losses, start and
    end params on the CPU)."""
    from paddle_tpu_torch.core.mesh import make_mesh
    from paddle_tpu_torch.models.ernie import ErnieConfig
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel.hybrid import HybridParallelTrainer, flatten_tree

    cfg = ErnieConfig(**HYB_SMALL, causal=causal, attn_impl=impl)
    tr = HybridParallelTrainer(cfg, make_mesh(HYB_MESH, device=device), Adam(1e-3),
                               num_micro=HYB_MICRO, seed=seed, device=device)
    start = {k: v.cpu().clone() for k, v in flatten_tree(tr.params).items()}
    losses = [float(tr.train_step(i.to(device), y.to(device))) for i, y in batches]
    return np.asarray(losses), start, {k: v.cpu() for k, v in flatten_tree(tr.params).items()}


def hybrid_leg_b(dev):
    """Card (``"auto"``: the kernels) vs CPU (``"flash"``: their plain
    versions), causal and not, seeds 0–2, 3 steps from the same weights."""
    H, D = HYB_SMALL["num_heads"], HYB_SMALL["hidden_size"] // HYB_SMALL["num_heads"]
    worst = {"loss": 0.0, "update": 0.0}
    for causal in (False, True):
        for seed in range(3):
            rng = np.random.default_rng(60 + seed)
            batches = [hybrid_batch(rng, HYB_SMALL["vocab_size"], HYB_SMALL_BATCH,
                                    HYB_SMALL["max_seq_len"], "cpu")
                       for _ in range(HYB_SMALL_STEPS)]
            gl, w0, gp = hybrid_small_run(dev, causal, "auto", seed, batches)
            cl, c0, cp = hybrid_small_run(torch.device("cpu"), causal, "flash", seed, batches)
            assert all(torch.equal(w0[k], c0[k]) for k in w0), "leg B: weights differ"
            loss = float(np.max(np.abs(gl - cl) / np.abs(cl)))
            upd = 0.0
            for k, s in w0.items():
                dg, dc = gp[k] - s, cp[k] - s
                if k.endswith("attn.qkv_b"):     # [pp, H·3·D]: drop the key bias
                    dg, dc = (d.reshape(-1, H, 3, D)[:, :, [0, 2]] for d in (dg, dc))
                if float(dc.norm()) > 0:
                    upd = max(upd, float((dg - dc).norm() / dc.norm()))
            worst["loss"], worst["update"] = max(worst["loss"], loss), max(worst["update"], upd)
            log(f"hybrid leg B causal={causal} seed={seed}: card vs CPU losses {gl.tolist()} "
                f"vs {cl.tolist()} (worst relative {loss}), worst relative update difference "
                f"{upd} (stated bounds {HYB_TOL})")
            assert loss <= HYB_TOL["loss"] and upd <= HYB_TOL["update"], \
                f"hybrid leg B causal={causal} seed={seed}: {loss}, {upd}"
    return worst


def ring_hop_kernels(dev):
    """B5–B7 at leg A's hop shape, causal: the hop of past keys (q_offset
    L, k_offset 0) and the fully masked hop (q_offset 0, k_offset L), with
    a numpy-seeded dO and dlse, against their plain versions on the card
    (``FA_TOL``), each twice to the same bits; at the masked hop out, dQ,
    dK, dV exactly 0 and lse exactly NEG. Then the times at the hop of
    past keys (every pair visible) for the kernels line."""
    from paddle_tpu_torch.ops import flash_attention as fa

    B, L, H, D = RING_HOP
    rng = np.random.default_rng(41)
    q, k, v, do = (torch.from_numpy(rng.normal(size=RING_HOP).astype(np.float32)).to(dev)
                   for _ in range(4))
    dlse = torch.from_numpy(rng.normal(size=(B, L, H)).astype(np.float32)).to(dev)
    tol = FA_TOL["default"]
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for qo, ko in ((L, 0), (0, L)):
        kw = dict(causal=True, q_offset=qo, k_offset=ko)

        def run():
            out, lse = fa.flash_attention_fwd(q, k, v, **kw)
            delta = ((do * out).sum(-1) - dlse).contiguous()
            return (out, lse, fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
                    *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)), delta

        got, delta = run()
        again, _ = run()
        torch.cuda.synchronize()
        same = all(bitwise_equal(a, b) for a, b in zip(got, again))
        out, lse, dq, dk, dv = got
        w_out, w_lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
        w_dq = fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
        w_dk, w_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
        errs = {"out": max_abs(out, w_out), "lse": max_abs(lse, w_lse), "dq": max_abs(dq, w_dq),
                "dk": max_abs(dk, w_dk), "dv": max_abs(dv, w_dv)}
        ok = same and all(bool(torch.isfinite(t).all()) for t in got) and \
            all(e <= tol.get(n, tol["grad"]) for n, e in errs.items())
        line = (f"kernel flash_attention ring hop {list(RING_HOP)} causal q_offset={qo} "
                f"k_offset={ko}: max_abs {errs} (stated bounds {tol}), two runs bitwise {same}")
        if qo + L - 1 < ko:
            exact = (all(bool((t == 0).all()) for t in (out, dq, dk, dv))
                     and bool((lse == fa.NEG).all()))
            ok = ok and exact
            line += f"; masked hop: out, dQ, dK, dV exactly 0 and lse exactly NEG {exact}"
        log(line)
        assert ok, f"ring hop kernels: q_offset {qo}, k_offset {ko}"
        for name, keys in (("fwd", ("out", "lse")), ("dq", ("dq",)), ("dkv", ("dk", "dv"))):
            worst[name] = max(worst[name], *(errs[n] for n in keys))

    return flash_kernel_times(dev, q, k, v, do, dlse, dict(causal=True, q_offset=L, k_offset=0),
                              "ring", worst)


def hybrid_leg_c(dev, card):
    """MoE at full width: 8 experts (gshard) on ``{"dp": 2, "pp": 2, "cp": 1,
    "mp": 2}``, ep riding dp; 2 warm-up and 4 timed steps."""
    from paddle_tpu_torch.core.mesh import make_mesh
    from paddle_tpu_torch.models.ernie import ErnieConfig
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel.hybrid import HybridParallelTrainer

    cfg = ErnieConfig(**ERNIE_CFG, num_experts=8, moe_gate="gshard")
    t0 = time.perf_counter()
    tr = HybridParallelTrainer(cfg, make_mesh(HYB_MOE_MESH), Adam(1e-4), num_micro=HYB_MICRO,
                               seed=1)
    n_params = sum(t.numel() for g in tr.params["stages"].values() for t in g.values())
    ids, labels = hybrid_batch(np.random.default_rng(31), cfg.vocab_size, ERNIE_BATCH,
                               ERNIE_SEQ, dev)
    torch.cuda.synchronize()
    log(f"hybrid leg C: {cfg.num_experts} experts, {n_params} stage parameters, built on "
        f"{HYB_MOE_MESH} in {time.perf_counter() - t0:.2f} s (host)")
    torch.cuda.reset_peak_memory_stats()
    losses, aux = [], []
    for i in range(HYB_WARM + HYB_MOE_STEPS):
        if i == HYB_WARM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(float(tr.train_step(ids, labels)))
        aux.append(tr.last_aux_loss)
    dt = time.perf_counter() - t0
    tps = ERNIE_BATCH * ERNIE_SEQ * HYB_MOE_STEPS / dt
    log(f"hybrid leg C: losses {losses}, aux (load-balancing) losses {aux}; {tps:.1f} tokens/s, "
        f"{1e3 * dt / HYB_MOE_STEPS:.3f} ms/step, peak memory "
        f"{torch.cuda.max_memory_allocated()} B on {card}")
    assert np.isfinite(losses).all() and np.isfinite(aux).all(), "hybrid leg C: non-finite"
    assert losses[-1] < losses[0], "hybrid leg C: loss did not fall"
    return {"tokens_per_s": tps, "ms_per_step": 1e3 * dt / HYB_MOE_STEPS}


def phase_hybrid(dev, card, serial):
    """Phase 21: legs A (full width, causal, the ring over cp), B (card vs
    CPU, small; the ring hop kernels at leg A's shape) and C (MoE)."""
    t_phase = time.perf_counter()
    tr, batch, counts, stats = hybrid_leg_a(dev, card, serial)
    t_b = time.perf_counter()
    hybrid_leg_b(dev)
    ring = ring_hop_kernels(dev)
    t_c = time.perf_counter()
    moe = hybrid_leg_c(dev, card)
    torch.cuda.empty_cache()
    log(f"hybrid (phase 21): {time.perf_counter() - t_phase:.1f} s (leg A {t_b - t_phase:.1f} s, "
        f"leg B and the hop kernels {t_c - t_b:.1f} s, leg C {time.perf_counter() - t_c:.1f} s) "
        f"on {card}")
    return {"trainer": tr, "batch": batch, "counts": counts, "stats": stats, "ring": ring,
            "moe": moe}


# -- phase 22: DCN and xDeepFM through the pass trainer, the serving export,
# -- the rest of the vision zoo ------------------------------------------------

# Leg A: the pass path's Criteo shape (26 slots, 13 dense, dim 8, DNN 400^3,
# a 2^21-row cache, batch 4096) over ZOO_LINES MultiSlot lines from the hot
# path's generator (``ctr_lines``, ZOO_IDS ids a slot): one pass, 4 steps (cut
# from 8 for the script's time limit), each family with a dense optimizer of
# this slice. The exports serve batch 1 and
# 4096 in a child process (``--serve-export DIR``); SERVE_UNSEEN of the keys
# are outside the pass; SERVE_CALLS calls at 4096 give the p50.
ZOO_LINES, ZOO_IDS = 16_384, 10_000
CTR_FAMILIES = (("DCN", "Adagrad"), ("XDeepFM", "Lamb"))
SERVE_UNSEEN, SERVE_CALLS, EXPORT_TOL = 0.05, 50, 1e-6
_SERVE_RESULT = "SERVE_EXPORT "
# Leg B: each family at 224x224, 1000 classes, batch ZOO_BATCH, f32, through
# ``Trainer`` for ZOO_STEPS steps (the first a warm-up; cut from 3 for the
# script's time limit), each with its dense
# optimizer; then card vs CPU at ZOO_SMALL (side, batch) from the same weights:
# the eval forward within ZOO_FWD_TOL of the CPU output's largest value, and one
# training step's update within ZOO_UPDATE_TOL (||Δcard − Δcpu|| / ||Δcpu||
# over all parameters; dropout off on both sides). AlexNet's 6x6 and VGG's 7x7
# adaptive pools need 224.
ZOO_BATCH, ZOO_STEPS, ZOO_CLASSES = 32, 2, 1000
ZOO = (("vgg16", "Momentum"), ("alexnet", "RMSProp"), ("squeezenet1_1", "Adadelta"),
       ("mobilenet_v2", "Adamax"), ("shufflenet_v2_x1_0", "Lars"), ("googlenet", "Momentum"),
       ("densenet121", "RMSProp"))
# Readings on an H100 80GB HBM3 (700 W), seed 63 / weights 7: eval out
# 3.8e-7-2.6e-6 (VGG16); updates without BatchNorm 4.3e-7-2.1e-5 (VGG16),
# with it 2.9e-5 (DenseNet121), 0.017 (ShuffleNetV2), 0.082 (MobileNetV2:
# batch statistics over 4 images, ill-conditioned at init as phase 11's
# ResNet). Bounds ~2.5-5x the largest reading.
ZOO_SMALL = {"vgg16": (224, 2), "alexnet": (224, 2)}   # others: (64, 4)
ZOO_FWD_TOL = 1e-5
ZOO_UPDATE_TOL = {True: 0.2, False: 1e-4}              # by "has BatchNorm"


def zoo_optimizer(name):
    from paddle_tpu_torch import optimizer as O

    return {"Momentum": lambda: O.Momentum(0.01, 0.9, weight_decay=1e-4),
            "RMSProp": lambda: O.RMSProp(1e-4),
            "Adadelta": lambda: O.Adadelta(1.0),
            "Adamax": lambda: O.Adamax(2e-3),
            "Lars": lambda: O.Lars(0.1),
            "Adagrad": lambda: O.Adagrad(1e-2),
            "Adam": lambda: O.Adam(1e-3),
            "Lamb": lambda: O.Lamb(1e-2)}[name]()


def zoo_ctr_trainer(family, opt_name, dev):
    """A ``CtrPassTrainer`` of ``family`` at the pass path's width over a
    16-shard host table, its per-step losses recorded (device scalars)."""
    from paddle_tpu_torch.models import ctr
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.embedding_cache import CacheConfig
    from paddle_tpu_torch.ps.ps_trainer import CtrPassTrainer
    from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

    model = getattr(ctr, family)(ctr.CtrConfig(SLOTS, DENSE, DIM, (400, 400, 400)),
                                 generator=torch.Generator().manual_seed(0))
    table = MemorySparseTable(TableConfig(shard_num=16,
                                          accessor_config=AccessorConfig(embedx_dim=DIM)))
    tr = CtrPassTrainer(model, zoo_optimizer(opt_name), table,
                        CacheConfig(capacity=CAPACITY, embedx_dim=DIM, embedx_threshold=0.0),
                        device=dev, **slot_names(SLOTS, DENSE))
    losses, build = [], tr._packed_step

    def recording(batch_size, slab=1):
        step = build(batch_size, slab)

        def run(*args):
            if not losses:
                losses.t0 = time.perf_counter()
            out = step(*args)
            losses.append(out[3])
            return out
        return run

    tr._packed_step = recording
    losses = _Losses()
    return tr, losses


class _Losses(list):
    """The pass's per-step losses; ``t0``: the host clock at the first step."""
    t0 = None


def step_ms(losses, steps):
    """Host ms a step from the first step's call to the last loss on the
    host (the pass's build before it excluded)."""
    float(losses[-1])
    return 1e3 * (time.perf_counter() - losses.t0) / steps


def serving_batch(tr, ds, rng):
    """(lo32 [4096, S] int64 with SERVE_UNSEEN of the keys outside the pass,
    dense [4096, D] f32, the unseen mask) from the pass's first records."""
    from paddle_tpu_torch.ps.ps_trainer import _dense_and_labels, _slot_tagged_keys

    batch = next(iter(ds.batch_iter(BATCH, drop_last=False)))
    lo32 = (_slot_tagged_keys(batch, tr.sparse_slots) & np.uint64(0xFFFFFFFF)).astype(np.int64)
    dense, _ = _dense_and_labels(batch, tr.dense_slots, tr.label_slot, lo32.shape[0])
    unseen = rng.random(lo32.shape) < SERVE_UNSEEN
    lo32[unseen] = ZOO_IDS + rng.integers(0, 1 << 20, int(unseen.sum()))
    return lo32, dense.astype(np.float32), unseen


def ctr_export_leg(dev, card, family, opt_name, ds, base):
    """One family: a pass, its launches and B1 on a captured push, then the
    fused and dense exports and the trainer's own predictions for them."""
    from paddle_tpu_torch.models.ctr import serving_pull

    tr, step_losses = zoo_ctr_trainer(family, opt_name, dev)
    try:
        push, restore = capture_first_push()
        torch.cuda.synchronize()
        reset_launches()
        try:
            res = tr.train_from_dataset(ds, batch_size=BATCH, drop_last=False)
        finally:
            restore()
        torch.cuda.synchronize()
        counts = read_launches()
        steps = int(res["steps"])
        ms = step_ms(step_losses, steps)
        losses = torch.stack(step_losses).cpu().numpy()
        log(f"item 5 {family} ({opt_name}): {steps} steps, {res['samples_per_sec']:.1f} "
            f"samples/s (batch {BATCH}, the pass's host build included), {ms:.3f} ms a step "
            f"(host clock, build excluded), losses {losses.tolist()}, launches {counts} on "
            f"{card}")
        assert np.isfinite(losses).all(), f"{family}: non-finite loss"
        assert losses[-2:].mean() < losses[:2].mean(), f"{family}: loss did not fall"
        assert counts["ctr_sparse_rows"] == steps == ZOO_LINES // BATCH, \
            f"{family}: B1 launches {counts['ctr_sparse_rows']} != steps {steps}"
        assert counts["merge_sparse_grads"] == steps, f"{family}: merge launches {counts}"
        b1 = wd_b1_check(push, dim=DIM, what=f"{family} push")

        keys = np.unique(tr._tagged_pass_keys(ds))
        out = {}
        for fused in (True, False):
            d = os.path.join(base, f"{family}_{'fused' if fused else 'dense'}")
            t0 = time.perf_counter()
            tr.save_inference_model(d, fused=fused, keys=keys if fused else None)
            out["fused" if fused else "dense"] = time.perf_counter() - t0
        assert tr.cache.state is not None, f"{family}: the exported pass is not active"
        lo32, dense, unseen = serving_batch(tr, ds, np.random.default_rng(61))
        lo_d = torch.from_numpy(lo32).to(dev)
        with torch.no_grad():
            emb = serving_pull(tr.cache.state, tr.cache.device_map.state,
                               torch.arange(SLOTS, device=dev), lo_d)
            want = torch.sigmoid(torch.func.functional_call(
                tr.model, tr.params, (emb, torch.from_numpy(dense).to(dev))))
        zeros = bool((emb[torch.from_numpy(unseen).to(dev)] == 0).all())
        assert zeros, f"{family}: an unseen key pulled a nonzero row"
        np.savez(os.path.join(base, f"{family}_inputs.npz"), lo32=lo32, dense=dense,
                 emb=emb.cpu().numpy(), want=want.cpu().numpy())
        tr.cache.end_pass()
        log(f"item 5 {family}: exports fused {out['fused']:.2f} s, dense {out['dense']:.2f} s "
            f"(torch.export trace + save); {int(unseen.sum())} of {unseen.size} serving keys "
            f"outside the pass, their rows zero on {card}")
        return {"steps": steps, "launches": counts["ctr_sparse_rows"], "b1": b1,
                "samples_per_s": res["samples_per_sec"], "ms_per_step": ms, "export_s": out}
    finally:
        tr.table.close()


def deepfm_pass_baseline(dev, card, ds):
    """DeepFM (Adam) through the same pass: ms a step for the families'
    comparison."""
    tr, step_losses = zoo_ctr_trainer("DeepFM", "Adam", dev)
    try:
        res = tr.train_from_dataset(ds, batch_size=BATCH, drop_last=False)
        ms = step_ms(step_losses, int(res["steps"]))
        log(f"item 5 DeepFM (Adam) baseline: {res['samples_per_sec']:.1f} samples/s, {ms:.3f} ms "
            f"a step (host clock, build excluded) on {card}")
        return ms
    finally:
        tr.table.close()


def serve_export_child(base, device="cuda"):
    """``--serve-export DIR``: load each artifact of ``DIR`` on the card,
    serve batch 1 and the parent's whole batch (4096) against the parent's
    predictions (within EXPORT_TOL), check that serving launched no kernel,
    time SERVE_CALLS calls at the whole batch; prints one
    ``SERVE_EXPORT {json}`` line."""
    from paddle_tpu_torch.io.inference import load_inference_model

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rec = {}
    for family, _ in CTR_FAMILIES:
        inp = np.load(os.path.join(base, f"{family}_inputs.npz"))
        for kind in ("fused", "dense"):
            t0 = time.perf_counter()
            pred = load_inference_model(os.path.join(base, f"{family}_{kind}"), device=dev)
            sync()
            load_s = time.perf_counter() - t0
            first = inp["lo32"] if kind == "fused" else inp["emb"]
            reset_launches()
            err = 0.0
            for n in (1, len(inp["want"])):
                got = pred(first[:n], inp["dense"][:n]).cpu().numpy()
                assert got.shape == (n,), f"{family} {kind}: shape {got.shape}"
                err = max(err, float(np.abs(got - inp["want"][:n]).max()))
            x = torch.from_numpy(first).to(dev)
            dn = torch.from_numpy(inp["dense"]).to(dev)
            ms = []
            for _ in range(SERVE_CALLS):
                sync()
                t0 = time.perf_counter()
                pred(x, dn)
                sync()
                ms.append(1e3 * (time.perf_counter() - t0))
            launched = sum(read_launches().values())
            rec[f"{family}_{kind}"] = {"max_abs_err": err, "load_s": load_s,
                                       "p50_ms": float(np.median(ms)), "launches": launched}
    print(_SERVE_RESULT + json.dumps(rec), flush=True)
    return 0


def zoo_step_run(device, name, opt_name, weights, batches):
    """One model of the zoo through ``Trainer``: (losses, the start and the
    params and buffers after the steps, on the CPU)."""
    from paddle_tpu_torch import models
    from paddle_tpu_torch.executor import Trainer
    from paddle_tpu_torch.nn import functional as F

    from paddle_tpu_torch.nn.layers import Dropout

    model = getattr(models, name)(num_classes=ZOO_CLASSES)
    model.load_state_dict(weights)
    for m in model.modules():  # the card's and the CPU's generators draw other masks
        if isinstance(m, Dropout):
            m.p = 0.0
    tr = Trainer(model, zoo_optimizer(opt_name), F.cross_entropy, device=device)
    losses = [float(tr.train_step(x.to(device), y.to(device))) for x, y in batches]
    return np.asarray(losses), {k: v.cpu() for k, v in
                                {**tr.state["params"], **tr.state["buffers"]}.items()}


def zoo_full_width(dev, card):
    """Leg B at 224: ms a step (the steps after the first) and peak memory."""
    from paddle_tpu_torch import models
    from paddle_tpu_torch.executor import Trainer
    from paddle_tpu_torch.nn import functional as F

    rng = np.random.default_rng(62)
    x = torch.from_numpy(rng.normal(size=(ZOO_BATCH, 3, 224, 224)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, ZOO_CLASSES, ZOO_BATCH)).to(dev)
    stats = {}
    for name, opt_name in ZOO:
        model = getattr(models, name)(num_classes=ZOO_CLASSES,
                                      generator=torch.Generator().manual_seed(0))
        tr = Trainer(model, zoo_optimizer(opt_name), F.cross_entropy, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = [tr.train_step(x, y)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [tr.train_step(x, y) for _ in range(ZOO_STEPS - 1)]
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / (ZOO_STEPS - 1)
        losses = torch.stack(losses).cpu().numpy()
        stats[name] = {"ms_per_step": ms, "peak_bytes": torch.cuda.max_memory_allocated(),
                       "images_per_s": 1e3 * ZOO_BATCH / ms}
        log(f"zoo {name} ({opt_name}): losses {losses.tolist()}, {ms:.3f} ms/step "
            f"({ZOO_STEPS - 1} timed steps after 1, batch {ZOO_BATCH} x 3x224x224), "
            f"{stats[name]['images_per_s']:.1f} images/s, peak memory "
            f"{stats[name]['peak_bytes']} B on {card}")
        assert np.isfinite(losses).all(), f"zoo {name}: non-finite loss"
        del tr, model
        torch.cuda.empty_cache()
    return stats


def zoo_parity(dev):
    """Leg B small: card vs CPU from the same weights (ZOO_SMALL): the eval
    forward (ZOO_FWD_TOL) and one training step's update
    (ZOO_UPDATE_TOL)."""
    from paddle_tpu_torch import models

    cpu = torch.device("cpu")
    for name, opt_name in ZOO:
        side, batch = ZOO_SMALL.get(name, (64, 4))
        rng = np.random.default_rng(63)
        batches = [(torch.from_numpy(rng.normal(size=(batch, 3, side, side)).astype(np.float32)),
                    torch.from_numpy(rng.integers(0, ZOO_CLASSES, batch)))]
        model = getattr(models, name)(num_classes=ZOO_CLASSES,
                                      generator=torch.Generator().manual_seed(7))
        weights = model.state_dict()
        model.eval()
        with torch.no_grad():
            want = model(batches[0][0])
            model.to(dev)
            got = model(batches[0][0].to(dev)).cpu()
        fwd = float((got - want).abs().max() / want.abs().max())
        has_bn = any(k.endswith("_mean") for k in weights)
        gl, gs = zoo_step_run(dev, name, opt_name, weights, batches)
        cl, cs = zoo_step_run(cpu, name, opt_name, weights, batches)
        num = den = 0.0
        for k, w0 in weights.items():
            if k.endswith(("_mean", "_variance")):
                continue
            dg, dc = gs[k] - w0, cs[k] - w0
            num, den = num + float((dg - dc).norm()) ** 2, den + float(dc.norm()) ** 2
        upd = (num / max(den, 1e-30)) ** 0.5
        loss = float(abs(gl[0] / cl[0] - 1))
        log(f"zoo parity {name} ({side}x{side}, batch {batch}): eval out card vs CPU {fwd} of "
            f"its largest (bound {ZOO_FWD_TOL}); step loss {loss}; update {upd} over all params "
            f"(bound {ZOO_UPDATE_TOL[has_bn]}, BatchNorm {has_bn})")
        assert fwd <= ZOO_FWD_TOL, f"zoo {name}: eval forward differs by {fwd}"
        assert loss <= ZOO_FWD_TOL, f"zoo {name}: step loss differs by {loss}"
        assert upd <= ZOO_UPDATE_TOL[has_bn], f"zoo {name}: updates differ by {upd}"


def zoo_hapi_roundtrip(dev, base):
    """``hapi.Model.save``/``load`` on the card: a step after a load is
    bitwise the step after the save (cuDNN deterministic and dropout off
    for the check)."""
    from paddle_tpu_torch import hapi, models
    from paddle_tpu_torch.nn import functional as F

    rng = np.random.default_rng(64)
    x = rng.normal(size=(8, 3, 64, 64)).astype(np.float32)
    y = rng.integers(0, ZOO_CLASSES, 8)
    from paddle_tpu_torch.nn.layers import Dropout

    net = models.squeezenet1_1(num_classes=ZOO_CLASSES, generator=torch.Generator().manual_seed(5))
    for mod in net.modules():  # the trainer's generator is not part of the checkpoint
        if isinstance(mod, Dropout):
            mod.p = 0.0
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        m = hapi.Model(net, device=dev)
        m.prepare(zoo_optimizer("Adamax"), F.cross_entropy)
        m.train_batch(x, y)
        path = os.path.join(base, "hapi_squeezenet")
        m.save(path)
        a = m.train_batch(x, y)["loss"]
        pa = {k: v.clone() for k, v in m.state["params"].items()}
        m.load(path)
        b = m.train_batch(x, y)["loss"]
        same = a == b and all(torch.equal(pa[k], v) for k, v in m.state["params"].items())
    finally:
        torch.backends.cudnn.deterministic = det
    log(f"zoo hapi: Model.save/load round trip on the card (squeezenet1_1, Adamax): the next "
        f"step's loss {a} vs {b}, params bitwise {same}")
    assert same, "hapi save/load: the step after a load differs from the step after the save"


def phase_item5(dev, card):
    """Phase 22: leg A (DCN and xDeepFM through ``CtrPassTrainer`` at the
    pass path's width, B1 a step, the fused and dense serving exports
    served from a child process) and leg B (the vision zoo at 224, card vs
    CPU, hapi save/load)."""
    import shutil as _shutil
    import tempfile

    t_phase = time.perf_counter()
    base = tempfile.mkdtemp(prefix="item5_")
    try:
        t0 = time.perf_counter()
        ds = ctr_dataset(ctr_lines(np.random.default_rng(60), ZOO_LINES, ZOO_IDS, SLOTS, DENSE),
                         SLOTS, DENSE)
        log(f"item 5: {ds.num_records} MultiSlot lines made and parsed in "
            f"{time.perf_counter() - t0:.2f} s (host)")
        fam = {f: ctr_export_leg(dev, card, f, o, ds, base) for f, o in CTR_FAMILIES}
        base_ms = deepfm_pass_baseline(dev, card, ds)
        log(f"item 5: a step against DeepFM's {base_ms:.3f} ms: " + ", ".join(
            f"{f} {r['ms_per_step'] / base_ms:.2f}x" for f, r in fam.items()))
        del ds
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, PSJOB_SCRIPT, "--serve-export", base],
                           capture_output=True, text=True, timeout=900)
        child_s = time.perf_counter() - t0
        got = [json.loads(l[len(_SERVE_RESULT):]) for l in p.stdout.splitlines()
               if l.startswith(_SERVE_RESULT)]
        assert p.returncode == 0 and got, \
            f"serve-export child rc {p.returncode}:\n{p.stdout[-3000:]}\n{p.stderr[-3000:]}"
        for name, r in got[0].items():
            log(f"item 5 serving {name} (child process, {child_s:.1f} s in all): load "
                f"{r['load_s']:.3f} s, batch 1 and {BATCH} within {r['max_abs_err']} of the "
                f"trainer's forward (bound {EXPORT_TOL}), p50 {r['p50_ms']:.3f} ms at batch "
                f"{BATCH} over {SERVE_CALLS} calls, kernel launches while serving "
                f"{r['launches']} on {card}")
            assert r["max_abs_err"] <= EXPORT_TOL, f"{name}: served {r['max_abs_err']} off"
            assert r["launches"] == 0, f"{name}: serving launched {r['launches']} kernels"
        t_b = time.perf_counter()
        zoo = zoo_full_width(dev, card)
        zoo_parity(dev)
        zoo_hapi_roundtrip(dev, base)
    finally:
        _shutil.rmtree(base, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"item 5 (phase 22): {time.perf_counter() - t_phase:.1f} s (leg A "
        f"{t_b - t_phase:.1f} s, leg B {time.perf_counter() - t_b:.1f} s) on {card}")
    return {"families": fam, "zoo": zoo}


# -- phase 23: ROADMAP items 9 and 4's rest ---------------------------------------------
# DIN at PaddleRec's models/rank/din/config.yaml widths: item_emb_size 64 (embedx dim 64),
# item_count 63,001 and cat_count 801, an attention unit 80 wide and a DNN 80 -> 40;
# 2 target columns (item, category) and the history cut at DIN_HIST items (lengths
# uniform in 1..DIN_HIST, the rest padding: the capacity sentinel). One dense feature,
# the history's length over DIN_HIST (the JAX model takes dense features; PaddleRec's DIN
# has none). Each item has one category, drawn once from the seed; a label is likelier
# when the target's item or category is ≡ 0 mod 5. The data is synthetic: the Amazon
# data is not in the repository.
DIN_ITEMS, DIN_CATS, DIN_DIM, DIN_HIST = 63_001, 801, 64, 50
DIN_ATT, DIN_DNN, DIN_CAP = 80, (80, 40), 1 << 17
# ESMM and MMoE at the pass path's width (26 slots, 13 dense, dim 8, DNN 400^3, batch
# 4096), MT_IDS ids a slot, MMoE with the JAX defaults (4 experts of 32, 2 tasks); the
# labels are tests/test_multitask_models.py's recipe (a click from "clicky" ids ≡ 0 mod 5
# and the first dense feature; a conversion only where the click is 1, from ids ≡ 0 mod
# 7), its thresholds moved up by the mean count of such ids over 26 slots
MT_IDS, MT_CAP = 4_000, 1 << 18
I9_STEPS = 8                         # steps a family's pass takes at batch BATCH
# each family's Adam rate: the 400^3 towers swing at 1e-2 (ESMM's loss 1.08 -> 2.00 at
# step 2 on the CPU at full width), fall smoothly at 1e-3
I9_LR = {"din": 1e-2, "esmm": 1e-3, "mmoe": 1e-3}
I9_SERVE_CALLS = 10
I9_MESH = {"dp": 2, "mp": 2}


def din_batches(rng, steps, batch):
    """``steps`` DIN batches: (keys [B, 2 + DIN_HIST] u64 — items hi 0,
    categories hi 1 —, padding mask [B, T], dense [B, 1], labels [B])."""
    cat_of = rng.integers(0, DIN_CATS, DIN_ITEMS)
    out = []
    for _ in range(steps):
        target = rng.integers(0, DIN_ITEMS, batch)
        hist = rng.integers(0, DIN_ITEMS, (batch, DIN_HIST))
        lengths = rng.integers(1, DIN_HIST + 1, batch)
        cat = cat_of[target]
        keys = np.concatenate([target[:, None], (1 << 32) | cat[:, None], hist],
                              axis=1).astype(np.uint64)
        pad = np.zeros(keys.shape, bool)
        pad[:, 2:] = np.arange(DIN_HIST)[None, :] >= lengths[:, None]
        dense = (lengths / DIN_HIST).astype(np.float32)[:, None]
        score = 2.0 * (cat % 5 == 0) + 2.0 * (target % 5 == 0) + rng.normal(size=batch)
        out.append((keys, pad, dense, (score > 1.5).astype(np.int32)))
    return out


def mt_batches(rng, steps, batch):
    """``steps`` multitask batches: (slot-tagged keys [B, 26], no padding,
    dense [B, 13], labels [B, 2] = (click, conversion))."""
    out = []
    for _ in range(steps):
        ids = rng.integers(0, MT_IDS, (batch, SLOTS))
        keys = (ids.astype(np.uint64) | (np.arange(SLOTS, dtype=np.uint64) << np.uint64(32)))
        dense = rng.normal(size=(batch, DENSE)).astype(np.float32)
        clicky, convy = (ids % 5 == 0).sum(1), (ids % 7 == 0).sum(1)
        click = clicky + dense[:, 0] + rng.normal(scale=0.5, size=batch) > 1.0 + SLOTS / 5
        conv = (convy + rng.normal(scale=0.5, size=batch) > 1.0 + SLOTS / 7) & click
        out.append((keys, np.zeros(keys.shape, bool), dense,
                    np.stack([click, conv], axis=1).astype(np.int32)))
    return out


def i9_family(family):
    """(model, the step's maker, embedx dim, capacity, batches' maker)."""
    from paddle_tpu_torch.models import ctr
    from paddle_tpu_torch.models.din import DIN, make_ctr_attention_train_step
    from paddle_tpu_torch.models.multitask import ESMM, MMoE, make_multitask_train_step

    g = torch.Generator().manual_seed(9)
    if family == "din":
        return (DIN(2, DIN_HIST, 1, DIN_DIM, dnn_hidden=DIN_DNN, att_hidden=DIN_ATT,
                    generator=g), make_ctr_attention_train_step, DIN_DIM, DIN_CAP, din_batches)
    cfg = ctr.CtrConfig(SLOTS, DENSE, DIM, (400, 400, 400))
    model = ESMM(cfg, generator=g) if family == "esmm" else MMoE(cfg, generator=g)
    return model, make_multitask_train_step, DIM, MT_CAP, mt_batches


def i9_pass(dev, card, family, base):
    """Leg A for one family: ``begin_pass``, I9_STEPS steps at batch BATCH,
    the exports of leg B (DIN, ESMM) while the pass is active, ``end_pass``.
    Returns the family's record."""
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.embedding_cache import CacheConfig, HbmEmbeddingCache
    from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

    model, make_step, dim, cap, make_batches = i9_family(family)
    rng = np.random.default_rng({"din": 90, "esmm": 91, "mmoe": 92}[family])
    batches = make_batches(rng, I9_STEPS, BATCH)
    table = MemorySparseTable(TableConfig(shard_num=16,
                                          accessor_config=AccessorConfig(embedx_dim=dim)))
    cfg = CacheConfig(capacity=cap, embedx_dim=dim, embedx_threshold=0.0)
    cache = HbmEmbeddingCache(table, cfg, device=dev, device_map=True)
    try:
        t0 = time.perf_counter()
        cache.begin_pass(np.unique(np.concatenate([k[~p] for k, p, _, _ in batches])))
        build_s = time.perf_counter() - t0
        model = model.to(dev)
        params = {k: v.detach() for k, v in model.named_parameters()}
        opt = Adam(I9_LR[family])
        opt_state = opt.init(params)
        step = make_step(model, opt, cfg, device=dev)
        feeds = []
        for keys, pad, dense, labels in batches:
            rows = np.full(keys.shape, cap, np.int64)   # padding: the sentinel
            rows[~pad] = cache.lookup(keys[~pad])
            feeds.append(tuple(torch.from_numpy(a).to(dev) for a in (rows, dense, labels)))
        push = restore = None
        if dev.type == "cuda":
            push, restore = capture_first_push()
        _sync(dev)
        reset_launches()
        losses, marks = [], []
        try:
            for rows, dense, labels in feeds:
                marks.append(time.perf_counter())
                params, opt_state, cache.state, loss = step(params, opt_state, cache.state,
                                                            rows, dense, labels)
                losses.append(loss)
                if len(marks) == 1:
                    _sync(dev)   # the first step (the process's first of these shapes) apart
            _sync(dev)
        finally:
            if restore is not None:
                restore()
        first_ms = 1e3 * (marks[1] - marks[0])
        ms = 1e3 * (time.perf_counter() - marks[1]) / (len(feeds) - 1)
        counts = read_launches()
        losses = torch.stack(losses).cpu().numpy()
        real = sum(int((~p).sum()) for _, p, _, _ in batches)
        log(f"items 9 {family}: pass of {len(cache._pass_keys)} keys built in {build_s:.2f} s, "
            f"{len(feeds)} steps at batch {BATCH} ({real} real positions of "
            f"{sum(p.size for _, p, _, _ in batches)}), the first step {first_ms:.3f} ms, "
            f"the other {len(feeds) - 1} {ms:.3f} ms a step (host clock, each span ends in a "
            f"sync), losses {losses.tolist()}, launches {counts} on {card}")
        assert np.isfinite(losses).all(), f"phase 23: {family} non-finite loss {losses}"
        assert losses[-2:].mean() < losses[:2].mean(), f"phase 23: {family} loss did not fall"
        rec = {"steps": len(feeds), "ms_per_step": ms, "first_ms": first_ms,
               "losses": losses.tolist(),
               "launches": counts["ctr_sparse_rows"], "b1": {}}
        if dev.type == "cuda":
            assert counts["ctr_sparse_rows"] == counts["merge_sparse_grads"] == len(feeds), \
                f"phase 23: {family} B1/merge launches {counts} != steps {len(feeds)}"
            rec["b1"] = wd_b1_check(push, dim=dim, what=f"{family} push")
        if family in ("din", "esmm"):
            rec["serve"] = i9_serve(dev, card, family, model, params, cache, batches[0], base)
        cache.end_pass()
        return rec
    finally:
        table.close()


def i9_serve(dev, card, family, model, params, cache, batch, base):
    """Leg B for one family: export the pass (DIN ``with_real``, its last
    two behaviour keys of every row outside the pass; ESMM through its
    ``predict``), load it in this process and serve batch 1 and BATCH
    within EXPORT_TOL of the model's own forward on the same pull,
    launching no kernel."""
    from torch.func import functional_call

    from paddle_tpu_torch.io.inference import load_inference_model
    from paddle_tpu_torch.models.ctr import export_ctr_inference, serving_pull

    keys, pad, dense, _ = batch
    with_real = family == "din"
    slot_ids = (np.array([0, 1] + [0] * DIN_HIST) if with_real else np.arange(SLOTS))
    lo32 = (keys & np.uint64(0xFFFFFFFF)).astype(np.int64)
    if with_real:
        lo32[pad] = 0xFFFFFFFF                   # padding: a key in no pass
        lo32[:, -2:] = DIN_ITEMS + np.arange(2)  # item ids past the vocabulary
    d = os.path.join(base, family)
    t0 = time.perf_counter()
    export_ctr_inference(d, model, cache, slot_ids=slot_ids, num_dense=dense.shape[1],
                         with_real=with_real, params=params)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = load_inference_model(d, device=dev)
    load_s = time.perf_counter() - t0
    reset_launches()
    got = {n: pred(lo32[:n], dense[:n]) for n in (1, len(lo32))}
    launched = sum(read_launches().values())
    times = []
    for _ in range(I9_SERVE_CALLS):
        _sync(dev)
        t0 = time.perf_counter()
        pred(lo32, dense)
        _sync(dev)
        times.append(1e3 * (time.perf_counter() - t0))
    slot_hi = torch.as_tensor(slot_ids, device=dev)
    err = 0.0
    for n, out in got.items():
        lo, dn = torch.from_numpy(lo32[:n]).to(dev), torch.from_numpy(dense[:n]).to(dev)
        with torch.no_grad():
            if with_real:
                emb, real = serving_pull(cache.state, cache.device_map.state, slot_hi, lo,
                                         with_real=True)
                assert not real[:, -2:].any() and not emb[:, -2:].any(), \
                    "phase 23: an out-of-pass key pulled a row"
                want = (torch.sigmoid(functional_call(model, params, (emb, real, dn))),)
            else:
                emb = serving_pull(cache.state, cache.device_map.state, slot_hi, lo)
                want = type(model).predict(functional_call(model, params, (emb, dn)))
        out = out if isinstance(out, tuple) else (out,)
        assert len(out) == len(want) and all(tuple(o.shape) == (n,) for o in out), \
            f"phase 23: {family} served shapes {[tuple(o.shape) for o in out]}"
        err = max(err, max(float((o - w).abs().max()) for o, w in zip(out, want)))
    rec = {"export_s": export_s, "load_s": load_s, "max_abs_err": err, "launches": launched,
           "p50_ms": float(np.median(times))}
    log(f"items 9 {family} export ({'with_real' if with_real else 'predict'}): export "
        f"{export_s:.2f} s, load {load_s:.3f} s, batch 1 and {len(lo32)} within {err} of the "
        f"model's own forward (bound {EXPORT_TOL}), p50 {rec['p50_ms']:.3f} ms at batch "
        f"{len(lo32)} over {I9_SERVE_CALLS} calls, kernel launches while serving {launched} "
        f"on {card}")
    assert err <= EXPORT_TOL, f"phase 23: {family} served {err} off"
    assert launched == 0, f"phase 23: {family} serving launched {launched} kernels"
    return rec


def i9_guard(dev, card):
    """Leg C's guard and scopes: a DeepFM ``CtrPassTrainer`` pass at the pass
    path's width on 2 batches with ``Adam(nan)`` under ``check_nan_inf``:
    it raises, the pass is discarded, the host table's digest is the one
    from before the pass, and ``ctr_train_step`` counted the steps run."""
    from paddle_tpu_torch.core import profiler
    from paddle_tpu_torch.core.enforce import PreconditionNotMetError
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.models import ctr
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.embedding_cache import CacheConfig
    from paddle_tpu_torch.ps.ps_trainer import CtrPassTrainer
    from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

    ds = ctr_dataset(ctr_lines(np.random.default_rng(60), 2 * BATCH, ZOO_IDS, SLOTS, DENSE),
                     SLOTS, DENSE)
    table = MemorySparseTable(TableConfig(shard_num=16,
                                          accessor_config=AccessorConfig(embedx_dim=DIM)))
    tr = CtrPassTrainer(ctr.DeepFM(ctr.CtrConfig(SLOTS, DENSE, DIM, (400, 400, 400)),
                                   generator=torch.Generator().manual_seed(0)),
                        Adam(float("nan")), table,
                        CacheConfig(capacity=MT_CAP, embedx_dim=DIM, embedx_threshold=0.0),
                        device=dev, **slot_names(SLOTS, DENSE))
    try:
        table.pull_sparse(np.unique(tr._tagged_pass_keys(ds)), create=True)
        before = table.digest()
        profiler.reset_host_events()
        set_flags({"check_nan_inf": True})
        try:
            tr.train_from_dataset(ds, batch_size=BATCH, drop_last=False)
            raise AssertionError("phase 23: a NaN pass trained through check_nan_inf")
        except PreconditionNotMetError as e:
            msg = str(e)
        finally:
            set_flags({"check_nan_inf": False})
        steps = profiler.host_event_stats().get("ctr_train_step", {}).get("count", 0)
        same = table.digest() == before
        log(f"items 9 guard: Adam(nan) pass raised {msg!r}; cache.state None "
            f"{tr.cache.state is None}; host table digest unchanged {same}; ctr_train_step "
            f"scopes {steps} for 2 steps on {card}")
        assert tr.cache.state is None and same, "phase 23: the diverged pass was not discarded"
        assert steps == 2, f"phase 23: ctr_train_step counted {steps} for 2 steps"
    finally:
        table.close()


def i9_runtime(dev, card, base):
    """Leg C's rest: a ``Trainer`` dump on the card, ``CUDAPlace``, and the
    axis-form ``reduce``/``split_axis``/``barrier`` over ``run_ranks`` on
    I9_MESH, card bitwise equal to the CPU."""
    from paddle_tpu_torch.core import places
    from paddle_tpu_torch.core.mesh import make_mesh
    from paddle_tpu_torch.executor import Trainer
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.layers import Linear
    from paddle_tpu_torch.ops import collectives as coll
    from paddle_tpu_torch.optimizer import SGD

    g = torch.Generator().manual_seed(3)
    model = torch.nn.Sequential(Linear(4, 8, generator=g), torch.nn.ReLU(),
                                Linear(8, 2, generator=g))
    tr = Trainer(model, SGD(0.1), F.cross_entropy, device=dev)
    d = os.path.join(base, "dump")
    tr.set_dump_config(d, fields=("loss", "input:0", "label:0"), trainer_id=0)
    rng = np.random.default_rng(4)
    for _ in range(3):
        tr.train_step(rng.normal(size=(8, 4)).astype(np.float32), rng.integers(0, 2, 8))
    tr.set_dump_config(None)
    lines = open(os.path.join(d, "trainer-000.dump")).read().strip().splitlines()
    fields = [l.split("\t")[1] for l in lines]
    assert len(lines) == 9 and fields == ["loss", "input:0", "label:0"] * 3, \
        f"phase 23: dump lines {lines}"
    if dev.type == "cuda":
        assert places.CUDAPlace(0).torch_device() == torch.device("cuda", 0)

    x = np.random.default_rng(5).integers(-8, 8, size=(4, 4, 6)).astype(np.float32)

    def run(device):
        m = make_mesh(I9_MESH, device=device)
        xs = torch.from_numpy(x).to(device)

        def f(r):
            return (coll.reduce(xs[r], "mp", root=1),
                    coll.reduce(xs[r], ("dp", "mp"), op=coll.ReduceOp.MAX),
                    coll.split_axis(xs[r], "dp", dim=0), coll.barrier("mp"))

        return coll.run_ranks(m, f)

    on_dev, on_cpu = run(dev), run(torch.device("cpu"))
    same = all(torch.equal(a.cpu(), b) for ra, rb in zip(on_dev, on_cpu)
               for a, b in zip(ra[:3], rb[:3])) and all(r[3] is None for r in on_dev)
    log(f"items 9 runtime: Trainer dump 3 steps x 3 fields; CUDAPlace(0) -> cuda:0; reduce / "
        f"split_axis / barrier over {I9_MESH} card == CPU bitwise {same} on {card}")
    assert same, "phase 23: the axis collectives differ between the card and the CPU"


def phase_item9(dev, card):
    """Phase 23: leg A (DIN, ESMM and MMoE on a pass each), leg B (DIN's
    and ESMM's exports served in this process), leg C (the NaN guard, the
    scopes, the dump, places, the axis collectives)."""
    import shutil as _shutil
    import tempfile

    t_phase = time.perf_counter()
    base = tempfile.mkdtemp(prefix="item9_")
    try:
        fam = {f: i9_pass(dev, card, f, base) for f in ("din", "esmm", "mmoe")}
        t_c = time.perf_counter()
        i9_guard(dev, card)
        i9_runtime(dev, card, base)
    finally:
        _shutil.rmtree(base, ignore_errors=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"items 9 (phase 23): {time.perf_counter() - t_phase:.1f} s (legs A and B "
        f"{t_c - t_phase:.1f} s, leg C {time.perf_counter() - t_c:.1f} s) on {card}")
    return {"families": fam}


# -- phase 24: item 8's first half: the pipelines, DeepWalk, the heter pipeline --

# Leg A: ERNIE (phase 7's width) through PipelineTrainer on PIPE_MESH, M
# micro-batches of [batch / M, 512]: f_then_b and 1f1b with 2 blocks a stage,
# interleave with 2 chunks of 1 block a rank; PIPE_WARM + PIPE_STEPS steps
# each; the 1f1b trainer's optimizer is fleet's GradientMerge chain (k 2)
# over Adam. Peak memory of one SGD step at PIPE_MEM_MICRO micro-batches.
PIPE_MESH = {"dp": 1, "pp": 4}
PIPE_MICRO, PIPE_MEM_MICRO, PIPE_WARM, PIPE_STEPS = 4, 8, 1, 3
PIPE_HOP = (2, 512, 16, 64)          # a micro-batch's attention: [batch / M, L, H, D]
PIPE_FIRST_LOSS_TOL = 1e-5           # the schedules' first losses, relative to f_then_b's
# card vs CPU at HYB_SMALL's widths, 4 layers deep on {"dp": 1, "pp": 2}
PIPE_SMALL_MESH, PIPE_SMALL_LAYERS, PIPE_SMALL_BATCH, PIPE_SMALL_STEPS = (
    {"dp": 1, "pp": 2}, 4, 4, 2)
# Adam's moments card vs CPU, relative to their norm: the gradients behind
# them differ by up to 2.1e-3 of their norm under SGD (measured on one H100:
# the small schedules' worst update difference), so 1e-2
PIPE_MOMENT_TOL = 1e-2
# Leg B: DeepWalk at Perozzi et al.'s (KDD 2014) widths: d 128, walk length
# 40, window 10; 5 negatives (word2vec's SGNS default); 1024 walks a step;
# a planted-community graph of DW_NODES nodes (communities of DW_COMMUNITY,
# 90 % of the edges inside), degrees 8-24 (mean 16), max_deg 32.
DW_NODES, DW_COMMUNITY, DW_MAX_DEG = 262_144, 256, 32
DW_DIM, DW_WALK, DW_WINDOW, DW_NEG, DW_BATCH, DW_STEPS = 128, 40, 10, 5, 1024, 8
# The sparse rule averages a key's gradient over its appearances (the show
# scale) and divides by sqrt(1 + its squared sum): at 0.3 (the JAX test's
# rate on a 20-node graph) 8 steps leave the loss flat; a CPU sweep at a
# quarter of the nodes and walks (same visits a node) fell 4.160 -> 4.135
# at 2.0, fell faster at 3.0 and diverged by step 8 at 5.0.
DW_LR = 2.0
# Leg C: the HeterPS shape at the pass path's widths (26 slots, embedx dim
# 8, batch 4096, a 400^3 tower), 16 micro-batches from a child process.
HET_ITEMS, HET_IDS, HET_SEED = 16, 10_000, 24
HET_READY = "HETER_HEAD_SENT "


def pipe_models(cfg, pp, seed=0, device="cpu"):
    """Two ``PipelineLayer``s over the same weights, drawn on ``device``
    from a generator of it: ``pp`` stages of ``num_layers / pp`` blocks,
    and ``num_layers`` stages of 1 block (the interleave's chunks); logical
    stage l holds block l."""
    from paddle_tpu_torch.models.ernie import ErnieEmbedding, ErnieHead, ErnieStage
    from paddle_tpu_torch.parallel import LayerDesc, PipelineLayer

    bps = cfg.num_layers // pp
    g = torch.Generator(device).manual_seed(seed)
    with torch.device(device):
        staged = PipelineLayer([LayerDesc(ErnieStage, cfg, bps, g) for _ in range(pp)],
                               embed=ErnieEmbedding(cfg, g), head=ErnieHead(cfg, g))
    with torch.device("meta"):
        per_block = PipelineLayer([LayerDesc(ErnieStage, cfg, 1) for _ in range(cfg.num_layers)],
                                  embed=ErnieEmbedding(cfg), head=ErnieHead(cfg))
    sd = {}
    for k, v in staged.state_dict().items():
        if k.startswith("stages."):
            _, s, _, b, rest = k.split(".", 4)
            k = f"stages.{int(s) * bps + int(b)}.blocks.0.{rest}"
        sd[k] = v
    per_block.load_state_dict(sd, assign=True)
    return staged, per_block


def pipe_launches_per_step(schedule, pp, micro, layers):
    """Flash launches a step: under f_then_b every rank runs every tick (M +
    pp − 1) through its blocks and the backward reaches the M valid ticks;
    under 1f1b and interleave each of the M·layers block items runs its
    forward twice (the item's, then its recompute in the backward) and its
    backward once."""
    bwd = micro * layers
    fwd = pp * (micro + pp - 1) * (layers // pp) if schedule == "f_then_b" else 2 * bwd
    return {"flash_attention_fwd": fwd, "flash_attention_bwd_dq": bwd,
            "flash_attention_bwd_dkv": bwd}


def pipe_gm_optimizer():
    """fleet's chain for ``gradient_merge`` (k 2) over Adam(1e-4)."""
    from paddle_tpu_torch.distributed import DistributedStrategy, Fleet, UserDefinedRoleMaker
    from paddle_tpu_torch.optimizer import Adam

    f = Fleet().init(UserDefinedRoleMaker())
    return f.distributed_optimizer(Adam(1e-4), DistributedStrategy(
        gradient_merge=True, gradient_merge_configs={"k_steps": 2}))


def pipe_trainer(model, opt, schedule, V, mesh, micro, device):
    from paddle_tpu_torch.core.mesh import make_mesh
    from paddle_tpu_torch.parallel import PipelineTrainer

    return PipelineTrainer(model, opt, lm_loss, make_mesh(mesh, device=device), micro,
                           schedule=schedule, num_virtual=V, device=device)


def pipe_leg_a(dev, card):
    """Full width: the three schedules' steps (launches against the formula,
    the GradientMerge chain's held step), their first losses, peak memory
    of f_then_b against 1f1b at PIPE_MEM_MICRO."""
    from paddle_tpu_torch.models.ernie import ErnieConfig
    from paddle_tpu_torch.optimizer import SGD, Adam

    cfg = ErnieConfig(**ERNIE_CFG, attn_impl="flash")
    pp, L = PIPE_MESH["pp"], cfg.num_layers
    t0 = time.perf_counter()
    staged, per_block = pipe_models(cfg, pp, device=dev)
    ids, labels = hybrid_batch(np.random.default_rng(32), cfg.vocab_size, ERNIE_BATCH,
                               ERNIE_SEQ, dev)
    _sync(dev)
    log(f"pipeline leg A: ERNIE {ERNIE_CFG} drawn on the card in {time.perf_counter() - t0:.2f} s")
    # (schedule, model, chunks a rank, optimizer, micro-batches, the GM chain)
    runs = (("f_then_b", staged, 1, Adam(1e-4), PIPE_MICRO, False),
            ("1f1b", staged, 1, pipe_gm_optimizer(), PIPE_MICRO, True),
            ("interleave", per_block, 2, Adam(1e-4), PIPE_MICRO, False),
            ("f_then_b", staged, 1, SGD(1e-4), PIPE_MEM_MICRO, False),
            ("1f1b", staged, 1, SGD(1e-4), PIPE_MEM_MICRO, False))
    reset_launches()
    rec, first, peak, above = {}, {}, {}, {}
    total = {k: 0 for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                            "flash_attention_bwd_dkv")}
    for schedule, model, V, opt, micro, gm in runs:
        mem = micro == PIPE_MEM_MICRO
        before = read_launches()
        t_setup = time.perf_counter()
        tr = pipe_trainer(model, opt, schedule, V, PIPE_MESH, micro, dev)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t_setup
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()     # the params and what earlier phases hold
        n_steps = 1 if mem else PIPE_WARM + PIPE_STEPS
        start = {k: v.clone() for k, v in tr.flat_params().items()} if gm else None
        losses = []
        for i in range(n_steps):
            if i == PIPE_WARM:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            losses.append(tr.train_step(ids, labels))
            if start is not None and i == 0:   # the chain's held step
                held = all(torch.equal(v, start[k]) for k, v in tr.flat_params().items())
                log(f"pipeline leg A 1f1b: the GradientMerge chain's first (held) step left "
                    f"every parameter unchanged: {held}")
                assert held, "pipeline leg A: a held GradientMerge step moved a parameter"
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0 if not mem else None
        got = {k: v - before[k] for k, v in read_launches().items() if k in total}
        want = {k: n_steps * n for k, n in pipe_launches_per_step(schedule, pp, micro, L).items()}
        for k in total:
            total[k] += got[k]
        losses = torch.stack(losses).cpu().numpy()
        if mem:
            peak[schedule] = torch.cuda.max_memory_allocated()
            above[schedule] = peak[schedule] - base
            log(f"pipeline leg A memory, {schedule} at M={micro}: one SGD step, loss "
                f"{losses[0]}, peak device memory {peak[schedule]} B ({above[schedule]} B above "
                f"the {base} B allocated before the step), flash launches {got} "
                f"(formula {want}), stashed inputs at most {tr.last_max_stash} a rank on {card}")
        else:
            first[schedule] = float(losses[0])
            rec[schedule] = {"ms_per_step": 1e3 * dt / PIPE_STEPS,
                             "tokens_per_s": ERNIE_BATCH * ERNIE_SEQ * PIPE_STEPS / dt,
                             "losses": losses.tolist(), "max_stash": tr.last_max_stash}
            log(f"pipeline leg A {schedule} (pp {pp}, V {V}, M {micro}): losses "
                f"{losses.tolist()}, {rec[schedule]['ms_per_step']:.3f} ms/step, "
                f"{rec[schedule]['tokens_per_s']:.1f} tokens/s ({PIPE_STEPS} timed steps after "
                f"{PIPE_WARM}; the trainer built in {t_setup:.2f} s), peak memory "
                f"{torch.cuda.max_memory_allocated()} B, stashed "
                f"inputs at most {tr.last_max_stash} a rank; flash launches {got} (formula "
                f"{want}) on {card}")
            assert np.isfinite(losses).all(), f"pipeline leg A {schedule}: non-finite loss"
            assert losses[-1] < losses[0], f"pipeline leg A {schedule}: loss did not fall"
        assert got == want, f"pipeline leg A {schedule} M={micro}: launches {got}, formula {want}"
        del tr
        torch.cuda.empty_cache()
    rel = {s: abs(v - first["f_then_b"]) / abs(first["f_then_b"]) for s, v in first.items()}
    log(f"pipeline leg A: first losses {first}, relative to f_then_b's {rel} (stated bound "
        f"{PIPE_FIRST_LOSS_TOL}); peak memory at M={PIPE_MEM_MICRO}: f_then_b {peak['f_then_b']} "
        f"B, 1f1b {peak['1f1b']} B ({peak['1f1b'] / peak['f_then_b']:.3f} of it; above the "
        f"step's start {above['1f1b'] / max(above['f_then_b'], 1):.3f}) on {card}")
    assert max(rel.values()) <= PIPE_FIRST_LOSS_TOL, f"pipeline leg A: first losses {first}"
    assert peak["1f1b"] < peak["f_then_b"], f"pipeline leg A: 1f1b peak memory {peak}"
    assert all(v > 0 for v in total.values()), f"pipeline leg A: a kernel never ran {total}"
    return {"schedules": rec, "peak": peak, "peak_above_start": above, "counts": total}


def pipe_small_run(device, schedule, make_opt, batches):
    """A small ERNIE through ``PipelineTrainer`` (HYB_SMALL's widths,
    PIPE_SMALL_LAYERS deep): (losses, start and end params, the end
    optimizer state; on the CPU)."""
    from paddle_tpu_torch.models.ernie import ErnieConfig

    cfg = ErnieConfig(**dict(HYB_SMALL, num_layers=PIPE_SMALL_LAYERS), attn_impl="flash")
    staged, per_block = pipe_models(cfg, PIPE_SMALL_MESH["pp"], seed=5)
    model, V = (per_block, 2) if schedule == "interleave" else (staged, 1)
    tr = pipe_trainer(model, make_opt(), schedule, V, PIPE_SMALL_MESH, 2, device)
    start = {k: v.cpu().clone() for k, v in tr.flat_params().items()}
    losses = [float(tr.train_step(i.to(device), y.to(device))) for i, y in batches]

    def on_cpu(t):
        return {k: on_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.cpu()

    return (np.asarray(losses), start, {k: v.cpu() for k, v in tr.flat_params().items()},
            on_cpu(tr.opt_state))


def pipe_leg_a_small(dev):
    """Card (the kernels) vs CPU (their plain versions) from the same
    weights. Each schedule under SGD(0.1), 2 steps: the losses and each
    tensor's update within HYB_TOL (the key bias left out, as phase 21
    does). 1f1b under fleet's GradientMerge chain over Adam(1e-3), a held
    and an apply step: Adam's moments within PIPE_MOMENT_TOL of their norm,
    and the update element by element within 1e-3·lr where the merged
    gradient is at least 1e-3 of its tensor's largest (Adam's first step is
    ±lr, so an element whose gradient is within rounding of 0 may move
    either way)."""
    from paddle_tpu_torch.optimizer import SGD

    H, D = HYB_SMALL["num_heads"], HYB_SMALL["hidden_size"] // HYB_SMALL["num_heads"]
    worst = {"loss": 0.0, "update": 0.0, "moments": 0.0, "adam_update": 0.0}
    cases = [(s, "SGD", lambda: SGD(0.1)) for s in ("f_then_b", "1f1b", "interleave")]
    cases.append(("1f1b", "GradientMerge(Adam)", pipe_gm_optimizer))
    for schedule, opt_name, make_opt in cases:
        t0 = time.perf_counter()
        rng = np.random.default_rng(64)
        batches = [hybrid_batch(rng, HYB_SMALL["vocab_size"], PIPE_SMALL_BATCH,
                                HYB_SMALL["max_seq_len"], "cpu") for _ in range(PIPE_SMALL_STEPS)]
        gl, w0, gp, gs = pipe_small_run(dev, schedule, make_opt, batches)
        cl, c0, cp, cs_ = pipe_small_run(torch.device("cpu"), schedule, make_opt, batches)
        assert all(torch.equal(w0[k], c0[k]) for k in w0), "pipeline small: weights differ"
        loss = float(np.max(np.abs(gl - cl) / np.abs(cl)))
        upd = mom = adam = 0.0
        for k, s in w0.items():
            dg, dc = gp[k] - s, cp[k] - s
            if opt_name == "SGD":
                if k.endswith("attn.qkv_b"):     # [stages, H·3·D]: drop the key bias
                    dg, dc = (d.reshape(-1, H, 3, D)[:, :, [0, 2]] for d in (dg, dc))
                if float(dc.norm()) > 0:
                    upd = max(upd, float((dg - dc).norm() / dc.norm()))
                continue
            for slot in ("m", "v"):
                a, b = gs["inner"][slot][k], cs_["inner"][slot][k]
                if float(b.norm()) > 0:
                    mom = max(mom, float((a - b).norm() / b.norm()))
            m = cs_["inner"]["m"][k]
            big = m.abs() >= 1e-3 * m.abs().max()
            if bool(big.any()):
                adam = max(adam, float((dg - dc)[big].abs().max()) / 1e-3)
        worst = {"loss": max(worst["loss"], loss), "update": max(worst["update"], upd),
                 "moments": max(worst["moments"], mom), "adam_update": max(worst["adam_update"],
                                                                          adam)}
        log(f"pipeline leg A small, {schedule} {opt_name} ({time.perf_counter() - t0:.2f} s): card "
            f"vs CPU losses {gl.tolist()} vs "
            f"{cl.tolist()} (worst relative {loss}); " + (
                f"worst relative update difference {upd} (stated bounds {HYB_TOL})"
                if opt_name == "SGD" else
                f"Adam's moments within {mom} of their norm (bound {PIPE_MOMENT_TOL}), the update "
                f"where |m| >= 1e-3 of its tensor's largest within {adam}·lr (bound 1e-3·lr)"))
        assert loss <= HYB_TOL["loss"] and upd <= HYB_TOL["update"] and \
            mom <= PIPE_MOMENT_TOL and adam <= 1e-3, \
            f"pipeline small {schedule} {opt_name}: {loss}, {upd}, {mom}, {adam}"
    return worst


def flash_kernel_times(dev, q, k, v, do, dlse, kw, what, worst):
    """B5–B7 timed at q, k, v (every (query, key) pair visible, so SDPA runs
    unmasked as the library call) beside their plain versions and byte
    bounds: the kernels line's numbers for ``what``."""
    from paddle_tpu_torch.ops import flash_attention as fa

    B, L, H, D = q.shape
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = ((do * out).sum(-1) - dlse).contiguous()
    bw = (q, k, v, do, lse, delta)
    runs = {"fwd": (lambda: fa.flash_attention_fwd(q, k, v, **kw),
                    lambda: fa.flash_attention_fwd_plain(q, k, v, **kw)),
            "dq": (lambda: fa.flash_attention_bwd_dq(*bw, **kw),
                   lambda: fa.flash_attention_bwd_dq_plain(*bw, **kw)),
            "dkv": (lambda: fa.flash_attention_bwd_dkv(*bw, **kw),
                    lambda: fa.flash_attention_bwd_dkv_plain(*bw, **kw))}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (t.permute(0, 2, 1, 3).to(torch.bfloat16).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    so = sdpa(qs, ks, vs)

    def sdpa_fwd():
        with torch.no_grad():
            sdpa(qs, ks, vs)

    lib_fwd, _ = time_cuda(sdpa_fwd)
    lib_bwd, _ = time_cuda(lambda: torch.autograd.grad(
        so, (qs, ks, vs), do.permute(0, 2, 1, 3).to(torch.bfloat16), retain_graph=True))
    bounds = fa_bounds(B, L, H, D)
    result = {}
    for name, (kern, plain_fn) in runs.items():
        ms_k, call_k = time_cuda(kern)
        ms_p, _ = time_cuda(plain_fn)
        nbytes, nops = bounds[name]
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, nops / BF16_OPS_PER_S * 1e3
        lib = lib_fwd if name == "fwd" else lib_bwd
        log(f"kernel flash_attention_{name}@{what} at {[B, L, H, D]} {kw}: device {ms_k} ms, "
            f"plain {ms_p} ms, bound {max(bytes_ms, ops_ms)} ms ({nbytes} B, {nops} bf16 ops), "
            f"scaled_dot_product_attention bf16 {'forward' if name == 'fwd' else 'backward'} "
            f"{lib} ms; per call from an idle card {call_k} ms")
        result[name] = {"max_abs_err": worst[name], "ms": ms_k, "plain_ms": ms_p,
                        "bound_ms": max(bytes_ms, ops_ms),
                        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                        "library_ms": lib}
    return result


def pipe_hop_kernels(dev):
    """B5–B7 at leg A's per-micro shape PIPE_HOP, not causal, with a
    numpy-seeded dO (dlse 0: the pipeline's attention has no ring): within
    ``FA_TOL`` of their plain versions on the card, twice the same bits;
    then timed for the kernels line."""
    from paddle_tpu_torch.ops import flash_attention as fa

    B, L, H, D = PIPE_HOP
    rng = np.random.default_rng(42)
    q, k, v, do = (torch.from_numpy(rng.normal(size=PIPE_HOP).astype(np.float32)).to(dev)
                   for _ in range(4))
    dlse = torch.zeros((B, L, H), device=dev)
    kw = dict(causal=False)

    def run():
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        delta = (do * out).sum(-1).contiguous()
        return (out, lse, fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
                *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)), delta

    got, delta = run()
    again, _ = run()
    torch.cuda.synchronize()
    same = all(bitwise_equal(a, b) for a, b in zip(got, again))
    out, lse, dq, dk, dv = got
    w_out, w_lse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    w_dq = fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
    w_dk, w_dv = fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
    errs = {"out": max_abs(out, w_out), "lse": max_abs(lse, w_lse), "dq": max_abs(dq, w_dq),
            "dk": max_abs(dk, w_dk), "dv": max_abs(dv, w_dv)}
    tol = FA_TOL["default"]
    ok = same and all(bool(torch.isfinite(t).all()) for t in got) and \
        all(e <= tol.get(n, tol["grad"]) for n, e in errs.items())
    log(f"kernel flash_attention pipeline micro-batch {list(PIPE_HOP)} not causal: max_abs "
        f"{errs} (stated bounds {tol}), two runs bitwise {same}")
    assert ok, "pipeline hop kernels disagree with their plain versions"
    worst = {"fwd": max(errs["out"], errs["lse"]), "dq": errs["dq"],
             "dkv": max(errs["dk"], errs["dv"])}
    return flash_kernel_times(dev, q, k, v, do, dlse, kw, "pipeline", worst)


def dw_graph(rng):
    """The planted-community graph: (nodes [N] uint64 = 0..N-1, neighbours
    [N, DW_MAX_DEG] uint64 padded with 0, degrees [N] int32)."""
    n = DW_NODES
    deg = rng.integers(8, 25, n)
    local = (np.arange(n) // DW_COMMUNITY * DW_COMMUNITY)[:, None] + \
        rng.integers(0, DW_COMMUNITY, (n, DW_MAX_DEG))
    far = rng.integers(0, n, (n, DW_MAX_DEG))
    nbrs = np.where(rng.random((n, DW_MAX_DEG)) < 0.9, local, far)
    nbrs = np.where(np.arange(DW_MAX_DEG)[None, :] < deg[:, None], nbrs, 0)
    return np.arange(n, dtype=np.uint64), nbrs.astype(np.uint64), deg.astype(np.int32)


def dw_cache(dev, nodes, dim, capacity, seed, lr):
    """A 16-shard host table with both tagged tables' rows made by
    ``init_node_embeddings``, and an ``HbmEmbeddingCache`` pass over them."""
    from paddle_tpu_torch.models import graph_embedding as ge
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.embedding_cache import CacheConfig, HbmEmbeddingCache
    from paddle_tpu_torch.ps.sgd_rule import SGDRuleConfig
    from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

    sgd = SGDRuleConfig(learning_rate=lr, initial_g2sum=1.0)
    table = MemorySparseTable(TableConfig(shard_num=16, accessor_config=AccessorConfig(
        embedx_dim=dim, embedx_threshold=0.0, sgd=sgd)))
    cfg = CacheConfig(capacity=capacity, embedx_dim=dim, embedx_threshold=0.0, sgd=sgd)
    ge.init_node_embeddings(table, nodes, np.random.default_rng(seed), scale=0.1)
    cache = HbmEmbeddingCache(table, cfg, device=dev, device_map=True)
    cache.begin_pass(np.concatenate([ge.tag_center(nodes), ge.tag_context(nodes)]))
    return table, cache, cfg


def dw_walks_on_edges(walk, nbrs, deg):
    """Every step of every walk of ``walk`` (wh, wl, live read back) is an
    edge of the host graph, or a frozen dead end: (steps checked, live steps)."""
    wh, wl, live = (t.cpu().numpy() for t in walk)
    assert (wh == 0).all(), "DeepWalk: a walk left the raw-node key space"
    slots = np.arange(nbrs.shape[1])[None, :]
    for t in range(wl.shape[1] - 1):
        cur, nxt = wl[:, t].astype(np.int64), wl[:, t + 1]
        edge = ((nbrs[cur] == nxt[:, None].astype(np.uint64)) & (slots < deg[cur][:, None])).any(1)
        ok = np.where(live[:, t + 1], edge, nxt == wl[:, t])
        assert ok.all(), f"DeepWalk: walk step {t} left the graph for {int((~ok).sum())} walks"
    return wl.size - wl.shape[0], int(live[:, 1:].sum())


def dw_leg_b(dev, card):
    """DeepWalk at the published widths: one pass, DW_STEPS steps; B1 once a
    step and bitwise on the first push; the loss falls; one batch of walks
    checked against the graph."""
    from paddle_tpu_torch.models import DeepWalkConfig, make_deepwalk_train_step
    from paddle_tpu_torch.ops.device_graph import DeviceGraph

    t0 = time.perf_counter()
    nodes, nbrs, deg = dw_graph(np.random.default_rng(24))
    graph = DeviceGraph.from_arrays(nodes, nbrs, deg, device=dev)
    t_graph = time.perf_counter() - t0
    table, cache, cfg = dw_cache(dev, nodes, DW_DIM, 1 << 20, 25, DW_LR)
    t_pass = time.perf_counter() - t0 - t_graph
    step = make_deepwalk_train_step(graph, cfg, DeepWalkConfig(DW_WALK, DW_WINDOW, DW_NEG, DW_DIM),
                                    pool_lo=nodes.astype(np.uint32))
    gen = torch.Generator(dev).manual_seed(26)
    orig_walk, walks = DeviceGraph.random_walk, []

    def keep_first(*a):
        out = orig_walk(*a)
        if not walks:
            walks.append(out)
        return out

    push = restore = None
    if dev.type == "cuda":
        push, restore = capture_first_push()
    DeviceGraph.random_walk = staticmethod(keep_first)
    _sync(dev)
    reset_launches()
    losses, marks = [], []
    try:
        for _ in range(DW_STEPS):
            marks.append(time.perf_counter())
            starts = torch.randint(0, DW_NODES, (DW_BATCH,), generator=gen, device=dev)
            cache.state, loss = step(cache.state, cache.device_map.state, starts, gen)
            losses.append(loss)
            if len(marks) == 1:
                _sync(dev)
        _sync(dev)
    finally:
        DeviceGraph.random_walk = staticmethod(orig_walk)
        if restore is not None:
            restore()
    ms = 1e3 * (time.perf_counter() - marks[1]) / (DW_STEPS - 1)
    first_ms = 1e3 * (marks[1] - marks[0])
    counts = read_launches()
    losses = torch.stack(losses).cpu().numpy()
    pairs = DW_BATCH * DW_WALK * 2 * DW_WINDOW
    checked, live = dw_walks_on_edges(walks[0], nbrs, deg)
    log(f"DeepWalk leg B: {DW_NODES} nodes (mean degree {deg.mean():.3f}, max_deg {DW_MAX_DEG}, "
        f"capped rows {graph.capped_rows}) uploaded in {t_graph:.2f} s, a pass of "
        f"{2 * DW_NODES} tagged keys at dim {DW_DIM} in {t_pass:.2f} s (host); {DW_STEPS} steps "
        f"of {DW_BATCH} walks x {DW_WALK} steps, window {DW_WINDOW}, {DW_NEG} negatives "
        f"({pairs} pair slots, {pairs * (2 + DW_NEG)} pulled rows a step): the first step "
        f"{first_ms:.3f} ms, the other {DW_STEPS - 1} {ms:.3f} ms a step (host clock, each span "
        f"ends in a sync), losses {losses.tolist()}, launches {counts}; the first batch's "
        f"{checked} walk steps ({live} live) all on edges or frozen, on {card}")
    assert np.isfinite(losses).all(), f"DeepWalk: non-finite loss {losses}"
    assert losses[-1] < losses[0], f"DeepWalk: the loss did not fall {losses}"
    rec = {"steps": DW_STEPS, "ms_per_step": ms, "losses": losses.tolist(),
           "launches": counts["ctr_sparse_rows"], "b1": {}}
    if dev.type == "cuda":
        assert counts["ctr_sparse_rows"] == counts["merge_sparse_grads"] == DW_STEPS, \
            f"DeepWalk: B1/merge launches {counts} != steps {DW_STEPS}"
        # the plain version takes ~0.1 s a call at this n: 5 timed calls
        rec["b1"] = wd_b1_check(push, dim=DW_DIM, what="DeepWalk push", plain_reps=5)
    cache.end_pass()
    table.close()
    return rec


def dw_communities(dev, card):
    """JAX's ``test_deepwalk_learns_communities`` on the card: two 10-cliques
    and a bridge from ``from_graph_table``, 60 steps of 64 walks (length 6,
    window 2, 4 negatives, dim 16): link-prediction AUC > 0.8."""
    from paddle_tpu_torch.models import DeepWalkConfig, make_deepwalk_train_step
    from paddle_tpu_torch.models import graph_embedding as ge
    from paddle_tpu_torch.ops.device_graph import DeviceGraph
    from paddle_tpu_torch.ps.graph_table import GraphTable

    k = 10
    g = GraphTable(shard_num=4, seed=0)
    src = [b + i for b in (0, k) for i in range(k) for j in range(k) if i != j] + [0, k]
    dst = [b + j for b in (0, k) for i in range(k) for j in range(k) if i != j] + [k, 0]
    g.add_graph_node(list(range(2 * k)))
    g.add_edges(src, dst)
    nodes = np.arange(2 * k, dtype=np.uint64)
    table, cache, cfg = dw_cache(dev, nodes, 16, 1 << 8, 0, 0.3)
    step = make_deepwalk_train_step(DeviceGraph.from_graph_table(g, 32, device=dev), cfg,
                                    DeepWalkConfig(6, 2, 4, 16), pool_lo=nodes.astype(np.uint32))
    gen = torch.Generator(dev).manual_seed(0)
    losses = []
    for _ in range(60):
        starts = torch.randint(0, 2 * k, (64,), generator=gen, device=dev)
        cache.state, loss = step(cache.state, cache.device_map.state, starts, gen)
        losses.append(loss)
    losses = torch.stack(losses).cpu().numpy()
    intra = np.array([[b + i, b + j] for b in (0, k) for i in range(k) for j in range(k)
                      if i != j])
    cross = np.array([[i, k + j] for i in range(2, k) for j in range(2, k)])
    auc = ge.link_prediction_auc(cache, intra, cross)
    log(f"DeepWalk two 10-cliques on the card: losses {losses[0]} -> {losses[-1]}, "
        f"link-prediction AUC {auc} (bound > 0.8) on {card}")
    assert losses[-1] < losses[0] * 0.8 and auc > 0.8, f"DeepWalk communities: AUC {auc}"
    cache.end_pass()
    table.close()
    return auc


def dist_graph_check():
    """A ``DistGraphClient`` over 3 port ``NativePsServer``s answers the
    2-hop sampling loop in the local ``GraphTable``'s shapes (JAX
    ``tests/test_dist_graph.py:129-144``), with its degrees."""
    from paddle_tpu_torch.ps import rpc
    from paddle_tpu_torch.ps.graph_client import DistGraphClient
    from paddle_tpu_torch.ps.graph_table import GraphTable

    servers = [rpc.NativePsServer(n_trainers=1) for _ in range(3)]
    client = rpc.RpcPsClient([f"127.0.0.1:{s.port}" for s in servers])
    try:
        out = []
        for g in (GraphTable(shard_num=2), DistGraphClient(client, table_id=11)):
            rng = np.random.default_rng(3)
            nodes = np.arange(1, 201, dtype=np.uint64)
            g.add_graph_node(nodes, rng.normal(size=(200, 5)).astype(np.float32))
            g.add_edges(rng.choice(nodes, 1200), rng.choice(nodes, 1200),
                        rng.uniform(0.1, 2.0, 1200).astype(np.float32))
            seeds = np.asarray([1, 2, 3], np.uint64)
            n1, m1 = g.sample_neighbors(seeds, 4, weighted=False)
            n2, m2 = g.sample_neighbors(n1.reshape(-1), 4, weighted=False)
            out.append(((n1.shape, m1.shape, n2.shape, m2.shape, n1.dtype, m2.dtype),
                        g.get_node_degree(nodes), g.node_count, g.edge_count))
    finally:
        client.close()
        for s in servers:
            s.close()
    same = out[0][0] == out[1][0] and np.array_equal(out[0][1], out[1][1]) and \
        out[0][2:] == out[1][2:]
    log(f"DistGraphClient over 3 servers: 2-hop shapes {out[1][0]}, {out[1][2]} nodes, "
        f"{out[1][3]} edges; shapes, degrees and counts equal to the local GraphTable's: {same}")
    assert same, f"DistGraphClient: {out[1][0]} vs {out[0][0]}"


def het_keys(rng):
    """[BATCH, SLOTS] slot-tagged keys (slot in the high half, HET_IDS ids a slot)."""
    ids = rng.integers(0, HET_IDS, (BATCH, SLOTS)).astype(np.uint64)
    return (np.arange(SLOTS, dtype=np.uint64)[None, :] << np.uint64(32)) | ids


def heter_head_child(port):
    """``--heter-head PORT``: the CPU head of leg C; HET_ITEMS micro-batches
    (keys, dense features, labels) from a numpy seed over the channel, then
    STOP."""
    from paddle_tpu_torch.parallel.heter_channel import ChannelClient

    rng = np.random.default_rng(HET_SEED)
    cli = ChannelClient("127.0.0.1", int(port))
    for i in range(HET_ITEMS):
        cli.send({"idx": np.asarray(i), "keys": het_keys(rng),
                  "dense": rng.random((BATCH, DENSE), dtype=np.float32),
                  "labels": (rng.random(BATCH) < 0.25).astype(np.float32)})
    cli.send_stop()
    cli.close()
    print(f"{HET_READY}{HET_ITEMS}", flush=True)
    return 0


def het_sections(dev):
    """(the three section functions, the table, the tower's params, the log
    of table operations, the items seen): host pull → the tower's step on the
    card (Adam) → host push; the pull and push log their order under one lock."""
    import threading

    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

    table = MemorySparseTable(TableConfig(shard_num=16,
                                          accessor_config=AccessorConfig(embedx_dim=DIM)))
    g = torch.Generator().manual_seed(HET_SEED)
    width = SLOTS * (1 + DIM) + DENSE
    tower = torch.nn.Sequential(Linear(width, 400, generator=g), torch.nn.ReLU(),
                                Linear(400, 400, generator=g), torch.nn.ReLU(),
                                Linear(400, 400, generator=g), torch.nn.ReLU(),
                                Linear(400, 1, generator=g)).to(dev)
    params = {k: v.detach() for k, v in tower.named_parameters()}
    opt = Adam(1e-3)
    state = {"params": params, "opt": opt.init(params), "losses": []}
    order, items, lock = [], {}, threading.Lock()

    def pull(item):
        i = int(item["idx"])
        keys = item["keys"]
        with lock:
            pulled = table.pull_sparse(keys.ravel())
            order.append(("pull", i))
        items[i] = item
        emb = pulled[:, 2:].reshape(BATCH, SLOTS * (1 + DIM))
        return i, keys, emb, item["dense"], item["labels"]

    def card_step(x):
        i, keys, emb, dense, labels = x
        e = torch.from_numpy(np.ascontiguousarray(emb)).to(dev).requires_grad_(True)
        y = torch.from_numpy(np.array(labels)).to(dev)
        p = {k: v.requires_grad_(True) for k, v in state["params"].items()}
        logit = torch.func.functional_call(tower, p, (torch.cat(
            [e, torch.from_numpy(np.array(dense)).to(dev)], dim=1),))[:, 0]
        loss = torch.nn.functional.binary_cross_entropy_with_logits(logit, y)
        got = torch.autograd.grad(loss, [e, *p.values()])
        new, state["opt"] = opt.update(dict(zip(p, got[1:])), state["opt"],
                                       {k: v.detach() for k, v in p.items()})
        state["params"] = new
        state["losses"].append(loss.detach())
        return i, keys, got[0].cpu().numpy(), labels

    def push(x):
        i, keys, ge, labels = x
        n = keys.size
        vals = np.zeros((n, 3 + 1 + DIM), np.float32)
        vals[:, 1] = 1.0
        vals[:, 2] = np.repeat(np.asarray(labels), SLOTS)
        vals[:, 3:] = ge.reshape(n, 1 + DIM)
        with lock:
            table.push_sparse(keys.ravel(), vals)
            order.append(("push", i))
        return i

    return (pull, card_step, push), table, state, order, items


def het_head_start():
    """The channel's server and the CPU head's child (started at the phase's
    start, so its interpreter's start overlaps legs A and B; it blocks on the
    channel's bounded queue until leg C reads)."""
    from paddle_tpu_torch.parallel.heter_channel import ChannelServer

    srv = ChannelServer(capacity=4)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    child = subprocess.Popen([sys.executable, PSJOB_SCRIPT, "--heter-head", str(srv.port)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return srv, child


def het_leg_c(dev, card, head):
    """The HeterPS shape across two processes: a child runs the CPU head and
    sends HET_ITEMS micro-batches over ``ChannelClient``; here
    ``HeterPipelineTrainer([pull, card step, push])`` runs them from
    ``channel_source``. Items in order, the table and the tower bitwise equal
    to a serial replay (one thread, the run's order of table operations),
    the child's exit 0, the card section's busy spans overlapping the host
    sections'."""
    from paddle_tpu_torch.parallel.heter_channel import channel_source
    from paddle_tpu_torch.parallel.heter_pipeline import HeterPipelineTrainer, SectionConfig

    srv, child = head
    fns, table, state, order, items = het_sections(dev)
    t0 = time.perf_counter()
    try:
        tr = HeterPipelineTrainer([SectionConfig(fns[0], "cpu"), SectionConfig(fns[1], "gpu"),
                                   SectionConfig(fns[2], "cpu")], channel_capacity=2)
        out = tr.run(channel_source(srv, timeout=120))
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        try:
            stdout, stderr = child.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            child.kill()
            stdout, stderr = child.communicate()
    assert child.returncode == 0, f"leg C head child rc {child.returncode}: {stderr[-2000:]}"
    assert out == list(range(HET_ITEMS)), f"leg C: items out of order {out}"
    assert [i for op, i in order if op == "pull"] == list(range(HET_ITEMS)), "leg C: pull order"
    host = tr.spans[0] + tr.spans[2]
    overlap = sum(max(0.0, min(e, f) - max(s, r)) for s, e in tr.spans[1] for r, f in host)
    busy = {n: sum(e - s for s, e in sp) for n, sp in zip(("pull", "card", "push"), tr.spans)}

    s_fns, s_table, s_state, s_order, _ = het_sections(dev)
    pulled, trained = {}, 0
    for op, i in order:       # the serial replay: the run's order of table operations
        if op == "pull":
            pulled[i] = s_fns[0](items[i])
            continue
        while trained <= i:
            pulled[trained] = s_fns[1](pulled[trained])
            trained += 1
        s_fns[2](pulled[i])
    keys = np.unique(np.concatenate([items[i]["keys"].ravel() for i in items]))
    same_table = bool(np.array_equal(table.export_full(keys)[0], s_table.export_full(keys)[0]))
    same_tower = all(torch.equal(state["params"][k], s_state["params"][k])
                     for k in state["params"])
    losses = torch.stack(state["losses"]).cpu().numpy()
    same_loss = bool(np.array_equal(losses, torch.stack(s_state["losses"]).cpu().numpy()))
    log(f"heter leg C: {HET_ITEMS} micro-batches of {BATCH} x {SLOTS} slots from a child "
        f"process ({stdout.strip()!r}, rc {child.returncode}) in {wall:.2f} s (the child started "
        f"with the phase); in order; section "
        f"busy seconds {busy}, card spans overlapping host spans {overlap:.4f} s; losses "
        f"{losses[0]} -> {losses[-1]}; table ({len(keys)} keys), tower and losses bitwise equal "
        f"to the serial replay: {same_table}, {same_tower}, {same_loss} on {card}")
    assert overlap > 0, "leg C: the card section never overlapped a host section"
    assert same_table and same_tower and same_loss, "leg C: the pipeline differs from the replay"
    assert np.isfinite(losses).all(), "leg C: non-finite loss"
    table.close()
    s_table.close()
    return {"overlap_s": overlap, "busy_s": busy, "wall_s": wall}


def phase_item8(dev, card):
    """Phase 24: leg A (ERNIE through PipelineTrainer, full width and card vs
    CPU small; B5–B7 at the micro-batch shape), leg B (DeepWalk at the
    published widths, the communities on the card, DistGraphClient), leg C
    (the heter pipeline across two processes)."""
    t_phase = time.perf_counter()
    head = het_head_start()
    try:
        a = pipe_leg_a(dev, card)
        t_small = time.perf_counter()
        pipe_leg_a_small(dev)
        a["kernels"] = pipe_hop_kernels(dev)
        torch.cuda.empty_cache()
        t_b = time.perf_counter()
        b = dw_leg_b(dev, card)
        dw_communities(dev, card)
        dist_graph_check()
        torch.cuda.empty_cache()
        t_c = time.perf_counter()
        c = het_leg_c(dev, card, head)
    finally:
        srv, child = head
        if child.poll() is None:
            child.kill()
            child.communicate()
        srv.close()
    log(f"item 8 (phase 24): {time.perf_counter() - t_phase:.1f} s (leg A {t_small - t_phase:.1f} "
        f"s and its small runs and kernels {t_b - t_small:.1f} s, leg B {t_c - t_b:.1f} s, leg C "
        f"{time.perf_counter() - t_c:.1f} s) on {card}")
    return {"pipeline": a, "deepwalk": b, "heter": c}


# -- phase 25: item 8's second half: the planner, the fleet executor, the elastic launcher --

# Leg A: ERNIE at phase 7's width. The planner traces it on meta tensors, completes
# the two-hint Megatron layout on a (dp 2, mp 2) mesh, and plans 4 devices under
# a budget that forces a split (the parameter bytes × 4 / 2 × 1.01, as JAX's
# test_planner_bridge_realistic_width); the plan runs through
# hybrid_trainer_from_plan on PLAN_BATCH × 512 in PLAN_MICRO micro-batches (1 warm
# and PLAN_STEPS timed steps); then Engine(plan="auto") fits ENGINE_STEPS batches
# beside a Trainer on the same weights and batches.
PLAN_DEVICES, PLAN_BATCH, PLAN_MICRO, PLAN_STEPS, ENGINE_STEPS = 4, 8, 4, 2, 3
PLAN_HINTS = {"blocks.0.attn.qkv_w": [-1, 1], "blocks.0.ffn.w_in": [-1, 1]}
# Leg B: phase 24 leg C's HeterPS shape (26 slots, embedx dim 8, batch 4096, a
# 400^3 tower) through the pass path's DeepFM step; FE_ITEMS micro-batches made
# and packed in a child process, credits FE_CREDITS on every edge.
FE_ITEMS, FE_CREDITS, FE_SEED, FE_CAP = 16, 2, 25, 1 << 19
FE_READY = "FLEET_SOURCE_DONE "
# Leg C: elastic_launch_local over 2 trainer processes (min_np 1, max_np 2); rank 1
# crashes once; EL_ITEMS pass-path DeepFM steps, each from the same saved weights
# on its own batch.
EL_ITEMS, EL_SEED, EL_CAP = 4, 26, 1 << 18


def plan_ernie_model(cfg, dev):
    """The serial ERNIE of phase 7, drawn from a seed on the CPU, on ``dev``."""
    from paddle_tpu_torch.models.ernie import Ernie

    return Ernie(cfg, generator=torch.Generator().manual_seed(0)).to(dev)


def plan_leg_a(dev, card):
    """The planner at ERNIE's full width: trace (no launch), complete the
    two-hint layout, choose a split plan for PLAN_DEVICES devices and run it
    through the hybrid trainer (first loss against the serial model, launches
    against the formula); then Engine(plan="auto") against a Trainer."""
    import copy
    import tempfile

    from paddle_tpu_torch.distributed import auto_parallel as ap
    from paddle_tpu_torch.distributed.completion import trace_param_graph
    from paddle_tpu_torch.executor import Trainer
    from paddle_tpu_torch.models.ernie import Ernie, ErnieConfig
    from paddle_tpu_torch.optimizer import Adam

    cfg = ErnieConfig(**ERNIE_CFG)
    with torch.device("meta"):
        meta_model = Ernie(cfg)
    meta_ids = torch.empty(PLAN_BATCH, ERNIE_SEQ, dtype=torch.int64, device="meta")
    reset_launches()
    t0 = time.perf_counter()
    graph = trace_param_graph(meta_model, [meta_ids])
    t_trace = time.perf_counter() - t0
    specs = ap.complete_shardings(meta_model, ap.ProcessMesh(shape=(2, 2), dim_names=("dp", "mp")),
                                  PLAN_HINTS, example_inputs=[meta_ids])
    pbytes = sum(p.numel() * p.element_size() for p in meta_model.parameters())
    t0 = time.perf_counter()
    mesh, ann, cands = ap.choose_strategy(meta_model, batch_tokens=PLAN_BATCH * ERNIE_SEQ,
                                          n_devices=PLAN_DEVICES,
                                          per_device_bytes=pbytes * 4.0 / 2 * 1.01,
                                          example_inputs=[meta_ids], allow_sh=False)
    t_plan = time.perf_counter() - t0
    traced = read_launches()
    assert not any(traced.values()), f"plan leg A: the trace launched a kernel {traced}"
    want_pairs = {"attn.qkv_w": (None, "mp"), "attn.qkv_b": ("mp",), "attn.proj_w": ("mp",),
                  "attn.proj_b": (), "ffn.w_in": (None, "mp"), "ffn.b_in": ("mp",),
                  "ffn.w_out": ("mp",), "ffn.b_out": ()}
    bad = [(f"blocks.{b}.{k}", specs[f"blocks.{b}.{k}"]) for b in range(cfg.num_layers)
           for k, v in want_pairs.items() if specs[f"blocks.{b}.{k}"] != v]
    assert not bad, f"plan leg A: the completed layout breaks a Megatron pair {bad}"
    assert len(graph.uses) == 2 + 4 * cfg.num_layers + 1, len(graph.uses)
    chosen = next(c for c in cands if c.get("chosen"))
    dims = dict(zip(mesh.dim_names, mesh.shape))
    log(f"plan leg A: ERNIE {ERNIE_CFG} ({pbytes} parameter bytes) traced on meta tensors in "
        f"{t_trace:.2f} s ({len(graph.uses)} uses, no launch); two hints completed every "
        f"block's Megatron pairs ({len(specs)} layouts); choose_strategy over {PLAN_DEVICES} "
        f"devices under {pbytes * 4.0 / 2 * 1.01:.0f} B in {t_plan:.2f} s: {len(cands)} "
        f"candidates, chosen (dp, mp, pp) = ({dims['dp']}, {dims['mp']}, {dims['pp']}), sh "
        f"{chosen['sh']}, recompute {chosen['recompute']}, {chosen['per_device_state_bytes']:.0f} "
        f"B a device, total_s {chosen['total_s']}, hints {len(ann)}")
    assert chosen["fits"] and dims["dp"] * dims["mp"] * dims["pp"] == PLAN_DEVICES

    # the plan on the card, against the serial model on the trainer's weights
    t0 = time.perf_counter()
    trainer = ap.hybrid_trainer_from_plan(cfg, mesh, Adam(1e-4), num_micro=PLAN_MICRO, seed=0,
                                          device=dev)
    ids, labels = hybrid_batch(np.random.default_rng(33), cfg.vocab_size, PLAN_BATCH,
                               ERNIE_SEQ, dev)
    serial = Ernie(cfg).to(dev)
    serial.load_state_dict(trainer.serial_state_dict())
    with torch.no_grad():
        want_loss = float(serial.loss(ids, labels))
    del serial
    _sync(dev)
    t_build = time.perf_counter() - t0
    shape = {"dp": dims["dp"], "pp": dims["pp"], "cp": 1, "mp": dims["mp"]}
    formula = hybrid_launches_per_step(cfg, shape, PLAN_MICRO)
    reset_launches()
    losses = [trainer.train_step(ids, labels)]
    first = float(losses[0])
    one = {k: v for k, v in read_launches().items() if k in formula}
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(PLAN_STEPS):
        losses.append(trainer.train_step(ids, labels))
    _sync(dev)
    ms = 1e3 * (time.perf_counter() - t0) / PLAN_STEPS
    counts = {k: v for k, v in read_launches().items() if k in formula}
    losses = torch.stack(losses).cpu().numpy()
    rel = abs(first - want_loss) / abs(want_loss)
    log(f"plan leg A: hybrid_trainer_from_plan over {shape} (built with the serial check in "
        f"{t_build:.2f} s), M={PLAN_MICRO}, batch {PLAN_BATCH} x {ERNIE_SEQ}: losses "
        f"{losses.tolist()}, first {first} vs the serial model's {want_loss} (relative "
        f"{rel:.3e}, stated bound {PIPE_FIRST_LOSS_TOL}), {ms:.3f} ms/step over {PLAN_STEPS} "
        f"steps after 1, flash launches a step {one} (formula {formula}), in all {counts} on "
        f"{card}")
    assert rel <= PIPE_FIRST_LOSS_TOL, f"plan leg A: first loss {first} vs serial {want_loss}"
    if dev.type == "cuda":   # the plain versions on the CPU count nothing
        assert one == formula, f"plan leg A: launches {one}, formula {formula}"
        assert counts == {k: (1 + PLAN_STEPS) * v for k, v in formula.items()}, counts
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    hop = (PLAN_BATCH // (PLAN_MICRO * dims["dp"]), ERNIE_SEQ, cfg.num_heads // dims["mp"],
           cfg.head_dim)
    # the kernels line times B5-B7 for this plan at phase 24's micro-batch
    # shape (the @pipeline rows): a plan that splits the batch or the heads
    # otherwise would run them at a shape no phase times
    assert hop == PIPE_HOP, f"plan leg A: attention at {hop}, timed only at {PIPE_HOP}"
    del trainer
    torch.cuda.empty_cache()

    # Engine(plan="auto") beside a Trainer on the same weights and batches
    model = plan_ernie_model(cfg, dev)
    twin = copy.deepcopy(model)
    rng = np.random.default_rng(34)
    batches = [hybrid_batch(rng, cfg.vocab_size, PLAN_BATCH, ERNIE_SEQ, dev)
               for _ in range(ENGINE_STEPS + 1)]
    card_bytes = (torch.cuda.get_device_properties(0).total_memory if dev.type == "cuda"
                  else ap.H100_MEMORY_BYTES)
    engine = ap.Engine(model, lm_loss, Adam(1e-4), plan="auto", n_devices=PLAN_DEVICES,
                       per_device_bytes=card_bytes, batch_tokens=PLAN_BATCH * ERNIE_SEQ,
                       example_inputs=[meta_ids], device=dev)
    reset_launches()
    t0 = time.perf_counter()
    got = engine.fit([((i,), (l,)) for i, l in batches[:ENGINE_STEPS]])
    t_fit = time.perf_counter() - t0
    fit_counts = read_launches()
    reset_launches()
    val = engine.evaluate([((batches[0][0],), (batches[0][1],))])
    pred = engine.predict(batches[0][0])
    eval_counts = read_launches()
    ref_tr = Trainer(twin, Adam(1e-4), lm_loss, device=dev)
    want = [float(ref_tr.train_step(i, l)) for i, l in batches[:ENGINE_STEPS]]
    with tempfile.TemporaryDirectory(prefix="engine_") as tmp:
        t0 = time.perf_counter()
        engine.save(os.path.join(tmp, "snap"))
        nxt = engine.fit([((batches[-1][0],), (batches[-1][1],))])
        engine.load(os.path.join(tmp, "snap"))
        again = engine.fit([((batches[-1][0],), (batches[-1][1],))])
        t_ckpt = time.perf_counter() - t0
    comp = engine.completion(batches[0][0], batches[0][1])
    L = cfg.num_layers
    per_step = {"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L}
    fit_want = {k: ENGINE_STEPS * v for k, v in per_step.items()}
    fit_got = {k: fit_counts[k] for k in per_step}
    eval_got = {k: eval_counts[k] for k in per_step}
    log(f"plan leg A: Engine(plan='auto', n_devices={PLAN_DEVICES}, per_device_bytes="
        f"{card_bytes}) chose mesh {dict(zip(engine.process_mesh.dim_names, engine.process_mesh.shape))} "
        f"sh {engine.sharding_stage} with {len(engine.annotations)} hints; fit {got} in "
        f"{t_fit:.2f} s, a Trainer on the same weights and batches {want} (bitwise: "
        f"{got == want}); evaluate {val}, predict {tuple(pred.shape)}; save, one more step "
        f"{nxt}, load, the step again {again} ({t_ckpt:.2f} s); completion() reports "
        f"{sum(1 for v in comp['param_specs'].values() if v)} sharded of "
        f"{len(comp['param_specs'])} layouts, batch over {comp['input_shardings'][2]}; flash "
        f"launches fit {fit_got} (formula {fit_want}), evaluate + predict {eval_got} on {card}")
    assert got == want, f"plan leg A: Engine losses {got} vs Trainer's {want}"
    assert nxt == again, f"plan leg A: Engine load did not restore the state: {nxt} vs {again}"
    assert np.isfinite(val) and tuple(pred.shape) == (PLAN_BATCH, ERNIE_SEQ, cfg.vocab_size)
    if dev.type == "cuda":
        assert fit_got == fit_want, f"plan leg A: Engine fit launches {fit_got}, want {fit_want}"
        assert eval_got == {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": 0,
                            "flash_attention_bwd_dkv": 0}, eval_got
    assert set(comp["param_specs"]) == set(dict(model.named_parameters()))
    del engine, ref_tr, model, twin
    torch.cuda.empty_cache()
    return {"plan": dims, "candidates": len(cands), "first_loss": first, "serial_loss": want_loss,
            "ms_per_step": ms, "hop": hop, "engine_losses": got}


def fe_conf(seed, items):
    """What a leg's child processes need to make the same micro-batches."""
    return {"batch": BATCH, "ids": HET_IDS, "items": items, "seed": seed}


def fe_item(i, conf):
    """Micro-batch ``i`` of ``conf``: ([batch, SLOTS] slot-tagged keys, dense
    [batch, DENSE] f32, labels [batch] i32) from a numpy seed."""
    rng = np.random.default_rng((conf["seed"], i))
    b = conf["batch"]
    ids = rng.integers(0, conf["ids"], (b, SLOTS)).astype(np.uint64)
    keys = (np.arange(SLOTS, dtype=np.uint64)[None, :] << np.uint64(32)) | ids
    dense = rng.random((b, DENSE), dtype=np.float32)
    labels = (rng.random(b) < 0.25).astype(np.int32)
    return keys, dense, labels


def fe_pack(item):
    """The pass path's wire buffer of an ``fe_item``."""
    from paddle_tpu_torch.models.ctr import pack_ctr_batch

    keys, dense, labels = item
    lo32 = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return pack_ctr_batch(lo32, dense, labels, weights=np.ones(len(labels), np.float32))


def fe_pass_trainer(dev, capacity, keys, batch):
    """The pass path's DeepFM (phase 3's width, Adam 1e-3) over a fresh
    16-shard host table with a pass over ``keys`` active: (trainer, step,
    the device map's state)."""
    from paddle_tpu_torch.models import ctr
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.accessor import AccessorConfig
    from paddle_tpu_torch.ps.embedding_cache import CacheConfig
    from paddle_tpu_torch.ps.ps_trainer import CtrPassTrainer
    from paddle_tpu_torch.ps.table import MemorySparseTable, TableConfig

    model = ctr.DeepFM(ctr.CtrConfig(SLOTS, DENSE, DIM, (400, 400, 400)),
                       generator=torch.Generator().manual_seed(0))
    table = MemorySparseTable(TableConfig(shard_num=16,
                                          accessor_config=AccessorConfig(embedx_dim=DIM)))
    tr = CtrPassTrainer(model, Adam(1e-3), table,
                        CacheConfig(capacity=capacity, embedx_dim=DIM, embedx_threshold=0.0),
                        device=dev, **slot_names(SLOTS, DENSE))
    tr.cache.activate_pass(tr.cache.prepare_pass(np.unique(keys.ravel())))
    return tr, tr._packed_step(batch), tr.cache.device_map.state


def fe_nodes(fns, n):
    """The leg's task graph of ``n`` micro-batches: source (0) → pack (1) in
    the child, card step (2) → sink (3) here; ``fns`` gives the local nodes'
    functions."""
    from paddle_tpu_torch.distributed.fleet_executor import TaskNode

    return [TaskNode(0, fn=fns.get(0), role="source", max_run_times=n,
                     downstreams=[(1, FE_CREDITS)]),
            TaskNode(1, fn=fns.get(1), max_run_times=n, upstreams=[0],
                     downstreams=[(2, FE_CREDITS)]),
            TaskNode(2, fn=fns.get(2), max_run_times=n, upstreams=[1],
                     downstreams=[(3, FE_CREDITS)]),
            TaskNode(3, fn=fns.get(3), role="sink", max_run_times=n, upstreams=[2])]


FE_PLACEMENT = {0: 0, 1: 0, 2: 1, 3: 1}


def fleet_source_child(path):
    """``--fleet-source CONFIG.json``: rank 0 of leg B, the source and the CPU
    pack stage, over a RemoteMessageBus signed with the config's secret;
    prints its interceptors' in-flight peaks at the end."""
    from paddle_tpu_torch.distributed.fleet_executor import Carrier, RemoteMessageBus

    with open(path) as f:
        conf = json.load(f)

    def emit(i):
        return i, time.monotonic(), fe_item(i, conf)

    def pack(x):
        i, t, item = x
        return i, t, fe_pack(item)

    addrs = {r: ("127.0.0.1", int(p)) for r, p in enumerate(conf["ports"])}
    bus = RemoteMessageBus(0, addrs, FE_PLACEMENT, connect_timeout=600.0,
                           secret=bytes.fromhex(conf["secret"]))
    carrier = Carrier(fe_nodes({0: emit, 1: pack}, conf["items"]),
                      feeds={0: list(range(conf["items"]))}, bus=bus, local_ids=[0, 1])
    carrier.start()
    carrier.wait(timeout=900.0)
    peaks = {t: carrier.interceptors[t].peak_in_flight for t in (0, 1)}
    bus.close()
    print(f"{FE_READY}{json.dumps(peaks)}", flush=True)
    return 0


def fe_source_start(base):
    """Leg B's child, started with the phase so its interpreter's start
    overlaps leg A (it dials this process until leg B's bus listens); its
    config (ports, the bus's secret, the micro-batches) goes in ``base``."""
    import socket

    ports = []
    for _ in range(2):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    conf = dict(fe_conf(FE_SEED, FE_ITEMS), ports=ports, secret=os.urandom(16).hex())
    path = os.path.join(base, "fleet_source.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    child = subprocess.Popen([sys.executable, PSJOB_SCRIPT, "--fleet-source", path], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return child, conf


def fe_leg_b(dev, card, source):
    """The fleet executor over the pass path: the child's source and pack stage
    feed this process's card step (one B1 a step) and sink over a signed
    RemoteMessageBus; losses, dense params and cache rows bitwise against the
    same steps run serially here; no edge beyond its credits."""
    from paddle_tpu_torch.distributed.fleet_executor import Carrier, RemoteMessageBus

    child, conf = source
    items = [fe_item(i, conf) for i in range(FE_ITEMS)]
    keys = np.concatenate([it[0].ravel() for it in items])
    tr, step, map_state = fe_pass_trainer(dev, FE_CAP, keys, conf["batch"])
    state = {"losses": {}}

    def card_step(x):
        i, t, packed = x
        p = torch.from_numpy(packed).to(dev)
        tr.params, tr.opt_state, tr.cache.state, loss = step(tr.params, tr.opt_state,
                                                             tr.cache.state, map_state, p)
        return i, t, loss

    def sink(x):
        i, _, loss = x
        state["losses"][i] = float(loss)          # the loss on the host: the step is done
        return i, time.monotonic()

    addrs = {r: ("127.0.0.1", p) for r, p in enumerate(conf["ports"])}
    bus = RemoteMessageBus(1, addrs, FE_PLACEMENT, connect_timeout=120.0,
                           secret=bytes.fromhex(conf["secret"]))
    reset_launches()
    t0 = time.perf_counter()
    t_start = time.monotonic()
    try:
        carrier = Carrier(fe_nodes({2: card_step, 3: sink}, FE_ITEMS), bus=bus,
                          local_ids=[2, 3])
        carrier.start()
        carrier.wait(timeout=300.0)
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        bus.close()
    launches = read_launches()
    stdout, stderr = child.communicate(timeout=120)
    assert child.returncode == 0, f"leg B source child rc {child.returncode}: {stderr[-2000:]}"
    line = next(ln for ln in stdout.splitlines() if ln.startswith(FE_READY))
    peaks = {int(k): {int(d): n for d, n in v.items()}
             for k, v in json.loads(line[len(FE_READY):]).items()}
    peaks[2] = dict(carrier.interceptors[2].peak_in_flight)
    outs = carrier.sinks[0].outputs
    assert [i for i, _ in outs] == list(range(FE_ITEMS)), f"leg B: items out of order {outs}"
    done_at = [t_start] + [t for _, t in outs]
    walls = [b - a for a, b in zip(done_at, done_at[1:])]

    s_tr, s_step, s_map = fe_pass_trainer(dev, FE_CAP, keys, conf["batch"])
    s_losses = []
    for it in items:
        p = torch.from_numpy(fe_pack(it)).to(dev)
        s_tr.params, s_tr.opt_state, s_tr.cache.state, loss = s_step(
            s_tr.params, s_tr.opt_state, s_tr.cache.state, s_map, p)
        s_losses.append(float(loss))
    losses = [state["losses"][i] for i in range(FE_ITEMS)]
    same_loss = losses == s_losses
    same_dense = all(torch.equal(tr.params[k], s_tr.params[k]) for k in tr.params)
    same_rows = all(torch.equal(a, b) for a, b in zip(tr.cache.state.values(),
                                                       s_tr.cache.state.values()))
    peak = max(n for v in peaks.values() for n in v.values())
    log(f"fleet leg B: {FE_ITEMS} micro-batches of {conf['batch']} x {SLOTS} slots made and packed in "
        f"a child process, over an HMAC-signed RemoteMessageBus, through the pass path's "
        f"DeepFM step here (credits {FE_CREDITS}) in {wall:.2f} s; each micro-batch's wall "
        f"(its loss on this host after the previous one's, the first after the carrier's "
        f"start; seconds) {[round(w, 4) for w in walls]}; in-flight peaks by interceptor {peaks}; B1 launches "
        f"{launches['ctr_sparse_rows']} (one a step); losses {losses[0]} -> {losses[-1]}; "
        f"losses, dense params and cache rows bitwise equal to the serial run: {same_loss}, "
        f"{same_dense}, {same_rows} on {card}")
    assert dev.type != "cuda" or launches["ctr_sparse_rows"] == FE_ITEMS, \
        f"leg B: B1 launches {launches}"
    assert peak <= FE_CREDITS, f"leg B: an edge held {peak} micro-batches > {FE_CREDITS} credits"
    assert same_loss and same_dense and same_rows, "leg B: the executor differs from the serial run"
    assert np.isfinite(losses).all(), f"leg B: non-finite loss {losses}"
    tr.table.close()
    s_tr.table.close()
    return {"wall_s": wall, "walls_s": walls, "peaks": peaks, "b1": launches["ctr_sparse_rows"]}


def el_item_step(dev, weights, i, conf):
    """One pass-path DeepFM step on leg C's batch ``i`` from ``weights``
    (a fresh table, cache and Adam state): the loss as a float."""
    keys, dense, labels = fe_item(i, conf)
    tr, step, map_state = fe_pass_trainer(dev, conf["cap"], keys, conf["batch"])
    tr.params = {k: v.to(dev) for k, v in weights.items()}
    tr.opt_state = tr.optimizer.init(tr.params)
    p = torch.from_numpy(fe_pack((keys, dense, labels))).to(dev)
    _, _, _, loss = step(tr.params, tr.opt_state, tr.cache.state, map_state, p)
    out = float(loss)
    tr.table.close()
    return out


def elastic_trainer_child(config_path):
    """``--elastic-trainer CONFIG.json``: one trainer of leg C, started by
    elastic_launch_local. Rank 1 crashes once (before touching the card); the
    others take the items ``i % world == rank`` not yet done, each written to a
    done-file made with a hard link, so an item is done at most once."""
    with open(config_path) as f:
        conf = json.load(f)
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    eps = os.environ["PADDLE_TRAINER_ENDPOINTS"].split(",")
    base = conf["base"]
    marker = os.path.join(base, "crashed_once")
    if rank == 1 and not os.path.exists(marker):
        open(marker, "w").close()
        os._exit(17)
    dev = torch.device(conf["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    weights = torch.load(os.path.join(base, "weights.pt"))
    for i in range(conf["items"]):
        done = os.path.join(base, f"item_{i}.json")
        if i % world != rank or os.path.exists(done):
            continue
        loss = el_item_step(dev, weights, i, conf)
        tmp = f"{done}.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"loss": loss.hex(), "rank": rank, "world": world, "eps": len(eps)}, f)
        os.link(tmp, done)   # fails if the item was already done
        os.remove(tmp)
    return 0


def elastic_leg_c(dev, card):
    """elastic_launch_local over two trainer processes on the card: rank 1
    crashes once, the supervisor restarts the world at size 1 with the env
    rewritten, every item is done exactly once, each loss bitwise equal to
    the same step run here."""
    import tempfile

    from paddle_tpu_torch.distributed.launch import JobSpec, elastic_launch_local
    from paddle_tpu_torch.models import ctr

    base = tempfile.mkdtemp(prefix="elastic_")
    try:
        model = ctr.DeepFM(ctr.CtrConfig(SLOTS, DENSE, DIM, (400, 400, 400)),
                           generator=torch.Generator().manual_seed(EL_SEED))
        weights = {k: v.detach() for k, v in model.named_parameters()}
        torch.save(weights, os.path.join(base, "weights.pt"))
        conf = dict(fe_conf(EL_SEED, EL_ITEMS), base=base, device=dev.type, cap=EL_CAP)
        path = os.path.join(base, "config.json")
        with open(path, "w") as f:
            json.dump(conf, f)
        logs = os.path.join(base, "logs")
        t0 = time.perf_counter()
        rc = elastic_launch_local(JobSpec([PSJOB_SCRIPT, "--elastic-trainer", path], nproc=2,
                                          log_dir=logs, env={"OMP_NUM_THREADS": "1"}),
                                  min_np=1, max_np=2, heartbeat_interval=0.1,
                                  heartbeat_ttl=0.5, elastic_timeout=0.5, timeout=300)
        wall = time.perf_counter() - t0
        gens = sorted(os.listdir(logs))
        done = {}
        for i in range(EL_ITEMS):
            with open(os.path.join(base, f"item_{i}.json")) as f:
                done[i] = json.load(f)
        want = [el_item_step(dev, weights, i, conf) for i in range(EL_ITEMS)]
        got = [float.fromhex(done[i]["loss"]) for i in range(EL_ITEMS)]
        restarts = len({g.split(".")[1] for g in gens}) - 1
        log(f"elastic leg C: elastic_launch_local(2 trainers, min_np 1, max_np 2) rc {rc} in "
            f"{wall:.2f} s, generations' logs {gens} ({restarts} restart), rank 1 crashed once: "
            f"{os.path.exists(os.path.join(base, 'crashed_once'))}; items done by "
            f"{[(d['rank'], d['world'], d['eps']) for d in done.values()]} (rank, "
            f"PADDLE_TRAINERS_NUM, endpoints); losses {got}, the same steps here {want} "
            f"(bitwise: {got == want}) on {card}")
        assert rc == 0, f"leg C: elastic_launch_local rc {rc}"
        assert restarts == 1, f"leg C: {restarts} restarts ({gens})"
        assert sorted(n for n in os.listdir(base) if n.startswith("item_")) == sorted(
            f"item_{i}.json" for i in range(EL_ITEMS)), os.listdir(base)
        # rank 1's share ran in the relaunched world of one; rank 0 of the
        # first world may have finished its own share before the restart
        assert all(d["eps"] == d["world"] and (d["world"] == 1 or i % 2 == 0)
                   for i, d in done.items()), done
        assert all(done[i]["world"] == 1 for i in range(1, EL_ITEMS, 2)), done
        assert got == want, f"leg C: losses {got} vs {want}"
        return {"wall_s": wall, "restarts": restarts}
    finally:
        shutil.rmtree(base, ignore_errors=True)


def phase_item8b(dev, card):
    """Phase 25: leg A (the planner at ERNIE's width, its plan on the hybrid
    trainer, Engine), leg B (the fleet executor over the pass path across two
    processes), leg C (the elastic launcher with trainers on the card)."""
    import tempfile

    t_phase = time.perf_counter()
    base = tempfile.mkdtemp(prefix="item8b_")
    source = fe_source_start(base)
    try:
        a = plan_leg_a(dev, card)
        t_b = time.perf_counter()
        b = fe_leg_b(dev, card, source)
        torch.cuda.empty_cache()
        t_c = time.perf_counter()
        c = elastic_leg_c(dev, card)
    finally:
        child = source[0]
        if child.poll() is None:
            child.kill()
            child.communicate()
        shutil.rmtree(base, ignore_errors=True)
    log(f"item 8b (phase 25): {time.perf_counter() - t_phase:.1f} s (leg A {t_b - t_phase:.1f} "
        f"s, leg B {t_c - t_b:.1f} s, leg C {time.perf_counter() - t_c:.1f} s) on {card}")
    return {"plan": a, "fleet": b, "elastic": c}


# -- phase 26: dense data parallel and ZeRO (item 7's first half) ---------------------

SPMD_MESH = {"dp": 4}                     # leg A: batch 8 over 4 ranks
SPMD_ZERO3_MESH = {"sharding": 4}         # stage 3's GSPMD path cuts over "sharding"
SPMD_RANK = (2, 512, 16, 64)              # a rank's attention: [batch / dp, L, H, D]
SPMD_WARM, SPMD_STEPS, SPMD_LR = 2, 4, 1e-4
# every rung's first loss against the stage-0 GSPMD rung's, relative: the same
# weights and batch, only the per-rank split of the mean (and cuBLAS at M = 1024
# tokens a rank against 4096) differ
SPMD_FIRST_LOSS_TOL = 2e-5
SPMD_SH_MESH = {"dp": 1, "pp": 2, "cp": 1, "mp": 2, "sh": 2}
SPMD_SH_DP_MESH = {"dp": 2, "pp": 2, "cp": 1, "mp": 2}   # the same batch split, no sh
SPMD_SMALL_BATCH, SPMD_SMALL_STEPS, SPMD_SH_STEPS, SPMD_SMALL_LR = 8, 3, 3, 0.5
# leg B, card (the kernels) vs CPU (their plain versions): HYB_TOL's bounds
SPMD_TOL = {"loss": 1e-4, "update": 5e-2}
# the sh trainer against the dp=2 trainer on one device: the same ranks' work,
# the same rank-order sums; relative, losses and each tensor's update by norm
SPMD_SH_TOL = 1e-5


def spmd_rungs():
    """(name, ZeRO stage, comm config or None for the GSPMD path, mesh)."""
    return (("stage0 gspmd", 0, None, SPMD_MESH),
            ("fp32 fused", 0, dict(), SPMD_MESH),
            ("fp32 unfused", 0, dict(fuse=False), SPMD_MESH),
            ("bf16 fused", 0, dict(quant="bf16"), SPMD_MESH),
            ("int8 fused", 0, dict(quant="int8"), SPMD_MESH),
            ("zero1 fused", 1, dict(), SPMD_MESH),
            ("zero2 fused", 2, dict(), SPMD_MESH),
            ("zero3 gspmd", 3, None, SPMD_ZERO3_MESH))


def spmd_zero_slices(tr, stage, fused, what):
    """Each rank's ZeRO slice holds 1/4 of its leaf: a flat shard of the
    padded leaf (fused stages 1-2), or 1/4 of the rows on the cut dim
    (GSPMD stage 3: the slots and the params)."""
    from paddle_tpu_torch.parallel.spmd import RankSlices

    if fused:
        leaves = list(tr.opt_state["inner"]["m"].values())
    else:
        leaves = list(tr.opt_state["m"].values()) + list(tr.state["params"].values())
    sliced = [x for x in leaves if isinstance(x, RankSlices)]
    K = 4
    ok = bool(sliced) and all(
        len(x.parts) == K and all((p.numel() if x.dim is None else p.shape[x.dim]) * K ==
                                  (x.full().numel() if x.dim is None else x.full().shape[x.dim])
                                  for p in x.parts) for x in sliced)
    log(f"spmd leg A {what}: {len(sliced)} of {len(leaves)} ZeRO leaves held as {K} rank "
        f"slices, each 1/{K} of its leaf's rows: {ok}")
    assert ok, f"spmd leg A {what}: a ZeRO slice is not 1/{K} of its leaf"


def spmd_leg_a(dev, card):
    """ERNIE at full width through ``SpmdTrainer`` on 4 logical ranks: the
    rungs of :func:`spmd_rungs` from one set of weights and one batch, each
    SPMD_WARM + SPMD_STEPS Adam steps."""
    from paddle_tpu_torch.core.mesh import make_mesh
    from paddle_tpu_torch.distributed.comm_fusion import CommFusionConfig
    from paddle_tpu_torch.models.ernie import Ernie, ErnieConfig
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel.spmd import SpmdTrainer

    cfg = ErnieConfig(**ERNIE_CFG)       # attn_impl "auto": B5-B7 on the card
    L, K = cfg.num_layers, SPMD_MESH["dp"]
    t0 = time.perf_counter()
    model = Ernie(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    ids, labels = hybrid_batch(np.random.default_rng(33), cfg.vocab_size, ERNIE_BATCH,
                               ERNIE_SEQ, dev)
    _sync(dev)
    log(f"spmd leg A: ERNIE {ERNIE_CFG} built on the card in {time.perf_counter() - t0:.2f} s")
    steps = SPMD_WARM + SPMD_STEPS
    names = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    threaded = {k: 0 for k in names}
    whole = {k: 0 for k in names}
    rec, first, kept = {}, {}, {}
    reset_launches()
    for name, stage, comm, shape in spmd_rungs():
        before = read_launches()
        t_setup = time.perf_counter()
        tr = SpmdTrainer(model, Adam(SPMD_LR), lm_loss, make_mesh(shape, device=dev),
                         zero_stage=stage, device=dev,
                         comm=None if comm is None else CommFusionConfig(**comm))
        _sync(dev)
        t_setup = time.perf_counter() - t_setup
        torch.cuda.reset_peak_memory_stats()
        losses = []
        for i in range(steps):
            if i == SPMD_WARM:
                _sync(dev)
                t0 = time.perf_counter()
            losses.append(tr.train_step(ids, labels))
        _sync(dev)
        dt = time.perf_counter() - t0
        got = {k: v - before[k] for k, v in read_launches().items() if k in threaded}
        fused = comm is not None
        want = steps * L * (K if fused else 1)
        for k in names:
            (threaded if fused else whole)[k] += got[k]
        losses = torch.stack(losses).cpu().numpy()
        first[name] = float(losses[0])
        rec[name] = {"ms_per_step": 1e3 * dt / SPMD_STEPS,
                     "tokens_per_s": ERNIE_BATCH * ERNIE_SEQ * SPMD_STEPS / dt,
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "losses": losses.tolist()}
        log(f"spmd leg A {name} (stage {stage}, mesh {shape}): losses {losses.tolist()}, "
            f"{rec[name]['ms_per_step']:.3f} ms/step, {rec[name]['tokens_per_s']:.1f} tokens/s "
            f"({SPMD_STEPS} timed steps after {SPMD_WARM}; built in {t_setup:.2f} s), peak "
            f"memory {rec[name]['peak_bytes']} B, flash launches {got} (want {want} each) on "
            f"{card}")
        assert np.isfinite(losses).all(), f"spmd leg A {name}: non-finite loss"
        assert losses[-1] < losses[0], f"spmd leg A {name}: loss did not fall"
        assert all(got[k] == want for k in names), f"spmd leg A {name}: launches {got}, {want}"
        if stage:
            spmd_zero_slices(tr, stage, fused, name)
        if name in ("fp32 fused", "fp32 unfused"):
            kept[name] = {k: v.clone() for k, v in tr.full_state()[0]["params"].items()}
        del tr
        torch.cuda.empty_cache()
    rel = {n: abs(v - first["stage0 gspmd"]) / abs(first["stage0 gspmd"])
           for n, v in first.items()}
    a, b = kept["fp32 fused"], kept["fp32 unfused"]
    same = all(bitwise_equal(a[k], b[k]) for k in a)
    log(f"spmd leg A: first losses relative to stage 0 GSPMD's {rel} (stated bound "
        f"{SPMD_FIRST_LOSS_TOL}); fused fp32 after {steps} steps bitwise equal to the unfused "
        f"per-tensor rung: {same}")
    assert max(rel.values()) <= SPMD_FIRST_LOSS_TOL, f"spmd leg A: first losses {first}"
    assert same, "spmd leg A: fused fp32 differs from the per-tensor rung"
    return {"rungs": rec, "first_rel": rel, "counts": threaded, "whole_batch_counts": whole}


def spmd_small_weights():
    from paddle_tpu_torch.models.ernie import Ernie, ErnieConfig

    model = Ernie(ErnieConfig(**HYB_SMALL), generator=torch.Generator().manual_seed(26))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def spmd_small_run(device, impl, stage, comm, weights, batches):
    """SPMD_SMALL_STEPS SGD steps of a small ERNIE over SPMD_MESH: (losses,
    end params on the CPU). SGD, not Adam: an int8 code that rounds the
    other way on a last-bit gradient difference moves its element by a
    quantum, which Adam's normalization would blow up to a whole step."""
    from paddle_tpu_torch.core.mesh import make_mesh
    from paddle_tpu_torch.distributed.comm_fusion import CommFusionConfig
    from paddle_tpu_torch.models.ernie import Ernie, ErnieConfig
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.parallel.spmd import SpmdTrainer

    model = Ernie(ErnieConfig(**HYB_SMALL, attn_impl=impl))
    model.load_state_dict(weights)
    tr = SpmdTrainer(model, SGD(SPMD_SMALL_LR), lm_loss, make_mesh(SPMD_MESH, device=device),
                     zero_stage=stage, comm=CommFusionConfig(**comm), device=device)
    losses = [float(tr.train_step(i.to(device), y.to(device))) for i, y in batches]
    return np.asarray(losses), {k: v.cpu() for k, v in tr.full_state()[0]["params"].items()}


def spmd_update_gap(start, got, want, cfg=HYB_SMALL):
    """The worst tensor's ||Δgot − Δwant|| / ||Δwant|| (the key bias left out:
    its true gradient is 0, so Adam moves it on rounding noise); ``cfg``:
    the ERNIE widths the params have."""
    H, D = cfg["num_heads"], cfg["hidden_size"] // cfg["num_heads"]
    worst = 0.0
    for k, s in start.items():
        dg, dw = got[k] - s, want[k] - s
        if k.endswith("attn.qkv_b"):
            dg, dw = (d.reshape(*d.shape[:-1], H, 3, D)[..., [0, 2], :] for d in (dg, dw))
        if float(dw.norm()) > 0:
            worst = max(worst, float((dg - dw).norm() / dw.norm()))
    return worst


def spmd_sh_run(device, impl, shape, batches, cfg_kw=HYB_SMALL, opt=None):
    """The hybrid trainer over ``shape`` (SGD(SPMD_SMALL_LR) unless ``opt``):
    (losses, start and end params on the CPU, the trainer)."""
    from paddle_tpu_torch.core.mesh import make_mesh
    from paddle_tpu_torch.models.ernie import ErnieConfig
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.parallel.hybrid import HybridParallelTrainer, flatten_tree

    tr = HybridParallelTrainer(ErnieConfig(**{**cfg_kw, "attn_impl": impl}),
                               make_mesh(shape, device=device), opt or SGD(SPMD_SMALL_LR),
                               num_micro=HYB_MICRO, seed=26, device=device)
    start = {k: v.cpu().clone() for k, v in flatten_tree(tr.params).items()}
    losses = [tr.train_step(i.to(device), y.to(device)) for i, y in batches]
    losses = np.asarray([float(x) for x in losses])
    return losses, start, {k: v.cpu() for k, v in flatten_tree(tr.params).items()}, tr


def spmd_leg_b(dev, card):
    """Small (HYB_SMALL's widths): fused int8 and fused ZeRO-2 over
    SPMD_MESH, card vs CPU; the hybrid trainer's sh mesh card vs CPU and
    against the dp mesh without sh; then SPMD_SH_STEPS steps of the sh mesh
    at ERNIE's full width."""
    cpu = torch.device("cpu")
    weights = spmd_small_weights()
    rng = np.random.default_rng(61)
    batches = [hybrid_batch(rng, HYB_SMALL["vocab_size"], SPMD_SMALL_BATCH,
                            HYB_SMALL["max_seq_len"], "cpu") for _ in range(SPMD_SMALL_STEPS)]
    start = {k: v.clone() for k, v in weights.items()}
    worst = {}
    for what, stage, comm in (("int8 fused", 0, dict(quant="int8")), ("zero2 fused", 2, {})):
        gl, gp = spmd_small_run(dev, "auto", stage, comm, weights, batches)
        cl, cp = spmd_small_run(cpu, "flash", stage, comm, weights, batches)
        loss = float(np.max(np.abs(gl - cl) / np.abs(cl)))
        upd = spmd_update_gap(start, gp, cp)
        worst[what] = {"loss": loss, "update": upd}
        log(f"spmd leg B {what}: card vs CPU losses {gl.tolist()} vs {cl.tolist()} (worst "
            f"relative {loss}), worst relative update difference {upd} (stated bounds "
            f"{SPMD_TOL})")
        assert loss <= SPMD_TOL["loss"] and upd <= SPMD_TOL["update"], \
            f"spmd leg B {what}: {loss}, {upd}"
    gl, s0, gp, _ = spmd_sh_run(dev, "auto", SPMD_SH_MESH, batches)
    cl, c0, cp, _ = spmd_sh_run(cpu, "flash", SPMD_SH_MESH, batches)
    dl, d0, dp, _ = spmd_sh_run(dev, "auto", SPMD_SH_DP_MESH, batches)
    assert all(torch.equal(s0[k], c0[k]) and torch.equal(s0[k], d0[k]) for k in s0), \
        "spmd leg B: the sh runs' weights differ"
    loss = float(np.max(np.abs(gl - cl) / np.abs(cl)))
    upd = spmd_update_gap(s0, gp, cp)
    sh_loss = float(np.max(np.abs(gl - dl) / np.abs(dl)))
    sh_upd = spmd_update_gap(s0, gp, dp)
    worst["sh"] = {"loss": loss, "update": upd, "vs_dp_loss": sh_loss, "vs_dp_update": sh_upd}
    log(f"spmd leg B hybrid {SPMD_SH_MESH}: card vs CPU losses {gl.tolist()} vs {cl.tolist()} "
        f"(worst relative {loss}), worst relative update difference {upd} (bounds {SPMD_TOL}); "
        f"against {SPMD_SH_DP_MESH} on the card: losses {dl.tolist()} (worst relative "
        f"{sh_loss}), updates {sh_upd} (bound {SPMD_SH_TOL})")
    assert loss <= SPMD_TOL["loss"] and upd <= SPMD_TOL["update"], f"spmd leg B sh: {loss}, {upd}"
    assert sh_loss <= SPMD_SH_TOL and sh_upd <= SPMD_SH_TOL, \
        f"spmd leg B sh vs dp: {sh_loss}, {sh_upd}"
    return worst


def spmd_sh_full_width(dev, card):
    """SPMD_SH_STEPS Adam steps of the hybrid trainer over SPMD_SH_MESH at
    ERNIE's full width: finite losses, the launch formula, ms a step."""
    from paddle_tpu_torch.models.ernie import ErnieConfig

    cfg_kw = dict(ERNIE_CFG)
    batches = [hybrid_batch(np.random.default_rng(62), cfg_kw["vocab_size"], ERNIE_BATCH,
                            ERNIE_SEQ, dev)] * SPMD_SH_STEPS
    torch.cuda.reset_peak_memory_stats()
    before = read_launches()
    t0 = time.perf_counter()
    from paddle_tpu_torch.optimizer import Adam

    losses, _, _, tr = spmd_sh_run(dev, cfg_kw.get("attn_impl", "auto"), SPMD_SH_MESH, batches,
                                   cfg_kw, Adam(SPMD_LR))
    _sync(dev)
    dt = time.perf_counter() - t0
    got = {k: v - before[k] for k, v in read_launches().items() if k.startswith("flash")}
    want = {k: SPMD_SH_STEPS * n for k, n in
            hybrid_launches_per_step(ErnieConfig(**cfg_kw), SPMD_SH_MESH, HYB_MICRO).items()}
    sliced = sum(1 for v in tr.opt_state["m"].values() if type(v).__name__ == "RankSlices")
    log(f"spmd leg B hybrid {SPMD_SH_MESH} at full width: losses {losses.tolist()}, "
        f"{SPMD_SH_STEPS} steps in {dt:.2f} s (the trainer's build included; "
        f"{1e3 * dt / SPMD_SH_STEPS:.1f} ms a step), peak memory "
        f"{torch.cuda.max_memory_allocated()} B, {sliced} of {len(tr.opt_state['m'])} Adam "
        f"slots held as sh slices, flash launches {got} (formula {want}) on {card}")
    assert np.isfinite(losses).all(), "spmd leg B: non-finite loss on the sh mesh"
    assert got == want, f"spmd leg B sh: launches {got}, formula {want}"
    assert sliced > 0, "spmd leg B sh: no slot is held as sh slices"
    return {"losses": losses.tolist(), "s": dt, "launches": got}


def phase_spmd(dev, card):
    """Phase 26: leg A (ERNIE at full width, dense DP and ZeRO over 4
    logical ranks), leg B (small card-vs-CPU parity of fused int8, ZeRO-2
    and the hybrid sh axis; the sh mesh at full width)."""
    t_phase = time.perf_counter()
    assert PIPE_HOP == SPMD_RANK, "the rank's attention shape is not phase 24's"
    a = spmd_leg_a(dev, card)
    torch.cuda.empty_cache()
    t_b = time.perf_counter()
    b = spmd_leg_b(dev, card)
    c = spmd_sh_full_width(dev, card)
    torch.cuda.empty_cache()
    log(f"spmd (phase 26): {time.perf_counter() - t_phase:.1f} s (leg A {t_b - t_phase:.1f} s, "
        f"leg B {time.perf_counter() - t_b:.1f} s) on {card}")
    return {"leg_a": a, "leg_b": b, "sh_full": c, "counts": a["counts"]}


# -- phase 27: the mesh over processes (torch.distributed) --------------------

MP_RANKS = 4                    # processes of legs A and B (one card: gloo, staged)
MP_TIMEOUT = 420                # seconds a leg's processes may take
MP_HOT_STEPS, MP_CTR_STEPS = 16, 8
MP_ERNIE_WARM, MP_ERNIE_STEPS = 2, 2
# leg B's rungs: (name, ZeRO stage, comm config or None for the stage-2 path, mesh)
MP_ERNIE_RUNGS = (("fp32 fused", 0, dict(), {"dp": MP_RANKS}),
                  ("int8 fused", 0, dict(quant="int8"), {"dp": MP_RANKS}),
                  ("zero2 stage-2 path", 2, None, {"sharding": MP_RANKS}))
MP_SAVED_RUNG = "zero2 stage-2 path"
MP_LEG_C_BACKEND = "nccl"       # leg C's: a real NCCL communicator at world size 1
# process mesh against the thread mesh at K = 4: gloo's ring sums the dense
# gradients in another order than the rank order, so losses and dense params
# agree to the last bits only; the sparse rows of the first step are bitwise
MP_LOSS_TOL = 1e-6
_MP_RESULT = "MP_RESULT "
# the sizes a phase 27 child takes from its parent (a caller may shrink them)
MP_SIZES = ("BATCH", "HOT_CAP", "CAPACITY", "PASS_KEYS", "ERNIE_CFG", "ERNIE_BATCH", "ERNIE_SEQ",
            "MP_HOT_STEPS", "MP_CTR_STEPS", "MP_ERNIE_WARM", "MP_ERNIE_STEPS")


def mp_hot_snapshot(trainer, ds):
    """Phase 4's sharded tier after its run, on the CPU: the key map, the
    tier's columns, the dense params and the run's eight batches (keys lo,
    dense, labels), the state phase 27's hot leg starts from."""
    from paddle_tpu_torch.ps.ps_trainer import _dense_and_labels, _slot_tagged_keys

    tier, names = trainer.hot_tier, slot_names(SLOTS, DENSE)
    dm = tier.device_map
    batches = []
    for b in ds.batch_iter(BATCH):
        keys = _slot_tagged_keys(b, names["sparse_slots"])
        dense, labels = _dense_and_labels(b, names["dense_slots"], names["label_slot"],
                                          keys.shape[0])
        lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        batches.append(tuple(torch.from_numpy(np.ascontiguousarray(a))
                             for a in (lo, dense, labels)))
    return {"map": {k: v.cpu().clone() for k, v in dm.device_state().items()},
            "probe_buckets": dm.probe_buckets, "banks": dm.banks,
            "tier": {k: v.cpu().clone() for k, v in tier.state.items()},
            "params": {k: v.cpu().clone() for k, v in trainer.params.items()},
            "cfg": tier.cache_config, "batches": batches}


def mp_hot_step(mesh, snap, dev):
    """The sharded hot step over ``mesh`` from the snapshot's weights:
    (step, params, opt state, map state)."""
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.hot_tier import make_sharded_hot_train_step

    model = DeepFM(CtrConfig(SLOTS, DENSE, DIM, (400, 400, 400)),
                   generator=torch.Generator().manual_seed(0)).to(dev)
    opt = Adam(learning_rate=1e-3)
    params = {k: v.to(dev) for k, v in snap["params"].items()}
    step = make_sharded_hot_train_step(model, opt, snap["cfg"], mesh, np.arange(SLOTS),
                                       probe_buckets=snap["probe_buckets"], banks=snap["banks"])
    return step, params, opt.init(params), {k: v.to(dev) for k, v in snap["map"].items()}


def mp_ctr_setup(dev):
    """The pass path's shape for the sharded CTR step from keys: a 2^21-row
    cache, a replicated map of 2^20 slot-tagged keys (rows spread over the
    shards), DeepFM at the Criteo width and MP_CTR_STEPS batches of 4096,
    all from seeds (every process builds the same)."""
    import dataclasses

    from paddle_tpu_torch.ps.device_hash import DeviceKeyMap, map_state_to_device
    from paddle_tpu_torch.ps.sharded_cache import shard_spread_rows

    rng = np.random.default_rng(27)
    per = PASS_KEYS // SLOTS
    ids = rng.choice(1 << 30, (SLOTS, per), replace=False).astype(np.uint64)
    keys = ((np.arange(SLOTS, dtype=np.uint64)[:, None] << np.uint64(32)) | ids).reshape(-1)
    rows = shard_spread_rows(np.arange(len(keys), dtype=np.int64), CAPACITY,
                             MP_RANKS).astype(np.int32)
    map_state = map_state_to_device(DeviceKeyMap.build_host(keys, rows), dev)
    cfg = dataclasses.replace(hot_cfg("adagrad", "adagrad", True), capacity=CAPACITY)
    cols, _ = rows_inputs(rng, CAPACITY, DIM, "adagrad", "adagrad", dev)
    state = dict(zip(COLUMNS, cols))
    for k in ("embed_w", "embedx_w"):   # a trained table's scale, not unit normals
        state[k].mul_(0.01)
    batches = []
    for _ in range(MP_CTR_STEPS):
        pick = rng.integers(0, per, (BATCH, SLOTS))
        lo = ids[np.arange(SLOTS)[None, :], pick].astype(np.uint32).view(np.int32)
        dense = rng.normal(size=(BATCH, DENSE)).astype(np.float32)
        labels = (rng.random(BATCH) < 0.3).astype(np.int32)
        batches.append(tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                             (lo, dense, labels)))
    return map_state, cfg, state, batches


def mp_ctr_step(mesh, cfg, dev):
    from paddle_tpu_torch.models.ctr import CtrConfig, DeepFM
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.ps.sharded_cache import make_sharded_ctr_train_step_from_keys

    model = DeepFM(CtrConfig(SLOTS, DENSE, DIM, (400, 400, 400)),
                   generator=torch.Generator().manual_seed(1)).to(dev)
    opt = Adam(learning_rate=1e-3)
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    step = make_sharded_ctr_train_step_from_keys(model, opt, cfg, mesh, np.arange(SLOTS))
    return step, params, opt.init(params)


def mp_run_steps(step, params, opt_state, state, map_state, batches, n, dev, first_path=None):
    """``n`` steps over ``batches`` (cycled): (losses, params, ms a step after
    the first, bytes staged a step after the first, overflow). ``first_path``:
    the state after the first step is saved there (CPU)."""
    from paddle_tpu_torch.ops import transport

    losses, overflow = [], 0
    for t in range(n):
        if t == 1:
            _sync(dev)
            staged0, t0 = transport.stage_through_host.bytes, time.perf_counter()
        lo, dense, labels = (a.to(dev) for a in batches[t % len(batches)])
        params, opt_state, state, loss, ov = step(params, opt_state, state, map_state, lo,
                                                  dense, labels)
        losses.append(float(loss))
        overflow += int(ov)
        if t == 0 and first_path is not None:
            torch.save({k: v.cpu() for k, v in state.items()}, first_path)
    _sync(dev)
    dt = (time.perf_counter() - t0) / (n - 1)
    staged = (transport.stage_through_host.bytes - staged0) / (n - 1)
    return losses, params, 1e3 * dt, staged, overflow


def mp_capture(module, name, capture_state):
    """Wrap ``module.name`` to keep the first call's inputs (and, for an
    in-place push, the state before and after it); returns (the dict,
    restore)."""
    orig, got = getattr(module, name), {}

    def wrapped(*args, **kw):
        if "args" not in got:
            got["args"] = tuple(a.clone() if isinstance(a, torch.Tensor) else
                                ({k: v.clone() for k, v in a.items()} if isinstance(a, dict)
                                 else a) for a in args)
            got["kw"] = dict(kw)
            out = orig(*args, **kw)
            if capture_state:
                got["after"] = {k: v.clone() for k, v in args[0].items()}
            else:
                got["out"] = out.clone()
            return out
        return orig(*args, **kw)

    setattr(module, name, wrapped)
    return got, lambda: setattr(module, name, orig)


def mp_b3_b4_check(b3, b4, rank, timed):
    """B3 and B4 on this process's first-step inputs against their plain
    versions (bitwise; B3's on the card, B4's on the CPU); ``timed`` adds
    device times beside the plain versions' (on the card) and the bounds."""
    from paddle_tpu_torch.ops import hot_kernels as hk
    from paddle_tpu_torch.ps.device_hash import dynamic_map_lookup

    ms, hi, lo = b3["args"][:3]
    pb, banks = b3["kw"]["probe_buckets"], b3["kw"]["banks"]
    want3 = dynamic_map_lookup(ms, hi, lo, pb, banks)
    ok3 = bitwise_equal(b3["out"], want3)
    state, rows, grads, shows, clicks, cfg = b4["args"]
    # B4's plain version runs on the CPU copy (on the card its merge would
    # sum with atomics), as phase 2b holds it
    pre = {k: v.cpu().clone() for k, v in state.items()}
    want4 = hk.hot_scatter_apply_plain(pre, rows.cpu(), grads.cpu(), shows.cpu(), clicks.cpu(),
                                       cfg)
    ok4 = all(bitwise_equal(b4["after"][k].cpu(), want4[k]) for k in COLUMNS)
    err4 = max(max_abs(b4["after"][k].cpu(), want4[k]) for k in COLUMNS)
    out = {"b3_bitwise": ok3, "b4_bitwise": ok4, "b3_max_abs": max_abs(b3["out"], want3),
           "b4_max_abs": err4, "b3_n": int(hi.numel()), "b4_n": int(rows.numel())}
    if timed:
        n3 = int(hi.numel())
        first = dynamic_map_lookup(ms, hi, lo, 1, banks) >= 0
        buckets3 = n3 + int((~first).sum())
        nbytes3 = n3 * 8 + buckets3 * 3 * 32 + n3 * 4
        k3, _ = time_cuda(lambda: hk.hot_probe(ms, hi, lo, probe_buckets=pb, banks=banks))
        p3, _ = time_cuda(lambda: dynamic_map_lookup(ms, hi, lo, pb, banks))
        out["b3"] = {"max_abs_err": out["b3_max_abs"], "ms": k3, "plain_ms": p3,
                     "bound_ms": nbytes3 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        C = state["embed_w"].shape[0]
        r64 = rows.to(torch.int64)
        u = int(torch.unique(r64[(r64 >= 0) & (r64 < C)]).numel())
        work = {k: v.clone() for k, v in state.items()}
        k4, _ = time_cuda(lambda: hk.hot_scatter_apply(work, rows, grads, shows, clicks, cfg))
        p4, _ = time_cuda(lambda: hk.hot_scatter_apply_plain(work, rows, grads, shows, clicks,
                                                             cfg))
        nbytes, nops, bytes_ms, ops_ms = scatter_bound(int(rows.numel()), u, cfg)
        out["b4"] = {"max_abs_err": err4, "ms": k4, "plain_ms": p4,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        log(f"phase 27 rank {rank}: B3 on its first step's {n3} keys: device {k3} ms, plain "
            f"{p3} ms, bound {out['b3']['bound_ms']} ms; B4 on its owner push (n = "
            f"{int(rows.numel())}, u = {u}): device {k4} ms, plain {p4} ms, bound "
            f"{out['b4']['bound_ms']} ms")
    return out


def mp_leg_a_child(conf, rank, world, dev):
    """Leg A in one process: the sharded hot step (MP_HOT_STEPS) and the
    sharded CTR step from keys (MP_CTR_STEPS) on this process's row block."""
    from paddle_tpu_torch.core.mesh import make_process_mesh
    from paddle_tpu_torch.ops import collectives as coll
    from paddle_tpu_torch.ops import sparse_optimizer as so
    from paddle_tpu_torch.ps import hot_tier

    def reading(ms, staged, ov, losses, block):
        return {"losses": losses, "ms_per_step": ms, "staged_bytes_per_step": staged,
                "overflow": ov, "launches": read_launches(),
                "block_rows": int(block["embed_w"].shape[0]),
                "peak_bytes": torch.cuda.max_memory_allocated(dev)}

    base = conf["base"]
    mesh = make_process_mesh({"ps": world}, device=dev)
    res = {"device": str(mesh.device)}
    snap = torch.load(os.path.join(base, "hot.pt"), weights_only=False)
    b = HOT_CAP // world
    block = {k: v[rank * b:(rank + 1) * b].to(dev) for k, v in snap["tier"].items()}
    del snap["tier"]
    b3, undo3 = mp_capture(hot_tier, "hot_probe", False)
    b4, undo4 = mp_capture(hot_tier, "hot_scatter_apply", True)
    try:
        step, params, opt_state, map_state = mp_hot_step(mesh, snap, dev)
    finally:
        undo3()
        undo4()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    losses, params, ms, staged, ov = mp_run_steps(
        step, params, opt_state, block, map_state, snap["batches"], MP_HOT_STEPS, dev,
        os.path.join(base, f"hot_first_{rank}.pt"))
    res["hot"] = reading(ms, staged, ov, losses, block)
    if rank == 0:
        torch.save({k: v.cpu() for k, v in params.items()}, os.path.join(base, "hot_params.pt"))
    checks = mp_b3_b4_check(b3, b4, rank, False)
    coll.run_ranks(mesh, lambda r: coll.barrier("ps"))
    if rank == 0:   # timed with the other processes idle at the barrier
        checks.update(mp_b3_b4_check(b3, b4, rank, True))
    coll.run_ranks(mesh, lambda r: coll.barrier("ps"))
    res["hot"]["checks"] = checks
    del b3, b4, block, map_state, snap
    torch.cuda.empty_cache()

    map_state, cfg, state, batches = mp_ctr_setup(dev)
    b = CAPACITY // world
    block = {k: v[rank * b:(rank + 1) * b].clone() for k, v in state.items()}
    del state
    torch.cuda.empty_cache()
    step, params, opt_state = mp_ctr_step(mesh, cfg, dev)
    push, undo = capture_first_push()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    try:
        losses, params, ms, staged, ov = mp_run_steps(
            step, params, opt_state, block, map_state, batches, MP_CTR_STEPS, dev,
            os.path.join(base, f"ctr_first_{rank}.pt"))
    finally:
        undo()
    res["ctr"] = reading(ms, staged, ov, losses, block)
    if rank == 0:
        torch.save({k: v.cpu() for k, v in params.items()}, os.path.join(base, "ctr_params.pt"))
    st, (uniq, dsum, csum, g), kw = push["state"], push["args"], push["kw"]
    got = tuple(c.clone() for c in st)
    so.ctr_sparse_rows_at(got, uniq, dsum, csum, g, **kw)
    want = so.ctr_sparse_rows_at_plain(tuple(c.clone() for c in st), uniq, dsum, csum, g, **kw)
    res["ctr"]["b1_bitwise"] = bitwise_cols(got, want)
    coll.run_ranks(mesh, lambda r: coll.barrier("ps"))
    if rank == 0:
        res["ctr"]["b1"] = wd_b1_check(push, dim=DIM, what="phase 27 owner push (rank 0)")
    coll.run_ranks(mesh, lambda r: coll.barrier("ps"))
    return res


def mp_ernie_trainer(model, rung, mesh, dev):
    from paddle_tpu_torch.distributed.comm_fusion import CommFusionConfig
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.parallel.spmd import SpmdTrainer

    _, stage, comm, _ = rung
    return SpmdTrainer(model, Adam(SPMD_LR), lm_loss, mesh, zero_stage=stage, device=dev,
                       comm=None if comm is None else CommFusionConfig(**comm))


def mp_ernie_model(dev):
    from paddle_tpu_torch.models.ernie import Ernie, ErnieConfig

    cfg = ErnieConfig(**ERNIE_CFG)
    model = Ernie(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    batch = hybrid_batch(np.random.default_rng(33), cfg.vocab_size, ERNIE_BATCH, ERNIE_SEQ, dev)
    return cfg, model, batch


def mp_leg_b_child(conf, rank, world, dev):
    """Leg B in one process: ERNIE at full width, each rung of
    MP_ERNIE_RUNGS (or ``conf["rungs"]``) for MP_ERNIE_WARM + MP_ERNIE_STEPS
    Adam steps over the process mesh."""
    from paddle_tpu_torch.core.mesh import make_process_mesh
    from paddle_tpu_torch.ops import transport

    base = conf["base"]
    cfg, model, (ids, labels) = mp_ernie_model(dev)
    out = {}
    for rung in MP_ERNIE_RUNGS:
        name, _, _, shape = rung
        if name not in conf["rungs"]:
            continue
        shape = {a: world for a in shape}
        tr = mp_ernie_trainer(model, rung, make_process_mesh(shape, device=dev), dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        losses = []
        for i in range(MP_ERNIE_WARM + MP_ERNIE_STEPS):
            if i == MP_ERNIE_WARM:
                _sync(dev)
                staged0, t0 = transport.stage_through_host.bytes, time.perf_counter()
            losses.append(float(tr.train_step(ids, labels)))
        _sync(dev)
        dt = (time.perf_counter() - t0) / MP_ERNIE_STEPS
        staged = (transport.stage_through_host.bytes - staged0) / MP_ERNIE_STEPS
        counts = {k: v for k, v in read_launches().items() if k.startswith("flash")}
        out[name] = {"losses": losses, "ms_per_step": 1e3 * dt, "staged_bytes_per_step": staged,
                     "peak_bytes": torch.cuda.max_memory_allocated(dev), "launches": counts}
        if rank == 0:
            torch.save({k: v.cpu() for k, v in tr.state["params"].items()},
                       os.path.join(base, f"params_{name.replace(' ', '_')}.pt"))
        if name == MP_SAVED_RUNG and conf.get("save"):
            tr.save(os.path.join(base, "process.snap"))
        del tr
        torch.cuda.empty_cache()
    return out


def mp_collective_cases(x):
    """Every axis-form mapping over "dp" (module 3's table) on ``x``."""
    from paddle_tpu_torch.ops import collectives as coll

    R = coll.ReduceOp
    return {"psum": lambda: coll.psum(x, "dp"), "pmax": lambda: coll.pmax(x, "dp"),
            "psum_scatter": lambda: coll.psum_scatter(x, "dp", 1),
            "all_gather": lambda: coll.all_gather(x, "dp", 1),
            "all_to_all": lambda: coll.all_to_all(x, "dp", 0, 1),
            "shift": lambda: coll.shift(x, "dp", 1),
            "ppermute": lambda: coll.ppermute(x, "dp", [(0, 0)]),
            "broadcast": lambda: coll.broadcast(x, "dp"),
            "reduce_sum": lambda: coll.reduce(x, "dp"),
            "reduce_avg": lambda: coll.reduce(x, "dp", op=R.AVG),
            "all_reduce_min": lambda: coll.ProcessGroup("dp").all_reduce(x, R.MIN),
            "all_reduce_prod": lambda: coll.ProcessGroup("dp").all_reduce(x, R.PROD),
            "barrier": lambda: (coll.barrier("dp"), x)[1]}


def mp_leg_c_child(conf, rank, world, dev):
    """Leg C: NCCL at world size 1, every mapping on a real communicator
    against its definition (the thread mesh of one rank), then one fused
    step of a small ERNIE over the process mesh against the GSPMD step of
    the mesh of one logical rank."""
    import torch.distributed as dist

    from paddle_tpu_torch.core.mesh import make_mesh, make_process_mesh
    from paddle_tpu_torch.distributed.comm_fusion import CommFusionConfig
    from paddle_tpu_torch.models.ernie import Ernie, ErnieConfig
    from paddle_tpu_torch.ops import collectives as coll
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.parallel.spmd import SpmdTrainer

    pm = make_process_mesh({"dp": 1}, device=dev)
    tm = make_mesh({"dp": 1}, device=dev)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(8, 12)).astype(np.float32)).to(dev)
    got = coll.run_ranks(pm, lambda r: {k: f() for k, f in mp_collective_cases(x).items()})[0]
    want = coll.run_ranks(tm, lambda r: {k: f() for k, f in mp_collective_cases(x).items()})[0]
    equal = {k: bitwise_equal(got[k], want[k]) for k in got}
    res = {"backend": dist.get_backend(), "world": dist.get_world_size(), "device": str(pm.device),
           "mappings_equal": equal}
    weights = spmd_small_weights()
    batch = hybrid_batch(np.random.default_rng(61), HYB_SMALL["vocab_size"], SPMD_SMALL_BATCH,
                         HYB_SMALL["max_seq_len"], dev)
    out = {}
    for what, mesh, comm in (("fused over NCCL", pm, CommFusionConfig()), ("gspmd", tm, None)):
        model = Ernie(ErnieConfig(**HYB_SMALL))
        model.load_state_dict(weights)
        tr = SpmdTrainer(model, SGD(SPMD_SMALL_LR), lm_loss, mesh, device=dev, comm=comm)
        loss = float(tr.train_step(*batch))
        out[what] = (loss, {k: v.cpu() for k, v in tr.state["params"].items()})
    (fl, fp), (gl, gp) = out["fused over NCCL"], out["gspmd"]
    res["fused_loss"], res["gspmd_loss"] = fl, gl
    res["loss_rel"] = abs(fl - gl) / abs(gl)
    res["update_gap"] = spmd_update_gap({k: v.cpu() for k, v in weights.items()}, fp, gp)
    return res


def mp_child(config_path):
    """``--mp-rank CONFIG.json``: one process of phase 27, started by
    ``launch_local``; joins the job (the config's backend, the store in
    ``PADDLE_MASTER``), runs its leg and prints one result line."""
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import collective as C

    with open(config_path) as f:
        conf = json.load(f)
    globals().update(conf["sizes"])
    torch.backends.cuda.matmul.allow_tf32 = False
    env = C.init_parallel_env(os.environ["PADDLE_MASTER"], backend=conf["backend"])
    rank, world = env.rank, env.world_size
    dev = torch.device("cpu")
    if conf["device"] == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    res = {"A": mp_leg_a_child, "B": mp_leg_b_child, "C": mp_leg_c_child}[conf["leg"]](
        conf, rank, world, dev)
    res.update(rank=rank, world=world, backend=dist.get_backend(), seconds=time.perf_counter() - t0)
    dist.destroy_process_group()
    print(_MP_RESULT + json.dumps(res), flush=True)
    return 0


def mp_launch(base, leg, nproc, backend, dev, **conf):
    """Run one leg's ``nproc`` processes (``--mp-rank``) through the port's
    launcher and a ``file://`` store; every process must exit 0 and print
    its result line. Returns the results by rank and the seconds."""
    from paddle_tpu_torch.testing.multiprocess import run_job

    work = os.path.join(base, f"leg_{leg}_{backend}_{nproc}")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "conf.json")
    with open(path, "w") as f:
        json.dump(dict(conf, leg=leg, backend=backend, base=base, device=dev.type,
                       sizes={k: globals()[k] for k in MP_SIZES}), f)
    t0 = time.perf_counter()
    logs = run_job([PSJOB_SCRIPT, "--mp-rank", path], nproc, work, MP_TIMEOUT)
    got = []
    for r, text in enumerate(logs):
        lines = [l for l in text.splitlines() if l.startswith(_MP_RESULT)]
        if not lines:
            raise AssertionError(f"phase 27 leg {leg}: rank {r} printed no result:\n{text[-3000:]}")
        got.append(json.loads(lines[-1][len(_MP_RESULT):]))
    return got, time.perf_counter() - t0


def mp_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def mp_params_rel(got, want):
    """(the worst tensor's ||got − want|| / ||want||, its name)."""
    return max((float((got[k].double() - want[k].double()).norm() / want[k].double().norm()), k)
               for k in want if float(want[k].norm()) > 0)


def mp_leg_a(dev, card, base, snap):
    """Leg A: the sharded hot step and the sharded CTR step over MP_RANKS
    processes (gloo, the card shared) against the same steps over the thread
    mesh of phase 4 in this process."""
    from paddle_tpu_torch.core.mesh import make_mesh

    torch.save(snap, os.path.join(base, "hot.pt"))
    mesh = make_mesh({"ps": MP_RANKS}, device=dev)
    step, params, opt_state, map_state = mp_hot_step(mesh, snap, dev)
    tier = {k: v.to(dev) for k, v in snap["tier"].items()}
    hot = mp_run_steps(step, params, opt_state, tier, map_state, snap["batches"], MP_HOT_STEPS,
                       dev, os.path.join(base, "hot_first_thread.pt"))
    del tier, map_state
    map_state, cfg, state, batches = mp_ctr_setup(dev)
    step, params, opt_state = mp_ctr_step(mesh, cfg, dev)
    ctr = mp_run_steps(step, params, opt_state, state, map_state, batches, MP_CTR_STEPS, dev,
                       os.path.join(base, "ctr_first_thread.pt"))
    del state, map_state
    torch.cuda.empty_cache()
    log(f"phase 27 leg A, thread mesh {{'ps': {MP_RANKS}}}: hot {hot[2]:.3f} ms/step, CTR "
        f"{ctr[2]:.3f} ms/step on {card}")
    ranks, secs = mp_launch(base, "A", MP_RANKS, "gloo", dev)
    out = {"seconds": secs}
    for name, ref, cap in (("hot", hot, HOT_CAP), ("ctr", ctr, CAPACITY)):
        want_first = torch.load(os.path.join(base, f"{name}_first_thread.pt"))
        firsts = [torch.load(os.path.join(base, f"{name}_first_{r}.pt")) for r in range(MP_RANKS)]
        first_ok = all(bitwise_equal(torch.cat([f[k] for f in firsts]), want_first[k])
                       for k in want_first)
        got_params = torch.load(os.path.join(base, f"{name}_params.pt"))
        prel, pname = mp_params_rel(got_params, {k: v.cpu() for k, v in ref[1].items()})
        lrel = max(mp_rel(r[name]["losses"], ref[0]) for r in ranks)
        steps = MP_HOT_STEPS if name == "hot" else MP_CTR_STEPS
        kern = ("hot_probe", "hot_scatter_apply") if name == "hot" else ("ctr_sparse_rows",)
        per = {k: [r[name]["launches"][k] for r in ranks] for k in kern}
        ov = sum(r[name]["overflow"] for r in ranks)
        blocks = [r[name]["block_rows"] for r in ranks]
        log(f"phase 27 leg A {name}: {MP_RANKS} processes ({ranks[0]['backend']}, devices "
            f"{sorted({r['device'] for r in ranks})}), row blocks {blocks} of {cap}; losses "
            f"{ranks[0][name]['losses']} vs the thread mesh's {ref[0]} (worst relative {lrel}, "
            f"bound {MP_LOSS_TOL}); dense params worst relative {prel} ({pname}; bound "
            f"{MP_LOSS_TOL}); "
            f"first step's rows bitwise {first_ok}; overflow {ov}; launches per process "
            f"{per} over {steps} steps; ms/step {[round(r[name]['ms_per_step'], 3) for r in ranks]}"
            f" (thread mesh {ref[2]:.3f}); bytes staged through the host a step "
            f"{[r[name]['staged_bytes_per_step'] for r in ranks]}; peak memory a process "
            f"{[r[name]['peak_bytes'] for r in ranks]} B on {card}")
        assert ov == 0, f"phase 27 leg A {name}: routing overflow {ov}"
        assert first_ok, f"phase 27 leg A {name}: the first step's rows differ"
        assert lrel <= MP_LOSS_TOL and prel <= MP_LOSS_TOL, \
            f"phase 27 leg A {name}: losses {lrel}, params {prel}"
        assert all(b == cap // MP_RANKS for b in blocks), f"phase 27 leg A {name}: {blocks}"
        assert all(v == [steps] * MP_RANKS for v in per.values()), \
            f"phase 27 leg A {name}: launches {per}, want {steps} a process"
        out[name] = {"launches": {k: sum(v) for k, v in per.items()},
                     "ms_per_step": [r[name]["ms_per_step"] for r in ranks],
                     "staged_bytes_per_step": [r[name]["staged_bytes_per_step"] for r in ranks],
                     "peak_bytes": [r[name]["peak_bytes"] for r in ranks]}
    checks = [r["hot"]["checks"] for r in ranks]
    log(f"phase 27 leg A: B3/B4 on each process's first step against their plain versions "
        f"(B3's on the card, B4's on the CPU): B3 bitwise {[c['b3_bitwise'] for c in checks]} (n "
        f"{[c['b3_n'] for c in checks]}), B4 bitwise {[c['b4_bitwise'] for c in checks]} (n "
        f"{[c['b4_n'] for c in checks]}); B1 on each first owner push bitwise "
        f"{[r['ctr']['b1_bitwise'] for r in ranks]}")
    assert all(c["b3_bitwise"] and c["b4_bitwise"] for c in checks), "phase 27: B3/B4 differ"
    assert all(r["ctr"]["b1_bitwise"] for r in ranks), "phase 27: B1 differs"
    out["b3"], out["b4"], out["b1"] = checks[0]["b3"], checks[0]["b4"], ranks[0]["ctr"]["b1"]
    return out


def mp_leg_b(dev, card, base, nproc=MP_RANKS, backend="gloo"):
    """Leg B: ERNIE at full width over ``nproc`` processes, the rungs of
    MP_ERNIE_RUNGS against the same rungs over the thread mesh here."""
    from paddle_tpu_torch.core.mesh import make_mesh
    from paddle_tpu_torch.io.checkpoint import load_train_state

    rungs = [r for r in MP_ERNIE_RUNGS if backend == "gloo" or r[0] == "fp32 fused"]
    cfg, model, (ids, labels) = mp_ernie_model(dev)
    start = {k: v.detach().cpu().clone() for k, v in model.named_parameters()}
    ref = {}
    for rung in rungs:
        name, _, _, shape = rung
        tr = mp_ernie_trainer(model, rung, make_mesh({a: nproc for a in shape}, device=dev), dev)
        losses = [float(tr.train_step(ids, labels))
                  for _ in range(MP_ERNIE_WARM + MP_ERNIE_STEPS)]
        ref[name] = (losses, {k: v.cpu() for k, v in tr.state["params"].items()})
        if name == MP_SAVED_RUNG:
            tr.save(os.path.join(base, "thread.snap"))
        del tr
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    ranks, secs = mp_launch(base, "B", nproc, backend, dev, rungs=[r[0] for r in rungs],
                            save=backend == "gloo")
    out = {"seconds": secs, "counts": {}}
    want_launches = (MP_ERNIE_WARM + MP_ERNIE_STEPS) * cfg.num_layers
    for name, _, _, _ in rungs:
        first = max(abs(r[name]["losses"][0] - ref[name][0][0]) / abs(ref[name][0][0])
                    for r in ranks)
        got = torch.load(os.path.join(base, f"params_{name.replace(' ', '_')}.pt"))
        upd = spmd_update_gap(start, got, ref[name][1], ERNIE_CFG)
        per = [r[name]["launches"] for r in ranks]
        log(f"phase 27 leg B {name}: {nproc} processes ({backend}): losses "
            f"{ranks[0][name]['losses']} vs the thread mesh's {ref[name][0]} (first relative "
            f"{first}, bound {MP_LOSS_TOL}); worst relative update difference {upd} (bound "
            f"{HYB_TOL['update']}); ms/step {[round(r[name]['ms_per_step'], 1) for r in ranks]}; "
            f"bytes staged through the host a step "
            f"{[r[name]['staged_bytes_per_step'] for r in ranks]}; peak memory a process "
            f"{[r[name]['peak_bytes'] for r in ranks]} B; flash launches per process {per[0]} "
            f"(want {want_launches} each) on {card}")
        assert first <= MP_LOSS_TOL, f"phase 27 leg B {name}: first loss {first}"
        assert upd <= HYB_TOL["update"], f"phase 27 leg B {name}: update gap {upd}"
        assert all(v == want_launches for p in per for v in p.values()), \
            f"phase 27 leg B {name}: launches {per}"
        for k in per[0]:
            out["counts"][k] = out["counts"].get(k, 0) + sum(p[k] for p in per)
        out[name] = {"ms_per_step": [r[name]["ms_per_step"] for r in ranks],
                     "staged_bytes_per_step": [r[name]["staged_bytes_per_step"] for r in ranks],
                     "peak_bytes": [r[name]["peak_bytes"] for r in ranks], "update_gap": upd,
                     "first_rel": first}
    if backend == "gloo":
        a = load_train_state(os.path.join(base, "process.snap"))
        b = load_train_state(os.path.join(base, "thread.snap"))
        worst, where, n = mp_snap_gap(a, b)
        log(f"phase 27 leg B: the {MP_SAVED_RUNG} save from the process mesh against the thread "
            f"mesh's: {n} arrays, worst relative difference {worst} ({where}; bound "
            f"{HYB_TOL['update']})")
        assert worst <= HYB_TOL["update"], f"phase 27 leg B: saves differ by {worst}"
        out["save_gap"] = worst
    return out


def mp_snap_gap(a, b, path=""):
    """(worst ||a − b|| / ||b|| over the float arrays of two snapshots, its
    path, the count of arrays); the structures, shapes and the other
    leaves must be equal. Attention's key bias is left out of
    ``attn.qkv_b`` arrays (params and Adam slots): its true gradient is 0,
    so its values are rounding noise (as in ``spmd_update_gap``)."""
    if isinstance(b, dict):
        assert sorted(map(str, a)) == sorted(map(str, b)), (path, sorted(a), sorted(b))
        parts = [mp_snap_gap(a[k], b[k], f"{path}/{k}") for k in b]
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        parts = [mp_snap_gap(x, y, f"{path}/{i}") for i, (x, y) in enumerate(zip(a, b))]
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype, (path, x.shape, y.shape)
        if not np.issubdtype(y.dtype, np.floating) or path.endswith("rng"):
            assert np.array_equal(x, y), path
            return 0.0, path, 1
        if path.endswith("attn.qkv_b"):
            H = ERNIE_CFG["num_heads"]
            D = ERNIE_CFG["hidden_size"] // H
            x, y = (v.reshape(*v.shape[:-1], H, 3, D)[..., [0, 2], :] for v in (x, y))
        d = float(np.linalg.norm((x - y).astype(np.float64)))
        n = float(np.linalg.norm(y.astype(np.float64)))
        return (d / n if n > 0 else d), path, 1
    worst = max(parts, key=lambda p: p[0]) if parts else (0.0, path, 0)
    return worst[0], worst[1], sum(p[2] for p in parts)


def mp_leg_c(dev, card, base):
    """Leg C: NCCL at world size 1 in a process of its own; a two-card NCCL
    run of leg B's fp32 rung where the machine has a second card."""
    ranks, secs = mp_launch(base, "C", 1, MP_LEG_C_BACKEND, dev)
    r = ranks[0]
    log(f"phase 27 leg C: {r['backend']} at world size {r['world']} on {r['device']}: every "
        f"mapping equals its definition {r['mappings_equal']}; one fused step of a small ERNIE "
        f"over NCCL against the GSPMD step: losses {r['fused_loss']} vs {r['gspmd_loss']} "
        f"(relative {r['loss_rel']}, bound {SPMD_TOL['loss']}), worst relative update "
        f"difference {r['update_gap']} (bound {SPMD_TOL['update']}); {secs:.1f} s")
    assert r["backend"] == MP_LEG_C_BACKEND and r["world"] == 1, r
    assert all(r["mappings_equal"].values()), r["mappings_equal"]
    assert r["loss_rel"] <= SPMD_TOL["loss"] and r["update_gap"] <= SPMD_TOL["update"], r
    n = torch.cuda.device_count()
    if n >= 2:
        two = mp_leg_b(dev, card, os.path.join(base, "two_cards"), nproc=2, backend="nccl")
        return {"seconds": secs, "two_cards": two}
    log(f"phase 27 leg C: the two-card NCCL run of leg B did not run: this machine has {n} "
        f"card (NCCL refuses two ranks of one communicator on one card, so legs A and B share "
        f"the card over gloo)")
    return {"seconds": secs, "two_cards": None}


def phase_mp(dev, card, hot_snap):
    """Phase 27: the mesh over processes. Leg C (NCCL at world size 1), leg
    A (the sharded PS steps over 4 processes, each holding its row block),
    leg B (ERNIE dense DP and ZeRO-2 over 4 processes), all in processes
    started by the port's launcher, the kernels built before they start."""
    import tempfile

    t0 = time.perf_counter()
    base = tempfile.mkdtemp(prefix="mp_phase_")
    try:
        torch.cuda.empty_cache()
        c = mp_leg_c(dev, card, base)
        a = mp_leg_a(dev, card, base, hot_snap)
        torch.cuda.empty_cache()
        b = mp_leg_b(dev, card, base)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    log(f"mesh over processes (phase 27): {time.perf_counter() - t0:.1f} s (leg C "
        f"{c['seconds']:.1f} s, leg A's processes {a['seconds']:.1f} s, leg B's "
        f"{b['seconds']:.1f} s) on {card}")
    return {"a": a, "b": b, "c": c}


HYB_RANGES = ("hybrid_forward", "hybrid_backward", "hybrid_update")
# B5-B7's kernels in ops/csrc/flash_attention.cu (tensor-core and f32 forms)
HYB_FLASH_KERNELS = ("fwd_mma_kernel", "bwd_dq_mma_kernel", "bwd_dkv_mma_kernel",
                     "fwd_f32_kernel", "bwd_dq_f32_kernel", "bwd_dkv_f32_kernel")


def hybrid_step_profile(hyb):
    """Where one leg A step's time goes: torch.profiler over one step (after
    a warm-up step; the ranks' threads and autograd's included), the
    trainer's three ranges (host ms: the ranks' forwards, the backward,
    Adam), the device kernels (count, ms by kind) and the device's busy
    share of the step's wall time. Taken last, with the other profiler
    windows (a window slows every later launch of the process)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tr, (ids, labels) = hyb["trainer"], hyb["batch"]
    tr.train_step(ids, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_step(ids, labels)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    host = {n: sum(e.cpu_time_total for e in events if e.name == n) / 1e3 for n in HYB_RANGES}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("Memset", "Memcpy"))]
    kinds = {"flash": 0.0, "gemm": 0.0, "other": 0.0}
    by_name = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        short = (e.name.replace("(anonymous namespace)::", "").replace("void ", "")
                 .split("(")[0].split("<")[0])
        low = short.lower()
        kind = ("flash" if low.endswith(HYB_FLASH_KERNELS) else
                "gemm" if any(w in low for w in ("gemm", "xmma", "cutlass")) else "other")
        kinds[kind] += us / 1e3
        by_name[short] = by_name.get(short, 0.0) + us / 1e3
    busy = sum(kinds.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"hybrid leg A profile (one step): wall {wall:.3f} ms; host ranges {host}; device "
        f"kernels {len(kernels)}, device ms {busy:.3f} (busy {100 * busy / wall:.1f} %) by kind "
        f"{ {k: round(v, 3) for k, v in kinds.items()} }; top {[(n, round(v, 3)) for n, v in top]}")
    return {"wall_ms": wall, "host_ms": host, "kernels": len(kernels), "device_ms": busy}


def main(argv):
    profile_dir = None
    if argv[:1] == ["--ps-job"] and len(argv) == 2:
        return ps_job_child(argv[1])
    if argv[:1] == ["--ckpt-job"] and len(argv) == 2:
        return ckpt_job_child(argv[1])
    if argv[:1] == ["--ha-server"] and len(argv) == 4:
        return ha_server_child(*argv[1:])
    if argv[:1] == ["--serve-export"] and len(argv) == 2:
        return serve_export_child(argv[1])
    if argv[:1] == ["--heter-head"] and len(argv) == 2:
        return heter_head_child(argv[1])
    if argv[:1] == ["--fleet-source"] and len(argv) == 2:
        return fleet_source_child(argv[1])
    if argv[:1] == ["--elastic-trainer"] and len(argv) == 2:
        return elastic_trainer_child(argv[1])
    if argv[:1] == ["--mp-rank"] and len(argv) == 2:
        return mp_child(argv[1])
    if argv[:1] == ["--profile"] and len(argv) == 2:
        profile_dir = argv[1]
    elif argv:
        print("usage: chip_smoke.py [--profile DIR]  (--ps-job CONFIG.json: one process of "
              "phase 14's job; --ckpt-job CONFIG.json: one leg of phase 15; --ha-server STORE "
              "JOB SHARD: one server process of phase 16's leg C; --serve-export DIR: phase "
              "22's serving child; --heter-head PORT: phase 24's CPU head; --fleet-source "
              "CONFIG.json: phase 25's source process; --elastic-trainer CONFIG.json: one of "
              "phase 25's elastic trainers; --mp-rank CONFIG.json: one process of phase 27)",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:  # the script alone, outside a checkout
        print(f"chip_smoke: the paddle_tpu_torch package is not importable here ({e}); run "
              "this script from the root of a checkout", file=sys.stderr)
        return 2

    t_script = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 matmuls for parity
    # (cuDNN's TF32 is left as it is: the port's conv2d pins it off itself)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {name} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    host_s, ssd_s, kern_s, hot_s, flash_s = build_all()
    log(f"build: host library {host_s:.2f} s, SSD tier + PS service (zlib) {ssd_s:.2f} s, "
        f"ctr_sparse_rows {kern_s:.2f} s, hot_kernels {hot_s:.2f} s, flash_attention "
        f"{flash_s:.2f} s (two g++ and three nvcc in parallel)")

    secs = {}

    def timed(name, fn, *args):
        """Run one phase and keep its seconds (host clock) under ``name``."""
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = round(time.perf_counter() - t0, 1)
        return out

    b1, k = timed("2", phase_kernel, dev)
    log(f"kernel ctr_sparse_rows adagrad/adagrad n={BATCH * SLOTS}: device {k['ms']} ms "
        f"(the kernel alone {k['kernel_ms']} ms, the rest copies of the rows), "
        f"plain {k['plain_ms']} ms, bound {k['bound_ms']} ms; per call from an idle "
        f"card (host issue included) {k['call_ms']} ms, plain {k['plain_call_ms']} ms "
        f"({k['bound_by']}: {k['bytes']} B, {k['ops']} f32 ops) on {card}")
    b2, b3 = timed("2b probe", phase_hot_probe, dev)
    b4, b4_sort = timed("2b scatter", phase_hot_scatter, dev)
    pass_counts = timed("3", phase_main_path, dev, card, profile_dir)
    ds = hot_dataset()
    hot_counts, _, _ = timed("4", phase_hot_path, dev, card, ds, profile_dir)
    sharded_counts, _, hot_snap = timed("4 sharded", phase_hot_path, dev, card, ds, profile_dir,
                                        SHARDS)
    timed("5b", phase_parity, dev)
    timed("5", phase_hot_parity, dev)
    timed("5c", phase_sharded_parity, dev)
    fa = timed("6", phase_flash_kernels, dev)
    ernie_counts, ernie_stats = timed("7", phase_ernie, dev, card, profile_dir)
    timed("8", phase_ernie_parity, dev)
    resnets, resnet_batch = timed("9", phase_resnet, dev, card)
    timed("10", phase_lenet, dev, card)
    timed("11", phase_vision_parity, dev)
    wd_counts, wd_b1, wd_cold = timed("12", phase_widedeep, dev, card)
    rpc_counts, rpc_b2, rpc_b4 = timed("13", phase_rpc, dev, card, ds)
    del ds
    gpubox = timed("14", phase_ps_job, dev, card)
    timed("15", phase_job_checkpoint, dev, card)
    ha_counts, ha_b2, ha_b4 = timed("16", phase_ha, dev, card)
    keep = {}
    rs_counts, rs_b2, rs_b4 = timed("17", phase_reshard, dev, card, keep)
    tn_counts, tn_b2, tn_b4 = timed("18", phase_tenancy, dev, card, keep.pop("leg_b_oracle"))
    timed("19", phase_obs_fleet, dev, card, keep.pop("leg_a_oracle"))
    rs_launches, rs_b1 = timed("20", phase_recsys, dev, card)
    hyb = timed("21", phase_hybrid, dev, card, ernie_stats)
    item5 = timed("22", phase_item5, dev, card)
    item9 = timed("23", phase_item9, dev, card)
    item8 = timed("24", phase_item8, dev, card)
    timed("25", phase_item8b, dev, card)
    spmd = timed("26", phase_spmd, dev, card)
    mp = timed("27", phase_mp, dev, card, hot_snap)
    del hot_snap
    timed("profiles", phase_kernel_counts, dev)
    timed("profiles wd", wd_kernel_counts, dev)
    timed("profiles hybrid", hybrid_step_profile, hyb)
    timed("profiles resnet", phase_resnet_kernel_counts, resnets, resnet_batch, profile_dir)
    log(f"phase seconds {secs}; the script {time.perf_counter() - t_script:.1f} s (the build "
        f"included) on {card}")
    del resnets, resnet_batch, hyb["trainer"]

    def entry(name, source, replaces, launches, r):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r.get("library_ms")}

    hot_src = "paddle_tpu_torch/ops/csrc/hot_kernels.cu"
    fa_src = "paddle_tpu_torch/ops/csrc/flash_attention.cu"
    fa_ref = "paddle_tpu/ops/flash_attention.py"
    # library_ms is null for B1, the probes and B4: no single PyTorch call
    # computes the fused CTR rule, the probe (with or without the gather),
    # or the merge+rule+scatter. The sort (B4's first part, the jnp.unique
    # in front of the Pallas call) has torch.sort as its library call.
    # B1's numbers are its in-place form's on the pass push, the call the
    # pass path makes (both forms count in ctr_sparse_rows.launches), and
    # on a Wide&Deep push in ctr_sparse_rows@widedeep.
    b1_src = "paddle_tpu_torch/ops/csrc/ctr_sparse_rows.cu"
    b1_ref = "paddle_tpu/ops/sparse_optimizer.py:203"
    kernels = [
        entry("ctr_sparse_rows", b1_src, b1_ref, pass_counts["ctr_sparse_rows"], b1),
        # B1 again as the Wide&Deep daily loop launches it (phase 12): its
        # launches there, its numbers on one of that path's pushes
        entry("ctr_sparse_rows@widedeep", b1_src, b1_ref, wd_counts["ctr_sparse_rows"], wd_b1),
        entry("hot_probe_gather", hot_src, "paddle_tpu/ops/hot_kernels.py:116",
              hot_counts["hot_probe_gather"], b2),
        entry("hot_probe", hot_src, "paddle_tpu/ops/hot_kernels.py:212",
              sharded_counts["hot_probe"], b3),
        entry("hot_scatter_apply", hot_src, "paddle_tpu/ops/hot_kernels.py:278",
              hot_counts["hot_scatter_apply"], b4),
        entry("sort_rows", hot_src, "paddle_tpu/ops/hot_kernels.py:278",
              hot_counts["sort_rows"], b4_sort),
        entry("flash_attention_fwd", fa_src, f"{fa_ref}:127",
              ernie_counts["flash_attention_fwd"], fa["fwd"]),
        entry("flash_attention_bwd_dq", fa_src, f"{fa_ref}:176",
              ernie_counts["flash_attention_bwd_dq"], fa["dq"]),
        entry("flash_attention_bwd_dkv", fa_src, f"{fa_ref}:221",
              ernie_counts["flash_attention_bwd_dkv"], fa["dkv"]),
        # B2 and B4 again as the the_one_ps rung's tier leg launches them
        # (phase 13): its launches there, their numbers on one of its batches
        entry("hot_probe_gather@rpc", hot_src, "paddle_tpu/ops/hot_kernels.py:116",
              rpc_counts["hot_probe_gather"], rpc_b2),
        entry("hot_scatter_apply@rpc", hot_src, "paddle_tpu/ops/hot_kernels.py:278",
              rpc_counts["hot_scatter_apply"], rpc_b4),
        # B1 again as phase 14's gpubox trainer process launches it over
        # RemoteSparseTable: its launches there, its numbers on that leg's
        # first push, measured in that process
        entry("ctr_sparse_rows@gpubox_rpc", b1_src, b1_ref,
              gpubox["launches"]["ctr_sparse_rows"], gpubox["b1"]),
        # B2 and B4 again as phase 16's tier arm launches them across a
        # failover: the chaos run's launches, their numbers on the first
        # batch after the promotion
        entry("hot_probe_gather@ha", hot_src, "paddle_tpu/ops/hot_kernels.py:116",
              ha_counts["hot_probe_gather"], ha_b2),
        entry("hot_scatter_apply@ha", hot_src, "paddle_tpu/ops/hot_kernels.py:278",
              ha_counts["hot_scatter_apply"], ha_b4),
        # B2 and B4 again as phase 17's tier leg launches them across a
        # grow: the warm epoch's launches, their numbers on its first batch
        entry("hot_probe_gather@reshard", hot_src, "paddle_tpu/ops/hot_kernels.py:116",
              rs_counts["hot_probe_gather"], rs_b2),
        entry("hot_scatter_apply@reshard", hot_src, "paddle_tpu/ops/hot_kernels.py:278",
              rs_counts["hot_scatter_apply"], rs_b4),
        # B2 and B4 again as phase 18's tenant launches them beside the
        # abuser: the warm epoch's launches, their numbers on its first batch
        entry("hot_probe_gather@tenancy", hot_src, "paddle_tpu/ops/hot_kernels.py:116",
              tn_counts["hot_probe_gather"], tn_b2),
        entry("hot_scatter_apply@tenancy", hot_src, "paddle_tpu/ops/hot_kernels.py:278",
              tn_counts["hot_scatter_apply"], tn_b4),
        # B1 again as phase 20's recsys train steps launch it: the three
        # families' launches summed, its numbers on GRU4Rec's first push
        entry("ctr_sparse_rows@recsys", b1_src, b1_ref, rs_launches, rs_b1),
        # B5-B7 again as phase 21's hybrid trainer launches them, once a hop
        # of the ring over cp: leg A's launches, their numbers at its hop
        entry("flash_attention_fwd@ring", fa_src, f"{fa_ref}:127",
              hyb["counts"]["flash_attention_fwd"], hyb["ring"]["fwd"]),
        entry("flash_attention_bwd_dq@ring", fa_src, f"{fa_ref}:176",
              hyb["counts"]["flash_attention_bwd_dq"], hyb["ring"]["dq"]),
        entry("flash_attention_bwd_dkv@ring", fa_src, f"{fa_ref}:221",
              hyb["counts"]["flash_attention_bwd_dkv"], hyb["ring"]["dkv"]),
        # B1 again as phase 22's DCN and xDeepFM passes launch it: each pass's
        # launches, its numbers on that family's first push
        entry("ctr_sparse_rows@dcn", b1_src, b1_ref, item5["families"]["DCN"]["launches"],
              item5["families"]["DCN"]["b1"]),
        entry("ctr_sparse_rows@xdeepfm", b1_src, b1_ref,
              item5["families"]["XDeepFM"]["launches"], item5["families"]["XDeepFM"]["b1"]),
        # B1 again as phase 23's DIN (embedx dim 64: the run-time-width
        # instantiation), ESMM and MMoE passes launch it: each pass's launches,
        # its numbers on that family's first push
        *(entry(f"ctr_sparse_rows@{f}", b1_src, b1_ref, item9["families"][f]["launches"],
                item9["families"][f]["b1"]) for f in ("din", "esmm", "mmoe")),
        # B1 again as phase 24's DeepWalk pass launches it at dim 128 (kMaxDim):
        # its launches there, its numbers on the first push
        entry("ctr_sparse_rows@deepwalk", b1_src, b1_ref, item8["deepwalk"]["launches"],
              item8["deepwalk"]["b1"]),
        # B5-B7 again as phase 24's pipeline trainer launches them (the three
        # schedules and the memory steps of leg A), their numbers at a
        # micro-batch's shape
        *(entry(f"flash_attention_{name}@pipeline", fa_src, f"{fa_ref}:{line}",
                item8["pipeline"]["counts"][f"flash_attention_{name}"],
                item8["pipeline"]["kernels"][key])
          for name, key, line in (("fwd", "fwd", 127), ("bwd_dq", "dq", 176),
                                  ("bwd_dkv", "dkv", 221))),
        # B5-B7 again as phase 26's SpmdTrainer launches them on the fused rungs
        # (a rank's attention [2, 512, 16, 64], the shape phase 24 checks and
        # times): their launches there, phase 24's numbers at that shape
        *(entry(f"flash_attention_{name}@spmd", fa_src, f"{fa_ref}:{line}",
                spmd["counts"][f"flash_attention_{name}"], item8["pipeline"]["kernels"][key])
          for name, key, line in (("fwd", "fwd", 127), ("bwd_dq", "dq", 176),
                                  ("bwd_dkv", "dkv", 221))),
        # B1 again as phase 12 leg B's cold-tier day launches it, over the
        # admission-gated, block-compressed fp16 SSD table: its launches
        # there, its numbers on that day's first push
        entry("ctr_sparse_rows@ssd_scale", b1_src, b1_ref, wd_cold["launches"], wd_cold["b1"]),
        # B3, B4 and B1 again as phase 27's processes launch them, each process
        # on its own row block: launches summed over the 4 processes, their
        # numbers on rank 0's first step (B3 on its 26,624 keys, B4 and B1 on
        # its owner push), measured in that process with the others idle
        entry("hot_probe@mp", hot_src, "paddle_tpu/ops/hot_kernels.py:212",
              mp["a"]["hot"]["launches"]["hot_probe"], mp["a"]["b3"]),
        entry("hot_scatter_apply@mp", hot_src, "paddle_tpu/ops/hot_kernels.py:278",
              mp["a"]["hot"]["launches"]["hot_scatter_apply"], mp["a"]["b4"]),
        entry("ctr_sparse_rows@mp", b1_src, b1_ref,
              mp["a"]["ctr"]["launches"]["ctr_sparse_rows"], mp["a"]["b1"]),
        # B5-B7 again as phase 27's leg B launches them in its 4 processes (a
        # rank's attention [2, 512, 16, 64]): launches summed over the
        # processes; the numbers are phase 24's at that shape, reused
        *(entry(f"flash_attention_{name}@mp", fa_src, f"{fa_ref}:{line}",
                mp["b"]["counts"][f"flash_attention_{name}"], item8["pipeline"]["kernels"][key])
          for name, key, line in (("fwd", "fwd", 127), ("bwd_dq", "dq", 176),
                                  ("bwd_dkv", "dkv", 221)))]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
