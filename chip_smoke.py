#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``horovod_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``horovod_tpu_torch/csrc`` (the optimizer
   tail, flash attention, the codec and BatchNorm), one ``nvcc`` per
   source, all started together;
3. the fused optimizer tail (B1 momentum, B2 sgd, B3 adam) against its
   plain PyTorch version on the card at 2,359,296 (the largest ResNet-50
   leaf), 25,557,032 (all parameters in one buffer) and 1,000 elements,
   float32 and bfloat16, Adam at steps 1 and 3: float32 bit for bit,
   bfloat16 within 1 bf16 ulp; B3 also at the leaf shapes of both
   transformer paths, float32, bit for bit; the multi-leaf launches
   against their plain loops: B2 (``sgd_update_multi``) and B1
   (``momentum_update_multi``, trace in place) over the 161 ResNet-50
   leaf shapes and an empty leaf, B3 (``adam_update_multi``, moments in
   place, steps 1 and 3) over the 75 transformer leaf shapes and an
   empty leaf, navg 1 and 2, float32 bit for bit and bfloat16 within 1
   ulp, one launch each; a list one row longer than a launch's parameter
   table (two launches) and leaves one element off the 16-byte grid (the
   scalar loop); then B1 and B2 over the 161 ResNet-50 leaves of one step
   and B3 over the 75 transformer leaves as the paths launch them (one
   launch per dtype group), each beside the old one launch per leaf, one
   launch over one buffer of all the elements, its plain version, its
   memory bound, the sweep's host time, and a PyTorch call: for B2
   ``torch._foreach_mul`` (the same function in one call), for B1
   ``torch._fused_sgd_`` and for B3 ``torch._fused_adam_`` (the nearest
   library calls, not the same function: they update the weights);
4. flash attention (B8 forward step, B9 dQ, B10 dK/dV) against the plain
   versions on the card: the transformer path's shape (192, 1024, 64)
   bf16, causal and not, from a fresh state; the carried state over two
   KV halves against one call; a fully masked block; float32 at (8,
   256, 64); bf16 within the JAX package's 2e-2 and within the tighter
   bounds of ``flash_attention.BF16_MAX_ABS`` and ``BF16_ROW_REL``; then
   each timed at the path's shape beside its plain version, its bound
   and ``scaled_dot_product_attention`` (and B9 + B10 together beside
   SDPA's backward), and at the long-context shape (12, 8192, 64) beside
   its bound and SDPA; the registers, local memory (stack and spills) and
   shared memory of the bf16 B8, B9 and B10 (``wgmma``) kernels from
   ``cudaFuncGetAttributes``;
5. a small ResNet, a small transformer and SmallCNN (96 px, batch 2)
   (float32, TF32 off) trained 3 steps on the card through the kernels
   (N1-N4 for the CNNs' BatchNorm) and on the CPU through the plain
   versions: losses and weights must agree; Inception-v3 at 139 px,
   batch 2, one step on the card against the CPU (loss, BatchNorm
   statistics) and against a float64 CPU evaluation (the whole
   gradient's relative L2 error, at most twice the CPU float32 run's
   plus 1e-3: this model's float32 gradients are rounding-dominated at
   random weights), then 3 card steps;
6. the ResNet-50 path: ``init()`` (world 1, NCCL), ResNet-50 at
   224x224, 1000 classes, batch 256, bf16 compute, ``DistributedOptimizer(
   fused_update.sgd(0.1, momentum=0.9))`` with ``HOROVOD_FUSED_UPDATE=1``
   on a seeded synthetic batch; every loss finite, exactly one
   momentum-kernel launch per step (the 161 leaves are one dtype group)
   and 53 launches of each of N1-N4 per step;
   then 3 steps of plain SGD,
   ``fused_update.sgd(0.1)``, on a new model: every loss finite, one B2
   launch and no B1 launch per step;
7. the transformer path: the JAX package's transformer bench config
   (vocab 32768, d_model 768, 12 x 64 heads, 12 layers, d_ff 3072, seq
   1024, batch 16, bf16) trained 6 steps with ``DistributedOptimizer(
   fused_update.adam(3e-4))``: losses finite and falling, 12 launches of
   each of B8, B9 and B10 and one of B3 per step;
8. the long-context config (seq 8192, batch 1) trained 2 steps, its
   peak memory below one float32 (12, 8192, 8192) score block per layer
   and below the measured peak plus one such block, and B8, B9 and B10
   checked at its attention shape (12, 8192, 64) bf16 causal;
9. the codec kernels (B4 quantize, B5 dequantize, B6 int4 pack, B7 int4
   unpack) against their plain versions, bit for bit, at the fused
   gradient buffer of both paths (25,557,032 and 110,906,112 float32 in
   blocks of 256) for the int8 headroom of 1, 2 and 4 ranks (qmax 127,
   63, 31; int4 7, 3, 1), with a block of .5 ties, a zero block, int32
   partial sums and the int8 sum of four payloads; each timed beside its
   plain version, its bound and, for B5, ``torch.mul``;
10. the lossy wire on the ResNet-50 path: the 161 gradient leaves of the
   main path's model through ``Compression.int8`` and ``Compression.int4``
   (exactly 161 launches of each of B4-B7, error at most scale / 2), then
   a 4-rank reduction at the fused-buffer width from four seeded 64-image
   batch shards, int8 at qmax 31 and int4 at qmax 1, with only the
   transport emulated on the one card: equal to the plain pipeline bit
   for bit and within n * scale / 2 of the float sum;
11. BatchNorm N1-N4 against their plain versions at the paths' shapes
   (ResNet-50's (256*112*112, 64) and (256*7*7, 2048), Inception-v3's
   (128*149*149, 32), (128*35*35, 48) and (128*8*8, 448)), bf16 and
   float32, train and eval, eps 1e-5 / 1e-3 and momentum 0.9 / 0.99:
   float32 statistics and sums no further from a float64 evaluation
   than twice the plain version's plus 1e-6 of scale, y and dx within
   one ulp or 2^-8 (bf16) / 2^-20 (float32) of the largest magnitude,
   the same bits from the same input twice; each timed at the largest
   BatchNorm of ResNet-50 and Inception-v3 beside its plain version,
   its bound and the nearest library calls (``torch.batch_norm``,
   ``aten.native_batch_norm_backward``: not the same function);
12. B1 over VGG-16's 32 leaf shapes (138,357,544 elements) in one
   launch, float32 bit for bit, bf16 within 1 ulp, timed; then VGG-16
   at 224 px, batch 128, bf16, dropout on, 5 steps: one B1 launch per
   step and no N1-N4 launch;
13. Inception-v3 at 299 px, batch 128, bf16, dropout on, 5 steps: one
   B1 launch and 94 launches of each of N1-N4 per step.  Both CNN paths
   report median and mean step time, img/s and peak memory;
14. ZeRO and the overlap engine: (a) the sharded tail at an emulated
   world of 4 with 4 buckets (only the transport emulated): the
   ResNet-50 gradients of four 64-image batch shards of the main path's
   model through ``fuse_bucket_piece``, summed, each rank's shard
   through ``fused_update_groups`` (B1, navg 4) and the update
   reassembled by ``leaf_from_buckets``, equal bit for bit to stage 0's
   B1 over the summed gradients; B3 likewise at the LM's 75 leaf shapes;
   one launch per emulated rank; (b) the ResNet-50 path (world 1 over
   NCCL) 3 steps at stage 0 + overlap, stages 1, 2 and 3 (stage 3
   through ``zero3_train_step``) and stage 2 + overlap: losses finite,
   one B1 and 53 of each of N1-N4 per step, median step time, peak
   memory and optimizer-state bytes, and one more step's tail on the
   captured gradients equal to stage 0's bit for bit; (c) the transformer
   at ZeRO stage 2, 3 steps: losses finite and falling, one B3 and 12 of
   each of B8-B10 per step;
15. sequence parallelism at the long-context LM's attention: (a) B8, B9
   and B10 against their plain versions at the ring's offsets (a block
   visible whole, one hidden whole, which must leave the fresh state and
   give zero gradients exactly, two partial blocks off the tile grid, the
   zigzag pairs) at (12, 2048, 64) bf16 and (8, 256, 64) f32; (b) the
   causal ring over an emulated group of 4 ranks at (12, 8192, 64) bf16,
   contiguous and zigzag, each rank walking its ``ring_plan`` with the
   ring's own step functions: out, dQ, dK and dV against the one-call
   kernels within ``BF16_MAX_ABS``/``BF16_ROW_REL``, launches per rank
   exactly as planned, kernel time per rank; (c) Ulysses emulated (12
   heads into 4 groups, ``blockwise_attention`` on each at L = 8192);
16. the data plane over an emulated world of 4 on the card (threads, one
   at a time, running the port's own functions; only the transfers
   between them are emulated, summed in member order): (a) the two-level
   lossy sum, ``quantized_allreduce(with_error=True)`` over a (cross 2,
   local 2) pair of ResNet-50's fused gradient buffer from four seeded
   64-image shards, int8 (B4/B5 at qmax ``sum_safe_qmax(2)``) and int4
   (B6/B7 at ``sum_safe_qmax4(2)``) on the cross hop only: bit for bit
   with the same pipeline run on the CPU (the plain versions), within nc
   * scale / 2 of the float sum with the scales of the local partial
   sums, the residual the cross hop's error divided by nl, one encode and
   two decode launches per emulated rank, ms before each transfer and
   payload bytes per hop; ZeRO stage 2 over the pair against stage 0 over
   it (B1 over the 161 ResNet-50 leaves, B3 at the LM's 75 leaf shapes;
   two steps): weights bit for bit, each rank's state shard at its
   ``shard_index``, one launch per rank per step; (b) Adasum over the 161
   leaves fused with per-leaf segments, f32 and bf16 over the world and
   f32 over the pair: every rank bit-identical, within rtol 1e-4 / atol
   1e-5 x scale (bf16 2^-7; the pair 1e-5 / 1e-6 against the local mean's
   Adasum) of the float64 ``adasum_reference``; (c) the main path at world
   1 over NCCL, 3 steps flat, under ``init(mesh="dp:1")`` and with
   ``op=Adasum``, deterministic cuDNN: losses and weights bit for bit, one
   B1 and 53 of each of N1-N4 per step;
17. tensor and expert parallelism in the LM over emulated worlds on the
   card (the ranks are threads of phase 16's ``EmulatedWorld``, each
   running ``Transformer(..., mesh=<its place>)``, ``lm_optimizer`` and
   ``lm_train_step``; the backward on the rank's own thread): (a) the
   bench LM (batch 16, fused Adam, 3 steps) at dp 1 x tp 2 against one
   rank at tp = 1 whose ``wqkv`` is ``tp_equivalent_wqkv`` of the same
   weights: losses within rtol 2e-2 and the step-1 gradient, joined
   from both ranks' shards, within 0.1 relative L2 (phase 15's bf16 LM
   tolerances); exactly 12 of each of B8-B10 (6 heads each) and one B3
   per rank per step; the peak memory and the bytes each tensor rank
   all-reduces; (b) the bench LM with a Switch-MoE MLP every second
   layer (2 experts per rank) at dp = ep = 4, batch 4 per rank: the
   first MoE layer's weights through ``moe_layer`` on every rank (4,096
   float32 tokens each) against ``moe_reference`` over all 8 experts
   (rtol 1e-4 / atol 1e-5, TF32 off), then 3 steps: losses finite and
   equal on every rank, 12 of each of B8-B10 and two B3 (one per
   reduction group) per rank per step; (c) the CPU tests' small LM
   (float32, SGD 0.5) at tp 2, then with MoE at ep 2, 3 steps on the
   card (kernels) and on the CPU (plain versions): losses within rtol
   1e-4, weights within 1e-4 of each tensor's largest magnitude;
18. pipeline parallelism in the LM over emulated worlds on the card
   (phase 17's ``EmulatedWorld``, whose hops also emulate
   ``Hop.permute``; each rank's own peak memory kept): (a) the bench LM
   (batch 16, fused Adam, 3 steps) at pp 2 under GPipe with 2
   microbatches against one card at pp = 1: the step-1 loss within rtol
   1e-3, the step-1 layer gradient joined from both stages within 0.1
   relative L2 of twice pp = 1's (the reference's factor: its
   broadcast's backward sums the cotangents over pp); exactly 12 of each
   of B8-B10 and one B3 per rank per step; the payload bytes per rank
   per step over pp equal to the reckoning (2 microbatches of
   activations or gradients, and the (16, 1024, 768) bf16 result all-
   reduced each way); each rank's peak memory; (b) the interleaved
   schedule at ``pp_virtual=2`` (5 schedule steps): losses within rtol
   2e-2 of (a)'s, the step-1 gradient within 0.1 relative L2 of (a)'s in
   the permuted storage order, launches as (a)'s; (c) ``pp_remat`` on
   (a): the gradient within 0.1 relative L2 of (a)'s, 24 B8 and 12 of
   B9 and B10 per rank per step, the peaks beside (a)'s; (d) the CPU
   tests' small LM (float32, SGD 0.5) at pp 2 under GPipe and the
   interleaved schedule, 3 steps on the card (kernels) and on the CPU
   (plain versions): every rank's losses within rtol 1e-4 and weights
   within 1e-4 of each tensor's largest magnitude;
19. local SGD / DiLoCo over phase 16's emulated (cross 2, local 2)
   world: (a) the bench step (ResNet-50 224 px, batch 256 per rank, each
   rank its own seeded batch, bf16, ``fused_update.sgd(0.1,
   momentum=0.9)`` under ``LocalSGD`` at H = 2, deterministic cuDNN), 4
   inner steps with syncs after steps 2 and 4, at stages 0 and 2 on the
   none, int8 and int4 outer wires: one B1 per rank per inner step and
   one encode and two decode launches (B4/B5, B6/B7) per lossy sync; the
   cross-hop bytes per sync as reckoned (``ls_cross_bytes``: nothing
   during the inner steps); a slice's ranks bit-identical after every
   inner step and all four after every sync; stage 2 bit for bit stage
   0 on the none wire; each new anchor within the float32 rounding (plus
   half a quantization step through the outer step on a lossy wire) of a
   float64 recomputation from the ranks' anchors, parameters, residuals
   and velocity; per-rank ms of the inner step and the sync (each rank's
   own work, one at a time) and the outer-state bytes; (b) SmallCNN
   (float32, TF32 off) under ``LocalSGD`` at stage 0 on the int8 wire,
   4 steps on the card and on the CPU: losses within rtol 1e-4, weights
   within 1e-5 of each tensor's largest magnitude;
20. the eager negotiated plane: (a) the process's runtime at world 1
   over NCCL: the 161 gradient leaves of the main path's model (224 px,
   batch 256, bf16) through ``hvd.allreduce_async`` under their frontend
   names ``allreduce.<param>``, one allgather, broadcast, reducescatter
   and alltoall, each equal to its input bit for bit, the rounds and the
   median round latency; then ``horovod_tpu_torch.torch.
   DistributedOptimizer(torch.optim.SGD(lr=0.01))`` 3 steps, bit for bit
   with plain SGD (deterministic cuDNN); (b) an emulated world of 4: four
   ``BackgroundRuntime``s, each with its own ``KVController`` over one
   in-process ``DictTransport`` and an ``EagerExecutor`` over phase 16's
   ``EmulatedWorld`` flat hop (a runtime holds its rank's turn on the
   device while it executes a response); each rank submits its own
   64-image shard's 161 gradients in hook order rotated by a seeded shift
   and drives its runtime's cycles, two steps on each of the none, int8
   and int4 wires (fresh runtimes per wire): every rank the same bits;
   none bit for bit with phase 16's in-trace ``grouped_allreduce``;
   int8/int4 each fused response bit for bit with ``quantized_allreduce``
   on the CPU (the plain versions) and within n * scale / 2 of the float
   sum; one encode and one decode launch per fused response per rank
   (none on the none wire); step 2 served by the cache's fast path (a
   fast round, no explicit request); then, with the background threads
   started, a shape mismatch raising the coordinator's message on every
   rank, the runtimes reducing afterwards, and a join with uneven work
   returning the last rank to join; per rank the rounds, fast rounds and
   responses per step, payload bytes per response and the work before
   each transfer;
21. the rest of the eager plane and the training paths on it, over four
   emulated runtimes started on their own threads (phase 20b's, over the
   eager module's handle manager; each emulated rank's thread bound to
   its runtime with ``ops.eager.bound_runtime``), on the captured
   gradients of the main path's model's 161 leaves (four 64-image
   shards): (a) ``DistributedOptimizer(fused_update.sgd(0.1,
   momentum=0.9), eager=True)`` at stages 1, 2 and 3 on the none and int8
   wires, two steps: on the none wire bit for bit the in-trace stage
   over the same emulated world, on int8 within the wire's bound of the
   none wire; per rank, from the wrappers' launch counters, one B1 per
   step and one B4 and one B5 per reduce-scatter response (none on the
   none wire, no B6/B7 on either), the responses, the
   payload bytes and the optimizer state; (b) local SGD's eager regime
   (no axis pair; (cross 2, local 2); H = 2; 4 inner steps) bit for bit
   the in-trace ``LocalSGD`` over the emulated pair, nothing on the cross
   hop in an inner step and one float32 delta per sync; (c)
   ``HOROVOD_CONTROL_FANOUT=2``: stage 2's responses byte-identical to the
   flat plane's; (d) liveness at 0.2 s / 2 s: one emulated rank stops
   beating and answering, the other three raise ``RanksDownError`` naming
   it within the timeout plus 5 s; (e) the native wire codec
   (``csrc/wire.cc``, built with ``g++``) is the one loaded; the median
   round latency of phase 20b's step with the native and the Python
   codec, and a cold round's messages alone through each;
22. the observability planes: (a) the ResNet-50 bench step of phase 6
   at world 1 over NCCL, two warm-up steps, then two rounds of 10 bare
   and 10 observed steps in alternation (observed: ``hvd.trace_step``,
   the on-card batch through ``hvd.wrap_data_loader``,
   ``HOROVOD_FLIGHT_DIR`` and ``HOROVOD_GOODPUT_DIR`` set, the rank's
   ``/metrics`` endpoint on a held port, scraped once at the end): one
   B1 and 53 of each of N1-N4 per step in both modes, finite losses,
   ``hvd_step_time_seconds`` counting the observed steps, the goodput
   phases summing to the ledger's elapsed time, the scrape parsing as
   Prometheus text, and the flight dump merged by
   ``horovod_tpu_torch.trace`` holding one complete ``step`` span per
   observed step whose split sums to its wall; both modes' median steps
   and their ratio; (b) phase 20b's four emulated runtimes on the int8
   wire over 2 steps: the background's wire-byte and logical-byte
   counters equal to the bytes the emulated world moved, the
   negotiation-latency histogram counting every round, one ``dispatch``
   B/E pair per response, and one B4 and one B5 per fused float
   response;
23. the training-health plane and the checkpoint: (a) the ResNet-50
   bench step of phase 6, two warm-up steps, then two rounds of 10
   steps health off and 10 with ``HOROVOD_HEALTH=1`` in alternation (one
   B1 and 53 of each of N1-N4 per step in both modes, finite losses,
   both medians and their ratio, the tap alone timed); the tail on one
   set of captured gradients with health on and off, bit for bit; under
   ``HOROVOD_HEALTH_SKIP_NONFINITE=1`` one step with
   ``HOROVOD_FAULT_SPEC=nan:grads*``: parameters and trace bit for bit
   as before it, no B1, ``hvd_nonfinite_total{float32, rank 0}`` > 0,
   one step skipped, a ``health`` event on the flight ring, and the
   next clean step one B1 that moves the weights; (c) that state
   (parameters, BatchNorm buffers, trace) saved and restored into fresh
   objects on the card bit for bit, the save and restore wall times
   against the goodput ledger's ``checkpoint`` phase, and phase 14a's
   emulated stage-2 trace shards at 4 ranks saved through their host
   form and re-cut for 2, gathered bit for bit; (b) phase 20b's four
   emulated runtimes on the int8 wire over 3 steps with health on and
   ``nan@rank2:grad_buffer*:round2``: one verdict per fused response,
   one naming rank 2 / float32, one B4 and one B5 per response; then
   with ``HOROVOD_ADAPTIVE_COMPRESSION=1`` and the overlap schedule, a
   finite ``hvd_compression_residual_ratio`` for each of 4 buckets.

24. the elastic plane, every run launched by ``python -m
   horovod_tpu_torch.run`` as a child (this script's hidden
   ``--phase24-worker`` mode) on phase 6's ResNet-50 step with
   deterministic cuDNN: (a) the port's native KV store builds into its
   own library (``libhvdtorchkv_<hash>.so``), refuses a wrong secret,
   and its set/get round trip over loopback (median of 1000, us); (b)
   ``-np 1 --restart-attempts 1 --checkpoint-dir D``: attempt 0 commits
   durably at steps 2 and 4, leaves a torn ``step_6`` staging dir and
   SIGKILLs itself after step 5; the launcher restarts it with
   ``HOROVOD_RESUME_STEP=4``; attempt 1's restored state equals the
   step-4 snapshot and its step-8 parameters and trace equal an
   uninterrupted 8-step launch's, bit for bit; the downtime and its
   parts (respawn, ``init()``, restore, first step); (c) ``--elastic
   -np 1`` committing durably every step, SIGTERM after step 3: the rank
   drains at the agreed boundary with one emergency commit and exits 0,
   the launcher classifies it ``preempted`` and returns 0; a second
   launch on D resumes from that commit bit for bit; the drain time,
   ``hvd_preempt_drain_seconds`` and the commit's wall time against
   ``HOROVOD_PREEMPT_GRACE_SECONDS``.  Every launch holds one B1 and 53
   of each of N1-N4 per step (the ``launches_restart`` and
   ``launches_preempt`` keys of the kernels line).

25. the timeline and the autotuner: (a) ``init()`` under
   ``HOROVOD_TIMELINE`` and ``HOROVOD_TIMELINE_MARK_CYCLES`` at world 1
   over NCCL, the ResNet-50 step (224 px, batch 256, bf16) with phase
   20a's 161 gradients through ``hvd.allreduce_async_`` after the
   backward and the fused momentum SGD's tail, 3 rounds of 4 steps with
   the runtime's
   writer detached and attached in alternation: the trace parses after
   ``shutdown()``; each gradient's row holds ``NEGOTIATE_ALLREDUCE`` B
   and E, ``RANK0_READY`` and ``XLA_ALLREDUCE`` B and E once per traced
   step, plus ``CYCLE_START`` marks; one B1 and 53 of each of N1-N4 per
   step both ways; both medians, their ratio and the writer's host time
   per step (an event's stamp, append and flush timed alone, times the
   events per step); (b) phase 20b's four emulated runtimes under
   ``HOROVOD_AUTOTUNE``, ``HOROVOD_ADAPTIVE_COMPRESSION`` and
   ``HOROVOD_OVERLAP`` with one-round sample windows, 6 steps: every rank
   applied the same proposals at the same rounds and ran every round
   under the same knobs; per response the mode of each bucket and its
   B4-B7 launches equal to its modes' codec (the kernels' own counters);
   each response's result bit for bit the same bucketed schedule's plain
   versions on the CPU under the knobs it ran with; rank 0's samples,
   pinning and final knobs (the ``launches_timeline`` and
   ``launches_autotune`` keys of the kernels line).

26. the autopilot on phase 6's ResNet-50 step (deterministic cuDNN):
   (a) at world 1 in process, ``ElasticState(checkpoint_dir=D)`` under
   ``HOROVOD_HEALTH=1`` and ``HOROVOD_CHECKPOINT_KEEP=4``, a commit
   every 2 steps, 10 steps: a reference run with the autopilot off, then
   ``HOROVOD_AUTOPILOT=1`` with step 5 poisoned once (``nan:grads*`` set
   for that step): the nonfinite sentinel trips, the next commit is
   stamped ``poisoned``, the commit's tick rolls back to the newest
   healthy commit (step 4) and the loop replays; the final parameters,
   BatchNorm buffers and momentum traces equal the reference's bit for
   bit, ``rank_autopilot().stats()["rollbacks"] == 1`` and one
   ``applied`` autopilot event on the ring; then under
   ``HOROVOD_AUTOPILOT_DRY_RUN=1`` the verdict is ``dry_run`` and
   nothing is restored; the tick's host time per commit (median, on
   against off) and the rollback's wall time; (b) ``python -m
   horovod_tpu_torch.run -np 1 --elastic --autopilot --checkpoint-dir D``
   over the ``apdrain`` worker: the engaged line once, the rank's
   ``--preempt 0`` applied through the ungated ``preempt_drain`` rule,
   the rank drained with one emergency commit and exit 0, the launcher's
   return 0, its flight dump holding the verdict with rank, uid and
   source; the drain time beside 24c's.  One B1 and 53 of each of N1-N4
   per step that ran, replayed steps included (the
   ``launches_autopilot`` key of the kernels line).

27. the fleet simulator (``horovod_tpu_torch.runtime.simfleet``, host
   only, no kernel; every ``HOROVOD_*`` knob cleared for its run) at the
   JAX package's documented scale: ``run_trace(256, 16, 3)`` and
   ``reform_storm(256, 16, 8)`` twice each, identical, the roster dense
   at 248; ``coordinated_abort(32, 8, 5)`` reaching all 31 survivors;
   ``measure_scaling(1024, 32, 3)`` at a root-message ratio of at least
   8; ``local_sgd_scaling(256, 16, 4, 2)`` at a round ratio of at least
   4; ``straggler_drill`` (and its dry run) and ``preempt_storm`` at
   (256, 16), replayed; ``slo_burn_drill()``; ``rollback_drill()`` with
   its parameters on the card: one rollback, bit-exact, the same
   ``final_digest`` as the drill at ``device="cpu"``, and the dry run
   not bit-exact.  Each scenario's wall time on a line of its own with
   the card's name and power limit.

28. the perf observatory on phase 6's ResNet-50 step at world 1 over
   NCCL: (a) two warm-up steps, one step under
   ``torch.utils.flop_counter.FlopCounterMode`` (its count is
   ``set_step_flops``), then 8 steps under ``hvd.trace_step`` with
   ``HOROVOD_PROFILE_EVERY_N_STEPS=2`` and ``HOROVOD_PROFILE_KEEP=2``,
   each timed with CUDA events inside its span and the analyzer joined
   after it: at least 2 captures analyzed and 2 step directories kept;
   each kept capture's device compute within [0.5, 1.05] of its step's
   CUDA-event time, its comm 0 (world 1 runs no collective), the fused
   tail's ``multi_kernel`` found once and each of N1-N4's kernels 53
   times in it, equal to the wrappers' counters over that step; the
   ``hvd_device_*`` gauges equal to the last analysis, ``hvd_mfu`` in
   (0, 1], the goodput ledger booking ``comm_exposed`` from the device;
   the event categories and counts of the capture printed; (b) two
   rounds of 6 steps with the knob off and 6 with it on, in alternation:
   the median of the un-sampled steps against the knob off, beside the
   two off rounds' own ratio (the ``launches_profile`` key of the
   kernels line).
29. the invariant lint suite on the card (``horovod_tpu_torch/analysis``):
   (a) ``python -m horovod_tpu_torch.analysis all --json`` in a
   subprocess (the knob, concurrency and schedule passes, the program
   set on the card): exit 0, the summary counts and the skipped rules
   printed; (b) ``programs.run()`` in process, 8 emulated ranks on the
   card: no finding (every preset clean, every control flagged), B4 and
   B5 launched (their ``LAUNCHES`` equal to the kernel records) in the
   lossy programs only, every int8 transfer of the hierarchical int8
   program on a cross hop; (c) phase 6's ResNet-50 step at world 1 under
   the recorder: ``single_fused_kernel`` holds (B1 recorded once per
   step), N1-N4 recorded 53 times each, equal to their counters; the
   positive control, the tail run leaf by leaf (``momentum_update``, one
   buffer per leaf, 161 launches) is flagged ``SCHED-FUSED-TAIL``; the
   aten and c10d op names of the step and of a world-1 NCCL all-reduce,
   reduce-scatter and all-gather with their counts; (d) what the closed
   hooks (``common/events.py``) add to that step: (i) each hook timed
   against the work the parent did in its place (an inline
   ``LAUNCHES`` bump; ``note_sent``), times the step's launches and hop
   transfers, as a share of the step; (ii) three rounds of 8 steps with
   each hook doing only the parent's work and 8 as shipped, in
   alternation: the median step ratio beside the first arm's own
   rounds' spread (the ``launches_analysis`` key of the kernels line on
   B1, B4, B5 and N1-N4).

Then the run's wall time, a ``{"kernels": [...]}`` line, the
``nvidia-smi`` line, and as the last line ``{"ok": true, "device":
{...}}``.
``--profile FILE`` adds a device-time breakdown of the ResNet-50 path
(table in FILE), the VGG-16, Inception-v3, transformer and long-context
paths and the health tap (tables in FILE with ``_vgg16``,
``_inception3``, ``_transformer``, ``_long`` and ``_health`` before its
suffix).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

MEM_BW = 3.35e12       # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
F32_PEAK = 67e12       # H100 SXM float32 outside the tensor cores, FLOP/s
BF16_PEAK = 989e12     # H100 SXM dense bf16 tensor cores, FLOP/s
STEPS, BATCH = 6, 256  # main path: bench.py's batch per chip
N_LEAF_MAX = 2_359_296
N_PARAMS = 25_557_032
REPLACES = {
    "momentum": "horovod_tpu/optim/fused_update.py:314",
    "sgd": "horovod_tpu/optim/fused_update.py:299",
    "adam": "horovod_tpu/optim/fused_update.py:331",
    "flash_block_step": "horovod_tpu/ops/pallas_attention.py:94",
    "flash_bwd_dq": "horovod_tpu/ops/pallas_attention.py:256",
    "flash_bwd_dkv": "horovod_tpu/ops/pallas_attention.py:301",
    "quantize": "horovod_tpu/ops/quantization.py:210",
    "dequantize": "horovod_tpu/ops/quantization.py:232",
    "pack4": "horovod_tpu/ops/quantization.py:496",
    "unpack4": "horovod_tpu/ops/quantization.py:519",
}
CODECS = ("quantize", "dequantize", "pack4", "unpack4")
# the JAX package's transformer bench (bench.py:_bench_transformer)
LM = dict(vocab=32768, d_model=768, n_heads=12, head_dim=64, n_layers=12,
          d_ff=3072)
LM_STEPS, LM_BATCH, LM_SEQ = 6, 16, 1024
LONG_STEPS, LONG_BATCH, LONG_SEQ = 2, 1, 8192
# one float32 (heads, L, L) score block for each layer: what a backward
# that kept its scores would hold at the long-context config
LONG_MEM_LIMIT = LM["n_layers"] * LM["n_heads"] * LONG_SEQ ** 2 * 4
# and the tighter gate: the peak measured on an H100 80GB HBM3 at 700 W
# (9,219,148,288 B, PERF.md) plus one layer's f32 score block, which a
# backward that kept bf16 scores for every layer, or f32 scores for two
# layers, would exceed
LONG_MEM_TIGHT = 9_219_148_288 + LM["n_heads"] * LONG_SEQ ** 2 * 4
LM_LEAVES = 3 + 6 * LM["n_layers"]
# the fused float32 gradient buffer of each path, in blocks of 256
QBLOCK = 256
CODEC_BUFFERS = {"ResNet-50": N_PARAMS, "transformer": 110_906_112}
# bytes per element moved (float32 side 4 B, int8 side 1 B or 1/2 B) and
# float operations per element (B4/B6: multiply, rint, two clamps; B5/B7:
# one multiply); plus one 4 B scale per block
CODEC_BYTES = {"quantize": 5, "dequantize": 5, "pack4": 4.5, "unpack4": 4.5}
CODEC_FLOPS = {"quantize": 4, "dequantize": 1, "pack4": 4, "unpack4": 1}
CODEC_LIBRARY = {
    "dequantize": "torch.mul(q2d, scales[:, None]) (int8 x float32 -> "
                  "float32 in one kernel)",
    "quantize": None, "pack4": None, "unpack4": None}
NO_LIBRARY = ("no one PyTorch call computes it: torch.quantize_per_channel "
              "divides by the scale and clamps to [-128, 127]")
# the paths' attention shapes: (batch * heads, seq, head_dim)
ATTN_SHAPE = (LM_BATCH * LM["n_heads"], LM_SEQ, LM["head_dim"])
LONG_ATTN_SHAPE = (LONG_BATCH * LM["n_heads"], LONG_SEQ, LM["head_dim"])
FLASH = ("flash_block_step", "flash_bwd_dq", "flash_bwd_dkv")
# the bf16 kernels on the tensor cores (f32 and the rest run on the CUDA
# cores)
TC_KERNELS = FLASH
SGD_STEPS = 3
# bf16: p and ds are rounded to bf16 and the kernels sum in another
# order, so a value that crosses a rounding boundary moves by one bf16
# ulp; this is the JAX package's own bf16 tolerance
# (tests/test_pallas_attention.py:118), and bf16 results are also held to
# flash_attention.BF16_MAX_ABS and BF16_ROW_REL.  f32: only the order of
# the sums differs (TF32 off).
ATTN_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-4, 1e-5)}
# bytes moved and float operations per element (f32): reads + writes
BYTES_PER_EL = {"sgd": 8, "momentum": 16, "adam": 24}
FLOPS_PER_EL = {"sgd": 1, "momentum": 3, "adam": 12}


def log(msg: str) -> None:
    print(msg, flush=True)


def pin_one_card() -> str:
    """Make the run see one card, the first one it was given, before
    CUDA starts: the smoke uses one card and reports one.  Returns that
    card's index (or UUID) for ``nvidia-smi -i``."""
    os.environ.setdefault("CUDA_DEVICE_ORDER", "PCI_BUS_ID")
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    card = "0" if visible is None else visible.split(",")[0].strip()
    os.environ["CUDA_VISIBLE_DEVICES"] = card
    return card


def nvidia_smi_line(card: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", card, "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _ulps(a, b):
    """Elementwise distance in ulps of a's dtype (float32 or bfloat16)."""
    import torch

    if a.dtype == torch.bfloat16:
        ia, ib = a.view(torch.int16).int(), b.view(torch.int16).int()
        sign = 1 << 15
    else:
        ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
        sign = 1 << 31
    ia = torch.where(ia < 0, -(ia & (sign - 1)), ia)
    ib = torch.where(ib < 0, -(ib & (sign - 1)), ib)
    return (ia - ib).abs()


def ulp_diff(a, b) -> int:
    """Largest distance in ulps of a's dtype (float32 or bfloat16)."""
    return int(_ulps(a, b).max().item()) if a.numel() else 0


def _hold_ulp(res: dict, kind: str, got, want, tol: int, what: str):
    for a, b in zip(got, want):
        err = float((a.float() - b.float()).abs().max().item()) \
            if a.numel() else 0.0
        ulp = ulp_diff(a, b)
        r = res[kind]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["max_ulp"] = max(r["max_ulp"], ulp)
        if ulp > tol:
            raise AssertionError(f"{kind} {what}: kernel is {ulp} ulp from "
                                 f"its plain version (max abs {err})")


def _off_grid(torch, t):
    """A copy of ``t`` whose base address is one element off the 16-byte
    grid."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def multi_check(TF, torch, res, kind, shapes, gen, dtype, navg, step,
                off_grid=False) -> int:
    """One multi-leaf launch of B1 (``kind`` momentum) or B3 (adam) over
    new leaves of ``shapes``, its state updated in place, held against
    the plain loop on copies of that state (float32 0 ulp, bfloat16 1
    ulp); with ``off_grid`` every other leaf is a view one element off
    the 16-byte grid.  Returns the launches it took."""
    def new(s):
        return torch.randn(s, device="cuda", generator=gen).to(dtype)

    grads = [new(s) for s in shapes]
    if off_grid:
        grads = [_off_grid(torch, g) if i % 2 else g
                 for i, g in enumerate(grads)]
    states = [[new(s) for s in shapes] for _ in range(2)]
    states[1] = [v.abs() for v in states[1]]
    before = [[x.clone() for x in st] for st in states]
    TF.reset_launch_counts()
    if kind == "momentum":
        got = TF.momentum_update_multi(grads, states[0], navg, 0.9, -0.1,
                                       t_outs=states[0])
        want = zip(*[TF.momentum_plain(g, t, navg, 0.9, -0.1)
                     for g, t in zip(grads, before[0])])
    else:
        spec = TF.FusedSpec("adam", 3e-4)
        bc1, bc2 = TF.bias_corrections(spec, step)
        got = TF.adam_update_multi(grads, *states, bc1, bc2, navg, spec,
                                   mu_outs=states[0], nu_outs=states[1])
        want = zip(*[TF.adam_plain(g, m, v, bc1, bc2, navg, spec)
                     for g, m, v in zip(grads, *before)])
    torch.cuda.synchronize()
    launches = TF.LAUNCHES[kind]
    for gl, wl in zip(got, want):
        _hold_ulp(res, kind, gl, wl, 0 if dtype == torch.float32 else 1,
                  f"{len(shapes)} leaves in one call, {dtype} navg={navg} "
                  f"step={step} off_grid={off_grid}")
    return launches


def kernel_checks(TF, torch, adam_shapes, sgd_shapes, lm_leaves) -> dict:
    """Phase 3a: kernel against plain version; returns per-kernel
    max_abs_err (and max ulp).  B3 is also held at the distinct leaf
    shapes ``adam_shapes`` of the path that runs it; the multi-leaf
    launches of B2 and B1 over the leaf shapes ``sgd_shapes`` and an
    empty leaf, of B3 over ``lm_leaves`` and an empty leaf; a list one
    row past a launch's table; leaves off the 16-byte grid."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    res = {k: {"max_abs_err": 0.0, "max_ulp": 0}
           for k in ("sgd", "momentum", "adam")}
    for n in (N_LEAF_MAX, N_PARAMS, 1000):
        for dtype in (torch.float32, torch.bfloat16):
            g, t, v = (torch.randn(n, device="cuda", generator=gen)
                       .to(dtype) for _ in range(3))
            v = v.abs()
            cases = [("sgd", 1, None), ("momentum", 1, None),
                     ("adam", 1, 1), ("adam", 1, 3)]
            if n == 1000:
                cases += [("sgd", 3, None), ("momentum", 3, None),
                          ("adam", 3, 3)]
            for kind, navg, step in cases:
                spec = TF.FusedSpec(kind, 0.1, 0.9)
                if kind == "sgd":
                    got = [TF.sgd_update(g, navg, -0.1)]
                    want = [TF.sgd_plain(g, navg, -0.1)]
                elif kind == "momentum":
                    got = TF.momentum_update(g, t, navg, 0.9, -0.1)
                    want = TF.momentum_plain(g, t, navg, 0.9, -0.1)
                else:
                    bc1, bc2 = TF.bias_corrections(spec, step)
                    got = TF.adam_update(g, t, v, bc1, bc2, navg, spec)
                    want = TF.adam_plain(g, t, v, bc1, bc2, navg, spec)
                torch.cuda.synchronize()
                _hold_ulp(res, kind, got, want,
                          0 if dtype == torch.float32 else 1,
                          f"n={n} {dtype} navg={navg} step={step}")
            log(f"[kernels] n={n} {str(dtype)[6:]}: sgd, momentum, adam "
                "agree with their plain versions")
            del g, t, v
    spec = TF.FusedSpec("adam", 3e-4)
    for shape in sorted(set(adam_shapes)):
        g, mu, nu = (torch.randn(shape, device="cuda", generator=gen)
                     for _ in range(3))
        nu = nu.abs()
        for step in (1, 3):
            bc1, bc2 = TF.bias_corrections(spec, step)
            got = TF.adam_update(g, mu, nu, bc1, bc2, 1, spec)
            want = TF.adam_plain(g, mu, nu, bc1, bc2, 1, spec)
            torch.cuda.synchronize()
            _hold_ulp(res, "adam", got, want, 0, f"{shape} step={step}")
    log(f"[kernels] adam at the path's {len(set(adam_shapes))} distinct "
        "leaf shapes, float32, steps 1 and 3: bit-exact")
    shapes = list(sgd_shapes) + [(0,)]
    for dtype in (torch.float32, torch.bfloat16):
        grads = [torch.randn(s, device="cuda", generator=gen).to(dtype)
                 for s in shapes]
        for navg in (1, 2):
            TF.reset_launch_counts()
            got = TF.sgd_update_multi(grads, navg, -0.1)
            torch.cuda.synchronize()
            if TF.LAUNCHES["sgd"] != 1:
                raise AssertionError(f"sgd_update_multi launched "
                                     f"{TF.LAUNCHES['sgd']} times")
            want = [TF.sgd_plain(g, navg, -0.1) for g in grads]
            _hold_ulp(res, "sgd", got, want, 0,
                      f"one launch over {len(shapes)} leaves {dtype} "
                      f"navg={navg}")
        del grads, got, want
    log(f"[kernels] sgd in one launch over the {len(shapes) - 1} ResNet-50 "
        "leaf shapes and an empty leaf, float32 and bfloat16, navg 1 and 2: "
        "bit for bit with the plain loop")
    cases = (("momentum", list(sgd_shapes), ((1, None), (2, None))),
             ("adam", list(lm_leaves), ((1, 1), (1, 3), (2, 1), (2, 3))))
    for kind, kshapes, runs in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for navg, step in runs:
                n = multi_check(TF, torch, res, kind, kshapes + [(0,)], gen,
                                dtype, navg, step)
                want = -(-len(kshapes) // TF.capacity(kind))
                if n != want:
                    raise AssertionError(f"{kind}_update_multi over "
                                         f"{len(kshapes)} leaves launched "
                                         f"{n} times, expected {want}")
            torch.cuda.empty_cache()
        log(f"[kernels] {kind} in {want} launch(es) over the {len(kshapes)} leaf "
            f"shapes and an empty leaf, state in place, float32 and "
            f"bfloat16, (navg, step) {[r for r in runs]}: float32 bit for "
            f"bit, bfloat16 within 1 ulp of the plain loop (largest "
            f"{res[kind]['max_ulp']} ulp)")
    for kind in ("sgd", "momentum", "adam"):
        cap = TF.capacity(kind)
        kshapes = [(1 + 37 * i % 5000,) for i in range(cap + 1)]
        if kind == "sgd":
            grads = [torch.randn(s, device="cuda", generator=gen)
                     for s in kshapes]
            TF.reset_launch_counts()
            got = TF.sgd_update_multi(grads, 2, -0.1)
            torch.cuda.synchronize()
            n = TF.LAUNCHES["sgd"]
            _hold_ulp(res, "sgd", got, [TF.sgd_plain(g, 2, -0.1)
                                        for g in grads], 0, "split")
        else:
            n = multi_check(TF, torch, res, kind, kshapes, gen,
                            torch.float32, 2, 2)
        if n != 2:
            raise AssertionError(f"{kind}: {cap + 1} rows (capacity {cap}) "
                                 f"took {n} launches, expected 2")
        for dtype in (torch.float32, torch.bfloat16):
            if kind != "sgd":
                multi_check(TF, torch, res, kind, list(sgd_shapes[:24]), gen,
                            dtype, 2, 3, off_grid=True)
        log(f"[kernels] {kind}: {cap + 1} leaves (a launch takes {cap}) in "
            f"two launches; " + ("" if kind == "sgd" else
                                  "24 leaves, every other one off the "
                                  "16-byte grid, float32 and bfloat16; ")
            + "equal to the plain loop")
    return res


def host_ms(torch, fn, reps: int = 20) -> float:
    """Median host time of one call of ``fn`` (``perf_counter`` around
    the call, no synchronise inside: what the launching thread spends)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def kernel_timings(TF, torch, shapes, kinds) -> dict:
    """Phase 3b: each kernel of ``kinds`` over one step's leaves (its
    path's shapes) as its path launches it (one launch over the leaves),
    beside its plain version, the old one launch per leaf, one launch
    over one buffer of all the elements, the sweep's host time and a
    PyTorch call: the same function in one call for B2
    (``torch._foreach_mul``), the nearest library call for B1 and B3
    (``torch._fused_sgd_``, ``torch._fused_adam_``: not the same
    function, they update the weights); B2 also ``torch.mul`` leaf by
    leaf."""
    gen = torch.Generator(device="cuda").manual_seed(99)

    def leaves():
        return [torch.randn(s, device="cuda", generator=gen)
                for s in shapes]

    g, t, v = leaves(), leaves(), [x.abs() for x in leaves()]
    u = [torch.empty_like(x) for x in g]
    n_el = sum(x.numel() for x in g)
    spec = TF.FusedSpec("adam", 0.1)
    bc1, bc2 = TF.bias_corrections(spec, 3)
    calls = {  # (the path's launch, one launch per leaf, plain)
        "sgd": (lambda: TF.sgd_update_multi(g, 1, -0.1, outs=u),
                lambda: [TF.sgd_update(a, 1, -0.1, out=o)
                         for a, o in zip(g, u)],
                lambda: [TF.sgd_plain(a, 1, -0.1) for a in g]),
        "momentum": (lambda: TF.momentum_update_multi(
                         g, t, 1, 0.9, -0.1, outs=u, t_outs=t),
                     lambda: [TF.momentum_update(a, b, 1, 0.9, -0.1, out=o,
                                                 t_out=b)
                              for a, b, o in zip(g, t, u)],
                     lambda: [TF.momentum_plain(a, b, 1, 0.9, -0.1)
                              for a, b in zip(g, t)]),
        "adam": (lambda: TF.adam_update_multi(
                     g, t, v, bc1, bc2, 1, spec, outs=u, mu_outs=t,
                     nu_outs=v),
                 lambda: [TF.adam_update(a, b, c, bc1, bc2, 1, spec, out=o,
                                         mu_out=b, nu_out=c)
                          for a, b, c, o in zip(g, t, v, u)],
                 lambda: [TF.adam_plain(a, b, c, bc1, bc2, 1, spec)
                          for a, b, c in zip(g, t, v)]),
    }
    params = [x.clone() for x in g]
    steps = [torch.tensor(3.0, device="cuda") for _ in g]
    library = {  # (call, label, computes the same function)
        "sgd": (lambda: torch._foreach_mul(g, -0.1),
                "torch._foreach_mul (one call over the leaves)", True),
        "momentum": (lambda: torch._fused_sgd_(
                         params, g, t, weight_decay=0.0, momentum=0.9,
                         lr=0.1, dampening=0.0, nesterov=False,
                         maximize=False, is_first_step=False),
                     "torch._fused_sgd_ over the same leaves (momentum 0.9,"
                     " dampening 0): nearest library call, not the same "
                     "function (it updates the weights)", False),
        "adam": (lambda: torch._fused_adam_(
                     params, g, t, v, [], steps, lr=0.1, beta1=0.9,
                     beta2=0.999, weight_decay=0.0, eps=1e-8, amsgrad=False,
                     maximize=False),
                 "torch._fused_adam_ over the same leaves: nearest library "
                 "call, not the same function (it updates the weights and "
                 "orders Adam's operations otherwise)", False),
    }
    flat = torch.randn(n_el, device="cuda", generator=gen)
    flat_t, flat_u = torch.randn_like(flat), torch.empty_like(flat)
    flat_v = torch.randn_like(flat).abs()
    consts = {"sgd": (-0.1,), "momentum": (0.9, -0.1),
              "adam": (0.1, 0.9, 0.001, 0.999, bc1, bc2, 0.0, 1e-8, -0.1)}

    def kernel_only(kind):
        """The C entry on a table built once: the launch without the
        wrapper's Python checks and table (the kernel's device time)."""
        ops = {"sgd": (g, u), "momentum": (g, t, u, t),
               "adam": (g, t, v, u, t, v)}[kind]
        table, _ = TF.leaf_table([[x.data_ptr() for x in ts] for ts in ops],
                                 [x.numel() for x in g], TF.capacity(kind))
        fn = getattr(TF._kernels(), f"hvd_{kind}_multi")
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            if fn(0, table.ctypes.data, len(table), TF._CHUNK, 0, 1.0,
                  *consts[kind], stream):
                raise AssertionError(f"hvd_{kind}_multi failed")
        return launch

    out = {}
    for kind in kinds:
        kern, per_leaf, plain = calls[kind]
        lib, label, same = library[kind]
        one = {"sgd": lambda: TF.sgd_update(flat, 1, -0.1, out=flat_u),
               "momentum": lambda: TF.momentum_update(
                   flat, flat_t, 1, 0.9, -0.1, out=flat_u, t_out=flat_t),
               "adam": lambda: TF.adam_update(
                   flat, flat_t, flat_v, bc1, bc2, 1, spec, out=flat_u,
                   mu_out=flat_t, nu_out=flat_v)}[kind]
        TF.reset_launch_counts()
        kern()
        torch.cuda.synchronize()
        t_ = out[kind] = {"launches_per_sweep": TF.LAUNCHES[kind]}
        # kernel, plain, kernel, plain: the two measured in turns
        t_["ms"] = cuda_ms(kern)
        t_["plain_ms"] = cuda_ms(plain, reps=5)
        t_["ms_again"] = cuda_ms(kern)
        t_["plain_ms_again"] = cuda_ms(plain, reps=5)
        t_["ms_per_leaf"] = cuda_ms(per_leaf)
        t_["ms_one_buffer"] = cuda_ms(one)
        t_["ms_kernel"] = cuda_ms(kernel_only(kind))
        t_["host_ms"] = host_ms(torch, kern)
        t_["host_ms_per_leaf"] = host_ms(torch, per_leaf)
        lib_ms = cuda_ms(lib)
        t_["library_ms" if same else "nearest_library_ms"] = lib_ms
        t_["library" if same else "nearest_library"] = label
        if not same:
            t_["library_ms"] = None
        extra = ""
        if kind == "sgd":
            t_["torch_mul_ms"] = cuda_ms(
                lambda: [torch.mul(a, -0.1, out=o) for a, o in zip(g, u)])
            extra = f"; torch.mul leaf by leaf {t_['torch_mul_ms']:.4f} ms"
        bytes_ = BYTES_PER_EL[kind] * n_el
        flops = FLOPS_PER_EL[kind] * n_el
        t_bytes, t_ops = bytes_ / MEM_BW * 1e3, flops / F32_PEAK * 1e3
        t_["bound_ms"] = max(t_bytes, t_ops)
        t_["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[timing] {kind} over {len(shapes)} leaves ({n_el} f32) in "
            f"{t_['launches_per_sweep']} launch(es): {t_['ms']:.4f} / "
            f"{t_['ms_again']:.4f} ms ({t_['bound_ms'] / t_['ms']:.3f} of "
            f"bound), host time {t_['host_ms']:.4f} ms; plain "
            f"{t_['plain_ms']:.4f} / {t_['plain_ms_again']:.4f} ms; one "
            f"launch per leaf {t_['ms_per_leaf']:.4f} ms (host "
            f"{t_['host_ms_per_leaf']:.4f} ms); the launch alone, its "
            f"table built once, {t_['ms_kernel']:.4f} ms "
            f"({t_['bound_ms'] / t_['ms_kernel']:.3f} of bound); one "
            f"{n_el}-element launch "
            f"{t_['ms_one_buffer']:.4f} ms; bound {t_['bound_ms']:.4f} ms "
            f"({t_['bound_by']}); {label}: {lib_ms:.4f} ms{extra}")
    return out


def small_reference(hvd, torch) -> None:
    """Phase 4: a small ResNet trained 3 steps on the card (fused tail)
    and on the CPU (plain optimizer) from the same weights and batch."""
    from horovod_tpu_torch.models.layers import BatchNorm
    from horovod_tpu_torch.models.resnet import BottleneckBlock, ResNet
    from horovod_tpu_torch.ops import batch_norm as BN
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    torch.backends.cudnn.allow_tf32 = False
    try:
        kw = dict(stage_sizes=[1, 1, 1, 1], block_cls=BottleneckBlock,
                  num_classes=10, num_filters=8, dtype=torch.float32,
                  seed=7)
        mg, mc = ResNet(device="cuda", **kw), ResNet(device="cpu", **kw)
        og = hvd.DistributedOptimizer(TF.sgd(mg.parameters(), 0.1, 0.9))
        oc = TF.sgd(mc.parameters(), 0.1, 0.9)
        xg, yg = synthetic_batch(8, 32, 10, seed=3, device="cuda")
        xc, yc = synthetic_batch(8, 32, 10, seed=3, device="cpu")
        n_bn = sum(isinstance(m, BatchNorm) for m in mg.modules())
        BN.reset_launch_counts()
        for step in range(3):
            lg = float(train_step(mg, og, xg, yg))
            lc = float(train_step(mc, oc, xc, yc))
            if not math.isclose(lg, lc, rel_tol=1e-4, abs_tol=1e-5):
                raise AssertionError(
                    f"small reference step {step}: card loss {lg} vs CPU {lc}")
        worst = 0.0
        for (name, a), b in zip(mg.state_dict().items(),
                                mc.state_dict().values()):
            a, b = a.cpu(), b
            err = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
            worst = max(worst, err)
            if err > 1e-3:
                raise AssertionError(
                    f"small reference: {name} differs by {err} of its scale")
        if BN.LAUNCHES != dict.fromkeys(BN_KERNELS, 3 * n_bn):
            raise AssertionError(f"small ResNet: BatchNorm launches "
                                 f"{BN.LAUNCHES}, expected {3 * n_bn} each")
        log(f"[reference] small ResNet, 3 steps: card and CPU agree "
            f"(last loss {lg:.6f} vs {lc:.6f}; worst weight error "
            f"{worst:.2e} of scale; tolerance rel 1e-4 loss, 1e-3 weights); "
            f"N1-N4 launched {BN.LAUNCHES}")
    finally:
        torch.backends.cudnn.allow_tf32 = True


def main_path(hvd, torch, steps: int, batch: int, gpu: str,
              profile: str | None = None) -> dict:
    """Phase 5: ResNet-50 training steps through the public entry points."""
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import batch_norm as BN
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0)
    opt = hvd.DistributedOptimizer(
        hvd.fused_update.sgd(model.parameters(), 0.1, momentum=0.9))
    if not TF.active():
        raise AssertionError("the fused tail is not active")
    images, labels = synthetic_batch(batch, 224, 1000, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    TF.reset_launch_counts()
    BN.reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = train_step(model, opt, images, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = {**TF.LAUNCHES, **BN.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    # one launch per step over the 161 float32 leaves (one dtype group),
    # or as many as the launch's parameter table splits them into
    want = -(-161 // TF.capacity("momentum")) * steps
    if launches["momentum"] != want:
        raise AssertionError(
            f"momentum kernel launched {launches['momentum']} times in "
            f"{steps} steps, expected {want}")
    if BN.LAUNCHES != dict.fromkeys(BN_KERNELS, RESNET50_BN * steps):
        raise AssertionError(f"BatchNorm kernels launched {BN.LAUNCHES} "
                             f"times in {steps} steps, expected "
                             f"{RESNET50_BN * steps} each")
    steady = times[1:] or times
    step_s = sum(steady) / len(steady)
    med = statistics.median(steady)
    log(f"[main] ResNet-50 224x224 batch {batch} bf16, fused momentum SGD,"
        f" {steps} steps on {gpu}: losses {losses}")
    log(f"[main] step times (s) {times}; steady step mean {step_s:.4f} s = "
        f"{batch / step_s:.1f} img/s, median {med:.4f} s = "
        f"{batch / med:.1f} img/s; peak memory "
        f"{peak / 2**30:.2f} GiB; kernel launches {launches}; on {gpu}")
    if profile:
        profile_steps(torch, lambda: train_step(model, opt, images, labels),
                      step_s, profile, RESNET_CLASSES, "resnet50")
    return {"launches": launches, "losses": losses, "step_s": step_s,
            "median_s": med, "peak_bytes": peak, "model": model}


def sgd_path(hvd, torch, gpu: str) -> dict:
    """Phase 6b: B2 on a path: the main path's ResNet-50 (a new model,
    seed 1) trained ``SGD_STEPS`` steps with plain SGD,
    ``DistributedOptimizer(fused_update.sgd(0.1))`` under
    ``HOROVOD_FUSED_UPDATE=1``: every loss finite, one B2 launch per step
    (the 161 float32 leaves are one dtype group) and no B1 launch."""
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=1)
    opt = hvd.DistributedOptimizer(
        hvd.fused_update.sgd(model.parameters(), 0.1))
    if not TF.active():
        raise AssertionError("the fused tail is not active")
    images, labels = synthetic_batch(BATCH, 224, 1000, seed=0)
    torch.cuda.synchronize()
    losses, times = [], []
    TF.reset_launch_counts()
    for _ in range(SGD_STEPS):
        t0 = time.perf_counter()
        loss = train_step(model, opt, images, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = dict(TF.LAUNCHES)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"plain SGD: non-finite loss: {losses}")
    want = {"sgd": SGD_STEPS, "momentum": 0, "adam": 0}
    if launches != want:
        raise AssertionError(f"plain SGD: kernel launches {launches} in "
                             f"{SGD_STEPS} steps, expected {want}")
    log(f"[sgd] ResNet-50 224x224 batch {BATCH} bf16, fused plain SGD, "
        f"{SGD_STEPS} steps on {gpu}: losses {losses}; step times (s) "
        f"{times}; kernel launches {launches}")
    return {"launches": launches, "losses": losses, "times": times}


RESNET_CLASSES = {"batch norm N1-N4": ("reduce_tiles", "finalize<",
                                       "normalize<", "bwd_dx<"),
                  "convolution (cuDNN)": ("xmma", "conv", "gemm", "cudnn",
                                          "implicit", "cutlass"),
                  "fused tail B1": ("momentumop",),
                  "NCCL": ("nccl",)}
LM_CLASSES = {"attention B8 forward": ("flash_fwd",),
              "attention B9 dQ": ("flash_bwd_dq",),
              "attention B10 dK/dV": ("flash_bwd_dkv",),
              "fused tail B3": ("adamop",),
              "matmul (cuBLAS)": ("gemm", "nvjet", "xmma", "cutlass"),
              "NCCL": ("nccl",)}


def profile_steps(torch, step, step_s: float, out: str, classes: dict,
                  tag: str, steps: int = 3) -> None:
    """``--profile``: device kernel time per step of a path by class
    (``torch.profiler``) and the device's busy share of the profiled
    wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
    ka = prof.key_averages()
    # device activity only: CPU-side rows (aten:: ops, and the autograd
    # Function around a ctypes launch) repeat their kernels' time, and
    # "Command Buffer Full" marks the host waiting, not device work
    kern = {e.key: e.self_device_time_total / steps / 1e3 for e in ka
            if e.self_device_time_total > 0
            and e.device_type == DeviceType.CUDA
            and "Command Buffer" not in e.key}
    if not kern:
        raise AssertionError("the profiler recorded no device time")
    totals = dict.fromkeys([*classes, "elementwise and reductions"], 0.0)
    for k, ms in kern.items():
        name = next((c for c, words in classes.items()
                     if any(w in k.lower() for w in words)),
                    "elementwise and reductions")
        totals[name] += ms
    busy = sum(kern.values())
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=60))
        for k, ms in sorted(kern.items(), key=lambda kv: -kv[1]):
            f.write(f"{ms:10.3f} ms/step  {k}\n")
    log(f"[profile {tag}] {steps} profiled steps: wall "
        f"{wall * 1e3:.3f} ms/step (unprofiled {step_s * 1e3:.3f}); "
        f"device kernels {busy:.3f} ms/step, busy share "
        f"{busy / 1e3 / wall:.3f}")
    for name, ms in totals.items():
        log(f"[profile {tag}]   {name}: {ms:.3f} ms/step "
            f"({ms / busy:.3f} of device time)")
    for k, ms in sorted(kern.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile {tag}]   {ms:9.3f} ms/step  {k[:100]}")


def _attn_inputs(torch, shape, dtype, gen):
    """q, k, v and dO of ``shape`` (BH, L, D), standard normal."""
    return [torch.randn(*shape, device="cuda", generator=gen).to(dtype)
            for _ in range(4)]


def _fresh(torch, bh: int, l_: int, d: int):
    return (torch.full((bh, l_), -math.inf, device="cuda"),
            torch.zeros(bh, l_, device="cuda"),
            torch.zeros(bh, l_, d, device="cuda"))


def _lse_delta(state, do):
    """The ring forward's saved lse and the backward's delta for a
    state ``(m, l, o)`` and upstream gradient ``do``."""
    from horovod_tpu_torch.parallel.ring_attention import finish

    out, lse = finish(*state)
    return lse, (do.float() * out).sum(-1)


def _flash_res() -> dict:
    return {k: {"max_abs_err": 0.0, "max_row_err": 0.0} for k in FLASH}


def _hold(FA, torch, res: dict, name: str, got, want, dtype,
          what: str) -> None:
    """Raise unless ``got`` is within the attention tolerance of
    ``want`` and, in bf16, within ``BF16_MAX_ABS`` and ``BF16_ROW_REL``;
    record the largest absolute and row errors under ``name``."""
    rtol, atol = ATTN_TOL[str(dtype)[6:]]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{what}: {m}")
    err, row = FA.errors(got, want)
    r = res[name]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["max_row_err"] = max(r["max_row_err"], row)
    if dtype == torch.bfloat16 and (err > FA.BF16_MAX_ABS
                                    or row > FA.BF16_ROW_REL):
        raise AssertionError(
            f"{what}: largest error {err}, largest row error {row}; bounds "
            f"{FA.BF16_MAX_ABS}, {FA.BF16_ROW_REL}")


def _hold_state(FA, torch, res: dict, got, want, dtype, what: str) -> None:
    """B8's (m, l, o); in bf16 o is held as o / l (see
    ``flash_attention.state_pairs``)."""
    for n, a, b in FA.state_pairs(got, want, dtype == torch.bfloat16):
        _hold(FA, torch, res, "flash_block_step", a, b, dtype, f"{what} {n}")


def _hold_three(FA, torch, res: dict, q, k, v, do, causal: bool,
                what: str) -> None:
    """B8 from a fresh state, then B9 and B10 from the lse and delta of
    the plain B8 state, each against its plain version."""
    dtype = q.dtype
    fresh = _fresh(torch, *q.shape)
    want = FA.flash_block_step_plain(q, k, v, *fresh, 0, 0, causal)
    _hold_state(FA, torch, res, FA.flash_block_step(
        q, k, v, *fresh, 0, 0, causal=causal), want, dtype, f"B8 {what}")
    lse, delta = _lse_delta(want, do)
    del want, fresh
    args = (q, k, v, do, lse, delta, 0, 0)
    _hold(FA, torch, res, "flash_bwd_dq",
          FA.flash_bwd_dq(*args, causal=causal),
          FA.flash_bwd_dq_plain(*args, causal), dtype, f"B9 dq {what}")
    for n, a, b in zip(("dk", "dv"), FA.flash_bwd_dkv(*args, causal=causal),
                       FA.flash_bwd_dkv_plain(*args, causal)):
        _hold(FA, torch, res, "flash_bwd_dkv", a, b, dtype,
              f"B10 {n} {what}")
    torch.cuda.synchronize()


def attention_checks(FA, torch) -> dict:
    """Phase 4a: B8-B10 against their plain versions on the card;
    returns each kernel's largest absolute and row errors."""
    res = _flash_res()
    gen = torch.Generator(device="cuda").manual_seed(2024)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dtype, shape, causals in (
                (torch.bfloat16, ATTN_SHAPE, (True, False)),
                (torch.float32, (8, 256, 64), (True, False))):
            q, k, v, do = _attn_inputs(torch, shape, dtype, gen)
            for causal in causals:
                what = f"{shape} {str(dtype)[6:]} causal={causal}"
                _hold_three(FA, torch, res, q, k, v, do, causal, what)
                log(f"[attention] {what}: B8, B9, B10 agree with their "
                    f"plain versions")
            del q, k, v, do
        # the carried state: two steps over the KV halves, one call
        q, k, v, _ = _attn_inputs(torch, ATTN_SHAPE, torch.bfloat16, gen)
        half = ATTN_SHAPE[1] // 2
        k1, k2 = k[:, :half].contiguous(), k[:, half:].contiguous()
        v1, v2 = v[:, :half].contiguous(), v[:, half:].contiguous()
        st = FA.flash_block_step(q, k1, v1, *_fresh(torch, *ATTN_SHAPE), 0, 0)
        st = FA.flash_block_step(q, k2, v2, *st, 0, half)
        want = FA.flash_block_step_plain(q, k, v, *_fresh(torch, *ATTN_SHAPE),
                                         0, 0, True)
        _hold_state(FA, torch, res, st, want, torch.bfloat16,
                    "B8 two KV halves vs one call")
        # a fully masked block: queries 0..511 against keys 512..1023
        bh, _, d = ATTN_SHAPE
        m, l, o = FA.flash_block_step(q[:, :half].contiguous(), k2, v2,
                                      *_fresh(torch, bh, half, d), 0, half)
        if not (torch.isneginf(m).all() and not l.any() and not o.any()):
            raise AssertionError("B8 on a fully masked block changed the "
                                 "fresh state")
        torch.cuda.synchronize()
        log(f"[attention] {ATTN_SHAPE} bf16: the carried state over two KV "
            f"halves agrees with one call; a fully masked block keeps m = "
            f"-inf, l = 0; largest errors {res} (bf16 B8 o as o / l); "
            f"tolerance rtol/atol {ATTN_TOL}, bf16 also largest error "
            f"{FA.BF16_MAX_ABS} and row error {FA.BF16_ROW_REL}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return res


def attention_costs(shape, itemsize: int) -> dict:
    """(bytes, float operations) each kernel must move and do at
    ``shape`` (BH, L, D), causal: every input read once, every output
    written once; products over the (q, k) pairs the mask leaves."""
    bh, l_, d = shape
    el, rows = bh * l_ * d, bh * l_
    pairs = bh * l_ * (l_ + 1) // 2
    return {
        # q, k, v; m, l, o in and out
        "flash_block_step": (3 * el * itemsize + 2 * (2 * rows + el) * 4,
                             4 * pairs * d),
        # q, k, v, dO, lse, delta in; dQ out
        "flash_bwd_dq": (4 * el * itemsize + 2 * rows * 4 + el * 4,
                         6 * pairs * d),
        # the same in; dK, dV out
        "flash_bwd_dkv": (4 * el * itemsize + 2 * rows * 4 + 2 * el * 4,
                          8 * pairs * d),
    }


def attention_timings(FA, torch, shape, batch: int,
                      plain: bool) -> dict:
    """Phase 4b: B8-B10 at ``shape`` (bf16, causal), each beside its
    bound, ``scaled_dot_product_attention`` on the same inputs (forward
    for B8, its backward for B9 and B10 together; SDPA returns the
    normalised output where B8 returns the carried state) and, with
    ``plain``, its plain version."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(7)
    bh, l_, d = shape
    q, k, v, do = _attn_inputs(torch, shape, torch.bfloat16, gen)
    fresh = _fresh(torch, *shape)
    lse, delta = _lse_delta(FA.flash_block_step(q, k, v, *fresh, 0, 0), do)
    args = (q, k, v, do, lse, delta, 0, 0)
    calls = {
        "flash_block_step": (
            lambda: FA.flash_block_step(q, k, v, *fresh, 0, 0),
            lambda: FA.flash_block_step_plain(q, k, v, *fresh, 0, 0, True)),
        "flash_bwd_dq": (lambda: FA.flash_bwd_dq(*args),
                         lambda: FA.flash_bwd_dq_plain(*args, True)),
        "flash_bwd_dkv": (lambda: FA.flash_bwd_dkv(*args),
                          lambda: FA.flash_bwd_dkv_plain(*args, True)),
    }
    h = bh // batch
    q4, k4, v4, do4 = (x.view(batch, h, l_, d) for x in (q, k, v, do))
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q4, k4, v4))
    out4 = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib = {
        "fwd": cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True)),
        "bwd": cuda_ms(lambda: torch.autograd.grad(
            out4, (qg, kg, vg), do4, retain_graph=True)),
    }
    costs = attention_costs(shape, 2)
    out = {}
    for name, (kern, plain_fn) in calls.items():
        t = {"ms": cuda_ms(kern)}
        if plain:
            t["plain_ms"] = cuda_ms(plain_fn, reps=3)
        t["ms_again"] = cuda_ms(kern)
        if plain:
            t["plain_ms_again"] = cuda_ms(plain_fn, reps=3)
        bytes_, flops = costs[name]
        t_bytes, t_ops = bytes_ / MEM_BW * 1e3, flops / BF16_PEAK * 1e3
        t["bound_ms"] = max(t_bytes, t_ops)
        t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        fwd = name == "flash_block_step"
        t["library_ms"] = lib["fwd" if fwd else "bwd"]
        t["library"] = ("F.scaled_dot_product_attention(is_causal=True) "
                        + ("forward" if fwd else
                           "backward, dQ dK dV together"))
        t["bytes"], t["flops"] = bytes_, flops
        t["tflops"] = flops / t["ms"] / 1e9
        out[name] = t
        plain_txt = (f"plain {t['plain_ms']:.4f} / {t['plain_ms_again']:.4f}"
                     f" ms; " if plain else "")
        log(f"[timing] {name} {shape} bf16 causal: kernel "
            f"{t['ms']:.4f} / {t['ms_again']:.4f} ms "
            f"({t['tflops']:.1f} TFLOP/s, "
            f"{t['bound_ms'] / t['ms']:.4f} of bound), {plain_txt}bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {bytes_} B, "
            f"{flops} FLOP); library {t['library_ms']:.4f} ms "
            f"({t['library']}; kernel / library "
            f"{t['ms'] / t['library_ms']:.3f})")
    # the fairer pair: SDPA's backward computes dQ, dK and dV together
    both = cuda_ms(lambda: (FA.flash_bwd_dq(*args), FA.flash_bwd_dkv(*args)))
    out["flash_bwd_dq"]["ms_with_dkv"] = both
    flops = costs["flash_bwd_dq"][1] + costs["flash_bwd_dkv"][1]
    log(f"[timing] flash_bwd_dq + flash_bwd_dkv {shape} bf16 causal: "
        f"{both:.4f} ms ({flops / both / 1e9:.1f} TFLOP/s); SDPA backward "
        f"{lib['bwd']:.4f} ms (kernels / library {both / lib['bwd']:.3f})")
    del q, k, v, do, fresh, lse, delta, qg, kg, vg, out4
    torch.cuda.empty_cache()
    return out


def tc_build_report(FA) -> dict:
    """Registers, local memory (stack and spills) and shared memory of
    the bf16 tensor-core kernels at D <= 64 and D = 128; returns those at
    the paths' head dim per wrapper name."""
    out = {}
    for name in TC_KERNELS:
        for d in (64, 128):
            a = FA.tc_kernel_attributes(name, d)
            log(f"[build] {name} bf16 kernel at D <= {d}: {a['registers']} "
                f"registers, {a['local_bytes']} B local memory per thread, "
                f"{a['smem_bytes']} B dynamic shared memory")
            if d == LM["head_dim"]:
                out[name] = a
    return out


def lm_shapes(seq: int) -> list:
    """The transformer's parameter shapes, in ``parameters()`` order."""
    dm, ff = LM["d_model"], LM["d_ff"]
    hd = LM["n_heads"] * LM["head_dim"]
    layer = [(dm, 3 * hd), (hd, dm), (dm, ff), (ff, dm), (dm,), (dm,)]
    return ([(LM["vocab"], dm), (seq, dm), (dm,)]
            + layer * LM["n_layers"])


def small_lm_reference(hvd, torch) -> None:
    """Phase 5b: a small transformer (f32, TF32 off) trained 3 steps on
    the card (B8-B10, fused Adam B3) and on the CPU (plain versions) from
    the same weights and batch."""
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import lm_train_step, synthetic_tokens

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = TransformerConfig(vocab=256, d_model=64, n_heads=4,
                                head_dim=16, n_layers=2, d_ff=256,
                                max_seq=128, dtype="float32")
        mg = Transformer(cfg, seed=3, device="cuda")
        mc = Transformer(cfg, seed=3, device="cpu")
        og = hvd.DistributedOptimizer(TF.adam(mg.parameters(), 3e-4))
        oc = TF.adam(mc.parameters(), 3e-4)
        xg, yg = synthetic_tokens(2, 128, cfg.vocab, seed=5, device="cuda")
        xc, yc = synthetic_tokens(2, 128, cfg.vocab, seed=5, device="cpu")
        for step in range(3):
            lg = float(lm_train_step(mg, og, xg, yg))
            lc = float(lm_train_step(mc, oc, xc, yc))
            if not math.isclose(lg, lc, rel_tol=1e-4):
                raise AssertionError(
                    f"small transformer step {step}: card loss {lg} vs CPU "
                    f"{lc}")
        worst = 0.0
        for (name, a), b in zip(mg.state_dict().items(),
                                mc.state_dict().values()):
            err = float((a.cpu() - b).abs().max()) / max(
                float(b.abs().max()), 1e-30)
            worst = max(worst, err)
            if err > 1e-3:
                raise AssertionError(
                    f"small transformer: {name} differs by {err} of its "
                    "scale")
        log(f"[reference] small transformer, 3 steps: card and CPU agree "
            f"(last loss {lg:.6f} vs {lc:.6f}; worst weight error "
            f"{worst:.2e} of scale; tolerance rel 1e-4 loss, 1e-3 weights)")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def lm_path(hvd, torch, seq: int, batch: int, steps: int, gpu: str,
            tag: str, profile: str | None = None,
            zero_stage: int = 0) -> dict:
    """Phases 7, 8 and 14c: the transformer LM trained through the public
    entry points at the bench's widths (seed 0 weights, seed 1 tokens),
    at ZeRO stage ``zero_stage``."""
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import lm_train_step, synthetic_tokens

    cfg = TransformerConfig(**LM, max_seq=seq)
    model = Transformer(cfg, seed=0)
    opt = hvd.DistributedOptimizer(
        hvd.fused_update.adam(model.parameters(), 3e-4),
        zero_stage=zero_stage)
    if not TF.active():
        raise AssertionError("the fused tail is not active")
    tokens, targets = synthetic_tokens(batch, seq, cfg.vocab, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    FA.reset_launch_counts()
    TF.reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = lm_train_step(model, opt, tokens, targets)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = {**FA.LAUNCHES, "adam": TF.LAUNCHES["adam"]}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    want = {k: cfg.n_layers * steps for k in FA.LAUNCHES}
    want["adam"] = -(-LM_LEAVES // TF.capacity("adam")) * steps
    if launches != want:
        raise AssertionError(
            f"{tag}: kernel launches {launches} in {steps} steps, expected "
            f"{want}")
    steady = times[1:] or times
    step_s = sum(steady) / len(steady)
    med = statistics.median(steady)
    log(f"[{tag}] transformer d{cfg.d_model} L{cfg.n_layers} "
        f"h{cfg.n_heads}x{cfg.head_dim} seq {seq} batch {batch} bf16, "
        f"fused Adam, {steps} steps on {gpu}: losses {losses}")
    log(f"[{tag}] step times (s) {times}; steady step mean {step_s:.4f} s ="
        f" {batch * seq / step_s:.1f} tokens/s, median {med:.4f} s = "
        f"{batch * seq / med:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB ({peak} B); kernel launches {launches}; "
        f"on {gpu}")
    if profile:
        stem, ext = os.path.splitext(profile)
        profile_steps(torch, lambda: lm_train_step(model, opt, tokens,
                                                   targets),
                      step_s, f"{stem}_{tag}{ext}", LM_CLASSES, tag)
    return {"launches": launches, "losses": losses, "step_s": step_s,
            "median_s": med, "peak_bytes": peak,
            "state_bytes": opt.state_bytes()}


def long_context(hvd, torch, FA, gpu: str, profile: str | None) -> dict:
    """Phase 8: the long-context config, its peak memory under the
    O(L^2) limits, then B8, B9 and B10 against their plain versions at
    its attention shape; returns each kernel's largest error there."""
    path = lm_path(hvd, torch, LONG_SEQ, LONG_BATCH, LONG_STEPS, gpu, "long",
                   profile)
    peak = path["peak_bytes"]
    for limit, what in ((LONG_MEM_LIMIT, "one f32 score block per layer"),
                        (LONG_MEM_TIGHT, "the measured O(L) peak plus one "
                                         "layer's f32 score block")):
        if peak >= limit:
            raise AssertionError(f"long context: peak memory {peak} B is "
                                 f"not below {limit} B, {what}")
    torch.cuda.empty_cache()
    shape = LONG_ATTN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(11)
    res = _flash_res()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        q, k, v, do = _attn_inputs(torch, shape, torch.bfloat16, gen)
        _hold_three(FA, torch, res, q, k, v, do, True,
                    f"{shape} bf16 causal")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    del q, k, v, do
    torch.cuda.empty_cache()
    log(f"[long] peak memory {peak} B < {LONG_MEM_TIGHT} B < "
        f"{LONG_MEM_LIMIT} B; B8, B9, B10 at {shape} bf16 causal agree with "
        f"their plain versions (largest errors {res}; B8 o as o / l)")
    return res


def _hold_bits(res: dict, name: str, got, want, what: str) -> None:
    """Raise unless ``got`` equals ``want`` bit for bit; record the
    largest absolute difference (0.0 when they agree)."""
    err = float((got.float() - want.float()).abs().max().item()) \
        if got.numel() else 0.0
    res[name] = max(res[name], err)
    if got.dtype != want.dtype or not got.equal(want):
        bad = int((got != want).sum().item()) if got.shape == want.shape \
            else got.numel()
        raise AssertionError(f"{name} {what}: {bad} elements differ from "
                             f"the plain version (max abs {err})")


def _tie_blocks(torch, x2d, gen):
    """Block 0: exact .5 ties under a power-of-two scale (set by
    :func:`_tie_scales`); block 1: all zero."""
    k = torch.randint(-31, 31, (x2d.shape[1],), device="cuda", generator=gen)
    x2d[0] = (k.float() + 0.5) * 0.125
    x2d[1] = 0.0


def _tie_scales(s):
    s[0] = 0.125
    return s


def _emulated_wire(Q, torch, res, xs, qmax: int, int4: bool, what: str):
    """An n-rank reduction of the rows ``xs`` (list of (nb, block)
    float32) with only the transport emulated: shared scales (max over
    the ranks), each rank's payload, their int8 sum (checked against the
    int64 sum: no wrap), the sum and each residual dequantized; every
    kernel output held against its plain version.  Returns ``(sum,
    scales)``."""
    enc, dec = ((Q.quantize_pack4_values, Q.unpack_dequantize4_values)
                if int4 else (Q.quantize_values, Q.dequantize_values))
    enc_p, dec_p = ((Q.quantize_pack4_plain, Q.unpack_dequantize4_plain)
                    if int4 else (Q.quantize_plain, Q.dequantize_plain))
    ek, dk = ("pack4", "unpack4") if int4 else ("quantize", "dequantize")
    shared = torch.stack([Q.block_absmax(x) for x in xs]).amax(0)
    s = Q._scales(shared, qmax)
    qs = []
    for r, x in enumerate(xs):
        q = enc(x, s, qmax)
        _hold_bits(res, ek, q, enc_p(x, s, qmax), f"{what} rank {r}")
        _hold_bits(res, dk, dec(q, s), dec_p(q, s),
                   f"{what} rank {r} residual")
        qs.append(q)
    stack = torch.stack(qs)
    qsum = stack.sum(0, dtype=torch.int8)
    if not qsum.long().equal(stack.long().sum(0)):
        raise AssertionError(f"{what}: the int8 sum wrapped")
    out = dec(qsum, s)
    _hold_bits(res, dk, out, dec_p(qsum, s), f"{what} sum")
    torch.cuda.synchronize()
    return out, s


def codec_checks(Q, torch) -> dict:
    """Phase 9a: B4-B7 against their plain versions on the card at the
    fused gradient buffer of both paths; returns each kernel's largest
    absolute difference."""
    res = dict.fromkeys(CODECS, 0.0)
    gen = torch.Generator(device="cuda").manual_seed(4242)
    for name, n_el in CODEC_BUFFERS.items():
        x2d, _ = Q._to_blocks(torch.randn(n_el, device="cuda",
                                          generator=gen), QBLOCK)
        _tie_blocks(torch, x2d, gen)
        absmax = Q.block_absmax(x2d)
        what = f"{name} {tuple(x2d.shape)}"
        for qmax in (127, 63, 31):
            s = _tie_scales(Q._scales(absmax, qmax))
            q = Q.quantize_values(x2d, s, qmax)
            _hold_bits(res, "quantize", q, Q.quantize_plain(x2d, s, qmax),
                       f"{what} qmax {qmax}")
            _hold_bits(res, "dequantize", Q.dequantize_values(q, s),
                       Q.dequantize_plain(q, s), f"{what} qmax {qmax}")
            del q
        for qmax in (7, 3, 1):
            s = _tie_scales(Q._scales(absmax, qmax))
            p = Q.quantize_pack4_values(x2d, s, qmax)
            _hold_bits(res, "pack4", p, Q.quantize_pack4_plain(x2d, s, qmax),
                       f"{what} qmax {qmax}")
            _hold_bits(res, "unpack4", Q.unpack_dequantize4_values(p, s),
                       Q.unpack_dequantize4_plain(p, s), f"{what} qmax {qmax}")
            del p
        # four payloads summed on an int8 wire: B5 on the sum (and on the
        # same sums held as int32), B7 on summed packed bytes
        xs = [x2d] + [torch.randn(x2d.shape, device="cuda", generator=gen)
                      for _ in range(3)]
        _emulated_wire(Q, torch, res, xs, 31, False, f"{what} 4 payloads")
        qsum = torch.stack([Q.quantize_values(x, Q._scales(absmax, 31), 31)
                            for x in xs]).sum(0, dtype=torch.int32)
        s = Q._scales(absmax, 31)
        _hold_bits(res, "dequantize", Q.dequantize_values(qsum, s),
                   Q.dequantize_plain(qsum, s), f"{what} int32 sums")
        del qsum
        _emulated_wire(Q, torch, res, xs, 1, True, f"{what} 4 packed payloads")
        del xs, x2d
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"[codec] {what}: B4, B5 at qmax 127/63/31 and B6, B7 at 7/3/1 "
            "(a .5-tie block, a zero block), B5 on int32 sums and on the "
            "int8 sum of 4 payloads, B7 on summed packed bytes: bit for bit "
            "with their plain versions")
    return res


def half_scale(s, qmax: int):
    """The per-element error bound of one rank's round trip, ``s / 2``,
    widened by the float32 rounding of ``1/s``, ``x * (1/s)`` and ``q *
    s`` (each at most 2**-24 relative, with ``|x/s|, |q| <= qmax``):
    ``s * (1/2 + (3 qmax + 2) 2**-24)``.  A value ``x/s`` within that
    rounding of a .5 tie may round to the farther grid point."""
    return s * (0.5 + (3 * qmax + 2) * 2.0 ** -24)


def codec_path(hvd, Q, torch, model, gpu: str) -> dict:
    """Phase 10: the lossy wire on the ResNet-50 path (one card).
    Returns the launches of B4-B7 in the compressors' round trips and
    each kernel's largest difference from its plain version."""
    from horovod_tpu_torch.train_step import (softmax_cross_entropy,
                                              synthetic_batch)

    grads = [p.grad.detach().clone() for p in model.parameters()]
    if len(grads) != 161 or any(g.dtype != torch.float32 for g in grads):
        raise AssertionError("expected the 161 float32 gradient leaves of "
                             "the main path's backward")
    worst = {"int8": 0.0, "int4": 0.0}
    Q.reset_launch_counts()
    for g in grads:
        for mode, qmax in (("int8", 127), ("int4", 7)):
            comp = hvd.Compression.lookup(mode)
            wire, ctx = comp.compress(g)
            back = comp.decompress(wire, ctx)
            err2d, _ = Q._to_blocks(back - g, ctx.block)
            ratio = float((err2d.abs() / (wire[1][:, None] / 2)
                           .clamp_min(1e-30)).max())
            worst[mode] = max(worst[mode], ratio)
            if not bool((err2d.abs() <= half_scale(wire[1], qmax)[:, None])
                        .all().item()):
                raise AssertionError(
                    f"{mode} round trip of a {tuple(g.shape)} leaf: error "
                    f"{ratio} of scale / 2, beyond its float32 rounding")
    torch.cuda.synchronize()
    launches = dict(Q.LAUNCHES)
    if launches != dict.fromkeys(CODECS, 161):
        raise AssertionError(f"codec launches {launches}, expected 161 each")
    log(f"[wire] 161 ResNet-50 gradient leaves through Compression.int8 and "
        f"Compression.int4: launches {launches}; largest error / (scale/2) "
        f"{worst}")

    # a 4-rank reduction at the fused-buffer width: four batch shards of
    # 64 images, one backward each; only the transport is emulated
    res = dict.fromkeys(CODECS, 0.0)
    xs = []
    for r in range(4):
        images, labels = synthetic_batch(64, 224, 1000, seed=100 + r)
        model.zero_grad(set_to_none=True)
        softmax_cross_entropy(model(images), labels).backward()
        flat = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
        xs.append(Q._to_blocks(flat, QBLOCK)[0])
        del images, labels, flat
    model.zero_grad(set_to_none=True)
    exact = torch.stack(xs).double().sum(0)
    for qmax, int4 in ((31, False), (1, True)):
        what = f"4-rank {'int4' if int4 else 'int8'} qmax {qmax}"
        out, s = _emulated_wire(Q, torch, res, xs, qmax, int4, what)
        bound = 4 * half_scale(s.double(), qmax)[:, None]
        excess = float(((out.double() - exact).abs() - bound).max())
        if excess > 0:
            raise AssertionError(f"{what}: beyond n * scale / 2 of the float "
                                 f"sum by {excess}")
        log(f"[wire] {what} over 4 gradient buffers of {N_PARAMS} float32 "
            f"({tuple(out.shape)} blocks; only the transport is emulated, "
            f"the four ranks' payloads summed on this card): kernels bit for "
            f"bit with the plain pipeline, the sum within n * scale / 2 of "
            f"the float sum; on {gpu}")
    del xs, exact
    torch.cuda.empty_cache()
    return {"launches": launches, "errs": res}


def codec_timings(Q, torch) -> dict:
    """Phase 9b: B4-B7 at both fused-buffer shapes, each twice beside its
    plain version, its memory bound and (B5) ``torch.mul``."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for name, n_el in CODEC_BUFFERS.items():
        x2d, _ = Q._to_blocks(torch.randn(n_el, device="cuda", generator=gen),
                              QBLOCK)
        nb = x2d.shape[0]
        s = Q._scales(Q.block_absmax(x2d), 127)
        q = Q.quantize_values(x2d, s, 127)
        p = Q.quantize_pack4_values(x2d, s, 7)
        calls = {
            "quantize": (lambda: Q.quantize_values(x2d, s, 127),
                         lambda: Q.quantize_plain(x2d, s, 127), None),
            "dequantize": (lambda: Q.dequantize_values(q, s),
                           lambda: Q.dequantize_plain(q, s),
                           lambda: torch.mul(q, s[:, None])),
            "pack4": (lambda: Q.quantize_pack4_values(x2d, s, 7),
                      lambda: Q.quantize_pack4_plain(x2d, s, 7), None),
            "unpack4": (lambda: Q.unpack_dequantize4_values(p, s),
                        lambda: Q.unpack_dequantize4_plain(p, s), None),
        }
        for kind, (kern, plain, lib) in calls.items():
            t = {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, reps=5)}
            t["ms_again"] = cuda_ms(kern)
            t["plain_ms_again"] = cuda_ms(plain, reps=5)
            t["library_ms"] = cuda_ms(lib) if lib else None
            bytes_ = CODEC_BYTES[kind] * nb * QBLOCK + 4 * nb
            flops = CODEC_FLOPS[kind] * nb * QBLOCK
            t_bytes, t_ops = bytes_ / MEM_BW * 1e3, flops / F32_PEAK * 1e3
            t["bound_ms"] = max(t_bytes, t_ops)
            t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            t["bytes"] = bytes_
            out.setdefault(kind, {})[name] = t
            log(f"[timing] {kind} {name} ({nb}, {QBLOCK}): kernel "
                f"{t['ms']:.4f} / {t['ms_again']:.4f} ms "
                f"({bytes_ / t['ms'] / 1e9:.3f} TB/s, "
                f"{t['bound_ms'] / t['ms']:.3f} of bound), plain "
                f"{t['plain_ms']:.4f} / {t['plain_ms_again']:.4f} ms; bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {bytes_:.0f} B); "
                f"library {t['library_ms']}")
        del x2d, q, p
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# BatchNorm N1-N4 (phase 11) and the CNN paths (phases 12-13)
# ---------------------------------------------------------------------------

# the paths' BatchNorm activations as (rows, channels), bench sizes
BN_SHAPES = {
    "ResNet-50 bn_init": (256 * 112 * 112, 64),
    "ResNet-50 last stage": (256 * 7 * 7, 2048),
    "Inception-v3 ConvBN_0": (128 * 149 * 149, 32),
    "Inception-v3 MixedA 5x5 branch": (128 * 35 * 35, 48),
    "Inception-v3 MixedC 448": (128 * 8 * 8, 448),
}
# the shapes the kernels are timed at (bf16): the largest of each path
BN_TIMED = ("ResNet-50 bn_init", "Inception-v3 ConvBN_0")
BN_KERNELS = ("bn_stats", "bn_normalize", "bn_bwd_reduce", "bn_bwd_dx")
BN_REPLACES = ("flax.linen.BatchNorm under XLA (no Pallas kernel): "
               "horovod_tpu/models/resnet.py:83-84, "
               "horovod_tpu/models/inception.py:33-34")
# activation passes (x, dy read; y, dx written), per-channel float32
# vectors moved, and float32 operations per element of each kernel
BN_COST = {"bn_stats": (1, 7, 3), "bn_normalize": (2, 4, 3),
           "bn_bwd_reduce": (2, 4, 5), "bn_bwd_dx": (3, 5, 7)}
# outputs y and dx: within one ulp of the plain version's, or within
# this share of the tensor's largest magnitude
BN_ACT_TOL = {"torch.bfloat16": 2.0 ** -8, "torch.float32": 2.0 ** -20}
# the cancelling cases (bn_case): var within twice the plain version's
# error plus this many float32 ulps of E[x^2].  The float32 fast form
# rounds mean, mean^2 and E[x^2] once each; the mean's half ulp moves
# mean^2 by about one ulp of E[x^2], so its own error is about 2 ulps
BN_CANCEL_ULPS = 4
# the shapes of the cancelling cases: the longest reduction, and a C off
# the powers of two
BN_CANCEL_SHAPES = ("ResNet-50 bn_init", "Inception-v3 MixedA 5x5 branch")
# N2-N4's one-call library functions (bn_timings)
BN_LIBRARY = {
    "bn_normalize": "torch.batch_norm_elemt on the channels-last NCHW view",
    "bn_bwd_reduce": "torch.batch_norm_backward_reduce(input_g=False) on "
                     "the channels-last NCHW view: grad_weight and grad_bias",
    "bn_bwd_dx": "torch.batch_norm_backward_elemt on the channels-last NCHW "
                 "view, with sum_dy_xmu = dscale / rstd",
}
# the bench's CNN paths (bench.py:1877-1880): side, batch, BatchNorms
CNN_STEPS = 5
CNN = {"vgg16": (224, 128, 0), "inception3": (299, 128, 94)}
RESNET50_BN = 53
# Inception-v3's card gradients (inception_reference): the relative L2
# error against float64 of the whole gradient and of each leaf at most
# twice the CPU float32 run's plus this
INCEPTION_GRAD_FLOOR = 1e-3
VGG16_LEAVES = 32


def _bn_res() -> dict:
    res = {k: {"max_abs_err": 0.0, "max_ulp": 0, "max_err_f64": 0.0,
               "plain_err_f64": 0.0, "chain_max_abs_err": 0.0,
               "chain_max_ulp": 0} for k in BN_KERNELS}
    # the cancelling cases' readings, one entry per case (bn_case)
    res["bn_stats"]["cancel"] = []
    return res


def _hold_stat(res: dict, name: str, what: str, got, plain, ref,
               floor: float | None = None) -> tuple:
    """A float32 statistic or sum: the kernel's error against the float64
    evaluation ``ref`` at most twice the plain version's plus ``floor``,
    by default 1e-6 of the quantity's scale; returns both errors."""
    ref = ref.double()
    k = float((got.double() - ref).abs().max())
    p = float((plain.double() - ref).abs().max())
    scale = float(ref.abs().max())
    if floor is None:
        floor = 1e-6 * scale
    r = res[name]
    r["max_abs_err"] = max(r["max_abs_err"],
                           float((got - plain).abs().max()))
    r["max_err_f64"] = max(r["max_err_f64"], k)
    r["plain_err_f64"] = max(r["plain_err_f64"], p)
    if not k <= 2 * p + floor:
        raise AssertionError(f"{name} {what}: error {k} against float64, "
                             f"plain {p}, floor {floor}, scale {scale}")
    return k, p


def _hold_act(res: dict, name: str, what: str, got, want,
              chain: bool = False) -> None:
    """An output in x's dtype: every element within one ulp of the plain
    version's, or within ``BN_ACT_TOL`` of its largest magnitude.  With
    ``chain`` the plain version ran on the plain statistics (its errors
    are recorded apart: on the same statistics N2 and N4 round as the
    plain versions do)."""
    diff = (got.float() - want.float()).abs()
    tol = BN_ACT_TOL[str(got.dtype)] * float(want.float().abs().max())
    ulps = _ulps(got, want)
    bad = int(((ulps > 1) & (diff > tol)).sum())
    r, pre = res[name], "chain_" if chain else ""
    r[pre + "max_abs_err"] = max(r[pre + "max_abs_err"], float(diff.max()))
    r[pre + "max_ulp"] = max(r[pre + "max_ulp"], int(ulps.max()))
    if bad:
        raise AssertionError(f"{name} {what}: {bad} elements beyond one ulp "
                             f"and {tol} of the plain version")


def _hold_ulp_of(torch, what: str, got, want) -> None:
    """float32 ``got`` within one ulp of ``want``."""
    n = int(_ulps(got, want).max())
    if n > 1:
        raise AssertionError(f"{what}: {n} ulps from {want.tolist()[:8]}")


def _same_bits(name: str, what: str, a, b) -> None:
    for x, y in zip(a, b):
        if not x.equal(y):
            raise AssertionError(f"{name} {what}: two runs on the same "
                                 "input differ")


def bn_case(BN, torch, res: dict, shape, dtype, eps: float,
            momentum: float, train: bool, gen, what: str,
            off_grid: bool = False, cancel: bool = False) -> None:
    """N1-N4 (train) or N2, N3 and N2 as the input gradient (eval) at
    ``shape`` against their plain versions, the float64 evaluation of
    the same expressions and themselves (the same input twice); with
    ``off_grid`` x and dy are views one element off the 16-byte grid
    (the scalar loop).

    With ``cancel`` x is ``1e3 + 1e-2 * randn``: the fast variance
    E[x^2] - E[x]^2 cancels in float32 to the rounding of E[x^2], in the
    kernel and in the plain version alike, so their var (a few float32
    ulps of E[x^2], or 0 by the clamp) and rstd = rsqrt(var + eps) are
    two draws of that noise.  There var and the running variance are
    held to twice the plain version's error plus ``BN_CANCEL_ULPS``
    float32 ulps of E[x^2] (times 1 - momentum for the running one),
    rstd to the kernel's own var (one ulp of the float64
    ``rsqrt(var + eps)``), and the outputs only against the plain
    versions on the kernel's statistics (the chain through the plain
    statistics would compare two draws of the noise); the readings go
    to ``res["bn_stats"]["cancel"]``."""
    m, c = shape
    what = f"{what} {shape} {str(dtype)[6:]} eps {eps} " + (
        f"momentum {momentum} train" if train else "eval") + (
        " off the 16-byte grid" if off_grid else "") + (
        " cancelling variance" if cancel else "")

    def randn(*s):
        return torch.randn(*s, device="cuda", generator=gen)

    if cancel:
        x = (1e3 + 1e-2 * randn(m, c)).to(dtype)
    else:
        x = (randn(m, c) * 1.5 + randn(c)).to(dtype)
    dy = randn(m, c).to(dtype)
    if off_grid:
        x, dy = _off_grid(torch, x), _off_grid(torch, dy)
    scale, bias = 1 + 0.1 * randn(c), 0.1 * randn(c)
    ra0 = (0.1 * randn(c), 1 + 0.1 * randn(c).abs())
    if train:
        ra_k = [t.clone() for t in ra0]
        ra_p = [t.clone() for t in ra0]
        got = BN.bn_stats(x, eps, momentum, *ra_k)
        plain = BN.bn_stats_plain(x, eps, momentum, *ra_p)
        ref = BN.bn_stats_plain(x.double(), eps)
        ref_ra = [momentum * t.double() + (1 - momentum) * s
                  for t, s in zip(ra0, ref[:2])]
        names = ("mean", "var", "rstd", "running mean", "running var")
        floors = dict.fromkeys(names)
        if cancel:
            ex2 = (x.double() ** 2).mean(0).float()
            ulp = float((torch.nextafter(ex2, ex2 + 1) - ex2).max())
            floors["var"] = BN_CANCEL_ULPS * ulp
            floors["running var"] = (BN_CANCEL_ULPS * ulp * (1 - momentum)
                                     + 1e-6 * float(ref_ra[1].abs().max()))
        # the cancelling cases' statistics stay out of the largest errors
        # (their readings are kept apart below)
        sres, errs = _bn_res() if cancel else res, {}
        for n, a, b, r in zip(names, (*got, *ra_k), (*plain, *ra_p),
                              (*ref, *ref_ra)):
            if cancel and n == "rstd":
                _hold_ulp_of(torch, f"bn_stats {what} rstd", a,
                             torch.rsqrt(got[1].double() + eps).float())
                continue
            errs[n] = _hold_stat(sres, "bn_stats", f"{what} {n}", a, b, r,
                                 floors[n])
        if cancel:
            rs = got[2] / plain[2]
            res["bn_stats"]["cancel"].append({
                "case": what, "ulp_ex2": ulp,
                "mean_err": errs["mean"][0], "plain_mean_err": errs["mean"][1],
                "var_err": errs["var"][0], "plain_var_err": errs["var"][1],
                "var_ref_max": float(ref[1].max()),
                "clamped": int((got[1] == 0).sum()),
                "plain_clamped": int((plain[1] == 0).sum()),
                "rstd_over_plain": [float(rs.min()), float(rs.max())]})
        again = [t.clone() for t in ra0]
        _same_bits("bn_stats", what, (*got, *ra_k),
                   (*BN.bn_stats(x, eps, momentum, *again), *again))
        mean, _, rstd = got
        pmean, prstd = plain[0], plain[2]
    else:
        mean = pmean = ra0[0]
        rstd = prstd = torch.rsqrt(ra0[1] + eps)
    # N2 on the same statistics, then the kernels' chain against the
    # plain versions' chain
    chain = not (cancel and train)
    y = BN.bn_normalize(x, mean, rstd, scale, bias)
    _hold_act(res, "bn_normalize", what, y,
              BN.bn_normalize_plain(x, mean, rstd, scale, bias))
    if chain:
        _hold_act(res, "bn_normalize", f"{what} (chain)", y,
                  BN.bn_normalize_plain(x, pmean, prstd, scale, bias), True)
    _same_bits("bn_normalize", what, (y,),
               (BN.bn_normalize(x, mean, rstd, scale, bias),))
    del y
    db, ds = BN.bn_bwd_reduce(dy, x, mean, rstd)
    plain = BN.bn_bwd_reduce_plain(dy, x, mean, rstd)
    ref = BN.bn_bwd_reduce_plain(dy.double(), x.double(), mean.double(),
                                 rstd.double())
    for n, a, b, r in zip(("dbias", "dscale"), (db, ds), plain, ref):
        _hold_stat(res, "bn_bwd_reduce", f"{what} {n}", a, b, r)
    _same_bits("bn_bwd_reduce", what, (db, ds),
               BN.bn_bwd_reduce(dy, x, mean, rstd))
    if train:
        dx = BN.bn_bwd_dx(dy, x, mean, rstd, scale, db, ds)
        _hold_act(res, "bn_bwd_dx", what, dx,
                  BN.bn_bwd_dx_plain(dy, x, mean, rstd, scale, db, ds))
        if chain:
            sums = BN.bn_bwd_reduce_plain(dy, x, pmean, prstd)
            _hold_act(res, "bn_bwd_dx", f"{what} (chain)", dx,
                      BN.bn_bwd_dx_plain(dy, x, pmean, prstd, scale, *sums),
                      True)
        _same_bits("bn_bwd_dx", what, (dx,),
                   (BN.bn_bwd_dx(dy, x, mean, rstd, scale, db, ds),))
        del dx
    else:
        # the eval backward's dx = dy * (rstd * scale), through N2
        zero = torch.zeros_like(mean)
        _hold_act(res, "bn_normalize", f"{what} dx",
                  BN.bn_normalize(dy, zero, rstd, scale, zero),
                  (dy.float() * (rstd * scale)).to(dtype))
    torch.cuda.synchronize()


def bn_checks(BN, torch) -> dict:
    """Phase 11a: N1-N4 at the paths' BatchNorm shapes, bf16 and float32,
    train (eps 1e-5 momentum 0.9 and eps 1e-3 momentum 0.99, by turns)
    and eval; then the cancelling cases at ``BN_CANCEL_SHAPES``; returns
    each kernel's largest errors and the cancelling cases' readings."""
    res = _bn_res()
    gen = torch.Generator(device="cuda").manual_seed(31)
    cases = [(1e-5, 0.9), (1e-3, 0.99), (1e-3, 0.9), (1e-5, 0.99)]
    k = 0
    for what, shape in BN_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            eps, mom = cases[k % len(cases)]
            k += 1
            bn_case(BN, torch, res, shape, dtype, eps, mom, True, gen, what)
            bn_case(BN, torch, res, shape, dtype, eps, mom, False, gen, what)
            torch.cuda.empty_cache()
        log(f"[batch norm] {what} {shape}: N1-N4 train and eval, bf16 and "
            f"float32, agree with their plain versions and the float64 "
            f"evaluation, and repeat bit for bit")
    for what in BN_CANCEL_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for train in (True, False):
                bn_case(BN, torch, res, BN_SHAPES[what], dtype, 1e-5, 0.9,
                        train, gen, what, cancel=True)
            torch.cuda.empty_cache()
    for r in res["bn_stats"]["cancel"]:
        log(f"[batch norm] cancelling variance (x = 1e3 + 1e-2 randn), "
            f"{r['case']}: var error against float64 {r['var_err']:.6g} "
            f"(plain {r['plain_var_err']:.6g}; float64 var at most "
            f"{r['var_ref_max']:.6g}; one float32 ulp of E[x^2] "
            f"{r['ulp_ex2']:.6g}); clamped channels {r['clamped']} (plain "
            f"{r['plain_clamped']}); rstd over the plain version's "
            f"{r['rstd_over_plain']}")
    log(f"[batch norm] largest errors {res}; tolerance: statistics within "
        f"2x the plain version's float64 error + 1e-6 of scale; y and dx "
        f"within 1 ulp or {BN_ACT_TOL} of the largest magnitude")
    return res


def bn_bound(name: str, shape, itemsize: int):
    m, c = shape
    passes, vecs, ops = BN_COST[name]
    t_bytes = (passes * m * c * itemsize + vecs * c * 4) / MEM_BW * 1e3
    t_ops = ops * m * c / F32_PEAK * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bn_timings(BN, torch) -> dict:
    """Phase 11b: N1-N4 at the largest BatchNorm of each path (bf16),
    each twice beside its plain version and its memory bound, and the
    library calls on the channels-last NCHW view.  N2-N4 each have one
    call that computes the same function on the given statistics,
    SyncBatchNorm's building blocks: ``torch.batch_norm_elemt`` (N2),
    ``torch.batch_norm_backward_reduce`` (N3's dbias and dscale) and
    ``torch.batch_norm_backward_elemt`` (N4): their ``library_ms``, and
    their outputs' largest difference from the kernel's as a share of
    its largest magnitude.  N1 has none: ``torch.batch_norm_stats``
    (Welford's variance, no running statistics) is its nearest call.
    The whole layer's cuDNN calls, ``torch.batch_norm`` in training mode
    (N1 and N2's work) and ``aten.native_batch_norm_backward`` (N3 and
    N4's), are timed beside them as ``layer_library_ms``."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    out = {}
    nhwc = {"ResNet-50 bn_init": (256, 112, 112),
            "Inception-v3 ConvBN_0": (128, 149, 149)}
    for what in BN_TIMED:
        m, c = shape = BN_SHAPES[what]
        x = (torch.randn(m, c, device="cuda", generator=gen) + 0.5).to(
            torch.bfloat16)
        dy = torch.randn(m, c, device="cuda", generator=gen).to(x.dtype)
        scale = torch.rand(c, device="cuda", generator=gen) + 0.5
        bias = torch.randn(c, device="cuda", generator=gen)
        ra = [torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")]
        mean, _, rstd = BN.bn_stats(x, 1e-5, 0.9, *ra)
        db, ds = BN.bn_bwd_reduce(dy, x, mean, rstd)
        calls = {
            "bn_stats": (lambda: BN.bn_stats(x, 1e-5, 0.9, *ra),
                         lambda: BN.bn_stats_plain(x, 1e-5, 0.9, *ra)),
            "bn_normalize": (
                lambda: BN.bn_normalize(x, mean, rstd, scale, bias),
                lambda: BN.bn_normalize_plain(x, mean, rstd, scale, bias)),
            "bn_bwd_reduce": (
                lambda: BN.bn_bwd_reduce(dy, x, mean, rstd),
                lambda: BN.bn_bwd_reduce_plain(dy, x, mean, rstd)),
            "bn_bwd_dx": (
                lambda: BN.bn_bwd_dx(dy, x, mean, rstd, scale, db, ds),
                lambda: BN.bn_bwd_dx_plain(dy, x, mean, rstd, scale, db,
                                           ds)),
        }
        n, h, w = nhwc[what]
        x4 = x.view(n, h, w, c).permute(0, 3, 1, 2)
        dy4 = dy.view(n, h, w, c).permute(0, 3, 1, 2)
        rm, rv = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")
        _, save_mean, save_invstd = torch.native_batch_norm(
            x4, scale, bias, rm, rv, True, 0.1, 1e-5)
        count = torch.full((1,), m, dtype=torch.int32, device="cuda")
        sum_dy, sum_dy_xmu, _, _ = torch.batch_norm_backward_reduce(
            dy4, x4, mean, rstd, scale, True, False, False)
        lib_calls = {
            "bn_stats": lambda: torch.batch_norm_stats(x4, 1e-5),
            "bn_normalize": lambda: torch.batch_norm_elemt(
                x4, scale, bias, mean, rstd, 1e-5),
            "bn_bwd_reduce": lambda: torch.batch_norm_backward_reduce(
                dy4, x4, mean, rstd, scale, False, True, True)[2:],
            "bn_bwd_dx": lambda: torch.batch_norm_backward_elemt(
                dy4, x4, mean, rstd, scale, sum_dy, sum_dy_xmu, count),
        }

        def rows(t):  # the channels-last NCHW result as (M, C)
            return t.permute(0, 2, 3, 1).reshape(m, c)

        same = {
            "bn_normalize": ((rows(lib_calls["bn_normalize"]()),),
                             (calls["bn_normalize"][0](),)),
            "bn_bwd_reduce": (lib_calls["bn_bwd_reduce"]()[::-1], (db, ds)),
            "bn_bwd_dx": ((rows(lib_calls["bn_bwd_dx"]()),),
                          (calls["bn_bwd_dx"][0](),)),
        }
        layer = {
            "forward": cuda_ms(lambda: torch.batch_norm(
                x4, scale, bias, rm, rv, True, 0.1, 1e-5, True)),
            "backward": cuda_ms(
                lambda: torch.ops.aten.native_batch_norm_backward(
                    dy4, x4, scale, rm, rv, save_mean, save_invstd, True,
                    1e-5, [True, True, True])),
        }
        for name, (kern, plain) in calls.items():
            t = {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, reps=5)}
            t["ms_again"] = cuda_ms(kern)
            t["plain_ms_again"] = cuda_ms(plain, reps=5)
            t["bound_ms"], t["bound_by"] = bn_bound(name, shape, 2)
            lib_ms = cuda_ms(lib_calls[name])
            if name in same:
                t["library_ms"] = lib_ms
                t["library"] = BN_LIBRARY[name]
                t["library_max_rel_diff"] = max(
                    float((a.float() - b.float()).abs().max()
                          / b.float().abs().max())
                    for a, b in zip(*same[name]))
                lib_txt = (f"library {lib_ms:.4f} ms ({BN_LIBRARY[name]}; "
                           f"largest difference from the kernel "
                           f"{t['library_max_rel_diff']:.3g} of its scale)")
            else:
                t["library_ms"] = None
                t["nearest_library_ms"] = lib_ms
                t["nearest_library"] = (
                    "torch.batch_norm_stats on the channels-last NCHW view: "
                    "nearest library call, not the same function (Welford's "
                    "variance, no running statistics)")
                lib_txt = (f"nearest library call (not the same function) "
                           f"{lib_ms:.4f} ms")
            fwd = name in ("bn_stats", "bn_normalize")
            t["layer_library_ms"] = layer["forward" if fwd else "backward"]
            t["layer_library"] = (
                ("torch.batch_norm(training=True) on the channels-last NCHW "
                 "view, N1 and N2's work in one call" if fwd else
                 "aten.native_batch_norm_backward, N3 and N4's work in one "
                 "call") + ": the whole layer's cuDNN call, not the same "
                "function (cuDNN's variance and its unbiased running "
                "variance)")
            out.setdefault(name, {})[what] = t
            log(f"[timing] {name} {what} {shape} bf16: kernel "
                f"{t['ms']:.4f} / {t['ms_again']:.4f} ms "
                f"({t['bound_ms'] / t['ms']:.3f} of bound), plain "
                f"{t['plain_ms']:.4f} / {t['plain_ms_again']:.4f} ms; bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}); {lib_txt}; the "
                f"whole layer's {'forward' if fwd else 'backward'} (not the "
                f"same function) {t['layer_library_ms']:.4f} ms")
        del x, dy, x4, dy4, save_mean, save_invstd, same
        torch.cuda.empty_cache()
    return out


def vgg16_shapes() -> list:
    """VGG-16's 32 parameter shapes at 224 px and 1000 classes, in
    ``parameters()`` order (the model is not built for them)."""
    from horovod_tpu_torch.models.vgg import _CFG

    widths, ch, shapes = (64, 128, 256, 512, 512), 3, []
    for stage, n_convs in enumerate(_CFG[16]):
        for _ in range(n_convs):
            shapes += [(widths[stage], ch, 3, 3), (widths[stage],)]
            ch = widths[stage]
    shapes += [(4096, 7 * 7 * 512), (4096,), (4096, 4096), (4096,),
               (1000, 4096), (1000,)]
    return shapes


def vgg_momentum_check(TF, torch, shapes) -> dict:
    """Phase 12a: B1 over VGG-16's 32 leaf shapes (102,760,448 elements in
    Dense_0) and an empty leaf in one launch, float32 bit for bit and
    bf16 within 1 ulp of the plain loop."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    res = {"momentum": {"max_abs_err": 0.0, "max_ulp": 0}}
    for dtype in (torch.float32, torch.bfloat16):
        n = multi_check(TF, torch, res, "momentum", list(shapes) + [(0,)],
                        gen, dtype, 1, None)
        if n != 1:
            raise AssertionError(f"B1 over VGG-16's leaves: {n} launches")
        torch.cuda.empty_cache()
    log(f"[kernels] momentum in one launch over VGG-16's {len(shapes)} leaf "
        f"shapes ({sum(math.prod(s) for s in shapes)} elements) and an empty "
        f"leaf: float32 bit for bit, bf16 within 1 ulp (largest "
        f"{res['momentum']['max_ulp']})")
    return res["momentum"]


def _weights_close(mg, mc, tol: float, what: str) -> float:
    """Every tensor of the card model's state within ``tol`` of its
    largest magnitude on the CPU model; returns the worst share."""
    worst = 0.0
    for (name, a), b in zip(mg.state_dict().items(),
                            mc.state_dict().values()):
        err = float((a.cpu() - b).abs().max()) / max(float(b.abs().max()),
                                                     1e-30)
        worst = max(worst, err)
        if err > tol:
            raise AssertionError(f"{what}: {name} differs by {err} of its "
                                 "scale")
    return worst


def small_cnn_reference(hvd, torch) -> None:
    """Phase 5c: SmallCNN at 96 px, batch 2, float32 (TF32 off), trained
    3 steps on the card (N1-N4, B1) and on the CPU (plain versions) from
    the same weights and batch: losses within rel 1e-4, weights within
    1e-3 of scale."""
    from horovod_tpu_torch.models.mnist import SmallCNN
    from horovod_tpu_torch.ops import batch_norm as BN
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    torch.backends.cudnn.allow_tf32 = False
    try:
        kw = dict(num_classes=10, dtype=torch.float32, seed=7)
        mg, mc = SmallCNN(device="cuda", **kw), SmallCNN(device="cpu", **kw)
        og = hvd.DistributedOptimizer(TF.sgd(mg.parameters(), 0.1, 0.9))
        oc = TF.sgd(mc.parameters(), 0.1, 0.9)
        xg, yg = synthetic_batch(2, 96, 10, seed=3, device="cuda")
        xc, yc = synthetic_batch(2, 96, 10, seed=3, device="cpu")
        BN.reset_launch_counts()
        for step in range(3):
            lg = float(train_step(mg, og, xg, yg))
            lc = float(train_step(mc, oc, xc, yc))
            if not math.isclose(lg, lc, rel_tol=1e-4, abs_tol=1e-5):
                raise AssertionError(
                    f"SmallCNN step {step}: card loss {lg} vs CPU {lc}")
        if BN.LAUNCHES != dict.fromkeys(BN_KERNELS, 9):
            raise AssertionError(f"SmallCNN: BatchNorm launches "
                                 f"{BN.LAUNCHES}, expected 9 each")
        worst = _weights_close(mg, mc, 1e-3, "SmallCNN")
        log(f"[reference] SmallCNN 96 px batch 2, 3 steps: card and CPU "
            f"agree (last loss {lg:.6f} vs {lc:.6f}; worst weight error "
            f"{worst:.2e} of scale; tolerance rel 1e-4 loss, 1e-3 "
            f"weights); N1-N4 launched {BN.LAUNCHES}")
    finally:
        torch.backends.cudnn.allow_tf32 = True


def inception_reference(hvd, torch) -> None:
    """Phase 5d: Inception-v3 (float32, TF32 off, dropout in eval on both
    sides: the card's and the CPU's masks differ) at 139 px, batch 2.
    One step from the same weights: the card (N1-N4) against the CPU
    (plain versions) on the loss (rel 1e-4) and the new BatchNorm
    statistics (rtol 1e-3, atol 1e-4); the gradients against a float64
    CPU evaluation. At random weights this model's float32 gradients
    carry rounding far above float32's (flax's and the port's alike: the
    CPU's whole gradient sits 3-5e-2 from float64 in relative L2 here,
    single tensors up to 0.3-1.0 of their scale, PERF.md), so the card
    is held on relative L2 errors against float64, each at most twice
    the CPU float32 run's plus ``INCEPTION_GRAD_FLOOR``: the whole
    gradient's, and every one of the 284 leaves' on its own (so a fault
    confined to a few leaves, one BatchNorm's scale and bias or one
    branch's convolutions, shows). Then 3 steps on the card through
    N1-N4 and B1: finite losses, 94 launches of each of N1-N4 and one of
    B1 per step. (At 75 px and batch 2 the last blocks' BatchNorms see
    two rows and even the forward differs by 3.5e-4 between float32 and
    float64.)
    """
    from horovod_tpu_torch.models.inception import InceptionV3
    from horovod_tpu_torch.ops import batch_norm as BN
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import (softmax_cross_entropy,
                                              synthetic_batch, train_step)

    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = {}
        for dev, dt in (("cuda", torch.float32), ("cpu", torch.float32),
                        ("cpu", torch.float64)):
            m = InceptionV3(num_classes=10, dtype=dt, device=dev, seed=7)
            m = m.to(dt).train()
            m.Dropout_0.eval()
            x, y = synthetic_batch(2, 139, 10, seed=3, device=dev)
            BN.reset_launch_counts()
            loss = softmax_cross_entropy(m(x.to(dt)), y)
            loss.backward()
            runs[(dev, dt)] = (loss.item(), m, dict(BN.LAUNCHES))
        (lg, mg, ng), (lc, mc, _), (l64, m64, _) = runs.values()
        if ng != dict.fromkeys(BN_KERNELS, 94):
            raise AssertionError(f"Inception-v3 card step: BatchNorm "
                                 f"launches {ng}, expected 94 each")
        if not math.isclose(lg, lc, rel_tol=1e-4):
            raise AssertionError(f"Inception-v3: card loss {lg} vs CPU {lc}")
        for (name, a), b in zip(mg.named_buffers(), mc.buffers()):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-4,
                                       msg=lambda s: f"{name}: {s}")
        # relative L2 errors against float64, the whole gradient's and
        # each leaf's: the card's at most twice the CPU float32 run's plus
        # INCEPTION_GRAD_FLOOR
        names = [n for n, _ in m64.named_parameters()]
        ref = [p.grad for p in m64.parameters()]
        grads = {k: [p.grad.cpu().double() for p in m.parameters()]
                 for k, m in (("card", mg), ("cpu", mc))}

        def rel(a, b):
            return float((a - b).norm() / b.norm().clamp_min(1e-300))

        err = {k: rel(torch.cat([t.flatten() for t in g]),
                      torch.cat([t.flatten() for t in ref]))
               for k, g in grads.items()}
        leaf = {k: [rel(a, b) for a, b in zip(g, ref)]
                for k, g in grads.items()}
        ratio = sorted((c / max(p, 1e-300), n) for n, c, p in
                       zip(names, leaf["card"], leaf["cpu"]))
        bn = [i for i, n in enumerate(names) if "BatchNorm" in n]
        readings = {
            "leaves": len(names), "batch_norm_leaves": len(bn),
            "whole": err,
            "median_leaf": {k: statistics.median(v) for k, v in leaf.items()},
            "worst_leaf": {k: max(zip(v, names)) for k, v in leaf.items()},
            "worst_batch_norm_leaf": {k: max((v[i], names[i]) for i in bn)
                                      for k, v in leaf.items()},
            "card_over_cpu": {"median": statistics.median(
                r for r, _ in ratio), "largest five": ratio[-5:]},
        }
        bad = [(n, c, p) for n, c, p in zip(names, leaf["card"], leaf["cpu"])
               if not c <= 2 * p + INCEPTION_GRAD_FLOOR]
        if not err["card"] <= 2 * err["cpu"] + INCEPTION_GRAD_FLOOR or bad:
            raise AssertionError(
                f"Inception-v3 gradients: relative L2 error against float64 "
                f"{err}; leaves past twice the CPU's + "
                f"{INCEPTION_GRAD_FLOOR}: {bad}; {readings}")
        del mc, m64, runs
        og = hvd.DistributedOptimizer(TF.sgd(mg.parameters(), 0.1, 0.9))
        xg, yg = synthetic_batch(2, 139, 10, seed=3, device="cuda")
        TF.reset_launch_counts()
        BN.reset_launch_counts()
        losses = [float(train_step(mg, og, xg, yg)) for _ in range(3)]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"Inception-v3 small: losses {losses}")
        if BN.LAUNCHES != dict.fromkeys(BN_KERNELS, 3 * 94) \
                or TF.LAUNCHES["momentum"] != 3:
            raise AssertionError(f"Inception-v3 small: launches "
                                 f"{BN.LAUNCHES}, B1 {TF.LAUNCHES}")
        log(f"[reference] Inception-v3 139 px batch 2 float32: card loss "
            f"{lg:.7f}, CPU {lc:.7f}, float64 {l64:.7f}; batch statistics "
            f"agree (rtol 1e-3, atol 1e-4); the whole gradient's relative "
            f"L2 error against float64: card {err['card']:.4e}, CPU "
            f"{err['cpu']:.4e}; every leaf's too (card held to twice the "
            f"CPU's + {INCEPTION_GRAD_FLOOR}): {readings}; then 3 card steps "
            f"{losses}, N1-N4 launched 94 times each per step, B1 once")
    finally:
        torch.backends.cudnn.allow_tf32 = True


def cnn_path(hvd, torch, name: str, gpu: str,
             profile: str | None = None) -> dict:
    """Phases 12b and 13: VGG-16 or Inception-v3 at the bench's size
    (``CNN``), 1000 classes, bf16, dropout active, trained ``CNN_STEPS``
    steps with ``DistributedOptimizer(fused_update.sgd(0.1,
    momentum=0.9))`` on a seeded synthetic batch: every loss finite, one
    B1 launch per step, one launch of each of N1-N4 per BatchNorm per
    step."""
    from horovod_tpu_torch.models.inception import InceptionV3
    from horovod_tpu_torch.models.vgg import VGG16
    from horovod_tpu_torch.ops import batch_norm as BN
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    side, batch, n_bn = CNN[name]
    model = {"vgg16": VGG16, "inception3": InceptionV3}[name](
        num_classes=1000, dtype=torch.bfloat16, seed=0)
    opt = hvd.DistributedOptimizer(
        hvd.fused_update.sgd(model.parameters(), 0.1, momentum=0.9))
    if not TF.active():
        raise AssertionError("the fused tail is not active")
    images, labels = synthetic_batch(batch, side, 1000, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    TF.reset_launch_counts()
    BN.reset_launch_counts()
    for _ in range(CNN_STEPS):
        t0 = time.perf_counter()
        loss = train_step(model, opt, images, labels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = {"momentum": TF.LAUNCHES["momentum"], **BN.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss: {losses}")
    want = {"momentum": CNN_STEPS,
            **dict.fromkeys(BN_KERNELS, n_bn * CNN_STEPS)}
    if launches != want:
        raise AssertionError(f"{name}: kernel launches {launches} in "
                             f"{CNN_STEPS} steps, expected {want}")
    steady = times[1:]
    step_s = sum(steady) / len(steady)
    med = statistics.median(steady)
    log(f"[{name}] {side}x{side} batch {batch} bf16, dropout on, fused "
        f"momentum SGD, {CNN_STEPS} steps on {gpu}: losses {losses}")
    log(f"[{name}] step times (s) {times}; steady step mean {step_s:.4f} s "
        f"= {batch / step_s:.1f} img/s, median {med:.4f} s = "
        f"{batch / med:.1f} img/s; peak memory {peak / 2**30:.2f} GiB "
        f"({peak} B); kernel launches {launches}; on {gpu}")
    if profile:
        stem, ext = os.path.splitext(profile)
        profile_steps(torch, lambda: train_step(model, opt, images, labels),
                      step_s, f"{stem}_{name}{ext}", RESNET_CLASSES, name)
    del model, opt, images, labels
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses, "step_s": step_s,
            "median_s": med, "peak_bytes": peak}


# ---------------------------------------------------------------------------
# ZeRO stages 1-3 and the overlap engine (phase 14)
# ---------------------------------------------------------------------------

ZERO_N, ZERO_K = 4, 4  # the emulated world and its buckets (phase 14a)
# (name, zero_stage, overlap) of the ResNet-50 runs (phase 14b)
ZERO_CONFIGS = (("stage 0 + overlap", 0, True), ("stage 1", 1, False),
                ("stage 2", 2, False), ("stage 3", 3, False),
                ("stage 2 + overlap", 2, True))
ZERO_STEPS = 3


def _sharded_tail(torch, spec, grads, state: dict, what: str) -> dict:
    """The sharded tail at an emulated world of ``ZERO_N`` (only the
    transport emulated): every rank's ``ZERO_K`` bucket pieces
    (``fuse_bucket_piece``) summed in rank order, each rank's shard
    through ``fused_update_groups`` (navg ``ZERO_N``) with its shard of
    ``state``, the update reassembled leaf by leaf from the bucket results
    (``leaf_from_buckets``); held bit for bit, updates and moments,
    against stage 0's multi-leaf kernel over the gradients summed in the
    same order.  Returns the launches of each side."""
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import overlap as O
    from horovod_tpu_torch.optim import distributed as D
    from horovod_tpu_torch.optim import fused_update as TF

    n = ZERO_N
    lay = D._shard_layout(grads[0], n)
    if len(lay.keys) != 1:
        raise AssertionError(f"{what}: expected one float32 group")
    L, bounds = lay.shard[0], O.bucket_bounds(lay.shard[0], ZERO_K)
    sums = []
    for s, e in bounds:
        pieces = [C.fuse_bucket_piece(g, lay.idxs[0], lay.sizes[0],
                                      lay.padded[0], n, s, e, torch.float32)
                  for g in grads]
        total = pieces[0].clone()
        for piece in pieces[1:]:
            total.add_(piece)
        sums.append(total.view(n, e - s))
        del pieces
    moments = [k for k in state if k != "count"]
    TF.reset_launch_counts()
    shards = []
    for j in range(n):
        st = {k: D._rank_shard(state[k], lay, 0, j).clone() for k in moments}
        if "count" in state:
            st["count"] = state["count"]
        shard = torch.cat([sm[j] for sm in sums])
        shards.append((TF.fused_update_groups(spec, [shard], [st], n,
                                              [torch.float32])[0], st))
    torch.cuda.synchronize()
    zero_launches = TF.LAUNCHES[spec.kind]
    if zero_launches != n:
        raise AssertionError(f"{what}: {zero_launches} launches for {n} "
                             "emulated ranks of one group")
    del sums
    outs = {"update": [torch.cat([u[s:e] for u, _ in shards])
                       for s, e in bounds]}
    for k in moments:
        outs[k] = [torch.cat([st[k][s:e] for _, st in shards])
                   for s, e in bounds]
    summed = []
    for i in range(len(grads[0])):
        t = grads[0][i].clone()
        for g in grads[1:]:
            t.add_(g[i])
        summed.append(t)
    TF.reset_launch_counts()
    if spec.kind == "momentum":
        us, ts = TF.momentum_update_multi(
            summed, [t.clone() for t in state["trace"]], n, spec.momentum,
            -spec.lr)
        want = {"update": us, "trace": ts}
    else:
        bc1, bc2 = TF.bias_corrections(spec, state["count"] + 1)
        us, ms, vs = TF.adam_update_multi(
            summed, [m.clone() for m in state["mu"]],
            [v.clone() for v in state["nu"]], bc1, bc2, n, spec)
        want = {"update": us, "mu": ms, "nu": vs}
    torch.cuda.synchronize()
    stage0_launches = TF.LAUNCHES[spec.kind]
    off = 0
    for i, sz in zip(lay.idxs[0], lay.sizes[0]):
        for k, w in want.items():
            got = C.leaf_from_buckets(outs[k], bounds, n, L, off, sz)
            if not torch.equal(got.view(w[i].shape), w[i]):
                raise AssertionError(
                    f"{what}: leaf {i} {k} differs from stage 0's")
        off += sz
    return {"zero_launches": zero_launches,
            "stage0_launches": stage0_launches}


def zero_tail_emulated(torch, model, gpu: str) -> dict:
    """Phase 14a: B1 over the ResNet-50 gradients of four 64-image batch
    shards of the main path's model (a seeded random trace), B3 over
    seeded gradients and moments at the LM's 75 leaf shapes, each as the
    sharded tail at an emulated world of 4 with 4 buckets, bit for bit
    against stage 0."""
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import (softmax_cross_entropy,
                                              synthetic_batch)

    grads = []
    for r in range(ZERO_N):
        images, labels = synthetic_batch(64, 224, 1000, seed=100 + r)
        model.zero_grad(set_to_none=True)
        softmax_cross_entropy(model(images), labels).backward()
        grads.append([p.grad.detach().clone() for p in model.parameters()])
        del images, labels
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device="cuda").manual_seed(14)
    trace = [torch.randn(g.shape, device="cuda", generator=gen)
             for g in grads[0]]
    out = {"momentum": _sharded_tail(
        torch, TF.FusedSpec("momentum", 0.1, 0.9), grads, {"trace": trace},
        "ResNet-50 B1")}
    del grads, trace
    shapes = lm_shapes(LM_SEQ)
    grads = [[torch.randn(s, device="cuda", generator=gen) for s in shapes]
             for _ in range(ZERO_N)]
    state = {"mu": [torch.randn(s, device="cuda", generator=gen) * 1e-2
                    for s in shapes],
             "nu": [torch.rand(s, device="cuda", generator=gen) * 1e-4
                    for s in shapes],
             "count": 2}
    out["adam"] = _sharded_tail(
        torch, TF.FusedSpec("adam", 3e-4, 0.0, 0.9, 0.999, 1e-8), grads,
        state, "LM B3")
    del grads, state
    torch.cuda.empty_cache()
    log(f"[zero] the sharded tail at an emulated world of {ZERO_N} with "
        f"{ZERO_K} buckets (fuse_bucket_piece, fused_update_groups with "
        f"navg {ZERO_N}, leaf_from_buckets) equals stage 0's kernel over "
        f"the summed gradients bit for bit, updates and moments: B1 over "
        f"the 161 ResNet-50 leaves ({out['momentum']['zero_launches']} "
        f"launches, stage 0 {out['momentum']['stage0_launches']}), B3 over "
        f"the 75 LM leaves ({out['adam']['zero_launches']} launches, stage 0 "
        f"{out['adam']['stage0_launches']}); on {gpu}")
    return out


def _leaves_of(flat, sizes, shapes) -> list:
    out, off = [], 0
    for sz, shape in zip(sizes, shapes):
        out.append(flat[off:off + sz].view(shape))
        off += sz
    return out


def _zero_tail_check(hvd, torch, name: str, opt, model, zp) -> None:
    """One more step of ``opt`` on its current weights, state and
    gradients (the last step's) against a stage-0 optimizer on copies of
    them: the weights and traces equal bit for bit.  At a world of one
    the shard is the whole padded buffer."""
    if zp is None:
        params = list(model.parameters())
        shapes = [p.shape for p in params]
        sizes = [p.numel() for p in params]
        grads = [p.grad.clone() for p in params]
        weights = lambda: [p.detach() for p in params]  # noqa: E731
        if opt.zero_stage == 0:
            traces = lambda: [opt.optimizer.state[p]["trace"]  # noqa: E731
                              for p in params]
        else:
            traces = lambda: _leaves_of(  # noqa: E731
                opt.shard_state[0]["trace"], sizes, shapes)
    else:
        shapes, sizes = zp.shapes, zp.layout.sizes[0]
        shard = zp.shards[0]
        grads = [g.clone() for g in _leaves_of(shard.grad, sizes, shapes)]
        weights = lambda: _leaves_of(shard.detach(), sizes,  # noqa: E731
                                     shapes)
        traces = lambda: _leaves_of(  # noqa: E731
            opt.optimizer.state[shard]["trace"], sizes, shapes)
    ref = [torch.nn.Parameter(w.clone()) for w in weights()]
    for p, g in zip(ref, grads):
        p.grad = g
    ropt = hvd.DistributedOptimizer(hvd.fused_update.sgd(ref, 0.1,
                                                         momentum=0.9))
    for p, t in zip(ref, traces()):
        ropt.optimizer.state[p]["trace"].copy_(t)
    opt.step()
    ropt.step()
    torch.cuda.synchronize()
    for i, (a, b, ta, tb) in enumerate(zip(weights(), ref, traces(), [
            ropt.optimizer.state[p]["trace"] for p in ref])):
        if not (torch.equal(a, b.detach()) and torch.equal(ta, tb)):
            raise AssertionError(f"{name}: the tail on captured gradients "
                                 f"differs from stage 0's at leaf {i}")


def zero_resnet_paths(hvd, torch, gpu: str) -> dict:
    """Phase 14b: the main path's ResNet-50 (224 px, batch 256, bf16,
    fused momentum SGD, world 1 over NCCL) ``ZERO_STEPS`` steps at each of
    ``ZERO_CONFIGS``, stage 3 through ``zero3_train_step``: every loss
    finite, one B1 and 53 of each of N1-N4 per step, median step time,
    peak memory and optimizer-state bytes; then the tail check."""
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import batch_norm as BN
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import (synthetic_batch, train_step,
                                              zero3_train_step)

    images, labels = synthetic_batch(BATCH, 224, 1000, seed=0)
    out = {}
    for name, stage, overlap in ZERO_CONFIGS:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0)
        zp = hvd.zero3_shard_params(model) if stage == 3 else None
        opt = hvd.DistributedOptimizer(
            hvd.fused_update.sgd(zp.shards if zp else model.parameters(),
                                 0.1, momentum=0.9),
            zero_stage=stage, overlap=overlap)
        torch.cuda.synchronize()
        losses, times = [], []
        TF.reset_launch_counts()
        BN.reset_launch_counts()
        for _ in range(ZERO_STEPS):
            t0 = time.perf_counter()
            if zp is None:
                loss = train_step(model, opt, images, labels)
            else:
                loss = zero3_train_step(model, zp, opt, images, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
        launches = {**TF.LAUNCHES, **BN.LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: non-finite loss: {losses}")
        want = {"sgd": 0, "momentum": ZERO_STEPS, "adam": 0,
                **dict.fromkeys(BN_KERNELS, RESNET50_BN * ZERO_STEPS)}
        if launches != want:
            raise AssertionError(f"{name}: kernel launches {launches} in "
                                 f"{ZERO_STEPS} steps, expected {want}")
        _zero_tail_check(hvd, torch, name, opt, model, zp)
        med = statistics.median(times[1:])
        log(f"[zero] ResNet-50 224x224 batch {BATCH} bf16, fused momentum "
            f"SGD, {name}, {ZERO_STEPS} steps on {gpu}: losses {losses}; "
            f"step times (s) {times}; median {med:.4f} s = "
            f"{BATCH / med:.1f} img/s; peak memory {peak} B; optimizer "
            f"state {opt.state_bytes()} B; kernel launches {launches}; the "
            "tail on captured gradients equals stage 0's bit for bit")
        out[name] = {"launches": launches, "losses": losses,
                     "median_s": med, "peak_bytes": peak,
                     "state_bytes": opt.state_bytes()}
        del model, opt, zp
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Sequence parallelism (phase 15)
# ---------------------------------------------------------------------------

SP = 4  # the emulated sequence group: the long-context LM over four ranks
# the offsets the ring gives B8-B10 (as tests/test_torch_cuda.py's
# SP_OFFSET_CASES): (bh, [(name, q_offset, k_offset, causal, rows)]) at
# Lq = Lk = rows, the long-context chunk (12, 2048, 64) bf16 and (8, 256,
# 64) f32; the zigzag pairs at half a chunk
SP_OFFSETS = {
    "bfloat16": (12, [("visible whole", 2048, 0, True, 2048),
                      ("hidden whole", 0, 2048, True, 2048),
                      ("partial, keys ahead", 0, 1000, True, 2048),
                      ("partial, queries ahead", 1337, 0, True, 2048),
                      ("zigzag diagonal", 0, 0, True, 1024),
                      ("zigzag full", 0, 0, False, 1024)]),
    "float32": (8, [("visible whole", 256, 0, True, 256),
                    ("hidden whole", 0, 256, True, 256),
                    ("partial, keys ahead", 0, 125, True, 256),
                    ("partial, queries ahead", 167, 0, True, 256),
                    ("zigzag diagonal", 0, 0, True, 128),
                    ("zigzag full", 0, 0, False, 128)]),
}
ULYSSES_BLOCK_K = 512
# a device-side wait (~3 ms at the H100's clocks) before each timed call
# of the host-ahead pass, long enough for the host to enqueue the call's
# launches: its CUDA events then time the kernels back to back, without
# the host's launch gaps
SLEEP_CYCLES = 5_000_000


def sp_offset_checks(FA, torch) -> dict:
    """Phase 15a: B8 from a fresh state, B9 and B10 from the lse and delta
    of the block seen whole, each against its plain version at the ring's
    offsets; a block hidden whole must leave the fresh state and give
    zero gradients exactly.  Returns each kernel's largest errors."""
    from horovod_tpu_torch.parallel.ring_attention import finish

    res = _flash_res()
    gen = torch.Generator(device="cuda").manual_seed(15)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dname, (bh, cases) in SP_OFFSETS.items():
            dtype = getattr(torch, dname)
            for name, qo, ko, causal, rows in cases:
                shape = (bh, rows, LM["head_dim"])
                q, k, v, do = _attn_inputs(torch, shape, dtype, gen)
                fresh = _fresh(torch, *shape)
                what = (f"{shape} {dname} {name}, offsets ({qo}, {ko}) "
                        f"causal={causal}")
                got = FA.flash_block_step(q, k, v, *fresh, qo, ko,
                                          causal=causal)
                _hold_state(FA, torch, res, got, FA.flash_block_step_plain(
                    q, k, v, *fresh, qo, ko, causal), dtype, f"B8 {what}")
                out, lse = finish(*FA.flash_block_step_plain(
                    q, k, v, *fresh, 0, 0, False))
                args = (q, k, v, do, lse, (do.float() * out).sum(-1), qo,
                        ko)
                dq = FA.flash_bwd_dq(*args, causal=causal)
                dk, dv = FA.flash_bwd_dkv(*args, causal=causal)
                _hold(FA, torch, res, "flash_bwd_dq", dq,
                      FA.flash_bwd_dq_plain(*args, causal), dtype,
                      f"B9 dq {what}")
                for n, a, b in zip(("dk", "dv"), (dk, dv),
                                   FA.flash_bwd_dkv_plain(*args, causal)):
                    _hold(FA, torch, res, "flash_bwd_dkv", a, b, dtype,
                          f"B10 {n} {what}")
                if name == "hidden whole" and not (
                        all(torch.equal(a, b) for a, b in zip(got, fresh))
                        and not (dq.any() or dk.any() or dv.any())):
                    raise AssertionError(
                        f"{what}: a block hidden whole changed the fresh "
                        "state or gave a non-zero gradient")
                torch.cuda.synchronize()
        log(f"[sp] B8, B9, B10 agree with their plain versions at the "
            f"ring's offsets (visible whole, hidden whole: the fresh state "
            f"and zero gradients exactly, two partial blocks off the tile "
            f"grid, the zigzag pairs) at (12, 2048, 64) bf16 and (8, 256, "
            f"64) f32: largest errors {res}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return res


class _RankClock:
    """The launches and the kernel time (CUDA events) of each emulated
    rank, summed over the calls made for it; with ``ahead`` each call
    waits ``SLEEP_CYCLES`` on the device first, so the events time its
    kernels without the host's launch gaps."""

    def __init__(self, FA, n: int, ahead: bool):
        self.FA, self.ahead = FA, ahead
        self.launches = [dict.fromkeys(FLASH, 0) for _ in range(n)]
        self.events = [[] for _ in range(n)]

    def call(self, torch, rank: int, fn, *args):
        before = dict(self.FA.LAUNCHES)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        if self.ahead:
            torch.cuda._sleep(SLEEP_CYCLES)
        ev[0].record()
        out = fn(*args)
        ev[1].record()
        self.events[rank].append(ev)
        for k in FLASH:
            self.launches[rank][k] += self.FA.LAUNCHES[k] - before[k]
        return out

    def ms(self, torch) -> list:
        torch.cuda.synchronize()
        return [sum(a.elapsed_time(b) for a, b in evs) for evs in self.events]


def _one_call(FA, torch, q, k, v, do) -> dict:
    """B8, B9 and B10 over the whole sequence (sp = 1), float32 results."""
    from horovod_tpu_torch.parallel.ring_attention import finish

    out, lse = finish(*FA.flash_block_step(q, k, v, *_fresh(torch, *q.shape),
                                           0, 0))
    args = (q, k, v, do, lse, (do.float() * out).sum(-1), 0, 0)
    dk, dv = FA.flash_bwd_dkv(*args)
    return {"out": out, "dq": FA.flash_bwd_dq(*args), "dk": dk, "dv": dv}


def sp_emulated_ring(FA, torch, layout: str, x: dict, want: dict,
                     ahead: bool) -> dict:
    """Phase 15b: the causal ring over an emulated group of ``SP`` ranks
    at ``LONG_ATTN_SHAPE`` bf16 in ``layout``: each rank walks its
    ``ring_plan`` with the ring's own per-step functions (the rotation is
    list indexing: at step j rank i holds rank (i - j) mod SP's block, and
    the dK/dV accumulators are added in the ring's order), forward then
    backward; the assembled out, dQ, dK, dV are held against the one-call
    kernels ``want``.  Returns the launches, the kernel ms (as the host
    drives them, or with ``ahead`` the device time alone: see
    :class:`_RankClock`) and the errors of each rank."""
    from horovod_tpu_torch.parallel import ring_attention as R

    bh, L, d = LONG_ATTN_SHAPE
    lc = L // SP
    zig = layout == "zigzag"
    shard = (lambda t: R.zigzag_shard(t, SP)) if zig else (lambda t: t)
    plans = [R.ring_plan(i, SP, lc, True, layout) for i in range(SP)]
    qsl, kvsl = R.plan_slices(plans[0])
    chunk = {n: [shard(t)[:, i * lc:(i + 1) * lc] for i in range(SP)]
             for n, t in x.items()}
    q = [R.split_rows(t, qsl) for t in chunk["q"]]
    k = [R.split_rows(t, kvsl) for t in chunk["k"]]
    v = [R.split_rows(t, kvsl) for t in chunk["v"]]
    do = [R.split_rows(t, qsl) for t in chunk["do"]]
    clock = _RankClock(FA, SP, ahead)
    FA.reset_launch_counts()
    outs, lses, deltas = [], [], []
    for i in range(SP):
        state = R.fresh_state(q[i])
        for j in range(SP):
            src = (i - j) % SP
            clock.call(torch, i, R.ring_fwd_step, plans[i][j], q[i], k[src],
                       v[src], state)
        done = {key: R.finish(*st) for key, st in state.items()}
        outs.append({key: r[0] for key, r in done.items()})
        lses.append({key: r[1] for key, r in done.items()})
        deltas.append({key: (do[i][key].float() * o).sum(-1)
                       for key, o in outs[i].items()})
    dq = [{key: torch.zeros(t.shape, device="cuda") for key, t in q[i].items()}
          for i in range(SP)]
    acc = [{key: [torch.zeros(t.shape, device="cuda") for _ in range(2)]
            for key, t in k[i].items()} for i in range(SP)]
    for j in range(SP):
        for i in range(SP):
            src = (i - j) % SP
            dkv = clock.call(torch, i, R.ring_bwd_step, plans[i][j], q[i],
                             k[src], v[src], do[i], lses[i], deltas[i],
                             dq[i])
            for key, (a, b) in dkv.items():
                acc[src][key][0].add_(a)
                acc[src][key][1].add_(b)
    ms = clock.ms(torch)
    unshard = ((lambda t: R.zigzag_unshard(t, SP)) if zig else
               (lambda t: t))
    got = {"out": [R.join_rows(o) for o in outs],
           "dq": [R.join_rows(g) for g in dq],
           "dk": [R.join_rows({key: a[0] for key, a in g.items()})
                  for g in acc],
           "dv": [R.join_rows({key: a[1] for key, a in g.items()})
                  for g in acc]}
    res = _flash_res()
    errs = {}
    for n, parts in got.items():
        g = unshard(torch.cat(parts, 1))
        name = {"out": "flash_block_step", "dq": "flash_bwd_dq"}.get(
            n, "flash_bwd_dkv")
        _hold(FA, torch, res, name, g, want[n], torch.bfloat16,
              f"emulated {layout} ring, sp = {SP}, {n}")
        errs[n] = FA.errors(g, want[n])
    for i in range(SP):
        runs = sum(a.run for step in plans[i] for a in step)
        if clock.launches[i] != dict.fromkeys(FLASH, runs):
            raise AssertionError(
                f"emulated {layout} ring rank {i}: launches "
                f"{clock.launches[i]}, planned {runs} of each")
    log(f"[sp] emulated {layout} ring, {LONG_ATTN_SHAPE} bf16 causal over sp "
        f"= {SP}: out, dQ, dK, dV agree with the one-call kernels (largest "
        f"(abs, row) errors {errs}); launches per rank "
        f"{[c['flash_block_step'] for c in clock.launches]} of each of B8, "
        f"B9, B10, as planned; ms per rank (forward + backward, "
        f"{'device alone, host ahead' if ahead else 'as the host drives'}) "
        f"{ms}")
    return {"launches": [c["flash_block_step"] for c in clock.launches],
            "ms": ms, "errors": errs, "res": res}


def sp_emulated_ulysses(FA, torch, x: dict, want: dict, ahead: bool) -> dict:
    """Phase 15c: Ulysses over an emulated group of ``SP`` ranks: the head
    regrouping (each rank gets its group of 12 / SP heads over the whole
    sequence) on the card, ``blockwise_attention`` forward and backward on
    each group at L = 8192, the groups reassembled and held against the
    one-call kernels rounded to bf16 (blockwise_attention returns q's
    dtype) at the JAX package's bf16 tolerance and the row bound; timed
    per group as :func:`sp_emulated_ring` times a rank."""
    from horovod_tpu_torch.parallel.ring_attention import (blockwise_attention,
                                                           blockwise_plan)

    bh, L, d = LONG_ATTN_SHAPE
    hg = bh // SP
    four = {n: t.view(LONG_BATCH, LM["n_heads"], L, d).transpose(1, 2)
            for n, t in x.items()}
    clock = _RankClock(FA, SP, ahead)
    parts = {n: [] for n in ("out", "dq", "dk", "dv")}
    for r in range(SP):
        mine = {n: t[:, :, r * hg:(r + 1) * hg].detach().clone()
                for n, t in four.items()}
        for n in "qkv":
            mine[n].requires_grad_()

        def fwd_bwd():
            out = blockwise_attention(mine["q"], mine["k"], mine["v"], True,
                                      ULYSSES_BLOCK_K)
            out.backward(mine["do"])
            return out

        out = clock.call(torch, r, fwd_bwd)
        for n, t in (("out", out), ("dq", mine["q"].grad),
                     ("dk", mine["k"].grad), ("dv", mine["v"].grad)):
            parts[n].append(t.detach())
    ms = clock.ms(torch)
    errs = {}
    for n, ps in parts.items():
        g = torch.cat(ps, 2).transpose(1, 2).reshape(bh, L, d).float()
        w = want[n].to(torch.bfloat16).float()
        torch.testing.assert_close(g, w, rtol=ATTN_TOL["bfloat16"][0],
                                   atol=ATTN_TOL["bfloat16"][1],
                                   msg=lambda m: f"emulated Ulysses {n}: {m}")
        errs[n] = FA.errors(g, w)
        if errs[n][1] > FA.BF16_ROW_REL:
            raise AssertionError(f"emulated Ulysses {n}: row error "
                                 f"{errs[n][1]} > {FA.BF16_ROW_REL}")
    blocks = len(blockwise_plan(L, ULYSSES_BLOCK_K)[0])
    if clock.launches != [dict.fromkeys(FLASH, blocks)] * SP:
        raise AssertionError(f"emulated Ulysses: launches {clock.launches}, "
                             f"planned {blocks} of each per head group")
    log(f"[sp] emulated Ulysses, {LM['n_heads']} heads into {SP} groups, "
        f"blockwise_attention at L = {L} (block_k {ULYSSES_BLOCK_K}): out, "
        f"dQ, dK, dV agree with the one-call kernels rounded to bf16 "
        f"(largest (abs, row) errors {errs}); {blocks} launches of each of "
        f"B8, B9, B10 per group, as planned; ms per group (forward + "
        f"backward, with autograd, "
        f"{'device alone, host ahead' if ahead else 'as the host drives'}) "
        f"{ms}")
    return {"launches": [c["flash_block_step"] for c in clock.launches],
            "ms": ms, "errors": errs}


def sequence_parallel(FA, torch) -> dict:
    """Phase 15: the offsets (15a), the emulated ring in both layouts
    (15b) and the emulated Ulysses (15c) at the long-context LM's
    attention; the emulations run twice, timed as the host drives them
    and then with the host ahead."""
    t0 = time.perf_counter()
    offsets = sp_offset_checks(FA, torch)
    gen = torch.Generator(device="cuda").manual_seed(16)
    x = dict(zip(("q", "k", "v", "do"), _attn_inputs(
        torch, LONG_ATTN_SHAPE, torch.bfloat16, gen)))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = _one_call(FA, torch, x["q"], x["k"], x["v"], x["do"])
        rings, uly = {}, {}
        for ahead in (False, True):
            for layout in ("contiguous", "zigzag"):
                r = sp_emulated_ring(FA, torch, layout, x, want, ahead)
                rings.setdefault(layout, r)["ms_device" if ahead else
                                            "ms"] = r["ms"]
            r = sp_emulated_ulysses(FA, torch, x, want, ahead)
            uly.setdefault("ulysses", r)["ms_device" if ahead else
                                         "ms"] = r["ms"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for key in ("ms", "ms_device"):
        slow = {layout: max(r[key]) for layout, r in rings.items()}
        log(f"[sp] slowest rank's attention ms (forward + backward, "
            f"{'device alone' if key == 'ms_device' else 'as driven'}): "
            f"contiguous {slow['contiguous']:.4f}, zigzag "
            f"{slow['zigzag']:.4f} (zigzag / contiguous "
            f"{slow['zigzag'] / slow['contiguous']:.3f})")
    log(f"[sp] phase 15 took {time.perf_counter() - t0:.1f} s")
    del x, want
    torch.cuda.empty_cache()
    return {"offsets": offsets, "rings": rings, "ulysses": uly["ulysses"]}


# ---------------------------------------------------------------------------
# The data plane (phase 16): an emulated world on one card
# ---------------------------------------------------------------------------

DP_N, DP_CROSS, DP_LOCAL = 4, 2, 2  # the emulated world and its pair
DP_STEPS = 3                        # phase 16c's steps per run


def _resnet_grads(torch, model) -> list:
    """The main path's model's gradient leaves for four seeded 64-image
    batch shards (the shards of phases 10 and 14a)."""
    from horovod_tpu_torch.train_step import (softmax_cross_entropy,
                                              synthetic_batch)

    grads = []
    for r in range(DP_N):
        images, labels = synthetic_batch(64, 224, 1000, seed=100 + r)
        model.zero_grad(set_to_none=True)
        softmax_cross_entropy(model(images), labels).backward()
        grads.append([p.grad.detach().clone() for p in model.parameters()])
        del images, labels
    model.zero_grad(set_to_none=True)
    return grads


def _lossy_pair(Q, torch, flats, mode: str, gpu: str) -> dict:
    """Phase 16a, the two-level lossy sum: ``quantized_allreduce(op=Sum,
    with_error=True, mode)`` on each emulated rank over the (cross 2,
    local 2) pair, on the card and (the plain versions) on the CPU."""
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.parallel.emulated import EmulatedWorld

    qmax = (Q.sum_safe_qmax if mode == "int8" else Q.sum_safe_qmax4)(DP_CROSS)
    enc = Q.quantize_plain if mode == "int8" else Q.quantize_pack4_plain
    dec = Q.dequantize_plain if mode == "int8" else Q.unpack_dequantize4_plain
    kernels = ("quantize", "dequantize") if mode == "int8" \
        else ("pack4", "unpack4")
    runs = {}
    for dev in ("cuda", "cpu"):
        world = EmulatedWorld(torch, DP_N, (Q.LAUNCHES,), sync=dev == "cuda")
        xs = [f if dev == "cuda" else f.cpu() for f in flats]
        Q.reset_launch_counts()
        runs[dev] = (world, world.run(lambda r: C.quantized_allreduce(
            xs[r], op=C.Sum, with_error=True, mode=mode,
            axis_name=world.pair(r, DP_LOCAL))))
    world, outs = runs["cuda"]
    for r, ((out, err), (pout, perr)) in enumerate(zip(outs, runs["cpu"][1])):
        if not (torch.equal(out.cpu(), pout) and torch.equal(err.cpu(), perr)):
            raise AssertionError(f"{mode} rank {r}: the card's two-level sum "
                                 "or residual differs from the plain "
                                 "versions' on the CPU")
        want = {kernels[0]: 1, kernels[1]: 2}
        if dict(world.launches[r]) != want:
            raise AssertionError(f"{mode} rank {r}: launches "
                                 f"{dict(world.launches[r])}, expected {want}")
    # the bound, from the local partial sums' block absmax: the cross hop
    # is the only lossy one; and the residual is the cross hop's error of
    # the rank's local shard, gathered over the local hop and divided by nl
    half = flats[0].numel() // DP_LOCAL
    worst = 0.0
    for l_ in range(DP_LOCAL):
        sl = slice(l_ * half, (l_ + 1) * half)
        parts = [flats[c * DP_LOCAL][sl] + flats[c * DP_LOCAL + 1][sl]
                 for c in range(DP_CROSS)]
        p2d = [Q._to_blocks(p, QBLOCK)[0] for p in parts]
        s = Q._scales(torch.stack([Q.block_absmax(p) for p in p2d]).amax(0),
                      qmax)
        exact = (parts[0].double() + parts[1].double())
        bound = DP_CROSS * torch.repeat_interleave(
            half_scale(s.double(), qmax), QBLOCK)[:half]
        for r, (out, err) in enumerate(outs):
            excess = float(((out[sl].double() - exact).abs() - bound).max())
            worst = max(worst, float(((out[sl].double() - exact).abs()
                                      / bound.clamp_min(1e-30)).max()))
            if excess > 0:
                raise AssertionError(f"{mode} rank {r}: beyond nc * scale / "
                                     f"2 of the float sum by {excess}")
            c = r // DP_LOCAL
            resid = (p2d[c] - dec(enc(p2d[c], s, qmax), s)).reshape(-1)[:half]
            if not torch.equal(err[sl] * DP_LOCAL, resid):
                raise AssertionError(f"{mode} rank {r}: the residual of "
                                     f"local shard {l_} is not the cross "
                                     "hop's error divided by nl")
        del parts, p2d, exact, bound
    ms = dict(world.ms[0])
    log(f"[data plane] {mode} over an emulated (cross {DP_CROSS}, local "
        f"{DP_LOCAL}) world, ResNet-50's fused gradient buffer "
        f"({flats[0].numel()} f32) from four 64-image shards: the card's "
        f"sum and residual equal the plain versions' bit for bit on every "
        f"rank; within nc * scale / 2 of the float sum (largest "
        f"{worst:.4f} of the bound), scales from the local partial sums at "
        f"qmax {qmax}; residual = the cross hop's error / nl; launches per "
        f"rank {[dict(x) for x in world.launches]}; rank 0's ms before "
        f"each transfer {ms}; payload bytes per hop (rank 0) "
        f"{dict(world.wire[0])}; on {gpu}")
    return {"launches": [dict(x) for x in world.launches],
            "ms": [dict(x) for x in world.ms],
            "wire": [dict(x) for x in world.wire], "worst": worst}


def _zero_pair(torch, kind: str, weights, grads, gpu: str) -> dict:
    """Phase 16a, the sharded variant: ``DistributedOptimizer`` with the
    fused tail (``kind``: B1 momentum or B3 Adam) at stage 2 on each
    emulated rank over the pair, against stage 0 over the same pair: two
    steps, weights bit for bit, each rank's shard of the state at its
    ``shard_index`` of stage 0's, one launch per rank per step."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.parallel.emulated import EmulatedWorld

    res = {}
    for stage in (0, 2):
        world = EmulatedWorld(torch, DP_N, (TF.LAUNCHES,))

        def step(r):
            ax = world.pair(r, DP_LOCAL)
            ps = [torch.nn.Parameter(w.clone()) for w in weights]
            opt = (hvd.fused_update.sgd(ps, 0.1, momentum=0.9)
                   if kind == "momentum" else hvd.fused_update.adam(ps, 3e-4))
            dopt = hvd.DistributedOptimizer(opt, zero_stage=stage,
                                            axis_name=ax)
            for _ in range(2):
                for p, g in zip(ps, grads[r]):
                    p.grad = g.clone()
                dopt.step()
            key = "trace" if kind == "momentum" else "mu"
            st = (torch.cat([opt.state[p][key].reshape(-1) for p in ps])
                  if stage == 0 else dopt.shard_state[0][key])
            return [p.detach() for p in ps], st, C.shard_index(ax)

        TF.reset_launch_counts()
        res[stage] = (world, world.run(step))
    base = res[0][1][0]
    for stage, (world, outs) in res.items():
        for r, (ws, st, idx) in enumerate(outs):
            if not all(torch.equal(a, b) for a, b in zip(ws, base[0])):
                raise AssertionError(f"{kind} stage {stage} rank {r}: "
                                     "weights differ from stage 0's")
            if dict(world.launches[r]) != {kind: 2}:
                raise AssertionError(f"{kind} stage {stage} rank {r}: "
                                     f"launches {dict(world.launches[r])}")
            if stage == 2:
                L = st.numel()
                full = res[0][1][r][1]
                want = full[idx * L:(idx + 1) * L]
                if idx != r or not torch.equal(st[:want.numel()], want):
                    raise AssertionError(f"{kind} rank {r}: its shard is not "
                                         f"segment {idx} of stage 0's state")
    log(f"[data plane] ZeRO stage 2 over the emulated pair ({kind}, "
        f"{len(weights)} leaves, two steps): weights equal stage 0's over "
        f"the pair bit for bit on every rank, each rank's state shard is "
        f"segment shard_index = rank (cross-major) of stage 0's, launches "
        f"per rank {[dict(w.launches[0]) for w, _ in res.values()]} "
        f"(stage 0, stage 2); rank 0's ms before each transfer at stage 2 "
        f"{dict(res[2][0].ms[0])}; on {gpu}")
    return {"launches": {s: [dict(x) for x in w.launches]
                         for s, (w, _) in res.items()}}


def _adasum_world(torch, grads, gpu: str) -> dict:
    """Phase 16b: ``grouped_allreduce(op=Adasum)`` over the ResNet-50
    gradient leaves of four emulated ranks, f32 and bf16 (computed in
    f32) over the flat world, f32 hierarchically over the pair."""
    import numpy as np

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import adasum as A
    from horovod_tpu_torch.parallel.emulated import EmulatedWorld

    out = {}
    for name, dtype, pair in (("f32", torch.float32, False),
                              ("bf16", torch.bfloat16, False),
                              ("f32 pair", torch.float32, True)):
        world = EmulatedWorld(torch, DP_N)
        leaves = [[g.to(dtype) for g in gs] for gs in grads]
        res = world.run(lambda r: hvd.grouped_allreduce(
            leaves[r], op=hvd.Adasum, axis_name=(
                world.pair(r, DP_LOCAL) if pair else world.flat(r))))
        for r in range(1, DP_N):
            if not all(torch.equal(a, b) for a, b in zip(res[r], res[0])):
                raise AssertionError(f"Adasum {name}: rank {r}'s result "
                                     "differs from rank 0's")
        # the float64 reference leaf by leaf; the pair: local mean, then
        # Adasum across the cross axis
        if dtype == torch.float32:
            rtol, atol = (1e-5, 1e-6) if pair else (1e-4, 1e-5)
        else:
            rtol = atol = 2.0 ** -7
        worst = 0.0
        for i in range(len(leaves[0])):
            per = [leaves[r][i].float().cpu().numpy() for r in range(DP_N)]
            if pair:
                per = list(np.stack(per).astype(np.float64).reshape(
                    DP_CROSS, DP_LOCAL, -1).mean(1))
            want = A.adasum_reference(per).reshape(-1)
            got = res[0][i].float().cpu().numpy().astype(np.float64) \
                .reshape(-1)
            tol = rtol * np.abs(want) + atol * np.abs(want).max()
            worst = max(worst, float((np.abs(got - want) / np.maximum(
                tol, 1e-30)).max()))
            if not (np.abs(got - want) <= tol).all():
                raise AssertionError(f"Adasum {name} leaf {i}: beyond rtol "
                                     f"{rtol} / atol {atol} x scale of the "
                                     "float64 reference")
        out[name] = worst
        log(f"[data plane] Adasum {name} over an emulated world of {DP_N}, "
            f"161 ResNet-50 gradient leaves fused per dtype (per-leaf "
            f"segments): every rank bit-identical; within rtol {rtol} / "
            f"atol {atol} x the leaf's scale of the float64 reference "
            f"(largest {worst:.4f} of the tolerance); rank 0's ms before "
            f"each transfer {dict(world.ms[0])}; on {gpu}")
        del leaves, res
    return out


def data_plane_emulated(hvd, torch, model, gpu: str) -> dict:
    """Phase 16a-b on the main path's model's gradients."""
    from horovod_tpu_torch.ops import quantization as Q
    from horovod_tpu_torch.optim import fused_update as TF

    t0 = time.perf_counter()
    prev = os.environ.get("HOROVOD_HIERARCHICAL_ALLREDUCE")
    os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = "1"
    try:
        grads = _resnet_grads(torch, model)
        flats = [torch.cat([g.reshape(-1) for g in gs]) for gs in grads]
        out = {mode: _lossy_pair(Q, torch, flats, mode, gpu)
               for mode in ("int8", "int4")}
        del flats
        weights = [p.detach().clone() for p in model.parameters()]
        out["zero_momentum"] = _zero_pair(torch, "momentum", weights, grads,
                                          gpu)
        del weights
        out["adasum"] = _adasum_world(torch, grads, gpu)
        del grads
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(16)
        shapes = lm_shapes(LM_SEQ)
        weights = [torch.randn(s, device="cuda", generator=gen) * 0.02
                   for s in shapes]
        grads = [[torch.randn(s, device="cuda", generator=gen) * 1e-2
                  for s in shapes] for _ in range(DP_N)]
        out["zero_adam"] = _zero_pair(torch, "adam", weights, grads, gpu)
        del weights, grads
    finally:
        if prev is None:
            os.environ.pop("HOROVOD_HIERARCHICAL_ALLREDUCE", None)
        else:
            os.environ["HOROVOD_HIERARCHICAL_ALLREDUCE"] = prev
        torch.cuda.empty_cache()
    TF.reset_launch_counts()
    log(f"[data plane] phase 16a-b took {time.perf_counter() - t0:.1f} s")
    return out


def data_plane_degenerate(hvd, torch, gpu: str) -> dict:
    """Phase 16c: the main path's ResNet-50 at world 1 over NCCL,
    ``DP_STEPS`` steps each flat (Average), under ``init(mesh="dp:1")``
    and with ``op=Adasum``: losses and weights bit for bit with the flat
    run (deterministic cuDNN), one B1 and 53 of each of N1-N4 per step."""
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import batch_norm as BN
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    cudnn = torch.backends.cudnn
    flags = (cudnn.benchmark, cudnn.deterministic)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    images, labels = synthetic_batch(BATCH, 224, 1000, seed=0)
    out = {}
    try:
        for name, mesh, op in (("flat", None, hvd.Average),
                               ("mesh dp:1", "dp:1", hvd.Average),
                               ("Adasum", None, hvd.Adasum)):
            hvd.shutdown()
            hvd.init(mesh=mesh)
            model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0)
            opt = hvd.DistributedOptimizer(
                hvd.fused_update.sgd(model.parameters(), 0.1, momentum=0.9),
                op=op)
            TF.reset_launch_counts()
            BN.reset_launch_counts()
            losses = [float(train_step(model, opt, images, labels))
                      for _ in range(DP_STEPS)]
            torch.cuda.synchronize()
            launches = {**TF.LAUNCHES, **BN.LAUNCHES}
            want = {"sgd": 0, "momentum": DP_STEPS, "adam": 0,
                    **dict.fromkeys(BN_KERNELS, RESNET50_BN * DP_STEPS)}
            if launches != want:
                raise AssertionError(f"{name}: launches {launches}, expected "
                                     f"{want}")
            out[name] = {"losses": losses, "launches": launches,
                         "weights": [p.detach().clone()
                                     for p in model.parameters()],
                         "axis": str(opt.axis_name)}
            del model, opt
            os.environ.pop("HOROVOD_MESH", None)
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = \
            flags
        os.environ.pop("HOROVOD_MESH", None)
    base = out["flat"]
    for name in ("mesh dp:1", "Adasum"):
        if out[name]["losses"] != base["losses"] or not all(
                torch.equal(a, b) for a, b in zip(out[name]["weights"],
                                                  base["weights"])):
            raise AssertionError(f"{name}: losses or weights differ from the "
                                 "flat Average run's")
    if [out[n]["axis"] for n in out] != ["hvd", "dp", "hvd"]:
        raise AssertionError("the default reduction axis of the three runs "
                             f"is {[out[n]['axis'] for n in out]}")
    for r in out.values():
        del r["weights"]
    log(f"[data plane] ResNet-50 224x224 batch {BATCH} bf16, world 1 over "
        f"NCCL, {DP_STEPS} steps flat, under init(mesh='dp:1') (axis dp) and "
        f"with op=Adasum: losses {base['losses']} and weights equal bit for "
        f"bit; launches per run {base['launches']}; on {gpu}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Tensor and expert parallelism (phase 17): emulated ranks on one card
# ---------------------------------------------------------------------------

MP_STEPS = 3
TP_N, TP_BATCH = 2, 16          # 17a: dp 1 x tp 2, the bench batch
EP_N, EP_BATCH = 4, 4           # 17b: dp = ep = 4, batch 4 per rank
EP_MOE = dict(moe_every=2, experts_per_rank=2)
# 17c: the CPU tests' config (tests/test_torch_model_parallel.py)
MP_SMALL = dict(vocab=64, d_model=32, n_heads=4, head_dim=8, n_layers=4,
                d_ff=64, max_seq=64)
MP_SMALL_BATCH, MP_SMALL_LR = 4, 0.5
# 17a: the losses of two bf16 runs of one function (8.2e-6 apart on an
# H100); the step-1 gradient at phase 15's bf16 LM limit
TP_LOSS_RTOL, LM_GRAD_REL = 1e-3, 0.1
MOE_TOL = dict(rtol=1e-4, atol=1e-5)    # tests/test_pipeline_moe.py:283


def emulated_place(world, r: int, dp: int, tp: int, pp: int = 1):
    """Rank ``r``'s place in an emulated ``make_mesh(dp, pp, tp, 1)`` of
    ``world``: ``place_ranks``'s layout over the world's hops."""
    from horovod_tpu_torch.parallel.mesh import (AXES, HopPair, Place,
                                                 place_ranks)

    h = {name: world.hop(r, ranks, name)
         for name, ranks in place_ranks(r, dp=dp, pp=pp, tp=tp).items()}
    return Place(*(h[a] for a in AXES), HopPair(h["dp"], h["sp"],
                                                h["dp*sp"]))


def _adam_launches(TF, groups) -> int:
    """B3 launches for one step over leaf groups of these sizes."""
    return sum(-(-n // TF.capacity("adam")) for n in groups)


def _mp_world(torch, device: str, n: int, dp: int, tp: int, cfg, params,
              tokens, make_opt, steps: int, counters, collect=None,
              pp: int = 1, memory: bool = False):
    """``steps`` of ``lm_train_step`` with ``lm_optimizer`` on every rank
    of an emulated ``(dp, pp, tp)`` world on ``device`` (the port's own
    functions; the backward runs on each rank's thread).  Returns the
    world, and per rank its losses, coordinate, trained local tree and
    ``collect(model)`` after the first step."""
    from horovod_tpu_torch import interop
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.parallel.emulated import EmulatedWorld
    from horovod_tpu_torch.train_step import (lm_optimizer, lm_train_step,
                                              shard_tokens)

    world = EmulatedWorld(torch, n, counters, sync=device == "cuda",
                          memory=memory)

    def rank(r):
        with torch.autograd.set_multithreading_enabled(False):
            place = emulated_place(world, r, dp, tp, pp)
            model = Transformer(cfg, params=params, device=device,
                                mesh=place)
            opt = lm_optimizer(model, make_opt(model.parameters()))
            d = model.coord()["dp"][0]
            tok, tgt = (shard_tokens(t, dp, 1, d, 0).to(device)
                        for t in tokens)
            losses, got = [], None
            for step in range(steps):
                losses.append(float(lm_train_step(model, opt, tok, tgt)))
                if step == 0 and collect is not None:
                    got = collect(model)
            return {"losses": losses, "coord": model.coord(),
                    "tree": interop.transformer_to_jax(model),
                    "collected": got, "groups": opt.axes}

    return world, world.run(rank)


def _full_grads(cfg, outs, tp: int):
    """Every rank's step-1 gradient joined to the full tree, ``wqkv`` in
    the tp-equivalent layout, flattened in the tree's order."""
    import numpy as np

    from horovod_tpu_torch.interop import transformer_to_jax_full
    from horovod_tpu_torch.models.transformer import tp_equivalent_wqkv

    full = transformer_to_jax_full(
        [(o["coord"], o["collected"]) for o in outs], cfg)
    full["layers"]["wqkv"] = tp_equivalent_wqkv(full["layers"]["wqkv"], tp)
    return _flat_tree(np, full)


def _flat_tree(np, tree) -> "object":
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.append(_flat_tree(np, v) if isinstance(v, dict)
                   else np.asarray(v, np.float32).reshape(-1))
    return np.concatenate(out)


def tensor_parallel_emulated(hvd, torch, gpu: str) -> dict:
    """Phase 17a: the bench LM at an emulated dp 1 x tp 2 on the card
    (batch 16, fused Adam, ``MP_STEPS`` steps) against one rank at tp = 1
    whose ``wqkv`` is ``tp_equivalent_wqkv`` of the same weights."""
    import numpy as np

    from horovod_tpu_torch import interop
    from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                      init_params,
                                                      tp_equivalent_wqkv)
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import lm_train_step, synthetic_tokens

    t0 = time.perf_counter()
    cfg = TransformerConfig(**LM, max_seq=LM_SEQ)
    params = init_params(np.random.RandomState(0), cfg)
    tokens = synthetic_tokens(TP_BATCH, LM_SEQ, cfg.vocab, seed=1,
                              device="cpu")
    # the reference: one rank at tp = 1 computing the tp model's function
    eq = dict(params, layers=dict(params["layers"]))
    eq["layers"]["wqkv"] = tp_equivalent_wqkv(params["layers"]["wqkv"],
                                              TP_N)
    model = Transformer(cfg, params=eq)
    opt = hvd.DistributedOptimizer(hvd.fused_update.adam(
        model.parameters(), 3e-4))
    tok, tgt = (t.cuda() for t in tokens)
    ref_losses = []
    for step in range(MP_STEPS):
        ref_losses.append(float(lm_train_step(model, opt, tok, tgt)))
        if step == 0:
            ref_grad = _flat_tree(np, interop.transformer_to_jax(
                model, grads=True))
    del model, opt, eq
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launch_counts()
    TF.reset_launch_counts()
    world, outs = _mp_world(
        torch, "cuda", TP_N, 1, TP_N, cfg, params, tokens,
        lambda ps: hvd.fused_update.adam(ps, 3e-4), MP_STEPS,
        (FA.LAUNCHES, TF.LAUNCHES),
        collect=lambda m: interop.transformer_to_jax(m, grads=True))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    total = {**FA.LAUNCHES, "adam": TF.LAUNCHES["adam"]}
    want = {k: cfg.n_layers * MP_STEPS for k in FLASH}
    want["adam"] = _adam_launches(TF, [LM_LEAVES]) * MP_STEPS
    for r, o in enumerate(outs):
        got = {k: world.launches[r][k] for k in want}
        if got != want:
            raise AssertionError(f"tp rank {r}: launches {got}, expected "
                                 f"{want}")
        if not all(math.isfinite(x) for x in o["losses"]):
            raise AssertionError(f"tp rank {r}: losses {o['losses']}")
        for a, b in zip(o["losses"], ref_losses):
            if not math.isclose(a, b, rel_tol=TP_LOSS_RTOL):
                raise AssertionError(f"tp rank {r}: losses {o['losses']} vs "
                                     f"tp = 1 equivalent {ref_losses}")
    if total != {k: v * TP_N for k, v in want.items()}:
        raise AssertionError(f"tp: launches over the world {total}")
    grad = _full_grads(cfg, outs, TP_N)
    rel = float(np.linalg.norm(grad.astype(np.float64) - ref_grad)
                / np.linalg.norm(ref_grad.astype(np.float64)))
    if not rel <= LM_GRAD_REL:
        raise AssertionError(f"tp: step-1 gradient {rel} relative L2 from "
                             "the tp = 1 equivalent's")
    wire = [dict(w) for w in world.wire]
    tp_bytes = wire[0].get("tp", 0) / MP_STEPS
    log(f"[mp] 17a tensor parallelism, bench LM at emulated dp 1 x tp "
        f"{TP_N} ({cfg.n_heads // TP_N} heads per rank), batch {TP_BATCH}, "
        f"seq {LM_SEQ}, bf16, fused Adam, {MP_STEPS} steps: losses "
        f"{[o['losses'] for o in outs]}; "
        f"tp = 1 with tp_equivalent_wqkv {ref_losses} (rtol "
        f"{TP_LOSS_RTOL}); step-1 gradient gathered to full {rel:.3e} "
        f"relative L2 (limit {LM_GRAD_REL}); launches per rank per step "
        f"{ {k: v // MP_STEPS for k, v in want.items()} }; all-reduce "
        f"bytes per tensor rank per step {tp_bytes:.0f} "
        f"({wire[0]}); peak memory of both emulated ranks {peak} B "
        f"({peak / 2**30:.2f} GiB); rank 0's ms before each transfer, "
        f"summed {sum(world.ms[0].values()):.1f}; "
        f"{time.perf_counter() - t0:.1f} s; on {gpu}")
    # what rank 0 counted (each rank's equals ``want``, checked above)
    return {"launches": {k: world.launches[0][k] for k in want},
            "losses": [o["losses"] for o in outs],
            "ref_losses": ref_losses, "grad_rel": rel, "peak_bytes": peak,
            "tp_bytes_per_step": tp_bytes}


def _first_moe_check(torch, world, params, cfg, gpu: str) -> dict:
    """Phase 17b, the layer: ``moe_layer`` on every emulated rank (its
    own 4,096 float32 tokens, the LM's first MoE weights, its two experts)
    against ``moe_reference`` over all eight experts."""
    from horovod_tpu_torch.parallel.moe import moe_layer, moe_reference, route

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        w = {k: torch.from_numpy(params["moe"][k][0]).cuda()
             for k in ("router", "w_in", "w_out")}
        el = cfg.experts_per_rank
        t = EP_BATCH * LM_SEQ
        gen = torch.Generator(device="cuda").manual_seed(17)
        xs = [torch.randn(t, cfg.d_model, device="cuda", generator=gen)
              for _ in range(EP_N)]

        def rank(r):
            place = emulated_place(world, r, EP_N, 1)
            out, aux = moe_layer(xs[r], w["router"],
                                 w["w_in"][r * el:(r + 1) * el],
                                 w["w_out"][r * el:(r + 1) * el], place.dp)
            return out, float(aux)

        outs = world.run(rank)
        worst, margins, kept = 0.0, [], []
        for r, (out, aux) in enumerate(outs):
            ref = moe_reference(xs[r], w["router"], w["w_in"], w["w_out"])
            torch.testing.assert_close(out, ref, **MOE_TOL,
                                       msg=lambda m: f"moe rank {r}: {m}")
            worst = max(worst, float((out - ref).abs().max()))
            gates, _, _, _, _, keep, _ = route(xs[r], w["router"])
            top2 = gates.topk(2, dim=-1).values
            margins.append(float((top2[:, 0] - top2[:, 1]).min()))
            kept.append(int(keep.any(-1).sum()))
            if not math.isfinite(aux):
                raise AssertionError(f"moe rank {r}: aux {aux}")
        log(f"[mp] 17b first MoE layer at {t} f32 tokens per rank, "
            f"{EP_N} x {el} experts: every rank's moe_layer within rtol "
            f"{MOE_TOL['rtol']} / atol {MOE_TOL['atol']} of moe_reference "
            f"over all experts (largest difference {worst:.3e}); tokens "
            f"kept per rank {kept}; smallest top-1 gate margin per rank "
            f"{[f'{m:.2e}' for m in margins]}; on {gpu}")
        return {"max_abs_err": worst, "margins": margins}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def expert_parallel_emulated(hvd, torch, gpu: str) -> dict:
    """Phase 17b: the bench LM with a Switch-MoE MLP every second layer
    (2 experts per rank) at an emulated dp = ep = 4 on the card (batch 4
    per rank, fused Adam, ``MP_STEPS`` steps); the first MoE layer
    against ``moe_reference``."""
    import numpy as np

    from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                      init_params)
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.parallel.emulated import EmulatedWorld
    from horovod_tpu_torch.train_step import synthetic_tokens

    t0 = time.perf_counter()
    cfg = TransformerConfig(**LM, max_seq=LM_SEQ, **EP_MOE)
    params = init_params(np.random.RandomState(0), cfg, ep=EP_N)
    layer = _first_moe_check(torch, EmulatedWorld(torch, EP_N), params,
                             cfg, gpu)
    tokens = synthetic_tokens(EP_N * EP_BATCH, LM_SEQ, cfg.vocab, seed=1,
                              device="cpu")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launch_counts()
    TF.reset_launch_counts()
    world, outs = _mp_world(
        torch, "cuda", EP_N, EP_N, 1, cfg, params, tokens,
        lambda ps: hvd.fused_update.adam(ps, 3e-4), MP_STEPS,
        (FA.LAUNCHES, TF.LAUNCHES))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    n_moe = cfg.n_layers // cfg.moe_every
    want = {k: cfg.n_layers * MP_STEPS for k in FLASH}
    # ("dp", "sp"): every leaf but the experts; ("sp",): the experts
    want["adam"] = _adam_launches(TF, [LM_LEAVES + n_moe,
                                       2 * n_moe]) * MP_STEPS
    for r, o in enumerate(outs):
        got = {k: world.launches[r][k] for k in want}
        if got != want:
            raise AssertionError(f"ep rank {r}: launches {got}, expected "
                                 f"{want}")
        if not all(math.isfinite(x) for x in o["losses"]):
            raise AssertionError(f"ep rank {r}: losses {o['losses']}")
        if o["losses"] != outs[0]["losses"]:
            raise AssertionError(f"ep rank {r}: the global loss differs "
                                 f"from rank 0's: {o['losses']}")
        if [tuple(a) for a in o["groups"]] != [("dp", "sp"), ("sp",)]:
            raise AssertionError(f"ep rank {r}: groups {o['groups']}")
    total = {**FA.LAUNCHES, "adam": TF.LAUNCHES["adam"]}
    if total != {k: v * EP_N for k, v in want.items()}:
        raise AssertionError(f"ep: launches over the world {total}")
    wire = dict(world.wire[0])
    log(f"[mp] 17b expert parallelism, bench LM + MoE every 2nd layer at "
        f"emulated dp = ep = {EP_N} ({EP_N * cfg.experts_per_rank} "
        f"experts, 2 per rank), batch {EP_BATCH} per rank (cut from 16), "
        f"bf16, fused Adam, {MP_STEPS} steps: global losses "
        f"{outs[0]['losses']} (equal on every rank); launches per rank per "
        f"step { {k: v // MP_STEPS for k, v in want.items()} } (B3 once "
        f"per reduction group); rank 0's payload bytes per step "
        f"{ {k: v / MP_STEPS for k, v in wire.items()} }; peak memory of "
        f"the four emulated ranks {peak} B ({peak / 2**30:.2f} GiB); "
        f"{time.perf_counter() - t0:.1f} s; on {gpu}")
    return {"launches": {k: world.launches[0][k] for k in want},
            "losses": outs[0]["losses"], "peak_bytes": peak, "layer": layer}


def small_mp_reference(hvd, torch, gpu: str) -> dict:
    """Phase 17c: the CPU tests' small LM (float32, SGD lr 0.5) at an
    emulated tp 2, then dp = ep 2 with MoE layers, 3 steps on the card
    (kernels) and on the CPU (plain versions) from the same weights and
    batch: losses within rtol 1e-4, weights within 1e-4 of each tensor's
    largest magnitude (TF32 off)."""
    import numpy as np

    from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                      init_params)
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import synthetic_tokens

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    try:
        for name, dp, tp, moe in (("tp2", 1, 2, 0), ("moe ep2", 2, 1, 2)):
            cfg = TransformerConfig(**MP_SMALL, dtype="float32",
                                    moe_every=moe)
            params = init_params(np.random.RandomState(0), cfg, ep=dp)
            tokens = synthetic_tokens(MP_SMALL_BATCH, MP_SMALL["max_seq"],
                                      cfg.vocab, seed=1, device="cpu")
            runs = {}
            for dev in ("cuda", "cpu"):
                FA.reset_launch_counts()
                TF.reset_launch_counts()
                world, outs = _mp_world(
                    torch, dev, 2, dp, tp, cfg, params, tokens,
                    lambda ps: hvd.fused_update.sgd(ps, MP_SMALL_LR),
                    MP_STEPS, (FA.LAUNCHES, TF.LAUNCHES))
                runs[dev] = (outs, [dict(w) for w in world.launches])
            worst = 0.0
            for r, (g, c) in enumerate(zip(runs["cuda"][0], runs["cpu"][0])):
                for a, b in zip(g["losses"], c["losses"]):
                    if not math.isclose(a, b, rel_tol=1e-4):
                        raise AssertionError(
                            f"small {name} rank {r}: card losses "
                            f"{g['losses']} vs CPU {c['losses']}")
                a, b = _flat_tree(np, g["tree"]), _flat_tree(np, c["tree"])
                worst = max(worst, float(np.abs(a - b).max())
                            / float(np.abs(b).max()))
                _trees_within(g["tree"], c["tree"], 1e-4,
                              f"small {name} rank {r}")
            want = {k: cfg.n_layers * MP_STEPS for k in FLASH}
            want["sgd"] = (2 if moe else 1) * MP_STEPS
            for r, counts in enumerate(runs["cuda"][1]):
                got = {k: counts.get(k, 0) for k in want}
                if got != want:
                    raise AssertionError(f"small {name} rank {r}: card "
                                         f"launches {got}, expected {want}")
            log(f"[mp] 17c small LM {name} (float32, SGD {MP_SMALL_LR}, "
                f"{MP_STEPS} steps, emulated dp {dp} x tp {tp}): card and "
                f"CPU agree (losses {runs['cuda'][0][0]['losses']} vs "
                f"{runs['cpu'][0][0]['losses']}; worst weight error "
                f"{worst:.2e} of the largest magnitude; rtol 1e-4 loss, 1e-4 "
                f"weights); card launches per rank {want}; on {gpu}")
            res[name] = {"launches": {k: runs["cuda"][1][0].get(k, 0)
                                      for k in want}, "worst": worst}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return res


def _trees_within(a: dict, b: dict, tol: float, what: str) -> None:
    """Every leaf of ``a`` within ``tol`` of the largest magnitude of the
    same leaf of ``b``."""
    import numpy as np

    for k, v in b.items():
        if isinstance(v, dict):
            _trees_within(a[k], v, tol, f"{what} {k}")
            continue
        x, y = np.asarray(a[k], np.float32), np.asarray(v, np.float32)
        err = float(np.abs(x - y).max())
        if err > tol * max(float(np.abs(y).max()), 1e-30):
            raise AssertionError(f"{what} {k}: differs by {err}, over {tol} "
                                 "of its largest magnitude")


def model_parallel(hvd, torch, gpu: str) -> dict:
    """Phase 17 (a-c)."""
    t0 = time.perf_counter()
    out = {"tp": tensor_parallel_emulated(hvd, torch, gpu)}
    torch.cuda.empty_cache()
    out["ep"] = expert_parallel_emulated(hvd, torch, gpu)
    torch.cuda.empty_cache()
    out["small"] = small_mp_reference(hvd, torch, gpu)
    log(f"[mp] phase 17 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Pipeline parallelism (phase 18): emulated pp ranks on one card
# ---------------------------------------------------------------------------

PP_N, PP_BATCH, PP_STEPS = 2, 16, 3   # 18a-c: pp 2, the bench batch
PP_MICRO = 2                          # pp_microbatches
PP_VIRTUAL = 2                        # 18b: chunks per rank
# 18a: the step-1 loss against pp = 1; the layer gradient against pp
# times pp = 1's (the reference's factor: its psum's backward sums the
# cotangents over pp) at phase 15's bf16 LM limit; 18b: the losses
# against 18a's (tests/test_transformer.py:115)
PP_LOSS_RTOL, PP_SCHEDULE_RTOL = 1e-3, 2e-2


def _pp_reference(hvd, torch, cfg, params, tokens) -> tuple:
    """One card at pp = 1: the step-1 loss and gradient (the full tree,
    numpy) of the bench LM with fused Adam."""
    from horovod_tpu_torch import interop
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.train_step import lm_train_step

    model = Transformer(cfg, params=params)
    opt = hvd.DistributedOptimizer(hvd.fused_update.adam(
        model.parameters(), 3e-4))
    tok, tgt = (t.cuda() for t in tokens)
    loss = float(lm_train_step(model, opt, tok, tgt))
    grads = interop.transformer_to_jax(model, grads=True)
    del model, opt
    torch.cuda.empty_cache()
    return loss, grads


def _pp_run(hvd, torch, cfg, params, tokens, counters, tag: str) -> dict:
    """``PP_STEPS`` steps of the bench LM at an emulated pp = ``PP_N``
    with fused Adam: the world, each rank's results (the step-1 gradient
    collected), the launches each rank counted per step, each rank's
    peak memory and payload bytes per step over the pp hop."""
    from horovod_tpu_torch import interop
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.optim import fused_update as TF

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launch_counts()
    TF.reset_launch_counts()
    t0 = time.perf_counter()
    world, outs = _mp_world(
        torch, "cuda", PP_N, 1, 1, cfg, params, tokens,
        lambda ps: hvd.fused_update.adam(ps, 3e-4), PP_STEPS, counters,
        collect=lambda m: interop.transformer_to_jax(m, grads=True),
        pp=PP_N, memory=True)
    torch.cuda.synchronize()
    res = {"world": world, "outs": outs, "seconds": time.perf_counter() - t0,
           "launches": [{k: world.launches[r][k] // PP_STEPS
                         for k in (*FLASH, "adam")} for r in range(PP_N)],
           "peak": list(world.peak),
           "wire": [world.wire[r]["pp"] / PP_STEPS for r in range(PP_N)],
           "calls": [{k: v // PP_STEPS for k, v in world.calls[r].items()}
                     for r in range(PP_N)]}
    for r, o in enumerate(outs):
        if not all(math.isfinite(x) for x in o["losses"]):
            raise AssertionError(f"{tag} rank {r}: losses {o['losses']}")
    return res


def _pp_grads(cfg, outs) -> dict:
    """The step-1 gradient joined from every stage (the full tree in
    storage order; the replicated leaves the last stage's)."""
    from horovod_tpu_torch.interop import transformer_to_jax_full

    return transformer_to_jax_full(
        [(o["coord"], o["collected"]) for o in outs], cfg)


def _rel(a: dict, b: dict) -> float:
    """The relative L2 distance of tree ``a`` from tree ``b``."""
    import numpy as np

    x, y = (_flat_tree(np, t).astype(np.float64) for t in (a, b))
    return float(np.linalg.norm(x - y) / np.linalg.norm(y))


def _hold_pp_launches(res: dict, want: dict, tag: str) -> None:
    for r, got in enumerate(res["launches"]):
        if got != want:
            raise AssertionError(f"{tag} rank {r}: launches per step {got},"
                                 f" expected {want}")


def pipeline_parallel(hvd, torch, gpu: str) -> dict:
    """Phase 18 (a-d): the bench LM at an emulated pp = 2 (GPipe, the
    interleaved schedule, ``pp_remat``) against one card at pp = 1 and
    against each other, and the small LM on the card against the CPU."""
    import dataclasses

    import numpy as np

    from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                      init_params,
                                                      storage_order)
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.parallel.pipeline import interleaved_schedule
    from horovod_tpu_torch.train_step import synthetic_tokens

    t0 = time.perf_counter()
    counters = (FA.LAUNCHES, TF.LAUNCHES)
    cfg = TransformerConfig(**LM, max_seq=LM_SEQ, pp_microbatches=PP_MICRO)
    params = init_params(np.random.RandomState(0), cfg)
    tokens = synthetic_tokens(PP_BATCH, LM_SEQ, cfg.vocab, seed=1,
                              device="cpu")
    ref_loss, ref_grads = _pp_reference(hvd, torch, cfg, params, tokens)
    twice = {k: PP_N * v for k, v in ref_grads["layers"].items()}
    per_stage = cfg.n_layers // PP_N
    adam = _adam_launches(TF, [3 + 6 * per_stage])
    want = dict.fromkeys(FLASH, per_stage * PP_MICRO) | {"adam": adam}
    mb_bytes = (PP_BATCH // PP_MICRO) * LM_SEQ * cfg.d_model * 2   # bf16
    out_bytes = PP_BATCH * LM_SEQ * cfg.d_model * 2
    # stage 0 sends each microbatch's activations, stage 1 each one's
    # gradient back; the broadcast all-reduces the (B, L, d) result
    # forward and its cotangent backward
    want_wire = PP_MICRO * mb_bytes + 2 * out_bytes

    # (a) GPipe
    a = _pp_run(hvd, torch, cfg, params, tokens, counters, "18a")
    _hold_pp_launches(a, want, "18a gpipe")
    for r, o in enumerate(a["outs"]):
        if not math.isclose(o["losses"][0], ref_loss, rel_tol=PP_LOSS_RTOL):
            raise AssertionError(f"18a rank {r}: step-1 loss "
                                 f"{o['losses'][0]} vs pp = 1 {ref_loss}")
    if a["wire"] != [want_wire] * PP_N:
        raise AssertionError(f"18a: bytes per step over pp {a['wire']}, "
                             f"expected {want_wire}")
    a_grads = _pp_grads(cfg, a["outs"])
    rel_a = _rel(a_grads["layers"], twice)
    rel_a1 = _rel(a_grads["layers"], ref_grads["layers"])
    if not rel_a <= LM_GRAD_REL:
        raise AssertionError(f"18a: step-1 layer gradient {rel_a} relative "
                             f"L2 from {PP_N} x pp = 1's")
    log(f"[pp] 18a GPipe, bench LM at emulated pp {PP_N} ({per_stage} "
        f"layers per stage, {PP_MICRO} microbatches of "
        f"{PP_BATCH // PP_MICRO} rows), seq {LM_SEQ}, bf16, fused Adam, "
        f"{PP_STEPS} steps: losses per rank "
        f"{[o['losses'] for o in a['outs']]}; pp = 1 step-1 loss "
        f"{ref_loss} (rtol {PP_LOSS_RTOL}); step-1 layer gradient joined "
        f"from both stages {rel_a:.3e} relative L2 from {PP_N} x pp = 1's "
        f"(limit {LM_GRAD_REL}; {rel_a1:.3e} from 1 x); launches per rank "
        f"per step {a['launches']}; transfers per rank per step "
        f"{a['calls']}; payload bytes per rank per step over pp "
        f"{a['wire']} (reckoned {PP_MICRO} x {mb_bytes} + 2 x {out_bytes});"
        f" peak memory per rank {a['peak']} B "
        f"({[round(p / 2**30, 2) for p in a['peak']]} GiB); "
        f"{a['seconds']:.1f} s; on {gpu}")

    # (b) the interleaved schedule, storage in the permuted order
    cfg_b = dataclasses.replace(cfg, pp_schedule="interleaved",
                                pp_virtual=PP_VIRTUAL)
    steps = interleaved_schedule(PP_N, PP_VIRTUAL, PP_MICRO)[0]
    if steps != PP_MICRO * PP_VIRTUAL + PP_N - 1:
        raise AssertionError(f"18b: the schedule takes {steps} steps")
    b = _pp_run(hvd, torch, cfg_b, params, tokens, counters, "18b")
    _hold_pp_launches(b, want, "18b interleaved")
    for r, (ob, oa) in enumerate(zip(b["outs"], a["outs"])):
        for x, y in zip(ob["losses"], oa["losses"]):
            if not math.isclose(x, y, rel_tol=PP_SCHEDULE_RTOL):
                raise AssertionError(f"18b rank {r}: losses {ob['losses']}"
                                     f" vs gpipe {oa['losses']}")
    rel_b = _rel(_pp_grads(cfg_b, b["outs"]),
                 storage_order(a_grads, cfg_b, PP_N))
    if not rel_b <= LM_GRAD_REL:
        raise AssertionError(f"18b: step-1 gradient {rel_b} relative L2 "
                             "from GPipe's (storage order)")
    log(f"[pp] 18b interleaved, pp_virtual {PP_VIRTUAL} "
        f"({cfg.n_layers // (PP_N * PP_VIRTUAL)} layers per chunk, "
        f"{steps} schedule steps = M*V + P - 1): losses per rank "
        f"{[o['losses'] for o in b['outs']]} (rtol {PP_SCHEDULE_RTOL} of "
        f"18a's); step-1 gradient {rel_b:.3e} relative L2 from 18a's in "
        f"the permuted storage order; launches per rank per step "
        f"{b['launches']}; transfers per rank per step {b['calls']}; "
        f"payload bytes per rank per step over pp {b['wire']}; peak memory "
        f"per rank {b['peak']} B; {b['seconds']:.1f} s; on {gpu}")

    # (c) pp_remat on (a)
    cfg_c = dataclasses.replace(cfg, pp_remat=True)
    c = _pp_run(hvd, torch, cfg_c, params, tokens, counters, "18c")
    _hold_pp_launches(c, dict(want, flash_block_step=2 * per_stage
                              * PP_MICRO), "18c remat")
    rel_c = _rel(_pp_grads(cfg, c["outs"]), a_grads)
    if not rel_c <= LM_GRAD_REL:
        raise AssertionError(f"18c: step-1 gradient {rel_c} relative L2 "
                             "from 18a's")
    log(f"[pp] 18c pp_remat: losses per rank "
        f"{[o['losses'] for o in c['outs']]}; step-1 gradient "
        f"{rel_c:.3e} relative L2 from 18a's; launches per rank per step "
        f"{c['launches']}; peak memory per rank {c['peak']} B "
        f"({[round(p / 2**30, 2) for p in c['peak']]} GiB) against 18a's "
        f"{a['peak']} B; {c['seconds']:.1f} s; on {gpu}")
    res = {"a": a, "b": b, "c": c}
    for k in res:
        res[k] = {"launches": res[k]["launches"][0], "peak": res[k]["peak"],
                  "wire": res[k]["wire"], "losses": [
                      o["losses"] for o in res[k]["outs"]]}
    res.update(ref_loss=ref_loss, grad_rel={"a": rel_a, "b": rel_b,
                                            "c": rel_c})
    torch.cuda.empty_cache()
    res["d"] = small_pp_reference(hvd, torch, gpu)
    log(f"[pp] phase 18 took {time.perf_counter() - t0:.1f} s")
    return res


def small_pp_reference(hvd, torch, gpu: str) -> dict:
    """Phase 18d: the CPU tests' small LM (float32, SGD lr 0.5) at an
    emulated pp 2 under GPipe and the interleaved schedule (2 chunks of
    one layer per rank), 3 steps on the card (kernels) and on the CPU
    (plain versions) from the same weights and batch: every rank's
    losses within rtol 1e-4 and weights within 1e-4 of each tensor's
    largest magnitude (TF32 off)."""
    import numpy as np

    from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                      init_params)
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import synthetic_tokens

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    try:
        for name, fields in (("gpipe", {}),
                             ("interleaved", dict(pp_schedule="interleaved",
                                                  pp_virtual=2))):
            cfg = TransformerConfig(**MP_SMALL, dtype="float32", **fields)
            params = init_params(np.random.RandomState(0), cfg)
            tokens = synthetic_tokens(MP_SMALL_BATCH, MP_SMALL["max_seq"],
                                      cfg.vocab, seed=1, device="cpu")
            runs = {}
            for dev in ("cuda", "cpu"):
                FA.reset_launch_counts()
                TF.reset_launch_counts()
                world, outs = _mp_world(
                    torch, dev, PP_N, 1, 1, cfg, params, tokens,
                    lambda ps: hvd.fused_update.sgd(ps, MP_SMALL_LR),
                    MP_STEPS, (FA.LAUNCHES, TF.LAUNCHES), pp=PP_N)
                runs[dev] = (outs, [dict(w) for w in world.launches])
            worst = 0.0
            for r, (g, c) in enumerate(zip(runs["cuda"][0], runs["cpu"][0])):
                for x, y in zip(g["losses"], c["losses"]):
                    if not math.isclose(x, y, rel_tol=1e-4):
                        raise AssertionError(
                            f"small pp {name} rank {r}: card losses "
                            f"{g['losses']} vs CPU {c['losses']}")
                x, y = _flat_tree(np, g["tree"]), _flat_tree(np, c["tree"])
                worst = max(worst, float(np.abs(x - y).max())
                            / float(np.abs(y).max()))
                _trees_within(g["tree"], c["tree"], 1e-4,
                              f"small pp {name} rank {r}")
            per = cfg.n_layers // PP_N * cfg.pp_microbatches
            want = {k: per * MP_STEPS for k in FLASH}
            want["sgd"] = MP_STEPS
            for r, counts in enumerate(runs["cuda"][1]):
                got = {k: counts.get(k, 0) for k in want}
                if got != want:
                    raise AssertionError(f"small pp {name} rank {r}: card "
                                         f"launches {got}, expected {want}")
            log(f"[pp] 18d small LM pp {PP_N} {name} (float32, SGD "
                f"{MP_SMALL_LR}, {MP_STEPS} steps): card and CPU agree on "
                f"every rank (rank 0 losses {runs['cuda'][0][0]['losses']} "
                f"vs {runs['cpu'][0][0]['losses']}; worst weight error "
                f"{worst:.2e} of the largest magnitude; rtol 1e-4 loss, "
                f"1e-4 weights); card launches per rank {want}; on {gpu}")
            res[name] = {"launches": {k: runs["cuda"][1][0].get(k, 0)
                                      for k in want}, "worst": worst}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return res


# ---------------------------------------------------------------------------
# Local SGD / DiLoCo (phase 19): the bench step over an emulated world
# ---------------------------------------------------------------------------

LS_H, LS_STEPS = 2, 4
LS_LR, LS_MU = 0.7, 0.9                 # HOROVOD_OUTER_LR / _MOMENTUM
#: 19a's cases: (zero_stage, outer wire)
LS_CASES = ((0, "none"), (0, "int8"), (0, "int4"), (2, "none"),
            (2, "int8"), (2, "int4"))
LS_CODEC = {"none": (), "int8": ("quantize", "dequantize"),
            "int4": ("pack4", "unpack4")}
#: 19b: SmallCNN, float32, batch and image size per emulated rank
LS_SMALL_BATCH, LS_SMALL_SIZE, LS_SMALL_TOL = 16, 32, 1e-5


def ls_cross_bytes(stage: int, wire: str) -> int:
    """The bytes one rank sends over the cross hop per outer sync: the
    whole fused delta at stage 0, its local shard at stage 2 (the buffer
    padded to a multiple of the local size); float32, or the int8
    payload (int4: packed two per byte) in blocks of ``QBLOCK`` plus one
    float32 scale per block (the scales' ``max``)."""
    n = -(-N_PARAMS // DP_LOCAL) if stage else N_PARAMS
    if wire == "none":
        return 4 * n
    nb = -(-n // QBLOCK)
    return nb * QBLOCK // (1 if wire == "int8" else 2) + 4 * nb


def _ulp32(torch, x):
    x = x.float().abs()
    return (torch.nextafter(x, torch.full_like(x, math.inf)) - x).double()


def _hold_sync(Q, torch, pre, post, r: int, k: int, wire: str) -> float:
    """Sync ``k`` of rank ``r`` against float64: the new anchor within
    the float32 rounding of the outer step (two ulps of the result, and
    four ulps of each delta's operands through ``lr * (1 + mu + mu^2)``)
    plus, on a lossy wire, half a quantization step of the block (and
    the rounding of ``x / scale``) through ``lr * (1 + mu)`` (the cross
    sum is within ``nc * scale / 2``);
    returns the largest share of the tolerance used."""
    l_ = r % DP_LOCAL
    partners = [c * DP_LOCAL + l_ for c in range(DP_CROSS)]
    red = 0.0
    e = None
    deltas32 = []
    for q in partners:
        a, v, res, p = pre[q][k]
        d = a.double() - p.double()
        d32 = a.float() - p.float()
        if res is not None:
            d = d + res.double()
            d32 = d32 + res
        deltas32.append(d32)
        red = red + d
        u = _ulp32(torch, torch.maximum(a.float().abs(), p.float().abs()))
        e = u if e is None else torch.maximum(e, u)
        del d
    red = red / DP_CROSS
    a, v, _, _ = pre[r][k]
    v = LS_MU * v.double() + red
    ref = a.double() - LS_LR * (red + LS_MU * v)
    tol = 2 * _ulp32(torch, ref) + LS_LR * (1 + LS_MU + LS_MU ** 2) * 4 * e
    if wire != "none":
        qmax = (Q.sum_safe_qmax if wire == "int8" else Q.sum_safe_qmax4)(
            DP_CROSS)
        amax = torch.stack([Q.block_absmax(Q._to_blocks(d, QBLOCK)[0])
                            for d in deltas32]).amax(0)
        s = Q._scales(amax, qmax).double()
        # half a step, and the float32 rounding of x / scale (a
        # relative 2^-23 of values up to qmax)
        tol = tol + LS_LR * (1 + LS_MU) * torch.repeat_interleave(
            s * (0.5 + qmax * 2.0 ** -22), QBLOCK)[:ref.numel()]
    err = (post[r][k].double() - ref).abs()
    worst = float((err / tol).max())
    if worst > 1:
        raise AssertionError(f"local SGD {wire} rank {r} sync {k + 1}: the "
                             f"new anchor is {worst:.3f} of its tolerance "
                             "from the float64 recomputation")
    return worst


def _ls_case(hvd, Q, TF, torch, models, batches, stage: int, wire: str,
             base=None) -> dict:
    """One 19a case: every emulated rank runs ``LS_STEPS`` inner steps of
    ``train_step`` under ``LocalSGD`` over its (cross, local) pair and
    ``maybe_outer_sync`` after each; returns what the checks read."""
    from horovod_tpu_torch.parallel.emulated import EmulatedWorld
    from horovod_tpu_torch.train_step import train_step

    world = EmulatedWorld(torch, DP_N, (TF.LAUNCHES, Q.LAUNCHES))
    flat = [[] for _ in range(DP_N)]       # weights after each step / sync
    pre = [[] for _ in range(DP_N)]
    post = [[] for _ in range(DP_N)]
    inner_ms = [[] for _ in range(DP_N)]
    sync_ms = [[] for _ in range(DP_N)]

    def weights(m):
        return torch.cat([p.detach().reshape(-1) for p in m.parameters()])

    def rank(r):
        m = models[r]
        opt = hvd.LocalSGD(
            hvd.fused_update.sgd(m.parameters(), 0.1, momentum=0.9), h=LS_H,
            axis_name=world.pair(r, DP_LOCAL), zero_stage=stage,
            compression=hvd.Compression.lookup(wire))
        x, y = batches[r]
        losses = []
        for step in range(1, LS_STEPS + 1):
            t = world.busy_ms(r)
            with torch.autograd.set_multithreading_enabled(False):
                losses.append(train_step(m, opt, x, y))
            inner_ms[r].append(world.busy_ms(r) - t)
            flat[r].append(weights(m))
            if opt.should_sync(step):
                o = opt.outer
                pre[r].append((o.anchor[0].clone(), o.velocity[0].clone(),
                               None if o.residual is None
                               else o.residual[0].clone(),
                               opt._current_bufs()[0].clone()))
                t = world.busy_ms(r)
                opt.maybe_outer_sync(step)
                sync_ms[r].append(world.busy_ms(r) - t)
                post[r].append(o.anchor[0].clone())
                flat[r].append(weights(m))
        return [float(x) for x in losses], opt.outer_state_bytes()

    TF.reset_launch_counts()
    Q.reset_launch_counts()
    outs = world.run(rank)
    what = f"local SGD stage {stage} {wire}"
    # every rank's weights: one slice's ranks equal after each inner
    # step, all four after each sync
    k = 0
    for step in range(1, LS_STEPS + 1):
        for c in range(DP_CROSS):
            a, b = (flat[c * DP_LOCAL + l_][k] for l_ in range(DP_LOCAL))
            if not torch.equal(a, b):
                raise AssertionError(f"{what} step {step}: the ranks of "
                                     f"slice {c} differ")
        k += 1
        if step % LS_H == 0:
            if not all(torch.equal(flat[r][k], flat[0][k])
                       for r in range(DP_N)):
                raise AssertionError(f"{what} sync after step {step}: the "
                                     "four ranks differ")
            k += 1
    if base is not None:
        for r in range(DP_N):
            if not all(torch.equal(a, b) for a, b in zip(flat[r], base[r])):
                raise AssertionError(f"{what} rank {r}: not bit for bit "
                                     "stage 0's weights")
    worst = max(_hold_sync(Q, torch, pre, post, r, j, wire)
                for r in range(DP_N) for j in range(len(pre[r])))
    del pre, post
    syncs = LS_STEPS // LS_H
    want = {"momentum": LS_STEPS}
    if wire != "none":
        enc, dec = LS_CODEC[wire]
        want.update({enc: syncs, dec: 2 * syncs})
    cross = ls_cross_bytes(stage, wire)
    for r in range(DP_N):
        if dict(world.launches[r]) != want:
            raise AssertionError(f"{what} rank {r}: launches "
                                 f"{dict(world.launches[r])}, expected "
                                 f"{want}")
        if world.wire[r]["cross"] != syncs * cross:
            raise AssertionError(f"{what} rank {r}: {world.wire[r]['cross']}"
                                 f" B over the cross hop, expected {syncs} x "
                                 f"{cross}")
    losses = [o[0] for o in outs]
    if not all(math.isfinite(v) for ls in losses for v in ls):
        raise AssertionError(f"{what}: losses {losses}")
    return {"flat": flat if base is None and wire == "none" else None,
            "losses": losses, "outer_bytes": [o[1] for o in outs],
            "launches": [dict(x) for x in world.launches],
            "cross_bytes": [world.wire[r]["cross"] for r in range(DP_N)],
            "local_bytes": [world.wire[r]["local"] for r in range(DP_N)],
            "inner_ms": [statistics.median(x[1:]) for x in inner_ms],
            "sync_ms": [statistics.median(x) for x in sync_ms],
            "worst": worst}


def local_sgd_emulated(hvd, torch, gpu: str, model_fn=None,
                       batch: int = BATCH, size: int = 224,
                       classes: int = 1000) -> dict:
    """Phase 19a: the bench step (ResNet-50 224 px, batch 256 per rank,
    bf16, fused momentum SGD) under ``LocalSGD`` at H = 2 over an
    emulated (cross 2, local 2) world, 4 inner steps per case, the
    cases of ``LS_CASES``; deterministic cuDNN (stage 2 must equal stage
    0 bit for bit)."""
    import copy

    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import quantization as Q
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import synthetic_batch

    t0 = time.perf_counter()
    cudnn = torch.backends.cudnn
    flags = (cudnn.benchmark, cudnn.deterministic)
    cudnn.benchmark, cudnn.deterministic = False, True
    out = {}
    try:
        if model_fn is None:
            def model_fn():
                return ResNet50(num_classes=classes, dtype=torch.bfloat16,
                                seed=0)
        models = [model_fn()]
        models += [copy.deepcopy(models[0]) for _ in range(DP_N - 1)]
        init = [t.detach().clone() for t in models[0].state_dict().values()]
        batches = [synthetic_batch(batch, size, classes, seed=100 + r)
                   for r in range(DP_N)]
        base = None
        for stage, wire in LS_CASES:
            for m in models:
                with torch.no_grad():
                    for t, v in zip(m.state_dict().values(), init):
                        t.copy_(v)
            res = _ls_case(hvd, Q, TF, torch, models, batches, stage, wire,
                           base=base if (stage, wire) == (2, "none")
                           else None)
            if (stage, wire) == (0, "none"):
                base = res["flat"]
            res.pop("flat")
            out[f"stage {stage} {wire}"] = res
            log(f"[local sgd] 19a stage {stage} {wire}: {LS_STEPS} inner "
                f"steps, syncs after steps {LS_H} and {2 * LS_H}; the ranks "
                f"of a slice bit-identical after every inner step, all four "
                f"after every sync"
                + ("; bit for bit stage 0's weights"
                   if (stage, wire) == (2, "none") else "")
                + f"; new anchors within {res['worst']:.6f} of the tolerance "
                f"of the float64 recomputation; launches per rank "
                f"{res['launches'][0]}; cross bytes per rank per sync "
                f"{res['cross_bytes'][0] // (LS_STEPS // LS_H)} (reckoned "
                f"{ls_cross_bytes(stage, wire)}), local bytes per rank over "
                f"the run {res['local_bytes'][0]}; outer state "
                f"{res['outer_bytes'][0]} B per rank; per-rank ms of work "
                f"alone: inner step {[round(x, 4) for x in res['inner_ms']]}"
                f", sync {[round(x, 4) for x in res['sync_ms']]}; losses "
                f"rank 0 {res['losses'][0]}; on {gpu}")
        del base, models, batches, init
    finally:
        cudnn.benchmark, cudnn.deterministic = flags
        torch.cuda.empty_cache()
    log(f"[local sgd] phase 19a took {time.perf_counter() - t0:.1f} s")
    return out


def small_local_sgd_reference(hvd, torch, gpu: str) -> dict:
    """Phase 19b: SmallCNN (float32, TF32 off) under ``LocalSGD`` at
    stage 0 on the int8 outer wire, H = 2, 4 steps, over the emulated
    (cross 2, local 2) world on the card (kernels) and on the CPU (plain
    versions), each rank its own batch: losses within rtol 1e-4 and
    weights within ``LS_SMALL_TOL`` of each tensor's largest magnitude."""
    from horovod_tpu_torch.models.mnist import SmallCNN
    from horovod_tpu_torch.ops import quantization as Q
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.parallel.emulated import EmulatedWorld
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    try:
        for dev in ("cuda", "cpu"):
            world = EmulatedWorld(torch, DP_N, (TF.LAUNCHES, Q.LAUNCHES),
                                  sync=dev == "cuda")
            batches = [synthetic_batch(LS_SMALL_BATCH, LS_SMALL_SIZE, 10,
                                       seed=200 + r, device=dev)
                       for r in range(DP_N)]

            def rank(r, dev=dev, world=world, batches=batches):
                m = SmallCNN(num_classes=10, seed=7, device=dev)
                opt = hvd.LocalSGD(
                    hvd.fused_update.sgd(m.parameters(), 0.1, momentum=0.9),
                    h=LS_H, axis_name=world.pair(r, DP_LOCAL), zero_stage=0,
                    compression=hvd.Compression.int8)
                losses = []
                for step in range(1, LS_STEPS + 1):
                    with torch.autograd.set_multithreading_enabled(False):
                        losses.append(float(train_step(m, opt, *batches[r])))
                    opt.maybe_outer_sync(step)
                return losses, [t.detach().cpu() for t in
                                m.state_dict().values()]

            TF.reset_launch_counts()
            Q.reset_launch_counts()
            runs[dev] = (world, world.run(rank))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    worst = 0.0
    for r, ((lg, wg), (lc, wc)) in enumerate(zip(runs["cuda"][1],
                                                 runs["cpu"][1])):
        for a, b in zip(lg, lc):
            if not math.isclose(a, b, rel_tol=1e-4):
                raise AssertionError(f"19b rank {r}: card losses {lg} vs "
                                     f"CPU {lc}")
        for i, (a, b) in enumerate(zip(wg, wc)):
            err = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
            worst = max(worst, err)
            if err > LS_SMALL_TOL:
                raise AssertionError(f"19b rank {r} tensor {i}: card and CPU "
                                     f"differ by {err} of its scale")
    want = {"momentum": LS_STEPS, "quantize": LS_STEPS // LS_H,
            "dequantize": 2 * LS_STEPS // LS_H}
    for r in range(DP_N):
        if dict(runs["cuda"][0].launches[r]) != want:
            raise AssertionError(f"19b rank {r}: card launches "
                                 f"{dict(runs['cuda'][0].launches[r])}, "
                                 f"expected {want}")
    log(f"[local sgd] 19b SmallCNN {LS_SMALL_SIZE} px, batch "
        f"{LS_SMALL_BATCH} per rank, float32, LocalSGD stage 0 int8, H = "
        f"{LS_H}, {LS_STEPS} steps over the emulated (cross {DP_CROSS}, "
        f"local {DP_LOCAL}) world: card and CPU agree on every rank (rank 0 "
        f"losses {runs['cuda'][1][0][0]} vs {runs['cpu'][1][0][0]}; worst "
        f"weight error {worst:.2e} of the largest magnitude; rtol 1e-4 "
        f"loss, {LS_SMALL_TOL} weights); card launches per rank {want}; on "
        f"{gpu}")
    return {"worst": worst, "launches": want}


def local_sgd(hvd, torch, gpu: str) -> dict:
    """Phase 19 (a-b)."""
    t0 = time.perf_counter()
    out = {"a": local_sgd_emulated(hvd, torch, gpu),
           "b": small_local_sgd_reference(hvd, torch, gpu)}
    log(f"[local sgd] phase 19 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 20: the eager negotiated plane
# ---------------------------------------------------------------------------

EAGER_WIRES = ("none", "int8", "int4")
EAGER_STEPS = 2
EAGER_CODEC = {"none": (), "int8": ("quantize", "dequantize"),
               "int4": ("pack4", "unpack4")}
EAGER_SHARD = 64          # images per emulated rank (phase 16's shards)
EAGER_TIMEOUT_S = 300.0   # the emulated controllers' wire deadline


class DictTransport:
    """An in-process key-value store shared by the emulated ranks'
    controllers (the six methods of the port's ``StoreTransport``)."""

    def __init__(self):
        import threading

        self.store, self.cv = {}, threading.Condition()

    def set(self, key, value):
        with self.cv:
            self.store[key] = value
            self.cv.notify_all()

    set_overwrite = set

    def set_once(self, key, value):
        with self.cv:
            self.store.setdefault(key, value)
            self.cv.notify_all()

    def get_blocking(self, key, timeout_s):
        with self.cv:
            if not self.cv.wait_for(lambda: key in self.store, timeout_s):
                raise TimeoutError(key)
            return self.store[key]

    def try_get(self, key):
        with self.cv:
            return self.store.get(key)

    def delete(self, key):
        with self.cv:
            self.store.pop(key, None)


def _hook_order(torch, model, images, labels) -> list:
    """One backward: the parameters in the order their post-accumulate
    hooks fired, and their gradients."""
    from horovod_tpu_torch.train_step import softmax_cross_entropy

    order = []
    hooks = [p.register_post_accumulate_grad_hook(order.append)
             for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    softmax_cross_entropy(model(images), labels).backward()
    for h in hooks:
        h.remove()
    return order


def eager_world1(hvd, torch, gpu: str, device: str = "cuda",
                 model_fn=None, batch: int = BATCH, size: int = 224,
                 classes: int = 1000) -> dict:
    """Phase 20a: the process's eager runtime at world 1 over NCCL: the
    161 gradient leaves of the main path's model through
    ``hvd.allreduce_async`` under their frontend names, one op of each
    other kind, equal to their inputs bit for bit; then the frontend's
    ``DistributedOptimizer(torch.optim.SGD(lr=0.01))`` 3 steps, bit for
    bit with the plain optimizer (deterministic cuDNN)."""
    import horovod_tpu_torch.torch as thvd
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import eager as E
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    if model_fn is None:
        def model_fn():
            return ResNet50(num_classes=classes, dtype=torch.bfloat16,
                            seed=0)
    cudnn = torch.backends.cudnn
    flags = (cudnn.benchmark, cudnn.deterministic)
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        model = model_fn()
        names = {id(p): n for n, p in model.named_parameters()}
        images, labels = synthetic_batch(batch, size, classes, seed=0,
                                         device=device)
        order = _hook_order(torch, model, images, labels)
        rt = E._runtime()
        rounds0, resp0 = rt.rounds, rt.responses
        rt.round_seconds.clear()
        handles = [(p.grad, hvd.allreduce_async(
            p.grad, name=f"allreduce.{names[id(p)]}")) for p in order]
        x = torch.arange(4 * 6, dtype=torch.float32,
                         device=device).reshape(4, 6)
        others = {"allgather": hvd.allgather_async(x, name="w1.gather"),
                  "broadcast": hvd.broadcast_async(x, 0, name="w1.bcast"),
                  "reducescatter": hvd.reducescatter_async(
                      x, name="w1.rs")}
        outs = [(g, hvd.synchronize(h)) for g, h in handles]
        outs += [(x, hvd.synchronize(h)) for h in others.values()]
        outs.append((x, hvd.alltoall(x, name="w1.a2a")))
        torch.cuda.synchronize()
        for i, (want, got) in enumerate(outs):
            if not torch.equal(got, want):
                raise AssertionError(f"20a: eager result {i} differs from "
                                     "its input at world 1")
        lat = sorted(rt.round_seconds)
        rounds, responses = rt.rounds - rounds0, rt.responses - resp0
        del handles, outs, order
        # the frontend against the plain optimizer
        weights = {}
        for which in ("frontend", "plain"):
            m = model_fn()
            sgd = torch.optim.SGD(m.parameters(), lr=0.01)
            opt = sgd if which == "plain" else thvd.DistributedOptimizer(
                sgd, named_parameters=m.named_parameters())
            steps = []
            for _ in range(SGD_STEPS):
                train_step(m, opt, images, labels)
                steps.append([p.detach().clone() for p in m.parameters()])
            weights[which] = steps
            del m, sgd, opt
        for k, (a, b) in enumerate(zip(weights["frontend"],
                                       weights["plain"])):
            if not all(torch.equal(u, v) for u, v in zip(a, b)):
                raise AssertionError(f"20a: the frontend's step {k + 1} "
                                     "differs from plain SGD at world 1")
        del weights, model
    finally:
        cudnn.benchmark, cudnn.deterministic = flags
    out = {"rounds": rounds, "responses": responses,
           "median_round_ms": lat[len(lat) // 2] * 1e3 if lat else None}
    log(f"[eager] 20a world 1 over NCCL: {len(names)} ResNet-50 gradient "
        f"leaves (224 px, batch {batch}, bf16) through "
        f"hvd.allreduce_async under their frontend names, and one "
        f"allgather, broadcast, reducescatter and alltoall: equal to the "
        f"inputs bit for bit; {rounds} rounds, {responses} responses, "
        f"median round {out['median_round_ms']} ms (host clock, "
        f"negotiation and dispatch); the frontend's "
        f"DistributedOptimizer(SGD(lr=0.01)) {SGD_STEPS} steps bit for bit "
        f"with plain SGD; on {gpu}")
    return out


def _emu_runtime_class(world):
    """A ``BackgroundRuntime`` of ``world``'s rank: it holds the rank's
    turn on the device while it executes a response, and logs each
    response's names, launches and payload bytes."""
    import collections

    from horovod_tpu_torch.runtime.background import BackgroundRuntime

    class EmuRuntime(BackgroundRuntime):
        log = None

        def _execute(self, resp):
            r = self.rank
            la = collections.Counter(world.launches[r])
            wi = collections.Counter(world.wire[r])
            with world.hold(r):
                super()._execute(resp)
            if self.log is not None and resp.kind not in ("join", "error"):
                self.log.append({
                    "kind": resp.kind, "names": list(resp.names),
                    "resp": json.dumps(resp.wire(), sort_keys=True),
                    "launches": dict(collections.Counter(
                        world.launches[r]) - la),
                    "wire_bytes": sum((collections.Counter(
                        world.wire[r]) - wi).values())})

    return EmuRuntime


def _emu_runtimes(torch, world, device: str, epoch: int) -> list:
    from horovod_tpu_torch.ops.eager import HandleManager
    from horovod_tpu_torch.ops.eager_exec import EagerExecutor
    from horovod_tpu_torch.runtime.controller import KVController

    transport = DictTransport()
    cls = _emu_runtime_class(world)
    return [cls(r, world.n, KVController(transport, r, world.n, epoch,
                                         timeout=EAGER_TIMEOUT_S),
                EagerExecutor(world.flat(r), device), HandleManager(),
                start=False) for r in range(world.n)]


def _threads(fn, n: int) -> list:
    """``fn(r)`` on ``n`` threads; their results (a failure re-raised)."""
    import threading

    out, errs = [None] * n, []

    def body(r):
        try:
            out[r] = fn(r)
        except BaseException as exc:  # noqa: BLE001 -- re-raised below
            errs.append(exc)

    ts = [threading.Thread(target=body, args=(r,), daemon=True)
          for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=EAGER_TIMEOUT_S)
    if errs:
        raise errs[0]
    if any(t.is_alive() for t in ts):
        raise AssertionError("an emulated rank did not finish")
    return out


def _eager_step(rt, submissions) -> dict:
    """One rank's step: its submissions ``(name, tensor)`` in its order,
    then cycles driven by this thread until every handle is done."""
    hm, handles = rt.hm, []
    for name, t in submissions:
        h = hm.allocate()
        rt.enqueue("allreduce", t, name, 1, h, None)
        handles.append((name, h))
    while not all(hm.poll(h) for _, h in handles):
        rt.run_cycle()
    return {name: hm.wait(h) for name, h in handles}


def _stats(rt) -> tuple:
    c = rt.controller
    return (rt.rounds, c.fast_rounds, rt.responses, c.explicit_requests)


def _eager_wire_checks(Q, torch, wire, grads, log0, outs, device, gpu):
    """20b on a lossy wire: each fused response of step 1 bit for bit
    with the same buffers through ``quantized_allreduce`` on the CPU
    (the plain versions) over an emulated world, and within n * scale /
    2 of the float sum."""
    from horovod_tpu_torch.common.util import true_divide
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.parallel.emulated import EmulatedWorld

    n = len(grads)
    qmax = (Q.sum_safe_qmax if wire == "int8" else Q.sum_safe_qmax4)(n)
    worst = 0.0
    for resp in log0:
        flats = [torch.cat([grads[r][name].reshape(-1)
                            for name in resp["names"]]).cpu()
                 for r in range(n)]
        cpu = EmulatedWorld(torch, n, sync=False)
        sums = cpu.run(lambda r: C.quantized_allreduce(
            flats[r], op=C.Sum, block_size=QBLOCK, mode=wire,
            overlap=False, axis_name=cpu.flat(r)))
        got = torch.cat([outs[name].reshape(-1) for name in resp["names"]])
        want = true_divide(sums[0], n)
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"20b {wire}: the response "
                                 f"{resp['names'][:2]}... differs from "
                                 "quantized_allreduce's plain versions")
        p2d = [Q._to_blocks(f, QBLOCK)[0] for f in flats]
        s = Q._scales(torch.stack([Q.block_absmax(p) for p in p2d])
                      .amax(0), qmax)
        exact = sum(f.double() for f in flats)
        bound = n * torch.repeat_interleave(
            half_scale(s.double(), qmax), QBLOCK)[:exact.numel()]
        err = (sums[0].double() - exact).abs()
        if bool((err > bound).any()):
            raise AssertionError(f"20b {wire}: beyond n * scale / 2 of the "
                                 "float sum")
        worst = max(worst, float((err / bound.clamp_min(1e-30)).max()))
        del flats, sums, p2d, exact, bound, err
    return worst


def _eager_shards(torch, device: str, model_fn=None, size: int = 224,
                  classes: int = 1000) -> tuple:
    """Phase 20b's submissions: each emulated rank's 64-image shard's
    gradients in hook order, rotated by a seeded shift: ``(orders,
    grads, subs, shifts)``."""
    import numpy as np

    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.train_step import synthetic_batch

    if model_fn is None:
        def model_fn():
            return ResNet50(num_classes=classes, dtype=torch.bfloat16,
                            seed=0)
    model = model_fn()
    names = {id(p): f"allreduce.{k}" for k, p in model.named_parameters()}
    grads, orders = [], []
    for r in range(DP_N):
        images, labels = synthetic_batch(EAGER_SHARD, size, classes,
                                         seed=100 + r, device=device)
        order = _hook_order(torch, model, images, labels)
        orders.append([names[id(p)] for p in order])
        grads.append({names[id(p)]: p.grad.detach().clone() for p in order})
        del images, labels
    model.zero_grad(set_to_none=True)
    del model
    shifts = np.random.RandomState(20).randint(0, len(orders[0]), DP_N)
    subs = [[(k, grads[r][k]) for k in orders[r][s:] + orders[r][:s]]
            for r, s in enumerate(shifts)]
    return orders, grads, subs, shifts


def eager_emulated(hvd, torch, gpu: str, device: str = "cuda",
                   model_fn=None, size: int = 224,
                   classes: int = 1000) -> dict:
    """Phase 20b: four ``BackgroundRuntime``s, each with its own
    ``KVController`` over one in-process ``DictTransport`` and an
    ``EagerExecutor`` over phase 16's ``EmulatedWorld`` flat hop; each
    rank's thread submits its own 64-image shard's 161 gradients in
    hook order rotated by a seeded shift and drives its runtime's cycles
    (scripted submissions: every rank's requests reach round 1 whole);
    two steps per wire, a mismatch and a join with the background
    threads started."""
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import quantization as Q
    from horovod_tpu_torch.parallel.emulated import EmulatedWorld

    t0 = time.perf_counter()
    n = DP_N
    orders, grads, subs, shifts = _eager_shards(torch, device, model_fn,
                                                size, classes)
    # phase 16's in-trace reduction of the same gradients
    ref_world = EmulatedWorld(torch, n, sync=device == "cuda")
    keys = orders[0]
    ref = ref_world.run(lambda r: C.grouped_allreduce(
        [grads[r][k] for k in keys], axis_name=ref_world.flat(r)))
    ref = dict(zip(keys, ref[0]))
    out = {}
    for epoch, wire in enumerate(EAGER_WIRES, 1):
        os.environ["HOROVOD_COMPRESSION"] = wire
        world = EmulatedWorld(torch, n, (Q.LAUNCHES,),
                              sync=device == "cuda", free=True)
        rts = _emu_runtimes(torch, world, device, epoch)
        Q.reset_launch_counts()
        steps = []
        try:
            for step in range(EAGER_STEPS):
                for rt in rts:
                    rt.log = []
                before = [_stats(rt) for rt in rts]
                res = _threads(lambda r: _eager_step(rts[r], subs[r]), n)
                after = [_stats(rt) for rt in rts]
                st = [dict(zip(("rounds", "fast_rounds", "responses",
                                "explicit"), (a - b for a, b in
                                              zip(after[r], before[r]))))
                      for r in range(n)]
                for k in keys:
                    for r in range(1, n):
                        if not torch.equal(res[r][k], res[0][k]):
                            raise AssertionError(
                                f"20b {wire} step {step + 1}: rank {r}'s "
                                f"{k} differs from rank 0's")
                    if wire == "none" and not torch.equal(res[0][k], ref[k]):
                        raise AssertionError(
                            f"20b none step {step + 1}: {k} differs from "
                            "phase 16's in-trace grouped_allreduce")
                for r, rt in enumerate(rts):
                    want = dict.fromkeys(EAGER_CODEC[wire], 1)
                    for resp in rt.log:
                        if resp["launches"] != want:
                            raise AssertionError(
                                f"20b {wire} rank {r}: launches "
                                f"{resp['launches']} for one response, "
                                f"expected {want}")
                if step == 1:
                    if any(s["fast_rounds"] < 1 or s["explicit"]
                           for s in st):
                        raise AssertionError(
                            f"20b {wire} step 2: not served by the cache's "
                            f"fast path: {st}")
                    for k in keys:
                        if not torch.equal(res[0][k], steps[0]["out"][k]):
                            raise AssertionError(
                                f"20b {wire}: step 2's {k} differs from "
                                "step 1's")
                steps.append({"out": res[0], "stats": st,
                              "log": [list(rt.log) for rt in rts]})
            worst = (_eager_wire_checks(Q, torch, wire, grads,
                                        steps[0]["log"][0],
                                        steps[0]["out"], device, gpu)
                     if wire != "none" else None)
            launches = [dict(world.launches[r]) for r in range(n)]
            if wire == "none":
                checks = _eager_errors_and_join(torch, rts, device)
            for rt in rts:
                rt.stop()
        finally:
            os.environ["HOROVOD_COMPRESSION"] = "none"
        out[wire] = {
            "stats": [s["stats"] for s in steps],
            "responses": [len(s["log"][0]) for s in steps],
            "wire_bytes": [[x["wire_bytes"] for x in s["log"][0]]
                           for s in steps],
            "launches": launches, "worst": worst,
            "ms": [dict(world.ms[r]) for r in range(n)]}
        log(f"[eager] 20b {wire}: 4 emulated ranks, 161 ResNet-50 "
            f"gradients of a {EAGER_SHARD}-image shard each, hook order "
            f"rotated by {list(map(int, shifts))}; every rank the same bits"
            + ("; bit for bit phase 16's in-trace grouped_allreduce"
               if wire == "none" else
               f"; each fused response bit for bit quantized_allreduce's "
               f"plain versions on the CPU, within {worst:.4f} of n * "
               f"scale / 2 of the float sum")
            + f"; per step and rank rounds/fast rounds/responses/explicit "
            f"requests {[s['stats'] for s in steps]}; responses per step "
            f"{out[wire]['responses']}; payload bytes per response (rank "
            f"0) {out[wire]['wire_bytes']}; launches per rank over both "
            f"steps {launches}; per rank ms of work before each transfer "
            f"{out[wire]['ms']}; on {gpu}")
        del rts, world, steps
    out["checks"] = checks
    log(f"[eager] 20b: a mismatched shape raised on every rank "
        f"({checks['mismatch']!r}), the runtimes worked afterwards, join "
        f"with uneven work returned {checks['join']} on every rank; phase "
        f"20b took {time.perf_counter() - t0:.1f} s")
    del grads, ref
    return out


def _eager_errors_and_join(torch, rts, device: str) -> dict:
    """20b with the runtimes' background threads running: a shape
    mismatch on one rank fails every rank's handle with the
    coordinator's message, the runtimes still reduce afterwards, and a
    join with uneven work (rank 3 reduces twice more) returns rank 3
    everywhere."""
    from horovod_tpu_torch.common.types import HorovodTpuError

    for rt in rts:
        rt.start()
    n = len(rts)

    def rank(r):
        rt, hm = rts[r], rts[r].hm
        h = hm.allocate()
        rt.enqueue("allreduce", torch.ones(8 + (r == n - 1), device=device),
                   "eager.bad", 1, h, None)
        try:
            hm.wait(h)
            msg = None
        except HorovodTpuError as exc:
            msg = str(exc)
        h = hm.allocate()
        rt.enqueue("allreduce", torch.ones(4, device=device), "eager.after",
                   2, h, None)
        after = hm.wait(h)
        extra = []
        if r == n - 1:
            for k in range(2):
                h = hm.allocate()
                rt.enqueue("allreduce", torch.full((3,), 6.0, device=device),
                           f"eager.uneven.{k}", 2, h, None)
                extra.append(hm.wait(h))
        return msg, after, extra, rt.join()

    res = _threads(rank, n)
    # the first rank to submit gives the table its shape: either order
    want = {f"Mismatched shapes for tensor eager.bad: {a} vs {b}."
            for a, b in (("(8,)", "(9,)"), ("(9,)", "(8,)"))}
    for r, (msg, after, extra, last) in enumerate(res):
        if msg not in want or msg != res[0][0]:
            raise AssertionError(f"20b rank {r}: mismatch raised {msg!r}")
        if not torch.equal(after.cpu(), torch.full((4,), float(n))):
            raise AssertionError(f"20b rank {r}: the runtime did not reduce "
                                 "after the mismatch")
        if last != n - 1 or any(not torch.equal(
                e.cpu(), torch.full((3,), 6.0)) for e in extra):
            raise AssertionError(f"20b rank {r}: join returned {last}")
    return {"mismatch": res[0][0], "join": n - 1}


def eager_plane(hvd, torch, gpu: str) -> dict:
    """Phase 20 (a-b)."""
    t0 = time.perf_counter()
    out = {"a": eager_world1(hvd, torch, gpu),
           "b": eager_emulated(hvd, torch, gpu)}
    log(f"[eager] phase 20 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 21: the rest of the eager plane, and training on it
# ---------------------------------------------------------------------------

ZE_STAGES, ZE_WIRES, ZE_STEPS = (1, 2, 3), ("none", "int8"), 2
ZE_CHUNKS = 4           # HOROVOD_ZERO_PREFETCH_CHUNKS' default
ZE_LR, ZE_MU = 0.1, 0.9
PHASE21_DEVICE = "cuda"  # "cpu" rehearses the phase without a card
HB_INTERVAL, HB_TIMEOUT = 0.2, 2.0
CODEC_ROUNDS = 200      # 21e: rounds of the codec alone, per codec


def _rank_launches(mod):
    """Books ``mod.LAUNCHES`` (the kernel wrappers' launch counter) per
    emulated rank while active: the counter is swapped for a dict that
    credits each increment to the incrementing thread's rank (its
    ``rank.r``, set by the caller), and afterwards the original counter
    takes the total.  Yields the per-rank ``collections.Counter``s."""
    import collections
    import contextlib
    import threading

    rank, seen = threading.local(), threading.local()
    per = {}

    class Booked(dict):
        def __getitem__(self, k):
            v = dict.__getitem__(self, k)
            seen.k, seen.v = k, v
            return v

        def __setitem__(self, k, v):
            r = getattr(rank, "r", None)
            if r is not None:
                base = seen.v if getattr(seen, "k", None) == k \
                    else dict.get(self, k, 0)
                per.setdefault(r, collections.Counter())[k] += v - base
            seen.k = None
            dict.__setitem__(self, k, v)

    @contextlib.contextmanager
    def active():
        orig = mod.LAUNCHES
        mod.LAUNCHES = Booked(orig)
        try:
            yield per
        finally:
            orig.update(mod.LAUNCHES)
            mod.LAUNCHES = orig

    return rank, active


def _bound_runtimes(torch, world, device: str, epoch: int, local=None,
                    fanout=None, transport=None, transports=None) -> list:
    """Four started ``BackgroundRuntime``s of ``world`` over the eager
    module's handle manager, each rank's controller over one in-process
    store (``transports[r]`` where given) and its executor over the
    world's flat hop (and its (cross, local) pair with ``local``)."""
    from horovod_tpu_torch.ops import eager as E
    from horovod_tpu_torch.ops.eager_exec import EagerExecutor
    from horovod_tpu_torch.runtime.controller import KVController

    transport = transport or DictTransport()
    cls = _emu_runtime_class(world)
    rts = [cls(r, world.n, KVController(
        (transports or {}).get(r, transport), r, world.n, epoch,
        timeout=EAGER_TIMEOUT_S, fanout=fanout),
        EagerExecutor(world.flat(r), device,
                      pair=world.pair(r, local) if local else None),
        E.handle_manager, start=False) for r in range(world.n)]
    for rt in rts:
        rt.log = []
        rt.start()
    return rts


def _ze_rank(hvd, torch, stage: int, weights, grads, axis, eager: bool,
             comp) -> tuple:
    """One emulated rank's ``ZE_STEPS`` steps of ``DistributedOptimizer(
    fused_update.sgd(ZE_LR, ZE_MU))`` at ``stage`` on its captured
    gradients (stage 3: ``zero3_shard_params`` cut over ``axis`` and a
    loss linear in the weights, whose cotangents are the gradients):
    the weights and the optimizer-state bytes."""
    names = [f"p{i}" for i in range(len(weights))]
    ps = [torch.nn.Parameter(w.clone()) for w in weights]
    kw = {"eager": True} if eager else {"axis_name": axis}
    if stage == 3:
        zp = hvd.zero3_shard_params(list(zip(names, ps)), axis_name=axis)
        opt = hvd.DistributedOptimizer(
            hvd.fused_update.sgd(zp.shards, ZE_LR, momentum=ZE_MU),
            zero_stage=3, compression=comp, **kw)
        # the eager wire's mode is the knob's
        fkw = {"eager": True} if eager else {"compression": comp}
        for _ in range(ZE_STEPS):
            opt.zero_grad()
            full = hvd.zero3_full_params(zp, **fkw)
            # the backward on this rank's thread (CUDA's autograd would
            # run every rank's on one device thread)
            with torch.autograd.set_multithreading_enabled(False):
                sum((full[k] * g).sum()
                    for k, g in zip(names, grads)).backward()
            opt.step()
        full = hvd.zero3_full_params(zp, **fkw)
        ws = [full[k].detach() for k in names]
    else:
        opt = hvd.DistributedOptimizer(
            hvd.fused_update.sgd(ps, ZE_LR, momentum=ZE_MU),
            zero_stage=stage, compression=comp, **kw)
        for _ in range(ZE_STEPS):
            for p, g in zip(ps, grads):
                p.grad = g.clone()
            opt.step()
        ws = [p.detach() for p in ps]
    return ws, opt.state_bytes()


def _ze_intrace(hvd, Q, TF, torch, stage: int, wire: str, weights,
                grads) -> dict:
    from horovod_tpu_torch.parallel.emulated import EmulatedWorld

    world = EmulatedWorld(torch, DP_N, (TF.LAUNCHES, Q.LAUNCHES))
    comp = hvd.Compression.lookup(wire)
    outs = world.run(lambda r: _ze_rank(hvd, torch, stage, weights,
                                        grads[r], world.flat(r), False,
                                        comp))
    return {"weights": [o[0] for o in outs], "state": [o[1] for o in outs],
            "launches": [dict(x) for x in world.launches]}


def _ze_eager(hvd, Q, TF, torch, stage: int, wire: str, weights, grads,
              epoch: int, fanout=None) -> dict:
    """Four emulated ranks on the eager wire: runtimes started, each
    rank's thread bound to its own (``ops.eager.bound_runtime``)."""
    from horovod_tpu_torch.ops import eager as E
    from horovod_tpu_torch.parallel.emulated import EmulatedWorld

    os.environ["HOROVOD_COMPRESSION"] = wire
    world = EmulatedWorld(torch, DP_N, (Q.LAUNCHES,), free=True)
    rts = _bound_runtimes(torch, world, PHASE21_DEVICE, epoch,
                           fanout=fanout)
    rank, active = _rank_launches(TF)
    comp = hvd.Compression.lookup(wire)

    def body(r):
        rank.r = r
        with E.bound_runtime(rts[r]):
            return _ze_rank(hvd, torch, stage, weights, grads[r],
                            world.flat(r), True, comp)

    try:
        TF.reset_launch_counts()
        with active() as booked:
            outs = _threads(body, DP_N)
        torch.cuda.synchronize()
        b1_total = TF.LAUNCHES["momentum"]
    finally:
        os.environ["HOROVOD_COMPRESSION"] = "none"
        for rt in rts:
            rt.stop()
    logs = [rt.log for rt in rts]
    codec = [{k: sum(x["launches"].get(k, 0) for x in lg)
              for k in CODECS} for lg in logs]
    return {"weights": [o[0] for o in outs], "state": [o[1] for o in outs],
            "b1": [booked.get(r, {}).get("momentum", 0)
                   for r in range(DP_N)],
            "b1_total": b1_total, "codec": codec,
            "responses": [len(lg) for lg in logs],
            "kinds": [sorted({x["kind"] for x in lg}) for lg in logs],
            "wire_bytes": [sum(x["wire_bytes"] for x in lg) for lg in logs],
            "resp": [[x["resp"] for x in lg] for lg in logs],
            "round_ms": statistics.median(
                [s * 1e3 for rt in rts for s in rt.round_seconds])}


def _ze_bound(torch, Q, weights, grads, want) -> float:
    """The int8 wire's bound on the weights after ``ZE_STEPS`` momentum
    steps: each step's reduced gradient within half a quantization step
    (a block's scale is at most the largest magnitude of any rank's
    gradient over ``sum_safe_qmax(n)``), and the float32 rounding of ``x
    / scale``, of the float mean, through ``lr * (1 + (1 + mu))``, plus
    four ulps of the weights; returns the largest share used by
    ``want`` against the none wire's weights."""
    amax = max(float(g.abs().max()) for gs in grads for g in gs)
    qmax = Q.sum_safe_qmax(DP_N)
    step = amax / qmax
    worst = 0.0
    for got, ref in zip(want[0], want[1]):
        tol = ZE_LR * (2 + ZE_MU) * step * (0.5 + qmax * 2.0 ** -22) \
            + 4 * _ulp32(torch, ref)
        worst = max(worst, float(((got.double() - ref.double()).abs()
                                  / tol).max()))
    return worst


def eager_zero_emulated(hvd, torch, gpu: str) -> dict:
    """21a and 21c: ``DistributedOptimizer(..., eager=True)`` at stages
    1-3 over four emulated runtimes on the none and int8 wires, each
    beside the in-trace stage over the same emulated world; the
    hierarchical plane (fanout 2) at stage 2 beside the flat one."""
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import quantization as Q
    from horovod_tpu_torch.optim import fused_update as TF

    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0)
    grads = _resnet_grads(torch, model)
    weights = [p.detach().clone() for p in model.parameters()]
    del model
    out, epoch = {}, 100
    for stage in ZE_STAGES:
        ref = _ze_intrace(hvd, Q, TF, torch, stage, "none", weights, grads)
        for wire in ZE_WIRES:
            epoch += 1
            res = _ze_eager(hvd, Q, TF, torch, stage, wire, weights, grads,
                            epoch)
            what = f"21a stage {stage} {wire}"
            for r in range(DP_N):
                if not all(torch.equal(a, b) for a, b in
                           zip(res["weights"][r], res["weights"][0])):
                    raise AssertionError(f"{what}: rank {r}'s weights differ "
                                         "from rank 0's")
                if res["b1"][r] != ZE_STEPS:
                    raise AssertionError(f"{what} rank {r}: {res['b1'][r]} "
                                         f"B1 launches, expected {ZE_STEPS}")
                n_rs = ZE_STEPS * (1 if stage == 1 else ZE_CHUNKS) \
                    if wire == "int8" else 0
                want = {"quantize": n_rs, "dequantize": n_rs, "pack4": 0,
                        "unpack4": 0}
                if res["codec"][r] != want:
                    raise AssertionError(f"{what} rank {r}: codec launches "
                                         f"{res['codec'][r]}, expected {want}")
            if res["b1_total"] != DP_N * ZE_STEPS:
                raise AssertionError(f"{what}: {res['b1_total']} B1 launches "
                                     f"for {DP_N} ranks x {ZE_STEPS} steps")
            if wire == "none":
                for r in range(DP_N):
                    if not all(torch.equal(a, b) for a, b in
                               zip(res["weights"][r], ref["weights"][r])):
                        raise AssertionError(f"{what} rank {r}: not bit for "
                                             "bit the in-trace stage")
                res["worst"] = None
                base = res
            else:
                res["worst"] = _ze_bound(
                    torch, Q, weights, grads,
                    (res["weights"][0], base["weights"][0]))
                if res["worst"] > 1:
                    raise AssertionError(f"{what}: {res['worst']:.3f} of the "
                                         "int8 wire's bound from the none "
                                         "wire")
            out[f"stage {stage} {wire}"] = {
                k: res[k] for k in ("b1", "codec", "responses", "wire_bytes",
                                    "state", "worst", "round_ms")}
            log(f"[eager] 21a stage {stage} {wire}: four emulated runtimes, "
                f"the 161 ResNet-50 leaves' captured gradients ({ZE_STEPS} "
                f"steps, fused momentum SGD, eager=True): "
                + ("bit for bit the in-trace stage over the same world"
                   if wire == "none" else
                   f"{res['worst']:.6f} of the int8 wire's bound from the "
                   "none wire")
                + f"; per rank over {ZE_STEPS} steps B1 {res['b1']}, B4-B7 "
                f"{res['codec']}; responses per rank {res['responses']} "
                f"({res['kinds'][0]}); payload bytes per rank "
                f"{res['wire_bytes']}; optimizer state per rank "
                f"{res['state']} B (in-trace {ref['state']} B); median round "
                f"{res['round_ms']:.3f} ms; on {gpu}")
            if stage == 2 and wire == "none":
                epoch += 1
                hier = _ze_eager(hvd, Q, TF, torch, stage, wire, weights,
                                 grads, epoch, fanout=2)
                for r in range(DP_N):
                    if hier["resp"][r] != res["resp"][r]:
                        raise AssertionError(f"21c rank {r}: the hierarchical "
                                             "plane's responses differ from "
                                             "the flat plane's")
                    if not all(torch.equal(a, b) for a, b in
                               zip(hier["weights"][r], res["weights"][r])):
                        raise AssertionError(f"21c rank {r}: weights differ "
                                             "from the flat plane's")
                out["hier"] = {"responses": hier["responses"],
                               "round_ms": hier["round_ms"]}
                log(f"[eager] 21c HOROVOD_CONTROL_FANOUT=2 (2 slices of 2): "
                    f"stage 2's {hier['responses'][0]} responses per rank "
                    f"byte-identical to the flat plane's, weights bit for "
                    f"bit; median round {hier['round_ms']:.3f} ms (flat "
                    f"{res['round_ms']:.3f} ms); on {gpu}")
            del res
        del ref
    del grads, weights, base
    torch.cuda.empty_cache()
    return out


def _ls_rank(hvd, torch, weights, grads, axis, wire_counter) -> dict:
    """One emulated rank's ``LS_STEPS`` inner steps under ``LocalSGD(h=
    LS_H)`` (stage 0, fused momentum SGD) on its captured gradients, over
    ``axis`` (``None``: the eager regime), ``maybe_outer_sync`` after
    each; the weights after every step and sync, and per step the
    cross-hop bytes it added."""
    ps = [torch.nn.Parameter(w.clone()) for w in weights]
    kw = {} if axis is None else {"axis_name": axis}
    opt = hvd.LocalSGD(hvd.fused_update.sgd(ps, 0.1, momentum=0.9), h=LS_H,
                       compression=hvd.Compression.none, **kw)
    flat, cross = [], []
    for step in range(1, LS_STEPS + 1):
        c0 = wire_counter()
        for p, g in zip(ps, grads):
            p.grad = g.clone()
        opt.step()
        c1 = wire_counter()
        opt.maybe_outer_sync(step)
        cross.append((c1 - c0, wire_counter() - c1))
        flat.append(torch.cat([p.detach().reshape(-1) for p in ps]))
    return {"flat": flat, "cross": cross, "eager": opt.eager}


def eager_local_sgd_emulated(hvd, torch, gpu: str) -> dict:
    """21b: local SGD's eager regime (no pair) over four emulated
    runtimes with a (cross 2, local 2) pair, against the in-trace
    ``LocalSGD`` over the emulated pair."""
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import eager as E
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.parallel.emulated import EmulatedWorld

    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0)
    grads = _resnet_grads(torch, model)
    weights = [p.detach().clone() for p in model.parameters()]
    del model
    world = EmulatedWorld(torch, DP_N, (TF.LAUNCHES,))
    ref = world.run(lambda r: _ls_rank(
        hvd, torch, weights, grads[r], world.pair(r, DP_LOCAL),
        lambda: world.wire[r]["cross"]))
    os.environ["HOROVOD_LOCAL_SGD_H"] = str(LS_H)
    ew = EmulatedWorld(torch, DP_N, (TF.LAUNCHES,), free=True)
    rts = _bound_runtimes(torch, ew, PHASE21_DEVICE, 200, local=DP_LOCAL)

    def body(r):
        with E.bound_runtime(rts[r]):
            return _ls_rank(hvd, torch, weights, grads[r], None,
                            lambda: ew.wire[r]["cross"])

    try:
        res = _threads(body, DP_N)
    finally:
        os.environ.pop("HOROVOD_LOCAL_SGD_H", None)
        for rt in rts:
            rt.stop()
    sync_bytes = ls_cross_bytes(0, "none")
    scopes = sorted({x["names"][0].split(".")[1] for x in rts[0].log})
    for r in range(DP_N):
        if not res[r]["eager"]:
            raise AssertionError(f"21b rank {r}: LocalSGD did not take the "
                                 "eager regime")
        for k, (a, b) in enumerate(zip(res[r]["flat"], ref[r]["flat"])):
            if not torch.equal(a, b):
                raise AssertionError(f"21b rank {r} step {k + 1}: not bit "
                                     "for bit the in-trace LocalSGD over the "
                                     "pair")
        for step, (inner, sync) in enumerate(res[r]["cross"], 1):
            want = sync_bytes if step % LS_H == 0 else 0
            if inner or sync != want:
                raise AssertionError(f"21b rank {r} step {step}: {inner} B "
                                     f"over the cross hop in the inner step, "
                                     f"{sync} B in the sync (expected 0 and "
                                     f"{want})")
    if scopes != ["cross", "local"]:
        raise AssertionError(f"21b: response scopes {scopes}")
    out = {"cross": res[0]["cross"], "local_bytes": ew.wire[0]["local"],
           "responses": len(rts[0].log)}
    log(f"[eager] 21b local SGD's eager regime, (cross 2, local 2), H = "
        f"{LS_H}, {LS_STEPS} inner steps on the 161 ResNet-50 leaves' "
        f"captured gradients: bit for bit the in-trace LocalSGD over the "
        f"emulated pair after every step and sync on every rank; cross-hop "
        f"bytes per step (inner, sync) {out['cross']} (a sync reckoned "
        f"{sync_bytes}); local bytes {out['local_bytes']}; "
        f"{out['responses']} localsgd.local./localsgd.cross. responses per "
        f"rank; on {gpu}")
    del res, ref, grads, weights
    torch.cuda.empty_cache()
    return out


class _DyingTransport:
    """A rank's view of the store that fails every call once ``dead``:
    the rank stops beating and stops answering."""

    def __init__(self, inner):
        self.inner, self.dead = inner, False

    def __getattr__(self, name):
        fn = getattr(self.inner, name)

        def call(*a, **kw):
            if self.dead:
                raise ConnectionError("this emulated rank is down")
            return fn(*a, **kw)
        return call


def eager_liveness_emulated(hvd, torch, gpu: str) -> dict:
    """21d: four emulated runtimes with ``HOROVOD_HEARTBEAT_INTERVAL`` 0.2
    s and ``_TIMEOUT_SECONDS`` 2 s; after one allreduce rank 3 stops
    beating and answering; the other three, each submitting an
    allreduce, raise ``RanksDownError`` naming rank 3."""
    from horovod_tpu_torch.common.types import RanksDownError
    from horovod_tpu_torch.ops import eager as E
    from horovod_tpu_torch.parallel.emulated import EmulatedWorld

    env = {"HOROVOD_HEARTBEAT_INTERVAL": str(HB_INTERVAL),
           "HOROVOD_HEARTBEAT_TIMEOUT_SECONDS": str(HB_TIMEOUT)}
    os.environ.update(env)
    store = DictTransport()
    dying = _DyingTransport(store)
    world = EmulatedWorld(torch, DP_N, (), free=True)
    try:
        rts = _bound_runtimes(torch, world, PHASE21_DEVICE, 300,
                              transport=store,
                              transports={DP_N - 1: dying})
    finally:
        for k in env:
            os.environ.pop(k)
    try:
        def warm(r):
            with E.bound_runtime(rts[r]):
                return hvd.allreduce(torch.ones(4, device=PHASE21_DEVICE),
                                     op=hvd.Sum, name="hb.warm")
        warm_outs = _threads(warm, DP_N)
        if any(float(o.sum()) != 4 * DP_N for o in warm_outs):
            raise AssertionError("21d: the warm-up allreduce is wrong")
        dying.dead = True
        t_dead = time.monotonic()

        def survivor(r):
            with E.bound_runtime(rts[r]):
                try:
                    hvd.allreduce(torch.ones(4, device=PHASE21_DEVICE),
                                  op=hvd.Sum, name="hb.after")
                except RanksDownError as exc:
                    return time.monotonic() - t_dead, list(exc.ranks), \
                        str(exc)
                return None

        got = _threads(survivor, DP_N - 1)
    finally:
        for rt in rts:
            rt.stop()
    for r, g in enumerate(got):
        if g is None or g[1] != [DP_N - 1]:
            raise AssertionError(f"21d rank {r}: {g!r} instead of "
                                 f"RanksDownError naming [{DP_N - 1}]")
        if g[0] > HB_TIMEOUT + 5:
            raise AssertionError(f"21d rank {r}: raised {g[0]:.2f} s after "
                                 "the death")
    out = {"detect_s": [g[0] for g in got]}
    log(f"[eager] 21d liveness (interval {HB_INTERVAL} s, timeout "
        f"{HB_TIMEOUT} s): emulated rank {DP_N - 1} stopped beating; ranks "
        f"0-{DP_N - 2} raised RanksDownError naming [{DP_N - 1}] after "
        f"{[round(x, 3) for x in out['detect_s']]} s; {got[0][2][:160]!r}")
    return out


def _codec_round_msgs(names_shapes) -> tuple:
    """A cold round's messages of one rank of four: its request list (161
    requests, every rank the same) and the coordinator's response list."""
    from horovod_tpu_torch.runtime import controller as C

    reqs = [C.Request(n, "allreduce", 1, 8, s) for n, s in names_shapes]
    coord = C.Coordinator(DP_N)
    for r in range(DP_N):
        coord.ingest(r, reqs, False, False)
    resps, _ = coord.compute_responses()
    rank_msg = {"b": [], "i": [], "req": [q.wire() for q in reqs],
                "j": False, "x": False}
    resp_msg = {"resp": [p.wire() for p in resps], "i": [], "x": False,
                "aj": False, "lj": -1}
    return rank_msg, resp_msg


def eager_codec_emulated(hvd, torch, gpu: str) -> dict:
    """21e: the native codec is the one loaded; the median round latency
    (``BackgroundRuntime.round_seconds``) of phase 20b's step (four
    emulated runtimes, the 161 ResNet-50 gradients of a 64-image shard
    each) with the native and with the pure-Python codec, and a cold
    round's messages alone through each (rank 0 decodes four request
    lists and encodes the response list)."""
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.parallel.emulated import EmulatedWorld
    from horovod_tpu_torch.runtime import wire as W
    from horovod_tpu_torch.train_step import synthetic_batch

    if not W.native_loaded():
        raise AssertionError("21e: the native wire codec is not loaded")
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0)
    names = {id(p): f"allreduce.{k}" for k, p in model.named_parameters()}
    images, labels = synthetic_batch(EAGER_SHARD, 224, 1000, seed=100,
                                     device=PHASE21_DEVICE)
    order = _hook_order(torch, model, images, labels)
    subs = [(names[id(p)], p.grad.detach().clone()) for p in order]
    shapes = [(names[id(p)], tuple(p.shape)) for p in order]
    del model, images, labels, order
    rank_msg, resp_msg = _codec_round_msgs(shapes)
    out, loaded = {}, W._native
    for native in (True, False):
        # the Python codec's round: the module without its native one
        W._native = loaded if native else None
        try:
            world = EmulatedWorld(torch, DP_N, (), free=True,
                                  sync=PHASE21_DEVICE == "cuda")
            rts = _emu_runtimes(torch, world, PHASE21_DEVICE, 400 + native)
            for step in range(EAGER_STEPS + 1):
                _threads(lambda r: _eager_step(rts[r], subs), DP_N)
            lat = sorted(s * 1e3 for rt in rts for s in rt.round_seconds)
            for rt in rts:
                rt.stop()
            t0 = time.perf_counter()
            for _ in range(CODEC_ROUNDS):
                blob = W.dumps_rank(rank_msg)
                for _ in range(DP_N):
                    W.loads_rank(blob)
                W.loads_resp(W.dumps_resp(resp_msg))
            codec_ms = (time.perf_counter() - t0) * 1e3 / CODEC_ROUNDS
        finally:
            W._native = loaded
        key = "native" if native else "python"
        out[key] = {"median_round_ms": lat[len(lat) // 2],
                    "rounds": len(lat), "codec_ms": codec_ms}
        del rts, world
    log(f"[eager] 21e the native wire codec (csrc/wire.cc, g++) is loaded; "
        f"phase 20b's step (4 emulated runtimes, 161 ResNet-50 gradients, "
        f"{EAGER_STEPS + 1} steps): median round "
        f"{out['native']['median_round_ms']:.3f} ms native, "
        f"{out['python']['median_round_ms']:.3f} ms Python (host clock, "
        f"negotiation and dispatch); a cold round's messages alone (rank 0: "
        f"encode its list, decode four, encode and decode the response "
        f"list of {len(resp_msg['resp'])}): "
        f"{out['native']['codec_ms']:.3f} ms native, "
        f"{out['python']['codec_ms']:.3f} ms Python; on {gpu}")
    del subs
    torch.cuda.empty_cache()
    return out


def eager_training(hvd, torch, gpu: str) -> dict:
    """Phase 21 (a-e)."""
    t0 = time.perf_counter()
    out = {"a": eager_zero_emulated(hvd, torch, gpu),
           "b": eager_local_sgd_emulated(hvd, torch, gpu),
           "d": eager_liveness_emulated(hvd, torch, gpu),
           "e": eager_codec_emulated(hvd, torch, gpu)}
    log(f"[eager] phase 21 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 22: the observability planes
# ---------------------------------------------------------------------------

OBS_WARMUP, OBS_STEPS, OBS_ROUNDS = 2, 10, 2
OBS_EMPTY = 1000   # empty observed steps of the host-cost reading
PROM_LINE = (r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
             r'(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*",?)*\})?'
             r' (-?[0-9.eE+-]+|\+Inf|-Inf|NaN)$')


def _prometheus_text(text: str) -> int:
    """Parse ``text`` as Prometheus text exposition 0.0.4: every line a
    ``# HELP``/``# TYPE`` comment or a sample; returns the samples."""
    import re

    sample = re.compile(PROM_LINE)
    n = 0
    for line in text.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            if len(line.split(" ", 3)) < 3:
                raise AssertionError(f"22a: bad comment line {line!r}")
            continue
        if not sample.match(line):
            raise AssertionError(f"22a: not a Prometheus sample: {line!r}")
        n += 1
    return n


def _obs_counts(TF, BN, steps: int, what: str) -> dict:
    got = {**TF.LAUNCHES, **BN.LAUNCHES}
    want = -(-161 // TF.capacity("momentum")) * steps
    if got["momentum"] != want or any(
            got[k] != RESNET50_BN * steps for k in BN_KERNELS):
        raise AssertionError(f"22a {what}: launches {got} over {steps} "
                             f"steps, expected {want} B1 and "
                             f"{RESNET50_BN * steps} of each of N1-N4")
    return {k: got[k] for k in ("momentum", *BN_KERNELS)}


def _observer_host_us(hvd) -> float:
    """The observers' host cost per step: ``OBS_EMPTY`` empty steps under
    ``trace_step`` with a batch through ``wrap_data_loader``, less the
    same loop bare, in microseconds (after 22a's checks: these steps
    land on the histogram and the ring too)."""
    import itertools

    t0 = time.perf_counter()
    for i, _ in enumerate(hvd.wrap_data_loader(
            itertools.repeat(None, OBS_EMPTY))):
        with hvd.trace_step(step=i):
            pass
    t1 = time.perf_counter()
    for i, _ in enumerate(itertools.repeat(None, OBS_EMPTY)):
        pass
    t2 = time.perf_counter()
    return ((t1 - t0) - (t2 - t1)) / OBS_EMPTY * 1e6


def observability_resnet(hvd, torch, gpu: str) -> dict:
    """22a: the bench step bare and observed, in alternation."""
    import itertools
    import tempfile
    import urllib.request

    from horovod_tpu_torch.common.util import reserve_port
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import batch_norm as BN
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.perf import goodput as GP
    from horovod_tpu_torch.runtime import flight as FL
    from horovod_tpu_torch.runtime import metrics as M
    from horovod_tpu_torch.trace import analyze, merge_dumps
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0)
    opt = hvd.DistributedOptimizer(
        hvd.fused_update.sgd(model.parameters(), 0.1, momentum=0.9))
    images, labels = synthetic_batch(BATCH, 224, 1000, seed=0)
    for _ in range(OBS_WARMUP):
        train_step(model, opt, images, labels)
    torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="hvd_obs_")
    saved = {k: os.environ.get(k) for k in
             ("HOROVOD_FLIGHT_DIR", "HOROVOD_GOODPUT_DIR",
              "HOROVOD_METRICS_PORT")}
    held, port = reserve_port()
    os.environ["HOROVOD_METRICS_PORT"] = str(port)
    try:
        srv = M.start_rank_endpoint(0)
    finally:
        held.close()
    if srv is None:
        raise AssertionError("22a: the metrics endpoint did not start")
    hist = M.registry().histogram("hvd_step_time_seconds")
    hist0 = hist.total()
    FL.reset()
    times = {"bare": [], "observed": []}
    losses, counts = [], {"bare": [], "observed": []}
    step_id = 0
    try:
        for rnd in range(OBS_ROUNDS):
            for mode in ("bare", "observed"):
                observed = mode == "observed"
                if observed:
                    os.environ["HOROVOD_FLIGHT_DIR"] = tmp
                    os.environ["HOROVOD_GOODPUT_DIR"] = tmp
                else:
                    os.environ.pop("HOROVOD_FLIGHT_DIR", None)
                    os.environ.pop("HOROVOD_GOODPUT_DIR", None)
                torch.cuda.synchronize()
                TF.reset_launch_counts()
                BN.reset_launch_counts()
                if observed:
                    batches = hvd.wrap_data_loader(itertools.repeat(
                        (images, labels), OBS_STEPS))
                    t0 = time.perf_counter()
                    for x, y in batches:
                        with hvd.trace_step(step=step_id):
                            loss = train_step(model, opt, x, y)
                            torch.cuda.synchronize()
                        t1 = time.perf_counter()
                        times[mode].append(t1 - t0)
                        t0 = t1
                        step_id += 1
                        losses.append(float(loss))
                else:
                    for _ in range(OBS_STEPS):
                        t0 = time.perf_counter()
                        loss = train_step(model, opt, images, labels)
                        torch.cuda.synchronize()
                        times[mode].append(time.perf_counter() - t0)
                        losses.append(float(loss))
                counts[mode].append(_obs_counts(TF, BN, OBS_STEPS,
                                                f"{mode} round {rnd + 1}"))
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=30).read().decode()
        flight_path = hvd.dump_flight_recorder()
        ledger_path = GP.dump("explicit")
    finally:
        srv.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"22a: non-finite loss: {losses}")
    n_obs = OBS_STEPS * OBS_ROUNDS
    if hist.total() - hist0 != n_obs:
        raise AssertionError(f"22a: hvd_step_time_seconds counted "
                             f"{hist.total() - hist0}, not {n_obs}")
    samples = _prometheus_text(text)
    if f"hvd_step_time_seconds_count {hist.total():g}" not in text:
        raise AssertionError("22a: the scrape misses the step histogram")
    # the goodput ledger conserves the wall (tests/test_goodput.py:539)
    rep = GP.load_report(tmp)
    led = rep["ranks"][0]
    tot = sum(led["phases"].values()) + led["unattributed_s"]
    if not ledger_path or abs(tot - led["elapsed_s"]) \
            > 0.02 * led["elapsed_s"] + 1e-6:
        raise AssertionError(f"22a: goodput phases {tot} against elapsed "
                             f"{led['elapsed_s']} ({ledger_path})")
    # the flight dump, merged: one complete step span per observed step
    out_path, dumps, offsets = merge_dumps(tmp)
    if not flight_path or len(dumps) != 1:
        raise AssertionError(f"22a: flight dumps {os.listdir(tmp)}")
    with open(out_path) as f:
        trace = json.load(f)
    spans = {}
    for ev in trace["traceEvents"]:
        if ev.get("name", "").startswith("step ") and ev["ph"] in "BE":
            if (ev.get("args") or {}).get("unfinished"):
                raise AssertionError(f"22a: unfinished {ev['name']}")
            spans[ev["name"]] = spans.get(ev["name"], "") + ev["ph"]
    if spans != {f"step {i}": "BE" for i in range(n_obs)}:
        raise AssertionError(f"22a: step spans {spans}")
    ends = [e for e in dumps[0].of_kind("step") if e["ph"] == "E"]
    for e in ends:
        split = e["compute_s"] + e["blocked_s"] + e["input_wait_s"]
        if abs(split - e["wall_s"]) > 5e-6:
            raise AssertionError(f"22a: step {e['step']} split {split} "
                                 f"against wall {e['wall_s']}")
    report = analyze(dumps, offsets)
    ph = report["phases"][0]
    if ph["steps"] != n_obs or abs(
            ph["step_compute_total_s"] + ph["step_blocked_total_s"]
            + sum(e["input_wait_s"] for e in ends)
            - sum(e["wall_s"] for e in ends)) > 1e-3:
        raise AssertionError(f"22a: the analyzer's step split {ph}")
    med = {k: statistics.median(v) for k, v in times.items()}
    ratio = med["observed"] / med["bare"]
    host_us = _observer_host_us(hvd)
    out = {"median_s": med, "ratio": ratio, "times": times,
           "observer_host_us": host_us,
           "launches": counts, "samples": samples,
           "goodput": {k: led[k] for k in ("elapsed_s", "goodput_ratio")},
           "step_mean_s": ph["step_mean_s"]}
    log(f"[obs] 22a ResNet-50 batch {BATCH} bf16, world 1 over NCCL, "
        f"{OBS_ROUNDS} rounds of {OBS_STEPS} bare then {OBS_STEPS} "
        f"observed steps after {OBS_WARMUP} of warm-up: median step bare "
        f"{med['bare']:.4f} s, observed {med['observed']:.4f} s, ratio "
        f"{ratio:.4f}; the observers' host cost alone {host_us:.1f} us per "
        f"step ({OBS_EMPTY} empty steps); steps bare "
        f"{[round(t, 4) for t in times['bare']]}, "
        f"observed {[round(t, 4) for t in times['observed']]}; launches "
        f"per round {counts}; {samples} samples scraped; the flight dump "
        f"merged to {n_obs} complete step spans (analyzer mean "
        f"{ph['step_mean_s']} s); goodput ledger elapsed "
        f"{led['elapsed_s']:.1f} s, ratio {led['goodput_ratio']}; on {gpu}")
    del model, opt, images, labels
    torch.cuda.empty_cache()
    return out


def observability_eager(hvd, torch, gpu: str, device: str = "cuda",
                        model_fn=None, size: int = 224,
                        classes: int = 1000) -> dict:
    """22b: phase 20b's world on the int8 wire, read through the
    metrics registry and the flight ring (the emulated ranks share one
    of each, so the checks sum over them)."""
    from horovod_tpu_torch.ops import quantization as Q
    from horovod_tpu_torch.parallel.emulated import EmulatedWorld
    from horovod_tpu_torch.runtime import flight as FL
    from horovod_tpu_torch.runtime import metrics as M

    n = DP_N
    _, _, subs, _ = _eager_shards(torch, device, model_fn, size, classes)
    wire_c = M.counter("hvd_data_wire_bytes_total")
    logical_c = M.counter("hvd_data_logical_bytes_total")
    neg = M.registry().histogram("hvd_negotiation_seconds")
    os.environ["HOROVOD_COMPRESSION"] = "int8"
    world = EmulatedWorld(torch, n, (Q.LAUNCHES,), sync=device == "cuda",
                          free=True)
    rts = _emu_runtimes(torch, world, device, 900)
    for rt in rts:
        rt.log = []
    FL.reset()
    Q.reset_launch_counts()
    w0, l0, n0 = wire_c.total(), logical_c.total(), neg.total()
    try:
        for _ in range(EAGER_STEPS):
            _threads(lambda r: _eager_step(rts[r], subs[r]), n)
        wire_b, logical_b = wire_c.total() - w0, logical_c.total() - l0
        rounds = sum(rt.rounds for rt in rts)
        lat = neg.total() - n0
        events = FL.recorder().snapshot()
    finally:
        for rt in rts:
            rt.stop()
        os.environ["HOROVOD_COMPRESSION"] = "none"
    moved = sum(sum(world.wire[r].values()) for r in range(n))
    logical = sum(t.numel() * t.element_size() for s in subs
                  for _, t in s) * EAGER_STEPS
    responses = sum(len(rt.log) for rt in rts)
    disp = [e["ph"] for e in events if e["kind"] == "dispatch"]
    want = dict.fromkeys(EAGER_CODEC["int8"], 1)
    bad = [x["launches"] for rt in rts for x in rt.log
           if x["launches"] != want]
    if wire_b != moved or logical_b != logical:
        raise AssertionError(f"22b: wire {wire_b} B / logical {logical_b} "
                             f"B on the counters, the world moved {moved} "
                             f"B of {logical} B")
    if lat != rounds:
        raise AssertionError(f"22b: {lat} negotiation latencies for "
                             f"{rounds} rounds")
    if disp.count("B") != responses or disp.count("E") != responses:
        raise AssertionError(f"22b: dispatch spans {disp.count('B')} B / "
                             f"{disp.count('E')} E for {responses} "
                             "responses")
    if bad or not responses:
        raise AssertionError(f"22b: launches per response {bad}, expected "
                             f"{want}")
    out = {"wire_bytes": wire_b, "logical_bytes": logical_b,
           "rounds": rounds, "responses": responses,
           "launches": [dict(world.launches[r]) for r in range(n)]}
    log(f"[obs] 22b {n} emulated runtimes, int8 wire, {EAGER_STEPS} steps: "
        f"{wire_b} B on the wire of {logical_b} B logical (ratio "
        f"{wire_b / logical_b:.4f}), as the emulated world moved; "
        f"{rounds} rounds, each with its negotiation latency; {responses} "
        f"responses, each with its dispatch span and one B4 and one B5; "
        f"launches per rank {out['launches']}; on {gpu}")
    del rts, world, subs
    torch.cuda.empty_cache()
    return out


def observability(hvd, torch, gpu: str) -> dict:
    """Phase 22 (a-b)."""
    t0 = time.perf_counter()
    out = {"a": observability_resnet(hvd, torch, gpu),
           "b": observability_eager(hvd, torch, gpu)}
    log(f"[obs] phase 22 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 23: the training-health plane and the checkpoint
# ---------------------------------------------------------------------------

HEALTH_WARMUP, HEALTH_STEPS, HEALTH_ROUNDS = 2, 10, 2
HEALTH_EAGER_STEPS = 3
HEALTH_KNOBS = ("HOROVOD_HEALTH", "HOROVOD_HEALTH_SKIP_NONFINITE",
                "HOROVOD_FAULT_SPEC", "HOROVOD_FLIGHT_DIR",
                "HOROVOD_ADAPTIVE_COMPRESSION", "HOROVOD_OVERLAP",
                "HOROVOD_COMPRESSION")


class _EnvKnobs:
    """Sets environment knobs for a block and puts back what was there
    (the health knobs, and any it was given)."""

    def __init__(self, **kv):
        self.kv = kv

    def __enter__(self):
        self.old = {k: os.environ.get(k) for k in (*HEALTH_KNOBS, *self.kv)}
        for k, v in self.kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)

    def __exit__(self, *exc):
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _grads_and_state(model, opt) -> tuple:
    params = list(model.parameters())
    return ([p.detach().clone() for p in params],
            [p.grad.detach().clone() for p in params],
            [opt.optimizer.state[p]["trace"].clone() for p in params])


def _same(xs, ys) -> bool:
    import torch

    return all(torch.equal(a, b) for a, b in zip(xs, ys))


def health_resnet(hvd, torch, gpu: str, profile: str | None = None) -> dict:
    """23a: the bench step health off and on in alternation, the tail on
    captured gradients both ways, then a poisoned step under the skip
    knob.  Returns the model and optimizer for 23c."""
    import tempfile

    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import batch_norm as BN
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.parallel import mesh as PM
    from horovod_tpu_torch.runtime import faults as F
    from horovod_tpu_torch.runtime import health as H
    from horovod_tpu_torch.runtime import metrics as M
    from horovod_tpu_torch.train_step import (softmax_cross_entropy,
                                              synthetic_batch, train_step)

    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0)
    opt = hvd.DistributedOptimizer(
        hvd.fused_update.sgd(model.parameters(), 0.1, momentum=0.9))
    images, labels = synthetic_batch(BATCH, 224, 1000, seed=0)
    for _ in range(HEALTH_WARMUP):
        train_step(model, opt, images, labels)
    torch.cuda.synchronize()
    H.reset()
    times = {"off": [], "on": []}
    losses, counts = [], {"off": [], "on": []}
    for rnd in range(HEALTH_ROUNDS):
        for mode in ("off", "on"):
            with _EnvKnobs(HOROVOD_HEALTH=int(mode == "on")):
                torch.cuda.synchronize()
                TF.reset_launch_counts()
                BN.reset_launch_counts()
                for _ in range(HEALTH_STEPS):
                    t0 = time.perf_counter()
                    loss = train_step(model, opt, images, labels)
                    torch.cuda.synchronize()
                    times[mode].append(time.perf_counter() - t0)
                    losses.append(float(loss))
                counts[mode].append(_obs_counts(
                    TF, BN, HEALTH_STEPS, f"23a health {mode} round "
                    f"{rnd + 1}"))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"23a: non-finite loss: {losses}")
    H.flush()
    norm = M.gauge("hvd_grad_norm").value(group="all")
    ratio_g = M.gauge("hvd_update_ratio").value(group="float32")
    if not (norm > 0 and math.isfinite(norm) and ratio_g > 0):
        raise AssertionError(f"23a: grad norm {norm}, update ratio "
                             f"{ratio_g} not published")
    med = {k: statistics.median(v) for k, v in times.items()}
    ratio = med["on"] / med["off"]
    # the tail on one set of captured gradients, health on and off
    opt.zero_grad(set_to_none=True)
    softmax_cross_entropy(model(images), labels).backward()
    w0, g0, t0_ = _grads_and_state(model, opt)
    params = list(model.parameters())
    hop = PM.flat_hop(None)
    grads = [p.grad for p in params]
    # the statistics alone on the device (CUDA events over 10 calls),
    # then the whole tap and the update ratio each as the host sees it
    # (synchronized around one call, verdict published, median of 10)
    stats_ms = cuda_ms(lambda: H.group_stats(grads), reps=10)

    def serial_ms(fn):
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            H.flush()
        return statistics.median(times)

    tap_ms = serial_ms(lambda: H.tap_gradients(grads, hop))
    # the fused tail's updates are contiguous; a convolution's gradient
    # on the card is channels-last
    upds = [g.contiguous() for g in grads]
    ratio_ms = serial_ms(lambda: H.tap_update_ratio(upds, params))
    if profile:
        stem, ext = os.path.splitext(profile)
        profile_steps(
            torch, lambda: (H.tap_gradients(grads, hop),
                            H.tap_update_ratio(upds, params)),
            (tap_ms + ratio_ms) / 1e3, f"{stem}_health{ext}",
            {"staging copy": ["cat", "copy"],
             "nonzero counts": ["count_nonzero", "nonzero", "ne_"],
             "norms": ["norm", "reduce"]}, "health tap", steps=5)
        H.flush()
    del grads, upds
    res = {}
    for mode in ("on", "off"):
        with torch.no_grad():
            for p, w, g, t in zip(params, w0, g0, t0_):
                p.copy_(w)
                p.grad.copy_(g)
                opt.optimizer.state[p]["trace"].copy_(t)
        with _EnvKnobs(HOROVOD_HEALTH=int(mode == "on")):
            opt.step()
        torch.cuda.synchronize()
        res[mode] = _grads_and_state(model, opt)
    if not (_same(res["on"][0], res["off"][0])
            and _same(res["on"][2], res["off"][2])):
        raise AssertionError("23a: the tail with health on differs from "
                             "the tail with health off")
    del res, g0
    # a poisoned step under the skip knob
    tmp = tempfile.mkdtemp(prefix="hvd_health_")
    H.reset()
    with _EnvKnobs(HOROVOD_HEALTH=1, HOROVOD_HEALTH_SKIP_NONFINITE=1,
                   HOROVOD_FLIGHT_DIR=tmp):
        opt.zero_grad(set_to_none=True)
        softmax_cross_entropy(model(images), labels).backward()
        before = _grads_and_state(model, opt)
        TF.reset_launch_counts()
        with _EnvKnobs(HOROVOD_FAULT_SPEC="nan:grads*"):
            opt.step()
        torch.cuda.synchronize()
        skip_b1 = TF.LAUNCHES["momentum"]
        F._data_cache = ("", [])
        after = _grads_and_state(model, opt)
        nf = M.counter("hvd_nonfinite_total").value(group="float32",
                                                    rank="0")
        skipped = M.counter("hvd_health_skipped_steps_total").total()
        flight_path = hvd.dump_flight_recorder()
        with open(flight_path) as f:
            kinds = [json.loads(ln).get("kind") for ln in f]
        TF.reset_launch_counts()
        loss = train_step(model, opt, images, labels)
        torch.cuda.synchronize()
        clean_b1 = TF.LAUNCHES["momentum"]
        moved = not _same([p.detach() for p in model.parameters()],
                          after[0])
    if not (_same(before[0], after[0]) and _same(before[2], after[2])):
        raise AssertionError("23a: the skipped step changed the "
                             "parameters or the trace")
    if not (nf > 0 and skipped == 1 and "health" in kinds
            and skip_b1 == 0 and clean_b1 == -(-161 // TF.capacity(
                "momentum")) and moved and math.isfinite(float(loss))):
        raise AssertionError(
            f"23a: skip step: nonfinite {nf}, skipped {skipped}, health "
            f"event {'health' in kinds}, B1 {skip_b1} then {clean_b1}, "
            f"moved {moved}, loss {float(loss)}")
    out = {"median_s": med, "ratio": ratio, "times": times,
           "launches": counts, "tap_ms": tap_ms, "stats_ms": stats_ms,
           "ratio_ms": ratio_ms,
           "skip": {"nonfinite": nf, "skipped": skipped,
                    "b1_skipped_step": skip_b1, "b1_next_step": clean_b1},
           "model": model, "opt": opt}
    log(f"[health] 23a ResNet-50 batch {BATCH} bf16, world 1 over NCCL, "
        f"{HEALTH_ROUNDS} rounds of {HEALTH_STEPS} steps health off then "
        f"{HEALTH_STEPS} on after {HEALTH_WARMUP} of warm-up: median step "
        f"off {med['off']:.4f} s, on {med['on']:.4f} s, ratio {ratio:.4f}; "
        f"the tap alone (stats of the 161 gradients, the verdict "
        f"all-gather and its copy to the host) {tap_ms:.4f} ms serially "
        f"({100 * tap_ms / 1e3 / med['off']:.2f}% of the step), its "
        f"statistics {stats_ms:.4f} ms on the device, the update ratio "
        f"{ratio_ms:.4f} ms serially; steps off "
        f"{[round(t, 4) for t in times['off']]}, "
        f"on {[round(t, 4) for t in times['on']]}; launches per round "
        f"{counts}; the tail on captured gradients bit for bit health on "
        f"and off; under HOROVOD_HEALTH_SKIP_NONFINITE=1 a nan:grads* step "
        f"held the parameters and the trace bit for bit with {skip_b1} B1 "
        f"launches, hvd_nonfinite_total{{float32, rank 0}} {nf:g}, "
        f"{skipped:g} step skipped, a health event on the flight ring; the "
        f"next clean step launched {clean_b1} B1 and moved the weights; "
        f"on {gpu}")
    return out


def health_eager(hvd, torch, gpu: str, device: str = "cuda",
                 model_fn=None, size: int = 224,
                 classes: int = 1000) -> dict:
    """23b: phase 20b's four emulated runtimes on the int8 wire with
    health on and ``nan@rank2:grad_buffer*:round2``; then the same with
    ``HOROVOD_ADAPTIVE_COMPRESSION=1`` and the overlap schedule."""
    from horovod_tpu_torch.ops import quantization as Q
    from horovod_tpu_torch.optim import distributed as D
    from horovod_tpu_torch.parallel.emulated import EmulatedWorld
    from horovod_tpu_torch.runtime import faults as F
    from horovod_tpu_torch.runtime import health as H

    n = DP_N
    _, _, subs, _ = _eager_shards(torch, device, model_fn, size, classes)
    # under the optimizer's eager names, which the fault rule matches
    subs = [[("grad_buffer." + k.split(".", 1)[1], t) for k, t in sub]
            for sub in subs]
    verdicts = []
    real = H.publish_verdict

    def record(g, idx=None, groups=(), sentinel=True):
        if idx in (None, 0):  # the emulated ranks share one verdict
            verdicts.append((g.copy(), groups))
        real(g, idx, groups, sentinel)

    out = {}
    for epoch, (name, knobs) in enumerate((
            ("health", dict(HOROVOD_HEALTH=1, HOROVOD_COMPRESSION="int8",
                            HOROVOD_FAULT_SPEC="nan@rank2:grad_buffer*:"
                                               "round2")),
            ("adaptive", dict(HOROVOD_HEALTH=1, HOROVOD_COMPRESSION="int8",
                              HOROVOD_ADAPTIVE_COMPRESSION=1,
                              HOROVOD_OVERLAP=1))), 950):
        H.reset()
        F._data_cache = ("", [])
        D._M_RESID_RATIO.reset()
        verdicts.clear()
        H.publish_verdict = record
        try:
            with _EnvKnobs(**knobs):
                world = EmulatedWorld(torch, n, (Q.LAUNCHES,),
                                      sync=device == "cuda", free=True)
                rts = _emu_runtimes(torch, world, device, epoch)
                for rt in rts:
                    rt.log = []
                Q.reset_launch_counts()
                try:
                    # round 2 comes in the third step
                    for _ in range(HEALTH_EAGER_STEPS):
                        _threads(lambda r: _eager_step(rts[r], subs[r]), n)
                finally:
                    for rt in rts:
                        rt.stop()
                H.flush()
        finally:
            H.publish_verdict = real
            F._data_cache = ("", [])
        responses = sum(len(rt.log) for rt in rts)
        bad = [v for v, g in verdicts if (v[:, 3::3] > 0).any()]
        culprits = sorted({(int(row[0]), g[0]) for v, g in verdicts
                           for row in v if row[3] > 0})
        series = D._M_RESID_RATIO.series()
        out[name] = {"responses": responses, "verdicts": len(verdicts),
                     "poisoned_verdicts": len(bad), "culprits": culprits,
                     "launches": [dict(world.launches[r])
                                  for r in range(n)],
                     "ratio_series": {s["labels"]["bucket"]: s["value"]
                                      for s in series}}
        if name == "health":
            want = dict.fromkeys(EAGER_CODEC["int8"], 1)
            wrong = [x["launches"] for rt in rts for x in rt.log
                     if x["launches"] != want]
            if wrong or not responses:
                raise AssertionError(f"23b: launches per response {wrong}"
                                     f", expected {want}")
            if culprits != [(2, "float32")] or len(bad) != 1 \
                    or len(verdicts) != responses // n:
                raise AssertionError(
                    f"23b: {len(verdicts)} verdicts published for "
                    f"{responses} responses of {n} ranks, {len(bad)} "
                    f"poisoned, culprits {culprits}")
        else:
            vals = out[name]["ratio_series"]
            if sorted(vals) != [str(b) for b in range(4)] or not all(
                    math.isfinite(v) for v in vals.values()):
                raise AssertionError(f"23b: hvd_compression_residual_ratio "
                                     f"{vals}, expected 4 finite buckets")
        del world, rts
    log(f"[health] 23b {n} emulated runtimes, int8 wire, "
        f"{HEALTH_EAGER_STEPS} "
        f"steps, HOROVOD_HEALTH=1 and nan@rank2:grad_buffer*:round2: "
        f"{out['health']['verdicts']} verdicts published (one per fused "
        f"response, the emulated ranks share the process), "
        f"{out['health']['poisoned_verdicts']} naming "
        f"{out['health']['culprits']}; one B4 and one B5 per fused float "
        f"response (launches per rank {out['health']['launches']}); with "
        f"HOROVOD_ADAPTIVE_COMPRESSION=1 and HOROVOD_OVERLAP=1 "
        f"hvd_compression_residual_ratio per bucket "
        f"{out['adaptive']['ratio_series']}; on {gpu}")
    del subs
    torch.cuda.empty_cache()
    return out


def health_checkpoint(hvd, torch, gpu: str, model, opt,
                      device: str = "cuda") -> dict:
    """23c: the ResNet-50 state after 23a (parameters, BatchNorm buffers,
    the momentum trace) saved and restored into fresh objects on the
    card, the goodput ledger's checkpoint seconds against the wall; then
    phase 14a's emulated stage-2 shard states of a seeded trace over the
    ResNet-50 leaves, saved at four emulated ranks through their host
    form and re-cut for two."""
    import shutil
    import tempfile

    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.optim import distributed as D
    from horovod_tpu_torch.perf import goodput as GP

    tmp = tempfile.mkdtemp(prefix="hvd_ckpt_")
    try:
        state = {"model": model.state_dict(), "opt": opt.state_dict(),
                 "step": 1}
        GP.reset()
        GP.start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ckpt.save(tmp, state, 1)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ckpt.restore(tmp, 1)
        restore_s = time.perf_counter() - t0
        ledger_s = GP.ledger().snapshot()["phases"]["checkpoint"]
        wall = save_s + restore_s
        nbytes = os.path.getsize(os.path.join(path, "tree.pkl"))
        fresh = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=1)
        fopt = hvd.DistributedOptimizer(
            hvd.fused_update.sgd(fresh.parameters(), 0.1, momentum=0.9))
        fresh.load_state_dict(back["model"])
        fopt.load_state_dict(back["opt"])
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(
            model.state_dict().values(), fresh.state_dict().values()))
        same_trace = all(
            torch.equal(opt.optimizer.state[p]["trace"],
                        fopt.optimizer.state[q]["trace"])
            for p, q in zip(model.parameters(), fresh.parameters()))
        on_card = all(p.device.type == device for p in fresh.parameters())
        if not (same and same_trace and on_card):
            raise AssertionError(f"23c: restored state equal {same}, trace "
                                 f"{same_trace}, on the card {on_card}")
        if abs(ledger_s - wall) > 0.02 * wall + 5e-3:
            raise AssertionError(f"23c: goodput checkpoint {ledger_s} s "
                                 f"against the wall {wall} s")
        del back, fresh, fopt, state
        # 14a's emulated stage-2 shard states at four ranks, re-cut for two
        params = list(model.parameters())
        gen = torch.Generator(device=device).manual_seed(14)
        trace = [torch.randn(p.shape, device=device, generator=gen)
                 for p in params]
        lay = D._shard_layout(trace, ZERO_N)
        shards = [D.ShardedState([{"trace": D._rank_shard(
            trace, lay, 0, j).clone()}], None, lay) for j in range(ZERO_N)]
        full = torch.cat([s.inner[0]["trace"] for s in shards])
        host = D.sharded_state_to_host(shards[0], gather=lambda t: full)
        ckpt.save(tmp, {"opt": host}, 2)
        back = ckpt.restore(tmp, 2)["opt"]
        cuts = [D.sharded_state_from_host(back, world=2, rank=r)
                for r in range(2)]
        again = torch.cat([c.inner[0]["trace"].to(device) for c in cuts])
        total = sum(lay.sizes[0])
        flat = torch.cat([t.reshape(-1) for t in trace])
        if not (torch.equal(again[:total], flat)
                and torch.equal(full[:total], flat)
                and not bool(again[total:].any())):
            raise AssertionError("23c: the 4-to-2 re-cut of the stage-2 "
                                 "state differs from the saved state")
        out = {"save_s": save_s, "restore_s": restore_s,
               "ledger_s": ledger_s, "bytes": nbytes,
               "reshard": {"padded4": lay.padded[0],
                           "padded2": cuts[0].layout.padded[0]}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        GP.reset()
    log(f"[health] 23c checkpoint of the ResNet-50 state after 23a "
        f"(parameters, BatchNorm buffers, momentum trace: tree.pkl "
        f"{nbytes} B): save {save_s:.4f} s, restore {restore_s:.4f} s "
        f"(the goodput ledger's checkpoint phase {ledger_s:.4f} s of "
        f"{wall:.4f} s), restored into a fresh model and optimizer on the "
        f"card bit for bit; phase 14a's stage-2 trace shards at 4 "
        f"emulated ranks (padded {out['reshard']['padded4']}) saved "
        f"through their host form and re-cut for 2 (padded "
        f"{out['reshard']['padded2']}): gathered bit for bit; on {gpu}")
    return out


def health_plane(hvd, torch, gpu: str, profile: str | None = None) -> dict:
    """Phase 23 (a-c)."""
    t0 = time.perf_counter()
    a = health_resnet(hvd, torch, gpu, profile)
    model, opt = a.pop("model"), a.pop("opt")
    out = {"a": a}
    out["c"] = health_checkpoint(hvd, torch, gpu, model, opt)
    del model, opt
    torch.cuda.empty_cache()
    out["b"] = health_eager(hvd, torch, gpu)
    log(f"[health] phase 23 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# The elastic plane (phase 24): the native KV store, restart from the last
# complete checkpoint and the preemption drain, every run through
# ``python -m horovod_tpu_torch.run`` on phase 6's ResNet-50 step
# ---------------------------------------------------------------------------

P24_STEPS = 8           # the uninterrupted and the restarted run
P24_SAVES = (2, 4)      # attempt 0's durable commits
P24_KILL = 5            # attempt 0 SIGKILLs itself after this step
P24_NOTICE = 3          # the drain run SIGTERMs its rank after this step
P24_RESUMED = 2         # steps the resumed drain run takes
P24_KV_REPS = 1000
P24_TAG = "phase24"


def _p24_worker(mode: str, d: str) -> int:
    """One rank of a phase-24 launch (``--phase24-worker MODE DIR``): the
    ResNet-50 bench step with deterministic cuDNN.  ``restart``: an
    attempt-0 run commits durably at ``P24_SAVES``, leaves a torn
    ``step_6`` and SIGKILLs itself after step ``P24_KILL``; attempt 1
    (``HOROVOD_RESUME_STEP``) restores that step and trains on to
    ``P24_STEPS``.  ``plain``: ``P24_STEPS`` steps, no checkpoint.
    ``drain``: elastic, a durable commit every step, SIGTERM after step
    ``P24_NOTICE``.  ``apdrain`` (phase 26b): as ``drain``, but the notice
    is ``python -m horovod_tpu_torch.run --preempt 0`` run from the rank,
    which the launcher's autopilot turns into the drain.  ``resume``:
    elastic, restores the newest complete commit and takes
    ``P24_RESUMED`` steps.  Prints one JSON line."""
    t_proc = time.time()
    import hashlib
    import signal

    import numpy as np
    import torch

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import batch_norm as BN
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.ops import quantization as Q
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    counters = (TF, FA, Q, BN)
    out = {"mode": mode, "t_proc": t_proc,
           "attempt": os.environ.get("HOROVOD_RESTART_ATTEMPT"),
           "import_s": time.time() - t_proc}
    t0 = time.time()
    hvd.init()
    out["init_s"] = time.time() - t0
    t0 = time.time()
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0)
    opt = hvd.DistributedOptimizer(
        hvd.fused_update.sgd(model.parameters(), 0.1, momentum=0.9))
    images, labels = synthetic_batch(BATCH, 224, 1000, seed=0)
    torch.cuda.synchronize()
    out["build_s"] = time.time() - t0
    state = elastic.ElasticState(
        params=model, opt_state=opt,
        checkpoint_dir=None if mode == "plain" else d)

    def same_as(snap) -> bool:
        now = {"params": elastic._params_to_host(model),
               "opt_state": elastic._opt_to_host(opt)}

        def eq(a, b):
            # a snapshot read back from disk holds CPU tensors
            a, b = (ckpt.to_numpy(x) if torch.is_tensor(x) else x
                    for x in (a, b))
            if isinstance(a, dict) and isinstance(b, dict):
                return a.keys() == b.keys() and all(eq(a[k], b[k])
                                                    for k in a)
            if isinstance(a, (list, tuple)):
                return len(a) == len(b) and all(map(eq, a, b))
            if isinstance(a, np.ndarray):
                return a.dtype == b.dtype and np.array_equal(a, b)
            return a == b
        return eq(now["params"], snap["params"]) and \
            eq(now["opt_state"], snap["opt_state"])

    def digest() -> str:
        h = hashlib.sha256()
        for v in model.state_dict().values():
            h.update(v.detach().float().cpu().numpy().tobytes())
        for st in opt.optimizer.state.values():
            for k in sorted(st):
                if torch.is_tensor(st[k]):
                    h.update(st[k].float().cpu().numpy().tobytes())
        return h.hexdigest()

    resume = os.environ.get("HOROVOD_RESUME_STEP")
    if mode == "restart" and resume is not None:
        t0 = time.time()
        snap = ckpt.restore(d, step=int(resume))
        state.load(snap)
        torch.cuda.synchronize()
        out["restore_s"] = time.time() - t0
        out["restored_equal"] = same_as(snap)
        out["resumed_at"] = state.step
    if mode == "resume":
        t0 = time.time()
        step = ckpt.latest_complete(d)
        snap = ckpt.restore(d, step=step)
        state.load(snap)
        torch.cuda.synchronize()
        out["restore_s"] = time.time() - t0
        out["restored_equal"] = same_as(snap)
        out["resumed_at"] = state.step
        out["commit_step"] = int(snap["step"])
    total = {"restart": P24_STEPS, "plain": P24_STEPS,
             "drain": P24_STEPS,
             # the drain must come before the steps run out
             "apdrain": 4 * P24_STEPS,
             "resume": state.step + P24_RESUMED}[mode]
    losses, step_end, step_s = [], [], []
    for m in counters:
        m.reset_launch_counts()

    def one_step() -> None:
        t = time.time()
        loss = train_step(model, opt, images, labels)
        torch.cuda.synchronize()
        state.step += 1
        losses.append(float(loss))
        step_end.append(time.time())
        step_s.append(step_end[-1] - t)

    def report(**extra) -> None:
        out.update(extra)
        out.update({"steps": len(losses), "losses": losses,
                    "step_end": step_end, "step_s": step_s,
                    "final_step": state.step,
                    # every kernel's count, the off-path ones counted too
                    "launches": {k: v for m in counters
                                 for k, v in m.LAUNCHES.items()}})
        print(json.dumps({P24_TAG: out}), flush=True)

    if mode in ("restart", "plain"):
        while state.step < total:
            one_step()
            if mode == "restart" and resume is None:
                if state.step in P24_SAVES:
                    state.commit()
                if state.step == P24_KILL:
                    torn = os.path.join(d, f"step_6.tmp.{os.getpid()}")
                    os.makedirs(torn, exist_ok=True)
                    with open(os.path.join(torn, "tree.pkl"), "wb") as f:
                        f.write(b"torn")
                    report(digest=digest(), t_kill=time.time())
                    os.kill(os.getpid(), signal.SIGKILL)
        report(digest=digest())
        hvd.shutdown()
        return 0

    def train(state):
        while state.step < total:
            state.commit()
            elastic.poll()
            one_step()
            if mode == "drain" and state.step == P24_NOTICE:
                out["t_notice"] = time.time()
                os.kill(os.getpid(), signal.SIGTERM)
            if mode == "apdrain" and state.step == P24_NOTICE:
                out["t_notice"] = time.time()
                req = subprocess.run(
                    [sys.executable, "-m", "horovod_tpu_torch.run",
                     "--preempt", "0"], capture_output=True, text=True,
                    timeout=60)
                out["preempt_rc"] = req.returncode
                out["t_sent"] = time.time()
        state.commit()
        return state

    try:
        elastic.run(state, train)
    except SystemExit:
        snap = hvd.metrics()["metrics"].get("hvd_preempt_drain_seconds", {})
        series = (snap.get("series") or [{}])[0]
        report(t_exit=time.time(), commit_s=state.last_commit_s,
               drain_metric_s=series.get("sum"),
               drain_commit_step=state.step, digest=digest())
        raise
    report(digest=digest())
    hvd.shutdown()
    return 0


def _p24_launch(args: list, mode: str, d: str, timeout: float = 300,
                **env_extra) -> tuple:
    """Run ``python -m horovod_tpu_torch.run ARGS -- python chip_smoke.py
    --phase24-worker MODE D``; its exit code, its workers' JSON records
    in order, and its stderr."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env.update({"PYTHONPATH": root + os.pathsep + env.get("PYTHONPATH", ""),
                "HOROVOD_FUSED_UPDATE": "1",
                "HOROVOD_CHECKPOINT_KEEP": "2",
                "HOROVOD_METRICS_PUBLISH_INTERVAL": "0"})
    env.update(env_extra)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", *args, "--",
           sys.executable, os.path.abspath(__file__), "--phase24-worker",
           mode, d]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout, cwd=root)
    recs = []
    for ln in proc.stdout.splitlines():
        _, _, rest = ln.partition(">:")
        if rest.startswith("{") and P24_TAG in rest:
            recs.append(json.loads(rest)[P24_TAG])
    log(f"[elastic] {' '.join(args)} ({mode}): rc {proc.returncode}, "
        f"{time.perf_counter() - t0:.1f} s")
    return proc.returncode, recs, proc.stderr


def _p24_counts(rec: dict, what: str) -> dict:
    """One B1 and RESNET50_BN of each of N1-N4 per step of a launch, and
    no launch of any other kernel; every count as the launch counted it."""
    n, got = rec["steps"], rec["launches"]
    want = {k: 0 for k in got}
    want.update({"momentum": n, **dict.fromkeys(BN_KERNELS,
                                                RESNET50_BN * n)})
    if got != want:
        raise AssertionError(f"[elastic] {what}: {n} steps launched "
                             f"{got}, want {want}")
    return {"steps": n, **got}


def kv_store_phase(gpu: str) -> dict:
    """24a: the port's KV store builds (its own library), refuses a
    wrong secret, and its set/get round trip over loopback."""
    from horovod_tpu_torch import _build
    from horovod_tpu_torch.runtime import kvstore

    t0 = time.perf_counter()
    path = kvstore.library_path()
    info = _build.build_info[kvstore.LIB_NAME]
    if "libhvdtorchkv_" not in os.path.basename(path):
        raise AssertionError(f"[kv] the KV store loaded {path}")
    log(f"[kv] built {path} in {info['seconds']:.1f} s "
        f"(g++ log: {info['log'].strip() or 'reused'})")
    srv = kvstore.KVStoreServer(secret=b"phase24-secret")
    try:
        try:
            kvstore.KVStoreClient("127.0.0.1", srv.port,
                                  connect_timeout_s=2, secret=b"wrong")
        except OSError as exc:
            log(f"[kv] a wrong secret is refused: {exc}")
        else:
            raise AssertionError("[kv] a wrong secret was accepted")
        c = kvstore.KVStoreClient("127.0.0.1", srv.port,
                                  secret=b"phase24-secret")
        us = []
        for i in range(P24_KV_REPS):
            t = time.perf_counter()
            c.set("rt", str(i))
            got = c.try_get("rt")
            us.append((time.perf_counter() - t) * 1e6)
            if got != str(i):
                raise AssertionError(f"[kv] read {got!r} after set {i}")
        c.close()
    finally:
        srv.stop()
    med = statistics.median(us)
    log(f"[kv] set+get round trip over loopback: median {med:.1f} us of "
        f"{P24_KV_REPS} (p90 {sorted(us)[int(0.9 * len(us))]:.1f} us), "
        f"host of {gpu}; phase 24a {time.perf_counter() - t0:.1f} s")
    return {"roundtrip_us": med, "library": os.path.basename(path)}


def elastic_plane(gpu: str, work: str) -> dict:
    """Phase 24: the KV store (a), a restart from the last complete
    checkpoint against an uninterrupted launch (b), a preemption drain
    and its resume (c), every run launched by the port's launcher."""
    import shutil

    t_phase = time.perf_counter()
    out = {"a": kv_store_phase(gpu)}
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # 24b: restart from the last complete checkpoint
    d = os.path.join(work, "restart")
    rc, recs, err = _p24_launch(
        ["-np", "1", "--restart-attempts", "1", "--checkpoint-dir", d],
        "restart", d)
    if rc != 0 or len(recs) != 2:
        raise AssertionError(f"[elastic] restart launch rc {rc}, "
                             f"{len(recs)} records:\n{err[-4000:]}")
    if "resuming from complete checkpoint step 4" not in err:
        raise AssertionError(f"[elastic] no resume from step 4:\n"
                             f"{err[-3000:]}")
    a0, a1 = recs
    if a1["resumed_at"] != P24_SAVES[-1] or not a1["restored_equal"]:
        raise AssertionError(f"[elastic] attempt 1 resumed at "
                             f"{a1['resumed_at']}, restored state equal to"
                             f" the step-4 snapshot: "
                             f"{a1['restored_equal']}")
    rc, plain, err = _p24_launch(["-np", "1"], "plain", d + "_plain")
    if rc != 0 or len(plain) != 1:
        raise AssertionError(f"[elastic] uninterrupted launch rc {rc}:\n"
                             f"{err[-3000:]}")
    plain = plain[0]
    same = a1["digest"] == plain["digest"]
    if not same:
        raise AssertionError(
            f"[elastic] the resumed step-{P24_STEPS} state (sha256 "
            f"{a1['digest']}) differs from the uninterrupted launch's "
            f"({plain['digest']}); losses {a1['losses']} against "
            f"{plain['losses'][P24_SAVES[-1]:]}")
    if a1["losses"] != plain["losses"][P24_SAVES[-1]:]:
        raise AssertionError("[elastic] resumed losses differ")
    last = a0["step_end"][-1]
    first = a1["step_end"][0]
    parts = {"respawn_s": a1["t_proc"] - a0["t_kill"],
             "import_s": a1["import_s"], "init_s": a1["init_s"],
             "build_s": a1["build_s"], "restore_s": a1["restore_s"],
             "first_step_s": a1["step_s"][0]}
    parts["other_s"] = (first - last) - sum(parts.values())
    out["b"] = {"downtime_s": first - last, **parts,
                "launches": {"attempt0": _p24_counts(a0, "attempt 0"),
                             "attempt1": _p24_counts(a1, "attempt 1"),
                             "plain": _p24_counts(plain, "uninterrupted")},
                "bit_for_bit": same}
    log(f"[elastic] 24b: step-{P24_STEPS} parameters and trace bit for bit"
        f" with the uninterrupted launch; downtime (step {P24_KILL} end to "
        f"the resumed step {P24_KILL} end) {first - last:.3f} s: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
        + f"; on {gpu}")
    # 24c: the preemption drain, then the resume on the same directory
    d = os.path.join(work, "drain")
    grace = float(os.environ.get("HOROVOD_PREEMPT_GRACE_SECONDS") or 30)
    rc, recs, err = _p24_launch(["-np", "1", "--elastic"], "drain", d)
    if rc != 0 or len(recs) != 1:
        raise AssertionError(f"[elastic] drain launch rc {rc}:\n"
                             f"{err[-4000:]}")
    if "exited after graceful preemption drain (rc=0)" not in err:
        raise AssertionError(f"[elastic] the drained rank was not "
                             f"classified preempted:\n{err[-3000:]}")
    dr = recs[0]
    rc, recs, err = _p24_launch(["-np", "1", "--elastic"], "resume", d)
    if rc != 0 or len(recs) != 1:
        raise AssertionError(f"[elastic] resume launch rc {rc}:\n"
                             f"{err[-4000:]}")
    rs = recs[0]
    if not rs["restored_equal"] or rs["commit_step"] != \
            dr["drain_commit_step"] or rs["resumed_at"] != rs["commit_step"]:
        raise AssertionError(f"[elastic] resume: {rs}, drain: {dr}")
    drain_s = dr["t_exit"] - dr["t_notice"]
    out["c"] = {"drain_s": drain_s, "metric_s": dr["drain_metric_s"],
                "commit_s": dr["commit_s"], "grace_s": grace,
                "commit_step": dr["drain_commit_step"],
                "launches": {"drain": _p24_counts(dr, "drain"),
                             "resume": _p24_counts(rs, "resume")}}
    if drain_s > grace:
        raise AssertionError(f"[elastic] drain {drain_s:.1f} s past the "
                             f"{grace:.0f} s grace")
    log(f"[elastic] 24c: SIGTERM after step {P24_NOTICE}, drained at the "
        f"commit of step {dr['drain_commit_step']}; notice to exit "
        f"{drain_s:.3f} s, hvd_preempt_drain_seconds "
        f"{dr['drain_metric_s']:.3f} s, emergency commit {dr['commit_s']:.3f}"
        f" s, against HOROVOD_PREEMPT_GRACE_SECONDS={grace:.0f}; resumed at "
        f"step {rs['resumed_at']} bit for bit; on {gpu}")
    shutil.rmtree(work, ignore_errors=True)
    log(f"[elastic] phase 24 took {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 25: the timeline and the autotuner
# ---------------------------------------------------------------------------

TL_WARM, TL_ROUNDS, TL_STEPS = 2, 3, 4  # 25a: warm-up; off/on rounds, steps
TL_EVENT_REPS = 20000   # 25a: native writer calls timed on the host
TUNE_STEPS = 6          # 25b: steps of the four emulated runtimes
TUNE_ENV = {"HOROVOD_AUTOTUNE": "1", "HOROVOD_ADAPTIVE_COMPRESSION": "1",
            "HOROVOD_OVERLAP": "1", "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "1",
            "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "0",
            "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "3"}
TUNED_KNOBS = ("fusion_threshold", "cycle_time_ms", "overlap_chunks",
               "zero_prefetch_chunks", "hierarchical_allreduce",
               "hierarchical_allgather", "bucket_compression")


def _restore_env(saved: dict) -> None:
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def timeline_world1(hvd, torch, gpu: str, device: str = "cuda",
                    model_fn=None, batch: int = BATCH, size: int = 224,
                    classes: int = 1000) -> dict:
    """Phase 25a: ``init()`` under ``HOROVOD_TIMELINE`` and
    ``HOROVOD_TIMELINE_MARK_CYCLES`` at world 1 over NCCL, the bench
    ResNet-50 step (224 px, batch 256, bf16) on the eager plane: after
    the backward, phase 20a's 161 gradients through
    ``hvd.allreduce_async_`` in hook order under their frontend names,
    then momentum SGD's fused tail over all of them
    (``momentum_update_multi``: one B1, and 53 of each of N1-N4 per
    step).  ``TL_ROUNDS`` rounds of ``TL_STEPS`` steps with the
    runtime's writer detached (the knob unset) and attached, in
    alternation; the trace parses, each gradient's row holds one
    ``NEGOTIATE_ALLREDUCE`` B and E, one ``RANK0_READY`` and one
    ``XLA_ALLREDUCE`` B and E per traced step, and cycle marks; both
    medians and their ratio, and the writer's host time per step (an
    event's stamp, append and flush timed alone, times the events per
    step)."""
    import tempfile

    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import batch_norm as BN
    from horovod_tpu_torch.ops import eager as E
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.runtime import timeline as TLM
    from horovod_tpu_torch.train_step import (softmax_cross_entropy,
                                              synthetic_batch)

    if model_fn is None:
        def model_fn():
            return ResNet50(num_classes=classes, dtype=torch.bfloat16,
                            seed=0)
    tmp = tempfile.mkdtemp(prefix="hvd_tl_")
    path = os.path.join(tmp, "timeline.json")
    saved = {k: os.environ.get(k) for k in
             ("HOROVOD_TIMELINE", "HOROVOD_TIMELINE_MARK_CYCLES")}
    os.environ["HOROVOD_TIMELINE"] = path
    os.environ["HOROVOD_TIMELINE_MARK_CYCLES"] = "1"
    try:
        hvd.init(device=device)
        rt = E._runtime()
        tl = rt.timeline
        if tl is None or basics.state().timeline is not tl:
            raise AssertionError("25a: the runtime opened no timeline")
        coord = rt.controller.coordinator

        def attach(on: bool) -> None:
            rt.timeline = coord.timeline = tl if on else None

        attach(False)
        model = model_fn()
        images, labels = synthetic_batch(batch, size, classes, seed=0,
                                         device=device)
        label = {id(p): f"allreduce.{n}" for n, p in model.named_parameters()}
        order = [(label[id(p)], p) for p in
                 _hook_order(torch, model, images, labels)]
        names = [n for n, _ in order]
        traces = [torch.zeros_like(p) for _, p in order]

        def train_step():
            model.train()
            model.zero_grad(set_to_none=True)
            loss = softmax_cross_entropy(model(images), labels)
            loss.backward()
            for h in [hvd.allreduce_async_(p.grad, name=n)
                      for n, p in order]:
                hvd.synchronize(h)
            with torch.no_grad():
                us, _ = TF.momentum_update_multi(
                    [p.grad for _, p in order], traces, 1, 0.9, -0.1,
                    t_outs=traces)
                for (_, p), u in zip(order, us):
                    p.add_(u)
            return loss.detach()

        for _ in range(TL_WARM):
            train_step()
        torch.cuda.synchronize()
        times = {"off": [], "on": []}
        counts = {"off": [], "on": []}
        losses = []
        for _ in range(TL_ROUNDS):
            for mode in ("off", "on"):
                attach(mode == "on")
                TF.reset_launch_counts()
                BN.reset_launch_counts()
                for _ in range(TL_STEPS):
                    t0 = time.perf_counter()
                    loss = train_step()
                    torch.cuda.synchronize()
                    times[mode].append(time.perf_counter() - t0)
                    losses.append(float(loss))
                counts[mode].append({"momentum": TF.LAUNCHES["momentum"],
                                     **{k: BN.LAUNCHES[k]
                                        for k in BN_KERNELS}})
        attach(True)
        del model, images, labels, order, traces
        hvd.shutdown()  # closes the writer: the footer lands
        if basics.state().timeline is not None:
            raise AssertionError("25a: shutdown() left the timeline open")
    finally:
        _restore_env(saved)
    with open(path) as f:
        events = json.load(f)
    traced = TL_ROUNDS * TL_STEPS
    rows = {e["tid"]: e["args"]["name"] for e in events
            if e["ph"] == "M" and e["name"] == "thread_name"}
    per: dict = {}
    cycles = 0
    for e in events:
        if e["ph"] == "M":
            continue
        if e["tid"] == 0:
            cycles += e["name"] == "CYCLE_START"
            continue
        key = (e["name"], e["ph"])
        row = per.setdefault(rows[e["tid"]], {})
        row[key] = row.get(key, 0) + 1
    want = {("NEGOTIATE_ALLREDUCE", "B"): traced,
            ("NEGOTIATE_ALLREDUCE", "E"): traced,
            ("RANK0_READY", "i"): traced,
            ("XLA_ALLREDUCE", "B"): traced, ("XLA_ALLREDUCE", "E"): traced}
    if sorted(per) != sorted(names):
        raise AssertionError(f"25a: {len(per)} rows in the trace, expected "
                             f"the {len(names)} gradients")
    for name in names:
        if per[name] != want:
            raise AssertionError(f"25a: row {name}: {per[name]}, expected "
                                 f"{want}")
    if cycles < 1:
        raise AssertionError("25a: no CYCLE_START under "
                             "HOROVOD_TIMELINE_MARK_CYCLES")
    want_counts = {"momentum": TL_STEPS,
                   **{k: TL_STEPS * RESNET50_BN for k in BN_KERNELS}}
    for mode, cs in counts.items():
        if any(c != want_counts for c in cs):
            raise AssertionError(f"25a {mode}: launches {cs}, expected "
                                 f"{want_counts} per round")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"25a: losses {losses}")
    # the writer's cost on the runtime's threads, timed alone on a
    # scratch writer: the events' stamps and appends, and the flushes
    # that hand them to the native thread (one per FLUSH_AT events)
    bench = TLM.make_timeline(os.path.join(tmp, "bench.json"))
    t0 = time.perf_counter()
    for _ in range(TL_EVENT_REPS):
        bench.negotiate_start("allreduce.layer1.0.conv1.weight",
                              "allreduce")
    bench.flush()
    call_us = (time.perf_counter() - t0) / TL_EVENT_REPS * 1e6
    bench.close()
    per_step = (sum(sum(r.values()) for r in per.values()) + cycles) / traced
    med = {m: statistics.median(v) for m, v in times.items()}
    out = {"median_s": med, "ratio": med["on"] / med["off"],
           "events_per_step": per_step, "call_us": call_us,
           "writer_ms_per_step": per_step * call_us / 1e3,
           "cycles": cycles, "rows": len(per), "traced_steps": traced,
           "launches": counts, "trace_bytes": os.path.getsize(path)}
    log(f"[timeline] 25a world 1 over NCCL, the ResNet-50 step (224 px, "
        f"batch {batch}, bf16) with its {len(names)} gradients through "
        f"hvd.allreduce_async_ and the fused momentum SGD's tail, "
        f"{TL_ROUNDS} x {TL_STEPS} steps "
        f"each way: the trace ({out['trace_bytes']} B) parses; each of the "
        f"{len(names)} gradients' rows holds NEGOTIATE_ALLREDUCE B/E, "
        f"RANK0_READY and XLA_ALLREDUCE B/E once per traced step "
        f"({traced}); {cycles} CYCLE_START marks; one B1 and "
        f"{RESNET50_BN} of each of N1-N4 per step either way; median step "
        f"on {med['on']:.4f} s, off {med['off']:.4f} s, ratio "
        f"{out['ratio']:.4f}; {per_step:.1f} events per step at "
        f"{call_us:.3f} us each (stamp, append and flush): "
        f"{out['writer_ms_per_step']:.3f} ms of host time per step; on "
        f"{gpu}")
    return out


def _tune_runtime_class(world):
    """Phase 20b's ``EmuRuntime`` that also logs, per executed response,
    the round, this rank's tuned knobs (and its cache probing), the wire
    mode of each overlap bucket and its own B4-B7 launches (the codec
    counters' changes the world booked to this rank)."""
    import collections
    import hashlib

    from horovod_tpu_torch.common import config as C
    from horovod_tpu_torch.common.types import dtype_from_code
    from horovod_tpu_torch.ops import eager_exec as EX
    from horovod_tpu_torch.ops import overlap as OV
    from horovod_tpu_torch.runtime.background import BackgroundRuntime

    class TuneRuntime(BackgroundRuntime):
        log = None

        def _execute(self, resp):
            r = self.rank
            if resp.kind in ("join", "error"):
                with world.hold(r):
                    super()._execute(resp)
                return
            knobs = {k: C.get(k) for k in TUNED_KNOBS}
            knobs["cache_active"] = self.controller.cache_active
            dtype = dtype_from_code(resp.dtype_code)
            total = sum(math.prod(s) for s in resp.shapes)
            shard = -(-total // self.world)
            modes = OV.resolve_bucket_modes(
                len(OV.bucket_bounds(shard)), EX.wire_mode(dtype), dtype)
            # the world books each counter change to the rank whose turn
            # it was (a transfer hands the device to the other ranks)
            la = collections.Counter(world.launches[r])
            with world.hold(r):
                super()._execute(resp)
            launches = {k: world.launches[r][k] - la[k] for k in CODECS}
            self.log.append({
                "round": self.controller.round - 1,
                "digest": hashlib.sha256(json.dumps(
                    knobs, sort_keys=True).encode()).hexdigest()[:16],
                "knobs": knobs, "names": list(resp.names),
                "modes": modes, "guard": EX._eager_guard_signal(modes),
                "launches": launches})

    return TuneRuntime


def _want_codec(modes, guard: bool) -> dict:
    """B4-B7 of one response on the overlap schedule: per lossy bucket
    one encode and one decode, and one more decode for the residual when
    the guardrail's signal is on (``quantization._dense_scatter_impl``)."""
    want = dict.fromkeys(CODECS, 0)
    for m in modes:
        codec = EAGER_CODEC.get(m, ())
        if codec:
            want[codec[0]] += 1
            want[codec[1]] += 1 + int(guard)
    return want


def autotune_emulated(hvd, torch, gpu: str, device: str = "cuda",
                      model_fn=None, size: int = 224,
                      classes: int = 1000) -> dict:
    """Phase 25b: phase 20b's four emulated runtimes (one
    ``DictTransport``, phase 16's ``EmulatedWorld``) under
    ``HOROVOD_AUTOTUNE``, ``HOROVOD_ADAPTIVE_COMPRESSION`` and
    ``HOROVOD_OVERLAP`` with one-round sample windows, ``TUNE_STEPS``
    steps of each rank's 161 ResNet-50 gradients (its 64-image shard):
    every rank applies the same proposals at the same rounds and
    executes every round under the same knobs; per response the mode of
    each bucket and its B4-B7 launches held to the mode's codec; each
    response's result bit for bit the same bucketed schedule's plain
    versions on the CPU over an emulated world under the knobs it ran
    with (phase 20b's tolerance for every mode it runs); rank 0's
    samples, pinning and the final knobs."""
    import hashlib

    from horovod_tpu_torch.common import config as C
    from horovod_tpu_torch.common.util import true_divide
    from horovod_tpu_torch.ops import overlap as OV
    from horovod_tpu_torch.ops import quantization as Q
    from horovod_tpu_torch.ops.eager import HandleManager
    from horovod_tpu_torch.ops.eager_exec import EagerExecutor
    from horovod_tpu_torch.parallel.emulated import EmulatedWorld
    from horovod_tpu_torch.runtime import metrics as M
    from horovod_tpu_torch.runtime.controller import KVController

    t0 = time.perf_counter()
    n = DP_N
    orders, grads, subs, shifts = _eager_shards(torch, device, model_fn,
                                                size, classes)
    keep = ("HOROVOD_COMPRESSION", "HOROVOD_BUCKET_COMPRESSION",
            "HOROVOD_OVERLAP_CHUNKS", *TUNE_ENV,
            *(C.knobs()[k].env for k in TUNED_KNOBS))
    saved = {k: os.environ.get(k) for k in keep}
    os.environ.update(TUNE_ENV)
    os.environ["HOROVOD_COMPRESSION"] = "none"
    # no step span in this phase: the tuner scores logical bytes per
    # second, not an earlier phase's blocked time
    M.gauge("hvd_step_phase_seconds_last").reset()
    M.gauge("hvd_compression_residual_ratio").reset()
    try:
        world = EmulatedWorld(torch, n, (Q.LAUNCHES,),
                              sync=device == "cuda", free=True)
        transport = DictTransport()
        cls = _tune_runtime_class(world)
        rts = [cls(r, n, KVController(transport, r, n, 25,
                                      timeout=EAGER_TIMEOUT_S),
                   EagerExecutor(world.flat(r), device), HandleManager(),
                   start=False) for r in range(n)]
        if rts[0].pm is None or any(rt.pm is not None for rt in rts[1:]):
            raise AssertionError("25b: the tuner is not rank 0's alone")
        steps = []
        for step in range(TUNE_STEPS):
            for rt in rts:
                rt.log = []
            res = _threads(lambda r: _eager_step(rts[r], subs[r]), n)
            for k in orders[0]:
                for r in range(1, n):
                    if not torch.equal(res[r][k], res[0][k]):
                        raise AssertionError(f"25b step {step + 1}: rank "
                                             f"{r}'s {k} differs")
            seq0 = [(x["round"], x["digest"]) for x in rts[0].log]
            for r, rt in enumerate(rts):
                seq = [(x["round"], x["digest"]) for x in rt.log]
                if seq != seq0:
                    raise AssertionError(
                        f"25b step {step + 1}: rank {r} ran rounds/knobs "
                        f"{seq}, rank 0 {seq0}")
                for x in rt.log:
                    want = _want_codec(x["modes"], x["guard"])
                    if x["launches"] != want:
                        raise AssertionError(
                            f"25b step {step + 1} rank {r}: launches "
                            f"{x['launches']} for bucket modes "
                            f"{x['modes']}, expected {want}")
            steps.append({"out": res[0], "log": [list(rt.log) for rt in rts]})
        tunes = [list(rt.controller.tunes) for rt in rts]
        if not tunes[0] or any(t != tunes[0] for t in tunes):
            raise AssertionError(f"25b: the ranks applied {tunes}")
        pm = rts[0].pm
        final = {k: C.get(k) for k in TUNED_KNOBS}
        objective = pm._objective
        # the reduction reference: per (names, knobs) the same schedule's
        # plain versions on the CPU over an emulated world
        refs, checked = {}, 0
        for s in steps:
            for x in s["log"][0]:
                key = (tuple(x["names"]), x["digest"])
                got = torch.cat([s["out"][k].reshape(-1)
                                 for k in x["names"]]).cpu()
                if key not in refs:
                    for k in ("bucket_compression", "overlap_chunks"):
                        os.environ[C.knobs()[k].env] = str(x["knobs"][k])
                    flats = [torch.cat([grads[r][k].reshape(-1)
                                        for k in x["names"]]).cpu()
                             for r in range(n)]
                    cpu = EmulatedWorld(torch, n, sync=False)
                    sums = cpu.run(lambda r: OV.overlapped_flat_reduce(
                        flats[r], op=2, quantized="none",
                        with_error=x["guard"], block_size=QBLOCK,
                        axis_name=cpu.flat(r))[0])
                    dt = flats[0].dtype
                    refs[key] = true_divide(sums[0].to(dt), n).to(dt)
                    checked += 1
                    del flats, sums
                if not torch.equal(got, refs[key]):
                    raise AssertionError(
                        f"25b: the response {x['names'][:2]}... under "
                        f"bucket modes {x['modes']} differs from the "
                        "plain versions' schedule on the CPU")
        for rt in rts:
            rt.stop()
    finally:
        _restore_env(saved)
        M.gauge("hvd_compression_residual_ratio").reset()
    log0 = [x for s in steps for x in s["log"][0]]
    per_mode = {}
    for x in log0:
        for m in x["modes"]:
            per_mode[m] = per_mode.get(m, 0) + 1
    launches = {k: sum(x["launches"][k] for x in log0) for k in CODECS}
    out = {"samples": pm._samples_seen, "pinned": pm._pinned,
           "objective": objective, "final": final,
           "tunes": [[rnd, t] for rnd, t in tunes[0]],
           "responses": [len(s["log"][0]) for s in steps],
           "bucket_modes": per_mode, "launches": launches,
           "launches_per_step": [
               {k: sum(x["launches"][k] for x in s["log"][0])
                for k in CODECS} for s in steps],
           "configs": sorted({x["digest"] for x in log0}),
           "checked": checked, "seconds": time.perf_counter() - t0}
    digest = hashlib.sha256(json.dumps(out["tunes"], sort_keys=True)
                            .encode()).hexdigest()[:16]
    log(f"[autotune] 25b: 4 emulated ranks, 161 ResNet-50 gradients of a "
        f"{EAGER_SHARD}-image shard each, {TUNE_STEPS} steps under "
        f"HOROVOD_AUTOTUNE, HOROVOD_ADAPTIVE_COMPRESSION and HOROVOD_OVERLAP "
        f"(1-round windows, 0 warm-up, 3 samples): every rank applied the "
        f"same {len(out['tunes'])} proposals at rounds "
        f"{[t[0] for t in out['tunes']]} (digest {digest}) and ran every "
        f"round under the same knobs; rank 0 saw {out['samples']} samples "
        f"({objective}), pinned {out['pinned']}; final knobs {final}; "
        f"responses per step {out['responses']}; bucket modes run "
        f"{per_mode}; B4-B7 launches per step (rank 0) "
        f"{out['launches_per_step']}, each response's equal to its modes' "
        f"codec; {checked} distinct (response, knobs) results bit for bit "
        f"the schedule's plain versions on the CPU; phase 25b took "
        f"{out['seconds']:.1f} s; on {gpu}")
    del grads, steps, refs
    return out


def tuning_plane(hvd, torch, gpu: str) -> dict:
    """Phase 25 (a-b)."""
    t0 = time.perf_counter()
    out = {"a": timeline_world1(hvd, torch, gpu)}
    torch.cuda.empty_cache()
    out["b"] = autotune_emulated(hvd, torch, gpu)
    torch.cuda.empty_cache()
    log(f"[autotune] phase 25 took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 26: the autopilot on phase 6's ResNet-50 step: the rank side's
# rollback at world 1 in process, and the launcher's engine at -np 1
# ---------------------------------------------------------------------------

AP_STEPS, AP_EVERY, AP_POISON = 10, 2, 5   # 26a: steps, commit period,
                                            # the step poisoned once
AP_KEEP = 4                                 # HOROVOD_CHECKPOINT_KEEP


def _ap_run(hvd, torch, model_fn, images, labels, ckdir: str, *,
            autopilot: bool, dry_run: bool = False, poison=None,
            sync=None) -> dict:
    """One 26a run: a fresh model and fused momentum SGD under
    ``ElasticState(checkpoint_dir=ckdir)``, ``HOROVOD_HEALTH=1`` and
    ``HOROVOD_CHECKPOINT_KEEP``, a commit every ``AP_EVERY`` steps until
    step ``AP_STEPS``; step ``poison``'s first run carries
    ``HOROVOD_FAULT_SPEC=nan:grads*`` (the in-trace rule, set for that
    one step).  Every commit's autopilot tick and every rollback are
    timed on the host.  Returns the steps that ran, their losses, the
    kernels' launches over the run, a digest of the parameters, the
    BatchNorm buffers and the momentum traces, the engine's stats, the
    ring's ``autopilot`` events and the commits' verdicts."""
    import hashlib

    from horovod_tpu_torch import checkpoint as ckpt
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.ops import batch_norm as BN
    from horovod_tpu_torch.ops import flash_attention as FA
    from horovod_tpu_torch.ops import quantization as Q
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.runtime import autopilot as AP
    from horovod_tpu_torch.runtime import faults as F
    from horovod_tpu_torch.runtime import flight
    from horovod_tpu_torch.runtime import health as H
    from horovod_tpu_torch.train_step import train_step

    sync = sync or torch.cuda.synchronize
    counters = (TF, FA, Q, BN)
    knobs = dict(HOROVOD_HEALTH=1, HOROVOD_AUTOPILOT=int(autopilot),
                 HOROVOD_AUTOPILOT_DRY_RUN=int(dry_run),
                 HOROVOD_CHECKPOINT_KEEP=AP_KEEP, HOROVOD_FAULT_SPEC=None)
    ticks, rollbacks = [], []
    real_tick = elastic._autopilot_tick
    real_rb = elastic.ElasticState.rollback_to_healthy

    def tick(state):
        n = len(rollbacks)
        t0 = time.perf_counter()
        real_tick(state)
        if len(rollbacks) == n:   # the rollback's tick is timed apart
            ticks.append(time.perf_counter() - t0)

    def rollback(state):
        t0 = time.perf_counter()
        step = real_rb(state)
        sync()
        rollbacks.append({"s": time.perf_counter() - t0, "to_step": step})
        return step

    with _EnvKnobs(**knobs):
        AP.reset()
        H.reset()
        flight.reset()
        model = model_fn()
        opt = hvd.DistributedOptimizer(
            hvd.fused_update.sgd(model.parameters(), 0.1, momentum=0.9))
        state = elastic.ElasticState(params=model, opt_state=opt,
                                     checkpoint_dir=ckdir)
        elastic._autopilot_tick = tick
        elastic.ElasticState.rollback_to_healthy = rollback
        ran, losses, poisoned = [], [], False
        try:
            for m in counters:
                m.reset_launch_counts()
            while state.step < AP_STEPS:
                if len(ran) >= 3 * AP_STEPS:
                    raise AssertionError("[autopilot] 26a: the rollback "
                                         "loop never converged")
                if state.step % AP_EVERY == 0:
                    state.commit()
                hit = state.step == poison and not poisoned
                poisoned = poisoned or hit
                with _EnvKnobs(HOROVOD_FAULT_SPEC="nan:grads*" if hit
                               else None):
                    loss = train_step(model, opt, images, labels)
                sync()
                F._data_cache = ("", [])
                ran.append(state.step)
                losses.append(float(loss))
                state.step += 1
            launches = {k: v for m in counters
                        for k, v in m.LAUNCHES.items()}
        finally:
            elastic._autopilot_tick = real_tick
            elastic.ElasticState.rollback_to_healthy = real_rb
        h = hashlib.sha256()
        for v in model.state_dict().values():
            h.update(v.detach().float().cpu().numpy().tobytes())
        for st in opt.optimizer.state.values():
            for k in sorted(st):
                if torch.is_tensor(st[k]):
                    h.update(st[k].float().cpu().numpy().tobytes())
        finite = all(bool(torch.isfinite(v).all())
                     for v in model.state_dict().values()
                     if v.is_floating_point())
        stats = AP.rank_autopilot().stats()
        events = [{k: e.get(k) for k in ("rule", "act", "target",
                                         "outcome", "evidence")}
                  for e in flight.recorder().snapshot()
                  if e["kind"] == "autopilot"]
        verdicts = {s: ckpt.verdict_of(ckdir, s)
                    for s in ckpt._complete_steps(ckdir)}
        AP.reset()
        H.reset()
    return {"ran": ran, "losses": losses, "launches": launches,
            "digest": h.hexdigest(), "finite": finite, "stats": stats,
            "events": events, "verdicts": verdicts, "ticks": ticks,
            "rollbacks": rollbacks}


def _ap_counts(run: dict, what: str) -> dict:
    """One B1 and RESNET50_BN of each of N1-N4 per step that ran
    (replayed steps included), and no launch of any other kernel."""
    n, got = len(run["ran"]), run["launches"]
    want = {k: 0 for k in got}
    want.update({"momentum": n, **dict.fromkeys(BN_KERNELS,
                                                RESNET50_BN * n)})
    if got != want:
        raise AssertionError(f"[autopilot] {what}: {n} steps launched "
                             f"{got}, want {want}")
    return {"steps": n, **got}


def autopilot_rollback(hvd, torch, gpu: str, work: str, device: str = "cuda",
                       model_fn=None, batch: int = BATCH, size: int = 224,
                       classes: int = 1000) -> dict:
    """26a: phase 6's ResNet-50 step (deterministic cuDNN) at world 1 in
    process, three runs of ``_ap_run``: autopilot off and unpoisoned (the
    reference bits, and the tick's cost with the knob off); autopilot on
    with step ``AP_POISON`` poisoned once: the nonfinite sentinel trips,
    the next commit is stamped ``poisoned``, the tick rolls back to the
    newest healthy commit and the loop replays, and the final parameters,
    BatchNorm buffers and momentum traces equal the reference's bit for
    bit after exactly one applied rollback (one ``applied`` autopilot
    event on the ring, with its evidence); then the same under
    ``HOROVOD_AUTOPILOT_DRY_RUN``: the verdict is ``dry_run`` and nothing
    is restored."""
    import shutil

    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.train_step import synthetic_batch

    if model_fn is None:
        def model_fn():
            return ResNet50(num_classes=classes, dtype=torch.bfloat16,
                            seed=0)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    hvd.init(device=None if device == "cuda" else device)
    try:
        images, labels = synthetic_batch(batch, size, classes, seed=0,
                                         device=device)
        runs = {}
        for name, kw in (("off", dict(autopilot=False)),
                         ("rollback", dict(autopilot=True,
                                           poison=AP_POISON)),
                         ("dry_run", dict(autopilot=True, dry_run=True,
                                          poison=AP_POISON))):
            d = os.path.join(work, name)
            shutil.rmtree(d, ignore_errors=True)
            runs[name] = _ap_run(hvd, torch, model_fn, images, labels, d,
                                 sync=sync, **kw)
            shutil.rmtree(d, ignore_errors=True)
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        hvd.shutdown()
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
    off, rb, dry = runs["off"], runs["rollback"], runs["dry_run"]
    if off["ran"] != list(range(AP_STEPS)) or not off["finite"] \
            or off["stats"]["actions_total"] or off["events"]:
        raise AssertionError(f"[autopilot] 26a: the reference run: {off}")
    back = AP_POISON - AP_POISON % AP_EVERY
    want_ran = list(range(AP_POISON + 1)) + list(range(back, AP_STEPS))
    applied = [e for e in rb["events"] if e["outcome"] == "applied"]
    others = {e["outcome"] for e in rb["events"]} - {"applied"}
    if not (rb["stats"]["rollbacks"] == 1 and len(applied) == 1
            and applied[0]["rule"] == "health_rollback"
            and "nonfinite" in applied[0]["evidence"]["alerts"]
            and others <= {"suppressed:cooldown"}
            and len(rb["rollbacks"]) == 1
            and rb["rollbacks"][0]["to_step"] == back):
        raise AssertionError(f"[autopilot] 26a: want one applied rollback "
                             f"to step {back}: stats {rb['stats']}, events "
                             f"{rb['events']}, rollbacks {rb['rollbacks']}")
    if "poisoned" not in rb["verdicts"].values():
        raise AssertionError(f"[autopilot] 26a: no commit stamped "
                             f"poisoned: {rb['verdicts']}")
    if rb["ran"] != want_ran:
        raise AssertionError(f"[autopilot] 26a: steps ran {rb['ran']}, "
                             f"want {want_ran}")
    if rb["digest"] != off["digest"] or not rb["finite"]:
        raise AssertionError(
            f"[autopilot] 26a: the rolled-back run's parameters, buffers "
            f"and traces (sha256 {rb['digest']}) differ from the "
            f"unpoisoned run's ({off['digest']}); losses {rb['losses']} "
            f"against {off['losses']}")
    replay = rb["losses"][AP_POISON + 1:]
    if replay != off["losses"][back:]:
        raise AssertionError(f"[autopilot] 26a: replayed losses {replay} "
                             f"against {off['losses'][back:]}")
    if not (dry["stats"]["rollbacks"] == 0
            and dry["stats"]["by_outcome"].get("dry_run") == 1
            and not dry["rollbacks"] and dry["ran"] == list(range(AP_STEPS))
            and not dry["finite"]
            and not any(e["outcome"] == "applied" for e in dry["events"])):
        raise AssertionError(f"[autopilot] 26a: the dry run restored "
                             f"something or recorded no dry_run verdict: "
                             f"stats {dry['stats']}, ran {dry['ran']}, "
                             f"finite {dry['finite']}")
    counts = {n: _ap_counts(r, f"26a {n}") for n, r in runs.items()}
    med = {n: statistics.median(r["ticks"]) for n, r in
           (("on", rb), ("off", off))}
    out = {"tick_ms": {k: v * 1e3 for k, v in med.items()},
           "tick_ms_dry_run": statistics.median(dry["ticks"]) * 1e3,
           "rollback_s": rb["rollbacks"][0]["s"],
           "rolled_back_to": back, "ran": rb["ran"],
           "evidence": applied[0]["evidence"],
           "outcomes": rb["stats"]["by_outcome"],
           "outcomes_dry_run": dry["stats"]["by_outcome"],
           "verdicts": rb["verdicts"], "launches": counts}
    log(f"[autopilot] 26a: step {AP_POISON} poisoned once; one rollback "
        f"applied ({rb['stats']['by_outcome']}), evidence "
        f"{applied[0]['evidence']}, to the commit of step {back} in "
        f"{out['rollback_s']:.3f} s; steps ran {rb['ran']}; parameters, "
        f"BatchNorm buffers and traces bit for bit with the unpoisoned "
        f"run; commit verdicts {rb['verdicts']}; the dry run recorded "
        f"{dry['stats']['by_outcome']} and restored nothing")
    log(f"[autopilot] 26a: the tick's host time per commit, median "
        f"{med['on'] * 1e3:.4f} ms with the autopilot on ({len(rb['ticks'])}"
        f" ticks, the rollback's apart) against {med['off'] * 1e3:.4f} ms "
        f"off ({len(off['ticks'])}); launches per run {counts}; on {gpu}")
    return out


def autopilot_launcher(gpu: str, work: str, drain_24c: float) -> dict:
    """26b: ``python -m horovod_tpu_torch.run -np 1 --elastic --autopilot
    --checkpoint-dir D`` over phase 24's worker in ``apdrain`` mode: the
    engaged line once; the rank's ``--preempt 0`` request becomes the
    ungated ``preempt_drain`` verdict, applied; the rank drains with one
    emergency commit and exits 0, the launcher returns 0; the launcher's
    flight dump holds the verdict with its rank, uid and source."""
    import shutil

    d = os.path.join(work, "apdrain")
    fl = os.path.join(work, "apdrain_flight")
    for x in (d, fl):
        shutil.rmtree(x, ignore_errors=True)
    rc, recs, err = _p24_launch(
        ["-np", "1", "--elastic", "--autopilot", "--checkpoint-dir", d],
        "apdrain", d, HOROVOD_FLIGHT_DIR=fl)
    if rc != 0 or len(recs) != 1:
        raise AssertionError(f"[autopilot] 26b: launch rc {rc}, "
                             f"{len(recs)} records:\n{err[-4000:]}")
    for line, n in (("[hvdrun autopilot] engaged: rules", 1),
                    ("graceful drain ordered for rank 0 (uid rank0)", 1),
                    ("exited after graceful preemption drain (rc=0)", 1),
                    ("[hvdrun autopilot] 1 verdict(s): {'applied': 1}", 1)):
        if err.count(line) != n:
            raise AssertionError(f"[autopilot] 26b: {line!r} "
                                 f"{err.count(line)} times, want {n}:\n"
                                 f"{err[-4000:]}")
    acts = []
    for name in sorted(os.listdir(fl)):
        if not (name.startswith("flight-") and name.endswith(".jsonl")):
            continue
        with open(os.path.join(fl, name)) as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
        if lines and "initialized" not in lines[0]["meta"]:
            acts += [e for e in lines if e.get("kind") == "autopilot"]
    if len(acts) != 1 or acts[0]["rule"] != "preempt_drain" \
            or acts[0]["outcome"] != "applied" \
            or {k: acts[0]["evidence"].get(k)
                for k in ("rank", "uid", "source")} != {
                    "rank": 0, "uid": "rank0", "source": "cli"}:
        raise AssertionError(f"[autopilot] 26b: the launcher's dump "
                             f"holds {acts}")
    dr = recs[0]
    if dr.get("preempt_rc") != 0:
        raise AssertionError(f"[autopilot] 26b: --preempt 0 returned "
                             f"{dr.get('preempt_rc')}")
    drain_s = dr["t_exit"] - dr["t_notice"]
    out = {"drain_s": drain_s, "after_cli_s": dr["t_exit"] - dr["t_sent"],
           "metric_s": dr["drain_metric_s"],
           "commit_s": dr["commit_s"], "commit_step": dr["drain_commit_step"],
           "evidence": acts[0]["evidence"],
           "launches": _p24_counts(dr, "26b apdrain")}
    shutil.rmtree(work, ignore_errors=True)
    log(f"[autopilot] 26b: --preempt 0 after step {P24_NOTICE} went through"
        f" preempt_drain (applied, evidence {acts[0]['evidence']}); drained "
        f"at the commit of step {dr['drain_commit_step']}; request to exit "
        f"{drain_s:.3f} s ({out['after_cli_s']:.3f} s after the --preempt "
        f"command returned) against 24c's SIGTERM to exit {drain_24c:.3f} s, "
        f"hvd_preempt_drain_seconds {dr['drain_metric_s']:.3f} s, emergency"
        f" commit {dr['commit_s']:.3f} s; on {gpu}")
    return out


def autopilot_plane(hvd, torch, gpu: str, work: str,
                    drain_24c: float) -> dict:
    """Phase 26 (a-b)."""
    t0 = time.perf_counter()
    out = {"a": autopilot_rollback(hvd, torch, gpu, work)}
    torch.cuda.empty_cache()
    out["b"] = autopilot_launcher(gpu, work, drain_24c)
    log(f"[autopilot] phase 26 took {time.perf_counter() - t0:.1f} s")
    return out


def _timed(name: str, gpu: str, fn, *args, **kw):
    """``fn(*args, **kw)`` with its wall time logged on a line of its own
    beside the card's name and power limit."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    dt = time.perf_counter() - t0
    log(f"[simfleet] {name}: {dt:.3f} s wall on {gpu}")
    return out, dt


def fleet_simulator(gpu: str) -> dict:
    """Phase 27: the port's fleet simulator (host only, no kernel) at the
    JAX package's documented scale (``ci.sh``'s simfleet stages and the
    CLI's defaults), every ``HOROVOD_*`` knob of the earlier phases
    cleared for its run: 256-rank negotiation traces and 8-death re-form
    storms replayed twice, identical, the roster dense; the coordinated
    abort reaching all 31 survivors; the root-message ratio at 1024 ranks
    at least 8; the local-SGD round economy at least H; the straggler and
    preemption drills at 256 ranks (replayed, no death, the straggler's
    host shed, every notice drained); the SLO-burn loop; the rollback
    drill with its parameters on the card: one rollback, bit-exact with
    its unpoisoned reference, and the same ``final_digest`` as the drill
    on the CPU; its dry run not bit-exact."""
    from horovod_tpu_torch.runtime import simfleet as SF

    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith("HOROVOD_")}
    t_phase = time.perf_counter()
    wall = {}
    try:
        (a, wall["trace"]) = _timed("run_trace(256, 16, 3)", gpu,
                                    SF.run_trace, 256, 16, 3, 0)
        b, _ = _timed("run_trace(256, 16, 3) replay", gpu,
                      SF.run_trace, 256, 16, 3, 0)
        if a != b or len(a) != 3:
            raise AssertionError(f"[simfleet] 256-rank trace drift: {a} "
                                 f"against {b}")
        s1, wall["storm"] = _timed("reform_storm(256, 16, 8)", gpu,
                                   SF.reform_storm, 256, 16, 8)
        s2, _ = _timed("reform_storm(256, 16, 8) replay", gpu,
                       SF.reform_storm, 256, 16, 8)
        if s1 != s2 or s1["new_world"] != 248 or len(s1["victims"]) != 8:
            raise AssertionError(f"[simfleet] storm: {s1} against {s2}")
        ab, wall["abort"] = _timed("coordinated_abort(32, 8, 5)", gpu,
                                   SF.coordinated_abort, 32, 8, 5)
        if ab["died"] != [5] or not (ab["survivors_aborted"]
                                     == ab["survivors_total"] == 31):
            raise AssertionError(f"[simfleet] abort: {ab}")
        sc, wall["scaling"] = _timed("measure_scaling(1024, 32, 3)", gpu,
                                     SF.measure_scaling, 1024, 32, 3)
        if not sc["ratio"] >= 8.0:
            raise AssertionError(f"[simfleet] scaling ratio below 8: {sc}")
        ls, wall["localsgd"] = _timed(
            "local_sgd_scaling(256, 16, 4, 2)", gpu,
            SF.local_sgd_scaling, 256, 16, 4, 2)
        if not ls["cross_round_ratio"] >= 4.0:
            raise AssertionError(f"[simfleet] local SGD: {ls}")
        st, wall["straggler"] = _timed("straggler_drill(256, 16)", gpu,
                                       SF.straggler_drill, 256, 16)
        st2, _ = _timed("straggler_drill(256, 16) replay", gpu,
                        SF.straggler_drill, 256, 16)
        if st != st2 or st["deaths"] != [] or st["world_after"] != 255 \
                or st["blacklisted"] != ["host-0003"]:
            raise AssertionError(f"[simfleet] straggler: {st}")
        dry, _ = _timed("straggler_drill(256, 16, dry_run)", gpu,
                        SF.straggler_drill, 256, 16, dry_run=True)
        if dry["blacklisted"] or dry["world_after"] != 256 or not any(
                x["outcome"] == "dry_run" for x in dry["actions"]):
            raise AssertionError(f"[simfleet] straggler dry run: {dry}")
        pe, wall["preempt"] = _timed("preempt_storm(256, 16)", gpu,
                                     SF.preempt_storm, 256, 16)
        pe2, _ = _timed("preempt_storm(256, 16) replay", gpu,
                        SF.preempt_storm, 256, 16)
        if pe != pe2 or pe["deaths"] or pe["blacklisted"] \
                or pe["drained"] != pe["victims"] \
                or pe["world_after"] != 256 - len(pe["victims"]) \
                or not all(x["outcome"] == "applied"
                           for x in pe["actions"]):
            raise AssertionError(f"[simfleet] preemption storm: {pe}")
        burn, wall["burn"] = _timed("slo_burn_drill()", gpu,
                                    SF.slo_burn_drill)
        if burn != SF.slo_burn_drill() \
                or burn["events"][0] != ["shrink", burn["victim"]] \
                or ["grow", None] not in burn["events"] \
                or burn["shed"] != [burn["victim"]]:
            raise AssertionError(f"[simfleet] SLO burn: {burn}")
        rb, wall["rollback"] = _timed("rollback_drill(device=cuda)", gpu,
                                      SF.rollback_drill, device="cuda")
        rb_cpu, wall["rollback_cpu"] = _timed(
            "rollback_drill(device=cpu)", gpu, SF.rollback_drill,
            device="cpu")
        if rb["rollbacks"] != 1 or not rb["bit_exact"] \
                or not rb["final_finite"] \
                or rb["final_digest"] != rb_cpu["final_digest"]:
            raise AssertionError(f"[simfleet] rollback on the card: {rb}; "
                                 f"on the CPU: {rb_cpu}")
        rb_dry, _ = _timed("rollback_drill(device=cuda, dry_run)", gpu,
                           SF.rollback_drill, dry_run=True, device="cuda")
        if rb_dry["bit_exact"] or rb_dry["actions"][0]["outcome"] \
                != "dry_run":
            raise AssertionError(f"[simfleet] rollback dry run: {rb_dry}")
    finally:
        _restore_env(saved)
    out = {"wall_s": wall,
           "trace_root_ops": a[-1]["root_ops"],
           "storm_roster_digest": s1["roster_digest"],
           "abort": ab,
           "scaling": {k: sc[k] for k in ("flat_root_ops_per_round",
                                          "hier_root_ops_per_round",
                                          "ratio")},
           "localsgd_ratio": ls["cross_round_ratio"],
           "straggler_blacklisted": st["blacklisted"],
           "preempt_drained": pe["drained"],
           "burn_shed": burn["shed"],
           "rollback_digest": rb["final_digest"],
           # the monitor's loss is params @ params, a reduction the card
           # orders its own way: whether the rest of the drill's record
           # matched the CPU's too
           "rollback_same_record_as_cpu": rb == rb_cpu}
    log(f"[simfleet] phase 27: 256-rank trace {a[-1]['root_ops']} root "
        f"ops/round; storm roster {s1['roster_digest']}; abort "
        f"{ab['survivors_aborted']}/{ab['survivors_total']} survivors; "
        f"world 1024 root ops/round flat {sc['flat_root_ops_per_round']} "
        f"against hier {sc['hier_root_ops_per_round']}, ratio "
        f"{sc['ratio']}; straggler shed {st['blacklisted']}; drained "
        f"{pe['drained']}; burn shed {burn['shed']}; rollback digest "
        f"{rb['final_digest']} on the card and the CPU (whole record "
        f"equal: {out['rollback_same_record_as_cpu']})")
    log(f"[simfleet] phase 27 took {time.perf_counter() - t_phase:.1f} s "
        f"on {gpu}")
    return out


# ---------------------------------------------------------------------------
# Phase 28: the perf observatory (sampled torch.profiler captures) on phase
# 6's ResNet-50 step
# ---------------------------------------------------------------------------

PROF_EVERY, PROF_KEEP, PROF_STEPS = 2, 2, 8  # 28a: knob, rotation, steps
PROF_ROUNDS, PROF_ROUND_STEPS = 2, 6         # 28b: off/on rounds, steps
#: each counted kernel's name as a capture shows it (demangled), by the
#: wrapper counter that counts its launches: B1's multi-leaf kernel, and
#: N1-N4 (N1 and N3 launch their row-tile pass and one finalize each)
PROF_KERNELS = {"momentum": r"(^|[\s:])multi_kernel<",
                "bn_stats": r"(^|[\s:])finalize<false>",
                "bn_normalize": r"(^|[\s:])normalize<",
                "bn_bwd_reduce": r"(^|[\s:])finalize<true>",
                "bn_bwd_dx": r"(^|[\s:])bwd_dx<"}
PROF_ENV = ("HOROVOD_PROFILE_EVERY_N_STEPS", "HOROVOD_PROFILE_DIR",
            "HOROVOD_PROFILE_KEEP", "HOROVOD_FUSED_UPDATE")


def _capture_kernels(K, path: str) -> tuple:
    """``({counter: kernels found}, {category: events}, device kernels,
    the most frequent kernel names)`` of one Chrome trace."""
    import collections
    import re

    with open(path) as f:
        raw = json.load(f)["traceEvents"]
    cats = collections.Counter(str(e.get("cat", e.get("ph"))) for e in raw)
    names = collections.Counter(
        e.name for p in K.read_trace(path).planes
        if p.name.startswith("/device:") for e in K.device_work(p))
    found = {k: sum(n for name, n in names.items() if re.search(pat, name))
             for k, pat in PROF_KERNELS.items()}
    return found, dict(cats), sum(names.values()), names.most_common(8)


def perf_observatory(hvd, torch, gpu: str) -> dict:
    """Phase 28 (a-b)."""
    import tempfile

    from torch.utils.flop_counter import FlopCounterMode

    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import batch_norm as BN
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.perf import capture as C
    from horovod_tpu_torch.perf import goodput as GP
    from horovod_tpu_torch.perf import kineto as K
    from horovod_tpu_torch.runtime import metrics as M
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    t_phase = time.perf_counter()
    saved = {k: os.environ.get(k) for k in PROF_ENV}
    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    hvd.init()
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0)
    opt = hvd.DistributedOptimizer(
        hvd.fused_update.sgd(model.parameters(), 0.1, momentum=0.9))
    images, labels = synthetic_batch(BATCH, 224, 1000, seed=0)
    for _ in range(2):
        train_step(model, opt, images, labels)
    with FlopCounterMode(display=False) as fc:
        train_step(model, opt, images, labels)
    flops = fc.get_total_flops()
    torch.cuda.synchronize()
    root = tempfile.mkdtemp(prefix="hvd_prof_")
    sampled: list = []
    start = C.maybe_start

    def spy(step):
        token = start(step)
        sampled.append(token is not None)
        return token

    C.maybe_start = spy
    try:
        os.environ.update({"HOROVOD_PROFILE_EVERY_N_STEPS": str(PROF_EVERY),
                           "HOROVOD_PROFILE_DIR": root,
                           "HOROVOD_PROFILE_KEEP": str(PROF_KEEP)})
        C.reset()
        C.set_step_flops(flops)
        captures0 = M.counter("hvd_profile_captures_total").total()
        device0 = GP.ledger().snapshot()["exposed_source"].get("device", 0)
        ev_ms, launches, losses = [], [], []
        for step in range(PROF_STEPS):
            TF.reset_launch_counts()
            BN.reset_launch_counts()
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            with hvd.trace_step(step=step):
                e0.record()
                loss = train_step(model, opt, images, labels)
                e1.record()
            e1.synchronize()
            ev_ms.append(e0.elapsed_time(e1))
            losses.append(float(loss))
            c = {**TF.LAUNCHES, **BN.LAUNCHES}
            launches.append({k: c[k] for k in PROF_KERNELS})
            C.drain(120)
        captures = M.counter("hvd_profile_captures_total").total() - captures0
        device = (GP.ledger().snapshot()["exposed_source"].get("device", 0)
                  - device0)
        rank_dir = os.path.join(root, "rank0")
        kept = sorted(os.listdir(rank_dir))
        if captures < 2 or len(kept) != PROF_KEEP:
            raise AssertionError(f"28a: {captures} captures analyzed, kept "
                                 f"{kept} (HOROVOD_PROFILE_KEEP={PROF_KEEP})")
        ratios, cats = {}, {}
        for d in kept:
            with open(os.path.join(rank_dir, d, "analysis.json")) as f:
                an = json.load(f)
            step = an["captured_step"]
            tot = an["totals"]
            if not any(p.startswith("/device:GPU") for p in an["planes"]):
                raise AssertionError(f"28a: step {step}'s capture holds no "
                                     f"device plane: {an['planes']}")
            ratios[step] = round(tot["compute_s_per_step"] * 1e3
                                 / ev_ms[step], 4)
            if not 0.5 <= ratios[step] <= 1.05:
                raise AssertionError(
                    f"28a: step {step}: device compute "
                    f"{tot['compute_s_per_step']} s against "
                    f"{ev_ms[step]:.3f} ms between its CUDA events")
            if tot["comm_s"] != 0 or any(s["comm_by_kind"]
                                         for s in an["steps"]):
                raise AssertionError(f"28a: comm at world 1: {tot} "
                                     f"{[s['comm_by_kind'] for s in an['steps']]}")
            found, cats, n_dev, top = _capture_kernels(K, an["trace_path"])
            want = {k: launches[step][k] for k in PROF_KERNELS}
            if found != want or want["momentum"] != 1 or any(
                    want[k] != RESNET50_BN for k in BN_KERNELS):
                raise AssertionError(
                    f"28a: step {step}: kernels in the capture {found}, "
                    f"the wrappers counted {want}; most frequent {top}")
            log(f"[perf] 28a step {step}: {n_dev} device events, "
                f"{an['op_events']} op events, wall "
                f"{tot['wall_s_per_step']} s, compute "
                f"{tot['compute_s_per_step']} s, CUDA events "
                f"{ev_ms[step]:.3f} ms, ratio {ratios[step]}, mfu "
                f"{tot.get('mfu')}; kernels {found}; most frequent {top}")
        snap = M.registry().snapshot()

        def gauge(name):
            return snap[name]["series"][0]["value"]

        last = C.last_analysis()["totals"]
        mfu = gauge("hvd_mfu")
        if gauge("hvd_device_compute_seconds") !=                 last["compute_s_per_step"] or                 gauge("hvd_device_comm_exposed_seconds") != 0 or                 not 0 < mfu <= 1 or device < 1:
            raise AssertionError(
                f"28a: gauges compute {gauge('hvd_device_compute_seconds')}"
                f" (last {last['compute_s_per_step']}), exposed "
                f"{gauge('hvd_device_comm_exposed_seconds')}, mfu {mfu}; "
                f"{device} steps booked from the device")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"28a: non-finite loss: {losses}")
        log(f"[perf] 28a ResNet-50 batch {BATCH} bf16, world 1 over NCCL, "
            f"{PROF_STEPS} steps at HOROVOD_PROFILE_EVERY_N_STEPS="
            f"{PROF_EVERY}: {captures:g} captures, kept {kept}; "
            f"FlopCounterMode {flops:.4g} FLOP per step; mfu {mfu}; "
            f"compute/CUDA-event ratios {ratios}; {device} steps booked "
            f"comm_exposed from the device; event categories of the last "
            f"capture {cats}; CUDA-event ms {[round(x, 3) for x in ev_ms]}; "
            f"on {gpu}")
        # 28b: the un-sampled steps against the knob off, in alternation
        times = {"off": [], "on": [], "sampled": []}
        off_rounds = []
        for _ in range(PROF_ROUNDS):
            for mode in ("off", "on"):
                if mode == "off":
                    os.environ.pop("HOROVOD_PROFILE_EVERY_N_STEPS")
                else:
                    os.environ["HOROVOD_PROFILE_EVERY_N_STEPS"] = \
                        str(PROF_EVERY)
                rnd = []
                for _ in range(PROF_ROUND_STEPS):
                    del sampled[:]
                    t0 = time.perf_counter()
                    with hvd.trace_step():
                        train_step(model, opt, images, labels)
                        torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    if mode == "off":
                        rnd.append(dt)
                    else:
                        times["sampled" if any(sampled) else "on"].append(dt)
                times["off"] += rnd
                if mode == "off":
                    off_rounds.append(statistics.median(rnd))
                C.drain(120)
        med = {k: statistics.median(v) for k, v in times.items() if v}
        ratio = med["on"] / med["off"]
        noise = max(off_rounds) / min(off_rounds)
        log(f"[perf] 28b {PROF_ROUNDS} rounds of {PROF_ROUND_STEPS} steps "
            f"knob off then {PROF_ROUND_STEPS} at {PROF_EVERY}: median step "
            f"off {med['off']:.4f} s, un-sampled {med['on']:.4f} s (ratio "
            f"{ratio:.4f}; the two off rounds' medians differ by "
            f"{noise:.4f}x), sampled {med.get('sampled', float('nan')):.4f}"
            f" s over {len(times['sampled'])} steps; on {gpu}")
    finally:
        C.maybe_start = start
        C.reset()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    del model, opt, images, labels
    hvd.shutdown()
    torch.cuda.empty_cache()
    log(f"[perf] phase 28 took {time.perf_counter() - t_phase:.1f} s")
    return {"captures": captures, "compute_ratios": ratios, "mfu": mfu,
            "launches": launches, "ratio": ratio, "noise": noise,
            "median_s": med, "flops": flops}


# ---------------------------------------------------------------------------
# Phase 29: the invariant lint suite on the card
# ---------------------------------------------------------------------------

AN_ROUNDS, AN_ROUND_STEPS = 3, 8   # 29d: rounds, steps per mode and round
HOOK_CALLS, HOOK_REPS = 200_000, 7  # 29d (i): calls per timing, timings


def _hook_costs(torch) -> dict:
    """29d (i): the host time of one closed event hook against the work
    the parent did in its place (a ``LAUNCHES`` bump inline; the
    ``note_sent`` call with its thread-local read), in ns per event,
    each the median of :data:`HOOK_REPS` timings of :data:`HOOK_CALLS`
    events, the two alternating."""
    import collections
    import threading

    from horovod_tpu_torch.common import events

    sent_tls = threading.local()

    def note_sent(t):
        box = getattr(sent_tls, "box", None)
        if box is not None and t is not None:
            box[0] += t.numel() * t.element_size()

    class TwoRanks:
        ranks = (0, 1)

    hop, t, counts = TwoRanks(), torch.ones(4), collections.Counter()
    calls = range(HOOK_CALLS)

    def parent_launch():
        for _ in calls:
            counts["momentum"] += 1

    def hook_launch():
        for _ in calls:
            events.note_launch(counts, "fused_update", "momentum")

    def parent_transfer():
        for _ in calls:
            note_sent(t)

    def hook_transfer():
        for _ in calls:
            events.note_transfer(hop, "all-reduce", t)

    out = {}
    for kind, parent, hook in (("launch", parent_launch, hook_launch),
                               ("transfer", parent_transfer, hook_transfer)):
        ns = {"parent_ns": [], "hook_ns": []}
        for _ in range(HOOK_REPS):
            for key, fn in (("parent_ns", parent), ("hook_ns", hook)):
                t0 = time.perf_counter_ns()
                fn()
                ns[key].append((time.perf_counter_ns() - t0) / HOOK_CALLS)
        out[kind] = {k: statistics.median(v) for k, v in ns.items()}
        out[kind]["added_ns"] = out[kind]["hook_ns"] - out[kind]["parent_ns"]
    return out


def _analysis_cli(gpu: str) -> dict:
    """29a: the CLI's ``all --json`` in a subprocess."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.analysis", "all",
         "--json"], capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"29a: the lint CLI exited {proc.returncode}:"
                             f"\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    doc = json.loads(proc.stdout)
    log(f"[analysis] 29a `python -m horovod_tpu_torch.analysis all --json`:"
        f" exit 0 in {wall:.1f} s; passes {doc['passes']}, summary "
        f"{doc['summary']}, allowlisted "
        f"{sorted({f['rule'] for f in doc['findings']})}, skipped "
        f"{[x['rule'] for x in doc['skipped']]}; on {gpu}")
    return {"summary": doc["summary"], "wall_s": wall}


def _analysis_programs(torch, gpu: str) -> dict:
    """29b: the program set over 8 emulated ranks on the card."""
    import collections

    from horovod_tpu_torch.analysis import programs as P
    from horovod_tpu_torch.analysis import schedule_lint as SL
    from horovod_tpu_torch.ops import quantization as Q

    Q.reset_launch_counts()
    progs = {}
    t0 = time.perf_counter()
    found = P.run(programs=progs)
    wall = time.perf_counter() - t0
    if found:
        raise AssertionError("29b: the program set on the card has "
                             "findings:\n" + "\n".join(f.render()
                                                       for f in found))
    recs = {label: collections.Counter(
        r.opcode for prog in ps for r in prog.kernels("hvd.quantization."))
        for label, ps in progs.items()}
    for kind in ("quantize", "dequantize"):
        n = sum(c[f"hvd.quantization.{kind}"] for c in recs.values())
        if n != Q.LAUNCHES[kind]:
            raise AssertionError(f"29b: {kind} recorded {n} times, counted "
                                 f"{Q.LAUNCHES[kind]}")
    for label, c in recs.items():
        if (label in ("hier-int8", "flat-lossy")) != bool(c):
            raise AssertionError(f"29b: {label}: codec kernel records {c}")
    for r, prog in enumerate(progs["hier-int8"]):
        c = collections.Counter(r_.opcode for r_ in prog.kernels())
        if not (c["hvd.quantization.quantize"]
                and c["hvd.quantization.dequantize"]):
            raise AssertionError(f"29b: hier-int8 rank {r}: B4/B5 records "
                                 f"{dict(c)}")
        kinds = {SL._axis_kind(x, 4) for x in prog.collectives()
                 if x.shapes and x.shapes[0].dtype == "s8"}
        if kinds != {"cross"}:
            raise AssertionError(f"29b: hier-int8 rank {r}: int8 transfers "
                                 f"on {kinds}")
    tally = {label: collections.Counter(
        (x.opcode, SL._axis_kind(x, 4), x.shapes[0].dtype)
        for x in ps[0].collectives()) for label, ps in progs.items()}
    log(f"[analysis] 29b the program set over 8 emulated ranks on the card "
        f"in {wall:.1f} s: no finding (every preset clean, every control "
        f"flagged); B4/B5 launches {dict(Q.LAUNCHES)} equal to their "
        f"records, per program {({k: dict(v) for k, v in recs.items()})}; "
        f"rank 0's transfers (opcode, axis, dtype) "
        f"{({k: {' '.join(map(str, t)): n for t, n in v.items()} for k, v in tally.items()})}; "
        f"on {gpu}")
    return {"launches": dict(Q.LAUNCHES), "wall_s": wall}


def analysis_phase(hvd, torch, gpu: str) -> dict:
    """Phase 29 (a-d)."""
    import collections

    import torch.distributed as dist

    from horovod_tpu_torch.analysis import schedule_lint as SL
    from horovod_tpu_torch.common import events as _events
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import batch_norm as BN
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cli = _analysis_cli(gpu)
    progs = _analysis_programs(torch, gpu)

    # 29c: phase 6's step at world 1 under the recorder
    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    hvd.init()
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0)
    opt = hvd.DistributedOptimizer(
        hvd.fused_update.sgd(model.parameters(), 0.1, momentum=0.9))
    images, labels = synthetic_batch(BATCH, 224, 1000, seed=0)
    for _ in range(2):
        train_step(model, opt, images, labels)
    torch.cuda.synchronize()
    TF.reset_launch_counts()
    BN.reset_launch_counts()
    with SL.record(1, "resnet50-step") as prog:
        loss = train_step(model, opt, images, labels)
        torch.cuda.synchronize()
    counts = {**TF.LAUNCHES, **BN.LAUNCHES}
    b1 = -(-161 // TF.capacity("momentum"))
    found = SL.check_program(prog, [SL.single_fused_kernel(
        b1, label="resnet50-step")])
    if found or not math.isfinite(float(loss)):
        raise AssertionError("29c: " + "\n".join(f.render() for f in found)
                             + f" (loss {float(loss)})")
    kern = collections.Counter(r.opcode for r in prog.kernels())
    want = {"hvd.fused_update.momentum": counts["momentum"],
            **{f"hvd.batch_norm.{n}": counts[n] for n in BN_KERNELS}}
    if dict(kern) != want or counts["momentum"] != b1 \
            or any(counts[n] != RESNET50_BN for n in BN_KERNELS):
        raise AssertionError(f"29c: kernel records {dict(kern)}, counters "
                             f"{counts}")
    # the positive control: the tail leaf by leaf, one buffer per leaf
    leaves = [p.detach() for p in model.parameters()]
    traces = [torch.zeros_like(p) for p in leaves]
    with SL.record(1, "leaf-by-leaf") as ctl:
        for g, t in zip(leaves, traces):
            TF.momentum_update(g, t, 1, 0.9, -0.1)
    flagged = SL.check_program(ctl, [SL.single_fused_kernel(
        b1, label="leaf-by-leaf-control")])
    n_leaf = len(ctl.kernels("hvd.fused_update."))
    if [f.rule for f in flagged] != ["SCHED-FUSED-TAIL"] \
            or n_leaf != len(leaves):
        raise AssertionError(f"29c: the leaf-by-leaf control: {flagged}, "
                             f"{n_leaf} launches of {len(leaves)} leaves")
    x = torch.ones(1024, device="cuda")
    out = torch.empty(1024 // dist.get_world_size(), device="cuda")
    gat = torch.empty(1024, device="cuda")
    with SL.record(1, "world1-nccl") as wprog:
        dist.all_reduce(x)
        dist.reduce_scatter_tensor(out, x)
        dist.all_gather_into_tensor(gat, out)
    torch.cuda.synchronize()
    c10d = [(r.opcode, r.ranks) for r in wprog.records if r.via == "c10d"]
    if [o for o, _ in c10d] != ["all-reduce", "reduce-scatter",
                                "all-gather"] \
            or any(rk != (0,) for _, rk in c10d):
        raise AssertionError(f"29c: the world-1 NCCL ops recorded as {c10d}")
    aten = collections.Counter(r.opcode for r in prog.records
                               if r.via == "aten")
    log(f"[analysis] 29c ResNet-50 batch {BATCH} bf16 at world 1, one step "
        f"under the recorder: {len(prog.records)} records, "
        f"single_fused_kernel({b1}) holds; kernel records {dict(kern)} "
        f"equal to the counters; the leaf-by-leaf control "
        f"({n_leaf} launches) flagged {[f.rule for f in flagged]}; "
        f"{sum(aten.values())} aten ops of {len(aten)} kinds, the most "
        f"frequent {aten.most_common(12)}; c10d ops of the step "
        f"{sorted({r.opcode for r in prog.records if r.via == 'c10d'})}; "
        f"a world-1 NCCL all-reduce, reduce-scatter and all-gather "
        f"recorded as {c10d}, packets "
        f"{sorted({r.name.rsplit('.', 1)[0] for r in wprog.records})}; "
        f"on {gpu}")

    # 29d: what the closed hooks add to the step.  The parent bumped
    # LAUNCHES inline and called note_sent per transfer; the hooks are
    # one call each in their place, so (i) times each event's hook
    # against the parent's own work, and (ii) alternates steps with the
    # hooks as shipped against steps with each hook doing only the
    # parent's work (a call each, the closed branch gone).
    n_launch = len(prog.kernels())
    n_transfer = len([r for r in prog.records if r.via == "hop"])
    micro = _hook_costs(torch)
    added_s = (n_launch * micro["launch"]["added_ns"]
               + n_transfer * micro["transfer"]["added_ns"]) * 1e-9
    shipped = (_events.note_launch, _events.note_transfer)

    def parent_launch(counts, module, kind, n=1):
        counts[kind] += n

    def parent_transfer(hop, opcode, sent, out=None, pairs=None):
        box = getattr(_events._sent, "box", None)
        if box is not None and sent is not None:
            box[0] += sent.numel() * sent.element_size()

    times = {"parent-work": [], "closed": []}
    base_rounds = []
    try:
        for _ in range(AN_ROUNDS):
            for mode in ("parent-work", "closed"):
                _events.note_launch, _events.note_transfer = \
                    (parent_launch, parent_transfer) \
                    if mode == "parent-work" else shipped
                rnd = []
                for _ in range(AN_ROUND_STEPS):
                    t0 = time.perf_counter()
                    train_step(model, opt, images, labels)
                    torch.cuda.synchronize()
                    rnd.append(time.perf_counter() - t0)
                times[mode] += rnd
                if mode == "parent-work":
                    base_rounds.append(statistics.median(rnd))
    finally:
        _events.note_launch, _events.note_transfer = shipped
    med = {k: statistics.median(v) for k, v in times.items()}
    ratio = med["closed"] / med["parent-work"]
    noise = max(base_rounds) / min(base_rounds)
    share = added_s / med["closed"]
    log(f"[analysis] 29d (i) per event, closed hook against the parent's "
        f"inline work ({HOOK_CALLS} calls, median of {HOOK_REPS}): launch "
        f"{micro['launch']['hook_ns']:.1f} ns against "
        f"{micro['launch']['parent_ns']:.1f} ns, transfer "
        f"{micro['transfer']['hook_ns']:.1f} ns against "
        f"{micro['transfer']['parent_ns']:.1f} ns; the step's "
        f"{n_launch} launches and {n_transfer} hop transfers add "
        f"{added_s * 1e6:.2f} us per step, {share:.3e} of the median step "
        f"{med['closed']:.4f} s; (ii) {AN_ROUNDS} rounds of "
        f"{AN_ROUND_STEPS} steps with each hook doing only the parent's "
        f"work, then {AN_ROUND_STEPS} as shipped: median step "
        f"{med['parent-work']:.4f} s against {med['closed']:.4f} s (ratio "
        f"{ratio:.4f}; the parent-work rounds' medians differ by "
        f"{noise:.4f}x); on {gpu}")
    del model, opt, images, labels, leaves, traces, prog, ctl
    hvd.shutdown()
    torch.cuda.empty_cache()
    log(f"[analysis] phase 29 took {time.perf_counter() - t_phase:.1f} s")
    return {"cli": cli, "programs": progs, "counts": counts,
            "ratio": ratio, "noise": noise, "median_s": med,
            "hook_ns": micro, "added_s": added_s, "share": share}


def run(args) -> int:
    t_start = time.perf_counter()
    card = pin_one_card()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to test",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        raise AssertionError(
            f"expected one visible card, see {torch.cuda.device_count()}")
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import _build
        from horovod_tpu_torch.models.resnet import ResNet50
        from horovod_tpu_torch.ops import batch_norm as BN
        from horovod_tpu_torch.ops import flash_attention as FA
        from horovod_tpu_torch.ops import quantization as Q
        from horovod_tpu_torch.optim import fused_update as TF
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc}); run "
              "from the repository root", file=sys.stderr)
        return 2

    gpu = nvidia_smi_line(card)
    log(f"[gpu] {gpu}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    sources = ("fused_update", "flash_attention", "quantization",
               "batch_norm")
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.load, sources))
    for name in sources:
        info = _build.build_info[name]
        log(f"[build] {name}.cu: nvcc {info['seconds']:.1f} s\n"
            f"{info['log'].strip()}")
    log(f"[build] all {len(sources)} loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    shapes = {"momentum": [tuple(p.shape) for p in
                           ResNet50(device="cpu").parameters()],
              "adam": lm_shapes(LM_SEQ)}
    shapes["sgd"] = shapes["momentum"]
    # B3 at the leaf shapes of both transformer paths (the long-context
    # path adds the (8192, 768) position table)
    checks = kernel_checks(TF, torch, shapes["adam"] + lm_shapes(LONG_SEQ),
                           shapes["sgd"], shapes["adam"])
    checks.update(attention_checks(FA, torch))
    codec_errs = codec_checks(Q, torch)
    bn_errs = bn_checks(BN, torch)
    vgg = vgg16_shapes()
    if len(vgg) != VGG16_LEAVES or sum(map(math.prod, vgg)) != 138_357_544:
        raise AssertionError("VGG-16's leaf shapes do not add up")
    vgg_err = vgg_momentum_check(TF, torch, vgg)
    hvd.init()
    os.environ["HOROVOD_FUSED_UPDATE"] = "1"
    timings = kernel_timings(TF, torch, shapes["momentum"],
                             ("momentum", "sgd"))
    timings.update(kernel_timings(TF, torch, shapes["adam"], ("adam",)))
    timings.update(attention_timings(FA, torch, ATTN_SHAPE, LM_BATCH, True))
    long_times = attention_timings(FA, torch, LONG_ATTN_SHAPE, LONG_BATCH,
                                   False)
    tc_info = tc_build_report(FA)
    codec_times = codec_timings(Q, torch)
    bn_times = bn_timings(BN, torch)
    vgg_times = kernel_timings(TF, torch, vgg, ("momentum",))["momentum"]
    small_reference(hvd, torch)
    small_lm_reference(hvd, torch)
    small_cnn_reference(hvd, torch)
    inception_reference(hvd, torch)
    torch.backends.cudnn.benchmark = True
    path = main_path(hvd, torch, STEPS, BATCH, gpu, args.profile)
    model = path.pop("model")
    wire = codec_path(hvd, Q, torch, model, gpu)
    zero_tail = zero_tail_emulated(torch, model, gpu)
    data_plane = data_plane_emulated(hvd, torch, model, gpu)
    del model
    torch.cuda.empty_cache()
    sgd = sgd_path(hvd, torch, gpu)
    torch.cuda.empty_cache()
    cnn = {name: cnn_path(hvd, torch, name, gpu, args.profile)
           for name in CNN}
    lm = lm_path(hvd, torch, LM_SEQ, LM_BATCH, LM_STEPS, gpu, "transformer",
                 args.profile)
    torch.cuda.empty_cache()
    long_errs = long_context(hvd, torch, FA, gpu, args.profile)
    torch.cuda.empty_cache()
    zero = zero_resnet_paths(hvd, torch, gpu)
    zero_lm = lm_path(hvd, torch, LM_SEQ, LM_BATCH, ZERO_STEPS, gpu,
                      "transformer stage 2", zero_stage=2)
    if not zero_lm["losses"][-1] < zero_lm["losses"][0]:
        raise AssertionError(f"transformer stage 2: losses do not fall: "
                             f"{zero_lm['losses']}")
    log(f"[zero] transformer stage 2: optimizer state "
        f"{zero_lm['state_bytes']} B (stage 0: {lm['state_bytes']} B)")
    sp = sequence_parallel(FA, torch)
    data_plane["degenerate"] = data_plane_degenerate(hvd, torch, gpu)
    torch.cuda.empty_cache()
    mp = model_parallel(hvd, torch, gpu)
    torch.cuda.empty_cache()
    pp = pipeline_parallel(hvd, torch, gpu)
    torch.cuda.empty_cache()
    lsgd = local_sgd(hvd, torch, gpu)
    torch.cuda.empty_cache()
    eager = eager_plane(hvd, torch, gpu)
    torch.cuda.empty_cache()
    eager21 = eager_training(hvd, torch, gpu)
    torch.cuda.empty_cache()
    obs = observability(hvd, torch, gpu)
    torch.cuda.empty_cache()
    health = health_plane(hvd, torch, gpu, args.profile)
    hvd.shutdown()
    torch.cuda.empty_cache()
    el = elastic_plane(gpu, os.path.join(_build.BUILD_DIR, "phase24"))
    tune = tuning_plane(hvd, torch, gpu)
    torch.cuda.empty_cache()
    apl = autopilot_plane(hvd, torch, gpu,
                          os.path.join(_build.BUILD_DIR, "phase26"),
                          el["c"]["drain_s"])
    hvd.shutdown()
    fleet = fleet_simulator(gpu)
    prof = perf_observatory(hvd, torch, gpu)
    lint = analysis_phase(hvd, torch, gpu)

    def p24(name: str) -> dict:
        """A kernel's launches in phase 24's and phase 26's runs, as each
        run counted them."""
        return {"launches_restart": {k: c[name] for k, c in
                                     el["b"]["launches"].items()},
                "launches_preempt": {k: c[name] for k, c in
                                     el["c"]["launches"].items()},
                # 26a's three runs (replayed steps included) and 26b's
                "launches_autopilot": {
                    **{k: c[name] for k, c in
                       apl["a"]["launches"].items()},
                    "apdrain": apl["b"]["launches"][name]}}

    launches = {**path["launches"], **lm["launches"],
                "sgd": sgd["launches"]["sgd"]}
    kernels = []
    for kind in ("momentum", "sgd", "adam"):
        t = timings[kind]
        n_el = sum(math.prod(s) for s in shapes[kind])
        model = "transformer" if kind == "adam" else "ResNet-50"
        kernels.append({
            **p24(kind),
            "name": f"fused_update.{kind}",
            "route": "cuda",
            "source": "horovod_tpu_torch/csrc/fused_update.cu",
            "replaces": REPLACES[kind],
            "launches": launches[kind],
            "max_abs_err": checks[kind]["max_abs_err"],
            "max_ulp": checks[kind]["max_ulp"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library": t.get("library"),
            **({} if kind == "sgd" else
               {"nearest_library_ms": t["nearest_library_ms"],
                "nearest_library": t["nearest_library"]}),
            "ms_per_leaf": t["ms_per_leaf"], "host_ms": t["host_ms"],
            "host_ms_per_leaf": t["host_ms_per_leaf"],
            "ms_one_buffer": t["ms_one_buffer"], "ms_kernel": t["ms_kernel"],
            "launches_per_sweep": t["launches_per_sweep"],
            "capacity": TF.capacity(kind),
            "launch": "one over all the leaves of one dtype, the leaf "
                      "table in the kernel's parameters",
            "shapes": f"{len(shapes[kind])} {model} leaves, {n_el} f32",
            **({"torch_mul_ms": t["torch_mul_ms"]} if kind == "sgd" else {}),
            **({"launches_zero_resnet50": {
                    n: r["launches"]["momentum"] for n, r in zero.items()},
                "zero_tail_launches": zero_tail["momentum"],
                # phase 19a, per emulated rank over LS_STEPS inner steps
                "launches_local_sgd": {
                    n: r["launches"][0]["momentum"]
                    for n, r in lsgd["a"].items()},
                # phase 21a, per emulated rank over ZE_STEPS steps of the
                # eager regime (one on the shard per step), the wrapper's
                # own counter booked per rank
                "launches_eager_zero": {
                    n: r["b1"][0] for n, r in eager21["a"].items()
                    if n != "hier"},
                # phase 22a, per round of OBS_STEPS steps, bare and
                # observed
                "launches_observability": {
                    m: [c["momentum"] for c in v]
                    for m, v in obs["a"]["launches"].items()},
                # phase 23a, per round of HEALTH_STEPS steps, health off
                # and on; then the skipped step and the next clean one
                "launches_health": {
                    m: [c["momentum"] for c in v]
                    for m, v in health["a"]["launches"].items()},
                "launches_health_skip": [
                    health["a"]["skip"]["b1_skipped_step"],
                    health["a"]["skip"]["b1_next_step"]],
                # phase 25a, per round of TL_STEPS steps, the timeline
                # detached and attached
                "launches_timeline": {
                    m: [c["momentum"] for c in v]
                    for m, v in tune["a"]["launches"].items()},
                # phase 28a, per step under the sampled capture
                "launches_profile": [c["momentum"]
                                     for c in prof["launches"]],
                # phase 29c, the step under the schedule recorder
                "launches_analysis": lint["counts"]["momentum"]}
               if kind == "momentum" else {}),
            **({"launches_zero_lm": zero_lm["launches"]["adam"],
                "zero_tail_launches": zero_tail["adam"],
                # phase 17, per emulated rank over MP_STEPS steps
                "launches_tp": mp["tp"]["launches"]["adam"],
                "launches_ep": mp["ep"]["launches"]["adam"],
                # phase 18, per emulated rank per step (a, b, c)
                "launches_pp": {k: pp[k]["launches"]["adam"]
                                for k in "abc"}}
               if kind == "adam" else {}),
            **({"ms_vgg16": vgg_times["ms"],
                "plain_ms_vgg16": vgg_times["plain_ms"],
                "bound_ms_vgg16": vgg_times["bound_ms"],
                "nearest_library_ms_vgg16": vgg_times["nearest_library_ms"],
                "ms_kernel_vgg16": vgg_times["ms_kernel"],
                "max_ulp_vgg16": vgg_err["max_ulp"],
                "launches_vgg16": cnn["vgg16"]["launches"]["momentum"],
                "launches_inception3":
                    cnn["inception3"]["launches"]["momentum"]}
               if kind == "momentum" else {}),
        })
    for name in FLASH:
        t, tl = timings[name], long_times[name]
        kernels.append({
            **p24(name),
            "name": f"flash_attention.{name}",
            "route": "cuda",
            "source": "horovod_tpu_torch/csrc/flash_attention.cu",
            "replaces": REPLACES[name],
            "launches": launches[name],
            # the largest over every case, the long-context shape's and
            # the sequence-parallel offsets' too
            **{k: max(checks[name][k], long_errs[name][k],
                      sp["offsets"][name][k])
               for k in ("max_abs_err", "max_row_err")},
            "max_abs_err_long": long_errs[name]["max_abs_err"],
            "max_row_err_long": long_errs[name]["max_row_err"],
            "max_abs_err_sp_offsets": sp["offsets"][name]["max_abs_err"],
            "max_row_err_sp_offsets": sp["offsets"][name]["max_row_err"],
            # phase 15b-c: per emulated rank, forward + backward
            "launches_sp": {k: r["launches"] for k, r in
                            (*sp["rings"].items(),
                             ("ulysses", sp["ulysses"]))},
            "ms_sp": {k: r["ms"] for k, r in
                      (*sp["rings"].items(), ("ulysses", sp["ulysses"]))},
            "ms_sp_device": {k: r["ms_device"] for k, r in
                             (*sp["rings"].items(),
                              ("ulysses", sp["ulysses"]))},
            "max_row_err_sp_ring": max(
                r["res"][name]["max_row_err"]
                for r in sp["rings"].values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "library": t["library"],
            "tflops": t["tflops"],
            "ms_long": tl["ms"], "bound_ms_long": tl["bound_ms"],
            "library_ms_long": tl["library_ms"], "tflops_long": tl["tflops"],
            **tc_info.get(name, {}),
            "launches_zero_lm": zero_lm["launches"][name],
            # phase 17, per emulated rank over MP_STEPS steps
            "launches_tp": mp["tp"]["launches"][name],
            "launches_ep": mp["ep"]["launches"][name],
            # phase 18, per emulated rank per step: GPipe, interleaved,
            # pp_remat
            "launches_pp": {k: pp[k]["launches"][name] for k in "abc"},
            "cores": "bf16 on the tensor cores (wgmma), f32 on the CUDA "
                     "cores",
            **({"ms_with_dkv": t["ms_with_dkv"],
                "ms_with_dkv_long": tl["ms_with_dkv"]}
               if name == "flash_bwd_dq" else {}),
            "shapes": f"timed at {ATTN_SHAPE} bf16 causal; *_long at "
                      f"{LONG_ATTN_SHAPE}",
        })
    for kind in CODECS:
        t, tl = (codec_times[kind][k] for k in CODEC_BUFFERS)
        kernels.append({
            **p24(kind),
            "name": f"quantization.{kind}",
            "route": "cuda",
            "source": "horovod_tpu_torch/csrc/quantization.cu",
            "replaces": REPLACES[kind],
            # the compressors' round trips of the 161 ResNet-50 leaves
            "launches": wire["launches"][kind],
            # phase 19a, per emulated rank over its LS_STEPS // LS_H syncs
            "launches_local_sgd": {
                n: r["launches"][0].get(kind, 0)
                for n, r in lsgd["a"].items()},
            # phase 20b, per emulated rank over EAGER_STEPS steps of the
            # eager plane on each wire (one per fused float response)
            "launches_eager": {w: eager["b"][w]["launches"][0].get(kind, 0)
                               for w in EAGER_WIRES},
            "eager_responses": {w: eager["b"][w]["responses"]
                                for w in EAGER_WIRES},
            # phase 21a, per emulated rank over ZE_STEPS steps of the
            # eager ZeRO regime (one per reduce-scatter response)
            "launches_eager_zero": {
                n: r["codec"][0][kind]
                for n, r in eager21["a"].items() if n != "hier"},
            # phase 22b, per emulated rank over EAGER_STEPS int8 steps
            "launches_observability": [
                x.get(kind, 0) for x in obs["b"]["launches"]],
            # phase 23b, per emulated rank over EAGER_STEPS int8 steps
            # with the health tap
            "launches_health": [
                x.get(kind, 0) for x in health["b"]["health"]["launches"]],
            # phase 25b, rank 0 over TUNE_STEPS steps under the tuner's
            # per-bucket modes, and per step
            "launches_autotune": tune["b"]["launches"][kind],
            "launches_autotune_per_step": [
                c[kind] for c in tune["b"]["launches_per_step"]],
            # phase 29b, the program set over 8 emulated ranks (the
            # lossy programs' codec kernels)
            **({"launches_analysis": lint["programs"]["launches"][kind]}
               if kind in ("quantize", "dequantize") else {}),
            "max_abs_err": max(codec_errs[kind], wire["errs"][kind]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": CODEC_LIBRARY[kind] or NO_LIBRARY,
            "ms_transformer": tl["ms"], "plain_ms_transformer": tl["plain_ms"],
            "bound_ms_transformer": tl["bound_ms"],
            "library_ms_transformer": tl["library_ms"],
            "shapes": (f"timed at the ResNet-50 fused buffer "
                       f"({-(-N_PARAMS // QBLOCK)}, {QBLOCK}) f32; "
                       "*_transformer at (433227, 256)"),
        })
    for name in BN_KERNELS:
        t, ti = (bn_times[name][k] for k in BN_TIMED)
        e = bn_errs[name]
        kernels.append({
            **p24(name),
            "name": f"batch_norm.{name}",
            "route": "cuda",
            "source": "horovod_tpu_torch/csrc/batch_norm.cu",
            "replaces": BN_REPLACES,
            # the ResNet-50 path's run; the other CNN paths' beside it
            "launches": launches[name],
            "launches_inception3": cnn["inception3"]["launches"][name],
            "launches_vgg16": cnn["vgg16"]["launches"][name],
            "launches_zero_resnet50": {n: r["launches"][name]
                                       for n, r in zero.items()},
            # phase 22a, per round of OBS_STEPS steps, bare and observed
            "launches_observability": {
                m: [c[name] for c in v]
                for m, v in obs["a"]["launches"].items()},
            # phase 23a, per round of HEALTH_STEPS steps, health off and on
            "launches_health": {
                m: [c[name] for c in v]
                for m, v in health["a"]["launches"].items()},
            # phase 25a, per round of TL_STEPS steps, the timeline
            # detached and attached
            "launches_timeline": {
                m: [c[name] for c in v]
                for m, v in tune["a"]["launches"].items()},
            # phase 28a, per step under the sampled capture
            "launches_profile": [c[name] for c in prof["launches"]],
            # phase 29c, the step under the schedule recorder
            "launches_analysis": lint["counts"][name],
            "max_abs_err": e["max_abs_err"], "max_ulp": e["max_ulp"],
            "max_err_f64": e["max_err_f64"],
            "plain_err_f64": e["plain_err_f64"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            **({"library": t["library"],
                "library_max_rel_diff": t["library_max_rel_diff"],
                "library_ms_inception3": ti["library_ms"]}
               if t["library_ms"] is not None else
               {"nearest_library_ms": t["nearest_library_ms"],
                "nearest_library": t["nearest_library"],
                "nearest_library_ms_inception3": ti["nearest_library_ms"]}),
            "layer_library_ms": t["layer_library_ms"],
            "layer_library": t["layer_library"],
            "ms_inception3": ti["ms"], "plain_ms_inception3": ti["plain_ms"],
            "bound_ms_inception3": ti["bound_ms"],
            "layer_library_ms_inception3": ti["layer_library_ms"],
            **({"cancel": e["cancel"]} if name == "bn_stats" else {}),
            "shapes": f"timed at {BN_SHAPES[BN_TIMED[0]]} bf16 (ResNet-50 "
                      f"bn_init); *_inception3 at {BN_SHAPES[BN_TIMED[1]]}",
        })
    log(f"[health] phase 23a: health on/off median step ratio "
        f"{health['a']['ratio']:.4f} ({health['a']['median_s']['on']:.4f} "
        f"against {health['a']['median_s']['off']:.4f} s); 23c save "
        f"{health['c']['save_s']:.4f} s, restore "
        f"{health['c']['restore_s']:.4f} s of {health['c']['bytes']} B; on "
        f"{gpu}")
    log(f"[obs] phase 22a: observed/bare median step ratio "
        f"{obs['a']['ratio']:.4f} ({obs['a']['median_s']['observed']:.4f} "
        f"against {obs['a']['median_s']['bare']:.4f} s) on {gpu}")
    log(f"[elastic] phase 24: KV round trip {el['a']['roundtrip_us']:.1f} "
        f"us; restart downtime {el['b']['downtime_s']:.3f} s; drain "
        f"{el['c']['drain_s']:.3f} s (grace {el['c']['grace_s']:.0f} s); "
        f"on {gpu}")
    log(f"[timeline] phase 25a: timeline on/off median step ratio "
        f"{tune['a']['ratio']:.4f} ({tune['a']['median_s']['on']:.4f} "
        f"against {tune['a']['median_s']['off']:.4f} s), writer host time "
        f"{tune['a']['writer_ms_per_step']:.3f} ms per step; 25b "
        f"{tune['b']['samples']} samples, pinned {tune['b']['pinned']}, "
        f"final knobs {tune['b']['final']}; on {gpu}")
    log(f"[autopilot] phase 26: tick {apl['a']['tick_ms']['on']:.4f} ms per "
        f"commit on against {apl['a']['tick_ms']['off']:.4f} ms off; "
        f"rollback {apl['a']['rollback_s']:.3f} s; drain through the "
        f"autopilot {apl['b']['drain_s']:.3f} s (24c {el['c']['drain_s']:.3f}"
        f" s); on {gpu}")
    log(f"[simfleet] phase 27: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in fleet["wall_s"].items())
        + f"; scaling ratio {fleet['scaling']['ratio']}; on {gpu}")
    log(f"[perf] phase 28: {prof['captures']} captures; device compute "
        f"over the CUDA-event step {prof['compute_ratios']}; mfu "
        f"{prof['mfu']}; un-sampled/off median step ratio "
        f"{prof['ratio']:.4f} beside the off rounds' {prof['noise']:.4f}; "
        f"on {gpu}")
    log(f"[analysis] phase 29: the CLI's summary {lint['cli']['summary']}; "
        f"the closed hooks add {lint['added_s'] * 1e6:.2f} us per ResNet-50 "
        f"step ({lint['share']:.3e} of it; launch "
        f"{lint['hook_ns']['launch']['added_ns']:.1f} ns, transfer "
        f"{lint['hook_ns']['transfer']['added_ns']:.1f} ns per event); "
        f"shipped/parent-work median step ratio {lint['ratio']:.4f} beside "
        f"the parent-work rounds' {lint['noise']:.4f}; on {gpu}")
    log(f"[done] wall time {time.perf_counter() - t_start:.1f} s; CNN paths "
        + "; ".join(f"{n}: median step {r['median_s']:.4f} s, "
                    f"{CNN[n][1] / r['median_s']:.1f} img/s, peak "
                    f"{r['peak_bytes']} B" for n, r in cnn.items()))
    log(json.dumps({"kernels": kernels}))
    log(gpu)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="FILE",
                    help="also profile a few steps of each path; write the "
                         "profiler's tables to FILE, FILE_vgg16, "
                         "FILE_inception3, FILE_transformer and FILE_long")
    ap.add_argument("--phase24-worker", nargs=2, metavar=("MODE", "DIR"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.phase24_worker:
        return _p24_worker(*args.phase24_worker)
    try:
        return run(args)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
