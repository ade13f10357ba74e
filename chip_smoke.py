#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (src/repro_torch) end to end on one NVIDIA GPU.

    python3 chip_smoke.py [--layers-out PATH]

1. Refuses at once without CUDA, or when it does not sit in a checkout of the
   repository (it needs src/repro_torch). Prints the card's name and power
   limit as nvidia-smi reports them.
2. Builds the CUDA kernels from the checkout's sources with nvcc (one nvcc
   per source, in parallel) and times the build; counts HMMA, LDGSTS, LDS
   and FFMA in the SASS (cuobjdump) of each instantiation of the split-TF32
   kernels (the fp32 ECR / PECR kernel, the fp32 BSR kernel, the fp32
   flash forward, both flash backward passes and the MLA kernel), of the
   MLA backward's dq and dkv kernels (fp32 and bf16 latent, on the TF32
   tensor cores) and of the bf16 flash kernels (with LDSM, also counted
   for the rest), and fails unless every one has HMMA and
   LDGSTS (the MLA forward's key-split combine, which has neither, is
   only counted),
   every bf16 one (and the MLA forward over a bf16 latent) LDSM
   (ldmatrix), and the expected number of
   instantiations exists; prints each one's registers, stack frame and
   spill bytes (nvcc -Xptxas -v, from the build's output).
3. Serves the published VGG-19 (3x224x224, 1000 classes, random weights from
   a fixed generator seed with the dead-filter shift) through the port's
   Engine (block_c=8, occ_threshold=0.75, max_batch=8, SimClock): 16 requests
   through replay_stream. The engine serves every batch by replaying the
   CUDA graph its warmup captured per bucket, so the kernel wrappers'
   Python counters do not tick while it serves: a launch on the served path
   is counted as the launches each runner recorded per replay while
   capturing, times its replays, plus any wrapper launch (`read_counts`).
   Those counts are set to 0 just before and read just after; the plan
   must hold ECR and PECR layers, both counts must have grown, and no
   served batch may have built (captured) a runner. The warm batch-8
   service is traced through the captured runner, with eager `run_plan`
   beside it. Engine logits are held against the dense
   path on cuDNN (TF32 off) at rtol=1e-3 plus atol=1e-3*max|dense| — sixteen
   fp32 conv layers summed in another order. Then LeNet-5 and AlexNet serve
   8 requests each with the same check.
4. Three more VGG-19 phases, 16 requests each, counters set to 0 just before
   each and read just after:
   - pruned to block density 0.3 (prune_graph_params, probed on the
     calibration batch), fp32: bsr_matmul must launch; logits within the
     same tolerance of the dense cuDNN path on the pruned weights;
   - unpruned, int8=True: ecr_conv_int8 must launch; engine logits bitwise
     equal to run_plan on the same 8-bucket; top-1 agreement and max drift
     against the fp32 dense path are printed;
   - pruned to 0.3 and int8=True: bsr_matmul_int8 must launch; the same
     checks. The int8 phases are planned once at the default int8_budget
     0.98 (its Int8Report is printed) and served at int8_budget=0.0: random
     weights give near-tied logits, so the probe is no accuracy claim here.
5. Holds each kernel against its plain PyTorch version on the same packed
   operands, at the real input of every layer of each served plan that runs
   it (batch 8, and the single-image branch at N=1 for the conv kernels),
   and at edge cases (a cnt=0 sample or row-block, stride 4 with k 11, k 5
   with pad 0, K=27 and other ragged K/O/P, C % block_c != 0, int8 values at
   +-127 over VGG-19's longest reduction). The int8 tensor-core kernels
   also meet the paths they add: ECR schedules whose live blocks leave 1, 2
   or 3 blocks of a 32-channel step (cnt % 4 at block_c 8), cnt = n_cb,
   ids out of order, block_c 4 and 16, and N=1 at conv13's shape (a grid
   of 8 blocks); BSR at every block width 8-128 with F = 25 and 27, T not
   a multiple of 8, ragged P, and density 0.3 with schedules that differ
   per row-block. The split-TF32 BSR kernel meets its own paths
   (`edge_cases_bsr_tf32`): every block width 8-128 at density 0.3 with
   schedules that differ per row-block and a cnt = 0 row-block, F = 25 and
   27 with T = 70 and ragged P, the conv probe lowered as BSR at K = 4608
   (uniform, and x and w spread over 2^+-12), operands off 16-byte
   alignment. The split-TF32 ECR / PECR kernel meets its own paths
   (`edge_cases_tf32`): schedules that leave half an 8-channel k-step
   (block_c 4) or take two per block (block_c 16), cnt = n_cb, cnt = 0, ids
   out of order, ragged O, with and without the pool; N=1 at conv13's shape;
   the served conv10 and conv12 shapes at batch 8; x and w spread over
   2^+-12 at K = 4608, where one TF32 product per multiply-add fails the
   limit; operands off 16-byte alignment. fp32 kernels:
   max|kernel - plain| <= 1e-4*max|plain| + 1e-5*min(1, max|plain|): the
   absolute floor shrinks with the data, since pruning leaves the deep
   layers' outputs far below 1e-5; int8 kernels: bitwise equal. The ops
   are also held against cuDNN (fp32) or their int8 oracle.
   Times kernel, plain version and the library call with CUDA events after
   warm-up, in turns (eager calls; kernel and library call also as
   CUDA-graph replays, which leave out the host's per-call overhead), and
   computes each call's bound from its data. The
   library call is F.conv2d (+ relu + max_pool2d for PECR) for the fp32 conv
   kernels, F.conv2d on the dequantized operands for the int8 conv,
   torch.matmul on the padded dense operands for BSR, and torch._int_mm plus
   the rescale for int8 BSR; none of these is on the port's path.
5b. The graphs phase: VGG-19 (dense-weight, pruned 0.3, int8, pruned
   int8), LeNet-5 and AlexNet (published widths, seed-0 weights) through an
   Engine's compiled runners at buckets 2, 4 and 8: each bucket's capture
   seconds, torch.cuda.memory_reserved and graph pool bytes; its logits
   bitwise equal to eager run_plan at the same bucket, and its occupancies
   equal, at n_valid = 1 .. bucket on one runner; its launches per replay
   equal to the plan's kernel layers; eager and graph host wall (median of
   5); at bucket 8 the device time and idle share of a replayed batch and
   of eager run_plan (torch.profiler), and each kernel of the plan found
   in the replay's trace as often as the plan runs it (its C entry point
   printed beside the kernel symbol). Then a hot swap to another params set
   with the same zeros (so the same plan and key) and back: no build, no
   capture, each batch bitwise equal to its own params' run_plan.
5c. The sharded phase: the published VGG-19 served data-parallel through
   Engine(mesh=data_mesh(2, devices=[cuda:0, cuda:0])), two slots of the
   one card standing for the reference's virtual devices, for the
   dense-weight fp32 variant (ECR and PECR per shard) and the pruned 0.3 +
   int8 variant (int8 BSR, and int8 ECR where planned), 16 requests each
   (two 8-buckets, each split 4 + 4). Counters set to 0 just before serving
   and read just after: every kernel's launches equal 2 x the sum of the
   slots' per-replay counts, no eager launch, no runner built while
   serving. Each shard's logits bitwise equal to run_plan on its slice
   (cuDNN picks its algorithm per batch size, so the whole bucket's rows
   are not the contract); the fp32 variant's 16 logits against the dense
   cuDNN path at rtol 1e-3 + 1e-3*max, the int8 variant's top-1 agreement
   and max drift against the fp32 dense path printed. A ragged bucket of 4
   images and 4 all-zero pads (the second shard all padding): the
   aggregated occupancy within 1e-6 of run_plan's n_valid-masked
   statistic. Captures and graph-pool bytes per slot; the warm batch-8
   service, sharded against an unsharded runner of the same plan, in turns
   (device time and host wall by graph replay: on one card the shards
   share its SMs, so this is the cost of sharding, not a speed-up). The
   default Engine (mesh="auto") on a one-card machine: one slot and
   PlanKey.mesh_shape (). With two or more cards, the fp32 variant also
   serves over auto_mesh's real cards; with one, the phase says that part
   did not run.
6. The obs phase: measure -> calibrate -> search -> plan on the published
   VGG-19 and on it pruned to 0.3, at batch 8 (eight calibration images):
   - profile_plan times every layer under dense (cuDNN), ECR, PECR (on the
     fusable layers), BSR, int8 ECR and int8 BSR (host wall around each
     layer call and a synchronize, median of 3) and prints one line per
     layer: occupancy, weight density, ms per impl;
   - CalibrationDB.from_report fits one scale per (kind, impl), printed
     with the plan at the datasheet constants beside the calibrated one;
   - tile_search searches the occupancy-rule plan's kernel layers on the
     card's grid (fp32 ECR / PECR block_c x block_o, BSR bf) and prints
     each layer's default and winner with their times and whether the
     floor holds (it must); every timed geometry's kernel is held against
     its plain version (fp32 limit; int8 bitwise);
   - an Engine planned with the DB's constants and tile winners, traced,
     serves 16 requests: its logits within the tolerance of the dense path
     on cuDNN, every kernel of its plan launched, and the plan must reach
     at least one kernel. Every kernel must also have launched in the
     profile and the search. With --layers-out, the trace and the DB are
     written beside that file (obs_trace_*.json, obs_calibration_*.json).
7. The paper's methods as plain oracles, and the static verifier:
   - full-width VGG-19 (3x224x224, 1000 classes; init_cnn at generator
     seed 0 plus shift_dead_channels) through cnn_forward at batch 1 (one
     image) and 2 under dense, im2col, ecr, pecr (the oracles) and
     ecr_pallas, pecr_pallas (the kernels): each impl's logits within
     1e-4*max|dense|, printed with the forward's wall, its peak
     torch.cuda.max_memory_allocated and its kernel launches; the window
     statistics (sparsity, theta, mul and add reduction; paper Fig. 2 /
     Fig. 6) of the 16 conv inputs; each conv layer timed at batch 1 by
     CUDA events under conv2d dense / im2col / ecr / ecr_pallas and each
     stage-final layer under conv_pool unfused / pecr / pecr_pallas, with
     fused_traffic_bytes beside it; the oracle plan
     (plan_network(use_pallas=False)) verified and run against dense;
   - verify_plan on every plan the script builds (the served VGG-19,
     LeNet-5 and AlexNet plans, the pruned / int8 / pruned+int8 plans and
     their probes, the obs phase's base, calibrated and tile-stamped
     plans, the oracle plan): none may have an error;
   - a copy of the served VGG-19 plan with an ECR layer claimed as BSR at
     density 0.3 on unpruned params must give RPA205 and be refused by
     run_plan; one with a tile the kernels cannot honour gives the RPA204
     warn (the kernel falls back, logits bitwise unchanged); a launch
     record one spatial tile short gives RPA101; verify_plan's host wall
     per run_plan call is printed beside the batch-8 wall, for the served
     VGG-19 plan and for each pruned / int8 variant's;
   - the Python mirror of the conv kernels' tile choice
     (kernels/tiles.py) against the kernels' own host code on every
     full-width VGG-19 / LeNet-5 / AlexNet conv geometry at batch 1, 2
     and 8 (each output tile, with and without the pool, fp32 and int8),
     each accepted geometry launched once at batch 2, and kMaxSmem against
     the device's opt-in shared memory per block where torch exposes it;
   - python -m repro_torch.analysis.cli --json over the reduced zoo must
     exit 0 with no error.
8. Serves full-width qwen3-0.6b (28 layers, d_model 1024, 16 query / 8 KV
   heads, head_dim 128, vocab 151,936; random weights from generator seed
   0) through `repro_torch.launch.serve.serve` at batch 4, prompt 32, 32
   generated tokens, once with the fp32 KV cache and once with the int8
   cache, after a 2-token warm-up of each. The flash counters are set to 0
   just before each run and read just after: flash_fwd must launch 28 * 32 =
   896 times in the fp32 run and flash_fwd_q8 896 times in the int8 run (one
   launch per layer at prefill and at each of the 31 decode steps). The
   card's weights are carried to the host and the port's plain path runs
   teacher-forced on the served tokens (prefill plus 4 decode steps, fp32
   and int8 cache): card logits within rtol 1e-3 + 1e-3*max|host| of the
   host's, and the served tokens equal to the card's argmax. For the int8
   cache the host first quantizes its own K/V and must land within one step
   of the card's values (scales within 1e-5 relative), then attends over
   the card's values: a value on a rounding boundary may round either way
   after fp32 noise, and one step apart moves the logits by more than the
   limit. int8-cache top-1 agreement and drift against the fp32 cache are
   printed. Then both
   flash kernels are held against their plain versions (out, m and l for
   fp32; same tolerance as the fp32 conv kernels) at the real q, k, v of
   layers 0 and 27 at prefill and at the first decode step (captured from
   the teacher-forced card run), at a long prefill (Sq = Sk = 2048, causal)
   and a long decode (kv_len 4096 in a 4160-slot cache) at batch 4, and at
   edge shapes (ragged Sq/Sk, kv_len < Sk, q_offset > 0, Sq = 1, a fully
   masked block, G = 3; decode at G = 1, 2, 4, 8 with kv_len 1, 63 and 65,
   the fp32 kernel's tile edges; q and k spread over 2^+-3 at D = 128).
   The training phase adds the trained forward shape (layer 0 of a batch-8
   step: out, m and l, timed). Kernel, plain version and the library call
   (F.scaled_dot_product_attention in fp32 with K/V expanded to the query
   heads and the same boolean mask; dequantize + SDPA for the int8 kernel)
   are timed in turns at layer 0 of the served shapes and at the long ones,
   as CUDA-graph replays (device time: the eager call's host overhead
   exceeds the kernel at the served shapes) and as eager calls.
   A torch.profiler trace of one warm prefill and one warm decode step per
   cache type gives wall, device time and idle share.
9. Trains full-width qwen3-0.6b (the same config, weights from generator
   seed 0) through `repro_torch.launch.train.train` at the reference
   launcher's defaults: bf16 parameters, fp32 moments, global batch 8,
   sequence 128, remat "full", 6 steps, checkpoints into a temporary
   directory the phase removes. Prints each step's loss, grad norm,
   synchronised step time, tok/s and model TFLOP/s (6 * n_params * tokens
   per step, n_params from `ModelConfig.n_params`). The flash counters and
   the per-entry-point counts (`kernels.cuda.FLASH_ENTRY_LAUNCHES`) are set
   to 0 just before and read just after: per step flash_fwd must launch 56
   times (28 layers, and again under remat), flash_bwd_dq and flash_bwd_dkv
   28 times each, all on the bf16 entry points and none on an fp32 one.
   Then: the save time of a checkpoint of the trained params and both
   moments; a torch.profiler trace of one warm bf16 step; one step's loss
   and gradients on the card against the host's plain path at bf16 and
   batch 2 (loss within 1e-2 relative, grad norm 3e-2, every leaf within
   5e-2*max|host leaf|, every layer of every leaf nonzero on the card); the
   bf16 kernels against their plain versions (out, dq, dk, dv within
   2^-7*max|plain|, m and l within 1e-5*max|plain|; with q and k over
   2^+-3, where scores reach about 70 and one fp32 ulp of a score moves l
   by about 1e-5 of itself, m and l within the fp32 limit above, as the
   fp32 kernels' m and l) at the real operands of
   layers 0 and 27 of a batch-8 step, at a long causal shape (batch 4,
   Sq = Sk = 2048) and at edge shapes (every head dim, ragged Sq/Sk, G = 1,
   2, 8, q_offset/kv_len, non-causal, rows that see no key; q and k over
   2^+-3 at Sk = 512), all in the model layout read through strides;
   remat none / dots / full from the same weights (one loss and gradient
   computation: its peak memory above the state, full <= dots <= none, and
   loss and leaves of dots and full within 1e-6 relative of none; then two
   steps: the second step's peak, time, device time and forward launches,
   28 / 56 / 56); `compress_grads` -> `decompress_grads` on
   one step's gradients, int8 and topk, two rounds (g + err_old =
   decompressed + err_new within 1e-6*max|g|). Then the fp32 trainer
   (`init_train_state` / `make_train_step` at param_dtype float32, the
   reference's `build_trainer` route), 3 steps, on the fp32 entry points
   only, with its own warm-step trace, gradients against the host at
   batch 2 (loss 1e-4 relative, grad norm 1e-3, leaves 1e-3*max) and the
   fp32 backward kernels at the same shapes (the fp32 limit above). Kernel,
   plain version and the library call (F.scaled_dot_product_attention in
   the operands' type, forward, and the backward with K/V expanded and the
   same mask, all three gradients in one call: the memory-efficient
   attention backward op) timed in turns at layer 0 and at the long shape
   as CUDA-graph replays (device time), the eager calls beside them; the
   bound per pass is max(6 (dq) or 8 (dk/dv) * B*H*pairs*D / the rate of
   the type (split-TF32 165 TFLOP/s, bf16 989), bytes / 3.35 TB/s). At
   head dim 128 the bf16 passes are also run, checked and timed at both
   block tiles (32 and 64 rows a dq block owns, keys a dk/dv block owns,
   through `repro_flash_bwd_*_bf16_tile`), printed on a `bf16 block
   tiles` line per timed shape. Last,
   at the reduced config and bf16, a 10-step run against one with a failure
   at step 7 (checkpoints every 3): losses bitwise equal.
9b. The distributed phase: full-width qwen3-0.6b at the trainer's bf16
   defaults (remat full), B 4 x S 128, 3 steps, trained by the sharded
   trainer (`launch.train.build_trainer`) over 2 gloo ranks sharing cuda:0
   (spawned after the kernels are built) on meshes (2, 1) and (1, 2), and
   by the unsharded trainer on rank 0 in the same run. Per rank: step ms,
   memory (the state it holds plus the most a step allocates above what it
   held before the step) against the unsharded trainer's, its parameter
   shard, the
   launches of the bf16 flash forward and both backward passes (counters
   read just before and after the 3 steps; each must equal the 3-step
   count) and each step's loss and grad norm within 1e-2 / 3e-2 relative of
   the unsharded trainer's; the worst gathered leaf after step 3 within
   5e-2 of max|leaf|, and each leaf's change over the 3 steps within 0.2
   of the unsharded change's, in norm. The runs take no warm-up, so every
   step moves the state at the peak rate. Elastic: a step on (2, 1),
   `shrink_mesh` to (1, 1) at grad_accum 2 (`rebalance_grad_accum`),
   `reshard_state` from the gathered arrays, step 2 within the same limits
   of the unsharded step 2, its change to each leaf too; the dropped rank
   leaves. GPipe (`pipeline_apply`) over the 2 ranks at
   the reference test's case (L 8, M 6, mb 4) at D 16 and D 1024: output
   within 2e-4 of the sequential stack, each stage's gradient within 2e-4
   of autograd's and on its own rank only. With 2 cards it runs again
   over NCCL, a card a rank; with one it prints that NCCL was not run.
9c. The dry-run phase (the compile-time launch tools, `launch/{hlo_cost,
   hlo_analysis,dryrun}`): in a subprocess of its own, on fake worlds of
   `torch.distributed`'s "fake" backend and fake tensors, (a) the port's
   dry run of full-width qwen3-0.6b at decode_32k, prefill_32k and
   train_4k on the 16x16 production mesh (256 fake ranks): per cell FLOPs,
   bytes, collectives by kind, the three roofline terms, the dominant one,
   the useful-FLOP ratio and the trace seconds; it fails on a cell in
   error or a zero FLOP, byte or collective count. (b) The dry run of step
   9b's own cell (B 4 x S 128, bf16, warm-up 0) on fake (2, 1) and (1, 2)
   meshes, held against what step 9b measured in this run: the predicted
   state of a rank (the dry run's state arguments) within 0.5% of what
   step 9b's `build_trainer` left allocated on the card (the allocator's
   `memory_allocated` before and after, which rounds each tensor up to 512
   bytes), and the predicted
   transient (the step's counted peak of live bytes) printed with its ratio
   to the measured transient, no gate. (c) `autotune(mode="model",
   use_pallas=False)` on VGG-19 at batch 8: every candidate's model_us,
   `_model_us` taking `hlo_model_us` for each (kernel-free) plan, and the
   chosen plan's `hlo_model_us` beside its captured runner's device time
   (CUDA events around graph replays); the eager count ignores L2
   residency, so the ratio has no gate. (d) The host's nanoseconds a call
   of `obs.scopes.scope` outside a count (what every attention call pays
   on the serving path) and inside one, beside a bare call.
10. The dense LM phase, after the earlier phases have released their
   engines, graph pools and weights (del, gc.collect(), empty_cache();
   memory_reserved printed before it, the peak allocated in it, and its
   seconds). minitron-8b (d_model 4096, squared-ReLU FFN, block-ECR) and
   stablelm-12b (d_model 5120 over 32 heads: head dim 160), one at a time at
   full width, weights drawn on the card from a `torch.Generator` on it
   (drawing minitron-8b's 7.7 B normals on the host takes over a minute;
   the card's draw seconds are printed), served through `serve(params=...)` at batch 4,
   prompt 32, 32 tokens with an fp32 and an int8 KV cache, the flash
   counters set to 0 just before each served run and read just after:
   n_layers x 32 launches of flash_fwd (fp32) or flash_fwd_q8 (int8), none
   of the other; the served tokens must equal the card's own teacher-forced
   argmax over the whole depth, with finite logits. A warm prefill and
   decode step per cache type are traced (wall, device time, idle share).
   The flash kernels are checked at the captured prefill and first decode
   shapes of layers 0 and n - 1 against their plain versions, layer 0
   timed beside SDPA: out and l at the fp32 limit widened by
   8 * 2^-24 * (the largest row max) * max|plain|, since these configs'
   scores reach ~1,500 (no qk_norm; wq and wk drawn at fan-in n_heads) and
   an fp32 rounding of a score moves p by that fraction, on either side
   (both sides' out is printed against an fp64 reference); at head dim 160 also at ragged,
   causal with q_offset, kv_len < Sk, decode and fully masked edges. On
   minitron-8b's captured layer-0 FFN input (T = 128, D = 4096, F = 16384),
   `sparse_ffn_apply` must be bitwise equal to the dense relu2 FFN, and
   `sparse_ffn_stats` is printed. A depth-2 slice of the served weights
   (untied head included) runs teacher-forced on the card and on the host
   (fp32 and int8 cache, the int8 rounding pinned as in step 8): rtol 1e-3
   + 1e-3*max|host|, the int8 scales within 1e-4 relative (layer 1's K
   comes through layer 0's saturated attention). Then each dense arch's
   REDUCED config trains 3 bf16
   steps on the card (remat "full") beside the host (remat "none") from the
   same state and batches: the flash entry points must be the bf16 ones,
   2 n_layers forward and n_layers of each backward pass per step; the
   loss per step within 1e-2 relative; the same configs with qk_norm on also
   hold the grad norm (3e-2 relative) and step 0's gradient leaves
   (5e-2*max|host leaf|). The registered configs' grad norms and leaves are
   printed beside the host's fp32 grad norm on the same weights, not held:
   without qk_norm their scores have a std of ~32 (wq and wk drawn at
   fan-in n_heads) and bf16 rounding decides their gradients.
10b. The MoE phase, after the dense LM phase has released its weights.
   arctic-480b (d_model 7168, 56 query / 8 KV heads: head dim 128, G 7;
   128 experts top-2, expert width 4864, a dense residual FFN of 4864,
   vocab 32,000) at full width with its depth cut to one layer (~56 GB of
   fp32 weights; two layers do not fit the card), weights drawn on the
   card (seconds and peak allocated printed), served through
   `serve(cfg, params=...)` (the launcher takes the cut config) at batch 4, prompt 32, 32
   tokens with an fp32 and an int8 KV cache, the flash counters set to 0
   just before each served run and read just after: 32 launches of
   flash_fwd (fp32) or flash_fwd_q8 (int8), none of the other. Each served
   call's routing is printed (token count, capacity: 8 at T = 128 and T =
   4, tokens per expert, pairs dropped at capacity). The served tokens must
   equal the card's teacher-forced argmax, with finite logits; a warm
   prefill and decode step per cache type are traced. The flash kernels are
   checked at the captured G 7 prefill and decode shapes of layer 0 as in
   step 10, timed beside SDPA. Layer 0's routed FFN on its captured prefill
   input is held against an fp64 brute force on the card over 4 tokens
   (and any token with a dropped pair): fp64 routing, the reference's
   drops, each kept pair's gated expert weighted by its gate; within
   1e-4*max|fp64|. Reduced arctic-480b (2 layers, 8 experts, dense
   residual), drawn on the host: teacher-forced logits on the card against
   the host over fp32 and int8 caches (rtol 1e-3 + 1e-3*max|host|, the int8
   rounding pinned as in step 10), then 3 bf16 train steps card vs host as
   in step 10 (registered: the loss; qk_norm: loss, grad norm and step-0
   leaves), the router aux loss in the loss.
10c. The MLA phase, after the MoE phase has released arctic's weights.
   deepseek-v2-236b (d_model 5120, 128 heads on one latent kv head: keys
   [c_kv ; k_rope] of width 512 + 64, values c_kv of width 512; 160
   experts top-6 and 2 shared, expert width 1536, vocab 102,400) at full
   width with its depth cut to two layers (~36 GB of fp32 weights),
   weights drawn on the card (seconds, GB and peak allocated printed),
   served through `serve(cfg, params=...)` at batch 4, prompt 32, 32 tokens
   over the fp32 latent cache and the int8 request's bf16 latent cache, the
   flash counters set to 0 just before each served run and read just
   after: 64 launches of repro_flash_fwd_mla_f32 (fp32) or
   repro_flash_fwd_mla_bf16kv (bf16 latent), and none of the other MLA
   entry or of repro_flash_fwd_f32 / repro_flash_fwd_q8. The served tokens
   must equal the card's teacher-forced argmax, with finite logits; a warm
   prefill and decode step per cache are traced. The MLA kernel is held
   against its plain version at the captured prefill and decode shapes of
   layers 0 and 1 (fp32 latent: out 1e-4*max|plain| + 1e-5*min(1,
   max|plain|), m and l 1e-5*max|plain|; bf16 latent: out 2^-7*max|plain|,
   m and l 1e-5*max|plain|), layer 0 timed by CUDA-graph replay beside its
   plain version, SDPA on the same function (the backend it ran named) and
   the bound; the served run's launches are also counted by shape (2 at
   prefill, 62 at decode). Off the served path, a decode over 4,096 keys
   at B 4 (`MLA_LONG_DECODE`, operands drawn on the card, the key-split
   path of the kernel and its combine) is held and timed the same way, for
   both latents. Reduced deepseek-v2 (2 layers, 4 heads on a 32 + 16 latent),
   drawn on the host: teacher-forced logits on the card against the host,
   within 1e-4*max|host| (fp32 latent) and 2^-7*max|host| (bf16 latent).
   The train part: one full-width MLA sublayer (B 2, S 128) forward and
   backward through MLAAttentionFn at fp32 and bf16 (each entry launched
   once), both backward passes against the plain version on the captured
   operands (each repeated bitwise) and timed by CUDA-graph replay beside
   it, SDPA's memory-efficient backward and the bound, both passes also as
   the one call autograd makes; the same at B 1 x S 1024 on operands drawn
   on the card (times printed, not gated); the fp32 sublayer's gradients
   card vs host; reduced deepseek-v2's fp32 and 3 bf16 train steps against
   the host. The phase's seconds and peak memory are printed.
10d. The recurrent phase, after the MLA phase has released deepseek-v2's
   weights. jamba-v0.1-52b (d_model 4096, Mamba d_inner 8192 and state N
   16; attention with 32 query / 8 KV heads, head dim 128, G 4; 16 experts
   top-2 on the odd layers; vocab 65,536) at full width with its depth cut
   to one interleave group of 8 layers, [mamba x4, attn, mamba x3] (~53 GB
   of fp32 weights), weights drawn on the card (seconds, GB and peak
   allocated printed), served through `serve(cfg, params=...)` at batch 4,
   prompt 32, 32 tokens over the fp32 and the int8 KV cache (beside the
   fp32 recurrent state), the launch counters set to 0 just before each
   served run and read just after: 7 x 32 = 224 launches of the selective
   scan (repro_selective_scan_f32) and 32 of repro_flash_fwd_f32 (fp32) or
   repro_flash_fwd_q8 (int8), none of any other entry. The served tokens
   must equal the card's teacher-forced argmax, with finite logits; a warm
   prefill and decode step per cache type are traced. The scan is held
   against its plain version at the captured prefill and decode operands
   of the first and last Mamba layers (the fp32 limit), layer 0's timed by
   CUDA-graph replay and eager beside its plain version and the bound
   (max(B*S*di*(7N + 7) operations / 67 TFLOP/s, bytes / 3.35 TB/s): x,
   dt, z, B, C, A, D and the state read once, out and the state written
   once); no single PyTorch call computes the scan, so no library time.
   The flash kernels are held against their plain versions at the
   attention layer's captured prefill and decode operands (G 4, the
   saturated-scores widening of step 10). xlstm-125m (12 layers of mLSTM /
   sLSTM, d_model 768, 4 heads, vocab 50,304) at full width and depth
   (0.58 GB), served the same way at prompt 128, so that every mLSTM
   prefill takes the chunkwise form (6 calls per prefill, counted), then
   32 tokens on the sequential form; no kernel of the port is on its path
   (every counter must stay 0); tokens against the teacher-forced argmax
   and traces as above. Reduced jamba and xlstm (xlstm at prompt 128),
   drawn on the host: teacher-forced logits on the card against the host
   over the fp32 and the int8 request (rtol 1e-3 + 1e-3*max|host|, the int8
   rounding pinned as in step 10). The phase's seconds and peak memory
   are printed.
10e. The cross phase, after the recurrent phase has released jamba's
   weights. llama-3.2-vision-90b (d_model 8192, 64 query / 8 KV heads, head
   dim 128, G 8; a gated cross-attention layer over 1,024 image tokens
   after every four self-attention layers; vocab 128,256) at full width
   with its depth cut to one group of 5, [attn x4, cross] (6.38 B
   parameters, 25.5 GB at fp32), weights drawn on the card, served through
   `serve(cfg, params=...)` at batch 4, prompt 32, 32 tokens over the fp32
   and the int8 KV cache, with the reference's zero image embeddings at
   prefill and every decode step; the launch counters set to 0 just before
   each served run and read just after: fp32, 5 x 32 = 160 launches of
   repro_flash_fwd_f32; int8, 4 x 32 = 128 of repro_flash_fwd_q8 and 32 of
   repro_flash_fwd_f32 (the cross layer keeps no cache: its K / V are
   recomputed from the image embeddings at every step); none of any other
   entry. The served tokens must equal the card's teacher-forced argmax
   over the same zero inputs, with finite logits; a warm prefill and
   decode step per cache type are traced; the self-attention layer 0's
   flash calls at prefill and decode are held against their plain
   versions (G 8, the saturated-scores widening of step 10). A cross
   layer's gate is drawn as 0.0, and zero image embeddings give K = V = 0,
   so the cross path is then checked with the gate at 0.7 and unit-normal
   image embeddings: the logits must move against the gate at 0, and the
   cross layer's flash call at prefill (Sq 32) and at the first decode
   step (Sq 1), non-causal over the 1,024 image tokens, is held against
   its plain version and timed by CUDA-graph replay beside its plain
   version, SDPA and the bound. whisper-tiny at full size (41,158,276
   parameters: 4 encoder layers, 4 decoder layers of self- and
   cross-attention, d_model 384, 6 heads of 64, G 1), drawn on the host and
   moved to the card, served the same way with the reference's zero frames
   at prefill and zero encoder output at each decode step: fp32, 4 + 32 x 8
   = 260 launches of repro_flash_fwd_f32 (the encoder once, then each
   decoder layer's self- and cross-attention per step); int8, 4 x 32 = 128
   of repro_flash_fwd_q8 and 4 + 4 x 32 = 132 of repro_flash_fwd_f32; the
   greedy check and traces as above; the served requests' teacher-forced
   logits on the card against the host's at full size over both requests
   (rtol 1e-3 + 1e-3*max|host|, the int8 rounding pinned). With the gates
   at 0.7, unit-normal frames at prefill and a unit-normal encoder output at
   decode, the encoder's layer 0 (non-causal, Sq = Sk = 32) and the
   decoder's cross layer 0 (prefill and first decode step) are checked and
   timed on repro_flash_fwd_f32 at head dim 64, and the decoder's
   self-attention layer 0 on repro_flash_fwd_q8. With those inputs the
   registered weights (wq and wk at fan-in n_heads, no qk_norm) amplify
   fp32 rounding until a 1e-7 relative nudge of the inputs moves the
   host's logits by about a tenth of their max, so their card-vs-host error is
   printed beside that gap and not held; the same widths with qk_norm on
   are held card against host at the limit over both requests. Reduced
   llama-3.2-vision-90b and whisper-tiny, drawn on the host with the gates
   at 0.7 and unit-normal side inputs: card against host over both
   requests. The phase's seconds and peak memory are printed.
11. The scenario phase, on the published VGG-19 (weights and calibration
   images as in step 3; Engines at block_c=8, occ_threshold=0.75,
   max_batch=8, on a SimClock charged with the measured service time):
   - hotswap: 24 requests at 200 req/s; at the midpoint `hot_swap` to
     prune_graph_params(params, 0.3) with a plan built on the card. The
     launch counters are read at the swap: bsr_matmul must be 0 there and
     grow after it, ecr_conv and conv_pool must have grown before it. Each
     result is held against run_plan of the model that served it (rtol
     1e-3 + 1e-3*max|logits|; bitwise only at the same bucket), and the two
     models' logits must differ by more than 10x that tolerance; both
     margins are printed. Then the swap back to the dense-weight model
     (no runner built), a candidate with one BSR layer's density claimed
     0.5 on the 0.3 params (`hot_swap` returns False, verify_rejects 1,
     RPA205), and 8 more requests served by the dense-weight model. Then
     the weight signature: the 0.3 variant and the first of 0.5, 0.4, 0.35,
     0.25 with the same (kind, impl) decisions and other rounded BSR
     densities must get two runners on one engine, each serving its own
     model, or the script prints that no such pair exists;
   - diurnal: 32 requests planned at dead_frac 0.5, replan_band 0.15, no
     cooldown, stepping at the midpoint to 0.0 (VGG-19's 3 input channels
     fill one 8-channel block either way, so no occupancy moves; the
     largest EMA drift and the re-plans are printed) and to 1.0 (blank
     frames), where at least one re-plan must land: the batches formed
     before the step, the batch it landed after, the plan before and
     after, and whether the new plan equals plan_network on the drifted
     images (it must);
   - burst: 32 Poisson requests at 50 req/s with 16x bursts: every id
     served once, each formed within the deadline plus the service of the
     batches that ran between its arrival and its formation; p50 / p95;
   - multitenant: VGG-19 and LeNet-5 (published) on one PlanCache and
     clock, 8 requests each: no build after warmup, each tenant within the
     tolerance of its own model's run_plan;
   - history: serve_cnn(full=True, history=...) steady and then
     --scenario hotswap into a temporary BenchDB; every record stamped with
     the card's name, the trend table, and `python -m
     repro_torch.obs.history.cli check --json` must exit 0 or 1 with JSON
     (1 is a regression verdict, printed, not a failure).
   The phase's seconds are printed, per part and in all.
12. Prints the kernel table as one JSON line (the twelve TPU kernel sites of
   the repo; the single-image rows are the batched kernels at N=1), the card
   line, and last {"ok": true, "device": {...}}. Any failure exits non-zero
   without it. In the CNN rows, ms / plain_ms / library_ms /
   bound_ms are sums over the served plan's layers that run the kernel (one
   batch-8 VGG-19 forward, or N=1 for the single-image rows); launches count
   the serving run of the phase that runs the kernel, and are 0 for the
   single-image rows, which the engine (buckets of 2 or more) never runs;
   "sharded_launches" counts the kernel's launches in the sharded phase
   (step 5c, both variants). In
   the flash rows they are sums of one prefill launch and one decode launch
   at the served shapes (layer 0), with every timed shape listed under
   "shapes", and launches count the served qwen3-0.6b run; "dense_lm" lists
   the same per served dense arch (head dim, launches, layer 0's times), and
   "launches_by_head_dim" the served runs' launches by head dim (160:
   stablelm-12b; 64: whisper-tiny; arctic-480b's and llama-3.2-vision-90b's
   add to 128), "moe_lm" the same as
   "dense_lm" for arctic-480b at depth 1 (G 7), "cross_lm" per cross-phase
   arch its launches per request and its timed shapes (step 10e). The flash
   bound is
   max(4*B*H*(visible q.k pairs)*D / 165 TFLOP/s (split-TF32), bytes /
   3.35 TB/s), the
   bytes being the K/V of the keys read (4 bytes, or 1 byte plus the fp32
   scales), Q, O, and m, l for fp32, once. The backward rows time one
   launch of each pass at layer 0 of the trained batch-8 step by graph
   replay, with every timed shape under "shapes", and launches count the
   fp32 trainer's 3-step run; they carry "redesigned_in": 18 (split-TF32),
   eager_ms, eager_library_ms, achieved_tflops, bound_share and
   fp32_core_bound_ms. The bf16 rows (flash_fwd_bf16, flash_bwd_dq_bf16,
   flash_bwd_dkv_bf16) time one launch at layer 0 of the
   trained bf16 step the same way, their launches count the 6-step bf16
   training run, and their bound and achieved TFLOP/s are at 989 TFLOP/s;
   flash_bwd_dq_bf16 and flash_bwd_dkv_bf16 carry "redesigned_in": 25, and
   their trained and long shapes the times of both block tiles ("tile_ms");
   flash_fwd_bf16 carries "redesigned_in": 26 (FlashAttention-2's layout:
   a warp owns 16 rows, a block-shared cp.async ring of K/V tiles,
   ldmatrix fragments). Every time in the line is measured in the run.
   The rows whose kernels were redesigned for the tensor cores, the fp32
   ECR / PECR rows (ecr_conv_batch, conv_pool_batch and both at N=1;
   split-TF32, "redesigned_in": 16), bsr_matmul (split-TF32, 17) and the
   int8 rows (ecr_conv_int8_batch, at N=1, bsr_matmul_int8; 15), time
   kernel and library as device time
   (CUDA-graph replay, as the flash rows do; the eager times ride along as
   eager_ms and eager_library_ms, the plain version is timed eager) and
   carry the achieved GB/s on the bytes of the bound and "bound_share" =
   bound_ms / ms, all from the device time, with the achieved TFLOP/s (fp32
   rows) or TOPS (int8 rows) on the live multiply-adds. The fp32 rows' bound
   is at 495 / 3 = 165 TFLOP/s, the rate of three TF32 products per
   multiply-add, and "fp32_core_bound_ms" beside it at the CUDA cores' 67
   TFLOP/s; the N=1 rows say "split_reduction": false (the kernel does not
   split its reduction across blocks). flash_fwd carries "redesigned_in":
   17 (its rows were always timed by graph replay; flash_fwd_q8 runs on
   its body). The MLA rows (flash_fwd_mla_f32, flash_fwd_mla_bf16kv) sum
   one prefill and one decode launch at layer 0 of the served deepseek-v2
   by graph replay, launches count its served run over their cache type
   ("launches_by_shape" splits them into prefill and decode), "shapes" also
   hold the 4,096-key decode,
   "replaces" names flash_fwd_pallas's function (no pallas_call site sits
   on the reference's MLA path, which runs the jnp flash_attention named
   in "reference_call"), and the bound is max(2*B*H*(visible pairs)*(r +
   dr + r) / 165 TFLOP/s, bytes / 3.35 TB/s), the bytes being q, the keys
   read once, out, and m, l. The selective_scan row sums one prefill and
   one decode launch at layer 0 of the served jamba by graph replay (its
   plain version too), its launches count the served fp32 run
   ("int8_request_launches" the int8 one), "replaces" names the
   reference's `lax.scan` (no pallas_call site), its bound is step 10d's
   and its library_ms is null.
   `--layers-out PATH` also writes the per-layer numbers there as JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
# H100 SXM, TF32 tensor cores (495 TFLOP/s dense) at three products per
# fp32-accurate multiply-add (split-TF32): the fp32 ECR / PECR kernels' rate
PEAK_TF32_SPLIT_FLOPS = 495e12 / 3
PEAK_INT8_OPS = 1979e12  # H100 SXM, int8 tensor cores, dense
PEAK_BF16_FLOPS = 989e12  # H100 SXM, bf16 tensor cores, dense
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
KERNEL_TOL = ("fp32: max|kernel - plain| <= 1e-4*max|plain| + 1e-5*min(1, max|plain|) "
              "(flash out and l at scores up to S: + 8*2^-24*S*max|plain|); "
              "int8: bitwise; bf16 flash: out, dq, dk, dv 2^-7*max|plain|, m and l "
              "1e-5*max|plain| (the fp32 limit with q and k over 2^+-3)")
PRUNE_DENSITY = 0.3
# the split-TF32 kernels and their instantiations: ECR / PECR (4 tiles x
# pool), BSR (16- or 4-byte copies x 8, 4 or 2 row-blocks per block), the
# fp32 flash forward (7 head dims: 8 ... 256 and stablelm-12b's 160), both
# backward passes (6 head dims each) and the MLA kernel (fp32 and bf16
# latent x (r, dr, column slices) 512/64/1, 512/64/4 and 32/16/1; TF32
# products, P.V over a bf16 latent on the bf16 ones, so its SASS shows LDSM)
# with its key-split combine (fp32 and bf16 x r 512 and 32: no MMA, no
# cp.async: the SASS check counts its instantiations only)
SPLIT_TF32_KERNELS = {"ecr_conv_kernel": 8, "bsr_matmul_kernel": 6, "flash_fwd_kernel": 7,
                      "flash_bwd_dq_kernel": 6, "flash_bwd_dkv_kernel": 6,
                      "flash_mla_kernel": 6, "flash_mla_combine_kernel": 4}
NO_MMA_KERNELS = ("flash_mla_combine_kernel",)
# the bf16 tensor-core kernels (the training step at bf16): 6 head dims each,
# and the backward passes' other block tile at head dim 128; the SASS of
# each must show ldmatrix (LDSM) beside HMMA and LDGSTS
BF16_KERNELS = {"flash_fwd_bf16_kernel": 6, "flash_bwd_dq_bf16_kernel": 7,
                "flash_bwd_dkv_bf16_kernel": 7}
# the bf16 backward passes' block tiles (rows a dq block owns, keys a dk/dv
# block owns), both timed at head dim 128
BF16_BWD_TILES = (32, 64)
# the MLA backward passes on the TF32 tensor cores: fp32 and bf16 latent x
# (r, dr) 512/64 and 32/16 each
MLA_BWD_KERNELS = {"mla_bwd_dq_kernel": 4, "mla_bwd_dkv_kernel": 4}
# the selective scan's CUDA-core kernels (fp32 and bf16 activations x N 8
# and 16): no MMA; the backward keeps its chunk's states in registers, so
# its SASS must show no local memory (LDL, STL)
SCAN_KERNELS = {"selective_scan_kernel": 4, "selective_scan_bwd_kernel": 4,
                "scan_bwd_reduce": 4}


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_turns(fns: dict, rounds: int = 5, iters: int = 10) -> dict:
    """Median ms per call of each function, timed with CUDA events after a
    warm-up, the functions taking turns round by round."""
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    samples = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            samples[k].append(start.elapsed_time(end) / iters)
    return {k: sorted(v)[len(v) // 2] for k, v in samples.items()}


def time_graph_turns(fns: dict, rounds: int = 5, iters: int = 10) -> dict:
    """Median device ms per call of each function: `iters` calls captured in
    one CUDA graph per function and replayed, timed with CUDA events, the
    functions taking turns round by round. Graph replay leaves the host's
    per-call overhead out, which at the served LM shapes exceeds the
    kernels' own time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns.values():
            for _ in range(2):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graphs = {}
    for k, fn in fns.items():
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        graphs[k] = g
    for g in graphs.values():
        g.replay()
    torch.cuda.synchronize()
    samples = {k: [] for k in fns}
    for _ in range(rounds):
        for k, g in graphs.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            torch.cuda.synchronize()
            samples[k].append(start.elapsed_time(end) / iters)
    del graphs
    return {k: sorted(v)[len(v) // 2] for k, v in samples.items()}


def device_times(fns: dict) -> dict:
    """Kernel and library ms per call as device time (CUDA-graph replay,
    `time_graph_turns`), the plain version's eager (its schedule loop reads
    the counts on the host, so it cannot be captured); the eager times of
    kernel and library ride along under "eager" as eager_ms and
    eager_library_ms."""
    te = time_turns(fns)
    tg = time_graph_turns({k: fns[k] for k in ("kernel", "library")})
    return {"kernel": tg["kernel"], "plain": te["plain"], "library": tg["library"],
            "eager": {"eager_ms": te["kernel"], "eager_library_ms": te["library"]}}


def work_bound(x, w, ids, cnt, *, stride, block_c, out_elems, peak, elem_bytes=4):
    """(op time, byte time) in ms of a conv kernel for what these inputs
    need: the live blocks' multiply-adds, each scheduled input block read
    once, the weights of the union of scheduled blocks read once (operands
    at `elem_bytes`), the schedules and the fp32 output written once."""
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    oh, ow = (h - kh) // stride + 1, (wd - kw) // stride + 1
    counts = cnt.clamp(0, c // block_c).tolist()
    ids_h = ids.tolist()
    live = sum(counts)
    union = {j for b in range(n) for j in ids_h[b][:counts[b]]}
    ops = 2.0 * oh * ow * o * kh * kw * block_c * live
    nbytes = (elem_bytes * (live * block_c * h * wd + len(union) * block_c * kh * kw * o)
              + 4.0 * (ids.numel() + cnt.numel() + out_elems))
    return ops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3


def bsr_bound(h, d, ids, cnt, block, *, elem_bytes, peak):
    """(op time, byte time) in ms of a BSR matmul h (T,F) @ w (F,d) for what
    this schedule needs: 2*d multiply-adds per live element of h (blocks
    clipped to T and F), each live block of h read once, the rows of w under
    the union of live reduction blocks read once, the fp32 output written
    once, and the schedules."""
    t, f = h.shape
    bt, bf = block[0], block[1]
    counts = cnt.clamp(0, ids.shape[1]).tolist()
    ids_h = ids.tolist()
    area, union = 0, set()
    for i, c in enumerate(counts):
        rows = min(bt, t - i * bt)
        for j in ids_h[i][:c]:
            area += rows * max(0, min(bf, f - j * bf))
            union.add(j)
    w_rows = sum(max(0, min(bf, f - j * bf)) for j in union)
    ops = 2.0 * area * d
    nbytes = elem_bytes * (area + w_rows * d) + 4.0 * (t * d + ids.numel() + cnt.numel())
    return ops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3


class KernelBook:
    """Accumulates each kernel's comparisons and timings for the JSON line."""

    def __init__(self):
        self.rows = []
        self.max_err = {}

    def check(self, kernel, label, got, want, widen=0.0):
        """The fp32 limit, plus `widen` * max|plain| where the scores are
        large enough that their fp32 rounding moves the result by more
        (`score_widening`)."""
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        lim = 1e-4 * scale + 1e-5 * min(1.0, scale) + widen * scale
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), err)
        wide = f", widened by {widen:.2e} x max|plain|" if widen else ""
        print(f"  {kernel:15s} {label:46s} max_abs_err={err:.3e} (limit {lim:.3e}{wide}, "
              f"max|plain|={scale:.3e})")
        if not err <= lim:
            raise AssertionError(f"{kernel} {label}: {err} > {lim} ({KERNEL_TOL})")

    def check_bf16(self, kernel, label, got, want, *, stat=False, wide=False):
        """bf16 flash kernels: out, dq, dk, dv (bf16) within 2^-7 * max|plain|
        (one bf16 ulp at the largest value); m and l (fp32, `stat`) within
        1e-5 * max|plain|, or, with q and k spread over 2^+-3 (`wide`:
        scores near 70, where one fp32 ulp of a score moves l by about 1e-5
        of itself and two summation orders of the same exact products
        differ by that), within the port's fp32 limit, as the fp32 kernels'
        m and l."""
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        if stat and wide:
            lim = 1e-4 * scale + 1e-5 * min(1.0, scale)
        else:
            lim = (1e-5 if stat else 2.0 ** -7) * scale
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), err)
        print(f"  {kernel:15s} {label:46s} max_abs_err={err:.3e} (limit {lim:.3e}, "
              f"max|plain|={scale:.3e})")
        if got.dtype != want.dtype or not err <= lim:
            raise AssertionError(f"{kernel} {label}: {err} > {lim} or {got.dtype} is not "
                                 f"{want.dtype} ({KERNEL_TOL})")

    def check_stat(self, kernel, label, got, want, widen=0.0):
        """m and l of the MLA kernel (fp32): 1e-5 * max|plain|, plus `widen` *
        max|plain| for l where the fp32 rounding of large scores moves it
        more (`score_widening`)."""
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        lim = (1e-5 + widen) * scale
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), err)
        wide = f", widened by {widen:.2e} x max|plain|" if widen else ""
        print(f"  {kernel:15s} {label:46s} max_abs_err={err:.3e} (limit {lim:.3e}{wide}, "
              f"max|plain|={scale:.3e})")
        if got.dtype != want.dtype or not err <= lim:
            raise AssertionError(f"{kernel} {label}: {err} > {lim} ({MLA_TOL})")

    def exact(self, kernel, label, got, want):
        """int8 kernels: bitwise equal to the plain version."""
        import torch

        err = float((got - want).abs().max())
        same = got.shape == want.shape and bool(torch.equal(got, want))
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), err)
        print(f"  {kernel:15s} {label:46s} bitwise={same} max_abs_err={err:.3e}")
        if not same:
            raise AssertionError(f"{kernel} {label}: not bitwise equal ({KERNEL_TOL})")



def check_layer_kernels(book, unit, kind, xp, w, pool, timed: bool):
    """Kernel vs plain (batched and N=1) on one sparse layer's real input,
    the op vs cuDNN, and, when `timed`, kernel/plain/library timings."""
    import torch
    import torch.nn.functional as F

    from repro_torch.graph.registry import unit_launch
    from repro_torch.kernels.conv_pool.kernel import conv_pool_batch, conv_pool_plain
    from repro_torch.kernels.conv_pool.ops import fused_conv_pool
    from repro_torch.kernels.ecr_conv.kernel import ecr_conv_batch, ecr_conv_plain
    from repro_torch.kernels.ecr_conv.ops import ecr_conv, pack_operands, pack_operands_single

    impl = "pecr_pallas" if pool else "ecr_pallas"
    name = "conv_pool" if pool else "ecr_conv"
    stride = unit.conv.stride
    launch = unit_launch(kind, impl, unit, block_c=8, batch=xp.shape[0])
    bc = launch.block_c

    def kernel(args):
        if pool:
            return conv_pool_batch(*args, stride=stride, pool=pool, block_c=bc)
        return ecr_conv_batch(*args, stride=stride, block_c=bc)

    def plain(args):
        if pool:
            return conv_pool_plain(*args, stride=stride, pool=pool, block_c=bc)
        return ecr_conv_plain(*args, stride=stride, block_c=bc)

    def library():
        y = F.conv2d(xp, w, stride=stride)
        return F.max_pool2d(torch.relu(y), pool, pool) if pool else y

    label = f"conv{unit.index + 1} x{tuple(xp.shape)} w{tuple(w.shape)}"
    packed = pack_operands(xp, w, launch)
    got = kernel(packed)
    torch.cuda.synchronize()
    book.check(name, label + f" N={xp.shape[0]}", got, plain(packed))
    single = pack_operands_single(xp[0], w, launch)
    book.check(name, label + " N=1", kernel(single), plain(single))
    op = fused_conv_pool(xp, w, stride, pool, block_c=8) if pool else \
        ecr_conv(xp, w, stride, block_c=8)
    book.check(name, label + " op vs cuDNN", op, library())
    if not timed:
        return
    x1 = xp[:1]

    def library_n1():
        y = F.conv2d(x1, w, stride=stride)
        return F.max_pool2d(torch.relu(y), pool, pool) if pool else y

    row = {"kernel": name, "layer": f"conv{unit.index + 1}",
           "x_nchw": list(xp.shape), "w_oihw": list(w.shape), "block_c": bc,
           "cnt": packed[3].tolist(), "n_cb": launch.n_cb, "n1_cnt": int(single[3][0])}
    for sfx, args, lib_fn, n_out in (("", packed, library, got.numel()),
                                     ("_n1", single, library_n1, got.numel() // got.shape[0])):
        t = device_times({"kernel": lambda a=args: kernel(a),
                          "plain": lambda a=args: plain(a), "library": lib_fn})
        # the bound at the rate of the kernel's arithmetic (split-TF32), and
        # at the CUDA cores' fp32 rate beside it
        ft, bt = work_bound(*args, stride=stride, block_c=bc, out_elems=n_out,
                            peak=PEAK_TF32_SPLIT_FLOPS)
        fc = ft * PEAK_TF32_SPLIT_FLOPS / PEAK_FP32_FLOPS
        row.update({"ms" + sfx: t["kernel"], "plain_ms" + sfx: t["plain"],
                    "library_ms" + sfx: t["library"],
                    "eager_ms" + sfx: t["eager"]["eager_ms"],
                    "eager_library_ms" + sfx: t["eager"]["eager_library_ms"],
                    "flop_ms" + sfx: ft, "byte_ms" + sfx: bt, "bound_ms" + sfx: max(ft, bt),
                    "fp32_core_bound_ms" + sfx: max(fc, bt),
                    "bound_by" + sfx: "operations" if ft >= bt else "bytes"})
        _print_times(f"N={args[0].shape[0]}", t, ft, bt)
    book.rows.append(row)


def edge_cases(book, dev):
    """Synthetic shapes the served VGG-19 does not reach."""
    import numpy as np
    import torch

    from repro_torch.graph.ir import ConvSpec, ConvUnit, PoolSpec

    cases = [  # (c, h, o, k, stride, pad, pool)
        (3, 224, 64, 11, 4, 2, 0),   # AlexNet conv1: stride 4, k 11, C % 8 != 0
        (64, 27, 192, 5, 1, 2, 0),   # AlexNet conv2: k 5
        (6, 14, 16, 5, 1, 0, 2),     # LeNet conv2: k 5, pad 0, fused pool
        (20, 27, 70, 3, 1, 1, 2),    # odd map, O % 64 != 0, C % 8 != 0, floor pool
        (20, 15, 70, 3, 2, 1, 0),    # odd map at stride 2
    ]
    rng = np.random.default_rng(7)
    for i, (c, h, o, k, s, pad, pool) in enumerate(cases):
        x = rng.random((3, c, h, h), dtype=np.float32)
        x *= rng.random((3, c, 1, 1)) > 0.4
        x[-1] = 0.0  # the batcher's all-zero pad sample: cnt = 0
        w = rng.standard_normal((o, c, k, k)).astype(np.float32) / (c * k * k) ** 0.5
        spec = ConvSpec(o, k=k, stride=s, pad=pad)
        oh = (h + 2 * pad - k) // s + 1
        unit = ConvUnit(index=100 + i, stage=0, slot=0, conv=spec, relu=True,
                        pool=PoolSpec(pool) if pool else None, in_shape=(c, h, h),
                        out_shape=(o, oh // max(pool, 1), oh // max(pool, 1)))
        xp = torch.nn.functional.pad(torch.from_numpy(x).to(dev), (pad,) * 4)
        check_layer_kernels(book, unit, "conv_pool" if pool else "conv", xp,
                            torch.from_numpy(w).to(dev), pool, timed=False)


def _row(name, unit, xp, w, t, ft, bt, extra=None):
    row = {"kernel": name, "layer": f"conv{unit.index + 1}",
           "x_nchw": list(xp.shape), "w_oihw": list(w.shape),
           "ms": t["kernel"], "plain_ms": t["plain"], "library_ms": t["library"],
           "flop_ms": ft, "byte_ms": bt, "bound_ms": max(ft, bt),
           "bound_by": "operations" if ft >= bt else "bytes"}
    row.update(extra or {})
    return row


def _print_times(label, t, ft, bt):
    eager = t.get("eager")
    note = (f" [kernel and library: CUDA-graph replay; eager calls: "
            f"{eager['eager_ms']:.4f} / {eager['eager_library_ms']:.4f} ms]" if eager else "")
    print(f"    {label}: ms={t['kernel']:.4f} plain_ms={t['plain']:.4f} "
          f"library_ms={t['library']:.4f} bound_ms={max(ft, bt):.4f} "
          f"({'operations' if ft >= bt else 'bytes'}){note}")


def check_ecr_int8_layer(book, unit, xp, w, timed: bool):
    """int8 ECR kernel vs its plain version (bitwise) on one layer's real
    input, batched and at N=1 (the single-image kernel); the op vs its int8
    oracle; when `timed`, kernel/plain/library times, where the library call
    is F.conv2d on the dequantized operands."""
    import torch
    import torch.nn.functional as F

    from repro_torch.graph.registry import unit_launch
    from repro_torch.quant.kernels import ecr_conv_int8_batch, ecr_conv_int8_plain
    from repro_torch.quant.ops import (
        ecr_conv_int8,
        ecr_conv_int8_ref,
        pack_int8_operands,
        pack_int8_operands_single,
    )

    stride = unit.conv.stride
    launch = unit_launch("conv", "ecr_int8", unit, block_c=8, batch=xp.shape[0])
    bc = launch.block_c
    label = f"conv{unit.index + 1} x{tuple(xp.shape)} w{tuple(w.shape)}"
    packed = pack_int8_operands(xp, w, launch)
    single = pack_int8_operands_single(xp[0], w, launch)

    def kernel(args):
        return ecr_conv_int8_batch(*args, stride=stride, block_c=bc)

    def plain(args):
        return ecr_conv_int8_plain(*args, stride=stride, block_c=bc)

    got = kernel(packed)
    torch.cuda.synchronize()
    book.exact("ecr_conv_int8", label + f" N={xp.shape[0]}", got, plain(packed))
    got1 = kernel(single)
    book.exact("ecr_conv_int8_n1", label + " N=1", got1, plain(single))
    book.check("ecr_conv_int8 op", label + " vs int8 oracle",
               ecr_conv_int8(xp, w, stride, block_c=8), ecr_conv_int8_ref(xp, w, stride))
    if not timed:
        return

    def dequantized(args):
        x, wk, sx, sw = args[:4]
        xd = (x.float() * sx.reshape(-1, 1, 1, 1)).permute(0, 3, 1, 2).contiguous()
        wd = (wk.float() * sw.reshape(1, 1, 1, -1)).permute(3, 2, 0, 1).contiguous()
        return xd, wd

    xd, wd = dequantized(packed)
    xd1, wd1 = dequantized(single)
    t = device_times({"kernel": lambda: kernel(packed), "plain": lambda: plain(packed),
                      "library": lambda: F.conv2d(xd, wd, stride=stride)})
    t1 = device_times({"kernel": lambda: kernel(single), "plain": lambda: plain(single),
                       "library": lambda: F.conv2d(xd1, wd1, stride=stride)})
    x, wk, _, _, ids, cnt = packed
    ft, bt = work_bound(x, wk, ids, cnt, stride=stride, block_c=bc,
                        out_elems=got.numel(), elem_bytes=1, peak=PEAK_INT8_OPS)
    x1, wk1, _, _, ids1, cnt1 = single
    ft1, bt1 = work_bound(x1, wk1, ids1, cnt1, stride=stride, block_c=bc,
                          out_elems=got1.numel(), elem_bytes=1, peak=PEAK_INT8_OPS)
    meta = {"block_c": bc, "cnt": cnt.tolist(), "n_cb": launch.n_cb, **t["eager"]}
    book.rows.append(_row("ecr_conv_int8", unit, xp, w, t, ft, bt, meta))
    book.rows.append(_row("ecr_conv_int8_n1", unit, xp[:1], w, t1, ft1, bt1,
                          {"block_c": bc, "cnt": cnt1.tolist(), "n_cb": launch.n_cb,
                           **t1["eager"]}))
    _print_times(f"N={xp.shape[0]}", t, ft, bt)
    _print_times("N=1", t1, ft1, bt1)


def check_bsr_layer(book, unit, xp, w, *, int8: bool, timed: bool):
    """BSR kernel (fp32 or int8) vs its plain version on one layer's real
    input (fp32 within tolerance, int8 bitwise), the op vs cuDNN (fp32) or
    its int8 oracle, and, when `timed`, kernel/plain/library times: the
    library call is torch.matmul on the padded dense operands (fp32) or
    torch._int_mm plus the rescale (int8)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.bsr_matmul.kernel import bsr_matmul, bsr_matmul_plain
    from repro_torch.quant.kernels import bsr_matmul_int8, bsr_matmul_int8_plain
    from repro_torch.quant.ops import conv2d_bsr_int8, conv2d_bsr_int8_ref, pack_bsr_int8_operands
    from repro_torch.sparse_weights.conv import conv2d_bsr, pack_bsr_operands

    stride = unit.conv.stride
    label = f"conv{unit.index + 1} x{tuple(xp.shape)} w{tuple(w.shape)}"
    if int8:
        h, at, sh, sa, ids, cnt, launch, _, _ = pack_bsr_int8_operands(xp, w, stride)
        name = "bsr_matmul_int8"
    else:
        h, at, ids, cnt, launch, _, _ = pack_bsr_operands(xp, w, stride)
        name = "bsr_matmul"
    blk = (launch.bt, launch.bf)

    def kernel():
        if int8:
            return bsr_matmul_int8(h, at, sh, sa, ids, cnt, block=blk)
        return bsr_matmul(h, at, ids, cnt, block=blk)

    def plain():
        if int8:
            return bsr_matmul_int8_plain(h, at, sh, sa, ids, cnt, block=blk)
        return bsr_matmul_plain(h, at, ids, cnt, block=blk)

    got = kernel()
    torch.cuda.synchronize()
    if int8:
        book.exact(name, label, got, plain())
        book.check(name + " op", label + " vs int8 oracle",
                   conv2d_bsr_int8(xp, w, stride), conv2d_bsr_int8_ref(xp, w, stride))
    else:
        book.check(name, label, got, plain())
        book.check(name + " op", label + " vs cuDNN", conv2d_bsr(xp, w, stride),
                   F.conv2d(xp, w, stride=stride))
    if not timed:
        return
    # the dense operands padded as the reference pads them: rows and taps to
    # block multiples, patches to a multiple of 128
    t_pad, f_pad, d_pad = (-launch.t) % launch.bt, (-launch.f) % launch.bf, (-launch.d) % 128
    hp = F.pad(h, (0, f_pad, 0, t_pad))
    atp = F.pad(at, (0, d_pad, 0, f_pad))
    if int8:
        shp = F.pad(sh, (0, 0, 0, t_pad), value=1.0)

        def library():
            return (torch._int_mm(hp, atp).float() * shp) * sa
    else:
        def library():
            return torch.matmul(hp, atp)

    t = device_times({"kernel": kernel, "plain": plain, "library": library})
    # the fp32 bound at the rate of the kernel's arithmetic (split-TF32), and
    # at the CUDA cores' fp32 rate beside it
    ft, bt = bsr_bound(h, at.shape[1], ids, cnt, blk, elem_bytes=1 if int8 else 4,
                       peak=PEAK_INT8_OPS if int8 else PEAK_TF32_SPLIT_FLOPS)
    meta = {"block": list(blk), "live_blocks": int(cnt.clamp(min=0).sum()),
            "blocks": launch.nt * launch.nf, "t_f_d": [launch.t, launch.f, launch.d],
            "cnt": cnt.tolist(), **t["eager"]}
    if not int8:
        meta["fp32_core_bound_ms"] = max(ft * PEAK_TF32_SPLIT_FLOPS / PEAK_FP32_FLOPS, bt)
    book.rows.append(_row(name, unit, xp, w, t, ft, bt, meta))
    _print_times(f"live {meta['live_blocks']}/{meta['blocks']} blocks", t, ft, bt)


def edge_cases_bsr_tf32(book, dev):
    """The split-TF32 BSR kernel's own paths against the plain version (fp32
    limit), each launch counted and every cnt = 0 row-block all zeros: every
    block width 8-128 at density 0.3 with schedules that differ per
    row-block (row-block 0 fully pruned), in grids of 8 and 2 row-blocks per
    block; F = 25 and 27 with T = 70 and ragged P; the conv probe lowered as
    BSR (K = 4608, every block scheduled), uniform and with x and w spread
    over 2^+-12, where one TF32 product per multiply-add fails the limit;
    operands off 16-byte alignment (4-byte copies); 525 row-blocks (a large
    T: the most counts any launch here ranks)."""
    import numpy as np
    import torch

    from repro_torch.core.sparsity import patches_t
    from repro_torch.kernels.bsr_matmul.kernel import bsr_matmul, bsr_matmul_plain
    from repro_torch.kernels.bsr_matmul.ops import block_schedule

    rng = np.random.default_rng(17)

    def run(label, h, w, ids, cnt, bf):
        before = bsr_matmul.launches
        got = bsr_matmul(h, w, ids, cnt, block=(8, bf))
        torch.cuda.synchronize()
        if bsr_matmul.launches != before + 1:
            raise AssertionError(f"{label}: the launch was not counted once")
        book.check("bsr_matmul", label, got, bsr_matmul_plain(h, w, ids, cnt, block=(8, bf)))
        for i in (cnt == 0).nonzero().flatten().tolist():
            if bool(torch.any(got[8 * i:8 * i + 8] != 0)):
                raise AssertionError(f"{label}: the cnt = 0 row-block {i} is not all zeros")

    def pruned(t, f, d, bf, density):
        nt, nf = -(-t // 8), -(-f // bf)
        keep = rng.random((nt, nf)) < density
        keep[0] = False
        mask = np.repeat(np.repeat(keep, 8, 0), bf, 1)[:t, :f]
        h = torch.from_numpy((rng.standard_normal((t, f)) * mask).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.random((f, d), dtype=np.float32)).to(dev)
        ids, cnt = block_schedule(h, 8, bf)
        return h, w, ids.contiguous(), cnt.contiguous()

    for bf in (8, 16, 32, 64, 128):
        for t, f, d in ((70, 25, 1001), (70, 27, 1002), (256, 1152, 2048),
                        (256, 1152, 34816)):
            run(f"T={t} F={f} P={d} bf={bf} density 0.3", *pruned(t, f, d, bf, 0.3), bf)
    for kind in ("uniform", "wide"):
        x, w = tf32_probe_operands(kind)
        at, _, _ = patches_t(x.permute(0, 3, 1, 2), 3, 3)
        h = w.permute(3, 2, 0, 1).reshape(64, -1).contiguous()
        ids, cnt = block_schedule(h, 8, 128)
        label = ("x and w over 2^+-12, K=4608" if kind == "wide"
                 else "conv probe, K=4608")
        run(label, h.to(dev), at.contiguous().to(dev), ids.to(dev), cnt.to(dev), 128)

    def misaligned(t):  # the same values, 4 bytes past a 16-byte boundary
        buf = torch.empty(t.numel() + 4, device=dev)
        v = buf[1:1 + t.numel()].view(t.shape)
        v.copy_(t)
        return v

    h, w, ids, cnt = pruned(40, 512, 1000, 128, 0.5)
    run("h and w off 16-byte alignment", misaligned(h), misaligned(w), ids, cnt, 128)
    run("T=4200 (525 row-blocks) F=128 P=300 bf=16", *pruned(4200, 128, 300, 16, 0.3), 16)


def edge_cases_new(book, dev):
    """The BSR and int8 kernels at shapes and values the served VGG-19 does
    not reach: ragged K/O/P, an all-pruned row-block (cnt = 0), stride 4
    with k 11, k 5 with pad 0, an int8 cnt = 0 pad sample, and int8 values
    at +-127 over VGG-19's longest reduction (512 * 3 * 3 = 4608 taps)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.graph.ir import ConvSpec, ConvUnit
    from repro_torch.kernels.bsr_matmul.ops import block_schedule
    from repro_torch.quant.kernels import (
        bsr_matmul_int8,
        bsr_matmul_int8_plain,
        ecr_conv_int8_batch,
        ecr_conv_int8_plain,
    )
    from repro_torch.sparse_weights.format import conv_weight_matrix, weight_block
    from repro_torch.sparse_weights.prune import prune_matrix

    cases = [  # (c, h, o, k, stride, pad)
        (3, 30, 64, 3, 1, 1),       # K = 27 (VGG-19 conv1_1), ragged P
        (1, 32, 6, 5, 1, 0),        # LeNet-5 conv1: O = 6, K = 25, k 5 pad 0
        (3, 224, 64, 11, 4, 2),     # AlexNet conv1: stride 4, k 11, K = 363
        (64, 27, 192, 5, 1, 2),     # AlexNet conv2: k 5
        (20, 15, 70, 3, 2, 1),      # ragged O and C at stride 2
    ]
    rng = np.random.default_rng(11)
    for i, (c, h, o, k, s, pad) in enumerate(cases):
        x = rng.random((3, c, h, h), dtype=np.float32)
        x *= rng.random((3, c, 1, 1)) > 0.4
        x[-1] = 0.0  # the batcher's all-zero pad sample
        w = rng.standard_normal((o, c, k, k)).astype(np.float32) / (c * k * k) ** 0.5
        wt = torch.from_numpy(w).to(dev)
        m = conv_weight_matrix(wt)
        m = prune_matrix(m, PRUNE_DENSITY, weight_block(*m.shape))[0]
        m[:8] = 0.0  # an all-pruned row-block: cnt = 0
        wt = m.reshape(wt.shape).contiguous()
        spec = ConvSpec(o, k=k, stride=s, pad=pad)
        oh = (h + 2 * pad - k) // s + 1
        unit = ConvUnit(index=200 + i, stage=0, slot=0, conv=spec, relu=True,
                        pool=None, in_shape=(c, h, h), out_shape=(o, oh, oh))
        xp = F.pad(torch.from_numpy(x).to(dev), (pad,) * 4)
        check_bsr_layer(book, unit, xp, wt, int8=False, timed=False)
        check_bsr_layer(book, unit, xp, wt, int8=True, timed=False)
        check_ecr_int8_layer(book, unit, xp, wt, timed=False)

    # int8 extremes: every product is 127 * 127, summed over 4608 taps
    taps = 512 * 9
    h8 = torch.full((16, taps), 127, dtype=torch.int8, device=dev)
    h8[8:] = -127
    w8 = torch.full((taps, 300), 127, dtype=torch.int8, device=dev)
    ids, cnt = block_schedule(h8, 8, 128)
    one16, one = torch.ones(16, device=dev), torch.ones(1, device=dev)
    got = bsr_matmul_int8(h8, w8, one16, one, ids, cnt, block=(8, 128))
    book.exact("bsr_matmul_int8", "+-127 over K=4608", got,
               bsr_matmul_int8_plain(h8, w8, one16, one, ids, cnt, block=(8, 128)))
    if not (torch.all(got[:8] == 127 * 127 * taps) and torch.all(got[8:] == -127 * 127 * taps)):
        raise AssertionError("bsr_matmul_int8 extremes are not exact")
    x8 = torch.full((2, 16, 16, 512), 127, dtype=torch.int8, device=dev)
    x8[1] = 0  # a cnt = 0 pad sample
    w8 = torch.full((3, 3, 512, 64), -127, dtype=torch.int8, device=dev)
    ids = torch.arange(64, dtype=torch.int32, device=dev).repeat(2, 1).contiguous()
    cnt = torch.tensor([64, 0], dtype=torch.int32, device=dev)
    ones2, ones64 = torch.ones(2, device=dev), torch.ones(64, device=dev)
    got = ecr_conv_int8_batch(x8, w8, ones2, ones64, ids, cnt, stride=1, block_c=8)
    book.exact("ecr_conv_int8", "+-127 over C*kh*kw=4608, a cnt=0 sample", got,
               ecr_conv_int8_plain(x8, w8, ones2, ones64, ids, cnt, stride=1, block_c=8))
    if not (torch.all(got[0] == -127 * 127 * taps) and torch.all(got[1] == 0)):
        raise AssertionError("ecr_conv_int8 extremes are not exact")


def edge_cases_int8_tc(book, dev):
    """The int8 tensor-core kernels' own paths, bitwise against the plain
    versions: ECR schedules that leave 1, 2 or 3 blocks of a 32-channel
    step, cnt = n_cb, cnt = 0 and ids out of order at block_c 4, 8 and 16
    and O not a multiple of 128; N=1 at VGG-19 conv13's shape (a grid of 8
    blocks); BSR at block widths 8-128 with F = 25 and 27, T = 70, ragged P
    and density 0.3 (schedules differ per row-block, row-block 0 fully
    pruned), in grids that take 2 and 8 row-blocks per block."""
    import numpy as np
    import torch

    from repro_torch.kernels.bsr_matmul.ops import block_schedule
    from repro_torch.quant.kernels import (
        bsr_matmul_int8,
        bsr_matmul_int8_plain,
        ecr_conv_int8_batch,
        ecr_conv_int8_plain,
    )

    rng = np.random.default_rng(15)

    def i8(shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)

    def scales(n):
        return torch.from_numpy(rng.random(n).astype(np.float32) * 1e-2 + 1e-4).to(dev)

    cnts = [1, 2, 3, 8, 0, 5]
    for bc, o in ((8, 96), (8, 70), (16, 128), (4, 64)):
        x, w = i8((len(cnts), 13, 19, 8 * bc)), i8((3, 3, 8 * bc, o))
        ids = torch.from_numpy(np.stack([rng.permutation(8) for _ in cnts])
                               .astype(np.int32)).to(dev)
        cnt = torch.tensor(cnts, dtype=torch.int32, device=dev)
        args = (x, w, scales(len(cnts)), scales(o), ids, cnt)
        book.exact("ecr_conv_int8", f"cnt {cnts}, ids permuted, block_c {bc}, O={o}",
                   ecr_conv_int8_batch(*args, stride=1, block_c=bc),
                   ecr_conv_int8_plain(*args, stride=1, block_c=bc))
    x, w = i8((1, 16, 16, 512)), i8((3, 3, 512, 512))
    x[..., 36 * 8:] = 0
    ids = torch.arange(64, dtype=torch.int32, device=dev)[None].contiguous()
    args = (x, w, scales(1), scales(512), ids, torch.tensor([36], dtype=torch.int32,
                                                            device=dev))
    book.exact("ecr_conv_int8_n1", "N=1 conv13 shape, 36/64 blocks",
               ecr_conv_int8_batch(*args, stride=1, block_c=8),
               ecr_conv_int8_plain(*args, stride=1, block_c=8))

    for bf in (8, 16, 32, 64, 128):
        for t, f, d in ((70, 25, 1001), (70, 27, 1002), (256, 1152, 2048),
                        (256, 1152, 34816)):
            nt, nf = -(-t // 8), -(-f // bf)
            keep = rng.random((nt, nf)) < 0.3
            keep[0] = False
            mask = np.repeat(np.repeat(keep, 8, 0), bf, 1)[:t, :f]
            h = i8((t, f)) * torch.from_numpy(mask.astype(np.int8)).to(dev)
            ids, cnt = block_schedule(h, 8, bf)
            args = (h, i8((f, d)), scales(t), scales(1), ids.contiguous(), cnt.contiguous())
            book.exact("bsr_matmul_int8", f"T={t} F={f} P={d} bf={bf} density 0.3",
                       bsr_matmul_int8(*args, block=(8, bf)),
                       bsr_matmul_int8_plain(*args, block=(8, bf)))


def tf32_probe_operands(kind: str, seed: int = 0):
    """A conv with VGG-19 conv10's reduction (3x3x512 = 4,608 terms) over
    16x16 positions and 64 output channels: x uniform on [0, 1) and w normal
    over sqrt(K) ("uniform"), or both scaled elementwise by 2^e, e uniform
    over -12..12 ("wide"). The same operands as the host's
    tests/test_torch_kernels.py, which shows that one TF32 product per
    multiply-add fails the fp32 limit on them and split-TF32 holds it."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = rng.random((1, 18, 18, 512), dtype=np.float32)
    w = (rng.standard_normal((3, 3, 512, 64)) / np.sqrt(4608)).astype(np.float32)
    if kind == "wide":
        x = (x * np.exp2(rng.integers(-12, 13, x.shape))).astype(np.float32)
        w = (w * np.exp2(rng.integers(-12, 13, w.shape))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def edge_cases_tf32(book, dev):
    """The split-TF32 ECR / PECR kernel's own paths against the plain
    versions (fp32 limit), each launch counted and every cnt = 0 sample all
    zeros: schedules that leave half an 8-channel k-step (block_c 4), two
    k-steps per block (block_c 16), cnt = n_cb, cnt = 0 and ids out of order,
    O not a multiple of the tile; N=1 at VGG-19 conv13's shape (36 of 64
    blocks, the kernel's smallest served grid); the served conv10 and conv12
    shapes at batch 8; an input spread over 2^+-12 at K = 4608, where one
    TF32 product per multiply-add fails the limit; operands off 16-byte
    alignment (plain loads instead of cp.async)."""
    import numpy as np
    import torch

    from repro_torch.kernels.conv_pool.kernel import conv_pool_batch, conv_pool_plain
    from repro_torch.kernels.ecr_conv.kernel import ecr_conv_batch, ecr_conv_plain

    rng = np.random.default_rng(16)

    def operands(n, h, w_, c, o):
        x = torch.from_numpy(rng.random((n, h, w_, c), dtype=np.float32)).to(dev)
        w = rng.standard_normal((3, 3, c, o)) / np.sqrt(9 * c)
        return x, torch.from_numpy(w.astype(np.float32)).to(dev)

    def schedule(cnts, n_cb, permuted=True):
        order = [rng.permutation(n_cb) if permuted else np.arange(n_cb) for _ in cnts]
        return (torch.from_numpy(np.stack(order).astype(np.int32)).to(dev),
                torch.tensor(cnts, dtype=torch.int32, device=dev))

    def run(label, x, w, ids, cnt, *, bc, pool=0):
        wrapper = conv_pool_batch if pool else ecr_conv_batch
        before = wrapper.launches
        if pool:
            got = conv_pool_batch(x, w, ids, cnt, stride=1, pool=pool, block_c=bc)
            want = conv_pool_plain(x, w, ids, cnt, stride=1, pool=pool, block_c=bc)
        else:
            got = ecr_conv_batch(x, w, ids, cnt, stride=1, block_c=bc)
            want = ecr_conv_plain(x, w, ids, cnt, stride=1, block_c=bc)
        torch.cuda.synchronize()
        if wrapper.launches != before + 1:
            raise AssertionError(f"{label}: the launch was not counted once")
        book.check("conv_pool" if pool else "ecr_conv", label, got, want)
        for b in (cnt == 0).nonzero().flatten().tolist():
            if bool(torch.any(got[b] != 0)):
                raise AssertionError(f"{label}: the cnt = 0 sample {b} is not all zeros")

    cnts = [1, 2, 3, 8, 0, 5]
    for bc, o, pool in ((8, 96, 0), (8, 70, 2), (16, 128, 0), (4, 64, 2), (4, 70, 0),
                        (16, 64, 2)):
        x, w = operands(len(cnts), 13, 19, 8 * bc, o)
        ids, cnt = schedule(cnts, 8)
        run(f"cnt {cnts}, ids permuted, block_c {bc}, O={o}, pool {pool}", x, w, ids, cnt,
            bc=bc, pool=pool)
    x, w = operands(1, 16, 16, 512, 512)
    x[..., 36 * 8:] = 0.0
    ids, cnt = schedule([36], 64, permuted=False)
    run("N=1 conv13 shape, 36/64 blocks", x, w, ids, cnt, bc=8)
    x, w = operands(8, 30, 30, 512, 512)
    x[-1] = 0.0
    ids, cnt = schedule([42] * 7 + [0], 64)
    run("conv10 shape, batch 8, 42/64 blocks", x, w, ids, cnt, bc=8)
    run("conv12 shape, batch 8, 42/64 blocks, pool 2", x, w, ids, cnt, bc=8, pool=2)
    x, w = (t.to(dev) for t in tf32_probe_operands("wide"))
    ids, cnt = schedule([64], 64, permuted=False)
    run("x and w over 2^+-12, K=4608", x, w, ids, cnt, bc=8)
    x, w = operands(3, 12, 12, 32, 64)

    def misaligned(t):  # the same values, 4 bytes past a 16-byte boundary
        buf = torch.empty(t.numel() + 4, device=dev)
        v = buf[1:1 + t.numel()].view(t.shape)
        v.copy_(t)
        return v

    ids, cnt = schedule([4, 0, 2], 4)
    run("x and w off 16-byte alignment", misaligned(x), misaligned(w), ids, cnt, bc=8)
    run("x and w off 16-byte alignment, pool 2", misaligned(x), misaligned(w), ids, cnt,
        bc=8, pool=2)


def sass_counts(lib_path) -> dict:
    """{kernel symbol: {opcode: count}} of the built library's SASS
    (cuobjdump -sass from the toolkit that built it)."""
    import re

    from repro_torch.kernels.cuda import nvcc_path

    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    r = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {r.stderr.strip()}")
    counts, fn = {}, None
    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {}
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if m and fn:
            counts[fn][m.group(1)] = counts[fn].get(m.group(1), 0) + 1
    return counts


def ptxas_usage(text: str) -> dict:
    """{kernel symbol: {"registers", "stack", "spill_stores", "spill_loads"}}
    from nvcc's `-Xptxas -v` report in the build's output: registers per
    thread, stack frame bytes, and the bytes of registers spilled to it."""
    import re

    usage, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            usage[fn] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                      r"spill loads", line)
        if m and fn:
            usage[fn].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn]["registers"] = int(m.group(1))
            fn = None
    return usage


def kernel_category(name: str) -> str:
    """Coarse class of a CUDA kernel by its symbol name."""
    for stem, cat in (("flash_mla_kernel", "flash MLA kernel"),
                      ("flash_mla_combine_kernel", "flash MLA kernel"),
                      ("mla_bwd_dq_kernel", "flash MLA bwd dq kernel"),
                      ("mla_bwd_dkv", "flash MLA bwd dkv kernel"),
                      ("selective_scan_kernel", "selective scan kernel"),
                      ("selective_scan_bwd_kernel", "selective scan bwd kernel"),
                      ("scan_bwd_reduce", "selective scan bwd kernel"),
                      ("flash_bwd_dq_bf16_kernel", "flash bwd dq bf16 kernel"),
                      ("flash_bwd_dkv_bf16_kernel", "flash bwd dk/dv bf16 kernel"),
                      ("flash_fwd_bf16_kernel", "flash bf16 kernel")):
        if stem in name:
            return cat
    if "flash_bwd_dq_kernel" in name:
        return "flash bwd dq kernel"
    if "flash_bwd_dkv_kernel" in name:
        return "flash bwd dk/dv kernel"
    if "flash_fwd_q8_kernel" in name:
        return "flash q8 kernel"
    if "flash_fwd_kernel" in name:
        return "flash kernel"
    if "bsr_matmul_i8_kernel" in name:
        return "bsr int8 kernel"
    if "ecr_conv_i8_kernel" in name:
        return "ecr int8 kernel"
    if "bsr_matmul_kernel" in name:
        return "bsr kernel"
    if "ecr_conv_kernel" in name:
        return "pecr kernel" if "Lb1E" in name or "true>" in name else "ecr kernel"
    low = name.lower()
    if any(t in low for t in ("cudnn", "xmma", "conv", "gemm", "cutlass", "nvjet")):
        return "cuDNN/cuBLAS (dense convs, head, LM matmuls)"
    if "sort" in low or "radix" in low:
        return "argsort (compaction)"
    if "im2col" in low:
        return "im2col (BSR patches)"
    return "other (pad/permute/gather/relu/pool/occupancy/quantize)"


def trace_breakdown(fn, extra=None) -> dict:
    """Host wall time of `fn` (median of 5, synchronised, after 2 warm-up
    runs) and a torch.profiler trace of one more run, summed by kernel class.
    The device idle share is 1 - device time / wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls)[2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0.0)
        kernels[e.key] = (kernels.get(e.key, (0.0, 0))[0] + us, e.count)
    cats = {}
    for name, (us, _) in kernels.items():
        cats[kernel_category(name)] = cats.get(kernel_category(name), 0.0) + us / 1e3
    device_ms = sum(cats.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    names = {}
    for name, (_, n) in kernels.items():
        names.setdefault(kernel_category(name), {})[name[:160]] = n
    out = {"wall_ms": wall_ms, "walls_ms": walls, "device_ms": device_ms,
           "device_ops": sum(n for _, n in kernels.values()),
           "idle_share": max(0.0, 1.0 - device_ms / wall_ms) if device_ms else None,
           "by_class_ms": cats, "kernels_by_class": names,
           "top_kernels": [{"name": k[:120], "ms": v[0] / 1e3, "count": v[1]}
                           for k, v in top]}
    out.update(extra or {})
    return out


def service_breakdown(eng, imgs) -> dict:
    """One warm batch through the engine's captured runner for its bucket
    (`trace_breakdown` of a replay: copy in, replay, clones out), with the
    same batch through eager `run_plan` (which verifies the plan on every
    call) beside it under "eager"."""
    from repro_torch.pipeline import run_plan

    n = imgs.shape[0]
    runner = eng._executable(n)
    eager = trace_breakdown(
        lambda: run_plan(eng.plan, eng.params, imgs, collect_occupancy=True, n_valid=n),
        {"batch": n})
    return trace_breakdown(lambda: runner(eng.params, imgs, n),
                           {"batch": n, "route": "CUDA-graph replay", "eager": eager})


def print_service(name, svc) -> None:
    """The graph and eager breakdowns of `service_breakdown`, by class."""
    ev = svc["eager"]
    print(f"{name} warm batch-{svc['batch']} service, CUDA-graph replay: wall "
          f"{svc['wall_ms']:.2f} ms (median of 5), device {svc['device_ms']:.2f} ms, "
          f"idle share {svc['idle_share']}; eager run_plan: wall {ev['wall_ms']:.2f} ms, "
          f"device {ev['device_ms']:.2f} ms, idle share {ev['idle_share']}")
    for label, b in (("graph", svc), ("eager", ev)):
        for cat, ms in sorted(b["by_class_ms"].items(), key=lambda kv: -kv[1]):
            print(f"  {label} {ms:8.3f} ms  {cat}")


def make_params(graph, *, seed, dev, prune_density=1.0):
    """Random weights from generator `seed` with the dead filters shifted,
    optionally block-pruned (the calibration batch as probe), and the 2
    calibration images. Returns (params, calib, prune report or None)."""
    import torch

    from repro_torch.graph import init_graph
    from repro_torch.launch.serve_cnn import synth_requests
    from repro_torch.models.cnn import shift_dead_channels
    from repro_torch.sparse_weights.prune import prune_graph_params

    params = shift_dead_channels(init_graph(torch.Generator().manual_seed(seed),
                                            graph, device=dev))
    calib = torch.stack(synth_requests(graph, 2, seed=seed + 1, device=dev))
    report = None
    if prune_density < 1.0:
        params, report = prune_graph_params(params, prune_density, graph, probe=calib)
    return params, calib, report


def serve(graph, n_requests, *, seed, dev, prune_density=1.0, int8=False,
          int8_budget=0.98):
    """An Engine over `make_params`' weights, planned on its 2 calibration
    images, and its request images. Returns (engine, params, imgs, planning
    seconds, clock, prune report)."""
    from repro_torch.launch.serve_cnn import synth_requests
    from repro_torch.serving import Engine, SimClock

    params, calib, report = make_params(graph, seed=seed, dev=dev,
                                        prune_density=prune_density)
    clock = SimClock()
    t0 = time.perf_counter()
    eng = Engine(params, graph=graph, calib=calib, occ_threshold=0.75,
                 block_c=8, max_batch=8, clock=clock, int8=int8,
                 int8_budget=int8_budget, device=dev)
    plan_s = time.perf_counter() - t0
    eng.warmup()
    imgs = synth_requests(graph, n_requests, seed=seed + 2, device=dev)
    return eng, params, imgs, plan_s, clock, report


def plan_line(plan) -> str:
    return " ".join(f"conv{lp.index + 1}={lp.impl}@{lp.occupancy:.2f}"
                    for lp in plan.layers)


def reset_counts(wrappers, *engines) -> None:
    """Every count to 0: the wrappers' own and, for each engine, the
    launches its runners' replays stand for."""
    for fn in wrappers.values():
        fn.launches = 0
    for eng in engines:
        eng.cache.graphs.replay_launches.clear()


def read_counts(wrappers, *engines) -> dict:
    """Launches per kernel since `reset_counts`: the wrappers' counts (eager
    calls, and a runner's warm-up and capture) plus, for each engine, its
    runners' launches per replay (recorded while capturing) times their
    replays."""
    out = {k: fn.launches for k, fn in wrappers.items()}
    for eng in engines:
        replayed = eng.cache.graphs.replay_launches
        for k, fn in wrappers.items():
            out[k] += replayed.get(fn.__name__, 0)
    return out


def variant_phase(name, graph, dev, wrappers, failures, *, prune_density,
                  int8, want):
    """One served VGG-19 variant (pruned and/or int8): plan, counters to 0,
    16 requests, counters read; `want` is the wrapper that must have
    launched. Returns (engine plan, params, request batch, launches,
    summary) for the kernel checks."""
    import numpy as np
    import torch

    from repro_torch.graph import run_graph
    from repro_torch.pipeline import plan_network, run_plan
    from repro_torch.serving import replay_stream

    budget = 0.98
    if int8:
        # plan once at the default budget, to show what the probe does
        p0, calib0, _ = make_params(graph, seed=0, dev=dev, prune_density=prune_density)
        t0 = time.perf_counter()
        probed = plan_network(p0, calib0, graph, occ_threshold=0.75, block_c=8,
                              int8=True, int8_budget=0.98)
        rep = probed.int8_report
        print(f"{name} int8 probe at int8_budget=0.98 ({time.perf_counter() - t0:.2f} s): "
              f"{len(rep.layers)} layers kept {list(rep.layers)}, {len(rep.demoted)} "
              f"demoted {list(rep.demoted)}, top-1 agreement {rep.top1_agreement:.3f}, "
              f"max logit drift {rep.max_logit_drift:.3e}; plan {plan_line(probed)}")
        verify_built(f"{name} probed at int8_budget=0.98", probed, p0, 2, failures)
        del p0, calib0, probed
        budget = 0.0
    eng, params, imgs, plan_s, clock, prep = serve(
        graph, 16, seed=0, dev=dev, prune_density=prune_density, int8=int8,
        int8_budget=budget)
    plan = eng.plan
    if prep is not None:
        print(f"{name} pruned to {prep.density:.4f} achieved block density (target "
              f"{prune_density}): probe max logit drift {prep.max_logit_drift:.3e}, "
              f"top-1 agreement {prep.top1_agreement:.2f}")
    served_at = f" (served at int8_budget={budget})" if int8 else ""
    print(f"{name} plan ({plan_s:.2f} s){served_at}: {plan_line(plan)}")
    print(f"{name} plan counts: {plan.counts()}")
    verify_built(name, plan, params, 8, failures)
    captures = eng.stats()["captures"]
    reset_counts(wrappers, eng)
    t_start = clock()
    wall0 = time.perf_counter()
    results = replay_stream(eng, imgs, rate_rps=1000.0)
    wall = time.perf_counter() - wall0
    launches = read_counts(wrappers, eng)
    makespan = clock() - t_start
    stats = eng.stats()
    print(f"{name} served {len(results)} requests: launches {launches} (all by "
          f"CUDA-graph replay: eager {read_counts(wrappers)}), {stats['batches']} "
          f"batches, {stats['captures'] - captures} captures while serving "
          f"({stats['batch_builds']} by a batch), throughput "
          f"{len(results) / makespan:.1f} req/s (SimClock, measured service), "
          f"p50={stats['p50_ms']:.2f} ms p95={stats['p95_ms']:.2f} ms, host wall {wall:.2f} s")
    if launches[want] < 1:
        failures.append(f"{name}: {want} never launched on the served path: {launches}")
    if stats["batch_builds"]:
        failures.append(f"{name}: a served batch built (captured) its own runner")
    served = np.stack([r.logits for r in sorted(results, key=lambda r: r.id)])
    batch = torch.stack(imgs)
    dense = run_graph(graph, params, batch, "dense").cpu().numpy()
    scale = float(np.abs(dense).max())
    err = float(np.abs(served - dense).max())
    if not np.all(np.isfinite(served)) or served.shape != (16, 1000):
        failures.append(f"{name}: served logits not finite or of the wrong shape")
    if int8:
        agree = float((served.argmax(-1) == dense.argmax(-1)).mean())
        print(f"{name} served logits vs the fp32 dense path: top-1 agreement "
              f"{agree:.3f}, max drift {err:.3e} (max|dense|={scale:.3e})")
        ref8 = run_plan(plan, params, batch[:8]).cpu().numpy()
        same = bool(np.array_equal(served[:8], ref8))
        print(f"{name} engine logits bitwise equal to run_plan on the same 8-bucket: "
              f"{same} (max diff {float(np.abs(served[:8] - ref8).max()):.3e})")
        if not same:
            failures.append(f"{name}: engine logits differ from run_plan on its bucket")
    else:
        ok = np.allclose(served, dense, rtol=1e-3, atol=1e-3 * scale)
        print(f"{name} engine vs dense cuDNN on the pruned weights: max_abs_err={err:.3e} "
              f"(max|dense|={scale:.3e}, rtol=1e-3, atol=1e-3*max|dense|): "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name}: engine logits disagree with the dense path")
    cost = verify_cost(name, plan, params, batch[:8])
    summary = {"plan": plan_line(plan), "counts": plan.counts(), "launches": launches,
               "verify": cost,
               "p50_ms": stats["p50_ms"], "p95_ms": stats["p95_ms"],
               "throughput_rps": len(results) / makespan, "max_abs_vs_dense": err,
               "max_abs_dense": scale,
               "prune_density": None if prep is None else prep.density}
    svc = service_breakdown(eng, batch[:8])
    return plan, params, batch, launches, summary, svc


def variant_kernel_checks(book, plan, params, batch, failures, name):
    """Every layer of a variant plan at its real input (batch 8): the new
    kernels checked and timed, the ECR / PECR layers checked. Rows are
    tagged with the phase."""
    from repro_torch.graph import pad2d, run_unit

    x = batch[:8]
    first = len(book.rows)
    for lp, w in zip(plan.layers, params["conv"]):
        unit = lp.to_unit()
        xp = pad2d(x, unit.conv.pad)
        try:
            if lp.impl in ("bsr", "bsr_int8"):
                check_bsr_layer(book, unit, xp, w, int8=lp.impl == "bsr_int8",
                                timed=True)
            elif lp.impl == "ecr_int8":
                check_ecr_int8_layer(book, unit, xp, w, timed=True)
            elif lp.impl in ("ecr_pallas", "pecr_pallas"):
                pool = unit.pool.p if lp.kind == "conv_pool" else 0
                check_layer_kernels(book, unit, lp.kind, xp, w, pool, timed=False)
        except Exception:
            traceback.print_exc()
            failures.append(f"{name}: kernel check failed at conv{unit.index + 1}")
        x = run_unit(x, w, unit, "conv", "dense")
    for row in book.rows[first:]:
        row["phase"] = name


OBS_BATCH = 8  # the obs phase profiles, searches and plans on 8 images


def check_geometry(book, unit, kind, impl, xp, w, tile):
    """The kernel of (kind, impl) at one searched geometry `tile` against
    its plain version on the layer's real input: fp32 within the limit,
    int8 bitwise."""
    import torch

    from repro_torch.graph.registry import unit_launch
    from repro_torch.kernels.bsr_matmul.kernel import bsr_matmul, bsr_matmul_plain
    from repro_torch.kernels.conv_pool.kernel import conv_pool_batch, conv_pool_plain
    from repro_torch.kernels.ecr_conv.kernel import ecr_conv_batch, ecr_conv_plain
    from repro_torch.kernels.ecr_conv.ops import pack_operands
    from repro_torch.kernels.tiles import resolve_block_o
    from repro_torch.quant.kernels import (
        bsr_matmul_int8,
        bsr_matmul_int8_plain,
        ecr_conv_int8_batch,
        ecr_conv_int8_plain,
    )
    from repro_torch.quant.ops import pack_bsr_int8_operands, pack_int8_operands
    from repro_torch.sparse_weights.conv import pack_bsr_operands

    stride = unit.conv.stride
    label = f"conv{unit.index + 1} tile {tuple(tile.key()) if tile else 'default'}"
    if impl in ("bsr", "bsr_int8"):
        if impl == "bsr_int8":
            h, at, sh, sa, ids, cnt, launch, _, _ = pack_bsr_int8_operands(xp, w, stride, tile)
            blk = (launch.bt, launch.bf)
            got = bsr_matmul_int8(h, at, sh, sa, ids, cnt, block=blk)
            torch.cuda.synchronize()
            book.exact("bsr_matmul_int8", label + f" bf={blk[1]}", got,
                       bsr_matmul_int8_plain(h, at, sh, sa, ids, cnt, block=blk))
        else:
            h, at, ids, cnt, launch, _, _ = pack_bsr_operands(xp, w, stride, tile)
            blk = (launch.bt, launch.bf)
            got = bsr_matmul(h, at, ids, cnt, block=blk)
            torch.cuda.synchronize()
            book.check("bsr_matmul", label + f" bf={blk[1]}", got,
                       bsr_matmul_plain(h, at, ids, cnt, block=blk))
        return
    # block_c 0 as the search runs it: the default geometry is the auto block
    launch = unit_launch(kind, impl, unit, tile=tile, block_c=0, batch=xp.shape[0])
    bc, bo = launch.block_c, resolve_block_o(unit.conv.c_out, tile.block_o)
    if impl == "ecr_int8":
        packed = pack_int8_operands(xp, w, launch)
        got = ecr_conv_int8_batch(*packed, stride=stride, block_c=bc)
        torch.cuda.synchronize()
        book.exact("ecr_conv_int8", label + f" bc={bc}", got,
                   ecr_conv_int8_plain(*packed, stride=stride, block_c=bc))
        return
    packed = pack_operands(xp, w, launch)
    if kind == "conv_pool":
        pool = unit.pool.p
        got = conv_pool_batch(*packed, stride=stride, pool=pool, block_c=bc, block_o=bo)
        torch.cuda.synchronize()
        book.check("conv_pool", label + f" bc={bc} bo={bo}", got,
                   conv_pool_plain(*packed, stride=stride, pool=pool, block_c=bc))
    else:
        got = ecr_conv_batch(*packed, stride=stride, block_c=bc, block_o=bo)
        torch.cuda.synchronize()
        book.check("ecr_conv", label + f" bc={bc} bo={bo}", got,
                   ecr_conv_plain(*packed, stride=stride, block_c=bc))


def obs_variant(name, graph, dev, wrappers, book, failures, outdir, *, prune_density):
    """The measure -> calibrate -> search -> plan loop on one VGG-19 variant
    at batch 8: profile every layer per impl, fit a CalibrationDB, search
    the tile geometry of the occupancy-rule plan's kernel layers (every
    timed geometry's kernel held against its plain version), and serve 16
    requests through an Engine planned with the DB's constants and tiles,
    traced. The counters are set to 0 before the profile and read after the
    search (every kernel must have run there), then set to 0 again just
    before serving and read just after (every kernel of the served plan
    must have run, and the plan must hold one)."""
    import numpy as np
    import torch

    from repro_torch.graph import pad2d, run_graph, run_unit
    from repro_torch.graph.registry import get_op
    from repro_torch.launch.serve_cnn import synth_requests
    from repro_torch.obs import PROFILE_IMPLS, CalibrationDB, Tracer, profile_plan, tile_search
    from repro_torch.pipeline import plan_network
    from repro_torch.serving import Engine, SimClock, replay_stream

    t_phase = time.perf_counter()
    params, _, _ = make_params(graph, seed=0, dev=dev, prune_density=prune_density)
    calib = torch.stack(synth_requests(graph, OBS_BATCH, seed=1, device=dev))
    tracer = Tracer()
    base = plan_network(params, calib, graph, occ_threshold=0.75, block_c=8)
    impls = PROFILE_IMPLS + ("ecr_int8", "bsr_int8")
    reset_counts(wrappers)
    report = profile_plan(base, params, calib, impls=impls, iters=3, warmup=1,
                          tracer=tracer)
    cols = (("dense", "dense"), ("ECR", "ecr_pallas"), ("PECR", "pecr_pallas"),
            ("BSR", "bsr"), ("ECR int8", "ecr_int8"), ("BSR int8", "bsr_int8"))
    print(f"{name} obs profile (batch {report.batch}, block_c 8, {report.device_kind}; "
          f"host wall per layer call with a synchronize, median of 3, ms):")
    layers = {}
    for idx, rows in sorted(report.layers().items()):
        by = {t.impl: t for t in rows}
        t0 = rows[0]
        cells = " ".join(f"{lab} {by[impl].measured_us / 1e3:8.3f}" if impl in by
                         else f"{lab} {'-':>8s}" for lab, impl in cols)
        print(f"  conv{idx + 1:<2d} occ {t0.occupancy:.2f} wd {t0.weight_density:.2f}: {cells}")
        layers[f"conv{idx + 1}"] = {
            "occupancy": t0.occupancy, "weight_density": t0.weight_density,
            **{impl: {"ms": t.measured_us / 1e3, "predicted_ms": t.predicted_us / 1e3,
                      "spread": t.spread} for impl, t in by.items()}}
    db = CalibrationDB.from_report(report)
    scales = {f"{k}/{i}": e.scale for (_, k, i, _), e in sorted(db.entries.items())}
    print(f"{name} calibration (scale = median predicted/measured per (kind, impl); "
          f"agreement {report.agreement()} -> {report.recalibrated(db).agreement()}):")
    for key, sc in scales.items():
        e = next(e for (_, k, i, _), e in db.entries.items() if f"{k}/{i}" == key)
        print(f"  {key:24s} scale {sc:.4e} ({e.n_samples} layers, residual spread "
              f"{e.resid_spread:.3f})")
    calibrated = plan_network(params, calib, graph, occ_threshold=0.75, block_c=8,
                              calibration=db)
    print(f"{name} plan, datasheet constants: {plan_line(base)}")
    print(f"{name} plan, calibrated:          {plan_line(calibrated)}")
    verify_built(f"{name} obs plan", base, params, OBS_BATCH, failures)
    verify_built(f"{name} obs plan, calibrated", calibrated, params, OBS_BATCH, failures)
    ts, db = tile_search(base, params, calib, db=db, calibration=db, tracer=tracer)
    measured = read_counts(wrappers)
    print(f"{name} launches in the profile and the tile search: {measured}")
    for k, n in measured.items():
        if n < 1:
            failures.append(f"{name}: {k} never launched in the profile or the tile search")
    print(f"{name} tile search: {len(ts.improved_layers())}/{len(ts.layers)} layers "
          f"improved, floor holds: {ts.floor_holds()}")
    if not ts.floor_holds():
        failures.append(f"{name}: the tile search's floor does not hold")
    x = calib
    searched = []
    for lp, unit, w in zip(base.layers, graph.units(), params["conv"]):
        r = ts.layers[unit.index]
        if get_op(lp.kind, lp.impl).pallas:
            print(f"  conv{unit.index + 1:<2d} {lp.impl:12s} default {r.default.key} "
                  f"{r.default.measured_us / 1e3:.3f} ms -> winner {r.best.key} "
                  f"{r.best.measured_us / 1e3:.3f} ms ({sum(c.timed for c in r.candidates)} "
                  f"of {len(r.candidates)} timed)")
            searched.append(r.row())
            from repro_torch.kernels.tiles import TileConfig

            xp = pad2d(x, unit.conv.pad)
            for cd in r.candidates:
                if cd.timed:
                    check_geometry(book, unit, lp.kind, lp.impl, xp, w,
                                   TileConfig.from_key(cd.key))
        x = run_unit(x, w, unit, "conv", "dense")
    imgs = synth_requests(graph, 16, seed=2, device=dev)
    clock = SimClock()
    eng = Engine(params, graph=graph, calib=calib, occ_threshold=0.75, block_c=8,
                 max_batch=8, clock=clock, tracer=tracer, calibration=db, tiles=db,
                 device=dev)
    plan = eng.plan
    print(f"{name} served plan (calibration + tiles): {plan_line(plan)}")
    verify_built(f"{name} obs plan, calibrated and tile-stamped", plan, params, 8, failures)
    moved = [f"conv{a.index + 1}: {a.impl} -> {b.impl}"
             + (f" tile {b.tile.key()}" if b.tile else "")
             for a, b in zip(base.layers, plan.layers)
             if (a.kind, a.impl) != (b.kind, b.impl) or b.tile]
    print(f"{name} moved by calibration or tile search: {moved or 'none'}")
    eng.warmup()
    reset_counts(wrappers, eng)
    results = replay_stream(eng, imgs, rate_rps=1000.0)
    launches = read_counts(wrappers, eng)
    print(f"{name} served {len(results)} requests through the searched plan: "
          f"launches {launches} (CUDA-graph replays and any captures)")
    kernel_impls = {lp.impl for lp in plan.layers if get_op(lp.kind, lp.impl).pallas}
    want = {"ecr_pallas": "ecr_conv", "pecr_pallas": "conv_pool", "bsr": "bsr_matmul",
            "ecr_int8": "ecr_conv_int8", "bsr_int8": "bsr_matmul_int8"}
    if not kernel_impls:
        failures.append(f"{name}: the searched plan never reaches a CUDA kernel")
    for impl in kernel_impls:
        if launches[want[impl]] < 1:
            failures.append(f"{name}: {want[impl]} never launched on the searched plan")
    served = np.stack([r.logits for r in sorted(results, key=lambda r: r.id)])
    dense = run_graph(graph, params, torch.stack(imgs), "dense").cpu().numpy()
    scale = float(np.abs(dense).max())
    err = float(np.abs(served - dense).max())
    ok = bool(np.allclose(served, dense, rtol=1e-3, atol=1e-3 * scale)
              and np.all(np.isfinite(served)) and served.shape == (16, graph.n_classes()))
    print(f"{name} searched-plan engine vs dense cuDNN: max_abs_err={err:.3e} "
          f"(max|dense|={scale:.3e}, rtol=1e-3, atol=1e-3*max|dense|): "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{name}: searched-plan engine logits disagree with the dense path")
    spans = sorted({e["name"] for e in tracer.events})
    if outdir is not None:
        db.save(str(outdir / f"obs_calibration_{name}.json"))
        tracer.save(str(outdir / f"obs_trace_{name}.json"))
    secs = time.perf_counter() - t_phase
    print(f"{name} obs phase: {len(tracer.events)} trace events ({', '.join(spans)}), "
          f"{secs:.1f} s")
    return {"layers": layers, "scales": scales, "agreement": report.agreement(),
            "agreement_calibrated": report.recalibrated(db).agreement(),
            "plan": plan_line(base), "plan_calibrated": plan_line(calibrated),
            "plan_served": plan_line(plan), "moved": moved, "tile_search": searched,
            "floor_holds": ts.floor_holds(), "launches_measured": measured,
            "launches": launches,
            "max_abs_vs_dense": err, "max_abs_dense": scale, "seconds": secs}


LM_ARCH = "qwen3-0.6b"
LM_SERVE = dict(batch=4, prompt_len=32, gen_len=32, seed=0)
LM_TF_STEPS = 4  # teacher-forced decode steps held against the CPU
LM_LONG = dict(b=4, sq=2048, dec_kv_len=4096, dec_s_max=4160)


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


class capture_attention:
    """Within the block, record the (q, k, v[, scales], kwargs) of the
    model's flash calls whose running index is in `keep` (cloned: the cache
    is written in place), then run the call as usual."""

    def __init__(self, keep):
        self.keep, self.calls, self.n = set(keep), {}, 0

    def __enter__(self):
        import repro_torch.models.attention as A

        self.A, self.orig = A, (A.flash_fwd, A.flash_fwd_q8)

        def wrap(fn):
            def rec(*args, **kw):
                if self.n in self.keep:
                    self.calls[self.n] = (tuple(a.clone() for a in args), dict(kw))
                self.n += 1
                return fn(*args, **kw)
            return rec

        A.flash_fwd, A.flash_fwd_q8 = wrap(self.orig[0]), wrap(self.orig[1])
        return self

    def __exit__(self, *exc):
        self.A.flash_fwd, self.A.flash_fwd_q8 = self.orig


class pin_quantization:
    """The int8 cache's rounding, pinned. Mode "record" (the card's run) keeps
    each `_quantize_kv` result in call order; mode "replay" (the host's run)
    quantizes its own K/V, holds the result to the card's (values within one
    step, scales within 1e-5 relative: an fp32 difference of 1e-7 moves a
    value sitting on a rounding boundary by one step) and hands on the
    card's values, so the host attends over the cache the card attended
    over."""

    def __init__(self, mode, recorded=None):
        self.mode, self.recorded = mode, recorded if recorded is not None else []
        self.i, self.moved, self.total, self.worst_step, self.worst_scale = 0, 0, 0, 0, 0.0

    def __enter__(self):
        import repro_torch.models.attention as A

        self.A, self.orig = A, A._quantize_kv

        def quantize(x):
            q, sc = self.orig(x)
            if self.mode == "record":
                self.recorded.append((q.cpu(), sc.cpu()))
                return q, sc
            qc, scc = self.recorded[self.i]
            self.i += 1
            step = (q.int() - qc.int()).abs()
            self.moved += int((step > 0).sum())
            self.total += q.numel()
            self.worst_step = max(self.worst_step, int(step.max()))
            self.worst_scale = max(self.worst_scale,
                                   float(((sc - scc).abs() / scc.abs()).max()))
            return qc.to(q.device), scc.to(sc.device)

        A._quantize_kv = quantize
        return self

    def __exit__(self, *exc):
        self.A._quantize_kv = self.orig


def teacher_forced(cfg, params, prompt, follow, kv_dtype, dev, max_len, inputs=None):
    """Prefill the prompt, then decode the `follow` tokens one by one:
    [prefill logits (B,S,V)] + one (B,1,V) per step, on the host. `inputs`
    = (prefill's, each decode step's) batch entries beside the tokens (a
    VLM's image embeddings, whisper's frames and encoder output), moved to
    `dev`."""
    import torch

    from repro_torch.models import model as M

    pre, dec = ({k: v.to(dev) for k, v in d.items()} for d in (inputs or ({}, {})))
    dt = torch.int8 if kv_dtype == "int8" else torch.float32
    cache = M.init_cache(cfg, prompt.shape[0], max_len, dt, device=dev)
    out = []
    with torch.no_grad():
        lg, cache = M.prefill(cfg, params, cache, {"tokens": prompt.to(dev), **pre})
        out.append(lg.cpu())
        for t in range(follow.shape[1]):
            lg, cache = M.decode_step(cfg, params, cache,
                                      {"tokens": follow[:, t:t + 1].to(dev), **dec},
                                      prompt.shape[1] + t)
            out.append(lg.cpu())
    return out


def visible_pairs(sq, sk, causal, q_offset, kv_len):
    """(visible q.k pairs per head, keys any row reads) under the masks."""
    lim = sk if kv_len is None else max(0, min(sk, kv_len))
    per_row = [lim if not causal else max(0, min(lim, q_offset + s + 1))
               for s in range(sq)]
    return sum(per_row), max(per_row)


def flash_bound(q, k, kw, *, q8):
    """(op time, byte time) in ms: 4 * B * H * pairs * D operations (q.k and
    p.v) at the rate of the operands' type (fp32: the kernels' split-TF32,
    165 TFLOP/s; bf16: the bf16 tensor cores, 989 TFLOP/s); K/V of the keys
    read (4 or 2 bytes, or 1 byte plus the fp32 scales), Q and O once, and m
    and l (fp32 and bf16 kernels) over 3.35 TB/s."""
    b, sq, kvh, g, d = q.shape
    sk = k.shape[1]
    eb = q.element_size()
    pairs, keys = visible_pairs(sq, sk, kw["causal"], kw["q_offset"], kw["kv_len"])
    ops = 4.0 * b * kvh * g * pairs * d
    kv_bytes = 2.0 * b * kvh * keys * (d * 1 + 4 if q8 else d * eb)
    nbytes = kv_bytes + 2.0 * eb * b * kvh * g * sq * d + (0 if q8 else 8.0 * b * kvh * g * sq)
    peak = PEAK_BF16_FLOPS if eb == 2 else PEAK_TF32_SPLIT_FLOPS
    return ops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3


def attention_mask(sq, sk, kw, device):
    """The kernels' causal / q_offset / kv_len mask as a boolean (Sq, Sk)."""
    import torch

    qpos = kw["q_offset"] + torch.arange(sq, device=device)
    kpos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if kw["causal"]:
        mask &= qpos[:, None] >= kpos[None, :]
    if kw["kv_len"] is not None:
        mask &= (kpos < kw["kv_len"])[None, :]
    return mask


def flash_library(q, k, v, kw, ks=None, vs=None):
    """F.scaled_dot_product_attention on the same inputs: q to (B,H,Sq,D),
    K/V expanded to the H query heads (outside the call for fp32; for int8
    the dequantize and the expansion are inside it), the same boolean mask."""
    import torch.nn.functional as F

    b, sq, kvh, g, d = q.shape
    qh = q.reshape(b, sq, kvh * g, d).transpose(1, 2)
    mask = attention_mask(sq, k.shape[1], kw, q.device)

    def heads(x):
        return x.repeat_interleave(g, dim=2).transpose(1, 2)

    if ks is None:
        kh, vh = heads(k), heads(v)
        return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                      scale=kw["scale"])
    return lambda: F.scaled_dot_product_attention(
        qh, heads(k.float() * ks[..., None]), heads(v.float() * vs[..., None]),
        attn_mask=mask, scale=kw["scale"])


# A score rounded in fp32 carries a few units of 2^-24 * |s|, on the kernel's
# side and on the plain version's (up to 2.7 each against an fp64 reference
# on the H100, at scores up to 1,500); p = exp(s - m), and with it out and l,
# moves by that fraction of itself.
SCORE_ULPS = 8


def score_widening(max_score: float) -> float:
    """What the fp32 limit of out and l widens by, as a fraction of
    max|plain|, at scores up to `max_score`: SCORE_ULPS * 2^-24 * max_score.
    At the scores the qwen3 checks see (|s| < 100) it is under 5e-5 of the
    1e-4 limit; at random-weight dense configs without qk_norm (wq and wk
    drawn at fan-in n_heads: scores near 1,500) it is about 7e-4."""
    return SCORE_ULPS * 2.0 ** -24 * max_score


def check_flash(book, label, args, kw, *, timed, wide=False, phase=LM_ARCH,
                saturated=False):
    """A flash kernel against its plain version (out, and m, l for fp32 and
    bf16) on model-layout operands (`wide`: q and k spread over 2^+-3);
    `saturated` (fp32 and int8 K/V): out and l at the fp32 limit widened by
    `score_widening` of the plain version's largest row max, both sides'
    out also printed against an fp64 reference; when `timed`, kernel /
    plain / library times and the bound. Returns the timing row or None."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import (
        flash_fwd,
        flash_fwd_plain,
        flash_fwd_q8,
        flash_fwd_q8_plain,
    )

    q8 = len(args) == 5
    bf16 = args[0].dtype == torch.bfloat16
    name = "flash_fwd_q8" if q8 else ("flash_fwd_bf16" if bf16 else "flash_fwd")
    kernel = (lambda: flash_fwd_q8(*args, **kw)) if q8 else (lambda: flash_fwd(*args, **kw))
    plain = (lambda: flash_fwd_q8_plain(*args, **kw)) if q8 else \
        (lambda: flash_fwd_plain(*args, **kw))
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    tag = (f"{label} q{tuple(args[0].shape)} k{tuple(args[1].shape)} "
           f"q_offset={kw['q_offset']} kv_len={kw['kv_len']}")
    widen = 0.0
    if saturated:
        from repro_torch.kernels.flash_attention.kernel import dequantize

        kv = ((dequantize(args[1], args[3]), dequantize(args[2], args[4])) if q8
              else args[1:3])
        m = flash_fwd_plain(args[0], *kv, **kw)[1]
        m = m[m > -1e29]  # rows that see no key carry the mask value
        max_score = float(m.abs().max()) if m.numel() else 0.0
        widen = score_widening(max_score)
        truth = flash_fwd_plain(*(t.double() for t in (args[0], *kv)), **kw)[0]
        g_out, w_out = (got, want) if q8 else (got[0], want[0])
        print(f"  {name:15s} {label}: scores up to {max_score:.1f}; out against fp64: "
              f"kernel {float((g_out.double() - truth).abs().max()):.3e}, plain "
              f"{float((w_out.double() - truth).abs().max()):.3e}")
    if q8:
        book.check(name, tag, got, want, widen=widen)
    elif bf16:
        for part, g_, w_ in zip(("out", "m", "l"), got, want):
            book.check_bf16(name, f"{tag} {part}", g_, w_, stat=part != "out", wide=wide)
    else:
        for part, g_, w_ in zip(("out", "m", "l"), got, want):
            book.check(name, f"{tag} {part}", g_, w_, widen=0.0 if part == "m" else widen)
    if not timed:
        return None
    lib = flash_library(*args[:3], kw, *(args[3:] if q8 else ()))
    lib_out = lib()
    got_out = got if q8 else got[0]
    b, sq, kvh, g, d = args[0].shape
    lib_err = float((lib_out.transpose(1, 2).reshape(got_out.shape).float()
                     - got_out.float()).abs().max())
    fns = {"kernel": kernel, "plain": plain, "library": lib}
    t = time_graph_turns(fns)
    te = time_turns(fns)
    ft, bt = flash_bound(args[0], args[1], kw, q8=q8)
    row = {"kernel": name, "shape": label, "q": list(args[0].shape),
           "k": list(args[1].shape), "q_offset": kw["q_offset"], "kv_len": kw["kv_len"],
           "ms": t["kernel"], "plain_ms": t["plain"], "library_ms": t["library"],
           "eager_ms": te["kernel"], "eager_plain_ms": te["plain"],
           "eager_library_ms": te["library"],
           "flop_ms": ft, "byte_ms": bt, "bound_ms": max(ft, bt),
           "bound_by": "operations" if ft >= bt else "bytes",
           "library_max_abs_diff": lib_err, "phase": phase, "head_dim": d}
    book.rows.append(row)
    print(f"    {name} {label}: ms={t['kernel']:.4f} plain_ms={t['plain']:.4f} "
          f"library_ms={t['library']:.4f} bound_ms={max(ft, bt):.4f} "
          f"({row['bound_by']}) [CUDA-graph replay]; eager calls: "
          f"{te['kernel']:.4f} / {te['plain']:.4f} / {te['library']:.4f} ms; "
          f"|kernel - SDPA| {lib_err:.2e}")
    return row


def lm_phase(book, dev, failures) -> dict:
    """Full-width qwen3-0.6b served through the port (fp32 and int8 cache):
    counters, teacher-forced logits against the CPU, the flash kernels at the
    served, long and edge shapes, and a trace of prefill and decode."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_fwd, flash_fwd_q8
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    from repro_torch.models.attention import _quantize_kv

    cfg = get_config(LM_ARCH)
    wrappers = {"flash_fwd": flash_fwd, "flash_fwd_q8": flash_fwd_q8}
    max_len = LM_SERVE["prompt_len"] + LM_SERVE["gen_len"]
    expect = cfg.n_layers * LM_SERVE["gen_len"]  # prefill + gen_len - 1 steps
    summary = {"runs": {}}
    served = {}
    for kvd, want in (("float32", "flash_fwd"), ("int8", "flash_fwd_q8")):
        # warm-up: cuBLAS handles and first launches stay out of the timed run
        serve(LM_ARCH, reduced=False, device=dev, kv_cache_dtype=kvd,
              **dict(LM_SERVE, gen_len=2))
        reset_counts(wrappers)
        res = serve(LM_ARCH, reduced=False, device=dev, kv_cache_dtype=kvd, **LM_SERVE)
        launches = read_counts(wrappers)
        served[kvd] = res
        print(f"{LM_ARCH} served ({kvd} KV cache): batch {LM_SERVE['batch']}, prompt "
              f"{LM_SERVE['prompt_len']}, {LM_SERVE['gen_len']} tokens: prefill "
              f"{res.prefill_ms:.2f} ms, decode {res.decode_ms:.3f} ms/step, "
              f"{res.tok_s:.1f} tok/s; launches {launches} (expected {expect} of {want})")
        other = "flash_fwd_q8" if want == "flash_fwd" else "flash_fwd"
        if launches[want] != expect or launches[other] != 0:
            failures.append(f"{LM_ARCH} {kvd}: launches {launches}, expected {expect} "
                            f"of {want} and none of {other}")
        toks = res.tokens.cpu()
        if toks.shape != (LM_SERVE["batch"], LM_SERVE["gen_len"]) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            failures.append(f"{LM_ARCH} {kvd}: served tokens malformed")
        summary["runs"][kvd] = {"prefill_ms": res.prefill_ms, "decode_ms": res.decode_ms,
                                "tok_s": res.tok_s, "launches": launches}

    # the weights serve drew (host generator, seed 0), on the card and the host
    params = M.init_params(cfg, torch.Generator().manual_seed(LM_SERVE["seed"]), device=dev)
    params_cpu = tree_to(params, "cpu")
    n_layers = cfg.n_layers
    keep = (0, n_layers - 1, n_layers, 2 * n_layers - 1)  # prefill / first decode step
    card_logits, captured = {}, {}
    for kvd, res in served.items():
        prompt, follow = res.prompt.cpu(), res.tokens.cpu()[:, :LM_TF_STEPS]
        with capture_attention(keep) as cap, pin_quantization("record") as rec:
            card = teacher_forced(cfg, params, prompt, follow, kvd, dev, max_len)
        captured[kvd] = cap.calls
        card_logits[kvd] = card
        host = teacher_forced(cfg, params_cpu, prompt, follow, kvd, "cpu", max_len)
        pinned = None
        if kvd == "int8":
            # each side's own rounding (reported), then the host on the card's values
            raw = max(float((c - h).abs().max()) for c, h in zip(card, host))
            with pin_quantization("replay", rec.recorded) as pinned:
                host = teacher_forced(cfg, params_cpu, prompt, follow, kvd, "cpu", max_len)
            q_ok = pinned.worst_step <= 1 and pinned.worst_scale <= 1e-5
            print(f"{LM_ARCH} int8 host vs card quantization of the cache: "
                  f"{pinned.moved} of {pinned.total} values one step apart "
                  f"(max step {pinned.worst_step}, limit 1), scales within "
                  f"{pinned.worst_scale:.2e} relative (limit 1e-5): "
                  f"{'ok' if q_ok else 'FAIL'}; logits on each side's own "
                  f"rounding differ by up to {raw:.3e}")
            if not q_ok:
                failures.append(f"{LM_ARCH} int8: host and card quantize the cache apart")
            summary["runs"][kvd].update(
                quant_values_moved=pinned.moved, quant_values=pinned.total,
                quant_worst_step=pinned.worst_step, quant_worst_scale=pinned.worst_scale,
                max_abs_unpinned=raw)
        worst, ok = 0.0, True
        for c, h in zip(card, host):
            c, h = c.numpy(), h.numpy()
            scale = float(np.abs(h).max())
            worst = max(worst, float(np.abs(c - h).max()))
            ok &= bool(np.all(np.isfinite(c))) and np.allclose(c, h, rtol=1e-3,
                                                               atol=1e-3 * scale)
        greedy = torch.stack([card[0][:, -1].argmax(-1)] + [
            lg[:, 0].argmax(-1) for lg in card[1:LM_TF_STEPS]], 1).to(torch.int32)
        same = bool(torch.equal(greedy, follow))
        on = " (host on the card's int8 cache values)" if pinned is not None else ""
        print(f"{LM_ARCH} {kvd} card vs host plain path{on}, teacher-forced prefill + "
              f"{LM_TF_STEPS} decode steps: max_abs_err={worst:.3e} (max|host|="
              f"{max(float(h.abs().max()) for h in host):.3e}, rtol=1e-3, "
              f"atol=1e-3*max|host|): {'ok' if ok else 'FAIL'}; served tokens are "
              f"the card's argmax: {same}")
        if not ok:
            failures.append(f"{LM_ARCH} {kvd}: card logits disagree with the host")
        if not same:
            failures.append(f"{LM_ARCH} {kvd}: served tokens are not the greedy argmax")
        summary["runs"][kvd]["max_abs_vs_host"] = worst
    agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
             for a, b in zip(card_logits["int8"], card_logits["float32"])]
    drift = max(float((a - b).abs().max())
                for a, b in zip(card_logits["int8"], card_logits["float32"]))
    print(f"{LM_ARCH} int8 cache vs fp32 cache logits (card, teacher-forced): top-1 "
          f"agreement {np.mean(agree):.3f} (per step {['%.3f' % a for a in agree]}), "
          f"max drift {drift:.3e}")
    summary["int8_vs_fp32"] = {"top1_agreement": float(np.mean(agree)), "max_drift": drift}

    # ---- the flash kernels at the served, long and edge shapes -------------
    print(f"{LM_ARCH} flash kernel checks (both kernels at the fp32 limit, "
          f"{KERNEL_TOL.split(';')[0]}):")
    for kvd, calls in captured.items():
        for idx in keep:
            if idx not in calls:
                failures.append(f"{LM_ARCH} {kvd}: attention call {idx} not captured")
                continue
            args, kw = calls[idx]
            layer = idx % n_layers
            label = f"{'prefill' if idx < n_layers else 'decode'} layer {layer}"
            check_flash(book, label, args, kw, timed=(layer == 0))
    gen = torch.Generator(device=dev).manual_seed(5)
    kvh, g, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
    b, sq = LM_LONG["b"], LM_LONG["sq"]
    q = torch.randn((b, sq, kvh, g, d), generator=gen, device=dev)
    k = torch.randn((b, sq, kvh, d), generator=gen, device=dev)
    v = torch.randn((b, sq, kvh, d), generator=gen, device=dev)
    sc = d ** -0.5
    longs = [("long prefill", (q, k, v), dict(scale=sc, causal=True, q_offset=0, kv_len=None))]
    kl, smax = LM_LONG["dec_kv_len"], LM_LONG["dec_s_max"]
    qd = torch.randn((b, 1, kvh, g, d), generator=gen, device=dev)
    kd = torch.randn((b, smax, kvh, d), generator=gen, device=dev)
    vd = torch.randn((b, smax, kvh, d), generator=gen, device=dev)
    longs.append(("long decode", (qd, kd, vd),
                  dict(scale=sc, causal=True, q_offset=kl - 1, kv_len=kl)))
    for label, (qq, kk, vv), kw in longs:
        check_flash(book, label, (qq, kk, vv), kw, timed=True)
        kq, ks = _quantize_kv(kk)
        vq, vs = _quantize_kv(vv)
        check_flash(book, label, (qq, kq, vq, ks, vs), kw, timed=True)
    del q, k, v, kd, vd
    # edge shapes: ragged Sq/Sk, kv_len < Sk, q_offset > 0, Sq = 1, a fully
    # masked block, G = 3; decode at the fp32 kernel's tile edges (G of a
    # 16-row tile live, kv_len at one key, one short of and one past a
    # 64-key cache read at Sk = 80)
    edges = [  # (b, sq, kvh, g, sk, d, causal, q_offset, kv_len)
        (3, 37, 2, 2, 53, 128, False, 0, None),
        (3, 37, 2, 2, 53, 128, True, 16, None),
        (2, 100, 1, 3, 300, 64, True, 200, 290),
        (2, 1, 8, 2, 130, 128, True, 99, 100),
        (2, 8, 2, 2, 32, 128, False, 0, 0),
    ]
    edges += [(4, 1, 8, eg, 80, 128, True, kvl - 1, kvl)
              for eg in (1, 2, 4, 8) for kvl in (1, 63, 65)]
    for eb, esq, ekv, eg, esk, ed, causal, qo, kvl in edges:
        qq = torch.randn((eb, esq, ekv, eg, ed), generator=gen, device=dev)
        kk = torch.randn((eb, esk, ekv, ed), generator=gen, device=dev)
        vv = torch.randn((eb, esk, ekv, ed), generator=gen, device=dev)
        kw = dict(scale=ed ** -0.5, causal=causal, q_offset=qo, kv_len=kvl)
        check_flash(book, "edge", (qq, kk, vv), kw, timed=False)
        kq, ks = _quantize_kv(kk)
        vq, vs = _quantize_kv(vv)
        check_flash(book, "edge", (qq, kq, vq, ks, vs), kw, timed=False)
    # q and k spread over 2^+-3 at D = 128 (scores up to about 70), where one
    # TF32 product per multiply-add misses the fp32 limit
    qq = torch.randn((4, 32, kvh, g, d), generator=gen, device=dev)
    kk = torch.randn((4, 64, kvh, d), generator=gen, device=dev)
    vv = torch.randn((4, 64, kvh, d), generator=gen, device=dev)
    qq = qq * torch.exp2(torch.randint(-3, 4, qq.shape, generator=gen, device=dev).float())
    kk = kk * torch.exp2(torch.randint(-3, 4, kk.shape, generator=gen, device=dev).float())
    check_flash(book, "q and k over 2^+-3", (qq, kk, vv),
                dict(scale=d ** -0.5, causal=True, q_offset=0, kv_len=32), timed=False)

    # ---- where the time goes: one prefill and one decode step, warm --------
    summary["service"] = {}
    for kvd in ("float32", "int8"):
        dt = torch.int8 if kvd == "int8" else torch.float32
        cache = M.init_cache(cfg, LM_SERVE["batch"], max_len, dt, device=dev)
        prompt = served[kvd].prompt
        nxt = served[kvd].tokens[:, :1]

        def prefill():
            with torch.no_grad():
                return M.prefill(cfg, params, cache, {"tokens": prompt})

        def decode():
            with torch.no_grad():
                return M.decode_step(cfg, params, cache, {"tokens": nxt},
                                     LM_SERVE["prompt_len"])

        for step, fn in (("prefill", prefill), ("decode", decode)):
            br = trace_breakdown(fn)
            summary["service"][f"{kvd} {step}"] = br
            print(f"{LM_ARCH} {kvd} warm {step}: wall {br['wall_ms']:.3f} ms (median of 5), "
                  f"device {br['device_ms']:.3f} ms in {br['device_ops']} device ops, "
                  f"idle share {br['idle_share']}")
            for cat, ms in sorted(br["by_class_ms"].items(), key=lambda kv: -kv[1]):
                print(f"  {ms:8.3f} ms  {cat}")
    del params, params_cpu
    torch.cuda.empty_cache()
    return summary


LM_TRAIN = dict(steps=6, global_batch=8, seq_len=128, seed=0)
LM_TRAIN_HOST_BATCH = 2  # the host's gradient check, batch cut for its sake
LM_TRAIN_FP32_STEPS = 3  # the fp32 trainer's run
LM_RESTART = dict(steps=10, global_batch=2, seq_len=32, checkpoint_every=3, fail_at=(7,))


class capture_backward:
    """Within the block, record (q, k, v, out, m, l, do, kwargs) of the
    attention backward calls (`FlashAttentionFn.backward`'s `flash_bwd`)
    whose running index is in `keep`, cloned, then run the call as usual.
    The backward visits the layers last to first: index 0 is the last
    layer."""

    def __init__(self, keep):
        self.keep, self.calls, self.n = set(keep), {}, 0

    def __enter__(self):
        import repro_torch.kernels.flash_attention.ops as O

        self.O, self.orig = O, O.flash_bwd

        def rec(*args, **kw):
            if self.n in self.keep:
                self.calls[self.n] = (tuple(a.detach().clone() for a in args), dict(kw))
            self.n += 1
            return self.orig(*args, **kw)

        O.flash_bwd = rec
        return self

    def __exit__(self, *exc):
        self.O.flash_bwd = self.orig


def flash_bwd_bound(q, k, kw, *, part, peak=None):
    """(op time, byte time) in ms of one backward pass for these inputs:
    per visible (q, k) pair and head-dim element 6 operations for dq
    (scores, dp, ds.k) and 8 for dk/dv (scores, dp, p^T.do, ds^T.q), at
    `peak` (default: the rate of the operands' type, the fp32 kernels'
    split-TF32 165 TFLOP/s or the bf16 tensor cores' 989; 67 for fp32 on
    the CUDA cores); q, do, k, v of the keys read (4 or 2 bytes), m, l,
    delta read, and dq, or dk and dv, written once, over 3.35 TB/s."""
    b, sq, kvh, g, d = q.shape
    sk = k.shape[1]
    eb = q.element_size()
    if peak is None:
        peak = PEAK_BF16_FLOPS if eb == 2 else PEAK_TF32_SPLIT_FLOPS
    pairs, keys = visible_pairs(sq, sk, kw["causal"], kw["q_offset"], kw["kv_len"])
    per = 6.0 if part == "dq" else 8.0
    ops = per * b * kvh * g * pairs * d
    rows = b * kvh * g * sq
    qbytes = 1.0 * eb * rows * d
    kbytes = 1.0 * eb * b * kvh * keys * d
    nbytes = 2 * qbytes + 2 * kbytes + 12.0 * rows + (qbytes if part == "dq" else 2 * kbytes)
    return ops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3


def sdpa_backward(q, k, v, do, kw):
    """The backward of F.scaled_dot_product_attention (in the operands' type)
    on the same inputs (K/V expanded to the query heads, the same mask): two
    closures
    that compute its three gradients, the autograd backward of the SDPA call
    (eager only: it runs on the forward's stream) and the memory-efficient
    attention backward op, SDPA's fused backend for fp32 inputs with a mask,
    fed by that op's own forward (capturable in a CUDA graph; the caller
    prints how far its dq lies from the autograd call's)."""
    import torch
    import torch.nn.functional as F

    b, sq, kvh, g, d = q.shape
    sk = k.shape[1]
    qh = q.reshape(b, sq, kvh * g, d).transpose(1, 2).detach().requires_grad_(True)
    kh = k.repeat_interleave(g, dim=2).transpose(1, 2).detach().requires_grad_(True)
    vh = v.repeat_interleave(g, dim=2).transpose(1, 2).detach().requires_grad_(True)
    mask = attention_mask(sq, sk, kw, q.device)
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, scale=kw["scale"])
    doh = do.reshape(b, sq, kvh * g, d).transpose(1, 2)
    bias = torch.zeros((sq, sk), device=q.device, dtype=q.dtype).masked_fill(
        ~mask, float("-inf"))
    bias = bias.expand(b, kvh * g, sq, sk)
    aten = torch.ops.aten
    o, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
        qh.detach(), kh.detach(), vh.detach(), bias, True, 0.0, False, scale=kw["scale"])
    return (lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True),
            lambda: aten._scaled_dot_product_efficient_attention_backward(
                doh, qh.detach(), kh.detach(), vh.detach(), bias, o, lse, seed, offset, 0.0,
                [True, True, True, False], False, scale=kw["scale"])[:3])


def flash_bwd_bf16_tile(ops, kw, *, part, tile):
    """One bf16 backward pass at a chosen block tile (`repro_flash_bwd_*_bf16_tile`:
    the rows a dq block owns or the keys a dk/dv block owns, 32 or 64 at head
    dim 128) on the wrappers' operands -> dq, or (dk, dv). For the tile
    comparison only: it counts no launch, and the wrappers take the passes'
    own tiles."""
    import ctypes

    import torch

    from repro_torch.kernels import cuda as kcuda

    q, k, v, do, m, l, delta = ops
    nbkv, nh, g, sq, sk, d = kcuda.check_flash_operands(q, k, v)
    dq = torch.empty_like(q) if part == "dq" else q
    dk, dv = (torch.empty_like(k), torch.empty_like(v)) if part == "dkv" else (k, v)
    dims = (ctypes.c_int * 9)(nbkv, nh, g, sq, sk, d, int(bool(kw["causal"])),
                              int(kw["q_offset"]),
                              -1 if kw["kv_len"] is None else max(0, int(kw["kv_len"])))
    strides = (ctypes.c_longlong * 24)(*kcuda.flash_bwd_strides(q, k, v, do, dq, dk, dv))
    fn = getattr(kcuda.library(), f"repro_flash_bwd_{part}_bf16_tile")
    fn.argtypes = ([ctypes.c_void_p] * (8 if part == "dq" else 9)
                   + [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_longlong),
                      ctypes.c_float, ctypes.c_void_p, ctypes.c_int])
    fn.restype = ctypes.c_int
    outs = (dq,) if part == "dq" else (dk, dv)
    err = fn(*(t.data_ptr() for t in ops + outs), dims, strides, float(kw["scale"]),
             torch.cuda.current_stream().cuda_stream, int(tile))
    if err != 0:
        raise RuntimeError(f"repro_flash_bwd_{part}_bf16_tile (tile {tile}) failed: "
                           f"cudaError {err}")
    return dq if part == "dq" else (dk, dv)


def check_flash_bwd(book, label, args, kw, *, timed):
    """Both backward kernels against their plain versions (dq; dk and dv) on
    model-layout operands (q, k, v, out, m, l, do); when `timed`, kernel /
    plain / library times and the bound of each pass. Returns the rows."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import (
        flash_bwd_dkv,
        flash_bwd_dkv_plain,
        flash_bwd_dq,
        flash_bwd_dq_plain,
        flash_delta,
    )

    q, k, v, out, m, l, do = args
    delta = flash_delta(do, out)
    ops = (q, k, v, do, m, l, delta)
    dq = flash_bwd_dq(*ops, **kw)
    dk, dv = flash_bwd_dkv(*ops, **kw)
    torch.cuda.synchronize()
    pdq = flash_bwd_dq_plain(*ops, **kw)
    pdk, pdv = flash_bwd_dkv_plain(*ops, **kw)
    tag = (f"{label} q{tuple(q.shape)} k{tuple(k.shape)} q_offset={kw['q_offset']} "
           f"kv_len={kw['kv_len']} causal={kw['causal']}")
    bf16 = q.dtype == torch.bfloat16
    sfx = "_bf16" if bf16 else ""
    check = book.check_bf16 if bf16 else book.check
    check("flash_bwd_dq" + sfx, f"{tag} dq", dq, pdq)
    check("flash_bwd_dkv" + sfx, f"{tag} dk", dk, pdk)
    check("flash_bwd_dkv" + sfx, f"{tag} dv", dv, pdv)
    if not timed:
        return []
    lib_autograd, lib = sdpa_backward(q, k, v, do, kw)
    gq = lib()[0]
    lib_err = float((gq.transpose(1, 2).reshape(q.shape).float() - dq.float()).abs().max())
    lib_gap = float((lib_autograd()[0].float() - gq.float()).abs().max())
    del gq
    fns = {"dq": lambda: flash_bwd_dq(*ops, **kw), "dkv": lambda: flash_bwd_dkv(*ops, **kw),
           "dq_plain": lambda: flash_bwd_dq_plain(*ops, **kw),
           "dkv_plain": lambda: flash_bwd_dkv_plain(*ops, **kw), "library": lib}
    tiles = bf16 and q.shape[-1] == 128  # both block tiles of the bf16 passes, compared
    if tiles:
        for tile in BF16_BWD_TILES:
            check(f"flash_bwd_dq{sfx}", f"{tag} dq (BM {tile})",
                  flash_bwd_bf16_tile(ops, kw, part="dq", tile=tile), pdq)
            tdk, tdv = flash_bwd_bf16_tile(ops, kw, part="dkv", tile=tile)
            check(f"flash_bwd_dkv{sfx}", f"{tag} dk (BN {tile})", tdk, pdk)
            check(f"flash_bwd_dkv{sfx}", f"{tag} dv (BN {tile})", tdv, pdv)
            for part in ("dq", "dkv"):
                fns[f"{part}_tile{tile}"] = (lambda part=part, tile=tile: flash_bwd_bf16_tile(
                    ops, kw, part=part, tile=tile))
    t = time_graph_turns(fns)
    te = time_turns({**fns, "library": lib_autograd})
    rows = []
    for part, name in (("dq", "flash_bwd_dq" + sfx), ("dkv", "flash_bwd_dkv" + sfx)):
        ft, bt = flash_bwd_bound(q, k, kw, part=part)
        fc, _ = flash_bwd_bound(q, k, kw, part=part, peak=PEAK_FP32_FLOPS)
        row = {"kernel": name, "shape": label, "q": list(q.shape), "k": list(k.shape),
               "q_offset": kw["q_offset"], "kv_len": kw["kv_len"], "ms": t[part],
               "plain_ms": t[part + "_plain"], "library_ms": t["library"],
               "eager_ms": te[part], "eager_plain_ms": te[part + "_plain"],
               "eager_library_ms": te["library"],
               "flop_ms": ft, "byte_ms": bt, "bound_ms": max(ft, bt),
               "bound_by": "operations" if ft >= bt else "bytes",
               "fp32_core_bound_ms": max(fc, bt),
               "library_max_abs_diff_dq": lib_err, "phase": LM_ARCH + "-train"}
        if tiles:
            row["tile_ms"] = {str(tile): t[f"{part}_tile{tile}"] for tile in BF16_BWD_TILES}
        book.rows.append(row)
        rows.append(row)
        print(f"    {name} {label}: ms={t[part]:.4f} plain_ms={t[part + '_plain']:.4f} "
              f"library_ms={t['library']:.4f} (SDPA backward, all three gradients) "
              f"bound_ms={max(ft, bt):.4f} ({row['bound_by']}; CUDA cores "
              f"{max(fc, bt):.4f}) [CUDA-graph replay]; eager calls: {te[part]:.4f} / "
              f"{te[part + '_plain']:.4f} / {te['library']:.4f} ms (library: autograd SDPA)")
    print(f"    dq + dk/dv {t['dq'] + t['dkv']:.4f} ms against SDPA's backward "
          f"{t['library']:.4f} ms [CUDA-graph replay]; |dq - SDPA dq| {lib_err:.2e}; "
          f"efficient-attention op vs autograd SDPA dq {lib_gap:.2e}")
    if tiles:
        print(f"    bf16 block tiles {label}: dq BM " + " / ".join(
                  f"{tile} {t[f'dq_tile{tile}']:.4f}" for tile in BF16_BWD_TILES)
              + " ms, dk/dv BN " + " / ".join(
                  f"{tile} {t[f'dkv_tile{tile}']:.4f}" for tile in BF16_BWD_TILES)
              + " ms [CUDA-graph replay, same run]")
    return rows


def grads_vs_host(cfg, run, batch0, dev, failures, *, limits, tag) -> tuple:
    """One step's loss, grad norm and gradient leaves on the card against the
    host's plain path at `run`'s types (fresh weights from the train seed,
    the first LM_TRAIN_HOST_BATCH rows of `batch0`); before that, the
    attention backward calls of layers 0 and n_layers - 1 of the full batch
    are captured for the kernel checks. limits = (loss, grad norm, leaf),
    each relative. Returns (summary, captured calls)."""
    import torch

    from repro_torch.launch.steps import DTYPES, loss_and_grads, to_device
    from repro_torch.models import model as M
    from repro_torch.optim import global_norm
    from repro_torch.tree import tree_leaves, tree_paths

    n_layers, sl = cfg.n_layers, LM_TRAIN["seq_len"]
    params = M.init_params(cfg, torch.Generator().manual_seed(LM_TRAIN["seed"]), device=dev,
                           dtype=DTYPES[run.param_dtype])
    keep = (0, n_layers - 1)  # backward order: the last layer, then layer 0
    with capture_backward(keep) as cap:
        loss_and_grads(cfg, run, params, to_device(batch0, dev))
    hb = {k: v[:LM_TRAIN_HOST_BATCH] for k, v in batch0.items()}
    loss_c, grads_c = loss_and_grads(cfg, run, params, to_device(hb, dev))
    params_cpu = tree_to(params, "cpu")
    del params
    grads_c = tree_to(grads_c, "cpu")
    t0 = time.perf_counter()
    loss_h, grads_h = loss_and_grads(cfg, run.replace(remat="none"), params_cpu,
                                     to_device(hb, "cpu"))
    host_s = time.perf_counter() - t0
    lc, lh = float(loss_c), float(loss_h)
    nc, nh = float(global_norm(grads_c)), float(global_norm(grads_h))
    lim_loss, lim_norm, lim_leaf = limits
    worst, zero_layers, ok_leaves = 0.0, [], True
    for (path_c, gc), gh in zip(tree_paths(grads_c), tree_leaves(grads_h)):
        gc, gh = gc.float(), gh.float()
        scale = float(gh.abs().max())
        err = float((gc - gh).abs().max())
        worst = max(worst, err / scale if scale else err)
        ok_leaves &= err <= lim_leaf * scale
        per_layer = gc.reshape(gc.shape[0], -1) if path_c.startswith("groups") else \
            gc.reshape(1, -1)
        zero_layers += [f"{path_c}[{i}]" for i in range(per_layer.shape[0])
                        if not bool(per_layer[i].abs().max() > 0)]
    ok_loss = abs(lc - lh) <= lim_loss * abs(lh)
    ok_norm = abs(nc - nh) <= lim_norm * nh
    print(f"{LM_ARCH} {tag} one step's gradients, card vs host plain path (batch "
          f"{LM_TRAIN_HOST_BATCH} x {sl}; host {host_s:.1f} s): loss {lc:.6f} vs "
          f"{lh:.6f} ({'ok' if ok_loss else 'FAIL'}, {lim_loss:g} rel), grad norm {nc:.6f} "
          f"vs {nh:.6f} ({'ok' if ok_norm else 'FAIL'}, {lim_norm:g} rel), worst leaf "
          f"max|card - host| / max|host| = {worst:.2e} ({'ok' if ok_leaves else 'FAIL'},"
          f" {lim_leaf:g}); leaves (per layer) with a zero gradient on the card: "
          f"{zero_layers or 'none'}")
    if not (ok_loss and ok_norm and ok_leaves):
        failures.append(f"{LM_ARCH} {tag}: card gradients disagree with the host")
    if zero_layers:
        failures.append(f"{LM_ARCH} {tag}: zero gradients on the card: {zero_layers}")
    summary = {"loss": [lc, lh], "grad_norm": [nc, nh], "worst_leaf_rel": worst,
               "zero": zero_layers, "host_s": host_s, "limits": list(limits)}
    return summary, cap.calls


def flash_shape_checks(book, cfg, calls, dev, dtype, failures):
    """The flash kernels of one type against their plain versions: both
    backward passes at the captured trained layers (layer 0 timed, with the
    forward), then forward and backward at the long shape (timed) and at the
    edges (every head dim; ragged Sq / Sk; G = 1, 2, 8; q_offset / kv_len;
    non-causal; q and k over 2^+-3), all in the model layout read through
    strides."""
    import torch

    from repro_torch.kernels.cuda import FLASH_HEAD_DIMS
    from repro_torch.kernels.flash_attention.kernel import flash_fwd

    n_layers = cfg.n_layers
    for idx in (0, n_layers - 1):
        if idx not in calls:
            failures.append(f"{LM_ARCH} train {dtype}: backward call {idx} not captured")
            continue
        args, kw = calls[idx]
        layer = n_layers - 1 - idx
        check_flash_bwd(book, f"trained layer {layer}", args, kw, timed=(layer == 0))
        if layer == 0:  # the forward at the trained shape: out, m and l
            check_flash(book, "trained layer 0", args[:3], kw, timed=True)
    gen = torch.Generator(device=dev).manual_seed(6)

    def operands(b, sq, kvh, g, sk, d, kw, wide=False):
        q = torch.randn((b, sq, kvh, g, d), generator=gen, device=dev)
        k = torch.randn((b, sk, kvh, d), generator=gen, device=dev)
        v = torch.randn((b, sk, kvh, d), generator=gen, device=dev)
        if wide:  # q and k elementwise times 2^e, e uniform over -3..3
            for t in (q, k):
                t.mul_(torch.exp2(torch.randint(-3, 4, t.shape, generator=gen,
                                                device=dev).float()))
        q, k, v = (t.to(dtype) for t in (q, k, v))
        with torch.no_grad():
            out, m, l = flash_fwd(q, k, v, **kw)
        do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
        return q, k, v, out, m, l, do

    kvh, g, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
    lb, ls = LM_LONG["b"], LM_LONG["sq"]
    kw = dict(scale=d ** -0.5, causal=True, q_offset=0, kv_len=None)
    args = operands(lb, ls, kvh, g, ls, d, kw)
    if dtype == torch.bfloat16:  # the fp32 forward's long shape is the LM phase's
        check_flash(book, "long 2048x2048 causal", args[:3], kw, timed=True)
    check_flash_bwd(book, "long 2048x2048 causal", args, kw, timed=True)
    del args
    torch.cuda.empty_cache()
    edges = [(2, 37, 2, 2, 53, hd, hd % 16 == 0, 0, None) for hd in FLASH_HEAD_DIMS]
    edges += [(3, 37, 1, 1, 53, 128, True, 16, None),
              (2, 70, 1, 8, 130, 64, True, 200, 250),
              (2, 65, 2, 8, 97, 256, False, 0, 80),
              (2, 1, 8, 2, 130, 128, True, 99, 100),
              (2, 40, 2, 2, 40, 128, True, -8, None)]
    edges = [e + (False,) for e in edges] + [(2, 384, 4, 2, 512, 128, True, 128, None, True)]
    for eb, esq, ekv, eg, esk, ed, causal, qo, kvl, wide in edges:
        ekw = dict(scale=ed ** -0.5, causal=causal, q_offset=qo, kv_len=kvl)
        label = "edge, q and k over 2^+-3" if wide else "edge"
        args = operands(eb, esq, ekv, eg, esk, ed, ekw, wide)
        if dtype == torch.bfloat16:
            check_flash(book, label, args[:3], ekw, timed=False, wide=wide)
        check_flash_bwd(book, label, args, ekw, timed=False)


def remat_checks(cfg, batches, dev, failures) -> dict:
    """remat none / dots / full at full width and bf16, from the same
    weights: one loss and gradient computation (its peak device memory,
    max_memory_allocated, where the saved activations live; loss and leaves
    of "dots" and "full" against "none" within 1e-6 relative), then two
    train steps (the second step's peak, which AdamW's fp32 passes may set,
    its CUDA-event time, the device time of a traced warm step and the bf16
    forward launches)."""
    import torch

    from repro_torch.configs.base import DEFAULT_RUN
    from repro_torch.kernels.cuda import FLASH_ENTRY_LAUNCHES
    from repro_torch.launch.steps import (
        init_train_state,
        loss_and_grads,
        make_train_step,
        to_device,
    )
    from repro_torch.tree import tree_leaves

    out, ref = {}, None
    b0, b1 = (to_device(b, dev) for b in batches)
    for remat in ("none", "dots", "full"):
        run = DEFAULT_RUN.replace(remat=remat)
        state = init_train_state(cfg, run, torch.Generator().manual_seed(LM_TRAIN["seed"]),
                                 device=dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, grads = loss_and_grads(cfg, run, state.params, b0)
        torch.cuda.synchronize()
        grad_peak = torch.cuda.max_memory_allocated() - base
        loss, grads = float(loss), [g.float().cpu() for g in tree_leaves(grads)]
        if ref is None:
            ref = (loss, grads)
        step = make_train_step(cfg, run, 10, device=dev)
        step(state, b0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fwd0 = FLASH_ENTRY_LAUNCHES["repro_flash_fwd_bf16"]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, b1)
        end.record()
        torch.cuda.synchronize()
        fwd = FLASH_ENTRY_LAUNCHES["repro_flash_fwd_bf16"] - fwd0
        peak = torch.cuda.max_memory_allocated()
        br = trace_breakdown(lambda: step(state, b1))
        loss_rel = abs(loss - ref[0]) / abs(ref[0])
        leaf_rel = max(float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
                       for g, r in zip(grads, ref[1]))
        out[remat] = {"grad_peak_above_state_gb": grad_peak / 1e9,
                      "peak_gb": peak / 1e9, "state_gb": base / 1e9,
                      "above_state_gb": (peak - base) / 1e9, "step_ms": start.elapsed_time(end),
                      "device_ms": br["device_ms"], "wall_ms": br["wall_ms"],
                      "idle_share": br["idle_share"], "fwd_launches": fwd,
                      "loss": loss, "loss_rel_vs_none": loss_rel, "leaf_rel_vs_none": leaf_rel}
        want_fwd = cfg.n_layers * (1 if remat == "none" else 2)
        print(f"{LM_ARCH} remat {remat}: loss and gradients peak {grad_peak / 1e9:.3f} GB above "
              f"the state; second step peak {peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f}"
              f" GB above the {base / 1e9:.3f} GB of params, moments and batch), step "
              f"{start.elapsed_time(end):.2f} ms (CUDA events), warm step device "
              f"{br['device_ms']:.2f} ms of {br['wall_ms']:.2f} ms wall (idle share "
              f"{br['idle_share']}), bf16 forward launches {fwd} (expected {want_fwd}); "
              f"loss {loss:.6f}, vs none: loss {loss_rel:.2e}, worst leaf {leaf_rel:.2e} "
              f"(limit 1e-6 relative)")
        if fwd != want_fwd:
            failures.append(f"remat {remat}: {fwd} forward launches, expected {want_fwd}")
        if not (loss_rel <= 1e-6 and leaf_rel <= 1e-6):
            failures.append(f"remat {remat}: loss or gradients differ from remat none")
        del state, step, grads
        torch.cuda.empty_cache()
    peaks = {k: v["grad_peak_above_state_gb"] for k, v in out.items()}
    ordered = peaks["full"] <= peaks["dots"] <= peaks["none"]
    print(f"{LM_ARCH} remat loss-and-gradients peak above the state, full <= dots <= none: "
          f"{ordered} ({peaks} GB)")
    if not ordered:
        failures.append(f"remat peak memory out of order: {peaks}")
    return out


def compression_checks(grads, dev, failures) -> dict:
    """`compress_grads` -> `decompress_grads` on one step's card gradients,
    int8 and topk (1%), two rounds so the second carries an error buffer:
    g + err_old = decompressed + err_new within 1e-6 * max|g| per leaf."""
    import torch

    from repro_torch.optim import compress_grads, decompress_grads, init_error_feedback
    from repro_torch.tree import tree_leaves

    out = {}
    for scheme in ("int8", "topk"):
        err = init_error_feedback(grads)
        gen = torch.Generator(device=dev).manual_seed(0)
        worst, ms = 0.0, []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            comp, new_err = compress_grads(grads, err, scheme=scheme, generator=gen)
            dec = decompress_grads(comp, scheme=scheme)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            for g, e0, d_, e1 in zip(*(tree_leaves(t) for t in (grads, err, dec, new_err))):
                g = g.float()
                lim = float(g.abs().max())
                gap = float((g + e0 - d_ - e1).abs().max())
                worst = max(worst, gap / lim if lim else gap)
            err = new_err
        ok = worst <= 1e-6
        print(f"{LM_ARCH} gradient compression {scheme}: g + err_old = decompressed + "
              f"err_new to {worst:.2e} of max|g| (limit 1e-6): {'ok' if ok else 'FAIL'}; "
              f"compress + decompress of {len(tree_leaves(grads))} leaves {ms[-1]:.1f} ms "
              f"(host wall)")
        if not ok:
            failures.append(f"gradient compression {scheme}: identity off by {worst}")
        out[scheme] = {"worst_rel": worst, "ms": ms}
    return out


def train_phase(book, dev, failures) -> dict:
    """Full-width qwen3-0.6b trained through `repro_torch.launch.train.train`
    at the reference launcher's types (bf16 params, fp32 moments, remat
    full): launch counters per step and per entry point, the model FLOPs per
    step, the final checkpoint's save time, a trace of one warm step, one
    step's gradients against the host's plain path, the bf16 flash kernels
    at the trained, long and edge shapes, remat none / dots / full, gradient
    compression; then an fp32 run through `init_train_state` /
    `make_train_step` with the same checks for the fp32 kernels; and restart
    equality at the reduced config."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import DEFAULT_RUN, get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels.cuda import FLASH_ENTRY_LAUNCHES
    from repro_torch.kernels.flash_attention.kernel import (
        flash_bwd,
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_fwd,
    )
    from repro_torch.launch.steps import (
        init_train_state,
        loss_and_grads,
        make_train_step,
        to_device,
    )
    from repro_torch.launch.train import train
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves

    cfg = get_config(LM_ARCH)
    n_layers, steps = cfg.n_layers, LM_TRAIN["steps"]
    gb, sl = LM_TRAIN["global_batch"], LM_TRAIN["seq_len"]
    n_params = cfg.n_params()
    flops_step = 6.0 * n_params * gb * sl
    wrappers = {"flash_fwd": flash_fwd, "flash_bwd": flash_bwd,
                "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv}

    def expect(n):
        return {"flash_fwd": 2 * n_layers * n, "flash_bwd": n_layers * n,
                "flash_bwd_dq": n_layers * n, "flash_bwd_dkv": n_layers * n}

    def expect_entries(n, t):
        return {f"repro_flash_fwd_{t}": 2 * n_layers * n,
                f"repro_flash_bwd_dq_{t}": n_layers * n,
                f"repro_flash_bwd_dkv_{t}": n_layers * n}

    def entries_since(before):
        return {k: n - before[k] for k, n in FLASH_ENTRY_LAUNCHES.items() if n != before[k]}

    summary = {"n_params": n_params, "model_flops_per_step": flops_step}
    tmp = Path(tempfile.mkdtemp(prefix="repro_torch_train_"))
    batch0 = make_pipeline(cfg, sl, gb, seed=LM_TRAIN["seed"]).batch_at(0)
    batch1 = make_pipeline(cfg, sl, gb, seed=LM_TRAIN["seed"]).batch_at(1)
    try:
        # ---- the main run: train() at the reference launcher's defaults ----
        reset_counts(wrappers)
        before = dict(FLASH_ENTRY_LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, hist = train(LM_ARCH, reduced=False, steps=steps, global_batch=gb,
                            seq_len=sl, ckpt_dir=str(tmp / "main"),
                            checkpoint_every=10 * steps, resume=False,
                            seed=LM_TRAIN["seed"], device=dev)
        wall = time.perf_counter() - t0
        launches = read_counts(wrappers)
        entries = entries_since(before)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for h in hist:
            print(f"{LM_ARCH} train step {h['step']}: loss {h['loss']:.5f} grad_norm "
                  f"{h['grad_norm']:.5f} lr {h['lr']:.3e} step {h['step_ms']:.1f} ms "
                  f"(synchronised) {gb * sl / h['step_ms'] * 1e3:.0f} tok/s, "
                  f"{flops_step / h['step_ms'] / 1e9:.1f} model TFLOP/s (6 N tokens)")
        per_step = {k: v / max(len(hist), 1) for k, v in entries.items()}
        dtypes = sorted({str(t.dtype) for t in tree_leaves(state.params)})
        mdtypes = sorted({str(t.dtype) for t in tree_leaves(state.opt.m)})
        print(f"{LM_ARCH} trained {len(hist)} steps (batch {gb} x {sl}, remat full, params "
              f"{dtypes}, moments {mdtypes}) in {wall:.2f} s with set-up and the final "
              f"checkpoint; n_params {n_params:,}, 6 N tokens = {flops_step:.4e} FLOP per "
              f"step; launches {launches} (expected {expect(steps)}); per entry point "
              f"{entries} = {per_step} per step (expected {expect_entries(steps, 'bf16')}); "
              f"peak device memory {peak_gb:.2f} GB")
        if launches != expect(steps) or entries != expect_entries(steps, "bf16"):
            failures.append(f"{LM_ARCH} train: launches {launches} / {entries}, expected "
                            f"{expect(steps)} / {expect_entries(steps, 'bf16')}")
        if dtypes != ["torch.bfloat16"] or mdtypes != ["torch.float32"]:
            failures.append(f"{LM_ARCH} train: params {dtypes}, moments {mdtypes}")
        if len(hist) != steps or not all(np.isfinite(h["loss"]) and np.isfinite(
                h["grad_norm"]) for h in hist):
            failures.append(f"{LM_ARCH} train: history malformed or not finite")
        warm = hist[1:]
        med = sorted(h["step_ms"] for h in warm)[len(warm) // 2]
        summary["main"] = {
            "history": hist, "launches": launches, "entries": entries, "wall_s": wall,
            "peak_gb": peak_gb, "step_ms_warm_median": med,
            "tok_s_warm": gb * sl * len(warm) / sum(h["step_ms"] for h in warm) * 1e3,
            "model_tflops_warm_median": flops_step / med / 1e9}

        # ---- the final checkpoint's size and save time ----------------------
        ck = CheckpointManager(tmp / "save", keep=1)
        nbytes = sum(t.numel() * t.element_size() for t in
                     tree_leaves(state.params) + tree_leaves(state.opt.m)
                     + tree_leaves(state.opt.v))
        t0 = time.perf_counter()
        ck.save(steps, state, extra={"step": steps}, block=True)
        save_s = time.perf_counter() - t0
        ck.close()
        print(f"{LM_ARCH} checkpoint of params + m + v ({nbytes / 1e9:.2f} GB): "
              f"save {save_s:.2f} s (host copy + npz write + atomic commit)")
        summary["save"] = {"bytes": nbytes, "save_s": save_s}
        shutil.rmtree(tmp / "save", ignore_errors=True)

        # ---- where the time goes: one warm bf16 train step -----------------
        run = DEFAULT_RUN.replace(remat="full")
        step_fn = make_train_step(cfg, run, steps, device=dev)
        br = trace_breakdown(lambda: step_fn(state, batch0), {"batch": gb, "seq": sl})
        summary["service"] = br
        print(f"{LM_ARCH} warm bf16 train step: wall {br['wall_ms']:.3f} ms (median of 5), "
              f"device {br['device_ms']:.3f} ms in {br['device_ops']} device ops, "
              f"idle share {br['idle_share']}")
        for cat, ms in sorted(br["by_class_ms"].items(), key=lambda kv: -kv[1]):
            print(f"  {ms:8.3f} ms  {cat}")
        for k in br["top_kernels"]:
            print(f"  top {k['ms']:8.3f} ms x{k['count']}  {k['name']}")
        del state, step_fn
        torch.cuda.empty_cache()

        # ---- one step's gradients at bf16, card against the host -----------
        summary["grads_vs_host"], calls = grads_vs_host(
            cfg, run, batch0, dev, failures, limits=(1e-2, 3e-2, 5e-2), tag="bf16")
        torch.cuda.empty_cache()
        print(f"{LM_ARCH} bf16 flash kernel checks ({KERNEL_TOL.split('; ')[-1]}):")
        flash_shape_checks(book, cfg, calls, dev, torch.bfloat16, failures)
        del calls
        torch.cuda.empty_cache()

        # ---- remat none / dots / full; gradient compression ----------------
        summary["remat"] = remat_checks(cfg, (batch0, batch1), dev, failures)
        params = M.init_params(cfg, torch.Generator().manual_seed(LM_TRAIN["seed"]),
                               device=dev, dtype=torch.bfloat16)
        _, grads = loss_and_grads(cfg, run, params, to_device(batch0, dev))
        del params
        summary["compression"] = compression_checks(grads, dev, failures)
        del grads
        torch.cuda.empty_cache()

        # ---- the fp32 trainer: init_train_state / make_train_step ----------
        run32 = DEFAULT_RUN.replace(remat="full", param_dtype="float32")
        n32 = LM_TRAIN_FP32_STEPS
        state = init_train_state(cfg, run32, torch.Generator().manual_seed(LM_TRAIN["seed"]),
                                 device=dev)
        step_fn = make_train_step(cfg, run32, steps, device=dev)
        pipe = make_pipeline(cfg, sl, gb, seed=LM_TRAIN["seed"])
        reset_counts(wrappers)
        before = dict(FLASH_ENTRY_LAUNCHES)
        hist32 = []
        for i in range(n32):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, pipe.batch_at(i))
            loss = float(m["loss"])
            hist32.append({"step": i, "loss": loss, "grad_norm": float(m["grad_norm"]),
                           "step_ms": (time.perf_counter() - t0) * 1e3})
        launches = read_counts(wrappers)
        entries = entries_since(before)
        print(f"{LM_ARCH} fp32 trainer (init_train_state / make_train_step, param_dtype "
              f"float32): {n32} steps, losses {[round(h['loss'], 5) for h in hist32]}, step "
              f"ms {[round(h['step_ms'], 1) for h in hist32]}; launches {launches} "
              f"(expected {expect(n32)}); per entry point {entries} (expected "
              f"{expect_entries(n32, 'f32')})")
        if launches != expect(n32) or entries != expect_entries(n32, "f32"):
            failures.append(f"{LM_ARCH} fp32 train: launches {launches} / {entries}")
        if not all(np.isfinite(h["loss"]) for h in hist32):
            failures.append(f"{LM_ARCH} fp32 train: loss not finite")
        br32 = trace_breakdown(lambda: step_fn(state, batch0), {"batch": gb, "seq": sl})
        summary["fp32"] = {"history": hist32, "launches": launches, "entries": entries,
                           "service": br32}
        print(f"{LM_ARCH} warm fp32 train step: wall {br32['wall_ms']:.3f} ms (median of "
              f"5), device {br32['device_ms']:.3f} ms in {br32['device_ops']} device ops, "
              f"idle share {br32['idle_share']}")
        for cat, ms in sorted(br32["by_class_ms"].items(), key=lambda kv: -kv[1]):
            print(f"  {ms:8.3f} ms  {cat}")
        del state, step_fn
        torch.cuda.empty_cache()
        summary["fp32"]["grads_vs_host"], calls = grads_vs_host(
            cfg, run32, batch0, dev, failures, limits=(1e-4, 1e-3, 1e-3), tag="fp32")
        torch.cuda.empty_cache()
        print(f"{LM_ARCH} fp32 flash backward kernel checks ({KERNEL_TOL.split(';')[0]}):")
        flash_shape_checks(book, cfg, calls, dev, torch.float32, failures)
        del calls
        torch.cuda.empty_cache()

        # ---- restart on the card at the reduced config (bf16) --------------
        losses = {}
        for tag, fail_at in (("uninterrupted", ()), ("failed", LM_RESTART["fail_at"])):
            _, h = train(LM_ARCH, reduced=True, steps=LM_RESTART["steps"],
                         global_batch=LM_RESTART["global_batch"],
                         seq_len=LM_RESTART["seq_len"], ckpt_dir=str(tmp / tag),
                         checkpoint_every=LM_RESTART["checkpoint_every"],
                         fail_at=fail_at, resume=False, seed=7, device=dev)
            losses[tag] = {x["step"]: x["loss"] for x in h}
        a, b = losses["uninterrupted"], losses["failed"]
        same = sorted(a) == sorted(b) and all(a[s_] == b[s_] for s_ in a)
        diff = max(abs(a[s_] - b[s_]) for s_ in a) if sorted(a) == sorted(b) else float("inf")
        print(f"{LM_ARCH} reduced restart on the card at bf16 ({LM_RESTART['steps']} steps, "
              f"failure at {LM_RESTART['fail_at']}, checkpoints every "
              f"{LM_RESTART['checkpoint_every']}): losses bitwise equal {same} (max |loss "
              f"difference| {diff:.3e}): {'ok' if same else 'FAIL'}")
        if not same:
            failures.append(f"{LM_ARCH} train: restart changed the losses by {diff}")
        summary["restart_max_loss_diff"] = diff
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return summary


# ---- the paper's methods as plain oracles, and the static verifier --------

# ---------------------------------------------------------------------------
# the dense LM family beyond qwen3-0.6b: minitron-8b (block-ECR relu2 FFN) and
# stablelm-12b (head dim 160) served at full width, all three trained reduced
# ---------------------------------------------------------------------------

DIST_TRAIN = dict(steps=3, global_batch=4, seq_len=128, seed=0)
DIST_MESHES = ((2, 1), (1, 2))
DIST_LIMITS = (1e-2, 3e-2, 5e-2)  # loss, grad norm (relative), worst leaf (of max|leaf|)
DIST_DELTA_LIMIT = 0.2  # each leaf's change in norm, of the unsharded change's (bf16)
DIST_PIPE_DIMS = (16, 1024)  # the reference test's case (L 8, M 6, mb 4) at two widths
DIST_ENTRIES = ("repro_flash_fwd_bf16", "repro_flash_bwd_dq_bf16", "repro_flash_bwd_dkv_bf16")


def distributed_rank(rank, world, port, out_dir, backend):
    """One rank of the distributed phase (step 9b): gloo ranks sharing
    cuda:0, or NCCL ranks with a card each. Writes its numbers to
    out_dir/rank_<rank>.json."""
    sys.path.insert(0, str(ROOT / "src"))
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    import os

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    from repro_torch.configs.base import DEFAULT_RUN, ShapeConfig, get_config
    from repro_torch.data import make_pipeline
    from repro_torch.launch.mesh import rank_device
    from repro_torch.launch.steps import TrainState, init_train_state, make_train_step
    from repro_torch.launch.train import ShardedTrainStep, build_trainer
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import OptState
    from repro_torch.parallel import ProcessMesh, gather_tree
    from repro_torch.parallel.pipeline import pipeline_apply, split_stages
    from repro_torch.runtime import rebalance_grad_accum, reshard_state, shrink_mesh
    from repro_torch.tree import state_leaves, tree_leaves

    dev = rank_device("cuda:0", backend)
    torch.cuda.init()  # the allocator's statistics exist from here
    cfg = get_config(LM_ARCH)
    # bf16 params, fp32 moments, remat full; no warm-up, so that every step
    # moves the state at the peak rate
    run = DEFAULT_RUN.replace(warmup_steps=0)
    steps, gb, sl = DIST_TRAIN["steps"], DIST_TRAIN["global_batch"], DIST_TRAIN["seq_len"]
    shape = ShapeConfig("distributed", sl, gb, "train")
    pipe = make_pipeline(cfg, sl, gb, seed=DIST_TRAIN["seed"])
    res = {"rank": rank, "device": str(dev), "backend": backend}

    def change_err(changes):
        """The worst leaf's ||got - want|| / ||want|| over (got, want) pairs,
        one a leaf, of the change a run made to it: against the unsharded
        run's change."""
        return max(float((g - w).norm() / w.norm().clamp_min(1e-30)) for g, w in changes)

    transient = [0.0]  # the most a step allocated above what was held before it, GiB

    def timed_steps(step_fn, state, first, n):
        hist, ms = [], []
        for s in range(first, first + n):
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            state, m = step_fn(state, pipe.batch_at(s))
            hist.append((float(m["loss"]), float(m["grad_norm"])))
            ms.append((time.perf_counter() - t0) * 1e3)
            transient[0] = max(transient[0],
                               (torch.cuda.max_memory_allocated(dev) - base) / 2**30)
        return state, hist, ms

    def state_gib(state):
        return sum(t.numel() * t.element_size() for t in state_leaves(state)) / 2**30

    # the unsharded trainer on rank 0's card (the other ranks wait at the
    # barrier); its parameters kept after each step (copies: the step
    # updates them in place)
    ref_params = None  # rank 0's unsharded parameters, [p0, p1, .., p_steps]
    if rank == 0:
        state = init_train_state(cfg, run, torch.Generator().manual_seed(DIST_TRAIN["seed"]),
                                 device=dev)
        ref_params = [[p.clone() for p in tree_leaves(state.params)]]
        step_fn = make_train_step(cfg, run, steps, device=dev)
        hist, ms = [], []
        transient[0] = 0.0
        for s in range(steps):
            state, h, m = timed_steps(step_fn, state, s, 1)
            hist, ms = hist + h, ms + m
            ref_params.append([p.clone() for p in tree_leaves(state.params)])
        res["unsharded"] = {"hist": hist, "ms": ms, "state_gib": state_gib(state),
                            "step_gib": transient[0]}
        del state, step_fn
    dist.barrier()

    # the sharded trainer on each mesh; on (2, 1) the whole state after step 1
    # is kept for the elastic check
    from repro_torch.kernels import cuda as kcuda

    snapshot = None
    for shp in DIST_MESHES:
        mesh = ProcessMesh(shp, ("data", "model"), device=dev)
        # what the built state holds on the card: the allocator's count
        # before and after (the whole draw is freed inside)
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        step_fn, state = build_trainer(cfg, run, shape, mesh, steps, DIST_TRAIN["seed"])
        torch.cuda.synchronize(dev)
        built = torch.cuda.memory_allocated(dev) - held
        transient[0] = 0.0
        before = {k: kcuda.FLASH_ENTRY_LAUNCHES[k] for k in DIST_ENTRIES}
        hist, ms = [], []
        for s in range(steps):
            state, h, m = timed_steps(step_fn, state, s, 1)
            hist, ms = hist + h, ms + m
            if shp == (2, 1) and s == 0:
                snapshot = (mesh, gather_tree(state, step_fn.specs, mesh))
        launches = {k: kcuda.FLASH_ENTRY_LAUNCHES[k] - before[k] for k in DIST_ENTRIES}
        whole = gather_tree(state.params, step_fn.specs.params, mesh)
        entry = {"hist": hist, "ms": ms, "state_gib": state_gib(state), "step_gib": transient[0],
                 "launches": launches, "param_shard_gib": state_gib(state.params),
                 "built_gib": built / 2**30, "state_tensors": len(state_leaves(state))}
        if rank == 0:
            entry["worst_leaf"] = max(
                float((a.float() - b.float()).abs().max() / b.float().abs().max())
                for a, b in zip(tree_leaves(whole), ref_params[steps]))
            entry["worst_delta"] = change_err(
                (a.float() - p0.float(), b.float() - p0.float())
                for a, b, p0 in zip(tree_leaves(whole), ref_params[steps], ref_params[0]))
        res[f"{shp[0]}x{shp[1]}"] = entry
        del whole, state, step_fn
        torch.cuda.empty_cache()

    # elastic: from the (2, 1) state after step 1, shrink to (1, 1) at
    # grad_accum 2, reshard the gathered arrays, take step 2
    mesh, whole = snapshot
    del snapshot
    new = shrink_mesh(mesh, lost_data_slices=1)
    run2 = rebalance_grad_accum(run, mesh, new)
    el = {"member": new.member, "grad_accum": run2.grad_accum,
          "hist0": res["2x1"]["hist"][:1]}
    if new.member:
        paxes = M.param_axes(cfg)
        axes = TrainState(params=paxes, opt=OptState(step=(), m=paxes, v=paxes))
        state = reshard_state(whole, axes, new)
        # p1 copied: on (1, 1) the resharded state is the gathered arrays
        p1 = [t.clone() for t in tree_leaves(whole.params)] if rank == 0 else None
        del whole
        step2 = ShardedTrainStep(cfg, run2, shape, new, steps, dev)
        state, hist1, ms1 = timed_steps(step2, state, 1, 1)
        el.update(hist1=hist1, ms=ms1, new_shape=new.shape)
        if rank == 0:  # step 2's own change to each leaf, on the resharded moments
            p2 = gather_tree(state.params, step2.specs.params, new)
            el["step2_delta"] = change_err(
                (a.float() - b.float(), c.float() - d.float())
                for a, b, c, d in zip(tree_leaves(p2), p1, ref_params[2], ref_params[1]))
        del state, p1
    else:
        del whole
    res["elastic"] = el
    del ref_params
    torch.cuda.empty_cache()
    dist.barrier()

    # GPipe over the ranks on ("pod",)
    mesh = ProcessMesh((world,), ("pod",), device=dev)
    res["pipeline"] = {}
    for d in DIST_PIPE_DIMS:
        rng = np.random.default_rng(0)
        ws = torch.from_numpy((rng.standard_normal((8, d, d)) * 1.2 / np.sqrt(d))
                              .astype(np.float32)).to(dev)
        x = torch.from_numpy(rng.standard_normal((6, 4, d)).astype(np.float32)).to(dev)

        def stage_fn(sp, h):
            for i in range(sp.shape[0]):
                h = torch.tanh(h @ sp[i])
            return h

        stages = split_stages(ws, world).requires_grad_(True)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        y = pipeline_apply(stage_fn, stages, x, mesh=mesh, axis="pod")
        (y ** 2).sum().backward()
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        seq_w = ws.clone().requires_grad_(True)
        h = x
        for i in range(seq_w.shape[0]):
            h = torch.tanh(h @ seq_w[i])
        (h ** 2).sum().backward()
        s = mesh.coords["pod"]
        g_ref = split_stages(seq_w.grad, world)
        others = torch.cat([stages.grad[:s], stages.grad[s + 1:]])
        res["pipeline"][str(d)] = {
            "stage": s, "ms": ms, "y_err": float((y - h).abs().max()),
            "y_scale": float(h.abs().max()),
            "grad_err": float((stages.grad[s] - g_ref[s]).abs().max()),
            "grad_scale": float(g_ref[s].abs().max()),
            "other_stages_grad": float(others.abs().sum())}
    (Path(out_dir) / f"rank_{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def distributed_phase(failures) -> dict:
    """Step 9b: full-width qwen3-0.6b trained by the sharded trainer over 2
    gloo ranks sharing the card, on meshes (2, 1) and (1, 2), against the
    unsharded trainer in the same run; elastic shrink; GPipe. Over NCCL
    with a card per rank where the machine has 2 cards."""
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from repro_torch.configs.base import get_config

    def free_port():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 2 else [])
    if "nccl" not in backends:
        print(f"distributed nccl: not run, {torch.cuda.device_count()} card (one card a "
              "rank needs 2)")
    lim = DIST_LIMITS
    summary = {}
    for backend in backends:
        t0 = time.perf_counter()
        out = Path(tempfile.mkdtemp(prefix="repro_torch_dist_"))
        mp.spawn(distributed_rank, args=(2, free_port(), str(out), backend), nprocs=2)
        ranks = [json.loads((out / f"rank_{r}.json").read_text()) for r in range(2)]
        wall = time.perf_counter() - t0
        base = ranks[0]["unsharded"]
        print(f"distributed {backend}: unsharded {LM_ARCH} bf16 B {DIST_TRAIN['global_batch']} "
              f"x S {DIST_TRAIN['seq_len']} on rank 0: step ms "
              f"{[round(m, 2) for m in base['ms']]}, state {base['state_gib']:.3f} GiB + a "
              f"step's transient {base['step_gib']:.3f} GiB = "
              f"{base['state_gib'] + base['step_gib']:.3f}, "
              f"loss {[round(h[0], 5) for h in base['hist']]}")
        want = train_entries(get_config(LM_ARCH), DIST_TRAIN["steps"])
        for shp in DIST_MESHES:
            key = f"{shp[0]}x{shp[1]}"
            for r in ranks:
                e = r[key]
                errs = [(abs(a[0] - b[0]) / abs(b[0]), abs(a[1] - b[1]) / abs(b[1]))
                        for a, b in zip(e["hist"], base["hist"])]
                print(f"distributed {backend} {key} rank {r['rank']} ({r['device']}): step ms "
                      f"{[round(m, 2) for m in e['ms']]}, state shards {e['state_gib']:.3f} "
                      f"GiB + a step's transient {e['step_gib']:.3f} GiB = "
                      f"{e['state_gib'] + e['step_gib']:.3f} vs unsharded "
                      f"{base['state_gib'] + base['step_gib']:.3f}, param shard "
                      f"{e['param_shard_gib']:.3f} GiB, launches {e['launches']}, loss / "
                      f"grad norm rel err {[(f'{a:.2e}', f'{b:.2e}') for a, b in errs]}"
                      + (f", worst leaf {e['worst_leaf']:.3e}, worst leaf change "
                         f"{e['worst_delta']:.3e}" if "worst_leaf" in e else ""))
                if any(a > lim[0] or b > lim[1] for a, b in errs):
                    failures.append(f"distributed {backend} {key} rank {r['rank']}: loss or "
                                    f"grad norm off the unsharded trainer's")
                if e.get("worst_leaf", 0.0) > lim[2]:
                    failures.append(f"distributed {backend} {key}: worst leaf "
                                    f"{e['worst_leaf']:.3e} > {lim[2]}")
                if e.get("worst_delta", 0.0) > DIST_DELTA_LIMIT:
                    failures.append(f"distributed {backend} {key}: worst leaf change "
                                    f"{e['worst_delta']:.3e} > {DIST_DELTA_LIMIT}")
                if e["launches"] != {k: want[k] for k in DIST_ENTRIES}:
                    failures.append(f"distributed {backend} {key} rank {r['rank']}: launches "
                                    f"{e['launches']}, want {want}")
        kept = [r["elastic"] for r in ranks if r["elastic"]["member"]]
        for r in ranks:
            el = r["elastic"]
            line = (f"distributed {backend} elastic rank {r['rank']}: on (2, 1) step 1 loss "
                    f"{el['hist0'][0][0]:.5f}; shrink -> member {el['member']}, grad_accum "
                    f"{el['grad_accum']}")
            if el["member"]:
                a, b = el["hist1"][0], base["hist"][1]
                ea, eb = abs(a[0] - b[0]) / abs(b[0]), abs(a[1] - b[1]) / abs(b[1])
                line += (f", {el['new_shape']} step 2 {el['ms'][0]:.2f} ms, loss / grad norm "
                         f"rel err to the unsharded step 2 {ea:.2e} / {eb:.2e}")
                if "step2_delta" in el:
                    line += (f", step 2's change to the worst leaf {el['step2_delta']:.3e} of "
                             f"the unsharded step 2's")
                if ea > lim[0] or eb > lim[1] or el.get("step2_delta", 0.0) > DIST_DELTA_LIMIT:
                    failures.append(f"distributed {backend} elastic: step 2 off the "
                                    f"unsharded trainer's")
            print(line)
        if len(kept) != 1 or any(r["elastic"]["grad_accum"] != 2 for r in ranks):
            failures.append(f"distributed {backend} elastic: {len(kept)} ranks kept, grad_accum "
                            f"{[r['elastic']['grad_accum'] for r in ranks]}")
        for d in DIST_PIPE_DIMS:
            for r in ranks:
                pr = r["pipeline"][str(d)]
                ok = (pr["y_err"] <= 2e-4 * max(1.0, pr["y_scale"])
                      and pr["grad_err"] <= 2e-4 * max(1.0, pr["grad_scale"])
                      and pr["other_stages_grad"] == 0.0)
                print(f"distributed {backend} pipeline D {d} rank {r['rank']} (stage "
                      f"{pr['stage']}): forward + backward {pr['ms']:.2f} ms, output err "
                      f"{pr['y_err']:.2e} (max {pr['y_scale']:.3f}), stage grad err "
                      f"{pr['grad_err']:.2e} (max {pr['grad_scale']:.3e}), other stages' "
                      f"grad {pr['other_stages_grad']}")
                if not ok:
                    failures.append(f"distributed {backend} pipeline D {d} rank {r['rank']} "
                                    f"off the sequential stack")
        print(f"distributed {backend}: phase {wall:.1f} s")
        summary[backend] = {"ranks": ranks, "seconds": wall}
    return summary


DRYRUN_CELLS = ("decode_32k", "prefill_32k", "train_4k")
DRYRUN_STATE_TOL = 5e-3  # predicted state of a rank against its allocation on the card


def dryrun_records(out_dir) -> dict:
    """Step 9c's records from a subprocess of their own: the production
    cells (`run_cell`, 16x16) and step 9b's cell on fake (2, 1) and (1, 2)
    meshes (`dry_run_cell`)."""
    code = f"""
import json, sys, time
from repro_torch.configs.base import DEFAULT_RUN, ShapeConfig, get_config
from repro_torch.launch.dryrun import dry_run_cell, fake_world, run_cell
from repro_torch.parallel.api import ProcessMesh
recs = {{}}
for shape in {DRYRUN_CELLS!r}:
    t0 = time.perf_counter()
    recs[shape] = run_cell({LM_ARCH!r}, shape, False, force=True, out_dir={str(out_dir)!r})
    recs[shape]["cell_wall_s"] = time.perf_counter() - t0
cfg = get_config({LM_ARCH!r})
shape = ShapeConfig("distributed", {DIST_TRAIN['seq_len']}, {DIST_TRAIN['global_batch']}, "train")
run = DEFAULT_RUN.replace(warmup_steps=0)
for shp in {DIST_MESHES!r}:
    with fake_world(2):
        mesh = ProcessMesh(shp, ("data", "model"), device="cpu")
        recs[f"{{shp[0]}}x{{shp[1]}}"] = dry_run_cell(cfg, shape, run, mesh)
print(json.dumps(recs))
"""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=str(ROOT), timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"dry-run subprocess exited {r.returncode}: {r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def dryrun_phase(dev, distributed, failures) -> dict:
    """Step 9c: the dry run's production cells, its prediction of step 9b's
    memory, and `hlo_model_us` in the autotuner against a captured runner."""
    import importlib
    import shutil
    import tempfile
    import timeit

    import torch

    from repro_torch.configs.vgg19_sparse import CNNConfig, vgg19_graph
    from repro_torch.launch.serve_cnn import synth_requests
    from repro_torch.serving.graph_runner import CompiledRunner

    t0 = time.perf_counter()
    out = Path(tempfile.mkdtemp(prefix="repro_torch_dryrun_"))
    try:
        recs = dryrun_records(out)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    sub_s = time.perf_counter() - t0
    # (a) the production cells
    for shape in DRYRUN_CELLS:
        r = recs[shape]
        if r.get("status") != "ok":
            failures.append(f"dry run {LM_ARCH} {shape} 16x16: status {r.get('status')} "
                            f"{r.get('error', r.get('reason', ''))}")
            continue
        c = r["collectives"]
        print(f"dry run {LM_ARCH} {shape} 16x16 (256 fake ranks): FLOPs {r['hlo_flops_per_device']:.4e}"
              f", bytes {r['hlo_bytes_per_device']:.4e}, collectives {c['bytes_by_kind']} "
              f"(counts {c['counts']}; by link {r['collective_bytes_by_link']}), terms compute "
              f"{r['compute_term_s']:.4e} s / memory {r['memory_term_s']:.4e} s / collective "
              f"{r['collective_term_s']:.4e} s, dominant {r['dominant_term']}, useful_flop_ratio "
              f"{r['useful_flop_ratio']:.5f}, memory {r['memory_analysis']}, pallas_flash "
              f"{r.get('pallas_flash')}, trace {r['trace_s']:.2f} s (cell {r['cell_wall_s']:.2f} s)")
        if not (r["hlo_flops_per_device"] > 0 and r["hlo_bytes_per_device"] > 0
                and c["total_bytes"] > 0):
            failures.append(f"dry run {LM_ARCH} {shape}: a zero FLOP, byte or collective count")
    # (b) step 9b's cell against what step 9b measured
    ranks = distributed.get("gloo", {}).get("ranks", [])
    pred = {}
    for shp in DIST_MESHES:
        key = f"{shp[0]}x{shp[1]}"
        r = recs[key]
        if r.get("status") != "ok":
            failures.append(f"dry run of step 9b's cell on {shp}: status {r.get('status')} "
                            f"{r.get('error', '')}")
            continue
        state = r["argument_bytes"]["state"] / 2**30
        temp = r["memory_analysis"]["temp_size_in_bytes"] / 2**30
        pred[key] = {"state_gib": state, "transient_gib": temp, "flops": r["hlo_flops_per_device"],
                     "collectives": r["collectives"]["bytes_by_kind"], "trace_s": r["trace_s"]}
        if not ranks:
            failures.append(f"dry run {key}: step 9b measured nothing to hold the prediction to")
            continue
        for rk in ranks:
            m = rk[key]
            # measured: the allocator's count across build_trainer, which
            # rounds each tensor up to 512 bytes
            got = m["built_gib"]
            err = abs(state - got) / got
            print(f"dry run prediction {key} rank {rk['rank']}: state {state:.6f} GiB against "
                  f"the {got:.6f} GiB step 9b's build_trainer left allocated on the card "
                  f"({(got - state) * 2**30:.0f} B apart; the allocator's 512-byte rounding of "
                  f"its {m['state_tensors']} tensors adds at most "
                  f"{m['state_tensors'] * 512} B; rel err {err:.2e}, limit {DRYRUN_STATE_TOL}); "
                  f"a step's transient {temp:.3f} GiB against step 9b's {m['step_gib']:.3f} "
                  f"(ratio {temp / m['step_gib']:.3f}); FLOPs {r['hlo_flops_per_device']:.4e}, "
                  f"collectives {r['collectives']['bytes_by_kind']}, trace {r['trace_s']:.2f} s")
            if err > DRYRUN_STATE_TOL:
                failures.append(f"dry run {key}: predicted state {state:.6f} GiB off the "
                                f"{got:.6f} allocated on the card by {err:.2e}")
    # (c) hlo_model_us in the autotuner's model ranking, VGG-19 at batch 8
    A = importlib.import_module("repro_torch.serving.autotune")
    graph = vgg19_graph(CNNConfig())
    params, _, _ = make_params(graph, seed=0, dev=dev)
    calib = torch.stack(synth_requests(graph, 8, seed=300, device=dev))
    routes = []
    real_hlo, real_plan = A.hlo_model_us, A.plan_model_us
    A.hlo_model_us = lambda fn, *a: routes.append("hlo_model_us") or real_hlo(fn, *a)
    A.plan_model_us = lambda *a, **k: routes.append("plan_model_us") or real_plan(*a, **k)
    try:
        t1 = time.perf_counter()
        res = A.autotune(params, calib, graph, mode="model", use_pallas=False)
        tune_s = time.perf_counter() - t1
    finally:
        A.hlo_model_us, A.plan_model_us = real_hlo, real_plan
    for c in res.candidates:
        print(f"dry run autotune VGG-19 batch 8 occ_threshold {c.occ_threshold} block_c "
              f"{c.block_c}: model_us {c.model_us:.2f}, counts {c.plan.counts()}")
    kernel_free = all(not A.get_op(lp.kind, lp.impl).pallas
                      for c in res.candidates for lp in c.plan.layers)
    distinct = len({A.plan_key(8, c.plan) for c in res.candidates})
    print(f"dry run autotune: routes {routes} for {distinct} distinct kernel-free plans "
          f"({kernel_free}); picked {plan_line(res.plan)} in {tune_s:.2f} s")
    if not kernel_free or routes != ["hlo_model_us"] * distinct:
        failures.append(f"dry run autotune: _model_us took {routes} for {distinct} "
                        "kernel-free plans")
    best_us = real_hlo(A._runner_for(res.plan), params, calib)
    runner = CompiledRunner(res.plan, params, 8, dev)
    try:
        dev_ms = time_turns({"replay": lambda: runner(params, calib, 8)})["replay"]
    finally:
        runner.release()
    print(f"dry run autotune: the chosen plan's hlo_model_us {best_us:.2f} us against its "
          f"captured runner's device time {dev_ms * 1e3:.2f} us (ratio "
          f"{best_us / (dev_ms * 1e3):.3f}; the eager count ignores L2 residency: no gate)")
    # (d) what an attention call's scope costs the host, outside a count
    # (the serving path) and inside one
    from repro_torch.obs.scopes import counting, scope

    def scoped():
        with scope("flash_attention"):
            pass

    def bare():
        pass

    n = 200_000
    scope_ns = {}
    for name, fn, ctx in (("bare call", bare, None), ("scope outside a count", scoped, None),
                          ("scope inside a count", scoped, counting)):
        with ctx() if ctx else contextlib.nullcontext():
            scope_ns[name] = min(timeit.repeat(fn, number=n, repeat=5)) / n * 1e9
    print("dry run scope cost on the host: " + ", ".join(
        f"{k} {v:.1f} ns" for k, v in scope_ns.items()))
    wall = time.perf_counter() - t0
    print(f"dry-run phase: {wall:.1f} s (subprocess {sub_s:.1f} s)")
    return {"cells": recs, "prediction": pred, "autotune": [c.row() for c in res.candidates],
            "routes": routes, "chosen_hlo_model_us": best_us, "chosen_device_ms": dev_ms,
            "scope_ns": scope_ns, "seconds": wall}


DENSE_SERVE_ARCHS = ("minitron-8b", "stablelm-12b")
DENSE_TRAIN_ARCHS = ("minitron-8b", "stablelm-12b", "mistral-large-123b")
DENSE_SLICE_LAYERS = 2  # the full-width slice held against the host
DENSE_TRAIN = dict(steps=3, global_batch=4, seq_len=64, seed=0)
# How far the host's int8 cache scales may sit from the card's in the slice
# (relative): layer 1's K comes through layer 0's attention, whose scores
# reach ~1,500 here, so its output carries up to `score_widening(1500)` (7e-4)
# of fp32 rounding on either side, where qwen3's well-conditioned check
# holds 1e-5 (measured on the H100: 2.4e-5 and 3.5e-5 apart).
DENSE_SLICE_SCALE_TOL = 1e-4
# head dim 160 edges (b, sq, kvh, g, sk, causal, q_offset, kv_len): ragged
# Sq / Sk, causal with q_offset > 0, kv_len < Sk, decode, a fully masked block
DENSE_D160_EDGES = [(3, 37, 2, 4, 53, False, 0, None), (3, 37, 2, 4, 53, True, 16, None),
                    (2, 100, 1, 4, 300, True, 200, 290), (2, 1, 8, 4, 130, True, 99, 100),
                    (2, 8, 2, 4, 32, False, 0, 0)]


class capture_ffn:
    """Within the block, record the input of the model's first FFN call
    (layer 0 of a prefill), then run the call as usual."""

    def __enter__(self):
        import repro_torch.models.transformer as T

        self.T, self.orig, self.x = T, T.ffn_apply, None

        def rec(p, x, cfg):
            if self.x is None:
                self.x = x.detach().clone()
            return self.orig(p, x, cfg)

        T.ffn_apply = rec
        return self

    def __exit__(self, *exc):
        self.T.ffn_apply = self.orig


def logits_close(card, host) -> tuple:
    """(max|card - host|, max|host|, within rtol 1e-3 + 1e-3 * max|host| and
    finite) over lists of logits."""
    import numpy as np

    worst, scale, ok = 0.0, 0.0, True
    for c, h in zip(card, host):
        c, h = c.numpy(), h.numpy()
        s = float(np.abs(h).max())
        worst, scale = max(worst, float(np.abs(c - h).max())), max(scale, s)
        ok &= bool(np.all(np.isfinite(c))) and np.allclose(c, h, rtol=1e-3, atol=1e-3 * s)
    return worst, scale, ok


def card_vs_host(label, cfg, params, params_cpu, prompt, follow, kvd, dev, max_len,
                 failures, inputs=None) -> dict:
    """Teacher-forced logits of the same weights on the card and on the
    host's plain path (prefill + `follow`'s decode steps, fed `inputs` as
    `teacher_forced` takes them; for the int8 cache the host quantizes its
    own K/V, is held within one step and DENSE_SLICE_SCALE_TOL of the
    card's, then attends over the card's values, `pin_quantization`), at
    rtol 1e-3 + 1e-3*max|host|."""
    with pin_quantization("record") as rec:
        card = teacher_forced(cfg, params, prompt, follow, kvd, dev, max_len, inputs)
    t0 = time.perf_counter()
    with (pin_quantization("replay", rec.recorded) if kvd == "int8"
          else contextlib.nullcontext()) as pinned:
        host = teacher_forced(cfg, params_cpu, prompt, follow, kvd, "cpu", max_len, inputs)
    host_s = time.perf_counter() - t0
    worst, scale, ok = logits_close(card, host)
    pin = ""
    if pinned is not None:
        q_ok = pinned.worst_step <= 1 and pinned.worst_scale <= DENSE_SLICE_SCALE_TOL
        pin = (f" (host on the card's int8 cache values: {pinned.moved} of "
               f"{pinned.total} one step apart (limit 1), scales within "
               f"{pinned.worst_scale:.2e} relative (limit "
               f"{DENSE_SLICE_SCALE_TOL:g}): {'ok' if q_ok else 'FAIL'})")
        ok &= q_ok
    print(f"{label}, {kvd} cache, card vs host plain path{pin}, teacher-forced prefill + "
          f"{follow.shape[1]} decode steps: max_abs_err={worst:.3e} (max|host|={scale:.3e}, "
          f"rtol=1e-3, atol=1e-3*max|host|): {'ok' if ok else 'FAIL'}; host {host_s:.1f} s")
    if not ok:
        failures.append(f"{label} {kvd}: the card's logits disagree with the host")
    return {"max_abs_err": worst, "max_host": scale, "ok": ok, "host_s": host_s}


def dense_serve(arch, book, dev, failures) -> dict:
    """One dense arch at full width: weights drawn on the card, served
    (fp32 and int8 KV cache) through `serve(params=...)` with the flash
    counters set to 0 just before and read just after, the served tokens
    against the card's teacher-forced argmax over the whole depth, warm
    prefill / decode traces, the flash kernels at the captured shapes (and,
    at head dim 160, its edges), the block-masked FFN on layer 0's captured
    input where the config is block-ECR, and a depth-2 slice of the same
    weights (untied head included) against the host."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.sparse_ffn import activation_fn, sparse_ffn_apply, sparse_ffn_stats
    from repro_torch.kernels.flash_attention.kernel import flash_fwd, flash_fwd_q8
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    from repro_torch.models.attention import _quantize_kv
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config(arch)
    n_layers, d = cfg.n_layers, cfg.resolved_head_dim
    out = {"head_dim": d, "groups": cfg.n_heads // cfg.n_kv_heads, "n_params": cfg.n_params(),
           "runs": {}, "service": {}}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(LM_SERVE["seed"]),
                           device=dev)
    torch.cuda.synchronize()
    out["card_draw_s"] = time.perf_counter() - t0
    out["weight_gb"] = sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9
    print(f"{arch}: {out['n_params']:,} params, {out['weight_gb']:.2f} GB at fp32, drawn "
          f"on the card in {out['card_draw_s']:.2f} s; head dim {d}; memory_allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    wrappers = {"flash_fwd": flash_fwd, "flash_fwd_q8": flash_fwd_q8}
    max_len = LM_SERVE["prompt_len"] + LM_SERVE["gen_len"]
    expect = n_layers * LM_SERVE["gen_len"]
    keep = (0, n_layers - 1, n_layers, 2 * n_layers - 1)
    captured, served, ffn_x = {}, {}, None
    for kvd, want in (("float32", "flash_fwd"), ("int8", "flash_fwd_q8")):
        serve(arch, reduced=False, device=dev, kv_cache_dtype=kvd, params=params,
              **dict(LM_SERVE, gen_len=2))
        reset_counts(wrappers)
        res = serve(arch, reduced=False, device=dev, kv_cache_dtype=kvd, params=params,
                    **LM_SERVE)
        launches = read_counts(wrappers)
        served[kvd] = res
        other = "flash_fwd_q8" if want == "flash_fwd" else "flash_fwd"
        print(f"{arch} served ({kvd} KV cache): batch {LM_SERVE['batch']}, prompt "
              f"{LM_SERVE['prompt_len']}, {LM_SERVE['gen_len']} tokens: prefill "
              f"{res.prefill_ms:.2f} ms, decode {res.decode_ms:.3f} ms/step, "
              f"{res.tok_s:.1f} tok/s; launches {launches} (expected {expect} of {want}, "
              f"none of {other})")
        if launches[want] != expect or launches[other] != 0:
            failures.append(f"{arch} {kvd}: launches {launches}, expected {expect} of "
                            f"{want} and none of {other}")
        toks = res.tokens.cpu()
        if toks.shape != (LM_SERVE["batch"], LM_SERVE["gen_len"]) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            failures.append(f"{arch} {kvd}: served tokens malformed")
        prompt, follow = res.prompt.cpu(), toks[:, :LM_TF_STEPS]
        with capture_attention(keep) as cap, capture_ffn() as cf:
            card = teacher_forced(cfg, params, prompt, follow, kvd, dev, max_len)
        captured[kvd] = cap.calls
        ffn_x = cf.x if ffn_x is None else ffn_x
        greedy = torch.stack([card[0][:, -1].argmax(-1)] + [
            lg[:, 0].argmax(-1) for lg in card[1:LM_TF_STEPS]], 1).to(torch.int32)
        same = bool(torch.equal(greedy, follow))
        finite = all(bool(torch.isfinite(lg).all()) for lg in card)
        print(f"{arch} {kvd}: served tokens equal the card's teacher-forced argmax over "
              f"all {n_layers} layers (prefill + {LM_TF_STEPS - 1} steps): {same}; "
              f"logits finite: {finite}")
        if not (same and finite):
            failures.append(f"{arch} {kvd}: served tokens are not the card's greedy "
                            f"argmax, or its logits are not finite")
        out["runs"][kvd] = {"prefill_ms": res.prefill_ms, "decode_ms": res.decode_ms,
                            "tok_s": res.tok_s, "launches": launches, "greedy": same}
        dt = torch.int8 if kvd == "int8" else torch.float32
        cache = M.init_cache(cfg, LM_SERVE["batch"], max_len, dt, device=dev)
        nxt = res.tokens[:, :1]

        def prefill():
            with torch.no_grad():
                return M.prefill(cfg, params, cache, {"tokens": res.prompt})

        def decode():
            with torch.no_grad():
                return M.decode_step(cfg, params, cache, {"tokens": nxt},
                                     LM_SERVE["prompt_len"])

        for step, fn in (("prefill", prefill), ("decode", decode)):
            br = trace_breakdown(fn)
            out["service"][f"{kvd} {step}"] = br
            print(f"{arch} {kvd} warm {step}: wall {br['wall_ms']:.3f} ms (median of 5), "
                  f"device {br['device_ms']:.3f} ms in {br['device_ops']} device ops, "
                  f"idle share {br['idle_share']}; by class "
                  + ", ".join(f"{c} {ms:.3f}" for c, ms in
                              sorted(br["by_class_ms"].items(), key=lambda kv: -kv[1])))
        del cache

    print(f"{arch} flash kernel checks at head dim {d} (the fp32 limit, "
          f"{KERNEL_TOL.split(';')[0]}):")
    for kvd, calls in captured.items():
        for idx in keep:
            if idx not in calls:
                failures.append(f"{arch} {kvd}: attention call {idx} not captured")
                continue
            args, kw = calls[idx]
            layer = idx % n_layers
            label = f"{'prefill' if idx < n_layers else 'decode'} layer {layer}"
            row = check_flash(book, label, args, kw, timed=(layer == 0), phase=arch,
                              saturated=True)
            if row is not None:
                out.setdefault("timed", {}).setdefault(row["kernel"], []).append(
                    {k: row[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                         "bound_ms", "flop_ms", "byte_ms")})
    del captured
    for name in ("flash_fwd", "flash_fwd_q8"):
        if len(out.get("timed", {}).get(name, [])) != 2:
            failures.append(f"{arch}: {name} was not timed at layer 0's served shapes")
    if d == 160:
        gen = torch.Generator(device=dev).manual_seed(7)
        for eb, esq, ekv, eg, esk, causal, qo, kvl in DENSE_D160_EDGES:
            qq = torch.randn((eb, esq, ekv, eg, d), generator=gen, device=dev)
            kk = torch.randn((eb, esk, ekv, d), generator=gen, device=dev)
            vv = torch.randn((eb, esk, ekv, d), generator=gen, device=dev)
            kw = dict(scale=d ** -0.5, causal=causal, q_offset=qo, kv_len=kvl)
            check_flash(book, "edge", (qq, kk, vv), kw, timed=False, phase=arch)
            kq, ks = _quantize_kv(kk)
            vq, vs = _quantize_kv(vv)
            check_flash(book, "edge", (qq, kq, vq, ks, vs), kw, timed=False, phase=arch)

    if cfg.ffn_sparsity == "block_ecr" and ffn_x is not None:
        x2 = ffn_x.reshape(-1, cfg.d_model)
        ffn = params["groups"]["sub0"]["ffn"]
        w1, w2 = ffn["w1"][0], ffn["w2"][0]
        y, occ = sparse_ffn_apply(x2, w1, w2, cfg.mlp_activation)
        dense = activation_fn(cfg.mlp_activation)(x2 @ w1) @ w2
        same = bool(torch.equal(y, dense))
        st = sparse_ffn_stats(x2, w1, cfg.mlp_activation)
        out["ffn"] = {"shape": [*x2.shape, w1.shape[1]], "bitwise": same,
                      "occupancy": float(occ), **st}
        print(f"{arch} block-ECR FFN on layer 0's captured prefill input (T, D, F) = "
              f"({x2.shape[0]}, {x2.shape[1]}, {w1.shape[1]}), blocks (8, 128): "
              f"sparse_ffn_apply bitwise equal to the dense {cfg.mlp_activation} FFN: "
              f"{same}; occupancy {float(occ):.6f}; sparse_ffn_stats {st}")
        if not same:
            failures.append(f"{arch}: sparse_ffn_apply differs from the dense FFN")
        del y, dense, x2

    # the first DENSE_SLICE_LAYERS layers of the served weights, untied head
    # included, on the card against the host's plain path
    cfg2 = dataclasses.replace(cfg, n_layers=DENSE_SLICE_LAYERS)
    sl = {k: v for k, v in params.items() if k != "groups"}
    sl["groups"] = tree_map(lambda t: t[:DENSE_SLICE_LAYERS].clone(), params["groups"])
    del params, ffn_x
    gc.collect()
    torch.cuda.empty_cache()
    sl_cpu = tree_to(sl, "cpu")
    out["slice"] = {
        kvd: card_vs_host(f"{arch} depth-{DENSE_SLICE_LAYERS} slice at full width", cfg2, sl,
                          sl_cpu, res.prompt.cpu(), res.tokens.cpu()[:, :LM_TF_STEPS], kvd,
                          dev, max_len, failures)
        for kvd, res in served.items()}
    del sl, sl_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_entries(cfg, steps, sfx="bf16") -> dict:
    """The kernel launches `steps` train steps at remat "full" make, per
    entry point of the `sfx` type ("bf16" or "f32"): every attention
    sublayer (self, cross and encoder) the flash forward twice (forward and
    recompute) and each backward pass once; every MLA sublayer the MLA
    forward twice (the bf16 latent's entry at bf16) and its dq and dkv
    passes once; every Mamba sublayer the scan forward twice and its
    backward once."""
    from repro_torch.models import model as M

    kinds = {}
    for layout, groups in M.group_stacks(cfg).values():
        for sub in layout:
            kinds[sub.kind] = kinds.get(sub.kind, 0) + groups
    n_attn = kinds.get("attn", 0) + kinds.get("cross", 0)
    n_mla, n_mamba = kinds.get("mla", 0), kinds.get("mamba", 0)
    want = {}
    if n_attn:
        want.update({f"repro_flash_fwd_{sfx}": 2 * n_attn * steps,
                     f"repro_flash_bwd_dq_{sfx}": n_attn * steps,
                     f"repro_flash_bwd_dkv_{sfx}": n_attn * steps})
    if n_mla:
        want.update({"repro_flash_fwd_mla_" + ("bf16kv" if sfx == "bf16" else "f32"):
                     2 * n_mla * steps, f"repro_flash_bwd_mla_dq_{sfx}": n_mla * steps,
                     f"repro_flash_bwd_mla_dkv_{sfx}": n_mla * steps})
    if n_mamba:
        want.update({f"repro_selective_scan_{sfx}": 2 * n_mamba * steps,
                     f"repro_selective_scan_bwd_{sfx}": n_mamba * steps})
    return want


def entry_counts() -> dict:
    """Every flash, MLA and scan entry point's launches so far."""
    from repro_torch.kernels import cuda as kcuda

    return {**kcuda.FLASH_ENTRY_LAUNCHES, **kcuda.MLA_ENTRY_LAUNCHES,
            **kcuda.SCAN_ENTRY_LAUNCHES}


def entries_since(before) -> dict:
    return {k: n - before[k] for k, n in entry_counts().items() if n != before[k]}


class count_plain:
    """Count, within the block, the calls of the LM kernels' plain versions
    (a step on the card must make none)."""

    NAMES = {"repro_torch.kernels.flash_attention.kernel": (
                 "flash_fwd_plain", "flash_fwd_q8_plain", "flash_bwd_dq_plain",
                 "flash_bwd_dkv_plain", "flash_bwd_plain", "flash_fwd_mla_plain",
                 "flash_bwd_mla_plain"),
             "repro_torch.kernels.selective_scan.kernel": (
                 "selective_scan_plain", "selective_scan_bwd_plain")}

    def __enter__(self):
        import importlib

        self.saved, self.n = [], 0
        for mod_name, names in self.NAMES.items():
            mod = importlib.import_module(mod_name)
            for name in names:
                orig = getattr(mod, name)

                def rec(*a, _orig=orig, **k):
                    self.n += 1
                    return _orig(*a, **k)

                setattr(mod, name, rec)
                self.saved.append((mod, name, orig))
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)


def side_batch(cfg, batch, seq_len, seed, dtype) -> dict:
    """A training batch with a VLM's image embeddings or whisper's frames
    added, unit-normal from `seed`, in the parameters' type `dtype` (the
    pipeline gives tokens only; a bf16 trainer feeds bf16 activations)."""
    if cfg.family not in ("vlm", "audio"):
        return batch
    side = unit_inputs(cfg, batch["tokens"].shape[0], seq_len, seed)[0]
    return {**batch, **{k: v.to(dtype) for k, v in side.items()}}


def dense_train(dev, failures, archs=DENSE_TRAIN_ARCHS, variants=("registered", "qk_norm"),
                held=None, trace=False) -> dict:
    """Each of `archs`' REDUCED config trained 3 bf16 steps on the card
    (`make_train_step` at the reference launcher's types, remat "full")
    beside the host's plain path (remat "none") from the same state and
    batches (cross archs: the gates at CROSS_GATE and unit-normal side
    inputs), the launch counters set to 0 just before the steps and read
    just after (`train_entries`), and the plain versions' calls counted in
    the card's steps (none allowed); step 0's gradients first. Every variant
    holds the loss per step within 1e-2 relative; `held` maps a variant to
    what it holds besides: "grad_norm" within 3e-2, "leaves" (step 0's
    worst leaf) within 5e-2 (default: the qk_norm variant holds both).
    What is not held is printed beside the host's fp32 gradients on the
    same weights, which show bf16 rounding deciding it: registered configs
    without qk_norm (the scores' std is ~32 and the softmax saturates), and
    leaves whose host bf16 gradient lies farther than the limit from the
    host's fp32 one (the "host bf16 vs fp32" figure). With `trace`, the
    first variant's step is traced after the steps (`trace_breakdown`)."""
    import torch

    from repro_torch.configs.base import DEFAULT_RUN, get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels.flash_attention.kernel import (
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_bwd_mla,
        flash_fwd,
        flash_fwd_mla,
    )
    from repro_torch.kernels.selective_scan.kernel import selective_scan, selective_scan_bwd
    from repro_torch.launch.steps import (
        DTYPES,
        init_train_state,
        loss_and_grads,
        make_train_step,
        to_device,
    )
    from repro_torch.optim import global_norm
    from repro_torch.tree import tree_leaves, tree_map

    held = {"qk_norm": ("grad_norm", "leaves")} if held is None else held
    wrappers = {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq,
                "flash_bwd_dkv": flash_bwd_dkv, "flash_fwd_mla": flash_fwd_mla,
                "flash_bwd_mla": flash_bwd_mla, "selective_scan": selective_scan,
                "selective_scan_bwd": selective_scan_bwd}
    gb, sl, seed = DENSE_TRAIN["global_batch"], DENSE_TRAIN["seq_len"], DENSE_TRAIN["seed"]
    out = {}
    for arch in archs:
        for variant in variants:
            cfg = get_config(arch, reduced=True)
            if variant == "qk_norm":
                cfg = dataclasses.replace(cfg, qk_norm=True)
            run = DEFAULT_RUN.replace(warmup_steps=2)
            hrun = run.replace(remat="none")
            state_c = init_train_state(cfg, run, torch.Generator().manual_seed(seed), device=dev)
            state_h = init_train_state(cfg, hrun, torch.Generator().manual_seed(seed),
                                       device="cpu")
            for st in (state_c, state_h):
                set_gates(st.params, CROSS_GATE)
            pipe = make_pipeline(cfg, sl, gb, seed=seed)
            batches = [side_batch(cfg, to_device(pipe.batch_at(s), "cpu"), sl, seed + s,
                                  DTYPES[run.param_dtype])
                       for s in range(DENSE_TRAIN["steps"])]
            b0 = batches[0]
            _, g_c = loss_and_grads(cfg, run, state_c.params, to_device(b0, dev))
            _, g_h = loss_and_grads(cfg, hrun, state_h.params, to_device(b0, "cpu"))
            _, g_f = loss_and_grads(cfg, hrun.replace(param_dtype="float32"),
                                    tree_map(lambda t: t.float(), state_h.params),
                                    to_device(b0, "cpu"))
            worst = host_gap = 0.0
            for a, b, f in zip(tree_leaves(g_c), tree_leaves(g_h), tree_leaves(g_f)):
                a, b = a.float().cpu(), b.float()
                worst = max(worst, float((a - b).abs().max()) / max(float(b.abs().max()),
                                                                     1e-30))
                host_gap = max(host_gap, float((b - f).abs().max())
                               / max(float(f.abs().max()), 1e-30))
            gn_f = float(global_norm(g_f))
            del g_c, g_h, g_f
            step_c = make_train_step(cfg, run, 10, device=dev)
            step_h = make_train_step(cfg, hrun, 10, device="cpu")
            reset_counts(wrappers)
            before = entry_counts()
            losses, norms, plain_calls = [], [], 0
            for batch in batches:
                with count_plain() as pc:
                    state_c, mc = step_c(state_c, batch)
                plain_calls += pc.n
                state_h, mh = step_h(state_h, batch)
                losses.append((float(mc["loss"]), float(mh["loss"])))
                norms.append((float(mc["grad_norm"]), float(mh["grad_norm"])))
            launches = read_counts(wrappers)
            entries = entries_since(before)
            steps = DENSE_TRAIN["steps"]
            want = train_entries(cfg, steps)
            ok_loss = all(abs(c - h) <= 1e-2 * abs(h) for c, h in losses)
            ok_norm = all(abs(c - h) <= 3e-2 * h for c, h in norms)
            ok_leaf = worst <= 5e-2
            holds = held.get(variant, ())
            finite = all(map(lambda v: v == v and abs(v) < float("inf"),
                             [c for c, _ in losses + norms]))

            def verdict(ok, what):
                return ("ok" if ok else "FAIL") if what in holds else "not held"

            print(f"{arch} reduced ({variant}, head dim {cfg.resolved_head_dim}) bf16 x "
                  f"{steps} steps, batch {gb} x {sl}, card vs host: loss "
                  f"{[f'{c:.5f}/{h:.5f}' for c, h in losses]} "
                  f"({'ok' if ok_loss else 'FAIL'}, 1e-2 rel); grad norm "
                  f"{[f'{c:.4f}/{h:.4f}' for c, h in norms]} "
                  f"({verdict(ok_norm, 'grad_norm')}, 3e-2 rel); "
                  f"step-0 worst leaf max|card - host| / max|host| {worst:.2e} "
                  f"({verdict(ok_leaf, 'leaves')}, 5e-2); host fp32 grad norm on the same "
                  f"weights {gn_f:.4f}, host bf16 vs fp32 worst leaf {host_gap:.2e}; launches "
                  f"{launches}, per entry point {entries} (expected {want}); plain-version "
                  f"calls in the card's steps: {plain_calls}")
            if (not (ok_loss and finite) or ("grad_norm" in holds and not ok_norm)
                    or ("leaves" in holds and not ok_leaf)):
                failures.append(f"{arch} reduced {variant}: bf16 card steps disagree with "
                                f"the host")
            if entries != want:
                failures.append(f"{arch} reduced {variant}: entry launches {entries}, "
                                f"expected {want}")
            if plain_calls:
                failures.append(f"{arch} reduced {variant}: the card's steps called a plain "
                                f"version {plain_calls} times")
            if trace and variant == variants[0]:
                br = trace_breakdown(lambda: step_c(state_c, batches[0]),
                                     {"batch": gb, "seq": sl})
                print(f"{arch} reduced ({variant}) warm bf16 train step: wall "
                      f"{br['wall_ms']:.3f} ms (median of 5), device {br['device_ms']:.3f} ms "
                      f"in {br['device_ops']} device ops, idle share {br['idle_share']}; by "
                      f"class " + ", ".join(f"{c} {ms:.3f}" for c, ms in sorted(
                          br["by_class_ms"].items(), key=lambda kv: -kv[1])))
                out[f"{arch} step"] = br
            out[f"{arch} {variant}"] = {"loss": losses, "grad_norm": norms,
                                        "worst_leaf_rel": worst, "host_fp32_grad_norm": gn_f,
                                        "host_bf16_vs_fp32_leaf": host_gap,
                                        "launches": launches, "entries": entries,
                                        "plain_calls": plain_calls,
                                        "held": ["loss", *holds]}
            del state_c, state_h
    return out


def fp32_train_step(arch, dev, failures) -> dict:
    """One fp32 train step of the reduced `arch` on the card beside the
    host's (the fp32 trainer reaches the fp32 entry points): the counters
    set to 0 just before it and read just after (`train_entries` at "f32"),
    the loss within 1e-4 relative."""
    import torch

    from repro_torch.configs.base import DEFAULT_RUN, get_config
    from repro_torch.data import make_pipeline
    from repro_torch.launch.steps import init_train_state, make_train_step, to_device

    cfg = get_config(arch, reduced=True)
    run = DEFAULT_RUN.replace(param_dtype="float32", warmup_steps=2)
    seed, sl, gb = DENSE_TRAIN["seed"], DENSE_TRAIN["seq_len"], DENSE_TRAIN["global_batch"]
    batch = to_device(make_pipeline(cfg, sl, gb, seed=seed).batch_at(0), "cpu")
    res = {}
    for where, r in ((dev, run), ("cpu", run.replace(remat="none"))):
        state = init_train_state(cfg, r, torch.Generator().manual_seed(seed), device=where)
        before = entry_counts()
        _, m = make_train_step(cfg, r, 10, device=where)(state, batch)
        res[str(where)] = (float(m["loss"]), entries_since(before))
    (lc, entries), (lh, _) = res[str(dev)], res["cpu"]
    want = train_entries(cfg, 1, "f32")
    ok = abs(lc - lh) <= 1e-4 * abs(lh)
    print(f"{arch} reduced fp32 train step, card vs host: loss {lc:.6f} vs {lh:.6f} "
          f"({'ok' if ok else 'FAIL'}, 1e-4 rel); entries {entries} (expected {want})")
    if not ok:
        failures.append(f"{arch} reduced fp32 step: the card's loss disagrees with the host")
    if entries != want:
        failures.append(f"{arch} reduced fp32 step: entry launches {entries}, expected {want}")
    return {"loss": [lc, lh], "entries": entries}


def dense_rows(name, kvd, dense_lm, archs=DENSE_SERVE_ARCHS) -> list:
    """For the kernel line's flash rows: per served arch of `archs` (its
    results in `dense_lm`), its head dim, query heads per KV head, the
    served run's launches and layer 0's prefill + decode times."""
    rows = []
    for arch in archs:
        res = dense_lm.get(arch)
        if not res:
            continue
        timed = res.get("timed", {}).get(name, [])
        rows.append({"arch": arch, "head_dim": res["head_dim"], "groups": res["groups"],
                     "launches": res["runs"].get(kvd, {}).get("launches", {}).get(name, 0),
                     **{k: sum(r[k] for r in timed) for k in
                        ("ms", "plain_ms", "library_ms", "bound_ms")},
                     "bound_by": ("operations" if sum(r["flop_ms"] for r in timed)
                                  >= sum(r["byte_ms"] for r in timed) else "bytes")})
    return rows


def launches_by_head_dim(name, kvd, lm, dense_lm, moe_lm, cross_lm) -> dict:
    """The served runs' launches of one flash row, by head dim, over the
    request of type `kvd`."""
    out = {128: lm.get("runs", {}).get(kvd, {}).get("launches", {}).get(name, 0)}
    for row in dense_rows(name, kvd, dense_lm) + moe_rows(name, kvd, moe_lm):
        out[row["head_dim"]] = out.get(row["head_dim"], 0) + row["launches"]
    for row in cross_rows(name, cross_lm):
        out[row["head_dim"]] = out.get(row["head_dim"], 0) + row["launches"].get(kvd, 0)
    return out


def moe_rows(name, kvd, moe_lm) -> list:
    """`dense_rows` for the MoE phase's served arch (arctic-480b, G 7)."""
    return dense_rows(name, kvd, {MOE_ARCH: moe_lm.get("serve")}, (MOE_ARCH,))


def dense_phase(book, dev, failures) -> dict:
    """The dense LM family beyond qwen3-0.6b (see `dense_serve`,
    `dense_train`); memory reserved before it and the peak in it."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {"memory_reserved_before_gib": torch.cuda.memory_reserved() / 2**30}
    print(f"dense LM phase: memory_reserved before it "
          f"{out['memory_reserved_before_gib']:.2f} GiB")
    for arch in DENSE_SERVE_ARCHS:
        try:
            out[arch] = dense_serve(arch, book, dev, failures)
        except Exception:
            traceback.print_exc()
            failures.append(f"{arch} serving failed")
        gc.collect()
        torch.cuda.empty_cache()
    try:
        out["train"] = dense_train(dev, failures)
    except Exception:
        traceback.print_exc()
        failures.append("dense LM training failed")
    out["peak_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["seconds"] = time.perf_counter() - t0
    print(f"dense LM phase: peak memory_allocated {out['peak_allocated_gib']:.2f} GiB; "
          f"{out['seconds']:.1f} s")
    return out


MOE_ARCH = "arctic-480b"
# one full-width arctic-480b layer holds ~56.3 GB of fp32 weights (the three
# expert leaves 17.85 GB each); two do not fit the card's 80 GB
MOE_LAYERS = 1
MOE_BRUTE_TOKENS = 4  # tokens of the captured prefill input the fp64 brute force runs
# the routed FFN on the card against its fp64 brute force: the fp32 limit of
# the kernels (1e-4 * max|fp64|); cuBLAS's fp32 products over K = 7168 and
# 4864 sit near 1e-6 of it
MOE_BRUTE_TOL = 1e-4


class capture_moe:
    """Within the block, record every routing (`models.moe.route`: token
    count, capacity, tokens per expert, pairs dropped) and the input and
    output of the first routed FFN call (layer 0 of a prefill), then run the
    calls as usual. The records stay on the card until read."""

    def __enter__(self):
        import repro_torch.models.moe as MOE
        import repro_torch.models.transformer as T

        self.MOE, self.T = MOE, T
        self.orig_route, self.orig_ffn = MOE.route, T.moe_ffn
        self.routes, self.first = [], None

        def route(router, xt, cfg):
            r = self.orig_route(router, xt, cfg)
            self.routes.append((xt.shape[0], r.cap, r.eidx.detach().clone(),
                                r.keep.clone(), r.gates.detach().clone()))
            return r

        def moe_ffn(p, x, cfg):
            y, aux = self.orig_ffn(p, x, cfg)
            if self.first is None:
                self.first = (x.detach().clone(), y.detach().clone())
            return y, aux

        MOE.route, T.moe_ffn = route, moe_ffn
        return self

    def __exit__(self, *exc):
        self.MOE.route, self.T.moe_ffn = self.orig_route, self.orig_ffn

    def per_call(self, n_experts) -> list:
        """[(T, cap, tokens per expert, pairs dropped)] per routing call."""
        import torch

        out = []
        for t, cap, eidx, keep, _ in self.routes:
            counts = torch.bincount(eidx.reshape(-1).cpu(), minlength=n_experts)
            out.append((t, cap, counts.tolist(), int((~keep).sum())))
        return out


def moe_brute_force(cfg, params, x, y, failures) -> dict:
    """The routed FFN of layer 0 on its captured prefill input `x` against
    an fp64 brute force on the card over the first MOE_BRUTE_TOKENS tokens
    (and any token with a pair dropped): fp64 router softmax and top-k, the
    reference's drops (a pair past its expert's capacity, in token order,
    counts nothing), and each kept pair's gated silu expert in fp64,
    weighted by its renormalised gate (`tests/test_moe.py::
    test_brute_force_equivalence_no_drops`)."""
    import torch

    from repro_torch.models.moe import _capacity

    moe = params["groups"]["sub0"]["moe"]
    xt = x.reshape(-1, cfg.d_model).double()
    yt = y.reshape(-1, cfg.d_model).double()
    t, k = xt.shape[0], cfg.top_k
    probs = torch.softmax(xt @ moe["router"][0].double(), dim=-1)
    top, eidx = torch.topk(probs, k + 1, dim=-1)
    margin = float((top[:, k - 1] - top[:, k]).min())
    gates = top[:, :k] / top[:, :k].sum(-1, keepdim=True)
    eidx = eidx[:, :k].cpu()
    cap = _capacity(t, cfg)
    seen = torch.zeros(cfg.n_experts, dtype=torch.int64)
    keep = torch.zeros((t, k), dtype=torch.bool)
    for i in range(t):
        for j in range(k):
            e = int(eidx[i, j])
            keep[i, j] = seen[e] < cap
            seen[e] += 1
    rows = sorted(set(range(MOE_BRUTE_TOKENS)) | {i for i in range(t) if not keep[i].all()})
    ref = torch.zeros((len(rows), cfg.d_model), dtype=torch.float64, device=x.device)
    for r, i in enumerate(rows):
        for j in range(k):
            if keep[i, j]:
                e = int(eidx[i, j])
                h = xt[i] @ moe["w1"][0, e].double()
                h = h * torch.sigmoid(h) * (xt[i] @ moe["w3"][0, e].double())
                ref[r] += gates[i, j] * (h @ moe["w2"][0, e].double())
    err = float((yt[rows] - ref).abs().max())
    scale = float(ref.abs().max())
    ok = err <= MOE_BRUTE_TOL * scale and bool(torch.isfinite(yt).all())
    out = {"tokens": rows, "pairs": int(keep[rows].sum()), "dropped": int((~keep).sum()),
           "capacity": cap, "min_top_k_margin": margin, "max_abs_err": err,
           "max_ref": scale, "ok": ok}
    print(f"{MOE_ARCH} routed FFN of layer 0 on its captured prefill input (T {t}, "
          f"capacity {cap}, {out['dropped']} pairs dropped), tokens {rows} "
          f"({out['pairs']} kept pairs) against an fp64 brute force on the card: "
          f"max_abs_err={err:.3e} (max|fp64|={scale:.3e}, limit {MOE_BRUTE_TOL:g}*max): "
          f"{'ok' if ok else 'FAIL'}; smallest fp64 top-{k} margin {margin:.3e}")
    if not ok:
        failures.append(f"{MOE_ARCH}: the routed FFN disagrees with its fp64 brute force")
    return out


def moe_serve(book, dev, failures) -> dict:
    """arctic-480b at full width cut to MOE_LAYERS: weights drawn on the
    card, served (fp32 and int8 KV cache) through `serve(cfg, params=...)` with the
    flash counters set to 0 just before and read just after, the routing of
    every served call, the served tokens against the card's teacher-forced
    argmax, warm prefill / decode traces, the flash kernels at the captured
    G 7 shapes, and the routed FFN against an fp64 brute force."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_fwd, flash_fwd_q8
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    n_layers, d = cfg.n_layers, cfg.resolved_head_dim
    out = {"n_layers": n_layers, "head_dim": d, "groups": cfg.n_heads // cfg.n_kv_heads,
           "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
           "runs": {}, "service": {}, "routing": {}}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(LM_SERVE["seed"]),
                           device=dev)
    torch.cuda.synchronize()
    out["card_draw_s"] = time.perf_counter() - t0
    out["weight_gb"] = sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9
    out["draw_peak_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"{MOE_ARCH} at full width, depth {n_layers} (of 35): {out['n_params']:,} params "
          f"({out['n_active_params']:,} active per token), {out['weight_gb']:.2f} GB at "
          f"fp32, drawn on the card in {out['card_draw_s']:.2f} s; peak memory_allocated "
          f"while drawing {out['draw_peak_allocated_gib']:.2f} GiB; head dim {d}, G "
          f"{out['groups']}, {cfg.n_experts} experts top-{cfg.top_k}")
    wrappers = {"flash_fwd": flash_fwd, "flash_fwd_q8": flash_fwd_q8}
    max_len = LM_SERVE["prompt_len"] + LM_SERVE["gen_len"]
    expect = n_layers * LM_SERVE["gen_len"]
    keep = (0, n_layers - 1, n_layers, 2 * n_layers - 1)
    captured, first_moe = {}, None
    for kvd, want in (("float32", "flash_fwd"), ("int8", "flash_fwd_q8")):
        serve(cfg, device=dev, kv_cache_dtype=kvd, params=params, **dict(LM_SERVE, gen_len=2))
        with capture_moe() as cm:
            reset_counts(wrappers)
            res = serve(cfg, device=dev, kv_cache_dtype=kvd, params=params, **LM_SERVE)
            launches = read_counts(wrappers)
        other = "flash_fwd_q8" if want == "flash_fwd" else "flash_fwd"
        print(f"{MOE_ARCH} served ({kvd} KV cache): batch {LM_SERVE['batch']}, prompt "
              f"{LM_SERVE['prompt_len']}, {LM_SERVE['gen_len']} tokens: prefill "
              f"{res.prefill_ms:.2f} ms, decode {res.decode_ms:.3f} ms/step, "
              f"{res.tok_s:.1f} tok/s; launches {launches} (expected {expect} of {want}, "
              f"none of {other})")
        if launches[want] != expect or launches[other] != 0:
            failures.append(f"{MOE_ARCH} {kvd}: launches {launches}, expected {expect} of "
                            f"{want} and none of {other}")
        calls = cm.per_call(cfg.n_experts)
        if len(calls) != n_layers * LM_SERVE["gen_len"]:
            failures.append(f"{MOE_ARCH} {kvd}: {len(calls)} routing calls")
        for i, (t, cap, counts, dropped) in enumerate(calls):
            reached = {e: c for e, c in enumerate(counts) if c}
            shown = counts if i == 0 else reached
            print(f"  routing call {i} ({'prefill' if i < n_layers else 'decode'} layer "
                  f"{i % n_layers}): T {t}, capacity {cap}, {dropped} of {t * cfg.top_k} "
                  f"pairs dropped, {len(reached)} experts reached, most {max(counts)}; "
                  f"tokens per expert {shown}")
        out["routing"][kvd] = [{"T": t, "capacity": cap, "dropped": dropped,
                                "experts_reached": sum(1 for c in counts if c),
                                "max_per_expert": max(counts)}
                               for t, cap, counts, dropped in calls]
        caps = {(t, cap) for t, cap, _, _ in calls}
        if caps != {(LM_SERVE["batch"] * LM_SERVE["prompt_len"], 8), (LM_SERVE["batch"], 8)}:
            failures.append(f"{MOE_ARCH} {kvd}: capacities {sorted(caps)}, expected 8 at "
                            f"T = 128 and T = 4")
        toks = res.tokens.cpu()
        if toks.shape != (LM_SERVE["batch"], LM_SERVE["gen_len"]) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            failures.append(f"{MOE_ARCH} {kvd}: served tokens malformed")
        prompt, follow = res.prompt.cpu(), toks[:, :LM_TF_STEPS]
        with capture_attention(keep) as cap, capture_moe() as cf:
            card = teacher_forced(cfg, params, prompt, follow, kvd, dev, max_len)
        captured[kvd] = cap.calls
        first_moe = cf.first if first_moe is None else first_moe
        greedy = torch.stack([card[0][:, -1].argmax(-1)] + [
            lg[:, 0].argmax(-1) for lg in card[1:LM_TF_STEPS]], 1).to(torch.int32)
        same = bool(torch.equal(greedy, follow))
        finite = all(bool(torch.isfinite(lg).all()) for lg in card)
        print(f"{MOE_ARCH} {kvd}: served tokens equal the card's teacher-forced argmax "
              f"(prefill + {LM_TF_STEPS - 1} steps): {same}; logits finite: {finite}")
        if not (same and finite):
            failures.append(f"{MOE_ARCH} {kvd}: served tokens are not the card's greedy "
                            f"argmax, or its logits are not finite")
        out["runs"][kvd] = {"prefill_ms": res.prefill_ms, "decode_ms": res.decode_ms,
                            "tok_s": res.tok_s, "launches": launches, "greedy": same}
        dt = torch.int8 if kvd == "int8" else torch.float32
        cache = M.init_cache(cfg, LM_SERVE["batch"], max_len, dt, device=dev)
        nxt = res.tokens[:, :1]

        def prefill():
            with torch.no_grad():
                return M.prefill(cfg, params, cache, {"tokens": res.prompt})

        def decode():
            with torch.no_grad():
                return M.decode_step(cfg, params, cache, {"tokens": nxt},
                                     LM_SERVE["prompt_len"])

        for step, fn in (("prefill", prefill), ("decode", decode)):
            br = trace_breakdown(fn)
            out["service"][f"{kvd} {step}"] = br
            print(f"{MOE_ARCH} {kvd} warm {step}: wall {br['wall_ms']:.3f} ms (median of 5), "
                  f"device {br['device_ms']:.3f} ms in {br['device_ops']} device ops, "
                  f"idle share {br['idle_share']}; by class "
                  + ", ".join(f"{c} {ms:.3f}" for c, ms in
                              sorted(br["by_class_ms"].items(), key=lambda kv: -kv[1])))
        del cache

    print(f"{MOE_ARCH} flash kernel checks at head dim {d}, G {out['groups']} (the fp32 "
          f"limit, {KERNEL_TOL.split(';')[0]}):")
    for kvd, calls in captured.items():
        for idx in sorted(set(keep)):
            if idx not in calls:
                failures.append(f"{MOE_ARCH} {kvd}: attention call {idx} not captured")
                continue
            args, kw_ = calls[idx]
            layer = idx % n_layers
            label = f"{'prefill' if idx < n_layers else 'decode'} layer {layer}"
            row = check_flash(book, label, args, kw_, timed=(layer == 0), phase=MOE_ARCH,
                              saturated=True)
            if row is not None:
                out.setdefault("timed", {}).setdefault(row["kernel"], []).append(
                    {k: row[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                         "bound_ms", "flop_ms", "byte_ms")})
    del captured
    for name in ("flash_fwd", "flash_fwd_q8"):
        if len(out.get("timed", {}).get(name, [])) != 2:
            failures.append(f"{MOE_ARCH}: {name} was not timed at layer 0's served shapes")
    if first_moe is None:
        failures.append(f"{MOE_ARCH}: layer 0's routed FFN input was not captured")
    else:
        out["brute_force"] = moe_brute_force(cfg, params, *first_moe, failures)
    del params, first_moe
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_reduced(dev, failures) -> dict:
    """Reduced arctic-480b (2 layers, 8 experts, dense residual FFN) drawn on
    the host: `card_vs_host` over fp32 and int8 caches."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    cfg = get_config(MOE_ARCH, reduced=True)
    params_cpu = M.init_params(cfg, torch.Generator().manual_seed(LM_SERVE["seed"]),
                               device="cpu")
    params = tree_to(params_cpu, dev)
    gen = torch.Generator().manual_seed(LM_SERVE["seed"] + 1)
    prompt = torch.randint(0, cfg.vocab_size, (LM_SERVE["batch"], LM_SERVE["prompt_len"]),
                           generator=gen)
    follow = torch.randint(0, cfg.vocab_size, (LM_SERVE["batch"], LM_TF_STEPS), generator=gen)
    max_len = LM_SERVE["prompt_len"] + LM_TF_STEPS
    return {kvd: card_vs_host(f"{MOE_ARCH} reduced", cfg, params, params_cpu, prompt, follow,
                              kvd, dev, max_len, failures)
            for kvd in ("float32", "int8")}


def moe_phase(book, dev, failures) -> dict:
    """The MoE LM family (see `moe_serve`, `moe_reduced`, and `dense_train`
    on reduced arctic-480b); memory reserved before it and the peak in it."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {"memory_reserved_before_gib": torch.cuda.memory_reserved() / 2**30}
    print(f"MoE phase: memory_reserved before it {out['memory_reserved_before_gib']:.2f} GiB")
    for key, fn in (("serve", lambda: moe_serve(book, dev, failures)),
                    ("reduced", lambda: moe_reduced(dev, failures)),
                    ("train", lambda: dense_train(dev, failures, archs=(MOE_ARCH,)))):
        try:
            out[key] = fn()
        except Exception:
            traceback.print_exc()
            failures.append(f"{MOE_ARCH} {key} failed")
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"MoE phase: {out['seconds']:.1f} s")
    return out


MLA_ARCH = "deepseek-v2-236b"
# depth 2 of 60: the smallest depth with a second layer in the stacked
# (n_layers, B, S_max, r) latent cache; 35.97 GB of fp32 weights (one
# layer's largest leaf, an expert leaf, is 5.03 GB)
MLA_LAYERS = 2
MLA_ENTRIES = ("repro_flash_fwd_mla_f32", "repro_flash_fwd_mla_bf16kv")
# what the MLA kernel's fp32 and bf16 entries are held to against the plain
# version; l (and fp32 out) widen by `score_widening` at scores up to S: both
# sides' scores are fp32 sums of 576 terms, and at S near 30 one fp32 ulp of
# a score moves l by about 1e-5 of itself
MLA_TOL = ("fp32 latent: out 1e-4*max|plain| + 1e-5*min(1, max|plain|), m 1e-5*max|plain|, "
           "l 1e-5*max|plain|; bf16 latent: out 2^-7*max|plain|, m and l 1e-5*max|plain|; "
           "fp32 out and both l + 8*2^-24*S*max|plain| at scores up to S")


class capture_mla:
    """Within the block, record the (q, c_kv, k_rope, kwargs) of the MLA
    kernel calls whose running index is in `keep` (cloned: the cache is
    written in place), then run the call as usual; `n` counts the calls and
    `prefill` those with more than one query position."""

    def __init__(self, keep):
        self.keep, self.calls, self.n, self.prefill = set(keep), {}, 0, 0

    def __enter__(self):
        import repro_torch.models.attention as A

        self.A, self.orig = A, A.flash_fwd_mla

        def rec(*args, **kw):
            if self.n in self.keep:
                self.calls[self.n] = (tuple(a.clone() for a in args), dict(kw))
            self.n += 1
            self.prefill += args[0].shape[1] > 1
            return self.orig(*args, **kw)

        A.flash_fwd_mla = rec
        return self

    def __exit__(self, *exc):
        self.A.flash_fwd_mla = self.orig


def mla_bound(q, c_kv, kw):
    """(op time, byte time) in ms of the MLA kernel's work: 2 * B * H *
    pairs * (Dk + Dv) operations (q.k over r + dr, p.v over r) at 165
    TFLOP/s (split-TF32; the bf16 entry's products are TF32 too); q read,
    the keys any row reads ([c_kv ; k_rope] once: the values are the same
    c_kv rows), out written in the latent's type, and m, l, over 3.35 TB/s."""
    b, sq, h, dk = q.shape
    sk, r = c_kv.shape[1], c_kv.shape[2]
    eb = c_kv.element_size()
    pairs, keys = visible_pairs(sq, sk, kw["causal"], kw["q_offset"], kw["kv_len"])
    ops = 2.0 * b * h * pairs * (dk + r)
    nbytes = 4.0 * b * sq * h * dk + eb * b * keys * dk + eb * b * sq * h * r + 8.0 * b * sq * h
    return ops / PEAK_TF32_SPLIT_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3


def mla_library(q, c_kv, k_rope, kw):
    """F.scaled_dot_product_attention on the same function: q (B, H, Sq,
    r + dr) over the keys [c_kv ; k_rope] and values c_kv of the one latent
    head, expanded to the H heads, in fp32 (a bf16 latent widened inside
    the call), the same boolean mask. Tries SDPA's backends in turn and
    keeps the first that runs -> (fn, backend name)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, sq, h, dk = q.shape
    qh = q.transpose(1, 2)
    mask = attention_mask(sq, c_kv.shape[1], kw, q.device)

    def call():
        c = c_kv.float()[:, None].expand(b, h, -1, -1)
        k = torch.cat([c_kv.float(), k_rope.float()], -1)[:, None].expand(b, h, -1, -1)
        return F.scaled_dot_product_attention(qh, k, c, attn_mask=mask, scale=kw["scale"])

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                call()
            torch.cuda.synchronize()
        except RuntimeError:
            continue

        def fn(backend=backend):
            with sdpa_kernel([backend]):
                return call()
        return fn, backend.name
    raise RuntimeError("no SDPA backend takes the MLA shape")


def check_mla(book, label, args, kw, *, timed) -> dict | None:
    """The MLA kernel against its plain version (out, m, l) at the limits of
    MLA_TOL; when `timed`, kernel / plain / SDPA by CUDA-graph replay and
    eager, and the bound. Returns the timing row or None."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_fwd_mla, flash_fwd_mla_plain

    bf16 = args[1].dtype == torch.bfloat16
    name = "flash_fwd_mla_bf16kv" if bf16 else "flash_fwd_mla_f32"
    kernel = lambda: flash_fwd_mla(*args, **kw)  # noqa: E731
    plain = lambda: flash_fwd_mla_plain(*args, **kw)  # noqa: E731
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    tag = (f"{label} q{tuple(args[0].shape)} c_kv{tuple(args[1].shape)} "
           f"q_offset={kw['q_offset']} kv_len={kw['kv_len']}")
    m = want[1][want[1] > -1e29]  # rows that see no key carry the mask value
    widen = score_widening(float(m.abs().max()) if m.numel() else 0.0)
    if bf16:
        book.check_bf16(name, f"{tag} out", got[0], want[0])
    else:
        book.check(name, f"{tag} out", got[0], want[0], widen=widen)
    book.check_stat(name, f"{tag} m", got[1], want[1])
    book.check_stat(name, f"{tag} l", got[2], want[2], widen=widen)
    if not timed:
        return None
    lib, backend = mla_library(*args, kw)
    lib_err = float((lib().transpose(1, 2).float() - got[0].float()).abs().max())
    fns = {"kernel": kernel, "plain": plain, "library": lib}
    t = time_graph_turns(fns)
    te = time_turns(fns)
    ft, bt = mla_bound(args[0], args[1], kw)
    row = {"kernel": name, "shape": label, "q": list(args[0].shape),
           "c_kv": list(args[1].shape), "q_offset": kw["q_offset"], "kv_len": kw["kv_len"],
           "ms": t["kernel"], "plain_ms": t["plain"], "library_ms": t["library"],
           "library_backend": backend, "eager_ms": te["kernel"], "eager_plain_ms": te["plain"],
           "eager_library_ms": te["library"], "flop_ms": ft, "byte_ms": bt,
           "bound_ms": max(ft, bt), "bound_by": "operations" if ft >= bt else "bytes",
           "library_max_abs_diff": lib_err, "phase": MLA_ARCH}
    book.rows.append(row)
    print(f"    {name} {label}: ms={t['kernel']:.4f} plain_ms={t['plain']:.4f} "
          f"library_ms={t['library']:.4f} (SDPA {backend}) bound_ms={max(ft, bt):.4f} "
          f"({row['bound_by']}) [CUDA-graph replay]; eager calls: {te['kernel']:.4f} / "
          f"{te['plain']:.4f} / {te['library']:.4f} ms; |kernel - SDPA| {lib_err:.2e}")
    return row


# a decode over 4,096 keys at full width, off the served path: B 4 x 128
# heads over a 4,096-key latent (the key-split path of the MLA kernel and
# its combine), fp32 and bf16 latent, operands drawn on the card
MLA_LONG_DECODE = dict(batch=4, kv_len=4096, seed=2)


def mla_long_decode(book, dev, failures) -> dict:
    """The MLA kernel at `MLA_LONG_DECODE` (q at position kv_len - 1, causal,
    kv_len keys), both latents: held against its plain version at MLA_TOL's
    limits, repeated bitwise, and timed beside it, SDPA and the bound
    (`check_mla`, label "decode 4096"); the times gate nothing."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_fwd_mla

    cfg = get_config(MLA_ARCH)
    b, n = MLA_LONG_DECODE["batch"], MLA_LONG_DECODE["kv_len"]
    r, dr, h = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.n_heads
    out = {}
    for dtype, sfx in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        try:
            gen = torch.Generator(device=dev).manual_seed(MLA_LONG_DECODE["seed"])
            args = (torch.randn((b, 1, h, r + dr), generator=gen, device=dev),
                    torch.randn((b, n, r), generator=gen, device=dev).to(dtype),
                    torch.randn((b, n, dr), generator=gen, device=dev).to(dtype))
            kw = dict(scale=(cfg.nope_head_dim + dr) ** -0.5, causal=True, q_offset=n - 1,
                      kv_len=n)
            print(f"{MLA_ARCH} MLA forward, a decode over {n} keys at B {b}, {h} heads, {sfx}:")
            first, second = flash_fwd_mla(*args, **kw), flash_fwd_mla(*args, **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(first, second))
            print(f"  repeats bitwise: {same}")
            if not same:
                failures.append(f"{MLA_ARCH} MLA decode over {n} keys, {sfx}: repeats differ")
            row = check_mla(book, f"decode {n}", args, kw, timed=True)
            out[sfx] = {k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                            "bound_by")}
            del args, first, second
        except Exception:
            traceback.print_exc()
            failures.append(f"{MLA_ARCH} MLA decode over {n} keys, {sfx}, failed")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mla_counts() -> dict:
    """The MLA and GQA flash launches since `mla_reset`, per entry point."""
    from repro_torch.kernels import cuda as kcuda

    return {**{k: kcuda.MLA_ENTRY_LAUNCHES[k] for k in MLA_ENTRIES},
            **{k: kcuda.FLASH_ENTRY_LAUNCHES[k] for k in ("repro_flash_fwd_f32",
                                                          "repro_flash_fwd_q8")}}


def mla_reset() -> None:
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels.flash_attention.kernel import flash_fwd, flash_fwd_mla, flash_fwd_q8

    for d in (kcuda.MLA_ENTRY_LAUNCHES, kcuda.FLASH_ENTRY_LAUNCHES):
        for k in d:
            d[k] = 0
    reset_counts({"flash_fwd_mla": flash_fwd_mla, "flash_fwd": flash_fwd,
                  "flash_fwd_q8": flash_fwd_q8})


def mla_serve(book, dev, failures) -> dict:
    """deepseek-v2-236b at full width cut to MLA_LAYERS: weights drawn on the
    card, served (fp32 latent cache, and the int8 request's bf16 latent)
    through `serve(cfg, params=...)` with the flash counters set to 0 just
    before and read just after, the served tokens against the card's
    teacher-forced argmax, warm prefill / decode traces, and the MLA kernel
    at the captured layer 0 and 1 shapes against its plain version, layer 0
    timed beside SDPA."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_fwd_mla
    from repro_torch.launch.serve import cache_kind, serve
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_LAYERS)
    n_layers = cfg.n_layers
    out = {"n_layers": n_layers, "n_params": cfg.n_params(),
           "n_active_params": cfg.n_active_params(), "runs": {}, "service": {}}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(LM_SERVE["seed"]),
                           device=dev)
    torch.cuda.synchronize()
    out["card_draw_s"] = time.perf_counter() - t0
    out["weight_gb"] = sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9
    out["draw_peak_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"{MLA_ARCH} at full width, depth {n_layers} (of 60): {out['n_params']:,} params "
          f"({out['n_active_params']:,} active per token), {out['weight_gb']:.2f} GB at "
          f"fp32, drawn on the card in {out['card_draw_s']:.2f} s; peak memory_allocated "
          f"while drawing {out['draw_peak_allocated_gib']:.2f} GiB; {cfg.n_heads} heads on "
          f"one latent (r {cfg.kv_lora_rank}, dr {cfg.rope_head_dim}), {cfg.n_experts} "
          f"experts top-{cfg.top_k} and {cfg.n_shared_experts} shared")
    max_len = LM_SERVE["prompt_len"] + LM_SERVE["gen_len"]
    expect = n_layers * LM_SERVE["gen_len"]
    keep = (0, n_layers - 1, n_layers, 2 * n_layers - 1)
    captured = {}
    for kvd, want in (("float32", MLA_ENTRIES[0]), ("int8", MLA_ENTRIES[1])):
        serve(cfg, device=dev, kv_cache_dtype=kvd, params=params, **dict(LM_SERVE, gen_len=2))
        mla_reset()
        with capture_mla(()) as shapes:
            res = serve(cfg, device=dev, kv_cache_dtype=kvd, params=params, **LM_SERVE)
        launches = mla_counts()
        wrapper = flash_fwd_mla.launches
        by_shape = {"prefill": shapes.prefill, "decode": shapes.n - shapes.prefill}
        print(f"{MLA_ARCH} served ({cache_kind(cfg, kvd)} cache, {kvd} requested): batch "
              f"{LM_SERVE['batch']}, prompt {LM_SERVE['prompt_len']}, {LM_SERVE['gen_len']} "
              f"tokens: prefill {res.prefill_ms:.2f} ms, decode {res.decode_ms:.3f} ms/step, "
              f"{res.tok_s:.1f} tok/s; launches {launches} (wrapper {wrapper}; expected "
              f"{expect} of {want}, none of the others; by shape {by_shape})")
        if launches[want] != expect or wrapper != expect or sum(launches.values()) != expect:
            failures.append(f"{MLA_ARCH} {kvd}: launches {launches} (wrapper {wrapper}), "
                            f"expected {expect} of {want} and none of the others")
        toks = res.tokens.cpu()
        if toks.shape != (LM_SERVE["batch"], LM_SERVE["gen_len"]) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            failures.append(f"{MLA_ARCH} {kvd}: served tokens malformed")
        prompt, follow = res.prompt.cpu(), toks[:, :LM_TF_STEPS]
        with capture_mla(keep) as cap:
            card = teacher_forced(cfg, params, prompt, follow, kvd, dev, max_len)
        captured[kvd] = cap.calls
        greedy = torch.stack([card[0][:, -1].argmax(-1)] + [
            lg[:, 0].argmax(-1) for lg in card[1:LM_TF_STEPS]], 1).to(torch.int32)
        same = bool(torch.equal(greedy, follow))
        finite = all(bool(torch.isfinite(lg).all()) for lg in card)
        print(f"{MLA_ARCH} {kvd}: served tokens equal the card's teacher-forced argmax "
              f"(prefill + {LM_TF_STEPS - 1} steps): {same}; logits finite: {finite}")
        if not (same and finite):
            failures.append(f"{MLA_ARCH} {kvd}: served tokens are not the card's greedy "
                            f"argmax, or its logits are not finite")
        out["runs"][kvd] = {"prefill_ms": res.prefill_ms, "decode_ms": res.decode_ms,
                            "tok_s": res.tok_s, "launches": launches, "greedy": same,
                            "launches_by_shape": by_shape, "cache": cache_kind(cfg, kvd)}
        cache = M.init_cache(cfg, LM_SERVE["batch"], max_len,
                             torch.int8 if kvd == "int8" else torch.float32, device=dev)
        nxt = res.tokens[:, :1]

        def prefill():
            with torch.no_grad():
                return M.prefill(cfg, params, cache, {"tokens": res.prompt})

        def decode():
            with torch.no_grad():
                return M.decode_step(cfg, params, cache, {"tokens": nxt},
                                     LM_SERVE["prompt_len"])

        for step, fn in (("prefill", prefill), ("decode", decode)):
            br = trace_breakdown(fn)
            out["service"][f"{kvd} {step}"] = br
            print(f"{MLA_ARCH} {kvd} warm {step}: wall {br['wall_ms']:.3f} ms (median of 5), "
                  f"device {br['device_ms']:.3f} ms in {br['device_ops']} device ops, "
                  f"idle share {br['idle_share']}; by class "
                  + ", ".join(f"{c} {ms:.3f}" for c, ms in
                              sorted(br["by_class_ms"].items(), key=lambda kv: -kv[1])))
        del cache

    print(f"{MLA_ARCH} MLA kernel checks ({MLA_TOL}):")
    for kvd, calls in captured.items():
        for idx in sorted(set(keep)):
            if idx not in calls:
                failures.append(f"{MLA_ARCH} {kvd}: MLA call {idx} not captured")
                continue
            args, kw_ = calls[idx]
            layer = idx % n_layers
            label = f"{'prefill' if idx < n_layers else 'decode'} layer {layer}"
            row = check_mla(book, label, args, kw_, timed=(layer == 0))
            if row is not None:
                out.setdefault("timed", {}).setdefault(row["kernel"], []).append(
                    {k: row[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                         "library_backend", "bound_ms", "flop_ms", "byte_ms")})
    del captured
    for name in ("flash_fwd_mla_f32", "flash_fwd_mla_bf16kv"):
        if len(out.get("timed", {}).get(name, [])) != 2:
            failures.append(f"{MLA_ARCH}: {name} was not timed at layer 0's served shapes")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mla_reduced(dev, failures) -> dict:
    """Reduced deepseek-v2 (2 layers, 4 heads on a 32-wide latent, 8 experts
    top-2 and 1 shared) drawn on the host: teacher-forced logits on the card
    (the MLA kernel) against the host (its plain version), within
    1e-4*max|host| over the fp32 latent cache and 2^-7*max over the bf16 one
    (the int8 request)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    cfg = get_config(MLA_ARCH, reduced=True)
    params_cpu = M.init_params(cfg, torch.Generator().manual_seed(LM_SERVE["seed"]),
                               device="cpu")
    params = tree_to(params_cpu, dev)
    gen = torch.Generator().manual_seed(LM_SERVE["seed"] + 1)
    prompt = torch.randint(0, cfg.vocab_size, (LM_SERVE["batch"], LM_SERVE["prompt_len"]),
                           generator=gen)
    follow = torch.randint(0, cfg.vocab_size, (LM_SERVE["batch"], LM_TF_STEPS), generator=gen)
    max_len = LM_SERVE["prompt_len"] + LM_TF_STEPS
    out = {}
    for kvd, rel in (("float32", 1e-4), ("int8", 2.0 ** -7)):
        card = teacher_forced(cfg, params, prompt, follow, kvd, dev, max_len)
        host = teacher_forced(cfg, params_cpu, prompt, follow, kvd, "cpu", max_len)
        err = max(float((c - h).abs().max()) for c, h in zip(card, host))
        scale = max(float(h.abs().max()) for h in host)
        ok = err <= rel * scale and all(bool(torch.isfinite(c).all()) for c in card)
        print(f"{MLA_ARCH} reduced, {kvd} requested ({'bf16' if kvd == 'int8' else 'fp32'} "
              f"latent cache), card vs host plain path, teacher-forced prefill + "
              f"{LM_TF_STEPS} decode steps: max_abs_err={err:.3e} (max|host|={scale:.3e}, "
              f"limit {rel:g}*max): {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{MLA_ARCH} reduced {kvd}: the card's logits disagree with the host")
        out[kvd] = {"max_abs_err": err, "max_host": scale, "ok": ok}
    return out


# training at full width: one MLA sublayer (layer 0's weights) at B 2, S 128
MLA_TRAIN = dict(batch=2, seq_len=128, seed=0)
# the MLA backward's longer timed shape: full width, 131,072 rows
MLA_LONG = dict(batch=1, seq_len=1024, seed=1)
# what a sublayer's gradients are held to, card against host, at fp32:
# the linear loss sum(out * g), the gradients' global norm, every leaf;
# and at bf16 (the bf16 train-step limits)
SUBLAYER_LIMITS = (1e-4, 1e-3, 1e-3)
SUBLAYER_BF16_LIMITS = (1e-2, 3e-2, 5e-2)


class capture_fn_bwd:
    """Within the block, record the operands of the first call of `name` in
    module `mod` (a name an autograd Function's backward calls: a wrapper,
    or the launch a wrapper calls), cloned, then run the call as usual."""

    def __init__(self, mod, name):
        self.mod_name, self.name, self.calls = mod, name, []

    def __enter__(self):
        import importlib

        self.mod = importlib.import_module(self.mod_name)
        self.orig = getattr(self.mod, self.name)

        def rec(*args, **kw):
            if not self.calls:
                self.calls.append((tuple(a.detach().clone() if a is not None else None
                                         for a in args), dict(kw)))
            return self.orig(*args, **kw)

        setattr(self.mod, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


def mla_bwd_bound(q, c_kv, kw, *, part, peak=None):
    """(op time, byte time) in ms of one MLA backward pass for these inputs:
    per visible (row, key) pair 2 (Dk + Dv + Dk) operations for dq (s, dp,
    ds.K) and 2 (2 Dk + 2 Dv) for dc_kv / dk_rope (s, dp, ds^T qs, p^T
    do), at `peak` (default: the rate of the operands' type, split-TF32 165
    TFLOP/s for fp32, the bf16 tensor cores' 989 for bf16); q and do of
    every row and the keys any row reads, in the operands' type, m, l,
    delta, and dq or dc_kv and dk_rope written once, over 3.35 TB/s."""
    b, sq, h, dk = q.shape
    sk, r = c_kv.shape[1], c_kv.shape[2]
    eb = c_kv.element_size()
    if peak is None:
        peak = PEAK_BF16_FLOPS if eb == 2 else PEAK_TF32_SPLIT_FLOPS
    pairs, keys = visible_pairs(sq, sk, kw["causal"], kw["q_offset"], kw["kv_len"])
    per = 2.0 * (2 * dk + r) if part == "dq" else 2.0 * (2 * dk + 2 * r)
    ops = per * b * h * pairs
    rows = b * sq * h
    nbytes = (eb * rows * (dk + r) + eb * b * keys * dk + 12.0 * rows
              + (eb * rows * dk if part == "dq" else eb * b * sk * dk))
    return ops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3


def mla_sdpa_backward(q, c_kv, k_rope, do, kw):
    """The memory-efficient attention backward op (SDPA's fused backend for
    a masked fp32 or bf16 call) on MLA's function: q (B, H, Sq, r + dr) over
    the keys [c_kv ; k_rope] and values c_kv expanded to the H heads, the
    same mask as an additive bias, fed by that op's own forward, all three
    gradients. Returns (fn, None), or (None, the reason) where the op takes
    no such call."""
    import torch

    b, sq, h, dk = q.shape
    sk = c_kv.shape[1]
    dt = c_kv.dtype
    qh = q.to(dt).transpose(1, 2).contiguous()
    kh = torch.cat([c_kv, k_rope], -1)[:, None].expand(b, h, sk, dk).contiguous()
    vh = c_kv[:, None].expand(b, h, sk, c_kv.shape[2]).contiguous()
    doh = do.transpose(1, 2).contiguous()
    mask = attention_mask(sq, sk, kw, q.device)
    bias = torch.zeros((sq, sk), device=q.device, dtype=dt).masked_fill(~mask, float("-inf"))
    bias = bias.expand(b, h, sq, sk)
    aten = torch.ops.aten
    try:
        o, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
            qh, kh, vh, bias, True, 0.0, False, scale=kw["scale"])

        def fn():
            return aten._scaled_dot_product_efficient_attention_backward(
                doh, qh, kh, vh, bias, o, lse, seed, offset, 0.0, [True, True, True, False],
                False, scale=kw["scale"])[:3]

        fn()
        torch.cuda.synchronize()
        return fn, None
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:200]


def check_mla_bwd(book, label, ops, kw, *, timed) -> list:
    """Both MLA backward passes against the plain version on captured
    operands (q, c_kv, k_rope, do, m, l, delta) at MLA_TOL's limits (fp32
    widened at the row maxes), each repeated bitwise; when `timed`, kernel /
    plain / SDPA's backward by CUDA-graph replay, and the bound. Returns the
    rows."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_bwd_mla, flash_bwd_mla_plain

    bf16 = ops[1].dtype == torch.bfloat16
    sfx = "_bf16" if bf16 else "_f32"
    fns = {part: (lambda part=part: flash_bwd_mla(*ops, part=part, **kw)) for part in
           ("dq", "dkv")}
    fns.update({f"{part}_plain": (lambda part=part: flash_bwd_mla_plain(*ops, part=part, **kw))
                for part in ("dq", "dkv")})
    fns["pair"] = lambda: flash_bwd_mla(*ops, **kw)  # both passes in one call, as autograd
    got = {part: fns[part]() for part in ("dq", "dkv")}
    again = {part: fns[part]() for part in ("dq", "dkv")}
    torch.cuda.synchronize()
    want = flash_bwd_mla_plain(*ops, **kw)
    m = ops[4][ops[4] > -1e29]
    widen = score_widening(float(m.abs().max()) if m.numel() else 0.0)
    tag = f"{label} q{tuple(ops[0].shape)} c_kv{tuple(ops[1].shape)} causal={kw['causal']}"
    for part, names, gs, ws in (("dq", ("dq",), (got["dq"],), want[:1]),
                                ("dkv", ("dc_kv", "dk_rope"), got["dkv"], want[1:])):
        name = f"flash_bwd_mla_{part}{sfx}"
        for n_, g_, w_ in zip(names, gs, ws):
            if bf16:
                book.check_bf16(name, f"{tag} {n_}", g_, w_)
            else:
                book.check(name, f"{tag} {n_}", g_, w_, widen=widen)
        same = all(torch.equal(x, y) for x, y in zip(
            (again[part],) if part == "dq" else again[part], gs))
        print(f"    {name} repeats bitwise: {same}")
        if not same:
            raise AssertionError(f"{name}: a repeat is not bitwise the same")
    if not timed:
        return []
    lib, why = mla_sdpa_backward(ops[0], ops[1], ops[2], ops[3], kw)
    if lib is not None:
        fns["library"] = lib
    t = time_graph_turns(fns)
    rows = []
    for part in ("dq", "dkv"):
        name = f"flash_bwd_mla_{part}{sfx}"
        ft, bt = mla_bwd_bound(ops[0], ops[1], kw, part=part)
        fc, _ = mla_bwd_bound(ops[0], ops[1], kw, part=part, peak=PEAK_FP32_FLOPS)
        row = {"kernel": name, "shape": label, "q": list(ops[0].shape),
               "c_kv": list(ops[1].shape), "ms": t[part], "plain_ms": t[part + "_plain"],
               "library_ms": t.get("library"), "library_note": why or
               "SDPA memory-efficient backward, all three gradients, q and the keys "
               "expanded to the H heads", "flop_ms": ft, "byte_ms": bt,
               "bound_ms": max(ft, bt), "bound_by": "operations" if ft >= bt else "bytes",
               "fp32_core_bound_ms": max(fc, bt), "pair_ms": t["pair"],
               "phase": MLA_ARCH + "-train"}
        book.rows.append(row)
        rows.append(row)
        lib_s = f"{t['library']:.4f}" if lib is not None else f"None ({why})"
        print(f"    {name} {label}: ms={t[part]:.4f} plain_ms={t[part + '_plain']:.4f} "
              f"library_ms={lib_s} bound_ms={max(ft, bt):.4f} ({row['bound_by']}; "
              f"{max(ft, bt) / t[part]:.1%} of it reached; CUDA cores {max(fc, bt):.4f}) "
              f"[CUDA-graph replay]")
    vs = (f"{t['library']:.4f} ({t['pair'] / t['library']:.2f}x)" if lib is not None
          else f"None ({why})")
    print(f"    flash_bwd_mla{sfx} {label}: dq + dkv in one call (as autograd makes it) "
          f"{t['pair']:.4f} ms (the passes apart {t['dq'] + t['dkv']:.4f}) against SDPA's "
          f"backward {vs}; each pass against its plain version: dq "
          f"{t['dq'] / t['dq_plain']:.2f}x, dkv {t['dkv'] / t['dkv_plain']:.2f}x")
    return rows


def mla_drawn_operands(dev, dtype, batch, seq_len, seed) -> tuple:
    """(args, kw) of an MLA backward at full width, `batch` x `seq_len`, 128
    heads, causal: q, c_kv, k_rope and do drawn unit-normal on the card in
    `dtype`, and m, l and delta from the kernel forward."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_fwd_mla, mla_delta

    cfg = get_config(MLA_ARCH)
    h, r, dr = cfg.n_heads, cfg.kv_lora_rank, cfg.rope_head_dim
    gen = torch.Generator(device=dev).manual_seed(seed)
    ops = [torch.randn(shape, device=dev, generator=gen).to(dtype)
           for shape in ((batch, seq_len, h, r + dr), (batch, seq_len, r),
                         (batch, seq_len, dr), (batch, seq_len, h, r))]
    kw = dict(scale=(cfg.nope_head_dim + dr) ** -0.5, causal=True, q_offset=0, kv_len=None)
    with torch.no_grad():
        o, m, l = flash_fwd_mla(*ops[:3], **kw)
        return (*ops, m, l, mla_delta(ops[3], o)), kw


def mla_long_backward(book, dev, failures) -> dict:
    """Both MLA backward passes at a longer shape than the sublayer's
    (`MLA_LONG`: full width, B 1 x S 1024, 131,072 rows, 67 M visible
    pairs), fp32 and bf16, on `mla_drawn_operands`: checked against the
    plain version and timed beside it, SDPA's backward and the bound
    (`check_mla_bwd`); the times gate nothing."""
    import torch

    b, s = MLA_LONG["batch"], MLA_LONG["seq_len"]
    out = {}
    for dtype, sfx in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        try:
            args, kw = mla_drawn_operands(dev, dtype, b, s, MLA_LONG["seed"])
            print(f"{MLA_ARCH} MLA backward at B {b} x S {s}, 128 heads, causal, {sfx}:")
            rows = check_mla_bwd(book, f"S {s}", args, kw, timed=True)
            out[sfx] = [{k: x[k] for k in ("kernel", "ms", "plain_ms", "library_ms",
                                          "bound_ms")} for x in rows]
            del args
        except Exception:
            traceback.print_exc()
            failures.append(f"{MLA_ARCH} MLA backward at S {s}, {sfx}, failed")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def sublayer_vs_host(name, fn, params, inputs, g, dev, failures, dtype=None) -> dict:
    """A sublayer's gradients on the card against the host's: `fn(params,
    inputs...)` -> out on each device from the same fp32 weights and inputs
    (cast to `dtype` on both when given: bfloat16 is held at
    SUBLAYER_BF16_LIMITS), the linear loss sum(out * g), the gradients'
    global norm and every leaf (the weights and the inputs) at
    SUBLAYER_LIMITS."""
    import torch

    bf16 = dtype == torch.bfloat16
    tag = "bf16" if bf16 else "fp32"
    res = {}
    for where in (dev, "cpu"):
        p = {k: v.detach().to(where, dtype).requires_grad_() for k, v in params.items()}
        xs = [x.detach().to(where, dtype).requires_grad_() for x in inputs]
        gw = g.to(where, dtype)
        t0 = time.perf_counter()
        out = fn(p, *xs)
        grads = torch.autograd.grad(out, list(p.values()) + xs, gw)
        loss = float((out.detach().float() * gw.float()).sum())
        if str(where) != "cpu":
            torch.cuda.synchronize()
        res[str(where)] = (loss, [t.detach().float().cpu() for t in grads],
                           time.perf_counter() - t0)
        del p, xs, grads, out
    (lc, gc_, sc), (lh, gh, sh) = res[str(dev)], res["cpu"]
    lim_loss, lim_norm, lim_leaf = SUBLAYER_BF16_LIMITS if bf16 else SUBLAYER_LIMITS
    nc = float(torch.stack([t.norm() for t in gc_]).norm())
    nh = float(torch.stack([t.norm() for t in gh]).norm())
    names = list(params) + [f"input{i}" for i in range(len(inputs))]
    worst, bad = 0.0, []
    for n_, a, b in zip(names, gc_, gh):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        worst = max(worst, err / scale if scale else err)
        if not err <= lim_leaf * scale:
            bad.append(n_)
    ok_loss = abs(lc - lh) <= lim_loss * abs(lh)
    ok_norm = abs(nc - nh) <= lim_norm * nh
    print(f"{name} full-width sublayer {tag} gradients, card vs host: loss {lc:.6e} vs {lh:.6e} "
          f"({'ok' if ok_loss else 'FAIL'}, {lim_loss:g} rel), grad norm {nc:.6e} vs "
          f"{nh:.6e} ({'ok' if ok_norm else 'FAIL'}, {lim_norm:g} rel), worst leaf "
          f"max|card - host| / max|host| {worst:.2e} ({'ok' if not bad else bad}, "
          f"{lim_leaf:g}); card {sc:.2f} s, host {sh:.2f} s")
    if not (ok_loss and ok_norm) or bad:
        failures.append(f"{name} sublayer: card {tag} gradients disagree with the host")
    return {"loss": [lc, lh], "grad_norm": [nc, nh], "worst_leaf_rel": worst,
            "host_s": sh}


def mla_sublayer(book, dev, failures) -> dict:
    """deepseek-v2's MLA sublayer at full width (128 heads on a 512-wide
    latent, Dk 576 / Dv 512), weights drawn on the card, at B 2 x S 128:
    forward and backward through `mla_attention` (MLAAttentionFn) at fp32
    and bf16 with the MLA counters set to 0 just before and read just after
    (the forward and each backward pass once), both backward passes against
    their plain version on the captured operands (timed, beside SDPA's
    backward), and at fp32 and bf16 the sublayer's gradients against the
    host's (bf16: the forward's rows see up to 128 keys, past the key ring
    that holds 64 over a bf16 latent)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.models import attention as A

    cfg = get_config(MLA_ARCH)
    b, s = MLA_TRAIN["batch"], MLA_TRAIN["seq_len"]
    gen = torch.Generator(device=dev).manual_seed(MLA_TRAIN["seed"])
    p32 = A.init_mla(gen, cfg, place=lambda t, axes: t.to(dev))
    x32 = torch.randn((b, s, cfg.d_model), device=dev, generator=gen)
    g32 = torch.randn((b, s, cfg.d_model), device=dev, generator=gen)
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    gb = sum(t.numel() * t.element_size() for t in p32.values()) / 1e9
    print(f"{MLA_ARCH} MLA sublayer at full width: {gb:.2f} GB of fp32 weights drawn on the "
          f"card; B {b} x S {s}, {cfg.n_heads} heads, Dk {cfg.kv_lora_rank + cfg.rope_head_dim}"
          f" / Dv {cfg.kv_lora_rank}")

    def fwd(p, x):
        return A.mla_attention(p, x, cfg=cfg, positions=pos.to(x.device))[0]

    out = {"weight_gb": gb, "runs": {}}
    for dtype, sfx in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        p = {k: v.to(dtype).requires_grad_() for k, v in p32.items()}
        x = x32.to(dtype).requires_grad_()
        before = dict(kcuda.MLA_ENTRY_LAUNCHES)
        with capture_fn_bwd("repro_torch.kernels.flash_attention.ops", "flash_bwd_mla") as cap:
            y = fwd(p, x)
            grads = torch.autograd.grad(y, list(p.values()) + [x], g32.to(dtype))
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in kcuda.MLA_ENTRY_LAUNCHES.items()
                    if n != before[k]}
        want = {"repro_flash_fwd_mla_" + ("bf16kv" if sfx == "bf16" else "f32"): 1,
                f"repro_flash_bwd_mla_dq_{sfx}": 1, f"repro_flash_bwd_mla_dkv_{sfx}": 1}
        finite = all(bool(torch.isfinite(t).all()) for t in grads)
        print(f"{MLA_ARCH} sublayer {sfx} forward + backward: launches {launched} (expected "
              f"{want}); gradients finite: {finite}")
        if launched != want or not finite:
            failures.append(f"{MLA_ARCH} sublayer {sfx}: launches {launched} or non-finite "
                            f"gradients")
        del y, grads, p, x
        args, kw = cap.calls[0]
        print(f"{MLA_ARCH} MLA backward kernel checks, {sfx} ({MLA_TOL}):")
        rows = check_mla_bwd(book, "sublayer", args, kw, timed=True)
        out["runs"][sfx] = {"launches": launched,
                            "timed": [{k: r[k] for k in ("kernel", "ms", "plain_ms",
                                                         "library_ms", "bound_ms")}
                                      for r in rows]}
        del args, cap
        gc.collect()
        torch.cuda.empty_cache()
    out["host"] = sublayer_vs_host(MLA_ARCH + " MLA", fwd, p32, [x32], g32, dev, failures)
    out["host_bf16"] = sublayer_vs_host(MLA_ARCH + " MLA", fwd, p32, [x32], g32, dev, failures,
                                        dtype=torch.bfloat16)
    return out


def mla_train(book, dev, failures) -> dict:
    """The MLA family's training: the full-width sublayer (`mla_sublayer`),
    one fp32 train step of the reduced config (`fp32_train_step`), and 3
    bf16 steps of it beside the host (`dense_train`; qk_norm does not reach
    MLA, whose latents are always normed, so the registered config is held
    at all three limits)."""
    return {"sublayer": mla_sublayer(book, dev, failures),
            "long": mla_long_backward(book, dev, failures),
            "fp32_step": fp32_train_step(MLA_ARCH, dev, failures),
            "reduced": dense_train(dev, failures, archs=(MLA_ARCH,), variants=("registered",),
                                   held={"registered": ("grad_norm", "leaves")}, trace=True)}


def mla_phase(book, dev, failures) -> dict:
    """The MLA family (see `mla_serve`, `mla_reduced`, `mla_train`); memory
    reserved before it and the peak in it."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {"memory_reserved_before_gib": torch.cuda.memory_reserved() / 2**30}
    print(f"MLA phase: memory_reserved before it {out['memory_reserved_before_gib']:.2f} GiB")
    for key, fn in (("serve", lambda: mla_serve(book, dev, failures)),
                    ("long_decode", lambda: mla_long_decode(book, dev, failures)),
                    ("reduced", lambda: mla_reduced(dev, failures)),
                    ("train", lambda: mla_train(book, dev, failures))):
        try:
            out[key] = fn()
        except Exception:
            traceback.print_exc()
            failures.append(f"{MLA_ARCH} {key} failed")
        gc.collect()
        torch.cuda.empty_cache()
    out["peak_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["seconds"] = time.perf_counter() - t0
    print(f"MLA phase: peak memory_allocated {out['peak_allocated_gib']:.2f} GiB; "
          f"{out['seconds']:.1f} s")
    return out


SSM_ARCH = "jamba-v0.1-52b"
# depth 8 of 32: one interleave group [mamba x4, attn, mamba x3], the least
# depth the group layout allows; 53.18 GB of fp32 weights (one layer's
# largest leaf, an expert leaf, is 3.76 GB)
SSM_LAYERS = 8
XLSTM_ARCH = "xlstm-125m"
# xlstm serves a 128-token prompt, so that every mLSTM prefill takes the
# chunkwise form (chunk 128), then decodes on the sequential one
XLSTM_SERVE = dict(LM_SERVE, prompt_len=128)
SCAN_ENTRY = "repro_selective_scan_f32"


class capture_scan:
    """Within the block, record the operands of the selective-scan calls
    whose running index is in `keep` (cloned), then run the call as usual."""

    def __init__(self, keep):
        self.keep, self.calls, self.n = set(keep), {}, 0

    def __enter__(self):
        import repro_torch.models.ssm as S

        self.S, self.orig = S, S.selective_scan

        def rec(*args):
            if self.n in self.keep:
                self.calls[self.n] = tuple(a.clone() for a in args)
            self.n += 1
            return self.orig(*args)

        S.selective_scan = rec
        return self

    def __exit__(self, *exc):
        self.S.selective_scan = self.orig


class count_chunkwise:
    """Count the chunkwise mLSTM's calls within the block."""

    def __enter__(self):
        import repro_torch.models.xlstm as X

        self.X, self.orig, self.n = X, X._mlstm_chunkwise, 0

        def rec(*args):
            self.n += 1
            return self.orig(*args)

        X._mlstm_chunkwise = rec
        return self

    def __exit__(self, *exc):
        self.X._mlstm_chunkwise = self.orig


def scan_bound(args):
    """(op time, byte time) in ms of the selective scan: per channel and
    step 7 fp32 operations per state (dt * A, its exp, the decay, the input
    product and sum, the output product and sum) and 7 for the skip and the
    gate, at 67 TFLOP/s; x, dt, z, D (in the activation type), B, C, A and
    h0 read once, out and h_last written once, over 3.35 TB/s."""
    x, _, a, bm, _, _, _, h0 = args
    b, s, di = x.shape
    n = a.shape[1]
    eb = x.element_size()
    ops = float(b * s * di * (7 * n + 7))
    nbytes = (eb * (4 * b * s * di + di)
              + 4.0 * (2 * b * s * n + a.numel() + 2 * h0.numel()))
    return ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3


def check_scan(book, label, args, *, timed) -> dict | None:
    """The selective scan against its plain version (out and h_last, the
    fp32 limit); when `timed`, kernel and plain by CUDA-graph replay and
    eager, and the bound. No single PyTorch call computes this function:
    the row's library time is None."""
    import torch

    from repro_torch.kernels.selective_scan.kernel import selective_scan, selective_scan_plain

    kernel = lambda: selective_scan(*args)  # noqa: E731
    plain = lambda: selective_scan_plain(*args)  # noqa: E731
    with torch.no_grad():
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
    tag = f"{label} x{tuple(args[0].shape)} N={args[2].shape[1]}"
    for part, g_, w_ in zip(("out", "h_last"), got, want):
        book.check("selective_scan", f"{tag} {part}", g_, w_)
    if not timed:
        return None
    fns = {"kernel": kernel, "plain": plain}
    with torch.no_grad():
        t = time_graph_turns(fns)
        te = time_turns(fns)
    ft, bt = scan_bound(args)
    row = {"kernel": "selective_scan", "shape": label, "x": list(args[0].shape),
           "n": args[2].shape[1], "ms": t["kernel"], "plain_ms": t["plain"], "library_ms": None,
           "eager_ms": te["kernel"], "eager_plain_ms": te["plain"], "flop_ms": ft,
           "byte_ms": bt, "bound_ms": max(ft, bt),
           "bound_by": "operations" if ft >= bt else "bytes", "phase": SSM_ARCH}
    book.rows.append(row)
    print(f"    selective_scan {label}: ms={t['kernel']:.4f} plain_ms={t['plain']:.4f} "
          f"library_ms=None (no single PyTorch call) bound_ms={max(ft, bt):.4f} "
          f"({row['bound_by']}) [CUDA-graph replay]; eager calls: {te['kernel']:.4f} / "
          f"{te['plain']:.4f} ms")
    return row


def recurrent_counts() -> dict:
    """The scan and GQA flash launches since `recurrent_reset`, per entry
    point, and the wrappers' own counts."""
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels.flash_attention.kernel import flash_fwd, flash_fwd_q8
    from repro_torch.kernels.selective_scan.kernel import selective_scan

    return {SCAN_ENTRY: kcuda.SCAN_ENTRY_LAUNCHES[SCAN_ENTRY],
            **{k: kcuda.FLASH_ENTRY_LAUNCHES[k] for k in ("repro_flash_fwd_f32",
                                                          "repro_flash_fwd_q8")},
            **{k: kcuda.MLA_ENTRY_LAUNCHES[k] for k in MLA_ENTRIES},
            "wrappers": {"selective_scan": selective_scan.launches,
                         "flash_fwd": flash_fwd.launches, "flash_fwd_q8": flash_fwd_q8.launches}}


def recurrent_reset() -> None:
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels.selective_scan.kernel import selective_scan

    mla_reset()  # the flash and MLA counters
    kcuda.SCAN_ENTRY_LAUNCHES[SCAN_ENTRY] = 0
    selective_scan.launches = 0


def serve_and_hold(name, cfg, params, run, kvd, dev, failures, *, expect) -> tuple:
    """One served run through `serve(cfg, params=...)` after a 2-token
    warm-up, the launch counters set to 0 just before it and read just
    after and held to `expect` (entry point -> launches; every other entry
    0), then the served tokens against the card's teacher-forced argmax
    (prefill + LM_TF_STEPS - 1 steps). Returns (the run's summary, the
    ServeResult)."""
    import torch

    from repro_torch.launch.serve import cache_kind, serve

    serve(cfg, device=dev, kv_cache_dtype=kvd, params=params, **dict(run, gen_len=2))
    recurrent_reset()
    res = serve(cfg, device=dev, kv_cache_dtype=kvd, params=params, **run)
    launches = recurrent_counts()
    wrappers = launches.pop("wrappers")
    print(f"{name} served ({cache_kind(cfg, kvd)} cache, {kvd} requested): batch "
          f"{run['batch']}, prompt {run['prompt_len']}, {run['gen_len']} tokens: prefill "
          f"{res.prefill_ms:.2f} ms, decode {res.decode_ms:.3f} ms/step, {res.tok_s:.1f} "
          f"tok/s; launches {launches} (wrappers {wrappers}; expected {expect}, none of "
          f"the others)")
    want = {k: expect.get(k, 0) for k in launches}
    want_wrappers = {"selective_scan": expect.get(SCAN_ENTRY, 0),
                     "flash_fwd": expect.get("repro_flash_fwd_f32", 0),
                     "flash_fwd_q8": expect.get("repro_flash_fwd_q8", 0)}
    if launches != want or wrappers != want_wrappers:
        failures.append(f"{name} {kvd}: launches {launches} (wrappers {wrappers}), expected "
                        f"{expect} and none of the others")
    toks = res.tokens.cpu()
    if toks.shape != (run["batch"], run["gen_len"]) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        failures.append(f"{name} {kvd}: served tokens malformed")
    return {"prefill_ms": res.prefill_ms, "decode_ms": res.decode_ms, "tok_s": res.tok_s,
            "launches": launches, "cache": cache_kind(cfg, kvd)}, res


def hold_greedy(name, kvd, card, follow, failures) -> bool:
    import torch

    greedy = torch.stack([card[0][:, -1].argmax(-1)] + [
        lg[:, 0].argmax(-1) for lg in card[1:LM_TF_STEPS]], 1).to(torch.int32)
    same = bool(torch.equal(greedy, follow))
    finite = all(bool(torch.isfinite(lg).all()) for lg in card)
    print(f"{name} {kvd}: served tokens equal the card's teacher-forced argmax "
          f"(prefill + {LM_TF_STEPS - 1} steps): {same}; logits finite: {finite}")
    if not (same and finite):
        failures.append(f"{name} {kvd}: served tokens are not the card's greedy argmax, or "
                        f"its logits are not finite")
    return same


def trace_steps(name, cfg, params, res, kvd, run, dev, inputs=None) -> dict:
    """A torch.profiler trace of one warm prefill and one warm decode step
    (`trace_breakdown`) over a fresh cache of the served request's type,
    fed `inputs` (on `dev`) as `teacher_forced` takes them."""
    import torch

    from repro_torch.models import model as M

    pre, dec = inputs or ({}, {})
    cache = M.init_cache(cfg, run["batch"], run["prompt_len"] + run["gen_len"],
                         torch.int8 if kvd == "int8" else torch.float32, device=dev)
    nxt = res.tokens[:, :1]

    def prefill():
        with torch.no_grad():
            return M.prefill(cfg, params, cache, {"tokens": res.prompt, **pre})

    def decode():
        with torch.no_grad():
            return M.decode_step(cfg, params, cache, {"tokens": nxt, **dec},
                                 run["prompt_len"])

    out = {}
    for step, fn in (("prefill", prefill), ("decode", decode)):
        br = trace_breakdown(fn)
        out[f"{kvd} {step}"] = br
        print(f"{name} {kvd} warm {step}: wall {br['wall_ms']:.3f} ms (median of 5), "
              f"device {br['device_ms']:.3f} ms in {br['device_ops']} device ops, idle share "
              f"{br['idle_share']}; by class "
              + ", ".join(f"{c} {ms:.3f}" for c, ms in
                          sorted(br["by_class_ms"].items(), key=lambda kv: -kv[1])))
    return out


def draw_on_card(name, cfg, dev, note) -> tuple:
    """Weights drawn on the card from a CUDA generator (seconds, GB, peak)."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves

    out = {"n_layers": cfg.n_layers, "n_params": cfg.n_params(),
           "n_active_params": cfg.n_active_params()}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(LM_SERVE["seed"]),
                           device=dev)
    torch.cuda.synchronize()
    out["card_draw_s"] = time.perf_counter() - t0
    out["weight_gb"] = sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9
    out["draw_peak_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"{name} at full width, {note}: {out['n_params']:,} params "
          f"({out['n_active_params']:,} active per token), {out['weight_gb']:.2f} GB at fp32, "
          f"drawn on the card in {out['card_draw_s']:.2f} s; peak memory_allocated while "
          f"drawing {out['draw_peak_allocated_gib']:.2f} GiB")
    return params, out


def jamba_serve(book, dev, failures) -> dict:
    """jamba-v0.1-52b at full width cut to SSM_LAYERS (one interleave
    group): weights drawn on the card, served over the fp32 and the int8 KV
    cache (beside the fp32 recurrent state) with the counters set to 0 just
    before and read just after: 7 x 32 scan launches and 32 of the request's
    flash entry (head dim 128, G 4); the served tokens against the card's
    teacher-forced argmax; warm prefill / decode traces; the scan at the
    captured prefill and decode operands of the first and last Mamba layer
    against its plain version, layer 0 timed; the flash kernel at the
    attention layer's captured prefill and decode operands."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(SSM_ARCH), n_layers=SSM_LAYERS)
    lay = T.group_layout(cfg)
    n_mamba, n_attn = sum(s.kind == "mamba" for s in lay), sum(s.kind == "attn" for s in lay)
    params, out = draw_on_card(SSM_ARCH, cfg, dev, f"depth {cfg.n_layers} (of 32), one group "
                               f"{[s.kind for s in lay]}, {cfg.n_experts} experts top-"
                               f"{cfg.top_k} on {sum(s.ffn == 'moe' for s in lay)} layers, "
                               f"d_inner {cfg.ssm_expand * cfg.d_model}, N {cfg.ssm_state_dim}")
    out.update(runs={}, service={})
    run = LM_SERVE
    max_len = run["prompt_len"] + run["gen_len"]
    keep_scan = (0, n_mamba - 1, n_mamba, 2 * n_mamba - 1)  # prefill and first decode
    keep_attn = (0, n_attn)
    scans, attns = {}, {}
    for kvd, entry in (("float32", "repro_flash_fwd_f32"), ("int8", "repro_flash_fwd_q8")):
        expect = {SCAN_ENTRY: n_mamba * run["gen_len"], entry: n_attn * run["gen_len"]}
        summary, res = serve_and_hold(SSM_ARCH, cfg, params, run, kvd, dev, failures,
                                      expect=expect)
        prompt, follow = res.prompt.cpu(), res.tokens.cpu()[:, :LM_TF_STEPS]
        with capture_scan(keep_scan) as cap, capture_attention(keep_attn) as acap:
            card = teacher_forced(cfg, params, prompt, follow, kvd, dev, max_len)
        scans[kvd], attns[kvd] = cap.calls, acap.calls
        summary["greedy"] = hold_greedy(SSM_ARCH, kvd, card, follow, failures)
        out["runs"][kvd] = summary
        out["service"].update(trace_steps(SSM_ARCH, cfg, params, res, kvd, run, dev))
    print(f"{SSM_ARCH} selective scan checks ({KERNEL_TOL}):")
    for kvd, calls in scans.items():
        for idx in keep_scan:
            if idx not in calls:
                failures.append(f"{SSM_ARCH} {kvd}: scan call {idx} not captured")
                continue
            step = "prefill" if idx < n_mamba else "decode"
            layer = [i for i, s in enumerate(lay) if s.kind == "mamba"][idx % n_mamba]
            row = check_scan(book, f"{step} layer {layer}", calls[idx],
                             timed=(kvd == "float32" and layer == 0))
            if row is not None:
                out.setdefault("timed", []).append(
                    {k: row[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "flop_ms",
                                         "byte_ms", "eager_ms", "eager_plain_ms")})
    if len(out.get("timed", [])) != 2:
        failures.append(f"{SSM_ARCH}: the scan was not timed at layer 0's served shapes")
    attn_layer = [i for i, s in enumerate(lay) if s.kind == "attn"][0]
    for kvd, calls in attns.items():
        for idx in keep_attn:
            if idx not in calls:
                failures.append(f"{SSM_ARCH} {kvd}: attention call {idx} not captured")
                continue
            args, kw_ = calls[idx]
            step = "prefill" if idx < n_attn else "decode"
            check_flash(book, f"{step} layer {attn_layer}", args, kw_, timed=False,
                        phase=SSM_ARCH, saturated=True)
    del params, scans, attns
    gc.collect()
    torch.cuda.empty_cache()
    return out


def xlstm_serve(dev, failures) -> dict:
    """xlstm-125m at full width and depth (12 layers): weights drawn on the
    card, served at prompt 128 (every mLSTM prefill chunkwise: 6 calls of
    the chunkwise form per prefill) and 32 tokens, once per request type
    (both give the same recurrent state), the counters set to 0 just before
    and read just after (no kernel of the port is on this path: all 0); the
    served tokens against the card's teacher-forced argmax; warm prefill /
    decode traces."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T

    cfg = get_config(XLSTM_ARCH)
    lay = T.group_layout(cfg)
    n_mlstm = T.n_groups(cfg) * sum(s.kind == "mlstm" for s in lay)
    params, out = draw_on_card(XLSTM_ARCH, cfg, dev, f"full depth {cfg.n_layers}, groups "
                               f"{[s.kind for s in lay]}, {cfg.n_heads} heads")
    out.update(runs={}, service={})
    run = XLSTM_SERVE
    for kvd in ("float32", "int8"):
        with count_chunkwise() as chunked:
            summary, res = serve_and_hold(XLSTM_ARCH, cfg, params, run, kvd, dev, failures,
                                          expect={})
        # the warm-up and the served run each prefill once
        summary["chunkwise_calls"] = chunked.n
        print(f"{XLSTM_ARCH} {kvd}: chunkwise mLSTM calls over the warm-up and the served "
              f"run {chunked.n} (expected {2 * n_mlstm}: {n_mlstm} per prefill)")
        if chunked.n != 2 * n_mlstm:
            failures.append(f"{XLSTM_ARCH} {kvd}: the prefill did not take the chunkwise mLSTM")
        prompt, follow = res.prompt.cpu(), res.tokens.cpu()[:, :LM_TF_STEPS]
        card = teacher_forced(cfg, params, prompt, follow, kvd, dev,
                              run["prompt_len"] + run["gen_len"])
        summary["greedy"] = hold_greedy(XLSTM_ARCH, kvd, card, follow, failures)
        out["runs"][kvd] = summary
        out["service"].update(trace_steps(XLSTM_ARCH, cfg, params, res, kvd, run, dev))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def recurrent_reduced(dev, failures) -> dict:
    """Reduced jamba (one group at d_model 128, di 256, N 8) and xlstm (2
    layers), drawn on the host: teacher-forced logits on the card (the scan
    kernel, flash, cuBLAS) against the host's plain path over the fp32 and
    the int8 request (`card_vs_host`: rtol 1e-3 + 1e-3 * max|host|, the int8
    rounding pinned); xlstm at prompt 128 (chunkwise prefill)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    out = {}
    for arch, prompt_len in ((SSM_ARCH, LM_SERVE["prompt_len"]),
                             (XLSTM_ARCH, XLSTM_SERVE["prompt_len"])):
        cfg = get_config(arch, reduced=True)
        params_cpu = M.init_params(cfg, torch.Generator().manual_seed(LM_SERVE["seed"]),
                                   device="cpu")
        params = tree_to(params_cpu, dev)
        gen = torch.Generator().manual_seed(LM_SERVE["seed"] + 1)
        prompt = torch.randint(0, cfg.vocab_size, (LM_SERVE["batch"], prompt_len),
                               generator=gen)
        follow = torch.randint(0, cfg.vocab_size, (LM_SERVE["batch"], LM_TF_STEPS),
                               generator=gen)
        for kvd in ("float32", "int8"):
            out[f"{arch} {kvd}"] = card_vs_host(f"{arch} reduced", cfg, params, params_cpu,
                                                prompt, follow, kvd, dev,
                                                prompt_len + LM_TF_STEPS, failures)
    return out


# training at full width: one Mamba sublayer (layer 0's weights) at B 4, S 128
SSM_TRAIN = dict(batch=4, seq_len=128, seed=0)


def scan_bwd_bound(args):
    """(op time, byte time) in ms of the scan's backward: per channel, step
    and state about 20 fp32 operations (the states recomputed: the decay's
    exp, the update; then dh, dB, dC, du, the decay's gradient, dA, ddt)
    and 20 per channel and step for the gate and the skip, at 67 TFLOP/s;
    x, dt, z, dout, D (activation type), B, C, A, h0, dh_last read once and
    dx, ddt, dz, dD, dB, dC, dA, dh0 written once, over 3.35 TB/s."""
    x, _, a, bm, _, _, _, h0 = args[:8]
    b, s, di = x.shape
    n = a.shape[1]
    eb = x.element_size()
    ops = float(b * s * di * (20 * n + 20))
    nbytes = (eb * (7 * b * s * di + 2 * di)
              + 4.0 * (4 * b * s * n + 2 * a.numel() + 3 * h0.numel()))
    return ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3


def check_scan_train(book, label, args, dout, dh_last, *, timed) -> list:
    """The scan's forward (the activation type's entry) and backward against
    their plain versions on captured training operands, the backward
    repeated bitwise; when `timed`, kernel and plain by CUDA-graph replay
    and the bounds (no single PyTorch call computes either: library None).
    Returns the rows (the backward's, and the bf16 forward's)."""
    import torch

    from repro_torch.kernels.selective_scan.kernel import (
        selective_scan,
        selective_scan_bwd,
        selective_scan_bwd_plain,
        selective_scan_plain,
    )

    bf16 = args[0].dtype == torch.bfloat16
    sfx = "_bf16" if bf16 else "_f32"
    fwd_name = "selective_scan_bf16" if bf16 else "selective_scan"
    fns = {"fwd": lambda: selective_scan(*args), "fwd_plain": lambda: selective_scan_plain(*args),
           "bwd": lambda: selective_scan_bwd(*args, dout, dh_last),
           "bwd_plain": lambda: selective_scan_bwd_plain(*args, dout, dh_last)}
    tag = f"{label} x{tuple(args[0].shape)} N={args[2].shape[1]}"
    check = book.check_bf16 if bf16 else book.check
    with torch.no_grad():
        got_f, got_b, again = fns["fwd"](), fns["bwd"](), fns["bwd"]()
        torch.cuda.synchronize()
        want_f, want_b = fns["fwd_plain"](), fns["bwd_plain"]()
    for part, g_, w_ in zip(("out", "h_last"), got_f, want_f):
        (book.check if part == "h_last" else check)(fwd_name, f"{tag} {part}", g_, w_)
    for part, g_, w_ in zip(("dx", "ddt", "da", "db", "dc", "dd", "dz", "dh0"), got_b, want_b):
        (check if g_.dtype == torch.bfloat16 else book.check)(
            "selective_scan_bwd" + sfx, f"{tag} {part}", g_, w_)
    same = all(torch.equal(x, y) for x, y in zip(got_b, again))
    print(f"    selective_scan_bwd{sfx} repeats bitwise: {same}")
    if not same:
        raise AssertionError(f"selective_scan_bwd{sfx}: a repeat is not bitwise the same")
    if not timed:
        return []
    if not bf16:  # the fp32 forward is timed at the served shapes
        del fns["fwd"], fns["fwd_plain"]
    with torch.no_grad():
        t = time_graph_turns(fns)
    rows = []
    for key, name, (ft, bt) in (("bwd", "selective_scan_bwd" + sfx, scan_bwd_bound(args)),
                                ("fwd", fwd_name, scan_bound(args))):
        if key not in t:
            continue
        row = {"kernel": name, "shape": label, "x": list(args[0].shape),
               "n": args[2].shape[1], "ms": t[key], "plain_ms": t[key + "_plain"],
               "library_ms": None, "flop_ms": ft, "byte_ms": bt, "bound_ms": max(ft, bt),
               "bound_by": "operations" if ft >= bt else "bytes", "phase": SSM_ARCH + "-train"}
        book.rows.append(row)
        rows.append(row)
        print(f"    {name} {label}: ms={t[key]:.4f} plain_ms={t[key + '_plain']:.4f} "
              f"library_ms=None (no single PyTorch call) bound_ms={max(ft, bt):.4f} "
              f"({row['bound_by']}) [CUDA-graph replay]")
    return rows


def mamba_sublayer(book, dev, failures) -> dict:
    """jamba's Mamba sublayer at full width (d_model 4096, di 8192, N 16),
    weights drawn on the card, at B 4 x S 128: forward and backward through
    `mamba_block` (SelectiveScanFn) at fp32 and bf16 with the scan counters
    set to 0 just before and read just after (the forward and the backward
    once), the scan's forward and backward against their plain versions on
    the captured operands (timed), and at fp32 the sublayer's gradients
    against the host's."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.models import ssm as S

    cfg = get_config(SSM_ARCH)
    b, s = SSM_TRAIN["batch"], SSM_TRAIN["seq_len"]
    gen = torch.Generator(device=dev).manual_seed(SSM_TRAIN["seed"])
    p32 = S.init_mamba(gen, cfg, place=lambda t, axes: t.to(dev))
    x32 = torch.randn((b, s, cfg.d_model), device=dev, generator=gen)
    g32 = torch.randn((b, s, cfg.d_model), device=dev, generator=gen)
    gb = sum(t.numel() * t.element_size() for t in p32.values()) / 1e9
    print(f"{SSM_ARCH} Mamba sublayer at full width: {gb:.2f} GB of fp32 weights drawn on the "
          f"card; B {b} x S {s}, di {S._d_inner(cfg)}, N {cfg.ssm_state_dim}")

    def fwd(p, x):
        return S.mamba_block(p, x, cfg)[0]

    out = {"weight_gb": gb, "runs": {}}
    for dtype, sfx in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        p = {k: v.to(dtype).requires_grad_() for k, v in p32.items()}
        x = x32.to(dtype).requires_grad_()
        before = dict(kcuda.SCAN_ENTRY_LAUNCHES)
        with capture_fn_bwd("repro_torch.kernels.selective_scan.kernel",
                            "launch_selective_scan_bwd") as cap:
            y = fwd(p, x)
            grads = torch.autograd.grad(y, list(p.values()) + [x], g32.to(dtype))
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in kcuda.SCAN_ENTRY_LAUNCHES.items()
                    if n != before[k]}
        want = {f"repro_selective_scan_{sfx}": 1, f"repro_selective_scan_bwd_{sfx}": 1}
        finite = all(bool(torch.isfinite(t).all()) for t in grads)
        print(f"{SSM_ARCH} sublayer {sfx} forward + backward: launches {launched} (expected "
              f"{want}); gradients finite: {finite}")
        if launched != want or not finite:
            failures.append(f"{SSM_ARCH} sublayer {sfx}: launches {launched} or non-finite "
                            f"gradients")
        del y, grads, p, x
        args, _ = cap.calls[0]
        print(f"{SSM_ARCH} scan kernel checks at training, {sfx} ({KERNEL_TOL}):")
        rows = check_scan_train(book, "sublayer", args[:8], args[8], args[9], timed=True)
        out["runs"][sfx] = {"launches": launched,
                            "timed": [{k: r[k] for k in ("kernel", "ms", "plain_ms", "bound_ms")}
                                      for r in rows]}
        del args, cap
        gc.collect()
        torch.cuda.empty_cache()
    out["host"] = sublayer_vs_host(SSM_ARCH + " Mamba", fwd, p32, [x32], g32, dev, failures)
    return out


def jamba_train(book, dev, failures) -> dict:
    """The hybrid family's training: the full-width Mamba sublayer
    (`mamba_sublayer`), one fp32 train step of the reduced jamba
    (`fp32_train_step`), and 3 bf16 steps of it beside the host
    (`dense_train`: registered, and with qk_norm on, which holds the loss
    and the grad norm; its leaves are rounding-decided on the host itself,
    whose bf16 gradients lie up to ~40% of a Mamba or expert leaf's max
    from its fp32 ones)."""
    return {"sublayer": mamba_sublayer(book, dev, failures),
            "fp32_step": fp32_train_step(SSM_ARCH, dev, failures),
            "reduced": dense_train(dev, failures, archs=(SSM_ARCH,),
                                   held={"qk_norm": ("grad_norm",)}, trace=True)}


def cross_train(dev, failures) -> dict:
    """3 bf16 steps of the reduced llama-3.2-vision and whisper-tiny beside
    the host (`dense_train`: gates at CROSS_GATE, unit-normal side inputs;
    registered, and with qk_norm on, which holds all three limits for the
    VLM, the loss and the grad norm for whisper: its cross layer's wq, wk
    and norm gradients peak near 5e-5 and the host's own bf16 ones lie ~10%
    of that from its fp32 ones)."""
    return {**dense_train(dev, failures, archs=(CROSS_ARCH,), trace=True),
            **dense_train(dev, failures, archs=(AUDIO_ARCH,),
                          held={"qk_norm": ("grad_norm",)}, trace=True)}


def recurrent_phase(book, dev, failures) -> dict:
    """The recurrent-state families (see `jamba_serve`, `xlstm_serve`,
    `recurrent_reduced`, `jamba_train`); memory reserved before it and the
    peak in it."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {"memory_reserved_before_gib": torch.cuda.memory_reserved() / 2**30}
    print(f"recurrent phase: memory_reserved before it "
          f"{out['memory_reserved_before_gib']:.2f} GiB")
    peak = 0.0  # each part's draw resets the peak: keep the largest
    for key, fn in (("jamba", lambda: jamba_serve(book, dev, failures)),
                    ("xlstm", lambda: xlstm_serve(dev, failures)),
                    ("reduced", lambda: recurrent_reduced(dev, failures)),
                    ("train", lambda: jamba_train(book, dev, failures))):
        try:
            out[key] = fn()
        except Exception:
            traceback.print_exc()
            failures.append(f"recurrent phase: {key} failed")
        peak = max(peak, torch.cuda.max_memory_allocated())
        gc.collect()
        torch.cuda.empty_cache()
    out["peak_allocated_gib"] = peak / 2**30
    out["seconds"] = time.perf_counter() - t0
    print(f"recurrent phase: peak memory_allocated {out['peak_allocated_gib']:.2f} GiB; "
          f"{out['seconds']:.1f} s")
    return out


CROSS_ARCH = "llama-3.2-vision-90b"
# one [attn x4, cross] group at full width: the least depth the layout allows
# (6,379,626,497 parameters, 25.5 GB at fp32; 87.7 B at the published 100)
CROSS_LAYERS = 5
AUDIO_ARCH = "whisper-tiny"
# a cross sublayer's gate is drawn as 0.0 (tanh(0) = 0: a fresh cross layer
# adds nothing), and the served requests carry zero image embeddings and
# frames (K = V = 0): every card check of the cross path runs these weights
# with the gates at 0.7 and unit-normal side inputs
CROSS_GATE = 0.7


class capture_cross:
    """Within the block, record the (q, k, v) and kwargs of the cache-less
    flash calls (`FlashAttentionFn`'s forward: the cross layers and
    whisper's encoder) whose running index is in `keep` (cloned), then run
    the call as usual."""

    def __init__(self, keep):
        self.keep, self.calls, self.n = set(keep), {}, 0

    def __enter__(self):
        import repro_torch.kernels.flash_attention.ops as O

        self.O, self.orig = O, O.flash_fwd

        def rec(q, k, v, **kw):
            if self.n in self.keep:
                self.calls[self.n] = ((q.clone(), k.clone(), v.clone()), dict(kw))
            self.n += 1
            return self.orig(q, k, v, **kw)

        O.flash_fwd = rec
        return self

    def __exit__(self, *exc):
        self.O.flash_fwd = self.orig


def set_gates(params, value) -> int:
    """Every cross sublayer's gate leaf set to `value` in place; returns how
    many stacked gate leaves there were."""
    n = 0
    for stack in ("groups", "enc_groups"):
        for sub in params.get(stack, {}).values():
            if "gate" in sub["mix"]:
                sub["mix"]["gate"].fill_(value)
                n += 1
    return n


def unit_inputs(cfg, batch, prompt_len, seed) -> tuple:
    """Unit-normal side inputs on the host, as `teacher_forced` takes them:
    a VLM's image embeddings (prefill and decode), whisper's frames
    (prefill) and an encoder output (decode), (batch, n, d_model)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    if cfg.family == "vlm":
        img = torch.randn((batch, cfg.n_image_tokens, cfg.d_model), generator=gen)
        return {"img_embeds": img}, {"img_embeds": img}
    return ({"frames": torch.randn((batch, prompt_len, cfg.d_model), generator=gen)},
            {"enc_out": torch.randn((batch, prompt_len, cfg.d_model), generator=gen)})


def cross_entries(cfg, kvd, gen_len) -> dict:
    """The flash launches one served request makes (prefill + gen_len - 1
    decode steps): every self-attention layer on the request's entry at
    each step, every cross layer on the fp32 one (it keeps no cache), and
    whisper's encoder layers once, at prefill, on the fp32 one."""
    from repro_torch.models import model as M

    lay, groups = M.group_stacks(cfg)["groups"]
    n_self = groups * sum(s.kind == "attn" for s in lay)
    n_cross = groups * sum(s.kind == "cross" for s in lay)
    n_enc = cfg.n_encoder_layers if cfg.is_encoder_decoder else 0
    if kvd == "int8":
        return {"repro_flash_fwd_q8": n_self * gen_len,
                "repro_flash_fwd_f32": n_enc + n_cross * gen_len}
    return {"repro_flash_fwd_f32": n_enc + (n_self + n_cross) * gen_len}


def cross_serve_runs(name, cfg, params, out, book, dev, failures) -> tuple:
    """Both requests through `serve(cfg, params=...)` with the counters set
    to 0 just before and read just after (`cross_entries`), the served
    tokens against the card's teacher-forced argmax over the same zero
    side inputs, warm prefill / decode traces; the self-attention layer 0's
    flash calls at prefill and decode checked (not timed). Returns the last
    request's (prompt, follow)."""
    from repro_torch.launch.serve import request_inputs
    from repro_torch.models import model as M

    run = LM_SERVE
    max_len = run["prompt_len"] + run["gen_len"]
    lay, groups = M.group_stacks(cfg)["groups"]
    n_self = groups * sum(s.kind == "attn" for s in lay)
    zero = request_inputs(cfg, run["batch"], run["prompt_len"], dev)
    for kvd in ("float32", "int8"):
        summary, res = serve_and_hold(name, cfg, params, run, kvd, dev, failures,
                                      expect=cross_entries(cfg, kvd, run["gen_len"]))
        prompt, follow = res.prompt.cpu(), res.tokens.cpu()[:, :LM_TF_STEPS]
        with capture_attention((0, n_self)) as cap:
            card = teacher_forced(cfg, params, prompt, follow, kvd, dev, max_len, zero)
        summary["greedy"] = hold_greedy(name, kvd, card, follow, failures)
        out["runs"][kvd] = summary
        out["service"].update(trace_steps(name, cfg, params, res, kvd, run, dev, zero))
        for idx in (0, n_self):
            if idx not in cap.calls:
                failures.append(f"{name} {kvd}: self-attention call {idx} not captured")
                continue
            args, kw = cap.calls[idx]
            check_flash(book, f"{'prefill' if idx == 0 else 'decode'} self layer 0", args,
                        kw, timed=False, phase=name, saturated=True)
    return prompt, follow


def check_cross_calls(name, book, calls, labels, out, failures, timed=True) -> None:
    """The captured cache-less flash calls `labels` (index -> label) against
    their plain versions, timed against SDPA and the bound."""
    for idx, label in labels.items():
        if idx not in calls:
            failures.append(f"{name}: flash call {idx} ({label}) not captured")
            continue
        args, kw = calls[idx]
        row = check_flash(book, label, args, kw, timed=timed, phase=name, saturated=True)
        if row is not None:
            out.setdefault("timed", {}).setdefault(row["kernel"], []).append(row)


def vlm_serve(book, dev, failures) -> dict:
    """llama-3.2-vision-90b at full width cut to CROSS_LAYERS (one [attn x4,
    cross] group): weights drawn on the card, served over the fp32 and the
    int8 KV cache with zero image embeddings (`cross_serve_runs`); then,
    with the gate at CROSS_GATE and unit-normal image embeddings, the
    cross layer's flash call at prefill (Sq 32) and at the first decode step
    (Sq 1) over the 1,024 image tokens, non-causal, G 8, D 128, against its
    plain version and timed; the logits with the gate open against it
    closed (the cross path must move them)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(CROSS_ARCH), n_layers=CROSS_LAYERS)
    lay = T.group_layout(cfg)
    params, out = draw_on_card(CROSS_ARCH, cfg, dev, f"depth {cfg.n_layers} (of 100), one group "
                               f"{[s.kind for s in lay]}, {cfg.n_image_tokens} image tokens, "
                               f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads")
    out.update(runs={}, service={}, head_dim=cfg.resolved_head_dim,
               groups=cfg.n_heads // cfg.n_kv_heads)
    prompt, follow = cross_serve_runs(CROSS_ARCH, cfg, params, out, book, dev, failures)
    run = LM_SERVE
    max_len = run["prompt_len"] + run["gen_len"]
    inputs = unit_inputs(cfg, run["batch"], run["prompt_len"], LM_SERVE["seed"] + 2)
    closed = teacher_forced(cfg, params, prompt, follow[:, :1], "float32", dev, max_len, inputs)
    out["gates"] = set_gates(params, CROSS_GATE)
    with capture_cross((0, 1)) as cap:
        opened = teacher_forced(cfg, params, prompt, follow[:, :1], "float32", dev, max_len,
                                inputs)
    moved = max(float((a - b).abs().max()) for a, b in zip(opened, closed))
    scale = max(float(a.abs().max()) for a in opened)
    finite = all(bool(torch.isfinite(a).all()) for a in opened)
    out["gate_moves_logits"] = moved
    print(f"{CROSS_ARCH}: gate {CROSS_GATE} with unit-normal image embeddings moves the "
          f"teacher-forced logits by {moved:.3e} (max|logits| {scale:.3e}) against the gate "
          f"at 0; finite {finite}")
    if not finite or moved <= 1e-3 * scale:
        failures.append(f"{CROSS_ARCH}: the cross path does not move the logits, or they are "
                        f"not finite")
    print(f"{CROSS_ARCH} cross-layer flash checks ({KERNEL_TOL}):")
    check_cross_calls(CROSS_ARCH, book, cap.calls, {0: "cross prefill layer 4",
                                                    1: "cross decode layer 4"}, out, failures)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def nudge_gap(cfg, params_cpu, prompt, follow, inputs, max_len, seeds=2) -> float:
    """How far fp32 rounding alone moves these logits on the host: the
    largest change of the host's teacher-forced logits when the side inputs
    are nudged by a relative 1e-7 (normal noise), over `seeds` nudges."""
    import torch

    base = teacher_forced(cfg, params_cpu, prompt, follow, "float32", "cpu", max_len, inputs)
    gap = 0.0
    for seed in range(seeds):
        gen = torch.Generator().manual_seed(100 + seed)
        nudged = tuple({k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
                        for k, v in d.items()} for d in inputs)
        out = teacher_forced(cfg, params_cpu, prompt, follow, "float32", "cpu", max_len, nudged)
        gap = max(gap, max(float((a - b).abs().max()) for a, b in zip(out, base)))
    return gap


def whisper_serve(book, dev, failures) -> dict:
    """whisper-tiny at full size: weights drawn on the host and moved to the
    card, served over both requests (`cross_serve_runs`: the reference's
    zero frames at prefill and zero encoder output at decode), and the
    served requests' teacher-forced logits held card against host
    (`card_vs_host`: rtol 1e-3 + 1e-3 * max|host|, the int8 rounding
    pinned). Then the cross path, with the gates at CROSS_GATE, unit-normal
    frames at prefill and a unit-normal encoder output at decode: the
    encoder's layer 0 and the decoder's cross layer 0 (prefill and first
    decode step, D 64, G 1) checked and timed on the fp32 entry, the
    decoder's self-attention layer 0 on the int8 entry. With these inputs
    the registered weights (wq and wk drawn at fan-in n_heads, no qk_norm)
    amplify fp32 rounding layer by layer, until a 1e-7 relative nudge of the
    inputs moves the host's own logits by about a tenth of their max: their card
    against host error is printed beside that gap, and not held. The same
    widths with qk_norm on are held card against host at the LM limit over
    both requests."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import request_inputs
    from repro_torch.models import model as M

    cfg = get_config(AUDIO_ARCH)
    run = LM_SERVE
    max_len = run["prompt_len"] + run["gen_len"]
    out = {"n_params": cfg.n_params(), "runs": {}, "service": {},
           "head_dim": cfg.resolved_head_dim, "groups": cfg.n_heads // cfg.n_kv_heads,
           "card_vs_host": {}}
    params_cpu = M.init_params(cfg, torch.Generator().manual_seed(run["seed"]), device="cpu")
    params = tree_to(params_cpu, dev)
    print(f"{AUDIO_ARCH} at full size: {out['n_params']:,} params, encoder "
          f"{cfg.n_encoder_layers} x {[tuple(s) for s in M.AUDIO_ENC_LAYOUT]}, decoder "
          f"{cfg.n_layers} x {[tuple(s) for s in M.AUDIO_DEC_LAYOUT]}, head dim "
          f"{cfg.resolved_head_dim}")
    prompt, follow = cross_serve_runs(AUDIO_ARCH, cfg, params, out, book, dev, failures)
    zero = request_inputs(cfg, run["batch"], run["prompt_len"], "cpu")
    for kvd in ("float32", "int8"):
        out["card_vs_host"][f"served {kvd}"] = card_vs_host(
            f"{AUDIO_ARCH} full size, served inputs", cfg, params, params_cpu, prompt, follow,
            kvd, dev, max_len, failures, zero)
    out["gates"] = set_gates(params, CROSS_GATE)
    set_gates(params_cpu, CROSS_GATE)
    inputs = unit_inputs(cfg, run["batch"], run["prompt_len"], run["seed"] + 2)
    n_enc, n_dec = cfg.n_encoder_layers, cfg.n_layers
    with capture_cross((0, n_enc, n_enc + n_dec)) as cap:
        card = teacher_forced(cfg, params, prompt, follow, "float32", dev, max_len, inputs)
    host = teacher_forced(cfg, params_cpu, prompt, follow, "float32", "cpu", max_len, inputs)
    worst, scale, _ = logits_close(card, host)
    gap = nudge_gap(cfg, params_cpu, prompt, follow, inputs, max_len)
    finite = all(bool(torch.isfinite(c).all()) for c in card)
    out["open_gate_card_vs_host"] = {"max_abs_err": worst, "max_host": scale,
                                     "nudge_gap": gap, "finite": finite}
    print(f"{AUDIO_ARCH} full size, gate {CROSS_GATE}, unit-normal frames, float32 cache, "
          f"card vs host, teacher-forced prefill + {follow.shape[1]} decode steps: "
          f"max_abs_err={worst:.3e} (max|host|={scale:.3e}); a 1e-7 relative nudge of the "
          f"inputs moves the host's own logits by {gap:.3e}: not held (see the qk_norm "
          f"lines); logits finite {finite}")
    if not finite:
        failures.append(f"{AUDIO_ARCH} full size, gate {CROSS_GATE}: logits not finite")
    print(f"{AUDIO_ARCH} float32 flash checks ({KERNEL_TOL}):")
    check_cross_calls(AUDIO_ARCH, book, cap.calls, {
        0: "encoder layer 0", n_enc: "cross prefill layer 0",
        n_enc + n_dec: "cross decode layer 0"}, out, failures)
    with capture_attention((0, n_dec)) as acap:
        teacher_forced(cfg, params, prompt, follow[:, :1], "int8", dev, max_len, inputs)
    print(f"{AUDIO_ARCH} int8 flash checks ({KERNEL_TOL}):")
    check_cross_calls(AUDIO_ARCH, book, acap.calls, {
        0: "prefill self layer 0", n_dec: "decode self layer 0"}, out, failures)
    del params, params_cpu
    qk = dataclasses.replace(cfg, qk_norm=True)
    params_cpu = M.init_params(qk, torch.Generator().manual_seed(run["seed"]), device="cpu")
    set_gates(params_cpu, CROSS_GATE)
    params = tree_to(params_cpu, dev)
    for kvd in ("float32", "int8"):
        out["card_vs_host"][f"qk_norm {kvd}"] = card_vs_host(
            f"{AUDIO_ARCH} full size with qk_norm, gate {CROSS_GATE}", qk, params, params_cpu,
            prompt, follow, kvd, dev, max_len, failures, inputs)
    del params, params_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return out


def cross_reduced(dev, failures) -> dict:
    """Reduced llama-3.2-vision-90b and whisper-tiny drawn on the host with
    the gates at CROSS_GATE: teacher-forced logits on the card against the
    host's plain path, fed unit-normal image embeddings or frames and
    encoder output, over the fp32 and the int8 request (`card_vs_host`)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M

    out = {}
    run = LM_SERVE
    for arch in (CROSS_ARCH, AUDIO_ARCH):
        cfg = get_config(arch, reduced=True)
        params_cpu = M.init_params(cfg, torch.Generator().manual_seed(run["seed"]),
                                   device="cpu")
        set_gates(params_cpu, CROSS_GATE)
        params = tree_to(params_cpu, dev)
        gen = torch.Generator().manual_seed(run["seed"] + 1)
        prompt = torch.randint(0, cfg.vocab_size, (run["batch"], run["prompt_len"]),
                               generator=gen)
        follow = torch.randint(0, cfg.vocab_size, (run["batch"], LM_TF_STEPS), generator=gen)
        inputs = unit_inputs(cfg, run["batch"], run["prompt_len"], run["seed"] + 2)
        for kvd in ("float32", "int8"):
            out[f"{arch} {kvd}"] = card_vs_host(f"{arch} reduced, gate {CROSS_GATE}", cfg,
                                                params, params_cpu, prompt, follow, kvd, dev,
                                                run["prompt_len"] + LM_TF_STEPS, failures,
                                                inputs)
    return out


def cross_phase(book, dev, failures) -> dict:
    """The cross-attention families (see `vlm_serve`, `whisper_serve`,
    `cross_reduced`, `cross_train`); memory reserved before it and the peak
    in it."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {"memory_reserved_before_gib": torch.cuda.memory_reserved() / 2**30}
    print(f"cross phase: memory_reserved before it {out['memory_reserved_before_gib']:.2f} GiB")
    peak = 0.0  # the VLM's draw resets the peak: keep the largest
    for key, fn in (("vlm", lambda: vlm_serve(book, dev, failures)),
                    ("whisper", lambda: whisper_serve(book, dev, failures)),
                    ("reduced", lambda: cross_reduced(dev, failures)),
                    ("train", lambda: cross_train(dev, failures))):
        try:
            out[key] = fn()
        except Exception:
            traceback.print_exc()
            failures.append(f"cross phase: {key} failed")
        peak = max(peak, torch.cuda.max_memory_allocated())
        gc.collect()
        torch.cuda.empty_cache()
    out["peak_allocated_gib"] = peak / 2**30
    out["seconds"] = time.perf_counter() - t0
    print(f"cross phase: peak memory_allocated {out['peak_allocated_gib']:.2f} GiB; "
          f"{out['seconds']:.1f} s")
    return out


def cross_rows(name, cross_lm) -> list:
    """For the kernel line's flash rows (`name` flash_fwd or flash_fwd_q8):
    per cross-phase arch, its head dim, query heads per KV head, the served
    runs' launches of the row's entry per request, and its timed shapes."""
    entry = "repro_flash_fwd_q8" if name == "flash_fwd_q8" else "repro_flash_fwd_f32"
    rows = []
    for arch, key in ((CROSS_ARCH, "vlm"), (AUDIO_ARCH, "whisper")):
        res = cross_lm.get(key)
        if not res:
            continue
        timed = res.get("timed", {}).get(name, [])
        rows.append({"arch": arch, "head_dim": res["head_dim"], "groups": res["groups"],
                     "launches": {kvd: r.get("launches", {}).get(entry, 0)
                                  for kvd, r in res.get("runs", {}).items()},
                     "shapes": [{k: r[k] for k in ("shape", "q", "k", "ms", "plain_ms",
                                                   "library_ms", "bound_ms", "bound_by",
                                                   "eager_ms", "eager_library_ms")}
                                for r in timed]})
    return rows


PAPER_IMPLS = ("dense", "im2col", "ecr", "pecr", "ecr_pallas", "pecr_pallas")
VERIFIED = []  # one entry per plan this script builds


def verify_built(name, plan, params, batch, failures) -> None:
    """verify_plan on a plan this script built: it must show no error."""
    from repro_torch.analysis import errors, verify_plan

    diags = verify_plan(plan, params, batch=batch)
    errs = sorted({d.code for d in errors(diags)})
    VERIFIED.append({"plan": name, "layers": len(plan.layers), "batch": batch,
                     "errors": errs, "notes": sorted({d.code for d in diags} - set(errs))})
    if errs:
        failures.append(f"{name}: verify_plan finds errors {errs}")


def verifier_checks(plan, params, imgs, failures) -> dict:
    """The verifier on the card: a copy of the served VGG-19 plan corrupted
    two ways (a BSR layer at a weight density its params do not have, and a
    searched tile the kernels cannot honour), the launch record of a served
    layer corrupted, and the host wall of verify_plan per run_plan call
    beside the batch's wall."""
    import torch

    from dataclasses import replace

    from repro_torch.analysis import PlanVerificationError, check_launch_descriptor, verify_plan
    from repro_torch.graph.registry import unit_launch
    from repro_torch.kernels.tiles import TileConfig
    from repro_torch.pipeline import run_plan

    batch = int(imgs.shape[0])
    i = next(i for i, lp in enumerate(plan.layers) if lp.impl == "ecr_pallas")
    layers = list(plan.layers)
    layers[i] = replace(layers[i], kind="conv", impl="bsr", weight_density=0.3)
    dense_copy = replace(plan, layers=tuple(layers))
    codes = sorted({d.code for d in verify_plan(dense_copy, params, batch=batch)})
    try:
        run_plan(dense_copy, params, imgs)
        refused = False
    except PlanVerificationError as e:
        refused = "RPA205" in str(e)
    print(f"verifier: conv{i + 1} claimed as BSR at density 0.3 on unpruned params: "
          f"codes {codes}, run_plan refused: {refused}")
    if "RPA205" not in codes or not refused:
        failures.append("verifier: a BSR plan on params of another density was not refused")
    layers = list(plan.layers)
    layers[i] = replace(layers[i], tile=TileConfig(block_c=1000, block_o=32))
    tiled = replace(plan, layers=tuple(layers))
    diags = verify_plan(tiled, params, batch=batch)
    warned = sorted({d.code for d in diags})
    same = bool(torch.equal(run_plan(tiled, params, imgs), run_plan(plan, params, imgs)))
    L = unit_launch(plan.layers[i].kind, plan.layers[i].impl, plan.layers[i].to_unit(),
                    block_c=plan.block_c, batch=batch)
    bad = replace(L, tiles=L.tiles - 1)
    bad_codes = sorted({d.code for d in check_launch_descriptor(bad)})
    print(f"verifier: conv{i + 1} with tile block_c=1000 block_o=32: codes {warned} "
          f"(warn: the kernel falls back, logits bitwise unchanged: {same}); its launch "
          f"record one spatial tile short ({bad.tiles} of {L.tiles}): codes {bad_codes}")
    if warned != ["RPA204"] or not same or "RPA101" not in bad_codes:
        failures.append("verifier: a bad tile was not reported as the reference reports it")
    cost = verify_cost("vgg19", plan, params, imgs)
    return {"rpa205_codes": codes, "tile_codes": warned, "launch_codes": bad_codes,
            **cost}


def verify_cost(name, plan, params, imgs) -> dict:
    """verify_plan runs on every run_plan: its host wall (median of 5)
    against the wall of the whole run_plan call, verification included."""
    import torch

    from repro_torch.analysis import verify_plan
    from repro_torch.pipeline import run_plan

    batch = int(imgs.shape[0])
    verify_ms, run_ms = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        verify_plan(plan, params, batch=batch)
        verify_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_plan(plan, params, imgs)
        torch.cuda.synchronize()
        run_ms.append((time.perf_counter() - t0) * 1e3)
    v, r = sorted(verify_ms)[2], sorted(run_ms)[2]
    print(f"{name} verify_plan host wall {v:.3f} ms per run_plan call (median of 5) "
          f"beside the batch-{batch} run_plan wall {r:.3f} ms (verify included): "
          f"{100 * v / r:.1f}%")
    return {"verify_ms": v, "run_plan_ms": r, "verify_share": v / r}


def geometry_checks(dev, failures) -> dict:
    """Every full-width VGG-19 / LeNet-5 / AlexNet conv geometry: the Python
    mirror of the conv kernels' tile choice (`kernels.tiles`) against the
    kernels' own host code (`kernels.cuda.conv_tile`) at batch 1, 2 and 8,
    every output tile (0, 64, 128), with and without the pool, fp32 and
    int8; then each geometry the mirror accepts launched once at batch 2
    (fp32 conv, fused pool where the unit fuses, int8)."""
    import torch

    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.configs.lenet import LENET
    from repro_torch.configs.vgg19_sparse import CNNConfig, vgg19_graph
    from repro_torch.graph.registry import fusion_eligible
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels.conv_pool.kernel import conv_pool_batch
    from repro_torch.kernels.ecr_conv.kernel import ecr_conv_batch
    from repro_torch.kernels.tiles import CUDA_MAX_SMEM, f32_conv_tile, i8_conv_tile
    from repro_torch.quant.kernels import ecr_conv_int8_batch

    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    optin = getattr(props, "shared_memory_per_block_optin", None)
    print(f"geometry: {sms} SMs; kMaxSmem {CUDA_MAX_SMEM} B against the device's opt-in "
          f"shared memory per block {optin if optin is not None else 'not exposed by torch'}")
    if optin is not None and CUDA_MAX_SMEM > optin:
        failures.append(f"kMaxSmem {CUDA_MAX_SMEM} exceeds the device's opt-in {optin}")
    gen = torch.Generator(device=dev).manual_seed(0)
    compared = differ = launched = 0
    for gname, g in (("vgg19", vgg19_graph(CNNConfig())), ("lenet5", LENET),
                     ("alexnet", ALEXNET)):
        for unit in g.units():
            c, h, w = unit.in_shape
            conv, o = unit.conv, unit.conv.c_out
            hp, wp, k, st = h + 2 * conv.pad, w + 2 * conv.pad, conv.k, conv.stride
            oh, ow = (hp - k) // st + 1, (wp - k) // st + 1
            cp = c + (-c) % 8
            pools = (0, unit.pool.p) if fusion_eligible(unit) else (0,)
            for batch in (1, 2, 8):
                cases = [(pool, tn, False) for pool in pools for tn in (0, 64, 128)]
                for pool, tn, int8 in cases + [(0, 0, True)]:
                    mirror = (i8_conv_tile(oh, ow, o, k, k, st) if int8 else
                              f32_conv_tile(batch, oh, ow, o, k, k, st, pool, tn, sms))
                    try:
                        card = kcuda.conv_tile(batch, hp, wp, cp, o, k, k, stride=st,
                                               block_c=8, pool=pool, block_o=tn, int8=int8)
                    except RuntimeError:
                        card = (0,) * 7
                    compared += 1
                    if tuple(mirror) != tuple(card):
                        differ += 1
                        failures.append(f"{gname} conv{unit.index + 1} batch {batch} pool "
                                        f"{pool} tn {tn} int8 {int8}: mirror {mirror} != "
                                        f"kernel {card}")
            # one launch of each accepted geometry at batch 2
            n_cb = cp // 8
            x = torch.rand((2, hp, wp, cp), generator=gen, device=dev)
            wt = torch.randn((k, k, cp, o), generator=gen, device=dev)
            ids = torch.arange(n_cb, dtype=torch.int32, device=dev).repeat(2, 1).contiguous()
            cnt = torch.full((2,), n_cb, dtype=torch.int32, device=dev)
            outs = []
            if f32_conv_tile(2, oh, ow, o, k, k, st, 0, 0, sms)[0]:
                outs.append(ecr_conv_batch(x, wt, ids, cnt, stride=st, block_c=8))
            if len(pools) > 1 and f32_conv_tile(2, oh, ow, o, k, k, st, pools[1], 0, sms)[0]:
                outs.append(conv_pool_batch(x, wt, ids, cnt, stride=st, pool=pools[1],
                                            block_c=8))
            if i8_conv_tile(oh, ow, o, k, k, st)[0]:
                xq = torch.randint(-127, 128, x.shape, generator=gen, device=dev,
                                   dtype=torch.int8)
                wq = torch.randint(-127, 128, wt.shape, generator=gen, device=dev,
                                   dtype=torch.int8)
                sx = torch.full((2, 1), 1e-3, device=dev)
                sw = torch.full((1, o), 1e-3, device=dev)
                outs.append(ecr_conv_int8_batch(xq, wq, sx, sw, ids, cnt, stride=st,
                                                block_c=8))
            torch.cuda.synchronize()
            for y in outs:
                launched += 1
                if not bool(torch.isfinite(y).all()):
                    failures.append(f"{gname} conv{unit.index + 1}: a launch gave non-finite "
                                    f"values")
            del x, wt, outs
    print(f"geometry: the Python tile mirror against the kernels' host code on "
          f"{compared} (geometry, batch, pool, tn, dtype) cases: {compared - differ} equal, "
          f"{differ} differ; {launched} launches of the accepted geometries at batch 2, "
          f"all finite")
    return {"compared": compared, "differ": differ, "launched": launched, "sms": sms,
            "smem_optin": optin}


def paper_phase(dev, wrappers, failures) -> dict:
    """The paper's methods on full-width VGG-19 (3x224x224, 1000 classes;
    weights from init_cnn at generator seed 0 plus shift_dead_channels):
    cnn_forward at batch 1 (one image) and 2 under every impl against the
    dense path, Fig. 2 / Fig. 6's window statistics of the 16 conv inputs,
    each conv layer timed by CUDA events under every conv impl and, on the
    stage-final layers, every conv+pool impl (batch 1), and the oracle plan
    (use_pallas=False) planned, verified and run."""
    import torch

    from repro_torch.configs.vgg19_sparse import CNNConfig, vgg19_graph
    from repro_torch.core import conv2d, conv_pool, window_stats
    from repro_torch.core.pecr import fused_traffic_bytes
    from repro_torch.graph import pad2d
    from repro_torch.graph.ir import graph_weights
    from repro_torch.graph.registry import fusion_eligible
    from repro_torch.launch.serve_cnn import synth_requests
    from repro_torch.models.cnn import (
        cnn_feature_maps,
        cnn_forward,
        init_cnn,
        shift_dead_channels,
    )
    from repro_torch.pipeline import plan_network, run_plan

    t_phase = time.perf_counter()
    ccfg = CNNConfig()
    graph = vgg19_graph(ccfg)
    params = shift_dead_channels(init_cnn(torch.Generator().manual_seed(0), ccfg,
                                          device=dev))
    imgs = torch.stack(synth_requests(graph, 2, seed=2, device=dev))
    res = {"forward": [], "window_stats": [], "layers": []}
    for batch, x in ((1, imgs[0]), (2, imgs)):
        dense = cnn_forward(params, x, "dense", ccfg)
        scale = float(dense.abs().max())
        for impl in PAPER_IMPLS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(wrappers)
            t0 = time.perf_counter()
            got = cnn_forward(params, x, impl, ccfg)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            launches = {k: v for k, v in read_counts(wrappers).items() if v}
            err = float((got - dense).abs().max())
            ok = (bool(torch.isfinite(got).all()) and got.shape == dense.shape
                  and err <= 1e-4 * scale)
            print(f"paper batch {batch} cnn_forward {impl:12s}: max_abs_err vs dense "
                  f"{err:.3e} (limit 1e-4*max|dense| = {1e-4 * scale:.3e}): "
                  f"{'ok' if ok else 'FAIL'}; wall {wall:.1f} ms, peak allocated "
                  f"{peak:.0f} MiB, kernel launches {launches}")
            if not ok:
                failures.append(f"paper: cnn_forward {impl} at batch {batch} disagrees "
                                f"with dense")
            if impl.endswith("_pallas") and not launches:
                failures.append(f"paper: cnn_forward {impl} launched no kernel")
            res["forward"].append({"batch": batch, "impl": impl, "max_abs_err": err,
                                   "max_abs_dense": scale, "wall_ms": wall,
                                   "peak_mib": peak, "launches": launches})
    maps = cnn_feature_maps(params, imgs[0], ccfg)
    print("paper window statistics of the 16 conv inputs (image 0; paper Fig. 2 / "
          "Fig. 6, 3x3 windows, stride 1, before padding):")
    for unit, m in zip(graph.units(), maps):
        ws = window_stats(m, 3, 3, 1)
        print(f"  conv{unit.index + 1:<2d} {tuple(m.shape)}: sparsity {ws.sparsity:.4f}, "
              f"theta {ws.theta:.4f}, mul reduction {ws.mul_reduction:.4f}, add "
              f"reduction {ws.add_reduction:.4f}")
        res["window_stats"].append({"layer": unit.index + 1, "shape": tuple(m.shape),
                                    **vars(ws), "mul_reduction": ws.mul_reduction,
                                    "add_reduction": ws.add_reduction})
    conv_ws, _ = graph_weights(params)
    print("paper per-layer ms (batch 1, CUDA events, median of 3; conv: dense / im2col "
          "/ ecr / ecr_pallas; stage-final conv+pool: unfused / pecr / pecr_pallas):")
    for unit, m, w in zip(graph.units(), maps, conv_ws):
        xp = pad2d(m, unit.conv.pad)
        t = time_turns({impl: (lambda impl=impl: conv2d(xp, w, 1, impl))
                        for impl in ("dense", "im2col", "ecr", "ecr_pallas")},
                       rounds=3, iters=1)
        row = {"layer": unit.index + 1, "in": tuple(xp.shape), **t}
        line = " ".join(f"{k} {v:8.3f}" for k, v in t.items())
        if fusion_eligible(unit):
            tp = time_turns({impl: (lambda impl=impl: conv_pool(xp, w, 1, 2, None, impl))
                             for impl in ("unfused", "pecr", "pecr_pallas")},
                            rounds=3, iters=1)
            tb = fused_traffic_bytes(tuple(xp.shape), w.shape[0], 3, 3, 1, 2)
            row.update({f"pool_{k}": v for k, v in tp.items()}, traffic=tb)
            line += (" | " + " ".join(f"{k} {v:8.3f}" for k, v in tp.items())
                     + f" | fused {tb['fused_bytes']} B, unfused {tb['unfused_bytes']} B,"
                       f" saved {tb['saved_frac']:.3f}")
        print(f"  conv{unit.index + 1:<2d} {tuple(xp.shape)}: {line}")
        res["layers"].append(row)
    oplan = plan_network(params, imgs, graph, occ_threshold=0.75, block_c=8,
                         use_pallas=False)
    verify_built("vgg19 oracle plan (use_pallas=False)", oplan, params, 2, failures)
    got = run_plan(oplan, params, imgs)
    dense = cnn_forward(params, imgs, "dense", ccfg)
    err = float((got - dense).abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= 1e-4 * float(dense.abs().max())
    print(f"paper oracle plan: {plan_line(oplan)}; run_plan vs dense max_abs_err "
          f"{err:.3e}: {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("paper: the oracle plan disagrees with dense")
    res["oracle_plan"] = plan_line(oplan)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"paper phase: {res['seconds']:.1f} s")
    return res


GRAPH_BUCKETS = (2, 4, 8)
# the kernel class (`kernel_category`) of each kernel impl, and its C entry
# point and wrapper
IMPL_KERNELS = {"ecr_pallas": ("ecr kernel", "repro_ecr_conv_f32", "ecr_conv_batch"),
                "pecr_pallas": ("pecr kernel", "repro_conv_pool_f32", "conv_pool_batch"),
                "bsr": ("bsr kernel", "repro_bsr_matmul_f32", "bsr_matmul"),
                "ecr_int8": ("ecr int8 kernel", "repro_ecr_conv_i8", "ecr_conv_int8_batch"),
                "bsr_int8": ("bsr int8 kernel", "repro_bsr_matmul_i8", "bsr_matmul_int8")}


def median_wall_ms(fn, n: int = 5) -> float:
    """Median host wall of `fn` with a synchronize, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return sorted(walls)[n // 2]


def perturbed(params, seed: int):
    """Another model with `params`' zeros (so the same plan and key): every
    weight times 1 + 0.05 * N(0, 1) from generator `seed`."""
    import torch

    w0 = params["conv"][0]
    g = torch.Generator(device=w0.device).manual_seed(seed)

    def move(w):
        return w * (1.0 + 0.05 * torch.randn(w.shape, generator=g, device=w.device))

    return {"conv": [move(w) for w in params["conv"]],
            "dense": [move(w) for w in params["dense"]]}


def graphs_model(name, graph, dev, failures, *, prune_density=1.0, int8=False) -> dict:
    """One model through its Engine's compiled runners at buckets 2, 4 and 8:
    each captured (seconds, memory_reserved, the graph pool), its logits
    bitwise equal to eager run_plan at the same bucket and its occupancies
    equal at n_valid = 1 .. bucket on one runner, the eager and graph host
    wall (median of 5); at bucket 8 device time and idle share of both and
    the kernel names in a torch.profiler trace of one replayed batch; then
    a hot swap to a same-key params set and back, each batch equal to its
    own params' run_plan."""
    import numpy as np
    import torch

    from repro_torch.launch.serve_cnn import synth_requests
    from repro_torch.pipeline import run_plan
    from repro_torch.serving import Engine

    params, calib, _ = make_params(graph, seed=0, dev=dev, prune_density=prune_density)
    # replan_band 10: no drift re-plan moves the plan under the checks (the
    # scenario phase drives re-plans)
    eng = Engine(params, graph=graph, calib=calib, occ_threshold=0.75, block_c=8,
                 max_batch=8, int8=int8, int8_budget=0.0, replan_band=10.0, device=dev)
    plan = eng.plan
    verify_built(f"graphs {name}", plan, params, 8, failures)
    kernel_impls = [lp.impl for lp in plan.layers if lp.impl in IMPL_KERNELS]
    print(f"graphs {name} plan: {plan_line(plan)}")
    out = {"plan": plan_line(plan), "buckets": {}}
    for b in GRAPH_BUCKETS:
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        eng.warmup([b])
        build_s = time.perf_counter() - t0
        runner = eng._executable(b)
        imgs = torch.stack(synth_requests(graph, b, seed=100 + b, device=dev))
        imgs[-1] = 0.0  # the all-zero tail of a padded bucket
        want = run_plan(plan, params, imgs)
        bitwise, occ_equal = True, True
        for nv in range(1, b + 1):
            logits, occs = runner(params, imgs, nv)
            ref, ref_occs = run_plan(plan, params, imgs, collect_occupancy=True, n_valid=nv)
            bitwise &= bool(torch.equal(logits, want) and torch.equal(logits, ref))
            occ_equal &= bool(torch.equal(occs, ref_occs))
        per_replay = {IMPL_KERNELS[i][2]: kernel_impls.count(i) for i in set(kernel_impls)}
        row = {"build_s": build_s, "capture_s": runner.capture_s,
               "memory_reserved_mib": torch.cuda.memory_reserved() / 2**20,
               "reserved_by_build_mib": (torch.cuda.memory_reserved() - mem0) / 2**20,
               "graph_pool_mib": eng.cache.graphs.nbytes() / 2**20,
               "launches_per_replay": runner.launches_per_replay,
               "bitwise_vs_eager": bitwise, "occupancies_equal": occ_equal,
               "eager_wall_ms": median_wall_ms(
                   lambda x=imgs, n=b: run_plan(plan, params, x, collect_occupancy=True,
                                                n_valid=n)),
               "graph_wall_ms": median_wall_ms(lambda r=runner, x=imgs, n=b: r(params, x, n))}
        print(f"graphs {name} bucket {b}: build {build_s:.3f} s (capture {runner.capture_s:.3f} "
              f"s), memory_reserved {row['memory_reserved_mib']:.1f} MiB "
              f"(+{row['reserved_by_build_mib']:.1f}), graph pool {row['graph_pool_mib']:.1f} "
              f"MiB; launches per replay {runner.launches_per_replay}; logits bitwise equal to "
              f"eager run_plan at n_valid 1..{b}: {bitwise}; occupancies equal: {occ_equal}; "
              f"host wall eager {row['eager_wall_ms']:.3f} ms, graph {row['graph_wall_ms']:.3f} "
              f"ms (median of 5)")
        if not (bitwise and occ_equal):
            failures.append(f"graphs {name} bucket {b}: the replay differs from eager run_plan")
        if runner.launches_per_replay != per_replay:
            failures.append(f"graphs {name} bucket {b}: launches per replay "
                            f"{runner.launches_per_replay}, the plan runs {per_replay}")
        if b == GRAPH_BUCKETS[-1]:
            svc = service_breakdown(eng, imgs)
            print_service(f"graphs {name}", svc)
            row["service"] = svc
            names = svc["kernels_by_class"]
            for impl in sorted(set(kernel_impls)):
                cls, entry, _ = IMPL_KERNELS[impl]
                found = names.get(cls, {})
                print(f"graphs {name} replayed batch trace: {entry} ({impl}) as "
                      f"{sum(found.values())} launches of {sorted(found)[:2]}")
                if sum(found.values()) != kernel_impls.count(impl):
                    failures.append(f"graphs {name}: {entry} not in the trace of a replayed "
                                    f"batch as often as the plan runs it")
        out["buckets"][b] = row
    # a hot swap to another params set of the same key, and back
    imgs = torch.stack(synth_requests(graph, 8, seed=200, device=dev))
    other = perturbed(params, seed=1)
    builds, captures = eng.cache.compiles, eng.cache.graphs.captures
    got = {}
    for label, p in (("swapped", other), ("back", params)):
        t0 = time.perf_counter()
        ok = eng.hot_swap(p, plan=plan)
        swap_ms = (time.perf_counter() - t0) * 1e3
        served = eng.serve(list(imgs))
        got[label] = bool(ok) and np.array_equal(served, run_plan(plan, p, imgs).cpu().numpy())
        got[label + "_ms"] = swap_ms
        got[label + "_logits"] = served
    apart = float(np.abs(got["swapped_logits"] - got["back_logits"]).max())
    same_key = eng.cache.compiles == builds and eng.cache.graphs.captures == captures
    print(f"graphs {name} same-key hot swap: to another params set {got['swapped']} "
          f"({got['swapped_ms']:.1f} ms), back {got['back']} ({got['back_ms']:.1f} ms), "
          f"each batch bitwise equal to its own params' run_plan; the two models' logits "
          f"differ by {apart:.3e}; builds {builds} -> {eng.cache.compiles}, captures "
          f"{captures} -> {eng.cache.graphs.captures}")
    if not (got["swapped"] and got["back"] and same_key and apart > 0):
        failures.append(f"graphs {name}: a same-key hot swap did not serve each params "
                        f"set's own logits without a build")
    out["hot_swap"] = {"swapped": got["swapped"], "back": got["back"], "apart": apart,
                       "swap_ms": got["swapped_ms"], "builds": eng.cache.compiles,
                       "captures": eng.cache.graphs.captures}
    out["stats"] = {k: eng.stats()[k] for k in ("compiles", "captures", "graph_pool_bytes",
                                                  "batch_builds")}
    return out


def graphs_phase(dev, failures) -> dict:
    """`graphs_model` over VGG-19 (dense-weight, pruned 0.3, int8, pruned
    int8), LeNet-5 and AlexNet."""
    import torch

    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.configs.lenet import LENET
    from repro_torch.configs.vgg19_sparse import CNNConfig, vgg19_graph

    t0 = time.perf_counter()
    vgg = vgg19_graph(CNNConfig())
    out = {}
    for name, graph, prune, int8 in (
            ("vgg19", vgg, 1.0, False), ("vgg19-pruned", vgg, PRUNE_DENSITY, False),
            ("vgg19-int8", vgg, 1.0, True), ("vgg19-pruned-int8", vgg, PRUNE_DENSITY, True),
            ("lenet5", LENET, 1.0, False), ("alexnet", ALEXNET, 1.0, False)):
        try:
            out[name] = graphs_model(name, graph, dev, failures, prune_density=prune,
                                     int8=int8)
        except Exception:
            traceback.print_exc()
            failures.append(f"graphs {name} failed")
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"graphs phase: {out['seconds']:.1f} s")
    return out


SHARD_VARIANTS = (("vgg19", 1.0, False), ("vgg19-pruned-int8", PRUNE_DENSITY, True))


def sharded_variant(name, graph, dev, wrappers, failures, *, prune_density, int8,
                    slots) -> dict:
    """One VGG-19 variant served over a 1-D data mesh of `slots` (step
    5c): 16 requests through Engine(mesh=), the checks and the per-slot
    figures; the warm batch-8 service against an unsharded runner of the
    same plan when the slots share one card."""
    import numpy as np
    import torch

    from repro_torch.graph import run_graph
    from repro_torch.launch.serve_cnn import synth_requests
    from repro_torch.parallel import data_mesh
    from repro_torch.pipeline import plan_network, run_plan
    from repro_torch.serving import Engine, SimClock
    from repro_torch.serving.graph_runner import CompiledRunner

    tag = f"sharded {name} over {[str(d) for d in slots]}"
    params, calib, _ = make_params(graph, seed=0, dev=dev, prune_density=prune_density)
    t0 = time.perf_counter()
    plan = plan_network(params, calib, graph, occ_threshold=0.75, block_c=8, int8=int8,
                        int8_budget=0.0)
    eng = Engine(params, graph=graph, plan=plan, max_batch=8, clock=SimClock(),
                 mesh=data_mesh(len(slots), devices=slots), device=dev)
    eng.warmup()
    build_s = time.perf_counter() - t0
    runner = eng._executable(8)
    print(f"{tag}: plan {plan_line(plan)}; buckets {eng.batcher.exec_buckets()} built in "
          f"{build_s:.2f} s (planning included); per slot captures "
          f"{eng.stats()['captures_per_slot']}, capture s at bucket 8 "
          f"{[round(r.capture_s, 3) for r in runner.runners]}")
    imgs = torch.stack(synth_requests(graph, 16, seed=2, device=dev))
    captures = eng.stats()["captures"]
    reset_counts(wrappers)
    for pool in eng.cache.pools:
        pool.replay_launches.clear()
    wall0 = time.perf_counter()
    served = eng.serve(list(imgs))  # two 8-buckets, each split 4 + 4
    wall = time.perf_counter() - wall0
    eager = read_counts(wrappers)
    replayed = {}
    for pool in eng.cache.pools:
        for k, n in pool.replay_launches.items():
            replayed[k] = replayed.get(k, 0) + n
    launches = {k: eager[k] + replayed.get(fn.__name__, 0) for k, fn in wrappers.items()}
    per_replay = {}
    for r in runner.runners:
        for k, n in r.launches_per_replay.items():
            per_replay[k] = per_replay.get(k, 0) + n
    want = {k: 2 * per_replay.get(fn.__name__, 0) for k, fn in wrappers.items()}
    stats = eng.stats()
    print(f"{tag} served 16 requests in {stats['batches']} batches: launches {launches} "
          f"(2 x the slots' per-replay counts {want}: {launches == want}; eager {eager}), "
          f"{stats['captures'] - captures} captures while serving ({stats['batch_builds']} "
          f"by a batch), host wall {wall:.3f} s")
    if launches != want or any(eager.values()):
        failures.append(f"{tag}: launches {launches}, want {want} by replay alone")
    if stats["batch_builds"] or stats["captures"] != captures or stats["batches"] != 2:
        failures.append(f"{tag}: a runner was built while serving, or not 2 batches")
    kernels = {"ecr_pallas": "ecr_conv", "pecr_pallas": "conv_pool", "bsr": "bsr_matmul",
               "ecr_int8": "ecr_conv_int8", "bsr_int8": "bsr_matmul_int8"}
    for impl in {lp.impl for lp in plan.layers} & set(kernels):
        if launches[kernels[impl]] < 1:
            failures.append(f"{tag}: {kernels[impl]} ({impl}) never launched")
    shard_equal, shard_diff = True, 0.0
    for b in range(2):
        for i in range(2):
            rows = slice(8 * b + 4 * i, 8 * b + 4 * i + 4)
            ref = run_plan(plan, params, imgs[rows]).cpu().numpy()
            shard_equal &= bool(np.array_equal(served[rows], ref))
            shard_diff = max(shard_diff, float(np.abs(served[rows] - ref).max()))
    print(f"{tag}: every shard's logits bitwise equal to run_plan on its slice: "
          f"{shard_equal} (max diff {shard_diff:.3e})")
    if not shard_equal:
        failures.append(f"{tag}: a shard's logits differ from run_plan on its slice")
    dense = run_graph(graph, params, imgs, "dense").cpu().numpy()
    scale = float(np.abs(dense).max())
    err = float(np.abs(served - dense).max())
    if not np.all(np.isfinite(served)) or served.shape != (16, 1000):
        failures.append(f"{tag}: served logits not finite or of the wrong shape")
    out = {"plan": plan_line(plan), "slots": [str(d) for d in slots],
           "launches": launches, "per_replay": per_replay, "shard_bitwise": shard_equal,
           "max_abs_vs_dense": err, "max_abs_dense": scale,
           "captures_per_slot": stats["captures_per_slot"],
           "graph_pool_bytes_per_slot": stats["graph_pool_bytes_per_slot"],
           "capture_s_bucket8": [r.capture_s for r in runner.runners]}
    if int8:
        agree = float((served.argmax(-1) == dense.argmax(-1)).mean())
        out["top1_vs_dense"] = agree
        print(f"{tag} served logits vs the fp32 dense path: top-1 agreement {agree:.3f}, "
              f"max drift {err:.3e} (max|dense|={scale:.3e})")
    else:
        ok = np.allclose(served, dense, rtol=1e-3, atol=1e-3 * scale)
        print(f"{tag} vs dense cuDNN: max_abs_err={err:.3e} (max|dense|={scale:.3e}, "
              f"rtol=1e-3, atol=1e-3*max|dense|): {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{tag}: served logits disagree with the dense path")
    ragged = torch.cat([imgs[:4], torch.zeros_like(imgs[:4])])
    _, occs = runner(params, ragged, 4)
    _, ref_occs = run_plan(plan, params, ragged, collect_occupancy=True, n_valid=4)
    occ_err = float((occs - ref_occs).abs().max())
    occ_ok = bool(torch.allclose(occs, ref_occs, rtol=1e-6, atol=1e-6))
    out["ragged_occupancy_err"] = occ_err
    print(f"{tag} ragged bucket (4 real + 4 zero, the second shard all padding): "
          f"aggregated occupancy vs run_plan's n_valid=4 statistic max diff {occ_err:.3e} "
          f"(rtol 1e-6, atol 1e-6): {'ok' if occ_ok else 'FAIL'}")
    if not occ_ok:
        failures.append(f"{tag}: the aggregated occupancy of a ragged bucket is off")
    print(f"{tag} graph pool per slot: "
          f"{[round(b / 2**20, 1) for b in stats['graph_pool_bytes_per_slot']]} MiB")
    if len(set(slots)) == 1:
        single = CompiledRunner(plan, params, 8, dev)
        x8 = imgs[:8]
        turns = []
        for label in ("unsharded", "sharded", "sharded", "unsharded"):
            fn = (lambda: single(params, x8, 8)) if label == "unsharded" \
                else (lambda: runner(params, x8, 8))
            turns.append((label, trace_breakdown(fn, {"batch": 8})))
        single.release()
        out["service"] = [{"route": label, **{k: t[k] for k in (
            "wall_ms", "device_ms", "device_ops", "idle_share", "by_class_ms")}}
            for label, t in turns]
        out["card"] = card_line()
        print(f"{tag} warm batch-8 service by CUDA-graph replay on {out['card']}, in turns "
              f"(the two shards share one card's SMs: the cost of sharding, not a "
              f"speed-up): " + "; ".join(
                  f"{label} wall {t['wall_ms']:.3f} ms device {t['device_ms']:.3f} ms "
                  f"({t['device_ops']} ops, idle {t['idle_share']})" for label, t in turns))
    del eng, runner
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sharded_phase(dev, wrappers, failures) -> dict:
    """Step 5c: `sharded_variant` for SHARD_VARIANTS over two slots of
    cuda:0, the default engine's mesh, and real cards where present."""
    import torch

    from repro_torch.configs.vgg19_sparse import CNNConfig, vgg19_graph
    from repro_torch.serving import Engine, SimClock, auto_mesh, plan_key

    t0 = time.perf_counter()
    graph = vgg19_graph(CNNConfig())
    out = {}
    card0 = torch.device("cuda", 0)
    for name, prune, int8 in SHARD_VARIANTS:
        try:
            out[name] = sharded_variant(name, graph, dev, wrappers, failures,
                                        prune_density=prune, int8=int8, slots=[card0] * 2)
        except Exception:
            traceback.print_exc()
            failures.append(f"sharded {name} failed")
    params, calib, _ = make_params(graph, seed=0, dev=dev)
    auto = Engine(params, graph=graph, calib=calib, occ_threshold=0.75, block_c=8,
                  max_batch=8, clock=SimClock(), device=dev)
    n_cards = torch.cuda.device_count()
    shape = plan_key(8, auto.plan, auto.mesh).mesh_shape
    out["default_engine"] = {"cards": n_cards, "n_devices": auto.n_devices,
                             "mesh_shape": shape}
    print(f"sharded: the default Engine (mesh='auto') on {n_cards} card(s): n_devices "
          f"{auto.n_devices}, PlanKey.mesh_shape {shape}")
    if n_cards == 1 and (auto.n_devices != 1 or shape != ()):
        failures.append("sharded: the default engine on one card is not unsharded")
    del auto, params, calib
    if n_cards >= 2:
        slots = auto_mesh(8).slots
        try:
            out["cards"] = sharded_variant("vgg19", graph, dev, wrappers, failures,
                                           prune_density=1.0, int8=False, slots=slots)
        except Exception:
            traceback.print_exc()
            failures.append("sharded vgg19 over real cards failed")
    else:
        print("sharded: serving over several real cards did not run (this machine has "
              "one card)")
    out["seconds"] = time.perf_counter() - t0
    print(f"sharded phase: {out['seconds']:.1f} s")
    return out


SCN_RATE = 200.0  # req/s offered in the hot-swap and diurnal streams


def scn_engine(graph, params, calib, dev, **kw):
    """An Engine as the served phases build them (block_c=8,
    occ_threshold=0.75, max_batch=8), on a SimClock charged with the
    measured service time."""
    from repro_torch.serving import Engine, SimClock

    kw.setdefault("clock", SimClock())
    return Engine(params, graph=graph, calib=calib, occ_threshold=0.75, block_c=8,
                  max_batch=8, device=dev, **kw)


def plan_logits(plan, params, imgs):
    """run_plan over `imgs` in buckets of 8 (the engine's largest), numpy."""
    import numpy as np

    from repro_torch.pipeline import run_plan

    return np.concatenate([run_plan(plan, params, imgs[i:i + 8]).cpu().numpy()
                           for i in range(0, imgs.shape[0], 8)])


def close(got, ref) -> tuple:
    """rtol 1e-3 + 1e-3*max|ref|: on the card run_plan equals the engine
    bitwise only at the same bucket. Returns (ok, max_abs_err)."""
    import numpy as np

    atol = 1e-3 * float(np.abs(ref).max())
    ok = bool(np.all(np.isfinite(got)) and np.allclose(got, ref, rtol=1e-3, atol=atol))
    return ok, float(np.abs(got - ref).max())


def decisions(plan) -> list:
    return [(lp.kind, lp.impl) for lp in plan.layers]


def scenario_hotswap(graph, params, calib, dev, wrappers, failures) -> dict:
    """24 requests with a hot swap to the 0.3-pruned variant (planned on the
    card) at the midpoint, the swap back, a refused corrupt swap, and the
    weight signature on two pruned variants."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.pipeline import plan_network
    from repro_torch.serving import HotSwapScenario, plan_key, replay_scenario, replay_stream
    from repro_torch.serving.scenarios import synth_image
    from repro_torch.sparse_weights.prune import prune_graph_params

    pruned, rep = prune_graph_params(params, 0.3, graph)
    pplan = plan_network(pruned, calib, graph, occ_threshold=0.75, block_c=8)
    verify_built("scenario hot-swap variant (pruned 0.3)", pplan, pruned, 8, failures)
    eng = scn_engine(graph, params, calib, dev)
    dplan = eng.plan
    eng.warmup()
    n = 24
    at_swap = {}

    def swap(engines):
        at_swap.update(read_counts(wrappers, eng))
        at_swap["swapped"] = engines[""].hot_swap(pruned, plan=pplan)

    scn = HotSwapScenario(in_shape=graph.in_shape, n_requests=n, rate_rps=SCN_RATE,
                          t_swap=n / (2 * SCN_RATE), swap_fn=swap, seed=0)
    reset_counts(wrappers, eng)
    results = replay_scenario(eng, scn)[""]
    launches = read_counts(wrappers, eng)
    st = eng.stats()
    print(f"scenario hotswap: pruned to {rep.density:.4f}; plan after the swap "
          f"{plan_line(pplan)}; launches at the swap {dict((k, at_swap.get(k)) for k in wrappers)},"
          f" after the stream {launches}; {st['batches']} batches, hot_swaps "
          f"{st['hot_swaps']}, compiles {st['compiles']}")
    if not at_swap.get("swapped") or sorted(r.id for r in results) != list(range(n)):
        failures.append("scenario hotswap: the swap did not land or a request was lost")
    if at_swap.get("bsr_matmul", 1) != 0 or launches["bsr_matmul"] < 1:
        failures.append("scenario hotswap: bsr_matmul did not grow only after the swap")
    if at_swap.get("ecr_conv", 0) < 1 or at_swap.get("conv_pool", 0) < 1:
        failures.append("scenario hotswap: ECR / PECR did not launch before the swap")
    swap_t = [e["t"] for e in st["telemetry"]["replan_events"] if e["kind"] == "hot_swap"][0]
    imgs = torch.stack([r.img for r in scn.requests()]).to(dev)
    ref_old, ref_new = plan_logits(dplan, params, imgs), plan_logits(pplan, pruned, imgs)
    # the largest per-logit tolerance either check allows: rtol 1e-3 plus
    # atol 1e-3*max|ref|, both at most 1e-3*max|logits|
    tol = 2e-3 * max(float(np.abs(ref_old).max()), float(np.abs(ref_new).max()))
    pre = [r for r in results if r.t_done <= swap_t]
    post = [r for r in results if r.t_done > swap_t]
    worst = 0.0
    for part, ref in ((pre, ref_old), (post, ref_new)):
        if part:
            ok, err = close(np.stack([r.logits for r in part]),
                               ref[[r.id for r in part]])
            worst = max(worst, err)
            if not ok:
                failures.append("scenario hotswap: a request disagrees with the model "
                                "that served it")
    apart = float(min(np.abs(ref_old[i] - ref_new[i]).max() for i in range(n)))
    print(f"scenario hotswap: {len(pre)} requests served before the swap, {len(post)} "
          f"after; each against run_plan of its model: max err {worst:.3e} = "
          f"{worst / tol:.4f} x the tolerance {tol:.3e} (2e-3*max|logits|); the two "
          f"models' logits differ by at least {apart:.3e} = {apart / tol:.1f} x the "
          f"tolerance per request")
    if not pre or not post or apart <= 10 * tol:
        failures.append("scenario hotswap: the swap did not land mid-stream, or the two "
                        "models cannot be told apart")
    # the swap back builds nothing; a corrupt candidate is refused
    builds = eng.cache.compiles
    back = eng.hot_swap(params, plan=dplan)
    k = next(i for i, lp in enumerate(pplan.layers) if lp.impl == "bsr")
    bad = replace(pplan, layers=tuple(replace(lp, weight_density=0.5) if i == k else lp
                                      for i, lp in enumerate(pplan.layers)))
    refused = eng.hot_swap(pruned, plan=bad)
    codes = [e["codes"] for e in eng.stats()["telemetry"]["replan_events"]
             if e["kind"] == "verify_reject"]
    reset_counts(wrappers, eng)
    more = [synth_image(graph.in_shape, 1, i) for i in range(8)]
    after = sorted(replay_stream(eng, more, rate_rps=1000.0), key=lambda r: r.id)
    after_launches = read_counts(wrappers, eng)
    ok_after, err_after = close(np.stack([r.logits for r in after]),
                                   plan_logits(dplan, params, torch.stack(more).to(dev)))
    print(f"scenario hotswap: swap back {back}, compiles {builds} -> "
          f"{eng.cache.compiles} after 8 more requests; conv{k + 1} density claimed 0.5 "
          f"on the 0.3 params: hot_swap returned {refused}, verify_rejects "
          f"{eng.verify_rejects}, codes {codes}; the next batches vs the dense-weight "
          f"model's run_plan: max err {err_after:.3e} {'ok' if ok_after else 'FAIL'}, "
          f"launches {after_launches}")
    if not back or eng.cache.compiles != builds:
        failures.append("scenario hotswap: the swap back built a runner")
    if refused or eng.verify_rejects != 1 or not codes or "RPA205" not in codes[0]:
        failures.append("scenario hotswap: the corrupt swap was not refused with RPA205")
    if not ok_after or after_launches["bsr_matmul"] != 0:
        failures.append("scenario hotswap: after the refused swap the engine did not "
                        "serve the current model")
    out = {"pruned_density": rep.density, "plan_after_swap": plan_line(pplan),
           "launches_at_swap": {k: at_swap.get(k) for k in wrappers},
           "launches": launches, "served_before_swap": len(pre), "max_err": worst,
           "tolerance": tol, "models_apart": apart, "compiles": builds,
           "compiles_after_swap_back": eng.cache.compiles, "refused_codes": codes}
    del eng
    # the weight signature at full width: two pruned variants with the same
    # (kind, impl) decisions but other rounded BSR densities, on one engine;
    # 0.5 first, then densities nearer 0.3 (at 224 px the 0.5 and 0.4
    # variants move layers off BSR)
    for d in (0.5, 0.4, 0.35, 0.25):
        p5, rep5 = prune_graph_params(params, d, graph)
        plan5 = plan_network(p5, calib, graph, occ_threshold=0.75, block_c=8)
        verify_built(f"scenario weight_sig variant (pruned {d})", plan5, p5, 8, failures)
        same = decisions(plan5) == decisions(pplan)
        sigs_differ = plan_key(8, plan5).weight_sig != plan_key(8, pplan).weight_sig
        print(f"scenario weight_sig: the {d} variant plans {plan_line(plan5)}: same "
              f"(kind, impl) decisions as the 0.3 variant: {same}; rounded BSR "
              f"densities differ: {sigs_differ}")
        if same and sigs_differ:
            break
    else:
        print("scenario weight_sig: no pair with equal decisions and other BSR "
              "densities at full width; "
              "tests/test_torch_engine_replan.py::"
              "test_hot_swap_between_pruned_variants_builds_separate_runners is the "
              "evidence")
        out["weight_sig"] = "no pair with equal decisions"
        return out
    eng = scn_engine(graph, pruned, calib, dev, plan=pplan)
    batch = torch.stack(more).to(dev)
    got3 = eng.serve(list(batch))
    b3 = eng.cache.compiles
    eng.hot_swap(p5, plan=plan5)
    got5 = eng.serve(list(batch))
    keys_differ = plan_key(8, pplan) != plan_key(8, plan5)
    ok3 = close(got3, plan_logits(pplan, pruned, batch))[0]
    ok5 = close(got5, plan_logits(plan5, p5, batch))[0]
    print(f"scenario weight_sig: 0.3 and {d} variants (density {rep5.density:.4f}) "
          f"plan the same decisions; weight_sig {plan_key(8, pplan).weight_sig[:3]}... vs "
          f"{plan_key(8, plan5).weight_sig[:3]}...: keys differ {keys_differ}; builds "
          f"{b3} then {eng.cache.compiles}; each variant vs its own run_plan: {ok3} {ok5}")
    if not keys_differ or b3 != 1 or eng.cache.compiles != 2 or not (ok3 and ok5):
        failures.append("scenario weight_sig: the pruned variants shared a runner")
    out["weight_sig"] = {"pair": [0.3, d], "keys_differ": keys_differ,
                         "builds": eng.cache.compiles}
    return out


def scenario_diurnal(graph, params, calib, dev, failures) -> dict:
    """32 requests planned at dead_frac 0.5, stepping at the midpoint, with
    replan_band 0.15 and no cooldown: to 0.0 (a re-plan needs the occupancy
    to move, and VGG-19's 3 input channels fill one 8-channel block either
    way), then to 1.0 (blank frames: every layer's occupancy drops)."""
    import numpy as np
    import torch

    from repro_torch.pipeline import plan_network
    from repro_torch.serving import DiurnalDriftScenario, replay_scenario

    n = 32
    out = {}
    for dead_hi in (0.0, 1.0):
        eng = scn_engine(graph, params, calib, dev, replan_band=0.15, replan_cooldown=0)
        before = eng.plan
        planned = np.array([lp.occupancy for lp in before.layers])
        eng.warmup()
        scn = DiurnalDriftScenario(in_shape=graph.in_shape, n_requests=n, rate_rps=SCN_RATE,
                                   dead_lo=0.5, dead_hi=dead_hi, drift="step",
                                   t_drift=n / (2 * SCN_RATE), seed=0)
        results = replay_scenario(eng, scn)[""]
        st = eng.stats()
        tel = st["telemetry"]
        drift = max(float(np.abs(np.array(v) - planned).max()) for _, v in tel["occ_timeline"])
        swaps = [e for e in tel["replan_events"] if e["kind"] == "swap" and e["changed"]]
        landed = [sum(1 for t, _ in tel["occ_timeline"] if t <= e["t"]) for e in swaps]
        onset = len({r.t_formed for r in results if r.t_formed < scn.t_drift})
        label = f"scenario diurnal 0.5 -> {dead_hi}"
        print(f"{label}: {len(results)} served in {st['batches']} batches, "
              f"{onset} formed before the step; replans {st['replans']}, largest "
              f"|occupancy EMA - planned| {drift:.4f} (band 0.15)")
        entry = {"replans": st["replans"], "max_drift": drift, "landed_at_batch": landed,
                 "batches_before_step": onset}
        if swaps:
            drifted = torch.stack([r.img for r in scn.requests()[-8:]]).to(dev)
            ref = plan_network(params, drifted, graph, occ_threshold=0.75, block_c=8)
            same = decisions(ref) == decisions(eng.plan)
            print(f"{label}: the re-plan landed after batch {landed[0]}; plan before "
                  f"{plan_line(before)}; after {plan_line(eng.plan)}; equals plan_network "
                  f"on the last 8 (drifted) images: {same}")
            entry.update(plan_before=plan_line(before), plan_after=plan_line(eng.plan),
                         equals_plan_network=same)
            if not same:
                failures.append(f"{label}: the re-plan is not plan_network's plan")
        if not all(np.all(np.isfinite(r.logits)) for r in results) or len(results) != n:
            failures.append(f"{label}: lost requests or non-finite logits")
        out[str(dead_hi)] = entry
        del eng
    if out["1.0"]["replans"] < 1:
        failures.append("scenario diurnal: no re-plan landed on the blank-frame step")
    return out


def scenario_burst(graph, params, calib, dev, failures) -> dict:
    """32 Poisson requests at 50 req/s with 16x bursts: every id served once,
    each formed within its deadline plus the service of the buckets that
    ran between its arrival and its formation (the one executing when it
    arrived included: the measured service exceeds the 10 ms deadline)."""
    from repro_torch.serving import PoissonBurstScenario, replay_scenario

    n, rate = 32, 50.0
    t_mid = n / (2 * rate)
    eng = scn_engine(graph, params, calib, dev)
    eng.warmup()
    scn = PoissonBurstScenario(in_shape=graph.in_shape, n_requests=n, base_rps=rate,
                               burst_rps=16 * rate, burst_every_s=t_mid,
                               burst_len_s=t_mid / 4, seed=0)
    results = replay_scenario(eng, scn)[""]
    batches = {r.t_formed: r.t_done for r in results}  # t_formed -> t_done
    late = []
    for r in results:
        busy = sum(d - f for f, d in batches.items() if f < r.t_formed and d > r.t_arrival)
        if r.t_formed - r.t_arrival > eng.batcher.deadline_s + busy + 1e-9:
            late.append(r.id)
    if late:
        failures.append(f"scenario burst: requests {late} waited past their bound")
    st = eng.stats()
    print(f"scenario burst: {len(results)} served once each: "
          f"{sorted(r.id for r in results) == list(range(n))}; {st['batches']} batches, "
          f"buckets {st['telemetry']['bucket_counts']}; p50={st['p50_ms']:.2f} ms "
          f"p95={st['p95_ms']:.2f} ms (SimClock, measured service); every request "
          f"formed within its bound: {not late}")
    if sorted(r.id for r in results) != list(range(n)):
        failures.append("scenario burst: a request was lost or served twice")
    return {"p50_ms": st["p50_ms"], "p95_ms": st["p95_ms"], "batches": st["batches"],
            "bucket_counts": st["telemetry"]["bucket_counts"]}


def scenario_multitenant(graph, params, calib, dev, failures) -> dict:
    """VGG-19 and LeNet-5 (published sizes) on one PlanCache and clock, 8
    requests each: no build after warmup, each tenant against its model."""
    import numpy as np
    import torch

    from repro_torch.configs.lenet import LENET
    from repro_torch.serving import (
        MultiTenantScenario,
        PlanCache,
        SimClock,
        TenantSpec,
        replay_scenario,
    )

    lparams, lcalib, _ = make_params(LENET, seed=1, dev=dev)
    clock, cache = SimClock(), PlanCache()
    engines = {"vgg19": scn_engine(graph, params, calib, dev, clock=clock, cache=cache),
               "lenet5": scn_engine(LENET, lparams, lcalib, dev, clock=clock, cache=cache)}
    warm = sum(e.warmup() for e in engines.values())
    scn = MultiTenantScenario(tenants=(
        ("vgg19", TenantSpec(in_shape=graph.in_shape, n_requests=8, rate_rps=100.0)),
        ("lenet5", TenantSpec(in_shape=LENET.in_shape, n_requests=8, rate_rps=100.0))),
        seed=0)
    results = replay_scenario(engines, scn)
    line = []
    for stream, eng in engines.items():
        imgs = torch.stack([r.img for r in scn.requests() if r.stream == stream]).to(dev)
        got = sorted(results[stream], key=lambda r: r.id)
        ok, err = close(np.stack([r.logits for r in got]),
                           plan_logits(eng.plan, eng.params, imgs))
        line.append(f"{stream} {len(got)} served, vs its run_plan max err {err:.3e} "
                    f"{'ok' if ok else 'FAIL'}")
        if not ok or len(got) != 8:
            failures.append(f"scenario multitenant: {stream} disagrees with its model")
    print(f"scenario multitenant: warmup built {warm} runners ({len(cache._entries)} keys), "
          f"after the stream {cache.compiles}; " + "; ".join(line))
    if cache.compiles != warm:
        failures.append("scenario multitenant: the stream built a runner")
    return {"warm_builds": warm, "builds_after": cache.compiles}


def scenario_history(kind, failures, full=True, device=None) -> dict:
    """serve_cnn(history=...) twice (steady at 96 px, then hotswap): every
    record stamped with the card's name, the trend table, and the history
    CLI's check."""
    import os
    import tempfile

    from repro_torch.launch.serve_cnn import serve_cnn
    from repro_torch.obs.history import BenchDB, trend_table

    with tempfile.TemporaryDirectory() as tmp:
        db_path = os.path.join(tmp, "benchdb.jsonl")
        for scenario in ("steady", "hotswap"):
            s = serve_cnn(model="vgg19", full=full, n_requests=16, scenario=scenario,
                          history=db_path, device=device)
            print(f"scenario history: serve_cnn --full --scenario {scenario}: "
                  f"{s['requests']} served, p50={s['p50_ms']:.2f} ms "
                  f"p95={s['p95_ms']:.2f} ms, hot_swaps {s['hot_swaps']}")
        db = BenchDB(db_path)
        kinds = sorted({r.device_kind for r in db.records})
        print(f"scenario history: {len(db)} points, {len(db.series())} series, device "
              f"kinds {kinds}")
        print(trend_table(db))
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        r = subprocess.run([sys.executable, "-m", "repro_torch.obs.history.cli", "check",
                            "--db", db_path, "--json"], capture_output=True, text=True,
                           env=env, cwd=ROOT, timeout=300)
        report = json.loads(r.stdout) if r.returncode in (0, 1) else {}
    print(f"scenario history: check --json exit {r.returncode}, counts "
          f"{report.get('counts')}, regressed {report.get('regressed')}")
    if not len(db) or kinds != [kind]:
        failures.append(f"scenario history: empty DB or records not stamped {kind!r}")
    if r.returncode not in (0, 1) or "counts" not in report:
        print(r.stderr[-2000:], file=sys.stderr)
        failures.append("scenario history: the history CLI check failed")
    return {"points": len(db), "series": len(db.series()), "device_kinds": kinds,
            "check_rc": r.returncode, "check_counts": report.get("counts")}


def scenario_phase(dev, wrappers, failures) -> dict:
    """The scenario library on the published VGG-19 (3x224x224, 1000 classes,
    make_params' weights and calibration images)."""
    import torch

    from repro_torch.configs.vgg19_sparse import CNNConfig, vgg19_graph

    graph = vgg19_graph(CNNConfig())
    params, calib, _ = make_params(graph, seed=0, dev=dev)
    t_phase = time.perf_counter()
    out = {}
    for name, fn, args in (
            ("hotswap", scenario_hotswap, (graph, params, calib, dev, wrappers, failures)),
            ("diurnal", scenario_diurnal, (graph, params, calib, dev, failures)),
            ("burst", scenario_burst, (graph, params, calib, dev, failures)),
            ("multitenant", scenario_multitenant, (graph, params, calib, dev, failures)),
            ("history", scenario_history, (torch.cuda.get_device_name(0), failures))):
        t0 = time.perf_counter()
        try:
            out[name] = fn(*args)
        except Exception:
            traceback.print_exc()
            failures.append(f"scenario {name} failed")
        out.setdefault(name, {})
        out[name]["seconds"] = time.perf_counter() - t0
        print(f"scenario {name}: {out[name]['seconds']:.2f} s")
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"scenario phase: {out['seconds']:.2f} s")
    return out


def lint_cli(failures) -> dict:
    """python -m repro_torch.analysis.cli --json over the zoo, on the card."""
    import os

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis.cli", "--json"],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    doc = json.loads(r.stdout) if r.returncode == 0 else {}
    models = [(rep["model"], " ".join(rep["plan"]["layers"])) for rep in doc.get("reports", [])]
    print(f"analysis cli --json: exit {r.returncode}, n_errors {doc.get('n_errors')}, "
          f"{models}, {time.perf_counter() - t0:.1f} s")
    if r.returncode != 0 or doc.get("n_errors") != 0:
        print(r.stderr[-2000:], file=sys.stderr)
        failures.append("python -m repro_torch.analysis.cli --json did not exit clean")
    return {"rc": r.returncode, "n_errors": doc.get("n_errors"), "models": models}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--layers-out", type=Path, default=None, metavar="PATH",
                    help="write the per-layer kernel numbers to PATH as JSON")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        return fail("CUDA is not available; this script runs the port on an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        return fail(f"{ROOT} is not a checkout of the repository (no src/repro_torch)")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.configs.lenet import LENET
    from repro_torch.configs.vgg19_sparse import CNNConfig, vgg19_graph
    from repro_torch.device import resolve_device
    from repro_torch.graph import pad2d, run_graph, run_unit
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels.bsr_matmul.kernel import bsr_matmul
    from repro_torch.kernels.conv_pool.kernel import conv_pool_batch
    from repro_torch.kernels.ecr_conv.kernel import ecr_conv_batch
    from repro_torch.pipeline import run_plan
    from repro_torch.quant.kernels import bsr_matmul_int8, ecr_conv_int8_batch
    from repro_torch.serving import replay_stream

    dev = resolve_device("cuda")  # also turns TF32 off for cuDNN and cuBLAS
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build_out = io.StringIO()
    with contextlib.redirect_stdout(build_out):
        lib_path = kcuda.build(verbose=True)
    print(build_out.getvalue(), end="")
    kcuda.library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s")

    book = KernelBook()
    failures = []
    # the fp32 tensor-core bodies (ECR / PECR, BSR, the fp32 flash forward,
    # the MLA kernel and its backward passes) run on the TF32 tensor cores
    # (HMMA), staged by cp.async (LDGSTS); the
    # conv body has no CUDA-core fp32 multiply-add (FFMA) left; the bf16
    # flash kernels run on the bf16 tensor cores (HMMA), staged by cp.async
    all_sass = sass_counts(lib_path)
    usage = ptxas_usage(build_out.getvalue())  # empty if the library was built before
    for stem, want in {**SPLIT_TF32_KERNELS, **BF16_KERNELS, **MLA_BWD_KERNELS}.items():
        sass = {k: v for k, v in all_sass.items() if stem in k}
        for fn, ops in sorted(sass.items()):
            res = usage.get(fn)
            regs = (f"registers {res.get('registers')}, stack frame {res.get('stack')} B, "
                    f"spill stores {res.get('spill_stores')} B, spill loads "
                    f"{res.get('spill_loads')} B" if res else
                    "registers and spills not reported (library built before this run)")
            print(f"sass {fn[:100]}: " + ", ".join(f"{op} {ops.get(op, 0)}" for op in
                                                  ("HMMA", "LDGSTS", "LDSM", "LDS", "FFMA"))
                  + f"; {regs}")
            if stem in NO_MMA_KERNELS:
                continue
            if not ops.get("HMMA") or not ops.get("LDGSTS"):
                failures.append(f"{fn}: no HMMA or no LDGSTS in its SASS")
            bf16_mla = stem == "flash_mla_kernel" and "kernelIt" in fn
            if (stem in BF16_KERNELS or bf16_mla) and not ops.get("LDSM"):
                failures.append(f"{fn}: no LDSM (ldmatrix) in its SASS")
        if len(sass) != want:
            failures.append(f"expected {want} {stem} instantiations, found {len(sass)}")
    for stem, want in SCAN_KERNELS.items():
        sass = {k: v for k, v in all_sass.items() if stem in k}
        for fn, ops in sorted(sass.items()):
            res = usage.get(fn) or {}
            print(f"sass {fn[:100]}: " + ", ".join(f"{op} {ops.get(op, 0)}" for op in
                                                  ("FFMA", "MUFU", "SHFL", "LDL", "STL"))
                  + f"; registers {res.get('registers')}, stack frame {res.get('stack')} B")
            if stem == "selective_scan_bwd_kernel" and (ops.get("LDL") or ops.get("STL")):
                failures.append(f"{fn}: local memory (LDL / STL) in its SASS")
        if len(sass) != want:
            failures.append(f"expected {want} {stem} instantiations, found {len(sass)}")
    wrappers = {"ecr_conv": ecr_conv_batch, "conv_pool": conv_pool_batch,
                "bsr_matmul": bsr_matmul, "ecr_conv_int8": ecr_conv_int8_batch,
                "bsr_matmul_int8": bsr_matmul_int8}

    # ---- the main path: published VGG-19 through the Engine ----------------
    graph = vgg19_graph(CNNConfig())
    eng, params, imgs, plan_s, clock, _ = serve(graph, 16, seed=0, dev=dev)
    plan = eng.plan
    print(f"vgg19 plan ({plan_s:.2f} s): {plan_line(plan)}")
    verify_built("vgg19", plan, params, 8, failures)
    impls = [lp.impl for lp in plan.layers]
    captures = eng.stats()["captures"]
    reset_counts(wrappers, eng)
    t_start = clock()
    wall0 = time.perf_counter()
    results = replay_stream(eng, imgs, rate_rps=1000.0)
    wall = time.perf_counter() - wall0
    launches = read_counts(wrappers, eng)
    makespan = clock() - t_start
    stats = eng.stats()
    print(f"vgg19 served {len(results)} requests: launches {launches} (all by CUDA-graph "
          f"replay: eager {read_counts(wrappers)}), {stats['batches']} batches, "
          f"compiles={stats['compiles']} captures={stats['captures']} ("
          f"{stats['captures'] - captures} while serving, {stats['batch_builds']} by a batch) "
          f"hits={stats['hits']}, graph pool "
          f"{stats['graph_pool_bytes'] / 2**20:.1f} MiB, throughput "
          f"{len(results) / makespan:.1f} req/s (SimClock, measured service), "
          f"p50={stats['p50_ms']:.2f} ms p95={stats['p95_ms']:.2f} ms, host wall {wall:.2f} s")
    if "ecr_pallas" not in impls or "pecr_pallas" not in impls:
        failures.append(f"vgg19 plan lacks an ECR or PECR layer: {impls}")
    if launches["ecr_conv"] < 1 or launches["conv_pool"] < 1:
        failures.append(f"a kernel of the main path never launched: {launches}")
    if stats["batch_builds"]:
        failures.append("vgg19: a served batch built (captured) its own runner")
    order = sorted(results, key=lambda r: r.id)
    served = np.stack([r.logits for r in order])
    batch = torch.stack(imgs)
    dense = run_graph(graph, params, batch, "dense").cpu().numpy()
    scale = float(np.abs(dense).max())
    err = float(np.abs(served - dense).max())
    ok = np.allclose(served, dense, rtol=1e-3, atol=1e-3 * scale)
    print(f"vgg19 engine vs dense cuDNN: max_abs_err={err:.3e} (max|dense|="
          f"{scale:.3e}, rtol=1e-3, atol=1e-3*max|dense|): {'ok' if ok else 'FAIL'}")
    if not ok or not np.all(np.isfinite(served)) or served.shape != (16, 1000):
        failures.append("vgg19 engine logits disagree with the dense path")
    ref8 = run_plan(plan, params, batch[:8]).cpu().numpy()
    print(f"vgg19 engine logits bitwise equal to run_plan on the same 8-bucket: "
          f"{bool(np.array_equal(served[:8], ref8))} "
          f"(max diff {float(np.abs(served[:8] - ref8).max()):.3e})")
    for m in (1, 2):  # the min_bucket question: is a sample's row batch-invariant?
        refm = run_plan(plan, params, batch[:m]).cpu().numpy()
        print(f"vgg19 run_plan at N={m} bitwise equal to its rows at N=8: "
              f"{bool(np.array_equal(refm, ref8[:m]))} "
              f"(max diff {float(np.abs(refm - ref8[:m]).max()):.3e})")

    # ---- LeNet-5 and AlexNet through the same spine ------------------------
    for name, g in (("lenet5", LENET), ("alexnet", ALEXNET)):
        e2, p2, im2, _, _, _ = serve(g, 8, seed=0, dev=dev)
        verify_built(name, e2.plan, p2, 8, failures)
        res2 = sorted(replay_stream(e2, im2, rate_rps=1000.0), key=lambda r: r.id)
        got2 = np.stack([r.logits for r in res2])
        ref2 = run_graph(g, p2, torch.stack(im2), "dense").cpu().numpy()
        sc2 = float(np.abs(ref2).max())
        ok2 = np.allclose(got2, ref2, rtol=1e-3, atol=1e-3 * sc2) and np.all(np.isfinite(got2))
        print(f"{name} plan: {[lp.impl for lp in e2.plan.layers]}; served "
              f"{len(res2)}: max_abs_err={float(np.abs(got2 - ref2).max()):.3e} "
              f"vs dense: {'ok' if ok2 else 'FAIL'}")
        if not ok2:
            failures.append(f"{name} engine logits disagree with the dense path")

    # ---- where the time goes in one warm batch-8 service -------------------
    svc = service_breakdown(eng, batch[:8])
    print_service("vgg19", svc)
    verifier = {}
    try:
        verifier = verifier_checks(plan, params, batch[:8], failures)
    except Exception:
        traceback.print_exc()
        failures.append("verifier checks failed")

    # ---- kernels vs plain versions at the served VGG-19 layer shapes -------
    print(f"kernel checks ({KERNEL_TOL}):")
    conv_ws = params["conv"]
    x = batch[:8]
    for lp, w in zip(plan.layers, conv_ws):
        unit = lp.to_unit()
        if lp.impl in ("ecr_pallas", "pecr_pallas"):
            pool = unit.pool.p if lp.kind == "conv_pool" else 0
            try:
                check_layer_kernels(book, unit, lp.kind, pad2d(x, unit.conv.pad), w,
                                    pool, timed=True)
            except Exception:
                traceback.print_exc()
                failures.append(f"kernel check failed at conv{unit.index + 1}")
        x = run_unit(x, w, unit, "conv", "dense")
    for row in book.rows:
        row["phase"] = "vgg19"
    try:
        edge_cases(book, dev)
    except Exception:
        traceback.print_exc()
        failures.append("edge-case kernel check failed")
    try:
        edge_cases_tf32(book, dev)
    except Exception:
        traceback.print_exc()
        failures.append("edge-case check of the split-TF32 ECR / PECR kernel failed")

    del eng
    torch.cuda.empty_cache()

    # ---- pruned, int8 and pruned+int8 VGG-19 through the Engine -------------
    variants = {}
    services = {"vgg19": svc}
    phase_launches = {"vgg19": launches}
    for name, prune, int8, want in (
            ("vgg19-pruned", PRUNE_DENSITY, False, "bsr_matmul"),
            ("vgg19-int8", 1.0, True, "ecr_conv_int8"),
            ("vgg19-pruned-int8", PRUNE_DENSITY, True, "bsr_matmul_int8")):
        try:
            vplan, vparams, vbatch, vl, summary, vs = variant_phase(
                name, graph, dev, wrappers, failures, prune_density=prune,
                int8=int8, want=want)
        except Exception:
            traceback.print_exc()
            failures.append(f"{name} phase failed")
            continue
        phase_launches[name] = vl
        variants[name] = summary
        services[name] = vs
        print_service(name, vs)
        print(f"{name} kernel checks ({KERNEL_TOL}):")
        variant_kernel_checks(book, vplan, vparams, vbatch, failures, name)
        del vplan, vparams, vbatch
        torch.cuda.empty_cache()
    try:
        edge_cases_new(book, dev)
    except Exception:
        traceback.print_exc()
        failures.append("edge-case check of the BSR / int8 kernels failed")
    try:
        edge_cases_int8_tc(book, dev)
    except Exception:
        traceback.print_exc()
        failures.append("edge-case check of the int8 tensor-core kernels failed")
    try:
        edge_cases_bsr_tf32(book, dev)
    except Exception:
        traceback.print_exc()
        failures.append("edge-case check of the split-TF32 BSR kernel failed")

    # ---- the compiled runners: one CUDA graph per (bucket, plan) key ------
    graphs = {}
    try:
        graphs = graphs_phase(dev, failures)
    except Exception:
        traceback.print_exc()
        failures.append("graphs phase failed")
    torch.cuda.empty_cache()

    # ---- data-parallel serving: Engine(mesh=) over two slots of the card --
    sharded = {}
    try:
        sharded = sharded_phase(dev, wrappers, failures)
    except Exception:
        traceback.print_exc()
        failures.append("sharded phase failed")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- obs: measure -> calibrate -> search -> plan on VGG-19 --------------
    obs = {}
    outdir = args.layers_out.parent if args.layers_out is not None else None
    if outdir is not None:
        outdir.mkdir(parents=True, exist_ok=True)
    for name, prune in (("vgg19", 1.0), ("vgg19-pruned", PRUNE_DENSITY)):
        try:
            obs[name] = obs_variant(name, graph, dev, wrappers, book, failures, outdir,
                                    prune_density=prune)
        except Exception:
            traceback.print_exc()
            failures.append(f"{name} obs phase failed")
        torch.cuda.empty_cache()

    # ---- the paper's methods as oracles; the verifier's geometry and CLI ---
    paper, geometry, lint = {}, {}, {}
    try:
        paper = paper_phase(dev, wrappers, failures)
    except Exception:
        traceback.print_exc()
        failures.append("paper phase failed")
    torch.cuda.empty_cache()
    try:
        geometry = geometry_checks(dev, failures)
    except Exception:
        traceback.print_exc()
        failures.append("geometry checks failed")
    torch.cuda.empty_cache()
    try:
        lint = lint_cli(failures)
    except Exception:
        traceback.print_exc()
        failures.append("analysis cli check failed")
    scenario = {}
    try:
        scenario = scenario_phase(dev, wrappers, failures)
    except Exception:
        traceback.print_exc()
        failures.append("scenario phase failed")
    torch.cuda.empty_cache()
    print(f"verify_plan on the {len(VERIFIED)} plans this run built:")
    for v in VERIFIED:
        print(f"  {v['plan']}: {v['layers']} layers at batch {v['batch']}, errors "
              f"{v['errors'] or 'none'}, notes {v['notes'] or 'none'}")
    if len(VERIFIED) < 12:
        failures.append(f"only {len(VERIFIED)} plans were verified")

    # ---- full-width qwen3-0.6b served through the flash kernels ------------
    lm = {}
    try:
        lm = lm_phase(book, dev, failures)
    except Exception:
        traceback.print_exc()
        failures.append(f"{LM_ARCH} phase failed")

    # ---- full-width qwen3-0.6b trained through the flash backward kernels --
    train_summary = {}
    try:
        train_summary = train_phase(book, dev, failures)
    except Exception:
        traceback.print_exc()
        failures.append(f"{LM_ARCH}-train phase failed")

    # ---- full-width qwen3-0.6b trained over 2 ranks sharing the card ------
    gc.collect()
    torch.cuda.empty_cache()
    distributed = {}
    try:
        distributed = distributed_phase(failures)
    except Exception:
        traceback.print_exc()
        failures.append("distributed phase failed")

    # ---- the compile-time launch tools: the dry run against step 9b ------
    dryrun = {}
    try:
        dryrun = dryrun_phase(dev, distributed, failures)
    except Exception:
        traceback.print_exc()
        failures.append("dry-run phase failed")

    # ---- the dense LM family at full width, after the earlier phases have
    # released their engines, graph pools and weights ----------------------
    del params, imgs, batch, x, dense, e2, p2, im2
    gc.collect()
    torch.cuda.empty_cache()
    dense_lm = {}
    try:
        dense_lm = dense_phase(book, dev, failures)
    except Exception:
        traceback.print_exc()
        failures.append("dense LM phase failed")
    gc.collect()
    torch.cuda.empty_cache()
    moe_lm = {}
    try:
        moe_lm = moe_phase(book, dev, failures)
    except Exception:
        traceback.print_exc()
        failures.append("MoE phase failed")
    gc.collect()
    torch.cuda.empty_cache()
    mla_lm = {}
    try:
        mla_lm = mla_phase(book, dev, failures)
    except Exception:
        traceback.print_exc()
        failures.append("MLA phase failed")
    gc.collect()
    torch.cuda.empty_cache()
    recurrent_lm = {}
    try:
        recurrent_lm = recurrent_phase(book, dev, failures)
    except Exception:
        traceback.print_exc()
        failures.append("recurrent phase failed")
    gc.collect()
    torch.cuda.empty_cache()
    cross_lm = {}
    try:
        cross_lm = cross_phase(book, dev, failures)
    except Exception:
        traceback.print_exc()
        failures.append("cross phase failed")

    csrc = "src/repro_torch/kernels/csrc/"
    # (name, book key, row suffix, source, replaces, the phase that serves it)
    table = (
        ("ecr_conv_batch", "ecr_conv", "", "ecr_conv.cu",
         "src/repro/kernels/ecr_conv/kernel.py:166", "vgg19"),
        ("conv_pool_batch", "conv_pool", "", "ecr_conv.cu",
         "src/repro/kernels/conv_pool/kernel.py:181", "vgg19"),
        ("ecr_conv_batch at N=1", "ecr_conv", "_n1", "ecr_conv.cu",
         "src/repro/kernels/ecr_conv/kernel.py:94", "vgg19"),
        ("conv_pool_batch at N=1", "conv_pool", "_n1", "ecr_conv.cu",
         "src/repro/kernels/conv_pool/kernel.py:98", "vgg19"),
        ("bsr_matmul", "bsr_matmul", "", "bsr_matmul.cu",
         "src/repro/kernels/bsr_matmul/kernel.py:75", "vgg19-pruned"),
        ("ecr_conv_int8_batch", "ecr_conv_int8", "", "ecr_conv_int8.cu",
         "src/repro/quant/kernels.py:183", "vgg19-int8"),
        ("ecr_conv_int8_batch at N=1", "ecr_conv_int8_n1", "", "ecr_conv_int8.cu",
         "src/repro/quant/kernels.py:104", "vgg19-int8"),
        ("bsr_matmul_int8", "bsr_matmul_int8", "", "bsr_matmul_int8.cu",
         "src/repro/quant/kernels.py:252", "vgg19-pruned-int8"),
    )
    # rows whose kernels were redesigned for the tensor cores, and in which PR
    # (16 and 17: fp32 on split-TF32; 15: int8)
    redesigned = {"ecr_conv_batch": 16, "conv_pool_batch": 16, "ecr_conv_batch at N=1": 16,
                  "conv_pool_batch at N=1": 16, "bsr_matmul": 17, "ecr_conv_int8_batch": 15,
                  "ecr_conv_int8_batch at N=1": 15, "bsr_matmul_int8": 15}
    int8_rows = ("ecr_conv_int8_batch", "ecr_conv_int8_batch at N=1", "bsr_matmul_int8")
    kernels = []
    for name, key, sfx, source, replaces, phase in table:
        rows = [r for r in book.rows if r["kernel"] == key and r["phase"] == phase]
        flop_ms = sum(r["flop_ms" + sfx] for r in rows)
        byte_ms = sum(r["byte_ms" + sfx] for r in rows)
        # the engine's buckets hold at least 2 requests: the single-image rows
        # are never launched on the served path
        single = "N=1" in name
        ms = sum(r["ms" + sfx] for r in rows)
        bound = sum(r["bound_ms" + sfx] for r in rows)
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + source,
            "replaces": replaces,
            "launches": 0 if single else phase_launches.get(phase, {}).get(key, 0),
            "max_abs_err": book.max_err.get(key, 0.0),
            "ms": ms,
            "plain_ms": sum(r["plain_ms" + sfx] for r in rows),
            "bound_ms": bound,
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "library_ms": sum(r["library_ms" + sfx] for r in rows),
            "phase": phase, "layers": [r["layer"] for r in rows],
            # the sharded phase's runs (two slots of the card), both variants
            "sharded_launches": 0 if single else sum(
                sharded.get(v[0], {}).get("launches", {}).get(key, 0)
                for v in SHARD_VARIANTS)})
        if name in redesigned and ms > 0:
            kernels[-1].update({
                "redesigned_in": redesigned[name],
                "timing": "CUDA-graph replay (plain_ms eager)",
                "eager_ms": sum(r["eager_ms" + sfx] for r in rows),
                "eager_library_ms": sum(r["eager_library_ms" + sfx] for r in rows),
                "achieved_gbs": byte_ms / ms * PEAK_HBM_BYTES / 1e9,
                "bound_share": bound / ms})
            if name not in int8_rows:
                kernels[-1].update({
                    "achieved_tflops": flop_ms / ms * PEAK_TF32_SPLIT_FLOPS / 1e12,
                    "fp32_core_bound_ms": sum(r["fp32_core_bound_ms" + sfx] for r in rows)})
                if single:
                    kernels[-1]["split_reduction"] = False  # not implemented
            else:
                kernels[-1]["achieved_tops"] = flop_ms / ms * PEAK_INT8_OPS / 1e12
        if not rows:
            failures.append(f"no timed layer ran {name}")
    # the flash rows: one prefill plus one decode launch at the served shapes
    # (layer 0), with every timed shape listed under "shapes"
    flash_src = "src/repro/kernels/flash_attention/kernel.py"
    for name, kvd, replaces in (("flash_fwd", "float32", flash_src + ":94"),
                                ("flash_fwd_q8", "int8", flash_src + ":165")):
        rows = [r for r in book.rows if r["kernel"] == name and r["phase"] == LM_ARCH]
        main_rows = [r for r in rows if r["shape"] in ("prefill layer 0", "decode layer 0")]
        flop_ms = sum(r["flop_ms"] for r in main_rows)
        byte_ms = sum(r["byte_ms"] for r in main_rows)
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + "flash_attention.cu",
            "replaces": replaces,
            **({"redesigned_in": 17, "timing": "CUDA-graph replay (plain_ms too)"}
               if name == "flash_fwd" else {}),
            "launches": lm.get("runs", {}).get(kvd, {}).get("launches", {}).get(name, 0),
            "max_abs_err": book.max_err.get(name, 0.0),
            "ms": sum(r["ms"] for r in main_rows),
            "plain_ms": sum(r["plain_ms"] for r in main_rows),
            "bound_ms": sum(r["bound_ms"] for r in main_rows),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "library_ms": sum(r["library_ms"] for r in main_rows),
            "phase": LM_ARCH,
            # the dense LM phase's served archs: layer 0's prefill and decode
            # launch by graph replay and the served run's launches, per arch
            "dense_lm": dense_rows(name, kvd, dense_lm),
            # the same for the MoE phase's arctic-480b (depth 1, G 7)
            "moe_lm": moe_rows(name, kvd, moe_lm),
            # the cross phase's archs: llama-3.2-vision-90b (depth 5: its
            # cross layer non-causal over 1,024 image tokens, G 8, D 128) and
            # whisper-tiny (D 64, G 1), launches per request and timed shapes
            "cross_lm": cross_rows(name, cross_lm),
            "launches_by_head_dim": launches_by_head_dim(name, kvd, lm, dense_lm, moe_lm,
                                                         cross_lm),
            # the fp32 trainer's run (the main training run is bf16)
            "train_launches": (train_summary.get("fp32", {}).get("entries", {})
                               .get("repro_flash_fwd_f32", 0) if name == "flash_fwd" else 0),
            "shapes": [{k: r[k] for k in ("shape", "q", "k", "ms", "plain_ms",
                                          "library_ms", "bound_ms", "bound_by")}
                       for r in rows]})
        if len(main_rows) != 2:
            failures.append(f"{name}: the served shapes were not timed")
    # the backward rows: one launch of each pass at the trained shape (layer
    # 0 of a batch-8 step), with every timed shape listed under "shapes"; the
    # fp32 passes' launches are the fp32 trainer's run, the bf16 ones' (and
    # the bf16 forward's) the main training run's
    train_entries = train_summary.get("main", {}).get("entries", {})
    fp32_entries = train_summary.get("fp32", {}).get("entries", {})
    for name, src, site, launched, peak in (
            ("flash_bwd_dq", "flash_attention_bwd.cu", ":265",
             fp32_entries.get("repro_flash_bwd_dq_f32", 0), PEAK_TF32_SPLIT_FLOPS),
            ("flash_bwd_dkv", "flash_attention_bwd.cu", ":284",
             fp32_entries.get("repro_flash_bwd_dkv_f32", 0), PEAK_TF32_SPLIT_FLOPS),
            ("flash_fwd_bf16", "flash_attention.cu", ":94",
             train_entries.get("repro_flash_fwd_bf16", 0), PEAK_BF16_FLOPS),
            ("flash_bwd_dq_bf16", "flash_attention_bwd.cu", ":265",
             train_entries.get("repro_flash_bwd_dq_bf16", 0), PEAK_BF16_FLOPS),
            ("flash_bwd_dkv_bf16", "flash_attention_bwd.cu", ":284",
             train_entries.get("repro_flash_bwd_dkv_bf16", 0), PEAK_BF16_FLOPS)):
        rows = [r for r in book.rows if r["kernel"] == name]
        main_rows = [r for r in rows if r["shape"] == "trained layer 0"]
        ms = sum(r["ms"] for r in main_rows)
        bound = sum(r["bound_ms"] for r in main_rows)
        flop_ms = sum(r["flop_ms"] for r in main_rows)
        bf16 = name.endswith("_bf16")
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + src,
            "replaces": flash_src + site,
            "redesigned_in": {"flash_fwd_bf16": 26, "flash_bwd_dq_bf16": 25,
                              "flash_bwd_dkv_bf16": 25}.get(name, 18),
            "timing": "CUDA-graph replay (plain_ms too)",
            "launches": launched,
            "max_abs_err": book.max_err.get(name, 0.0),
            "ms": ms,
            "plain_ms": sum(r["plain_ms"] for r in main_rows),
            "bound_ms": bound,
            "bound_by": main_rows[0]["bound_by"] if main_rows else "operations",
            "library_ms": sum(r["library_ms"] for r in main_rows),
            "eager_ms": sum(r["eager_ms"] for r in main_rows),
            "eager_library_ms": sum(r["eager_library_ms"] for r in main_rows),
            "achieved_tflops": flop_ms / ms * peak / 1e12 if ms else 0.0,
            "bound_share": bound / ms if ms else 0.0,
            **({} if bf16 else {"fp32_core_bound_ms": sum(r["fp32_core_bound_ms"]
                                                          for r in main_rows)}),
            "phase": LM_ARCH + "-train",
            "shapes": [{k: r[k] for k in ("shape", "q", "k", "ms", "plain_ms",
                                          "library_ms", "eager_ms", "eager_library_ms",
                                          "bound_ms", "bound_by", "tile_ms") if k in r}
                       for r in rows]})
        if len(main_rows) != 1:
            failures.append(f"{name}: the trained shape was not timed")
    # the MLA rows: one prefill plus one decode launch at the served shapes
    # (layer 0), launches over the served deepseek-v2 run of their cache type;
    # no pallas_call site sits on the reference's MLA path: its chunked jnp
    # flash_attention computes flash_fwd_pallas's function at Dk != Dv
    serve_runs = mla_lm.get("serve", {}).get("runs", {})
    for name, kvd, entry in (("flash_fwd_mla_f32", "float32", MLA_ENTRIES[0]),
                             ("flash_fwd_mla_bf16kv", "int8", MLA_ENTRIES[1])):
        rows = [r for r in book.rows if r["kernel"] == name]
        main_rows = [r for r in rows if r["shape"] in ("prefill layer 0", "decode layer 0")]
        flop_ms = sum(r["flop_ms"] for r in main_rows)
        byte_ms = sum(r["byte_ms"] for r in main_rows)
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + "flash_mla.cu",
            "replaces": flash_src + ":94", "reference_call": "src/repro/models/attention.py:336",
            "timing": "CUDA-graph replay (plain_ms too)",
            "launches": serve_runs.get(kvd, {}).get("launches", {}).get(entry, 0),
            "launches_by_shape": serve_runs.get(kvd, {}).get("launches_by_shape", {}),
            "max_abs_err": book.max_err.get(name, 0.0),
            "ms": sum(r["ms"] for r in main_rows),
            "plain_ms": sum(r["plain_ms"] for r in main_rows),
            "bound_ms": sum(r["bound_ms"] for r in main_rows),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "library_ms": sum(r["library_ms"] for r in main_rows),
            "library_backend": sorted({r["library_backend"] for r in main_rows}),
            "eager_ms": sum(r["eager_ms"] for r in main_rows),
            "eager_library_ms": sum(r["eager_library_ms"] for r in main_rows),
            "phase": MLA_ARCH,
            "shapes": [{k: r[k] for k in ("shape", "q", "c_kv", "ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by")} for r in rows]})
        if len(main_rows) != 2:
            failures.append(f"{name}: the served shapes were not timed")
    # the selective scan: one prefill plus one decode launch at the served
    # shapes (jamba's layer 0), launches over the served fp32 jamba run; no
    # pallas_call site: the reference runs the recurrence as a jnp lax.scan
    rows = [r for r in book.rows if r["kernel"] == "selective_scan"]
    flop_ms = sum(r["flop_ms"] for r in rows)
    byte_ms = sum(r["byte_ms"] for r in rows)
    jamba_runs = recurrent_lm.get("jamba", {}).get("runs", {})
    kernels.append({
        "name": "selective_scan", "route": "cuda", "source": csrc + "selective_scan.cu",
        "replaces": "src/repro/models/ssm.py:106",
        "timing": "CUDA-graph replay (plain_ms too)",
        "launches": jamba_runs.get("float32", {}).get("launches", {}).get(SCAN_ENTRY, 0),
        "int8_request_launches": jamba_runs.get("int8", {}).get("launches", {}).get(
            SCAN_ENTRY, 0),
        "max_abs_err": book.max_err.get("selective_scan", 0.0),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "library_ms": None,
        "eager_ms": sum(r["eager_ms"] for r in rows),
        "phase": SSM_ARCH,
        "shapes": [{k: r[k] for k in ("shape", "x", "n", "ms", "plain_ms", "bound_ms",
                                      "bound_by")} for r in rows]})
    if len(rows) != 2:
        failures.append("selective_scan: the served shapes were not timed")
    # the training rows of the MLA and hybrid families: each timed at its
    # full-width sublayer (deepseek-v2's MLA at B 2 x S 128, jamba's Mamba at
    # B 4 x S 128), launches over the phase's training runs (the sublayer's
    # forward and backward, the reduced config's fp32 step and its 3 bf16
    # steps, each counted from 0 just before and read just after)
    for name, entry, lm, src, replaces, ref in (
            ("flash_bwd_mla_dq_f32", "repro_flash_bwd_mla_dq_f32", mla_lm, "flash_mla_bwd.cu",
             flash_src + ":265", "src/repro/models/attention.py:336"),
            ("flash_bwd_mla_dkv_f32", "repro_flash_bwd_mla_dkv_f32", mla_lm,
             "flash_mla_bwd.cu", flash_src + ":284", "src/repro/models/attention.py:336"),
            ("flash_bwd_mla_dq_bf16", "repro_flash_bwd_mla_dq_bf16", mla_lm,
             "flash_mla_bwd.cu", flash_src + ":265", "src/repro/models/attention.py:336"),
            ("flash_bwd_mla_dkv_bf16", "repro_flash_bwd_mla_dkv_bf16", mla_lm,
             "flash_mla_bwd.cu", flash_src + ":284", "src/repro/models/attention.py:336"),
            ("selective_scan_bf16", "repro_selective_scan_bf16", recurrent_lm,
             "selective_scan.cu", "src/repro/models/ssm.py:106", None),
            ("selective_scan_bwd_f32", "repro_selective_scan_bwd_f32", recurrent_lm,
             "selective_scan.cu", "src/repro/models/ssm.py:106", None),
            ("selective_scan_bwd_bf16", "repro_selective_scan_bwd_bf16", recurrent_lm,
             "selective_scan.cu", "src/repro/models/ssm.py:106", None)):
        train = lm.get("train", {})
        sub = train.get("sublayer", {}).get("runs", {})
        launched = (sum(r.get("launches", {}).get(entry, 0) for r in sub.values())
                    + train.get("fp32_step", {}).get("entries", {}).get(entry, 0)
                    + sum(r.get("entries", {}).get(entry, 0)
                          for k, r in train.get("reduced", {}).items()
                          if not k.endswith(" step")))
        shapes = [r for r in book.rows if r["kernel"] == name]
        rows = [r for r in shapes if r["shape"] == "sublayer"]
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + src, "replaces": replaces,
            **({"reference_call": ref} if ref else {}),
            "timing": "CUDA-graph replay (plain_ms too)",
            "launches": launched,
            "max_abs_err": book.max_err.get(name, 0.0),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": rows[0]["bound_by"] if rows else "operations",
            "library_ms": (rows[0]["library_ms"] if rows else None),
            **({"library_note": rows[0]["library_note"]} if rows and "library_note" in rows[0]
               else {}),
            **({"fp32_core_bound_ms": rows[0]["fp32_core_bound_ms"]}
               if rows and "fp32_core_bound_ms" in rows[0] else {}),
            "phase": (MLA_ARCH if lm is mla_lm else SSM_ARCH) + "-train",
            "shapes": [{k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                                          "bound_by") if k in r} for r in shapes]})
        if len(rows) != 1:
            failures.append(f"{name}: the full-width sublayer was not timed")
        if not launched:
            failures.append(f"{name}: no launch in its family's training runs")
    if args.layers_out is not None:
        args.layers_out.parent.mkdir(parents=True, exist_ok=True)
        args.layers_out.write_text(json.dumps(
            {"card": card, "rows": book.rows, "kernels": kernels,
             "service": services, "variants": variants, "obs": obs, "lm": lm,
             "dense_lm": dense_lm, "moe_lm": moe_lm, "mla_lm": mla_lm,
             "recurrent_lm": recurrent_lm, "cross_lm": cross_lm,
             "train": train_summary, "paper": paper, "verifier": verifier,
             "geometry": geometry, "lint": lint, "scenario": scenario,
             "graphs": graphs, "sharded": sharded, "distributed": distributed,
             "dryrun": dryrun, "verified": VERIFIED},
            indent=1, default=str))
    if failures:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
